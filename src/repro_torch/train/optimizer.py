"""AdamW of the port (the reference's ``repro.train.optimizer``, no
``torch.optim``).

The state keeps the reference's layout: fp32 moments ``m`` and ``v`` with
the parameters' tree structure, and ``count``, an int32 scalar tensor on
the parameters' device.  ``adamw_update`` is functional: it returns new
parameter and state trees and leaves its inputs as they were, so a caller
may keep a step's parameters (a checkpoint, a replay) while training goes
on.  The learning rate, the clip scale and the bias corrections are device
tensors, so an update makes no host sync.

``torch.optim.AdamW`` is not this function: its clipping, schedule and
decay order differ.  The arithmetic here is the reference's, in its order.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_flatten(tree) -> tuple[list, callable]:
    """``(leaves, rebuild)`` of a nested dict of tensors, in
    ``jax.tree.leaves`` order (keys sorted); ``rebuild(new_leaves)`` puts
    new leaves back in ``tree``'s structure."""
    if not isinstance(tree, dict):
        return [tree], lambda leaves: leaves[0]
    keys = sorted(tree)
    parts = [tree_flatten(tree[k]) for k in keys]

    def rebuild(leaves):
        out, pos = {}, 0
        for k, (sub, build) in zip(keys, parts):
            out[k] = build(leaves[pos:pos + len(sub)])
            pos += len(sub)
        return out

    return [x for sub, _ in parts for x in sub], rebuild


def adamw_init(params) -> dict:
    leaves, rebuild = tree_flatten(params)
    return {
        "m": rebuild([torch.zeros_like(p, dtype=torch.float32) for p in leaves]),
        "v": rebuild([torch.zeros_like(p, dtype=torch.float32) for p in leaves]),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_flatten(tree)[0])
    return torch.sqrt(sq)


def adamw_update(cfg: AdamWConfig, grads, state, params):
    """Returns (new_params, new_state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p_new = p - lr * (step + cfg.weight_decay * p)
        return p_new.to(p.dtype), m_new, v_new

    flat_p, rebuild = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_flatten(t)[0] for t in (grads, state["m"], state["v"]))
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_state = {
        "m": rebuild([o[1] for o in out]),
        "v": rebuild([o[2] for o in out]),
        "count": count,
    }
    return rebuild([o[0] for o in out]), new_state, {"grad_norm": gnorm, "lr": lr}


def update_reading(cfg: AdamWConfig, params, new_params, state, ulps: int) -> float:
    """How far one step's ``new_params`` lie from AdamW recomputed in
    float64 from the step's own ``params`` and new ``state`` (its ``m``,
    ``v`` and ``count``), on the tensors' device: max |new - want| over
    ``ulps`` x (want's fp32 spacing + 2**-23 x lr x (|Adam step| + |wd x
    p|)).  At most 1 when the step's fp32 arithmetic is AdamW's; a step
    that leaves the parameters as they were, or takes twice the lr, reads
    far above it once lr is many ulp of the parameters (a short warm-up).
    The fp32 scalars (lr, the bias corrections) are the ones the step
    computes."""
    count = torch.tensor(float(state["count"]), dtype=torch.float32)
    lr = float(cfg.lr * torch.clamp(count / max(cfg.warmup_steps, 1), max=1.0))
    bc1, bc2 = (float(1.0 - b ** count) for b in (cfg.b1, cfg.b2))
    worst = 0.0
    for p0, p1, m, v in zip(*(tree_flatten(t)[0] for t in (params, new_params, state["m"],
                                                         state["v"]))):
        p0, m, v = (t.double() for t in (p0, m, v))
        adam, decay = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps), cfg.weight_decay * p0
        want = p0 - lr * (adam + decay)
        w32 = want.float().abs()
        spacing = torch.nextafter(w32, torch.full_like(w32, math.inf)) - w32
        tol = ulps * (spacing.double() + 2.0**-23 * lr * (adam.abs() + decay.abs()))
        worst = max(worst, float(((p1.double() - want).abs() / tol).max()))
    return worst
