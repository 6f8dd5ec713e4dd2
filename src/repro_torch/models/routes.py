"""Routing records of the MoE layers.

``RouteLog`` records, while it is open, every ``moe_apply`` call's routing
through ``layers.set_moe_observer``: the fp32 router logits (G, Sg, E),
the chosen experts (G, Sg, K) in choice order and the assignments kept
under capacity (G, Sg * K).  It keeps the device tensors, so recording
makes no host sync; the kept masks give the share capacity dropped.

``route_changes`` holds one run's routes against another's on the same
inputs (the card against the CPU, bf16 against fp32).  Routing is
discontinuous: where two experts' logits lie within the runs' rounding
differences, the runs may choose differently (a route flip), and the
token's row then differs by a whole expert's output.  So it reports
which batch rows a flip reached and whether every flip lay within a
stated gap of the reference run's logits.
"""

from __future__ import annotations

import torch

from . import layers


class RouteLog:
    """Context manager: ``calls`` is the list of (logits, experts, keep) of
    every ``moe_apply`` call made while it is open, in call order."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self) -> "RouteLog":
        layers.set_moe_observer(lambda *routing: self.calls.append(routing))
        return self

    def __exit__(self, *exc) -> bool:
        layers.set_moe_observer(None)
        return False


def _gap(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The smallest gap among each token's k + 1 largest logits: under it a
    perturbation can change the chosen set or its order."""
    top = torch.sort(logits, dim=-1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).amin(-1)


def route_changes(truth: list, other: list, *, tokens_per_row: int, eps: float,
                  hit: torch.Tensor | None = None) -> dict:
    """Routes of ``other`` against ``truth`` (two ``RouteLog.calls`` of the
    same calls), call by call.  A batch row is hit when one of its tokens
    takes other experts, or the same in another order, or when capacity
    keeps another set of its assignments (a flip elsewhere in its dispatch
    group reorders the queue for a slot); a hit row stays hit.  A flip of a
    token whose row was not hit before is "near" when the truth's gap is at
    most ``eps`` x the token's largest |logit|, else "wide".

    ``tokens_per_row`` maps a call's flattened tokens to batch rows (the
    sequence length in prefill, 1 in decode); ``hit`` carries the rows hit
    by earlier calls (decode steps).  -> {"held": rows not hit (bool),
    "flips", "wide", "tokens": tokens checked, "calls"}."""
    if len(truth) != len(other):
        raise ValueError(f"{len(truth)} calls against {len(other)}")
    flips = wide = tokens = 0
    for (t_logits, t_experts, t_keep), (o_logits, o_experts, o_keep) in zip(truth, other):
        g, sg, k = t_experts.shape
        if o_experts.shape != t_experts.shape:
            raise ValueError(f"routing shapes {tuple(t_experts.shape)} and "
                             f"{tuple(o_experts.shape)} differ")
        t_logits = t_logits.float().cpu()
        rows = torch.arange(g * sg).view(g, sg) // tokens_per_row
        if hit is None:
            hit = torch.zeros(g * sg // tokens_per_row, dtype=torch.bool)
        clean = ~hit[rows]
        flip = (t_experts.cpu() != o_experts.cpu()).any(-1)
        moved = (t_keep.cpu() != o_keep.cpu()).view(g, sg, k).any(-1)
        near = _gap(t_logits, k) <= eps * t_logits.abs().amax(-1)
        flips += int((flip & clean).sum())
        wide += int((flip & clean & ~near).sum())
        tokens += int(clean.sum())
        hit = hit.clone()
        hit[rows[flip | moved]] = True
    return {"held": ~hit if hit is not None else None, "flips": flips, "wide": wide,
            "tokens": tokens, "calls": len(truth)}
