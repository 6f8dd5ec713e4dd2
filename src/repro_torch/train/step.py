"""Train, serve and prefill step factories of the port (the reference's
``repro.train.step``).

``make_train_step(cfg)`` -> step(params, opt_state, batch) -> (params,
opt_state, {"loss", "grad_norm", "lr"}): one AdamW step on the gradient of
``loss_fn``, functional (new trees out, the inputs untouched).  With
``n_microbatches`` > 1 the batch splits into slices taken one after the
other, their gradients accumulated in ``grad_dtype`` and divided by n, the
loss averaged: the activation peak scales with the slice, the
accumulation buffer with the model.  Training reads the fp32 master
parameters directly: the layers' own casts carry the gradient to them.

``make_serve_step(cfg)`` -> step(params, cache, batch) -> (logits, cache):
one-token decode against a cache, which the step consumes (it is updated
in place).  ``make_prefill_step(cfg)`` -> step(params, batch) -> the
last-position logits.

Each step keeps one bf16 working copy of the matmul weights (embedding,
head, attention, MLP, router, expert, RG-LRU and RWKV6 matrices; the list
is ``_MATMUL_LEAVES`` and every ``w_*``), made the first time
it sees a parameter tree and reused while the same tree object comes
back; a tree changed in place needs a new step.  The reference casts
every weight to bf16 inside each call (``p["w_q"].astype(dt)``); the
cast is deterministic, so the copy holds the same bits and the layers'
own casts become no-ops.  Norm scales and biases stay fp32, since the norms
multiply by them in fp32, and so do the recurrent families' vectors.
"""

from __future__ import annotations

import torch

from ..models import decode_step, loss_fn, prefill
from ..models.config import ModelConfig
from ..models import hooks, layers
from .optimizer import AdamWConfig, adamw_init, adamw_update, tree_flatten


# Cast: the leaves the reference casts to the compute dtype at every use
# and multiplies as matrices -- the embedding and head, every ``w_*``
# (attention, cross-attention, MLP, experts, RG-LRU and RWKV projections),
# the router and RWKV6's low-rank mix and decay factors.  Kept fp32: norm
# scales and biases, RG-LRU's ``a_param`` and conv, RWKV6's ``mix_base``,
# ``mix_k`` / ``mix_r``, ``ln_scale``, and ``decay_base`` and ``bonus_u``,
# which the reference reads in fp32 (a bf16 copy would round them).
_MATMUL_LEAVES = ("embed", "lm_head", "router", "mix_lora_a", "mix_lora_b", "decay_lora_a",
                  "decay_lora_b")


def _is_matmul_weight(name: str) -> bool:
    return name in _MATMUL_LEAVES or name.startswith("w_")


def bf16_working_copy(params: dict) -> dict:
    """The tree with every matmul weight cast to bf16, norms untouched."""
    return {
        name: bf16_working_copy(leaf) if isinstance(leaf, dict)
        else leaf.to(layers.COMPUTE_DTYPE) if _is_matmul_weight(name) else leaf
        for name, leaf in params.items()
    }


class _WorkingCopy:
    """The bf16 copy of the last parameter tree seen (by identity)."""

    def __init__(self):
        self.source = self.copy = None

    def __call__(self, params: dict) -> dict:
        if params is not self.source:
            self.source, self.copy = params, bf16_working_copy(params)
        return self.copy


def make_serve_step(cfg: ModelConfig):
    working = _WorkingCopy()

    def serve_step(params, cache, batch):
        with hooks.scope():
            return decode_step(cfg, working(params), cache, batch)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    working = _WorkingCopy()

    def prefill_step(params, batch):
        with hooks.scope():
            return prefill(cfg, working(params), batch)

    return prefill_step


def _split_micro(batch: dict, n: int) -> list:
    """``n`` batches of ``b // n`` rows each; raises unless n divides b."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible into {n} microbatches")
    return [{k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)] for k, x in batch.items()}
            for i in range(n)]


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    n_microbatches: int = 1,
    grad_dtype: torch.dtype = torch.float32,
):
    def value_and_grad(leaves, rebuild, batch):
        # detached aliases of the master leaves: the gradient is taken with
        # respect to them, and the caller's tensors gain no autograd state
        xs = [p.detach().requires_grad_() for p in leaves]
        val, _ = loss_fn(cfg, rebuild(xs), batch)
        return val.detach(), list(torch.autograd.grad(val, xs))

    def train_step(params, opt_state, batch):
        with hooks.scope():
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        leaves, rebuild = tree_flatten(params)
        if n_microbatches == 1:
            val, grads = value_and_grad(leaves, rebuild, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device) for p in leaves]
            vsum = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for mb in _split_micro(batch, n_microbatches):
                v, g = value_and_grad(leaves, rebuild, mb)
                for a, b in zip(grads, g):
                    a.add_(b.to(grad_dtype))
                vsum = vsum + v
            grads = [g / n_microbatches for g in grads]
            val = vsum / n_microbatches
        params, opt_state, opt_metrics = adamw_update(opt_cfg, rebuild(grads), opt_state, params)
        return params, opt_state, {"loss": val, **opt_metrics}

    return train_step


def init_train_state(cfg: ModelConfig, params):
    return adamw_init(params)
