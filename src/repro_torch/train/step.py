"""Serve and prefill step factories of the port (the serving half of the
reference's ``repro.train.step``).

``make_serve_step(cfg)`` -> step(params, cache, batch) -> (logits, cache):
one-token decode against a cache, which the step consumes (it is updated
in place).  ``make_prefill_step(cfg)`` -> step(params, batch) -> the
last-position logits.

Each step keeps one bf16 working copy of the matmul weights (embedding,
head, attention and MLP matrices), made the first time it sees a
parameter tree and reused while the same tree object comes back; a tree
changed in place needs a new step.  The reference casts every weight to
bf16 inside each call (``p["w_q"].astype(dt)``); the cast is
deterministic, so the copy holds the same bits and the layers' own casts
become no-ops.  Norm scales and biases stay fp32, since the norms
multiply by them in fp32.
"""

from __future__ import annotations

from ..models import decode_step, prefill
from ..models.config import ModelConfig
from ..models import layers


def _is_matmul_weight(name: str) -> bool:
    return name in ("embed", "lm_head") or name.startswith("w_")


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
        return decode_step(cfg, working(params), cache, batch)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    working = _WorkingCopy()

    def prefill_step(params, batch):
        return prefill(cfg, working(params), batch)

    return prefill_step
