"""Placement hooks: how the models meet a mesh without importing one.

The models call these where a mesh changes what a step must do:

  * ``constrain(x)`` on the residual stream (after the embedding, after
    every block, at every norm's input, on decode steps) and on tensors
    built whole on every rank (positions, the loss mask);
  * ``gather(p)`` on a layer's parameters (and the head) where they are
    used;
  * ``split_heads(x, dim, n)`` before a view splits dimension ``dim`` into
    ``n`` groups (attention heads, kv groups, RWKV heads), and
    ``merge_heads(x, dim, n)`` after a view merges them;
  * ``attend(fn, q, k, v, bias)`` around an attention kernel,
    ``wkv(fn, ...)`` around RWKV6's WKV and ``moe(fn, cfg, p, x)`` around
    the MoE layer;
  * ``embedding(tokens, table)`` for the token lookup, ``nll(logits,
    targets)`` for the cross-entropy's per-position terms and
    ``ring_write(buf, dim, slot, values)`` for a decode cache's ring slots;
  * ``scope()``: the context a step runs its body in.

With no placement registered they are the identity,
``F.embedding``, logsumexp minus the gathered gold logit, ``index_copy_``
and no context: an unsharded run sees exactly the tensors it always saw.

A launcher that shards the model registers a ``Placement`` here
(``repro_torch.launch.shardings.activation_constraint_fn`` makes the one of
a ``DeviceMesh``): ``constrain`` places the activation and its gradient
(the reference registers a ``with_sharding_constraint`` under its mesh),
``gather`` all-gathers FSDP shards, the head hooks reshard a dimension
whose sharding does not divide ``n`` (DTensor refuses such a view where
GSPMD reshards silently), ``attend`` and ``wkv`` run a per-head kernel on each rank's
own heads, ``moe`` each rank's token groups on its experts, and ``scope`` is DTensor's implicit replication,
so the models' plain-tensor constants act as replicated.
``repro_torch.models`` depends on no mesh or layout code.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


def _nll(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]


class Placement:
    """What a mesh registers.  The base class is the unsharded behaviour;
    a mesh's subclass overrides it."""

    def constrain(self, x):
        return x

    def gather(self, tree):
        return tree

    def split_heads(self, x, dim: int, n: int):
        return x

    def merge_heads(self, x, dim: int, n: int):
        return x

    def attend(self, fn, q, k, v, bias):
        return fn(q, k, v, bias)

    def moe(self, fn, cfg, p, x):
        return fn(cfg, p, x, cfg.moe)

    def wkv(self, fn, r, k, v, logw, u, head_dim: int, state):
        return fn(r, k, v, logw, u, head_dim, state)

    def embedding(self, tokens, table):
        return F.embedding(tokens, table)

    def nll(self, logits, targets):
        return _nll(logits, targets)

    def ring_write(self, buf, dim: int, slot, values) -> None:
        buf.index_copy_(dim, slot, values)

    def scope(self):
        return contextlib.nullcontext()


_UNSHARDED = Placement()
_PLACEMENT: Optional[Placement] = None


def set_constraint(placement: Optional[Placement]) -> None:
    """Register a ``Placement``, or None."""
    global _PLACEMENT
    _PLACEMENT = placement


def _current() -> Placement:
    return _UNSHARDED if _PLACEMENT is None else _PLACEMENT


def constrain(x: torch.Tensor) -> torch.Tensor:
    return _current().constrain(x)


def gather(tree):
    """A layer's parameters (a tensor or a dict of them) ready for use."""
    return _current().gather(tree)


def split_heads(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready for a view that splits dimension ``dim`` into ``n``."""
    return _current().split_heads(x, dim, n)


def merge_heads(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x``, whose dimension ``dim`` a view just merged from ``n`` groups;
    on a mesh its gradient is made ready for backward's split."""
    return _current().merge_heads(x, dim, n)


def attend(fn, q, k, v, bias):
    """``fn(q, k, v, bias)``: an attention kernel over (B, S, H, D) heads;
    on a mesh each rank runs it on its own heads where they divide."""
    return _current().attend(fn, q, k, v, bias)


def moe(fn, cfg, p, x):
    """``fn(cfg, p, x, cfg.moe)``: the MoE layer -> (y, aux); on a mesh
    each rank dispatches its own token groups to its own experts where the
    groups divide."""
    return _current().moe(fn, cfg, p, x)


def wkv(fn, r, k, v, logw, u, head_dim: int, state):
    """``fn(r, k, v, logw, u, head_dim, state)``: RWKV6's chunked WKV over
    (B, S, H * head_dim) -> (out, state); on a mesh each rank runs it on
    its own heads where they divide."""
    return _current().wkv(fn, r, k, v, logw, u, head_dim, state)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``."""
    return _current().embedding(tokens, table)


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp(logits) - logits[target]`` over the last
    (vocab) dimension."""
    return _current().nll(logits, targets)


def ring_write(buf: torch.Tensor, dim: int, slot: torch.Tensor, values: torch.Tensor) -> None:
    """``buf.index_copy_(dim, slot, values)``: ring slots written in place."""
    _current().ring_write(buf, dim, slot, values)


def scope():
    """The context a step runs its body in."""
    return _current().scope()


class activation_sharding:
    """Context manager: register a placement."""

    def __init__(self, placement: Placement):
        self.placement = placement

    def __enter__(self):
        set_constraint(self.placement)
        return self

    def __exit__(self, *exc):
        set_constraint(None)
        return False
