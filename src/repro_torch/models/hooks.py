"""Activation-placement hook.

Models call ``constrain(x)`` on the residual stream (after the embedding,
after every block, on decode steps).  By default it is the identity.  A
launcher that shards the model over several cards registers a function
here that places the activation (the reference registers a
``with_sharding_constraint`` under its mesh), so ``repro_torch.models``
depends on no mesh or layout code.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_CONSTRAIN: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def set_constraint(fn: Optional[Callable[[torch.Tensor], torch.Tensor]]) -> None:
    global _CONSTRAIN
    _CONSTRAIN = fn


def constrain(x: torch.Tensor) -> torch.Tensor:
    if _CONSTRAIN is None:
        return x
    return _CONSTRAIN(x)


class activation_sharding:
    """Context manager: register a constraint function."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.fn = fn

    def __enter__(self):
        set_constraint(self.fn)
        return self

    def __exit__(self, *exc):
        set_constraint(None)
        return False
