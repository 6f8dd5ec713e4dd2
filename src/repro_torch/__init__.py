"""ASURA placement and serving on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas reference package, module for module: ``core``
(cluster, host oracles, ``PlacementEngine``), ``kernels`` (hand-written
CUDA kernels + plain-torch twins), ``obs`` (metrics slab, trace ledger),
``migrate`` (planner, throttled mover, dual-version serving window),
``serve`` (traffic, serving driver, router) and ``convert`` (carrying the
reference's cluster and tables across).  Imports torch and numpy only;
entry points run on the CUDA card unless given ``device="cpu"``.
"""

from . import convert, core, kernels, migrate, obs, serve

__all__ = ["convert", "core", "kernels", "migrate", "obs", "serve"]
