"""ASURA placement and serving on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas reference package, module for module: ``core``
(cluster, host oracles, ``PlacementEngine``), ``kernels`` (hand-written
CUDA kernels + plain-torch twins), ``obs`` (metrics slab, trace ledger),
``migrate`` (planner, throttled mover, dual-version serving window),
``serve`` (traffic, serving driver, router), the consumers of placement
-- ``runtime`` (elastic coordinator, failure detection, stragglers,
durability simulator), ``data`` (sharded pipeline) and ``checkpoint``
(replicated checkpoint store) -- the language models (``configs``,
``models``, ``train``: dense, MoE and MLA; served by ``launch.serve``,
trained by ``launch.train``), and
``convert`` (carrying the reference's cluster, tables, stores and model
trees across).  Imports torch and numpy only;
entry points run on the CUDA card unless given ``device="cpu"``.
"""

from . import (
    checkpoint, configs, convert, core, data, kernels, migrate, models, obs, runtime, serve, train,
)

__all__ = [
    "checkpoint", "configs", "convert", "core", "data", "kernels", "migrate", "models", "obs",
    "runtime", "serve", "train",
]
