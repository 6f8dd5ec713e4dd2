"""Hand-written CUDA kernels for Hopper, their wrappers and plain-torch twins.

``asura_place`` and ``baselines`` hold the wrappers (launch counters in
``LAUNCHES``), ``ref`` and ``baselines_ref`` the twins, ``ops`` the
table-level entry points, ``build`` the ``nvcc`` build at first use.
Nothing is compiled at import time.
"""

from .asura_place import (
    LAUNCHES,
    diff_nodes_cuda,
    diff_replicas_cuda,
    place_fused_cuda,
    place_replicas_cuda,
    reset_launches,
)
from .baselines import (
    baseline_replicas_cuda,
    ch_place_cuda,
    rs_place_cuda,
    wrh_place_cuda,
)

__all__ = [
    "LAUNCHES",
    "baseline_replicas_cuda",
    "ch_place_cuda",
    "diff_nodes_cuda",
    "diff_replicas_cuda",
    "place_fused_cuda",
    "place_replicas_cuda",
    "reset_launches",
    "rs_place_cuda",
    "wrh_place_cuda",
]
