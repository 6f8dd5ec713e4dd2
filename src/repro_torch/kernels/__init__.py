"""Hand-written CUDA kernels for Hopper, their wrappers and plain-torch twins.

``asura_place`` holds the wrappers (launch counters in ``LAUNCHES``),
``ref`` the twins, ``ops`` the table-level entry points, ``build`` the
``nvcc`` build at first use.  Nothing is compiled at import time.
"""

from .asura_place import (
    LAUNCHES,
    diff_nodes_cuda,
    diff_replicas_cuda,
    place_fused_cuda,
    place_replicas_cuda,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "diff_nodes_cuda",
    "diff_replicas_cuda",
    "place_fused_cuda",
    "place_replicas_cuda",
    "reset_launches",
]
