"""Hand-written CUDA kernels for Hopper, their wrappers and plain-torch twins.

``asura_place``, ``baselines``, ``hierarchy``, ``traffic`` and ``serve`` hold
the wrappers (launch counters in ``LAUNCHES``), ``ref``, ``baselines_ref`` and
``hierarchy_ref`` the twins (``traffic``'s is ``serve/traffic.py::lane_words_twin``,
``serve``'s are ``serve/stream.py``'s ``select_count_twin`` and ``count_update_twin``),
``ops`` the table-level entry points, ``build`` the ``nvcc`` build at first use.
Nothing is compiled at import time.
"""

from .asura_place import (
    LAUNCHES,
    addition_numbers_cuda,
    diff_nodes_cuda,
    diff_replicas_aligned_cuda,
    diff_replicas_cuda,
    place_cuda,
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
from .hierarchy import hier_place_replicas_cuda
from .hierarchy_ref import hier_place_replicas_ref
from .serve import count_update_cuda, select_count_cuda
from .traffic import lane_words_cuda

__all__ = [
    "LAUNCHES",
    "addition_numbers_cuda",
    "baseline_replicas_cuda",
    "ch_place_cuda",
    "count_update_cuda",
    "diff_nodes_cuda",
    "diff_replicas_aligned_cuda",
    "diff_replicas_cuda",
    "hier_place_replicas_cuda",
    "hier_place_replicas_ref",
    "lane_words_cuda",
    "place_cuda",
    "place_fused_cuda",
    "place_replicas_cuda",
    "reset_launches",
    "rs_place_cuda",
    "select_count_cuda",
    "wrh_place_cuda",
]
