"""Wrappers of the serving driver's select-and-count kernels (``csrc/serve.cu``).

``select_count_cuda`` (SC) replaces no TPU kernel: the reference serves a
batch's replica choice and its per-node histogram as one jit of jnp ops
(``serve/stream.py`` ``_route_batch_fn``).  It picks one holder per lane
(``primary``, ``random`` or ``pow2`` against the start-of-batch counts)
and adds each lane below ``n_valid`` to the int32 histogram ``hist``, in
one launch.  ``count_update_cuda`` folds that histogram into the load
state: fresh ``counts + hist`` and ``max(queue + hist - service, 0)``,
the queue written into a row of the history ring in place, ``hist``
handed back zeroed.  Their plain-torch twins are ``serve/stream.py``'s
``select_count_twin`` and ``count_update_twin``, which the driver takes
for CPU tensors.  Both follow the contract of ``asura_place.py``: checks
first; outputs from ``torch.empty`` on the current stream, no
synchronisation; a non-zero launch status raises; one added to
``LAUNCHES["select_count"]`` / ``LAUNCHES["count_update"]`` per launch
and nowhere else.  The owners and the selection words may come at any
strides (a generated batch's words are a column of its two words a lane,
the hierarchical kernel's node plane comes transposed): nothing is copied.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .asura_place import LAUNCHES, _check, _raise_on, _stream

LAUNCHES.update({"select_count": 0, "count_update": 0})

POLICY_CODES = {"primary": 0, "random": 1, "pow2": 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("serve")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.serve_select_count.argtypes = [p, i64, i64, p, i64, p, p, p, i64, i64] + [i32] * 3 + [p]
    lib.serve_select_count.restype = i32
    lib.serve_count_update.argtypes = [p] * 7 + [i32, p]
    lib.serve_count_update.restype = i32
    return lib


def _on_cuda(fn: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{fn} runs on cuda, not {dev}")


def select_count_cuda(
    owners: torch.Tensor,
    sel: torch.Tensor,
    counts: torch.Tensor,
    hist: torch.Tensor,
    *,
    policy: str,
    n_replicas: int,
    n_valid: int,
) -> torch.Tensor:
    """One holder per lane -> (n,) int32 chosen nodes; adds 1 to
    ``hist[chosen]`` for each lane below ``n_valid``.

    ``owners`` is (n, R) int32 with -1 for unfilled slots, ``sel`` the
    (n,) int64 u32 selection words, ``counts`` and ``hist`` (n_bins,)
    int32.  Node ids must lie below n_bins: the kernel neither reads nor
    counts a bin outside the planes."""
    if not isinstance(owners, torch.Tensor):
        raise TypeError(f"owners must be a torch.Tensor, got {type(owners).__name__}")
    dev = owners.device
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if owners.dtype != torch.int32:
        raise TypeError(f"owners must be torch.int32, got {owners.dtype}")
    if owners.dim() != 2 or owners.shape[1] != R:
        raise ValueError(f"owners must be (n, {R}), got {tuple(owners.shape)}")
    n = owners.shape[0]
    if not isinstance(sel, torch.Tensor):
        raise TypeError(f"sel must be a torch.Tensor, got {type(sel).__name__}")
    if sel.dtype != torch.int64:
        raise TypeError(f"sel must be torch.int64, got {sel.dtype}")
    if sel.device != dev:
        raise ValueError(f"sel is on {sel.device}, owners are on {dev}")
    if sel.dim() != 1 or sel.shape[0] != n:
        raise ValueError(f"sel must be 1-D of length {n}, got {tuple(sel.shape)}")
    n_bins = counts.shape[0] if isinstance(counts, torch.Tensor) and counts.dim() == 1 else 0
    _check("counts", counts, torch.int32, dev, n_bins)
    _check("hist", hist, torch.int32, dev, n_bins)
    if not 1 <= n_bins < 2**31:
        raise ValueError(f"counts must hold 1 .. 2**31-1 bins, got {n_bins}")
    if policy not in POLICY_CODES:
        raise ValueError(f"policy must be one of {tuple(POLICY_CODES)}, got {policy!r}")
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid must lie in [0, {n}], got {n_valid}")
    _on_cuda("select_count_cuda", dev)
    chosen = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return chosen
    rc = _lib().serve_select_count(
        owners.data_ptr(), owners.stride(0), owners.stride(1), sel.data_ptr(), sel.stride(0),
        counts.data_ptr(), chosen.data_ptr(), hist.data_ptr(), n, int(n_valid), R,
        POLICY_CODES[policy], n_bins, _stream(dev),
    )
    _raise_on(rc, "serve_select_count")
    LAUNCHES["select_count"] += 1
    return chosen


def count_update_cuda(
    hist: torch.Tensor,
    counts: torch.Tensor,
    queue: torch.Tensor,
    service: torch.Tensor,
    qrow: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (counts + hist, max(queue + hist - service, 0)) as new (n_bins,)
    int32 tensors, with int32 wrap; the queue is also written into
    ``qrow`` (a row of the history ring) and ``hist`` is zeroed, in
    place."""
    dev = hist.device if isinstance(hist, torch.Tensor) else None
    n_bins = hist.shape[0] if isinstance(hist, torch.Tensor) and hist.dim() == 1 else 0
    for name, t in (("hist", hist), ("counts", counts), ("queue", queue),
                    ("service", service), ("qrow", qrow)):
        _check(name, t, torch.int32, dev, n_bins)
    if not 1 <= n_bins < 2**31:
        raise ValueError(f"hist must hold 1 .. 2**31-1 bins, got {n_bins}")
    _on_cuda("count_update_cuda", dev)
    counts_out = torch.empty_like(counts)
    queue_out = torch.empty_like(queue)
    rc = _lib().serve_count_update(
        hist.data_ptr(), counts.data_ptr(), queue.data_ptr(), service.data_ptr(),
        counts_out.data_ptr(), queue_out.data_ptr(), qrow.data_ptr(), n_bins, _stream(dev),
    )
    _raise_on(rc, "serve_count_update")
    LAUNCHES["count_update"] += 1
    return counts_out, queue_out
