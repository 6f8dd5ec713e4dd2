"""Wrapper of the hand-written selection-word kernel (``csrc/traffic.cu``).

``lane_words_cuda`` replaces no TPU kernel: the reference draws the
serving driver's per-request words with ``jax.random`` in jnp.  It gives
``TrafficModel.lane_words``'s result for CUDA tensors in one launch: the
``(n, n_words)`` int64 u32 words ``bits(fold_in(batch_key, lane),
(n_words,))`` for ``n_words`` 1 or 2, with the batch key
``fold_in(root_key, step)`` computed on the host.  Its plain-torch twin
is ``serve/traffic.py``'s ``lane_words_twin``, which
``TrafficModel.lane_words`` takes for CPU tensors.  It follows the
contract of ``asura_place.py``: checks first; output from ``torch.empty``
on the current stream, no synchronisation; a non-zero launch status
raises; one added to ``LAUNCHES["lane_words"]`` per launch and nowhere
else.  Lanes are not padded: the kernel masks the ragged edge itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .asura_place import LAUNCHES, _check, _raise_on, _stream
from .u32 import M32

LAUNCHES.update({"lane_words": 0})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("traffic")
    p, u32, i32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int64
    lib.traffic_lane_words.argtypes = [u32, u32, p, p, i64, i32, p]
    lib.traffic_lane_words.restype = i32
    return lib


def lane_words_cuda(batch_key, lanes: torch.Tensor, n_words: int) -> torch.Tensor:
    """(len(lanes), n_words) int64 u32 words of the lanes (their values
    mod 2**32) under the u32 pair ``batch_key``, on the lanes' CUDA
    device."""
    dev = lanes.device if isinstance(lanes, torch.Tensor) else None
    _check("lanes", lanes, torch.int64, dev)
    if n_words not in (1, 2):
        raise ValueError(f"n_words must be 1 or 2, got {n_words}")
    k0, k1 = (int(k) for k in batch_key)
    if not (0 <= k0 <= M32 and 0 <= k1 <= M32):
        raise ValueError(f"batch_key must be two u32 values, got {batch_key}")
    if dev.type != "cuda":
        raise ValueError(f"lane_words_cuda runs on cuda, not {dev}")
    n = lanes.shape[0]
    out = torch.empty((n, n_words), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    rc = _lib().traffic_lane_words(k0, k1, lanes.data_ptr(), out.data_ptr(), n, n_words,
                                   _stream(dev))
    _raise_on(rc, "traffic_lane_words")
    LAUNCHES["lane_words"] += 1
    return out
