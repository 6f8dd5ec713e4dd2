"""Wrapper of the hand-written two-level kernel (``csrc/hierarchy.cu``).

``hier_place_replicas_cuda`` replaces the reference's
``hier_place_replicas_pallas``: for every id, the section-5.A draw of R
distinct DOMAINS over the domain table, then one salted placement per
replica in that domain's own table -> (2, R, n) int32 (plane 0 domain
ids, plane 1 node ids, -1 for a slot level 1 did not fill).  It follows
the contract of ``asura_place.py``: the plain-torch twin
(``hierarchy_ref.py``) only for CPU tensors; for CUDA tensors it launches
the kernel or raises; checks first; outputs from ``torch.empty`` on the
current stream, no synchronisation; a non-zero launch status raises; one
added to ``LAUNCHES["hier_replicas"]`` per launch and nowhere else.

``hier_tables_prep`` builds the eight device tables from one hierarchy
version's host arrays, laid out as the reference's engine lays them out
(so a reference artifact's tables carry over unchanged): the domain table
lane-padded with its node ids re-mapped to dense domain SLOTS, and the
per-domain tables stacked at a row stride ``s_pad`` (the largest domain's
length, lane-padded) with zero lengths, -1 nodes and the u64 cumsum
carried at the domain's total through the padding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.asura import tail_cumsum_halves
from ..device import resolve_device
from . import build
from .asura_place import LAUNCHES, _check, _check_ladder, _raise_on, _stream
from .hierarchy_ref import hier_place_replicas_ref

LANE = 128  # the reference's table padding unit

LAUNCHES.update({"hier_replicas": 0})

_TABLES = (
    ("top_len32", torch.uint32), ("top_slot_of", torch.int32),
    ("dom_len32", torch.uint32), ("dom_node", torch.int32),
    ("dom_cum_hi", torch.uint32), ("dom_cum_lo", torch.uint32),
    ("dom_top", torch.int32), ("dom_ids", torch.int32),
)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("hierarchy")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hier_place_replicas.argtypes = [p] * 12 + [i64] + [i32] * 6 + [p]
    lib.hier_place_replicas.restype = i32
    return lib


def _lane_pad(x: np.ndarray, fill) -> np.ndarray:
    return np.concatenate([x, np.full((-x.shape[0]) % LANE, fill, dtype=x.dtype)])


def hier_tables_prep(
    top_len32, top_slot_of, dom_len32_rows, dom_node_rows, dom_tops, domain_ids,
    *, device=None,
) -> tuple[tuple, int]:
    """One hierarchy version's host arrays -> (the eight device tables in
    the kernel's operand order, ``s_pad``).

    ``top_len32`` / ``top_slot_of``: the domain table's u32 lengths and
    dense domain slots (-1 on holes); ``dom_len32_rows`` /
    ``dom_node_rows``: one (u32 lengths, node ids) pair per domain, in slot
    order; ``dom_tops`` / ``domain_ids``: per-slot top level and domain
    id."""
    dev = resolve_device(device)
    s_pad = -(-max(len(row) for row in dom_len32_rows) // LANE) * LANE
    D = len(dom_len32_rows)
    len_flat = np.zeros(D * s_pad, dtype=np.uint32)
    node_flat = np.full(D * s_pad, -1, dtype=np.int32)
    cum_hi = np.zeros(D * s_pad, dtype=np.uint32)
    cum_lo = np.zeros(D * s_pad, dtype=np.uint32)
    for i, (row, nodes) in enumerate(zip(dom_len32_rows, dom_node_rows)):
        base = i * s_pad
        len_flat[base : base + len(row)] = row
        node_flat[base : base + len(nodes)] = nodes
        padded = np.zeros(s_pad, dtype=np.uint32)
        padded[: len(row)] = row
        cum_hi[base : base + s_pad], cum_lo[base : base + s_pad] = tail_cumsum_halves(padded)
    host = (
        _lane_pad(np.asarray(top_len32, dtype=np.uint32), np.uint32(0)),
        _lane_pad(np.asarray(top_slot_of, dtype=np.int32), np.int32(-1)),
        len_flat, node_flat, cum_hi, cum_lo,
        _lane_pad(np.asarray(dom_tops, dtype=np.int32), np.int32(0)),
        _lane_pad(np.asarray(domain_ids, dtype=np.int32), np.int32(0)),
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host), s_pad


def hier_place_replicas_cuda(
    ids: torch.Tensor,
    top_len32: torch.Tensor,
    top_slot_of: torch.Tensor,
    dom_len32: torch.Tensor,
    dom_node: torch.Tensor,
    dom_cum_hi: torch.Tensor,
    dom_cum_lo: torch.Tensor,
    dom_top: torch.Tensor,
    dom_ids: torch.Tensor,
    *,
    top_level: int,
    max_top: int,
    s_pad: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
) -> torch.Tensor:
    """Two-level replication -> (2, R, n) int32 (domain ids, node ids).

    ``top_len32`` / ``top_slot_of``: the domain table (uint32 lengths,
    int32 dense domain slots); ``dom_len32`` / ``dom_node`` /
    ``dom_cum_hi`` / ``dom_cum_lo``: the (D * s_pad,) stacked per-domain
    tables (uint32, int32, uint32, uint32); ``dom_top`` / ``dom_ids``:
    per-slot int32 top level and domain id (at least D entries)."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    tables = (top_len32, top_slot_of, dom_len32, dom_node, dom_cum_hi, dom_cum_lo,
              dom_top, dom_ids)
    # three groups of equal length: the domain table, the stacked rows and
    # the per-slot vectors; each group's length is its first table's
    group = (0, 0, 2, 2, 2, 2, 6, 6)
    lengths = [t.shape[0] if isinstance(t, torch.Tensor) else 0 for t in tables]
    for (name, dtype), t, g in zip(_TABLES, tables, group):
        _check(name, t, dtype, dev, lengths[g])
    n_segs_top, d_flat, d_pad = lengths[0], lengths[2], lengths[6]
    if not (s_pad >= 1 and d_flat % s_pad == 0 and d_flat // s_pad <= d_pad):
        raise ValueError(
            f"stacked tables of length {d_flat} need a row stride s_pad dividing "
            f"it, with a top level and id per row ({d_pad} given); s_pad={s_pad}"
        )
    _check_ladder(n_segs_top, top_level, s_log2, max_draws)
    _check_ladder(s_pad, max_top, s_log2, max_draws)
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    kw = dict(top_level=top_level, max_top=max_top, s_log2=s_log2,
              max_draws=max_draws, s_pad=s_pad, n_replicas=R)
    if dev.type == "cpu":
        return hier_place_replicas_ref(ids, *tables, **kw)
    if dev.type != "cuda":
        raise ValueError(f"hier_place_replicas_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((2, R, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # R > 8: each lane keeps its level-1 picks in its own rows of these
    scratch = (
        [torch.empty((n, R), dtype=torch.int32, device=dev) for _ in range(2)]
        if R > 8 else [None, None]
    )
    rc = _lib().hier_place_replicas(
        ids.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
        *(None if s is None else s.data_ptr() for s in scratch),
        n, n_segs_top, top_level, s_pad, s_log2, max_draws, R, _stream(dev),
    )
    _raise_on(rc, "hier_place_replicas")
    LAUNCHES["hier_replicas"] += 1
    return out
