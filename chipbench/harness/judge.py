"""Comparisons of the program's answers with the reference's.

Every comparison is exact (the placement is integer arithmetic): each
returns the number of entries that differ, and its limit is 0.  The
program's tensors are only read here, never handed to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from chipbench.reference.asura import widen
from chipbench.reference.tables import HierarchyModel, TableModel


def differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of ``got`` (any integer dtype) that differ from ``want``;
    a shape mismatch counts every entry of ``want``."""
    if tuple(got.shape) != tuple(want.shape):
        return int(want.numel())
    got = widen(got) if got.dtype == torch.uint32 else got.to(torch.int64)
    return int((got.to(want.device) != want.to(torch.int64)).sum())


def _cum_halves(len32: np.ndarray, width: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    row = np.zeros(width if width is not None else len(len32), dtype=np.uint64)
    row[: len(len32)] = len32
    cum = np.cumsum(row)
    return (cum >> np.uint64(32)).astype(np.int64), (cum & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _host(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.uint32:
        t = widen(t)
    return t.to(torch.int64).numpy()


def _count(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int((got != want).sum())


def flat_table(art, model: TableModel) -> int:
    """Entries of a flat table version the kernels read (lengths, owners,
    cumsum halves, top level) that differ from the model's."""
    len32, owner, top = model.arrays()
    hi, lo = _cum_halves(len32)
    bad = int(art.top_level != top)
    bad += _count(_host(art.len32_dev), len32.astype(np.int64))
    bad += _count(_host(art.node_of_dev), owner)
    bad += _count(_host(art.cum_hi_dev), hi) + _count(_host(art.cum_lo_dev), lo)
    return bad


def flat_table_host(len32: np.ndarray, node_of: np.ndarray, top: int, model: TableModel) -> int:
    """The same for a version's host arrays (a version that was evicted)."""
    want_len, want_owner, want_top = model.arrays()
    return (int(top != want_top) + _count(np.asarray(len32, dtype=np.int64), want_len.astype(np.int64))
            + _count(np.asarray(node_of, dtype=np.int64), want_owner))


def rack_tables(art, model: HierarchyModel) -> int:
    """Entries of a rack-aware version's device tables that differ from
    the model's: the table of racks (lengths; each segment's rack through
    the dense slots), and per rack its row of lengths, owners, cumsum
    halves, top level and id; the padding past each row must be empty."""
    top_len, top_slot, d_len, d_node, d_hi, d_lo, d_top, d_ids = (_host(t) for t in art.tables_dev)
    racks = model.rack_ids()
    width = art.s_pad
    bad = 0
    len32, owner, top = model.racks.arrays()
    n = len(len32)
    bad += int(art.top_level != top)
    bad += _count(top_len[:n], len32.astype(np.int64)) + int((top_len[n:] != 0).sum())
    slot_rack = np.where(top_slot[:n] >= 0, d_ids[np.clip(top_slot[:n], 0, None)], -1)
    bad += _count(slot_rack, owner) + int((top_slot[n:] != -1).sum())
    bad += _count(d_ids[: len(racks)], np.asarray(racks, dtype=np.int64))
    for i, rack in enumerate(racks):
        rl, ro, rt = model.nodes[rack].arrays()
        row = slice(i * width, (i + 1) * width)
        want_len = np.zeros(width, dtype=np.int64)
        want_len[: len(rl)] = rl
        want_own = np.full(width, -1, dtype=np.int64)
        want_own[: len(ro)] = ro
        hi, lo = _cum_halves(rl, width)
        bad += _count(d_len[row], want_len) + _count(d_node[row], want_own)
        bad += _count(d_hi[row], hi) + _count(d_lo[row], lo) + int(d_top[i] != rt)
    return bad
