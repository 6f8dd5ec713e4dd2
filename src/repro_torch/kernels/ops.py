"""Public entry points for batched ASURA placement and replication.

Two tiers, as in the reference:

  * ``*_on_table_device`` -- the device-resident path: placement, the
    non-converged tail and, for the node variants, the seg->node gather
    run in one kernel launch and return a device tensor with no host sync
    (the path the ``PlacementEngine`` device variants and the serving
    driver use);
  * ``place_on_table`` / ``place_replicas_on_table`` -- host-facing: the
    same launch plus exactly one device->host copy of the result.

The migration planner's two-version diffs (``diff_nodes_on_tables_device``,
``diff_replicas_on_tables_device``) place every id under two tables in
one launch; the replica diff's launch also aligns the two sets per slot
(the reference leaves that alignment outside its Pallas kernels, and
``align_replica_sets`` here is its plain-torch form, which CPU tables and
the hierarchical diff run).  The ADDITION NUMBER
trace (``addition_numbers_on_table_device``), jnp in the reference, is one
launch of its own kernel.

The failure-domain-aware (two-level) entry points
(``hier_place_replicas_on_tables[_device]``,
``hier_diff_replicas_on_tables_device``) take a hierarchy version's eight
prepped tables (``kernels.hierarchy.hier_tables_prep``) and run kernel B8
(its plain-torch twin for CPU tables, as every wrapper does).

``table_prep`` / ``node_table_prep`` / ``tail_prep`` build the device
tables once per table version on the host; ``asura_place*`` are the
table-deriving conveniences.  Tables are not lane-padded: the kernels
test ``k < n_segs`` against the real table length.

The baselines' entry points (``baseline_place_on_table[_device]``,
``baseline_place_replicas_on_table_device``) take an algorithm's two
prepped tables (``kernels.baselines.*_table_prep``): (ring, owners) for
``ch``, (starts, owners) for ``rs``, (salts, inv_w) for ``wrh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.asura import (
    DEFAULT_PARAMS,
    AsuraParams,
    _upper_bound,
    lengths_to_u32,
    tail_cumsum_halves,
)
from ..device import resolve_device
from ..obs.trace import maybe_span
from .asura_place import (
    addition_numbers_cuda,
    diff_nodes_cuda,
    diff_replicas_aligned_cuda,
    place_fused_cuda,
    place_replicas_cuda,
)
from .baselines import REPLICA_MAX_TRIES, baseline_place_cuda, baseline_replicas_cuda
from .hierarchy import hier_place_replicas_cuda
from .u32 import as_u32, to_u32

__all__ = [
    "as_ids",
    "table_prep",
    "node_table_prep",
    "tail_prep",
    "place_on_table",
    "place_on_table_device",
    "place_nodes_on_table_device",
    "place_replicas_on_table",
    "place_replicas_on_table_device",
    "diff_nodes_on_tables_device",
    "diff_replicas_on_tables_device",
    "addition_numbers_on_table_device",
    "baseline_place_on_table",
    "baseline_place_on_table_device",
    "baseline_place_replicas_on_table_device",
    "hier_place_replicas_on_tables_device",
    "hier_place_replicas_on_tables",
    "hier_diff_replicas_on_tables_device",
    "asura_place",
    "asura_place_nodes",
    "asura_place_replicas",
]


def as_ids(datum_ids, device) -> torch.Tensor:
    """Datum ids -> a contiguous 1-D ``uint32`` tensor on ``device``.

    Integer tensors of any dtype are taken mod 2**32 where they lie (no
    host round trip); host sequences are cast as NumPy casts to uint32."""
    if isinstance(datum_ids, torch.Tensor):
        t = datum_ids if datum_ids.dtype == torch.uint32 else to_u32(as_u32(datum_ids))
        return t.reshape(-1).to(device).contiguous()
    arr = np.ascontiguousarray(np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32)))
    return torch.from_numpy(arr).to(device)


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)).to(device)


def table_prep(seg_lengths, params: AsuraParams = DEFAULT_PARAMS, *, device=None):
    """Host-side: canonical u32 length table on ``device`` + the static top
    level (``lengths_to_u32`` validates lengths in [0, 1))."""
    lengths = np.asarray(seg_lengths, dtype=np.float64)
    top_level = params.level_for(_upper_bound(lengths))
    return _u32_tensor(lengths_to_u32(lengths), resolve_device(device)), top_level


def node_table_prep(seg_to_node, *, device=None) -> torch.Tensor:
    """Host-side: int32 seg->node map on ``device`` (-1 on holes)."""
    node_of = np.ascontiguousarray(np.asarray(seg_to_node, dtype=np.int32))
    return torch.from_numpy(node_of).to(resolve_device(device))


def tail_prep(len32, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-side: the u64 length-cumsum as two u32 halves on ``device``,
    computed once per table version (DESIGN.md section 3.2)."""
    if isinstance(len32, torch.Tensor):
        len32 = len32.cpu().numpy()
    cum_hi, cum_lo = tail_cumsum_halves(np.asarray(len32, dtype=np.uint32))
    dev = resolve_device(device)
    return _u32_tensor(cum_hi, dev), _u32_tensor(cum_lo, dev)


def place_on_table_device(
    datum_ids,
    len32: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    node_of: torch.Tensor | None = None,
    *,
    top_level: int,
    params: AsuraParams = DEFAULT_PARAMS,
    emit_nodes: bool = False,
) -> torch.Tensor:
    """Device-resident total placement -> (batch,) int32 on the tables'
    device; node ids with ``emit_nodes`` (needs ``node_of``)."""
    if emit_nodes and node_of is None:
        raise ValueError("emit_nodes=True requires the node table")
    if node_of is None:
        node_of = torch.full(len32.shape, -1, dtype=torch.int32, device=len32.device)
    return place_fused_cuda(
        as_ids(datum_ids, len32.device), len32, cum_hi, cum_lo, node_of,
        top_level=top_level, s_log2=params.s_log2, max_draws=params.max_draws,
        emit_nodes=emit_nodes,
    )


def place_nodes_on_table_device(
    datum_ids, len32, cum_hi, cum_lo, node_of, **kwargs
) -> torch.Tensor:
    """Device-resident placement straight to node ids (fused gather)."""
    return place_on_table_device(
        datum_ids, len32, cum_hi, cum_lo, node_of, emit_nodes=True, **kwargs
    )


def place_on_table(
    datum_ids,
    len32: torch.Tensor,
    *,
    top_level: int,
    cum_hi: torch.Tensor | None = None,
    cum_lo: torch.Tensor | None = None,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Placement against a prebuilt table -> int64 segments on the host
    (one device->host copy).  The tail tables are derived here if not
    given."""
    if cum_hi is None or cum_lo is None:
        cum_hi, cum_lo = tail_prep(len32, device=len32.device)
    segs = place_on_table_device(
        datum_ids, len32, cum_hi, cum_lo, top_level=top_level, params=params
    )
    return segs.cpu().numpy().astype(np.int64)


def place_replicas_on_table_device(
    datum_ids,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    n_replicas: int,
    *,
    top_level: int,
    params: AsuraParams = DEFAULT_PARAMS,
    emit_nodes: bool = False,
    emit_stats: bool = False,
):
    """Device-resident replica placement -> (batch, R) int32 (segments, or
    nodes with ``emit_nodes``); -1 marks unfilled slots, which the device
    path documents instead of checking (a check would sync).
    ``emit_stats`` also returns the uint32 ``[depth_hist..., nonconverged]``
    vector."""
    return place_replicas_cuda(
        as_ids(datum_ids, len32.device), len32, node_of,
        top_level=top_level, s_log2=params.s_log2, max_draws=params.max_draws,
        n_replicas=n_replicas, emit_nodes=emit_nodes, emit_stats=emit_stats,
    )


def place_replicas_on_table(
    datum_ids,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    n_replicas: int,
    *,
    top_level: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> np.ndarray:
    """Replica placement -> (batch, R) int64 segments on the host; raises
    when a lane did not find R distinct nodes, as the NumPy path does."""
    out = place_replicas_on_table_device(
        datum_ids, len32, node_of, n_replicas, top_level=top_level, params=params
    ).cpu().numpy().astype(np.int64)
    if (out < 0).any():
        raise RuntimeError("replication did not converge; too few distinct nodes?")
    return out


def diff_nodes_on_tables_device(
    datum_ids,
    len32_a: torch.Tensor,
    cum_hi_a: torch.Tensor,
    cum_lo_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    cum_hi_b: torch.Tensor,
    cum_lo_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Version diff against two prebuilt tables -> ``(moved, src, dst)``.

    Every id is placed under table A (version v) and table B (v+1) in one
    launch; ``src`` / ``dst`` are int32 node ids under v / v+1 and
    ``moved = src != dst``.  All three stay on the tables' device with no
    host sync -- ``plan_stream`` chains chunks of this."""
    out = diff_nodes_cuda(
        as_ids(datum_ids, len32_a.device),
        len32_a, cum_hi_a, cum_lo_a, node_a,
        len32_b, cum_hi_b, cum_lo_b, node_b,
        top_a=top_a, top_b=top_b, s_log2=params.s_log2,
        max_draws=params.max_draws,
    )
    src, dst = out[0], out[1]
    return src != dst, src, dst


def align_replica_sets(
    before: torch.Tensor, after: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot minimal alignment of two (batch, R) replica-node sets
    -> ``(moved, src, dst, src_slot)``, all (batch, R).

    The device twin of ``core.asura.align_replica_sets`` (same exact
    integer formulation: (batch, R, R) compares, exclusive ranks,
    ``where``):
    slots index the AFTER set; ``moved[b, r]`` iff ``after[b, r]`` is not in
    ``before[b, :]``, ``src`` is the rank-matched vacated node for moved
    slots (``after[b, r]`` itself otherwise), ``src_slot`` its before-set
    position (rollback re-indexing); ``dst`` is ``after`` as int32."""
    with maybe_span(None, "ops.align_replica_sets"):
        before = before.to(torch.int32)
        after = after.to(torch.int32)
        R = after.shape[1]
        new = ~(after[:, :, None] == before[:, None, :]).any(dim=2)
        lost = ~(before[:, :, None] == after[:, None, :]).any(dim=2)
        # exclusive ranks as a masked sum, not a cumsum: torch's scan over a
        # short innermost dimension takes ~10 ms per 2**20 rows on an H100,
        # ~20x the rest of the alignment together
        earlier = torch.ones((R, R), dtype=torch.bool, device=after.device).tril(-1)  # j < r
        rank_new = (new[:, None, :] & earlier).sum(dim=2, dtype=torch.int32)
        rank_lost = (lost[:, None, :] & earlier).sum(dim=2, dtype=torch.int32)
        match = lost[:, None, :] & (rank_lost[:, None, :] == rank_new[:, :, None])
        zero = torch.zeros((), dtype=torch.int32, device=after.device)
        picked_src = torch.where(match, before[:, None, :], zero).sum(dim=2, dtype=torch.int32)
        slots = torch.arange(R, dtype=torch.int32, device=after.device)
        picked_slot = torch.where(match, slots[None, None, :], zero).sum(dim=2, dtype=torch.int32)
        src = torch.where(new, picked_src, after)
        src_slot = torch.where(new, picked_slot, slots[None, :])
        return new, src, after, src_slot


def diff_replicas_on_tables_device(
    datum_ids,
    len32_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replica-set version diff against two prebuilt tables
    -> ``(moved, src, dst, src_slot)``, each (batch, R) on the tables'
    device, no host sync.

    Every id's full R-replica set is placed under table A (v) and table B
    (v+1) and the two sets are aligned per slot in one launch (on CPU
    tables the twin, then ``align_replica_sets``): a row moves exactly when
    its slot's owner changed -- the section-5 minimal replica mass."""
    return diff_replicas_aligned_cuda(
        as_ids(datum_ids, len32_a.device), len32_a, node_a, len32_b, node_b,
        top_a=top_a, top_b=top_b, s_log2=params.s_log2,
        max_draws=params.max_draws, n_replicas=n_replicas,
    )


def addition_numbers_top(
    top_level: int, *, extra_levels: int | None = None,
    params: AsuraParams = DEFAULT_PARAMS,
) -> int:
    """The top level of the ADDITION-NUMBER trace's ladder: the table's
    ``top_level`` plus ``extra_levels`` (default: up to 4, capped by the
    2**31 segment-space bound)."""
    if extra_levels is None:
        extra_levels = max(0, min(4, 31 - params.s_log2 - top_level))
    return top_level + extra_levels


def addition_numbers_on_table_device(
    datum_ids,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    n_replicas: int = 1,
    extra_levels: int | None = None,
    params: AsuraParams = DEFAULT_PARAMS,
) -> torch.Tensor:
    """ADDITION NUMBERs against a prebuilt table -> (batch,) int32 on the
    table's device.

    Runs the trace ``extra_levels`` generator levels above the entry level
    (default: up to 4, capped by the 2**31 segment-space bound).  The
    extended stream only inserts numbers, each a miss (section 2.B), so the
    minimum unused anterior number is unchanged where the unextended trace
    has one and equals the minimally extended scalar result where it does
    not.  -1 marks the remaining lanes (more extension needed, or no
    convergence): callers treat -1 as "candidate", which keeps the
    prefilter sound.  One kernel launch and no host sync for a CUDA
    table, the twin (``ref.addition_numbers_ref``) for a CPU one."""
    ids = as_ids(datum_ids, len32.device)
    return addition_numbers_cuda(
        ids, len32, node_of,
        top_level=addition_numbers_top(top_level, extra_levels=extra_levels, params=params),
        s_log2=params.s_log2, max_draws=params.max_draws, n_replicas=n_replicas,
    )


def baseline_place_on_table_device(
    algorithm: str, datum_ids, table_a: torch.Tensor, table_b: torch.Tensor
) -> torch.Tensor:
    """Device-resident baseline placement -> (batch,) int32 node ids on
    the tables' device, one kernel launch, no host sync."""
    return baseline_place_cuda(algorithm, as_ids(datum_ids, table_a.device), table_a, table_b)


def baseline_place_on_table(
    algorithm: str, datum_ids, table_a: torch.Tensor, table_b: torch.Tensor
) -> np.ndarray:
    """Baseline placement -> (batch,) int64 node ids on the host (one
    device->host copy)."""
    out = baseline_place_on_table_device(algorithm, datum_ids, table_a, table_b)
    return out.cpu().numpy().astype(np.int64)


def baseline_place_replicas_on_table_device(
    algorithm: str,
    datum_ids,
    table_a: torch.Tensor,
    table_b: torch.Tensor,
    *,
    n_replicas: int,
    max_tries: int = REPLICA_MAX_TRIES,
    emit_stats: bool = False,
):
    """Device-resident baseline R-way fan-out -> (batch, R) int32 node ids,
    primary first; -1 marks unfilled slots (documented, not checked: a
    check would sync).  ``emit_stats`` also returns the uint32
    ``[reprobes]``."""
    return baseline_replicas_cuda(
        algorithm, as_ids(datum_ids, table_a.device), table_a, table_b,
        n_replicas=n_replicas, max_tries=max_tries, emit_stats=emit_stats,
    )


def hier_place_replicas_on_tables_device(
    datum_ids,
    tables,
    *,
    top_level: int,
    max_top: int,
    s_pad: int,
    n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS,
) -> torch.Tensor:
    """Two-level replication -> (2, R, batch) int32 on the tables' device,
    no host sync.  ``tables`` is the eight-tuple of a hierarchy version
    (the ``HierArtifact``'s ``tables_dev``); plane 0 holds domain ids,
    plane 1 node ids, -1 marks slots whose distinct-domain draw did not
    converge (too few domains)."""
    ids = as_ids(datum_ids, tables[0].device)
    return hier_place_replicas_cuda(
        ids, *tables, top_level=top_level, max_top=max_top, s_pad=s_pad,
        s_log2=params.s_log2, max_draws=params.max_draws, n_replicas=n_replicas,
    )


def hier_place_replicas_on_tables(datum_ids, tables, **kwargs) -> np.ndarray:
    """Host-facing two-level replication -> (batch, R, 2) int64 ``(domain,
    node)`` pairs; raises when a lane found fewer than R distinct domains,
    as the NumPy oracle does."""
    out = hier_place_replicas_on_tables_device(datum_ids, tables, **kwargs).cpu().numpy()
    if (out[0] < 0).any():
        raise RuntimeError(
            "hierarchical replication did not converge; too few distinct domains?"
        )
    return out.transpose(2, 1, 0).astype(np.int64)


def hier_diff_replicas_on_tables_device(
    datum_ids,
    tables_a,
    tables_b,
    *,
    statics_a: tuple,
    statics_b: tuple,
    n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS,
):
    """Two-level replica-set version diff -> ``(moved, src, dst, src_slot,
    src_dom, dst_dom)``, each (batch, R) on the tables' device, no host
    sync.

    ``statics_*`` are ``(top_level, max_top, s_pad)`` per version.  Every
    id's (domain, node) R-set is placed under v and v+1 (one launch of B8
    each), then the two sets are aligned on their NODE plane
    (``align_replica_sets``; node ids are globally unique across domains)
    and the domains ride along: ``src_dom`` is the vacated node's domain
    under v (gathered at ``src_slot``), ``dst_dom`` the v+1 set's, and
    ``src_dom == dst_dom`` where a slot did not move."""
    ids = as_ids(datum_ids, tables_a[0].device)
    kw = dict(n_replicas=n_replicas, params=params)
    (top_a, max_a, pad_a), (top_b, max_b, pad_b) = statics_a, statics_b
    before = hier_place_replicas_on_tables_device(
        ids, tables_a, top_level=top_a, max_top=max_a, s_pad=pad_a, **kw
    )
    after = hier_place_replicas_on_tables_device(
        ids, tables_b, top_level=top_b, max_top=max_b, s_pad=pad_b, **kw
    )
    moved, src, dst, src_slot = align_replica_sets(before[1].T, after[1].T)
    dst_dom = after[0].T.contiguous()
    src_dom = torch.gather(before[0].T, 1, src_slot.long())
    return moved, src, dst, src_slot, torch.where(moved, src_dom, dst_dom), dst_dom


def asura_place(
    datum_ids, seg_lengths, params: AsuraParams = DEFAULT_PARAMS, *, device=None
) -> torch.Tensor:
    """Place a batch of ids -> (batch,) int32 segments on ``device``."""
    len32, top_level = table_prep(seg_lengths, params, device=device)
    cum_hi, cum_lo = tail_prep(len32, device=len32.device)
    return place_on_table_device(
        datum_ids, len32, cum_hi, cum_lo, top_level=top_level, params=params
    )


def asura_place_nodes(
    datum_ids, seg_lengths, seg_to_node, params: AsuraParams = DEFAULT_PARAMS,
    *, device=None,
) -> torch.Tensor:
    """Batch placement straight to node ids (fused gather) on ``device``."""
    len32, top_level = table_prep(seg_lengths, params, device=device)
    cum_hi, cum_lo = tail_prep(len32, device=len32.device)
    node_of = node_table_prep(seg_to_node, device=len32.device)
    return place_nodes_on_table_device(
        datum_ids, len32, cum_hi, cum_lo, node_of, top_level=top_level,
        params=params,
    )


def asura_place_replicas(
    datum_ids, seg_lengths, seg_to_node, n_replicas: int,
    params: AsuraParams = DEFAULT_PARAMS, *, device=None,
) -> torch.Tensor:
    """Replica placement -> (batch, R) int32 segments, primary first
    (raises on non-convergence)."""
    len32, top_level = table_prep(seg_lengths, params, device=device)
    node_of = node_table_prep(seg_to_node, device=len32.device)
    segs = place_replicas_on_table(
        datum_ids, len32, node_of, n_replicas, top_level=top_level, params=params
    )
    return torch.from_numpy(segs.astype(np.int32)).to(len32.device)
