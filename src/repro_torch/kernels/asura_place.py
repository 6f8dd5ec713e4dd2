"""Wrappers of the hand-written CUDA placement kernels (``csrc/asura_place.cu``).

``place_cuda`` replaces the reference's ``place_pallas`` (the bounded
draw loop alone, -1 for a non-converged lane; the reference exports it
and no caller of its own uses it); ``place_fused_cuda`` replaces
``place_fused_pallas``; ``place_replicas_cuda`` replaces ``place_replicas_pallas`` and also emits
the serving path's stats vector; ``diff_nodes_cuda`` and
``diff_replicas_cuda`` replace ``diff_nodes_pallas`` and
``diff_replicas_pallas`` (the migration planner's two-version diffs);
``diff_replicas_aligned_cuda`` is the latter's kernel with the per-slot
alignment of its two sets (the reference's jnp ``_align_replica_sets``)
as its epilogue, so the sets never reach memory.
``addition_numbers_cuda`` replaces no TPU kernel: it is the section 2.D
ADDITION-NUMBER trace, which the reference computes in jnp
(``kernels/ref.py`` ``addition_numbers_ref``), for the planner's
add-node prefilter.  All seven:

  * take the plain-torch twin (``ref.py``; the aligned diff also
    ``ops.align_replica_sets``) only for CPU tensors; for CUDA
    tensors they launch the kernel or raise -- no fallback;
  * check device, dtype, contiguity and shape first (ids and tables are
    ``uint32`` tensors, the seg->node map ``int32``);
  * allocate outputs with ``torch.empty`` and launch on the current
    stream without synchronising, raising if the launch reports a CUDA
    error;
  * add one to ``LAUNCHES[<kernel>]`` per kernel launch, and nowhere else.

Ids are not padded: the kernels mask the ragged edge themselves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

LAUNCHES = {"place": 0, "place_fused": 0, "place_replicas": 0, "diff_nodes": 0,
            "diff_replicas": 0, "diff_replicas_aligned": 0, "addition_numbers": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("asura_place")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.asura_place.argtypes = [p] * 3 + [i64] + [i32] * 4 + [p]
    lib.asura_place.restype = i32
    lib.asura_place_fused.argtypes = [p] * 6 + [i64] + [i32] * 5 + [p]
    lib.asura_place_fused.restype = i32
    lib.asura_place_replicas.argtypes = [p] * 7 + [i64] + [i32] * 6 + [p]
    lib.asura_place_replicas.restype = i32
    lib.asura_diff_nodes.argtypes = [p] * 10 + [i64] + [i32] * 6 + [p]
    lib.asura_diff_nodes.restype = i32
    lib.asura_diff_replicas.argtypes = [p] * 6 + [i64] + [i32] * 7 + [p]
    lib.asura_diff_replicas.restype = i32
    lib.asura_diff_replicas_aligned.argtypes = [p] * 10 + [i64] + [i32] * 7 + [p]
    lib.asura_diff_replicas_aligned.restype = i32
    lib.asura_addition_numbers.argtypes = [p] * 5 + [i64] + [i32] * 5 + [p]
    lib.asura_addition_numbers.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, dtype, device, length=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, ids are on {device}")
    if t.dim() != 1 or (length is not None and t.shape[0] != length):
        raise ValueError(f"{name} must be 1-D of length {length}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ladder(n_segs: int, top_level: int, s_log2: int, max_draws: int) -> None:
    if not 1 <= n_segs < 2**31:
        raise ValueError(f"table must hold 1 .. 2**31-1 segments, got {n_segs}")
    if top_level < 0 or s_log2 < 1 or s_log2 + top_level > 31:
        raise ValueError(
            f"need top_level >= 0, s_log2 >= 1, s_log2 + top_level <= 31; got "
            f"{top_level}, {s_log2}"
        )
    if max_draws < 0:
        raise ValueError(f"max_draws must be >= 0, got {max_draws}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")


def place_cuda(
    ids: torch.Tensor,
    len32: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
) -> torch.Tensor:
    """Bounded placement -> (n,) int32 segments, -1 for a lane that did not
    hit within ``max_draws`` draws (no tail, no gather).  ``len32`` is the
    (n_segs,) uint32 length table."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs = len32.shape[0] if isinstance(len32, torch.Tensor) else 0
    _check("len32", len32, torch.uint32, dev, n_segs)
    _check_ladder(n_segs, top_level, s_log2, max_draws)
    if dev.type == "cpu":
        return ref.place_ref(ids, len32, top_level=top_level, s_log2=s_log2,
                             max_draws=max_draws)
    if dev.type != "cuda":
        raise ValueError(f"place_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rc = _lib().asura_place(
        ids.data_ptr(), len32.data_ptr(), out.data_ptr(), n, n_segs, top_level,
        s_log2, max_draws, _stream(dev),
    )
    _raise_on(rc, "asura_place")
    LAUNCHES["place"] += 1
    return out


def place_fused_cuda(
    ids: torch.Tensor,
    len32: torch.Tensor,
    cum_hi: torch.Tensor,
    cum_lo: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
    emit_nodes: bool = False,
) -> torch.Tensor:
    """Total placement -> (n,) int32 segments, or nodes with ``emit_nodes``.

    ``len32`` / ``cum_hi`` / ``cum_lo`` are the (n_segs,) uint32 length
    table and u64 length-cumsum halves, ``node_of`` the (n_segs,) int32
    seg->node map."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs = len32.shape[0] if isinstance(len32, torch.Tensor) else 0
    for name, t, dt in (
        ("len32", len32, torch.uint32), ("cum_hi", cum_hi, torch.uint32),
        ("cum_lo", cum_lo, torch.uint32), ("node_of", node_of, torch.int32),
    ):
        _check(name, t, dt, dev, n_segs)
    _check_ladder(n_segs, top_level, s_log2, max_draws)
    if dev.type == "cpu":
        return ref.place_fused_ref(
            ids, len32, cum_hi, cum_lo, node_of, top_level=top_level,
            s_log2=s_log2, max_draws=max_draws, emit_nodes=emit_nodes,
        )
    if dev.type != "cuda":
        raise ValueError(f"place_fused_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rc = _lib().asura_place_fused(
        ids.data_ptr(), len32.data_ptr(), cum_hi.data_ptr(), cum_lo.data_ptr(),
        node_of.data_ptr(), out.data_ptr(), n, n_segs, top_level, s_log2,
        max_draws, int(emit_nodes), _stream(dev),
    )
    _raise_on(rc, "asura_place_fused")
    LAUNCHES["place_fused"] += 1
    return out


def place_replicas_cuda(
    ids: torch.Tensor,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
    emit_nodes: bool = False,
    emit_stats: bool = False,
):
    """Section 5.A replication -> (n, R) int32, primary first, -1 for
    unfilled slots; segments, or nodes with ``emit_nodes``.

    ``emit_stats`` also returns the (DEPTH_BINS + 1,) uint32 vector
    ``[depth_hist..., nonconverged]`` (sums mod 2**32)."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs = len32.shape[0] if isinstance(len32, torch.Tensor) else 0
    _check("len32", len32, torch.uint32, dev, n_segs)
    _check("node_of", node_of, torch.int32, dev, n_segs)
    _check_ladder(n_segs, top_level, s_log2, max_draws)
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if max_draws * R >= 2**31:  # the kernel counts draws in int32, as the reference does
        raise ValueError(f"max_draws * n_replicas must be < 2**31, got {max_draws} * {R}")
    if dev.type == "cpu":
        return ref.place_replicas_fused_ref(
            ids, len32, node_of, top_level=top_level, s_log2=s_log2,
            max_draws=max_draws, n_replicas=R, emit_nodes=emit_nodes,
            emit_stats=emit_stats,
        )
    if dev.type != "cuda":
        raise ValueError(f"place_replicas_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((n, R), dtype=torch.int32, device=dev)
    stats = (
        torch.zeros(ref.DEPTH_BINS + 1, dtype=torch.int32, device=dev)
        if emit_stats else None
    )
    if n > 0:
        # R > 8: each lane keeps its picks in its own rows of these
        scratch = (
            [torch.empty((n, R), dtype=torch.int32, device=dev) for _ in range(2)]
            if R > 8 else [None, None]
        )
        rc = _lib().asura_place_replicas(
            ids.data_ptr(), len32.data_ptr(), node_of.data_ptr(), out.data_ptr(),
            *(None if s is None else s.data_ptr() for s in scratch),
            None if stats is None else stats.data_ptr(),
            n, n_segs, top_level, s_log2, max_draws, R, int(emit_nodes),
            _stream(dev),
        )
        _raise_on(rc, "asura_place_replicas")
        LAUNCHES["place_replicas"] += 1
    if emit_stats:
        return out, stats.view(torch.uint32)
    return out


def _check_table(tag: str, dev, len32, node_of, cum_hi=None, cum_lo=None) -> int:
    """Check one table set (``len32`` u32, optional tail halves u32,
    ``node_of`` i32, all of one length) -> its length."""
    n_segs = len32.shape[0] if isinstance(len32, torch.Tensor) else 0
    _check(f"len32_{tag}", len32, torch.uint32, dev, n_segs)
    if cum_hi is not None:
        _check(f"cum_hi_{tag}", cum_hi, torch.uint32, dev, n_segs)
        _check(f"cum_lo_{tag}", cum_lo, torch.uint32, dev, n_segs)
    _check(f"node_{tag}", node_of, torch.int32, dev, n_segs)
    return n_segs


def diff_nodes_cuda(
    ids: torch.Tensor,
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
    s_log2: int = 1,
    max_draws: int = 128,
) -> torch.Tensor:
    """Two-version total placement -> (2, n) int32 nodes: row 0 under
    table A (version v), row 1 under table B (v+1).  The tables may differ
    in length and top level."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs_a = _check_table("a", dev, len32_a, node_a, cum_hi_a, cum_lo_a)
    n_segs_b = _check_table("b", dev, len32_b, node_b, cum_hi_b, cum_lo_b)
    _check_ladder(n_segs_a, top_a, s_log2, max_draws)
    _check_ladder(n_segs_b, top_b, s_log2, max_draws)
    if dev.type == "cpu":
        return ref.diff_fused_ref(
            ids, len32_a, cum_hi_a, cum_lo_a, node_a,
            len32_b, cum_hi_b, cum_lo_b, node_b,
            top_a=top_a, top_b=top_b, s_log2=s_log2, max_draws=max_draws,
        )
    if dev.type != "cuda":
        raise ValueError(f"diff_nodes_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rc = _lib().asura_diff_nodes(
        ids.data_ptr(), len32_a.data_ptr(), cum_hi_a.data_ptr(),
        cum_lo_a.data_ptr(), node_a.data_ptr(), len32_b.data_ptr(),
        cum_hi_b.data_ptr(), cum_lo_b.data_ptr(), node_b.data_ptr(),
        out.data_ptr(), n, n_segs_a, n_segs_b, top_a, top_b, s_log2,
        max_draws, _stream(dev),
    )
    _raise_on(rc, "asura_diff_nodes")
    LAUNCHES["diff_nodes"] += 1
    return out


def _check_diff_replicas(ids, len32_a, node_a, len32_b, node_b, top_a, top_b, s_log2,
                         max_draws, n_replicas) -> tuple[int, int, int]:
    """B4's operand checks -> (n_segs_a, n_segs_b, R)."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs_a = _check_table("a", dev, len32_a, node_a)
    n_segs_b = _check_table("b", dev, len32_b, node_b)
    _check_ladder(n_segs_a, top_a, s_log2, max_draws)
    _check_ladder(n_segs_b, top_b, s_log2, max_draws)
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if max_draws * R >= 2**31:  # the kernel counts draws in int32, as the reference does
        raise ValueError(f"max_draws * n_replicas must be < 2**31, got {max_draws} * {R}")
    return n_segs_a, n_segs_b, R


def diff_replicas_cuda(
    ids: torch.Tensor,
    len32_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
) -> torch.Tensor:
    """Two-version replica placement -> (2, n, R) int32 replica-node sets
    (primary first, -1 for unfilled slots): index 0 under table A
    (version v), index 1 under table B (v+1)."""
    dev = ids.device
    n_segs_a, n_segs_b, R = _check_diff_replicas(
        ids, len32_a, node_a, len32_b, node_b, top_a, top_b, s_log2, max_draws, n_replicas)
    if dev.type == "cpu":
        return ref.diff_replicas_fused_ref(
            ids, len32_a, node_a, len32_b, node_b, top_a=top_a, top_b=top_b,
            s_log2=s_log2, max_draws=max_draws, n_replicas=R,
        )
    if dev.type != "cuda":
        raise ValueError(f"diff_replicas_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((2, n, R), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    rc = _lib().asura_diff_replicas(
        ids.data_ptr(), len32_a.data_ptr(), node_a.data_ptr(),
        len32_b.data_ptr(), node_b.data_ptr(), out.data_ptr(),
        n, n_segs_a, n_segs_b, top_a, top_b, s_log2, max_draws, R, _stream(dev),
    )
    _raise_on(rc, "asura_diff_replicas")
    LAUNCHES["diff_replicas"] += 1
    return out


def diff_replicas_aligned_cuda(
    ids: torch.Tensor,
    len32_a: torch.Tensor,
    node_a: torch.Tensor,
    len32_b: torch.Tensor,
    node_b: torch.Tensor,
    *,
    top_a: int,
    top_b: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-version replica placement aligned per slot -> ``(moved, src,
    dst, src_slot)``, each a contiguous (n, R) tensor (``moved`` bool, the
    rest int32): exactly ``ops.align_replica_sets`` of
    ``diff_replicas_cuda``'s two sets, computed in the same launch, so the
    sets never reach memory.  The operands are ``diff_replicas_cuda``'s."""
    dev = ids.device
    n_segs_a, n_segs_b, R = _check_diff_replicas(
        ids, len32_a, node_a, len32_b, node_b, top_a, top_b, s_log2, max_draws, n_replicas)
    if dev.type == "cpu":
        from .ops import align_replica_sets  # ops imports this module

        sets = ref.diff_replicas_fused_ref(
            ids, len32_a, node_a, len32_b, node_b, top_a=top_a, top_b=top_b,
            s_log2=s_log2, max_draws=max_draws, n_replicas=R,
        )
        return align_replica_sets(sets[0], sets[1])
    if dev.type != "cuda":
        raise ValueError(f"diff_replicas_aligned_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    moved = torch.empty((n, R), dtype=torch.bool, device=dev)
    src, dst, src_slot = (torch.empty((n, R), dtype=torch.int32, device=dev) for _ in range(3))
    if n == 0:
        return moved, src, dst, src_slot
    # R > 8: each lane keeps its before set in its own row of this
    before = torch.empty((n, R), dtype=torch.int32, device=dev) if R > 8 else None
    rc = _lib().asura_diff_replicas_aligned(
        ids.data_ptr(), len32_a.data_ptr(), node_a.data_ptr(),
        len32_b.data_ptr(), node_b.data_ptr(), moved.data_ptr(), src.data_ptr(),
        dst.data_ptr(), src_slot.data_ptr(), None if before is None else before.data_ptr(),
        n, n_segs_a, n_segs_b, top_a, top_b, s_log2, max_draws, R, _stream(dev),
    )
    _raise_on(rc, "asura_diff_replicas_aligned")
    LAUNCHES["diff_replicas_aligned"] += 1
    return moved, src, dst, src_slot


def addition_numbers_cuda(
    ids: torch.Tensor,
    len32: torch.Tensor,
    node_of: torch.Tensor,
    *,
    top_level: int,
    s_log2: int = 1,
    max_draws: int = 128,
    n_replicas: int = 1,
) -> torch.Tensor:
    """Section 2.D ADDITION NUMBER per id -> (n,) int32: the minimum unused
    anterior ASURA number of the bounded R-replica trace against one table,
    run with the ladder at ``top_level`` (the caller's extended top), -1
    where the lane did not fill R slots within ``max_draws * max(1, R)``
    draws or had no unused draw."""
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_segs = len32.shape[0] if isinstance(len32, torch.Tensor) else 0
    _check("len32", len32, torch.uint32, dev, n_segs)
    _check("node_of", node_of, torch.int32, dev, n_segs)
    _check_ladder(n_segs, top_level, s_log2, max_draws)
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if max_draws * R >= 2**31:  # the kernel counts draws in int32, as the reference does
        raise ValueError(f"max_draws * n_replicas must be < 2**31, got {max_draws} * {R}")
    if dev.type == "cpu":
        return ref.addition_numbers_ref(
            ids, len32, node_of, top_level=top_level, s_log2=s_log2,
            max_draws=max_draws, n_replicas=R,
        )
    if dev.type != "cuda":
        raise ValueError(f"addition_numbers_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # R > 8: each lane keeps its picked nodes in its own row of this
    nodes = torch.empty((n, R), dtype=torch.int32, device=dev) if R > 8 else None
    rc = _lib().asura_addition_numbers(
        ids.data_ptr(), len32.data_ptr(), node_of.data_ptr(), out.data_ptr(),
        None if nodes is None else nodes.data_ptr(), n, n_segs, top_level,
        s_log2, max_draws, R, _stream(dev),
    )
    _raise_on(rc, "asura_addition_numbers")
    LAUNCHES["addition_numbers"] += 1
    return out
