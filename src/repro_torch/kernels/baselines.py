"""Wrappers of the hand-written baseline kernels (``csrc/baselines.cu``).

The paper's evaluation compares ASURA with Consistent Hashing, Random
Slicing and weighted Rendezvous hashing; the reference makes the three
first-class device backends of its ``PlacementEngine``.  Here:

  * ``ch_table_prep`` / ``rs_table_prep`` / ``wrh_table_prep`` build each
    algorithm's two lane-padded device tables on the host, with the same
    contents as the reference's prep (``inv_w`` is ``np.float32(1) / w``
    on the host, then uploaded);
  * ``ch_place_cuda``, ``rs_place_cuda`` and ``wrh_place_cuda``
    (``baseline_place_cuda`` under one algorithm each) replace the
    reference's ``ch_place_pallas``, ``rs_place_pallas`` and
    ``wrh_place_pallas``;
  * ``baseline_replicas_cuda`` is the R-way fan-out (with its
    ``[reprobes]`` stat) that the reference runs as a jnp loop around the
    lookups; serving under a baseline goes through it on the card;
  * ``baseline_place_replicas_np`` is the NumPy oracle of the fan-out.

Every wrapper follows the contract of ``asura_place.py``: the plain-torch
twin (``baselines_ref.py``) only for CPU tensors; for CUDA tensors it
launches the kernel or raises; checks first; outputs from ``torch.empty``
on the current stream, no synchronisation; a non-zero launch status
raises; one added to ``LAUNCHES[<kernel>]`` per launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.consistent_hashing import ch_place_np
from ..core.random_slicing import rs_place_np
from ..core.rng import GOLDEN, draw_u32_np
from ..core.wrh import wrh_place_np
from ..device import resolve_device
from . import baselines_ref as bref
from . import build
from .asura_place import LAUNCHES, _check, _raise_on, _stream
from .baselines_ref import REPLICA_FANOUT_LEVEL, REPLICA_MAX_TRIES
from .launch import PLAN_FIELDS

ALGORITHMS = ("ch", "rs", "wrh")
LANE = 128  # the reference's table padding unit
_ALG_CODE = {"ch": 0, "rs": 1, "wrh": 2}

LAUNCHES.update({"ch_place": 0, "rs_place": 0, "wrh_place": 0, "baseline_replicas": 0})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("baselines")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.baseline_ch_place, lib.baseline_rs_place, lib.baseline_wrh_place):
        fn.argtypes = [p] * 4 + [i64, i32, p]
        fn.restype = i32
    lib.baseline_replicas.argtypes = [i32] + [p] * 5 + [i64, i32, i32, i32, p]
    lib.baseline_replicas.restype = i32
    lib.baseline_launch_plan.argtypes = [i32, p, i64, i32, i32, p]
    lib.baseline_launch_plan.restype = i32
    return lib


# ---------------------------------------------------------------------------
# Host-side table prep (lane padding, one upload per artifact)
# ---------------------------------------------------------------------------


def _lane_pad(x: np.ndarray, fill) -> np.ndarray:
    pad = (-x.shape[0]) % LANE
    if pad == 0:
        return x
    return np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def ch_table_prep(ring_hashes, ring_owners, *, device=None):
    """(ring uint32, owners int32) lane-padded on ``device``.  Hash padding
    is 0xFFFFFFFF and owner padding the FIRST ring owner, so a hash past
    every real point resolves to the wrap target, as the oracle's
    ``idx == n -> 0`` does."""
    hashes = np.asarray(ring_hashes, dtype=np.uint32)
    owners = np.asarray(ring_owners).astype(np.int32)
    return (
        _upload(_lane_pad(hashes, np.uint32(0xFFFFFFFF)), device),
        _upload(_lane_pad(owners, np.int32(owners[0])), device),
    )


def rs_table_prep(starts32, owners, *, device=None):
    """(starts uint32, owners int32) lane-padded on ``device``.  Start
    padding is 0xFFFFFFFF and owner padding the LAST real owner, so the
    side="right" search maps a hash at or above a pad start to the final
    interval's owner, as the unpadded oracle does."""
    starts = np.asarray(starts32, dtype=np.uint32)
    owners = np.asarray(owners).astype(np.int32)
    return (
        _upload(_lane_pad(starts, np.uint32(0xFFFFFFFF)), device),
        _upload(_lane_pad(owners, np.int32(owners[-1])), device),
    )


def wrh_table_prep(node_ids, weights, *, device=None):
    """(salts uint32, inv_w float32) lane-padded on ``device``:
    ``salts[j] = GOLDEN * (node_id + 1) mod 2**32`` (the keyed draw's level
    term, hoisted out of the per-pair loop) and ``inv_w[j] = float32(1) /
    weight`` computed here in NumPy f32 (0.0 for a weight <= 0, which never
    wins).  Padding is salt 0 and ``inv_w`` 0.0."""
    nodes = np.asarray(node_ids, dtype=np.uint32)
    w = np.asarray(weights, dtype=np.float32)
    with np.errstate(over="ignore", divide="ignore"):  # u32 wrap by design
        salts = np.uint32(GOLDEN) * (nodes + np.uint32(1))
        inv_w = np.where(w > 0.0, np.float32(1.0) / w, np.float32(0.0)).astype(np.float32)
    return (
        _upload(_lane_pad(salts, np.uint32(0)), device),
        _upload(_lane_pad(inv_w, np.float32(0.0)), device),
    )


TABLE_PREP = {"ch": ch_table_prep, "rs": rs_table_prep, "wrh": wrh_table_prep}


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def _check_tables(algorithm: str, ids, keys, vals) -> int:
    """Check ids and one algorithm's (keys, vals) pair -> the table length."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    dev = ids.device
    _check("ids", ids, torch.uint32, dev)
    n_keys = keys.shape[0] if isinstance(keys, torch.Tensor) else 0
    _check("keys", keys, torch.uint32, dev, n_keys)
    vals_dtype = torch.float32 if algorithm == "wrh" else torch.int32
    _check("vals", vals, vals_dtype, dev, n_keys)
    if n_keys >= 2**31 or (algorithm != "wrh" and n_keys < 1):
        raise ValueError(f"{algorithm} table must hold 1 .. 2**31-1 entries, got {n_keys}")
    return n_keys


def baseline_place_cuda(algorithm: str, ids, keys, vals) -> torch.Tensor:
    """One lookup per id under ``algorithm`` -> (n,) int32 node ids; the
    three wrappers below name its algorithms."""
    n_keys = _check_tables(algorithm, ids, keys, vals)
    dev = ids.device
    if dev.type == "cpu":
        return bref.LOOKUPS[algorithm](ids, keys, vals)
    if dev.type != "cuda":
        raise ValueError(f"{algorithm}_place_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = getattr(_lib(), f"baseline_{algorithm}_place")
    rc = fn(ids.data_ptr(), keys.data_ptr(), vals.data_ptr(), out.data_ptr(), n,
            n_keys, _stream(dev))
    _raise_on(rc, f"baseline_{algorithm}_place")
    LAUNCHES[f"{algorithm}_place"] += 1
    return out


def ch_place_cuda(ids: torch.Tensor, ring: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Consistent-hashing lookup -> (n,) int32 owners.  ``ring`` is the
    sorted (lane-padded) uint32 ring, ``owners`` its int32 owners."""
    return baseline_place_cuda("ch", ids, ring, owners)


def rs_place_cuda(ids: torch.Tensor, starts: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Random-slicing lookup -> (n,) int32 owners.  ``starts`` are the
    sorted (lane-padded) uint32 interval starts, ``starts[0] == 0``."""
    return baseline_place_cuda("rs", ids, starts, owners)


def wrh_place_cuda(ids: torch.Tensor, salts: torch.Tensor, inv_w: torch.Tensor) -> torch.Tensor:
    """Weighted-rendezvous argmin -> (n,) int32 node ids (-1 when no entry
    has ``inv_w > 0``).  ``salts`` uint32 and ``inv_w`` float32 come from
    ``wrh_table_prep``."""
    return baseline_place_cuda("wrh", ids, salts, inv_w)


def baseline_replicas_cuda(
    algorithm: str,
    ids: torch.Tensor,
    keys: torch.Tensor,
    vals: torch.Tensor,
    *,
    n_replicas: int,
    max_tries: int = REPLICA_MAX_TRIES,
    emit_stats: bool = False,
):
    """R-way fan-out under ``algorithm`` -> (n, R) int32 nodes, primary
    first, -1 for unfilled slots; ``emit_stats`` also returns the (1,)
    uint32 ``[reprobes]``."""
    n_keys = _check_tables(algorithm, ids, keys, vals)
    R = int(n_replicas)
    if R < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if max_tries < 0:
        raise ValueError(f"max_tries must be >= 0, got {max_tries}")
    dev = ids.device
    if dev.type == "cpu":
        return bref.baseline_replicas_lookup(
            algorithm, ids, keys, vals, n_replicas=R, max_tries=max_tries,
            emit_stats=emit_stats,
        )
    if dev.type != "cuda":
        raise ValueError(f"baseline_replicas_cuda runs on cuda or cpu, not {dev}")
    n = ids.shape[0]
    out = torch.empty((n, R), dtype=torch.int32, device=dev)
    stats = torch.zeros(1, dtype=torch.int32, device=dev) if emit_stats else None
    if n > 0:
        rc = _lib().baseline_replicas(
            _ALG_CODE[algorithm], ids.data_ptr(), keys.data_ptr(), vals.data_ptr(),
            out.data_ptr(), None if stats is None else stats.data_ptr(), n, n_keys,
            R, int(max_tries), _stream(dev),
        )
        _raise_on(rc, "baseline_replicas")
        LAUNCHES["baseline_replicas"] += 1
    if emit_stats:
        return out, stats.view(torch.uint32)
    return out


def launch_plan(algorithm: str, keys: torch.Tensor, n: int, n_replicas: int = 0) -> dict:
    """The plan the CUDA launcher computes for ``n`` ids against the
    device table ``keys`` (``n_replicas`` 0: B5 / B6's lookup kernel, else
    the fan-out), read back without launching: the fields of
    ``launch.PLAN_FIELDS``."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = _lib().baseline_launch_plan(_ALG_CODE[algorithm], keys.data_ptr(), n,
                                     keys.shape[0], int(n_replicas), plan)
    _raise_on(rc, "baseline_launch_plan")
    return dict(zip(PLAN_FIELDS, plan))


# ---------------------------------------------------------------------------
# The NumPy oracle of the fan-out
# ---------------------------------------------------------------------------

ORACLES = {"ch": ch_place_np, "rs": rs_place_np, "wrh": wrh_place_np}


def baseline_place_replicas_np(
    algorithm: str,
    datum_ids,
    keys: np.ndarray,
    vals: np.ndarray,
    n_replicas: int,
    *,
    max_tries: int = REPLICA_MAX_TRIES,
) -> np.ndarray:
    """NumPy oracle of the fan-out on the canonical (unpadded) tables ->
    (batch, R) int64."""
    place = ORACLES[algorithm]
    ids = np.atleast_1d(np.asarray(datum_ids, dtype=np.uint32))
    n = ids.shape[0]
    slots = np.full((n_replicas, n), -1, dtype=np.int64)
    slots[0] = place(ids, keys, vals)
    found = np.ones(n, dtype=np.int64)
    for k in range(1, max_tries + 1):
        if (found >= n_replicas).all():
            break
        h = draw_u32_np(ids, REPLICA_FANOUT_LEVEL, np.full(n, k, dtype=np.uint32))
        cand = place(h, keys, vals)
        dup = (slots == cand[None]).any(axis=0)
        take = (~dup) & (found < n_replicas)
        slots[found[take], np.nonzero(take)[0]] = cand[take]
        found[take] += 1
    return slots.T
