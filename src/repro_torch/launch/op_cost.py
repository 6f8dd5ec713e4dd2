"""Per-device cost of one step of the port, counted op by op as it runs.

The port's counterpart of ``repro/launch/hlo_cost.py``.  The reference
re-derives FLOPs, bytes and collective bytes from the compiled SPMD HLO
text, expanding ``while`` loops by their trip counts.  The port has no HLO:
eager torch dispatches every op of every loop iteration, so the counter
sits at the dispatch level and sees each op once per execution
(``trip_unknown`` is always False).

``OpCounter`` is a ``TorchDispatchMode``.  An op on DTensors is left to
DTensor (``NotImplemented``), which runs it as ops on the LOCAL shards plus
the functional collectives its redistributions need; those come back
through the mode, so every count is per device (``FlopCounterMode`` over
DTensors counts the global product).  Each local op becomes a record
(its name and the shapes and dtypes of its tensor inputs and outputs), and
``analyze(records)`` reduces records to a ``ModuleCost``:

  * ``flops``: dot FLOPs, ``2 * prod(out) * contraction`` for mm / bmm /
    addmm / baddbmm (what ``hlo_cost`` counts for a ``dot``);
  * ``bytes``: every non-view op's tensor inputs and outputs.  Eager torch
    fuses nothing, so each op reads its inputs from and writes its outputs
    to device memory; this is the port's own rule, not ``hlo_cost``'s
    fusion-boundary rule;
  * ``collective_bytes`` / ``collective_by_kind``: output bytes of each
    all-gather, all-reduce, reduce-scatter and all-to-all, by kind, with
    ``collective_counts`` beside them.

The counter also keeps the bytes of the storages its ops create that are
still alive (a weak reference each), and their high-water mark: with
fake tensors nothing is allocated, so this is the step's memory reckoning
(``launch.dryrun``).  The records can be written out (``dump``) and
re-analysed later (``load``, ``launch.reanalyze``).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import math
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# dot-like ops -> index of the left operand among the tensor inputs
_DOTS = {"aten.mm": 0, "aten.bmm": 0, "aten.addmm": 1, "aten.baddbmm": 1}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# DTensor's sharding propagation (ops run there only derive shapes)
_PROPAGATION = {"propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached"}
# ops that move no data: waiting on a collective, views not declared as
# views, metadata, allocations
_FREE = {"wait_tensor", "detach", "lift_fresh", "_local_scalar_dense", "alias", "_unsafe_view",
         "_reshape_alias", "device", "empty", "empty_strided", "empty_like"}


@dataclasses.dataclass
class ModuleCost:
    flops: float
    bytes: float
    collective_bytes: float
    collective_by_kind: dict
    trip_unknown: bool
    collective_counts: dict = dataclasses.field(default_factory=dict)


def _nbytes(shape, dtype: str) -> int:
    return math.prod(shape) * getattr(torch, dtype).itemsize


def _base(op: str) -> str:
    """"aten.mm.default" -> "aten.mm"; "_c10d_functional.all_reduce.default"
    -> "_c10d_functional.all_reduce"."""
    return op.rsplit(".", 1)[0] if op.count(".") >= 2 else op


def analyze(records) -> ModuleCost:
    """Reduce op records ({"op", "in": [[shape, dtype]], "out": [...],
    "view": bool}) to per-device totals."""
    flops = nbytes = coll = 0.0
    by_kind: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for r in records:
        base = _base(r["op"])
        name = base.rsplit(".", 1)[-1]
        out_bytes = sum(_nbytes(s, d) for s, d in r["out"])
        if base in _DOTS:
            lhs = r["in"][_DOTS[base]][0]
            flops += 2.0 * math.prod(r["out"][0][0]) * lhs[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            coll += out_bytes
            by_kind[kind] += out_bytes
            counts[kind] += 1
        if not r.get("view") and name not in _FREE:
            nbytes += out_bytes + sum(_nbytes(s, d) for s, d in r["in"])
    return ModuleCost(flops, nbytes, coll, dict(by_kind), False, dict(counts))


def _tensors(tree) -> list:
    """The tensors of nested lists / tuples / dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _meta(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


class OpCounter(TorchDispatchMode):
    """Records every local op run under it (see the module docstring);
    ``cost()`` analyses them, ``live_bytes`` / ``peak_bytes`` are the bytes
    of the storages its ops made that are alive now / were at most."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}  # storage key -> (bytes, weakref)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops and collectives
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self._ours(ins + outs):
            return out
        rec = {"op": str(func), "in": [_meta(t) for t in ins],
               "out": [_meta(t) for t in outs], "view": bool(func.is_view)}
        self.records.append(rec)
        if not (func.is_view or func._schema.is_mutable):  # those alias their inputs
            for t in _tensors(out):
                self._track(t)
        return out

    def _ours(self, tensors) -> bool:
        """Whether the op is the step's work.  DTensor's sharding
        propagation runs ops on fake GLOBAL-shape tensors to learn output
        shapes (and its cost model on index tensors): not work."""
        if not tensors:
            return False
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_code.co_name in _PROPAGATION:
                return False
            frame = frame.f_back
        return True

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._live:
            return
        size = st.nbytes()

        def free(_ref, key=key, size=size):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= size

        self._live[key] = (size, weakref.ref(st, free))
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def cost(self) -> ModuleCost:
        return analyze(self.records)


def dump(records, path: str) -> None:
    """Write op records as gzipped JSON lines."""
    with gzip.open(path, "wt") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")


def load(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]
