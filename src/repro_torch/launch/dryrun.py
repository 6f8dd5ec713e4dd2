"""Production-mesh dry run of the port: every (arch x shape) cell, reckoned
per device on a 16x16 (or 2x16x16) mesh (the reference's
``repro.launch.dryrun``).

The reference forces 512 host devices, lowers and compiles each step with
explicit shardings and reads XLA's memory and cost analyses.  The port is
SPMD over ``torch.distributed`` and compiles nothing, so a cell here

  1. joins a ``"fake"`` process group of 256 / 512 ranks (collectives
     return at once and move nothing) and builds the production mesh over
     it (device type "cpu" on every host: ``DEVICE_TYPE``);
  2. builds the step's inputs as DTensors whose local shards are fake
     tensors (shapes and dtypes, no storage), placed by the sharding rules
     (``launch.shardings``) from ``param_specs`` / ``input_specs`` /
     ``cache_specs``;
  3. runs the port's real step once (``make_train_step``,
     ``make_prefill_step`` or ``make_serve_step``) under
     ``FakeTensorMode`` and the op counter (``launch.op_cost``), with the
     activation hooks of the mesh registered, and places its outputs as the
     reference's ``out_shardings`` do;
  4. reports the reference's keys: ``flops`` / ``hlo_bytes`` /
     ``collective_*`` from the op counter (per device; ``hlo_bytes`` keeps
     the reference's key and holds the counter's bytes of materialised
     ops), ``argument`` / ``output`` bytes from the local shards of the
     inputs and outputs, and the peak from the counter's high-water mark of
     live storages: ``peak = argument + the most bytes the step's own
     allocations held at once``, ``temp = peak - argument - output`` of the
     fresh outputs.  ``lower_s`` / ``compile_s`` become ``trace_s``.

It is a reckoning on the host, run on no card, as the reference's runs on
forced host CPU devices: it says whether a cell fits 80 GB per device and
what it communicates, not how fast it runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models import input_specs, param_specs, reduced_config
from ..models import hooks, layers
from ..models.config import ModelConfig, ShapeSpec
from ..train import AdamWConfig, make_prefill_step, make_serve_step, make_train_step
from . import op_cost
from .mesh import make_production_mesh
from .shardings import (
    activation_constraint_fn,
    batch_shardings,
    cache_shardings,
    local_shape,
    logits_sharding,
    opt_shardings,
    param_shardings,
    replicated,
    serve_param_shardings,
    to_placements,
)

# microbatch counts per (arch, shape), as the reference's table (empty)
MICROBATCHES: dict[tuple[str, str], int] = {}
# The mesh's device type, "cpu" on every host, so a reckoning is the same
# on a CPU-only host and on the card's (a CPU-only torch cannot take
# autograd through fake CUDA tensors).  On a CPU mesh DTensor runs an
# all-to-all as an all-gather and a chunk, counted as the all-gather it is.
DEVICE_TYPE = "cpu"


def _meta_like(tree, dtype=None):
    """Meta stand-ins of a tree (``dtype``: every leaf's new dtype)."""
    if isinstance(tree, dict):
        return {k: _meta_like(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype or tree.dtype, device="meta")


def _opt_specs(params_abs):
    return {"m": _meta_like(params_abs, torch.float32),
            "v": _meta_like(params_abs, torch.float32),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def build_cell(cfg: ModelConfig, spec: ShapeSpec, mesh, *, n_microbatches: int = 1,
               serve_tp_only: bool = False):
    """(fn, in_specs, in_shardings, out_shardings) of one cell: train with
    params, AdamW moments and batch sharded by the rules; prefill and decode
    with every parameter in bf16 (the reference's ``_bf16_params``), TP-only
    when ``serve_tp_only``.  ``in_specs`` are meta tensors; ``mesh`` may be
    any mesh-like object (``.axis_names``, ``.shape``)."""
    params_abs = param_specs(cfg)
    serve_sh = serve_param_shardings if serve_tp_only else param_shardings
    if spec.kind == "train":
        fn = make_train_step(cfg, AdamWConfig(), n_microbatches=n_microbatches)
        batch = input_specs(cfg, spec)["batch"]
        in_specs = (params_abs, _opt_specs(params_abs), batch)
        in_sh = (param_shardings(mesh, params_abs), opt_shardings(mesh, params_abs),
                 batch_shardings(mesh, batch))
        out_sh = (in_sh[0], in_sh[1], replicated(mesh, {"loss": 0, "grad_norm": 0, "lr": 0}))
        return fn, in_specs, in_sh, out_sh
    pa = _meta_like(params_abs, layers.COMPUTE_DTYPE)
    if spec.kind == "prefill":
        batch = input_specs(cfg, spec)["batch"]
        in_sh = (serve_sh(mesh, pa), batch_shardings(mesh, batch))
        return (make_prefill_step(cfg), (pa, batch), in_sh,
                logits_sharding(mesh, spec.global_batch, cfg.vocab))
    ins = input_specs(cfg, spec)
    cache_sh = cache_shardings(mesh, cfg, ins["cache"])
    in_sh = (serve_sh(mesh, pa), cache_sh, batch_shardings(mesh, ins["batch"]))
    out_sh = (logits_sharding(mesh, spec.global_batch, cfg.vocab), cache_sh)
    return make_serve_step(cfg), (pa, ins["cache"], ins["batch"]), in_sh, out_sh


def _pairs(tree, shardings):
    """(leaf, sharding) pairs of a tree and its sharding tree."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _pairs(tree[k], shardings[k])]
    if isinstance(tree, (tuple, list)):
        return [p for t, s in zip(tree, shardings) for p in _pairs(t, s)]
    return [(tree, shardings)]


def shard_bytes(tree, shardings) -> int:
    """Per-device bytes of a (meta) tree placed by ``shardings``."""
    return sum(math.prod(local_shape(sh, t.shape)) * t.dtype.itemsize
               for t, sh in _pairs(tree, shardings))


def cell_argument_bytes(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
                        serve_tp_only: bool = True) -> int:
    """The per-device argument bytes of a cell from the specs alone (any
    mesh-like object; no process group)."""
    _, in_specs, in_sh, _ = build_cell(cfg, spec, mesh, serve_tp_only=serve_tp_only)
    return shard_bytes(in_specs, in_sh)


def _fake_inputs(tree, shardings):
    """DTensors with fake local shards on their shardings' meshes (call
    under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _fake_inputs(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fake_inputs(t, s) for t, s in zip(tree, shardings))
    mesh = shardings.mesh
    local = torch.empty(local_shape(shardings, tree.shape), dtype=tree.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, shardings.placements, run_check=False,
                              shape=tree.shape, stride=_contiguous_stride(tree.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _place(tree, shardings):
    """Redistribute a step's outputs onto the cell's output specs, each on
    the mesh it came out on (a loss computed from activations on the batch
    mesh stays there)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(t, s) for t, s in zip(tree, shardings))
    if isinstance(tree, DTensor):
        want = to_placements(tree.device_mesh, shardings.spec)
        if tuple(tree.placements) != want:
            return tree.redistribute(tree.device_mesh, want)
    return tree


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in op_cost._tensors(tree)]


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` process group of ``world`` ranks for the duration (the
    counterpart of the reference's forced host devices)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, verbose: bool = True,
             op_dir: str | None = None, serve_tp_only: bool = False,
             remat: str | None = None, reduced: bool = False):
    """One cell on a fake 256- (or 512-) rank group -> the reference's
    record (``status`` "ok", or "skipped" with the reason).  ``reduced``
    takes the arch's reduced config (tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    spec = SHAPES[shape]
    ok, reason = shape_applicable(cfg, spec)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skipped", "reason": reason}
    if remat:
        from ..models import lm as _lm

        _lm.set_remat_policy(remat)
    n_micro = MICROBATCHES.get((arch, shape), 1)
    world = 512 if multi_pod else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=DEVICE_TYPE)
        fn, in_specs, in_sh, out_sh = build_cell(
            cfg, spec, mesh, n_microbatches=n_micro, serve_tp_only=serve_tp_only)
        arg_bytes = shard_bytes(in_specs, in_sh)
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True) as fake_mode:
            args = _fake_inputs(in_specs, in_sh)
        # The step runs outside the mode: ops on the fake inputs stay fake
        # (a fake tensor enters its mode itself), while DTensor's own index
        # arithmetic and the models' small constants are real tensors (a
        # fake mode on the stack would make DTensor's cost model ask a fake
        # tensor for its values); tensors built whole on every rank (the
        # positions, whose masks are rank-sized) are made fake as they are
        # placed.
        arg_keys = {t.untyped_storage()._cdata for t in _local_tensors(args)}
        counter = op_cost.OpCounter()
        placement = activation_constraint_fn(mesh, whole=fake_mode.from_tensor)
        with hooks.activation_sharding(placement), counter:
            out = _place(fn(*args), out_sh)
        outs = _local_tensors(out)
        out_bytes = sum(t.untyped_storage().nbytes() for t in outs)
        fresh = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in outs
                 if t.untyped_storage()._cdata not in arg_keys}
        t_trace = time.perf_counter() - t0
        n_dev = mesh.size()
        mesh_shape = "x".join(str(s) for s in mesh.shape)
    mc = counter.cost()
    if op_dir:
        os.makedirs(op_dir, exist_ok=True)
        op_cost.dump(counter.records, op_log_path(op_dir, arch, shape, multi_pod))
    peak = arg_bytes + counter.peak_bytes
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_shape,
        "mesh_device": DEVICE_TYPE,
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "flops": mc.flops,
        "hlo_bytes": mc.bytes,
        "collective_bytes_per_device": mc.collective_bytes,
        "collective_by_kind": dict(mc.collective_by_kind),
        "trip_unknown": mc.trip_unknown,
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": out_bytes,
        "temp_bytes_per_device": peak - arg_bytes - sum(fresh.values()),
        "peak_bytes_per_device": peak,
        "collectives": {"bytes": dict(mc.collective_by_kind),
                        "counts": dict(mc.collective_counts),
                        "total_bytes": mc.collective_bytes},
        "n_devices": n_dev,
        "n_microbatches": n_micro,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if verbose:
        print(json.dumps(result, indent=2, default=float), flush=True)
    return result


def op_log_path(op_dir: str, arch: str, shape: str, multi_pod: bool) -> str:
    return f"{op_dir}/{arch}_{shape}_{'mp' if multi_pod else 'sp'}.ops.gz"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--out", default=None)
    ap.add_argument("--op-dir", default=None, help="write each cell's op log (gz)")
    ap.add_argument("--serve-tp-only", dest="serve_tp_only", action="store_true",
                    default=True, help="serve weights TP-only (the default)")
    ap.add_argument("--serve-fsdp", dest="serve_tp_only", action="store_false")
    ap.add_argument("--remat", default=None, choices=["nothing", "dots", "everything"])
    ap.add_argument("--blockwise-threshold", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)
    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        if args.microbatches:
            MICROBATCHES[(args.arch, args.shape)] = args.microbatches
    if args.blockwise_threshold:
        layers.set_blockwise_threshold(args.blockwise_threshold)
    results = []
    for arch, shape in cells:
        if args.all:
            print(f"=== {arch} x {shape} (multi_pod={args.multi_pod}) ===", flush=True)
        try:
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod, op_dir=args.op_dir,
                                    serve_tp_only=args.serve_tp_only, remat=args.remat,
                                    reduced=args.reduced))
        except Exception as e:  # a failure here is a bug in the system
            if not args.all:
                raise
            results.append({"arch": arch, "shape": shape, "status": "FAILED",
                            "error": str(e)[:500]})
            print(f"FAILED: {e}", file=sys.stderr)
        if args.out:  # after every cell, so a long sweep keeps what it has
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2, default=float)
    n_fail = sum(1 for r in results if r["status"] == "FAILED")
    print(f"\n{len(results)} cells: {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
