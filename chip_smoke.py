#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--profile]

The main path is ASURA STEP 2 -- placing a batch of u32 datum ids against
one versioned segment table -- reached two ways: bulk placement through
``PlacementEngine`` and the batched serving step ``RequestStreamDriver``.
The deployment follows the repository's own Fig. 5 evaluation points
(``benchmarks/calc_time.py``): a heterogeneous 4096-node cluster with
capacities drawn from ``--seed`` in [0.5, 2.0), and one 10,000-node
cluster.  Phases (each passes or raises; any failure exits non-zero):

  1. card name and power limit; build the CUDA kernels from the sources
     in this checkout;
  2. the fused placement kernel against its plain-torch twin on the card,
     exact equality, emit_nodes both ways: 2**20 + 13 ids on both
     clusters, and the forced tail (max_draws 0 and 1);
  3. the replica kernel against its twin, R in {1, 3, 5} (and R = 12,
     the lane-rows path), emit_nodes both ways, with the stats vector;
  4. bulk main path: ``PlacementEngine(cluster)`` on the card,
     ``place_nodes_device`` on 2**24 ids and ``place_replica_nodes_device``
     at R = 3 under ``torch.cuda.set_sync_debug_mode("error")``; one
     table upload, both kernels launched, CUDA-event timings;
  5. serving main path: batch 65,536, 2**20 keys, Zipf(1.1), R = 3, pow2,
     instrumented, 16 steps under sync-debug "error"; counts, live nodes
     and the metrics slab checked, and everything equal to a CPU driver
     (the twins) at the same seed;
  6. one JSON line per kernel set: launches on the main path, time at the
     phase-4 shape, the twin's time, and the least time the card could
     take for the same work.

``--profile`` also traces 4 serving steps with ``torch.profiler`` and
prints the device busy time per step, the idle share and the kernels that
fill it (PERF.md section 5).

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or without the package beside this script, it
exits non-zero before printing any result.  Every integer result is
compared with zero tolerance: the whole stack is exact integer math.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

LADDER_NODES = 4096  # benchmarks/calc_time.py LADDER_NODES
HUGE_NODES = 10_000  # benchmarks/calc_time.py HUGE_NODES[0]
CHECK_IDS = (1 << 20) + 13
BULK_IDS = 1 << 24
TIMED_CALLS = 10
SERVE_BATCH = 1 << 16
SERVE_KEYS = 1 << 20
SERVE_STEPS = 16

# Published peaks of one H100 SXM (NVIDIA data sheet; at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# int32 ALU: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, from the same data
# sheet's SM count and clock that give its 67 TFLOP/s FP32 row
# (132 x 128 FP32 lanes x 2 x 1.98 GHz).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 ops the kernels spend per consulted ladder level (two fmix32 at 8
# ops each + seed add, counter multiply, xor, counter tick) and per draw
# (floor shift, fraction shift, bound and length compares).
OPS_PER_LEVEL = 20
OPS_PER_DRAW = 4
SOURCE = "src/repro_torch/kernels/csrc/asura_place.cu"
REPLACES = {
    "place_fused": "src/repro/kernels/asura_place.py:510",
    "place_replicas": "src/repro/kernels/asura_place.py:396",
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after one
    warm-up call."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(starts, ends)]


def mismatches(torch, a, b) -> tuple[int, int]:
    """(number of differing entries, max |a - b|) of two integer tensors."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.uint32:
        from repro_torch.kernels.u32 import as_u32

        a, b = as_u32(a), as_u32(b)
    a, b = a.to(torch.int64), b.to(torch.int64)
    diff = (a - b).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def ladder_work(torch, stats, top_level: int) -> tuple[int, int]:
    """(consulted levels, draws) from a [depth_hist..., nonconv] vector."""
    from repro_torch.kernels.ref import DEPTH_BINS
    from repro_torch.kernels.u32 import as_u32

    hist = as_u32(stats[:DEPTH_BINS]).cpu()
    depth = torch.arange(DEPTH_BINS, dtype=torch.int64)
    return int((hist * depth).sum()), int(hist.sum())


def profile_steps(torch, driver, steps: int) -> dict:
    """Device busy time per serving step and the kernels that fill it, from
    a ``torch.profiler`` trace of ``steps`` steps (after one untraced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    driver.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            driver.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "busy_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": sum(len(v) for v in by_name.values()) / steps,
        "top": [(name[:60], sum(v) / steps / 1e3, len(v) // steps) for name, v in top],
    }


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run(seed: int, dev, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import AsuraParams, PlacementEngine, make_cluster
    from repro_torch.kernels import asura_place as ap
    from repro_torch.kernels import build, ref
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import RequestStreamDriver

    rng = np.random.default_rng(seed)
    caps = {
        LADDER_NODES: rng.uniform(0.5, 2.0, LADDER_NODES),
        HUGE_NODES: rng.uniform(0.5, 2.0, HUGE_NODES),
    }

    def ids_on(n: int):
        return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(dev)

    worst = {"place_fused": 0, "place_replicas": 0}

    def hold(name: str, what: str, got, want) -> None:
        bad, err = mismatches(torch, got, want)
        worst[name] = max(worst[name], err)
        print(f"  {name:15s} {what:44s} {bad} mismatches")
        require(bad == 0, f"{name} disagrees with its twin: {what}")

    # -- phase 1: card, build ------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- phase 2: fused placement kernel vs twin -----------------------------
    print(f"phase 2: place_fused_cuda vs twin, {CHECK_IDS} ids, exact")
    ids = ids_on(CHECK_IDS)
    cases = [(n, AsuraParams()) for n in (LADDER_NODES, HUGE_NODES)]
    cases += [(LADDER_NODES, AsuraParams(max_draws=d)) for d in (0, 1)]
    for n_nodes, params in cases:
        art = PlacementEngine(make_cluster(caps[n_nodes], params), device=dev)._device_artifact()
        tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
        kw = dict(top_level=art.top_level, s_log2=params.s_log2, max_draws=params.max_draws)
        if params.max_draws <= 1:
            tail = int((ref.place_ref(ids, art.len32_dev, **kw) < 0).sum())
            print(f"  forced tail max_draws={params.max_draws}: {tail} of {CHECK_IDS} lanes")
        for emit in (False, True):
            hold("place_fused", f"{n_nodes} nodes {params} nodes={emit}",
                 ap.place_fused_cuda(ids, *tabs, emit_nodes=emit, **kw),
                 ref.place_fused_ref(ids, *tabs, emit_nodes=emit, **kw))

    # -- phase 3: replica kernel vs twin -------------------------------------
    print("phase 3: place_replicas_cuda vs twin, exact, with stats")
    art = PlacementEngine(make_cluster(caps[LADDER_NODES]), device=dev)._device_artifact()
    kw = dict(top_level=art.top_level, s_log2=1, max_draws=128)
    for R, n in ((1, CHECK_IDS), (3, CHECK_IDS), (5, CHECK_IDS), (12, 1 << 16)):
        sub = ids[:n]
        for emit in (False, True):
            out, st = ap.place_replicas_cuda(sub, art.len32_dev, art.node_of_dev, n_replicas=R,
                                             emit_nodes=emit, emit_stats=True, **kw)
            out_t, st_t = ref.place_replicas_fused_ref(sub, art.len32_dev, art.node_of_dev,
                                                       n_replicas=R, emit_nodes=emit,
                                                       emit_stats=True, **kw)
            hold("place_replicas", f"R={R} {n} ids nodes={emit}", out, out_t)
            hold("place_replicas", f"R={R} {n} ids nodes={emit} stats", st, st_t)

    # -- phase 4: bulk main path ---------------------------------------------
    print(f"phase 4: PlacementEngine on the card, {BULK_IDS} ids")
    cluster = make_cluster(caps[LADDER_NODES])
    engine = PlacementEngine(cluster)
    require(engine.device.type == "cuda", f"engine placed on {engine.device}")
    art = engine.artifact()  # the one table upload, outside the sync guard
    bulk = ids_on(BULK_IDS)
    torch.cuda.synchronize()
    ev = {k: [] for k in ("place_fused", "place_replicas")}
    outs = {}
    ap.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(1 + TIMED_CALLS):
            for name, call in (
                ("place_fused", lambda: engine.place_nodes_device(bulk)),
                ("place_replicas", lambda: engine.place_replica_nodes_device(bulk, 3)),
            ):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                outs[name] = call()
                e.record()
                ev[name].append((s, e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bulk_launches = dict(ap.LAUNCHES)
    torch.cuda.synchronize()
    print(f"  launches {bulk_launches}, uploads {engine.uploads}")
    require(engine.uploads == 1, f"engine uploaded {engine.uploads} tables")
    require(all(v > 0 for v in bulk_launches.values()), "a kernel was not launched")
    ms = {k: statistics.median(s.elapsed_time(e) for s, e in v[1:]) for k, v in ev.items()}
    for k in ms:
        print(f"  {k:15s} median {ms[k]:.4f} ms over {TIMED_CALLS} calls, "
              f"{BULK_IDS / ms[k] * 1e3:.4g} ids/s")
    tabs = (art.len32_dev, art.cum_hi_dev, art.cum_lo_dev, art.node_of_dev)
    kw = dict(top_level=art.top_level, s_log2=1, max_draws=128)
    plain = {}
    want = ref.place_fused_ref(bulk, *tabs, emit_nodes=True, **kw)
    hold("place_fused", "engine place_nodes_device", outs["place_fused"], want)
    plain["place_fused"] = statistics.median(cuda_ms(
        torch, lambda: ref.place_fused_ref(bulk, *tabs, emit_nodes=True, **kw), 2))
    want = ref.place_replicas_fused_ref(bulk, art.len32_dev, art.node_of_dev, n_replicas=3,
                                        emit_nodes=True, emit_stats=False, **kw)
    hold("place_replicas", "engine place_replica_nodes_device R=3", outs["place_replicas"], want)
    plain["place_replicas"] = statistics.median(cuda_ms(
        torch, lambda: ref.place_replicas_fused_ref(
            bulk, art.len32_dev, art.node_of_dev, n_replicas=3, emit_nodes=True,
            emit_stats=False, **kw), 2))
    # the work this run's data needs, read from the replica kernel's stats
    # (at R = 1 it makes exactly the fused kernel's draws; its unfilled
    # lanes are the fused kernel's tail lanes)
    n_segs = art.n_segs
    _, st1 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev, n_replicas=1,
                                    emit_stats=True, **kw)
    _, st3 = ap.place_replicas_cuda(bulk, art.len32_dev, art.node_of_dev, n_replicas=3,
                                    emit_stats=True, **kw)
    levels1, draws1 = ladder_work(torch, st1, art.top_level)
    tail1 = int(st1[ref.DEPTH_BINS].view(torch.int32))
    levels3, draws3 = ladder_work(torch, st3, art.top_level)
    search = (n_segs - 1).bit_length()
    work = {
        "place_fused": (
            8 * BULK_IDS + 16 * n_segs,
            OPS_PER_LEVEL * (levels1 + tail1) + OPS_PER_DRAW * draws1 + 6 * search * tail1,
        ),
        "place_replicas": (
            4 * BULK_IDS + 4 * 3 * BULK_IDS + 8 * n_segs,
            OPS_PER_LEVEL * levels3 + (OPS_PER_DRAW + 3) * draws3,
        ),
    }
    print(f"  work: R=1 {levels1} levels / {draws1} draws / {tail1} tail lanes; "
          f"R=3 {levels3} levels / {draws3} draws")

    # -- phase 5: serving main path ------------------------------------------
    print(f"phase 5: RequestStreamDriver batch {SERVE_BATCH}, {SERVE_KEYS} keys, "
          f"zipf 1.1, R=3, pow2, {SERVE_STEPS} steps")
    cfg = dict(batch=SERVE_BATCH, n_keys=SERVE_KEYS, law="zipf", alpha=1.1,
               n_replicas=3, policy="pow2", seed=seed)
    metrics = MetricsRegistry()
    driver = RequestStreamDriver(engine, metrics=metrics, **cfg)
    torch.cuda.synchronize()
    chosen, step_ev = [], []
    ap.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SERVE_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            chosen.append(driver.step())
            e.record()
            step_ev.append((s, e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    serve_launches = dict(ap.LAUNCHES)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
    step_ms = [s.elapsed_time(e) for s, e in step_ev]
    print(f"  launches {serve_launches}, uploads {engine.uploads}, "
          f"step_traces {driver.step_traces}")
    require(serve_launches["place_replicas"] > 0, "serving did not launch the replica kernel")
    require(engine.uploads == 1, f"engine uploaded {engine.uploads} tables")
    counts = driver.load_counts()
    require(int(counts.sum()) == SERVE_STEPS * SERVE_BATCH, f"counts sum {counts.sum()}")
    live = torch.tensor(sorted(cluster.nodes), device=dev, dtype=torch.int32)
    require(bool(torch.isin(torch.stack(chosen), live).all()), "a request went to a dead node")
    snap = metrics.snapshot()
    require(np.array_equal(snap["serve.served"].astype(np.int64), counts.astype(np.int64)),
            "slab serve.served != load_counts")
    skew, p99 = driver.load_skew(), driver.queue_p99()
    print(f"  step median {statistics.median(step_ms):.4f} ms (CUDA events), "
          f"{wall_ms:.4f} ms wall incl. enqueue; load_skew {skew:.6f}, queue_p99 {p99}")
    t0 = time.perf_counter()
    cpu_metrics = MetricsRegistry(device="cpu")
    cpu = RequestStreamDriver(
        PlacementEngine(make_cluster(caps[LADDER_NODES]), device="cpu"),
        metrics=cpu_metrics, **cfg,
    )
    for i in range(SERVE_STEPS):
        bad, _ = mismatches(torch, chosen[i].cpu(), cpu.step())
        require(bad == 0, f"step {i}: {bad} chosen nodes differ from the CPU driver")
    for name in ("counts", "queue", "qhist"):
        bad, _ = mismatches(torch, getattr(driver, name).cpu(), getattr(cpu, name))
        require(bad == 0, f"{name} differs from the CPU driver")
    cpu_snap = cpu_metrics.snapshot()
    for name, v in snap.items():
        require(np.array_equal(np.asarray(v), np.asarray(cpu_snap[name])),
                f"slab {name} differs from the CPU driver")
    print(f"  equal to the CPU driver (twins) in chosen, counts, queue, qhist and slab "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    if profile:
        prof = profile_steps(torch, RequestStreamDriver(engine, **cfg), 4)
        busy, wall = prof["busy_ms_per_step"], prof["wall_ms_per_step"]
        if busy > 0:
            print(f"  profiler: {wall:.4f} ms wall / {busy:.4f} ms device busy per step "
                  f"(idle share {1 - busy / wall:.4f}), "
                  f"{prof['kernels_per_step']:.0f} kernels per step")
            for name, ms_step, n in prof["top"]:
                print(f"    {ms_step:9.4f} ms/step {n:4d}x  {name}")
        else:
            print("  profiler: device time not measured (no CUDA events in the trace)")

    # -- phase 6: the kernels line -------------------------------------------
    kernels = []
    for name in ("place_fused", "place_replicas"):
        b_ms, b_by = bound(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": bulk_launches[name] + serve_launches[name],
            "max_abs_err": worst[name], "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"phase 6: {name}: 0 mismatches, {ms[name]:.4f} ms vs bound {b_ms:.4f} ms "
              f"({b_by}), twin {plain[name]:.2f} ms")
    return {"kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace serving steps with torch.profiler")
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    result = run(args.seed, torch.device("cuda", torch.cuda.current_device()), args.profile)
    print(json.dumps(result))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
