"""Training launcher of the port, on the CUDA card by default.

Wires every substrate together, as the reference's ``repro.launch.train``:
the ASURA-placed data pipeline (its ownership sweep is one launch of the
fused placement kernel on the card) -> the model -> AdamW -> the
ASURA-replicated checkpoint store (chunk placement through the replica
kernel) with async saves.  The weights are synthetic, drawn from
``--seed``; the data are the pipeline's synthetic shards.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--reduced] --steps 20 --batch 8 --seq 128 [--microbatches 1] \\
        [--remat nothing] [--device cpu] [--seed 0]

It prints the reference's lines (the config, this host's shards, the loss
every 5 steps, the loss first -> last), then the median step time (CUDA
events on the card, the host clock on the CPU) with tokens/s, and the
peak device memory.  It returns 0 only if the loss improved (the mean of
the last 3 steps below that of the first 3).  Without ``--device`` it
runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..checkpoint import AsuraCheckpointStore, CheckpointManager
from ..configs import ARCHS, get_config
from ..core import make_uniform_cluster
from ..data import DataPipeline, ShardedDataset
from ..device import resolve_device
from ..models import init_params, layers, reduced_config
from ..models.lm import _REMAT_POLICIES, set_remat_policy
from ..train import AdamWConfig, init_train_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic weights")
    ap.add_argument("--remat", choices=_REMAT_POLICIES, default=None,
                    help="per-layer remat policy (default: as set, 'nothing' at import)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")
    return ap


def run(argv=None) -> dict:
    """The CLI: parse ``argv``, train, checkpoint, print; -> what it
    measured (config, device, the pipeline, the checkpoint manager, the
    last save's (step, state) or None, the final parameters and optimizer
    state, every step's loss, the median step ms and tokens/s, peak memory
    in bytes (None on the CPU), the host wall of each ``save_async`` call
    (the state's copy to the host), rc)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.remat is not None:
        set_remat_policy(args.remat)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr), n_microbatches=args.microbatches)
    print(f"arch={cfg.name} params~{cfg.param_count():.3g}")

    # data: ASURA-placed shards for this host
    ingest = make_uniform_cluster(args.hosts, device=dev)
    dataset = ShardedDataset(
        n_shards=max(64, args.hosts * 8),
        tokens_per_shard=args.batch * args.seq * 4,
        vocab=cfg.vocab,
    )
    pipeline = DataPipeline(
        dataset, ingest, args.host_id, batch_per_host=args.batch, seq_len=args.seq
    )
    print(f"host {args.host_id} owns {pipeline.owned_shards.size} shards")

    # checkpoint store: ASURA-replicated
    store = AsuraCheckpointStore({i: 1.0 for i in range(6)}, n_replicas=3, device=dev)
    mgr = CheckpointManager(store)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = init_train_state(cfg, params)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    it = pipeline.batches()
    losses, marks, saves, last_save = [], [], [], None
    t0 = time.time()
    for step in range(args.steps):
        try:
            tokens = next(it)
        except StopIteration:
            it = pipeline.batches(epoch=step)
            tokens = next(it)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if cfg.family == "encdec":  # the stub audio frontend's frames, as the reference
            batch["frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                          dtype=torch.bfloat16, device=dev)
        if cfg.vision_prefix:
            batch["patches"] = torch.zeros((args.batch, cfg.vision_prefix, cfg.d_model),
                                           dtype=layers.COMPUTE_DTYPE, device=dev)
        if on_card:
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            end.record()
        else:
            begin = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            end = time.perf_counter()
        marks.append((begin, end))
        losses.append(float(metrics["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            print(
                f"step {step:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / (step + 1):.2f}s/step)"
            )
        if args.ckpt_every and step % args.ckpt_every == 0 and step > 0:
            last_save = (step, {"params": params, "opt": opt_state})
            t_save = time.perf_counter()
            mgr.save_async(*last_save)
            saves.append(time.perf_counter() - t_save)
    mgr.wait()
    first = float(np.mean(losses[:3]))
    last = float(np.mean(losses[-3:]))
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")

    if on_card:
        torch.cuda.synchronize(dev)
        step_ms = [b.elapsed_time(e) for b, e in marks]
        peak = torch.cuda.max_memory_allocated(dev)
        name, timer = torch.cuda.get_device_name(dev), "cuda events"
    else:
        step_ms = [(e - b) * 1e3 for b, e in marks]
        peak, name, timer = None, "cpu", "host clock"
    median = statistics.median(step_ms) if step_ms else float("nan")
    tok_s = args.batch * args.seq * 1e3 / median if step_ms else float("nan")
    print(f"train step {median:.4f} ms (median of {len(step_ms)}, {timer}, batch {args.batch} "
          f"x {args.seq}, {args.microbatches} microbatch(es)): {tok_s:.1f} tokens/s on {name}")
    print(f"peak memory {peak / 2**30:.4f} GiB on {name}" if peak is not None
          else "peak memory not measured (cpu)")
    return {"cfg": cfg, "device": dev, "pipeline": pipeline, "manager": mgr,
            "last_save": last_save, "params": params, "opt_state": opt_state,
            "losses": losses, "step_ms": median, "tok_s": tok_s, "peak_bytes": peak,
            "save_s": saves, "rc": 0 if last < first else 1}


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
