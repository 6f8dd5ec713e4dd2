"""Serving driver of the port: batched greedy decode with ASURA request
routing, on the CUDA card by default.

Requests are routed to serving replicas by ASURA on the request id -- the
placement function the storage layer uses (on the card, one launch of the
fused placement kernel), so adding or removing a replica moves only the
minimal set of sessions.  This process plays one replica: it takes its
share of a synthetic request stream and decodes ``--decode-len`` greedy
tokens per request, in batches, each batch against a fresh ring-buffer KV
cache.  The weights are synthetic, drawn from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--reduced] [--layers N] --replicas 4 --replica-id 0 --requests 64 \\
        --batch 8 --decode-len 8 --cache-len 64 [--device cpu] [--seed 0]

``--layers`` cuts the depth (widths stay the config's), so that a model
larger than the card runs at full width: ``--arch mixtral-8x22b --layers
2``; deepseek-v2-236b keeps its leading dense layer, so ``--layers 2`` is
one dense and one MoE layer; recurrentgemma-9b keeps whole (rec, rec,
attn) super-blocks plus the tail (``--layers 4``: one super-block and one
recurrent layer); whisper-large-v3 cuts its decoder (the encoder keeps
its 32 layers).  Every family runs: dense, MoE / MLA, the RG-LRU hybrid,
RWKV6 and the encoder-decoder, which decodes against the cache's zero
encoder output, as the reference does.

It prints the reference's two lines (the routed share; requests x tokens
in seconds and tok/s, counting the lanes decoded: the routed requests
padded to whole batches, as the reference does), then the decode time per step (median; CUDA events
on the card, the host clock on the CPU) and the tokens/s of one step.
Without ``--device`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import make_uniform_cluster
from ..device import resolve_device
from ..models import init_cache, init_params, reduced_config
from ..models.config import ModelConfig
from ..train import make_serve_step


@dataclasses.dataclass
class Decoded:
    """What ``decode_requests`` produced, one row per request id."""

    tokens: np.ndarray  # (n, decode_len) int64: the greedy token of each step
    step_ms: list  # one per decode step, every batch
    timer: str  # "cuda events" or "host clock"


def decode_requests(cfg: ModelConfig, params: dict, ids, *, batch: int, decode_len: int,
                    cache_len: int, device, on_step=None) -> Decoded:
    """Greedy decode of ``decode_len`` tokens for each request id, the
    reference's loop (``repro/launch/serve.py``): ids in batches of
    ``batch`` (the tail batch padded with id 0), each batch against a fresh
    cache of ``cache_len`` positions; a request's first token is ``id %
    vocab`` and step t runs at position t.  The steps make no host sync;
    the tokens come to the host once, at the end.  Each step's logits are
    dropped once its tokens are taken, so memory does not grow with the
    number of requests; ``on_step(start, t, logits)``, if given, sees the
    (n, vocab) fp32 logits of requests ``start .. start + n`` at step t."""
    dev = resolve_device(device)
    ids = np.asarray(ids, dtype=np.uint32)
    serve = make_serve_step(cfg)
    on_card = dev.type == "cuda"
    tokens_out = [torch.zeros((0, decode_len), dtype=torch.int32, device=dev)]
    marks = []
    for start in range(0, ids.size, batch):
        chunk = ids[start:start + batch]
        n = chunk.size
        if n < batch:  # pad the tail batch
            chunk = np.pad(chunk, (0, batch - n))
        cache = init_cache(cfg, batch, cache_len, device=dev)
        tokens = torch.from_numpy((chunk % cfg.vocab).astype(np.int32)).to(dev)[:, None]
        steps_t = []
        for t in range(decode_len):
            step = {"tokens": tokens,
                    "positions": torch.full((batch, 1), t, dtype=torch.int32, device=dev)}
            if on_card:
                begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                begin.record()
                logits, cache = serve(params, cache, step)
                end.record()
            else:
                begin = time.perf_counter()
                logits, cache = serve(params, cache, step)
                end = time.perf_counter()
            marks.append((begin, end))
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            steps_t.append(tokens[:n, 0])
            if on_step is not None:
                on_step(start, t, logits[:n])
        tokens_out.append(torch.stack(steps_t, dim=1))
    tokens_host = torch.cat(tokens_out).cpu().numpy().astype(np.int64)  # syncs
    if on_card:
        step_ms = [b.elapsed_time(e) for b, e in marks]
    else:
        step_ms = [(e - b) * 1e3 for b, e in marks]
    return Decoded(tokens_host, step_ms, "cuda events" if on_card else "host clock")


def cut_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to ``n`` layers, widths kept (``--layers``): the dense
    and MoE models keep their leading dense layers and need one more;
    recurrentgemma keeps whole ``block_pattern`` super-blocks and the
    tail, ``divmod(n, len(block_pattern))``, and needs one pattern; the
    encoder-decoder cuts its decoder only; RWKV6 cuts its layers."""
    if cfg.family == "rglru":
        first, why = len(cfg.block_pattern), f"one block pattern {cfg.block_pattern}"
    elif cfg.moe is not None:
        first, why = cfg.n_dense_layers + 1, "its leading dense layers and one more"
    else:
        first, why = 1, "one layer"
    if n < first:
        raise ValueError(f"--layers {n}: {cfg.name} needs at least {first} ({why})")
    return dataclasses.replace(cfg, n_layers=n)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the config's)")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--replica-id", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--decode-len", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic weights")
    return ap


def run(argv=None) -> dict:
    """The CLI: parse ``argv``, route, decode, print; -> what it measured
    (config, parameters, device, the routing engine, every request's
    owner, this replica's ids, ``Decoded``, the lanes decoded (the ids
    padded to whole batches, as the reference counts them), wall seconds,
    median step ms and tokens/s)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)

    # ASURA request routing via the PlacementEngine: the replica-membership
    # table is canonicalized once and reused for every routing call below.
    routing = make_uniform_cluster(args.replicas, device=dev)
    engine = routing.engine
    req_ids = np.arange(args.requests, dtype=np.uint32)
    owners = engine.place_nodes(req_ids)
    mine = req_ids[owners == args.replica_id]
    print(
        f"replica {args.replica_id} serves {mine.size}/{args.requests} requests "
        f"(engine backend={engine.backend}, table uploads={engine.uploads})"
    )

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator, device=dev)
    t0 = time.perf_counter()
    out = decode_requests(cfg, params, mine, batch=args.batch, decode_len=args.decode_len,
                          cache_len=args.cache_len, device=dev)
    wall = time.perf_counter() - t0
    # the reference counts every lane decoded, the tail batch's pad lanes too
    done = -(-int(mine.size) // args.batch) * args.batch
    print(
        f"decoded {done} requests x {args.decode_len} tokens in {wall:.2f}s "
        f"({done * args.decode_len / max(wall, 1e-9):.1f} tok/s)"
    )
    step_ms = statistics.median(out.step_ms) if out.step_ms else float("nan")
    tok_s = args.batch * 1e3 / step_ms if out.step_ms else float("nan")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"decode step {step_ms:.4f} ms (median of {len(out.step_ms)}, {out.timer}, "
          f"batch {args.batch}): {tok_s:.1f} tok/s on {name}")
    return {"cfg": cfg, "params": params, "device": dev, "engine": engine, "owners": owners,
            "ids": mine, "decoded": out, "lanes": done, "wall_s": wall, "step_ms": step_ms,
            "tok_s": tok_s}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
