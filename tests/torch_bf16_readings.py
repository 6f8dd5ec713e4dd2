"""CPU readings behind ``chip_smoke.py``'s phase-16d / 16e limits (not a
test module: pytest does not collect it).

For the reduced recurrentgemma-9b, rwkv6-3b and whisper-large-v3, 4
weight draws each (one draw of the port's ``init_params``, the same values
in both packages), the reference's bf16 run is held to the port's fp32
run with the port's bf16 run as the control, and the reverse -- the
reading chip_smoke.py takes of the card, with another bf16
implementation in the card's place:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_bf16_readings.py serve
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_bf16_readings.py train

"serve": logits of a prefill 8 x 300 and 20 decode steps; "train": one
2 x 128 AdamW step's loss, ``grad_norm`` and moments ``m`` and ``v``.
Each reading is max |held - fp32| over max |control - fp32| (at least
2**-8 x max |fp32|).
"""
import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax
import jax.numpy as jnp
import numpy as np
import torch
from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.models import decode_step, init_cache, init_params, prefill, reduced_config
from repro_torch.models import layers as tl
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_flatten
from torch_lm_parity import family_batch, reference_tree

ARCHS = ("recurrentgemma-9b", "rwkv6-3b", "whisper-large-v3")
B, P, N = 8, 300, 20  # prefill batch x length, decode steps
DRAWS = 4


@contextlib.contextmanager
def port_fp32():
    tl.set_compute_dtype(torch.float32)
    try:
        yield
    finally:
        tl.set_compute_dtype(torch.bfloat16)


def port_logits(c, tp, tb, toks) -> list:
    out = [prefill(c, tp, tb)]
    cache = init_cache(c, B, P, device="cpu")
    for t in range(N):
        logits, cache = decode_step(c, tp, cache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "positions": torch.full((B, 1), t, dtype=torch.int32)})
        out.append(logits)
    return [o.float().numpy() for o in out]


def ref_logits(jc, jp, jb, toks) -> list:
    out = [np.asarray(jax.jit(lambda p, b: jlm.prefill(jc, p, b))(jp, jb))]
    cache = jlm.init_cache(jc, B, P)
    step = jax.jit(lambda p, c, b: jlm.decode_step(jc, p, c, b))
    for t in range(N):
        logits, cache = step(jp, cache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                         "positions": jnp.full((B, 1), t, jnp.int32)})
        out.append(np.asarray(logits))
    return out


def reading(held, control, truth) -> float:
    """max |held - truth| over max |control - truth|, the latter at least
    2**-8 x max |truth|, over lists of arrays."""
    def dist(xs, ys):
        return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                   for x, y in zip(xs, ys))

    floor = 2.0**-8 * max(float(np.abs(t).max()) for t in truth)
    return dist(held, truth) / max(dist(control, truth), floor)


def serve_readings(c, jc, tp, jp, rng, draw) -> list:
    toks = rng.integers(0, c.vocab, (B, P)).astype(np.int32)
    jb, tb = family_batch(c, toks, seed=draw)
    port = port_logits(c, tp, tb, toks)
    with port_fp32():
        truth = port_logits(c, tp, tb, toks)
    ref = ref_logits(jc, jp, jb, toks)
    return ([reading([r], [p], [t]) for r, p, t in zip(ref, port, truth)]
            + [reading([p], [r], [t]) for r, p, t in zip(ref, port, truth)])


def train_readings(c, jc, tp, jp, rng, draw) -> list:
    toks = rng.integers(0, c.vocab, (2, 128)).astype(np.int32)
    jb, tb = family_batch(c, toks, seed=draw)
    step = make_train_step(c, AdamWConfig(warmup_steps=1))

    def port(fp32):
        with port_fp32() if fp32 else contextlib.nullcontext():
            _, st, m = step(tp, init_train_state(c, tp), tb)
        return {"loss": [m["loss"].numpy()], "grad_norm": [m["grad_norm"].numpy()],
                **{k: [x.numpy() for x in tree_flatten(st[k])[0]] for k in ("m", "v")}}

    bf16, truth = port(False), port(True)
    jstep_fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(warmup_steps=1)))
    _, js, jm = jstep_fn(jp, jstep.init_train_state(jc, jp), jb)
    ref = {"loss": [np.asarray(jm["loss"])], "grad_norm": [np.asarray(jm["grad_norm"])],
           **{k: [np.asarray(x) for x in jax.tree.leaves(js[k])] for k in ("m", "v")}}
    out = []
    for k in bf16:
        out += [reading(ref[k], bf16[k], truth[k]), reading(bf16[k], ref[k], truth[k])]
        print(f"    {k}: {out[-2]:.4f} / {out[-1]:.4f}")
    return out


def main(mode: str) -> None:
    torch.set_num_threads(4)
    worst = []
    for arch in ARCHS:
        c = reduced_config(configs.get_config(arch))
        jc = japi.reduced_config(jconfigs.get_config(arch))
        rs = []
        for draw in range(DRAWS):
            tp = init_params(c, torch.Generator().manual_seed(draw), device="cpu")
            jp = reference_tree(tp)
            rng = np.random.default_rng(draw)
            fn = serve_readings if mode == "serve" else train_readings
            got = fn(c, jc, tp, jp, rng, draw)
            rs += got
            print(f"{arch} seed {draw}: readings {min(got):.4f} .. {max(got):.4f}", flush=True)
        print(f"{arch}: largest {max(rs):.4f} of {len(rs)}")
        worst += rs
    print(f"all: largest {max(worst):.4f} of {len(worst)}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "serve")
