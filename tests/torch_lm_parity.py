"""Parity helpers shared by the port's language-model tests on the CPU:
the reduced MoE models with the same weights in both packages, the fp32
switch of both, and the reference's AdamW steps and gradients against
the port's.

The training tolerances are the ones ``tests/test_torch_train.py``'s
docstring states: fp32 leaves at ``rtol=1e-4, atol=1e-5 x max |reference
leaf|``, each step's update at its own scale plus the gradient's
tolerance carried through Adam's step, steps at ``PARITY_OPT``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.models import init_params, loss_fn, reduced_config
from repro_torch.models import layers as tl
from repro_torch.train.optimizer import tree_flatten

RTOL = 1e-4
PARITY_OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)

_SETUPS: dict = {}


def reference_tree(tree: dict) -> dict:
    """A port tree's values as the reference's jax arrays, key for key."""
    return {k: reference_tree(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


def reduced_setup(arch: str):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced size: one draw of the port's ``init_params`` (the reference's
    distribution), the same values in both packages (cached)."""
    if arch not in _SETUPS:
        c = reduced_config(configs.get_config(arch))
        tp = init_params(c, torch.Generator().manual_seed(0), device="cpu")
        jc = japi.reduced_config(jconfigs.get_config(arch))
        _SETUPS[arch] = (jc, reference_tree(tp), c, tp)
    return _SETUPS[arch]


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 inside the test."""
    for mod in (jl, jlm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    saved = tl.COMPUTE_DTYPE
    tl.set_compute_dtype(torch.float32)
    yield "fp32"
    tl.set_compute_dtype(saved)


def _port_value_and_grad(cfg, params, batch):
    leaves, rebuild = tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    val, aux = loss_fn(cfg, rebuild(xs), batch)
    grads = list(torch.autograd.grad(val, xs))
    return val.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _hold_leaves(got, want):
    """Each port leaf against the reference's, in ``jax.tree.leaves``
    order, at atol 1e-5 x max |reference leaf|."""
    got = got if isinstance(got, list) else tree_flatten(got)[0]
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=RTOL,
                                   atol=1e-5 * float(np.abs(w).max()))


def _hold_update(before, after, jbefore, jafter, jprev, jstate, tree_floor=False):
    """The port's update ``after - before`` against the reference's
    ``jafter - jbefore``, one step from the same parameters and AdamW state
    ``jprev`` (the reference's state after it: ``jstate``), leaf by leaf,
    at the module docstring's tolerance.  ``tree_floor``: the gradient's
    absolute tolerance is at least 2**-23 x the largest |gradient| of the
    whole tree -- one backward pass rounds every leaf at that scale, which
    a leaf whose gradients are a thousandth of the others' (whisper's
    cross-attention keys at init) sits under."""
    o = jopt.AdamWConfig(**PARITY_OPT)
    k = int(jstate["count"])
    bc1, bc2 = 1 - o.b1**k, 1 - o.b2**k
    lr = o.lr * min(1.0, k / max(o.warmup_steps, 1))

    def leaves(tree):
        return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]

    got = [(a.double() - b.double()).numpy() for a, b in zip(tree_flatten(after)[0],
                                                             tree_flatten(before)[0])]
    want = [a - b for a, b in zip(leaves(jafter), leaves(jbefore))]
    m0, m, v = leaves(jprev["m"]), leaves(jstate["m"]), leaves(jstate["v"])
    assert len(got) == len(want) == len(m)
    grads = [(m[i] - o.b1 * m0[i]) / (1 - o.b1) for i in range(len(m))]  # the clipped gradients
    floor = 2.0**-23 * max(float(np.abs(g).max()) for g in grads) if tree_floor else 0.0
    for i, (g_, w) in enumerate(zip(got, want)):
        grad = grads[i]
        big_m, root = m[i] / bc1, np.sqrt(v[i] / bc2)
        d_root = np.divide((1 - o.b2) * grad, bc2 * root, out=np.zeros_like(root),
                           where=root > 0)
        d_step = np.abs(((1 - o.b1) / bc1 * (root + o.eps) - big_m * d_root)
                        / (root + o.eps) ** 2)
        from_grad = lr * d_step * (RTOL * np.abs(grad)
                                   + max(1e-5 * np.abs(grad).max(), floor))
        own = RTOL * np.abs(w) + 1e-5 * np.abs(w).max()
        bad = np.abs(g_ - w) > own + from_grad
        assert not bad.any(), (i, int(bad.sum()), float(np.abs(g_ - w)[bad].max()))


def _hold_state(got, want):
    _hold_leaves(got["m"], want["m"])
    _hold_leaves(got["v"], want["v"])
    assert got["count"].dtype == torch.int32 and got["count"].shape == ()
    assert int(got["count"]) == int(want["count"])


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol)


def family_batch(cfg, toks, seed=0):
    """(reference batch, port batch) of ``toks`` (B, S) plus the family's
    extra input: encdec's (B, enc_seq, D) frames (standard normal, from a
    NumPy seed; both packages cast them to the compute dtype alike)."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        frames = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    return jb, tb


def hold_decode(jc, jp, c, tp, toks, cache_len, tol, prepare=None):
    """Decode ``toks`` (B, T) one token a step, token t at position t, in
    both packages from a fresh cache of ``cache_len`` positions (``prepare
    (jcache, tcache) -> (jcache, tcache)`` may fill it first): each step's
    logits at ``tol``, the port's cache consumed (the same dict back), and
    after each step every cache leaf against the reference's -- integer
    leaves (ring positions, indices) exactly, float leaves (K / V rings,
    recurrent states) at ``tol``'s rtol and its atol times the leaf's
    largest magnitude (at least 1): a bf16 rounding that differs in one
    layer reaches the next layer's normed input, which an RWKV "prev" or a
    recurrent state keeps.  -> the last (reference, port) caches."""
    from repro_torch.models import decode_step, init_cache

    b, steps = toks.shape
    jcache, tcache = jlm.init_cache(jc, b, cache_len), init_cache(c, b, cache_len, device="cpu")
    if prepare is not None:
        jcache, tcache = prepare(jcache, tcache)
    step = jax.jit(lambda p, cc, bb: jlm.decode_step(jc, p, cc, bb))
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                         "positions": jnp.asarray(pos)})
        got, same = decode_step(c, tp, tcache, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                "positions": torch.from_numpy(pos)})
        assert same is tcache
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, c.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        wl = jax.tree.leaves(jcache)
        gl = tree_flatten(tcache)[0]
        assert len(wl) == len(gl)
        for g, w in zip(gl, wl):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            if g.is_floating_point():
                w = w.astype(np.float32)
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g.float().numpy(), w, rtol=tol["rtol"],
                                           atol=tol["atol"] * scale)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
    return jcache, tcache
