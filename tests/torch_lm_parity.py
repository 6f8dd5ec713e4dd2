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


def _hold_update(before, after, jbefore, jafter, jprev, jstate):
    """The port's update ``after - before`` against the reference's
    ``jafter - jbefore``, one step from the same parameters and AdamW state
    ``jprev`` (the reference's state after it: ``jstate``), leaf by leaf,
    at the module docstring's tolerance."""
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
    for i, (g_, w) in enumerate(zip(got, want)):
        grad = (m[i] - o.b1 * m0[i]) / (1 - o.b1)  # the clipped gradient
        big_m, root = m[i] / bc1, np.sqrt(v[i] / bc2)
        d_root = np.divide((1 - o.b2) * grad, bc2 * root, out=np.zeros_like(root),
                           where=root > 0)
        d_step = np.abs(((1 - o.b1) / bc1 * (root + o.eps) - big_m * d_root)
                        / (root + o.eps) ** 2)
        from_grad = lr * d_step * (RTOL * np.abs(grad) + 1e-5 * np.abs(grad).max())
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
