"""The port's recurrent mixers (``repro_torch.models.recurrent``) held to
the reference's ``repro.models.recurrent`` on the CPU, function by function.

RG-LRU (recurrentgemma) and RWKV6 at the reduced widths (d_model 128, LRU
width 128, RWKV head dim 32), the reference's weights carried across with
``convert.model_params_from_reference``, inputs from NumPy seeds.
Tolerances: fp32 inputs at ``rtol=1e-4, atol=1e-5`` (outputs, carried
states and gradients); bf16 inputs at ``rtol=atol=2e-2``, the reference's
bf16 tolerance (``tests/test_layer_math.py``).  The deterministic leaves
are the reference's values: the constants exactly, ``a_param`` at ``rtol
2e-5`` (the two packages' fp32 linspace differs by up to 2 ulp, which
``-log`` near 0.999 magnifies about 1000-fold).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import recurrent as jr
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import recurrent as tr
from repro_torch.models import reduced_config

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
TOL = {"fp32": FP32, "bf16": BF16}
DTYPES = ("fp32", "bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: under
    a parallel test run the default threads of every worker fight over the
    same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **changes):
    jc = japi.reduced_config(jconfigs.get_config(arch))
    c = reduced_config(configs.get_config(arch))
    return dataclasses.replace(jc, **changes), dataclasses.replace(c, **changes)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(rng, shape, dtype, scale=1.0):
    """The same values on both sides: (jax array, torch tensor) in fp32 or
    bf16, from a NumPy draw."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dtype == "fp32":
        return jnp.asarray(a), torch.from_numpy(a)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _port(tree):
    return model_params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, dtype):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Trees, deterministic leaves, state inits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_inits_match_reference_trees_and_deterministic_leaves(arch, width):
    """Keys, shapes and dtypes of every init and state init, stacked
    (``lead``) and not; the deterministic leaves' values."""
    full = width == "full"
    jc = jconfigs.get_config(arch) if full else japi.reduced_config(jconfigs.get_config(arch))
    c = configs.get_config(arch) if full else reduced_config(configs.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    if arch == "recurrentgemma-9b":
        pairs = [(jr.rglru_init, tr.rglru_init)]
        states = (jr.rglru_state_init, tr.rglru_state_init)
        constants = {"conv_b"}
    else:
        pairs = [(jr.rwkv6_timemix_init, tr.rwkv6_timemix_init),
                 (jr.rwkv6_channelmix_init, tr.rwkv6_channelmix_init)]
        states = (jr.rwkv6_state_init, tr.rwkv6_state_init)
        constants = {"mix_base", "decay_base", "ln_scale", "mix_k", "mix_r"}
    for j_init, t_init in pairs:
        want = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jc)) if full else j_init(
            jax.random.PRNGKey(0), jc)
        shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
        assert _shapes(t_init(torch.Generator(), c, device="meta")) == shapes
        stacked = t_init(None, c, lead=(3,), device="meta")
        assert _shapes(stacked) == {k: ((3, *s), d) for k, (s, d) in shapes.items()}
        if full:
            continue
        got = t_init(gen, c, lead=(2,), device="cpu")
        for name in constants & set(got):
            for layer in got[name]:
                np.testing.assert_array_equal(layer.numpy(), np.asarray(want[name]))
        if "a_param" in got:
            for layer in got["a_param"]:
                np.testing.assert_allclose(layer.numpy(), np.asarray(want["a_param"]),
                                           rtol=2e-5)
    jstate = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          jax.eval_shape(lambda: states[0](jc, 3)))
    assert _shapes(states[1](c, 3, device="meta")) == jstate
    zeros = states[1](c, 3, lead=(2,), device="cpu")
    assert all(float(x.abs().max()) == 0.0 for x in jax.tree.leaves(zeros))


def test_a_param_holds_the_reference_decays_at_full_width():
    """recurrentgemma's 4,096 decays: a_param against the reference's to
    2e-5, and sigmoid(a_param) = linspace(0.9, 0.999) to fp32 rounding."""
    c = configs.get_config("recurrentgemma-9b")
    want = np.asarray(jr.rglru_init(jax.random.PRNGKey(0), jconfigs.get_config(
        "recurrentgemma-9b"))["a_param"])
    got = tr._a_param(c.lru_width, "cpu")
    assert got.dtype == torch.float32 and got.shape == (4096,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    lin = np.linspace(0.9, 0.999, 4096)
    np.testing.assert_allclose(torch.sigmoid(got.double()).numpy(), lin, rtol=1e-6)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["zero tail", "carried tail"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(0)
    jx, tx = _inputs(rng, (2, 9, 16), dtype)
    w = rng.standard_normal((tr.CONV_WIDTH, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    state = rng.standard_normal((2, tr.CONV_WIDTH - 1, 16)).astype(np.float32) if with_state \
        else None
    want, want_tail = jr._causal_conv(jx, jnp.asarray(w), jnp.asarray(bias),
                                      None if state is None else jnp.asarray(state))
    got, tail = tr._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(bias),
                                None if state is None else torch.from_numpy(state))
    assert got.dtype == tx.dtype and tail.dtype == tx.dtype
    _close(got, want, dtype)
    _close(tail, want_tail, dtype)
    if dtype == "bf16":  # the sum in bf16, as the reference: not the fp32 sum rounded once
        exact = tr._causal_conv(tx.float(), torch.from_numpy(w), torch.from_numpy(bias),
                                None if state is None else torch.from_numpy(state))[0]
        assert not torch.equal(got, exact.to(torch.bfloat16))


@pytest.mark.parametrize("s", [1, 2, 3, 5, 64, 100])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against the sequential recurrence in float64,
    from zero and from a carried h."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, s, 4)))
    b = torch.from_numpy(rng.standard_normal((3, s, 4)))
    h0 = torch.from_numpy(rng.standard_normal((3, 4)))
    for start in (None, h0):
        h = torch.zeros(3, 4, dtype=torch.float64) if start is None else start
        want = []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = tr._linear_scan(a, b, start)
        np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_prefill_matches_reference(dtype, s):
    """The full-sequence path (the associative scan) and its new state."""
    jc, c = _cfgs("recurrentgemma-9b")
    jp = jr.rglru_init(jax.random.PRNGKey(1), jc)
    tp = _port(jp)
    jx, tx = _inputs(np.random.default_rng(2), (2, s, c.d_model), dtype)
    want, wstate = jr.rglru_apply(jc, jp, jx)
    got, state = tr.rglru_apply(c, tp, tx)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    for k in ("h", "conv"):
        assert state[k].dtype == torch.float32
        _close(state[k], wstate[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_carries_state_as_reference(dtype):
    """A prefix of 8 tokens, then 4 one-token steps, then a 3-token step,
    each from the carried state (written in place in the port)."""
    jc, c = _cfgs("recurrentgemma-9b")
    jp = jr.rglru_init(jax.random.PRNGKey(3), jc)
    tp = _port(jp)
    jx, tx = _inputs(np.random.default_rng(4), (2, 15, c.d_model), dtype)
    jstate, tstate = jr.rglru_state_init(jc, 2), tr.rglru_state_init(c, 2)
    for lo, hi in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12), (12, 15)):
        want, jstate = jr.rglru_apply(jc, jp, jx[:, lo:hi], state=jstate)
        got, same = tr.rglru_apply(c, tp, tx[:, lo:hi], state=tstate)
        assert same is tstate  # consumed: written in place
        _close(got, want, dtype)
        for k in ("h", "conv"):
            _close(tstate[k], jstate[k], dtype)


def test_rglru_gradients_match_reference():
    """fp32: d(sum of out * g) / d(every leaf, x) through the scan."""
    jc, c = _cfgs("recurrentgemma-9b")
    jp = jr.rglru_init(jax.random.PRNGKey(5), jc)
    rng = np.random.default_rng(6)
    jx, tx = _inputs(rng, (2, 21, c.d_model), "fp32")
    g = rng.standard_normal((2, 21, c.d_model)).astype(np.float32)

    def f(p, x):
        return jnp.sum(jr.rglru_apply(jc, p, x)[0] * g)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(jp, jx)
    tp = {k: v.requires_grad_() for k, v in _port(jp).items()}
    tx.requires_grad_()
    (tr.rglru_apply(c, tp, tx)[0] * torch.from_numpy(g)).sum().backward()
    for k in tp:
        w = np.asarray(want_p[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-6))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_x).max()))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, s, dtype, d=64, decay=0.0):
    """r, k, v at the scale the reduced time mix feeds them (~0.25: normed
    activations through 0.02-scale weights of width 128), log decays
    around -exp(-2 + decay), the bonus at its init's 0.5 scale."""
    jr_, tr_ = _inputs(rng, (2, s, d), dtype, scale=0.25)
    jk, tk = _inputs(rng, (2, s, d), dtype, scale=0.25)
    jv, tv = _inputs(rng, (2, s, d), dtype, scale=0.25)
    logw = -np.exp(rng.standard_normal((2, s, d)).astype(np.float32) * 0.5 - 2.0 + decay)
    u = (rng.standard_normal(d) * 0.5).astype(np.float32)
    return ((jr_, jk, jv, jnp.asarray(logw), jnp.asarray(u)),
            (tr_, tk, tv, torch.from_numpy(logw), torch.from_numpy(u)))


@pytest.mark.parametrize("carried", [False, True], ids=["zero state", "carried state"])
@pytest.mark.parametrize("s", [1, 127, 128, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv_chunked_matches_reference(dtype, s, carried):
    """1 token (a padded chunk), one short chunk, one whole chunk, and three
    chunks the last of them padded; from zero and from a carried state."""
    rng = np.random.default_rng(s)
    jin, tin = _wkv_inputs(rng, s, dtype)
    state = rng.standard_normal((2, 2, 32, 32)).astype(np.float32) if carried else None
    want, wS = jr._wkv_chunked(*jin, 32, None if state is None else jnp.asarray(state))
    got, S = tr._wkv_chunked(*tin, 32, None if state is None else torch.from_numpy(state))
    assert got.dtype == torch.float32 and S.dtype == torch.float32
    _close(got, want, dtype)
    _close(S, wS, dtype)


def test_wkv_clip_matches_reference():
    """Strong decays (per-step log decay near -e^2.5) push -csum past the
    clip at 30 within a chunk: the clipped pairs are the reference's."""
    rng = np.random.default_rng(7)
    jin, tin = _wkv_inputs(rng, 200, "fp32", decay=4.5)
    csum = np.cumsum(np.asarray(jin[3])[:, :128], axis=1)
    assert (-csum > 30.0).mean() > 0.5  # most pairs clipped
    want, wS = jr._wkv_chunked(*jin, 32)
    got, S = tr._wkv_chunked(*tin, 32)
    _close(got, want, "fp32")
    _close(S, wS, "fp32")
    unclipped = jr._wkv_chunked(*jin[:3], jin[3] * 1e-3, jin[4], 32)[0]
    assert np.abs(np.asarray(unclipped) - np.asarray(want)).max() > 1e-3


def test_wkv_chunks_compose_like_the_whole_sequence():
    """The reference's own property: two segments carried through the
    state equal the whole sequence (within fp32 rounding)."""
    rng = np.random.default_rng(8)
    _, (r, k, v, logw, u) = _wkv_inputs(rng, 150, "fp32")
    whole, S = tr._wkv_chunked(r, k, v, logw, u, 32)
    a, Sa = tr._wkv_chunked(r[:, :70], k[:, :70], v[:, :70], logw[:, :70], u, 32)
    b, Sb = tr._wkv_chunked(r[:, 70:], k[:, 70:], v[:, 70:], logw[:, 70:], u, 32, Sa)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Sb.numpy(), S.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_token_shift_matches_reference(dtype):
    rng = np.random.default_rng(9)
    jx, tx = _inputs(rng, (2, 5, 8), dtype)
    prev = rng.standard_normal((2, 1, 8)).astype(np.float32)
    got = tr._token_shift(tx, torch.from_numpy(prev))
    assert got.dtype == tx.dtype
    _close(got, jr._token_shift(jx, jnp.asarray(prev)), dtype)
    assert torch.equal(got[:, 1:], tx[:, :-1])


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_timemix_matches_reference(dtype, with_state):
    """Time mix over 140 tokens (two chunks), then 3 one-token steps from
    the carried state; the new state's "prev" is the input's last token."""
    jc, c = _cfgs("rwkv6-3b")
    jp = jr.rwkv6_timemix_init(jax.random.PRNGKey(10), jc)
    tp = _port(jp)
    rng = np.random.default_rng(11)
    jx, tx = _inputs(rng, (2, 140, c.d_model), dtype)
    jstate = tstate = None
    if with_state:
        S = rng.standard_normal((2, c.d_model // 32, 32, 32)).astype(np.float32) * 0.1
        prev = rng.standard_normal((2, 1, c.d_model)).astype(np.float32)
        jstate = {"S": jnp.asarray(S), "prev": jnp.asarray(prev)}
        tstate = {"S": torch.from_numpy(S.copy()), "prev": torch.from_numpy(prev.copy())}
    want, jstate = jr.rwkv6_timemix_apply(jc, jp, jx, state=jstate)
    got, new = tr.rwkv6_timemix_apply(c, tp, tx, state=tstate)
    assert got.dtype == tx.dtype and (new is tstate) == with_state
    _close(got, want, dtype)
    for k in ("S", "prev"):
        assert new[k].dtype == torch.float32
        _close(new[k], jstate[k], dtype)
    np.testing.assert_array_equal(_np(new["prev"]), _np(tx[:, -1:]))
    for t in range(3):
        jx1, tx1 = _inputs(rng, (2, 1, c.d_model), dtype)
        want, jstate = jr.rwkv6_timemix_apply(jc, jp, jx1, state=jstate)
        got, new = tr.rwkv6_timemix_apply(c, tp, tx1, state=new)
        _close(got, want, dtype)
        _close(new["S"], jstate["S"], dtype)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_channelmix_matches_reference(dtype, with_state):
    jc, c = _cfgs("rwkv6-3b")
    jp = jr.rwkv6_channelmix_init(jax.random.PRNGKey(12), jc)
    tp = _port(jp)
    rng = np.random.default_rng(13)
    jx, tx = _inputs(rng, (3, 7, c.d_model), dtype)
    prev = rng.standard_normal((3, 1, c.d_model)).astype(np.float32)
    jstate = {"prev": jnp.asarray(prev)} if with_state else None
    tstate = {"prev": torch.from_numpy(prev.copy())} if with_state else None
    want, wnew = jr.rwkv6_channelmix_apply(jc, jp, jx, state=jstate)
    got, new = tr.rwkv6_channelmix_apply(c, tp, tx, state=tstate)
    assert (new is tstate) == with_state
    _close(got, want, dtype)
    _close(new["prev"], wnew["prev"], dtype)


def test_timemix_gradients_match_reference():
    """fp32: every leaf's gradient through the mixes, the chunked WKV (two
    chunks) and the per-head norm, and the input's."""
    jc, c = _cfgs("rwkv6-3b")
    jp = jr.rwkv6_timemix_init(jax.random.PRNGKey(14), jc)
    rng = np.random.default_rng(15)
    jx, tx = _inputs(rng, (2, 150, c.d_model), "fp32")
    g = rng.standard_normal((2, 150, c.d_model)).astype(np.float32)

    def f(p, x):
        return jnp.sum(jr.rwkv6_timemix_apply(jc, p, x)[0] * g)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(jp, jx)
    tp = {k: v.requires_grad_() for k, v in _port(jp).items()}
    tx.requires_grad_()
    (tr.rwkv6_timemix_apply(c, tp, tx)[0] * torch.from_numpy(g)).sum().backward()
    for k in tp:
        w = np.asarray(want_p[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_x).max()))
