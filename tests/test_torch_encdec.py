"""The port's encoder-decoder family -- whisper-large-v3 -- served and
trained, held to the reference on the CPU.

At the reference's ``reduced_config`` (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, 16 stub audio frames, vocab 512), the same
weights in both packages (one draw of the port's ``init_params``), tokens
and frames from NumPy seeds.  Tolerances as in
``tests/test_torch_recurrent_lm.py``: fp32 compute at ``rtol=1e-4,
atol=1e-5`` (the loss and ``global_norm`` at ``rtol=1e-4``, gradient
leaves and AdamW updates at ``PARITY_OPT`` as ``tests/test_torch_train.py``
holds them), bf16 at ``rtol=atol=2e-2``, ring positions and indices
exactly.  The encoder is not causal; the decoder's self-attention and the
encoder's attention are roped, cross-attention's queries are not; both
stacks add the fp32 sinusoid.  Decode recomputes every layer's cross K / V
from the cache's ``enc_out`` at every step and leaves it as it is: zeros
from ``init_cache`` (what the serving CLI decodes against, as the
reference), or an encoder output put there.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.convert import (
    model_cache_from_reference,
    model_params_from_reference,
    opt_state_from_reference,
)
from repro_torch.launch import serve, train
from repro_torch.models import (
    SHAPES,
    LanguageModel,
    cache_specs,
    init_cache,
    input_specs,
    make_inputs,
    param_specs,
    prefill,
    reduced_config,
)
from repro_torch.models import lm as tlm
from repro_torch.train import AdamWConfig, global_norm, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_flatten
from torch_lm_parity import (  # noqa: F401
    PARITY_OPT,
    _close,
    _hold_leaves,
    _hold_state,
    _hold_update,
    _port_value_and_grad,
    family_batch,
    fp32,
    hold_decode,
    reduced_setup,
    tokens,
)

ARCH = "whisper-large-v3"
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["fp32", "bf16"])
def compute(request):
    if request.param == "fp32":
        request.getfixturevalue("fp32")
        return FP32
    return BF16


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Trees, specs, the pieces
# ---------------------------------------------------------------------------


def test_trees_and_converters_carry_the_encoder_and_enc_out():
    jc = japi.reduced_config(jconfigs.get_config(ARCH))
    c = reduced_config(configs.get_config(ARCH))
    jspec = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jlm.param_specs(jc))
    assert _shapes(param_specs(c)) == jspec
    jcache = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), japi.cache_specs(jc, 3, 10))
    assert _shapes(cache_specs(c, 3, 10)) == jcache
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref_cache = jlm.init_cache(jc, 3, 10)
    ref_cache["enc_out"] = jnp.full(ref_cache["enc_out"].shape, 0.5, jnp.bfloat16)
    carried = model_cache_from_reference(jax.tree.map(np.asarray, ref_cache), device="cpu")
    assert carried["enc_out"].dtype == torch.bfloat16 and carried["enc_out"].shape == (3, 16, 128)
    assert float(carried["enc_out"].min()) == 0.5
    fresh = init_cache(c, 3, 10, device="cpu")
    assert float(fresh["enc_out"].abs().max()) == 0.0
    keys = set(LanguageModel(c, tp).state_dict())
    assert {"enc_blocks.attn.w_q", "enc_final_norm.bias", "blocks.cross.w_k",
            "blocks.norm3.scale", "lm_head"} <= keys
    assert len(keys) == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_and_make_inputs_cover_the_family(shape):
    """Frames in train / prefill cells, ``enc_out`` in the decode cache,
    against the reference's full-size specs; concrete inputs small."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    spec = SHAPES[shape]
    got, want = tree_flatten(input_specs(cfg, spec))[0], jax.tree.leaves(
        japi.input_specs(jcfg, spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
    c = reduced_config(cfg)
    small = SHAPES[shape].__class__(shape, 24, 2, spec.kind)
    out = make_inputs(c, small, torch.Generator().manual_seed(0), device="cpu")
    if spec.kind == "decode":
        assert out["cache"]["enc_out"].shape == (2, 16, 128)
    else:
        assert out["batch"]["frames"].shape == (2, 16, 128)
        assert out["batch"]["frames"].dtype == torch.bfloat16


def test_sinusoid_matches_reference():
    """Float64 NumPy frequencies cast to fp32, then fp32 angles: equal to
    the reference's to fp32 rounding of sin / cos, also at whisper's full
    width and at positions past 500k."""
    for d in (128, 1280):
        pos = np.array([[0, 1, 7, 1499], [4095, 32_767, 100_000, 524_287]], np.int32)
        want = np.asarray(jlm._sinusoidal(jnp.asarray(pos), d))
        got = tlm._sinusoidal(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == (2, 4, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * max(1.0, d / 128))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_kv_and_encoder_match_reference(request, dtype):
    """``_cross_kv`` and ``_encode`` (non-causal, sinusoid plus RoPE)."""
    if dtype == "fp32":
        request.getfixturevalue("fp32")
    tol = FP32 if dtype == "fp32" else BF16
    jc, jp, c, tp = reduced_setup(ARCH)
    frames = np.random.default_rng(1).standard_normal((3, c.enc_seq, c.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, f: jlm._encode(jc, p, f))(jp, jnp.asarray(frames))
    got = tlm._encode(c, tp, torch.from_numpy(frames))
    assert got.dtype == tlm.layers.COMPUTE_DTYPE
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    cross = {k: v[0] for k, v in tp["blocks"]["cross"].items()}
    jcross = {k: v[0] for k, v in jp["blocks"]["cross"].items()}
    for g, w in zip(tlm._cross_kv(c, cross, got), jlm._cross_kv(jc, jcross, want)):
        assert g.shape == (3, c.enc_seq, c.n_kv_heads, c.head_dim_)
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    # not causal: the first frame's output reads the last frame
    bumped = frames.copy()
    bumped[:, -1] += 1.0
    again = tlm._encode(c, tp, torch.from_numpy(bumped))
    assert float((again[:, 0] - got[:, 0]).abs().max()) > 0


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_matches_reference(compute):
    jc, jp, c, tp = reduced_setup(ARCH)
    jb, tb = family_batch(c, tokens(c, (3, 40), seed=1), seed=2)
    want = np.asarray(jax.jit(lambda p, b: jlm.prefill(jc, p, b))(jp, jb))
    got = prefill(c, tp, tb)
    assert got.dtype == torch.float32 and got.shape == (3, c.vocab)
    np.testing.assert_allclose(got.numpy(), want, **compute)
    other = dict(tb, frames=tb["frames"].flip(1))  # the frames reach the logits
    assert float((prefill(c, tp, other) - got).abs().max()) > 1e-4


@pytest.mark.parametrize("enc_out", ["zeros", "encoded"])
def test_decode_matches_reference(compute, enc_out):
    """20 steps against a 24-position cache; ``enc_out`` the zeros of
    ``init_cache`` or the encoder's output of random frames, put in both
    caches; it comes back untouched."""
    jc, jp, c, tp = reduced_setup(ARCH)
    filled = {}

    def prepare(jcache, tcache):
        if enc_out == "encoded":
            frames = np.random.default_rng(3).standard_normal(
                (3, c.enc_seq, c.d_model)).astype(np.float32)
            enc = jlm._encode(jc, jp, jnp.asarray(frames))
            jcache = dict(jcache, enc_out=enc.astype(jcache["enc_out"].dtype))
            tcache["enc_out"] = model_cache_from_reference(
                {"e": np.asarray(jcache["enc_out"])}, device="cpu")["e"]
        filled["enc_out"] = tcache["enc_out"].clone()
        return jcache, tcache

    _, tcache = hold_decode(jc, jp, c, tp, tokens(c, (3, 20), seed=4), 24, compute, prepare)
    assert torch.equal(tcache["enc_out"], filled["enc_out"])
    assert tcache["blocks"]["index"].tolist() == [20, 20]
    assert tcache["blocks"]["pos"][0, 0, :20].tolist() == list(range(20))


# ---------------------------------------------------------------------------
# Loss, gradients, AdamW
# ---------------------------------------------------------------------------


def _train_batches(c, n, seed=0):
    return [tokens(c, (2, 64), seed=seed + i) for i in range(n)]


def test_loss_and_gradients_match_reference_in_fp32(fp32):
    """Every gradient leaf, the encoder's and the cross-attention's
    included, through the frames' path."""
    jc, jp, c, tp = reduced_setup(ARCH)
    jb, tb = family_batch(c, _train_batches(c, 1)[0], seed=5)
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b), has_aux=True))(jp, jb)
    got, aux, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want)
    _close(aux["ce"], want_aux["ce"])
    _hold_leaves(grads, want_g)
    enc_grads = tree_flatten(tree_flatten(tp)[1](grads)["enc_blocks"])[0]
    assert all(float(g.abs().max()) > 0 for g in enc_grads if g.dim() == 3)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g))


def test_train_steps_match_reference_in_fp32(fp32):
    """Three AdamW steps at lr 1e-2 from the reference's parameters and
    state; the cross-attention keys' gradients at init are ~1e-3 of the
    other leaves', at the backward's rounding floor (2e-10 against the
    reference at step 3, 4e-5 of their own largest), so the update holds
    the gradient to 2**-23 x the tree's largest |gradient| at least."""
    jc, jp, c, tp = reduced_setup(ARCH)
    jstep_fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**PARITY_OPT)))
    step = make_train_step(c, AdamWConfig(**PARITY_OPT))
    js = jstep.init_train_state(jc, jp)
    params, state = tp, init_train_state(c, tp)
    for i, toks in enumerate(_train_batches(c, 3, seed=10)):
        jb, tb = family_batch(c, toks, seed=10 + i)
        jp2, js2, jm = jstep_fn(jp, js, jb)
        new, new_state, m = step(params, state, tb)
        for k in m:
            _close(m[k], jm[k])
        _hold_update(params, new, jp, jp2, js, js2, tree_floor=True)
        if i in (0, 2):
            _hold_state(new_state, js2)
        jp, js = jp2, js2
        params = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        state = opt_state_from_reference(jax.tree.map(np.asarray, js), device="cpu")


def test_bf16_loss_and_grad_norm_match_reference():
    jc, jp, c, tp = reduced_setup(ARCH)
    jb, tb = family_batch(c, _train_batches(c, 1, seed=20)[0], seed=20)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b), has_aux=True))(jp, jb)
    got, _, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want, rtol=2e-2)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g), rtol=2e-2)


def test_remat_policies_give_the_same_loss_and_gradients():
    _, _, c, tp = reduced_setup(ARCH)
    tb = family_batch(c, _train_batches(c, 1, seed=30)[0], seed=30)[1]
    try:
        tlm.set_remat_policy("everything")
        want, _, want_g = _port_value_and_grad(c, tp, tb)
        for policy in ("nothing", "dots"):
            tlm.set_remat_policy(policy)
            got, _, got_g = _port_value_and_grad(c, tp, tb)
            assert torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    finally:
        tlm.set_remat_policy("nothing")


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def _lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().splitlines()


def test_training_cli_feeds_frames_as_the_reference():
    """The training CLI at ``--reduced`` builds the (batch, enc_seq, D) bf16
    zero frames: its config and ownership lines are the reference's, its
    loss falls."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
            "--ckpt-every", "3", "--lr", "1e-3"]
    _, ref = _lines(jtrain.main, argv)
    seen = []
    real = tlm.forward

    def spy(cfg, params, batch):
        seen.append(batch["frames"])
        return real(cfg, params, batch)

    tlm.forward = spy
    try:
        rep, port = _lines(train.run, argv + ["--device", "cpu"])
    finally:
        tlm.forward = real
    assert port[:2] == ref[:2]
    assert rep["rc"] == 0 and len(rep["losses"]) == 6
    assert seen and all(f.shape == (4, 16, 128) and f.dtype == torch.bfloat16
                        and float(f.abs().max()) == 0.0 for f in seen)


def test_serving_cli_matches_the_reference_cli():
    argv = ["--arch", ARCH, "--reduced", "--requests", "16", "--batch", "4", "--decode-len", "3",
            "--cache-len", "8"]
    _, ref = _lines(jserve.main, argv)
    rep, port = _lines(serve.run, argv + ["--device", "cpu"])
    assert port[0].split(" (")[0] == ref[0].split(" (")[0]
    assert rep["decoded"].tokens.shape == (rep["ids"].size, 3)
    cut, _ = _lines(serve.run, argv + ["--device", "cpu", "--layers", "1"])
    assert cut["cfg"].n_layers == 1 and cut["cfg"].n_enc_layers == 2
    assert cut["params"]["blocks"]["attn"]["w_q"].shape[0] == 1
    assert cut["params"]["enc_blocks"]["attn"]["w_q"].shape[0] == 2
