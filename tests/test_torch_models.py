"""The port's model layers and configs, held to the reference's on the CPU.

Configs are data and must be equal.  fp32 layer functions (norms, RoPE,
the mask, softmax) agree at ``rtol=1e-5, atol=1e-6``, the mask exactly;
the bf16 layers at ``rtol=2e-2, atol=2e-2``, the reference's own tolerance
for bf16 layers (``tests/test_layer_math.py``).  Inputs come from a NumPy
seed; reference weights cross over with ``convert.model_params_from_reference``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import model_cache_from_reference, model_params_from_reference
from repro_torch.models import (
    SHAPES,
    LanguageModel,
    cache_specs,
    decode_step,
    init_cache,
    init_params,
    loss_fn,
    param_specs,
    prefill,
    reduced_config,
    shape_applicable,
)
from repro_torch.models import layers as tl

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
CPU = torch.device("cpu")
SERVED = ("smollm-135m", "granite-3-2b", "deepseek-7b", "command-r-35b", "internvl2-26b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    """(reference reduced config, port reduced config)."""
    return japi.reduced_config(jconfigs.get_config(arch)), reduced_config(configs.get_config(arch))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(rng, shape):
    """The same bf16 values on both sides, from a NumPy draw."""
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _ref_params(jc, seed=0):
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    return jp, model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_matches_reference(arch):
    full, port = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(full)
    assert dataclasses.asdict(reduced_config(port)) == dataclasses.asdict(
        japi.reduced_config(full))
    for c, j in ((port, full), (reduced_config(port), japi.reduced_config(full))):
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        assert c.head_dim_ == j.head_dim_
        for name, spec in SHAPES.items():
            assert shape_applicable(c, spec) == jconfigs.shape_applicable(
                j, jconfigs.SHAPES[name])


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {n: dataclasses.asdict(s) for n, s in configs.SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in jconfigs.SHAPES.items()}
    port = [(a, s.name, ok, why) for a, s, ok, why in configs.all_cells()]
    ref = [(a, s.name, ok, why) for a, s, ok, why in jconfigs.all_cells()]
    assert port == ref and len(port) == 40
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_family_runs_reduced_on_the_cpu(arch):
    """Every config the repo ships, at its reduced size: ``init_params``, a
    prefill, two decode steps and ``loss_fn`` run on the CPU, finite and of
    the reference's shapes (the trees key for key with the reference's)."""
    jc, c = _cfgs(arch)
    params = init_params(c, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(params) == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                                           jlm.param_specs(jc))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, c.vocab, (2, 12)).astype(np.int32))}
    if c.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, c.enc_seq, c.d_model)).astype(np.float32))
    if c.vision_prefix:
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((2, c.vision_prefix, c.d_model)).astype(np.float32))
    logits = prefill(c, params, batch)
    assert logits.shape == (2, c.vocab) and bool(torch.isfinite(logits).all())
    cache = init_cache(c, 2, 8, device="cpu")
    for t in range(2):
        step = {"tokens": batch["tokens"][:, t:t + 1],
                "positions": torch.full((2, 1), t, dtype=torch.int32)}
        logits, out = decode_step(c, params, cache, step)
        assert out is cache and logits.shape == (2, c.vocab)
        assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    loss, aux = loss_fn(c, params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss)) and 3.0 < float(loss) < 12.0
    assert set(aux) == {"ce", "aux"}


# ---------------------------------------------------------------------------
# fp32 layer functions
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, scale=scale, bias=bias).items()}
    np.testing.assert_allclose(_np(tl.rmsnorm(t["x"], t["scale"])),
                               _np(jl.rmsnorm(x, scale)), **FP32)
    np.testing.assert_allclose(_np(tl.layernorm(t["x"], t["scale"], t["bias"])),
                               _np(jl.layernorm(x, scale, bias)), **FP32)
    # bf16 input: computed in fp32, cast back to the input dtype
    jx, tx = _bf16(rng, (2, 7, 64))
    out = tl.layernorm(tx, t["scale"], t["bias"])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jl.layernorm(jx, scale, bias)), **BF16)
    # the population variance: a constant row normalizes to the bias
    const = torch.full((1, 64), 5.0)
    np.testing.assert_allclose(_np(tl.layernorm(const, t["scale"], t["bias"])), bias[None],
                               **FP32)
    cfg = configs.get_config("command-r-35b")
    p = tl.norm_init(cfg, 64, lead=(3,))
    assert set(p) == {"scale", "bias"} and p["scale"].shape == (3, 64)
    assert set(tl.norm_init(configs.get_config("smollm-135m"), 8)) == {"scale"}


@pytest.mark.parametrize("theta", [10_000.0, 8_000_000.0])
def test_rope_matches_reference(theta):
    np.testing.assert_allclose(_np(tl.rope_freqs(64, theta)), _np(jl.rope_freqs(64, theta)),
                               **FP32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(jl.apply_rope(x, pos, theta)), **FP32)
    # halves, not even/odd pairs: position 0 is the identity, and the first
    # frequency rotates (x[0], x[32]) as one pair
    zero = tl.apply_rope(torch.from_numpy(x), torch.zeros((2, 9), dtype=torch.int32), theta)
    np.testing.assert_array_equal(zero.numpy(), x)
    one = tl.apply_rope(torch.from_numpy(x), torch.ones((2, 9), dtype=torch.int32), theta)
    c, s = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(one[..., 0].numpy(), x[..., 0] * c - x[..., 32] * s, **FP32)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3), (False, 4)])
def test_mask_bias_is_exact(causal, window):
    rng = np.random.default_rng(2)
    q_pos = rng.integers(0, 12, (2, 5)).astype(np.int32)
    k_pos = rng.integers(0, 12, (2, 7)).astype(np.int32)
    k_pos[:, -2:] = 2**30  # empty cache slots
    got = tl._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal=causal,
                        window=window)
    want = np.asarray(jl._mask_bias(q_pos, k_pos, causal=causal, window=window))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0.0, np.float32(-1e30)}


def test_softmax_with_mask_sentinel_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 33)).astype(np.float32) * 5
    x[:, ::3] += np.float32(-1e30)
    np.testing.assert_allclose(torch.softmax(torch.from_numpy(x), -1).numpy(),
                               np.asarray(jax.nn.softmax(x, axis=-1)), **FP32)


# ---------------------------------------------------------------------------
# bf16 layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    jc, c = _cfgs("smollm-135m")
    jc, c = dataclasses.replace(jc, act=act), dataclasses.replace(c, act=act)
    jp = jl.mlp_init(jax.random.PRNGKey(0), jc, 128, 256)
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    jx, tx = _bf16(np.random.default_rng(4), (2, 6, 128))
    got = tl.mlp_apply(c, tp, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jl.mlp_apply(jc, jp, jx)), **BF16)
    assert set(tp) == set(tl.mlp_init(torch.Generator(), c, 128, 256, device=CPU))


def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(tl._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), **FP32)


@pytest.mark.parametrize("arch,window", [
    ("smollm-135m", 0), ("deepseek-7b", 0), ("command-r-35b", 0), ("smollm-135m", 5),
])
def test_attention_prefill_matches_reference(arch, window):
    jc, c = _cfgs(arch)
    jp = jl.attention_init(jax.random.PRNGKey(1), jc)
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    jx, tx = _bf16(np.random.default_rng(5), (2, 11, c.d_model))
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    want, _ = jl.attention_apply(jc, jp, jx, positions=jnp.asarray(pos), window=window)
    got, none = tl.attention_apply(c, tp, tx, positions=torch.from_numpy(pos.copy()),
                                   window=window)
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_gqa_grouping_reads_kv_head_of_query_over_group():
    """Query head h reads kv head h // group: with one kv head's values set
    to a constant, exactly that head's queries return it."""
    rng = np.random.default_rng(6)
    b, s, hkv, group, d = 1, 4, 2, 3, 8
    q = torch.from_numpy(rng.standard_normal((b, s, hkv * group, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = torch.zeros((b, s, hkv, d))
    v[:, :, 1] = 7.0
    out = tl._sdpa(q, k, v, torch.zeros((b, s, s)))
    np.testing.assert_allclose(out[:, :, :group].numpy(), 0.0)
    np.testing.assert_allclose(out[:, :, group:].numpy(), 7.0, rtol=1e-6)
    jq, tq = _bf16(rng, (2, 5, 6, 16))
    jk, tk = _bf16(rng, (2, 9, 2, 16))
    jv, tv = _bf16(rng, (2, 9, 2, 16))
    bias = np.where(rng.random((2, 5, 9)) < 0.3, -1e30, 0.0).astype(np.float32)
    bias[..., 0] = 0.0
    np.testing.assert_allclose(_np(tl._sdpa(tq, tk, tv, torch.from_numpy(bias))),
                               _np(jl._sdpa(jq, jk, jv, bias)), **BF16)


def test_cross_attention_kv_override_matches_reference():
    jc, c = _cfgs("deepseek-7b")
    jp = jl.attention_init(jax.random.PRNGKey(2), jc)
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    jx, tx = _bf16(rng, (2, 3, c.d_model))
    jk, tk = _bf16(rng, (2, 6, c.n_kv_heads, c.head_dim_))
    jv, tv = _bf16(rng, (2, 6, c.n_kv_heads, c.head_dim_))
    qpos = np.zeros((2, 3), np.int32)
    kpos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    want, _ = jl.attention_apply(jc, jp, jx, positions=qpos, kv_override=(jk, jv, kpos))
    got, _ = tl.attention_apply(c, tp, tx, positions=torch.from_numpy(qpos),
                                kv_override=(tk, tv, torch.from_numpy(kpos)))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("sk,causal,window", [(40, True, 0), (37, True, 0), (37, False, 0),
                                             (29, True, 6)])
def test_blockwise_matches_reference_over_several_chunks(monkeypatch, sk, causal, window):
    """KV_CHUNK patched to 8 in both packages: 4-5 chunks, a padded last
    one when sk is not a multiple of 8."""
    monkeypatch.setattr(jl, "KV_CHUNK", 8)
    monkeypatch.setattr(tl, "KV_CHUNK", 8)
    rng = np.random.default_rng(8)
    jq, tq = _bf16(rng, (2, sk, 4, 16))
    jk, tk = _bf16(rng, (2, sk, 2, 16))
    jv, tv = _bf16(rng, (2, sk, 2, 16))
    pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk)).copy()
    tpos = torch.from_numpy(pos)
    got = tl._sdpa_blockwise(tq, tk, tv, tpos, tpos, causal=causal, window=window)
    want = jl._sdpa_blockwise(jq, jk, jv, pos, pos, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    dense = tl._sdpa(tq, tk, tv, tl._mask_bias(tpos, tpos, causal=causal, window=window))
    if causal or sk % 8 == 0:
        np.testing.assert_allclose(_np(got), _np(dense), **BF16)
    else:
        # the padded keys sit at position 2**30, which only the causal mask
        # excludes: without it they take softmax weight in both packages
        assert np.abs(_np(got) - _np(dense)).max() > 2e-2


def test_blockwise_threshold_switches_the_attention_path(monkeypatch):
    monkeypatch.setattr(tl, "KV_CHUNK", 4)
    monkeypatch.setattr(tl, "BLOCKWISE_THRESHOLD", tl.BLOCKWISE_THRESHOLD)
    jc, c = _cfgs("smollm-135m")
    _, tp = _ref_params(jc)
    p = {k: v[0] for k, v in tp["dense_blocks"]["attn"].items()}
    _, tx = _bf16(np.random.default_rng(9), (1, 13, c.d_model))
    pos = torch.arange(13, dtype=torch.int32)[None]
    calls = []
    real = tl._sdpa_blockwise
    monkeypatch.setattr(tl, "_sdpa_blockwise", lambda *a, **k: calls.append(1) or real(*a, **k))
    dense, _ = tl.attention_apply(c, p, tx, positions=pos)
    tl.set_blockwise_threshold(12)
    chunked, _ = tl.attention_apply(c, p, tx, positions=pos)
    assert calls == [1] and tl.BLOCKWISE_THRESHOLD == 12
    np.testing.assert_allclose(_np(chunked), _np(dense), **BF16)


def test_attention_decode_ring_buffer_matches_reference():
    """Decode one token at a time into a 4-slot ring: the reference's and the
    port's caches agree slot for slot, also after the ring wraps."""
    jc, c = _cfgs("smollm-135m")
    jp = jl.attention_init(jax.random.PRNGKey(3), jc)
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    jcache = jl.attention_cache_init(jc, 2, 4)
    tcache = tl.attention_cache_init(c, 2, 4)
    assert tcache["index"].shape == () and tcache["pos"].dtype == torch.int32
    rng = np.random.default_rng(10)
    for t in range(7):
        jx, tx = _bf16(rng, (2, 1, c.d_model))
        pos = np.full((2, 1), t, np.int32)
        want, jcache = jl.attention_apply(jc, jp, jx, positions=pos, cache=jcache)
        got, same = tl.attention_apply(c, tp, tx, positions=torch.from_numpy(pos), cache=tcache)
        assert same is tcache  # updated in place and returned
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        assert int(tcache["index"]) == int(jcache["index"]) == t + 1
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **BF16)
    np.testing.assert_array_equal(tcache["pos"][0].numpy(), [4, 5, 6, 3])


# ---------------------------------------------------------------------------
# Trees, init, the module
# ---------------------------------------------------------------------------


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", SERVED)
def test_param_and_cache_trees_match_reference(arch):
    jc, c = _cfgs(arch)
    jspec = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jlm.param_specs(jc))
    spec = param_specs(c)
    assert _shapes(spec) == jspec
    assert all(t.device.type == "meta" for t in jax.tree.leaves(spec))
    jcache = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), japi.cache_specs(jc, 3, 10))
    assert _shapes(cache_specs(c, 3, 10)) == jcache
    # the reference's values cross over key for key, dtypes kept
    jp, tp = _ref_params(jc)
    assert _shapes(tp) == jspec
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref_cache = jax.tree.map(np.asarray, jlm.init_cache(jc, 3, 10))
    tcache = model_cache_from_reference(ref_cache, device="cpu")
    assert tcache["dense_blocks"]["k"].dtype == torch.bfloat16
    for k in ("k", "v", "pos", "index"):
        assert torch.equal(tcache["dense_blocks"][k], init_cache(c, 3, 10, device="cpu")
                           ["dense_blocks"][k])


def test_init_params_draws_the_reference_distribution():
    c = reduced_config(configs.get_config("deepseek-7b"))
    a = init_params(c, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(c, torch.Generator().manual_seed(5), device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    w = a["dense_blocks"]["attn"]["w_q"]
    assert w.shape == (2, 128, 128)
    assert float(w.abs().max()) <= 0.04 + 1e-7  # truncated at 2 sigma
    # std of a standard normal truncated at +-2 is 0.8796
    assert abs(float(a["embed"].std()) - 0.02 * 0.8796) < 0.001
    assert torch.equal(a["dense_blocks"]["norm1"]["scale"], torch.ones(2, 128))
    assert "lm_head" in a and a["lm_head"].shape == (128, 512)


def test_language_model_module_holds_the_tree():
    jc, c = _cfgs("command-r-35b")
    _, tp = _ref_params(jc)
    model = LanguageModel(c, tp)
    keys = set(model.state_dict())
    assert "embed" in keys and "dense_blocks.attn.w_q" in keys
    assert "dense_blocks.norm1.bias" in keys and len(keys) == len(jax.tree.leaves(tp))
    assert not any(p.requires_grad for p in model.parameters())
    model = model.to(torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, 512, (2, 6)).astype(np.int32))
    assert torch.equal(model.prefill({"tokens": tokens}), prefill(c, tp, {"tokens": tokens}))
    cache = init_cache(c, 2, 4, device="cpu")
    logits, out = model.decode(cache, {"tokens": tokens[:, :1],
                                       "positions": torch.zeros((2, 1), dtype=torch.int32)})
    assert out is cache and logits.shape == (2, 512)
    rwkv = reduced_config(configs.get_config("rwkv6-3b"))  # every family is a module
    rwkv_keys = set(LanguageModel(rwkv, init_params(rwkv, torch.Generator(), device="cpu"))
                    .state_dict())
    assert {"blocks.time.w_r", "blocks.time.bonus_u", "blocks.channel.mix_k"} <= rwkv_keys
