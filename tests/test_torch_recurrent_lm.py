"""The port's recurrent language models -- recurrentgemma-9b (RG-LRU +
local attention) and rwkv6-3b -- served and trained, held to the reference
on the CPU (their mixers, layer by layer: ``tests/test_torch_recurrent.py``).

Both at the reference's ``reduced_config`` (d_model 128, vocab 512;
recurrentgemma one (rec, rec, attn) super-block plus one recurrent tail
layer, LRU width 128, window 16; rwkv6 2 layers of head dim 32), the same
weights in both packages (one draw of the port's ``init_params``), tokens
from NumPy seeds.  Tolerances:

* fp32 compute (both packages switched to fp32): logits, caches and
  recurrent states at ``rtol=1e-4, atol=1e-5``; the loss and
  ``global_norm`` at ``rtol=1e-4``; every gradient leaf and three AdamW
  updates at ``PARITY_OPT`` as ``tests/test_torch_train.py`` holds them;
* bf16 (the default): ``rtol=atol=2e-2``, the reference's bf16 tolerance;
* ring positions and indices: exactly.

A prefill of 300 tokens spans three RWKV chunks (the last one padded) and
many local windows; 20 decode steps against a 24-position cache pass the
window of 16 and wrap recurrentgemma's ring, and carry the recurrent
states from step to step.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
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

ARCHS = ("recurrentgemma-9b", "rwkv6-3b")
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
    """The tolerance of the compute dtype under test (fp32: both packages
    switched by the ``fp32`` fixture)."""
    if request.param == "fp32":
        request.getfixturevalue("fp32")
        return FP32
    return BF16


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Trees, specs, converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_and_converters_carry_the_family_exactly(arch):
    """Parameter and cache trees key for key with the reference's (nested
    super-blocks, per-layer states), on the meta device and carried across
    with the converters; the module's state_dict keys."""
    jc = japi.reduced_config(jconfigs.get_config(arch))
    c = reduced_config(configs.get_config(arch))
    jspec = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jlm.param_specs(jc))
    assert _shapes(param_specs(c)) == jspec
    jcache = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), japi.cache_specs(jc, 3, 40))
    assert _shapes(cache_specs(c, 3, 40)) == jcache
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    assert _shapes(tp) == jspec
    for a, b in zip(jax.tree.leaves(jp), tree_flatten(tp)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref_cache = model_cache_from_reference(jax.tree.map(np.asarray, jlm.init_cache(jc, 3, 40)),
                                           device="cpu")
    for a, b in zip(tree_flatten(ref_cache)[0], tree_flatten(init_cache(c, 3, 40,
                                                                         device="cpu"))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    keys = set(LanguageModel(c, tp).state_dict())
    assert len(keys) == len(jax.tree.leaves(jp))
    if arch == "recurrentgemma-9b":
        assert {"super_blocks.l0.rec.w_x", "super_blocks.l2.attn.w_q",
                "tail_blocks.rec.a_param"} <= keys
        assert tp["super_blocks"]["l0"]["rec"]["w_x"].shape[0] == 1  # one super-block
        assert init_cache(c, 3, 40, device="cpu")["super_blocks"]["l2"]["k"].shape[2] == 16
    else:
        assert {"blocks.time.decay_base", "blocks.channel.w_k"} <= keys


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_input_specs_and_make_inputs_cover_the_family(arch, shape):
    """Full-size specs against the reference's (meta tensors; the local
    ring at long_500k is the window's 2,048 slots) and concrete inputs at a
    small size."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    spec = SHAPES[shape]
    got, want = tree_flatten(input_specs(cfg, spec))[0], jax.tree.leaves(
        japi.input_specs(jcfg, spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
    if shape == "long_500k" and arch == "recurrentgemma-9b":
        assert input_specs(cfg, spec)["cache"]["super_blocks"]["l2"]["k"].shape[2] == 2048
    small = dataclasses.replace(spec, global_batch=2, seq_len=24)
    c = reduced_config(cfg)
    out = make_inputs(c, small, torch.Generator().manual_seed(0), device="cpu")
    assert out["batch"]["tokens"].dtype == torch.int32
    if spec.kind == "decode":
        assert out["batch"]["positions"].tolist() == [[23], [23]]
        assert _shapes(out["cache"]) == _shapes(cache_specs(c, 2, 24))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(compute, arch):
    jc, jp, c, tp = reduced_setup(arch)
    jb, tb = family_batch(c, tokens(c, (3, 300), seed=1))
    want = np.asarray(jax.jit(lambda p, b: jlm.prefill(jc, p, b))(jp, jb))
    got = prefill(c, tp, tb)
    assert got.dtype == torch.float32 and got.shape == (3, c.vocab)
    np.testing.assert_allclose(got.numpy(), want, **compute)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(compute, arch):
    """20 steps against a 24-position cache: recurrentgemma's local ring
    (16 slots) wraps at step 16; the states carry every step."""
    jc, jp, c, tp = reduced_setup(arch)
    _, tcache = hold_decode(jc, jp, c, tp, tokens(c, (3, 20), seed=2), 24, compute)
    if arch == "recurrentgemma-9b":
        ring = tcache["super_blocks"]["l2"]
        assert ring["pos"].shape[-1] == 16 and ring["index"].tolist() == [20]
        assert ring["pos"][0, 0].tolist() == list(range(16, 20)) + list(range(4, 16))
        assert float(tcache["tail_blocks"]["h"].abs().max()) > 0
    else:
        assert float(tcache["blocks"]["time"]["S"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_carries_a_reference_state_across(arch):
    """A cache the reference decoded 5 steps into, carried across with the
    converter, decodes on in the port as in the reference (bf16)."""
    jc, jp, c, tp = reduced_setup(arch)
    toks = tokens(c, (2, 8), seed=3)
    step = jax.jit(lambda p, cc, b: jlm.decode_step(jc, p, cc, b))
    jcache = jlm.init_cache(jc, 2, 24)
    for t in range(5):
        _, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "positions": jnp.full((2, 1), t, jnp.int32)})
    tcache = model_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    for t in range(5, 8):
        want, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                         "positions": jnp.full((2, 1), t, jnp.int32)})
        got, tcache = tlm.decode_step(c, tp, tcache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "positions": torch.full((2, 1), t, dtype=torch.int32)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_working_copy_casts_only_what_the_reference_casts_at_every_use(arch):
    """The serving steps' bf16 copy: the matrices (every ``w_*``, RWKV's
    low-rank mix and decay factors, the embedding and head) in bf16; the
    vectors the reference reads in fp32 (``decay_base``, ``bonus_u``) and
    the rest (``a_param``, the conv, mixes, scales, norms) untouched, and
    the steps' logits those of the fp32 master (the layers cast alike)."""
    from repro_torch.train import bf16_working_copy, make_prefill_step, make_serve_step

    _, _, c, tp = reduced_setup(arch)
    work = bf16_working_copy(tp)
    names = {}

    def walk(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, pre + k + ".")
            else:
                names[pre + k] = v

    walk(work)
    cast = {n for n, v in names.items() if v.dtype == torch.bfloat16}
    kept = set(names) - cast
    leaf = {n.rsplit(".", 1)[-1] for n in cast}
    matrices = {"embed", "lm_head", "mix_lora_a", "mix_lora_b", "decay_lora_a", "decay_lora_b"}
    assert leaf <= matrices | {x for x in leaf if x.startswith("w_")}
    fp32_leaves = {n.rsplit(".", 1)[-1] for n in kept}
    if arch == "rwkv6-3b":
        assert {"decay_base", "bonus_u", "mix_base", "mix_k", "mix_r", "ln_scale"} <= fp32_leaves
        assert {"mix_lora_a", "decay_lora_b", "w_r"} <= leaf
    else:
        assert {"a_param", "conv_w", "conv_b"} <= fp32_leaves and {"w_rg", "w_out"} <= leaf
    toks = tokens(c, (2, 9), seed=5)
    tb = {"tokens": torch.from_numpy(toks)}
    assert torch.equal(make_prefill_step(c)(tp, tb), prefill(c, tp, tb))
    step = make_serve_step(c)
    caches = [init_cache(c, 2, 8, device="cpu") for _ in range(2)]
    for t in range(3):
        b = {"tokens": tb["tokens"][:, t:t + 1], "positions": torch.full((2, 1), t,
                                                                        dtype=torch.int32)}
        assert torch.equal(step(tp, caches[0], b)[0], tlm.decode_step(c, tp, caches[1], b)[0])


# ---------------------------------------------------------------------------
# Loss, gradients, AdamW
# ---------------------------------------------------------------------------


def _train_batches(c, n, seed=0):
    """``n`` (2, 140) token batches: two RWKV chunks, many local windows."""
    return [tokens(c, (2, 140), seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_in_fp32(fp32, arch):
    """The loss, its ce and aux parts, every gradient leaf (through the
    doubling scan, the conv, the chunked WKV and its clip, the mixes) and
    the global norm."""
    jc, jp, c, tp = reduced_setup(arch)
    jb, tb = family_batch(c, _train_batches(c, 1)[0])
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b), has_aux=True))(jp, jb)
    got, aux, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want)
    _close(aux["ce"], want_aux["ce"])
    assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0
    _hold_leaves(grads, want_g)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference_in_fp32(fp32, arch):
    """Three AdamW steps at lr 1e-2, each port step from the reference's
    parameters and state before it; the metrics are the reference's."""
    jc, jp, c, tp = reduced_setup(arch)
    jstep_fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**PARITY_OPT)))
    step = make_train_step(c, AdamWConfig(**PARITY_OPT))
    js = jstep.init_train_state(jc, jp)
    params, state = tp, init_train_state(c, tp)
    for i, toks in enumerate(_train_batches(c, 3, seed=10)):
        jb, tb = family_batch(c, toks)
        jp2, js2, jm = jstep_fn(jp, js, jb)
        new, new_state, m = step(params, state, tb)
        assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
        for k in m:
            _close(m[k], jm[k])
        _hold_update(params, new, jp, jp2, js, js2)
        if i in (0, 2):
            _hold_state(new_state, js2)
        jp, js = jp2, js2
        params = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        state = opt_state_from_reference(jax.tree.map(np.asarray, js), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grad_norm_match_reference(arch):
    jc, jp, c, tp = reduced_setup(arch)
    jb, tb = family_batch(c, _train_batches(c, 1, seed=20)[0])
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b), has_aux=True))(jp, jb)
    got, _, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want, rtol=2e-2)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """"nothing" and "dots" against "everything", exactly: a whole
    super-block (recurrentgemma) or layer (rwkv6) is one remat unit."""
    _, _, c, tp = reduced_setup(arch)
    tb = family_batch(c, _train_batches(c, 1, seed=30)[0])[1]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cli_matches_the_reference_cli(arch):
    """The serving CLI at ``--reduced``: the routed share line is the
    reference's, every decoded token in range."""
    argv = ["--arch", arch, "--reduced", "--requests", "16", "--batch", "4", "--decode-len",
            "3", "--cache-len", "8"]
    with contextlib.redirect_stdout(io.StringIO()) as ref:
        jserve.main(argv)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rep = serve.run(argv + ["--device", "cpu"])
    ref_lines, lines = ref.getvalue().splitlines(), buf.getvalue().splitlines()
    assert lines[0].split(" (")[0] == ref_lines[0].split(" (")[0]
    assert rep["decoded"].tokens.shape == (rep["ids"].size, 3)
    assert 0 <= rep["decoded"].tokens.min() and rep["decoded"].tokens.max() < rep["cfg"].vocab


def test_layers_flag_keeps_whole_super_blocks_and_cuts_each_family():
    """``--layers``: recurrentgemma keeps (rec, rec, attn) super-blocks and
    the tail, refusing fewer than one pattern; rwkv6 and the dense models
    cut their layers; the encoder-decoder its decoder only."""
    rg = configs.get_config("recurrentgemma-9b")
    cut = serve.cut_layers(rg, 4)
    assert cut.n_layers == 4 and tlm._stacks(cut) == [("super_blocks", 1, "super"),
                                                      ("tail_blocks", 1, "rec")]
    assert tlm._stacks(serve.cut_layers(rg, 6)) == [("super_blocks", 2, "super")]
    with pytest.raises(ValueError, match="one block pattern"):
        serve.cut_layers(rg, 2)
    assert serve.cut_layers(configs.get_config("rwkv6-3b"), 8).n_layers == 8
    wh = serve.cut_layers(configs.get_config("whisper-large-v3"), 2)
    assert (wh.n_layers, wh.n_enc_layers) == (2, 32)
    with pytest.raises(ValueError, match="leading dense layers"):
        serve.cut_layers(configs.get_config("deepseek-v2-236b"), 1)
    assert serve.cut_layers(configs.get_config("smollm-135m"), 1).n_layers == 1
    with contextlib.redirect_stdout(io.StringIO()):
        rep = serve.run(["--arch", "recurrentgemma-9b", "--reduced", "--layers", "3",
                         "--requests", "4", "--batch", "2", "--decode-len", "2", "--device",
                         "cpu"])
    assert "tail_blocks" not in rep["params"] and rep["cfg"].n_layers == 3


def test_training_cli_runs_both_families():
    for arch in ARCHS:
        argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                "--ckpt-every", "2", "--lr", "1e-3", "--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rep = train.run(argv)
        jc = japi.reduced_config(jconfigs.get_config(arch))
        assert buf.getvalue().splitlines()[0] == f"arch={jc.name} params~{jc.param_count():.3g}"
        assert len(rep["losses"]) == 4 and all(np.isfinite(rep["losses"]))
        assert rep["manager"].saved_steps == [2] and int(rep["opt_state"]["count"]) == 4
