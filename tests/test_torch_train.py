"""The port's language-model training path, held to the reference on the CPU.

Reduced configs (2 layers, d_model 128, vocab 512), the reference's own
weights carried across with ``convert.model_params_from_reference``, and
token batches from the ``DataPipeline`` (the same synthetic shards in both
packages).  Tolerances:

* fp32 compute (the port's ``set_compute_dtype(torch.float32)``, the
  reference's ``COMPUTE_DTYPE`` patched to fp32 in the test only): the
  loss, ``global_norm`` and the step metrics at ``rtol=1e-4``; every
  gradient leaf and the AdamW moments ``m`` / ``v`` at ``rtol=1e-4, atol=
  1e-5 x max |reference leaf|`` (each leaf at its own scale); ``count``
  exactly;
* the parameters: the steps run at ``PARITY_OPT`` (lr 1e-2, one warm-up
  step, weight decay 0.1), where the update dominates the parameters'
  rounding.  Each port step starts from the reference's parameters and
  AdamW state before it (carried across), and its update (new minus old
  parameters) is held leaf by leaf to the reference's at ``rtol=1e-4,
  atol=1e-5 x max |reference update|`` plus the gradient's own tolerance
  carried through Adam's step, ``lr x |d step / d g| x (1e-4 |g| + 1e-5
  max |g|)``: ``g`` is the reference's clipped gradient, recovered from its
  first moments as ``(m_k - b1 m_{k-1}) / (1 - b1)``, and the derivative
  is taken at the reference's moments.  Adam's first step is about lr x
  sign(g), so where |g| is near eps (rounding noise) the carried term lets
  the element step either way; elsewhere it is a fraction of the update;
* bf16 compute (the default): the loss and ``global_norm`` at
  ``rtol=2e-2``, the reference's bf16 tolerance;
* microbatched (4) against the port's own single step: ``atol=2e-3``
  (the reference's ``tests/test_end_to_end.py:53``);
* the three remat policies against each other: exact (the CPU recomputes
  deterministically);
* the restored checkpoint: bit for bit; the replay against the
  uninterrupted run: ``atol=1e-5`` (the reference's ``:71``).
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataPipeline as JDataPipeline
from repro.data import ShardedDataset as JShardedDataset
from repro.core import make_uniform_cluster as j_uniform_cluster
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import AsuraCheckpointStore, CheckpointManager
from repro_torch.convert import model_params_from_reference, opt_state_from_reference
from repro_torch.core import make_uniform_cluster
from repro_torch.data import DataPipeline, ShardedDataset
from repro_torch.launch import train
from repro_torch.models import (
    SHAPES,
    ShapeSpec,
    input_specs,
    make_inputs,
    prefill,
    reduced_config,
)
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.train import (
    AdamWConfig,
    global_norm,
    init_train_state,
    make_train_step,
)
from repro_torch.train.optimizer import tree_flatten
from repro_torch.train.step import _split_micro
from torch_lm_parity import (
    PARITY_OPT,
    RTOL,
    _close,
    _hold_leaves,
    _hold_state,
    _hold_update,
    _port_value_and_grad,
)

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("smollm-135m", "granite-3-2b", "deepseek-7b", "command-r-35b", "internvl2-26b")
SMOKE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2, kind="train")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=24, global_batch=2, kind="decode")

_SETUPS: dict = {}
_JITS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced size, the port holding the reference's weights (cached)."""
    if arch not in _SETUPS:
        jc = japi.reduced_config(jconfigs.get_config(arch))
        jp = jlm.init_params(jc, jax.random.PRNGKey(0))
        tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        _SETUPS[arch] = (jc, jp, reduced_config(configs.get_config(arch)), tp)
    return _SETUPS[arch]


def _jit(key, make):
    """One jitted reference function per key; the key names the compute
    dtype, since the trace fixes it."""
    if key not in _JITS:
        _JITS[key] = jax.jit(make())
    return _JITS[key]


def _ref_value_and_grad(jc, dtype):
    return _jit(("vg", jc.name, dtype), lambda: jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b), has_aux=True))


def _ref_train_step(jc, dtype, n=1, grad_dtype=jnp.float32):
    return _jit(("step", jc.name, dtype, n, grad_dtype), lambda: jstep.make_train_step(
        jc, jopt.AdamWConfig(**PARITY_OPT), n_microbatches=n, grad_dtype=grad_dtype))


def _port_train_step(cfg, n=1, grad_dtype=torch.float32):
    return make_train_step(cfg, AdamWConfig(**PARITY_OPT), n_microbatches=n,
                           grad_dtype=grad_dtype)


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 inside the test."""
    for mod in (jl, jlm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    saved = tl.COMPUTE_DTYPE
    tl.set_compute_dtype(torch.float32)
    yield "fp32"
    tl.set_compute_dtype(saved)


def _token_batches(vocab, n, batch=4, seq=64):
    """``n`` (batch, seq) batches of the port's DataPipeline (host 0 of 2),
    the reference's ``tests/test_end_to_end.py`` ``_batches``."""
    ds = ShardedDataset(n_shards=16, tokens_per_shard=batch * seq * 8, vocab=vocab)
    pipe = DataPipeline(ds, make_uniform_cluster(2, device="cpu"), 0, batch_per_host=batch,
                        seq_len=seq)
    it, out = pipe.batches(), []
    while len(out) < n:
        try:
            out.append(next(it))
        except StopIteration:
            it = pipe.batches(epoch=len(out))
    return out


def _batch(cfg, tokens, seed=1):
    """(reference batch, port batch) holding the same tokens (and, for a
    VLM, the same stub patches)."""
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if cfg.vision_prefix:
        patches = np.random.default_rng(seed).standard_normal(
            (tokens.shape[0], cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return jb, tb


# ---------------------------------------------------------------------------
# Loss, gradients and steps against the reference
# ---------------------------------------------------------------------------


def test_pipeline_batches_are_the_reference_pipelines():
    ds = JShardedDataset(n_shards=16, tokens_per_shard=4 * 64 * 8, vocab=512)
    pipe = JDataPipeline(ds, j_uniform_cluster(2), 0, batch_per_host=4, seq_len=64)
    it = pipe.batches()
    want = [next(it) for _ in range(3)]
    for got, w in zip(_token_batches(512, 3), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_reference_in_fp32(fp32, arch):
    jc, jp, c, tp = _setup(arch)
    jb, tb = _batch(c, _token_batches(c.vocab, 1)[0])
    (want, want_aux), want_g = _ref_value_and_grad(jc, fp32)(jp, jb)
    got, aux, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want)
    _close(aux["ce"], want_aux["ce"])
    assert float(aux["aux"]) == float(want_aux["aux"]) == 0.0
    _hold_leaves(grads, want_g)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g))


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference_in_fp32(fp32, arch):
    """Three steps.  Each port step starts from the reference's parameters
    and AdamW state before it (carried across), so each update is held on
    its own, the bias corrections at counts 1 to 3 included; the state
    after the first and the third step; the inputs of a step stay as they
    were (the step is functional)."""
    jc, jp, c, tp = _setup(arch)
    jstep_fn, step = _ref_train_step(jc, fp32), _port_train_step(c)
    js = jstep.init_train_state(jc, jp)
    params, state = tp, init_train_state(c, tp)
    for i, tokens in enumerate(_token_batches(c.vocab, 3)):
        jb, tb = _batch(c, tokens, seed=i)
        kept = [t.clone() for t in tree_flatten(params)[0] + tree_flatten(state)[0]]
        jp2, js2, jm = jstep_fn(jp, js, jb)
        new, new_state, m = step(params, state, tb)
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k])
        _hold_update(params, new, jp, jp2, js, js2)
        if i in (0, 2):
            _hold_state(new_state, js2)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_flatten(params)[0] + tree_flatten(state)[0], kept))
        jp, js = jp2, js2
        params = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        state = opt_state_from_reference(jax.tree.map(np.asarray, js), device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_loss_and_grad_norm_match_reference(arch):
    jc, jp, c, tp = _setup(arch)
    jb, tb = _batch(c, _token_batches(c.vocab, 1)[0])
    (want, _), want_g = _ref_value_and_grad(jc, "bf16")(jp, jb)
    got, _, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want, rtol=2e-2)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g), rtol=2e-2)


def test_reference_state_carries_across_mid_training(fp32):
    """Two reference steps; its parameters and AdamW state cross over and
    both take a third."""
    jc, jp, c, _ = _setup("granite-3-2b")
    batches = _token_batches(c.vocab, 3)
    jstep_fn, js = _ref_train_step(jc, fp32), jstep.init_train_state(jc, jp)
    for tokens in batches[:2]:
        jp, js, _ = jstep_fn(jp, js, {"tokens": jnp.asarray(tokens)})
    params = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    state = opt_state_from_reference(jax.tree.map(np.asarray, js), device="cpu")
    _hold_state(state, js)
    jp2, js2, jm = jstep_fn(jp, js, {"tokens": jnp.asarray(batches[2])})
    params2, state, m = _port_train_step(c)(params, state,
                                            {"tokens": torch.from_numpy(batches[2])})
    _close(m["loss"], jm["loss"])
    _hold_update(params, params2, jp, jp2, js, js2)
    _hold_state(state, js2)


# ---------------------------------------------------------------------------
# Microbatches, remat, the blockwise path, the chunked loss
# ---------------------------------------------------------------------------


def test_microbatched_matches_reference_microbatched(fp32):
    jc, jp, c, tp = _setup("smollm-135m")
    tokens = _token_batches(c.vocab, 1, batch=8)[0]
    js0 = jstep.init_train_state(jc, jp)
    jparams, js, jm = _ref_train_step(jc, fp32, n=4)(jp, js0, {"tokens": jnp.asarray(tokens)})
    params, state, m = _port_train_step(c, n=4)(
        tp, init_train_state(c, tp), {"tokens": torch.from_numpy(tokens)})
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"])
    _hold_update(tp, params, jp, jparams, js0, js)
    _hold_state(state, js)


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_microbatched_matches_single_step(grad_dtype):
    """Gradient accumulation over 4 slices against the monolithic step,
    the reference's ``test_microbatched_matches_single`` in the port."""
    _, _, c, tp = _setup("smollm-135m")
    tokens = torch.from_numpy(_token_batches(c.vocab, 1, batch=8)[0])
    p1, _, m1 = make_train_step(c)(tp, init_train_state(c, tp), {"tokens": tokens})
    p4, s4, m4 = make_train_step(c, n_microbatches=4, grad_dtype=grad_dtype)(
        tp, init_train_state(c, tp), {"tokens": tokens})
    assert torch.isfinite(m4["loss"]) and torch.isfinite(m4["grad_norm"])
    assert all(m.dtype == torch.float32 for m in tree_flatten(s4["m"])[0])
    for a, b in zip(tree_flatten(p1)[0], tree_flatten(p4)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)


def test_split_micro_raises_on_a_batch_that_does_not_divide():
    batch = {"tokens": torch.zeros((6, 4), dtype=torch.int32)}
    assert [mb["tokens"].shape for mb in _split_micro(batch, 3)] == [(2, 4)] * 3
    with pytest.raises(ValueError, match="not divisible into 4 microbatches"):
        _split_micro(batch, 4)
    _, _, c, tp = _setup("smollm-135m")
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(c, n_microbatches=4)(tp, init_train_state(c, tp), batch)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policies_give_the_same_loss_and_gradients(policy):
    """Against "everything" (no checkpoint); the serving path is untouched."""
    _, _, c, tp = _setup("command-r-35b")
    tb = {"tokens": torch.from_numpy(_token_batches(c.vocab, 1)[0])}
    try:
        tlm.set_remat_policy("everything")
        want, _, want_g = _port_value_and_grad(c, tp, tb)
        served = prefill(c, tp, tb)
        tlm.set_remat_policy(policy)
        got, _, got_g = _port_value_and_grad(c, tp, tb)
        assert torch.equal(prefill(c, tp, tb), served)
    finally:
        tlm.set_remat_policy("nothing")
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        tlm.set_remat_policy("offload")
    assert tlm._remat_policy_name == "nothing"


def test_blockwise_backward_matches_dense_and_reference(fp32, monkeypatch):
    """Sequences over the threshold go kv-chunked (chunks of 8 over 64
    positions); autograd runs through the online softmax."""
    jc, jp, c, tp = _setup("granite-3-2b")
    jb, tb = _batch(c, _token_batches(c.vocab, 1)[0])
    dense, _, dense_g = _port_value_and_grad(c, tp, tb)
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 16)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, jb), has_aux=True)(jp)
    got, _, grads = _port_value_and_grad(c, tp, tb)
    _close(got, want)
    _hold_leaves(grads, want_g)
    _close(got, dense)
    for a, b in zip(grads, dense_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=1e-5 * float(b.abs().max()))


def test_chunked_ce_pads_the_tail_like_the_reference(fp32, monkeypatch):
    """40 positions in chunks of 16: the reference pads the third chunk to
    16, the port takes it short; both equal one chunk of 256."""
    jc, jp, c, tp = _setup("command-r-35b")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((3, 40, c.d_model)).astype(np.float32)
    targets = rng.integers(0, c.vocab, (3, 40)).astype(np.int32)
    mask = (rng.random((3, 40)) > 0.2).astype(np.float32)
    whole = tlm.chunked_ce(c, tp, *map(torch.from_numpy, (hidden, targets, mask)))
    for mod in (jlm, tlm):
        monkeypatch.setattr(mod, "CE_CHUNK", 16)
    want = jlm.chunked_ce(jc, jp, jnp.asarray(hidden), jnp.asarray(targets), jnp.asarray(mask))
    h = torch.from_numpy(hidden).requires_grad_()
    got = tlm.chunked_ce(c, tp, h, torch.from_numpy(targets), torch.from_numpy(mask))
    _close(got.detach(), want)
    _close(got.detach(), whole, rtol=1e-5)
    want_h = jax.grad(lambda x: jlm.chunked_ce(jc, jp, x, jnp.asarray(targets),
                                               jnp.asarray(mask)))(jnp.asarray(hidden))
    got_h, = torch.autograd.grad(got, h)
    _hold_leaves([got_h], [want_h])


# ---------------------------------------------------------------------------
# Specs and inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,spec", [
    ("smollm-135m", SMOKE_TRAIN), ("smollm-135m", SMOKE_DECODE),
    ("internvl2-26b", SHAPES["prefill_32k"]), ("internvl2-26b", SMOKE_DECODE),
    ("whisper-large-v3", SHAPES["train_4k"]),  # frames
    ("whisper-large-v3", SMOKE_DECODE),  # the decoder's rings and enc_out
    ("recurrentgemma-9b", SMOKE_DECODE), ("recurrentgemma-9b", SHAPES["long_500k"]),
    ("rwkv6-3b", SMOKE_DECODE), ("rwkv6-3b", SHAPES["long_500k"]),
], ids=lambda x: getattr(x, "name", x))
def test_input_specs_match_reference(arch, spec):
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    got, want = input_specs(cfg, spec), japi.input_specs(jcfg, spec)
    flat_got, flat_want = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_make_inputs_train_step_smoke(arch):
    """The reference's ``tests/test_arch_smoke.py`` train case in the port:
    the loss near ln(512), every gradient finite, one nonzero."""
    _, _, c, tp = _setup(arch)
    inputs = make_inputs(c, SMOKE_TRAIN, torch.Generator().manual_seed(0), device="cpu")
    tokens = inputs["batch"]["tokens"]
    assert tokens.dtype == torch.int32 and tokens.shape == (2, 32)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < c.vocab - 1
    val, _, grads = _port_value_and_grad(c, tp, inputs["batch"])
    assert 3.0 < float(val) < 12.0
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    dec = make_inputs(c, SMOKE_DECODE, torch.Generator().manual_seed(0), device="cpu")
    assert dec["batch"]["positions"].tolist() == [[23], [23]]
    assert dec["cache"]["dense_blocks"]["k"].shape[1:3] == (2, 24)


# ---------------------------------------------------------------------------
# The reference's end-to-end stories, in the port
# ---------------------------------------------------------------------------


def test_loss_decreases():
    _, _, c, params = _setup("smollm-135m")
    opt = init_train_state(c, params)
    step = make_train_step(c, AdamWConfig(lr=1e-3, warmup_steps=5))
    losses = []
    for tokens in _token_batches(c.vocab, 30):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_train_checkpoint_crash_restore():
    """Train 5 steps, save async, train on to step 10; two of 5 storage
    nodes die; the restore is bit-exact and its replay reaches the same
    weights."""
    _, _, c, params = _setup("smollm-135m")
    opt = init_train_state(c, params)
    step = make_train_step(c, AdamWConfig(lr=1e-3))
    store = AsuraCheckpointStore({i: 1.0 for i in range(5)}, n_replicas=3, device="cpu")
    mgr = CheckpointManager(store)
    batches = [{"tokens": torch.from_numpy(t)} for t in _token_batches(c.vocab, 10)]
    for batch in batches[:5]:
        params, opt, _ = step(params, opt, batch)
    mgr.save_async(5, {"params": params, "opt": opt})
    mgr.wait()
    lost_params, lost_opt = params, opt
    for batch in batches[5:]:
        lost_params, lost_opt, _ = step(lost_params, lost_opt, batch)
    store.fail_node(1)
    store.fail_node(3)
    restored = mgr.restore(5, {"params": params, "opt": opt})
    saved = tree_flatten({"params": params, "opt": opt})[0]
    got = tree_flatten(restored)[0]
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, saved))
    replayed, opt2 = restored["params"], restored["opt"]
    for batch in batches[5:]:
        replayed, opt2, _ = step(replayed, opt2, batch)
    for a, b in zip(tree_flatten(replayed)[0], tree_flatten(lost_params)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert int(opt2["count"]) == int(lost_opt["count"]) == 10


def _lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().splitlines()


def test_train_cli_matches_the_reference_cli():
    """The reference's CLI smoke (``tests/test_end_to_end.py:132``) in both
    packages: the port returns 0 (the loss improved), and its config and
    shard-ownership lines are the reference's."""
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "6", "--batch", "4", "--seq", "64",
            "--ckpt-every", "3", "--lr", "1e-3"]
    _, ref = _lines(jtrain.main, argv)
    rc, port = _lines(train.main, argv + ["--device", "cpu"])
    assert rc == 0
    assert port[:2] == ref[:2] and port[1].startswith("host 0 owns ")
    assert port[2].startswith("step    0 loss ") and "improved" in port[-3]
    assert port[-2].startswith("train step ") and "host clock" in port[-2]
    assert port[-1] == "peak memory not measured (cpu)"


def test_train_cli_reports_what_it_measured():
    with contextlib.redirect_stdout(io.StringIO()):
        rep = train.run(["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
                         "--seq", "32", "--microbatches", "2", "--ckpt-every", "2",
                         "--remat", "dots"])
    try:
        assert rep["device"] == torch.device("cpu") and len(rep["losses"]) == 4
        assert rep["manager"].saved_steps == [2] and len(rep["save_s"]) == 1
        assert int(rep["opt_state"]["count"]) == 4 and rep["peak_bytes"] is None
        assert rep["tok_s"] == pytest.approx(4 * 32 * 1e3 / rep["step_ms"])
        assert rep["rc"] == int(not np.mean(rep["losses"][-3:]) < np.mean(rep["losses"][:3]))
        step, saved = rep["last_save"]
        restored = rep["manager"].restore(step, saved)
        assert step == 2 and int(restored["opt"]["count"]) == 3
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(restored)[0],
                                                     tree_flatten(saved)[0]))
    finally:
        tlm.set_remat_policy("nothing")


def test_train_cli_without_a_device_raises_on_a_host_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


def test_example_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_train_smollm", ROOT / "examples" / "torch_train_smollm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = example.main(steps=4, device="cpu")
    lines = buf.getvalue().splitlines()
    assert rc in (0, 1)  # 4 steps in the schedule's warm-up
    assert lines[0].startswith("arch=smollm-135m-smoke") and lines[1].startswith("host 0 owns ")
    assert any(line.startswith("loss ") for line in lines)
