"""The port's language-model serving path, held to the reference on the CPU.

Prefill and decode logits of the served configs agree with the
reference's at ``rtol=2e-2, atol=2e-2`` (the reference's own bf16
tolerance, ``tests/test_layer_math.py``) on the reference's own weights
(carried over with ``convert.model_params_from_reference``); greedy tokens
are equal wherever the reference's top-2 margin exceeds 4e-2.  Then the
serving CLI: ``decode_requests`` against the reference's loop, the CLI and
the example with ``--device cpu``, and the CLI refusing to run without a
card when no device is given.
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
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import model_cache_from_reference, model_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_cache, prefill, reduced_config
from repro_torch.models import layers as tl
from repro_torch.train import bf16_working_copy, make_prefill_step, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
BF16 = dict(rtol=2e-2, atol=2e-2)
FP32 = dict(rtol=1e-4, atol=1e-5)
MARGIN = 4e-2
DECODED = ("smollm-135m", "granite-3-2b", "deepseek-7b", "command-r-35b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch, seed=0):
    """(reference cfg, reference params, port cfg, port params) at the
    reduced size, the port holding the reference's weights."""
    jc = japi.reduced_config(jconfigs.get_config(arch))
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, reduced_config(configs.get_config(arch)), tp


def _margin(logits):
    """Top-2 gap of each row of (..., V) logits."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _hold(got, want):
    """Logits within the bf16 tolerance; greedy tokens equal where the
    reference's top-2 margin exceeds MARGIN.  -> rows compared by token."""
    np.testing.assert_allclose(got, want, **BF16)
    sure = _margin(want) > MARGIN
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    return int(sure.sum())


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _jit_decode(jc):
    return jax.jit(lambda p, c, b: jlm.decode_step(jc, p, c, b))


def _port_step(tokens, t):
    b = tokens.shape[0]
    return {"tokens": torch.from_numpy(tokens[:, t:t + 1].copy()),
            "positions": torch.full((b, 1), t, dtype=torch.int32)}


def _ref_step(tokens, t):
    b = tokens.shape[0]
    return {"tokens": jnp.asarray(tokens[:, t:t + 1]),
            "positions": jnp.full((b, 1), t, jnp.int32)}


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODED + ("internvl2-26b",))
def test_prefill_matches_reference(arch):
    jc, jp, c, tp = _setup(arch)
    tokens = _tokens(c, (4, 12))
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if c.vision_prefix:  # the stub vision tower's patches, prepended
        patches = np.random.default_rng(1).standard_normal(
            (4, c.vision_prefix, c.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    want = np.asarray(jax.jit(lambda p, b: jlm.prefill(jc, p, b))(jp, jb))
    got = prefill(c, tp, tb)
    assert got.dtype == torch.float32 and got.shape == (4, c.vocab)
    _hold(got.numpy(), want)
    if c.vision_prefix:  # the patches reach the text logits
        assert not np.allclose(prefill(c, tp, {"tokens": tb["tokens"]}).numpy(), want, atol=1e-3)


@pytest.mark.parametrize("cache_len", [16, 5], ids=["cache above steps", "ring wraps"])
@pytest.mark.parametrize("arch", DECODED)
def test_decode_matches_reference(arch, cache_len):
    """9 teacher-forced steps; with 5 slots the ring overwrites its oldest
    entries from step 5 on, in both packages."""
    jc, jp, c, tp = _setup(arch)
    tokens = _tokens(c, (3, 9), seed=2)
    jcache, cache = jlm.init_cache(jc, 3, cache_len), init_cache(c, 3, cache_len, device="cpu")
    jd = _jit_decode(jc)
    compared = 0
    for t in range(tokens.shape[1]):
        want, jcache = jd(jp, jcache, _ref_step(tokens, t))
        got, out = decode_step(c, tp, cache, _port_step(tokens, t))
        assert out is cache  # consumed: updated in place and returned
        compared += _hold(got.numpy(), np.asarray(want))
    ref_pos = np.asarray(jcache["dense_blocks"]["pos"])
    np.testing.assert_array_equal(cache["dense_blocks"]["pos"].numpy(), ref_pos)
    np.testing.assert_array_equal(cache["dense_blocks"]["index"].numpy(),
                                  np.asarray(jcache["dense_blocks"]["index"]))
    assert cache["dense_blocks"]["index"].shape == (c.n_layers,)
    np.testing.assert_allclose(cache["dense_blocks"]["k"].float().numpy(),
                               np.asarray(jcache["dense_blocks"]["k"], np.float32), **BF16)
    assert compared > 0


@pytest.mark.parametrize("arch", DECODED)
def test_decode_matches_own_prefill_prefix(arch):
    _, _, c, tp = _setup(arch)
    tokens = _tokens(c, (2, 8), seed=3)
    par = prefill(c, tp, {"tokens": torch.from_numpy(tokens)})
    cache = init_cache(c, 2, 16, device="cpu")
    for t in range(tokens.shape[1]):
        seq, cache = decode_step(c, tp, cache, _port_step(tokens, t))
    np.testing.assert_allclose(seq.numpy(), par.numpy(), **BF16)


def test_blockwise_prefill_matches_reference(monkeypatch):
    """Prompts over the threshold go kv-chunked in both packages (chunks of
    8 over 40 positions)."""
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 16)
    jc, jp, c, tp = _setup("granite-3-2b")
    tokens = _tokens(c, (2, 40), seed=4)
    want = np.asarray(jlm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}))
    got = prefill(c, tp, {"tokens": torch.from_numpy(tokens)})
    _hold(got.numpy(), want)
    monkeypatch.setattr(tl, "BLOCKWISE_THRESHOLD", 8_192)
    np.testing.assert_allclose(prefill(c, tp, {"tokens": torch.from_numpy(tokens)}).numpy(),
                               got.numpy(), **BF16)


def test_reference_cache_carries_across_mid_decode():
    """The reference decodes 4 steps; its cache crosses over and both go on
    for 4 more (the ring of 6 slots wraps on the way)."""
    jc, jp, c, tp = _setup("command-r-35b")
    tokens = _tokens(c, (2, 8), seed=5)
    jcache, jd = jlm.init_cache(jc, 2, 6), _jit_decode(jc)
    for t in range(4):
        _, jcache = jd(jp, jcache, _ref_step(tokens, t))
    cache = model_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    assert cache["dense_blocks"]["index"].dtype == torch.int32
    for t in range(4, 8):
        want, jcache = jd(jp, jcache, _ref_step(tokens, t))
        got, cache = decode_step(c, tp, cache, _port_step(tokens, t))
        _hold(got.numpy(), np.asarray(want))


def test_steps_hold_one_bf16_working_copy_with_the_reference_bits():
    """The working copy holds the bits of the reference's per-call cast: the
    steps equal the functions on the fp32 tree exactly."""
    _, _, c, tp = _setup("deepseek-7b")
    copy = bf16_working_copy(tp)
    assert copy["embed"].dtype == copy["lm_head"].dtype == torch.bfloat16
    assert copy["dense_blocks"]["attn"]["w_q"].dtype == torch.bfloat16
    assert copy["dense_blocks"]["norm1"]["scale"] is tp["dense_blocks"]["norm1"]["scale"]
    tokens = _tokens(c, (2, 5), seed=6)
    step, pre = make_serve_step(c), make_prefill_step(c)
    assert torch.equal(pre(tp, {"tokens": torch.from_numpy(tokens)}),
                       prefill(c, tp, {"tokens": torch.from_numpy(tokens)}))
    a, b = init_cache(c, 2, 4, device="cpu"), init_cache(c, 2, 4, device="cpu")
    for t in range(5):
        got, a = step(tp, a, _port_step(tokens, t))
        want, b = decode_step(c, tp, b, _port_step(tokens, t))
        assert torch.equal(got, want)
    for k in ("k", "v", "pos", "index"):
        assert torch.equal(a["dense_blocks"][k], b["dense_blocks"][k])


@pytest.mark.parametrize("arch", DECODED)
def test_fp32_compute_matches_the_reference_in_fp32(monkeypatch, arch):
    """``set_compute_dtype(float32)`` runs the whole model in fp32, the
    truth the card's bf16 logits are held to (``chip_smoke.py`` 13e): with
    the reference's compute dtype patched to fp32 as well, prefill and
    decode agree to fp32 rounding, and the knob restores bf16."""
    for mod in (jl, jlm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    jc, jp, c, tp = _setup(arch)
    tokens = _tokens(c, (2, 6), seed=7)
    saved = tl.COMPUTE_DTYPE
    tl.set_compute_dtype(torch.float32)
    try:
        want = np.asarray(jlm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}))
        got = prefill(c, tp, {"tokens": torch.from_numpy(tokens)}).numpy()
        np.testing.assert_allclose(got, want, **FP32)
        jcache, cache = jlm.init_cache(jc, 2, 4), init_cache(c, 2, 4, device="cpu")
        assert cache["dense_blocks"]["k"].dtype == torch.float32
        jd = _jit_decode(jc)
        for t in range(tokens.shape[1]):  # the ring of 4 wraps
            want, jcache = jd(jp, jcache, _ref_step(tokens, t))
            got, cache = decode_step(c, tp, cache, _port_step(tokens, t))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    finally:
        tl.set_compute_dtype(saved)
    assert tl.COMPUTE_DTYPE == torch.bfloat16
    assert init_cache(c, 1, 2, device="cpu")["dense_blocks"]["k"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The serving CLI and the example
# ---------------------------------------------------------------------------


def _reference_loop(jc, jp, ids, *, batch, decode_len, cache_len):
    """``repro/launch/serve.py``'s decode loop, recording each step's
    logits and tokens -> (tokens (n, T), logits (n, T, V))."""
    step = jax.jit(lambda p, c, b: jlm.decode_step(jc, p, c, b))
    toks, logs = [], []
    for start in range(0, ids.size, batch):
        chunk = ids[start:start + batch]
        n = chunk.size
        if n < batch:
            chunk = np.pad(chunk, (0, batch - n))
        cache = jlm.init_cache(jc, batch, cache_len)
        tokens = jnp.asarray(chunk % jc.vocab, jnp.int32)[:, None]
        bt, bl = [], []
        for t in range(decode_len):
            logits, cache = step(jp, cache, {"tokens": tokens,
                                             "positions": jnp.full((batch, 1), t, jnp.int32)})
            tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            bt.append(np.asarray(tokens[:n, 0]))
            bl.append(np.asarray(logits[:n]))
        toks.append(np.stack(bt, 1))
        logs.append(np.stack(bl, 1))
    return np.concatenate(toks), np.concatenate(logs)


def _lines(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_decode_requests_matches_the_reference_loop():
    """The routed share is the reference's, and every request's greedy
    tokens follow the reference's until a step whose top-2 margin is at
    most MARGIN (after it the two may feed different tokens)."""
    argv = ["--reduced", "--replicas", "4", "--replica-id", "1", "--requests", "40",
            "--batch", "4", "--decode-len", "6", "--cache-len", "4"]
    ref = _lines(jserve.main, argv)
    port = _lines(serve.main, argv + ["--device", "cpu"])
    share = ref[0].split(" (engine")[0]
    assert port[0].split(" (engine")[0] == share and share.startswith("replica 1 serves ")
    assert port[0].endswith("(engine backend=device, table uploads=1)")
    assert port[1].split(" in ")[0] == ref[1].split(" in ")[0]  # lanes padded, as the reference
    assert port[2].startswith("decode step ") and "host clock, batch 4" in port[2]

    jc, jp, c, tp = _setup("smollm-135m")
    from repro.core import make_uniform_cluster

    ids = np.arange(40, dtype=np.uint32)
    mine = ids[make_uniform_cluster(4).engine.place_nodes(ids) == 1]
    assert share.startswith(f"replica 1 serves {mine.size}/40")
    want_t, want_l = _reference_loop(jc, jp, mine, batch=4, decode_len=6, cache_len=4)
    got_l = np.full(want_l.shape, np.nan, dtype=np.float32)

    def keep(start, t, logits):
        got_l[start:start + logits.shape[0], t] = logits.numpy()

    out = serve.decode_requests(c, tp, mine, batch=4, decode_len=6, cache_len=4, device="cpu",
                                on_step=keep)
    assert out.tokens.shape == want_t.shape == (mine.size, 6)
    assert len(out.step_ms) == 6 * -(-mine.size // 4) and not np.isnan(got_l).any()
    compared = 0
    for r in range(mine.size):
        for t in range(6):
            np.testing.assert_allclose(got_l[r, t], want_l[r, t], **BF16)
            if _margin(want_l[r, t]) <= MARGIN:
                break
            assert out.tokens[r, t] == want_t[r, t]
            compared += 1
    assert compared >= mine.size


def test_cli_counts_the_decoded_lanes_as_the_reference():
    """The tail batch's pad lanes count, as the reference's ``done +=
    ids.size`` after padding: 10 routed requests in batches of 4 are 12."""
    argv = ["--reduced", "--replicas", "4", "--replica-id", "1", "--requests", "40",
            "--batch", "4", "--decode-len", "2"]
    ref = _lines(jserve.main, argv)
    port = _lines(serve.main, argv + ["--device", "cpu"])
    assert ref[0].startswith("replica 1 serves 10/40 ")
    assert port[0].split(" (engine")[0] == ref[0].split(" (engine")[0]
    assert ref[1].startswith("decoded 12 requests x 2 tokens in ")
    assert port[1].startswith("decoded 12 requests x 2 tokens in ")


def test_cli_without_a_device_raises_on_a_host_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "4"])


def test_cli_reports_what_it_measured():
    with contextlib.redirect_stdout(io.StringIO()):
        rep = serve.run(["--reduced", "--device", "cpu", "--requests", "16", "--batch", "2",
                         "--decode-len", "3", "--replicas", "2", "--seed", "3"])
    assert rep["device"] == torch.device("cpu") and rep["cfg"].name == "smollm-135m-smoke"
    assert rep["decoded"].tokens.shape == (rep["ids"].size, 3)
    assert np.array_equal(rep["ids"], np.arange(16)[rep["owners"] == 0])
    assert np.array_equal(rep["owners"], rep["engine"].place_nodes(np.arange(16, dtype=np.uint32)))
    assert rep["step_ms"] > 0 and rep["tok_s"] == pytest.approx(2e3 / rep["step_ms"])
    assert rep["lanes"] == -(-rep["ids"].size // 2) * 2
    again = _silent_run(["--reduced", "--device", "cpu", "--requests", "16", "--batch", "2",
                         "--decode-len", "3", "--replicas", "2", "--seed", "3"])
    np.testing.assert_array_equal(again["decoded"].tokens, rep["decoded"].tokens)


def _silent_run(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return serve.run(argv)


def test_example_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_routing", ROOT / "examples" / "torch_serve_routing.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    lines = _lines(example.main, "cpu")
    assert any("equal: True" in line for line in lines)
    assert any("all to the standby: True" in line for line in lines)
    assert any(line.startswith("replica 0 serves ") for line in lines)
    assert any(line.startswith("decoded ") for line in lines)
