"""The port's MoE and MLA language models served, held to the reference on
the CPU (their training: ``tests/test_torch_moe_mla_train.py``).

mixtral-8x22b (sliding-window attention, 8 experts, top-2) and
deepseek-v2-236b (multi-head latent attention, one dense layer, then MoE
with a shared expert) at the reference's ``reduced_config`` (2 layers,
d_model 128, 8 experts of width 128, top-2, window 16, vocab 512), the
same weights in both packages (the layer cases draw the reference's and
carry them across with ``convert``; the models draw the port's), inputs
from NumPy seeds.  Tolerances:

* fp32 compute (both packages switched to fp32): ``rtol=1e-4, atol=1e-5``
  for layer outputs, the aux loss and logits;
* bf16 (the default): ``rtol=atol=2e-2``, the reference's bf16 tolerance;
* routes (each token's experts, in choice order) and the assignments that
  capacity drops: exactly, wherever the two packages see the same layer
  input (the layer cases and every fp32 case), ties included.

Routing is discontinuous.  In bf16 the router logits are rounded to bf16,
and layer inputs that differ by a rounding (the two packages round their
bf16 products and fused elementwise chains differently) can order two
experts differently where their logits lie within a few bf16 steps: a
route flip, after which the token's row differs by a whole expert's
output.  So the model-level bf16 cases record every MoE call's router
logits in both packages (the port through ``routes.RouteLog``, the
reference through a spy on its ``moe_apply``, in the test only), require
the routes to be equal wherever the reference's smallest gap among a
token's top k + 1 logits exceeds ``ROUTE_EPS`` x the token's largest
|logit| (8 bf16 steps at that scale), and hold the logits at 2e-2 on the
rows no flip reached.  A flip reaches the flipped token's row (in decode
from that step on, through the cache) and any row of its dispatch group
whose kept assignments it changes (it reorders the queue for a slot).
A row a flip reached may differ; at least half of all rows agree.
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
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.convert import (
    model_cache_from_reference,
    model_params_from_reference,
    opt_state_from_reference,
)
from repro_torch.launch import serve
from repro_torch.models import (
    ShapeSpec,
    cache_specs,
    decode_step,
    init_cache,
    input_specs,
    make_inputs,
    param_specs,
    prefill,
    reduced_config,
)
from repro_torch.models import layers as tl
from repro_torch.models.routes import RouteLog, route_changes
from repro_torch.train.optimizer import tree_flatten
from torch_lm_parity import _hold_state, fp32, reduced_setup, tokens as _tokens  # noqa: F401

ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ROUTE_EPS = 2.0**-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
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


def _inputs(rng, shape, dtype, mean=0.0):
    """The same values on both sides: (jax array, torch tensor) in fp32 or
    bf16, from a NumPy draw."""
    a = (rng.standard_normal(shape) + mean).astype(np.float32)
    if dtype == "fp32":
        return jnp.asarray(a), torch.from_numpy(a)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _port_tree(tree):
    return model_params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# Routes: recorded in both packages, compared on the host
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Routes:
    """Every MoE call's routing, in call order: the reference's fp32 router
    logits (G, Sg, E) from a spy on its ``moe_apply`` (``ref_moe``; the
    model reaches it through ``repro.models.lm``, patched in the test), the
    port's (logits, experts, keep) from a ``RouteLog``."""

    ref: list
    port: RouteLog
    ref_moe: object


@pytest.fixture
def routes(monkeypatch):
    ref = []
    real = jl.moe_apply

    def ref_moe(cfg, p, x, moe):
        b, s, d = x.shape
        g = max(b * s // jl.MOE_GROUP, 1)
        logits = (x.reshape(g, -1, d) @ p["router"].astype(x.dtype)).astype(jnp.float32)
        jax.debug.callback(lambda a: ref.append(np.array(a)), logits)
        return real(cfg, p, x, moe)

    monkeypatch.setattr(jlm, "moe_apply", ref_moe)
    with RouteLog() as port:
        yield _Routes(ref, port, ref_moe)


def _port_call(routes):
    """The port's last recorded call as NumPy (logits, experts, keep)."""
    return tuple(t.cpu().numpy() for t in routes.port.calls[-1])


def _order(logits, k):
    """The top-k experts of each token in choice order, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    return np.argsort(-logits, axis=-1, kind="stable")[..., :k]


def _gap(logits, k):
    """The smallest gap among each token's k + 1 largest logits: under it a
    perturbation can change the chosen set or their order."""
    top = -np.sort(-logits, axis=-1)[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(-1)


def _keep_oracle(logits, k, cap):
    """The reference's capacity rule in NumPy: an assignment is kept while
    the count of earlier assignments (in (token, choice) order) to its
    expert is below cap."""
    g, sg, e = logits.shape
    experts = _order(logits, k).reshape(g, sg * k)
    onehot = np.eye(e, dtype=np.int64)[experts]
    pos = ((np.cumsum(onehot, axis=1) - 1) * onehot).sum(-1)
    return pos < cap


class _Flips:
    """The batch rows a route flip reached (``routes.route_changes``), MoE
    call by call from the calls recorded after it was made: the reference's routes (its logits through the NumPy
    oracles of top-k and capacity) are the truth, and every flip of a row
    not hit before must lie within ``ROUTE_EPS`` of the reference's gap."""

    def __init__(self, routes: _Routes, moe):
        self.routes, self.moe = routes, moe
        self.hit, self.seen, self.flips = None, len(routes.port.calls), 0

    def update(self, tokens_per_row: int) -> np.ndarray:
        """Take the calls recorded since the last update -> rows not hit."""
        k, truth = self.moe.top_k, []
        for r in self.routes.ref[self.seen:]:
            cap = int(max(r.shape[1] * k / r.shape[2] * self.moe.capacity_factor, 4))
            truth.append((torch.from_numpy(r), torch.from_numpy(_order(r, k)),
                          torch.from_numpy(_keep_oracle(r, k, cap))))
        port = self.routes.port.calls[self.seen:]
        for (p, experts, _), (r, _, _) in zip(port, truth):
            np.testing.assert_array_equal(experts.numpy(), _order(p.numpy(), k))  # its own order
            assert p.shape == r.shape
        out = route_changes(truth, port, tokens_per_row=tokens_per_row, eps=ROUTE_EPS,
                            hit=self.hit)
        assert out["wide"] == 0, f"{out['wide']} routes flipped across a wide gap"
        self.flips += out["flips"]
        self.seen += out["calls"]
        self.hit = ~out["held"]
        return out["held"].numpy()


def _hold_rows(got, want, held, tol):
    """Logits (rows, V) at ``tol`` on every row no flip reached; a row a
    flip reached may differ, but at least half of all rows agree."""
    np.testing.assert_allclose(got[held], want[held], **tol)
    close = np.isclose(got, want, **tol).all(-1)
    assert close.sum() * 2 >= close.size, f"{int((~close).sum())} rows differ"


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _moe_case(arch, dtype, shape, routes, seed=1, edit=None, mean=0.0, **changes):
    """The reference's and the port's ``moe_apply`` on the same input (of
    mean ``mean``) and weights (``edit`` changes the reference's NumPy tree
    first) -> (jc, c,
    want y, want aux, got y, got aux, reference logits, port (logits,
    experts, keep))."""
    jc, c = _cfgs(arch, **changes)
    jp = jax.tree.map(np.array, jl.moe_init(jax.random.PRNGKey(seed), jc, jc.moe))
    if edit is not None:
        edit(jp)
    tp = _port_tree(jp)
    jx, tx = _inputs(np.random.default_rng(seed), shape + (c.d_model,), dtype, mean)
    want, want_aux = jax.jit(routes.ref_moe, static_argnums=(0, 3))(jc, jp, jx, jc.moe)
    got, got_aux = tl.moe_apply(c, tp, tx, c.moe)
    assert got.dtype == tx.dtype and got_aux.dtype == torch.float32
    return jc, c, _np(want), float(want_aux), _np(got), float(got_aux), routes.ref[-1], \
        _port_call(routes)


def _cap(c, sg):
    return int(max(sg * c.moe.top_k / c.moe.n_experts * c.moe.capacity_factor, 4))


@pytest.mark.parametrize("shape", [(2, 12), (4, 300)], ids=["1 group", "4 groups"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(routes, arch, dtype, shape):
    """Output and aux loss; routes and the kept assignments exactly (the
    same input reaches both routers); deepseek-v2's shared expert."""
    jc, c, want, want_aux, got, got_aux, rlog, (plog, experts, keep) = _moe_case(
        arch, dtype, shape, routes)
    np.testing.assert_allclose(got, want, **(FP32 if dtype == "fp32" else BF16))
    np.testing.assert_allclose(got_aux, want_aux, rtol=1e-4)
    k = c.moe.top_k
    np.testing.assert_array_equal(experts, _order(rlog, k))
    np.testing.assert_array_equal(keep, _keep_oracle(rlog, k, _cap(c, rlog.shape[1])))
    assert rlog.shape[0] == max(shape[0] * shape[1] // tl.MOE_GROUP, 1)
    if arch == "deepseek-v2-236b":
        assert c.moe.n_shared == 1


def test_moe_router_ties_route_to_the_lower_expert(routes):
    """Experts 2 and 5 share one router column, scaled so that they often
    lead: every token ties them, and both packages take 2 before 5 (a
    choice of 5 would add another expert's output)."""
    def tie(p):
        p["router"][:, 2] *= 4.0
        p["router"][:, 5] = p["router"][:, 2]

    jc, c, want, _, got, _, rlog, (_, experts, keep) = _moe_case(
        "mixtral-8x22b", "fp32", (4, 300), routes, edit=tie)
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_array_equal(experts, _order(rlog, 2))
    first = experts[..., 0]
    both = (experts == 2).any(-1) & (experts == 5).any(-1)
    boundary = (experts[..., 1] == 2) & ~both  # 2 second, 5 tied third and left out
    assert (first[both] == 2).all() and both.sum() > 50 and boundary.sum() > 0
    assert not (experts == 5).any(-1)[~both].any()
    np.testing.assert_array_equal(keep, _keep_oracle(rlog, 2, _cap(c, 300)))


def test_moe_capacity_overflow_drops_what_the_reference_drops(routes):
    """A router biased to expert 0 (inputs of mean 1, +0.05 on its column):
    every token chooses it first, so each group's later tokens overflow its
    capacity; the same assignments drop in both packages, and the dropped
    gates are not renormalised."""
    def bias(p):
        p["router"][:, 0] += 0.05

    jc, c, want, _, got, _, rlog, (_, experts, keep) = _moe_case(
        "deepseek-v2-236b", "fp32", (4, 300), routes, edit=bias, mean=1.0)
    np.testing.assert_allclose(got, want, **FP32)
    cap = _cap(c, 300)
    assert (experts[..., 0] == 0).all()
    np.testing.assert_array_equal(keep, _keep_oracle(rlog, 2, cap))
    first = keep.reshape(4, 300, 2)[..., 0]
    assert first[:, :cap].all() and not first[:, cap:].any()  # earlier tokens first


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_moe_gelu_variants_match_reference(routes, act):
    """``act == "gelu"``: no w_up, the gate matrix through the tanh gelu
    (the reverse of ``mlp_apply``, which keeps w_up); geglu keeps both."""
    jc, c, want, want_aux, got, got_aux, rlog, (_, experts, _) = _moe_case(
        "mixtral-8x22b", "fp32", (2, 12), routes, act=act)
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_array_equal(experts, _order(rlog, 2))
    keys = set(tl.moe_init(torch.Generator(), c, c.moe, device="cpu"))
    assert keys == set(jl.moe_init(jax.random.PRNGKey(0), jc, jc.moe))
    assert ("w_up" in keys) == (act == "geglu")


def test_moe_token_count_that_does_not_group_raises():
    """513 tokens make 2 groups of 256.5: the reference's reshape raises,
    and so does the port (no padding); 512 run."""
    jc, c = _cfgs("mixtral-8x22b")
    jp = jl.moe_init(jax.random.PRNGKey(0), jc, jc.moe)
    tp = _port_tree(jp)
    rng = np.random.default_rng(0)
    jx, tx = _inputs(rng, (1, 513, c.d_model), "fp32")
    with pytest.raises(TypeError):
        jl.moe_apply(jc, jp, jx, jc.moe)
    with pytest.raises(ValueError, match="513 tokens do not split into 2 equal groups"):
        tl.moe_apply(c, tp, tx, c.moe)
    jx, tx = _inputs(rng, (2, 256, c.d_model), "fp32")
    want = jax.jit(jl.moe_apply, static_argnums=(0, 3))(jc, jp, jx, jc.moe)[0]
    np.testing.assert_allclose(_np(tl.moe_apply(c, tp, tx, c.moe)[0]), _np(want), **FP32)


# ---------------------------------------------------------------------------
# The MLA layer
# ---------------------------------------------------------------------------


def _mla_params(seed=2):
    jc, c = _cfgs("deepseek-v2-236b")
    jp = jl.mla_init(jax.random.PRNGKey(seed), jc, jc.mla)
    return jc, c, jp, _port_tree(jp)


def _ref_mla(jc):
    """The reference's ``mla_apply``, jitted (traced at the first call,
    after the test's patches)."""
    return jax.jit(lambda p, x, pos, cache=None: jl.mla_apply(jc, p, x, positions=pos,
                                                              cache=cache))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mla_prefill_matches_reference(dtype):
    jc, c, jp, tp = _mla_params()
    jx, tx = _inputs(np.random.default_rng(3), (2, 11, c.d_model), dtype)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want, none = _ref_mla(jc)(jp, jx, jnp.asarray(pos))
    got, also_none = tl.mla_apply(c, tp, tx, positions=torch.from_numpy(pos))
    assert none is None and also_none is None
    assert got.shape == (2, 11, c.d_model) and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **(FP32 if dtype == "fp32" else BF16))
    assert set(tp) == set(tl.mla_init(torch.Generator(), c, c.mla, device="cpu"))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mla_blockwise_matches_reference(monkeypatch, dtype):
    """Above the threshold (16, chunks of 8, 37 positions: a padded last
    chunk) both packages go kv-chunked on values padded to the key dim."""
    jc, c, jp, tp = _mla_params()
    jx, tx = _inputs(np.random.default_rng(4), (2, 37, c.d_model), dtype)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37)).copy()
    dense, _ = tl.mla_apply(c, tp, tx, positions=torch.from_numpy(pos))
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 16)
    calls = []
    real = tl._sdpa_blockwise
    monkeypatch.setattr(tl, "_sdpa_blockwise", lambda *a, **k: calls.append(a[2].shape) or
                        real(*a, **k))
    want, _ = _ref_mla(jc)(jp, jx, jnp.asarray(pos))
    got, _ = tl.mla_apply(c, tp, tx, positions=torch.from_numpy(pos))
    qk = c.mla.qk_nope_dim + c.mla.qk_rope_dim
    assert calls == [(2, 37, c.n_heads, qk)]  # v padded from v_head_dim to the key dim
    tol = FP32 if dtype == "fp32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(dense), **tol)


def test_mla_head_groups_hold_the_same_result(monkeypatch):
    """``SCORE_BYTES`` bounds the scores held at once by running heads in
    groups: one head at a time gives what all heads at once give."""
    _, c, _, tp = _mla_params()
    _, tx = _inputs(np.random.default_rng(5), (2, 9, c.d_model), "fp32")
    pos = torch.arange(9, dtype=torch.int32).expand(2, -1)
    whole, _ = tl.mla_apply(c, tp, tx, positions=pos)
    monkeypatch.setattr(tl, "SCORE_BYTES", 4 * 2 * 9 * 9)  # one head's scores
    one, _ = tl.mla_apply(c, tp, tx, positions=pos)
    np.testing.assert_allclose(one.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mla_decode_ring_cache_matches_reference(monkeypatch, dtype):
    """Decode one token at a time into a 4-slot compressed ring: the
    latent and RoPE key slots agree with the reference's, the positions and
    the index exactly, also after the ring wraps."""
    if dtype == "fp32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    jc, c, jp, tp = _mla_params()
    jcache, cache = jl.mla_cache_init(jc, 2, 4), tl.mla_cache_init(c, 2, 4)
    assert cache["ckv"].shape == (2, 4, c.mla.kv_lora_rank) and cache["index"].shape == ()
    rng = np.random.default_rng(6)
    tol = FP32 if dtype == "fp32" else BF16
    ref = _ref_mla(jc)
    for t in range(7):
        jx, tx = _inputs(rng, (2, 1, c.d_model), dtype)
        pos = np.full((2, 1), t, np.int32)
        want, jcache = ref(jp, jx, jnp.asarray(pos), jcache)
        got, same = tl.mla_apply(c, tp, tx, positions=torch.from_numpy(pos), cache=cache)
        assert same is cache  # written in place and returned
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        assert int(cache["index"]) == int(jcache["index"]) == t + 1
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **tol)
    np.testing.assert_array_equal(cache["pos"][0].numpy(), [4, 5, 6, 3])


# ---------------------------------------------------------------------------
# Trees, converters, specs
# ---------------------------------------------------------------------------


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_and_converters_carry_both_stacks_exactly(arch):
    """Parameter and cache trees (the "blocks" MoE stack, deepseek-v2's
    "dense_blocks" layer, expert leaves, the compressed cache) have the
    reference's keys, shapes and dtypes, and values in the reference's
    parameter tree, its cache (after 3 decode steps) and its AdamW state
    cross over bit for bit."""
    jc, jp, c, tp = reduced_setup(arch)
    specs = jlm.param_specs(jc)
    jspec = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), specs)
    assert _shapes(param_specs(c)) == _shapes(tp) == jspec
    assert set(jspec) >= {"blocks"} and ("dense_blocks" in jspec) == (c.n_dense_layers > 0)
    assert tp["blocks"]["moe"]["w_gate"].shape == (1 if c.n_dense_layers else 2, 8, 128, 128)
    rng = np.random.default_rng(0)
    drawn = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), specs)
    carried = model_params_from_reference(drawn, device="cpu")
    assert _shapes(carried) == jspec
    for a, b in zip(jax.tree.leaves(drawn), tree_flatten(carried)[0]):
        np.testing.assert_array_equal(a, b.numpy())
    jcspec = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), japi.cache_specs(jc, 3, 10))
    assert _shapes(cache_specs(c, 3, 10)) == _shapes(init_cache(c, 3, 10, device="cpu")) == jcspec
    tokens = _tokens(c, (3, 3))
    jcache, jd = jlm.init_cache(jc, 3, 10), jax.jit(lambda p, cc, b: jlm.decode_step(jc, p, cc, b))
    for t in range(3):
        _, jcache = jd(jp, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                    "positions": jnp.full((3, 1), t, jnp.int32)})
    cache = model_cache_from_reference(jax.tree.map(np.asarray, jcache), device="cpu")
    for a, b in zip(jax.tree.leaves(jcache), tree_flatten(cache)[0]):
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())
    js = jax.tree.map(np.asarray, jstep.init_train_state(jc, jp))
    js = dict(js, m=jax.tree.map(lambda x: x + 0.5, js["m"]), count=js["count"] + 3)
    state = opt_state_from_reference(js, device="cpu")
    _hold_state(state, js)
    for a, b in zip(jax.tree.leaves(js["m"]), tree_flatten(state["m"])[0]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_make_inputs_cover_both_families(arch):
    spec = ShapeSpec("smoke_decode", seq_len=24, global_batch=2, kind="decode")
    c, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got, want = input_specs(c, spec), japi.input_specs(jcfg, spec)
    flat_got, flat_want = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
    small = reduced_config(c)
    dec = make_inputs(small, spec, torch.Generator().manual_seed(0), device="cpu")
    key = "ckv" if small.mla is not None else "k"
    assert dec["cache"]["blocks"][key].shape[1:3] == (2, 24 if small.mla else small.window)
    assert dec["batch"]["positions"].tolist() == [[23], [23]]


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(request, routes, arch, dtype):
    """4 prompts of 12 (one dispatch group) and 16 of 32 (two groups of
    256; mixtral's window of 16 masks): in fp32 every route equal and the
    logits at 1e-4, in bf16 the logits at 2e-2 on the rows no flip
    reached."""
    if dtype == "fp32":
        request.getfixturevalue("fp32")
    jc, jp, c, tp = reduced_setup(arch)
    for b, s in ((4, 12), (16, 32)):
        flips = _Flips(routes, c.moe)
        tokens = _tokens(c, (b, s), seed=s)
        want = np.asarray(jax.jit(lambda p, t: jlm.prefill(jc, p, {"tokens": t}))(
            jp, jnp.asarray(tokens)))
        got = prefill(c, tp, {"tokens": torch.from_numpy(tokens)})
        assert got.dtype == torch.float32 and got.shape == (b, c.vocab)
        held = flips.update(s)
        if dtype == "fp32":
            assert flips.flips == 0
            np.testing.assert_allclose(got.numpy(), want, **FP32)
        else:
            _hold_rows(got.numpy(), want, held, BF16)


@pytest.mark.parametrize("dtype,cache_len", [("fp32", 5), ("bf16", 16), ("bf16", 5)],
                         ids=["fp32 ring wraps", "bf16 cache above steps", "bf16 ring wraps"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(request, routes, arch, dtype, cache_len):
    """9 teacher-forced steps at batch 4 (capacity 4 per expert: no drops
    at top-2 of 8), the cache consumed; with 5 slots the ring overwrites its
    oldest entries from step 5 on.  Positions and index exactly, the cache
    values on the held rows."""
    if dtype == "fp32":
        request.getfixturevalue("fp32")
    jc, jp, c, tp = reduced_setup(arch)
    b = 4
    tokens = _tokens(c, (b, 9), seed=2)
    jcache, cache = jlm.init_cache(jc, b, cache_len), init_cache(c, b, cache_len, device="cpu")
    jd = jax.jit(lambda p, cc, bb: jlm.decode_step(jc, p, cc, bb))
    flips = _Flips(routes, c.moe)
    tol = FP32 if dtype == "fp32" else BF16
    for t in range(tokens.shape[1]):
        want, jcache = jd(jp, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                       "positions": jnp.full((b, 1), t, jnp.int32)})
        got, out = decode_step(c, tp, cache, {
            "tokens": torch.from_numpy(tokens[:, t:t + 1].copy()),
            "positions": torch.full((b, 1), t, dtype=torch.int32)})
        assert out is cache
        held = flips.update(1)
        _hold_rows(got.numpy(), np.asarray(want), held, tol)
    assert all(bool(keep.all()) for _, _, keep in routes.port.calls)
    if dtype == "fp32":
        assert flips.flips == 0
    for key in cache:
        for name, leaf in cache[key].items():
            ref = np.asarray(jcache[key][name].astype(jnp.float32))
            if name in ("pos", "index"):
                np.testing.assert_array_equal(leaf.numpy(), ref)
            else:  # (L, B, ...)
                np.testing.assert_allclose(leaf.float().numpy()[:, held], ref[:, held], **tol)
    assert cache["blocks"]["index"].tolist() == [9] * cache["blocks"]["index"].numel()


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def _lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().splitlines()


def test_serving_cli_matches_the_reference_cli():
    """mixtral at ``--reduced``: the routed share and the decoded lanes are
    the reference CLI's; the decode at batch 8 runs at capacity 4, where
    top-2 of 8 can overflow an expert."""
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--replicas", "4", "--replica-id", "1",
            "--requests", "40", "--batch", "8", "--decode-len", "3", "--cache-len", "4"]
    _, ref = _lines(jserve.main, argv)
    rep, port = _lines(serve.run, argv + ["--device", "cpu"])
    assert port[0].split(" (engine")[0] == ref[0].split(" (engine")[0]
    assert port[1].split(" in ")[0] == ref[1].split(" in ")[0]
    assert rep["cfg"].name == "mixtral-8x22b-smoke"
    assert rep["decoded"].tokens.shape == (rep["ids"].size, 3)
    assert rep["decoded"].tokens.max() < rep["cfg"].vocab
