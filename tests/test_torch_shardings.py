"""The port's sharding rules (``repro_torch.launch.{mesh,shardings}``) against
the reference's (``repro.launch.{mesh,shardings}``), exactly, on the
production mesh shapes.

The spec functions take any mesh-like object, so both packages are asked on
fake 16x16 and 2x16x16 meshes: every leaf of ``param_specs`` of all ten
configs (train and serve specs), every leaf of ``cache_specs`` for each
decode shape the config runs, the batch and logits specs, and the
counterparts of ``tests/test_shardings.py``'s cases.  The reference's tree
functions wrap each spec in a ``NamedSharding``, which needs a real jax
mesh; the tests swap in the bare spec (nothing of the reference is edited).
The per-device argument bytes of every (arch x shape) cell on 16x16 are
held to the sum of local shard bytes under the reference's specs, and
``to_placements`` is checked on a fake-backend 2x2 ``DeviceMesh`` (the
4-rank gloo selftest of ``tests/test_torch_sharded_step.py`` checks every
rank's local shards too).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.launch import mesh as ref_mesh
from repro.launch import shardings as ref_sh
from repro.models import cache_specs as ref_cache_specs
from repro.models import input_specs as ref_input_specs
from repro.models import param_specs as ref_param_specs
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import batch_pspec, data_axes
from repro_torch.models import cache_specs, param_specs


class FakeMesh:
    def __init__(self, multi_pod: bool):
        self.axis_names = ("pod", "data", "model") if multi_pod else ("data", "model")
        self.shape = dict(zip(self.axis_names, (2, 16, 16) if multi_pod else (16, 16)))


MESHES = {"16x16": FakeMesh(False), "2x16x16": FakeMesh(True)}


@pytest.fixture(params=list(MESHES))
def mesh(request):
    return MESHES[request.param]


@pytest.fixture
def bare_ref(monkeypatch):
    """The reference's tree functions with ``NamedSharding`` -> its spec."""
    monkeypatch.setattr(ref_sh, "NamedSharding", lambda mesh, spec: spec)
    return ref_sh


def _ref_leaves(tree):
    """[(names, leaf)] of a reference tree."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(str(p.key) for p in path), leaf))
    return out


def _port_leaf(tree, names):
    for n in names:
        tree = tree[n]
    return tree


def _ref_path(names):
    return tuple(jax.tree_util.DictKey(n) for n in names)


# ---------------------------------------------------------------------------
# every leaf of every config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, bare_ref):
    ref_tree = ref_param_specs(ref_config(arch))
    port_tree = param_specs(get_config(arch))
    serve_ref = bare_ref.serve_param_shardings(mesh, ref_tree)
    serve_port = shardings.serve_param_shardings(mesh, port_tree)
    leaves = _ref_leaves(ref_tree)
    assert len(leaves) == len(_flat(port_tree))
    for names, leaf in leaves:
        port = _port_leaf(port_tree, names)
        assert tuple(port.shape) == tuple(leaf.shape), names
        want = tuple(ref_sh.param_pspec(_ref_path(names), leaf, mesh))
        assert shardings.param_pspec(names, port, mesh) == want, names
        assert shardings.param_pspec(names, port) == tuple(ref_sh.param_pspec(
            _ref_path(names), leaf)), names
        assert _port_leaf(serve_port, names).spec == tuple(_port_leaf(serve_ref, names)), names


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def _decode_shapes(cfg):
    return [s for s in ("decode_32k", "long_500k") if shape_applicable(cfg, SHAPES[s])[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh, bare_ref):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in _decode_shapes(cfg):
        spec = SHAPES[shape]
        ref_tree = ref_cache_specs(rcfg, spec.global_batch, spec.seq_len)
        port_tree = cache_specs(cfg, spec.global_batch, spec.seq_len)
        want_tree = bare_ref.cache_shardings(mesh, rcfg, ref_tree)
        got_tree = shardings.cache_shardings(mesh, cfg, port_tree)
        leaves = _ref_leaves(ref_tree)
        assert len(leaves) == len(_flat(port_tree))
        for names, leaf in leaves:
            assert tuple(_port_leaf(port_tree, names).shape) == tuple(leaf.shape), names
            got = _port_leaf(got_tree, names).spec
            assert got == tuple(_port_leaf(want_tree, names)), (shape, names)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_logits_specs_equal_the_reference(arch, mesh, bare_ref):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape, spec in SHAPES.items():
        ref_batch = ref_input_specs(rcfg, spec)["batch"]
        want = bare_ref.batch_shardings(mesh, ref_batch)
        got = shardings.batch_shardings(
            mesh, {k: torch.empty(v.shape, device="meta") for k, v in ref_batch.items()})
        for k in ref_batch:
            assert got[k].spec == tuple(want[k]), (shape, k)
        assert shardings.logits_sharding(mesh, spec.global_batch, cfg.vocab).spec == tuple(
            bare_ref.logits_sharding(mesh, spec.global_batch, rcfg.vocab))


def test_data_axes_and_batch_pspec(mesh):
    assert data_axes(mesh) == ref_mesh.data_axes(mesh)
    assert batch_pspec(mesh) == tuple(ref_mesh.batch_pspec(mesh))


# ---------------------------------------------------------------------------
# the counterparts of tests/test_shardings.py
# ---------------------------------------------------------------------------


def test_megatron_pairing():
    sh = shardings.param_shardings(MESHES["16x16"], param_specs(get_config("granite-3-2b")))
    blocks = sh["dense_blocks"]
    assert blocks["attn"]["w_q"].spec == (None, "data", "model")
    assert blocks["attn"]["w_o"].spec == (None, "model", "data")
    assert blocks["mlp"]["w_gate"].spec == (None, "data", "model")
    assert blocks["mlp"]["w_down"].spec == (None, "model", "data")


def test_embed_vocab_on_model():
    sh = shardings.param_shardings(MESHES["16x16"], param_specs(get_config("deepseek-7b")))
    assert sh["embed"].spec == ("model", "data")
    assert sh["lm_head"].spec == ("data", "model")


def test_moe_expert_parallel_and_fallback():
    mesh = MESHES["16x16"]
    ds = shardings.param_shardings(mesh, param_specs(get_config("deepseek-v2-236b")))
    assert ds["blocks"]["moe"]["w_gate"].spec[-3] == "model"  # 160 experts: EP
    leaf = param_specs(get_config("mixtral-8x22b"))["blocks"]["moe"]["w_gate"]
    assert shardings.param_pspec(("blocks", "moe", "w_gate"), leaf, mesh) == (
        None, None, "data", "model")  # 8 experts < 16: TP over d_ff


def test_norms_replicated():
    sh = shardings.param_shardings(MESHES["16x16"], param_specs(get_config("granite-3-2b")))
    assert sh["final_norm"]["scale"].spec == ()


def test_fit_drops_nondividing_axes():
    m = MESHES["2x16x16"]
    assert shardings._fit(m, ("data", "model"), (1, 32768)) == (None, "model")
    assert shardings._fit(m, ("model",), (8,)) == (None,)
    assert shardings._fit(m, (("pod", "data"),), (64,)) == (("pod", "data"),)
    assert shardings._fit(m, (("pod", "data"),), (16,)) == (None,)
    assert shardings._fit(m, ("data", "model"), (256, 4096)) == ("data", "model")


def test_batch1_moves_to_the_sequence():
    cfg = get_config("mixtral-8x22b")
    leaf = cache_specs(cfg, 1, 4096)["blocks"]["k"]  # (56, 1, 4096, 8, 128)
    assert shardings.cache_pspec(("blocks", "k"), leaf, MESHES["16x16"], cfg) == (
        None, None, ("data", "model"), None, None)
    cfg = get_config("deepseek-7b")
    leaf = cache_specs(cfg, 128, 32768)["dense_blocks"]["k"]
    assert shardings.cache_pspec(("dense_blocks", "k"), leaf, MESHES["16x16"], cfg) == (
        None, "data", None, "model", None)


def test_batch_first_dim():
    sh = shardings.batch_shardings(MESHES["16x16"], {"tokens": torch.empty((32, 128),
                                                                           device="meta")})
    assert sh["tokens"].spec == ("data", None)


# ---------------------------------------------------------------------------
# per-device argument bytes of every cell
# ---------------------------------------------------------------------------


def _ref_local_bytes(mesh, tree, specs) -> int:
    sizes = mesh.shape
    total = 0
    for (_, leaf), (_, spec) in zip(_ref_leaves(tree), _ref_leaves_specs(specs)):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                shape[d] //= sizes[a]
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


def _ref_leaves_specs(tree):
    # a spec tree's leaves are PartitionSpecs (tuples): stop there
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(p, tuple(s)) for p, s in flat]


def _ref_cell_bytes(bare, mesh, rcfg, spec) -> int:
    """The reference dry run's argument tree and shardings (its
    ``build_cell`` with ``serve_tp_only``, the CLI default)."""
    params = ref_param_specs(rcfg)
    if spec.kind == "train":
        opt = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
        trees = [params, opt, opt, {"c": jax.ShapeDtypeStruct((), jnp.int32)},
                 ref_input_specs(rcfg, spec)["batch"]]
        sh = bare.param_shardings(mesh, params)
        specs = [sh, sh, sh, {"c": jax.sharding.PartitionSpec()},
                 bare.batch_shardings(mesh, trees[-1])]
    else:
        bf = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.bfloat16), params)
        ins = ref_input_specs(rcfg, spec)
        trees = [bf, ins["batch"]]
        specs = [bare.serve_param_shardings(mesh, bf), bare.batch_shardings(mesh, ins["batch"])]
        if spec.kind == "decode":
            trees.append(ins["cache"])
            specs.append(bare.cache_shardings(mesh, rcfg, ins["cache"]))
    return sum(_ref_local_bytes(mesh, t, s) for t, s in zip(trees, specs))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_argument_bytes_equal_the_reference_spec_sum(arch, bare_ref):
    mesh = MESHES["16x16"]
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape, spec in SHAPES.items():
        if not shape_applicable(cfg, spec)[0]:
            continue
        got = dryrun.cell_argument_bytes(cfg, spec, mesh)
        assert got == _ref_cell_bytes(bare_ref, mesh, rcfg, spec), shape


# ---------------------------------------------------------------------------
# to_placements on a DeviceMesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_2x2():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield make_debug_mesh(2, 2, device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("spec", [(), ("data", None), (None, "model"), ("model", "data"),
                                  (("data", "model"), None), (None, ("data", "model"))])
def test_to_placements_gives_the_local_shards_the_spec_implies(fake_2x2, spec):
    from torch.distributed.tensor import distribute_tensor

    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sh = shardings.NamedSharding(fake_2x2, spec)
    d = distribute_tensor(t, fake_2x2, sh.placements)
    assert tuple(d.to_local().shape) == shardings.local_shape(sh, t.shape)
    assert tuple(d.shape) == (8, 12)


def test_to_placements_refuses_axes_out_of_mesh_order():
    with pytest.raises(ValueError):
        shardings.to_placements(MESHES["16x16"], (("model", "data"),))


def test_meshes_need_a_process_group_of_their_size(monkeypatch, fake_2x2):
    from repro_torch.launch import mesh as port_mesh

    with pytest.raises(ValueError, match="needs 256 ranks"):
        port_mesh.make_production_mesh(device_type="cpu")  # the group has 4
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        port_mesh.make_debug_mesh(1, 1, device_type="cpu")
