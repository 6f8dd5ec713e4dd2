"""The port's sharded model steps (``repro_torch.launch.shardings`` on a
``DeviceMesh``, the models' placement hooks) against the unsharded port and
the reference, on the CPU.

Two halves, as ``tests/test_torch_mesh.py``:

  * IN PROCESS at world size 1: a module-scoped gloo group and a 1x1
    ``make_debug_mesh``.  The counterpart of the reference's
    ``test_sharded_train_step_on_debug_mesh``: reduced smollm-135m with the
    reference's weights carried across (``convert``), the batch from the
    port's ``DataPipeline`` (equal to the reference's), one sharded train
    step whose loss equals the reference's unsharded loss at rtol 1e-5.
    Both packages compute in fp32 there: across two implementations a bf16
    loss differs by roundings far above 1e-5.  The same step, a prefill
    and decode steps on the mesh equal the unsharded port's (exactly; one
    rank: every collective is the identity; the train step, at
    ``SELFTEST_OPT``'s lr 1e-2 from step 1, at rtol 1e-4 / atol 1e-5, the
    moments at atol 1e-5 x each leaf's max and the update by
    ``hold_update``, since the vocab-parallel cross-entropy sums in its
    own order), and with no mesh registered the hooks change nothing.
  * FOUR RANKS: ``python -m repro_torch.launch.shardings --selftest``
    spawns 4 gloo ranks on a 2x2 mesh (one thread each) that hold one
    train step, a prefill and 3 decode steps of reduced smollm-135m,
    mixtral-8x22b, deepseek-v2-236b and rwkv6-3b (and mixtral with 7
    experts, the MoE's tensor-parallel fallback) in fp32 to the unsharded
    port as the 1x1 case holds it, MoE routes exactly, on every rank, and
    check every rank's local shards against the specs and a
    sequence-sharded ring's writes (one slot, two shards', wrapping; batch
    4 and 1).  The run starts with the module and overlaps the in-process
    cases.  The same selftest on 1x3 (RWKV6's heads do not divide the
    model axis) and on 2x2x1 and 2x1x2 meshes with a "pod" axis, whose
    batch lives on the flattened batch mesh.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.data import DataPipeline as RefPipeline
from repro.data import ShardedDataset as RefDataset
from repro.core import make_uniform_cluster as ref_cluster
from repro.models import api as japi
from repro.models import init_params as ref_init_params
from repro.train import AdamWConfig as RefAdamW
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.core import make_uniform_cluster
from repro_torch.data import DataPipeline, ShardedDataset
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import hooks, init_cache, reduced_config
from repro_torch.train import AdamWConfig, init_train_state, make_prefill_step
from repro_torch.train import make_serve_step, make_train_step
from repro_torch.train.optimizer import tree_flatten

from torch_lm_parity import fp32  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 64  # the reference's _batches


@pytest.fixture(scope="module", autouse=True)
def four_ranks():
    """The 2x2 selftest, started with the module."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.shardings", "--selftest"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield make_debug_mesh(1, 1, device_type="cpu")
    dist.destroy_process_group()


def _batch(cfg):
    """The first batch of host 0 of 2 (the reference's ``_batches``), from
    the port's pipeline, and the reference pipeline's for comparison."""
    ds = dict(n_shards=16, tokens_per_shard=BATCH * SEQ * 8, vocab=cfg.vocab)
    port = DataPipeline(ShardedDataset(**ds), make_uniform_cluster(2, device="cpu"), 0,
                        batch_per_host=BATCH, seq_len=SEQ)
    ref = RefPipeline(RefDataset(**ds), ref_cluster(2), 0, batch_per_host=BATCH, seq_len=SEQ)
    return next(port.batches()), next(ref.batches())


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny model (its weights) in both packages."""
    rcfg = japi.reduced_config(ref_config("smollm-135m"))
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
    cfg = reduced_config(get_config("smollm-135m"))
    params = model_params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, cfg, params


def _distribute(mesh, params, opt, batch):
    return (sh.distribute_tree(params, sh.param_shardings(mesh, params)),
            sh.distribute_tree(opt, sh.opt_shardings(mesh, params)),
            sh.distribute_tree(batch, sh.batch_shardings(mesh, batch)))


def test_sharded_train_step_on_debug_mesh_matches_reference(mesh, tiny, fp32):
    rcfg, rparams, cfg, params = tiny
    tokens, ref_tokens = _batch(cfg)
    assert np.array_equal(tokens, ref_tokens)
    ref_step = jax.jit(ref_make_train_step(rcfg, RefAdamW()))
    _, _, ref_metrics = ref_step(rparams, ref_init_train_state(rcfg, rparams),
                                 {"tokens": jnp.asarray(ref_tokens)})
    batch = {"tokens": torch.from_numpy(tokens)}
    with hooks.activation_sharding(sh.activation_constraint_fn(mesh)):
        p, o, b = _distribute(mesh, params, init_train_state(cfg, params), batch)
        _, _, metrics = make_train_step(cfg, AdamWConfig())(p, o, b)
    loss = sh.full_tree(metrics["loss"]).item()
    np.testing.assert_allclose(loss, float(ref_metrics["loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b", "rwkv6-3b"])
def test_one_rank_mesh_equals_the_unsharded_port(mesh, fp32, arch):
    cfg = reduced_config(get_config(arch))
    params = init_params_cpu(cfg)
    tokens = torch.randint(0, cfg.vocab - 1, (BATCH, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    opt = init_train_state(cfg, params)
    adamw = AdamWConfig(**sh.SELFTEST_OPT)  # the update is hundreds of times its tolerance
    want_p, want_o, want_m = make_train_step(cfg, adamw)(params, opt, batch)
    want_logits = make_prefill_step(cfg)(params, batch)
    with hooks.activation_sharding(sh.activation_constraint_fn(mesh)):
        p, o, b = _distribute(mesh, params, opt, batch)
        got_p, got_o, got_m = make_train_step(cfg, adamw)(p, o, b)
        got_logits = make_prefill_step(cfg)(p, b)
    # the vocab-parallel CE sums in its own order: fp32 tolerances, the
    # moments against each leaf's own max, the update by ``hold_update``
    for key in want_m:
        torch.testing.assert_close(sh.full_tree(got_m[key]), want_m[key], rtol=sh.RTOL,
                                   atol=sh.ATOL)
    sh._compare(got_o, {k: want_o[k] for k in ("m", "v")}, arch, scaled=True)
    assert torch.equal(sh.full_tree(got_o["count"]), want_o["count"])
    sh.hold_update(adamw, *(tree_flatten(t)[0] for t in (params, got_p, want_p, opt["m"],
                                                          want_o["m"], want_o["v"])),
                   count=1, what=arch)
    assert torch.equal(sh.full_tree(got_logits), want_logits)


def init_params_cpu(cfg):
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_one_rank_decode_equals_the_unsharded_port(mesh):
    cfg = reduced_config(get_config("smollm-135m"))
    params = init_params_cpu(cfg)
    gen = torch.Generator().manual_seed(2)
    steps = [{"tokens": torch.randint(0, cfg.vocab - 1, (BATCH, 1), generator=gen),
              "positions": torch.full((BATCH, 1), t, dtype=torch.int32)} for t in range(3)]
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, BATCH, 8, device="cpu")
    want = [serve(params, cache, b)[0] for b in steps]
    with hooks.activation_sharding(sh.activation_constraint_fn(mesh)):
        p = sh.distribute_tree(params, sh.serve_param_shardings(mesh, params))
        c = init_cache(cfg, BATCH, 8, device="cpu")
        c = sh.distribute_tree(c, sh.cache_shardings(mesh, cfg, c))
        serve = make_serve_step(cfg)
        for b, w in zip(steps, want):
            b = sh.distribute_tree(b, sh.batch_shardings(mesh, b))
            logits, c = serve(p, c, b)
            assert torch.equal(sh.full_tree(logits), w)
    assert torch.equal(sh.full_tree(c["dense_blocks"]["k"]), cache["dense_blocks"]["k"])


def test_hooks_are_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 8)
    assert hooks.constrain(x) is x and hooks.gather({"w": x})["w"] is x
    assert hooks.split_heads(x, -1, 2) is x and hooks.merge_heads(x, -1, 2) is x
    logits, t = torch.randn(2, 3, 10), torch.randint(0, 10, (2, 3))
    assert torch.equal(hooks.nll(logits, t), torch.logsumexp(logits, -1)
                       - logits.gather(-1, t[..., None])[..., 0])
    buf = torch.zeros(2, 4)
    hooks.ring_write(buf, 1, torch.tensor([2]), torch.ones(2, 1))
    assert buf[:, 2].eq(1).all() and buf.sum() == 2


def test_selftest_on_4_gloo_ranks(four_ranks):
    stdout, stderr = four_ranks.communicate(timeout=600)
    assert four_ranks.returncode == 0, f"selftest failed:\n{stderr[-3000:]}"
    assert "sharded model selftest OK on 4 ranks" in stdout
    assert ("sharded == unsharded for smollm-135m, mixtral-8x22b, deepseek-v2-236b, rwkv6-3b, "
            "mixtral-8x22b with 7 experts" in stdout)


def test_wkv_per_rank_where_the_heads_do_not_divide_the_model_axis(capfd):
    """A 1x3 gloo mesh: RWKV6's 4 heads do not divide the 3-way model
    axis, so each rank runs the WKV on its rows and every head
    (``local_map``); train, prefill and decode equal the unsharded port.
    No ring of this mesh has a sharded sequence, so the ring check is off."""
    from repro_torch.launch.shardings import spawn_selftest

    assert spawn_selftest(1, 3, archs=("rwkv6-3b",), check_ring=False) == 3
    assert "sharded == unsharded for rwkv6-3b" in capfd.readouterr().out


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)], ids=["2x2x1", "2x1x2"])
def test_selftest_on_a_multi_pod_mesh(capfd, data, model):
    """Four gloo ranks on a (pod, data, model) mesh: the batch, the caches
    and the activations live on the batch mesh (``launch.mesh.batch_mesh``,
    "pod" and "data" flattened), every gathered parameter crosses to it
    and its gradient back (``shardings._Remesh``); the train step's update,
    loss, grad norm and moments, prefill, decode and MoE routes of every
    selftest arch equal the unsharded port's, as on the 2x2 mesh.  2x2x1
    holds FSDP over "data" beside "pod"; 2x1x2 holds tensor parallelism
    and the sequence-sharded ring."""
    from repro_torch.launch.shardings import spawn_selftest

    assert spawn_selftest(data, model, pod=2) == 4
    out = capfd.readouterr().out
    assert f"2x{data}x{model} gloo mesh, sharded == unsharded for smollm-135m" in out
    assert "rwkv6-3b" in out
