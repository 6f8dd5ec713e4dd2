"""The port's production-mesh dry run (``repro_torch.launch.{op_cost,dryrun,
reanalyze}``) on the CPU.

  * ``op_cost``'s FLOPs equal the reference's loop-aware
    ``hlo_cost.analyze`` on ``tests/test_hlo_cost.py``'s cases: a plain
    matmul, a loop of L products (the reference's scan times its trip
    count), nested loops and the gradient.  The port counts dispatched ops,
    the reference parses compiled HLO; the numbers must agree exactly.
  * Collective bytes by kind, hand-counted, on a fake 4-rank mesh: one
    all-gather, one all-reduce and one reduce-scatter of known shapes.
  * ``run_cell`` on reduced configs on fake 16x16 and 2x16x16 groups:
    status "ok" (or the reference's "skipped" where the shape does not
    apply), every key of the reference's record present, per-device
    argument bytes equal to the sum of local shards under the reference's
    specs, and a per-device reckoning (the product FLOPs of one rank, not
    of the mesh); a multi-pod rank of a batch-sharded cell reckons what a
    16x16 rank does at half the global batch.
  * ``--op-dir`` then ``reanalyze``: the re-derived fields equal the run's.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.launch.hlo_cost import analyze as hlo_analyze
from repro.models import api as japi
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, op_cost, reanalyze
from repro_torch.models import reduced_config

from test_torch_shardings import MESHES, _ref_cell_bytes, bare_ref  # noqa: F401

S = jax.ShapeDtypeStruct
F32 = jnp.float32

# the reference dry run's record keys (lower_s / compile_s become trace_s)
REF_KEYS = ("arch", "shape", "mesh", "status", "flops", "hlo_bytes",
            "collective_bytes_per_device", "collective_by_kind", "trip_unknown",
            "argument_bytes_per_device", "output_bytes_per_device", "temp_bytes_per_device",
            "peak_bytes_per_device", "collectives", "n_devices", "n_microbatches",
            "param_count", "active_param_count")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_flops(fn, *specs):
    return hlo_analyze(jax.jit(fn).lower(*specs).compile().as_text()).flops


def _port_flops(fn, *shapes):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) for s in shapes]
    counter = op_cost.OpCounter()
    with counter:
        fn(*args)
    cost = counter.cost()
    assert cost.collective_bytes == 0 and not cost.trip_unknown
    return cost.flops


def _jbody(x, w):
    return jnp.tanh(x @ w), None


def _loop(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def test_plain_matmul_flops_equal_hlo_cost():
    want = _ref_flops(lambda x, y: x @ y, S((64, 128), F32), S((128, 32), F32))
    assert _port_flops(lambda x, y: x @ y, (64, 128), (128, 32)) == want == 2 * 64 * 128 * 32


@pytest.mark.parametrize("n_layers", [3, 17])
def test_loop_flops_equal_hlo_cost_scan(n_layers):
    want = _ref_flops(lambda x, ws: jax.lax.scan(_jbody, x, ws)[0],
                      S((32, 64), F32), S((n_layers, 64, 64), F32))
    assert _port_flops(_loop, (32, 64), (n_layers, 64, 64)) == want


def test_nested_loop_flops_equal_hlo_cost():
    def outer(x, ws):
        return jax.lax.scan(lambda c, _: (jax.lax.scan(_jbody, c, ws)[0], None), x, None,
                            length=5)[0]

    def nested(x, ws):
        for _ in range(5):
            x = _loop(x, ws)
        return x

    want = _ref_flops(outer, S((32, 64), F32), S((4, 64, 64), F32))
    assert _port_flops(nested, (32, 64), (4, 64, 64)) == want == 2 * 32 * 64 * 64 * 20


def test_gradient_flops_equal_hlo_cost():
    want = _ref_flops(jax.grad(lambda w, x: jnp.sum(jnp.tanh(x @ w))),
                      S((64, 64), F32), S((32, 64), F32))

    def grad(w, x):
        w.requires_grad_()
        return torch.autograd.grad(torch.tanh(x @ w).sum(), w)

    assert _port_flops(grad, (64, 64), (32, 64)) == want


def test_bytes_count_every_materialised_op():
    counter = op_cost.OpCounter()
    with counter:
        a = torch.ones(256, 256)
        b = a @ a
        b.t()  # a view moves nothing
    # ones writes 256 KiB; the product reads two and writes one
    assert counter.cost().bytes == 4 * 256 * 256 * 4
    assert counter.peak_bytes == 2 * 256 * 256 * 4


@pytest.fixture
def fake_4():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    dist.destroy_process_group()


def test_collective_bytes_by_kind_hand_counted(fake_4):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    local = torch.randn(8, 16)  # fp32: a (32, 16) tensor sharded 4 ways
    counter = op_cost.OpCounter()
    with counter:
        DTensor.from_local(local, fake_4, [Shard(0)], run_check=False).redistribute(
            fake_4, [Replicate()]).to_local()
        DTensor.from_local(local, fake_4, [Partial()], run_check=False).redistribute(
            fake_4, [Replicate()]).to_local()
        DTensor.from_local(local, fake_4, [Partial()], run_check=False).redistribute(
            fake_4, [Shard(0)]).to_local()
    cost = counter.cost()
    assert cost.collective_by_kind == {"all-gather": 32 * 16 * 4, "all-reduce": 8 * 16 * 4,
                                       "reduce-scatter": 2 * 16 * 4}
    assert cost.collective_counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert cost.collective_bytes == sum(cost.collective_by_kind.values())


# ---------------------------------------------------------------------------
# run_cell on reduced configs
# ---------------------------------------------------------------------------

CELLS = [
    ("smollm-135m", "train_4k", False), ("smollm-135m", "prefill_32k", False),
    ("smollm-135m", "decode_32k", False), ("smollm-135m", "long_500k", False),
    ("smollm-135m", "decode_32k", True), ("smollm-135m", "train_4k", True),
    ("rwkv6-3b", "train_4k", False), ("rwkv6-3b", "prefill_32k", False),
    ("rwkv6-3b", "decode_32k", False), ("rwkv6-3b", "long_500k", False),
    ("rwkv6-3b", "decode_32k", True), ("rwkv6-3b", "long_500k", True),
    ("rwkv6-3b", "prefill_32k", True), ("rwkv6-3b", "train_4k", True),
]


@functools.cache
def _cell(arch, shape, multi_pod, half_batch=False):
    """One reduced cell's record, traced once per file: the multi-pod
    comparison below reads the cells CELLS has already run."""
    with pytest.MonkeyPatch.context() as mp:
        if half_batch:
            spec = dryrun.SHAPES[shape]
            mp.setitem(dryrun.SHAPES, shape,
                       dataclasses.replace(spec, global_batch=spec.global_batch // 2))
        return dryrun.run_cell(arch, shape, multi_pod=multi_pod, reduced=True,
                               verbose=False, serve_tp_only=True)  # the CLI's default


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_on_reduced_configs(arch, shape, multi_pod, bare_ref):
    r = _cell(arch, shape, multi_pod)
    cfg = reduced_config(get_config(arch))
    if shape == "long_500k" and not cfg.subquadratic:
        assert r["status"] == "skipped" and "500k" in r["reason"]
        return
    assert r["status"] == "ok"
    assert all(k in r for k in REF_KEYS), [k for k in REF_KEYS if k not in r]
    assert r["n_devices"] == (512 if multi_pod else 256)
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    mesh = MESHES["2x16x16" if multi_pod else "16x16"]
    spec = SHAPES[shape]
    want = _ref_cell_bytes(bare_ref, mesh, japi.reduced_config(ref_config(arch)), spec)
    assert r["argument_bytes_per_device"] == want
    assert r["peak_bytes_per_device"] >= r["argument_bytes_per_device"]
    assert r["temp_bytes_per_device"] >= 0 and r["output_bytes_per_device"] > 0
    assert r["flops"] > 0 and r["hlo_bytes"] > 0
    assert r["collective_bytes_per_device"] == sum(r["collective_by_kind"].values())
    assert r["param_count"] == cfg.param_count()


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("rwkv6-3b", "prefill_32k"), ("rwkv6-3b", "train_4k"),
])
def test_multi_pod_rank_reckons_a_16x16_rank_at_half_the_batch(arch, shape):
    """The batch lives on the batch mesh, whose first axis is ("pod",
    "data") flattened (``launch.mesh.batch_mesh``), so a rank of the
    2x16x16 mesh holds one plain 32-way shard of the batch and runs the
    same per-device step as a rank of the 16x16 mesh at half the global
    batch: the same rows, the same parameter shards (FSDP over "data"
    alone), the same FLOPs.  Against the 16x16 cell at the full batch that
    is half the FLOPs where DTensor's plan does not depend on the rows a
    rank holds (prefill); in training, at 16 rows a rank, DTensor splits
    some weight-gradient products one row a device over "model" as well,
    which 8 rows cannot do whole, so there the multi-pod rank does a
    little more than half."""
    mp, sp = _cell(arch, shape, True), _cell(arch, shape, False)
    half = _cell(arch, shape, False, half_batch=True)
    assert mp["status"] == "ok" and mp["n_devices"] == 512 and mp["mesh"] == "2x16x16"
    for key in ("flops", "argument_bytes_per_device", "output_bytes_per_device"):
        assert mp[key] == half[key], key
    if SHAPES[shape].kind == "prefill":
        assert 2 * mp["flops"] == sp["flops"]
    else:
        assert sp["flops"] < 2 * mp["flops"] < 1.15 * sp["flops"]


# A training step's collective bytes on the 2x16x16 mesh less those of a
# 16x16 rank at half the batch, by kind (measured on the reduced cells;
# see the test below for where they come from)
TRAIN_GRADIENT_PLAN_DELTA = {
    "smollm-135m": {"all-gather": 0, "all-reduce": 10_240 - 16_384, "reduce-scatter": 0},
    "rwkv6-3b": {"all-gather": 1_024 - 3_072, "all-reduce": 678_912 - 1_673_344,
                 "reduce-scatter": 0},
}


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("rwkv6-3b", "prefill_32k"), ("rwkv6-3b", "train_4k"),
])
def test_multi_pod_rank_holds_and_moves_what_a_16x16_rank_does_at_half_the_batch(arch, shape):
    """The embedding looks up only the rank's rows (ROADMAP C4: it used to
    look up the whole global batch and all-reduce it), so a rank of the
    2x16x16 mesh holds at its peak what a 16x16 rank holds at half the
    global batch, byte for byte, and in prefill moves the same collective
    bytes of every kind.  Training settles the gradients by two plans:
    the multi-pod rank sums each gradient into its shards over "data"
    inside ``shardings._Remesh`` and then over "pod" (smollm-135m: 23
    fp32 all-reduces, 10,240 B; rwkv6-3b: 76, 678,912 B, and two
    all-gathers of 1,024 B), while DTensor's plan on one pod leaves some
    shards partial over "model" and all-reduces them before the gradient
    norm (16 of 16,384 B; 80 of 1,673,344 B, and three all-gathers of
    3,072 B).  Every other collective of the step is the same, so each
    kind differs from the 16x16 rank's by exactly those bytes
    (``TRAIN_GRADIENT_PLAN_DELTA``): no kind may grow, and the sum over
    "pod" may not go missing."""
    mp, half = _cell(arch, shape, True), _cell(arch, shape, False, half_batch=True)
    assert mp["peak_bytes_per_device"] == half["peak_bytes_per_device"]
    assert mp["temp_bytes_per_device"] == half["temp_bytes_per_device"]
    if SHAPES[shape].kind == "prefill":
        assert mp["collective_by_kind"] == half["collective_by_kind"]
        return
    delta = {kind: half["collective_by_kind"].get(kind, 0) + d
             for kind, d in TRAIN_GRADIENT_PLAN_DELTA[arch].items()}
    assert mp["collective_by_kind"] == delta


def test_multi_pod_prefill_reduces_no_whole_batch_embedding():
    """ROADMAP C4's minimal input, ``dryrun --arch rwkv6-3b --shape
    prefill_32k --reduced --multi-pod``: its all-reduces were 285.2 MB, of
    them 268.4 MB the whole (32, 32,768, 128) bf16 embedding, and its peak
    809,926,144 B.  With each rank looking up its own rows no all-reduce
    carries that tensor: each rank sums over "model" only its 1 / 32 of
    it."""
    r = _cell("rwkv6-3b", "prefill_32k", True)
    spec = SHAPES["prefill_32k"]
    cfg = reduced_config(get_config("rwkv6-3b"))
    whole = spec.global_batch * spec.seq_len * cfg.d_model * 2  # bf16
    assert whole == 268_435_456
    assert r["collective_by_kind"]["all-reduce"] < whole


def test_run_cell_counts_one_device_not_the_mesh():
    """A decode step is per-row work: twice the data ranks (2x16x16 against
    16x16, the same model axis) halve every rank's rows and FLOPs and
    shrink its collectives and peak; a count over the whole mesh would
    double instead."""
    sp, mp = (dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=m, reduced=True,
                              verbose=False) for m in (False, True))
    assert mp["flops"] * 2 == sp["flops"] > 0
    assert mp["collective_bytes_per_device"] < sp["collective_bytes_per_device"]
    assert mp["peak_bytes_per_device"] < sp["peak_bytes_per_device"]


def test_op_dir_and_reanalyze_round_trip(tmp_path):
    cells = [dryrun.run_cell("smollm-135m", "decode_32k", reduced=True, verbose=False,
                             op_dir=str(tmp_path))]
    path = tmp_path / "cells.json"
    path.write_text(json.dumps(cells, default=float))
    assert reanalyze.main(str(path), str(tmp_path), "sp") == 0
    again = json.loads(path.read_text())[0]
    for key in ("flops", "hlo_bytes", "collective_bytes_per_device", "collective_by_kind",
                "trip_unknown", "collectives"):
        assert again[key] == json.loads(json.dumps(cells[0][key], default=float)), key


def test_dryrun_cli_on_a_reduced_cell(tmp_path, capsys):
    out = tmp_path / "one.json"
    rc = dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--reduced",
                      "--out", str(out)])
    assert rc == 0
    cells = json.loads(out.read_text())
    assert len(cells) == 1 and cells[0]["status"] == "ok"
    assert "1 cells: 0 failed" in capsys.readouterr().out


def test_dry_run_refuses_a_group_that_is_already_up(fake_4):
    with pytest.raises(RuntimeError, match="already initialized"):
        dryrun.run_cell("smollm-135m", "decode_32k", reduced=True, verbose=False)
