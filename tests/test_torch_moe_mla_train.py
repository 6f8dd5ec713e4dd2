"""The port's MoE and MLA language models trained, held to the reference
on the CPU (their serving: ``tests/test_torch_moe_mla.py``).

mixtral-8x22b and deepseek-v2-236b at the reference's ``reduced_config``
(2 layers, d_model 128, 8 experts of width 128, top-2), the same weights
in both packages (one draw of the port's ``init_params``), token batches
from NumPy seeds.  fp32 compute (both packages switched to fp32): the
loss, its ce and aux parts and ``global_norm`` at ``rtol=1e-4``, every
gradient leaf and three AdamW updates as ``tests/test_torch_train.py``
holds them; bf16 (the default): the loss, aux and ``global_norm`` at
``rtol=2e-2``, the reference's bf16 tolerance; the remat policies
against each other exactly.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.convert import model_params_from_reference, opt_state_from_reference
from repro_torch.launch import train
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
    fp32,
    reduced_setup,
    tokens,
)

ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: the
    reduced models run thousands of small ops, and under a parallel test
    run the default threads of every worker fight over the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Loss, gradients, AdamW
# ---------------------------------------------------------------------------


def _train_tokens(cfg, n, seed=0):
    """``n`` (4, 64) token batches: 256 tokens, one dispatch group."""
    return [tokens(cfg, (4, 64), seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_in_fp32(fp32, arch):
    """The loss, its ce and aux parts (ce + 0.01 x aux), every gradient
    leaf (experts, router, shared expert, MLA projections) and the global
    norm."""
    jc, jp, c, tp = reduced_setup(arch)
    batch = _train_tokens(c, 1)[0]
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.loss_fn(jc, p, {"tokens": t}), has_aux=True))(jp, jnp.asarray(batch))
    got, aux, grads = _port_value_and_grad(c, tp, {"tokens": torch.from_numpy(batch)})
    _close(got, want)
    _close(aux["ce"], want_aux["ce"])
    _close(aux["aux"], want_aux["aux"])
    assert float(aux["aux"]) > 1.0  # top-2 of 8: the Switch loss sits near 1 per MoE layer
    _close(got, aux["ce"] + 0.01 * aux["aux"], rtol=1e-6)
    _hold_leaves(grads, want_g)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference_in_fp32(fp32, arch):
    """Three steps at lr 1e-2, each port step from the reference's
    parameters and AdamW state before it; the metrics are the reference's
    keys, the loss includes 0.01 x aux, AdamW runs over the (L, E, D, F)
    expert leaves."""
    jc, jp, c, tp = reduced_setup(arch)
    jstep_fn = jax.jit(jstep.make_train_step(jc, jopt.AdamWConfig(**PARITY_OPT)))
    step = make_train_step(c, AdamWConfig(**PARITY_OPT))
    js = jstep.init_train_state(jc, jp)
    params, state = tp, init_train_state(c, tp)
    for i, batch in enumerate(_train_tokens(c, 3, seed=10)):
        jp2, js2, jm = jstep_fn(jp, js, {"tokens": jnp.asarray(batch)})
        new, new_state, m = step(params, state, {"tokens": torch.from_numpy(batch)})
        assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
        for k in m:
            _close(m[k], jm[k])
        _hold_update(params, new, jp, jp2, js, js2)
        if i in (0, 2):
            _hold_state(new_state, js2)
        jp, js = jp2, js2
        params = model_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        state = opt_state_from_reference(jax.tree.map(np.asarray, js), device="cpu")
    assert new["blocks"]["moe"]["w_gate"].dim() == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grad_norm_match_reference(arch):
    jc, jp, c, tp = reduced_setup(arch)
    batch = _train_tokens(c, 1, seed=20)[0]
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.loss_fn(jc, p, {"tokens": t}), has_aux=True))(jp, jnp.asarray(batch))
    got, aux, grads = _port_value_and_grad(c, tp, {"tokens": torch.from_numpy(batch)})
    _close(got, want, rtol=2e-2)
    _close(aux["aux"], want_aux["aux"], rtol=2e-2)
    _close(global_norm(tree_flatten(tp)[1](grads)), jopt.global_norm(want_g), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """"nothing" and "dots" against "everything", exactly; under "dots" the
    expert products (batched, ``aten.bmm``) are among the saved outputs."""
    from torch.utils import checkpoint as ckpt

    _, _, c, tp = reduced_setup(arch)
    tb = {"tokens": torch.from_numpy(_train_tokens(c, 1, seed=30)[0])}
    saved = []
    real = tlm._save_matmuls

    def spy(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if policy == ckpt.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return policy

    try:
        tlm.set_remat_policy("everything")
        want, _, want_g = _port_value_and_grad(c, tp, tb)
        results = {}
        for policy in ("nothing", "dots"):
            tlm.set_remat_policy(policy)
            tlm._save_matmuls = spy
            results[policy] = _port_value_and_grad(c, tp, tb)
    finally:
        tlm._save_matmuls = real
        tlm.set_remat_policy("nothing")
    for got, _, got_g in results.values():
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert torch.ops.aten.bmm.default in saved



# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------


def test_training_cli_runs_both_families():
    """Both MoE families through the training CLI at ``--reduced``: the
    config line is the reference's, the loss is finite and its aux part
    counted (the step's loss is above the plain cross-entropy floor)."""
    for arch in ARCHS:
        argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                "--ckpt-every", "2", "--lr", "1e-3", "--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rep = train.run(argv)
        lines = buf.getvalue().splitlines()
        jc = japi.reduced_config(jconfigs.get_config(arch))
        assert lines[0] == f"arch={jc.name} params~{jc.param_count():.3g}"
        assert len(rep["losses"]) == 4 and all(np.isfinite(rep["losses"]))
        assert rep["manager"].saved_steps == [2] and int(rep["opt_state"]["count"]) == 4
        assert "blocks" in rep["params"] and rep["params"]["blocks"]["moe"]["router"].dim() == 3
