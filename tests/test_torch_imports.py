"""The port stands alone: it imports torch and numpy, never jax and never
the reference package, and its chip smoke script refuses to run without a
card or without the package beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# ``import jax`` / ``from jax...`` and any import of the reference package
# (``repro`` but not ``repro_torch``)
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(?!_torch)\b"
    r"|from\s+repro(?!_torch)\b)",
    re.MULTILINE,
)


def _run(code_or_args, cwd=ROOT, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_import_loads_neither_jax_nor_the_reference():
    proc = _run(
        "import sys, repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.kernels.ops, repro_torch.kernels.build, repro_torch.obs, "
        "repro_torch.serve, repro_torch.migrate, repro_torch.migrate.live, "
        "repro_torch.kernels.baselines, repro_torch.kernels.baselines_ref, "
        "repro_torch.core.consistent_hashing, repro_torch.core.random_slicing, "
        "repro_torch.core.wrh, repro_torch.core.straw, repro_torch.core.hierarchy, "
        "repro_torch.kernels.hierarchy, repro_torch.kernels.hierarchy_ref\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_consumer_imports_load_neither_jax_nor_the_reference():
    proc = _run(
        "import sys, repro_torch.runtime, repro_torch.data, repro_torch.checkpoint, "
        "repro_torch.runtime.durability, repro_torch.runtime.elastic, "
        "repro_torch.checkpoint.sharded, repro_torch.data.pipeline\n"
        "assert repro_torch.runtime.__all__ and repro_torch.data.__all__ "
        "and repro_torch.checkpoint.__all__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_mesh_import_loads_neither_jax_nor_the_reference():
    proc = _run(
        "import sys, repro_torch.launch.placement_mesh as pm\n"
        "assert pm.DATA_AXIS == 'data' and callable(pm.make_data_mesh)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_model_imports_load_neither_jax_nor_the_reference():
    proc = _run(
        "import sys, repro_torch.models, repro_torch.configs, repro_torch.train, "
        "repro_torch.launch.serve, repro_torch.train.optimizer, repro_torch.launch.train\n"
        "assert repro_torch.models.__all__ and repro_torch.train.__all__\n"
        "assert callable(repro_torch.launch.train.run) and "
        "callable(repro_torch.train.optimizer.adamw_update)\n"
        "assert len(repro_torch.configs.ARCHS) == 10\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_sharded_model_imports_load_neither_jax_nor_the_reference():
    proc = _run(
        "import sys, repro_torch.launch.mesh as m, repro_torch.launch.shardings as s, "
        "repro_torch.launch.op_cost as c, repro_torch.launch.dryrun as d, "
        "repro_torch.launch.reanalyze as r, repro_torch.models.hooks as h\n"
        "assert callable(m.make_production_mesh) and callable(s.param_pspec)\n"
        "assert callable(c.analyze) and callable(d.run_cell) and callable(r.main)\n"
        "assert h.constrain is not None and h._PLACEMENT is None\n"
        "bad = sorted(x for x in sys.modules if x == 'jax' or x.startswith('jax.')"
        " or x == 'repro' or x.startswith('repro.'))\n"
        "print(bad)"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"

def test_consumer_packages_export_the_reference_names():
    import repro.checkpoint
    import repro.data
    import repro.runtime
    import repro.train
    import repro_torch.checkpoint
    import repro_torch.data
    import repro_torch.runtime
    import repro_torch.train

    for ref, port in ((repro.runtime, repro_torch.runtime), (repro.data, repro_torch.data),
                      (repro.checkpoint, repro_torch.checkpoint),
                      (repro.train, repro_torch.train)):
        assert port.__all__ == ref.__all__
        assert all(hasattr(port, name) for name in port.__all__)


def test_no_port_file_imports_jax_or_the_reference():
    files = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 10
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from repro.core import Cluster")
    assert _FORBIDDEN.search("    import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import Cluster")


def test_chip_smoke_exits_nonzero_without_a_card():
    proc = _run([str(ROOT / "chip_smoke.py")], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                env_extra={"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
