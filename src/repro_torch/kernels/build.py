"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The output lands in ``kernels/_build/`` (listed in ``.gitignore``), named
by a hash of the source, of every header it includes from ``csrc/`` (the
shared ``hash.cuh``) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.  A failed build
raises with the compiler's output; nothing falls back.  ``-Xptxas -v``'s
report (registers, stack frame and spill bytes per kernel) is kept beside
each library and read back by ``ptxas_report``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("asura_place", "baselines", "hierarchy", "traffic", "serve")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes with ``#include
    "..."`` from ``csrc/``, transitively, in first-seen order."""
    files = [CSRC / f"{name}.cu"]
    for path in files:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists() and dep not in files:
                files.append(dep)
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source not yet built, all ``nvcc`` processes at once.

    Returns ``{name: {"path", "seconds", "log"}}`` for what was compiled
    (``log`` holds ``-Xptxas -v``'s register and spill report, also kept
    beside the library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    built = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        built[name] = {
            "path": str(out), "seconds": time.perf_counter() - t0, "log": log,
        }
    return built


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed)."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> dict:
    """``-Xptxas -v`` output -> ``{mangled kernel: {"registers", "stack",
    "spill_stores", "spill_loads"}}`` for every entry function."""
    kernels: dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            kernels.setdefault(entry, {})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _FRAME.search(line)) and props in kernels:
            kernels[props].update(zip(("stack", "spill_stores", "spill_loads"),
                                      map(int, m.groups())))
        elif (m := _REGS.search(line)) and entry is not None:
            kernels[entry]["registers"] = int(m.group(1))
    return kernels


def ptxas_report(name: str) -> dict:
    """``parse_ptxas`` of the kept build log of ``csrc/<name>.cu`` (built
    first if needed; empty for a library built without one)."""
    build_all((name,))
    log = library_path(name).with_suffix(".log")
    return parse_ptxas(log.read_text()) if log.exists() else {}
