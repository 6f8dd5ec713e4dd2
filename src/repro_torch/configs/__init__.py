"""Assigned architecture registry of the port: ``get_config("<arch-id>")``.

The same ten configurations as the reference's registry, as data.  Every
architecture answers here; the families the port cannot run yet are
refused later, by ``models.init_params``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, shape_applicable

ARCHS: tuple[str, ...] = (
    "granite-3-2b",
    "command-r-35b",
    "deepseek-7b",
    "smollm-135m",
    "whisper-large-v3",
    "deepseek-v2-236b",
    "mixtral-8x22b",
    "internvl2-26b",
    "recurrentgemma-9b",
    "rwkv6-3b",
)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    module = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}"
    )
    return module.get_config()


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for spec in SHAPES.values():
            ok, reason = shape_applicable(cfg, spec)
            yield arch, spec, ok, reason


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "all_cells", "shape_applicable"]
