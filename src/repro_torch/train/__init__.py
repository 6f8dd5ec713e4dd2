"""Optimizer and step factories of the port: training, serving and
prefill (the reference's ``repro.train``)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .step import (
    bf16_working_copy,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "init_train_state",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]
