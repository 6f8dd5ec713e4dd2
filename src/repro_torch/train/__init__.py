"""Step factories of the port: serving and prefill (training comes with
ROADMAP A9b)."""

from .step import bf16_working_copy, make_prefill_step, make_serve_step

__all__ = ["bf16_working_copy", "make_prefill_step", "make_serve_step"]
