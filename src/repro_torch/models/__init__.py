"""Model zoo of the port: configs, layers and the functional model API,
served and trained for every family the reference runs (dense, MoE and
MLA language models, the RG-LRU hybrid, RWKV6 and the encoder-decoder)."""

from .api import (
    LanguageModel,
    cache_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    input_specs,
    loss_fn,
    make_inputs,
    param_specs,
    prefill,
    reduced_config,
)
from .config import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeSpec, shape_applicable

__all__ = [
    "SHAPES",
    "LanguageModel",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeSpec",
    "cache_specs",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "input_specs",
    "loss_fn",
    "make_inputs",
    "param_specs",
    "prefill",
    "reduced_config",
    "shape_applicable",
]
