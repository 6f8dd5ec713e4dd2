"""Public model API of the port: reduced (smoke) configs and shape trees."""

from __future__ import annotations

import dataclasses

from . import lm
from .config import MLAConfig, ModelConfig, MoEConfig

init_params = lm.init_params
param_specs = lm.param_specs
prefill = lm.prefill
decode_step = lm.decode_step
init_cache = lm.init_cache
forward = lm.forward
LanguageModel = lm.LanguageModel


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree's shapes and dtypes, on the meta device."""
    return lm.init_cache(cfg, batch, max_len, device="meta")


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/feature set, tiny dims -- one CPU forward/train step."""
    changes: dict = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        rwkv_head_dim=32,
    )
    if cfg.family == "rglru":
        changes["n_layers"] = len(cfg.block_pattern) + 1  # pattern + tail
        changes["lru_width"] = 128
        changes["window"] = 16
    elif cfg.family == "encdec":
        changes["n_layers"] = 2
        changes["n_enc_layers"] = 2
        changes["enc_seq"] = 16
    else:
        changes["n_layers"] = 2
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128,
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_shared=128,
        )
        changes["n_dense_layers"] = min(cfg.n_dense_layers, 1)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
            v_head_dim=32,
        )
    if cfg.attn_kind == "swa":
        changes["window"] = 16
    if cfg.vision_prefix:
        changes["vision_prefix"] = 8
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
