"""Public model API of the port: input specs, reduced (smoke) configs and
shape trees."""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import layers, lm
from .config import MLAConfig, ModelConfig, MoEConfig, ShapeSpec

init_params = lm.init_params
param_specs = lm.param_specs
loss_fn = lm.loss_fn
prefill = lm.prefill
decode_step = lm.decode_step
init_cache = lm.init_cache
forward = lm.forward
LanguageModel = lm.LanguageModel


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree's shapes and dtypes, on the meta device."""
    return lm.init_cache(cfg, batch, max_len, device="meta")


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input of a shape cell (the
    reference's keys): train / prefill cells {"batch": {"tokens"} plus
    "frames" (encdec) or "patches" (VLM)}; decode cells {"batch":
    {"tokens", "positions"}, "cache"} with the cache at the cell's
    seq_len."""
    b, s = spec.global_batch, spec.seq_len
    meta = torch.device("meta")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=meta)

    if spec.kind in ("train", "prefill"):
        batch = {"tokens": empty((b, s), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = empty((b, cfg.enc_seq, cfg.d_model), layers.COMPUTE_DTYPE)
        if cfg.vision_prefix:
            batch["patches"] = empty((b, cfg.vision_prefix, cfg.d_model), layers.COMPUTE_DTYPE)
        return {"batch": batch}
    batch = {"tokens": empty((b, 1), torch.int32), "positions": empty((b, 1), torch.int32)}
    return {"batch": batch, "cache": cache_specs(cfg, b, s)}


def make_inputs(cfg: ModelConfig, spec: ShapeSpec, generator: torch.Generator,
                device=None) -> dict:
    """Concrete (small-scale) inputs matching ``input_specs`` on ``device``
    (None: the CUDA card): tokens drawn from ``generator`` in [0, vocab -
    1), float inputs zero; a decode cell gets a fresh cache and positions
    ``seq_len - 1``.  The tokens differ from the reference's
    ``jax.random`` draw."""
    dev = resolve_device(device)
    batch = {
        name: torch.randint(0, max(cfg.vocab - 1, 2), t.shape, generator=generator,
                            dtype=t.dtype, device=generator.device).to(dev)
        if not t.is_floating_point() else torch.zeros(t.shape, dtype=t.dtype, device=dev)
        for name, t in input_specs(cfg, spec)["batch"].items()
    }
    out = {"batch": batch}
    if spec.kind == "decode":
        out["cache"] = lm.init_cache(cfg, spec.global_batch, spec.seq_len, device=dev)
        batch["positions"] = torch.full((spec.global_batch, 1), spec.seq_len - 1,
                                        dtype=torch.int32, device=dev)
    return out


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
