"""Model/shape configuration for the assigned architecture pool.

The port's own copy of the reference's ``repro.models.config``, field for
field (plain Python: no torch, no jax), so that the two packages agree on
every configuration, parameter count and shape cell.

One ``ModelConfig`` covers every family (dense GQA, enc-dec, MLA+MoE,
SWA+MoE, VLM, RG-LRU hybrid, RWKV6) via feature fields; ``family`` selects
the forward implementation.  ``ShapeSpec`` enumerates the assigned input
shapes; decode shapes lower ``serve_step`` (single token + KV cache), not
``train_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["lm", "encdec", "rglru", "rwkv6"]
AttnKind = Literal["full", "swa", "local"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    attn_kind: AttnKind = "full"
    window: int = 0  # swa / local attention window
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    n_dense_layers: int = 0  # leading dense layers before MoE layers
    # hybrid (recurrentgemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    # rwkv6
    rwkv_head_dim: int = 64
    # enc-dec
    n_enc_layers: int = 0
    enc_seq: int = 0  # stub frontend sequence length (audio frames / patches)
    # vlm: number of prefix patch embeddings from the (stub) vision tower
    vision_prefix: int = 0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # long_500k applicability: True iff memory/compute are sub-quadratic in
    # context (SSM / hybrid-local / sliding-window); see DESIGN.md section 4.
    subquadratic: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        total += self._block_params()
        if self.family == "encdec":
            total += self.enc_seq * d  # encoder positional table
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        total += self._block_params(active_only=True)
        return total

    def _block_params(self, active_only: bool = False) -> int:
        d = self.d_model
        hd = self.head_dim_
        n_moe_layers = max(self.n_layers - self.n_dense_layers, 0) if self.moe else 0
        n_dense = self.n_layers - n_moe_layers
        total = 0
        # attention / mixer params per layer
        if self.family == "rwkv6":
            per_mix = 4 * d * d + 6 * d * 32 * 2  # r,k,v,o + lora decay/mix
        elif self.mla is not None:
            m = self.mla
            per_mix = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            per_mix = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "rglru":
            # mixer params vary by block type; approximate with the mean
            n_rec = sum(1 for b in self.block_pattern if b == "rec")
            n_att = len(self.block_pattern) - n_rec
            w = self.lru_width or d
            per_rec = 2 * d * w + w * d + 4 * w  # in-proj x2, out-proj, gates
            per_mix = (per_rec * n_rec + per_mix * n_att) / max(
                len(self.block_pattern), 1
            )
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        per_dense_mlp = mlp_mult * d * self.d_ff
        total += self.n_layers * per_mix + n_dense * per_dense_mlp
        if self.moe:
            e_all = self.moe.top_k if active_only else self.moe.n_experts
            per_moe = (
                e_all * mlp_mult * d * self.moe.d_ff_expert
                + self.moe.n_shared * mlp_mult * d * self.moe.d_ff_shared
                + d * self.moe.n_experts  # router
            )
            total += n_moe_layers * per_moe
        if self.family == "encdec":
            # encoder blocks + decoder cross-attention
            total += self.n_enc_layers * (per_mix + per_dense_mlp)
            total += self.n_layers * per_mix  # cross-attn per decoder layer
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, spec: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason recorded when skipped."""
    if spec.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "full-attention arch: 500k context needs sub-quadratic attention "
            "(DESIGN.md section 4)"
        )
    return True, ""
