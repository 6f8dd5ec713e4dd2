"""deepseek-v2-236b [MLA + MoE 160e top-6 + 2 shared] — arXiv:2405.04434.

MLA: kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_head=128.
Layer 0 is a dense FFN (d_ff=12288); layers 1..59 are MoE with expert
d_ff=1536, 2 shared experts, top-6 routing of 160 experts.
"""

from repro_torch.models.config import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="lm",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # the dense layer's FFN
    vocab=102400,
    head_dim=192,  # qk_nope + qk_rope (for bookkeeping; MLA dims rule)
    attn_kind="full",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared=2,
        d_ff_shared=1536,
        capacity_factor=1.25,
    ),
    n_dense_layers=1,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
)


def get_config() -> ModelConfig:
    return CONFIG
