"""mixtral-8x22b [MoE 8e top-2, SWA] — arXiv:2401.04088.

Sliding-window attention (window 4096) bounds decode cache and attention
compute, so the long_500k cell runs with a window-clamped ring cache.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="lm",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    attn_kind="swa",
    window=4096,
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        d_ff_expert=16384,
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
    subquadratic=True,  # SWA: cache and compute bounded by the window
)


def get_config() -> ModelConfig:
    return CONFIG
