"""rwkv6-3b [Finch: attention-free, data-dependent decay] — arXiv:2404.05892.

Constant-size WKV matrix state -> long_500k runs.  Head dim 64 (40 heads).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    rwkv_head_dim=64,
    norm="layernorm",
    act="swiglu",
    subquadratic=True,
)


def get_config() -> ModelConfig:
    return CONFIG
