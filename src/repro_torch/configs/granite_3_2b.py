"""granite-3-2b [dense GQA] — hf:ibm-granite/granite-3.0-2b-base."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="lm",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    head_dim=64,
    attn_kind="full",
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def get_config() -> ModelConfig:
    return CONFIG
