"""command-r-35b [dense GQA, no-bias] — hf:CohereForAI/c4ai-command-r-v01."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="lm",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    attn_kind="full",
    norm="layernorm",
    act="swiglu",
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)


def get_config() -> ModelConfig:
    return CONFIG
