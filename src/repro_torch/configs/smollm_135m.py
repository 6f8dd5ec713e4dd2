"""smollm-135m [dense, llama-arch small] — hf:HuggingFaceTB/SmolLM-135M."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="lm",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    head_dim=64,
    attn_kind="full",
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def get_config() -> ModelConfig:
    return CONFIG
