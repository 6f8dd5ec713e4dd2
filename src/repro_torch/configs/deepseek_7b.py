"""deepseek-7b [dense, llama-arch, MHA] — arXiv:2401.02954."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="lm",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,  # GQA kv=32 == MHA
    d_ff=11008,
    vocab=102400,
    head_dim=128,
    attn_kind="full",
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
)


def get_config() -> ModelConfig:
    return CONFIG
