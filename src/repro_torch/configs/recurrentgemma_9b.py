"""recurrentgemma-9b [hybrid RG-LRU + local attention, 2:1] — arXiv:2402.19427.

Block pattern (rec, rec, attn) repeating; 38 layers = 12 super-blocks + 2
trailing recurrent layers.  Local attention window 2048, MQA (kv=1).
Constant-size recurrent state + windowed cache -> long_500k runs.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="rglru",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    attn_kind="local",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    norm="rmsnorm",
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
)


def get_config() -> ModelConfig:
    return CONFIG
