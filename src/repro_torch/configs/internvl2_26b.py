"""internvl2-26b [VLM: InternViT stub + InternLM2-20b backbone] — arXiv:2404.16821.

The vision tower is a STUB: ``input_specs()`` supplies 256 precomputed patch
embeddings (already projected to d_model) prepended to the text sequence
(DESIGN.md section 4).  Assigned sequence shapes apply to the text tokens.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="lm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    attn_kind="full",
    vision_prefix=256,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
)


def get_config() -> ModelConfig:
    return CONFIG
