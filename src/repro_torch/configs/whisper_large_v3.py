"""whisper-large-v3 [audio enc-dec backbone] — arXiv:2212.04356.

The conv/audio frontend is a STUB: ``input_specs()`` supplies precomputed
1280-d frame embeddings (1500 frames) to the encoder (DESIGN.md section 4).
Assigned sequence shapes apply to the decoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,  # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,  # MHA
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    attn_kind="full",
    norm="layernorm",
    act="gelu",
    enc_seq=1500,
)


def get_config() -> ModelConfig:
    return CONFIG
