"""seamless-m4t-medium [audio, enc-dec]  [arXiv:2308.11596; hf]

12L decoder + 12L speech-encoder, d_model=1024, 16H (GQA kv=16, hd=64),
d_ff=4096, vocab=256206.  The modality frontend (w2v-BERT conformer feature
extractor) is a stub: the encoder takes precomputed frame embeddings at
d_model.  FULL and SMOKE as in ``repro.configs.seamless_m4t_medium``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    unit=("dec_attn",),
    n_units=12,
    activation="relu",
    is_encdec=True,
    n_enc_layers=12,
    audio_frontend=True,
    tie_embeddings=True,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("dec_attn",),
    n_units=2,
    activation="relu",
    is_encdec=True,
    n_enc_layers=2,
    audio_frontend=True,
    quadratic=True,
)

register(FULL, SMOKE)
