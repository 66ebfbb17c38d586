"""deepseek-coder-33b [dense]  [arXiv:2401.14196; hf]

62L, d_model=7168, 56H (GQA kv=8, head_dim=128), d_ff=19200, vocab=32256.
Llama-architecture: SwiGLU, RoPE theta 100000, untied embeddings.  FULL
and SMOKE as in ``repro.configs.deepseek_coder_33b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    unit=("attn_global",),
    n_units=62,
    activation="swiglu",
    rope_theta=100000.0,
    tie_embeddings=False,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    unit=("attn_global",),
    n_units=3,
    activation="swiglu",
    rope_theta=100000.0,
    tie_embeddings=False,
    quadratic=True,
)

register(FULL, SMOKE)
