"""internvl2-76b [vlm]  [arXiv:2404.16821; unverified]

LM backbone: 80L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=28672,
vocab=128256 (Llama-3-70B backbone of InternVL2-Llama3-76B).  The InternViT
frontend is a stub: ``num_prefix_embeds`` precomputed patch embeddings at
d_model are prepended to the token sequence (the serving engine passes
zeros).  FULL and SMOKE as in ``repro.configs.internvl2_76b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    unit=("attn_global",),
    n_units=80,
    activation="swiglu",
    rope_theta=500000.0,
    num_prefix_embeds=256,
    tie_embeddings=False,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("attn_global",),
    n_units=3,
    activation="swiglu",
    num_prefix_embeds=8,
    tie_embeddings=False,
    quadratic=True,
)

register(FULL, SMOKE)
