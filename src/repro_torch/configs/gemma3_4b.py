"""gemma3-4b [dense]  [hf:google/gemma-3-4b-pt; unverified]

34L, d_model=2560, 8H (GQA kv=4, head_dim=256), d_ff=10240, vocab=262144.
5 local : 1 global interleaving (window 1024), qk-norm, RoPE theta 10k local
/ 1M global, gemma-style embed scaling + post-norms: 5 units of (5 local,
1 global) and a suffix of 4 local layers.  Every attention layer's prefill
runs kernel K10 on the card.  FULL and SMOKE as in
``repro.configs.gemma3_4b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    unit=("attn_local",) * 5 + ("attn_global",),
    n_units=5,
    suffix=("attn_local",) * 4,
    activation="geglu",
    local_window=1024,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    qk_norm=True,
    embed_scale=True,
    post_norm=True,
    tie_embeddings=True,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("attn_local",) * 2 + ("attn_global",),
    n_units=2,
    suffix=("attn_local",) * 2,
    activation="geglu",
    local_window=32,
    rope_theta_global=1000000.0,
    qk_norm=True,
    embed_scale=True,
    post_norm=True,
    quadratic=True,
)

register(FULL, SMOKE)
