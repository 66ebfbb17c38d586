"""gemma2-27b [dense]  [arXiv:2408.00118; hf]

46L, d_model=4608, 32H (GQA kv=16, head_dim=128), d_ff=36864, vocab=256000.
Alternating local(4096)/global attention, attn softcap 50, final logit
softcap 30, gemma post-norms + embed scaling.  Every attention layer's
prefill runs kernel K10 on the card.  FULL and SMOKE as in
``repro.configs.gemma2_27b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    unit=("attn_local", "attn_global"),
    n_units=23,
    activation="geglu",
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    post_norm=True,
    tie_embeddings=True,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("attn_local", "attn_global"),
    n_units=2,
    activation="geglu",
    local_window=32,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    post_norm=True,
    quadratic=True,
)

register(FULL, SMOKE)
