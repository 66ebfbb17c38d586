"""recurrentgemma-2b [hybrid]  [arXiv:2402.19427; hf]

26L, d_model=2560, 10H (MQA kv=1, head_dim=256), d_ff=7680, vocab=256000.
Griffin pattern (rec, rec, local-attn) x8 + (rec, rec); RG-LRU width 2560,
temporal conv width 4, local window 2048.  The RG-LRU recurrence runs on
the linear_recurrence primitive (AFFINE operator, channel layout): kernel
K6 on the card.  FULL and SMOKE as in ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    unit=("rglru", "rglru", "attn_local"),
    n_units=8,
    suffix=("rglru", "rglru"),
    activation="geglu",
    local_window=2048,
    rnn_width=2560,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
    quadratic=False,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("rglru", "rglru", "attn_local"),
    n_units=1,
    suffix=("rglru", "rglru"),
    activation="geglu",
    local_window=32,
    rnn_width=64,
    conv_width=4,
    embed_scale=True,
    quadratic=False,
)

register(FULL, SMOKE)
