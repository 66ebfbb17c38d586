"""minitron-4b [dense]  [arXiv:2407.14679; hf]

32L, d_model=3072, 24H (GQA kv=8, head_dim=128), d_ff=9216, vocab=256000.
Pruned nemotron: squared-ReLU MLP (no gating), untied embeddings.  FULL
and SMOKE as in ``repro.configs.minitron_4b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    unit=("attn_global",),
    n_units=32,
    activation="relu2",
    tie_embeddings=False,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    unit=("attn_global",),
    n_units=3,
    activation="relu2",
    tie_embeddings=False,
    quadratic=True,
)

register(FULL, SMOKE)
