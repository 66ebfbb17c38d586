"""moonshot-v1-16b-a3b [moe]  [hf:moonshotai/Moonlight-16B-A3B; hf]

48L, d_model=2048, 16H (GQA kv=16, head_dim=128), vocab=163840.
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, sigmoid router
(DeepSeek-V3-style aux-free); first layer dense (d_ff=11264, per the HF
config of Moonlight); untied embeddings.  FULL and SMOKE as in
``repro.configs.moonshot_v1_16b_a3b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,                # dense stem layer width
    vocab_size=163840,
    prefix=("gqa_dense",),
    unit=("gqa_moe",),
    n_units=47,
    activation="swiglu",
    n_experts=64,
    moe_top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    capacity_factor=1.25,
    router_type="sigmoid",
    rope_theta=50000.0,
    tie_embeddings=False,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    prefix=("gqa_dense",),
    unit=("gqa_moe",),
    n_units=2,
    activation="swiglu",
    n_experts=8,
    moe_top_k=2,
    n_shared_experts=1,
    moe_d_ff=64,
    router_type="sigmoid",
    tie_embeddings=False,
    quadratic=True,
)

register(FULL, SMOKE)
