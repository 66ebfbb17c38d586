"""deepseek-v3-671b [moe]  [arXiv:2412.19437; hf]

61L, d_model=7168, 128H MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), vocab=129280.  First 3 layers dense (d_ff=18432); 58 MoE layers with
1 shared + 256 routed experts, top-8, sigmoid (aux-loss-free) router,
expert d_ff=2048.  Depth-1 multi-token prediction head.  FULL and SMOKE as
in ``repro.configs.deepseek_v3_671b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab_size=129280,
    prefix=("mla_dense",) * 3,
    unit=("mla_moe",),
    n_units=58,
    activation="swiglu",
    n_experts=256,
    moe_top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    capacity_factor=1.25,
    router_type="sigmoid",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    tie_embeddings=False,
    quadratic=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    prefix=("mla_dense",),
    unit=("mla_moe",),
    n_units=2,
    activation="swiglu",
    n_experts=8,
    moe_top_k=2,
    n_shared_experts=1,
    moe_d_ff=64,
    router_type="sigmoid",
    use_mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    mtp_depth=1,
    tie_embeddings=False,
    quadratic=True,
)

register(FULL, SMOKE)
