"""xlstm-1.3b [ssm]  [arXiv:2405.04517; unverified]

48L, d_model=2048, 4 heads, vocab=50304, d_ff=0 (mixers carry their own
up/down projections).  7:1 mLSTM:sLSTM interleave -- 6 units of
(mlstm x7, slstm x1).  The mLSTM's stabilizer runs on ``scan`` with the
non-commutative MAXPLUS_AFFINE operator and its inter-chunk states on
``linear_recurrence``: kernel K6 on the card (its long-T path for the
stabilizer of a long prompt).  The sLSTM's gates read h_{t-1}, so it runs
as a loop over time.  FULL and SMOKE as in ``repro.configs.xlstm_1p3b``.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    unit=("mlstm",) * 7 + ("slstm",),
    n_units=6,
    activation="gelu",
    conv_width=4,
    mlstm_chunk=64,
    tie_embeddings=True,
    quadratic=False,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=512,
    unit=("mlstm", "mlstm", "mlstm", "slstm"),
    n_units=1,
    activation="gelu",
    conv_width=4,
    mlstm_chunk=8,
    quadratic=False,
)

register(FULL, SMOKE)
