"""The host side of K10's gradient on the tensor cores
(``csrc/flash_attention_bwd.cuh``), which the CPU can check without a card:

* ``bwd_plan``: the dkv launch's split, blocks, partial tiles, workspace
  bytes and ticket words at the trained and served layers --
  recurrentgemma-2b's one kv head (64 key tiles for 132 SMs: split),
  gemma2-27b's global layer, deepseek-v3's MLA and seamless's cross
  attention (enough key tiles: no split) -- at one key tile, and the CUDA
  cores' plan;
* ``query_tiles`` (the kernel's QueryTiles): the query tiles a key tile's
  blocks visit are each tile that holds a row keeping one of its keys or a
  row keeping none, once, against a brute force over the mask;
* the gradient's units: each body, the wgmma forms of the padded head and
  value widths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402

SMS = 132        # the H100's streaming multiprocessors

# (B, S, T, H, KH, hd, dv, causal, window) -> (splits, blocks, partials,
# workspace bytes, counters).  The rows take 2 B H SP floats (SP: S rounded
# up to 128), a partial tile 64 (hd + dv).
PLANS = {
    # 64 key tiles; a key tile meets at most 33 query tiles of 10 heads:
    # 330 items, split 5 ways (ceil(2 x 132 / 64)).
    "recurrentgemma-2b local": ((1, 4096, 4096, 10, 1, 256, 256, True, 2048),
                                (5, 320, 320, 4 * (2 * 10 * 4096
                                                   + 320 * 64 * 512), 64)),
    "gemma2-27b global": ((1, 2100, 2100, 32, 16, 128, 128, True, 0),
                          (1, 528, 0, 4 * 2 * 32 * 2176, 0)),
    "deepseek-v3-671b MLA": ((1, 2100, 2100, 128, 128, 192, 128, True, 0),
                             (1, 4224, 0, 4 * 2 * 128 * 2176, 0)),
    "seamless-m4t-medium cross": ((1, 64, 2100, 16, 16, 64, 64, False, 0),
                                  (1, 528, 0, 4 * 2 * 16 * 128, 0)),
    # One key tile: 10 heads x 16 query tiles, one item a block.
    "one key tile": ((1, 1000, 50, 10, 1, 128, 128, False, 0),
                     (160, 160, 160, 4 * (2 * 10 * 1024 + 160 * 64 * 256),
                      1)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_bwd_plan_at_the_layers(name):
    args, (splits, blocks, partials, nbytes, counters) = PLANS[name]
    plan = flash_k.bwd_plan(*args, "TensorCores", sms=SMS)
    assert (plan.splits, plan.blocks, plan.partials, plan.workspace_bytes,
            plan.counters) == (splits, blocks, partials, nbytes, counters)


def test_bwd_plan_of_the_cuda_cores():
    """Float32 keeps its two launches: no split, D in the workspace."""
    plan = flash_k.bwd_plan(1, 100, 100, 4, 4, 192, 128, True, 0,
                            "CudaCores", sms=SMS)
    assert (plan.splits, plan.partials, plan.workspace_bytes,
            plan.counters) == (1, 0, 4 * 100 * 4, 0)


def test_query_tiles_cover_the_rows_of_each_key_tile():
    """For causal or not, windows that skip tiles, S < T and S > T, and
    rows that keep no key: the tiles a key tile visits are each tile that
    holds a row keeping one of its keys or a row keeping none, once."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        S, T = (int(x) for x in rng.integers(1, 400, 2))
        causal = bool(rng.integers(2))
        window = int(rng.choice([0, 1, 8, 64, 100, 300]))
        q = np.arange(S)[:, None]
        k = np.arange(T)[None, :]
        keep = np.ones((S, T), bool)
        if causal:
            keep &= q >= k
        if window:
            keep &= q - k < window
        empty = ~keep.any(axis=1)
        for k0 in range(0, T, 64):
            rows = keep[:, k0:k0 + 64].any(axis=1) | empty
            want = sorted({int(r) // 64 for r in np.flatnonzero(rows)})
            got = flash_k.query_tiles(k0, S, T, causal, window)
            assert sorted(got) == want and len(set(got)) == len(got), (
                S, T, causal, window, k0)


def test_bwd_units_carry_their_bodies_and_wgmma_forms():
    """bf16: the tensor cores with the gradient's three wgmma forms (m64n64
    for the scores, m64n{padded head} for dK and dQ, m64n{padded value
    head} for dV); float32: the CUDA cores, no wgmma; a body is required."""
    bf = torch.bfloat16
    u = flash_k.flash_bwd_unit(bf, 192, "test", 128)
    assert "using Body = rt::flash_bwd::TensorCores<HD, Wgmma, DV>;" in \
        u.source
    assert "static constexpr int HN = 192, VN = 128;" in u.source
    for n in (64, 192, 128):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in \
            u.source
    u = flash_k.flash_bwd_unit(bf, 80, "test")
    assert "static constexpr int HN = 128, VN = 128;" in u.source
    f32 = flash_k.flash_bwd_unit(torch.float32, 64, "test")
    assert "using Body = rt::flash_bwd::CudaCores<HD>;" in f32.source
    assert "wgmma" not in f32.source
    with pytest.raises(ValueError, match="body is one of"):
        _lib.unit("flash_bwd", "test", dtypes=[bf], head_dim=64)
    assert "rt::maxplus_grad::run" in _lib.unit("maxplus_grad",
                                                "test").source
