"""The port's K10 (fused attention) against the reference kernel.

On the CPU ``repro_torch.kernels.flash_attention`` runs its plain version,
``kernels/ref.py``'s ``flash_attention_ref``; it must equal
``flash_attention_pallas(..., interpret=True)`` at the same ``q_block`` and
``kv_block`` on the same numpy inputs: within 1e-5 in float32 (the two
frameworks order a dot product's float32 sums differently), within 1e-2 in
bfloat16 (one bf16 rounding of p, of which a float32 difference in the
score can move a value by one step).  The cases are the reference's own
(``tests/test_flash_attention.py``) plus causal attention with S != T, rows
that keep no key, and head_dim 16 and 256.  The tests marked ``cuda`` need
the card and skip here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as JF  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _qkv(N, S, T, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, n, d)).astype(np.float32)
            for n in (S, T, T)]


def _both(q, k, v, dtype="float32", **kw):
    """(port, reference) outputs as float32 numpy arrays."""
    tdt = getattr(torch, dtype)
    got = flash_k.flash_attention(*(torch.from_numpy(x).to(tdt)
                                    for x in (q, k, v)), **kw)
    want = JF.flash_attention_pallas(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
        interpret=True, **kw)
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 100, 64), (3, 33, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(shape, causal):
    N, S, d = shape
    got, want = _both(*_qkv(N, S, S, d, 0), causal=causal, q_block=32,
                      kv_block=32)
    np.testing.assert_allclose(got, want, **F32)


def test_flash_window_and_softcap_match_pallas():
    got, want = _both(*_qkv(2, 96, 96, 64, 1), causal=True, window=16,
                      softcap=30.0, q_block=32, kv_block=32)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("S,T,causal,window", [
    (24, 72, False, 0),     # the reference's cross-length case
    (24, 72, True, 0),      # causal, fewer queries than keys
    (72, 24, True, 0),      # causal, rows past T see every key
    (60, 20, True, 8),      # rows 27.. keep no key at all
    (40, 17, False, 5),     # the same without the causal mask
])
def test_flash_cross_lengths_match_pallas(S, T, causal, window):
    """Positions count from 0 for q and k alike; a row that keeps no key
    averages v over the padded kv tiles, as the reference kernel does."""
    got, want = _both(*_qkv(1, S, T, 32, 2), causal=causal, window=window,
                      q_block=16, kv_block=32)
    np.testing.assert_allclose(got, want, **F32)


def test_flash_bf16_matches_pallas():
    got, want = _both(*_qkv(2, 64, 64, 64, 3), dtype="bfloat16",
                      q_block=32, kv_block=32)
    np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("d,dtype", [(16, "float32"), (256, "float32"),
                                     (256, "bfloat16")])
def test_flash_head_dims_match_pallas(d, dtype):
    got, want = _both(*_qkv(2, 40, 40, d, 4), dtype=dtype, window=24,
                      softcap=50.0, q_block=32, kv_block=32)
    np.testing.assert_allclose(got, want, **(F32 if dtype == "float32"
                                             else BF16))


def test_flash_matches_dense_softmax():
    """The plain version against softmax attention written out densely."""
    q, k, v = _qkv(2, 70, 70, 16, 5)
    got = flash_k.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=20, softcap=30.0, kv_block=32)
    s = np.einsum("nsd,ntd->nst", q, k) / np.sqrt(16)
    s = 30.0 * np.tanh(s / 30.0)
    pos = np.arange(70)
    keep = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < 20)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = (p / p.sum(-1, keepdims=True)) @ v
    np.testing.assert_allclose(got.numpy(), dense, **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_entry_equals_broadcast_kv(dtype):
    """Query head (k, g) attends to kv head k: the GQA entry equals the
    (N, S, d) entry on explicitly broadcast k and v."""
    B, S, T, K, G, hd = 2, 37, 37, 2, 3, 16
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(B, S, K, G, hd))).to(dtype)
    k = torch.from_numpy(rng.normal(size=(B, T, K, hd))).to(dtype)
    v = torch.from_numpy(rng.normal(size=(B, T, K, hd))).to(dtype)
    got = flash_k.flash_attention_gqa(q, k, v, window=9, softcap=50.0)

    def heads(x, n):
        if x.ndim == 4:
            x = x[:, :, :, None].expand(B, n, K, G, hd)
        return x.permute(0, 2, 3, 1, 4).reshape(B * K * G, n, hd)

    flat = flash_k.flash_attention(heads(q, S), heads(k, T), heads(v, T),
                                   window=9, softcap=50.0)
    want = flat.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("is_local", [True, False])
def test_gqa_forward_k10_route_matches_blockwise(is_local):
    """The model's prefill on K10's route (the cuda backend's; here its
    plain version) against ``blockwise_attention``'s (the torch backend's),
    on gemma2's smoke config in float32."""
    cfg = dataclasses.replace(get_config("gemma2-27b", smoke=True),
                              dtype="float32")
    gen = torch.Generator().manual_seed(7)
    params = TA.init_gqa(gen, cfg)
    x = torch.randn(2, 45, cfg.d_model, generator=gen)
    want, cw = TA.gqa_forward(params, cfg, x, is_local=is_local,
                              return_cache_len=64)
    with ki.use_backend("cuda"):
        got, cg = TA.gqa_forward(params, cfg, x, is_local=is_local,
                                 return_cache_len=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    assert all(torch.equal(cg[key], cw[key]) for key in ("k", "v"))


def test_cost_counts_match_reference():
    for args in ((2, 100, 100, 64), (32, 2100, 2100, 128), (1, 24, 72, 16)):
        assert ref.flash_attention_flops(*args) == \
            JF.flash_attention_flops(*args)
        assert ref.flash_attention_flops(*args, causal=False) == \
            JF.flash_attention_flops(*args, causal=False)
        for t, j in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
            assert ref.flash_attention_bytes(*args, t, 32, 64) == \
                JF.flash_attention_bytes(*args, j, 32, 64)


def test_flash_units_carry_dtype_and_head_dim():
    """The generated unit (no nvcc needed to generate it) names its element
    type and head_dim and selects its dtype's body: bf16 the tensor cores,
    with the unit's wgmma forms (P V over the row padded to whole 64-wide
    boxes), f32 the CUDA cores, and a body that reads another element type
    than the unit's fails to compile; what the kernel does not take raises
    before any build."""
    u = flash_k.flash_unit(torch.bfloat16, 128, "test")
    assert "using Elem = __nv_bfloat16;" in u.source
    assert "static_assert(std::is_same<Body::Elem, Elem>::value" in u.source
    assert "constexpr int HD = 128;" in u.source
    assert "using Body = rt::flash::TensorCores<HD, Wgmma>;" in u.source
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in u.source
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in u.source
    f32 = flash_k.flash_unit(torch.float32, 128, "test")
    assert "using Body = rt::flash::CudaCores<HD>;" in f32.source
    assert "wgmma" not in f32.source and "TensorCores" not in f32.source
    assert "m64n128k16" in flash_k.flash_unit(torch.bfloat16, 80,
                                              "test").source
    assert "m64n256k16" in flash_k.flash_unit(torch.bfloat16, 256,
                                              "test").source
    assert u.digest != f32.digest
    assert u.digest != flash_k.flash_unit(torch.bfloat16, 256, "test").digest
    with pytest.raises(ValueError, match="body is one of"):
        _lib.unit("flash", "test", dtypes=[torch.float32], head_dim=64,
                  body="Scalar")
    with pytest.raises(NotImplementedError, match="head_dim 16 to 256"):
        flash_k.flash_unit(torch.float32, 24, "test")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        flash_k.flash_unit(torch.float16, 64, "test")
    with pytest.raises(ValueError, match="head_dim"):
        _lib.unit("copy", "test", head_dim=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,K,G,hd,window,softcap", [
    (130, 130, 4, 2, 128, 50, 50.0),
    (300, 40, 1, 2, 256, 30, 0.0),    # rows 69.. keep no key
])
def test_k10_launches_and_matches_plain_version_on_the_card(
        cuda_device, S, T, K, G, hd, window, softcap):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, S, K, G, hd, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.randn(1, T, K, hd, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    v = torch.randn(1, T, K, hd, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    before = flash_k.flash_attention_gqa.launches
    got = flash_k.flash_attention_gqa(q, k, v, window=window,
                                      softcap=softcap)
    assert flash_k.flash_attention_gqa.launches == before + 1
    want = ref.flash_attention_gqa_ref(q, k, v, window=window,
                                       softcap=softcap,
                                       kv_block=flash_k.KV_BLOCK)
    # Each output row within one bf16 step (2^-7) of its own norm.
    d = (got.float() - want.float()).norm(dim=-1)
    assert float((d / want.float().norm(dim=-1)).max()) <= 2 ** -7


@pytest.mark.cuda
def test_k10_raises_rather_than_running_its_plain_version(cuda_device,
                                                          monkeypatch):
    q = torch.zeros(1, 8, 24, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash_k.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="kv_block=128"):
        flash_k.flash_attention(q, q, q, kv_block=128)

    def broken(unit):
        raise RuntimeError("CUDA kernel build failed")

    monkeypatch.setattr(_lib, "load", broken)
    q = torch.zeros(1, 8, 32, device=cuda_device)
    before = flash_k.flash_attention_gqa.launches
    with pytest.raises(RuntimeError, match="build failed"):
        flash_k.flash_attention(q, q, q)
    assert flash_k.flash_attention_gqa.launches == before
