"""``linear_recurrence``'s gradient kernel (``csrc/linrec_grad.cuh``) on
the CPU: its plain version ``kernels/scan.py::linrec_grad_plain`` and the
cuda route's wrapper ``linrec_grad_cuda`` (which runs the plain version on
CPU tensors) against ``jax.grad`` of the reference's ``linear_recurrence``
under ``jax.jit``; the form the host picks by shape; and, on tensors that
say they lie on the card (``test_torch_primitives``'s ``_OnCard``) with a
stand-in library that records each entry call, the backward as one
``rt_linrec_grad`` call.

Inputs come from numpy with a seed; the reference's own h is the forward
the gradient reads.  Float32 (and float64 in the host checks), da, db and
dh0 each within 1e-5 of its largest entry: the reference's gradient runs
XLA's reverse scan, the plain version a serial walk, the same products in
another order.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ops as ops_k  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from test_torch_primitives import _Entries, _on_card  # noqa: E402

TOL = 1e-5
F32, F64, BF16, F16 = torch.float32, torch.float64, torch.bfloat16, \
    torch.float16

# (B, T, C, with h0, reverse, dh's dtype): both sides of the short form's
# limit (T = 64) and of the long-T form's (T = 128 at B C <= 1,024), T = 1,
# reverse recurrences, a bf16 and an f16 dh.
CASES = [
    (2, 9, 5, False, False, F32),
    (2, 9, 5, True, True, F32),
    (3, 1, 4, True, False, F32),
    (2, 64, 3, True, True, F32),
    (2, 65, 3, False, False, BF16),
    (1, 127, 8, True, False, F32),
    (1, 128, 8, True, True, F16),
]


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.detach().double().numpy() - want).max())
    bound = TOL * float(np.abs(want).max()) + 1e-7
    assert err <= bound, f"{what}: {err} > {bound}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradient_matches_jax(case):
    """da, db and dh0 of the plain version and of the cuda wrapper on CPU
    tensors against ``jax.grad`` of the reference, the cotangent dh given
    in its own dtype (the reference sees its values in float32)."""
    B, T, C, with_h0, reverse, dh_dtype = case
    rng = np.random.default_rng(B * 1000 + T * 10 + C)
    an = rng.uniform(0.5, 1.0, (B, T, C)).astype(np.float32)
    bn = rng.standard_normal((B, T, C)).astype(np.float32)
    hn = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    dh = torch.from_numpy(rng.standard_normal((B, T, C)).astype(
        np.float32)).to(dh_dtype)
    dn = dh.float().numpy()
    args = [x for x in (an, bn, hn) if x is not None]

    def f(*xs):
        return (j_forge.linear_recurrence(*xs, reverse=reverse,
                                          layout=JBatched()) * dn).sum()

    want = jax.jit(jax.grad(f, argnums=tuple(range(len(args)))))(*args)
    h = np.array(j_forge.linear_recurrence(*args, reverse=reverse,
                                           layout=JBatched()))
    a, h = torch.from_numpy(an), torch.from_numpy(h)
    h0 = None if hn is None else torch.from_numpy(hn)
    for fn in (scan_k.linrec_grad_plain, scan_k.linrec_grad_cuda):
        da, db, dh0 = fn(a, h, dh, h0, reverse=reverse)
        assert da.dtype == db.dtype == F32 and (dh0 is None) == (h0 is None)
        for name, g, w in zip(("da", "db", "dh0"), (da, db, dh0), want):
            _close(g, w, f"{fn.__name__} {name}")


def test_form_by_shape():
    """The short form up to 64 steps, whatever the channels; above it the
    long-T form where K6 takes its long-T path (B C <= 1,024, T >= 128),
    the channel tiles elsewhere."""
    form = scan_k.linrec_grad_form
    assert form(1, 16, 4 * 1024 * 1024) == "short"     # xLSTM's chunk states
    assert form(1, 16, 4096) == form(3, 1, 7) == form(2, 64, 4) == "short"
    assert form(1, 4096, 2560) == form(2, 65, 3) == "tiles"   # the RG-LRU
    assert form(1, 127, 1024) == form(2, 4096, 513) == "tiles"
    assert form(2, 4096, 256) == form(1, 128, 1024) == "long"
    for shape in ((1, 65, 8), (1, 200, 2048), (1, 128, 1024)):
        assert (form(*shape) == "long") == (
            shape[1] > 64 and scan_k.uses_long_t(*shape))


@pytest.fixture
def card(monkeypatch):
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(_lib, "_PLANS", {})
    for attr in ("launches", "long_t_launches", "reverse_launches",
                 "long_t_reverse_launches"):
        monkeypatch.setattr(scan_k.scan_channel_cuda, attr, 0)
    monkeypatch.setattr(scan_k.linrec_grad_cuda, "launches", 0)
    monkeypatch.setattr(scan_k.linrec_grad_cuda, "form_launches",
                        dict.fromkeys(scan_k.LINREC_FORMS, 0))
    return lib


@pytest.mark.parametrize("shape,with_h0,reverse,dtype,form", [
    ((1, 16, 4096), False, False, F32, "short"),
    ((2, 300, 2048), True, True, F32, "tiles"),
    ((2, 256, 8), True, False, F64, "long"),
])
def test_backward_is_one_entry_call(card, shape, with_h0, reverse, dtype,
                                    form):
    """Forward: one K6 entry call.  Backward (called directly: the autograd
    engine hands a backward plain tensors): one ``rt_linrec_grad`` call of
    the (leaf type, dh type) unit, no K6 call, on a, h, dh and h0 as they
    are -- no shifted copy, no cast -- writing da, db and dh0, with the
    form's index; only the long-T form passes scratch, sized for its chunk
    maps."""
    B, T, C = shape
    a = _on_card(torch.rand(shape, dtype=dtype)).requires_grad_()
    b = _on_card(torch.rand(shape, dtype=dtype)).requires_grad_()
    h0 = _on_card(torch.rand(B, C, dtype=dtype)).requires_grad_() \
        if with_h0 else None
    h = t_forge.linear_recurrence(a, b, h0, reverse=reverse,
                                  layout=TBatched())
    assert h.grad_fn is not None
    assert [c[0] for c in card.calls] == ["rt_scan_channel"]
    card.calls.clear()
    dh = _on_card(torch.rand(shape, dtype=dtype))
    saved = (a.detach(), h.detach(), None if h0 is None else h0.detach())
    ctx = types.SimpleNamespace(saved_tensors=saved, reverse=reverse)
    da, db, dh0, none = ops_k.LinearRecurrence.backward(ctx, dh)
    assert da.shape == db.shape == shape and none is None
    assert (dh0 is None) == (h0 is None)
    (name, args), = card.calls
    assert name == "rt_linrec_grad"
    assert args[:7] == tuple(_lib.ptr(t) for t in (
        saved[0], saved[1], dh, saved[2], da, db, dh0))
    nchunks = -(-T // scan_k.LONG_CHUNK)
    size = 2 * B * C * nchunks * dtype.itemsize if form == "long" else 0
    assert (args[7] is None) == (form != "long") and args[8] == size
    assert args[9:] == (B, T, C, int(reverse),
                        scan_k.LINREC_FORMS.index(form), 7)
    assert card.loaded[-1] == _lib.unit("linrec_grad", "test",
                                        dtypes=(dtype, dtype))
    assert scan_k.linrec_grad_cuda.launches == 1
    assert scan_k.linrec_grad_cuda.form_launches[form] == 1
    k6 = scan_k.scan_channel_cuda
    assert k6.reverse_launches + k6.long_t_reverse_launches == int(reverse)


def test_wrapper_raises_on_what_it_does_not_take(card):
    """On the card the wrapper launches or raises, before any entry call:
    leaves other than float32 / float64, a dh of an integer type, leaves of
    two types, a non-contiguous operand, an h0 of another shape."""
    a = _on_card(torch.rand(2, 9, 4))
    dh = _on_card(torch.rand(2, 9, 4))
    grad = scan_k.linrec_grad_cuda
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        grad(a.to(BF16), a.to(BF16), dh)
    with pytest.raises(NotImplementedError, match="int32"):
        grad(a, a, dh.to(torch.int32))
    with pytest.raises(NotImplementedError, match="one dtype"):
        grad(a, a.double(), dh)
    with pytest.raises(ValueError, match="contiguous"):
        grad(a, a, _on_card(torch.rand(2, 4, 9)).transpose(1, 2))
    with pytest.raises(ValueError, match=r"h0 must be \(B, C\)"):
        grad(a, a, dh, _on_card(torch.rand(2, 5)))
    assert card.calls == [] and grad.launches == 0
