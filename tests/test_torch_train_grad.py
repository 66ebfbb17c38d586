"""The gradients of the port's two kernels on the training path, and the
rule that no other cuda route silently cuts the graph.

* K10's gradient: ``kernels/ref.py::flash_attention_bwd_ref`` (the plain
  version of ``csrc/flash_attention_bwd.cuh``, an explicit backward)
  against ``torch.autograd`` through ``flash_attention_ref``, and
  ``flash_attention.Attention`` (the ``autograd.Function`` the models'
  cuda route runs, its plain halves on CPU tensors) against
  ``jax.grad`` of the reference's ``blockwise_attention``.  Float32,
  each gradient within 1e-5 of its largest entry: the two are the same
  sums in another order.
* K6's gradient: ``kernels/ops.py::LinearRecurrence`` (one call of
  ``csrc/linrec_grad.cuh``, its plain version on CPU tensors) against
  autograd through the torch route and ``jax.grad`` of the reference's
  ``linear_recurrence``, within 1e-5 of each gradient's largest entry.
* On tensors that say they lie on the card (``test_torch_primitives``'s
  ``_OnCard``) and a stand-in library that records each entry call: a
  cuda route without a gradient raises under autograd, naming the route;
  K6's backward is one ``rt_linrec_grad`` entry call on a, h and dh as
  they are; K10's forward asks for the log-sum-exp and its backward is one
  ``rt_flash_bwd`` call.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.kernels import matvec as matvec_k  # noqa: E402
from repro_torch.kernels import ops as ops_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_primitives import _Entries, _on_card  # noqa: E402

TOL = 1e-5


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want, what=""):
    want = want.detach().double()
    err = float((got.detach().double() - want).abs().max())
    bound = TOL * float(want.abs().max()) + 1e-7
    assert err <= bound, f"{what}: {err} > {bound}"


# (B, S, T, K, G, d, dv, causal, window, softcap): GQA; a window and a soft
# cap; cross attention (not causal, S != T); a value head narrower than
# q's; rows past T + window - 1 that keep no key.
FLASH_CASES = [
    (2, 37, 37, 2, 3, 32, 32, True, 0, 0.0),
    (1, 70, 70, 1, 4, 16, 16, True, 24, 5.0),
    (1, 20, 75, 2, 2, 32, 32, False, 0, 0.0),
    (1, 45, 45, 2, 1, 48, 32, True, 0, 0.0),
    (1, 90, 30, 1, 2, 16, 16, True, 8, 0.0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_ref_and_function_match_autograd(case):
    """``flash_attention_bwd_ref`` from the forward's ``out`` and ``lse``,
    and ``Attention``'s backward (the models' cuda route, reached with
    ``use_backend("cuda")``), against autograd through the plain forward
    at the kernel's key tiles (so rows that keep no key average over the
    same padded count)."""
    B, S, T, K, G, d, dv, causal, window, cap = case
    rng = np.random.default_rng(sum(case[:7]))
    q = _rand(rng, B, S, K, G, d).requires_grad_()
    k = _rand(rng, B, T, K, d).requires_grad_()
    v = _rand(rng, B, T, K, dv).requires_grad_()
    dout = _rand(rng, B, S, K, G, dv)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = ref.flash_attention_gqa_ref(q, k, v, kv_block=64,
                                           return_lse=True, **kw)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = ref.flash_attention_bwd_ref(
        q.detach().reshape(B, S, K * G, d), k.detach(), v.detach(),
        out.detach().reshape(B, S, K * G, dv), lse.detach(),
        dout.reshape(B, S, K * G, dv), **kw)
    for name, g, w in zip("qkv", got, want):
        _close(g.reshape(w.shape), w, f"bwd_ref d{name}")
    with ki.use_backend("cuda"):
        out_f = flash_k.flash_attention_gqa(q, k, v, **kw)
    assert torch.equal(out_f.detach(), out.detach())
    for name, g, w in zip("qkv", torch.autograd.grad(out_f, (q, k, v), dout),
                          want):
        _close(g, w, f"Attention d{name}")


@pytest.mark.parametrize("case", FLASH_CASES[1:4])
def test_flash_gradient_against_reference_blockwise(case):
    """The cuda route's gradient (``Attention``) against ``jax.grad`` of
    the reference's ``blockwise_attention``, the core the reference trains
    through (no row here keeps no key: the two average such a row over
    different counts)."""
    B, S, T, K, G, d, dv, causal, window, cap = case
    rng = np.random.default_rng(sum(case[:7]) + 1)
    qn = rng.standard_normal((B, S, K, G, d)).astype(np.float32)
    kn = rng.standard_normal((B, T, K, d)).astype(np.float32)
    vn = rng.standard_normal((B, T, K, dv)).astype(np.float32)
    dn = rng.standard_normal((B, S, K, G, dv)).astype(np.float32)

    def f(q, k, v):
        o = jattn.blockwise_attention(q, k, v, qpos=jnp.arange(S),
                                      causal=causal, window=window,
                                      softcap=cap)
        return jnp.sum(o * dn)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(qn, kn, vn)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    with ki.use_backend("cuda"):
        out = flash_k.flash_attention_gqa(q, k, v, causal=causal,
                                          window=window, softcap=cap)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dn))
    for name, g, w in zip("qkv", got, want):
        _close(g, torch.from_numpy(np.array(w)), f"d{name}")


@pytest.mark.parametrize("reverse", [False, True])
def test_k6_gradient(reverse):
    """``linear_recurrence``'s gradient on the cuda route (its plain K6 on
    CPU tensors) against autograd through the torch route and ``jax.grad``
    of the reference's, for a, b and h0, with and without h0."""
    rng = np.random.default_rng(7)
    B, T, C = 3, 67, 5
    an = rng.uniform(0.5, 1.0, (B, T, C)).astype(np.float32)
    bn = rng.standard_normal((B, T, C)).astype(np.float32)
    dn = rng.standard_normal((B, T, C)).astype(np.float32)
    for hn in (None, rng.standard_normal((B, C)).astype(np.float32)):
        args = [x for x in (an, bn, hn) if x is not None]
        inputs = [torch.from_numpy(x).requires_grad_() for x in args]

        def port(backend):
            with ki.use_backend(backend):
                h = t_forge.linear_recurrence(*inputs, reverse=reverse,
                                              layout=TBatched())
            return torch.autograd.grad(h, inputs, torch.from_numpy(dn))

        got, plain = port("cuda"), port("torch")

        def f(*xs):
            h = j_forge.linear_recurrence(*xs, reverse=reverse,
                                          layout=JBatched())
            return jnp.sum(h * dn)

        want = jax.jit(jax.grad(f, argnums=tuple(range(len(args)))))(*args)
        for name, g, p, w in zip(("a", "b", "h0"), got, plain, want):
            _close(g, p, f"d{name} against the torch route")
            _close(g, torch.from_numpy(np.array(w)), f"d{name} against jax")


@pytest.fixture
def card(monkeypatch):
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(_lib, "_PLANS", {})
    monkeypatch.setattr(_lib, "_WORKSPACES", {})
    monkeypatch.setattr(matvec_k, "sms", lambda device: 132)
    for w, attr in ((scan_k.scan_channel_cuda, "launches"),
                    (scan_k.scan_channel_cuda, "reverse_launches"),
                    (scan_k.linrec_grad_cuda, "launches"),
                    (flash_k.flash_attention_gqa, "launches"),
                    (flash_k.flash_attention_bwd, "launches")):
        monkeypatch.setattr(w, attr, 0)
    return lib


def test_cuda_routes_without_a_gradient_raise(card):
    """Under autograd with an input that requires grad, a cuda route that
    has no ``autograd.Function`` raises, naming the route, before it
    launches anything; under ``no_grad`` (or with no such input) it
    launches as before."""
    x = _on_card(torch.ones(64)).requires_grad_()
    A = _on_card(torch.ones(64, 8)).requires_grad_()
    calls = {
        "scan@flat": lambda: t_forge.scan(t_alg.ADD, x),
        "scan@batched": lambda: t_forge.scan(
            t_alg.MAXPLUS_AFFINE, (x.reshape(8, 8), x.reshape(8, 8)),
            layout=TBatched()),
        "mapreduce@flat": lambda: t_forge.mapreduce(lambda y: y, t_alg.ADD,
                                                    x),
        "matvec@flat": lambda: t_forge.matvec(lambda u, a: u * a, t_alg.ADD,
                                              A, x),
        "sort@flat": lambda: t_forge.sort(x),
        "top_k@flat": lambda: t_forge.top_k(x, 4),
        "copy@flat": lambda: t_forge.copy(x),
    }
    for route, call in calls.items():
        with pytest.raises(RuntimeError, match=rf"{route} \(cuda\): the "
                                               r"kernel has no gradient"):
            call()
    assert card.calls == []
    with torch.no_grad():
        t_forge.scan(t_alg.ADD, x)
    t_forge.scan(t_alg.ADD, x.detach())
    assert [c[0] for c in card.calls] == ["rt_scan_tile"] * 2


def test_k6_and_k10_backward_host_side(card):
    """K6's gradient: the forward is one channel-tile entry call; the
    backward (``LinearRecurrence.backward``) one ``rt_linrec_grad`` call of
    the float32 unit in the short form (T = 9), on a, h and dh as they are
    -- no shifted copy, no cast, no K6 launch -- writing da and db, no h0.
    K10's: under autograd the forward passes a log-sum-exp output to
    ``rt_flash``, and the backward is one ``rt_flash_bwd`` call of the
    (bf16, 64) gradient unit on the tensor cores, with the workspace and
    split of ``bwd_plan`` (one key tile: its two query heads' items split
    over two blocks, a ticket word from the stream's workspace).  Each
    kernel's counter moves once a launch.
    (The backwards are called directly: the autograd engine hands a
    backward plain tensors, which no longer say they lie on the card.)"""
    k6, grad = scan_k.scan_channel_cuda, scan_k.linrec_grad_cuda
    a = _on_card(torch.rand(2, 9, 4096)).requires_grad_()
    b = _on_card(torch.rand(2, 9, 4096)).requires_grad_()
    h = t_forge.linear_recurrence(a, b, layout=TBatched())
    assert h.grad_fn is not None
    dh = _on_card(torch.rand(2, 9, 4096))
    ctx = types.SimpleNamespace(saved_tensors=(a.detach(), h.detach(), None),
                                reverse=False)
    da, db, dh0, _ = ops_k.LinearRecurrence.backward(ctx, dh)
    assert da.shape == db.shape == a.shape and dh0 is None
    (n0, args0), (n1, args1) = card.calls
    assert n0 == "rt_scan_channel" and args0[4:9] == (2, 9, 4096, 1, 0)
    assert n1 == "rt_linrec_grad"
    assert args1[:7] == (a.data_ptr(), h.data_ptr(), dh.data_ptr(), None,
                         da.data_ptr(), db.data_ptr(), None)
    assert args1[7:] == (None, 0, 2, 9, 4096, 0,
                         scan_k.LINREC_FORMS.index("short"), 7)
    assert card.loaded[-1] == _lib.unit("linrec_grad", "test",
                                        dtypes=(torch.float32,) * 2)
    assert (k6.launches, k6.reverse_launches, grad.launches) == (1, 0, 1)

    card.calls.clear()
    bf = torch.bfloat16
    q = _on_card(torch.zeros(1, 9, 1, 2, 64, dtype=bf)).requires_grad_()
    k = _on_card(torch.zeros(1, 9, 1, 64, dtype=bf)).requires_grad_()
    v = _on_card(torch.zeros(1, 9, 1, 64, dtype=bf)).requires_grad_()
    out = flash_k.flash_attention_gqa(q, k, v, window=4)
    assert out.grad_fn is not None
    (n0, args0), = card.calls
    assert n0 == "rt_flash" and args0[15] is not None
    card.calls.clear()
    dq, dk, dv = flash_k.flash_attention_bwd(
        q.detach().reshape(1, 9, 2, 64), k.detach(), v.detach(),
        out.detach().reshape(1, 9, 2, 64),
        _on_card(torch.zeros(1, 9, 2)), _on_card(torch.ones(1, 9, 2, 64,
                                                            dtype=bf)),
        window=4)
    (n1, args1), = card.calls
    assert n1 == "rt_flash_bwd" and args1[11:19] == (1, 9, 9, 2, 1, 64, 1, 4)
    plan = flash_k.bwd_plan(1, 9, 9, 2, 1, 64, 64, True, 4, "TensorCores")
    assert (plan.splits, plan.blocks, plan.counters) == (2, 2, 1)
    assert args1[22] == plan.splits and args1[6] is not None
    assert args1[7] == _lib._WORKSPACES[(-1, 7)].counters.data_ptr()
    unit = card.loaded[-1]
    assert unit == flash_k.flash_bwd_unit(bf, 64, "test")
    assert "rt::flash_bwd::TensorCores<HD, Wgmma>" in unit.source
    assert dq.shape == (1, 9, 2, 64) and dv.shape == v.shape
    assert flash_k.flash_attention_gqa.launches == 1
    assert flash_k.flash_attention_bwd.launches == 1
