"""xLSTM's gradient on the cuda route: the mLSTM stabilizer's scan under
MAXPLUS_AFFINE (``kernels/ops.py::MaxplusAffineScan``), which the registry
lets through autograd on ``scan@flat`` (``core/intrinsics.py:
GRAD_ROUTES``), and the first train step of xlstm-1.3b smoke through it.

* The Function on CPU tensors (K6's wrapper runs its plain version), reached
  through the model's ``_mlstm_stabilizer`` under ``use_backend("cuda")``,
  against ``jax.grad`` of the reference's ``_mlstm_stabilizer`` (jitted):
  each gradient within 1e-5 of its largest entry, float32 sums of the
  forget gates taken in another order.
* Ties (lf_t + m_{t-1} == li_t): the Function's backward walks the
  combine tree of ``lax.associative_scan`` and halves the adjoint at each
  tied ``max`` of it, as ``jax.grad`` does: the reference's bits at a tie,
  at chains of two to four, and at dyadic tie patterns placed on and
  across the tree's pair boundaries, at odd and even T up to 33.
* xlstm-1.3b smoke, float32: ``forward_train``'s loss and every gradient
  leaf on the cuda route (both Functions engaged) against the reference's
  jitted ``value_and_grad``, 1e-4 as ``test_torch_train_forward.py``.
* On tensors that say they lie on the card and a stand-in library: the
  stabilizer's forward is one K6 entry call (the long-T path at T >= 128)
  and its backward one entry call of the stabilizer-gradient kernel
  (``csrc/maxplus_grad.cuh``); other forms of a MAXPLUS_AFFINE scan still
  raise under autograd.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.convert import params_to_jax  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ops as ops_k  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_primitives import _Entries, _on_card  # noqa: E402
from test_torch_train_forward import RTOL, port_loss, setup  # noqa: E402

TOL = 1e-5


def port_grads(lf, li, dm):
    """m and (dlf, dli) of the port's stabilizer on the cuda route."""
    lf_t, li_t = (torch.from_numpy(x).requires_grad_() for x in (lf, li))
    with ki.use_backend("cuda"):
        m = trec._mlstm_stabilizer(lf_t, li_t)
    grads = torch.autograd.grad(m, (lf_t, li_t), torch.from_numpy(dm))
    return m.detach().numpy(), [g.numpy() for g in grads]


@jax.jit
def _ref_grads(lf, li, dm):
    return jax.grad(lambda a, b: jnp.sum(jrec._mlstm_stabilizer(a, b) * dm),
                    argnums=(0, 1))(lf, li)


def ref_grads(lf, li, dm):
    return [np.asarray(g) for g in _ref_grads(lf, li, dm)]


@pytest.mark.parametrize("shape", [(2, 37, 3), (1, 130, 4), (3, 9, 1)])
def test_stabilizer_gradient_matches_jax(shape):
    """Past K6's long-T threshold (T = 130), below it, and B = 3."""
    rng = np.random.default_rng(sum(shape))
    lf, li, dm = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(3))
    lf = -np.abs(lf)                 # log forget gates: below 0, as a sigmoid
    m, got = port_grads(lf, li, dm)
    np.testing.assert_allclose(
        m, np.asarray(jrec._mlstm_stabilizer(lf, li)), rtol=TOL, atol=TOL)
    for name, g, w in zip(("dlf", "dli"), got, ref_grads(lf, li, dm)):
        bound = TOL * float(np.abs(w).max()) + 1e-7
        assert float(np.abs(g - w).max()) <= bound, name


def _one_row(*rows):
    return [np.asarray(r, np.float32)[None, :, None] for r in rows]


def test_ties_split_the_adjoint_as_the_reference():
    """A tie at one step, a chain of two, three and four: the reference's
    halves to the bit (dyadic gates: every sum is exact).  The chain of
    four at dm = (0, 0, 0, 1) is the input on which a gradient along a
    serial walk (1/8, 1/8, 1/4, 1/2) parts from the reference's tree
    (1/4 each): the port walks the same tree."""
    for lf, li in (([0.0, 0.0], [1.0, 1.0]),
                   ([0.0, -0.5, 0.5, 0.0], [1.0, 0.5, 1.0, 0.25]),
                   ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
                   ([0.0] * 4, [1.0] * 4)):
        lf, li, dm = _one_row(lf, li, [1.0] * len(lf))
        _, got = port_grads(lf, li, dm)
        for g, w in zip(got, ref_grads(lf, li, dm)):
            np.testing.assert_array_equal(g, w)
    lf, li, dm = _one_row([0.0] * 4, [1.0] * 4, [0.0, 0.0, 0.0, 1.0])
    _, (dlf, dli) = port_grads(lf, li, dm)
    rlf, rli = ref_grads(lf, li, dm)
    np.testing.assert_array_equal(dli.ravel(), [0.25] * 4)
    np.testing.assert_array_equal(dlf.ravel(), [0.0, 0.25, 0.5, 0.75])
    np.testing.assert_array_equal(dli, rli)
    np.testing.assert_array_equal(dlf, rlf)


GATES = np.asarray([-0.5, 0.0, 0.5, 1.0], np.float32)


def tie_patterns(T, rng):
    """(lf, li, dm) of shape (2, T, 6), dyadic: per column a chain of
    tied steps (lf 0 over a run of li at the level the step before it
    reached), each run of 1 to 5 steps starting at an odd or even position
    -- on and across the tree's pair boundaries -- over gates of -0.5
    around it; one column all ties; one of gates drawn from {-0.5, 0, 0.5,
    1}; dm from {-0.5, 0, 1, 2}."""
    lf = np.full((2, T, 6), -0.5, np.float32)
    li = np.full((2, T, 6), -0.5, np.float32)
    for b in range(2):
        for h in range(4):
            start = min(int(rng.integers(1, 4)) + h % 2, T - 1)
            run = int(rng.integers(1, 6))
            li[b, start - 1:start + run, h] = 1.0
            lf[b, start:start + run, h] = 0.0
    lf[:, :, 4], li[:, :, 4] = 0.0, 1.0
    lf[:, :, 5] = rng.choice(GATES, (2, T))
    li[:, :, 5] = rng.choice(GATES, (2, T))
    dm = rng.choice(np.asarray([-0.5, 0.0, 1.0, 2.0], np.float32), (2, T, 6))
    return lf, li, dm


@pytest.mark.parametrize("T", [5, 8, 17, 32])
def test_tie_patterns_match_the_reference_to_the_bit(T):
    """Chains of ties on and across the tree's pair boundaries, at odd
    and even T up to 33 (two draws each), against ``jax.grad`` of the
    reference's stabilizer: dlf and dli equal to the bit."""
    rng = np.random.default_rng(T)
    for n in (T, T + 1):
        lf, li, dm = tie_patterns(n, rng)
        _, got = port_grads(lf, li, dm)
        for g, w in zip(got, ref_grads(lf, li, dm)):
            np.testing.assert_array_equal(g, w)


def test_xlstm_first_step_gradient_on_the_cuda_route():
    """xlstm-1.3b smoke in float32: loss and every gradient leaf of
    ``forward_train`` on the cuda route (the stabilizer through
    ``MaxplusAffineScan``, the chunk states through ``LinearRecurrence``,
    their plain halves on CPU tensors) against the jitted reference."""
    cfg_j, cfg_t, tree, batch = setup("xlstm-1.3b")
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.forward_train(p, cfg_j, b, remat="none"),
        has_aux=True))(jax.tree.map(jnp.asarray, tree),
                       jax.tree.map(jnp.asarray, batch))
    engaged = []
    real = ops_k.MaxplusAffineScan.apply
    with ki.use_backend("cuda"):
        ops_k.MaxplusAffineScan.apply = lambda *a: engaged.append(1) or \
            real(*a)
        try:
            params, leaves, loss, _ = port_loss(cfg_t, tree, batch)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            ops_k.MaxplusAffineScan.apply = real
    assert engaged, "the stabilizer did not take the Function"
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(leaves, got)]
    spec = torch.utils._pytree.tree_structure(params)
    have = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(params_to_jax(
                torch.utils._pytree.tree_unflatten(got, spec), cfg_t))[0]}
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    assert set(have) == set(want)
    for path, g in want.items():
        bound = RTOL * float(np.abs(g).max()) + 1e-7
        assert float(np.abs(have[path] - g).max()) <= bound, path


@pytest.fixture
def card(monkeypatch):
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(_lib, "_PLANS", {})
    for attr in ("launches", "long_t_launches", "reverse_launches",
                 "long_t_reverse_launches"):
        monkeypatch.setattr(scan_k.scan_channel_cuda, attr, 0)
    return lib


@pytest.mark.parametrize("T,long_t", [(1024, True), (9, False)])
def test_stabilizer_backward_is_one_reverse_k6_call(card, monkeypatch, T,
                                                    long_t):
    """Forward: one K6 entry call under MAXPLUS_AFFINE (its long-T path
    from T = 128).  Backward (called directly: the autograd engine hands a
    backward plain tensors): no K6 call, reverse or not, but one entry
    call of the stabilizer-gradient kernel, on lf, li and the contiguous
    float32 (dA, dB), writing (dlf, dli) of (B, T, H), after asking the
    unit for the workspace a column needs (the stand-in answers 0: the
    levels fit in shared memory at these T)."""
    seen = []
    real = scan_k.scan_channel_cuda

    def record(op, xs, **kw):
        seen.append((op, xs, kw))
        return real(op, xs, **kw)

    grad = scan_k.maxplus_grad_cuda
    monkeypatch.setattr(ops_k, "scan_k", types.SimpleNamespace(
        scan_channel_cuda=record, maxplus_grad_cuda=grad))
    monkeypatch.setattr(grad, "launches", 0)
    B, H = 1, 4
    lf = _on_card(-torch.rand(B, T, H)).requires_grad_()
    li = _on_card(torch.rand(B, T, H)).requires_grad_()
    A, Bm = t_forge.scan(t_alg.MAXPLUS_AFFINE, (lf, li), axis=1)
    assert A.grad_fn is not None and Bm.grad_fn is not None
    dA, dB = _on_card(torch.rand(B, T, H)), _on_card(torch.rand(B, T, H))
    ctx = types.SimpleNamespace(saved_tensors=(lf.detach(), li.detach()))
    dlf, dli, _ = ops_k.MaxplusAffineScan.backward(ctx, dA, dB)
    assert dlf.shape == dli.shape == (B, T, H)
    (op0, _, kw0), = seen
    assert op0 is t_alg.MAXPLUS_AFFINE and not kw0.get("reverse")
    names = [c[0] for c in card.calls]
    assert names == ["rt_scan_channel", "rt_maxplus_grad_floats",
                     "rt_maxplus_grad"]
    assert card.calls[1][1] == (T,)
    args = card.calls[2][1]
    assert args[:4] == tuple(t.data_ptr() for t in (lf, li, dA, dB))
    assert args[6] is None and args[7:] == (B, T, H, 7)
    assert card.loaded[-1] == _lib.unit("maxplus_grad", "test")
    assert grad.launches == 1
    k6 = real
    assert (k6.long_t_launches, k6.launches) == (
        (1, 0) if long_t else (0, 1))
    assert k6.reverse_launches == k6.long_t_reverse_launches == 0


def test_other_maxplus_forms_still_raise(card):
    """Only the stabilizer's form carries a gradient: a reverse or
    exclusive MAXPLUS_AFFINE scan, or one over 1-D leaves, raises under
    autograd before it launches anything."""
    lf = _on_card(-torch.rand(1, 9, 4)).requires_grad_()
    li = _on_card(torch.rand(1, 9, 4)).requires_grad_()
    calls = [
        lambda: t_forge.scan(t_alg.MAXPLUS_AFFINE, (lf, li), axis=1,
                             reverse=True),
        lambda: t_forge.scan(t_alg.MAXPLUS_AFFINE, (lf, li), axis=1,
                             inclusive=False),
        lambda: t_forge.scan(t_alg.MAXPLUS_AFFINE,
                             (lf.reshape(-1), li.reshape(-1))),
        lambda: t_forge.scan(t_alg.AFFINE, (lf, li), axis=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match=r"scan@flat \(cuda\): the "
                                               r"kernel has no gradient"):
            call()
    assert card.calls == []
