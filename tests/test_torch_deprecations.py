"""The port's legacy names: warn-once shims over the new surface, as the
reference's ``tests/test_deprecations.py`` holds its own.

Every ``segmented_*`` / ``batched_*`` name of ``repro_torch.core.primitives``
emits exactly one ``DeprecationWarning`` per process, forwards its kwargs
and gives the layout-polymorphic call's result to the bit; the names are
the reference's shim list.  ``force_backend`` (a warn-once global pin that a
``use_backend`` scope and an explicit ``backend=`` still beat) and the
sorts' ``sub_backend=`` alias likewise.  On the CPU both backends run the
plain versions; ``cuda`` on CPU tensors is the kernels' wrappers taking
their plain halves.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import primitives as j_forge  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.core import operators as alg  # noqa: E402
from repro_torch.core import primitives as forge  # noqa: E402
from repro_torch.core.layout import Batched, Segmented  # noqa: E402
from repro_torch.kernels import sort as sort_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

N = 64
OFFSETS = torch.tensor([0, 7, 7, 40, 64], dtype=torch.int32)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(seed, *shape):
    return torch.from_numpy(_rng(seed).standard_normal(shape).astype(
        np.float32))


def _cases():
    x2 = _f32(1, 3, 33)
    m2 = tuple(_f32(2 + i, 2, 17) for i in range(4))
    x1 = _f32(6, N)
    A3, v2, p2 = _f32(7, 2, 9, 5), _f32(8, 2, 9), _f32(9, 2, 5)
    a3 = torch.from_numpy(_rng(10).uniform(0.5, 1.0, (2, 11, 6)).astype(
        np.float32))
    b3, h0 = _f32(11, 2, 11, 6), _f32(12, 2, 6)
    flags = torch.zeros(N, dtype=torch.int32)
    flags[[0, 7, 40]] = 1
    keys = _f32(3, N)
    vals = torch.arange(N, dtype=torch.int32)
    seg = Segmented(offsets=OFFSETS)
    return [
        ("batched_scan",
         lambda: forge.batched_scan(alg.ADD, x2, inclusive=False,
                                    reverse=True, backend="torch"),
         lambda: forge.scan(alg.ADD, x2, inclusive=False, reverse=True,
                            layout=Batched(), backend="torch")),
        ("batched_mapreduce",
         lambda: forge.batched_mapreduce(lambda t: t, alg.MAT2_MUL, m2,
                                         backend="torch"),
         lambda: forge.mapreduce(lambda t: t, alg.MAT2_MUL, m2,
                                 layout=Batched(), backend="torch")),
        ("batched_matvec",
         lambda: forge.batched_matvec(alg.TIMES, alg.ADD, A3, v2,
                                      backend="torch"),
         lambda: forge.matvec(alg.TIMES, alg.ADD, A3, v2, layout=Batched(),
                              backend="torch")),
        ("batched_vecmat",
         lambda: forge.batched_vecmat(alg.TIMES, alg.MIN, A3, p2,
                                      backend="torch"),
         lambda: forge.vecmat(alg.TIMES, alg.MIN, A3, p2, layout=Batched(),
                              backend="torch")),
        ("batched_semiring_matvec",
         lambda: forge.batched_semiring_matvec(alg.ARITHMETIC, A3, v2,
                                               backend="torch"),
         lambda: forge.semiring_matvec(alg.ARITHMETIC, A3, v2,
                                       layout=Batched(), backend="torch")),
        ("batched_semiring_vecmat",
         lambda: forge.batched_semiring_vecmat(alg.ARITHMETIC, A3, p2,
                                               backend="torch"),
         lambda: forge.semiring_vecmat(alg.ARITHMETIC, A3, p2,
                                       layout=Batched(), backend="torch")),
        ("batched_linear_recurrence",
         lambda: forge.batched_linear_recurrence(a3, b3, h0, reverse=True,
                                                 backend="torch"),
         lambda: forge.linear_recurrence(a3, b3, h0, reverse=True,
                                         layout=Batched(), backend="torch")),
        ("segmented_scan",
         lambda: forge.segmented_scan(alg.ADD, x1, offsets=OFFSETS,
                                      inclusive=False, backend="torch"),
         lambda: forge.scan(alg.ADD, x1, inclusive=False, layout=seg,
                            backend="torch")),
        ("segmented_mapreduce",
         lambda: forge.segmented_mapreduce(lambda v: v, alg.MAX, x1,
                                           flags=flags, num_segments=5,
                                           backend="torch"),
         lambda: forge.mapreduce(lambda v: v, alg.MAX, x1, backend="torch",
                                 layout=Segmented(flags=flags,
                                                  num_segments=5))),
        ("segmented_sort",
         lambda: forge.segmented_sort(keys, offsets=OFFSETS,
                                      descending=True, backend="torch"),
         lambda: forge.sort(keys, descending=True, layout=seg,
                            backend="torch")),
        ("segmented_sort_pairs",
         lambda: forge.segmented_sort_pairs(keys, vals, offsets=OFFSETS,
                                            backend="torch"),
         lambda: forge.sort_pairs(keys, vals, layout=seg, backend="torch")),
        ("segmented_argsort",
         lambda: forge.segmented_argsort(keys, offsets=OFFSETS,
                                         backend="torch"),
         lambda: forge.argsort(keys, layout=seg, backend="torch")),
        ("segmented_top_k",
         lambda: forge.segmented_top_k(keys, 9, offsets=OFFSETS,
                                       largest=False, backend="torch"),
         lambda: forge.top_k(keys, 9, largest=False, layout=seg,
                             backend="torch")),
    ]


_CASES = {name: (legacy, new) for name, legacy, new in _cases()}


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


@pytest.fixture
def fresh_warn_state():
    """Reset the warn-once bookkeeping so each test observes a first call."""
    saved = set(forge._WARNED)
    forge._WARNED.clear()
    yield
    forge._WARNED.clear()
    forge._WARNED.update(saved)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_legacy_name_warns_once_and_matches_new_surface(name,
                                                        fresh_warn_state):
    legacy, new = _CASES[name]
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        got = legacy()
    deps = [w for w in first if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1, f"{name}: expected exactly one DeprecationWarning"
    assert name in str(deps[0].message)
    assert any(s in str(deps[0].message)
               for s in ("layout", "Segmented", "Batched"))
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        got2 = legacy()
    assert not [w for w in second
                if issubclass(w.category, DeprecationWarning)], (
        f"{name}: legacy shim warned twice")
    want = new()
    for g, g2, w in zip(_leaves(got), _leaves(got2), _leaves(want)):
        assert torch.equal(g, w), name
        assert torch.equal(g, g2), name


def test_legacy_names_are_the_reference_shims():
    """The port's shim list is the reference's, and every name has a case
    here."""
    def legacy(mod):
        return sorted(n for n in dir(mod)
                      if n.startswith(("segmented_", "batched_"))
                      and callable(getattr(mod, n)))
    assert legacy(forge) == legacy(j_forge) == sorted(_CASES)


def test_new_surface_does_not_warn():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        forge.scan(alg.ADD, torch.arange(8, dtype=torch.float32))
        forge.mapreduce(lambda t: t, alg.ADD, torch.ones(2, 4),
                        layout=Batched())
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


@pytest.fixture
def fresh_force_backend_state():
    """Reset the force_backend warn-once flag and any forced global."""
    saved = ki._FORCE_BACKEND_WARNED, ki._FORCED_BACKEND
    ki._FORCE_BACKEND_WARNED, ki._FORCED_BACKEND = False, None
    yield
    ki._FORCE_BACKEND_WARNED, ki._FORCED_BACKEND = saved


def test_force_backend_warns_once_and_matches_use_backend(
        fresh_force_backend_state):
    x = _f32(20, 33)
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        ki.force_backend("cuda")
    deps = [w for w in first if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1 and "use_backend" in str(deps[0].message)
    assert ki.current_backend(x) == "cuda"
    got = forge.scan(alg.ADD, x)
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        ki.force_backend(None)
    assert not [w for w in second
                if issubclass(w.category, DeprecationWarning)]
    assert ki._FORCED_BACKEND is None
    with ki.use_backend("cuda"):
        want = forge.scan(alg.ADD, x)
    assert torch.equal(got, want)


def test_use_backend_scope_and_backend_arg_beat_forced_global(
        fresh_force_backend_state, monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ki.force_backend("cuda")
    with ki.use_backend("torch"):
        assert ki.current_backend() == "torch"
    assert ki.current_backend() == "cuda"
    seen = []
    real = ki.resolve_impl
    monkeypatch.setattr(ki, "resolve_impl", lambda p, b=None, d=None:
                        seen.append(b) or real(p, b, d))
    forge.scan(alg.ADD, _f32(21, 8), backend="torch")
    assert seen == ["torch"]


@pytest.fixture
def fresh_sub_backend_state():
    saved = ki._SUB_BACKEND_WARNED
    ki._SUB_BACKEND_WARNED = False
    yield
    ki._SUB_BACKEND_WARNED = saved


def test_sub_backend_alias_warns_once_and_matches(fresh_sub_backend_state):
    keys, vals = _f32(22, 41), torch.arange(41, dtype=torch.int32)
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        got = sort_k.sort_radix(keys, sub_backend="torch")
    deps = [w for w in first if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1 and "sub_backend" in str(deps[0].message)
    with warnings.catch_warnings(record=True) as second:
        warnings.simplefilter("always")
        gk, gv = sort_k.sort_pairs_radix(keys, vals, sub_backend="cuda")
    assert not [w for w in second
                if issubclass(w.category, DeprecationWarning)]
    assert torch.equal(got, sort_k.sort_radix(keys, backend="torch"))
    wk, wv = sort_k.sort_pairs_radix(keys, vals, backend="cuda")
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def test_sub_backend_alias_rejects_both_spellings(fresh_sub_backend_state):
    with pytest.raises(TypeError, match="both backend= and"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            sort_k.sort_radix(_f32(23, 8), backend="torch",
                              sub_backend="torch")
