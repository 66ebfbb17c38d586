"""The port's autotuner (``repro_torch/core/tuning.py``) and its tuning
policies (``core/intrinsics.py``), held against the reference's
``repro.core.tuning`` where the two must agree: ``shape_bucket``, each
tunable route's keyer ``(op, dtype, n[, batch])`` on the same numpy
inputs, the cache key up to its platform part, and each route's ladder
(the sharded routes' aside; ``linear_recurrence@batched`` without the 32
its K6 cannot take).

The tuner's own behavior runs on the CPU through the ``cuda`` rows on CPU
tensors (each wrapper's plain version) with the timer replaced: CUDA
events need the card.  The host-side race drives the real wrappers on
tensors that say they lie on the card and a stand-in library
(``test_torch_primitives``'s), which records each unit loaded and each
entry called: every candidate's call carries its knob, a hit makes one
call.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as j_alg  # noqa: E402
from repro.core import tuning as j_tuning  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as forge  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.layout import Batched, Segmented  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import copy as copy_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_primitives import _Entries, _on_card  # noqa: E402


def _np(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _route_args(route):
    """(reference args, port args) of one call of ``route``: the same numpy
    data in both packages."""
    x = _np(0, 3000)
    x2, A3 = _np(1, 5, 300), _np(2, 3, 100, 9000)
    a3 = _np(3, 2, 1000, 70)
    keys = np.random.default_rng(4).integers(0, 2**31, 5000).astype(
        np.uint32)
    jx = {"x": jnp.asarray(x), "x2": jnp.asarray(x2), "A3": jnp.asarray(A3),
          "a3": jnp.asarray(a3), "keys": jnp.asarray(keys),
          "xb": jnp.asarray(x, jnp.bfloat16)}
    tx = {"x": torch.from_numpy(x), "x2": torch.from_numpy(x2),
          "A3": torch.from_numpy(A3), "a3": torch.from_numpy(a3),
          "keys": torch.from_numpy(keys.astype(np.int64)).to(torch.uint32),
          "xb": torch.from_numpy(x).to(torch.bfloat16)}

    def both(make):
        return make(jx, j_alg), make(tx, t_alg)

    prim, layout = route.split("@")
    if prim == "copy":
        return both(lambda d, a: (d["x"],))
    if prim == "scan":
        data = {"flat": "xb", "batched": "x2", "segmented": "x"}[layout]
        return both(lambda d, a: (a.MAX, d[data]))
    if prim == "mapreduce":
        data = "x2" if layout == "batched" else "x"
        return both(lambda d, a: (None, a.ADD, d[data]))
    if prim in ("matvec", "vecmat"):
        return both(lambda d, a: (None, a.ADD, d["A3"], d["x2"]))
    if prim == "linear_recurrence":
        return both(lambda d, a: (d["a3"], d["a3"]))
    if prim == "sort_pairs":
        return both(lambda d, a: (d["keys"], d["x"]))
    if prim == "top_k":
        return both(lambda d, a: (d["keys"], 7))
    return both(lambda d, a: (d["keys"],))


@pytest.mark.parametrize("route", sorted(tuning.TUNABLE))
def test_keys_and_ladders_match_the_reference(route):
    """Every tunable route: the port's keyer gives the reference's (op,
    dtype, n, batch) on the same inputs, the cache key matches up to its
    platform part, and the ladder is the reference's (K6 leaves out 32)."""
    spec, jspec = tuning.TUNABLE[route], j_tuning.TUNABLE[route]
    want = list(jspec.candidates)
    if route == "linear_recurrence@batched":
        want = [c for c in want if c["nitem_scan"] != 32]
    assert list(spec.candidates) == want
    jargs, targs = _route_args(route)
    jkey, tkey = jspec.keyer(jargs, {}), spec.keyer(targs, {})
    assert tkey == jkey[:4] and jkey[4] is None
    jt, tt = j_tuning.Autotuner.__new__(j_tuning.Autotuner), \
        tuning.Autotuner.__new__(tuning.Autotuner)
    prefix = lambda k: k.split("|platform=")[0]  # noqa: E731
    assert prefix(tt.make_key(route, "cuda", *tkey)) == prefix(
        jt.make_key(route, "cuda", *jkey))
    for n in (0, 1, 2, 3, 1000, 4096, 4097, 10**8):
        assert tuning.shape_bucket(n) == j_tuning.shape_bucket(n)


def test_chip_table_and_the_untuned_launch(monkeypatch):
    """``detect_chip`` reads the card's name; the GPU family's policies
    launch what the kernels launch with no policy (every knob field at the
    wrappers' default); the TPU and interpret entries are not
    registered; an unknown name resolves through ``generic``."""
    for name, chip in (("NVIDIA H100 80GB HBM3", "gpu_h100"),
                       ("NVIDIA A100-SXM4-40GB", "gpu_a100"),
                       ("AMD Instinct MI300X", "gpu_mi300"),
                       ("NVIDIA L4", "gpu_generic")):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
        ki.detect_chip.cache_clear()
        assert ki.detect_chip() == chip
        assert ki.resolve_tuning().name == chip
    monkeypatch.undo()
    ki.detect_chip.cache_clear()
    assert ki.detect_chip() == "generic"
    default = ki.TuningPolicy()
    for name in ("gpu_generic", "gpu_a100", "gpu_h100", "gpu_mi300"):
        assert dataclasses.replace(ki.resolve_tuning(name),
                                   name="generic") == default
    assert (default.nitem_copy, default.nitem_scan, default.nitem_reduce,
            default.matvec_rows, default.vecmat_rows,
            default.sort_digit_bits) == (copy_k.NITEM_DEFAULT,
                                         _lib.DEFAULT_NITEM,
                                         _lib.DEFAULT_NITEM, 8, 8, 8)
    assert not {"tpu_v5e", "tpu_v5p", "interpret", "gpu_interpret"} & set(
        ki._TUNING_REGISTRY)
    assert ki.resolve_tuning("tpu_v5p").name == "generic"
    assert {f.name for f in dataclasses.fields(ki.TuningPolicy)} == {
        f.name for f in dataclasses.fields(
            __import__("repro.core.intrinsics",
                       fromlist=["TuningPolicy"]).TuningPolicy)}


class _Clock:
    """The timer of a race on the CPU: each candidate's call runs once and
    takes the next of ``times`` seconds."""

    def __init__(self, times):
        self.times, self.timed = list(times), 0

    def __call__(self, tuner, fn):
        fn()
        self.timed += 1
        return self.times[(self.timed - 1) % len(self.times)]


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    clock = _Clock([3.0, 1.0, 2.0, 4.0])
    monkeypatch.setattr(tuning.Autotuner, "_time",
                        lambda self, fn: clock(self, fn))
    t = tuning.enable(str(tmp_path / "tuning.json"))
    t.clock = clock
    yield t
    tuning.disable()


def test_first_call_races_second_call_hits_across_instances(tuner):
    """The first call races the ladder and caches the winner (the second
    candidate here); the same key hits, in this tuner and in a fresh one
    on the same file, without a race; results equal the untuned call's."""
    x = torch.arange(4096, dtype=torch.float32)
    want = forge.scan(t_alg.ADD, x)
    with ki.use_backend("cuda"):
        got = forge.scan(t_alg.ADD, x)
        assert tuner.stats["benchmarks"] == 1
        assert tuner.stats["bench_calls"] == len(
            tuning.TUNABLE["scan@flat"].candidates)
        assert torch.equal(got, want)
        (key, entry), = json.load(open(tuner.cache_path)).items()
        assert key.startswith("scan@flat|op=add|dtype=float32|n=4096|"
                              "backend=cuda|platform=")
        assert entry["overrides"] == {"nitem_scan": 8}
        assert tuner.last_race["winner"] == {"nitem_scan": 8}
        assert torch.equal(forge.scan(t_alg.ADD, x * 2), want * 2)
        assert tuner.stats["benchmarks"] == 1 and tuner.stats["hits"] == 1
        fresh = tuning.enable(tuner.cache_path)
        forge.scan(t_alg.ADD, x + 3)
        assert fresh.stats == {"benchmarks": 0, "hits": 1, "bench_calls": 0}


def test_keys_separate_and_share_by_bucket(tuner):
    """Another operator or dtype tunes apart; extents of one bucket share
    an entry; a batch of another bucket tunes apart, one race a batch."""
    with ki.use_backend("cuda"):
        forge.scan(t_alg.ADD, torch.ones(3000))
        forge.scan(t_alg.ADD, torch.ones(4000))            # same bucket
        assert tuner.stats["benchmarks"] == 1
        forge.scan(t_alg.MAX, torch.ones(3000))
        forge.scan(t_alg.ADD, torch.ones(3000, dtype=torch.float64))
        assert tuner.stats["benchmarks"] == 3
        forge.scan(t_alg.ADD, torch.ones(4, 4096), layout=Batched())
        forge.scan(t_alg.ADD, torch.ones(3, 4096), layout=Batched())
        assert tuner.stats["benchmarks"] == 4
        forge.scan(t_alg.ADD, torch.ones(32, 4096), layout=Batched())
        assert tuner.stats["benchmarks"] == 5
    batched = sorted(k for k in tuner._cache if k.startswith("scan@batched"))
    assert "|n=4096|batch=4|" in batched[1] and "|batch=32|" in batched[0]


def test_what_is_not_tuned(tuner):
    """An explicit ``policy=`` bypasses the tuner; the torch backend is
    never tuned; a call on meta tensors runs the prior policy and leaves
    its key unset; with the tuner disabled the hook is gone."""
    x = torch.arange(1024, dtype=torch.float32)
    impl = ki.resolve_impl("scan@flat", "cuda")
    impl(t_alg.ADD, x, policy=ki.resolve_tuning("gpu_h100"))
    forge.scan(t_alg.ADD, x, backend="torch")
    assert ki.resolve_impl("scan@flat", "torch") is \
        ki._IMPL_REGISTRY[("scan@flat", "torch")]
    seen = []
    impl_meta = tuning._hook("copy@flat", "cuda", lambda *a, **k:
                             seen.append(k.get("policy")))
    impl_meta(torch.empty(8, device="meta"))
    assert seen == [None] and tuner.stats["benchmarks"] == 0
    assert tuner._cache == {}
    tuning.disable()
    assert ki._TUNER_HOOK is None and tuning.active() is None
    assert ki.resolve_impl("scan@flat", "cuda") is \
        ki._IMPL_REGISTRY[("scan@flat", "cuda")]


def test_segmented_and_sort_races_stay_correct(tuner):
    """A segmented scan and the sort race their ladders (the sort's digit
    width x nitem_scan) and give the untuned answer."""
    x = torch.arange(3000, dtype=torch.float32)
    offs = torch.tensor([0, 100, 2500, 3000], dtype=torch.int32)
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 256).astype(np.uint8))
    want = forge.scan(t_alg.ADD, x, layout=Segmented(offsets=offs))
    want_sorted = forge.sort(keys)
    with ki.use_backend("cuda"):
        got = forge.scan(t_alg.ADD, x, layout=Segmented(offsets=offs))
        got_sorted = forge.sort(keys)
    assert torch.equal(got, want) and torch.equal(got_sorted, want_sorted)
    sort_key, = (k for k in tuner._cache if k.startswith("sort@flat|"))
    assert set(tuner._cache[sort_key]["overrides"]) == {"sort_digit_bits",
                                                        "nitem_scan"}
    assert tuner.stats["benchmarks"] == 2


def test_corrupt_cache_re_tunes_instead_of_raising(tmp_path, monkeypatch):
    clock = _Clock([1.0])
    monkeypatch.setattr(tuning.Autotuner, "_time",
                        lambda self, fn: clock(self, fn))
    path = tmp_path / "tuning.json"
    path.write_text('{"scan@flat|op=add|dtype=float32|n=4096"')  # truncated
    t = tuning.enable(str(path))
    try:
        with ki.use_backend("cuda"):
            forge.scan(t_alg.ADD, torch.ones(4096))
        assert t.stats["benchmarks"] == 1
        assert len(json.load(open(path))) == 1
    finally:
        tuning.disable()


def test_concurrent_writers_merge_not_clobber(tmp_path):
    path = str(tmp_path / "tuning.json")
    a, b = tuning.Autotuner(path), tuning.Autotuner(path)
    a._cache["key_a"] = {"overrides": {"nitem_scan": 8}, "seconds": 1.0}
    a._save()
    b._cache["key_b"] = {"overrides": {"nitem_scan": 16}, "seconds": 2.0}
    b._save()
    assert set(json.load(open(path))) == {"key_a", "key_b"}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_default_cache_path_and_env(monkeypatch, tmp_path):
    """``REPRO_TUNING_CACHE`` moves the cache; the default is the port's
    own file; ``REPRO_AUTOTUNE`` turns the tuner on, unset or 0 leaves it
    off."""
    monkeypatch.delenv("REPRO_TUNING_CACHE", raising=False)
    assert tuning.default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "tuning.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "t.json"))
    for value, on in (("0", False), ("", False), ("1", True)):
        monkeypatch.setenv("REPRO_AUTOTUNE", value)
        tuning.maybe_enable_from_env()
        assert (tuning.active() is not None) == on
        tuning.disable()
    assert tuning.Autotuner().cache_path == str(tmp_path / "t.json")


@pytest.fixture
def card(monkeypatch):
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(_lib, "_PLANS", {})
    return lib


def test_host_side_race_carries_each_knob(card, tuner):
    """On tensors that say they lie on the card: K1's race calls its entry
    once a candidate with builds deferred, then once more each to time
    it, each call with that candidate's vectors a thread; K2's race loads one unit a candidate,
    each with its NITEM.  A hit makes one entry call, with the winner's
    knob."""
    x = _on_card(torch.ones(4096))
    forge.copy(x)
    ladder = [c["nitem_copy"] for c in tuning.TUNABLE["copy@flat"].candidates]
    nitems = [args[3] for name, args in card.calls if name == "rt_copy"]
    assert nitems == ladder + ladder + [ladder[1]]
    card.calls.clear()
    forge.copy(x)
    (name, args), = card.calls
    assert name == "rt_copy" and args[3] == ladder[1]
    card.calls.clear()
    card.loaded.clear()
    forge.scan(t_alg.ADD, _on_card(torch.ones(1000)))
    knobs = [c["nitem_scan"] for c in tuning.TUNABLE["scan@flat"].candidates]
    sources = [u.source for u in card.loaded]
    for k in knobs:
        assert any(f"constexpr int NITEM = {k};" in s for s in sources)
    card.calls.clear()
    forge.scan(t_alg.ADD, _on_card(torch.ones(1000)))
    assert [c[0] for c in card.calls] == ["rt_scan_tile"]
