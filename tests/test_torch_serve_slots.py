"""The PyTorch port's slot helpers, open-loop serving and slot hygiene
against the JAX package.

* An open-loop ``serve`` trace (five requests arriving at steps 0, 2, 3, 7
  and 7 into two slots) through both engines on the float32 smoke gemma2:
  streams, submit, admit and finish steps identical, ``seq_logprob``
  within 1e-5.
* ``serving/cache.py``'s helpers against the reference's on the same numpy
  inputs, bit for bit: ``select_slots``, ``gather_slots``, ``poison_slot``,
  ``scatter_slot`` (one slot, and a batch-1 tree broadcast over a run of
  slots as beam search admits), ``quantize_kv_tree``; ``ring_slot``,
  ``slot_position``, ``SlotLedger`` and ``SlotError``.  The reference
  stacks ``units`` on a layer axis (the slot axis second); the port keeps
  a list of per-unit tuples, every leaf leading with the slot axis.
* ``ring_rows`` / ``commit_rows``: a decode step that wrote the caches in
  place, kept on one row and rolled back on the other, bit for bit.
* A slot recycled under ``poison_on_evict`` (plain and quantized KV)
  serves exactly what a fresh engine does (the reference's
  ``tests/test_cache.py`` checks).

``engine_pair`` and ``smoke_configs`` are imported by the other files of
the slice.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.serving import cache as JCA  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.core import operators as talg  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import cache as TCA  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401


def smoke_configs(name):
    return (dataclasses.replace(JC.get_config(name, smoke=True),
                                dtype="float32"),
            dataclasses.replace(TC.get_config(name, smoke=True),
                                dtype="float32"))


def engine_pair(name, param_seed=3, **kw):
    """The reference's and the port's engines of ``name``'s float32 smoke
    config on the same numpy parameters (``both_params`` from
    ``param_seed``), with the same engine arguments; and the configs and
    parameters."""
    cfg_j, cfg_t = smoke_configs(name)
    params_j, params_t = both_params(cfg_j, cfg_t, param_seed, torch.float32)
    kw = {"cache_len": 64, "batch_size": 2, **kw}
    return (JEngine(cfg_j, None, params_j, **kw),
            TEngine(cfg_t, params_t, device="cpu", **kw),
            (cfg_j, cfg_t, params_j, params_t))


# ---------------------------------------------------------------------------
# Open-loop serve
# ---------------------------------------------------------------------------


def test_serve_open_loop_matches_reference():
    j_eng, t_eng, _ = engine_pair("gemma2-27b")
    rng = np.random.default_rng(5)
    spec = [(0, 5, 6), (2, 3, 4), (3, 9, 5), (7, 2, 3), (7, 12, 4)]
    prompts = [rng.integers(0, 512, n).tolist() for _, n, _ in spec]
    j_recs = j_eng.serve([(a, JRequest(prompt=p, max_new_tokens=m))
                          for (a, _, m), p in zip(spec, prompts)])
    t_recs = t_eng.serve([(a, TRequest(prompt=p, max_new_tokens=m))
                          for (a, _, m), p in zip(spec, prompts)])
    assert [r.tokens for r in t_recs] == [r.tokens for r in j_recs]
    for key in ("submit_step", "admit_step", "finish_step", "slot", "seed"):
        assert [getattr(r, key) for r in t_recs] == \
            [getattr(r, key) for r in j_recs], key
    np.testing.assert_allclose([r.seq_logprob for r in t_recs],
                               [r.seq_logprob for r in j_recs],
                               rtol=1e-5, atol=1e-5)
    for key in ("admissions", "loop_dispatches", "decode_steps",
                "final_step", "total_tokens"):
        assert t_eng.last_stats[key] == j_eng.last_stats[key], key


# ---------------------------------------------------------------------------
# The slot helpers against the reference's
# ---------------------------------------------------------------------------

B, L, U, D = 4, 8, 3, 5


def _np_tree(seed=0):
    """Leaves in the port's layout (numpy): the slot axis first."""
    rng = np.random.default_rng(seed)
    return {
        "prefix": [{"k": rng.normal(size=(B, L, 2, D)).astype(np.float32),
                    "pos": rng.integers(-9, 9, B).astype(np.int32)}],
        "units": [({"k": rng.normal(size=(B, L, 2, D)).astype(np.float32),
                    "h": rng.normal(size=(B, D)).astype(np.float32),
                    "code": rng.integers(0, 255, (B, D)).astype(np.uint8)},)
                  for _ in range(U)],
        "suffix": [{"conv": rng.normal(size=(B, 4, D)).astype(np.float32),
                    "v": rng.normal(size=(B, L, 2, D)).astype(np.float32)}],
    }


def _to_ref(tree):
    """The reference's layout: ``units`` stacked on a leading layer axis."""
    units = jax.tree.map(lambda *ls: np.stack(ls), *tree["units"])
    return jax.tree.map(jnp.asarray, {**tree, "units": units})


def _to_port(tree):
    return torch.utils._pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _ref_to_np(tree):
    """The reference's tree back in the port's layout (numpy)."""
    tree = jax.tree.map(np.asarray, tree)
    units = tree["units"]
    n = jax.tree.leaves(units)[0].shape[0]
    return {**tree, "units": [jax.tree.map(lambda l, u=u: l[u], units)
                              for u in range(n)]}


def by_path(tree, path=()):
    """{path: numpy leaf} of a cache tree of either package (a KVQuant as
    its ``values`` and ``scales``)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in by_path(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in by_path(x, path + (i,)).items()}
    if hasattr(tree, "scales"):
        return {path + ("values",): by_path(tree.values)[()],
                path + ("scales",): by_path(tree.scales)[()]}
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().cpu().numpy()}
    return {path: np.asarray(tree)}


def _assert_same(t_tree, r_tree):
    got, want = by_path(t_tree), by_path(_ref_to_np(r_tree))
    assert sorted(got, key=str) == sorted(want, key=str)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def _helper_cases():
    rng = np.random.default_rng(1)
    mask = rng.random(B) < 0.5
    rows = rng.integers(0, B, B).astype(np.int32)
    one = jax.tree.map(lambda a: a[1:2] + 1, _np_tree(2))
    two = jax.tree.map(lambda a: a[:1] * 3, _np_tree(3))
    return {
        "select_slots": (
            lambda t: TCA.select_slots(torch.from_numpy(mask), t,
                                       _to_port(_np_tree(4))),
            lambda r: JCA.select_slots(jnp.asarray(mask), r,
                                       _to_ref(_np_tree(4)))),
        "gather_slots": (
            lambda t: TCA.gather_slots(t, torch.from_numpy(rows)),
            lambda r: JCA.gather_slots(r, jnp.asarray(rows))),
        "poison_slot": (
            lambda t: TCA.poison_slot(t, 2),
            lambda r: JCA.poison_slot(r, 2)),
        "scatter_slot": (
            # One slot, then a batch-1 tree broadcast over two slots.
            lambda t: TCA.scatter_slot(
                TCA.scatter_slot(t, _to_port(one), 3),
                torch.utils._pytree.tree_map(
                    lambda l: l.expand((2,) + l.shape[1:]), _to_port(two)),
                1),
            lambda r: JCA.scatter_slot(
                JCA.scatter_slot(r, _to_ref(one), 3),
                jax.tree.map(lambda l: jnp.repeat(l, 2, axis=0)
                             if l.ndim and l.shape[0] == 1
                             else jnp.repeat(l, 2, axis=1), _to_ref(two)),
                1)),
        "quantize_kv_tree": (
            lambda t: TCA.quantize_kv_tree(t, "int8"),
            lambda r: JCA.quantize_kv_tree(r, "int8")),
    }


@pytest.mark.parametrize("name", ["select_slots", "gather_slots",
                                  "poison_slot", "scatter_slot",
                                  "quantize_kv_tree"])
def test_slot_helper_matches_reference(name):
    port_fn, ref_fn = _helper_cases()[name]
    got = port_fn(_to_port(_np_tree()))
    want = ref_fn(_to_ref(_np_tree()))
    _assert_same(got, want)
    if name == "quantize_kv_tree":
        # The rank-4 k and v leaves became KVQuant nodes, nothing else.
        assert isinstance(got["prefix"][0]["k"], talg.KVQuant)
        assert isinstance(got["suffix"][0]["v"], talg.KVQuant)
        assert not isinstance(got["suffix"][0]["conv"], talg.KVQuant)


def test_ring_address_and_ledger_match_reference():
    pos = np.arange(-3, 40)
    for window in (1, 5, 8, 32):
        np.testing.assert_array_equal(
            TCA.ring_slot(torch.from_numpy(pos), window).numpy(),
            np.asarray(JCA.ring_slot(jnp.asarray(pos), window)))
        for s in range(window):
            np.testing.assert_array_equal(
                TCA.slot_position(s, torch.from_numpy(pos), window).numpy(),
                np.asarray(JCA.slot_position(s, jnp.asarray(pos), window)))
        assert TCA.ring_slot(37, window) == int(JCA.ring_slot(37, window))
    t, r = TCA.SlotLedger(4, 16), JCA.SlotLedger(4, 16)
    for led in (t, r):
        led.occupy(0, 5)
        led.occupy(2, 16)
        led.advance(0, 3)
        led.advance(2, 4)              # clamped at cache_len
        led.occupy(3, 1)
        led.free(3)
    np.testing.assert_array_equal(t.offsets().numpy(), np.asarray(r.offsets()))
    assert t.offsets().dtype == torch.int32
    assert [t.segment_of(s) for s in range(4)] == \
        [r.segment_of(s) for s in range(4)]
    assert issubclass(TCA.SlotError, IndexError)
    for slot in (-1, 4):
        for fn in (lambda: t.occupy(slot, 2), lambda: t.advance(slot),
                   lambda: t.free(slot), lambda: t.segment_of(slot)):
            with pytest.raises(TCA.SlotError, match="outside"):
                fn()
    with pytest.raises(ValueError, match="length"):
        t.occupy(1, 17)
    np.testing.assert_array_equal(t.lengths, r.lengths)


# ---------------------------------------------------------------------------
# Rolling back an in-place decode step on some rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma2-27b", "recurrentgemma-2b"])
def test_commit_rows_rolls_back_an_in_place_step(name):
    """A decode step at positions past the smoke window of 32 (the local
    ring wraps) writes the caches in place; ``commit_rows`` keeps it on row
    0 and gives row 1 back its earlier state, every leaf bit for bit: ring
    leaves one slot a row, recurrent states by row."""
    _, cfg = smoke_configs(name)
    params = tlm.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, 512, (2, 40)))
    _, caches = tlm.prefill(params, cfg, toks, cache_len=64)
    before = torch.utils._pytree.tree_map(torch.clone, caches)
    pos = torch.tensor([40, 40], dtype=torch.int32)
    step = torch.tensor([[7], [9]])
    _, advanced = tlm.decode_step(
        params, cfg, torch.utils._pytree.tree_map(torch.clone, before), step,
        pos)
    saved = TCA.ring_rows(caches, pos)
    _, new = tlm.decode_step(params, cfg, caches, step, pos)
    kept = TCA.commit_rows(torch.tensor([True, False]), new, caches, saved,
                           pos)
    for got, adv, old in zip(*(torch.utils._pytree.tree_leaves(t)
                               for t in (kept, advanced, before))):
        assert torch.equal(got[0], adv[0])
        assert torch.equal(got[1], old[1])
    assert any(not torch.equal(a[0], o[0]) for a, o in zip(
        *(torch.utils._pytree.tree_leaves(t) for t in (advanced, before))))


# ---------------------------------------------------------------------------
# Slot hygiene under poison_on_evict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [None, "int8", "fp8_e4m3"])
def test_recycled_poisoned_slot_serves_as_a_fresh_engine(mode):
    """Two requests through ONE slot, the freed slot NaN-poisoned: the
    second request's stream is a fresh engine's, and no score is NaN."""
    _, cfg = smoke_configs("gemma2-27b")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    ra = TRequest([3, 1, 4], max_new_tokens=5, seed=7)
    rb = TRequest([2, 7, 2], max_new_tokens=5, seed=9)
    kw = dict(cache_len=32, batch_size=1, temperature=0.7, top_k=8,
              quantize_kv=mode, device="cpu")
    eng = TEngine(cfg, params, poison_on_evict=True, **kw)
    out_both = eng.generate([ra, rb])           # rb recycles ra's slot
    out_fresh = TEngine(cfg, params, **kw).generate([rb])
    assert out_both[1] == out_fresh[0]
    assert not np.isnan(eng.last_scores).any()
    # The freed slot is poisoned after the drain: NaN floats, -1 codes.
    state = eng._fresh_state()
    state = eng.strategy.poison(eng, state["caches"], 0)
    for leaf in torch.utils._pytree.tree_leaves(state):
        if leaf.is_floating_point():
            assert torch.isnan(leaf[0]).all()
        else:
            assert (leaf[0] == leaf.new_full((), -1)).all()
