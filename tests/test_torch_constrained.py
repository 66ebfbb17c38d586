"""DFA-constrained sampling and the strategy registry in the PyTorch port
against the JAX package.

On the float32 smoke gemma2 with the same numpy parameters in both
packages: the port's ``Constrained`` streams (sampled and greedy, a seeded
3-state DFA) equal the reference's, with ``seq_logprob`` within 1e-5, and
the port's own ``reference_constrained`` (the oracle over the port's
engine); no emitted token is masked in its state; staggered arrivals
recycle slots.  The tables' validation texts are the reference's.  The
registry: its names, the error for an unknown one, ``resolve_strategy``'s
forms; ``generate_padded`` and an encoder-decoder refuse a non-vanilla
strategy, as the reference's do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serving import strategies as JST  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.serving import strategies as TST  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.strategies.ref import (  # noqa: E402
    reference_constrained)
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401
from test_torch_serve_slots import smoke_configs  # noqa: E402

# As many requests as slots: the reference engine compiles one loop.
REQS = [([1, 2, 3, 4], 8, 0), ([(11 * i) % 480 + 3 for i in range(30)], 7, 1)]
KW = dict(cache_len=64, batch_size=2)
SAMPLED = dict(temperature=1.0, top_k=8, seed=5)


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = smoke_configs("gemma2-27b")
    return (cfg_j, cfg_t) + both_params(cfg_j, cfg_t, 3, torch.float32)


_ENGINES = {}


def dfa(vocab, seed=0, n_states=3, density=0.3):
    rng = np.random.default_rng(seed)
    allowed = rng.random((n_states, vocab)) < density
    allowed[:, 0] = True     # no dead states
    trans = rng.integers(0, n_states, (n_states, vocab)).astype(np.int32)
    return allowed, trans


def walk(allowed, trans, tokens, start=0):
    s = start
    for t in tokens:
        assert allowed[s, t], f"token {t} masked in state {s}"
        s = trans[s, t]


def check(models, tables, reqs, arrivals=None, **kw):
    """Both engines (built once per DFA and knobs: the reference's compiles
    its programs once) serve ``reqs``; the port's streams equal the
    reference's and its oracle's, and obey the DFA."""
    cfg_j, cfg_t, pj, pt = models
    allowed, trans = tables
    key = (allowed.tobytes(), tuple(sorted(kw.items())))
    if key not in _ENGINES:
        _ENGINES[key] = (
            JEngine(cfg_j, None, pj, **KW, **kw,
                    strategy=JST.Constrained(allowed, trans)),
            TEngine(cfg_t, pt, device="cpu", **KW, **kw,
                    strategy=TST.Constrained(allowed, trans)))
    j_eng, t_eng = _ENGINES[key]
    arrivals = arrivals or [0] * len(reqs)
    j = j_eng.serve([(a, JRequest(p, m, seed=s))
                     for a, (p, m, s) in zip(arrivals, reqs)])
    t = t_eng.serve([(a, TRequest(p, m, seed=s))
                     for a, (p, m, s) in zip(arrivals, reqs)])
    assert [r.tokens for r in t] == [r.tokens for r in j]
    np.testing.assert_allclose([r.seq_logprob for r in t],
                               [r.seq_logprob for r in j],
                               rtol=1e-5, atol=1e-5)
    for (p, m, s), rec in zip(reqs, t):
        toks, states = reference_constrained(
            t_eng, p, s, allowed=allowed, transitions=trans, max_new=m)
        assert rec.tokens == toks
        walk(allowed, trans, rec.tokens)
    return t


def test_constrained_sampled_matches_reference_and_oracle(models):
    check(models, dfa(models[1].vocab_size), REQS, **SAMPLED)


def test_constrained_greedy_never_emits_masked(models):
    tables = dfa(models[1].vocab_size, seed=2, density=0.1)
    recs = check(models, tables, REQS)
    # The mask binds: an unconstrained engine's greedy streams differ.
    cfg_t, pt = models[1], models[3]
    free = TEngine(cfg_t, pt, device="cpu", **KW).generate(
        [TRequest(p, m, seed=s) for p, m, s in REQS])
    assert free != [r.tokens for r in recs]


def test_constrained_staggered_arrivals(models):
    """Four requests through two slots, arrivals mid-flight: each stream
    is the oracle's for the request alone (the engine and the oracle are
    held to the reference above)."""
    reqs = [([1, 2, 3], 5, 0), ([4, 5], 4, 1), ([6, 7, 8], 6, 2),
            ([2, 9], 3, 3)]
    allowed, trans = dfa(models[1].vocab_size)
    eng = TEngine(models[1], models[3], device="cpu", **KW, **SAMPLED,
                  strategy=TST.Constrained(allowed, trans))
    recs = eng.serve([(a, TRequest(p, m, seed=s))
                      for a, (p, m, s) in zip([0, 0, 2, 3], reqs)])
    assert max(r.admit_step for r in recs) > 0
    for (p, m, s), rec in zip(reqs, recs):
        assert rec.tokens == reference_constrained(
            eng, p, s, allowed=allowed, transitions=trans, max_new=m)[0]
        walk(allowed, trans, rec.tokens)


def test_constrained_table_validation(models):
    cfg_j, cfg_t, pj, pt = models
    V = cfg_t.vocab_size
    ok = np.ones((2, V), bool)
    trans = np.zeros((2, V), np.int32)
    dead = ok.copy()
    dead[1] = False
    bad = trans.copy()
    bad[0, 0] = 5
    for args, kw in (((dead, trans), {}), ((ok, bad), {}),
                     ((ok, trans), {"start_state": 9}),
                     ((ok[:, :5], trans), {})):
        texts = []
        for mod in (TST, JST):
            with pytest.raises(ValueError) as e:
                mod.Constrained(*args, **kw)
            texts.append(str(e.value))
        assert texts[0] == texts[1]
    wide = (np.ones((2, V + 1), bool), np.zeros((2, V + 1), np.int32))
    texts = []
    for build in (lambda: TEngine(cfg_t, pt, device="cpu", **KW,
                                  strategy=TST.Constrained(*wide)),
                  lambda: JEngine(cfg_j, None, pj, **KW,
                                  strategy=JST.Constrained(*wide))):
        with pytest.raises(ValueError, match="vocab") as e:
            build()
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def test_registry_lists_the_reference_strategies():
    assert TST.available_strategies() == JST.available_strategies() == \
        ["beam", "constrained", "speculative", "vanilla"]
    for name in TST.available_strategies():
        assert TST.get_strategy(name).name == name


def test_registry_unknown_name_is_actionable():
    texts = []
    for mod in (TST, JST):
        with pytest.raises(ValueError, match="available") as e:
            mod.get_strategy("nonexistent")
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def test_resolve_strategy_forms():
    assert isinstance(TST.resolve_strategy(None), TST.Vanilla)
    inst = TST.BeamSearch(width=2)
    assert TST.resolve_strategy(inst) is inst
    assert isinstance(TST.resolve_strategy("vanilla"), TST.Vanilla)
    assert isinstance(TST.resolve_strategy("beam"), TST.BeamSearch)
    with pytest.raises(TypeError, match="registered name"):
        TST.resolve_strategy(42)
    # register_strategy is the decorator the built-ins go through.
    assert TST.register_strategy(TST.Vanilla) is TST.Vanilla


def test_generate_padded_refuses_non_vanilla(models):
    cfg_t, pt = models[1], models[3]
    eng = TEngine(cfg_t, pt, device="cpu", **KW,
                  strategy=TST.BeamSearch(width=2))
    with pytest.raises(NotImplementedError, match="vanilla"):
        eng.generate_padded([TRequest([1, 2], 2)])


def test_encdec_refuses_non_vanilla_strategy():
    """The constructor raises before the parameters are touched."""
    _, cfg = smoke_configs("seamless-m4t-medium")
    with pytest.raises(NotImplementedError, match="enc-dec"):
        TEngine(cfg, None, device="cpu", **KW,
                strategy=TST.BeamSearch(width=2))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        TEngine(cfg, None, device="cpu", **KW, strategy="beam")
