"""Beam search in the PyTorch port against the JAX package.

On the float32 smoke gemma2 with the same numpy parameters in both
packages, the port's ``BeamSearch`` at widths 1, 2 and 4 gives the
reference's ``BeamSearch`` hypotheses, with ``seq_logprob`` within 1e-5,
and the port's own ``reference_beam`` (the oracle over the port's engine)
to the bit.  EOS routes hypotheses to the finished store, the GNMT length
penalty reranks them, staggered arrivals recycle slots (the cache at
``batch_size * width`` rows), ``poison_on_evict`` poisons every beam row
of a freed slot, and an engine that samples is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.strategies import BeamSearch as JBeam  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.strategies import BeamSearch as TBeam  # noqa: E402
from repro_torch.serving.strategies.ref import reference_beam  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401
from test_torch_serve_slots import smoke_configs  # noqa: E402

# As many requests as slots: the reference engine compiles one loop.
REQS = [([1, 2, 3, 4], 8), ([(11 * i) % 480 + 3 for i in range(30)], 7)]
KW = dict(cache_len=64, batch_size=2)


class Models:
    """gemma2 smoke in both packages, and each beam configuration's pair
    of engines built once (the reference's compiles its programs once)."""

    def __init__(self):
        self.cfg_j, self.cfg_t = smoke_configs("gemma2-27b")
        self.pj, self.pt = both_params(self.cfg_j, self.cfg_t, 3,
                                       torch.float32)
        self._engines = {}

    def engines(self, **beam):
        key = tuple(sorted(beam.items()))
        if key not in self._engines:
            self._engines[key] = (
                JEngine(self.cfg_j, None, self.pj, **KW,
                        strategy=JBeam(**beam)),
                TEngine(self.cfg_t, self.pt, device="cpu", **KW,
                        strategy=TBeam(**beam)))
        return self._engines[key]


@pytest.fixture(scope="module")
def models():
    return Models()


def check(models, reqs, arrivals=None, **beam):
    """Both engines serve ``reqs``; the port's hypotheses equal the
    reference's and its oracle's.  Returns the port's outputs."""
    j_eng, t_eng = models.engines(**beam)
    arrivals = arrivals or [0] * len(reqs)
    j = j_eng.serve([(a, JRequest(p, m, eos_id=e))
                     for a, (p, m, e) in zip(arrivals, reqs)])
    t = t_eng.serve([(a, TRequest(p, m, eos_id=e))
                     for a, (p, m, e) in zip(arrivals, reqs)])
    assert [r.tokens for r in t] == [r.tokens for r in j]
    np.testing.assert_allclose([r.seq_logprob for r in t],
                               [r.seq_logprob for r in j],
                               rtol=1e-5, atol=1e-5)
    for (p, m, e), rec in zip(reqs, t):
        toks, score = reference_beam(
            t_eng, p, width=beam["width"], max_new=m, eos_id=e,
            length_penalty=beam.get("length_penalty", 0.0))
        assert rec.tokens == toks
        assert rec.seq_logprob == score
    return t


@pytest.mark.parametrize("width", [1, 2, 4])
def test_beam_matches_reference_and_oracle(models, width):
    recs = check(models, [(p, m, -1) for p, m in REQS], width=width)
    assert [len(r.tokens) for r in recs] == [m for _, m in REQS]


def _eos_reqs(models):
    """EOS set to the third token of each request's width-2 hypothesis,
    so that the beams reach it."""
    _, t_eng = models.engines(width=2)
    outs = t_eng.generate([TRequest(p, m) for p, m in REQS])
    return [(p, m + 2, o[2]) for (p, m), o in zip(REQS, outs)]


def test_beam_eos_routes_to_the_finished_store(models):
    reqs = _eos_reqs(models)
    recs = check(models, reqs, width=2)
    assert any(r.tokens[-1] == e for r, (_, _, e) in zip(recs, reqs))


def test_beam_length_penalty(models):
    reqs = _eos_reqs(models)
    check(models, reqs, width=2, length_penalty=0.6)
    # alpha = 0 is the default, to the bit.
    _, t0 = models.engines(width=2)
    tz = TEngine(models.cfg_t, models.pt, device="cpu", **KW,
                 strategy=TBeam(width=2, length_penalty=0.0))
    assert t0.generate([TRequest(p, m) for p, m, _ in reqs]) == \
        tz.generate([TRequest(p, m) for p, m, _ in reqs])
    assert t0.last_stats["seq_logprob"] == tz.last_stats["seq_logprob"]


def test_beam_staggered_arrivals_and_poisoned_slots(models):
    """Four requests through two slots, arrivals mid-flight, every freed
    slot's beam rows poisoned: each request as the oracle has it alone
    (the engine and the oracle are held to the reference above)."""
    reqs = [([1, 2, 3], 5, -1), ([4, 5], 4, -1), ([6, 7, 8], 6, -1),
            ([2, 9], 3, -1)]
    eng = TEngine(models.cfg_t, models.pt, device="cpu", **KW,
                  poison_on_evict=True, strategy=TBeam(width=2))
    recs = eng.serve([(a, TRequest(p, m)) for a, (p, m, _) in
                      zip([0, 0, 2, 3], reqs)])
    for (p, m, _), rec in zip(reqs, recs):
        assert rec.tokens == reference_beam(eng, p, width=2, max_new=m)[0]
    caches = eng.strategy.poison(eng, eng._fresh_state()["caches"], 1)
    for leaf in torch.utils._pytree.tree_leaves(caches):
        assert torch.isnan(leaf[2:4]).all() and not torch.isnan(leaf[:2]).any()


def test_beam_refuses_sampling_and_bad_arguments(models):
    with pytest.raises(ValueError, match="deterministic"):
        TEngine(models.cfg_t, models.pt, device="cpu", **KW,
                temperature=1.0, strategy=TBeam(width=2))
    with pytest.raises(ValueError, match="width"):
        TBeam(width=0)
    with pytest.raises(ValueError, match="length_penalty"):
        TBeam(width=2, length_penalty=-0.5)
