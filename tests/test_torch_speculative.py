"""Speculative decoding in the PyTorch port against the JAX package.

On the float32 smoke gemma2 (and recurrentgemma-2b) with the same numpy
parameters in both packages, a draft from other parameters: the port's
``Speculative`` streams equal its own ``Vanilla``'s and the reference's
``Speculative``'s, greedy (k of 1, 2 and 4) and sampled, with the
``spec_*`` stats and the per-request ``meta`` equal to the reference's.  A
perfect draft (the target itself) accepts every proposal, as the rounds
and meta it must give show; a mismatched
draft over a prompt of 28 tokens and 10 new ones runs the local ring of 32
past its window, where a rejected proposal's in-place cache write must be
rolled back or the next query reads it.  Bucketed prefill composes with
it; staggered arrivals recycle slots; the draft stream's key is the
reference's; the constructor and ``bind`` refuse what the reference's do.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serving import sampling as JSP  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.strategies import Speculative as JSpec  # noqa: E402
from repro_torch.serving import sampling as TSP  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro_torch.serving.strategies import Speculative as TSpec  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401
from test_torch_serve_slots import smoke_configs  # noqa: E402

# As many requests as slots: the reference engine compiles one loop (a
# waiting request would add its stop-on-free variant).
REQS = [([1, 2, 3, 4], 8, 0),
        ([(11 * i) % 480 + 3 for i in range(20)], 9, 1)]
KW = dict(cache_len=64, batch_size=2)


class Models:
    """Target and draft of one smoke config, in both packages."""

    def __init__(self, name):
        self.cfg_j, self.cfg_t = smoke_configs(name)
        self.pj, self.pt = both_params(self.cfg_j, self.cfg_t, 3,
                                       torch.float32)
        self.dj, self.dt = both_params(self.cfg_j, self.cfg_t, 7,
                                       torch.float32)

    def engines(self, k, draft="other", **kw):
        dj, dt = (self.pj, self.pt) if draft == "self" else (self.dj,
                                                             self.dt)
        kw = {**KW, **kw}
        return (JEngine(self.cfg_j, None, self.pj, **kw,
                        strategy=JSpec(self.cfg_j, dj, k=k)),
                TEngine(self.cfg_t, self.pt, device="cpu", **kw,
                        strategy=TSpec(self.cfg_t, dt, k=k)))

    def vanilla(self, **kw):
        return TEngine(self.cfg_t, self.pt, device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def gemma():
    return Models("gemma2-27b")


def serve_both(j_eng, t_eng, reqs, arrivals=None):
    arrivals = arrivals or [0] * len(reqs)
    j = j_eng.serve([(a, JRequest(p, m, seed=s))
                     for a, (p, m, s) in zip(arrivals, reqs)])
    t = t_eng.serve([(a, TRequest(p, m, seed=s))
                     for a, (p, m, s) in zip(arrivals, reqs)])
    return j, t


def check_against_reference(j_eng, t_eng, j_recs, t_recs):
    assert [r.tokens for r in t_recs] == [r.tokens for r in j_recs]
    assert [r.meta for r in t_recs] == [r.meta for r in j_recs]
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "decode_steps", "final_step"):
        assert t_eng.last_stats[key] == j_eng.last_stats[key], key
    np.testing.assert_allclose([r.seq_logprob for r in t_recs],
                               [r.seq_logprob for r in j_recs],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculative_greedy_matches_vanilla_and_reference(gemma, k):
    j_eng, t_eng = gemma.engines(k)
    j_recs, t_recs = serve_both(j_eng, t_eng, REQS)
    check_against_reference(j_eng, t_eng, j_recs, t_recs)
    assert [r.tokens for r in t_recs] == gemma.vanilla().generate(
        [TRequest(p, m, seed=s) for p, m, s in REQS])


def test_speculative_sampled_matches_vanilla_and_reference(gemma):
    kw = dict(temperature=1.0, top_k=5, seed=3)
    j_eng, t_eng = gemma.engines(3, **kw)
    j_recs, t_recs = serve_both(j_eng, t_eng, REQS)
    check_against_reference(j_eng, t_eng, j_recs, t_recs)
    assert [r.tokens for r in t_recs] == gemma.vanilla(**kw).generate(
        [TRequest(p, m, seed=s) for p, m, s in REQS])


def test_perfect_draft_accepts_every_proposal(gemma):
    """The target as its own draft: every proposal is accepted, so each
    round emits k + 1 tokens until the length cap."""
    k = 4
    _, t_eng = gemma.engines(k, draft="self")
    t_recs = t_eng.serve([TRequest(p, m, seed=s) for p, m, s in REQS])
    assert [r.tokens for r in t_recs] == gemma.vanilla().generate(
        [TRequest(p, m, seed=s) for p, m, s in REQS])
    for rec in t_recs:
        loop_tokens = len(rec.tokens) - 1          # the first at admission
        assert rec.meta["spec_rounds"] == math.ceil(loop_tokens / (k + 1))
        assert rec.meta["spec_accepted"] + rec.meta["spec_rounds"] == \
            loop_tokens
    reqs16 = [([3, 1, 4, 1, 5], 16, 0)]            # 15 = 3 rounds of 5
    t_eng.generate([TRequest(p, m, seed=s) for p, m, s in reqs16])
    assert t_eng.last_stats["spec_acceptance_rate"] == 1.0


@pytest.mark.parametrize("name", ["gemma2-27b", "recurrentgemma-2b"])
def test_mismatched_draft_over_a_wrapping_ring(name):
    """Sampled over the whole vocabulary, so that the streams vary (greedy
    smoke streams repeat a token, which a mismatched draft then guesses);
    positions 28 to 38 and the rejected proposals' writes past them wrap
    the ring of 32."""
    models = Models(name)
    kw = dict(temperature=1.0, seed=3)
    reqs = [([(13 * i) % 490 + 5 for i in range(28)], 10, 0),
            ([(17 * i) % 470 + 2 for i in range(28)], 10, 1)]
    j_eng, t_eng = models.engines(4, **kw)
    j_recs, t_recs = serve_both(j_eng, t_eng, reqs)
    check_against_reference(j_eng, t_eng, j_recs, t_recs)
    want = models.vanilla(**kw).generate(
        [TRequest(p, m, seed=s) for p, m, s in reqs])
    assert [r.tokens for r in t_recs] == want
    assert all(len(set(o)) > 3 for o in want)
    assert t_eng.last_stats["spec_acceptance_rate"] < 0.5


def test_speculative_with_bucketed_prefill(gemma):
    """Buckets feed both models' caches: the streams and the stats are the
    exact-length speculative engine's (held to the reference above)."""
    _, exact = gemma.engines(2)
    _, t_eng = gemma.engines(2, prefill_buckets="pow2")
    reqs = [TRequest(p, m, seed=s) for p, m, s in REQS]
    assert t_eng.generate(reqs) == exact.generate(reqs) == \
        gemma.vanilla().generate(reqs)
    for key in ("spec_rounds", "spec_proposed", "spec_accepted"):
        assert t_eng.last_stats[key] == exact.last_stats[key], key


def test_staggered_arrivals_recycle_slots(gemma):
    """Four requests through two slots with arrivals mid-flight: each
    stream is the request's vanilla stream alone."""
    reqs = [([1, 2, 3], 5, 0), ([4, 5], 4, 1), ([6, 7, 8], 6, 2),
            ([2, 9], 3, 3)]
    _, t_eng = gemma.engines(3)
    t_recs = t_eng.serve([(a, TRequest(p, m, seed=s))
                          for a, (p, m, s) in zip((0, 0, 2, 3), reqs)])
    van = gemma.vanilla()
    assert [r.tokens for r in t_recs] == [
        van.generate([TRequest(p, m, seed=s)])[0] for p, m, s in reqs]


def test_draft_stream_key_matches_reference():
    assert TSP.DRAFT_STREAM == JSP.DRAFT_STREAM == 0x5D1A_F7
    got = TSP.stream_key(TSP.PRNGKey(11), TSP.DRAFT_STREAM)
    want = JSP.stream_key(jax.random.PRNGKey(11), JSP.DRAFT_STREAM)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert not torch.equal(got, TSP.PRNGKey(11))


def test_speculative_validation(gemma):
    with pytest.raises(ValueError, match="k must be"):
        TSpec(gemma.cfg_t, gemma.dt, k=0)
    small = dataclasses.replace(gemma.cfg_t, vocab_size=256)
    with pytest.raises(ValueError, match="draft vocab_size"):
        gemma.vanilla(strategy=TSpec(small, gemma.dt))
    prefixed = dataclasses.replace(gemma.cfg_t, num_prefix_embeds=4)
    with pytest.raises(ValueError, match="num_prefix_embeds"):
        gemma.vanilla(strategy=TSpec(prefixed, gemma.dt))
    _, encdec = smoke_configs("seamless-m4t-medium")
    encdec = dataclasses.replace(encdec, vocab_size=gemma.cfg_t.vocab_size)
    with pytest.raises(ValueError, match="decoder-only"):
        gemma.vanilla(strategy=TSpec(encdec, gemma.dt))
    with pytest.raises(NotImplementedError, match="vanilla"):
        gemma.vanilla(strategy=TSpec(gemma.cfg_t, gemma.dt)).generate_padded(
            [TRequest([1, 2], 2)])
