"""The nucleus pins of the reference's ``tests/test_serving.py`` through
the port's ``sample_tokens``, held against the reference's draws (the
exact-id harness of ``test_torch_sampling.py``), in a file of at most 12
tests so that ``--dist loadfile`` queues it behind the larger files.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import intrinsics as t_ki  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_sampling import DRAWS, VOCAB, _sample_both  # noqa: E402


# ---------------------------------------------------------------------------
# The nucleus pins (reference tests/test_serving.py), through the port and
# held against the reference's draws, at the reference's vocabulary cut to
# 64 (one (DRAWS, VOCAB) shape keeps the reference's compilations few).
# 4-bit digits keep the CPU's plain rank scans small; the result does not
# depend on the digit width.
# ---------------------------------------------------------------------------


@pytest.fixture
def narrow_digits(monkeypatch):
    base = t_ki.resolve_tuning()
    monkeypatch.setitem(t_ki._TUNING_REGISTRY, base.name,
                        dataclasses.replace(base, sort_digit_bits=4))


def _draws(logits_row, *, top_k, top_p, n=DRAWS):
    logits = np.tile(np.asarray(logits_row, np.float32)[None, :], (n, 1))
    got, want = _sample_both(logits, np.arange(n, dtype=np.int32),
                             np.zeros(n, np.int32), temperature=1.0,
                             top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got, want)
    return got


def test_nucleus_all_candidates_survive_on_renormalized_mass(narrow_digits):
    """8 equal candidates carrying about half the full-vocab mass,
    top_p=0.95: the renormalized exclusive prefix tops out at 7/8 < 0.95,
    so all 8 survive."""
    logits = np.full(VOCAB, 3.0, np.float32)
    cands = np.arange(0, 56, 7)
    logits[cands] = 5.0
    draws = _draws(logits, top_k=8, top_p=0.95)
    assert set(draws) == set(cands.tolist())


def test_nucleus_truncates_on_renormalized_prefix(narrow_digits):
    logits = np.full(VOCAB, -30.0, np.float32)
    logits[7] = np.log(0.7)
    logits[[13, 21, 34]] = np.log(0.1)
    draws = _draws(logits, top_k=4, top_p=0.75)
    assert set(draws) == {7, 13}


def test_nucleus_first_candidate_always_survives(narrow_digits):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=VOCAB).astype(np.float32)
    draws = _draws(logits, top_k=8, top_p=1e-6)
    assert (draws == int(np.argmax(logits))).all()
