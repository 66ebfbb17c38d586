"""``mapreduce@segmented`` against the JAX package for every case of
``test_torch_segmented.py`` (integer and float ADD, MAX, QUATERNION_MUL)
at every descriptor: its inputs and tolerances, in a file of at most 12
tests so that ``--dist loadfile`` queues it behind the larger files.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_segmented import (  # noqa: E402
    CASES, OFFSETS, mapreduce_matches_reference)


@pytest.mark.parametrize("op_name,dtype", CASES)
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_segmented_mapreduce_matches_reference(op_name, dtype, offsets):
    mapreduce_matches_reference(op_name, dtype, offsets)
