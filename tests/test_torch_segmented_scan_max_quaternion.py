"""``scan@segmented`` against the JAX package for the MAX and QUATERNION_MUL cases: the
inputs, descriptors and tolerances of ``test_torch_segmented.py``, in a
file of at most 12 tests so that ``--dist loadfile`` queues it behind the
larger files.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_segmented import (  # noqa: E402
    CASES, OFFSETS, scan_matches_reference)


@pytest.mark.parametrize("op_name,dtype", CASES[2:])
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
@pytest.mark.parametrize("inclusive", [True, False])
def test_segmented_scan_matches_reference(op_name, dtype, offsets, inclusive):
    scan_matches_reference(op_name, dtype, offsets, inclusive)
