"""The port's fp8 quantization codecs (e4m3 and e5m2) against the
reference's, bit for bit: codes, scales, dequantized values and the error
bound across block-boundary shapes (block 32) and a batch rank -- the
inputs and comparisons of ``test_torch_quantized.py``, in a file of at
most 12 tests so that ``--dist loadfile`` queues it behind the larger
files.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_quantized import (  # noqa: E402
    QUANT_MODES, SHAPES, bit_exact_against_reference)


@pytest.mark.parametrize("mode", QUANT_MODES[1:])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bit_exact_against_reference(mode, shape):
    bit_exact_against_reference(mode, shape)
