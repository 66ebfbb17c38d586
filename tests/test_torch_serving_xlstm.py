"""xlstm-1.3b served by the port and by the reference: the served tests
of ``tests/test_torch_serving.py`` (greedy streams identical, sequence
log-probabilities within 1e-4, EOS) on the float32 smoke config, in a file
of their own so that ``--dist loadfile`` builds this reference engine on
another worker than the other models'.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_models import one_torch_thread  # noqa: E402,F401
# In the order of test_torch_serving.py (pytest runs a module's tests in
# the order their names entered it): the log-probs test reads the stats of
# the fixture's run, before the EOS test serves again.
from test_torch_serving import serve_both  # noqa: E402
from test_torch_serving import (  # noqa: E402,F401,I001
    test_greedy_streams_identical_to_reference)
from test_torch_serving import (  # noqa: E402,F401,I001
    test_seq_logprobs_match_reference)
from test_torch_serving import (  # noqa: E402,F401,I001
    test_eos_stops_like_reference)


@pytest.fixture(scope="module", params=["xlstm-1.3b"])
def served(request):
    return serve_both(request.param)
