"""gemma3-4b and internvl2-76b served by the port and by the reference: the
served tests of ``tests/test_torch_serving_models.py`` (greedy streams
identical, sequence log-probabilities within 1e-4, EOS) on the float32
smoke configs.  gemma3-4b's prompt of 40 tokens wraps its local rings of
32 slots; internvl2-76b's requests go behind 8 zero prefix embeddings, so
their positions start at the prompt's length plus 8.  A prompt whose
prefix overruns the cache raises as in the reference.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as JC  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401
# In the order of test_torch_serving_models.py: the log-probs test reads
# the stats of the fixture's run, before the EOS test serves again.
from test_torch_serving_models import serve_both  # noqa: E402
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_greedy_streams_identical_to_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_seq_logprobs_match_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_eos_stops_like_reference)


@pytest.fixture(scope="module", params=["gemma3-4b", "internvl2-76b"])
def served(request):
    return serve_both(request.param)


def test_prefix_overrunning_the_cache_raises_like_reference():
    """internvl2-76b's 8 prefix embeddings count against ``cache_len``: a
    prompt of 60 tokens needs 68 slots of 64, and one of 50 with 8 new
    tokens 66; both engines refuse each with the same message."""
    name = "internvl2-76b"
    cfg_j = dataclasses.replace(JC.get_config(name, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(name, smoke=True),
                                dtype="float32")
    params_j, params_t = both_params(cfg_j, cfg_t, 3, torch.float32)
    engines = (JEngine(cfg_j, None, params_j, cache_len=64, batch_size=2),
               TEngine(cfg_t, params_t, cache_len=64, batch_size=2,
                       device="cpu"))
    for n, new, what in ((60, 1, "68 tokens incl. prefix"),
                         (50, 8, "(58+8)")):
        errors = []
        for eng, req in zip(engines, (JRequest, TRequest)):
            with pytest.raises(ValueError) as e:
                eng.generate([req(prompt=list(range(n)),
                                  max_new_tokens=new)])
            errors.append(str(e.value))
        assert what in errors[1]
        assert errors[0] == errors[1]
