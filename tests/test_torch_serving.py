"""The PyTorch port's serving slice: its structure against the JAX
package.

The CSR compaction of finished outputs and the scheduler's trace against
the reference's, and two checks of the port itself: it imports neither JAX
nor the reference package, and its entry points raise without a card
unless they are given ``device="cpu"``.  The engines serving models
against the reference's are in ``test_torch_serving_models.py`` (and the
files it names), each a file of at most 12 tests, so that ``--dist
loadfile`` queues them behind the larger files.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serving import cache as JCA  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.serving import cache as TCA  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

NAME = "recurrentgemma-2b"
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_ROOT = REPO / "src" / "repro_torch"


@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0], [4, 4]])
def test_compact_ragged_matches_reference(counts):
    B, T = len(counts), 6
    buf = np.arange(B * T, dtype=np.int32).reshape(B, T)
    for device_counts in (True, False):
        c = jnp.asarray(counts, jnp.int32) if device_counts else \
            np.asarray(counts)
        want_flat, want_off = JCA.compact_ragged(jnp.asarray(buf), c)
        got_flat, got_off = TCA.compact_ragged(
            torch.from_numpy(buf), torch.tensor(counts, dtype=torch.int32))
        np.testing.assert_array_equal(got_flat.numpy(), np.asarray(want_flat))
        np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))


def test_scheduler_copy_replays_reference_trace():
    """The port's scheduler copy runs one trace exactly as the reference."""
    trace = [("submit", 0), ("submit", 1), ("submit", 2), ("admit", 0),
             ("complete", 1), ("submit", 3), ("admit", 2), ("complete", 0),
             ("admit", 3), ("complete", 1), ("complete", 0)]
    logs = []
    for mod in (JS, TS):
        sched, log = mod.Scheduler(2), []
        for what, arg in trace:
            if what == "submit":
                log.append(sched.submit(object(), step=arg))
            elif what == "admit":
                log.append([(r.rid, r.slot) for r in sched.admit(step=arg)])
            else:
                log.append(sched.complete(arg, step=5).rid)
            sched.check_invariants()
        logs.append((log, sched.all_done))
    assert logs[0] == logs[1]


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, and not chip_smoke.py, imports jax or the
    reference package."""
    paths = sorted(PORT_ROOT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 20
    offenders = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}: {name}")
    assert not offenders


def test_engine_without_gpu_or_device_raises(monkeypatch):
    cfg = TC.get_config(NAME, smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        TEngine(cfg, {}, cache_len=64, batch_size=2)
    from repro_torch.models import lm
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        lm.init_params(cfg)
