"""Empirical autotuner for the kernels' launch knobs (the port of
``repro.core.tuning``).

The static :class:`~repro_torch.core.intrinsics.TuningPolicy` table holds a
prior per card family; this module measures on top of it.  The first call of
a tunable route on the ``cuda`` backend for a new (route, operator, dtype,
shape bucket, backend, card) key races the route's candidate ladder
(``TuneRecipe`` in ``core/intrinsics.py``) on the actual inputs and keeps
the winner in an on-disk JSON cache; every later call with that key reuses
it without measuring.

* Every candidate's units are built before anything is timed: the tuner
  runs each candidate with ``kernels/_lib.py``'s builds deferred, gathers
  the units they need and builds them all in one parallel ``build``; a
  build is never timed.
* A candidate is timed on the card with CUDA events around
  ``bench_repeats`` calls, after one untimed call, under
  ``torch.no_grad()``.
* A call on tensors that cannot be timed -- meta or fake tensors, or a
  stream being captured into a CUDA graph -- runs on the prior policy and
  leaves its key unset, as the reference does inside a trace.
* The ``torch`` backend is never tuned: its rows read no knob.

Layering: ``core.intrinsics`` knows nothing about this module; it exposes a
hook (:func:`~repro_torch.core.intrinsics.set_tuner_hook`) that
:func:`enable` installs.  ``resolve_impl`` consults the hook, so every
dispatch site gets tuning without naming it.  Off by default.

Usage::

    from repro_torch.core import tuning
    tuning.enable()                       # or REPRO_AUTOTUNE=1 in the env
    forge.scan(alg.ADD, x)                # first call: races + caches
    forge.scan(alg.ADD, torch.ones_like(x))   # same key: a hit, no race

The cache path defaults to ``~/.cache/repro_torch/tuning.json`` and can be
moved with ``REPRO_TUNING_CACHE=/path/to/tuning.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import intrinsics as ki
from repro_torch.kernels import _lib


def default_cache_path() -> str:
    return os.environ.get(
        "REPRO_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "tuning.json"))


def shape_bucket(n: int) -> int:
    """Power-of-two bucket so dimension jitter shares one tuning entry."""
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# What is tunable: derived from the PrimitiveDef registry.  Each RouteDef
# carries a TuneRecipe (candidate ladder + key-extraction recipe); one
# generic keyer below interprets the recipe.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TunableSpec:
    """How to tune one route: cache-key fields + candidate overrides.

    ``keyer`` returns ``(op_name, dtype, n, batch)``; ``batch`` (the
    batched family, else None) rides its own bucket in the key, and
    because the batched routes are single launches one race covers the
    whole batch.  (The reference's fifth field, a sharded route's mesh
    topology, comes with the distributed layer.)
    """

    keyer: Callable[[tuple, dict], tuple]
    candidates: tuple[dict, ...]  # TuningPolicy field overrides to race


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _recipe_keyer(route: "ki.RouteDef") -> Callable:
    """Generic key extraction driven by a route's TuneRecipe.

    * ``flat``: total element count over the data's leaves.
    * ``row``: ``(B, n)`` leaves -- per-row extent + batch bucket.
    * ``trail2``: ``(B, d1, d2)`` leading leaf -- the trailing dims bucket
      separately ("128x8192", not their product) because the launch
      branches on the aspect ratio, so a tall-narrow winner is never
      replayed on a wide-short problem; batch rides its own bucket.

    Argument indices default to the route's own ``data_arg``/``op_arg``.
    """
    recipe = route.tuning
    data_arg = recipe.data_arg if recipe.data_arg is not None else \
        route.data_arg
    op_arg = recipe.op_arg if recipe.op_arg is not None else route.op_arg

    def keyer(args, kwargs):
        op_name = (recipe.op_label if recipe.op_label is not None
                   else getattr(args[op_arg], "name", "?"))
        leaves = pytree.tree_leaves(args[data_arg])
        lead = leaves[0]
        # A Quantized operand carries its own dtype tag ("int8q64"): the
        # storage dtype alone would share winners across modes and blocks.
        qtag = getattr(args[data_arg], "qtag", None)
        dtype = qtag if qtag is not None else _dtype_name(lead.dtype)
        if recipe.dims == "flat":
            return (op_name, dtype, sum(int(l.numel()) for l in leaves),
                    None)
        if recipe.dims == "row":
            return (op_name, dtype, int(lead.shape[1]), int(lead.shape[0]))
        b, d1, d2 = lead.shape
        return (op_name, dtype,
                f"{shape_bucket(int(d1))}x{shape_bucket(int(d2))}", int(b))

    return keyer


TUNABLE: dict[str, TunableSpec] = {
    route.key: TunableSpec(_recipe_keyer(route), tuple(route.tuning.ladder))
    for route in ki.iter_routes() if route.tuning is not None
}


def _device_name() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "no card"


# ---------------------------------------------------------------------------
# The tuner itself.
# ---------------------------------------------------------------------------


class Autotuner:
    """Benchmark-once, memoize-forever policy selection with a JSON cache.

    ``stats`` counts races (``benchmarks``), cache ``hits`` and timed
    candidates (``bench_calls``); ``last_race`` holds the latest race's
    key, each candidate's seconds a call, the winner and the units built
    for it with the build's seconds."""

    def __init__(self, cache_path: str | None = None, *,
                 bench_repeats: int = 2):
        self.cache_path = cache_path or default_cache_path()
        self.bench_repeats = bench_repeats
        self.stats = {"benchmarks": 0, "hits": 0, "bench_calls": 0}
        self.last_race: dict | None = None
        self._cache: dict[str, dict] = {}
        self._load()

    # -- persistence --------------------------------------------------------

    def _read_disk(self) -> dict:
        """Best-effort read; a corrupt or truncated cache (a concurrent
        writer cut mid-line) means re-tuning, never an exception."""
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def _load(self):
        self._cache = self._read_disk()

    def _save(self):
        """Atomic, concurrency-tolerant persist: the read-merge-write cycle
        holds an advisory ``flock`` on a sidecar lock file (so a concurrent
        tuner's fresh entries are merged, not overwritten with this one's
        stale view), the temp file carries the pid, and ``os.replace``
        publishes it atomically.  Without ``fcntl`` the lock degrades to
        merge-on-save."""
        try:
            os.makedirs(os.path.dirname(self.cache_path) or ".",
                        exist_ok=True)
            with open(self.cache_path + ".lock", "w") as lk:
                try:
                    import fcntl
                    fcntl.flock(lk, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    pass  # non-POSIX: unserialized merge-on-save
                merged = self._read_disk()
                merged.update(self._cache)
                self._cache = merged
                tmp = f"{self.cache_path}.{os.getpid()}.tmp"
                try:
                    with open(tmp, "w") as f:
                        json.dump(merged, f, indent=1, sort_keys=True)
                    os.replace(tmp, self.cache_path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        except OSError:
            pass  # caching is best-effort; never fail the computation

    # -- keys ---------------------------------------------------------------

    def make_key(self, primitive: str, backend: str, op_name: str,
                 dtype: str, n, batch: int | None = None) -> str:
        """Cache key.  ``batch`` (the batched family) gets its own bucket;
        ``n`` is a flat extent to bucket, or a pre-bucketed string of a
        multi-dim row ("8192x128").  The platform part names the card
        (``torch.cuda.get_device_name()``), its chip-table family and the
        process's card count, so a winner on one card is never replayed on
        another."""
        platform = (f"{_device_name()}/{ki.detect_chip()}"
                    f"/d{torch.cuda.device_count()}")
        batch_part = "" if batch is None else f"|batch={shape_bucket(batch)}"
        n_part = n if isinstance(n, str) else shape_bucket(n)
        return (f"{primitive}|op={op_name}|dtype={dtype}"
                f"|n={n_part}{batch_part}"
                f"|backend={backend}|platform={platform}")

    def lookup(self, key: str) -> dict | None:
        entry = self._cache.get(key)
        if entry is not None:
            self.stats["hits"] += 1
        return entry

    # -- measurement --------------------------------------------------------

    def _time(self, fn) -> float:
        """Seconds a call: CUDA events around ``bench_repeats`` calls, after
        one untimed call."""
        with torch.no_grad():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.bench_repeats):
                fn()
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / self.bench_repeats

    @staticmethod
    def _build_all(calls: list) -> tuple[list, list, float]:
        """Run every candidate call with builds deferred, build the units
        they stop at in one parallel build, and again until each call runs
        through or fails.  Returns (the calls that ran, the units built,
        the build's seconds)."""
        pending, ok, built, seconds = list(calls), [], [], 0.0
        while pending:
            missing, retry = {}, []
            for call in pending:
                try:
                    with torch.no_grad(), _lib.deferring():
                        call()
                    ok.append(call)
                except _lib.Unbuilt as e:
                    missing[e.unit.digest] = e.unit
                    retry.append(call)
                except Exception:
                    pass  # candidate invalid for this shape -- skip it
            if missing:
                t0 = time.perf_counter()
                _lib.build(list(missing.values()))
                seconds += time.perf_counter() - t0
                built += [u.label for u in missing.values()]
            pending = retry
        return ok, built, seconds

    def benchmark(self, key: str, spec: TunableSpec, base: ki.TuningPolicy,
                  impl: Callable, args: tuple, kwargs: dict) -> dict:
        """Race the candidate ladder on the actual inputs; memoize winner."""
        self.stats["benchmarks"] += 1
        calls = {}
        for overrides in spec.candidates:
            policy = dataclasses.replace(base, **overrides)
            calls[json.dumps(overrides, sort_keys=True)] = (
                lambda p=policy: impl(*args, **kwargs, policy=p))
        runnable, built, build_s = self._build_all(list(calls.values()))
        times = {}
        for label, call in calls.items():
            if call not in runnable:
                continue
            try:
                times[label] = self._time(call)
            except Exception:
                continue
            self.stats["bench_calls"] += 1
        entry = {"overrides": {}, "seconds": float("inf")}
        if times:
            best = min(times, key=times.get)
            entry = {"overrides": json.loads(best), "seconds": times[best]}
            # Only memoize a real measurement: if every candidate failed,
            # retry on the next call instead of pinning the base policy.
            self._cache[key] = entry
            self._save()
        self.last_race = {"key": key, "candidates": times,
                          "winner": entry["overrides"], "built": built,
                          "build_s": build_s}
        return entry


# ---------------------------------------------------------------------------
# resolve_impl hook.
# ---------------------------------------------------------------------------

_ACTIVE: Autotuner | None = None


def active() -> Autotuner | None:
    return _ACTIVE


def _timeable(args, kwargs) -> bool:
    """Whether a call's tensors can be timed on the card: none is a meta or
    fake tensor, and the current stream is not being captured."""
    from torch._subclasses.fake_tensor import FakeTensor
    for leaf in pytree.tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor) and (
                leaf.is_meta or isinstance(leaf, FakeTensor)):
            return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def _hook(primitive: str, backend: str, impl: Callable) -> Callable | None:
    spec = TUNABLE.get(primitive)
    if spec is None or backend != "cuda":
        return None  # nothing to tune: the torch rows read no knob

    def tuned(*args, **kwargs):
        tuner = _ACTIVE
        if tuner is None or kwargs.get("policy") is not None:
            return impl(*args, **kwargs)
        key = tuner.make_key(primitive, backend, *spec.keyer(args, kwargs))
        base = ki.resolve_tuning(ki.default_policy_name(backend))
        entry = tuner.lookup(key)
        if entry is None:
            if not _timeable(args, kwargs):
                # Nothing meaningful to time: run the prior policy and
                # leave the key for a call that can be timed.
                return impl(*args, **kwargs)
            entry = tuner.benchmark(key, spec, base, impl, args, kwargs)
        policy = dataclasses.replace(base, **entry["overrides"])
        return impl(*args, **kwargs, policy=policy)

    return tuned


def enable(cache_path: str | None = None, **kw) -> Autotuner:
    """Install the autotuner behind every resolve_impl dispatch."""
    global _ACTIVE
    _ACTIVE = Autotuner(cache_path, **kw)
    ki.set_tuner_hook(_hook)
    return _ACTIVE


def disable():
    global _ACTIVE
    _ACTIVE = None
    ki.set_tuner_hook(None)


def maybe_enable_from_env():
    if os.environ.get("REPRO_AUTOTUNE", "") not in ("", "0"):
        enable()
