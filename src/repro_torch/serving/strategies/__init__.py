"""Decoding strategies of the port's continuous-batching engine.

The port of ``repro.serving.strategies``: strategies register under a short
name, lookups fail with a ValueError listing what is available, and
``Engine(strategy=...)`` accepts a name (for strategies without required
arguments), a :class:`DecodeStrategy` instance (a draft model, a beam
width, a token grammar), or None for the vanilla default.  Registered:
``vanilla`` (greedy / top-k / top-p), ``speculative`` (draft and verify,
streams equal to vanilla's), ``beam`` (beam search on the slot cache) and
``constrained`` (a token-level DFA masking the vocabulary).
"""
from repro_torch.serving.strategies.base import (
    DecodeStrategy,
    Vanilla,
    vanilla_admit,
)

_STRATEGIES: dict = {}


def register_strategy(cls):
    """Class decorator: register a DecodeStrategy subclass under its
    ``name``."""
    _STRATEGIES[cls.name] = cls
    return cls


def available_strategies():
    return sorted(_STRATEGIES)


def get_strategy(name: str):
    """Look up a registered strategy class by name."""
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r} "
            f"(available: {', '.join(available_strategies())})") from None


def resolve_strategy(spec):
    """Normalize ``Engine(strategy=...)``: None -> Vanilla(), a name ->
    that class constructed with no arguments, an instance -> itself."""
    if spec is None:
        return Vanilla()
    if isinstance(spec, str):
        return get_strategy(spec)()
    if isinstance(spec, DecodeStrategy):
        return spec
    raise TypeError(
        f"strategy must be None, a registered name, or a DecodeStrategy "
        f"instance; got {type(spec).__name__}")


register_strategy(Vanilla)

from repro_torch.serving.strategies.beam import BeamSearch  # noqa: E402
from repro_torch.serving.strategies.constrained import Constrained  # noqa: E402,E501
from repro_torch.serving.strategies.speculative import Speculative  # noqa: E402,E501

register_strategy(Speculative)
register_strategy(BeamSearch)
register_strategy(Constrained)

__all__ = [
    "DecodeStrategy", "Vanilla", "Speculative", "BeamSearch", "Constrained",
    "vanilla_admit", "register_strategy", "available_strategies",
    "get_strategy", "resolve_strategy",
]
