"""Decoding strategies of the port's continuous-batching engine.

This slice has the interface and the greedy default; the reference's
speculative, beam and constrained strategies come with later slices.
"""
from repro_torch.serving.strategies.base import (  # noqa: F401
    DecodeStrategy,
    Vanilla,
    vanilla_admit,
)
