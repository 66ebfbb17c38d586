"""Layout descriptors: where the independent problems live in the data.

The port of ``repro.core.layout`` for these slices: :class:`Flat` (one
problem over the whole data, the default), :class:`Batched` (``B``
independent problems of identical extent in one launch: ``(B, n)`` rows,
``(B, T, C)`` recurrences) and :class:`Segmented` (contiguous ragged
segments of one flat stream, described by flags or CSR offsets).  Every
primitive in ``core.primitives`` takes ``layout=`` and dispatches through the
route registry in ``core.intrinsics``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Layout:
    """Base class for layout descriptors.  ``kind`` keys the registry."""

    kind = "abstract"

    def describe(self) -> str:
        return f"{type(self).__name__}()"


@dataclasses.dataclass(frozen=True)
class Flat(Layout):
    """One problem over the whole data (the paper's default layout)."""

    kind = "flat"


@dataclasses.dataclass(frozen=True)
class Batched(Layout):
    """B independent problems of identical extent, batch on grid axis 0."""

    kind = "batched"


@dataclasses.dataclass(frozen=True, eq=False)
class Segmented(Layout):
    """Contiguous ragged segments of one flat stream.

    Exactly one of ``flags`` (``(n,)`` int/bool, nonzero starts a segment;
    element 0 always implicitly starts one) or ``offsets``
    (``(num_segments + 1,)`` CSR monotone starts, ``offsets[0] == 0``,
    ``offsets[-1] == n``) must be given.  ``num_segments`` is required by
    per-segment *reductions* (top_k) under the flag variant, where the
    output extent cannot be read off the descriptor.
    """

    kind = "segmented"
    flags: torch.Tensor | None = None
    offsets: torch.Tensor | None = None
    num_segments: int | None = None

    # eq=False suppresses the generated (field-wise) __eq__, which would
    # compare tensors elementwise; descriptors compare by *identity* of the
    # flag/offset tensors instead, so two Segmented values are equal only
    # when they describe the same segmentation objects.
    def __eq__(self, other):
        if not isinstance(other, Segmented):
            return NotImplemented
        return (self.flags is other.flags and self.offsets is other.offsets
                and self.num_segments == other.num_segments)

    def __hash__(self):
        return hash((id(self.flags), id(self.offsets), self.num_segments))

    def describe(self) -> str:
        d = "flags" if self.flags is not None else (
            "offsets" if self.offsets is not None else "<no descriptor>")
        ns = f", num_segments={self.num_segments}" \
            if self.num_segments is not None else ""
        return f"Segmented({d}=...{ns})"


FLAT = Flat()


def validate_descriptor(flags, offsets, *, where: str) -> None:
    """The one segment-descriptor exclusivity check (used by dispatch)."""
    if (flags is None) == (offsets is None):
        raise ValueError(
            f"{where}: pass exactly one of flags= or offsets= in "
            f"Segmented(...)")


def as_layout(layout: Layout | None) -> Layout:
    """Normalize the public ``layout=`` argument (None means Flat)."""
    if layout is None:
        return FLAT
    if not isinstance(layout, Layout):
        raise TypeError(
            f"layout= must be a Layout descriptor (Flat/Batched/Segmented), "
            f"got "
            f"{layout!r}")
    return layout
