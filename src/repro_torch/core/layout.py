"""Layout descriptors: where the independent problems live in the data.

The port of ``repro.core.layout`` for this slice: :class:`Flat` (one problem
over the whole data, the default) and :class:`Batched` (``B`` independent
problems of identical extent in one launch: ``(B, n)`` rows, ``(B, T, C)``
recurrences).  Every primitive in ``core.primitives`` takes ``layout=`` and
dispatches through the route registry in ``core.intrinsics``.
"""
from __future__ import annotations

import dataclasses


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


FLAT = Flat()


def as_layout(layout: Layout | None) -> Layout:
    """Normalize the public ``layout=`` argument (None means Flat)."""
    if layout is None:
        return FLAT
    if not isinstance(layout, Layout):
        raise TypeError(
            f"layout= must be a Layout descriptor (Flat/Batched), got "
            f"{layout!r}")
    return layout
