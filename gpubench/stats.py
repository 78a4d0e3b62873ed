"""Percentiles of client-side samples."""

from __future__ import annotations

from typing import Optional, Sequence


def pct(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0-1) of ``values``: the sorted sample at index
    ``int(q (n - 1))`` (``distkeras_torch.serve_bench``'s rule), None
    when there are none."""
    if not values:
        return None
    s = sorted(values)
    return s[int(q * (len(s) - 1))]
