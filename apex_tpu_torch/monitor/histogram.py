"""Bounded-memory streaming latency histograms.

Port of ``apex_tpu/monitor/histogram.py`` (plain host Python, unchanged):
:class:`StreamingHistogram` keeps log-spaced fixed buckets instead of
every sample, so a long-running serve reads its quantiles live in bounded
memory:

* **Bounded memory by construction.** The bucket array is sized at
  construction (``decades x bins_per_decade + 2`` slots, ~700 ints at
  the defaults) and never grows.
* **Bounded relative error.** Log-spaced edges make every bucket the
  same *relative* width (``10^(1/bins_per_decade) - 1`` — ~3.7% at the
  default 64 bins/decade), so a quantile read is off by at most one
  bucket width at its own magnitude.
* **Mergeable.** Two histograms with the same geometry fold together.

Exact ``min``/``max``/``count``/``sum`` ride along, so the extreme
quantiles (q=0, q=1) and the mean are exact, not bucketed. Values are
unit-agnostic positive floats (the serving telemetry feeds
milliseconds); non-positive values clamp into the underflow bucket. The
quantiles are bit-identical to the reference's on the same inputs
(``tests/test_torch_monitor.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

__all__ = ["StreamingHistogram"]


class StreamingHistogram:
    """Log-spaced fixed-bucket histogram over positive values.

    ``lo``/``hi`` bound the resolved range (values outside clamp into
    underflow/overflow buckets, still counted — quantiles there return
    the exact tracked min/max); ``bins_per_decade`` sets the relative
    resolution. The defaults resolve 0.1 us .. ~28 h in milliseconds at
    ~3.7% relative width.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e8,
                 bins_per_decade: int = 64):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if bins_per_decade < 1:
            raise ValueError(
                f"bins_per_decade must be >= 1, got {bins_per_decade}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        self._log_lo = math.log10(self.lo)
        # bucket i (0-based) covers [lo*g^i, lo*g^(i+1)) with
        # g = 10^(1/bins_per_decade); + underflow (index -1) + overflow
        self.num_buckets = int(math.ceil(
            (math.log10(self.hi) - self._log_lo) * self.bins_per_decade))
        self._counts: List[int] = [0] * (self.num_buckets + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # --- geometry ------------------------------------------------------------

    def _index(self, value: float) -> int:
        """Slot index in the counts array (0 = underflow)."""
        if value < self.lo:
            return 0
        if value >= self.hi:
            return self.num_buckets + 1
        i = int((math.log10(value) - self._log_lo) * self.bins_per_decade)
        # float round-off at exact edges: keep inside the resolved range
        return min(max(i, 0), self.num_buckets - 1) + 1

    def bucket_edges(self, value: float) -> tuple:
        """The ``[lower, upper)`` edges of the bucket holding ``value``
        (underflow → ``(0, lo)``; overflow → ``(hi, inf)``)."""
        slot = self._index(value)
        if slot == 0:
            return (0.0, self.lo)
        if slot == self.num_buckets + 1:
            return (self.hi, math.inf)
        i = slot - 1
        scale = 1.0 / self.bins_per_decade
        return (10.0 ** (self._log_lo + i * scale),
                10.0 ** (self._log_lo + (i + 1) * scale))

    def bucket_width(self, value: float) -> float:
        """Absolute width of the bucket holding ``value`` — the parity
        tolerance of a quantile read at that magnitude."""
        low, high = self.bucket_edges(value)
        if not math.isfinite(high):
            return max((self.max or self.hi) - self.hi, 0.0) or self.hi
        return high - low

    # --- ingest --------------------------------------------------------------

    def add(self, value: float, n: int = 1) -> None:
        """Fold ``n`` observations of ``value`` in (O(1), no allocation)."""
        value = float(value)
        if math.isnan(value):
            raise ValueError("cannot add nan to a histogram")
        n = int(n)
        if n < 1:
            return
        self._counts[self._index(value)] += n
        self.count += n
        self.sum += value * n
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def reset(self) -> None:
        """Zero every counter, keeping the geometry — the
        sliding-window consumers reset at each window edge inside a
        hot loop (one C-level list fill; no object reconstruction)."""
        self._counts = [0] * len(self._counts)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold ``other`` into self (same geometry required)."""
        if (other.lo, other.hi, other.bins_per_decade) != \
                (self.lo, self.hi, self.bins_per_decade):
            raise ValueError(
                "histogram geometries differ: "
                f"({self.lo}, {self.hi}, {self.bins_per_decade}) vs "
                f"({other.lo}, {other.hi}, {other.bins_per_decade})")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for v in (other.min, other.max):
            if v is not None:
                if self.min is None or v < self.min:
                    self.min = v
                if self.max is None or v > self.max:
                    self.max = v

    # --- reads ---------------------------------------------------------------

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (q in [0, 1]) — ``None`` on an empty histogram.

        Returns the geometric midpoint of the bucket holding the
        order statistic at rank ``floor(q * (count - 1))`` (the lower
        bound of ``np.percentile``'s linear interpolation), clamped to
        the exact tracked ``[min, max]`` — so q=0 / q=1 are exact and
        interior quantiles are within one bucket width of the
        sample-list answer.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = int(math.floor(q * (self.count - 1)))  # 0-based
        cum = 0
        slot = 0
        for slot, c in enumerate(self._counts):
            cum += c
            if cum > rank:
                break
        if slot == 0:
            value = self.min
        elif slot == self.num_buckets + 1:
            value = self.max
        else:
            low, high = self.bucket_edges(
                10.0 ** (self._log_lo + (slot - 0.5) / self.bins_per_decade))
            value = math.sqrt(low * high)  # geometric midpoint
        return min(max(value, self.min), self.max)

    def percentile(self, p: float) -> Optional[float]:
        """``quantile(p / 100)`` — the ``np.percentile`` calling
        convention the sample-list math used."""
        return self.quantile(p / 100.0)

    def summary(self, prefix: str = "") -> Dict[str, float]:
        """The standard quantile block for a telemetry record
        (``{prefix}p50`` / ``p90`` / ``p99`` / ``mean`` / ``max`` /
        ``count``); empty dict when no samples landed yet — callers
        encode that as an explicit skip, never nan."""
        if self.count == 0:
            return {}
        return {
            f"{prefix}p50": self.quantile(0.5),
            f"{prefix}p90": self.quantile(0.9),
            f"{prefix}p99": self.quantile(0.99),
            f"{prefix}mean": self.mean,
            f"{prefix}max": self.max,
            f"{prefix}count": self.count,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"StreamingHistogram(count={self.count}, min={self.min}, "
                f"max={self.max}, buckets={self.num_buckets})")
