"""``BoundedTimeline``, copied from ``repro.core.dispatch`` (the JAX
package's module) for the SFS scheduler's adaptive-slice trace."""
from __future__ import annotations


class BoundedTimeline:
    """Append-only ``(t, S)`` adaptive-slice trace with a hard length cap.

    ``slice_timeline`` used to be a plain list growing one entry per
    adaptive window forever — unbounded memory on million-request runs.
    This keeps appends O(1) amortized and, when the cap is reached,
    decimates in place: every second interior entry is dropped (the first
    and the most recent survive), halving time resolution instead of
    growing.  The Fig. 10 shape is preserved at any cap >= 4.
    """

    __slots__ = ("_data", "cap")

    def __init__(self, *entries, cap: int = 4096):
        self.cap = max(int(cap), 4)
        self._data = list(entries)

    def append(self, entry) -> None:
        if len(self._data) >= self.cap:
            self._data = self._data[:-1:2] + [self._data[-1]]
        self._data.append(entry)

    def __len__(self):
        return len(self._data)

    def __getitem__(self, i):
        return self._data[i]

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other):
        return self._data == list(other)

    def __repr__(self):
        return f"BoundedTimeline({self._data!r}, cap={self.cap})"
