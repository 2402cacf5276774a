"""Bounded list-like event log (the fix for unbounded in-memory growth).

`search.islands.IslandFleet` used plain lists for fleet events and
quarantine records: on an hours-long run with a chatty fault schedule they
grow without bound. :class:`RingLog` keeps only the newest ``cap`` items in
memory while counting everything (``total``/``dropped``), and optionally
*spills* every appended item to the obs trace — the JSONL is the complete
stream, the ring is the working set.

It is deliberately list-shaped: ``append``/``extend``/iteration/``len``/
indexing and full-slice assignment (``log[:] = items`` — the
checkpoint-restore idiom in `search.runtime`) all work, so existing
callers and tests that treated the field as a list keep working.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, List, Optional


class RingLog:
    def __init__(self, cap: int = 1024, *,
                 spill: Optional[Callable[[object], None]] = None):
        if cap <= 0:
            raise ValueError("RingLog cap must be positive")
        self.cap = cap
        self._d: deque = deque(maxlen=cap)
        self.total = 0                      # everything ever appended
        self._spill = spill

    @property
    def dropped(self) -> int:
        return self.total - len(self._d)

    def append(self, item) -> None:
        self.total += 1
        if self._spill is not None:
            self._spill(item)
        self._d.append(item)

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        self._d.clear()
        self.total = 0

    # -- list compatibility --------------------------------------------------

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._d)[i]
        return self._d[i]

    def __setitem__(self, key, value) -> None:
        """Only full-slice replacement (``log[:] = items``) is supported —
        the restore idiom. Restored items bypass the spill (they were
        spilled when first appended) and reset ``total`` to the restored
        length; `search.runtime` re-applies the checkpointed total."""
        if not (isinstance(key, slice) and key.start is None
                and key.stop is None and key.step is None):
            raise TypeError("RingLog only supports full-slice assignment")
        self._d.clear()
        self._d.extend(list(value)[-self.cap:])
        self.total = len(self._d)

    def __repr__(self) -> str:
        return (f"RingLog(cap={self.cap}, kept={len(self._d)}, "
                f"total={self.total})")

    def to_list(self) -> List:
        return list(self._d)


__all__ = ["RingLog"]
