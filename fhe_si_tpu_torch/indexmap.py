"""IndexSet / IndexMap (reference IndexSet.h:26-163, IndexMap.h:76-171).

The port's copy of fhe_si_tpu/indexmap.py (pure Python; below the
docstring the module is the same, which tests/test_torch_host.py
checks).  The prime chain is static and tensors carry a dense prime
axis, so these are host-side bookkeeping classes: IndexSet names a
subset of chain indices (used by the DoubleCrt mod-up/mod-down API);
IndexMap keys per-prime host data by such a set.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional


class IndexSet:
    """Dynamic set of small nonnegative ints with the reference's API
    surface: first/last/card, next/prev iteration, set algebra."""

    def __init__(self, lo: Optional[int] = None, hi: Optional[int] = None):
        self._s: set[int] = set()
        if lo is not None:
            hi = lo if hi is None else hi
            self._s.update(range(lo, hi + 1))

    @classmethod
    def of(cls, items: Iterable[int]) -> "IndexSet":
        out = cls()
        out._s = set(int(i) for i in items)
        return out

    # --- cardinality / bounds (IndexSet.h:44-78)
    def card(self) -> int:
        return len(self._s)

    def first(self) -> int:
        return min(self._s) if self._s else 0

    def last(self) -> int:
        return max(self._s) if self._s else -1

    def next(self, i: int) -> int:
        """Smallest member > i, or last()+1 when none (loop protocol)."""
        bigger = [j for j in self._s if j > i]
        return min(bigger) if bigger else self.last() + 1

    def prev(self, i: int) -> int:
        smaller = [j for j in self._s if j < i]
        return max(smaller) if smaller else self.first() - 1

    # --- membership / algebra (IndexSet.h:80-163, IndexSet.cpp:183-248)
    def contains(self, other) -> bool:
        if isinstance(other, IndexSet):
            return other._s <= self._s
        return int(other) in self._s

    __contains__ = contains

    def insert(self, i: int):
        self._s.add(int(i))

    def remove(self, i: int):
        self._s.discard(int(i))

    def __or__(self, other: "IndexSet") -> "IndexSet":
        return IndexSet.of(self._s | other._s)

    def __and__(self, other: "IndexSet") -> "IndexSet":
        return IndexSet.of(self._s & other._s)

    def __xor__(self, other: "IndexSet") -> "IndexSet":
        return IndexSet.of(self._s ^ other._s)

    def __truediv__(self, other: "IndexSet") -> "IndexSet":
        """Set difference (the reference spells it operator/)."""
        return IndexSet.of(self._s - other._s)

    def __eq__(self, other) -> bool:
        return isinstance(other, IndexSet) and self._s == other._s

    def __le__(self, other: "IndexSet") -> bool:
        return self._s <= other._s

    def __ge__(self, other: "IndexSet") -> bool:
        return self._s >= other._s

    def __gt__(self, other: "IndexSet") -> bool:
        return self._s > other._s

    def __iter__(self) -> Iterator[int]:
        return iter(sorted(self._s))

    def __len__(self) -> int:
        return len(self._s)

    def is_disjoint(self, other: "IndexSet") -> bool:
        return self._s.isdisjoint(other._s)

    def __repr__(self):
        return f"IndexSet({sorted(self._s)})"


def disjoint(a: IndexSet, b: IndexSet) -> bool:
    return a.is_disjoint(b)


def card(a: IndexSet) -> int:
    return a.card()


class IndexMap:
    """Map keyed by an IndexSet with a pluggable per-element initializer
    (IndexMapInit analog, IndexMap.h:33-74)."""

    def __init__(self, init: Optional[Callable[[int], object]] = None):
        self._init = init
        self._d: dict[int, object] = {}

    def get_index_set(self) -> IndexSet:
        return IndexSet.of(self._d.keys())

    def insert(self, s: IndexSet | int):
        items = [s] if isinstance(s, int) else list(s)
        for i in items:
            if i not in self._d:
                self._d[i] = self._init(i) if self._init else None

    def remove(self, s: IndexSet | int):
        items = [s] if isinstance(s, int) else list(s)
        for i in items:
            self._d.pop(i, None)

    def clear(self):
        self._d.clear()

    def __getitem__(self, i: int):
        return self._d[i]

    def __setitem__(self, i: int, v):
        self._d[i] = v
