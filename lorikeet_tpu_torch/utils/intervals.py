"""Genomic interval primitives.

Contract: reference/src/utils/simple_interval.rs (SimpleInterval,
1-based closed coordinates, :33-205; CoordMath :228-275) and
interval_utils.rs:42-57 (parse_limiting_interval).  Conformance suite:
tests/test_intervals.py (port of tests/simple_interval_unit_tests.rs).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering


@total_ordering
@dataclass(frozen=True)
class SimpleInterval:
    """Closed interval [start, end] on contig ``tid`` (reference
    coordinate convention: size = end - start + 1)."""
    tid: int
    start: int
    end: int

    def size(self) -> int:
        return self.end - self.start + 1

    def contigs_match(self, other) -> bool:
        return self.tid == other.tid

    def overlaps(self, other) -> bool:
        return self.overlaps_with_margin(other, 0)

    def overlaps_with_margin(self, other, margin: int) -> bool:
        """simple_interval.rs:201-205 (usize underflow saturates at 0)."""
        return (self.contigs_match(other)
                and self.start <= other.end + margin
                and max(other.start - margin, 0) <= self.end)

    def within_distance_of(self, other, distance: int) -> bool:
        return (self.contigs_match(other)
                and overlaps(self.start, self.end,
                             max(other.start - distance, 0),
                             other.end + distance))

    def contains(self, other) -> bool:
        return (self.contigs_match(other)
                and encloses(self.start, self.end, other.start, other.end))

    def span_with(self, other) -> "SimpleInterval":
        if not self.contigs_match(other):
            raise ValueError("Cannot get span for intervals on different "
                             "contigs")
        return SimpleInterval(self.tid, min(self.start, other.start),
                              max(self.end, other.end))

    def expand_within_contig(self, padding: int,
                             contig_length: int) -> "SimpleInterval":
        start = 0 if self.start < padding else self.start - padding
        return SimpleInterval(self.tid, start,
                              min(self.end + padding, contig_length))

    def intersect(self, that) -> "SimpleInterval":
        if not self.overlaps(that):
            raise ValueError(f"The two intervals need to overlap "
                             f"{self} and {that}")
        return SimpleInterval(self.tid, max(self.start, that.start),
                              min(self.end, that.end))

    def contiguous(self, that) -> bool:
        return (self.tid == that.tid and self.start <= that.end + 1
                and that.start <= self.end + 1)

    def merge_with_contiguous(self, that) -> "SimpleInterval":
        """Raises ValueError for non-contiguous inputs
        (BirdToolError::NonContiguousIntervals analogue)."""
        if not self.contiguous(that):
            raise ValueError(f"The two intervals need to be contiguous: "
                             f"{self} {that}")
        return SimpleInterval(self.tid, min(self.start, that.start),
                              max(self.end, that.end))

    def __lt__(self, other):
        # min-heap ordering of simple_interval.rs:210-217: tid asc, end
        # DESC, start asc
        return ((self.tid, -self.end, self.start)
                < (other.tid, -other.end, other.start))


# CoordMath (simple_interval.rs:228-275)

def get_length(start: int, end: int) -> int:
    return end - start + 1


def overlaps(start: int, end: int, start2: int, end2: int) -> bool:
    return start <= end2 and start2 <= end


def encloses(outer_start: int, outer_end: int, inner_start: int,
             inner_end: int) -> bool:
    return outer_start <= inner_start and inner_end <= outer_end


def get_overlap(start: int, end: int, start2: int, end2: int) -> int:
    if not overlaps(start, end, start2, end2):
        return 0
    return get_length(max(start, start2), min(end, end2))


def parse_limiting_interval(text: str | None) -> SimpleInterval | None:
    """'start-end' -> SimpleInterval(0, start, end); a bare number is
    ignored (interval_utils.rs:42-57)."""
    if not text:
        return None
    parts = text.split("-")
    if len(parts) == 1:
        return None
    return SimpleInterval(0, int(parts[0]), int(parts[1]))
