"""Half-open record-span arithmetic for the data checkpoint (a copy of
the JAX package's ``utils/spans.py:merge_span``)."""

from __future__ import annotations


def merge_span(spans: list[list[int]], begin: int, end: int) -> None:
    """Insert [begin,end) into a list of disjoint [b,e) spans, merging
    overlaps/adjacency in place; keeps the list sorted."""
    if end <= begin:
        return
    out: list[list[int]] = []
    for b, e in spans:
        if e < begin or b > end:  # strictly disjoint, not even adjacent
            out.append([b, e])
        else:  # overlapping or adjacent: absorb into the new span
            begin = min(begin, b)
            end = max(end, e)
    out.append([begin, end])
    out.sort()
    spans[:] = out
