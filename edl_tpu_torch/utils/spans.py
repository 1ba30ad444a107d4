"""Half-open record-span arithmetic shared by the data checkpoint
(``cluster/state.py``) and the data service's work queue
(``data/data_server.py``); a copy of the JAX package's ``utils/spans.py``."""

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


def in_spans(spans: list[list[int]], record_no: int) -> bool:
    return any(b <= record_no < e for b, e in spans)


def intersect_spans(a: list[list[int]], b: list[list[int]]) -> list[list[int]]:
    """Merged intersection of two span lists (each need not be sorted
    or disjoint)."""
    am: list[list[int]] = []
    for begin, end in a:
        merge_span(am, begin, end)
    bm: list[list[int]] = []
    for begin, end in b:
        merge_span(bm, begin, end)
    out: list[list[int]] = []
    for ab, ae in am:
        for bb, be in bm:
            lo, hi = max(ab, bb), min(ae, be)
            if lo < hi:
                merge_span(out, lo, hi)
    return out
