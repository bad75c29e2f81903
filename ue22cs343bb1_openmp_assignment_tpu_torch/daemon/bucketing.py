"""Slot shape bucketing: bound padding_waste with a few slot classes.

The single-slot-shape serving layer (serve.py) pads every job to the
max (nodes, trace_len) over the stream — a bimodal mix of tiny and
huge jobs then burns most of its slot instruction budget on padding.
The fix is a SMALL fixed set of slot shape classes ("buckets"): each
job runs in the cheapest bucket that covers its shape, one vmapped
wave per bucket, and the compile count stays pinned at the bucket
count (each bucket is one ``run_wave_chunk`` slot shape).

``choose_buckets`` picks ≤ k classes from a shape histogram by exact
dynamic programming over the lexicographically sorted distinct shapes
partitioned into contiguous segments (each segment's class is the
elementwise max over its members, so every member fits). Contiguous-
in-sorted-order is optimal when trace length grows with node count
(the usual fleet shape) and a deterministic, near-optimal heuristic
otherwise — and determinism is load-bearing: the daemon re-chooses
online as the histogram grows, and two identical submission schedules
must build identical buckets (the VirtualClock byte-parity gate).

Costs are in slot-instruction-budget units (``nodes * trace_len`` per
job), the same unit ``serve.weighted_padding_waste`` reports, so "k
buckets strictly beat one max shape" is checkable end to end.

The port's copy of the JAX package's ``daemon/bucketing.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Shape = Tuple[int, int]   # (nodes, trace_len)


def shape_histogram(shapes) -> Dict[Shape, int]:
    """Iterable of (nodes, trace_len) → {shape: count}."""
    hist: Dict[Shape, int] = {}
    for s in shapes:
        key = (int(s[0]), int(s[1]))
        hist[key] = hist.get(key, 0) + 1
    return hist


def cover(a: Shape, b: Shape) -> Shape:
    """The smallest shape both fit in (elementwise max)."""
    return (max(a[0], b[0]), max(a[1], b[1]))


def fits(shape: Shape, bucket: Shape) -> bool:
    return shape[0] <= bucket[0] and shape[1] <= bucket[1]


def bucket_for(shape: Shape, buckets) -> Optional[Shape]:
    """The cheapest (min slot budget, then lexicographic) bucket
    covering ``shape``; None when nothing fits."""
    covering = [b for b in buckets if fits(shape, b)]
    if not covering:
        return None
    return min(covering, key=lambda b: (b[0] * b[1], b))


def assignment_cost(hist: Dict[Shape, int], buckets) -> int:
    """Total slot instruction budget when every job in ``hist`` runs
    in its cheapest covering bucket; raises if any shape fits no
    bucket (a chooser bug — chosen buckets always cover by
    construction)."""
    total = 0
    for shape, count in hist.items():
        b = bucket_for(shape, buckets)
        if b is None:
            raise ValueError(f"shape {shape} fits no bucket in "
                             f"{sorted(buckets)}")
        total += count * b[0] * b[1]
    return total


def padding_waste(hist: Dict[Shape, int], buckets) -> float:
    """The weighted padding_waste of running ``hist`` through
    ``buckets`` — 1 - real/budget, the serve summary convention."""
    budget = assignment_cost(hist, buckets)
    real = sum(c * n * t for (n, t), c in hist.items())
    return 1.0 - real / budget if budget else 0.0


def choose_buckets(hist: Dict[Shape, int], k: int) -> List[Shape]:
    """≤ k slot classes for a shape histogram, minimizing total slot
    budget over contiguous segments of the sorted distinct shapes.

    Returns the chosen classes sorted ascending. ``k >= len(hist)``
    degenerates to one exact class per shape (zero shape padding);
    ``k == 1`` degenerates to the single max shape — the baseline the
    bucketing win is measured against.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not hist:
        return []
    shapes = sorted(hist)
    m = len(shapes)
    k = min(k, m)

    # seg_class[i][j] / seg_cost[i][j]: the class covering shapes[i..j]
    # and the budget of running those shapes' jobs in it
    seg_class = [[None] * m for _ in range(m)]
    seg_cost = [[0] * m for _ in range(m)]
    for i in range(m):
        c = shapes[i]
        jobs = 0
        for j in range(i, m):
            c = cover(c, shapes[j])
            jobs += hist[shapes[j]]
            seg_class[i][j] = c
            seg_cost[i][j] = jobs * c[0] * c[1]

    INF = float("inf")
    # best[c][j]: min budget partitioning shapes[0..j] into c+1 segments
    best = [[INF] * m for _ in range(k)]
    cut = [[-1] * m for _ in range(k)]
    for j in range(m):
        best[0][j] = seg_cost[0][j]
    for c in range(1, k):
        for j in range(c, m):
            for i in range(c, j + 1):
                cand = best[c - 1][i - 1] + seg_cost[i][j]
                if cand < best[c][j]:
                    best[c][j] = cand
                    cut[c][j] = i
    segs = min(range(k), key=lambda c: best[c][m - 1])
    bounds = []
    j = m - 1
    for c in range(segs, 0, -1):
        i = cut[c][j]
        bounds.append((i, j))
        j = i - 1
    bounds.append((0, j))
    return sorted(seg_class[i][j] for i, j in bounds)
