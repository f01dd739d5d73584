"""Keep the biggest connected component of the match graph (port of
`estimation/components.py`): union-find over pairs with confidence >=
conf_thresh, through the shared native runtime when it is built.  Host
work on the tiny (N, N) confidence table."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core import native

__all__ = ["biggest_component", "DisjointSets"]


class DisjointSets:
    """cv::detail::DisjointSets semantics (path compression + size union)."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def merge(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def biggest_component(confidence,
                      conf_thresh: float) -> Tuple[List[int], List[int]]:
    """(kept ascending, removed) for an (N, N) confidence table."""
    confidence = np.asarray(confidence)
    n = confidence.shape[0]
    kept = native.biggest_component(confidence, conf_thresh)
    if kept is not None:
        keep = set(kept)
        return kept, [i for i in range(n) if i not in keep]
    ds = DisjointSets(n)
    for i in range(n):
        for j in range(n):
            if i != j and confidence[i, j] >= conf_thresh:
                ds.merge(i, j)
    roots = [ds.find(i) for i in range(n)]
    sizes = {}
    for r in roots:
        sizes[r] = sizes.get(r, 0) + 1
    max_root = max(sizes, key=lambda r: (sizes[r], -r))
    return ([i for i in range(n) if roots[i] == max_root],
            [i for i in range(n) if roots[i] != max_root])
