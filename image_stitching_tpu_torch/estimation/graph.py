"""The match graph as Graphviz DOT (port of `estimation/graph.py`): one
edge per pair with confidence above the threshold, labelled with its
matches, inliers and confidence; images with no such edge as isolated
nodes."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["matches_graph_dot"]


def matches_graph_dot(names: Sequence[str], confidence: np.ndarray,
                      num_inliers: np.ndarray, num_matches: np.ndarray,
                      conf_threshold: float) -> str:
    """DOT text of the match graph (edges where conf > threshold)."""
    conf = np.asarray(confidence)
    inl = np.asarray(num_inliers)
    nm = np.asarray(num_matches)
    n = conf.shape[0]
    lines = ["graph matches_graph {"]
    connected = set()
    for i in range(n):
        for j in range(i + 1, n):
            if conf[i, j] > conf_threshold:
                a = os.path.basename(str(names[i]))
                b = os.path.basename(str(names[j]))
                lines.append(
                    f'"{a}" -- "{b}"'
                    f'[label="Nm={int(nm[i, j])}, Ni={int(inl[i, j])}, '
                    f'C={conf[i, j]:.5g}"];')
                connected.update((i, j))
    for i in range(n):
        if i not in connected:
            lines.append(f'"{os.path.basename(str(names[i]))}";')
    lines.append("}")
    return "\n".join(lines)
