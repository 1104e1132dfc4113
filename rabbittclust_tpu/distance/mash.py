"""Mash / AAF-containment distance math (float64, exact vs reference).

Formulas (reference src/MST.cpp:514-540, src/greedy.cpp:526-543):
  jaccard     j = |A∩B| / (|A| + |B| - |A∩B|)
  Mash        D = -(1/k) * ln(2j / (1+j));  j=1 -> 0, j=0 -> 1
  containment c = |A∩B| / min(|A|, |B|)
  AAF         D = -(1/k) * ln(c);           c=1 -> 0, c=0 -> 1

All final distances are computed on the host in float64 from exact integer
intersection counts — device kernels only produce the integer counts, so device
float rounding can never change a cluster decision.
"""

from __future__ import annotations

import math

import numpy as np


def jaccard_index(common, size0, size1):
    common = np.asarray(common, dtype=np.float64)
    denom = np.asarray(size0, dtype=np.float64) + size1 - common
    with np.errstate(divide="ignore", invalid="ignore"):
        j = np.where(denom == 0, 0.0, common / np.maximum(denom, 1e-300))
    return j


def mash_distance(common, size0, size1, kmer_size: int) -> np.ndarray:
    """Vectorized Mash distance from integer intersection counts."""
    j = jaccard_index(common, size0, size1)
    with np.errstate(divide="ignore", invalid="ignore"):
        core = -(1.0 / kmer_size) * np.log(2.0 * j / (1.0 + j))
    d = np.where(j == 1.0, 0.0, np.where(j == 0.0, 1.0, core))
    return d


def aaf_distance(common, size0, size1, kmer_size: int) -> np.ndarray:
    """Vectorized AAF/containment distance."""
    common = np.asarray(common, dtype=np.float64)
    mins = np.minimum(np.asarray(size0, dtype=np.float64), size1)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(mins == 0, 0.0, common / np.maximum(mins, 1e-300))
        core = -(1.0 / kmer_size) * np.log(np.maximum(c, 1e-300))
    d = np.where(c == 1.0, 0.0, np.where(c == 0.0, 1.0, core))
    return d


def size_ratio_limit(threshold: float, k: int) -> int:
    """Pair-pruning ratio R = 2*e^{D*k} - 1, truncated to int exactly as the
    reference stores it (``int radio = calr(threshold, kmer_size-1)``,
    src/MST.cpp:26-37,224)."""
    if threshold < 0:
        raise ValueError("Mash distance cannot be negative.")
    if k <= 0:
        raise ValueError("k-mer size must be positive.")
    return int(2.0 * math.exp(threshold * k) - 1.0)


def min_jaccard_for_threshold(threshold: float, kmer_size: int) -> float:
    """Greedy candidate bound: j_min = x/(2-x), x = e^{-d*k}
    (reference src/greedy.cpp:652-654)."""
    x = math.exp(-threshold * kmer_size)
    return x / (2.0 - x)


def min_common_for_pair(j_min: float, size0: int, size1: int) -> int:
    """common >= ceil(j_min*(|A|+|B|)/(1+j_min)) (src/greedy.cpp:774)."""
    return int(math.ceil(j_min * (size0 + size1) / (1.0 + j_min)))


def max_distance_for_sketch(min_jaccard: float, kmer_size: int) -> float:
    """Mash inversion used by parameter tuning (src/sub_command.cpp:2356-2360)."""
    if min_jaccard >= 1.0:
        return 1.0
    return -1.0 / kmer_size * math.log(2 * min_jaccard / (1.0 + min_jaccard))
