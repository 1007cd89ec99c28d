"""Divergence-ordered device tiling.

A device tile runs until its slowest lane finishes, so grouping alignments
of similar *distance* into the same tile shortens the tiles that would
otherwise wait on one divergent lane.  Length is a weak predictor of
distance; the reference has no analog of this because its persistent-kernel
work pool load-balances dynamically
(lib/kernels/common_alignment_kernels.cuh:123-126).  The gain on the GPU
engine is not measured.

`divergence_score` is the cheap host-side predictor that makes this
practical: sample ~48 k-mers of the pattern and test whether each occurs in
the text within an indel-drift window around its own position; the miss
fraction tracks the pair's divergence.  bytes.find runs at C speed, so the
scan is cheap next to aligning a long read.
"""
from __future__ import annotations

import numpy as np

# Only long tiers benefit (short-read tiles finish in lockstep anyway) and
# only they can amortize the host scan.
MIN_PRESORT_TIER = 4096


def divergence_score(
    pattern: bytes,
    text: bytes,
    anchors: int = 32,
    k: int = 12,
) -> float:
    """Estimated divergence in [0, 1]; monotone-ish in alignment distance.

    The drift window is capped: anchors past the cumulative-indel horizon of
    a high-divergence pair read as misses, which only pushes its score
    further up — ranking (all that matters for tiling) is preserved while
    the byte scan stays short.
    """
    L = min(len(pattern), len(text))
    if L < 4 * k:
        return 0.0
    step = max(1, (L - k) // anchors)
    hits = 0
    total = 0
    for pos in range(0, L - k, step):
        slack = min(32 + (pos >> 3), 192)
        w0 = max(0, pos - slack)
        w1 = min(len(text), pos + k + slack)
        hits += text.find(pattern[pos : pos + k], w0, w1) >= 0
        total += 1
    return 1.0 - hits / max(total, 1)


def divergence_scores(patterns, texts, lens=None) -> np.ndarray:
    """Scores for every pair; pairs below MIN_PRESORT_TIER get 0 (their
    relative order then falls back to length)."""
    out = np.zeros(len(patterns))
    for i, (p, t) in enumerate(zip(patterns, texts)):
        if lens is not None and lens[i] < MIN_PRESORT_TIER:
            continue
        out[i] = divergence_score(p, t)
    return out
