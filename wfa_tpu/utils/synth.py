"""Seeded synthetic read pairs for bench.py, chip_smoke.py and the tools.

Every generator takes a ``numpy.random.Generator`` so a run is reproducible
from its seed.
"""
from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_reads(rng: np.random.Generator, n: int, length: int) -> list[bytes]:
    """``n`` uniform random ACGT reads of ``length`` bases."""
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    return [row.tobytes() for row in _BASES[codes]]


def mutate(rng: np.random.Generator, seqs: list[bytes], err: float) -> list[bytes]:
    """Copies of ``seqs`` with about ``err * len`` edits each: 60%
    substitutions, 20% single-base deletions, 20% single-base insertions."""
    out = []
    for s in seqs:
        arr = np.frombuffer(s, dtype=np.uint8).copy()
        n = len(arr)
        nmut = int(n * err)
        pos = rng.integers(0, n, size=nmut)
        kinds = rng.random(nmut)
        sub_pos = pos[kinds < 0.6]
        arr[sub_pos] = _BASES[rng.integers(0, 4, size=len(sub_pos))]
        del_pos = np.unique(pos[(kinds >= 0.6) & (kinds < 0.8)])
        keep = np.ones(n, dtype=bool)
        keep[del_pos] = False
        arr = arr[keep]
        ins_pos = np.sort(pos[kinds >= 0.8]) % max(len(arr), 1)
        arr = np.insert(
            arr, ins_pos, _BASES[rng.integers(0, 4, size=len(ins_pos))]
        )
        out.append(arr.tobytes())
    return out


def read_pairs(
    rng: np.random.Generator, n: int, length: int, err: float
) -> tuple[list[bytes], list[bytes]]:
    """``n`` (pattern, text) pairs: random patterns, texts mutated at ``err``."""
    pats = random_reads(rng, n, length)
    return pats, mutate(rng, pats, err)
