"""Differential test over randomized penalty configurations.

The engines' static schedule (wavefront existence, ring slots, tie-breaking)
depends only on (x, o, e); golden datasets cover five configs — this sweeps
odd corners (e > o, x = 1, o = 0, large gaps) against the pure-Python oracle.
"""
import random

import pytest

from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.cpu_wfa import align_one_py
from wfa_tpu.utils.verification import affine_score, check_cigar

PENALTY_SET = [
    Penalties(1, 1, 1),
    Penalties(1, 0, 1),    # zero gap-open
    Penalties(1, 5, 3),    # e > x
    Penalties(4, 1, 2),
    Penalties(6, 2, 5),
    Penalties(2, 10, 1),   # expensive open, cheap extend
    Penalties(9, 7, 4),
    Penalties(45, 8, 3),   # 46-score working set (two-word bitmask word 2)
]


def _pairs(seed):
    rng = random.Random(seed)

    def mutate(s, err):
        out = list(s)
        for _ in range(int(len(s) * err)):
            op = rng.choice("XID")
            pos = rng.randrange(max(1, len(out)))
            if op == "X":
                out[pos] = rng.choice("ACGT")
            elif op == "I":
                out.insert(pos, rng.choice("ACGT"))
            elif len(out) > 1:
                del out[pos]
        return "".join(out)

    pairs = []
    for L in (6, 30, 70):
        for err in (0.0, 0.1, 0.25):
            p = "".join(rng.choice("ACGT") for _ in range(L))
            pairs.append((p.encode(), mutate(p, err).encode()))
    return pairs


@pytest.mark.parametrize("pen", PENALTY_SET, ids=lambda p: f"x{p.x}o{p.o}e{p.e}")
def test_engine_matches_oracle_random_penalties(pen):
    pairs = _pairs(hash((pen.x, pen.o, pen.e)) & 0xFFFF)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    opts = AlignmentOptions(
        penalties=pen, compute_cigar=True, max_error=120
    )
    res = align_pairs(pats, txts, opts)
    for (p, t), r in zip(pairs, res):
        oracle, _ = align_one_py(p, t, pen, False)
        assert r.error == oracle, (pen, p, t, r.error, oracle)
        assert check_cigar(r.cigar, p, t), (pen, p, t, r.cigar)
        assert affine_score(r.cigar, pen) == r.error
