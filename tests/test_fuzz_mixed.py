"""Fuzz the full aligner path with mixed-length batches.

Random pairs spanning several length tiers in one batch exercise the tier
planner (binning, per-tier widths, certificates, bucketing, CPU routing) in
combinations the targeted tests don't; every score and CIGAR is checked
against the Python oracle.
"""
import random

from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.cpu_wfa import align_one_py
from wfa_tpu.utils.verification import affine_score, check_cigar

PEN = Penalties(2, 3, 1)


def _random_pairs(rng, n):
    def mutate(s, err):
        out = list(s)
        for _ in range(int(len(s) * err)):
            op = rng.choice("XIDN")
            pos = rng.randrange(max(1, len(out)))
            if op == "X":
                out[pos] = rng.choice("ACGT")
            elif op == "I":
                out.insert(pos, rng.choice("ACGT"))
            elif op == "N":
                # occasionally inject an ambiguous base -> CPU routing
                if rng.random() < 0.05:
                    out[pos] = "N"
            elif len(out) > 1:
                del out[pos]
        return "".join(out)

    pairs = []
    for _ in range(n):
        L = rng.choice([3, 17, 64, 90, 200, 333, 512, 700])
        err = rng.choice([0.0, 0.05, 0.2, 0.4])
        p = "".join(rng.choice("ACGT") for _ in range(L))
        pairs.append((p.encode(), mutate(p, err).encode()))
    return pairs


def test_fuzz_mixed_lengths_cigar():
    rng = random.Random(1234)
    pairs = _random_pairs(rng, 60)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    opts = AlignmentOptions(
        penalties=PEN, compute_cigar=True, max_error=400
    )
    res = align_pairs(pats, txts, opts)
    for i, ((p, t), r) in enumerate(zip(pairs, res)):
        oracle, _ = align_one_py(p, t, PEN, False)
        assert r.error == oracle, (i, len(p), len(t), r.error, oracle)
        assert check_cigar(r.cigar, p, t), (i, r.cigar[:60])
        assert affine_score(r.cigar, PEN) == r.error


def test_fuzz_mixed_lengths_banded_distance():
    rng = random.Random(99)
    pairs = _random_pairs(rng, 40)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    opts = AlignmentOptions(
        penalties=PEN, max_error=400, band=25
    )
    res = align_pairs(pats, txts, opts)
    for i, ((p, t), r) in enumerate(zip(pairs, res)):
        oracle, _ = align_one_py(p, t, PEN, False)
        # Banded is a heuristic: scores are lower-bounded by the optimum.
        assert r.error >= oracle, (i, r.error, oracle)
