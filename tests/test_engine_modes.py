"""align_pairs in exact and banded mode, distance and CIGAR, over penalty
sets that reach the recurrence's tie-breaking corners (gap-open cheaper
than a mismatch, e > o, o = 0)."""
import pytest

from wfa_tpu import native
from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.verification import affine_score, check_cigar

from test_engine import make_pairs

PENALTIES = [
    Penalties(2, 3, 1), Penalties(3, 5, 2), Penalties(4, 1, 2),
    Penalties(1, 0, 1),
]


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize(
    "pen", PENALTIES, ids=lambda p: f"x{p.x}o{p.o}e{p.e}"
)
@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_align_pairs_modes(band, pen, cigar):
    pairs = make_pairs(17, sizes=(10, 60, 120), errs=(0.0, 0.1))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    res = align_pairs(pats, txts, AlignmentOptions(
        penalties=pen, max_error=100, band=band, compute_cigar=cigar,
    ))
    for p, t, r in zip(pats, txts, res):
        oracle = native.cpu_align_single(p, t, pen)
        if band < 0:
            assert r.finished_on_accelerator, (p, t)
            assert r.error == oracle, (p, t, r.error, oracle)
        else:
            # Banded is a heuristic: never below the optimum.
            assert r.error >= oracle, (p, t, r.error, oracle)
        if cigar:
            assert check_cigar(r.cigar, p, t), (p, t, r.cigar)
            assert affine_score(r.cigar, pen) == r.error
        else:
            assert r.cigar == ""
