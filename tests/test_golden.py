"""Golden-file tests against the reference's own corpus
(tests/test-aligner.sh analog): scores must match
tests/data/results/test.score.affine.p{0,1,2}.alg bit-for-bit."""
from pathlib import Path

import numpy as np
import pytest

from wfa_tpu import AlignmentOptions, Penalties, align_pairs
from wfa_tpu.utils.io import read_seq_file

DATA = Path(__file__).parent / "data"

PENALTY_SETS = [
    (Penalties(1, 2, 1), "p0"),
    (Penalties(3, 1, 4), "p1"),
    (Penalties(5, 3, 2), "p2"),
]


def load_corpus(max_len=None):
    batch = read_seq_file(DATA / "wfa.utest.seq")
    idx = range(len(batch))
    if max_len is not None:
        idx = [
            i for i in idx
            if max(len(batch.patterns[i]), len(batch.texts[i])) <= max_len
        ]
    return (
        [batch.patterns[i] for i in idx],
        [batch.texts[i] for i in idx],
        list(idx),
    )


def golden_scores(tag):
    path = DATA / "results" / f"test.score.affine.{tag}.alg"
    return [int(line.split()[0]) for line in path.read_text().splitlines() if line.strip()]


@pytest.mark.parametrize("pen,tag", PENALTY_SETS)
def test_golden_scores_short(pen, tag):
    """All pairs up to 2kbp (295 of 305); the 10kbp tier runs in the slow
    test below and in chip_smoke.py on the card."""
    pats, txts, idx = load_corpus(max_len=2048)
    golden = golden_scores(tag)
    res = align_pairs(
        pats, txts,
        AlignmentOptions(penalties=pen, max_error=10000, cpu_fallback=False),
    )
    for j, i in enumerate(idx):
        assert -res[j].error == golden[i], (i, -res[j].error, golden[i])


@pytest.mark.parametrize("pen,tag", [PENALTY_SETS[0]])
def test_golden_cigars_short(pen, tag):
    from wfa_tpu.utils.verification import affine_score, check_cigar

    pats, txts, idx = load_corpus(max_len=256)
    golden = golden_scores(tag)
    res = align_pairs(
        pats, txts,
        AlignmentOptions(penalties=pen, max_error=300, compute_cigar=True),
    )
    for j, i in enumerate(idx):
        assert -res[j].error == golden[i]
        assert check_cigar(res[j].cigar, pats[j], txts[j]), res[j].cigar
        assert affine_score(res[j].cigar, pen) == res[j].error


def test_low_max_error_forces_cpu_recovery():
    """test-aligner.sh:27 analog: -e 25 forces the CPU path; results must
    still match the golden scores."""
    pen, tag = PENALTY_SETS[0]
    pats, txts, idx = load_corpus(max_len=2048)
    golden = golden_scores(tag)
    res = align_pairs(
        pats, txts, AlignmentOptions(penalties=pen, max_error=25)
    )
    n_cpu = sum(not r.finished_on_accelerator for r in res)
    assert n_cpu > 0  # some pairs must exceed 25 steps
    for j, i in enumerate(idx):
        assert -res[j].error == golden[i]


@pytest.mark.slow
@pytest.mark.parametrize("pen,tag", PENALTY_SETS)
def test_golden_scores_full(pen, tag):
    pats, txts, idx = load_corpus()
    golden = golden_scores(tag)
    res = align_pairs(
        pats, txts,
        AlignmentOptions(penalties=pen, max_error=10000, cpu_fallback=False),
    )
    for j, i in enumerate(idx):
        assert -res[j].error == golden[i]
