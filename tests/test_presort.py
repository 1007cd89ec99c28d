"""Divergence estimator for distance-ordered device tiling."""
import numpy as np

from wfa_tpu.types import Penalties
from wfa_tpu.utils.presort import divergence_score, divergence_scores


def _mutate(rng, seq, err):
    bases = b"ACGT"
    out = bytearray(seq)
    n = int(len(out) * err)
    for _ in range(n):
        op = rng.integers(0, 3)
        pos = int(rng.integers(0, max(1, len(out))))
        if op == 0:
            out[pos] = bases[rng.integers(0, 4)]
        elif op == 1:
            out.insert(pos, bases[rng.integers(0, 4)])
        elif len(out) > 1:
            del out[pos]
    return bytes(out)


def test_score_monotone_in_error_rate():
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    p = rng.choice(bases, size=8000).tobytes()
    scores = [
        divergence_score(p, _mutate(rng, p, e))
        for e in (0.0, 0.02, 0.06, 0.12, 0.25)
    ]
    assert scores[0] == 0.0
    assert all(b > a - 0.05 for a, b in zip(scores, scores[1:]))
    assert scores[-1] > scores[0] + 0.3


def test_scores_rank_diverse_batch():
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts, errs = [], [], []
    for _ in range(40):
        p = rng.choice(bases, size=6000).tobytes()
        e = float(rng.uniform(0.01, 0.10))
        pats.append(p)
        txts.append(_mutate(rng, p, e))
        errs.append(e)
    s = divergence_scores(pats, txts, np.full(40, 6000))
    rs = np.argsort(np.argsort(s))
    re = np.argsort(np.argsort(errs))
    rho = np.corrcoef(rs, re)[0, 1]
    assert rho > 0.7, rho


def test_short_pairs_skipped():
    s = divergence_scores([b"ACGT" * 10], [b"ACGT" * 10], np.array([40]))
    assert s[0] == 0.0


def test_align_pairs_results_stay_in_input_order():
    """The divergence sort reorders device tiles, never the results."""
    from wfa_tpu import AlignmentOptions, Penalties, align_pairs

    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = [], []
    for e in (0.08, 0.01, 0.05, 0.0, 0.03, 0.06, 0.02, 0.04):
        p = rng.choice(bases, size=5000).tobytes()
        pats.append(p)
        txts.append(_mutate(rng, p, e))
    res = align_pairs(
        pats, txts,
        AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=2500),
    )
    from wfa_tpu import native

    for p, t, r in zip(pats, txts, res):
        assert r.error == native.cpu_align_single(p, t, Penalties(2, 3, 1))
