"""Exact windows wider than 1024 diagonals: the device engine holds the
whole 2*min(max_error, tier+2)+1 window, so there is no width cap and no
certificate — every pair finishes on the device with its optimal score,
including distances past 3077 (the bound a 6144-diagonal cap would give at
penalties 2,3,1)."""
import numpy as np

from wfa_tpu import native
from wfa_tpu.aligner import _plan_tiers, align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils import synth
from wfa_tpu.utils.verification import affine_score, check_cigar

PEN = Penalties(2, 3, 1)


def _check_on_device(pats, txts, res, pen):
    mask = np.ones(len(pats), dtype=np.int8)
    oracle, _, _ = native.cpu_align_batch(pats, txts, pen, mask, False)
    assert all(r.finished_on_accelerator for r in res)
    assert [r.error for r in res] == oracle.tolist()


def _window(pats, txts, opts):
    lens = np.array([max(len(p), len(t)) for p, t in zip(pats, txts)])
    return {p.wf_width for p in _plan_tiers(lens, opts, opts.max_error)}


def test_wide_exact_window_distance():
    pats, txts = synth.read_pairs(np.random.default_rng(1), 8, 700, 0.1)
    opts = AlignmentOptions(penalties=PEN, max_error=800, data_parallel=False)
    assert min(_window(pats, txts, opts)) > 1024
    _check_on_device(pats, txts, align_pairs(pats, txts, opts), PEN)


def test_wide_exact_window_cigar():
    pats, txts = synth.read_pairs(np.random.default_rng(2), 8, 700, 0.1)
    opts = AlignmentOptions(
        penalties=PEN, max_error=800, compute_cigar=True, data_parallel=False
    )
    assert min(_window(pats, txts, opts)) > 1024
    res = align_pairs(pats, txts, opts)
    _check_on_device(pats, txts, res, PEN)
    for p, t, r in zip(pats, txts, res):
        assert check_cigar(r.cigar, p, t)
        assert affine_score(r.cigar, PEN) == r.error


def test_exact_distance_past_old_certificate_short_reads():
    # Unrelated 700bp reads at expensive penalties: distances above 3077.
    pen = Penalties(12, 8, 6)
    rng = np.random.default_rng(3)
    pats = synth.random_reads(rng, 8, 700)
    txts = synth.random_reads(rng, 8, 700)
    opts = AlignmentOptions(penalties=pen, max_error=8000, data_parallel=False)
    res = align_pairs(pats, txts, opts)
    assert min(r.error for r in res) > 3077
    _check_on_device(pats, txts, res, pen)
