"""Edge-case behavior of the full align_pairs path (XLA engine on CPU).

The reference handles these implicitly (N-detection in the packing kernel
routes to CPU, sequence_packing_kernel.cu:68-76; empty/short sequences flow
through the same recurrence); here they are pinned as tests.
"""
import pytest

from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.cpu_wfa import align_one_py
from wfa_tpu.utils.verification import affine_score, check_cigar

PEN = Penalties(2, 3, 1)


def _run(pairs, **kw):
    opts = AlignmentOptions(
        penalties=PEN, compute_cigar=True, max_error=64, **kw
    )
    return align_pairs([p for p, _ in pairs], [t for _, t in pairs], opts)


def _oracle(p, t):
    d, _ = align_one_py(p, t, PEN, False)
    return d


CASES = [
    (b"", b""),                      # both empty
    (b"ACGT", b"ACGT"),              # identical
    (b"A", b"C"),                    # single-base mismatch
    (b"A", b"A"),                    # single-base match
    (b"", b"ACGTAC"),                # empty pattern (pure insertion)
    (b"ACGTAC", b""),                # empty text (pure deletion)
    (b"ACGT", b"ACGTACGTACGT"),      # long insertion tail
    (b"ACGTACGTACGT", b"ACGT"),      # long deletion tail
    (b"AAAA", b"TTTT"),              # all mismatches
]


def test_edge_pairs_scores_and_cigars():
    res = _run(CASES)
    for (p, t), r in zip(CASES, res):
        assert r.error == _oracle(p, t), (p, t, r.error)
        assert check_cigar(r.cigar, p, t), (p, t, r.cigar)
        assert affine_score(r.cigar, PEN) == r.error


def test_n_bases_route_to_cpu():
    pairs = [(b"ACGTNACGT", b"ACGTTACGT"), (b"ACGTACGT", b"ACGTACGT")]
    res = _run(pairs)
    # The N pair must not run on the device engine.
    assert not res[0].finished_on_accelerator
    assert res[1].finished_on_accelerator
    for (p, t), r in zip(pairs, res):
        assert r.error == _oracle(p, t)
        assert check_cigar(r.cigar, p, t)


def test_lowercase_routes_to_cpu_and_aligns():
    pairs = [(b"acgtacgt", b"acgtacgt")]
    res = _run(pairs)
    assert res[0].error == 0


def test_mismatched_list_lengths_raise():
    with pytest.raises(ValueError):
        align_pairs([b"A"], [], AlignmentOptions(penalties=PEN))


def test_empty_batch():
    assert align_pairs([], [], AlignmentOptions(penalties=PEN)) == []


def test_device_retry_escalates_before_cpu_fallback():
    """Pairs whose distance exceeds max_error get a second device pass at a
    doubled budget (AlignmentOptions.device_retries) before the CPU fallback
    (reference contract: unfinished pairs are always recomputed,
    lib/align.cu:236-249 — here the recompute stays on the accelerator when
    the bigger budget suffices)."""
    # distance 2*10 = 20 > max_error 16, but < the retry budget 32.
    p = b"ACGT" * 16
    t = b"TCGT" * 8 + b"ACGT" * 8  # 8 mismatches, distance 16 > max_error?
    pairs = [(p, t), (p, p)]
    res = _run(pairs, device_retries=1)
    assert res[0].error == _oracle(p, t)
    assert res[0].error > 8  # genuinely past the first budget below
    opts_low = AlignmentOptions(
        penalties=PEN, compute_cigar=True, max_error=res[0].error - 2,
        device_retries=1,
    )
    r1 = align_pairs([p, p], [t, p], opts_low)
    assert r1[0].finished_on_accelerator
    assert r1[0].error == res[0].error
    assert check_cigar(r1[0].cigar, p, t)
    # With retries disabled the same pair must take the CPU fallback.
    opts_none = AlignmentOptions(
        penalties=PEN, compute_cigar=True, max_error=res[0].error - 2,
        device_retries=0,
    )
    r0 = align_pairs([p, p], [t, p], opts_none)
    assert not r0[0].finished_on_accelerator
    assert r0[0].error == res[0].error


def test_device_retry_skips_non_acgt():
    """Non-ACGT pairs can never finish on device; the retry tier must not
    re-run them (they go straight to the CPU fallback)."""
    p, t = b"ACGTNACGT" * 8, b"ACGTTACGT" * 8
    opts = AlignmentOptions(
        penalties=PEN, compute_cigar=True, max_error=4,
        device_retries=3,
    )
    res = align_pairs([p], [t], opts)
    assert not res[0].finished_on_accelerator
    assert res[0].error == _oracle(p, t)
