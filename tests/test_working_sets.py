"""Penalty sets whose working set max(o+e, x) + 1 is wide (41 to 71 live
scores) run on the device engine like any other, on every platform."""
import jax
import pytest

from wfa_tpu import native
from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.verification import affine_score, check_cigar

from test_engine import make_pairs


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize(
    "pen",
    [Penalties(40, 3, 1), Penalties(5, 30, 20), Penalties(63, 10, 1),
     Penalties(70, 2, 1)],
    ids=["x40", "o30e20", "x63", "x70"],
)
def test_wide_working_set_on_device(monkeypatch, pen, cigar):
    assert pen.active_working_set > 40
    pairs = make_pairs(11, sizes=(20, 90), errs=(0.0, 0.1))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    oracle = [native.cpu_align_single(p, t, pen) for p, t in pairs]
    opts = AlignmentOptions(penalties=pen, max_error=700, compute_cigar=cigar)
    for platform in ("gpu", "cpu"):
        # The engine is chosen without looking at the platform.
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        res = align_pairs(pats, txts, opts)
        assert all(r.finished_on_accelerator for r in res), platform
        assert [r.error for r in res] == oracle, platform
        if cigar:
            for p, t, r in zip(pats, txts, res):
                assert check_cigar(r.cigar, p, t), (p, t, r.cigar)
                assert affine_score(r.cigar, pen) == r.error
