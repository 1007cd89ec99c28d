"""data_parallel=True shards each tile over every local device (8 virtual
CPU devices under the test settings); results must match the one-device
run bit for bit."""
import pytest

from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties

from test_engine import make_pairs


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize("band", [-1, 10], ids=["exact", "banded"])
def test_data_parallel_matches_one_device(band, cigar):
    pairs = make_pairs(29, sizes=(30, 90, 150), errs=(0.0, 0.05, 0.2))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    out = {}
    for dp in (True, False):
        res = align_pairs(pats, txts, AlignmentOptions(
            penalties=Penalties(2, 3, 1), max_error=120, band=band,
            compute_cigar=cigar, data_parallel=dp,
        ))
        out[dp] = [(r.error, r.cigar, r.finished_on_accelerator) for r in res]
    assert out[True] == out[False]
    assert sum(on_dev for _, _, on_dev in out[True]) >= len(pairs) // 2
