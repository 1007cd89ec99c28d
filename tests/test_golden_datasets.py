"""Golden-score parity on the reference's embedded API-test datasets
(tests/data/sequences_10K.h and sequences_1000.h in the reference, converted
to .seq + JSON here; the reference asserts these in tests/test_api.c).

Scores in the golden files are WFA2-lib convention (negative cost); our
engines report positive distance, so the assertion is error == -golden.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from wfa_tpu import native
from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils.io import read_seq_file

DATA = Path(__file__).parent / "data"


def _load(name):
    batch = read_seq_file(DATA / f"{name}.seq")
    golden = json.loads((DATA / f"{name}.golden.json").read_text())
    return batch, golden


@pytest.mark.skipif(not native.available(), reason="native engine not built")
@pytest.mark.parametrize(
    "name,key,pen",
    [
        ("seq_10K_n100", "results_10K_n100_x2o3e1", Penalties(2, 3, 1)),
        ("seq_10K_n100", "results_10K_n100_x3o5e2", Penalties(3, 5, 2)),
        ("seq_1000_n1000", "results_1000_n1000_x2o3e1", Penalties(2, 3, 1)),
        ("seq_1000_n1000", "results_1000_n1000_x5o3e2", Penalties(5, 3, 2)),
    ],
)
def test_cpu_engine_golden(name, key, pen):
    """The native CPU WFA engine must reproduce every reference golden score."""
    batch, golden = _load(name)
    expect = np.array(golden[key], dtype=np.int32)
    mask = np.ones(len(batch.patterns), dtype=np.int8)
    dist, _, _ = native.cpu_align_batch(
        batch.patterns, batch.texts, pen, mask, False
    )
    np.testing.assert_array_equal(dist, -expect)


def test_device_engine_golden_1000_subset():
    """Device engine (XLA on the CPU test mesh) vs golden scores on a subset
    of the 1kbp dataset (the full runs are exercised on real hardware)."""
    batch, golden = _load("seq_1000_n1000")
    expect = [-v for v in golden["results_1000_n1000_x2o3e1"][:16]]
    opts = AlignmentOptions(
        penalties=Penalties(2, 3, 1), max_error=300
    )
    res = align_pairs(batch.patterns[:16], batch.texts[:16], opts)
    assert [r.error for r in res] == expect
