"""Tests that need an NVIDIA GPU: the device engine compiled for the card
against the same engine on the CPU backend, the wide working set, and data
parallelism over the visible cards.  They skip where JAX sees no GPU; run
them on the card with ``python -m pytest tests/ -m gpu``."""
import jax
import numpy as np
import pytest

from wfa_tpu import native
from wfa_tpu.aligner import align_pairs
from wfa_tpu.params import AlignmentOptions
from wfa_tpu.types import Penalties
from wfa_tpu.utils import synth

pytestmark = pytest.mark.gpu


def _key(res):
    return [(r.error, r.cigar, r.finished_on_accelerator) for r in res]


def _pairs(seed, n=24):
    rng = np.random.default_rng(seed)
    pats, txts = [], []
    for length, err in ((80, 0.05), (300, 0.1), (900, 0.03)):
        p, t = synth.read_pairs(rng, n // 3, length, err)
        pats += p
        txts += t
    return pats, txts


@pytest.mark.parametrize("cigar", [False, True], ids=["distance", "cigar"])
@pytest.mark.parametrize("band", [-1, 25], ids=["exact", "banded"])
def test_gpu_engine_matches_cpu_backend(gpu_device, band, cigar):
    pats, txts = _pairs(1)
    opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=200,
                            band=band, compute_cigar=cigar,
                            data_parallel=False)
    with jax.default_device(gpu_device):
        on_gpu = align_pairs(pats, txts, opts)
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = align_pairs(pats, txts, opts)
    assert _key(on_gpu) == _key(on_cpu)
    assert all(r.finished_on_accelerator for r in on_gpu)


def test_gpu_wide_working_set(gpu_device):
    pen = Penalties(70, 2, 1)
    pats, txts = _pairs(2)
    with jax.default_device(gpu_device):
        res = align_pairs(pats, txts, AlignmentOptions(penalties=pen))
    mask = np.ones(len(pats), dtype=np.int8)
    oracle, _, _ = native.cpu_align_batch(pats, txts, pen, mask, False)
    assert all(r.finished_on_accelerator for r in res)
    assert [r.error for r in res] == oracle.tolist()


def test_gpu_data_parallel_matches_one_card(gpu_device):
    pats, txts = _pairs(3, n=48)
    out = {}
    for dp in (True, False):
        out[dp] = _key(align_pairs(pats, txts, AlignmentOptions(
            penalties=Penalties(2, 3, 1), max_error=200, compute_cigar=True,
            data_parallel=dp,
        )))
    assert out[True] == out[False]
