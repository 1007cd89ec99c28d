"""Rules of the tier planner (_plan_tiers): length tiers, window widths,
tile sizes from the memory budget, the wide exact-CIGAR clamp, score
limits and tile ordering.  Host arithmetic only, no device work."""
import random

import numpy as np
import pytest

from wfa_tpu.aligner import _plan_tiers, _round_up, _tier_of
from wfa_tpu.params import AlignmentOptions, default_band_width
from wfa_tpu.schedule import build_schedule
from wfa_tpu.types import Penalties

PEN = Penalties(2, 3, 1)


def plan(lens, max_error, hint=None, **kw):
    opts = AlignmentOptions(penalties=kw.pop("penalties", PEN), **kw)
    return _plan_tiers(np.asarray(lens), opts, max_error, hint)


def test_tier_binning():
    lens = [10, 62, 63, 100, 126, 127, 1000, 5000]
    plans = plan(lens, 50)
    assert [p.tier for p in plans] == [64, 128, 256, 1024, 8192]
    assert [sorted(p.indices) for p in plans] == [
        [0, 1], [2, 3, 4], [5], [6], [7]
    ]
    for p in plans:
        assert all(_tier_of(lens[i]) == p.tier for i in p.indices)
        assert p.nwords == p.tier // 16 + 1


def test_exact_width_covers_the_error_budget():
    assert plan([100], 50)[0].wf_width == 2 * 50 + 1
    # The window never exceeds what the tier's lengths can reach.
    assert plan([60], 10000)[0].wf_width == 2 * (64 + 2) + 1
    assert plan([14000], 3000)[0].wf_width == 6001


def test_banded_width_and_no_score_limit():
    p = plan([14000], 3000, band=25)[0]
    assert p.wf_width == default_band_width(3000) == 1024
    assert p.score_limit is None
    assert plan([14000], 3000, band=25, band_width=256)[0].wf_width == 256
    # A band wider than the tier can use is cut to 2*(tier+2)+1.
    assert plan([30], 3000, band=25)[0].wf_width == 2 * (64 + 2) + 1


def test_exact_score_limit_is_all_indel_cost():
    for pen in (PEN, Penalties(5, 3, 2), Penalties(1, 0, 1)):
        p = plan([900], 5000, penalties=pen)[0]
        assert p.score_limit == 2 * pen.o + pen.e * 2 * (1024 + 2) + pen.x


def test_distance_tile_from_budget():
    budget = 64 << 20
    p = plan([1000] * 5000, 300, memory_budget_bytes=budget)[0]
    per_lane = 3 * PEN.active_working_set * p.wf_width * 4 * 2
    assert p.tile_batch == _round_up(budget // per_lane, 8)
    # The 2048-lane cap and the batch size bound the tile too.
    assert plan([100] * 5000, 50)[0].tile_batch == 2048
    assert plan([100] * 13, 50)[0].tile_batch == 16


def test_cigar_tile_from_budget():
    budget = 256 << 20
    p = plan([1000] * 5000, 300, compute_cigar=True,
             memory_budget_bytes=budget)[0]
    steps = build_schedule(PEN, 300, p.score_limit).num_steps
    assert p.tile_batch == _round_up(budget // (steps * p.wf_width * 3), 8)


def test_wide_exact_cigar_tiles_clamped_to_16_lanes():
    assert plan([10000] * 100, 3000, compute_cigar=True)[0].tile_batch == 16
    # Distance mode at the same width, and CIGAR below 2048 diagonals,
    # keep their budget-sized tiles.
    assert plan([10000] * 100, 3000)[0].tile_batch == 104
    assert plan([1000] * 100, 300, compute_cigar=True)[0].tile_batch > 16


@pytest.mark.parametrize("n,tile", [(1, None), (9, None), (100, 5), (3, 64)])
def test_tiles_are_multiples_of_8(n, tile):
    p = plan([200] * n, 100, tile_batch=tile)[0]
    assert p.tile_batch % 8 == 0
    assert 8 <= p.tile_batch <= _round_up(n, 8)
    if tile:
        assert p.tile_batch == min(_round_up(tile, 8), _round_up(n, 8))


def test_cost_hint_orders_tiles():
    lens = [5000, 5100, 4900, 5050]
    hint = np.array([0.1, 0.1, 0.5, 0.3])
    assert plan(lens, 2000, hint)[0].indices == [2, 3, 1, 0]
    # Without a hint, longest first.
    assert plan(lens, 2000)[0].indices == [1, 3, 0, 2]


def test_plan_invariants_fuzz():
    rng = random.Random(42)
    for _ in range(200):
        n = rng.choice([1, 7, 100, 3000])
        lens = [rng.randint(1, 20000) for _ in range(n)]
        me = rng.randint(16, 5000)
        banded = rng.random() < 0.4
        cigar = rng.random() < 0.5
        budget = rng.choice([16 << 20, 256 << 20, 1 << 30])
        plans = plan(lens, me, band=25 if banded else -1,
                     compute_cigar=cigar, memory_budget_bytes=budget)
        seen = sorted(i for p in plans for i in p.indices)
        assert seen == list(range(n))
        assert [p.tier for p in plans] == sorted({p.tier for p in plans})
        for p in plans:
            assert p.wf_width % 2 == 1 or banded
            assert p.wf_width <= 2 * (p.tier + 2) + 1
            assert p.tile_batch % 8 == 0
            assert 8 <= p.tile_batch <= max(8, _round_up(len(p.indices), 8))
            if cigar and p.wf_width >= 2048:
                assert p.tile_batch <= 16
            assert (p.score_limit is None) == banded
