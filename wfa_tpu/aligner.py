"""Public aligner API — the L5 layer of the framework.

Role-equivalent to the reference's aligner object and batch orchestration
(lib/aligner.c:114-260 `wfagpu_add_sequences` / `wfagpu_align`, and
lib/align.cu:42-481 `launch_alignments`), redesigned for batched
execution of one static-shape XLA program per tile:

* Pairs are **binned by length tier** (powers of two) instead of using the
  first batch's sizes for buffer sizing (lib/align.cu:83-94): each tier
  compiles one static-shape engine and runs dense tiles, replacing the
  persistent-kernel work pool with batch tiles.
* Unfinished / N-containing / oversized pairs go to the native CPU fallback
  engine exactly like the reference routes them to WFA2-lib
  (lib/align.cu:236-249, sequence_packing_kernel.cu:68-76).
* CIGARs for device-finished pairs are decoded from the engine's choice
  tables by the native OpenMP decoder (utils/cigar.c analog).

Like the reference, the CPU fallback runs the WFA-adaptive heuristic when the
device ran banded (utils/wfa_cpu.c:48) and exact otherwise; the pure-Python
fallback engine is always exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .ops.packing import pack_batch
from .params import AlignmentOptions, default_band_width, default_max_error
from .schedule import build_schedule
from .types import MAX_SEQ_LEN, AlignmentResult
from .utils.logger import LOG
from .utils.presort import MIN_PRESORT_TIER

_MIN_TIER = 64


def _tier_of(length: int) -> int:
    t = _MIN_TIER
    while length + 2 > t:
        t *= 2
    return t


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@dataclasses.dataclass
class _TierPlan:
    tier: int
    indices: list[int]
    wf_width: int
    tile_batch: int
    nwords: int
    score_limit: int | None


def _plan_tiers(
    lens: np.ndarray, opts: AlignmentOptions, max_error: int,
    cost_hint: np.ndarray | None = None,
) -> list[_TierPlan]:
    pen = opts.penalties
    tiers: dict[int, list[int]] = {}
    for i, L in enumerate(lens):
        tiers.setdefault(_tier_of(int(L)), []).append(i)

    plans = []
    for tier, idxs in sorted(tiers.items()):
        # Order within the tier so each device tile holds alignments of
        # similar cost — tiles run until their slowest lane finishes.  The
        # estimated-divergence hint groups by predicted *distance* (oracle
        # distance ordering measured 1.74x on diverse 14kbp batches;
        # utils/presort.py), with length as the tie-break / fallback.
        if cost_hint is not None:
            idxs.sort(key=lambda i: (-cost_hint[i], -int(lens[i])))
        else:
            idxs.sort(key=lambda i: -int(lens[i]))
        if opts.banded:
            width = opts.band_width or default_band_width(max_error)
            w = min(width, 2 * (tier + 2) + 1)
            score_limit = None
        else:
            w2 = min(max_error, tier + 2)
            w = 2 * w2 + 1
            # Cost of the all-indels alignment bounds the optimum, so the
            # schedule never needs scores beyond it for this tier.
            score_limit = 2 * pen.o + pen.e * 2 * (tier + 2) + pen.x
        sched = build_schedule(pen, max_error, score_limit if not opts.banded else None)
        if opts.compute_cigar:
            # Choice-table bytes per alignment, times 3 for XLA's lane padding
            # and the while-loop's double-buffered carry — undersizing this
            # can OOM the device on long-read exact-CIGAR tiles.
            per_lane = sched.num_steps * w * 3
        else:
            per_lane = 3 * pen.active_working_set * w * 4 * 2
        per_lane = max(per_lane, 1)
        tile = opts.tile_batch or max(
            8, min(2048, opts.memory_budget_bytes // per_lane)
        )
        if opts.compute_cigar and w >= 2048:
            # Memory bound: a wide exact-CIGAR tile carries an [S, B, W] u8
            # choice table through the score loop, about 18 MB per lane at
            # 10kbp and -e 3000 (S ~ 3000, W = 6001); 16 lanes keep it near
            # 300 MB, with room for the loop's copies of the carry.
            tile = min(tile, 16)
        tile = min(_round_up(len(idxs), 8), _round_up(tile, 8))
        nwords = tier // 16 + 1
        plans.append(_TierPlan(tier, idxs, w, tile, nwords, score_limit))
    return plans


def align_pairs(
    patterns: list[bytes],
    texts: list[bytes],
    options: AlignmentOptions | None = None,
) -> list[AlignmentResult]:
    """Align a batch of (pattern, text) pairs; the functional core API."""
    import jax
    import jax.numpy as jnp

    from .ops.engine_xla import EngineConfig, align_batch_device

    opts = options or AlignmentOptions()
    pen = opts.penalties
    n = len(patterns)
    if n == 0:
        return []
    if len(texts) != n:
        raise ValueError("patterns and texts must have equal length")

    max_error = opts.max_error or default_max_error(
        len(patterns[0]), len(texts[0]), pen
    )

    lens = np.array(
        [max(len(p), len(t)) for p, t in zip(patterns, texts)], dtype=np.int64
    )
    results: list[AlignmentResult | None] = [None] * n
    need_cpu = np.zeros(n, dtype=bool)

    # Pairs the device engine cannot take at all.
    oversized = np.array(
        [
            len(p) >= MAX_SEQ_LEN or len(t) >= MAX_SEQ_LEN
            for p, t in zip(patterns, texts)
        ]
    )
    need_cpu |= oversized
    device_idx = [i for i in range(n) if not oversized[i]]

    band = opts.resolved_band() if opts.banded else -1

    # Local (per-process) device count: in multi-host runs the batch reaching
    # this function is already host-sharded, so tiles shard over local cards.
    ndev = jax.local_device_count() if opts.data_parallel else 1

    def _device_pass(run_idx: list[int], err: int) -> None:
        # Divergence-ordered tiling for long reads (see utils/presort.py).
        # A device tile runs until its slowest lane finishes, so cost-ordered
        # tiles reclaim finish-time variance; the native CPU fallback
        # schedules per-pair dynamically and never sees the hints.
        hints = None
        dev_lens = lens[run_idx]
        if dev_lens.size and int(dev_lens.max()) >= MIN_PRESORT_TIER:
            from .utils.presort import divergence_scores

            hints = divergence_scores(
                [patterns[i] for i in run_idx],
                [texts[i] for i in run_idx],
                dev_lens,
            )

        for plan in _plan_tiers(dev_lens, opts, err, hints):
            idxs = [run_idx[j] for j in plan.indices]
            cfg = EngineConfig(
                penalties=pen,
                max_steps=err,
                wf_width=plan.wf_width,
                compute_cigar=opts.compute_cigar,
                band=band,
                score_limit=plan.score_limit,
            )
            sched = build_schedule(pen, err, cfg.score_limit)
            step_of_score = None
            if opts.compute_cigar:
                max_sc = int(sched.score[-1]) if sched.num_steps else 0
                step_of_score = np.full(max_sc + 1, -1, dtype=np.int32)
                step_of_score[sched.score] = np.arange(
                    sched.num_steps, dtype=np.int32
                )

            for start in range(0, len(idxs), plan.tile_batch):
                chunk = idxs[start : start + plan.tile_batch]
                bsz = _round_up(plan.tile_batch, 8 * ndev)
                pats = [patterns[i] for i in chunk]
                pats += [b""] * (bsz - len(chunk))
                txts = [texts[i] for i in chunk]
                txts += [b""] * (bsz - len(chunk))

                pat_w, p_len, p_ok = pack_batch(pats, plan.nwords)
                txt_w, t_len, t_ok = pack_batch(txts, plan.nwords)
                valid = p_ok & t_ok

                dev_args = (
                    jnp.asarray(pat_w),
                    jnp.asarray(txt_w),
                    jnp.asarray(p_len),
                    jnp.asarray(t_len),
                    jnp.asarray(valid),
                )
                if ndev > 1:
                    from .parallel.mesh import align_batch_sharded, data_mesh

                    out = align_batch_sharded(cfg, data_mesh(), *dev_args)
                else:
                    out = align_batch_device(cfg, *dev_args)
                dist = np.asarray(out["distance"])
                fin = np.asarray(out["finished"])

                cigars: list[str | None] = [None] * bsz
                if opts.compute_cigar:
                    # Fetch only steps the traceback can reach (device-side
                    # slice before the D2H transfer).
                    dmax = int(dist[fin].max(initial=0))
                    smax = int(
                        step_of_score[min(dmax, len(step_of_score) - 1)]
                    )
                    rows = min(out["choices"].shape[0], smax + 2)
                    choices = np.asarray(out["choices"][:rows])
                    lo_trace = np.asarray(out["lo_trace"][:rows])
                    if native.available():
                        cigars, _ = native.traceback_batch(
                            choices, lo_trace, step_of_score, dist, fin,
                            pats, txts, pen,
                        )
                    else:
                        from .traceback import recover_cigar

                        cigars = [
                            recover_cigar(
                                choices[:, b], lo_trace[:, b], sched,
                                int(dist[b]), pats[b], txts[b],
                            )
                            if fin[b]
                            else None
                            for b in range(bsz)
                        ]

                for b, i in enumerate(chunk):
                    if fin[b]:
                        results[i] = AlignmentResult(
                            error=int(dist[b]),
                            cigar=cigars[b] or "",
                            finished_on_accelerator=True,
                        )
                    else:
                        need_cpu[i] = True

    # Escalating on-device retry tier: pairs the device left unfinished at
    # ``max_error`` get up to ``device_retries`` further device passes at a
    # doubled error budget (wider band / window) before the host takes over.
    # The reference recomputes every unfinished pair on the CPU
    # (lib/align.cu:236-249); results here stay exactly as correct — a pair
    # either finishes on device under the bigger budget or still falls back.
    # Only ACGT-clean pairs re-enter (non-ACGT can never finish on device),
    # and the budget never escalates past the all-indel cost bound.
    err_cap = 2 * pen.o + pen.e * 2 * int(lens.max(initial=0)) + pen.x
    todo = device_idx
    attempt_err = max_error
    for attempt in range(max(0, opts.device_retries) + 1):
        if not todo:
            break
        if attempt:
            LOG.debug(
                "device retry %d: %d unfinished pairs at max_error %d",
                attempt, len(todo), attempt_err,
            )
            for i in todo:
                need_cpu[i] = False
        _device_pass(todo, attempt_err)
        failed = [i for i in todo if need_cpu[i]]
        nxt = min(attempt_err * 2, err_cap)
        if nxt <= attempt_err:
            break
        attempt_err = nxt
        from .ops.packing import _ACGT

        todo = [
            i for i in failed
            if _ACGT[np.frombuffer(patterns[i], np.uint8)].all()
            and _ACGT[np.frombuffer(texts[i], np.uint8)].all()
        ]

    # ---- CPU fallback pass (lib/align.cu:236-249 analog). ----
    cpu_idx = np.flatnonzero(need_cpu)
    if cpu_idx.size and opts.cpu_fallback:
        LOG.debug("CPU fallback for %d/%d pairs", cpu_idx.size, n)
        cpats = [patterns[i] for i in cpu_idx]
        ctxts = [texts[i] for i in cpu_idx]
        mask = np.ones(len(cpats), dtype=np.int8)
        if native.available():
            # Heuristic (WFA-adaptive) CPU pass iff the device ran banded,
            # exact otherwise — utils/wfa_cpu.c:40-48 semantics.
            dist, cigs, _ = native.cpu_align_batch(
                cpats, ctxts, pen, mask, opts.compute_cigar,
                adaptive=opts.banded,
            )
        else:
            from .utils.cpu_wfa import align_one_py

            dist = np.zeros(len(cpats), dtype=np.int32)
            cigs = []
            for j, (p, t) in enumerate(zip(cpats, ctxts)):
                d, c = align_one_py(p, t, pen, opts.compute_cigar)
                dist[j] = d
                cigs.append(c)
        for j, i in enumerate(cpu_idx):
            results[i] = AlignmentResult(
                error=int(dist[j]),
                cigar=(cigs[j] or "") if opts.compute_cigar else "",
                finished_on_accelerator=False,
            )
    elif cpu_idx.size:
        LOG.warning(
            "%d pairs unfinished on device and cpu_fallback is disabled; "
            "their results carry finished=False placeholders",
            cpu_idx.size,
        )
        for i in cpu_idx:
            results[i] = AlignmentResult(
                error=0, cigar="", finished_on_accelerator=False,
                finished=False,
            )

    return results  # type: ignore[return-value]


class WfaAligner:
    """Stateful convenience wrapper (wfagpu_initialize_aligner /
    wfagpu_add_sequences / wfagpu_align, lib/aligner.h:49-63)."""

    def __init__(self, options: AlignmentOptions | None = None):
        self.options = options or AlignmentOptions()
        self._patterns: list[bytes] = []
        self._texts: list[bytes] = []
        self.results: list[AlignmentResult] = []

    def add_sequences(self, pattern: bytes | str, text: bytes | str) -> None:
        if isinstance(pattern, str):
            pattern = pattern.encode()
        if isinstance(text, str):
            text = text.encode()
        self._patterns.append(pattern)
        self._texts.append(text)

    def __len__(self) -> int:
        return len(self._patterns)

    def align(self) -> list[AlignmentResult]:
        # Honors options.batch_size via the streaming pipeline
        # (wfagpu_set_batch_size semantics, lib/aligner.c:212).
        from .pipeline import align_pairs_pipelined

        self.results = align_pairs_pipelined(
            self._patterns, self._texts, self.options
        )
        return self.results
