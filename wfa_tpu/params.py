"""Alignment options and auto-derivation heuristics.

Counterpart of ``wfa_alignment_options_t`` and its helpers
(lib/alignment_parameters.h:33-106, tools/aligner.c:311-416).  Fields map as:

* ``max_error``       — identical meaning (kernel step budget / memory sizing).
* ``band_width``      — the reference's band width is implicitly
                        ``threads_per_block`` (tools/aligner.c:413); here it
                        is an explicit wavefront-window width.
* ``num_workers``     — no analog: the device engine processes dense batch
                        tiles instead of persistent blocks pulling from an
                        atomic pool (SURVEY §2.4).
* ``batch_size``      — host streaming-pipeline batch (lib/align.cu:177).
* ``band``            — re-centering interval; <0 disables (exact mode),
                        0 means "auto" = 25 (tools/aligner.c:409-412).
"""
from __future__ import annotations

import dataclasses

from .types import Penalties

AUTO_BAND_INTERVAL = 25  # tools/aligner.c:411


def default_max_error(
    first_pattern_len: int,
    first_text_len: int,
    penalties: Penalties,
    floor: int = 50,
) -> int:
    """Assume ~10% error between sequences; alignments beyond this error are
    offloaded to the CPU (lib/alignment_parameters.h:87-93; the CLI uses
    floor=20, tools/aligner.c:336)."""
    max_error = int(max(first_text_len, first_pattern_len) * 0.1)
    max_error *= max(penalties.x, penalties.o, penalties.e)
    return max(max_error, floor)


def default_band_width(max_error: int) -> int:
    """Window width from the max wavefront size — the reference's
    threads-per-block lookup (lib/alignment_parameters.h:60-71 /
    tools/aligner.c:352-357), reused as the band width."""
    max_wf_size = 2 * max_error + 1
    if max_wf_size <= 128:
        return 64
    if max_wf_size <= 256:
        return 128
    if max_wf_size <= 512:
        return 256
    if max_wf_size <= 1024:
        return 512
    return 1024


@dataclasses.dataclass
class AlignmentOptions:
    penalties: Penalties = dataclasses.field(default_factory=Penalties)
    max_error: int | None = None       # None: auto from first pair
    compute_cigar: bool = False
    batch_size: int | None = None      # None: all pairs in one pipeline batch
    band: int = -1                     # re-center interval; 0 = auto(25)
    band_width: int | None = None      # None: auto table
    # Device tiling: lanes per tile, and the device memory one tile may use.
    tile_batch: int | None = None      # None: auto from memory budget
    memory_budget_bytes: int = 1 << 30
    # Run CPU fallback for unfinished/invalid pairs (reference always does).
    cpu_fallback: bool = True
    # On-device escalation before the CPU fallback: pairs the device left
    # unfinished at ``max_error`` are retried up to this many times with a
    # doubled error budget (and hence wider band / window) while they can
    # still benefit (ACGT-clean, non-oversized).  The reference recomputes
    # every unfinished pair on the host (lib/align.cu:236-249); the retry
    # tier keeps heuristically-divergent pairs on the accelerator instead.
    # 0 disables (exact reference routing).
    device_retries: int = 1
    # Shard alignment batches over all visible devices (pure data parallelism
    # over a 1-D mesh; SURVEY §2.4 item 5).  Ignored with one device.
    data_parallel: bool = True

    def resolved_band(self) -> int:
        if self.band == 0:
            return AUTO_BAND_INTERVAL
        return self.band

    @property
    def banded(self) -> bool:
        return self.band >= 0
