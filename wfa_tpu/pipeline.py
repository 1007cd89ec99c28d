"""Streaming batch pipeline.

Counterpart of the reference's double-buffered batch loop
(lib/align.cu:177-385): there, stream1 prefetches batch i+1's sequences H2D
while stream2 packs/aligns batch i and the host (OpenMP) post-processes batch
i-1 (CPU fallback re-alignment + CIGAR expansion, lib/align.cu:236-255).

Here the same overlap falls out of a two-deep thread pipeline: JAX dispatch is
asynchronous, device execution serializes on the device stream, and the host
stages (packing, choice-table decode, CPU fallback) of one batch run while the
device computes the other.  ctypes calls into the native OpenMP engines
release the GIL, so both threads make real progress.

``batch_size`` mirrors wfagpu_set_batch_size (lib/aligner.c:212); the default
(None) processes everything as one batch, like the CLI default of N/10 is the
reference's own heuristic (lib/alignment_parameters.h:100-103) rather than a
hard requirement.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

from .aligner import align_pairs
from .params import AlignmentOptions, default_max_error
from .types import AlignmentResult


def align_pairs_pipelined(
    patterns: list[bytes],
    texts: list[bytes],
    options: AlignmentOptions | None = None,
) -> list[AlignmentResult]:
    """Batched, pipelined front-end over ``align_pairs``.

    Splits the workload into ``options.batch_size`` chunks and runs them
    through a two-deep pipeline so device compute of batch i overlaps host
    work of batch i-1.  Semantically identical to a single ``align_pairs``
    call (same per-pair results).
    """
    opts = options or AlignmentOptions()
    n = len(patterns)
    if n == 0:
        return []
    bs = opts.batch_size or n
    if bs >= n:
        return align_pairs(patterns, texts, opts)

    # Resolve auto max_error once, from the first pair, so every batch
    # compiles the same engine shapes (the reference likewise derives it from
    # the first pair only: lib/alignment_parameters.h:87-93).
    if opts.max_error is None:
        opts = dataclasses.replace(
            opts,
            max_error=default_max_error(
                len(patterns[0]), len(texts[0]), opts.penalties
            ),
        )

    results: list[AlignmentResult | None] = [None] * n
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [
            (start, ex.submit(
                align_pairs, patterns[start : start + bs],
                texts[start : start + bs], opts,
            ))
            for start in range(0, n, bs)
        ]
        for start, fut in futs:
            r = fut.result()
            results[start : start + len(r)] = r
    return results  # type: ignore[return-value]
