"""Multi-host bring-up and batch partitioning.

The reference is single-process, single-GPU (SURVEY §2.4 item 5); scaling
across processes is a new subsystem: `jax.distributed` initializes the
multi-process runtime and each process feeds its own slice of the input
batch to its own devices.  Alignments are
independent, so host-sharding is pure striding — no redistribution, and each
host decodes/falls back only its local results.

Typical use, in each of N processes.  JAX reserves most of a card's memory
when a process first uses it, so on a GPU host every process must see its
own card (``CUDA_VISIBLE_DEVICES`` or ``jax.distributed.initialize``'s
``local_device_ids``):

    from wfa_tpu.parallel.distributed import initialize, host_shard
    initialize("localhost:12345", N, process_id)
    mine = host_shard(len(patterns))   # slice of the global batch
    results = align_pairs_pipelined(
        [patterns[i] for i in mine], [texts[i] for i in mine], opts)

Scores can then be written per-host (merged offline) or gathered with
`multihost_utils.process_allgather` when a single output file is needed.
"""
from __future__ import annotations

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the multi-process JAX runtime (idempotent).

    Pass the coordinator address, process count and this process's id;
    with no cluster environment to read them from, ``jax.distributed``
    cannot find them itself, and the call degrades to one process.

    The already-initialized check must NOT touch `jax.process_count()` —
    that instantiates the backends, after which `jax.distributed.initialize`
    refuses to run (it must precede any JAX computation).
    """
    import jax

    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # Single-process environment (no coordinator configured): fine —
        # everything degrades to one host.
        pass


def host_shard(n: int, process_id: int | None = None,
               num_processes: int | None = None) -> np.ndarray:
    """Indices of the global batch this host is responsible for.

    Strided (not blocked) so every host sees the same length mix — keeps the
    per-tier tile shapes, and therefore compile caches, identical across
    hosts.
    """
    import jax

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    return np.arange(pid, n, nproc)


def shard_batch(
    patterns: list,
    texts: list,
    output_file: str | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
):
    """Restrict a global batch to this host's strided shard.

    Returns (patterns, texts, output_file) where output_file gets a
    ``.{process_id}`` suffix so every host writes its own results (merge
    offline or with ``allgather_scores``).  The CLI multi-host branch is a
    thin call to this, so the logic is unit-testable with injected
    process_id/num_processes.
    """
    import jax

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    mine = host_shard(len(patterns), pid, nproc)
    out = f"{output_file}.{pid}" if output_file else output_file
    return (
        [patterns[i] for i in mine],
        [texts[i] for i in mine],
        out,
    )


def merge_sharded_scores(
    per_host: list[np.ndarray], total: int
) -> np.ndarray:
    """Undo the strided host sharding: per_host[p][j] is global index
    p + j*nproc.  Inverse of host_shard for score arrays (e.g. after
    allgather_scores); rows longer than the host's shard (allgather
    padding) are trimmed."""
    nproc = len(per_host)
    out = np.empty(total, dtype=np.asarray(per_host[0]).dtype)
    for p, arr in enumerate(per_host):
        k = len(range(p, total, nproc))
        out[p:total:nproc] = np.asarray(arr)[:k]
    return out


def allgather_scores(
    local_scores: np.ndarray,
    total: int | None = None,
    fill: int = -1,
) -> np.ndarray:
    """Gather per-host score arrays to every host (cross-process collective).

    `process_allgather` requires equal-length arrays on every host, but
    `host_shard` shards are unequal whenever ``total % nproc != 0`` — pass
    ``total`` (the global batch size) and each host pads its shard to
    ``ceil(total/nproc)`` with ``fill`` before the collective; the padding
    is trimmed again by `merge_sharded_scores`.  Without ``total`` the
    local arrays must already be equal-length across hosts.
    """
    import jax
    from jax.experimental import multihost_utils

    local = np.asarray(local_scores)
    if total is not None:
        width = -(-total // jax.process_count())
        padded = np.full(width, fill, dtype=local.dtype)
        padded[: len(local)] = local
        local = padded
    return np.asarray(multihost_utils.process_allgather(local))
