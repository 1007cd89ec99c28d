"""Data-parallel execution over a 1-D device mesh.

The reference is strictly single-GPU (device 0 hard-coded,
lib/sequence_alignment.cu:87); its only scale-out axis is more blocks on one
card.  Here the *batch* dimension scales across cards and hosts instead:
alignments are independent, so the natural mapping is pure data parallelism
over a 1-D ``("data",)`` mesh that follows the batch — each device runs the
full wavefront engine on its shard with zero per-step communication (the
termination `while_loop` is per-shard, so no cross-device sync happens inside
the hot loop), and results are gathered once at the end.  Nothing assumes a
particular interconnect topology.

Multi-host: initialize `jax.distributed` and build the mesh over each
process's local devices (see parallel/distributed.py).  TP/PP/SP/EP have no
counterpart in this workload (SURVEY §2.4 item 5): there is no tensor to
shard within one alignment beyond the wavefront itself.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P


def data_mesh(devices=None) -> Mesh:
    """A 1-D data-parallel mesh over the given devices.

    Defaults to this process's **local** devices: the aligner host-shards the
    batch before it reaches the engines (cli.py multi-host branch), so each
    process must shard-map its host-local arrays over its own devices only — a
    global mesh would treat the per-host numpy inputs as replicated and the
    SPMD programs would diverge when per-host shard sizes differ.
    Single-process runs see every device either way.
    """
    devices = devices if devices is not None else jax.local_devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def align_batch_sharded(
    cfg,
    mesh: Mesh,
    pat,
    txt,
    plen,
    tlen,
    valid,
):
    """Shard-mapped engine: batch dim split over the "data" axis.

    All inputs must have a batch dimension divisible by the mesh size (the
    aligner pads with empty pairs).  Each shard runs the engine independently
    — no collectives in the score loop; the gather to host happens when the
    caller fetches the outputs.
    """
    from ..ops.engine_xla import _align_batch_impl
    from ..schedule import build_schedule

    sched = build_schedule(cfg.penalties, cfg.max_steps, cfg.score_limit)

    in_specs = (P("data"), P("data"), P("data"), P("data"), P("data"))
    out_specs = {"distance": P("data"), "finished": P("data")}
    if cfg.compute_cigar:
        out_specs["choices"] = P(None, "data", None)
        out_specs["lo_trace"] = P(None, "data")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def run(pat_s, txt_s, plen_s, tlen_s, valid_s):
        return _align_batch_impl(
            cfg, sched, pat_s, txt_s, plen_s, tlen_s, valid_s
        )

    return run(pat, txt, plen, tlen, valid)
