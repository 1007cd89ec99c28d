"""Multi-host helpers: single-process degradation, shard arithmetic, the CLI
host-shard path (with injected process ids), score gathering and merging.

A real multi-machine bring-up cannot run here; everything with cross-process semantics is
exercised by (a) injecting explicit process_id/num_processes and checking the
shards compose back to the global batch, and (b) running the collective
helpers in their single-process degradation (process_allgather with one
process), which covers the full code path minus the DCN transport.
"""
import numpy as np
import pytest

from wfa_tpu.parallel.distributed import (
    allgather_scores,
    host_shard,
    initialize,
    merge_sharded_scores,
    shard_batch,
)


def test_initialize_single_process_noop():
    initialize()  # must not raise without a coordinator


def test_host_shard_strided_partition():
    n, nproc = 103, 8
    shards = [host_shard(n, pid, nproc) for pid in range(nproc)]
    allidx = np.sort(np.concatenate(shards))
    np.testing.assert_array_equal(allidx, np.arange(n))
    # Strided: every shard sees the same length mix (consecutive global
    # indices land on different hosts).
    assert shards[0][1] == nproc


def test_host_shard_defaults_to_jax_process():
    # Single process: the default-argument path must return everything.
    np.testing.assert_array_equal(host_shard(7), np.arange(7))


@pytest.mark.parametrize("n,nproc", [(10, 4), (64, 8), (5, 8)])
def test_shard_batch_composes_to_global(n, nproc):
    pats = [bytes([65 + i % 26]) * (i + 1) for i in range(n)]
    txts = [bytes([97 + i % 26]) * (i + 1) for i in range(n)]
    seen = {}
    for pid in range(nproc):
        sp, st, out = shard_batch(
            pats, txts, "res.out", process_id=pid, num_processes=nproc
        )
        assert out == f"res.out.{pid}"
        assert len(sp) == len(st) == len(host_shard(n, pid, nproc))
        for j, gi in enumerate(host_shard(n, pid, nproc)):
            assert sp[j] == pats[gi] and st[j] == txts[gi]
            seen[int(gi)] = True
    assert sorted(seen) == list(range(n))


def test_shard_batch_none_output_file():
    sp, st, out = shard_batch(
        [b"A"], [b"C"], None, process_id=0, num_processes=2
    )
    assert out is None and sp == [b"A"]


def test_merge_sharded_scores_inverts_host_shard():
    n, nproc = 23, 5
    scores = np.arange(n) * 3 - 7
    per_host = [scores[host_shard(n, p, nproc)] for p in range(nproc)]
    np.testing.assert_array_equal(
        merge_sharded_scores(per_host, n), scores
    )


def test_allgather_scores_single_process():
    """Single-process degradation of the DCN collective: one host's scores
    come back unchanged (stacked along the process axis)."""
    local = np.array([3, -1, 42], dtype=np.int32)
    got = np.asarray(allgather_scores(local))
    assert got.reshape(-1, 3)[0].tolist() == [3, -1, 42]


def test_two_process_distributed_bringup(tmp_path):
    """REAL 2-process `jax.distributed` bring-up on CPU: coordinator +
    worker subprocesses shard a batch, align their host shards, allgather
    the scores over the distributed runtime, and process 0 merges them —
    the full multi-host path minus a real multi-machine interconnect."""
    import subprocess
    import sys
    from pathlib import Path

    # 9 pairs across 2 hosts -> unequal shards (5 vs 4): exercises the
    # allgather padding path (total=) end-to-end.
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(Path(__file__).parent.parent)!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "pid, nproc, port = (int(v) for v in sys.argv[1:4])\n"
        "from wfa_tpu.parallel.distributed import (\n"
        "    initialize, shard_batch, allgather_scores,\n"
        "    merge_sharded_scores)\n"
        "initialize(f'localhost:{port}', nproc, pid)\n"
        "assert jax.process_count() == nproc, jax.process_count()\n"
        "import numpy as np\n"
        "pats = [bytes([65 + i % 4]) * 8 + b'ACGT' * 12 for i in range(9)]\n"
        "txts = [p[:20] + p[21:] + b'G' for p in pats]\n"
        "sp, st, _ = shard_batch(pats, txts, None)\n"
        "from wfa_tpu import AlignmentOptions, Penalties, align_pairs\n"
        "res = align_pairs(sp, st, AlignmentOptions(\n"
        "    penalties=Penalties(2, 3, 1), max_error=20,\n"
        "    data_parallel=False))\n"
        "local = np.array([r.error for r in res], dtype=np.int32)\n"
        "g = np.asarray(allgather_scores(local, total=9))\n"
        "g = g.reshape(nproc, -1)\n"
        "if pid == 0:\n"
        "    merged = merge_sharded_scores(list(g), 9)\n"
        "    ref = [align_pairs([p], [t], AlignmentOptions(\n"
        "        penalties=Penalties(2, 3, 1), max_error=20,\n"
        "        data_parallel=False))[0].error\n"
        "        for p, t in zip(pats, txts)]\n"
        "    assert merged.tolist() == ref, (merged.tolist(), ref)\n"
        "print('OK', pid)\n"
    )
    import os
    import socket

    # Ephemeral coordinator port: a hardcoded one collides on shared hosts.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(p), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for p in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert "OK 0" in outs[0] and "OK 1" in outs[1]


def test_cli_multihost_end_to_end(tmp_path, monkeypatch):
    """Emulate the CLI's multi-host branch: every process aligns its strided
    shard and writes its own output file; merged, they reproduce the
    single-process golden scores."""
    from pathlib import Path

    from wfa_tpu.cli import main

    DATA = Path(__file__).parent / "data"
    nproc = 2
    full = tmp_path / "full.out"
    assert main([
        "-i", str(DATA / "wfa.utest.seq"), "-n", "24", "-g", "1,2,1",
        "-e", "25", "-o", str(full),
    ]) == 0
    full_scores = [
        line.split("\t")[0] for line in full.read_text().splitlines()
    ]

    import jax

    per_host = []
    for pid in range(nproc):
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        out = tmp_path / f"shard.out"
        assert main([
            "-i", str(DATA / "wfa.utest.seq"), "-n", "24", "-g", "1,2,1",
            "-e", "25", "-o", str(out),
        ]) == 0
        per_host.append([
            line.split("\t")[0]
            for line in (tmp_path / f"shard.out.{pid}").read_text().splitlines()
        ])
    monkeypatch.undo()
    merged = merge_sharded_scores(
        [np.array([int(s) for s in h]) for h in per_host], 24
    )
    assert merged.tolist() == [int(s) for s in full_scores]
