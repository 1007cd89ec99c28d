"""Time the repo's own native CPU engine (native/wfa_cpu.cpp, OpenMP — one
thread per core) on the exact workloads tools/wfa2_baseline.py measures, for
a WFA2-lib-CPU vs native-CPU vs device comparison on identical inputs.

Usage:  python tools/cpu_engine_bench.py [--quick]
Output: one JSON line per workload + a table.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from tools.wfa2_baseline import WORK, gen_hifi_x8, gen_short_seq
from wfa_tpu import native
from wfa_tpu.types import Penalties
from wfa_tpu.utils.io import read_seq_file

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def run_one(tag: str, seq: Path, pen: Penalties, adaptive: bool = False) -> dict:
    batch = read_seq_file(seq)
    pats, txts = batch.patterns, batch.texts
    mask = np.ones(len(pats), dtype=np.int8)
    t0 = time.perf_counter()
    dist, _, status = native.cpu_align_batch(
        pats, txts, pen, mask, compute_cigar=False, adaptive=adaptive
    )
    secs = time.perf_counter() - t0
    assert (status == 1).all()
    rec = {
        "workload": tag,
        "n": len(pats),
        "align_seconds": round(secs, 4),
        "aln_per_sec": round(len(pats) / secs, 2),
        "penalties": f"x{pen.x},o{pen.o},e{pen.e}",
        "mode": "wfa-adaptive" if adaptive else "exact",
        "tool": "wfa_tpu native CPU engine (OpenMP; 1 core on this host)",
    }
    print(json.dumps(rec))
    return rec


def main() -> int:
    quick = "--quick" in sys.argv
    WORK.mkdir(parents=True, exist_ok=True)
    hifi8 = WORK / "hifi_x8.seq"
    short = WORK / "short_100bp.seq"
    if not hifi8.exists():
        gen_hifi_x8(hifi8)
    if not short.exists():
        gen_short_seq(short)

    p0 = Penalties(1, 2, 1)
    pb = Penalties(2, 3, 1)
    rows = [
        run_one("utest_p0 (1,2,1)", DATA / "wfa.utest.seq", p0),
        run_one("100bp_x4096 exact", short, pb),
        run_one("1kbp_n1000 exact", DATA / "seq_1000_n1000.seq", pb),
    ]
    if not quick:
        rows.append(run_one("hifi_x8 exact", hifi8, pb))
        # The engine's banded-analog heuristic pass (adaptive is what the
        # CPU fallback runs when the device ran banded).
        rows.append(run_one("hifi_x8 wfa-adaptive", hifi8, pb, adaptive=True))
        rows.append(run_one("10kbp_n100 exact", DATA / "seq_10K_n100.seq", pb))

    w = max(len(r["workload"]) for r in rows) + 2
    print(f"\n{'workload':<{w}}{'n':>6}  {'aln/s':>10}  mode")
    for r in rows:
        print(f"{r['workload']:<{w}}{r['n']:>6}  {r['aln_per_sec']:>10}  {r['mode']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
