"""Same-host external baseline: the reference's vendored WFA2-lib CPU aligner.

Builds `/root/reference/external/WFA` (copied OUT of the read-only reference
tree into /tmp — none of its code enters this repo) and runs its
`align_benchmark` tool on the exact workloads `bench.py` measures, for an
independent-implementation comparison column: WFA2-lib CPU vs this repo's
CPU engine vs its device engine on identical inputs.

Usage:  python tools/wfa2_baseline.py [--quick]
Output: one table + one JSON line per workload on stdout.
"""
from __future__ import annotations

import json
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF_WFA = Path("/root/reference/external/WFA")
WORK = Path("/tmp/wfa2_baseline")
BIN = WORK / "WFA" / "bin" / "align_benchmark"


def build() -> Path:
    if BIN.exists():
        return BIN
    WORK.mkdir(parents=True, exist_ok=True)
    dst = WORK / "WFA"
    if not dst.exists():
        shutil.copytree(REF_WFA, dst)
    # The vendored Makefile has a parallel-build ordering race (apps need
    # lib/libwfa.a); a serial re-run converges.
    subprocess.run(["make", "-j8"], cwd=dst, capture_output=True)
    r = subprocess.run(["make"], cwd=dst, capture_output=True)
    if not BIN.exists():
        raise RuntimeError(f"WFA2-lib build failed:\n{r.stderr.decode()[-2000:]}")
    return BIN


def _mutate(rng: random.Random, s: str, err: float) -> str:
    # Identical generator to bench.py::_bench_short_exact (seed 0).
    out = list(s)
    for _ in range(int(len(s) * err)):
        op = rng.choice("XID")
        pos = rng.randrange(max(1, len(out)))
        if op == "X":
            out[pos] = rng.choice("ACGT")
        elif op == "I":
            out.insert(pos, rng.choice("ACGT"))
        elif len(out) > 1:
            del out[pos]
    return "".join(out)


def gen_short_seq(path: Path, n: int = 4096) -> None:
    rng = random.Random(0)
    with path.open("w") as fp:
        for _ in range(n):
            p = "".join(rng.choice("ACGT") for _ in range(100))
            fp.write(f">{p}\n<{_mutate(rng, p, 0.05)}\n")


def gen_hifi_x8(path: Path) -> None:
    raw = (ROOT / "tests" / "data" / "test_hifi.seq").read_text()
    path.write_text(raw * 8)


def run_one(
    tag: str, seq: Path, g: str, extra: list[str], timeout: int = 1800
) -> dict:
    cmd = [
        str(BIN), "-a", "gap-affine-wfa", "-i", str(seq),
        "-g", g, "--wfa-score-only", *extra,
    ]
    r = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout
    )
    out = r.stdout + r.stderr
    reads = re.search(r"Total\.reads\s+(\d+)", out)
    t = re.search(r"Time\.Alignment\s+([\d.]+)\s+(ns|us|ms|s|m)\b", out)
    if not (reads and t):
        raise RuntimeError(f"{tag}: cannot parse align_benchmark output:\n{out[-1500:]}")
    scale = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0}[t.group(2)]
    secs = float(t.group(1)) * scale
    n = int(reads.group(1))
    rec = {
        "workload": tag,
        "n": n,
        "align_seconds": round(secs, 4),
        "aln_per_sec": round(n / secs, 2),
        "penalties": g,
        "mode": " ".join(extra) or "exact",
        "tool": "WFA2-lib align_benchmark (CPU, 1 thread)",
    }
    print(json.dumps(rec))
    return rec


def main() -> int:
    quick = "--quick" in sys.argv
    build()
    data = ROOT / "tests" / "data"
    hifi8 = WORK / "hifi_x8.seq"
    short = WORK / "short_100bp.seq"
    if not hifi8.exists():
        gen_hifi_x8(hifi8)
    if not short.exists():
        gen_short_seq(short)

    rows = []
    rows.append(run_one("utest_p0 (1,2,1)", data / "wfa.utest.seq", "0,1,2,1", []))
    rows.append(run_one("100bp_x4096 exact", short, "0,2,3,1", []))
    rows.append(run_one("1kbp_n1000 exact", data / "seq_1000_n1000.seq", "0,2,3,1", []))
    if not quick:
        rows.append(run_one("10kbp_n100 exact", data / "seq_10K_n100.seq", "0,2,3,1", []))
        rows.append(run_one("hifi_x8 exact", hifi8, "0,2,3,1", []))
        # Heuristic analogs of the repo's banded mode (band width 512 ->
        # static diagonals +-256), and WFA2's own adaptive heuristic.
        rows.append(run_one(
            "hifi_x8 banded-static +-256", hifi8, "0,2,3,1",
            ["--wfa-heuristic", "banded-static",
             "--wfa-heuristic-parameters", "-256,256"],
        ))
        rows.append(run_one(
            "hifi_x8 wfa-adaptive", hifi8, "0,2,3,1",
            ["--wfa-heuristic", "wfa-adaptive",
             "--wfa-heuristic-parameters", "10,50,1"],
        ))

    w = max(len(r["workload"]) for r in rows) + 2
    print(f"\n{'workload':<{w}}{'n':>6}  {'aln/s':>10}  mode")
    for r in rows:
        print(f"{r['workload']:<{w}}{r['n']:>6}  {r['aln_per_sec']:>10}  {r['mode']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
