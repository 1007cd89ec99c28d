#!/usr/bin/env python
"""Smoke run of the aligner on an NVIDIA GPU, at the sizes its users run.

Drives the user entry points (``wfa_tpu.cli.main``, ``align_pairs``) in one
process and checks every result:

  0  environment: card name and power limit, JAX version, devices, cache
  1  golden CLI: wfa.utest.seq at -g 1,2,1 / 3,1,4 / 5,3,2, -e 10000, every
     score against tests/data/results/test.score.affine.p{0,1,2}.alg
  2  golden datasets through align_pairs, exact distance: 1000x1kbp at
     -e 300 and 100x10kbp at -e 3000
  3  CIGAR: the 1000x1kbp set in exact CIGAR mode (every CIGAR replays and
     scores its golden distance), and the CLI HiFi -x -c check
  4  HiFi at scale: 4,096 pairs, banded distance and banded CIGAR at -B auto
     -e 3000, against the same XLA engine jitted on the CPU backend on a
     64-pair subsample (the CPU backend takes about a second per HiFi pair)
  5  short reads: 100,000 pairs of 100 bp at 5% error, exact distance,
     against the native CPU oracle on 1,000 pairs
  6  wide working set: 1kbp pairs at -g 70,2,1 (71 live scores), against
     the oracle
  7  the tests marked ``gpu``, run in this process with pytest

Tolerance is zero everywhere: the engine is int32 end to end (integer DP,
xor/clz extension, no floating point), so TF32 and summation order do not
apply and every score and CIGAR must match exactly.

Each phase prints one line: pairs, first-call seconds (set-up, compilation
included), warm wall seconds, alignments/s, pairs finished on the device,
mismatches and peak device bytes, with the card's name and power limit.
The last line of stdout is a JSON object with ``"ok": true`` and the device,
printed only when every phase passed.  Without a GPU it exits non-zero and
prints no result.

``--four-cards`` runs only the data-parallel check on a four-card host:
phase 4 at 16,384 pairs and the 1000x1kbp exact CIGAR set with
``data_parallel=True`` over the four cards, each compared bit for bit with
``data_parallel=False`` on card 0.

Run:  python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"


def count_mismatches(got, want) -> int:
    """Positions where two sequences differ; a length difference counts
    once per missing or extra entry."""
    got, want = list(got), list(want)
    n = sum(g != w for g, w in zip(got, want))
    return n + abs(len(got) - len(want))


def _results_key(res):
    return [(r.error, r.cigar, r.finished_on_accelerator) for r in res]


class Smoke:
    """Runs phases, prints one line each and remembers failures."""

    def __init__(self, card: str):
        import jax

        self.card = card
        self.dev = jax.devices()[0]
        self.failures: list[str] = []

    def peak_bytes(self) -> int:
        return int(self.dev.memory_stats()["peak_bytes_in_use"])

    def timed(self, run):
        """(first-call seconds, warm seconds, first results, warm results)."""
        t0 = time.perf_counter()
        first = run()
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = run()
        wall = time.perf_counter() - t0
        return setup, wall, first, warm

    def report(self, name, res, setup, wall, mismatches, need_on_device=None,
               extra=""):
        n = len(res)
        on_dev = sum(r.finished_on_accelerator for r in res)
        line = (
            f"[phase] {name} | pairs {n} | setup {setup:.2f} s | warm "
            f"{wall:.3f} s | {n / wall:.1f} aln/s | on device {on_dev}/{n} | "
            f"mismatches {mismatches} | peak {self.peak_bytes()} B"
        )
        if extra:
            line += f" | {extra}"
        print(f"{line} | {self.card}", flush=True)
        if mismatches:
            self.failures.append(f"{name}: {mismatches} mismatches")
        if need_on_device is not None and on_dev < need_on_device:
            self.failures.append(
                f"{name}: {on_dev} pairs on device, expected {need_on_device}"
            )


def _acgt_pairs(patterns, texts) -> int:
    import numpy as np

    from wfa_tpu.ops.packing import _ACGT

    return sum(
        bool(_ACGT[np.frombuffer(p, np.uint8)].all()
             and _ACGT[np.frombuffer(t, np.uint8)].all())
        for p, t in zip(patterns, texts)
    )


def _run_cli(argv):
    """cli.main in-process; returns (rc, results, stderr text)."""
    import contextlib
    import io

    import wfa_tpu.cli as cli

    captured = []
    orig = cli.align_pairs_pipelined

    def capture(*args, **kwargs):
        res = orig(*args, **kwargs)
        captured.append(res)
        return res

    err = io.StringIO()
    cli.align_pairs_pipelined = capture
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        cli.align_pairs_pipelined = orig
    sys.stderr.write(err.getvalue()[-2000:])
    return rc, captured[0], err.getvalue()


def _golden_file(tag):
    path = DATA / "results" / f"test.score.affine.{tag}.alg"
    return [line.split()[0] for line in path.read_text().splitlines()
            if line.strip()]


def _golden_set(name, key):
    from wfa_tpu.utils.io import read_seq_file

    batch = read_seq_file(DATA / f"{name}.seq")
    golden = json.loads((DATA / f"{name}.golden.json").read_text())
    return batch.patterns, batch.texts, [-v for v in golden[key]]


def _hifi(n):
    from wfa_tpu.utils.io import read_seq_file

    batch = read_seq_file(DATA / "test_hifi.seq")
    reps = -(-n // len(batch.patterns))
    return (batch.patterns * reps)[:n], (batch.texts * reps)[:n]


def phase_golden_cli(smoke, tmp, n=None):
    from wfa_tpu.utils.io import read_seq_file

    batch = read_seq_file(DATA / "wfa.utest.seq", n)
    n_acgt = _acgt_pairs(batch.patterns, batch.texts)
    for pen, tag in (("1,2,1", "p0"), ("3,1,4", "p1"), ("5,3,2", "p2")):
        out = Path(tmp) / f"{tag}.out"
        argv = ["-i", str(DATA / "wfa.utest.seq"), "-g", pen, "-e", "10000",
                "-o", str(out)] + (["-n", str(n)] if n else [])

        def run():
            rc, res, _ = _run_cli(argv)
            assert rc == 0, f"CLI exit code {rc}"
            return res

        setup, wall, first, warm = smoke.timed(run)
        got = [line.split("\t")[0] for line in out.read_text().splitlines()
               if line.strip()]
        bad = count_mismatches(got, _golden_file(tag)[: len(batch)])
        bad += count_mismatches(_results_key(first), _results_key(warm))
        smoke.report(f"1 golden CLI -g {pen} -e 10000", warm, setup, wall,
                     bad, need_on_device=n_acgt)


def phase_golden_sets(smoke):
    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties

    for name, key, err in (
        ("seq_1000_n1000", "results_1000_n1000_x2o3e1", 300),
        ("seq_10K_n100", "results_10K_n100_x2o3e1", 3000),
    ):
        pats, txts, expect = _golden_set(name, key)
        opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=err)
        setup, wall, first, warm = smoke.timed(
            lambda: align_pairs(pats, txts, opts))
        bad = count_mismatches([r.error for r in warm], expect)
        bad += count_mismatches(_results_key(first), _results_key(warm))
        smoke.report(f"2 golden {name} exact distance -e {err}", warm, setup,
                     wall, bad, need_on_device=len(pats))


def phase_cigar(smoke):
    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils.verification import affine_score, check_cigar

    pen = Penalties(2, 3, 1)
    pats, txts, expect = _golden_set(
        "seq_1000_n1000", "results_1000_n1000_x2o3e1")
    opts = AlignmentOptions(penalties=pen, max_error=300, compute_cigar=True)
    setup, wall, first, warm = smoke.timed(
        lambda: align_pairs(pats, txts, opts))
    bad = sum(
        not (check_cigar(r.cigar, p, t) and affine_score(r.cigar, pen) == d
             and r.error == d)
        for r, p, t, d in zip(warm, pats, txts, expect)
    )
    bad += count_mismatches(_results_key(first), _results_key(warm))
    smoke.report("3 golden seq_1000_n1000 exact CIGAR -e 300", warm, setup,
                 wall, bad)

    argv = ["-Q", str(DATA / "test_hifi.query.fasta"),
            "-T", str(DATA / "test_hifi.target.fasta"),
            "-e", "3000", "-x", "-c"]
    checks = []

    def run():
        rc, res, err = _run_cli(argv)
        assert rc == 0, f"CLI exit code {rc}"
        line = [s for s in err.splitlines() if s.startswith("correct=")][-1]
        checks.append(dict(kv.split("=") for kv in line.split()))
        return res

    setup, wall, first, warm = smoke.timed(run)
    bad = sum(int(c["incorrect"]) for c in checks)
    bad += sum(int(c["correct"]) != len(warm) for c in checks)
    bad += count_mismatches(_results_key(first), _results_key(warm))
    smoke.report("3 CLI HiFi -e 3000 -x -c", warm, setup, wall, bad,
                 extra=f"check {checks[-1]}")


def phase_hifi_scale(smoke, n=4096, ref_every=64):
    import jax

    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties

    pats, txts = _hifi(n)
    sub = list(range(0, n, ref_every))
    for cigar in (False, True):
        opts = AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000,
                                band=25, compute_cigar=cigar)
        setup, wall, first, warm = smoke.timed(
            lambda: align_pairs(pats, txts, opts))
        # Banded mode is a heuristic: the reference is the same engine
        # jitted on the CPU backend, which must agree bit for bit.
        t0 = time.perf_counter()
        with jax.default_device(jax.devices("cpu")[0]):
            ref = align_pairs(
                [pats[i] for i in sub], [txts[i] for i in sub],
                AlignmentOptions(penalties=Penalties(2, 3, 1), max_error=3000,
                                 band=25, compute_cigar=cigar,
                                 data_parallel=False),
            )
        t_ref = time.perf_counter() - t0
        bad = count_mismatches(_results_key([warm[i] for i in sub]),
                               _results_key(ref))
        bad += count_mismatches(_results_key(first), _results_key(warm))
        mode = "CIGAR" if cigar else "distance"
        smoke.report(f"4 HiFi x{n} banded {mode} -B auto -e 3000", warm,
                     setup, wall, bad,
                     extra=f"CPU-backend reference on {len(sub)} pairs "
                           f"{t_ref:.1f} s")


def phase_short_reads(smoke, n=100_000, n_ref=1000):
    import numpy as np

    from wfa_tpu import native
    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils import synth

    pen = Penalties(2, 3, 1)
    pats, txts = synth.read_pairs(np.random.default_rng(5), n, 100, 0.05)
    opts = AlignmentOptions(penalties=pen)
    setup, wall, first, warm = smoke.timed(
        lambda: align_pairs(pats, txts, opts))
    sub = list(range(0, n, n // n_ref))[:n_ref]
    oracle, _, _ = native.cpu_align_batch(
        [pats[i] for i in sub], [txts[i] for i in sub], pen,
        np.ones(len(sub), dtype=np.int8), False)
    bad = count_mismatches([warm[i].error for i in sub], oracle.tolist())
    bad += count_mismatches(_results_key(first), _results_key(warm))
    smoke.report(f"5 short reads {n}x100bp 5% error exact distance", warm,
                 setup, wall, bad, need_on_device=n,
                 extra=f"oracle on {len(sub)} pairs")


def phase_wide_working_set(smoke, n=512):
    import numpy as np

    from wfa_tpu import native
    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils import synth

    pen = Penalties(70, 2, 1)
    pats, txts = synth.read_pairs(np.random.default_rng(9), n, 1000, 0.05)
    opts = AlignmentOptions(penalties=pen)
    setup, wall, first, warm = smoke.timed(
        lambda: align_pairs(pats, txts, opts))
    oracle, _, _ = native.cpu_align_batch(
        pats, txts, pen, np.ones(n, dtype=np.int8), False)
    bad = count_mismatches([r.error for r in warm], oracle.tolist())
    bad += count_mismatches(_results_key(first), _results_key(warm))
    smoke.report(f"6 wide working set -g 70,2,1 (aws "
                 f"{pen.active_working_set}) {n}x1kbp", warm, setup, wall,
                 bad, need_on_device=n)


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests(smoke):
    import pytest

    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
         str(ROOT / "tests")],
        plugins=[outcomes],
    )
    wall = time.perf_counter() - t0
    print(f"[phase] 7 gpu-marked tests | passed {outcomes.passed} | failed "
          f"{outcomes.failed} | skipped {outcomes.skipped} | exit {int(rc)} | "
          f"{wall:.1f} s | peak {smoke.peak_bytes()} B | {smoke.card}",
          flush=True)
    if rc != 0 or outcomes.failed or outcomes.skipped or not outcomes.passed:
        smoke.failures.append("7 gpu-marked tests")


def four_cards(smoke, n_hifi=16384):
    """data_parallel=True over four cards vs data_parallel=False on card 0."""
    import jax

    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties

    ndev = len(jax.devices())
    if ndev != 4:
        smoke.failures.append(f"--four-cards needs 4 GPUs, JAX sees {ndev}")
        return
    pen = Penalties(2, 3, 1)
    hp, ht = _hifi(n_hifi)
    gp, gt, _ = _golden_set("seq_1000_n1000", "results_1000_n1000_x2o3e1")
    runs = (
        (f"HiFi x{n_hifi} banded distance", hp, ht,
         dict(max_error=3000, band=25)),
        (f"HiFi x{n_hifi} banded CIGAR", hp, ht,
         dict(max_error=3000, band=25, compute_cigar=True)),
        ("golden seq_1000_n1000 exact CIGAR -e 300", gp, gt,
         dict(max_error=300, compute_cigar=True)),
    )
    for name, pats, txts, kw in runs:
        out = {}
        for dp in (True, False):
            opts = AlignmentOptions(penalties=pen, data_parallel=dp, **kw)
            out[dp] = smoke.timed(lambda: align_pairs(pats, txts, opts))
        bad = count_mismatches(_results_key(out[True][3]),
                               _results_key(out[False][3]))
        setup, wall = out[True][0], out[True][1]
        smoke.report(
            f"4-card {name} data_parallel over {ndev} cards", out[True][3],
            setup, wall, bad,
            extra=f"one card: setup {out[False][0]:.2f} s warm "
                  f"{out[False][1]:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of the aligner")
    ap.add_argument("--four-cards", action="store_true",
                    help="only the data-parallel check over four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    import subprocess
    import tempfile

    sys.path.insert(0, str(ROOT))
    from wfa_tpu import native
    from wfa_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().replace("\n", "; ")
    print(card, flush=True)
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native library did not build (make -C native)")
    print(f"[phase] 0 environment | jax {jax.__version__} | {dev.device_kind}"
          f" x{len(jax.devices())} | compile cache {cache} | native build "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)

    smoke = Smoke(card)
    if args.four_cards:
        four_cards(smoke)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_golden_cli(smoke, tmp)
        phase_golden_sets(smoke)
        phase_cigar(smoke)
        phase_hifi_scale(smoke)
        phase_short_reads(smoke)
        phase_wide_working_set(smoke)
        phase_gpu_tests(smoke)

    if smoke.failures:
        print("FAILED: " + "; ".join(smoke.failures), file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
