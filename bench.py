#!/usr/bin/env python
"""Throughput of the aligner's cells on one GPU, through ``align_pairs``.

Headline: alignments/s on PacBio HiFi reads in banded (adaptive-band)
distance mode — the reference's long-read configuration (README.md:25-27:
HiFi, max-error 3000, banded), on the bundled 50-pair HiFi corpus
replicated to 400 pairs.  The other cells print on stderr.  Every cell runs
the user-facing ``align_pairs`` with the engine it picks; its first call
(compilation included) is reported as set-up time, and the rate is the best
of the warm calls, timed after the results reach the host.

Prints one JSON line on stdout:
  {"metric": ..., "value": N, "unit": "alignments/s", "device": {...}}

Needs a GPU: with none, it exits non-zero and prints no result.

Run:  python bench.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

DATA = ROOT / "tests" / "data"


def _timed_cell(pats, txts, opts, reps=3, check=None):
    """(set-up seconds, best warm alignments/s, results) for one cell."""
    from wfa_tpu.aligner import align_pairs

    t0 = time.perf_counter()
    res = align_pairs(pats, txts, opts)
    setup = time.perf_counter() - t0
    if check is not None:
        check(res)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        align_pairs(pats, txts, opts)
        best = max(best, len(pats) / (time.perf_counter() - t0))
    return setup, best, res


def _hifi(reps: int = 8):
    from wfa_tpu.utils.io import read_seq_file

    batch = read_seq_file(DATA / "test_hifi.seq")
    return batch.patterns * reps, batch.texts * reps


def _all_on_device(res):
    n_cpu = sum(not r.finished_on_accelerator for r in res)
    assert n_cpu == 0, f"{n_cpu} pairs fell back to the CPU engine"


def _golden(name, key):
    from wfa_tpu.utils.io import read_seq_file

    batch = read_seq_file(DATA / f"{name}.seq")
    golden = json.loads((DATA / f"{name}.golden.json").read_text())
    return batch.patterns, batch.texts, [-v for v in golden[key]]


def cells():
    """(name, patterns, texts, options, check) for every cell, headline
    first."""
    from wfa_tpu import native
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils import synth

    pen = Penalties(2, 3, 1)
    hp, ht = _hifi()
    yield ("HiFi ~14kbp banded distance", hp, ht,
           AlignmentOptions(penalties=pen, max_error=3000, band=25),
           _all_on_device)
    yield ("HiFi ~14kbp banded CIGAR", hp, ht,
           AlignmentOptions(penalties=pen, max_error=3000, band=25,
                            compute_cigar=True),
           _all_on_device)
    yield ("HiFi ~14kbp exact distance -e 3000", hp, ht,
           AlignmentOptions(penalties=pen, max_error=3000), _all_on_device)

    rng = np.random.default_rng(0)
    sp, st = synth.read_pairs(rng, 4096, 100, 0.05)
    yield ("100bp 5% error exact distance", sp, st,
           AlignmentOptions(penalties=pen, max_error=60), _all_on_device)

    for name, key, err in (
        ("seq_1000_n1000", "results_1000_n1000_x2o3e1", 300),
        ("seq_10K_n100", "results_10K_n100_x2o3e1", 3000),
    ):
        gp, gt, expect = _golden(name, key)

        def check(res, expect=expect):
            assert [r.error for r in res] == expect, "golden mismatch"
            _all_on_device(res)

        yield (f"{name} exact distance -e {err}, golden-checked", gp, gt,
               AlignmentOptions(penalties=pen, max_error=err), check)

    # 16x5kbp at 50% substitutions: exact distances ~3750, wider than any
    # banded window; scores checked against the CPU oracle.
    rng = np.random.default_rng(7)
    wp = synth.random_reads(rng, 16, 5000)
    wt = []
    for p in wp:
        t = np.frombuffer(p, dtype=np.uint8).copy()
        k = len(t) // 2
        t[rng.choice(len(t), size=k, replace=False)] = np.frombuffer(
            b"ACGT", dtype=np.uint8
        )[rng.integers(0, 4, size=k)]
        wt.append(t.tobytes())

    def check_wide(res):
        _all_on_device(res)
        mask = np.ones(len(wp), dtype=np.int8)
        oracle, _, _ = native.cpu_align_batch(wp, wt, pen, mask, False)
        assert [r.error for r in res] == oracle.tolist(), "oracle mismatch"

    yield ("16x5kbp 35% divergence exact distance", wp, wt,
           AlignmentOptions(penalties=pen, max_error=4600), check_wide)

    rng = np.random.default_rng(7)
    npats, ntxts = synth.read_pairs(rng, 128, 20000, 0.06)
    yield ("Nanopore-like 20kbp 6% error banded distance", npats, ntxts,
           AlignmentOptions(penalties=pen, max_error=5000, band=25), None)


def _pipeline_overlap(pen):
    """Single-shot vs 8-batch pipeline on a 1kbp CIGAR batch in which every
    4th pair needs the CPU fallback; the ratio is the overlap factor."""
    import dataclasses

    from wfa_tpu.aligner import align_pairs
    from wfa_tpu.params import AlignmentOptions
    from wfa_tpu.pipeline import align_pairs_pipelined
    from wfa_tpu.utils import synth

    rng = np.random.default_rng(3)
    n = 1024
    pats, txts = synth.read_pairs(rng, n, 1000, 0.05)
    hi = synth.mutate(rng, [pats[i] for i in range(0, n, 4)], 0.3)
    for j, i in enumerate(range(0, n, 4)):
        txts[i] = hi[j]
    base = AlignmentOptions(penalties=pen, max_error=120, compute_cigar=True)
    piped = dataclasses.replace(base, batch_size=n // 8)
    align_pairs(pats[:64], txts[:64], base)
    factors = []
    n_cpu = 0
    for _ in range(3):
        t0 = time.perf_counter()
        r_single = align_pairs(pats, txts, base)
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_piped = align_pairs_pipelined(pats, txts, piped)
        t_piped = time.perf_counter() - t0
        assert [r.error for r in r_single] == [r.error for r in r_piped]
        factors.append(t_single / t_piped)
        n_cpu = sum(not r.finished_on_accelerator for r in r_single)
    return factors, n_cpu


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from wfa_tpu.types import Penalties
    from wfa_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().replace("\n", "; ")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"[bench] {device} card: {card} jax {jax.__version__} "
          f"compile cache: {cache}", file=sys.stderr)

    headline = None
    for name, pats, txts, opts, check in cells():
        setup, rate, _ = _timed_cell(pats, txts, opts, check=check)
        print(f"[bench] {name} ({len(pats)} pairs): {rate:.2f} "
              f"alignments/s, set-up {setup:.2f}s [{card}]", file=sys.stderr)
        if headline is None:
            headline = (name, rate)
    factors, n_cpu = _pipeline_overlap(Penalties(2, 3, 1))
    print(f"[bench] pipeline overlap factor (1024 pairs 1kbp CIGAR, {n_cpu} "
          f"on the CPU fallback): {' '.join(f'{f:.2f}' for f in factors)} "
          f"[{card}]", file=sys.stderr)
    print(json.dumps({
        "metric": f"alignments/s ({headline[0]})",
        "value": round(headline[1], 2),
        "unit": "alignments/s",
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
