"""Band-width recall on Nanopore-like reads.

The reference's approximate-mode chart (README.md:123-137) reports recall on
a Nanopore dataset.  This tool aligns one seeded batch exactly (on the
device, cross-checked against the CPU oracle on a subsample), then in banded
mode at several band widths, and prints for each width how many pairs the
device finished and how many of those scored optimally.

Two read models:

* default: uniform 6% error.  Uniform errors keep the optimal path
  centered, so every band width recalls 100% — this bounds the easy case
  but cannot discriminate.
* ``--burst``: 1% background error plus clustered structural events
  (200–500 bp insertions/deletions and 50–300 bp high-error patches at
  random loci).  Long indels displace the optimal path by hundreds of
  diagonals between re-centering steps, which is exactly what the banded
  heuristic can miss.

Run:  python tools/nanopore_recall.py [--burst] [--n 128] [--length 20000]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from wfa_tpu import native  # noqa: E402
from wfa_tpu.aligner import align_pairs  # noqa: E402
from wfa_tpu.params import AlignmentOptions  # noqa: E402
from wfa_tpu.types import Penalties  # noqa: E402
from wfa_tpu.utils import synth  # noqa: E402
from wfa_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def mutate_bursts(rng, seqs, bg_err=0.01, n_bursts=3):
    """Background error plus clustered indel/substitution bursts."""
    out = []
    for s in seqs:
        t = bytearray(synth.mutate(rng, [s], bg_err)[0])
        for _ in range(n_bursts):
            kind = rng.integers(0, 3)
            pos = int(rng.integers(100, max(101, len(t) - 600)))
            if kind == 0:      # long deletion
                del t[pos : pos + int(rng.integers(200, 501))]
            elif kind == 1:    # long insertion
                ln = int(rng.integers(200, 501))
                t[pos:pos] = synth.random_reads(rng, 1, ln)[0]
            else:              # high-error patch
                ln = int(rng.integers(50, 301))
                t[pos : pos + ln] = synth.mutate(
                    rng, [bytes(t[pos : pos + ln])], 0.4
                )[0]
        out.append(bytes(t))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--burst", action="store_true")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--length", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    enable_compile_cache()

    rng = np.random.default_rng(args.seed)
    pats = synth.random_reads(rng, args.n, args.length)
    txts = (mutate_bursts(rng, pats) if args.burst
            else synth.mutate(rng, pats, 0.06))
    pen = Penalties(2, 3, 1)
    max_error = 5000

    res = align_pairs(
        pats, txts, AlignmentOptions(penalties=pen, max_error=max_error)
    )
    exact = np.array([r.error for r in res])
    for i in rng.choice(args.n, size=min(4, args.n), replace=False):
        assert exact[i] == native.cpu_align_single(pats[i], txts[i], pen), i
    print(f"exact distances: {exact.min()}..{exact.max()}")

    for width in (128, 256, 512, 1024):
        res = align_pairs(pats, txts, AlignmentOptions(
            penalties=pen, max_error=max_error, band=25, band_width=width,
            device_retries=0, cpu_fallback=False,
        ))
        d = np.array([r.error for r in res])
        f = np.array([r.finished_on_accelerator for r in res])
        opt = (d == exact) & f
        print(
            f"band width {width:4d}: finished {f.sum()}/{args.n}, "
            f"score==optimal {opt.sum()}/{args.n} "
            f"({100.0 * opt.sum() / args.n:.1f}%), max inflation "
            f"{(d - exact)[f].max(initial=0)}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
