"""API walkthrough with manually tuned options.

Python analog of the reference's examples/manual_example.c: the full tuning
surface — max_error, banded (heuristic) execution with an explicit band width
and re-centering interval, batch size for the streaming pipeline, and
distance-only mode.

Run:  python examples/manual_example.py
"""
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wfa_tpu import AlignmentOptions, Penalties, align_pairs_pipelined


def noisy_copy(rng: random.Random, seq: str, err: float) -> str:
    out = list(seq)
    for _ in range(int(len(seq) * err)):
        op = rng.choice("XID")
        pos = rng.randrange(max(1, len(out)))
        if op == "X":
            out[pos] = rng.choice("ACGT")
        elif op == "I":
            out.insert(pos, rng.choice("ACGT"))
        elif len(out) > 1:
            del out[pos]
    return "".join(out)


def main() -> int:
    rng = random.Random(42)
    patterns, texts = [], []
    for _ in range(64):
        p = "".join(rng.choice("ACGT") for _ in range(1000))
        patterns.append(p.encode())
        texts.append(noisy_copy(rng, p, 0.05).encode())

    opts = AlignmentOptions(
        penalties=Penalties(x=5, o=3, e=2),
        # Kernel step budget; pairs needing more error go to the CPU engine
        # (reference: wfa_alignment_options_t.max_error).
        max_error=400,
        # Adaptive band: window of `band_width` diagonals, re-centered every
        # `band` scores (reference: -B/-t flags; band=0 would mean auto=25).
        band=25,
        band_width=128,
        # Streaming pipeline batch (reference: wfagpu_set_batch_size).
        batch_size=32,
        compute_cigar=False,
    )
    results = align_pairs_pipelined(patterns, texts, opts)

    on_dev = sum(r.finished_on_accelerator for r in results)
    print(f"aligned {len(results)} pairs ({on_dev} on the accelerator)")
    for i in (0, 1, 2):
        print(f"pair {i}: score {-results[i].error}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
