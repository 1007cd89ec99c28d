"""wfa_tpu — wavefront alignment (WFA) framework in JAX/XLA.

A from-scratch re-design of batch gap-affine pairwise DNA alignment with the
capabilities of WFA-GPU (exact + adaptive-band modes, distance-only or full
CIGAR, CPU fallback, .seq/FASTA IO, CLI), run on an accelerator through XLA:
static-shape batched wavefront programs, host-precomputed control
schedules, dense choice-table backtraces, and data-parallel sharding over
device meshes.
"""
from .aligner import WfaAligner, align_pairs
from .params import AlignmentOptions, default_band_width, default_max_error
from .pipeline import align_pairs_pipelined
from .types import MAX_SEQ_LEN, AlignmentResult, Penalties

__version__ = "0.1.0"

__all__ = [
    "WfaAligner",
    "align_pairs",
    "align_pairs_pipelined",
    "AlignmentOptions",
    "AlignmentResult",
    "Penalties",
    "MAX_SEQ_LEN",
    "default_band_width",
    "default_max_error",
]
