"""ctypes bindings for the native C++ components (build/libwfatpu_native.so).

The native library provides the framework's host-side hot paths, mirroring the
reference's native layers:

* ``wfa_cpu_align_*`` — CPU WFA fallback engine + exact oracle (role of
  utils/wfa_cpu.c over the vendored WFA2-lib).
* ``wfa_traceback_batch`` — CIGAR recovery from device choice tables (role of
  utils/cigar.c `recover_cigar_affine`).
* ``wfa_read_*`` — fast .seq / FASTA readers (role of
  utils/sequence_reader.c).

Every entry point has a pure-Python fallback elsewhere in the package; this
module raises ``NativeUnavailable`` if the .so is missing so callers can
degrade gracefully.
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
from pathlib import Path

import numpy as np

from .types import Penalties
from .utils.logger import LOG

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SO_PATH = _REPO_ROOT / "build" / "libwfatpu_native.so"


class NativeUnavailable(RuntimeError):
    pass


_lib = None


def _try_build() -> None:
    makefile = _REPO_ROOT / "native" / "Makefile"
    if makefile.exists():
        try:
            subprocess.run(
                ["make", "-C", str(makefile.parent)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except subprocess.CalledProcessError as e:
            LOG.warning(
                "native build failed; using the Python fallbacks:\n%s",
                e.stderr.decode(errors="replace")[-2000:],
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            LOG.warning("native build failed (%s); using the Python "
                        "fallbacks", e)


def get_lib() -> ct.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _SO_PATH.exists():
        _try_build()
    if not _SO_PATH.exists():
        raise NativeUnavailable(f"{_SO_PATH} not built (run make -C native)")
    try:
        lib = _load_and_bind()
    except AttributeError:
        # Stale prebuilt .so from before a symbol was added: rebuild once
        # (make sees the newer sources) and retry; degrade to the Python
        # fallbacks — not an AttributeError crash — if it still lacks it.
        _try_build()
        try:
            lib = _load_and_bind()
        except AttributeError as e:
            raise NativeUnavailable(f"stale {_SO_PATH}: {e}") from e
    _lib = lib
    return lib


def _load_and_bind() -> ct.CDLL:
    lib = ct.CDLL(str(_SO_PATH))

    lib.wfa_cpu_align_single.restype = ct.c_int
    lib.wfa_cpu_align_single.argtypes = [
        ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
        ct.c_int, ct.c_int, ct.c_int,
    ]
    lib.wfa_cpu_align_batch.restype = None
    lib.wfa_cpu_align_batch.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int,
    ]
    lib.wfa_traceback_batch.restype = None
    lib.wfa_traceback_batch.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_int64, ct.c_void_p,
    ]
    lib.wfa_pack_batch.restype = None
    lib.wfa_pack_batch.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_void_p, ct.c_void_p,
    ]
    for name in ("wfa_read_seq_scan",):
        fn = getattr(lib, name)
        fn.restype = ct.c_int64
        fn.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int64)]
    lib.wfa_read_seq_load.restype = ct.c_int64
    lib.wfa_read_seq_load.argtypes = [
        ct.c_char_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_int64,
    ]
    lib.wfa_read_fasta_scan.restype = ct.c_int64
    lib.wfa_read_fasta_scan.argtypes = [
        ct.c_char_p, ct.c_char_p, ct.POINTER(ct.c_int64),
    ]
    lib.wfa_read_fasta_load.restype = ct.c_int64
    lib.wfa_read_fasta_load.argtypes = [
        ct.c_char_p, ct.c_char_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_int64,
    ]
    return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def cpu_align_single(pattern: bytes, text: bytes, pen: Penalties) -> int:
    """Exact single-pair oracle (compute_alignment_cpu analog)."""
    lib = get_lib()
    return lib.wfa_cpu_align_single(
        pattern, len(pattern), text, len(text), pen.x, pen.o, pen.e
    )


def pack_batch_native(
    seqs: list[bytes], out_words: int, max_seq_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-pass C++ packing + ACGT validity (sequence_packing_kernel.cu
    analog); semantics identical to ops/packing.pack_batch's NumPy path.
    Returns (packed[B, out_words] u32, lengths[B] i32, valid[B] bool)."""
    lib = get_lib()
    b = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=b)
    starts = np.zeros(b, dtype=np.int64)
    if b > 1:
        np.cumsum(lengths[:-1], out=starts[1:])
    flat = np.frombuffer(
        b"".join(seqs) if b else b"\0", dtype=np.uint8
    )
    lengths32 = lengths.astype(np.int32)
    out = np.empty((b, out_words), dtype=np.uint32)
    valid = np.empty(b, dtype=np.uint8)
    lib.wfa_pack_batch(
        _ptr(flat), _ptr(starts), _ptr(lengths32),
        ct.c_int32(b), ct.c_int32(out_words), ct.c_int32(max_seq_len),
        _ptr(out), _ptr(valid),
    )
    return out, lengths32, valid != 0


def _flat_seqs(patterns, texts):
    p_off = np.zeros(len(patterns), dtype=np.int64)
    t_off = np.zeros(len(patterns), dtype=np.int64)
    p_len = np.array([len(p) for p in patterns], dtype=np.int32)
    t_len = np.array([len(t) for t in texts], dtype=np.int32)
    total = int(p_len.sum() + t_len.sum())
    buf = np.empty(max(total, 1), dtype=np.uint8)
    pos = 0
    for i, (p, t) in enumerate(zip(patterns, texts)):
        p_off[i] = pos
        buf[pos : pos + len(p)] = np.frombuffer(p, dtype=np.uint8)
        pos += len(p)
        t_off[i] = pos
        buf[pos : pos + len(t)] = np.frombuffer(t, dtype=np.uint8)
        pos += len(t)
    return buf, p_off, t_off, p_len, t_len


def cpu_align_batch(
    patterns: list[bytes],
    texts: list[bytes],
    pen: Penalties,
    mask: np.ndarray,
    compute_cigar: bool,
    cigar_stride: int = 0,
    adaptive: bool = False,
) -> tuple[np.ndarray, list[str | None], np.ndarray]:
    """OpenMP batch fallback (compute_alignments_cpu_threaded analog).

    ``adaptive`` enables the WFA-adaptive trimming heuristic — the reference
    turns it on for the CPU pass when the device ran banded
    (utils/wfa_cpu.c:40-48).  Returns (distances, cigars, status); cigars
    entries are None for skipped pairs.  Retries with a larger stride on
    overflow.
    """
    lib = get_lib()
    n = len(patterns)
    buf, p_off, t_off, p_len, t_len = _flat_seqs(patterns, texts)
    mask8 = np.ascontiguousarray(mask, dtype=np.int8)
    dist = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int8)
    adp = 1 if adaptive else 0

    if compute_cigar:
        if cigar_stride <= 0:
            cigar_stride = 4096
        cig_buf = np.zeros(n * cigar_stride, dtype=np.uint8)
        lib.wfa_cpu_align_batch(
            _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
            _ptr(mask8), n, pen.x, pen.o, pen.e,
            _ptr(dist), _ptr(cig_buf), cigar_stride, _ptr(status), adp,
        )
        cigars: list[str | None] = []
        raw = cig_buf.tobytes()
        for i in range(n):
            if status[i] == 1:
                s = raw[i * cigar_stride : (i + 1) * cigar_stride]
                cigars.append(s.split(b"\0", 1)[0].decode())
            else:
                cigars.append(None)
        # Overflow retry on the failing rows only: one pathological
        # alignment must not make every row pay the wider-stride replay.
        over = np.flatnonzero(status == 2)
        if over.size:
            sub_d, sub_c, sub_s = cpu_align_batch(
                [patterns[i] for i in over], [texts[i] for i in over],
                pen, mask8[over], True, cigar_stride * 4, adaptive,
            )
            dist[over], status[over] = sub_d, sub_s
            for j, i in enumerate(over):
                cigars[i] = sub_c[j]
    else:
        lib.wfa_cpu_align_batch(
            _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
            _ptr(mask8), n, pen.x, pen.o, pen.e,
            _ptr(dist), None, 0, _ptr(status), adp,
        )
        cigars = [None] * n
    return dist, cigars, status


def traceback_batch(
    choices: np.ndarray,      # [S, B, W] uint8
    lo_trace: np.ndarray,     # [S, B] int32
    step_of_score: np.ndarray,  # [max_score+1] int32, -1 where absent
    distances: np.ndarray,    # [B] int32
    finished: np.ndarray,     # [B] bool
    patterns: list[bytes],
    texts: list[bytes],
    pen: Penalties,
    cigar_stride: int = 0,
) -> tuple[list[str | None], np.ndarray]:
    """Decode device choice tables into CIGARs (recover_cigar_affine analog)."""
    lib = get_lib()
    S, B, W = choices.shape
    choices = np.ascontiguousarray(choices, dtype=np.uint8)
    lo_trace = np.ascontiguousarray(lo_trace, dtype=np.int32)
    step_of_score = np.ascontiguousarray(step_of_score, dtype=np.int32)
    distances = np.ascontiguousarray(distances, dtype=np.int32)
    fin8 = np.ascontiguousarray(finished, dtype=np.int8)
    buf, p_off, t_off, p_len, t_len = _flat_seqs(patterns, texts)
    status = np.zeros(B, dtype=np.int8)

    if cigar_stride <= 0:
        cigar_stride = max(64, 8 * int(distances.max(initial=0)) + 64)
    cig_buf = np.zeros(B * cigar_stride, dtype=np.uint8)
    lib.wfa_traceback_batch(
        _ptr(choices), _ptr(lo_trace), S, B, W,
        _ptr(step_of_score), len(step_of_score) - 1,
        _ptr(distances), _ptr(fin8),
        _ptr(buf), _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len),
        pen.x, pen.o, pen.e,
        _ptr(cig_buf), cigar_stride, _ptr(status),
    )
    bad = status > 2
    if bad.any():
        raise RuntimeError(
            f"traceback failed for {bad.sum()} alignments (codes "
            f"{np.unique(status[bad])})"
        )
    cigars: list[str | None] = []
    raw = cig_buf.tobytes()
    for i in range(B):
        if status[i] == 1:
            s = raw[i * cigar_stride : (i + 1) * cigar_stride]
            cigars.append(s.split(b"\0", 1)[0].decode())
        else:
            cigars.append(None)
    over = np.flatnonzero(status == 2)
    if over.size:  # retry the overflowing subset only
        sub_c, sub_s = traceback_batch(
            choices[:, over], lo_trace[:, over], step_of_score,
            distances[over], finished[over],
            [patterns[i] for i in over], [texts[i] for i in over],
            pen, cigar_stride * 4,
        )
        status[over] = sub_s
        for j, i in enumerate(over):
            cigars[i] = sub_c[j]
    return cigars, status


def read_seq_native(path: str):
    """Fast .seq reader; returns (patterns, texts) as lists of bytes."""
    lib = get_lib()
    total = ct.c_int64(0)
    n = lib.wfa_read_seq_scan(str(path).encode(), ct.byref(total))
    if n < 0:
        raise IOError(f"cannot read .seq file {path}")
    buf = np.empty(max(int(total.value), 1), dtype=np.uint8)
    p_off = np.zeros(n, dtype=np.int64)
    t_off = np.zeros(n, dtype=np.int64)
    p_len = np.zeros(n, dtype=np.int32)
    t_len = np.zeros(n, dtype=np.int32)
    got = lib.wfa_read_seq_load(
        str(path).encode(), _ptr(buf), _ptr(p_off), _ptr(t_off),
        _ptr(p_len), _ptr(t_len), n,
    )
    raw = buf.tobytes()
    pats = [raw[p_off[i] : p_off[i] + p_len[i]] for i in range(got)]
    txts = [raw[t_off[i] : t_off[i] + t_len[i]] for i in range(got)]
    return pats, txts


def read_fasta_native(query_path: str, target_path: str):
    lib = get_lib()
    total = ct.c_int64(0)
    n = lib.wfa_read_fasta_scan(
        str(query_path).encode(), str(target_path).encode(), ct.byref(total)
    )
    if n < 0:
        raise IOError(f"cannot read FASTA files {query_path}, {target_path}")
    buf = np.empty(max(int(total.value), 1), dtype=np.uint8)
    p_off = np.zeros(n, dtype=np.int64)
    t_off = np.zeros(n, dtype=np.int64)
    p_len = np.zeros(n, dtype=np.int32)
    t_len = np.zeros(n, dtype=np.int32)
    got = lib.wfa_read_fasta_load(
        str(query_path).encode(), str(target_path).encode(), _ptr(buf),
        _ptr(p_off), _ptr(t_off), _ptr(p_len), _ptr(t_len), n,
    )
    raw = buf.tobytes()
    pats = [raw[p_off[i] : p_off[i] + p_len[i]] for i in range(got)]
    txts = [raw[t_off[i] : t_off[i] + t_len[i]] for i in range(got)]
    return pats, txts
