// CPU gap-affine wavefront aligner (score + CIGAR) — the fallback engine and
// differential-test oracle for the wavefront alignment framework.
//
// Role-equivalent to the reference's utils/wfa_cpu.c bridge over the vendored
// WFA2-lib (external/WFA): it re-aligns every pair the accelerator kernel
// could not finish within max_steps, and serves as the exact oracle for check
// mode (compute_alignment_cpu, utils/wfa_cpu.c:166-189).  Implemented from
// scratch: classic WFA over M/I/D wavefronts with per-score choice tables for
// traceback, OpenMP-parallel across alignments (cf. utils/wfa_cpu.c:52-57).
//
// Scores are returned as positive distances (the reference negates WFA2-lib's
// negative cost at the boundary, utils/wfa_cpu.c:186-189).
//
// Build: see native/Makefile (produces libwfatpu_native.so, bound via ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <climits>
#include <vector>
#include <string>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using offset_t = int32_t;
constexpr offset_t kNull = INT32_MIN / 4;

// Choice encoding shared with the device engine (wfa_tpu/ops/engine_xla.py).
constexpr uint8_t M_FROM_X = 0;
constexpr uint8_t M_FROM_I = 1;
constexpr uint8_t M_FROM_D = 2;
constexpr uint8_t I_EXT_BIT = 1 << 2;
constexpr uint8_t D_EXT_BIT = 1 << 3;

constexpr int OP_NOOP = 0, OP_INS = 1, OP_SUB = 2, OP_DEL = 3;

// Packed (offset, op) compare — same lexicographic tie-breaking as the
// reference MAX_PB packs (sequence_alignment_kernel.cu:165-289):
// gap-extend beats gap-open; DEL > SUB > INS on equal offsets.
static inline int64_t pack(offset_t off, int op) {
  return (static_cast<int64_t>(off) << 2) | op;
}

struct Wavefront {
  int lo = 0, hi = -1;          // empty when hi < lo
  std::vector<offset_t> m, i, d;
  bool exists = false;

  offset_t M(int k) const { return (k < lo || k > hi) ? kNull : m[k - lo]; }
  offset_t I(int k) const { return (k < lo || k > hi) ? kNull : i[k - lo]; }
  offset_t D(int k) const { return (k < lo || k > hi) ? kNull : d[k - lo]; }
};

static inline offset_t extend(const char* pat, int plen, const char* txt,
                              int tlen, int k, offset_t off) {
  int v = off - k, h = off;
  if (off < 0 || v > plen || h > tlen) return kNull;
  // 8-byte block compare, same idea as utils/cigar.c:63-94 but bounds-checked.
  while (v + 8 <= plen && h + 8 <= tlen) {
    uint64_t a, b;
    std::memcpy(&a, pat + v, 8);
    std::memcpy(&b, txt + h, 8);
    uint64_t diff = a ^ b;
    if (diff) {
      int eq = __builtin_ctzll(diff) >> 3;
      return off + (v - (off - k)) + eq;
    }
    v += 8;
    h += 8;
  }
  while (v < plen && h < tlen && pat[v] == txt[h]) {
    ++v;
    ++h;
  }
  return off + (v - (off - k));
}

struct CigarBuf {
  std::string s;
  int last_op = -1;
  long rep = 0;
  void push(int op, long count) {
    if (count <= 0) return;
    if (op == last_op) {
      rep += count;
      return;
    }
    flush();
    last_op = op;
    rep = count;
  }
  void flush() {
    if (rep > 0 && last_op >= 0) {
      char tmp[24];
      static const char ops[] = "?IXDM";
      int n = snprintf(tmp, sizeof tmp, "%ld%c", rep, ops[last_op]);
      s.append(tmp, n);
    }
    rep = 0;
    last_op = -1;
  }
};
constexpr int OP_M = 4;

// WFA-adaptive heuristic parameters (the reference enables WFA2-lib's
// wfadaptive heuristic for the CPU pass iff the accelerator ran banded,
// utils/wfa_cpu.c:40-48; these are WFA2's defaults).
constexpr int kAdaptiveMinLength = 10;
constexpr int kAdaptiveMaxDistDelta = 50;

// One full alignment. Returns distance; fills `cigar` when non-null.
// The forward pass stores one choice byte per computed (score, diagonal); the
// backward walk + run-length emitter reproduce the device traceback exactly
// (wfa_tpu/traceback.py; reference utils/cigar.c:96-272 semantics).
// `adaptive` trims unpromising diagonals (heuristic, score >= optimal).
static int align_one(const char* pat, int plen, const char* txt, int tlen,
                     int x, int o, int e, std::string* cigar,
                     bool adaptive = false) {
  const int target_k = tlen - plen;
  const offset_t target_off = tlen;

  const int ring = std::max(o + e, x) + 1;
  std::vector<Wavefront> ringbuf(ring);

  // choices[d] exists only for computed scores.
  std::vector<std::vector<uint8_t>> choices;
  std::vector<int> choice_lo;
  const bool want_cigar = cigar != nullptr;

  // score 0.
  {
    Wavefront& w = ringbuf[0];
    w.lo = w.hi = 0;
    w.m.assign(1, extend(pat, plen, txt, tlen, 0, 0));
    w.i.assign(1, kNull);
    w.d.assign(1, kNull);
    w.exists = true;
  }
  if (want_cigar) {
    choices.emplace_back();
    choice_lo.push_back(0);
  }
  if (target_k == 0 && ringbuf[0].m[0] == target_off) {
    if (want_cigar) {
      CigarBuf cb;
      cb.push(OP_M, tlen);
      cb.flush();
      *cigar = std::move(cb.s);
    }
    return 0;
  }

  // Existence bookkeeping mirrors the static schedule (wfa_tpu/schedule.py).
  std::vector<uint8_t> m_exist{1}, i_exist{0};

  const long hard_cap = static_cast<long>(plen + tlen + 4) *
                        std::max(x, o + e) + o + 8;
  for (long d = 1; d <= hard_cap; ++d) {
    bool gap = (d - o - e >= 0 && m_exist[d - o - e]) ||
               (d - e >= 0 && i_exist[d - e]);
    bool m = gap || (d - x >= 0 && m_exist[d - x]);
    i_exist.push_back(gap ? 1 : 0);
    m_exist.push_back(m ? 1 : 0);
    if (want_cigar) {
      choices.emplace_back();
      choice_lo.push_back(0);
    }
    if (!m) continue;

    const Wavefront* wx = (d - x >= 0 && m_exist[d - x])
                              ? &ringbuf[(d - x) % ring] : nullptr;
    const Wavefront* woe = (d - o - e >= 0 && m_exist[d - o - e])
                               ? &ringbuf[(d - o - e) % ring] : nullptr;
    const Wavefront* wie = (d - e >= 0 && i_exist[d - e])
                               ? &ringbuf[(d - e) % ring] : nullptr;

    int lo, hi;
    if (gap) {
      int hi_id = std::max(woe ? woe->hi : INT32_MIN / 2,
                           wie ? wie->hi : INT32_MIN / 2) + 1;
      int lo_id = std::min(woe ? woe->lo : INT32_MAX / 2,
                           wie ? wie->lo : INT32_MAX / 2) - 1;
      hi = std::max(wx ? wx->hi : INT32_MIN / 2, hi_id);
      lo = std::min(wx ? wx->lo : INT32_MAX / 2, lo_id);
    } else {
      hi = wx->hi;
      lo = wx->lo;
    }
    // Diagonals beyond the sequence envelope can never contribute.
    lo = std::max(lo, -plen - 1);
    hi = std::min(hi, tlen + 1);
    if (hi < lo) continue;

    Wavefront& w = ringbuf[d % ring];
    int width = hi - lo + 1;
    w.lo = lo;
    w.hi = hi;
    w.m.assign(width, kNull);
    w.i.assign(width, kNull);
    w.d.assign(width, kNull);
    w.exists = true;

    uint8_t* ch = nullptr;
    if (want_cigar) {
      choices[d].assign(width, 0);
      choice_lo[d] = lo;
      ch = choices[d].data();
    }

    for (int k = lo; k <= hi; ++k) {
      offset_t i_val = kNull, d_val = kNull;
      uint8_t cbits = 0;
      if (gap) {
        offset_t i_open = (woe ? woe->M(k - 1) : kNull) + 1;
        offset_t i_ext = (wie ? wie->I(k - 1) : kNull) + 1;
        int64_t ipb = std::max(pack(i_open, 1), pack(i_ext, 2));
        i_val = static_cast<offset_t>(ipb >> 2);
        if ((ipb & 3) == 2) cbits |= I_EXT_BIT;

        offset_t d_open = woe ? woe->M(k + 1) : kNull;
        offset_t d_ext = wie ? ringbuf[(d - e) % ring].D(k + 1) : kNull;
        int64_t dpb = std::max(pack(d_open, 1), pack(d_ext, 2));
        d_val = static_cast<offset_t>(dpb >> 2);
        if ((dpb & 3) == 2) cbits |= D_EXT_BIT;
      }
      offset_t x_off = (wx ? wx->M(k) : kNull) + 1;
      int64_t mpb = std::max(std::max(pack(x_off, OP_SUB), pack(d_val, OP_DEL)),
                             pack(i_val, OP_INS));
      offset_t m_cand = static_cast<offset_t>(mpb >> 2);
      int m_op = static_cast<int>(mpb & 3);
      if (ch) {
        uint8_t mc = (m_op == OP_SUB) ? M_FROM_X
                     : (m_op == OP_INS) ? M_FROM_I : M_FROM_D;
        ch[k - lo] = cbits | mc;
      }
      w.i[k - lo] = i_val;
      w.d[k - lo] = d_val;
      w.m[k - lo] = extend(pat, plen, txt, tlen, k, m_cand);
    }

    // WFA-adaptive reduction: drop diagonals whose distance-to-target
    // exceeds the best by more than the threshold.
    if (adaptive && hi - lo + 1 > kAdaptiveMinLength) {
      auto d2t = [&](int k) -> long {
        offset_t off = w.M(k);
        if (off < 0) return LONG_MAX / 2;
        long left_v = plen - (off - k);
        long left_h = tlen - off;
        return std::max(left_v, left_h);
      };
      long best = LONG_MAX / 2;
      for (int k = lo; k <= hi; ++k) best = std::min(best, d2t(k));
      int nlo = lo, nhi = hi;
      while (nlo < target_k && nhi - nlo + 1 > kAdaptiveMinLength &&
             d2t(nlo) - best > kAdaptiveMaxDistDelta)
        ++nlo;
      while (nhi > target_k && nhi - nlo + 1 > kAdaptiveMinLength &&
             d2t(nhi) - best > kAdaptiveMaxDistDelta)
        --nhi;
      if (nlo > lo || nhi < hi) {
        int nw = nhi - nlo + 1;
        std::vector<offset_t> nm(w.m.begin() + (nlo - lo),
                                 w.m.begin() + (nlo - lo) + nw);
        std::vector<offset_t> ni(w.i.begin() + (nlo - lo),
                                 w.i.begin() + (nlo - lo) + nw);
        std::vector<offset_t> nd(w.d.begin() + (nlo - lo),
                                 w.d.begin() + (nlo - lo) + nw);
        w.m.swap(nm);
        w.i.swap(ni);
        w.d.swap(nd);
        w.lo = nlo;
        w.hi = nhi;
      }
    }

    if (std::abs(target_k) <= d && w.M(target_k) == target_off) {
      if (want_cigar) {
        // Backward walk over choice tables -> forward op replay.
        std::vector<uint8_t> ops_rev;
        int mat = 0;
        long dd = d;
        int kk = target_k;
        while (dd > 0) {
          uint8_t c = choices[dd][kk - choice_lo[dd]];
          if (mat == 0) {
            ops_rev.push_back(OP_SUB);
            int mc = c & 3;
            if (mc == M_FROM_X) dd -= x;
            else if (mc == M_FROM_I) mat = 1;
            else mat = 2;
          } else if (mat == 1) {
            ops_rev.push_back(OP_INS);
            if (c & I_EXT_BIT) { dd -= e; --kk; }
            else { mat = 0; dd -= o + e; --kk; }
          } else {
            ops_rev.push_back(OP_DEL);
            if (c & D_EXT_BIT) { dd -= e; ++kk; }
            else { mat = 0; dd -= o + e; ++kk; }
          }
        }
        std::reverse(ops_rev.begin(), ops_rev.end());

        // Forward run-length decode (reference utils/cigar.c:119-268
        // semantics, incl. the gap-closing SUB -> NOOP rule).
        CigarBuf cb;
        bool extending = false;
        int k2 = 0;
        offset_t off = 0;
        for (uint8_t opu : ops_rev) {
          int op = opu;
          if (!extending) {
            int v = off - k2, h = off;
            int n = std::min(plen - v, tlen - h);
            int acc = 0;
            while (acc < n && pat[v + acc] == txt[h + acc]) ++acc;
            cb.push(OP_M, acc);
            off += acc;
          }
          if (op == OP_DEL) { extending = true; --k2; }
          else if (op == OP_SUB) {
            if (extending) { extending = false; op = OP_NOOP; }
            else ++off;
          } else { extending = true; ++k2; ++off; }
          if (op != OP_NOOP) cb.push(op, 1);
        }
        if (!extending) {
          int v = off - k2, h = off;
          int n = std::min(plen - v, tlen - h);
          int acc = 0;
          while (acc < n && pat[v + acc] == txt[h + acc]) ++acc;
          cb.push(OP_M, acc);
        }
        cb.flush();
        *cigar = std::move(cb.s);
      }
      return static_cast<int>(d);
    }
  }
  return -1;  // unreachable for well-formed inputs
}

}  // namespace

extern "C" {

// Single-pair exact oracle (analog of compute_alignment_cpu,
// utils/wfa_cpu.c:166-189).  Returns the distance.
int wfa_cpu_align_single(const char* pattern, int plen, const char* text,
                         int tlen, int x, int o, int e) {
  return align_one(pattern, plen, text, tlen, x, o, e, nullptr);
}

// Batch alignment over flat buffers (analog of
// compute_alignments_cpu_threaded / compute_distance_cpu_threaded,
// utils/wfa_cpu.c:30-164).
//
//   seqs         concatenated pattern/text bytes
//   p_off/t_off  int64 offsets into seqs, per pair
//   p_len/t_len  int32 lengths
//   mask         int8: only pairs with mask[i] != 0 are aligned
//   distances    out int32[n]
//   cigars       out char buffer, `cigar_stride` bytes per pair (may be null
//                for distance-only); NUL-terminated, truncated-never: pairs
//                whose CIGAR exceeds the stride get status 2.
//   status       out int8[n]: 0 skipped, 1 ok, 2 cigar-overflow
//   adaptive     != 0 enables the WFA-adaptive trimming heuristic (used when
//                the accelerator ran banded, like utils/wfa_cpu.c:40-48);
//                falls back to the exact pass if the heuristic dead-ends.
void wfa_cpu_align_batch(const char* seqs, const int64_t* p_off,
                         const int64_t* t_off, const int32_t* p_len,
                         const int32_t* t_len, const int8_t* mask, int64_t n,
                         int x, int o, int e, int32_t* distances, char* cigars,
                         int64_t cigar_stride, int8_t* status, int adaptive) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) {
      status[i] = 0;
      continue;
    }
    std::string cig;
    std::string* cp = cigars ? &cig : nullptr;
    int dist = align_one(seqs + p_off[i], p_len[i], seqs + t_off[i], t_len[i],
                         x, o, e, cp, adaptive != 0);
    if (dist < 0 && adaptive) {
      if (cp) cig.clear();
      dist = align_one(seqs + p_off[i], p_len[i], seqs + t_off[i], t_len[i],
                       x, o, e, cp, false);
    }
    distances[i] = dist;
    if (cigars) {
      if (static_cast<int64_t>(cig.size()) + 1 <= cigar_stride) {
        std::memcpy(cigars + i * cigar_stride, cig.c_str(), cig.size() + 1);
        status[i] = 1;
      } else {
        cigars[i * cigar_stride] = '\0';
        status[i] = 2;
      }
    } else {
      status[i] = 1;
    }
  }
}

int wfa_cpu_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
