// Batch CIGAR recovery from the device engine's dense choice tables.
//
// Native, OpenMP-parallel equivalent of the reference's host-side CIGAR
// expansion pass (utils/wfa_cpu.c:88-107 calling recover_cigar_affine,
// utils/cigar.c:96-272): for every alignment the accelerator finished, walk
// the recorded per-step choices backwards from (M, final_score, target_k),
// then replay the op stream forwards, emitting run-length CIGAR with
// LCP-derived M runs and the gap-closing-SUB rule.
//
// Must stay semantically identical to wfa_tpu/traceback.py (the pure-Python
// reference implementation, cross-validated in tests).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <algorithm>

namespace {

constexpr int OP_NOOP = 0, OP_INS = 1, OP_SUB = 2, OP_DEL = 3, OP_M = 4;
constexpr uint8_t M_FROM_X = 0, M_FROM_I = 1, M_FROM_D = 2;
constexpr uint8_t I_EXT_BIT = 1 << 2, D_EXT_BIT = 1 << 3;

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

// Backward DP walk; ChoiceAt is (d, k) -> 4-bit choice, or a negative
// error code.
template <typename ChoiceAt>
static int walk_ops(ChoiceAt&& choice_at, int32_t distance, int plen,
                    int tlen, int x, int o, int e,
                    std::vector<uint8_t>* ops_rev) {
  ops_rev->reserve(2 * distance + 2);
  int mat = 0;
  long d = distance;
  int k = tlen - plen;
  while (d > 0) {
    int c = choice_at(d, k);
    if (c < 0) return -c;
    if (mat == 0) {
      ops_rev->push_back(OP_SUB);
      int mc = c & 3;
      if (mc == M_FROM_X) d -= x;
      else if (mc == M_FROM_I) mat = 1;
      else mat = 2;
    } else if (mat == 1) {
      ops_rev->push_back(OP_INS);
      if (c & I_EXT_BIT) { d -= e; --k; }
      else { mat = 0; d -= o + e; --k; }
    } else {
      ops_rev->push_back(OP_DEL);
      if (c & D_EXT_BIT) { d -= e; ++k; }
      else { mat = 0; d -= o + e; ++k; }
    }
  }
  if (mat != 0 || d != 0 || k != 0) return 3;
  std::reverse(ops_rev->begin(), ops_rev->end());
  return 0;
}

// Forward replay (utils/cigar.c:119-268 semantics) -> run-length CIGAR.
static void emit_cigar(const std::vector<uint8_t>& ops_rev, const char* pat,
                       int plen, const char* txt, int tlen, CigarBuf* cb);

static int decode_one(const uint8_t* choices, const int32_t* lo_trace,
                      int64_t S, int64_t B, int64_t W, int64_t b,
                      const int32_t* step_of_score, int32_t distance,
                      const char* pat, int plen, const char* txt, int tlen,
                      int x, int o, int e, std::string* out) {
  CigarBuf cb;
  if (distance == 0) {
    cb.push(OP_M, tlen);  // utils/cigar.c:108-110
    cb.flush();
    *out = std::move(cb.s);
    return 0;
  }
  auto choice_at = [&](long d, int k) -> int {
    int s = step_of_score[d];
    if (s < 0) return -1;
    int j = k - lo_trace[static_cast<int64_t>(s) * B + b];
    if (j < 0 || j >= W) return -2;
    return choices[(static_cast<int64_t>(s) * B + b) * W + j];
  };
  std::vector<uint8_t> ops_rev;
  int rc = walk_ops(choice_at, distance, plen, tlen, x, o, e, &ops_rev);
  if (rc != 0) return rc;
  emit_cigar(ops_rev, pat, plen, txt, tlen, &cb);
  cb.flush();
  *out = std::move(cb.s);
  return 0;
}

// Longest common prefix of pat[v:] / txt[h:], 8 bytes per XOR compare (the
// 64-bit analog of utils/cigar.c:63-94 `extend_wavefront`'s block loop).
static inline int lcp64(const char* pat, int v, int plen, const char* txt,
                        int h, int tlen) {
  int n = std::min(plen - v, tlen - h);
  int acc = 0;
  while (acc + 8 <= n) {
    uint64_t a, b;
    std::memcpy(&a, pat + v + acc, 8);
    std::memcpy(&b, txt + h + acc, 8);
    uint64_t diff = a ^ b;
    if (diff) return acc + (__builtin_ctzll(diff) >> 3);
    acc += 8;
  }
  while (acc < n && pat[v + acc] == txt[h + acc]) ++acc;
  return acc;
}

static void emit_cigar(const std::vector<uint8_t>& ops_rev, const char* pat,
                       int plen, const char* txt, int tlen, CigarBuf* cbp) {
  CigarBuf& cb = *cbp;
  bool extending = false;
  int k2 = 0;
  int off = 0;
  for (uint8_t opu : ops_rev) {
    int op = opu;
    if (!extending) {
      int acc = lcp64(pat, off - k2, plen, txt, off, tlen);
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
    cb.push(OP_M, lcp64(pat, off - k2, plen, txt, off, tlen));
  }
}

}  // namespace

extern "C" {

// choices:  uint8 [S, B, W]   per-step choice table from the device engine
// lo_trace: int32 [S, B]      window base per step
// step_of_score: int32[max_score+1], -1 where no wavefront was computed
// distances/finished: per-alignment results from the engine
// seqs + offsets/lengths: raw ASCII sequences (pattern, text)
// cigars: out buffer, cigar_stride bytes per alignment
// status: 0 skipped (unfinished -> CPU fallback), 1 ok, 2 overflow, >2 error
void wfa_traceback_batch(const uint8_t* choices, const int32_t* lo_trace,
                         int64_t S, int64_t B, int64_t W,
                         const int32_t* step_of_score, int64_t max_score,
                         const int32_t* distances, const int8_t* finished,
                         const char* seqs, const int64_t* p_off,
                         const int64_t* t_off, const int32_t* p_len,
                         const int32_t* t_len, int x, int o, int e,
                         char* cigars, int64_t cigar_stride, int8_t* status) {
#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t b = 0; b < B; ++b) {
    if (!finished[b] || distances[b] > max_score) {
      status[b] = 0;
      continue;
    }
    std::string cig;
    int rc = decode_one(choices, lo_trace, S, B, W, b, step_of_score,
                        distances[b], seqs + p_off[b], p_len[b],
                        seqs + t_off[b], t_len[b], x, o, e, &cig);
    if (rc != 0) {
      status[b] = static_cast<int8_t>(2 + rc);
      cigars[b * cigar_stride] = '\0';
      continue;
    }
    if (static_cast<int64_t>(cig.size()) + 1 <= cigar_stride) {
      std::memcpy(cigars + b * cigar_stride, cig.c_str(), cig.size() + 1);
      status[b] = 1;
    } else {
      cigars[b * cigar_stride] = '\0';
      status[b] = 2;
    }
  }
}

}  // extern "C"
