// Fused matcher -> top-K: the dual-softmax match matrix never reaches
// device memory.
//
// Replaces mickey_tpu/ops/fused_matcher.py::fused_topk_scores, i.e. its two
// Pallas kernels driven by _topk_candidates:
//   K2a  _col_stats_kernel  -> mk_col_lse_f32: per column j of the
//        correlation s = dsc0 dsc1^T / T, lse_col_j = logsumexp_i s_ij,
//        folded with the dustbin logit alpha by a closed-form logaddexp
//        (the TPU kernel's glue at _topk_candidates:546-547 moves in here);
//   K2b  _pair_topk_kernel  -> mk_pair_topk_f32: per row i, lse_row_i
//        including alpha, the final score
//        f_ij = exp(s_ij - lse_row_i) exp(s_ij - lse_col_j) scr0_i scr1_j,
//        the row's top-L (value, flat index i*N + j) that L rounds of
//        max / first index / mask give, and the row's validity partials
//        (mass, non-finite count, minimum).
// The reference computes the correlation at Precision.HIGHEST (1/T = 10
// turns TF32 truncation into ~0.04 logit error). Both kernels run it at
// fp32 accuracy as 3xTF32 wgmma on the correlation engine of corr_tf32.cuh
// (its design is there), on one split of the descriptors: K2a's prep
// writes it, K2b reads it (its wrapper passes K2a's scratch) and runs no
// prep of its own. Under cfg.TPU.MATCHER_BF16 the JAX package hands both
// Pallas kernels bf16 descriptors, which they multiply in one MXU pass with
// fp32 accumulation (_corr_block's bf16 branch): mk_col_lse_bf16 and
// mk_pair_topk_bf16 are the same kernels in the engine's bf16 mode (one bf16
// wgmma pass, exact for bf16 operands), K2b again on K2a's prepared copy.
// K2a: each CTA owns 64 columns (dsc1 rows) and sweeps one
// chunk of dsc0's rows; col_lse_combine_kernel folds the chunks' (max, sum)
// partials in a fixed order and adds alpha, so no float atomics and two
// launches agree bitwise.
//
// What bounds K2b on the H100: the correlation, 3 x 2 B M N C flops at
// 495 TFLOP/s TF32 (0.012 ms at B = 2, M = N = 1938, C = 128; the FFMA
// body it replaces was capped by 67 TFLOP/s fp32, 0.029 ms, and took 0.61
// ms on an H100 SXM at 700 W; bf16 mode: 2 B M N C flops at 989 TFLOP/s,
// 0.0019 ms), and two exponentials a score, against
// reading the descriptors and writing the (B, L, M) table. In practice the
// per-tile epilogues: one warpgroup a CTA is one warp an SM partition, which
// hides no latency, so every dependent chain in an epilogue adds to the
// tile's time. Design (topk_kernel, one warpgroup of 64 own rows of
// dsc0, K4's two sweeps):
//  - sweep 1 is K4's first sweep, the same issue_corr chains and the same
//    corr_lse_tile / corr_lse_row, so K2b's s and lse_row are K4's bit for
//    bit; besides, each thread keeps, for each of its two rows, the 4
//    largest of its tiles' largest keys (2 u - lse_col log2 e + log2 scr1,
//    which orders a row's scores as log2 f does, up to rounding; the tile's
//    largest by a tree of depth 4). The L-th largest of a row's 16 keys is
//    its bar: L of its scores lie at or above the score it implies, so none
//    of its best L lies below that score less a margin (the floor,
//    topk_floor; -inf where scr0 or underflow would make the scores tie
//    and go by column);
//  - sweep 2 recomputes s and forms the 32 scores f of a thread in the JAX
//    order first, independent of one another, then the row stats by trees
//    (mass, minimum) and bit masks (non-finite, NaN, NaN in the last
//    column), then gives each score at or above the floor to the thread's
//    own list for that row: 16 slots in shared memory (128 threads x 2 rows
//    x 16 x 8 B = 32 KB beside the engine's 197 KB), a predicated store.
//    ~25 scores a row pass at random scores, ~6 a list, so a full list
//    (topk_replace's scan) is rare. Inserting into one list a row in turn,
//    or with no floor, was several times slower (PERF.md);
//  - at the end each entry of a row's four lists counts the entries that
//    beat it (value desc, column asc): its rank is its round, so the best L
//    go straight to their places and the rounds' rules (all (NaN, N - 1)
//    for a NaN before the last column, (NaN, N - 1) first for one in it, (0,
//    column 0) past the list) fill the rest. The lists hold the row's best L
//    under a strict order whatever the order of insertion, so launches
//    agree bitwise.
// At B = 2 the 62 own tiles leave half of the 132 SMs idle, so the wrapper
// splits the column tiles into chunks there (ops/fused_matcher.py::
// pair_topk_chunks): a sweep-1 launch writes each chunk's partial
// logsumexps and keys, topk_combine_kernel folds them into lse_row and the
// bars (a warp a row), a sweep-2 launch writes each chunk's ranked list,
// stats and flags, and topk_merge_kernel ranks the chunks' entries into the
// rounds (a warp a row).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "corr_tf32.cuh"

namespace {

constexpr int TOPK_MAX_L = 16;       // row_topl a list in shared memory holds
// column chunks of a split launch: two at the serving shape beat one, three
// and four did not (PERF.md)
constexpr int TOPK_MAX_CHUNKS = 2;
constexpr int TOPK_KEYS = 16;        // sweep 1's keys a row: 4 a thread, 4 threads
constexpr int TOPK_NONE = INT_MAX;   // the column of an empty list entry
constexpr int TOPK_NAN_OTHER = 1;    // a row's flags: a NaN score before its last column,
constexpr int TOPK_NAN_LAST = 2;     // in its last column
// A score may sit this far (log2 units) below the score its row's bar
// implies and still enter a list: the key orders a row's scores up to
// ~1e-5 of rounding.
constexpr float TOPK_KEY_MARGIN = 1e-3f;
// a CTA's lists: two a thread (its rows g and g + 8), TOPK_MAX_L entries
// of 8 bytes each, after the engine's shared memory
constexpr size_t TOPK_LIST_BYTES = CORR_NT * 2 * TOPK_MAX_L * 8;
template <class Op>
constexpr size_t topk_smem() {
  return corr_smem<Op>() + TOPK_LIST_BYTES;
}
static_assert(topk_smem<CorrTf32>() <= 232448, "one CTA an SM");
static_assert(TOPK_MAX_CHUNKS * TOPK_KEYS <= 64 && TOPK_MAX_CHUNKS * TOPK_MAX_L <= 64,
              "the fold and the merge rank two entries a lane");
enum TopkMode : int { TOPK_BOTH = 0, TOPK_SWEEP1 = 1, TOPK_SWEEP2 = 2 };

__device__ __forceinline__ float logaddexp(float x, float y) {
  // jnp.logaddexp: amax + log1p(exp(-|x - y|)), NaN-propagating
  float d = x - y;
  if (isnan(d)) return x + y;
  return fmaxf(x, y) + log1pf(expf(-fabsf(d)));
}

// lse_col[b, j] = logaddexp(logsumexp of column j, alpha) from the engine's
// partials part[b, chunk, j] = (shift, sum of exp2(u - shift)), u = s log2 e,
// summed over the chunks in order.
__global__ void col_lse_combine_kernel(const float2* __restrict__ part, float* __restrict__ lse_col, int B,
                                       int chunks, int N, float alpha) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * N) return;
  const int b = e / N, j = e % N;
  const float2* p = part + static_cast<long long>(b) * chunks * N + j;
  float top = -INFINITY;
  for (int k = 0; k < chunks; ++k) top = fmaxf(top, p[static_cast<long long>(k) * N].x);
  float tot = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float2 v = p[static_cast<long long>(k) * N];
    tot += v.y * exp2f(v.x - top);
  }
  lse_col[e] = logaddexp((log2f(tot) + top) * CORR_LN2, alpha);
}

// (v, j) comes before (bv, bj) in a row's rounds: a larger value, or the
// lower column of an exact tie.
__device__ __forceinline__ bool topk_beats(float v, int j, float bv, int bj) { return v > bv || (v == bv && j < bj); }

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sweep 1's key of a score: 2 u + cb with cb = -lse_col log2 e + log2
// scr1 of its column, which orders a row's scores f as log2 f less a row
// constant does, up to rounding: f = exp2(key - lse_row log2 e) scr0.

// x into a thread's 4 largest keys k[0] >= ... >= k[3] (NaN never
// enters), without a branch: a max into the last place, then one
// compare-exchange a place up.
__device__ __forceinline__ void topk_keep4(float (&k)[4], float x) {
  k[3] = x > k[3] ? x : k[3];
#pragma unroll
  for (int p = 3; p > 0; --p) {
    const float hi = fmaxf(k[p - 1], k[p]), lo = fminf(k[p - 1], k[p]);
    k[p - 1] = hi;
    k[p] = lo;
  }
}

// The bar of a row: the L-th largest of keys (n of them, distinct entries),
// so that L of the row's scores have keys at or above it; -inf if fewer.
__device__ __forceinline__ float topk_bar(const float* keys, int n, int L) {
  float bar = -INFINITY;
  for (int a = 0; a < n; ++a) {
    int at_least = 0;
    for (int b = 0; b < n; ++b) at_least += keys[b] >= keys[a];
    if (at_least >= L) bar = fmaxf(bar, keys[a]);
  }
  return bar;
}

// A row's floor for sweep 2 from its bar: exp2(bar - TOPK_KEY_MARGIN + ar)
// scr0 (ar = -lse_row log2 e), below the least score of L of the row's
// entries, so no score of its best L lies below it. Only where the keys
// order the row's scores: scr0 a positive normal number (the key leaves the
// row's factors out; at 0 or +inf all scores tie and go by column) and the
// bar's scores clear of underflow (log2 above -100). Else -inf: every score
// passes.
__device__ __forceinline__ float topk_floor(float bar, float ar, float q0) {
  if (!(q0 >= 1.17549435e-38f && q0 <= 3.40282347e38f && bar + ar + lg2(q0) > -100.f)) return -INFINITY;
  return corr_ex2(bar - TOPK_KEY_MARGIN + ar) * q0;
}

// One thread's list of a row's scores in its columns: TOPK_MAX_L slots of
// (value bits, column) in shared memory, unsorted; the k-th score given it
// goes to slot (k + lane) % 16 (so the lanes of a warp filling their lists
// hit 16 banks), the empty ones (-inf, TOPK_NONE); n, in registers, counts
// the slots taken. Once it holds L, a score takes the place of the worst
// entry under topk_beats if it beats it (topk_replace: a scan, rare, since
// few scores pass the floor), so the list holds the best L of the scores
// given it whatever their order.
__device__ void topk_replace(int2* lst, int L, int lane, float v, int j) {
  int ws = lane & (TOPK_MAX_L - 1);
  int2 w = lst[ws];
  for (int k = 1; k < L; ++k) {
    const int at = (k + lane) & (TOPK_MAX_L - 1);
    const int2 e = lst[at];
    if (topk_beats(__int_as_float(w.x), w.y, __int_as_float(e.x), e.y)) {
      w = e;
      ws = at;
    }
  }
  if (topk_beats(v, j, __int_as_float(w.x), w.y)) lst[ws] = make_int2(__float_as_int(v), j);
}

// The minimum of a row's scores, NaN-propagating as torch.amin: NaN once
// any score is NaN.
__device__ __forceinline__ float nan_min(float mn, float f) { return (f < mn || isnan(f)) ? f : mn; }

struct TopkArgs {
  int M, N, L;
  int per;          // column tiles of a chunk (all of them in one)
  float c;          // inv_temp log2 e
  float alpha2;     // alpha log2 e
  const float* scr0;
  const float* scr1;
  const float* lse_col;
  float* lse_row;   // written by TOPK_BOTH's first sweep, read by TOPK_SWEEP2
  float* bar;       // a split launch: each row's bar (topk_combine_kernel)
  float* vals;      // TOPK_BOTH: the outputs
  int* idxs;
  float* stats;
  float2* lse_part; // TOPK_SWEEP1: per (b, chunk, row) (shift, sum of exp2(u - shift))
  float* keys;      // and the row's TOPK_KEYS keys
  int2* plist;      // TOPK_SWEEP2: per (b, chunk, row) the chunk's best L,
  float4* pstat;    // and (mass, non-finite count, minimum, flags)
};

// The end of sweep 2. The rows' stats over their four lanes; then every
// entry of the row's four lists takes its rank among them (how many beat
// it), so the best L go straight to their places, no sort: final (the
// outputs, as L rounds of max / first index / mask give them: a NaN before
// the last column makes every round (NaN, N - 1); one only in the last
// column is round 0, the list follows; rounds past the list take (0,
// column 0)), or the chunk's partials (the list in order, empty entries
// after it; topk_merge_kernel applies the rules). Lane t4 = h writes the
// special rounds of row h (r0, r1).
__device__ __forceinline__ void topk_finish(const TopkArgs& a, const int2* lists, int warp, int g, int t4, int r0, int r1,
                                            int n0, int n1, float mass0, float mass1, float bad0, float bad1,
                                            float mn0, float mn1, int fl0, int fl1, bool final) {
  const int b = blockIdx.z;
  const long long rb = static_cast<long long>(b) * a.M;
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mass0 += __shfl_xor_sync(0xffffffffu, mass0, o);
    mass1 += __shfl_xor_sync(0xffffffffu, mass1, o);
    bad0 += __shfl_xor_sync(0xffffffffu, bad0, o);
    bad1 += __shfl_xor_sync(0xffffffffu, bad1, o);
    mn0 = nan_min(mn0, __shfl_xor_sync(0xffffffffu, mn0, o));
    mn1 = nan_min(mn1, __shfl_xor_sync(0xffffffffu, mn1, o));
    fl0 |= __shfl_xor_sync(0xffffffffu, fl0, o);
    fl1 |= __shfl_xor_sync(0xffffffffu, fl1, o);
    n0 += __shfl_xor_sync(0xffffffffu, n0, o);
    n1 += __shfl_xor_sync(0xffffffffu, n1, o);
  }
  __syncwarp();  // every lane's lists are complete
  const int2* row_lists = lists + 2 * (32 * warp + 4 * g) * TOPK_MAX_L;  // lane 4 g + q's of row h at (2 q + h) 16
  const long long slot0 = final ? 0 : (static_cast<long long>(b) * gridDim.y + blockIdx.y) * a.M;
  for (int h = 0; h < 2; ++h) {
    const int row = h ? r1 : r0;
    if (row >= a.M) continue;
    const int flags = h ? fl1 : fl0;
    const int shift = final && (flags & TOPK_NAN_LAST) ? 1 : 0;
    const int2* own = row_lists + (2 * t4 + h) * TOPK_MAX_L;
    if (!(final && (flags & TOPK_NAN_OTHER))) {
      for (int k = 0; k < TOPK_MAX_L; ++k) {
        const int2 e = own[k];
        if (e.y == TOPK_NONE) continue;
        const float v = __int_as_float(e.x);
        int rank = 0;
        for (int q = 0; q < 4; ++q) {
          const int2* other = row_lists + (2 * q + h) * TOPK_MAX_L;
#pragma unroll
          for (int kk = 0; kk < TOPK_MAX_L; ++kk) rank += topk_beats(__int_as_float(other[kk].x), other[kk].y, v, e.y);
        }
        const int l = rank + shift;
        if (l >= a.L) continue;
        if (final) {
          const long long o = (static_cast<long long>(b) * a.L + l) * a.M + row;
          a.vals[o] = fmaxf(v, 0.f);
          a.idxs[o] = row * a.N + e.y;
        } else {
          a.plist[(slot0 + row) * a.L + l] = e;
        }
      }
    }
    if (t4 != h) continue;
    const int listed = min(h ? n1 : n0, a.L);  // the row's entries in all four lists, at most L ranked
    if (final) {
      float* out = a.stats + (rb + row) * 3;
      out[0] = h ? mass1 : mass0;
      out[1] = h ? bad1 : bad0;
      out[2] = h ? mn1 : mn0;
      for (int l = 0; l < a.L; ++l) {
        const long long o = (static_cast<long long>(b) * a.L + l) * a.M + row;
        if ((flags & TOPK_NAN_OTHER) || l < shift) {
          a.vals[o] = NAN;
          a.idxs[o] = row * a.N + a.N - 1;
        } else if (l >= listed + shift) {
          a.vals[o] = 0.f;
          a.idxs[o] = row * a.N;
        }
      }
    } else {
      a.pstat[slot0 + row] = make_float4(h ? mass1 : mass0, h ? bad1 : bad0, h ? mn1 : mn0, __int_as_float(flags));
      for (int l = listed; l < a.L; ++l) a.plist[(slot0 + row) * a.L + l] = make_int2(__float_as_int(-INFINITY), TOPK_NONE);
    }
  }
}

// K2b on the engine in mode Op, in corr_fwd_kernel's accumulator layout: one CTA owns
// 64 rows of dsc0 (blockIdx.x) of one image (blockIdx.z) and sweeps chunk
// blockIdx.y of dsc1's column tiles (all of them for TOPK_BOTH).
//  - sweep 1 (TOPK_BOTH, TOPK_SWEEP1) is K4's, the same corr_lse_tile; each
//    thread keeps the 4 largest of its tiles' largest keys (2 u + cb,
//    topk_keep4) of each of its rows; TOPK_BOTH then has lse_row
//    (corr_lse_row) and each row's bar from its 16 keys, TOPK_SWEEP1 writes
//    the chunk's partial logsumexps and keys;
//  - sweep 2 (TOPK_BOTH, TOPK_SWEEP2) forms f, keeps the row's stats in
//    registers and gives each thread's lists the scores not below the
//    row's floor (topk_floor): no score of a row's best L is left out, and
//    few others pass; TOPK_BOTH writes the outputs, TOPK_SWEEP2 its chunk's
//    partials for topk_merge_kernel.
template <int kMode, class Op>
__global__ void __launch_bounds__(CORR_NT, 1)
topk_kernel(const __grid_constant__ CorrMaps maps, const TopkArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t own = base, ring = base + Op::kTile;
  const uint32_t bar0 = ring + CORR_STAGES * Op::kTile, a_bar = bar0 + 8 * CORR_STAGES;
  // thread t's lists of rows g, g + 8 at lists + (2 t + {0, 1}) TOPK_MAX_L
  int2* lists = reinterpret_cast<int2*>(smem_raw + (a_bar + 8 - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * CORR_BM, b = blockIdx.z;
  const int first = blockIdx.y * a.per;
  const int nt = min(a.per, (a.N + CORR_BN - 1) / CORR_BN - first);
  const int total = kMode == TOPK_BOTH ? 2 * nt : nt;

  auto load_stage = [&](int t) {
    Op::load(ring + (t % CORR_STAGES) * Op::kTile, &maps.oth_hi, &maps.oth_lo, bar0 + 8 * (t % CORR_STAGES),
             (first + t % nt) * CORR_BN, b);
  };
  if (kMode != TOPK_SWEEP1) {
    for (int e = tid; e < 2 * CORR_NT * TOPK_MAX_L; e += CORR_NT)
      lists[e] = make_int2(__float_as_int(-INFINITY), TOPK_NONE);
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st <= CORR_STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    Op::load(own, &maps.own_hi, &maps.own_lo, a_bar, o0, b);
    for (int t = 0; t < CORR_STAGES && t < total; ++t) load_stage(t);
  }

  const int r0 = o0 + 16 * warp + g, r1 = r0 + 8;
  int2* lst0 = lists + 2 * tid * TOPK_MAX_L;  // this thread's of row r0, then r1
  int2* lst1 = lst0 + TOPK_MAX_L;
  const long long rb = static_cast<long long>(b) * a.M;
  float ar0 = 0.f, ar1 = 0.f;                  // sweep 2: -lse_row log2 e of rows r0, r1
  float fb0 = -INFINITY, fb1 = -INFINITY;      // sweep 2: the rows' floors (topk_floor)
  const float q0 = r0 < a.M ? a.scr0[rb + r0] : 0.f, q1 = r1 < a.M ? a.scr0[rb + r1] : 0.f;
  if (kMode == TOPK_SWEEP2) {
    ar0 = r0 < a.M ? -a.lse_row[rb + r0] * CORR_LOG2E : 0.f;
    ar1 = r1 < a.M ? -a.lse_row[rb + r1] * CORR_LOG2E : 0.f;
    fb0 = r0 < a.M ? topk_floor(a.bar[rb + r0], ar0, q0) : 0.f;
    fb1 = r1 < a.M ? topk_floor(a.bar[rb + r1], ar1, q1) : 0.f;
  }
  const float* lc = a.lse_col + static_cast<long long>(b) * a.N;
  const float* s1 = a.scr1 + static_cast<long long>(b) * a.N;
  mbar_wait(a_bar, 0);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // sweep 1, as corr_tf32_kernel
  float key0[4], key1[4];                                     // sweep 1: the rows' 4 largest keys
#pragma unroll
  for (int k = 0; k < 4; ++k) key0[k] = key1[k] = -INFINITY;
  // sweep 2: rows r0, r1's stats over this thread's columns: mass, the
  // minimum of the scores that are not NaN, and the counts of non-finite
  // scores, of NaN and of NaN in the last column
  float mass0 = 0.f, mass1 = 0.f, mn0 = INFINITY, mn1 = INFINITY;
  int bad0 = 0, bad1 = 0, nan0 = 0, nan1 = 0, last0 = 0, last1 = 0;
  int n0 = 0, n1 = 0;    // the lists' counts
  float s[32];
  float x[32], h[4][32];

  for (int t = 0; t < total; ++t) {
    const int st = t % CORR_STAGES;
    if (!CORR_ABLATE_LOADS || t < CORR_STAGES) mbar_wait(bar0 + 8 * st, (t / CORR_STAGES) & 1);
    Op::issue(x, h, own, ring + st * Op::kTile);
    const int j0 = (first + t % nt) * CORR_BN;  // the column of accumulator column 0
    // -lse_col log2 e and scr1 of this thread's 16 columns (index 2 j + e:
    // column 8 j + 2 t4 + e), loaded under the products
    float bc[16], q[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = j0 + 8 * (k >> 1) + 2 * t4 + (k & 1);
      bc[k] = col < a.N ? -lc[col] * CORR_LOG2E : 0.f;
      q[k] = col < a.N ? s1[col] : 0.f;
    }
    wgmma_wait();
    Op::sum(s, x, h);

    if (kMode == TOPK_SWEEP1 || (kMode == TOPK_BOTH && t < nt)) {
      corr_lse_tile(s, a.c, a.N - j0, t4, m0, m1, l0, l1);  // s is u now, -inf past the last column
      // each row's largest key of the tile (a tree of depth 4) into its 4 largest
#pragma unroll
      for (int k = 0; k < 16; ++k) bc[k] += lg2(q[k]);  // cb
      float key[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) key[i] = (s[i] + s[i]) + bc[2 * (i >> 2) + (i & 1)];
#pragma unroll
      for (int w = 1; w < 32; w <<= 1) {
        if (w == 2) continue;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i & w) || (i & ((w << 1) - 1) & ~w & ~2)) continue;  // i the lowest of its group at this level
          key[i] = fmaxf(key[i], key[i | w]);  // NaN left out
        }
      }
      topk_keep4(key0, key[0]);
      topk_keep4(key1, key[2]);
      if (kMode == TOPK_BOTH && t == nt - 1) {  // lse_row, the dustbin folded in as the TPU kernel does
        const float2 lse = corr_lse_row(m0, m1, l0, l1, a.alpha2);
        if (t4 == 0 && r0 < a.M) a.lse_row[rb + r0] = lse.x;
        if (t4 == 0 && r1 < a.M) a.lse_row[rb + r1] = lse.y;
        ar0 = -lse.x * CORR_LOG2E;
        ar1 = -lse.y * CORR_LOG2E;
        // the bars: the L-th largest of the 16 keys of each row's four lanes
        float all0[TOPK_KEYS], all1[TOPK_KEYS];
#pragma unroll
        for (int e = 0; e < TOPK_KEYS; ++e) {
          all0[e] = __shfl_sync(0xffffffffu, key0[e & 3], (lane & ~3) | (e >> 2));
          all1[e] = __shfl_sync(0xffffffffu, key1[e & 3], (lane & ~3) | (e >> 2));
        }
        fb0 = topk_floor(topk_bar(all0, TOPK_KEYS, a.L), ar0, q0);
        fb1 = topk_floor(topk_bar(all1, TOPK_KEYS, a.L), ar1, q1);
      }
    } else {
      // f = ((exp(s - lse_row) exp(s - lse_col)) scr0) scr1, the JAX order,
      // into s: all 32 first, independent of one another, then the stats and
      // the lists read them (one warp an SM partition hides no latency, so
      // no chain waits on an exponential). Bit i of a mask: register i; R0
      // the bits of row r0, the others row r1's.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float u = s[i] * a.c;
        s[i] = ((corr_ex2(u + ((i & 2) ? ar1 : ar0)) * corr_ex2(u + bc[2 * (i >> 2) + (i & 1)])) *
                ((i & 2) ? q1 : q0)) * q[2 * (i >> 2) + (i & 1)];
      }
      constexpr uint32_t R0 = 0x33333333u;
      // ok: scores in the matrix (rows past M, zero-filled, hold garbage)
      uint32_t ok = (r0 < a.M ? R0 : 0u) | (r1 < a.M ? ~R0 : 0u), last = 0u, badm = 0u, nanm = 0u;
      if (j0 + CORR_BN >= a.N) {  // the tile of the last column, maybe ragged
        const uint32_t rows = ok;
        ok = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          ok |= col < a.N ? 1u << i : 0u;
          last |= col == a.N - 1 ? 1u << i : 0u;
        }
        ok &= rows;
      }
      float sum[32], low[32];  // pairwise: the mass and the minimum of each row's 16
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool in = ok >> i & 1;
        badm |= in && !isfinite(s[i]) ? 1u << i : 0u;
        nanm |= in && isnan(s[i]) ? 1u << i : 0u;
        sum[i] = in ? s[i] : 0.f;
        low[i] = in ? s[i] : INFINITY;
      }
      // rows r0 (registers i & 2 == 0) and r1 apart: pair i with i ^ 1, then ^ 4, ^ 8, ^ 16
#pragma unroll
      for (int w = 1; w < 32; w <<= 1) {
        if (w == 2) continue;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i & w) || (i & ((w << 1) - 1) & ~w & ~2)) continue;  // i the lowest of its group at this level
          sum[i] += sum[i | w];
          low[i] = fminf(low[i], low[i | w]);
        }
      }
      mass0 += sum[0];
      mass1 += sum[2];
      mn0 = fminf(mn0, low[0]);
      mn1 = fminf(mn1, low[2]);
      bad0 += __popc(badm & R0);
      bad1 += __popc(badm & ~R0);
      nan0 += __popc(nanm & R0);
      nan1 += __popc(nanm & ~R0);
      last0 += __popc(nanm & last & R0);
      last1 += __popc(nanm & last & ~R0);
#ifndef MK_ABLATE_SELECT
      // a score not below its row's floor goes into this thread's list while
      // it has room, else its bit in ovf marks it for topk_replace below
      uint32_t ovf = 0;
      const float cut0 = fb0 > -INFINITY ? fb0 : -3.40282347e38f, cut1 = fb1 > -INFINITY ? fb1 : -3.40282347e38f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool second = i & 2;
        const bool pass = (ok >> i & 1) && s[i] >= (second ? cut1 : cut0);  // never NaN nor -inf
        int& n = second ? n1 : n0;
        const bool room = n < a.L;
        if (pass && room)
          (second ? lst1 : lst0)[(n + lane) & (TOPK_MAX_L - 1)] =
              make_int2(__float_as_int(s[i]), j0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
        n += pass && room;
        ovf |= pass && !room ? 1u << i : 0u;
      }
#endif
#ifndef MK_ABLATE_SELECT
      if (__any_sync(0xffffffffu, ovf != 0)) {  // rare: a full list; f read back by index
        float fv[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) fv[i] = s[i];
#pragma unroll 1
        for (int i = 0; i < 32; ++i) {
          if (ovf & (1u << i))
            topk_replace((i & 2) ? lst1 : lst0, a.L, lane, fv[i], j0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
        }
      }
#endif
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && !CORR_ABLATE_LOADS && t + CORR_STAGES < total) load_stage(t + CORR_STAGES);
  }

  if constexpr (kMode == TOPK_SWEEP1) {  // the chunk's partial logsumexps and keys
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const long long at = (static_cast<long long>(b) * gridDim.y + blockIdx.y) * a.M;
    if (t4 == 0 && r0 < a.M) a.lse_part[at + r0] = make_float2(corr_shift(m0), l0);
    if (t4 == 0 && r1 < a.M) a.lse_part[at + r1] = make_float2(corr_shift(m1), l1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (r0 < a.M) a.keys[(at + r0) * TOPK_KEYS + 4 * t4 + k] = key0[k];
      if (r1 < a.M) a.keys[(at + r1) * TOPK_KEYS + 4 * t4 + k] = key1[k];
    }
  } else {
    // NaN-propagating minima, as torch.amin; the flags of a NaN before the
    // last column (this thread's NaN other than its last column's) and in it
    const int flag0 = (nan0 > last0 ? TOPK_NAN_OTHER : 0) | (last0 ? TOPK_NAN_LAST : 0);
    const int flag1 = (nan1 > last1 ? TOPK_NAN_OTHER : 0) | (last1 ? TOPK_NAN_LAST : 0);
    topk_finish(a, lists, warp, g, t4, r0, r1, n0, n1, mass0, mass1, static_cast<float>(bad0),
                static_cast<float>(bad1), nan0 ? NAN : mn0, nan1 ? NAN : mn1, flag0, flag1, kMode == TOPK_BOTH);
  }
}

// A split launch's lse_row and bars from TOPK_SWEEP1's partials, one warp
// a row. lse_row as corr_lse_row gives it, the chunks folded in order with
// the dustbin (alpha2 = alpha log2 e): a chunk's sum is +inf only where it
// holds a +inf score, then NaN, as the TPU kernel's row max gives (exp(inf
// - inf)); a chunk of -inf scores only (sum 0) takes no part. The bar: the
// L-th largest of the chunks' keys (each lane ranks two of the up to 64).
__global__ void topk_combine_kernel(const float2* __restrict__ part, const float* __restrict__ keys,
                                    float* __restrict__ lse_row, float* __restrict__ bar, int B, int chunks, int M,
                                    int L, float alpha2) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (e >= B * M) return;  // warp-uniform
  const long long at0 = static_cast<long long>(e / M) * chunks * M + e % M;  // chunk k at at0 + k M
  const int n = chunks * TOPK_KEYS;
  auto key = [&](int k) {
    return k < n ? keys[(at0 + static_cast<long long>(k / TOPK_KEYS) * M) * TOPK_KEYS + k % TOPK_KEYS] : -INFINITY;
  };
  const float k0 = key(lane), k1 = key(lane + 32);
  int c0 = 0, c1 = 0;  // how many keys are at or above k0, k1
  for (int j = 0; j < 32; ++j) {
    const float o0 = __shfl_sync(0xffffffffu, k0, j), o1 = __shfl_sync(0xffffffffu, k1, j);
    c0 += (o0 >= k0) + (o1 >= k0);
    c1 += (o0 >= k1) + (o1 >= k1);
  }
  float b = fmaxf(c0 >= L ? k0 : -INFINITY, c1 >= L ? k1 : -INFINITY);
  for (int o = 16; o > 0; o >>= 1) b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  if (lane != 0) return;
  bar[e] = b;
  float top = -INFINITY;
  for (int k = 0; k < chunks; ++k) {
    const float2 v = part[at0 + static_cast<long long>(k) * M];
    if (v.y != 0.f) top = fmaxf(top, v.x);
  }
  const float rm = fmaxf(top, alpha2);
  float tot = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float2 v = part[at0 + static_cast<long long>(k) * M];
    if (v.y != 0.f) tot += v.y * exp2f(v.x - rm);
  }
  lse_row[e] = isinf(tot) ? NAN : (log2f(tot + exp2f(alpha2 - rm)) + rm) * CORR_LN2;
}

// A split launch's outputs from TOPK_SWEEP2's partials, one warp a row: the
// stats summed in chunk order (NaN-propagating minimum, flags or-ed), then
// every entry of the chunks' lists (two a lane, of the up to 64) ranked among
// them, into its round as topk_finish places them, and the rounds' rules for
// the rest.
__global__ void topk_merge_kernel(const int2* __restrict__ plist, const float4* __restrict__ pstat,
                                  float* __restrict__ vals, int* __restrict__ idxs, float* __restrict__ stats, int B,
                                  int chunks, int M, int N, int L) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (e >= B * M) return;  // warp-uniform
  const int b = e / M, row = e % M;
  const long long at0 = static_cast<long long>(b) * chunks * M + row;  // chunk k at at0 + k M
  int flags = 0;
  for (int k = 0; k < chunks; ++k) flags |= __float_as_int(pstat[at0 + static_cast<long long>(k) * M].w);
  if (lane == 0) {
    float mass = 0.f, bad = 0.f, mn = INFINITY;
    for (int k = 0; k < chunks; ++k) {
      const float4 p = pstat[at0 + static_cast<long long>(k) * M];
      mass += p.x;
      bad += p.y;
      mn = nan_min(mn, p.z);
    }
    float* st = stats + static_cast<long long>(e) * 3;
    st[0] = mass;
    st[1] = bad;
    st[2] = mn;
  }
  auto entry = [&](int k) {  // entry k of the chunks' lists: chunk k / L, place k % L
    return k < chunks * L ? plist[(at0 + static_cast<long long>(k / L) * M) * L + k % L]
                          : make_int2(__float_as_int(-INFINITY), TOPK_NONE);
  };
  const int2 e0 = entry(lane), e1 = entry(lane + 32);
  int r0 = 0, r1 = 0;  // how many entries beat e0, e1
  for (int j = 0; j < 32; ++j) {
    const int2 o0 = make_int2(__shfl_sync(0xffffffffu, e0.x, j), __shfl_sync(0xffffffffu, e0.y, j));
    const int2 o1 = make_int2(__shfl_sync(0xffffffffu, e1.x, j), __shfl_sync(0xffffffffu, e1.y, j));
    r0 += topk_beats(__int_as_float(o0.x), o0.y, __int_as_float(e0.x), e0.y) +
          topk_beats(__int_as_float(o1.x), o1.y, __int_as_float(e0.x), e0.y);
    r1 += topk_beats(__int_as_float(o0.x), o0.y, __int_as_float(e1.x), e1.y) +
          topk_beats(__int_as_float(o1.x), o1.y, __int_as_float(e1.x), e1.y);
  }
  const int listed = min(__popc(__ballot_sync(0xffffffffu, e0.y != TOPK_NONE)) +
                             __popc(__ballot_sync(0xffffffffu, e1.y != TOPK_NONE)), L);
  const int shift = flags & TOPK_NAN_LAST ? 1 : 0;
  auto put = [&](int l, float v, int j) {
    const long long o = (static_cast<long long>(b) * L + l) * M + row;
    vals[o] = v;
    idxs[o] = row * N + j;
  };
  if (!(flags & TOPK_NAN_OTHER)) {
    if (e0.y != TOPK_NONE && r0 + shift < L) put(r0 + shift, fmaxf(__int_as_float(e0.x), 0.f), e0.y);
    if (e1.y != TOPK_NONE && r1 + shift < L) put(r1 + shift, fmaxf(__int_as_float(e1.x), 0.f), e1.y);
  }
  if (lane < L) {
    if ((flags & TOPK_NAN_OTHER) || lane < shift) {
      put(lane, NAN, N - 1);
    } else if (lane >= listed + shift) {
      put(lane, 0.f, 0);
    }
  }
}

}  // namespace

namespace {

// K2a in mode Op: corr_launch, then the fixed-order combine of the chunks'
// partials, which follow the prepared descriptors in scratch.
template <class Op>
int col_lse_launch(const void* d0, const void* d1, void* lse_col, void* scratch, const long long* geom, int B, int M,
                   int N, int C, int chunks, float inv_temp, float alpha, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  float2* part = reinterpret_cast<float2*>(sc + Op::scratch_floats(B, M, N));
  int rc = corr_launch<false, Op>(d0, d1, sc, geom, B, M, N, C, chunks, inv_temp, alpha, part, nullptr, nullptr,
                                  nullptr, st);
  if (rc != 0) return rc;
  col_lse_combine_kernel<<<(B * N + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(lse_col), B, chunks, N,
                                                                alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d0 (B, M, C), d1 (B, N, C) fp32, C <= 128 -> lse_col (B, N). scratch:
// corr_split_floats(B, M, N) floats of split descriptors (corr_launch), then
// the partials, B x chunks x N float2; chunks: how many chunks of dsc0's rows
// (ops/fused_matcher.py::col_lse_chunks); geom: the maps of dsc1's split
// (own) then dsc0's.
extern "C" int mk_col_lse_f32(const void* d0, const void* d1, void* lse_col, void* scratch, const long long* geom,
                              int B, int M, int N, int C, int chunks, float inv_temp, float alpha, void* stream) {
  return col_lse_launch<CorrTf32>(d0, d1, lse_col, scratch, geom, B, M, N, C, chunks, inv_temp, alpha, stream);
}

// mk_col_lse_f32 on bf16 descriptors (the engine's bf16 mode): scratch holds
// their [row][128] bf16 copy, (B M + B N) 64 floats, then the partials; geom
// the bf16 maps (span 64).
extern "C" int mk_col_lse_bf16(const void* d0, const void* d1, void* lse_col, void* scratch, const long long* geom,
                               int B, int M, int N, int C, int chunks, float inv_temp, float alpha, void* stream) {
  return col_lse_launch<CorrBf16>(d0, d1, lse_col, scratch, geom, B, M, N, C, chunks, inv_temp, alpha, stream);
}

// A split launch's work buffer, in floats from its start: per (b, chunk,
// row) a float4 of stats (pstat, at 0), a float2 of lse_row partials, 16
// keys and L int2 list entries, then per (b, row) a bar. Every part starts
// at a multiple of its type's size (the buffer at 16 bytes).
struct TopkWork {
  long long lse_part, keys, plist, bar, end;
};

static TopkWork topk_work(int B, int M, int L, int chunks) {
  const long long parts = static_cast<long long>(B) * chunks * M;
  TopkWork w;
  w.lse_part = 4 * parts;
  w.keys = w.lse_part + 2 * parts;
  w.plist = w.keys + TOPK_KEYS * parts;
  w.bar = w.plist + 2 * L * parts;
  w.end = w.bar + static_cast<long long>(B) * M;
  return w;
}

namespace {

// K2b in mode Op (mk_pair_topk_f32's arguments).
template <class Op>
int pair_topk_launch(const void* d0, const void* d1, const void* scr0, const void* scr1, const void* lse_col,
                     void* vals, void* idxs, void* stats, void* lse_row, void* split, void* work,
                     const long long* geom, int B, int M, int N, int C, int L, int chunks, float inv_temp, float alpha,
                     int do_split, void* stream) {
  const int tiles = (N + CORR_BN - 1) / CORR_BN, per = chunks < 1 ? 0 : (tiles + chunks - 1) / chunks;
  if (split == nullptr || B < 1 || M < 1 || N < 1 || C < 1 || C > CORR_C || L < 1 || L > TOPK_MAX_L || chunks < 1 ||
      chunks > TOPK_MAX_CHUNKS || (chunks > 1 && work == nullptr) || (chunks - 1) * per >= tiles ||
      !corr_geometry_ok(geom, B, M, CORR_BM, Op::kSpan) || !corr_geometry_ok(geom + 14, B, N, CORR_BN, Op::kSpan))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(split);
  int rc = do_split ? Op::prep(d0, d1, sc, B, M, N, C, st) : 0;
  CorrMaps maps = {};
  if (rc == 0) rc = Op::encode(&maps.own_hi, &maps.own_lo, sc, 0, B, M, N, geom);
  if (rc == 0) rc = Op::encode(&maps.oth_hi, &maps.oth_lo, sc, 1, B, M, N, geom + 14);
  if (rc != 0) return rc;
  TopkArgs a = {};
  a.M = M;
  a.N = N;
  a.L = L;
  a.per = per;
  a.c = inv_temp * CORR_LOG2E;
  a.alpha2 = alpha * CORR_LOG2E;
  a.scr0 = static_cast<const float*>(scr0);
  a.scr1 = static_cast<const float*>(scr1);
  a.lse_col = static_cast<const float*>(lse_col);
  a.lse_row = static_cast<float*>(lse_row);
  a.vals = static_cast<float*>(vals);
  a.idxs = static_cast<int*>(idxs);
  a.stats = static_cast<float*>(stats);
  constexpr size_t smem = topk_smem<Op>();
  const dim3 grid((M + CORR_BM - 1) / CORR_BM, chunks, B);
  // per launch: the attributes belong to the current device
  if (chunks == 1) {
    const cudaError_t e = cudaFuncSetAttribute(topk_kernel<TOPK_BOTH, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    topk_kernel<TOPK_BOTH, Op><<<grid, CORR_NT, smem, st>>>(maps, a);
    return static_cast<int>(cudaGetLastError());
  }
  const TopkWork w = topk_work(B, M, L, chunks);
  float* wk = static_cast<float*>(work);
  a.pstat = reinterpret_cast<float4*>(wk);
  a.lse_part = reinterpret_cast<float2*>(wk + w.lse_part);
  a.keys = wk + w.keys;
  a.plist = reinterpret_cast<int2*>(wk + w.plist);
  a.bar = wk + w.bar;
  cudaError_t e = cudaFuncSetAttribute(topk_kernel<TOPK_SWEEP1, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(topk_kernel<TOPK_SWEEP2, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_kernel<TOPK_SWEEP1, Op><<<grid, CORR_NT, smem, st>>>(maps, a);
  topk_combine_kernel<<<(B * M + 3) / 4, 128, 0, st>>>(a.lse_part, a.keys, a.lse_row, a.bar, B, chunks, M, L,
                                                       a.alpha2);
  topk_kernel<TOPK_SWEEP2, Op><<<grid, CORR_NT, smem, st>>>(maps, a);
  topk_merge_kernel<<<(B * M + 3) / 4, 128, 0, st>>>(a.plist, a.pstat, a.vals, a.idxs, a.stats, B, chunks, M, N,
                                                     L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d0 (B, M, C), d1 (B, N, C) fp32, C <= 128; scr0 (B, M), scr1 (B, N),
// lse_col (B, N) from col_lse -> vals, idxs (B, L, M), stats (B, M, 3),
// lse_row (B, M); L <= 16. split: corr_split_floats(B, M, N) floats,
// written here with do_split, else holding these descriptors' split
// (col_lse's scratch); geom: the maps of dsc0's split (own) then dsc1's;
// chunks: how many chunks of dsc1's column tiles (at most TOPK_MAX_CHUNKS, each the same
// whole number of tiles, none empty: ops/fused_matcher.py::pair_topk_chunks);
// work (chunks > 1): mk_pair_topk_work_floats(B, M, L, chunks) floats, laid
// out by topk_work.
extern "C" int mk_pair_topk_f32(const void* d0, const void* d1, const void* scr0, const void* scr1,
                                const void* lse_col, void* vals, void* idxs, void* stats, void* lse_row, void* split,
                                void* work, const long long* geom, int B, int M, int N, int C, int L, int chunks,
                                float inv_temp, float alpha, int do_split, void* stream) {
  return pair_topk_launch<CorrTf32>(d0, d1, scr0, scr1, lse_col, vals, idxs, stats, lse_row, split, work, geom, B, M,
                                    N, C, L, chunks, inv_temp, alpha, do_split, stream);
}

// mk_pair_topk_f32 on bf16 descriptors (the engine's bf16 mode): split holds
// or receives their [row][128] bf16 copy (mk_col_lse_bf16's scratch), geom
// the bf16 maps.
extern "C" int mk_pair_topk_bf16(const void* d0, const void* d1, const void* scr0, const void* scr1,
                                 const void* lse_col, void* vals, void* idxs, void* stats, void* lse_row, void* split,
                                 void* work, const long long* geom, int B, int M, int N, int C, int L, int chunks,
                                 float inv_temp, float alpha, int do_split, void* stream) {
  return pair_topk_launch<CorrBf16>(d0, d1, scr0, scr1, lse_col, vals, idxs, stats, lse_row, split, work, geom, B, M,
                                    N, C, L, chunks, inv_temp, alpha, do_split, stream);
}

// The limits of mk_pair_topk_f32 / _bf16 and the size of their work buffer, for its
// wrapper (ops/fused_matcher.py): the most L and column chunks it takes, and
// the floats a launch in `chunks` > 1 chunks needs (0 for one chunk, -1
// outside the limits).
extern "C" int mk_pair_topk_max_l() { return TOPK_MAX_L; }
extern "C" int mk_pair_topk_max_chunks() { return TOPK_MAX_CHUNKS; }
extern "C" long long mk_pair_topk_work_floats(int B, int M, int L, int chunks) {
  if (B < 1 || M < 1 || L < 1 || L > TOPK_MAX_L || chunks < 1 || chunks > TOPK_MAX_CHUNKS) return -1;
  return chunks == 1 ? 0 : topk_work(B, M, L, chunks).end;
}
