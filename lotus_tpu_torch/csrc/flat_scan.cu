// K2: the Flat store's streaming scan for Hopper (sm_90a).
//
// Replaces lotus_tpu/ops/pallas_flat.py::_scan_kernel (launched by
// _flat_pallas_impl).  ops/flat_scan.py::scan_fold is its wrapper and
// scan_fold_reference its plain PyTorch version.
//
// What it computes.  For every query q and lane l in [0, 128), the best two
// scores, with their rows, among the rows r < n_valid with r mod 128 == l
// (the global row, so the result does not depend on any tile size):
//   s = dot(q, x_r), then s * scale_r (scales given), then s + bias[r / blk][q]
//   (bias given), and MASK_SCORE where row_mask[r] == 0 (mask given).
// The dot is
//   int8 x int8 -> int32 (__dp4a, exact), then __int2float_rn   (int8 queries, int8 store)
//   bf16 x bf16 -> f32 sums (FMA)                                 (everything else)
// where int8 rows convert to bf16 exactly and f32 rows round to bf16
// (__float2bfloat16_rn), as the reference casts the store to the queries'
// type.  The multiply and the add use __fmul_rn / __fadd_rn, so no FMA
// contraction changes the last bit.  The top-2 is ordered by (score desc,
// row asc): a strict '>' over the rows in ascending order, so ties go to the
// earlier row and masked rows never enter; their lanes keep (MASK_SCORE, -1).
// Output: best and second in columns 0..127 and 128..255 of (B, 256) f32 and
// int32 planes.
//
// The TPU kernel walks every row in order for each 256-query tile, the
// running top-2 in VMEM: B / 256 programs, 16 at B = 4096 for 132 SMs.  Here
// the grid is (64-query tiles) x (row splits), with the splits chosen by
// lotus_flat_scan_plan so that the grid fills the SMs.  Each block folds its
// split (whole 128-row slices) into a top-2 per (query, lane) held in
// registers and writes it as a partial; merge_kernel folds the partials
// split by split in row order under the same rule.  So the result is the sequential fold's, bit for
// bit, whatever the schedule (no atomics).
//
// What bounds it on this card.  The work is B * N * d MACs (3.3e12 at
// 2^20 x 768 and B = 4096) on the CUDA cores: f32 FMAs for bf16 operands,
// dp4a for int8.  The store is streamed once per 64-query tile, but the
// query tile is the fastest grid index, so the blocks that share a split run
// together and most of those reads are L2 hits; HBM sees the store about
// once per wave.  The simple design keeps the depth tiled (32 floats or 128
// int8 values) in padded shared memory, so that both operand reads are bank
// conflict free, and gives each thread an 8 x 4 register tile (12 shared
// loads per 32 FMAs or dp4a).  Each thread issues all 24 global loads of a
// tile before it stores any, so a tile waits for one memory latency.  A
// ragged row tail and a depth that is not a multiple of 4 or of the tile are
// zero-filled in shared memory.  A thread holds 32 sums and a 128-value
// fold state (over 200 registers), so one block fits on an SM and that one
// latency per tile is not hidden by another block.  Tensor cores (wgmma),
// TMA and double buffering are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NL = 128;       // lanes: lane = row mod 128
constexpr int QB = 64;        // queries per block
constexpr int THREADS = 256;
constexpr int TQ = 8;         // queries per thread: tq + 8 i
constexpr int TL = 4;         // lanes per thread: tl + 32 m
constexpr int KT = 32;        // 32-bit words (int8: 128 values) or floats per depth tile
constexpr int LD = KT + 1;    // padded row stride in shared memory
constexpr int FILL = (QB + NL) * KT / THREADS;  // shared words each thread fills per tile
static_assert(THREADS == 8 * KT && QB % 8 == 0 && NL % 8 == 0, "fill layout: rows tq + 8 j, word tl");
constexpr float MASK_SCORE = -3.0e38f;
constexpr int NO_HIT = -1;

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

// Operand values as the reference's dot sees them: bf16 queries, and rows
// cast to bf16 (exact for int8, round to nearest even for f32).
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Four int8 values at depth 4 * kw .. 4 * kw + 3 of a d-long row, zero past d.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int kw, int d, bool aligned) {
  if (aligned) return 4 * kw < d ? *reinterpret_cast<const uint32_t*>(row + 4 * kw) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * kw + j;
    if (k < d) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[k])) << (8 * j);
  }
  return v;
}

// Keep the top-2 of (best, sec) under (score desc, row asc) when (s, id)
// comes after both in row order.
__device__ __forceinline__ void fold(float s, int id, float& best, int& best_i, float& sec,
                                     int& sec_i) {
  if (s > best) {
    sec = best;
    sec_i = best_i;
    best = s;
    best_i = id;
  } else if (s > sec) {
    sec = s;
    sec_i = id;
  }
}

template <typename QT, typename XT, bool INT8_DOT>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(
    const QT* __restrict__ xq, const XT* __restrict__ xb, const float* __restrict__ scales,
    const float* __restrict__ bias, const int8_t* __restrict__ row_mask,
    float* __restrict__ part_s, int* __restrict__ part_i, int b, int d, int n_scan,
    int rows_per_split, int blk) {
  using Acc = std::conditional_t<INT8_DOT, int, float>;
  __shared__ __align__(16) uint32_t smem[(QB + NL) * LD];
  const int tid = threadIdx.x;
  const int tl = tid & 31;
  const int tq = tid >> 5;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const long start = (long)split * rows_per_split;
  const long end = start + rows_per_split < n_scan ? start + rows_per_split : (long)n_scan;
  const bool aligned = INT8_DOT && d % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(xb)) % 4 == 0;
  const int dk = INT8_DOT ? (d + 3) / 4 : d;  // depth in shared-memory words

  float best[TQ][TL], sec[TQ][TL];
  int best_i[TQ][TL], sec_i[TQ][TL];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      best[i][m] = MASK_SCORE;
      sec[i][m] = MASK_SCORE;
      best_i[i][m] = NO_HIT;
      sec_i[i][m] = NO_HIT;
    }

  for (long row0 = start; row0 < end; row0 += NL) {
    Acc acc[TQ][TL];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int m = 0; m < TL; ++m) acc[i][m] = 0;

    for (int k0 = 0; k0 < dk; k0 += KT) {
      // Fill the depth tile: thread (tq, tl) takes depth word k0 + tl of
      // shared rows tq + 8 j, the QB query rows first, then the NL store
      // rows.  Every load of the tile is issued before the first store, so
      // the tile waits for one memory latency, not FILL of them.
      const int k = k0 + tl;
      uint32_t stage[FILL];
#pragma unroll
      for (int j = 0; j < FILL; ++j) {
        const bool is_q = j < QB / 8;
        const long src = is_q ? (long)q0 + tq + 8 * j : row0 + tq + 8 * (j - QB / 8);
        const bool live = k < dk && (is_q ? src < b : src < end);
        if constexpr (INT8_DOT) {
          const int8_t* p = is_q ? reinterpret_cast<const int8_t*>(xq) + src * d
                                 : reinterpret_cast<const int8_t*>(xb) + src * d;
          stage[j] = live ? load_word(p, k, d, aligned) : 0u;
        } else {
          float v = 0.f;
          if (live) v = is_q ? to_f(xq[src * d + k]) : to_f(xb[src * d + k]);
          stage[j] = __float_as_uint(v);
        }
      }
#pragma unroll
      for (int j = 0; j < FILL; ++j) smem[(tq + 8 * j) * LD + tl] = stage[j];
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < KT; ++cc) {
        if constexpr (INT8_DOT) {
          const int* s = reinterpret_cast<const int*>(smem);
          int a[TQ], bv[TL];
#pragma unroll
          for (int i = 0; i < TQ; ++i) a[i] = s[(tq + 8 * i) * LD + cc];
#pragma unroll
          for (int m = 0; m < TL; ++m) bv[m] = s[(QB + tl + 32 * m) * LD + cc];
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int m = 0; m < TL; ++m) acc[i][m] = __dp4a(a[i], bv[m], acc[i][m]);
        } else {
          const float* s = reinterpret_cast<const float*>(smem);
          float a[TQ], bv[TL];
#pragma unroll
          for (int i = 0; i < TQ; ++i) a[i] = s[(tq + 8 * i) * LD + cc];
#pragma unroll
          for (int m = 0; m < TL; ++m) bv[m] = s[(QB + tl + 32 * m) * LD + cc];
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int m = 0; m < TL; ++m) acc[i][m] = fmaf(a[i], bv[m], acc[i][m]);
        }
      }
      __syncthreads();
    }

    // Epilogue: scale, bias, mask, fold.  A 128-row slice lies inside one
    // bias block (blk is a multiple of 128 and slices start at multiples of 128).
    float bq[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int q = q0 + tq + 8 * i;
      bq[i] = bias != nullptr && q < b ? bias[(row0 / blk) * b + q] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      const long row = row0 + tl + 32 * m;
      const bool ok = row < end && (row_mask == nullptr || row_mask[row] != 0);
      const float sc = scales != nullptr && row < end ? scales[row] : 1.f;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float v;
        if constexpr (INT8_DOT) v = __int2float_rn(acc[i][m]);
        else v = acc[i][m];
        if (scales != nullptr) v = __fmul_rn(v, sc);
        if (bias != nullptr) v = __fadd_rn(v, bq[i]);
        // A masked row scores MASK_SCORE, which never passes the strict '>'.
        fold(ok ? v : MASK_SCORE, static_cast<int>(row), best[i][m], best_i[i][m], sec[i][m],
             sec_i[i][m]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = q0 + tq + 8 * i;
    if (q >= b) continue;
    const long o = ((long)split * b + q) * (2 * NL);
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      const int lane = tl + 32 * m;
      part_s[o + lane] = best[i][m];
      part_s[o + NL + lane] = sec[i][m];
      part_i[o + lane] = best_i[i][m];
      part_i[o + NL + lane] = sec_i[i][m];
    }
  }
}

// Folds the (splits, B, 256) partials, split 0 first, into (B, 256).  Split
// s holds only rows before those of split s + 1, so the top-2 of two
// consecutive ranges is: the later best wins only when strictly greater, and
// the second is the earlier candidate unless the later one is strictly
// greater.
__global__ void merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                             float* __restrict__ out_s, int* __restrict__ out_i, int splits,
                             int b) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)b * NL) return;
  const long q = idx / NL;
  const int lane = static_cast<int>(idx % NL);
  float best = MASK_SCORE, sec = MASK_SCORE;
  int best_i = NO_HIT, sec_i = NO_HIT;
  for (int s = 0; s < splits; ++s) {
    const long o = ((long)s * b + q) * (2 * NL) + lane;
    const float nb = part_s[o], ns = part_s[o + NL];
    const int nbi = part_i[o], nsi = part_i[o + NL];
    if (nb > best) {
      if (!(best >= ns)) {
        sec = ns;
        sec_i = nsi;
      } else {
        sec = best;
        sec_i = best_i;
      }
      best = nb;
      best_i = nbi;
    } else if (nb > sec) {
      sec = nb;
      sec_i = nbi;
    }
  }
  const long o = q * (2 * NL) + lane;
  out_s[o] = best;
  out_s[o + NL] = sec;
  out_i[o] = best_i;
  out_i[o + NL] = sec_i;
}

template <typename QT, typename XT, bool INT8_DOT>
int launch(const void* xq, const void* xb, const void* scales, const void* bias,
           const void* row_mask, void* part_s, void* part_i, int b, int d, int n_scan,
           int splits, int rows_per_split, int blk, cudaStream_t stream) {
  const dim3 grid((b + QB - 1) / QB, splits);
  scan_kernel<QT, XT, INT8_DOT><<<grid, THREADS, 0, stream>>>(
      static_cast<const QT*>(xq), static_cast<const XT*>(xb), static_cast<const float*>(scales),
      static_cast<const float*>(bias), static_cast<const int8_t*>(row_mask),
      static_cast<float*>(part_s), static_cast<int*>(part_i), b, d, n_scan, rows_per_split, blk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 (scan, then merge) on `stream` and returns cudaGetLastError()
// (0 on success).  q_dtype / x_dtype: 0 = f32, 1 = bf16, 2 = int8.  Pairs:
// (int8, int8) with the dp4a dot; (bf16, int8), (bf16, bf16), (bf16, f32).
// scales, bias and row_mask may be null.  part_s / part_i hold
// splits * b * 256 values; rows_per_split and blk are multiples of 128.
int lotus_flat_scan(const void* xq, const void* xb, const void* scales, const void* bias,
                    const void* row_mask, void* part_s, void* part_i, void* out_s, void* out_i,
                    int b, int d, int n_scan, int splits, int rows_per_split, int blk,
                    int q_dtype, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return 0;
  if (splits <= 0 || rows_per_split <= 0 || rows_per_split % NL != 0 || blk <= 0 || blk % NL != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int code;
  if (q_dtype == I8 && x_dtype == I8)
    code = launch<int8_t, int8_t, true>(xq, xb, scales, bias, row_mask, part_s, part_i, b, d,
                                        n_scan, splits, rows_per_split, blk, s);
  else if (q_dtype == BF16 && x_dtype == I8)
    code = launch<__nv_bfloat16, int8_t, false>(xq, xb, scales, bias, row_mask, part_s, part_i,
                                                b, d, n_scan, splits, rows_per_split, blk, s);
  else if (q_dtype == BF16 && x_dtype == BF16)
    code = launch<__nv_bfloat16, __nv_bfloat16, false>(xq, xb, scales, bias, row_mask, part_s,
                                                       part_i, b, d, n_scan, splits,
                                                       rows_per_split, blk, s);
  else if (q_dtype == BF16 && x_dtype == F32)
    code = launch<__nv_bfloat16, float, false>(xq, xb, scales, bias, row_mask, part_s, part_i, b,
                                               d, n_scan, splits, rows_per_split, blk, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (code != 0) return code;
  const long cells = (long)b * NL;
  merge_kernel<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), splits, b);
  return static_cast<int>(cudaGetLastError());
}

// K2's grid for b queries over n_scan rows on a card of `sms` SMs: the
// number of row splits and the rows of each (whole 128-row slices).  One
// scan block is resident per SM (over 200 registers a thread), so the grid
// covers at least two waves of `sms` blocks; among up to twice that many
// splits it takes the one whose last wave is fullest (the fewest on a tie).
void lotus_flat_scan_plan(int b, int n_scan, int sms, int* splits, int* rows_per_split) {
  const long qtiles = (b + QB - 1) / QB > 0 ? (b + QB - 1) / QB : 1;
  const long slots = sms > 0 ? sms : 1;
  const long slices = n_scan > NL ? (n_scan + NL - 1) / NL : 1;
  const long want = (2 * slots + qtiles - 1) / qtiles;
  const long lo = want < slices ? want : slices;
  const long hi = 2 * lo < slices ? 2 * lo : slices;
  long pick = lo;
  double pick_fill = -1.0;
  for (long s = lo; s <= hi; ++s) {
    const long blocks = qtiles * s;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > pick_fill) {
      pick_fill = fill;
      pick = s;
    }
  }
  const long per_split = (slices + pick - 1) / pick;
  *splits = static_cast<int>((slices + per_split - 1) / per_split);
  *rows_per_split = static_cast<int>(per_split * NL);
}

}  // extern "C"
