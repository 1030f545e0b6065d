// K1: the grouped IVF probe kernel for Hopper (sm_90a).
//
// Replaces lotus_tpu/ops/pallas_ivf.py::_probe_kernel (with its folds
// _bucket_pack_accum and _bucket_top2_accum and the mask _slice_mask).
// ops/ivf_probe.py::probe_fold is its wrapper and probe_fold_reference its
// plain PyTorch version.
//
// What it computes.  One thread block owns one (probed list, chunk of
// QU = 128 query slots) and loops over every bl-row block of the list.  For
// each 64-row slice j of a block it forms the (128 x 64) scores
//   int8 x int8 -> int32 (__dp4a, exact)         when INT8_DOT
//   bf16 or f32 operands -> f32 (FMA)            otherwise
// multiplies them by the row scales (DEQUANT), forms 2*dot - |x|^2 (L2),
// masks columns at or past the list's live row count, and folds them into a
// top-2 per (query slot, lane): lane j' of a list holds its rows
// {j' + 64 i}.  PACKED writes the window-local row id into the low 13
// mantissa bits and folds with fmaxf/fminf on the floats (negative floats
// order the other way as integers); the unpacked fold keeps (score, global
// storage row) pairs with a strict '>' in slice order, so ties go to the
// earlier row.  Output: (grid, 128, 128) f32 [+ int32], best in columns
// 0..63 and second in 64..127; blocks whose chunk table entry is -1 write
// MASK_SCORE and exit.
//
// The TPU version needs a sequential grid so that one chunk's output stays
// resident across units; that is why it carries a 'first' flag, a packed
// SMEM scalar table and parked units.  Here the fold state of a whole list
// lives in registers for the block's lifetime, and none of the three exist.
//
// What bounds it on this card.  Each probed list is streamed once per
// 128-pair chunk, so at the config-4 shape (int8 store, int8 queries,
// d = 768) the work is int8 MACs against the dp4a rate of the CUDA cores,
// with the list bytes coming from HBM and L2.  The simple design keeps the
// depth tiled (128 int8 or 32 float values per tile) in padded shared
// memory so that both operand reads are bank-conflict free, gives each
// thread an 8 x 4 register tile (12 shared loads per 32 dp4a), and skips
// slices that lie wholly in a list's padding tail.  Tensor cores (wgmma or
// mma.sync), TMA and double buffering are left to later work.
//
// Build without --use_fast_math or -ftz=true: a score of exactly +-0 packs
// into a denormal that carries the id.  The epilogue uses __fmul_rn and
// __fsub_rn so the scale multiply and 2*s - |x|^2 round as the reference
// does (no FMA contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QU = 128;       // query slots per chunk
constexpr int NBK = 64;       // candidate lanes (512 / BUCKET)
constexpr int NCAND = 2 * NBK;
constexpr int THREADS = 256;
constexpr int TQ = 8;         // query slots per thread: tq + 16 i
constexpr int TL = 4;         // lanes per thread: tl + 16 m
constexpr int KT = 32;        // 32-bit words (int8: 128 values) or floats per depth tile
constexpr int LD = KT + 1;    // padded row stride in shared memory
constexpr int LOCAL_MASK = (1 << 13) - 1;
constexpr float MASK_SCORE = -3.0e38f;

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename QT, typename XT, bool INT8_DOT, bool DEQUANT, bool L2, bool PACKED>
__global__ void __launch_bounds__(THREADS, 2) probe_kernel(
    const QT* __restrict__ xq, const XT* __restrict__ xb,
    const float* __restrict__ scales, const float* __restrict__ norms,
    const int* __restrict__ chunk_list, const int* __restrict__ list_start,
    const int* __restrict__ list_size, float* __restrict__ out_s, int* __restrict__ out_i,
    int d, int bl) {
  __shared__ __align__(16) uint32_t smem[(QU + NBK) * LD];
  const int tid = threadIdx.x;
  const int tl = tid & 15;
  const int tq = tid >> 4;
  const int c = blockIdx.x;

  float best[TQ][TL], sec[TQ][TL];
  int best_i[TQ][TL], sec_i[TQ][TL];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      best[i][m] = MASK_SCORE;
      sec[i][m] = MASK_SCORE;
      best_i[i][m] = 0;
      sec_i[i][m] = 0;
    }

  const int l = chunk_list[c];
  if (l >= 0) {
    const int start = list_start[l];
    const int size = list_size[l];
    const int nblk = (size + bl - 1) / bl;
    const int bucket = bl / NBK;
    // int8 operands are read as 32-bit words of four values.
    const int dk = INT8_DOT ? d / 4 : d;
    for (int blk = 0; blk < nblk; ++blk) {
      const int vcount = min(size - blk * bl, bl);
      for (int j = 0; j < bucket && j * NBK < vcount; ++j) {
        const long row0 = (long)start + (long)blk * bl + (long)j * NBK;
        int acc_i[TQ][TL];
        float acc_f[TQ][TL];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int m = 0; m < TL; ++m) {
            acc_i[i][m] = 0;
            acc_f[i][m] = 0.f;
          }
        for (int k0 = 0; k0 < dk; k0 += KT) {
          if constexpr (INT8_DOT) {
            const int32_t* qw = reinterpret_cast<const int32_t*>(xq) + (long)c * QU * dk;
            const int32_t* xw = reinterpret_cast<const int32_t*>(xb) + row0 * dk;
            for (int idx = tid; idx < QU * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              smem[r * LD + cc] = k < dk ? static_cast<uint32_t>(qw[(long)r * dk + k]) : 0u;
            }
            for (int idx = tid; idx < NBK * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              smem[(QU + r) * LD + cc] = k < dk ? static_cast<uint32_t>(xw[(long)r * dk + k]) : 0u;
            }
          } else {
            float* fs = reinterpret_cast<float*>(smem);
            const QT* qp = xq + (long)c * QU * d;
            const XT* xp = xb + row0 * d;
            for (int idx = tid; idx < QU * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              fs[r * LD + cc] = k < d ? to_f(qp[(long)r * d + k]) : 0.f;
            }
            for (int idx = tid; idx < NBK * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              fs[(QU + r) * LD + cc] = k < d ? to_f(xp[(long)r * d + k]) : 0.f;
            }
          }
          __syncthreads();
          if constexpr (INT8_DOT) {
            const int* s = reinterpret_cast<const int*>(smem);
#pragma unroll 8
            for (int cc = 0; cc < KT; ++cc) {
              int a[TQ], b[TL];
#pragma unroll
              for (int i = 0; i < TQ; ++i) a[i] = s[(tq + 16 * i) * LD + cc];
#pragma unroll
              for (int m = 0; m < TL; ++m) b[m] = s[(QU + tl + 16 * m) * LD + cc];
#pragma unroll
              for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int m = 0; m < TL; ++m) acc_i[i][m] = __dp4a(a[i], b[m], acc_i[i][m]);
            }
          } else {
            const float* s = reinterpret_cast<const float*>(smem);
#pragma unroll 8
            for (int cc = 0; cc < KT; ++cc) {
              float a[TQ], b[TL];
#pragma unroll
              for (int i = 0; i < TQ; ++i) a[i] = s[(tq + 16 * i) * LD + cc];
#pragma unroll
              for (int m = 0; m < TL; ++m) b[m] = s[(QU + tl + 16 * m) * LD + cc];
#pragma unroll
              for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int m = 0; m < TL; ++m) acc_f[i][m] = fmaf(a[i], b[m], acc_f[i][m]);
            }
          }
          __syncthreads();
        }
        // Epilogue: scale, l2, mask, fold.
#pragma unroll
        for (int m = 0; m < TL; ++m) {
          const int lane = tl + 16 * m;
          const int col = j * NBK + lane;
          const bool ok = col < vcount;
          const long row = row0 + lane;
          const float sc = DEQUANT ? scales[row] : 1.f;
          const float nm = L2 ? norms[row] : 0.f;
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            float v = INT8_DOT ? __int2float_rn(acc_i[i][m]) : acc_f[i][m];
            if (DEQUANT) v = __fmul_rn(v, sc);
            if (L2) v = __fsub_rn(__fmul_rn(2.f, v), nm);
            if constexpr (PACKED) {
              const int local = blk * bl + col;
              const float pk =
                  ok ? __int_as_float((__float_as_int(v) & ~LOCAL_MASK) | local) : MASK_SCORE;
              const float nb = fmaxf(best[i][m], pk);
              sec[i][m] = fmaxf(sec[i][m], fminf(best[i][m], pk));
              best[i][m] = nb;
            } else {
              const float sv = ok ? v : MASK_SCORE;
              const int id = static_cast<int>(row);
              if (sv > best[i][m]) {
                sec[i][m] = best[i][m];
                sec_i[i][m] = best_i[i][m];
                best[i][m] = sv;
                best_i[i][m] = id;
              } else if (sv > sec[i][m]) {
                sec[i][m] = sv;
                sec_i[i][m] = id;
              }
            }
          }
        }
      }
    }
  }

  float* os = out_s + (long)c * QU * NCAND;
  int* oi = PACKED ? nullptr : out_i + (long)c * QU * NCAND;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      const int o = (tq + 16 * i) * NCAND + tl + 16 * m;
      os[o] = best[i][m];
      os[o + NBK] = sec[i][m];
      if constexpr (!PACKED) {
        oi[o] = best_i[i][m];
        oi[o + NBK] = sec_i[i][m];
      }
    }
}

template <typename QT, typename XT, bool INT8_DOT, bool DEQUANT, bool L2, bool PACKED>
void launch(const void* xq, const void* xb, const void* scales, const void* norms,
            const void* chunk_list, const void* list_start, const void* list_size, void* out_s,
            void* out_i, int grid, int d, int bl, cudaStream_t stream) {
  probe_kernel<QT, XT, INT8_DOT, DEQUANT, L2, PACKED><<<grid, THREADS, 0, stream>>>(
      static_cast<const QT*>(xq), static_cast<const XT*>(xb), static_cast<const float*>(scales),
      static_cast<const float*>(norms), static_cast<const int*>(chunk_list),
      static_cast<const int*>(list_start), static_cast<const int*>(list_size),
      static_cast<float*>(out_s), static_cast<int*>(out_i), d, bl);
}

template <typename QT, typename XT, bool INT8_DOT, bool DEQUANT>
int launch_variant(int l2, int packed, const void* xq, const void* xb, const void* scales,
                   const void* norms, const void* chunk_list, const void* list_start,
                   const void* list_size, void* out_s, void* out_i, int grid, int d, int bl,
                   cudaStream_t stream) {
#define LOTUS_LAUNCH(L2V, PKV)                                                                  \
  launch<QT, XT, INT8_DOT, DEQUANT, L2V, PKV>(xq, xb, scales, norms, chunk_list, list_start, \
                                              list_size, out_s, out_i, grid, d, bl, stream)
  if (l2 && packed) LOTUS_LAUNCH(true, true);
  else if (l2) LOTUS_LAUNCH(true, false);
  else if (packed) LOTUS_LAUNCH(false, true);
  else LOTUS_LAUNCH(false, false);
#undef LOTUS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// q_dtype / x_dtype: 0 = f32, 1 = bf16, 2 = int8.  Supported pairs:
// (int8, int8) with int8_dot and no l2; (bf16, int8); (bf16, bf16); (f32, f32).
int lotus_ivf_probe(const void* xq, const void* xb, const void* scales, const void* norms,
                    const void* chunk_list, const void* list_start, const void* list_size,
                    void* out_s, void* out_i, int grid, int d, int bl, int q_dtype, int x_dtype,
                    int int8_dot, int l2, int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid <= 0) return 0;
  if (bl <= 0 || bl % NBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (int8_dot) {
    if (q_dtype != I8 || x_dtype != I8 || l2 || d % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_variant<int8_t, int8_t, true, true>(0, packed, xq, xb, scales, norms, chunk_list,
                                                      list_start, list_size, out_s, out_i, grid,
                                                      d, bl, s);
  }
  if (q_dtype == BF16 && x_dtype == I8)
    return launch_variant<__nv_bfloat16, int8_t, false, true>(l2, packed, xq, xb, scales, norms,
                                                              chunk_list, list_start, list_size,
                                                              out_s, out_i, grid, d, bl, s);
  if (q_dtype == BF16 && x_dtype == BF16)
    return launch_variant<__nv_bfloat16, __nv_bfloat16, false, false>(
        l2, packed, xq, xb, scales, norms, chunk_list, list_start, list_size, out_s, out_i, grid,
        d, bl, s);
  if (q_dtype == F32 && x_dtype == F32)
    return launch_variant<float, float, false, false>(l2, packed, xq, xb, scales, norms,
                                                      chunk_list, list_start, list_size, out_s,
                                                      out_i, grid, d, bl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lotus_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
