// K3: the grouped probe's pool stage for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference runs this stage as XLA ops after
// its probe kernel (lotus_tpu/ops/pallas_ivf.py:558-645: the per-pair gather
// of the kernel output, the packed-id decode, the residual bias and the
// pool's top-k), and the port ran it as about a dozen PyTorch passes over
// the pool.  ops/ivf_probe.py::pool_select is its wrapper and
// pool_select_reference its plain PyTorch version.
//
// What it computes.  For query q, pair (q, j) is row padpos[q * nprobe + j]
// of K1's output (KC = 128 or 64 candidates; a pair whose list holds no
// rows reads MASK_SCORE).  Each candidate becomes a score exactly as the
// plain version forms it: packed candidates drop their 13 id bits; with a
// residual bias, a candidate at or below MASK_SCORE / 2 becomes MASK_SCORE,
// any other is multiplied by the query's int8 scale (when given, __fmul_rn)
// and then gets the pair's bias added (__fadd_rn; never contracted into an
// FMA, which would round once where the plain version rounds twice).  The
// output is the query's k_out best scores in descending order and their
// storage rows: a packed candidate's row is min(list_start + id bits,
// n_rows - 1), an unpacked one's the row K1 wrote beside it.  Scores order
// as their f32 bits do under the usual monotone map to unsigned keys (the
// map torch.topk's radix select uses); among equal scores the candidate
// earlier in the pool (pair, then column) comes first.
//
// What bounds it on this card.  Each candidate is read once: at the config-4
// slice (2,048 queries x 208 pairs x 128 candidates) 218 MB, 0.065 ms at
// 3.35 TB/s, beside a few MB of pair tables.  K1's output (486 MB a slice)
// does not fit the 50 MB L2, so the reads come from device memory, and the
// selection has to cost less than the read.  The design:
// - One block of 256 threads a query.  A warp reads a pair's 512 (or 256)
//   contiguous bytes at 16 bytes a lane, four pairs in flight a lane, forms
//   the scores in registers and keeps only each pair's best key in shared
//   memory.  Pairs of empty lists are not read at all.
// - Selection without staging the pool.  A pair puts at most k_out
//   candidates into its query's head, so the k_out-th best of the pairs'
//   maxima, t, is at most the k_out-th best score (the reference's
//   pre-reduction argument, pallas_ivf.py:569-582).  Only pairs whose
//   maximum beats t can hold a score above t, and there are fewer than
//   k_out of them: their candidates are read again (a second read of about
//   a tenth of the bytes) and those above t are appended to a list in shared
//   memory, which a bitonic sort orders.  Where fewer than k_out scores
//   beat t, the k_out-th score is t itself, and the earliest candidates
//   equal to t fill the head.  Where more beat t than the list holds, t
//   rises to the k_out-th best of the list and the pass repeats; each
//   repeat leaves fewer above t, so it ends.
// - Pools far larger than shared memory (nprobe 1,024 and more) need no
//   tiling: a block's tables hold per pair only its row offset, bias,
//   maximum and place in the list of qualifying pairs, 20 bytes, beside the
//   candidate list of at least 2,048 entries (and of k_out or more).  They
//   sit in shared memory while they fit in 227 KB (nprobe up to about 8,000
//   at k_out 2,048, k_out up to 16,384 at small nprobe); past that each
//   block keeps them in a slice of a device-memory workspace the wrapper
//   allocates, and a grid of as many blocks as the workspace holds loops
//   over the queries.  Those sizes are far from any served shape: the
//   workspace makes them correct, not fast.
// - Launched on PyTorch's stream with no host synchronisation; the wrapper
//   allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // pairs a lane keeps in flight
constexpr int LOCAL_MASK = (1 << 13) - 1;
constexpr float MASK_SCORE = -3.0e38f;
constexpr float MASKED_AT = -1.5e38f;  // MASK_SCORE / 2
constexpr int MIN_CAP = 2048;          // entries of the candidate list, at least
constexpr int MAX_SMEM = 232448 - 1024;  // under the 227 KB a block may opt into, static included
constexpr long long WORK_BUDGET = 256ll << 20;  // device-memory tables of all blocks, at most (but one block's)
constexpr unsigned FULL = 0xffffffffu;

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ int dev_pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// Order-preserving map of f32 bits to unsigned keys, and back.
__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float score_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A list entry: the key above, the pool position's complement below, so one
// descending order puts higher scores first and earlier positions first
// among equal scores.
__device__ __forceinline__ uint64_t entry(uint32_t key, int pos) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~pos);
}

struct Args {
  const float* cand;          // K1's output, (rows, KC) f32
  const int* cand_idx;        // (rows, KC) int32 storage rows, unpacked only
  const long long* padpos;    // (b * nprobe,) row of each pair in cand
  const int* probe_lists;     // (b * nprobe,)
  const int* list_start;      // (nlist,)
  const int* list_size;       // (nlist,), as K1 got it
  const float* bias;          // (b * nprobe,) or null
  const float* qscale;        // (b,) or null; applied only with a bias
  float* out_s;               // (b, k_out)
  int* out_rows;              // (b, k_out)
  unsigned char* work;        // the blocks' tables in device memory, or null: in shared memory
  long long work_stride;      // bytes of one block's tables in work
  int b, nprobe, k_out, n_rows, cap;
};

template <bool PACKED>
__device__ __forceinline__ uint32_t pool_key(float raw, float bias, float qs, bool has_bias, bool has_scale) {
  float s = PACKED ? __int_as_float(__float_as_int(raw) & ~LOCAL_MASK) : raw;
  if (has_bias) {
    const bool masked = s <= MASKED_AT;
    if (has_scale) s = __fmul_rn(s, qs);
    s = masked ? MASK_SCORE : __fadd_rn(s, bias);
  }
  return key_of(s);
}

// Four candidates of a pair from column col; a pair of an empty list
// (off < 0) reads MASK_SCORE without touching memory.
__device__ __forceinline__ float4 load4(const float* cand, long long off, int col) {
  if (off < 0) return make_float4(MASK_SCORE, MASK_SCORE, MASK_SCORE, MASK_SCORE);
  return __ldg(reinterpret_cast<const float4*>(cand + off + col));
}

// Descending bitonic sort of n (a power of two) entries in shared memory by
// the whole block; every thread calls it after the entries are written.
template <typename T>
__device__ void sort_desc(T* x, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = threadIdx.x; c < n / 2; c += THREADS) {
        const int i = ((c & ~(j - 1)) << 1) | (c & (j - 1));
        const int l = i | j;
        const T a = x[i], b = x[l];
        if (((i & k) == 0) ? (a < b) : (a > b)) {
          x[i] = b;
          x[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One query's head: q's pairs through the two passes into `tables` (the
// list, then per pair its row offset, maximum, bias and place among the
// qualifying pairs), sorted, written to out_s / out_rows.
template <int KC, bool PACKED>
__device__ __forceinline__ void select_query(const Args& a, int q, unsigned char* tables) {
  constexpr int LP = KC / 4;    // lanes a pair
  constexpr int PPW = 32 / LP;  // pairs a warp step
  constexpr int STEP = WARPS * PPW;
  __shared__ int n_above, n_qual;

  const int nprobe = a.nprobe, k_out = a.k_out, cap = a.cap;
  uint64_t* list = reinterpret_cast<uint64_t*>(tables);
  long long* off = reinterpret_cast<long long*>(list + cap);
  uint32_t* pmax = reinterpret_cast<uint32_t*>(off + nprobe);
  float* pbias = reinterpret_cast<float*>(pmax + nprobe);
  int* qual = reinterpret_cast<int*>(pbias + nprobe);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_bias = a.bias != nullptr, has_scale = has_bias && a.qscale != nullptr;
  const int sub = lane / LP, col = (lane % LP) * 4;

  const long long base = static_cast<long long>(q) * nprobe;
  const float qs = has_scale ? a.qscale[q] : 1.f;

  // ---- the query's pair table ---------------------------------------------
  for (int j = tid; j < nprobe; j += THREADS) {
    off[j] = a.list_size[a.probe_lists[base + j]] > 0 ? a.padpos[base + j] * KC : -1;
    pbias[j] = has_bias ? a.bias[base + j] : 0.f;
  }
  __syncthreads();

  // ---- pass 1: every pair's best key ----------------------------------------
  for (int j0 = warp * PPW; j0 < nprobe; j0 += STEP * UNROLL) {  // uniform in the warp
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * STEP + sub;
      v[u] = load4(a.cand, j < nprobe ? off[j] : -1, col);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * STEP + sub;
      const float b = j < nprobe ? pbias[j] : 0.f;
      uint32_t m = max(max(pool_key<PACKED>(v[u].x, b, qs, has_bias, has_scale),
                           pool_key<PACKED>(v[u].y, b, qs, has_bias, has_scale)),
                       max(pool_key<PACKED>(v[u].z, b, qs, has_bias, has_scale),
                           pool_key<PACKED>(v[u].w, b, qs, has_bias, has_scale)));
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
      if (j < nprobe && lane % LP == 0) pmax[j] = m;
    }
  }
  __syncthreads();

  // ---- t: the k_out-th best pair maximum (no bound with fewer pairs) ------
  uint32_t t = 0;
  if (nprobe >= k_out) {
    uint32_t* keys = reinterpret_cast<uint32_t*>(list);
    const int n2 = dev_pow2_at_least(nprobe);
    for (int i = tid; i < n2; i += THREADS) keys[i] = i < nprobe ? pmax[i] : 0u;
    __syncthreads();
    sort_desc(keys, n2);
    t = keys[k_out - 1];
    __syncthreads();
  }

  // ---- pass 2: the candidates above t, from the pairs whose best beats t ----
  int n_gt;
  for (;;) {
    if (tid == 0) n_above = n_qual = 0;
    __syncthreads();
    for (int j = tid; j < nprobe; j += THREADS)
      if (pmax[j] > t) qual[atomicAdd(&n_qual, 1)] = j;
    __syncthreads();
    const int nq = n_qual;
    for (int i0 = warp * PPW; i0 < nq; i0 += STEP * UNROLL) {  // uniform in the warp
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * STEP + sub;
        v[u] = load4(a.cand, i < nq ? off[qual[i]] : -1, col);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * STEP + sub;
        const int j = i < nq ? qual[i] : 0;
        const float b = pbias[j];
        const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t k = pool_key<PACKED>(vals[e], b, qs, has_bias, has_scale);
          const bool above = i < nq && k > t;
          const unsigned m = __ballot_sync(FULL, above);
          if (m == 0) continue;
          int first = 0;
          if (lane == 0) first = atomicAdd(&n_above, __popc(m));
          first = __shfl_sync(FULL, first, 0);
          const int at = first + __popc(m & ((1u << lane) - 1));
          if (above && at < cap) list[at] = entry(k, j * KC + col + e);
        }
      }
    }
    __syncthreads();
    n_gt = n_above;
    __syncthreads();
    if (n_gt <= cap) break;
    // The list overflowed: t rises to the k_out-th best of what it holds.
    sort_desc(list, cap);
    t = static_cast<uint32_t>(list[k_out - 1] >> 32);
    __syncthreads();
  }

  // ---- fewer than k_out above t: t is the k_out-th score; ties fill in ------
  int n_sort = n_gt;
  if (n_gt < k_out) {
    n_sort = k_out;
    if (warp == 0) {
      const int need = k_out - n_gt;
      int got = 0;  // uniform in the warp
      for (int j = 0; j < nprobe && got < need; ++j) {
        if (pmax[j] < t) continue;
        const float4 v = load4(a.cand, lane < LP ? off[j] : -1, lane * 4);
        const float vals[4] = {v.x, v.y, v.z, v.w};
        bool tie[4];
        int cnt = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tie[e] = lane < LP && pool_key<PACKED>(vals[e], pbias[j], qs, has_bias, has_scale) == t;
          cnt += tie[e];
        }
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += n;
        }
        int p = got + incl - cnt;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (tie[e]) {
            if (p < need) list[n_gt + p] = entry(t, j * KC + lane * 4 + e);
            ++p;
          }
        }
        got += __shfl_sync(FULL, incl, 31);
      }
    }
  }

  // ---- order the head and write it out --------------------------------------
  const int n2 = dev_pow2_at_least(n_sort);
  for (int i = n_sort + tid; i < n2; i += THREADS) list[i] = 0;  // sorts last
  __syncthreads();
  sort_desc(list, n2);
  for (int i = tid; i < k_out; i += THREADS) {
    const uint64_t e = list[i];
    const int pos = static_cast<int>(~static_cast<uint32_t>(e));
    const int j = pos / KC, c = pos % KC;
    int row;
    if constexpr (PACKED) {
      const long long o = off[j];
      const int bits = o < 0 ? __float_as_int(MASK_SCORE) : __float_as_int(a.cand[o + c]);
      row = min(a.list_start[a.probe_lists[base + j]] + (bits & LOCAL_MASK), a.n_rows - 1);
    } else {
      row = a.cand_idx[a.padpos[base + j] * KC + c];
    }
    a.out_s[static_cast<long long>(q) * k_out + i] = score_of(static_cast<uint32_t>(e >> 32));
    a.out_rows[static_cast<long long>(q) * k_out + i] = row;
  }
}

// A block a query, its tables in shared memory (IN_SMEM: addressed as
// shared; generic addresses made K3 8% slower at config 4's slice); or, past
// shared memory, blocks that each take queries blockIdx.x, + gridDim.x, ...
// with their tables in a slice of the workspace.
template <int KC, bool PACKED, bool IN_SMEM>
__global__ void __launch_bounds__(THREADS) pool_select(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (IN_SMEM) {
    select_query<KC, PACKED>(a, blockIdx.x, smem);
  } else {
    unsigned char* tables = a.work + blockIdx.x * a.work_stride;
    for (int q = blockIdx.x; q < a.b; q += gridDim.x) {
      select_query<KC, PACKED>(a, q, tables);
      __syncthreads();  // the next query rewrites the tables
    }
  }
}

int list_cap(int nprobe, int k_out) {
  int cap = pow2_at_least(k_out > MIN_CAP ? k_out : MIN_CAP);
  const int half = (pow2_at_least(nprobe) + 1) / 2;  // the pair maxima sort as 32-bit keys in the list
  return cap > half ? cap : pow2_at_least(half);
}

// Bytes of one block's tables (16-byte multiples).
long long table_bytes(int nprobe, int cap) {
  return (static_cast<long long>(cap) * 8 + static_cast<long long>(nprobe) * (8 + 4 + 4 + 4) + 15) / 16 * 16;
}

// Blocks that share the workspace: every query's where one block's tables
// fit the budget, else as many as it holds, at least one.
int work_blocks(int b, long long stride) {
  const long long n = WORK_BUDGET / stride;
  return static_cast<int>(n < 1 ? 1 : (n < b ? n : b));
}

template <int KC, bool PACKED>
int launch(const Args& a, int blocks, int smem, cudaStream_t stream) {
  if (a.work != nullptr) {
    pool_select<KC, PACKED, false><<<blocks, THREADS, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = pool_select<KC, PACKED, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device-memory workspace K3 needs for these sizes: 0 where a
// block's tables fit in shared memory.
long long lotus_pool_select_workspace(int b, int nprobe, int k_out) {
  if (b < 1 || nprobe < 1 || k_out < 1) return 0;
  const long long stride = table_bytes(nprobe, list_cap(nprobe, k_out));
  return stride <= MAX_SMEM ? 0 : stride * work_blocks(b, stride);
}

// Launches K3 on `stream` and returns a cudaError_t (0 on success).
// kc: 64 or 128 candidates a pair; 1 <= k_out <= nprobe * kc; cand_idx is
// read only when !packed; bias / qscale may be null (qscale is read only
// with a bias).  cand must be 16-byte aligned; work must hold
// lotus_pool_select_workspace(b, nprobe, k_out) bytes, 16-byte aligned.
int lotus_pool_select(const void* cand, const void* cand_idx, const void* padpos, const void* probe_lists,
                      const void* list_start, const void* list_size, const void* bias, const void* qscale,
                      void* out_s, void* out_rows, void* work, long long work_bytes, int b, int nprobe, int kc,
                      int k_out, int packed, int n_rows, void* stream) {
  if (b <= 0) return 0;
  if ((kc != 64 && kc != 128) || nprobe < 1 || k_out < 1 ||
      static_cast<long long>(k_out) > static_cast<long long>(nprobe) * kc || n_rows < 1 ||
      (!packed && cand_idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = list_cap(nprobe, k_out);
  const long long stride = table_bytes(nprobe, cap);
  const bool in_smem = stride <= MAX_SMEM;
  const long long need = lotus_pool_select_workspace(b, nprobe, k_out);
  if (!in_smem && (work == nullptr || work_bytes < need || reinterpret_cast<uintptr_t>(work) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(cand), static_cast<const int*>(cand_idx),
               static_cast<const long long*>(padpos), static_cast<const int*>(probe_lists),
               static_cast<const int*>(list_start), static_cast<const int*>(list_size),
               static_cast<const float*>(bias), static_cast<const float*>(qscale),
               static_cast<float*>(out_s), static_cast<int*>(out_rows),
               in_smem ? nullptr : static_cast<unsigned char*>(work), stride, b, nprobe, k_out, n_rows, cap};
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = in_smem ? b : work_blocks(b, stride);
  const int smem = in_smem ? static_cast<int>(stride) : 0;
  if (kc == 128) return packed ? launch<128, true>(a, blocks, smem, s) : launch<128, false>(a, blocks, smem, s);
  return packed ? launch<64, true>(a, blocks, smem, s) : launch<64, false>(a, blocks, smem, s);
}

}  // extern "C"
