// K4: the MoE layer's combine for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts layer.
// It replaces the PyTorch passes that ended DeepSeek-V2's routed experts
// (models/deepseek_v2.py): the unsort of the second grouped GEMM's output
// into pair order, its copy to f32, the multiply by the routing weights, the
// sum over a token's k slots, the cast back and, in a pass of its own, the
// shared experts' add.  ops/moe_combine.py::moe_combine is its wrapper and
// moe_combine_reference its plain PyTorch version.
//
// What it computes.  For token u, with the pairs u * k + j sorted by expert
// and inv[u * k + j] a pair's place in that order:
//   y[u] = round(sum_{j = 0..k-1, inv[u k + j] < held} w[u, j] * out[inv[u k + j]] + shared[u])
// in f32, each product and each add rounded on its own (__fmul_rn, __fadd_rn:
// never contracted into an FMA, as the plain version rounds twice), the
// slots in order j = 0..k-1 and the shared row last, then rounded once to
// the rows' type.  `held` (the held experts' pair count, the last of the
// grouped GEMMs' offsets) is read on the card; the rows at or past it were
// never written where a layer holds only some experts, and are never read.
//
// What bounds it on this card.  Bytes: each held pair's row once (at the
// passage join's shape, 196,608 bf16 rows of 2,048, 805 MB), each shared row
// once and each output row once (134 MB each): 1.07 GB, 0.32 ms at
// 3.35 TB/s.  The PyTorch passes moved about 9.9 GB, nine times that (the
// f32 copy and the product are each twice the rows' bytes, written and read
// again), and it is added for that.  The design:
// - A token's k rows lie at random places of `out`, each a contiguous row
//   (4 KB at hidden 2,048 in bf16).  A block of 256 threads takes one token
//   (or 256 / the row's vectors tokens, for narrow rows); each thread owns
//   16-byte vectors of the row and issues the loads of up to 8 slots and the
//   shared row before it adds any of them, so a token's rows are all in
//   flight together.
// - The sum stays in registers: no shared memory, no atomics, so a token's
//   result is the same in every run.
// - Rows are read and written as 16-byte vectors only: the wrapper refuses
//   a width that is not a whole number of them, or tensors not 16-byte
//   aligned (every DeepSeek-V2 width is a multiple of 8).
// - Launched on PyTorch's stream with no host synchronisation; the wrapper
//   allocates the output.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 8;  // slots whose loads a thread keeps in flight

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// 16 bytes of a row, loaded and stored as one access.
template <typename T>
struct alignas(16) Pack {
  static constexpr int VEC = 16 / sizeof(T);
  T v[VEC];
};

struct Args {
  const void* out;       // (t * k, hidden) rows in the sorted pair order
  const long long* inv;  // (t * k,)
  const float* weights;  // (t, k)
  const int* held;       // one int32: the held pairs' count
  const void* shared;    // (t, hidden) or null
  void* y;               // (t, hidden)
  long long t;
  int k;
  int hidden;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) moe_combine(const Args a) {
  using P = Pack<T>;
  constexpr int VEC = P::VEC;
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (u >= a.t) return;
  const int nvec = a.hidden / VEC;
  const long long held = *a.held;
  const P* __restrict__ out = static_cast<const P*>(a.out);
  const P* __restrict__ shared = static_cast<const P*>(a.shared);
  const long long* __restrict__ inv = a.inv + u * a.k;
  const float* __restrict__ w = a.weights + u * a.k;
  P* __restrict__ y = static_cast<P*>(a.y);
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    P s;
    if (shared != nullptr) s = shared[u * nvec + c];
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int j0 = 0; j0 < a.k; j0 += SLOTS) {
      P r[SLOTS];
      float wj[SLOTS];
      bool live[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int j = j0 + i;
        const long long p = j < a.k ? inv[j] : held;
        live[i] = p < held;
        if (live[i]) {
          r[i] = out[p * nvec + c];
          wj[i] = w[j];
        }
      }
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (live[i]) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj[i], to_f32(r[i].v[e])));
        }
      }
    }
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = shared != nullptr ? __fadd_rn(acc[e], to_f32(s.v[e])) : acc[e];
      o.v[e] = from_f32<T>(v);
    }
    y[u * nvec + c] = o;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  if (a.hidden % VEC || !aligned16(a.out) || !aligned16(a.y) || (a.shared != nullptr && !aligned16(a.shared)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = a.hidden / VEC;
  const int tx = nvec >= THREADS ? THREADS : (nvec <= 32 ? 32 : pow2_at_least(nvec));
  const dim3 block(tx, THREADS / tx);
  const long long blocks = (a.t + block.y - 1) / block.y;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  moe_combine<T><<<static_cast<unsigned>(blocks), block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns a cudaError_t (0 on success).
// dtype: 0 f32, 1 bf16, 2 f16 (out, shared and y alike), hidden a multiple
// of 16 bytes' elements and out, shared and y 16-byte aligned; inv is int64;
// held points at one int32 on the device; shared may be null.
int lotus_moe_combine(const void* out, const void* inv, const void* weights, const void* held, const void* shared,
                      void* y, long long t, int k, int hidden, int dtype, void* stream) {
  if (t <= 0 || hidden <= 0) return 0;
  if (k < 1 || out == nullptr || inv == nullptr || weights == nullptr || held == nullptr || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{out, static_cast<const long long*>(inv), static_cast<const float*>(weights),
               static_cast<const int*>(held), shared, y, t, k, hidden};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(a, s);
    case BF16: return launch<__nv_bfloat16>(a, s);
    case F16: return launch<__half>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
