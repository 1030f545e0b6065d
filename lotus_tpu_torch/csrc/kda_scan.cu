// K6: KDA's chunked recurrence for Hopper (sm_90a), in two launches.
//
// Replaces no TPU kernel: the JAX package has no KDA layer.  It replaces
// the plain PyTorch passes of ops/kda.py::scan_chunks_reference (the
// chunk's pairs in f64, a batched triangular solve, a Python loop of three
// batched products a chunk); ops/kda.py::scan_chunks is its wrapper.
//
// What it computes, for each (batch x head) b and chunk n of CHUNK = 64
// tokens, with q, k, g (d_k = 128, 64) and v (d_v = 128, 64) f32 tiles
// channels first, beta (64) and the state S (d_k, d_v) entering the chunk
// (zero before the first), exactly the plain version's algebra in f32:
//   d[c, t] = exp(max(g[c, t], PAIR_FLOOR))            each token's decay
//   A[r, i] = beta_r sum_c k[c, r] k[c, i] prod_{t=i+1..r} d[c, t]    (i < r)
//   P[r, i] = scale sum_c q[c, r] k[c, i] prod_{t=i+1..r} d[c, t]     (i <= r)
//   (I + A) [W | U0] = diag(beta) [(K * e^G)^T | V^T],  e^G[c, r] = prod_{t<=r} d[c, t]
//   U = U0 - W S;   O = scale (Q * e^G)^T S + P U
//   S <- diag(prod_t d[c, t]) S + (K * prod_{t>r} d[c, t]) U
// Every product has f32 operands and an f32 sum (CUDA-core FMA; no
// fast-math, no TF32); the state stays f32.
//
// Keeping the decays exact without f64.  Every decay the recurrence needs
// between two tokens is a product of the tokens' own decays d <= 1, so no
// factor ever exceeds 1 and none is a difference of long sums (which is
// where f32 cumulative log decays lose digits).  A and P need
// prod_{t=i+1..r} d[c, t] inside a GEMM over c, which is split at a token m
// between i and r into a row factor prod_{m<t<=r} d and a column factor
// prod_{i<t<=m} d, both at most 1: the chunk's lower triangle is covered by
// a binary hierarchy of blocks (halves of 32, 16, 8, 4, 2, 1 tokens), each
// block's lower-left quadrant with its middle as m.  A factor that
// underflows belongs to a pair whose true factor is smaller still.  The
// floor is the plain version's: it changes only a decay below e^-21.
//
// What bounds it on this card.  Bytes: q, k, v and g in f32 tiles and beta,
// 2,052 bytes a (token, head) in, o's 512 out: 5.4 GB a layer of 8 x 8,192
// tokens and 32 heads, 1.6 ms at 3.35 TB/s, plus the 148 KB a tile the chunk
// stage writes and the state stage reads (4.9 GB).  Operations: about 70 k
// FMA a (token, head), 16 k in the chunk stage and 54 k in the state stage;
// 1.5e11 a layer, 4.4 ms at 67 TFLOP/s on the CUDA cores, so the products,
// kept in f32, bound it.  On an H100 (700 W) at that shape it takes 13.9 ms:
// the state stage 6.2 (55% of the CUDA cores' peak), the chunk stage 7.7,
// where one 196 KB block an SM waits on its load and its barriers more than
// it computes.
//
// The design:
// - Chunk stage (kda_chunk_stage), one block of 512 threads a tile (chunk,
//   b), every tile independent: the tile in shared memory; the hierarchy's
//   scaled operands level by level, each level a small GEMM over c (2 x 2
//   pairs a thread, the c range split over lanes and summed by shuffles);
//   the forward substitution with one thread a right-hand column (128 of W,
//   128 of U0), its 64 rows in registers, while the other 256 threads form
//   Q * e^G, K * e^{G_C - G} and the chunk's decay.  It writes, per tile, a
//   pack [W; Q e^G] (128 c x 128 rows), K_out^T (64 x 128), P^T (64 x 64),
//   the decay (128), and U0 (64 x 128).
// - State stage (kda_state_stage), one block of 256 threads a (b, half of
//   d_v): its 128 x 64 slice of S in shared memory and registers across all
//   the sequence's chunks; each chunk's pack streamed through a 5-deep ring
//   of 8 KB slices by cp.async, so the loads run ahead of the products;
//   [W; Q e^G] S (8 x 4 outputs a thread), U, P U and the state update in
//   registers; O written once.
// - Launched on PyTorch's stream with no host synchronisation; the wrapper
//   allocates the output and the workspace (148 KB a tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DK = 128;  // key channels a head
constexpr int DV = 128;  // value channels a head
constexpr int C = 64;    // tokens a chunk
constexpr float PAIR_FLOOR = -21.0f;
constexpr float SCALE = 0.08838834764831845f;  // DK ** -0.5

constexpr int TILE = DK * C;  // floats of a q, k, g or v tile
// The pack a tile's chunk stage writes for the state stage (floats).
constexpr int WQ_OFF = 0;                    // [c][128]: rows 0-63 W, 64-127 Q e^G
constexpr int KT_OFF = WQ_OFF + DK * 2 * C;  // [r][c]: K * e^{G_C - G}
constexpr int PT_OFF = KT_OFF + C * DK;      // [i][r]: P
constexpr int DECAY_OFF = PT_OFF + C * C;    // [c]: e^{G_C}
constexpr int PACK = DECAY_OFF + DK;
constexpr int U0_FLOATS = C * DV;  // [r][j]

// ---- chunk stage -------------------------------------------------------------

constexpr int T1 = 512;
constexpr int LDA = C + 1;   // [c][t] arrays: a lane a channel reads without conflicts
constexpr int LDX = DK + 4;  // [t][c] arrays: float4 along c
constexpr int KS_OFF = 0, QS_OFF = KS_OFF + DK * LDA, DS_OFF = QS_OFF + DK * LDA;
constexpr int XS_OFF = DS_OFF + DK * LDA, YS_OFF = XS_OFF + C * LDX;
constexpr int AS_OFF = YS_OFF + C * LDX, PS_OFF = AS_OFF + C * C, BS_OFF = PS_OFF + C * C;
constexpr int SMEM1 = (BS_OFF + C) * 4;
static_assert(XS_OFF % 4 == 0 && YS_OFF % 4 == 0 && AS_OFF % 4 == 0 && PS_OFF % 4 == 0, "float4 alignment");
static_assert(DV * LDA <= C * LDX, "v and W are staged in X's and Y's space");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const float* beta;
  float* pack;  // (tiles, PACK)
  float* u0;    // (tiles, C, DV)
  float* out;   // (tiles, C, DV)
  int bh;
  int chunks;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int SPLIT>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One level of the hierarchy: blocks of 2H tokens, rows [s + H, s + 2H)
// against columns [s, s + H) about m = s + H.  First the scaled operands
// (k and q times their row factor, k times its column factor) [t][c], then
// the pairs' sums over c.
template <int H>
__device__ __forceinline__ void level(float* sm, int tid) {
  const float* ks = sm + KS_OFF;
  const float* qs = sm + QS_OFF;
  const float* ds = sm + DS_OFF;
  float* xs = sm + XS_OFF;
  float* ys = sm + YS_OFF;
  {
    const int c = tid & (DK - 1), half = (tid >> 7) & 1, first = tid >> 8;
    for (int b = first; b < C / (2 * H); b += 2) {
      const int m = 2 * H * b + H;
      float f = 1.0f;
      if (half == 0) {
#pragma unroll
        for (int t = m - 1; t >= m - H; --t) {
          f *= ds[c * LDA + t + 1];
          xs[t * LDX + c] = ks[c * LDA + t] * f;
        }
      } else {
#pragma unroll
        for (int t = m; t < m + H; ++t) {
          xs[t * LDX + c] = ks[c * LDA + t] * f;
          ys[t * LDX + c] = qs[c * LDA + t] * f;
          if (t + 1 < m + H) f *= ds[c * LDA + t + 1];
        }
      }
    }
  }
  __syncthreads();
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  const float4* y4 = reinterpret_cast<const float4*>(ys);
  float* as = sm + AS_OFF;
  float* ps = sm + PS_OFF;
  const float* bs = sm + BS_OFF;
  constexpr int Q = LDX / 4;
  if constexpr (H >= 2) {
    constexpr int SPLIT = 64 / H, HH = H / 2;  // 8H tiles of 2 x 2 pairs, SPLIT lanes a tile
    const int part = tid & (SPLIT - 1), tile = tid / SPLIT;
    const int b = tile / (HH * HH), rem = tile % (HH * HH);
    const int r0 = 2 * H * b + H + rem / HH, r1 = r0 + HH, i0 = 2 * H * b + rem % HH, i1 = i0 + HH;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f, p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
#pragma unroll 4
    for (int cq = part; cq < DK / 4; cq += SPLIT) {
      const float4 xr0 = x4[r0 * Q + cq], xr1 = x4[r1 * Q + cq];
      const float4 yr0 = y4[r0 * Q + cq], yr1 = y4[r1 * Q + cq];
      const float4 xi0 = x4[i0 * Q + cq], xi1 = x4[i1 * Q + cq];
      a00 = dot4(xr0, xi0, a00);
      a01 = dot4(xr0, xi1, a01);
      a10 = dot4(xr1, xi0, a10);
      a11 = dot4(xr1, xi1, a11);
      p00 = dot4(yr0, xi0, p00);
      p01 = dot4(yr0, xi1, p01);
      p10 = dot4(yr1, xi0, p10);
      p11 = dot4(yr1, xi1, p11);
    }
    a00 = lane_sum<SPLIT>(a00);
    a01 = lane_sum<SPLIT>(a01);
    a10 = lane_sum<SPLIT>(a10);
    a11 = lane_sum<SPLIT>(a11);
    p00 = lane_sum<SPLIT>(p00);
    p01 = lane_sum<SPLIT>(p01);
    p10 = lane_sum<SPLIT>(p10);
    p11 = lane_sum<SPLIT>(p11);
    if (part == 0) {
      as[r0 * C + i0] = bs[r0] * a00;
      as[r0 * C + i1] = bs[r0] * a01;
      as[r1 * C + i0] = bs[r1] * a10;
      as[r1 * C + i1] = bs[r1] * a11;
      ps[i0 * C + r0] = SCALE * p00;
      ps[i1 * C + r0] = SCALE * p01;
      ps[i0 * C + r1] = SCALE * p10;
      ps[i1 * C + r1] = SCALE * p11;
    }
  } else {
    constexpr int SPLIT = 16;  // 32 pairs (2b + 1, 2b)
    const int part = tid & (SPLIT - 1), b = tid / SPLIT;
    const int r = 2 * b + 1, i = 2 * b;
    float a = 0.f, p = 0.f;
#pragma unroll
    for (int cq = part; cq < DK / 4; cq += SPLIT) {
      const float4 xi = x4[i * Q + cq];
      a = dot4(x4[r * Q + cq], xi, a);
      p = dot4(y4[r * Q + cq], xi, p);
    }
    a = lane_sum<SPLIT>(a);
    p = lane_sum<SPLIT>(p);
    if (part == 0) {
      as[r * C + i] = bs[r] * a;
      ps[i * C + r] = SCALE * p;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(T1, 1) kda_chunk_stage(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  float* ks = sm + KS_OFF;
  float* qs = sm + QS_OFF;
  float* ds = sm + DS_OFF;
  float* ps = sm + PS_OFF;
  float* bs = sm + BS_OFF;

  // The tile into shared memory, [c][t] with a padded row; each token's
  // decay floored as the plain version floors it.  v waits in registers
  // until the hierarchy's operands are done with its space.
  const float4* q4 = reinterpret_cast<const float4*>(a.q + tile * TILE);
  const float4* k4 = reinterpret_cast<const float4*>(a.k + tile * TILE);
  const float4* g4 = reinterpret_cast<const float4*>(a.g + tile * TILE);
  const float4* v4 = reinterpret_cast<const float4*>(a.v + tile * TILE);
  float4 vr[TILE / 4 / T1];
#pragma unroll
  for (int m = 0; m < TILE / 4 / T1; ++m) vr[m] = __ldg(v4 + tid + m * T1);
#pragma unroll
  for (int m = 0; m < TILE / 4 / T1; ++m) {
    const int e = 4 * (tid + m * T1), c = e / C, t = e % C;
    const float4 qv = __ldg(q4 + tid + m * T1), kv = __ldg(k4 + tid + m * T1), gv = __ldg(g4 + tid + m * T1);
    float* qd = qs + c * LDA + t;
    float* kd = ks + c * LDA + t;
    float* dd = ds + c * LDA + t;
    qd[0] = qv.x, qd[1] = qv.y, qd[2] = qv.z, qd[3] = qv.w;
    kd[0] = kv.x, kd[1] = kv.y, kd[2] = kv.z, kd[3] = kv.w;
    dd[0] = expf(fmaxf(gv.x, PAIR_FLOOR));
    dd[1] = expf(fmaxf(gv.y, PAIR_FLOOR));
    dd[2] = expf(fmaxf(gv.z, PAIR_FLOOR));
    dd[3] = expf(fmaxf(gv.w, PAIR_FLOOR));
  }
  for (int e = tid; e < C * C; e += T1) ps[e] = 0.0f;
  if (tid < C) bs[tid] = __ldg(a.beta + tile * C + tid);
  __syncthreads();

  // P's diagonal (no decay between a token and itself): 8 lanes a row.
  {
    const int r = tid >> 3, part = tid & 7;
    float p = 0.f;
#pragma unroll
    for (int c = part; c < DK; c += 8) p = fmaf(qs[c * LDA + r], ks[c * LDA + r], p);
    p = lane_sum<8>(p);
    if (part == 0) ps[r * C + r] = SCALE * p;
  }
  level<32>(sm, tid);
  level<16>(sm, tid);
  level<8>(sm, tid);
  level<4>(sm, tid);
  level<2>(sm, tid);
  level<1>(sm, tid);

  float* vs = sm + XS_OFF;  // [j][t], padded as ks
  float* ws = sm + YS_OFF;  // W staged [c][r], padded as ks
#pragma unroll
  for (int m = 0; m < TILE / 4 / T1; ++m) {
    const int e = 4 * (tid + m * T1), j = e / C, t = e % C;
    float* vd = vs + j * LDA + t;
    vd[0] = vr[m].x, vd[1] = vr[m].y, vd[2] = vr[m].z, vd[3] = vr[m].w;
  }
  __syncthreads();

  float* pack = a.pack + tile * PACK;
  if (tid < DK + DV) {
    // Forward substitution, one right-hand column a thread: columns 0-127
    // are beta (K * e^G)^T (giving W), 128-255 beta V^T (giving U0).
    const bool w_col = tid < DK;
    const int col = w_col ? tid : tid - DK;
    const float* as = sm + AS_OFF;
    float x[C];
    float pre = 1.0f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      float rhs;
      if (w_col) {
        pre *= ds[col * LDA + r];
        rhs = bs[r] * (ks[col * LDA + r] * pre);
      } else {
        rhs = bs[r] * vs[col * LDA + r];
      }
      const float4* a4 = reinterpret_cast<const float4*>(as + r * C);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < r / 4; ++i4) {
        const float4 av = a4[i4];
        s0 = fmaf(av.x, x[4 * i4], s0);
        s1 = fmaf(av.y, x[4 * i4 + 1], s1);
        s2 = fmaf(av.z, x[4 * i4 + 2], s2);
        s3 = fmaf(av.w, x[4 * i4 + 3], s3);
      }
#pragma unroll
      for (int i = (r / 4) * 4; i < r; ++i) s0 = fmaf(as[r * C + i], x[i], s0);
      x[r] = rhs - ((s0 + s1) + (s2 + s3));
    }
    if (w_col) {
#pragma unroll
      for (int r = 0; r < C; ++r) ws[col * LDA + r] = x[r];
    } else {
      float* u0 = a.u0 + tile * U0_FLOATS;
#pragma unroll
      for (int r = 0; r < C; ++r) u0[r * DV + col] = x[r];
    }
  } else if (tid < DK + DV + DK) {
    // Q * e^G, scaled, in place of q.
    const int c = tid - DK - DV;
    float pre = 1.0f;
#pragma unroll 16
    for (int r = 0; r < C; ++r) {
      pre *= ds[c * LDA + r];
      qs[c * LDA + r] = SCALE * (qs[c * LDA + r] * pre);
    }
  } else {
    // K * e^{G_C - G} (written [r][c]) and the chunk's decay e^{G_C}.
    const int c = tid - DK - DV - DK;
    float f = 1.0f;
#pragma unroll 16
    for (int r = C - 1; r >= 0; --r) {
      pack[KT_OFF + r * DK + c] = ks[c * LDA + r] * f;
      f *= ds[c * LDA + r];
    }
    pack[DECAY_OFF + c] = f;
  }
  __syncthreads();

  for (int e = tid; e < DK * 2 * C; e += T1) {
    const int c = e / (2 * C), row = e % (2 * C);
    pack[WQ_OFF + e] = row < C ? ws[c * LDA + row] : qs[c * LDA + row - C];
  }
  const float4* p4 = reinterpret_cast<const float4*>(ps);
  float4* pt = reinterpret_cast<float4*>(pack + PT_OFF);
  for (int e = tid; e < C * C / 4; e += T1) pt[e] = p4[e];
}

// ---- state stage -------------------------------------------------------------

constexpr int T2 = 256;
constexpr int HALF = DV / 2;          // value columns a block
constexpr int SLICE = 2048;           // floats a ring slot (8 KB)
constexpr int NST = 5;                // ring depth
constexpr int SLICES = 16;            // a chunk: 8 of [W; Q e^G], 2 of U0, 4 of K_out^T, 2 of P^T
constexpr int SS_OFF2 = 0;            // S [c][HALF]
constexpr int US_OFF2 = SS_OFF2 + DK * HALF;   // U [r][HALF]
constexpr int OB_OFF2 = US_OFF2 + C * HALF;    // (Q e^G) S [r][HALF]
constexpr int RING_OFF2 = OB_OFF2 + C * HALF;  // NST slots
constexpr int SMEM2 = (RING_OFF2 + NST * SLICE) * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slice s of chunk n into its ring slot; 32 bytes a thread.  Always
// commits a group (empty past the end), so the wait counts stay aligned.
__device__ __forceinline__ void issue(const Args& a, float* ring, int b, int h, int gs, int total, int tid) {
  if (gs < total) {
    const int n = gs / SLICES, s = gs % SLICES;
    const long long tile = static_cast<long long>(n) * a.bh + b;
    float* dst = ring + (gs % NST) * SLICE;
    const float* src;
    if (s < 10 && s >= 8) {
      const int row = tid >> 3, col = (tid & 7) * 8;
      dst += row * HALF + col;
      src = a.u0 + tile * U0_FLOATS + (32 * (s - 8) + row) * DV + HALF * h + col;
    } else {
      const int off = s < 8 ? WQ_OFF + s * SLICE : s < 14 ? KT_OFF + (s - 10) * SLICE : PT_OFF + (s - 14) * SLICE;
      dst += tid * 8;
      src = a.pack + tile * PACK + off + tid * 8;
    }
    cp_async16(dst, src);
    cp_async16(dst + 4, src + 4);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(T2, 2) kda_state_stage(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x >> 1, h = blockIdx.x & 1;
  float* ss = sm + SS_OFF2;
  float* us = sm + US_OFF2;
  float* ob = sm + OB_OFF2;
  float* ring = sm + RING_OFF2;
  const int total = a.chunks * SLICES;

  // This thread's 8 x 4 of the state: rows (channels) 8ty.., columns 4tx..
  float st[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = 0.0f;
    reinterpret_cast<float4*>(ss + (8 * ty + i) * HALF)[tx] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) issue(a, ring, b, h, p, total, tid);

  float acc[8][4];   // [W; Q e^G] S: rows 8ty.. of 128, then the state update
  float o[4][4];     // O: rows 4ty.., columns 4tx..
  float4 dec0 = make_float4(0.f, 0.f, 0.f, 0.f), dec1 = dec0;
  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    issue(a, ring, b, h, gs + NST - 1, total, tid);
    const int n = gs / SLICES, s = gs % SLICES;
    const long long tile = static_cast<long long>(n) * a.bh + b;
    const float* slot = ring + (gs % NST) * SLICE;
    const float4* s4 = reinterpret_cast<const float4*>(slot);
    if (s < 8) {
      if (s == 0) {
        const float4* d4 = reinterpret_cast<const float4*>(a.pack + tile * PACK + DECAY_OFF);
        dec0 = __ldg(d4 + 2 * ty);
        dec1 = __ldg(d4 + 2 * ty + 1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      const float4* sv4 = reinterpret_cast<const float4*>(ss + 16 * s * HALF);
#pragma unroll
      for (int cl = 0; cl < 16; ++cl) {
        const float4 w0 = s4[cl * 32 + 2 * ty], w1 = s4[cl * 32 + 2 * ty + 1];
        const float4 sv = sv4[cl * (HALF / 4) + tx];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w[i], sj[j], acc[i][j]);
      }
    } else if (s < 10) {
      // U = U0 - W S for this slice's 32 rows; (Q e^G) S set aside for O.
      const int lo = 32 * (s - 8);
      if (ty < 8 && 8 * ty >= lo && 8 * ty < lo + 32) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 u0 = s4[(8 * ty + i - lo) * (HALF / 4) + tx];
          reinterpret_cast<float4*>(us + (8 * ty + i) * HALF)[tx] =
              make_float4(u0.x - acc[i][0], u0.y - acc[i][1], u0.z - acc[i][2], u0.w - acc[i][3]);
        }
      } else if (ty >= 8 && s == 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          reinterpret_cast<float4*>(ob + (8 * (ty - 8) + i) * HALF)[tx] =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    } else if (s < 14) {
      // S <- e^{G_C} S + K_out U, 16 rows of U a slice.
      if (s == 10) {
        const float dec[8] = {dec0.x, dec0.y, dec0.z, dec0.w, dec1.x, dec1.y, dec1.z, dec1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dec[i] * st[i][j];
      }
      const float4* u4 = reinterpret_cast<const float4*>(us + 16 * (s - 10) * HALF);
#pragma unroll
      for (int rl = 0; rl < 16; ++rl) {
        const float4 k0 = s4[rl * 32 + 2 * ty], k1 = s4[rl * 32 + 2 * ty + 1];
        const float4 uv = u4[rl * (HALF / 4) + tx];
        const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float uj[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kk[i], uj[j], acc[i][j]);
      }
      if (s == 13) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = acc[i][j];
          reinterpret_cast<float4*>(ss + (8 * ty + i) * HALF)[tx] =
              make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        }
      }
    } else {
      // O = (Q e^G) S + P U, 32 columns of P (rows of U) a slice; P is
      // zero above its diagonal, so a row stops at its own token.
      const int lo = 32 * (s - 14);
      if (s == 14) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = reinterpret_cast<const float4*>(ob + (4 * ty + i) * HALF)[tx];
          o[i][0] = v.x, o[i][1] = v.y, o[i][2] = v.z, o[i][3] = v.w;
        }
      }
      const int stop = min(32, 4 * ty + 4 - lo);
      const float4* u4 = reinterpret_cast<const float4*>(us + lo * HALF);
#pragma unroll 4
      for (int il = 0; il < stop; ++il) {
        const float4 pv = s4[il * (C / 4) + ty];
        const float4 uv = u4[il * (HALF / 4) + tx];
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
        const float uj[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pp[i], uj[j], o[i][j]);
      }
      if (s == 15) {
        float* out = a.out + tile * (C * DV) + HALF * h;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<float4*>(out + (4 * ty + i) * DV)[tx] = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Bytes of the workspace K6 needs for `tiles` = chunks x (batch x heads) tiles.
long long lotus_kda_scan_workspace(long long tiles) {
  return tiles * static_cast<long long>(PACK + U0_FLOATS) * 4;
}

// Launches K6's two kernels on `stream` and returns a cudaError_t (0 on
// success).  q, k, g: (chunks, bh, 128, 64) f32, v: (chunks, bh, 128, 64)
// f32, beta: (chunks, bh, 1, 64) f32, all contiguous; out: (chunks, bh, 64,
// 128) f32; workspace: lotus_kda_scan_workspace(chunks * bh) bytes.  Every
// pointer 16-byte aligned.
int lotus_kda_scan(const void* q, const void* k, const void* v, const void* g, const void* beta, void* workspace,
                   void* out, int chunks, int bh, void* stream) {
  if (chunks <= 0 || bh <= 0) return 0;
  const void* ptrs[] = {q, k, v, g, beta, workspace, out};
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(chunks) * bh;
  if (tiles > 0x7fffffffll || 2ll * bh > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(workspace);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<const float*>(g), static_cast<const float*>(beta), ws, ws + tiles * PACK,
               static_cast<float*>(out), bh, chunks};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(kda_chunk_stage, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kda_state_stage, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM2);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_chunk_stage<<<static_cast<unsigned>(tiles), T1, SMEM1, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_state_stage<<<static_cast<unsigned>(2 * bh), T2, SMEM2, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
