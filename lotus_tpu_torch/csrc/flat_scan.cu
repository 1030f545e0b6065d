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
//   int8 x int8 -> int32 (exact), then __int2float_rn          (int8 queries, int8 store)
//   bf16 x bf16 -> f32 sums                                     (everything else)
// where int8 rows convert to bf16 exactly and f32 and f16 rows round to bf16
// (__float2bfloat16_rn; f16 -> f32 is exact, so f16 rounds once), as the
// reference casts the store to the queries' type.  The multiply and the add use __fmul_rn / __fadd_rn, so no FMA
// contraction changes the last bit.  The top-2 is ordered by (score desc,
// row asc): a strict '>' over the rows in ascending order, so ties go to the
// earlier row and masked rows never enter; their lanes keep (MASK_SCORE, -1).
// Output: best and second in columns 0..127 and 128..255 of (B, 256) f32 and
// int32 planes.
//
// The TPU kernel walks every row in order for each 256-query tile, the
// running top-2 in VMEM.  Here the grid is (64-query tiles) x (row splits),
// with the splits chosen by lotus_flat_scan_plan so that the grid fills the
// SMs.  Each block folds its split (whole 128-row slices) into a top-2 per
// (query, lane) and writes it as a partial; merge_kernel folds the partials
// split by split in row order under the same rule.  So the result is the
// sequential fold's, bit for bit, whatever the schedule (no atomics).
//
// What bounds it on this card.  The work is B * N * d MACs (3.3e12 at
// 2^20 x 768 and B = 4096), which the tensor cores do in about 7 ms (bf16)
// or 3.4 ms (int8) at the data-sheet rates.  Every 64-query tile streams the
// whole store, so at B = 4096 the SMs read 64 store passes (103 GB in bf16)
// from L2; the query tile is the fastest grid index, so the blocks that share
// a split run together and L2, not HBM, serves the repeats.  Measured on an
// H100, the L2-to-SM stream of those passes, the per-stage handshake and the
// fold (4.3e9 scores per batch) bound the kernel, each about as much as the
// tensor cores.  The design:
// - A block is three warpgroups: two consumers and one producer.  setmaxnreg
//   moves registers from the producer (56) to the consumers (224).
// - The query tile (64 x d, the A operand, K-major) stays in shared memory
//   for the whole split (64 x 768 bf16 is 96 KB, int8 48 KB) when two ring
//   stages fit beside it, which holds up to d 1280 in bf16 and 2560 in int8.
//   Past that the query is streamed: each stage carries the query tile's
//   depth chunks after the store's (8 KB each), loaded the same way as the
//   store's, so every d runs through the same consumers at the cost of
//   reading the query tile again for every slice.
// - The store (the B operand, K-major) streams through a ring of up to 4
//   stages, each 128 rows (one slice) x 2 depth chunks of 128 bytes, under
//   mbarrier full / empty pairs: two chunks a stage halve the handshakes,
//   which cost as much as the loads themselves at one chunk a stage.  All
//   tiles use the 128-byte swizzle.  For (bf16, bf16) and (int8, int8) with
//   a row stride that is a multiple of 16 bytes, TMA loads the stages
//   (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so no
//   -lcuda); rows past n_valid and depth past d arrive as zeros.  For bf16
//   queries on an int8, f32 or f16 store (the residual scan is the first)
//   TMA loads the raw rows into a small ring and the producer converts them
//   to bf16: int8 exactly, with no int -> float instruction, f32 and f16
//   rounded with __float2bfloat16_rn.  A row stride TMA cannot describe goes through the
//   producer's registers: it converts or rounds the same way, zero-fills the
//   depth tail and writes the swizzled layout itself.  The producer's 128
//   threads walk the stages in step; one of them arrives on each barrier.
// - Consumer c owns lanes 64c .. 64c + 63 of every slice and runs
//   wgmma m64n64k16 (bf16 -> f32) or m64n64k32 (s8 -> s32) over the depth.
//   In the accumulator layout a thread always holds the same 32 (query,
//   column) cells, and column = lane, so the fold state (best, sec and their
//   slices: 96 registers) stays in that thread's registers with no shuffles.
//   The slices reach each thread in ascending row order, so the strict '>'
//   keeps the tie rule.  The fold is branch-free.
// - The producer also writes, per slice, the row factors, the live flags
//   (n_valid, split end, row mask) and the 64 bias values into a small ring
//   in shared memory, so the epilogue loads nothing from device memory.
// - No thread-block cluster: multicasting each stage to a cluster of query
//   tiles measured slower (4 tiles) or no faster (2) than one block per
//   tile, so the blocks of a split share the store through L2 alone.
// The PTX wrappers (mbarrier, TMA, setmaxnreg, wgmma), the int8 -> bf16
// conversion and the tensor-map encoding live in hopper.cuh, shared with K1.

#include <stdint.h>

#include <type_traits>

#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr int NL = 128;            // lanes: lane = row mod 128; rows per slice
constexpr int QB = 64;             // queries per block (the wgmma M)
constexpr int HALF = 64;           // lanes per consumer (the wgmma N)
constexpr int CHUNK = 128;         // bytes of depth per chunk (one 128-byte swizzle row)
constexpr int KPS = 2;             // depth chunks per ring stage
constexpr int MAX_STAGES = 4;      // store ring depth, as shared memory allows
constexpr int RAW = 4;             // raw chunk slots (at most) of the converting loader
constexpr int NSI = 2;             // slice-info ring depth
constexpr int CONSUMERS = 2;       // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 2 * 128 * 224 + 128 * 56 = 64,512 <= 65,536
constexpr int CHUNK_BYTES = NL * CHUNK;     // 16 KB: one slice x one depth chunk of operands
constexpr int STAGE_BYTES = KPS * CHUNK_BYTES;
constexpr int QCHUNK_BYTES = QB * CHUNK;    // 8 KB: one depth chunk of the query tile
// The converting loader's raw ring: 4 slots of int8 rows (8 KB a bf16 depth
// chunk), or 2 of f16 (16 KB a chunk) or f32 rows (32 KB a chunk).
__host__ __device__ constexpr int raw_slots(int xsize) { return xsize == 1 ? RAW : 2; }
__host__ __device__ constexpr int raw_chunk_bytes(int xsize) { return NL * (CHUNK / 2) * xsize; }
constexpr int SMEM_LIMIT = 232448;          // dynamic shared memory a block may have on sm_90
constexpr int MAX_SLICES = 0xFFFF;          // slices per split: ids pack into 16 bits
constexpr uint32_t NO_SLICE = 0xFFFF;
constexpr float MASK_SCORE = -3.0e38f;
constexpr int NO_HIT = -1;

enum DType { F32 = 0, BF16 = 1, I8 = 2, F16 = 3 };
// How the producer fills the store ring.
enum Loader { REGISTERS = 0, TMA = 1, TMA_CONVERT = 2 };

// What the producer hands the epilogue for one slice.
struct SliceInfo {
  float fac[NL];     // row scale (1 without scales)
  float bias[QB];    // bias[row0 / blk][q0 + m] (0 without bias)
  uint8_t live[NL];  // row < split end (and n_valid) and row_mask != 0
};

constexpr int INFO_BYTES = NSI * static_cast<int>(sizeof(SliceInfo));
constexpr int BAR_BYTES = 8 * (2 * MAX_STAGES + RAW + 2 * NSI + 1);

// Shared memory of a block beside the store ring: the resident query tile
// (nk depth chunks; 0 when the query is streamed), the raw ring (TMA_CONVERT
// only, of xsize-byte rows), the slice infos and the barriers, after up to
// 1024 bytes of alignment.
constexpr int smem_fixed(int nk, int loader, int xsize) {
  return 1024 + nk * QCHUNK_BYTES +
         (loader == TMA_CONVERT ? raw_slots(xsize) * raw_chunk_bytes(xsize) : 0) + INFO_BYTES + BAR_BYTES;
}

// Eight f16 values (16 bytes) as eight bf16, each rounded once: f16 -> f32 is
// exact, then __float2bfloat16_rn, as the reference's astype rounds.
__device__ __forceinline__ uint4 half8_to_bf16(uint4 v) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __half2float(__ushort_as_half(static_cast<unsigned short>(in[i] & 0xFFFFu)));
    const float hi = __half2float(__ushort_as_half(static_cast<unsigned short>(in[i] >> 16)));
    w[i] = bf16_bits(lo) | (bf16_bits(hi) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- the register loader ---------------------------------------------------

// One 16-byte unit of an operand row in the operand type OT: depth
// k0 .. k0 + 16 / sizeof(OT) - 1 of a d-long row of XT, zero past d.  `vec`:
// the row start is aligned for the unit's vector load.
template <typename XT, typename OT>
__device__ __forceinline__ uint4 load_unit(const XT* __restrict__ row, int k0, int d, bool vec) {
  constexpr int EPU = 16 / static_cast<int>(sizeof(OT));
  const bool whole = vec && k0 + EPU <= d;
  if constexpr (std::is_same_v<XT, OT>) {
    if (whole) return __ldg(reinterpret_cast<const uint4*>(row + k0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (std::is_same_v<OT, int8_t>) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (k0 + e < d) w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k0 + e])) << (8 * (e % 4));
  } else {
    float f[8];
    if constexpr (std::is_same_v<XT, int8_t>) {  // exact in bf16
      if (whole) {
        const uint2 r = __ldg(reinterpret_cast<const uint2*>(row + k0));
        return int8x8_to_bf16(r.x, r.y);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = k0 + e < d ? static_cast<float>(row[k0 + e]) : 0.f;
      }
    } else if constexpr (std::is_same_v<XT, __half>) {  // rounds to bf16
      if (whole) return half8_to_bf16(__ldg(reinterpret_cast<const uint4*>(row + k0)));
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = k0 + e < d ? __half2float(row[k0 + e]) : 0.f;
    } else if constexpr (std::is_same_v<XT, float>) {  // rounds to bf16 below
      if (whole) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + k0));
        const float4 c = __ldg(reinterpret_cast<const float4*>(row + k0 + 4));
        f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = c.x, f[5] = c.y, f[6] = c.z, f[7] = c.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = k0 + e < d ? row[k0 + e] : 0.f;
      }
    } else {  // bf16 rows whose start is not 16-byte aligned: bf16 -> f32 -> bf16 is exact
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = k0 + e < d ? __bfloat162float(row[k0 + e]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- the scan kernel -------------------------------------------------------

// Keep the top-2 of (best, sec) under (score desc, row asc) when (v, slice)
// comes after both in row order.  pk holds the best's slice in its low 16
// bits and the second's in its high 16 bits.  Branch-free: two compares,
// selects and one byte permute, so the 32 cells of a thread interleave.
__device__ __forceinline__ void fold(float v, uint32_t slice, float& best, float& sec, uint32_t& pk) {
  const bool over_best = v > best, over_sec = v > sec;
  pk = __byte_perm(pk, slice, over_best ? 0x1054u : (over_sec ? 0x5410u : 0x3210u));
  sec = over_best ? best : (over_sec ? v : sec);
  best = over_best ? v : best;
}

// OT: the operand type (int8 for the int8 dot, else bf16); XT: the store's
// type.  The grid's x is the query tile, y the row split.
template <typename OT, typename XT>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap, int loader,
    const OT* __restrict__ xq, const XT* __restrict__ xb, const float* __restrict__ scales,
    const float* __restrict__ bias, const int8_t* __restrict__ row_mask,
    float* __restrict__ part_s, int* __restrict__ part_i, int b, int d, int n_scan,
    int rows_per_split, int blk, int nk, int nst, int qstream, int qvec, int xvec) {
  constexpr bool INT8_DOT = std::is_same_v<OT, int8_t>;
  constexpr bool CAN_TMA = std::is_same_v<OT, XT>;
  constexpr bool CAN_CONVERT = std::is_same_v<OT, __nv_bfloat16> &&
                                (std::is_same_v<XT, int8_t> || std::is_same_v<XT, float> || std::is_same_v<XT, __half>);
  constexpr int XS = static_cast<int>(sizeof(XT));
  constexpr int SLOTS = raw_slots(XS);
  constexpr int RAW_BYTES = raw_chunk_bytes(XS);
  constexpr int EPC = CHUNK / static_cast<int>(sizeof(OT));  // depth values per chunk
  constexpr int EPU = 16 / static_cast<int>(sizeof(OT));     // depth values per 16-byte unit
  using Acc = std::conditional_t<INT8_DOT, int, float>;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* q_smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* x_smem = q_smem + (qstream ? 0 : nk * QCHUNK_BYTES);
  // A streamed query's depth chunks follow the store's in each stage.
  const int stage_bytes = STAGE_BYTES + (qstream ? KPS * QCHUNK_BYTES : 0);
  uint8_t* raw_smem = x_smem + nst * stage_bytes;
  SliceInfo* info = reinterpret_cast<SliceInfo*>(raw_smem + (loader == TMA_CONVERT ? SLOTS * RAW_BYTES : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(info + NSI);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* raw_full = empty + MAX_STAGES;
  uint64_t* info_full = raw_full + RAW;
  uint64_t* info_empty = info_full + NSI;
  uint64_t* qbar = info_empty + NSI;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const long start = (long)split * rows_per_split;
  const long end = start + rows_per_split < n_scan ? start + rows_per_split : (long)n_scan;
  const int nslices = end > start ? static_cast<int>((end - start + NL - 1) / NL) : 0;
  const int sps = (nk + KPS - 1) / KPS;  // ring stages per slice

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);                  // producer thread 0 (with the TMA bytes)
      mbar_init(&empty[s], 4 * CONSUMERS);     // lane 0 of every consumer warp
    }
    for (int s = 0; s < RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < NSI; ++s) {
      mbar_init(&info_full[s], 1);
      mbar_init(&info_empty[s], 4 * CONSUMERS);
    }
    mbar_init(qbar, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * CONSUMERS) {
    // ==== producer warpgroup: its 128 threads walk the stages in step ====
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 128 * CONSUMERS;
    const int chunks = nslices * nk;

    // Unit u (16 bytes) of depth chunk kc of query row r of the tile; zeros past B.
    auto query_unit = [&](int kc, int r, int u) {
      const int q = q0 + r;
      return q < b ? load_unit<OT, OT>(xq + (long)q * d, kc * EPC + u * EPU, d, qvec != 0)
                   : make_uint4(0u, 0u, 0u, 0u);
    };

    // The resident query tile (a streamed one comes with the stages).
    if (qstream) {
      mbar_arrive(qbar);
    } else if ((CAN_TMA || CAN_CONVERT) && loader != REGISTERS) {
      if (pt == 0) {
        mbar_arrive_tx(qbar, nk * QCHUNK_BYTES);
        for (int kc = 0; kc < nk; ++kc) tma_load_2d(q_smem + kc * QCHUNK_BYTES, &qmap, qbar, kc * EPC, q0);
      } else {
        mbar_arrive(qbar);
      }
    } else {
      for (int idx = pt; idx < nk * QB * 8; idx += 128) {
        const int kc = idx / (QB * 8), r = (idx >> 3) % QB, u = idx & 7;
        *swizzled(q_smem + kc * QCHUNK_BYTES, r, u) = query_unit(kc, r, u);
      }
      fence_proxy_async();
      mbar_arrive(qbar);
    }

    // TMA_CONVERT: chunk g (slice-major) of the int8, f16 or f32 store into raw slot g % SLOTS.
    auto issue_raw = [&](int g) {
      const int s = g / nk, kc = g - s * nk, slot = g % SLOTS;
      mbar_arrive_tx(&raw_full[slot], RAW_BYTES);
      tma_load_2d(raw_smem + slot * RAW_BYTES, &xmap, &raw_full[slot], kc * (CHUNK / 2),
                  static_cast<int>(start + (long)s * NL));
    };
    if (CAN_CONVERT && loader == TMA_CONVERT && pt == 0)
      for (int g = 0; g < SLOTS && g < chunks; ++g) issue_raw(g);

    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < nslices * sps; ++g) {
      const int s = g / sps, k0 = (g - s * sps) * KPS;  // slice, first depth chunk
      const int kn = nk - k0 < KPS ? nk - k0 : KPS;      // depth chunks in this stage
      const long row0 = start + (long)s * NL;
      if (k0 == 0) {  // the slice's row factors, live flags and bias, for the epilogue
        const int slot = s % NSI;
        SliceInfo& si = info[slot];
        mbar_wait(&info_empty[slot], ((s / NSI) & 1) ^ 1);
        const long row = row0 + pt;
        const bool in = row < end;
        si.fac[pt] = scales != nullptr && in ? scales[row] : 1.f;
        si.live[pt] = in && (row_mask == nullptr || row_mask[row] != 0);
        if (pt < QB)
          si.bias[pt] = bias != nullptr && q0 + pt < b ? bias[(row0 / blk) * b + q0 + pt] : 0.f;
        producer_sync();
        if (pt == 0) mbar_arrive(&info_full[slot]);
      }
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* dst = x_smem + stage * stage_bytes;
      uint8_t* qdst = dst + STAGE_BYTES;  // a streamed query's chunks
      if (CAN_TMA && loader == TMA) {
        if (pt == 0) {  // rows past n_valid or B and depth past d arrive as zeros
          mbar_arrive_tx(&full[stage], kn * (CHUNK_BYTES + (qstream ? QCHUNK_BYTES : 0)));
          for (int j = 0; j < kn; ++j)
            tma_load_2d(dst + j * CHUNK_BYTES, &xmap, &full[stage], (k0 + j) * EPC, static_cast<int>(row0));
          if (qstream)
            for (int j = 0; j < kn; ++j)
              tma_load_2d(qdst + j * QCHUNK_BYTES, &qmap, &full[stage], (k0 + j) * EPC, q0);
        }
      } else {
        if (qstream)  // 512 units per query chunk, 4 per thread
          for (int j = 0; j < kn; ++j)
#pragma unroll
            for (int i = 0; i < QB * 8 / 128; ++i) {
              const int idx = i * 128 + pt, r = idx >> 3, u = idx & 7;
              *swizzled(qdst + j * QCHUNK_BYTES, r, u) = query_unit(k0 + j, r, u);
            }
        for (int j = 0; j < kn; ++j) {
          uint8_t* part = dst + j * CHUNK_BYTES;
          const int kc = k0 + j;
          if (CAN_CONVERT && loader == TMA_CONVERT) {
            const int gc = s * nk + kc, slot = gc % SLOTS;
            mbar_wait(&raw_full[slot], (gc / SLOTS) & 1);
            const uint8_t* raw = raw_smem + slot * RAW_BYTES;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int idx = i * 128 + pt, r = idx >> 3, u = idx & 7;
              const uint8_t* unit = raw + (r * (CHUNK / 2) + u * 8) * XS;  // 8 values of row r
              if constexpr (XS == 1) {
                const uint2 v = *reinterpret_cast<const uint2*>(unit);
                *swizzled(part, r, u) = int8x8_to_bf16(v.x, v.y);
              } else if constexpr (XS == 2) {  // f16 rows: rounds to bf16
                *swizzled(part, r, u) = half8_to_bf16(*reinterpret_cast<const uint4*>(unit));
              } else {  // rounds to bf16, as the reference casts the store
                const float4 a = *reinterpret_cast<const float4*>(unit);
                const float4 c = *reinterpret_cast<const float4*>(unit + 16);
                *swizzled(part, r, u) = make_uint4(bf16_bits(a.x) | (bf16_bits(a.y) << 16),
                                                   bf16_bits(a.z) | (bf16_bits(a.w) << 16),
                                                   bf16_bits(c.x) | (bf16_bits(c.y) << 16),
                                                   bf16_bits(c.z) | (bf16_bits(c.w) << 16));
              }
            }
          } else {
            // 1024 units per chunk, 8 per thread, in two batches of 4 loads.
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint4 v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int idx = (4 * h + i) * 128 + pt, r = idx >> 3, u = idx & 7;
                const long row = row0 + r;
                v[i] = row < n_scan ? load_unit<XT, OT>(xb + row * d, kc * EPC + u * EPU, d, xvec != 0)
                                    : make_uint4(0u, 0u, 0u, 0u);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int idx = (4 * h + i) * 128 + pt;
                *swizzled(part, idx >> 3, idx & 7) = v[i];
              }
            }
          }
        }
        fence_proxy_async();
        producer_sync();  // the whole stage is written (and the raw slots read)
        if (pt == 0) {
          mbar_arrive(&full[stage]);
          if (CAN_CONVERT && loader == TMA_CONVERT)
            for (int j = 0; j < kn; ++j)
              if (s * nk + k0 + j + SLOTS < chunks) issue_raw(s * nk + k0 + j + SLOTS);
        }
      }
      if (++stage == nst) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ==== consumer warpgroups: c owns lanes 64c .. 64c + 63 ====
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = tid >> 7;
    const int w = (tid >> 5) & 3;
    const int l = tid & 31;
    // Cell 4j + 2i + e of this thread: query 16w + l/4 + 8i, lane 64c + 8j + 2(l%4) + e.
    float best[32], sec[32];
    uint32_t pk[32];  // the best's and the second's slice in the split (NO_SLICE: none)
    Acc acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      best[i] = MASK_SCORE;
      sec[i] = MASK_SCORE;
      pk[i] = NO_SLICE | (NO_SLICE << 16);
      acc[i] = 0;
    }
    const uint32_t qa = smem_u32(q_smem);
    const uint32_t xa = smem_u32(x_smem);
    const bool has_scales = scales != nullptr, has_bias = bias != nullptr;
    mbar_wait(qbar, 0);

    // A stage goes back once the wgmma group that read it is done, one stage
    // behind the group just issued.
    int stage = 0, held = -1;
    uint32_t phase = 0;
    auto release = [&](int st) {
      if (l == 0) mbar_arrive(&empty[st]);
    };
    for (int s = 0; s < nslices; ++s) {
      for (int k0 = 0; k0 < nk; k0 += KPS) {
        mbar_wait(&full[stage], phase);
        fence_acc(acc);
        wgmma_fence();
        const uint32_t sa = xa + stage * stage_bytes;
#pragma unroll
        for (int j = 0; j < KPS; ++j) {
          const int kc = k0 + j;
          if (kc < nk) {
            const uint32_t qc = qstream ? sa + STAGE_BYTES + j * QCHUNK_BYTES : qa + kc * QCHUNK_BYTES;
#pragma unroll
            for (int kk = 0; kk < CHUNK / 32; ++kk) {
              const uint64_t da = sw128_desc(qc + kk * 32);
              const uint64_t db = sw128_desc(sa + c * HALF * CHUNK + j * CHUNK_BYTES + kk * 32);
              if constexpr (INT8_DOT) wgmma_s8(acc, da, db, kc | kk);
              else wgmma_bf16(acc, da, db, kc | kk);
            }
          }
        }
        wgmma_commit();
        fence_acc(acc);
        if (held >= 0) {  // the group before this one is done: its stage goes back
          wgmma_wait<1>();
          release(held);
        }
        held = stage;
        if (++stage == nst) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(held);
      held = -1;

      // Epilogue: scale, bias, mask, fold, in the accumulator's own layout.
      mbar_wait(&info_full[s % NSI], (s / NSI) & 1);
      const SliceInfo& si = info[s % NSI];
      float bq[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) bq[i] = si.bias[16 * w + (l >> 2) + 8 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * HALF + 8 * j + 2 * (l & 3);
        const float2 fac = *reinterpret_cast<const float2*>(&si.fac[col]);
        const uint32_t live = *reinterpret_cast<const uint16_t*>(&si.live[col]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            float v;
            if constexpr (INT8_DOT) v = __int2float_rn(acc[x]);
            else v = acc[x];
            if (has_scales) v = __fmul_rn(v, e ? fac.y : fac.x);
            if (has_bias) v = __fadd_rn(v, bq[i]);
            // A masked row scores MASK_SCORE, which never passes the strict '>'.
            fold((live >> (8 * e)) & 0xff ? v : MASK_SCORE, static_cast<uint32_t>(s), best[x], sec[x],
                 pk[x]);
          }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&info_empty[s % NSI]);
    }

    auto row_of = [&](uint32_t slice, int col) {
      return slice == NO_SLICE ? NO_HIT : static_cast<int>(start + (long)slice * NL + col);
    };
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + 16 * w + (l >> 2) + 8 * i;
      if (q >= b) continue;
      const long o = ((long)split * b + q) * (2 * NL);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * i;
        const int col = c * HALF + 8 * j + 2 * (l & 3);
        *reinterpret_cast<float2*>(&part_s[o + col]) = make_float2(best[x], best[x + 1]);
        *reinterpret_cast<float2*>(&part_s[o + NL + col]) = make_float2(sec[x], sec[x + 1]);
        *reinterpret_cast<int2*>(&part_i[o + col]) =
            make_int2(row_of(pk[x] & 0xFFFF, col), row_of(pk[x + 1] & 0xFFFF, col + 1));
        *reinterpret_cast<int2*>(&part_i[o + NL + col]) =
            make_int2(row_of(pk[x] >> 16, col), row_of(pk[x + 1] >> 16, col + 1));
      }
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

// ---- host side -------------------------------------------------------------

// TMA needs 16-byte aligned bases and row strides, of the queries and of the
// store.  It loads the operand stages itself when the store is of the
// operand type, and the raw rows of an int8, f16 or f32 store under bf16
// queries, which the producer converts; everything else goes through the
// producer's registers.  ops/flat_scan.py::kernel_variant states the same
// rules.
int pick_loader(const void* xq, const void* xb, int b, int d, int n_scan, int q_dtype, int x_dtype) {
  if (b <= 0 || n_scan <= 0 || !aligned(xq, 16) || !aligned(xb, 16)) return REGISTERS;
  if (q_dtype == x_dtype && q_dtype == I8 && d % 16 == 0) return TMA;
  if (q_dtype == x_dtype && q_dtype == BF16 && d % 8 == 0) return TMA;
  if (q_dtype == BF16 && x_dtype == I8 && d % 16 == 0) return TMA_CONVERT;
  if (q_dtype == BF16 && x_dtype == F32 && d % 8 == 0) return TMA_CONVERT;
  if (q_dtype == BF16 && x_dtype == F16 && d % 8 == 0) return TMA_CONVERT;
  return REGISTERS;
}

template <typename OT, typename XT>
int launch(const void* xq, const void* xb, const void* scales, const void* bias,
           const void* row_mask, void* part_s, void* part_i, int b, int d, int n_scan,
           int splits, int rows_per_split, int blk, int loader, int* streamed, cudaStream_t stream) {
  constexpr int OS = static_cast<int>(sizeof(OT)), XS = static_cast<int>(sizeof(XT));
  constexpr int EPC = CHUNK / OS;
  const int nk = (d + EPC - 1) / EPC;
  // The query tile stays resident when two stages fit beside it; else it streams.
  const int qstream = smem_fixed(nk, loader, XS) + 2 * STAGE_BYTES > SMEM_LIMIT;
  *streamed = qstream;
  const int fixed = smem_fixed(qstream ? 0 : nk, loader, XS);
  const int stage_bytes = STAGE_BYTES + (qstream ? KPS * QCHUNK_BYTES : 0);
  int nst = (SMEM_LIMIT - fixed) / stage_bytes;
  nst = nst < MAX_STAGES ? nst : MAX_STAGES;
  if (nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + nst * stage_bytes;
  auto kernel = scan_kernel<OT, XT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap = {}, xmap = {};
  if (loader != REGISTERS) {
    const bool ok =
        make_map(&qmap, xq, OS, d, b, CHUNK, QB, CU_TENSOR_MAP_SWIZZLE_128B) &&
        (loader == TMA ? make_map(&xmap, xb, OS, d, n_scan, CHUNK, NL, CU_TENSOR_MAP_SWIZZLE_128B)
                       : make_map(&xmap, xb, XS, d, n_scan, CHUNK / 2 * XS, NL, CU_TENSOR_MAP_SWIZZLE_NONE));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  // Vector loads in the register loader: every row start aligned for them.
  constexpr long XV = std::is_same_v<XT, int8_t> && !std::is_same_v<OT, int8_t> ? 8 : 16;
  const int qvec = (static_cast<long>(d) * OS) % 16 == 0 && aligned(xq, 16);
  const int xvec = (static_cast<long>(d) * sizeof(XT)) % XV == 0 && aligned(xb, XV);
  const dim3 grid((b + QB - 1) / QB, splits);
  kernel<<<grid, THREADS, smem, stream>>>(qmap, xmap, loader, static_cast<const OT*>(xq),
                                          static_cast<const XT*>(xb), static_cast<const float*>(scales),
                                          static_cast<const float*>(bias),
                                          static_cast<const int8_t*>(row_mask), static_cast<float*>(part_s),
                                          static_cast<int*>(part_i), b, d, n_scan, rows_per_split, blk, nk,
                                          nst, qstream, qvec, xvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 (scan, then merge) on `stream` and returns a cudaError_t (0 on
// success).  q_dtype / x_dtype: 0 = f32, 1 = bf16, 2 = int8, 3 = f16.  Pairs:
// (int8, int8) with the int8 dot; (bf16, int8), (bf16, bf16), (bf16, f32),
// (bf16, f16).  scales,
// bias and row_mask may be null.  part_s / part_i hold splits * b * 256
// values; rows_per_split and blk are multiples of 128, rows_per_split at most
// 65,535 slices of 128 rows, as lotus_flat_scan_plan gives them.  Any d > 0.
// For reports it writes how it loaded the store into *loader (0 through the
// producer's registers, 1 by TMA, 2 by TMA as raw rows converted to bf16 in
// shared memory) and into *streamed whether the query tile streamed with the
// stages (1) or stayed resident (0).
int lotus_flat_scan(const void* xq, const void* xb, const void* scales, const void* bias,
                    const void* row_mask, void* part_s, void* part_i, void* out_s, void* out_i,
                    int b, int d, int n_scan, int splits, int rows_per_split, int blk,
                    int q_dtype, int x_dtype, void* stream, int* loader, int* streamed) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *loader = pick_loader(xq, xb, b, d, n_scan, q_dtype, x_dtype);
  *streamed = 0;
  if (b <= 0) return 0;
  if (splits <= 0 || rows_per_split <= 0 || rows_per_split % NL != 0 ||
      rows_per_split / NL > MAX_SLICES || blk <= 0 || blk % NL != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = *loader;
  int code;
  if (q_dtype == I8 && x_dtype == I8)
    code = launch<int8_t, int8_t>(xq, xb, scales, bias, row_mask, part_s, part_i, b, d, n_scan,
                                  splits, rows_per_split, blk, ld, streamed, s);
  else if (q_dtype == BF16 && x_dtype == I8)
    code = launch<__nv_bfloat16, int8_t>(xq, xb, scales, bias, row_mask, part_s, part_i, b, d,
                                         n_scan, splits, rows_per_split, blk, ld, streamed, s);
  else if (q_dtype == BF16 && x_dtype == BF16)
    code = launch<__nv_bfloat16, __nv_bfloat16>(xq, xb, scales, bias, row_mask, part_s, part_i, b,
                                                d, n_scan, splits, rows_per_split, blk, ld, streamed, s);
  else if (q_dtype == BF16 && x_dtype == F32)
    code = launch<__nv_bfloat16, float>(xq, xb, scales, bias, row_mask, part_s, part_i, b, d,
                                        n_scan, splits, rows_per_split, blk, ld, streamed, s);
  else if (q_dtype == BF16 && x_dtype == F16)
    code = launch<__nv_bfloat16, __half>(xq, xb, scales, bias, row_mask, part_s, part_i, b, d,
                                         n_scan, splits, rows_per_split, blk, ld, streamed, s);
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
// block is resident per SM (one warpgroup of fold state per 64 lanes fills
// the registers), so the grid covers at least two waves of the SMs; among up
// to twice that many splits it takes the one whose last wave is fullest (the
// fewest on a tie).  The query tile is the grid's fastest index, so the
// blocks that share a split run together and L2 serves their repeats.
void lotus_flat_scan_plan(int b, int n_scan, int sms, int* splits, int* rows_per_split) {
  const long tiles = (b + QB - 1) / QB > 0 ? (b + QB - 1) / QB : 1;
  const long slots = sms > 0 ? sms : 1;
  const long slices = n_scan > NL ? (n_scan + NL - 1) / NL : 1;
  const long want = (2 * slots + tiles - 1) / tiles;
  const long lo = want < slices ? want : slices;
  const long hi = 2 * lo < slices ? 2 * lo : slices;
  long pick = lo;
  double pick_fill = -1.0;
  for (long s = lo; s <= hi; ++s) {
    const long blocks = tiles * s;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > pick_fill) {
      pick_fill = fill;
      pick = s;
    }
  }
  long per_split = (slices + pick - 1) / pick;
  if (per_split > MAX_SLICES) per_split = MAX_SLICES;
  *splits = static_cast<int>((slices + per_split - 1) / per_split);
  *rows_per_split = static_cast<int>(per_split * NL);
}

}  // extern "C"
