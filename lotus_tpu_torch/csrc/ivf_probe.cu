// K1: the grouped IVF probe kernel for Hopper (sm_90a).
//
// Replaces lotus_tpu/ops/pallas_ivf.py::_probe_kernel (with its folds
// _bucket_pack_accum, _bucket_top2_accum and _bucket_top1_accum and the mask
// _slice_mask).  ops/ivf_probe.py::probe_fold is its wrapper and
// probe_fold_reference its plain PyTorch version.
//
// What it computes.  One thread block owns one (probed list, chunk of
// QU = 128 query slots) and walks the list's live rows in 64-row slices.
// Block-aligned storage keeps a list's blocks contiguous and only its last
// block partial, so slice s covers list rows 64 s .. 64 s + 63, and slices
// wholly past the list's size are never read.  For each slice it forms the
// (128 x 64) scores
//   int8 x int8 -> int32 (exact)         when the queries and rows are int8
//   bf16 x bf16 -> f32 sums              bf16 queries on bf16 or int8 rows
//   f32 x f32 -> f32 (FMA)               f32 queries on f32 or f16 rows
// multiplies them by the row scales (int8 rows), forms 2*dot - |x|^2 (l2),
// masks columns at or past the list's size, and folds them into a top-2
// (or, under the top-1 fold, a top-1) per (query slot, lane): lane j of a
// list holds its rows {j + 64 i}.  PACKED writes the list-local row id into
// the low 13 mantissa bits and folds with fmaxf/fminf on the floats; the
// unpacked fold keeps (score, global storage row) pairs with a strict '>' in
// slice order, so ties go to the earlier row.  Output: (grid, 128, NC) f32
// [+ int32], NC = 128 (best in columns 0..63, second in 64..127) or 64
// (top-1); blocks whose chunk-table entry is -1, and empty lists, write
// MASK_SCORE (ids 0).
//
// The TPU version needs a sequential grid so that one chunk's output stays
// resident across units; that is why it carries a 'first' flag, a packed
// SMEM scalar table and parked units.  Here the fold state of a whole list
// lives in registers for the block's lifetime, and none of the three exist.
//
// What bounds it on this card.  Each probed list is streamed once per
// 128-slot chunk: at the config-4 shape (int8 rows and queries, d 768) a
// 64-row slice is 48 KB of rows against 6.3e6 int8 MACs, 256 operations a
// byte, under the card's ridge of about 590 (1,979 TOP/s over 3.35 TB/s), so
// the list bytes from HBM bound it, with L2 serving the chunks of one list
// that run side by side (their blocks are adjacent in the grid).  The design
// (probe_wgmma):
// - A block is three warpgroups: two consumers and one producer.  setmaxnreg
//   moves registers from the producer (56) to the consumers (224).
// - Consumer c owns query slots 64c .. 64c + 63 and both consume the same
//   64-row store slice: wgmma m64n64k32 (s8 -> s32) or m64n64k16 (bf16 ->
//   f32) over the depth.  Accumulator column n is then exactly lane n, and a
//   thread always holds the same 32 (slot, lane) cells, so the fold state
//   stays in that thread's registers for the whole list with no shuffles.
// - The query tile (128 x d, the A operand, K-major) stays resident in
//   shared memory when two ring stages fit beside it (int8 to d 1280, bf16
//   to d 640; 96 KB at d 768 in int8).  Past that (bf16 at d 768: 192 KB)
//   each stage also carries the query's depth chunks after the store's,
//   loaded by TMA from L2 with the store's.
// - The store (the B operand, K-major) streams through a ring of stages of
//   64 rows x up to a whole slice's depth chunks of 128 bytes (48 KB at d 768
//   in int8), fed by TMA under mbarrier full / empty pairs: one handshake a
//   slice, since a handshake costs about 270 cycles on this card.  All tiles
//   use the 128-byte swizzle.  bf16 queries on int8 rows load the raw rows by
//   TMA into a small ring, and the producer converts them to bf16 exactly in
//   shared memory (hopper.cuh's int8x8_to_bf16), as K2 does.
// - The producer brings each slice's 64 row scales (and norms, for l2) by a
//   bulk copy into a 4-slot ring in shared memory beside the stages, so the
//   epilogue loads nothing from device memory.  Loaded from L2 in the
//   epilogue instead, the scales' latency cost about 2 ms of 5.4 per
//   config-4 slice (tools_torch/k1_variants.py).
// - The epilogue (convert, scale, l2, mask, fold) is branch-free and runs in
//   the accumulator's own register layout after each slice's wgmma.
// - The grid is the static bound P / QU + nlist + 1 with no host sync;
//   blocks of dead chunks write MASK_SCORE and exit before any barrier.
//
// Two cases stay on the CUDA cores (probe_cores, the first design):
// - f32 queries, on f32 or f16 rows.  The reference runs them at
//   Precision.HIGHEST (pallas_ivf.py:283-286; an f16 store keeps f32
//   queries, :373-376, and the kernel casts its rows to f32, :282), and the
//   tensor cores' TF32 would round the operands, so the products are f32
//   FMAs; f16 rows convert to f32 exactly in the loader.
// - Rows TMA cannot describe: a row stride or base that is not a multiple of
//   16 bytes (int8 rows with d % 16 != 0, bf16 rows with d % 8 != 0).
// probe_cores keeps the depth tiled in padded shared memory (128 int8 or 32
// float values a tile), an 8 x 4 register tile per thread, and __dp4a for
// the int8 dot.  At d % 4 != 0 an int8 row does not start on a 32-bit word,
// so its words are assembled byte by byte, zero past d: the int32 sums stay
// exact at any depth.
//
// Build without --use_fast_math or -ftz=true: a score of exactly +-0 packs
// into a denormal that carries the id.  The epilogues use __fmul_rn and
// __fsub_rn so the scale multiply and 2*s - |x|^2 round as the reference
// does (no FMA contraction).

#include <stdint.h>

#include <type_traits>

#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr int QU = 128;  // query slots per chunk
constexpr int NBK = 64;  // candidate lanes (512 / BUCKET), rows per slice
constexpr int LOCAL_MASK = (1 << 13) - 1;
constexpr float MASK_SCORE = -3.0e38f;

enum DType { F32 = 0, BF16 = 1, I8 = 2, F16 = 3 };
// How K1 ran, reported to the wrapper: on the CUDA cores, or on the tensor
// cores with the store loaded by TMA, or by TMA as raw int8 rows converted
// to bf16 in shared memory.
enum Route { CORES = 0, TMA = 1, TMA_CONVERT = 2 };

// ---- probe_wgmma: the tensor-core kernel -----------------------------------

constexpr int CHUNK = 128;                 // bytes of depth per chunk (one 128-byte swizzle row)
constexpr int XCHUNK_BYTES = NBK * CHUNK;  // 8 KB: one slice x one depth chunk of the store
constexpr int QCHUNK_BYTES = QU * CHUNK;   // 16 KB: one depth chunk of the query tile
constexpr int HALF_Q_BYTES = 64 * CHUNK;   // a consumer's 64 slots of a query chunk
constexpr int MAX_STAGES = 4;
constexpr int KPS_MAX = 8;                  // depth chunks a stage, at most (the consumer's switch)
constexpr int RAW = 4;                      // raw int8 chunk slots of the converting loader
constexpr int RAW_BYTES = NBK * CHUNK / 2;  // 4 KB: 64 rows x 64 int8 values (one bf16 chunk)
constexpr int CONSUMERS = 2;
constexpr int TC_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 2 * 128 * 224 + 128 * 56 = 64,512 <= 65,536
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have on sm_90
constexpr int NSI = 4;                      // slice-info ring depth
constexpr int INFO_SLOT = 2 * NBK * 4;      // a slice's 64 row scales, then its 64 norms
constexpr int INFO_BYTES = NSI * INFO_SLOT;
constexpr int BAR_BYTES = 8 * (2 * MAX_STAGES + RAW + 2 * NSI + 1);
constexpr uint32_t NO_SLICE = 0xFFFFFFFFu;

// The wgmma of one stage: N depth chunks of the query (at qc, 16 KB apart)
// against the store's (at sa, 8 KB apart), four k-steps of 32 bytes each.
// A fixed N keeps the sequence free of branches, so ptxas inserts no
// warpgroup.arrive between the instructions.  `first`: the stage opens the
// slice, whose first product overwrites the accumulators.
template <int N, bool INT8_DOT, typename Acc>
__device__ __forceinline__ void stage_mma(Acc (&acc)[32], uint32_t qc, uint32_t sa, bool first) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int kk = 0; kk < CHUNK / 32; ++kk) {
      const uint64_t da = sw128_desc(qc + j * QCHUNK_BYTES + kk * 32);
      const uint64_t db = sw128_desc(sa + j * XCHUNK_BYTES + kk * 32);
      const int scale_d = first && j == 0 && kk == 0 ? 0 : 1;
      if constexpr (INT8_DOT) wgmma_s8(acc, da, db, scale_d);
      else wgmma_bf16(acc, da, db, scale_d);
    }
}

// OT: the operand type (int8 for the int8 dot, else bf16); XT: the rows'
// type (int8 rows under bf16 queries are converted).  nk depth chunks of 128
// bytes, kps of them a stage, nst stages; qstream: the query tile streams
// with the stages instead of staying resident.
template <typename OT, typename XT, bool PACKED, bool TOP1>
__global__ void __launch_bounds__(TC_THREADS, 1) probe_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ scales, const float* __restrict__ norms,
    const int* __restrict__ chunk_list, const int* __restrict__ list_start,
    const int* __restrict__ list_size, float* __restrict__ out_s, int* __restrict__ out_i, int nk,
    int kps, int nst, int qstream, int l2) {
  constexpr bool INT8_DOT = std::is_same_v<OT, int8_t>;
  constexpr bool CONVERT = !std::is_same_v<OT, XT>;
  constexpr bool DEQUANT = std::is_same_v<XT, int8_t>;
  constexpr int NC = TOP1 ? NBK : 2 * NBK;
  constexpr int EPC = CHUNK / static_cast<int>(sizeof(OT));  // depth values per chunk
  using Acc = std::conditional_t<INT8_DOT, int, float>;

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int lid = chunk_list[c];
  const int size = lid >= 0 ? list_size[lid] : 0;
  float* os = out_s + (long)c * QU * NC;
  int* oi = PACKED ? nullptr : out_i + (long)c * QU * NC;
  if (size <= 0) {  // a dead chunk or an empty list
    for (int o = tid; o < QU * NC; o += TC_THREADS) {
      os[o] = MASK_SCORE;
      if constexpr (!PACKED) oi[o] = 0;
    }
    return;
  }
  const long start = list_start[lid];
  const int nslices = (size + NBK - 1) / NBK;
  const int sps = (nk + kps - 1) / kps;  // ring stages per slice
  const int stage_bytes = kps * (XCHUNK_BYTES + (qstream ? QCHUNK_BYTES : 0));

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* q_smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* x_smem = q_smem + (qstream ? 0 : nk * QCHUNK_BYTES);
  uint8_t* raw_smem = x_smem + nst * stage_bytes;
  uint8_t* info_smem = raw_smem + (CONVERT ? RAW * RAW_BYTES : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(info_smem + INFO_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* raw_full = empty + MAX_STAGES;
  uint64_t* info_full = raw_full + RAW;
  uint64_t* info_empty = info_full + NSI;
  uint64_t* qbar = info_empty + NSI;
  // The slice infos: its row scales (int8 rows) and norms (l2).
  const bool has_info = DEQUANT || l2;
  const uint32_t info_bytes = (DEQUANT ? NBK * 4 : 0) + (l2 ? NBK * 4 : 0);

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);               // producer thread 0 (with the TMA bytes)
      mbar_init(&empty[s], 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < NSI; ++s) {
      mbar_init(&info_full[s], 1);               // producer thread 0 (with the copy's bytes)
      mbar_init(&info_empty[s], 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * CONSUMERS) {
    // ==== producer warpgroup ====
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 128 * CONSUMERS;
    const int qrow = c * QU;
    const int chunks = nslices * nk;
    if (!qstream && pt == 0) {  // the resident query tile
      mbar_arrive_tx(qbar, nk * QCHUNK_BYTES);
      for (int kc = 0; kc < nk; ++kc) tma_load_2d(q_smem + kc * QCHUNK_BYTES, &qmap, qbar, kc * EPC, qrow);
    }
    // CONVERT: raw chunk g (slice-major) of int8 rows into slot g % RAW.
    auto issue_raw = [&](int g) {
      const int s = g / nk, kc = g - s * nk, slot = g % RAW;
      mbar_arrive_tx(&raw_full[slot], RAW_BYTES);
      tma_load_2d(raw_smem + slot * RAW_BYTES, &xmap, &raw_full[slot], kc * (CHUNK / 2),
                  static_cast<int>(start + (long)s * NBK));
    };
    if (CONVERT && pt == 0)
      for (int g = 0; g < RAW && g < chunks; ++g) issue_raw(g);

    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < nslices * sps; ++g) {
      const int s = g / sps, k0 = (g - s * sps) * kps;  // slice, first depth chunk
      const int kn = nk - k0 < kps ? nk - k0 : kps;      // depth chunks in this stage
      const int row0 = static_cast<int>(start + (long)s * NBK);
      const uint32_t qbytes = qstream ? kn * QCHUNK_BYTES : 0;
      if (has_info && k0 == 0 && pt == 0) {  // the slice's scales and norms, by bulk copy
        const int slot = s % NSI;
        uint8_t* si = info_smem + slot * INFO_SLOT;
        mbar_wait(&info_empty[slot], ((s / NSI) & 1) ^ 1);
        mbar_arrive_tx(&info_full[slot], info_bytes);
        if (DEQUANT) bulk_load(si, scales + row0, NBK * 4, &info_full[slot]);
        if (l2) bulk_load(si + NBK * 4, norms + row0, NBK * 4, &info_full[slot]);
      }
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* dst = x_smem + stage * stage_bytes;
      uint8_t* qdst = dst + kps * XCHUNK_BYTES;  // a streamed query's chunks
      auto load_query = [&]() {
        for (int j = 0; j < kn; ++j)
          tma_load_2d(qdst + j * QCHUNK_BYTES, &qmap, &full[stage], (k0 + j) * EPC, qrow);
      };
      if constexpr (!CONVERT) {
        if (pt == 0) {  // rows past the store and depth past d arrive as zeros
          mbar_arrive_tx(&full[stage], kn * XCHUNK_BYTES + qbytes);
          for (int j = 0; j < kn; ++j)
            tma_load_2d(dst + j * XCHUNK_BYTES, &xmap, &full[stage], (k0 + j) * EPC, row0);
          if (qstream) load_query();
        }
      } else {
        for (int j = 0; j < kn; ++j) {
          const int gc = s * nk + k0 + j, slot = gc % RAW;
          mbar_wait(&raw_full[slot], (gc / RAW) & 1);
          const uint8_t* raw = raw_smem + slot * RAW_BYTES;
          uint8_t* part = dst + j * XCHUNK_BYTES;
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // 512 units of 8 values, 4 per thread
            const int idx = i * 128 + pt, r = idx >> 3, u = idx & 7;
            const uint2 v = *reinterpret_cast<const uint2*>(raw + r * (CHUNK / 2) + u * 8);
            *swizzled(part, r, u) = int8x8_to_bf16(v.x, v.y);
          }
        }
        fence_proxy_async();
        producer_sync();  // the stage's rows are written and its raw slots read
        if (pt == 0) {
          if (qstream) {
            mbar_arrive_tx(&full[stage], qbytes);
            load_query();
          } else {
            mbar_arrive(&full[stage]);
          }
          for (int j = 0; j < kn; ++j)
            if (s * nk + k0 + j + RAW < chunks) issue_raw(s * nk + k0 + j + RAW);
        }
      }
      if (++stage == nst) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ==== consumer warpgroups: c owns query slots 64c .. 64c + 63 ====
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int l = tid & 31;
  // Cell 4j + 2i + e of this thread: slot 64cw + 16w + l/4 + 8i, lane 8j + 2(l%4) + e.
  float best[32], sec[TOP1 ? 1 : 32];
  uint32_t bs[PACKED ? 1 : 32], ss[PACKED || TOP1 ? 1 : 32];  // slices of the unpacked fold
  Acc acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    best[x] = MASK_SCORE;
    if constexpr (!TOP1) sec[x] = MASK_SCORE;
    if constexpr (!PACKED) bs[x] = NO_SLICE;
    if constexpr (!PACKED && !TOP1) ss[x] = NO_SLICE;
    acc[x] = 0;
  }
  const uint32_t qa = smem_u32(q_smem) + cw * HALF_Q_BYTES;
  const uint32_t xa = smem_u32(x_smem);
  if (!qstream) mbar_wait(qbar, 0);

  // A stage goes back once the wgmma group that read it is done, one stage
  // behind the group just issued.
  int stage = 0, held = -1;
  uint32_t phase = 0;
  auto release = [&](int st) {
    if (l == 0) mbar_arrive(&empty[st]);
  };
  for (int s = 0; s < nslices; ++s) {
    for (int k0 = 0; k0 < nk; k0 += kps) {
      const int kn = nk - k0 < kps ? nk - k0 : kps;
      mbar_wait(&full[stage], phase);
      fence_acc(acc);
      wgmma_fence();
      const uint32_t sa = xa + stage * stage_bytes;
      // A streamed query's chunk j follows the store's in the stage.
      const uint32_t q0 = qstream ? sa + kps * XCHUNK_BYTES + cw * HALF_Q_BYTES : qa + k0 * QCHUNK_BYTES;
      switch (kn) {  // straight-line wgmma for each stage width
#define LOTUS_STAGE(N) \
  case N:              \
    stage_mma<N, INT8_DOT>(acc, q0, sa, k0 == 0);  \
    break;
        LOTUS_STAGE(1) LOTUS_STAGE(2) LOTUS_STAGE(3) LOTUS_STAGE(4)
        LOTUS_STAGE(5) LOTUS_STAGE(6) LOTUS_STAGE(7) LOTUS_STAGE(8)
#undef LOTUS_STAGE
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

    // Epilogue: scale, l2, mask, fold, in the accumulator's own layout.
    const long row0 = start + (long)s * NBK;
    const int base = s * NBK;  // the slice's first column in the list
    const float* si = reinterpret_cast<const float*>(info_smem + (s % NSI) * INFO_SLOT);
    if (has_info) mbar_wait(&info_full[s % NSI], (s / NSI) & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (l & 3);
      float2 fac = make_float2(1.f, 1.f), nm = make_float2(0.f, 0.f);
      if constexpr (DEQUANT) fac = *reinterpret_cast<const float2*>(si + col);
      if (l2) nm = *reinterpret_cast<const float2*>(si + NBK + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          float v;
          if constexpr (INT8_DOT) v = __int2float_rn(acc[x]);
          else v = acc[x];
          if constexpr (DEQUANT) v = __fmul_rn(v, e ? fac.y : fac.x);
          if (l2) v = __fsub_rn(__fmul_rn(2.f, v), e ? nm.y : nm.x);
          const int local = base + col + e;
          const bool ok = local < size;
          if constexpr (PACKED) {
            const float pk = ok ? __int_as_float((__float_as_int(v) & ~LOCAL_MASK) | local) : MASK_SCORE;
            if constexpr (TOP1) {
              best[x] = fmaxf(best[x], pk);
            } else {
              const float nb = fmaxf(best[x], pk);
              sec[x] = fmaxf(sec[x], fminf(best[x], pk));
              best[x] = nb;
            }
          } else {
            // A masked column scores MASK_SCORE, which never passes the strict '>'.
            const float sv = ok ? v : MASK_SCORE;
            const bool over_best = sv > best[x];
            if constexpr (!TOP1) {
              const bool over_sec = sv > sec[x];
              ss[x] = over_best ? bs[x] : (over_sec ? static_cast<uint32_t>(s) : ss[x]);
              sec[x] = over_best ? best[x] : (over_sec ? sv : sec[x]);
            }
            bs[x] = over_best ? static_cast<uint32_t>(s) : bs[x];
            best[x] = over_best ? sv : best[x];
          }
        }
    }
    if (has_info) {
      __syncwarp();
      if (l == 0) mbar_arrive(&info_empty[s % NSI]);
    }
  }

  auto row_of = [&](uint32_t slice, int col) {
    return slice == NO_SLICE ? 0 : static_cast<int>(start + (long)slice * NBK + col);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = 64 * cw + 16 * w + (l >> 2) + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = 4 * j + 2 * i;
      const int col = 8 * j + 2 * (l & 3);
      const long o = (long)slot * NC + col;
      *reinterpret_cast<float2*>(&os[o]) = make_float2(best[x], best[x + 1]);
      if constexpr (!TOP1) *reinterpret_cast<float2*>(&os[o + NBK]) = make_float2(sec[x], sec[x + 1]);
      if constexpr (!PACKED) {
        *reinterpret_cast<int2*>(&oi[o]) = make_int2(row_of(bs[x], col), row_of(bs[x + 1], col + 1));
        if constexpr (!TOP1)
          *reinterpret_cast<int2*>(&oi[o + NBK]) = make_int2(row_of(ss[x], col), row_of(ss[x + 1], col + 1));
      }
    }
  }
}

// ---- probe_cores: the CUDA-core kernel -------------------------------------

constexpr int THREADS = 256;
constexpr int TQ = 8;   // query slots per thread: tq + 16 i
constexpr int TL = 4;   // lanes per thread: tl + 16 m
constexpr int KT = 32;  // 32-bit words (int8: 128 values) or floats per depth tile
constexpr int LD = KT + 1;  // padded row stride in shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// 32-bit word k (int8 values 4k .. 4k + 3) of a d-long int8 row, zero past
// d: one load when rows are whole words (`words`: d % 4 == 0 and a 4-byte
// aligned base), else byte by byte.
__device__ __forceinline__ uint32_t int8_word(const int8_t* row, int k, int d, bool words) {
  if (words) return reinterpret_cast<const uint32_t*>(row)[k];
  uint32_t w = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * k + e < d) w |= static_cast<uint32_t>(static_cast<uint8_t>(row[4 * k + e])) << (8 * e);
  return w;
}

template <typename QT, typename XT, bool INT8_DOT, bool DEQUANT, bool PACKED>
__global__ void __launch_bounds__(THREADS, 2) probe_cores(
    const QT* __restrict__ xq, const XT* __restrict__ xb,
    const float* __restrict__ scales, const float* __restrict__ norms,
    const int* __restrict__ chunk_list, const int* __restrict__ list_start,
    const int* __restrict__ list_size, float* __restrict__ out_s, int* __restrict__ out_i,
    int d, int bl, int l2, int top1) {
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
    // int8 operands are read as 32-bit words of four values (the last one
    // zero-padded past d).
    const int dk = INT8_DOT ? (d + 3) / 4 : d;
    const bool words = d % 4 == 0;
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
            const int8_t* qp = reinterpret_cast<const int8_t*>(xq) + (long)c * QU * d;
            const int8_t* xp = reinterpret_cast<const int8_t*>(xb) + row0 * d;
            for (int idx = tid; idx < QU * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              smem[r * LD + cc] = k < dk ? int8_word(qp + (long)r * d, k, d, words) : 0u;
            }
            for (int idx = tid; idx < NBK * KT; idx += THREADS) {
              const int r = idx / KT, cc = idx % KT, k = k0 + cc;
              smem[(QU + r) * LD + cc] = k < dk ? int8_word(xp + (long)r * d, k, d, words) : 0u;
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
          const float nm = l2 ? norms[row] : 0.f;
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            float v = INT8_DOT ? __int2float_rn(acc_i[i][m]) : acc_f[i][m];
            if (DEQUANT) v = __fmul_rn(v, sc);
            if (l2) v = __fsub_rn(__fmul_rn(2.f, v), nm);
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

  // The top-1 fold keeps the best of the top-2 state and writes 64 columns.
  const int nc = top1 ? NBK : 2 * NBK;
  float* os = out_s + (long)c * QU * nc;
  int* oi = PACKED ? nullptr : out_i + (long)c * QU * nc;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int m = 0; m < TL; ++m) {
      const int o = (tq + 16 * i) * nc + tl + 16 * m;
      os[o] = best[i][m];
      if (!top1) os[o + NBK] = sec[i][m];
      if constexpr (!PACKED) {
        oi[o] = best_i[i][m];
        if (!top1) oi[o + NBK] = sec_i[i][m];
      }
    }
}

// ---- host side -------------------------------------------------------------

struct Args {
  const void *xq, *xb, *scales, *norms, *chunk_list, *list_start, *list_size;
  void *out_s, *out_i;
  int grid, d, bl, q_rows, n_rows, l2;
  cudaStream_t stream;
};

// The tensor cores take the int8 dot and bf16 queries on bf16 or int8 rows
// when TMA can describe both operands (16-byte aligned bases and row
// strides) and the bulk copies of scales and norms (16-byte aligned bases).
int pick_route(const Args& a, int q_dtype, int x_dtype, int int8_dot) {
  const int d = a.d;
  if (a.q_rows <= 0 || a.n_rows <= 0 || !aligned(a.xq, 16) || !aligned(a.xb, 16) || !aligned(a.scales, 16) ||
      !aligned(a.norms, 16))
    return CORES;
  if (int8_dot) return d % 16 == 0 ? TMA : CORES;
  if (q_dtype == BF16 && x_dtype == BF16) return d % 8 == 0 ? TMA : CORES;
  if (q_dtype == BF16 && x_dtype == I8) return d % 16 == 0 ? TMA_CONVERT : CORES;
  return CORES;  // f32: full-precision FMAs
}


template <typename OT, typename XT, bool PACKED, bool TOP1>
int launch_wgmma(const Args& a, int route, int* streamed) {
  constexpr int OS = static_cast<int>(sizeof(OT));
  constexpr int EPC = CHUNK / OS;
  const int nk = (a.d + EPC - 1) / EPC;
  const int fixed0 = 1024 + (route == TMA_CONVERT ? RAW * RAW_BYTES : 0) + INFO_BYTES + BAR_BYTES;
  // The query tile stays resident when two stages of up to four chunks fit beside it.
  const int min_k = nk < 4 ? nk : 4;
  const int qstream = fixed0 + nk * QCHUNK_BYTES + 2 * min_k * XCHUNK_BYTES > SMEM_LIMIT;
  *streamed = qstream;
  const int avail = SMEM_LIMIT - fixed0 - (qstream ? 0 : nk * QCHUNK_BYTES);
  const int cb = XCHUNK_BYTES + (qstream ? QCHUNK_BYTES : 0);  // ring bytes per depth chunk
  // The fewest stages a slice such that two stages fit: every stage costs a handshake.
  int sps = 1;
  while ((nk + sps - 1) / sps > KPS_MAX || 2 * ((nk + sps - 1) / sps) * cb > avail) ++sps;
  const int kps = (nk + sps - 1) / sps;
  int nst = avail / (kps * cb);
  nst = nst < MAX_STAGES ? nst : MAX_STAGES;
  const int smem = SMEM_LIMIT - avail + nst * kps * cb;
  auto kernel = probe_wgmma<OT, XT, PACKED, TOP1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qmap = {}, xmap = {};
  const bool ok =
      make_map(&qmap, a.xq, OS, a.d, a.q_rows, CHUNK, QU, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (route == TMA ? make_map(&xmap, a.xb, OS, a.d, a.n_rows, CHUNK, NBK, CU_TENSOR_MAP_SWIZZLE_128B)
                    : make_map(&xmap, a.xb, 1, a.d, a.n_rows, CHUNK / 2, NBK, CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<a.grid, TC_THREADS, smem, a.stream>>>(
      qmap, xmap, static_cast<const float*>(a.scales), static_cast<const float*>(a.norms),
      static_cast<const int*>(a.chunk_list), static_cast<const int*>(a.list_start),
      static_cast<const int*>(a.list_size), static_cast<float*>(a.out_s), static_cast<int*>(a.out_i),
      nk, kps, nst, qstream, a.l2);
  return static_cast<int>(cudaGetLastError());
}

template <typename OT, typename XT>
int wgmma_variant(const Args& a, int packed, int top1, int route, int* streamed) {
  if (packed && top1) return launch_wgmma<OT, XT, true, true>(a, route, streamed);
  if (packed) return launch_wgmma<OT, XT, true, false>(a, route, streamed);
  if (top1) return launch_wgmma<OT, XT, false, true>(a, route, streamed);
  return launch_wgmma<OT, XT, false, false>(a, route, streamed);
}

template <typename QT, typename XT, bool INT8_DOT, bool DEQUANT>
int cores_variant(const Args& a, int packed, int top1) {
  auto run = [&](auto kernel) {
    kernel<<<a.grid, THREADS, 0, a.stream>>>(
        static_cast<const QT*>(a.xq), static_cast<const XT*>(a.xb), static_cast<const float*>(a.scales),
        static_cast<const float*>(a.norms), static_cast<const int*>(a.chunk_list),
        static_cast<const int*>(a.list_start), static_cast<const int*>(a.list_size),
        static_cast<float*>(a.out_s), static_cast<int*>(a.out_i), a.d, a.bl, a.l2, top1);
  };
  if (packed) run(probe_cores<QT, XT, INT8_DOT, DEQUANT, true>);
  else run(probe_cores<QT, XT, INT8_DOT, DEQUANT, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns a cudaError_t (0 on success).
// q_dtype / x_dtype: 0 = f32, 1 = bf16, 2 = int8, 3 = f16.  Supported
// pairs: (int8, int8) with int8_dot and no l2, at any d; (bf16, int8);
// (bf16, bf16); (f32, f32); (f32, f16).  ops/ivf_probe.py::kernel_variant
// states the same rules.
// q_rows / n_rows: the rows of xq and xb.  top1: the top-1 fold (64 output
// columns) instead of the top-2 (128).  For reports it writes how K1 ran
// into *route (0 on the CUDA cores, 1 on the tensor cores with the store
// loaded by TMA, 2 likewise with raw int8 rows converted to bf16 in shared
// memory) and into *streamed whether the query tile streamed with the
// stages (1) or stayed resident (0).
int lotus_ivf_probe(const void* xq, const void* xb, const void* scales, const void* norms,
                    const void* chunk_list, const void* list_start, const void* list_size,
                    void* out_s, void* out_i, int grid, int d, int bl, int q_rows, int n_rows,
                    int q_dtype, int x_dtype, int int8_dot, int l2, int packed, int top1, void* stream,
                    int* route, int* streamed) {
  const Args a{xq, xb, scales, norms, chunk_list, list_start, list_size, out_s, out_i,
               grid, d, bl, q_rows, n_rows, l2, static_cast<cudaStream_t>(stream)};
  *route = pick_route(a, q_dtype, x_dtype, int8_dot);
  *streamed = 0;
  if (grid <= 0) return 0;
  if (bl <= 0 || bl % NBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (int8_dot) {
    if (q_dtype != I8 || x_dtype != I8 || l2) return static_cast<int>(cudaErrorInvalidValue);
    if (*route == TMA) return wgmma_variant<int8_t, int8_t>(a, packed, top1, TMA, streamed);
    return cores_variant<int8_t, int8_t, true, true>(a, packed, top1);
  }
  if (q_dtype == BF16 && x_dtype == I8) {
    if (*route == TMA_CONVERT) return wgmma_variant<__nv_bfloat16, int8_t>(a, packed, top1, TMA_CONVERT, streamed);
    return cores_variant<__nv_bfloat16, int8_t, false, true>(a, packed, top1);
  }
  if (q_dtype == BF16 && x_dtype == BF16) {
    if (*route == TMA) return wgmma_variant<__nv_bfloat16, __nv_bfloat16>(a, packed, top1, TMA, streamed);
    return cores_variant<__nv_bfloat16, __nv_bfloat16, false, false>(a, packed, top1);
  }
  if (q_dtype == F32 && x_dtype == F32) return cores_variant<float, float, false, false>(a, packed, top1);
  if (q_dtype == F32 && x_dtype == F16) return cores_variant<float, __half, false, false>(a, packed, top1);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lotus_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
