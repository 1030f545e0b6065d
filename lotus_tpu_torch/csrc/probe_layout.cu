// K5: the grouped probe's layout stage for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference builds K1's inputs with XLA ops
// before its probe kernel (lotus_tpu/ops/pallas_ivf.py:378-440: the pair
// grouping by an exclusive cumsum over a (b, nlist) 0/1 histogram, or one
// stable argsort of the list ids past 2**26 cells; the chunk table by a
// cumsum over the lists' chunk counts; the padded query units by a gather
// through a (chunks * 128,) slot table), and the port ran them as about 26
// PyTorch passes a slice, one of which copied a host scalar and so made the
// host wait for the card.  ops/ivf_probe.py::probe_layout is its wrapper and
// probe_layout_reference its plain PyTorch version.
//
// What it computes, bit for bit as the plain version.  Pair p = q * nprobe
// + j probes list l = probe_lists[p].  Its rank r is the number of queries
// before q that probed l, so a list's pairs keep query order.  List l holds
// count[l] pairs in chunks[l] = ceil(count[l] / 128) chunks of 128 slots,
// placed after the chunks of the lists before it (chunk_base[l]); the pair
// sits in slot padpos[p] = chunk_base[l] * 128 + r.  Outputs:
// - chunk_list (n_chunks_max + 1,) int32: the list of each chunk, -1 from
//   the live chunks' end (n_chunks_max = b * nprobe / 128 + nlist, the
//   static bound, and one parking entry past it);
// - padpos (b * nprobe,) int64;
// - blocks (nlist,) int32: ceil(list_size[l] / bl) where count[l] > 0, else 0;
// - xq_units (n_chunks_max * 128, row): each pair's query row in its slot,
//   zeros in the other slots of live chunks.  Rows of dead chunks are not
//   written: K1 exits on a dead chunk before it reads its rows.
// probe_lists rows are distinct per query (the coarse ranking's top
// nprobe).  A list id outside [0, nlist) is dropped, as the JAX reference's
// scatter (mode="drop") drops it, and its pair is parked on the first slot
// of the parking chunk, whose K1 output row is masked; the plain PyTorch
// version does not define that input (its histogram scatter wraps -1 to
// the last list and raises past nlist), and the coarse ranking never makes it.
//
// What bounds it on this card.  Bytes: the query units of the live chunks
// written once (at config 4's slice, 2,048 int8 queries x 208 of 4,096 lists
// at d 768: about 4,100 live chunks of the bound's 7,424, 0.41 GB), beside
// the probe lists read and padpos written (5 MB) and the queries read
// (1.5 MB): about 0.12 ms at 3.35 TB/s.  The plain version writes and
// scans the (b, nlist) int32 histogram (33.5 MB, written, scanned and read
// back twice) and gathers every slot of every chunk, the dead ones too,
// through an int64 index (0.73 GB).  The design, four launches, no host
// synchronisation:
// 1. probe_layout_bits: one bit a pair in an (nlist, ceil(b / 32)) uint32
//    table, built in shared memory by blocks of (one word of 32 queries) x
//    (1,024 lists) and written whole, so nothing needs zeroing first and no
//    atomic leaves the block (1 MB at config 4's slice).  It is bound by the
//    latency of its reads, not their bytes, so the blocks are small: on an
//    H100 at config 4's slice, blocks of 8 words (32 blocks) took 0.056 ms,
//    of one word (256 blocks) 0.016 ms;
// 2. probe_layout_count: one warp a list; each word's set bits in the
//    list's earlier words (a warp prefix sum of popcounts), and the count;
// 3. probe_layout_table: one block scans the lists' chunk counts into
//    chunk_base and writes chunk_list and blocks;
// 4. probe_layout_units: a group of threads a pair finds its rank (the
//    word's earlier bits' popcount over its prefix), writes padpos and
//    copies the query row into its slot in the widest vectors the row
//    width and both bases allow (16 bytes at every width that is a multiple
//    of 16); one block a list zeroes the contiguous run of its last chunk's
//    unused slots.  The zeroes are stores in the kernel, not a memset.
// The query rows (1.5 MB at config 4) stay in L2, so device memory sees
// little beyond the units' writes.  The bit table holds b * nlist / 8 bytes,
// and as much again for the earlier words' counts, indexed in 64 bits: a
// sixteenth of the plain version's int32 histogram, and less than K1's
// output (512 bytes or more a pair) wherever nlist < 2,048 * nprobe, so K5
// takes every batch the probe can hold.  Its 32-bit indices bound a batch
// to b < 2**31 queries and b * nprobe < 2**32 pairs (units and padpos of 32
// GB and more); past that it refuses the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QU = 128;  // query slots a chunk (ops/ivf_probe.py's QU)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_LISTS = 1024;  // lists a bits block covers (4 KB of shared memory)
constexpr int TABLE_THREADS = 1024;
constexpr long long MAX_PAIRS = 1ll << 32;  // b * nprobe, below: a pair's query is a 32-bit quotient
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* probe_lists;  // (b * nprobe,)
  const void* xq;          // (b, row_bytes)
  const int* list_size;    // (nlist,)
  void* units;             // (n_chunks_max * QU, row_bytes)
  int* chunk_list;         // (n_chunks_max + 1,)
  long long* padpos;       // (b * nprobe,)
  int* blocks;             // (nlist,)
  uint32_t* bits;          // (nlist, words): bit q % 32 of word q / 32 set where query q probed the list
  uint32_t* below;         // (nlist, words): set bits in the list's earlier words
  int* count;              // (nlist,)
  int* chunk_base;         // (nlist,)
  long long b, pairs, n_chunks_max;
  int nprobe, nlist, words, bl;
  long long nvec;          // vectors a row
};

// Block (x, y): word x (queries 32x .. 32x + 31) of the lists in tiles y,
// y + gridDim.y, ...  The word's pairs are contiguous in probe_lists, so the
// block reads them in order, several loads in flight a thread.
__global__ void __launch_bounds__(THREADS) probe_layout_bits(const Args a) {
  __shared__ uint32_t tile[TILE_LISTS];
  const long long q0 = 32ll * blockIdx.x;
  const unsigned nprobe = static_cast<unsigned>(a.nprobe);
  const unsigned np = static_cast<unsigned>(min(a.b - q0, 32ll)) * nprobe;
  const int* lists = a.probe_lists + q0 * a.nprobe;
  for (int l0 = blockIdx.y * TILE_LISTS; l0 < a.nlist; l0 += gridDim.y * TILE_LISTS) {
    const int nl = min(TILE_LISTS, a.nlist - l0);
    for (int i = threadIdx.x; i < TILE_LISTS; i += THREADS) tile[i] = 0u;
    __syncthreads();
#pragma unroll 4
    for (unsigned i = threadIdx.x; i < np; i += THREADS) {
      const int l = lists[i] - l0;
      if (l >= 0 && l < nl) atomicOr(&tile[l], 1u << (i / nprobe));
    }
    __syncthreads();
    for (int l = threadIdx.x; l < nl; l += THREADS) a.bits[static_cast<long long>(l0 + l) * a.words + blockIdx.x] = tile[l];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) probe_layout_count(const Args a) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= a.nlist) return;
  const long long at = static_cast<long long>(l) * a.words;
  int carry = 0;
  for (int w0 = 0; w0 < a.words; w0 += 32) {
    const int w = w0 + lane;
    const int c = w < a.words ? __popc(a.bits[at + w]) : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (w < a.words) a.below[at + w] = static_cast<uint32_t>(carry + incl - c);
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) a.count[l] = carry;
}

__global__ void __launch_bounds__(TABLE_THREADS) probe_layout_table(const Args a) {
  __shared__ long long warp_sum[TABLE_THREADS / 32];
  __shared__ long long total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (a.nlist + TABLE_THREADS - 1) / TABLE_THREADS;  // a thread's run of lists
  const int lo = min(a.nlist, tid * per), hi = min(a.nlist, lo + per);
  long long mine = 0;
  for (int l = lo; l < hi; ++l) mine += (a.count[l] + QU - 1) / QU;
  long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long s = warp_sum[lane];
    long long si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(FULL, si, o);
      if (lane >= o) si += v;
    }
    warp_sum[lane] = si - s;
    if (lane == 31) total = si;
  }
  __syncthreads();
  long long base = warp_sum[warp] + incl - mine;
  for (int l = lo; l < hi; ++l) {
    const int cnt = a.count[l];
    const int chunks = (cnt + QU - 1) / QU;
    a.chunk_base[l] = static_cast<int>(base);
    a.blocks[l] = cnt > 0 ? (a.list_size[l] + a.bl - 1) / a.bl : 0;
    for (int c = 0; c < chunks; ++c) a.chunk_list[base + c] = l;
    base += chunks;
  }
  for (long long c = total + tid; c <= a.n_chunks_max; c += TABLE_THREADS) a.chunk_list[c] = -1;
}

// Blocks below pair_blocks: `group` threads a pair (a power of two up to
// 32).  The rest: one block a list, zeroing its last chunk's unused slots.
template <typename Vec>
__global__ void __launch_bounds__(THREADS) probe_layout_units(const Args a, int group, long long pair_blocks) {
  Vec* __restrict__ units = static_cast<Vec*>(a.units);
  const long long nvec = a.nvec;
  if (blockIdx.x < pair_blocks) {
    const long long p = static_cast<long long>(blockIdx.x) * (THREADS / group) + threadIdx.x / group;
    if (p >= a.pairs) return;
    const int g = threadIdx.x & (group - 1);
    // pairs < 2**32: 32-bit division
    const unsigned q = static_cast<unsigned>(p) / static_cast<unsigned>(a.nprobe);
    const int l = a.probe_lists[p];
    const long long park = a.n_chunks_max * QU;
    long long pos = park;
    if (static_cast<unsigned>(l) < static_cast<unsigned>(a.nlist)) {
      const long long at = static_cast<long long>(l) * a.words + (q >> 5);
      const uint32_t earlier = a.bits[at] & ((1u << (q & 31)) - 1u);
      pos = static_cast<long long>(a.chunk_base[l]) * QU + a.below[at] + __popc(earlier);
    }
    if (g == 0) a.padpos[p] = pos;
    if (pos == park) return;
    const Vec* __restrict__ src = static_cast<const Vec*>(a.xq) + q * nvec;
    Vec* __restrict__ dst = units + pos * nvec;
#pragma unroll 4
    for (long long i = g; i < nvec; i += group) dst[i] = src[i];
    return;
  }
  const int l = static_cast<int>(blockIdx.x - pair_blocks);
  const int cnt = a.count[l];
  const long long first = static_cast<long long>(a.chunk_base[l]) * QU;
  const long long lo = (first + cnt) * nvec;
  const long long hi = (first + static_cast<long long>((cnt + QU - 1) / QU) * QU) * nvec;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) units[i] = Vec{};
}

template <typename Vec>
int launch_units(const Args& a, cudaStream_t stream) {
  int group = 1;  // about four vectors a thread; whole warps for wide rows
  while (group < 32 && group * 4LL < a.nvec) group <<= 1;
  const long long pair_blocks = (a.pairs + THREADS / group - 1) / (THREADS / group);
  const long long grid = pair_blocks + a.nlist;
  if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  probe_layout_units<Vec><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(a, group, pair_blocks);
  return static_cast<int>(cudaGetLastError());
}

long long words_of(long long b) { return (b + 31) / 32; }

}  // namespace

extern "C" {

// Bytes of device-memory workspace K5 needs: the bit table and the earlier
// words' counts, (nlist, ceil(b / 32)) uint32 each, and two (nlist,) int32.
long long lotus_probe_layout_workspace(long long b, int nlist) {
  if (b < 0 || nlist < 0) return 0;
  return 8ll * nlist * words_of(b) + 8ll * nlist;
}

// Launches K5 on `stream` and returns a cudaError_t (0 on success).
// probe_lists: (b, nprobe) int32; xq: (b, row_bytes) bytes of the queries'
// rows; list_size, blocks: (nlist,) int32; units: (n_chunks_max * 128,
// row_bytes); chunk_list: (n_chunks_max + 1,) int32 and padpos: (b *
// nprobe,) int64, where n_chunks_max = b * nprobe / 128 + nlist; work holds
// lotus_probe_layout_workspace(b, nlist) bytes, 4-byte aligned.  Takes b <
// 2**31, b * nprobe < 2**32 and nprobe < 2**27 (a bits block's 32 queries'
// pairs in 32 bits).
int lotus_probe_layout(const void* probe_lists, const void* xq, const void* list_size, void* units, void* chunk_list,
                       void* padpos, void* blocks, void* work, long long work_bytes, long long b, int nprobe,
                       int nlist, long long row_bytes, int bl, void* stream) {
  if (b < 0 || b > 0x7fffffffll || nprobe < 0 || nprobe >= (1 << 27) || nlist < 0 || bl < 1 || row_bytes < 0 ||
      b * static_cast<long long>(nprobe) >= MAX_PAIRS || work_bytes < lotus_probe_layout_workspace(b, nlist) ||
      reinterpret_cast<uintptr_t>(work) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = b * nprobe;
  const long long n_chunks_max = pairs / QU + nlist;
  const int words = static_cast<int>(words_of(b));
  const long long cells = static_cast<long long>(nlist) * words;
  uint32_t* bits = static_cast<uint32_t*>(work);
  int* count = reinterpret_cast<int*>(bits + 2 * cells);
  // The widest vector that divides the row and both bases.
  const uintptr_t align = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(units) |
                          static_cast<uintptr_t>(row_bytes);
  int vec = 16;
  while (vec > 1 && align % vec) vec >>= 1;
  Args a{static_cast<const int*>(probe_lists), xq, static_cast<const int*>(list_size), units,
         static_cast<int*>(chunk_list), static_cast<long long*>(padpos), static_cast<int*>(blocks),
         bits, bits + cells, count, count + nlist, b, pairs, n_chunks_max, nprobe, nlist, words, bl,
         row_bytes / vec};
  const auto s = static_cast<cudaStream_t>(stream);
  if (cells > 0) {
    const int tiles = (nlist + TILE_LISTS - 1) / TILE_LISTS;
    const dim3 grid(words, tiles < 65535 ? tiles : 65535);
    probe_layout_bits<<<grid, THREADS, 0, s>>>(a);
    if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  }
  if (nlist > 0) {
    probe_layout_count<<<(nlist + WARPS - 1) / WARPS, THREADS, 0, s>>>(a);
    if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  }
  probe_layout_table<<<1, TABLE_THREADS, 0, s>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  switch (vec) {
    case 16: return launch_units<uint4>(a, s);
    case 8: return launch_units<uint2>(a, s);
    case 4: return launch_units<uint32_t>(a, s);
    case 2: return launch_units<uint16_t>(a, s);
    default: return launch_units<uint8_t>(a, s);
  }
}

}  // extern "C"
