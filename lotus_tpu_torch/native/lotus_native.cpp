// lotus_native: the host runtime of lotus_tpu_torch.
//
// A copy of lotus_tpu's native/lotus_native.cpp with the same algorithms,
// so that both libraries give the same answers bit for bit:
//   - union-find connected components over duplicate-pair edge lists
//     (sem_dedup's host step)
//   - k-way merge of per-shard top-k candidate lists (the serving front
//     end's merge)
//   - checksummed raw array file IO (CRC32, IEEE 802.3)
//
// Exposed with a plain C ABI for ctypes; see lotus_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ----------------------------------------------------------- union-find
// edges: 2*n_edges int64 (a, b) pairs with ids in [0, n_nodes).
// out_labels: n_nodes int64, filled with the component root of each node
// (path-compressed, so equal labels <=> same component).
void lotus_union_find(const int64_t* edges, int64_t n_edges, int64_t n_nodes,
                      int64_t* out_labels) {
  std::vector<int64_t> parent(n_nodes);
  std::iota(parent.begin(), parent.end(), 0);
  std::vector<int8_t> rank(n_nodes, 0);

  auto find = [&](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  };

  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t a = find(edges[2 * e]);
    int64_t b = find(edges[2 * e + 1]);
    if (a == b) continue;
    if (rank[a] < rank[b]) std::swap(a, b);
    parent[b] = a;
    if (rank[a] == rank[b]) ++rank[a];
  }
  for (int64_t i = 0; i < n_nodes; ++i) out_labels[i] = find(i);
}

// ------------------------------------------------------ top-k k-way merge
// scores: n_lists * list_len floats (descending within each list).
// ids:    matching int64 ids (-1 = missing).
// Merges into the global top-k (descending), writing k scores + ids.
void lotus_topk_merge(const float* scores, const int64_t* ids, int64_t n_lists,
                      int64_t list_len, int64_t k, float* out_scores,
                      int64_t* out_ids) {
  struct Head {
    float score;
    int64_t list;
    int64_t pos;
  };
  auto cmp = [](const Head& a, const Head& b) { return a.score < b.score; };
  std::vector<Head> heap;
  heap.reserve(n_lists);
  for (int64_t l = 0; l < n_lists; ++l) {
    if (list_len > 0 && ids[l * list_len] >= 0) {
      heap.push_back({scores[l * list_len], l, 0});
    }
  }
  std::make_heap(heap.begin(), heap.end(), cmp);

  int64_t written = 0;
  while (written < k && !heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    Head h = heap.back();
    heap.pop_back();
    out_scores[written] = h.score;
    out_ids[written] = ids[h.list * list_len + h.pos];
    ++written;
    int64_t next = h.pos + 1;
    if (next < list_len && ids[h.list * list_len + next] >= 0) {
      heap.push_back({scores[h.list * list_len + next], h.list, next});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
  for (; written < k; ++written) {
    out_scores[written] = -3.0e38f;
    out_ids[written] = -1;
  }
}

// Batched variant for the serving front end: one (n_lists, list_len) merge
// per query.  scores/ids are laid out [n_queries, n_lists, list_len]; the
// outputs are [n_queries, k].  Keeps the whole fan-in aggregation of a
// query batch in one native call instead of n_queries ctypes round trips.
void lotus_topk_merge_batch(const float* scores, const int64_t* ids,
                            int64_t n_queries, int64_t n_lists,
                            int64_t list_len, int64_t k, float* out_scores,
                            int64_t* out_ids) {
  const int64_t in_stride = n_lists * list_len;
  for (int64_t q = 0; q < n_queries; ++q) {
    lotus_topk_merge(scores + q * in_stride, ids + q * in_stride, n_lists,
                     list_len, k, out_scores + q * k, out_ids + q * k);
  }
}

// --------------------------------------------------------- checksummed IO
// CRC32 (IEEE 802.3 polynomial, table-driven).
static uint32_t crc32_table[256];
static bool crc32_ready = false;

static void crc32_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int j = 0; j < 8; ++j) c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    crc32_table[i] = c;
  }
  crc32_ready = true;
}

uint32_t lotus_crc32(const uint8_t* data, int64_t len) {
  if (!crc32_ready) crc32_init();
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; ++i)
    c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// File layout: magic "LTPU" | u32 version | u64 byte_len | u32 crc | payload.
// Returns 0 on success, negative error codes otherwise.
int lotus_write_array(const char* path, const uint8_t* data, int64_t len) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const char magic[4] = {'L', 'T', 'P', 'U'};
  uint32_t version = 1;
  uint64_t blen = static_cast<uint64_t>(len);
  uint32_t crc = lotus_crc32(data, len);
  bool ok = std::fwrite(magic, 1, 4, f) == 4 &&
            std::fwrite(&version, 4, 1, f) == 1 &&
            std::fwrite(&blen, 8, 1, f) == 1 &&
            std::fwrite(&crc, 4, 1, f) == 1 &&
            (len == 0 || std::fwrite(data, 1, len, f) == static_cast<size_t>(len));
  std::fclose(f);
  return ok ? 0 : -2;
}

// Reads the header; returns payload length, or negative error.
// If out != nullptr it must have space for the payload; the payload is read
// and its CRC verified (-3 = corrupt).
int64_t lotus_read_array(const char* path, uint8_t* out, int64_t out_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t version = 0, crc = 0;
  uint64_t blen = 0;
  bool ok = std::fread(magic, 1, 4, f) == 4 && std::memcmp(magic, "LTPU", 4) == 0 &&
            std::fread(&version, 4, 1, f) == 1 && std::fread(&blen, 8, 1, f) == 1 &&
            std::fread(&crc, 4, 1, f) == 1;
  if (!ok) {
    std::fclose(f);
    return -2;
  }
  if (out == nullptr) {
    std::fclose(f);
    return static_cast<int64_t>(blen);
  }
  if (out_cap < static_cast<int64_t>(blen)) {
    std::fclose(f);
    return -4;
  }
  ok = blen == 0 || std::fread(out, 1, blen, f) == blen;
  std::fclose(f);
  if (!ok) return -2;
  if (lotus_crc32(out, static_cast<int64_t>(blen)) != crc) return -3;
  return static_cast<int64_t>(blen);
}

}  // extern "C"
