// Native point-cloud denoising for the sweep's IO tail (SURVEY.md C8 —
// the reference's `denoising.py` analog: drop small floating clusters of
// occupied voxels after the overlap merge).
//
// Connected components over the 26-neighborhood of integer voxel
// coordinates: open-addressed hash of packed coords -> record index, then
// union-find (path halving + union by size) over the 13 forward neighbor
// offsets.  O(N * 13) expected; labels are compacted to [0, n_components).
//
// ctypes C ABI; caller owns buffers.  The port's own copy of
// surfacenet_tpu/native/denoise.cpp, with the same code.

#include <cstdint>
#include <vector>

namespace {

// Same packing as merge.cpp: signed coords, 21 bits each incl. sign.
inline uint64_t pack(int64_t x, int64_t y, int64_t z) {
  const uint64_t bias = 1u << 20;
  return ((uint64_t)(x + bias) << 42) | ((uint64_t)(y + bias) << 21) |
         (uint64_t)(z + bias);
}

// Open-addressed hash map: packed key -> record index.  Linear probing,
// power-of-two capacity >= 2n, empty slot = UINT64_MAX.
struct VoxelHash {
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  uint64_t mask;

  explicit VoxelHash(int64_t n) {
    uint64_t cap = 16;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline uint64_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return k;
  }

  void insert(uint64_t key, int64_t val) {
    uint64_t i = mix(key) & mask;
    while (keys[i] != UINT64_MAX) {
      if (keys[i] == key) return;  // first record wins (coords are unique)
      i = (i + 1) & mask;
    }
    keys[i] = key;
    vals[i] = val;
  }

  int64_t find(uint64_t key) const {
    uint64_t i = mix(key) & mask;
    while (keys[i] != UINT64_MAX) {
      if (keys[i] == key) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
};

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int64_t> size;

  explicit UnionFind(int64_t n) : parent(n), size(n, 1) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }

  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
  }
};

}  // namespace

extern "C" {

// Label 26-connected components of n integer voxel coords (row-major
// (N, 3) int64).  Writes compact labels in [0, n_components) to
// out_labels (int64, capacity n) and per-record component sizes to
// out_sizes (int64, capacity n).  Returns the number of components.
int64_t sn_components(const int64_t* coords, int64_t n, int64_t* out_labels,
                      int64_t* out_sizes) {
  if (n == 0) return 0;
  VoxelHash hash(n);
  for (int64_t i = 0; i < n; ++i)
    hash.insert(pack(coords[3 * i], coords[3 * i + 1], coords[3 * i + 2]), i);

  // 13 forward offsets = half the 26-neighborhood (lexicographically > 0);
  // the backward half is covered by the neighbor's own forward pass.
  static const int off[13][3] = {
      {0, 0, 1}, {0, 1, -1}, {0, 1, 0},  {0, 1, 1},  {1, -1, -1},
      {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},  {1, 0, 1},
      {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

  UnionFind uf(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = coords[3 * i], y = coords[3 * i + 1],
                  z = coords[3 * i + 2];
    for (const auto& o : off) {
      int64_t j = hash.find(pack(x + o[0], y + o[1], z + o[2]));
      if (j >= 0) uf.unite(i, j);
    }
  }

  // Compact root ids -> [0, n_components); emit per-record sizes.
  std::vector<int64_t> compact(n, -1);
  int64_t n_comp = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf.find(i);
    if (compact[r] < 0) compact[r] = n_comp++;
    out_labels[i] = compact[r];
    out_sizes[i] = uf.size[r];
  }
  return n_comp;
}

}  // extern "C"
