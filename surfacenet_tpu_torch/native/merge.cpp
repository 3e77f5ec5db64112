// Native sparse-voxel merge for SparseCubeStore (SURVEY.md C10).
//
// The device sweep emits per-cube sparse voxel records; merging a full scan
// means deduplicating tens of millions of (x, y, z) int coordinates,
// vote-filtering overlap regions, and averaging probabilities/colors.  The
// numpy path (np.unique + np.add.at) is O(N log N) with several large
// temporaries; this native path is a single O(N) pass over a flat hash map,
// plus a binary-search containment counter, built for the production IO
// tail of multi-host sweeps.
//
// Exposed via ctypes: plain C ABI, raw pointers + lengths, caller owns all
// buffers.  The port's own copy of surfacenet_tpu/native/merge.cpp, with the
// same code: built by the same compiler, both give bitwise equal merges.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Pack signed voxel coords (each fits in 21 bits incl. sign) into a key.
inline uint64_t pack(int64_t x, int64_t y, int64_t z) {
  const uint64_t bias = 1u << 20;
  return ((uint64_t)(x + bias) << 42) | ((uint64_t)(y + bias) << 21) |
         (uint64_t)(z + bias);
}

struct Acc {
  float votes = 0.f;
  float prob_sum = 0.f;
  float color_sum[3] = {0.f, 0.f, 0.f};
  float contain = 0.f;
  int64_t x, y, z;
};

}  // namespace

extern "C" {

// Count, for each record, how many cubes from `done` (packed cube-grid keys,
// sorted ascending) contain the record's voxel coordinate.
//
// A cube at grid g (stride st, side D) contains voxel c iff
// g*st <= c < g*st + D, i.e. g in [ceil((c-D+1)/st), floor(c/st)].
void sn_containment(const int64_t* coords, int64_t n,
                    const uint64_t* done_sorted, int64_t n_done,
                    int64_t stride, int64_t D, float* out_counts) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3] = {coords[3 * i], coords[3 * i + 1], coords[3 * i + 2]};
    int64_t lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      int64_t v = c[a] - D + 1;
      lo[a] = v >= 0 ? (v + stride - 1) / stride : -((-v) / stride);
      hi[a] = c[a] >= 0 ? c[a] / stride : -((-c[a] + stride - 1) / stride);
    }
    float cnt = 0.f;
    for (int64_t gx = lo[0]; gx <= hi[0]; ++gx)
      for (int64_t gy = lo[1]; gy <= hi[1]; ++gy)
        for (int64_t gz = lo[2]; gz <= hi[2]; ++gz) {
          uint64_t key = pack(gx, gy, gz);
          if (std::binary_search(done_sorted, done_sorted + n_done, key))
            cnt += 1.f;
        }
    out_counts[i] = cnt;
  }
}

// Merge sparse voxel records: dedupe by coordinate, average prob/color over
// contributing records, keep voxels whose occupied-vote fraction among
// containing cubes >= vote_threshold.
//
// Returns the number of surviving voxels written to out_* (capacity must be
// >= n).  contain[i] is the containment count of record i (sn_containment).
int64_t sn_merge(const int64_t* coords, const float* probs,
                 const float* colors, const float* contain, int64_t n,
                 float vote_threshold, int64_t* out_coords, float* out_probs,
                 float* out_colors) {
  std::unordered_map<uint64_t, Acc> map;
  map.reserve((size_t)n * 2);
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = coords[3 * i], y = coords[3 * i + 1], z = coords[3 * i + 2];
    Acc& a = map[pack(x, y, z)];
    a.x = x; a.y = y; a.z = z;
    a.votes += 1.f;
    a.prob_sum += probs[i];
    a.color_sum[0] += colors[3 * i];
    a.color_sum[1] += colors[3 * i + 1];
    a.color_sum[2] += colors[3 * i + 2];
    a.contain = std::max(a.contain, contain[i]);
  }
  int64_t m = 0;
  for (auto& kv : map) {
    const Acc& a = kv.second;
    float denom = a.contain > 1.f ? a.contain : 1.f;
    if (a.votes / denom < vote_threshold) continue;
    out_coords[3 * m] = a.x;
    out_coords[3 * m + 1] = a.y;
    out_coords[3 * m + 2] = a.z;
    out_probs[m] = a.prob_sum / a.votes;
    out_colors[3 * m] = a.color_sum[0] / a.votes;
    out_colors[3 * m + 1] = a.color_sum[1] / a.votes;
    out_colors[3 * m + 2] = a.color_sum[2] / a.votes;
    ++m;
  }
  return m;
}

// Pack cube-grid indices into sorted keys (helper for sn_containment).
void sn_pack_keys(const int64_t* grid, int64_t n, uint64_t* out_keys) {
  for (int64_t i = 0; i < n; ++i)
    out_keys[i] = pack(grid[3 * i], grid[3 * i + 1], grid[3 * i + 2]);
  std::sort(out_keys, out_keys + n);
}

}  // extern "C"
