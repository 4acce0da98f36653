// Hand-written Hopper (sm_90a) kernel for the per-tile band tables of
// nbody_tpu_torch: ops/forces.build_cell_tables_torch in one launch that
// writes only the rows the table sweep reads.  Plain C interface, bound
// with ctypes by nbody_tpu_torch/ops/cuda/tables.py; the entry point
// launches on the stream it is given, allocates nothing, reads nothing
// back and returns cudaGetLastError().
//
// It replaces no Pallas kernel: the JAX package gathers the tables in jnp,
// every row at the caps' width, and the plain PyTorch port does the same
// (a sort of the item slots, a gather of 144-byte items into a temporary,
// a strided copy into the planes, then the same for the near anti rows).
// At the grown caps of a dense core (65,536 + 9 x 13,504 rows a tile,
// 1,954 tiles) that writes and reads ~12 GB a build, while the table sweep
// reads only two live ranges of each row: [0, near_cnt) and [near_cap,
// row_cnt).  This kernel writes those two ranges, bit for bit the plain
// version's there, and leaves every other row as it found it (the tables'
// contract: rows outside the live ranges are unspecified).
//
// Bound.  The live rows written once at 16 B (4 planes x 4 B) plus the
// lists' live prefixes and the counts read once.  A dense core's build
// has ~8e7 live rows (~40,000 a tile): ~1.3 GB, ~0.4 ms at 3.35 TB/s; the
// 1M disk's start state ~1.5e7 (~0.08 ms).  The sources (the cell
// hierarchy, ~40 MB at 1M) stay in L2: a tile's near children and listed
// parents are neighbours in Morton order.
//
// Design:
//   * a tile's rows are split over `splits` blocks of kThreads threads
//     (the caller sizes it from the row width, so a dense tile's live rows
//     spread over many SMs and a light tile's extra blocks exit at once);
//     thread i of a tile takes live rows i, i + splits * kThreads, ...,
//     so every plane's stores are coalesced;
//   * the live rows are the near anti rows, then the items of the ss, sup,
//     mid and cmid lists' live prefixes in that order: the order the plain
//     version's stable validity sort gives, so nothing is sorted.  Item j
//     is rows near_cap + 9j ... + 8: its 8 member monopoles, then the
//     parent's row negated;
//   * each row is read where it lives, in the five source levels (super-
//     supers, supers, cells, children, grandchildren): an item of level l
//     has its parent in level l and its members 8 id + k in level l + 1, a
//     near anti row is a child's row negated.  Pad ids (outside [0, n)) and
//     members past a level's end are zero rows, as the plain version's
//     clamps and zero padding make them;
//   * counts are clamped to [0, cap] as the plain version's validity mask
//     clamps them; near_cnt passes through as the plain version passes it.
//
// Numerics: copies and one negation, so every live row is the plain
// version's bit for bit (a zero gmass negates to -0.0 in both).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 5;   // super-supers, supers, cells, children, gkids
constexpr int kLists = 4;    // ss, sup, mid, cmid: items of levels 0..3
constexpr int kItemRows = 9; // 8 members and the negated parent

}  // namespace

// The argument block (ops/cuda/tables.py's TablesArgs, field for field).
struct TablesArgs {
  // the source levels, float32: super-supers [n_ss], supers [n_sup], cells
  // [g_cap], children [8 g_cap], grandchildren [64 g_cap] (com [.., 3])
  const float* ss_com;
  const float* ss_gmass;
  const float* sup_com;
  const float* sup_gmass;
  const float* cell_com;
  const float* cell_gmass;
  const float* kid_com;
  const float* kid_gmass;
  const float* gkid_com;
  const float* gkid_gmass;
  // the band lists, int32 [tiles, cap] with their counts [tiles]
  const int* ss_idx;
  const int* ss_cnt;
  const int* sup_idx;
  const int* sup_cnt;
  const int* mid_idx;
  const int* mid_cnt;
  const int* cmid_idx;
  const int* cmid_cnt;
  const int* near_idx;
  const int* near_cnt;
  // outputs: planes float32 [tiles, rows], counts int32 [tiles]
  float* tx;
  float* ty;
  float* tz;
  float* tm;
  int* row_cnt;
  int* near_cnt_out;
  int tiles, n_ss, n_sup, g_cap, ss_cap, sup_cap, mid_cap, cmid_cap, near_cap;
  int splits;
};

namespace {

__global__ void __launch_bounds__(kThreads)
    band_tables_kernel(const TablesArgs a) {
  __shared__ const float* s_com[kLevels];
  __shared__ const float* s_gm[kLevels];
  __shared__ long long s_n[kLevels];
  __shared__ const int* s_list[kLists];
  __shared__ int s_end[kLists];     // running item counts, list by list
  __shared__ int s_near;

  const int t = blockIdx.x / a.splits;
  const int part = blockIdx.x - t * a.splits;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const long long g = a.g_cap;
    const float* com[kLevels] = {a.ss_com, a.sup_com, a.cell_com, a.kid_com,
                                 a.gkid_com};
    const float* gm[kLevels] = {a.ss_gmass, a.sup_gmass, a.cell_gmass,
                                a.kid_gmass, a.gkid_gmass};
    const long long n[kLevels] = {a.n_ss, a.n_sup, g, 8 * g, 64 * g};
    for (int l = 0; l < kLevels; ++l) {
      s_com[l] = com[l];
      s_gm[l] = gm[l];
      s_n[l] = n[l];
    }
    const int* idx[kLists] = {a.ss_idx, a.sup_idx, a.mid_idx, a.cmid_idx};
    const int* cnt[kLists] = {a.ss_cnt, a.sup_cnt, a.mid_cnt, a.cmid_cnt};
    const int cap[kLists] = {a.ss_cap, a.sup_cap, a.mid_cap, a.cmid_cap};
    int end = 0;
    for (int l = 0; l < kLists; ++l) {
      end += min(max(cnt[l][t], 0), cap[l]);
      s_end[l] = end;
      s_list[l] = idx[l] + (size_t)t * cap[l];
    }
    s_near = min(max(a.near_cnt[t], 0), a.near_cap);
    if (part == 0) {
      a.row_cnt[t] = a.near_cap + kItemRows * end;
      a.near_cnt_out[t] = a.near_cnt[t];
    }
  }
  __syncthreads();

  const int rows = a.near_cap + kItemRows * (a.ss_cap + a.sup_cap +
                                             a.mid_cap + a.cmid_cap);
  const size_t row0 = (size_t)t * rows;
  const int nn = s_near;
  const int live = nn + kItemRows * s_end[kLists - 1];
  const int* near = a.near_idx + (size_t)t * a.near_cap;
  for (int i = part * kThreads + tid; i < live; i += a.splits * kThreads) {
    int r, lvl;
    long long src;
    bool ok, negate;
    if (i < nn) {                        // a near child's anti row
      r = i;
      lvl = 3;
      src = near[i];
      ok = src >= 0 && src < s_n[3];
      negate = true;
    } else {                             // row k of item j
      const int q = i - nn;
      const int j = q / kItemRows;
      const int k = q - kItemRows * j;
      r = a.near_cap + q;
      const int l = (j >= s_end[0]) + (j >= s_end[1]) + (j >= s_end[2]);
      const long long pid = s_list[l][j - (l ? s_end[l - 1] : 0)];
      ok = pid >= 0 && pid < s_n[l];
      negate = k == kItemRows - 1;
      lvl = negate ? l : l + 1;
      src = negate ? pid : 8 * pid + k;
      ok = ok && src < s_n[lvl];
    }
    float x = 0.f, y = 0.f, z = 0.f, m = 0.f;
    if (ok) {
      const float* c = s_com[lvl] + 3 * src;
      x = __ldg(c);
      y = __ldg(c + 1);
      z = __ldg(c + 2);
      m = __ldg(s_gm[lvl] + src);
      if (negate) m = -m;
    }
    a.tx[row0 + r] = x;
    a.ty[row0 + r] = y;
    a.tz[row0 + r] = z;
    a.tm[row0 + r] = m;
  }
}

}  // namespace

extern "C" {

// splits blocks of kThreads threads a tile.
int nbody_band_tables(const TablesArgs* args, void* stream) {
  const TablesArgs a = *args;
  if (a.tiles < 0 || a.splits < 1 || a.n_ss < 1 || a.n_sup < 1 ||
      a.g_cap < 1 || a.ss_cap < 0 || a.sup_cap < 0 || a.mid_cap < 0 ||
      a.cmid_cap < 0 || a.near_cap < 0 ||
      (long long)a.tiles * a.splits > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.tiles > 0) {
    band_tables_kernel<<<a.tiles * a.splits, kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
