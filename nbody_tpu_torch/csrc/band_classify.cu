// Hand-written Hopper (sm_90a) kernel for the band classifier of
// nbody_tpu_torch: ops/forces.cell_band_lists_torch in one launch.  Plain C
// interface, bound with ctypes by nbody_tpu_torch/ops/cuda/classify.py;
// the entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError().
//
// It replaces no Pallas kernel: the JAX package classifies in jnp, chunks
// of target tiles through panels at the lists' static caps, and the plain
// PyTorch port does the same.  On the card that is some 3,000 small
// kernels a build at 1M bodies (about 15 GB of panels written and read)
// and some 350 at 100k, most of a rebuild's device time.  This kernel
// computes the same 13 arrays and 5 overflow flags, bit for bit, and the
// demanded length of each list, the longest over tiles, as the plain
// version's `demand`.
//
// Bound.  One block a target tile.  At 1M (1,954 tiles) a tile tests about
// 19k (sub-sphere, source) pairs, 8 x (154 super-supers + 8 x (109 + 86 +
// 86) listed parents), 11 FP32 operations each (3 sub, 3 mul, 2 add, sqrt,
// sub, min): ~0.4 GFLOP over the card, ~6 us at 67 TFLOP/s.  Its inputs,
// the whole source hierarchy, are ~15 MB (a tile reads ~100 KB of them,
// from L2) and it writes ~20 KB of lists a tile at the caps (39 MB): ~16 us
// at 3.35 TB/s, its least time (chip_smoke.py's bound).  What bounds this
// design is the latency of each stage's dependent loads and block
// barriers, not throughput: 0.24 ms at 1M, against ~22 ms of plain kernels.
//
// Design:
//   * the block's 8 sub-spheres (centre, radius + target skin + half the
//     uniform skin) sit in shared memory, and each stage walks only the
//     live prefix of the previous stage's list, 8 members a listed parent,
//     one candidate a thread against all 8 sub-spheres;
//   * failing ids are compacted in order, by warp ballot and a prefix over
//     the block's warps.  Parents come ascending and members are 8 *
//     parent + j, so every list comes out ascending with no sort, the
//     order the plain version's row sort gives; a list is cut at its cap
//     and its raw count sets the overflow flag;
//   * stage 3 also takes the grandchild-box test of the failing children
//     and splits them into the cmid and near lists;
//   * one warp scans the near runs in order into deduplicated 128-wide
//     windows: each run cut into `pieces` aligned pieces, equal
//     consecutive window keys merged, a child whose last piece ranks at
//     win_cap or above dropped whole (its lane words left out, its
//     anti-row cut from near_idx);
//   * the lists, windows and counts live in shared memory (~17 KB at the
//     default caps, 4 B an entry of ss, sup, mid and near and 20 B a
//     window; the opt-in limit, 227 KB, bounds the caps that can grow)
//     and are written out once, padded as the plain version pads them.
//     A near list longer than kNearSmem entries (a dense core's grown
//     cap) is built in its output row instead, as the cmid list always
//     is, and padded there;
//   * each list's raw count, and the near children's distinct windows, are
//     the tile's demand: one atomicMax a list into the build's `demand`.
//
// Numerics: every float operation of the MAC tests is the plain version's,
// in its order, as an __f*_rn intrinsic (no contraction): |d| summed left
// to right, the clamps, sqrt(g g + soft), the divide, >= theta.  min and
// max propagate NaN as torch.amin / torch.minimum do.  The lane words of
// one window are summed as uint32 as the plain version sums them (an OR,
// since the pieces of one window cover disjoint lanes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;           // sub-spheres a tile (forces.SUB_FACTOR)
constexpr int kSpan = 128;        // window width (forces.SPAN_ALIGN)
constexpr int kBig = 2147483646;  // absent key (forces._BIG)
constexpr float kBigF = 3.0e38f;  // forces._BIG_F
constexpr unsigned kFull = 0xffffffffu;
// the longest near list kept in shared memory (ops/cuda/classify.py's
// NEAR_SMEM); a longer one is built in global memory, in its output row
constexpr int kNearSmem = 8192;

}  // namespace

// The argument block (ops/cuda/classify.py's ClassifyArgs, field for
// field).  Float arrays are float32, id arrays int64 where marked.
struct ClassifyArgs {
  // target sub-spheres [tiles * 8] (centre [.., 3])
  const float* tgt_center;
  const float* tgt_radius;
  const float* tgt_skin;
  // super-supers [n_ss]
  const float* ss_com;
  const float* ss_diam;
  const float* ss_skin;
  const float* ss_gmass;
  // supers [n_sup]
  const float* sup_com;
  const float* sup_diam;
  const float* sup_skin;
  const float* sup_gmass;
  // cells [g_cap]
  const float* cell_com;
  const float* cell_diam;
  const float* cell_skin;
  // children [g_cap * 8]
  const float* kid_com;
  const float* kid_diam;
  const float* kid_gmass;
  const float* kid_skin;
  const float* kid_gdiam;         // gchild_diam_max
  const uint8_t* kid_complete;    // gchild_complete (bool)
  const long long* kid_first;
  const long long* kid_count;
  // grandchildren [g_cap * 64]
  const float* gkid_com;
  const float* gkid_gmass;
  // outputs (int32; flags bool [5] and demand int32 [6], zeroed by the
  // caller)
  int* ss_idx;
  int* ss_cnt;
  int* sup_idx;
  int* sup_cnt;
  int* mid_idx;
  int* mid_cnt;
  int* cmid_idx;
  int* cmid_cnt;
  int* near_idx;
  int* near_cnt;
  int* win_first;
  int* win_mask;
  int* win_cnt;
  uint8_t* flags;
  int* demand;  // ss, sup, mid, cmid, near, windows (forces.BAND_DEMAND)
  int tiles, n_ss, n_sup, g_cap;
  int ss_cap, sup_cap, mid_cap, cmid_cap, near_cap, win_cap, pieces;
  float half, soft, theta;
};

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// |p - c_j| - rt_j, the least over the tile's 8 sub-spheres.
__device__ __forceinline__ float min_gap(float x, float y, float z,
                                         const float (&c)[3][kSub],
                                         const float (&rt)[kSub]) {
  float g = 0.0f;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float dx = __fsub_rn(x, c[0][j]);
    const float dy = __fsub_rn(y, c[1][j]);
    const float dz = __fsub_rn(z, c[2][j]);
    const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float gj = __fsub_rn(__fsqrt_rn(n2), rt[j]);
    g = j == 0 ? gj : min_nan(g, gj);
  }
  return g;
}

// The MAC ratio (diam + 2 sk) / sqrt(gap^2 + soft), the gap deflated by the
// source's margin sk = src_skin + half.
__device__ __forceinline__ float mac_ratio(float gmin, float diam, float sk,
                                           float soft) {
  const float gap = clamp0(__fsub_rn(clamp0(gmin), sk));
  const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(gap, gap), soft));
  return __fdiv_rn(__fadd_rn(diam, __fmul_rn(2.0f, sk)), dist);
}

// The least gap from the tile's sub-spheres to child `kid`'s grandchild-COM
// box (the box of its massive grandchildren's centres of mass).
__device__ __forceinline__ float box_gap(const float* __restrict__ gcom,
                                         const float* __restrict__ gmass,
                                         int kid, const float (&c)[3][kSub],
                                         const float (&rt)[kSub]) {
  float lo[3], hi[3];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const size_t gi = (size_t)kid * 8 + g;
    const bool ok = gmass[gi] > 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = gcom[3 * gi + d];
      const float l = ok ? v : kBigF, h = ok ? v : -kBigF;
      lo[d] = g == 0 ? l : min_nan(lo[d], l);
      hi[d] = g == 0 ? h : max_nan(hi[d], h);
    }
  }
  float gmin = 0.0f;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    float d[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float cl = min_nan(max_nan(c[e][j], lo[e]), hi[e]);
      d[e] = __fsub_rn(cl, c[e][j]);
    }
    const float n2 = __fadd_rn(
        __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
        __fmul_rn(d[2], d[2]));
    const float gj = __fsub_rn(__fsqrt_rn(n2), rt[j]);
    gmin = j == 0 ? gj : min_nan(gmin, gj);
  }
  return gmin;
}

// Appends `id` of the threads whose `keep` is set, in thread order, to
// list[base...], dropping what falls at or past `cap`; returns how many
// kept (the same in every thread).  Every thread of the block calls it.
__device__ __forceinline__ int append(bool keep, int id, int* list, int base,
                                      int cap, int* warp_cnt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, keep);
  if (lane == 0) warp_cnt[w] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int n = warp_cnt[i];
    before += i < w ? n : 0;
    total += n;
  }
  if (keep) {
    const int pos = base + before + __popc(m & ((1u << lane) - 1u));
    if (pos < cap) list[pos] = id;
  }
  __syncthreads();
  return total;
}

// Row `t` of an index list: its first min(cnt, cap) ids, then `pad`.
__device__ __forceinline__ void write_row(int* out, const int* list, int cnt,
                                          int cap, int pad) {
  const int n = min(cnt, cap);
  for (int k = threadIdx.x; k < cap; k += kThreads) {
    out[k] = k < n ? min(list[k], pad) : pad;
  }
}

// Window key of piece j of the run [f, f + cnt) (forces._pieces): the
// aligned window it lies in if live, else the run's last window (or kBig
// for an empty run).
__device__ __forceinline__ long long piece_key(long long w, long long end,
                                               long long cnt,
                                               long long key_last, int j) {
  if (cnt <= 0) return kBig;
  return end > (long long)kSpan * j ? w + j : key_last;
}

// int32 with the low k bits set, k clamped to [0, 32] (forces._lowmask).
__device__ __forceinline__ unsigned low_mask(long long k) {
  return k >= 32 ? kFull : (k <= 0 ? 0u : ((1u << k) - 1u));
}

__global__ void __launch_bounds__(kThreads)
    band_classify_kernel(const ClassifyArgs a) {
  extern __shared__ int smem[];
  int* s_ss = smem;
  int* s_sup = s_ss + a.ss_cap;
  int* s_mid = s_sup + a.sup_cap;
  const bool near_smem = a.near_cap <= kNearSmem;
  int* s_near = near_smem ? s_mid + a.mid_cap
                          : a.near_idx + (size_t)blockIdx.x * a.near_cap;
  int* s_wkey = s_mid + a.mid_cap + (near_smem ? a.near_cap : 0);
  unsigned* s_wacc = reinterpret_cast<unsigned*>(s_wkey + a.win_cap);
  __shared__ float s_c[3][kSub], s_rt[kSub];
  __shared__ int s_wc[2][kWarps];
  __shared__ int s_scan[4];  // live windows, kept children, any dropped,
                             // distinct windows (demanded)

  const int t = blockIdx.x, tid = threadIdx.x;
  const float half = a.half, soft = a.soft, theta = a.theta;
  if (tid < kSub) {
    const int i = t * kSub + tid;
#pragma unroll
    for (int d = 0; d < 3; ++d) s_c[d][tid] = a.tgt_center[3 * i + d];
    s_rt[tid] = __fadd_rn(__fadd_rn(a.tgt_radius[i], a.tgt_skin[i]), half);
  }
  for (int r = tid; r < a.win_cap; r += kThreads) {
    s_wkey[r] = kBig;
#pragma unroll
    for (int m = 0; m < 4; ++m) s_wacc[4 * r + m] = 0u;
  }
  __syncthreads();

  // stage 0: every super-super
  int n_ss = 0;
  for (int c0 = 0; c0 < a.n_ss; c0 += kThreads) {
    const int s = c0 + tid;
    bool fail = false;
    if (s < a.n_ss) {
      const float sk = __fadd_rn(a.ss_skin[s], half);
      const float g = min_gap(a.ss_com[3 * s], a.ss_com[3 * s + 1],
                              a.ss_com[3 * s + 2], s_c, s_rt);
      fail = mac_ratio(g, a.ss_diam[s], sk, soft) >= theta &&
             a.ss_gmass[s] > 0.0f;
    }
    n_ss += append(fail, s, s_ss, n_ss, a.ss_cap, s_wc[0]);
  }

  // stage 1: the member supers of the listed super-supers (rows past
  // n_sup are the plain version's massless pad rows)
  int n_sup = 0;
  const int c_sup = 8 * min(n_ss, a.ss_cap);
  for (int c0 = 0; c0 < c_sup; c0 += kThreads) {
    const int c = c0 + tid;
    bool fail = false;
    int kid = 0;
    if (c < c_sup) {
      kid = 8 * s_ss[c >> 3] + (c & 7);
      if (kid < a.n_sup) {
        const float sk = __fadd_rn(a.sup_skin[kid], half);
        const float g = min_gap(a.sup_com[3 * kid], a.sup_com[3 * kid + 1],
                                a.sup_com[3 * kid + 2], s_c, s_rt);
        fail = mac_ratio(g, a.sup_diam[kid], sk, soft) >= theta &&
               a.sup_gmass[kid] > 0.0f;
      }
    }
    n_sup += append(fail, kid, s_sup, n_sup, a.sup_cap, s_wc[0]);
  }

  // stage 2: the cells of the listed supers (empty cells count as massive,
  // as in the plain version)
  int n_mid = 0;
  const int c_mid = 8 * min(n_sup, a.sup_cap);
  for (int c0 = 0; c0 < c_mid; c0 += kThreads) {
    const int c = c0 + tid;
    bool fail = false;
    int kid = 0;
    if (c < c_mid) {
      kid = 8 * s_sup[c >> 3] + (c & 7);
      if (kid < a.g_cap) {
        const float sk = __fadd_rn(a.cell_skin[kid], half);
        const float g = min_gap(a.cell_com[3 * kid], a.cell_com[3 * kid + 1],
                                a.cell_com[3 * kid + 2], s_c, s_rt);
        fail = mac_ratio(g, a.cell_diam[kid], sk, soft) >= theta;
      }
    }
    n_mid += append(fail, kid, s_mid, n_mid, a.mid_cap, s_wc[0]);
  }

  // stage 3: the children of the listed cells, each failing one refined to
  // its grandchild monopoles (cmid) if they pass, else exact P2P (near)
  int n_cmid = 0, n_near = 0;
  const int k_cap = 8 * a.g_cap;
  int* cmid_row = a.cmid_idx + (size_t)t * a.cmid_cap;
  const int c_kid = 8 * min(n_mid, a.mid_cap);
  for (int c0 = 0; c0 < c_kid; c0 += kThreads) {
    const int c = c0 + tid;
    bool cmid = false, near = false;
    int kid = 0;
    if (c < c_kid) {
      kid = 8 * s_mid[c >> 3] + (c & 7);
      if (kid < k_cap && a.kid_gmass[kid] > 0.0f) {
        const float sk = __fadd_rn(a.kid_skin[kid], half);
        const float g = min_gap(a.kid_com[3 * kid], a.kid_com[3 * kid + 1],
                                a.kid_com[3 * kid + 2], s_c, s_rt);
        if (mac_ratio(g, a.kid_diam[kid], sk, soft) >= theta) {
          if (a.kid_complete[kid]) {
            cmid = mac_ratio(box_gap(a.gkid_com, a.gkid_gmass, kid, s_c, s_rt),
                             a.kid_gdiam[kid], sk, soft) < theta;
          }
          near = !cmid;
        }
      }
    }
    n_cmid += append(cmid, kid, cmid_row, n_cmid, a.cmid_cap, s_wc[0]);
    n_near += append(near, kid, s_near, n_near, a.near_cap, s_wc[1]);
  }

  // the near windows: one warp over the listed children in order
  const int nn = min(n_near, a.near_cap);
  if (tid < 32) {
    const int lane = tid, pieces = a.pieces;
    long long carry = kBig;  // the previous child's last piece key
    int rank_base = -1, kept = 0, live = 0, wanted = 0;
    bool dropped = false;
    for (int k0 = 0; k0 < nn; k0 += 32) {
      const int k = k0 + lane;
      const bool on = k < nn;
      long long f = 0, cnt = 0;
      if (on) {
        const int id = s_near[k];
        f = a.kid_first[id];
        cnt = a.kid_count[id];
      }
      const long long w = f / kSpan, off = f % kSpan, end = off + cnt;
      const long long key_last =
          w + max((end + kSpan - 1) / kSpan - 1, 0LL);
      const long long last = piece_key(w, end, cnt, key_last, pieces - 1);
      long long prev = __shfl_up_sync(kFull, last, 1);
      if (lane == 0) prev = carry;
      // boundaries among this child's pieces, the first against `prev`
      int nb = 0, nw = 0;
      long long pk = prev;
      for (int j = 0; j < pieces; ++j) {
        const long long key = piece_key(w, end, cnt, key_last, j);
        const bool bnd = (k == 0 && j == 0) || key != pk;
        nb += bnd;
        nw += bnd && key < kBig;
        pk = key;
      }
      if (!on) nb = nw = 0;
      wanted += nw;
      int incl = nb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int rank_last = rank_base + incl;
      const bool drop = on && cnt > 0 && rank_last >= a.win_cap;
      if (on) {
        int r = rank_last - nb;
        pk = prev;
        for (int j = 0; j < pieces; ++j) {
          const long long key = piece_key(w, end, cnt, key_last, j);
          const bool bnd = (k == 0 && j == 0) || key != pk;
          pk = key;
          r += bnd;
          if (r >= a.win_cap) break;
          if (bnd) {
            s_wkey[r] = (int)key;
            live += key < kBig;
          }
          const long long j0 = (long long)kSpan * j;
          if (cnt > 0 && end > j0 && !drop) {
            const long long s_j = max(off - j0, 0LL);
            const long long e_j = min(end - j0, (long long)kSpan);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const unsigned word =
                  low_mask(e_j - 32 * m) & ~low_mask(s_j - 32 * m);
              if (word) atomicAdd(&s_wacc[4 * r + m], word);
            }
          }
        }
      }
      kept += __popc(__ballot_sync(kFull, on && cnt > 0 && !drop));
      dropped = dropped || __any_sync(kFull, drop);
      rank_base += __shfl_sync(kFull, incl, 31);
      carry = __shfl_sync(kFull, last, min(31, nn - 1 - k0));
    }
    live = __reduce_add_sync(kFull, live);
    wanted = __reduce_add_sync(kFull, wanted);
    if (lane == 0) {
      s_scan[0] = live;
      s_scan[1] = kept;
      s_scan[2] = dropped;
      s_scan[3] = wanted;
    }
  }
  __syncthreads();

  // the rows, padded as the plain version pads them
  const size_t row = t;
  write_row(a.ss_idx + row * a.ss_cap, s_ss, n_ss, a.ss_cap, a.n_ss);
  write_row(a.sup_idx + row * a.sup_cap, s_sup, n_sup, a.sup_cap, a.n_sup);
  write_row(a.mid_idx + row * a.mid_cap, s_mid, n_mid, a.mid_cap, a.g_cap);
  for (int k = min(n_cmid, a.cmid_cap) + tid; k < a.cmid_cap; k += kThreads) {
    cmid_row[k] = k_cap;
  }
  const int near_kept = min(nn, s_scan[1]);
  write_row(a.near_idx + row * a.near_cap, s_near, near_kept, a.near_cap,
            k_cap);
  for (int r = tid; r < a.win_cap; r += kThreads) {
    const int key = s_wkey[r];
    const bool on = key < kBig;
    a.win_first[row * a.win_cap + r] = on ? key * kSpan : 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a.win_mask[(row * 4 + m) * a.win_cap + r] =
          on ? (int)s_wacc[4 * r + m] : 0;
    }
  }
  if (tid == 0) {
    a.ss_cnt[t] = min(n_ss, a.ss_cap);
    a.sup_cnt[t] = min(n_sup, a.sup_cap);
    a.mid_cnt[t] = min(n_mid, a.mid_cap);
    a.cmid_cnt[t] = min(n_cmid, a.cmid_cap);
    a.near_cnt[t] = near_kept;
    a.win_cnt[t] = s_scan[0];
    if (n_ss > a.ss_cap) a.flags[0] = 1;
    if (n_sup > a.sup_cap) a.flags[1] = 1;
    if (n_mid > a.mid_cap) a.flags[2] = 1;
    if (n_cmid > a.cmid_cap) a.flags[3] = 1;
    if (n_near > a.near_cap || s_scan[2]) a.flags[4] = 1;
    atomicMax(a.demand + 0, n_ss);
    atomicMax(a.demand + 1, n_sup);
    atomicMax(a.demand + 2, n_mid);
    atomicMax(a.demand + 3, n_cmid);
    atomicMax(a.demand + 4, n_near);
    atomicMax(a.demand + 5, s_scan[3]);
  }
}

}  // namespace

extern "C" {

// One block of kThreads threads a tile; the lists, window keys and window
// words in dynamic shared memory.
int nbody_band_classify(const ClassifyArgs* args, void* stream) {
  const ClassifyArgs a = *args;
  if (a.pieces < 1 || a.win_cap < 0 || a.n_ss < 1 || a.ss_cap < 0 ||
      a.sup_cap < 0 || a.mid_cap < 0 || a.cmid_cap < 0 || a.near_cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int) * ((size_t)a.ss_cap + a.sup_cap +
                                     a.mid_cap + 5 * a.win_cap +
                                     (a.near_cap <= kNearSmem ? a.near_cap
                                                               : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_classify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.tiles > 0) {
    band_classify_kernel<<<a.tiles, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
