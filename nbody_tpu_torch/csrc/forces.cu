// Hand-written Hopper (sm_90a) kernels for the three Barnes-Hut force
// sweeps of nbody_tpu_torch.  Plain C interface, bound with ctypes by
// nbody_tpu_torch/ops/cuda/forces.py; each entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// All three evaluate the v5 force law on float32 sources (x, y, z, m):
//     a += m * d / (|d|^2 + soft)^{3/2},   d = source - target,
// with m carrying G.  Per interaction that is about 20 FP32 operations
// with one square root and one division, so each sweep is bound by FP32
// throughput (67 TFLOP/s on an H100 SXM), not by memory: every source
// staged in shared memory is reused by every thread of the block.  The
// first versions keep one target per thread, accumulate in registers and
// stage sources through shared memory in blocks of the thread count;
// tensor cores (a w.[1|q] mma formulation), TMA and clusters are later
// work.
//
// Numerics: the band decomposition CANCELS large terms (with no_ss the
// far sweep holds every super-super monopole, the target's own included,
// and the table sweep's anti rows take them back out), so a tile's sweep
// can be 100-1000x its total.  Plain float32 sums in two different orders
// then disagree by ~1e-4 of the total.  So each term is rounded exactly as
// the plain PyTorch version rounds it (built with -fmad=false: no fused
// multiply-adds; the same operation order; a correctly rounded sqrtf and
// division where torch computes 1 / torch.sqrt, since rsqrtf's 2-ulp
// approximation is not reproducible from PyTorch), and the three sums
// are held in float64, as the plain version sums the same float32 terms.
// (A compensated float32 sum is not enough: Kahan's correction fails
// when a term outweighs the running sum, which cancellation makes common,
// and left 1-ulp disagreements on ~23% of targets.)  Kernel and plain
// then round the same nearly exact sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFarThreads = 256;
constexpr int kTableThreads = 256;
constexpr int kWindow = 128;  // near-window width (forces.SPAN_ALIGN)

// Running sum of float32 force terms, held in float64.
struct Sum {
  double s = 0.0;
  __device__ __forceinline__ void add(float x) { s += (double)x; }
  __device__ __forceinline__ float total() const { return (float)s; }
};

__device__ __forceinline__ void accumulate(const float4* __restrict__ src,
                                           int count, float px, float py,
                                           float pz, float soft, Sum& ax,
                                           Sum& ay, Sum& az) {
#pragma unroll 4
  for (int k = 0; k < count; ++k) {
    const float4 q = src[k];
    const float dx = q.x - px;
    const float dy = q.y - py;
    const float dz = q.z - pz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float inv = 1.0f / sqrtf(d2 + soft);
    const float w = q.w * (inv * inv * inv);
    ax.add(w * dx);
    ay.add(w * dy);
    az.add(w * dz);
  }
}

// Replaces far_sweep_pallas / _far_kernel (nbody_tpu/ops/pallas/forces.py:
// 110-173): every target against the live prefix of the top-level
// aggregates.  The live count is read from device memory (no host sync).
// Bound: FP32 throughput, N * n_live interactions; the ~154 aggregates are
// staged once per block in shared memory, and targets are read once.
__global__ void far_sweep_kernel(const float* __restrict__ pos, int n,
                                 const float* __restrict__ com,
                                 const float* __restrict__ gmass, int s_cap,
                                 const int* __restrict__ n_live_ptr,
                                 float soft, float* __restrict__ acc) {
  __shared__ float4 src[kFarThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_live = min(*n_live_ptr, s_cap);
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = pos[3 * i];
    py = pos[3 * i + 1];
    pz = pos[3 * i + 2];
  }
  Sum ax, ay, az;
  for (int base = 0; base < n_live; base += kFarThreads) {
    const int j = base + threadIdx.x;
    if (j < n_live) {
      src[threadIdx.x] =
          make_float4(com[3 * j], com[3 * j + 1], com[3 * j + 2], gmass[j]);
    }
    __syncthreads();
    accumulate(src, min(kFarThreads, n_live - base), px, py, pz, soft, ax, ay,
               az);
    __syncthreads();
  }
  if (i < n) {
    acc[3 * i] = ax.total();
    acc[3 * i + 1] = ay.total();
    acc[3 * i + 2] = az.total();
  }
}

// Replaces table_sweep_pallas / _table_kernel (:181-268): each tile's
// targets against the two live regions of the tile's planar table row,
// [0, near_cnt) and [near_cap, row_cnt).  Grid (tiles, ceil(B/256)).
// Bound: FP32 throughput, B * (live rows) per tile; rows are staged in
// shared memory in chunks of 256, so each row is read from device memory
// once per block (twice per tile at B = 512).
__global__ void table_sweep_kernel(const float* __restrict__ pos, int b,
                                   const float* __restrict__ tx,
                                   const float* __restrict__ ty,
                                   const float* __restrict__ tz,
                                   const float* __restrict__ tm, int rows,
                                   const int* __restrict__ near_cnt,
                                   const int* __restrict__ row_cnt,
                                   int near_cap, float soft,
                                   float* __restrict__ acc) {
  __shared__ float4 src[kTableThreads];
  const int t = blockIdx.x;
  const int local = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = local < b;
  const size_t i = (size_t)t * b + local;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    px = pos[3 * i];
    py = pos[3 * i + 1];
    pz = pos[3 * i + 2];
  }
  const size_t row0 = (size_t)t * rows;
  const int lo[2] = {0, near_cap};
  const int hi[2] = {min(near_cnt[t], near_cap), min(row_cnt[t], rows)};
  Sum ax, ay, az;
  for (int reg = 0; reg < 2; ++reg) {
    for (int base = lo[reg]; base < hi[reg]; base += kTableThreads) {
      const int j = base + threadIdx.x;
      if (j < hi[reg]) {
        const size_t r = row0 + j;
        src[threadIdx.x] = make_float4(tx[r], ty[r], tz[r], tm[r]);
      }
      __syncthreads();
      accumulate(src, min(kTableThreads, hi[reg] - base), px, py, pz, soft,
                 ax, ay, az);
      __syncthreads();
    }
  }
  if (active) {
    acc[3 * i] = ax.total();
    acc[3 * i + 1] = ay.total();
    acc[3 * i + 2] = az.total();
  }
}

// Replaces near_span_pallas / _near_kernel (:276-480): exact P2P of each
// tile's targets against its win_cnt[t] deduplicated 128-wide source
// windows.  Block of 128 threads: thread l loads lane l of the window
// (coalesced) and keeps it only if bit l%32 of mask word l/32 is set
// (mass zeroed otherwise, G folded in), then every thread sweeps the
// staged window for its target.  Grid (tiles, ceil(B/128)).  Iterates
// win_cnt, as the Pallas kernel does.  Bound: FP32 throughput over the
// executed lanes (128 per window, masked lanes included).
__global__ void near_span_kernel(const float* __restrict__ tgt, int b,
                                 const float* __restrict__ src_pos,
                                 const float* __restrict__ src_mass,
                                 int n_src,
                                 const int* __restrict__ win_first,
                                 const int* __restrict__ win_mask,
                                 const int* __restrict__ win_cnt, int w_cap,
                                 float g, float soft,
                                 float* __restrict__ acc) {
  __shared__ float4 src[kWindow];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int local = blockIdx.y * kWindow + lane;
  const bool active = local < b;
  const size_t i = (size_t)t * b + local;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    px = tgt[3 * i];
    py = tgt[3 * i + 1];
    pz = tgt[3 * i + 2];
  }
  const int cnt = min(win_cnt[t], w_cap);
  const int* first = win_first + (size_t)t * w_cap;
  const int* word = win_mask + ((size_t)t * 4 + (lane >> 5)) * w_cap;
  Sum ax, ay, az;
  for (int k = 0; k < cnt; ++k) {
    const int j = first[k] + lane;
    const unsigned bits = (unsigned)word[k];
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (((bits >> (lane & 31)) & 1u) && j < n_src) {
      q = make_float4(src_pos[3 * (size_t)j], src_pos[3 * (size_t)j + 1],
                      src_pos[3 * (size_t)j + 2], g * src_mass[j]);
    }
    src[lane] = q;
    __syncthreads();
    accumulate(src, kWindow, px, py, pz, soft, ax, ay, az);
    __syncthreads();
  }
  if (active) {
    acc[3 * i] = ax.total();
    acc[3 * i + 1] = ay.total();
    acc[3 * i + 2] = az.total();
  }
}

}  // namespace

extern "C" {

int nbody_far_sweep(const float* pos, int n, const float* com,
                    const float* gmass, int s_cap, const int* n_live,
                    float soft, float* acc, void* stream) {
  if (n > 0) {
    const int blocks = (n + kFarThreads - 1) / kFarThreads;
    far_sweep_kernel<<<blocks, kFarThreads, 0, (cudaStream_t)stream>>>(
        pos, n, com, gmass, s_cap, n_live, soft, acc);
  }
  return (int)cudaGetLastError();
}

int nbody_table_sweep(const float* pos, int tiles, int b, const float* tx,
                      const float* ty, const float* tz, const float* tm,
                      int rows, const int* near_cnt, const int* row_cnt,
                      int near_cap, float soft, float* acc, void* stream) {
  if (tiles > 0) {
    const dim3 grid(tiles, (b + kTableThreads - 1) / kTableThreads);
    table_sweep_kernel<<<grid, kTableThreads, 0, (cudaStream_t)stream>>>(
        pos, b, tx, ty, tz, tm, rows, near_cnt, row_cnt, near_cap, soft, acc);
  }
  return (int)cudaGetLastError();
}

int nbody_near_span(const float* tgt, int tiles, int b, const float* src_pos,
                    const float* src_mass, int n_src, const int* win_first,
                    const int* win_mask, const int* win_cnt, int w_cap,
                    float g, float soft, float* acc, void* stream) {
  if (tiles > 0) {
    const dim3 grid(tiles, (b + kWindow - 1) / kWindow);
    near_span_kernel<<<grid, kWindow, 0, (cudaStream_t)stream>>>(
        tgt, b, src_pos, src_mass, n_src, win_first, win_mask, win_cnt, w_cap,
        g, soft, acc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
