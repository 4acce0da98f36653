// Hand-written Hopper (sm_90a) kernel for the far sweep of
// nbody_tpu_torch's Barnes-Hut force: every target against the live
// top-level aggregates.  (The two per-tile sweeps, near_span and
// table_sweep, live in tile_sweeps.cu with their own arithmetic and
// flags.)  Plain C interface, bound with ctypes by
// nbody_tpu_torch/ops/cuda/forces.py; the entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// It evaluates the v5 force law on float32 sources (x, y, z, m):
//     a += m * d / (|d|^2 + soft)^{3/2},   d = source - target,
// with m carrying G.  Per interaction that is about 20 FP32 operations
// with one square root and one division, so the sweep is bound by FP32
// throughput (67 TFLOP/s on an H100 SXM), not by memory: every source
// staged in shared memory is reused by every thread of the block.  One
// target per thread, sums in registers, sources staged through shared
// memory in blocks of the thread count.
//
// Numerics: which kernel keeps which arithmetic.  The band decomposition
// CANCELS large terms (with no_ss the far sweep holds every super-super
// monopole, the target's own included, and the table sweep's anti rows
// take them back out), so a tile's sweep can be 100-1000x its total.
//   * far_sweep (this file) keeps exact agreement with its plain PyTorch
//     version: each term is rounded as the plain version rounds it (the
//     library is built with -fmad=false: no fused multiply-adds; the same
//     operation order; a correctly rounded sqrtf and division where torch
//     computes 1 / torch.sqrt), and the three sums are held in float64, as
//     the plain version sums the same float32 terms.  (A compensated
//     float32 sum is not enough: Kahan's correction fails when a term
//     outweighs the running sum, which cancellation makes common.)  It is
//     0.2 ms of a step, launched once per far+mid refresh, so the exact
//     arithmetic costs little here and its sum is the largest of the three.
//   * near_span and table_sweep (tile_sweeps.cu) are held to their plain
//     versions by an error bound instead, and take fused multiply-adds, the
//     SFU's rsqrt and chunked float32 partial sums as far as that bound
//     allows; the note there says which and why.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFarThreads = 256;

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

}  // extern "C"
