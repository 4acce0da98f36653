// Hand-written Hopper (sm_90a) kernel for the far-sweep panel probe of
// nbody_tpu_torch.tools.prof_mxu.  Plain C interface, bound with ctypes by
// nbody_tpu_torch/ops/cuda/panel.py; the entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// Replaces tools/_prof_mxu.py:sweep (the Pallas call at :79, kernel body
// make_kernel :64-73, panels :22-62): a panel of 256 targets against the
// sources in chunks of 1024, the chunk's partial added to the target's
// sum.  The panel is written three ways (template argument V):
//   V = 0 (vpu):   a += sum_j w_j d_j, d = q - p;
//   V = 1 (mxu):   S = sum_j w_j [1, q_j]; a += S[1:4] - p S[0];
//   V = 2 (mxu_c): V = 1 with p and q centred on the 256 targets' mean,
// with w = m / (|d|^2 + soft)^{3/2} (rsqrtf, as lax.rsqrt).  V = 1 and 2
// rest on the identity sum w (q - p) = sum w q - p sum w, whose float32
// cancellation is what the probe measures, so every sum is float32 as the
// Pallas kernel's (preferred_element_type=float32), each target's chunk
// sum taken source by source in order, and S is formed in the kernel's
// own body with FMAs; a tensor-core (mma) version of S is later work.
//
// Bound: the issue rate (one warp instruction per clock per SM
// sub-partition).  The bound counts 19 (vpu) or 20 FP32 operations a pair;
// with fused multiply-adds a pair is 13 (vpu) or 14 FP32 instructions and
// one SFU rsqrt, and rsqrtf's check for a denormal argument (a compare
// and two predicated multiplies, never taken here: the argument is at
// least soft) adds three, so about 17-19 instructions a pair are issued
// and a bit over half of the bound is the most this arithmetic can reach.
// What the design does about the rest:
//   * kTargets = 4 targets a thread (a panel is one block of 64 threads),
//     so one 16-byte broadcast shared-memory load of a source (x, y, z, m)
//     feeds four pairs and the loop's overhead is shared (two targets a
//     thread at 128 threads measured slower in every variant);
//   * the sources of a chunk are staged as float4 in shared memory through
//     a two-stage cp.async ring, so chunk c + 1 is in flight while chunk c
//     is swept, with one barrier pair per chunk (stages of half a chunk,
//     which fit twice the blocks on an SM, measured no faster);
//   * the pair loop is unrolled by kUnroll with no remainder (a chunk is
//     1024 sources).
// Each target's sums take the same operations in the same order as the
// one-target-a-thread kernel this replaced, so the output is bit-equal
// to that kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // targets per panel (_prof_mxu.B)
constexpr int kChunk = 1024;  // sources per chunk (_prof_mxu.LC)
constexpr int kTargets = 4;   // targets per thread
constexpr int kThreads = kTile / kTargets;
constexpr int kUnroll = 8;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem));
}

// One panel per block, R = kTargets targets a thread: target r of thread
// tid is row r * kThreads + tid of the panel, so a warp's loads are
// contiguous.
template <int V>
__global__ void __launch_bounds__(kThreads)
    panel_sweep_kernel(const float* __restrict__ pos3,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ gz,
                       const float* __restrict__ gm, int n_chunks, float soft,
                       float* __restrict__ out) {
  constexpr int R = kTargets;
  __shared__ float4 buf[2][kChunk];
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * kTile;
  float p[R][3];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t i = row0 + r * kThreads + tid;
#pragma unroll
    for (int c = 0; c < 3; ++c) p[r][c] = pos3[3 * i + c];
  }
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if constexpr (V == 2) {
    // the panel's mean target (jnp.mean over the 256 rows), by a tree over
    // the rows in their panel order
    __shared__ float red[3][kTile];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) red[c][r * kThreads + tid] = p[r][c];
    }
    __syncthreads();
    for (int s = kTile / 2; s > 0; s >>= 1) {
      for (int i = tid; i < s; i += kThreads) {
#pragma unroll
        for (int c = 0; c < 3; ++c) red[c][i] += red[c][i + s];
      }
      __syncthreads();
    }
    cx = red[0][0] * (1.0f / kTile);
    cy = red[1][0] * (1.0f / kTile);
    cz = red[2][0] * (1.0f / kTile);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r][0] -= cx;
      p[r][1] -= cy;
      p[r][2] -= cz;
    }
  }

  auto stage = [&](int chunk) {
    float4* dst = buf[chunk & 1];
    const size_t j0 = (size_t)chunk * kChunk;
    for (int k = tid; k < kChunk; k += kThreads) {
      cp_async4(&dst[k].x, gx + j0 + k);
      cp_async4(&dst[k].y, gy + j0 + k);
      cp_async4(&dst[k].z, gz + j0 + k);
      cp_async4(&dst[k].w, gm + j0 + k);
    }
    asm volatile("cp.async.commit_group;");
  };

  float a[R][3] = {};
  if (n_chunks > 0) stage(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      stage(chunk + 1);
      asm volatile("cp.async.wait_group 1;");
    } else {
      asm volatile("cp.async.wait_group 0;");
    }
    __syncthreads();
    const float4* __restrict__ src = buf[chunk & 1];
    float s[R][4] = {};
    for (int k = 0; k < kChunk; k += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 q = src[k + u];
        const float qx = q.x - cx, qy = q.y - cy, qz = q.z - cz;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = qx - p[r][0];
          const float dy = qy - p[r][1];
          const float dz = qz - p[r][2];
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float inv = rsqrtf(d2 + soft);
          const float w = q.w * (inv * inv * inv);
          if constexpr (V == 0) {
            s[r][1] += w * dx;
            s[r][2] += w * dy;
            s[r][3] += w * dz;
          } else {
            s[r][0] += w;
            s[r][1] += w * qx;
            s[r][2] += w * qy;
            s[r][3] += w * qz;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (V == 0) {
          a[r][c] += s[r][c + 1];
        } else {
          a[r][c] += s[r][c + 1] - p[r][c] * s[r][0];
        }
      }
    }
    __syncthreads();    // before chunk + 2 overwrites this stage
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t i = row0 + r * kThreads + tid;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * i + c] = a[r][c];
  }
}

}  // namespace

extern "C" {

// variant 0 vpu, 1 mxu, 2 mxu_c; pos3 [tiles, 256, 3], g* [n_src] with
// n_src a multiple of 1024, out [tiles, 256, 3].
int nbody_panel_sweep(int variant, const float* pos3, int tiles,
                      const float* gx, const float* gy, const float* gz,
                      const float* gm, int n_src, float soft, float* out,
                      void* stream) {
  if (n_src % kChunk != 0 || variant < 0 || variant > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles > 0) {
    const int n_chunks = n_src / kChunk;
    cudaStream_t s = (cudaStream_t)stream;
    if (variant == 0) {
      panel_sweep_kernel<0><<<tiles, kThreads, 0, s>>>(pos3, gx, gy, gz, gm,
                                                       n_chunks, soft, out);
    } else if (variant == 1) {
      panel_sweep_kernel<1><<<tiles, kThreads, 0, s>>>(pos3, gx, gy, gz, gm,
                                                       n_chunks, soft, out);
    } else {
      panel_sweep_kernel<2><<<tiles, kThreads, 0, s>>>(pos3, gx, gy, gz, gm,
                                                       n_chunks, soft, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
