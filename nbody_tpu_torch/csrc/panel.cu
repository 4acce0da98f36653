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
// Pallas kernel's (preferred_element_type=float32), and S is formed in
// the kernel's own body with FMAs; a tensor-core (mma) version of S is
// later work.
//
// Bound: FP32 throughput.  About 20 operations per pair (19 for vpu) and
// one rsqrt; every source staged in shared memory is read by all 256
// threads of the block, and each target is read and written once.  One
// target per thread, one 256-target panel per block, sources staged
// through shared memory one 1024-source chunk at a time.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;    // targets per panel (_prof_mxu.B)
constexpr int kChunk = 1024;  // sources per chunk (_prof_mxu.LC)

template <int V>
__global__ void __launch_bounds__(kTile)
    panel_sweep_kernel(const float* __restrict__ pos3,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ gz,
                       const float* __restrict__ gm, int n_chunks, float soft,
                       float* __restrict__ out) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], sm[kChunk];
  const int tid = threadIdx.x;
  const size_t i = (size_t)blockIdx.x * kTile + tid;
  float px = pos3[3 * i], py = pos3[3 * i + 1], pz = pos3[3 * i + 2];
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if constexpr (V == 2) {
    // the panel's mean target (jnp.mean over the 256 rows)
    __shared__ float red[3][kTile];
    red[0][tid] = px;
    red[1][tid] = py;
    red[2][tid] = pz;
    __syncthreads();
    for (int s = kTile / 2; s > 0; s >>= 1) {
      if (tid < s) {
        red[0][tid] += red[0][tid + s];
        red[1][tid] += red[1][tid + s];
        red[2][tid] += red[2][tid + s];
      }
      __syncthreads();
    }
    cx = red[0][0] * (1.0f / kTile);
    cy = red[1][0] * (1.0f / kTile);
    cz = red[2][0] * (1.0f / kTile);
    px -= cx;
    py -= cy;
    pz -= cz;
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk is consumed
    for (int k = tid; k < kChunk; k += kTile) {
      const int j = c * kChunk + k;
      sx[k] = gx[j] - cx;
      sy[k] = gy[j] - cy;
      sz[k] = gz[j] - cz;
      sm[k] = gm[j];
    }
    __syncthreads();
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float qx = sx[k], qy = sy[k], qz = sz[k];
      const float dx = qx - px;
      const float dy = qy - py;
      const float dz = qz - pz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float inv = rsqrtf(d2 + soft);
      const float w = sm[k] * (inv * inv * inv);
      if constexpr (V == 0) {
        s1 += w * dx;
        s2 += w * dy;
        s3 += w * dz;
      } else {
        s0 += w;
        s1 += w * qx;
        s2 += w * qy;
        s3 += w * qz;
      }
    }
    if constexpr (V == 0) {
      ax += s1;
      ay += s2;
      az += s3;
    } else {
      ax += s1 - px * s0;
      ay += s2 - py * s0;
      az += s3 - pz * s0;
    }
  }
  out[3 * i] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
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
      panel_sweep_kernel<0><<<tiles, kTile, 0, s>>>(pos3, gx, gy, gz, gm,
                                                    n_chunks, soft, out);
    } else if (variant == 1) {
      panel_sweep_kernel<1><<<tiles, kTile, 0, s>>>(pos3, gx, gy, gz, gm,
                                                    n_chunks, soft, out);
    } else {
      panel_sweep_kernel<2><<<tiles, kTile, 0, s>>>(pos3, gx, gy, gz, gm,
                                                    n_chunks, soft, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
