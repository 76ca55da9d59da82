// Exact farthest-point sampling: (B,N) planar x/y/z + valid -> (B,K) int32.
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/fps.py (fps_pallas /
// _fps_kernel). Pick 0 is the first valid index (0 if none). Each later pick
// updates every point's running min squared distance to the picked set and
// takes the argmax, the lowest index winning ties; invalid points sit at
// -1e10 and never win.
//
// What bounds it on the H100: the dependency chain. The K-1 picks are
// strictly sequential and each needs an argmax over all N points, so the
// kernel is a chain of K-1 block-wide reductions; bytes (N*13 B once) and
// operations (~10 per point per pick) are far below the card's rates.
// Design: one block of 1024 threads per batch row, so a pick never leaves
// the SM. Each thread keeps its points' running min distances in registers
// (points tid, tid+1024, ...; kPointsPerThread of them, so N <= 18432), and
// the coordinates sit in shared memory (12*N bytes, 216 KB at N = 18000,
// opted in). A pick is a register scan, a warp-shuffle
// (value, lowest index) argmax, and one pass over the 32 warp results in
// shared memory: two __syncthreads per pick. Distances are
// ((dx*dx + dy*dy) + dz*dz) without fused multiply-adds (--fmad=false), as
// the plain version rounds them.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kPointsPerThread = 18;  // 18000 raw points on the main path
constexpr int kMaxPoints = kThreads * kPointsPerThread;
constexpr float kBig = 1e10f;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
           const float* __restrict__ gz, const unsigned char* __restrict__ valid,
           int* __restrict__ out, int n, int k_samples) {
  extern __shared__ float smem[];
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * n;
  float* xs = smem;
  float* ys = smem + n;
  float* zs = smem + 2 * n;
  for (int i = tid; i < n; i += kThreads) {
    xs[i] = gx[row + i];
    ys[i] = gy[row + i];
    zs[i] = gz[row + i];
  }

  // running min distances in registers; first valid index by a min-reduction
  float dist[kPointsPerThread];
  int first = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < kPointsPerThread; ++j) {
    const int i = tid + j * kThreads;
    const bool ok = i < n && valid[row + i];
    dist[j] = i < n ? (ok ? kBig : -kBig) : -INFINITY;
    if (ok && i < first) first = i;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) first = min(first, __shfl_down_sync(0xffffffffu, first, off));
  if (lane == 0) red_idx[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int f = red_idx[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) f = min(f, __shfl_down_sync(0xffffffffu, f, off));
    if (lane == 0) {
      s_pick = f >= n ? 0 : f;
      out[(size_t)b * k_samples] = s_pick;
    }
  }
  __syncthreads();
  int last = s_pick;

  for (int k = 1; k < k_samples; ++k) {
    const float cx = xs[last], cy = ys[last], cz = zs[last];
    float best = -INFINITY;
    int besti = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) {
        const float dx = xs[i] - cx, dy = ys[i] - cy, dz = zs[i] - cz;
        const float d = dx * dx + dy * dy + dz * dz;
        const float nd = fminf(dist[j], d);
        dist[j] = nd;
        if (nd > best) {
          best = nd;
          besti = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      argmax_merge(best, besti, ov, oi);
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      float v = red_val[lane];
      int vi = red_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, vi, off);
        argmax_merge(v, vi, ov, oi);
      }
      if (lane == 0) {
        s_pick = vi;
        out[(size_t)b * k_samples + k] = vi;
      }
    }
    __syncthreads();
    last = s_pick;
  }
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y, z (b,n) f32; valid (b,n) uint8; out (b,k) int32. Requires n <= 18432.
extern "C" int fv2p_fps(const float* x, const float* y, const float* z,
                        const unsigned char* valid, int* out, int b, int n, int k,
                        void* stream) {
  if (b == 0 || k == 0) return 0;
  if (n < 1 || n > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = 3 * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, valid, out, n, k);
  return static_cast<int>(cudaGetLastError());
}
