// Rotated-BEV overlap-area matrix: (N,4,2) x (M,4,2) CCW corners -> (N,M).
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/rotated_iou.py
// (overlap_matrix / _overlap_kernel / _clip_tile).
//
// What bounds it on the H100: arithmetic. Each pair runs a Sutherland-Hodgman
// clip of one quad by the four edges of the other (at most 8 vertices) and a
// shoelace sum, a few thousand scalar f32 operations, while its bytes are 64 B
// of corners in and 4 B out. Design: one thread per pair, the clipped polygon
// held in registers. Every loop over the 8 vertex slots is unrolled, and the
// compaction of emitted vertices is a chain of predicated selects over static
// slots (as in the TPU kernel), so no register array is indexed dynamically
// and nothing spills to local memory. The arithmetic is that of the plain
// PyTorch version line for line; built with --fmad=false it rounds the same.
#include <cuda_runtime.h>

namespace {

constexpr int kV = 8;          // max vertices of a quad-quad intersection
constexpr float kEps = 1e-8f;
constexpr int kThreads = 256;

__device__ __forceinline__ float clip_area(const float ax[4], const float ay[4],
                                           const float bx[4], const float by[4]) {
  float vx[kV], vy[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    vx[k] = k < 4 ? ax[k] : 0.f;
    vy[k] = k < 4 ? ay[k] : 0.f;
  }
  int count = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p1x = bx[e], p1y = by[e];
    const float ex = bx[(e + 1) & 3] - p1x;
    const float ey = by[(e + 1) & 3] - p1y;
    float side[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) side[k] = ex * (vy[k] - p1y) - ey * (vx[k] - p1x);

    float nvx[kV], nvy[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      nvx[k] = 0.f;
      nvy[k] = 0.f;
    }
    int pos = -1;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int kn = k + 1 < kV ? k + 1 : kV - 1;
      const bool wrap = (k + 1) >= count;
      const float nx = wrap ? vx[0] : vx[kn];
      const float ny = wrap ? vy[0] : vy[kn];
      const float ns = wrap ? side[0] : side[kn];
      const bool valid_slot = k < count;
      const bool inside = side[k] >= 0.f;
      const float denom = side[k] - ns;
      const float t = side[k] / (fabsf(denom) > kEps ? denom : kEps);
      const float ix = vx[k] + t * (nx - vx[k]);
      const float iy = vy[k] + t * (ny - vy[k]);
      // candidate 2k: the current vertex, if inside
      const bool ok0 = inside && valid_slot;
      pos += ok0 ? 1 : 0;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (ok0 && pos == j) {
          nvx[j] = vx[k];
          nvy[j] = vy[k];
        }
      }
      // candidate 2k+1: the edge crossing, if the edge changes sides
      const bool ok1 = (inside != (ns >= 0.f)) && valid_slot;
      pos += ok1 ? 1 : 0;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (ok1 && pos == j) {
          nvx[j] = ix;
          nvy[j] = iy;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      vx[k] = nvx[k];
      vy[k] = nvy[k];
    }
    count = pos + 1 < kV ? pos + 1 : kV;
  }
  float area = 0.f;
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int kn = k + 1 < kV ? k + 1 : kV - 1;
    const bool wrap = (k + 1) >= count;
    const float nx = wrap ? vx[0] : vx[kn];
    const float ny = wrap ? vy[0] : vy[kn];
    const float cross = vx[k] * ny - vy[k] * nx;
    area = area + (k < count ? cross : 0.f);
  }
  area = 0.5f * fabsf(area);
  return count >= 3 ? area : 0.f;
}

__global__ void __launch_bounds__(kThreads)
overlap_kernel(const float* __restrict__ ca, const float* __restrict__ cb,
               float* __restrict__ out, int n, int m) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bx[k] = cb[(size_t)j * 8 + 2 * k];
    by[k] = cb[(size_t)j * 8 + 2 * k + 1];
  }
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    float ax[4], ay[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ax[k] = __ldg(ca + (size_t)i * 8 + 2 * k);
      ay[k] = __ldg(ca + (size_t)i * 8 + 2 * k + 1);
    }
    out[(size_t)i * m + j] = clip_area(ax, ay, bx, by);
  }
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// corners_a (n,4,2), corners_b (m,4,2) f32 contiguous -> out (n,m) f32.
extern "C" int fv2p_overlap_matrix(const float* corners_a, const float* corners_b,
                                   float* out, int n, int m, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + kThreads - 1) / kThreads, n < 65535 ? n : 65535);
    overlap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        corners_a, corners_b, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
