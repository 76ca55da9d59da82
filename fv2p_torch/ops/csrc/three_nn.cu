// Exact 3-nearest-neighbour search: queries (B,M,3) against sources (B,N,3)
// + valid -> ascending squared distances (B,M,3) f32 and indices (B,M,3) int32.
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/three_nn.py
// (three_nn_pallas / _three_nn_kernel / _merge_sorted3). Distances are
// elementwise f32 ((dx*dx + dy*dy) + dz*dz, no matmul expansion, no fused
// multiply-adds: --fmad=false), invalid sources carry +1e10, the result is
// the three smallest in (distance, index) order, so the lowest index wins a
// tie. The output is clamped to d >= 0 and idx in [0, N-1].
//
// What bounds it on the H100: arithmetic. Every query meets every source of
// its sample (~10 f32 operations a pair) while the bytes are 12 B a point.
// Design: one thread per query, 256 queries a block, one block row per batch
// sample; the sources stream through shared memory in tiles of 1024 float4
// (x, y, z, invalid offset), read by all threads at the same address
// (broadcast, no bank conflicts). The running best-3 lives in registers; the
// sources are scanned in index order and only a strictly smaller distance
// displaces an entry, which is the (distance, index) order of the TPU
// kernel's merge.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1e10f;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ src,
                const unsigned char* __restrict__ src_valid, float* __restrict__ out_d,
                int* __restrict__ out_i, int m, int n) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float* qp = query + ((size_t)b * m + (q < m ? q : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* sp = src + (size_t)b * n * 3;
  const unsigned char* vp = src_valid + (size_t)b * n;

  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0x7fffffff, i1 = 0x7fffffff, i2 = 0x7fffffff;
  for (int base = 0; base < n; base += kTile) {
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
      const int s = base + t;
      float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (s < n) {
        v.x = sp[(size_t)s * 3];
        v.y = sp[(size_t)s * 3 + 1];
        v.z = sp[(size_t)s * 3 + 2];
        v.w = vp[s] ? 0.f : kBig;
      }
      tile[t] = v;
    }
    __syncthreads();
    const int lim = n - base < kTile ? n - base : kTile;
    for (int t = 0; t < lim; ++t) {
      const float4 v = tile[t];
      const float dx = qx - v.x, dy = qy - v.y, dz = qz - v.z;
      const float d = (dx * dx + dy * dy + dz * dz) + v.w;
      if (d < d2) {
        const int idx = base + t;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = idx;
          } else {
            d1 = d;
            i1 = idx;
          }
        } else {
          d2 = d;
          i2 = idx;
        }
      }
    }
    __syncthreads();
  }
  if (q < m) {
    const size_t o = ((size_t)b * m + q) * 3;
    out_d[o] = fmaxf(d0, 0.f);
    out_d[o + 1] = fmaxf(d1, 0.f);
    out_d[o + 2] = fmaxf(d2, 0.f);
    out_i[o] = min(max(i0, 0), n - 1);
    out_i[o + 1] = min(max(i1, 0), n - 1);
    out_i[o + 2] = min(max(i2, 0), n - 1);
  }
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// query (b,m,3), src (b,n,3) f32; src_valid (b,n) uint8 -> out_d, out_i (b,m,3).
extern "C" int fv2p_three_nn(const float* query, const float* src,
                             const unsigned char* src_valid, float* out_d, int* out_i,
                             int b, int m, int n, void* stream) {
  if (b > 0 && m > 0 && n > 0) {
    const dim3 grid((m + kThreads - 1) / kThreads, b);
    three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        query, src, src_valid, out_d, out_i, m, n);
  }
  return static_cast<int>(cudaGetLastError());
}
