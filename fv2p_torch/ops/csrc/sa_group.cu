// Fused two-radius set abstraction at RoI grid points: ball query + 2-layer
// MLP + max over slots, -> (R,G,2H) bf16 (radius-0 H channels | radius-1 H).
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/sa_group.py
// (sa_group_pool_fused / _kernel). Semantics: for each RoI r and grid center
// g, the first nsample points (index order) with d2 < radius^2 among the
// valid ones, empty slots backfilled with the first hit. Layer 1 comes
// precomputed per point, Z = xyz @ W1x + feats @ W1f (bf16), with the center
// term cw = center @ W1x - b1 (f32); an empty ball gives layer 1 the input
// 0 with cw = -b1. h1 = relu(Z[idx] - cw) rounded to bf16, then layer 2 with
// f32 accumulation, + b2, ReLU, and the max over slots, stored as bf16.
//
// What bounds it on the H100: arithmetic in layer 2 (a 64x64 product per
// slot, up to 48 slots per center), then the L2 reads of the gathered Z
// rows. Design: one block of 256 threads per (RoI, 8 grid centers). The
// RoI's points and both W2 sit in shared memory. Each warp runs one center's
// ball query for both radii as an ordered scan of 32 points at a time
// (ballot + popcount prefix gives each hit its slot), stopping once both
// slot lists are full. Where the TPU kernel used a one-hot matmul to select
// rows, this gathers the Z rows by index (coalesced 128 B rows). Backfilled
// slots repeat slot 0 and cannot change the max, so only min(count, nsample)
// distinct slots are computed. Layer 2 runs as f32 fmaf loops on the CUDA
// cores, thread (center, out channel) reading h1 by broadcast and W2 along
// its row; tensor cores (mma/wgmma) are later work. Distances are
// ((dx*dx + dy*dy) + dz*dz) without fused multiply-adds (--fmad=false), as
// the plain version rounds them, so the two agree on which points are in a
// ball.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kH = 64;         // hidden width of both MLP layers
constexpr int kMaxS = 32;      // largest nsample
constexpr int kCenters = 8;    // grid centers per block, one warp each
constexpr int kThreads = 256;  // 4 centers x 64 channels per layer-2 pass
constexpr int kGroup = kThreads / kH;

__global__ void __launch_bounds__(kThreads)
sa_group_kernel(const float* __restrict__ centers, const float* __restrict__ xyz,
                const unsigned char* __restrict__ valid,
                const __nv_bfloat16* __restrict__ z, const float* __restrict__ cw,
                const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b1,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                int R, int G, int P, float r2_0, float r2_1, int ns0, int ns1) {
  extern __shared__ float smem[];
  float* s_w2 = smem;                                  // [2][kH][kH]
  float* s_h1 = s_w2 + 2 * kH * kH;                    // [kGroup][2][kMaxS][kH]
  float* s_xyz = s_h1 + kGroup * 2 * kMaxS * kH;       // [P][3]
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_xyz + 3 * P);
  __shared__ int s_idx[kCenters][2][kMaxS];
  __shared__ int s_cnt[kCenters][2];

  const int r = blockIdx.y;
  const int g0 = blockIdx.x * kCenters;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < 2 * kH * kH; i += kThreads) s_w2[i] = __bfloat162float(w2[i]);
  for (int i = tid; i < 3 * P; i += kThreads) s_xyz[i] = xyz[(size_t)r * P * 3 + i];
  for (int i = tid; i < P; i += kThreads) s_valid[i] = valid[(size_t)r * P + i];
  __syncthreads();

  // ball query: warp w scans the points in index order for center g0 + w
  {
    const int g = g0 + warp;
    int c0 = 0, c1 = 0;
    if (g < G) {
      const float* cp = centers + ((size_t)r * G + g) * 3;
      const float cx = cp[0], cy = cp[1], cz = cp[2];
      const unsigned lt = (1u << lane) - 1u;
      for (int base = 0; base < P; base += 32) {
        const int p = base + lane;
        bool in0 = false, in1 = false;
        if (p < P && s_valid[p]) {
          const float dx = cx - s_xyz[3 * p], dy = cy - s_xyz[3 * p + 1],
                      dz = cz - s_xyz[3 * p + 2];
          const float d2 = dx * dx + dy * dy + dz * dz;
          in0 = d2 < r2_0;
          in1 = d2 < r2_1;
        }
        const unsigned m0 = __ballot_sync(0xffffffffu, in0);
        const unsigned m1 = __ballot_sync(0xffffffffu, in1);
        if (in0) {
          const int pos = c0 + __popc(m0 & lt);
          if (pos < ns0) s_idx[warp][0][pos] = p;
        }
        if (in1) {
          const int pos = c1 + __popc(m1 & lt);
          if (pos < ns1) s_idx[warp][1][pos] = p;
        }
        c0 += __popc(m0);
        c1 += __popc(m1);
        if (c0 >= ns0 && c1 >= ns1) break;
      }
    }
    if (lane == 0) {
      s_cnt[warp][0] = c0;
      s_cnt[warp][1] = c1;
    }
  }
  __syncthreads();

  for (int grp = 0; grp < kCenters / kGroup; ++grp) {
    // layer 1: h1[j][i][s][k] = bf16(relu(Z[idx] - cw)) for the distinct slots
    for (int e = tid; e < kGroup * 2 * kMaxS * kH; e += kThreads) {
      const int k = e % kH;
      const int s = (e / kH) % kMaxS;
      const int i = (e / (kH * kMaxS)) % 2;
      const int cl = grp * kGroup + e / (kH * kMaxS * 2);
      const int g = g0 + cl;
      if (g >= G) continue;
      const int cnt = s_cnt[cl][i];
      const int ns = i ? ns1 : ns0;
      const int neff = cnt == 0 ? 1 : (cnt < ns ? cnt : ns);
      if (s >= neff) continue;
      float t, c;
      if (cnt > 0) {
        const int p = s_idx[cl][i][s];
        t = __bfloat162float(z[(((size_t)i * R + r) * P + p) * kH + k]);
        c = cw[(((size_t)i * R + r) * G + g) * kH + k];
      } else {
        t = 0.f;
        c = -b1[i * kH + k];
      }
      s_h1[e] = __bfloat162float(__float2bfloat16(fmaxf(t - c, 0.f)));
    }
    __syncthreads();

    // layer 2 + max over slots: thread (center j, output channel ch)
    const int j = tid / kH, ch = tid % kH;
    const int cl = grp * kGroup + j;
    const int g = g0 + cl;
    if (g < G) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int cnt = s_cnt[cl][i];
        const int ns = i ? ns1 : ns0;
        const int neff = cnt == 0 ? 1 : (cnt < ns ? cnt : ns);
        const float* w = s_w2 + i * kH * kH + ch;
        const float bias = b2[i * kH + ch];
        float best = 0.f;  // every slot is a ReLU output, >= 0
        for (int s = 0; s < neff; ++s) {
          const float* h = s_h1 + ((j * 2 + i) * kMaxS + s) * kH;
          float acc = 0.f;
#pragma unroll 16
          for (int k = 0; k < kH; ++k) acc = fmaf(h[k], w[k * kH], acc);
          best = fmaxf(best, fmaxf(acc + bias, 0.f));
        }
        out[((size_t)r * G + g) * 2 * kH + i * kH + ch] = __float2bfloat16(best);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// centers (R,G,3), xyz (R,P,3) f32; valid (R,P) uint8; z (2,R,P,64) bf16;
// cw (2,R,G,64) f32; w2 (2,64,64) bf16; b1, b2 (2,64) f32 -> out (R,G,128) bf16.
// Requires nsamples <= 32.
extern "C" int fv2p_sa_group(const float* centers, const float* xyz,
                             const unsigned char* valid, const void* z, const float* cw,
                             const void* w2, const float* b1, const float* b2, void* out,
                             int R, int G, int P, float r2_0, float r2_1, int ns0, int ns1,
                             void* stream) {
  if (R == 0 || G == 0) return 0;
  if (ns0 > kMaxS || ns1 > kMaxS || ns0 < 1 || ns1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = (size_t)(2 * kH * kH + kGroup * 2 * kMaxS * kH + 3 * P) * sizeof(float) +
                     (size_t)P;
  cudaError_t err = cudaFuncSetAttribute(sa_group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G + kCenters - 1) / kCenters, R);
  sa_group_kernel<<<grid, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      centers, xyz, valid, static_cast<const __nv_bfloat16*>(z), cw,
      static_cast<const __nv_bfloat16*>(w2), b1, b2, static_cast<__nv_bfloat16*>(out), R, G,
      P, r2_0, r2_1, ns0, ns1);
  return static_cast<int>(cudaGetLastError());
}
