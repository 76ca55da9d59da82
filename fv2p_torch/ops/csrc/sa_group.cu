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
// What bounds it on the H100: by the bytes it must move (Z, cw and the
// output once: the bound in PERF.md), in practice by warp scheduling and
// the L2 latency of the gathered Z rows; the layer-2 products are a small
// share of the tensor cores' rate.
//
// Design: one block per (RoI, a fixed share of its grid centers); both W2
// (bf16, rows padded to 144 B so ldmatrix has no bank conflicts), the
// biases and the RoI's points are loaded once per block, an invalid point
// stored with x = +inf so that it is in no ball. After that prologue each
// warp loops over centers on its own, with no block barrier:
//   * Ball query for both radii as an ordered scan of 32 points at a time
//     (ballot + popcount prefix gives each hit its slot), stopping once both
//     slot lists are full. Distances are ((dx*dx + dy*dy) + dz*dz) without
//     fused multiply-adds (--fmad=false), as the plain version rounds them.
//   * The Z rows of the distinct slots (128 B each) and the center's two cw
//     rows come by cp.async (16 B a lane) into one of the warp's two staging
//     tiles; the copies of the next center are in flight while the current
//     one is computed. A tile row's 16-byte chunks are XOR-swizzled by the
//     row so that ldmatrix reads 8 rows without bank conflicts.
//   * Layer 1 is applied to the A fragment in registers: ldmatrix.x4 gives a
//     lane rows lane/4 and lane/4+8, columns 16*ks + 2*(lane%4) + {0,1} and
//     + 8; relu(z - cw) is rounded to bf16 there (cvt.rn.bf16x2).
//   * Layer 2 is mma.sync.m16n8k16 (bf16 x bf16 -> f32): per radius 1 or 2
//     row tiles of 16 slots x 8 column tiles x 4 depth steps, W2 fragments by
//     ldmatrix.trans from shared memory. bf16 products are exact in f32, so
//     only the order of the sum differs from the plain version.
//   * Max over slots in the accumulator fragment: a lane holds rows lane/4
//     and lane/4+8 of columns 8*j + 2*(lane%4) + {0,1} for each column tile
//     j. Rows beyond the distinct slots are masked to -inf (backfilled slots
//     repeat slot 0 and cannot change the max; a zero row would pool
//     relu(b2)). The 8 lanes that share lane%4 then reduce-scatter over
//     lane bits 4, 3, 2 (__shfl_xor_sync by 16, 8, 4), halving the column
//     tiles a lane keeps at each step, so lane l ends with columns 2l, 2l+1:
//     + b2, ReLU, bf16 once per column (max_s relu(a_s + b) =
//     relu(max_s a_s + b)), and one coalesced 128 B store per radius.
// 12 warps a block and 36 centers a block are the measured best at the main
// path's shapes on an H100 (24-72 centers a block lie within 1.5%; one
// block per RoI loses 16% to the tail of its 3 waves). A block that would
// not fit in shared memory (many points per RoI) runs with 4 warps instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kH = 64;                   // hidden width of both MLP layers
constexpr int kMaxS = 32;                // largest nsample
constexpr int kWarps = 12;
constexpr int kCentersPerBlock = 36;     // grid centers one block takes
constexpr int kSmallWarps = 4;           // when kWarps staging tiles do not fit
constexpr int kW2Stride = kH + 8;        // bf16 per padded W2 row (144 B)
constexpr int kW2Bytes = 2 * kH * kW2Stride * 2;
constexpr int kBiasBytes = 4 * kH * 4;   // b1 (2,H) | b2 (2,H)
constexpr int kCwBytes = 2 * kH * 4;     // one center's cw rows, both radii
constexpr int kRowBytes = kH * 2;        // one Z row
constexpr int kIdxPerWarp = 2 * kMaxS;
constexpr int kMaxSmem = 232448;         // what a block may opt in to on sm_90
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// one staging tile: the slot rows of both radii, then the cw rows
__host__ __device__ inline int stage_bytes(int ns0, int ns1) {
  return (round16(ns0) + round16(ns1)) * kRowBytes + kCwBytes;
}

inline size_t smem_bytes(int warps, int P, int ns0, int ns1) {
  return static_cast<size_t>(kW2Bytes) + kBiasBytes +
         static_cast<size_t>(warps) * 2 * stage_bytes(ns0, ns1) +
         static_cast<size_t>(warps) * kIdxPerWarp * 4 + static_cast<size_t>(P) * 12;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 z values -> bf16(relu(z - cw)), low half first
__device__ __forceinline__ uint32_t layer1(uint32_t z2, float2 cw) {
  const float lo = __uint_as_float(z2 << 16), hi = __uint_as_float(z2 & 0xffff0000u);
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(fmaxf(lo - cw.x, 0.f), fmaxf(hi - cw.y, 0.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kNumWarps>
__global__ void __launch_bounds__(kNumWarps * 32, 1)
sa_group_kernel(const float* __restrict__ centers, const float* __restrict__ xyz,
                const unsigned char* __restrict__ valid,
                const __nv_bfloat16* __restrict__ z, const float* __restrict__ cw,
                const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b1,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int R, int G,
                int P, float r2_0, float r2_1, int ns0, int ns1, int shares) {
  constexpr int kThreads = kNumWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage = stage_bytes(ns0, ns1);
  const int row1 = round16(ns0);                    // first tile row of radius 1
  const int cw_off = (row1 + round16(ns1)) * kRowBytes;
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem);   // [2*kH][kW2Stride]
  float* s_b1 = reinterpret_cast<float*>(smem + kW2Bytes);        // [2][kH]
  float* s_b2 = s_b1 + 2 * kH;                                    // [2][kH]
  unsigned char* s_stage = smem + kW2Bytes + kBiasBytes;          // [warps][2][stage]
  int* s_idx = reinterpret_cast<int*>(s_stage + kNumWarps * 2 * stage);
  float* s_xyz = reinterpret_cast<float*>(s_idx + kNumWarps * kIdxPerWarp);  // [P][3]

  const int r = blockIdx.x / shares;
  const int g_begin = (blockIdx.x % shares) * kCentersPerBlock;
  const int g_end = min(G, g_begin + kCentersPerBlock);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // prologue: W2, biases and the RoI's points, once per block
  for (int i = tid; i < 2 * kH * kH / 8; i += kThreads) {
    const uint4 v = reinterpret_cast<const uint4*>(w2)[i];
    *reinterpret_cast<uint4*>(s_w2 + (i >> 3) * kW2Stride + (i & 7) * 8) = v;
  }
  for (int i = tid; i < 2 * kH; i += kThreads) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
  }
  for (int i = tid; i < P; i += kThreads) {
    const float* p = xyz + (static_cast<size_t>(r) * P + i) * 3;
    s_xyz[3 * i] = valid[static_cast<size_t>(r) * P + i] ? p[0] : INFINITY;
    s_xyz[3 * i + 1] = p[1];
    s_xyz[3 * i + 2] = p[2];
  }
  __syncthreads();

  unsigned char* my_stage = s_stage + warp * 2 * stage;
  int* my_idx = s_idx + warp * kIdxPerWarp;
  const uint32_t w2_addr = smem_addr(s_w2);
  const unsigned lt = (1u << lane) - 1u;

  // Ball query of center g into my_idx ([0,ns0) radius 0, [kMaxS,kMaxS+ns1)
  // radius 1), then the copies of its Z rows and cw rows into staging tile
  // `buf`, as one cp.async group. Returns the in-ball counts.
  auto fetch = [&](int g, int buf, int& c0, int& c1) {
    const float* cp = centers + (static_cast<size_t>(r) * G + g) * 3;
    const float cx = cp[0], cy = cp[1], cz = cp[2];
    c0 = 0;
    c1 = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      bool in0 = false, in1 = false;
      if (p < P) {
        const float dx = cx - s_xyz[3 * p], dy = cy - s_xyz[3 * p + 1],
                    dz = cz - s_xyz[3 * p + 2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        in0 = d2 < r2_0;
        in1 = d2 < r2_1;
      }
      const unsigned m0 = __ballot_sync(kFull, in0);
      const unsigned m1 = __ballot_sync(kFull, in1);
      if (in0) {
        const int pos = c0 + __popc(m0 & lt);
        if (pos < ns0) my_idx[pos] = p;
      }
      if (in1) {
        const int pos = c1 + __popc(m1 & lt);
        if (pos < ns1) my_idx[kMaxS + pos] = p;
      }
      c0 += __popc(m0);
      c1 += __popc(m1);
      if (c0 >= ns0 && c1 >= ns1) break;
    }
    __syncwarp();
    const uint32_t tile = smem_addr(my_stage + buf * stage);
    const int chunk = lane & 7;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rows = min(i ? c1 : c0, i ? ns1 : ns0);
      const int row_base = i ? row1 : 0;
      const __nv_bfloat16* zi = z + (static_cast<size_t>(i) * R + r) * P * kH;
      for (int s = lane >> 3; s < rows; s += 4) {
        const int p = my_idx[i * kMaxS + s];
        const int row = row_base + s;
        cp_async16(tile + row * kRowBytes + ((chunk ^ (row & 7)) << 4),
                   zi + static_cast<size_t>(p) * kH + chunk * 8);
      }
    }
    // cw rows: lanes 0-15 radius 0, lanes 16-31 radius 1, 4 floats each
    cp_async16(tile + cw_off + lane * 16,
               cw + ((static_cast<size_t>(lane >> 4) * R + r) * G + g) * kH + (lane & 15) * 4);
    cp_async_commit();
  };

  // Layers 1 and 2 and the max over slots of center g from staging tile buf.
  auto compute = [&](int g, int buf, int c0, int c1) {
    const unsigned char* tile_ptr = my_stage + buf * stage;
    const uint32_t tile = smem_addr(tile_ptr);
    const float* s_cw = reinterpret_cast<const float*>(tile_ptr + cw_off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cnt = i ? c1 : c0;
      const int ns = i ? ns1 : ns0;
      const int neff = cnt == 0 ? 1 : min(cnt, ns);  // distinct slots
      const int row_base = i ? row1 : 0;
      // the center term for this lane's A-fragment columns
      float2 cwv[4][2];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = i * kH + ks * 16 + h * 8 + (lane & 3) * 2;
          if (cnt > 0) {
            cwv[ks][h] = *reinterpret_cast<const float2*>(s_cw + col);
          } else {  // empty ball: layer 1 sees 0 - (-b1)
            cwv[ks][h] = make_float2(-s_b1[col], -s_b1[col + 1]);
          }
        }
      float best[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) best[j][0] = best[j][1] = -INFINITY;

      for (int rt = 0; rt * 16 < neff; ++rt) {
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        const int arow = row_base + rt * 16 + (lane & 15);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4] = {0u, 0u, 0u, 0u};
          if (cnt > 0)
            ldmatrix_x4(a, tile + arow * kRowBytes + (((ks * 2 + (lane >> 4)) ^ (arow & 7)) << 4));
          a[0] = layer1(a[0], cwv[ks][0]);
          a[1] = layer1(a[1], cwv[ks][0]);
          a[2] = layer1(a[2], cwv[ks][1]);
          a[3] = layer1(a[3], cwv[ks][1]);
          // W2 fragments: matrices (k 0-7 | k 8-15) x (column tile 2jp | 2jp+1)
          const int krow = i * kH + ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t bfrag[4];
            ldmatrix_x4_trans(bfrag,
                              w2_addr + (krow * kW2Stride + (2 * jp + (lane >> 4)) * 8) * 2);
            mma_bf16(acc[2 * jp], a, bfrag[0], bfrag[1]);
            mma_bf16(acc[2 * jp + 1], a, bfrag[2], bfrag[3]);
          }
        }
        const bool lo_ok = rt * 16 + (lane >> 2) < neff;
        const bool hi_ok = rt * 16 + (lane >> 2) + 8 < neff;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (lo_ok) {
            best[j][0] = fmaxf(best[j][0], acc[j][0]);
            best[j][1] = fmaxf(best[j][1], acc[j][1]);
          }
          if (hi_ok) {
            best[j][0] = fmaxf(best[j][0], acc[j][2]);
            best[j][1] = fmaxf(best[j][1], acc[j][3]);
          }
        }
      }

      // reduce-scatter over the 8 lanes that share lane%4: after the steps
      // by 16, 8, 4 a lane keeps column tile j = lane/4
      const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
      float m4[4][2], m2[2][2], m1[2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float keep = up16 ? best[j + 4][c] : best[j][c];
          const float send = up16 ? best[j][c] : best[j + 4][c];
          m4[j][c] = fmaxf(keep, __shfl_xor_sync(kFull, send, 16));
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float keep = up8 ? m4[j + 2][c] : m4[j][c];
          const float send = up8 ? m4[j][c] : m4[j + 2][c];
          m2[j][c] = fmaxf(keep, __shfl_xor_sync(kFull, send, 8));
        }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float keep = up4 ? m2[1][c] : m2[0][c];
        const float send = up4 ? m2[0][c] : m2[1][c];
        m1[c] = fmaxf(keep, __shfl_xor_sync(kFull, send, 4));
      }
      const int col = i * kH + lane * 2;
      const __nv_bfloat162 o = __floats2bfloat162_rn(fmaxf(m1[0] + s_b2[col], 0.f),
                                                     fmaxf(m1[1] + s_b2[col + 1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(r) * G + g) * 2 * kH + col) =
          o;
    }
  };

  int g = g_begin + warp;
  int c0 = 0, c1 = 0, next_c0 = 0, next_c1 = 0;
  if (g < g_end) fetch(g, 0, next_c0, next_c1);
  for (int buf = 0; g < g_end; g += kNumWarps, buf ^= 1) {
    c0 = next_c0;
    c1 = next_c1;
    if (g + kNumWarps < g_end) {
      fetch(g + kNumWarps, buf ^ 1, next_c0, next_c1);
      cp_async_wait<1>();  // all but the group just committed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();          // every lane's copies have landed
    compute(g, buf, c0, c1);
    __syncwarp();          // the tile and my_idx are free again
  }
}

template <int kNumWarps>
int launch(const float* centers, const float* xyz, const unsigned char* valid, const void* z,
           const float* cw, const void* w2, const float* b1, const float* b2, void* out, int R,
           int G, int P, float r2_0, float r2_1, int ns0, int ns1, size_t dyn, void* stream) {
  auto kernel = sa_group_kernel<kNumWarps>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shares = (G + kCentersPerBlock - 1) / kCentersPerBlock;
  kernel<<<static_cast<unsigned>(R) * shares, kNumWarps * 32, dyn,
           static_cast<cudaStream_t>(stream)>>>(
      centers, xyz, valid, static_cast<const __nv_bfloat16*>(z), cw,
      static_cast<const __nv_bfloat16*>(w2), b1, b2, static_cast<__nv_bfloat16*>(out), R, G, P,
      r2_0, r2_1, ns0, ns1, shares);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// centers (R,G,3), xyz (R,P,3) f32; valid (R,P) uint8; z (2,R,P,64) bf16;
// cw (2,R,G,64) f32; w2 (2,64,64) bf16; b1, b2 (2,64) f32 -> out (R,G,128) bf16.
// z, cw and w2 must lie on 16-byte boundaries. Requires nsamples <= 32 and
// P <= 8192.
extern "C" int fv2p_sa_group(const float* centers, const float* xyz,
                             const unsigned char* valid, const void* z, const float* cw,
                             const void* w2, const float* b1, const float* b2, void* out,
                             int R, int G, int P, float r2_0, float r2_1, int ns0, int ns1,
                             void* stream) {
  if (R == 0 || G == 0) return 0;
  if (ns0 > kMaxS || ns1 > kMaxS || ns0 < 1 || ns1 < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t dyn = smem_bytes(kWarps, P, ns0, ns1);
  if (dyn <= kMaxSmem)
    return launch<kWarps>(centers, xyz, valid, z, cw, w2, b1, b2, out, R, G, P, r2_0, r2_1,
                          ns0, ns1, dyn, stream);
  dyn = smem_bytes(kSmallWarps, P, ns0, ns1);
  if (dyn > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kSmallWarps>(centers, xyz, valid, z, cw, w2, b1, b2, out, R, G, P, r2_0, r2_1,
                             ns0, ns1, dyn, stream);
}
