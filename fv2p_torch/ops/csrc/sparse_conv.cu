// Sparse convolution forward without autograd, as one implicit GEMM over the
// output-side neighbour table:
//
//   out[o] = bf16( sum_k sum_c feat[nbr[o, k], c] * W[k, c, :] )   (f32 sums)
//
// widened to f32, then optionally + bias (an f32 add) and 0.0 where the output
// row is not valid. An index equal to n_in names the zero row (a missing
// neighbour); the features carry no padded copy of it.
//
// Replaces no Pallas kernel: JAX runs the sparse conv as XLA's gather + dot
// (fv2p_tpu/ops/sparse/conv.py sparse_conv_apply), and the port's no-grad
// forward did the same with PyTorch's int64 gather and cuBLAS, writing the
// (N_out, K * Cin) gathered rows to device memory and reading them back
// (6.6 GB a KITTI test batch of VoxelResBackBone8x's 21 convs).
//
// What bounds it on the H100: the features read once, the int64 tables and
// the f32 output (~1.5 GB a test batch, ~0.44 ms at 3.35 TB/s) and the
// tensor-core products (~479 GFLOP at capacity, ~0.48 ms at 989 TFLOP/s);
// in practice the latency of the gathered rows. Every level's features fit in
// the 50 MB L2, and rows in key order put a tile's neighbours close together,
// so the 27 reads of an input row are mostly L2 (and L1) hits.
//
// Design: a block takes 64 output rows and the full Cout (4 warps, 16 rows
// each). It loads the tile's table slice once (contiguous int64, turned into
// int32 rows with -1 for the zero row) and votes which taps name any real
// row; taps whose 64 indices are all the zero row add exact zeros and are
// skipped, and a tile with no such tap goes straight to the epilogue. For
// each remaining tap the tile's input rows (cp.async, 16 bytes a copy, L1
// cached: neighbouring taps read overlapping rows) and W[k] (cp.async,
// L2 only) go into one stage of a 2-3 stage ring in shared memory, so the
// copies of the next taps are in flight while the current one is multiplied.
// Zero rows are plain 16-byte zero stores, never a read. Cin that is not a
// multiple of 8 (the first layer's 4 or 5) is gathered element by element;
// the depth is zero-padded to a multiple of 16 in shared memory (both the
// rows' padding columns and W's padding rows, so no stale value meets a
// zero). Rows are padded by 16 bytes so that ldmatrix reads 8 rows without
// bank conflicts. The products are mma.sync.m16n8k16 (bf16 x bf16 -> f32,
// exact products), A by ldmatrix.x4 and W by ldmatrix.x4.trans, so only the
// order of the f32 sums differs from cuBLAS; the sum is rounded to bf16 once,
// as the parent's bf16 matmul output is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;           // output rows a block
constexpr int kWarps = 4;           // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTaps = 32;        // the tap mask is one 32-bit word
constexpr int kMaxCin = 128;
constexpr int kMaxSmem = 232448;    // what a block may opt in to on sm_90
constexpr int kTwoBlocks = 113 * 1024;  // at most this much keeps two blocks on an SM

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// byte offsets of one launch's dynamic shared memory: `stages` x (A rows |
// W[k]), then the tile's table (taps x kRows int32), then the active taps
// and their mask
struct Layout {
  int a_stride, w_stride;  // bf16 elements a row
  int a_bytes, stage_bytes, idx_off, taps_off, total;
};

__host__ __device__ inline Layout layout(int cin, int cout, int taps, int stages) {
  Layout l;
  const int cin_p = round16(cin);
  l.a_stride = cin_p + 8;
  l.w_stride = cout + 8;
  l.a_bytes = kRows * l.a_stride * 2;
  l.stage_bytes = l.a_bytes + cin_p * l.w_stride * 2;
  l.idx_off = stages * l.stage_bytes;
  l.taps_off = l.idx_off + kRows * taps * 4;
  l.total = l.taps_off + (kMaxTaps + 1) * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src) {
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

template <int kCout>
__global__ void __launch_bounds__(kThreads)
sparse_conv_fwd_kernel(const __nv_bfloat16* __restrict__ feat,
                       const __nv_bfloat16* __restrict__ weight,
                       const long long* __restrict__ nbr, const float* __restrict__ bias,
                       const unsigned char* __restrict__ valid, float* __restrict__ out,
                       int n_in, int n_out, int cin, int taps, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(cin, kCout, taps, stages);
  const int cin_p = round16(cin);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx_off);    // [taps][kRows], -1: zero row
  int* s_taps = reinterpret_cast<int*>(smem + L.taps_off);  // active taps, mask at kMaxTaps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_out - row0);
  const bool wide = (cin & 7) == 0;  // rows copied 16 bytes at a time
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the depth padding of every stage, which no copy writes: W's rows
  // [cin, cin_p) and, for the 16-byte copies, the rows' columns [cin, cin_p)
  if (tid == 0) s_taps[kMaxTaps] = 0;
  for (int s = 0; s < stages; ++s) {
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem + s * L.stage_bytes);
    __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + s * L.stage_bytes + L.a_bytes);
    for (int i = tid; i < (cin_p - cin) * kCout; i += kThreads)
      sw[(cin + i / kCout) * L.w_stride + i % kCout] = zero;
    if (wide)
      for (int i = tid; i < kRows * (cin_p - cin); i += kThreads)
        sa[(i / (cin_p - cin)) * L.a_stride + cin + i % (cin_p - cin)] = zero;
  }
  __syncthreads();

  // the tile's table slice (contiguous), tap-major, and the taps in use
  unsigned mask = 0;
  const long long* tile = nbr + static_cast<long long>(row0) * taps;
  for (int i = tid; i < kRows * taps; i += kThreads) {
    const int r = i / taps, t = i - r * taps;
    int v = -1;
    if (r < rows) {
      const long long x = tile[i];
      if (x < 0 || x > n_in) __trap();  // as the parent's gather, out of range is fatal
      if (x != n_in) {
        v = static_cast<int>(x);
        mask |= 1u << t;
      }
    }
    s_idx[t * kRows + r] = v;
  }
  mask = __reduce_or_sync(0xffffffffu, mask);
  if (lane == 0 && mask) atomicOr(reinterpret_cast<unsigned*>(s_taps + kMaxTaps), mask);
  __syncthreads();
  mask = static_cast<unsigned>(s_taps[kMaxTaps]);
  const int n_active = __popc(mask);
  if (tid == 0)
    for (unsigned j = 0, m = mask; m; ++j, m &= m - 1) s_taps[j] = __ffs(static_cast<int>(m)) - 1;
  __syncthreads();

  // tap t's rows and W[t] into stage s (one cp.async group, committed by the caller)
  auto load = [&](int s, int t) {
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem + s * L.stage_bytes);
    __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + s * L.stage_bytes + L.a_bytes);
    const int* idx = s_idx + t * kRows;
    if (wide) {
      const int chunks = cin >> 3;
      for (int i = tid; i < kRows * chunks; i += kThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        const int src = idx[r];
        __nv_bfloat16* dst = sa + r * L.a_stride + c;
        if (src >= 0)
          cp_async16_ca(smem_addr(dst), feat + static_cast<size_t>(src) * cin + c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < kRows * cin_p; i += kThreads) {
        const int r = i / cin_p, c = i - r * cin_p;
        const int src = idx[r];
        sa[r * L.a_stride + c] =
            (src >= 0 && c < cin) ? feat[static_cast<size_t>(src) * cin + c] : zero;
      }
    }
    const __nv_bfloat16* wk = weight + static_cast<size_t>(t) * cin * kCout;
    constexpr int kChunks = kCout / 8;
    for (int i = tid; i < cin * kChunks; i += kThreads) {
      const int c = i / kChunks, n = (i % kChunks) * 8;
      cp_async16_cg(smem_addr(sw + c * L.w_stride + n), wk + c * kCout + n);
    }
  };

  float acc[kCout / 8][4];
#pragma unroll
  for (int j = 0; j < kCout / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // lane l addresses row l % 16, column 8 * (l / 16) of a 16 x 16 piece, for
  // A (x4: a0..a3) and for W (x4.trans: b0, b1 of two 8-column tiles)
  const uint32_t a_off = ((warp * 16 + (lane & 15)) * L.a_stride + (lane >> 4) * 8) * 2;
  const uint32_t w_off = ((lane & 15) * L.w_stride + (lane >> 4) * 8) * 2;
  for (int p = 0; p < stages - 1; ++p) {
    if (p < n_active) load(p, s_taps[p]);
    cp_async_commit();
  }
  for (int i = 0; i < n_active; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tap i has landed for every thread; stage (i - 1) is free
    const int next = i + stages - 1;
    if (next < n_active) load(next % stages, s_taps[next]);
    cp_async_commit();
    const uint32_t base = smem_addr(smem + (i % stages) * L.stage_bytes);
    const uint32_t a_addr = base + a_off, w_addr = base + L.a_bytes + w_off;
    for (int kk = 0; kk < cin_p / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + kk * 32);
#pragma unroll
      for (int j = 0; j < kCout / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_addr + (kk * 16 * L.w_stride + j * 16) * 2);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }

  // a lane holds rows lane / 4 and lane / 4 + 8 of its warp's 16, columns
  // 8 j + 2 (lane % 4) + {0, 1}: one bf16 rounding, widened, + bias, masked
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + h * 8;
    if (r >= rows) continue;
    const int o = row0 + r;
    const bool keep = valid == nullptr || valid[o];
    float* dst = out + static_cast<size_t>(o) * kCout;
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j) {
      const int col = j * 8 + 2 * q;
      float v0 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * h]));
      float v1 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * h + 1]));
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, bias[col]);
        v1 = __fadd_rn(v1, bias[col + 1]);
      }
      if (!keep) v0 = v1 = 0.f;
      *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
    }
  }
}

template <int kCout>
int launch(const void* feat, const void* weight, const long long* nbr, const float* bias,
           const unsigned char* valid, float* out, int n_in, int n_out, int cin, int taps,
           void* stream) {
  int stages = 3;
  Layout l = layout(cin, kCout, taps, stages);
  if (l.total > kTwoBlocks) {
    stages = 2;
    l = layout(cin, kCout, taps, stages);
  }
  if (l.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sparse_conv_fwd_kernel<kCout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_out + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, l.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat), static_cast<const __nv_bfloat16*>(weight), nbr,
      bias, valid, out, n_in, n_out, cin, taps, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// feat (n_in, cin) bf16, weight (taps, cin, cout) bf16, nbr (n_out, taps)
// int64 in [0, n_in], bias (cout) f32 or null, valid (n_out) uint8 or null
// -> out (n_out, cout) f32. feat and weight must lie on 16-byte boundaries.
// Requires cin <= 128, cout in {16, 32, 64, 128}, taps <= 32.
extern "C" int fv2p_sparse_conv_fwd(const void* feat, const void* weight, const long long* nbr,
                                    const float* bias, const unsigned char* valid, float* out,
                                    int n_in, int n_out, int cin, int cout, int taps,
                                    void* stream) {
  if (n_out == 0) return 0;
  if (taps < 1 || taps > kMaxTaps || cin < 1 || cin > kMaxCin || n_in < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cout) {
    case 16:
      return launch<16>(feat, weight, nbr, bias, valid, out, n_in, n_out, cin, taps, stream);
    case 32:
      return launch<32>(feat, weight, nbr, bias, valid, out, n_in, n_out, cin, taps, stream);
    case 64:
      return launch<64>(feat, weight, nbr, bias, valid, out, n_in, n_out, cin, taps, stream);
    case 128:
      return launch<128>(feat, weight, nbr, bias, valid, out, n_in, n_out, cin, taps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
