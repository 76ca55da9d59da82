// Modulated deformable conv v2 forward without autograd (3 x 3 kernel), as one
// implicit GEMM whose A operand is sampled on the fly:
//
//   out[p, :] = sum_tap ( sum_c sample[p, tap, c] * W[tap, c, :] )   (f32 sums)
//
// sample[p, tap, c] is the bilinear blend of the four corners around
// (h + ky - 1 + dy, w + kx - 1 + dx), group g = c / Cg, with the modulation
// folded into the corner weights: the arithmetic of fv2p_torch/ops/dcn.py
// _mdcn_forward, step for step. Coordinates are f32; a sample counts only if
// floor(y) lies in [-1, H-1] and floor(x) in [-1, W-1]; a corner outside the
// map reads zero; each weight is ((1 - wy) * (1 - wx)) * m (and the other three
// in that association), rounded to bf16 once; the blend is
// v00 w00 + v01 w01 + v10 w10 + v11 w11 with a bf16 rounding after each step,
// as PyTorch's bf16 mul and addcmul_ round (a bf16 product, then three f32
// multiply-adds, each rounded to bf16: a product of two bf16 values is exact in
// f32); products bf16 x bf16 with f32 sums. Every sample is interpolated,
// whatever its offset or mask.
//
// Replaces no Pallas kernel: JAX runs the deformable conv as XLA
// (fv2p_tpu/ops/dcn.py modulated_deform_conv), and the port's no-grad forward
// ran as PyTorch tensor code: per tap, four index_selects of the corners, a
// multiply and three addcmul_ on the (B*HW, C) blends, and an f32-accumulating
// addmm, ~150 launches a call, writing every corner and blend to device memory
// (4.7 GB of corners a KITTI test batch of MGAF-3DSSD's four calls).
//
// What bounds it on the H100: the tensor-core products. The four calls of a
// test batch are 259.6 GFLOP, 0.262 ms at 989 TFLOP/s, against ~0.46 GB of
// bytes that no kernel can avoid (maps, offsets and mask read once, the f32
// output written once), ~0.14 ms at 3.35 TB/s. In practice each role below is
// held back by its own work long before that: the sampling by the roundings of
// the blend (~11 instructions an element of A, which no bf16x2 operation can
// take over without rounding once where PyTorch rounds twice), the products by
// mma.sync's shared-memory traffic and the per-tap running sum. At those four
// calls on an H100 SXM (700 W) the kernel takes ~2.25 ms; with its products
// taken out ~2.16 ms, with its sampling taken out ~1.68 ms.
//
// Design: a block takes 64 neighbouring output pixels (row-major over W) and
// all of Cout (128 or 256), so each sample is blended once, and has its SM to
// itself: 16 warps in two roles, handing a ring of 4 A tiles (64 pixels x 64
// channels, rows padded by 16 bytes so that ldmatrix reads them without bank
// conflicts) back and forth by named barriers (full, empty), so that the
// sampling (ALU and loads) and the products (tensor cores) run at once. The
// depth runs tap by tap, 64 channels a step.
//  - 8 producer warps sample. A thread takes one pixel and 8 channels of each
//    32-channel half of a step: where the (tap, group) changes it reads the
//    offsets and mask and computes the coordinates, validity and the four bf16
//    weights; it loads the four corners as 16-byte vectors and blends them in
//    registers (two channels an instruction where the rounding allows: the
//    first product as a bf16x2 multiply, the roundings as bf16x2
//    conversions). The next half's corners are in flight while a half is
//    blended, and the producers run up to 4 steps ahead of the products.
//  - 8 consumer warps multiply (mma.sync.m16n8k16, bf16 x bf16 -> f32, A by
//    ldmatrix.x4 and W by ldmatrix.x4.trans; a warp 32 pixels x Cout/4), with
//    W[tap, step's channels, :] by cp.async in a 3-stage ring. Each tap is
//    summed in registers in increasing channel order, 16 at a time, and added
//    after its last step to the running sum, which lives in shared memory, as
//    the tensor code's per-tap addmm adds it: only the order of sums inside a
//    16-deep piece could differ from cuBLAS.
// No corner or sample is written to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 9;            // 3 x 3, ky-major
constexpr int kRows = 64;           // output pixels a block
constexpr int kDepth = 64;          // input channels a step
constexpr int kHalf = kDepth / 2;   // channels a producer thread samples at a time
constexpr int kRoleThreads = 256;   // 8 consumer warps, then 8 producer warps
constexpr int kThreads = 2 * kRoleThreads;
constexpr int kAStages = 4;         // the A ring: producers run up to 4 steps ahead
constexpr int kWStages = 3;
constexpr int kAStride = kDepth + 8;  // bf16 elements a row of an A tile
constexpr int kABytes = kRows * kAStride * 2;
// named barriers (0 is __syncthreads'): A stage s is full, A stage s is empty
constexpr int kFull = 1, kEmpty = kFull + kAStages;

// shared memory of a launch: the W ring, the A ring, then the running sum
// (kRows x (cols + 8) f32; the padding spreads a half-warp's float2 accesses
// over the 32 banks)
template <int kCols>
struct Smem {
  static constexpr int kWStride = kCols + 8;  // bf16 elements a row of a W tile
  static constexpr int kWBytes = kDepth * kWStride * 2;
  static constexpr int kAOff = kWStages * kWBytes;
  static constexpr int kAccStride = kCols + 8;
  static constexpr int kAccOff = kAOff + kAStages * kABytes;
  static constexpr int kBytes = kAccOff + kRows * kAccStride * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// named barrier `id` over n threads: wait for all, or only mark this warp's arrival
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the two bf16 of a 32-bit word (low: the even channel), widened
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// two f32 rounded to bf16 once each, packed (a in the low half)
__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// word i (a constant once unrolled) of a 16-byte vector
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one pixel's sample of 8 channels at one tap: its four corners (zero outside
// the map or where the sample does not count) and their bf16 weights
struct Corners {
  uint4 v[4];   // 00 01 10 11
  float w[4];   // bf16 values, widened
};

struct Problem {
  const __nv_bfloat16* x;   // (B, H, W, C)
  const float* dy;          // (B, H, W, G * 9)
  const float* dx;
  const __nv_bfloat16* mask;
  const __nv_bfloat16* weight;  // (9, C, Cout)
  float* out;               // (B, H, W, Cout)
  int h, w, c, cg, gk, pixels, chunks;
};

// A producer thread walks its pixel's depth 32 channels at a time (two
// "halves" a step), tap-major. A cursor follows one half: its tap, its index
// within the tap, the thread's channel and group, and whether its (tap, group)
// differs from the half before (only then are the offsets read and the
// coordinates computed again).
struct Cursor {
  int tap, half, c, g, g_end;
  bool fresh;
};

// where one pixel samples at one (tap, group): the four bf16 weights, the
// first corner's row of x, and which corners lie in the map
struct Geometry {
  float w[4];
  const __nv_bfloat16* p00;
  bool top, bottom, left, right;
};

// Coordinates, validity and weights of a sample.
__device__ __forceinline__ void locate(const Problem& P, bool live, int base, int ph, int pw,
                                       int tap, float dy, float dx, float m, Geometry& geo) {
  const int ky = tap / 3, kx = tap - ky * 3;
  const float sy = __fadd_rn(static_cast<float>(ph + ky - 1), dy);
  const float sx = __fadd_rn(static_cast<float>(pw + kx - 1), dx);
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float wy1 = __fsub_rn(sy, y0), wx1 = __fsub_rn(sx, x0);
  const float wy0 = __fsub_rn(1.f, wy1), wx0 = __fsub_rn(1.f, wx1);
  geo.w[0] = bf16_round(__fmul_rn(__fmul_rn(wy0, wx0), m));
  geo.w[1] = bf16_round(__fmul_rn(__fmul_rn(wy0, wx1), m));
  geo.w[2] = bf16_round(__fmul_rn(__fmul_rn(wy1, wx0), m));
  geo.w[3] = bf16_round(__fmul_rn(__fmul_rn(wy1, wx1), m));
  const bool ok = live && y0 >= -1.f && y0 <= static_cast<float>(P.h - 1) && x0 >= -1.f &&
                  x0 <= static_cast<float>(P.w - 1);
  const int yi = ok ? static_cast<int>(y0) : 0, xi = ok ? static_cast<int>(x0) : 0;
  // a counted sample's corners lie in rows yi, yi + 1 of [-1, H] and columns
  // xi, xi + 1 of [-1, W]: only row -1 / H and column -1 / W read zero
  geo.top = ok && yi >= 0;
  geo.bottom = ok && yi + 1 < P.h;
  geo.left = xi >= 0;
  geo.right = xi + 1 < P.w;
  geo.p00 = P.x + (base + yi * P.w + xi) * P.c;
}

// The four corners of 8 channels from c, and the weights, for the blend.
__device__ __forceinline__ void gather(const Problem& P, const Geometry& geo, bool live, int c,
                                       Corners& k) {
  const uint4* const c00 = reinterpret_cast<const uint4*>(geo.p00 + c);
  const int dx1 = P.c / 8, dy1 = P.w * P.c / 8;  // one column, one row, in 16-byte units
  const uint4 zero = make_uint4(0, 0, 0, 0);
  k.v[0] = live && geo.top && geo.left ? __ldg(c00) : zero;
  k.v[1] = live && geo.top && geo.right ? __ldg(c00 + dx1) : zero;
  k.v[2] = live && geo.bottom && geo.left ? __ldg(c00 + dy1) : zero;
  k.v[3] = live && geo.bottom && geo.right ? __ldg(c00 + dy1 + dx1) : zero;
#pragma unroll
  for (int q = 0; q < 4; ++q) k.w[q] = geo.w[q];
}

// The blend of 8 channels, rounded to bf16 after each step, into shared
// memory: v00 w00 as a bf16x2 product (the exact product rounded once, as the
// f32 product rounded to bf16 is), then each further corner as an f32
// multiply-add (the product is exact, so it rounds as PyTorch's separate
// multiply and add do) rounded to bf16.
__device__ __forceinline__ void blend_store(__nv_bfloat16* dst, bool live, const Corners& k) {
  uint32_t out[4] = {0, 0, 0, 0};
  if (live) {
    const __nv_bfloat162 w00 = __bfloat162bfloat162(__float2bfloat16_rn(k.w[0]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t s;
      {
        const uint32_t v = word(k.v[0], i);
        const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v), w00);
        s = *reinterpret_cast<const uint32_t*>(&p);
      }
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        const uint32_t v = word(k.v[q], i);
        s = pack_rn(__fmaf_rn(lo(v), k.w[q], lo(s)), __fmaf_rn(hi(v), k.w[q], hi(s)));
      }
      out[i] = s;
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
}

template <int kCols>
__global__ void __launch_bounds__(kThreads, 1) dcn_fwd_kernel(const Problem P) {
  using S = Smem<kCols>;
  constexpr int kNT = kCols / 32;  // 8-column tiles a consumer warp (32 rows x kCols / 4)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kRows;
  const int steps = kTaps * P.chunks;

  if (tid >= kRoleThreads) {
    // ---- producer: one pixel's 8 channels of each 32-channel half, into the A ring
    const int ptid = tid - kRoleThreads;
    const int cv = (ptid & 3) * 8;
    const bool row_live = m0 + (ptid >> 2) < P.pixels;
    const int pix = row_live ? m0 + (ptid >> 2) : 0;
    const int hw = P.h * P.w;
    const int base = pix / hw * hw;
    const int ph = (pix - base) / P.w, pw = pix - base - ph * P.w;
    unsigned char* const a_own = smem + S::kAOff + ((ptid >> 2) * kAStride + cv) * 2;
    const int halves = 2 * P.chunks;

    auto advance = [&](Cursor& s) {
      s.c += kHalf;
      s.fresh = false;
      if (++s.half == halves) {
        s.half = 0;
        ++s.tap;
        s.c = cv;
        s.g = cv / P.cg;
        s.g_end = (s.g + 1) * P.cg;
        s.fresh = true;
      }
      while (s.c >= s.g_end) {
        ++s.g;
        s.g_end += P.cg;
        s.fresh = true;
      }
    };
    auto live = [&](const Cursor& s) { return row_live && s.tap < kTaps && s.c < P.c; };
    float rdy = 0.f, rdx = 0.f, rm = 0.f;  // offsets and mask of a half ahead
    auto raw = [&](const Cursor& s) {
      rdy = rdx = rm = 0.f;
      if (live(s)) {
        const int i = pix * P.gk + s.g * kTaps + s.tap;
        rdy = __ldg(P.dy + i);
        rdx = __ldg(P.dx + i);
        rm = __bfloat162float(P.mask[i]);
      }
    };

    // cur: half u's corners (loaded); s1, s2: halves u + 1 (its offsets read
    // if fresh) and u + 2; geo: where s1's (tap, group) samples
    Cursor s1{0, 0, cv, cv / P.cg, (cv / P.cg + 1) * P.cg, true};
    Geometry geo;
    Corners cur, nxt;
    raw(s1);
    bool cur_live = live(s1);
    locate(P, cur_live, base, ph, pw, s1.tap, rdy, rdx, rm, geo);
    gather(P, geo, cur_live, s1.c, cur);
    advance(s1);
    if (s1.fresh) raw(s1);
    Cursor s2 = s1;
    advance(s2);
    for (int u = 0, stage = 0; u < 2 * steps; ++u) {
      const bool nxt_live = live(s1);
      if (s1.fresh) locate(P, nxt_live, base, ph, pw, s1.tap, rdy, rdx, rm, geo);
      gather(P, geo, nxt_live, s1.c, nxt);  // in flight
      if (s2.fresh) raw(s2);
      const int half = u & 1;
      if (!half && u >= 2 * kAStages) bar_sync(kEmpty + stage, kThreads);  // consumers done
      blend_store(reinterpret_cast<__nv_bfloat16*>(a_own + stage * kABytes) + half * kHalf,
                  cur_live, cur);
      if (half) {
        // arrive orders the stores before it for the threads that sync on the
        // barrier; a fence here would also wait for the loads in flight
        bar_arrive(kFull + stage, kThreads);
        stage = stage == kAStages - 1 ? 0 : stage + 1;
      }
      cur = nxt;
      cur_live = nxt_live;
      advance(s1);
      advance(s2);
    }
    return;
  }

  // ---- consumer: W by cp.async, the products, the per-tap and running sums
  const int lane = tid & 31, warp = tid >> 5;
  // W[tap, chunk's channels, :] into a stage (cp.async; rows past C zeroed)
  auto load_w = [&](int stage, int tap, int chunk) {
    __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + stage * S::kWBytes);
    const int c0 = chunk * kDepth;
    const __nv_bfloat16* wk = P.weight + (tap * P.c + c0) * kCols;
    constexpr int kPieces = kDepth * kCols / 8 / kRoleThreads;  // 16-byte copies a thread
#pragma unroll
    for (int r = 0; r < kPieces; ++r) {
      const int i = tid + r * kRoleThreads;
      const int row = i / (kCols / 8), col = (i % (kCols / 8)) * 8;
      __nv_bfloat16* dst = sw + row * S::kWStride + col;
      if (c0 + row < P.c)
        cp_async16_cg(smem_addr(dst), wk + row * kCols + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };
  // (tw, jw): the step whose W is loaded next; (tap, chunk): step i
  int tw = 0, jw = 0;
  auto next_w = [&]() {
    if (++jw == P.chunks) {
      jw = 0;
      ++tw;
    }
  };
#pragma unroll
  for (int st = 0; st < kWStages - 1; ++st) {
    if (tw < kTaps) load_w(st, tw, jw);
    cp_async_commit();
    next_w();
  }

  float tap_acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tap_acc[i][j][e] = 0.f;

  // lane l addresses row l % 16, column 8 * (l / 16) of a 16 x 16 piece, for
  // A (x4: a0..a3) and for W (x4.trans: b0, b1 of two 8-column tiles)
  const int wm = warp & 1, wn = warp >> 1;
  const uint32_t a_off = smem_addr(smem + S::kAOff) +
                         ((wm * 32 + (lane & 15)) * kAStride + (lane >> 4) * 8) * 2;
  const uint32_t w_off =
      smem_addr(smem) + ((lane & 15) * S::kWStride + wn * (kCols / 4) + (lane >> 4) * 8) * 2;
  // a lane's sums: rows wm * 32 + 16 mi + lane / 4 (+ 8), columns
  // wn * kCols / 4 + 8 j + 2 (lane % 4) (+ 1)
  const int g = lane >> 2, q = lane & 3;
  const int col0 = wn * (kCols / 4) + 2 * q;
  float* const acc_s =
      reinterpret_cast<float*>(smem + S::kAccOff) + (wm * 32 + g) * S::kAccStride + col0;

  for (int i = 0, tap = 0, chunk = 0, stage = 0, wstage = 0; i < steps; ++i) {
    cp_async_wait<kWStages - 2>();
    bar_sync(kFull + stage, kThreads);  // step i's A (producers) and W (every consumer)
    // the W stage of step i - 1 is free: every consumer has passed this barrier
    if (tw < kTaps) load_w(wstage == 0 ? kWStages - 1 : wstage - 1, tw, jw);
    cp_async_commit();
    next_w();

    const uint32_t a_base = a_off + stage * kABytes, w_base = w_off + wstage * S::kWBytes;
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], a_base + kk * 32);
      ldmatrix_x4(a[1], a_base + 16 * kAStride * 2 + kk * 32);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_base + (kk * 16 * S::kWStride + j * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(tap_acc[mi][2 * j], a[mi], b[0], b[1]);
          mma_bf16(tap_acc[mi][2 * j + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (i + kAStages < steps) bar_arrive(kEmpty + stage, kThreads);  // A stage read
    stage = stage == kAStages - 1 ? 0 : stage + 1;
    wstage = wstage == kWStages - 1 ? 0 : wstage + 1;

    if (++chunk == P.chunks) {
      // the tap's last step: the running sum (0 before the first tap) plus the
      // tap, kept in shared memory, or written out after the last tap
      chunk = 0;
      const bool first = tap == 0, last = tap == kTaps - 1;
      ++tap;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* const row = reinterpret_cast<float2*>(acc_s + (mi * 16 + h * 8) * S::kAccStride);
          const int p = m0 + wm * 32 + mi * 16 + g + h * 8;
          float2* const dst = reinterpret_cast<float2*>(
              P.out + (last && p < P.pixels ? p : 0) * kCols + col0);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float2 old = first ? make_float2(0.f, 0.f) : row[j * 4];
            const float2 sum = make_float2(__fadd_rn(old.x, tap_acc[mi][j][2 * h]),
                                           __fadd_rn(old.y, tap_acc[mi][j][2 * h + 1]));
            tap_acc[mi][j][2 * h] = tap_acc[mi][j][2 * h + 1] = 0.f;
            if (!last)
              row[j * 4] = sum;
            else if (p < P.pixels)
              dst[j * 4] = sum;
          }
        }
    }
  }
}

template <int kCols>
int launch(const Problem& P, void* stream) {
  constexpr int kBytes = Smem<kCols>::kBytes;
  auto kernel = dcn_fwd_kernel<kCols>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((P.pixels + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (b, h, w, c) bf16, offset_dy and offset_dx (b, h, w, groups * 9) f32, mask
// (b, h, w, groups * 9) bf16, weight (9, c, cout) bf16 -> out (b, h, w, cout)
// f32. x and weight must lie on 16-byte boundaries. Requires c / groups a
// multiple of 8, cout 128 or 256, and every element index of the five tensors
// and the output below 2^31.
extern "C" int fv2p_dcn_fwd(const void* x, const void* offset_dy, const void* offset_dx,
                            const void* mask, const void* weight, float* out, int b, int h,
                            int w, int c, int groups, int cout, void* stream) {
  if (b < 0 || h < 0 || w < 0 || c < 1 || groups < 1 || c % groups != 0 ||
      (c / groups) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(b) * h * w;
  if (pixels == 0) return 0;
  Problem P;
  P.x = static_cast<const __nv_bfloat16*>(x);
  P.dy = static_cast<const float*>(offset_dy);
  P.dx = static_cast<const float*>(offset_dx);
  P.mask = static_cast<const __nv_bfloat16*>(mask);
  P.weight = static_cast<const __nv_bfloat16*>(weight);
  P.out = out;
  P.h = h;
  P.w = w;
  P.c = c;
  P.cg = c / groups;
  P.gk = groups * kTaps;
  P.pixels = static_cast<int>(pixels);
  P.chunks = (c + kDepth - 1) / kDepth;
  switch (cout) {
    case 128:
      return launch<128>(P, stream);
    case 256:
      return launch<256>(P, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
