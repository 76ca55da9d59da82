// Exact 3-nearest-neighbour search: queries (B,M,3) against sources (B,N,3)
// + valid -> ascending squared distances (B,M,3) f32 and indices (B,M,3) int32.
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/three_nn.py
// (three_nn_pallas / _three_nn_kernel / _merge_sorted3). Distances are
// elementwise f32 (((dx*dx + dy*dy) + dz*dz) + offset, no matmul expansion,
// no fused multiply-adds: --fmad=false), invalid sources carry +1e10, the
// result is the three smallest in (distance, index) order, so the lowest
// index wins a tie. Slots that no source fills hold (inf, 0), as the plain
// version's argmin over an exhausted row does.
//
// What bounds it on the H100: arithmetic, if every query meets every source
// (~10 f32 operations a pair, 12 B a point), and exactness forbids the fused
// multiply-adds that the card's peak rate assumes. So the design does not
// visit most pairs. The callers' sources are voxel centers in key order: 256
// consecutive rows are a thin strip of space, and a query's three nearest
// centers lie in a few strips. The kernel uses that but does not depend on
// it: any order and any valid mask give the exact answer, only slower.
//
//  * three_nn_prep_kernel, one warp per tile of kTileRows consecutive
//    sources: the axis-aligned box of the tile's valid rows and a cap (1e10
//    if the tile holds an invalid row, else inf) into scratch, and the rows
//    repacked as float4 (x, y, z, offset) so that a lane loads a source with
//    one 16-byte access. Rows past N carry offset inf and are never taken.
//  * three_nn_kernel, one warp per query, the sample's tile boxes in shared
//    memory. A tile's lower bound is min(distance from the query to the box,
//    cap), the distance written as the kernel writes a source's, with the
//    query clamped into the box in place of the source. f32 subtraction,
//    multiplication and addition are monotone, so every source of the tile
//    has a computed distance >= that computed bound, bit for bit (a valid
//    row lies in the box; an invalid row is at least 1e10 away): no margin
//    is needed. The warp first scans the tile of least bound (further tiles
//    while fewer than three valid sources were met), which gives an upper
//    limit U on the third-best distance. Then it walks the other tiles, 32
//    bounds at a time, and skips a tile only if its bound exceeds U (a source
//    at exactly U with a lower index must still be met). Lanes take the rows
//    lane, lane + 32, ... of a visited tile and keep a private best-3 in
//    (distance, index) order, so the order of the visits does not matter;
//    the common case costs one comparison a row. After each 32 tiles U is
//    tightened to the third-smallest distance met so far. Three rounds of
//    warp-wide minimum over (distance, index) merge the 32 lists: the
//    counterpart of _merge_sorted3.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTileRows = 256;       // sources a tile
constexpr int kRowsPerLane = kTileRows / 32;
constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerBlock = 16;
constexpr int kSeedTiles = 3;        // tiles tried for the first upper limit
constexpr int kBoxFields = 7;        // a tile's box: lo xyz, hi xyz, cap
constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;

// Distances are sums of squares plus a non-negative offset: never negative,
// so their bit patterns order like the values and redux.sync can take the
// minimum.
__device__ __forceinline__ unsigned warp_min(unsigned v) {
  return __reduce_min_sync(kFull, v);
}

// The third-smallest of the warp's 32 ascending lists (h0 <= h1 <= h2).
__device__ __forceinline__ float third_smallest(float h0, float h1, float h2, int lane) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m = warp_min(__float_as_uint(h0));
    const unsigned holders = __ballot_sync(kFull, __float_as_uint(h0) == m);
    if (lane == __ffs(holders) - 1) {
      h0 = h1;
      h1 = h2;
      h2 = INFINITY;
    }
  }
  return __uint_as_float(m);
}

// (distance, index) order: the lowest index wins among equal distances.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float source_distance(float qx, float qy, float qz,
                                                 const float4 v) {
  const float dx = qx - v.x, dy = qy - v.y, dz = qz - v.z;
  return (dx * dx + dy * dy + dz * dz) + v.w;
}

__global__ void __launch_bounds__(kThreads)
three_nn_prep_kernel(const float* __restrict__ src,
                     const unsigned char* __restrict__ src_valid,
                     float4* __restrict__ packed, float* __restrict__ boxes, int n,
                     int n_tiles) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (tile >= n_tiles) return;
  const float* sp = src + (size_t)b * n * 3;
  const unsigned char* vp = src_valid + (size_t)b * n;
  float4* out = packed + ((size_t)b * n_tiles + tile) * kTileRows;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  bool invalid_row = false;
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int row = r * 32 + lane;
    const int s = tile * kTileRows + row;
    float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
    if (s < n) {
      v.x = sp[(size_t)s * 3];
      v.y = sp[(size_t)s * 3 + 1];
      v.z = sp[(size_t)s * 3 + 2];
      const bool ok = vp[s] != 0;
      v.w = ok ? 0.f : kBig;
      invalid_row |= !ok;
      if (ok) {
        lo[0] = fminf(lo[0], v.x);
        lo[1] = fminf(lo[1], v.y);
        lo[2] = fminf(lo[2], v.z);
        hi[0] = fmaxf(hi[0], v.x);
        hi[1] = fmaxf(hi[1], v.y);
        hi[2] = fmaxf(hi[2], v.z);
      }
    }
    out[row] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(kFull, lo[k], off));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(kFull, hi[k], off));
    }
  }
  const bool capped = __any_sync(kFull, invalid_row);
  if (lane == 0) {
    // a tile without a valid row keeps lo = inf, hi = -inf: its box distance
    // is inf and its bound is the cap
    float* bp = boxes + ((size_t)b * n_tiles + tile) * kBoxFields;
    bp[0] = lo[0];
    bp[1] = lo[1];
    bp[2] = lo[2];
    bp[3] = hi[0];
    bp[4] = hi[1];
    bp[5] = hi[2];
    bp[6] = capped ? kBig : INFINITY;
  }
}

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float4* __restrict__ packed,
                const float* __restrict__ boxes, float* __restrict__ out_d,
                int* __restrict__ out_i, int m, int n, int n_tiles) {
  extern __shared__ float box_fields[];          // kBoxFields arrays of n_tiles
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const float* bp = boxes + (size_t)b * n_tiles * kBoxFields;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
#pragma unroll
    for (int f = 0; f < kBoxFields; ++f) box_fields[f * n_tiles + t] = bp[t * kBoxFields + f];
  }
  __syncthreads();
  const float* lox = box_fields;
  const float* loy = lox + n_tiles;
  const float* loz = loy + n_tiles;
  const float* hix = loz + n_tiles;
  const float* hiy = hix + n_tiles;
  const float* hiz = hiy + n_tiles;
  const float* cap = hiz + n_tiles;
  const float4* sp = packed + (size_t)b * n_tiles * kTileRows;

  const int q_first = blockIdx.x * kQueriesPerBlock;
  const int q_end = min(q_first + kQueriesPerBlock, m);
  for (int q = q_first + warp; q < q_end; q += kWarps) {
    const float* qp = query + ((size_t)b * m + q) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];

    auto tile_bound = [&](int t) {
      const float dx = qx - fminf(fmaxf(qx, lox[t]), hix[t]);
      const float dy = qy - fminf(fmaxf(qy, loy[t]), hiy[t]);
      const float dz = qz - fminf(fmaxf(qz, loz[t]), hiz[t]);
      return fminf(dx * dx + dy * dy + dz * dz, cap[t]);
    };

    // the lane's best three of the rows it met, ascending in (distance,
    // index); the order in which tiles are met does not matter
    float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
    int i0 = 0, i1 = 0, i2 = 0;
    auto scan_tile = [&](int tile) {
      const float4* tp = sp + (size_t)tile * kTileRows + lane;
      float4 v[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) v[r] = tp[r * 32];
      bool changed = false;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const float d = source_distance(qx, qy, qz, v[r]);
        if (d <= d2) {
          const int idx = tile * kTileRows + r * 32 + lane;
          if (before(d, idx, d2, i2)) {
            changed = true;
            if (before(d, idx, d1, i1)) {
              d2 = d1;
              i2 = i1;
              if (before(d, idx, d0, i0)) {
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
      }
      return changed;
    };

    // 1. the most promising tiles give a first upper limit on the third-best
    // distance: the tile of least bound, further ones while fewer than three
    // valid sources were met
    float upper = INFINITY;
    int seeds[kSeedTiles];
    unsigned prev_bound = 0;
    int prev_tile = -1;
#pragma unroll
    for (int a = 0; a < kSeedTiles; ++a) {
      seeds[a] = -1;
      if (upper < kBig) continue;
      unsigned best_bound = 0xffffffffu;
      int best_tile = kIntMax;
      for (int t = lane; t < n_tiles; t += 32) {
        const unsigned bound = __float_as_uint(tile_bound(t));
        const bool fresh = bound > prev_bound || (bound == prev_bound && t > prev_tile);
        if (fresh && bound < best_bound) {
          best_bound = bound;
          best_tile = t;
        }
      }
      const unsigned least = warp_min(best_bound);
      const int tile = (int)warp_min(best_bound == least ? (unsigned)best_tile
                                                         : (unsigned)kIntMax);
      if (tile == kIntMax) continue;                // every tile was taken
      prev_bound = least;
      prev_tile = tile;
      seeds[a] = tile;
      scan_tile(tile);
      upper = third_smallest(d0, d1, d2, lane);
    }

    // 2. every other tile whose bound does not exceed the limit
    for (int base = 0; base < n_tiles; base += 32) {
      const int t = base + lane;
      bool go = t < n_tiles && tile_bound(t) <= upper;
#pragma unroll
      for (int a = 0; a < kSeedTiles; ++a) go = go && t != seeds[a];
      unsigned todo = __ballot_sync(kFull, go);
      bool changed = false;
      while (todo) {
        changed |= scan_tile(base + __ffs(todo) - 1);
        todo &= todo - 1;
      }
      if (__any_sync(kFull, changed)) upper = fminf(upper, third_smallest(d0, d1, d2, lane));
    }

    // 3. the three smallest of the 32 lists in (distance, index) order
    const size_t o = ((size_t)b * m + q) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned least = warp_min(__float_as_uint(d0));
      const int idx = (int)warp_min(__float_as_uint(d0) == least ? (unsigned)i0
                                                                 : (unsigned)kIntMax);
      if (lane == 0) {
        out_d[o + k] = fmaxf(__uint_as_float(least), 0.f);
        out_i[o + k] = min(max(idx, 0), n - 1);
      }
      if (__float_as_uint(d0) == least && i0 == idx) {
        d0 = d1;
        i0 = i1;
        d1 = d2;
        i1 = i2;
        d2 = INFINITY;
        i2 = 0;
      }
    }
  }
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sources a tile: the wrapper sizes the scratch from it.
extern "C" int fv2p_three_nn_tile_rows() { return kTileRows; }

// query (b,m,3), src (b,n,3) f32; src_valid (b,n) uint8; scratch, with
// tiles = ceil(n / tile rows): packed (b, tiles * tile rows, 4) f32 and boxes
// (b, tiles, 7) f32 -> out_d, out_i (b,m,3).
extern "C" int fv2p_three_nn(const float* query, const float* src,
                             const unsigned char* src_valid, float* packed, float* boxes,
                             float* out_d, int* out_i, int b, int m, int n, void* stream) {
  if (b <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const size_t shared = sizeof(float) * kBoxFields * n_tiles;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        three_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  three_nn_prep_kernel<<<dim3((n_tiles + kWarps - 1) / kWarps, b), kThreads, 0, s>>>(
      src, src_valid, reinterpret_cast<float4*>(packed), boxes, n, n_tiles);
  three_nn_kernel<<<dim3((m + kQueriesPerBlock - 1) / kQueriesPerBlock, b), kThreads,
                    shared, s>>>(query, reinterpret_cast<const float4*>(packed), boxes,
                                 out_d, out_i, m, n, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
