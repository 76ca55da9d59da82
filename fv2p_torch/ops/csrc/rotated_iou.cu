// Rotated-BEV box overlap: intersection areas of (N,4,2) x (M,4,2) CCW
// corners -> (N,M), and the IoU of (N,7) x (M,7) boxes -> (N,M), in full or
// (a set against itself) the upper triangle i < j only, as greedy NMS reads it.
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/rotated_iou.py
// (overlap_matrix / _overlap_kernel / _clip_tile).
//
// What bounds it on the H100: arithmetic. A pair's Sutherland-Hodgman clip of
// one quad by the four edges of the other (at most 8 vertices) and its
// shoelace sum are a few thousand scalar f32 operations, against 56-64 B in
// and 4 B out. But most pairs of a detector's boxes lie far apart, and NMS
// reads only i < j. Design, one block per 32 x 32 pairs:
//
//  * 64 threads set up the block's boxes in shared memory: the corners (for
//    the IoU entry points computed here from x, y, dx, dy, heading with the
//    operations of box_utils.boxes_to_corners_bev in their order, sinf and
//    cosf unfused), the mean of the corners, the largest distance from it to
//    a corner, and the area dx * dy.
//  * Cull: a pair whose centers are farther apart than the two radii (with a
//    relative margin of 1e-3 and 1e-5 of the coordinates' magnitude, far more
//    than rounding moves them) has disjoint boxes, and the clip of disjoint
//    boxes is exactly 0: every vertex falls outside some edge and the polygon
//    runs empty. That holds only where all four edges of the clip box have a
//    direction: a null edge keeps every vertex (a box of size 0 returns the
//    other box's area), and an edge shorter than the coordinates' rounding
//    points anywhere. So a box whose shortest edge is not above 1e-4 of its
//    coordinates' magnitude gets an infinite radius and is never culled, nor
//    is anything that is not finite. Culled pairs, and i >= j of an upper
//    triangle, are written as 0.0 at once.
//  * Compact: the surviving pairs go into a queue in shared memory (ballot,
//    popcount, one atomicAdd a warp); then the threads take the queue in
//    dense groups of 32, so no warp runs the clip for a single lane.
//  * Epilogue (IoU entry points): ov / max((area_a + area_b) - ov, 1e-6) in
//    IEEE f32, the composition utils/iou3d.py made of the overlap matrix.
//
// The clip holds its polygon in registers. Every loop over the 8 vertex slots
// is unrolled, and the compaction of emitted vertices is a chain of predicated
// selects over static slots (as in the TPU kernel), so no register array is
// indexed dynamically and nothing spills to local memory. The arithmetic is
// that of the plain PyTorch version line for line; built with --fmad=false it
// rounds the same, so NMS decisions at the threshold cannot move.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kV = 8;          // max vertices of a quad-quad intersection
constexpr float kEps = 1e-8f;
constexpr int kTile = 32;      // a block's pairs: kTile rows x kTile columns
constexpr int kThreads = 256;
constexpr int kPairs = kTile * kTile;
constexpr float kCullRel = 1e-3f, kCullAbs = 1e-5f, kMinEdgeRel = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

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

// One side of the block's pairs: kTile boxes as corners, center, radius, area.
struct BoxTile {
  float x[kTile][4], y[kTile][4];
  float cx[kTile], cy[kTile], radius[kTile], area[kTile];
};

// Box k of the tile from CCW corners (4,2), or from (x, y, z, dx, dy, dz,
// heading) with the corner order and arithmetic of boxes_to_corners_bev(...)
// .flip(1): template (-,+), (-,-), (+,-), (+,+) halves, rotated, shifted.
template <bool kBoxes>
__device__ __forceinline__ void load_box(BoxTile& t, int k, const float* __restrict__ p) {
  float x[4], y[4];
  float area = 0.f;
  if (kBoxes) {
    const float dx = p[3], dy = p[4];
    const float cosa = cosf(p[6]), sina = sinf(p[6]);
    const float tx[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
    const float ty[4] = {0.5f, -0.5f, -0.5f, 0.5f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float lx = dx * tx[c], ly = dy * ty[c];
      x[c] = (lx * cosa - ly * sina) + p[0];
      y[c] = (lx * sina + ly * cosa) + p[1];
    }
    area = dx * dy;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = p[2 * c];
      y[c] = p[2 * c + 1];
    }
  }
  const float cx = 0.25f * ((x[0] + x[2]) + (x[1] + x[3]));
  const float cy = 0.25f * ((y[0] + y[2]) + (y[1] + y[3]));
  float r2 = 0.f, edge2 = INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float rx = x[c] - cx, ry = y[c] - cy;
    const float ex = x[(c + 1) & 3] - x[c], ey = y[(c + 1) & 3] - y[c];
    r2 = fmaxf(r2, rx * rx + ry * ry);
    edge2 = fminf(edge2, ex * ex + ey * ey);
    t.x[k][c] = x[c];
    t.y[k][c] = y[c];
  }
  const float radius = sqrtf(r2);
  const float min_edge = kMinEdgeRel * ((fabsf(cx) + fabsf(cy)) + radius);
  t.cx[k] = cx;
  t.cy[k] = cy;
  // (a NaN fails the comparison too)
  t.radius[k] = edge2 > min_edge * min_edge ? radius : INFINITY;
  t.area[k] = area;
}

// kBoxes: inputs are boxes (.,7) and the output is the IoU; else inputs are
// corners (.,4,2) and the output the intersection area. kUpper: b is a, and
// only i < j is computed.
template <bool kBoxes, bool kUpper>
__global__ void __launch_bounds__(kThreads)
overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int n, int m) {
  __shared__ BoxTile rows, cols;
  __shared__ unsigned short queue[kPairs];
  __shared__ int queued;
  constexpr int kStride = kBoxes ? 7 : 8;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  if (kUpper && blockIdx.y > blockIdx.x) {       // wholly below the diagonal
    for (int e = tid; e < kPairs; e += kThreads) {
      const int i = i0 + e / kTile, j = j0 + e % kTile;
      if (i < n && j < m) out[(size_t)i * m + j] = 0.f;
    }
    return;
  }
  if (tid == 0) queued = 0;
  if (tid < 2 * kTile) {
    const int k = tid % kTile;
    const bool col = tid >= kTile;
    const int idx = (col ? j0 : i0) + k;
    // past the end: the last box again, its pairs are never computed
    const int last = (col ? m : n) - 1;
    load_box<kBoxes>(col ? cols : rows, k, (col ? b : a) + (size_t)min(idx, last) * kStride);
  }
  __syncthreads();

  for (int e = tid; e < kPairs; e += kThreads) {
    const int ti = e / kTile, tj = e % kTile;
    const int i = i0 + ti, j = j0 + tj;
    const bool in_range = i < n && j < m;
    const float dx = rows.cx[ti] - cols.cx[tj], dy = rows.cy[ti] - cols.cy[tj];
    const float d2 = dx * dx + dy * dy;
    const float reach = (rows.radius[ti] + cols.radius[tj]) * (1.f + kCullRel)
        + kCullAbs * ((fabsf(rows.cx[ti]) + fabsf(rows.cy[ti]))
                      + (fabsf(cols.cx[tj]) + fabsf(cols.cy[tj])));
    // any NaN makes a comparison false: such a pair is clipped, not culled
    const bool culled = d2 > reach * reach && d2 < INFINITY;
    const bool live = in_range && !culled && (!kUpper || i < j);
    if (in_range && !live) out[(size_t)i * m + j] = 0.f;
    const unsigned mask = __ballot_sync(kFull, live);
    if (mask) {
      const int lane = tid & 31;
      int base = 0;
      if (lane == __ffs(mask) - 1) base = atomicAdd(&queued, __popc(mask));
      base = __shfl_sync(kFull, base, __ffs(mask) - 1);
      if (live) queue[base + __popc(mask & ((1u << lane) - 1))] = (unsigned short)e;
    }
  }
  __syncthreads();

  const int count = queued;
  for (int q = tid; q < count; q += kThreads) {
    const int e = queue[q];
    const int ti = e / kTile, tj = e % kTile;
    float ax[4], ay[4], bx[4], by[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ax[c] = rows.x[ti][c];
      ay[c] = rows.y[ti][c];
      bx[c] = cols.x[tj][c];
      by[c] = cols.y[tj][c];
    }
    float v = clip_area(ax, ay, bx, by);
    if (kBoxes) v = v / fmaxf((rows.area[ti] + cols.area[tj]) - v, 1e-6f);
    out[(size_t)(i0 + ti) * m + (j0 + tj)] = v;
  }
}

template <bool kBoxes, bool kUpper>
int launch(const float* a, const float* b, float* out, int n, int m, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    overlap_kernel<kBoxes, kUpper><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// corners_a (n,4,2), corners_b (m,4,2) f32 contiguous -> areas out (n,m) f32.
extern "C" int fv2p_overlap_matrix(const float* corners_a, const float* corners_b,
                                   float* out, int n, int m, void* stream) {
  return launch<false, false>(corners_a, corners_b, out, n, m, stream);
}

// boxes_a (n,7), boxes_b (m,7) f32 contiguous -> BEV IoU out (n,m) f32. With
// upper != 0, boxes_b is boxes_a and only i < j is computed, 0 elsewhere.
extern "C" int fv2p_iou_bev(const float* boxes_a, const float* boxes_b, float* out,
                            int n, int m, int upper, void* stream) {
  if (upper) return launch<true, true>(boxes_a, boxes_a, out, n, n, stream);
  return launch<true, false>(boxes_a, boxes_b, out, n, m, stream);
}
