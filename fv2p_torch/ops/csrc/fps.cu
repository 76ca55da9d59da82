// Exact farthest-point sampling: (B,N) planar x/y/z + valid -> (B,K) int32.
//
// Replaces the Pallas TPU kernel fv2p_tpu/ops/pallas/fps.py (fps_pallas /
// _fps_kernel). Pick 0 is the first valid index (0 if none). Each later pick
// updates every point's running min squared distance to the picked set and
// takes the argmax, the lowest index winning ties; invalid points sit at
// -1e10 and never win.
//
// What bounds it on the H100: the dependency chain. The K-1 picks are
// strictly sequential and each needs an argmax over all N points; bytes
// (N*13 B once) and operations (~10 per point per pick) are far below the
// card's rates. What counts is the latency of one pick: the distance pass
// over a thread's points, plus one cluster-wide exchange.
//
// Design: a thread-block cluster of kCluster blocks per scan.
//   * Block `rank` owns points j*kCluster*kThreads + rank*kThreads + tid.
//     Their coordinates and running distances live in registers, so the
//     distance pass reads no memory. Distances are ((dx*dx + dy*dy) + dz*dz)
//     without fused multiply-adds (--fmad=false), as the plain version
//     rounds them.
//   * The running distance is mapped to a u32 key that orders like the float
//     (sign bit flipped for >= 0, all bits inverted for < 0), so a warp's
//     argmax with the lowest index winning is two redux.sync operations:
//     max of the key, then min of the index over the lanes holding that max.
//   * Every warp packs (key, pick number, index) into one 64-bit word and
//     lanes 0..kCluster-1 store it into the warp's slot in every block's
//     shared memory (distributed shared memory, st.shared::cluster). After
//     one synchronisation every warp of every block reduces all
//     kCluster*kWarps slots itself with the same two redux.sync, so all
//     threads know the pick without a broadcast. Block 0 writes out.
//   * The picked point's coordinates. Up to 18432 points (the eval path's
//     18000) every block keeps a copy of the whole scan in its own shared
//     memory (12*N bytes, opted in), so they are one local load. Above that
//     the copy no longer fits (288 KB at the dataset's 24000-point cap,
//     over the 227 KB of shared memory a block of an H100, sm_90, can opt
//     into): a second instantiation keeps in each block only its own
//     points, as float4 (48 KB at 24576), and reads the winner's from the
//     owning block through distributed shared memory (one
//     ld.shared::cluster.v4 a pick). The pick chain, slot word and exchange
//     are the same in both.
//   * Waymo scans (MAX_POINTS_PER_SCAN 180000). 8 x 128 threads would hold
//     176 points a thread, far past the register file. A third
//     instantiation spreads a scan over a cluster of 16 blocks of 512
//     threads (16 is past the portable 8: the launch opts into
//     cudaFuncAttributeNonPortableClusterSizeAllowed), 22 points a thread
//     in registers (180224 in all) and each block's own points as float4 in
//     shared memory (176 KB). An index needs 18 bits, so its slot word
//     carries a 14-bit tag. With 256 warps a cluster the one-level
//     exchange would have every warp poll 256 slots a pick; this shape
//     reduces each block's 16 warps first and exchanges one slot a block
//     (exchange_two_level): 22.07 against 23.91 ms for 16384 picks from
//     2 x 180000 points of the Waymo fixture, chain floors 14.40 against
//     18.80 ms (tools/torch_kernel_variants.py, H100 80GB HBM3 at 700 W).
//     The dataset pads a scan with invalid points
//     (about 30000 valid of 180000 on the Waymo fixture), and invalid
//     points never change (their running distance stays -1e10), so a
//     thread updates only its points up to its last valid one; a thread
//     with none offers the constant candidate its points would give
//     (-1e10 at its lowest index, or nothing). That is exact for any mask.
//
// The exchange protocol has no cluster barrier inside the loop. Slots are
// double-buffered by pick parity: pick k writes buffer k&1. A word carries
// its pick number, is written with one 64-bit store (single-copy atomic),
// and a warp polls its local buffer k&1 until every slot shows tag k. A fast
// warp can run at most one pick ahead: to finish pick k+1 it needs the
// pick-k+1 word of every warp of the cluster, and a warp computes that word
// from the pick it reduced out of all pick-k slots, so every warp has
// consumed buffer k&1 before anyone can store pick k+2 into it. Tags of one
// buffer differ by 2 between successive uses, so the tag (16 bits; 14 in the
// 180000-point shape) never confuses an old word with a new one; the buffers
// start with an all-ones tag, which is neither 0 nor 1. A cluster barrier
// after the set-up keeps any remote store from reaching a block that has not
// initialised its slots, and one before the exit keeps a block alive while
// peers may still store into it.
//
// The shape (8 blocks of 128 threads, 18 points a thread) and the tagged
// poll are the measured best of cluster 4/8/16 x 128/256/512 threads x
// cluster barrier/tagged poll at B=4, N=18000, K=16384 on an H100: a
// barrier.cluster arrive + wait a pick costs more by itself than the whole
// tagged-poll pick.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;

// One instantiation's shape: kCluster blocks of kThreads threads per scan,
// kPointsPerThread points a thread, indices in kIdxBits bits of the slot
// word (the tag takes the other 32 - kIdxBits of its low half). kTwoLevel:
// the exchange reduces each block's warps first (exchange_two_level).
template <int kCluster_, int kThreads_, int kPointsPerThread_, int kIdxBits_,
          bool kTwoLevel_>
struct Shape {
  static constexpr int kCluster = kCluster_;
  static constexpr int kThreads = kThreads_;
  static constexpr int kPointsPerThread = kPointsPerThread_;
  static constexpr int kIdxBits = kIdxBits_;
  static constexpr bool kTwoLevel = kTwoLevel_;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStride = kCluster * kThreads;  // points the cluster takes per round
  static constexpr int kMaxPoints = kPointsPerThread * kStride;
  // slots a block holds per buffer: one a warp of the cluster, or one a block
  static constexpr int kSlots = kTwoLevel ? kCluster : kCluster * kWarps;
  static constexpr int kSlotsPerLane = (kSlots + 31) / 32;
  static constexpr uint32_t kIdxMask = (1u << kIdxBits) - 1u;
  static constexpr uint32_t kTagMask = (1u << (32 - kIdxBits)) - 1u;
  static constexpr uint32_t kNoIndex = kIdxMask;  // index field of a slot that holds no point
  static_assert(kCluster >= 1 && kCluster <= 16, "cluster size");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
  static_assert(kMaxPoints < static_cast<int>(kNoIndex), "index field");
  static_assert(kTagMask >= 3, "a tag must tell two uses of a buffer apart");
  static_assert(!kTwoLevel || (kWarps <= 32 && kCluster <= 32), "one warp reduces");
};

constexpr int kCluster = 8;    // blocks per scan (the portable maximum)
constexpr int kThreads = 128;  // threads per block
constexpr int kStride = kCluster * kThreads;
// whole-scan copy in every block: 18 points a thread, 18000 on the eval path
constexpr int kMaxPointsShared = 18 * kStride;
// own points only: 24 a thread, the train path's 24000-point scans
constexpr int kMaxPoints = 24 * kStride;
using SharedShape = Shape<kCluster, kThreads, kMaxPointsShared / kStride, 16, false>;
using OwnShape = Shape<kCluster, kThreads, kMaxPoints / kStride, 16, false>;
// Waymo's 180000-point scans: 16 blocks (non-portable) of 512 threads, 22 a thread
constexpr int kWideCluster = 16;
constexpr int kWideThreads = 512;
constexpr int kWideStride = kWideCluster * kWideThreads;
constexpr int kMaxPointsWide = 22 * kWideStride;
constexpr bool kWideTwoLevel = true;
using WideShape =
    Shape<kWideCluster, kWideThreads, kMaxPointsWide / kWideStride, 18, kWideTwoLevel>;
static_assert(kMaxPointsShared < kMaxPoints && kMaxPoints < kMaxPointsWide,
              "three instantiations");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// shared::cluster address of this block's shared address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void store_cluster(uint32_t addr, unsigned long long v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_slot(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 load_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// f32 -> u32 with the same order: -inf < -1e10 < +0.0 < 1e10. (-0.0 cannot
// arise: a running distance is a sum of squares or one of the constants.)
__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Cluster-wide argmax of (key, lowest index) for pick number k. Every thread
// of the cluster calls it with its own candidate and gets the winning index.
template <class S>
__device__ __forceinline__ int exchange(uint32_t key, uint32_t idx, int k,
                                        uint32_t remote_slot, uint32_t local_slots,
                                        int lane) {
  const uint32_t wmax = __reduce_max_sync(kFull, key);
  const uint32_t wmin = __reduce_min_sync(kFull, key == wmax ? idx : kFull);
  const uint32_t tag = static_cast<uint32_t>(k) & S::kTagMask;
  const uint32_t buf = static_cast<uint32_t>(k & 1) * (S::kSlots * 8u);
  if (lane < S::kCluster) {
    const unsigned long long word = (static_cast<unsigned long long>(wmax) << 32) |
                                    (tag << S::kIdxBits) | (wmin & S::kIdxMask);
    store_cluster(remote_slot + buf, word);
  }
  __syncwarp();

  unsigned long long w[S::kSlotsPerLane];
  bool ready;
  do {
    ready = true;
#pragma unroll
    for (int q = 0; q < S::kSlotsPerLane; ++q) {
      const int s = lane + 32 * q;
      if (s < S::kSlots) {
        w[q] = load_slot(local_slots + buf + s * 8u);
        ready = ready && ((static_cast<uint32_t>(w[q]) >> S::kIdxBits) == tag);
      } else {
        w[q] = S::kNoIndex;  // key 0 loses to every real key
      }
    }
  } while (!__all_sync(kFull, ready));

  uint32_t bk = 0;
#pragma unroll
  for (int q = 0; q < S::kSlotsPerLane; ++q) bk = max(bk, static_cast<uint32_t>(w[q] >> 32));
  uint32_t bi = kFull;
#pragma unroll
  for (int q = 0; q < S::kSlotsPerLane; ++q)
    if (static_cast<uint32_t>(w[q] >> 32) == bk)
      bi = min(bi, static_cast<uint32_t>(w[q]) & S::kIdxMask);
  const uint32_t cmax = __reduce_max_sync(kFull, bk);
  return static_cast<int>(__reduce_min_sync(kFull, bk == cmax ? bi : kFull));
}

// The same argmax in two levels, for a cluster of many warps: each warp's
// candidate goes to its block's shared memory; after a block barrier warp
// 0 reduces the block's kWarps candidates and its lanes 0..kCluster-1 store
// the block's word, tagged as above, into slot `rank` of every block; warp
// 0 polls its block's kCluster slots, reduces them and leaves the pick in
// shared memory for the block's other warps behind a second barrier. A
// pick then costs two block barriers and kCluster slots a block in place of
// kCluster * kWarps. The double-buffer argument above holds block for
// block; within a block, a warp writes its next candidate only after the
// barrier that follows warp 0's reading of the current ones, and warp 0
// writes the next pick only after the barrier that follows every warp's
// reading of the current one.
template <class S>
__device__ __forceinline__ int exchange_two_level(uint32_t key, uint32_t idx, int k,
                                                  uint32_t remote_slot, uint32_t local_slots,
                                                  unsigned long long* warp_best, int* pick,
                                                  int lane, int warp) {
  const uint32_t wmax = __reduce_max_sync(kFull, key);
  const uint32_t wmin = __reduce_min_sync(kFull, key == wmax ? idx : kFull);
  if (lane == 0) warp_best[warp] = (static_cast<unsigned long long>(wmax) << 32) | wmin;
  __syncthreads();
  if (warp == 0) {
    uint32_t bk = 0, bi = kFull;
    if (lane < S::kWarps) {
      const unsigned long long w = warp_best[lane];
      bk = static_cast<uint32_t>(w >> 32);
      bi = static_cast<uint32_t>(w);
    }
    const uint32_t bmax = __reduce_max_sync(kFull, bk);
    const uint32_t bmin = __reduce_min_sync(kFull, bk == bmax ? bi : kFull);
    const uint32_t tag = static_cast<uint32_t>(k) & S::kTagMask;
    const uint32_t buf = static_cast<uint32_t>(k & 1) * (S::kSlots * 8u);
    if (lane < S::kCluster) {
      const unsigned long long word = (static_cast<unsigned long long>(bmax) << 32) |
                                      (tag << S::kIdxBits) | (bmin & S::kIdxMask);
      store_cluster(remote_slot + buf, word);
    }
    __syncwarp();
    unsigned long long w = 0;  // lanes past the cluster: key 0
    bool ready;
    do {
      ready = true;
      if (lane < S::kCluster) {
        w = load_slot(local_slots + buf + lane * 8u);
        ready = (static_cast<uint32_t>(w) >> S::kIdxBits) == tag;
      }
    } while (!__all_sync(kFull, ready));
    const uint32_t ck = static_cast<uint32_t>(w >> 32);
    const uint32_t cmax = __reduce_max_sync(kFull, ck);
    const uint32_t cmin = __reduce_min_sync(
        kFull, (lane < S::kCluster && ck == cmax) ? (static_cast<uint32_t>(w) & S::kIdxMask)
                                                   : kFull);
    if (lane == 0) *pick = static_cast<int>(cmin);
  }
  __syncthreads();
  return *pick;
}

// kWork = false is the synchronisation skeleton alone: the same cluster, the
// same stores, tagged poll, reductions and coordinate load, with a hash
// of the last pick in place of the distance pass. It times the floor that
// the chain of K-1 exchanges sets under any amount of distance work.
//
// S: the shape (cluster, block, points a thread, index bits).
// kWholeScan: every block holds the whole scan's coordinates (xs | ys | zs,
// 12*n bytes); otherwise each block holds its own points as float4 at local
// row j*kThreads + tid (16*kPointsPerThread*kThreads bytes) and the pick's
// coordinates are read from the owning block.
// kSkipTail: a thread updates its points only up to its last valid one.
template <bool kWork, class S, bool kWholeScan, bool kSkipTail>
__global__ void __launch_bounds__(S::kThreads, 1)
fps_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
           const float* __restrict__ gz, const unsigned char* __restrict__ valid,
           int* __restrict__ out, int n, int k_samples) {
  constexpr int kThreads = S::kThreads, kStride = S::kStride, kPoints = S::kPointsPerThread;
  extern __shared__ __align__(16) float coords[];
  __shared__ __align__(8) unsigned long long slots[2 * S::kSlots];
  __shared__ __align__(8) unsigned long long warp_best[S::kWarps];  // two-level only
  __shared__ int pick;                                               // two-level only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int b = blockIdx.x / S::kCluster;
  const size_t row = static_cast<size_t>(b) * n;
  float* xs = coords;
  float* ys = coords + n;
  float* zs = coords + 2 * n;
  if (kWholeScan) {
    for (int i = tid; i < n; i += kThreads) {
      xs[i] = gx[row + i];
      ys[i] = gy[row + i];
      zs[i] = gz[row + i];
    }
  }
  for (int i = tid; i < 2 * S::kSlots; i += kThreads) slots[i] = ~0ull;

  // this thread's points: coordinates and running min distances in registers
  const int base = rank * kThreads + tid;
  float px[kPoints], py[kPoints], pz[kPoints];
  float dist[kPoints];
  int first = -1;
  int live = 0;  // 1 + the last of this thread's slots that holds a valid point
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = base + j * kStride;
    const bool in = i < n;
    const bool ok = in && valid[row + i];
    px[j] = in ? gx[row + i] : 0.f;
    py[j] = in ? gy[row + i] : 0.f;
    pz[j] = in ? gz[row + i] : 0.f;
    dist[j] = in ? (ok ? kBig : -kBig) : -INFINITY;
    if (ok && first < 0) first = i;
    if (ok) live = j + 1;
    if (!kWholeScan)
      reinterpret_cast<float4*>(coords)[j * kThreads + tid] =
          make_float4(px[j], py[j], pz[j], 0.f);
  }
  // the candidate of a thread without a valid point: its points keep their
  // initial distances, so its best is the first (lowest index) of them
  const uint32_t idle_key = ordered_key(base < n ? -kBig : -INFINITY);
  const uint32_t idle_idx = base < n ? static_cast<uint32_t>(base) : S::kNoIndex;

  const uint32_t local_slots = smem_addr(slots);
  // this warp's (flat) or this block's (two-level) slot in block `lane`
  const uint32_t remote_slot =
      map_to_rank(local_slots, lane < S::kCluster ? lane : 0) +
      (S::kTwoLevel ? rank : rank * S::kWarps + warp) * 8u;
  auto argmax = [&](uint32_t key, uint32_t idx, int k) {
    if constexpr (S::kTwoLevel)
      return exchange_two_level<S>(key, idx, k, remote_slot, local_slots, warp_best, &pick,
                                   lane, warp);
    else
      return exchange<S>(key, idx, k, remote_slot, local_slots, lane);
  };
  cluster_barrier();  // coordinates and slots of every block are in place

  // pick 0: the first valid index, 0 if the row has none
  int last = argmax(first >= 0 ? kFull - static_cast<uint32_t>(first) : 0u,
                    first >= 0 ? static_cast<uint32_t>(first) : 0u, 0);
  int* out_row = out + static_cast<size_t>(b) * k_samples;
  const bool writer = rank == 0 && tid == 0;
  if (writer) out_row[0] = last;

  const uint32_t own_coords = smem_addr(coords);
  for (int k = 1; k < k_samples; ++k) {
    float cx, cy, cz;
    if (kWholeScan) {
      cx = xs[last];
      cy = ys[last];
      cz = zs[last];
    } else {
      // point `last` is row (last / kStride) * kThreads + last % kThreads of
      // block (last % kStride) / kThreads
      const uint32_t owner = static_cast<uint32_t>((last % kStride) / kThreads);
      const uint32_t local = static_cast<uint32_t>((last / kStride) * kThreads + last % kThreads);
      const float4 c = load_cluster_f4(map_to_rank(own_coords + local * 16u, owner));
      cx = c.x;
      cy = c.y;
      cz = c.z;
    }
    uint32_t key, idx;
    if (kWork) {
      float best = -INFINITY;
      idx = S::kNoIndex;
#pragma unroll
      for (int j = 0; j < kPoints; ++j) {
        if (kSkipTail && j >= live) continue;  // invalid from here on: unchanged
        const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
        const float d = dx * dx + dy * dy + dz * dz;
        const float nd = fminf(dist[j], d);
        dist[j] = nd;
        if (nd > best) {  // strict: the lowest of this thread's indices wins
          best = nd;
          idx = static_cast<uint32_t>(base + j * kStride);
        }
      }
      key = ordered_key(best);
      if (kSkipTail && live == 0) {
        key = idle_key;
        idx = idle_idx;
      }
    } else {
      key = (__float_as_uint(cx + cy + cz) * 2654435761u) ^ (base * 40503u + k);
      idx = base < n ? base : 0;
    }
    last = argmax(key, idx, k);
    if (writer) out_row[k] = last;
  }
  cluster_barrier();  // no block leaves while a peer may still store into it
}

template <class S, class Kernel>
int launch_shape(Kernel kernel, int smem_bytes, const float* x, const float* y,
                 const float* z, const unsigned char* valid, int* out, int b, int n, int k,
                 void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S::kCluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * S::kCluster);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, z, valid, out, n, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWork>
int launch(const float* x, const float* y, const float* z, const unsigned char* valid,
           int* out, int b, int n, int k, void* stream) {
  if (b == 0 || k == 0) return 0;
  if (n < 1 || n > kMaxPointsWide) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kMaxPointsShared)
    return launch_shape<SharedShape>(fps_kernel<kWork, SharedShape, true, false>,
                                     3 * n * static_cast<int>(sizeof(float)), x, y, z, valid,
                                     out, b, n, k, stream);
  if (n <= kMaxPoints)
    return launch_shape<OwnShape>(
        fps_kernel<kWork, OwnShape, false, false>,
        OwnShape::kPointsPerThread * OwnShape::kThreads * static_cast<int>(sizeof(float4)), x,
        y, z, valid, out, b, n, k, stream);
  return launch_shape<WideShape>(
      fps_kernel<kWork, WideShape, false, true>,
      WideShape::kPointsPerThread * WideShape::kThreads * static_cast<int>(sizeof(float4)), x,
      y, z, valid, out, b, n, k, stream);
}

}  // namespace

extern "C" const char* fv2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y, z (b,n) f32; valid (b,n) uint8; out (b,k) int32. Requires
// n <= 180224 and a card with thread-block clusters (compute capability 9.0).
extern "C" int fv2p_fps(const float* x, const float* y, const float* z,
                        const unsigned char* valid, int* out, int b, int n, int k,
                        void* stream) {
  return launch<true>(x, y, z, valid, out, b, n, k, stream);
}

// The exchange chain of fv2p_fps without its distance work (a timing floor;
// `out` receives indices below n that mean nothing).
extern "C" int fv2p_fps_chain(const float* x, const float* y, const float* z,
                              const unsigned char* valid, int* out, int b, int n, int k,
                              void* stream) {
  return launch<false>(x, y, z, valid, out, b, n, k, stream);
}
