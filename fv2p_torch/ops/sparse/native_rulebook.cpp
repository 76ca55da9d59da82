// Native rulebook builder for the sparse 3D backbone (the counterpart of the
// reference's C++ indice-pair construction, pcdet/ops/spconv/src/indice.cc):
// every gather table of one sample's topology, with a plain C interface
// loaded through ctypes by host_rulebook.py. Bit-exact with the numpy
// builder there (same key order, same truncation, same -1 sentinels).
//
// Build (host_rulebook.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 native_rulebook.cpp -o librulebook.so
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t encode(int64_t z, int64_t y, int64_t x, int64_t d, int64_t w) {
  return (y * w + x) * d + z;
}

// open-addressing hash: one cache miss per probe instead of ~14 for a
// binary search over 12k keys (this is what makes the builder ~20x faster
// than numpy searchsorted)
struct KeyMap {
  std::vector<int64_t> slot_key;
  std::vector<int32_t> slot_val;
  uint64_t mask = 0;

  void build(const std::vector<int64_t>& keys) {
    uint64_t cap = 16;
    while (cap < 2 * keys.size() + 1) cap <<= 1;
    mask = cap - 1;
    slot_key.assign(cap, -1);
    slot_val.assign(cap, -1);
    for (size_t i = 0; i < keys.size(); ++i) {
      uint64_t h = static_cast<uint64_t>(keys[i]) * 0x9E3779B97F4A7C15ull;
      uint64_t s = (h ^ (h >> 29)) & mask;
      while (slot_key[s] != -1) s = (s + 1) & mask;
      slot_key[s] = keys[i];
      slot_val[s] = static_cast<int32_t>(i);
    }
  }

  inline uint64_t slot_of(int64_t q) const {
    uint64_t h = static_cast<uint64_t>(q) * 0x9E3779B97F4A7C15ull;
    return (h ^ (h >> 29)) & mask;
  }

  inline void prefetch(int64_t q) const {
    __builtin_prefetch(&slot_key[slot_of(q)]);
  }

  inline int32_t find(int64_t q) const {
    uint64_t s = slot_of(q);
    while (true) {
      const int64_t k = slot_key[s];
      if (k == q) return slot_val[s];
      if (k == -1) return -1;
      s = (s + 1) & mask;
    }
  }
};

struct Level {
  std::vector<int64_t> keys;           // sorted
  std::vector<int32_t> coords;         // (n, 3) z,y,x matching keys order
  KeyMap map;
  int64_t d, h, w;
};

void subm_table(const Level& L, int kd, int kh, int kw, int cap,
                int32_t* out /* (K, cap) */) {
  // probe only the first half of the taps: subm neighborhoods are
  // symmetric (nbr[k][i] == j  <=>  nbr[K-1-k][j] == i) and the center tap
  // is the identity — halves the hash probes.
  const int K = kd * kh * kw;
  const int n = static_cast<int>(L.keys.size());
  std::fill(out, out + static_cast<size_t>(K) * cap, -1);
  int k = 0;
  for (int tz = 0; tz < kd; ++tz)
    for (int ty = 0; ty < kh; ++ty)
      for (int tx = 0; tx < kw; ++tx, ++k) {
        if (k > (K - 1) / 2) break;
        int32_t* row = out + static_cast<size_t>(k) * cap;
        if (2 * k == K - 1) {  // center
          for (int i = 0; i < n; ++i) row[i] = i;
          continue;
        }
        const int rz = tz - kd / 2, ry = ty - kh / 2, rx = tx - kw / 2;
        int32_t* mirror = out + static_cast<size_t>(K - 1 - k) * cap;
        // blocked probing with software prefetch: the probes are random
        // ~L2-miss accesses; issuing a block of prefetches hides latency
        constexpr int B = 16;
        int64_t qbuf[B];
        int ibuf[B];
        for (int i0 = 0; i0 < n; i0 += B) {
          const int lim = std::min(B, n - i0);
          int nb = 0;
          for (int t = 0; t < lim; ++t) {
            const int i = i0 + t;
            const int64_t z = L.coords[3 * i] + rz;
            const int64_t y = L.coords[3 * i + 1] + ry;
            const int64_t x = L.coords[3 * i + 2] + rx;
            if (z < 0 || z >= L.d || y < 0 || y >= L.h || x < 0 || x >= L.w)
              continue;
            qbuf[nb] = encode(z, y, x, L.d, L.w);
            ibuf[nb] = i;
            L.map.prefetch(qbuf[nb]);
            ++nb;
          }
          for (int t = 0; t < nb; ++t) {
            const int32_t j = L.map.find(qbuf[t]);
            row[ibuf[t]] = j;
            if (j >= 0) mirror[j] = ibuf[t];
          }
        }
      }
}

// insert-only hash set for candidate dedup (replaces sort+unique of the
// full (input x tap) candidate list: ~25 ms -> ~5 ms per scan)
struct KeySet {
  std::vector<int64_t> slot;
  uint64_t mask = 0;
  size_t count = 0;

  void init(size_t expect) {
    uint64_t cap = 16;
    while (cap < 2 * expect + 1) cap <<= 1;
    mask = cap - 1;
    slot.assign(cap, -1);
    count = 0;
  }

  inline void insert(int64_t q) {
    uint64_t h = static_cast<uint64_t>(q) * 0x9E3779B97F4A7C15ull;
    uint64_t s = (h ^ (h >> 29)) & mask;
    while (true) {
      const int64_t k = slot[s];
      if (k == q) return;
      if (k == -1) {
        slot[s] = q;
        ++count;
        return;
      }
      s = (s + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Builds all tables for one sample.
//   coords:      (n_valid, 3) int32 z,y,x in z-last key order
//   shape1:      int32[3] = d,h,w of level 1
//   down_params: (n_downs, 9) int32 kd,kh,kw,sd,sh,sw,pd,ph,pw
//   caps:        int32[n_downs+1] per-level capacities
//   subm_flags:  uint8[n_downs+1] build a 27-tap subm table for level i
// Outputs (caller-allocated, -1 sentinels):
//   subm_out:   concat of (27, caps[i]) for flagged levels, in level order
//   down_out:   concat of (K_i, caps[i+1])
//   inv_out:    concat of (K_i, caps[i])
//   coords_out: concat of (caps[i], 3) for levels 1..n_downs (downsampled)
//   nvalid_out: int32[n_downs+1] (slot 0 = n_valid input)
//   ntotal_out: int32[n_downs+1] pre-truncation active count per level;
//               ntotal > cap means rows were silently dropped (overflow)
void build_rulebooks(const int32_t* coords, int32_t n_valid,
                     const int32_t* shape1, int32_t n_downs,
                     const int32_t* down_params, const int32_t* caps,
                     const uint8_t* subm_flags, int32_t* subm_out,
                     int32_t* down_out, int32_t* inv_out, int32_t* coords_out,
                     int32_t* nvalid_out, int32_t* ntotal_out) {
  Level L;
  L.d = shape1[0];
  L.h = shape1[1];
  L.w = shape1[2];
  L.coords.assign(coords, coords + 3 * static_cast<size_t>(n_valid));
  L.keys.resize(n_valid);
  for (int i = 0; i < n_valid; ++i) {
    L.keys[i] =
        encode(L.coords[3 * i], L.coords[3 * i + 1], L.coords[3 * i + 2], L.d,
               L.w);
  }
  L.map.build(L.keys);
  nvalid_out[0] = n_valid;
  ntotal_out[0] = n_valid;

  int32_t* subm_ptr = subm_out;
  int32_t* down_ptr = down_out;
  int32_t* inv_ptr = inv_out;
  int32_t* coords_ptr = coords_out;

  if (subm_flags[0]) {
    subm_table(L, 3, 3, 3, caps[0], subm_ptr);
    subm_ptr += static_cast<size_t>(27) * caps[0];
  }

  for (int di = 0; di < n_downs; ++di) {
    const int32_t* p = down_params + 9 * di;
    const int kd = p[0], kh = p[1], kw = p[2];
    const int sd = p[3], sh = p[4], sw = p[5];
    const int pd = p[6], ph = p[7], pw = p[8];
    const int K = kd * kh * kw;
    const int cap_src = caps[di], cap_dst = caps[di + 1];
    const int64_t od = (L.d + 2 * pd - kd) / sd + 1;
    const int64_t oh = (L.h + 2 * ph - kh) / sh + 1;
    const int64_t ow = (L.w + 2 * pw - kw) / sw + 1;

    // candidate output cells from every (input, tap) pair, deduped in a
    // hash set; only the unique survivors get sorted (key order)
    const int n = static_cast<int>(L.keys.size());
    KeySet seen;
    seen.init(static_cast<size_t>(n) * 2 + 16);
    for (int tz = 0; tz < kd; ++tz)
      for (int ty = 0; ty < kh; ++ty)
        for (int tx = 0; tx < kw; ++tx)
          for (int i = 0; i < n; ++i) {
            const int64_t zn = L.coords[3 * i] + pd - tz;
            const int64_t yn = L.coords[3 * i + 1] + ph - ty;
            const int64_t xn = L.coords[3 * i + 2] + pw - tx;
            if (zn % sd != 0 || yn % sh != 0 || xn % sw != 0) continue;
            const int64_t oz = zn / sd, oy = yn / sh, ox = xn / sw;
            if (oz < 0 || oz >= od || oy < 0 || oy >= oh || ox < 0 ||
                ox >= ow)
              continue;
            seen.insert(encode(oz, oy, ox, od, ow));
          }
    std::vector<int64_t> cand;
    cand.reserve(seen.count);
    for (const int64_t k2 : seen.slot)
      if (k2 != -1) cand.push_back(k2);
    std::sort(cand.begin(), cand.end());
    const int m = static_cast<int>(
        std::min<size_t>(cand.size(), static_cast<size_t>(cap_dst)));

    Level O;
    O.d = od;
    O.h = oh;
    O.w = ow;
    O.keys.assign(cand.begin(), cand.begin() + m);
    O.coords.resize(3 * static_cast<size_t>(m));
    for (int i = 0; i < m; ++i) {
      const int64_t key = O.keys[i];
      const int64_t oz = key % od;
      const int64_t col = key / od;
      O.coords[3 * i] = static_cast<int32_t>(oz);
      O.coords[3 * i + 1] = static_cast<int32_t>(col / ow);
      O.coords[3 * i + 2] = static_cast<int32_t>(col % ow);
    }
    O.map.build(O.keys);

    // output-gather table + inverse
    std::fill(down_ptr, down_ptr + static_cast<size_t>(K) * cap_dst, -1);
    std::fill(inv_ptr, inv_ptr + static_cast<size_t>(K) * cap_src, -1);
    int k = 0;
    for (int tz = 0; tz < kd; ++tz)
      for (int ty = 0; ty < kh; ++ty)
        for (int tx = 0; tx < kw; ++tx, ++k) {
          int32_t* drow = down_ptr + static_cast<size_t>(k) * cap_dst;
          int32_t* irow = inv_ptr + static_cast<size_t>(k) * cap_src;
          constexpr int B = 16;
          int64_t qbuf[B];
          int obuf[B];
          for (int o0 = 0; o0 < m; o0 += B) {
            const int lim = std::min(B, m - o0);
            int nb = 0;
            for (int t = 0; t < lim; ++t) {
              const int o = o0 + t;
              const int64_t iz = static_cast<int64_t>(O.coords[3 * o]) * sd -
                                 pd + tz;
              const int64_t iy = static_cast<int64_t>(O.coords[3 * o + 1]) *
                                     sh - ph + ty;
              const int64_t ix = static_cast<int64_t>(O.coords[3 * o + 2]) *
                                     sw - pw + tx;
              if (iz < 0 || iz >= L.d || iy < 0 || iy >= L.h || ix < 0 ||
                  ix >= L.w)
                continue;
              qbuf[nb] = encode(iz, iy, ix, L.d, L.w);
              obuf[nb] = o;
              L.map.prefetch(qbuf[nb]);
              ++nb;
            }
            for (int t = 0; t < nb; ++t) {
              const int32_t src = L.map.find(qbuf[t]);
              drow[obuf[t]] = src;
              if (src >= 0) irow[src] = obuf[t];
            }
          }
        }
    down_ptr += static_cast<size_t>(K) * cap_dst;
    inv_ptr += static_cast<size_t>(K) * cap_src;

    // padded coords + nvalid for this level
    std::memset(coords_ptr, 0, sizeof(int32_t) * 3 * cap_dst);
    std::memcpy(coords_ptr, O.coords.data(), sizeof(int32_t) * 3 * m);
    coords_ptr += 3 * static_cast<size_t>(cap_dst);
    nvalid_out[di + 1] = m;
    ntotal_out[di + 1] = static_cast<int32_t>(cand.size());

    if (subm_flags[di + 1]) {
      subm_table(O, 3, 3, 3, cap_dst, subm_ptr);
      subm_ptr += static_cast<size_t>(27) * cap_dst;
    }
    L = std::move(O);
  }
}

}  // extern "C"
