// Tile-walk ray traversal for Hopper (sm_90a): the per-round kernel of the
// host-driven walk and the fused walk in its closest-hit and any-hit forms.
//
// Replaces the Pallas TPU kernels of spcbpt_tpu/ops/pallas_tile.py:
//   tile_round         <- _round_kernel   (pallas_tile.py:416, via mt_round)
//   tile_walk_closest  <- _closest_kernel (pallas_tile.py:163, via
//                                          pallas_closest)
//   tile_walk_any      <- _any_kernel     (pallas_tile.py:236, via pallas_any)
// and computes what they compute, lane for lane: the Moller-Trumbore
// arithmetic of `_mt_vpu` in its operation order (built with --fmad=false,
// IEEE division, so t/u/v round like the plain torch versions of
// ops/pallas_tile.py), the minimum t with the smallest slot on ties, and for
// the fused walk the interval-slab entry bounds of `_block_entries`, the
// (entry, id)-lexicographic visit order of `_next_cluster`, the closest
// termination e <= max(min(best_t, tmax)) with strict < on improvement, and
// the any-hit stop once every lane is occluded or dead.
//
// Triangles come as the JAX package's (C, 16, 128) float blocks: rows 0..8
// hold p0, e1, e2 (x, y, z) per slot, tri_k slots in use, the rest zero.
// A zero slot has det = 0 and never hits, so the slot loops stop at tri_k.
//
// What bounds them on the card. At the interior's 1,370 clusters of at most
// 32 triangles a round costs each ray 32 x ~45 f32 operations against 4.6 KB
// of block read once per tile, so the arithmetic is small; the walks are
// bound by their round count (the tile walks until its farthest lane's hit,
// and a 128- or 256-ray tile of secondary rays overlaps many clusters) and,
// for the round kernel, by the host loop that launches one round at a time.
//
// What the design does about it.
//   tile_round: one block per tile, one thread per ray (R = 256 threads).
//     The block reads its cluster's 9 x 128 floats from tri_block in place
//     (no gathered copy of the blocks per round) into shared memory; every
//     thread of a warp then reads the same slot at once, a broadcast. A tile
//     that does not run writes a miss and returns; a lane whose tmax_eff is
//     not above its tmin skips the slot loop.
//   tile_walk_*: one block per 128-ray tile, one thread per ray; tiles are
//     independent (Pallas' grouping of 8 tiles per program only changes
//     when a program stops). The block reduces its rays' origin, direction
//     and t-interval bounds, writes the tile's C entry bounds to shared
//     memory (4 bytes per cluster), and each round takes the next cluster
//     by a block-wide lexicographic reduction, stages the cluster's block in
//     shared memory and tests it. Occluded and dead lanes skip the slot
//     loop of the any-hit form.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr float kTiny = 1e-12f;   // |direction| floor of the slab test
constexpr int kSlots = 128;       // slot columns of a (16, 128) block
constexpr int kBlockRows = 16;
constexpr int kTriRows = 9;       // p0 | e1 | e2, x y z each
constexpr int kTile = 128;        // rays per tile of the fused walk
constexpr int kWarps = kTile / 32;
constexpr int kMaxRoundLanes = 256;  // rays per tile of the round kernel
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        size_t i) {
  Ray r;
  r.ox = __ldg(o + 3 * i);
  r.oy = __ldg(o + 3 * i + 1);
  r.oz = __ldg(o + 3 * i + 2);
  r.dx = __ldg(d + 3 * i);
  r.dy = __ldg(d + 3 * i + 1);
  r.dz = __ldg(d + 3 * i + 2);
  return r;
}

// Rows 0..8 of cluster `cid`'s block into shared memory, s[row * 128 + slot].
// The caller synchronises before any thread reads it.
__device__ __forceinline__ void stage_block(float* s,
                                            const float* __restrict__ blocks,
                                            int cid) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  for (int j = threadIdx.x; j < kTriRows * kSlots; j += blockDim.x)
    s[j] = __ldg(b + j);
}

// Moller-Trumbore of slot k in the operation order of pallas_tile._mt_vpu.
__device__ __forceinline__ bool mt_slot(const Ray& r, const float* s, int k,
                                        bool cull, float tmn, float tmx,
                                        float& t, float& u, float& v) {
  const float p0x = s[0 * kSlots + k], p0y = s[1 * kSlots + k],
              p0z = s[2 * kSlots + k];
  const float e1x = s[3 * kSlots + k], e1y = s[4 * kSlots + k],
              e1z = s[5 * kSlots + k];
  const float e2x = s[6 * kSlots + k], e2y = s[7 * kSlots + k],
              e2z = s[8 * kSlots + k];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = cull ? det > kEpsDet : fabsf(det) > kEpsDet;
  if (!det_ok) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > tmn) & (t < tmx);
}

// The closest hit of one ray among slots [0, tri_k) of a staged block:
// strict < over ascending slots gives the smallest slot on equal t.
__device__ __forceinline__ void closest_in_block(const Ray& r, const float* s,
                                                 int tri_k, bool cull,
                                                 float tmn, float tmx,
                                                 float& bt, float& bu,
                                                 float& bv, int& bs) {
  for (int k = 0; k < tri_k; ++k) {
    float t, u, v;
    if (mt_slot(r, s, k, cull, tmn, tmx, t, u, v) && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      bs = k;
    }
  }
}

__device__ __forceinline__ bool any_in_block(const Ray& r, const float* s,
                                             int tri_k, float tmn,
                                             float tmx) {
  for (int k = 0; k < tri_k; ++k) {
    float t, u, v;
    if (mt_slot(r, s, k, false, tmn, tmx, t, u, v)) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// K4: one round of the host-driven walk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxRoundLanes)
round_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin,
             const float* __restrict__ tmax_eff,
             const int* __restrict__ cid,
             const unsigned char* __restrict__ run,
             const float* __restrict__ blocks, int tri_k, int cull,
             float* __restrict__ out_t, float* __restrict__ out_u,
             float* __restrict__ out_v, float* __restrict__ out_dn,
             int* __restrict__ out_slot) {
  __shared__ float s[kTriRows * kSlots];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bs = kSlots;
  if (run[tile]) {  // uniform over the block
    stage_block(s, blocks, cid[tile]);
    __syncthreads();
    const float tmn = __ldg(tmin + i);
    const float tmx = __ldg(tmax_eff + i);
    if (tmx > tmn)
      closest_in_block(load_ray(o, d, i), s, tri_k, cull != 0, tmn, tmx, bt,
                       bu, bv, bs);
  }
  out_t[i] = bt;
  out_u[i] = bu;
  out_v[i] = bv;
  out_dn[i] = 1.0f;
  out_slot[i] = bs;
}

// ---------------------------------------------------------------------------
// K5: the fused walk, one block per 128-ray tile
// ---------------------------------------------------------------------------

// Block-wide reductions over the tile's 4 warps. Each ends with a barrier,
// so the scratch is free for the next one.
__device__ __forceinline__ float block_min(float x, float* red) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, m));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = fminf(x, red[w]);
  __syncthreads();
  return x;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  return -block_min(-x, red);
}

__device__ __forceinline__ void lex_min(float& e, int& c, float oe, int oc) {
  if (oe < e || (oe == e && oc < c)) {
    e = oe;
    c = oc;
  }
}

// The (entry, id)-lexicographic successor of (last_e, last_c) over the
// tile's entries: each thread scans a strided 128th, then the block reduces.
// (kBig, C) when no cluster follows.
__device__ __forceinline__ void next_cluster(const float* entries, int c_total,
                                             float last_e, int last_c,
                                             float* red_e, int* red_c,
                                             float& e_out, int& c_out) {
  float be = kBig;
  int bc = c_total;
  for (int c = threadIdx.x; c < c_total; c += kTile) {
    const float e = entries[c];
    if (e > last_e || (e == last_e && c > last_c)) lex_min(be, bc, e, c);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    lex_min(be, bc, __shfl_xor_sync(kFull, be, m),
            __shfl_xor_sync(kFull, bc, m));
  if ((threadIdx.x & 31) == 0) {
    red_e[threadIdx.x >> 5] = be;
    red_c[threadIdx.x >> 5] = bc;
  }
  __syncthreads();
  be = red_e[0];
  bc = red_c[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) lex_min(be, bc, red_e[w], red_c[w]);
  __syncthreads();
  e_out = be;
  c_out = bc;
}

// The tile's conservative entry bound per cluster (tile_trace.tile_entries
// for one tile, in its operation order), written to entries[0, C).
__device__ __forceinline__ void tile_entries(const Ray& r, float tmn,
                                             float tmx,
                                             const float* __restrict__ cmin,
                                             const float* __restrict__ cmax,
                                             int c_total, float* red,
                                             float* entries) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float dv[3] = {r.dx, r.dy, r.dz};
  float olo[3], ohi[3], il[3], ih[3];
  bool straddle[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    olo[a] = block_min(o[a], red);
    ohi[a] = block_max(o[a], red);
    const float dlo = block_min(dv[a], red);
    const float dhi = block_max(dv[a], red);
    straddle[a] = (dlo <= 0.0f) & (dhi >= 0.0f);
    const float safe_lo = fabsf(dlo) < kTiny ? (dlo < 0.0f ? -kTiny : kTiny)
                                             : dlo;
    const float safe_hi = fabsf(dhi) < kTiny ? (dhi < 0.0f ? -kTiny : kTiny)
                                             : dhi;
    il[a] = fminf(1.0f / safe_lo, 1.0f / safe_hi);
    ih[a] = fmaxf(1.0f / safe_lo, 1.0f / safe_hi);
  }
  const float tmin_lb = block_min(tmn, red);
  const float tmax_ub = block_max(tmx, red);
  for (int c = threadIdx.x; c < c_total; c += kTile) {
    float entry = 0.0f, exit_ = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float bmin = __ldg(cmin + 3 * c + a);
      const float bmax = __ldg(cmax + 3 * c + a);
      const float lo_ab = fminf(bmin - ohi[a], bmax - ohi[a]);
      const float hi_ab = fmaxf(bmin - olo[a], bmax - olo[a]);
      const float p1 = lo_ab * il[a];
      const float p2 = lo_ab * ih[a];
      const float p3 = hi_ab * il[a];
      const float p4 = hi_ab * ih[a];
      float ax_lo = fminf(fminf(p1, p2), fminf(p3, p4));
      float ax_hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
      if (straddle[a]) {
        ax_lo = -kBig;
        ax_hi = kBig;
      }
      entry = a == 0 ? ax_lo : fmaxf(entry, ax_lo);
      exit_ = a == 0 ? ax_hi : fminf(exit_, ax_hi);
    }
    const bool overlap = (entry <= exit_) & (exit_ >= tmin_lb) &
                         (entry <= tmax_ub);
    entries[c] = overlap ? entry : kBig;
  }
  __syncthreads();
}

template <bool kAny>
__global__ void __launch_bounds__(kTile)
walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ tmin, const float* __restrict__ tmax,
            const float* __restrict__ cmin, const float* __restrict__ cmax,
            const int* __restrict__ tri_begin,
            const float* __restrict__ blocks, int c_total, int tri_k,
            int cull, float* __restrict__ out_t, int* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v,
            int* __restrict__ out_occ) {
  extern __shared__ float smem[];
  float* blk = smem;                        // 9 x 128 floats
  float* entries = smem + kTriRows * kSlots;  // c_total floats
  __shared__ float red_e[kWarps];
  __shared__ int red_c[kWarps];

  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  tile_entries(r, tmn, tmx, cmin, cmax, c_total, red_e, entries);

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  bool occ = false;
  float last_e = -kBig;
  int last_c = -1;
  while (true) {
    float e;
    int cid;
    next_cluster(entries, c_total, last_e, last_c, red_e, red_c, e, cid);
    bool run;
    if (kAny) {
      run = !__syncthreads_and(occ || tmx < tmn) && e < kBig;
    } else {
      const float bound = block_max(fminf(best_t, tmx), red_e);
      run = e < kBig && e <= bound;
    }
    if (!run) break;  // uniform over the block: a tile never restarts
    stage_block(blk, blocks, cid);
    __syncthreads();
    if (kAny) {
      if (!occ && tmx > tmn) occ = any_in_block(r, blk, tri_k, tmn, tmx);
    } else {
      const float tmax_eff = fminf(best_t, tmx);
      if (tmax_eff > tmn) {
        float cb = kBig, cu = 0.0f, cv = 0.0f;
        int cs = kSlots;
        closest_in_block(r, blk, tri_k, cull != 0, tmn, tmax_eff, cb, cu, cv,
                         cs);
        if (cb < best_t) {
          best_t = cb;
          best_id = __ldg(tri_begin + cid) + cs;
          best_u = cu;
          best_v = cv;
        }
      }
    }
    __syncthreads();  // every thread is done with blk before the next stage
    last_e = e;
    last_c = cid;
  }
  if (kAny) {
    out_occ[i] = occ ? 1 : 0;
  } else {
    out_t[i] = best_t;
    out_tri[i] = best_id;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

template <bool kAny>
int launch_walk(const float* o, const float* d, const float* tmin,
                const float* tmax, const float* cmin, const float* cmax,
                const int* tri_begin, const float* blocks, int n, int c_total,
                int tri_k, int cull, float* out_t, int* out_tri, float* out_u,
                float* out_v, int* out_occ, void* stream) {
  const size_t smem = sizeof(float) * (kTriRows * kSlots + c_total);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<kAny>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walk_kernel<kAny><<<n / kTile, kTile, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_begin, blocks, c_total, tri_k, cull,
      out_t, out_tri, out_u, out_v, out_occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers to
// contiguous arrays; each launch goes on `stream` and the function returns
// the cudaGetLastError() after it (0 on success).

// K4. o/d (nt, r, 3), tmin/tmax_eff (nt, r) float32; cid (nt,) int32; run
// (nt,) bool; blocks (C, 16, 128) float32; 1 <= r <= 256, tri_k <= 128.
// Outputs (nt, r): t, u, v, dn float32 and slot int32.
extern "C" int tile_round(const float* o, const float* d, const float* tmin,
                          const float* tmax_eff, const int* cid,
                          const unsigned char* run, const float* blocks,
                          int nt, int r, int tri_k, int cull, float* out_t,
                          float* out_u, float* out_v, float* out_dn,
                          int* out_slot, void* stream) {
  round_kernel<<<nt, r, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax_eff, cid, run, blocks, tri_k, cull, out_t, out_u,
      out_v, out_dn, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// K5. o/d (n, 3), tmin/tmax (n,) float32 with n a multiple of 128; cmin/cmax
// (C, 3) float32; tri_begin (C,) int32; blocks (C, 16, 128) float32.
// Outputs (n,): t, tri, u, v (closest) or occ int32 (any).
extern "C" int tile_walk_closest(const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* cmin, const float* cmax,
                                 const int* tri_begin, const float* blocks,
                                 int n, int c_total, int tri_k, int cull,
                                 float* out_t, int* out_tri, float* out_u,
                                 float* out_v, void* stream) {
  return launch_walk<false>(o, d, tmin, tmax, cmin, cmax, tri_begin, blocks,
                            n, c_total, tri_k, cull, out_t, out_tri, out_u,
                            out_v, nullptr, stream);
}

extern "C" int tile_walk_any(const float* o, const float* d,
                             const float* tmin, const float* tmax,
                             const float* cmin, const float* cmax,
                             const float* blocks, int n, int c_total,
                             int tri_k, int* out_occ, void* stream) {
  return launch_walk<true>(o, d, tmin, tmax, cmin, cmax, nullptr, blocks, n,
                           c_total, tri_k, 0, nullptr, nullptr, nullptr,
                           nullptr, out_occ, stream);
}
