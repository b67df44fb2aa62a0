// List-walk ray traversal for Hopper (sm_90a): one ray tile per block over
// its presorted near-to-far cluster list, closest hit and any hit, each in a
// resident and a streamed form.
//
// Replaces the Pallas TPU kernels of spcbpt_tpu/ops/pallas_walk.py:
//   list_walk_closest         <- _closest_kernel_vmem (pallas_walk.py:156)
//   list_walk_closest_stream  <- _closest_kernel      (pallas_walk.py:97)
//   list_walk_any             <- _any_kernel_vmem     (pallas_walk.py:207)
//   list_walk_any_stream      <- _any_kernel          (pallas_walk.py:235)
// and computes what they compute, lane for lane: Moller-Trumbore of every
// lane against all 128 slots of the cluster's block in the operation order
// of `_mt_rows` (built with --fmad=false and IEEE division, so t/u/v round
// like the plain torch versions of ops/pallas_walk.py), the minimum t with
// the smallest slot on ties and improvement on strict <, and the stop rules:
// closest stops when the next entry exceeds the tile's largest
// min(best_t, tmax) (unless prune is off), any hit when it exceeds the
// largest tmax of the tile's unoccluded lanes (-1e30 for an occluded lane).
//
// The walk list (count, ids, bases, entries) is built outside the kernel
// (ops/pallas_walk._prepare) and read uniformly by the block. Triangles come
// as the JAX package's (C, 16, 128) float blocks: rows 0..8 hold p0, e1, e2
// (x, y, z) per slot, the rest zero; a zero slot has det = 0 and never hits.
//
// What bounds them on the card. A round costs each lane 128 slot tests of
// ~45 f32 operations against a 4.6 KB block read once per tile, so on paper
// the walks are bound by arithmetic (of which the zero slots of a K=32 set
// are three quarters) and the bytes are small. In practice the chain of
// rounds bounds them: a tile walks its list in series, each round ending in
// a block-wide max reduction and barriers, and a tile of incoherent rays
// overlaps many clusters.
//
// What the design does about it, kept simple (a later PR makes it fast):
//   * one block per tile (128 or 256 threads), one thread per lane, blocks
//     independent, as Pallas' grid programs are;
//   * resident forms read the cluster's rows 0..8 from global memory, where
//     the whole table (1,370 x 8 KB or 368 x 8 KB at the interior) sits in
//     the 50 MB L2; every thread of a warp reads the same slot, a broadcast;
//   * streamed forms stage rows 0..8 through two shared-memory buffers with
//     cp.async: round r+1's block is in flight while round r computes (the
//     2-deep DMA of pallas_walk.py:114-124), and the last copy is drained
//     when the walk stops early;
//   * a lane whose interval is empty (tmax_eff <= tmin, or occluded) skips
//     the slot loop; it cannot hit.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kSlots = 128;       // slot columns of a (16, 128) block
constexpr int kBlockRows = 16;
constexpr int kTriRows = 9;       // p0 | e1 | e2, x y z each
constexpr int kStage = kTriRows * kSlots;  // floats staged per round
constexpr int kMaxTile = 256;     // rays per tile = threads per block
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

// Moller-Trumbore of slot k of a block (rows at stride 128, in global or
// shared memory) in the operation order of pallas_walk._mt_rows.
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

// Block-wide max over the tile's warps; ends with a barrier, so the scratch
// is free for the next call.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

// The streamed forms' staging: rows 0..8 of cluster `cid` (4,608 bytes) into
// a shared buffer with 16-byte cp.async copies, one commit group per stage.
__device__ __forceinline__ void stage_async(float* buf,
                                            const float* __restrict__ blocks,
                                            int cid) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  for (int j = threadIdx.x; j < kStage / 4; j += blockDim.x) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(buf + 4 * j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(b + 4 * j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The block of round r: in place (resident) or staged (streamed; round r+1
// is issued before round r is waited for).
template <bool kStream>
__device__ __forceinline__ const float* round_block(
    const float* __restrict__ blocks, const int* __restrict__ ids, int r,
    int n, float (*buf)[kStage]) {
  if (!kStream)
    return blocks + static_cast<size_t>(__ldg(ids + r)) * kBlockRows * kSlots;
  if (r + 1 < n) {
    stage_async(buf[(r + 1) & 1], blocks, __ldg(ids + r + 1));
    wait_all_but_newest();
  } else {
    wait_all();
  }
  __syncthreads();  // every thread's copies of round r are visible
  return buf[r & 1];
}

template <bool kStream>
__global__ void __launch_bounds__(kMaxTile)
closest_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
               const int* __restrict__ bases,
               const float* __restrict__ entries, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tmin,
               const float* __restrict__ tmax,
               const float* __restrict__ blocks, int c_total, int cull,
               int prune, float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ __align__(16) float buf[kStream ? 2 : 1][kStage];
  __shared__ float red[kMaxTile / 32];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * c_total;
  const int n = __ldg(counts + tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (kStream && n > 0) stage_async(buf[0], blocks, __ldg(ids + row));
  bool go = n > 0;
  int r = 0;
  while (go) {  // uniform over the block
    const float* s = round_block<kStream>(blocks, ids + row, r, n, buf);
    const float tmax_eff = fminf(best_t, tmx);
    if (tmax_eff > tmn) {
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      for (int k = 0; k < kSlots; ++k) {
        float t, u, v;
        if (mt_slot(ray, s, k, cull != 0, tmn, tmax_eff, t, u, v) && t < cb) {
          cb = t;
          cu = u;
          cv = v;
          cs = k;
        }
      }
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(bases + row + r) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
    ++r;
    if (kStream || prune) {
      const float bound = block_max(fminf(best_t, tmx), red);
      go = r < n && __ldg(entries + row + r) <= bound;
    } else {
      go = r < n;
    }
    // every thread is done with this round's buffer before it is refilled
    if (kStream) __syncthreads();
  }
  if (kStream) wait_all();  // drain the prefetch of a walk that stopped early
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

template <bool kStream>
__global__ void __launch_bounds__(kMaxTile)
any_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
           const float* __restrict__ entries, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tmin,
           const float* __restrict__ tmax, const float* __restrict__ blocks,
           int c_total, int* __restrict__ out_occ) {
  __shared__ __align__(16) float buf[kStream ? 2 : 1][kStage];
  __shared__ float red[kMaxTile / 32];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * c_total;
  const int n = __ldg(counts + tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  bool occ = false;
  if (kStream && n > 0) stage_async(buf[0], blocks, __ldg(ids + row));
  bool go = n > 0;
  int r = 0;
  while (go) {  // uniform over the block
    const float* s = round_block<kStream>(blocks, ids + row, r, n, buf);
    if (!occ && tmx > tmn) {
      for (int k = 0; k < kSlots && !occ; ++k) {
        float t, u, v;
        // a hit at t >= 1e30 is a miss in the plain version's t table
        occ = mt_slot(ray, s, k, false, tmn, tmx, t, u, v) && t < kBig;
      }
    }
    ++r;
    const float open_max = block_max(occ ? -kBig : tmx, red);
    go = r < n && __ldg(entries + row + r) <= open_max;
    if (kStream) __syncthreads();
  }
  if (kStream) wait_all();
  out_occ[i] = occ ? 1 : 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers to
// contiguous arrays; each launch goes on `stream` and the function returns
// the cudaGetLastError() after it (0 on success).
//
// counts (nt,) int32; ids, bases (nt, c) int32; entries (nt, c) float32,
// each row sorted near to far; o/d (nt * tile, 3), tmin/tmax (nt * tile,)
// float32; blocks (c, 16, 128) float32; tile a multiple of 32 up to 256.
// Outputs (nt * tile,): t, tri, u, v (closest) or occ int32 (any).

extern "C" int list_walk_closest(const int* counts, const int* ids,
                                 const int* bases, const float* entries,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* blocks, int nt, int tile,
                                 int c_total, int cull, int prune,
                                 float* out_t, int* out_tri, float* out_u,
                                 float* out_v, void* stream) {
  closest_kernel<false><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, c_total, cull,
      prune, out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int list_walk_closest_stream(const int* counts, const int* ids,
                                        const int* bases,
                                        const float* entries, const float* o,
                                        const float* d, const float* tmin,
                                        const float* tmax,
                                        const float* blocks, int nt, int tile,
                                        int c_total, int cull, float* out_t,
                                        int* out_tri, float* out_u,
                                        float* out_v, void* stream) {
  closest_kernel<true><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, c_total, cull, 1,
      out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int list_walk_any(const int* counts, const int* ids,
                             const float* entries, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, const float* blocks, int nt,
                             int tile, int c_total, int* out_occ,
                             void* stream) {
  any_kernel<false><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, entries, o, d, tmin, tmax, blocks, c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int list_walk_any_stream(const int* counts, const int* ids,
                                    const float* entries, const float* o,
                                    const float* d, const float* tmin,
                                    const float* tmax, const float* blocks,
                                    int nt, int tile, int c_total,
                                    int* out_occ, void* stream) {
  any_kernel<true><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, entries, o, d, tmin, tmax, blocks, c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}
