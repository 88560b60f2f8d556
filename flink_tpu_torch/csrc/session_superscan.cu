// Kernels K3 and K4: session windows on Hopper.
//
// Replace two XLA programs of the JAX package's session path, which has no
// Pallas kernel: flink_tpu/ops/superscan.py::session_ingest_scatter (the
// ingest of tpu_session_operator.py::_build_ingest and of the fused
// superspan) and ::session_gap_merge_scan with the gather, purge and
// packing around it (tpu_session_operator.py::_build_merge_scan, and the
// merge step of superscan.py::make_session_superscan). On the TPU, XLA
// compiles the merge's static loop over the slice columns into straight-
// line fused code; eager PyTorch would run it as 1,000-2,000 kernels a
// merge, whatever the key count.
//
// The rings are slice-major [S, K]: the fragment count, its min and max
// ms relative to the slice start (int32; empty cells hold 0, g and -1),
// and one ring per value field (float32 or int32).
//
// K3 lands records (kid, spos, rel, vals): a record with 0 <= kid < K and
// 0 <= spos < S adds 1 to the count of cell spos * K + kid, folds rel into
// its min and max, and combines its value into each field: float add;
// int32 add, min and max of the value cast as numpy casts (toward zero);
// float min and max, where a NaN value makes the cell NaN for good, as
// torch's and XLA's min and max do. A launch may cover several steps,
// whose ingests commute. Two routes, chosen by shape (the wrapper's
// ops/cuda_session.py::k3_plan):
//
//   k3_ingest_tiled   the host gives the launch's slice window, W ring
//                  positions from p0 (it may wrap past S). The keys are
//                  cut into runs of 32 and the runs dealt round-robin to NT
//                  key tiles (a power of two, the fewest whose cells fit a
//                  CTA's shared memory), so a step's block of hot keys
//                  spreads over every tile. Each tile's records are split
//                  over Q clusters of C = 4 CTAs, Q as many as the card
//                  holds in one wave. A CTA holds a private copy of its
//                  tile's cells (key run x window position: count, min, max
//                  and each field) in shared memory, reads its 1/(Q C) of the
//                  records once, every column in 16-byte loads, and lands
//                  its tile's records with shared-memory atomics (float
//                  min/max as order keys). After cluster.sync() CTA r folds
//                  the r-th share of the tile's cells over the C copies
//                  through distributed shared memory, in rank order. With
//                  Q = 1 it merges each cell that took a record into the
//                  ring with one plain read-modify-write; with Q > 1 it
//                  stores the cluster's partial, and k3_merge_parts, the
//                  next launch, merges each cell's Q partials in part order
//                  into the ring the same way. No device-memory atomics. A
//                  record outside the window (none, when the host's window
//                  is right) lands in the ring by device atomics; its cell
//                  is no tile's.
//   k3_ingest_atomic where the tiles would outgrow K3's tile limit (a
//                  long run or many keys), and for launches of few records
//                  (where the tiles' fixed cost is more than the atomics'),
//                  one grid-stride pass that lands each record by
//                  device-memory atomics, float min/max as native integer
//                  atomics on the float's bits, split by its sign.
//
// K4 (k4_merge_staged) runs one thread per key, a warp per 32-key tile,
// four tiles a CTA, and walks n ring columns in order (position pos[i], or
// (p0 + i) mod S; times in 64-bit ms relative to slice r0 + i). Each warp
// stages its tile's cells into shared memory with cp.async, CH columns a
// chunk (a column of 32 neighbouring keys is a 128-byte row of a ring):
// the count rows, then the other rings' rows of the columns where one of
// its keys holds a fragment, so a chunk costs two round trips and the
// empty cells' min, max and fields are never read. A thread then visits
// only its key's occupied columns (a bit mask), in order. A fragment joins
// the open session iff its min is at most g after the session's max, else
// it closes it; at the end the open session closes iff its max + g - 1 <=
// wm_rel. A closed session takes the key's next emission slot of the
// packed result and its cells (a run of consecutive columns the scan has
// passed) go back to the identities in the ring at once; a key with no
// slot left sets the overflow flag and its session stays. Float min and
// max fields propagate NaN. Without K4_MERGE the scan only reads which
// columns hold a fragment (a superspan's live bounds after its last ingest).
//
// Packed result (ops/superscan.py::packed_size): the int64 start and end
// ms, each [M, K]; the int32 count and each field's bits, each [M, K]; the
// slots each key has used [K]; then lo_rel, hi_rel, overflow, 0. K4 writes
// all of it: with K4_INIT every slot of its keys (zeros past the used
// ones) and the scalars; without it, the slots after those its earlier
// merges used (a superspan carries them across its merges). The CTAs
// reduce the live bounds and the overflow flag into a 4-int scratch the
// wrapper keeps per stream ({INT_MAX, INT_MIN, 0, 0} between launches);
// the last CTA to finish, by a ticket in the scratch, writes the scalars
// and resets the scratch. Live bounds: per watermark (K4_BOUNDS_PW), the
// first and last scanned column that still holds a fragment ((n, -1) if
// none); per superspan (K4_BOUNDS_SS), the first and last slice relative
// to base slice brel at position bpos ((0, -1) if none), as
// ops/superscan.py::session_live_bounds.
//
// What bounds them: bytes. K3 must read 16 bytes a record and move each
// touched ring cell once; the tiled route reads every record once per tile
// (NT is 1 or 2 for a step of the session stream, 4 for a run of 8), and
// writes and re-reads Q partials of each tile. K4 needs the count ring over
// the scanned columns and the other rings where the count is not 0 (what
// it stages), and writes the closed sessions' cells and every slot of the
// packed result. Both also pay a fixed few microseconds a launch (tile
// set-up and fold; K4's ticket), which the small launches of a session
// job feel most.

#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define K3_THREADS 256                 // atomic route
#define K3_TILED_THREADS 1024
#define K3_CLUSTER 4                   // CTAs per cluster of the tiled route
#define K3_MAX_PARTS 16                // clusters a tile's records split over, at most
#define K3_TILE_SMEM (200 * 1024)      // one tiled CTA's copy of its tile, at most
#define K4_WARPS 4                     // 32-key tiles (warps) per K4 CTA
#define K4_MAX_CH 64                   // staged columns a chunk, at most

#define K4_MERGE 1                     // gap-merge (else: read live columns only)
#define K4_INIT 2                      // write every slot and scalar; slots start at 0
#define K4_BOUNDS_PW 4                 // per-watermark live bounds
#define K4_BOUNDS_SS 8                 // superspan live bounds

// ---------------------------------------------------------------------------
// K3, atomic route
// ---------------------------------------------------------------------------

// Float min/max into a float cell with one native integer atomic: for a
// value with the sign bit clear, signed-integer order of the bits is float
// order over every cell; with it set, unsigned order reversed is.
__device__ __forceinline__ void atomic_min_f32(int* c, float v) {
  const int b = __float_as_int(v);
  if (b >= 0) atomicMin(c, b);
  else atomicMax((unsigned int*)c, (unsigned int)b);
}

__device__ __forceinline__ void atomic_max_f32(int* c, float v) {
  const int b = __float_as_int(v);
  if (b >= 0) atomicMax(c, b);
  else atomicMin((unsigned int*)c, (unsigned int)b);
}

__device__ __forceinline__ void land(int kind, int* c, float v) {
  switch (kind) {
    case ADD_F32: atomicAdd((float*)c, v); break;
    case ADD_I32: atomicAdd(c, __float2int_rz(v)); break;
    // NaN: 0xffffffff is below every cell in the min order, 0x7fffffff
    // above every cell in the max order, and both are NaN
    case MIN_F32: if (v == v) atomic_min_f32(c, v); else atomicExch(c, -1); break;
    case MAX_F32: if (v == v) atomic_max_f32(c, v); else atomicExch(c, 0x7fffffff); break;
    case MIN_I32: atomicMin(c, __float2int_rz(v)); break;
    case MAX_I32: atomicMax(c, __float2int_rz(v)); break;
  }
}

// One record into ring cell c by device-memory atomics.
__device__ __noinline__ void land_ring_far(int* cnt, int* mn, int* mx, const Fields& fl,
                                           long long c, int r, float v);

__device__ __forceinline__ void land_ring(int* cnt, int* mn, int* mx, const Fields& fl,
                                          long long c, int r, float v) {
  atomicAdd(cnt + c, 1);
  atomicMin(mn + c, r);
  atomicMax(mx + c, r);
  for (int a = 0; a < fl.n; ++a) land(fl.kind[a], (int*)fl.p[a] + c, v);
}

// land_ring out of line, for the tiled route's records outside its window
__device__ __noinline__ void land_ring_far(int* cnt, int* mn, int* mx, const Fields& fl,
                                           long long c, int r, float v) {
  land_ring(cnt, mn, mx, fl, c, r, v);
}

__global__ void __launch_bounds__(K3_THREADS)
k3_ingest_atomic(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
                 const int* __restrict__ kid, const int* __restrict__ spos,
                 const int* __restrict__ rel, const float* __restrict__ vals, long long n,
                 int K, int S) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k = __ldcs(kid + i), s = __ldcs(spos + i);
    if ((unsigned int)k >= (unsigned int)K || (unsigned int)s >= (unsigned int)S) continue;
    land_ring(cnt, mn, mx, fl, (long long)s * K + k, __ldcs(rel + i),
              fl.n ? __ldcs(vals + i) : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// K3, tiled route
// ---------------------------------------------------------------------------

// Float min/max cells of a tile hold order keys: the float's bits mapped
// so that unsigned order is float order, which shared-memory atomicMin/Max
// land natively. A NaN lands as key 0 in a min (below every key) and as
// 0xffffffff in a max (above every key); both decode to a NaN.
__device__ __forceinline__ unsigned int f32_key(float v) {
  const unsigned int b = __float_as_uint(v);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ int key_bits(unsigned int k) {
  return (int)(k & 0x80000000u ? k ^ 0x80000000u : ~k);
}

__device__ __forceinline__ bool keyed(int kind) { return kind == MIN_F32 || kind == MAX_F32; }

// The identity of a tile cell of array a (0 count, 1 min, 2 max, 3 + f
// field f).
__device__ __forceinline__ int tile_identity(int a, int kind) {
  if (a == 0) return 0;
  if (a == 1) return INT_MAX;
  if (a == 2) return INT_MIN;
  if (kind == MIN_F32) return (int)0xffffffffu;
  if (kind == MAX_F32) return 0;
  return partial_identity(kind);
}

__device__ __forceinline__ void land_tile(int kind, int* c, float v) {
  switch (kind) {
    case ADD_F32: atomicAdd((float*)c, v); break;
    case ADD_I32: atomicAdd(c, __float2int_rz(v)); break;
    case MIN_F32: atomicMin((unsigned int*)c, v == v ? f32_key(v) : 0u); break;
    case MAX_F32: atomicMax((unsigned int*)c, v == v ? f32_key(v) : 0xffffffffu); break;
    case MIN_I32: atomicMin(c, __float2int_rz(v)); break;
    case MAX_I32: atomicMax(c, __float2int_rz(v)); break;
  }
}

// Merge two tile cells of a field.
__device__ __forceinline__ int tile_merge(int kind, int a, int b) {
  if (kind == MIN_F32) return (int)min((unsigned int)a, (unsigned int)b);
  if (kind == MAX_F32) return (int)max((unsigned int)a, (unsigned int)b);
  return merge_bits(kind, a, b);
}

// A field merge into a ring cell: merge_bits, but a NaN fragment makes a
// float min or max NaN (merge_bits already keeps a NaN accumulator).
__device__ __forceinline__ int merge_field(int kind, int a, int b) {
  const float fb = __int_as_float(b);
  if ((kind == MIN_F32 || kind == MAX_F32) && fb != fb) return b;
  return merge_bits(kind, a, b);
}

// Merge tile cell i of tile `me` (count c, min m, max x, fields f[] as
// tile cells) into the ring with one plain read-modify-write.
__device__ __forceinline__ void merge_cell(int* cnt, int* mn, int* mx, const Fields& fl, int i,
                                           int c, int m, int x, const int* f, int p0, int W,
                                           int KT, int lg, int me, int K, int S) {
  const int d = i / KT, l = i - d * KT;
  const int key = (((l >> 5) << lg) + me) * 32 + (l & 31);
  int pos = p0 + d;
  if (pos >= S) pos -= S;
  const long long rc = (long long)pos * K + key;
  cnt[rc] += c;
  mn[rc] = min(mn[rc], m);
  mx[rc] = max(mx[rc], x);
  for (int a = 0; a < fl.n; ++a) {
    const int v = keyed(fl.kind[a]) ? key_bits((unsigned int)f[a]) : f[a];
    int* ring = (int*)fl.p[a] + rc;
    *ring = merge_field(fl.kind[a], *ring, v);
  }
}

// The second launch of a tiled K3 with Q > 1: one thread per tile cell
// merges the cell's Q partials, in part order, into the ring.
__global__ void __launch_bounds__(256)
k3_merge_parts(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
               const int* __restrict__ part, int Q, int NT, int W, int KT, int p0, int lg,
               int K, int S) {
  const int nf = fl.n, NA = 3 + nf, ct = W * KT;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)NT * ct) return;
  const int me = (int)(id / ct), i = (int)(id - (long long)me * ct);
  const int* p = part + (long long)me * Q * NA * ct + i;
  // every partial holds every cell (the identities where its records left
  // none), so all its loads go out at once
  int c = 0, m = INT_MAX, x = INT_MIN, f[MAX_FIELDS];
#pragma unroll
  for (int a = 0; a < MAX_FIELDS; ++a) f[a] = a < nf ? tile_identity(3 + a, fl.kind[a]) : 0;
#pragma unroll
  for (int z = 0; z < K3_MAX_PARTS; ++z) {
    if (z >= Q) break;
    const int* pq = p + (long long)z * NA * ct;
    c += __ldcs(pq);
    m = min(m, __ldcs(pq + ct));
    x = max(x, __ldcs(pq + 2 * ct));
#pragma unroll
    for (int a = 0; a < MAX_FIELDS; ++a)
      if (a < nf) f[a] = tile_merge(fl.kind[a], f[a], __ldcs(pq + (3 + a) * ct));
  }
  if (c == 0) return;                          // no record: the ring cell stays
  merge_cell(cnt, mn, mx, fl, i, c, m, x, f, p0, W, KT, lg, me, K, S);
}

// Tile `blockIdx.y` of NT = 2^lg holds the key runs blockIdx.y,
// blockIdx.y + NT, ...: local key q * 32 + (k & 31) for run k >> 5 =
// q * NT + tile, KT local keys in all. Its cells, [3 + nf][W][KT] ints:
// array a, window position d (ring position (p0 + d) mod S), local key.
//
// A tile's records are split over Q = gridDim.z clusters (part
// blockIdx.z) of C = K3_CLUSTER CTAs. A thread reads groups of 4 records,
// every column as one 16-byte load (the next group in flight while it lands
// this one; cached, as the other tiles' clusters read them too), and lands
// those of its tile: each CTA reads 1/(Q C) of the records once. With Q = 1
// the cluster merges its folded tile into the ring itself; with Q > 1 it
// writes it to part ([NT][Q][3 + nf][W x KT], plain stores) and
// k3_merge_parts, launched next, merges the Q partials of each cell, in
// part order, into the ring.
__global__ void __launch_bounds__(K3_TILED_THREADS, 1)
k3_ingest_tiled(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
                const int* __restrict__ kid, const int* __restrict__ spos,
                const int* __restrict__ rel, const float* __restrict__ vals, long long n,
                int K, int S, int p0, int W, int lg, int KT, int vec, int* __restrict__ part) {
  extern __shared__ int tile[];
  __shared__ int kind[MAX_FIELDS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int C = K3_CLUSTER;
  const int Q = (int)gridDim.z, pz = (int)blockIdx.z;
  const int me = blockIdx.y, mask = (1 << lg) - 1;
  const int nf = fl.n;
  const int ct = W * KT;                       // cells of one array
  if (threadIdx.x < nf) kind[threadIdx.x] = fl.kind[threadIdx.x];
  __syncthreads();
  for (int a = 0; a < 3 + nf; ++a) {
    const int id = tile_identity(a, a >= 3 ? kind[a - 3] : 0);
    for (int i = threadIdx.x; i < ct; i += blockDim.x) tile[a * ct + i] = id;
  }
  __syncthreads();

  // a group of 4 records into their tile cells (or, outside the window,
  // the ring): the count, min and max, then each field, its kind's switch
  // once a group
  auto land_group = [&](const int (&k)[4], const int (&s)[4], const int (&r)[4],
                        const float (&v)[4]) {
    int c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[e] = -1;
      if ((unsigned int)k[e] >= (unsigned int)K || ((k[e] >> 5) & mask) != me ||
          (unsigned int)s[e] >= (unsigned int)S)
        continue;
      int d = s[e] - p0;
      if (d < 0) d += S;
      if (d < W) c[e] = d * KT + ((k[e] >> 5) >> lg) * 32 + (k[e] & 31);
      else land_ring_far(cnt, mn, mx, fl, (long long)s[e] * K + k[e], r[e], v[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c[e] < 0) continue;
      atomicAdd(tile + c[e], 1);
      atomicMin(tile + ct + c[e], r[e]);
      atomicMax(tile + 2 * ct + c[e], r[e]);
    }
    for (int a = 0; a < nf; ++a) {
      int* h = tile + (3 + a) * ct;
      switch (kind[a]) {
#define K3_LAND(KIND)                                                 \
  case KIND:                                                          \
    _Pragma("unroll") for (int e = 0; e < 4; ++e)                     \
      if (c[e] >= 0) land_tile(KIND, h + c[e], v[e]);                 \
    break;
        K3_LAND(ADD_F32) K3_LAND(ADD_I32) K3_LAND(MIN_F32) K3_LAND(MAX_F32)
        K3_LAND(MIN_I32) K3_LAND(MAX_I32)
#undef K3_LAND
      }
    }
  };
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)Q * C * blockDim.x;
  struct Group {
    int4 k, s, r;
    float4 v;
  };
  auto load = [&](long long g) {
    Group x;
    if (vec && g < groups) {
      x.k = __ldg(reinterpret_cast<const int4*>(kid) + g);
      x.s = __ldg(reinterpret_cast<const int4*>(spos) + g);
      x.r = __ldg(reinterpret_cast<const int4*>(rel) + g);
      x.v = nf ? __ldg(reinterpret_cast<const float4*>(vals) + g) : make_float4(0, 0, 0, 0);
    } else {
      int t[4][4];
      float u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long j = 4 * g + e;
        const bool in = g < groups && j < n;
        t[0][e] = in ? __ldg(kid + j) : -1;
        t[1][e] = in ? __ldg(spos + j) : -1;
        t[2][e] = in ? __ldg(rel + j) : 0;
        u[e] = in && nf ? __ldg(vals + j) : 0.0f;
      }
      x.k = make_int4(t[0][0], t[0][1], t[0][2], t[0][3]);
      x.s = make_int4(t[1][0], t[1][1], t[1][2], t[1][3]);
      x.r = make_int4(t[2][0], t[2][1], t[2][2], t[2][3]);
      x.v = make_float4(u[0], u[1], u[2], u[3]);
    }
    return x;
  };
  long long g = ((long long)pz * C + rank) * blockDim.x + threadIdx.x;
  Group cur = load(g);
  for (; g < groups; g += stride) {
    const Group next = load(g + stride);       // in flight while this group lands
    land_group({cur.k.x, cur.k.y, cur.k.z, cur.k.w}, {cur.s.x, cur.s.y, cur.s.z, cur.s.w},
               {cur.r.x, cur.r.y, cur.r.z, cur.r.w}, {cur.v.x, cur.v.y, cur.v.z, cur.v.w});
    cur = next;
  }
  cluster.sync();                              // every copy is complete

  // CTA `rank` folds its share of the tile's cells over the C copies, in
  // rank order
  const int per = (ct + C - 1) / C;
  const int lo = rank * per, hi = min(ct, lo + per);
  const int NA = 3 + nf;
  // a cell's array a folded over the cluster's copies
  auto fold = [&](int a, int i) {
    int* cell = tile + a * ct + i;
    const int kd = a == 0 ? ADD_I32 : a == 1 ? MIN_I32 : a == 2 ? MAX_I32 : kind[a - 3];
    int f = *cluster.map_shared_rank(cell, 0);
#pragma unroll
    for (int q = 1; q < C; ++q)                // the copies' loads together
      f = tile_merge(kd, f, *cluster.map_shared_rank(cell, q));
    return f;
  };
  int* mine = part + (long long)(me * Q + pz) * NA * ct;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int c = fold(0, i);
    if (Q == 1 && c == 0) continue;            // no record: the ring cell stays
    int f[MAX_FIELDS];
    const int m = fold(1, i), x = fold(2, i);
    for (int a = 0; a < nf; ++a) f[a] = fold(3 + a, i);
    if (Q == 1) {
      merge_cell(cnt, mn, mx, fl, i, c, m, x, f, p0, W, KT, lg, me, K, S);
      continue;
    }
    mine[i] = c;                               // the cluster's partial of the cell
    mine[ct + i] = m;
    mine[2 * ct + i] = x;
    for (int a = 0; a < nf; ++a) mine[(3 + a) * ct + i] = f[a];
  }
  cluster.sync();                              // no CTA leaves while read
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// Scratch (int32[4]): the launch's lo and hi accumulators, its overflow
// flag and the ticket of CTAs done.
#define K4_SCRATCH_LO 0
#define K4_SCRATCH_HI 1
#define K4_SCRATCH_OVF 2
#define K4_SCRATCH_TICKET 3

// A ring of the session set: 0 count, 1 min, 2 max, 3 + f field f.
__device__ __forceinline__ const int* ring_of(int a, const int* cnt, const int* mn,
                                              const int* mx, const Fields& fl) {
  return a == 0 ? cnt : a == 1 ? mn : a == 2 ? mx : (const int*)fl.p[a - 3];
}

// K4_WARPS independent 32-key tiles a CTA, one a warp: a warp stages,
// merges and purges its own keys (__syncwarp), and the CTA reduces its
// warps' bounds for the scratch.
__global__ void __launch_bounds__(K4_WARPS * 32)
k4_merge_staged(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
                const int* __restrict__ pos, int p0, int n, int r0, int g, long long wm_rel,
                int M, int* __restrict__ packed, int flags, int bpos, int brel, int K, int S,
                int CH, int vec, int* __restrict__ scratch) {
  extern __shared__ int st[];                  // per warp [CH][3 + nf][32]
  __shared__ int s_lo[K4_WARPS], s_hi[K4_WARPS], s_ovf[K4_WARPS];
  const int nf = fl.n, NA = 3 + nf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = (blockIdx.x * K4_WARPS + warp) * 32, k = k0 + lane;
  const bool mine = k < K;
  const bool merge = flags & K4_MERGE, init = flags & K4_INIT;
  const long long MK = (long long)M * K;
  long long* times = (long long*)packed;       // start, end: [2, M, K]
  int* blocks = packed + 4 * MK;               // count, fields: [1 + nf, M, K]
  int* slots = blocks + (1 + nf) * MK;
  int* scal = slots + K;
  const int pm = mod_s(p0, S);
  auto column = [&](int i) {
    if (pos) return pos[i];
    if (i >= S) return mod_s(pm + i, S);
    const int c = pm + i;
    return c >= S ? c - S : c;
  };
  const int chunks = (n + CH - 1) / CH;
  int* wst = st + warp * CH * NA * 32;          // [CH][3 + nf][32]

  // a lane stages 16-byte group q of a row: of the count ring in column
  // sub + 4t, of the other rings in rows 1 + sub + 4t of a column
  const int q = lane & 7, sub = lane >> 3;
  const bool whole = vec && k0 + 4 * q + 3 < K;
  auto copy = [&](int* dst, const int* src) {
    if (whole) {
      cp_async16(dst, src);
    } else {
      for (int u = 0; u < 4; ++u)
        if (k0 + 4 * q + u < K) cp_async4(dst + u, src + u);
    }
  };
  // stage chunk c's columns: the count rows first; then, for the columns
  // where one of the warp's keys holds a fragment, the other rings' rows
  // (none without K4_MERGE). Returns the chunk's columns where this
  // thread's key holds a fragment, as bits.
  auto stage = [&](int c) -> unsigned long long {
    const int i0 = c * CH, nc = min(CH, n - i0);
    int* buf = wst + 4 * q;
    for (int col = sub; col < nc; col += 4)
      copy(buf + col * NA * 32, cnt + (long long)column(i0 + col) * K + k0 + 4 * q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    unsigned long long own = 0;
    if (mine)
      for (int col = 0; col < nc; ++col)
        own |= (unsigned long long)(wst[col * NA * 32 + lane] > 0) << col;
    if (!merge) return own;
    unsigned long long any = own;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) any |= __shfl_xor_sync(0xffffffffu, any, o);
    for (unsigned long long b = any; b; b &= b - 1) {
      const int col = __ffsll((long long)b) - 1;
      const long long src = (long long)column(i0 + col) * K + k0 + 4 * q;
      for (int a = 1 + sub; a < NA; a += 4)
        copy(buf + (col * NA + a) * 32, ring_of(a, cnt, mn, mx, fl) + src);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    return own;
  };

  int slot = mine && !init ? slots[k] : 0;
  bool open = false, ovf = false;
  long long cmin = 0, cmax = 0;
  int ccnt = 0, cstart = 0, clast = 0;
  int cf[MAX_FIELDS];
  int lo = INT_MAX, hi = INT_MIN;              // live bounds, in the mode's terms
  // a run of live columns [c0, c1] of the scan into the bounds
  auto live = [&](int c0, int c1) {
    if (flags & K4_BOUNDS_PW) {
      lo = min(lo, c0);
      hi = max(hi, c1);
    } else if (flags & K4_BOUNDS_SS) {
      const int j0 = mod_s(p0 + c0 - bpos, S), j1 = j0 + (c1 - c0);
      lo = min(lo, brel + (j1 < S ? j0 : 0));
      hi = max(hi, brel + (j1 < S ? j1 : S - 1));
    }
  };
  auto close = [&]() {
    if (slot >= M) {                           // no slot left: the caller replays
      ovf = true;
      live(cstart, clast);
      return;
    }
    const long long e = (long long)slot * K + k;
    times[e] = cmin;
    times[MK + e] = cmax;
    blocks[e] = ccnt;
#pragma unroll
    for (int a = 0; a < MAX_FIELDS; ++a)
      if (a < nf) blocks[(1 + a) * MK + e] = cf[a];
    ++slot;
    for (int j = cstart; j <= clast; ++j) {    // the session's cells, all fragments
      const long long c = (long long)column(j) * K + k;
      cnt[c] = 0;
      mn[c] = g;
      mx[c] = -1;
#pragma unroll
      for (int a = 0; a < MAX_FIELDS; ++a)
        if (a < nf) ((int*)fl.p[a])[c] = fl.ident[a];
    }
  };

  for (int c = 0; c < chunks; ++c) {
    const unsigned long long own = stage(c);
    const int i0 = c * CH;
    const int* buf = wst + lane;
    if (mine) {
      for (unsigned long long b = own; b; b &= b - 1) {   // its fragments, in order
        const int ci = __ffsll((long long)b) - 1;
        const int i = i0 + ci;
        const int* x = buf + ci * NA * 32;
        const int xc = x[0];
        if (!merge) {                          // live columns only
          live(i, i);
          continue;
        }
        const long long off = (long long)(r0 + i) * g;
        const long long fmn = x[32] + off, fmx = x[64] + off;
        const bool join = open && fmn - cmax <= g;
        if (open && !join) close();
        if (!join) {
          cmin = fmn;
          ccnt = 0;
          cstart = i;
#pragma unroll
          for (int a = 0; a < MAX_FIELDS; ++a) cf[a] = fl.ident[a];
        }
        open = true;
        cmax = fmx;
        ccnt += xc;
        clast = i;
#pragma unroll
        for (int a = 0; a < MAX_FIELDS; ++a)
          if (a < nf) cf[a] = merge_field(fl.kind[a], cf[a], x[(3 + a) * 32]);
      }
    }
    __syncwarp();                              // the buffer is free for chunk c + 1
  }
  if (mine) {
    if (open) {
      if (cmax + g - 1 <= wm_rel) close();
      else live(cstart, clast);
    }
    if (init) {                                // the slots no session took hold 0
      for (int s = slot; s < M; ++s) {
        const long long e = (long long)s * K + k;
        times[e] = 0;
        times[MK + e] = 0;
        for (int a = 0; a <= nf; ++a) blocks[a * MK + e] = 0;
      }
    }
    if (merge || init) slots[k] = slot;
  }

  // the CTA's bounds and flag into the scratch; the last CTA writes the
  // scalars and resets the scratch
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const bool any_ovf = __any_sync(0xffffffffu, ovf);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_ovf[warp] = any_ovf;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int f = 0;
  for (int w = 0; w < K4_WARPS; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
    f |= s_ovf[w];
  }
  if (hi != INT_MIN) {
    atomicMin(scratch + K4_SCRATCH_LO, lo);
    atomicMax(scratch + K4_SCRATCH_HI, hi);
  }
  if (f) atomicOr(scratch + K4_SCRATCH_OVF, 1);
  __threadfence();
  if (atomicAdd(scratch + K4_SCRATCH_TICKET, 1) != (int)gridDim.x - 1) return;
  __threadfence();
  lo = atomicExch(scratch + K4_SCRATCH_LO, INT_MAX);
  hi = atomicExch(scratch + K4_SCRATCH_HI, INT_MIN);
  f = atomicExch(scratch + K4_SCRATCH_OVF, 0);
  atomicExch(scratch + K4_SCRATCH_TICKET, 0);
  if (flags & K4_BOUNDS_PW) {
    scal[0] = hi == INT_MIN ? n : lo;
    scal[1] = hi == INT_MIN ? -1 : hi;
  } else if (flags & K4_BOUNDS_SS) {
    // as session_live_bounds: hi at least -1, lo 0 unless hi >= 0
    hi = max(hi, -1);
    scal[0] = hi >= 0 ? lo : 0;
    scal[1] = hi;
  } else if (init) {
    scal[0] = 0;
    scal[1] = -1;
  }
  scal[2] = init ? f : (scal[2] | f);
  if (init) scal[3] = 0;
}

// ---------------------------------------------------------------------------
// host entry points
// ---------------------------------------------------------------------------

static bool session_kinds(const int* kinds, int nf) {
  if (nf < 0 || nf > MAX_FIELDS) return false;
  for (int a = 0; a < nf; ++a)
    if (kinds[a] < ADD_F32 || kinds[a] > MAX_I32 || kinds[a] == MAX8) return false;
  return true;
}

static Fields make_fields(void* const* fields, const int* kinds, const int* idents, int nf) {
  Fields fl = {};
  fl.n = nf;
  for (int a = 0; a < nf; ++a) {
    fl.p[a] = fields[a];
    fl.kind[a] = kinds[a];
    fl.ident[a] = idents ? idents[a] : 0;
  }
  return fl;
}

static bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Ask for the largest shared-memory carveout, as the tiled ingest's big
// tiles take, so an SM need not change its L1/shared split between the
// launches of a superspan.
template <class Kernel>
static cudaError_t max_carveout(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Sets the session kernels' attributes on the current device (their
// dynamic shared memory at its largest, the largest carveout), which the
// launches below take as set: the wrapper calls it once per device, before
// its first launch there. Returns the clusters of the tiled ingest
// (K3_CLUSTER CTAs of K3_TILE_SMEM each) that the device holds at once, or
// a negative CUDA error code.
extern "C" int session_prepare() {
  cudaError_t e = cudaFuncSetAttribute(k3_ingest_tiled,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, K3_TILE_SMEM);
  if (e == cudaSuccess) e = max_carveout(k3_ingest_tiled);
  if (e == cudaSuccess) e = max_carveout(k3_merge_parts);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k4_merge_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K4_WARPS * K4_MAX_CH * (3 + MAX_FIELDS) * 32 * 4);
  if (e == cudaSuccess) e = max_carveout(k4_merge_staged);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K3_CLUSTER, 1, 1);
  cfg.blockDim = dim3(K3_TILED_THREADS);
  cfg.dynamicSmemBytes = K3_TILE_SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K3_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, k3_ingest_tiled, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Ingest n records. NT == 0: the atomic route, at most 8 CTAs an SM
// (sms: the card's SM count, which the wrapper queries once). NT > 0: the
// tiled route over the window of W ring positions from p0, NT (a power of
// two) key tiles of KT local keys, each tile's records split over Q
// clusters of K3_CLUSTER CTAs (ops/cuda_session.py::k3_plan); with Q > 1,
// part: NT x Q x (3 + nf) x W x KT ints of scratch, and a second launch
// merges them. Returns a CUDA error code (0 = launched).
extern "C" int k3_session_ingest(int* cnt, int* mn, int* mx, void* const* fields,
                                 const int* kinds, int nf, const int* kid, const int* spos,
                                 const int* rel, const float* vals, long long n, int K, int S,
                                 int p0, int W, int NT, int Q, int KT, int* part, int sms,
                                 void* stream) {
  if (!session_kinds(kinds, nf) || K < 1 || S < 1 || n < 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Fields fl = make_fields(fields, kinds, nullptr, nf);
  cudaStream_t st = (cudaStream_t)stream;
  if (NT == 0) {
    const long long blocks = min((n + K3_THREADS - 1) / K3_THREADS, (long long)sms * 8);
    k3_ingest_atomic<<<(unsigned int)blocks, K3_THREADS, 0, st>>>(cnt, mn, mx, fl, kid, spos,
                                                                  rel, vals, n, K, S);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(3 + nf) * W * KT * 4;
  int lg = 0;
  while ((1 << lg) < NT) ++lg;
  if (p0 < 0 || p0 >= S || W < 1 || W > S || NT > 65535 || (1 << lg) != NT || KT < 32 ||
      KT % 32 || (long long)KT * NT < K || smem > K3_TILE_SMEM || Q < 1 || Q > K3_MAX_PARTS ||
      (Q > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(kid) && aligned16(spos) && aligned16(rel) &&
                  (nf == 0 || aligned16(vals));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K3_CLUSTER, (unsigned int)NT, (unsigned int)Q);
  cfg.blockDim = dim3(K3_TILED_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K3_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k3_ingest_tiled, cnt, mn, mx, fl, kid, spos, rel,
                                     vals, n, K, S, p0, W, lg, KT, vec, part);
  if (e != cudaSuccess || Q == 1) return (int)e;
  const long long cells = (long long)NT * W * KT;
  k3_merge_parts<<<(unsigned int)((cells + 255) / 256), 256, 0, st>>>(cnt, mn, mx, fl, part, Q,
                                                                     NT, W, KT, p0, lg, K, S);
  return (int)cudaGetLastError();
}

// One K4 launch over n columns (pos: a device array of n distinct
// positions, or null for the ring from p0), flags K4_*, bounds base
// (bpos, brel) for K4_BOUNDS_SS, CH columns a staged chunk, scratch: the
// stream's int32[4] ({INT_MAX, INT_MIN, 0, 0} between launches). Returns a
// CUDA error code (0 = launched).
extern "C" int k4_session_merge(int* cnt, int* mn, int* mx, void* const* fields,
                                const int* kinds, const int* idents, int nf, const int* pos,
                                int p0, int n, int r0, int g, long long wm_rel, int M,
                                int* packed, int flags, int bpos, int brel, int K, int S,
                                int CH, int* scratch, void* stream) {
  if (!session_kinds(kinds, nf) || K < 1 || S < 1 || n < 0 || M < 1 || g < 1 || CH < 1 ||
      CH > K4_MAX_CH || (n > 0 && CH > n))
    return (int)cudaErrorInvalidValue;
  const Fields fl = make_fields(fields, kinds, idents, nf);
  bool vec = K % 4 == 0 && aligned16(cnt) && aligned16(mn) && aligned16(mx);
  for (int a = 0; a < nf; ++a) vec = vec && aligned16(fields[a]);
  const size_t smem = (size_t)K4_WARPS * CH * (3 + nf) * 32 * 4;
  const int grid = (K + 32 * K4_WARPS - 1) / (32 * K4_WARPS);
  k4_merge_staged<<<grid, 32 * K4_WARPS, smem, (cudaStream_t)stream>>>(
      cnt, mn, mx, fl, pos, p0, n, r0, g, wm_rel, M, packed, flags, bpos, brel, K, S, CH,
      (int)vec, scratch);
  return (int)cudaGetLastError();
}
