// Kernel K2: the global-window T-step superscan dispatch on Hopper.
//
// Replaces flink_tpu/ops/pallas_superscan.py::build_global_superscan, the
// TPU kernel that ran the key-folded schedule (Nexmark Q7's per-window
// global max) as one pallas_call with the [S] slice ring in one VMEM row
// and NSB masked whole-chunk folds per chunk.
//
// As in K1 (superscan.cu), the records of all T steps reduce at once into
// step partials, and a second pass walks the steps in order. Two launches
// per dispatch:
//
//   k2_ingest_all  grid of (step, chunk) blocks over all T*B records. Each
//                  block folds a contiguous run of one step (up to 32K
//                  records) into NSB lanes per field in registers, then
//                  across the block with warp shuffles and shared memory in
//                  a fixed order, and stores its [1 + nf, NSB] partial with
//                  plain stores: no atomics. The fold is instantiated per
//                  NSB and per field kind, so no unused lane is reduced and
//                  no kind is switched on inside the record loop. The first
//                  block of each step also writes the step's descriptor.
//   k2_scan        one CTA. Warp 0 walks the steps with the [S] ring in
//                  its lanes' registers (lane s holds ring lane s of every
//                  array): a lane merges what the step adds to it, a fire
//                  folds its window with a warp-shuffle tree, a lane resets
//                  its purged lane. Meanwhile the other warps stage the next
//                  chunk of 16 steps in shared memory: each thread makes
//                  what one (step, array, lane) takes by folding the block
//                  partials of the lane's rels in block order, and the
//                  chunk's step descriptors (common.cuh) are copied in.
//                  The ring and the out rows are written once.
//
// The fixed fold order makes float sums the same from run to run.
// What bounds it: bytes. Each record's idx and value are read once; the
// ring, the out rows and the partials are a few hundred kilobytes at most.

#include "common.cuh"

#define MAX_NSB 8
#define MAX_S 32
#define MAX_R 128
#define K2_MAX_FIRES 16               // fire slots a step (one lane each)
#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_UNROLL 8                   // records in flight per thread
#define K2_SCAN_THREADS 512
#define K2_STEPS 16                   // steps per scan chunk
#define K2_FOLD_BATCH 8               // block partials a staging thread loads at once
#define COUNT_ONLY -1                 // fold_run without a value field

template <int KIND>
__device__ __forceinline__ int value_bits(float v) {
  return (KIND == ADD_F32 || KIND == MIN_F32 || KIND == MAX_F32)
             ? __float_as_int(v)
             : __float2int_rz(v);
}

// Fold the block's per-thread lanes in a fixed order into out[0, NSB).
template <int NSB>
__device__ __forceinline__ void block_fold(int kind, const int (&acc)[NSB],
                                           int* out, int (*red)[MAX_NSB]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NSB; ++s) {
    int x = acc[s];
    for (int o = 16; o > 0; o >>= 1)
      x = merge_bits(kind, x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x < NSB) {
    int x = red[0][threadIdx.x];
    for (int w = 1; w < K2_WARPS; ++w) x = merge_bits(kind, x, red[w][threadIdx.x]);
    out[threadIdx.x] = x;
  }
  __syncthreads();                        // red is free again
}

// Fold records [0, n) of ip/vp into the count lanes (COUNT) and the lanes
// of one field of kind KIND (unless COUNT_ONLY).
template <int NSB, int KIND, bool COUNT>
__device__ void fold_run(const int* __restrict__ ip, const float* __restrict__ vp,
                         int n, int* cnt_out, int* fld_out,
                         int (*red)[MAX_NSB]) {
  int cnt[NSB], acc[NSB];
#pragma unroll
  for (int s = 0; s < NSB; ++s) {
    cnt[s] = 0;
    acc[s] = partial_identity(KIND);
  }
  for (int j0 = threadIdx.x; j0 < n; j0 += K2_THREADS * K2_UNROLL) {
    int ii[K2_UNROLL], vb[K2_UNROLL];
#pragma unroll
    for (int u = 0; u < K2_UNROLL; ++u) {
      const int j = j0 + u * K2_THREADS;
      ii[u] = j < n ? __ldcs(ip + j) : -1;
      if (KIND != COUNT_ONLY) vb[u] = j < n ? value_bits<KIND>(__ldcs(vp + j)) : 0;
    }
#pragma unroll
    for (int u = 0; u < K2_UNROLL; ++u) {
      if (ii[u] < 0) continue;            // dropped records count nowhere
      const int sr = ii[u] % NSB;
#pragma unroll
      for (int s = 0; s < NSB; ++s) {
        if (s != sr) continue;
        if (COUNT) cnt[s] += 1;
        if (KIND != COUNT_ONLY) acc[s] = merge_bits(KIND, acc[s], vb[u]);
      }
    }
  }
  if (COUNT) block_fold<NSB>(ADD_I32, cnt, cnt_out, red);
  if (KIND != COUNT_ONLY) block_fold<NSB>(KIND, acc, fld_out, red);
}

template <int NSB, bool COUNT>
__device__ void fold_field(int kind, const int* ip, const float* vp, int n,
                           int* cnt_out, int* fld_out, int (*red)[MAX_NSB]) {
  switch (kind) {
    case ADD_F32: fold_run<NSB, ADD_F32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
    case ADD_I32: fold_run<NSB, ADD_I32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
    case MIN_F32: fold_run<NSB, MIN_F32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
    case MAX_F32: fold_run<NSB, MAX_F32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
    case MIN_I32: fold_run<NSB, MIN_I32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
    default:      fold_run<NSB, MAX_I32, COUNT>(ip, vp, n, cnt_out, fld_out, red); break;
  }
}

// Block (t, blk) folds records [blk * chunk, (blk + 1) * chunk) of step t
// into part[t][blk] = [1 + nf, NSB] (count lanes first); block (t, 0) also
// turns step t's plan into its descriptor for k2_scan.
template <int NSB>
__global__ void __launch_bounds__(K2_THREADS)
k2_ingest_all(Fields fl, const int* __restrict__ idx,
              const float* __restrict__ vals, int* __restrict__ part,
              StepDesc* __restrict__ descs, Plan plan, int S, int F, int R, int B,
              int nblk, int chunk) {
  __shared__ int red[K2_WARPS][MAX_NSB];
  const int t = blockIdx.x / nblk, blk = blockIdx.x - t * nblk;
  if (blk == 0 && threadIdx.x < 32) build_desc(descs[t], plan, t, S, F, R);
  const long long lo = (long long)t * B + (long long)blk * chunk;
  const int n = max(0, min(chunk, B - blk * chunk));
  const int* ip = idx + lo;
  const float* vp = fl.n ? vals + lo : nullptr;
  int* out = part + (long long)blockIdx.x * (1 + fl.n) * NSB;
  if (fl.n == 0) {
    fold_run<NSB, COUNT_ONLY, true>(ip, vp, n, out, nullptr, red);
    return;
  }
  fold_field<NSB, true>(fl.kind[0], ip, vp, n, out, out + NSB, red);
  for (int f = 1; f < fl.n; ++f)
    fold_field<NSB, false>(fl.kind[f], ip, vp, n, nullptr, out + (1 + f) * NSB, red);
}

__global__ void __launch_bounds__(K2_SCAN_THREADS)
k2_scan(int* __restrict__ count, Fields fl, const int* __restrict__ part,
        const StepDesc* __restrict__ descs, int* __restrict__ count_out, Fields outs,
        Spws spws, int S, int NSB, int F, int R, int T, int nblk) {
  // two chunk buffers: what each step adds to each ring lane, and the
  // steps' descriptors
  __shared__ int addv[2][K2_STEPS][1 + MAX_FIELDS][MAX_S];
  __shared__ StepDesc desc[2][K2_STEPS];
  __shared__ int rows[1 + MAX_FIELDS][MAX_R];
  __shared__ int kind_s[1 + MAX_FIELDS];
  const int na = 1 + fl.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int kind[1 + MAX_FIELDS], ident[1 + MAX_FIELDS];
#pragma unroll
  for (int a = 0; a <= MAX_FIELDS; ++a) {
    kind[a] = a ? fl.kind[a - 1] : (int)ADD_I32;
    ident[a] = a ? fl.ident[a - 1] : 0;
  }
  auto gring = [&](int a) { return a ? (int*)fl.p[a - 1] : count; };
  if (threadIdx.x == 0)
#pragma unroll
    for (int a = 0; a <= MAX_FIELDS; ++a) kind_s[a] = kind[a];
  __syncthreads();

  // stage chunk c with warps [w0, w0 + nw): each thread makes what one
  // (step, array, ring lane) takes, folding the block partials of the
  // lane's rels in block order (the identity where no rel lands), and the
  // threads copy the chunk's descriptors
  auto stage = [&](int c, int w0, int nw) {
    const int b = c & 1, c0 = c * K2_STEPS, tc = min(K2_STEPS, T - c0);
    const int per_step = na * NSB;
    for (int it = threadIdx.x - 32 * w0; it < tc * na * S; it += 32 * nw) {
      const int tl = it / (na * S), q = it - tl * na * S, a = q / S, lane_s = q - a * S;
      const int kd = kind_s[a];
      int x = partial_identity(kd);
      for (int rel = mod_s(lane_s - descs[c0 + tl].sm, S); rel < NSB; rel += S) {
        const int* src = part + (long long)(c0 + tl) * nblk * per_step + a * NSB + rel;
        for (int blk0 = 0; blk0 < nblk; blk0 += K2_FOLD_BATCH) {
          int v[K2_FOLD_BATCH];                // a batch of loads in flight
#pragma unroll
          for (int u = 0; u < K2_FOLD_BATCH; ++u)
            v[u] = blk0 + u < nblk ? src[(long long)(blk0 + u) * per_step] : partial_identity(kd);
#pragma unroll
          for (int u = 0; u < K2_FOLD_BATCH; ++u) x = merge_bits(kd, x, v[u]);
        }
      }
      addv[b][tl][a][lane_s] = x;
    }
    for (int x = threadIdx.x - 32 * w0; x < tc * (int)(sizeof(StepDesc) / 4); x += 32 * nw)
      reinterpret_cast<int*>(desc[b])[x] = reinterpret_cast<const int*>(descs + c0)[x];
  };

  for (int i = threadIdx.x; i < na * R; i += blockDim.x)
    rows[i / R][i % R] = ident[i / R];       // rows no fire writes: 0 / identity
  stage(0, 0, K2_SCAN_THREADS / 32);
  // warp 0 walks the steps with lane s holding ring lane s of every array
  int reg[1 + MAX_FIELDS];
#pragma unroll
  for (int a = 0; a <= MAX_FIELDS; ++a)
    reg[a] = warp == 0 && a < na && lane < S ? gring(a)[lane] : 0;
  const int w_lane = lane < F ? spws.w[lane] : 0;
  __syncthreads();

  const int chunks = (T + K2_STEPS - 1) / K2_STEPS;
  for (int c = 0; c < chunks; ++c) {
    if (warp) {                                // the other warps stage the next chunk
      if (c + 1 < chunks) stage(c + 1, 1, K2_SCAN_THREADS / 32 - 1);
    } else {
      const int b = c & 1, tc = min(K2_STEPS, T - c * K2_STEPS);
      for (int tl = 0; tl < tc; ++tl) {
        const StepDesc& d = desc[b][tl];
        if (lane < S)                          // ingest: what the step adds to the lane
#pragma unroll
          for (int a = 0; a <= MAX_FIELDS; ++a)
            if (a < na) reg[a] = merge_bits(kind[a], reg[a], addv[b][tl][a][lane]);
        for (unsigned int fires = d.fires[0]; fires; fires &= fires - 1) {
          const int f = __ffs(fires) - 1;      // fire: fold across the warp
          const int w = __shfl_sync(0xffffffffu, w_lane, f);
#pragma unroll
          for (int a = 0; a <= MAX_FIELDS; ++a) {
            if (a >= na) continue;
            const int x = warp_window_fold(kind[a], S, d.pos[f], w, reg[a]);
            if (lane == 0) rows[a][d.row[f]] = x;
          }
        }
        if ((d.dead[0] >> lane) & 1)          // purge
#pragma unroll
          for (int a = 0; a <= MAX_FIELDS; ++a)
            if (a < na) reg[a] = ident[a];
      }
    }
    __syncthreads();
  }

  if (warp == 0 && lane < S)
    for (int a = 0; a < na; ++a) gring(a)[lane] = reg[a];
  for (int i = threadIdx.x; i < na * R; i += blockDim.x) {
    const int a = i / R;
    (a ? (int*)outs.p[a - 1] : count_out)[i % R] = rows[a][i % R];
  }
}

#define K2_INGEST(N)                                                         \
  case N:                                                                    \
    k2_ingest_all<N><<<T * nblk, K2_THREADS, 0, st>>>(                       \
        fl, idx, vals, part, descs, pl, S, F, R, B, nblk, chunk);            \
    break;

// One dispatch of T steps: k2_ingest_all writes part ([T, nblk, 1 + nf,
// NSB] int32, allocated by the caller) and, after it, one StepDesc per
// step; k2_scan walks the steps. Returns a
// CUDA error code (0 = launched).
extern "C" int k2_global_superscan(
    int* count, void* const* fields, const int* kinds, const int* idents,
    int nf, const int* idx, const float* vals, const int* smin,
    const int* fpos, const int* fvalid, const int* frow, const int* purge,
    const int* spws, int F, int* count_out, void* const* outs, int S,
    int NSB, int R, int T, int B, int* part, int nblk, void* stream) {
  if (nf > MAX_FIELDS || F > K2_MAX_FIRES || NSB < 1 || NSB > MAX_NSB || S > MAX_S ||
      R > MAX_R || nblk < 1 || (long long)T * nblk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Fields fl = {}, ol = {};
  fl.n = ol.n = nf;
  for (int i = 0; i < nf; ++i) {
    fl.p[i] = fields[i];
    ol.p[i] = outs[i];
    fl.kind[i] = ol.kind[i] = kinds[i];
    fl.ident[i] = idents[i];
  }
  Spws sw = {};
  for (int f = 0; f < F; ++f) sw.w[f] = spws[f];
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk = (B + nblk - 1) / nblk;
  Plan pl = {smin, fpos, fvalid, frow, purge};
  StepDesc* descs = reinterpret_cast<StepDesc*>(part + (long long)T * nblk * (1 + nf) * NSB);
  switch (NSB) {
    K2_INGEST(1) K2_INGEST(2) K2_INGEST(3) K2_INGEST(4)
    K2_INGEST(5) K2_INGEST(6) K2_INGEST(7) K2_INGEST(8)
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k2_scan<<<1, K2_SCAN_THREADS, 0, st>>>(count, fl, part, descs, count_out, ol, sw, S,
                                         NSB, F, R, T, nblk);
  return (int)cudaGetLastError();
}
