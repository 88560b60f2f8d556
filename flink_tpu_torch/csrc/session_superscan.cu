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
//   k3_session_ingest  one grid-stride pass over n records (a launch may
//                  cover several steps, whose ingests commute). A record
//                  with 0 <= kid < K and 0 <= spos < S lands in cell
//                  spos * K + kid by device-memory atomics: add 1 to the
//                  count, min and max of rel, and one per value field:
//                  float add; int32 add, min and max of the value cast as
//                  numpy casts (toward zero); float min and max as native
//                  integer atomics on the float's bits, split by its sign
//                  (the order-key idea of K1, without re-encoding the
//                  ring; no compare-and-swap loop). A NaN value makes the
//                  cell NaN for good, as torch's and XLA's min and max do:
//                  it writes the one NaN pattern no later value can
//                  replace in that order.
//   k4_session_merge  one thread per key walks n ring columns in order
//                  (position pos[i], or (p0 + i) mod S; times in 64-bit ms
//                  relative to slice r0 + i), the open session in registers and the
//                  next column's cells already loaded. A fragment joins
//                  the open session iff its min is at most g after the
//                  session's max, else it closes it; at the end the open
//                  session closes iff its max + g - 1 <= wm_rel. A closed
//                  session takes the key's next emission slot of the
//                  packed result and its cells (a run of consecutive
//                  columns the scan has passed) go back to the identities
//                  at once; a key with no slot left sets the overflow flag
//                  (atomicOr) and its session stays. With `bounds` (the
//                  per-watermark mode) the first and last column that
//                  still holds a fragment are reduced over the block and
//                  folded into the result by atomicMin/atomicMax. Float
//                  min and max fields propagate NaN.
//
// Packed result (ops/superscan.py::packed_size): the int64 start and end
// ms, each [M, K]; the int32 count and each field's bits, each [M, K]; the
// slots each key has used [K] (read and written back, so a superspan
// carries them across its merges); then lo_rel, hi_rel, overflow, 0. The
// wrapper zero-fills it.
//
// What bounds them: bytes. K3 reads 16 bytes a record and its atomics land
// in the ring (16 MiB at the bench geometry, inside the 50 MB L2); records
// of one step crowd a few thousand cells, so same-address atomics
// serialise in L2. K4 reads every ring at each scanned column (the function
// needs the count there and the other rings only where the count is not 0)
// and writes the closed sessions' cells and slots; its loads are coalesced
// (neighbouring keys, one column), its packed stores scattered over the
// slots.

#include <climits>

#include "common.cuh"

#define K3_THREADS 256
#define K4_THREADS 128

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

// A field merge in the scan: merge_bits, but a NaN fragment makes a float
// min or max NaN (merge_bits already keeps a NaN accumulator).
__device__ __forceinline__ int merge_field(int kind, int a, int b) {
  const float fb = __int_as_float(b);
  if ((kind == MIN_F32 || kind == MAX_F32) && fb != fb) return b;
  return merge_bits(kind, a, b);
}

__global__ void __launch_bounds__(K3_THREADS)
k3_session_ingest(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
                  const int* __restrict__ kid, const int* __restrict__ spos,
                  const int* __restrict__ rel, const float* __restrict__ vals, long long n,
                  int K, int S) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k = __ldcs(kid + i), s = __ldcs(spos + i);
    if ((unsigned int)k >= (unsigned int)K || (unsigned int)s >= (unsigned int)S) continue;
    const long long c = (long long)s * K + k;
    const int r = __ldcs(rel + i);
    atomicAdd(cnt + c, 1);
    atomicMin(mn + c, r);
    atomicMax(mx + c, r);
    if (fl.n) {
      const float v = __ldcs(vals + i);
      for (int a = 0; a < fl.n; ++a) land(fl.kind[a], (int*)fl.p[a] + c, v);
    }
  }
}

__global__ void __launch_bounds__(K4_THREADS)
k4_session_merge(int* __restrict__ cnt, int* __restrict__ mn, int* __restrict__ mx, Fields fl,
                 const int* __restrict__ pos, int p0, int n, int r0, int g, long long wm_rel,
                 int M, int* __restrict__ packed, int bounds, int K, int S) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int nf = fl.n;
  const long long MK = (long long)M * K;
  long long* times = (long long*)packed;       // start, end: [2, M, K]
  int* blocks = packed + 4 * MK;               // count, fields: [1 + nf, M, K]
  int* slots = blocks + (1 + nf) * MK;
  int* scal = slots + K;
  int lo = INT_MAX, hi = -1;                   // columns of sessions left open
  auto column = [&](int i) { return pos ? pos[i] : mod_s(p0 + i, S); };

  if (k < K) {
    int slot = slots[k];
    bool open = false;
    long long cmin = 0, cmax = 0;
    int ccnt = 0, cstart = 0, clast = 0;
    int cf[MAX_FIELDS];
    int nx[3 + MAX_FIELDS] = {};               // the next column's cells
    bool nuse = false;
    auto fetch = [&](int i) {
      nuse = i < n;
      if (!nuse) return;
      const long long c = (long long)column(i) * K + k;
      nx[0] = cnt[c];
      nx[1] = mn[c];
      nx[2] = mx[c];
#pragma unroll
      for (int a = 0; a < MAX_FIELDS; ++a)
        if (a < nf) nx[3 + a] = ((const int*)fl.p[a])[c];
    };
    auto close = [&]() {
      if (slot >= M) {                         // no slot left: the caller replays
        atomicOr(scal + 2, 1);
        lo = min(lo, cstart);
        hi = max(hi, clast);
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
      for (int j = cstart; j <= clast; ++j) {  // the session's cells, all fragments
        const long long c = (long long)column(j) * K + k;
        cnt[c] = 0;
        mn[c] = g;
        mx[c] = -1;
#pragma unroll
        for (int a = 0; a < MAX_FIELDS; ++a)
          if (a < nf) ((int*)fl.p[a])[c] = fl.ident[a];
      }
    };

    fetch(0);
    for (int i = 0; i < n; ++i) {
      const bool use = nuse;
      int x[3 + MAX_FIELDS];
#pragma unroll
      for (int a = 0; a < 3 + MAX_FIELDS; ++a) x[a] = nx[a];
      fetch(i + 1);                            // in flight while this column merges
      if (!use || x[0] <= 0) continue;
      const long long off = (long long)(r0 + i) * g;
      const long long fmn = x[1] + off, fmx = x[2] + off;
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
      ccnt += x[0];
      clast = i;
#pragma unroll
      for (int a = 0; a < MAX_FIELDS; ++a)
        if (a < nf) cf[a] = merge_field(fl.kind[a], cf[a], x[3 + a]);
    }
    if (open) {
      if (cmax + g - 1 <= wm_rel) {
        close();
      } else {
        lo = min(lo, cstart);
        hi = max(hi, clast);
      }
    }
    slots[k] = slot;
  }

  if (!bounds) return;
  __shared__ int s_lo[K4_THREADS / 32], s_hi[K4_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x / 32] = lo;
    s_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < K4_THREADS / 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    if (hi >= 0) {
      atomicMin(scal, lo);
      atomicMax(scal + 1, hi);
    }
  }
}

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

// Ingest n records. Returns a CUDA error code (0 = launched).
extern "C" int k3_session_ingest(int* cnt, int* mn, int* mx, void* const* fields,
                                 const int* kinds, int nf, const int* kid, const int* spos,
                                 const int* rel, const float* vals, long long n, int K, int S,
                                 void* stream) {
  if (!session_kinds(kinds, nf) || K < 1 || S < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = min((n + K3_THREADS - 1) / K3_THREADS, (long long)sms * 8);
  k3_session_ingest<<<(unsigned int)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      cnt, mn, mx, make_fields(fields, kinds, nullptr, nf), kid, spos, rel, vals, n, K, S);
  return (int)cudaGetLastError();
}

// One gap-merge over n columns (pos: a device array of n distinct
// positions, or null for the full ring from p0). Returns a CUDA error code
// (0 = launched).
extern "C" int k4_session_merge(int* cnt, int* mn, int* mx, void* const* fields,
                                const int* kinds, const int* idents, int nf, const int* pos,
                                int p0, int n, int r0, int g, long long wm_rel, int M,
                                int* packed, int bounds, int K, int S, void* stream) {
  if (!session_kinds(kinds, nf) || K < 1 || S < 1 || n < 0 || M < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (K + K4_THREADS - 1) / K4_THREADS;
  k4_session_merge<<<grid, K4_THREADS, 0, (cudaStream_t)stream>>>(
      cnt, mn, mx, make_fields(fields, kinds, idents, nf), pos, p0, n, r0, g, wm_rel, M, packed,
      bounds, K, S);
  return (int)cudaGetLastError();
}
