// Kernel K1: the keyed T-step superscan dispatch on Hopper.
//
// Replaces flink_tpu/ops/pallas_superscan.py::build_superscan, the TPU
// kernel that ran ingest, fire and purge of all T steps in one pallas_call
// with the slice ring resident in VMEM and the ingest re-expressed as MXU
// one-hot histograms (a workaround for the TPU's slow scatter).
//
// Step t's ingest only combines into the ring columns (smin[t] + rel) % S,
// and step t's fire and purge need only the ring after that ingest. So the
// records of all T steps reduce at once, in parallel, into step partials
// P[t][k][rel] (one array per field and one for the count); a second pass
// then walks the steps in order, merging P[t] into the ring, folding the
// fire slots and purging. Counts and order statistics are order-free and
// int32 adds wrap the same; float adds change only their summation order,
// which atomics left free already. A group of steps is two launches:
//
//   k1_ingest_tiled  one thread-block cluster of C CTAs per step and key
//                  tile, C (1 to 8) chosen so the grid fills the SMs in one
//                  wave. Each CTA keeps a private histogram of the whole
//                  tile ([1 + nf] arrays of up to ~50K cells) in its shared
//                  memory and reads 1/C of the step's records (16-byte
//                  streaming loads, the next batch in flight), each landing
//                  with a shared-memory atomic (atomicAdd, atomicMin/Max;
//                  float min/max as order keys). After cluster.sync() CTA r folds
//                  the r-th share of the tile's cells over the C histograms
//                  through distributed shared memory, in rank order, and
//                  stores it to P with coalesced plain stores: no
//                  device-memory atomics and no remote atomics. Where a
//                  step's cells outgrow one CTA's shared memory the key
//                  range is tiled over several clusters, each re-reading
//                  the step's records.
//   k1_ingest_atomic  where that would take more than K1_MAX_TILES tiles
//                  (many keys), one cooperative grid sets P to the
//                  identities, synchronises, and lands each record with
//                  device-memory atomics, reading the records once.
//   k1_scan        one thread per key, 64 keys per CTA. The CTA keeps its
//                  [S, 64] ring tile of every array in shared memory for
//                  the whole group (in device memory where it does not
//                  fit): neighbouring keys in neighbouring banks, and a
//                  step touches the same columns for every key, so no
//                  access conflicts. The ingest kernel has already turned
//                  each step's plan into a descriptor (common.cuh: smin and
//                  fire positions mod S, the slots that write as a mask,
//                  purged columns as bits); the CTA stages 32 of them at a
//                  time, and each thread walks the steps with the next
//                  step's partials in flight: merge the NSB partials into
//                  their columns, fold each writing slot's window into its
//                  row, reset the dead columns. The ring is read and
//                  written once.
//
// Phase counters (observability.device.enabled, the JAX XLA superscan's
// int32[3] carry): with a `phase` buffer each dispatch adds [records with
// idx >= 0, fire slots, steps that purged] into it inside the launches it
// makes anyway. The ingest's first key tile counts its records (a block sum,
// one atomic per CTA); the warp that builds a step's descriptor counts its
// fire slots and purge; the partials entry counts the sum of its count
// partials in k1_scan.
//
// What bounds it: bytes. Every record's idx (and value) is read once (once
// per key tile); the
// ring, the out rows and the partials (6.3 MB at the YSB geometry) are
// small beside the records. The ops wrapper sizes the groups so the
// partials stay within a fixed scratch budget.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define K1_MAX_CLUSTER 8              // CTAs per cluster, at most
#define K1_MAX_TILES 16               // key tiles a step may take; beyond, atomics
#define K1_INGEST_THREADS 1024
#define K1_INGEST_SMEM (200 * 1024)   // one ingest CTA's histogram, at most
#define K1_SCAN_KEYS 64               // keys (threads) per scan CTA
#define K1_CHUNK 32                   // steps whose descriptors a scan CTA holds
#define K1_RING_SMEM (96 * 1024)      // a scan CTA's ring tile, at most
#define K1_STAGE_SMEM (64 * 1024)     // its staged partials, at most

// A cell's place in a histogram: the low 5 bits (the shared-memory bank)
// XOR the next 5. Cells kid * NSB + rel with few live rels would otherwise
// crowd a few banks; within each aligned run of 32 cells (ct is a multiple
// of 32) this is a bijection.
__device__ __forceinline__ unsigned int swizzle(unsigned int c) {
  return c ^ ((c >> 5) & 31u);
}

// An int add field's step partials hold float32 sums, as the JAX fused
// ingest's do (flink_tpu/ops/pallas_superscan.py, `wacc.astype(dt)`): its
// records land as float atomics into the partial's 32-bit word, and the
// partial is cast to int32 once, truncating toward zero, when the scan
// merges it into the ring. PART_I32_OF_F32 marks such a partial in the
// scan; the ingest lands and folds it as ADD_F32 (part_kind).
constexpr int PART_I32_OF_F32 = 7;

__device__ __forceinline__ int part_kind(int kind) { return kind == ADD_I32 ? ADD_F32 : kind; }

// The partials entry (k1_partials) takes partials its caller reduced: each
// cell holds its value's own bits (a float min/max as the float), merged
// into the ring as they are; an int add field's partial is its float32
// sum, PART_I32_OF_F32 as in the lane entry.
constexpr int PART_RAW = 8;

// A cell of K1's step partials. Float min/max are held as order keys: the
// float's bits mapped so that unsigned order is float order (-0.0 just
// below +0.0), which shared- and device-memory atomicMin/atomicMax land
// natively (a compare-and-swap loop per record was ~6x slower). Of equal
// values, -0.0 and +0.0, min keeps -0.0 and max +0.0, where a strict
// compare keeps whichever came first; NaN never lands, as no strict
// compare takes it. Every other kind holds its value's bits.
__device__ __forceinline__ bool keyed(int kind) { return kind == MIN_F32 || kind == MAX_F32; }

__device__ __forceinline__ unsigned int f32_key(float v) {
  const unsigned int b = __float_as_uint(v);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

// The identity of a step partial's cell.
__device__ __forceinline__ int part_identity(int kind) {
  return keyed(kind) ? (int)f32_key(__int_as_float(partial_identity(kind)))
                     : partial_identity(kind);
}

// Merge two step-partial cells.
__device__ __forceinline__ int part_merge(int kind, int a, int b) {
  if (kind == MIN_F32) return (int)min((unsigned int)a, (unsigned int)b);
  if (kind == MAX_F32) return (int)max((unsigned int)a, (unsigned int)b);
  return merge_bits(kind, a, b);
}

// A step-partial cell as the bits of its value (an int add field's float
// partial as its int32, cast once).
__device__ __forceinline__ int part_value(int kind, int p) {
  const unsigned int k = (unsigned int)p;
  if (kind == PART_I32_OF_F32) return __float2int_rz(__int_as_float(p));
  return keyed(kind) ? (int)(k & 0x80000000u ? k ^ 0x80000000u : ~k) : p;
}

// Records a thread loads per batch: four 16-byte groups for the count
// alone, two with value fields (each the faster of the two on the card,
// flink_tpu_torch/tools/k1_ab.py variants batch8 and batch16).
template <bool FIELDS>
__host__ __device__ constexpr int k1_batch() { return FIELDS ? 8 : 16; }

// Records [0, n) of one step, in batches: thread `first` of `stride`
// takes the 4-record groups first, first + stride, ..., k1_batch() / 4 of
// them a batch, and loads the next batch while land(r, v) lands this one. A
// group is one 16-byte load where vec (n % 4 == 0, both arrays 16-byte
// aligned), else four; a record past n reads as idx -1, which no cell
// takes. vals is read only with FIELDS.
template <bool FIELDS, class Land>
__device__ __forceinline__ void for_records(const int* __restrict__ ip,
                                            const float* __restrict__ vp, int n, bool vec,
                                            int first, int stride, Land land) {
  constexpr int NB = k1_batch<FIELDS>(), VEC = NB / 4;
  const int groups = (n + 3) / 4;
  auto load = [&](int (&r)[NB], float (&v)[NB], int g0) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int g = g0 + u * stride;
      if (vec && g < groups) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(ip) + g);
        r[4 * u] = x.x; r[4 * u + 1] = x.y; r[4 * u + 2] = x.z; r[4 * u + 3] = x.w;
        if (FIELDS) {
          const float4 y = __ldcs(reinterpret_cast<const float4*>(vp) + g);
          v[4 * u] = y.x; v[4 * u + 1] = y.y; v[4 * u + 2] = y.z; v[4 * u + 3] = y.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * g + e;
          const bool in = g < groups && j < n;
          r[4 * u + e] = in ? __ldcs(ip + j) : -1;
          v[4 * u + e] = FIELDS && in ? __ldcs(vp + j) : 0.0f;
        }
      }
    }
  };
  int r[NB], rn[NB];
  float v[NB], vn[NB];
  load(r, v, first);
  for (int g0 = first; g0 < groups; g0 += VEC * stride) {
    load(rn, vn, g0 + VEC * stride);           // in flight while this batch lands
    land(r, v);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      r[i] = rn[i];
      v[i] = vn[i];
    }
  }
}

// Land one record's value in step-partial cell c (shared or device
// memory) of a field of kind KIND.
template <int KIND>
__device__ __forceinline__ void land_one(int* c, float v, int exact) {
  // add fields without exact sums: rounded to bf16 once, as the TPU
  // kernel's one-term split does
  const float va = exact ? v : __bfloat162float(__float2bfloat16_rn(v));
  switch (KIND) {
    case ADD_F32: atomicAdd((float*)c, va); break;
    case ADD_I32: atomicAdd(c, __float2int_rz(va)); break;
    case MAX8: atomicMax(c, min(max(__float2int_rz(v), 0), 255)); break;
    case MIN_F32: if (v == v) atomicMin((unsigned int*)c, f32_key(v)); break;
    case MAX_F32: if (v == v) atomicMax((unsigned int*)c, f32_key(v)); break;
    case MIN_I32: atomicMin(c, __float2int_rz(v)); break;
    case MAX_I32: atomicMax(c, __float2int_rz(v)); break;
  }
}

template <int KIND, int NB>
__device__ __forceinline__ void land_each(int* h, const int (&cell)[NB], const float (&v)[NB],
                                          int exact) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (cell[i] >= 0) land_one<KIND>(h + cell[i], v[i], exact);
}

// Land a batch's values of one field in array h at the cells the batch's
// records take (-1: none). The kind is the same for every record, so the
// switch is taken once a batch.
template <int NB>
__device__ __forceinline__ void land_field(int kind, int* h, const int (&cell)[NB],
                                           const float (&v)[NB], int exact) {
  switch (kind) {
    case ADD_F32: land_each<ADD_F32>(h, cell, v, exact); break;
    case ADD_I32: land_each<ADD_I32>(h, cell, v, exact); break;
    case MAX8: land_each<MAX8>(h, cell, v, exact); break;
    case MIN_F32: land_each<MIN_F32>(h, cell, v, exact); break;
    case MAX_F32: land_each<MAX_F32>(h, cell, v, exact); break;
    case MIN_I32: land_each<MIN_I32>(h, cell, v, exact); break;
    case MAX_I32: land_each<MAX_I32>(h, cell, v, exact); break;
  }
}

// Tiled ingest. FIELDS: the aggregate has VALUE fields (else the count
// alone, and vals is not read). A record's cell in the step's [K, NSB]
// partial is its idx, key_id * NSB + rel.
template <bool FIELDS>
__global__ void __launch_bounds__(K1_INGEST_THREADS)
k1_ingest_tiled(Fields fl, const int* __restrict__ idx, const float* __restrict__ vals,
                int* __restrict__ part, StepDesc* __restrict__ descs, Plan plan, int K,
                int S, int NSB, int F, int R, int B, int t0, int tg, int ct, int vec,
                int exact, int* phase) {
  extern __shared__ int hist[];                // (1 + nf) arrays of ct cells, swizzled
  __shared__ int kind[1 + MAX_FIELDS];         // of each array's partials (count: ADD_I32)
  __shared__ int nrec;                         // the CTA's records with idx >= 0
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const long long cells = (long long)NSB * K;  // < 2^31 (ops.supports)
  const unsigned int c0 = blockIdx.y * ct;     // the tile's first cell
  const unsigned int nct = min((long long)ct, cells - c0);   // cells in the tile
  const int nf = FIELDS ? fl.n : 0;
  if (rank == 0 && blockIdx.y == 0 && threadIdx.x < 32)  // the step's plan, for k1_scan
    build_desc(descs[blockIdx.z], plan, (long long)t0 + blockIdx.z, S, F, R, phase);
  if (threadIdx.x <= nf)
    kind[threadIdx.x] = threadIdx.x ? part_kind(fl.kind[threadIdx.x - 1]) : ADD_I32;
  if (threadIdx.x == 0) nrec = 0;
  // the first key tile's CTAs read every record of the step once between
  // them: they count the ingested ones
  const bool counts = phase != nullptr && blockIdx.y == 0;
  int mine = 0;
  __syncthreads();
  for (int a = 0; a <= nf; ++a)                // whole swizzle runs
    for (int i = threadIdx.x; i < ct; i += blockDim.x) hist[a * ct + i] = part_identity(kind[a]);
  __syncthreads();

  // the cluster's CTAs take interleaved groups of the step's records
  constexpr int NB = k1_batch<FIELDS>();
  const long long base = (long long)(t0 + blockIdx.z) * B;
  for_records<FIELDS>(
      idx + base, vals + base, B, vec, rank * blockDim.x + threadIdx.x, C * blockDim.x,
      [&](const int (&r)[NB], const float (&v)[NB]) {
        int cell[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          // one unsigned compare drops negative idx (late, cold-routed,
          // padding), out-of-range keys (idx >= K * NSB) and another tile's
          // cells
          const unsigned int c = (unsigned int)r[i] - c0;
          cell[i] = c < nct ? (int)swizzle(c) : -1;
          if (cell[i] >= 0) atomicAdd(hist + cell[i], 1);
          if (counts) mine += r[i] >= 0;
        }
        for (int a = 1; a <= nf; ++a) land_field(kind[a], hist + a * ct, cell, v, exact);
      });
  if (counts) block_count_add(phase, mine, &nrec);
  cluster.sync();                              // every histogram is complete

  // CTA `rank` folds its share of the tile's cells over the cluster's C
  // histograms, in rank order, and stores them to P
  const int per = ((int)nct + C - 1) / C;
  const int lo = rank * per, hi = min((int)nct, lo + per);
  const int tl = blockIdx.z;
  for (int a = 0; a <= nf; ++a) {
    int* out = part + ((long long)a * tg + tl) * cells + c0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      int* cell = hist + a * ct + swizzle(i);
      int x = *cluster.map_shared_rank(cell, 0);
      for (int q = 1; q < C; ++q) x = part_merge(kind[a], x, *cluster.map_shared_rank(cell, q));
      out[i] = x;
    }
  }
  cluster.sync();                              // no CTA leaves while read
}

// Ingest by device-memory atomics, for steps whose cells would take more
// than K1_MAX_TILES key tiles: a grid that fits the card at once sets the
// group's partials to their identities and writes its descriptors, waits
// for the whole grid, then lands every record of every step in its
// partial. The records are read once.
template <bool FIELDS>
__global__ void __launch_bounds__(K1_INGEST_THREADS)
k1_ingest_atomic(Fields fl, const int* __restrict__ idx, const float* __restrict__ vals,
                 int* __restrict__ part, StepDesc* __restrict__ descs, Plan plan, int K,
                 int S, int NSB, int F, int R, int B, int t0, int tg, int vec, int exact,
                 int* phase) {
  __shared__ int kind[1 + MAX_FIELDS];         // of each array's partials (count: ADD_I32)
  __shared__ int nrec;                         // the CTA's records with idx >= 0
  cg::grid_group grid = cg::this_grid();
  const long long cells = (long long)NSB * K;  // < 2^31 (ops.supports)
  const long long n = (long long)tg * cells;   // cells of one array of the group
  const int nf = FIELDS ? fl.n : 0;
  const long long me = grid.thread_rank(), all = grid.size();
  if (threadIdx.x <= nf)
    kind[threadIdx.x] = threadIdx.x ? part_kind(fl.kind[threadIdx.x - 1]) : ADD_I32;
  if (threadIdx.x == 0) nrec = 0;
  __syncthreads();
  for (int a = 0; a <= nf; ++a) {
    const int id = part_identity(kind[a]);
    int* p = part + a * n;
    for (long long i = me; i < n; i += all) p[i] = id;
  }
  for (long long tl = me / 32; tl < tg; tl += all / 32)   // a warp per step
    build_desc(descs[tl], plan, t0 + tl, S, F, R, phase);
  grid.sync();

  constexpr int NB = k1_batch<FIELDS>();
  int mine = 0;                                // records with idx >= 0 this thread read
  for (int tl = 0; tl < tg; ++tl) {
    const long long base = (long long)(t0 + tl) * B;
    int* pc = part + (long long)tl * cells;
    for_records<FIELDS>(
        idx + base, vals + base, B, vec, (int)me, (int)all,
        [&](const int (&r)[NB], const float (&v)[NB]) {
          int cell[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            cell[i] = (unsigned int)r[i] < (unsigned int)cells ? r[i] : -1;
            if (cell[i] >= 0) atomicAdd(pc + cell[i], 1);
            if (phase != nullptr) mine += r[i] >= 0;
          }
          for (int a = 1; a <= nf; ++a) land_field(kind[a], pc + a * n, cell, v, exact);
        });
  }
  if (phase != nullptr) block_count_add(phase, mine, &nrec);
}

// STAGED: the CTA's ring tile [NA, S, K1_SCAN_KEYS] lives in shared
// memory (else the scan works on the ring in device memory). pb > 0: each
// thread copies its key's partials into shared memory ahead of use, in
// batches of pb steps, two batches in flight ([2, pb, NA, keys, NSB]; 16
// bytes a copy where NSB is a multiple of 4); pb = 0: it reads them from
// device memory as it goes.
template <int NA, bool STAGED>
__global__ void __launch_bounds__(K1_SCAN_KEYS)
k1_scan(int* __restrict__ count, Fields fl, const int* __restrict__ part,
        const StepDesc* __restrict__ descs, int* __restrict__ count_out, Fields outs,
        const int* __restrict__ purge, Spws spws, int K, int S, int NSB, int t0,
        int tg, int pb, int raw, int* phase) {
  extern __shared__ int sm[];                  // ring tile, then staged partials
  __shared__ StepDesc desc[K1_CHUNK];
  __shared__ int w_s[MAX_FIRES];
  __shared__ int nrec;                         // the CTA's sum of count partials
  // the partials entry counts what it ingests: the sum of the count
  // partials (phase is null for the lane entry, whose ingest counts)
  const bool counts = phase != nullptr;
  unsigned int psum = 0;
  const int kl = threadIdx.x, key = blockIdx.x * K1_SCAN_KEYS + kl;
  const bool mine = key < K;
  const long long cells = (long long)NSB * K;
  int kind[NA], pkind[NA], ident[NA];          // ring kind, its partials' kind
  int *ring_p[NA], *out_p[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    kind[a] = a ? fl.kind[a - 1] : ADD_I32;
    pkind[a] = a && kind[a] == ADD_I32 ? PART_I32_OF_F32 : raw ? PART_RAW : kind[a];
    ident[a] = a ? fl.ident[a - 1] : 0;
    ring_p[a] = (a ? (int*)fl.p[a - 1] : count) + key;
    out_p[a] = (a ? (int*)outs.p[a - 1] : count_out) + key;
  }
  for (int f = kl; f < MAX_FIRES; f += K1_SCAN_KEYS) w_s[f] = spws.w[f];
  if (kl == 0) nrec = 0;                       // ordered by the chunk loop's first barrier
  int* ps = sm + (STAGED ? NA * S * K1_SCAN_KEYS : 0);
  // ring cell (a, col) of the thread's key; neighbouring keys sit in
  // neighbouring banks, and a step's columns are the same for every key
#define K1_CELL(a, col) \
  (STAGED ? sm[((a) * S + (col)) * K1_SCAN_KEYS + kl] : ring_p[a][(long long)(col) * K])
  // partials of the thread's key: P[a][tl][key][r]
  const int* pk = part + (long long)key * NSB;
  auto stage_batch = [&](int b) {              // steps [b * pb, (b + 1) * pb)
    if (mine)
      for (int s = 0, tl = b * pb; s < pb && tl < tg; ++s, ++tl)
        for (int a = 0; a < NA; ++a) {
          int* dst = ps + ((((b & 1) * pb + s) * NA + a) * K1_SCAN_KEYS + kl) * NSB;
          const int* src = pk + ((long long)a * tg + tl) * cells;
          if (NSB % 4 == 0)
            for (int r = 0; r < NSB; r += 4) cp_async16(dst + r, src + r);
          else
            for (int r = 0; r < NSB; ++r) cp_async4(dst + r, src + r);
        }
    cp_async_commit();
  };
  if (STAGED && mine)                          // the ring tile, with batch 0
    for (int col = 0; col < S; ++col)
      for (int a = 0; a < NA; ++a)
        cp_async4(&K1_CELL(a, col), ring_p[a] + (long long)col * K);
  // the common case: partials staged, four rels, each in its own column
  const bool fast = pb > 0 && NSB == 4 && S >= 4;
  int nb = 0, bi = 0, bs = 0;                  // last batch staged; step and slot in batch
  if (pb)
    stage_batch(0);
  else
    cp_async_commit();

  for (int c0 = 0; c0 < tg; c0 += K1_CHUNK) {
    const int n = min(K1_CHUNK, tg - c0);
    __syncthreads();                           // the last chunk's readers are done
    for (int x = kl; x < n * (int)(sizeof(StepDesc) / 4); x += K1_SCAN_KEYS)
      reinterpret_cast<int*>(desc)[x] = reinterpret_cast<const int*>(descs + c0)[x];
    __syncthreads();
    if (!mine) continue;
    for (int i = 0; i < n; ++i) {
      const int tl = c0 + i;
      const StepDesc& d = desc[i];
      if (pb && bi == 0) {                     // this thread's copies of the batch are in
        stage_batch(++nb);
        cp_async_wait<1>();
      } else if (!pb && tl == 0) {
        cp_async_wait<0>();                    // the ring tile
      }
      // ingest: column (smin + r) mod S takes partial r
      const int* pt = pb ? ps + ((bs * pb + bi) * NA * K1_SCAN_KEYS + kl) * NSB
                         : pk + (long long)tl * cells;
      if (fast) {                              // loads first, then merges, then stores
        int col[4], cur[NA][4];
        int4 add[NA];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          col[r] = d.sm + r >= S ? d.sm + r - S : d.sm + r;
#pragma unroll
          for (int a = 0; a < NA; ++a) cur[a][r] = K1_CELL(a, col[r]);
        }
#pragma unroll
        for (int a = 0; a < NA; ++a)
          add[a] = *reinterpret_cast<const int4*>(pt + a * K1_SCAN_KEYS * 4);
        if (counts)
          psum += (unsigned int)add[0].x + (unsigned int)add[0].y + (unsigned int)add[0].z +
                  (unsigned int)add[0].w;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          K1_CELL(a, col[0]) = merge_bits(kind[a], cur[a][0], part_value(pkind[a], add[a].x));
          K1_CELL(a, col[1]) = merge_bits(kind[a], cur[a][1], part_value(pkind[a], add[a].y));
          K1_CELL(a, col[2]) = merge_bits(kind[a], cur[a][2], part_value(pkind[a], add[a].z));
          K1_CELL(a, col[3]) = merge_bits(kind[a], cur[a][3], part_value(pkind[a], add[a].w));
        }
      } else {
        const long long pa = pb ? (long long)K1_SCAN_KEYS * NSB : (long long)tg * cells;
        for (int r = 0; r < NSB; ++r) {
          const int col = (d.sm + r) % S;
          if (counts) psum += (unsigned int)pt[r];
#pragma unroll
          for (int a = 0; a < NA; ++a)
            K1_CELL(a, col) =
                merge_bits(kind[a], K1_CELL(a, col), part_value(pkind[a], pt[a * pa + r]));
        }
      }

      // fire: slot f folds its own w columns (a shared group's members
      // differ) from its position into its row
#pragma unroll
      for (int c = 0; c < FIRE_WORDS; ++c)
        for (unsigned int fires = d.fires[c]; fires; fires &= fires - 1) {
          const int f = 32 * c + __ffs(fires) - 1;
          const int pos = d.pos[f], w = w_s[f];
          const long long row = (long long)d.row[f] * K;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            int acc = K1_CELL(a, pos);
#pragma unroll 4
            for (int j = 1, col = pos; j < w; ++j) {
              col = col + 1 == S ? 0 : col + 1;
              acc = merge_bits(kind[a], acc, K1_CELL(a, col));
            }
            out_p[a][row] = acc;
          }
        }

      // purge: dead columns back to the identity
#pragma unroll
      for (int jw = 0; jw < DESC_DEAD_WORDS; ++jw)
        for (unsigned int dead = 32 * jw < S ? d.dead[jw] : 0; dead; dead &= dead - 1) {
          const int col = 32 * jw + __ffs(dead) - 1;
#pragma unroll
          for (int a = 0; a < NA; ++a) K1_CELL(a, col) = ident[a];
        }
      for (int col = 32 * DESC_DEAD_WORDS; col < S; ++col)   // rings wider than 128
        if (__ldg(purge + (long long)(t0 + tl) * S + col) == 0)
#pragma unroll
          for (int a = 0; a < NA; ++a) K1_CELL(a, col) = ident[a];
      if (pb && ++bi == pb) {
        bi = 0;
        bs ^= 1;
      }
    }
  }

  if (STAGED && mine)
    for (int col = 0; col < S; ++col)
#pragma unroll
      for (int a = 0; a < NA; ++a) ring_p[a][(long long)col * K] = K1_CELL(a, col);
  if (counts) block_count_add(phase, (int)psum, &nrec);
#undef K1_CELL
}

#define K1_SCAN(NA)                                                            \
  case NA:                                                                     \
    e = ring ? launch(k1_scan<NA, true>) : launch(k1_scan<NA, false>);         \
    break;

// Launch k1_scan over the group's partials (raw: k1_partials' caller-made
// ones): one thread per key; the CTA's ring tile in shared memory where it
// fits K1_RING_SMEM, and the partials staged in batches of up to K1_CHUNK
// steps that fit K1_STAGE_SMEM (none: read from device memory).
static cudaError_t launch_k1_scan(int* count, const Fields& fl, const int* part,
                                  const StepDesc* descs, int* count_out, const Fields& ol,
                                  const int* purge, const Spws& sw, int K, int S, int NSB,
                                  int t0, int tg, int raw, int* phase, cudaStream_t st) {
  const int na = 1 + fl.n;
  const size_t ring = (size_t)na * S * K1_SCAN_KEYS * 4 <= K1_RING_SMEM
                          ? (size_t)na * S * K1_SCAN_KEYS * 4 : 0;
  const size_t per_step = (size_t)2 * na * NSB * K1_SCAN_KEYS * 4;
  const int pb = (int)min((size_t)K1_CHUNK, K1_STAGE_SMEM / per_step);
  const size_t smem = ring + pb * per_step;
  const int grid = (K + K1_SCAN_KEYS - 1) / K1_SCAN_KEYS;
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_RING_SMEM + K1_STAGE_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, K1_SCAN_KEYS, smem, st>>>(count, fl, part, descs, count_out, ol, purge,
                                             sw, K, S, NSB, t0, tg, pb, raw, phase);
    return cudaGetLastError();
  };
  cudaError_t e = cudaErrorInvalidValue;
  switch (na) { K1_SCAN(1) K1_SCAN(2) K1_SCAN(3) K1_SCAN(4) K1_SCAN(5) }
  return e;
}

// One group of tg steps from step t0: the ingest writes the group's
// partials to part ([1 + nf, tg, K, NSB] int32, allocated by the caller)
// and, after them, one StepDesc per step; k1_scan walks the steps. phase:
// the dispatch's int32[3] phase counters, added to (null: off).
// Returns a CUDA error code (0 = launched).
extern "C" int k1_superscan(
    int* count, void* const* fields, const int* kinds, const int* idents,
    int nf, const int* idx, const float* vals, const int* smin,
    const int* fpos, const int* fvalid, const int* frow, const int* purge,
    const int* spws, int F, int* count_out, void* const* outs, int K, int S,
    int NSB, int R, int B, int exact, int* part, int t0, int tg, int* phase,
    void* stream) {
  if (nf > MAX_FIELDS || F > MAX_FIRES || tg < 1 || tg > 65535 || K < 1 || NSB < 1 ||
      S > 65536 || R > 65536 || (long long)NSB * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
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
  const int na = 1 + nf;

  // ingest: the fewest key tiles whose histograms fit one CTA; a tile's
  // cells rounded up to whole swizzle runs of 32
  const long long cells = (long long)NSB * K;
  const long long max_ct = K1_INGEST_SMEM / (4 * na) / 32 * 32;
  const long long tiles = (cells + max_ct - 1) / max_ct;
  const int ct = (int)(((cells + tiles - 1) / tiles + 31) / 32 * 32);
  const int vec = B % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                  (nf == 0 || (uintptr_t)vals % 16 == 0);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Plan pl = {smin, fpos, fvalid, frow, purge};
  StepDesc* descs = reinterpret_cast<StepDesc*>(part + (long long)na * tg * cells);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(K1_INGEST_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (tiles <= K1_MAX_TILES) {
    // each tile's cluster re-reads the step's records: a few tiles cost
    // less than an atomic in device memory per record and field
    auto ingest = nf ? k1_ingest_tiled<true> : k1_ingest_tiled<false>;
    e = cudaFuncSetAttribute(ingest, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K1_INGEST_SMEM);
    if (e != cudaSuccess) return (int)e;
    // CTAs per cluster: as many as fill the SMs in one wave, 1 to
    // K1_MAX_CLUSTER (each CTA pays for its histogram's init and fold)
    const int C = (int)max(1LL, min((long long)K1_MAX_CLUSTER, sms / (tiles * tg)));
    cfg.gridDim = dim3(C, (unsigned int)tiles, (unsigned int)tg);
    cfg.dynamicSmemBytes = (size_t)na * ct * 4;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaLaunchKernelEx(&cfg, ingest, fl, idx, vals, part, descs, pl, K, S, NSB, F, R,
                           B, t0, tg, ct, vec, exact, phase);
  } else {
    // a cooperative grid of as many CTAs as the card holds at once
    auto ingest = nf ? k1_ingest_atomic<true> : k1_ingest_atomic<false>;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ingest, K1_INGEST_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3((unsigned int)(sms * max(per_sm, 1)));
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    e = cudaLaunchKernelEx(&cfg, ingest, fl, idx, vals, part, descs, pl, K, S, NSB, F, R,
                           B, t0, tg, vec, exact, phase);
  }
  if (e != cudaSuccess) return (int)e;

  return (int)launch_k1_scan(count, fl, part, descs, count_out, ol, purge, sw, K, S, NSB, t0, tg,
                             0, nullptr, st);
}

// The step descriptors of a group of steps from t0, one warp a step (the
// partials entry has no ingest launch to build them).
__global__ void __launch_bounds__(32)
k1_descs(StepDesc* __restrict__ descs, Plan plan, int S, int F, int R, int t0, int* phase) {
  build_desc(descs[blockIdx.x], plan, (long long)t0 + blockIdx.x, S, F, R, phase);
}

// K1's partials entry: one group of tg steps from step t0 whose step
// partials the caller reduced ([1 + nf, tg, K, NSB] 32-bit patterns, the
// count then each field in its value's own bits, an int add field's as its
// float32 sum; the mesh's map-side
// combiner folds them across shards). Builds the group's descriptors into
// descs (tg StepDesc, allocated by the caller), then runs the same walk as
// k1_superscan: merge each step's partials into their columns, fire, purge.
// phase as k1_superscan's; the ingest count is the sum of the count
// partials. What bounds it: bytes, the partials read once beside a ring
// read and written once. Returns a CUDA error code (0 = launched).
extern "C" int k1_partials(
    int* count, void* const* fields, const int* kinds, const int* idents, int nf,
    const int* part, const int* smin, const int* fpos, const int* fvalid,
    const int* frow, const int* purge, const int* spws, int F, int* count_out,
    void* const* outs, int K, int S, int NSB, int R, int* descs, int t0, int tg,
    int* phase, void* stream) {
  if (nf > MAX_FIELDS || F > MAX_FIRES || tg < 1 || K < 1 || NSB < 1 || S > 65536 ||
      R > 65536 || (long long)NSB * K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
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
  Plan pl = {smin, fpos, fvalid, frow, purge};
  StepDesc* d = reinterpret_cast<StepDesc*>(descs);
  k1_descs<<<tg, 32, 0, st>>>(d, pl, S, F, R, t0, phase);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_k1_scan(count, fl, part, d, count_out, ol, purge, sw, K, S, NSB, t0, tg, 1,
                             phase, st);
}
