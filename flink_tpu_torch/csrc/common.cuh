// Shared pieces of the superscan kernels: field kinds, the merge of two
// cells, step-partial identities, cp.async, the step descriptors
// the scans walk, and the fire fold of a warp that holds a ring one lane
// per warp lane.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Field kinds, numbered as ops/cuda_superscan.py numbers them. The count
// ring merges as ADD_I32.
enum FieldKind {
  ADD_F32 = 0,
  ADD_I32 = 1,
  MAX8 = 2,      // int32 cell, value clipped to [0, 255], identity -1
  MIN_F32 = 3,
  MAX_F32 = 4,
  MIN_I32 = 5,
  MAX_I32 = 6,
};

#define MAX_FIELDS 4
// Fire slots a step, at most: a shared-partial group of 16 member windows
// at 4 fires a step each (K2 takes fewer: global_superscan.cu). A step's
// writing slots are a mask of FIRE_WORDS words.
#define MAX_FIRES 64
#define FIRE_WORDS (MAX_FIRES / 32)

struct Fields {
  void* p[MAX_FIELDS];   // one [S, K] (keyed) or [S] (global) ring per field
  int kind[MAX_FIELDS];
  int ident[MAX_FIELDS]; // purge identity, as the 32-bit pattern of the cell
  int n;
};

struct Spws {
  int w[MAX_FIRES];      // window length in slices of each fire slot
};

// The step's plan: smin [T], fire_pos/fire_valid/fire_row [T, F], purge
// [T, S], all int32 in device memory.
struct Plan {
  const int* smin;
  const int* fpos;
  const int* fvalid;
  const int* frow;
  const int* purge;
};

// Merge cell b into cell a, both 32-bit patterns of a field kind. Float
// min/max take b only when it is strictly smaller (larger): exact for -0.0
// and the +-FLT_MAX identities, and what a CAS loop that writes only on a
// strict compare leaves. Int32 adds wrap, as the reference's int32 sums do.
// Branch-free: a chain of selects, which folds to the one operation when
// the kind is known at compile time.
__device__ __forceinline__ int merge_bits(int kind, int a, int b) {
  const float fa = __int_as_float(a), fb = __int_as_float(b);
  int r = max(a, b);                                        // MAX8, MAX_I32
  r = kind == MIN_I32 ? min(a, b) : r;
  r = kind == MIN_F32 ? (fb < fa ? b : a) : r;
  r = kind == MAX_F32 ? (fb > fa ? b : a) : r;
  r = kind == ADD_I32 ? (int)((unsigned int)a + (unsigned int)b) : r;
  r = kind == ADD_F32 ? __float_as_int(fa + fb) : r;
  return r;
}

// The identity of a step partial: merging it into any cell leaves the
// cell's bits as they were (-0.0 for float adds: -0.0 + x is x, +0.0 too).
__host__ __device__ __forceinline__ int partial_identity(int kind) {
  switch (kind) {
    case ADD_F32: return (int)0x80000000u;   // -0.0f
    case ADD_I32: return 0;
    case MIN_F32: return 0x7f800000;         // +inf
    case MAX_F32: return (int)0xff800000u;   // -inf
    case MIN_I32: return 0x7fffffff;
    default:      return (int)0x80000000u;   // MAX8, MAX_I32: INT_MIN
  }
}

// Asynchronous 4- and 16-byte copies from device memory to shared memory
// (16: both addresses 16-byte aligned), and their commit and wait.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned int sa = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int sa = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x mod S in [0, S), as the plain version's Python modulo.
__device__ __forceinline__ int mod_s(int x, int S) {
  const int m = x % S;
  return m < 0 ? m + S : m;
}

// One step's plan as a warp that walks a ring reads it: smin and the fire
// positions reduced mod S, rows clipped to [0, R) (both below 2^16: the
// wrappers' limits), the slots that write as a mask (bit l of word c: slot
// 32 * c + l), and the purged columns as bits (columns below 128; a walker
// of a wider ring reads the plan's purge row itself).
#define DESC_DEAD_WORDS 4
struct StepDesc {
  int sm;
  unsigned int fires[FIRE_WORDS];
  unsigned short pos[MAX_FIRES];
  unsigned short row[MAX_FIRES];
  unsigned int dead[DESC_DEAD_WORDS];
};

static_assert(sizeof(StepDesc) == 4 * (1 + FIRE_WORDS + MAX_FIRES + DESC_DEAD_WORDS),
              "StepDesc is packed 32-bit words");

// sizeof(StepDesc): ops/cuda_superscan.py sizes the scratch that holds
// the descriptors, and checks its size against this when it loads a library.
extern "C" int step_desc_bytes() { return (int)sizeof(StepDesc); }

// Build the descriptor of step t; called by a whole warp, lane l holding
// slots l, 32 + l, ... A slot writes unless a later valid slot has the same
// row (the later write would win).
__device__ __forceinline__ void build_desc(StepDesc& d, const Plan& plan, long long t,
                                           int S, int F, int R) {
  const int lane = threadIdx.x & 31;
  int fv[FIRE_WORDS], row[FIRE_WORDS];
#pragma unroll
  for (int c = 0; c < FIRE_WORDS; ++c) {
    const int f = 32 * c + lane;
    const bool slot = f < F;
    fv[c] = slot ? plan.fvalid[t * F + f] : 0;
    row[c] = slot ? min(max(plan.frow[t * F + f], 0), R - 1) : -1;
    if (slot) {
      d.pos[f] = (unsigned short)mod_s(plan.fpos[t * F + f], S);
      d.row[f] = (unsigned short)row[c];
    }
  }
#pragma unroll
  for (int c = 0; c < FIRE_WORDS; ++c) {
    bool later = false;
#pragma unroll
    for (int c2 = c; c2 < FIRE_WORDS; ++c2) {
      if (32 * c2 >= F) continue;              // the same for the whole warp
      for (int l2 = 0; l2 < 32; ++l2) {
        const int v2 = __shfl_sync(0xffffffffu, fv[c2], l2);
        const int r2 = __shfl_sync(0xffffffffu, row[c2], l2);
        later |= (c2 > c || l2 > lane) && v2 > 0 && r2 == row[c];
      }
    }
    const unsigned int fires = __ballot_sync(0xffffffffu, fv[c] > 0 && !later);
    if (lane == 0) d.fires[c] = fires;
  }
#pragma unroll
  for (int j = 0; j < DESC_DEAD_WORDS; ++j) {
    const int col = lane + 32 * j;
    const unsigned int dead =
        __ballot_sync(0xffffffffu, col < S && plan.purge[t * S + col] == 0);
    if (lane == 0) d.dead[j] = dead;
  }
  if (lane == 0) d.sm = mod_s(plan.smin[t], S);
}

// The fold of the w ring lanes from pos (in [0, S)) of a ring held one
// lane per warp lane (v: this lane's cell; S <= 32), reduced across the
// warp in a fixed order; every lane returns it. A lane counts as often as
// the window covers it, as the sequential fold has it.
__device__ __forceinline__ int warp_window_fold(int kind, int S, int pos, int w, int v) {
  const int lane = threadIdx.x & 31;
  int x = partial_identity(kind);
  if (lane < S) {
    int d = lane - pos;
    if (d < 0) d += S;
    for (int i = d; i < w; i += S) x = merge_bits(kind, x, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = merge_bits(kind, x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
