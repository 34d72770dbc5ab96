// Hand-written Hopper kernel for batched DMN decision-table matching (sm_90a).
//
// What it replaces (the reference's jax.jit program, lowered by XLA):
//   - zeebe_tpu/ops/decision.py::_evaluate_batch (:343) with _match_matrix
//     (:323): N contexts against one compiled table of R rules over I inputs,
//     K unary-test atoms per cell. An atom of kind A_TRUE matches anything,
//     null included; A_RANGE is a lexicographic signed (hi, lo) comparison
//     of the context's f64 order key against both ends, F_LO_OPEN / F_HI_OPEN
//     choosing < over <= at the low / high end; A_EQ is equality of both
//     planes; RANGE and EQ match only where the input is valid; any other
//     kind (A_PAD) never matches. A cell is any over its K atoms, a rule all
//     over its I cells. Outputs: the match matrix m [N, R] (bool), the count
//     of matching rules per context and the first matching rule (or -1).
//
// What bounds it on an H100: every input read once (the context keys
// [N, I, 2] and validity [N, I] dominate; the atoms are a few KB) and every
// output written once; against that, N * I * R * K atom tests of roughly a
// dozen integer operations each. At the benchmark's geometry (N = 200,000,
// I = 2, R = 8, K = 4) the two are close (~2 us each); at a wide table
// (R = 512) the atom tests bound it by operations. chip_smoke.py computes
// both from the run's data and prints the larger.
//
// What the design does about it (a simple design that is right first): one
// thread per context walks the rules in 32-rule words. For each (word,
// input) the block stages that word's atoms of that input in shared memory,
// so the atoms are read from device memory once per block and from shared
// memory by every thread; the thread builds a 32-bit cell mask, ANDs it into
// the word's rule mask and stops testing inputs once the mask is empty. It
// then writes its bytes of m, adds __popc to its count and takes __ffs of the
// first non-empty word for the first match. No atomics: the output is
// deterministic. Writing m one byte per rule from each thread is not
// coalesced; a faster layout is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int A_TRUE = 1;
constexpr int A_RANGE = 2;
constexpr int A_EQ = 3;
constexpr int F_LO_OPEN = 1;
constexpr int F_HI_OPEN = 2;

struct Atom {
  int32_t kind, flags, lo_hi, lo_lo, hi_hi, hi_lo;
};

__device__ __forceinline__ bool key_le(int32_t ah, int32_t al, int32_t bh, int32_t bl) {
  return ah < bh || (ah == bh && al <= bl);
}

__device__ __forceinline__ bool key_lt(int32_t ah, int32_t al, int32_t bh, int32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__device__ __forceinline__ bool atom_matches(const Atom& at, bool valid, int32_t vh,
                                             int32_t vl) {
  if (at.kind == A_TRUE) return true;
  if (!valid) return false;
  if (at.kind == A_RANGE) {
    bool lo_ok = (at.flags & F_LO_OPEN) ? key_lt(at.lo_hi, at.lo_lo, vh, vl)
                                        : key_le(at.lo_hi, at.lo_lo, vh, vl);
    bool hi_ok = (at.flags & F_HI_OPEN) ? key_lt(vh, vl, at.hi_hi, at.hi_lo)
                                        : key_le(vh, vl, at.hi_hi, at.hi_lo);
    return lo_ok && hi_ok;
  }
  if (at.kind == A_EQ) return vh == at.lo_hi && vl == at.lo_lo;
  return false;
}

// atoms: [32 * K] of the current (word, input), rule-major
__global__ void k_decision(const int32_t* __restrict__ kind, const int32_t* __restrict__ flags,
                           const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                           const int32_t* __restrict__ keys,
                           const uint8_t* __restrict__ valid, int N, int I, int R, int K,
                           uint8_t* __restrict__ m, int32_t* __restrict__ counts,
                           int32_t* __restrict__ selected) {
  extern __shared__ Atom atoms[];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  int count = 0;
  int first = -1;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int nr = min(32, R - r0);
    uint32_t mask = nr == 32 ? 0xffffffffu : ((1u << nr) - 1u);
    for (int i = 0; i < I; ++i) {
      __syncthreads();  // every thread is done with the previous tile
      for (int a = threadIdx.x; a < nr * K; a += blockDim.x) {
        const size_t idx = ((size_t)i * R + r0 + a / K) * K + a % K;
        atoms[a] = Atom{kind[idx], flags[idx], lo[2 * idx], lo[2 * idx + 1],
                        hi[2 * idx], hi[2 * idx + 1]};
      }
      __syncthreads();
      if (!live || mask == 0) continue;
      const size_t ni = (size_t)n * I + i;
      const int32_t vh = keys[2 * ni], vl = keys[2 * ni + 1];
      const bool v = valid[ni] != 0;
      uint32_t cell = 0;
      for (int rr = 0; rr < nr; ++rr) {
        bool any = false;
        for (int k = 0; k < K; ++k) any |= atom_matches(atoms[rr * K + k], v, vh, vl);
        cell |= (uint32_t)any << rr;
      }
      mask &= cell;
    }
    if (!live) continue;
    uint8_t* row = m + (size_t)n * R + r0;
    for (int rr = 0; rr < nr; ++rr) row[rr] = (mask >> rr) & 1u;
    count += __popc(mask);
    if (first < 0 && mask != 0) first = r0 + __ffs((int)mask) - 1;
  }
  if (live) {
    counts[n] = count;
    selected[n] = first;
  }
}

}  // namespace

extern "C" {

// One launch over N >= 1 contexts on `stream`; K <= 64 (the shared tile,
// 32 * K atoms of 24 bytes, stays within the default 48 KB). Returns
// cudaGetLastError() after the launch.
int zt_decision(const int32_t* kind, const int32_t* flags, const int32_t* lo,
                const int32_t* hi, const int32_t* keys, const uint8_t* valid, int N, int I,
                int R, int K, uint8_t* m, int32_t* counts, int32_t* selected, void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  const size_t shared = (size_t)32 * K * sizeof(Atom);
  k_decision<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
      kind, flags, lo, hi, keys, valid, N, I, R, K, m, counts, selected);
  return (int)cudaGetLastError();
}

int zt_decision_max_atoms() { return 64; }

}  // extern "C"
