// Hand-written Hopper kernels for batched DMN decision-table matching (sm_90a).
//
// What they replace (the reference's jax.jit program, lowered by XLA):
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
// What bounds them on an H100: every input read once (the context keys
// [N, I, 2] and validity [N, I] dominate at a narrow table; the atoms are a
// few KB to a few hundred KB) and every output written once (m is N * R
// bytes); against that, the atom tests whose result depends on the context.
// At the benchmark's geometry (N = 200,000, I = 2, R = 8, K = 4) bytes bound
// it (~2 us); at a wide table (N = 16,384, I = 4, R = 512, K = 4) the atom
// tests do (~13 us of int32 operations). chip_smoke.py computes both from the
// run's data and prints the larger.
//
// Two layouts compute the same function; ops/kernels.run_decision picks one.
//
// k_decision_lanes (the default): one thread owns one (context, 32-rule
// word). W = ceil(R / 32) rounded up to a power of two, at most 32, lanes
// serve a context, so 32 / W contexts share a warp; above 1024 rules a lane
// loops over words w = lane, lane + 32, .... At R = 8 that is one thread per
// context, at R = 512 sixteen, so 16,384 contexts give 262,144 threads and
// fill the card.
//   - Operations (the wide table): the block stages the table once in shared
//     memory, each atom as a closed interval of 64-bit order keys (open ends
//     moved inward, EQ as [key, key], PAD as an empty interval: one
//     compare pair per test), word-minor so that the lanes of a context read
//     neighbouring 16-byte slots (no 16-way bank conflict between them), and
//     per (input, word) a mask of the cells that hold an A_TRUE atom. A lane tests only the rules still alive in its
//     word that are not always-true for the input, iterating their set bits,
//     and stops at a cell's first matching atom, so rules die off input by
//     input. The grid is persistent (the blocks the card holds at once loop
//     over tiles of contexts), so the table is staged once per block. A
//     table too large for shared memory is read from device memory through
//     the read-only path and canonicalized per test.
//   - Bytes (the benchmark table): a tile's context keys and validity are
//     staged in shared memory with coalesced loads; each lane writes its
//     word's bytes of m with the widest aligned stores (16 bytes at a whole
//     word of an aligned row, 8 bytes for R = 8), neighbouring lanes on
//     neighbouring addresses, the ragged last word masked.
//   - Count and first match: a segmented warp reduction over the context's
//     lanes (popcounts summed, the lowest matching rule index taken). No
//     atomics: the output is deterministic.
//
// k_decision (serial, kept for the A/B): one thread per context walks the
// rules in 32-rule words. For each (word, input) the block stages that word's
// atoms of that input in shared memory; the thread builds a 32-bit cell mask,
// ANDs it into the word's rule mask and stops testing inputs once the mask is
// empty, then writes its bytes of m one at a time, adds __popc to its count
// and takes __ffs of the first non-empty word.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;       // the serial layout
constexpr int kLaneThreads = 512;   // the lanes layout
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

// the order key of an f64 as one signed 64-bit integer: (hi, lo) compared
// lexicographically as signed int32s is this key's signed order
__device__ __forceinline__ long long key64(int32_t h, int32_t l) {
  return (long long)(((unsigned long long)(uint32_t)h << 32) |
                     (uint32_t)(l ^ INT32_MIN));
}

// an atom as the closed interval of keys it matches for a valid input;
// A_TRUE is handled by the always-true mask, so it and A_PAD are empty
__device__ __forceinline__ longlong2 atom_interval(int32_t kind, int32_t flags, int32_t lh,
                                                   int32_t ll, int32_t hh, int32_t hl) {
  const longlong2 empty = make_longlong2(LLONG_MAX, LLONG_MIN);
  long long lo = key64(lh, ll);
  if (kind == A_EQ) return make_longlong2(lo, lo);
  if (kind != A_RANGE) return empty;
  long long hi = key64(hh, hl);
  if (flags & F_LO_OPEN) {
    if (lo == LLONG_MAX) return empty;
    ++lo;
  }
  if (flags & F_HI_OPEN) {
    if (hi == LLONG_MIN) return empty;
    --hi;
  }
  return make_longlong2(lo, hi);
}

// the bytes of m from p: one per bit of mask, n of them (n <= 32), each as
// wide a store as p's alignment allows
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;  // bit k -> byte k
}

__device__ __forceinline__ void store_mask(uint8_t* p, uint32_t mask, int n) {
  while (n > 0) {
    const uintptr_t a = (uintptr_t)p;
    if (n >= 16 && (a & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(spread4(mask), spread4(mask >> 4),
                                                spread4(mask >> 8), spread4(mask >> 12));
      p += 16; mask >>= 16; n -= 16;
    } else if (n >= 8 && (a & 7) == 0) {
      *reinterpret_cast<uint2*>(p) = make_uint2(spread4(mask), spread4(mask >> 4));
      p += 8; mask >>= 8; n -= 8;
    } else if (n >= 4 && (a & 3) == 0) {
      *reinterpret_cast<uint32_t*>(p) = spread4(mask);
      p += 4; mask >>= 4; n -= 4;
    } else {
      *p = mask & 1u;
      p += 1; mask >>= 1; n -= 1;
    }
  }
}

// One launch of persistent blocks over tiles of C = blockDim.x / W contexts.
// Shared memory, in this order: the table's intervals [I, K, 32, nw] and,
// after the keys, its always-true masks [I, nw] (stage_atoms); the tile's keys
// [C, I] as int2 and validity [C, I] (stage_keys).
__global__ void __launch_bounds__(kLaneThreads)
k_decision_lanes(const int32_t* __restrict__ kind, const int32_t* __restrict__ flags,
                 const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                 const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid, int N,
                 int I, int R, int K, int W, int stage_atoms, int stage_keys,
                 uint8_t* __restrict__ m, int32_t* __restrict__ counts,
                 int32_t* __restrict__ selected) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, NT = blockDim.x;
  const int nw = (R + 31) / 32;
  const int C = NT / W;
  const int64_t n_atoms = (int64_t)I * R * K;
  // interval of atom k of rule 32 * w + j of input i at
  // ((i * K + k) * 32 + j) * nw + w: neighbouring lanes, on neighbouring
  // words, read neighbouring 16-byte slots
  const int64_t k_stride = (int64_t)32 * nw;
  size_t off = 0;
  longlong2* iv = reinterpret_cast<longlong2*>(smem);
  if (stage_atoms) off += (size_t)I * K * k_stride * sizeof(longlong2);
  int2* skeys = reinterpret_cast<int2*>(smem + off);
  if (stage_keys) off += (size_t)C * I * sizeof(int2);
  uint32_t* always = reinterpret_cast<uint32_t*>(smem + off);
  if (stage_atoms) off += (size_t)I * nw * sizeof(uint32_t);
  uint8_t* svalid = smem + off;

  if (stage_atoms) {
    for (int x = tid; x < I * nw; x += NT) always[x] = 0;
    __syncthreads();
    for (int64_t a = tid; a < n_atoms; a += NT) {
      const int32_t kd = kind[a];
      const int64_t i = a / K / R;
      const int r = (int)((a / K) % R), k = (int)(a % K);
      iv[((i * K + k) * 32 + (r & 31)) * nw + (r >> 5)] =
          atom_interval(kd, flags[a], lo[2 * a], lo[2 * a + 1], hi[2 * a], hi[2 * a + 1]);
      if (kd == A_TRUE) atomicOr(&always[i * nw + (r >> 5)], 1u << (r & 31));
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  const int sl = lane & (W - 1);                    // this lane's place in its context
  const int c = (tid >> 5) * (32 / W) + lane / W;   // its context within the tile
  const int ntiles = (N + C - 1) / C;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * C;
    const int n = n0 + c;
    const bool live = n < N;
    if (stage_keys) {
      const int64_t base = (int64_t)n0 * I;
      const int cnt = min(C, N - n0) * I;
      const int2* k2 = reinterpret_cast<const int2*>(keys);
      __syncthreads();  // the previous tile's keys are read
      for (int x = tid; x < cnt; x += NT) {
        skeys[x] = k2[base + x];
        svalid[x] = valid[base + x];
      }
      __syncthreads();
    }
    int count = 0, first = INT_MAX;
    for (int w = sl; live && w < nw; w += W) {
      const int nr = min(32, R - 32 * w);
      uint32_t mask = nr == 32 ? 0xffffffffu : ((1u << nr) - 1u);
      for (int i = 0; i < I && mask != 0; ++i) {
        int2 kv;
        bool v;
        if (stage_keys) {
          kv = skeys[c * I + i];
          v = svalid[c * I + i] != 0;
        } else {
          kv = __ldg(reinterpret_cast<const int2*>(keys) + (int64_t)n * I + i);
          v = __ldg(valid + (int64_t)n * I + i) != 0;
        }
        const long long key = key64(kv.x, kv.y);
        uint32_t fail = 0;
        if (stage_atoms) {
          const uint32_t aw = always[i * nw + w];
          if (!v) {
            fail = mask & ~aw;  // only A_TRUE matches a null input
          } else {
            uint32_t todo = mask & ~aw;
            while (todo != 0) {
              const int j = __ffs(todo) - 1;
              todo &= todo - 1;
              const longlong2* at = iv + ((int64_t)i * K * 32 + j) * nw + w;
              bool any = false;
              for (int k = 0; k < K && !any; ++k) {
                const longlong2 t = at[k * k_stride];
                any = t.x <= key && key <= t.y;
              }
              if (!any) fail |= 1u << j;
            }
          }
        } else {
          uint32_t todo = mask;
          while (todo != 0) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            const int64_t a0 = ((int64_t)i * R + 32 * w + j) * K;
            bool any = false;
            for (int k = 0; k < K && !any; ++k) {
              const int64_t a = a0 + k;
              const int32_t kd = __ldg(kind + a);
              if (kd == A_TRUE) {
                any = true;
              } else if (v) {
                const longlong2 t = atom_interval(kd, __ldg(flags + a), __ldg(lo + 2 * a),
                                                  __ldg(lo + 2 * a + 1), __ldg(hi + 2 * a),
                                                  __ldg(hi + 2 * a + 1));
                any = t.x <= key && key <= t.y;
              }
            }
            if (!any) fail |= 1u << j;
          }
        }
        mask &= ~fail;
      }
      store_mask(m + (int64_t)n * R + 32 * w, mask, nr);
      count += __popc(mask);
      if (mask != 0 && first == INT_MAX) first = 32 * w + __ffs(mask) - 1;
    }
    // the context's lanes are W aligned lanes of one warp: a butterfly over
    // them sums the counts and takes the lowest matching rule
    for (int o = W >> 1; o > 0; o >>= 1) {
      count += __shfl_xor_sync(0xffffffffu, count, o);
      first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    }
    if (live && sl == 0) {
      counts[n] = count;
      selected[n] = count > 0 ? first : -1;
    }
  }
}

// The lanes layout's shape for an [I, R, K] table, fixed before the launch:
// W lanes per context (ceil(R / 32) rule words rounded up to a power of two,
// at most 32); a tile's keys are staged when they take at most kKeysSmem
// bytes, the table's atoms (16 bytes each, the rules padded to whole words,
// plus a 4-byte always-true mask per input and word) when everything staged
// fits in kSmemLimit; `shared` is the byte layout k_decision_lanes reads.
struct LanesPlan {
  int W, stage_atoms, stage_keys;
  size_t shared;
};

constexpr size_t kKeysSmem = 32 * 1024;
constexpr size_t kSmemLimit = 200 * 1024;

LanesPlan lanes_plan(int I, int R, int K) {
  const int nw = (R + 31) / 32;
  LanesPlan p;
  p.W = 1;
  while (p.W < nw && p.W < 32) p.W *= 2;
  const size_t C = kLaneThreads / p.W;
  const size_t keys = C * I * (sizeof(int2) + 1);
  const size_t atoms = (size_t)I * K * 32 * nw * sizeof(longlong2) + (size_t)I * nw * 4;
  p.stage_keys = keys <= kKeysSmem;
  const size_t staged_keys = p.stage_keys ? keys : 0;
  p.stage_atoms = atoms + staged_keys <= kSmemLimit;
  p.shared = staged_keys + (p.stage_atoms ? atoms : 0);
  return p;
}

// Blocks of the lanes layout per SM at `shared` bytes, and the SM count of
// the current device: queried once per (device, shared bytes) and kept in a
// direct-mapped cache of packed words (shared << 32 | SMs << 16 | blocks),
// so a launch costs no occupancy query. A miss also raises the kernel's
// dynamic shared-memory limit on that device to kSmemLimit.
cudaError_t lanes_occupancy(size_t shared, int* per_sm, int* sms) {
  constexpr int kMaxDevices = 64, kSlots = 16;
  static std::atomic<uint64_t> cache[kMaxDevices][kSlots];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<uint64_t>* slot =
      dev < kMaxDevices ? &cache[dev][(shared / 16) % kSlots] : nullptr;
  if (slot != nullptr) {
    const uint64_t v = slot->load(std::memory_order_relaxed);
    if (v != 0 && (v >> 32) == shared) {
      *sms = (int)((v >> 16) & 0xffff);
      *per_sm = (int)(v & 0xffff);
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(k_decision_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k_decision_lanes, kLaneThreads,
                                                      shared);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (slot != nullptr) {
    slot->store(((uint64_t)shared << 32) | ((uint64_t)(*sms & 0xffff) << 16) |
                    (uint64_t)(*per_sm & 0xffff),
                std::memory_order_relaxed);
  }
  return cudaSuccess;
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

// The lanes layout: one launch of persistent blocks over N >= 1 contexts on
// `stream`, shaped by lanes_plan (the blocks the card holds at once, at most
// one per tile). Returns the first error of the occupancy query or
// cudaGetLastError() after the launch.
int zt_decision_lanes(const int32_t* kind, const int32_t* flags, const int32_t* lo,
                      const int32_t* hi, const int32_t* keys, const uint8_t* valid, int N,
                      int I, int R, int K, uint8_t* m, int32_t* counts, int32_t* selected,
                      void* stream) {
  const LanesPlan p = lanes_plan(I, R, K);
  int per_sm = 0, sms = 0;
  cudaError_t err = lanes_occupancy(p.shared, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int C = kLaneThreads / p.W;
  const long long tiles = ((long long)N + C - 1) / C;
  const int blocks = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  k_decision_lanes<<<blocks, kLaneThreads, p.shared, (cudaStream_t)stream>>>(
      kind, flags, lo, hi, keys, valid, N, I, R, K, p.W, p.stage_atoms, p.stage_keys, m,
      counts, selected);
  return (int)cudaGetLastError();
}

// The lanes layout's plan for an [I, R, K] table on the current device: lanes
// per context, whether it stages the atoms and the keys, its dynamic shared
// memory, its blocks per SM and its threads per block.
int zt_decision_lanes_plan(int I, int R, int K, int32_t* W, int32_t* stage_atoms,
                           int32_t* stage_keys, int32_t* shared, int32_t* per_sm,
                           int32_t* threads) {
  const LanesPlan p = lanes_plan(I, R, K);
  int sms = 0, n = 0;
  cudaError_t err = lanes_occupancy(p.shared, &n, &sms);
  if (err != cudaSuccess) return (int)err;
  *W = p.W;
  *stage_atoms = p.stage_atoms;
  *stage_keys = p.stage_keys;
  *shared = (int32_t)p.shared;
  *per_sm = n;
  *threads = kLaneThreads;
  return 0;
}

int zt_decision_max_atoms() { return 64; }

}  // extern "C"
