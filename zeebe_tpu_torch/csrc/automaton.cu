// Hand-written Hopper kernels for the BPMN automaton (sm_90a).
//
// What they replace (the reference's jax.jit programs, lowered by XLA):
//   - zeebe_tpu/ops/automaton.py::step (:366), with _eval_program (:213),
//     _eval_conditions (:281), _scope_occupancy (:295), _scope_drained
//     (:316) and _mi_spawnable (:342): one lock-step of every live token.
//   - run_collect (:704) with _pack_events (:659): up to n_steps steps with
//     an early exit, one packed int32 event row per step.
//   - run_to_completion (:773): steps with auto jobs and no events until no
//     token is live.
//   - zeebe_tpu/parallel/mesh.py::make_sharded_step (:102): one step of NS
//     independent shard blocks; the counters come back as the input plus
//     the sum of the shards' deltas (int32, wrapping), overflow as the OR of
//     the shards' flags.
//   - zeebe_tpu/parallel/mesh_runner.py::MeshKernelRunner._sharded_collect
//     (:233): run_collect of NS shard blocks, each leaving the chunk on its
//     own quiescence, with per-shard counters and packed rows
//     [n_steps, NS * row_len], shard s at columns [s*row_len, (s+1)*row_len).
//
// The shard axis. The reference puts one shard on each device of a mesh;
// here all NS shard blocks live on one card. Every per-instance access uses
// the global row shard * I + inst (token inst values are local to their
// shard block, as under shard_map); the free-slot and request prefix sums
// restart at each shard; the control words (go, active, any live, scan
// totals) and the counters are per shard. With NS = 1 every kernel computes
// exactly what it did before the shard axis.
//
// What bounds them on an H100: a step must read once the tables and state
// arrays its KernelConfig uses, and write once those it changes
// (join_counts is written only with joins, mi_left read and written only
// with MI, var_slots read only with conditions). At the serving geometry
// (the mixed set: I = 2048 instances, T = 8192 token slots, E = 13, FO = 3;
// joins and conditions) that is 448,282 bytes, 0.13 us at 3.35 TB/s; at the
// kernel-ceiling geometry (one_task, I = T = 1<<20, no flag set) 50,331,738
// bytes, 15 us (chip_smoke.py computes and prints every bound). A step is a
// chain of dependent phases (classify, rank joins, prefix-sum the free and
// placed slots, scatter, complete instances, recount scopes, count active
// tokens), each a few microseconds of latency-bound work, so at the serving
// geometry the dependencies between phases bound the step, not bytes.
//
// Two paths compute the same function from the same per-item device
// functions (classify_token, join_rank_request, place_request, ...):
//
//   - The fused chunk (k_chunk, zt_collect_fused), for shards of up to
//     zt_fused_max_tokens() slots (the serving geometry, and every group
//     of a set up to 8 live tokens per instance): ONE launch per chunk. Each shard is one thread-block cluster of
//     CLUSTER blocks that loops over the chunk's steps; no cluster waits on
//     another, since no lock-step of one shard reads another's state. Block
//     b of a cluster owns a contiguous range of the shard's tokens, of their
//     requests (token t owns requests t*FO .. t*FO+FO-1) and of its
//     instances. Phases that read what another block wrote are separated by
//     the hardware cluster barrier (barrier.cluster.arrive.release +
//     wait.acquire, which orders global memory too); the prefix sums run
//     per block over its contiguous range with block totals exchanged
//     through distributed shared memory. The early exit is a per-cluster
//     decision every block reaches from the same eight block totals, so a
//     quiet shard's cluster leaves the loop and zeroes the rows it never
//     wrote. The working set of a shard at the serving geometry (0.45 MB of
//     state, ~1 MB of scratch, 1.3 MB of rows per chunk) stays in the 50 MB
//     L2 across phases.
//   - The chain (zt_prepare + zt_steps), for larger shards and for
//     run_to_completion: every phase one grid-wide launch over all shards
//     (blockIdx.y, or blockIdx.z for the scan, or blockIdx.x for the
//     per-shard control kernels, is the shard), ~10 launches per step, all
//     enqueued back to back; the early exit is a per-shard device flag (go)
//     that every block reads first.
//
// Both: kernels allocate nothing (the wrapper hands in the working state,
// copied from the caller's so the API stays functional, and one int32
// scratch buffer; arrays the config never writes are shared with the
// caller's state). Join ranks need no sort: each join request links itself
// into a per-key list (atomicExch on the key's head) and then counts the
// list entries with a lower flat index, the rank the reference's stable
// argsort gives whatever the list's order; keys are global rows, so two
// shards' arrivals never share a list. Integer atomics only where the order
// cannot show (sums of int32 wrap mod 2^32 in any order), so every output is
// bit-exact and deterministic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// kernel opcodes (ops/tables.py)
constexpr int K_NONE = 0, K_TASK = 2, K_EXCLUSIVE = 3, K_JOIN = 5, K_CATCH = 7,
              K_SCOPE = 8, K_HOST = 9, K_MI = 10, K_INCLUSIVE = 11;
// token phases
constexpr int PHASE_AT = 0, PHASE_WAIT = 1, PHASE_DONE = 2, PHASE_STALLED = 3;
// condition VM opcodes
constexpr int OP_PUSH_CONST = 1, OP_PUSH_VAR = 2, OP_LT = 3, OP_LE = 4, OP_GT = 5,
              OP_GE = 6, OP_EQ = 7, OP_NE = 8, OP_AND = 9, OP_OR = 10, OP_NOT = 11,
              OP_NEG = 16;
constexpr int MAX_PROG_LEN = 24, STACK_DEPTH = 8;

// KernelConfig bits
constexpr int CFG_JOINS = 1, CFG_CONDITIONS = 2, CFG_SCOPES = 4, CFG_MI = 8;
// run modes
constexpr int MODE_AUTO_JOBS = 1, MODE_EMIT = 2, MODE_COLLECT = 4, MODE_COMPLETION = 8;
// ctl slots, CTL_N per shard
constexpr int CTL_GO = 0, CTL_ACTIVE = 1, CTL_ANY_LIVE = 2, CTL_STEPS = 3,
              CTL_FREE_TOTAL = 4, CTL_REQ_TOTAL = 5, CTL_N = 8;
// tok_flags bits
constexpr int TF_COMPLETING = 1, TF_SPAWNED = 2;
// req_flags bits
constexpr int RF_TAKE = 1, RF_JOIN = 2;

constexpr int BLOCK = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// the fused chunk: blocks per shard cluster (8 is the portable cluster
// size), threads per block (1024 at 64 registers beat 512 at 128 on an
// H100, PERF.md), and the largest shard it takes: its lock-step grows with
// the shard's tokens per thread, while the chain's spreads over every SM,
// so above 1 << 14 slots the chain is faster (chip_smoke.py's A/B)
constexpr int CLUSTER = 8;
constexpr int FUSED_THREADS = 1024;
constexpr int FUSED_MAX_TOKENS = 1 << 14;

}  // namespace

extern "C" {

struct ZtTables {
  const int32_t* kernel_op;     // [D, E]
  const int32_t* in_count;      // [D, E]
  const int32_t* out_count;     // [D, E]
  const int32_t* out_target;    // [D, E, FO]
  const int32_t* out_cond;      // [D, E, FO]
  const int32_t* default_slot;  // [D, E]
  const int32_t* scope_start;   // [D, E]
  const int8_t* in_scope;       // [D, E, E]
  const int8_t* mi_sequential;  // [D, E]
  const int32_t* cond_ops;      // [C, MAX_PROG_LEN]
  const int32_t* cond_args;     // [C, MAX_PROG_LEN, 2]
  int32_t D, E, FO, C;
};

// NS shard blocks of T token slots and I instances each; the arrays hold
// the blocks back to back, and token inst values are local to their block.
struct ZtState {
  int32_t* elem;          // [NS*T]
  int32_t* phase;         // [NS*T]
  int32_t* inst;          // [NS*T]
  const int32_t* def_of;  // [NS*I]
  const int32_t* var_slots;  // [NS*I, S, 2]
  int32_t* join_counts;   // [NS*I, E]
  int32_t* mi_left;       // [NS*I, E]
  uint8_t* done;          // [NS*I] bool
  uint8_t* incident;      // [NS*I] bool
  int32_t* transitions;   // one per shard (stride ctr_stride)
  int32_t* jobs_created;  // one per shard
  int32_t* completed;     // one per shard
  uint8_t* overflow;      // one per shard, bool
  int32_t T, I, S, NS;
  int32_t ctr_stride;     // 1: a counter per shard; 0: one counter for all
};

struct ZtScratch {
  int32_t* ctl;           // [NS*CTL_N] (the chain only)
  int32_t* occ;           // [NS*I*E] live tokens inside each scope
  int32_t* pend;          // [NS*I*E] unconsumed join arrivals inside each scope
  int32_t* arrivals;      // [NS*I*E] join arrivals this step
  int32_t* consumed;      // [NS*I*E] join arrivals consumed this step
  int32_t* head;          // [NS*I*E] last join request of the key (-1 none)
  int32_t* tpi;           // [NS*I]   live tokens per instance after the step
  int32_t* pending;       // [NS*I]   join arrivals pending per instance (the fused chunk)
  int32_t* req_target;    // [NS*T*FO]
  int32_t* req_flags;     // [NS*T*FO]
  int32_t* next;          // [NS*T*FO] join request list links
  int32_t* proceeds;      // [NS*T*FO] 0/1
  int32_t* place_rank;    // [NS*T*FO] rank within the shard
  int32_t* free_flag;     // [NS*T] 0/1
  int32_t* tok_flags;     // [NS*T]
  int32_t* tok_inst;      // [NS*T] start-of-step inst (local to the shard)
  int32_t* tok_elem;      // [NS*T] start-of-step elem
  int32_t* slot_of_rank;  // [NS*T] local slot of each free rank
  int32_t* block_sums;    // [NS*(nb_free + nb_req)] (the chain only)
};

}  // extern "C"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Every lane of the warp must call these (no divergent early return). A
// warp never spans two shards: each block works on one shard.
__device__ __forceinline__ void warp_add(int32_t* dst, int v) {
  int s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(dst, s);
}

__device__ __forceinline__ void warp_flag(int32_t* dst, bool v) {
  if (__any_sync(0xffffffffu, v) && (threadIdx.x & 31) == 0) *dst = 1;
}

// the packed row of shard s for this step (row_len = T*(2+FO) + 2 ints)
__device__ __forceinline__ int32_t* shard_row(int32_t* row, int s, int T, int FO) {
  return row ? row + (int64_t)s * ((int64_t)T * (2 + FO) + 2) : nullptr;
}

// One condition program against one instance's slots (reference
// _eval_program). Stack reads clamp into [0, DEPTH) like the reference's
// gathers; a NOP writes nothing (the reference's dropped scatter). The stack
// is a plain array indexed by sp, so it lives in local memory (L1). An
// earlier form that kept it in registers through unrolled selects returned
// false for every program on an H100 (nvcc 12.8, sm_90a); its cause was not
// found (ROADMAP section C). The VM runs only up to the last non-NOP op:
// a NOP (op 0) writes nothing and leaves sp as it is, so the trailing
// padding of a short program changes nothing (the loads of the 24 ops are
// independent; the interpreted ops are a dependent chain through sp).
__device__ bool eval_program(const int32_t* ops, const int32_t* args,
                             const int32_t* slots, int S) {
  int len = 0;
#pragma unroll
  for (int p = 0; p < MAX_PROG_LEN; ++p) {
    if (ops[p] != 0) len = p + 1;
  }
  int stk[STACK_DEPTH * 2];  // (hi, lo) per entry
  for (int k = 0; k < STACK_DEPTH * 2; ++k) stk[k] = 0;
  int sp = 0;
  for (int p = 0; p < len; ++p) {
    const int op = ops[p];
    const int a0 = args[2 * p], a1 = args[2 * p + 1];
    int ph = a0, pl = a1;
    if (op == OP_PUSH_VAR) {
      int v = a0 < 0 ? a0 + S : a0;
      v = clampi(v, 0, S - 1);
      ph = slots[2 * v];
      pl = slots[2 * v + 1];
    }
    const int ia = clampi(sp - 2, 0, STACK_DEPTH - 1);
    const int ib = clampi(sp - 1, 0, STACK_DEPTH - 1);
    const int ah = stk[2 * ia], al = stk[2 * ia + 1];
    const int bh = stk[2 * ib], bl = stk[2 * ib + 1];
    const bool lt = ah < bh || (ah == bh && al < bl);
    const bool eq = ah == bh && al == bl;
    bool bv = false;
    if (op == OP_LT) bv = lt;
    else if (op == OP_LE) bv = lt || eq;
    else if (op == OP_GT) bv = !(lt || eq);
    else if (op == OP_GE) bv = !lt;
    else if (op == OP_EQ) bv = eq;
    else if (op == OP_NE) bv = !eq;
    else if (op == OP_AND) bv = ah > 0 && bh > 0;
    else if (op == OP_OR) bv = ah > 0 || bh > 0;
    const bool is_push = op == OP_PUSH_CONST || op == OP_PUSH_VAR;
    const bool is_un = op == OP_NOT || op == OP_NEG;
    const bool is_bin = op >= OP_LT && op <= OP_OR;
    int nh, nl;
    if (is_push) {
      nh = ph; nl = pl;
    } else if (is_bin) {
      nh = bv ? 1 : 0; nl = 0;
    } else if (op == OP_NOT) {
      // 1 - min(b, 1), in unsigned arithmetic so INT32_MIN wraps as in JAX
      nh = (int)(1u - (unsigned)(bh < 1 ? bh : 1)); nl = 0;
    } else {
      // NEG: bitwise NOT of both planes; key(+0.0) = (0, INT32_MIN) stays
      const bool zero = bh == 0 && bl == INT32_MIN;
      nh = zero ? bh : ~bh; nl = zero ? bl : ~bl;
    }
    if (is_push || is_bin || is_un) {
      const int wp = clampi(is_push ? sp : (is_bin ? sp - 2 : sp - 1), 0, STACK_DEPTH - 1);
      stk[2 * wp] = nh;
      stk[2 * wp + 1] = nl;
    }
    sp += is_push ? 1 : (is_bin ? -1 : 0);
  }
  return stk[2 * clampi(sp - 1, 0, STACK_DEPTH - 1)] > 0;
}

// ---------------------------------------------------------------------------
// Per-item work, shared by both paths. s is the shard; token, request and
// instance indices are local to it.

// copy-in of token slot g (global index) and its start-of-run scratch
__device__ __forceinline__ void prepare_token(const ZtState& in, const ZtState& st,
                                              int64_t g) {
  st.elem[g] = in.elem[g];
  st.phase[g] = in.phase[g];
  st.inst[g] = in.inst[g];
}

// copy-in of (instance, element) key x (global index) and its scratch.
// join_counts / mi_left are shared with the caller's state (same pointer)
// when the config never writes them: nothing to copy then.
__device__ __forceinline__ void prepare_key(const ZtState& in, const ZtState& st,
                                            const ZtScratch& sc, int64_t x) {
  if (st.join_counts != in.join_counts) st.join_counts[x] = in.join_counts[x];
  if (st.mi_left != in.mi_left) st.mi_left[x] = in.mi_left[x];
  sc.occ[x] = 0;
  sc.pend[x] = 0;
  sc.arrivals[x] = 0;
  sc.consumed[x] = 0;
  sc.head[x] = -1;
}

__device__ __forceinline__ void prepare_instance(const ZtState& in, const ZtState& st,
                                                 const ZtScratch& sc, int64_t x) {
  st.done[x] = in.done[x];
  st.incident[x] = in.incident[x];
  sc.tpi[x] = 0;
}

// a replicated input counter (ctr_stride 0) starts every shard
__device__ __forceinline__ void prepare_counters(const ZtState& in, const ZtState& st,
                                                 int64_t s) {
  const int64_t c = s * in.ctr_stride;
  st.transitions[s] = in.transitions[c];
  st.jobs_created[s] = in.jobs_created[c];
  st.completed[s] = in.completed[c];
  st.overflow[s] = in.overflow[c];
}

// occupancy of token x: one for each scope of its instance that holds it
// (occ must be zero before, and counted after, every block's finish)
__device__ __forceinline__ void occupancy_token(const ZtTables& tb, const ZtState& st,
                                                const ZtScratch& sc, int s, int x) {
  const int E = tb.E;
  const int64_t g = (int64_t)s * st.T + x;
  const int e = st.elem[g];
  if (e < 0) return;
  const int64_t gi = (int64_t)s * st.I + st.inst[g];
  const int d = st.def_of[gi];
  const int8_t* row = tb.in_scope + ((int64_t)d * E + e) * E;
  for (int c = 0; c < E; ++c) {
    if (row[c]) atomicAdd(&sc.occ[gi * E + c], 1);
  }
}

// pending join arrivals inside scope c of an instance, key x = i*E + c
__device__ __forceinline__ void occupancy_key(const ZtTables& tb, const ZtState& st,
                                              const ZtScratch& sc, int s, int x) {
  const int E = tb.E;
  const int64_t gi = (int64_t)s * st.I + x / E;
  const int c = x % E;
  const int d = st.def_of[gi];
  unsigned sum = 0;
  for (int e = 0; e < E; ++e) {
    sum += (unsigned)st.join_counts[gi * E + e] *
           (unsigned)tb.in_scope[((int64_t)d * E + e) * E + c];
  }
  sc.pend[gi * E + c] = (int)sum;
}

// classify token t, run its gateway conditions, route, and emit its
// placement requests; returns its transitions, jobs, and whether it stays
// live
__device__ __forceinline__ void classify_token(const ZtTables& tb, const ZtState& st,
                                               const ZtScratch& sc, int mode, int cfg,
                                               int32_t* row, int s, int t, int& trans,
                                               int& jobs, bool& keep_live) {
  const int E = tb.E, FO = tb.FO;
  const int64_t g = (int64_t)s * st.T + t;
  const int e = st.elem[g];
  const int ph = st.phase[g];
  const int i = st.inst[g];
  const int64_t gi = (int64_t)s * st.I + i;
  const bool live = e >= 0;
  const int e0 = e < 0 ? 0 : e;
  const int d = st.def_of[gi];
  const int64_t de = (int64_t)d * E + e0;
  const int64_t ie = gi * E + e0;
  const int op = live ? tb.kernel_op[de] : K_NONE;
  const bool stalled = ph == PHASE_STALLED;
  const bool is_task = op == K_TASK;
  const bool is_wait = is_task || op == K_CATCH;
  const bool is_scope = op == K_SCOPE;
  const bool is_host = op == K_HOST;
  const bool is_mi = op == K_MI;
  const bool executing = live && ph == PHASE_AT && !stalled;
  const bool arriving_task = executing && is_wait;
  const bool arriving_scope = executing && is_scope;
  const bool arriving_host = executing && is_host;
  const bool arriving_mi = executing && is_mi;
  const bool pass_attempt = executing && !is_wait && !is_scope && !is_host && !is_mi;
  const bool waiting_done = live && is_wait &&
      ph == ((mode & MODE_AUTO_JOBS) ? PHASE_WAIT : PHASE_DONE);

  bool scope_resume = false, mi_spawn = false;
  if (cfg & (CFG_SCOPES | CFG_MI)) {
    const bool drained_here = sc.occ[ie] == 0 && sc.pend[ie] == 0;
    bool scope_like = op == K_SCOPE;
    if (cfg & CFG_MI) scope_like = scope_like || (op == K_MI && st.mi_left[ie] == 0);
    scope_resume = live && scope_like && ph == PHASE_WAIT && drained_here;
    if (cfg & CFG_MI) {
      const bool seq = tb.mi_sequential[de] > 0;
      mi_spawn = live && op == K_MI && ph == PHASE_WAIT && st.mi_left[ie] > 0 &&
                 (!seq || drained_here);
    }
  }

  const bool is_excl = op == K_EXCLUSIVE;
  const bool is_incl = op == K_INCLUSIVE;
  const int32_t* targets = tb.out_target + de * FO;
  unsigned cond_true = 0;
  if ((cfg & CFG_CONDITIONS) && (is_excl || is_incl) && pass_attempt) {
    const int32_t* conds = tb.out_cond + de * FO;
    const int32_t* slots = st.var_slots + gi * st.S * 2;
    for (int fo = 0; fo < FO; ++fo) {
      const int c = conds[fo];
      if (c >= 0 &&
          eval_program(tb.cond_ops + (int64_t)c * MAX_PROG_LEN,
                       tb.cond_args + (int64_t)c * MAX_PROG_LEN * 2, slots, st.S)) {
        cond_true |= 1u << fo;
      }
    }
  }
  const bool any_true = cond_true != 0;
  const int first_true = any_true ? __ffs(cond_true) - 1 : 0;
  const int dflt = tb.default_slot[de];
  const int excl_choice = any_true ? first_true : dflt;
  const bool no_match = (is_excl || is_incl) && pass_attempt && !any_true && dflt < 0;
  const bool full_pass = pass_attempt && !no_match;
  const bool completing = full_pass || waiting_done || scope_resume;
  const int out_count = tb.out_count[de];

  unsigned take = 0;
  for (int fo = 0; fo < FO; ++fo) {
    bool tk;
    if (is_excl) tk = fo == excl_choice && excl_choice >= 0;
    else if (is_incl) tk = ((cond_true >> fo) & 1u) || (fo == dflt && !any_true && dflt >= 0);
    else tk = fo < out_count;
    if (tk && completing && targets[fo] >= 0) take |= 1u << fo;
  }
  const bool spawning = arriving_scope || arriving_mi || mi_spawn;
  for (int fo = 0; fo < FO; ++fo) {
    const int64_t r = g * FO + fo;
    int rt = ((take >> fo) & 1u) ? targets[fo] : -1;
    if (fo == 0 && (cfg & (CFG_SCOPES | CFG_MI)) && spawning) rt = tb.scope_start[de];
    sc.req_target[r] = rt;
    int rf = ((take >> fo) & 1u) ? RF_TAKE : 0;
    bool proceeds = rt >= 0;
    if ((cfg & CFG_JOINS) && rt >= 0 && tb.kernel_op[(int64_t)d * E + rt] == K_JOIN) {
      const int64_t key = gi * E + rt;
      atomicAdd(&sc.arrivals[key], 1);
      sc.next[r] = atomicExch(&sc.head[key], (int)r);
      rf |= RF_JOIN;
      proceeds = false;  // decided by join_rank_request
    }
    sc.req_flags[r] = rf;
    sc.proceeds[r] = proceeds ? 1 : 0;
  }

  if (arriving_task || arriving_scope || arriving_host || arriving_mi) {
    st.phase[g] = PHASE_WAIT;
  }
  if (no_match) {
    st.phase[g] = PHASE_STALLED;
    st.incident[gi] = 1;
  }
  keep_live = live && !completing;
  if (keep_live) atomicAdd(&sc.tpi[gi], 1);
  sc.tok_inst[g] = i;
  sc.tok_elem[g] = e;
  sc.tok_flags[g] = (completing ? TF_COMPLETING : 0) |
                    (((cfg & CFG_MI) && (arriving_mi || mi_spawn)) ? TF_SPAWNED : 0);
  sc.free_flag[g] = (!live || completing) ? 1 : 0;

  if (mode & MODE_EMIT) {
    const int task_arrive = arriving_task || arriving_scope || arriving_mi;
    const int task_done = waiting_done || scope_resume;
    const int flags = (full_pass ? 1 : 0) | (task_arrive << 1) | (task_done << 2) |
                      ((no_match ? 1 : 0) << 3);
    // elem << 5 shifted as unsigned: elem == -1 gives -32 without UB
    row[(int64_t)t * (2 + FO)] = flags | (int)((unsigned)e << 5);
    row[(int64_t)t * (2 + FO) + 1] = i;
  }
  trans = (full_pass ? 4 : 0) + ((arriving_task || arriving_scope || arriving_mi) ? 2 : 0) +
          ((waiting_done || scope_resume) ? 2 : 0) + __popc(take);
  jobs = (arriving_task && is_task) ? 1 : 0;
}

// rank join request rl among the same (instance, join) key by flat index
// and decide whether it fills the join
__device__ __forceinline__ void join_rank_request(const ZtTables& tb, const ZtState& st,
                                                  const ZtScratch& sc, int s, int64_t rl) {
  const int E = tb.E, FO = tb.FO;
  const int64_t r = (int64_t)s * st.T * FO + rl;
  if (!(sc.req_flags[r] & RF_JOIN)) return;
  const int64_t gi = (int64_t)s * st.I + sc.tok_inst[r / FO];
  const int rt = sc.req_target[r];
  const int64_t key = gi * E + rt;
  const int c = sc.arrivals[key];
  unsigned rank = 0;
  if (c > 1) {
    int m = sc.head[key];
    for (int j = 0; j < c && m >= 0; ++j) {
      if (m < r) ++rank;
      m = sc.next[m];
    }
  }
  const int d = st.def_of[gi];
  int arity = tb.in_count[(int64_t)d * E + rt];
  if (arity < 1) arity = 1;
  const int count_after = (int)((unsigned)st.join_counts[key] + rank + 1u);
  int m = count_after % arity;
  if (m < 0) m += arity;  // floor modulo, as jnp's %
  if (m == 0) {
    atomicAdd(&sc.consumed[key], arity);
    sc.proceeds[r] = 1;
  }
}

// scatter request rl into the shard's freed slot of its rank, write its
// dest|take column, and spend one MI child per spawning body
__device__ __forceinline__ void place_request(const ZtTables& tb, const ZtState& st,
                                              const ZtScratch& sc, int mode, int cfg,
                                              int32_t* row, int s, int64_t rl,
                                              int free_total, bool& placed, bool& ovf) {
  const int E = tb.E, FO = tb.FO;
  const int64_t tok0 = (int64_t)s * st.T, i0 = (int64_t)s * st.I;
  const int64_t r = tok0 * FO + rl;
  const int64_t t = rl / FO;
  const int fo = (int)(rl - t * FO);
  int dest = st.T;
  if (sc.proceeds[r]) {
    const int pr = sc.place_rank[r];
    if (pr < free_total) {
      const int slot = sc.slot_of_rank[tok0 + pr];
      const int i = sc.tok_inst[tok0 + t];
      st.elem[tok0 + slot] = sc.req_target[r];
      st.inst[tok0 + slot] = i;
      st.phase[tok0 + slot] = PHASE_AT;
      atomicAdd(&sc.tpi[i0 + i], 1);
      dest = slot;
      placed = true;
    } else {
      ovf = true;
    }
  }
  if (mode & MODE_EMIT) {
    const unsigned take = (sc.req_flags[r] & RF_TAKE) ? 1u : 0u;
    row[t * (2 + FO) + 2 + fo] = (int)((unsigned)dest | (take << 16));
  }
  if ((cfg & CFG_MI) && fo == 0 && (sc.tok_flags[tok0 + t] & TF_SPAWNED)) {
    const int e = sc.tok_elem[tok0 + t];
    atomicAdd(&st.mi_left[(i0 + sc.tok_inst[tok0 + t]) * E + (e < 0 ? 0 : e)], -1);
  }
}

// key k = gi*E + e at the end of a step: apply the step's join arrivals
// and reset its per-key scratch; returns its join count after the step
__device__ __forceinline__ unsigned finish_key(const ZtState& st, const ZtScratch& sc,
                                               int cfg, int64_t k) {
  unsigned jc = (unsigned)st.join_counts[k];
  if (cfg & CFG_JOINS) {
    jc += (unsigned)sc.arrivals[k] - (unsigned)sc.consumed[k];
    st.join_counts[k] = (int)jc;
    sc.arrivals[k] = 0;
    sc.consumed[k] = 0;
    sc.head[k] = -1;
  }
  if (cfg & (CFG_SCOPES | CFG_MI)) sc.occ[k] = 0;  // recounted by the occupancy phase
  return jc;
}

// instance i (global row gi) with n live tokens and `pending` join arrivals
// (their sum over its keys, wrapping): complete it when both are 0; returns
// 1 when it completed in this step
__device__ __forceinline__ int complete_instance(const ZtState& st, int mode, int32_t* row,
                                                 int FO, int64_t gi, int i, int n,
                                                 unsigned pending) {
  if (!st.done[gi] && n == 0 && pending == 0) {
    st.done[gi] = 1;
    if ((mode & MODE_EMIT) && i < st.T) row[(int64_t)i * (2 + FO)] |= 16;
    return 1;
  }
  return 0;
}

// instance i, all its keys in one thread (the chain)
__device__ __forceinline__ int finish_instance(const ZtTables& tb, const ZtState& st,
                                               const ZtScratch& sc, int mode, int cfg,
                                               int32_t* row, int s, int i) {
  const int E = tb.E;
  const int64_t gi = (int64_t)s * st.I + i;
  unsigned pending = 0;
  for (int e = 0; e < E; ++e) pending += finish_key(st, sc, cfg, gi * E + e);
  const int n = sc.tpi[gi];
  sc.tpi[gi] = 0;
  return complete_instance(st, mode, row, tb.FO, gi, i, n, pending);
}

// run_collect's post-step active count of token t (needs the recounted
// occ/pend)
__device__ __forceinline__ int active_token(const ZtTables& tb, const ZtState& st,
                                            const ZtScratch& sc, int cfg, int s, int t) {
  const int E = tb.E;
  const int64_t g = (int64_t)s * st.T + t;
  const int e = st.elem[g];
  const int ph = st.phase[g];
  const bool live = e >= 0;
  int a = (live && (ph == PHASE_AT || ph == PHASE_DONE)) ? 1 : 0;
  if (cfg & (CFG_SCOPES | CFG_MI)) {
    const int e0 = e < 0 ? 0 : e;
    const int64_t gi = (int64_t)s * st.I + st.inst[g];
    const int d = st.def_of[gi];
    const int64_t de = (int64_t)d * E + e0;
    const int64_t ie = gi * E + e0;
    const int op = live ? tb.kernel_op[de] : K_NONE;
    const bool drained_here = sc.occ[ie] == 0 && sc.pend[ie] == 0;
    bool scope_like = op == K_SCOPE;
    if (cfg & CFG_MI) scope_like = scope_like || (op == K_MI && st.mi_left[ie] == 0);
    a += (live && scope_like && ph == PHASE_WAIT && drained_here) ? 1 : 0;
    if (cfg & CFG_MI) {
      const bool seq = tb.mi_sequential[de] > 0;
      a += (live && op == K_MI && ph == PHASE_WAIT && st.mi_left[ie] > 0 &&
            (!seq || drained_here)) ? 1 : 0;
    }
  }
  return a;
}

// block-wide exclusive scan of one int per thread; returns the exclusive
// prefix and writes the block total to *total
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return excl;
}

// ---------------------------------------------------------------------------
// The fused chunk: one cluster of CLUSTER blocks per shard, one launch for
// the whole chunk. Every thread of the cluster reaches every cluster
// barrier (no early return), and the loop's exit is decided from values
// every block reads alike.

// [lo, hi) of n items cut into `parts` contiguous ranges, range `k`
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range part_of(int n, int parts, int k) {
  const int per = (n + parts - 1) / parts;
  const int lo = min(k * per, n);
  return {lo, min(lo + per, n)};
}

__global__ void __launch_bounds__(FUSED_THREADS, 1)
k_chunk(ZtTables tb, ZtState in, ZtState st, ZtScratch sc, int n_steps, int mode, int cfg,
        int32_t* out, int64_t row_len) {
  constexpr int NT = FUSED_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  // per block: its free slots, its placed requests, its active tokens
  __shared__ int totals[3];
  const int b = (int)cluster.block_rank();
  const int s = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int T = st.T, I = st.I, E = tb.E, FO = tb.FO;
  const int64_t tok0 = (int64_t)s * T, i0 = (int64_t)s * I;
  // this block's tokens (and their requests), instances and instance keys
  const Range tok = part_of(T, CLUSTER, b);
  const Range ins = part_of(I, CLUSTER, b);
  const int r_lo = tok.lo * FO, r_hi = tok.hi * FO;
  const int k_lo = ins.lo * E, k_hi = ins.hi * E;
  // this thread's contiguous segments of the block's tokens and requests,
  // in the order of the shard's prefix sums
  const Range fseg = part_of(tok.hi - tok.lo, NT, tid);
  const Range rseg = part_of(r_hi - r_lo, NT, tid);
  const bool scoped = cfg & (CFG_SCOPES | CFG_MI);
  const bool collect = mode & MODE_COLLECT;

  for (int x = tok.lo + tid; x < tok.hi; x += NT) prepare_token(in, st, tok0 + x);
  for (int x = k_lo + tid; x < k_hi; x += NT) prepare_key(in, st, sc, i0 * E + x);
  for (int x = ins.lo + tid; x < ins.hi; x += NT) {
    prepare_instance(in, st, sc, i0 + x);
    sc.pending[i0 + x] = 0;
  }
  if (b == 0 && tid == 0) prepare_counters(in, st, s);
  cluster.sync();
  if (scoped) {
    for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, s, x);
    for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, s, x);
    cluster.sync();
  }

  int k = 0;
  while (k < n_steps) {
    int32_t* row = out ? shard_row(out + (int64_t)k * row_len * st.NS, s, T, FO) : nullptr;
    // classify (then rank joins against every block's links)
    int trans = 0, jobs = 0;
    for (int t = tok.lo + tid; t < tok.hi; t += NT) {
      int tr, jb;
      bool keep_live;
      classify_token(tb, st, sc, mode, cfg, row, s, t, tr, jb, keep_live);
      trans += tr;
      jobs += jb;
    }
    warp_add(&st.transitions[s], trans);
    warp_add(&st.jobs_created[s], jobs);
    if (cfg & CFG_JOINS) {
      cluster.sync();
      for (int r = r_lo + tid; r < r_hi; r += NT) join_rank_request(tb, st, sc, s, r);
    }
    __syncthreads();
    // prefix sums, pass 1: this block's free slots and placed requests are
    // final (its own classify and join ranks wrote them)
    int nf = 0, nr = 0;
    for (int x = fseg.lo; x < fseg.hi; ++x) nf += sc.free_flag[tok0 + tok.lo + x];
    for (int x = rseg.lo; x < rseg.hi; ++x) nr += sc.proceeds[tok0 * FO + r_lo + x];
    int block_free, block_req;
    const int excl_free = block_exclusive_scan(nf, &block_free);
    const int excl_req = block_exclusive_scan(nr, &block_req);
    if (tid == 0) {
      totals[0] = block_free;
      totals[1] = block_req;
    }
    cluster.sync();
    // pass 2: offsets from the lower blocks' totals (distributed shared
    // memory), then ranks: slot_of_rank for free slots (a completing
    // token's slot is freed), place_rank for requests
    int free_total = 0, free_base = 0, req_base = 0;
    for (int q = 0; q < CLUSTER; ++q) {
      const int* other = cluster.map_shared_rank(totals, q);
      free_total += other[0];
      if (q < b) {
        free_base += other[0];
        req_base += other[1];
      }
    }
    int rank = free_base + excl_free;
    for (int x = tok.lo + fseg.lo; x < tok.lo + fseg.hi; ++x) {
      if (sc.free_flag[tok0 + x]) {
        sc.slot_of_rank[tok0 + rank] = x;
        if (sc.tok_flags[tok0 + x] & TF_COMPLETING) st.elem[tok0 + x] = -1;
        ++rank;
      }
    }
    rank = req_base + excl_req;
    for (int x = r_lo + rseg.lo; x < r_lo + rseg.hi; ++x) {
      if (sc.proceeds[tok0 * FO + x]) sc.place_rank[tok0 * FO + x] = rank++;
    }
    cluster.sync();
    // place
    bool ovf = false;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      bool placed = false;
      place_request(tb, st, sc, mode, cfg, row, s, r, free_total, placed, ovf);
    }
    if (__any_sync(0xffffffffu, ovf) && (tid & 31) == 0) st.overflow[s] = 1;
    cluster.sync();
    // finish: first the block's keys, one per thread (each instance's
    // pending arrivals summed by atomics), then its instances
    for (int x = k_lo + tid; x < k_hi; x += NT) {
      const unsigned jc = finish_key(st, sc, cfg, i0 * E + x);
      if (jc != 0) atomicAdd(&sc.pending[i0 + x / E], (int)jc);
    }
    __syncthreads();
    int newly = 0;
    for (int i = ins.lo + tid; i < ins.hi; i += NT) {
      const int64_t gi = i0 + i;
      const int n = atomicExch(&sc.tpi[gi], 0);
      const unsigned pending = (unsigned)atomicExch(&sc.pending[gi], 0);
      newly += complete_instance(st, mode, row, FO, gi, i, n, pending);
    }
    warp_add(&st.completed[s], newly);
    warp_add(&st.transitions[s], 2 * newly);
    if (scoped) {
      cluster.sync();
      for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, s, x);
      for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, s, x);
      cluster.sync();
    }
    // count active tokens (after the recount of scopes)
    int act = 0;
    if (collect) {
      for (int t = tok.lo + tid; t < tok.hi; t += NT) act += active_token(tb, st, sc, cfg, s, t);
    }
    int block_active;
    block_exclusive_scan(act, &block_active);
    if (tid == 0) totals[2] = block_active;
    cluster.sync();
    int active = 0;
    for (int q = 0; q < CLUSTER; ++q) active += cluster.map_shared_rank(totals, q)[2];
    if (row != nullptr && b == 0 && tid == 0) {
      const int64_t tail = (int64_t)T * (2 + FO);
      row[tail] = collect ? active : 0;
      row[tail + 1] = st.overflow[s] ? 1 : 0;
    }
    ++k;
    if (collect && active == 0) break;
  }
  // rows after the shard's quiescence stay zero
  if (out != nullptr) {
    for (int j = k; j < n_steps; ++j) {
      int32_t* row = shard_row(out + (int64_t)j * row_len * st.NS, s, T, FO);
      for (int64_t x = (int64_t)b * NT + tid; x < row_len; x += (int64_t)CLUSTER * NT) row[x] = 0;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The chain: one grid-wide launch per phase over all shards.

__global__ void k_prepare(ZtState in, ZtState st, ZtScratch sc, int64_t NIE, int mode,
                          int32_t* out, int64_t out_len) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t x0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t NT = (int64_t)st.NS * st.T, NI = (int64_t)st.NS * st.I;
  for (int64_t x = x0; x < NT; x += stride) prepare_token(in, st, x);
  for (int64_t x = x0; x < NIE; x += stride) prepare_key(in, st, sc, x);
  for (int64_t x = x0; x < NI; x += stride) prepare_instance(in, st, sc, x);
  if (out != nullptr) {
    for (int64_t x = x0; x < out_len; x += stride) out[x] = 0;
  }
  for (int64_t s = x0; s < st.NS; s += stride) {
    prepare_counters(in, st, s);
    int32_t* ctl = sc.ctl + s * CTL_N;
    for (int k = 0; k < CTL_N; ++k) ctl[k] = 0;
    // run_to_completion's loop test runs before its first step (k_any_live)
    ctl[CTL_GO] = (mode & MODE_COMPLETION) ? 0 : 1;
  }
}

// go = any token of the shard live (run_to_completion's loop condition,
// before step 1)
__global__ void k_any_live(ZtState st, ZtScratch sc) {
  const int s = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  warp_flag(&sc.ctl[s * CTL_N + CTL_GO],
            t < st.T && st.elem[(int64_t)s * st.T + t] >= 0);
}

// occ/pend for the current state. occ must be zero on entry (k_prepare, or
// k_finish_instances of the step before).
__global__ void k_occupancy(ZtTables tb, ZtState st, ZtScratch sc) {
  const int s = blockIdx.y;
  if (!sc.ctl[s * CTL_N + CTL_GO]) return;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < st.T) occupancy_token(tb, st, sc, s, x);
  if (x < st.I * tb.E) occupancy_key(tb, st, sc, s, x);
}

__global__ void k_classify(ZtTables tb, ZtState st, ZtScratch sc, int mode, int cfg,
                           int32_t* row0) {
  const int s = blockIdx.y;
  int32_t* ctl = sc.ctl + s * CTL_N;
  if (!ctl[CTL_GO]) return;
  int32_t* row = shard_row(row0, s, st.T, tb.FO);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int trans = 0, jobs = 0;
  bool keep_live = false;
  if (t < st.T) classify_token(tb, st, sc, mode, cfg, row, s, t, trans, jobs, keep_live);
  warp_add(&st.transitions[s], trans);
  warp_add(&st.jobs_created[s], jobs);
  warp_flag(&ctl[CTL_ANY_LIVE], keep_live);
}

__global__ void k_join_rank(ZtTables tb, ZtState st, ZtScratch sc) {
  const int s = blockIdx.y;
  if (!sc.ctl[s * CTL_N + CTL_GO]) return;
  const int64_t rl = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (rl < (int64_t)st.T * tb.FO) join_rank_request(tb, st, sc, s, rl);
}

// The scan's arrays for shard blockIdx.z: free_flag (grid.y 0) or proceeds
// (grid.y 1), their length in the shard, and the shard's tile sums.
struct ScanPart {
  const int32_t* a;
  int64_t n;
  int32_t* sums;
};

__device__ __forceinline__ ScanPart scan_part(const ZtState& st, const ZtScratch& sc,
                                              int FO, int nb_free, int nb_req) {
  const int s = blockIdx.z;
  const bool req = blockIdx.y == 1;
  const int64_t n = req ? (int64_t)st.T * FO : st.T;
  ScanPart p;
  p.a = (req ? sc.proceeds : sc.free_flag) + (int64_t)s * n;
  p.n = n;
  p.sums = sc.block_sums + (int64_t)s * (nb_free + nb_req) + (req ? nb_free : 0);
  return p;
}

// scan pass 1: tile sums of free_flag (grid.y 0) and proceeds (grid.y 1)
__global__ void k_scan_sums(ZtState st, ZtScratch sc, int FO, int nb_free, int nb_req) {
  if (!sc.ctl[blockIdx.z * CTL_N + CTL_GO]) return;
  const int nb = blockIdx.y == 1 ? nb_req : nb_free;
  if ((int)blockIdx.x >= nb) return;
  const ScanPart p = scan_part(st, sc, FO, nb_free, nb_req);
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  int v = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < p.n) v += p.a[base + k];
  }
  int total;
  block_exclusive_scan(v, &total);
  if (threadIdx.x == 0) p.sums[blockIdx.x] = total;
}

// scan pass 2 (one block per shard): exclusive scan of the shard's tile
// sums, and its totals
__global__ void k_scan_blocks(ZtScratch sc, int nb_free, int nb_req) {
  const int s = blockIdx.x;
  int32_t* ctl = sc.ctl + s * CTL_N;
  if (!ctl[CTL_GO]) return;
  for (int which = 0; which < 2; ++which) {
    int32_t* sums = sc.block_sums + (int64_t)s * (nb_free + nb_req) + (which ? nb_free : 0);
    const int nb = which ? nb_req : nb_free;
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
      const int b = b0 + threadIdx.x;
      const int v = b < nb ? sums[b] : 0;
      int total;
      const int excl = block_exclusive_scan(v, &total);
      if (b < nb) sums[b] = carry + excl;
      carry += total;
    }
    if (threadIdx.x == 0) ctl[which ? CTL_REQ_TOTAL : CTL_FREE_TOTAL] = carry;
  }
}

// scan pass 3: ranks within the shard. free slots: slot_of_rank[free_rank]
// = local slot, and a completing token's slot is freed (elem = -1);
// requests: place_rank.
__global__ void k_scan_write(ZtState st, ZtScratch sc, int FO, int nb_free, int nb_req) {
  const int s = blockIdx.z;
  if (!sc.ctl[s * CTL_N + CTL_GO]) return;
  const bool req = blockIdx.y == 1;
  const int nb = req ? nb_req : nb_free;
  if ((int)blockIdx.x >= nb) return;
  const ScanPart p = scan_part(st, sc, FO, nb_free, nb_req);
  const int64_t off = (int64_t)s * p.n;
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  int f[SCAN_ITEMS];
  int v = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    f[k] = base + k < p.n ? p.a[base + k] : 0;
    v += f[k];
  }
  int total;
  int rank = block_exclusive_scan(v, &total) + p.sums[blockIdx.x];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t x = base + k;
    if (x < p.n && f[k]) {
      if (req) {
        sc.place_rank[off + x] = rank;
      } else {
        sc.slot_of_rank[off + rank] = (int)x;
        if (sc.tok_flags[off + x] & TF_COMPLETING) st.elem[off + x] = -1;
      }
      ++rank;
    }
  }
}

__global__ void k_place(ZtTables tb, ZtState st, ZtScratch sc, int mode, int cfg,
                        int32_t* row0) {
  const int s = blockIdx.y;
  int32_t* ctl = sc.ctl + s * CTL_N;
  if (!ctl[CTL_GO]) return;
  int32_t* row = shard_row(row0, s, st.T, tb.FO);
  const int64_t rl = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool placed = false, ovf = false;
  if (rl < (int64_t)st.T * tb.FO) {
    place_request(tb, st, sc, mode, cfg, row, s, rl, ctl[CTL_FREE_TOTAL], placed, ovf);
  }
  warp_flag(&ctl[CTL_ANY_LIVE], placed);
  if (__any_sync(0xffffffffu, ovf) && (threadIdx.x & 31) == 0) st.overflow[s] = 1;
}

__global__ void k_finish_instances(ZtTables tb, ZtState st, ZtScratch sc, int mode,
                                   int cfg, int32_t* row0) {
  const int s = blockIdx.y;
  if (!sc.ctl[s * CTL_N + CTL_GO]) return;
  int32_t* row = shard_row(row0, s, st.T, tb.FO);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int newly = i < st.I ? finish_instance(tb, st, sc, mode, cfg, row, s, i) : 0;
  warp_add(&st.completed[s], newly);
  warp_add(&st.transitions[s], 2 * newly);
}

__global__ void k_active(ZtTables tb, ZtState st, ZtScratch sc, int cfg) {
  const int s = blockIdx.y;
  int32_t* ctl = sc.ctl + s * CTL_N;
  if (!ctl[CTL_GO]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  warp_add(&ctl[CTL_ACTIVE], t < st.T ? active_token(tb, st, sc, cfg, s, t) : 0);
}

// one thread per shard: close the step (row tail, loop flag, per-step
// scalars)
__global__ void k_end_step(ZtState st, ZtScratch sc, int FO, int mode, int32_t* row0) {
  const int s = blockIdx.x;
  int32_t* ctl = sc.ctl + s * CTL_N;
  if (!ctl[CTL_GO]) return;
  if (mode & MODE_EMIT) {
    int32_t* row = shard_row(row0, s, st.T, FO);
    const int64_t tail = (int64_t)st.T * (2 + FO);
    row[tail] = ctl[CTL_ACTIVE];
    row[tail + 1] = st.overflow[s] ? 1 : 0;
  }
  if (mode & MODE_COLLECT) ctl[CTL_GO] = ctl[CTL_ACTIVE] > 0 ? 1 : 0;
  if (mode & MODE_COMPLETION) {
    ctl[CTL_STEPS] += 1;
    ctl[CTL_GO] = ctl[CTL_ANY_LIVE] ? 1 : 0;
  }
  ctl[CTL_ACTIVE] = 0;
  ctl[CTL_ANY_LIVE] = 0;
}

// make_sharded_step's counters: the input plus the sum over shards of each
// shard's delta (wrapping int32), and the OR of the shards' overflow flags
__global__ void k_combine(ZtState in, ZtState st, int32_t* transitions,
                          int32_t* jobs_created, int32_t* completed, uint8_t* overflow) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned dt = 0, dj = 0, dc = 0;
  bool ovf = false;
  for (int s = 0; s < st.NS; ++s) {
    const int64_t c = (int64_t)s * in.ctr_stride;
    dt += (unsigned)st.transitions[s] - (unsigned)in.transitions[c];
    dj += (unsigned)st.jobs_created[s] - (unsigned)in.jobs_created[c];
    dc += (unsigned)st.completed[s] - (unsigned)in.completed[c];
    ovf = ovf || st.overflow[s];
  }
  *transitions = (int)((unsigned)in.transitions[0] + dt);
  *jobs_created = (int)((unsigned)in.jobs_created[0] + dj);
  *completed = (int)((unsigned)in.completed[0] + dc);
  *overflow = ovf ? 1 : 0;
}

inline unsigned grid_for(int64_t n, int block) {
  const int64_t g = (n + block - 1) / block;
  return (unsigned)(g < 1 ? 1 : g);
}

// the fused chunk's launch configuration for NS shards
inline cudaLaunchConfig_t fused_config(int NS, cudaStream_t stream,
                                       cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)NS * CLUSTER);
  config.blockDim = dim3(FUSED_THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

// The chain's first launches: copy the caller's state into the working
// state, initialize the scratch, zero the packed output, and (scopes/MI)
// count the start-of-run occupancy. *launched counts the launches enqueued.
int zt_prepare(const ZtTables* tb, const ZtState* in, const ZtState* st,
               const ZtScratch* sc, int mode, int cfg, int32_t* out, int64_t out_len,
               void* stream, int32_t* launched) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t IE = (int64_t)st->I * tb->E;
  const int64_t NIE = IE * st->NS;
  int64_t n = (int64_t)st->T * st->NS;
  if (NIE > n) n = NIE;
  if (out_len > n) n = out_len;
  unsigned g = grid_for(n, BLOCK);
  if (g > 4096) g = 4096;
  k_prepare<<<g, BLOCK, 0, s>>>(*in, *st, *sc, NIE, mode, out, out_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  if (mode & MODE_COMPLETION) {
    k_any_live<<<dim3(grid_for(st->T, BLOCK), st->NS), BLOCK, 0, s>>>(*st, *sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  if (cfg & (CFG_SCOPES | CFG_MI)) {
    k_occupancy<<<dim3(grid_for(IE > st->T ? IE : st->T, BLOCK), st->NS), BLOCK, 0, s>>>(
        *tb, *st, *sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

// Enqueue n_steps lock-steps of the chain on the working state, every phase
// one launch over all NS shards. With out != null, step k writes packed row
// (row0 + k) of NS * row_len ints (row_len per shard).
int zt_steps(const ZtTables* tb, const ZtState* st, const ZtScratch* sc, int n_steps,
             int mode, int cfg, int32_t* out, int64_t row0, int64_t row_len,
             int nb_free, int nb_req, void* stream, int32_t* launched) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t T = st->T, R = (int64_t)st->T * tb->FO, IE = (int64_t)st->I * tb->E;
  const int64_t occ_n = T > IE ? T : IE;
  const unsigned NS = (unsigned)st->NS;
  const int nb = nb_free > nb_req ? nb_free : nb_req;
  cudaError_t err;
#define ZT_CHECK()                      \
  err = cudaGetLastError();             \
  if (err != cudaSuccess) return (int)err; \
  ++*launched
  for (int k = 0; k < n_steps; ++k) {
    int32_t* row = out ? out + (row0 + k) * row_len * NS : nullptr;
    k_classify<<<dim3(grid_for(T, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc, mode, cfg, row);
    ZT_CHECK();
    if (cfg & CFG_JOINS) {
      k_join_rank<<<dim3(grid_for(R, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc);
      ZT_CHECK();
    }
    k_scan_sums<<<dim3(nb, 2, NS), SCAN_THREADS, 0, s>>>(*st, *sc, tb->FO, nb_free, nb_req);
    ZT_CHECK();
    k_scan_blocks<<<NS, SCAN_THREADS, 0, s>>>(*sc, nb_free, nb_req);
    ZT_CHECK();
    k_scan_write<<<dim3(nb, 2, NS), SCAN_THREADS, 0, s>>>(*st, *sc, tb->FO, nb_free, nb_req);
    ZT_CHECK();
    k_place<<<dim3(grid_for(R, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc, mode, cfg, row);
    ZT_CHECK();
    k_finish_instances<<<dim3(grid_for(st->I, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc,
                                                                           mode, cfg, row);
    ZT_CHECK();
    if (cfg & (CFG_SCOPES | CFG_MI)) {
      k_occupancy<<<dim3(grid_for(occ_n, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc);
      ZT_CHECK();
    }
    if (mode & MODE_COLLECT) {
      k_active<<<dim3(grid_for(T, BLOCK), NS), BLOCK, 0, s>>>(*tb, *st, *sc, cfg);
      ZT_CHECK();
    }
    k_end_step<<<NS, 1, 0, s>>>(*st, *sc, tb->FO, mode, row);
    ZT_CHECK();
  }
#undef ZT_CHECK
  return 0;
}

// The fused chunk: copy-in, scratch init and n_steps lock-steps of every
// shard in ONE launch of NS clusters (no completion mode). out, when given,
// is [n_steps, NS * row_len]; every row a shard did not reach is zeroed.
int zt_collect_fused(const ZtTables* tb, const ZtState* in, const ZtState* st,
                     const ZtScratch* sc, int n_steps, int mode, int cfg, int32_t* out,
                     int64_t row_len, void* stream) {
  if (mode & MODE_COMPLETION) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(st->NS, (cudaStream_t)stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&config, k_chunk, *tb, *in, *st, *sc,
                                       n_steps, mode, cfg, out, row_len);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// make_sharded_step's counter combine (after its step): writes the scalar
// counters of the result state.
int zt_combine(const ZtState* in, const ZtState* st, int32_t* transitions,
               int32_t* jobs_created, int32_t* completed, uint8_t* overflow, void* stream) {
  k_combine<<<1, 32, 0, (cudaStream_t)stream>>>(*in, *st, transitions, jobs_created,
                                                 completed, overflow);
  return (int)cudaGetLastError();
}

// The fused kernel's resources: registers per thread, local memory per
// thread (stack and spills), and how many clusters of it fit on the card
// at once (cudaOccupancyMaxActiveClusters).
int zt_fused_resources(int32_t* regs, int32_t* local_bytes, int32_t* max_clusters) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k_chunk);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int32_t)fa.localSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(1, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)k_chunk, &config);
  *max_clusters = n;
  return (int)err;
}

int zt_scan_tile() { return SCAN_TILE; }

int zt_ctl_stride() { return CTL_N; }

int zt_fused_max_tokens() { return FUSED_MAX_TOKENS; }

int zt_fused_threads() { return FUSED_THREADS; }

int zt_cluster_blocks() { return CLUSTER; }

}  // extern "C"
