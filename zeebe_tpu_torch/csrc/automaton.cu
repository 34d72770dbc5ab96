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
//     On a mesh of several launch groups (parallel/mesh.py) each group's
//     blocks take this step and k_combine_groups sums the groups' counters.
//   - zeebe_tpu/parallel/mesh_runner.py::MeshKernelRunner._sharded_collect
//     (:233): run_collect of NS shard blocks, each leaving the chunk on its
//     own quiescence, with per-shard counters and packed rows
//     [n_steps, NS * row_len], shard s at columns [s*row_len, (s+1)*row_len).
//
// The shard axis. The reference puts one shard on each device of a mesh;
// here a launch takes NS shard blocks on one card (a mesh's launch group).
// Every per-instance access uses the global row shard * I + inst (token
// inst values are local to their shard block, as under shard_map); the
// free-slot and request prefix sums restart at each shard; the control
// words (go, active, any live, scan totals) and the counters are per
// shard. With NS = 1 every kernel computes exactly what it did before the
// shard axis.
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
// Three paths compute the same function from the same per-item device
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
//     L2 across phases. A small shard (the serving path's small bucket, I =
//     64) takes the block shape instead (k_chunk_block): one plain block
//     of pow2(max(T, I, 32)) threads per shard, __syncthreads for the
//     cluster barrier and the block's own totals, since at T = 64 a cluster
//     of 8 x 1024 threads leaves 1016 of each block's threads idle and
//     spends its lock-steps on cluster barriers.
//   - The chain (zt_prepare + zt_steps), for larger shards (and
//     run_to_completion when forced): every phase one grid-wide launch over
//     all shards (blockIdx.y, or blockIdx.z for the scan, or blockIdx.x for
//     the per-shard control kernels, is the shard), ~10 launches per step,
//     all enqueued back to back; the early exit is a per-shard device flag
//     (go) that every block reads first.
//   - The grid kernel (k_complete, zt_complete), for run_to_completion: ONE
//     cooperative launch per call that spans the whole card and runs the
//     reference's whole while_loop on the device (see the note at
//     k_complete).
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
// the fused chunk's block shape: one block of pow2(max(T, I, 32)) threads
// per shard, for shards of at most this many slots (ops/kernels.py's
// fused_shape picks it, below a threshold measured on the card)
constexpr int FUSED_BLOCK_THREADS = 1024;

// the grid kernel: threads per block (two blocks per SM at 64 registers),
// and the most blocks it launches (block_sums holds three totals per block)
constexpr int GRID_THREADS = 512;
constexpr int GRID_MAX_BLOCKS = 1024;

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
  int32_t* ctl;           // [NS*CTL_N] (the chain; the grid kernel's CTL_STEPS)
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
  int32_t* block_sums;    // [NS*max(nb_free + nb_req, 3*GRID_MAX_BLOCKS)] (the chain:
                          // tile sums; the grid kernel: per-block totals)
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
// when the config never writes them: nothing to copy then. The scope
// counts are read only with scopes or MI, the join scratch only with joins:
// the rest is left as it is.
__device__ __forceinline__ void prepare_key(const ZtState& in, const ZtState& st,
                                            const ZtScratch& sc, int cfg, int64_t x) {
  if (st.join_counts != in.join_counts) st.join_counts[x] = in.join_counts[x];
  if (st.mi_left != in.mi_left) st.mi_left[x] = in.mi_left[x];
  if (cfg & (CFG_SCOPES | CFG_MI)) {
    sc.occ[x] = 0;
    sc.pend[x] = 0;
  }
  if (cfg & CFG_JOINS) {
    sc.arrivals[x] = 0;
    sc.consumed[x] = 0;
    sc.head[x] = -1;
  }
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

// ranks of the set flags of a block's contiguous range [lo, hi), the first
// at `base`, in index order: tile by tile of blockDim.x * SCAN_ITEMS, each
// thread SCAN_ITEMS neighbouring flags (a warp's loads stay on a few cache
// lines), a block scan per tile; write(x, rank) for every set flag x
template <class Write>
__device__ void block_ranks(const int32_t* flag, int lo, int hi, int base, Write&& write) {
  const int tile = (int)blockDim.x * SCAN_ITEMS;
  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int x0 = t0 + (int)threadIdx.x * SCAN_ITEMS;
    int f[SCAN_ITEMS];
    int v = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      f[k] = x0 + k < hi ? flag[x0 + k] : 0;
      v += f[k];
    }
    int total;
    int rank = base + block_exclusive_scan(v, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (f[k]) write(x0 + k, rank++);
    }
    base += total;
  }
}

// block-wide sum of one int per thread; every thread gets the sum
__device__ int block_sum(int v) {
  __shared__ int warp_part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  int s = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : 0;
  s = __reduce_add_sync(0xffffffffu, s);
  __syncthreads();  // warp_part is written again by the next call
  return s;
}

// ---------------------------------------------------------------------------
// The fused chunk: CL blocks of NT threads per shard, one launch for the
// whole chunk, in one of two shapes. The cluster shape (k_chunk) runs each
// shard as a cluster of CLUSTER blocks of FUSED_THREADS; the block shape
// (k_chunk_block) runs each shard as one plain block of pow2(max(T, I, 32))
// threads, for shards of at most FUSED_BLOCK_THREADS slots. Both compute
// the same function from the same item code: only the barrier's scope (a
// cluster barrier, or __syncthreads) and where the other blocks' totals are
// read (distributed shared memory, or the block's own) differ. Every thread
// of a shard reaches every barrier (no early return), and the loop's exit
// is decided from values every block reads alike.

// [lo, hi) of n items cut into `parts` contiguous ranges, range `k`
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range part_of(int n, int parts, int k) {
  const int per = (n + parts - 1) / parts;
  const int lo = min(k * per, n);
  return {lo, min(lo + per, n)};
}

// the barrier between the phases of one shard: a cluster barrier
// (barrier.cluster.arrive.release + wait.acquire, which orders global
// memory too) across CL blocks, or the block's own
template <int CL>
__device__ __forceinline__ void shard_sync() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

template <int CL>
__device__ __forceinline__ int shard_block_rank() {
  if constexpr (CL == 1) {
    return 0;
  } else {
    return (int)cg::this_cluster().block_rank();
  }
}

// block q's copy of a __shared__ array of the shard's blocks
template <int CL>
__device__ __forceinline__ const int* block_shared(int* p, int q) {
  if constexpr (CL == 1) {
    return p;
  } else {
    return cg::this_cluster().map_shared_rank(p, q);
  }
}

template <int NT, int CL>
__device__ __forceinline__ void chunk_body(const ZtTables& tb, const ZtState& in,
                                           const ZtState& st, const ZtScratch& sc,
                                           int n_steps, int mode, int cfg, int32_t* out,
                                           int64_t row_len) {
  // per block: its free slots, its placed requests, its active tokens
  __shared__ int totals[3];
  const int b = shard_block_rank<CL>();
  const int s = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const int T = st.T, I = st.I, E = tb.E, FO = tb.FO;
  const int64_t tok0 = (int64_t)s * T, i0 = (int64_t)s * I;
  // this block's tokens (and their requests), instances and instance keys
  const Range tok = part_of(T, CL, b);
  const Range ins = part_of(I, CL, b);
  const int r_lo = tok.lo * FO, r_hi = tok.hi * FO;
  const int k_lo = ins.lo * E, k_hi = ins.hi * E;
  // this thread's contiguous segments of the block's tokens and requests,
  // in the order of the shard's prefix sums
  const Range fseg = part_of(tok.hi - tok.lo, NT, tid);
  const Range rseg = part_of(r_hi - r_lo, NT, tid);
  const bool scoped = cfg & (CFG_SCOPES | CFG_MI);
  const bool collect = mode & MODE_COLLECT;

  for (int x = tok.lo + tid; x < tok.hi; x += NT) prepare_token(in, st, tok0 + x);
  for (int x = k_lo + tid; x < k_hi; x += NT) prepare_key(in, st, sc, cfg, i0 * E + x);
  for (int x = ins.lo + tid; x < ins.hi; x += NT) {
    prepare_instance(in, st, sc, i0 + x);
    sc.pending[i0 + x] = 0;
  }
  if (b == 0 && tid == 0) prepare_counters(in, st, s);
  shard_sync<CL>();
  if (scoped) {
    for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, s, x);
    for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, s, x);
    shard_sync<CL>();
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
      shard_sync<CL>();
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
    shard_sync<CL>();
    // pass 2: offsets from the lower blocks' totals, then ranks:
    // slot_of_rank for free slots (a completing token's slot is freed),
    // place_rank for requests
    int free_total = 0, free_base = 0, req_base = 0;
    for (int q = 0; q < CL; ++q) {
      const int* other = block_shared<CL>(totals, q);
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
    shard_sync<CL>();
    // place
    bool ovf = false;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      bool placed = false;
      place_request(tb, st, sc, mode, cfg, row, s, r, free_total, placed, ovf);
    }
    if (__any_sync(0xffffffffu, ovf) && (tid & 31) == 0) st.overflow[s] = 1;
    shard_sync<CL>();
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
      shard_sync<CL>();
      for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, s, x);
      for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, s, x);
      shard_sync<CL>();
    }
    // count active tokens (after the recount of scopes)
    int act = 0;
    if (collect) {
      for (int t = tok.lo + tid; t < tok.hi; t += NT) act += active_token(tb, st, sc, cfg, s, t);
    }
    int block_active;
    block_exclusive_scan(act, &block_active);
    if (tid == 0) totals[2] = block_active;
    shard_sync<CL>();
    int active = 0;
    for (int q = 0; q < CL; ++q) active += block_shared<CL>(totals, q)[2];
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
      for (int64_t x = (int64_t)b * NT + tid; x < row_len; x += (int64_t)CL * NT) row[x] = 0;
    }
  }
  // no block leaves while another may still read its shared memory
  shard_sync<CL>();
}

__global__ void __launch_bounds__(FUSED_THREADS, 1)
k_chunk(ZtTables tb, ZtState in, ZtState st, ZtScratch sc, int n_steps, int mode, int cfg,
        int32_t* out, int64_t row_len) {
  chunk_body<FUSED_THREADS, CLUSTER>(tb, in, st, sc, n_steps, mode, cfg, out, row_len);
}

// the block shape: a plain launch of NS blocks of NT threads, its register
// budget set by its own block size
template <int NT>
__global__ void __launch_bounds__(NT, 1)
k_chunk_block(ZtTables tb, ZtState in, ZtState st, ZtScratch sc, int n_steps, int mode,
              int cfg, int32_t* out, int64_t row_len) {
  chunk_body<NT, 1>(tb, in, st, sc, n_steps, mode, cfg, out, row_len);
}

// ---------------------------------------------------------------------------
// The chain: one grid-wide launch per phase over all shards.

__global__ void k_prepare(ZtState in, ZtState st, ZtScratch sc, int64_t NIE, int mode,
                          int cfg, int32_t* out, int64_t out_len) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t x0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t NT = (int64_t)st.NS * st.T, NI = (int64_t)st.NS * st.I;
  for (int64_t x = x0; x < NT; x += stride) prepare_token(in, st, x);
  for (int64_t x = x0; x < NIE; x += stride) prepare_key(in, st, sc, cfg, x);
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

// The cross-group counter sum of a mesh of several launch groups, the
// reference's psum over devices: row g of rows [G, 4] holds group g's
// counters after its step (transitions, jobs_created, completed, overflow as
// 0 or 1), every group having started from the same replicated counters
// in_*. Writes the input plus the sum of the groups' deltas (wrapping int32)
// and the OR of the groups' flags. G is a handful of cards or groups and the
// rows are 16 bytes each: one thread walks them.
__global__ void k_combine_groups(const int32_t* rows, int G, const int32_t* in_t,
                                 const int32_t* in_j, const int32_t* in_c,
                                 int32_t* transitions, int32_t* jobs_created,
                                 int32_t* completed, uint8_t* overflow) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned t0 = (unsigned)*in_t, j0 = (unsigned)*in_j, c0 = (unsigned)*in_c;
  unsigned dt = 0, dj = 0, dc = 0;
  bool ovf = false;
  for (int g = 0; g < G; ++g) {
    const int32_t* row = rows + 4 * (int64_t)g;
    dt += (unsigned)row[0] - t0;
    dj += (unsigned)row[1] - j0;
    dc += (unsigned)row[2] - c0;
    ovf = ovf || row[3] != 0;
  }
  *transitions = (int)(t0 + dt);
  *jobs_created = (int)(j0 + dj);
  *completed = (int)(c0 + dc);
  *overflow = ovf ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The grid kernel: run_to_completion in ONE launch.
//
// It replaces zeebe_tpu/ops/automaton.py::run_to_completion (:773), a
// lax.while_loop of step (:366) with auto jobs and no events while any token
// is live and fewer than max_steps steps have run, with no host round trip.
// The chain ran it as ~7-10 grid launches per lock-step (classify, join
// ranks, three scan passes of which one is a single block walking every tile
// sum in series, place, finish, occupancy, end step), and the host read the
// loop flag after every block of 8 steps; the fused chunk cannot take it
// either: one cluster has 8 of 132 SMs, and at 1 << 20 token slots the
// lock-step is wide.
//
// What bounds it on an H100: a live lock-step must read and write the state
// arrays its KernelConfig uses once (one_task at I = T = 1 << 20: 50,331,738
// bytes, 15 us at 3.35 TB/s), so a call is bound by its live steps times
// those bytes, the first step reading the caller's state (the copy-in below
// is this kernel's choice, over that bound); on top of the bytes, every
// phase that reads what another block wrote costs one grid barrier (4 per
// step, 5 with joins, 6 with scopes or MI).
//
// What the design does about it: the kernel is launched cooperatively
// (cudaLaunchCooperativeKernel) with as many blocks as the card holds at once
// (the occupancy API x the SM count; a grid that could not be co-resident
// fails the launch, it never waits), and every block loops over the steps.
// Block b owns a contiguous range of the tokens, of their requests and of
// the instances and their keys, and walks its ranges with block-stride loops
// (at 1 << 20 tokens, 264 blocks of 512 threads: ~8 tokens a thread). Phases
// that read other blocks' writes are separated by cooperative_groups'
// grid.sync(), which fences global memory on both sides of the barrier. The
// prefix sums need no extra pass: a block's free flags and placed requests
// are its own writes (its classify and its join ranks), so each block counts
// its range with coalesced loads and publishes the totals, and after one
// grid barrier every block sums the totals of the blocks below it (at most
// GRID_MAX_BLOCKS values, from L2) and ranks its range tile by tile, each
// thread four neighbouring flags (a per-thread contiguous segment would cost
// an L1 wavefront per flag). The ranks are the chain's exactly. Counters go
// to device memory as one atomic per block and step (a warp's each would
// queue ~1 << 15 atomics on one address at 1 << 20 tokens), and a block
// reads its instances' pending join arrivals back only when it added some.
// The loop's exit is decided by every block from the same per-block "a token
// is live after the step" flags, read after the same barrier, so all blocks
// leave together; block 0 then writes the step count. Every read of a
// per-block slot and the next write to it are separated by at least one
// grid barrier (the totals are read before the ranks barrier and written
// again before the next scan barrier; the live flags are read before the
// next scan barrier and written again after it), so no slot is overwritten
// while another block may still read it.
__global__ void __launch_bounds__(GRID_THREADS, 2)
k_complete(ZtTables tb, ZtState in, ZtState st, ZtScratch sc, int max_steps, int mode,
           int cfg) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int T = st.T, I = st.I, E = tb.E, FO = tb.FO;
  const Range tok = part_of(T, G, b);
  const Range ins = part_of(I, G, b);
  const int r_lo = tok.lo * FO, r_hi = tok.hi * FO;
  const int k_lo = ins.lo * E, k_hi = ins.hi * E;
  const bool scoped = cfg & (CFG_SCOPES | CFG_MI);
  // per block: its free slots, its placed requests, a token live after the step
  int32_t* free_tot = sc.block_sums;
  int32_t* req_tot = free_tot + G;
  int32_t* live_tot = req_tot + G;

  // copy-in; run_to_completion's loop test before the first step
  bool live = false;
  for (int x = tok.lo + tid; x < tok.hi; x += NT) {
    prepare_token(in, st, x);
    live = live || in.elem[x] >= 0;
  }
  for (int x = k_lo + tid; x < k_hi; x += NT) prepare_key(in, st, sc, cfg, x);
  for (int x = ins.lo + tid; x < ins.hi; x += NT) {
    prepare_instance(in, st, sc, x);
    sc.pending[x] = 0;
  }
  if (b == 0 && tid == 0) prepare_counters(in, st, 0);
  int any = __syncthreads_or(live);
  if (tid == 0) live_tot[b] = any;
  grid.sync();
  if (scoped) {
    for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, 0, x);
    for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, 0, x);
    grid.sync();
  }
  int n_live = 0;
  for (int q = tid; q < G; q += NT) n_live += live_tot[q];
  bool go = block_sum(n_live) > 0;

  int steps = 0;
  while (go && steps < max_steps) {
    // classify (then rank joins against every block's links)
    bool keep = false;
    int trans = 0, jobs = 0;
    for (int t = tok.lo + tid; t < tok.hi; t += NT) {
      int tr, jb;
      bool keep_live;
      classify_token(tb, st, sc, mode, cfg, nullptr, 0, t, tr, jb, keep_live);
      trans += tr;
      jobs += jb;
      keep = keep || keep_live;
    }
    // one atomic per block and counter
    trans = block_sum(trans);
    jobs = block_sum(jobs);
    if (tid == 0) {
      if (trans) atomicAdd(&st.transitions[0], trans);
      if (jobs) atomicAdd(&st.jobs_created[0], jobs);
    }
    if (cfg & CFG_JOINS) {
      grid.sync();
      for (int r = r_lo + tid; r < r_hi; r += NT) join_rank_request(tb, st, sc, 0, r);
    }
    __syncthreads();
    // prefix sums: this block's free slots and placed requests are final;
    // their totals first
    int nf = 0, nr = 0;
    for (int x = tok.lo + tid; x < tok.hi; x += NT) nf += sc.free_flag[x];
    for (int r = r_lo + tid; r < r_hi; r += NT) nr += sc.proceeds[r];
    nf = block_sum(nf);
    nr = block_sum(nr);
    if (tid == 0) {
      free_tot[b] = nf;
      req_tot[b] = nr;
    }
    grid.sync();
    // offsets from the lower blocks' totals, then ranks: slot_of_rank for
    // free slots (a completing token's slot is freed), place_rank for requests
    int ft = 0, fb = 0, rb = 0;
    for (int q = tid; q < G; q += NT) {
      const int f = free_tot[q];
      ft += f;
      if (q < b) {
        fb += f;
        rb += req_tot[q];
      }
    }
    const int free_total = block_sum(ft);
    block_ranks(sc.free_flag, tok.lo, tok.hi, block_sum(fb), [&](int x, int rank) {
      sc.slot_of_rank[rank] = x;
      if (sc.tok_flags[x] & TF_COMPLETING) st.elem[x] = -1;
    });
    block_ranks(sc.proceeds, r_lo, r_hi, block_sum(rb),
                [&](int x, int rank) { sc.place_rank[x] = rank; });
    grid.sync();
    // place
    bool ovf = false;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      bool placed = false;
      place_request(tb, st, sc, mode, cfg, nullptr, 0, r, free_total, placed, ovf);
      keep = keep || placed;
    }
    if (__any_sync(0xffffffffu, ovf) && (tid & 31) == 0) st.overflow[0] = 1;
    grid.sync();
    // finish: the block's keys one per thread (each instance's pending
    // arrivals summed by atomics), then its instances
    bool added = false;
    for (int x = k_lo + tid; x < k_hi; x += NT) {
      const unsigned jc = finish_key(st, sc, cfg, x);
      if (jc != 0) {
        atomicAdd(&sc.pending[x / E], (int)jc);
        added = true;
      }
    }
    // the block's instances have pending arrivals only if one of its
    // threads added some: else every pending count is 0 and stays unread
    added = __syncthreads_or(added);
    int newly = 0;
    for (int i = ins.lo + tid; i < ins.hi; i += NT) {
      // both were summed by atomics: read them back the same way
      const int n = atomicExch(&sc.tpi[i], 0);
      const unsigned pending = added ? (unsigned)atomicExch(&sc.pending[i], 0) : 0u;
      newly += complete_instance(st, mode, nullptr, FO, i, i, n, pending);
    }
    newly = block_sum(newly);
    if (tid == 0 && newly) {
      atomicAdd(&st.completed[0], newly);
      atomicAdd(&st.transitions[0], 2 * newly);
    }
    if (scoped) {
      grid.sync();
      for (int x = tok.lo + tid; x < tok.hi; x += NT) occupancy_token(tb, st, sc, 0, x);
      for (int x = k_lo + tid; x < k_hi; x += NT) occupancy_key(tb, st, sc, 0, x);
    }
    any = __syncthreads_or(keep);
    if (tid == 0) live_tot[b] = any;
    grid.sync();
    n_live = 0;
    for (int q = tid; q < G; q += NT) n_live += live_tot[q];
    go = block_sum(n_live) > 0;
    ++steps;
  }
  if (b == 0 && tid == 0) sc.ctl[CTL_STEPS] = steps;
}

// The grid kernel's launch size on the current device: blocks per SM (the
// occupancy API) x the SM count, capped at GRID_MAX_BLOCKS; cached per device.
cudaError_t complete_grid(int* blocks, int* per_sm) {
  constexpr int kMaxDevices = 64;
  static int cached_blocks[kMaxDevices], cached_per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached_blocks[dev] > 0) {
    *blocks = cached_blocks[dev];
    *per_sm = cached_per_sm[dev];
    return cudaSuccess;
  }
  int sms = 0, coop = 0, n = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k_complete, GRID_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorCooperativeLaunchTooLarge;
  *per_sm = n;
  *blocks = n * sms < GRID_MAX_BLOCKS ? n * sms : GRID_MAX_BLOCKS;
  if (dev < kMaxDevices) {
    cached_per_sm[dev] = *per_sm;
    cached_blocks[dev] = *blocks;
  }
  return cudaSuccess;
}

inline unsigned grid_for(int64_t n, int block) {
  const int64_t g = (n + block - 1) / block;
  return (unsigned)(g < 1 ? 1 : g);
}

// the block shape's threads for a shard of T slots and I instances
inline int block_threads(int T, int I) {
  int n = 32;
  while (n < T || n < I) n <<= 1;
  return n;
}

// the block shape's launch: NS blocks, its threads fixed at compile time
cudaError_t launch_block(const ZtTables& tb, const ZtState& in, const ZtState& st,
                         const ZtScratch& sc, int n_steps, int mode, int cfg, int32_t* out,
                         int64_t row_len, cudaStream_t stream) {
  static_assert(FUSED_BLOCK_THREADS == 1024, "the cases below end at 1024 threads");
  const dim3 grid((unsigned)st.NS);
  switch (block_threads(st.T, st.I)) {
#define ZT_BLOCK(nt)                                                                  \
  case nt:                                                                            \
    k_chunk_block<nt><<<grid, nt, 0, stream>>>(tb, in, st, sc, n_steps, mode, cfg, out, \
                                               row_len);                              \
    break;
    ZT_BLOCK(32)
    ZT_BLOCK(64)
    ZT_BLOCK(128)
    ZT_BLOCK(256)
    ZT_BLOCK(512)
    ZT_BLOCK(1024)
#undef ZT_BLOCK
    default:
      return cudaErrorInvalidValue;  // more than FUSED_BLOCK_THREADS slots
  }
  return cudaGetLastError();
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
  k_prepare<<<g, BLOCK, 0, s>>>(*in, *st, *sc, NIE, mode, cfg, out, out_len);
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
// shard in ONE launch (no completion mode): NS clusters, or with `block`
// NS blocks (shards of at most FUSED_BLOCK_THREADS slots). out, when given,
// is [n_steps, NS * row_len]; every row a shard did not reach is zeroed.
int zt_collect_fused(const ZtTables* tb, const ZtState* in, const ZtState* st,
                     const ZtScratch* sc, int n_steps, int mode, int cfg, int32_t* out,
                     int64_t row_len, int block, void* stream) {
  if (mode & MODE_COMPLETION) return (int)cudaErrorInvalidValue;
  if (block) {
    return (int)launch_block(*tb, *in, *st, *sc, n_steps, mode, cfg, out, row_len,
                             (cudaStream_t)stream);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = fused_config(st->NS, (cudaStream_t)stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&config, k_chunk, *tb, *in, *st, *sc,
                                       n_steps, mode, cfg, out, row_len);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// run_to_completion in ONE cooperative launch of the grid kernel: copy-in,
// scratch init and up to max_steps lock-steps of one shard, the loop's exit
// on the device; ctl[CTL_STEPS] holds the steps run. A grid that cannot be
// co-resident fails the launch (cudaErrorCooperativeLaunchTooLarge).
int zt_complete(const ZtTables* tb, const ZtState* in, const ZtState* st,
                const ZtScratch* sc, int max_steps, int mode, int cfg, void* stream) {
  if (st->NS != 1 || !(mode & MODE_COMPLETION) || (mode & (MODE_EMIT | MODE_COLLECT))) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0, per_sm = 0;
  cudaError_t err = complete_grid(&blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  ZtTables t = *tb;
  ZtState a = *in, w = *st;
  ZtScratch c = *sc;
  void* args[] = {&t, &a, &w, &c, &max_steps, &mode, &cfg};
  err = cudaLaunchCooperativeKernel((const void*)k_complete, dim3(blocks), dim3(GRID_THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid kernel's resources: registers and local memory per thread, its
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the
// co-resident grid it launches.
int zt_complete_resources(int32_t* regs, int32_t* local_bytes, int32_t* per_sm,
                          int32_t* blocks) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k_complete);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *local_bytes = (int32_t)fa.localSizeBytes;
  int b = 0, p = 0;
  err = complete_grid(&b, &p);
  *per_sm = p;
  *blocks = b;
  return (int)err;
}

// make_sharded_step's counter combine (after its step): writes the scalar
// counters of the result state.
int zt_combine(const ZtState* in, const ZtState* st, int32_t* transitions,
               int32_t* jobs_created, int32_t* completed, uint8_t* overflow, void* stream) {
  k_combine<<<1, 32, 0, (cudaStream_t)stream>>>(*in, *st, transitions, jobs_created,
                                                 completed, overflow);
  return (int)cudaGetLastError();
}

// A grouped mesh's cross-group counter sum (after every group's step):
// writes the scalar counters of the result on the rows' card.
int zt_combine_groups(const int32_t* rows, int G, const int32_t* in_t, const int32_t* in_j,
                      const int32_t* in_c, int32_t* transitions, int32_t* jobs_created,
                      int32_t* completed, uint8_t* overflow, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  k_combine_groups<<<1, 32, 0, (cudaStream_t)stream>>>(rows, G, in_t, in_j, in_c, transitions,
                                                        jobs_created, completed, overflow);
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

int zt_fused_block_threads() { return FUSED_BLOCK_THREADS; }

int zt_grid_threads() { return GRID_THREADS; }

int zt_grid_max_blocks() { return GRID_MAX_BLOCKS; }

}  // extern "C"
