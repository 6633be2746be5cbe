// GP population evaluation + fitness moments for Hopper (sm_90a).
//
// Replaces the four TPU kernels of `repro/kernels/gp_eval.py`, all with
// the fused moment epilogue of the built-in fitness kernels r / c / m /
// mse (M = 1), merged across data tiles in a fixed order:
//
//   B1 gp_eval_fitness           <- eval_fitness_pallas (_eval_fitness_kernel):
//                                   heap trees
//   B2 gp_eval_postfix           <- eval_fitness_pallas_postfix
//                                   (_eval_fitness_postfix_kernel): postfix streams
//   B3 gp_fitness_from_subtrees  <- eval_fitness_pallas_from_subtrees
//                                   (_fitness_from_subtrees_kernel): preds =
//                                   uniq[root], gathered in the kernel
//   B4 gp_fitness_from_preds     <- eval_fitness_pallas_from_preds
//                                   (_fitness_from_preds_kernel): preds given
//
// plus two kernels in place of jnp code of the reference: gp_unique_table,
// the card's form of `core/eval.evaluate_unique_subtrees` (the dedup
// layer's unique-subtree table that B3/B4 read), and gp_predict_postfix,
// of `core/eval.evaluate_population_postfix` (the semantic tier's probe
// predictions). They share `apply_fn` with B1/B2, so dedup on and off
// give bitwise-equal predictions for every function set.
//
// Design (rethought for the card rather than copied from the TPU grid):
//   * Grid (data tiles, trees) for B1-B4. B1 and B2 are one block body
//     (`fitness_block`) under two kernel names. A block lays its tree's
//     active instructions out in shared memory once, with all its threads
//     at once: position t of the program reads slot t of a postfix row
//     (B2) or slot slots[t] of a heap row (B1; slots = the full heap's
//     postorder, a device constant), and a warp ballot plus a prefix over
//     the warps place the non-EMPTY slots. Pruning removes whole
//     subtrees, so a heap row compacted that way is exactly its tree's
//     postorder, the postfix form `heap_to_postfix` gives.
//   * Each thread walks that instruction list with a register stack of S
//     floats (S >= the program's stack depth), V points together (up to
//     4: one decode for V points, V X loads in flight). Every node applies
//     the same f32 operation to the same operand values as the reference,
//     so predictions are bitwise equal to it for
//     add/sub/mul/div/neg/abs/sqrt/square/min/max trees, and heap and
//     postfix forms of one tree agree bitwise.
//   * All threads of a block run the same tree, so the opcode branches
//     never diverge inside a warp; X is feature-major, so the threads of
//     a warp read neighbouring addresses of one feature row.
//   * The epilogue folds each point into a per-thread partial in a fixed
//     order (thread t: points t, t + 256, ... of the tile); the block
//     reduces with a fixed shuffle tree into one partial per (tree,
//     tile), and the partials are summed in tile order inside the kernel
//     by the block that draws a tree's last ticket (an int32 counter per
//     tree): every B1-B4 call is one launch. No float atomics: results
//     never change from run to run. B1-B4 share the epilogue, the
//     reduction and the merge order, so at one tile geometry their
//     moments are bitwise alike.
//   * B3 and B4 have no program: each thread loads all its points of the
//     tile (t, t + 256, ...; up to 16) at once, so the block's whole slice
//     of the row, y and w is in flight together, and folds them in that
//     order. Staging the slice in shared memory first (one bulk copy per
//     array on an mbarrier, or 16-byte cp.async by every thread) measured
//     no faster at any shape and slower at most (tools/gather_staging/):
//     the row is read once, and a staged block waits for its last byte
//     before any thread folds.
//   * The probe (gp_predict_postfix) has a few rows and 32 points: one
//     warp per row, up to 8 rows a block. A warp loads its row by ballot
//     into its own slice of shared memory, then gathers its feature
//     terminals' values at its 32 points with cp.async, all in flight at
//     once, so the interpreter then reads only shared memory.
//   * B2-B4 and the unique table take an optional device
//     flag `gate` and run only when (*gate != 0) == run_when, else every
//     block returns at once. The dedup path launches both branches of
//     the reference's lax.cond(overflow, ...) that way into one output,
//     and the host never reads the flag.
//   * The unique table runs one persistent block of 512 threads per SM
//     with nearly all of its shared memory. A block stages the live
//     slots' metadata once, computes their subtree heights by relaxation
//     and counting-sorts them by (height, opcode), all in shared memory:
//     no sort outside the kernel, one launch a call. Then for each of its
//     tiles of points (as wide as the slots' values fit, up to 32) it
//     evaluates one height at a time, a barrier between heights (6 at
//     depth 5), with every value in shared memory, and writes the tile's
//     rows out once.
//
// What bounds them: B1/B2 read little (op/arg rows, X, y, w: for kat7 at
// P=100 about 0.5 MB) and execute one interpreted node per active node
// per point, a few integer and f32 instructions plus a branch each: the
// interpreter overhead, not memory, sets the time; the design keeps the
// operands in registers and the instruction list in shared memory so
// that nothing but X, y and w is read from device memory inside the
// loop, and they decode each instruction once for V points. B3/B4 read
// one f32 row per tree plus y and w: memory and the epilogue's
// instructions bound them at large shapes; at kat7 the launch, one round
// of loads and the tile merge's atomic at the end do, so each block puts
// its whole slice in flight at once and the merge costs one atomic round
// trip, not a second launch. The unique table must write n_unique rows of
// D floats, which bounds it at large D; per tile it pays one barrier per
// height and the interpreter's decode per (slot, 8 points), which bound
// it at the paper's shapes.
//
// Numerics that match the reference: build with -fmad=false and without
// --use_fast_math (IEEE `/` and sqrtf), NaN-propagating min/max written
// out, rintf (round half to even) and the clamp to [0, n_classes - 1] for
// classify (which absorb nan_to_num), `fabsf(b) < 1e-9f` for protected
// division and `logf(fabsf(a) + 1e-9f)` for log; an opcode outside the
// function-set mask evaluates to 0, as the reference's select chain does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEmpty = 0;
constexpr int kConst = 1;
constexpr int kFeature = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// fitness kernel ids (repro_torch/core/fitness.py FitnessKernel.device_id)
constexpr int kR = 0;
constexpr int kC = 1;
constexpr int kM = 2;
constexpr int kMse = 3;

__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__device__ __forceinline__ int arity_of(int op) {
  return (op >= 7 && op <= 13) ? 1 : 2;  // neg..square are unary
}

__device__ __forceinline__ float apply_fn(int op, float a, float b) {
  switch (op) {
    case 3: return a + b;
    case 4: return a - b;
    case 5: return a * b;
    case 6: return fabsf(b) < 1e-9f ? 1.0f : a / b;
    case 7: return -a;
    case 8: return fabsf(a);
    case 9: return sinf(a);
    case 10: return cosf(a);
    case 11: return sqrtf(fabsf(a));
    case 12: return logf(fabsf(a) + 1e-9f);
    case 13: return a * a;
    case 14: return nan_min(a, b);
    case 15: return nan_max(a, b);
    default: return 0.0f;
  }
}

// The fused moment epilogue: folds one point's prediction into the
// thread's running partial of the built-in fitness kernel `kernel` (r, c,
// m, mse; M = 1). `bad` records a NaN prediction at a valid point, which
// makes a c/m tree's fitness +inf; r/mse map a NaN error to +inf directly.
__device__ __forceinline__ void epilogue(int kernel, float pred, float yd, float wd,
                                         float n_classes_m1, float precision,
                                         float& acc, int& bad) {
  if (kernel == kR || kernel == kMse) {
    const float diff = pred - yd;
    float e = (kernel == kR) ? fabsf(diff) : diff * diff;
    e = wd > 0.0f ? e : 0.0f;
    acc += isnan(e) ? INFINITY : e;
    return;
  }
  bool hit;
  if (kernel == kC) {
    // the reference's clip(rint(nan_to_num(pred)), 0, n_classes - 1): fmaxf
    // takes 0 over a NaN and the clamp maps +-inf as it maps +-FLT_MAX, so
    // nan_to_num needs no instructions of its own
    hit = fminf(fmaxf(rintf(pred), 0.0f), n_classes_m1) == yd;
  } else {
    hit = fabsf(pred - yd) <= precision;
  }
  acc += (hit ? 1.0f : 0.0f) * wd;
  bad |= (isnan(pred) && wd > 0.0f) ? 1 : 0;
}

__device__ __forceinline__ bool gated_off(const unsigned char* gate, int run_when) {
  return gate != nullptr && ((*gate != 0) != (run_when != 0));
}

// Whether function opcode o is in the run's function set (its flag, 0 or 1).
__device__ __forceinline__ int fn_enabled(int o, unsigned fn_mask) {
  return (o >= 0 && o < 32) ? static_cast<int>((fn_mask >> o) & 1u) : 0;
}

// A program in shared memory: per instruction its opcode, the clamped
// feature row or the function-set flag (idx), and a constant's value (val).
struct Program {
  int* code;
  int* idx;
  float* val;
};

// The program of N slots laid out from `smem` (3N words).
__device__ __forceinline__ Program program_at(int* smem, int N) {
  return {smem, smem + N, reinterpret_cast<float*>(smem + 2 * N)};
}

// Instruction `at` of a program: opcode o, argument a.
__device__ __forceinline__ void put_instr(const Program& pr, int at, int o, int a, int F,
                                          const float* __restrict__ consts, int C,
                                          unsigned fn_mask) {
  pr.code[at] = o;
  if (o == kFeature)
    pr.idx[at] = min(max(a, 0), F - 1);
  else if (o == kConst)
    pr.val[at] = __ldg(consts + min(max(a, 0), C - 1));
  else
    pr.idx[at] = fn_enabled(o, fn_mask);
}

// The block's partial of tree p from each thread's running (acc, bad): a
// fixed shuffle tree per warp, then the warps in order; the c/m kernels
// turn a NaN at a valid point into +inf. The value is thread 0's.
__device__ __forceinline__ float block_partial(float acc, int bad, int kernel) {
  __shared__ float s_acc[kWarps];
  __shared__ int s_bad[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    bad |= __shfl_down_sync(0xffffffffu, bad, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_acc[warp] = acc;
    s_bad[warp] = bad;
  }
  __syncthreads();
  float part = 0.0f;
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    int any_bad = 0;
    for (int k = 0; k < kWarps; ++k) {
      tot += s_acc[k];
      any_bad |= s_bad[k];
    }
    part = tot;
    if (kernel == kC || kernel == kM) part = any_bad ? INFINITY : -tot;
  }
  return part;
}

// All threads of a B1/B2 block lay row p's program out in shared memory at
// once: in each pass of kThreads positions, thread t takes position t0 + t
// and reads slot slots[t0 + t] of the row (B1: the heap's full postorder)
// or slot t0 + t (B2, slots = null: the postfix stream itself), its opcode
// and argument together; a warp ballot plus a prefix over the warps'
// counts give each non-EMPTY slot its place in the instruction list.
// Returns the list's length; the list is visible to the block on return.
__device__ int load_program(const int* __restrict__ op, const int* __restrict__ arg,
                            const int* __restrict__ slots, int p, int N, int F,
                            const float* __restrict__ consts, int C, unsigned fn_mask,
                            const Program& pr) {
  __shared__ int s_cnt[kWarps];
  const int* op_p = op + static_cast<size_t>(p) * N;
  const int* arg_p = arg + static_cast<size_t>(p) * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int len = 0;
  for (int t0 = 0; t0 < N; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int i = (t < N && slots) ? __ldg(slots + t) : t;
    const int o = t < N ? __ldg(op_p + i) : kEmpty;
    const int a = t < N ? __ldg(arg_p + i) : 0;
    const unsigned keep = __ballot_sync(0xffffffffu, o != kEmpty);
    if (lane == 0) s_cnt[warp] = __popc(keep);
    __syncthreads();
    int at = len + __popc(keep & ((1u << lane) - 1u));
    for (int k = 0; k < warp; ++k) at += s_cnt[k];
    if (o != kEmpty) put_instr(pr, at, o, a, F, consts, C, fn_mask);
    for (int k = 0; k < kWarps; ++k) len += s_cnt[k];
    __syncthreads();
  }
  return len;
}

// apply_fn on V operand pairs with one decode: a[k] = fn(a[k], b[k]); an
// opcode outside the switch (or a disabled one, passed as -1) gives 0.
template <int V>
__device__ __forceinline__ void apply_fn_v(int op, float (&a)[V], const float (&b)[V]) {
#define GP_FN_V(expr)             \
  _Pragma("unroll")               \
  for (int k = 0; k < V; ++k) {   \
    const float x = a[k];         \
    const float y = b[k];         \
    (void)y;                      \
    a[k] = (expr);                \
  }                               \
  return;
  switch (op) {
    case 3: GP_FN_V(x + y)
    case 4: GP_FN_V(x - y)
    case 5: GP_FN_V(x * y)
    case 6: GP_FN_V(fabsf(y) < 1e-9f ? 1.0f : x / y)
    case 7: GP_FN_V(-x)
    case 8: GP_FN_V(fabsf(x))
    case 9: GP_FN_V(sinf(x))
    case 10: GP_FN_V(cosf(x))
    case 11: GP_FN_V(sqrtf(fabsf(x)))
    case 12: GP_FN_V(logf(fabsf(x) + 1e-9f))
    case 13: GP_FN_V(x * x)
    case 14: GP_FN_V(nan_min(x, y))
    case 15: GP_FN_V(nan_max(x, y))
    default: GP_FN_V(0.0f)
  }
#undef GP_FN_V
}

// V points' predictions at once: the instruction list run on a register
// stack of S floats per point (slot 0 = top), one decode of each
// instruction for all V points. With Prefetch the next instruction's
// shared-memory loads are issued before this one runs: that shortens a
// lone warp's chain of latencies (the probe), while a block with many
// warps in flight (B1, B2) runs faster without the extra instructions. A
// feature terminal's values come from `term(idx, k)` for point k (the V
// calls are independent, so their loads are in flight together); an empty
// list predicts 0. Every point gets the reference's f32 operation per node.
template <int S, int V, bool Prefetch, class Term>
__device__ __forceinline__ void run_program_v(const Program& pr, int len, Term term,
                                              float (&pred)[V]) {
  float st[V][S];
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int j = 0; j < S; ++j) st[k][j] = 0.0f;
  }
  int o_next = len ? pr.code[0] : kEmpty;
  int i_next = len ? pr.idx[0] : 0;
  float v_next = len ? pr.val[0] : 0.0f;
  for (int t = 0; t < len; ++t) {
    int o, idx;
    float val;
    if (Prefetch) {
      o = o_next;
      idx = i_next;
      val = v_next;
      const int u = min(t + 1, len - 1);
      o_next = pr.code[u];
      i_next = pr.idx[u];
      v_next = pr.val[u];
    } else {
      o = pr.code[t];
    }
    if (o == kFeature || o == kConst) {
      float v[V];
      if (o == kFeature) {
        if (!Prefetch) idx = pr.idx[t];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = term(idx, k);
      } else {
        if (!Prefetch) val = pr.val[t];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = val;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int j = S - 1; j > 0; --j) st[k][j] = st[k][j - 1];
        st[k][0] = v[k];
      }
    } else {
      if (!Prefetch) idx = pr.idx[t];
      const int f = idx ? o : -1;
      const bool binary = arity_of(o) == 2;
      float a[V], b[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] = binary ? st[k][1] : st[k][0];
        b[k] = binary ? st[k][0] : 0.0f;
      }
      apply_fn_v<V>(f, a, b);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        st[k][0] = a[k];
        if (binary) {
#pragma unroll
          for (int j = 1; j < S - 1; ++j) st[k][j] = st[k][j + 1];
          st[k][S - 1] = 0.0f;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) pred[k] = len ? st[k][0] : 0.0f;
}

// Thread 0 of a fitness block hands its partial to the tile merge inside
// the kernel: with one tile it is tree p's result; otherwise it stores it
// and draws a ticket from tree p's counter with one acquire-release
// atomic (the release publishes the partial; the acquire of the last
// ticket sees every partial, as all the ticket's writes are atomic adds).
// The block that draws the last ticket sums the tree's partials in tile
// order (the reference's j == 0 store, j != 0 merge; no float atomics, so
// the result never changes from run to run), writes out[p] and resets the
// counter to 0.
__device__ void merge_partial(float part, int p, int tile, int T,
                              float* __restrict__ partial, int* __restrict__ tickets,
                              float* __restrict__ out) {
  if (T == 1) {
    out[p] = part;
    return;
  }
  partial[static_cast<size_t>(p) * T + tile] = part;
  int drawn;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(drawn)
               : "l"(tickets + p)
               : "memory");
  if (drawn != T - 1) return;
  const volatile float* row = partial + static_cast<size_t>(p) * T;
  float tot = row[0];
  for (int t = 1; t < T; ++t) tot += row[t];
  out[p] = tot;
  tickets[p] = 0;
}

// The arguments of a B1/B2 launch (kernel parameters, passed by value).
struct FitnessArgs {
  const int* op;
  const int* arg;
  const int* slots;  // B1: the heap's postorder, int32[N]; B2: null
  int N;
  const float* X;
  int F, D;
  const float* y;
  const float* w;  // null: all ones
  const float* consts;
  int C;
  unsigned fn_mask;
  int kernel;
  float n_classes_m1, precision;
  int chunk;
  const unsigned char* gate;  // null: always run
  int run_when;
  float* partial;  // P * tiles floats
  int* tickets;    // P int32 zeros; left zero
  float* out;      // P floats
};

// The block body of B1 and B2: tree blockIdx.y's program (`load_program`),
// then tile blockIdx.x of the points. Thread t takes the points
// tile * chunk + t + k * kThreads, V of them through the program together,
// and folds them into its partial in increasing k: B3's and B4's order
// (`gather_block`), so B1-B4 stay bitwise alike. The tile's partial goes
// to `merge_partial`.
template <int S, int V>
__device__ __forceinline__ void fitness_block(const FitnessArgs& a) {
  if (gated_off(a.gate, a.run_when)) return;
  extern __shared__ __align__(16) int smem[];
  const Program pr = program_at(smem, a.N);
  const int p = blockIdx.y;
  const int len = load_program(a.op, a.arg, a.slots, p, a.N, a.F, a.consts, a.C, a.fn_mask, pr);
  const float* __restrict__ X = a.X;
  const int D = a.D;
  const int tile = blockIdx.x;
  const int d_end = min(D, (tile + 1) * a.chunk);
  float acc = 0.0f;
  int bad = 0;
  for (int d0 = tile * a.chunk + threadIdx.x; d0 < d_end; d0 += V * kThreads) {
    int d[V];
    float pred[V];
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = min(d0 + k * kThreads, D - 1);
    run_program_v<S, V, false>(
        pr, len,
        [&](int row, int k) { return __ldg(X + static_cast<size_t>(row) * D + d[k]); }, pred);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (d0 + k * kThreads < d_end)
        epilogue(a.kernel, pred[k], __ldg(a.y + d[k]), a.w ? __ldg(a.w + d[k]) : 1.0f,
                 a.n_classes_m1, a.precision, acc, bad);
    }
  }
  const float part = block_partial(acc, bad, a.kernel);
  if (threadIdx.x == 0) merge_partial(part, p, tile, gridDim.x, a.partial, a.tickets, a.out);
}

// B1: heap trees (a.slots = the full heap's postorder).
template <int S, int V>
__global__ void __launch_bounds__(kThreads) eval_partial_kernel(const FitnessArgs a) {
  fitness_block<S, V>(a);
}

// B2: postfix streams. The active program is the row's non-EMPTY slots in
// order (a contiguous prefix under invariant P1; EMPTY slots anywhere are
// skipped, as the reference's interpreter holds its stack through them).
template <int S, int V>
__global__ void __launch_bounds__(kThreads) postfix_partial_kernel(const FitnessArgs a) {
  fitness_block<S, V>(a);
}

// --- the probe: postfix predictions with no epilogue ---------------------------

constexpr int kProbeRows = 8;    // rows (warps) a probe block takes at most
constexpr int kProbeTerms = 32;  // feature terminals a row gathers up front

// 32-bit words of one probe row's shared memory: its program (3N), its
// first kProbeTerms feature terminals' rows, and their values at the warp's
// 32 points.
__host__ __device__ constexpr size_t probe_row_words(int N) {
  return 3 * static_cast<size_t>(N) + kProbeTerms + kProbeTerms * 32;
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Predictions preds[p, d] of postfix rows: one warp per row, blockDim.x / 32
// rows a block. The warp lays its row out in its slice of shared memory by
// ballot, two rounds of 32 slots at a time with their loads issued
// together; a feature terminal's operand is its rank among the row's
// feature terminals (past kProbeTerms: kProbeTerms + its feature row, read
// from X in the interpreter), a constant's value is copied in by cp.async.
// Then per 32 points (lane = point) each lane copies its point's value of
// every gathered terminal with cp.async, all in flight at once, and the
// warp runs the program on shared memory alone (B2's interpreter, V = 1,
// with the next instruction prefetched).
template <int S>
__global__ void __launch_bounds__(kThreads) postfix_predict_kernel(
    const int* __restrict__ op, const int* __restrict__ arg, int P, int N,
    const float* __restrict__ X, int F, int D, const float* __restrict__ consts, int C,
    unsigned fn_mask, float* __restrict__ preds) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t p = static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (p >= static_cast<size_t>(P)) return;  // a whole warp: no __syncwarp waits on it
  int* row_smem = smem + warp * probe_row_words(N);
  const Program pr = program_at(row_smem, N);                      // [3N]
  int* s_frow = row_smem + 3 * N;                                  // [kProbeTerms]
  float* s_term = reinterpret_cast<float*>(s_frow + kProbeTerms);  // [kProbeTerms][32]
  const int* op_p = op + p * N;
  const int* arg_p = arg + p * N;
  const unsigned below = (1u << lane) - 1u;
  int len = 0, nf = 0;
  for (int t0 = 0; t0 < N; t0 += 64) {
    int o[2], a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 32 * r + lane;
      o[r] = t < N ? __ldg(op_p + t) : kEmpty;
      a[r] = t < N ? __ldg(arg_p + t) : 0;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned keep = __ballot_sync(0xffffffffu, o[r] != kEmpty);
      const unsigned feat = __ballot_sync(0xffffffffu, o[r] == kFeature);
      const int at = len + __popc(keep & below);
      if (o[r] == kFeature) {
        const int j = nf + __popc(feat & below);
        const int row = min(max(a[r], 0), F - 1);
        if (j < kProbeTerms) s_frow[j] = row;
        pr.code[at] = kFeature;
        pr.idx[at] = j < kProbeTerms ? j : kProbeTerms + row;
      } else if (o[r] == kConst) {
        pr.code[at] = kConst;
        cp_async_4(pr.val + at, consts + min(max(a[r], 0), C - 1));
      } else if (o[r] != kEmpty) {
        pr.code[at] = o[r];
        pr.idx[at] = fn_enabled(o[r], fn_mask);
      }
      len += __popc(keep);
      nf += __popc(feat);
    }
  }
  __syncwarp();
  const int gathered = min(nf, kProbeTerms);
  float* out = preds + p * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = min(d0 + lane, D - 1);
    for (int j = 0; j < gathered; ++j)
      cp_async_4(s_term + j * 32 + lane, X + static_cast<size_t>(s_frow[j]) * D + d);
    cp_async_wait_all();
    __syncwarp();  // every lane's copies (the constants) are visible to the warp
    float pred[1];
    run_program_v<S, 1, true>(
        pr, len,
        [&](int idx, int) {
          return idx < kProbeTerms ? s_term[idx * 32 + lane]
                                   : __ldg(X + static_cast<size_t>(idx - kProbeTerms) * D + d);
        },
        pred);
    if (d0 + lane < D) out[d0 + lane] = pred[0];
  }
}

// --- B3 / B4: the epilogue over gathered prediction rows ------------------------

// The arguments of a B3/B4 launch (kernel parameters, passed by value).
struct GatherArgs {
  const int* root;  // B3: int32[P], rows = uniq f32[U, D]; B4: null, rows = preds f32[P, D]
  const float* rows;
  int U, D;
  const float* y;
  const float* w;  // null: all ones
  int kernel;
  float n_classes_m1, precision;
  int chunk;
  const unsigned char* gate;  // null: always run
  int run_when;
  float* partial;  // P * tiles floats
  int* tickets;    // P int32 zeros; left zero
  float* out;      // P floats
};

// Thread t's points of a tile (n points from `row`, `y`, `w`) through the
// epilogue of fitness kernel K: points t + k * kThreads in increasing k,
// V of them loaded at once (all of them for V * kThreads >= n).
template <int V, int K>
__device__ __forceinline__ void fold_points(const float* __restrict__ row,
                                            const float* __restrict__ y,
                                            const float* __restrict__ w, int n,
                                            float n_classes_m1, float precision, float& acc,
                                            int& bad) {
  for (int i0 = threadIdx.x; i0 < n; i0 += V * kThreads) {
    float v[V], yv[V], wv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = min(i0 + k * kThreads, n - 1);
      v[k] = __ldg(row + i);
      yv[k] = __ldg(y + i);
      wv[k] = w ? __ldg(w + i) : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (i0 + k * kThreads < n)
        epilogue(K, v[k], yv[k], wv[k], n_classes_m1, precision, acc, bad);
    }
  }
}

// The block body of B3 and B4: tile blockIdx.x of tree blockIdx.y's
// prediction row (B3: uniq[clamp(root[p], 0, U - 1)], root read once; B4:
// preds[p]) through the epilogue. Each thread loads all its points of the
// tile at once (V = tile / kThreads, up to 16), so the block has its whole
// slice of the row, y and w in flight together, and folds them in B1's and
// B2's order (`fold_points`); the fitness kernel's branch is taken once per
// block, not per point. The tile's partial goes to `merge_partial`: one
// launch a call.
template <int V>
__device__ __forceinline__ void gather_block(const GatherArgs& a) {
  if (gated_off(a.gate, a.run_when)) return;  // before any ticket: they stay zero
  const int p = blockIdx.y;
  const int tile = blockIdx.x;
  const size_t r = a.root ? static_cast<size_t>(min(max(__ldg(a.root + p), 0), a.U - 1))
                          : static_cast<size_t>(p);
  const int lo = tile * a.chunk;
  const int n = min(a.D, lo + a.chunk) - lo;
  const float* row = a.rows + r * a.D + lo;
  const float* y = a.y + lo;
  const float* w = a.w ? a.w + lo : nullptr;
  float acc = 0.0f;
  int bad = 0;
  switch (a.kernel) {
    case kR: fold_points<V, kR>(row, y, w, n, a.n_classes_m1, a.precision, acc, bad); break;
    case kC: fold_points<V, kC>(row, y, w, n, a.n_classes_m1, a.precision, acc, bad); break;
    case kM: fold_points<V, kM>(row, y, w, n, a.n_classes_m1, a.precision, acc, bad); break;
    default: fold_points<V, kMse>(row, y, w, n, a.n_classes_m1, a.precision, acc, bad);
  }
  const float part = block_partial(acc, bad, a.kernel);
  if (threadIdx.x == 0) merge_partial(part, p, tile, gridDim.x, a.partial, a.tickets, a.out);
}

// B3 (a.root != null): the tree's row is uniq[clamp(root[p], 0, U - 1)].
template <int V>
__global__ void __launch_bounds__(kThreads) from_subtrees_kernel(const GatherArgs a) {
  gather_block<V>(a);
}

// B4 (a.root == null): the tree's row is preds[p].
template <int V>
__global__ void __launch_bounds__(kThreads) from_preds_kernel(const GatherArgs a) {
  gather_block<V>(a);
}

// --- the unique-subtree table ---------------------------------------------------
//
// Persistent blocks (one per SM, kTableThreads threads, nearly all of the
// SM's shared memory). Each block stages the live slots' metadata once,
// computes each slot's subtree height and buckets the slots by height (a
// slot's operands are strictly lower, so the slots of one height are
// independent), then walks its tiles of points: per tile it evaluates one
// height at a time with a block barrier between heights, keeping every
// slot's value at the tile's points in shared memory, and writes the
// tile's rows out at the end. The order inside a height is free: each
// slot gets the same apply_fn on the same operand bits whatever it is.

constexpr int kTableThreads = 512;

// A slot's kind in the staged metadata (a function slot keeps its opcode).
constexpr int kZeroSlot = -1;     // an unused slot or a disabled function: 0
constexpr int kFeatureSlot = -2;  // a = the clamped feature row
constexpr int kConstSlot = -3;    // a = the constant's bits
constexpr int kTableKinds = 32;   // sort bins a height: the three kinds, opcodes 3..31

// The sort bin of a staged word's kind or opcode (its low byte).
__device__ __forceinline__ int table_kind(int word) {
  const int code = static_cast<signed char>(word & 0xff);
  return code < 0 ? code + 3 : code;
}

struct SlotMeta {
  int code, a, b;
};

// Slot s's span length (`len`) and kind with its operands (the operand ids
// clamped to the live slots; a unary function has both the same). The five
// plan entries are loaded at once, then a constant's value.
__device__ __forceinline__ SlotMeta slot_meta(int s, const int* __restrict__ uop,
                                              const int* __restrict__ uarg,
                                              const int* __restrict__ ulhs,
                                              const int* __restrict__ urhs,
                                              const int* __restrict__ ulen, int n_live, int F,
                                              const float* __restrict__ consts, int C,
                                              unsigned fn_mask, int& len) {
  const int o = __ldg(uop + s);
  const int a = __ldg(uarg + s);
  const int l = __ldg(ulhs + s);
  const int r = __ldg(urhs + s);
  len = __ldg(ulen + s);
  if (len == 1) {
    if (o == kFeature) return {kFeatureSlot, min(max(a, 0), F - 1), 0};
    return {kConstSlot, __float_as_int(__ldg(consts + min(max(a, 0), C - 1))), 0};
  }
  if (len >= 2 && o >= 0 && o < 32 && ((fn_mask >> o) & 1u))
    return {o, min(max(l, 0), n_live - 1), min(max(r, 0), n_live - 1)};
  return {kZeroSlot, 0, 0};
}

// The fallback when the block's shared memory cannot hold the live slots'
// metadata and one point's values: per tile of 32 points, one span length
// at a time (operands have strictly shorter spans), each warp scans the
// slots 32 at a time and evaluates the ones of that length, with operands
// read back from the table.
__device__ void table_by_scan(const int* __restrict__ uop, const int* __restrict__ uarg,
                              const int* __restrict__ ulhs, const int* __restrict__ urhs,
                              const int* __restrict__ ulen, int n_live,
                              const float* __restrict__ X, int F, int D,
                              const float* __restrict__ consts, int C, unsigned fn_mask,
                              int* cell, float* uniq) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *cell = 0;
  __syncthreads();
  int my_max = 0;
  for (int s = threadIdx.x; s < n_live; s += kTableThreads)
    my_max = max(my_max, __ldg(ulen + s));
  atomicMax(cell, my_max);
  __syncthreads();
  const int max_len = *cell;
  for (int tile = blockIdx.x; tile < (D + 31) / 32; tile += gridDim.x) {
    const int d = tile * 32 + lane;
    for (int L = 0; L <= max_len; ++L) {
      for (int s0 = (threadIdx.x >> 5) * 32; s0 < n_live; s0 += kTableThreads) {
        const int s = s0 + lane;
        const int len = s < n_live ? min(max(__ldg(ulen + s), 0), max_len) : -1;
        unsigned hit = __ballot_sync(0xffffffffu, len == L);
        while (hit) {
          const int q = s0 + __ffs(hit) - 1;
          hit &= hit - 1;
          int q_len;
          const SlotMeta m = slot_meta(q, uop, uarg, ulhs, urhs, ulen, n_live, F, consts, C,
                                       fn_mask, q_len);
          if (d < D) {
            float v = 0.0f;
            if (m.code >= 0)
              v = apply_fn(m.code, uniq[static_cast<size_t>(m.a) * D + d],
                           uniq[static_cast<size_t>(m.b) * D + d]);
            else if (m.code == kFeatureSlot)
              v = __ldg(X + static_cast<size_t>(m.a) * D + d);
            else if (m.code == kConstSlot)
              v = __int_as_float(m.a);
            uniq[static_cast<size_t>(q) * D + d] = v;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Points per tile: the widest power of two up to 32 whose values fit `free`
// floats of shared memory for n_live slots and that still gives every block
// a tile, or half of it where that cuts the most points a block takes by an
// eighth or more.
__device__ __forceinline__ int table_tile(int n_live, size_t free, int D, int blocks) {
  int w = 32;
  while (w > 1 && (static_cast<size_t>(n_live) * w > free || (D + w - 1) / w < blocks))
    w >>= 1;
  auto share = [&](int t) { return ((D + t - 1) / t + blocks - 1) / blocks * t; };
  if (w > 1 && 8 * share(w / 2) <= 7 * share(w)) w >>= 1;
  return w;
}

template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x;
      v[k + 1] = t.y;
      v[k + 2] = t.z;
      v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// One tile's values vals[slot][point] (2**lg points from d0), one height at
// a time with a barrier between heights. A thread takes K neighbouring
// points of one slot at once: one decode, vector loads of both operand
// rows from shared memory, K independent applications (apply_fn_v, the
// same f32 operation per point as apply_fn). Neighbouring threads take the
// next points of the slot, then the next slots of the (height, kind)
// order, so a warp's slots mostly share their opcode.
template <int K>
__device__ void eval_tile(const int* start, int top, const int* order, const int* word,
                          const unsigned* ops, float* vals, int lg,
                          const float* __restrict__ X, int D, int d0) {
  constexpr int lg_k = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
  const int lg_c = lg - lg_k;  // chunks of K points a slot
  for (int g = 0; g < top; ++g) {
    const int lo = start[g * kTableKinds];
    const int items = (start[(g + 1) * kTableKinds] - lo) << lg_c;
    for (int i = threadIdx.x; i < items; i += kTableThreads) {
      const int s = order[lo + (i >> lg_c)];
      const int c = (i & ((1 << lg_c) - 1)) << lg_k;
      const int code = static_cast<signed char>(word[s] & 0xff);
      const unsigned ab = ops[s];
      float a[K];
      if (code >= 0) {
        float b[K];
        load_k<K>(vals + ((ab & 0xffffu) << lg) + c, a);
        load_k<K>(vals + ((ab >> 16) << lg) + c, b);
        apply_fn_v<K>(code, a, b);
      } else if (code == kFeatureSlot) {
        const float* row = X + static_cast<size_t>(ab) * D;
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = __ldg(row + min(d0 + c + k, D - 1));
      } else {
        const float v = code == kConstSlot ? __int_as_float(static_cast<int>(ab)) : 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = v;
      }
      store_k<K>(vals + (s << lg) + c, a);
    }
    __syncthreads();
  }
}

// The table: rows [0, n_live) of the live slots, n_live = min(n_unique, U)
// (all U on overflow), and the reserved all-EMPTY row U - 1, written 0 when
// it is not live. Shared memory (`smem_bytes` of it) holds each live slot's
// place in the height order, its height and kind, and its two operand ids
// (16 bits each; 12 bytes a slot), the height bounds, and the slots' values
// at the tile's points; where not even one point's values fit, the block
// falls back to `table_by_scan`.
__global__ void __launch_bounds__(kTableThreads) unique_table_kernel(
    const int* __restrict__ uop, const int* __restrict__ uarg,
    const int* __restrict__ ulhs, const int* __restrict__ urhs,
    const int* __restrict__ ulen, const int* __restrict__ n_unique, int U,
    const float* __restrict__ X, int F, int D, const float* __restrict__ consts, int C,
    unsigned fn_mask, const unsigned char* __restrict__ gate, int run_when, int smem_bytes,
    float* uniq) {
  if (gated_off(gate, run_when)) return;
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_cell, s_max_len;
  const int n_live = min(max(__ldg(n_unique), 0), U);
  if (n_live < U) {
    for (int d = blockIdx.x * kTableThreads + threadIdx.x; d < D;
         d += gridDim.x * kTableThreads)
      uniq[static_cast<size_t>(U - 1) * D + d] = 0.0f;
  }
  if (n_live == 0) return;
  if (n_live > 65535 || 4 * static_cast<size_t>(n_live) * sizeof(int) >
                           static_cast<size_t>(smem_bytes)) {
    table_by_scan(uop, uarg, ulhs, urhs, ulen, n_live, X, F, D, consts, C, fn_mask, &s_cell,
                  uniq);
    return;
  }
  int* order = smem;                // [n_live] the slots by height
  int* word = order + n_live;       // [n_live] height << 8 | kind or opcode
  unsigned* ops = reinterpret_cast<unsigned*>(word + n_live);  // [n_live] b << 16 | a
  if (threadIdx.x == 0) s_cell = s_max_len = 0;
  int my_len = 0;
  for (int s = threadIdx.x; s < n_live; s += kTableThreads) {
    int len;
    const SlotMeta m = slot_meta(s, uop, uarg, ulhs, urhs, ulen, n_live, F, consts, C,
                                 fn_mask, len);
    word[s] = m.code & 0xff;
    // terminals keep their value in the operand field: a feature row, or
    // the constant's bits (the only kind that needs all 32)
    ops[s] = m.code >= 0 ? (static_cast<unsigned>(m.b) << 16) | static_cast<unsigned>(m.a)
                         : static_cast<unsigned>(m.a);
    my_len = max(my_len, len);
  }
  __syncthreads();
  my_len = __reduce_max_sync(0xffffffffu, my_len);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_max_len, my_len);
  __syncthreads();
  // A height is below the slot's span length, so heights lie in [0, cap]
  // for a plan that fits its cap; the cap binds only on one that
  // overflowed, whose clamped operand ids may form cycles. The slots are
  // sorted by (height, kind or opcode): kTableKinds bins a height.
  const int cap = min(max(s_max_len - 1, 0), n_live);
  const int n_keys = (cap + 1) * kTableKinds;
  // (vals start on a 16-byte boundary, for vector access)
  const size_t words =
      (3 * static_cast<size_t>(n_live) + 2 * static_cast<size_t>(n_keys + 1) + 3) & ~size_t{3};
  if ((words + n_live) * sizeof(int) > static_cast<size_t>(smem_bytes)) {
    table_by_scan(uop, uarg, ulhs, urhs, ulen, n_live, X, F, D, consts, C, fn_mask, &s_cell,
                  uniq);
    return;
  }
  int* start = smem + 3 * n_live;   // [n_keys + 1] bounds of each (height, kind)
  int* cursor = start + n_keys + 1;  // [n_keys + 1] counts, then places
  float* vals = reinterpret_cast<float*>(smem + words);  // [n_live][tile]
  int* height = reinterpret_cast<int*>(vals);            // [n_live], before vals
  for (int s = threadIdx.x; s < n_live; s += kTableThreads) height[s] = 0;
  for (int g = threadIdx.x; g <= n_keys; g += kTableThreads) cursor[g] = 0;
  __syncthreads();
  // heights by relaxation: every function slot takes 1 + its operands'
  // larger height until a round changes nothing (one round per height,
  // plus one)
  for (int round = 0; round <= cap; ++round) {
    int changed = 0;
    for (int s = threadIdx.x; s < n_live; s += kTableThreads) {
      if (static_cast<signed char>(word[s] & 0xff) < 0) continue;
      const unsigned ab = ops[s];
      const int h = min(1 + max(height[ab & 0xffffu], height[ab >> 16]), cap);
      if (h != height[s]) {
        height[s] = h;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  int my_top = 0;
  for (int s = threadIdx.x; s < n_live; s += kTableThreads) {
    word[s] |= (height[s] * kTableKinds + table_kind(word[s])) << 8;
    atomicAdd(cursor + (word[s] >> 8), 1);
    my_top = max(my_top, height[s]);
  }
  my_top = __reduce_max_sync(0xffffffffu, my_top);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_cell, my_top);
  __syncthreads();
  const int top = s_cell + 1;  // the heights present: 0 .. top - 1
  // counting sort by (height, kind): a warp scans the counts, then each
  // slot takes a place in its key's range (in whatever order the atomics
  // give); the slots of a warp's lanes mostly share their opcode, so the
  // opcode branches rarely diverge
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int n_bins = top * kTableKinds;
    int carry = 0;
    for (int b0 = 0; b0 < n_bins; b0 += 32) {
      const int b = b0 + lane;
      const int c = b < n_bins ? cursor[b] : 0;
      int x = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += v;
      }
      if (b < n_bins) start[b] = cursor[b] = carry + x - c;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) start[n_bins] = carry;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_live; s += kTableThreads)
    order[atomicAdd(cursor + (word[s] >> 8), 1)] = s;
  __syncthreads();

  const int w = table_tile(n_live, smem_bytes / sizeof(int) - words, D, gridDim.x);
  const int lg = __ffs(w) - 1;
  for (int tile = blockIdx.x; tile < (D + w - 1) / w; tile += gridDim.x) {
    const int d0 = tile * w;
    if (w >= 8)
      eval_tile<8>(start, top, order, word, ops, vals, lg, X, D, d0);
    else if (w == 4)
      eval_tile<4>(start, top, order, word, ops, vals, lg, X, D, d0);
    else if (w == 2)
      eval_tile<2>(start, top, order, word, ops, vals, lg, X, D, d0);
    else
      eval_tile<1>(start, top, order, word, ops, vals, lg, X, D, d0);
    // the tile's rows, coalesced (16 bytes a thread where rows allow it)
    if (w >= 4 && (D & 3) == 0) {
      for (int i = threadIdx.x; i < (n_live << lg) / 4; i += kTableThreads) {
        const int d = d0 + ((4 * i) & (w - 1));
        if (d < D)
          *reinterpret_cast<float4*>(uniq + static_cast<size_t>((4 * i) >> lg) * D + d) =
              reinterpret_cast<const float4*>(vals)[i];
      }
    } else {
      for (int i = threadIdx.x; i < (n_live << lg); i += kTableThreads) {
        const int d = d0 + (i & (w - 1));
        if (d < D) uniq[static_cast<size_t>(i >> lg) * D + d] = vals[i];
      }
    }
    __syncthreads();
  }
}

bool valid_fitness_args(int kernel, int D, int chunk, int P) {
  return kernel >= kR && kernel <= kMse && D > 0 && chunk > 0 && P <= 65535;
}

template <int V>
void launch_gather_v(dim3 grid, cudaStream_t st, const GatherArgs& a) {
  if (a.root)
    from_subtrees_kernel<V><<<grid, kThreads, 0, st>>>(a);
  else
    from_preds_kernel<V><<<grid, kThreads, 0, st>>>(a);
}

// One B3 (a.root != null) or B4 launch of P trees: grid (tiles, trees), V =
// the thread's points per tile (chunk / kThreads), at most 16.
int launch_gather(int P, const GatherArgs& a, cudaStream_t st) {
  const int per = a.chunk / kThreads;
  auto launch = per >= 16 ? launch_gather_v<16> : per >= 8 ? launch_gather_v<8>
              : per >= 4  ? launch_gather_v<4>  : per >= 2 ? launch_gather_v<2>
                          : launch_gather_v<1>;
  launch(dim3((a.D + a.chunk - 1) / a.chunk, P), st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int V>
void launch_fitness(bool heap, dim3 grid, size_t smem, cudaStream_t st, const FitnessArgs& a) {
  if (heap)
    eval_partial_kernel<S, V><<<grid, kThreads, smem, st>>>(a);
  else
    postfix_partial_kernel<S, V><<<grid, kThreads, smem, st>>>(a);
}

// One B1 (heap) or B2 launch of P trees: grid (tiles, trees), a register
// stack of 8 floats when the programs' stack bound allows it, else 12, and
// V = the thread's points per tile (chunk / kThreads), at most 4.
int launch_rows(bool heap, int P, int stack_bound, const FitnessArgs& a, cudaStream_t st) {
  const int V = a.chunk >= 4 * kThreads ? 4 : a.chunk >= 2 * kThreads ? 2 : 1;
  const dim3 grid((a.D + a.chunk - 1) / a.chunk, P);
  const size_t smem = static_cast<size_t>(a.N) * 3 * sizeof(int);
  auto launch = stack_bound <= 8
                    ? (V == 4 ? launch_fitness<8, 4> : V == 2 ? launch_fitness<8, 2>
                                                               : launch_fitness<8, 1>)
                    : (V == 4 ? launch_fitness<12, 4> : V == 2 ? launch_fitness<12, 2>
                                                                : launch_fitness<12, 1>);
  launch(heap, grid, smem, st, a);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_probe(unsigned blocks, int rows, size_t smem, cudaStream_t st, const int* op,
                 const int* arg, int P, int N, const float* X, int F, int D,
                 const float* consts, int C, unsigned fn_mask, float* preds) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        postfix_predict_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  postfix_predict_kernel<S><<<blocks, 32 * rows, smem, st>>>(op, arg, P, N, X, F, D, consts,
                                                             C, fn_mask, preds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`,
// never synchronises and allocates nothing: `partial` holds
// P * ceil(D / chunk) floats (unused when there is one tile), `out` holds
// P floats, `tickets` P int32 zeros (B1-B4 leave them zero). Each returns
// cudaGetLastError() after its launch (0 on success). `gate` may be null
// (always run). B1-B4 take at most 65,535 trees a launch (gridDim.y); the
// wrappers launch more in chunks.

// B1, one launch. N = 2**(max_depth+1) - 1 heap slots per tree; `slots`
// int32[N] lists them in the full heap's postorder
// (argsort(postorder_table(N))).
extern "C" int gp_eval_fitness(const int* op, const int* arg, const int* slots, int P, int N,
                               int max_depth, const float* X, int F, int D, const float* y,
                               const float* w, const float* consts, int C,
                               unsigned fn_mask, int kernel, float n_classes_m1,
                               float precision, int chunk, float* partial, int* tickets,
                               float* out, void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || F <= 0 || C <= 0 || max_depth < 0 ||
      max_depth > 10 || N != (2 << max_depth) - 1 || slots == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FitnessArgs a{op,    arg,      slots,  N,     X,       F,       D,     y,
                      w,     consts,   C,      fn_mask, kernel, n_classes_m1, precision,
                      chunk, nullptr,  0,      partial, tickets, out};
  return launch_rows(true, P, max_depth + 1, a, static_cast<cudaStream_t>(stream));
}

// B2, one launch. Any N; stack_size is the programs' operand-stack bound
// (invariant P5).
extern "C" int gp_eval_postfix(const int* op, const int* arg, int P, int N, int stack_size,
                               const float* X, int F, int D, const float* y, const float* w,
                               const float* consts, int C, unsigned fn_mask, int kernel,
                               float n_classes_m1, float precision, int chunk,
                               const unsigned char* gate, int run_when, float* partial,
                               int* tickets, float* out, void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || F <= 0 || C <= 0 || N <= 0 ||
      stack_size < 1 || stack_size > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  const FitnessArgs a{op,    arg,    nullptr,  N,       X,       F,       D,     y,
                      w,     consts, C,        fn_mask, kernel,  n_classes_m1, precision,
                      chunk, gate,   run_when, partial, tickets, out};
  return launch_rows(false, P, stack_size, a, static_cast<cudaStream_t>(stream));
}

// B3, one launch. uniq is f32[U, D], root int32[P].
extern "C" int gp_fitness_from_subtrees(const int* root, int P, const float* uniq, int U,
                                        int D, const float* y, const float* w, int kernel,
                                        float n_classes_m1, float precision, int chunk,
                                        const unsigned char* gate, int run_when,
                                        float* partial, int* tickets, float* out,
                                        void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || U <= 0 || root == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const GatherArgs a{root,  uniq, U,        D,       y,       w,   kernel, n_classes_m1,
                     precision, chunk, gate, run_when, partial, tickets, out};
  return launch_gather(P, a, static_cast<cudaStream_t>(stream));
}

// B4, one launch. preds is f32[P, D].
extern "C" int gp_fitness_from_preds(const float* preds, int P, int D, const float* y,
                                     const float* w, int kernel, float n_classes_m1,
                                     float precision, int chunk, const unsigned char* gate,
                                     int run_when, float* partial, int* tickets, float* out,
                                     void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatherArgs a{nullptr, preds, P,        D,       y,       w,   kernel, n_classes_m1,
                     precision, chunk, gate, run_when, partial, tickets, out};
  return launch_gather(P, a, static_cast<cudaStream_t>(stream));
}

// The unique-subtree table uniq f32[U, D] of a dedup plan (uop, uarg,
// ulhs, urhs, ulen: int32[U]; n_unique: the plan's int32 count, read on
// the device), one launch of `blocks` persistent blocks with `smem_bytes`
// of dynamic shared memory each (at most 226 KB). Rows of the unused
// slots other than U - 1 are left unwritten.
extern "C" int gp_unique_table(const int* uop, const int* uarg, const int* ulhs,
                               const int* urhs, const int* ulen, const int* n_unique, int U,
                               const float* X, int F, int D, const float* consts, int C,
                               unsigned fn_mask, const unsigned char* gate, int run_when,
                               int blocks, int smem_bytes, float* uniq,
                               void* stream) {
  if (U <= 0 || D <= 0) return 0;
  if (F <= 0 || C <= 0 || blocks < 1 || smem_bytes < 0 || smem_bytes > 226 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        unique_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unique_table_kernel<<<blocks, kTableThreads, smem_bytes, st>>>(
      uop, uarg, ulhs, urhs, ulen, n_unique, U, X, F, D, consts, C, fn_mask, gate, run_when,
      smem_bytes, uniq);
  return static_cast<int>(cudaGetLastError());
}

// Postfix predictions preds f32[P, D] (no epilogue). stack_size as B2;
// `rows` rows (warps) a block, 1..kProbeRows, with rows * probe_row_words(N)
// 32-bit words of dynamic shared memory (at most 227 KB): the grid is
// ceil(P / rows) blocks, at most 2**31 - 1.
extern "C" int gp_predict_postfix(const int* op, const int* arg, int P, int N,
                                  int stack_size, const float* X, int F, int D,
                                  const float* consts, int C, unsigned fn_mask, int rows,
                                  float* preds, void* stream) {
  if (P <= 0 || D <= 0) return 0;
  const size_t smem = static_cast<size_t>(rows) * probe_row_words(N) * sizeof(int);
  const long long blocks = (static_cast<long long>(P) + rows - 1) / rows;
  if (F <= 0 || C <= 0 || N <= 0 || stack_size < 1 || stack_size > 12 || rows < 1 ||
      rows > kProbeRows || smem > 227 * 1024 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = stack_size <= 8 ? launch_probe<8> : launch_probe<12>;
  return launch(static_cast<unsigned>(blocks), rows, smem, static_cast<cudaStream_t>(stream),
                op, arg, P, N, X, F, D, consts, C, fn_mask, preds);
}
