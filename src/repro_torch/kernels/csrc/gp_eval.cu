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
//   * Grid (data tiles, trees) for B1-B4. A B1/B2 block lays its tree's
//     active instructions out in shared memory once: B1 (thread 0) walks
//     the heap in postorder, which is the tree's own postorder because
//     pruning removes whole subtrees; in B2 all threads load the postfix
//     stream at once and a warp ballot plus a prefix over the warps place
//     its non-EMPTY slots (the reference's EMPTY-hold), so no serial copy.
//   * Each thread walks that instruction list with a register stack of S
//     floats (S >= the program's stack depth): B1 one point at a time, B2
//     V points together (4 by default: one decode for four points, four X
//     loads in flight). Every node applies the same f32 operation to the same
//     operand values as the reference, so predictions are bitwise equal
//     to it for add/sub/mul/div/neg/abs/sqrt/square/min/max trees, and
//     heap and postfix forms of one tree agree bitwise.
//   * All threads of a block run the same tree, so the opcode branches
//     never diverge inside a warp; X is feature-major, so the threads of
//     a warp read neighbouring addresses of one feature row.
//   * The epilogue folds each point into a per-thread partial in a fixed
//     order (thread t: points t, t + 256, ... of the tile); the block
//     reduces with a fixed shuffle tree into one partial per (tree,
//     tile), and the partials are summed in tile order: by a second small
//     kernel after B1, B3 and B4, and inside B2 by the block that draws a
//     tree's last ticket (an int32 counter per tree). No float atomics:
//     results never change from run to run. B1-B4 share the epilogue, the
//     reduction and the merge order, so at one tile geometry their
//     moments are bitwise alike.
//   * B2-B4, their merges and the unique table take an optional device
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
// loop, and B2 decodes each instruction once for four points. B3/B4 read
// one f32 row per tree and tile plus y and w: memory (and, at kat7, the
// launch) bounds them. The unique table must write n_unique rows of D
// floats, which bounds it at large D; per tile it pays one barrier per
// height and the interpreter's decode per (slot, 8 points), which bound
// it at the paper's shapes.
//
// Numerics that match the reference: build with -fmad=false and without
// --use_fast_math (IEEE `/` and sqrtf), NaN-propagating min/max written
// out, rintf (round half to even) for classify, nan_to_num's +-inf ->
// +-FLT_MAX, `fabsf(b) < 1e-9f` for protected division and
// `logf(fabsf(a) + 1e-9f)` for log; an opcode outside the function-set
// mask evaluates to 0, as the reference's select chain does.

#include <cuda_runtime.h>
#include <float.h>
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
    float q = pred;  // nan_to_num
    if (isnan(q)) q = 0.0f;
    else if (isinf(q)) q = q > 0.0f ? FLT_MAX : -FLT_MAX;
    hit = fminf(fmaxf(rintf(q), 0.0f), n_classes_m1) == yd;
  } else {
    hit = fabsf(pred - yd) <= precision;
  }
  acc += (hit ? 1.0f : 0.0f) * wd;
  bad |= (isnan(pred) && wd > 0.0f) ? 1 : 0;
}

__device__ __forceinline__ bool gated_off(const unsigned char* gate, int run_when) {
  return gate != nullptr && ((*gate != 0) != (run_when != 0));
}

// Instruction `len` of a block's list in shared memory: the opcode, and
// the clamped feature row, the constant's value or the function-set flag.
__device__ __forceinline__ void put_instr(int* s_code, int* s_idx, float* s_val, int len,
                                          int o, int a, int F, const float* consts, int C,
                                          unsigned fn_mask) {
  s_code[len] = o;
  if (o == kFeature) {
    s_idx[len] = min(max(a, 0), F - 1);
  } else if (o == kConst) {
    s_val[len] = consts[min(max(a, 0), C - 1)];
  } else {
    s_idx[len] = (o < 32) ? static_cast<int>((fn_mask >> o) & 1u) : 0;
  }
}

// One point's prediction: the instruction list run on a register stack
// of S floats (slot 0 = top). An empty list predicts 0.
template <int S>
__device__ __forceinline__ float run_program(const int* s_code, const int* s_idx,
                                             const float* s_val, int len,
                                             const float* __restrict__ X, int D, int d) {
  float st[S];
#pragma unroll
  for (int k = 0; k < S; ++k) st[k] = 0.0f;
  for (int t = 0; t < len; ++t) {
    const int o = s_code[t];
    if (o == kFeature || o == kConst) {
      const float v = (o == kFeature) ? __ldg(X + static_cast<size_t>(s_idx[t]) * D + d)
                                      : s_val[t];
#pragma unroll
      for (int k = S - 1; k > 0; --k) st[k] = st[k - 1];
      st[0] = v;
    } else if (arity_of(o) == 1) {
      st[0] = s_idx[t] ? apply_fn(o, st[0], 0.0f) : 0.0f;
    } else {
      const float r = s_idx[t] ? apply_fn(o, st[1], st[0]) : 0.0f;
      st[0] = r;
#pragma unroll
      for (int k = 1; k < S - 1; ++k) st[k] = st[k + 1];
      st[S - 1] = 0.0f;
    }
  }
  return len ? st[0] : 0.0f;
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

// Folds the block's points of tile blockIdx.x (prediction `pred_at(d)`)
// into tree p's partial: the epilogue per point, in increasing d, then
// `block_partial`; thread 0 writes the partial.
template <class PredAt>
__device__ __forceinline__ void fold_tile(PredAt pred_at, int p, int D, int chunk,
                                          const float* __restrict__ y,
                                          const float* __restrict__ w, int kernel,
                                          float n_classes_m1, float precision,
                                          float* __restrict__ partial) {
  const int tile = blockIdx.x;
  const int d_end = min(D, (tile + 1) * chunk);
  float acc = 0.0f;
  int bad = 0;
  for (int d = tile * chunk + threadIdx.x; d < d_end; d += kThreads) {
    epilogue(kernel, pred_at(d), __ldg(y + d), w ? __ldg(w + d) : 1.0f, n_classes_m1,
             precision, acc, bad);
  }
  const float part = block_partial(acc, bad, kernel);
  if (threadIdx.x == 0) partial[static_cast<size_t>(p) * gridDim.x + tile] = part;
}

// B1: heap trees.
template <int S>
__global__ void __launch_bounds__(kThreads) eval_partial_kernel(
    const int* __restrict__ op, const int* __restrict__ arg, int N, int max_depth,
    const float* __restrict__ X, int F, int D, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ consts, int C,
    unsigned fn_mask, int kernel, float n_classes_m1, float precision, int chunk,
    float* __restrict__ partial) {
  extern __shared__ int smem[];
  int* s_code = smem;                                   // [N] opcode
  int* s_idx = smem + N;                                // [N] feature row | fn enabled
  float* s_val = reinterpret_cast<float*>(smem + 2 * N);  // [N] constant value
  __shared__ int s_len;

  const int p = blockIdx.y;
  const int* op_p = op + static_cast<size_t>(p) * N;
  const int* arg_p = arg + static_cast<size_t>(p) * N;

  if (threadIdx.x == 0) {
    int len = 0;
    int i = (1 << max_depth) - 1;  // leftmost slot of the deepest level
    for (;;) {
      const int o = op_p[i];
      if (o != kEmpty) {
        put_instr(s_code, s_idx, s_val, len, o, arg_p[i], F, consts, C, fn_mask);
        ++len;
      }
      if (i == 0) break;
      if (i & 1) {  // a left child: the right sibling's subtree comes next
        i += 1;
        while (2 * i + 1 < N) i = 2 * i + 1;
      } else {  // a right child: its parent comes next
        i = (i - 1) >> 1;
      }
    }
    s_len = len;
  }
  __syncthreads();
  const int len = s_len;
  fold_tile([&](int d) { return run_program<S>(s_code, s_idx, s_val, len, X, D, d); }, p,
            D, chunk, y, w, kernel, n_classes_m1, precision, partial);
}

// Thread 0 of a B2 or postfix-predict block: lays row p's postfix program
// (its non-EMPTY slots in order) out in shared memory as instructions and
// returns its length.
__device__ int load_postfix(const int* __restrict__ op, const int* __restrict__ arg, int p,
                            int N, int F, const float* __restrict__ consts, int C,
                            unsigned fn_mask, int* smem) {
  int* s_code = smem;
  int* s_idx = smem + N;
  float* s_val = reinterpret_cast<float*>(smem + 2 * N);
  const int* op_p = op + static_cast<size_t>(p) * N;
  const int* arg_p = arg + static_cast<size_t>(p) * N;
  int len = 0;
  for (int t = 0; t < N; ++t) {
    const int o = op_p[t];
    if (o == kEmpty) continue;
    put_instr(s_code, s_idx, s_val, len, o, arg_p[t], F, consts, C, fn_mask);
    ++len;
  }
  return len;
}

// All threads of a B2 block lay row p's postfix program out in shared
// memory at once: each takes one slot per pass of kThreads slots, and a
// warp ballot plus a prefix over the warps' counts give each non-EMPTY
// slot its place in the instruction list. Returns the list's length; the
// list is visible to the block on return.
__device__ int load_postfix_parallel(const int* __restrict__ op,
                                     const int* __restrict__ arg, int p, int N, int F,
                                     const float* __restrict__ consts, int C,
                                     unsigned fn_mask, int* smem) {
  __shared__ int s_cnt[kWarps];
  int* s_code = smem;
  int* s_idx = smem + N;
  float* s_val = reinterpret_cast<float*>(smem + 2 * N);
  const int* op_p = op + static_cast<size_t>(p) * N;
  const int* arg_p = arg + static_cast<size_t>(p) * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int len = 0;
  for (int t0 = 0; t0 < N; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int o = t < N ? __ldg(op_p + t) : kEmpty;
    const unsigned keep = __ballot_sync(0xffffffffu, o != kEmpty);
    if (lane == 0) s_cnt[warp] = __popc(keep);
    __syncthreads();
    int at = len + __popc(keep & ((1u << lane) - 1u));
    for (int k = 0; k < warp; ++k) at += s_cnt[k];
    if (o != kEmpty) put_instr(s_code, s_idx, s_val, at, o, __ldg(arg_p + t), F, consts, C,
                               fn_mask);
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

// V points' predictions at once (points d[0..V-1]): run_program's stack
// machine with one decode of each instruction for all V points and V
// independent X loads in flight per feature terminal. Each point gets the
// same f32 operations as run_program gives it.
template <int S, int V>
__device__ __forceinline__ void run_program_v(const int* s_code, const int* s_idx,
                                              const float* s_val, int len,
                                              const float* __restrict__ X, int D,
                                              const int (&d)[V], float (&pred)[V]) {
  float st[V][S];
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int j = 0; j < S; ++j) st[k][j] = 0.0f;
  }
  for (int t = 0; t < len; ++t) {
    const int o = s_code[t];
    if (o == kFeature || o == kConst) {
      float v[V];
      if (o == kFeature) {
        const float* row = X + static_cast<size_t>(s_idx[t]) * D;
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = __ldg(row + d[k]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = s_val[t];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int j = S - 1; j > 0; --j) st[k][j] = st[k][j - 1];
        st[k][0] = v[k];
      }
    } else {
      const int f = s_idx[t] ? o : -1;
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
// the kernel: with one tile it is tree p's result; otherwise it stores it,
// fences, and draws a ticket from tree p's counter. The block that draws
// the last ticket sums the tree's partials in tile order (the reference's
// j == 0 store, j != 0 merge; no float atomics, so the result never
// changes from run to run), writes out[p] and resets the counter to 0.
__device__ void merge_partial(float part, int p, int tile, int T,
                              float* __restrict__ partial, int* __restrict__ tickets,
                              float* __restrict__ out) {
  if (T == 1) {
    out[p] = part;
    return;
  }
  partial[static_cast<size_t>(p) * T + tile] = part;
  __threadfence();
  if (atomicAdd(tickets + p, 1) != T - 1) return;
  __threadfence();
  const volatile float* row = partial + static_cast<size_t>(p) * T;
  float tot = row[0];
  for (int t = 1; t < T; ++t) tot += row[t];
  out[p] = tot;
  tickets[p] = 0;
}

// B2: postfix streams. The active program is the row's non-EMPTY slots in
// order (a contiguous prefix under invariant P1; EMPTY slots anywhere are
// skipped, as the reference's interpreter holds its stack through them).
// Thread t takes the points tile * chunk + t + k * kThreads, V of them
// through the program together, and folds them into its partial in
// increasing k: fold_tile's order, so B1-B4 stay bitwise alike.
template <int S, int V>
__global__ void __launch_bounds__(kThreads) postfix_partial_kernel(
    const int* __restrict__ op, const int* __restrict__ arg, int N,
    const float* __restrict__ X, int F, int D, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ consts, int C,
    unsigned fn_mask, int kernel, float n_classes_m1, float precision, int chunk,
    const unsigned char* __restrict__ gate, int run_when, float* __restrict__ partial,
    int* __restrict__ tickets, float* __restrict__ out) {
  if (gated_off(gate, run_when)) return;
  extern __shared__ int smem[];
  const int p = blockIdx.y;
  const int len = load_postfix_parallel(op, arg, p, N, F, consts, C, fn_mask, smem);
  const int* s_code = smem;
  const int* s_idx = smem + N;
  const float* s_val = reinterpret_cast<const float*>(smem + 2 * N);
  const int tile = blockIdx.x;
  const int d_end = min(D, (tile + 1) * chunk);
  float acc = 0.0f;
  int bad = 0;
  for (int d0 = tile * chunk + threadIdx.x; d0 < d_end; d0 += V * kThreads) {
    int d[V];
    float pred[V];
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = min(d0 + k * kThreads, D - 1);
    run_program_v<S, V>(s_code, s_idx, s_val, len, X, D, d, pred);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (d0 + k * kThreads < d_end)
        epilogue(kernel, pred[k], __ldg(y + d[k]), w ? __ldg(w + d[k]) : 1.0f,
                 n_classes_m1, precision, acc, bad);
    }
  }
  const float part = block_partial(acc, bad, kernel);
  if (threadIdx.x == 0) merge_partial(part, p, tile, gridDim.x, partial, tickets, out);
}

// Postfix predictions preds[p, d] with no epilogue: B2's interpreter, for
// the semantic dedup tier's probe. Grid (point blocks, rows).
template <int S>
__global__ void __launch_bounds__(kThreads) postfix_predict_kernel(
    const int* __restrict__ op, const int* __restrict__ arg, int N,
    const float* __restrict__ X, int F, int D, const float* __restrict__ consts, int C,
    unsigned fn_mask, float* __restrict__ preds) {
  extern __shared__ int smem[];
  __shared__ int s_len;
  const int p = blockIdx.y;
  if (threadIdx.x == 0) s_len = load_postfix(op, arg, p, N, F, consts, C, fn_mask, smem);
  __syncthreads();
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  preds[static_cast<size_t>(p) * D + d] = run_program<S>(
      smem, smem + N, reinterpret_cast<const float*>(smem + 2 * N), s_len, X, D, d);
}

// B3: the tree's prediction row is uniq[clamp(root[p], 0, U - 1)].
__global__ void __launch_bounds__(kThreads) from_subtrees_kernel(
    const int* __restrict__ root, const float* __restrict__ uniq, int U, int D,
    const float* __restrict__ y, const float* __restrict__ w, int kernel,
    float n_classes_m1, float precision, int chunk, const unsigned char* __restrict__ gate,
    int run_when, float* __restrict__ partial) {
  if (gated_off(gate, run_when)) return;
  const int p = blockIdx.y;
  const float* row = uniq + static_cast<size_t>(min(max(root[p], 0), U - 1)) * D;
  fold_tile([&](int d) { return __ldg(row + d); }, p, D, chunk, y, w, kernel,
            n_classes_m1, precision, partial);
}

// B4: the tree's prediction row is preds[p].
__global__ void __launch_bounds__(kThreads) from_preds_kernel(
    const float* __restrict__ preds, int D, const float* __restrict__ y,
    const float* __restrict__ w, int kernel, float n_classes_m1, float precision,
    int chunk, const unsigned char* __restrict__ gate, int run_when,
    float* __restrict__ partial) {
  if (gated_off(gate, run_when)) return;
  const int p = blockIdx.y;
  const float* row = preds + static_cast<size_t>(p) * D;
  fold_tile([&](int d) { return __ldg(row + d); }, p, D, chunk, y, w, kernel,
            n_classes_m1, precision, partial);
}

// out[p] = sum over tiles of partial[p, :], in tile order (the reference's
// j == 0 store, j != 0 merge).
__global__ void merge_tiles_kernel(const float* __restrict__ partial, int P, int T,
                                   const unsigned char* __restrict__ gate, int run_when,
                                   float* __restrict__ out) {
  if (gated_off(gate, run_when)) return;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float* row = partial + static_cast<size_t>(p) * T;
  float tot = row[0];
  for (int t = 1; t < T; ++t) tot += row[t];
  out[p] = tot;
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
  extern __shared__ int smem[];
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

// The ordered tile merge after a partial kernel (none when one tile: the
// partial kernel then wrote `out` directly).
int merge_after(const float* partial, int P, int T, const unsigned char* gate,
                int run_when, float* out, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 1) {
    merge_tiles_kernel<<<(P + 127) / 128, 128, 0, st>>>(partial, P, T, gate, run_when,
                                                        out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`,
// never synchronises and allocates nothing: `partial` holds
// P * ceil(D / chunk) floats (unused when there is one tile), `out` holds
// P floats. Each returns cudaGetLastError() after its launches (0 on
// success). `gate` may be null (always run).

// B1. N = 2**(max_depth+1) - 1 heap slots per tree.
extern "C" int gp_eval_fitness(const int* op, const int* arg, int P, int N, int max_depth,
                               const float* X, int F, int D, const float* y,
                               const float* w, const float* consts, int C,
                               unsigned fn_mask, int kernel, float n_classes_m1,
                               float precision, int chunk, float* partial, float* out,
                               void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || F <= 0 || C <= 0 || max_depth < 0 ||
      max_depth > 10 || N != (2 << max_depth) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (D + chunk - 1) / chunk;
  const dim3 grid(T, P);
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = (T == 1) ? out : partial;
  if (max_depth + 1 <= 8) {
    eval_partial_kernel<8><<<grid, kThreads, smem, st>>>(
        op, arg, N, max_depth, X, F, D, y, w, consts, C, fn_mask, kernel, n_classes_m1,
        precision, chunk, dst);
  } else {
    eval_partial_kernel<12><<<grid, kThreads, smem, st>>>(
        op, arg, N, max_depth, X, F, D, y, w, consts, C, fn_mask, kernel, n_classes_m1,
        precision, chunk, dst);
  }
  return merge_after(partial, P, T, nullptr, 0, out, st);
}

template <int S, int V>
void launch_postfix(dim3 grid, size_t smem, cudaStream_t st, const int* op, const int* arg,
                    int N, const float* X, int F, int D, const float* y, const float* w,
                    const float* consts, int C, unsigned fn_mask, int kernel,
                    float n_classes_m1, float precision, int chunk,
                    const unsigned char* gate, int run_when, float* partial, int* tickets,
                    float* out) {
  postfix_partial_kernel<S, V><<<grid, kThreads, smem, st>>>(
      op, arg, N, X, F, D, y, w, consts, C, fn_mask, kernel, n_classes_m1, precision,
      chunk, gate, run_when, partial, tickets, out);
}

// B2, one launch. Any N; stack_size (the programs' operand-stack bound,
// invariant P5) picks the register stack, 8 or 12 floats. A thread
// carries V points through the program at once: its points per tile
// (chunk / kThreads), at most 4. `tickets` holds P int32 zeros (the
// kernel leaves them zero).
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
  const int V = chunk >= 4 * kThreads ? 4 : chunk >= 2 * kThreads ? 2 : 1;
  const int T = (D + chunk - 1) / chunk;
  const dim3 grid(T, P);
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = stack_size <= 8
                    ? (V == 4 ? launch_postfix<8, 4> : V == 2 ? launch_postfix<8, 2>
                                                               : launch_postfix<8, 1>)
                    : (V == 4 ? launch_postfix<12, 4> : V == 2 ? launch_postfix<12, 2>
                                                                : launch_postfix<12, 1>);
  launch(grid, smem, st, op, arg, N, X, F, D, y, w, consts, C, fn_mask, kernel,
         n_classes_m1, precision, chunk, gate, run_when, partial, tickets, out);
  return static_cast<int>(cudaGetLastError());
}

// B3. uniq is f32[U, D], root int32[P].
extern "C" int gp_fitness_from_subtrees(const int* root, int P, const float* uniq, int U,
                                        int D, const float* y, const float* w, int kernel,
                                        float n_classes_m1, float precision, int chunk,
                                        const unsigned char* gate, int run_when,
                                        float* partial, float* out, void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || U <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (D + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  from_subtrees_kernel<<<dim3(T, P), kThreads, 0, st>>>(
      root, uniq, U, D, y, w, kernel, n_classes_m1, precision, chunk, gate, run_when,
      (T == 1) ? out : partial);
  return merge_after(partial, P, T, gate, run_when, out, st);
}

// B4. preds is f32[P, D].
extern "C" int gp_fitness_from_preds(const float* preds, int P, int D, const float* y,
                                     const float* w, int kernel, float n_classes_m1,
                                     float precision, int chunk, const unsigned char* gate,
                                     int run_when, float* partial, float* out,
                                     void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (D + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  from_preds_kernel<<<dim3(T, P), kThreads, 0, st>>>(
      preds, D, y, w, kernel, n_classes_m1, precision, chunk, gate, run_when,
      (T == 1) ? out : partial);
  return merge_after(partial, P, T, gate, run_when, out, st);
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

// Postfix predictions preds f32[P, D] (no epilogue). stack_size as B2.
extern "C" int gp_predict_postfix(const int* op, const int* arg, int P, int N,
                                  int stack_size, const float* X, int F, int D,
                                  const float* consts, int C, unsigned fn_mask,
                                  float* preds, void* stream) {
  if (P <= 0 || D <= 0) return 0;
  if (F <= 0 || C <= 0 || N <= 0 || P > 65535 || stack_size < 1 || stack_size > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kThreads - 1) / kThreads, P);
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stack_size <= 8) {
    postfix_predict_kernel<8><<<grid, kThreads, smem, st>>>(op, arg, N, X, F, D, consts,
                                                             C, fn_mask, preds);
  } else {
    postfix_predict_kernel<12><<<grid, kThreads, smem, st>>>(op, arg, N, X, F, D, consts,
                                                              C, fn_mask, preds);
  }
  return static_cast<int>(cudaGetLastError());
}
