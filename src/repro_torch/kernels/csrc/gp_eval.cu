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
//     active instructions out in shared memory once (thread 0): B1 walks
//     the heap in postorder, which is the tree's own postorder because
//     pruning removes whole subtrees; B2 copies the postfix stream,
//     skipping EMPTY slots (the reference's EMPTY-hold), so no heap walk.
//   * Each thread walks that instruction list for its data points with a
//     register stack of S floats (S >= the program's stack depth). Every
//     node applies the same f32 operation to the same operand values as
//     the reference, so predictions are bitwise equal to it for
//     add/sub/mul/div/neg/abs/sqrt/square/min/max trees, and heap and
//     postfix forms of one tree agree bitwise.
//   * All threads of a block run the same tree, so the opcode branches
//     never diverge inside a warp; X is feature-major, so the threads of
//     a warp read neighbouring addresses of one feature row.
//   * The epilogue folds each point into a per-thread partial; the block
//     reduces with a fixed shuffle tree and writes one partial per
//     (tree, tile). A second small kernel sums each tree's tile partials
//     in tile order. No atomics: results never change from run to run.
//     B1-B4 share the epilogue, the reduction and the tile merge, so at
//     one tile geometry their moments are bitwise alike.
//   * B2-B4, their merges and the unique table take an optional device
//     flag `gate` and run only when (*gate != 0) == run_when, else every
//     block returns at once. The dedup path launches both branches of
//     the reference's lax.cond(overflow, ...) that way into one output,
//     and the host never reads the flag.
//
// What bounds them: B1/B2 read little (op/arg rows, X, y, w: for kat7 at
// P=100 about 0.5 MB) and execute one interpreted node per active node
// per point, a few integer and f32 instructions plus a branch each: the
// interpreter overhead, not memory, sets the time; the design keeps the
// operands in registers and the instruction list in shared memory so
// that nothing but X, y and w is read from device memory inside the
// loop. B3/B4 read one f32 row per tree and tile plus y and w: memory
// (and, at kat7, the launch) bounds them. The unique table is a chain of
// U dependent steps per point (read two operand values, write one), so
// the latency of that chain bounds it, not its bytes.
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

// Folds the block's points of tile blockIdx.x (prediction `pred_at(d)`)
// into tree p's partial: the epilogue per point, a fixed shuffle tree per
// warp, then the warps in order; thread 0 writes the partial.
template <class PredAt>
__device__ __forceinline__ void fold_tile(PredAt pred_at, int p, int D, int chunk,
                                          const float* __restrict__ y,
                                          const float* __restrict__ w, int kernel,
                                          float n_classes_m1, float precision,
                                          float* __restrict__ partial) {
  __shared__ float s_acc[kWarps];
  __shared__ int s_bad[kWarps];
  const int tile = blockIdx.x;
  const int d_end = min(D, (tile + 1) * chunk);
  float acc = 0.0f;
  int bad = 0;
  for (int d = tile * chunk + threadIdx.x; d < d_end; d += kThreads) {
    epilogue(kernel, pred_at(d), __ldg(y + d), w ? __ldg(w + d) : 1.0f, n_classes_m1,
             precision, acc, bad);
  }
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
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    int any_bad = 0;
    for (int k = 0; k < kWarps; ++k) {
      tot += s_acc[k];
      any_bad |= s_bad[k];
    }
    float part = tot;
    if (kernel == kC || kernel == kM) part = any_bad ? INFINITY : -tot;
    partial[static_cast<size_t>(p) * gridDim.x + tile] = part;
  }
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

// B2: postfix streams. The active program is the row's non-EMPTY slots in
// order (a contiguous prefix under invariant P1; EMPTY slots anywhere are
// skipped, as the reference's interpreter holds its stack through them).
template <int S>
__global__ void __launch_bounds__(kThreads) postfix_partial_kernel(
    const int* __restrict__ op, const int* __restrict__ arg, int N,
    const float* __restrict__ X, int F, int D, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ consts, int C,
    unsigned fn_mask, int kernel, float n_classes_m1, float precision, int chunk,
    const unsigned char* __restrict__ gate, int run_when, float* __restrict__ partial) {
  if (gated_off(gate, run_when)) return;
  extern __shared__ int smem[];
  int* s_code = smem;
  int* s_idx = smem + N;
  float* s_val = reinterpret_cast<float*>(smem + 2 * N);
  __shared__ int s_len;

  const int p = blockIdx.y;
  if (threadIdx.x == 0) s_len = load_postfix(op, arg, p, N, F, consts, C, fn_mask, smem);
  __syncthreads();
  const int len = s_len;
  fold_tile([&](int d) { return run_program<S>(s_code, s_idx, s_val, len, X, D, d); }, p,
            D, chunk, y, w, kernel, n_classes_m1, precision, partial);
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

// The unique-subtree table: one thread per data point walks the unique
// slots in ascending span length (`order`), so both operands of a slot
// are final when it reads them (they have shorter spans, and the same
// thread wrote them). The U - n_unique unused slots (length 0) sort
// first, in slot order, so the walk starts at the last of them, the
// reserved slot U - 1 (which all-EMPTY rows read; it holds 0), and
// leaves the others unwritten: nothing reads them. On overflow
// (n_unique > U - 1) it walks every slot.
__global__ void __launch_bounds__(kThreads) unique_table_kernel(
    const int* __restrict__ uop, const int* __restrict__ uarg,
    const int* __restrict__ ulhs, const int* __restrict__ urhs,
    const int* __restrict__ ulen, const long long* __restrict__ order,
    const int* __restrict__ n_unique, int U, const float* __restrict__ X, int F, int D,
    const float* __restrict__ consts, int C, unsigned fn_mask,
    const unsigned char* __restrict__ gate, int run_when, float* __restrict__ uniq) {
  if (gated_off(gate, run_when)) return;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  for (int k = max(U - __ldg(n_unique) - 1, 0); k < U; ++k) {
    const int s = static_cast<int>(__ldg(order + k));
    const int o = __ldg(uop + s);
    const int len = __ldg(ulen + s);
    float v = 0.0f;
    if (len == 1) {
      const int a = __ldg(uarg + s);
      v = (o == kFeature) ? __ldg(X + static_cast<size_t>(min(max(a, 0), F - 1)) * D + d)
                          : __ldg(consts + min(max(a, 0), C - 1));
    } else if (len >= 2 && o < 32 && ((fn_mask >> o) & 1u)) {
      const int l = min(max(__ldg(ulhs + s), 0), U - 1);
      const int r = min(max(__ldg(urhs + s), 0), U - 1);
      v = apply_fn(o, uniq[static_cast<size_t>(l) * D + d],
                   uniq[static_cast<size_t>(r) * D + d]);
    }
    uniq[static_cast<size_t>(s) * D + d] = v;
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

// B2. Any N; stack_size (the programs' operand-stack bound, invariant P5)
// picks the register stack: 8 or 12 floats.
extern "C" int gp_eval_postfix(const int* op, const int* arg, int P, int N, int stack_size,
                               const float* X, int F, int D, const float* y,
                               const float* w, const float* consts, int C,
                               unsigned fn_mask, int kernel, float n_classes_m1,
                               float precision, int chunk, const unsigned char* gate,
                               int run_when, float* partial, float* out, void* stream) {
  if (P <= 0) return 0;
  if (!valid_fitness_args(kernel, D, chunk, P) || F <= 0 || C <= 0 || N <= 0 ||
      stack_size < 1 || stack_size > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (D + chunk - 1) / chunk;
  const dim3 grid(T, P);
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = (T == 1) ? out : partial;
  if (stack_size <= 8) {
    postfix_partial_kernel<8><<<grid, kThreads, smem, st>>>(
        op, arg, N, X, F, D, y, w, consts, C, fn_mask, kernel, n_classes_m1, precision,
        chunk, gate, run_when, dst);
  } else {
    postfix_partial_kernel<12><<<grid, kThreads, smem, st>>>(
        op, arg, N, X, F, D, y, w, consts, C, fn_mask, kernel, n_classes_m1, precision,
        chunk, gate, run_when, dst);
  }
  return merge_after(partial, P, T, gate, run_when, out, st);
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
// ulhs, urhs, ulen: int32[U]; order: int64[U], the slots by ascending
// ulen; n_unique: the plan's int32 count, read on the device). Rows of
// the unused slots other than U - 1 are left unwritten.
extern "C" int gp_unique_table(const int* uop, const int* uarg, const int* ulhs,
                               const int* urhs, const int* ulen, const long long* order,
                               const int* n_unique, int U, const float* X, int F, int D,
                               const float* consts, int C, unsigned fn_mask,
                               const unsigned char* gate, int run_when, float* uniq,
                               void* stream) {
  if (U <= 0 || D <= 0) return 0;
  if (F <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unique_table_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      uop, uarg, ulhs, urhs, ulen, order, n_unique, U, X, F, D, consts, C, fn_mask, gate,
      run_when, uniq);
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
