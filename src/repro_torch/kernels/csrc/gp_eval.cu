// Fused GP population evaluation + fitness moments for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/gp_eval.py::eval_fitness_pallas`
// (body `_eval_fitness_kernel`): terminal lookup, heap-tree evaluation
// with the run's function set, and the fused moment epilogue of the
// built-in fitness kernels r / c / m / mse (M = 1), merged across data
// tiles in a fixed order.
//
// Design (rethought for the card rather than copied from the TPU grid):
//   * Grid (data tiles, trees). A block loads its tree's op/arg row once
//     and thread 0 lays the active nodes out in shared memory in
//     postorder: the full heap's postorder filtered to non-EMPTY slots,
//     which is the tree's own postorder because pruning removes whole
//     subtrees.
//   * Each thread walks that instruction list for its data points with a
//     register stack of S floats (S >= max_depth + 1). Every node applies
//     the same f32 operation to the same operand values as the
//     reference's level sweep, so predictions are bitwise equal to it
//     for add/sub/mul/div/neg/abs/sqrt/square/min/max trees.
//   * All threads of a block run the same tree, so the opcode branches
//     never diverge inside a warp; X is feature-major, so the threads of
//     a warp read neighbouring addresses of one feature row.
//   * The epilogue folds each point into a per-thread partial; the block
//     reduces with a fixed shuffle tree and writes one partial per
//     (tree, tile). A second small kernel sums each tree's tile partials
//     in tile order. No atomics: results never change from run to run.
//
// What bounds it: the bytes it must read are small (op/arg rows, X, y,
// w: for kat7 at P=100 about 0.5 MB), while the work is one interpreted
// node per active node per point, each a few integer and f32
// instructions plus a branch. The interpreter overhead, not memory,
// sets the time; the design keeps the operands in registers and the
// instruction list in shared memory so that nothing but X, y and w is
// read from device memory inside the loop.
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
  __shared__ float s_acc[kWarps];
  __shared__ int s_bad[kWarps];

  const int tile = blockIdx.x;
  const int p = blockIdx.y;
  const int* op_p = op + static_cast<size_t>(p) * N;
  const int* arg_p = arg + static_cast<size_t>(p) * N;

  if (threadIdx.x == 0) {
    int len = 0;
    int i = (1 << max_depth) - 1;  // leftmost slot of the deepest level
    for (;;) {
      const int o = op_p[i];
      if (o != kEmpty) {
        const int a = arg_p[i];
        s_code[len] = o;
        if (o == kFeature) {
          s_idx[len] = min(max(a, 0), F - 1);
        } else if (o == kConst) {
          s_val[len] = consts[min(max(a, 0), C - 1)];
        } else {
          s_idx[len] = (o < 32) ? static_cast<int>((fn_mask >> o) & 1u) : 0;
        }
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
  const int d_end = min(D, (tile + 1) * chunk);
  float acc = 0.0f;
  int bad = 0;
  for (int d = tile * chunk + threadIdx.x; d < d_end; d += kThreads) {
    float st[S];
#pragma unroll
    for (int k = 0; k < S; ++k) st[k] = 0.0f;
    for (int t = 0; t < len; ++t) {
      const int o = s_code[t];
      if (o == kFeature || o == kConst) {
        const float v = (o == kFeature)
                            ? __ldg(X + static_cast<size_t>(s_idx[t]) * D + d)
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
    epilogue(kernel, len ? st[0] : 0.0f, __ldg(y + d), w ? __ldg(w + d) : 1.0f,
             n_classes_m1, precision, acc, bad);
  }

  // fixed-order block reduction: shuffle tree per warp, then warps in order
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

// out[p] = sum over tiles of partial[p, :], in tile order (the reference's
// j == 0 store, j != 0 merge).
__global__ void merge_tiles_kernel(const float* __restrict__ partial, int P, int T,
                                   float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float* row = partial + static_cast<size_t>(p) * T;
  float tot = row[0];
  for (int t = 1; t < T; ++t) tot += row[t];
  out[p] = tot;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, never
// synchronises, allocates nothing: `partial` holds P * ceil(D / chunk)
// floats (unused when there is one tile), `out` holds P floats. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int gp_eval_fitness(const int* op, const int* arg, int P, int N, int max_depth,
                               const float* X, int F, int D, const float* y,
                               const float* w, const float* consts, int C,
                               unsigned fn_mask, int kernel, float n_classes_m1,
                               float precision, int chunk, float* partial, float* out,
                               void* stream) {
  if (P <= 0) return 0;
  if (chunk <= 0 || D <= 0 || F <= 0 || C <= 0 || max_depth < 0 || max_depth > 10 ||
      N != (2 << max_depth) - 1 || P > 65535)
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 1) {
    merge_tiles_kernel<<<(P + 127) / 128, 128, 0, st>>>(partial, P, T, out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
