// Kernel K3: the acting forward of a tanh-Gaussian policy in one launch:
// a ReLU trunk, the mean head, and the log-std head clamped to
// [log_std_min, log_std_max].
//
// Replaces: ilswiss_tpu/ops/fused_mlp.py, `_policy_kernel` (the Pallas TPU
// kernel launched by `fused_gaussian_policy_forward`).  The plain PyTorch
// version is `policy_forward_plain` in ilswiss_tpu_torch/ops/fused_mlp.py:
// one addmm per layer and a clamp.
//
// What bounds it on an H100: at the acting shapes (B = 128, 11 -> 256 ->
// 256 -> 3 + 3; humanoid 348 -> 256 -> 256 -> 17 + 17) the work is 18 to
// 43 MFLOP and 0.28 to 0.65 MB of weights, which the card's float32 peak
// and memory rate would move in well under a microsecond.  The launch
// latency and the serial depth of each thread's dot products bound it
// instead: B = 128 gives only four blocks.
//
// What the design does about it: the whole forward is one launch, and no
// activation goes back to device memory between layers.  A block takes a
// tile of 32 observation rows (16 when a layer is wider than 512) and
// keeps the tile's activations in dynamic shared memory, twice: a layer
// reads one buffer and writes the other.  A row is padded to an odd
// stride, so that a warp reading 32 different rows hits 32 different
// banks; at humanoid's widths (348 -> 256 -> 256) the two buffers take
// 89 KB, at 1024 -> 1024 131 KB, over the 48 KB of static shared memory,
// so the launch asks for them (cudaFuncSetAttribute).  In a trunk layer
// thread n computes output neurons n, n + 256, ... for all rows of the
// tile with float32 FMAs: each weight it reads from global memory (the
// weights stay resident in L2) is used once per row, and all threads read
// the same activation at once, which shared memory broadcasts.  In the
// heads each thread takes one (output, row) pair, so the 2 x A x rows dot
// products run in parallel.  wgmma and TMA are later work.

#include <cuda_runtime.h>

#define MLP_MAX_HIDDEN 4
#define MLP_MAX_WIDTH 1024
#define MLP_THREADS 256

struct MlpArgs {
  // trunk layers, then the mean head, then the log-std head; each weight
  // is nn.Linear's [out, in], row-major
  const float* w[MLP_MAX_HIDDEN + 2];
  const float* b[MLP_MAX_HIDDEN + 2];
  int dims[MLP_MAX_HIDDEN + 1];  // obs size, then each trunk width
  int num_hidden;
  int action_dim;
  int stride;  // shared row stride: the widest layer, made odd
  float log_std_min, log_std_max;
};

template <int ROWS>
__global__ void __launch_bounds__(MLP_THREADS)
policy_forward_kernel(const float* __restrict__ obs, float* __restrict__ mean,
                      float* __restrict__ log_std, int batch, MlpArgs a) {
  extern __shared__ float mlp_smem[];
  const int S = a.stride;
  float* cur = mlp_smem;              // [ROWS, S]: this layer's input
  float* nxt = mlp_smem + ROWS * S;   // [ROWS, S]: its output
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, batch - row0);
  const int t = threadIdx.x;

  int in = a.dims[0];
  for (int i = t; i < ROWS * in; i += MLP_THREADS) {
    const int r = i / in, k = i % in;
    cur[r * S + k] = (r < nrows) ? obs[(size_t)(row0 + r) * in + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < a.num_hidden; ++l) {
    const int out = a.dims[l + 1];
    for (int n = t; n < out; n += MLP_THREADS) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* w = a.w[l] + (size_t)n * in;
      for (int k = 0; k < in; ++k) {
        const float wk = __ldg(w + k);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(cur[r * S + k], wk, acc[r]);
      }
      const float bias = __ldg(a.b[l] + n);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) nxt[r * S + n] = fmaxf(acc[r] + bias, 0.f);
    }
    __syncthreads();  // the layer's output is complete
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    in = out;
  }

  // heads: pair p = (output o, row r); o < A is the mean, else log-std
  const int A = a.action_dim;
  for (int p = t; p < 2 * A * ROWS; p += MLP_THREADS) {
    const int o = p / ROWS, r = p % ROWS;
    if (r >= nrows) continue;
    const int head = o / A, j = o % A;
    const float* w = a.w[a.num_hidden + head] + (size_t)j * in;
    float acc = 0.f;
    for (int k = 0; k < in; ++k)
      acc = fmaf(cur[r * S + k], __ldg(w + k), acc);
    float v = acc + __ldg(a.b[a.num_hidden + head] + j);
    const size_t idx = (size_t)(row0 + r) * A + j;
    if (head == 0) {
      mean[idx] = v;
    } else {
      log_std[idx] = fminf(fmaxf(v, a.log_std_min), a.log_std_max);
    }
  }
}

template <int ROWS>
static int launch(const float* obs, float* mean, float* log_std, int batch,
                  const MlpArgs& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)ROWS * a.stride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      policy_forward_kernel<ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + ROWS - 1) / ROWS;
  policy_forward_kernel<ROWS><<<blocks, MLP_THREADS, smem, stream>>>(
      obs, mean, log_std, batch, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// weights/biases: num_hidden + 2 device pointers (trunk, mean, log-std);
// dims: num_hidden + 1 widths.  Launches on `stream`; returns the launch
// error, or cudaErrorInvalidValue for shapes the kernel does not take.
int fused_policy_forward(const float* obs, const void* const* weights,
                         const void* const* biases, const int* dims,
                         int num_hidden, int action_dim, float log_std_min,
                         float log_std_max, float* mean, float* log_std,
                         int batch, void* stream) {
  if (num_hidden < 1 || num_hidden > MLP_MAX_HIDDEN || action_dim < 1 ||
      batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  int widest = 1;
  for (int l = 0; l <= num_hidden; ++l) {
    if (dims[l] < 1 || dims[l] > MLP_MAX_WIDTH)
      return static_cast<int>(cudaErrorInvalidValue);
    a.dims[l] = dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  for (int l = 0; l < num_hidden + 2; ++l) {
    a.w[l] = static_cast<const float*>(weights[l]);
    a.b[l] = static_cast<const float*>(biases[l]);
  }
  a.num_hidden = num_hidden;
  a.action_dim = action_dim;
  a.stride = widest | 1;
  a.log_std_min = log_std_min;
  a.log_std_max = log_std_max;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return widest > 512 ? launch<16>(obs, mean, log_std, batch, a, s)
                      : launch<32>(obs, mean, log_std, batch, a, s);
}

}  // extern "C"
