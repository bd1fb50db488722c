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
// 256 -> 3 + 3) the work is about 18 MFLOP and 0.28 MB of weights, which
// the card's float32 peak and memory rate would move in well under a
// microsecond.  The launch latency and the serial depth of each thread's
// dot products bound it instead: B = 128 gives only four blocks.
//
// What the design does about it: the whole forward is one launch, and no
// activation goes back to device memory between layers.  A block takes a
// tile of 32 observation rows and keeps the tile's activations in shared
// memory (32 x 257 floats, the row padded by one so that a warp reading
// 32 different rows hits 32 different banks).  In a trunk layer thread n
// computes output neuron n for all 32 rows with float32 FMAs: each weight
// it reads from global memory (the weights stay resident in L2) is used
// 32 times, and all threads read the same activation at once, which
// shared memory broadcasts.  The outputs wait in registers until every
// thread has read the layer's input, then overwrite it in place.  In the
// heads each thread takes one (output, row) pair, so the 2 x 3 x 32 dot
// products run in parallel.  wgmma and TMA are later work.

#include <cuda_runtime.h>

#define MLP_MAX_HIDDEN 4
#define MLP_MAX_WIDTH 256
#define MLP_ROWS 32
#define MLP_THREADS 256
#define MLP_STRIDE (MLP_MAX_WIDTH + 1)

static_assert(MLP_THREADS >= MLP_MAX_WIDTH, "one thread per trunk neuron");

struct MlpArgs {
  // trunk layers, then the mean head, then the log-std head; each weight
  // is nn.Linear's [out, in], row-major
  const float* w[MLP_MAX_HIDDEN + 2];
  const float* b[MLP_MAX_HIDDEN + 2];
  int dims[MLP_MAX_HIDDEN + 1];  // obs size, then each trunk width
  int num_hidden;
  int action_dim;
  float log_std_min, log_std_max;
};

__global__ void __launch_bounds__(MLP_THREADS)
policy_forward_kernel(const float* __restrict__ obs, float* __restrict__ mean,
                      float* __restrict__ log_std, int batch, MlpArgs a) {
  __shared__ float act[MLP_ROWS * MLP_STRIDE];
  const int row0 = blockIdx.x * MLP_ROWS;
  const int nrows = min(MLP_ROWS, batch - row0);
  const int t = threadIdx.x;

  int in = a.dims[0];
  for (int i = t; i < MLP_ROWS * in; i += MLP_THREADS) {
    const int r = i / in, k = i % in;
    act[r * MLP_STRIDE + k] =
        (r < nrows) ? obs[(size_t)(row0 + r) * in + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < a.num_hidden; ++l) {
    const int out = a.dims[l + 1];
    float acc[MLP_ROWS];
#pragma unroll
    for (int r = 0; r < MLP_ROWS; ++r) acc[r] = 0.f;
    if (t < out) {
      const float* w = a.w[l] + (size_t)t * in;
      for (int k = 0; k < in; ++k) {
        const float wk = __ldg(w + k);
#pragma unroll
        for (int r = 0; r < MLP_ROWS; ++r)
          acc[r] = fmaf(act[r * MLP_STRIDE + k], wk, acc[r]);
      }
      const float bias = __ldg(a.b[l] + t);
#pragma unroll
      for (int r = 0; r < MLP_ROWS; ++r) acc[r] = fmaxf(acc[r] + bias, 0.f);
    }
    __syncthreads();  // every thread has read this layer's input
    if (t < out) {
#pragma unroll
      for (int r = 0; r < MLP_ROWS; ++r) act[r * MLP_STRIDE + t] = acc[r];
    }
    __syncthreads();
    in = out;
  }

  // heads: pair p = (output o, row r); o < A is the mean, else log-std
  const int A = a.action_dim;
  for (int p = t; p < 2 * A * MLP_ROWS; p += MLP_THREADS) {
    const int o = p / MLP_ROWS, r = p % MLP_ROWS;
    if (r >= nrows) continue;
    const int head = o / A, j = o % A;
    const float* w = a.w[a.num_hidden + head] + (size_t)j * in;
    float acc = 0.f;
    for (int k = 0; k < in; ++k)
      acc = fmaf(act[r * MLP_STRIDE + k], __ldg(w + k), acc);
    float v = acc + __ldg(a.b[a.num_hidden + head] + j);
    const size_t idx = (size_t)(row0 + r) * A + j;
    if (head == 0) {
      mean[idx] = v;
    } else {
      log_std[idx] = fminf(fmaxf(v, a.log_std_min), a.log_std_max);
    }
  }
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
  for (int l = 0; l <= num_hidden; ++l) {
    if (dims[l] < 1 || dims[l] > MLP_MAX_WIDTH)
      return static_cast<int>(cudaErrorInvalidValue);
    a.dims[l] = dims[l];
  }
  for (int l = 0; l < num_hidden + 2; ++l) {
    a.w[l] = static_cast<const float*>(weights[l]);
    a.b[l] = static_cast<const float*>(biases[l]);
  }
  a.num_hidden = num_hidden;
  a.action_dim = action_dim;
  a.log_std_min = log_std_min;
  a.log_std_max = log_std_max;
  const int blocks = (batch + MLP_ROWS - 1) / MLP_ROWS;
  policy_forward_kernel<<<blocks, MLP_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      obs, mean, log_std, batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
