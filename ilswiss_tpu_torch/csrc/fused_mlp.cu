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
// and memory rate would move in well under a microsecond.  What bounds it
// instead is the launch, the latency of one barrier per layer, the weight
// bytes each SM pulls from L2, and each output's serial dot product.  A
// grid of one block per tile of rows would leave most SMs idle at B = 128
// and make each block pull every weight of every layer.
//
// What the design does about it:
//
// * A thread block cluster (Hopper) takes a tile of TR rows: block `rank`
//   of the cluster's CS blocks computes output neurons [rank * out / CS,
//   (rank + 1) * out / CS) of each layer for the tile, and the heads are
//   split the same way over their 2 A outputs.  At B = 128 with TR = 8 and
//   CS = 8 that is 128 blocks on 128 SMs, each pulling an eighth of the
//   weights.
// * Each block holds the tile's whole input activation in its own shared
//   memory (two buffers).  It writes its slice of a layer's output into
//   the next buffer of every block of the cluster through distributed
//   shared memory (`map_shared_rank`) and waits on `cluster.sync()` before
//   the next layer: the one barrier a layer.  No activation goes to device memory.
// * Weights are staged, never walked through L2 by a thread: the block's
//   rows of a layer come into shared memory in chunks of KC input columns
//   with 16-byte `cp.async` copies (4-byte copies where a row is not
//   16-byte aligned, as at an input of 11), through a two-slot ring.  The
//   chunks of all layers form one sequence, so the next chunk (at 256
//   wide, the next layer's whole slice) is in flight while the current one
//   computes; any width up to 1024 streams through the same two slots.
//   KC is the widest of 256, 128 and 64 whose slots fit beside the
//   activations: a chunk's copy takes an L2 round trip, and with chunks of
//   64 columns the ring waited on it four times a layer.
// * Arithmetic: float32 FMAs, no tensor cores (TF32 keeps about three
//   digits and would fail the 2e-5 pin against the plain version; at 18
//   to 43 MFLOP over 64 SMs the FMA pipes are not the limit).  Thread t
//   keeps NP outputs of one row (neurons t / TR, t / TR + T / TR, ...; NP,
//   a template parameter of 1 to 8, is what the widest slice needs), so
//   each 16-byte load of the row's activation serves all of them, and the
//   weights come as 16-byte loads too (activation rows at a stride of
//   4 mod 32 floats, so the 8 rows a quarter warp reads meet no bank
//   conflict).  Each output sums its products over k in ascending order,
//   then adds the bias: a fixed order, no atomics, the same bits on every
//   launch.
//
// CS = MLP_CLUSTER = 8, and TR = 8 while the clusters fit the SMs in one
// wave (B = 128: 128 blocks), 16 beyond: the fastest of the measured pairs
// but at humanoid's B = 128, where 16 x 8 was a little faster (PERF.md).
// `kernels/redesign_sweep.py` builds the source with MLP_CLUSTER and
// MLP_ROWS set to time the other pairs (a cluster over 8 takes the
// non-portable size attribute); the port builds it without.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define MLP_MAX_HIDDEN 4
#define MLP_MAX_WIDTH 1024
#define MLP_THREADS 256
#define MLP_MAXP 8              // outputs a thread keeps, at most (NP)
#define MLP_MAX_SMEM (227 * 1024)
#ifndef MLP_CLUSTER
#define MLP_CLUSTER 8           // blocks in a cluster, CS
#endif
#ifndef MLP_ROWS
#define MLP_ROWS 0              // rows of a tile, TR; 0: the rule above
#endif

#ifndef ILSWISS_HOST_SHIM
// The asynchronous copies; the CPU rehearsal (kernels/host_build.py) takes
// plain copies from kernels/host_shim/.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` (0 or 1) groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else
    asm volatile("cp.async.wait_group 1;\n" ::);
}
#endif

struct MlpArgs {
  const float* obs;   // [batch, dims[0]]
  float* mean;        // [batch, action_dim]
  float* log_std;
  // trunk layers, then the mean head, then the log-std head; each weight
  // is nn.Linear's [out, in], row-major
  const float* w[MLP_MAX_HIDDEN + 2];
  const float* b[MLP_MAX_HIDDEN + 2];
  int dims[MLP_MAX_HIDDEN + 1];  // obs size, then each trunk width
  int num_hidden;
  int action_dim;
  int batch;
  int rows;       // TR, rows of a tile
  int stride;     // activation row stride: 4 mod 32, past the widest
  int max_slice;  // the most neurons a block takes in any layer
  int kc;         // input columns a staged chunk: 64, 128 or 256
  float log_std_min, log_std_max;
};

// layer l's sizes; l == num_hidden is the two heads as one layer of 2 A
// outputs (mean rows, then log-std rows)
__device__ __forceinline__ int layer_in(const MlpArgs& a, int l) {
  return a.dims[l < a.num_hidden ? l : a.num_hidden];
}
__device__ __forceinline__ int layer_out(const MlpArgs& a, int l) {
  return l < a.num_hidden ? a.dims[l + 1] : 2 * a.action_dim;
}
__device__ __forceinline__ const float* weight_row(const MlpArgs& a, int l,
                                                   int n) {
  const int in = layer_in(a, l);
  if (l < a.num_hidden) return a.w[l] + (size_t)n * in;
  const int A = a.action_dim;
  return n < A ? a.w[l] + (size_t)n * in : a.w[l + 1] + (size_t)(n - A) * in;
}

// stage chunk (l, k0) of this block's rows [n0, n0 + ns) into `slot`
__device__ __forceinline__ void issue_chunk(const MlpArgs& a, int l, int k0,
                                            int n0, int ns, float* slot) {
  const int in = layer_in(a, l);
  const int kc = min(a.kc, in - k0), ws = a.kc + 4;
  const int quads = (kc + 3) / 4;
  for (int i = threadIdx.x; i < ns * quads; i += blockDim.x) {
    const int n = i / quads, k = 4 * (i % quads);
    const float* src = weight_row(a, l, n0 + n) + k0 + k;
    float* dst = slot + n * ws + k;  // rows 16-byte aligned
    if (k + 4 <= kc && (reinterpret_cast<size_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int j = 0; j < 4 && k + j < kc; ++j) cp_async4(dst + j, src + j);
    }
  }
  cp_async_commit();
}

template <int NP>
__global__ void __launch_bounds__(MLP_THREADS) policy_forward_kernel(
    MlpArgs a) {
  extern __shared__ __align__(16) float mlp_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int TR = a.rows, S = a.stride, T = blockDim.x, t = threadIdx.x;
  float* const slot0 = mlp_smem;  // the ring's two weight slots
  const int KC = a.kc, WS = a.kc + 4;
  float* const slot1 = mlp_smem + a.max_slice * WS;
  float* cur = mlp_smem + 2 * a.max_slice * WS;  // [TR, S]
  float* nxt = cur + TR * S;
  const int row0 = (blockIdx.x / CS) * TR;
  const int nrows = min(TR, a.batch - row0);
  const int L = a.num_hidden + 1;  // trunk layers and the heads
  auto lo = [&](int l) { return rank * layer_out(a, l) / CS; };
  auto hi = [&](int l) { return (rank + 1) * layer_out(a, l) / CS; };

  // the first chunk's copies start before anything else
  issue_chunk(a, 0, 0, lo(0), hi(0) - lo(0), slot0);
  int in = a.dims[0];
  for (int i = t; i < TR * in; i += T) {
    const int r = i / in, k = i % in;
    cur[r * S + k] = r < nrows ? a.obs[(size_t)(row0 + r) * in + k] : 0.f;
  }
  // every block of the cluster is running before any writes into another
  // one's shared memory, and the tile's input is in place
  cluster.sync();

  // thread t: row r, neurons nt, nt + T / TR, ... of the block's slice
  const int r = t % TR, nt = t / TR, nstep = T / TR;
  int slot = 0;
  for (int l = 0; l < L; ++l) {
    const int n0 = lo(l), ns = hi(l) - n0, out = layer_out(a, l);
    float acc[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < in; k0 += KC) {
      // the next chunk of the sequence, into the other slot
      const bool more = k0 + KC < in || l + 1 < L;
      if (k0 + KC < in) {
        issue_chunk(a, l, k0 + KC, n0, ns, slot ? slot0 : slot1);
      } else if (l + 1 < L) {
        issue_chunk(a, l + 1, 0, lo(l + 1), hi(l + 1) - lo(l + 1),
                    slot ? slot0 : slot1);
      }
      cp_async_wait(more ? 1 : 0);
      __syncthreads();
      const float* ws = slot ? slot1 : slot0;
      const float* x = cur + r * S + k0;
      const int kc = min(KC, in - k0), kq = kc & ~3;
      int k = 0;
      for (; k < kq; k += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + k);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int n = nt + j * nstep;
          if (n < ns) {
            const float4 wv =
                *reinterpret_cast<const float4*>(ws + n * WS + k);
            acc[j] = fmaf(xv.x, wv.x, acc[j]);
            acc[j] = fmaf(xv.y, wv.y, acc[j]);
            acc[j] = fmaf(xv.z, wv.z, acc[j]);
            acc[j] = fmaf(xv.w, wv.w, acc[j]);
          }
        }
      }
      for (; k < kc; ++k) {
        const float xk = x[k];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int n = nt + j * nstep;
          if (n < ns) acc[j] = fmaf(xk, ws[n * WS + k], acc[j]);
        }
      }
      __syncthreads();  // the slot is read before it is refilled
      slot ^= 1;
    }

    if (l < a.num_hidden) {
      // bias and ReLU; the slice goes into every cluster block's next
      // buffer
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int n = nt + j * nstep;
        if (n >= ns) continue;
        const float v = fmaxf(acc[j] + a.b[l][n0 + n], 0.f);
        for (int q = 0; q < CS; ++q)
          cluster.map_shared_rank(nxt, q)[r * S + n0 + n] = v;
      }
      cluster.sync();  // the layer's output is complete in every block
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      in = out;
    } else if (r < nrows) {
      const int A = a.action_dim;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int n = nt + j * nstep;
        if (n >= ns) continue;
        const int o = n0 + n;
        const size_t at = (size_t)(row0 + r) * A + (o < A ? o : o - A);
        if (o < A) {
          a.mean[at] = acc[j] + a.b[l][o];
        } else {
          const float v = acc[j] + a.b[l + 1][o - A];
          a.log_std[at] = fminf(fmaxf(v, a.log_std_min), a.log_std_max);
        }
      }
    }
  }
}

static size_t smem_bytes(int rows, int stride, int max_slice, int kc) {
  return sizeof(float) *
         (2 * (size_t)max_slice * (kc + 4) + 2 * (size_t)rows * stride);
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
      action_dim > MLP_MAX_WIDTH || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int cluster = MLP_CLUSTER;
  int rows = MLP_ROWS;
  if (rows == 0) {
    int dev = 0, sms = 1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows = (batch + 7) / 8 * cluster <= sms ? 8 : 16;
  }
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
  a.obs = obs;
  a.mean = mean;
  a.log_std = log_std;
  a.num_hidden = num_hidden;
  a.action_dim = action_dim;
  a.batch = batch;
  a.stride = (widest + 31) / 32 * 32 + 4;
  a.log_std_min = log_std_min;
  a.log_std_max = log_std_max;
  int max_slice = (2 * action_dim + cluster - 1) / cluster;
  for (int l = 1; l <= num_hidden; ++l)
  {
    const int slice = (dims[l] + cluster - 1) / cluster;
    if (slice > max_slice) max_slice = slice;
  }
  a.max_slice = max_slice;
  // a thread keeps at most MLP_MAXP outputs of one row: fewer rows a tile
  // where a slice is wide
  while (rows > 1 &&
         (max_slice > MLP_MAXP * (MLP_THREADS / rows) ||
          smem_bytes(rows, a.stride, max_slice, 64) > MLP_MAX_SMEM))
    rows /= 2;
  if (max_slice > MLP_MAXP * (MLP_THREADS / rows))
    return static_cast<int>(cudaErrorInvalidValue);
  a.rows = rows;
  a.kc = 256;
  while (a.kc > 64 &&
         smem_bytes(rows, a.stride, max_slice, a.kc) > MLP_MAX_SMEM)
    a.kc /= 2;
  const size_t smem = smem_bytes(rows, a.stride, max_slice, a.kc);

  const int per_thread = (max_slice + MLP_THREADS / rows - 1) /
                         (MLP_THREADS / rows);
  void (*kernel)(MlpArgs) = per_thread <= 1   ? policy_forward_kernel<1>
                            : per_thread <= 2 ? policy_forward_kernel<2>
                            : per_thread <= 4 ? policy_forward_kernel<4>
                                              : policy_forward_kernel<8>;
  // the attributes are set once a kernel, to the most any launch takes,
  // so that a launch inside a CUDA graph's capture makes no such call
  static void (*ready[4])(MlpArgs);
  int slot = 0;
  while (slot < 4 && ready[slot] != nullptr && ready[slot] != kernel) ++slot;
  cudaError_t err = cudaSuccess;
  if (slot < 4 && ready[slot] == nullptr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MLP_MAX_SMEM);
    if (err == cudaSuccess && cluster > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[slot] = kernel;
  }
  cudaLaunchConfig_t cfg = {};
  const int tiles = (batch + rows - 1) / rows;
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(MLP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
