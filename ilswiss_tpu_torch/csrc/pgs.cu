// Kernel K4: the batched projected Gauss-Seidel solve of the rigid-body
// engine's contact and joint-limit rows, in u-form, one launch per solve.
//
// Replaces: ilswiss_tpu/ops/pgs_pallas.py, `_kernel` (the Pallas TPU kernel
// reached through `pgs_solve` under vmap).  The plain PyTorch version is
// `pgs_solve_plain` in ilswiss_tpu_torch/ops/pgs.py: the same sweeps, one
// handful of tensor operations per row.
//
// What it computes, per env, for nr rows and nv velocity coordinates:
//
//     f <- active ? f0 : 0            u <- W f            (W = M^-1 J^T)
//     `iters` sweeps; in each, for r = 0 .. nr-1 in order:
//         res = J_r . u + Rreg_r f_r + b_r
//         f_r' = active_r ? max(0, f_r - res / D_r) : 0
//         u  += (f_r' - f_r) W[:, r];   f_r <- f_r'
//
// and returns f.  The masking of f0, the warm start u = W f0 and every
// sweep happen inside the one launch.
//
// What bounds it on an H100: operations over bytes is about iters * 2
// (ant: 116 rows x 14 coordinates, 15 sweeps, 128 envs: 3.4 MFLOP over
// 1.7 MB), far below the card's balance, so the roofline bound is the
// bytes, about half a microsecond.  The real limit is neither: each row
// update needs the u that the row before it left, so one env is a chain
// of iters * nr dependent steps (1,740 for ant, 2,250 for humanoid), each
// a dot product of nv terms, a division and an update.  The time is that
// chain's latency, however few envs there are.
//
// What the design does about it: one warp per env and one warp per block,
// so that 128 envs spread over 128 SMs and no chain waits for another.
// Lane v keeps u[v] in a register for the whole solve.  A row's dot
// product is one multiply and a five-step xor-shuffle reduction in a fixed
// order, after which every lane holds the same sum and does the projection
// itself, so nothing is broadcast.  The row's J and W entries do not depend
// on the chain, so they are loaded one row ahead, and the four per-row
// scalars and f wait in shared memory.  J [B, nr, nv] and W [B, nv, nr] are
// read where the engine left them, through the strides the wrapper passes:
// no transposed or padded copy is made.  There are no atomics, so two
// launches on the same inputs give the same bits.  Staging J and W in shared
// memory and packing several envs into a block when B exceeds the SMs are
// later work.
//
// Limits: nv <= 32 (one lane per coordinate), nr <= 256 (shared memory).

#include <cuda_runtime.h>

#define PGS_MAX_NV 32
#define PGS_MAX_ROWS 256
#define PGS_THREADS 32

struct PgsArgs {
  const float* J;               // [B, nr, nv] by strides
  const float* W;               // [B, nv, nr] by strides
  const float* Rreg;            // [B, nr] contiguous, as b, D, f0 and f
  const float* b;
  const float* D;
  const unsigned char* active;  // [B, nr] contiguous, 0 or 1
  const float* f0;
  float* f;
  int nr, nv, iters;
  long long J_sb, J_sr, J_sv;   // strides in elements
  long long W_sb, W_sv, W_sr;
};

__global__ void __launch_bounds__(PGS_THREADS) pgs_kernel(PgsArgs a) {
  // f is kept twice: a sweep reads one copy and lane 0 writes the other,
  // so no lane can read a row after lane 0 has already replaced it
  __shared__ float f_s[2 * PGS_MAX_ROWS];
  __shared__ float reg_s[PGS_MAX_ROWS];
  __shared__ float b_s[PGS_MAX_ROWS];
  __shared__ float d_s[PGS_MAX_ROWS];
  __shared__ float mask_s[PGS_MAX_ROWS];

  const int lane = threadIdx.x;
  const int nr = a.nr;
  const bool mine = lane < a.nv;
  const size_t row0 = (size_t)blockIdx.x * nr;
  const float* Jl = a.J + (long long)blockIdx.x * a.J_sb + lane * a.J_sv;
  const float* Wl = a.W + (long long)blockIdx.x * a.W_sb + lane * a.W_sv;

  for (int r = lane; r < nr; r += PGS_THREADS) {
    const float m = a.active[row0 + r] ? 1.f : 0.f;
    mask_s[r] = m;
    f_s[r] = m != 0.f ? a.f0[row0 + r] : 0.f;
    reg_s[r] = a.Rreg[row0 + r];
    b_s[r] = a.b[row0 + r];
    d_s[r] = a.D[row0 + r];
  }
  __syncwarp();

  // warm start: u[v] = sum_r W[v, r] f_r, rows in order
  float u = 0.f;
  if (mine)
    for (int r = 0; r < nr; ++r) u = fmaf(Wl[r * a.W_sr], f_s[r], u);

  float jr = mine ? Jl[0] : 0.f;
  float wr = mine ? Wl[0] : 0.f;
  float* f_old = f_s;
  float* f_new = f_s + PGS_MAX_ROWS;
  for (int it = 0; it < a.iters; ++it) {
    for (int r = 0; r < nr; ++r) {
      // the next row's entries, loaded while this row's chain runs
      const int rn = r + 1 < nr ? r + 1 : 0;
      const float jn = mine ? Jl[rn * a.J_sr] : 0.f;
      const float wn = mine ? Wl[rn * a.W_sr] : 0.f;

      float dot = jr * u;
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float fo = f_old[r];
      const float res = dot + reg_s[r] * fo + b_s[r];
      const float fn =
          mask_s[r] != 0.f ? fmaxf(0.f, fo - res / d_s[r]) : 0.f;
      u = fmaf(fn - fo, wr, u);
      if (lane == 0) f_new[r] = fn;
      jr = jn;
      wr = wn;
    }
    __syncwarp();  // lane 0's writes are read by every lane in the next sweep
    float* t = f_old;
    f_old = f_new;
    f_new = t;
  }

  for (int r = lane; r < nr; r += PGS_THREADS) a.f[row0 + r] = f_old[r];
}

extern "C" {

const char* pgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptrs: J, W, Rreg, b, D, active (one byte per row), f0, f.  dims: B, nr,
// nv, iters.  strides, in elements: J's batch, row and coordinate strides,
// then W's batch, coordinate and row strides.  Launches once on `stream`;
// returns the CUDA error, cudaErrorInvalidValue for sizes the kernel does
// not take.
int pgs_solve(const void* const* ptrs, const int* dims,
              const long long* strides, void* stream) {
  const int B = dims[0];
  PgsArgs a;
  a.nr = dims[1]; a.nv = dims[2]; a.iters = dims[3];
  if (B < 1 || a.nr < 1 || a.nr > PGS_MAX_ROWS || a.nv < 1 ||
      a.nv > PGS_MAX_NV || a.iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.J = static_cast<const float*>(ptrs[0]);
  a.W = static_cast<const float*>(ptrs[1]);
  a.Rreg = static_cast<const float*>(ptrs[2]);
  a.b = static_cast<const float*>(ptrs[3]);
  a.D = static_cast<const float*>(ptrs[4]);
  a.active = static_cast<const unsigned char*>(ptrs[5]);
  a.f0 = static_cast<const float*>(ptrs[6]);
  a.f = static_cast<float*>(const_cast<void*>(ptrs[7]));
  a.J_sb = strides[0]; a.J_sr = strides[1]; a.J_sv = strides[2];
  a.W_sb = strides[3]; a.W_sv = strides[4]; a.W_sr = strides[5];
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<void*>(pgs_kernel), dim3(B), dim3(PGS_THREADS), args,
      0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
