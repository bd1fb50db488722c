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
// What bounds it on an H100: operations over bytes is about iters * 2, far
// below the card's balance, so the roofline bound is the bytes, about half
// a microsecond.  The real limit is neither: each row update needs the u
// that the row before it left, so one env is a chain of dependent row
// updates, each a dot product of nv terms, a division and an update.  The
// time is that chain's latency, however few envs there are.
//
// What the design does about it:
//
// * Only the active rows are walked.  An inactive row starts at f = 0, its
//   projection writes 0 again, and its update adds (0 - 0) W_r to u, which
//   changes nothing.  So each env first builds the ordered list of its
//   active rows in shared memory (a warp ballot and prefix count over the
//   mask, 32 rows at a time); the warm start and every sweep walk that
//   list, and inactive rows are written as exact zeros at the end.  For
//   finite J and W this is the same arithmetic on every active row, in the
//   same order, as walking every row: the skipped steps are `u + 0 * W_r`
//   and `u + W_r * 0`.  The one difference is where those steps are not
//   exact: the sign of a zero in u (-0 + 0 is +0), and a non-finite W entry
//   on an inactive row (inf * 0 is NaN), which the kernel never reads.  The
//   JAX kernel walks every row: on the TPU the batch lies on the lanes, so
//   one env cannot skip a row that another needs.
// * An env's active J and W rows, and its per-row scalars, are staged in
//   shared memory once, before the chain, by every thread of the block; the
//   chain then reads shared memory only, and each row's loads are issued a
//   row ahead.  Lane l of the env's L lanes holds CP coordinates of u,
//   u[l*CP .. l*CP + CP - 1], in registers (CP: the least power of two with
//   L * CP >= nv) and reads its coordinates of a row as one vector load.  A
//   row is stored as P floats, nv rounded up to a multiple of CP and
//   zero-padded, so that the L lanes of an env read one contiguous run and
//   meet no bank conflict.  A lane whose coordinates all lie past nv (at
//   L = 32 and nv 14, lanes 14 to 31) reads lane 0's words, which the
//   card broadcasts, and skips the warm start and every update of u, so
//   its u stays 0 and its products add zeros to the dot product.  An
//   env's rows are followed by one unused row, which keeps the envs of a
//   warp, which read the same row index k at once, off each other's
//   banks.
// * A row's dot product is a fixed-order pairwise sum of the lane's CP
//   products, then log2 L xor-shuffles.  After the butterfly every lane
//   holds the same bits, and every lane does the projection itself, which
//   spares the chain the shuffle that would hand f_r' from one lane to the
//   others.  The division stays the IEEE `res / D`, as in the plain
//   version.
// * E envs share a block when B exceeds the SMs (ceil(B / SMs), as far as
//   shared memory and the block's threads allow), so lanes do not idle at
//   B = 1024 and 4096.  A block of 32-lane envs may have 512 threads (16
//   envs; a lane keeps one coordinate); with fewer lanes it has at most
//   256, which leaves a lane's CP coordinates up to 255 registers and
//   measured faster at L = 4.  The envs of one warp step in lockstep over the
//   longest of their lists; an env past its own end computes nothing that
//   is kept.
// * L: 4 lanes an env while every env has an SM to itself (B <= SMs), 32
//   beyond (one warp an env, several warps an SM), the fastest of the
//   measured L in each regime (PERF.md).  `kernels/redesign_sweep.py`
//   builds the source with PGS_LANES set to time every L; the port builds
//   it without.
// * No atomics: two launches on the same inputs give the same bits.  J
//   [B, nr, nv] and W [B, nv, nr] are read through the strides the wrapper
//   passes, where the engine left them.
//
// Limits: nv <= 32, nr <= 256.

#include <cuda_runtime.h>

#define PGS_MAX_NV 32
#define PGS_MAX_ROWS 256
#define PGS_MAX_SMEM (227 * 1024)
#ifndef PGS_LANES
#define PGS_LANES 0  // 0: the measured choice of L (lanes_for below)
#endif

struct PgsArgs {
  const float* J;               // [B, nr, nv] by strides
  const float* W;               // [B, nv, nr] by strides
  const float* Rreg;            // [B, nr] contiguous, as b, D, f0 and f
  const float* b;
  const float* D;
  const unsigned char* active;  // [B, nr] contiguous, 0 or 1
  const float* f0;
  float* f;
  int B, nr, nv, iters;
  int envs;                     // envs per block, E
  int P;                        // a staged row's floats: nv padded to CP
  long long J_sb, J_sr, J_sv;   // strides in elements
  long long W_sb, W_sv, W_sr;
};

// CP consecutive floats from shared memory, as one or more vector loads
// (the staging layout keeps each lane's run aligned to min(CP, 4) floats)
template <int CP>
__device__ __forceinline__ void load_run(const float* p, float (&out)[CP]) {
  if constexpr (CP == 1) {
    out[0] = p[0];
  } else if constexpr (CP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < CP; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      out[c] = v.x;
      out[c + 1] = v.y;
      out[c + 2] = v.z;
      out[c + 3] = v.w;
    }
  }
}

// The shared-memory layout of a block of E envs with rows of P floats:
//   sc   float4 [E][nr]  (Rreg, b, D, 0) of the env's k-th active row
//   Js   float  [E][nr + 1][P], Ws the same: the env's k-th active row at
//        k; row nr is not used
//   fs   float  [2][E][nr] (a sweep reads one copy and writes the other)
//   idx  int    [E][nr]    the env's active rows, in order
//   pos  int    [E][nr]    each row's place in that list, or -1
//   cnt  int    [E]
__host__ __device__ inline size_t pgs_smem_bytes(int E, int nr, int P) {
  return sizeof(float) *
         ((size_t)E * (nr * (4 + 2 + 1 + 1) + 2 * (nr + 1) * P) + E);
}

// a block's threads at most, for L lanes an env
__host__ __device__ constexpr int pgs_max_threads(int L) {
  return L == 32 ? 512 : 256;
}

template <int L, int CP>
__global__ void __launch_bounds__(pgs_max_threads(L)) pgs_kernel(PgsArgs a) {
  extern __shared__ __align__(16) float pgs_smem[];
  const int E = a.envs, nr = a.nr, nv = a.nv, P = a.P;
  const int R = (nr + 1) * P;  // an env's J or W rows, one unused row included
  float* sc = pgs_smem;
  float* Js = sc + (size_t)4 * E * nr;
  float* Ws = Js + (size_t)E * R;
  float* fs = Ws + (size_t)E * R;
  int* idx = reinterpret_cast<int*>(fs + (size_t)2 * E * nr);
  int* pos = idx + (size_t)E * nr;
  int* cnt = pos + (size_t)E * nr;

  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t % 32, warp = t / 32, nwarps = T / 32;
  const int g0 = blockIdx.x * E;  // the block's first env

  // 1. each env's ordered list of active rows: a ballot and prefix count
  //    over the mask, whose bytes are all loaded first
  constexpr int CHUNKS = PGS_MAX_ROWS / 32;
  for (int e = warp; e < E; e += nwarps) {
    const int g = g0 + e;
    int n = 0;
    if (g < a.B) {
      const unsigned char* act = a.active + (size_t)g * nr;
      bool m[CHUNKS];
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int r = 32 * c + lane;
        m[c] = r < nr && act[r] != 0;
      }
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int r = 32 * c + lane;
        if (32 * c >= nr) break;
        const unsigned bal = __ballot_sync(0xffffffffu, m[c]);
        const int k = n + __popc(bal & ((1u << lane) - 1u));
        if (m[c]) idx[e * nr + k] = r;
        if (r < nr) pos[e * nr + r] = m[c] ? k : -1;
        n += __popc(bal);
      }
    }
    if (lane == 0) cnt[e] = n;
  }
  __syncthreads();

  // 2. stage the active rows: scalars, the warm start, and J and W rows
  //    zero-padded to P coordinates
  for (int e = 0; e < E && g0 + e < a.B; ++e) {
    const int g = g0 + e, n = cnt[e];
    const int* ide = idx + (size_t)e * nr;
    for (int k = t; k < n; k += T) {
      const size_t row = (size_t)g * nr + ide[k];
      reinterpret_cast<float4*>(sc)[e * nr + k] =
          make_float4(a.Rreg[row], a.b[row], a.D[row], 0.f);
      fs[e * nr + k] = a.f0[row];
    }
    for (int i = t; i < n * P; i += T) {
      const int k = i / P, v = i % P, r = ide[k];
      const size_t at = (size_t)e * R + i;
      Js[at] = v < nv ? a.J[g * a.J_sb + r * a.J_sr + v * a.J_sv] : 0.f;
      Ws[at] = v < nv ? a.W[g * a.W_sb + v * a.W_sv + r * a.W_sr] : 0.f;
    }
  }
  __syncthreads();

  // 3. the chain: env slot e = t / L, lane l of its L lanes.  Threads past
  //    the block's envs read env 0's rows (harmlessly) so that every lane
  //    of a warp takes part in each shuffle; they keep nothing.  A lane
  //    with no coordinate below nv reads lane 0's words and keeps u = 0.
  const int e = t / L, l = t % L, g = g0 + e;
  const bool mine = e < E && g < a.B;
  const int es = mine ? e : 0;
  const int n = mine ? cnt[e] : 0;
  const int nmax = __reduce_max_sync(0xffffffffu, n);
  if (nmax == 0 && !mine) return;  // a warp of helpers only
  const bool has = l * CP < nv;
  const size_t at = (size_t)es * R + (has ? l * CP : 0);
  const float* Je = Js + at;
  const float* We = Ws + at;
  const float4* sce = reinterpret_cast<const float4*>(sc) + (size_t)es * nr;
  float* f_old = fs + (size_t)es * nr;
  float* f_new = fs + (size_t)(E + es) * nr;

  // warm start: u = sum over the active rows, in order, of W_r f_r
  float u[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) u[c] = 0.f;
  for (int k = 0; k < (has ? n : 0); ++k) {
    float w[CP];
    load_run<CP>(We + (size_t)k * P, w);
    const float fk = f_old[k];
#pragma unroll
    for (int c = 0; c < CP; ++c) u[c] = fmaf(w[c], fk, u[c]);
  }

  if (nmax > 0) {
    float jr[CP], wr[CP];
    load_run<CP>(Je, jr);
    load_run<CP>(We, wr);
    float4 sr = sce[0];
    for (int it = 0; it < a.iters; ++it) {
      for (int k = 0; k < nmax; ++k) {
        const bool live = k < n;
        // the next row's entries (row 0 after the last), loaded while
        // this row's chain runs; J, W and the scalars never change
        const int kn = k + 1 < n ? k + 1 : 0;
        float jn[CP], wn[CP];
        load_run<CP>(Je + (size_t)kn * P, jn);
        load_run<CP>(We + (size_t)kn * P, wn);
        const float4 sn = sce[kn];
        const float fo = f_old[live ? k : 0];

        float p[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) p[c] = jr[c] * u[c];
#pragma unroll
        for (int h = CP / 2; h > 0; h /= 2)
#pragma unroll
          for (int c = 0; c < h; ++c) p[c] += p[c + h];
        float dot = p[0];
#pragma unroll
        for (int o = L / 2; o > 0; o /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float res = dot + sr.x * fo + sr.y;
        const float fn = fmaxf(0.f, fo - res / sr.z);
        if (live && has) {
#pragma unroll
          for (int c = 0; c < CP; ++c) u[c] = fmaf(fn - fo, wr[c], u[c]);
          if (l == 0) f_new[k] = fn;
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          jr[c] = jn[c];
          wr[c] = wn[c];
        }
        sr = sn;
      }
      __syncwarp();  // lane 0's writes are read by every lane next sweep
      float* tmp = f_old;
      f_old = f_new;
      f_new = tmp;
    }
  }

  // 4. out: the active rows' forces, exact zeros elsewhere
  if (!mine) return;
  float* fo = a.f + (size_t)g * nr;
  const int* pe = pos + (size_t)e * nr;
  for (int r = l; r < nr; r += L) {
    const int k = pe[r];
    fo[r] = k >= 0 ? f_old[k] : 0.f;
  }
}

// lanes per env: 4 while every env has an SM (B <= SMs), 32 beyond
static int lanes_for(int B, int sms) {
  if (PGS_LANES != 0) return PGS_LANES;
  return B <= sms ? 4 : 32;
}

// the kernel for (L, CP), for the CP that L lanes need (L * CP <= 32)
template <int L>
static void* pick_cp(int cp) {
  switch (cp) {
    case 1: return reinterpret_cast<void*>(pgs_kernel<L, 1>);
    case 2: if constexpr (L <= 16)
        return reinterpret_cast<void*>(pgs_kernel<L, 2>);
      break;
    case 4: if constexpr (L <= 8)
        return reinterpret_cast<void*>(pgs_kernel<L, 4>);
      break;
    case 8: if constexpr (L <= 4)
        return reinterpret_cast<void*>(pgs_kernel<L, 8>);
      break;
    case 16: if constexpr (L <= 2)
        return reinterpret_cast<void*>(pgs_kernel<L, 16>);
      break;
    case 32: if constexpr (L == 1)
        return reinterpret_cast<void*>(pgs_kernel<L, 32>);
      break;
  }
  return nullptr;
}

static void* pick(int L, int cp) {
  switch (L) {
    case 4: return pick_cp<4>(cp);
    case 32: return pick_cp<32>(cp);
#if PGS_LANES != 0 && PGS_LANES != 4 && PGS_LANES != 32
    case PGS_LANES: return pick_cp<PGS_LANES>(cp);
#endif
  }
  return nullptr;
}

extern "C" {

const char* pgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptrs: J, W, Rreg, b, D, active (one byte per row), f0, f.  dims: B, nr,
// nv, iters.  strides, in elements: J's batch, row and coordinate strides,
// then W's batch, coordinate and row strides.  Launches once on
// `stream`; returns the CUDA error, cudaErrorInvalidValue for sizes the
// kernel does not take.
int pgs_solve(const void* const* ptrs, const int* dims,
              const long long* strides, void* stream) {
  PgsArgs a;
  a.B = dims[0]; a.nr = dims[1]; a.nv = dims[2]; a.iters = dims[3];
  if (a.B < 1 || a.nr < 1 || a.nr > PGS_MAX_ROWS || a.nv < 1 ||
      a.nv > PGS_MAX_NV || a.iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = lanes_for(a.B, sms);
  int cp = 1;
  while (cp * L < a.nv) cp *= 2;
  void* kernel = pick(L, cp);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  // envs per block: enough that the blocks fit the SMs in one wave, as
  // far as shared memory and the block's threads allow
  const int P = (a.nv + cp - 1) / cp * cp;
  a.P = P;
  int E = (a.B + sms - 1) / sms;
  while (E > 1 && (pgs_smem_bytes(E, a.nr, P) > PGS_MAX_SMEM ||
                   E * L > pgs_max_threads(L)))
    --E;
  a.envs = E;
  int threads = (E * L + 31) / 32 * 32;
  if (threads < 128) threads = 128;  // more hands for the staging
  const size_t smem = pgs_smem_bytes(E, a.nr, P);

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
  // the attribute is set once a kernel, to the most any launch takes, so
  // that a launch inside a CUDA graph's capture makes no such call
  static void* ready[8];
  int slot = 0;
  while (slot < 8 && ready[slot] != nullptr && ready[slot] != kernel) ++slot;
  if (slot < 8 && ready[slot] == nullptr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PGS_MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[slot] = kernel;
  }
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3((a.B + E - 1) / E), dim3(threads),
                         args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
