// Kernel K2: K sequential SAC gradient steps in one launch: the critic
// target, the twin-critic forward and backward, the tanh-Gaussian policy
// forward and its hand-derived backward through the updated critics, Adam
// on the policy, the critics and log alpha, the Polyak step on the
// targets, and a [K, 8] table of metrics.
//
// Replaces: ilswiss_tpu/ops/fused_sac.py, `_make_kernel` (the Pallas TPU
// kernel launched by `fused_sac_chain`).  The plain PyTorch version is
// `fused_sac_chain_plain` in ilswiss_tpu_torch/ops/fused_sac.py; the
// formulas below follow it line for line.  Like the JAX kernel it has two
// modes: bf16 products (both operands of every product rounded to bf16,
// float32 sums; the default) and float32 products (the parity mode).
//
// What bounds it on an H100: one step is sixteen 512 x 256 x 256 products
// and a dozen thin ones, about 1.1 GFLOP, on 3.1 MB of state that stays in
// the 50 MB L2; the card's bf16 tensor-core peak would take about 1.1 us a
// step and its float32 peak about 17 us, so operations bound it, not
// bytes.  The steps depend on each other, and inside a step some seventeen
// groups of products do, so the chain is also a few thousand device-wide
// barriers deep.
//
// What the design does about it: the TPU kernel keeps all state in one
// core's fast memory; an SM's shared memory (227 KB) cannot hold 3.1 MB,
// so this is ONE persistent cooperative kernel, one block per SM, with the
// state, the activations and the gradients in global memory (L2-resident)
// and `grid.sync()` between dependent phases.  Nothing returns to the host
// between steps.  Inside a phase the independent products (the policy on
// obs and on next_obs and both critics; a layer's weight gradient and its
// input gradient) are cut into 64 x 32 output tiles, dealt round robin to
// the blocks, so a 512 x 256 product alone gives 64 tiles and a phase 128
// to 256.  A tile walks the depth in 64-deep chunks through a two-stage
// ring in dynamic shared memory: the next chunk's copies (16-byte
// `cp.async` where the operand's rows allow it, 4-byte ones elsewhere) are
// in flight while this chunk is multiplied, so a tile waits on one load per
// 64 of depth.  Operands are staged in the layout they have in memory
// (contiguous axis contiguous in shared memory too), so a product reads the
// parameters where PyTorch keeps them (nn.Linear [out, in], TwinQ
// [2, in, out]) and a concatenation (obs, action) is never materialised.
// In bf16 mode each warp multiplies a 16 x 16 piece of the tile with
// `mma.sync.m16n8k16` (bf16 in, float32 sums), rounding the operands to
// bf16 as it builds its fragments; in float32 mode each thread keeps a
// 2 x 4 micro-tile and uses FMAs on the same staging.  Bias gradients are
// float32 column sums of the unrounded upstream gradient, each column one
// block's fixed-order sum, as the JAX kernel sums them.  Thin products
// (heads, Q outputs, the action columns of the input gradient) take one
// warp per batch row with a shuffle reduction, followed by the row's
// elementwise math with one lane per action dimension, and the top row of
// the backward pass that starts there.  The first layer's weight gradient
// has few output tiles and the whole batch to sum, so its batch is cut
// into eight parts that different blocks sum; Adam adds the eight partial
// sums in a fixed order.  Every reduction over the batch has one owner and
// a fixed order: no float atomics, so two launches on the same inputs give
// the same bits.  wgmma and TMA are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define SAC_MAX_L 4
#define SAC_MAX_A 32
#define SAC_THREADS 256
#define SAC_WARPS (SAC_THREADS / 32)
#define SAC_TM 64     // tile rows
#define SAC_TN 32     // tile columns
#define SAC_KC 64     // depth of one staged chunk
#define SAC_PAD 4     // shared row padding: keeps 16-byte alignment
#define SAC_N_METRICS 8
#define SAC_KSPLIT 8  // parts of the batch in the first layer's gradient

// floats of one operand's stage: rows of the contiguous axis, padded
#define SAC_STAGE_A (SAC_TM * (SAC_KC + SAC_PAD) > SAC_KC * (SAC_TM + SAC_PAD) \
                         ? SAC_TM * (SAC_KC + SAC_PAD)                        \
                         : SAC_KC * (SAC_TM + SAC_PAD))
#define SAC_STAGE_B (SAC_TN * (SAC_KC + SAC_PAD) > SAC_KC * (SAC_TN + SAC_PAD) \
                         ? SAC_TN * (SAC_KC + SAC_PAD)                        \
                         : SAC_KC * (SAC_TN + SAC_PAD))
#define SAC_SMEM_BYTES (2 * (SAC_STAGE_A + SAC_STAGE_B) * 4)

#define TANH_EPS 1e-6f
#define LOG_SIG_MIN (-20.0f)
#define LOG_SIG_MAX 2.0f
#define ADAM_EPS 1e-8f
#define LOG_2PI 1.8378770664093453f

static_assert(SAC_THREADS == 8 * SAC_TN, "fp32 micro-tiles: 2 x 4 each");
static_assert(SAC_WARPS == (SAC_TM / 16) * (SAC_TN / 16), "16 x 16 a warp");
static_assert(SAC_WARPS == SAC_N_METRICS, "one warp reduces one statistic");
static_assert(SAC_MAX_A == 32, "one lane per action dimension");

#ifndef ILSWISS_HOST_SHIM
// The device-only pieces: bf16 rounding, the tensor-core product and the
// asynchronous copies.  The CPU rehearsal (kernels/host_build.py) takes
// stand-ins with the same rounding and fragment layout from
// kernels/host_shim/.

// bf16 x 2 with `lo` in the low half, as mma.sync's fragments hold them,
// each rounded to nearest, ties to even, as torch's and JAX's casts do
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bf16, as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16_pack(x, 0.f) << 16);
}

// c += a b for one 16 x 8 piece: a is 16 x 16 (row-major fragments), b
// 16 x 8 (column-major); lane (g = lane / 4, t = lane % 4) holds a rows g
// and g + 8 at columns 2t, 2t + 1, 2t + 8, 2t + 9; b column g at rows 2t,
// 2t + 1, 2t + 8, 2t + 9; c rows g and g + 8 at columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

struct PolicyLayer {  // nn.Linear: w [out, in], b [out]; Adam mu and nu
  float *w, *b, *mw, *mb, *vw, *vb;
};

struct CriticLayer {  // both critics: w [2, in, out], b [2, out]; target
  float *w, *b, *tw, *tb, *mw, *mb, *vw, *vb;
};

struct SacArgs {
  const float *obs, *act, *rew, *term, *nobs, *epsn, *epsw;  // [K, B, .]
  PolicyLayer P[SAC_MAX_L + 2];  // trunk, mean head, log-std head
  CriticLayer C[SAC_MAX_L + 1];  // trunk, output
  float *log_alpha, *alpha_m, *alpha_v;
  float *scratch, *metrics;
  int K, B, O, A, H, L, t0, train_alpha, bf16;
  float gamma, rscale, tau, one_m_tau, lr_q, lr_p, lr_a, lam_m, lam_s;
  float target_entropy, log_amin, log_amax, q_lo, q_hi;
  float b1, one_m_b1, b2, one_m_b2;
  double b1d, b2d;
};

// Scratch carved from one allocation; every buffer is float32.
struct Scratch {
  float *nact[2];  // policy trunk on next_obs, ping-pong      [B, H]
  float *tact[2];  // target critics' trunk, ping-pong       [2, B, H]
  float *cact;     // critics' trunk on (obs, action)     [2, L, B, H]
  float *kact;     // new critics' trunk on (obs, a_new)  [2, L, B, H]
  float *pact;     // policy trunk on obs                    [L, B, H]
  float *dbuf[2];  // critic backward, ping-pong             [2, B, H]
  float *dp[2];    // policy backward, ping-pong                [B, H]
  float *an, *mean, *lsr, *anew, *dmean, *dls;               // [B, A]
  float *lpn, *lp;                                           // [B]
  float *q, *dq;                                             // [2, B]
  float *stat;                                               // [8, B]
  // gradients, laid out layer by layer: w then b; layer 0's w SAC_KSPLIT
  // times (its bias only in the first part)
  float *gP, *gC;
  long long total;
};

__host__ __device__ inline int policy_params(int l, int L, int O, int A,
                                             int H) {
  const int in = l == 0 ? O : H, out = l < L ? H : A;
  return out * in + out;
}

__host__ __device__ inline int critic_params(int i, int L, int D, int H) {
  const int in = i == 0 ? D : H, out = i < L ? H : 1;
  return 2 * in * out + 2 * out;
}

__host__ __device__ inline Scratch carve(float* base, int B, int H, int L,
                                         int O, int A) {
  Scratch s;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base + off;
    off += (n + 3) / 4 * 4;
    return p;
  };
  const long long BH = (long long)B * H;
  for (int i = 0; i < 2; ++i) s.nact[i] = take(BH);
  for (int i = 0; i < 2; ++i) s.tact[i] = take(2 * BH);
  s.cact = take(2 * L * BH);
  s.kact = take(2 * L * BH);
  s.pact = take(L * BH);
  for (int i = 0; i < 2; ++i) s.dbuf[i] = take(2 * BH);
  for (int i = 0; i < 2; ++i) s.dp[i] = take(BH);
  s.an = take(B * A);
  s.mean = take(B * A);
  s.lsr = take(B * A);
  s.anew = take(B * A);
  s.dmean = take(B * A);
  s.dls = take(B * A);
  s.lpn = take(B);
  s.lp = take(B);
  s.q = take(2 * B);
  s.dq = take(2 * B);
  s.stat = take(SAC_N_METRICS * B);
  long long np = (SAC_KSPLIT - 1) * policy_params(0, L, O, A, H);
  long long nc = (SAC_KSPLIT - 1) * critic_params(0, L, O + A, H);
  for (int l = 0; l < L + 2; ++l) np += policy_params(l, L, O, A, H);
  for (int i = 0; i <= L; ++i) nc += critic_params(i, L, O + A, H);
  s.gP = take(np);
  s.gC = take(nc);
  s.total = off;
  return s;
}

// One operand of a product, element (i, k) with i the row (of A) or the
// column (of B) and k the depth.  `kc`: k is the axis that is contiguous in
// memory, else i is.  Along that contiguous axis the operand may continue
// at `split` in a second matrix: (obs, action) without a concatenation.
struct Opnd {
  const float* p;
  int ld;
  const float* p2;
  int ld2;
  int split;
  bool kc;
  __device__ const float* at(int i, int k) const {
    const int c = kc ? k : i, r = kc ? i : k;
    return c < split ? p + (size_t)r * ld + c
                     : p2 + (size_t)r * ld2 + (c - split);
  }
  // every aligned group of four along the contiguous axis is one 16-byte
  // load from one matrix
  __device__ bool vec() const {
    const bool one = split == 0x7fffffff;
    return ((ld | (one ? 0 : ld2 | split)) & 3) == 0 &&
           (reinterpret_cast<size_t>(p) & 15) == 0 &&
           (one || (reinterpret_cast<size_t>(p2) & 15) == 0);
  }
};

// a matrix [rows, ld] read row by row: element (i, k) at p[i * ld + k]
__device__ inline Opnd rows_k(const float* p, int ld) {
  return Opnd{p, ld, nullptr, 0, 0x7fffffff, true};
}

// a matrix [rows, ld] read down its columns: element (i, k) at p[k * ld + i]
__device__ inline Opnd cols_k(const float* p, int ld) {
  return Opnd{p, ld, nullptr, 0, 0x7fffffff, false};
}

// Copy the TI x SAC_KC chunk of `op` at (i0, k0) into shared memory `S`,
// its contiguous axis contiguous there too (row stride + SAC_PAD); out of
// range elements become 0.
template <int TI>
__device__ __forceinline__ void stage(float* S, const Opnd& op, bool vec,
                                      int i0, int k0, int I, int K) {
  static_assert(SAC_KC == 64 && (TI == 64 || TI == 32), "shifts below");
  const int tid = threadIdx.x;
  const int nc = op.kc ? SAC_KC : TI;   // contiguous extent
  const int stride = nc + SAC_PAD;
  const int units = TI * SAC_KC / 4;
  const int shift = nc == 64 ? 4 : 3;   // log2(nc / 4)
  for (int u = tid; u < units; u += SAC_THREADS) {
    const int r = u >> shift, c = (u & ((1 << shift) - 1)) * 4;
    const int i = op.kc ? i0 + r : i0 + c;
    const int k = op.kc ? k0 + c : k0 + r;
    float* dst = S + r * stride + c;
    // the group's four elements run along the contiguous axis
    const int cpos = op.kc ? k : i, cmax = op.kc ? K : I;
    const bool row_ok = op.kc ? i < I : k < K;
    if (vec && row_ok && cpos + 3 < cmax) {
      cp_async16(dst, op.at(i, k));
    } else {
      for (int j = 0; j < 4; ++j) {
        const int ii = op.kc ? i : i + j, kk = op.kc ? k + j : k;
        if (ii < I && kk < K)
          cp_async4(dst + j, op.at(ii, kk));
        else
          dst[j] = 0.f;
      }
    }
  }
}

// C(m, n) = sum_k A(m, k) * B(k, n) for m < M, n < N, handed to
// ep(m, n, sum).  In bf16 mode both operands are rounded to bf16 and the
// products summed in float32 on the tensor cores.  The 64 x 32 output
// tiles of successive calls in one phase are dealt round robin to the
// blocks: `task` is the running tile count of the phase.
template <class EP>
__device__ __forceinline__ void gemm(int M, int N, int K, const Opnd a,
                                     const Opnd b, EP ep, int& task,
                                     float* smem, bool bf16) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_n = (N + SAC_TN - 1) / SAC_TN;
  const int ntiles = ((M + SAC_TM - 1) / SAC_TM) * tiles_n;
  const int G = gridDim.x;
  const int first = ((int)blockIdx.x - task % G + G) % G;
  task = (task + ntiles) % G;
  const bool va = a.vec(), vb = b.vec();
  const int sa = a.kc ? SAC_KC + SAC_PAD : SAC_TM + SAC_PAD;
  const int sb = b.kc ? SAC_KC + SAC_PAD : SAC_TN + SAC_PAD;
  // element (i, k) of a staged chunk
  auto A_ = [&](const float* S, int i, int k) {
    return a.kc ? S[i * sa + k] : S[k * sa + i];
  };
  auto B_ = [&](const float* S, int i, int k) {
    return b.kc ? S[i * sb + k] : S[k * sb + i];
  };
  const int nchunks = (K + SAC_KC - 1) / SAC_KC;
  for (int t = first; t < ntiles; t += G) {
    const int m0 = (t / tiles_n) * SAC_TM, n0 = (t % tiles_n) * SAC_TN;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    if (nchunks > 0) {  // an empty part of the batch gives zeros
      stage<SAC_TM>(smem, a, va, m0, 0, M, K);
      stage<SAC_TN>(smem + SAC_STAGE_A, b, vb, n0, 0, N, K);
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        float* nxt = smem + ((c + 1) & 1) * (SAC_STAGE_A + SAC_STAGE_B);
        stage<SAC_TM>(nxt, a, va, m0, (c + 1) * SAC_KC, M, K);
        stage<SAC_TN>(nxt + SAC_STAGE_A, b, vb, n0, (c + 1) * SAC_KC, N, K);
        cp_async_commit();
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();
      const float* As = smem + (c & 1) * (SAC_STAGE_A + SAC_STAGE_B);
      const float* Bs = As + SAC_STAGE_A;
      if (bf16) {
        // warp w: rows 16 (w % 4), columns 16 (w / 4) as two 16 x 8 pieces
        const int g = lane >> 2, q = (lane & 3) * 2;
        const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 16;
#pragma unroll
        for (int ks = 0; ks < SAC_KC; ks += 16) {
          unsigned af[4];
          af[0] = bf16_pack(A_(As, r0 + g, ks + q), A_(As, r0 + g, ks + q + 1));
          af[1] = bf16_pack(A_(As, r0 + g + 8, ks + q),
                            A_(As, r0 + g + 8, ks + q + 1));
          af[2] = bf16_pack(A_(As, r0 + g, ks + q + 8),
                            A_(As, r0 + g, ks + q + 9));
          af[3] = bf16_pack(A_(As, r0 + g + 8, ks + q + 8),
                            A_(As, r0 + g + 8, ks + q + 9));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = c0 + 8 * h + g;
            unsigned bfr[2];
            bfr[0] = bf16_pack(B_(Bs, n, ks + q), B_(Bs, n, ks + q + 1));
            bfr[1] = bf16_pack(B_(Bs, n, ks + q + 8), B_(Bs, n, ks + q + 9));
            mma_bf16_16816(acc + 4 * h, af, bfr);
          }
        }
      } else {
        // thread: rows ty + 32 r (r < 2), columns tx + 8 j (j < 4)
        const int ty = tid >> 3, tx = tid & 7;
#pragma unroll 4
        for (int kk = 0; kk < SAC_KC; ++kk) {
          const float a0 = A_(As, ty, kk), a1 = A_(As, ty + 32, kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bv = B_(Bs, tx + 8 * j, kk);
            acc[j] = fmaf(a0, bv, acc[j]);
            acc[4 + j] = fmaf(a1, bv, acc[4 + j]);
          }
        }
      }
      __syncthreads();
    }
    if (bf16) {
      const int g = lane >> 2, q = (lane & 3) * 2;
      const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + r0 + g + (j >> 1) * 8;
          const int n = n0 + c0 + 8 * h + q + (j & 1);
          if (m < M && n < N) ep(m, n, acc[4 * h + j]);
        }
    } else {
      const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 32 * r, n = n0 + tx + 8 * j;
          if (m < M && n < N) ep(m, n, acc[4 * r + j]);
        }
    }
  }
}

// out[c] = sum over rows of d[r * cols + c]: the bias gradients, float32
// sums of the unrounded gradient.  A block takes 32 columns: thread
// (g, c) sums rows g, g + 8, g + 16, ... of column c, and the eight
// partial sums are added in order g = 0..7, so the order is fixed.  The
// tasks are dealt round robin with the phase's tiles (`task`); `red` is
// the block's 256 floats of shared memory.
__device__ inline void col_sums(const float* d, int rows, int cols,
                                float* out, int& task, float* red) {
  const int G = gridDim.x;
  const int ntasks = (cols + 31) / 32;
  const int first = ((int)blockIdx.x - task % G + G) % G;
  task = (task + ntasks) % G;
  const int cl = threadIdx.x & 31, g = threadIdx.x >> 5;
  for (int t = first; t < ntasks; t += G) {
    const int c = t * 32 + cl;
    float s = 0.f;
    if (c < cols)
      for (int r = g; r < rows; r += SAC_WARPS) s += d[(size_t)r * cols + c];
    red[threadIdx.x] = s;
    __syncthreads();
    if (g == 0 && c < cols) {
      float tot = red[cl];
      for (int j = 1; j < SAC_WARPS; ++j) tot += red[j * 32 + cl];
      out[c] = tot;
    }
    __syncthreads();
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x . w over n entries, both contiguous, each rounded to bf16 first in
// bf16 mode; every lane gets the sum
__device__ inline float warp_dot(const float* x, const float* w, int n,
                                 int lane, bool bf16) {
  float acc = 0.f;
  if (bf16) {
    for (int k = lane; k < n; k += 32)
      acc = fmaf(bf16_round(x[k]), bf16_round(w[k]), acc);
  } else {
    for (int k = lane; k < n; k += 32) acc = fmaf(x[k], w[k], acc);
  }
  return warp_sum(acc);
}

struct AdamConsts {
  float b1, one_m_b1, b2, one_m_b2, bc1, bc2, tau, one_m_tau;
};

// One Adam step on n entries, and the Polyak step on `tgt` where given.
// The gradient is the sum of `parts` partial sums `stride` apart.
__device__ inline void adam_range(float* p, const float* g, int parts,
                                  long long stride, float* m, float* v,
                                  float* tgt, int n, float lr,
                                  const AdamConsts a, int gtid,
                                  int nthreads) {
  const float bc1 = a.bc1, bc2 = a.bc2;
  for (int i = gtid; i < n; i += nthreads) {
    float gi = g[i];
    for (int s = 1; s < parts; ++s) gi += g[i + s * stride];
    const float mi = a.b1 * m[i] + a.one_m_b1 * gi;
    const float vi = a.b2 * v[i] + a.one_m_b2 * (gi * gi);
    m[i] = mi;
    v[i] = vi;
    const float pi = p[i] - lr * ((mi / bc1) / (sqrtf(vi / bc2) + ADAM_EPS));
    p[i] = pi;
    if (tgt) tgt[i] = tgt[i] * a.one_m_tau + pi * a.tau;
  }
}

// one block per SM: all 255 registers a thread may use
__global__ void __launch_bounds__(SAC_THREADS, 1)
    sac_chain_kernel(SacArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sac_smem[];
  __shared__ float s_bc[2];
  __shared__ float s_red[SAC_N_METRICS];
  __shared__ float s_dh[SAC_WARPS * 2 * SAC_MAX_A];

  const int B = a.B, O = a.O, A = a.A, H = a.H, L = a.L, D = O + A;
  const bool bf = a.bf16 != 0;
  const size_t BH = (size_t)B * H;
  const Scratch s = carve(a.scratch, B, H, L, O, A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * SAC_WARPS + warp;
  const int nwarps = gridDim.x * SAC_WARPS;
  const int gtid = blockIdx.x * SAC_THREADS + threadIdx.x;
  const int nthreads = gridDim.x * SAC_THREADS;
  const float invB = 1.0f / (float)B;
  const float invBA = 1.0f / (float)(B * A);
  auto rnd = [bf](float x) { return bf ? bf16_round(x) : x; };
  float* const smem = sac_smem;

  for (int step = 0; step < a.K; ++step) {
    const float* obs = a.obs + (size_t)step * B * O;
    const float* act = a.act + (size_t)step * B * A;
    const float* rew = a.rew + (size_t)step * B;
    const float* term = a.term + (size_t)step * B;
    const float* nobs = a.nobs + (size_t)step * B * O;
    const float* epsn = a.epsn + (size_t)step * B * A;
    const float* epsw = a.epsw + (size_t)step * B * A;

    // Adam's bias corrections 1 - b^t at the shared step t, in double as
    // the host computes them for the plain version
    if (threadIdx.x == 0) {
      const double t = (double)(a.t0 + step + 1);
      s_bc[0] = (float)(1.0 - pow(a.b1d, t));
      s_bc[1] = (float)(1.0 - pow(a.b2d, t));
    }
    __syncthreads();
    const float bc1 = s_bc[0], bc2 = s_bc[1];
    const AdamConsts adam = {a.b1, a.one_m_b1, a.b2, a.one_m_b2,
                             bc1,  bc2,        a.tau, a.one_m_tau};
    const float log_alpha = *a.log_alpha;
    const float alpha = expf(log_alpha);
    int task;

    // ---- trunks: policy on next_obs and on obs, critics on (obs, action)
    for (int i = 0; i < L; ++i) {
      task = 0;
      const int in_p = i ? H : O, in_c = i ? H : D;
      const Opnd W = rows_k(a.P[i].w, in_p);  // (n, k) = w[n, k]
      const float* bias = a.P[i].b;
      {
        const Opnd x = i ? rows_k(s.nact[(i - 1) & 1], H) : rows_k(nobs, O);
        float* out = s.nact[i & 1];
        gemm(B, H, in_p, x, W, [=](int m, int n, float v) {
          out[(size_t)m * H + n] = fmaxf(v + bias[n], 0.f);
        }, task, smem, bf);
      }
      {
        const Opnd x =
            i ? rows_k(s.pact + (i - 1) * BH, H) : rows_k(obs, O);
        float* out = s.pact + i * BH;
        gemm(B, H, in_p, x, W, [=](int m, int n, float v) {
          out[(size_t)m * H + n] = fmaxf(v + bias[n], 0.f);
        }, task, smem, bf);
      }
      for (int e = 0; e < 2; ++e) {
        const Opnd x = i ? rows_k(s.cact + (e * L + i - 1) * BH, H)
                         : Opnd{obs, O, act, A, O, true};
        const float* bc = a.C[i].b + e * H;
        float* out = s.cact + (e * L + i) * BH;
        gemm(B, H, in_c, x, cols_k(a.C[i].w + (size_t)e * in_c * H, H),
             [=](int m, int n, float v) {
               out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
             }, task, smem, bf);
      }
      grid.sync();
    }

    // ---- rows: heads and sample at next_obs; Q(obs, action); heads and
    // sample at obs.  Lane j keeps action dimension j.
    for (int r = gwarp; r < 3 * B; r += nwarps) {
      const int kind = r / B, row = r % B;
      if (kind == 1) {
        for (int e = 0; e < 2; ++e) {
          const float qv =
              warp_dot(s.cact + (e * L + L - 1) * BH + (size_t)row * H,
                       a.C[L].w + e * H, H, lane, bf) + a.C[L].b[e];
          if (lane == 0) s.q[e * B + row] = qv;
        }
        continue;
      }
      const float* h = (kind == 0 ? s.nact[(L - 1) & 1]
                                  : s.pact + (L - 1) * BH) + (size_t)row * H;
      float mean = 0.f, lsr = 0.f;
      for (int j = 0; j < A; ++j) {
        const float mj = warp_dot(h, a.P[L].w + (size_t)j * H, H, lane, bf) +
                         a.P[L].b[j];
        const float lj =
            warp_dot(h, a.P[L + 1].w + (size_t)j * H, H, lane, bf) +
            a.P[L + 1].b[j];
        if (lane == j) {
          mean = mj;
          lsr = lj;
        }
      }
      float lp = 0.f;
      if (lane < A) {
        const float* eps = (kind == 0 ? epsn : epsw) + (size_t)row * A;
        const float ls = fminf(fmaxf(lsr, LOG_SIG_MIN), LOG_SIG_MAX);
        const float ej = eps[lane];
        const float av = tanhf(mean + expf(ls) * ej);
        lp = -0.5f * (ej * ej + 2.0f * ls + LOG_2PI) -
             logf(1.0f - av * av + TANH_EPS);
        if (kind == 0) {
          s.an[row * A + lane] = av;
        } else {
          s.mean[row * A + lane] = mean;
          s.lsr[row * A + lane] = lsr;
          s.anew[row * A + lane] = av;
        }
      }
      lp = warp_sum(lp);
      if (lane == 0) (kind == 0 ? s.lpn : s.lp)[row] = lp;
    }
    grid.sync();

    // ---- target critics' trunk on (next_obs, a_next)
    for (int i = 0; i < L; ++i) {
      task = 0;
      const int in_c = i ? H : D;
      for (int e = 0; e < 2; ++e) {
        const Opnd x = i ? rows_k(s.tact[(i - 1) & 1] + e * BH, H)
                         : Opnd{nobs, O, s.an, A, O, true};
        const float* bc = a.C[i].tb + e * H;
        float* out = s.tact[i & 1] + e * BH;
        gemm(B, H, in_c, x, cols_k(a.C[i].tw + (size_t)e * in_c * H, H),
             [=](int m, int n, float v) {
               out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
             }, task, smem, bf);
      }
      grid.sync();
    }

    // ---- rows: target Q, y, dL/dq = (q - y) / B for both critics, and
    // the top of their backward: d_L = (dq x w_out) masked by the last
    // activation
    for (int row = gwarp; row < B; row += nwarps) {
      float tq[2];
      for (int e = 0; e < 2; ++e)
        tq[e] = warp_dot(s.tact[(L - 1) & 1] + e * BH + (size_t)row * H,
                         a.C[L].tw + e * H, H, lane, bf) + a.C[L].tb[e];
      const float min_tq = fminf(tq[0], tq[1]);
      float y = a.rscale * rew[row] +
                (1.0f - term[row]) * a.gamma * (min_tq - alpha * s.lpn[row]);
      y = fminf(fmaxf(y, a.q_lo), a.q_hi);
      for (int e = 0; e < 2; ++e) {
        const float qv = s.q[e * B + row];
        const float diff = qv - y;
        const float dq = diff * invB;
        if (lane == 0) {
          s.dq[e * B + row] = dq;
          s.stat[e * B + row] = diff * diff;
          s.stat[(2 + e) * B + row] = qv;
        }
        const float* top = s.cact + (e * L + L - 1) * BH + (size_t)row * H;
        const float* wout = a.C[L].w + e * H;
        float* dtop = s.dbuf[L & 1] + e * BH + (size_t)row * H;
        const float dqr = rnd(dq);
        for (int k = lane; k < H; k += 32)
          dtop[k] = top[k] > 0.f ? dqr * rnd(wout[k]) : 0.f;
      }
    }
    grid.sync();

    // ---- critics' backward.  Layer i's kernel gradient is
    // acts[i]^T d_{i+1}, its bias gradient the column sums of d_{i+1}.
    {
      const long long n0 = critic_params(0, L, D, H);
      long long goff[SAC_MAX_L + 1];
      long long acc = 0;
      for (int i = 0; i <= L; ++i) {
        goff[i] = acc;
        acc += (i == 0 ? SAC_KSPLIT : 1) * critic_params(i, L, D, H);
      }
      for (int i = L - 1; i >= 0; --i) {
        task = 0;
        const int in_c = i ? H : D;
        for (int e = 0; e < 2; ++e) {
          const float* dup = s.dbuf[(i + 1) & 1] + e * BH;  // d_{i+1}
          if (i + 1 == L) {
            const float* top = s.cact + (e * L + L - 1) * BH;
            float* g = s.gC + goff[L] + e * H;
            gemm(H, 1, B, cols_k(top, H), cols_k(s.dq + e * B, 1),
                 [=](int m, int n, float v) { g[m] = v; }, task, smem, bf);
            col_sums(s.dq + e * B, B, 1, s.gC + goff[L] + 2 * H + e, task,
                     smem);
          }
          // layer 0: the batch in SAC_KSPLIT parts, one partial sum each
          const int parts = i ? 1 : SAC_KSPLIT;
          const int Bp = (B + parts - 1) / parts;
          for (int part = 0; part < parts; ++part) {
            const int b0 = part * Bp, nb = max(0, min(Bp, B - b0));
            const Opnd x =
                i ? cols_k(s.cact + (e * L + i - 1) * BH + (size_t)b0 * H, H)
                  : Opnd{obs + (size_t)b0 * O, O, act + (size_t)b0 * A, A, O,
                         false};
            float* g = s.gC + goff[i] + part * n0 + (size_t)e * in_c * H;
            gemm(in_c, H, nb, x, cols_k(dup + (size_t)b0 * H, H),
                 [=](int m, int n, float v) { g[(size_t)m * H + n] = v; },
                 task, smem, bf);
          }
          col_sums(dup, B, H, s.gC + goff[i] + (size_t)2 * in_c * H + e * H,
                   task, smem);
          if (i > 0) {
            const float* mask = s.cact + (e * L + i - 1) * BH;
            float* out = s.dbuf[i & 1] + e * BH;
            gemm(B, H, H, rows_k(dup, H),
                 rows_k(a.C[i].w + (size_t)e * H * H, H),
                 [=](int m, int n, float v) {
                   out[(size_t)m * H + n] =
                       mask[(size_t)m * H + n] > 0.f ? v : 0.f;
                 }, task, smem, bf);
          }
        }
        grid.sync();
      }
      // Adam on the critics, then Polyak: old targets, new critics
      for (int i = 0; i <= L; ++i) {
        const int in_c = i == 0 ? D : H, out = i < L ? H : 1;
        const int nw = 2 * in_c * out, nb = 2 * out;
        const float* g = s.gC + goff[i];
        const int parts = i ? 1 : SAC_KSPLIT;
        adam_range(a.C[i].w, g, parts, n0, a.C[i].mw, a.C[i].vw, a.C[i].tw,
                   nw, a.lr_q, adam, gtid, nthreads);
        adam_range(a.C[i].b, g + nw, 1, 0, a.C[i].mb, a.C[i].vb, a.C[i].tb,
                   nb, a.lr_q, adam, gtid, nthreads);
      }
      grid.sync();
    }

    // ---- updated critics' trunk on (obs, a_new)
    for (int i = 0; i < L; ++i) {
      task = 0;
      const int in_c = i ? H : D;
      for (int e = 0; e < 2; ++e) {
        const Opnd x = i ? rows_k(s.kact + (e * L + i - 1) * BH, H)
                         : Opnd{obs, O, s.anew, A, O, true};
        const float* bc = a.C[i].b + e * H;
        float* out = s.kact + (e * L + i) * BH;
        gemm(B, H, in_c, x, cols_k(a.C[i].w + (size_t)e * in_c * H, H),
             [=](int m, int n, float v) {
               out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
             }, task, smem, bf);
      }
      grid.sync();
    }

    // ---- rows: Q(obs, a_new) of both critics; the smaller one takes the
    // policy gradient, critic 0 on a tie; the top of the way back through
    // the critics: d_L = (-sel_e / B x w_out) masked by the last activation
    for (int row = gwarp; row < B; row += nwarps) {
      float qn[2];
      for (int e = 0; e < 2; ++e)
        qn[e] = warp_dot(s.kact + (e * L + L - 1) * BH + (size_t)row * H,
                         a.C[L].w + e * H, H, lane, bf) + a.C[L].b[e];
      const float sel0 = qn[0] <= qn[1] ? 1.0f : 0.0f;
      if (lane == 0)
        s.stat[5 * B + row] = alpha * s.lp[row] - fminf(qn[0], qn[1]);
      for (int e = 0; e < 2; ++e) {
        const float dq = rnd(-invB * (e == 0 ? sel0 : 1.0f - sel0));
        const float* top = s.kact + (e * L + L - 1) * BH + (size_t)row * H;
        const float* wout = a.C[L].w + e * H;
        float* dtop = s.dbuf[L & 1] + e * BH + (size_t)row * H;
        for (int k = lane; k < H; k += 32)
          dtop[k] = top[k] > 0.f ? dq * rnd(wout[k]) : 0.f;
      }
    }
    grid.sync();

    // ---- back through the critics' trunk to layer 1's output
    for (int i = L - 1; i >= 1; --i) {
      task = 0;
      for (int e = 0; e < 2; ++e) {
        const float* mask = s.kact + (e * L + i - 1) * BH;
        float* out = s.dbuf[i & 1] + e * BH;
        gemm(B, H, H, rows_k(s.dbuf[(i + 1) & 1] + e * BH, H),
             rows_k(a.C[i].w + (size_t)e * H * H, H),
             [=](int m, int n, float v) {
               out[(size_t)m * H + n] = mask[(size_t)m * H + n] > 0.f ? v : 0.f;
             }, task, smem, bf);
      }
      grid.sync();
    }

    // ---- rows: the action columns of the input gradient, the
    // tanh-Gaussian backward to dL/dmean and dL/d(raw log-std) with lane j
    // on action dimension j, and the top of the policy trunk's backward:
    // (dmean W_mean + dls W_ls) masked by the last activation
    for (int row = gwarp; row < B; row += nwarps) {
      float daq = 0.f;
      for (int e = 0; e < 2; ++e) {
        const float* d1 = s.dbuf[1] + e * BH + (size_t)row * H;
        const float* W0 = a.C[0].w + (size_t)e * D * H;
        for (int j = 0; j < A; ++j) {
          const float part = warp_dot(d1, W0 + (size_t)(O + j) * H, H, lane,
                                      bf);
          if (lane == j) daq += part;
        }
      }
      float dmean = 0.f, dlsr = 0.f, mm = 0.f, ll = 0.f;
      if (lane < A) {
        const int j = lane;
        const float scale = alpha * invB;
        const float mean = s.mean[row * A + j], lsr = s.lsr[row * A + j];
        const float ls = fminf(fmaxf(lsr, LOG_SIG_MIN), LOG_SIG_MAX);
        const float ej = epsw[row * A + j], av = s.anew[row * A + j];
        const float sigma = expf(ls), inv_sig = expf(-ls);
        const float one_m_a2 = 1.0f - av * av;
        const float da_tot = daq + scale * 2.0f * av / (one_m_a2 + TANH_EPS);
        const float dz = da_tot * one_m_a2 - scale * ej * inv_sig;
        dmean = dz + scale * ej * inv_sig + (2.0f * a.lam_m * invBA) * mean;
        const float dls = dz * sigma * ej + scale * (ej * ej - 1.0f) +
                          (2.0f * a.lam_s * invBA) * ls;
        dlsr = (lsr > LOG_SIG_MIN && lsr < LOG_SIG_MAX) ? dls : 0.f;
        mm = mean * mean;
        ll = ls * ls;
        s.dmean[row * A + j] = dmean;
        s.dls[row * A + j] = dlsr;
      }
      float* dh = s_dh + warp * 2 * SAC_MAX_A;
      if (lane < A) {
        dh[lane] = rnd(dmean);
        dh[SAC_MAX_A + lane] = rnd(dlsr);
      }
      mm = warp_sum(mm);
      ll = warp_sum(ll);
      __syncwarp();
      if (lane == 0) {
        s.stat[4 * B + row] = s.lp[row];
        s.stat[6 * B + row] = mm;
        s.stat[7 * B + row] = ll;
      }
      const float* top = s.pact + (L - 1) * BH + (size_t)row * H;
      const float* Wm = a.P[L].w;
      const float* Ws = a.P[L + 1].w;
      float* dtop = s.dp[L & 1] + (size_t)row * H;
      for (int k = lane; k < H; k += 32) {
        float s1 = 0.f, s2 = 0.f;
        for (int j = 0; j < A; ++j) {
          s1 = fmaf(dh[j], rnd(Wm[(size_t)j * H + k]), s1);
          s2 = fmaf(dh[SAC_MAX_A + j], rnd(Ws[(size_t)j * H + k]), s2);
        }
        dtop[k] = top[k] > 0.f ? s1 + s2 : 0.f;
      }
      __syncwarp();  // dh is rewritten by this warp's next row
    }
    grid.sync();

    // ---- policy backward.  Gradients in nn.Linear's [out, in] layout;
    // bias gradients the column sums of the upstream gradient.
    {
      const long long n0 = policy_params(0, L, O, A, H);
      long long goff[SAC_MAX_L + 2];
      long long acc = 0;
      for (int l = 0; l < L + 2; ++l) {
        goff[l] = acc;
        acc += (l == 0 ? SAC_KSPLIT : 1) * policy_params(l, L, O, A, H);
      }
      for (int i = L - 1; i >= 0; --i) {
        task = 0;
        const int in_p = i ? H : O;
        const float* dup = s.dp[(i + 1) & 1];  // d_{i+1}
        if (i + 1 == L) {
          const float* top = s.pact + (L - 1) * BH;
          float* gm = s.gP + goff[L];
          float* gs = s.gP + goff[L + 1];
          gemm(2 * A, H, B, Opnd{s.dmean, A, s.dls, A, A, false},
               cols_k(top, H),
               [=](int m, int n, float v) {
                 if (m < A) gm[(size_t)m * H + n] = v;
                 else gs[(size_t)(m - A) * H + n] = v;
               }, task, smem, bf);
          col_sums(s.dmean, B, A, gm + A * H, task, smem);
          col_sums(s.dls, B, A, gs + A * H, task, smem);
        }
        // layer 0: the batch in SAC_KSPLIT parts, one partial sum each
        const int parts = i ? 1 : SAC_KSPLIT;
        const int Bp = (B + parts - 1) / parts;
        for (int part = 0; part < parts; ++part) {
          const int b0 = part * Bp, nb = max(0, min(Bp, B - b0));
          const Opnd x = i ? cols_k(s.pact + (i - 1) * BH + (size_t)b0 * H, H)
                           : cols_k(obs + (size_t)b0 * O, O);
          float* g = s.gP + goff[i] + part * n0;
          gemm(H, in_p, nb, cols_k(dup + (size_t)b0 * H, H), x,
               [=](int m, int n, float v) { g[(size_t)m * in_p + n] = v; },
               task, smem, bf);
        }
        col_sums(dup, B, H, s.gP + goff[i] + (size_t)H * in_p, task, smem);
        if (i > 0) {
          const float* mask = s.pact + (i - 1) * BH;
          float* out = s.dp[i & 1];
          gemm(B, H, H, rows_k(dup, H), cols_k(a.P[i].w, H),
               [=](int m, int n, float v) {
                 out[(size_t)m * H + n] =
                     mask[(size_t)m * H + n] > 0.f ? v : 0.f;
               }, task, smem, bf);
        }
        grid.sync();
      }

      // Adam on the policy
      for (int l = 0; l < L + 2; ++l) {
        const int in = l == 0 ? O : H, out = l < L ? H : A;
        const float* g = s.gP + goff[l];
        const int parts = l ? 1 : SAC_KSPLIT;
        adam_range(a.P[l].w, g, parts, n0, a.P[l].mw, a.P[l].vw, nullptr,
                   out * in, a.lr_p, adam, gtid, nthreads);
        adam_range(a.P[l].b, g + out * in, 1, 0, a.P[l].mb, a.P[l].vb,
                   nullptr, out, a.lr_p, adam, gtid, nthreads);
      }
    }

    // ---- the last block: batch sums of the eight statistics (one warp
    // each, a fixed order), the metrics row, and Adam on log alpha
    if (blockIdx.x == gridDim.x - 1) {
      float part = 0.f;
      for (int b = lane; b < B; b += 32) part += s.stat[warp * B + b];
      part = warp_sum(part);
      if (lane == 0) s_red[warp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        const float lp_mean = s_red[4] * invB;
        const float ga = -(lp_mean + a.target_entropy);
        float* row = a.metrics + (size_t)step * SAC_N_METRICS;
        row[0] = 0.5f * s_red[0] * invB;
        row[1] = 0.5f * s_red[1] * invB;
        row[2] = s_red[5] * invB + a.lam_m * (s_red[6] * invBA) +
                 a.lam_s * (s_red[7] * invBA);
        row[3] = log_alpha * ga;
        row[4] = alpha;
        row[5] = s_red[2] * invB;
        row[6] = s_red[3] * invB;
        row[7] = lp_mean;
        if (a.train_alpha) {
          const float mi = a.b1 * *a.alpha_m + a.one_m_b1 * ga;
          const float vi = a.b2 * *a.alpha_v + a.one_m_b2 * (ga * ga);
          *a.alpha_m = mi;
          *a.alpha_v = vi;
          const float la =
              log_alpha - a.lr_a * ((mi / bc1) / (sqrtf(vi / bc2) + ADAM_EPS));
          *a.log_alpha = fminf(fmaxf(la, a.log_amin), a.log_amax);
        }
      }
    }
    grid.sync();
  }
}

extern "C" {

const char* fused_sac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch that one launch needs at these sizes.
long long fused_sac_scratch_floats(int B, int H, int L, int O, int A) {
  return carve(nullptr, B, H, L, O, A).total;
}

// ptrs: obs, action, reward, terminal, next_obs, eps_next, eps_new; for
// each of the L + 2 policy layers w, b, mu(w), mu(b), nu(w), nu(b); for
// each of the L + 1 critic layers w, b, target w, target b, mu(w), mu(b),
// nu(w), nu(b); log alpha, its mu, its nu; scratch; metrics [K, 8].
// dims: K, B, O, A, H, L, t0 (the shared Adam count before the chain),
// train_alpha, bf16 (1: bf16 products, 0: float32).  hyper: discount,
// reward scale, tau, beta1, beta2, critic / policy / alpha learning rates,
// mean and std regularisers, target entropy, log min alpha, log max alpha,
// q target min and max (infinite when unset).  Launches once on `stream`;
// returns the CUDA error, cudaErrorInvalidValue for sizes the kernel does
// not take.
int fused_sac_chain(const void* const* ptrs, int n_ptrs, const int* dims,
                    const double* hyper, void* stream) {
  SacArgs a;
  a.K = dims[0]; a.B = dims[1]; a.O = dims[2]; a.A = dims[3];
  a.H = dims[4]; a.L = dims[5]; a.t0 = dims[6]; a.train_alpha = dims[7];
  a.bf16 = dims[8];
  if (a.K < 1 || a.B < 1 || a.O < 1 || a.A < 1 || a.A > SAC_MAX_A ||
      a.H < 1 || a.L < 1 || a.L > SAC_MAX_L || a.t0 < 0 ||
      (a.bf16 != 0 && a.bf16 != 1) ||
      n_ptrs != 7 + 6 * (a.L + 2) + 8 * (a.L + 1) + 5)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  auto next = [&]() {
    return static_cast<float*>(const_cast<void*>(ptrs[n++]));
  };
  a.obs = next(); a.act = next(); a.rew = next(); a.term = next();
  a.nobs = next(); a.epsn = next(); a.epsw = next();
  for (int l = 0; l < a.L + 2; ++l) {
    PolicyLayer& p = a.P[l];
    p.w = next(); p.b = next(); p.mw = next(); p.mb = next();
    p.vw = next(); p.vb = next();
  }
  for (int i = 0; i <= a.L; ++i) {
    CriticLayer& c = a.C[i];
    c.w = next(); c.b = next(); c.tw = next(); c.tb = next();
    c.mw = next(); c.mb = next(); c.vw = next(); c.vb = next();
  }
  a.log_alpha = next(); a.alpha_m = next(); a.alpha_v = next();
  a.scratch = next(); a.metrics = next();

  a.gamma = (float)hyper[0]; a.rscale = (float)hyper[1];
  a.tau = (float)hyper[2]; a.one_m_tau = (float)(1.0 - hyper[2]);
  a.b1d = hyper[3]; a.b2d = hyper[4];
  a.b1 = (float)hyper[3]; a.one_m_b1 = (float)(1.0 - hyper[3]);
  a.b2 = (float)hyper[4]; a.one_m_b2 = (float)(1.0 - hyper[4]);
  a.lr_q = (float)hyper[5]; a.lr_p = (float)hyper[6];
  a.lr_a = (float)hyper[7]; a.lam_m = (float)hyper[8];
  a.lam_s = (float)hyper[9]; a.target_entropy = (float)hyper[10];
  a.log_amin = (float)hyper[11]; a.log_amax = (float)hyper[12];
  a.q_lo = (float)hyper[13]; a.q_hi = (float)hyper[14];

  // the two-stage ring is over 48 KB: dynamic shared memory, asked for
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(sac_chain_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SAC_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cooperative launch needs every block resident at once: one per SM
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sac_chain_kernel, SAC_THREADS, SAC_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1 || sms < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sac_chain_kernel), dim3(sms), dim3(SAC_THREADS),
      args, SAC_SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
