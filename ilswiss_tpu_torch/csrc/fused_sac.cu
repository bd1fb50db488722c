// Kernel K2: K sequential SAC gradient steps in one launch: the critic
// target, the twin-critic forward and backward, the tanh-Gaussian policy
// forward and its hand-derived backward through the updated critics, Adam
// on the policy, the critics and log alpha, the Polyak step on the
// targets, and a [K, 8] table of metrics.
//
// Replaces: ilswiss_tpu/ops/fused_sac.py, `_make_kernel` (the Pallas TPU
// kernel launched by `fused_sac_chain`).  The plain PyTorch version is
// `fused_sac_chain_plain` in ilswiss_tpu_torch/ops/fused_sac.py; the
// formulas below follow it line for line.
//
// What bounds it on an H100: one step is sixteen 512 x 256 x 256 float32
// products and a dozen thin ones, about 1.1 GFLOP, on 3.1 MB of state that
// stays in the 50 MB L2; the card's float32 peak would take about 17 us a
// step, so operations bound it, not bytes.  The steps depend on each other,
// and inside a step some seventeen groups of products do, so the chain is
// also a few thousand device-wide barriers deep.
//
// What the design does about it: the TPU kernel keeps all state in one
// core's fast memory; an SM's shared memory (227 KB) cannot hold 3.1 MB,
// so this is ONE persistent cooperative kernel, one block per SM, with the
// state, the activations and the gradients in global memory (L2-resident)
// and `grid.sync()` between dependent phases.  Nothing returns to the host
// between steps.  Inside a phase the independent products (the policy on
// obs and on next_obs and both critics; a layer's weight gradient and its
// input gradient) are cut into 64 x 64 output tiles that are dealt round
// robin to the blocks.  A tile is a shared-memory product: 256 threads, a
// 4 x 4 micro-tile each, 16-deep slices of both operands staged through
// registers so that the next slice's loads overlap this slice's FMAs.
// Operands are read through small functors, so a product reads the
// parameters where PyTorch keeps them (nn.Linear [out, in], TwinQ
// [2, in, out]), a concatenation (obs, action) is never materialised, and a
// bias gradient is one more row or column (of ones) of the weight-gradient
// product.  Thin products (heads, Q outputs, the action columns of the
// input gradient) take one warp per batch row with a shuffle reduction,
// followed by the row's elementwise math and the top row of the backward
// pass that starts there.  The first layer's weight gradient has few
// output tiles and the whole batch to sum, so its batch is cut into eight
// parts that different blocks sum; Adam adds the eight partial sums in a
// fixed order.  Every reduction over the batch has one owner and a fixed
// order: no float atomics, so two launches on the same inputs give the
// same bits.  wgmma, TMA and bf16 are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define SAC_MAX_L 4
#define SAC_MAX_A 8
#define SAC_THREADS 256
#define SAC_WARPS (SAC_THREADS / 32)
#define SAC_TILE 64
#define SAC_KC 16
#define SAC_SSTRIDE 68  // shared row stride: 16-byte aligned, few conflicts
#define SAC_N_METRICS 8
#define SAC_KSPLIT 8  // parts of the batch in the first layer's gradient

#define TANH_EPS 1e-6f
#define LOG_SIG_MIN (-20.0f)
#define LOG_SIG_MAX 2.0f
#define ADAM_EPS 1e-8f
#define LOG_2PI 1.8378770664093453f

static_assert(SAC_THREADS == 4 * SAC_TILE, "slice loads: 4 per thread");
static_assert(SAC_WARPS == SAC_N_METRICS, "one warp reduces one statistic");

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
  int K, B, O, A, H, L, t0, train_alpha;
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
  // gradients, laid out layer by layer: w then b; layer 0 SAC_KSPLIT times
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

// Rows of a [rows, ld] matrix, optionally continued at column `split` by
// the rows of a second matrix: (obs, action) without a concatenation.
struct Rows {
  const float* p;
  int ld;
  const float* p2;
  int ld2;
  int split;
  __device__ float operator()(int m, int k) const {
    return k < split ? p[(size_t)m * ld + k]
                     : p2[(size_t)m * ld2 + (k - split)];
  }
};

__device__ inline Rows rows_of(const float* p, int ld) {
  return Rows{p, ld, nullptr, 0, 0x7fffffff};
}

// C(m, n) = sum_k A(m, k) * B(k, n) for m < M, n < N, handed to
// ep(m, n, sum).  la(m, k) and lb(k, n) read one operand element; AK / BK
// say that consecutive k (else consecutive m / n) are neighbours in
// memory, which picks the coalesced order of the slice loads.  The 64 x 64
// output tiles of successive calls in one phase are dealt round robin to
// the blocks: `task` is the running tile count of the phase.
template <bool AK, bool BK, class LA, class LB, class EP>
__device__ __forceinline__ void gemm(int M, int N, int K, LA la, LB lb, EP ep,
                                     int& task, float* As, float* Bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_n = (N + SAC_TILE - 1) / SAC_TILE;
  const int ntiles = ((M + SAC_TILE - 1) / SAC_TILE) * tiles_n;
  const int G = gridDim.x;
  const int first = ((int)blockIdx.x - task % G + G) % G;
  task = (task + ntiles) % G;
  for (int t = first; t < ntiles; t += G) {
    const int m0 = (t / tiles_n) * SAC_TILE, n0 = (t % tiles_n) * SAC_TILE;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float ra[4], rb[4];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = tid + r * SAC_THREADS;
        const int am = AK ? idx / SAC_KC : idx % SAC_TILE;
        const int ak = AK ? idx % SAC_KC : idx / SAC_TILE;
        ra[r] = (m0 + am < M && k0 + ak < K) ? la(m0 + am, k0 + ak) : 0.f;
        const int bn = BK ? idx / SAC_KC : idx % SAC_TILE;
        const int bk = BK ? idx % SAC_KC : idx / SAC_TILE;
        rb[r] = (n0 + bn < N && k0 + bk < K) ? lb(k0 + bk, n0 + bn) : 0.f;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += SAC_KC) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = tid + r * SAC_THREADS;
        const int am = AK ? idx / SAC_KC : idx % SAC_TILE;
        const int ak = AK ? idx % SAC_KC : idx / SAC_TILE;
        As[ak * SAC_SSTRIDE + am] = ra[r];
        const int bn = BK ? idx / SAC_KC : idx % SAC_TILE;
        const int bk = BK ? idx % SAC_KC : idx / SAC_TILE;
        Bs[bk * SAC_SSTRIDE + bn] = rb[r];
      }
      __syncthreads();
      if (k0 + SAC_KC < K) fetch(k0 + SAC_KC);
#pragma unroll
      for (int kk = 0; kk < SAC_KC; ++kk) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(&As[kk * SAC_SSTRIDE + ty * 4]);
        const float4 b4 =
            *reinterpret_cast<const float4*>(&Bs[kk * SAC_SSTRIDE + tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
        if (m < M && n < N) ep(m, n, acc[i][j]);
      }
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x . w over n entries, both contiguous; every lane gets the sum
__device__ inline float warp_dot(const float* x, const float* w, int n,
                                 int lane) {
  float acc = 0.f;
  for (int k = lane; k < n; k += 32) acc = fmaf(x[k], w[k], acc);
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

// The two policy heads on one trunk row `h`, then the sample and its
// log-prob: every lane returns with mean[j], raw log-std[j]; lane 0 does
// the row's elementwise math in the caller.
__device__ inline void warp_heads(const PolicyLayer hm, const PolicyLayer hs,
                                  int A, int H, const float* h, int lane,
                                  float* mean, float* lsr) {
#pragma unroll
  for (int j = 0; j < SAC_MAX_A; ++j) {
    if (j < A) {
      mean[j] = warp_dot(h, hm.w + (size_t)j * H, H, lane) + hm.b[j];
      lsr[j] = warp_dot(h, hs.w + (size_t)j * H, H, lane) + hs.b[j];
    }
  }
}

__global__ void __launch_bounds__(SAC_THREADS) sac_chain_kernel(SacArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) float As[SAC_KC * SAC_SSTRIDE];
  __shared__ __align__(16) float Bs[SAC_KC * SAC_SSTRIDE];
  __shared__ float s_bc[2];
  __shared__ float s_red[SAC_N_METRICS];

  const int B = a.B, O = a.O, A = a.A, H = a.H, L = a.L, D = O + A;
  const size_t BH = (size_t)B * H;
  const Scratch s = carve(a.scratch, B, H, L, O, A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * SAC_WARPS + warp;
  const int nwarps = gridDim.x * SAC_WARPS;
  const int gtid = blockIdx.x * SAC_THREADS + threadIdx.x;
  const int nthreads = gridDim.x * SAC_THREADS;
  const float invB = 1.0f / (float)B;
  const float invBA = 1.0f / (float)(B * A);

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
      const float* W = a.P[i].w;
      const float* bias = a.P[i].b;
      auto lw = [=](int k, int n) { return W[(size_t)n * in_p + k]; };
      {
        const Rows x = i ? rows_of(s.nact[(i - 1) & 1], H) : rows_of(nobs, O);
        float* out = s.nact[i & 1];
        gemm<true, true>(B, H, in_p, x, lw, [=](int m, int n, float v) {
          out[(size_t)m * H + n] = fmaxf(v + bias[n], 0.f);
        }, task, As, Bs);
      }
      {
        const Rows x =
            i ? rows_of(s.pact + (i - 1) * BH, H) : rows_of(obs, O);
        float* out = s.pact + i * BH;
        gemm<true, true>(B, H, in_p, x, lw, [=](int m, int n, float v) {
          out[(size_t)m * H + n] = fmaxf(v + bias[n], 0.f);
        }, task, As, Bs);
      }
      for (int e = 0; e < 2; ++e) {
        const Rows x = i ? rows_of(s.cact + (e * L + i - 1) * BH, H)
                         : Rows{obs, O, act, A, O};
        const float* Wc = a.C[i].w + (size_t)e * in_c * H;
        const float* bc = a.C[i].b + e * H;
        float* out = s.cact + (e * L + i) * BH;
        gemm<true, false>(B, H, in_c, x,
                          [=](int k, int n) { return Wc[(size_t)k * H + n]; },
                          [=](int m, int n, float v) {
                            out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
                          }, task, As, Bs);
      }
      grid.sync();
    }

    // ---- rows: heads and sample at next_obs; Q(obs, action); heads and
    // sample at obs
    for (int r = gwarp; r < 3 * B; r += nwarps) {
      const int kind = r / B, row = r % B;
      if (kind == 1) {
        for (int e = 0; e < 2; ++e) {
          const float qv =
              warp_dot(s.cact + (e * L + L - 1) * BH + (size_t)row * H,
                       a.C[L].w + e * H, H, lane) + a.C[L].b[e];
          if (lane == 0) s.q[e * B + row] = qv;
        }
        continue;
      }
      const float* h = (kind == 0 ? s.nact[(L - 1) & 1]
                                  : s.pact + (L - 1) * BH) + (size_t)row * H;
      const float* eps = (kind == 0 ? epsn : epsw) + (size_t)row * A;
      float mean[SAC_MAX_A], lsr[SAC_MAX_A];
      warp_heads(a.P[L], a.P[L + 1], A, H, h, lane, mean, lsr);
      if (lane == 0) {
        float lp = 0.f;
#pragma unroll
        for (int j = 0; j < SAC_MAX_A; ++j) {
          if (j < A) {
            const float ls = fminf(fmaxf(lsr[j], LOG_SIG_MIN), LOG_SIG_MAX);
            const float ej = eps[j];
            const float av = tanhf(mean[j] + expf(ls) * ej);
            lp += -0.5f * (ej * ej + 2.0f * ls + LOG_2PI) -
                  logf(1.0f - av * av + TANH_EPS);
            if (kind == 0) {
              s.an[row * A + j] = av;
            } else {
              s.mean[row * A + j] = mean[j];
              s.lsr[row * A + j] = lsr[j];
              s.anew[row * A + j] = av;
            }
          }
        }
        (kind == 0 ? s.lpn : s.lp)[row] = lp;
      }
    }
    grid.sync();

    // ---- target critics' trunk on (next_obs, a_next)
    for (int i = 0; i < L; ++i) {
      task = 0;
      const int in_c = i ? H : D;
      for (int e = 0; e < 2; ++e) {
        const Rows x = i ? rows_of(s.tact[(i - 1) & 1] + e * BH, H)
                         : Rows{nobs, O, s.an, A, O};
        const float* Wc = a.C[i].tw + (size_t)e * in_c * H;
        const float* bc = a.C[i].tb + e * H;
        float* out = s.tact[i & 1] + e * BH;
        gemm<true, false>(B, H, in_c, x,
                          [=](int k, int n) { return Wc[(size_t)k * H + n]; },
                          [=](int m, int n, float v) {
                            out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
                          }, task, As, Bs);
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
                         a.C[L].tw + e * H, H, lane) + a.C[L].tb[e];
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
        for (int k = lane; k < H; k += 32)
          dtop[k] = top[k] > 0.f ? dq * wout[k] : 0.f;
      }
    }
    grid.sync();

    // ---- critics' backward.  Layer i's kernel gradient is
    // acts[i]^T d_{i+1} with one more row of ones for the bias.
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
            const float* dq = s.dq + e * B;
            float* g = s.gC + goff[L] + e * H;
            float* gb = s.gC + goff[L] + 2 * H + e;
            gemm<false, false>(
                H + 1, 1, B,
                [=](int m, int k) {
                  return m < H ? top[(size_t)k * H + m] : 1.0f;
                },
                [=](int k, int n) { return dq[k]; },
                [=](int m, int n, float v) {
                  if (m < H) g[m] = v; else gb[0] = v;
                }, task, As, Bs);
          }
          const Rows x = i ? rows_of(s.cact + (e * L + i - 1) * BH, H)
                           : Rows{obs, O, act, A, O};
          // layer 0: the batch in SAC_KSPLIT parts, one partial sum each
          const int parts = i ? 1 : SAC_KSPLIT;
          const int Bp = (B + parts - 1) / parts;
          for (int part = 0; part < parts; ++part) {
            const int b0 = part * Bp;
            float* g = s.gC + goff[i] + part * n0 + (size_t)e * in_c * H;
            float* gb =
                s.gC + goff[i] + part * n0 + (size_t)2 * in_c * H + e * H;
            gemm<false, false>(
                in_c + 1, H, min(Bp, B - b0),
                [=](int m, int k) { return m < in_c ? x(b0 + k, m) : 1.0f; },
                [=](int k, int n) { return dup[(size_t)(b0 + k) * H + n]; },
                [=](int m, int n, float v) {
                  if (m < in_c) g[(size_t)m * H + n] = v; else gb[n] = v;
                }, task, As, Bs);
          }
          if (i > 0) {
            const float* Wc = a.C[i].w + (size_t)e * H * H;
            const float* mask = s.cact + (e * L + i - 1) * BH;
            float* out = s.dbuf[i & 1] + e * BH;
            gemm<true, true>(
                B, H, H, rows_of(dup, H),
                [=](int k, int n) { return Wc[(size_t)n * H + k]; },
                [=](int m, int n, float v) {
                  out[(size_t)m * H + n] =
                      mask[(size_t)m * H + n] > 0.f ? v : 0.f;
                }, task, As, Bs);
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
        adam_range(a.C[i].b, g + nw, parts, n0, a.C[i].mb, a.C[i].vb,
                   a.C[i].tb, nb, a.lr_q, adam, gtid, nthreads);
      }
      grid.sync();
    }

    // ---- updated critics' trunk on (obs, a_new)
    for (int i = 0; i < L; ++i) {
      task = 0;
      const int in_c = i ? H : D;
      for (int e = 0; e < 2; ++e) {
        const Rows x = i ? rows_of(s.kact + (e * L + i - 1) * BH, H)
                         : Rows{obs, O, s.anew, A, O};
        const float* Wc = a.C[i].w + (size_t)e * in_c * H;
        const float* bc = a.C[i].b + e * H;
        float* out = s.kact + (e * L + i) * BH;
        gemm<true, false>(B, H, in_c, x,
                          [=](int k, int n) { return Wc[(size_t)k * H + n]; },
                          [=](int m, int n, float v) {
                            out[(size_t)m * H + n] = fmaxf(v + bc[n], 0.f);
                          }, task, As, Bs);
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
                         a.C[L].w + e * H, H, lane) + a.C[L].b[e];
      const float sel0 = qn[0] <= qn[1] ? 1.0f : 0.0f;
      if (lane == 0)
        s.stat[5 * B + row] = alpha * s.lp[row] - fminf(qn[0], qn[1]);
      for (int e = 0; e < 2; ++e) {
        const float dq = -invB * (e == 0 ? sel0 : 1.0f - sel0);
        const float* top = s.kact + (e * L + L - 1) * BH + (size_t)row * H;
        const float* wout = a.C[L].w + e * H;
        float* dtop = s.dbuf[L & 1] + e * BH + (size_t)row * H;
        for (int k = lane; k < H; k += 32)
          dtop[k] = top[k] > 0.f ? dq * wout[k] : 0.f;
      }
    }
    grid.sync();

    // ---- back through the critics' trunk to layer 1's output
    for (int i = L - 1; i >= 1; --i) {
      task = 0;
      for (int e = 0; e < 2; ++e) {
        const float* Wc = a.C[i].w + (size_t)e * H * H;
        const float* mask = s.kact + (e * L + i - 1) * BH;
        float* out = s.dbuf[i & 1] + e * BH;
        gemm<true, true>(
            B, H, H, rows_of(s.dbuf[(i + 1) & 1] + e * BH, H),
            [=](int k, int n) { return Wc[(size_t)n * H + k]; },
            [=](int m, int n, float v) {
              out[(size_t)m * H + n] = mask[(size_t)m * H + n] > 0.f ? v : 0.f;
            }, task, As, Bs);
      }
      grid.sync();
    }

    // ---- rows: the action columns of the input gradient, the
    // tanh-Gaussian backward to dL/dmean and dL/d(raw log-std), and the
    // top of the policy trunk's backward: (dmean W_mean + dls W_ls) masked
    // by the last activation
    for (int row = gwarp; row < B; row += nwarps) {
      float daq[SAC_MAX_A];
#pragma unroll
      for (int j = 0; j < SAC_MAX_A; ++j) daq[j] = 0.f;
      for (int e = 0; e < 2; ++e) {
        const float* d1 = s.dbuf[1] + e * BH + (size_t)row * H;
        const float* W0 = a.C[0].w + (size_t)e * D * H;
        float part[SAC_MAX_A];
#pragma unroll
        for (int j = 0; j < SAC_MAX_A; ++j) part[j] = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float dk = d1[k];
#pragma unroll
          for (int j = 0; j < SAC_MAX_A; ++j)
            if (j < A)
              part[j] = fmaf(dk, W0[(size_t)(O + j) * H + k], part[j]);
        }
#pragma unroll
        for (int j = 0; j < SAC_MAX_A; ++j)
          if (j < A) daq[j] += warp_sum(part[j]);
      }
      float dmean[SAC_MAX_A], dlsr[SAC_MAX_A];
      {
        const float scale = alpha * invB;
        float sm = 0.f, ss = 0.f;
#pragma unroll
        for (int j = 0; j < SAC_MAX_A; ++j) {
          if (j < A) {
            const float mean = s.mean[row * A + j], lsr = s.lsr[row * A + j];
            const float ls = fminf(fmaxf(lsr, LOG_SIG_MIN), LOG_SIG_MAX);
            const float ej = epsw[row * A + j], av = s.anew[row * A + j];
            const float sigma = expf(ls), inv_sig = expf(-ls);
            const float one_m_a2 = 1.0f - av * av;
            const float da_tot =
                daq[j] + scale * 2.0f * av / (one_m_a2 + TANH_EPS);
            const float dz = da_tot * one_m_a2 - scale * ej * inv_sig;
            dmean[j] =
                dz + scale * ej * inv_sig + (2.0f * a.lam_m * invBA) * mean;
            const float dls = dz * sigma * ej + scale * (ej * ej - 1.0f) +
                              (2.0f * a.lam_s * invBA) * ls;
            dlsr[j] = (lsr > LOG_SIG_MIN && lsr < LOG_SIG_MAX) ? dls : 0.f;
            sm += mean * mean;
            ss += ls * ls;
            if (lane == 0) {
              s.dmean[row * A + j] = dmean[j];
              s.dls[row * A + j] = dlsr[j];
            }
          }
        }
        if (lane == 0) {
          s.stat[4 * B + row] = s.lp[row];
          s.stat[6 * B + row] = sm;
          s.stat[7 * B + row] = ss;
        }
      }
      const float* top = s.pact + (L - 1) * BH + (size_t)row * H;
      const float* Wm = a.P[L].w;
      const float* Ws = a.P[L + 1].w;
      float* dtop = s.dp[L & 1] + (size_t)row * H;
      for (int k = lane; k < H; k += 32) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < SAC_MAX_A; ++j) {
          if (j < A) {
            s1 = fmaf(dmean[j], Wm[(size_t)j * H + k], s1);
            s2 = fmaf(dlsr[j], Ws[(size_t)j * H + k], s2);
          }
        }
        dtop[k] = top[k] > 0.f ? s1 + s2 : 0.f;
      }
    }
    grid.sync();

    // ---- policy backward.  Gradients in nn.Linear's [out, in] layout
    // with one more column (of ones) for the bias.
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
          const float* dmean = s.dmean;
          const float* dls = s.dls;
          float* gm = s.gP + goff[L];
          float* gs = s.gP + goff[L + 1];
          gemm<false, false>(
              2 * A, H + 1, B,
              [=](int m, int k) {
                return m < A ? dmean[k * A + m] : dls[k * A + (m - A)];
              },
              [=](int k, int n) {
                return n < H ? top[(size_t)k * H + n] : 1.0f;
              },
              [=](int m, int n, float v) {
                float* g = m < A ? gm : gs;
                const int c = m < A ? m : m - A;
                if (n < H) g[(size_t)c * H + n] = v; else g[A * H + c] = v;
              }, task, As, Bs);
        }
        const Rows x = i ? rows_of(s.pact + (i - 1) * BH, H) : rows_of(obs, O);
        // layer 0: the batch in SAC_KSPLIT parts, one partial sum each
        const int parts = i ? 1 : SAC_KSPLIT;
        const int Bp = (B + parts - 1) / parts;
        for (int part = 0; part < parts; ++part) {
          const int b0 = part * Bp;
          float* g = s.gP + goff[i] + part * n0;
          gemm<false, false>(
              H, in_p + 1, min(Bp, B - b0),
              [=](int m, int k) { return dup[(size_t)(b0 + k) * H + m]; },
              [=](int k, int n) { return n < in_p ? x(b0 + k, n) : 1.0f; },
              [=](int m, int n, float v) {
                if (n < in_p) g[(size_t)m * in_p + n] = v;
                else g[(size_t)H * in_p + m] = v;
              }, task, As, Bs);
        }
        if (i > 0) {
          const float* W = a.P[i].w;
          const float* mask = s.pact + (i - 1) * BH;
          float* out = s.dp[i & 1];
          gemm<true, false>(
              B, H, H, rows_of(dup, H),
              [=](int k, int n) { return W[(size_t)k * H + n]; },
              [=](int m, int n, float v) {
                out[(size_t)m * H + n] =
                    mask[(size_t)m * H + n] > 0.f ? v : 0.f;
              }, task, As, Bs);
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
        adam_range(a.P[l].b, g + out * in, parts, n0, a.P[l].mb, a.P[l].vb,
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
// train_alpha.  hyper: discount, reward scale, tau, beta1, beta2, critic /
// policy / alpha learning rates, mean and std regularisers, target entropy,
// log min alpha, log max alpha, q target min and max (infinite when unset).
// Launches once on `stream`; returns the CUDA error, cudaErrorInvalidValue
// for sizes the kernel does not take.
int fused_sac_chain(const void* const* ptrs, int n_ptrs, const int* dims,
                    const double* hyper, void* stream) {
  SacArgs a;
  a.K = dims[0]; a.B = dims[1]; a.O = dims[2]; a.A = dims[3];
  a.H = dims[4]; a.L = dims[5]; a.t0 = dims[6]; a.train_alpha = dims[7];
  if (a.K < 1 || a.B < 1 || a.O < 1 || a.A < 1 || a.A > SAC_MAX_A ||
      a.H < 1 || a.L < 1 || a.L > SAC_MAX_L || a.t0 < 0 ||
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

  // a cooperative launch needs every block resident at once: one per SM
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sac_chain_kernel, SAC_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1 || sms < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sac_chain_kernel), dim3(sms), dim3(SAC_THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
