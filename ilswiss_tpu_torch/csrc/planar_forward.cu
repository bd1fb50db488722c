// Kernel K1: one constrained forward-dynamics evaluation of a planar chain
// (hopper, walker, halfcheetah, invertedpendulum) per env.
//
// Replaces: ilswiss_tpu/ops/planar_dynamics.py, `_fwd_kernel` (the Pallas
// TPU kernel launched by `_make_fwd_batched`).  The plain PyTorch version
// is `_forward_math` in ilswiss_tpu_torch/ops/planar_dynamics.py, which
// this file follows line for line: planar FK, analytic Jacobians, mass
// matrix, unrolled Cholesky, Coriolis/gravity bias, actuation and passive
// forces, contact and limit rows in the engine's order, W = M^-1 J^T,
// `iters` projected Gauss-Seidel sweeps, qacc, and for Euler models the
// implicit-damping solve with (M + h diag(damping)).
//
// What bounds it on an H100: neither bytes nor arithmetic throughput.  An
// evaluation reads (2 nv + nu + nrow) floats and writes (2 or 3) nv + nrow
// per env (about 0.4 KB for hopper), and its roughly 2e4 flops per env are
// a long chain of dependent scalar operations: FK, the Cholesky and every
// PGS row depend on the one before.  At the loop's B = 128 that is 128
// threads on a 132-SM card, so the time is one thread's serial depth plus
// the launch latency.
//
// What the design does about it: one thread per env, so envs never wait
// on each other and need no synchronisation; inputs and outputs in the
// [rows, B] structure-of-arrays layout, so neighbouring threads read
// neighbouring addresses; the model's constants as flat tables in
// __constant__ memory, where every thread of a warp reads the same
// address through the constant cache; loops over those tables instead of
// the Pallas unrolling, with PGS a real loop over `iters`.  M, L, W and
// the row data (a few KB per thread) spill to local memory, which stays
// in L1/L2 at these batch sizes.  Fusing the 16 evaluations of a control
// step into one launch is left for later work.

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_BODY 8
#define MAX_DOF 9
#define MAX_ACT 6
#define MAX_CON 16
#define MAX_LIM 12
#define MAX_ROW (4 * MAX_CON + MAX_LIM)
#define MAX_SLOTS 8
#define THREADS 128

static_assert(MAX_ROW == 76, "row maximum covers halfcheetah (76 rows)");

// Mirror of PlanarConsts in ops/planar_dynamics.py: 4-byte fields only.
// Impedance tables hold (d0, dw - d0, width, mid, power, a, b).
struct PlanarConsts {
  int nbody, nv, nu, ncon, nlim, nrow, nlimdof;
  float gz, floor_z;
  int body_parent[MAX_BODY];
  float body_x[MAX_BODY], body_z[MAX_BODY], body_ang[MAX_BODY];
  float ipos_x[MAX_BODY], ipos_z[MAX_BODY], mass[MAX_BODY], iyy[MAX_BODY];
  int joint_begin[MAX_BODY], joint_end[MAX_BODY];
  int body_ndof[MAX_BODY];
  int body_dofs[MAX_BODY][MAX_DOF];
  int body_nhinge[MAX_BODY];
  int body_hinges[MAX_BODY][MAX_DOF];
  int joint_hinge[MAX_DOF], joint_dof[MAX_DOF], joint_qadr[MAX_DOF];
  float joint_ax[MAX_DOF], joint_az[MAX_DOF], joint_sign[MAX_DOF];
  float joint_anx[MAX_DOF], joint_anz[MAX_DOF], joint_q0[MAX_DOF];
  int dof_hinge[MAX_DOF];
  float dof_sign[MAX_DOF], dof_ax[MAX_DOF], dof_az[MAX_DOF];
  int dof_nup[MAX_DOF];
  int dof_up[MAX_DOF][MAX_DOF];
  float armature[MAX_DOF], damping[MAX_DOF], hdamping[MAX_DOF];
  float stiffness[MAX_DOF], qpos_spring[MAX_DOF];
  int dof_qadr[MAX_DOF];
  int limdof[MAX_DOF];
  int act_dof[MAX_ACT];
  float act_gear[MAX_ACT], ctrl_lo[MAX_ACT], ctrl_hi[MAX_ACT];
  int con_body[MAX_CON], con_has_axis[MAX_CON];
  float con_lx[MAX_CON], con_lz[MAX_CON], con_axx[MAX_CON], con_axz[MAX_CON];
  float con_radius[MAX_CON], con_mu[MAX_CON], con_margin[MAX_CON];
  float con_k[MAX_CON], con_negb[MAX_CON], con_diag[MAX_CON];
  float con_imp[MAX_CON][7];
  int lim_dof[MAX_LIM], lim_qadr[MAX_LIM], lim_wcol[MAX_LIM];
  float lim_side[MAX_LIM], lim_bound[MAX_LIM], lim_k[MAX_LIM];
  float lim_negbside[MAX_LIM], lim_diag[MAX_LIM];
  float lim_imp[MAX_LIM][7];
};

__constant__ PlanarConsts c_models[MAX_SLOTS];

// The model of this launch; `slot` is uniform across the grid.
#define P (c_models[slot])

// MuJoCo solimp impedance (ops/rigid_body.py `_impedance`); `imp` is a
// per-thread copy of one impedance table, never a pointer into constant
// memory.
__device__ __forceinline__ float impedance(const float imp[7], float pos) {
  float x = fminf(fmaxf(fabsf(pos) / imp[2], 0.f), 1.f);
  float y = (x < imp[3]) ? imp[5] * powf(x, imp[4])
                         : 1.f - imp[6] * powf(1.f - x, imp[4]);
  return imp[0] + y * imp[1];
}

// Unrolled Cholesky with the sqrt(max(s, 1e-12)) floor; inv = 1 / L_ii.
__device__ __forceinline__ void cholesky(float M[MAX_DOF][MAX_DOF],
                                         float L[MAX_DOF][MAX_DOF],
                                         float inv[MAX_DOF], int nv) {
  for (int i = 0; i < nv; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = M[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        float lii = sqrtf(fmaxf(s, 1e-12f));
        L[i][i] = lii;
        inv[i] = 1.f / lii;
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
}

// Solve M x = rhs given the factor; rhs and x may alias.
__device__ __forceinline__ void chol_solve(float L[MAX_DOF][MAX_DOF],
                                           const float inv[MAX_DOF],
                                           const float* rhs, float* x,
                                           int nv) {
  float y[MAX_DOF];
  for (int i = 0; i < nv; ++i) {
    float s = rhs[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < nv; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

__global__ void __launch_bounds__(THREADS)
planar_forward_kernel(int slot, const float* __restrict__ q_in,
                      const float* __restrict__ qd_in,
                      const float* __restrict__ ctrl_in,
                      const float* __restrict__ f0_in,
                      float* __restrict__ qacc_out,
                      float* __restrict__ con_out,
                      float* __restrict__ f_out,
                      float* __restrict__ qacc_d_out,
                      int B, int iters, int damped) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int nv = P.nv, nb = P.nbody, nrow = P.nrow, ncon = P.ncon;

  float q[MAX_DOF], qd[MAX_DOF];
  for (int i = 0; i < nv; ++i) {
    q[i] = q_in[i * B + e];
    qd[i] = qd_in[i * B + e];
  }

  // ---- FK: body angles and origins, hinge world anchors -------------
  float ang[MAX_BODY], px[MAX_BODY], pz[MAX_BODY], cb[MAX_BODY], sb[MAX_BODY];
  float anc_x[MAX_DOF], anc_z[MAX_DOF];
  ang[0] = 0.f; px[0] = 0.f; pz[0] = 0.f; cb[0] = 1.f; sb[0] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const int par = P.body_parent[b];
    float a = ang[par] + P.body_ang[b];
    const float cp = cb[par], sp = sb[par];
    const float bx = P.body_x[b], bz = P.body_z[b];
    float x = px[par] + cp * bx + sp * bz;
    float z = pz[par] - sp * bx + cp * bz;
    float ca = cosf(a), sa = sinf(a);
    for (int j = P.joint_begin[b]; j < P.joint_end[b]; ++j) {
      if (!P.joint_hinge[j]) {
        const float qj = q[P.joint_qadr[j]] - P.joint_q0[j];
        x = x + P.joint_ax[j] * qj;
        z = z + P.joint_az[j] * qj;
      } else {
        const float qj = (q[P.joint_qadr[j]] - P.joint_q0[j]) * P.joint_sign[j];
        const float anx = P.joint_anx[j], anz = P.joint_anz[j];
        const float awx = x + ca * anx + sa * anz;
        const float awz = z - sa * anx + ca * anz;
        a = a + qj;
        ca = cosf(a);
        sa = sinf(a);
        x = awx - (ca * anx + sa * anz);
        z = awz - (-sa * anx + ca * anz);
        anc_x[P.joint_dof[j]] = awx;
        anc_z[P.joint_dof[j]] = awz;
      }
    }
    ang[b] = a; px[b] = x; pz[b] = z; cb[b] = ca; sb[b] = sa;
  }

  // Jacobian columns of a point attached below the first n dofs of list
  // `which` (0: dofs of body idx, 1: dofs above dof idx); zero elsewhere.
#define JAC_POINT(ptx, ptz, which, idx, Jx, Jz)                           \
  do {                                                                    \
    for (int d_ = 0; d_ < nv; ++d_) { Jx[d_] = 0.f; Jz[d_] = 0.f; }       \
    const int n_ = (which) ? P.dof_nup[idx] : P.body_ndof[idx];           \
    for (int i_ = 0; i_ < n_; ++i_) {                                     \
      const int d_ = (which) ? P.dof_up[idx][i_] : P.body_dofs[idx][i_];  \
      if (P.dof_hinge[d_]) {                                              \
        const float s_ = P.dof_sign[d_];                                  \
        Jx[d_] = s_ * ((ptz) - anc_z[d_]);                                \
        Jz[d_] = -(s_ * ((ptx) - anc_x[d_]));                             \
      } else {                                                            \
        Jx[d_] = P.dof_ax[d_];                                            \
        Jz[d_] = P.dof_az[d_];                                            \
      }                                                                   \
    }                                                                     \
  } while (0)
#define VEL_OF(Jx, Jz, which, idx, vx, vz)                                \
  do {                                                                    \
    vx = 0.f; vz = 0.f;                                                   \
    const int n_ = (which) ? P.dof_nup[idx] : P.body_ndof[idx];           \
    for (int i_ = 0; i_ < n_; ++i_) {                                     \
      const int d_ = (which) ? P.dof_up[idx][i_] : P.body_dofs[idx][i_];  \
      vx = vx + qd[d_] * Jx[d_];                                          \
      vz = vz + qd[d_] * Jz[d_];                                          \
    }                                                                     \
  } while (0)

  // ---- CoM Jacobians, mass matrix, Cholesky --------------------------
  float Jcx[MAX_BODY][MAX_DOF], Jcz[MAX_BODY][MAX_DOF];
  float M[MAX_DOF][MAX_DOF];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) M[i][j] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float ix = P.ipos_x[b], iz = P.ipos_z[b];
    const float cx = px[b] + cb[b] * ix + sb[b] * iz;
    const float cz = pz[b] - sb[b] * ix + cb[b] * iz;
    JAC_POINT(cx, cz, 0, b, Jcx[b], Jcz[b]);
    const float mb = P.mass[b], ib = P.iyy[b];
    const int n = P.body_ndof[b];
    for (int ii = 0; ii < n; ++ii) {
      const int di = P.body_dofs[b][ii];
      const float wi = P.dof_hinge[di] ? P.dof_sign[di] : 0.f;
      for (int jj = ii; jj < n; ++jj) {
        const int dj = P.body_dofs[b][jj];
        const float wj = P.dof_hinge[dj] ? P.dof_sign[dj] : 0.f;
        float t = mb * (Jcx[b][di] * Jcx[b][dj] + Jcz[b][di] * Jcz[b][dj]);
        if (wi != 0.f && wj != 0.f) t = t + ib * (wi * wj);
        M[di][dj] = M[di][dj] + t;
      }
    }
  }
  for (int i = 0; i < nv; ++i) {
    M[i][i] = M[i][i] + P.armature[i];
    for (int j = i + 1; j < nv; ++j) M[j][i] = M[i][j];
  }
  float L[MAX_DOF][MAX_DOF], inv[MAX_DOF];
  cholesky(M, L, inv, nv);

  // ---- bias (Coriolis + gravity) and smooth forces --------------------
  float avx[MAX_DOF], avz[MAX_DOF];
  {
    float jx[MAX_DOF], jz[MAX_DOF];
    for (int d = 0; d < nv; ++d) {
      if (!P.dof_hinge[d]) continue;
      JAC_POINT(anc_x[d], anc_z[d], 1, d, jx, jz);
      VEL_OF(jx, jz, 1, d, avx[d], avz[d]);
    }
  }
  float bias[MAX_DOF];
  for (int d = 0; d < nv; ++d) bias[d] = 0.f;
  for (int b = 1; b < nb; ++b) {
    float vbx, vbz;
    VEL_OF(Jcx[b], Jcz[b], 0, b, vbx, vbz);
    float ax = 0.f, az = 0.f;
    for (int i = 0; i < P.body_nhinge[b]; ++i) {
      const int d = P.body_hinges[b][i];
      const float s = P.dof_sign[d];
      ax = ax + qd[d] * (s * (vbz - avz[d]));
      az = az + qd[d] * (-(s * (vbx - avx[d])));
    }
    const float fx = P.mass[b] * ax;
    const float fz = P.mass[b] * (az - P.gz);
    for (int i = 0; i < P.body_ndof[b]; ++i) {
      const int d = P.body_dofs[b][i];
      bias[d] = bias[d] + Jcx[b][d] * fx + Jcz[b][d] * fz;
    }
  }
  float qfrc[MAX_DOF];
  for (int d = 0; d < nv; ++d) qfrc[d] = 0.f;
  for (int u = 0; u < P.nu; ++u) {
    const float c = fminf(fmaxf(ctrl_in[u * B + e], P.ctrl_lo[u]), P.ctrl_hi[u]);
    qfrc[P.act_dof[u]] = qfrc[P.act_dof[u]] + P.act_gear[u] * c;
  }
  for (int d = 0; d < nv; ++d) {
    float p = qfrc[d] - P.damping[d] * qd[d] - bias[d];
    if (P.stiffness[d] != 0.f)
      p = p - P.stiffness[d] * (q[P.dof_qadr[d]] - P.qpos_spring[d]);
    qfrc[d] = p;
  }
  float qacc_s[MAX_DOF];
  chol_solve(L, inv, qfrc, qacc_s, nv);

  float qacc[MAX_DOF], con[MAX_DOF];
  for (int d = 0; d < nv; ++d) { qacc[d] = qacc_s[d]; con[d] = 0.f; }

  if (nrow > 0) {
    // ---- constraint rows (the engine's order) -------------------------
    float row_mt[MAX_ROW], row_aref[MAX_ROW], row_dimp[MAX_ROW];
    bool row_active[MAX_ROW];
    float Jx[MAX_CON][MAX_DOF], Jz[MAX_CON][MAX_DOF];
    for (int ci = 0; ci < ncon; ++ci) {
      const int b = P.con_body[ci];
      const float lx = P.con_lx[ci], lz = P.con_lz[ci];
      const float ccx = px[b] + cb[b] * lx + sb[b] * lz;
      const float ccz = pz[b] - sb[b] * lx + cb[b] * lz;
      const float gap = ccz - P.con_radius[ci] - P.floor_z;
      const float xcz = ccz - (P.con_radius[ci] + 0.5f * gap);
      JAC_POINT(ccx, xcz, 0, b, Jx[ci], Jz[ci]);
      float vx, vz;
      VEL_OF(Jx[ci], Jz[ci], 0, b, vx, vz);
      const float pos = gap - P.con_margin[ci];
      const bool active = pos < 0.f;
      float imp[7];
      for (int k = 0; k < 7; ++k) imp[k] = P.con_imp[ci][k];
      const float dimp = impedance(imp, pos);
      // tangent frame: exactly one of t1, t2 lies in the plane
      float t1x = 0.f, t2x = -1.f;
      if (P.con_has_axis[ci]) {
        const float awx = cb[b] * P.con_axx[ci] + sb[b] * P.con_axz[ci];
        const float lax = fabsf(awx);
        const bool inpl = lax > 1e-8f;
        t1x = inpl ? -awx / fmaxf(lax, 1e-8f) : 0.f;
        t2x = inpl ? 0.f : -1.f;
      }
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * ci + k;
        const float tx = (k < 2) ? t1x : t2x;
        const float smu = (k % 2 == 0) ? P.con_mu[ci] : -P.con_mu[ci];
        const float vt = tx * vx;
        row_mt[r] = smu * tx;
        row_aref[r] = P.con_negb[ci] * (vz + smu * vt)
                      - P.con_k[ci] * dimp * pos;
        row_dimp[r] = dimp;
        row_active[r] = active;
      }
    }
    for (int li = 0; li < P.nlim; ++li) {
      const int r = 4 * ncon + li;
      const float pos = P.lim_side[li] * (q[P.lim_qadr[li]] - P.lim_bound[li]);
      float imp[7];
      for (int k = 0; k < 7; ++k) imp[k] = P.lim_imp[li][k];
      const float dimp = impedance(imp, pos);
      row_aref[r] = P.lim_negbside[li] * qd[P.lim_dof[li]]
                    - P.lim_k[li] * dimp * pos;
      row_dimp[r] = dimp;
      row_active[r] = pos < 0.f;
    }

    // ---- W = M^-1 J^T for the basis columns, then per-row data ---------
    float Wz[MAX_CON][MAX_DOF], Wx[MAX_CON][MAX_DOF], Wl[MAX_DOF][MAX_DOF];
    for (int ci = 0; ci < ncon; ++ci) {
      chol_solve(L, inv, Jz[ci], Wz[ci], nv);
      chol_solve(L, inv, Jx[ci], Wx[ci], nv);
    }
    for (int k = 0; k < P.nlimdof; ++k) {
      float ed[MAX_DOF];
      for (int d = 0; d < nv; ++d) ed[d] = (d == P.limdof[k]) ? 1.f : 0.f;
      chol_solve(L, inv, ed, Wl[k], nv);
    }
    float jrow[MAX_ROW][MAX_DOF], wrow[MAX_ROW][MAX_DOF];
    float rreg[MAX_ROW], Dr[MAX_ROW], bv[MAX_ROW];
    for (int ci = 0; ci < ncon; ++ci) {
      float ann = 0.f, anx = 0.f, axx = 0.f, bq = 0.f, bx = 0.f;
      for (int d = 0; d < nv; ++d) {
        ann = ann + Jz[ci][d] * Wz[ci][d];
        anx = anx + Jz[ci][d] * Wx[ci][d];
        axx = axx + Jx[ci][d] * Wx[ci][d];
        bq = bq + Jz[ci][d] * qacc_s[d];
        bx = bx + Jx[ci][d] * qacc_s[d];
      }
      for (int r = 4 * ci; r < 4 * ci + 4; ++r) {
        const float mt = row_mt[r];
        for (int d = 0; d < nv; ++d) {
          jrow[r][d] = Jz[ci][d] + mt * Jx[ci][d];
          wrow[r][d] = Wz[ci][d] + mt * Wx[ci][d];
        }
        const float dsafe = fminf(fmaxf(row_dimp[r], 1e-4f), 0.999999f);
        rreg[r] = fmaxf((1.f - dsafe) / dsafe * P.con_diag[ci], 1e-15f);
        const float adiag = ann + 2.f * mt * anx + mt * mt * axx;
        Dr[r] = fmaxf(adiag + rreg[r], 1e-9f);
        bv[r] = bq + mt * bx - row_aref[r];
      }
    }
    for (int li = 0; li < P.nlim; ++li) {
      const int r = 4 * ncon + li;
      const int d0 = P.lim_dof[li];
      const float side = P.lim_side[li];
      const float* w = Wl[P.lim_wcol[li]];
      for (int d = 0; d < nv; ++d) {
        jrow[r][d] = (d == d0) ? side : 0.f;
        wrow[r][d] = w[d] * side;
      }
      const float dsafe = fminf(fmaxf(row_dimp[r], 1e-4f), 0.999999f);
      rreg[r] = fmaxf((1.f - dsafe) / dsafe * P.lim_diag[li], 1e-15f);
      Dr[r] = fmaxf(w[d0] + rreg[r], 1e-9f);
      bv[r] = side * qacc_s[d0] - row_aref[r];
    }

    // ---- projected Gauss-Seidel on u = M^-1 J^T f -----------------------
    float f[MAX_ROW], u[MAX_DOF];
    for (int d = 0; d < nv; ++d) u[d] = 0.f;
    for (int r = 0; r < nrow; ++r) {
      f[r] = row_active[r] ? f0_in[r * B + e] : 0.f;
      for (int d = 0; d < nv; ++d) u[d] = u[d] + f[r] * wrow[r][d];
    }
    for (int it = 0; it < iters; ++it) {
      for (int r = 0; r < nrow; ++r) {
        float ju = 0.f;
        for (int d = 0; d < nv; ++d) ju = ju + jrow[r][d] * u[d];
        const float res = ju + rreg[r] * f[r] + bv[r];
        float fr = fmaxf(0.f, f[r] - res / Dr[r]);
        fr = row_active[r] ? fr : 0.f;
        const float delta = fr - f[r];
        for (int d = 0; d < nv; ++d) u[d] = u[d] + delta * wrow[r][d];
        f[r] = fr;
      }
    }
    for (int d = 0; d < nv; ++d) qacc[d] = qacc_s[d] + u[d];
    for (int r = 0; r < nrow; ++r) {
      for (int d = 0; d < nv; ++d) con[d] = con[d] + f[r] * jrow[r][d];
      f_out[r * B + e] = f[r];
    }
  }

  for (int d = 0; d < nv; ++d) {
    qacc_out[d * B + e] = qacc[d];
    con_out[d * B + e] = con[d];
  }
  if (damped) {
    // (M + h diag(damping)) qacc_d = qfrc + con
    for (int i = 0; i < nv; ++i) M[i][i] = M[i][i] + P.hdamping[i];
    cholesky(M, L, inv, nv);
    float rhs[MAX_DOF], qacc_d[MAX_DOF];
    for (int d = 0; d < nv; ++d) rhs[d] = qfrc[d] + con[d];
    chol_solve(L, inv, rhs, qacc_d, nv);
    for (int d = 0; d < nv; ++d) qacc_d_out[d * B + e] = qacc_d[d];
  }
#undef JAC_POINT
#undef VEL_OF
}

#undef P

extern "C" {

size_t planar_consts_size() { return sizeof(PlanarConsts); }

const char* planar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Copy one model's constant table into slot `slot` of c_models.
int planar_set_model(int slot, const void* consts, size_t nbytes) {
  if (slot < 0 || slot >= MAX_SLOTS || nbytes != sizeof(PlanarConsts))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyToSymbol(
      c_models, consts, nbytes, slot * sizeof(PlanarConsts),
      cudaMemcpyHostToDevice));
}

// One forward evaluation of B envs on `stream`; all arrays [rows, B] f32.
int planar_forward_launch(int slot, const float* q, const float* qd,
                          const float* ctrl, const float* f0, float* qacc,
                          float* con, float* f, float* qacc_d, int B,
                          int iters, int damped, void* stream) {
  if (slot < 0 || slot >= MAX_SLOTS || B <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + THREADS - 1) / THREADS;
  planar_forward_kernel<<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      slot, q, qd, ctrl, f0, qacc, con, f, qacc_d, B, iters, damped);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
