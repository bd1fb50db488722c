// Kernel K1: the planar chains' physics (hopper, walker, halfcheetah,
// invertedpendulum): one whole control step per launch, or one forward
// evaluation.
//
// Replaces: ilswiss_tpu/ops/planar_dynamics.py, `_fwd_kernel` (:694, the
// Pallas TPU kernel that `_make_fwd_batched` launches once per forward
// evaluation) together with the integrator around it (`_substep` and
// `_control_step`, :647-682).  The plain PyTorch versions are
// `_forward_math` and `_control_step` in ilswiss_tpu_torch/ops/
// planar_dynamics.py, which this file follows line for line: planar FK,
// analytic Jacobians, mass matrix, unrolled Cholesky, Coriolis/gravity
// bias, actuation and passive forces, contact and limit rows in the
// engine's order, W = M^-1 J^T, `iters` projected Gauss-Seidel sweeps,
// qacc, for Euler models the implicit-damping solve with
// (M + h diag(damping)); then `frame_skip` substeps of RK4 (four
// evaluations each, warm-started from the last one's row forces) or of
// semi-implicit Euler, with the same float operations in the same order.
//
// What bounds it on an H100: the serial depth of one env's chain.  An
// evaluation reads and writes well under a kilobyte per env and its
// roughly 2e4 flops depend on each other: FK, the Cholesky and every PGS
// row update need the one before (hopper: 15 sweeps of 38 rows, 570
// dependent row updates an evaluation, 16 evaluations a control step).
// Neither the memory rate nor the arithmetic rate comes near to binding.
//
// What the design does about it: nothing waits on anything but the chain
// itself.  One thread per env, and the envs spread over the SMs: a block
// holds ceil(B / SMs) envs (one at the loop's B = 128, eight at 1024), so
// at B = 128 no two envs share an SM.  Each env's working set (M, L, the Jacobians, W, the row
// data and forces, about 13 KB, sized for 76 rows) lives in dynamic
// shared memory, not in a local-memory frame that spills to L2; the PGS
// sweep, which is most of the work, keeps u in registers (the dof count is
// a template parameter, 6 or 9, with the rows zero-padded beyond the
// model's nv, which adds exact zeros).  A whole control step is one
// launch: the RK4 or Euler combination runs in the kernel between
// evaluations, so a hopper control step (16 evaluations) needs no launch
// or tensor operation between them.  The model's constants are a
// table in device memory passed by pointer.  One thread per env also
// means no synchronisation and no atomics: two launches give the same
// bits.  Built with -fmad=false so that it rounds like its plain version.

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_BODY 8
#define MAX_DOF 9
#define MAX_ACT 6
#define MAX_CON 16
#define MAX_LIM 12
#define MAX_ROW (4 * MAX_CON + MAX_LIM)
#define MAX_ENVS_PER_BLOCK 16

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
  float h;          // timestep
  int frame_skip;
  int euler;        // 1: semi-implicit Euler with damping, 0: RK4
};

// One env's working set, in shared memory.
struct Work {
  float q[MAX_DOF], qd[MAX_DOF], ctrl[MAX_ACT];
  float qacc[MAX_DOF], con[MAX_DOF], qacc_d[MAX_DOF];
  float M[MAX_DOF][MAX_DOF], L[MAX_DOF][MAX_DOF], inv[MAX_DOF];
  float qfrc[MAX_DOF], qacc_s[MAX_DOF], y[MAX_DOF], tmp[MAX_DOF];
  float ang[MAX_BODY], px[MAX_BODY], pz[MAX_BODY], cb[MAX_BODY], sb[MAX_BODY];
  float anc_x[MAX_DOF], anc_z[MAX_DOF], avx[MAX_DOF], avz[MAX_DOF];
  float Jcx[MAX_BODY][MAX_DOF], Jcz[MAX_BODY][MAX_DOF];
  float Jx[MAX_CON][MAX_DOF], Jz[MAX_CON][MAX_DOF];
  float Wx[MAX_CON][MAX_DOF], Wz[MAX_CON][MAX_DOF], Wl[MAX_DOF][MAX_DOF];
  float jrow[MAX_ROW][MAX_DOF], wrow[MAX_ROW][MAX_DOF];
  float row_mt[MAX_ROW], row_aref[MAX_ROW], row_dimp[MAX_ROW];
  float rreg[MAX_ROW], Dr[MAX_ROW], bv[MAX_ROW], f[MAX_ROW];
  int active[MAX_ROW];
  // the integrator: the substep's start, velocities and accelerations of
  // its RK4 stages, the evaluated state
  float q0[MAX_DOF], qd0[MAX_DOF];
  float kv[4][MAX_DOF], ka[4][MAX_DOF];
  float q_ev[MAX_DOF], qd_ev[MAX_DOF], con_out[MAX_DOF];
};

struct PlanarArgs {
  const PlanarConsts* P;
  const float *q, *qd, *ctrl, *f0;   // [rows, B]
  // a control step: q, qd, qfrc_con, f, q_ev, qd_ev; an evaluation:
  // qacc (in `q_out`), qfrc_con, f and, when damped, the damped qacc (in
  // `qd_out`)
  float *q_out, *qd_out, *con_out, *f_out, *qev_out, *qdev_out;
  int B, iters, step, damped;
};

// MuJoCo solimp impedance (ops/rigid_body.py `_impedance`).
__device__ __forceinline__ float impedance(const float* imp, float pos) {
  float x = fminf(fmaxf(fabsf(pos) / imp[2], 0.f), 1.f);
  float y = (x < imp[3]) ? imp[5] * powf(x, imp[4])
                         : 1.f - imp[6] * powf(1.f - x, imp[4]);
  return imp[0] + y * imp[1];
}

// Unrolled Cholesky with the sqrt(max(s, 1e-12)) floor; inv = 1 / L_ii.
__device__ __forceinline__ void cholesky(Work& w, int nv) {
  for (int i = 0; i < nv; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = w.M[i][j];
      for (int k = 0; k < j; ++k) s = s - w.L[i][k] * w.L[j][k];
      if (i == j) {
        float lii = sqrtf(fmaxf(s, 1e-12f));
        w.L[i][i] = lii;
        w.inv[i] = 1.f / lii;
      } else {
        w.L[i][j] = s * w.inv[j];
      }
    }
  }
}

// Solve M x = rhs given the factor; rhs and x may alias.
__device__ __forceinline__ void chol_solve(Work& w, const float* rhs,
                                           float* x, int nv) {
  for (int i = 0; i < nv; ++i) {
    float s = rhs[i];
    for (int k = 0; k < i; ++k) s = s - w.L[i][k] * w.y[k];
    w.y[i] = s * w.inv[i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float s = w.y[i];
    for (int k = i + 1; k < nv; ++k) s = s - w.L[k][i] * x[k];
    x[i] = s * w.inv[i];
  }
}

// Jacobian columns of a point attached below the dofs of body `b` (which
// = 0) or above dof `b` (which = 1); zero elsewhere.
__device__ __forceinline__ void jac_point(const PlanarConsts& P, Work& w,
                                          float ptx, float ptz, int which,
                                          int idx, float* Jx, float* Jz) {
  const int nv = P.nv;
  for (int d = 0; d < MAX_DOF; ++d) {
    Jx[d] = 0.f;
    Jz[d] = 0.f;
  }
  const int n = which ? P.dof_nup[idx] : P.body_ndof[idx];
  for (int i = 0; i < n; ++i) {
    const int d = which ? P.dof_up[idx][i] : P.body_dofs[idx][i];
    if (d >= nv) continue;
    if (P.dof_hinge[d]) {
      const float s = P.dof_sign[d];
      Jx[d] = s * (ptz - w.anc_z[d]);
      Jz[d] = -(s * (ptx - w.anc_x[d]));
    } else {
      Jx[d] = P.dof_ax[d];
      Jz[d] = P.dof_az[d];
    }
  }
}

__device__ __forceinline__ void vel_of(const PlanarConsts& P, const Work& w,
                                       const float* Jx, const float* Jz,
                                       int which, int idx, float& vx,
                                       float& vz) {
  vx = 0.f;
  vz = 0.f;
  const int n = which ? P.dof_nup[idx] : P.body_ndof[idx];
  for (int i = 0; i < n; ++i) {
    const int d = which ? P.dof_up[idx][i] : P.body_dofs[idx][i];
    vx = vx + w.qd[d] * Jx[d];
    vz = vz + w.qd[d] * Jz[d];
  }
}

// One forward evaluation at (w.q, w.qd, w.ctrl), warm-started from w.f:
// leaves qacc, con, f and, when `damped`, qacc_d in `w`.
template <int NV>
__device__ __noinline__ void forward(const PlanarConsts& P, Work& w,
                                     int iters, int damped) {
  const int nv = P.nv, nb = P.nbody, nrow = P.nrow, ncon = P.ncon;

  // ---- FK: body angles and origins, hinge world anchors -------------
  w.ang[0] = 0.f; w.px[0] = 0.f; w.pz[0] = 0.f; w.cb[0] = 1.f; w.sb[0] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const int par = P.body_parent[b];
    float a = w.ang[par] + P.body_ang[b];
    const float cp = w.cb[par], sp = w.sb[par];
    const float bx = P.body_x[b], bz = P.body_z[b];
    float x = w.px[par] + cp * bx + sp * bz;
    float z = w.pz[par] - sp * bx + cp * bz;
    float ca = cosf(a), sa = sinf(a);
    for (int j = P.joint_begin[b]; j < P.joint_end[b]; ++j) {
      if (!P.joint_hinge[j]) {
        const float qj = w.q[P.joint_qadr[j]] - P.joint_q0[j];
        x = x + P.joint_ax[j] * qj;
        z = z + P.joint_az[j] * qj;
      } else {
        const float qj = (w.q[P.joint_qadr[j]] - P.joint_q0[j]) * P.joint_sign[j];
        const float anx = P.joint_anx[j], anz = P.joint_anz[j];
        const float awx = x + ca * anx + sa * anz;
        const float awz = z - sa * anx + ca * anz;
        a = a + qj;
        ca = cosf(a);
        sa = sinf(a);
        x = awx - (ca * anx + sa * anz);
        z = awz - (-sa * anx + ca * anz);
        w.anc_x[P.joint_dof[j]] = awx;
        w.anc_z[P.joint_dof[j]] = awz;
      }
    }
    w.ang[b] = a; w.px[b] = x; w.pz[b] = z; w.cb[b] = ca; w.sb[b] = sa;
  }

  // ---- CoM Jacobians, mass matrix, Cholesky --------------------------
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) w.M[i][j] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float ix = P.ipos_x[b], iz = P.ipos_z[b];
    const float cx = w.px[b] + w.cb[b] * ix + w.sb[b] * iz;
    const float cz = w.pz[b] - w.sb[b] * ix + w.cb[b] * iz;
    jac_point(P, w, cx, cz, 0, b, w.Jcx[b], w.Jcz[b]);
    const float mb = P.mass[b], ib = P.iyy[b];
    const int n = P.body_ndof[b];
    for (int ii = 0; ii < n; ++ii) {
      const int di = P.body_dofs[b][ii];
      const float wi = P.dof_hinge[di] ? P.dof_sign[di] : 0.f;
      for (int jj = ii; jj < n; ++jj) {
        const int dj = P.body_dofs[b][jj];
        const float wj = P.dof_hinge[dj] ? P.dof_sign[dj] : 0.f;
        float t = mb * (w.Jcx[b][di] * w.Jcx[b][dj] + w.Jcz[b][di] * w.Jcz[b][dj]);
        if (wi != 0.f && wj != 0.f) t = t + ib * (wi * wj);
        w.M[di][dj] = w.M[di][dj] + t;
      }
    }
  }
  for (int i = 0; i < nv; ++i) {
    w.M[i][i] = w.M[i][i] + P.armature[i];
    for (int j = i + 1; j < nv; ++j) w.M[j][i] = w.M[i][j];
  }
  cholesky(w, nv);

  // ---- bias (Coriolis + gravity) and smooth forces --------------------
  for (int d = 0; d < nv; ++d) {
    if (!P.dof_hinge[d]) continue;
    jac_point(P, w, w.anc_x[d], w.anc_z[d], 1, d, w.y, w.tmp);
    vel_of(P, w, w.y, w.tmp, 1, d, w.avx[d], w.avz[d]);
  }
  float* bias = w.qacc;  // free until qacc is written
  for (int d = 0; d < nv; ++d) bias[d] = 0.f;
  for (int b = 1; b < nb; ++b) {
    float vbx, vbz;
    vel_of(P, w, w.Jcx[b], w.Jcz[b], 0, b, vbx, vbz);
    float ax = 0.f, az = 0.f;
    for (int i = 0; i < P.body_nhinge[b]; ++i) {
      const int d = P.body_hinges[b][i];
      const float s = P.dof_sign[d];
      ax = ax + w.qd[d] * (s * (vbz - w.avz[d]));
      az = az + w.qd[d] * (-(s * (vbx - w.avx[d])));
    }
    const float fx = P.mass[b] * ax;
    const float fz = P.mass[b] * (az - P.gz);
    for (int i = 0; i < P.body_ndof[b]; ++i) {
      const int d = P.body_dofs[b][i];
      bias[d] = bias[d] + w.Jcx[b][d] * fx + w.Jcz[b][d] * fz;
    }
  }
  for (int d = 0; d < nv; ++d) w.qfrc[d] = 0.f;
  for (int u = 0; u < P.nu; ++u) {
    const float c = fminf(fmaxf(w.ctrl[u], P.ctrl_lo[u]), P.ctrl_hi[u]);
    w.qfrc[P.act_dof[u]] = w.qfrc[P.act_dof[u]] + P.act_gear[u] * c;
  }
  for (int d = 0; d < nv; ++d) {
    float p = w.qfrc[d] - P.damping[d] * w.qd[d] - bias[d];
    if (P.stiffness[d] != 0.f)
      p = p - P.stiffness[d] * (w.q[P.dof_qadr[d]] - P.qpos_spring[d]);
    w.qfrc[d] = p;
  }
  chol_solve(w, w.qfrc, w.qacc_s, nv);

  for (int d = 0; d < nv; ++d) {
    w.qacc[d] = w.qacc_s[d];
    w.con[d] = 0.f;
  }

  if (nrow > 0) {
    // ---- constraint rows (the engine's order) -------------------------
    for (int ci = 0; ci < ncon; ++ci) {
      const int b = P.con_body[ci];
      const float lx = P.con_lx[ci], lz = P.con_lz[ci];
      const float ccx = w.px[b] + w.cb[b] * lx + w.sb[b] * lz;
      const float ccz = w.pz[b] - w.sb[b] * lx + w.cb[b] * lz;
      const float gap = ccz - P.con_radius[ci] - P.floor_z;
      const float xcz = ccz - (P.con_radius[ci] + 0.5f * gap);
      jac_point(P, w, ccx, xcz, 0, b, w.Jx[ci], w.Jz[ci]);
      float vx, vz;
      vel_of(P, w, w.Jx[ci], w.Jz[ci], 0, b, vx, vz);
      const float pos = gap - P.con_margin[ci];
      const int active = pos < 0.f;
      const float dimp = impedance(P.con_imp[ci], pos);
      // tangent frame: exactly one of t1, t2 lies in the plane
      float t1x = 0.f, t2x = -1.f;
      if (P.con_has_axis[ci]) {
        const float awx = w.cb[b] * P.con_axx[ci] + w.sb[b] * P.con_axz[ci];
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
        w.row_mt[r] = smu * tx;
        w.row_aref[r] = P.con_negb[ci] * (vz + smu * vt)
                        - P.con_k[ci] * dimp * pos;
        w.row_dimp[r] = dimp;
        w.active[r] = active;
      }
    }
    for (int li = 0; li < P.nlim; ++li) {
      const int r = 4 * ncon + li;
      const float pos = P.lim_side[li] * (w.q[P.lim_qadr[li]] - P.lim_bound[li]);
      const float dimp = impedance(P.lim_imp[li], pos);
      w.row_aref[r] = P.lim_negbside[li] * w.qd[P.lim_dof[li]]
                      - P.lim_k[li] * dimp * pos;
      w.row_dimp[r] = dimp;
      w.active[r] = pos < 0.f;
    }

    // ---- W = M^-1 J^T for the basis columns, then per-row data ---------
    for (int ci = 0; ci < ncon; ++ci) {
      chol_solve(w, w.Jz[ci], w.Wz[ci], nv);
      chol_solve(w, w.Jx[ci], w.Wx[ci], nv);
    }
    for (int k = 0; k < P.nlimdof; ++k) {
      for (int d = 0; d < nv; ++d) w.tmp[d] = (d == P.limdof[k]) ? 1.f : 0.f;
      chol_solve(w, w.tmp, w.Wl[k], nv);
    }
    for (int ci = 0; ci < ncon; ++ci) {
      float ann = 0.f, anx = 0.f, axx = 0.f, bq = 0.f, bx = 0.f;
      for (int d = 0; d < nv; ++d) {
        ann = ann + w.Jz[ci][d] * w.Wz[ci][d];
        anx = anx + w.Jz[ci][d] * w.Wx[ci][d];
        axx = axx + w.Jx[ci][d] * w.Wx[ci][d];
        bq = bq + w.Jz[ci][d] * w.qacc_s[d];
        bx = bx + w.Jx[ci][d] * w.qacc_s[d];
      }
      for (int r = 4 * ci; r < 4 * ci + 4; ++r) {
        const float mt = w.row_mt[r];
        for (int d = 0; d < NV; ++d) {
          w.jrow[r][d] = d < nv ? w.Jz[ci][d] + mt * w.Jx[ci][d] : 0.f;
          w.wrow[r][d] = d < nv ? w.Wz[ci][d] + mt * w.Wx[ci][d] : 0.f;
        }
        const float dsafe = fminf(fmaxf(w.row_dimp[r], 1e-4f), 0.999999f);
        w.rreg[r] = fmaxf((1.f - dsafe) / dsafe * P.con_diag[ci], 1e-15f);
        const float adiag = ann + 2.f * mt * anx + mt * mt * axx;
        w.Dr[r] = fmaxf(adiag + w.rreg[r], 1e-9f);
        w.bv[r] = bq + mt * bx - w.row_aref[r];
      }
    }
    for (int li = 0; li < P.nlim; ++li) {
      const int r = 4 * ncon + li;
      const int d0 = P.lim_dof[li];
      const float side = P.lim_side[li];
      const float* wl = w.Wl[P.lim_wcol[li]];
      for (int d = 0; d < NV; ++d) {
        w.jrow[r][d] = (d == d0) ? side : 0.f;
        w.wrow[r][d] = d < nv ? wl[d] * side : 0.f;
      }
      const float dsafe = fminf(fmaxf(w.row_dimp[r], 1e-4f), 0.999999f);
      w.rreg[r] = fmaxf((1.f - dsafe) / dsafe * P.lim_diag[li], 1e-15f);
      w.Dr[r] = fmaxf(wl[d0] + w.rreg[r], 1e-9f);
      w.bv[r] = side * w.qacc_s[d0] - w.row_aref[r];
    }

    // ---- projected Gauss-Seidel on u = M^-1 J^T f, u in registers -------
    float u[NV];
#pragma unroll
    for (int d = 0; d < NV; ++d) u[d] = 0.f;
    for (int r = 0; r < nrow; ++r) {
      const float fr = w.active[r] ? w.f[r] : 0.f;
      w.f[r] = fr;
#pragma unroll
      for (int d = 0; d < NV; ++d) u[d] = u[d] + fr * w.wrow[r][d];
    }
    for (int it = 0; it < iters; ++it) {
      for (int r = 0; r < nrow; ++r) {
        float ju = 0.f;
#pragma unroll
        for (int d = 0; d < NV; ++d) ju = ju + w.jrow[r][d] * u[d];
        const float f_old = w.f[r];
        const float res = ju + w.rreg[r] * f_old + w.bv[r];
        float fr = fmaxf(0.f, f_old - res / w.Dr[r]);
        fr = w.active[r] ? fr : 0.f;
        const float delta = fr - f_old;
#pragma unroll
        for (int d = 0; d < NV; ++d) u[d] = u[d] + delta * w.wrow[r][d];
        w.f[r] = fr;
      }
    }
#pragma unroll
    for (int d = 0; d < NV; ++d)
      if (d < nv) w.qacc[d] = w.qacc_s[d] + u[d];
    for (int r = 0; r < nrow; ++r)
      for (int d = 0; d < nv; ++d)
        w.con[d] = w.con[d] + w.f[r] * w.jrow[r][d];
  }

  if (damped) {
    // (M + h diag(damping)) qacc_d = qfrc + con
    for (int i = 0; i < nv; ++i) w.M[i][i] = w.M[i][i] + P.hdamping[i];
    cholesky(w, nv);
    for (int d = 0; d < nv; ++d) w.tmp[d] = w.qfrc[d] + w.con[d];
    chol_solve(w, w.tmp, w.qacc_d, nv);
  }
}

// The RK4 tableau of `_RK4_A` / `_RK4_B`, as float32 constants
#define RK4_SIXTH ((float)(1.0 / 6.0))
#define RK4_THIRD ((float)(1.0 / 3.0))

// One control step: `frame_skip` substeps of `_substep`, each Euler (one
// damped evaluation) or RK4 (four evaluations, the stage state
// q + h sum(a v), qd + h sum(a acc) with `sum` starting from 0 as
// Python's does); leaves q, qd, con_out, f, q_ev, qd_ev in `w`.
template <int NV>
__device__ void control_step(const PlanarConsts& P, Work& w, int iters) {
  const int nv = P.nv;
  const float h = P.h;
  for (int s = 0; s < P.frame_skip; ++s) {
    if (P.euler) {
      forward<NV>(P, w, iters, 1);
      for (int d = 0; d < nv; ++d) {
        const float qd_new = w.qd[d] + h * w.qacc_d[d];
        w.q_ev[d] = w.q[d];
        w.qd_ev[d] = w.qd[d];
        w.q[d] = w.q[d] + h * qd_new;
        w.qd[d] = qd_new;
        w.con_out[d] = w.con[d];
      }
      continue;
    }
    for (int d = 0; d < nv; ++d) {
      w.q0[d] = w.q[d];
      w.qd0[d] = w.qd[d];
    }
    forward<NV>(P, w, iters, 0);
    for (int d = 0; d < nv; ++d) {
      w.kv[0][d] = w.qd0[d];
      w.ka[0][d] = w.qacc[d];
      w.con_out[d] = w.con[d];
    }
    for (int i = 0; i < 3; ++i) {
      // _RK4_A[i] has one nonzero entry: 0.5, 0.5, 1.0 on stage i
      const float a = i < 2 ? 0.5f : 1.0f;
      for (int d = 0; d < nv; ++d) {
        const float dq = 0.f + a * w.kv[i][d];
        const float dv = 0.f + a * w.ka[i][d];
        w.q[d] = w.q0[d] + h * dq;
        w.qd[d] = w.qd0[d] + h * dv;
      }
      forward<NV>(P, w, iters, 0);
      for (int d = 0; d < nv; ++d) {
        w.kv[i + 1][d] = w.qd[d];
        w.ka[i + 1][d] = w.qacc[d];
      }
    }
    for (int d = 0; d < nv; ++d) {
      w.q_ev[d] = w.q[d];
      w.qd_ev[d] = w.qd[d];
      const float dq = 0.f + RK4_SIXTH * w.kv[0][d] + RK4_THIRD * w.kv[1][d] +
                       RK4_THIRD * w.kv[2][d] + RK4_SIXTH * w.kv[3][d];
      const float dv = 0.f + RK4_SIXTH * w.ka[0][d] + RK4_THIRD * w.ka[1][d] +
                       RK4_THIRD * w.ka[2][d] + RK4_SIXTH * w.ka[3][d];
      w.q[d] = w.q0[d] + h * dq;
      w.qd[d] = w.qd0[d] + h * dv;
    }
  }
}

template <int NV>
__global__ void planar_kernel(PlanarArgs a) {
  extern __shared__ __align__(16) float planar_smem[];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.B) return;
  Work& w = reinterpret_cast<Work*>(planar_smem)[threadIdx.x];
  const PlanarConsts& P = *a.P;
  const int B = a.B, nv = P.nv, nrow = P.nrow;
  for (int i = 0; i < nv; ++i) {
    w.q[i] = a.q[i * B + e];
    w.qd[i] = a.qd[i * B + e];
  }
  for (int u = 0; u < P.nu; ++u) w.ctrl[u] = a.ctrl[u * B + e];
  for (int r = 0; r < nrow; ++r) w.f[r] = a.f0[r * B + e];

  if (a.step) {
    control_step<NV>(P, w, a.iters);
    for (int d = 0; d < nv; ++d) {
      a.q_out[d * B + e] = w.q[d];
      a.qd_out[d * B + e] = w.qd[d];
      a.con_out[d * B + e] = w.con_out[d];
      a.qev_out[d * B + e] = w.q_ev[d];
      a.qdev_out[d * B + e] = w.qd_ev[d];
    }
  } else {
    forward<NV>(P, w, a.iters, a.damped);
    for (int d = 0; d < nv; ++d) {
      a.q_out[d * B + e] = w.qacc[d];
      a.con_out[d * B + e] = w.con[d];
      if (a.damped) a.qd_out[d * B + e] = w.qacc_d[d];
    }
  }
  for (int r = 0; r < nrow; ++r) a.f_out[r * B + e] = w.f[r];
}

extern "C" {

size_t planar_consts_size() { return sizeof(PlanarConsts); }

const char* planar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// consts: a PlanarConsts in device memory.  q, qd [nv, B], ctrl [nu, B],
// f0 [nrow, B] float32 on the device.  step = 1: one control step, outputs
// q, qd, qfrc_con, f, q_ev, qd_ev; step = 0: one evaluation, outputs qacc
// (in q_out), qfrc_con, f and, when damped, the damped qacc (in qd_out).
// nv and nrow are the model's, passed so that the launch can pick the
// kernel without reading device memory.  Launches on `stream`; returns the
// CUDA error, cudaErrorInvalidValue for what the kernel does not take.
int planar_launch(const void* consts, int nv, const float* q,
                  const float* qd, const float* ctrl, const float* f0,
                  float* q_out, float* qd_out, float* con_out, float* f_out,
                  float* qev_out, float* qdev_out, int B, int iters,
                  int step, int damped, void* stream) {
  if (B <= 0 || iters < 0 || nv < 1 || nv > MAX_DOF || (step != 0 &&
      step != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  PlanarArgs a;
  a.P = static_cast<const PlanarConsts*>(consts);
  a.q = q; a.qd = qd; a.ctrl = ctrl; a.f0 = f0;
  a.q_out = q_out; a.qd_out = qd_out; a.con_out = con_out; a.f_out = f_out;
  a.qev_out = qev_out; a.qdev_out = qdev_out;
  a.B = B; a.iters = iters; a.step = step; a.damped = damped;
  // spread the envs over the SMs: ceil(B / SMs) envs a block
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_block = (B + sms - 1) / sms;
  if (per_block > MAX_ENVS_PER_BLOCK) per_block = MAX_ENVS_PER_BLOCK;
  const int blocks = (B + per_block - 1) / per_block;
  const size_t smem = per_block * sizeof(Work);
  void* kernel = nv <= 6 ? reinterpret_cast<void*>(planar_kernel<6>)
                         : reinterpret_cast<void*>(planar_kernel<9>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(per_block), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
