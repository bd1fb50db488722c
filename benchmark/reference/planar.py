"""Plain planar dynamics of the benchmark's reference (hopper's physics).

A frozen copy of the planar forward evaluation's plain math (`_forward_math`
over [rows, B] tensors: planar kinematics, mass matrix, Cholesky, bias,
contact and limit rows, the projected Gauss-Seidel sweeps) and of its
RK4 / Euler control step, as the port had them when this benchmark was
written.  The port runs kernel K1 in their place on a card.  It imports
nothing of the port.  Any float type, any device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from benchmark.reference.rigid_body import RigidModel, _impedance, _kb

class PlanarModel:
    """Static planar constants of a RigidModel, or raises ValueError."""

    def __init__(self, m: RigidModel):
        def _ang_of(R):
            if not (np.allclose(R[1], [0, 1, 0], atol=1e-12)
                    and np.allclose(R[:, 1], [0, 1, 0], atol=1e-12)):
                raise ValueError("body_mat is not a y-rotation")
            return math.atan2(R[0, 2], R[0, 0])

        if m.nq != m.nv:
            raise ValueError("quaternion joints are not planar")
        if m.has_fluid:
            raise ValueError("fluid model unsupported in planar path")
        if abs(m.gravity[0]) > 0 or abs(m.gravity[1]) > 0:
            raise ValueError("gravity must be -z")

        self.m = m
        self.nv, self.nbody = m.nv, m.nbody
        self.gz = float(m.gravity[2])
        self.timestep = m.timestep
        self.frame_skip = m.frame_skip
        self.integrator = m.integrator

        self.body_parent = list(m.body_parent)
        self.body_pos2 = []
        self.body_ang = []
        self.ipos2 = []
        for b in range(m.nbody):
            if abs(m.body_pos[b][1]) > 1e-12 or abs(m.body_ipos[b][1]) > 1e-12:
                raise ValueError("out-of-plane body offset")
            self.body_pos2.append((float(m.body_pos[b][0]),
                                   float(m.body_pos[b][2])))
            self.body_ang.append(_ang_of(m.body_mat[b]))
            self.ipos2.append((float(m.body_ipos[b][0]),
                               float(m.body_ipos[b][2])))
        self.mass = [float(v) for v in m.body_mass]
        # world Iyy is invariant under the body's y-rotation, and the
        # planar M and bias read only that component
        self.iyy = [
            float((m.body_imat[b] @ np.diag(m.body_inertia[b])
                   @ m.body_imat[b].T)[1, 1])
            for b in range(m.nbody)
        ]

        # joints grouped by body in application order; slides must precede
        # any rotation so their world axis is constant
        self.joints = []
        seen_hinge = False
        for b in range(m.nbody):
            js = []
            for j in m.joints_of_body.get(b, []):
                if j.type == "slide":
                    if seen_hinge:
                        raise ValueError("slide below a hinge")
                    if abs(j.axis[1]) > 1e-12:
                        raise ValueError("out-of-plane slide axis")
                    js.append(dict(kind="slide", dadr=j.dadr, qadr=j.qadr,
                                   ax=float(j.axis[0]), az=float(j.axis[2]),
                                   q0=float(m.qpos0[j.qadr])))
                elif j.type == "hinge":
                    if abs(j.axis[0]) > 1e-12 or abs(j.axis[2]) > 1e-12:
                        raise ValueError("non-y hinge axis")
                    if abs(j.anchor[1]) > 1e-12:
                        raise ValueError("out-of-plane hinge anchor")
                    seen_hinge = True
                    js.append(dict(kind="hinge", dadr=j.dadr, qadr=j.qadr,
                                   sign=float(np.sign(j.axis[1])),
                                   anx=float(j.anchor[0]),
                                   anz=float(j.anchor[2]),
                                   q0=float(m.qpos0[j.qadr])))
                else:
                    raise ValueError(f"joint type {j.type}")
            self.joints.append(js)

        self.armature = [float(v) for v in m.dof_armature]
        self.damping = [float(v) for v in m.dof_damping]
        self.stiffness = [float(v) for v in m.dof_stiffness]
        self.dof_qadr = [int(v) for v in m.dof_qadr]
        self.qpos_spring = [float(v) for v in m.qpos_spring]

        self.act_dof = [int(d) for d in m.act_dof]
        self.act_gear = [float(g) for g in m.act_gear]
        self.ctrl_lo = [float(v) for v in m.ctrl_range[:, 0]]
        self.ctrl_hi = [float(v) for v in m.ctrl_range[:, 1]]

        # contact-free planar models (inverted pendulum) have no floor
        self.floor_z = 0.0 if m.floor_z is None else float(m.floor_z)
        self.contacts = []
        for c in m.contacts:
            if abs(c["lpos"][1]) > 1e-9:
                raise ValueError("out-of-plane contact")
            k, bb = _kb(c["solref"], c["solimp"])
            self.contacts.append(dict(
                body=int(c["body"]),
                lx=float(c["lpos"][0]), lz=float(c["lpos"][2]),
                axis=(None if c["axis"] is None else
                      (float(c["axis"][0]), float(c["axis"][2]))),
                radius=float(c["radius"]), mu=float(c["friction"]),
                margin=float(c["margin"]), k=float(k), b=float(bb),
                solimp=[float(v) for v in c["solimp"]],
                diag=float(c["diag_approx"]),
            ))
        self.limits = []
        for lim in m.limits:
            k, bb = _kb(lim["solref"], lim["solimp"])
            self.limits.append(dict(
                dof=int(lim["dof"]), qadr=int(lim["qadr"]),
                side=float(lim["side"]), bound=float(lim["bound"]),
                k=float(k), b=float(bb),
                solimp=[float(v) for v in lim["solimp"]],
                diag=float(lim["diag_approx"]),
            ))
        self.ncon = len(self.contacts)
        self.nrow = 4 * self.ncon + len(self.limits)
        assert self.nrow == m.nrow

        # chain structure: the dofs above and at each body (chain order),
        # the hinge dofs among them, and each dof's kind and constants
        self.dof_kind = [None] * self.nv
        self.dof_sign = [0.0] * self.nv
        self.dof_axis = [(0.0, 0.0)] * self.nv
        self.dofs_of = [[] for _ in range(self.nbody)]
        self.hinges_of = [[] for _ in range(self.nbody)]
        for b in range(1, self.nbody):
            par = self.body_parent[b]
            self.dofs_of[b] = list(self.dofs_of[par])
            self.hinges_of[b] = list(self.hinges_of[par])
            for j in self.joints[b]:
                d = j["dadr"]
                self.dofs_of[b].append(d)
                self.dof_kind[d] = j["kind"]
                if j["kind"] == "slide":
                    self.dof_axis[d] = (j["ax"], j["az"])
                else:
                    self.dof_sign[d] = j["sign"]
                    self.hinges_of[b].append(d)
        # the dofs above hinge d: its anchor moves with them
        self.dofs_above = [None] * self.nv
        for b in range(1, self.nbody):
            for d in self.hinges_of[b]:
                if self.dofs_above[d] is None:
                    ds = self.dofs_of[b]
                    self.dofs_above[d] = ds[:ds.index(d)]
        self.limit_dofs = sorted({lim["dof"] for lim in self.limits})


# --------------------------------------------------------------------------


def _chol(M, nv):
    """Unrolled Cholesky of M (nested lists of [B]); returns (L, 1/L_ii)
    with the same 1e-12 floor under the square root as the JAX module."""
    L = [[None] * nv for _ in range(nv)]
    inv = [None] * nv
    for i in range(nv):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                lii = torch.sqrt(torch.clamp_min(s, 1e-12))
                L[i][i] = lii
                inv[i] = 1.0 / lii
            else:
                L[i][j] = s * inv[j]
    return L, inv


def _chol_solve(L, inv, rhs, nv):
    """Solve M x = rhs for rhs of shape [nv, ..., B]; x like rhs."""
    y = [None] * nv
    for i in range(nv):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv[i]
    x = [None] * nv
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            s = s - L[k][i] * x[k]
        x[i] = s * inv[i]
    return torch.stack(x)


def _forward_math(pm: PlanarModel, q, qd, ctrl, f0, iters: int,
                  h_damp: float | None):
    """One constrained forward evaluation, the plain PyTorch version.

    q, qd [nv, B], ctrl [nu, B], f0 [nrow, B].  Returns (qacc [nv, B],
    qfrc_con [nv, B], f [nrow, B]) and, when `h_damp` is given, the
    implicit-damping acceleration (M + h diag(damping))^-1 (qfrc + con)
    as a fourth output."""
    nv, nb = pm.nv, pm.nbody
    zero = q[0] * 0.0

    # ---- FK: body angles and origins, hinge world anchors -------------
    ang = [zero] * nb
    px = [zero] * nb
    pz = [zero] * nb
    cos_b = [zero + 1.0] * nb
    sin_b = [zero] * nb
    anc_x = [None] * nv
    anc_z = [None] * nv
    for b in range(1, nb):
        par = pm.body_parent[b]
        a = ang[par] + pm.body_ang[b]
        c_p, s_p = cos_b[par], sin_b[par]
        bx, bz = pm.body_pos2[b]
        x = px[par] + c_p * bx + s_p * bz
        z = pz[par] - s_p * bx + c_p * bz
        c_a, s_a = torch.cos(a), torch.sin(a)
        for j in pm.joints[b]:
            if j["kind"] == "slide":
                qj = q[j["qadr"]] - j["q0"]
                x = x + j["ax"] * qj
                z = z + j["az"] * qj
            else:
                qj = (q[j["qadr"]] - j["q0"]) * j["sign"]
                awx = x + c_a * j["anx"] + s_a * j["anz"]
                awz = z - s_a * j["anx"] + c_a * j["anz"]
                a = a + qj
                c_a, s_a = torch.cos(a), torch.sin(a)
                x = awx - (c_a * j["anx"] + s_a * j["anz"])
                z = awz - (-s_a * j["anx"] + c_a * j["anz"])
                anc_x[j["dadr"]], anc_z[j["dadr"]] = awx, awz
        ang[b], px[b], pz[b] = a, x, z
        cos_b[b], sin_b[b] = c_a, s_a

    def jac_point(ptx, ptz, dofs):
        """(Jx, Jz) [nv, B] of a point rigidly attached below `dofs`."""
        jx = [zero] * nv
        jz = [zero] * nv
        for d in dofs:
            if pm.dof_kind[d] == "slide":
                jx[d] = zero + pm.dof_axis[d][0]
                jz[d] = zero + pm.dof_axis[d][1]
            else:
                s = pm.dof_sign[d]
                jx[d] = s * (ptz - anc_z[d])
                jz[d] = -(s * (ptx - anc_x[d]))
        return torch.stack(jx), torch.stack(jz)

    def vel_of(jx, jz, dofs):
        vx, vz = zero, zero
        for d in dofs:
            vx = vx + qd[d] * jx[d]
            vz = vz + qd[d] * jz[d]
        return vx, vz

    # ---- CoM Jacobians, mass matrix, Cholesky --------------------------
    Jc = [None] * nb
    M = zero.new_zeros((nv, nv) + zero.shape)
    for b in range(1, nb):
        ix, iz = pm.ipos2[b]
        cx = px[b] + cos_b[b] * ix + sin_b[b] * iz
        cz = pz[b] - sin_b[b] * ix + cos_b[b] * iz
        jx, jz = jac_point(cx, cz, pm.dofs_of[b])
        Jc[b] = (jx, jz)
        w = torch.tensor([pm.dof_sign[d] if d in pm.hinges_of[b] else 0.0
                          for d in range(nv)], dtype=q.dtype,
                         device=q.device)[:, None]
        M = M + (pm.mass[b] * (jx[:, None] * jx[None, :]
                               + jz[:, None] * jz[None, :])
                 + pm.iyy[b] * (w[:, None] * w[None, :]))
    M = M + torch.diag(torch.tensor(pm.armature, dtype=q.dtype,
                                    device=q.device))[:, :, None]
    L, inv = _chol(M, nv)

    # ---- bias (Coriolis + gravity) and smooth forces --------------------
    anc_vel = {}
    for d in range(nv):
        if pm.dof_kind[d] == "hinge":
            up = pm.dofs_above[d]
            ax_, az_ = jac_point(anc_x[d], anc_z[d], up)
            anc_vel[d] = vel_of(ax_, az_, up)
    bias = [zero] * nv
    for b in range(1, nb):
        jx, jz = Jc[b]
        vbx, vbz = vel_of(jx, jz, pm.dofs_of[b])
        ax_, az_ = zero, zero
        for d in pm.hinges_of[b]:
            s = pm.dof_sign[d]
            avx, avz = anc_vel[d]
            ax_ = ax_ + qd[d] * (s * (vbz - avz))
            az_ = az_ + qd[d] * (-(s * (vbx - avx)))
        fx = pm.mass[b] * ax_
        fz = pm.mass[b] * (az_ - pm.gz)
        for d in pm.dofs_of[b]:
            bias[d] = bias[d] + jx[d] * fx + jz[d] * fz

    qfrc = [zero] * nv
    for u, d in enumerate(pm.act_dof):
        qfrc[d] = qfrc[d] + pm.act_gear[u] * torch.clamp(
            ctrl[u], pm.ctrl_lo[u], pm.ctrl_hi[u])
    for d in range(nv):
        p = qfrc[d] - pm.damping[d] * qd[d] - bias[d]
        if pm.stiffness[d] != 0.0:
            p = p - pm.stiffness[d] * (q[pm.dof_qadr[d]] - pm.qpos_spring[d])
        qfrc[d] = p
    qfrc = torch.stack(qfrc)
    qacc_s = _chol_solve(L, inv, qfrc, nv)

    def damped_solve(rhs):
        Mh = M + torch.diag(torch.tensor(
            [h_damp * v for v in pm.damping], dtype=q.dtype,
            device=q.device))[:, :, None]
        Lh, invh = _chol(Mh, nv)
        return _chol_solve(Lh, invh, rhs, nv)

    if pm.nrow == 0:
        out = (qacc_s, torch.zeros_like(qacc_s), f0[:0])
        return out + (damped_solve(qfrc),) if h_damp is not None else out

    # ---- constraint rows (the engine's order) ---------------------------
    # per row: J row, W row = M^-1 J^T, Rreg, D, b, active
    row_mt, row_aref, row_dimp, row_active, row_diag = [], [], [], [], []
    cols = []            # right-hand sides of the W solve
    basis = []           # per contact: (Jx, Jz, dofs)
    for c in pm.contacts:
        b = c["body"]
        ccx = px[b] + cos_b[b] * c["lx"] + sin_b[b] * c["lz"]
        ccz = pz[b] - sin_b[b] * c["lx"] + cos_b[b] * c["lz"]
        gap = ccz - c["radius"] - pm.floor_z
        xcz = ccz - (c["radius"] + 0.5 * gap)
        jx, jz = jac_point(ccx, xcz, pm.dofs_of[b])
        vx, vz = vel_of(jx, jz, pm.dofs_of[b])
        pos = gap - c["margin"]
        active = pos < 0.0
        dimp = _impedance(c["solimp"], pos)
        # tangent frame: exactly one of t1, t2 lies in the plane
        if c["axis"] is None:
            t1x, t2x = zero, zero - 1.0
        else:
            awx = cos_b[b] * c["axis"][0] + sin_b[b] * c["axis"][1]
            lax = torch.abs(awx)
            inpl = lax > 1e-8
            t1x = torch.where(inpl, -awx / torch.clamp_min(lax, 1e-8), zero)
            t2x = torch.where(inpl, zero, zero - 1.0)
        basis.append((jx, jz, pm.dofs_of[b]))
        cols += [jz, jx]
        for tx in (t1x, t2x):
            vt = tx * vx
            for s in (1.0, -1.0):
                smu = s * c["mu"]
                row_mt.append(smu * tx)
                row_aref.append(-c["b"] * (vz + smu * vt)
                                - c["k"] * dimp * pos)
                row_dimp.append(dimp)
                row_active.append(active)
                row_diag.append(c["diag"])
    for d in pm.limit_dofs:
        e = torch.zeros_like(qacc_s)
        e[d] = 1.0
        cols.append(e)
    for lim in pm.limits:
        d = lim["dof"]
        pos = lim["side"] * (q[lim["qadr"]] - lim["bound"])
        dimp = _impedance(lim["solimp"], pos)
        row_aref.append(-lim["b"] * lim["side"] * qd[d]
                        - lim["k"] * dimp * pos)
        row_dimp.append(dimp)
        row_active.append(pos < 0.0)
        row_diag.append(lim["diag"])

    # one solve for every basis column: [nv, ncol, B]
    W = _chol_solve(L, inv, torch.stack(cols, 1), nv)
    jrows, wrows, adiag, bvec = [], [], [], []
    for ci, (jx, jz, dofs) in enumerate(basis):
        wz, wx = W[:, 2 * ci], W[:, 2 * ci + 1]
        ann = (jz * wz).sum(0)
        anx = (jz * wx).sum(0)
        axx = (jx * wx).sum(0)
        bq = (jz * qacc_s).sum(0)
        bx = (jx * qacc_s).sum(0)
        for r in range(4 * ci, 4 * ci + 4):
            mt = row_mt[r]
            jrows.append(jz + mt * jx)
            wrows.append(wz + mt * wx)
            adiag.append(ann + 2.0 * mt * anx + mt * mt * axx)
            bvec.append(bq + mt * bx - row_aref[r])
    for li, lim in enumerate(pm.limits):
        d, side = lim["dof"], lim["side"]
        w = W[:, 2 * pm.ncon + pm.limit_dofs.index(d)]
        e = torch.zeros_like(qacc_s)
        e[d] = side
        jrows.append(e)
        wrows.append(w * side)
        adiag.append(w[d])
        bvec.append(side * qacc_s[d] - row_aref[4 * pm.ncon + li])

    rreg, dd = [], []
    for r in range(pm.nrow):
        dsafe = torch.clamp(row_dimp[r], 1e-4, 1.0 - 1e-6)
        rr = torch.clamp_min((1.0 - dsafe) / dsafe * row_diag[r], 1e-15)
        rreg.append(rr)
        dd.append(torch.clamp_min(adiag[r] + rr, 1e-9))

    # ---- projected Gauss-Seidel on u = M^-1 J^T f -----------------------
    f = [torch.where(row_active[r], f0[r], zero) for r in range(pm.nrow)]
    u = torch.zeros_like(qacc_s)
    for r in range(pm.nrow):
        u = u + f[r] * wrows[r]
    for _ in range(iters):
        for r in range(pm.nrow):
            ju = (jrows[r] * u).sum(0)
            res = ju + rreg[r] * f[r] + bvec[r]
            fr = torch.clamp_min(f[r] - res / dd[r], 0.0)
            fr = torch.where(row_active[r], fr, zero)
            u = u + (fr - f[r]) * wrows[r]
            f[r] = fr

    qacc = qacc_s + u
    con = torch.zeros_like(qacc_s)
    for r in range(pm.nrow):
        con = con + f[r] * jrows[r]
    out = (qacc, con, torch.stack(f))
    if h_damp is not None:
        return out + (damped_solve(qfrc + con),)
    return out


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)

Forward = Callable[..., tuple]


def _substep(pm: PlanarModel, fwd: Forward, q, qd, ctrl, f0):
    """One integrator substep (the engine's _euler_step / _rk4_step)."""
    h = pm.timestep
    if pm.integrator == "euler":
        _, con, f, qacc_d = fwd(q, qd, ctrl, f0, True)
        qd_new = qd + h * qacc_d
        return q + h * qd_new, qd_new, con, f, (q, qd)
    qacc0, con, f = fwd(q, qd, ctrl, f0, False)
    vels = [qd]
    accs = [qacc0]
    for i in range(3):
        dq = sum(a * v for a, v in zip(_RK4_A[i], vels) if a != 0.0)
        dv = sum(a * acc for a, acc in zip(_RK4_A[i], accs) if a != 0.0)
        qi = q + h * dq
        vi = qd + h * dv
        qacci, _, f = fwd(qi, vi, ctrl, f, False)
        vels.append(vi)
        accs.append(qacci)
    dq = sum(b * v for b, v in zip(_RK4_B, vels))
    dv = sum(b * acc for b, acc in zip(_RK4_B, accs))
    return q + h * dq, qd + h * dv, con, f, (qi, vi)


def _control_step(pm: PlanarModel, fwd: Forward, q, qd, ctrl, f0):
    """`frame_skip` substeps; returns (q, qd, qfrc_con of the last
    substep, row forces, state of the last forward evaluation)."""
    carry = (q, qd, torch.zeros_like(qd), f0, (q, qd))
    for _ in range(pm.frame_skip):
        q_, qd_, _, f_, _ = carry
        carry = _substep(pm, fwd, q_, qd_, ctrl, f_)
    return carry


def planar_control_step(pm: PlanarModel, q, qd, ctrl, f0, iters: int):
    """One control step over [B, .] tensors: returns (q, qd, qfrc_con, f,
    (q_ev, qd_ev)), each [B, .]."""
    def fwd(q_, qd_, c_, f_, damped):
        return _forward_math(pm, q_, qd_, c_, f_, iters,
                             pm.timestep if damped else None)

    def rows(x):
        return x.t().contiguous()

    q_new, qd_new, con, f, (q_ev, qd_ev) = _control_step(
        pm, fwd, rows(q), rows(qd), rows(ctrl), rows(f0))
    return (q_new.t(), qd_new.t(), con.t(), f.t(), (q_ev.t(), qd_ev.t()))
