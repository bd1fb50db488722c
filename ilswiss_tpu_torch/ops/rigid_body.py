"""Static rigid-body model description (counterpart: the model part of
ilswiss_tpu/ops/rigid_body.py, `Joint` and `RigidModel`, plus the solver
constants `_impedance` and `_kb`).

Plain numpy, copied from the JAX module so the port imports nothing from
it.  The general engine (`fk`, `forward`, `physics_step` and the PGS
rows), which the non-planar models need, is not ported yet; the planar
models step through ops/planar_dynamics.py.
"""

from __future__ import annotations

import numpy as np
import torch


class Joint:
    __slots__ = ("type", "body", "qadr", "dadr", "axis", "anchor")

    def __init__(self, j: dict):
        self.type = str(j["type"])
        self.body = int(j["body"])
        self.qadr = int(j["qadr"])
        self.dadr = int(j["dadr"])
        self.axis = np.asarray(j["axis"], np.float64)
        self.anchor = np.asarray(j["anchor"], np.float64)


class RigidModel:
    """Static constants of one articulated model (plain numpy; hashable
    by identity so it can close over jitted functions)."""

    def __init__(self, p: dict):
        self.nq = int(p["nq"])
        self.nv = int(p["nv"])
        self.nbody = int(p["nbody"])
        self.nu = int(p["nu"])
        self.timestep = float(p["timestep"])
        self.frame_skip = int(p["frame_skip"])
        self.integrator = str(p["integrator"])
        self.gravity = np.asarray(p["gravity"], np.float64)
        self.density = float(p.get("density", 0.0))
        self.viscosity = float(p.get("viscosity", 0.0))
        self.wind = np.asarray(p.get("wind", (0.0, 0.0, 0.0)), np.float64)

        self.body_parent = [int(b) for b in p["body_parent"]]
        self.body_pos = np.asarray(p["body_pos"], np.float64)
        self.body_mat = np.asarray(p["body_mat"], np.float64)
        self.body_ipos = np.asarray(p["body_ipos"], np.float64)
        self.body_imat = np.asarray(p["body_imat"], np.float64)
        self.body_mass = np.asarray(p["body_mass"], np.float64)
        self.body_inertia = np.asarray(p["body_inertia"], np.float64)
        self.body_rootid = [int(b) for b in p.get(
            "body_rootid", [0] * self.nbody)]

        self.joints = [Joint(j) for j in p["joints"]]
        self.dof_armature = np.asarray(p["dof_armature"], np.float64)
        self.dof_damping = np.asarray(p["dof_damping"], np.float64)
        self.qpos0 = np.asarray(p["qpos0"], np.float64)
        self.qpos_spring = np.asarray(p["qpos_spring"], np.float64)

        # per-dof spring stiffness + the qpos coordinate it reads
        # (scalar joints only; quaternion joints have zero stiffness,
        # asserted at extraction)
        self.dof_stiffness = np.zeros(self.nv, np.float64)
        self.dof_qadr = np.zeros(self.nv, np.int32)
        for jp, j in zip(p["joints"], self.joints):
            if j.type in ("slide", "hinge"):
                self.dof_stiffness[j.dadr] = float(jp["stiffness"])
                self.dof_qadr[j.dadr] = j.qadr

        self.act_gear = np.asarray(p["act_gear"], np.float64)
        self.act_dof = [int(d) for d in p["act_dof"]]
        self.ctrl_range = np.asarray(p["ctrl_range"], np.float64)
        self.sites = [(int(s["body"]), np.asarray(s["pos"], np.float64))
                      for s in p.get("sites", [])]

        # joints grouped by owning body, in declaration order (MuJoCo
        # applies a body's joint transforms sequentially)
        self.joints_of_body = {
            b: [j for j in self.joints if j.body == b]
            for b in range(self.nbody)
        }

        # --- contact candidates: capsule endpoints vs. ground plane ---
        self.floor_z = p["floor_z"]
        body_invw = np.asarray(p["body_invweight0"], np.float64)
        self.dof_invweight0 = np.asarray(p["dof_invweight0"], np.float64)
        self.contacts = []
        if self.floor_z is not None:
            for g in p["geoms"]:
                if not g["contact"]:
                    continue
                assert int(g.get("condim", 3)) == 3, (
                    "plane contacts in the benchmark family are condim 3"
                )
                mat = np.asarray(g["mat"], np.float64)
                pos = np.asarray(g["pos"], np.float64)
                half = float(g["half_len"])
                ends = [1.0, -1.0] if half > 0 else [0.0]
                mu = float(g["friction"])
                # MuJoCo efc_diagApprox for pyramidal contact rows:
                # 2μ²(1+μ²)·(invweight_b1 + invweight_b2); b2 = world = 0
                diag = 2.0 * mu * mu * (1.0 + mu * mu) * body_invw[g["body"]]
                for s in ends:
                    self.contacts.append(dict(
                        body=int(g["body"]),
                        lpos=pos + mat @ np.array([0.0, 0.0, s * half]),
                        # capsule axis in the BODY frame (geom z axis);
                        # MuJoCo's plane-capsule contact frame takes
                        # tangent 1 along the axis projected onto the
                        # plane (pose-dependent), tangent 2 = n × t1.
                        # None for spheres (frame ≡ world axes up to
                        # sign/swap, to which the pyramid is invariant).
                        axis=(mat[:, 2].copy() if half > 0 else None),
                        radius=float(g["radius"]),
                        friction=mu,
                        solref=np.asarray(g["solref"], np.float64),
                        solimp=np.asarray(g["solimp"], np.float64),
                        margin=float(g["margin"]),
                        diag_approx=diag,
                    ))

        # --- joint-limit constraints (two one-sided rows per limited
        # scalar joint)
        self.limits = []
        for ji, j in enumerate(self.joints):
            jp = p["joints"][ji]
            if jp["limited"]:
                assert j.type in ("slide", "hinge")
                rng = np.asarray(jp["range"], np.float64)
                for side, bound in ((+1.0, rng[0]), (-1.0, rng[1])):
                    self.limits.append(dict(
                        dof=j.dadr, qadr=j.qadr, side=side,
                        bound=float(bound),
                        solref=np.asarray(jp["solref"], np.float64),
                        solimp=np.asarray(jp["solimp"], np.float64),
                        diag_approx=float(self.dof_invweight0[j.dadr]),
                    ))

        self.ncon = len(self.contacts)
        # 4 pyramid-edge rows per contact (condim 3) + limit rows
        self.nrow = 4 * self.ncon + len(self.limits)
        # MuJoCo efc_diagApprox, row-aligned with _constraint_system
        self.row_diag = np.array(
            [c["diag_approx"] for c in self.contacts for _ in range(4)]
            + [l["diag_approx"] for l in self.limits], np.float64,
        )

        # equivalent-inertia-box half sizes for the fluid model
        # (mj box: r_i = sqrt(3/2 (I_j + I_k - I_i)/m), zero for
        # massless bodies)
        with np.errstate(divide="ignore", invalid="ignore"):
            I = self.body_inertia
            m_ = np.maximum(self.body_mass, 1e-12)
            self.fluid_box = np.sqrt(np.maximum(1.5 * np.stack([
                (I[:, 1] + I[:, 2] - I[:, 0]) / m_,
                (I[:, 2] + I[:, 0] - I[:, 1]) / m_,
                (I[:, 0] + I[:, 1] - I[:, 2]) / m_,
            ], -1), 0.0))
            self.fluid_box[self.body_mass <= 0] = 0.0
        self.has_fluid = (self.density != 0.0) or (self.viscosity != 0.0)



def _impedance(solimp, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp impedance d(pos): a polynomial spline from d0 to
    d_width over |pos| in [0, width], endpoints clamped into
    [1e-4, 0.9999]."""
    d0, dw, width, mid, power = [float(v) for v in solimp]
    d0 = min(max(d0, 1e-4), 0.9999)
    dw = min(max(dw, 1e-4), 0.9999)
    x = torch.clamp(torch.abs(pos) / max(width, 1e-12), 0.0, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    y = torch.where(x < mid, a * x ** power, 1.0 - b * (1.0 - x) ** power)
    return d0 + y * (dw - d0)


def _kb(solref, solimp):
    """Spring/damper stiffnesses from solref=(timeconst, dampratio):
    K = 1/(d_max^2 tau^2 zeta^2), B = 2/(d_max tau); aref = -B vel - K d pos."""
    tau, zeta = float(solref[0]), float(solref[1])
    clamp = lambda v: min(max(v, 1e-4), 0.9999)
    dmax = max(clamp(float(solimp[0])), clamp(float(solimp[1])))
    b = 2.0 / (dmax * tau)
    k = 1.0 / (dmax ** 2 * tau ** 2 * zeta ** 2)
    return k, b
