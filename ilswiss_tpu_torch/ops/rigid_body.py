"""Generalized-coordinate rigid-body dynamics over a batch of envs
(counterpart: ilswiss_tpu/ops/rigid_body.py).

The static model (`Joint`, `RigidModel`, the solver constants `_impedance`
and `_kb`) is plain numpy, copied from the JAX module so the port imports
nothing from it.  The engine below it computes what the JAX engine
computes (the same conventions, formulas, row order and constants), with
two differences of form:

  * the batch dimension is written out: every function takes and returns
    tensors with a leading `[B]`, float32 or float64, on any device;
  * the velocity Jacobians are analytic instead of `jax.jvp`/`jacfwd`
    through `fk`.  Forward kinematics records, for every velocity
    coordinate d, its world axis a_d and the world point o_d it acts
    through: a hinge turns everything below it about a_d through its
    anchor, a slide moves it along a_d, a free joint's linear coordinates
    move it along the world axes and its angular coordinates (body-local
    angular velocity) turn it about the body frame's columns through the
    body origin.  A point x carried by body b then has the velocity column
    a_d x (x - o_d) (hinge, free angular) or a_d (slide, free linear) for
    every d at or above b, and zero otherwise.  The velocity-product
    accelerations (the JAX engine's second `jvp`) follow from the same
    quantities: an axis turns with the angular velocity of the frame it is
    fixed in, da_d/dt = w_d x a_d, and an anchor moves with that frame.
    The contact point's body-local offset is held fixed under this
    differentiation, as the JAX engine's `stop_gradient` holds it.

The Cholesky factor, W = M^-1 J^T and the row set-up are PyTorch calls; the
projected Gauss-Seidel sweeps go through `ops/pgs.py` (kernel K4 on a CUDA
tensor).  Planar models step through ops/planar_dynamics.py instead.

The stand-alone functions `kinetic_energy`, `potential_energy`,
`body_jacobians`, `mass_matrix`, `bias_forces`, `fluid_forces`,
`passive_forces`, `contact_gaps`, `constraint_forces` and `smooth_force`
(which only the JAX package's tests call) each build the shared
linearization and read what they need of it, as `forward` does; nothing
in the port's runs calls them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ilswiss_tpu_torch.ops.pgs import pgs_solve
from ilswiss_tpu_torch.utils.profiling import span


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
    by identity).  `consts(dtype, device)` gives the tensors the engine
    needs, made once per dtype and device."""

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
        self._consts: dict = {}

    def consts(self, dtype: torch.dtype, device) -> "_Consts":
        key = (dtype, torch.device(device))
        if key not in self._consts:
            self._consts[key] = _Consts(self, dtype, key[1])
        return self._consts[key]



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


# --------------------------------------------------------------------------
# Tensors of one model on one device
# --------------------------------------------------------------------------


def _runs(pairs):
    """Group consecutive (qadr, dadr) pairs into (qadr, dadr, length)."""
    out = []
    for qa, da in pairs:
        if out and out[-1][0] + out[-1][2] == qa \
                and out[-1][1] + out[-1][2] == da:
            out[-1][2] += 1
        else:
            out.append([qa, da, 1])
    return [tuple(r) for r in out]


class _Consts:
    """What the engine reads of a RigidModel, as tensors of one dtype on
    one device, plus the static structure of the kinematic tree."""

    def __init__(self, m: "RigidModel", dtype, device):
        def T(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)

        def I(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        nv, nb = m.nv, m.nbody
        # [body_mat | body_pos] per body: one product with the parent's
        # rotation gives the child's frame before its joints
        self.body_frame = T(np.concatenate(
            [m.body_mat, m.body_pos[:, :, None]], axis=2))
        self.ipos = T(m.body_ipos)
        self.imat = T(m.body_imat)
        self.mass = T(m.body_mass)
        self.total_mass = float(np.sum(m.body_mass))
        self.inertia = T(m.body_inertia)
        self.gravity = T(m.gravity)
        self.armature_diag = T(np.diag(m.dof_armature))
        self.damping = T(m.dof_damping)
        self.damping_diag = T(np.diag(m.dof_damping))
        self.stiffness = T(m.dof_stiffness)
        self.dof_qadr = I(m.dof_qadr)
        self.spring = T(m.qpos_spring[m.dof_qadr])
        self.has_spring = bool(np.any(m.dof_stiffness != 0.0))
        self.eye3 = T(np.eye(3))

        # actuation: qfrc = clip(ctrl) @ gear_map
        gear_map = np.zeros((m.nu, nv))
        for u, d in enumerate(m.act_dof):
            gear_map[u, d] += m.act_gear[u]
        self.gear_map = T(gear_map)
        self.ctrl_lo, self.ctrl_hi = T(m.ctrl_range[:, 0]), T(m.ctrl_range[:, 1])

        # hinges: Rodrigues terms K and K^2 of every hinge axis, and per
        # hinge [axis | anchor] for one product with the body rotation
        hinges = [j for j in m.joints if j.type == "hinge"]
        self.hinge_index = {id(j): i for i, j in enumerate(hinges)}
        self.hinge_qadr = I([j.qadr for j in hinges])
        K = np.zeros((len(hinges), 3, 3))
        for i, j in enumerate(hinges):
            a = j.axis
            K[i] = [[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                    [-a[1], a[0], 0.0]]
        self.hinge_K, self.hinge_K2 = T(K), T(K @ K)
        self.hinge_q0 = T([m.qpos0[j.qadr] for j in hinges])
        self.hinge_axis_anchor = T(np.stack(
            [np.stack([j.axis, j.anchor], axis=1) for j in hinges])
            if hinges else np.zeros((0, 3, 2)))
        self.slide_axis = {id(j): T(j.axis) for j in m.joints
                           if j.type == "slide"}

        # per velocity coordinate: does it turn (hinge, free angular) or
        # shift (slide, free linear) what hangs below it
        rot, lin = np.zeros(nv), np.zeros(nv)
        dof_body = np.zeros(nv, np.int64)
        free_of = {}
        for j in m.joints:
            if j.type == "free":
                lin[j.dadr:j.dadr + 3] = 1.0
                rot[j.dadr + 3:j.dadr + 6] = 1.0
                dof_body[j.dadr:j.dadr + 6] = j.body
                for k in range(6):
                    free_of[j.dadr + k] = j
            else:
                (rot if j.type == "hinge" else lin)[j.dadr] = 1.0
                dof_body[j.dadr] = j.body
        self.rot, self.lin = T(rot)[:, None], T(lin)[:, None]

        def ancestors(b):          # b and every body above it
            out = []
            while b != 0:
                out.append(b)
                b = m.body_parent[b]
            return out

        # anc[b, d]: coordinate d moves body b
        anc = np.zeros((nb, nv))
        for b in range(nb):
            for d in range(nv):
                anc[b, d] = float(dof_body[d] in ancestors(b))
        self.anc = T(anc)
        # frame_rot[d, e]: e turns the frame that axis d is fixed in;
        # frame_pt[d, e]: e moves the point o_d.  A scalar joint's axis and
        # anchor are fixed in the frame its predecessors leave: every
        # coordinate of the bodies above, and the earlier joints of its own
        # body.  A free joint's angular axes are the body frame's columns,
        # which all three angular coordinates turn; its origin moves with
        # its linear coordinates; its linear axes are the world's.
        frame_rot, frame_pt = np.zeros((nv, nv)), np.zeros((nv, nv))
        for d in range(nv):
            if d in free_of:
                j = free_of[d]
                if d >= j.dadr + 3:
                    frame_rot[d, j.dadr + 3:j.dadr + 6] = 1.0
                    frame_pt[d, j.dadr:j.dadr + 3] = 1.0
                continue
            above = ancestors(m.body_parent[dof_body[d]])
            for e in range(nv):
                if dof_body[e] in above or (dof_body[e] == dof_body[d]
                                            and e < d):
                    frame_rot[d, e] = frame_pt[d, e] = 1.0
        self.frame_rot, self.frame_pt = T(frame_rot), T(frame_pt)[:, :, None]

        # runs of scalar coordinates for integrate_pos / coord_rates
        self.scalar_runs = _runs([(j.qadr, j.dadr) for j in m.joints
                                  if j.type != "free"])

        # contacts
        if m.ncon:
            cs = m.contacts
            self.con_body = I([c["body"] for c in cs])
            self.con_lpos = T([c["lpos"] for c in cs])
            self.con_radius = T([c["radius"] for c in cs])
            self.con_has_axis = torch.as_tensor(
                [c["axis"] is not None for c in cs], device=device)
            self.con_axis = T([c["axis"] if c["axis"] is not None
                               else np.zeros(3) for c in cs])
            self.con_mu = T([c["friction"] for c in cs])
            self.con_margin = T([c["margin"] for c in cs])
            self.con_anc = self.anc[self.con_body]
            # body_of_con[b, c]: contact c acts on body b
            onto = np.zeros((nb, m.ncon))
            for i, c in enumerate(cs):
                onto[c["body"], i] = 1.0
            self.con_onto_body = T(onto)
        self.ey = T([0.0, 1.0, 0.0])
        self.ez = T([0.0, 0.0, 1.0])

        # limits
        lims = m.limits
        if lims:
            self.lim_qadr = I([l["qadr"] for l in lims])
            self.lim_dof = I([l["dof"] for l in lims])
            self.lim_side = T([l["side"] for l in lims])
            self.lim_bound = T([l["bound"] for l in lims])
            E = np.zeros((len(lims), nv))
            for i, l in enumerate(lims):
                E[i, l["dof"]] = l["side"]
            self.lim_rows = T(E)

        # per row, in row order (4 per contact, then the limits): the
        # solref / solimp constants of `_kb` and `_impedance`
        specs = [(c["solref"], c["solimp"]) for c in m.contacts
                 for _ in range(4)] + [(l["solref"], l["solimp"])
                                       for l in lims]
        kb = np.array([_kb(sr, si) for sr, si in specs]).reshape(-1, 2)
        self.row_k, self.row_b = T(kb[:, 0]), T(kb[:, 1])
        clamp = lambda v: min(max(float(v), 1e-4), 0.9999)
        imp = np.array([[clamp(si[0]), clamp(si[1]),
                         1.0 / max(float(si[2]), 1e-12), float(si[3]),
                         float(si[4])] for _, si in specs]).reshape(-1, 5)
        self.imp_d0, self.imp_dw = T(imp[:, 0]), T(imp[:, 1])
        self.imp_inv_width, self.imp_mid = T(imp[:, 2]), T(imp[:, 3])
        self.imp_power = T(imp[:, 4])
        self.imp_a = T(1.0 / imp[:, 3] ** (imp[:, 4] - 1.0))
        self.imp_b = T(1.0 / (1.0 - imp[:, 3]) ** (imp[:, 4] - 1.0))
        self.row_diag = T(m.row_diag)

        self.fluid_box = T(m.fluid_box)


def _impedance_rows(c: _Consts, pos: torch.Tensor) -> torch.Tensor:
    """`_impedance` for every row at once: pos [B, nrow]."""
    x = torch.clamp(torch.abs(pos) * c.imp_inv_width, 0.0, 1.0)
    y = torch.where(x < c.imp_mid, c.imp_a * x ** c.imp_power,
                    1.0 - c.imp_b * (1.0 - x) ** c.imp_power)
    return c.imp_d0 + y * (c.imp_dw - c.imp_d0)


# --------------------------------------------------------------------------
# Quaternion helpers (w, x, y, z, the MuJoCo convention), batched on the
# leading dimensions
# --------------------------------------------------------------------------


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_exp(v):
    """exp map: rotation vector [..., 3] -> unit quaternion [..., 4]
    (angle = |v|)."""
    angle = torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-32)
    half = 0.5 * angle
    return torch.cat([torch.cos(half), torch.sin(half) / angle * v], -1)


def quat_to_mat(q):
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


# --------------------------------------------------------------------------
# Kinematics
# --------------------------------------------------------------------------


def _kinematics(m: RigidModel, q):
    """Forward kinematics with the velocity geometry: world rotation R
    [B, nb, 3, 3] and origin p [B, nb, 3] of every body frame, and per
    velocity coordinate its world axis A [B, nv, 3] and the world point O
    [B, nv, 3] it acts through (zero where the coordinate only shifts).

    Joint transforms follow mj_kinematics: a free joint sets the frame from
    qpos (quaternion normalized); within a body, each scalar joint's axis
    and anchor are read in the frame accumulated so far."""
    c = m.consts(q.dtype, q.device)
    B = q.shape[0]
    zeros3 = q.new_zeros((B, 3))
    Rs = [c.eye3.expand(B, 3, 3)]
    ps = [zeros3]
    A = [None] * m.nv
    O = [zeros3] * m.nv
    if c.hinge_qadr.numel():
        ang = (q[:, c.hinge_qadr] - c.hinge_q0)[:, :, None, None]
        hinge_rot = (c.eye3 + torch.sin(ang) * c.hinge_K
                     + (1.0 - torch.cos(ang)) * c.hinge_K2)
    for b in range(1, m.nbody):
        par = m.body_parent[b]
        frame = torch.matmul(Rs[par], c.body_frame[b])        # [B, 3, 4]
        R, p = frame[:, :, :3], ps[par] + frame[:, :, 3]
        for j in m.joints_of_body[b]:
            if j.type == "free":
                p = q[:, j.qadr:j.qadr + 3]
                quat = q[:, j.qadr + 3:j.qadr + 7]
                quat = quat / torch.sqrt(
                    torch.sum(quat * quat, -1, keepdim=True))
                R = quat_to_mat(quat)
                for k in range(3):
                    A[j.dadr + k] = c.eye3[k].expand(B, 3)
                    A[j.dadr + 3 + k] = R[:, :, k]
                    O[j.dadr + 3 + k] = p
            elif j.type == "slide":
                aw = torch.matmul(R, c.slide_axis[id(j)])
                p = p + aw * (q[:, j.qadr] - m.qpos0[j.qadr])[:, None]
                A[j.dadr] = aw
            else:  # hinge
                h = c.hinge_index[id(j)]
                aa = torch.matmul(R, c.hinge_axis_anchor[h])  # [B, 3, 2]
                anchor_w = p + aa[:, :, 1]
                R = torch.matmul(R, hinge_rot[:, h])
                p = anchor_w - torch.matmul(R, c.hinge_axis_anchor[h, :, 1])
                A[j.dadr] = aa[:, :, 0]
                O[j.dadr] = anchor_w
        Rs.append(R)
        ps.append(p)
    return (torch.stack(Rs, 1), torch.stack(ps, 1),
            torch.stack(A, 1), torch.stack(O, 1))


def fk(m: RigidModel, q):
    """World rotation and origin of every body frame: (R [B, nb, 3, 3],
    p [B, nb, 3])."""
    R, p, _, _ = _kinematics(m, q)
    return R, p


def site_positions(m: RigidModel, q):
    """World position of every site [B, nsite, 3] (the double pendulum's
    tip)."""
    R, p = fk(m, q)
    return torch.stack([
        p[:, b] + torch.matmul(R[:, b], torch.as_tensor(
            lpos, dtype=q.dtype, device=q.device))
        for b, lpos in m.sites], 1)


def coord_rates(m: RigidModel, q, qd):
    """dq/dt = G(q) qd: the nv-dim MuJoCo velocity (free-joint angular
    part in the body-local frame) as nq-dim coordinate rates; for the
    quaternion, half q (x) (0, w_local), the tangent at the RAW quaternion
    (gym resets leave it un-normalized)."""
    if m.nq == m.nv:
        return qd

    def tangent(quat, w):
        pure = torch.cat([torch.zeros_like(w[:, :1]), w], -1)
        return 0.5 * quat_mul(quat, pure)

    return _over_coordinates(m, q, qd, lambda pos, lin: lin, tangent)


def integrate_pos(m: RigidModel, q, qd, h: float):
    """mj_integratePos: scalar coordinates advance linearly; a free joint's
    quaternion right-multiplies the exponential of h w_local and is
    normalized."""
    if m.nq == m.nv:
        return q + h * qd

    def turn(quat, w):
        quat = quat_mul(quat, quat_exp(h * w))
        return quat / torch.sqrt(torch.sum(quat * quat, -1, keepdim=True))

    return _over_coordinates(m, q, qd, lambda pos, lin: pos + h * lin, turn)


def _over_coordinates(m: RigidModel, q, qd, scalar_fn, quat_fn):
    """Assemble an nq-vector from per-joint pieces: `scalar_fn(q part, qd
    part)` for positions and runs of scalar joints, `quat_fn(quat, w)` for a
    free joint's quaternion."""
    c = m.consts(q.dtype, q.device)
    pieces = {}
    for j in m.joints:
        if j.type == "free":
            pieces[j.qadr] = scalar_fn(q[:, j.qadr:j.qadr + 3],
                                       qd[:, j.dadr:j.dadr + 3])
            pieces[j.qadr + 3] = quat_fn(q[:, j.qadr + 3:j.qadr + 7],
                                         qd[:, j.dadr + 3:j.dadr + 6])
    for qa, da, n in c.scalar_runs:
        pieces[qa] = scalar_fn(q[:, qa:qa + n], qd[:, da:da + n])
    return torch.cat([pieces[k] for k in sorted(pieces)], -1)


# --------------------------------------------------------------------------
# The shared linearization and what reads it
# --------------------------------------------------------------------------


def _point_jacobian(c: _Consts, A, O, pts, anc):
    """Velocity Jacobian [B, k, 3, nv] of k points `pts` [B, k, 3], point i
    carried by the body whose row of the ancestor table is anc[i]."""
    lever = pts[:, :, None, :] - O[:, None, :, :]              # [B, k, nv, 3]
    cols = (torch.cross(A[:, None].expand_as(lever), lever, dim=-1) * c.rot
            + A[:, None] * c.lin)
    return (cols * anc[:, :, None]).transpose(-1, -2), lever


def _contact_frames(m: RigidModel, c: _Consts, R, p):
    """Gap [B, ncon], contact point xc [B, ncon, 3] and MuJoCo's tangent
    frame t1, t2 [B, ncon, 3] of every candidate contact: t1 = -(capsule
    axis projected onto the plane, normalized), t2 = n x t1; the world
    frame for spheres and vertical capsules."""
    Rb, pb = R[:, c.con_body], p[:, c.con_body]
    centers = pb + torch.matmul(Rb, c.con_lpos[:, :, None])[..., 0]
    gap = centers[:, :, 2] - c.con_radius - m.floor_z
    # bottom of the sphere, raised by half the penetration
    xc = centers - (c.con_radius + 0.5 * gap)[:, :, None] * c.ez
    aw = torch.matmul(Rb, c.con_axis[:, :, None])[..., 0]
    L = torch.sqrt(aw[:, :, 0] * aw[:, :, 0] + aw[:, :, 1] * aw[:, :, 1])
    safe = torch.clamp_min(L, 1e-8)
    zero = torch.zeros_like(L)
    along = torch.stack([-aw[:, :, 0] / safe, -aw[:, :, 1] / safe, zero], -1)
    t1 = torch.where(((L > 1e-8) & c.con_has_axis)[:, :, None], along, c.ey)
    t2 = torch.stack([-t1[:, :, 1], t1[:, :, 0], zero], -1)
    return gap, xc, t1, t2


def _linearization(m: RigidModel, q):
    """Everything the dynamics needs of the kinematics at q, from ONE pass:
    body frames, CoMs, the CoM linear (Jv) and world angular (Jw) velocity
    Jacobians [B, nb, 3, nv], and for models with contacts the gaps, contact
    points, tangent frames and material-point Jacobians Jc [B, ncon, 3,
    nv]."""
    c = m.consts(q.dtype, q.device)
    R, p, A, O = _kinematics(m, q)
    com = p + torch.matmul(R, c.ipos[:, :, None])[..., 0]
    lin = {"R": R, "p": p, "A": A, "O": O, "com": com}
    lin["Jv"], lin["lever"] = _point_jacobian(c, A, O, com, c.anc)
    lin["Jw"] = ((A * c.rot).transpose(1, 2)[:, None]
                 * c.anc[:, None, :])
    if m.ncon:
        gap, xc, t1, t2 = _contact_frames(m, c, R, p)
        lin.update(gap=gap, xc=xc, t1s=t1, t2s=t2)
        lin["Jc"], _ = _point_jacobian(c, A, O, xc, c.con_anc)
    return lin


def _world_inertia(c: _Consts, R):
    """Per-body world-frame rotational inertia about the CoM:
    (R imat) diag(inertia) (R imat)^T."""
    Ri = torch.matmul(R, c.imat)
    return torch.matmul(Ri * c.inertia[:, None, :], Ri.transpose(-1, -2))


def _flat(J):
    """[B, nb, 3, nv] -> [B, 3 nb, nv]."""
    return J.reshape(J.shape[0], -1, J.shape[-1])


def _mass_from(m: RigidModel, lin, dtype):
    """M(q) = sum_b m_b Jv_b^T Jv_b + Jw_b^T I_b Jw_b + diag(armature)."""
    c = m.consts(dtype, lin["R"].device)
    Iw = _world_inertia(c, lin["R"])
    Jv, Jw = lin["Jv"], lin["Jw"]
    M = torch.matmul(_flat(Jv * c.mass[:, None, None]).transpose(1, 2),
                     _flat(Jv))
    M = M + torch.matmul(_flat(Jw).transpose(1, 2),
                         _flat(torch.matmul(Iw, Jw)))
    return M + c.armature_diag, Iw


def body_motion(m: RigidModel, q, qd):
    """CoM linear velocity and world angular velocity of every body,
    [B, nb, 3] each."""
    lin = _linearization(m, q)
    return _motion_from(lin, qd)


def _motion_from(lin, qd):
    B, nb = lin["com"].shape[:2]
    vcom = torch.matmul(_flat(lin["Jv"]), qd[:, :, None]).reshape(B, nb, 3)
    omega = torch.matmul(_flat(lin["Jw"]), qd[:, :, None]).reshape(B, nb, 3)
    return vcom, omega


def _bias_from(m: RigidModel, lin, Iw, q, qd):
    """Coriolis, centrifugal, gyroscopic and gravity forces in
    Jacobian-transpose Newton-Euler form (mj_rne with zero acceleration):
    sum_b Jv_b^T m_b (a_b - g) + Jw_b^T (I_b alpha_b + w_b x I_b w_b), with
    (a_b, alpha_b) the velocity-product accelerations at fixed qd."""
    c = m.consts(q.dtype, q.device)
    A, O, lever = lin["A"], lin["O"], lin["lever"]
    vcom, omega = _motion_from(lin, qd)
    u = qd[:, :, None]
    Y, Ylin = A * (u * c.rot), A * (u * c.lin)
    # each axis turns with the frame it is fixed in; each anchor moves
    # with that frame
    Adot = torch.cross(torch.matmul(c.frame_rot, Y), A, dim=-1)
    between = O[:, :, None, :] - O[:, None, :, :]              # o_d - o_e
    Odot = torch.sum(c.frame_pt * (
        torch.cross(Y[:, None].expand_as(between), between, dim=-1)
        + Ylin[:, None]), dim=2)
    X, Xlin = Adot * (u * c.rot), Adot * (u * c.lin)
    alpha = torch.matmul(c.anc, X)
    slip = vcom[:, :, None, :] - Odot[:, None, :, :]           # [B, nb, nv, 3]
    acom = torch.sum(c.anc[:, :, None] * (
        torch.cross(X[:, None].expand_as(lever), lever, dim=-1)
        + torch.cross(Y[:, None].expand_as(slip), slip, dim=-1)
        + Xlin[:, None]), dim=2)
    force = c.mass[:, None] * (acom - c.gravity)
    Iw_omega = torch.matmul(Iw, omega[..., None])[..., 0]
    torque = (torch.matmul(Iw, alpha[..., None])[..., 0]
              + torch.cross(omega, Iw_omega, dim=-1))
    B = q.shape[0]
    bias = (torch.matmul(_flat(lin["Jv"]).transpose(1, 2),
                         force.reshape(B, -1, 1))
            + torch.matmul(_flat(lin["Jw"]).transpose(1, 2),
                           torque.reshape(B, -1, 1)))[..., 0]
    return bias, vcom, omega


def actuation(m: RigidModel, ctrl):
    """Generalized actuator forces [B, nv]: gear times the clipped
    control, added onto each actuator's coordinate."""
    c = m.consts(ctrl.dtype, ctrl.device)
    return torch.matmul(torch.clamp(ctrl, c.ctrl_lo, c.ctrl_hi), c.gear_map)


def _fluid_from(m: RigidModel, lin, vcom, omega, qd):
    """MuJoCo's inertia-box fluid model (mj_passive): per-body viscous and
    quadratic density drag in the body's inertial frame, mapped back
    through the CoM Jacobians."""
    R = lin["R"]
    c = m.consts(R.dtype, R.device)
    Ri = torch.matmul(R, c.imat)
    wind = torch.as_tensor(m.wind, dtype=R.dtype, device=R.device)
    to_local = lambda v: torch.matmul(Ri.transpose(-1, -2), v[..., None])[..., 0]
    lvel_ang = to_local(omega)
    lvel_lin = to_local(vcom - wind)
    box = c.fluid_box
    lfrc_t = torch.zeros_like(lvel_ang)
    lfrc_f = torch.zeros_like(lvel_lin)
    if m.viscosity != 0.0:
        diam = torch.mean(2.0 * box, dim=-1, keepdim=True)
        lfrc_t = lfrc_t - math.pi * diam ** 3 * m.viscosity * lvel_ang
        lfrc_f = lfrc_f - 3.0 * math.pi * diam * m.viscosity * lvel_lin
    if m.density != 0.0:
        b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
        tq = torch.stack([b0 * (b1 ** 4 + b2 ** 4), b1 * (b2 ** 4 + b0 ** 4),
                          b2 * (b0 ** 4 + b1 ** 4)], -1)
        area = torch.stack([b1 * b2, b2 * b0, b0 * b1], -1)
        lfrc_t = lfrc_t - 0.5 * m.density * tq * torch.abs(lvel_ang) * lvel_ang
        lfrc_f = lfrc_f - 2.0 * m.density * area * torch.abs(lvel_lin) * lvel_lin
    F = torch.matmul(Ri, lfrc_f[..., None])
    T = torch.matmul(Ri, lfrc_t[..., None])
    B = qd.shape[0]
    return (torch.matmul(_flat(lin["Jv"]).transpose(1, 2),
                         F.reshape(B, -1, 1))
            + torch.matmul(_flat(lin["Jw"]).transpose(1, 2),
                           T.reshape(B, -1, 1)))[..., 0]


def _rows_from(m: RigidModel, lin, q, qd):
    """MuJoCo's pyramidal constraint rows from the shared linearization.

    Per contact 4 unnormalized pyramid-edge rows J_n +- mu J_t in the order
    (t1, +), (t1, -), (t2, +), (t2, -), each with force >= 0; then two
    one-sided rows per limited coordinate.  Returns J [B, nr, nv], aref
    [B, nr], d [B, nr] (impedance) and active [B, nr] (bool)."""
    c = m.consts(q.dtype, q.device)
    B = q.shape[0]
    Js, vels, poss = [], [], []
    if m.ncon:
        Jp = lin["Jc"]                                       # [B, ncon, 3, nv]
        t1, t2 = lin["t1s"], lin["t2s"]
        Jn = Jp[:, :, 2]
        mu = c.con_mu[:, None]
        Jt1 = mu * torch.matmul(t1[:, :, None, :], Jp)[:, :, 0]
        Jt2 = mu * torch.matmul(t2[:, :, None, :], Jp)[:, :, 0]
        Jcon = torch.stack([Jn + Jt1, Jn - Jt1, Jn + Jt2, Jn - Jt2], 2)
        Jcon = Jcon.reshape(B, 4 * m.ncon, m.nv)
        Js.append(Jcon)
        vels.append(torch.matmul(Jcon, qd[:, :, None])[..., 0])
        pos = lin["gap"] - c.con_margin
        poss.append(pos[:, :, None].expand(B, m.ncon, 4).reshape(B, -1))
    if m.limits:
        Js.append(c.lim_rows.expand(B, -1, -1))
        vels.append(c.lim_side * qd[:, c.lim_dof])
        poss.append(c.lim_side * (q[:, c.lim_qadr] - c.lim_bound))
    J, vel, pos = (torch.cat(x, 1) for x in (Js, vels, poss))
    d = _impedance_rows(c, pos)
    aref = -c.row_b * vel - c.row_k * d * pos
    return J, aref, d, pos < 0.0


def _cho_solve(L, rhs):
    """M^-1 rhs from the lower Cholesky factor L, rhs [B, nv, k]: two
    batched triangular solves, each one launch on the card (the library's
    `cholesky_solve` loops over the batch there when k > 1)."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def _solve_rows(m: RigidModel, L, J, aref, d, active, qacc_smooth, iters,
                f0, solve):
    c = m.consts(J.dtype, J.device)
    Jt = J.transpose(1, 2)
    W = _cho_solve(L, Jt)                                     # [B, nv, nr]
    dsafe = torch.clamp(d, 1e-4, 1.0 - 1e-6)
    Adiag = torch.sum(J * W.transpose(1, 2), -1)
    Rreg = torch.clamp_min((1.0 - dsafe) / dsafe * c.row_diag, 1e-15)
    b_vec = torch.matmul(J, qacc_smooth[:, :, None])[..., 0] - aref
    D = torch.clamp_min(Adiag + Rreg, 1e-9)
    f = solve(J, W, Rreg, b_vec, D, active, f0.contiguous(), iters)
    return torch.matmul(Jt, f[:, :, None])[..., 0], f


def forward(m: RigidModel, q, qd, ctrl, iters: int = 40, f0=None,
            solve=pgs_solve):
    """Full constrained forward dynamics over a batch, from one shared
    linearization.  Returns (qacc [B, nv], qfrc_total [B, nv], M [B, nv,
    nv], qfrc_constraint [B, nv], row forces [B, nr]).  `solve` is the
    Gauss-Seidel solve: `pgs_solve` (kernel K4 on CUDA tensors) unless a
    caller names the plain version."""
    c = m.consts(q.dtype, q.device)
    with span("physics_general.linearize"):
        lin = _linearization(m, q)
        M, Iw = _mass_from(m, lin, q.dtype)
        L = torch.linalg.cholesky(M)
    with span("physics_general.smooth"):
        bias, vcom, omega = _bias_from(m, lin, Iw, q, qd)
        qfrc = actuation(m, ctrl) - c.damping * qd - bias
        if c.has_spring:
            qfrc = qfrc - c.stiffness * (q[:, c.dof_qadr] - c.spring)
        if m.has_fluid:
            qfrc = qfrc + _fluid_from(m, lin, vcom, omega, qd)
        qacc_smooth = _cho_solve(L, qfrc[:, :, None])[..., 0]
        if m.nrow == 0:
            return (qacc_smooth, qfrc, M, torch.zeros_like(qd),
                    q.new_zeros((q.shape[0], 0)))
    with span("physics_general.rows"):
        J, aref, d, active = _rows_from(m, lin, q, qd)
        if f0 is None:
            f0 = q.new_zeros((q.shape[0], m.nrow))
    with span("physics_general.solve"):
        qfrc_con, f = _solve_rows(m, L, J, aref, d, active, qacc_smooth,
                                  iters, f0, solve)
        qfrc_total = qfrc + qfrc_con
        qacc = _cho_solve(L, qfrc_total[:, :, None])[..., 0]
    return qacc, qfrc_total, M, qfrc_con, f


def _euler_step(m: RigidModel, q, qd, ctrl, h, iters, f0, solve):
    """mujoco 'Euler': semi-implicit with implicit joint damping,
    (M + h diag(damping)) qacc = total force.  The fifth value is the
    pre-integration state, where the last forward evaluation ran."""
    c = m.consts(q.dtype, q.device)
    _, qfrc_total, M, qfrc_con, f = forward(m, q, qd, ctrl, iters=iters,
                                            f0=f0, solve=solve)
    with span("physics_general.integrate"):
        Lh = torch.linalg.cholesky(M + h * c.damping_diag)
        qacc = _cho_solve(Lh, qfrc_total[:, :, None])[..., 0]
        qd_new = qd + h * qacc
        q_new = integrate_pos(m, q, qd_new, h)
    return q_new, qd_new, qfrc_con, f, (q, qd)


# classic RK4 Butcher tableau, as mj_RungeKutta: stage positions integrate
# from the ORIGINAL qpos along A-weighted stage velocities (quaternion-
# aware), stage velocities from A-weighted stage accelerations
_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _rk4_step(m: RigidModel, q, qd, ctrl, h, iters, f0, solve):
    qacc0, _, _, con, f = forward(m, q, qd, ctrl, iters=iters, f0=f0,
                                  solve=solve)
    vels = [qd]
    accs = [qacc0]
    for i in range(3):
        with span("physics_general.integrate"):
            dq = sum(a * v for a, v in zip(_RK4_A[i], vels) if a != 0.0)
            dv = sum(a * acc for a, acc in zip(_RK4_A[i], accs) if a != 0.0)
            qi = integrate_pos(m, q, dq, h)
            vi = qd + h * dv
        qacci, _, _, _, f = forward(m, qi, vi, ctrl, iters=iters, f0=f,
                                    solve=solve)
        vels.append(vi)
        accs.append(qacci)
    with span("physics_general.integrate"):
        dq = sum(b * v for b, v in zip(_RK4_B, vels))
        dv = sum(b * acc for b, acc in zip(_RK4_B, accs))
        # the last forward evaluation ran at stage 3's state (qi, vi)
        q_new, qd_new = integrate_pos(m, q, dq, h), qd + h * dv
    return q_new, qd_new, con, f, (qi, vi)


def physics_step(m: RigidModel, q, qd, ctrl, iters: int = 40, f0=None,
                 solve=pgs_solve):
    """One control step = `frame_skip` integrator substeps over a batch: q
    [B, nq], qd [B, nv], ctrl [B, nu], f0 [B, nr] (the previous control
    step's row forces warm-start the solver; zeros if None).  Returns (q,
    qd, qfrc_constraint of the last substep, final row forces, state of the
    LAST forward evaluation).

    That fifth value (pre-integration for Euler, RK4 stage 3 otherwise) is
    where gym's observation-side derived quantities (cvel, cinert,
    cfrc_ext) are read, one evaluation behind qpos and qvel; pair it with
    the returned row forces when recomposing cfrc_ext."""
    stepper = _euler_step if m.integrator == "euler" else _rk4_step
    if f0 is None:
        f0 = q.new_zeros((q.shape[0], m.nrow))
    carry = (q, qd, torch.zeros_like(qd), f0, (q, qd))
    for _ in range(m.frame_skip):
        q_, qd_, _, f_, _ = carry
        carry = stepper(m, q_, qd_, ctrl, m.timestep, iters, f_, solve)
    return carry


# --------------------------------------------------------------------------
# Stand-alone quantities (JAX rigid_body.py:385-520, 555-565, 685-727, 794)
# --------------------------------------------------------------------------


def kinetic_energy(m: RigidModel, q, qd):
    """[B]: 1/2 sum_b m_b |v_com|^2 + 1/2 w_b . I_b w_b (in each body's
    principal-inertia frame) + 1/2 sum_j armature_j qd_j^2."""
    c = m.consts(q.dtype, q.device)
    lin = _linearization(m, q)
    vcom, omega = _motion_from(lin, qd)
    Ri = torch.matmul(lin["R"], c.imat)
    wl = torch.matmul(Ri.transpose(-1, -2), omega[..., None])[..., 0]
    ke = 0.5 * torch.sum(c.mass * torch.sum(vcom * vcom, -1), -1)
    ke = ke + 0.5 * torch.sum(c.inertia * wl * wl, (-1, -2))
    return ke + 0.5 * torch.sum(torch.diagonal(c.armature_diag) * qd * qd,
                                -1)


def potential_energy(m: RigidModel, q):
    """[B]: -sum_b m_b com_b . g."""
    c = m.consts(q.dtype, q.device)
    R, p = fk(m, q)
    com = p + torch.matmul(R, c.ipos[:, :, None])[..., 0]
    return -torch.sum(c.mass * torch.matmul(com, c.gravity), -1)


def body_jacobians(m: RigidModel, q):
    """The CoM linear and world angular velocity Jacobians with respect to
    qd, Jv and Jw [B, nb, 3, nv]."""
    lin = _linearization(m, q)
    return lin["Jv"], lin["Jw"]


def mass_matrix(m: RigidModel, q):
    """M(q) [B, nv, nv] (mj_fullM)."""
    return _mass_from(m, _linearization(m, q), q.dtype)[0]


def bias_forces(m: RigidModel, q, qd):
    """Coriolis, centrifugal, gyroscopic and gravity forces [B, nv]
    (mj_rne with zero acceleration, qfrc_bias)."""
    c = m.consts(q.dtype, q.device)
    lin = _linearization(m, q)
    return _bias_from(m, lin, _world_inertia(c, lin["R"]), q, qd)[0]


def fluid_forces(m: RigidModel, q, qd):
    """MuJoCo's inertia-box fluid forces [B, nv] (zero without a fluid)."""
    lin = _linearization(m, q)
    vcom, omega = _motion_from(lin, qd)
    return _fluid_from(m, lin, vcom, omega, qd)


def passive_forces(m: RigidModel, q, qd):
    """Joint damping and springs, and the fluid forces where the model has
    a fluid, [B, nv]."""
    c = m.consts(q.dtype, q.device)
    out = -c.damping * qd - c.stiffness * (q[:, c.dof_qadr] - c.spring)
    if m.has_fluid:
        out = out + fluid_forces(m, q, qd)
    return out


def smooth_force(m: RigidModel, q, qd, ctrl):
    """Actuation plus passive minus bias forces, [B, nv]."""
    return actuation(m, ctrl) + passive_forces(m, q, qd) - bias_forces(
        m, q, qd)


def contact_gaps(m: RigidModel, q):
    """The surface distance of each candidate contact to the floor,
    [B, ncon]."""
    c = m.consts(q.dtype, q.device)
    R, p = fk(m, q)
    return _contact_frames(m, c, R, p)[0]


def constraint_forces(m: RigidModel, q, qd, M, qacc_smooth,
                      iters: int = 40, f0=None, solve=pgs_solve):
    """The pyramidal contact and limit rows solved by warm-startable
    projected Gauss-Seidel (every row force >= 0) from the mass matrix M
    [B, nv, nv] and the unconstrained acceleration [B, nv]: returns
    (qfrc_constraint [B, nv], row forces [B, nr]); `f0` warm-starts the
    sweeps (zeros if None), `solve` as `forward`'s."""
    B = q.shape[0]
    if m.nrow == 0:
        return torch.zeros_like(qd), q.new_zeros((B, 0))
    J, aref, d, active = _rows_from(m, _linearization(m, q), q, qd)
    if f0 is None:
        f0 = q.new_zeros((B, m.nrow))
    return _solve_rows(m, torch.linalg.cholesky(M), J, aref, d, active,
                       qacc_smooth, iters, f0, solve)


# --------------------------------------------------------------------------
# Observation-side quantities
# --------------------------------------------------------------------------


def _robot_com(c: _Consts, com):
    """Whole-robot CoM [B, 3]: subtree_com of every moving body's root in
    the single-tree benchmark models."""
    return torch.sum(c.mass[:, None] * com, 1) / c.total_mass


def cfrc_ext(m: RigidModel, q, f):
    """Com-based external (contact) force per body [B, nb, 6], layout
    [torque(3), force(3)], as mjData.cfrc_ext after mj_rnePostConstraint for
    plane contacts.  Row forces fold back from the pyramid by the row
    order: normal = sum of a contact's 4 edges, tangent_t = mu (f+ - f-)."""
    B = q.shape[0]
    if m.ncon == 0:
        return q.new_zeros((B, m.nbody, 6))
    c = m.consts(q.dtype, q.device)
    R, p = fk(m, q)
    com = p + torch.matmul(R, c.ipos[:, :, None])[..., 0]
    _, xc, t1, t2 = _contact_frames(m, c, R, p)
    fe = f[:, :4 * m.ncon].reshape(B, m.ncon, 4)
    fn = torch.sum(fe, -1)
    ft1 = c.con_mu * (fe[:, :, 0] - fe[:, :, 1])
    ft2 = c.con_mu * (fe[:, :, 2] - fe[:, :, 3])
    F = ft1[..., None] * t1 + ft2[..., None] * t2 + fn[..., None] * c.ez
    T = torch.cross(xc - _robot_com(c, com)[:, None], F, dim=-1)
    return torch.matmul(c.con_onto_body, torch.cat([T, F], -1))


def com_quantities(m: RigidModel, q, qd):
    """MuJoCo's com-based per-body quantities for the humanoid observation:
    cinert [B, nb, 10] = [I_xx, I_yy, I_zz, I_xy, I_xz, I_yz, m d, m] about
    the whole-robot CoM, cvel [B, nb, 6] = [w, v at that point], and the
    x, y of the whole-robot CoM [B, 2]."""
    c = m.consts(q.dtype, q.device)
    lin = _linearization(m, q)
    R, com = lin["R"], lin["com"]
    robot_com = _robot_com(c, com)
    Iw = _world_inertia(c, R)
    d = com - robot_com[:, None]
    dd = torch.sum(d * d, -1)
    outer = d[..., :, None] * d[..., None, :]
    Ic = Iw + c.mass[:, None, None] * (dd[..., None, None] * c.eye3 - outer)
    mass = c.mass[:, None].expand(q.shape[0], m.nbody, 1)
    cinert = torch.cat([
        Ic[..., 0, 0:1], Ic[..., 1, 1:2], Ic[..., 2, 2:3],
        Ic[..., 0, 1:2], Ic[..., 0, 2:3], Ic[..., 1, 2:3],
        mass * d, mass], -1)
    vcom, omega = _motion_from(lin, qd)
    vc = vcom + torch.cross(omega, -d, dim=-1)
    return cinert, torch.cat([omega, vc], -1), robot_com[:, :2]
