"""The general rigid-body engine of the port
(ilswiss_tpu_torch/ops/rigid_body.py) against the JAX engine
(ilswiss_tpu/ops/rigid_body.py), for the models that reach it: ant,
humanoid, swimmer and the inverted double pendulum.

Inputs come from numpy seeds: perturbed poses with the free joint's
quaternion left un-normalized (as gym resets leave it), bodies lowered
until some contacts are active, some joints pushed past their limits.  The
JAX side is compiled ONCE per model (one jitted, vmapped function that
returns every quantity) and kept for the whole module.

Tolerances.  float64: every quantity within 1e-9 of the JAX engine after
dividing both by max(1, max |reference|), as tests/test_rigid_body.py
scales qacc: the port's Jacobians are analytic where JAX differentiates
forward kinematics, so the two agree to rounding, not bit for bit.  float32
forward evaluation against the port's own float64 one: rtol 2e-4, atol 5e-3
after the same scaling, the pin the planar path uses
(tests/test_torch_planar.py), because 15 unconverged Gauss-Seidel sweeps
amplify rounding of forces of size 1e3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.ops.rigid_body as jrb
from ilswiss_tpu.envs.locomotion import _model as jmodel
from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.ops import pgs
from ilswiss_tpu_torch.ops import planar_dynamics as pd
from ilswiss_tpu_torch.ops import rigid_body as rb

torch.set_num_threads(1)

MODELS = ["ant", "humanoid", "swimmer", "inverteddoublependulum"]
B, ITERS = 3, 15


def _states(name, seed=0, dtype=np.float64):
    """(q, qd, ctrl, f0), each [B, .]."""
    m = _model(name)
    rng = np.random.RandomState(seed)
    q = m.qpos0 + 0.1 * rng.randn(B, m.nq)
    qd = 0.5 * rng.randn(B, m.nv)
    ctrl = np.clip(rng.randn(B, m.nu), -1.2, 1.2)     # some clipped
    f0 = 0.2 * np.abs(rng.randn(B, m.nrow))
    if name == "ant":
        q[:, 2] = 0.45 + 0.1 * rng.rand(B)
        q[:, 3:7] = (np.array([1.0, 0, 0, 0]) + 0.3 * rng.randn(B, 4)) * 1.1
    elif name == "humanoid":
        q[:, 2] = 1.2 + 0.1 * rng.rand(B)
        q[:, 3:7] = (np.array([1.0, 0, 0, 0]) + 0.1 * rng.randn(B, 4)) * 0.9
    elif name == "swimmer":
        q[0, 3], q[1, 4] = 1.8, -1.78        # past the +-100 degree limits
    else:
        q[0, 0], q[1, 0] = 1.03, -1.01       # the cart past its rail
    return tuple(x.astype(dtype) for x in (q, qd, ctrl, f0))


def _jax_everything(jm):
    h = jm.timestep

    def everything(q, qd, ctrl, f0):
        lin = jrb._linearization(jm, q)
        M, Iw = jrb._mass_from(jm, lin, q.dtype)
        bias, vcom, omega = jrb._bias_from(jm, lin, Iw, q, qd)
        J, aref, d, active = jrb._rows_from(jm, lin, q, qd)
        qacc, qfrc, M2, con, f = jrb.forward(jm, q, qd, ctrl, iters=ITERS,
                                             f0=f0)
        cinert, cvel, mass_center = jrb.com_quantities(jm, q, qd)
        out = dict(
            fk_R=lin["R"], fk_p=lin["p"], M=M, bias=bias, vcom=vcom,
            omega=omega, rows_J=J, rows_aref=aref, rows_d=d,
            rows_active=active, forward_qacc=qacc, forward_qfrc_total=qfrc,
            forward_M=M2, forward_qfrc_constraint=con, forward_f=f,
            integrate_pos=jrb.integrate_pos(jm, q, qd, h),
            coord_rates=jrb.coord_rates(jm, q, qd),
            actuation=jrb.actuation(jm, ctrl),
            cfrc_ext=jrb.cfrc_ext(jm, q, f), cinert=cinert, cvel=cvel,
            mass_center=mass_center)
        if jm.sites:
            out["site_positions"] = jrb.site_positions(jm, q)
        return out

    return jax.jit(jax.vmap(everything))


def _port_everything(m, q, qd, ctrl, f0):
    lin = rb._linearization(m, q)
    M, Iw = rb._mass_from(m, lin, q.dtype)
    bias, _, _ = rb._bias_from(m, lin, Iw, q, qd)
    vcom, omega = rb.body_motion(m, q, qd)
    J, aref, d, active = rb._rows_from(m, lin, q, qd)
    qacc, qfrc, M2, con, f = rb.forward(m, q, qd, ctrl, iters=ITERS, f0=f0)
    cinert, cvel, mass_center = rb.com_quantities(m, q, qd)
    R, p = rb.fk(m, q)
    out = dict(
        fk_R=R, fk_p=p, M=M, bias=bias, vcom=vcom, omega=omega, rows_J=J,
        rows_aref=aref, rows_d=d, rows_active=active, forward_qacc=qacc,
        forward_qfrc_total=qfrc, forward_M=M2, forward_qfrc_constraint=con,
        forward_f=f, integrate_pos=rb.integrate_pos(m, q, qd, m.timestep),
        coord_rates=rb.coord_rates(m, q, qd), actuation=rb.actuation(m, ctrl),
        cfrc_ext=rb.cfrc_ext(m, q, f), cinert=cinert, cvel=cvel,
        mass_center=mass_center)
    if m.sites:
        out["site_positions"] = rb.site_positions(m, q)
    return {k: v.numpy() for k, v in out.items()}


_CACHE: dict = {}


def _both(name):
    """(JAX quantities, port quantities) of `name` at float64; the JAX
    function is compiled and run once per module."""
    if name not in _CACHE:
        args = _states(name)
        jax.config.update("jax_enable_x64", True)
        try:
            want = _jax_everything(jmodel(name))(
                *(jnp.asarray(x) for x in args))
            want = {k: np.asarray(v) for k, v in want.items()}
        finally:
            jax.config.update("jax_enable_x64", False)
        got = _port_everything(_model(name),
                               *(torch.as_tensor(x) for x in args))
        _CACHE[name] = (want, got)
    return _CACHE[name]


def _assert_scaled_close(got, want, atol, rtol=0.0, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=what)


GROUPS = {
    "fk": ("fk_R", "fk_p"),
    "mass_matrix": ("M",),
    "bias_and_body_motion": ("bias", "vcom", "omega"),
    "rows": ("rows_J", "rows_aref", "rows_d"),
    "forward": ("forward_qacc", "forward_qfrc_total", "forward_M",
                "forward_qfrc_constraint", "forward_f"),
    "integrate_pos_and_coord_rates": ("integrate_pos", "coord_rates"),
    "actuation": ("actuation",),
    "cfrc_ext": ("cfrc_ext",),
    "com_quantities": ("cinert", "cvel", "mass_center"),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("name", MODELS)
def test_engine_matches_jax_f64(name, group):
    want, got = _both(name)
    for key in GROUPS[group]:
        _assert_scaled_close(got[key], want[key], 1e-9, what=f"{name} {key}")
    if group == "rows":
        np.testing.assert_array_equal(got["rows_active"],
                                      want["rows_active"])


def test_inputs_exercise_contacts_limits_and_raw_quaternions():
    """The comparison above means little on free-floating bodies: some
    rows are active in every model, contacts carry force in ant and
    humanoid, and their quaternions are not unit."""
    for name in MODELS:
        want, _ = _both(name)
        assert want["rows_active"].any(), name
        assert np.abs(want["forward_f"]).max() > 1.0, name
    for name in ("ant", "humanoid"):
        q = _states(name)[0]
        assert np.all(np.abs(np.linalg.norm(q[:, 3:7], axis=1) - 1) > 5e-3)
        m = _model(name)
        want, _ = _both(name)
        assert want["rows_active"][:, :4 * m.ncon].any(), name
        assert np.abs(want["cfrc_ext"]).max() > 1.0, name


def test_site_positions_match_jax_f64():
    want, got = _both("inverteddoublependulum")
    _assert_scaled_close(got["site_positions"], want["site_positions"], 1e-9)


@pytest.mark.parametrize("name", MODELS)
def test_forward_float32_tracks_float64(name):
    """The plain engine at float32 against its own float64 evaluation."""
    m = _model(name)
    args = [torch.as_tensor(x) for x in _states(name)]
    want = rb.forward(m, *args[:3], iters=ITERS, f0=args[3])
    got = rb.forward(m, *(x.float() for x in args[:3]), iters=ITERS,
                     f0=args[3].float())
    for g, w, what in zip(got, want, ("qacc", "qfrc", "M", "con", "f")):
        assert g.dtype == torch.float32
        _assert_scaled_close(g.double().numpy(), w.numpy(), 5e-3, 2e-4,
                             f"{name} {what}")


@pytest.mark.parametrize("name", ["hopper", "walker", "halfcheetah"])
def test_engine_matches_planar_math_f64(name):
    """The general engine and the port's planar forward (`_forward_math`,
    kernel K1's plain version) are two routes to the same dynamics; on a
    planar model they agree at float64 (rtol 1e-9, atol 1e-8, the planar
    pin), halfcheetah's implicit-damping solve included."""
    m = _model(name)
    pm = pd.planar_model(m)
    rng = np.random.RandomState(4)
    q = torch.as_tensor(m.qpos0 + 0.2 * rng.randn(B, m.nq))
    qd = torch.as_tensor(rng.randn(B, m.nv))
    ctrl = torch.as_tensor(np.clip(rng.randn(B, m.nu), -1, 1))
    f0 = torch.as_tensor(0.2 * np.abs(rng.randn(B, m.nrow)))
    damped = m.integrator == "euler"
    want = pd._forward_math(pm, q.t(), qd.t(), ctrl.t(), f0.t(), ITERS,
                            m.timestep if damped else None)
    qacc, _, _, con, f = rb.forward(m, q, qd, ctrl, iters=ITERS, f0=f0)
    for g, w in zip((qacc, con, f), want):
        np.testing.assert_allclose(g.numpy(), w.t().numpy(), rtol=1e-9,
                                   atol=1e-8)
    if damped:
        q1, qd1, _, _, (q_ev, _) = rb._euler_step(
            m, q, qd, ctrl, m.timestep, ITERS, f0, pgs.pgs_solve)
        qd_want = qd + m.timestep * want[3].t()
        np.testing.assert_allclose(qd1.numpy(), qd_want.numpy(), rtol=1e-9,
                                   atol=1e-8)
        np.testing.assert_allclose(
            q1.numpy(), (q + m.timestep * qd_want).numpy(), rtol=1e-9,
            atol=1e-8)
        assert q_ev is q


@pytest.mark.parametrize("name", ["swimmer", "inverteddoublependulum"])
def test_physics_step_matches_jax_f64(name):
    """One whole control step (RK4 substeps, warm start carried from
    evaluation to evaluation) against the JAX `physics_step`; the two
    small models compile in seconds."""
    jm, m = jmodel(name), _model(name)
    args = _states(name, seed=1)
    jax.config.update("jax_enable_x64", True)
    try:
        want = jax.jit(jax.vmap(lambda q, qd, c, f0: jrb.physics_step(
            jm, q, qd, c, iters=ITERS, f0=f0)))(
                *(jnp.asarray(x) for x in args))
        want = jax.tree.map(np.asarray, want)
    finally:
        jax.config.update("jax_enable_x64", False)
    q, qd, ctrl, f0 = (torch.as_tensor(x) for x in args)
    got = rb.physics_step(m, q, qd, ctrl, iters=ITERS, f0=f0)
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    for g, w, what in zip(flat(got), flat(want),
                          ("q", "qd", "con", "f", "q_ev", "qd_ev")):
        _assert_scaled_close(g.numpy(), w, 1e-9, what=f"{name} {what}")


def test_physics_step_auto_takes_either_route():
    """A planar model goes through the planar step, any other through the
    engine, with the same arguments and return values."""
    for name, route in (("hopper", pd.planar_physics_step),
                        ("swimmer", rb.physics_step)):
        m = _model(name)
        rng = np.random.RandomState(6)
        q = torch.as_tensor((m.qpos0 + 0.05 * rng.randn(B, m.nq))
                            .astype(np.float32))
        qd = torch.as_tensor(rng.randn(B, m.nv).astype(np.float32))
        ctrl = torch.as_tensor(rng.rand(B, m.nu).astype(np.float32))
        got = pd.physics_step_auto(m, q, qd, ctrl, iters=ITERS)
        want = route(m, q, qd, ctrl, iters=ITERS)
        assert tuple(got[3].shape) == (B, m.nrow)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)


def test_factor_counts_failed_factorizations():
    """`_factor` keeps the factorization's `info` on the device: a planted
    mass matrix that is not positive definite is counted in
    `factor_failures`, not raised, and the others are factored as the
    library's `cholesky` factors them."""
    c = _model("ant").consts(torch.float64, "cpu")
    rng = np.random.RandomState(8)
    S = rng.randn(3, 5, 5)
    M = torch.as_tensor(S @ S.transpose(0, 2, 1) + np.eye(5))
    M[1] = -M[1]
    before = rb.factor_failures("cpu")
    L = rb._factor(c, M)
    assert rb.factor_failures("cpu") == before + 1
    assert torch.equal(L[[0, 2]], torch.linalg.cholesky(M[[0, 2]]))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(M)


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(5)
    a, b = rng.randn(4, 4), rng.randn(4, 4)
    v = rng.randn(4, 3)
    unit = a / np.linalg.norm(a, axis=1, keepdims=True)
    T = torch.as_tensor
    jax.config.update("jax_enable_x64", True)
    try:
        want = (np.asarray(jax.vmap(jrb.quat_mul)(a, b)),
                np.asarray(jax.vmap(jrb.quat_exp)(v)),
                np.asarray(jax.vmap(jrb.quat_exp)(np.zeros((1, 3)))),
                np.asarray(jax.vmap(jrb.quat_to_mat)(unit)))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = (rb.quat_mul(T(a), T(b)), rb.quat_exp(T(v)),
           rb.quat_exp(torch.zeros(1, 3, dtype=torch.float64)),
           rb.quat_to_mat(T(unit)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
