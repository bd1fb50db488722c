"""The general engine's stand-alone functions (ilswiss_tpu_torch/ops/
rigid_body.py: kinetic_energy, potential_energy, body_jacobians,
mass_matrix, bias_forces, fluid_forces, passive_forces, contact_gaps,
constraint_forces, smooth_force) against the JAX package's
(ilswiss_tpu/ops/rigid_body.py:385-520, 555-565, 685-727, 794), the calls
tests/test_rigid_body.py makes of them.

Inputs: 3 states a model from a numpy seed, float64, feet pushed into the
floor so that some contacts are active.  The JAX functions are compiled
once per model (one jitted, vmapped function of all ten).  Pin: every
quantity within 1e-9 of the JAX function after dividing both by max(1, max
|reference|), tests/test_torch_rigid_body.py's float64 pin (the port's
Jacobians are analytic where JAX differentiates forward kinematics).
Walker and hopper run in the tier; ant's JAX compile takes some 30 s on
one CPU worker, so its case is marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.ops.rigid_body as jrb
from ilswiss_tpu.envs.locomotion import _model as jmodel
from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.ops import rigid_body as rb

torch.set_num_threads(1)

T = torch.as_tensor


ENGINE_B, ENGINE_ITERS = 3, 15


def _engine_states(name, seed=0):
    m = _model(name)
    rng = np.random.RandomState(seed)
    q = m.qpos0 + 0.2 * rng.randn(ENGINE_B, m.nq)
    qd = rng.uniform(-1.0, 1.0, (ENGINE_B, m.nv))
    ctrl = np.clip(rng.randn(ENGINE_B, m.nu), -1.2, 1.2)
    f0 = 0.2 * np.abs(rng.randn(ENGINE_B, m.nrow))
    if name == "ant":
        q[:, 2] = 0.45 + 0.1 * rng.rand(ENGINE_B)
        q[:, 3:7] = (np.array([1.0, 0, 0, 0])
                     + 0.3 * rng.randn(ENGINE_B, 4)) * 1.1
    else:
        q[:, 1] -= 0.05 + 0.1 * rng.rand(ENGINE_B)    # feet into the floor
    return q, qd, ctrl, f0


def _jax_standalone(jm):
    def everything(q, qd, ctrl, f0):
        M = jrb.mass_matrix(jm, q)
        smooth = jrb.smooth_force(jm, q, qd, ctrl)
        qacc_smooth = jnp.linalg.solve(M, smooth)
        con, f = jrb.constraint_forces(jm, q, qd, M, qacc_smooth,
                                       iters=ENGINE_ITERS, f0=f0)
        Jv, Jw = jrb.body_jacobians(jm, q)
        return dict(
            kinetic_energy=jrb.kinetic_energy(jm, q, qd),
            potential_energy=jrb.potential_energy(jm, q),
            body_jacobians_v=Jv, body_jacobians_w=Jw, mass_matrix=M,
            bias_forces=jrb.bias_forces(jm, q, qd),
            fluid_forces=jrb.fluid_forces(jm, q, qd),
            passive_forces=jrb.passive_forces(jm, q, qd),
            contact_gaps=jrb.contact_gaps(jm, q),
            constraint_forces=con, constraint_rows=f,
            smooth_force=smooth, qacc_smooth=qacc_smooth)
    return jax.jit(jax.vmap(everything))


_ENGINE: dict = {}


def _engine_both(name):
    if name not in _ENGINE:
        q, qd, ctrl, f0 = _engine_states(name)
        jax.config.update("jax_enable_x64", True)
        try:
            want = _jax_standalone(jmodel(name))(
                *(jnp.asarray(x) for x in (q, qd, ctrl, f0)))
            want = {k: np.asarray(v) for k, v in want.items()}
        finally:
            jax.config.update("jax_enable_x64", False)
        m = _model(name)
        q, qd, ctrl, f0 = (T(x) for x in (q, qd, ctrl, f0))
        Jv, Jw = rb.body_jacobians(m, q)
        qacc_smooth = T(want["qacc_smooth"])
        con, f = rb.constraint_forces(m, q, qd, T(want["mass_matrix"]),
                                      qacc_smooth, iters=ENGINE_ITERS,
                                      f0=f0)
        got = dict(
            kinetic_energy=rb.kinetic_energy(m, q, qd),
            potential_energy=rb.potential_energy(m, q),
            body_jacobians_v=Jv, body_jacobians_w=Jw,
            mass_matrix=rb.mass_matrix(m, q),
            bias_forces=rb.bias_forces(m, q, qd),
            fluid_forces=rb.fluid_forces(m, q, qd),
            passive_forces=rb.passive_forces(m, q, qd),
            contact_gaps=rb.contact_gaps(m, q), constraint_forces=con,
            constraint_rows=f, smooth_force=rb.smooth_force(m, q, qd, ctrl),
            qacc_smooth=qacc_smooth)
        _ENGINE[name] = (want, {k: v.numpy() for k, v in got.items()})
    return _ENGINE[name]


ENGINE_MODELS = ["walker", "hopper",
                 pytest.param("ant", marks=pytest.mark.slow)]


@pytest.mark.parametrize("name", ENGINE_MODELS)
def test_engine_standalone_functions_match_jax_f64(name):
    """The ten stand-alone functions at float64 on 3 states (feet pushed
    into the floor, so some contacts are active), within 1e-9 of the JAX
    functions after scaling; `constraint_forces` from the JAX mass matrix
    and unconstrained acceleration, warm-started, 15 sweeps."""
    want, got = _engine_both(name)
    assert set(got) == set(want)
    for k in want:
        w, g = want[k], got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(1.0, float(np.max(np.abs(w), initial=0.0)))
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-9,
                                   err_msg=f"{name} {k}")
    assert (want["contact_gaps"] < 0).any()
    assert np.abs(want["constraint_forces"]).max() > 0
