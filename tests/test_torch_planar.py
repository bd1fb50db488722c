"""Kernel K1's plain version and the planar integrators against the JAX
package (ilswiss_tpu_torch/ops/planar_dynamics.py vs
ilswiss_tpu/ops/planar_dynamics.py and ilswiss_tpu/ops/rigid_body.py).

Tolerances: float64 forward rtol 1e-9, atol 1e-8 (the pin of
tests/test_planar_dynamics.py:50-56: the same formulas in the same order);
float32 control steps rtol 2e-4, atol 5e-3 (the pin of :97-98: 16
evaluations of 15 Gauss-Seidel sweeps each in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.ops.rigid_body as jrb
from ilswiss_tpu.envs.locomotion import _model as jmodel
from ilswiss_tpu.ops import planar_dynamics as jpd
from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.ops import planar_dynamics as pd

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=5e-3)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _rand_state(m, rng, B=None, scale=0.2):
    shape = () if B is None else (B,)
    q = m.qpos0 + scale * rng.randn(*shape, m.nq)
    qd = rng.randn(*shape, m.nv)
    ctrl = np.clip(rng.randn(*shape, m.nu), -1, 1)
    f0 = np.abs(rng.randn(*shape, m.nrow)) * 0.2
    return q, qd, ctrl, f0


@pytest.mark.parametrize("name", ["hopper", "walker", "halfcheetah",
                                  "invertedpendulum"])
def test_forward_plain_matches_jax_f64(name, x64):
    """One forward evaluation: `_forward_math` vs the JAX per-env
    reference, eagerly at float64 (halfcheetah: the damped branch;
    invertedpendulum: no contacts)."""
    m = jmodel(name)
    pm = pd.planar_model(_model(name))
    damped = pm.integrator == "euler"
    h = pm.timestep if damped else None
    q, qd, ctrl, f0 = _rand_state(m, np.random.RandomState(0))
    with jax.disable_jit():
        want = jpd.planar_forward_single(
            m, *(jnp.asarray(x) for x in (q, qd, ctrl, f0)), iters=15,
            h_damp=h)
    col = lambda x: torch.tensor(x, dtype=torch.float64)[:, None]
    got = pd._forward_math(pm, col(q), col(qd), col(ctrl), col(f0), 15, h)
    assert len(got) == len(want) == (4 if damped else 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w),
                                   rtol=1e-9, atol=1e-8)


def test_nonplanar_models_are_rejected():
    """The planar path refuses every model that is not a planar chain;
    `physics_step_auto` hands those to the general engine instead."""
    from ilswiss_tpu_torch.envs._locomotion_params import PARAMS
    from ilswiss_tpu_torch.ops.rigid_body import RigidModel
    for name in ("ant", "humanoid", "swimmer", "inverteddoublependulum"):
        m = RigidModel(PARAMS[name])
        assert pd.planar_model(m) is None
        with pytest.raises(ValueError):
            pd.planar_physics_step(m, None, None, None)
    m = RigidModel(PARAMS["swimmer"])
    before = pd.planar_forward.launches
    q = torch.as_tensor(m.qpos0, dtype=torch.float32)[None]
    out = pd.physics_step_auto(m, q, torch.zeros(1, m.nv),
                               torch.zeros(1, m.nu))
    assert tuple(out[0].shape) == (1, m.nq) and torch.isfinite(out[0]).all()
    assert pd.planar_forward.launches == before


def test_control_step_plain_matches_jax_integrator():
    """The port's batched `_control_step` over the plain forward vs the
    JAX `_control_step` over vmap(planar_forward_single), hopper, B = 2,
    float32; the JAX forward is compiled once and reused by all 16
    evaluations."""
    B = 2
    m = jmodel("hopper")
    pm = pd.planar_model(_model("hopper"))
    jpm = jpd.planar_model(m)
    q, qd, ctrl, f0 = (x.astype(np.float32) for x in _rand_state(
        m, np.random.RandomState(1), B=B, scale=0.1))
    single = jax.vmap(lambda a, b, c, d: jpd.planar_forward_single(
        m, a, b, c, d, iters=15))
    compiled = jax.jit(single).lower(
        *(jnp.asarray(x) for x in (q, qd, ctrl, f0))).compile()

    def call(qT, qdT, cT, fT):
        out = compiled(qT.T, qdT.T, cT.T, fT.T)
        return tuple(np.ascontiguousarray(np.asarray(x).T) for x in out)

    shapes = tuple(jax.ShapeDtypeStruct((n, B), jnp.float32)
                   for n in (m.nv, m.nv, m.nrow))

    def jfwd(qT, qdT, cT, fT, damped):
        assert not damped
        return jax.pure_callback(call, shapes, qT, qdT, cT, fT)

    want = jpd._control_step(jpm, jfwd, *(jnp.asarray(x.T) for x in
                                           (q, qd, ctrl, f0)))
    rows = lambda x: torch.as_tensor(x.T.copy())

    def fwd(q_, qd_, c_, f_, damped):
        return pd.planar_forward(pm, q_, qd_, c_, f_, 15, damped)

    got = pd._control_step(pm, fwd, rows(q), rows(qd), rows(ctrl), rows(f0))
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    for g, w, lbl in zip(flat(got), flat(want),
                         ("q", "qd", "con", "f", "q_ev", "qd_ev")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32,
                                   err_msg=lbl)


@pytest.mark.slow
def test_physics_step_matches_jax_engine():
    """The port's `planar_physics_step` (plain forward) vs the JAX general
    engine's `physics_step` under vmap, hopper, float32."""
    B = 2
    m = jmodel("hopper")
    q, qd, ctrl, _ = (x.astype(np.float32) for x in _rand_state(
        m, np.random.RandomState(2), B=B, scale=0.1))
    f0 = np.zeros((B, m.nrow), np.float32)
    want = jax.jit(jax.vmap(lambda a, b, c, d: jrb.physics_step(
        m, a, b, c, iters=15, f0=d)))(q, qd, ctrl, f0)
    T = torch.as_tensor
    got = pd.planar_physics_step(_model("hopper"), T(q), T(qd), T(ctrl),
                                 iters=15, f0=T(f0))
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    for g, w, lbl in zip(flat(got), flat(want),
                         ("q", "qd", "con", "f", "q_ev", "qd_ev")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32,
                                   err_msg=lbl)


def test_kernel_constants_fit():
    """Every planar model packs into the kernel's constant table."""
    for name in ("hopper", "walker", "halfcheetah", "invertedpendulum"):
        pm = pd.planar_model(_model(name))
        c = pd.planar_consts(pm)
        assert (c.nv, c.nrow, c.ncon) == (pm.nv, pm.nrow, pm.ncon)


@pytest.mark.parametrize("name", ["hopper", "walker", "halfcheetah"])
def test_plain_float32_tracks_float64(name):
    """The plain version at float32 stays within the float32 pin of its
    own float64 result on the inputs chip_smoke.py uses (0.1 pose and 0.3
    velocity noise, B = 128): the pin covers rounding through the 15
    unconverged sweeps, which is what separates K1 from it on the card."""
    m = _model(name)
    pm = pd.planar_model(m)
    g = torch.Generator().manual_seed(0)
    B, f64 = 128, torch.float64
    q = (torch.tensor(m.qpos0, dtype=f64)[:, None]
         + 0.1 * torch.randn(m.nq, B, generator=g, dtype=f64))
    qd = 0.3 * torch.randn(m.nv, B, generator=g, dtype=f64)
    ctrl = torch.randn(m.nu, B, generator=g, dtype=f64).clamp(-1.0, 1.0)
    f0 = 0.2 * torch.randn(m.nrow, B, generator=g, dtype=f64).abs()
    h = pm.timestep if pm.integrator == "euler" else None
    want = pd._forward_math(pm, q, qd, ctrl, f0, 15, h)
    got = pd._forward_math(pm, q.float(), qd.float(), ctrl.float(),
                           f0.float(), 15, h)
    for g32, w64 in zip(got, want):
        np.testing.assert_allclose(g32.double().numpy(), w64.numpy(), **F32)
