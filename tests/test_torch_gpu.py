"""Kernels K1 and K3 against their plain PyTorch versions on a CUDA card
(ilswiss_tpu_torch/csrc/planar_forward.cu, csrc/fused_mlp.cu).

Every test here is marked `gpu` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py configures JAX.)  Tolerances: K1
rtol 2e-4, atol 5e-3 per forward evaluation and control step (the
planar pin of tests/test_planar_dynamics.py:97-98); K3 2e-5 (the pin of
tests/test_pallas_ops.py).
"""

import numpy as np
import pytest
import torch

from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.ops import fused_mlp
from ilswiss_tpu_torch.ops import planar_dynamics as pd

F32 = dict(rtol=2e-4, atol=5e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hopper", "walker", "halfcheetah",
                                  "invertedpendulum"])
def test_planar_kernel_matches_plain(name, cuda):
    """K1: one evaluation and one control step at a ragged B = 100."""
    m = _model(name)
    pm = pd.planar_model(m)
    damped = pm.integrator == "euler"
    rng = np.random.RandomState(3)
    B = 100
    q = m.qpos0[:, None] + 0.1 * rng.randn(m.nq, B)
    qd = 0.3 * rng.randn(m.nv, B)
    ctrl = np.clip(rng.randn(m.nu, B), -1, 1)
    f0 = 0.2 * np.abs(rng.randn(m.nrow, B))
    q, qd, ctrl, f0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
                       for x in (q, qd, ctrl, f0))
    before = pd.planar_forward.launches
    got = pd.planar_forward(pm, q, qd, ctrl, f0, 15, damped)
    torch.cuda.synchronize()
    assert pd.planar_forward.launches == before + 1
    want = pd._forward_math(pm, q, qd, ctrl, f0, 15,
                            pm.timestep if damped else None)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32)
    got = pd.planar_physics_step(m, q.t(), qd.t(), ctrl.t(), f0=f0.t())

    def plain(a, b, c, d, dm):
        return pd._forward_math(pm, a, b, c, d, 15,
                                pm.timestep if dm else None)

    want = pd._control_step(pm, plain, q, qd, ctrl, f0)
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g.t(), w, **F32)


@pytest.mark.gpu
def test_planar_kernel_rejects_bad_inputs(cuda):
    pm = pd.planar_model(_model("hopper"))
    q = torch.zeros(6, 8, device=cuda)
    with pytest.raises(ValueError):
        pd.planar_forward(pm, q.double(), q, q[:3], torch.zeros(
            38, 8, device=cuda), 15, False)
    with pytest.raises(ValueError):
        pd.planar_forward(pm, q, q, q[:3], torch.zeros(
            37, 8, device=cuda), 15, False)


@pytest.mark.gpu
def test_fused_policy_kernel_matches_plain(cuda):
    """K3 at the acting widths, B = 128 and a ragged 37."""
    gen = torch.Generator().manual_seed(0)
    policy = TanhGaussianPolicy(11, 3, (256, 256), gen).to(cuda)
    for B in (128, 37):
        obs = torch.randn(B, 11, generator=gen).to(cuda)
        before = fused_mlp.fused_gaussian_policy_forward.launches
        got = fused_mlp.fused_gaussian_policy_forward(policy, obs)
        torch.cuda.synchronize()
        assert fused_mlp.fused_gaussian_policy_forward.launches == before + 1
        with torch.no_grad():
            want = fused_mlp.policy_forward_plain(
                *fused_mlp._layers(policy), obs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
