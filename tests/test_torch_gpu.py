"""Kernels K1, K2, K3 and K4 against their plain PyTorch versions on a CUDA
card (ilswiss_tpu_torch/csrc/planar_forward.cu, csrc/fused_sac.cu,
csrc/fused_mlp.cu, csrc/pgs.cu).

Every test here is marked `gpu` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py configures JAX.)  Tolerances: K1
rtol 2e-4, atol 5e-3 per forward evaluation and control step (the
planar pin of tests/test_planar_dynamics.py:97-98); K3 2e-5 (the pin of
tests/test_pallas_ops.py); K2 the pins of tests/test_fused_sac.py:91-121
(parameters and targets rtol 2e-4, atol 2e-5; log alpha 1e-5, 1e-6; mu
2e-4, 2e-6; nu 2e-3, 1e-8; metrics 5e-4, 5e-5); K4 rtol 2e-4, atol 1e-4
(the pin of tests/test_pgs_pallas.py:50-51), and inside the engine rtol
2e-4, atol 5e-3 on values divided by max(1, max |plain|).
"""

import numpy as np
import pytest
import torch

from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.ops import fused_mlp, fused_sac, pgs
from ilswiss_tpu_torch.ops import planar_dynamics as pd
from ilswiss_tpu_torch.ops import rigid_body as rb

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


def _chain_inputs(seed, K, B, n_obs, n_act, device):
    rng = np.random.RandomState(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    batches = {"obs": f(rng.randn(K, B, n_obs)),
               "action": f(np.tanh(rng.randn(K, B, n_act))),
               "reward": f(rng.randn(K, B)),
               "terminal": f(rng.rand(K, B) < 0.2),
               "next_obs": f(rng.randn(K, B, n_obs))}
    return batches, f(rng.randn(K, B, n_act)), f(rng.randn(K, B, n_act))


K2_CASES = {
    # n_obs, n_act, width, layers, B, K, config, Adam count at the start
    "small": (5, 2, 32, 2, 32, 3, SACConfig(reward_scale=2.0), 0),
    "full_width": (11, 3, 256, 2, 512, 4, SACConfig(), 0),
    "one_layer_fixed_alpha": (4, 1, 20, 1, 9, 2,
                              SACConfig(train_alpha=False), 0),
    "three_layers_clip_from_count_5": (
        5, 2, 70, 3, 70, 2,
        SACConfig(beta_1=0.25, q_target_min=-0.2, q_target_max=0.3), 5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_fused_sac_kernel_matches_plain(case, cuda):
    """K2: one launch of K steps against the plain chain from the same
    seeded state and inputs."""
    n_obs, n_act, width, layers, B, K, cfg, count0 = K2_CASES[case]
    sac = SAC(n_obs, n_act, cfg, net_size=width, num_hidden_layers=layers,
              device=cuda)
    states = [sac.init(0), sac.init(0)]
    for st in states:
        for opt in (st.policy_opt, st.qf_opt, st.alpha_opt):
            opt.count = count0
    batches, eps_next, eps_new = _chain_inputs(1, K, B, n_obs, n_act, cuda)
    before = fused_sac.fused_sac_chain.launches
    got, got_m = fused_sac.fused_sac_chain(sac, states[0], batches, eps_next,
                                           eps_new)
    torch.cuda.synchronize()
    assert fused_sac.fused_sac_chain.launches == before + 1
    want, want_m = fused_sac.fused_sac_chain_plain(sac, states[1], batches,
                                                   eps_next, eps_new)
    for g, w in zip(
            list(got.policy.parameters()) + list(got.qf.parameters())
            + list(got.target_qf.parameters()),
            list(want.policy.parameters()) + list(want.qf.parameters())
            + list(want.target_qf.parameters())):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.log_alpha, want.log_alpha, rtol=1e-5,
                               atol=1e-6)
    for name in ("policy_opt", "qf_opt", "alpha_opt"):
        g_opt, w_opt = getattr(got, name), getattr(want, name)
        assert g_opt.count == w_opt.count
        for g, w in zip(g_opt.mu, w_opt.mu):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-6)
        for g, w in zip(g_opt.nu, w_opt.nu):
            torch.testing.assert_close(g, w, rtol=2e-3, atol=1e-8)
    assert got.policy_opt.count == count0 + K
    for name in fused_sac.METRIC_NAMES:
        assert tuple(got_m[name].shape) == (K,)
        torch.testing.assert_close(got_m[name], want_m[name], rtol=5e-4,
                                   atol=5e-5)


@pytest.mark.gpu
def test_fused_sac_kernel_is_deterministic(cuda):
    """Two launches from the same state and inputs give the same bits:
    every reduction in K2 has a fixed order."""
    sac = SAC(11, 3, SACConfig(), net_size=256, num_hidden_layers=2,
              device=cuda)
    batches, eps_next, eps_new = _chain_inputs(2, 3, 512, 11, 3, cuda)
    finals = []
    for _ in range(2):
        st, m = fused_sac.fused_sac_chain(sac, sac.init(0), batches,
                                          eps_next, eps_new)
        finals.append([p.detach().clone() for p in st.policy.parameters()]
                      + [p.detach().clone() for p in st.qf.parameters()]
                      + [m[n].clone() for n in fused_sac.METRIC_NAMES])
    for x, y in zip(*finals):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_fused_sac_kernel_rejects_bad_inputs(cuda):
    sac = SAC(5, 2, SACConfig(), net_size=16, num_hidden_layers=2,
              device=cuda)
    batches, eps_next, eps_new = _chain_inputs(0, 2, 8, 5, 2, cuda)
    before = fused_sac.fused_sac_chain.launches
    with pytest.raises(ValueError):
        fused_sac.fused_sac_chain(sac, sac.init(0), batches,
                                  eps_next.double(), eps_new)
    with pytest.raises(ValueError):
        fused_sac.fused_sac_chain(sac, sac.init(0), batches, eps_next.cpu(),
                                  eps_new)
    assert fused_sac.fused_sac_chain.launches == before


def _pgs_problem(nr, nv, B, device):
    """A seeded instance shaped like the engine's: J random, M = I + small
    SPD, W = M^-1 J^T, 70% of the rows active."""
    rng = np.random.RandomState(nr)
    J = rng.randn(B, nr, nv)
    S = 0.2 * rng.randn(B, nv, nv)
    W = np.linalg.solve(np.eye(nv)[None] + S @ S.transpose(0, 2, 1),
                        J.transpose(0, 2, 1))
    Rreg = rng.uniform(0.05, 0.5, (B, nr))
    b = rng.randn(B, nr)
    D = np.einsum("brv,bvr->br", J, W) + Rreg
    active = torch.tensor(rng.rand(B, nr) < 0.7, device=device)
    f0 = np.abs(rng.randn(B, nr))
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return f(J), f(W), f(Rreg), f(b), f(D), active, f(f0)


@pytest.mark.gpu
@pytest.mark.parametrize("nr,nv,B", [(6, 4, 4), (38, 6, 9), (116, 14, 128),
                                     (150, 23, 128)])
def test_pgs_kernel_matches_plain(nr, nv, B, cuda):
    """K4: 15 sweeps against the plain version; inactive rows exactly zero,
    forces >= 0; W read through column-major strides gives the same bits."""
    args = _pgs_problem(nr, nv, B, cuda)
    before = pgs.pgs_solve.launches
    got = pgs.pgs_solve(*args, 15)
    torch.cuda.synchronize()
    assert pgs.pgs_solve.launches == before + 1
    want = pgs.pgs_solve_plain(*args, 15)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-4)
    assert bool((got[~args[5]] == 0.0).all()) and bool((got >= 0.0).all())
    W_cols = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(got, pgs.pgs_solve(args[0], W_cols, *args[2:], 15))


@pytest.mark.gpu
def test_pgs_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits: K4 has no
    atomics and a fixed reduction order."""
    args = _pgs_problem(116, 14, 128, cuda)
    assert torch.equal(pgs.pgs_solve(*args, 15), pgs.pgs_solve(*args, 15))


@pytest.mark.gpu
def test_pgs_kernel_rejects_bad_inputs(cuda):
    J, W, Rreg, b, D, active, f0 = _pgs_problem(6, 4, 4, cuda)
    wide = _pgs_problem(6, pgs.MAX_NV + 1, 2, cuda)
    tall = _pgs_problem(pgs.MAX_ROWS + 1, 3, 1, cuda)
    before = pgs.pgs_solve.launches
    for bad in ((J.double(), W.double(), Rreg.double(), b.double(),
                 D.double(), active, f0.double()),
                wide, tall,
                (J, W, Rreg, b, D, active.float(), f0),
                (J, W, Rreg, b, D, active, f0.cpu())):
        with pytest.raises(ValueError):
            pgs.pgs_solve(*bad, 15)
    assert pgs.pgs_solve.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ant", "humanoid", "swimmer",
                                  "inverteddoublependulum"])
def test_engine_with_kernel_matches_plain_solve(name, cuda):
    """K4 inside the general engine: one control step at a ragged B = 100
    with the kernel against the same with the plain solve named."""
    m = _model(name)
    rng = np.random.RandomState(7)
    B = 100
    q = m.qpos0 + 0.1 * rng.randn(B, m.nq)
    if name in ("ant", "humanoid"):
        q[:, 2] = (0.45 if name == "ant" else 1.25) + 0.1 * rng.rand(B)
    qd = 0.5 * rng.randn(B, m.nv)
    ctrl = np.clip(rng.randn(B, m.nu), -1, 1)
    f0 = 0.2 * np.abs(rng.randn(B, m.nrow))
    q, qd, ctrl, f0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
                       for x in (q, qd, ctrl, f0))
    evaluations = 4 * m.frame_skip
    before = pgs.pgs_solve.launches
    got = rb.physics_step(m, q, qd, ctrl, iters=15, f0=f0)
    torch.cuda.synchronize()
    assert pgs.pgs_solve.launches == before + evaluations
    want = rb.physics_step(m, q, qd, ctrl, iters=15, f0=f0,
                           solve=pgs.pgs_solve_plain)
    assert pgs.pgs_solve.launches == before + evaluations
    for g, w in zip(got[:4], want[:4]):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g / scale, w / scale, rtol=2e-4,
                                   atol=5e-3)
