"""Kernels K1, K2, K3 and K4 against their plain PyTorch versions on a CUDA
card (ilswiss_tpu_torch/csrc/planar_forward.cu, csrc/fused_sac.cu,
csrc/fused_mlp.cu, csrc/pgs.cu).

Every test here is marked `gpu` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py configures JAX.)  Tolerances: K1
rtol 2e-4, atol 5e-3 per forward evaluation and control step (the
planar pin of tests/test_planar_dynamics.py:97-98); K3 2e-5 (the pin of
tests/test_pallas_ops.py); K2 in each mode the pins of `K2_PINS` in
ilswiss_tpu_torch/testing.py (the float32 pins of
tests/test_fused_sac.py:91-121, and in bf16 mode mu 2e-2, 2e-5 and nu
1e-2, 1e-8), where at widths over 32 in bf16 mode the parameters, mu and
nu are held by `bf16_gate` instead: per group, at most a third as many
elements outside the pins as the plain float32 mode has against the
plain bf16 mode on the same state and inputs (testing.py says why).  K4
rtol 2e-4, atol 1e-4 (the pin of tests/test_pgs_pallas.py:50-51), and
inside the engine rtol 2e-4, atol 5e-3 on values divided by max(1, max
|plain|).
"""

import numpy as np
import pytest
import torch

from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs._locomotion_params import PARAMS
from ilswiss_tpu_torch.envs.locomotion import _model
from ilswiss_tpu_torch.kernels.engine_profile import grounded_state
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.ops import fused_mlp, fused_sac, pgs
from ilswiss_tpu_torch.ops import planar_dynamics as pd
from ilswiss_tpu_torch.ops import rigid_body as rb
from ilswiss_tpu_torch.testing import GATED, K2_PINS, bf16_gate, k2_groups

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
@pytest.mark.parametrize("name", ["hopper", "walker", "halfcheetah",
                                  "invertedpendulum"])
def test_planar_control_step_is_one_launch(name, cuda):
    """K1's control-step mode at B = 128: one launch, within F32 of
    `_control_step` over `_forward_math`, and two launches bit-equal."""
    m = _model(name)
    pm = pd.planar_model(m)
    rng = np.random.RandomState(5)
    B = 128
    q = m.qpos0[:, None] + 0.1 * rng.randn(m.nq, B)
    qd = 0.3 * rng.randn(m.nv, B)
    ctrl = np.clip(rng.randn(m.nu, B), -1, 1)
    f0 = 0.2 * np.abs(rng.randn(m.nrow, B))
    q, qd, ctrl, f0 = (torch.tensor(x, dtype=torch.float32, device=cuda)
                       for x in (q, qd, ctrl, f0))
    before = (pd.planar_forward.launches, pd.planar_control_step.launches)
    got = pd.planar_control_step(pm, q, qd, ctrl, f0, 15)
    torch.cuda.synchronize()
    assert (pd.planar_forward.launches,
            pd.planar_control_step.launches) == (before[0], before[1] + 1)

    def plain(a, b, c, d, dm):
        return pd._forward_math(pm, a, b, c, d, 15,
                                pm.timestep if dm else None)

    want = pd._control_step(pm, plain, q, qd, ctrl, f0)
    flat = lambda s: [s[0], s[1], s[2], s[3], *s[4]]
    for g, w in zip(flat(got), flat(want)):
        torch.testing.assert_close(g, w, **F32)
    again = pd.planar_control_step(pm, q, qd, ctrl, f0, 15)
    for g, w in zip(flat(got), flat(again)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_fused_policy_kernel_at_humanoid_width(cuda):
    """K3 at humanoid's acting shape (348 -> 256 -> 256 -> 17 + 17) and at
    the widest it takes (1024 -> 1024 -> 1024), B = 128 and 37."""
    gen = torch.Generator().manual_seed(1)
    for obs_size, act, hidden in ((348, 17, (256, 256)),
                                  (1024, 4, (1024, 1024))):
        policy = TanhGaussianPolicy(obs_size, act, hidden, gen).to(cuda)
        for B in (128, 37):
            obs = torch.randn(B, obs_size, generator=gen).to(cuda)
            got = fused_mlp.fused_gaussian_policy_forward(policy, obs)
            torch.cuda.synchronize()
            with torch.no_grad():
                want = fused_mlp.policy_forward_plain(
                    *fused_mlp._layers(policy), obs)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 17, 128])
@pytest.mark.parametrize("obs_size,hidden,act", [
    (11, (256, 256), 3), (348, (256, 256), 17), (40, (1024,), 5),
    (20, (64, 48, 32, 16), 4)])
def test_fused_policy_kernel_shapes(obs_size, hidden, act, B, cuda):
    """K3's cluster launch at the shapes its host rehearsal covers
    (tests/test_torch_fused_mlp.py): hopper's and humanoid's acting shapes,
    one layer of 1024, four hidden layers; one launch, two launches
    bit-equal."""
    gen = torch.Generator().manual_seed(B)
    policy = TanhGaussianPolicy(obs_size, act, hidden, gen).to(cuda)
    obs = torch.randn(B, obs_size, generator=gen).to(cuda)
    before = fused_mlp.fused_gaussian_policy_forward.launches
    got = fused_mlp.fused_gaussian_policy_forward(policy, obs)
    torch.cuda.synchronize()
    assert fused_mlp.fused_gaussian_policy_forward.launches == before + 1
    with torch.no_grad():
        want = fused_mlp.policy_forward_plain(*fused_mlp._layers(policy), obs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    again = fused_mlp.fused_gaussian_policy_forward(policy, obs)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


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
def test_planar_kernel_takes_an_empty_batch(cuda):
    """B = 0: empty outputs, and neither wrapper counts a launch."""
    pm = pd.planar_model(_model("hopper"))
    q, f0 = torch.zeros(6, 0, device=cuda), torch.zeros(38, 0, device=cuda)
    before = (pd.planar_forward.launches, pd.planar_control_step.launches)
    got = pd.planar_forward(pm, q, q, q[:3], f0, 15, False)
    assert [tuple(g.shape) for g in got] == [(6, 0), (6, 0), (38, 0)]
    got = pd.planar_control_step(pm, q, q, q[:3], f0, 15)
    assert tuple(got[0].shape) == (6, 0) and tuple(got[3].shape) == (38, 0)
    assert (pd.planar_forward.launches,
            pd.planar_control_step.launches) == before


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
    "humanoid_width": (348, 17, 256, 2, 512, 4, SACConfig(), 0),
}


def _k2_runs(case, cuda):
    """A function that runs one chain of `case` (the kernel or the plain
    version, in one mode) from the case's seeded state and inputs, and
    returns (state, metrics)."""
    n_obs, n_act, width, layers, B, K, cfg, count0 = K2_CASES[case]
    sac = SAC(n_obs, n_act, cfg, net_size=width, num_hidden_layers=layers,
              device=cuda)
    batches, eps_next, eps_new = _chain_inputs(1, K, B, n_obs, n_act, cuda)

    def run(chain, dtype):
        st = sac.init(0)
        for opt in (st.policy_opt, st.qf_opt, st.alpha_opt):
            opt.count = count0
        out = chain(sac, st, batches, eps_next, eps_new, dtype)
        torch.cuda.synchronize()
        return out
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_fused_sac_kernel_matches_plain(case, dtype, cuda):
    """K2: one launch of K steps against the plain chain in the same mode
    from the same seeded state and inputs, at the mode's pins; in bf16
    mode at widths over 32 the parameters, mu and nu under `bf16_gate`,
    with the plain float32 mode as its control."""
    n_obs, n_act, width, layers, B, K, cfg, count0 = K2_CASES[case]
    run = _k2_runs(case, cuda)
    before = fused_sac.fused_sac_chain.launches
    got, got_m = run(fused_sac.fused_sac_chain, dtype)
    assert fused_sac.fused_sac_chain.launches == before + 1
    want, want_m = run(fused_sac.fused_sac_chain_plain, dtype)
    gated = dtype == torch.bfloat16 and width > 32
    g, w = k2_groups(got, got_m), k2_groups(want, want_m)
    for name in g:
        assert all(torch.isfinite(x).all() for x in g[name]), name
        if gated and name in GATED:
            continue
        rtol, atol = K2_PINS[dtype][name]
        for x, y in zip(g[name], w[name]):
            torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
    if gated:
        control = k2_groups(*run(fused_sac.fused_sac_chain_plain,
                                 torch.float32))
        gate = bf16_gate(g, w, control)
        assert all(ok for _, _, ok in gate.values()), gate
    for name in ("policy_opt", "qf_opt", "alpha_opt"):
        assert getattr(got, name).count == getattr(want, name).count
    assert got.policy_opt.count == count0 + K
    for name in fused_sac.METRIC_NAMES:
        assert tuple(got_m[name].shape) == (K,)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in sorted(K2_CASES)
                                  if K2_CASES[c][2] > 32])
def test_bf16_gate_refuses_the_float32_mode(case, cuda):
    """The gate's own control: K2 in float32 mode, held against the plain
    bf16 mode as the bf16 kernel is above, fails `bf16_gate`, so the gate
    tells a kernel that ignores `matmul_dtype` from one that honours it."""
    run = _k2_runs(case, cuda)
    wrong = k2_groups(*run(fused_sac.fused_sac_chain, torch.float32))
    plain = k2_groups(*run(fused_sac.fused_sac_chain_plain, torch.bfloat16))
    control = k2_groups(*run(fused_sac.fused_sac_chain_plain, torch.float32))
    gate = bf16_gate(wrong, plain, control)
    assert not all(ok for _, _, ok in gate.values()), gate


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_fused_sac_kernel_is_deterministic(dtype, cuda):
    """Two launches from the same state and inputs give the same bits in
    each mode: every reduction in K2 has a fixed order."""
    sac = SAC(11, 3, SACConfig(), net_size=256, num_hidden_layers=2,
              device=cuda)
    batches, eps_next, eps_new = _chain_inputs(2, 3, 512, 11, 3, cuda)
    finals = []
    for _ in range(2):
        st, m = fused_sac.fused_sac_chain(sac, sac.init(0), batches,
                                          eps_next, eps_new, dtype)
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
@pytest.mark.parametrize("pattern", ["none", "all", "first", "last",
                                     "alternating", "random"])
def test_pgs_kernel_mask_patterns(pattern, cuda):
    """K4 walks only each env's active rows: any mask, against the plain
    version, which walks every row, in the layout the kernel takes on each
    side of the SM count (B = 100: 4 lanes an env; B = 1000: 32 lanes an
    env, several envs a block); nv 23 is no multiple of the lanes."""
    for B in (100, 1000):
        J, W, Rreg, b, D, _, f0 = _pgs_problem(38, 23, B, cuda)
        r = torch.arange(38, device=cuda).expand(B, 38)
        gen = torch.Generator().manual_seed(0)
        active = {"none": r < 0, "all": r >= 0, "first": r == 0,
                  "last": r == 37, "alternating": r % 2 == 1,
                  "random": (torch.rand(B, 38, generator=gen) < 0.3).to(cuda)
                  }[pattern].contiguous()
        args = (J, W, Rreg, b, D, active, f0)
        got = pgs.pgs_solve(*args, 15)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, pgs.pgs_solve_plain(*args, 15),
                                   rtol=2e-4, atol=1e-4)
        assert bool((got[~active] == 0.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ant", "humanoid"])
def test_pgs_kernel_on_the_engines_rows(name, cuda):
    """K4 on the rows one `forward` of 128 grounded envs hands its solve."""
    from ilswiss_tpu_torch.kernels.engine_profile import engine_rows
    args = engine_rows(_model(name), name, 128, cuda)
    got = pgs.pgs_solve(*args, 15)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pgs.pgs_solve_plain(*args, 15),
                               rtol=2e-4, atol=1e-4)
    assert bool((got[~args[5]] == 0.0).all()) and bool((got >= 0.0).all())
    assert torch.equal(got, pgs.pgs_solve(*args, 15))


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


def _graph_counts():
    s = rb.physics_step
    return s.graph_captures, s.graph_replays, s.eager_calls


def _step_outputs(out):
    q, qd, con, f, (q_ev, qd_ev) = out
    return q, qd, con, f, q_ev, qd_ev


@pytest.mark.gpu
@pytest.mark.parametrize("name,B", [("ant", 64), ("humanoid", 64),
                                    ("swimmer", 64), ("ant", 1)])
def test_graphed_step_matches_eager(name, B, cuda):
    """The control step as one CUDA graph against the same step run
    eagerly from the same inputs, over five consecutive steps that carry
    the state and the warm start: every output within 1e-6 after dividing
    by max(1, max |eager|); the outputs kept from one step are unchanged by
    the next; one capture, then one replay a step, each adding the step's
    K4 launches to `pgs_solve.launches` (20 on ant)."""
    m = rb.RigidModel(PARAMS[name])          # no graph captured yet
    q, qd, ctrl, f0 = grounded_state(m, name, B, 5, cuda)
    evaluations = m.frame_skip * (1 if m.integrator == "euler" else 4)
    start, kept = _graph_counts(), None
    for _ in range(5):
        before = pgs.pgs_solve.launches
        got = rb.physics_step(m, q, qd, ctrl, iters=15, f0=f0)
        assert pgs.pgs_solve.launches == before + evaluations
        want = rb._eager_step(m, q, qd, ctrl, 15, f0, pgs.pgs_solve)
        torch.cuda.synchronize()
        if kept is not None:
            for k, snapshot in zip(*kept):
                assert torch.equal(k, snapshot)
        for g, w in zip(_step_outputs(got), _step_outputs(want)):
            scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
            torch.testing.assert_close(g / scale, w / scale, rtol=1e-6,
                                       atol=1e-6)
        kept = (_step_outputs(got),
                [t.clone() for t in _step_outputs(got)])
        q, qd, f0 = got[0], got[1], got[3]
    assert _graph_counts() == (start[0] + 1, start[1] + 4, start[2])
    assert list(m._graphs) == [(B, 15, q.device)]


@pytest.mark.gpu
def test_step_inside_a_capture_runs_eager(cuda):
    """A caller capturing a graph of its own gets the eager step inside
    it: the engine captures and replays nothing and counts one eager call,
    and a replay of the caller's graph gives the eager step's outputs."""
    m = rb.RigidModel(PARAMS["ant"])
    q, qd, ctrl, f0 = grounded_state(m, "ant", 16, 6, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # the capture's warm-up
        want = rb._eager_step(m, q, qd, ctrl, 15, f0, pgs.pgs_solve)
    torch.cuda.synchronize()
    start = _graph_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = rb.physics_step(m, q, qd, ctrl, iters=15, f0=f0)
    assert _graph_counts() == (start[0], start[1], start[2] + 1)
    assert not m._graphs
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(_step_outputs(got), _step_outputs(want)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_bf16_pixel_encoder_on_the_card(cuda):
    """The visual path's encoder at the spec's width (4 convs of 32, 64 px,
    batch 128) with its default bf16 convs on the card (cuDNN) against the
    same weights in float32 on the card and on the CPU: features within
    atol 3e-2, the bf16 pin of tests/test_torch_visual.py."""
    from ilswiss_tpu_torch.models.encoders import PixelEncoder

    enc = PixelEncoder(64, 3, torch.Generator().manual_seed(0))
    x = torch.rand((128, 64, 64, 3), generator=torch.Generator()
                   .manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # float32 convs, not TF32
    try:
        with torch.no_grad():
            enc.compute_dtype = torch.float32
            want = enc(x)
            enc = enc.to(cuda)
            f32 = enc(x.to(cuda)).cpu()
            enc.compute_dtype = torch.bfloat16
            bf16 = enc(x.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(f32, want, rtol=1e-4, atol=1e-4)
    gap = float((bf16 - f32).abs().max())
    assert gap <= 3e-2, gap
    assert bool(torch.isfinite(bf16).all())
