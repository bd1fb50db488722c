"""The port's fused K-step SAC chain (ilswiss_tpu_torch/ops/fused_sac.py)
against the JAX package's Pallas kernel run in interpret mode with float32
products (ilswiss_tpu/ops/fused_sac.py, as tests/test_fused_sac.py runs
it), against K eager `train_step` calls of the port (the hand-derived
backward against autograd), and inside `OffPolicyLoop`.

On the CPU `fused_sac_chain` takes its plain version; kernel K2 itself is
held against the plain version on a card in tests/test_torch_gpu.py, and,
in the last test here, as a CPU build of its CUDA source on host threads
(ilswiss_tpu_torch/kernels/host_build.py).

Tolerances are the pins of tests/test_fused_sac.py:91-121: parameters and
targets rtol 2e-4, atol 2e-5; log alpha 1e-5, 1e-6; mu 2e-4, 2e-6; nu
2e-3, 1e-8; metrics 5e-4, 5e-5.  The loop comparison uses 5e-4, 5e-5 as
tests/test_fused_sac.py:124-156 does.
"""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.ops.fused_sac import fused_sac_chain as jax_fused_sac_chain
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.ops import fused_sac
from ilswiss_tpu_torch.ops.fused_sac import fused_sac_chain
from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

OBS, ACT, H, B, K = 5, 2, 32, 32, 3
JAX_CASES = [(0.9, 2.0), (0.25, 1.0)]
OPTS = ("policy_opt", "qf_opt", "alpha_opt")


def _inputs(seed, k=K, b=B, obs=OBS, act=ACT):
    """(batches [k, b, ...], eps_next, eps_new) as numpy float32."""
    rng = np.random.RandomState(seed)
    f = lambda x: x.astype(np.float32)
    batches = {
        "obs": f(rng.randn(k, b, obs)),
        "action": f(np.tanh(rng.randn(k, b, act))),
        "reward": f(rng.randn(k, b)),
        "terminal": f(rng.rand(k, b) < 0.2),
        "next_obs": f(rng.randn(k, b, obs)),
    }
    return batches, f(rng.randn(k, b, act)), f(rng.randn(k, b, act))


def _jax_numpy(state):
    s = jax.tree.map(np.asarray, state)
    opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu, "nu": o[0].nu}
    return {"policy_params": s.policy_params, "qf_params": s.qf_params,
            "target_qf_params": s.target_qf_params,
            "log_alpha": s.log_alpha, **{n: opt(getattr(s, n)) for n in OPTS}}


def _assert_states_close(got, want):
    """Two states in the JAX layouts, at the pins of test_fused_sac.py."""
    for name in ("policy_params", "qf_params", "target_qf_params"):
        jax.tree.map(
            lambda g, w: np.testing.assert_allclose(
                g, w, rtol=2e-4, atol=2e-5, err_msg=name),
            got[name], want[name])
    np.testing.assert_allclose(got["log_alpha"], want["log_alpha"],
                               rtol=1e-5, atol=1e-6)
    for name in OPTS:
        assert got[name]["count"] == want[name]["count"], name
        np.testing.assert_allclose(got[name]["mu"], want[name]["mu"],
                                   rtol=2e-4, atol=2e-6, err_msg=name)
        np.testing.assert_allclose(got[name]["nu"], want[name]["nu"],
                                   rtol=2e-3, atol=1e-8, err_msg=name)


def _assert_metrics_close(got, want):
    assert set(got) == set(fused_sac.METRIC_NAMES) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=5e-4, atol=5e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX start state, the inputs, and the state and metrics
    after the interpret-mode float32 Pallas chain."""
    runs = {}
    for beta_1, reward_scale in JAX_CASES:
        jsac = JSAC(OBS, ACT, JSACConfig(reward_scale=reward_scale,
                                         beta_1=beta_1),
                    net_size=H, num_hidden_layers=2)
        jstate = jsac.init(jax.random.PRNGKey(0))
        batches, eps_next, eps_new = _inputs(1)
        jnew, jmetrics = jax_fused_sac_chain(
            jsac, jstate, {k: jnp.asarray(v) for k, v in batches.items()},
            jnp.asarray(eps_next), jnp.asarray(eps_new),
            interpret=True, matmul_dtype=jnp.float32)
        runs[beta_1, reward_scale] = (
            jax.tree.map(np.asarray, jstate), (batches, eps_next, eps_new),
            _jax_numpy(jnew), jax.tree.map(np.asarray, jmetrics))
    return runs


@pytest.mark.parametrize("beta_1,reward_scale", JAX_CASES)
def test_plain_chain_matches_jax_kernel(jax_runs, beta_1, reward_scale):
    jstate0, (batches, eps_next, eps_new), want, want_metrics = \
        jax_runs[beta_1, reward_scale]
    sac = SAC(OBS, ACT, SACConfig(reward_scale=reward_scale, beta_1=beta_1),
              net_size=H, num_hidden_layers=2, device="cpu")
    state = convert.sac_state_from_jax(sac, jstate0)
    state, metrics = fused_sac_chain(
        sac, state, convert.batches_from_numpy(batches, "cpu"),
        torch.as_tensor(eps_next), torch.as_tensor(eps_new))
    _assert_states_close(convert.sac_state_to_numpy(state), want)
    _assert_metrics_close(convert.metrics_to_numpy(metrics), want_metrics)


def _port_pair(cfg, hidden=H, layers=2, count=0, log_std_bias=None):
    """Two identical port states (for the chain and for eager steps)."""
    sac = SAC(OBS, ACT, cfg, net_size=hidden, num_hidden_layers=layers,
              device="cpu")
    states = [sac.init(3), sac.init(3)]
    for s in states:
        for opt in (s.policy_opt, s.qf_opt, s.alpha_opt):
            opt.count = count
        if log_std_bias is not None:
            with torch.no_grad():
                s.policy.log_std.bias.copy_(torch.tensor(log_std_bias))
    return sac, states


def _eager(sac, state, batches, eps_next, eps_new):
    rows = []
    for k in range(eps_next.shape[0]):
        state, m = sac.train_step(
            state, {n: v[k] for n, v in batches.items()}, eps_next[k],
            eps_new[k])
        rows.append(m)
    return state, {n: torch.stack([m[n] for m in rows]) for n in rows[0]}


EAGER_CASES = {
    "default": dict(cfg=SACConfig()),
    "scaled": dict(cfg=SACConfig(reward_scale=2.0, beta_1=0.5)),
    "fixed_alpha": dict(cfg=SACConfig(train_alpha=False, init_alpha=0.3)),
    "q_clip": dict(cfg=SACConfig(q_target_min=-0.2, q_target_max=0.3)),
    # the first log-std sits above 2, where its gradient is masked (at
    # -20 the hand-derived formula cancels terms of size e^20, so that
    # side is checked without autograd below)
    "log_std_outside": dict(cfg=SACConfig(), log_std_bias=[2.5, -1.0]),
    "from_count_7": dict(cfg=SACConfig(beta_1=0.25), count=7),
    "one_layer": dict(cfg=SACConfig(), layers=1),
    "three_layers": dict(cfg=SACConfig(), layers=3, hidden=16),
}


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_plain_chain_matches_eager_train_steps(case):
    """The hand-derived backward against autograd: one chain of K steps
    and K `train_step` calls from the same state and draws."""
    kw = dict(EAGER_CASES[case])
    cfg = kw.pop("cfg")
    sac, (chained, stepped) = _port_pair(cfg, **kw)
    count0 = kw.get("count", 0)
    batches, eps_next, eps_new = _inputs(2)
    batches = convert.batches_from_numpy(batches, "cpu")
    eps_next, eps_new = torch.as_tensor(eps_next), torch.as_tensor(eps_new)
    log_alpha0 = float(chained.log_alpha.detach())

    chained, got_metrics = fused_sac_chain(sac, chained, batches, eps_next,
                                           eps_new)
    stepped, want_metrics = _eager(sac, stepped, batches, eps_next, eps_new)

    got = convert.sac_state_to_numpy(chained)
    _assert_states_close(got, convert.sac_state_to_numpy(stepped))
    _assert_metrics_close(convert.metrics_to_numpy(got_metrics),
                          convert.metrics_to_numpy(want_metrics))
    assert chained.policy_opt.count == chained.qf_opt.count == count0 + K
    if cfg.train_alpha:
        assert chained.alpha_opt.count == count0 + K
        assert float(chained.log_alpha.detach()) != log_alpha0
    else:
        # alpha, its moments and its count do not move
        assert chained.alpha_opt.count == count0
        assert float(chained.log_alpha.detach()) == log_alpha0
        assert float(chained.alpha_opt.mu[0]) == 0.0
        assert float(chained.alpha_opt.nu[0]) == 0.0
    for v in got_metrics.values():
        assert tuple(v.shape) == (K,)
    if case == "log_std_outside":
        mu = _moment_of(chained, chained.policy.log_std.bias)
        assert mu[0] == 0.0 and mu[1] != 0.0


def _moment_of(state, param):
    index = [id(p) for p in state.policy_opt.params].index(id(param))
    return state.policy_opt.mu[index]


def test_log_std_gradient_mask_is_the_open_interval():
    """A raw log-std exactly at 2 or at -20 takes no gradient: the head's
    weights and biases, and their moments, do not move."""
    sac, (state, _) = _port_pair(SACConfig())
    head = state.policy.log_std
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.tensor([2.0, -20.0]))
    batches, eps_next, eps_new = _inputs(5)
    state, metrics = fused_sac_chain(
        sac, state, convert.batches_from_numpy(batches, "cpu"),
        torch.as_tensor(eps_next), torch.as_tensor(eps_new))
    assert torch.all(head.weight == 0.0)
    assert torch.equal(head.bias.detach(), torch.tensor([2.0, -20.0]))
    assert torch.all(_moment_of(state, head.bias) == 0.0)
    assert torch.all(_moment_of(state, head.weight) == 0.0)
    assert torch.all(_moment_of(state, state.policy.mean.bias) != 0.0)


def test_q_clip_changes_the_update():
    """The clip case above is not vacuous: the clip moves the critics."""
    batches, eps_next, eps_new = _inputs(2)
    batches = convert.batches_from_numpy(batches, "cpu")
    eps_next, eps_new = torch.as_tensor(eps_next), torch.as_tensor(eps_new)
    finals = []
    for cfg in (SACConfig(), SACConfig(q_target_min=-0.2, q_target_max=0.3)):
        sac, (state, _) = _port_pair(cfg)
        state, _ = fused_sac_chain(sac, state, batches, eps_next, eps_new)
        finals.append(state.qf.output_bias.detach().clone())
    assert not torch.allclose(finals[0], finals[1], rtol=0, atol=1e-6)


def test_shared_adam_step_comes_from_the_policy_count():
    """All three optimizers are corrected at t = policy_opt.count + k + 1:
    a critic count that lags does not change the update, and each count
    advances by K from where it stood."""
    batches, eps_next, eps_new = _inputs(4)
    batches = convert.batches_from_numpy(batches, "cpu")
    eps_next, eps_new = torch.as_tensor(eps_next), torch.as_tensor(eps_new)
    sac, (a, b) = _port_pair(SACConfig(), count=5)
    b.qf_opt.count = 2
    a, _ = fused_sac_chain(sac, a, batches, eps_next, eps_new)
    b, _ = fused_sac_chain(sac, b, batches, eps_next, eps_new)
    for x, y in zip(a.qf.parameters(), b.qf.parameters()):
        assert torch.equal(x, y)
    assert (a.qf_opt.count, b.qf_opt.count) == (5 + K, 2 + K)
    assert a.policy_opt.count == b.policy_opt.count == 5 + K


# ---- the loop ---------------------------------------------------------------

NUM_ENVS, LOOP_BATCH, LOOP_H, LOOP_K = 2, 8, 16, 3


def _loop(use_fused_chain):
    vec = make_vec("hopper", NUM_ENVS, device="cpu")
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=LOOP_H, num_hidden_layers=2, use_fused_act=True,
              use_fused_chain=use_fused_chain, device="cpu")
    cfg = OffPolicyConfig(batch_size=LOOP_BATCH, replay_capacity=64,
                          min_steps_before_training=4,
                          grad_steps_per_iter=LOOP_K)
    return OffPolicyLoop(vec, sac, cfg)


def test_fused_loop_matches_eager_loop():
    """OffPolicyLoop with `use_fused_chain=True` reproduces the eager
    loop's state and metrics after two training iterations from the same
    seed: same draws in the same order, one chain per iteration."""
    finals = []
    for flag in (False, True):
        loop = _loop(flag)
        before = fused_sac_chain.launches
        runner = loop.warmup(loop.init(7))
        runner, metrics = loop.train_epoch(runner,
                                           steps_per_epoch=2 * NUM_ENVS)
        assert fused_sac_chain.launches == before   # CPU: the plain version
        finals.append((runner, metrics))
    (eager, eager_metrics), (fused, fused_metrics) = finals
    tol = dict(rtol=5e-4, atol=5e-5)
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(g, w, **tol),
        convert.sac_state_to_numpy(fused.algo_state),
        convert.sac_state_to_numpy(eager.algo_state))
    assert fused.algo_state.policy_opt.count == 2 * LOOP_K
    for k, v in eager_metrics.items():
        np.testing.assert_allclose(fused_metrics[k], v, **tol, err_msg=k)
    # the env, the ring and the noise stream went the same way
    np.testing.assert_allclose(fused.env_state.obs.numpy(),
                               eager.env_state.obs.numpy(), rtol=2e-4,
                               atol=5e-3)
    assert fused.replay.ptr == eager.replay.ptr
    assert torch.equal(fused.noise.act((3,)), eager.noise.act((3,)))


def test_train_chain_draws_in_the_eager_order():
    """`train_chain` asks the noise for `replay` then `train`, step by
    step, as the eager loop does."""
    loop = _loop(True)
    runner = loop.warmup(loop.init(0))
    calls = []

    class Recording:
        def replay(self, n):
            calls.append("replay")
            return runner.noise.replay(n)

        def train(self, shape):
            calls.append("train")
            return runner.noise.train(shape)

    loop.algo.train_chain(runner.algo_state, runner.replay, Recording(),
                          LOOP_BATCH, LOOP_K)
    assert calls == ["replay", "train"] * LOOP_K


# ---- what the kernel's wrapper refuses ---------------------------------------

def _kernel_case(**sizes):
    sizes = {"obs": OBS, "act": ACT, "hidden": 16, "layers": 2, "b": 8,
             **sizes}
    sac = SAC(sizes["obs"], sizes["act"], SACConfig(),
              net_size=sizes["hidden"], num_hidden_layers=sizes["layers"],
              device="cpu")
    batches, eps_next, eps_new = _inputs(0, k=2, b=sizes["b"],
                                         obs=sizes["obs"], act=sizes["act"])
    return (sac, sac.init(0), convert.batches_from_numpy(batches, "cpu"),
            torch.as_tensor(eps_next), torch.as_tensor(eps_new))


def test_kernel_inputs_accepts_the_small_shapes():
    sac, state, batches, eps_next, eps_new = _kernel_case()
    streams, tensors = fused_sac._kernel_inputs(sac, state, batches,
                                                eps_next, eps_new)
    # 7 streams; 6 tensors per policy layer, 8 per critic layer, 3 for alpha
    assert len(streams) == 7
    assert len(tensors) == 6 * 4 + 8 * 3 + 3


@pytest.mark.parametrize("fault", ["float64", "non_contiguous", "bad_shape",
                                   "batch_over_limit", "actions_over_limit",
                                   "layers_over_limit", "width_over_limit"])
def test_kernel_inputs_rejects(fault):
    """The checks run before anything is built, so they run without a
    card: the wrapper raises ValueError instead of launching."""
    sizes = {"batch_over_limit": dict(b=fused_sac.MAX_BATCH + 1),
             "actions_over_limit": dict(act=fused_sac.MAX_ACTION + 1),
             "layers_over_limit": dict(layers=fused_sac.MAX_HIDDEN + 1,
                                       hidden=4),
             "width_over_limit": dict(hidden=fused_sac.MAX_WIDTH + 1, b=2),
             }.get(fault, {})
    sac, state, batches, eps_next, eps_new = _kernel_case(**sizes)
    if fault == "float64":
        eps_new = eps_new.double()
    elif fault == "non_contiguous":
        batches["obs"] = batches["obs"].transpose(0, 1).contiguous() \
            .transpose(0, 1)
        assert not batches["obs"].is_contiguous()
    elif fault == "bad_shape":
        batches["reward"] = batches["reward"][:, :, None]
    with pytest.raises(ValueError):
        fused_sac._kernel_inputs(sac, state, batches, eps_next, eps_new)


# ---- the CUDA source itself, compiled for the CPU ---------------------------

HOST_CASES = {
    # obs, act, hidden, layers, b, k, config, Adam count at the start
    "two_layers": (5, 2, 32, 2, 32, 2, SACConfig(reward_scale=2.0), 0),
    "ragged_tiles_three_layers": (5, 2, 70, 3, 70, 2,
                                  SACConfig(beta_1=0.25, q_target_max=0.5),
                                  5),
    "one_layer_fixed_alpha": (4, 1, 20, 1, 9, 2,
                              SACConfig(train_alpha=False), 0),
}


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    from ilswiss_tpu_torch.kernels.host_build import build_host
    return fused_sac._declare(
        ctypes.CDLL(str(build_host("fused_sac", "SacArgs"))))


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_kernel_source_on_host_threads_matches_plain(host_lib, case):
    """csrc/fused_sac.cu, compiled by g++ against the host shim and run on
    three blocks of CPU threads through the wrapper's own launch code,
    against the plain chain: the kernel's indexing, phases and barriers,
    without a card.  Tolerances as on the card."""
    obs, act, hidden, layers, b, k, cfg, count0 = HOST_CASES[case]
    sac = SAC(obs, act, cfg, net_size=hidden, num_hidden_layers=layers,
              device="cpu")
    states = [sac.init(0), sac.init(0)]
    for st in states:
        for opt in (st.policy_opt, st.qf_opt, st.alpha_opt):
            opt.count = count0
    batches, eps_next, eps_new = _inputs(6, k=k, b=b, obs=obs, act=act)
    batches = convert.batches_from_numpy(batches, "cpu")
    eps_next, eps_new = torch.as_tensor(eps_next), torch.as_tensor(eps_new)

    streams, tensors = fused_sac._kernel_inputs(sac, states[0], batches,
                                                eps_next, eps_new)
    table = fused_sac._launch(host_lib, sac, states[0], streams, tensors,
                              None)
    fused_sac._advance_counts(states[0], k, cfg.train_alpha)
    got_metrics = {n: table[:, j].numpy()
                   for j, n in enumerate(fused_sac.METRIC_NAMES)}
    want, want_metrics = fused_sac.fused_sac_chain_plain(
        sac, states[1], batches, eps_next, eps_new)
    _assert_states_close(convert.sac_state_to_numpy(states[0]),
                         convert.sac_state_to_numpy(want))
    _assert_metrics_close(got_metrics,
                          convert.metrics_to_numpy(want_metrics))
