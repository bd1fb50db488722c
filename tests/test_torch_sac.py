"""The port's SAC `train_step` against the JAX package's, from the same
converted state, the same batch and the same Gaussian draws
(ilswiss_tpu_torch/algorithms/sac.py vs ilswiss_tpu/algorithms/sac.py).

Tolerance rtol 2e-4, atol 2e-5: the pin of tests/test_fused_sac.py for two
float32 implementations of the same update that sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

OBS, ACT, H, B = 11, 3, 32, 16
RTOL, ATOL = 2e-4, 2e-5
CFG = dict(reward_scale=2.0, beta_1=0.5, q_target_max=0.5)


def _batch(rng):
    return {
        "obs": rng.randn(B, OBS).astype(np.float32),
        "action": np.tanh(rng.randn(B, ACT)).astype(np.float32),
        "reward": rng.randn(B).astype(np.float32),
        "next_obs": rng.randn(B, OBS).astype(np.float32),
        "terminal": (rng.rand(B) < 0.2).astype(np.float32),
    }


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=path)


def _jax_numpy(state):
    s = jax.tree.map(np.asarray, state)
    opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu, "nu": o[0].nu}
    return {"policy_params": s.policy_params, "qf_params": s.qf_params,
            "target_qf_params": s.target_qf_params,
            "log_alpha": s.log_alpha, "policy_opt": opt(s.policy_opt),
            "qf_opt": opt(s.qf_opt), "alpha_opt": opt(s.alpha_opt)}


@pytest.fixture(scope="module")
def runs():
    """JAX reference: 3 train_steps with their keys and batches."""
    jsac = JSAC(OBS, ACT, JSACConfig(**CFG), net_size=H, num_hidden_layers=2)
    jstate = jsac.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    step = jax.jit(jsac.train_step)
    states, metrics, eps = [jstate], [], []
    for b, k in zip(batches, keys):
        k_next, k_new = jax.random.split(k)
        eps.append(tuple(np.asarray(jax.random.normal(kk, (B, ACT)))
                         for kk in (k_next, k_new)))
        s, m = step(states[-1], {n: jnp.asarray(v) for n, v in b.items()}, k)
        states.append(s)
        metrics.append(jax.tree.map(np.asarray, m))
    return jax.tree.map(np.asarray, states[0]), states, metrics, batches, eps


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(runs, n_steps):
    jstate0, jstates, jmetrics, batches, eps = runs
    sac = SAC(OBS, ACT, SACConfig(**CFG), net_size=H, num_hidden_layers=2,
              device="cpu")
    state = convert.sac_state_from_jax(sac, jstate0)
    for i in range(n_steps):
        batch = {k: torch.as_tensor(v) for k, v in batches[i].items()}
        state, metrics = sac.train_step(
            state, batch, torch.as_tensor(eps[i][0]),
            torch.as_tensor(eps[i][1]))
        for k, v in jmetrics[i].items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    got = convert.sac_state_to_numpy(state)
    want = _jax_numpy(jstates[n_steps])
    for name in ("policy_opt", "qf_opt", "alpha_opt"):
        assert got[name]["count"] == want[name]["count"] == n_steps
    _assert_tree_close(got, want)


def test_bridge_round_trip(runs):
    jstate0 = runs[0]
    sac = SAC(OBS, ACT, SACConfig(), net_size=H, num_hidden_layers=2,
              device="cpu")
    got = convert.sac_state_to_numpy(convert.sac_state_from_jax(sac, jstate0))
    want = _jax_numpy(jstate0)
    for name in ("policy_opt", "qf_opt", "alpha_opt"):
        assert got[name]["count"] == want[name]["count"]
    jax.tree.map(np.testing.assert_array_equal, got, want)


def test_act_matches_jax(runs):
    """Stochastic and deterministic acting from the same converted
    params and the same N(0, 1) draw."""
    jstate0 = jax.tree.map(jnp.asarray, runs[0])
    jsac = JSAC(OBS, ACT, JSACConfig(), net_size=H, num_hidden_layers=2)
    sac = SAC(OBS, ACT, SACConfig(), net_size=H, num_hidden_layers=2,
              device="cpu")
    state = convert.sac_state_from_jax(sac, runs[0])
    obs = np.random.RandomState(3).randn(5, OBS).astype(np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (5, ACT)))
    want = jsac.act(jstate0, jnp.asarray(obs), key)
    got = sac.act(state, torch.as_tensor(obs), torch.as_tensor(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    want_det = jsac.act(jstate0, jnp.asarray(obs), key, deterministic=True)
    got_det = sac.act(state, torch.as_tensor(obs), deterministic=True)
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det),
                               rtol=2e-5, atol=2e-5)
