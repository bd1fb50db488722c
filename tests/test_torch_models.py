"""The port's distributions, networks, policy and kernel K3's plain
version against the JAX package, on the same inputs and converted params
(ilswiss_tpu_torch/models/*, ops/fused_mlp.py vs ilswiss_tpu/models/*,
ops/fused_mlp.py).  Tolerance 2e-5: float32 products summed in different
orders, the pin of tests/test_pallas_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.models import distributions as JD
from ilswiss_tpu.models.networks import FlattenMLP as JFlattenMLP
from ilswiss_tpu.models.policies import TanhGaussianPolicy as JPolicy
from ilswiss_tpu.ops.fused_mlp import fused_gaussian_policy_forward as jfused
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import FlattenMLP
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.ops import fused_mlp
from ilswiss_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _policy_from_flax(params, obs_size, action_dim, hidden):
    policy = TanhGaussianPolicy(obs_size, action_dim, hidden,
                                torch.Generator().manual_seed(0))
    p = params["params"]
    with torch.no_grad():
        for name in [f"hidden_{i}" for i in range(len(hidden))] + [
                "mean", "log_std"]:
            layer = getattr(policy, name)
            layer.weight.copy_(torch.as_tensor(np.array(p[name]["kernel"]).T))
            layer.bias.copy_(torch.as_tensor(np.array(p[name]["bias"])))
    return policy


def test_distributions_match_jax():
    rng = np.random.RandomState(0)
    mean = rng.randn(6, 3).astype(np.float32)
    log_std = (rng.randn(6, 3) * 3).astype(np.float32)
    eps = rng.randn(6, 3).astype(np.float32)
    T = torch.as_tensor
    np.testing.assert_array_equal(
        D.clamp_log_std(T(log_std)).numpy(),
        np.asarray(JD.clamp_log_std(jnp.asarray(log_std))))
    ls = np.clip(log_std, -20.0, 2.0)
    a, pre = D.tanh_normal_sample(T(mean), T(ls), T(eps))
    z = mean + np.exp(ls) * eps
    np.testing.assert_allclose(pre.numpy(), z, **TOL)
    np.testing.assert_allclose(a.numpy(), np.tanh(z), **TOL)
    # the same action on both sides: log(1 - a^2 + eps) is ill-conditioned
    # where tanh saturates
    want = JD.tanh_normal_log_prob(jnp.asarray(mean), jnp.asarray(ls),
                                   jnp.asarray(a.numpy()), jnp.asarray(z))
    got = D.tanh_normal_log_prob(T(mean), T(ls), a, pre)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the atanh fallback branch
    act = np.tanh(rng.randn(6, 3)).astype(np.float32) * 0.9
    want = JD.tanh_normal_log_prob(jnp.asarray(mean), jnp.asarray(ls),
                                   jnp.asarray(act))
    got = D.tanh_normal_log_prob(T(mean), T(ls), T(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_bounds():
    gen = torch.Generator().manual_seed(0)
    qf = FlattenMLP(14, (64, 64), 1, gen)
    for i, fan_in in enumerate((14, 64)):
        layer = getattr(qf.mlp, f"hidden_{i}")
        assert float(layer.weight.abs().max()) <= 1.0 / np.sqrt(fan_in)
        assert float(layer.weight.abs().max()) > 0.5 / np.sqrt(fan_in)
        assert torch.all(layer.bias == 0.1)
    for t in (qf.mlp.output.weight, qf.mlp.output.bias):
        assert float(t.abs().max()) <= 3e-3 and float(t.abs().max()) > 0
    policy = TanhGaussianPolicy(11, 3, (64, 64), gen)
    for head in (policy.mean, policy.log_std):
        for t in (head.weight, head.bias):
            assert float(t.abs().max()) <= 1e-3 and float(t.abs().max()) > 0


def test_flatten_mlp_matches_flax():
    jq = JFlattenMLP(hidden_sizes=(32, 32), output_size=1)
    rng = np.random.RandomState(1)
    obs = rng.randn(8, 11).astype(np.float32)
    act = rng.randn(8, 3).astype(np.float32)
    params = jq.init(jax.random.PRNGKey(0), obs, act)
    want = jq.apply(params, obs, act)
    q = FlattenMLP(14, (32, 32), 1, torch.Generator().manual_seed(0))
    p = params["params"]["mlp"]
    with torch.no_grad():
        for name in ("hidden_0", "hidden_1", "output"):
            layer = getattr(q.mlp, name)
            layer.weight.copy_(torch.as_tensor(np.array(p[name]["kernel"]).T))
            layer.bias.copy_(torch.as_tensor(np.array(p[name]["bias"])))
    got = q(torch.as_tensor(obs), torch.as_tensor(act))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def policy_case():
    jp = JPolicy(action_dim=3, hidden_sizes=(64, 64))
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (32, 11)))
    params = jp.init(jax.random.PRNGKey(1), obs)
    return jp, params, obs


def test_policy_matches_flax(policy_case):
    jp, params, obs = policy_case
    want_mean, want_log_std = jp.apply(params, obs)
    policy = _policy_from_flax(params, 11, 3, (64, 64))
    mean, log_std = policy(torch.as_tensor(np.array(obs)))
    np.testing.assert_allclose(mean.detach().numpy(), want_mean, **TOL)
    np.testing.assert_allclose(log_std.detach().numpy(), want_log_std, **TOL)


def test_fused_policy_plain_matches_jax_kernel(policy_case):
    """K3's plain version (a CPU tensor) vs the Pallas kernel in
    interpret mode."""
    _, params, obs = policy_case
    want_mean, want_log_std = jfused(params, obs, interpret=True)
    policy = _policy_from_flax(params, 11, 3, (64, 64))
    before = fused_mlp.fused_gaussian_policy_forward.launches
    mean, log_std = fused_mlp.fused_gaussian_policy_forward(
        policy, torch.as_tensor(obs))
    assert fused_mlp.fused_gaussian_policy_forward.launches == before
    np.testing.assert_allclose(mean.numpy(), want_mean, **TOL)
    np.testing.assert_allclose(log_std.numpy(), want_log_std, **TOL)


def test_fused_policy_plain_clamps_log_std():
    jp = JPolicy(action_dim=2, hidden_sizes=(16,))
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 4))) * 100
    params = jp.init(jax.random.PRNGKey(1), obs)
    _, want = jfused(params, obs, interpret=True)
    policy = _policy_from_flax(params, 4, 2, (16,))
    _, log_std = fused_mlp.fused_gaussian_policy_forward(
        policy, torch.as_tensor(obs))
    assert float(log_std.max()) <= 2.0 and float(log_std.min()) >= -20.0
    np.testing.assert_allclose(log_std.numpy(), want, rtol=2e-5, atol=1e-4)


def test_resolve_device_needs_an_explicit_cpu():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_fused_policy_plain_matches_jax_kernel_at_humanoid_width():
    """K3's plain version at humanoid's acting shape, 348 -> 256 -> 256 ->
    17 + 17, B = 16, against the Pallas kernel in interpret mode (TOL)."""
    jp = JPolicy(action_dim=17, hidden_sizes=(256, 256))
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 348)))
    params = jp.init(jax.random.PRNGKey(3), obs)
    want_mean, want_log_std = jfused(params, obs, interpret=True)
    policy = _policy_from_flax(params, 348, 17, (256, 256))
    mean, log_std = fused_mlp.fused_gaussian_policy_forward(
        policy, torch.as_tensor(obs))
    np.testing.assert_allclose(mean.numpy(), want_mean, **TOL)
    np.testing.assert_allclose(log_std.numpy(), want_log_std, **TOL)


@pytest.mark.parametrize("obs_size,hidden,ok", [
    (348, (256, 256), True), (1024, (1024,), True), (1025, (64,), False),
    (11, (1025,), False)])
def test_fused_policy_kernel_widths(obs_size, hidden, ok):
    """K3 takes every layer up to 1024 wide, the input included, and
    refuses wider ones before anything is built."""
    policy = TanhGaussianPolicy(obs_size, 3, hidden, torch.Generator())
    weights, biases = fused_mlp._layers(policy)
    weights = [w.detach() for w in weights]
    biases = [b.detach() for b in biases]
    obs = torch.zeros(2, obs_size)
    if ok:
        assert fused_mlp._kernel_dims(weights, biases, obs) == \
            [obs_size] + list(hidden)
    else:
        with pytest.raises(ValueError):
            fused_mlp._kernel_dims(weights, biases, obs)
