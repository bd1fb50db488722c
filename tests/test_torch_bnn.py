"""The ensemble dynamics model in the port (ilswiss_tpu_torch/envs/
terminals.py, models/bnn.py, algorithms/bnn_trainer.py) against the JAX
package's (ilswiss_tpu/envs/terminals.py, models/bnn.py,
algorithms/bnn_trainer.py).

Inputs come from a numpy seed; the JAX state is carried across by
utils/convert.py, and the draws of a JAX `BNNTrainer.train` (the holdout
permutation, the bootstrap rows, and each epoch's numpy row shuffles) are
rebuilt from its key and replayed to the port in the port's documented
order.  Pins: forwards rtol 1e-5, atol 1e-6; updates rtol 2e-4, atol 2e-5
(tests/test_torch_offpolicy_trainers.py's); terminal flags, elites and
epoch counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.algorithms.bnn_trainer import BNNTrainer as JBNNTrainer
from ilswiss_tpu.algorithms.bnn_trainer import (
    BNNTrainerConfig as JBNNTrainerConfig,
)
from ilswiss_tpu.envs.terminals import TERMINAL_REGISTRY as JTERMINALS
from ilswiss_tpu.models import bnn as jbnn
from ilswiss_tpu_torch.algorithms.bnn_trainer import (
    BNNTrainer, BNNTrainerConfig,
)
from ilswiss_tpu_torch.envs.terminals import (
    TERMINAL_REGISTRY, get_terminal_func,
)
from ilswiss_tpu_torch.models import bnn
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
PIN = dict(rtol=2e-4, atol=2e-5)
OBS, ACT, E, ELITES, H, BATCH = 3, 1, 3, 2, (16, 16), 16


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _jax_numpy(jstate):
    """The JAX BNNState in `convert.bnn_state_to_numpy`'s layout."""
    s = jax.tree.map(np.asarray, jstate)
    adam = s.opt_state[0]
    return {"params": s.params,
            "opt_state": {"count": int(adam.count), "mu": adam.mu,
                          "nu": adam.nu},
            "normalizer": {"mean": s.normalizer.mean,
                           "std": s.normalizer.std},
            "elites": s.elites, "holdout_mse": s.holdout_mse}


def _config(**kw):
    base = dict(num_nets=E, num_elites=ELITES, hidden_sizes=H,
                batch_size=BATCH, holdout_ratio=0.2)
    base.update(kw)
    return base


def _trainers(**kw):
    cfg = _config(**kw)
    return (JBNNTrainer(OBS, ACT, JBNNTrainerConfig(**cfg)),
            BNNTrainer(OBS, ACT, BNNTrainerConfig(**cfg), device="cpu"))


def _data(seed, n):
    """Smooth synthetic dynamics: next = obs + 0.1 act + 0.05 sin(obs),
    reward -|obs|_1."""
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (n, ACT)).astype(np.float32)
    return {"obs": obs, "action": act,
            "reward": (-np.abs(obs).sum(-1)).astype(np.float32),
            "next_obs": (obs + 0.1 * act + 0.05 * np.sin(obs)).astype(
                np.float32)}


def _perturbed(jstate, seed, scale=0.2):
    """The JAX state with every parameter moved away from its init."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + scale * rng.randn(*x.shape),
                              jnp.float32), jstate.params)
    return jstate.replace(params=params)


# --- the terminal predicates ---------------------------------------------------
def _terminal_rows():
    """64 rows of 11 columns spread over every predicate's thresholds, and
    rows with a NaN, an inf or a |value| >= 100 mixed in."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 11).astype(np.float32) * 3.0
    x[:, 0] = rng.uniform(-3.0, 3.0, 64)
    x[:, 1] = rng.uniform(-1.5, 1.5, 64)
    x[:, 2] = rng.uniform(-0.4, 0.4, 64)
    x[0, 0] = np.nan
    x[1, 5] = np.nan
    x[2, 3] = np.inf
    x[3, 0] = -np.inf
    x[4, 1] = np.nan
    x[5, 7] = 150.0
    x[6, 0], x[6, 1] = 1.0, 0.0           # healthy in every predicate but
    x[6, 4] = -np.inf                     # for the inf
    x[7, 1:] = 0.0                        # an infinite height, every other
    x[7, 0] = np.inf                      # test passed: hopper's isfinite
    return x


@pytest.mark.parametrize("name", sorted(JTERMINALS))
def test_terminal_predicates_match_jax(name):
    assert set(TERMINAL_REGISTRY) == set(JTERMINALS)
    rows = _terminal_rows()
    obs, act = np.zeros_like(rows), np.zeros((64, 2), np.float32)
    want = np.asarray(JTERMINALS[name](jnp.asarray(obs), jnp.asarray(act),
                                       jnp.asarray(rows)))
    got = get_terminal_func(name)(torch.as_tensor(obs), torch.as_tensor(act),
                                  torch.as_tensor(rows))
    assert got.dtype == torch.bool and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    if name not in ("pendulum", "halfcheetah", "swimmer"):
        assert 0 < want.sum() < 64, want.sum()


def test_terminal_registry_names_unknown_envs():
    with pytest.raises(KeyError, match="no terminal fn"):
        get_terminal_func("no_such_env")


# --- the model ---------------------------------------------------------------
def test_fit_input_normalizer_matches_jax():
    rng = np.random.RandomState(1)
    x = (2.0 * rng.randn(40, 5) + rng.randn(5)).astype(np.float32)
    x[:, 3] = 1.25                         # a constant column: std -> 1
    want = jbnn.fit_input_normalizer(jnp.asarray(x))
    got = bnn.fit_input_normalizer(torch.as_tensor(x))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), **FWD)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), **FWD)
    assert float(got.std[0, 3]) == 1.0
    y = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_allclose(got(torch.as_tensor(y)).numpy(),
                               np.asarray(want(jnp.asarray(y))), **FWD)


def test_bnn_init_follows_the_jax_rules():
    """A fresh port model without the bridge: fan-in uniform kernels and
    bias 0.1 in the hidden layers, +-3e-3 in last_fc, the log-variance
    bounds at 0.5 and -10, the flax shapes."""
    model = bnn.BNN(OBS + ACT, (32, 32, 32), 1 + OBS, 5,
                    torch.Generator().manual_seed(0))
    widths = [OBS + ACT, 32, 32, 32]
    for i, layer in enumerate(model.layers()[:-1]):
        bound = 1.0 / widths[i] ** 0.5
        assert layer.kernel.shape == (5, widths[i], 32)
        assert layer.bias.shape == (5, 1, 32)
        top = float(layer.kernel.detach().abs().max())
        assert 0.9 * bound < top <= bound
        assert torch.all(layer.bias == 0.1)
    last = model.last_fc
    assert last.kernel.shape == (5, 32, 2 * (1 + OBS))
    assert float(last.kernel.detach().abs().max()) <= 3e-3
    assert float(last.bias.detach().abs().max()) <= 3e-3
    assert torch.all(model.max_log_var == 0.5)
    assert torch.all(model.min_log_var == -10.0)
    assert model.max_log_var.shape == (1, 1 + OBS)


@pytest.mark.parametrize("ensemble_input", [False, True],
                         ids=["shared", "per_net"])
def test_bnn_forward_matches_flax(ensemble_input):
    jtr, tr = _trainers()
    jstate = _perturbed(jtr.init(jax.random.PRNGKey(0)), 2, scale=0.5)
    state = convert.bnn_state_from_jax(tr, jax.tree.map(np.asarray, jstate))
    _close(convert.bnn_state_to_numpy(state), _jax_numpy(jstate),
           dict(rtol=0, atol=0))
    rng = np.random.RandomState(3)
    shape = (E, 9, OBS + ACT) if ensemble_input else (9, OBS + ACT)
    x = rng.randn(*shape).astype(np.float32)
    want = jtr.model.apply(jstate.params, jnp.asarray(x))
    with torch.no_grad():
        got = state.params(torch.as_tensor(x))
    for g, w in zip(got, want):
        assert g.shape == (E, 9, 1 + OBS)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


# --- one minibatch step ----------------------------------------------------------
def test_minibatch_step_matches_jax():
    """The second of two minibatch steps (so Adam's moments are away from
    zero) from a perturbed state: the loss, the parameters and the Adam
    state."""
    jtr, tr = _trainers()
    d = _data(4, 64)
    inputs = np.concatenate([d["obs"], d["action"]], -1)
    targets = np.concatenate([d["reward"][:, None],
                              d["next_obs"] - d["obs"]], -1)
    rng = np.random.RandomState(5)
    idx1, idx2 = (rng.randint(0, 64, (E, BATCH)) for _ in range(2))
    jstate = _perturbed(jtr.init(jax.random.PRNGKey(0)), 6)
    norm = jbnn.fit_input_normalizer(jnp.asarray(inputs))
    ji, jt = jnp.asarray(inputs), jnp.asarray(targets)
    params, opt, _ = jtr._epoch_fn(jstate.params, jstate.opt_state, norm,
                                   ji, jt, jnp.asarray(idx1))
    jstate = jstate.replace(params=params, opt_state=opt, normalizer=norm)
    state = convert.bnn_state_from_jax(tr, jax.tree.map(np.asarray, jstate))
    params, opt, jloss = jtr._epoch_fn(params, opt, norm, ji, jt,
                                       jnp.asarray(idx2))
    loss = tr.minibatch_step(state, torch.as_tensor(inputs[idx2]),
                             torch.as_tensor(targets[idx2]))
    np.testing.assert_allclose(float(loss), float(jloss), **PIN)
    assert state.opt_state.count == 2
    _close(convert.bnn_state_to_numpy(state),
           _jax_numpy(jstate.replace(params=params, opt_state=opt)), PIN)


# --- BNNTrainer.train ------------------------------------------------------
class _Draws:
    """The port's `Noise` methods `train` takes, answering each call with
    the next JAX draw; a call out of the documented order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        return torch.as_tensor(np.array(value), dtype=torch.int64)

    def permutation(self, n):
        return self._pop("permutation")

    def bootstrap(self, num_nets, n):
        return self._pop("bootstrap")

    def shuffle(self, num_nets, n):
        return self._pop("shuffle")


def train_draws(key, n_total, n_train, num_nets, epochs):
    """Every draw of a JAX `BNNTrainer.train` from its key, in the port's
    order (bnn_trainer.py: split into perm / boot / shuf keys, then a numpy
    generator seeded from the shuffle key permutes each net's row once an
    epoch)."""
    k_perm, k_boot, k_shuf = jax.random.split(key, 3)
    seq = [("permutation", jax.random.permutation(k_perm, n_total)),
           ("bootstrap", jax.random.randint(k_boot, (num_nets, n_train), 0,
                                            n_train))]
    rng = np.random.default_rng(int(jax.device_get(k_shuf)[0]))
    for _ in range(epochs):
        seq.append(("shuffle", rng.permuted(np.broadcast_to(
            np.arange(n_train), (num_nets, n_train)).copy(), axis=1)))
    return seq


# max_epochs: stops at 3; early_stop: stops at the first epoch in which no
# net improves by more than 1% (on this data the fourth).  Both at a larger
# lr than the default, so that every relative improvement lies far from
# the threshold, and in few steps: Adam divides each gradient by its own
# running size, and the two packages' rounding parts further with every
# step.
TRAIN_CASES = {"max_epochs": dict(lr=3e-3, max_epochs=3),
               "early_stop": dict(lr=1e-2, max_epochs_since_update=0)}
N_DATA = 120


@pytest.fixture(scope="module")
def train_runs():
    """Per case: the JAX state before and after `train`, its stats, and
    every holdout MSE it read from the device (one per epoch, then the
    final one)."""
    out = {}
    d = {k: jnp.asarray(v) for k, v in _data(7, N_DATA).items()}
    for name, kw in TRAIN_CASES.items():
        jtr, _ = _trainers(**kw)
        jstate = jtr.init(jax.random.PRNGKey(0))
        holdouts, device_get = [], jax.device_get

        def record(x):
            y = device_get(x)
            if isinstance(y, np.ndarray) and y.shape == (E,) \
                    and y.dtype == np.float32:
                holdouts.append(y)
            return y

        key = jax.random.PRNGKey(1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "device_get", record)
            jnext, stats = jtr.train(jstate, d, key)
        out[name] = dict(jstate=jstate, jnext=jnext, stats=stats, key=key,
                         holdouts=holdouts)
    return out


def _improvement_margin(holdouts):
    """The least distance of any net's relative holdout improvement from
    the 1% threshold, over the epochs of a JAX `train`."""
    best, margin = np.full((E,), 1e10), np.inf
    for h in holdouts:
        rel = (best - h) / best
        margin = min(margin, float(np.abs(rel - 0.01).min()))
        best = np.where(rel > 0.01, h, best)
    return margin


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_train_matches_jax(train_runs, name):
    """Both stopping rules: the epoch count exactly, the best parameters
    with the current Adam state, the normaliser, the elites exactly, the
    holdout MSEs and the stats, from the JAX draws replayed."""
    run = train_runs[name]
    stats = run["stats"]
    epochs = stats["bnn_epochs"]
    assert len(run["holdouts"]) == epochs + 1
    assert epochs == (3 if name == "max_epochs" else 4)
    # no net's improvement lies near the threshold, so rounding can flip
    # neither a snapshot nor the stop
    assert _improvement_margin(run["holdouts"][:-1]) > 1e-3
    n_train = N_DATA - int(N_DATA * 0.2)
    _, tr = _trainers(**TRAIN_CASES[name])
    state = convert.bnn_state_from_jax(tr, jax.tree.map(np.asarray,
                                                        run["jstate"]))
    noise = _Draws(train_draws(run["key"], N_DATA, n_train, E, epochs))
    data = {k: torch.as_tensor(v) for k, v in _data(7, N_DATA).items()}
    state, got = tr.train(state, data, noise)
    assert not noise.seq, "draws left over"
    assert set(got) == set(stats)
    assert got["bnn_epochs"] == epochs
    for k in ("bnn_train_loss", "bnn_holdout_mse"):
        np.testing.assert_allclose(got[k], stats[k], err_msg=k, **PIN)
    assert state.opt_state.count == epochs * (n_train // BATCH)
    got_state, want = convert.bnn_state_to_numpy(state), _jax_numpy(
        run["jnext"])
    np.testing.assert_array_equal(got_state.pop("elites"), want.pop("elites"))
    _close(got_state, want, PIN)


def test_predict_factored_matches_jax(train_runs):
    run = train_runs["early_stop"]
    _, tr = _trainers(**TRAIN_CASES["early_stop"])
    jtr = JBNNTrainer(OBS, ACT, JBNNTrainerConfig(
        **_config(**TRAIN_CASES["early_stop"])))
    state = convert.bnn_state_from_jax(tr, jax.tree.map(np.asarray,
                                                        run["jnext"]))
    d = _data(8, 11)
    want = jtr.predict_factored(run["jnext"], jnp.asarray(d["obs"]),
                                jnp.asarray(d["action"]))
    got = tr.predict_factored(state, torch.as_tensor(d["obs"]),
                              torch.as_tensor(d["action"]))
    for g, w in zip(got, want):
        assert g.shape == (E, 11, 1 + OBS)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
