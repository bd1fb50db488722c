"""Ensemble dynamics-model trainer with holdout early stopping
(counterpart: ilswiss_tpu/algorithms/bnn_trainer.py; `BNNTrainerConfig`,
`BNNState`, `BNNTrainer`).

The same fit as the JAX trainer:
  - loss of one minibatch: the mean over nets of
    mean((mu - y)^2 / var) + mean(logvar), plus the bound term
    0.01 * mean(max_lv) - 0.01 * mean(min_lv), plus the per-layer L2
    0.5 * wd * sum(W^2 + b^2) with decays [2.5e-5, 5e-5, 7.5e-5 ...,
    1e-4] inside the loss (not an optimiser weight decay).  As in the JAX
    trainer the decays are zipped with the layers, so with two hidden
    layers the list [2.5e-5, 1e-4] covers fc0 and fc1 and `last_fc` has
    none;
  - Adam at `lr` (optax's defaults, `algorithms/sac.py::Adam`);
  - `train` is host-driven: each call fits the input moments on the
    training rows, starts `best_mse` at 1e10, and after each epoch takes a
    net's snapshot where its holdout MSE improved by more than 1%
    (relative, in float64 on the host).  Leaves whose leading dim is
    `num_nets` are taken per net; the others (the log-variance bounds)
    take the current value.  It stops after more than
    `max_epochs_since_update` epochs without an improvement, at
    `max_epochs`, or at `max_grad_steps`; the best parameters come back
    with the CURRENT Adam moments, and the elites are the `num_elites`
    lowest final holdout MSEs.

`train` updates the state IN PLACE (the model's parameters, the moments,
the normaliser, elites and holdout MSEs) and returns it.  Its draws come
from a `Noise` (runtime/loop.py), in this order: `permutation(N)` (the
holdout split), `bootstrap(E, N_train)` (each net's rows), then one
`shuffle(E, N_train)` per epoch, which permutes each net's row of the
bootstrap indices (composed over the epochs, as the JAX trainer's numpy
shuffles are).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models.bnn import (
    BNN, InputNormalizer, fit_input_normalizer,
)
from ilswiss_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BNNTrainerConfig:
    num_nets: int = 7
    num_elites: int = 5
    hidden_sizes: tuple = (200, 200, 200, 200)
    lr: float = 1e-3
    batch_size: int = 256
    max_epochs: int | None = None
    max_epochs_since_update: int = 5
    max_grad_steps: int | None = None
    holdout_ratio: float = 0.2
    max_holdout: int = 5000
    reward_scale: float = 1.0


@dataclass
class BNNState:
    params: BNN
    opt_state: Adam
    normalizer: InputNormalizer
    elites: torch.Tensor        # [num_elites] int64
    holdout_mse: torch.Tensor   # [num_nets]


class BNNTrainer:
    def __init__(self, obs_size: int, action_size: int,
                 config: BNNTrainerConfig = BNNTrainerConfig(),
                 device=None):
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.input_dim = obs_size + action_size
        self.target_dim = 1 + obs_size
        self.device = resolve_device(device)
        n_hidden = len(config.hidden_sizes)
        self.layer_decays = (
            [2.5e-5, 5e-5] + [7.5e-5] * (n_hidden - 2) + [1e-4]
            if n_hidden > 2 else [2.5e-5, 1e-4])

    def init(self, seed: int) -> BNNState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed`, then the tensors move to the trainer's device."""
        cfg = self.config
        model = BNN(self.input_dim, cfg.hidden_sizes, self.target_dim,
                    cfg.num_nets, torch.Generator().manual_seed(seed)
                    ).to(self.device)
        kw = dict(dtype=torch.float32, device=self.device)
        return BNNState(
            params=model,
            opt_state=Adam(model.parameters(), cfg.lr, 0.9),
            normalizer=InputNormalizer(
                mean=torch.zeros((1, self.input_dim), **kw),
                std=torch.ones((1, self.input_dim), **kw)),
            elites=torch.arange(cfg.num_elites, device=self.device),
            holdout_mse=torch.full((cfg.num_nets,), float("inf"), **kw))

    # ------------------------------------------------------------------
    @staticmethod
    def _nll(model: BNN, normalizer: InputNormalizer, inputs, targets,
             add_var_loss: bool) -> torch.Tensor:
        """Per-net loss [E]; inputs [E?, B, in], targets [E?, B, tgt]."""
        mean, logvar = model(normalizer(inputs))
        if targets.dim() == 2:
            targets = targets[None]
        if add_var_loss:
            return (torch.mean((mean - targets) ** 2 * torch.exp(-logvar),
                               dim=(-2, -1))
                    + torch.mean(logvar, dim=(-2, -1)))
        return torch.mean((mean - targets) ** 2, dim=(-2, -1))

    def _l2_penalty(self, model: BNN) -> torch.Tensor:
        total = 0.0
        for layer, wd in zip(model.layers(), self.layer_decays):
            total = total + 0.5 * wd * (torch.sum(layer.kernel ** 2)
                                        + torch.sum(layer.bias ** 2))
        return total

    def minibatch_step(self, state: BNNState, inputs: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
        """One Adam step on the minibatch inputs [E, B, in], targets
        [E, B, tgt] (each net its own rows), normalised by the state's
        moments, in place; returns the loss before the step."""
        model = state.params
        loss = (torch.mean(self._nll(model, state.normalizer, inputs,
                                     targets, add_var_loss=True))
                + 0.01 * torch.mean(model.max_log_var)
                - 0.01 * torch.mean(model.min_log_var)
                + self._l2_penalty(model))
        state.opt_state.step(state.opt_state.grad(loss))
        return loss.detach()

    @torch.no_grad()
    def _holdout(self, state: BNNState, inputs, targets) -> np.ndarray:
        return self._nll(state.params, state.normalizer, inputs, targets,
                         add_var_loss=False).cpu().numpy()

    # ------------------------------------------------------------------
    def train(self, state: BNNState, data: Dict[str, torch.Tensor], noise,
              log=None) -> Tuple[BNNState, Dict[str, float]]:
        """Fit the ensemble on `data` (obs, action, reward, next_obs of
        N rows), in place; returns (state, stats) with the keys
        `bnn_epochs`, `bnn_train_loss` and `bnn_holdout_mse`."""
        cfg = self.config
        obs = data["obs"]
        inputs = torch.cat([obs, data["action"]], dim=-1)
        targets = torch.cat([cfg.reward_scale * data["reward"][:, None],
                             data["next_obs"] - obs], dim=-1)
        n_total = inputs.shape[0]
        num_holdout = min(int(n_total * cfg.holdout_ratio), cfg.max_holdout)
        perm = noise.permutation(n_total)
        ho_inputs, ho_targets = (inputs[perm[:num_holdout]],
                                 targets[perm[:num_holdout]])
        tr_inputs, tr_targets = (inputs[perm[num_holdout:]],
                                 targets[perm[num_holdout:]])
        n_train = n_total - num_holdout
        n_batches = n_train // cfg.batch_size
        state.normalizer = fit_input_normalizer(tr_inputs)
        idxs = noise.bootstrap(cfg.num_nets, n_train)

        params = list(state.params.parameters())
        per_net = [p.shape[0] == cfg.num_nets for p in params]
        best = [p.detach().clone() for p in params]
        best_mse = np.full((cfg.num_nets,), 1e10)
        epochs_since_update = grad_steps = epoch = 0
        while True:
            idxs = torch.gather(idxs, 1, noise.shuffle(cfg.num_nets, n_train))
            losses = []
            for b in range(n_batches):
                rows = idxs[:, b * cfg.batch_size:(b + 1) * cfg.batch_size]
                losses.append(self.minibatch_step(state, tr_inputs[rows],
                                                  tr_targets[rows]))
            train_loss = (torch.stack(losses).mean() if losses
                          else torch.tensor(float("nan")))
            grad_steps += n_batches
            holdout = self._holdout(state, ho_inputs, ho_targets)

            improved = (best_mse - holdout) / best_mse > 0.01
            if improved.any():
                sel = torch.as_tensor(improved, device=self.device)
                with torch.no_grad():
                    for b, p, net in zip(best, params, per_net):
                        if net:
                            mask = sel.reshape((-1,) + (1,) * (p.dim() - 1))
                            b.copy_(torch.where(mask, p, b))
                        else:
                            b.copy_(p)
                best_mse = np.where(improved, holdout, best_mse)
                epochs_since_update = 0
            else:
                epochs_since_update += 1

            epoch += 1
            if log and epoch % 10 == 0:
                log(f"BNN epoch {epoch}: train {float(train_loss):.4f} "
                    f"holdout {holdout.mean():.4f}")
            if epochs_since_update > cfg.max_epochs_since_update:
                break
            if cfg.max_epochs and epoch >= cfg.max_epochs:
                break
            if cfg.max_grad_steps and grad_steps >= cfg.max_grad_steps:
                break

        with torch.no_grad():
            for b, p in zip(best, params):
                p.copy_(b)
        final = self._holdout(state, ho_inputs, ho_targets)
        state.elites = torch.as_tensor(np.argsort(final)[:cfg.num_elites],
                                       device=self.device)
        state.holdout_mse = torch.as_tensor(final, device=self.device)
        stats = {
            "bnn_epochs": epoch,
            "bnn_train_loss": float(train_loss),
            "bnn_holdout_mse": float(
                np.mean(np.sort(final)[:cfg.num_elites])),
        }
        return state, stats

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict_factored(self, state: BNNState, obs: torch.Tensor,
                         act: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """(means, variances) [E, B, 1 + obs] of every net for the rows
        (obs, act) [B, ...], the observation part made absolute (the
        model predicts its change)."""
        inputs = torch.cat([obs, act], dim=-1)
        mean, logvar = state.params(state.normalizer(inputs))
        mean[..., 1:] += obs
        return mean, torch.exp(logvar)
