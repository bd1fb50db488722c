"""GCSL: goal-conditioned supervised learning (counterpart:
ilswiss_tpu/algorithms/gcsl.py; `GCSLConfig`, `GCSLState`, `GCSL`,
`GCSLLoop`).

Every transition is relabeled with a future achieved goal (her_ratio
1.0), and the policy is trained to reproduce the action taken, given the
observation, the relabeled goal and, with `use_horizons`, a one-hot of
the steps to that goal (clipped to [0, max_horizon)):
  - MLE:   -mean log pi(a | x) of the tanh-Gaussian
    (`expert_action_log_prob`, as BC's);
  - MSE:   mean sum (tanh(mu(x)) - a)^2, the deterministic head;
  - CLASS: cross-entropy of a categorical policy over a `DiscretEnv`'s
    action indices.
Acting conditions on the one-hot of `eval_horizon` (default 0, "reach the
goal now").  Adam is optax.adam(lr).

Draws: `act_noise` gives noise.act (N(0, 1) [n, A]), or noise.gumbel
([n, A]) in CLASS mode; `train_noise` gives nothing (the JAX step's key
goes unused).  `train_step` updates the state's tensors IN PLACE and
returns the same state object.  `GCSLLoop` is `HERLoop` with future
relabeling at her_ratio 1.0, the horizons returned, and integer warmup
actions on a discrete env.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ilswiss_tpu_torch.algorithms.her import HERLoop, HERLoopConfig
from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.policies import (
    CategoricalPolicy, TanhGaussianPolicy,
)
from ilswiss_tpu_torch.utils.device import resolve_device

MODES = ("MLE", "MSE", "CLASS")


@dataclass(frozen=True)
class GCSLConfig:
    mode: str = "MSE"  # MLE | MSE | CLASS (discrete cross-entropy)
    lr: float = 1e-3
    use_horizons: bool = True
    max_horizon: int = 50  # one-hot width == max_episode_steps
    # the horizon the deployed policy conditions on
    eval_horizon: int = 0


@dataclass
class GCSLState:
    policy: Any       # TanhGaussianPolicy, or CategoricalPolicy (CLASS)
    policy_opt: Adam


class GCSL:
    """Trainer: config, sizes and device; the learned state is a
    GCSLState."""

    def __init__(self, obs_size: int, goal_size: int, action_size: int,
                 config: GCSLConfig = GCSLConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None):
        if config.mode not in MODES:
            raise ValueError(f"GCSL mode {config.mode!r}: one of {MODES}")
        self.config = config
        self.obs_size = obs_size
        self.goal_size = goal_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.input_dim = obs_size + goal_size + (
            config.max_horizon if config.use_horizons else 0)
        self.device = resolve_device(device)

    def init(self, seed: int) -> GCSLState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        if self.config.mode == "CLASS":
            policy = CategoricalPolicy(self.input_dim, self.action_size,
                                       self.hidden, gen)
        else:
            policy = TanhGaussianPolicy(self.input_dim, self.action_size,
                                        self.hidden, gen)
        policy = policy.to(self.device)
        return GCSLState(policy=policy,
                         policy_opt=Adam(policy.parameters(), self.config.lr,
                                         0.9))

    def _input(self, obs_dict, horizon: torch.Tensor | None) -> torch.Tensor:
        parts = [obs_dict["observation"], obs_dict["desired_goal"]]
        cfg = self.config
        if cfg.use_horizons:
            if horizon is None:
                horizon = torch.full((parts[0].shape[0],), cfg.eval_horizon,
                                     dtype=torch.int64,
                                     device=parts[0].device)
            parts.append(torch.nn.functional.one_hot(
                torch.clamp(horizon.to(torch.int64), 0, cfg.max_horizon - 1),
                cfg.max_horizon).to(torch.float32))
        return torch.cat(parts, dim=-1)

    def act_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        if self.config.mode == "CLASS":
            return (noise.gumbel((n, self.action_size)),)
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return ()

    @torch.no_grad()
    def act(self, state: GCSLState, obs_dict, draw: torch.Tensor | None =
            None, deterministic: bool = False) -> torch.Tensor:
        """Actions at `eval_horizon`: indices (CLASS: argmax, or the Gumbel
        sample of `draw`), else tanh(mean), or the tanh-Normal sample of
        the N(0, 1) `draw`."""
        x = self._input(obs_dict, None)
        if self.config.mode == "CLASS":
            logits = state.policy(x)
            if deterministic:
                return torch.argmax(logits, dim=-1)
            return D.categorical_sample(logits, draw)
        mean, log_std = state.policy(x)
        if deterministic:
            return torch.tanh(mean)
        return D.tanh_normal_sample(mean, log_std, draw)[0]

    def train_step(self, state: GCSLState, batch: Dict[str, torch.Tensor]
                   ) -> tuple[GCSLState, Dict[str, torch.Tensor]]:
        """One gradient step on a relabeled batch (its "horizon" where
        given), in place; returns (state, {"gcsl_loss": 0-d tensor})."""
        x = self._input(batch, batch.get("horizon"))
        acts = batch["action"]
        if self.config.mode == "CLASS":
            logp = torch.log_softmax(state.policy(x), dim=-1)
            loss = -torch.mean(torch.take_along_dim(
                logp, acts.to(torch.int64)[:, None], dim=-1))
        else:
            mean, log_std = state.policy(x)
            if self.config.mode == "MLE":
                loss = -torch.mean(D.expert_action_log_prob(mean, log_std,
                                                            acts))
            else:
                loss = torch.mean(torch.sum((torch.tanh(mean) - acts) ** 2,
                                            dim=-1))
        # MSE mode leaves the log-std head out of the loss: its gradient
        # is zero, as autodiff gives it, and Adam still counts the step
        opt = state.policy_opt
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        opt.step([torch.zeros_like(p) if g is None else g
                  for g, p in zip(grads, opt.params)])
        return state, {"gcsl_loss": loss.detach()}


class GCSLLoop(HERLoop):
    """`HERLoop` with future relabeling at her_ratio 1.0 and the horizons
    (the reference's GoalHorizonRL loop, gcsl/rl.py); a discrete env warms
    up with integer actions."""

    return_horizon = True

    def __init__(self, vec_env: VectorEnv, gcsl: GCSL,
                 config: HERLoopConfig = HERLoopConfig()):
        super().__init__(vec_env, gcsl, config, relabel_type="future",
                         her_ratio=1.0)
        self.grad_steps_per_iter = (config.grad_steps_per_iter
                                    or vec_env.num_envs)

    def _random_action(self, noise) -> torch.Tensor:
        env, n = self.vec_env.env, self.vec_env.num_envs
        if env.discrete:
            return noise.warmup_index(n, env.action_size)
        return noise.warmup_action((n, env.action_size))
