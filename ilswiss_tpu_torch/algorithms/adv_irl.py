"""Adversarial imitation learning: GAIL, AIRL, FAIRL (counterpart:
ilswiss_tpu/algorithms/adv_irl.py; `AdvIRLConfig`, `AdvIRLState`,
`AdvIRL`).

The reference AdvIRL (rlkit/torch/algorithms/adv_irl/adv_irl.py:15-329):
a discriminator trained to tell expert transitions from the policy's,
wrapped around an inner off-policy trainer (the port's SAC) that learns
from rewards the current discriminator synthesizes.

  - disc input: [obs, action], or [obs, next_obs] when `state_only`;
  - BCE with logits, expert target 1, policy target 0;
  - the Gulrajani gradient penalty on per-row interpolates
    x~ = eps * expert + (1 - eps) * policy:
    weight * mean((sqrt(max(sum(g^2), 1e-12)) - 1)^2), g = d sum(disc(x~))
    / d x~, taken by `torch.autograd.grad(..., create_graph=True)` where
    JAX takes `jax.grad` inside the loss; with BatchNorm on, that forward
    normalizes by the interpolates' own batch statistics (train mode), and
    only the main forward's statistics move the running averages;
  - rewards per mode: airl logits, gail softplus(logits), gail2
    -softplus(-logits) (log D), fairl exp(logits) * (-logits), then the
    optional clips, from the discriminator in eval mode;
  - optional reward normalization by a running (Welford) std;
  - one train call: `num_update_loops_per_train_call` x
    (`num_disc_updates_per_loop_iter` discriminator steps, then
    `num_policy_updates_per_loop_iter` inner-trainer steps), the metrics
    averaged per loop and then over the loops.

The trajectory-window (rnn) discriminator (`disc_type: rnn`,
models/rnn_discriminators.py) scores windows of T = `disc_traj_len`
steps of one env (`replay_sample_window`), per step:
  - a discriminator step takes n_w = max(1, disc_optim_batch_size // T)
    windows from the demos and n_w from the ring, zeroes the inputs of
    steps outside `valid` (past the window's episode), interpolates per
    window (eps [n_w, 1, 1]), takes the penalty's gradient norm once per
    window over T x D, and averages BCE and accuracy over the valid
    steps (divided by max(sum(valid), 1)), the targets broadcast over T;
  - a policy step takes n_w = policy_optim_batch_size // T windows of the
    ring, rewards each step from the eval-mode logits, zeroes the rewards
    outside `valid`, and trains the inner SAC on the n_w * T flattened
    steps; `policy_optim_batch_size_from_expert` is not used, and
    `reward_norm` leaves the masked steps out of its moments.  As in the
    JAX package, the masked steps keep their obs, action and next_obs and
    SAC trains on them (ROADMAP.md section 3).

Draws.  Every random number comes from the runner's `noise`
(runtime/loop.py::Noise), in this order, so a test can replay the JAX
package's draws:
  - each discriminator step: `replay(disc_optim_batch_size)` for the
    expert rows, `replay(disc_optim_batch_size)` for the policy rows,
    `interpolation(disc_optim_batch_size)` for eps (drawn with the penalty
    off too); rnn: `replay(n_w)`, `replay(n_w)`, `interpolation(n_w)`;
  - each policy step: `replay(policy_optim_batch_size - n_exp)` for the
    policy rows, `replay(n_exp)` for the expert rows when
    `policy_optim_batch_size_from_expert` n_exp > 0, then
    `train((policy_optim_batch_size, action_size))`, SAC's two normals;
    rnn: `replay(n_w)`, then `train((n_w * T, action_size))`.
The JAX package derives the same draws from its keys (adv_irl.py:259-262,
:372-393, :451-483).

The image discriminator (`disc_type: cnn`, models/discriminators.py
`CNNDisc`) scores (image obs, action) pairs: uint8 frames are divided by
255; a discriminator step interpolates both inputs with one eps a row
(eps [n, 1] for the action, the same values as [n, 1, 1, 1] for the
image) and takes the penalty's gradient norm over both together (JAX
adv_irl.py:211-240); it scores (obs, action) only, so `state_only`
raises.  `feature_fn(policy_state, obs)` (the visual AdvIRL, reference
adv_irl_visual.py:54-55) feeds an mlp or rnn discriminator frozen
features of the inner trainer's encoder, detached, in place of the obs;
`feature_dim` is their width.

As the port's SAC, the update runs in place: the discriminator's
parameters, running averages and Adam moments, and the inner state, are
updated in their tensors, and the same state object is returned.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.data.replay import (
    ReplayState, replay_sample, replay_sample_window,
)
from ilswiss_tpu_torch.models.discriminators import CNNDisc, MLPDisc
from ilswiss_tpu_torch.models.rnn_discriminators import RNNDisc

MODES = ("airl", "gail", "gail2", "fairl")
# the discriminator's init draws come from a CPU generator of their own,
# seeded apart from the inner trainer's (`seed`) and the loop's noise
# (`seed + 1`, evaluation `seed + epoch + 1`)
DISC_SEED_OFFSET = 1 << 30


@dataclass(frozen=True)
class AdvIRLConfig:
    mode: str = "gail"  # airl | gail | gail2 | fairl
    state_only: bool = False
    disc_optim_batch_size: int = 1024
    policy_optim_batch_size: int = 1024
    policy_optim_batch_size_from_expert: int = 0
    num_update_loops_per_train_call: int = 1
    num_disc_updates_per_loop_iter: int = 1
    num_policy_updates_per_loop_iter: int = 1
    disc_lr: float = 1e-3
    disc_momentum: float = 0.0
    use_grad_pen: bool = True
    grad_pen_weight: float = 10.0
    rew_clip_min: float | None = None
    rew_clip_max: float | None = None
    # divide synthesized rewards by a running std (see the JAX config:
    # the repair of the GAIL alpha ratchet, tests/test_alpha_ratchet.py)
    reward_norm: bool = False
    disc_num_blocks: int = 2
    disc_hid_dim: int = 100
    disc_hid_act: str = "relu"
    disc_use_bn: bool = True
    disc_clamp_magnitude: float = 10.0
    # mlp | rnn (trajectory windows) | cnn (image obs)
    disc_type: str = "mlp"
    disc_traj_len: int = 16          # rnn window length T
    disc_rnn_cell: str = "gru"
    disc_rnn_layers: int = 2
    disc_rnn_bidirectional: bool = True
    disc_num_filters: int = 32       # cnn conv width


@dataclass
class AdvIRLState:
    disc: MLPDisc | RNNDisc | CNNDisc  # parameters (+ BatchNorm averages)
    disc_opt: Adam
    policy: Any              # the inner trainer's state (SACState)
    expert: ReplayState      # the demos, a full buffer
    # running (count, mean, m2) of synthesized rewards, 0-d tensors, when
    # config.reward_norm; None otherwise
    rew_stats: Any = None


def _means(metrics: List[Dict[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]).mean()
            for k in metrics[0]}


class AdvIRL:
    """`policy_trainer` is an off-policy trainer with `init(seed)`,
    `act(state, obs, eps, deterministic)`, `act_noise` and
    `train_step(state, batch, eps_next, eps_new)` (SAC); `expert_replay`
    the demo buffer (data/demo.py).  The loop calls `train_call(state,
    replay, noise)` in place of its own gradient steps (the reference's
    _do_training override)."""

    def __init__(self, obs_size: int, action_size: int, policy_trainer,
                 expert_replay: ReplayState,
                 config: AdvIRLConfig = AdvIRLConfig(), feature_fn=None,
                 feature_dim: int | None = None):
        if config.mode not in MODES:
            raise ValueError(f"unknown AdvIRL mode {config.mode!r}; "
                             f"known: {MODES}")
        if config.disc_type not in ("mlp", "rnn", "cnn"):
            raise ValueError(f"unknown disc_type {config.disc_type!r}")
        if config.disc_type == "cnn" and config.state_only:
            raise ValueError("the cnn discriminator scores (obs, action): "
                             "state_only is not supported")
        if config.disc_type == "cnn" and (
                expert_replay.data["obs"].dim() != 4):
            raise ValueError("the cnn discriminator needs image "
                             "observations [H, W, C]; the demos' obs are "
                             f"{tuple(expert_replay.data['obs'].shape[1:])}")
        if feature_fn is not None and feature_dim is None:
            raise ValueError("feature_fn needs feature_dim")
        self.rnn = config.disc_type == "rnn"
        self.cnn = config.disc_type == "cnn"
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.policy_trainer = policy_trainer
        self.expert_replay = expert_replay
        self.feature_fn = feature_fn
        if feature_fn is not None:
            obs_size = feature_dim
        self.device = policy_trainer.device
        self.disc_input_dim = (2 * obs_size if config.state_only
                               else obs_size + action_size)

    # ------------------------------------------------------------------
    def init(self, seed: int) -> AdvIRLState:
        """Fresh state: the inner trainer's from `seed`, the
        discriminator's from a CPU generator seeded `seed +
        DISC_SEED_OFFSET` (flax's inits: lecun_normal kernels, orthogonal
        recurrent kernels, zero biases), and a private copy of the demos on
        the trainer's device."""
        cfg = self.config
        policy = self.policy_trainer.init(seed)
        gen = torch.Generator().manual_seed(seed + DISC_SEED_OFFSET)
        if self.cnn:
            disc = CNNDisc(tuple(self.expert_replay.data["obs"].shape[1:]),
                           self.action_size, gen,
                           num_filters=cfg.disc_num_filters,
                           num_layer_blocks=cfg.disc_num_blocks,
                           hid_dim=cfg.disc_hid_dim,
                           hid_act=cfg.disc_hid_act,
                           clamp_magnitude=cfg.disc_clamp_magnitude)
        elif self.rnn:
            disc = RNNDisc(self.disc_input_dim, gen, hid_dim=cfg.disc_hid_dim,
                           cell_type=cfg.disc_rnn_cell,
                           num_layers=cfg.disc_rnn_layers,
                           bidirectional=cfg.disc_rnn_bidirectional,
                           clamp_magnitude=cfg.disc_clamp_magnitude)
        else:
            disc = MLPDisc(self.disc_input_dim, gen,
                           num_layer_blocks=cfg.disc_num_blocks,
                           hid_dim=cfg.disc_hid_dim,
                           hid_act=cfg.disc_hid_act, use_bn=cfg.disc_use_bn,
                           clamp_magnitude=cfg.disc_clamp_magnitude)
        disc = disc.to(self.device)
        e = self.expert_replay
        copy = lambda t: t.to(self.device, copy=True)  # noqa: E731
        expert = ReplayState(
            data={k: copy(v) for k, v in e.data.items()},
            ep_id=copy(e.ep_id), ptr=e.ptr, size=e.size,
            env_ep=copy(e.env_ep))
        zero = lambda: torch.zeros((), device=self.device)  # noqa: E731
        return AdvIRLState(
            disc=disc,
            disc_opt=Adam(disc.parameters(), cfg.disc_lr,
                          b1=cfg.disc_momentum, b2=0.999),
            policy=policy,
            expert=expert,
            rew_stats=(zero(), zero(), zero()) if cfg.reward_norm else None,
        )

    def act_noise(self, noise, n: int) -> tuple:
        return self.policy_trainer.act_noise(noise, n)

    def act(self, state: AdvIRLState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        return self.policy_trainer.act(state.policy, obs, eps,
                                       deterministic=deterministic)

    # ------------------------------------------------------------------
    def _disc_input(self, state: AdvIRLState,
                    batch: Dict[str, torch.Tensor]):
        """The discriminator's input: [.., D] (mlp) or [.., T, D] (rnn)
        concatenations, or an (image obs, action) pair (cnn)."""
        obs, other = batch["obs"], batch.get("next_obs")
        if self.cnn:
            if obs.dtype == torch.uint8:
                obs = obs.to(torch.float32) / 255.0
            return obs, batch["action"]
        if self.feature_fn is not None:
            with torch.no_grad():
                obs = self.feature_fn(state.policy, obs)
                if self.config.state_only:
                    other = self.feature_fn(state.policy, other)
        if not self.config.state_only:
            other = batch["action"]
        return torch.cat([obs, other], dim=-1)

    def _logits(self, disc, x, train: bool,
                stats: list | None = None) -> torch.Tensor:
        """The discriminator's logits; an rnn or cnn discriminator has no
        train mode (no BatchNorm)."""
        if self.rnn:
            return disc(x)
        if self.cnn:
            return disc(*x)
        return disc(x, train=train, stats=stats)

    def _windows(self, replay: ReplayState, noise, batch_size: int):
        """max(1, batch_size // T) windows of T = disc_traj_len steps of
        the buffer: (data [n_w, T, ...], valid [n_w, T])."""
        T = self.config.disc_traj_len
        win = replay_sample_window(
            replay, noise.replay(max(1, batch_size // T)), T)
        return win, win.pop("valid")

    def _disc_update(self, state: AdvIRLState, replay: ReplayState, noise
                     ) -> tuple[AdvIRLState, Dict[str, torch.Tensor]]:
        """One discriminator step (JAX `_disc_update`, adv_irl.py:259-348),
        in place."""
        cfg = self.config
        if self.rnn:
            expert, e_valid = self._windows(state.expert, noise,
                                            cfg.disc_optim_batch_size)
            policy, p_valid = self._windows(replay, noise,
                                            cfg.disc_optim_batch_size)
            n = e_valid.shape[0]
            # zero the steps past each window's episode, so the (reversed)
            # recurrence never mixes in a neighbouring episode
            expert_in = self._disc_input(state, expert) * e_valid[..., None]
            policy_in = self._disc_input(state, policy) * p_valid[..., None]
            eps = noise.interpolation(n).reshape(n, 1, 1)
            valid = torch.cat([e_valid, p_valid]).to(torch.float32)[..., None]
            ones = (n, 1, 1)                    # targets broadcast over T
        else:
            n = cfg.disc_optim_batch_size
            expert_in = self._disc_input(
                state, replay_sample(state.expert, noise.replay(n)))
            policy_in = self._disc_input(
                state, replay_sample(replay, noise.replay(n)))
            eps = noise.interpolation(n)
            valid = None
            ones = (n, 1)
        dev = self.device
        if self.cnn:
            x = tuple(torch.cat([e, p], dim=0)
                      for e, p in zip(expert_in, policy_in))
        else:
            x = torch.cat([expert_in, policy_in], dim=0)
        targets = torch.cat([torch.ones(ones, device=dev),
                             torch.zeros(ones, device=dev)])

        disc = state.disc
        stats: list = []
        logits = self._logits(disc, x, train=True, stats=stats)
        ce_rows = F.softplus(logits) - targets * logits
        hit = ((logits > 0) == (targets > 0.5)).float()
        if valid is None:
            ce, acc = torch.mean(ce_rows), torch.mean(hit)
        else:
            denom = torch.clamp_min(torch.sum(valid), 1.0)
            ce = torch.sum(ce_rows * valid) / denom
            acc = torch.sum(hit * valid) / denom
        loss = ce
        if cfg.use_grad_pen:
            pairs = (zip(expert_in, policy_in) if self.cnn
                     else [(expert_in, policy_in)])
            interp = []
            for e, p in pairs:
                w = eps.reshape(eps.shape[:1] + (1,) * (e.dim() - 1))
                interp.append((w * e + (1.0 - w) * p).requires_grad_(True))
            gs = torch.autograd.grad(
                torch.sum(self._logits(
                    disc, tuple(interp) if self.cnn else interp[0],
                    train=True)),
                interp, create_graph=True)
            # one norm a row (mlp; cnn over image and action together) or
            # a window (rnn, over T x D)
            sq = sum(torch.sum((g * g).reshape(g.shape[0], -1), dim=-1)
                     for g in gs)
            norm = torch.sqrt(torch.clamp_min(sq, 1e-12))
            grad_pen = torch.mean((norm - 1.0) ** 2)
            loss = ce + cfg.grad_pen_weight * grad_pen
        else:
            grad_pen = torch.zeros((), device=dev)
        grads = torch.autograd.grad(loss, state.disc_opt.params)
        state.disc_opt.step(grads)
        if not (self.rnn or self.cnn):
            disc.update_batch_stats(stats)
        return state, {"disc_ce_loss": ce.detach(), "disc_acc": acc,
                       "disc_grad_pen": grad_pen.detach()}

    # ------------------------------------------------------------------
    def _mode_reward(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.mode == "airl":
            rew = logits
        elif cfg.mode == "gail":
            rew = F.softplus(logits)
        elif cfg.mode == "gail2":
            rew = -F.softplus(-logits)       # log D
        else:                                # fairl
            rew = torch.exp(logits) * (-logits)
        if cfg.rew_clip_max is not None:
            rew = torch.clamp_max(rew, cfg.rew_clip_max)
        if cfg.rew_clip_min is not None:
            rew = torch.clamp_min(rew, cfg.rew_clip_min)
        return rew

    @torch.no_grad()
    def synthesize_rewards(self, state: AdvIRLState,
                           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B] rewards of `batch` from the discriminator in eval mode."""
        logits = self._logits(state.disc, self._disc_input(state, batch),
                              train=False)
        return self._mode_reward(logits[..., 0])

    def _policy_update(self, state: AdvIRLState, replay: ReplayState, noise
                       ) -> tuple[AdvIRLState, Dict[str, torch.Tensor]]:
        """One inner-trainer step on synthesized rewards (JAX
        `_policy_update`, adv_irl.py:372-416), in place."""
        cfg = self.config
        weight = None
        if self.rnn:
            win, valid = self._windows(replay, noise,
                                       cfg.policy_optim_batch_size)
            mask = valid.to(torch.float32)
            with torch.no_grad():
                logits = state.disc(self._disc_input(state, win)
                                    * valid[..., None])
            rew = self._mode_reward(logits[..., 0]) * mask
            # the masked steps keep their obs, action and next_obs: only
            # their reward is zeroed (the JAX package's batch)
            batch = {k: v.reshape((-1,) + v.shape[2:])
                     for k, v in win.items()}
            batch["reward"] = rew.reshape(-1)
            weight = mask.reshape(-1)
        else:
            n_exp = cfg.policy_optim_batch_size_from_expert
            batch = replay_sample(
                replay, noise.replay(cfg.policy_optim_batch_size - n_exp))
            if n_exp > 0:
                exp = replay_sample(state.expert, noise.replay(n_exp))
                batch = {k: torch.cat([batch[k], exp[k]], dim=0)
                         for k in batch}
            batch["reward"] = self.synthesize_rewards(state, batch)
        if cfg.reward_norm:
            state, batch["reward"] = self._normalize_rewards(
                state, batch["reward"], weight)
        eps_next, eps_new = noise.train(
            (batch["reward"].shape[0], self.action_size))
        state.policy, pol_metrics = self.policy_trainer.train_step(
            state.policy, batch, eps_next, eps_new)
        metrics = {f"policy_{k}": v for k, v in pol_metrics.items()}
        metrics["disc_rew_mean"] = torch.mean(batch["reward"])
        return state, metrics

    def _normalize_rewards(self, state: AdvIRLState, rew: torch.Tensor,
                           weight: torch.Tensor | None = None
                           ) -> tuple[AdvIRLState, torch.Tensor]:
        """Merge the batch into the running (count, mean, m2) (Welford),
        then divide by the running std, not centered (JAX
        `_normalize_rewards`, adv_irl.py:418-449).  `weight` (0/1) leaves
        masked rows out of the moments; an all-masked batch leaves them
        as they were."""
        count, mean, m2 = state.rew_stats
        r = rew.reshape(-1)
        if weight is None:
            n_b = torch.tensor(float(r.shape[0]), device=r.device)
            mean_b = torch.mean(r)
            m2_b = torch.sum((r - mean_b) ** 2)
        else:
            w = weight.reshape(-1)
            n_b = torch.sum(w)
            mean_b = torch.sum(w * r) / torch.clamp_min(n_b, 1.0)
            m2_b = torch.sum(w * (r - mean_b) ** 2)
        delta = mean_b - mean
        n = count + n_b
        denom = torch.clamp_min(n, 1.0)
        mean = mean + delta * n_b / denom
        m2 = m2 + m2_b + delta ** 2 * count * n_b / denom
        std = torch.sqrt(torch.clamp_min(
            m2 / torch.clamp_min(n - 1.0, 1.0), 1e-12))
        state.rew_stats = (n, mean, m2)
        return state, rew / (std + 1e-8)

    # ------------------------------------------------------------------
    def train_call(self, state: AdvIRLState, replay: ReplayState, noise
                   ) -> tuple[AdvIRLState, Dict[str, torch.Tensor]]:
        """One reference train call (adv_irl.py:126-131; JAX `train_call`,
        :451-483): the nested discriminator / policy loop, in place.
        Returns the metrics' means, 0-d tensors on the device."""
        cfg = self.config
        loops = []
        for _ in range(cfg.num_update_loops_per_train_call):
            disc_m = [self._disc_update(state, replay, noise)[1]
                      for _ in range(cfg.num_disc_updates_per_loop_iter)]
            pol_m = [self._policy_update(state, replay, noise)[1]
                     for _ in range(cfg.num_policy_updates_per_loop_iter)]
            loops.append({**_means(disc_m), **_means(pol_m)})
        return state, _means(loops)
