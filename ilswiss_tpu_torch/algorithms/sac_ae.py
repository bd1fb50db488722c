"""SAC-AE, RAD and CURL for pixel observations (counterpart:
ilswiss_tpu/algorithms/sac_ae.py; `SACAEConfig`, `SACAEState`, `SACAE`).

The reference visual SAC (rlkit/torch/algorithms/sac/sac_ae.py:15-423).
One `PixelEncoder` feeds the critics and the policy, and its updates are
owned as in the JAX trainer:
  - the critic step updates the encoder and both critics with one Adam
    over the three (`qf_opt`);
  - the q target's next action comes from the ONLINE encoder's features,
    detached, and its Q values from the TARGET encoder's;
  - the policy reads the features of the encoder as the critic step left
    it, detached, so it never updates the encoder, and both the policy
    and the alpha losses use the step's old alpha; alpha's Adam has
    beta1 0.5, and log alpha is not clamped;
  - the autoencoder step (`encdec_opt`, encoder and decoder): the MSE of
    the reconstruction against the frames centered to [-0.5, 0.5], plus
    decoder_latent_lambda * mean(0.5 * |z|^2);
  - CURL (`cpc_opt`, encoder and W): bilinear logits z_a W z_pos^T of the
    anchor through the online encoder and the positive through the target
    encoder (detached), shifted by each row's max, cross-entropy against
    the diagonal; W starts as U[0, 1);
  - Polyak targets: critics at soft_target_tau, encoder at
    enc_soft_target_tau.
RAD is SAC-AE on augmented batches (data/aug_replay.py); CURL also feeds
`observations_anchor` / `observations_pos` and sets cpc_update_freq.

The JAX `lax.cond`s on `step % freq` are Python branches on the state's
host-side `step` (an int, saved in a snapshot with the rest).  A phase
that does not run this step reports zeros, and `alpha` then reports
exp(log alpha); the loop's K-step means include those zeros, as JAX's.
The order within a step: actor-critic, autoencoder, targets, CURL.

As the port's SAC, a step updates the state's tensors IN PLACE and returns
the same state object; its Gaussian noise comes in as tensors (`eps_next`,
`eps_new`, drawn by `train_noise` every step, also where the actor-critic
phase does not run), the draws JAX makes from `split(key)`.
`acting_state` is the slice that the host loops copy to the CPU for
acting: the encoder and the policy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.encoders import (
    PixelDecoder, PixelEncoder, conv_out_dim, normalize_pixels,
)
from ilswiss_tpu_torch.models.networks import FlattenMLP
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import copy_params, soft_update


@dataclass(frozen=True)
class SACAEConfig:
    image_size: int = 64
    frame_channels: int = 3
    feature_dim: int = 50
    num_conv_layers: int = 4
    num_filters: int = 32
    discount: float = 0.99
    reward_scale: float = 1.0
    policy_lr: float = 1e-3
    qf_lr: float = 1e-3
    alpha_lr: float = 1e-3
    encdec_lr: float = 1e-3
    soft_target_tau: float = 0.01
    enc_soft_target_tau: float = 0.05
    init_alpha: float = 0.1
    train_alpha: bool = True
    policy_mean_reg_weight: float = 1e-3
    policy_std_reg_weight: float = 1e-3
    beta_1: float = 0.9
    decoder_latent_lambda: float = 1e-6
    ac_update_freq: int = 2
    encdec_update_freq: int = 1
    cpc_update_freq: int = 0  # 0 = no CURL
    target_update_freq: int = 2
    # the convs' dtype ("bfloat16" | "float32"), as the JAX default
    conv_dtype: str = "bfloat16"


@dataclass
class SACAEState:
    encoder: PixelEncoder
    decoder: PixelDecoder
    policy: TanhGaussianPolicy
    qf1: FlattenMLP
    qf2: FlattenMLP
    target_encoder: PixelEncoder
    target_qf1: FlattenMLP
    target_qf2: FlattenMLP
    cpc_W: torch.Tensor      # [feature_dim, feature_dim], requires grad
    log_alpha: torch.Tensor  # 0-d, requires grad
    qf_opt: Adam             # over (encoder, qf1, qf2)
    policy_opt: Adam
    alpha_opt: Adam
    encdec_opt: Adam         # over (encoder, decoder)
    cpc_opt: Adam            # over (encoder, W)
    step: int


def _zeros(device, names) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), device=device) for k in names}


class SACAE:
    """Trainer: config, sizes and device; the learned state is a
    SACAEState."""

    def __init__(self, action_size: int, config: SACAEConfig = SACAEConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None):
        self.config = config
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)
        self.conv_dtype = getattr(torch, config.conv_dtype)
        self.target_entropy = -float(action_size)

    def init(self, seed: int) -> SACAEState:
        """Fresh state; every init draw comes from a CPU generator seeded
        with `seed`, then the tensors move to the trainer's device."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        feat, cdt = cfg.feature_dim, self.conv_dtype
        encoder = PixelEncoder(
            cfg.image_size, cfg.frame_channels, gen, feature_dim=feat,
            num_layers=cfg.num_conv_layers, num_filters=cfg.num_filters,
            compute_dtype=cdt)
        decoder = PixelDecoder(
            conv_out_dim(cfg.image_size, cfg.num_conv_layers),
            cfg.frame_channels, feat, gen, num_layers=cfg.num_conv_layers,
            num_filters=cfg.num_filters, out_size=cfg.image_size,
            compute_dtype=cdt)
        policy = TanhGaussianPolicy(feat, self.action_size, self.hidden, gen)
        qf1 = FlattenMLP(feat + self.action_size, self.hidden, 1, gen)
        qf2 = FlattenMLP(feat + self.action_size, self.hidden, 1, gen)
        W = torch.rand((feat, feat), generator=gen)
        encoder, decoder, policy, qf1, qf2 = (
            m.to(self.device) for m in (encoder, decoder, policy, qf1, qf2))
        W = W.to(self.device).requires_grad_(True)
        log_alpha = torch.tensor(math.log(cfg.init_alpha),
                                 device=self.device, requires_grad=True)
        enc = list(encoder.parameters())
        b1 = cfg.beta_1
        return SACAEState(
            encoder=encoder, decoder=decoder, policy=policy,
            qf1=qf1, qf2=qf2,
            target_encoder=copy_params(encoder),
            target_qf1=copy_params(qf1), target_qf2=copy_params(qf2),
            cpc_W=W, log_alpha=log_alpha,
            qf_opt=Adam(enc + list(qf1.parameters())
                        + list(qf2.parameters()), cfg.qf_lr, b1),
            policy_opt=Adam(policy.parameters(), cfg.policy_lr, b1),
            alpha_opt=Adam([log_alpha], cfg.alpha_lr, 0.5),
            encdec_opt=Adam(enc + list(decoder.parameters()),
                            cfg.encdec_lr, b1),
            cpc_opt=Adam(enc + [W], cfg.encdec_lr, b1),
            step=0,
        )

    def act_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        """The draws of one stochastic `act` for n envs: (noise.act, N(0, 1)
        [n, A])."""
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The draws of one `train_step`: noise.train, (eps_next, eps_new)
        N(0, 1) [batch_size, A] each."""
        return noise.train((batch_size, self.action_size))

    def acting_state(self, state: SACAEState) -> SACAEState:
        """The acting slice of `state` (JAX sac_ae.py:162-172): the
        encoder and the policy; the decoder, the critics, the targets, W,
        log alpha and the five optimizers are None, so the host loop's
        per-segment copy holds what `act` reads and nothing else."""
        return SACAEState(
            encoder=state.encoder, decoder=None, policy=state.policy,
            qf1=None, qf2=None, target_encoder=None, target_qf1=None,
            target_qf2=None, cpc_W=None, log_alpha=None, qf_opt=None,
            policy_opt=None, alpha_opt=None, encdec_opt=None, cpc_opt=None,
            step=state.step)

    @torch.no_grad()
    def act(self, state: SACAEState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        """Policy actions in [-1, 1] from frames [B, H, W, C]; `eps` [B, A]
        is the N(0, 1) noise of a stochastic action."""
        mean, log_std = state.policy(state.encoder(obs))
        if deterministic:
            return torch.tanh(mean)
        return D.tanh_normal_sample(mean, log_std, eps)[0]

    # --- phases --------------------------------------------------------
    def _train_ac(self, state: SACAEState, batch: Dict[str, torch.Tensor],
                  eps_next: torch.Tensor, eps_new: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        obs, actions = batch["obs"], batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]
        alpha = torch.exp(state.log_alpha.detach())

        with torch.no_grad():
            # next action from the online encoder's features, its Q values
            # from the target encoder's
            n_mean, n_log_std = state.policy(state.encoder(next_obs))
            next_actions, n_pre = D.tanh_normal_sample(n_mean, n_log_std,
                                                       eps_next)
            next_log_pi = D.tanh_normal_log_prob(n_mean, n_log_std,
                                                 next_actions, n_pre)
            target_feat = state.target_encoder(next_obs)
            min_t_q = torch.minimum(
                state.target_qf1(target_feat, next_actions),
                state.target_qf2(target_feat, next_actions))
            q_target = rewards + (1.0 - terminals) * cfg.discount * (
                min_t_q - alpha * next_log_pi)

        feat = state.encoder(obs)
        qf1_loss = 0.5 * torch.mean((state.qf1(feat, actions) - q_target) ** 2)
        qf2_loss = 0.5 * torch.mean((state.qf2(feat, actions) - q_target) ** 2)
        state.qf_opt.step(state.qf_opt.grad(qf1_loss + qf2_loss))

        # the policy on detached features of the UPDATED encoder
        with torch.no_grad():
            feat = state.encoder(obs)
        mean, log_std = state.policy(feat)
        new_actions, pre = D.tanh_normal_sample(mean, log_std, eps_new)
        log_pi = D.tanh_normal_log_prob(mean, log_std, new_actions, pre)
        q_new = torch.minimum(state.qf1(feat, new_actions),
                              state.qf2(feat, new_actions))
        policy_loss = (torch.mean(alpha * log_pi - q_new)
                       + cfg.policy_mean_reg_weight * torch.mean(mean ** 2)
                       + cfg.policy_std_reg_weight * torch.mean(log_std ** 2))
        state.policy_opt.step(state.policy_opt.grad(policy_loss))

        alpha_loss = -torch.mean(
            state.log_alpha * (log_pi + self.target_entropy).detach())
        if cfg.train_alpha:
            state.alpha_opt.step(state.alpha_opt.grad(alpha_loss))
        return {"qf1_loss": qf1_loss, "qf2_loss": qf2_loss,
                "policy_loss": policy_loss, "alpha_loss": alpha_loss,
                "alpha": alpha}

    def _train_encdec(self, state: SACAEState,
                      batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        obs = batch["obs"]
        # the reference's preprocess_obs centers the frames to [-.5, .5]
        target = normalize_pixels(obs) - 0.5
        z = state.encoder(obs)
        rec = state.decoder(z)
        rec_loss = torch.mean((rec - target) ** 2)
        latent_loss = torch.mean(0.5 * torch.sum(z ** 2, dim=1))
        loss = rec_loss + self.config.decoder_latent_lambda * latent_loss
        state.encdec_opt.step(state.encdec_opt.grad(loss))
        return {"rec_loss": rec_loss, "latent_loss": latent_loss}

    def _train_cpc(self, state: SACAEState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            z_pos = state.target_encoder(batch["observations_pos"])
        z_a = state.encoder(batch["observations_anchor"])
        logits = z_a @ (state.cpc_W @ z_pos.T)                  # [B, B]
        logits = logits - torch.amax(logits, dim=1, keepdim=True)
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = F.cross_entropy(logits, labels)
        state.cpc_opt.step(state.cpc_opt.grad(loss))
        return {"curl_loss": loss}

    # ------------------------------------------------------------------
    def train_step(self, state: SACAEState, batch: Dict[str, torch.Tensor],
                   eps_next: torch.Tensor, eps_new: torch.Tensor
                   ) -> tuple[SACAEState, Dict[str, torch.Tensor]]:
        """One staggered step, in place; returns (state, metrics), 0-d
        tensors on the device."""
        cfg = self.config
        step, dev = state.step, self.device
        if step % cfg.ac_update_freq == 0:
            metrics = self._train_ac(state, batch, eps_next, eps_new)
        else:
            metrics = _zeros(dev, ("qf1_loss", "qf2_loss", "policy_loss",
                                   "alpha_loss"))
            metrics["alpha"] = torch.exp(state.log_alpha.detach())
        if cfg.encdec_update_freq > 0:
            metrics.update(
                self._train_encdec(state, batch)
                if step % cfg.encdec_update_freq == 0
                else _zeros(dev, ("rec_loss", "latent_loss")))
        if step % cfg.target_update_freq == 0:
            soft_update(state.target_qf1, state.qf1, cfg.soft_target_tau)
            soft_update(state.target_qf2, state.qf2, cfg.soft_target_tau)
            soft_update(state.target_encoder, state.encoder,
                        cfg.enc_soft_target_tau)
        if cfg.cpc_update_freq > 0:
            metrics.update(
                self._train_cpc(state, batch)
                if step % cfg.cpc_update_freq == 0
                else _zeros(dev, ("curl_loss",)))
        state.step = step + 1
        return state, {k: v.detach() for k, v in metrics.items()}
