"""The reference's SAC: acting and the learner's gradient steps in plain
PyTorch, with autograd, from the SAC paper's update as ILSwiss writes it
(Haarnoja et al., arXiv:1812.05905; rlkit's `SoftActorCritic`).  It
imports nothing of the port and takes no tensor the port made: the
benchmark hands it its own copy of the weights it made.

One gradient step, with alpha from before the step:

  y      = reward_scale r + (1 - terminal) gamma
           (min(Q1bar, Q2bar)(s', a') - alpha log pi(a'|s')),  a' ~ pi(s')
  critics: 0.5 mean((Qi(s, a) - y)^2) each, summed, one Adam step
  policy:  mean(alpha log pi(a~|s) - min(Q1, Q2)(s, a~))
           + mean_reg mean(mu^2) + std_reg mean(log_std^2), a~ ~ pi(s),
           against the UPDATED critics, one Adam step
  alpha:   -mean(log_alpha (log pi + target_entropy)), one Adam step, then
           log_alpha clamped to [log min_alpha, log max_alpha]
  targets: Polyak, tau

The policy is a tanh-Gaussian: a ReLU trunk, a mean head and a log-std
head clamped to [-20, 2]; log pi sums the base Normal's log density of
the pre-tanh sample and -log(1 - a^2 + 1e-6).  min() takes critic 0 on a
tie.  Adam is b2 = 0.999, eps = 1e-8, with bias correction by one step
count shared by the three optimizers.

Every matrix product goes through `product(x, w)`.  In the reference it is
a float32 product (the benchmark turns TF32 off); the control passes
`rounding`, which rounds both operands of every product, forward and
backward, to a lower precision first.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

LOG_SIG_MIN, LOG_SIG_MAX, TANH_EPS = -20.0, 2.0, 1e-6
METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
           "q1_pred_mean", "q2_pred_mean", "log_pi_mean")
_LOG_2PI = math.log(2.0 * math.pi)


class _Rounded(torch.autograd.Function):
    """A batched product whose operands are rounded, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, rounding):
        ctx.rounding = rounding
        xr, wr = rounding(x), rounding(w)
        ctx.save_for_backward(xr, wr)
        return torch.matmul(xr, wr)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rounding(g)
        gx = torch.matmul(gr, wr.transpose(-1, -2))
        gw = torch.matmul(xr.transpose(-1, -2), gr)
        # a weight shared across a broadcast batch sums its gradients
        while gw.dim() > wr.dim():
            gw = gw.sum(0)
        return gx, gw, None


def _product(rounding: Callable | None):
    if rounding is None:
        return torch.matmul
    return lambda x, w: _Rounded.apply(x, w, rounding)


def policy_forward(p: Dict[str, torch.Tensor], obs, layers: int,
                   product=torch.matmul):
    """(mean, clamped log-std) of the policy with weights `p` (kernels
    [in, out] under hidden_i_w / mean_w / log_std_w, biases *_b)."""
    x = obs
    for i in range(layers):
        x = torch.relu(product(x, p[f"hidden_{i}_w"]) + p[f"hidden_{i}_b"])
    mean = product(x, p["mean_w"]) + p["mean_b"]
    log_std = product(x, p["log_std_w"]) + p["log_std_b"]
    return mean, torch.clamp(log_std, LOG_SIG_MIN, LOG_SIG_MAX)


def sample(mean, log_std, eps):
    """(tanh-Gaussian action, its log pi [B, 1]) from N(0, 1) draws."""
    action = torch.tanh(mean + torch.exp(log_std) * eps)
    log_pi = (torch.sum(-0.5 * (eps * eps + 2.0 * log_std + _LOG_2PI), -1,
                        keepdim=True)
              - torch.sum(torch.log(1.0 - action * action + TANH_EPS), -1,
                          keepdim=True))
    return action, log_pi


def act(p, obs, eps, layers: int, product=torch.matmul):
    """The acting sample: actions in [-1, 1] from observations and draws."""
    with torch.no_grad():
        mean, log_std = policy_forward(p, obs, layers, product)
        return sample(mean, log_std, eps)[0]


def critics(c: Dict[str, torch.Tensor], obs, action, layers: int,
            product=torch.matmul):
    """[2, B, 1]: both critics (kernels [2, in, out], biases [2, out])."""
    x = torch.cat([obs, action], -1).unsqueeze(0).expand(2, -1, -1)
    for i in range(layers):
        x = torch.relu(product(x, c[f"hidden_{i}_w"])
                       + c[f"hidden_{i}_b"][:, None, :])
    return product(x, c["output_w"]) + c["output_b"][:, None, :]


class Learner:
    """The learner's state (policy, critics, targets, log alpha, Adam
    moments, the shared step) and its gradient step."""

    def __init__(self, policy, critics_, hp: dict, target_entropy: float,
                 layers: int, rounding: Callable | None = None):
        self.p = {k: v.detach().clone().float().requires_grad_()
                  for k, v in policy.items()}
        self.c = {k: v.detach().clone().float().requires_grad_()
                  for k, v in critics_.items()}
        self.tc = {k: v.detach().clone() for k, v in self.c.items()}
        device = next(iter(self.p.values())).device
        self.log_alpha = torch.tensor(math.log(hp["init_alpha"]),
                                      device=device)
        self.hp, self.layers = hp, layers
        self.target_entropy = target_entropy
        self.product = _product(rounding)
        self.mu = {("p", k): torch.zeros_like(v) for k, v in self.p.items()}
        self.mu.update({("c", k): torch.zeros_like(v)
                        for k, v in self.c.items()})
        self.mu[("a", "log_alpha")] = torch.zeros_like(self.log_alpha)
        self.nu = {k: torch.zeros_like(v) for k, v in self.mu.items()}
        self.t = 0
        self.first_grads: Dict[tuple, torch.Tensor] | None = None

    def leaves(self) -> Dict[tuple, torch.Tensor]:
        out = {("p", k): v.detach() for k, v in self.p.items()}
        out.update({("c", k): v.detach() for k, v in self.c.items()})
        out.update({("t", k): v for k, v in self.tc.items()})
        out[("a", "log_alpha")] = self.log_alpha
        return out

    @torch.no_grad()
    def _adam(self, group: str, params: dict, grads: dict, lr: float):
        b1, b2, eps = self.hp["beta_1"], 0.999, 1e-8
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        names = list(grads)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        m = [self.mu[(group, k)] for k in names]
        v = [self.nu[(group, k)] for k in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        update = torch._foreach_div(m, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(p, update, alpha=-lr)

    def step(self, obs, action, reward, terminal, next_obs, eps_next,
             eps_new) -> torch.Tensor:
        """One gradient step in place; returns the step's 8 metrics."""
        hp, L, prod = self.hp, self.layers, self.product
        self.t += 1
        alpha = torch.exp(self.log_alpha)
        with torch.no_grad():
            mean_n, ls_n = policy_forward(self.p, next_obs, L, prod)
            a_n, logpi_n = sample(mean_n, ls_n, eps_next)
            tq = critics(self.tc, next_obs, a_n, L, prod)
            y = (hp["reward_scale"] * reward[:, None]
                 + (1.0 - terminal[:, None]) * hp["discount"]
                 * (torch.where(tq[0] <= tq[1], tq[0], tq[1])
                    - alpha * logpi_n))

        c = self.c
        q = critics(c, obs, action, L, prod)
        qf_losses = 0.5 * torch.mean((q - y[None]) ** 2, dim=(1, 2))
        gc = dict(zip(c, torch.autograd.grad(qf_losses.sum(),
                                             list(c.values()))))
        self._adam("c", self.c, gc, hp["qf_lr"])

        p = self.p
        mean, ls = policy_forward(p, obs, L, prod)
        a_new, logpi = sample(mean, ls, eps_new)
        qn = critics(self.c, obs, a_new, L, prod)
        qmin = torch.where(qn[0] <= qn[1], qn[0], qn[1])
        policy_loss = (torch.mean(alpha * logpi - qmin)
                       + hp["policy_mean_reg_weight"] * torch.mean(mean ** 2)
                       + hp["policy_std_reg_weight"] * torch.mean(ls ** 2))
        gp = dict(zip(p, torch.autograd.grad(policy_loss, list(p.values()))))
        self._adam("p", self.p, gp, hp["policy_lr"])
        with torch.no_grad():
            ga = -torch.mean(logpi.detach() + self.target_entropy)
            alpha_loss = self.log_alpha * ga
            if hp["train_alpha"]:
                la = {"log_alpha": self.log_alpha}
                self._adam("a", la, {"log_alpha": ga}, hp["alpha_lr"])
                self.log_alpha.clamp_(math.log(hp["min_alpha"]),
                                      math.log(hp["max_alpha"]))
            torch._foreach_lerp_(list(self.tc.values()),
                                 [v.detach() for v in self.c.values()],
                                 hp["soft_target_tau"])
            if self.first_grads is None:
                self.first_grads = {("c", k): g for k, g in gc.items()}
                self.first_grads.update({("p", k): g for k, g in gp.items()})
                self.first_grads[("a", "log_alpha")] = ga
            return torch.stack([
                qf_losses[0].detach(), qf_losses[1].detach(),
                policy_loss.detach(), alpha_loss, alpha,
                q[0].mean().detach(), q[1].mean().detach(), logpi.mean()])
