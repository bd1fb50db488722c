"""Fused SAC update chain: K gradient steps in one call, with kernel K2
(counterpart: ilswiss_tpu/ops/fused_sac.py).

At one gradient step per env step the loop runs `num_envs` sequential
batch-512 SAC updates per iteration, each some two hundred small eager
PyTorch launches.  `fused_sac_chain` runs the whole chain (critic target,
twin-critic forward and backward, tanh-Gaussian policy forward and
backward through the updated critics, Adam on the policy, the critics and
log alpha, Polyak targets, the eight metrics per step) in ONE launch of
`csrc/fused_sac.cu` for CUDA tensors, and `fused_sac_chain_plain` for CPU
tensors.

Both apply the same update as `SAC.train_step`, with the backward
derived by hand (no autograd), formula for formula the JAX kernel's:

  * tanh-Gaussian log-prob log pi(mean, ls, z, a), z = mean + sigma * eps,
    a = tanh(z): the base-Normal term's direct partials are d/dmean =
    +eps e^-ls, d/dz = -eps e^-ls, d/dls = eps^2 - 1; the Jacobian term
    -log(1 - a^2 + 1e-6) gives d/da = 2a / (1 - a^2 + 1e-6);
  * min() over the twin critics routes the policy gradient to the critic
    with the smaller Q, critic 0 on a tie;
  * the log-std clamp [-20, 2] masks its gradient outside the open
    interval;
  * Adam is optax.adam(b1, 0.999): bias correction 1 - b^t, update
    -lr * m_hat / (sqrt(v_hat) + 1e-8).

ONE SHARED ADAM STEP.  The bias correction of all three optimizers uses
t = policy_opt.count + k + 1 at step k, as the JAX kernel does.  That is
exact while the three counts advance in lockstep, which `train_step` and
this chain both keep (with `train_alpha=False` alpha's optimizer never
steps, so its count does not matter).  After the chain the policy's and
the critics' counts are advanced by K, and alpha's by K only when
`train_alpha`.

Both versions update the `SACState` IN PLACE (parameters, targets,
moments, log alpha, counts) and read the parameters where they live:
`nn.Linear` weights [out, in] for the policy, `TwinQ` kernels [2, in, out]
for the critics.  Everything is float32; the JAX default of bfloat16
products with float32 accumulation is not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from ilswiss_tpu_torch.models.distributions import (
    LOG_SIG_MAX, LOG_SIG_MIN, TANH_EPS,
)

METRIC_NAMES = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                "alpha", "q1_pred_mean", "q2_pred_mean", "log_pi_mean")
BATCH_KEYS = ("obs", "action", "reward", "terminal", "next_obs")
ADAM_B2 = 0.999
_LOG_2PI = math.log(2.0 * math.pi)

# limits of kernel K2 (SAC_MAX_* in csrc/fused_sac.cu)
MAX_HIDDEN, MAX_ACTION, MAX_WIDTH, MAX_BATCH = 4, 8, 1024, 4096


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _policy_fwd(layers, x):
    """(mean, raw log-std, [x, g1..gL]) through nn.Linear layers."""
    acts = [x]
    for lin in layers[:-2]:
        x = torch.relu(torch.addmm(lin.bias, x, lin.weight.t()))
        acts.append(x)
    mean = torch.addmm(layers[-2].bias, x, layers[-2].weight.t())
    ls_raw = torch.addmm(layers[-1].bias, x, layers[-1].weight.t())
    return mean, ls_raw, acts


def _critic_fwd(layers, x):
    """(q [2, B, 1], [x, h1..hL] each [2, B, .]) through both critics."""
    x = x.expand((2,) + x.shape)
    acts = [x]
    for w, b in layers[:-1]:
        x = torch.relu(torch.baddbmm(b[:, None, :], x, w))
        acts.append(x)
    w, b = layers[-1]
    return torch.baddbmm(b[:, None, :], x, w), acts


def _log_pi(eps, ls, a):
    return torch.sum(-0.5 * (eps * eps + 2.0 * ls + _LOG_2PI)
                     - torch.log(1.0 - a * a + TANH_EPS),
                     dim=-1, keepdim=True)


@torch.no_grad()
def fused_sac_chain_plain(sac, state, batches: Dict[str, torch.Tensor],
                          eps_next: torch.Tensor, eps_new: torch.Tensor):
    """K SAC gradient steps in tensor operations, the backward written out
    by hand.  `batches`: [K, B, ...] tensors under `BATCH_KEYS`; `eps_*`:
    [K, B, A] standard-normal draws.  Updates `state` in place and returns
    (state, metrics) with each metric a [K] tensor.  See the module
    docstring for the shared Adam step."""
    cfg = sac.config
    K, B = batches["reward"].shape
    n_obs, A = sac.obs_size, sac.action_size
    tau = cfg.soft_target_tau
    log_amin, log_amax = math.log(cfg.min_alpha), math.log(cfg.max_alpha)
    clip_q = cfg.q_target_min is not None or cfg.q_target_max is not None

    P = state.policy.hidden_layers() + [state.policy.mean,
                                        state.policy.log_std]
    L = len(P) - 2
    C = state.qf.layers()
    T = state.target_qf.layers()
    t0 = state.policy_opt.count
    rows = []
    for k in range(K):
        t = t0 + k + 1
        o, a_taken = batches["obs"][k], batches["action"][k]
        rew, term = batches["reward"][k, :, None], \
            batches["terminal"][k, :, None]
        no, eps_n, eps_w = batches["next_obs"][k], eps_next[k], eps_new[k]
        log_alpha = state.log_alpha.detach().clone()
        alpha = torch.exp(log_alpha)

        # ---- critic target: policy and alpha from before the step --------
        mean_n, lsr_n, _ = _policy_fwd(P, no)
        ls_n = torch.clamp(lsr_n, LOG_SIG_MIN, LOG_SIG_MAX)
        a_n = torch.tanh(mean_n + torch.exp(ls_n) * eps_n)
        logpi_n = _log_pi(eps_n, ls_n, a_n)
        tq, _ = _critic_fwd(T, torch.cat([no, a_n], dim=-1))
        min_tq = torch.minimum(tq[0], tq[1])
        y = cfg.reward_scale * rew + (1.0 - term) * cfg.discount * (
            min_tq - alpha * logpi_n)
        if clip_q:
            y = torch.clamp(y, cfg.q_target_min, cfg.q_target_max)

        # ---- critics: forward, backward, Adam -----------------------------
        q, acts = _critic_fwd(C, torch.cat([o, a_taken], dim=-1))
        diff = q - y
        qf_losses = 0.5 * torch.mean(diff * diff, dim=(1, 2))
        d = diff * (1.0 / B)                        # dL/dq, [2, B, 1]
        Cg = [None] * (2 * (L + 1))
        for i in range(L, -1, -1):
            Cg[2 * i] = torch.bmm(acts[i].transpose(1, 2), d)
            Cg[2 * i + 1] = torch.sum(d, dim=1)
            if i > 0:
                d = torch.bmm(d, C[i][0].transpose(1, 2)) * (acts[i] > 0.0)
        state.qf_opt.apply(Cg, t)

        # ---- policy against the UPDATED critics ---------------------------
        mean, lsr, pacts = _policy_fwd(P, o)
        ls = torch.clamp(lsr, LOG_SIG_MIN, LOG_SIG_MAX)
        sigma = torch.exp(ls)
        a_new = torch.tanh(mean + sigma * eps_w)
        one_m_a2 = 1.0 - a_new * a_new
        logpi = _log_pi(eps_w, ls, a_new)
        qn, kacts = _critic_fwd(C, torch.cat([o, a_new], dim=-1))
        qmin = torch.minimum(qn[0], qn[1])

        # dL/dq_e = -1/B to the critic with the smaller Q (0 on a tie)
        sel0 = (qn[0] <= qn[1]).to(q.dtype)
        d = (-1.0 / B) * torch.stack([sel0, 1.0 - sel0])
        for i in range(L, 0, -1):
            d = torch.bmm(d, C[i][0].transpose(1, 2)) * (kacts[i] > 0.0)
        dxn = torch.bmm(d, C[0][0].transpose(1, 2))
        da_q = dxn[0, :, n_obs:] + dxn[1, :, n_obs:]

        inv_sig = torch.exp(-ls)
        scale = alpha / B
        da_tot = da_q + scale * 2.0 * a_new / (one_m_a2 + TANH_EPS)
        dz = da_tot * one_m_a2 - scale * eps_w * inv_sig
        dmean = (dz + scale * eps_w * inv_sig
                 + (2.0 * cfg.policy_mean_reg_weight / (B * A)) * mean)
        dls = (dz * sigma * eps_w + scale * (eps_w * eps_w - 1.0)
               + (2.0 * cfg.policy_std_reg_weight / (B * A)) * ls)
        dls_raw = dls * ((lsr > LOG_SIG_MIN) & (lsr < LOG_SIG_MAX))

        # gradients in nn.Linear's [out, in] layout
        Pg = [None] * (2 * (L + 2))
        gL = pacts[L]
        for j, dh in ((L, dmean), (L + 1, dls_raw)):
            Pg[2 * j] = dh.t() @ gL
            Pg[2 * j + 1] = torch.sum(dh, dim=0)
        d = (dmean @ P[L].weight + dls_raw @ P[L + 1].weight) * (gL > 0.0)
        for i in range(L - 1, -1, -1):
            Pg[2 * i] = d.t() @ pacts[i]
            Pg[2 * i + 1] = torch.sum(d, dim=0)
            if i > 0:
                d = (d @ P[i].weight) * (pacts[i] > 0.0)
        state.policy_opt.apply(Pg, t)

        policy_loss = (torch.mean(alpha * logpi - qmin)
                       + cfg.policy_mean_reg_weight * torch.mean(mean * mean)
                       + cfg.policy_std_reg_weight * torch.mean(ls * ls))

        # ---- alpha ----------------------------------------------------------
        ga = -torch.mean(logpi + sac.target_entropy)
        alpha_loss = log_alpha * ga
        if cfg.train_alpha:
            state.alpha_opt.apply([ga], t)
            state.log_alpha.clamp_(log_amin, log_amax)

        # ---- Polyak: old targets with the new critics -------------------------
        for (tw, tb), (cw, cb) in zip(T, C):
            tw.mul_(1.0 - tau).add_(cw * tau)
            tb.mul_(1.0 - tau).add_(cb * tau)

        rows.append(torch.stack([
            qf_losses[0], qf_losses[1], policy_loss, alpha_loss, alpha,
            torch.mean(q[0]), torch.mean(q[1]), torch.mean(logpi)]))

    _advance_counts(state, K, cfg.train_alpha)
    table = torch.stack(rows)
    return state, {n: table[:, j] for j, n in enumerate(METRIC_NAMES)}


def _advance_counts(state, K: int, train_alpha: bool) -> None:
    state.policy_opt.count += K
    state.qf_opt.count += K
    if train_alpha:
        state.alpha_opt.count += K


# --------------------------------------------------------------------------
# Kernel K2
# --------------------------------------------------------------------------

_LIB: ctypes.CDLL | None = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C interface of csrc/fused_sac.cu on a loaded library."""
    p = ctypes.c_void_p
    lib.fused_sac_chain.argtypes = [p, ctypes.c_int, p, p, p]
    lib.fused_sac_chain.restype = ctypes.c_int
    lib.fused_sac_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.fused_sac_scratch_floats.restype = ctypes.c_longlong
    lib.fused_sac_error_string.argtypes = [ctypes.c_int]
    lib.fused_sac_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ilswiss_tpu_torch.kernels.build import load
        _LIB = _declare(load("fused_sac"))
    return _LIB


def _moments(opt, tensors):
    """[(mu, nu)] of `tensors` in the optimizer `opt`."""
    index = {id(p): i for i, p in enumerate(opt.params)}
    return [(opt.mu[index[id(t)]], opt.nu[index[id(t)]]) for t in tensors]


def _kernel_tensors(state):
    """The state tensors in the order `fused_sac_chain` of csrc/fused_sac.cu
    takes them: for each policy layer (trunk, mean, log-std) w, b, mu(w),
    mu(b), nu(w), nu(b); for each critic layer (trunk, output) kernel, bias,
    target kernel, target bias, mu(kernel), mu(bias), nu(kernel), nu(bias);
    then log alpha, its mu and its nu."""
    out = []
    pol = state.policy
    for lin in pol.hidden_layers() + [pol.mean, pol.log_std]:
        (mw, vw), (mb, vb) = _moments(state.policy_opt,
                                      (lin.weight, lin.bias))
        out += [lin.weight, lin.bias, mw, mb, vw, vb]
    for (w, b), (tw, tb) in zip(state.qf.layers(), state.target_qf.layers()):
        (mw, vw), (mb, vb) = _moments(state.qf_opt, (w, b))
        out += [w, b, tw, tb, mw, mb, vw, vb]
    (ma, va), = _moments(state.alpha_opt, (state.log_alpha,))
    return out + [state.log_alpha, ma, va]


def _kernel_inputs(sac, state, batches, eps_next, eps_new):
    """(streams, state tensors) as kernel K2 takes them; raises ValueError
    for what it does not take.  Runs before anything is built."""
    reward = batches["reward"]
    if reward.dim() != 2:
        raise ValueError("batches['reward'] must be [K, B]")
    K, B = reward.shape
    n_obs, A, hidden = sac.obs_size, sac.action_size, tuple(sac.hidden)
    L = len(hidden)
    if not (1 <= L <= MAX_HIDDEN and len(set(hidden)) == 1
            and 1 <= hidden[0] <= MAX_WIDTH and 1 <= n_obs <= MAX_WIDTH
            and 1 <= A <= MAX_ACTION and 1 <= B <= MAX_BATCH and K >= 1):
        raise ValueError(
            f"K2 takes 1..{MAX_HIDDEN} hidden layers of one width <= "
            f"{MAX_WIDTH}, obs size <= {MAX_WIDTH}, action size <= "
            f"{MAX_ACTION} and batches <= {MAX_BATCH}; got hidden {hidden}, "
            f"obs {n_obs}, action {A}, batch {B}, K {K}")
    streams = [batches[k] for k in BATCH_KEYS] + [eps_next, eps_new]
    shapes = [(K, B, n_obs), (K, B, A), (K, B), (K, B), (K, B, n_obs),
              (K, B, A), (K, B, A)]
    for name, t, shape in zip(BATCH_KEYS + ("eps_next", "eps_new"), streams,
                              shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tensors = _kernel_tensors(state)
    for t in streams + tensors:
        if (t.device != reward.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("K2 takes contiguous float32 tensors on "
                             f"{reward.device}; got {t.dtype}, "
                             f"{tuple(t.shape)} on {t.device}")
    return streams, tensors


def _launch(lib: ctypes.CDLL, sac, state, streams, tensors, stream
            ) -> torch.Tensor:
    """One call of the library's `fused_sac_chain` on checked inputs; returns
    the [K, 8] metrics table.  `lib` is the CUDA library, or in a test the
    CPU build of the same source (kernels/host_build.py)."""
    reward = streams[BATCH_KEYS.index("reward")]
    K, B = reward.shape
    n_obs, A, H, L = (sac.obs_size, sac.action_size, sac.hidden[0],
                      len(sac.hidden))
    cfg = sac.config
    scratch = torch.empty(lib.fused_sac_scratch_floats(B, H, L, n_obs, A),
                          dtype=torch.float32, device=reward.device)
    table = torch.empty((K, len(METRIC_NAMES)), dtype=torch.float32,
                        device=reward.device)
    ptrs = [t.data_ptr() for t in streams + tensors + [scratch, table]]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dims = (K, B, n_obs, A, H, L, state.policy_opt.count,
            int(cfg.train_alpha))
    c_dims = (ctypes.c_int * len(dims))(*dims)
    hyper = (cfg.discount, cfg.reward_scale, cfg.soft_target_tau, cfg.beta_1,
             ADAM_B2, cfg.qf_lr, cfg.policy_lr, cfg.alpha_lr,
             cfg.policy_mean_reg_weight, cfg.policy_std_reg_weight,
             sac.target_entropy, math.log(cfg.min_alpha),
             math.log(cfg.max_alpha),
             -math.inf if cfg.q_target_min is None else cfg.q_target_min,
             math.inf if cfg.q_target_max is None else cfg.q_target_max)
    c_hyper = (ctypes.c_double * len(hyper))(*hyper)
    err = lib.fused_sac_chain(c_ptrs, len(ptrs), c_dims, c_hyper, stream)
    if err != 0:
        raise RuntimeError("fused_sac_chain: "
                           + lib.fused_sac_error_string(err).decode())
    return table


def fused_sac_chain(sac, state, batches: Dict[str, torch.Tensor],
                    eps_next: torch.Tensor, eps_new: torch.Tensor):
    """Run K fused SAC gradient steps on `state`, in place.

    `batches`: dict of [K, B, ...] tensors (obs, action, reward, terminal,
    next_obs) sampled from the replay ring; `eps_next`, `eps_new`:
    [K, B, A] standard-normal draws, the ones `train_step` would get at
    each step.  Returns (state, metrics): each metric a [K] tensor.

    CPU tensors take `fused_sac_chain_plain`.  CUDA tensors launch kernel
    K2 once on the current stream and add one to
    `fused_sac_chain.launches`; the call raises ValueError for inputs the
    kernel does not take (anything but contiguous float32 tensors on one
    device, more than 4 hidden layers, widths over 1024, more than 8
    action dimensions, batches over 4096) and RuntimeError when the
    launch fails.  See the module docstring for the shared Adam step."""
    reward = batches["reward"]
    if reward.device.type == "cpu":
        return fused_sac_chain_plain(sac, state, batches, eps_next, eps_new)
    if reward.device.type != "cuda":
        raise ValueError(f"unsupported device {reward.device}")
    streams, tensors = _kernel_inputs(sac, state, batches, eps_next, eps_new)
    stream = torch.cuda.current_stream(reward.device).cuda_stream
    table = _launch(_lib(), sac, state, streams, tensors, stream)
    fused_sac_chain.launches += 1
    _advance_counts(state, reward.shape[0], sac.config.train_alpha)
    return state, {n: table[:, j] for j, n in enumerate(METRIC_NAMES)}


fused_sac_chain.launches = 0
