"""Bridge between the JAX package's state and the port's (no JAX
counterpart).

It reads the JAX state as numpy arrays: any object with the JAX state's
attribute names whose leaves are numpy arrays, for example
`jax.tree.map(np.asarray, state)`.  It never imports JAX.  The layouts it
maps:

  * a flax Dense kernel is [in, out]; `nn.Linear.weight` is [out, in];
  * the twin critics are stacked [2, in, out] on both sides (`TwinQ`);
  * `optax.flatten` keeps each of SAC's optimizers' Adam moments as ONE
    ravelled vector in `ravel_pytree` order: dict keys sorted, so `bias`
    before `kernel` and the policy layers `hidden_0, hidden_1, log_std,
    mean`; a kernel is ravelled in its flax [in, out] layout;
  * a plain `optax.adam` (the AdvIRL discriminator's, and every optimizer
    of TD3, DDPG, SAC-V, discrete SAC and DQN) keeps its moments as trees
    shaped like its params; the discriminator's BatchNorm running averages
    are the `batch_stats` collection;
  * the other off-policy trainers' states keep one params tree per
    network (`<name>_params`, the port's module `<name>`), one optimizer
    per trained network and their step counters, which become ints;
  * a JAX demo buffer of stride 1 has `env_ep=None`, the port's a zero
    vector of length 1 (data/demo.py);
  * PPO's optimizers are optax chains: the policy's `(clip state, adam
    state)`, the clip stateless, and the value net's plain adam, each
    adam's moments trees shaped like the params; the Gaussian policy's
    free log-std is the leaf `log_std` [A];
  * the rnn discriminator's cells keep flax's gate names, each gate a
    Dense (`cell_f0.ir` is `params/cell_f0/ir`);
  * the ensemble model's layers keep flax's [E, in, out] kernels and
    [E, 1, out] biases untransposed; its optimizer is a plain optax.adam
    and its elites become int64;
  * BC's and GCSL's states are one policy (tanh-Gaussian, or GCSL's
    categorical `mlp`) and its plain optax.adam;
  * a goal env's observation is a dict of arrays, and the hindsight ring
    keeps the JAX field names;
  * a flax Conv kernel is [kh, kw, in, out] and `conv2d`'s weight
    [out, in, kh, kw]; a flax ConvTranspose kernel [kh, kw, in, out] is
    applied unflipped (transpose_kernel=False), while `conv_transpose2d`
    (the adjoint of a conv) flips its [in, out, kh, kw] weight, so the
    converter transposes AND flips both spatial axes; a flax LayerNorm's
    `scale` is `nn.LayerNorm.weight`;
  * SAC-AE's optimizers are plain optax.adams over tuples of trees:
    `qf_opt` over (encoder, qf1, qf2), `encdec_opt` over (encoder,
    decoder), `cpc_opt` over (encoder, W), and `policy_opt`, `alpha_opt`;
    its step counter becomes an int.

  * a JAX host runner's env-step count is a static field, an int on
    both sides; its key has no counterpart: the port's runner draws from
    a `Noise` and seeds its collector with the run's seed.

  * a JAX distributed runner stacks its shards: `env_state` and the
    ring's rows are [n * B, ...] and [n * cap, ...], `ptr`, `size`,
    `total_env_steps` and the keys [n]; the port's runners are one per
    rank (parallel/distributed.py), and rank r holds rows r * B to
    (r + 1) * B of the envs, ring shard r and its counters; the
    replicated learner state goes to every rank.

The `*_to_numpy` functions go the other way, into the JAX layouts, so a
test compares like with like.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLState
from ilswiss_tpu_torch.algorithms.bc import BCState
from ilswiss_tpu_torch.algorithms.gcsl import GCSLState
from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNState, BNNTrainer
from ilswiss_tpu_torch.algorithms.ddpg import DDPGState
from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOState
from ilswiss_tpu_torch.algorithms.discrete_sac import DiscreteSACState
from ilswiss_tpu_torch.algorithms.dqn import DQNState
from ilswiss_tpu_torch.algorithms.mbpo import MBPO, MBPORunnerState
from ilswiss_tpu_torch.algorithms.sac import SAC, Adam, SACState, TwinQ
from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEState
from ilswiss_tpu_torch.algorithms.sac_v import SACVState
from ilswiss_tpu_torch.algorithms.td3 import TD3State
from ilswiss_tpu_torch.data.her import HindsightReplayState
from ilswiss_tpu_torch.data.replay import ReplayState
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.models.bnn import InputNormalizer
from ilswiss_tpu_torch.models.discriminators import CNNDisc, MLPDisc
from ilswiss_tpu_torch.models.encoders import PixelDecoder, PixelEncoder
from ilswiss_tpu_torch.models.policies import (
    GaussianPolicy, TanhGaussianPolicy,
)
from ilswiss_tpu_torch.models.rnn_discriminators import RNNDisc
from ilswiss_tpu_torch.runtime.loop import RunnerState
from ilswiss_tpu_torch.runtime.host_loop import (
    HostOnPolicyRunnerState, HostRunnerState,
)
from ilswiss_tpu_torch.runtime.onpolicy import (
    OnPolicyLoop, OnPolicyRunnerState,
)
from ilswiss_tpu_torch.utils.running_stats import RunningMeanStd

# (port tensor, flax path, layout); the lists that feed optax.flatten's
# moments are in ravel_pytree order.  The layout is False (as is), True
# (a Dense kernel, transposed), "conv" or "deconv" (see the docstring)
_Leaf = Tuple[torch.Tensor, Tuple[str, ...], Any]


def _module_leaves(module: torch.nn.Module) -> List[_Leaf]:
    """Every parameter of a module built of `nn.Linear` layers named as
    the flax layers (MLP, FlattenMLP, the policies), at its path in the
    flax variables: `a.b.weight` is ("params", "a", "b", "kernel")."""
    out = []
    for name, t in module.named_parameters():
        *path, kind = name.split(".")
        out.append((t, ("params", *path,
                        "kernel" if kind == "weight" else kind),
                    kind == "weight"))
    return out


def _policy_leaves(policy: TanhGaussianPolicy) -> List[_Leaf]:
    """The policy's leaves in ravel_pytree order (paths sorted)."""
    return sorted(_module_leaves(policy), key=lambda leaf: leaf[1])


def _twinq_leaves(qf: TwinQ) -> List[_Leaf]:
    out = []
    for name in sorted(qf.names):
        out.append((getattr(qf, f"{name}_bias"),
                    ("params", "mlp", name, "bias"), False))
        out.append((getattr(qf, f"{name}_kernel"),
                    ("params", "mlp", name, "kernel"), False))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_flax(t: torch.Tensor, layout) -> np.ndarray:
    x = t.detach().cpu().numpy()
    if layout == "conv":                     # [out, in, kh, kw] -> flax
        return x.transpose(2, 3, 1, 0)
    if layout == "deconv":                   # flipped [in, out, kh, kw]
        return x[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return x.T if layout else x


def _from_flax(x, t: torch.Tensor, layout) -> torch.Tensor:
    x = np.asarray(x)
    if layout == "conv":
        x = x.transpose(3, 2, 0, 1)
    elif layout == "deconv":
        x = x.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    elif layout:
        x = x.T
    return torch.as_tensor(np.array(x), dtype=t.dtype,
                           device=t.device).reshape(t.shape)


@torch.no_grad()
def _load_leaves(leaves: List[_Leaf], params) -> None:
    for t, path, tr in leaves:
        t.copy_(_from_flax(_get(params, path), t, tr))


def _dump_leaves(leaves: List[_Leaf]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for t, path, tr in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_flax(t, tr)
    return out


def _moments_of(opt: Adam, leaves: List[_Leaf], moments):
    """`moments` (in the optimizer's parameter order) in leaf order."""
    index = {id(p): i for i, p in enumerate(opt.params)}
    return [moments[index[id(t)]] for t, _, _ in leaves]


@torch.no_grad()
def _load_adam(opt: Adam, leaves: List[_Leaf], adam_state) -> None:
    """Unravel optax's flat mu/nu into the per-parameter moments."""
    opt.count = int(np.asarray(adam_state.count))
    for flat, moments in ((adam_state.mu, opt.mu), (adam_state.nu, opt.nu)):
        flat = np.asarray(flat)
        off = 0
        for (t, _, tr), m in zip(leaves, _moments_of(opt, leaves, moments)):
            n = t.numel()
            shape = tuple(reversed(t.shape)) if tr else tuple(t.shape)
            m.copy_(_from_flax(flat[off:off + n].reshape(shape), m, tr))
            off += n
        if off != flat.size:
            raise ValueError(f"moment vector has {flat.size} entries, the "
                             f"parameters {off}")


def _dump_adam(opt: Adam, leaves: List[_Leaf]) -> Dict[str, Any]:
    def ravel(moments):
        return np.concatenate([
            _to_flax(m, tr).reshape(-1)
            for (_, _, tr), m in zip(leaves,
                                     _moments_of(opt, leaves, moments))])
    return {"count": opt.count, "mu": ravel(opt.mu), "nu": ravel(opt.nu)}


@torch.no_grad()
def _load_adam_tree(opt: Adam, leaves: List[_Leaf], adam_state) -> None:
    """A plain optax.adam's count and moment trees into `opt`."""
    opt.count = int(np.asarray(adam_state.count))
    for tree, moments in ((adam_state.mu, opt.mu), (adam_state.nu, opt.nu)):
        for (t, path, tr), m in zip(leaves,
                                    _moments_of(opt, leaves, moments)):
            m.copy_(_from_flax(_get(tree, path), m, tr))


def _dump_adam_tree(opt: Adam, leaves: List[_Leaf]) -> Dict[str, Any]:
    def tree(moments):
        return _dump_leaves([(m, path, tr) for (_, path, tr), m in zip(
            leaves, _moments_of(opt, leaves, moments))])
    return {"count": opt.count, "mu": tree(opt.mu), "nu": tree(opt.nu)}


def _alpha_leaves(state: SACState) -> List[_Leaf]:
    return [(state.log_alpha, (), False)]


def sac_state_from_jax(sac: SAC, jstate) -> SACState:
    """A SACState on `sac`'s device holding the JAX SACState's values:
    params, targets, log alpha, and each optimizer's moments and count."""
    state = sac.init(0)
    _load_leaves(_policy_leaves(state.policy), jstate.policy_params)
    _load_leaves(_twinq_leaves(state.qf), jstate.qf_params)
    _load_leaves(_twinq_leaves(state.target_qf), jstate.target_qf_params)
    with torch.no_grad():
        state.log_alpha.copy_(torch.as_tensor(np.array(jstate.log_alpha)))
    _load_adam(state.policy_opt, _policy_leaves(state.policy),
               jstate.policy_opt[0])
    _load_adam(state.qf_opt, _twinq_leaves(state.qf), jstate.qf_opt[0])
    _load_adam(state.alpha_opt, _alpha_leaves(state), jstate.alpha_opt[0])
    return state


def sac_state_to_numpy(state: SACState) -> Dict[str, Any]:
    """The port's SACState in the JAX layouts: flax param dicts, and per
    optimizer {"count", "mu", "nu"} with the moments ravelled as optax
    keeps them."""
    return {
        "policy_params": _dump_leaves(_policy_leaves(state.policy)),
        "qf_params": _dump_leaves(_twinq_leaves(state.qf)),
        "target_qf_params": _dump_leaves(_twinq_leaves(state.target_qf)),
        "log_alpha": state.log_alpha.detach().cpu().numpy(),
        "policy_opt": _dump_adam(state.policy_opt,
                                 _policy_leaves(state.policy)),
        "qf_opt": _dump_adam(state.qf_opt, _twinq_leaves(state.qf)),
        "alpha_opt": _dump_adam(state.alpha_opt, _alpha_leaves(state)),
    }


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _obs_from_jax(obs, device):
    if isinstance(obs, dict):
        return {k: _tensor(v, device, torch.float32) for k, v in obs.items()}
    return _tensor(obs, device, torch.float32)


def _obs_to_numpy(obs):
    if isinstance(obs, dict):
        return {k: v.cpu().numpy() for k, v in obs.items()}
    return obs.cpu().numpy()


def env_state_from_jax(jstate, device) -> EnvState:
    """A batched EnvState: internal (locomotion: q, qd, warm-start row
    forces, [B, 38] for hopper, [B, 116] for ant; a classic env's one
    [B, n] array becomes a 1-tuple; reach2d's (pos_vel, goal)), obs (a
    goal env's a dict) and t; the JAX per-env keys have no counterpart and
    are dropped."""
    internal = jstate.internal
    if not isinstance(internal, (tuple, list)):
        internal = (internal,)
    return EnvState(
        internal=tuple(_tensor(x, device, torch.float32) for x in internal),
        obs=_obs_from_jax(jstate.obs, device),
        t=_tensor(jstate.t, device, torch.int32),
    )


def env_state_to_numpy(state: EnvState) -> Dict[str, Any]:
    return {"internal": tuple(x.cpu().numpy() for x in state.internal),
            "obs": _obs_to_numpy(state.obs), "t": state.t.cpu().numpy()}


def replay_from_jax(jreplay, device) -> ReplayState:
    env_ep = (np.zeros((1,), np.int32) if jreplay.env_ep is None
              else jreplay.env_ep)
    return ReplayState(
        data={k: _tensor(v, device) for k, v in jreplay.data.items()},
        ep_id=_tensor(jreplay.ep_id, device, torch.int32),
        ptr=int(np.asarray(jreplay.ptr)),
        size=int(np.asarray(jreplay.size)),
        env_ep=_tensor(env_ep, device, torch.int32),
    )


def replay_to_numpy(state: ReplayState) -> Dict[str, Any]:
    return {"data": {k: v.cpu().numpy() for k, v in state.data.items()},
            "ep_id": state.ep_id.cpu().numpy(), "ptr": state.ptr,
            "size": state.size, "env_ep": state.env_ep.cpu().numpy()}


def _disc_leaves(disc: MLPDisc) -> List[_Leaf]:
    """Every parameter, at its path in the flax params tree."""
    out = []
    for i in range(disc.num_layer_blocks):
        dense = getattr(disc, f"dense_{i}")
        out.append((dense.weight, (f"dense_{i}", "kernel"), True))
        out.append((dense.bias, (f"dense_{i}", "bias"), False))
    for i, bn in enumerate(disc.batch_norms()):
        out.append((bn.scale, (f"bn_{i}", "scale"), False))
        out.append((bn.bias, (f"bn_{i}", "bias"), False))
    out.append((disc.logit.weight, ("logit", "kernel"), True))
    out.append((disc.logit.bias, ("logit", "bias"), False))
    return out


def _bn_stat_leaves(disc: MLPDisc) -> List[_Leaf]:
    return [(getattr(bn, s), (f"bn_{i}", s), False)
            for i, bn in enumerate(disc.batch_norms())
            for s in ("mean", "var")]


def disc_from_jax(disc: MLPDisc, variables) -> None:
    """Load a flax MLPDisc's variables ({"params"[, "batch_stats"]})
    into `disc`, in place."""
    _load_leaves(_disc_leaves(disc), variables["params"])
    if disc.use_bn:
        _load_leaves(_bn_stat_leaves(disc), variables["batch_stats"])


def disc_to_numpy(disc: MLPDisc) -> Dict[str, Any]:
    out = {"params": _dump_leaves(_disc_leaves(disc))}
    if disc.use_bn:
        out["batch_stats"] = _dump_leaves(_bn_stat_leaves(disc))
    return out


def _rnn_disc_leaves(disc: RNNDisc) -> List[_Leaf]:
    """Every parameter, at its path in the flax params tree (embed, each
    direction's cells gate by gate, logit)."""
    return [(t, path[1:], tr) for t, path, tr in _module_leaves(disc)]


def rnn_disc_from_jax(disc: RNNDisc, variables) -> None:
    """Load a flax RNNDisc's variables ({"params"}) into `disc`, in
    place."""
    _load_leaves(_rnn_disc_leaves(disc), variables["params"])


def rnn_disc_to_numpy(disc: RNNDisc) -> Dict[str, Any]:
    return {"params": _dump_leaves(_rnn_disc_leaves(disc))}


def _any_disc_leaves(disc) -> List[_Leaf]:
    if isinstance(disc, CNNDisc):
        return _cnn_disc_leaves(disc)
    return (_rnn_disc_leaves(disc) if isinstance(disc, RNNDisc)
            else _disc_leaves(disc))


def adv_irl_state_from_jax(algo: AdvIRL, jstate) -> AdvIRLState:
    """An AdvIRLState on the inner trainer's device holding the JAX
    AdvIRLState's values: the discriminator's parameters and running
    averages, its Adam's moments and count, the inner SACState, the
    expert buffer and the reward statistics."""
    state = algo.init(0)
    if isinstance(state.disc, RNNDisc):
        rnn_disc_from_jax(state.disc, jstate.disc_params)
    elif isinstance(state.disc, CNNDisc):
        cnn_disc_from_jax(state.disc, jstate.disc_params)
    else:
        disc_from_jax(state.disc, jstate.disc_params)
    _load_adam_tree(state.disc_opt, _any_disc_leaves(state.disc),
                    jstate.disc_opt[0])
    state.policy = sac_state_from_jax(algo.policy_trainer, jstate.policy)
    state.expert = replay_from_jax(jstate.expert, algo.device)
    if jstate.rew_stats is not None:
        state.rew_stats = tuple(_tensor(x, algo.device, torch.float32)
                                for x in jstate.rew_stats)
    return state


def adv_irl_state_to_numpy(state: AdvIRLState) -> Dict[str, Any]:
    """The port's AdvIRLState in the JAX layouts: `disc_params` as flax
    variables, `disc_opt` {"count", "mu", "nu"} with moment trees shaped
    like the params, the inner state as `sac_state_to_numpy`, the expert
    buffer as `replay_to_numpy`, and `rew_stats`."""
    dump = (rnn_disc_to_numpy if isinstance(state.disc, RNNDisc)
            else cnn_disc_to_numpy if isinstance(state.disc, CNNDisc)
            else disc_to_numpy)
    return {
        "disc_params": dump(state.disc),
        "disc_opt": _dump_adam_tree(state.disc_opt,
                                    _any_disc_leaves(state.disc)),
        "policy": sac_state_to_numpy(state.policy),
        "expert": replay_to_numpy(state.expert),
        "rew_stats": (None if state.rew_stats is None else
                      tuple(x.cpu().numpy() for x in state.rew_stats)),
    }


def batches_from_numpy(batches: Dict[str, Any], device
                       ) -> Dict[str, torch.Tensor]:
    """A dict of [K, B, ...] arrays (the fused chain's pre-sampled batches,
    or any batch dict) as tensors on `device`: float32, but integer arrays
    (a discrete env's actions) keep their dtype."""
    return {k: _tensor(v, device, None if np.issubdtype(
        np.asarray(v).dtype, np.integer) else torch.float32)
        for k, v in batches.items()}


# --- TD3, DDPG, SAC-V, discrete SAC, DQN ---------------------------------
# per state class: the networks (JAX field `<name>_params`), the optimizers
# (JAX field `<opt>`, a plain optax.adam over the network `<module>`) and
# the step counters
_LAYOUTS = {
    TD3State: (("policy", "qf1", "qf2", "target_policy", "target_qf1",
                "target_qf2"),
               {"policy_opt": "policy", "qf1_opt": "qf1", "qf2_opt": "qf2"},
               ("n_train_steps",)),
    DDPGState: (("policy", "qf", "target_policy", "target_qf"),
                {"policy_opt": "policy", "qf_opt": "qf"},
                ("n_train_steps",)),
    SACVState: (("policy", "qf1", "qf2", "vf", "target_vf"),
                {"policy_opt": "policy", "qf1_opt": "qf1",
                 "qf2_opt": "qf2", "vf_opt": "vf"}, ()),
    DiscreteSACState: (("policy", "qf1", "qf2", "target_qf1",
                        "target_qf2"),
                       {"policy_opt": "policy", "qf1_opt": "qf1",
                        "qf2_opt": "qf2"}, ()),
    DQNState: (("qf", "target_qf"), {"qf_opt": "qf"},
               ("n_train_steps", "n_act_steps")),
}


def offpolicy_state_from_jax(algo, jstate):
    """The port state of `algo` (TD3, DDPG, SACV, DiscreteSAC or DQN) on
    its device, holding the JAX state's values: every network's params,
    each Adam's moments and count, and the step counters."""
    state = algo.init(0)
    modules, opts, counters = _LAYOUTS[type(state)]
    for name in modules:
        _load_leaves(_module_leaves(getattr(state, name)),
                     getattr(jstate, f"{name}_params"))
    for opt, module in opts.items():
        _load_adam_tree(getattr(state, opt),
                        _module_leaves(getattr(state, module)),
                        getattr(jstate, opt)[0])
    for name in counters:
        setattr(state, name, int(np.asarray(getattr(jstate, name))))
    return state


def offpolicy_state_to_numpy(state) -> Dict[str, Any]:
    """Such a port state in the JAX layouts: `<name>_params` flax trees,
    per optimizer {"count", "mu", "nu"} with moment trees shaped like the
    params, and the counters."""
    modules, opts, counters = _LAYOUTS[type(state)]
    out: Dict[str, Any] = {
        f"{name}_params": _dump_leaves(_module_leaves(getattr(state, name)))
        for name in modules}
    for opt, module in opts.items():
        out[opt] = _dump_adam_tree(getattr(state, opt),
                                   _module_leaves(getattr(state, module)))
    out.update({name: getattr(state, name) for name in counters})
    return out


# the five trainers share one layout rule
td3_state_from_jax = ddpg_state_from_jax = sac_v_state_from_jax = \
    discrete_sac_state_from_jax = dqn_state_from_jax = offpolicy_state_from_jax
td3_state_to_numpy = ddpg_state_to_numpy = sac_v_state_to_numpy = \
    discrete_sac_state_to_numpy = dqn_state_to_numpy = offpolicy_state_to_numpy


# --- PPO and its on-policy runner ------------------------------------------
def gaussian_policy_from_jax(policy: GaussianPolicy, params) -> None:
    """Load a flax GaussianPolicy's variables into `policy`, in place."""
    _load_leaves(_module_leaves(policy), params)


def gaussian_policy_to_numpy(policy: GaussianPolicy) -> Dict[str, Any]:
    return _dump_leaves(_module_leaves(policy))


def ppo_state_from_jax(ppo: PPO, jstate) -> PPOState:
    """A PPOState on `ppo`'s device holding the JAX PPOState's values: both
    networks, and both Adams' moments and counts (the policy's adam is the
    second link of its chain, after the stateless global-norm clip)."""
    state = ppo.init(0)
    gaussian_policy_from_jax(state.policy, jstate.policy_params)
    _load_leaves(_module_leaves(state.vf), jstate.vf_params)
    _load_adam_tree(state.policy_opt, _module_leaves(state.policy),
                    jstate.policy_opt[1][0])
    _load_adam_tree(state.vf_opt, _module_leaves(state.vf),
                    jstate.vf_opt[0])
    return state


def ppo_state_to_numpy(state: PPOState) -> Dict[str, Any]:
    """The port's PPOState in the JAX layouts: flax param trees, and per
    optimizer {"count", "mu", "nu"} with moment trees shaped like the
    params."""
    return {
        "policy_params": gaussian_policy_to_numpy(state.policy),
        "vf_params": _dump_leaves(_module_leaves(state.vf)),
        "policy_opt": _dump_adam_tree(state.policy_opt,
                                      _module_leaves(state.policy)),
        "vf_opt": _dump_adam_tree(state.vf_opt, _module_leaves(state.vf)),
    }


def running_mean_std_from_jax(jrms, device) -> RunningMeanStd | None:
    if jrms is None:
        return None
    return RunningMeanStd(mean=_tensor(jrms.mean, device, torch.float32),
                          var=_tensor(jrms.var, device, torch.float32),
                          count=_tensor(jrms.count, device, torch.float32))


def running_mean_std_to_numpy(rms: RunningMeanStd | None
                              ) -> Dict[str, Any] | None:
    if rms is None:
        return None
    return {k: getattr(rms, k).cpu().numpy()
            for k in ("mean", "var", "count")}


def onpolicy_runner_from_jax(loop: OnPolicyLoop, jrunner, noise
                             ) -> OnPolicyRunnerState:
    """An OnPolicyRunnerState holding the JAX runner's env state, PPO
    state, moments and step count, drawing from `noise` (the JAX runner's
    key has no counterpart)."""
    device = loop.device
    return OnPolicyRunnerState(
        noise=noise,
        env_state=env_state_from_jax(jrunner.env_state, device),
        algo_state=ppo_state_from_jax(loop.algo, jrunner.algo_state),
        total_env_steps=int(np.asarray(jrunner.total_env_steps)),
        obs_rms=running_mean_std_from_jax(jrunner.obs_rms, device))


# --- the distributed runners' ranks -----------------------------------------
def _algo_state_from_jax(algo, jstate):
    if isinstance(algo, SAC):
        return sac_state_from_jax(algo, jstate)
    if isinstance(algo, AdvIRL):
        return adv_irl_state_from_jax(algo, jstate)
    if isinstance(algo, PPO):
        return ppo_state_from_jax(algo, jstate)
    return offpolicy_state_from_jax(algo, jstate)


def _shard(x, rank: int, world_size: int):
    x = np.asarray(x)
    rows = x.shape[0] // world_size
    return x[rank * rows:(rank + 1) * rows]


def _env_shard(jstate, rank: int, world_size: int):
    internal = jstate.internal
    internal = (tuple(_shard(x, rank, world_size) for x in internal)
                if isinstance(internal, (tuple, list))
                else _shard(internal, rank, world_size))
    return SimpleNamespace(internal=internal,
                           obs=_shard(jstate.obs, rank, world_size),
                           t=_shard(jstate.t, rank, world_size))


def rank_runner_from_jax(loop, jrunner, rank: int, world_size: int, noise
                         ) -> RunnerState:
    """Rank `rank`'s RunnerState, on `loop`'s device, of a JAX
    `DistributedOffPolicyRunner` state stacked over `world_size` shards:
    its env rows, its ring shard with its cursor, size and episode
    counters, its env-step count, and the replicated algorithm state;
    drawing from `noise`."""
    device, r = loop.device, jrunner.replay
    ring = SimpleNamespace(
        data={k: _shard(v, rank, world_size) for k, v in r.data.items()},
        ep_id=_shard(r.ep_id, rank, world_size),
        ptr=np.asarray(r.ptr)[rank], size=np.asarray(r.size)[rank],
        env_ep=_shard(r.env_ep, rank, world_size))
    return RunnerState(
        noise=noise,
        env_state=env_state_from_jax(
            _env_shard(jrunner.env_state, rank, world_size), device),
        replay=replay_from_jax(ring, device),
        algo_state=_algo_state_from_jax(loop.algo, jrunner.algo_state),
        total_env_steps=int(np.asarray(jrunner.total_env_steps)[rank]))


def rank_onpolicy_runner_from_jax(loop: OnPolicyLoop, jrunner, rank: int,
                                  world_size: int, noise
                                  ) -> OnPolicyRunnerState:
    """Rank `rank`'s OnPolicyRunnerState of a JAX
    `DistributedOnPolicyRunner` state: its env rows and env-step count,
    the replicated PPO state and moments; drawing from `noise`."""
    device = loop.device
    return OnPolicyRunnerState(
        noise=noise,
        env_state=env_state_from_jax(
            _env_shard(jrunner.env_state, rank, world_size), device),
        algo_state=ppo_state_from_jax(loop.algo, jrunner.algo_state),
        total_env_steps=int(np.asarray(jrunner.total_env_steps)[rank]),
        obs_rms=running_mean_std_from_jax(jrunner.obs_rms, device))


# --- the host loops' runners -----------------------------------------------
def host_runner_from_jax(loop, jrunner, noise, seed: int = 0
                         ) -> HostRunnerState:
    """A HostRunnerState on `loop`'s device holding the JAX host runner's
    ring, its SAC or AdvIRL state and its env-step count, drawing from
    `noise`, its collector seeded with `seed`."""
    algo = loop.algo
    from_jax = (adv_irl_state_from_jax if isinstance(algo, AdvIRL)
                else sac_state_from_jax)
    return HostRunnerState(
        noise=noise, replay=replay_from_jax(jrunner.replay, loop.device),
        algo_state=from_jax(algo, jrunner.algo_state),
        total_env_steps=int(jrunner.total_env_steps), seed=seed)


def host_onpolicy_runner_from_jax(loop, jrunner, noise, seed: int = 0
                                  ) -> HostOnPolicyRunnerState:
    """A HostOnPolicyRunnerState holding the JAX host runner's PPO state,
    moments and env-step count, drawing from `noise`, its collector seeded
    with `seed`."""
    return HostOnPolicyRunnerState(
        noise=noise, algo_state=ppo_state_from_jax(loop.algo,
                                                   jrunner.algo_state),
        total_env_steps=int(jrunner.total_env_steps), seed=seed,
        obs_rms=running_mean_std_from_jax(jrunner.obs_rms, loop.device))


# --- MBPO: the ensemble model and the runner --------------------------------
def bnn_state_from_jax(trainer: BNNTrainer, jstate) -> BNNState:
    """A BNNState on the trainer's device holding the JAX BNNState's
    values: the ensemble's params, its Adam's moments and count, the
    input moments, the elites and the holdout MSEs."""
    state = trainer.init(0)
    leaves = _module_leaves(state.params)
    _load_leaves(leaves, jstate.params)
    _load_adam_tree(state.opt_state, leaves, jstate.opt_state[0])
    device = trainer.device
    state.normalizer = InputNormalizer(
        mean=_tensor(jstate.normalizer.mean, device, torch.float32),
        std=_tensor(jstate.normalizer.std, device, torch.float32))
    state.elites = _tensor(jstate.elites, device, torch.int64)
    state.holdout_mse = _tensor(jstate.holdout_mse, device, torch.float32)
    return state


def bnn_state_to_numpy(state: BNNState) -> Dict[str, Any]:
    """The port's BNNState in the JAX layouts: `params` as flax variables,
    `opt_state` {"count", "mu", "nu"} with moment trees shaped like the
    params, the normalizer's `mean` and `std`, `elites`, `holdout_mse`."""
    leaves = _module_leaves(state.params)
    return {
        "params": _dump_leaves(leaves),
        "opt_state": _dump_adam_tree(state.opt_state, leaves),
        "normalizer": {"mean": state.normalizer.mean.cpu().numpy(),
                       "std": state.normalizer.std.cpu().numpy()},
        "elites": state.elites.cpu().numpy(),
        "holdout_mse": state.holdout_mse.cpu().numpy(),
    }


def mbpo_runner_from_jax(mbpo: MBPO, jrunner, noise) -> MBPORunnerState:
    """An MBPORunnerState on `mbpo`'s device holding the JAX runner's env
    state, both rings, the inner SACState, the BNNState and the step
    count, drawing from `noise` (the JAX runner's key has no
    counterpart)."""
    device = mbpo.device
    return MBPORunnerState(
        noise=noise,
        env_state=env_state_from_jax(jrunner.env_state, device),
        replay=replay_from_jax(jrunner.replay, device),
        model_replay=replay_from_jax(jrunner.model_replay, device),
        algo_state=sac_state_from_jax(mbpo.algo, jrunner.algo_state),
        bnn_state=bnn_state_from_jax(mbpo.bnn, jrunner.bnn_state),
        total_env_steps=int(np.asarray(jrunner.total_env_steps)))


def mbpo_runner_to_numpy(runner: MBPORunnerState) -> Dict[str, Any]:
    return {"env_state": env_state_to_numpy(runner.env_state),
            "replay": replay_to_numpy(runner.replay),
            "model_replay": replay_to_numpy(runner.model_replay),
            "algo_state": sac_state_to_numpy(runner.algo_state),
            "bnn_state": bnn_state_to_numpy(runner.bnn_state),
            "total_env_steps": runner.total_env_steps}


def metrics_to_numpy(metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


# --- BC, GCSL and the hindsight ring ----------------------------------------
def policy_state_from_jax(algo, jstate):
    """A BCState or GCSLState on `algo`'s device holding the JAX state's
    values: the policy's params and its plain optax.adam's moments and
    count."""
    state = algo.init(0)
    leaves = _module_leaves(state.policy)
    _load_leaves(leaves, jstate.policy_params)
    _load_adam_tree(state.policy_opt, leaves, jstate.policy_opt[0])
    return state


def policy_state_to_numpy(state: BCState | GCSLState) -> Dict[str, Any]:
    """Such a state in the JAX layouts: the flax param tree and
    {"count", "mu", "nu"} with moment trees shaped like the params."""
    leaves = _module_leaves(state.policy)
    return {"policy_params": _dump_leaves(leaves),
            "policy_opt": _dump_adam_tree(state.policy_opt, leaves)}


bc_state_from_jax = gcsl_state_from_jax = policy_state_from_jax
bc_state_to_numpy = gcsl_state_to_numpy = policy_state_to_numpy


def hindsight_from_jax(jstate, device) -> HindsightReplayState:
    return HindsightReplayState(
        data={k: _tensor(v, device) for k, v in jstate.data.items()},
        ep_len=_tensor(jstate.ep_len, device, torch.int32),
        cur_slot=_tensor(jstate.cur_slot, device, torch.int32),
        cur_t=_tensor(jstate.cur_t, device, torch.int32),
        completed=_tensor(jstate.completed, device, torch.int32))


def hindsight_to_numpy(state: HindsightReplayState) -> Dict[str, Any]:
    out = {"data": {k: v.cpu().numpy() for k, v in state.data.items()}}
    for name in ("ep_len", "cur_slot", "cur_t", "completed"):
        out[name] = getattr(state, name).cpu().numpy()
    return out


# --- the visual path: encoder, decoder, SAC-AE, CNNDisc ---------------------
def _encoder_leaves(enc: PixelEncoder) -> List[_Leaf]:
    out = []
    for i in range(enc.num_layers):
        conv = getattr(enc, f"conv{i}")
        out += [(conv.weight, ("params", f"conv{i}", "kernel"), "conv"),
                (conv.bias, ("params", f"conv{i}", "bias"), False)]
    return out + [(enc.fc.weight, ("params", "fc", "kernel"), True),
                  (enc.fc.bias, ("params", "fc", "bias"), False),
                  (enc.ln.weight, ("params", "ln", "scale"), False),
                  (enc.ln.bias, ("params", "ln", "bias"), False)]


def _decoder_leaves(dec: PixelDecoder) -> List[_Leaf]:
    out = [(dec.fc.weight, ("params", "fc", "kernel"), True),
           (dec.fc.bias, ("params", "fc", "bias"), False)]
    names = [f"deconv{i}" for i in range(dec.num_layers - 1)]
    for name in names + ["deconv_out"]:
        d = getattr(dec, name)
        out += [(d.weight, ("params", name, "kernel"), "deconv"),
                (d.bias, ("params", name, "bias"), False)]
    return out


def encoder_from_jax(enc: PixelEncoder, variables) -> None:
    """A flax PixelEncoder's variables ({"params"}) into `enc`, in place."""
    _load_leaves(_encoder_leaves(enc), variables)


def encoder_to_numpy(enc: PixelEncoder) -> Dict[str, Any]:
    return _dump_leaves(_encoder_leaves(enc))


def decoder_from_jax(dec: PixelDecoder, variables) -> None:
    """A flax PixelDecoder's variables into `dec`, in place (each
    ConvTranspose kernel transposed and flipped)."""
    _load_leaves(_decoder_leaves(dec), variables)


def decoder_to_numpy(dec: PixelDecoder) -> Dict[str, Any]:
    return _dump_leaves(_decoder_leaves(dec))


def _tuple_leaves(*parts: List[_Leaf]) -> List[_Leaf]:
    """The leaves of an optimizer over a tuple of trees, each path led by
    its tree's index."""
    return [(t, (i,) + path, tr) for i, leaves in enumerate(parts)
            for t, path, tr in leaves]


def _sac_ae_parts(state: SACAEState) -> Dict[str, List[_Leaf]]:
    """Each params field of the JAX SACAEState -> its leaves."""
    return {
        "encoder_params": _encoder_leaves(state.encoder),
        "decoder_params": _decoder_leaves(state.decoder),
        "policy_params": _module_leaves(state.policy),
        "qf1_params": _module_leaves(state.qf1),
        "qf2_params": _module_leaves(state.qf2),
        "target_encoder_params": _encoder_leaves(state.target_encoder),
        "target_qf1_params": _module_leaves(state.target_qf1),
        "target_qf2_params": _module_leaves(state.target_qf2),
    }


def _sac_ae_opts(state: SACAEState) -> Dict[str, Tuple[Adam, List[_Leaf]]]:
    p = _sac_ae_parts(state)
    return {
        "qf_opt": (state.qf_opt, _tuple_leaves(
            p["encoder_params"], p["qf1_params"], p["qf2_params"])),
        "policy_opt": (state.policy_opt, p["policy_params"]),
        "alpha_opt": (state.alpha_opt, [(state.log_alpha, (), False)]),
        "encdec_opt": (state.encdec_opt, _tuple_leaves(
            p["encoder_params"], p["decoder_params"])),
        "cpc_opt": (state.cpc_opt, _tuple_leaves(
            p["encoder_params"], [(state.cpc_W, (), False)])),
    }


def sac_ae_state_from_jax(algo: SACAE, jstate) -> SACAEState:
    """A SACAEState on `algo`'s device holding the JAX SACAEState's
    values: every params tree, W, log alpha, the five Adams' moments and
    counts, and the step."""
    state = algo.init(0)
    for field, leaves in _sac_ae_parts(state).items():
        _load_leaves(leaves, getattr(jstate, field))
    with torch.no_grad():
        state.cpc_W.copy_(_from_flax(jstate.cpc_W, state.cpc_W, False))
        state.log_alpha.copy_(_from_flax(jstate.log_alpha, state.log_alpha,
                                         False))
    for field, (opt, leaves) in _sac_ae_opts(state).items():
        _load_adam_tree(opt, leaves, getattr(jstate, field)[0])
    state.step = int(np.asarray(jstate.step))
    return state


def _dump_tuple(leaves: List[_Leaf], n: int):
    """`_dump_leaves` of tuple leaves, as the tuple of trees (a part whose
    only leaf has the empty path, as W, is that array)."""
    tree = _dump_leaves([(t, path, tr) for t, path, tr in leaves
                         if len(path) > 1])
    out = [tree.get(i) for i in range(n)]
    for t, path, tr in leaves:
        if len(path) == 1:
            out[path[0]] = _to_flax(t, tr)
    return tuple(out)


def sac_ae_state_to_numpy(state: SACAEState) -> Dict[str, Any]:
    """The port's SACAEState in the JAX layouts: flax variables per
    params field, W, log alpha, per optimizer {"count", "mu", "nu"} with
    moments shaped as the optimizer's params (a tuple of trees for
    qf_opt, encdec_opt and cpc_opt), and the step."""
    out: Dict[str, Any] = {field: _dump_leaves(leaves) for field, leaves
                           in _sac_ae_parts(state).items()}
    out["cpc_W"] = _to_flax(state.cpc_W, False)
    out["log_alpha"] = _to_flax(state.log_alpha, False)
    tuple_sizes = {"qf_opt": 3, "encdec_opt": 2, "cpc_opt": 2}
    for field, (opt, leaves) in _sac_ae_opts(state).items():
        n = tuple_sizes.get(field)
        if n:
            moments = {name: _dump_tuple(
                [(m, path, tr) for (_, path, tr), m in zip(
                    leaves, _moments_of(opt, leaves, getattr(opt, name)))],
                n) for name in ("mu", "nu")}
            out[field] = {"count": opt.count, **moments}
        elif field == "alpha_opt":
            out[field] = {"count": opt.count,
                          "mu": _to_flax(opt.mu[0], False),
                          "nu": _to_flax(opt.nu[0], False)}
        else:
            out[field] = _dump_adam_tree(opt, leaves)
    out["step"] = state.step
    return out


def _cnn_disc_leaves(disc: CNNDisc) -> List[_Leaf]:
    out = []
    for i in range(disc.num_layer_blocks):
        conv = getattr(disc, f"conv_{i}")
        out += [(conv.weight, (f"conv_{i}", "kernel"), "conv"),
                (conv.bias, (f"conv_{i}", "bias"), False)]
    for i in range(disc.num_layer_blocks):
        dense, ln = getattr(disc, f"dense_{i}"), getattr(disc, f"ln_{i}")
        out += [(dense.weight, (f"dense_{i}", "kernel"), True),
                (dense.bias, (f"dense_{i}", "bias"), False),
                (ln.weight, (f"ln_{i}", "scale"), False),
                (ln.bias, (f"ln_{i}", "bias"), False)]
    return out + [(disc.logit.weight, ("logit", "kernel"), True),
                  (disc.logit.bias, ("logit", "bias"), False)]


def cnn_disc_from_jax(disc: CNNDisc, variables) -> None:
    """A flax CNNDisc's variables ({"params"}) into `disc`, in place."""
    _load_leaves(_cnn_disc_leaves(disc), variables["params"])


def cnn_disc_to_numpy(disc: CNNDisc) -> Dict[str, Any]:
    return {"params": _dump_leaves(_cnn_disc_leaves(disc))}
