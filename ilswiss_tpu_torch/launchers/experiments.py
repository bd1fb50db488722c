"""Variant-dict -> training run (counterpart:
ilswiss_tpu/launchers/experiments.py; the off-policy trainers, AdvIRL,
PPO, MBPO and policy evaluation).

Rebuild of the reference's run_scripts/*_exp_script.py `experiment(variant)`
functions (e.g. sac_alpha_exp_script.py:23-101): consume the SAME yaml
variant schema (net_size / rl_alg_params / <algo>_params / env_specs), so
the exp_specs/ files run unchanged.

Schedule mapping: the reference interleaves
`num_steps_between_train_calls` env steps with
`num_train_steps_per_train_call` gradient steps on one env stream; with
B lockstep envs one loop iteration advances B env steps, so
grad_steps_per_iter = round(B * train_steps / steps_between).

Every `run_*` takes `device=None`, resolved by `utils.device.resolve_device`:
the GPU unless the caller names another device.  Only the on-device env
path exists; a spec that the JAX package would send to its host bridges
(a gymnasium id, or `env_specs.force_host`) raises NotImplementedError, as
does a trainer or env that is not ported yet, naming the item of
ROADMAP.md section 1 that ports it.  Nothing falls back.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict

from ilswiss_tpu_torch.envs import ENV_REGISTRY, make, make_vec
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.logging.logger import Logger
from ilswiss_tpu_torch.runtime.checkpoint import (
    SnapshotManager, restore_checkpoint, restore_subtree, resume_point,
)
from ilswiss_tpu_torch.runtime.evaluator import make_evaluator
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop,
)
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.guards import (
    PreemptionGuard, check_finite_metrics, enable_debug_nans,
)
from ilswiss_tpu_torch.utils.profiling import phase, trace

# the reference envs_dict.py names that the JAX package runs on its host
# bridges (copy of ilswiss_tpu/envs/host_mujoco.py:29-45)
GYM_ENV_IDS: Dict[str, str] = {
    "hopper": "Hopper-v5",
    "walker": "Walker2d-v5",
    "halfcheetah": "HalfCheetah-v5",
    "ant": "Ant-v5",
    "humanoid": "Humanoid-v5",
    "swimmer": "Swimmer-v5",
    "invertedpendulum": "InvertedPendulum-v5",
    "inverteddoublependulum": "InvertedDoublePendulum-v5",
    "lunarlandercont": "LunarLanderContinuous-v3",
    "bipedalwalker": "BipedalWalker-v3",
    "fetch-reach": "FetchReach-v4",
    "fetch-push": "FetchPush-v4",
    "fetch-pick-place": "FetchPickAndPlace-v4",
    "fetch-slide": "FetchSlide-v4",
}

# device envs of the JAX registry that the port has not ported yet, with
# the ROADMAP.md section 1 item that ports each
UNPORTED_DEVICE_ENVS: Dict[str, str] = {
    "reach2d": "2.5",
    "pendulum_pixels": "2.7",
}
HOST_ITEM = "2.8"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ilswiss_tpu_torch yet: ROADMAP.md "
        f"section 1 item {item}")


def _alg(variant: Dict, key: str) -> Dict:
    return dict(variant.get(key) or {})


def _is_host_env(env_name: str) -> bool:
    """Route env names: device registry first, then host gym ids.

    Unknown names raise instead of silently falling through to
    gymnasium (a typo'd device-env name must not become a host run)."""
    if env_name in ENV_REGISTRY:
        return False
    if env_name in UNPORTED_DEVICE_ENVS:
        raise _not_ported(f"device env {env_name!r}",
                          UNPORTED_DEVICE_ENVS[env_name])
    if env_name in GYM_ENV_IDS:
        return True
    if "-v" in env_name:
        try:
            import gymnasium
            known = env_name in gymnasium.registry
        except ImportError:
            known = False
        if known:
            return True
    raise ValueError(
        f"unknown env {env_name!r}: not a device env "
        f"(ilswiss_tpu_torch.envs.ENV_REGISTRY), not a native-engine env, "
        f"and not registered with gymnasium")


def _route_host(variant: Dict, env_name: str) -> None:
    """Raises where the JAX package would take its host path
    (`env_specs: {force_host: true}`, or a host env name): the host
    bridges are not ported.  Returns for the on-device path."""
    if bool(_alg(variant, "env_specs").get("force_host", False)):
        raise _not_ported("the host env path (env_specs.force_host)",
                          HOST_ITEM)
    if _is_host_env(env_name):
        raise _not_ported(f"the host env path (env {env_name!r})",
                          HOST_ITEM)


def _setup(variant: Dict, default_exp_name: str):
    seed = int(variant.get("seed", 0))
    env_specs = _alg(variant, "env_specs")
    env_name = env_specs.get("env_name", "pendulum")
    env_kwargs = dict(env_specs.get("env_kwargs") or {})
    rl = _alg(variant, "rl_alg_params")
    max_path_length = int(rl.get("max_path_length", 1000))
    env_kwargs.setdefault("max_episode_steps", max_path_length)
    num_envs = int(env_specs.get("env_num", 1))

    log_dir = variant.get("log_dir") or os.path.join(
        "logs", variant.get("exp_name", default_exp_name),
        f"seed_{seed}_id{variant.get('exp_id', 0)}",
    )
    logger = Logger(
        log_dir,
        use_tensorboard=bool(variant.get("use_tensorboard", False)),
        use_wandb=bool(variant.get("use_wandb", False)),
        print_to_console=bool(variant.get("print_to_console", True)),
    )
    logger.save_variant(variant)
    return seed, env_name, env_kwargs, num_envs, rl, logger


def _resolve_demo_path(variant: Dict) -> str:
    """`demo_path` directly, or `expert_name` looked up in the demos
    listing (`demos_listing`, default demos_listing.yaml; the reference's
    indirection, adv_irl_exp_script.py:31-34).  Relative paths are the
    working directory's, as in the JAX package."""
    if variant.get("demo_path"):
        return variant["demo_path"]
    name = variant.get("expert_name")
    if not name:
        raise KeyError("variant needs 'demo_path' or 'expert_name'")
    import yaml
    listing_path = variant.get("demos_listing", "demos_listing.yaml")
    with open(listing_path) as f:
        listing = yaml.safe_load(f)
    if name not in listing:
        raise KeyError(f"expert '{name}' not in {listing_path}; "
                       f"known: {sorted(listing)}")
    return listing[name]["file_path"]


def _grad_steps_per_iter(rl: Dict, num_envs: int) -> int:
    between = max(1, int(rl.get("num_steps_between_train_calls", 1000)))
    per_call = int(rl.get("num_train_steps_per_train_call", 1000))
    return max(1, round(num_envs * per_call / between))


def _num_eval_envs(rl: Dict) -> int:
    """The reference evaluates num_steps_per_eval // max_path_length
    rollouts per epoch (normal_sampler.py:96-115, typically 10); run at
    least `min_eval_episodes` (default 32) so the final-epoch mean +/- std
    is a low-variance statistic."""
    return max(
        int(rl.get("num_steps_per_eval", 10_000))
        // int(rl.get("max_path_length", 1000)),
        int(rl.get("min_eval_episodes", 32)),
    )


def _maybe_resume(variant: Dict | None, logger: Logger, runner):
    """variant['load_params'] = checkpoint path (or a previous run's
    log_dir) -> (runner, start epoch, resumed, meta), the runner restored
    in place (reference sac_exp_script.py:91-93 / logger.load_from_file).

    resumed is one of False, "full" and "light": a light snapshot ('last'
    of a light_snapshots run, or 'best', params and optimizers only)
    restores just the algo state, and the caller re-runs warmup to refill
    the ring.  A 'best' snapshot's own meta.json gives its epoch, so the
    run continues after the best epoch.  `meta` is `resume_point`'s, from
    which the caller seeds the best value."""
    if not variant or not variant.get("load_params"):
        return runner, 0, False, {}
    path = str(variant["load_params"])
    ckpt, meta, full = resume_point(path)
    start_epoch = int(meta.get("epoch", -1)) + 1
    if not full:
        restore_subtree(ckpt, runner.algo_state, key="algo_state")
        logger.log(f"light-resumed algo state from {path} at epoch "
                   f"{start_epoch} (replay ring refills via warmup)")
        return runner, start_epoch, "light", meta
    restore_checkpoint(ckpt, runner)
    logger.log(f"resumed from {path} at epoch {start_epoch}")
    return runner, start_epoch, "full", meta


def _run_off_policy(algo, vec: VectorEnv, rl: Dict, logger: Logger,
                    seed: int, variant: Dict | None = None):
    variant = variant or {}
    loop = OffPolicyLoop(
        vec, algo,
        OffPolicyConfig(
            batch_size=int(rl.get("batch_size", 256)),
            replay_capacity=int(rl.get("replay_buffer_size", 1_000_000)),
            min_steps_before_training=int(
                rl.get("min_steps_before_training", 1000)),
            grad_steps_per_iter=_grad_steps_per_iter(rl, vec.num_envs),
            no_terminal=bool(rl.get("no_terminal", False)),
        ),
    )
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    num_epochs = int(rl.get("num_epochs", 100))
    max_path_length = int(rl.get("max_path_length", 1000))
    n_eval = _num_eval_envs(rl)
    eval_vec = VectorEnv(vec.env, n_eval) if n_eval > vec.num_envs else vec
    evaluator = make_evaluator(
        eval_vec, lambda s, o: algo.act(s, o, deterministic=True),
        max_path_length)
    # 'last' is written every `freq_saving` epochs and once after the
    # final epoch; 'best' stores params only.  rl_alg_params.
    # light_snapshots: 'last' too stores params only (the ring refills
    # via warmup on resume), for runs whose full-ring save would dominate
    # wall-clock.
    light = bool(rl.get("light_snapshots", False))
    snap = SnapshotManager(
        logger.log_dir,
        mode=str(rl.get("snapshot_mode", "gap_last")),
        gap=int(rl.get("freq_saving", 10)),
        save_best=bool(rl.get("save_best", True)),
        best_state_fn=lambda r: {"algo_state": r.algo_state},
        last_state_fn=(
            (lambda r: {"algo_state": r.algo_state}) if light else None),
    )

    # the configuration the trainer runs with, as the spec was read
    logger.log(f"trainer {type(algo).__name__}: {algo.config}")
    runner = loop.init(seed)
    runner, start_epoch, resumed, meta = _maybe_resume(variant, logger,
                                                       runner)
    snap.best_value = float(meta.get("best_value", snap.best_value))
    if resumed != "full":
        runner = loop.warmup(runner)
        logger.log(f"warmup done: {runner.total_env_steps} env steps")
    # TotalEnvSteps after a light resume (the JAX device path's
    # convention, experiments.py:404-405): the runner's step count restarts
    # at the warmup's, so the LOGGED count adds the resumed epochs' steps,
    # start_epoch * num_steps_per_epoch, and includes the second warmup.
    steps_offset = (start_epoch * steps_per_epoch
                    if resumed == "light" else 0)

    if variant.get("debug_nans"):
        enable_debug_nans()
    guard = PreemptionGuard()
    profile_dir = variant.get("profile_dir")
    for epoch in range(start_epoch, num_epochs):
        t0 = time.time()
        with trace(profile_dir if epoch == start_epoch + 1 else None), \
                phase("train"):
            runner, metrics = loop.train_epoch(runner, steps_per_epoch)
        check_finite_metrics(
            metrics, epoch, logger.log,
            abort=bool(variant.get("abort_on_nan", False)))
        train_time = time.time() - t0

        t0 = time.time()
        with phase("eval"):
            # a generator of its own each epoch (the JAX PRNGKey(seed +
            # epoch + 1)): evaluation never draws from the runner's noise,
            # so a resumed run stays exact
            eval_stats = evaluator(runner.algo_state,
                                   Noise(seed + epoch + 1, vec.env.device))
        eval_time = time.time() - t0

        logger.record_dict(metrics, prefix="trainer/")
        logger.record_dict(eval_stats)
        logger.record_tabular("TotalEnvSteps",
                              steps_offset + runner.total_env_steps)
        logger.record_tabular("TrainTime", train_time)
        logger.record_tabular("EvalTime", eval_time)
        logger.record_tabular(
            "EnvStepsPerSec", steps_per_epoch / max(train_time, 1e-9))
        logger.dump_tabular(epoch)
        snap.on_epoch(epoch, runner, eval_stats)
        if guard.should_stop:
            # preemption notice: flush a resumable snapshot and exit at the
            # epoch boundary
            snap.save_last(runner, epoch=epoch)
            logger.log(f"preemption flush at epoch {epoch}; exiting")
            break
    else:
        if num_epochs > start_epoch:
            # exact end state (gap_last mode saves sparsely)
            snap.save_last(runner, epoch=num_epochs - 1)
    guard.restore()
    logger.close()
    return runner


# --------------------------------------------------------------------------
def _on_device_vec(variant: Dict, default_exp_name: str, device):
    """`_setup`, the host route's check, and the vectorized env."""
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, default_exp_name)
    _route_host(variant, env_name)
    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
    return seed, vec, rl, logger


def _nets(variant: Dict) -> Dict[str, int]:
    return dict(net_size=int(variant.get("net_size", 256)),
                num_hidden_layers=int(variant.get("num_hidden_layers", 2)))


def run_sac(variant: Dict[str, Any], device=None):
    """SAC auto-alpha (reference run_scripts/sac_alpha_exp_script.py)."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "sac", device)
    p = _alg(variant, "sac_params")
    algo = SAC(
        obs_size=vec.env.observation_size,
        action_size=vec.env.action_size,
        config=SACConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            soft_target_tau=float(p.get("soft_target_tau", 5e-3)),
            policy_lr=float(p.get("policy_lr", 3e-4)),
            qf_lr=float(p.get("qf_lr", 3e-4)),
            alpha_lr=float(p.get("alpha_lr", 3e-4)),
            policy_mean_reg_weight=float(
                p.get("policy_mean_reg_weight", 1e-3)),
            policy_std_reg_weight=float(
                p.get("policy_std_reg_weight", 1e-3)),
            target_entropy=p.get("target_entropy"),
        ),
        use_fused_chain=bool(p.get("use_fused_chain", False)),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_sac_v(variant: Dict[str, Any], device=None):
    """SAC with a value network and a fixed alpha (reference
    run_scripts/sac_exp_script.py); its parameters under `sac_params`."""
    from ilswiss_tpu_torch.algorithms.sac_v import SACV, SACVConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "sac_v", device)
    p = _alg(variant, "sac_params")
    algo = SACV(
        obs_size=vec.env.observation_size,
        action_size=vec.env.action_size,
        config=SACVConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            alpha=float(p.get("alpha", 1.0)),
            soft_target_tau=float(p.get("soft_target_tau", 5e-3)),
            policy_lr=float(p.get("policy_lr", 3e-4)),
            qf_lr=float(p.get("qf_lr", 3e-4)),
            vf_lr=float(p.get("vf_lr", 1e-3)),
        ),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_td3(variant: Dict[str, Any], device=None):
    """TD3 (reference run_scripts/td3_exp_script.py).  The target
    smoothing's sigma and clip are read as `target_policy_noise` /
    `target_policy_noise_clip`, as the JAX launcher reads them, or as
    `policy_noise` / `policy_noise_clip`, the names
    exp_specs/td3/td3_humanoid.yaml writes and the JAX launcher ignores;
    the `target_*` name wins where both are given."""
    from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "td3", device)
    p = _alg(variant, "td3_params")
    algo = TD3(
        obs_size=vec.env.observation_size,
        action_size=vec.env.action_size,
        config=TD3Config(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            soft_target_tau=float(p.get("soft_target_tau", 5e-3)),
            policy_lr=float(p.get("policy_lr", 1e-3)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
            target_policy_noise=float(p.get(
                "target_policy_noise", p.get("policy_noise", 0.2))),
            target_policy_noise_clip=float(p.get(
                "target_policy_noise_clip", p.get("policy_noise_clip", 0.5))),
            policy_and_target_update_period=int(
                p.get("policy_and_target_update_period", 2)),
            exploration_noise=float(p.get("exploration_noise", 0.1)),
        ),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_ddpg(variant: Dict[str, Any], device=None):
    """DDPG (reference run_scripts/ddpg_exp_script.py)."""
    from ilswiss_tpu_torch.algorithms.ddpg import DDPG, DDPGConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "ddpg", device)
    p = _alg(variant, "ddpg_params")
    algo = DDPG(
        obs_size=vec.env.observation_size,
        action_size=vec.env.action_size,
        config=DDPGConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            policy_lr=float(p.get("policy_lr", 1e-4)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
            soft_target_tau=float(p.get("soft_target_tau", 1e-2)),
        ),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_dqn(variant: Dict[str, Any], device=None):
    """DQN / Double DQN on a discrete env (cartpole).  Epsilon decays with
    the env steps of training (algorithms/dqn.py), where the JAX package
    counts gradient steps."""
    from ilswiss_tpu_torch.algorithms.dqn import DQN, DQNConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "dqn", device)
    p = _alg(variant, "dqn_params")
    algo = DQN(
        obs_size=vec.env.observation_size,
        num_actions=vec.env.action_size,
        config=DQNConfig(
            discount=float(p.get("discount", 0.99)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
            double_dqn=bool(p.get("double_dqn", True)),
            target_update_period=int(p.get("target_update_period", 500)),
        ),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_discrete_sac(variant: Dict[str, Any], device=None):
    """Discrete SAC (reference run_scripts/discrete_sac_exp_script.py).
    Its parameters are read from `discrete_sac_params`, the block
    exp_specs/sac/sac_cartpole_d.yaml writes, or from `sac_params` where
    only that is given; the JAX launcher reads `sac_params` alone and so
    trains that spec with its defaults (ROADMAP.md section 3)."""
    from ilswiss_tpu_torch.algorithms.discrete_sac import (
        DiscreteSAC, DiscreteSACConfig,
    )

    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "discrete_sac", device)
    p = _alg(variant, "discrete_sac_params" if variant.get(
        "discrete_sac_params") else "sac_params")
    algo = DiscreteSAC(
        obs_size=vec.env.observation_size,
        num_actions=vec.env.action_size,
        config=DiscreteSACConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            alpha=float(p.get("alpha", 1.0)),
            soft_target_tau=float(p.get("soft_target_tau", 1e-2)),
            policy_lr=float(p.get("policy_lr", 1e-3)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
        ),
        device=device, **_nets(variant))
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def _q_target_bounds(variant: Dict, mode: str, sp: Dict
                     ) -> tuple[float | None, float | None]:
    """Soft-Q target bounds from the reward mode (JAX
    experiments.py:1052-1069): the logits are clamped to +-clamp, so gail
    rewards lie in [0, clamp], gail2 in [-clamp, 0] and airl in [-clamp,
    clamp]; times reward_scale, plus or minus a margin of 10 for the
    entropy bonus, over 1 - discount.  fairl's e^x (-x) has no useful
    bound: None."""
    clamp = float(variant.get("disc_clamp_magnitude", 10.0))
    scale = float(sp.get("reward_scale", 2.0))
    gamma = float(sp.get("discount", 0.99))
    margin = 10.0
    bounds = {
        "gail": (0.0, scale * clamp),
        "gail2": (-scale * clamp, 0.0),
        "airl": (-scale * clamp, scale * clamp),
    }
    if mode not in bounds:
        return None, None
    rmin, rmax = bounds[mode]
    return (rmin - margin) / (1.0 - gamma), (rmax + margin) / (1.0 - gamma)


def run_adv_irl(variant: Dict[str, Any], device=None):
    """GAIL / AIRL / FAIRL (reference run_scripts/adv_irl_exp_script.py;
    the JAX `run_adv_irl`'s device branch, experiments.py:978-1148): demos
    from `demo_path` or `expert_name`, `traj_num` subsetting, demo-stats
    env scaling (`scale_env_with_demo_stats` / `minmax_env_with_demo_stats`,
    the env and the demos alike), DAC absorbing states (`wrap_absorbing`)
    and `no_terminal` storage; evaluation runs on the wrapped env, so its
    returns are the env's own rewards."""
    from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.data.demo import (
        demo_obs_stats, load_demos_npz, minmax_demos, scale_demos,
        subsample_trajs, wrap_absorbing_demos,
    )
    from ilswiss_tpu_torch.envs.wrappers import (
        AbsorbingEnv, MinmaxEnv, ScaledEnv,
    )

    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "adv_irl")
    p = _alg(variant, "adv_irl_params")
    # the reference nests the loop schedule inside adv_irl_params
    # (exp_specs/gail/*.yaml): accept either layout
    for k, v in p.items():
        if not isinstance(v, dict):
            rl.setdefault(k, v)
    _route_host(variant, env_name)
    wrap_absorbing = bool(p.get("wrap_absorbing", False))

    demos = load_demos_npz(_resolve_demo_path(variant), device=device)
    if variant.get("traj_num"):
        demos = subsample_trajs(demos, int(variant["traj_num"]))
    env = make(env_name, device=device, **env_kwargs)
    if bool(variant.get("scale_env_with_demo_stats", False)):
        stats = demo_obs_stats(demos)
        demos = scale_demos(demos, stats["obs_mean"], stats["obs_std"])
        env = ScaledEnv(env, obs_mean=stats["obs_mean"],
                        obs_std=stats["obs_std"])
    elif bool(variant.get("minmax_env_with_demo_stats", False)):
        stats = demo_obs_stats(demos)
        demos = minmax_demos(demos, stats["obs_min"], stats["obs_max"])
        env = MinmaxEnv(env, stats["obs_min"], stats["obs_max"])
    if wrap_absorbing:
        demos = wrap_absorbing_demos(demos)
        env = AbsorbingEnv(env)
    vec = VectorEnv(env, num_envs)
    obs_size, action_size = env.observation_size, env.action_size
    # one train call per loop iteration (num_envs env steps): the
    # update-loop count is rescaled to keep the reference's updates per
    # env step
    update_loops = max(1, round(
        num_envs * int(p.get("num_update_loops_per_train_call", 1))
        / max(1, int(rl.get("num_steps_between_train_calls", 1000)))))

    sp = _alg(variant, "sac_params")
    mode = str(p.get("mode", "gail"))
    q_lo, q_hi = _q_target_bounds(variant, mode, sp)
    sac = SAC(
        obs_size=obs_size,
        action_size=action_size,
        config=SACConfig(
            discount=float(sp.get("discount", 0.99)),
            reward_scale=float(sp.get("reward_scale", 2.0)),
            soft_target_tau=float(sp.get("soft_target_tau", 5e-3)),
            policy_lr=float(sp.get("policy_lr", 3e-4)),
            qf_lr=float(sp.get("qf_lr", 3e-4)),
            # the reference runs all of GAIL-SAC's Adams at the spec's
            # beta_1 (sac_alpha.py:60-76)
            beta_1=float(sp.get("beta_1", 0.9)),
            policy_mean_reg_weight=float(
                sp.get("policy_mean_reg_weight", 1e-3)),
            policy_std_reg_weight=float(
                sp.get("policy_std_reg_weight", 1e-3)),
            # the reference's SoftActorCritic starts at alpha 0.2
            # (sac_alpha.py:32)
            init_alpha=float(sp.get("alpha", 0.2)),
            # the JAX package's guard against the alpha ratchet of
            # nonstationary adversarial rewards
            max_alpha=float(sp.get("max_alpha", 2.0)),
            q_target_min=(float(sp["q_target_min"])
                          if "q_target_min" in sp else q_lo),
            q_target_max=(float(sp["q_target_max"])
                          if "q_target_max" in sp else q_hi),
        ),
        net_size=int(variant.get("policy_net_size", 256)),
        num_hidden_layers=int(variant.get("policy_num_hidden_layers", 2)),
        device=device,
    )
    algo = AdvIRL(
        obs_size, action_size, sac, demos,
        AdvIRLConfig(
            mode=mode,
            state_only=bool(p.get("state_only", False)),
            disc_optim_batch_size=int(p.get("disc_optim_batch_size", 1024)),
            policy_optim_batch_size=int(
                p.get("policy_optim_batch_size", 1024)),
            policy_optim_batch_size_from_expert=int(
                p.get("policy_optim_batch_size_from_expert", 0)),
            num_update_loops_per_train_call=update_loops,
            num_disc_updates_per_loop_iter=int(
                p.get("num_disc_updates_per_loop_iter", 1)),
            num_policy_updates_per_loop_iter=int(
                p.get("num_policy_updates_per_loop_iter", 1)),
            disc_lr=float(p.get("disc_lr", 3e-4)),
            disc_momentum=float(p.get("disc_momentum", 0.9)),
            use_grad_pen=bool(p.get("use_grad_pen", True)),
            grad_pen_weight=float(p.get("grad_pen_weight", 10.0)),
            rew_clip_min=p.get("rew_clip_min"),
            rew_clip_max=p.get("rew_clip_max"),
            reward_norm=bool(p.get("reward_norm", False)),
            disc_num_blocks=int(variant.get("disc_num_blocks", 2)),
            disc_hid_dim=int(variant.get("disc_hid_dim", 128)),
            disc_hid_act=str(variant.get("disc_hid_act", "tanh")),
            disc_use_bn=bool(variant.get("disc_use_bn", False)),
            disc_clamp_magnitude=float(
                variant.get("disc_clamp_magnitude", 10.0)),
            disc_type=str(variant.get("disc_type", "mlp")),
            disc_traj_len=int(variant.get("disc_traj_len", 16)),
            disc_rnn_cell=str(variant.get("disc_rnn_cell", "gru")),
            disc_rnn_layers=int(variant.get("disc_rnn_layers", 2)),
            disc_rnn_bidirectional=bool(
                variant.get("disc_rnn_bidirectional", True)),
        ),
    )
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_eval_policy(variant: Dict[str, Any], device=None):
    """Standalone policy evaluation from a checkpoint (reference
    run_scripts/evaluate_policy.py + exp_specs/eval_policy.yaml):
    rollouts of the policy of a params-only snapshot ('best'), return
    stats."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig

    if bool(variant.get("save_samples", False)):
        raise _not_ported("eval_policy's save_samples (data/demo.py and "
                          "runtime/collector.py)", "2.6")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "eval_policy")
    max_path_length = int(variant.get(
        "max_path_length", rl.get("max_path_length", 1000)))
    vec = make_vec(env_name, num_envs=max(num_envs, 8), device=device,
                   **env_kwargs)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=int(variant.get("policy_net_size", 256)),
              num_hidden_layers=int(variant.get(
                  "policy_num_hidden_layers", 2)),
              device=device)
    algo_state = restore_checkpoint(
        variant["policy_checkpoint"],
        {"algo_state": sac.init(0)})["algo_state"]
    noise = Noise(seed, device)
    if bool(variant.get("eval_deterministic", True)):
        act = lambda s, o: sac.act(s, o, deterministic=True)  # noqa: E731
    else:
        act = lambda s, o: sac.act(  # noqa: E731
            s, o, noise.act((o.shape[0], sac.action_size)))
    evaluator = make_evaluator(vec, act, max_path_length)
    stats = evaluator(algo_state, noise)
    logger.record_dict(stats)
    logger.dump_tabular(0)
    logger.close()
    return stats


def run_ppo(variant: Dict[str, Any], device=None):
    """PPO (reference run_scripts/ppo_exp_script.py; the JAX `run_ppo`'s
    device branch, experiments.py:646-725): `ppo_params` with the JAX
    defaults, `rollout_length`, and `env_specs.obs_norm` as the loop's
    `normalize_obs`.  The evaluator runs on the training envs, its act
    normalizing observations with the runner's moments; each epoch logs
    the trainer's metrics, the evaluation's keys, TotalEnvSteps, TrainTime
    and, as the off-policy launcher, EvalTime and EnvStepsPerSec, and hands
    the whole runner (moments included) to `SnapshotManager.on_epoch`.

    The JAX launcher never reads `load_params` for PPO, so a resume is
    silently dropped there; here a set `load_params` raises ValueError."""
    from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
    from ilswiss_tpu_torch.runtime.onpolicy import (
        OnPolicyConfig, OnPolicyLoop,
    )

    if variant.get("load_params"):
        raise ValueError(
            "load_params is set, but PPO has no resume: the JAX launcher "
            "never reads load_params for PPO, and the port adds none")
    device = resolve_device(device)
    seed, vec, rl, logger = _on_device_vec(variant, "ppo", device)
    p = _alg(variant, "ppo_params")
    algo = PPO(
        obs_size=vec.env.observation_size,
        action_size=vec.env.action_size,
        config=PPOConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            gae_tau=float(p.get("gae_tau", 0.9)),
            clip_eps=float(p.get("clip_eps", 0.2)),
            policy_lr=float(p.get("policy_lr", 3e-4)),
            value_lr=float(p.get("value_lr", 3e-4)),
            value_l2_reg=float(p.get("value_l2_reg", 1e-3)),
            use_value_clip=bool(p.get("use_value_clip", False)),
            update_epoch=int(p.get("update_epoch", 10)),
            mini_batch_size=int(p.get("mini_batch_size", 64)),
        ),
        device=device, **_nets(variant))
    loop = OnPolicyLoop(vec, algo, OnPolicyConfig(
        rollout_length=int(p.get("rollout_length", 128)),
        normalize_obs=bool(_alg(variant, "env_specs").get("obs_norm",
                                                          False))))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    num_epochs = int(rl.get("num_epochs", 100))
    max_path_length = int(rl.get("max_path_length", 1000))

    def eval_act(st, obs):
        algo_state, obs_rms = st
        return algo.act(algo_state, loop.normalize(obs_rms, obs),
                        deterministic=True)

    evaluator = make_evaluator(vec, eval_act, max_path_length)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)),
                           save_best=bool(rl.get("save_best", True)))
    logger.log(f"trainer {type(algo).__name__}: {algo.config}; "
               f"{loop.config}")
    runner = loop.init(seed)
    for epoch in range(num_epochs):
        t0, before = time.time(), runner.total_env_steps
        with phase("train"):
            runner, metrics = loop.train_epoch(runner, steps_per_epoch)
        train_time = time.time() - t0
        t0 = time.time()
        with phase("eval"):
            eval_stats = evaluator((runner.algo_state, runner.obs_rms),
                                   Noise(seed + epoch + 1, device))
        eval_time = time.time() - t0
        logger.record_dict(metrics, prefix="trainer/")
        logger.record_dict(eval_stats)
        logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
        logger.record_tabular("TrainTime", train_time)
        logger.record_tabular("EvalTime", eval_time)
        # an epoch is whole iterations of T * num_envs steps
        logger.record_tabular(
            "EnvStepsPerSec",
            (runner.total_env_steps - before) / max(train_time, 1e-9))
        logger.dump_tabular(epoch)
        snap.on_epoch(epoch, runner, eval_stats)
    logger.close()
    return runner


def run_mbpo(variant: Dict[str, Any], device=None):
    """MBPO (reference run_scripts/mbpo_exp_script.py; the JAX `run_mbpo`'s
    device branch, experiments.py:1722-1836): the loop keys under
    `rl_alg_params` or nested in `mbpo_params`, `bnn_params` with the JAX
    defaults, the terminal predicate of the env's name, evaluation on the
    training envs; each epoch logs the trainer's metrics, the evaluation's
    keys, TotalEnvSteps, TrainTime, EvalTime and EnvStepsPerSec, and hands
    the whole runner to `SnapshotManager.on_epoch` ('best' holds the
    inner SAC state, as the off-policy launcher's).

    Unlike the JAX launcher (ROADMAP.md section 3): SAC reads
    `soft_target_tau`, `policy_lr`, `qf_lr` and `target_entropy` from
    `sac_params` as well as `discount` and `reward_scale` (the JAX one
    drops the four, so mbpo_hopper.yaml's target entropy -1 becomes -1.5
    there), and a set `load_params` raises ValueError (the JAX device
    branch never reads it and starts afresh over the run's snapshots)."""
    from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainerConfig
    from ilswiss_tpu_torch.algorithms.mbpo import MBPO, MBPOConfig
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.envs.terminals import get_terminal_func

    if variant.get("load_params"):
        raise ValueError(
            "load_params is set, but MBPO has no resume: the JAX launcher "
            "never reads load_params for MBPO, and the port adds none")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "mbpo")
    mp = _alg(variant, "mbpo_params")
    # the reference nests the loop schedule inside mbpo_params
    # (exp_specs/mbpo/*.yaml): accept either layout
    for k, v in mp.items():
        if not isinstance(v, dict):
            rl.setdefault(k, v)
    _route_host(variant, env_name)
    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
    sp = _alg(variant, "sac_params")
    sac = SAC(
        vec.env.observation_size, vec.env.action_size,
        SACConfig(
            discount=float(sp.get("discount", 0.99)),
            reward_scale=float(sp.get("reward_scale", 1.0)),
            soft_target_tau=float(sp.get("soft_target_tau", 5e-3)),
            policy_lr=float(sp.get("policy_lr", 3e-4)),
            qf_lr=float(sp.get("qf_lr", 3e-4)),
            target_entropy=sp.get("target_entropy"),
        ),
        device=device, **_nets(variant))
    bp = _alg(variant, "bnn_params")
    max_path_length = int(rl.get("max_path_length", 1000))
    mbpo = MBPO(
        vec, sac, get_terminal_func(env_name),
        config=MBPOConfig(
            model_train_freq=int(mp.get("model_train_freq", 250)),
            rollout_batch_size=int(mp.get("rollout_batch_size", 100_000)),
            real_ratio=float(mp.get("real_ratio", 0.1)),
            rollout_schedule=tuple(
                mp.get("rollout_schedule", (20, 100, 1, 1))),
            batch_size=int(rl.get("batch_size", 256)),
            grad_steps_per_iter=_grad_steps_per_iter(rl, num_envs),
            replay_capacity=int(rl.get("replay_buffer_size", 1_000_000)),
            min_steps_before_training=int(
                rl.get("min_steps_before_training", 5000)),
            max_path_length=max_path_length,
        ),
        bnn_config=BNNTrainerConfig(
            num_nets=int(bp.get("num_nets", 7)),
            num_elites=int(bp.get("num_elites", 5)),
            hidden_sizes=tuple(bp.get("hidden_sizes", (200,) * 4)),
            batch_size=int(bp.get("batch_size", 256)),
            max_epochs=bp.get("max_epochs"),
            holdout_ratio=float(bp.get("holdout_ratio", 0.2)),
        ),
    )
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 1000))
    num_epochs = int(rl.get("num_epochs", 100))
    evaluator = make_evaluator(
        vec, lambda s, o: sac.act(s, o, deterministic=True), max_path_length)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)),
                           best_state_fn=lambda r: {
                               "algo_state": r.algo_state})
    logger.log(f"trainer {type(sac).__name__}: {sac.config}; "
               f"{mbpo.config}; {mbpo.bnn.config}")
    runner = mbpo.warmup(mbpo.init(seed))
    for epoch in range(num_epochs):
        t0, before = time.time(), runner.total_env_steps
        with phase("train"):
            runner, metrics = mbpo.train_epoch(runner, epoch, steps_per_epoch,
                                               log=logger.log)
        train_time = time.time() - t0
        t0 = time.time()
        with phase("eval"):
            eval_stats = evaluator(runner.algo_state,
                                   Noise(seed + epoch + 1, device))
        eval_time = time.time() - t0
        logger.record_dict(metrics, prefix="trainer/")
        logger.record_dict(eval_stats)
        logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
        logger.record_tabular("TrainTime", train_time)
        logger.record_tabular("EvalTime", eval_time)
        # an epoch is whole segments of whole iterations
        logger.record_tabular(
            "EnvStepsPerSec",
            (runner.total_env_steps - before) / max(train_time, 1e-9))
        logger.dump_tabular(epoch)
        snap.on_epoch(epoch, runner, eval_stats)
    logger.close()
    return runner


def _unported_run(name: str, item: str) -> Callable:
    def run(variant: Dict[str, Any], device=None):
        raise _not_ported(f"the {name!r} experiment", item)
    run.__name__ = f"run_{name}"
    return run


# every name of the JAX table (experiments.py:2188-2210); those not ported
# yet raise, naming the ROADMAP.md section 1 item that ports them
EXPERIMENTS: Dict[str, Callable] = {
    "sac": run_sac,
    "sac_v": run_sac_v,
    "td3": run_td3,
    "ddpg": run_ddpg,
    "dqn": run_dqn,
    "discrete_sac": run_discrete_sac,
    "eval_policy": run_eval_policy,
    "adv_irl": run_adv_irl,
    "gail": run_adv_irl,
    "ppo": run_ppo,
    "mbpo": run_mbpo,
    **{name: _unported_run(name, item) for name, item in (
        ("sac_vmap_seeds", "2.10"),
        ("bc", "2.6"),
        ("dagger", "2.6"),
        ("render_policy", "2.10"),
        ("sac_ae", "2.7"),
        ("sac_rad", "2.7"),
        ("sac_curl", "2.7"),
        ("her", "2.5"),
        ("gcsl", "2.5"),
        ("gen_expert", "2.6"),
    )},
}
