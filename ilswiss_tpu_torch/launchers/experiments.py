"""Variant-dict -> training run (counterpart:
ilswiss_tpu/launchers/experiments.py, every experiment of its
`EXPERIMENTS` table: the off-policy trainers, AdvIRL, PPO, MBPO, BC,
DAgger, expert demo generation, HER, GCSL, SAC-AE / RAD / CURL on device
pixel envs and on the DMC pixel envs, N SAC seeds in one process, policy
evaluation and rendering, and the host env paths).

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
the GPU unless the caller names another device.  Where the JAX launcher
routes a spec to its host bridges (`_route_host`: `env_specs.force_host`,
or an env name outside the device registry that gymnasium knows), so does
the port: `run_sac`, `run_td3`, `run_ddpg`, `run_ppo`, `run_adv_irl`,
`run_her`, `run_mbpo` and `run_gen_expert` step the env on the host
(envs/host_mujoco.py, envs/native_mujoco.py) and learn on `device`
(runtime/host_loop.py); `env_name: dmc` takes `run_sac_ae` and
`run_gen_expert` to the DMC pixel envs (envs/host_dmc.py).  The other
launchers build a device env as the JAX ones do, which raises KeyError
for a host env name.  Nothing falls back, but the native MuJoCo engine to
gymnasium where the machine cannot build it (`_make_host_env`).
"""

from __future__ import annotations

import importlib
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np

from ilswiss_tpu_torch.envs import ENV_REGISTRY, make, make_vec
from ilswiss_tpu_torch.envs.host_mujoco import GYM_ENV_IDS
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

def _alg(variant: Dict, key: str) -> Dict:
    return dict(variant.get(key) or {})


def _is_host_env(env_name: str) -> bool:
    """Route env names: device registry first, then host gym ids.

    Unknown names raise instead of silently falling through to
    gymnasium (a typo'd device-env name must not become a host run)."""
    if env_name in ENV_REGISTRY:
        return False
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


def _route_host(variant: Dict, env_name: str) -> bool:
    """Whether the run takes the host path: the device registry wins,
    unless the spec pins the host path with `env_specs: {force_host:
    true}` (exp_specs/sac/sac_hopper_native.yaml)."""
    if bool(_alg(variant, "env_specs").get("force_host", False)):
        return True
    return _is_host_env(env_name)


def _make_host_env(variant: Dict, env_name: str, env_kwargs: Dict,
                   num_envs: int, seed: int, logger: Logger,
                   demo_stats: Dict | None = None,
                   wrap_absorbing: bool = False):
    """A host vector env: the native engine where it runs the env (and
    `use_native_engine`, default true, allows it), else gymnasium threads;
    with demo-stats observation scaling (reference ScaledEnv / MinmaxEnv,
    adv_irl_exp_script.py:86-115) and DAC absorbing states.

    The native engine gives way to gymnasium, with the JAX launcher's log
    line, only where the machine cannot build or load it (ImportError: no
    mujoco or gymnasium; OSError: no g++, or a library that does not
    load).  Anything else raises: the JAX launcher catches every
    Exception here, so a compile error in mjvec.cpp silently changes the
    engine of a run (ROADMAP.md section 3)."""
    from ilswiss_tpu_torch.envs.host_mujoco import (
        AbsorbingHostEnv, GymVectorEnv, MinmaxHostEnv, ScaledHostEnv,
    )
    from ilswiss_tpu_torch.envs.native_mujoco import (
        _ENV_TYPES, NativeMjVectorEnv,
    )

    env_kwargs = dict(env_kwargs)
    max_path_length = env_kwargs.pop("max_episode_steps", None)
    env = None
    if bool(variant.get("use_native_engine", True)) and \
            env_name in _ENV_TYPES:
        try:
            env = NativeMjVectorEnv(env_name, num_envs=num_envs, seed=seed,
                                    max_episode_steps=max_path_length)
            logger.log(f"using native mjvec engine for {env_name}")
        except (ImportError, OSError) as e:
            logger.log(f"native engine unavailable ({e}); using gym")
    if env is None:
        env = GymVectorEnv(env_name, num_envs=num_envs, seed=seed,
                           max_episode_steps=max_path_length,
                           env_kwargs=env_kwargs)
    if demo_stats is not None:
        if demo_stats.get("minmax"):
            env = MinmaxHostEnv(env, demo_stats["obs_min"],
                                demo_stats["obs_max"])
        else:
            env = ScaledHostEnv(env, demo_stats["obs_mean"],
                                demo_stats["obs_std"])
    if wrap_absorbing:
        env = AbsorbingHostEnv(env)
    return env


def _host_env_sizes(env_name: str, env_kwargs: Dict) -> tuple[int, int]:
    """(observation size, action size) of a host env, from a one-env
    gymnasium probe."""
    from ilswiss_tpu_torch.envs.host_mujoco import GymVectorEnv

    kw = dict(env_kwargs)
    kw.pop("max_episode_steps", None)
    probe = GymVectorEnv(env_name, num_envs=1, env_kwargs=kw)
    sizes = (probe.observation_size, probe.action_size)
    probe.close()
    return sizes


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


def _refuse_resume(variant: Dict, name: str) -> None:
    """The JAX launchers of PPO, MBPO, BC, DAgger, gen_expert, HER and
    GCSL never read `load_params`, so a resume is silently dropped there
    and the run overwrites its snapshots; the port raises ValueError."""
    if variant.get("load_params"):
        raise ValueError(
            f"load_params is set, but {name} has no resume: the JAX "
            f"launcher never reads load_params for {name}, and the port "
            f"adds none")


def _load_demos(variant: Dict, device):
    """The demo buffer of `demo_path` / `expert_name`, cut to its first
    `traj_num` episodes where that is set."""
    from ilswiss_tpu_torch.data.demo import load_demos_npz, subsample_trajs

    demos = load_demos_npz(_resolve_demo_path(variant), device=device)
    if variant.get("traj_num"):
        demos = subsample_trajs(demos, int(variant["traj_num"]))
    return demos


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


def _num_host_eval_episodes(rl: Dict, default_steps: int = 10_000) -> int:
    """The host paths evaluate num_steps_per_eval // max_path_length
    episodes (at least 1), as the JAX host paths do."""
    return max(1, int(rl.get("num_steps_per_eval", default_steps))
               // int(rl.get("max_path_length", 1000)))


def _run_host_off_policy(algo, variant: Dict, rl: Dict, logger: Logger,
                         seed: int, env_name: str, env_kwargs: Dict,
                         num_envs: int, demo_stats: Dict | None = None,
                         wrap_absorbing: bool = False):
    """The host path of the off-policy launchers (JAX experiments.py:
    118-183): a host env, `HostOffPolicyLoop` with the learner on
    `algo.device`, the host evaluation, and per epoch the trainer's
    metrics, the evaluation's keys, the phase times (Time/...),
    TotalEnvSteps, TrainTime and EnvStepsPerSec; snapshots every epoch
    ('last', the whole runner, and 'best', as the JAX host path).

    Resume (`load_params`): a full snapshot holds the runner's env-step
    count, so TotalEnvSteps continues from it; after a light resume (a
    params-only snapshot) the count restarts at the warmup's and the
    logged TotalEnvSteps adds start_epoch * num_steps_per_epoch, the
    device path's convention (the JAX host path instead logs max(count,
    start_epoch * num_steps_per_epoch): ROADMAP.md section 3)."""
    from ilswiss_tpu_torch.runtime.host_loop import (
        HostLoopConfig, HostOffPolicyLoop,
    )
    from ilswiss_tpu_torch.utils.profiling import TIMER

    env = _make_host_env(variant, env_name, env_kwargs, num_envs, seed,
                         logger, demo_stats=demo_stats,
                         wrap_absorbing=wrap_absorbing)
    loop = HostOffPolicyLoop(env, algo, HostLoopConfig(
        batch_size=int(rl.get("batch_size", 256)),
        replay_capacity=int(rl.get("replay_buffer_size", 1_000_000)),
        steps_between_train_calls=int(
            rl.get("num_steps_between_train_calls", 1000)),
        train_steps_per_call=int(
            rl.get("num_train_steps_per_train_call", 1000)),
        min_steps_before_training=int(
            rl.get("min_steps_before_training", 1000)),
        no_terminal=bool(rl.get("no_terminal", False)),
    ))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    num_epochs = int(rl.get("num_epochs", 100))
    num_eval_episodes = _num_host_eval_episodes(rl)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)),
                           save_best=bool(rl.get("save_best", True)))
    logger.log(f"trainer {type(algo).__name__} on host env {env_name} "
               f"({type(env).__name__}): {algo.config}; {loop.config}")
    runner = loop.init(seed)
    runner, start_epoch, resumed, meta = _maybe_resume(variant, logger,
                                                       runner)
    snap.best_value = float(meta.get("best_value", snap.best_value))
    if resumed != "full":
        runner = loop.warmup(runner)
        logger.log(f"warmup done: {runner.total_env_steps} env steps")
    steps_offset = (start_epoch * steps_per_epoch
                    if resumed == "light" else 0)
    TIMER.reset()
    profile_dir = variant.get("profile_dir")
    try:
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with trace(profile_dir if epoch == start_epoch + 1 else None):
                runner, metrics = loop.train_epoch(runner, steps_per_epoch)
            train_time = time.time() - t0
            with phase("eval"):
                eval_stats = loop.evaluate(runner, num_eval_episodes,
                                           seed=seed + epoch + 1)
            logger.record_dict(metrics, prefix="trainer/")
            logger.record_dict(eval_stats)
            logger.record_dict(TIMER.stamp())
            logger.record_tabular("TotalEnvSteps",
                                  steps_offset + runner.total_env_steps)
            logger.record_tabular("TrainTime", train_time)
            logger.record_tabular("EnvStepsPerSec",
                                  steps_per_epoch / max(train_time, 1e-9))
            logger.dump_tabular(epoch)
            snap.on_epoch(epoch, runner, eval_stats)
    finally:
        env.close()
    logger.close()
    return runner


def _run_host_on_policy(algo, variant: Dict, p: Dict, rl: Dict,
                        logger: Logger, seed: int, env_name: str,
                        env_kwargs: Dict, num_envs: int):
    """PPO's host path (JAX experiments.py:186-227): host rollouts,
    `HostOnPolicyLoop` with the learner on `algo.device`; per epoch the
    trainer's metrics, the evaluation's keys, TotalEnvSteps, TrainTime and
    EnvStepsPerSec, and a snapshot of the runner (moments included)."""
    from ilswiss_tpu_torch.runtime.host_loop import HostOnPolicyLoop

    env = _make_host_env(variant, env_name, env_kwargs, num_envs, seed,
                         logger)
    loop = HostOnPolicyLoop(
        env, algo, rollout_length=int(p.get("rollout_length", 128)),
        normalize_obs=bool(_alg(variant, "env_specs").get("obs_norm",
                                                          False)))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    num_eval_episodes = _num_host_eval_episodes(rl)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)),
                           save_best=bool(rl.get("save_best", True)))
    logger.log(f"trainer {type(algo).__name__} on host env {env_name} "
               f"({type(env).__name__}): {algo.config}")
    runner = loop.init(seed)
    try:
        for epoch in range(int(rl.get("num_epochs", 100))):
            t0 = time.time()
            runner, metrics = loop.train_epoch(runner, steps_per_epoch)
            train_time = time.time() - t0
            eval_stats = loop.evaluate(runner, num_eval_episodes,
                                       seed=seed + epoch + 1)
            logger.record_dict(metrics, prefix="trainer/")
            logger.record_dict(eval_stats)
            logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
            logger.record_tabular("TrainTime", train_time)
            logger.record_tabular("EnvStepsPerSec",
                                  steps_per_epoch / max(train_time, 1e-9))
            logger.dump_tabular(epoch)
            snap.on_epoch(epoch, runner, eval_stats)
    finally:
        env.close()
    logger.close()
    return runner


# --------------------------------------------------------------------------
def _device_vec(variant: Dict, default_exp_name: str, device):
    """`_setup` and the vectorized device env, for the launchers that the
    JAX package never routes to a host env."""
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, default_exp_name)
    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
    return seed, vec, rl, logger


@dataclass
class _RoutedEnv:
    """A routed launcher's env: the device vec env, or None on the host
    path, and the env's sizes either way."""
    vec: VectorEnv | None
    obs_size: int
    action_size: int


def _routed_env(variant: Dict, env_name: str, env_kwargs: Dict,
                num_envs: int, device) -> _RoutedEnv:
    if _route_host(variant, env_name):
        return _RoutedEnv(None, *_host_env_sizes(env_name, env_kwargs))
    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
    return _RoutedEnv(vec, vec.env.observation_size, vec.env.action_size)


def _nets(variant: Dict) -> Dict[str, int]:
    return dict(net_size=int(variant.get("net_size", 256)),
                num_hidden_layers=int(variant.get("num_hidden_layers", 2)))


def run_sac(variant: Dict[str, Any], device=None):
    """SAC auto-alpha (reference run_scripts/sac_alpha_exp_script.py)."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig

    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant,
                                                              "sac")
    env = _routed_env(variant, env_name, env_kwargs, num_envs, device)
    p = _alg(variant, "sac_params")
    algo = SAC(
        obs_size=env.obs_size,
        action_size=env.action_size,
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
    if env.vec is None:
        return _run_host_off_policy(algo, variant, rl, logger, seed,
                                    env_name, env_kwargs, num_envs)
    return _run_off_policy(algo, env.vec, rl, logger, seed, variant=variant)


def run_sac_v(variant: Dict[str, Any], device=None):
    """SAC with a value network and a fixed alpha (reference
    run_scripts/sac_exp_script.py); its parameters under `sac_params`."""
    from ilswiss_tpu_torch.algorithms.sac_v import SACV, SACVConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _device_vec(variant, "sac_v", device)
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
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant,
                                                              "td3")
    env = _routed_env(variant, env_name, env_kwargs, num_envs, device)
    p = _alg(variant, "td3_params")
    algo = TD3(
        obs_size=env.obs_size,
        action_size=env.action_size,
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
    if env.vec is None:
        return _run_host_off_policy(algo, variant, rl, logger, seed,
                                    env_name, env_kwargs, num_envs)
    return _run_off_policy(algo, env.vec, rl, logger, seed, variant=variant)


def run_ddpg(variant: Dict[str, Any], device=None):
    """DDPG (reference run_scripts/ddpg_exp_script.py)."""
    from ilswiss_tpu_torch.algorithms.ddpg import DDPG, DDPGConfig

    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant,
                                                              "ddpg")
    env = _routed_env(variant, env_name, env_kwargs, num_envs, device)
    p = _alg(variant, "ddpg_params")
    algo = DDPG(
        obs_size=env.obs_size,
        action_size=env.action_size,
        config=DDPGConfig(
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            policy_lr=float(p.get("policy_lr", 1e-4)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
            soft_target_tau=float(p.get("soft_target_tau", 1e-2)),
        ),
        device=device, **_nets(variant))
    if env.vec is None:
        return _run_host_off_policy(algo, variant, rl, logger, seed,
                                    env_name, env_kwargs, num_envs)
    return _run_off_policy(algo, env.vec, rl, logger, seed, variant=variant)


def run_dqn(variant: Dict[str, Any], device=None):
    """DQN / Double DQN on a discrete env (cartpole).  Epsilon decays with
    the env steps of training (algorithms/dqn.py), where the JAX package
    counts gradient steps."""
    from ilswiss_tpu_torch.algorithms.dqn import DQN, DQNConfig

    device = resolve_device(device)
    seed, vec, rl, logger = _device_vec(variant, "dqn", device)
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
    seed, vec, rl, logger = _device_vec(variant, "discrete_sac", device)
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
    the JAX `run_adv_irl`, experiments.py:978-1148): demos from
    `demo_path` or `expert_name`, `traj_num` subsetting, demo-stats env
    scaling (`scale_env_with_demo_stats` / `minmax_env_with_demo_stats`,
    the env and the demos alike), DAC absorbing states (`wrap_absorbing`)
    and `no_terminal` storage; evaluation runs on the wrapped env, so its
    returns are the env's own rewards.  On the host path the env is the
    host env in the host wrappers (envs/host_mujoco.py), and
    `num_update_loops_per_train_call` is the spec's: one `train_call` a
    segment, the reference's cadence; on the device path it is rescaled
    to one call a loop iteration."""
    from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.data.demo import (
        demo_obs_stats, minmax_demos, scale_demos, wrap_absorbing_demos,
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
    host = _route_host(variant, env_name)
    wrap_absorbing = bool(p.get("wrap_absorbing", False))

    demos = _load_demos(variant, device)
    demo_stats = None
    if bool(variant.get("scale_env_with_demo_stats", False)):
        demo_stats = demo_obs_stats(demos)
        demos = scale_demos(demos, demo_stats["obs_mean"],
                            demo_stats["obs_std"])
    elif bool(variant.get("minmax_env_with_demo_stats", False)):
        demo_stats = dict(demo_obs_stats(demos), minmax=True)
        demos = minmax_demos(demos, demo_stats["obs_min"],
                             demo_stats["obs_max"])
    if wrap_absorbing:
        demos = wrap_absorbing_demos(demos)
    if host:
        obs_size, action_size = _host_env_sizes(env_name, env_kwargs)
        obs_size += int(wrap_absorbing)
        # one train call per steps_between_train_calls-step segment: the
        # reference's cadence as it stands
        update_loops = int(p.get("num_update_loops_per_train_call", 1))
    else:
        env = make(env_name, device=device, **env_kwargs)
        if demo_stats is not None and demo_stats.get("minmax"):
            env = MinmaxEnv(env, demo_stats["obs_min"],
                            demo_stats["obs_max"])
        elif demo_stats is not None:
            env = ScaledEnv(env, obs_mean=demo_stats["obs_mean"],
                            obs_std=demo_stats["obs_std"])
        if wrap_absorbing:
            env = AbsorbingEnv(env)
        vec = VectorEnv(env, num_envs)
        obs_size, action_size = env.observation_size, env.action_size
        # one train call per loop iteration (num_envs env steps): the
        # update-loop count is rescaled to keep the reference's updates
        # per env step
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
    if host:
        return _run_host_off_policy(
            algo, variant, rl, logger, seed, env_name, env_kwargs, num_envs,
            demo_stats=demo_stats, wrap_absorbing=wrap_absorbing)
    return _run_off_policy(algo, vec, rl, logger, seed, variant=variant)


def run_eval_policy(variant: Dict[str, Any], device=None):
    """Standalone policy evaluation from a checkpoint (reference
    run_scripts/evaluate_policy.py + exp_specs/eval_policy.yaml):
    rollouts of the policy of a params-only ('best') or a full snapshot,
    return stats; with `save_samples`, num_eval_steps // num_envs steps
    of every env saved as demos to <log_dir>/eval_samples.npz."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig

    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "eval_policy")
    max_path_length = int(variant.get(
        "max_path_length", rl.get("max_path_length", 1000)))
    num_eval_steps = int(variant.get(
        "num_eval_steps", rl.get("num_steps_per_eval", 2000)))
    vec = make_vec(env_name, num_envs=max(num_envs, 8), device=device,
                   **env_kwargs)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=int(variant.get("policy_net_size", 256)),
              num_hidden_layers=int(variant.get(
                  "policy_num_hidden_layers", 2)),
              device=device)
    # the algo state of a params-only snapshot ('best') or of a full one
    algo_state = restore_subtree(variant["policy_checkpoint"], sac.init(0))
    deterministic = bool(variant.get("eval_deterministic", True))
    noise = Noise(seed, device)

    def act(obs, noise):
        if deterministic:
            return sac.act(algo_state, obs, deterministic=True)
        return sac.act(algo_state, obs, *sac.act_noise(noise, obs.shape[0]))

    evaluator = make_evaluator(vec, lambda s, o: act(o, noise),
                               max_path_length)
    stats = evaluator(algo_state, noise)
    logger.record_dict(stats)
    logger.dump_tabular(0)

    if bool(variant.get("save_samples", False)):
        # the policy's transitions as a demo file (JAX
        # experiments.py:902-917), from a generator of their own
        from ilswiss_tpu_torch.data.demo import save_demos_npz
        from ilswiss_tpu_torch.runtime.collector import collect_transitions

        demos = collect_transitions(
            vec, act, max(1, num_eval_steps // vec.num_envs),
            Noise(seed + 1, device))
        out = os.path.join(logger.log_dir, "eval_samples.npz")
        save_demos_npz(out, demos)
        logger.log(f"saved {demos.size} transitions to {out}")
    logger.close()
    return stats


def run_ppo(variant: Dict[str, Any], device=None):
    """PPO (reference run_scripts/ppo_exp_script.py; the JAX `run_ppo`,
    experiments.py:646-725): `ppo_params` with the JAX defaults,
    `rollout_length`, and `env_specs.obs_norm` as the loop's
    `normalize_obs`.  The evaluator runs on the training envs, its act
    normalizing observations with the runner's moments; each epoch logs
    the trainer's metrics, the evaluation's keys, TotalEnvSteps, TrainTime
    and, as the off-policy launcher, EvalTime and EnvStepsPerSec, and hands
    the whole runner (moments included) to `SnapshotManager.on_epoch`.  A
    host env goes through `_run_host_on_policy`.

    The JAX launcher never reads `load_params` for PPO, on either path
    (its `_run_host_on_policy` never calls `_maybe_resume`), so a resume
    is silently dropped there; here a set `load_params` raises ValueError
    before any work."""
    from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
    from ilswiss_tpu_torch.runtime.onpolicy import (
        OnPolicyConfig, OnPolicyLoop,
    )

    _refuse_resume(variant, "PPO")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant, "ppo")
    env = _routed_env(variant, env_name, env_kwargs, num_envs, device)
    p = _alg(variant, "ppo_params")
    algo = PPO(
        obs_size=env.obs_size,
        action_size=env.action_size,
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
    if env.vec is None:
        return _run_host_on_policy(algo, variant, p, rl, logger, seed,
                                   env_name, env_kwargs, num_envs)
    vec = env.vec
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


def _run_host_mbpo(mbpo, variant: Dict, rl: Dict, logger: Logger,
                   seed: int, env_name: str, env_kwargs: Dict,
                   num_envs: int):
    """MBPO's host path (JAX experiments.py:1772-1800): `HostMBPOLoop`
    with num_train_steps_per_train_call / num_steps_between_train_calls
    SAC steps an env step; per epoch the trainer's metrics, the host
    evaluation's keys, TotalEnvSteps and TrainTime, and a snapshot."""
    from ilswiss_tpu_torch.algorithms.mbpo import HostMBPOLoop

    env = _make_host_env(variant, env_name, env_kwargs, num_envs, seed,
                         logger)
    loop = HostMBPOLoop(
        env, mbpo,
        grad_steps_per_env_step=(
            int(rl.get("num_train_steps_per_train_call", 20))
            / max(1, int(rl.get("num_steps_between_train_calls", 1)))),
        no_terminal=bool(rl.get("no_terminal", False)))
    num_eval_episodes = _num_host_eval_episodes(rl, 5000)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 1000))
    runner = loop.warmup(loop.init(seed))
    try:
        for epoch in range(int(rl.get("num_epochs", 100))):
            t0 = time.time()
            runner, metrics = loop.train_epoch(runner, epoch, steps_per_epoch,
                                               log=logger.log)
            train_time = time.time() - t0
            eval_stats = loop.evaluate(runner, num_eval_episodes,
                                       seed=seed + epoch + 1)
            logger.record_dict(metrics, prefix="trainer/")
            logger.record_dict(eval_stats)
            logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
            logger.record_tabular("TrainTime", train_time)
            logger.dump_tabular(epoch)
            snap.on_epoch(epoch, runner, eval_stats)
    finally:
        env.close()
    logger.close()
    return runner


def run_mbpo(variant: Dict[str, Any], device=None):
    """MBPO (reference run_scripts/mbpo_exp_script.py; the JAX `run_mbpo`,
    experiments.py:1722-1836): the loop keys under
    `rl_alg_params` or nested in `mbpo_params`, `bnn_params` with the JAX
    defaults, the terminal predicate of the env's name, evaluation on the
    training envs; each epoch logs the trainer's metrics, the evaluation's
    keys, TotalEnvSteps, TrainTime, EvalTime and EnvStepsPerSec, and hands
    the whole runner to `SnapshotManager.on_epoch` ('best' holds the
    inner SAC state, as the off-policy launcher's).  A host env goes
    through `_run_host_mbpo`.

    Unlike the JAX launcher (ROADMAP.md section 3): SAC reads
    `soft_target_tau`, `policy_lr`, `qf_lr` and `target_entropy` from
    `sac_params` as well as `discount` and `reward_scale` (the JAX one
    drops the four, so mbpo_hopper.yaml's target entropy -1 becomes -1.5
    there), and a set `load_params` raises ValueError (the JAX launcher
    never reads it and starts afresh over the run's snapshots)."""
    from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainerConfig
    from ilswiss_tpu_torch.algorithms.mbpo import MBPO, MBPOConfig
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.envs.terminals import get_terminal_func

    _refuse_resume(variant, "MBPO")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "mbpo")
    mp = _alg(variant, "mbpo_params")
    # the reference nests the loop schedule inside mbpo_params
    # (exp_specs/mbpo/*.yaml): accept either layout
    for k, v in mp.items():
        if not isinstance(v, dict):
            rl.setdefault(k, v)
    env = _routed_env(variant, env_name, env_kwargs, num_envs, device)
    sp = _alg(variant, "sac_params")
    sac = SAC(
        env.obs_size, env.action_size,
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
        env.vec, sac, get_terminal_func(env_name),
        obs_size=env.obs_size, action_size=env.action_size,
        num_envs=num_envs,
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
    logger.log(f"trainer {type(sac).__name__}: {sac.config}; "
               f"{mbpo.config}; {mbpo.bnn.config}")
    if env.vec is None:
        return _run_host_mbpo(mbpo, variant, rl, logger, seed, env_name,
                              env_kwargs, num_envs)
    vec = env.vec
    evaluator = make_evaluator(
        vec, lambda s, o: sac.act(s, o, deterministic=True), max_path_length)
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)),
                           best_state_fn=lambda r: {
                               "algo_state": r.algo_state})
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


# --------------------------------------------------------------------------
def _run_epochs(train_epoch: Callable, evaluator, runner, rl: Dict,
                logger: Logger, seed: int, device):
    """The epoch loop of the BC, DAgger, HER and GCSL launchers:
    `train_epoch(runner) -> (runner, metrics)`, then the evaluation from
    a generator of its own (the JAX PRNGKey(seed + epoch + 1)); each epoch
    logs the trainer's metrics, the evaluation's keys, TotalEnvSteps
    (where the runner counts env steps), TrainTime and EvalTime, and hands
    the runner to a `SnapshotManager` (gap `freq_saving`, 'last' the
    whole runner, 'best' its algo state, as the JAX launchers save)."""
    snap = SnapshotManager(
        logger.log_dir, gap=int(rl.get("freq_saving", 10)),
        best_state_fn=lambda r: {"algo_state": r.algo_state})
    for epoch in range(int(rl.get("num_epochs", 100))):
        t0 = time.time()
        with phase("train"):
            runner, metrics = train_epoch(runner)
        train_time = time.time() - t0
        t0 = time.time()
        with phase("eval"):
            eval_stats = evaluator(runner.algo_state,
                                   Noise(seed + epoch + 1, device))
        eval_time = time.time() - t0
        logger.record_dict(metrics, prefix="trainer/")
        logger.record_dict(eval_stats)
        if hasattr(runner, "total_env_steps"):
            logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
        logger.record_tabular("TrainTime", train_time)
        logger.record_tabular("EvalTime", eval_time)
        logger.dump_tabular(epoch)
        snap.on_epoch(epoch, runner, eval_stats)
    logger.close()
    return runner


def run_bc(variant: Dict[str, Any], device=None):
    """Behaviour cloning from demos (reference run_scripts/
    bc_exp_script.py; the JAX `run_bc`, experiments.py:728-775): an epoch
    is `num_train_steps_per_train_call` steps on the expert ring, the
    evaluation runs max(env_num, 8) envs for `max_path_length` steps.  A
    set `load_params` raises ValueError (the JAX launcher never reads
    it)."""
    from ilswiss_tpu_torch.algorithms.bc import BC, BCConfig
    from ilswiss_tpu_torch.runtime.offline import OfflineLoop

    _refuse_resume(variant, "BC")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant, "bc")
    vec = make_vec(env_name, num_envs=max(num_envs, 8), device=device,
                   **env_kwargs)
    p = _alg(variant, "bc_params")
    algo = BC(vec.env.observation_size, vec.env.action_size,
              BCConfig(mode=str(p.get("mode", "MLE")),
                       lr=float(p.get("lr", 1e-3))),
              device=device, **_nets(variant))
    loop = OfflineLoop(algo, _load_demos(variant, device),
                       batch_size=int(rl.get("batch_size", 256)))
    steps_per_epoch = int(rl.get("num_train_steps_per_train_call", 1000))
    evaluator = make_evaluator(
        vec, lambda s, o: algo.act(s, o, deterministic=True),
        int(rl.get("max_path_length", 1000)))
    logger.log(f"trainer {type(algo).__name__}: {algo.config}")
    return _run_epochs(lambda r: loop.train_epoch(r, steps_per_epoch),
                       evaluator, loop.init(seed), rl, logger, seed, device)


def _resolve_expert_fn(variant: Dict, vec: VectorEnv, device) -> Callable:
    """The expert DAgger queries, obs -> action: `scripted_expert`
    ("module:function"; a module under ilswiss_tpu. is read as the same
    path under ilswiss_tpu_torch., so the JAX specs' names resolve to the
    port's envs/experts.py, and any other module is imported as given), or
    the deterministic policy of a trained SAC snapshot at
    `expert_policy_path` (a 'best' or a full 'last'), with
    `expert_net_size` / `expert_num_hidden_layers` (default: the net
    sizes)."""
    scripted = variant.get("scripted_expert")
    if scripted:
        mod_name, fn_name = str(scripted).split(":")
        if mod_name == "ilswiss_tpu" or mod_name.startswith("ilswiss_tpu."):
            mod_name = "ilswiss_tpu_torch" + mod_name[len("ilswiss_tpu"):]
        return getattr(importlib.import_module(mod_name), fn_name)
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=int(variant.get("expert_net_size",
                                       variant.get("net_size", 256))),
              num_hidden_layers=int(variant.get(
                  "expert_num_hidden_layers",
                  variant.get("num_hidden_layers", 2))),
              device=device)
    algo_state = restore_subtree(str(variant["expert_policy_path"]),
                                 sac.init(0))
    return lambda obs: sac.act(algo_state, obs, deterministic=True)


def run_dagger(variant: Dict[str, Any], device=None):
    """DAgger (reference run_scripts/dagger_exp_script.py; the JAX
    `run_dagger`, experiments.py:777-868): the loop keys under
    `rl_alg_params` or nested in `dagger_params`, the ring seeded with the
    demos, `num_initial_train_steps` expert-only steps first, then epochs
    of `num_steps_per_epoch` env steps with K = `_grad_steps_per_iter` BC
    steps an iteration.  As in the JAX launcher, the env's horizon is read
    before `dagger_params` is merged (so from rl_alg_params' or the
    default 1000), and `dagger_params.num_updates_per_train_call` is not
    read: K comes from `num_train_steps_per_train_call` (default 1000).
    A set `load_params` raises ValueError (the JAX launcher never reads
    it)."""
    from ilswiss_tpu_torch.algorithms.bc import BC, BCConfig
    from ilswiss_tpu_torch.algorithms.dagger import (
        DAggerLoop, DAggerLoopConfig,
    )

    _refuse_resume(variant, "DAgger")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "dagger")
    p = _alg(variant, "dagger_params")
    # the reference nests the loop params inside dagger_params
    for k, v in p.items():
        rl.setdefault(k, v)
    vec = make_vec(env_name, num_envs=max(num_envs, 8), device=device,
                   **env_kwargs)
    bc = BC(vec.env.observation_size, vec.env.action_size,
            BCConfig(mode=str(p.get("mode", "MLE")),
                     lr=float(p.get("lr", 3e-4))),
            net_size=int(variant.get("policy_net_size",
                                     variant.get("net_size", 256))),
            num_hidden_layers=int(variant.get(
                "policy_num_hidden_layers",
                variant.get("num_hidden_layers", 2))),
            device=device)
    loop = DAggerLoop(
        vec, bc, _resolve_expert_fn(variant, vec, device),
        _load_demos(variant, device),
        DAggerLoopConfig(
            batch_size=int(rl.get("batch_size", 256)),
            aggregate_capacity=int(rl.get("replay_buffer_size", 200_000)),
            grad_steps_per_iter=_grad_steps_per_iter(rl, vec.num_envs)))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 8000))
    evaluator = make_evaluator(
        vec, lambda s, o: bc.act(s, o, deterministic=True),
        int(rl.get("max_path_length", 1000)))
    logger.log(f"trainer {type(bc).__name__}: {bc.config}; {loop.config}, "
               f"{loop.grad_steps_per_iter} steps an iteration")
    runner = loop.pretrain(
        loop.init(seed),
        initial_train_steps=int(rl.get("num_initial_train_steps", 1000)))
    logger.log(f"seeded with {runner.aggregate.size} demo rows, cursor "
               f"{runner.aggregate.ptr}")
    return _run_epochs(lambda r: loop.train_epoch(r, steps_per_epoch),
                       evaluator, runner, rl, logger, seed, device)


def _subsample_transitions(state, factor: int, seed: int):
    """Every `factor`-th transition within each episode from a random
    start offset per episode, drawn from np.random.RandomState(seed) (JAX
    experiments.py:2020-2038; the reference gen_expert_demos.py
    subsample_factor)."""
    if factor <= 1:
        return state
    from ilswiss_tpu_torch.data.demo import demos_to_replay_state
    n = state.size
    ep = state.ep_id[:n].cpu().numpy()
    rng = np.random.RandomState(seed)
    keep = np.zeros(n, bool)
    for e in np.unique(ep):
        idx = np.nonzero(ep == e)[0]
        keep[idx[rng.randint(factor)::factor]] = True
    sel = np.nonzero(keep)[0]
    d = {k: v[:n].cpu().numpy()[sel] for k, v in state.data.items()}
    return demos_to_replay_state(
        d["obs"], d["action"], d["reward"], d["next_obs"], d["terminal"],
        ep[sel], device=state.ep_id.device)


def _collect_host_transitions(variant: Dict, env_name: str,
                              env_kwargs: Dict, num_envs: int, seed: int,
                              act_fn: Callable, steps_per_env: int,
                              logger: Logger, device, env=None):
    """`steps_per_env` steps of `act_fn(obs, noise)` (tensors on `device`,
    draws from `Noise(seed, device)`) over a host vector env reset with
    `seed`, packed as a demo ReplayState on `device`: episode ids env *
    1,000,000 + the env's episode count (JAX experiments.py:1981-2017).
    `env` reuses a built env (the DMC pixel branch); else the launcher's
    host env is built.  The env is closed on exit."""
    import torch

    from ilswiss_tpu_torch.data.demo import demos_to_replay_state

    if env is None:
        env = _make_host_env(variant, env_name, env_kwargs, num_envs, seed,
                             logger)
    noise = Noise(seed, device)
    try:
        obs = env.reset(seed=seed)
        rows = {k: [] for k in
                ("obs", "action", "reward", "next_obs", "terminal")}
        ep_rows = []
        ep_counter = np.arange(num_envs, dtype=np.int64) * 1_000_000
        for _ in range(steps_per_env):
            action = act_fn(torch.as_tensor(obs, device=device),
                            noise).cpu().numpy()
            obs_prev, true_next, reward, terminal, done, obs = env.step(
                action)
            rows["obs"].append(obs_prev)
            rows["action"].append(action)
            rows["reward"].append(reward)
            rows["next_obs"].append(true_next)
            rows["terminal"].append(terminal.astype(np.float32))
            ep_rows.append(ep_counter.copy())
            ep_counter += done.astype(np.int64)
    finally:
        env.close()
    flat = {k: np.concatenate(v, axis=0) for k, v in rows.items()}
    return demos_to_replay_state(
        flat["obs"], flat["action"], flat["reward"], flat["next_obs"],
        flat["terminal"], np.concatenate(ep_rows).astype(np.int32),
        device=device)


def run_gen_expert(variant: Dict[str, Any], device=None):
    """Expert demos from a scripted controller (`use_scripted_policy`,
    envs/experts.py) or a trained `sac` / `td3` snapshot at `expert_path`
    (`expert_algo`), rolled over `env_num` device or host envs
    (`_route_host`; `_collect_host_transitions`) for num_rollouts *
    max_path_length steps in all, subsampled per episode
    (`subsample_factor`), saved to `save_path` (default
    demos/<exp_name>.npz) and registered under `expert_name` in
    `demos_listing` (default demos_listing.yaml) (reference
    run_scripts/gen_expert_demos.py; the JAX `run_gen_expert`,
    experiments.py:1839-1978).  `env_name: dmc` rolls a SAC-AE / RAD /
    CURL snapshot at `expert_path` (the port's DMC runner's; `augs` /
    `augmentation_params` give the crop it acts through) over DMC pixel
    envs, the JAX DMC branch (:1857-1903); a set `load_params` raises
    ValueError (the JAX launcher never reads it).  Returns the path
    written."""
    import yaml

    from ilswiss_tpu_torch.data.demo import save_demos_npz
    from ilswiss_tpu_torch.envs.experts import SCRIPTED_EXPERTS
    from ilswiss_tpu_torch.runtime.collector import collect_transitions

    _refuse_resume(variant, "gen_expert")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "gen_expert")
    is_dmc = env_name == "dmc"
    host = is_dmc or _route_host(variant, env_name)
    num_envs = max(1, num_envs)
    max_path_length = int(variant.get(
        "max_path_length", env_kwargs.get("max_episode_steps", 1000)))
    env_kwargs["max_episode_steps"] = max_path_length
    num_rollouts = int(variant.get("num_rollouts", 4))
    subsample = max(1, int(variant.get("subsample_factor", 1)))
    steps_per_env = -(-num_rollouts * max_path_length // num_envs)
    deterministic = bool(variant.get("use_deterministic_expert", True))
    vec = None if host else make_vec(env_name, num_envs=num_envs,
                                     device=device, **env_kwargs)
    dmc_env = None

    if is_dmc:
        # a pixel expert: host-rendered frames and a trained SAC-AE / RAD /
        # CURL snapshot, its trainer read from encoder_params alone
        from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEConfig
        from ilswiss_tpu_torch.data.augmentations import center_crop

        dmc_env = _dmc_env(variant, env_kwargs, num_envs, seed)
        img_size = dmc_env.observation_size[0]
        enc = _alg(variant, "encoder_params")
        augs, crop_size = _visual_augs(variant, img_size)
        algo = SACAE(
            action_size=dmc_env.action_size,
            config=SACAEConfig(
                image_size=crop_size if augs else img_size,
                frame_channels=dmc_env.observation_size[-1],
                feature_dim=int(enc.get("encoder_feature_dim", 50)),
                num_conv_layers=int(enc.get("num_layers", 4)),
                num_filters=int(enc.get("num_filters", 32))),
            net_size=int(variant.get("net_size", 1024)),
            num_hidden_layers=int(variant.get("num_hidden_layers", 2)),
            device=device)
        algo_state = restore_subtree(str(variant["expert_path"]),
                                     algo.init(0))

        def act_fn(obs, noise):
            if augs:
                obs = center_crop(obs, crop_size)
            if deterministic:
                return algo.act(algo_state, obs, deterministic=True)
            return algo.act(algo_state, obs,
                            *algo.act_noise(noise, obs.shape[0]))
    elif bool(variant.get("use_scripted_policy", False)):
        if env_name not in SCRIPTED_EXPERTS:
            raise KeyError(f"no scripted expert for '{env_name}'; "
                           f"available: {sorted(SCRIPTED_EXPERTS)}")
        controller = SCRIPTED_EXPERTS[env_name]
        act_fn = lambda obs, noise: controller(obs)  # noqa: E731
    else:
        expert_algo = str(variant.get("expert_algo", "sac"))
        obs_size, action_size = (
            _host_env_sizes(env_name, env_kwargs) if host
            else (vec.env.observation_size, vec.env.action_size))
        nets = dict(net_size=int(variant.get("net_size", 256)),
                    num_hidden_layers=int(variant.get("num_hidden_layers",
                                                      2)))
        if expert_algo == "td3":
            from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
            algo = TD3(obs_size, action_size, TD3Config(), device=device,
                       **nets)
        else:
            from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
            algo = SAC(obs_size, action_size, SACConfig(), device=device,
                       **nets)
        algo_state = restore_subtree(str(variant["expert_path"]),
                                     algo.init(0))

        def act_fn(obs, noise):
            if deterministic:
                return algo.act(algo_state, obs, deterministic=True)
            return algo.act(algo_state, obs,
                            *algo.act_noise(noise, obs.shape[0]))

    if host:
        demos = _collect_host_transitions(variant, env_name, env_kwargs,
                                          num_envs, seed, act_fn,
                                          steps_per_env, logger, device,
                                          env=dmc_env)
    else:
        demos = collect_transitions(vec, act_fn, steps_per_env,
                                    Noise(seed, device))
    demos = _subsample_transitions(demos, subsample, seed)

    out_path = str(variant.get("save_path") or os.path.join(
        "demos", f"{variant.get('exp_name', 'gen_expert')}.npz"))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_demos_npz(out_path, demos)
    mean_rew = float(demos.data["reward"].mean())
    logger.log(f"saved {demos.size} transitions to {out_path} "
               f"(mean step reward {mean_rew:.3f})")

    listing_path = str(variant.get("demos_listing", "demos_listing.yaml"))
    listing = {}
    if os.path.exists(listing_path):
        with open(listing_path) as f:
            listing = yaml.safe_load(f) or {}
    key = str(variant.get(
        "expert_name", os.path.splitext(os.path.basename(out_path))[0]))
    listing[key] = {"file_path": out_path, "env": env_name,
                    "num_transitions": demos.size}
    with open(listing_path, "w") as f:
        yaml.safe_dump(listing, f)
    logger.record_tabular("NumTransitions", demos.size)
    logger.record_tabular("MeanStepReward", mean_rew)
    logger.dump_tabular(0)
    logger.close()
    return out_path


def _visual_augs(variant: Dict, img_size: int) -> tuple[tuple, int]:
    """RAD / CURL augmentation knobs (JAX experiments.py:1151-1163): the
    repo's `augs` / `crop_size`, or the reference's `augmentation_params`
    (`data_augs` dash-joined, `image_size` the size after augmenting)."""
    aug_p = _alg(variant, "augmentation_params")
    augs = tuple(variant.get("augs") or ())
    if not augs and aug_p.get("data_augs"):
        augs = tuple(a.strip() for a in
                     str(aug_p["data_augs"]).split("-") if a.strip())
    crop = variant.get("crop_size", aug_p.get("image_size", img_size))
    return augs, int(crop)


class _CropActing:
    """SAC-AE for the loops, its acting through `view` (the center crop of
    RAD and CURL; JAX experiments.py:1265-1283, 1461-1491).  It forwards
    `acting_state`, or the host loop's per-segment acting copy would hold
    the whole state (critics, decoder, targets, five optimizers)."""

    def __init__(self, algo, view: Callable):
        self.algo, self.view = algo, view
        self.device = algo.device
        self.action_size = algo.action_size
        self.init = algo.init
        self.act_noise = algo.act_noise
        self.train_noise = algo.train_noise
        self.train_step = algo.train_step
        self.acting_state = algo.acting_state

    def act(self, state, obs, eps=None, deterministic=False):
        return self.algo.act(state, self.view(obs), eps,
                             deterministic=deterministic)


# free device memory where the backend reports none: the JAX launcher's
# fallback (its `_hbm_replay_capacity`, experiments.py:1189), kept so that
# the port sizes a ring on the CPU as the JAX launcher does there
JAX_FREE_MEMORY_FALLBACK = 16_000_000_000


def _hbm_replay_capacity(requested: int, obs_shape, logger: Logger, device,
                         budget_frac: float = 0.35) -> int:
    """The rows of a uint8 image ring that fit the device (JAX
    experiments.py:1166-1202): the obs and next_obs rings get
    `budget_frac` of the device's free memory (`torch.cuda.mem_get_info`
    on a card; JAX_FREE_MEMORY_FALLBACK elsewhere), in whole thousands of
    rows, at least 1000; the spec's value is an upper bound, never
    exceeded.  A full-snapshot resume under other memory pressure can
    derive another capacity, whose ring the snapshot then does not fit
    (the restore raises); light snapshots, the visual runs' default,
    rebuild the ring."""
    import torch

    bytes_per = 2 * int(np.prod(obs_shape))   # a uint8 obs + next_obs row
    device = torch.device(device)
    if device.type == "cuda":
        free = int(torch.cuda.mem_get_info(device)[0])
    else:
        free = JAX_FREE_MEMORY_FALLBACK
    derived = max(1000, int(free * budget_frac) // bytes_per // 1000 * 1000)
    cap = min(int(requested), derived)
    logger.log(
        f"visual replay sizing: spec={requested} derived={derived} "
        f"(free HBM {free / 1e9:.1f} GB, {bytes_per} B/transition, "
        f"budget {budget_frac:.0%}) -> capacity {cap}")
    return cap


def _dmc_env(variant: Dict, env_kwargs: Dict, num_envs: int, seed: int):
    """The DMC pixel env of a spec (`env_specs.frame_stack`, default 3;
    env_kwargs without the launcher's max_episode_steps and dmc2gym's
    visualize_reward and from_pixels: DMC's own time limit ends episodes),
    rendering through EGL unless MUJOCO_GL names another backend."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    from ilswiss_tpu_torch.envs.host_dmc import DMCVectorEnv

    kw = dict(env_kwargs)
    for drop in ("max_episode_steps", "visualize_reward", "from_pixels"):
        kw.pop(drop, None)
    return DMCVectorEnv(
        num_envs=max(1, num_envs), seed=seed,
        frame_stack=int(_alg(variant, "env_specs").get("frame_stack", 3)),
        **kw)


def _run_host_sac_ae(variant: Dict, rl: Dict, logger: Logger, seed: int,
                     env_kwargs: Dict, num_envs: int, device):
    """SAC-AE, RAD and CURL on the DMC pixel envs (JAX experiments.py:
    1204-1407, the reference's dmc2gym runs): frames rendered and stepped
    on the host (envs/host_dmc.py), a uint8 ring and the learner on
    `device` (`HostOffPolicyLoop`).

    The trainer is read from `encoder_params` (encoder_feature_dim,
    num_layers, num_filters; the top-level feature_dim / num_conv_layers /
    num_filters only where it has none, whereas the device branch reads
    the top level alone) and `sac_params`; nets default to 1024 x 2.
    Segments: `num_steps_between_train_calls` env steps a train call in the
    reference; here max(that, `min_segment_steps`, default 250) env steps
    a segment, with the gradient steps at the spec's ratio, unless
    `exact_cadence` (the JAX rule, kept for parity).  The ring holds
    `_hbm_replay_capacity` rows.  `prewarm_only`: one segment, then exit;
    `max_wall_minutes`: at the first epoch boundary past it, flush a
    'last' snapshot and exit.  Snapshots: 'last' every min(4, freq_saving)
    epochs and at the end, params only unless `light_snapshots` is false;
    'best' params only.  Resume (`load_params`): as `_run_host_off_policy`,
    the TotalEnvSteps convention of ROADMAP.md section 3 (host fault 2).
    Each epoch logs the trainer's metrics, the evaluation
    (num_steps_per_eval // max_path_length episodes from a reset with
    seed + epoch + 1 + 10,000), TotalEnvSteps, TrainTime, EnvStepsPerSec
    and SnapshotTime, the JAX keys."""
    from functools import partial

    from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEConfig
    from ilswiss_tpu_torch.data.aug_replay import augmented_sample
    from ilswiss_tpu_torch.data.augmentations import center_crop
    from ilswiss_tpu_torch.runtime.host_loop import (
        HostLoopConfig, HostOffPolicyLoop,
    )

    env = _dmc_env(variant, env_kwargs, num_envs, seed)
    try:
        img_size = env.observation_size[0]
        p = _alg(variant, "sac_params")
        enc = _alg(variant, "encoder_params")
        augs, crop_size = _visual_augs(variant, img_size)
        use_cpc = int(p.get("cpc_update_freq", 0)) > 0
        algo = SACAE(
            action_size=env.action_size,
            config=SACAEConfig(
                image_size=crop_size if augs else img_size,
                frame_channels=env.observation_size[-1],
                feature_dim=int(enc.get("encoder_feature_dim",
                                        variant.get("feature_dim", 50))),
                num_conv_layers=int(enc.get(
                    "num_layers", variant.get("num_conv_layers", 4))),
                num_filters=int(enc.get("num_filters",
                                        variant.get("num_filters", 32))),
                discount=float(p.get("discount", 0.99)),
                reward_scale=float(p.get("reward_scale", 1.0)),
                policy_lr=float(p.get("policy_lr", 1e-3)),
                qf_lr=float(p.get("qf_lr", 1e-3)),
                encdec_lr=float(p.get("encdec_lr", 1e-3)),
                init_alpha=float(p.get("alpha", 0.1)),
                alpha_lr=float(p.get("alpha_lr", 1e-3)),
                soft_target_tau=float(p.get("soft_target_tau", 0.01)),
                enc_soft_target_tau=float(p.get("enc_soft_target_tau",
                                                0.05)),
                ac_update_freq=int(p.get("ac_update_freq", 2)),
                encdec_update_freq=int(p.get("encdec_update_freq", 1)),
                cpc_update_freq=int(p.get("cpc_update_freq", 0)),
                target_update_freq=int(p.get("target_update_freq", 2)),
            ),
            net_size=int(variant.get("net_size", 1024)),
            num_hidden_layers=int(variant.get("num_hidden_layers", 2)),
            device=device)

        def view(obs):
            return center_crop(obs, crop_size) if augs else obs

        # the JAX rule: segments of at least min_segment_steps env steps
        # at the spec's ratio of gradient steps to env steps
        steps_between = int(rl.get("num_steps_between_train_calls", 1000))
        train_per_call = int(rl.get("num_train_steps_per_train_call", 500))
        if bool(rl.get("exact_cadence", False)):
            segment = steps_between
        else:
            segment = max(steps_between,
                          int(rl.get("min_segment_steps", 250)))
        grads_per_segment = max(1, round(
            segment * train_per_call / max(1, steps_between)))
        loop = HostOffPolicyLoop(env, _CropActing(algo, view), HostLoopConfig(
            batch_size=int(rl.get("batch_size", 128)),
            replay_capacity=_hbm_replay_capacity(
                int(rl.get("replay_buffer_size", 100_000)),
                env.observation_size, logger, device),
            steps_between_train_calls=segment,
            train_steps_per_call=grads_per_segment,
            min_steps_before_training=int(
                rl.get("min_steps_before_training", 1000)),
        ), sample_fn=(partial(augmented_sample, augs=augs,
                              out_size=crop_size, cpc=use_cpc)
                      if augs else None))

        steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
        num_epochs = int(rl.get("num_epochs", 100))
        num_eval_episodes = _num_host_eval_episodes(rl)
        light = bool(rl.get("light_snapshots", True))
        snap = SnapshotManager(
            logger.log_dir, mode="gap_last",
            gap=min(4, int(rl.get("freq_saving", 10))),
            save_best=bool(rl.get("save_best", True)),
            best_state_fn=lambda r: {"algo_state": r.algo_state},
            last_state_fn=(
                (lambda r: {"algo_state": r.algo_state}) if light else None))
        logger.log(f"trainer {type(algo).__name__} on host env {env.name}: "
                   f"{algo.config}; augs {augs}, crop {crop_size}; "
                   f"{loop.config}")

        runner = loop.init(seed)
        runner, start_epoch, resumed, meta = _maybe_resume(variant, logger,
                                                           runner)
        snap.best_value = float(meta.get("best_value", snap.best_value))
        if resumed != "full":
            runner = loop.warmup(runner)
            logger.log(f"warmup done: {runner.total_env_steps} env steps")
        steps_offset = (start_epoch * steps_per_epoch
                        if resumed == "light" else 0)
        if bool(rl.get("prewarm_only", False)):
            t0 = time.time()
            runner, _ = loop.train_epoch(runner, segment)
            logger.log(f"prewarm: one segment of the visual learner in "
                       f"{time.time() - t0:.1f}s")
            return runner
        wall_budget_s = float(rl.get("max_wall_minutes", 0)) * 60.0
        run_t0 = time.time()
        for epoch in range(start_epoch, num_epochs):
            if wall_budget_s and time.time() - run_t0 > wall_budget_s:
                logger.log(
                    f"wall budget {wall_budget_s / 60:.0f} min reached at "
                    f"epoch {epoch}; flushing 'last' and exiting (resume "
                    f"via load_params)")
                snap.save_last(runner, epoch=epoch - 1)
                return runner
            t0 = time.time()
            runner, metrics = loop.train_epoch(runner, steps_per_epoch)
            train_time = time.time() - t0
            eval_stats = loop.evaluate(runner, num_eval_episodes,
                                       seed=seed + epoch + 1)
            logger.record_dict(metrics, prefix="trainer/")
            logger.record_dict(eval_stats)
            logger.record_tabular("TotalEnvSteps",
                                  steps_offset + runner.total_env_steps)
            logger.record_tabular("TrainTime", train_time)
            logger.record_tabular(
                "EnvStepsPerSec", steps_per_epoch / max(train_time, 1e-9))
            t_snap = time.time()
            snap.on_epoch(epoch, runner, eval_stats)
            logger.record_tabular("SnapshotTime", time.time() - t_snap)
            logger.dump_tabular(epoch)
        if num_epochs > start_epoch:
            snap.save_last(runner, epoch=num_epochs - 1)
        return runner
    finally:
        env.close()
        logger.close()


def run_sac_ae(variant: Dict[str, Any], device=None):
    """SAC-AE, RAD and CURL on a device pixel env (reference
    run_scripts/sac_alpha_visual_exp_script.py; the device branch of the
    JAX `run_sac_ae`, experiments.py:1409-1516).  With `augs` the encoder
    is sized for the crop: training batches are augmented
    (data/aug_replay.py, with CURL's views where cpc_update_freq > 0), and
    acting and evaluation see center-cropped frames.  The evaluation runs
    on the training envs for `max_path_length` steps; each epoch logs the
    trainer's metrics, the evaluation, TotalEnvSteps, TrainTime and
    EvalTime, and snapshots as `_run_epochs` does; a set `load_params`
    raises ValueError (the JAX device branch never reads it, so a resume
    there silently starts afresh and overwrites the run's snapshots).
    `env_name: dmc` takes the host DMC branch, `_run_host_sac_ae`, which
    does resume."""
    from functools import partial

    from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEConfig
    from ilswiss_tpu_torch.data.aug_replay import augmented_sample
    from ilswiss_tpu_torch.data.augmentations import center_crop

    device = resolve_device(device)
    if _alg(variant, "env_specs").get("env_name") == "dmc":
        seed, _, env_kwargs, num_envs, rl, logger = _setup(variant,
                                                           "sac_ae")
        return _run_host_sac_ae(variant, rl, logger, seed, env_kwargs,
                                num_envs, device)
    _refuse_resume(variant, "SAC-AE")
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "sac_ae")
    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
    img_size = vec.env.observation_size[0]
    p = _alg(variant, "sac_params")
    augs, crop_size = _visual_augs(variant, img_size)
    use_cpc = int(p.get("cpc_update_freq", 0)) > 0
    algo = SACAE(
        action_size=vec.env.action_size,
        config=SACAEConfig(
            image_size=crop_size if augs else img_size,
            frame_channels=vec.env.observation_size[-1],
            feature_dim=int(variant.get("feature_dim", 50)),
            num_conv_layers=int(variant.get("num_conv_layers", 4)),
            num_filters=int(variant.get("num_filters", 32)),
            discount=float(p.get("discount", 0.99)),
            reward_scale=float(p.get("reward_scale", 1.0)),
            policy_lr=float(p.get("policy_lr", 1e-3)),
            qf_lr=float(p.get("qf_lr", 1e-3)),
            encdec_lr=float(p.get("encdec_lr", 1e-3)),
            init_alpha=float(p.get("alpha", 0.1)),
            alpha_lr=float(p.get("alpha_lr", 1e-3)),
            soft_target_tau=float(p.get("soft_target_tau", 0.01)),
            enc_soft_target_tau=float(p.get("enc_soft_target_tau", 0.05)),
            ac_update_freq=int(p.get("ac_update_freq", 2)),
            encdec_update_freq=int(p.get("encdec_update_freq", 1)),
            cpc_update_freq=int(p.get("cpc_update_freq", 0)),
            target_update_freq=int(p.get("target_update_freq", 2)),
        ),
        device=device, **_nets(variant))

    def view(obs):
        # the encoder is sized for the crop: acting sees the center crop
        return center_crop(obs, crop_size) if augs else obs

    loop = OffPolicyLoop(
        vec, _CropActing(algo, view),
        OffPolicyConfig(
            batch_size=int(rl.get("batch_size", 128)),
            replay_capacity=int(rl.get("replay_buffer_size", 100_000)),
            min_steps_before_training=int(
                rl.get("min_steps_before_training", 1000)),
            grad_steps_per_iter=_grad_steps_per_iter(rl, num_envs)),
        sample_fn=(partial(augmented_sample, augs=augs, out_size=crop_size,
                           cpc=use_cpc) if augs else None))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    evaluator = make_evaluator(
        vec, lambda s, o: algo.act(s, view(o), deterministic=True),
        int(rl.get("max_path_length", 200)))
    logger.log(f"trainer {type(algo).__name__}: {algo.config}; augs "
               f"{augs}, crop {crop_size}, {loop.grad_steps_per_iter} "
               f"steps an iteration")
    return _run_epochs(lambda r: loop.train_epoch(r, steps_per_epoch),
                       evaluator, loop.warmup(loop.init(seed)), rl, logger,
                       seed, device)


def _run_host_her(her, env, rl: Dict, logger: Logger, seed: int,
                  relabel: Dict, num_episode_slots: int):
    """HER's host path (JAX experiments.py:1571-1609): segments of
    max(horizon * env_num, num_steps_between_train_calls) env steps with
    num_train_steps_per_train_call / num_steps_between_train_calls inner
    steps an env step, a warmup of `min_steps_before_training` steps (or
    two episodes of every env), the SuccessRate evaluation; per epoch the
    trainer's metrics, the evaluation's keys, TotalEnvSteps and TrainTime,
    and a snapshot."""
    from ilswiss_tpu_torch.algorithms.her import HERLoopConfig, HostHERLoop

    between = int(rl.get("num_steps_between_train_calls", 1000))
    segment_steps = max(env.max_episode_steps * env.num_envs, between)
    grad_per_step = (int(rl.get("num_train_steps_per_train_call", 1))
                     / max(1, int(rl.get("num_steps_between_train_calls",
                                         2))))
    loop = HostHERLoop(
        env, her,
        HERLoopConfig(batch_size=int(rl.get("batch_size", 256)),
                      num_episode_slots=num_episode_slots),
        grad_steps_per_segment=max(1, int(segment_steps * grad_per_step)),
        segment_steps=segment_steps, **relabel)
    num_eval_episodes = max(1, int(rl.get("num_steps_per_eval", 1000))
                            // env.max_episode_steps)
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 4000))
    snap = SnapshotManager(logger.log_dir,
                           gap=int(rl.get("freq_saving", 10)))
    logger.log(f"trainer HER({type(her.inner).__name__}) on host env "
               f"{env.name}: {her.inner.config}; {loop.config}, "
               f"{loop.grad_steps_per_segment} steps a segment of "
               f"{segment_steps}")
    try:
        runner = loop.warmup(
            loop.init(seed),
            min_steps=int(rl.get("min_steps_before_training", 0)) or None)
        for epoch in range(int(rl.get("num_epochs", 50))):
            t0 = time.time()
            runner, metrics = loop.train_epoch(runner, steps_per_epoch)
            eval_stats = loop.evaluate(runner, num_eval_episodes,
                                       seed=seed + epoch + 1)
            logger.record_dict(metrics, prefix="trainer/")
            logger.record_dict(eval_stats)
            logger.record_tabular("TotalEnvSteps", runner.total_env_steps)
            logger.record_tabular("TrainTime", time.time() - t0)
            logger.dump_tabular(epoch)
            snap.on_epoch(epoch, runner, eval_stats)
    finally:
        env.close()
    logger.close()
    return runner


def run_her(variant: Dict[str, Any], device=None):
    """HER over SAC or TD3 (`inner_algo`) on a goal env (reference
    run_scripts/her_*_exp_script.py; the JAX `run_her`,
    experiments.py:1519-1657): TD3 with the reference's target clip
    [-1 / (1 - discount), 0] and the Gaussian-and-epsilon explorer
    (`max_sigma` or `exploration_noise`, `epsilon`); the relabel knobs
    from `her_params` or `rl_alg_params`; the evaluation on the training
    envs for the env's horizon.  A host goal env (the Fetch specs) goes
    through `_run_host_her`.  A set `load_params` raises ValueError (the
    JAX launcher never reads it)."""
    from ilswiss_tpu_torch.algorithms.her import HER, HERLoop, HERLoopConfig

    _refuse_resume(variant, "HER")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant, "her")
    if _route_host(variant, env_name):
        from ilswiss_tpu_torch.envs.host_mujoco import HostGoalVectorEnv
        kw = dict(env_kwargs)
        vec, env = None, HostGoalVectorEnv(
            env_name, num_envs=num_envs, seed=seed,
            max_episode_steps=kw.pop("max_episode_steps", None),
            env_kwargs=kw)
    else:
        vec = make_vec(env_name, num_envs=num_envs, device=device,
                       **env_kwargs)
        env = vec.env
    obs_size = env.observation_size + env.goal_size
    nets = _nets(variant)
    if str(variant.get("inner_algo", "sac")) == "td3":
        from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
        p = _alg(variant, "td3_params")
        discount = float(p.get("discount", 0.98))
        inner = TD3(obs_size, env.action_size, TD3Config(
            discount=discount,
            # the reference her/td3.py:79-86 target clip
            q_target_min=-1.0 / (1.0 - discount),
            q_target_max=0.0,
            # the reference's MlpGaussianAndEpsilonPolicy defaults
            exploration_noise=float(
                p.get("max_sigma", p.get("exploration_noise", 0.2))),
            exploration_epsilon=float(p.get("epsilon", 0.3)),
        ), device=device, **nets)
    else:
        from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
        p = _alg(variant, "sac_params")
        inner = SAC(obs_size, env.action_size, SACConfig(
            discount=float(p.get("discount", 0.98)),
            reward_scale=float(p.get("reward_scale", 1.0)),
        ), device=device, **nets)
    her = HER(inner)
    hp = _alg(variant, "her_params")
    # the reference HER specs keep the relabel knobs in rl_alg_params
    relabel = dict(
        relabel_type=str(hp.get("relabel_type",
                                rl.get("relabel_type", "future"))),
        her_ratio=float(hp.get("her_ratio", rl.get("her_ratio", 0.8))))
    if vec is None:
        return _run_host_her(her, env, rl, logger, seed, relabel,
                             int(hp.get("num_episode_slots", 1024)))
    loop = HERLoop(
        vec, her,
        HERLoopConfig(
            batch_size=int(rl.get("batch_size", 256)),
            num_episode_slots=int(hp.get("num_episode_slots", 1024)),
            grad_steps_per_iter=_grad_steps_per_iter(rl, vec.num_envs)),
        **relabel)
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 4000))
    rl.setdefault("num_epochs", 50)
    evaluator = make_evaluator(
        vec, lambda s, o: her.act(s, o, deterministic=True),
        env.max_episode_steps)
    logger.log(f"trainer HER({type(inner).__name__}): {inner.config}; "
               f"{loop.config}, {loop.grad_steps_per_iter} steps an "
               f"iteration")
    return _run_epochs(lambda r: loop.train_epoch(r, steps_per_epoch),
                       evaluator, loop.warmup(loop.init(seed)), rl, logger,
                       seed, device)


def run_gcsl(variant: Dict[str, Any], device=None):
    """GCSL on a device goal env (reference gcsl/rl.py; the JAX
    `run_gcsl`, experiments.py:1659-1720): `gcsl_params` (mode MLE, MSE or
    CLASS, lr, use_horizons, num_episode_slots), the one-hot's width the
    env's horizon, and with `env_specs.discretize` a `DiscretEnv` of
    `discret_kwargs` (granularity, possible_actions) under a CLASS-mode
    policy.  A set `load_params` raises ValueError (the JAX launcher never
    reads it).  As in the JAX launcher, a host env name raises KeyError
    (no device env of that name) and `force_host` is not read."""
    from ilswiss_tpu_torch.algorithms.gcsl import GCSL, GCSLConfig, GCSLLoop
    from ilswiss_tpu_torch.algorithms.her import HERLoopConfig
    from ilswiss_tpu_torch.envs.wrappers import DiscretEnv

    _refuse_resume(variant, "GCSL")
    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(variant, "gcsl")
    env_specs = _alg(variant, "env_specs")
    env = make(env_name, device=device, **env_kwargs)
    if bool(env_specs.get("discretize", False)):
        dk = dict(env_specs.get("discret_kwargs") or {})
        env = DiscretEnv(env, granularity=int(dk.get("granularity", 10)),
                         possible_actions=dk.get("possible_actions"))
    vec = VectorEnv(env, num_envs)
    p = _alg(variant, "gcsl_params")
    gcsl = GCSL(
        env.observation_size, env.goal_size, env.action_size,
        GCSLConfig(mode=str(p.get("mode", "MSE")),
                   lr=float(p.get("lr", 1e-3)),
                   use_horizons=bool(p.get("use_horizons", True)),
                   max_horizon=env.max_episode_steps),
        device=device, **_nets(variant))
    loop = GCSLLoop(vec, gcsl, HERLoopConfig(
        batch_size=int(rl.get("batch_size", 256)),
        num_episode_slots=int(p.get("num_episode_slots", 1024)),
        grad_steps_per_iter=_grad_steps_per_iter(rl, num_envs)))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 4000))
    rl.setdefault("num_epochs", 50)
    evaluator = make_evaluator(
        vec, lambda s, o: gcsl.act(s, o, deterministic=True),
        env.max_episode_steps)
    logger.log(f"trainer {type(gcsl).__name__}: {gcsl.config}; "
               f"{loop.config}, {loop.grad_steps_per_iter} steps an "
               f"iteration")
    return _run_epochs(lambda r: loop.train_epoch(r, steps_per_epoch),
                       evaluator, loop.warmup(loop.init(seed)), rl, logger,
                       seed, device)


def run_sac_vmapped_seeds(variant: Dict[str, Any], device=None):
    """N independent SAC seeds in one process (the JAX
    `run_sac_vmapped_seeds`, experiments.py:2041-2186; exp_specs/sac/
    sac_hopper_seeds.yaml): `seeds` (default 0, 1, 2) each train as a
    one-seed `run_sac` on a device env would, from `OffPolicyLoop.init(
    seed)`, through `runtime/seeds.py::SeedsOffPolicyLoop`, which steps all
    seeds' envs as one batch (K1 once per control step on a planar model).
    Each seed writes `seed_<s>_id0/progress.csv` and variant.json under
    the experiment's directory (`log_dir`, or logs/<exp_name>), and each
    epoch adds a row to `seeds_summary.csv` there (its header, returns
    rounded to 2 places) and prints the JAX epoch line.  The evaluation:
    max(num_steps_per_eval // max_path_length, min_eval_episodes (32),
    env_num) envs a seed, deterministic, reset from Noise(100,000 * (epoch
    + 1) + s), all seeds' envs as one batch.  Snapshots of the seeds'
    runners under the experiment's directory (mode `snapshot_mode`,
    default gap_and_last; 'best', at the seeds' mean return, params
    only); `load_params` resumes through `_maybe_resume`, and a light
    resume refills the rings through warmup (the JAX launcher warms up
    only at epoch 0, so after a light resume it trains on empty rings:
    ROADMAP.md section 3).  A host env raises ValueError, as in JAX."""
    import csv

    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.runtime.seeds import (
        SeedsOffPolicyLoop, make_seeds_evaluator,
    )

    device = resolve_device(device)
    seeds = [int(s) for s in variant.get("seeds") or (0, 1, 2)]
    env_specs = _alg(variant, "env_specs")
    env_name = env_specs.get("env_name", "hopper")
    env_kwargs = dict(env_specs.get("env_kwargs") or {})
    rl = _alg(variant, "rl_alg_params")
    max_path_length = int(rl.get("max_path_length", 1000))
    env_kwargs.setdefault("max_episode_steps", max_path_length)
    num_envs = int(env_specs.get("env_num", 8))
    if _is_host_env(env_name):
        raise ValueError(
            "sac_vmap_seeds needs an on-device env (got host env "
            f"{env_name!r}): the seeds' envs step as one device batch")

    exp_dir = variant.get("log_dir") or os.path.join(
        "logs", variant.get("exp_name", "sac_seeds"))
    loggers = []
    for s in seeds:
        lg = Logger(os.path.join(exp_dir, f"seed_{s}_id0"),
                    print_to_console=False)
        lg.save_variant({**variant, "seed": s})
        loggers.append(lg)

    vec = make_vec(env_name, num_envs=num_envs, device=device, **env_kwargs)
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
            target_entropy=p.get("target_entropy"),
        ),
        use_fused_chain=bool(p.get("use_fused_chain", False)),
        device=device, **_nets(variant))
    loop = SeedsOffPolicyLoop(vec, algo, OffPolicyConfig(
        batch_size=int(rl.get("batch_size", 512)),
        replay_capacity=int(rl.get("replay_buffer_size", 1_000_000)),
        min_steps_before_training=int(
            rl.get("min_steps_before_training", 5000)),
        grad_steps_per_iter=_grad_steps_per_iter(rl, num_envs),
    ), num_seeds=len(seeds))
    steps_per_epoch = int(rl.get("num_steps_per_epoch", 10_000))
    num_epochs = int(rl.get("num_epochs", 100))
    n_eval = max(
        int(rl.get("num_steps_per_eval", 10_000)) // max_path_length,
        int(rl.get("min_eval_episodes", 32)), num_envs)
    evaluate = make_seeds_evaluator(
        VectorEnv(vec.env, n_eval),
        lambda s, o: algo.act(s, o, deterministic=True), max_path_length,
        len(seeds))
    snap = SnapshotManager(
        exp_dir, mode=str(rl.get("snapshot_mode", "gap_and_last")),
        gap=int(rl.get("freq_saving", 10)),
        save_best=bool(rl.get("save_best", True)),
        best_state_fn=lambda r: {"algo_state": r.algo_state})
    loggers[0].log(f"trainer {type(algo).__name__} x {len(seeds)} seeds "
                   f"{seeds}: {algo.config}; {loop.config}, "
                   f"{loop.loop.grad_steps_per_iter} steps an iteration")

    runner = loop.init(seeds)
    runner, start_epoch, resumed, meta = _maybe_resume(variant, loggers[0],
                                                       runner)
    snap.best_value = float(meta.get("best_value", snap.best_value))
    if resumed != "full":
        runner = loop.warmup(runner)
    steps_offset = (start_epoch * steps_per_epoch
                    if resumed == "light" else 0)

    summary_path = os.path.join(exp_dir, "seeds_summary.csv")
    with open(summary_path, "a", newline="") as fh:
        if fh.tell() == 0:
            csv.writer(fh).writerow(
                ["Epoch", "TotalEnvSteps", "MeanAverageReturn",
                 "StdAverageReturn"] + [f"Return_seed{s}" for s in seeds])

    for epoch in range(start_epoch, num_epochs):
        t0 = time.time()
        runner, metrics = loop.train_epoch(runner, steps_per_epoch)
        train_time = time.time() - t0
        t0 = time.time()
        stats = evaluate(runner.algo_state,
                         [Noise(100_000 * (epoch + 1) + s, device)
                          for s in seeds])
        eval_time = time.time() - t0
        steps = [steps_offset + r.total_env_steps for r in runner.runners]
        rets = np.asarray([st["AverageReturn"] for st in stats], np.float64)
        for lg, m, st, n in zip(loggers, metrics, stats, steps):
            lg.record_dict(m, prefix="trainer/")
            lg.record_dict(st)
            lg.record_tabular("TotalEnvSteps", n)
            lg.record_tabular("TrainTime", train_time)
            lg.record_tabular("EvalTime", eval_time)
            lg.dump_tabular(epoch)
        with open(summary_path, "a", newline="") as fh:
            csv.writer(fh).writerow(
                [epoch, steps[0], round(float(rets.mean()), 2),
                 round(float(rets.std()), 2)]
                + [round(float(r), 2) for r in rets])
        print(f"[sac_vmap_seeds] epoch {epoch}: return "
              f"{rets.mean():.1f} ± {rets.std():.1f} "
              f"(seeds {np.round(rets, 1).tolist()}), "
              f"{steps_per_epoch * len(seeds) / max(train_time, 1e-9):.0f}"
              f" agg steps/s", flush=True)
        snap.on_epoch(epoch, runner, {"AverageReturn": float(rets.mean())})
    for lg in loggers:
        lg.close()
    return runner


def run_render_policy(variant: Dict[str, Any], device=None):
    """Deterministic rollouts of a trained SAC policy rendered to video
    (reference run_scripts/render_algorithm.py and video.py:12-29; the JAX
    `run_render_policy`, experiments.py:918-976).  The policy is restored
    from the SAC snapshot at `policy_checkpoint` (`policy_net_size` x
    `policy_num_hidden_layers`) onto `device`; the frames come from the
    matching gymnasium env (render_mode rgb_array, EGL unless MUJOCO_GL
    names another backend): the device envs have no renderer, and their
    observations are gymnasium's, so a policy trained on them acts on the
    gymnasium env.  Rollout r (of `num_rollouts`) resets with seed + r,
    runs at most `max_path_length` steps, is written to rollout_<r>.mp4 in
    the run's log dir (`logging/vistools.py::save_video`; a gif where no
    ffmpeg backend is installed) at `fps` (default 1 / the env's dt), and
    logs Return_<r>."""
    import torch

    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.logging.vistools import save_video

    os.environ.setdefault("MUJOCO_GL", "egl")
    import gymnasium

    device = resolve_device(device)
    seed, env_name, env_kwargs, num_envs, rl, logger = _setup(
        variant, "render_policy")
    env = gymnasium.make(GYM_ENV_IDS.get(env_name, env_name),
                         render_mode="rgb_array")
    try:
        obs, _ = env.reset(seed=seed)
        sac = SAC(int(np.prod(env.observation_space.shape)),
                  int(np.prod(env.action_space.shape)), SACConfig(),
                  net_size=int(variant.get("policy_net_size", 256)),
                  num_hidden_layers=int(variant.get(
                      "policy_num_hidden_layers", 2)),
                  device=device)
        algo_state = restore_subtree(variant["policy_checkpoint"],
                                     sac.init(0))

        def act(o):
            x = torch.as_tensor(np.asarray(o, np.float32), device=device)
            return sac.act(algo_state, x[None],
                           deterministic=True)[0].cpu().numpy()

        num_rollouts = int(variant.get("num_rollouts", 1))
        max_path_length = int(variant.get(
            "max_path_length", rl.get("max_path_length", 1000)))
        fps = int(variant.get("fps", round(1.0 / env.unwrapped.dt)))
        for r in range(num_rollouts):
            obs, _ = env.reset(seed=seed + r)
            frames, ret = [env.render()], 0.0
            for _ in range(max_path_length):
                obs, rew, term, trunc, _ = env.step(act(obs))
                ret += float(rew)
                frames.append(env.render())
                if term or trunc:
                    break
            out = save_video(
                np.stack(frames),
                os.path.join(logger.log_dir, f"rollout_{r}.mp4"), fps=fps)
            logger.log(f"rollout {r}: return {ret:.1f}, "
                       f"{len(frames)} frames -> {out}")
            logger.record_tabular(f"Return_{r}", ret)
        logger.dump_tabular(0)
    finally:
        env.close()
        logger.close()


# every name of the JAX table (experiments.py:2188-2210)
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
    "bc": run_bc,
    "dagger": run_dagger,
    "gen_expert": run_gen_expert,
    "her": run_her,
    "gcsl": run_gcsl,
    "sac_ae": run_sac_ae,
    "sac_rad": run_sac_ae,
    "sac_curl": run_sac_ae,
    "sac_vmap_seeds": run_sac_vmapped_seeds,
    "render_policy": run_render_policy,
}
