"""Off-policy actor-learner loop (counterpart: ilswiss_tpu/runtime/loop.py).

    iteration = act -> vec-env step -> replay store -> K gradient steps

The JAX package scans this inside one jitted program; here it is a Python
loop of eager PyTorch calls, with the metrics kept on the device until an
epoch ends.  K = `grad_steps_per_iter` defaults to the number of envs
(one gradient step per env step).  An algorithm with `train_call`
(AdvIRL) takes the iteration's updates itself, sampling the ring and
drawing from the runner's noise (JAX loop.py:134-149).  An algorithm with
`use_fused_chain` set takes the K steps as one `train_chain` call (kernel
K2) unless it carries a `group` (data parallelism, parallel/): K2
applies local gradients only, so under a group the K eager steps run and
average their gradients across the ranks, as the JAX loop takes its scan
path under a mesh axis (loop.py:153-159).

Every random draw of an iteration comes from one `noise` object, held by
the RunnerState as JAX holds its key.  `Noise` draws from a
`torch.Generator` on the loop's device; a test can swap in an object with
the same methods that replays the JAX package's draws.  A checkpoint
holds the generator's state (`Noise.state_dict`), so a resumed run draws
what the uninterrupted one would have drawn.  The algorithm names its
own draws: `act_noise(noise, n)` gives the extra arguments of one
stochastic `act` for n envs and `train_noise(noise, batch_size)` those of
one `train_step`, each a tuple of tensors drawn through named `Noise`
methods (SAC: `act`, then `train`; see each algorithm's docstring).  An
iteration draws in this order: the acting draws (warmup: `warmup_action`,
or `warmup_index` for a discrete env), `reset`, then per gradient step
the batch's draws (`replay`; an augmenting `sample_fn` adds its own, in
data/aug_replay.py's order) and the step's draws.

A discrete env (`env.discrete`, cartpole) gets a ring of int32 action
indices, and its warmup takes integer actions uniform in [0,
action_size) (JAX loop.py:82-89, :100-115).  An algorithm with
`note_env_steps(state, n)` (DQN, whose epsilon decays with the env steps
of training) is told the iteration's env steps at the end of each
training iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from ilswiss_tpu_torch.data.replay import (
    ReplayState, replay_add, replay_init, replay_sample,
)
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class OffPolicyConfig:
    batch_size: int = 256
    replay_capacity: int = 1_000_000
    grad_steps_per_iter: int | None = None  # default: num_envs (ratio 1.0)
    min_steps_before_training: int = 1000
    # store terminal = 0 always (the reference `no_terminal` flag)
    no_terminal: bool = False


class Noise:
    """Every draw the loop makes, from one generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _uniform(self, shape, low: float, high: float) -> torch.Tensor:
        return torch.empty(shape, device=self.device).uniform_(
            low, high, generator=self.generator)

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, device=self.device,
                           generator=self.generator)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        # a generator's state is a CPU byte tensor on every device
        self.generator.set_state(state["generator"].cpu())

    def _randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, high, shape, device=self.device,
                             generator=self.generator)

    def warmup_action(self, shape) -> torch.Tensor:
        """Uniform [-1, 1] warmup actions."""
        return self._uniform(shape, -1.0, 1.0)

    def warmup_index(self, n: int, num_actions: int) -> torch.Tensor:
        """Integer warmup actions [n], uniform in [0, num_actions)."""
        return self._randint((n,), num_actions)

    def act(self, shape) -> torch.Tensor:
        """N(0, 1) noise of the acting sample."""
        return self._normal(shape)

    def reset(self, env, n: int):
        """Reset noise for `n` envs (used where an episode ends)."""
        return env.sample_reset_noise(n, self.generator)

    def replay(self, batch_size: int) -> torch.Tensor:
        """Uniforms in [0, 1) that pick the replay rows of one batch."""
        return self._uniform((batch_size,), 0.0, 1.0)

    def train(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """(eps_next, eps_new): N(0, 1) noise of one gradient step."""
        return self._normal(shape), self._normal(shape)

    def interpolation(self, n: int) -> torch.Tensor:
        """Uniforms in [0, 1), [n, 1]: the per-row weights of a gradient
        penalty's interpolates (algorithms/adv_irl.py)."""
        return self._uniform((n, 1), 0.0, 1.0)

    def smoothing(self, shape) -> torch.Tensor:
        """N(0, 1) noise of TD3's target-policy smoothing."""
        return self._normal(shape)

    def sample(self, shape) -> torch.Tensor:
        """N(0, 1) noise of the one policy sample of a SAC-V step or of a
        BC step in MSE mode."""
        return self._normal(shape)

    def gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), as
        `jax.random.gumbel`: the noise of a categorical sample."""
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(self._uniform(shape, tiny, 1.0)))

    def flip(self, shape) -> torch.Tensor:
        """Uniforms in [0, 1) that decide where an explorer takes its
        random action (below epsilon)."""
        return self._uniform(shape, 0.0, 1.0)

    def random_index(self, shape, num_actions: int) -> torch.Tensor:
        """The random actions of epsilon-greedy, uniform in
        [0, num_actions)."""
        return self._randint(shape, num_actions)

    def random_action(self, shape) -> torch.Tensor:
        """The uniform [-1, 1) actions of the Gaussian-and-epsilon
        explorer."""
        return self._uniform(shape, -1.0, 1.0)

    def permutation(self, n: int) -> torch.Tensor:
        """A uniform random permutation of range(n), int64 [n]: the row
        order of one PPO pass (algorithms/ppo.py)."""
        return torch.randperm(n, generator=self.generator,
                              device=self.device)

    def bootstrap(self, num_nets: int, n: int) -> torch.Tensor:
        """Each ensemble net's bootstrap rows, int64 [num_nets, n] uniform
        in [0, n) (algorithms/bnn_trainer.py)."""
        return self._randint((num_nets, n), n)

    def shuffle(self, num_nets: int, n: int) -> torch.Tensor:
        """One uniform random permutation of range(n) per net, int64
        [num_nets, n]: an ensemble epoch's row order."""
        return torch.stack([self.permutation(n) for _ in range(num_nets)])

    def elite(self, n: int, num_elites: int) -> torch.Tensor:
        """Which of the elite nets each of n model branches takes, uniform
        in [0, num_elites) (algorithms/mbpo.py)."""
        return self._randint((n,), num_elites)

    def model(self, shape) -> torch.Tensor:
        """N(0, 1) noise of a model step's Gaussian sample."""
        return self._normal(shape)

    def augment_index(self, shape, low: int, high: int) -> torch.Tensor:
        """Integers uniform in [low, high): an image augmentation's
        offsets and boxes (data/augmentations.py)."""
        return torch.randint(low, high, shape, device=self.device,
                             generator=self.generator)

    def augment_uniform(self, shape) -> torch.Tensor:
        """Uniforms in [0, 1): an image augmentation's coins and factors."""
        return self._uniform(shape, 0.0, 1.0)

    def hindsight(self, batch_size: int, num_envs: int) -> tuple:
        """The draws of one hindsight batch (data/her.py): the env of each
        row, int64 [batch_size] uniform in [0, num_envs), then uniforms
        in [0, 1) [batch_size] that pick its episode, its step and its
        future step."""
        return (self._randint((batch_size,), num_envs),
                *(self._uniform((batch_size,), 0.0, 1.0) for _ in range(3)))


@dataclass
class RunnerState:
    noise: Any
    env_state: EnvState          # batched [num_envs]
    replay: ReplayState
    algo_state: Any
    total_env_steps: int


def sample_uniform(replay: ReplayState, noise, batch_size: int
                   ) -> Dict[str, torch.Tensor]:
    """The loop's default batch: `replay_sample` of `noise.replay` rows."""
    return replay_sample(replay, noise.replay(batch_size))


class OffPolicyLoop:
    """Off-policy runtime for an algorithm with `init(seed)`,
    `act(state, obs, *draws)` with `act_noise(noise, n)`, and either
    `train_call(state, replay, noise)` (AdvIRL: it takes an iteration's
    updates and draws itself), or `train_step(state, batch, *draws)` with
    `train_noise(noise, batch_size)` and, where `use_fused_chain` is set,
    `train_chain(state, replay, noise, batch_size, num_steps)` (SAC).
    SAC, SAC-V, TD3, DDPG, discrete SAC, DQN, AdvIRL and SAC-AE fit.

    `sample_fn(replay, noise, batch_size)` makes each gradient step's batch
    (JAX loop.py:64-71; RAD / CURL plug data/aug_replay.py's
    `augmented_sample` in here).  The K steps go through `train_chain`
    only with the default `sample_uniform`, as the JAX gate
    `sample_fn is replay_sample` (:153-159) has it: the fused chain samples
    the ring itself."""

    def __init__(self, vec_env: VectorEnv, algo, config: OffPolicyConfig,
                 sample_fn: Callable | None = None):
        self.vec_env = vec_env
        self.algo = algo
        self.config = config
        self.sample_fn = sample_fn or sample_uniform
        self.device = vec_env.env.device
        self.grad_steps_per_iter = (
            config.grad_steps_per_iter
            if config.grad_steps_per_iter is not None
            else vec_env.num_envs)

    def init(self, seed: int, noise=None) -> RunnerState:
        """Fresh runner: algorithm state from `seed`, env reset and every
        later draw from `noise` (default `Noise(seed + 1, device)`)."""
        noise = Noise(seed + 1, self.device) if noise is None else noise
        env = self.vec_env.env
        replay = replay_init(self.config.replay_capacity,
                             env.observation_size, env.action_size,
                             write_batch=self.vec_env.num_envs,
                             device=self.device, discrete=env.discrete)
        return RunnerState(
            noise=noise,
            env_state=self.vec_env.reset(
                noise.reset(env, self.vec_env.num_envs)),
            replay=replay,
            algo_state=self.algo.init(seed),
            total_env_steps=0,
        )

    # ------------------------------------------------------------------
    def _collect_iter(self, runner: RunnerState, random_actions: bool
                      ) -> RunnerState:
        with span("loop.collect"):
            noise, n, env = (runner.noise, self.vec_env.num_envs,
                             self.vec_env.env)
            if random_actions and env.discrete:
                action = noise.warmup_index(n, env.action_size)
            elif random_actions:
                action = noise.warmup_action((n, env.action_size))
            else:
                with span("acting.act"):
                    action = self.algo.act(runner.algo_state,
                                           runner.env_state.obs,
                                           *self.algo.act_noise(noise, n))
            env_state, tr = self.vec_env.step(
                runner.env_state, action, noise.reset(self.vec_env.env, n))
            if self.config.no_terminal:
                tr.terminal = torch.zeros_like(tr.terminal)
            runner.replay = replay_add(runner.replay, tr)
            runner.env_state = env_state
            runner.total_env_steps += n
            return runner

    def _train_iter(self, runner: RunnerState
                    ) -> tuple[RunnerState, Dict[str, torch.Tensor]]:
        with span("loop.iter"):
            runner = self._collect_iter(runner, random_actions=False)
            return self.learn(runner)

    def learn(self, runner: RunnerState
              ) -> tuple[RunnerState, Dict[str, torch.Tensor]]:
        """The learner's half of a training iteration, after its
        collection: `train_call`, one `train_chain`, or K eager steps;
        returns (runner, the iteration's metric means on the device)."""
        cfg = self.config
        if hasattr(self.algo, "train_call"):
            # an algorithm that owns its update schedule (AdvIRL's nested
            # discriminator / policy loop) samples the ring itself
            runner.algo_state, metrics = self.algo.train_call(
                runner.algo_state, runner.replay, runner.noise)
            return runner, metrics
        if (getattr(self.algo, "use_fused_chain", False)
                and self.sample_fn is sample_uniform
                and getattr(self.algo, "group", None) is None):
            runner.algo_state, metrics = self.algo.train_chain(
                runner.algo_state, runner.replay, runner.noise,
                cfg.batch_size, self.grad_steps_per_iter)
            return runner, {k: v.mean() for k, v in metrics.items()}
        sums: Dict[str, torch.Tensor] = {}
        state = runner.algo_state
        with span("learner.steps"):
            for _ in range(self.grad_steps_per_iter):
                batch = self.sample_fn(runner.replay, runner.noise,
                                       cfg.batch_size)
                state, metrics = self.algo.train_step(
                    state, batch,
                    *self.algo.train_noise(runner.noise, cfg.batch_size))
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
        if hasattr(self.algo, "note_env_steps"):
            self.algo.note_env_steps(state, self.vec_env.num_envs)
        runner.algo_state = state
        return runner, {k: v / self.grad_steps_per_iter
                        for k, v in sums.items()}

    # ------------------------------------------------------------------
    def warmup(self, runner: RunnerState) -> RunnerState:
        """max(1, min_steps_before_training // num_envs) iterations of
        uniform random actions."""
        iters = max(1, self.config.min_steps_before_training
                    // self.vec_env.num_envs)
        for _ in range(iters):
            runner = self._collect_iter(runner, random_actions=True)
        return runner

    def epoch_metrics(self, runner: RunnerState, steps_per_epoch: int
                      ) -> tuple[RunnerState, Dict[str, torch.Tensor]]:
        """max(1, steps_per_epoch // num_envs) training iterations; returns
        the per-epoch means of the metrics, kept on the device."""
        iters = max(1, steps_per_epoch // self.vec_env.num_envs)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(iters):
            runner, metrics = self._train_iter(runner)
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        return runner, {k: v / iters for k, v in sums.items()}

    def train_epoch(self, runner: RunnerState, steps_per_epoch: int
                    ) -> tuple[RunnerState, Dict[str, float]]:
        """`epoch_metrics` with the means as floats."""
        runner, metrics = self.epoch_metrics(runner, steps_per_epoch)
        return runner, {k: float(v) for k, v in metrics.items()}
