"""What the port's tests, chip_smoke.py and kernels/k2_mode_diff.py share
when they hold the fused SAC chain (ops/fused_sac.py, kernel K2) against a
reference: the pins of each mode of its products, the rule for its bf16
mode against its plain version at full width, and a way to run the loop's
fused chain in float32 mode; the bit-equality of two checkpoint trees
(`tree_diff`), which says that a resumed run is the uninterrupted one; and
`DeviceEnvAsHost` and `PixelEnvAsHost`, stand-in host envs for machines
without MuJoCo or dm_control.

Pins (`K2_PINS`, (rtol, atol) per group of the chain's output).  The
float32 mode keeps those of tests/test_fused_sac.py:91-121.  The bf16 mode
keeps them too, but for the Adam moments: mu (2e-2, 2e-5), nu (1e-2,
1e-8).  Both sides round the same float32 operands to bf16 and sum exact
products in float32, in other orders; an operand whose float32 value
differs in its last bits between the two and lies near a bf16 rounding
boundary rounds one bf16 ulp (2^-8) apart, and a gradient element that is
a sum of few such terms with cancellation moves by several times that,
relative to itself.  mu carries a gradient's relative error as it is and
nu twice; the parameters see it only as lr times Adam's normalised step,
and the metrics are batch means.  Readings, the port's plain chain against
the JAX bf16 kernel in interpret mode at hidden 32, B 32, K 3
(`PYTHONPATH=. python tests/test_torch_fused_sac.py` prints them, as the
share of each pin that the largest difference uses): at obs 348 / action
17 the bf16 mode uses 0.04
of the parameters' pin, 0.46 of mu's, 0.65 of nu's and 0.003 of the
metrics'; the float32 mode against the same kernel uses 66, 4.3 and 2.9
of the parameters', mu's and nu's (at 5 / 2: 0.0008, 0.0003, 0.0007 and 22,
1.4, 1.4).  So the pins tell the two modes apart in each of those groups;
the metrics' pin does not (the float32 mode uses 0.12 to 0.14 of it).

At full width (256 x 2, batch 512) kernel and plain version also part by
more: their float32 sums differ in order (the tensor cores' in rounding
too), so an operand near a boundary rounds apart, an activation near 0
falls on the other side of a ReLU, a whole column of a weight gradient
changes by one row's term, and Adam moves those parameters up to a full
step lr the other way.  Some elements then lie outside the pins.  How
many may is set by a control on the same state and inputs: the plain
version's float32 mode against its bf16 mode, which is what a kernel that
ignored `matmul_dtype` would read.  `bf16_gate` allows the kernel, per
group of parameters, mu and nu, at most a third of the control's count.
Readings (kernels/k2_mode_diff.py, an H100, at the hopper, ant and
humanoid shapes, K = 1, 2 and 4): see PERF.md, "K2's bf16 mode against
its plain version".
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ilswiss_tpu_torch.ops.fused_sac import METRIC_NAMES
from ilswiss_tpu_torch.runtime.loop import Noise

_F32_PINS = {"params": (2e-4, 2e-5), "log_alpha": (1e-5, 1e-6),
             "mu": (2e-4, 2e-6), "nu": (2e-3, 1e-8), "metrics": (5e-4, 5e-5)}
K2_PINS = {torch.float32: _F32_PINS,
           torch.bfloat16: {**_F32_PINS, "mu": (2e-2, 2e-5),
                            "nu": (1e-2, 1e-8)}}

# the groups `bf16_gate` counts, and the share of the control's count
# that the kernel may reach in each
GATED = ("params", "mu", "nu")
BF16_SHARE_OF_CONTROL = 1 / 3


def k2_groups(state, metrics: dict | None = None
              ) -> dict[str, list[torch.Tensor]]:
    """A SAC state's tensors by group: parameters (policy, critics,
    targets), log alpha, and the three optimizers' mu and nu; and the
    chain's `[K]` metrics when given."""
    opts = (state.policy_opt, state.qf_opt, state.alpha_opt)
    groups = {
        "params": [p.detach() for m in (state.policy, state.qf,
                                        state.target_qf)
                   for p in m.parameters()],
        "log_alpha": [state.log_alpha.detach()],
        "mu": [m for o in opts for m in o.mu],
        "nu": [v for o in opts for v in o.nu]}
    if metrics is not None:
        groups["metrics"] = [metrics[n] for n in METRIC_NAMES]
    return groups


def count_outside(got, want, rtol: float, atol: float) -> int:
    """Elements of the tensors `got` farther than atol + rtol |want| from
    `want`; a non-finite one counts as outside."""
    return sum(int((~((g - w).abs() <= atol + rtol * w.abs())).sum())
               for g, w in zip(got, want))


def bf16_gate(kernel: dict, plain: dict, control: dict
              ) -> dict[str, tuple[int, int, bool]]:
    """Per group of `GATED` (`k2_groups` of three runs from one state and
    one set of inputs: the kernel's, the plain version's in bf16 mode, and
    the plain version's in float32 mode): (the kernel's count outside the
    bf16 pins of the plain version, the control's count, whether the first
    is at most `BF16_SHARE_OF_CONTROL` of the second)."""
    out = {}
    for g in GATED:
        pin = K2_PINS[torch.bfloat16][g]
        n = count_outside(kernel[g], plain[g], *pin)
        c = count_outside(control[g], plain[g], *pin)
        out[g] = (n, c, n <= BF16_SHARE_OF_CONTROL * c)
    return out


@contextlib.contextmanager
def float32_chain():
    """`SAC.train_chain` takes the chain's float32 mode inside the block,
    for comparisons with a float32 learner (the eager steps, the JAX
    loop)."""
    from ilswiss_tpu_torch.algorithms import sac as sac_module
    chain = sac_module.fused_sac_chain
    sac_module.fused_sac_chain = functools.partial(
        chain, matmul_dtype=torch.float32)
    try:
        yield
    finally:
        sac_module.fused_sac_chain = chain


def tree_diff(x, y, where: str = "") -> list[str]:
    """The places where trees x and y (as `runtime.checkpoint.to_tree`
    makes them) are not bit-equal: a tensor of another dtype or value, a
    dict with other keys, a list of another length, a scalar that
    differs, or a leaf of another type."""
    if type(x) is not type(y):
        return [where]
    if isinstance(x, torch.Tensor):
        return [] if x.dtype == y.dtype and torch.equal(x, y) else [where]
    if isinstance(x, dict):
        if list(x) != list(y):
            return [where]
        return [d for k in x for d in tree_diff(x[k], y[k], f"{where}.{k}")]
    if isinstance(x, list):
        if len(x) != len(y):
            return [where]
        return [d for i, (p, q) in enumerate(zip(x, y))
                for d in tree_diff(p, q, f"{where}[{i}]")]
    return [] if x == y else [where]


class DeviceEnvAsHost:
    """One of the port's own device envs, built on the CPU, behind the
    host vector envs' numpy contract (envs/host_mujoco.py): `reset(seed)`
    and `step(actions) -> (obs_prev, true_next, reward, terminal, done,
    obs_after)` on numpy arrays; a goal env (reach2d) also gives
    `goal_size`, `compute_reward` and a seventh output, the success flag
    (within `distance_threshold` of the goal), as `HostGoalVectorEnv`.
    It lets the host loops' device half run where gymnasium and MuJoCo do
    not (chip_smoke.py's phase 19, tests).  It is test support: no env
    registry names it.  Its draws come from `Noise(seed, "cpu")`."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 max_episode_steps: int | None = None,
                 env_kwargs: dict | None = None, **_):
        from ilswiss_tpu_torch.envs import make_vec

        kw = dict(env_kwargs or {})
        if max_episode_steps is not None:
            kw["max_episode_steps"] = max_episode_steps
        self.vec = make_vec(env_name, num_envs, device="cpu", **kw)
        env = self.vec.env
        self.name = env_name
        self.num_envs = num_envs
        self.observation_size = env.observation_size
        self.action_size = env.action_size
        self.discrete = False
        self.max_episode_steps = env.max_episode_steps
        self.goal = hasattr(env, "goal_size")
        if self.goal:
            self.goal_size = env.goal_size
            self.compute_reward = env.compute_reward
        self._noise = Noise(seed, "cpu")
        self._state = None

    @staticmethod
    def _np(obs):
        if isinstance(obs, dict):
            return {k: v.numpy().copy() for k, v in obs.items()}
        return obs.numpy().copy()

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._noise = Noise(seed, "cpu")
        self._state = self.vec.reset(
            self._noise.reset(self.vec.env, self.num_envs))
        return self._np(self._state.obs)

    def step(self, normalized_actions):
        obs_prev = self._np(self._state.obs)
        self._state, tr = self.vec.step(
            self._state, torch.as_tensor(np.asarray(normalized_actions,
                                                    np.float32)),
            self._noise.reset(self.vec.env, self.num_envs))
        out = (obs_prev, self._np(tr.next_obs), tr.reward.numpy().copy(),
               tr.terminal.numpy().copy(), tr.done.numpy().copy(),
               self._np(self._state.obs))
        if not self.goal:
            return out
        env = self.vec.env
        success = env.compute_distance(tr.next_obs["achieved_goal"],
                                       tr.next_obs["desired_goal"]) \
            < env.distance_threshold
        return out + (success.numpy().astype(np.float32),)

    def close(self) -> None:
        pass


class PixelEnvAsHost(DeviceEnvAsHost):
    """A stand-in for `envs/host_dmc.py::DMCVectorEnv` where dm_control
    does not render (chip_smoke.py's phase 19, tests): the port's
    pendulum_pixels env on the CPU at `height` px behind the same numpy
    contract and uint8 frames, each of its `frame_stack` gray frames
    repeated to three channels, so that an observation is [height, height,
    3 * frame_stack] uint8 (newest frame last), round(255 x) of the
    analytic frames.  It takes DMCVectorEnv's arguments (the domain, the
    task and the rest are ignored); episodes end by the time limit only
    (`max_episode_steps`, default 1000, DMC's), terminal always False.  It
    is test support: no registry or launcher names it."""

    obs_dtype = np.uint8

    def __init__(self, num_envs: int, seed: int = 0, height: int = 84,
                 width: int | None = None, frame_stack: int = 3,
                 max_episode_steps: int | None = None, **_):
        super().__init__(
            "pendulum_pixels", num_envs, seed=seed,
            max_episode_steps=max_episode_steps or 1000,
            env_kwargs={"image_size": height, "frame_stack": frame_stack})
        self.name = "dmc-standin-pendulum_pixels"
        self.observation_size = (height, height, 3 * frame_stack)

    @staticmethod
    def _np(obs):
        frames = torch.round(obs * 255.0).to(torch.uint8)
        return torch.repeat_interleave(frames, 3, dim=-1).numpy().copy()
