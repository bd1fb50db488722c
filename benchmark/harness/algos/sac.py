"""SAC through `ilswiss_tpu_torch`'s off-policy loop: the system under
test, its set-up, and the comparison that decides `correct`.

The system is `runtime/loop.py::OffPolicyLoop` with SAC as
`chip_smoke.py`'s main path builds it (`use_fused_act`: acting through
kernel K3; `use_fused_chain`: the K gradient steps of an iteration in one
launch of kernel K2, bf16 products), sized by the cell's configuration and
traffic files.  A window's iteration is the loop's own `_train_iter` (act,
env step, ring write, K gradient steps).

Set-up: the weights and the draws made on the device from the seed, the
ring, the warmup of uniform random actions, the ring filled to the traffic
file's `ring_rows` with copies of the warmup's rows (through the program's
own `replay_add_masked`), and one training iteration through the window's
own call, which the comparison judges.  It captures what the reference
needs (`Captured`): the draws the benchmark handed the program, its
weights, and what the program produced in the first warmup iteration and
in that training iteration: the ring rows it wrote, the K batches its
gather read, the learner's [K, 8] metrics, its parameters, targets, log
alpha and Adam moments after the K steps.  The reference starts the
warmup from its own reset of the draws.  It starts the training iteration
from the program's env state and ring at that point (the warmup steps
between are the program's; their first iteration is checked by itself),
and from the benchmark's own weights.  The env reference runs in the
configuration's physics precision.

`reference_outputs` computes what the program should have produced;
`numbers` turns program and reference outputs into the compared numbers:

  ring_gap        exact: the obs and warmup actions the ring holds are the
                  ones the env showed and the draws gave, the cursor moved
                  by one batch a write and by the fill
  act_gap         largest |action - reference action| (acting)
  env_gap         largest |x - ref| / (1 + |ref|) over the reset
                  observations and the two control steps' next
                  observations and rewards (env physics)
  terminal_flips  exact: envs whose termination differs from the
                  reference's, where the reference's state lies more than
                  1e-3 from every threshold of the rule
  loss_gap        largest |loss - ref| / max(|ref|, 1e-3) over the first
                  three gradient steps' qf1, qf2 and policy losses (the
                  ring's gather and the learner)
  update_gap      worst leaf: |norm(change) - norm(ref change)| over the
                  larger of the reference's norm of that leaf's change
                  and the median leaf's, after the iteration's K steps
  moment_gap      the same of the norm of Adam's first moment

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's are left out of the last two (a target leaf follows its
critic leaf's gradient).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

import torch

from benchmark.harness import weights
from benchmark.harness.check import (judge, leaf_gap, rel_gap, round_fp8,
                                     tf32_product)
from benchmark.harness.draws import Draws, take
from benchmark.reference import envs
from benchmark.reference import sac as ref_sac

NUMBERS = ("ring_gap", "act_gap", "env_gap", "terminal_flips", "loss_gap",
           "update_gap", "moment_gap")
LOSSES = ("qf1_loss", "qf2_loss", "policy_loss")
LOSS_STEPS = 3
MARGIN = 1e-3
FILL_CHUNK = 1 << 16     # rows a call of the ring's fill writes, at most
GATHER_CHUNK = 64        # gradient steps' batches moved to the host at once


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one stream of the run's draws."""
    return (seed * 1_000_003 + stream) % (2 ** 63)


def build(config: dict, traffic: dict, device) -> SimpleNamespace:
    """The program, sized by the configuration and the traffic."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop

    if config["precision"]["learner_products"] != "bfloat16":
        raise ValueError("algos/sac.py drives K2 with bf16 products; "
                         "another precision is an algorithm file of its own")
    vec = make_vec(config["env"], traffic["num_envs"], device=device)
    hp = config["sac"]
    sac = SAC(vec.env.observation_size, vec.env.action_size,
              SACConfig(**{k: v for k, v in hp.items()
                           if k in SACConfig.__dataclass_fields__}),
              net_size=config["net_size"],
              num_hidden_layers=config["num_hidden_layers"],
              use_fused_act=True, use_fused_chain=True, device=device)
    loop = OffPolicyLoop(vec, sac, OffPolicyConfig(
        batch_size=traffic["batch_size"],
        replay_capacity=config["replay_capacity"],
        grad_steps_per_iter=traffic["grad_steps_per_iter"],
        min_steps_before_training=traffic["warmup_steps"]))
    shapes = SimpleNamespace(
        obs=vec.env.observation_size, act=vec.env.action_size,
        hidden=config["net_size"], layers=config["num_hidden_layers"],
        batch=traffic["batch_size"], K=traffic["grad_steps_per_iter"],
        envs=traffic["num_envs"])
    return SimpleNamespace(
        loop=loop, sac=sac, shapes=shapes, step=loop._train_iter,
        env_steps_per_iter=traffic["num_envs"],
        spans=[(sac, "act", "bench.act"), (vec, "step", "bench.env"),
               (loop, "learn", "bench.learn")],
        planar=envs.load(config["env"], "cpu").planar)


@dataclass
class Captured:
    layers: int
    hp: dict
    target_entropy: float
    policy0: dict
    critics0: dict
    # the reset and the first warmup iteration
    reset_noise: tuple
    reset_obs: torch.Tensor
    warm_action: torch.Tensor
    warm_rows: dict
    # the first training iteration
    env_before: tuple            # (q, qd, warm) of the program
    obs_before: torch.Tensor
    act_eps: torch.Tensor
    rows: dict
    batches: dict                # name -> [K, B, ...] on the host
    eps_next: torch.Tensor       # [K, B, A]
    eps_new: torch.Tensor
    metrics: torch.Tensor        # [K, 8] of the program
    after: dict                  # leaf -> the program's tensor after
    moments: dict                # leaf -> the program's Adam first moment
    cursor_ok: bool


def _rows(replay, start: int, n: int) -> dict:
    return {k: v[start:start + n].clone() for k, v in replay.data.items()}


def fill_ring(replay, rows: int) -> None:
    """Copies of the ring's rows appended through the program's
    `replay_add_masked` until it holds `rows`."""
    from ilswiss_tpu_torch.data.replay import replay_add_masked
    n0 = replay.size
    while replay.size < rows:
        n = min(n0, FILL_CHUNK, rows - replay.size)
        replay_add_masked(
            replay, {k: v[:n] for k, v in replay.data.items()},
            torch.ones(n, dtype=torch.bool, device=replay.ep_id.device))


def gathered(ring: dict, u: torch.Tensor, size: int) -> dict:
    """The reference's gather of each gradient step's batch, on the host:
    row min(int(u * size), size - 1) for each uniform of `u` [K, B]."""
    idx = torch.clamp_max((u * float(size)).long(), size - 1)
    return {k: torch.cat([v[idx[i:i + GATHER_CHUNK]].cpu()
                          for i in range(0, idx.shape[0], GATHER_CHUNK)])
            for k, v in ring.items()}


def set_up(system, config: dict, traffic: dict, seed: int, device
           ) -> tuple:
    """(runner, Captured): the warmup, the ring's fill and the first
    training iteration, with what the comparison needs."""
    s, loop, sac = system.shapes, system.loop, system.sac
    draws = Draws(seed_of(seed, 1), device)
    policy0, critics0 = weights.make(seed_of(seed, 2), s.obs, s.act,
                                     s.hidden, s.layers, device)
    draws.record = record = []
    runner = loop.init(seed, noise=draws)
    weights.load_into(runner.algo_state, policy0, critics0, s.layers)
    reset_obs = runner.env_state.obs.clone()
    runner = loop.warmup(runner)
    warm_rows = _rows(runner.replay, 0, s.envs)
    resets = take(record, "reset")
    warm_action = take(record, "warmup_action")[0]
    replay = runner.replay
    warm_ok = replay.ptr == replay.size == (len(resets) - 1) * s.envs
    fill = max(replay.size, traffic["ring_rows"] // s.envs * s.envs)
    fill_ring(replay, fill)

    # the first training iteration, through the window's own call
    env_before = tuple(t.clone() for t in runner.env_state.internal)
    obs_before = runner.env_state.obs.clone()
    ptr0, size0 = replay.ptr, replay.size
    draws.record = record = []
    kept = {}
    chain = sac.train_chain

    def keep_metrics(*args, **kwargs):
        state, metrics = chain(*args, **kwargs)
        kept["metrics"] = torch.stack([metrics[n] for n in ref_sac.METRICS],
                                      1)
        return state, metrics

    sac.train_chain = keep_metrics
    try:
        runner, _ = loop._train_iter(runner)
    finally:
        del sac.train_chain
    draws.record = None
    replay = runner.replay
    state = runner.algo_state
    p, c, t = weights.read_from(state, s.layers)
    after = {("p", k): v for k, v in p.items()}
    after.update({("c", k): v for k, v in c.items()})
    after.update({("t", k): v for k, v in t.items()})
    after[("a", "log_alpha")] = state.log_alpha.detach().clone()
    trains = take(record, "train")
    hp = dict(config["sac"])
    target_entropy = (hp["target_entropy"] if hp.get("target_entropy")
                      is not None else -s.act / 2.0)
    cap = Captured(
        layers=s.layers, hp=hp, target_entropy=target_entropy,
        policy0=policy0, critics0=critics0,
        reset_noise=resets[0], reset_obs=reset_obs,
        warm_action=warm_action, warm_rows=warm_rows,
        env_before=env_before, obs_before=obs_before,
        act_eps=take(record, "act")[0],
        rows=_rows(replay, ptr0, s.envs),
        batches=gathered(replay.data, torch.stack(take(record, "replay")),
                         replay.size),
        eps_next=torch.stack([e[0] for e in trains]),
        eps_new=torch.stack([e[1] for e in trains]),
        metrics=kept["metrics"].clone(),
        after=after,
        moments=weights.moments_from(state, s.layers),
        cursor_ok=(warm_ok and ptr0 == size0 == fill
                   and replay.ptr == ptr0 + s.envs
                   and replay.size == size0 + s.envs))
    return runner, cap


def _dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["precision"]["physics"])


def reference_outputs(cap: Captured, env, *, act_product=torch.matmul,
                      rounding=None, half_batch: bool = False,
                      physics: dict | None = None) -> dict:
    """What the program should have produced.  The control passes a lower
    precision: `act_product` for the acting forward, `rounding` for the
    learner's products, an `env` with TF32 on; a fault `half_batch`.
    `physics` reuses the env outputs of an earlier call."""
    dev = cap.obs_before.device
    to = dict(device=dev, dtype=torch.float64)
    p64 = {k: v.to(**to) for k, v in cap.policy0.items()}
    if physics is None:
        q0 = env.qpos0 + env._t(cap.reset_noise[0])
        physics = {
            "reset_obs": env.reset_obs(*cap.reset_noise),
            "warm": env.step(q0, env._t(cap.reset_noise[1]),
                             q0.new_zeros((q0.shape[0], env.model.nrow)),
                             cap.warm_action),
            "check": env.step(*cap.env_before, cap.rows["action"])}
    out = dict(physics)
    if act_product is torch.matmul:
        action = ref_sac.act(p64, cap.obs_before.to(**to),
                             cap.act_eps.to(**to), cap.layers)
    else:
        action = ref_sac.act(cap.policy0, cap.obs_before, cap.act_eps,
                             cap.layers, act_product)
    out["action"] = action

    learner = ref_sac.Learner(cap.policy0, cap.critics0, cap.hp,
                              cap.target_entropy, cap.layers, rounding)
    rows = []
    for k in range(cap.eps_next.shape[0]):
        b = {name: v[k].to(dev) for name, v in cap.batches.items()}
        n = b["reward"].shape[0] // 2 if half_batch else b["reward"].shape[0]
        rows.append(learner.step(b["obs"][:n], b["action"][:n],
                                 b["reward"][:n], b["terminal"][:n],
                                 b["next_obs"][:n], cap.eps_next[k][:n],
                                 cap.eps_new[k][:n]))
    out["metrics"] = torch.stack(rows)
    out["after"] = {k: v.clone() for k, v in learner.leaves().items()}
    out["moments"] = {k: v.clone() for k, v in learner.mu.items()}
    out["first_grads"] = learner.first_grads
    return out


def program_outputs(cap: Captured) -> dict:
    return {
        "reset_obs": cap.reset_obs,
        "warm": cap.warm_rows,
        "action": cap.rows["action"],
        "check": cap.rows,
        "metrics": cap.metrics,
        "after": cap.after,
        "moments": cap.moments,
    }


def _flips(prog_terminal, ref: dict) -> int:
    differ = prog_terminal.bool().cpu() != ref["terminal"].bool().cpu()
    return int((differ & (ref["margin"].cpu() > MARGIN)).sum())


def kept_leaves(first_grads: dict) -> Callable:
    """The rule on the reference's first gradient: a leaf (a target leaf by
    its critic's) whose norm is under a thousandth of the median leaf's is
    moved by rounding alone, and is left out."""
    norms = {k: float(g.double().norm()) for k, g in first_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]

    def keep(leaf) -> bool:
        group, name = leaf
        return norms[("c" if group == "t" else group, name)] >= 1e-3 * med
    return keep


def numbers(cap: Captured, prog: dict, ref: dict) -> dict:
    warm, check = prog["warm"], prog["check"]
    ring_gap = max(
        float((warm["obs"] - cap.reset_obs).abs().max()),
        float((warm["action"] - cap.warm_action).abs().max()),
        float((check["obs"] - cap.obs_before).abs().max()),
        0.0 if cap.cursor_ok else float("inf"))
    env_gap = max(
        rel_gap(prog["reset_obs"], ref["reset_obs"]),
        rel_gap(warm["next_obs"], ref["warm"]["next_obs"]),
        rel_gap(warm["reward"], ref["warm"]["reward"]),
        rel_gap(check["next_obs"], ref["check"]["next_obs"]),
        rel_gap(check["reward"], ref["check"]["reward"]))
    cols = [ref_sac.METRICS.index(n) for n in LOSSES]
    p_l = prog["metrics"][:LOSS_STEPS, cols].double()
    r_l = ref["metrics"][:LOSS_STEPS, cols].double()
    loss_gap = float(((p_l - r_l).abs()
                      / torch.clamp_min(r_l.abs(), 1e-3)).max())
    keep = kept_leaves(ref["first_grads"])
    base = {("p", k): v for k, v in cap.policy0.items()}
    base.update({("c", k): v for k, v in cap.critics0.items()})
    base.update({("t", k): v for k, v in cap.critics0.items()})
    base[("a", "log_alpha")] = torch.zeros((), device=cap.eps_next.device)
    return {
        "ring_gap": ring_gap,
        "act_gap": float((prog["action"].double()
                          - ref["action"].double()).abs().max()),
        "env_gap": env_gap,
        "terminal_flips": float(_flips(warm["terminal"], ref["warm"])
                                + _flips(check["terminal"], ref["check"])),
        "loss_gap": loss_gap,
        "update_gap": leaf_gap(prog["after"], ref["after"], base, keep),
        "moment_gap": leaf_gap(prog["moments"], ref["moments"], None, keep),
    }


def compare(cap: Captured, config: dict, limits: dict, device
            ) -> tuple[bool, dict]:
    """The comparison, once the program's state is freed."""
    env = envs.load(config["env"], device, _dtype(config))
    ref = reference_outputs(cap, env)
    return judge(numbers(cap, program_outputs(cap), ref), limits)


def as_program(cap: Captured, out: dict) -> dict:
    """Reference outputs (of a control, or with a fault planted) in the
    program's place."""
    def rows(step: dict, obs, action) -> dict:
        return {"obs": obs, "action": action, "next_obs": step["next_obs"],
                "reward": step["reward"], "terminal": step["terminal"]}
    return {
        "reset_obs": out["reset_obs"],
        "warm": rows(out["warm"], cap.warm_rows["obs"],
                     cap.warm_rows["action"]),
        "action": out["action"],
        "check": rows(out["check"], cap.obs_before, out["action"]),
        "metrics": out["metrics"],
        "after": out["after"],
        "moments": out["moments"],
    }


def control_outputs(cap: Captured, config: dict, device) -> dict:
    """The control: the reference in the program's place, one precision
    below what the configuration states: TF32 for the float32 acting and
    physics (TF32 is off in the program), fp8 e4m3 with a scale per tensor
    for the learner's bf16 products."""
    if _dtype(config) != torch.float32:
        raise ValueError("the control is defined for float32 physics")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        env = envs.load(config["env"], device, torch.float32)
        return reference_outputs(cap, env, act_product=tf32_product,
                                 rounding=round_fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fault_outputs(cap: Captured, ref: dict, env) -> dict:
    """The faults a training cell can have, planted in the reference put
    in the program's place: each as program outputs."""
    def swapped(x):
        y = x.clone()
        y[[0, 1]] = x[[1, 0]]
        return y
    out = {}
    base = as_program(cap, ref)
    unchanged = dict(base)
    unchanged["after"] = {k: (cap.policy0 if k[0] == "p" else cap.critics0)[
        k[1]] if k[0] != "a" else torch.zeros((), device=cap.eps_next.device)
        for k in ref["after"]}
    unchanged["moments"] = {k: torch.zeros_like(v)
                            for k, v in ref["moments"].items()}
    out["unchanged_state"] = unchanged
    physics = {k: ref[k] for k in ("reset_obs", "warm", "check")}
    out["half_batch"] = as_program(cap, reference_outputs(
        cap, env, half_batch=True, physics=physics))
    act = dict(base)
    act["action"] = swapped(ref["action"])
    out["swapped_actions"] = act
    ans = dict(base)
    ans["check"] = dict(base["check"], next_obs=swapped(
        ref["check"]["next_obs"]), reward=swapped(ref["check"]["reward"]))
    out["swapped_env_answers"] = ans
    return out


def readings(cap: Captured, config: dict, device, controls: bool) -> dict:
    """The readings the limits are set from: the program's numbers (the
    lower), and with `controls` the control's and each fault's (the
    upper)."""
    env = envs.load(config["env"], device, _dtype(config))
    ref = reference_outputs(cap, env)
    out = {"program": numbers(cap, program_outputs(cap), ref)}
    if controls:
        out["control"] = numbers(cap, as_program(
            cap, control_outputs(cap, config, device)), ref)
        out["faults"] = {name: numbers(cap, prog, ref) for name, prog
                         in fault_outputs(cap, ref, env).items()}
    return out
