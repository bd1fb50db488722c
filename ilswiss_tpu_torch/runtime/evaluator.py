"""Deterministic-policy evaluation (counterpart:
ilswiss_tpu/runtime/evaluator.py).

N eval envs run `max_path_length` lockstep steps; per-env return and
length accumulate only while the env's first episode is still running,
so reward never leaks across an autoreset.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ilswiss_tpu_torch.envs.vector import VectorEnv


def make_evaluator(vec_env: VectorEnv, act_fn: Callable,
                   max_path_length: int) -> Callable:
    """act_fn(algo_state, obs) -> deterministic action.  Returns
    evaluate(algo_state, noise) -> stats with the reference's keys;
    `noise` supplies the reset draws (`runtime.loop.Noise`)."""

    @torch.no_grad()
    def evaluate(algo_state, noise) -> Dict[str, float]:
        env, n = vec_env.env, vec_env.num_envs
        env_state = vec_env.reset(noise.reset(env, n))
        # the step counter's device: obs may be a goal env's dict
        kw = dict(dtype=torch.float32, device=env_state.t.device)
        returns = torch.zeros(n, **kw)
        lengths = torch.zeros(n, **kw)
        running = torch.ones(n, **kw)
        for _ in range(max_path_length):
            action = act_fn(algo_state, env_state.obs)
            env_state, tr = vec_env.step(env_state, action,
                                         noise.reset(env, n))
            returns = returns + tr.reward * running
            lengths = lengths + running
            running = running * (1.0 - tr.done.to(torch.float32))
        return return_stats(returns, lengths)

    return evaluate


def return_stats(returns: torch.Tensor, lengths: torch.Tensor
                 ) -> Dict[str, float]:
    """The reference's evaluation keys from per-env returns and lengths."""
    return {
        "AverageReturn": float(returns.mean()),
        "MaxReturn": float(returns.max()),
        "MinReturn": float(returns.min()),
        # population std, as jnp.std (ddof 0)
        "StdReturn": float(returns.std(correction=0)),
        "AvgPathLength": float(lengths.mean()),
    }
