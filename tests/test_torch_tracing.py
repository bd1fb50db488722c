"""The port's spans (utils/profiling.py::span) on the CPU: off while no
profiler records, one range a layer boundary of the fused off-policy loop
while one does, and `SPANS` the one list of their names.  Small hopper
and two-env ant loops; no JAX."""

import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop
from ilswiss_tpu_torch.utils import profiling

PACKAGE = Path(profiling.__file__).resolve().parents[1]

# span -> the span it opens inside, for one fused SAC training iteration
NESTING = {
    "loop.iter": None,
    "loop.collect": "loop.iter",
    "acting.act": "loop.collect",
    "env.step": "loop.collect",
    "env.physics": "env.step",
    "env.reset": "env.step",
    "env.observe": "env.physics",
    "replay.add": "loop.collect",
    "learner.chain": "loop.iter",
    "learner.draws": "learner.chain",
    "replay.gather": "learner.chain",
    "learner.launch": "learner.chain",
}
GENERAL = ("physics_general.linearize", "physics_general.smooth",
           "physics_general.rows", "physics_general.solve",
           "physics_general.integrate")


def _loop(env: str, fused: bool = True) -> OffPolicyLoop:
    vec = make_vec(env, 2, device="cpu", solver_iters=1)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=16, num_hidden_layers=2, use_fused_act=True,
              use_fused_chain=fused, device="cpu")
    return OffPolicyLoop(vec, sac, OffPolicyConfig(
        batch_size=8, replay_capacity=64, grad_steps_per_iter=2,
        min_steps_before_training=2))


def _spans_of_one_iter(loop: OffPolicyLoop) -> list:
    """(name, name of the innermost span around it) of every span one
    training iteration opens under the profiler, nested by their times."""
    runner = loop.warmup(loop.init(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loop._train_iter(runner)
    spans = sorted(
        ((e.start_ns(), -e.duration_ns(), e.name())
         for e in prof.profiler.kineto_results.events()
         if e.name() in profiling.SPANS))
    out, open_ = [], []          # open_: (end, name) of the enclosing spans
    for start, neg_dur, name in spans:
        while open_ and open_[-1][0] <= start:
            open_.pop()
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((start - neg_dur, name))
    return out


def test_no_profiler_no_range(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"a profiler range {name!r} was entered")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    loop = _loop("hopper")
    runner, metrics = loop._train_iter(loop.warmup(loop.init(0)))
    assert runner.total_env_steps == 4 and len(metrics) == 8


@pytest.mark.parametrize("env", ["hopper", "ant"])
def test_one_iteration_opens_each_span_once_nested(env):
    loop = _loop(env)
    spans = _spans_of_one_iter(loop)
    counts = Counter(name for name, _ in spans)
    for name, parent in NESTING.items():
        assert counts[name] == 1, name
        assert (name, parent) in spans, (name, parent)
    model = loop.vec_env.env.model
    if env == "hopper":
        assert counts["physics_planar.step"] == 1
        assert ("physics_planar.step", "env.physics") in spans
        assert not any(n in counts for n in GENERAL)
    else:
        forwards = model.frame_skip * (1 if model.integrator == "euler"
                                       else 4)
        for name in GENERAL:
            assert counts[name] == forwards, name
            assert {p for n, p in spans if n == name} == {"env.physics"}
        assert "physics_planar.step" not in counts
    # the eager K-step path (the other off-policy algorithms) is not taken
    assert "learner.steps" not in counts


def test_eager_steps_span():
    counts = Counter(n for n, _ in _spans_of_one_iter(_loop("hopper", False)))
    assert counts["learner.steps"] == 1 and "learner.chain" not in counts
    assert counts["replay.gather"] == 2     # one batch a gradient step


def test_spans_names_every_span_the_program_opens():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        if path.name == "profiling.py":
            continue
        text = path.read_text()
        # every span is opened through `span`, under a literal name
        assert "record_function" not in text, path
        assert "RecordFunction" not in text, path
        assert not re.findall(r"\bspan\((?!\"[^\"]+\"\))", text), path
        opened |= set(re.findall(r"\bspan\(\"([^\"]+)\"\)", text))
    assert opened == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))
