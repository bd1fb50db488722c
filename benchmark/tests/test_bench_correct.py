"""`correct` at a tiny size on the CPU: a sound run passes; each fault a
training cell can have, planted in the program underneath a run, fails
it; so does the control, the reference one precision below the
configuration's in the program's place.  (One chip: no exchange between
chips to leave out.)"""

import time

import pytest
import torch

from benchmark.harness import algos
from benchmark.harness import cell as cell_run
from benchmark.harness.check import judge
from benchmark.harness.spec import reader
from benchmark.reference import envs
from benchmark.tests.conftest import tiny_cell

SEED = 2 ** 31 + 77


def _run(cell):
    return cell_run.run(cell, SEED, 0.2, False, "cpu", time.time(), reader)


def test_sound_run_is_correct():
    out = _run(tiny_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def _unchanged_state(chain):
    def fault(sac, state, *args, **kwargs):
        keep = [t.detach().clone() for t in _state_tensors(state)]
        out = chain(sac, state, *args, **kwargs)
        with torch.no_grad():
            for t, k in zip(_state_tensors(state), keep):
                t.copy_(k)
        return out
    return fault


def _state_tensors(state):
    out = list(state.policy.parameters()) + list(state.qf.parameters()) \
        + list(state.target_qf.parameters()) + [state.log_alpha]
    for opt in (state.policy_opt, state.qf_opt, state.alpha_opt):
        out += opt.mu + opt.nu
    return out


def _half_batch(chain):
    def fault(sac, state, batches, eps_next, eps_new, *args, **kwargs):
        h = eps_next.shape[1] // 2
        return chain(sac, state, {k: v[:, :h].contiguous()
                                  for k, v in batches.items()},
                     eps_next[:, :h].contiguous(),
                     eps_new[:, :h].contiguous(), *args, **kwargs)
    return fault


def _altered_action(act):
    def fault(self, *args, **kwargs):
        a = act(self, *args, **kwargs)
        return a.flip(0)
    return fault


def _altered_answer(step):
    def fault(self, *args, **kwargs):
        state, tr = step(self, *args, **kwargs)
        tr.reward = tr.reward + 1.0
        return state, tr
    return fault


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_action", "altered_answer"])
def test_fault_is_not_correct(monkeypatch, fault):
    import ilswiss_tpu_torch.algorithms.sac as sac_mod
    from ilswiss_tpu_torch.envs.vector import VectorEnv
    if fault == "unchanged_state":
        monkeypatch.setattr(sac_mod, "fused_sac_chain",
                            _unchanged_state(sac_mod.fused_sac_chain))
    elif fault == "half_batch":
        monkeypatch.setattr(sac_mod, "fused_sac_chain",
                            _half_batch(sac_mod.fused_sac_chain))
    elif fault == "altered_action":
        monkeypatch.setattr(sac_mod.SAC, "act",
                            _altered_action(sac_mod.SAC.act))
    else:
        monkeypatch.setattr(VectorEnv, "step", _altered_answer(VectorEnv.step))
    out = _run(tiny_cell())
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    # at the committed limits, the control's numbers fail
    cell = tiny_cell()
    sac = algos.load("sac")
    system = sac.build(cell.config, cell.traffic, "cpu")
    _, cap = sac.set_up(system, cell.config, cell.traffic, SEED, "cpu")
    ref = sac.reference_outputs(cap, envs.load("hopper", "cpu"))
    sound = sac.numbers(cap, sac.program_outputs(cap), ref)
    control = sac.numbers(cap, sac.as_program(
        cap, sac.control_outputs(cap, cell.config, "cpu")), ref)
    assert judge(sound, cell.limits)[0]
    assert not judge(control, cell.limits)[0], control
