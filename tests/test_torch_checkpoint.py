"""Checkpoints and snapshots (ilswiss_tpu_torch/runtime/checkpoint.py vs
ilswiss_tpu/runtime/checkpoint.py): twins of the JAX harness tests
(tests/test_harness.py:74-135), the same directory names and meta.json as
the JAX `SnapshotManager` for the same `on_epoch` sequence in every mode,
a whole runner saved and restored exactly, and one test for each fault of
the reference that the port does not copy (ROADMAP.md section 3).
"""

import json
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.runtime import checkpoint as jckpt
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.logging.logger import Logger
from ilswiss_tpu_torch.runtime.checkpoint import (
    SnapshotManager, load_tree, restore_checkpoint, restore_run,
    restore_subtree, resume_point, save_checkpoint, snapshot_meta, to_tree,
)
from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop
from ilswiss_tpu_torch.testing import tree_diff

torch.set_num_threads(1)

MODES = ["all", "last", "gap", "gap_and_last", "gap_last", "none"]
RETURNS = [1.0, 3.0, 2.0, 5.0, 4.0]      # eval AverageReturn per epoch


def _sac():
    return SAC(3, 1, SACConfig(), net_size=16, num_hidden_layers=1,
               device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    sac = _sac()
    state = sac.init(0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    template = sac.init(1)                      # different values
    policy_params = list(template.policy.parameters())
    restored = restore_checkpoint(path, template)
    assert restored is template
    # in place: the modules and Adam's parameter lists hold the same tensors
    assert all(a is b for a, b in zip(policy_params,
                                      template.policy.parameters()))
    assert all(a is b for a, b in zip(template.policy_opt.params,
                                      template.policy.parameters()))
    assert tree_diff(to_tree(state), to_tree(restored)) == []


def test_snapshot_resume_roundtrip(tmp_path):
    """SnapshotManager 'last' + meta -> restore_run returns the state
    and the next epoch (reference load_from_file semantics)."""
    sac = _sac()
    state = sac.init(0)
    snap = SnapshotManager(str(tmp_path), mode="gap_and_last", gap=10)
    snap.on_epoch(4, state, {"AverageReturn": 1.0})
    template = sac.init(1)
    restored, next_epoch = restore_run(str(tmp_path), template)
    assert next_epoch == 5
    assert tree_diff(to_tree(state), to_tree(restored)) == []


def test_light_snapshot_marks_meta_and_restores_algo_state(tmp_path):
    """last_state_fn (params-only 'last'): meta.json records light=true,
    restore_subtree recovers the algo state."""
    sac = _sac()
    state = sac.init(0)

    class FakeRunner:
        algo_state = state

    snap = SnapshotManager(
        str(tmp_path), mode="gap_last", gap=4, save_best=False,
        last_state_fn=lambda r: {"algo_state": r.algo_state})
    snap.on_epoch(8, FakeRunner(), {"AverageReturn": 1.0})
    meta = snapshot_meta(str(tmp_path))
    assert meta.get("light") is True and meta["epoch"] == 8
    template = sac.init(1)
    restored = restore_subtree(str(tmp_path / "checkpoints" / "last"),
                               template, key="algo_state")
    assert tree_diff(to_tree(state), to_tree(restored)) == []


def test_restore_raises_on_missing_key_and_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path / "a"), {"w": torch.zeros(3),
                                          "n": 4})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path / "a"), {"w": torch.ones(3),
                                                 "n": 0, "v": torch.ones(1)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path / "a"), {"w": torch.ones(4),
                                                 "n": 0})
    sac = _sac()
    save_checkpoint(str(tmp_path / "b"), sac.init(0))
    wide = SAC(3, 1, SACConfig(), net_size=32, num_hidden_layers=1,
               device="cpu")
    with pytest.raises(RuntimeError):          # nn.Module: size mismatch
        restore_checkpoint(str(tmp_path / "b"), wide.init(0))
    # a matching template takes the values
    template = {"w": torch.ones(3), "n": 0}
    assert restore_checkpoint(str(tmp_path / "a"), template)["n"] == 4
    assert torch.equal(template["w"], torch.zeros(3))


def test_runner_roundtrip_is_exact(tmp_path):
    """A whole runner (modules, targets, log alpha, Adam moments and
    counts, ring with cursor, size and episode counters, env state, step
    count, noise generator) is restored exactly, and the next iteration of
    the restored runner equals that of the original."""
    def loop():
        vec = make_vec("pendulum", 4, device="cpu")
        sac = SAC(3, 1, SACConfig(), net_size=16, num_hidden_layers=1,
                  use_fused_chain=True, device="cpu")
        return OffPolicyLoop(vec, sac, OffPolicyConfig(
            batch_size=16, replay_capacity=64, min_steps_before_training=8,
            grad_steps_per_iter=2))

    la, lb = loop(), loop()
    a = la.train_epoch(la.warmup(la.init(0)), 8)[0]
    b = lb.init(5)
    save_checkpoint(str(tmp_path / "r"), a)
    restore_checkpoint(str(tmp_path / "r"), b)
    tree = to_tree(a)
    assert tree["total_env_steps"] == 16 and tree["replay"]["ptr"] == 16
    assert tree["algo_state"]["policy_opt"]["count"] == 4
    assert tree_diff(tree, to_tree(b)) == []
    a, ma = la.train_epoch(a, 4)
    b, mb = lb.train_epoch(b, 4)
    assert ma == mb
    assert tree_diff(to_tree(a), to_tree(b)) == []


# --- the same snapshots as the JAX SnapshotManager --------------------------
def _jax_listing_and_meta(log_dir, mode, light):
    snap = jckpt.SnapshotManager(
        str(log_dir), mode=mode, gap=2,
        best_state_fn=lambda s: {"algo_state": s["algo_state"]},
        last_state_fn=(lambda s: {"algo_state": s["algo_state"]})
        if light else None)
    state = {"algo_state": {"w": jnp.arange(3.0)}, "ring": jnp.ones(4)}
    for epoch, r in enumerate(RETURNS):
        snap.on_epoch(epoch, state, {"AverageReturn": r})
    snap.save_last(state, epoch=len(RETURNS) - 1)
    return _listing_and_meta(snap.dir)


def _listing_and_meta(ckpt_dir):
    meta = os.path.join(ckpt_dir, "meta.json")
    with open(meta) as f:
        return sorted(os.listdir(ckpt_dir)), json.load(f)


@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_snapshot_modes_match_jax(tmp_path, mode, light):
    """Same `on_epoch` sequence (5 epochs, gap 2, a best at epochs 0, 1
    and 3) and the end-of-run `save_last`: the same snapshot names and the
    same meta.json.  The port adds only its 'best' snapshot's own
    meta.json (reference fault 3)."""
    want = _jax_listing_and_meta(tmp_path / "jax", mode, light)
    snap = SnapshotManager(
        str(tmp_path / "port"), mode=mode, gap=2,
        best_state_fn=lambda s: {"algo_state": s["algo_state"]},
        last_state_fn=(lambda s: {"algo_state": s["algo_state"]})
        if light else None)
    state = {"algo_state": {"w": torch.arange(3.0)}, "ring": torch.ones(4)}
    for epoch, r in enumerate(RETURNS):
        snap.on_epoch(epoch, state, {"AverageReturn": r})
    snap.save_last(state, epoch=len(RETURNS) - 1)
    assert _listing_and_meta(snap.dir) == want
    with open(os.path.join(snap.dir, "best", "meta.json")) as f:
        assert json.load(f) == {"epoch": 3, "best_value": 5.0,
                                "light": True}
    tree = load_tree(os.path.join(snap.dir, "best"))
    assert list(tree) == ["algo_state"]


# --- faults of the reference that the port does not copy --------------------
@pytest.mark.parametrize("mode", ["last", "gap_and_last", "gap_last"])
def test_fault_best_value_of_a_last_saved_at_a_new_best(tmp_path, mode):
    """Reference fault 1 where a run dies between two 'last' saves:
    meta.json is written before the epoch's evaluation (as in JAX), so a
    'last' saved at an epoch that set a new best records the best before
    it, and the JAX resume starts from -inf anyway (checkpoint.py:125,
    :161).  The port's `resume_point` takes the 'best' snapshot's own
    value, so a worse epoch after the resume leaves 'best' as it was."""
    jsnap = jckpt.SnapshotManager(str(tmp_path / "jax"), mode=mode, gap=1)
    jsnap.on_epoch(0, {"algo_state": {"w": jnp.zeros(2)}},
                   {"AverageReturn": 9.0})
    snap = SnapshotManager(str(tmp_path / "port"), mode=mode, gap=1)
    snap.on_epoch(0, {"algo_state": {"w": torch.zeros(2)}},
                  {"AverageReturn": 9.0})            # a new best; then dies
    assert snapshot_meta(jsnap.dir)["best_value"] == float("-inf")
    assert snapshot_meta(snap.dir)["best_value"] == float("-inf")
    ckpt, meta, full = resume_point(str(tmp_path / "port"))
    assert ckpt == os.path.join(snap.dir, "last") and full
    assert meta["epoch"] == 0 and meta["best_value"] == 9.0
    resumed = SnapshotManager(str(tmp_path / "port"), mode=mode, gap=1)
    resumed.best_value = meta["best_value"]
    resumed.on_epoch(1, {"algo_state": {"w": torch.ones(2)}},
                     {"AverageReturn": 5.0})
    best = os.path.join(snap.dir, "best")
    assert snapshot_meta(best)["epoch"] == 0
    assert load_tree(best)["algo_state"]["w"].tolist() == [0.0, 0.0]


def test_fault_light_applies_to_every_last_save(tmp_path):
    """Reference fault 2: the JAX manager applies `last_state_fn` only in
    'gap_last' (checkpoint.py:164-190), so in 'last' and 'gap_and_last' a
    light run writes the FULL state while meta.json says light=true.  The
    port's 'last' holds what meta.json says in every mode."""
    light = lambda s: {"algo_state": s["algo_state"]}  # noqa: E731
    for mode in ("last", "gap_and_last", "gap_last"):
        jsnap = jckpt.SnapshotManager(str(tmp_path / "jax" / mode), mode=mode,
                                      gap=1, save_best=False,
                                      last_state_fn=light)
        jsnap.on_epoch(0, {"algo_state": {"w": jnp.zeros(2)},
                           "ring": jnp.ones(4)})
        with ocp.PyTreeCheckpointer() as ck:
            jkeys = set(ck.metadata(os.path.join(
                jsnap.dir, "last")).item_metadata)
        snap = SnapshotManager(str(tmp_path / "port" / mode), mode=mode,
                               gap=1, save_best=False, last_state_fn=light)
        snap.on_epoch(0, {"algo_state": {"w": torch.zeros(2)},
                          "ring": torch.ones(4)})
        assert snapshot_meta(snap.dir)["light"] is True
        assert snapshot_meta(jsnap.dir)["light"] is True
        assert set(load_tree(os.path.join(snap.dir, "last"))) == {
            "algo_state"}
        assert jkeys == ({"algo_state"} if mode == "gap_last"
                         else {"algo_state", "ring"})


@dataclass
class _Runner:
    algo_state: dict

    def replace(self, algo_state):          # the JAX runner's method
        return _Runner(algo_state)


def test_fault_best_resume_takes_the_best_epoch(tmp_path):
    """Reference fault 3: resuming from a 'best' snapshot, the JAX
    `_maybe_resume` starts after the epoch of the last 'last' save
    (experiments.py:316-321, meta.json), not after the best epoch.  The port
    records the best epoch beside the snapshot and starts after it."""
    quiet = dict(print_to_console=False)
    params = lambda s: {"algo_state": s["algo_state"]}  # noqa: E731
    jsnap = jckpt.SnapshotManager(str(tmp_path / "jax"), mode="last",
                                  best_state_fn=params)
    snap = SnapshotManager(str(tmp_path / "port"), mode="last",
                           best_state_fn=params)
    for epoch, r in enumerate([1.0, 9.0, 2.0, 3.0]):     # best at epoch 1
        jsnap.on_epoch(epoch, {"algo_state": {"w": jnp.full(2, epoch,
                                                            jnp.float32)}},
                       {"AverageReturn": r})
        snap.on_epoch(epoch, {"algo_state": {"w": torch.full((2,),
                                                             float(epoch))}},
                      {"AverageReturn": r})
    jvariant = {"load_params": os.path.join(jsnap.dir, "best")}
    _, j_start, j_how = jexp._maybe_resume(
        jvariant, jexp.Logger(str(tmp_path / "jl"), **quiet),
        _Runner({"w": jnp.zeros(2)}))
    runner = _Runner({"w": torch.zeros(2)})
    _, start, how, meta = pexp._maybe_resume(
        {"load_params": os.path.join(snap.dir, "best")},
        Logger(str(tmp_path / "pl"), **quiet), runner)
    assert (j_how, how) == ("light", "light")
    assert j_start == 4                 # after the last 'last' save
    assert start == 2                   # after the best epoch
    assert meta["best_value"] == 9.0
    assert runner.algo_state["w"].tolist() == [1.0, 1.0]
