"""Checkpoint / resume on `torch.save` (counterpart:
ilswiss_tpu/runtime/checkpoint.py).

Rebuild of the reference snapshot system (rlkit/core/logger.py:345-367
save modes + `load_from_file` resume :31-49).  A checkpoint is a
directory holding one `torch.save` file of a tree of nested dicts and
lists whose leaves are CPU tensors and Python scalars (`to_tree`): for a
runner, the state dicts of the policy, the critics and their targets, log
alpha, each Adam's moments and count, the replay ring with its cursor,
size and episode counters, the env state, the env-step count and the
noise generator's state.  Restoring copies the file's values into a
TEMPLATE of the same structure, IN PLACE (`restore_into`): the modules,
the optimizers and the loop keep the tensors they hold, and the template
decides the device.  A missing key or a shape that differs raises, as an
Orbax restore into a mismatched template does.

Snapshot modes mirror the reference: 'all' | 'last' | 'gap' |
'gap_and_last' | 'none' (logger.py:345-367), plus 'gap_last' and
best-by-metric checkpoints (base_algorithm.py:644-656).  Unlike the JAX
`SnapshotManager` (faults of the reference that the port does not copy,
ROADMAP section 3):
  * `last_state_fn` (a light, params-only 'last') applies to every 'last'
    save in every mode, not only in 'gap_last', so meta.json's `light`
    always says what 'last' holds;
  * a 'best' snapshot records its own epoch, value and lightness in a
    meta.json of its own, so a resume from it starts after the best
    epoch, not after the last 'last' save;
  * `resume_point` gives a resumed run the true best value: the larger of
    the run's meta.json (written, as in JAX, before the epoch's
    evaluation, so a 'last' saved at a new best holds the one before) and
    the 'best' snapshot's own, so a worse epoch after a resume does not
    overwrite the best snapshot (the caller seeds `best_value` with it).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import torch

from ilswiss_tpu_torch.utils.pytree import copy_into

STATE_FILE = "state.pt"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


# --- state <-> tree ------------------------------------------------------
def _walk(obj: Any, leaf) -> Any:
    """`obj` as nested dicts and lists with `leaf(tensor)` at the tensors:
    objects with a `state_dict()` (modules, `Adam`, `Noise`) give that,
    dataclasses (the runner, the env and replay state, `SACState`) a dict
    of their fields."""
    if isinstance(obj, torch.Tensor):
        return leaf(obj)
    if hasattr(obj, "state_dict"):
        return _walk(obj.state_dict(), leaf)
    if dataclasses.is_dataclass(obj):
        return {f.name: _walk(getattr(obj, f.name), leaf)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_walk(v, leaf) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def to_tree(obj: Any) -> Any:
    """The checkpointed form of `obj`: nested dicts and lists whose leaves
    are CPU tensors and Python scalars."""
    return _walk(obj, lambda t: t.detach().cpu())


def _check_keys(want, got: Mapping, where: str) -> None:
    if not isinstance(got, Mapping):
        raise ValueError(f"{where}: expected a mapping, got "
                         f"{type(got).__name__}")
    missing = [k for k in want if k not in got]
    extra = [k for k in got if k not in want]
    if missing or extra:
        raise KeyError(f"{where or 'checkpoint'}: missing {missing}, "
                       f"unexpected {extra}")


def restore_into(template: Any, tree: Any, where: str = "") -> Any:
    """Copy `tree` (as `to_tree` makes it) into `template` in place and
    return it.  Tensors are copied onto the template's device and dtype;
    scalar fields of dataclasses are set."""
    if isinstance(template, torch.Tensor):
        copy_into(template, tree, where or "checkpoint")
        return template
    if hasattr(template, "load_state_dict"):
        # nn.Module copies in place and raises on missing or unexpected
        # keys and on shapes that differ; Adam and Noise do the same
        template.load_state_dict(tree)
        return template
    if dataclasses.is_dataclass(template):
        names = [f.name for f in dataclasses.fields(template)]
        _check_keys(names, tree, where)
        for name in names:
            old = getattr(template, name)
            new = restore_into(old, tree[name], f"{where}.{name}")
            if new is not old:
                setattr(template, name, new)
        return template
    if isinstance(template, Mapping):
        _check_keys(list(template), tree, where)
        for k in template:
            new = restore_into(template[k], tree[k], f"{where}.{k}")
            if new is not template[k]:
                template[k] = new
        return template
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"{where}: expected {len(template)} entries")
        for i, (t, v) in enumerate(zip(template, tree)):
            if restore_into(t, v, f"{where}[{i}]") is not t:
                raise ValueError(f"{where}[{i}]: a scalar inside a "
                                 f"sequence cannot be restored in place")
        return template
    if type(tree) is not type(template) and not (
            isinstance(template, float) and isinstance(tree, int)):
        raise ValueError(f"{where}: expected a {type(template).__name__}, "
                         f"got {tree!r}")
    return tree


def _device_of(template: Any) -> torch.device:
    """The device of the template's first floating-point tensor (a
    generator's state is a CPU byte tensor on every device)."""
    devices = []
    _walk(template, lambda t: devices.append(t.device)
          if t.is_floating_point() else None)
    return devices[0] if devices else torch.device("cpu")


# --- files ---------------------------------------------------------------
def save_checkpoint(path: str, state: Any) -> None:
    """Write `to_tree(state)` as `<path>/state.pt` (through a temporary
    file, so an interrupted save leaves the previous one whole)."""
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save(to_tree(state), target + ".tmp")
    os.replace(target + ".tmp", target)


def load_tree(path: str, map_location=None) -> Any:
    """The saved tree of checkpoint `path`, its tensors on `map_location`
    (default: as saved, on the CPU)."""
    return torch.load(os.path.join(_abs(path), STATE_FILE),
                      map_location=map_location, weights_only=True)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore checkpoint `path` into `template` (in place; returned).
    The file loads onto the template's device."""
    return restore_into(template,
                        load_tree(path, _device_of(template)))


def restore_subtree(path: str, template: Any,
                    key: str = "algo_state") -> Any:
    """Restore one field of a saved runner into `template` (in place;
    returned).

    Snapshots hold the WHOLE runner; consumers like policy evaluation only
    need the algo state.  A card-written snapshot loads into a CPU template
    and the reverse: the file loads onto the template's device."""
    tree = load_tree(path, _device_of(template))
    return restore_into(template, tree[key] if key else tree, key or "")


class SnapshotManager:
    """Decides when/where to write epoch snapshots."""

    def __init__(self, log_dir: str, mode: str = "gap_and_last",
                 gap: int = 10, save_best: bool = True,
                 best_key: str = "AverageReturn",
                 best_state_fn=None, last_state_fn=None):
        if mode not in ("all", "last", "gap", "gap_and_last", "gap_last",
                        "none"):
            raise ValueError(f"unknown snapshot mode {mode!r}")
        self.dir = os.path.join(log_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.mode = mode
        self.gap = gap
        self.save_best = save_best
        self.best_key = best_key
        # a resumed run sets this from `resume_point`'s meta
        self.best_value = -float("inf")
        # best_state_fn(state) -> what a 'best' snapshot holds (runners
        # pass a params-only projection, what policy evaluation reads)
        self.best_state_fn = best_state_fn or (lambda s: s)
        # last_state_fn(state) -> what every 'last' snapshot holds.  A
        # FULL runner snapshot moves the whole replay ring device->host;
        # "light" runs pass a params-only projection, and resume then
        # restores the algo state and refills the ring through warmup.
        # meta.json records light=true.
        self.last_state_fn = last_state_fn or (lambda s: s)
        self._light = last_state_fn is not None
        self._best_light = best_state_fn is not None

    def _save_last(self, state: Any) -> None:
        save_checkpoint(os.path.join(self.dir, "last"),
                        self.last_state_fn(state))

    def save_last(self, state: Any, epoch: int | None = None) -> None:
        """Unconditional 'last' snapshot (end-of-run flush)."""
        self._save_last(state)
        if epoch is not None:
            self._write_meta(epoch)

    def _write_meta(self, epoch: int) -> None:
        # resume metadata next to the snapshots (the reference's
        # load_from_file returns the next epoch, logger.py:31-49).
        # Written ONLY when a resumable 'last' lands, so the restored
        # state and the resume epoch can never disagree (gap_last mode
        # saves sparsely).
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "best_value": self.best_value,
                       "light": self._light}, f)

    def on_epoch(self, epoch: int, state: Any,
                 eval_stats: dict | None = None) -> None:
        if self.mode in ("all", "last", "gap", "gap_and_last"):
            self._write_meta(epoch)
        elif self.mode == "gap_last" and epoch % self.gap == 0:
            self._write_meta(epoch)
        if self.mode == "all":
            save_checkpoint(os.path.join(self.dir, f"epoch_{epoch}"), state)
        elif self.mode == "last":
            self._save_last(state)
        elif self.mode == "gap":
            if epoch % self.gap == 0:
                save_checkpoint(
                    os.path.join(self.dir, f"epoch_{epoch}"), state)
        elif self.mode == "gap_and_last":
            if epoch % self.gap == 0:
                save_checkpoint(
                    os.path.join(self.dir, f"epoch_{epoch}"), state)
            self._save_last(state)
        elif self.mode == "gap_last":
            # Overwrite 'last' every `gap` epochs (no per-epoch full dump,
            # no epoch_N copies): a full runner snapshot moves the whole
            # replay ring device->host.  Resume granularity becomes `gap`
            # epochs; call save_last() after the final epoch for an exact
            # end state.
            if epoch % self.gap == 0:
                self._save_last(state)

        if (self.save_best and eval_stats is not None
                and self.best_key in eval_stats):
            v = float(eval_stats[self.best_key])
            if v > self.best_value:
                self.best_value = v
                best = os.path.join(self.dir, "best")
                save_checkpoint(best, self.best_state_fn(state))
                with open(os.path.join(best, "meta.json"), "w") as f:
                    json.dump({"epoch": epoch, "best_value": v,
                               "light": self._best_light}, f)


# --- resume ----------------------------------------------------------------
def _checkpoint_dir(path: str) -> str:
    """A run's log_dir resolves to its checkpoints/last; any other path is
    the checkpoint directory itself."""
    path = _abs(path)
    last = os.path.join(path, "checkpoints", "last")
    return last if os.path.isdir(last) else path


def _read_json(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def snapshot_meta(path: str) -> dict:
    """meta.json of a checkpoint dir, the checkpoints dir or a run log_dir
    ({} if absent): a 'best' snapshot's own, else the run's, beside
    'last'."""
    ckpt = _checkpoint_dir(path)
    for cand in (os.path.join(ckpt, "meta.json"),
                 os.path.join(os.path.dirname(ckpt), "meta.json")):
        meta = _read_json(cand)
        if meta is not None:
            return meta
    return {}


def resume_point(path: str) -> tuple[str, dict, bool]:
    """What a run resumes from, given `variant['load_params']` (a run's
    log_dir, its checkpoints/last, or a 'best' snapshot): (the checkpoint
    directory, its meta, whether it holds the whole runner).  A light
    snapshot (meta `light`) holds the algo state only.  The meta's
    `best_value` is the larger of the snapshot's and the 'best' snapshot's
    beside it, the true best of the run."""
    ckpt = _checkpoint_dir(path)
    meta = snapshot_meta(ckpt)
    best = _read_json(os.path.join(os.path.dirname(ckpt), "best",
                                   "meta.json"))
    if best is not None:
        meta["best_value"] = max(meta.get("best_value", -float("inf")),
                                 best["best_value"])
    return ckpt, meta, not meta.get("light", False)


def restore_run(path: str, template: Any) -> tuple[Any, int]:
    """Resume a run: restore the runner into `template` and return
    (state, next_epoch).  `path` is resolved by `resume_point`.  The
    reference equivalent is logger.load_from_file (logger.py:31-49) wired
    through variant['load_params'] (sac_exp_script.py:91-93)."""
    ckpt, meta, _ = resume_point(path)
    return (restore_checkpoint(ckpt, template),
            int(meta.get("epoch", -1)) + 1)
