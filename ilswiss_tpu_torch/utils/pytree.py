"""Parameter helpers (counterpart: ilswiss_tpu/utils/pytree.py).

JAX lerps immutable pytrees; here the target network's tensors are
updated in place, which saves a copy of every parameter per step.  A
restored checkpoint is copied into the live tensors the same way
(`copy_into`).  `cpu_copy` makes the host loops' acting snapshot.
"""

from __future__ import annotations

import copy
import itertools

import torch
from torch import nn


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """Polyak update IN PLACE: target <- (1 - tau) * target + tau * online.

    Runs under `no_grad` and writes into `target`'s parameter tensors;
    the formula and its order match the JAX `soft_update` lerp."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.mul_(1.0 - tau).add_(o * tau)


@torch.no_grad()
def hard_update(target: nn.Module, online: nn.Module) -> None:
    """target <- online IN PLACE (a hard target copy; the JAX trainers'
    per-leaf `jnp.where(do_hard, online, target)` where it holds)."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(o)


def copy_params(module: nn.Module) -> nn.Module:
    """A deep copy of `module` whose parameters take no gradient
    (target-network init)."""
    out = copy.deepcopy(module)
    out.requires_grad_(False)
    return out


@torch.no_grad()
def copy_into(dst: torch.Tensor, src, where: str) -> None:
    """dst <- src IN PLACE (onto dst's device and dtype); raises ValueError
    naming `where` unless `src` is a tensor of dst's shape."""
    if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
        got = tuple(src.shape) if isinstance(src, torch.Tensor) else src
        raise ValueError(f"{where}: expected a tensor of shape "
                         f"{tuple(dst.shape)}, got {got!r}")
    dst.copy_(src)


def cpu_copy(obj):
    """A copy of `obj` (a trainer's state: modules, optimizers,
    dataclasses, lists and dicts of tensors) in which every tensor is a new
    CPU tensor, whatever device it was on: nothing is shared with `obj`,
    and a module's parameters stay `nn.Parameter`s.  `.cpu()` is no such
    copy: on a CPU tensor it returns the tensor itself, which a trainer
    then updates in place."""
    memo, seen = {}, set()

    def visit(x):
        if x is None or id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            t = x.detach().to("cpu", copy=True)
            memo[id(x)] = (nn.Parameter(t, requires_grad=x.requires_grad)
                           if isinstance(x, nn.Parameter)
                           else t.requires_grad_(x.requires_grad))
        elif isinstance(x, nn.Module):
            for t in itertools.chain(x.parameters(), x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                visit(v)

    visit(obj)
    return copy.deepcopy(obj, memo)
