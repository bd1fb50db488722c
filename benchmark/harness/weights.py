"""The learner's initial weights, made on the device from the seed in one
draw, with ILSwiss's init: hidden layers U(+-1/sqrt(fan_in)) with bias
0.1, the policy's heads U(+-1e-3), the critics' outputs U(+-3e-3).

`make` returns the reference's own copy (kernels [in, out]; the critics'
stacked [2, in, out]); `load_into` copies it into the program's SACState.
"""

from __future__ import annotations

import torch


def _shapes(obs: int, act: int, hidden: int, layers: int):
    pol, cri = [], []
    width = obs
    for i in range(layers):
        pol += [(f"hidden_{i}_w", (width, hidden), width ** -0.5),
                (f"hidden_{i}_b", (hidden,), None)]
        width = hidden
    for head in ("mean", "log_std"):
        pol += [(f"{head}_w", (hidden, act), 1e-3),
                (f"{head}_b", (act,), 1e-3)]
    width = obs + act
    for i in range(layers):
        cri += [(f"hidden_{i}_w", (2, width, hidden), width ** -0.5),
                (f"hidden_{i}_b", (2, hidden), None)]
        width = hidden
    cri += [("output_w", (2, hidden, 1), 3e-3), ("output_b", (2, 1), 3e-3)]
    return pol, cri


def make(seed: int, obs: int, act: int, hidden: int, layers: int, device
         ) -> tuple[dict, dict]:
    """(policy, critics): dicts of float32 tensors on `device`."""
    pol, cri = _shapes(obs, act, hidden, layers)
    sizes = [torch.Size(s).numel() for _, s, _ in pol + cri]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0,
                                                           generator=g)
    out, at = [], 0
    for (name, shape, scale), n in zip(pol + cri, sizes):
        x = flat[at:at + n].view(shape)
        at += n
        out.append((name, x * scale if scale is not None
                    else torch.full(shape, 0.1, device=device)))
    return dict(out[:len(pol)]), dict(out[len(pol):])


@torch.no_grad()
def load_into(state, policy: dict, critics: dict, layers: int) -> None:
    """Copy the weights into the program's state: nn.Linear weights are
    [out, in]; the twin critics and their targets take kernels [2, in,
    out] under `<layer>_kernel` / `<layer>_bias`."""
    pol = state.policy
    names = [f"hidden_{i}" for i in range(layers)] + ["mean", "log_std"]
    for name in names:
        lin = getattr(pol, name)
        lin.weight.copy_(policy[f"{name}_w"].t())
        lin.bias.copy_(policy[f"{name}_b"])
    for qf in (state.qf, state.target_qf):
        for name in [f"hidden_{i}" for i in range(layers)] + ["output"]:
            getattr(qf, f"{name}_kernel").copy_(critics[f"{name}_w"])
            getattr(qf, f"{name}_bias").copy_(critics[f"{name}_b"])


def read_from(state, layers: int) -> tuple[dict, dict, dict]:
    """The program's (policy, critics, targets) in the reference's layout."""
    pol = state.policy
    p = {}
    for name in [f"hidden_{i}" for i in range(layers)] + ["mean", "log_std"]:
        lin = getattr(pol, name)
        p[f"{name}_w"], p[f"{name}_b"] = lin.weight.t(), lin.bias
    c, t = {}, {}
    for out, qf in ((c, state.qf), (t, state.target_qf)):
        for name in [f"hidden_{i}" for i in range(layers)] + ["output"]:
            out[f"{name}_w"] = getattr(qf, f"{name}_kernel")
            out[f"{name}_b"] = getattr(qf, f"{name}_bias")
    return ({k: v.detach().clone() for k, v in p.items()},
            {k: v.detach().clone() for k, v in c.items()},
            {k: v.detach().clone() for k, v in t.items()})


def _moment(opt, tensor):
    for p, m in zip(opt.params, opt.mu):
        if p is tensor:
            return m
    raise KeyError("the optimizer does not hold this tensor")


def moments_from(state, layers: int) -> dict:
    """The program's Adam first moments, keyed as the reference's."""
    out = {}
    for name in [f"hidden_{i}" for i in range(layers)] + ["mean", "log_std"]:
        lin = getattr(state.policy, name)
        out[("p", f"{name}_w")] = _moment(state.policy_opt, lin.weight).t()
        out[("p", f"{name}_b")] = _moment(state.policy_opt, lin.bias)
    for name in [f"hidden_{i}" for i in range(layers)] + ["output"]:
        for part, key in (("kernel", "w"), ("bias", "b")):
            out[("c", f"{name}_{key}")] = _moment(
                state.qf_opt, getattr(state.qf, f"{name}_{part}"))
    out[("a", "log_alpha")] = _moment(state.alpha_opt, state.log_alpha)
    return {k: v.detach().clone() for k, v in out.items()}
