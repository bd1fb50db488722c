"""What the port's tests, chip_smoke.py and kernels/k2_mode_diff.py share
when they hold the fused SAC chain (ops/fused_sac.py, kernel K2) against a
reference: the pins of each mode of its products, the rule for its bf16
mode against its plain version at full width, and a way to run the loop's
fused chain in float32 mode.

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

import torch

from ilswiss_tpu_torch.ops.fused_sac import METRIC_NAMES

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
