"""Work of one acting call: the tanh-Gaussian policy's forward on B
observations and its sample, counted from shapes."""

from benchmark.work.peaks import PEAK_F32_FLOPS, bound_ms


def policy_forward_work(B: int, O: int, A: int, H: int, L: int
                        ) -> tuple[float, float]:
    """(bytes, flops): the trunk and both heads' products (two flops per
    multiply-add) and about 10 elementwise flops per action for the clamp,
    exp, sample and tanh; the parameters and the observations read once,
    the noise read once and the actions written once."""
    macs = B * (O * H + (L - 1) * H * H + 2 * A * H)
    n_params = O * H + H + (L - 1) * (H * H + H) + 2 * (A * H + A)
    nbytes = 4 * (n_params + B * O + 2 * B * A)
    return nbytes, 2 * macs + 10 * B * A


def acting_bound_ms(B, O, A, H, L) -> float:
    return bound_ms(*policy_forward_work(B, O, A, H, L), PEAK_F32_FLOPS)
