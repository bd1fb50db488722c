"""Work of the learner's K-step SAC chain, counted from shapes (copied
from `chip_smoke.py`, where it bounds kernel K2)."""

from benchmark.work.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS


def k2_work(B: int, O: int, A: int, H: int, L: int, K: int
            ) -> tuple[float, float, float]:
    """(bytes, product flops, elementwise flops) of one chain of K steps,
    counted from the products of one step (two flops per multiply-add):
    the policy forward on obs and on next_obs; three twin-critic forwards
    (targets, critics, updated critics); the critics' weight and input
    gradients; the input gradient of the updated critics down to the
    action columns; the policy's weight and input gradients; and,
    elementwise in float32, about 12 flops per parameter for Adam and
    Polyak.  Bytes: the state (parameters, targets, moments, alpha) read
    once and written once, the K streamed batches and noise read once, the
    metrics written once."""
    D = O + A
    trunk = (L - 1) * H * H
    policy_fwd = O * H + trunk + 2 * A * H
    critic_fwd = D * H + trunk + H
    macs = B * (2 * policy_fwd
                + 3 * 2 * critic_fwd
                + 2 * (critic_fwd + H + trunk)
                + 2 * (H + trunk + A * H)
                + policy_fwd + 2 * A * H + trunk)
    n_policy = O * H + H + (L - 1) * (H * H + H) + 2 * (A * H + A)
    n_critics = 2 * (D * H + H + (L - 1) * (H * H + H) + H + 1)
    state = 3 * n_policy + 4 * n_critics + 3
    nbytes = 4 * (2 * state + K * B * (2 * O + 3 * A + 2) + K * 8)
    return nbytes, K * 2 * macs, K * 12 * (n_policy + 2 * n_critics)


def k2_bound_ms(B, O, A, H, L, K, bf16: bool = True) -> float:
    """The chain's least milliseconds: the products over the peak of their
    type (bf16 tensor cores, or float32) plus the elementwise float32
    operations over the float32 peak, against the bytes."""
    nbytes, prod, elem = k2_work(B, O, A, H, L, K)
    t_ops = (prod / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + elem / PEAK_F32_FLOPS) * 1e3
    return max(t_ops, nbytes / PEAK_BYTES * 1e3)
