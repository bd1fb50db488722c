"""What every cell's comparison shares: the judgement of the compared
numbers against their limits, the gaps it reads, and the roundings a
control takes one precision below the configuration's.  What a cell
compares, and how its reference follows the program, is its algorithm's
file under `algos/`."""

from __future__ import annotations

import torch


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and finite."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits[name]["limit"]
        out[name] = {"value": value, "limit": limit}
        if not (value == value and value <= limit):   # NaN fails
            ok = False
    return ok, out


def rel_gap(x, ref) -> float:
    """Largest |x - ref| / (1 + |ref|)."""
    x, ref = x.double(), ref.double()
    return float(((x - ref).abs() / (1.0 + ref.abs())).max())


def leaf_gap(prog: dict, ref: dict, base: dict | None, keep) -> float:
    """Worst leaf's |norm(p - base) - norm(r - base)| / max(norm(r - base),
    median over leaves), over the leaves `keep` admits."""
    def norm(d, k):
        v = d[k].double() - (base[k].double() if base else 0.0)
        return float(v.norm())
    names = [k for k in ref if keep(k)]
    ref_n = {k: norm(ref, k) for k in names}
    med = sorted(ref_n.values())[len(names) // 2]
    return max(abs(norm(prog, k) - ref_n[k]) / max(ref_n[k], med, 1e-30)
               for k in names)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (its largest magnitude at
    448), and back."""
    amax = x.detach().abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def tf32_product(x, w):
    return torch.matmul(round_tf32(x.float()), round_tf32(w.float()))
