"""The launch layouts of kernels K4 and K3, measured on the card (no JAX
counterpart: the Pallas kernels have one layout each).

    python3 -m ilswiss_tpu_torch.kernels.redesign_sweep [--parent DIR]

On one CUDA device it builds `csrc/pgs.cu` once for each lanes-per-env L
(with PGS_LANES=L) and `csrc/fused_mlp.cu` once for each (cluster size, tile
rows) pair in `K3_LAUNCHES` (with MLP_CLUSTER and MLP_ROWS), all in
parallel, and prints, on the card's name and power limit:

  * K4, for L in 1, 4, 8, 16 and 32, on the engine's own rows of ant and
    humanoid (`engine_profile.engine_rows`, 15 sweeps) at B = 128, 1024
    and 4096, and on seeded problems with 70% of the rows active at
    B = 128: the time per launch (`kernels/timing.py::graph_ms`), the
    distance from `pgs_solve_plain` in float32, the pin share (largest
    |got - want| / (1e-4 + 2e-4 |want|)) against the float32 and against
    the float64 plain version, and which L the port's own build takes;
  * K3, for each pair, at hopper's, ant's and humanoid's acting shapes
    (256 x 2) at B = 128 and 1024: the time per launch (`graph_ms`), after
    a check against `policy_forward_plain` at 2e-5.

With `--parent DIR`, the K4 and K3 sources of another checkout at DIR (a
`git archive` of the parent commit, say) are built as they stand and timed
the same way on the same inputs, beside the layouts above.  A layout the
card refuses (a cluster that does not fit) is printed as such and skipped.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ilswiss_tpu_torch.kernels.timing import graph_ms

K4_LANES = (1, 4, 8, 16, 32)
K3_LAUNCHES = ((8, 16), (8, 8), (16, 8), (16, 16), (4, 32), (8, 32))
K3_SHAPES = {"hopper": (11, 3), "ant": (105, 8), "humanoid": (348, 17)}


def random_rows(nr: int, nv: int, B: int, device, share: float = 0.7):
    """A seeded problem shaped like the engine's (J random, M = I + small
    SPD, W = M^-1 J^T) with `share` of the rows active."""
    rng = np.random.RandomState(nr)
    J = rng.randn(B, nr, nv)
    S = 0.2 * rng.randn(B, nv, nv)
    W = np.linalg.solve(np.eye(nv)[None] + S @ S.transpose(0, 2, 1),
                        J.transpose(0, 2, 1))
    Rreg = rng.uniform(0.05, 0.5, (B, nr))
    b = rng.randn(B, nr)
    D = np.einsum("brv,bvr->br", J, W) + Rreg
    active = torch.tensor(rng.rand(B, nr) < share, device=device)
    f0 = np.abs(rng.randn(B, nr))
    J, W, Rreg, b, D, f0 = (torch.tensor(x, dtype=torch.float32,
                                         device=device)
                            for x in (J, W, Rreg, b, D, f0))
    return J, W, Rreg, b, D, active, f0


def pin_share(got, want, rtol: float = 2e-4, atol: float = 1e-4) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 where
    `torch.allclose(got, want, rtol, atol)` holds."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _stream(dev):
    # read at each call: inside a graph's capture it is the capturing stream
    return torch.cuda.current_stream(dev).cuda_stream


def k4_sweep(dev, libs: dict, iters: int = 15) -> dict:
    """{(problem, B, layout): ms} over the K4 libraries in `libs`
    ({layout name: library})."""
    from ilswiss_tpu_torch.envs.locomotion import _model
    from ilswiss_tpu_torch.kernels.engine_profile import engine_rows
    from ilswiss_tpu_torch.ops import pgs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    problems = []
    for name in ("ant", "humanoid"):
        m = _model(name)
        for B in (128, 1024, 4096):
            problems.append((f"{name} engine rows", B,
                             engine_rows(m, name, B, dev, iters)))
    for nr, nv in ((116, 14), (150, 23)):
        problems.append((f"{nr} x nv {nv}, 70% active", 128,
                         random_rows(nr, nv, 128, dev)))
    out = {}
    for what, B, args in problems:
        want = pgs.pgs_solve_plain(*args, iters)
        want64 = pgs.pgs_solve_plain(
            *(x.double() if x.is_floating_point() else x for x in args),
            iters)
        per_env = args[5].sum(1)
        line = []
        for layout, lib in libs.items():
            run = lambda: pgs._launch(lib, *args, iters, _stream(dev))
            got = run()
            torch.cuda.synchronize()
            ok = (torch.allclose(got, want, rtol=2e-4, atol=1e-4)
                  and bool((got[~args[5]] == 0.0).all()))
            err = float((got - want).abs().max())
            ms = graph_ms(run)
            out[what, B, layout] = ms
            line.append(f"{layout} {ms:.4f} (err {err:.2g}, pin share "
                        f"{pin_share(got, want):.2g}, against float64 "
                        f"{pin_share(got, want64):.2g}"
                        f"{'' if ok else ', OUTSIDE'})")
        print(f"K4 {what}, B = {B} (active rows an env: mean "
              f"{float(per_env.float().mean()):.2f}, max {int(per_env.max())}"
              f"; max |f| {float(want.abs().max()):.3g}; plain float32 "
              f"against float64: pin share {pin_share(want, want64):.2g}; "
              f"the port takes L = {4 if B <= sms else 32}), ms: "
              + ", ".join(line))
    return out


def k3_sweep(dev, libs: dict) -> dict:
    """{(shape, B, layout): ms} over the K3 libraries in `libs`."""
    from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
    from ilswiss_tpu_torch.ops import fused_mlp
    gen = torch.Generator().manual_seed(0)
    out = {}
    for shape, (n_obs, n_act) in K3_SHAPES.items():
        policy = TanhGaussianPolicy(n_obs, n_act, (256, 256), gen).to(dev)
        w, b = fused_mlp._layers(policy)
        w, b = [x.detach() for x in w], [x.detach() for x in b]
        for B in (128, 1024):
            obs = torch.randn(B, n_obs, generator=gen).to(dev)
            dims = fused_mlp._kernel_dims(w, b, obs)
            want = fused_mlp.policy_forward_plain(w, b, obs)
            line = []
            for layout, lib in libs.items():
                run = lambda: fused_mlp._launch(lib, w, b, obs, dims,
                                                _stream(dev))
                try:
                    got = run()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    line.append(f"{layout} refused ({e})")
                    continue
                if not all(torch.allclose(g, x, rtol=2e-5, atol=2e-5)
                           for g, x in zip(got, want)):
                    raise RuntimeError(f"K3 {shape} B={B} {layout}: "
                                       f"differs from plain")
                ms = graph_ms(run)
                out[shape, B, layout] = ms
                line.append(f"{layout} {ms:.4f}")
            print(f"K3 {shape} ({n_obs} -> 256 -> 256 -> {n_act} + {n_act}), "
                  f"B = {B}, ms: " + ", ".join(line))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the root of another checkout whose K4 and K3 "
                         "sources are timed beside these")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("redesign_sweep: no CUDA device", file=sys.stderr)
        return 2
    from ilswiss_tpu_torch.kernels import build
    from ilswiss_tpu_torch.ops import fused_mlp, pgs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    pgs_src, mlp_src = build.CSRC / "pgs.cu", build.CSRC / "fused_mlp.cu"
    variants = [(f"pgs_L{L}", pgs_src, (f"PGS_LANES={L}",))
                for L in K4_LANES]
    variants += [(f"fused_mlp_{cs}x{tr}", mlp_src,
                  (f"MLP_CLUSTER={cs}", f"MLP_ROWS={tr}"))
                 for cs, tr in K3_LAUNCHES]
    if opts.parent is not None:
        csrc = opts.parent / "ilswiss_tpu_torch" / "csrc"
        variants += [("pgs_parent", csrc / "pgs.cu", ()),
                     ("fused_mlp_parent", csrc / "fused_mlp.cu", ())]
    built = build.build_variants(variants)
    for b in built:
        print(f"--- nvcc {b.name} ({b.seconds:.2f} s) ---")
        print("\n".join(line for line in b.log.splitlines()
                        if any(w in line for w in ("entry function",
                                                   "registers", "spill"))))
    libs = {b.name: ctypes.CDLL(str(b.path)) for b in built}
    k4 = {name.replace("pgs_", ""): pgs._declare(lib)
          for name, lib in libs.items() if name.startswith("pgs_")}
    k3 = {name.replace("fused_mlp_", ""): fused_mlp._declare(lib)
          for name, lib in libs.items() if name.startswith("fused_mlp_")}
    dev = torch.device("cuda")
    k4_sweep(dev, k4)
    k3_sweep(dev, k3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
