"""The projected Gauss-Seidel solve of the port (ilswiss_tpu_torch/ops/pgs.py
and csrc/pgs.cu, kernel K4) against the JAX package
(ilswiss_tpu/ops/pgs_pallas.py).

The same random problems, made with numpy from a seed in the shape of
tests/test_pgs_pallas.py's, go through

  * `pgs_solve_plain` and `jax.vmap(_sweep_fallback)`;
  * `pgs_solve_plain` and the Pallas kernel `_pgs_kernel_batched` in
    interpret mode;
  * `pgs_solve_plain` and the CUDA source itself, compiled by g++ against
    the host shim and run on CPU threads (kernels/host_build.py).

Tolerance in float32: rtol 2e-4, atol 1e-4, the pin of
tests/test_pgs_pallas.py (the same 15 sweeps with the dot products summed in
another order); rows that are not active come out exactly zero.  In float64
the plain version follows the fallback at 1e-12.
"""

import ctypes
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ilswiss_tpu.ops.pgs_pallas import _pgs_kernel_batched, _sweep_fallback
from ilswiss_tpu_torch.ops import pgs

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=1e-4)
ITERS = 15
# nr, nv, B: a toy, hopper's rows, ant's and humanoid's
SHAPES = [(6, 4, 4), (38, 6, 9), (116, 14, 3), (150, 23, 2)]


def _problem(nr, nv, B, dtype=np.float32):
    """Well-conditioned instances shaped like the engine's: J random,
    M = I + small SPD, W = M^-1 J^T."""
    rng = np.random.RandomState(nr)
    J = rng.randn(B, nr, nv)
    S = 0.2 * rng.randn(B, nv, nv)
    M = np.eye(nv)[None] + S @ S.transpose(0, 2, 1)
    W = np.linalg.solve(M, J.transpose(0, 2, 1))
    Rreg = rng.uniform(0.05, 0.5, (B, nr))
    b = rng.randn(B, nr)
    D = np.einsum("brv,bvr->br", J, W) + Rreg
    active = rng.rand(B, nr) < 0.7
    f0 = np.abs(rng.randn(B, nr))
    return tuple(x.astype(dtype) for x in (J, W, Rreg, b, D)) + (
        active, f0.astype(dtype))


def _tensors(args):
    return tuple(torch.as_tensor(x) for x in args)


@pytest.mark.parametrize("nr,nv,B", SHAPES)
def test_plain_matches_jax_fallback(nr, nv, B):
    args = _problem(nr, nv, B)
    want = np.asarray(jax.vmap(functools.partial(
        _sweep_fallback, iters=ITERS))(*(jnp.asarray(x) for x in args)))
    before = pgs.pgs_solve.launches
    got = pgs.pgs_solve(*_tensors(args), ITERS).numpy()
    assert pgs.pgs_solve.launches == before      # CPU: the plain version
    np.testing.assert_allclose(got, want, **F32)
    assert np.all(got[~args[5]] == 0.0) and np.all(got >= 0.0)


@pytest.mark.parametrize("nr,nv,B", SHAPES)
def test_plain_matches_interpreted_pallas_kernel(nr, nv, B):
    args = _problem(nr, nv, B)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pgs_kernel_batched(
            *(jnp.asarray(x) for x in args), iters=ITERS))
    got = pgs.pgs_solve_plain(*_tensors(args), ITERS).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert np.all(got[~args[5]] == 0.0)


def test_plain_float64_follows_fallback():
    jax.config.update("jax_enable_x64", True)
    try:
        args = _problem(38, 6, 5, np.float64)
        want = np.asarray(jax.vmap(functools.partial(
            _sweep_fallback, iters=ITERS))(*(jnp.asarray(x) for x in args)))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = pgs.pgs_solve_plain(*_tensors(args), ITERS)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_zero_sweeps_return_the_masked_warm_start():
    args = _tensors(_problem(6, 4, 4))
    got = pgs.pgs_solve_plain(*args, 0)
    assert torch.equal(got, torch.where(args[5], args[6],
                                        torch.zeros_like(args[6])))


# ---- the CUDA source itself, compiled for the CPU ---------------------------


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    from ilswiss_tpu_torch.kernels.host_build import build_host
    return pgs._declare(ctypes.CDLL(str(build_host("pgs", "PgsArgs"))))


@pytest.mark.parametrize("nr,nv,B", SHAPES)
def test_kernel_source_on_host_threads_matches_plain(host_lib, nr, nv, B):
    """csrc/pgs.cu on one block of 32 CPU threads per env, through the
    wrapper's own checks and launch code: the kernel's indexing, shuffles
    and the hand-over of f between sweeps, without a card.  Tolerance as
    on the card; two launches give the same bits; W read through
    column-major strides (as a triangular solve may leave it) gives the
    same bits as W read row-major."""
    args = _tensors(_problem(nr, nv, B))
    pgs._check_inputs(*args, ITERS)
    got = pgs._launch(host_lib, *args, ITERS, None)
    want = pgs.pgs_solve_plain(*args, ITERS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    assert torch.all(got[~args[5]] == 0.0) and torch.all(got >= 0.0)
    assert torch.equal(got, pgs._launch(host_lib, *args, ITERS, None))
    W_cols = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    assert W_cols.stride() != args[1].stride()
    pgs._check_inputs(args[0], W_cols, *args[2:], ITERS)
    assert torch.equal(got, pgs._launch(host_lib, args[0], W_cols, *args[2:],
                                        ITERS, None))


def test_kernel_source_on_host_threads_zero_sweeps(host_lib):
    args = _tensors(_problem(6, 4, 4))
    got = pgs._launch(host_lib, *args, 0, None)
    assert torch.equal(got, pgs.pgs_solve_plain(*args, 0))


# ---- what the wrapper refuses -----------------------------------------------


def _refusals():
    J, W, Rreg, b, D, active, f0 = _tensors(_problem(6, 4, 4))
    wide = _tensors(_problem(6, pgs.MAX_NV + 1, 2))
    tall = _tensors(_problem(pgs.MAX_ROWS + 1, 3, 1))
    return {
        "float64": (J.double(), W.double(), Rreg.double(), b.double(),
                    D.double(), active, f0.double()),
        "float64_W_only": (J, W.double(), Rreg, b, D, active, f0),
        "nv_over_32": wide,
        "rows_over_256": tall,
        "W_not_transposed_shape": (J, J, Rreg, b, D, active, f0),
        "active_not_bool": (J, W, Rreg, b, D, active.float(), f0),
        "row_vector_not_contiguous": (
            J, W, Rreg, b.t().contiguous().t(), D, active, f0),
        "f0_wrong_shape": (J, W, Rreg, b, D, active, f0[:, :5]),
        "J_not_batched": (J[0], W[0], Rreg[0], b[0], D[0], active[0], f0[0]),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_kernel_checks_refuse(case):
    """What `pgs_solve` raises ValueError for on a CUDA tensor, before
    anything is built: the checks read shapes, types and strides only, so
    they run here on CPU tensors."""
    with pytest.raises(ValueError):
        pgs._check_inputs(*_refusals()[case], ITERS)


def test_negative_sweeps_and_other_devices_are_refused():
    args = _tensors(_problem(6, 4, 4))
    with pytest.raises(ValueError):
        pgs._check_inputs(*args, -1)
    meta = tuple(x.to("meta") for x in args)
    before = pgs.pgs_solve.launches
    with pytest.raises(ValueError):
        pgs.pgs_solve(*meta, ITERS)
    assert pgs.pgs_solve.launches == before
