"""Kernel K3's CUDA source (ilswiss_tpu_torch/csrc/fused_mlp.cu) on CPU
threads against its plain version (`policy_forward_plain`).

The source is compiled by g++ against the host shim (kernels/host_build.py),
whose cluster launch runs each thread block cluster's threads together, so
the cluster rank, `map_shared_rank` writes into the other blocks' shared
memory, `cluster.sync()` and the two-slot weight ring are rehearsed through
the wrapper's own launch code.  Tolerance 2e-5, as on the card: float32
sums in another order than the library's.  The JAX-parity cases of the
plain version are in tests/test_torch_models.py.
"""

import ctypes
import shutil

import pytest
import torch

from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
# (obs, hidden, action): hopper's and humanoid's acting shapes, one layer
# of the widest width, four hidden layers
SHAPES = [(11, (256, 256), 3), (348, (256, 256), 17), (40, (1024,), 5),
          (20, (64, 48, 32, 16), 4)]


def _host_lib(sms):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    from ilswiss_tpu_torch.kernels.host_build import build_host
    return fused_mlp._declare(
        ctypes.CDLL(str(build_host("fused_mlp", "MlpArgs", sms))))


@pytest.fixture(scope="module")
def host_lib():
    """On the shim's 3 "SMs": the kernel takes tiles of 16 rows."""
    return _host_lib(3)


@pytest.fixture(scope="module")
def host_lib_132():
    """On a shim of the H100's 132 SMs: tiles of 8 rows up to B = 128."""
    return _host_lib(132)


def _case(obs_size, hidden, act, B, seed=0):
    gen = torch.Generator().manual_seed(seed)
    policy = TanhGaussianPolicy(obs_size, act, hidden, gen)
    w, b = fused_mlp._layers(policy)
    w, b = [x.detach() for x in w], [x.detach() for x in b]
    obs = 2.0 * torch.randn(B, obs_size, generator=gen)
    return w, b, obs


@pytest.mark.parametrize("B", [1, 17, 128])
@pytest.mark.parametrize("obs_size,hidden,act", SHAPES)
def test_kernel_source_on_host_threads_matches_plain(host_lib, obs_size,
                                                     hidden, act, B):
    """Clusters of 8 blocks, tiles of 16 rows (the kernel's choice on 3
    "SMs"); B = 17 leaves a ragged tile, B = 1 a tile of one row."""
    w, b, obs = _case(obs_size, hidden, act, B)
    dims = fused_mlp._kernel_dims(w, b, obs)
    got = fused_mlp._launch(host_lib, w, b, obs, dims, None)
    want = fused_mlp.policy_forward_plain(w, b, obs)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, **TOL)
    for g, x in zip(got, fused_mlp._launch(host_lib, w, b, obs, dims, None)):
        assert torch.equal(g, x)


@pytest.mark.parametrize("B", [1, 17, 128, 200])
def test_kernel_source_other_launches(host_lib_132, B):
    """The launches the card takes: on 132 SMs the kernel keeps tiles of 8
    rows while the clusters fit in one wave (B <= 128: 128 blocks) and 16
    beyond (B = 200); the same function as the plain version and the
    3-SM launch."""
    w, b, obs = _case(11, (256, 256), 3, B, seed=1)
    dims = fused_mlp._kernel_dims(w, b, obs)
    got = fused_mlp._launch(host_lib_132, w, b, obs, dims, None)
    want = fused_mlp.policy_forward_plain(w, b, obs)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, **TOL)


def test_kernel_source_clamps_log_std(host_lib):
    w, b, obs = _case(11, (256, 256), 3, 9, seed=2)
    b[-1] = b[-1] + torch.tensor([-40.0, 0.0, 40.0])
    dims = fused_mlp._kernel_dims(w, b, obs)
    _, log_std = fused_mlp._launch(host_lib, w, b, obs, dims, None)
    assert torch.all(log_std[:, 0] == -20.0) and torch.all(log_std[:, 2] == 2.0)


def test_kernel_refuses_an_action_wider_than_1024():
    w, b, obs = _case(11, (32,), 1025, 2)
    with pytest.raises(ValueError):
        fused_mlp._kernel_dims(w, b, obs)
