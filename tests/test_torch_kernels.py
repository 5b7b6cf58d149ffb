"""The port's pid_update kernel: its plain version against the Pallas
kernel (interpret mode) on the CPU, and the CUDA kernel against its plain
version on a card (marked ``cuda``, skipped without one).

The card's machine has no JAX, so this file imports JAX and the
reference only inside the test that compares with them:

    python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pid import GAINS
from repro_torch.kernels import ops, pid_update as pk

TOL = dict(atol=1e-4, rtol=1e-5)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32) for lo, hi in
            ((100, 300), (50, 310), (30, 95), (-60, 60), (-50, 50))]


@pytest.mark.parametrize("n", [7, 128, 1024, 2500])
def test_pid_update_ref_matches_pallas_kernel(n):
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    args = _inputs(n)
    want = ref_ops.pid_update(*map(jnp.asarray, args), interpret=True)
    got = pk.pid_update_ref(*map(torch.from_numpy, args), GAINS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_ops_pid_update_takes_the_plain_version_on_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(300, seed=1)]
    got = ops.pid_update(*args, GAINS, dt_s=0.01)
    want = pk.pid_update_ref(*args, GAINS, dt_s=0.01)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(16)]
    before = pk.pid_update.launches
    with pytest.raises(ValueError, match="CUDA"):
        pk.pid_update(*args, GAINS)
    assert pk.pid_update.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1024, 2500, 393_216])
def test_cuda_kernel_matches_plain_version(cuda, n):
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(n, seed=n)]
    before = pk.pid_update.launches
    got = ops.pid_update(*args, GAINS)
    torch.cuda.synchronize()
    assert pk.pid_update.launches == before + 1
    for g, w in zip(got, pk.pid_update_ref(*args, GAINS)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "strided", "shape"])
def test_cuda_kernel_rejects_what_it_does_not_take(cuda, bad):
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(64)]
    if bad == "float64":
        args[2] = args[2].double()
    elif bad == "strided":
        args[0] = torch.cat([args[0], args[0]])[::2]
    else:
        args[4] = args[4][:10]
    with pytest.raises(ValueError):
        pk.pid_update(*args, GAINS)
