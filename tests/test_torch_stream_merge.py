"""The port's streaming-merge plan (K9) against the JAX oracle and the
Pallas kernel (interpret mode), bit for bit.

On the CPU the port runs its plain version (``test_torch_gpu.py`` holds
the CUDA kernel against it on the card). The inputs are made with numpy
from a seed and handed to both packages; pointers are compared as their
``uint32`` bits.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.stream_merge import ref as jref  # noqa: E402
from repro.kernels.stream_merge.stream_merge import merge_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stream_merge import ops as tops  # noqa: E402
from repro_torch.kernels.stream_merge import ref as tref  # noqa: E402
from repro_torch.kernels.stream_merge import stream_merge as tsm  # noqa: E402


def _case(seed, k, n, density=0.3):
    rng = np.random.default_rng(seed)
    alloc = (rng.random((k, n)) < density).astype(np.uint32)
    ptrs = rng.integers(0, 2**32, (k, n), dtype=np.uint64).astype(np.uint32)
    return alloc, ptrs


def _port(alloc, ptrs, alloc_dtype=torch.int32):
    a = torch.from_numpy(alloc.astype(np.int32)).to(alloc_dtype)
    return a, torch.from_numpy(ptrs.view(np.int32).copy())


def _same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("k,n", [(2, 128), (8, 256), (30, 640)])
def test_merge_ref_matches_pallas_kernel(k, n):
    """The shapes of ``tests/test_kernels.py::test_stream_merge_sweep``."""
    alloc, ptrs = _case(k, k, n)
    want = merge_pallas(jnp.asarray(alloc), jnp.asarray(ptrs), interpret=True)
    _same(tref.merge_ref(*_port(alloc, ptrs)), want)


@pytest.mark.parametrize("k,n", [(1, 100), (5, 100), (3, 1)])
@pytest.mark.parametrize("alloc_dtype", [torch.int32, torch.bool])
def test_ops_merge_on_cpu_matches_jax_oracle(k, n, alloc_dtype):
    """N = 100 (no 128-lane padding on the port's side) and K = 1; an
    all-unallocated and an all-allocated page column ride along."""
    alloc, ptrs = _case(100 + k, k, n, density=0.4)
    alloc[:, 0] = 0
    if n > 1:
        alloc[:, 1] = 1
    want = jref.merge_ref(jnp.asarray(alloc), jnp.asarray(ptrs), None)
    before = dict(_build.LAUNCHES)
    _same(tops.merge(*_port(alloc, ptrs, alloc_dtype)), want)
    assert _build.LAUNCHES == before          # the CPU never launches


def test_cuda_wrapper_refuses_cpu_tensors():
    alloc, ptrs = _case(0, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.merge_cuda(*_port(alloc, ptrs))
