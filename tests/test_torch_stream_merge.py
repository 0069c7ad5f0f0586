"""The port's streaming-merge plan (K9) against the JAX oracle and the
Pallas kernel (interpret mode), bit for bit: the planes entry (``merge``)
and the word entry (``merge_entries``, what ``plan_merge`` calls) against
the JAX package's ``plan_merge``.

On the CPU the port runs its plain version (``test_torch_gpu.py`` holds
the CUDA kernel against it on the card). The inputs are made with numpy
from a seed and handed to both packages; pointers are compared as their
``uint32`` bits.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import chain as jchain  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.kernels.stream_merge import ref as jref  # noqa: E402
from repro.kernels.stream_merge.stream_merge import merge_pallas  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402
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


def _entries(seed, k, n, density=0.3):
    """Random (K, N, 2) packed L2 words in the real entry layout; page 0
    is allocated in no layer, the last page in every layer."""
    rng = np.random.default_rng(seed)
    alloc = rng.random((k, n)) < density
    alloc[:, 0] = False
    alloc[:, -1] = True
    e = np.asarray(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, 1 << 28, (k, n)).astype(np.uint32)),
        jnp.asarray(rng.integers(0, k, (k, n)).astype(np.uint32)),
        allocated=jnp.asarray(alloc),
        bfi_valid=jnp.asarray(rng.random((k, n)) < 0.7),
        zero=jnp.asarray(rng.random((k, n)) < 0.1),
    ))
    return e


@pytest.mark.parametrize("k,n", [(1, 33), (2, 128), (7, 100), (40, 257)])
def test_merge_entries_ref_matches_jax_plan_merge(k, n):
    """The word entry's plain version against the JAX package's
    ``plan_merge`` (merged words and found, bit for bit) and against the
    planes-then-``merge_ref`` composition it replaces; K = 1, N not a
    multiple of 32, an all-miss and an all-hit page."""
    e = _entries(k * 7 + n, k, n)
    jm, jf = jchain.plan_merge(jnp.asarray(e), k - 1)
    sub = tfmt.words(e)
    merged, found, src = tref.merge_entries_ref(sub)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jm).view(np.int32))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    f2, ptr, s2 = tref.merge_ref(tfmt.entry_allocated(sub), tfmt.entry_ptr(sub))
    assert torch.equal(found, f2) and torch.equal(src, s2)
    assert torch.equal(tfmt.entry_ptr(merged)[found], ptr[found])
    assert int(src[0]) == -1 and not bool(found[0])
    assert torch.equal(merged[0], sub[0, 0])           # a miss takes layer 0's
    assert int(src[-1]) == k - 1


@pytest.mark.parametrize("merge_upto", [0, 3, 11])
def test_port_plan_merge_matches_jax(merge_upto):
    """``plan_merge`` is now one call of the word entry on ``l2[:k]`` of a
    deeper stack; its result is still the JAX package's."""
    e = _entries(merge_upto, 12, 200)
    jm, jf = jchain.plan_merge(jnp.asarray(e), merge_upto)
    before = dict(_build.LAUNCHES)
    tm, tf = tchain.plan_merge(tfmt.words(e), merge_upto)
    assert _build.LAUNCHES == before          # the CPU never launches
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).view(np.int32))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_ops_merge_entries_on_cpu_takes_the_plain_version():
    sub = tfmt.words(_entries(3, 5, 64))
    got = tops.merge_entries(sub)
    want = tref.merge_entries_ref(sub)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        tsm.merge_entries_cuda(sub)


@pytest.mark.parametrize("dtype,n,vec", [(torch.bool, 4096, 4),
                                         (torch.bool, 33, 1),
                                         (torch.int32, 4096, 4),
                                         (torch.int32, 102, 1)])
def test_planes_config_takes_what_fits_n(dtype, n, vec):
    """The planes entry's pages a thread divide N (4, else 1), with the
    plane aligned to their bytes; the layers a batch are fixed."""
    alloc = torch.zeros((3, n), dtype=dtype)
    assert tsm.planes_config(alloc) == (vec, tsm.PLANES_UNROLL)
    if vec == 4:
        # a view one page in is no longer aligned to 4 pages' bytes
        assert tsm.planes_config(alloc[:, 1:-3]) == (1, tsm.PLANES_UNROLL)
