"""The port's fleet chain-resolve kernels (K1 vanilla walk, K2 direct lookup)
against the JAX oracles and Pallas kernels, bit for bit.

On the CPU the port runs its plain versions (``test_torch_gpu.py`` holds the
CUDA kernels against them on the card).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import format as jfmt  # noqa: E402
from repro.kernels.chain_resolve import ref as jref  # noqa: E402
from repro.kernels.chain_resolve.chain_resolve import (  # noqa: E402
    resolve_direct_fleet_pallas, resolve_vanilla_fleet_pallas)
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_resolve import chain_resolve as tcr  # noqa: E402
from repro_torch.kernels.chain_resolve import ops as tops  # noqa: E402
from repro_torch.kernels.chain_resolve import ref as tref  # noqa: E402


def packed_stack(seed, t, c, p, density=0.5):
    """Random (T, C, P) word0/word1 stacks in the real entry layout, plus
    lengths covering 0 (a free or padded row) and C (a full chain)."""
    rng = np.random.default_rng(seed)
    e = np.asarray(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, 10_000, (t, c, p)).astype(np.uint32)),
        jnp.asarray(rng.integers(0, c, (t, c, p)).astype(np.uint32)),
        allocated=jnp.asarray(rng.random((t, c, p)) < density),
        bfi_valid=jnp.asarray(rng.random((t, c, p)) < 0.7),
        zero=jnp.asarray(rng.random((t, c, p)) < 0.1),
    ))
    lengths = rng.integers(0, c + 1, t).astype(np.int32)
    lengths[0], lengths[-1] = 0, c
    return e[..., 0], e[..., 1], lengths


def _i32(x):
    return np.asarray(x).astype(np.uint32).view(np.int32)


CASES = [(c, p) for c in (1, 7, 64) for p in (16, 128)]


@pytest.mark.parametrize("c,p", CASES)
def test_vanilla_fleet_matches_jax(c, p):
    w0, _, lengths = packed_stack(c * 1000 + p, 4, c, p)
    o_ref, h_ref = jref.resolve_vanilla_fleet_ref(jnp.asarray(w0), jnp.asarray(lengths))
    o_pal, h_pal = resolve_vanilla_fleet_pallas(jnp.asarray(w0), jnp.asarray(lengths),
                                                interpret=True)
    o, h = tref.resolve_vanilla_fleet_ref(tfmt.words(w0), torch.as_tensor(lengths))
    for want_o, want_h in ((o_ref, h_ref), (o_pal, h_pal)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(h.numpy(), _i32(want_h))


@pytest.mark.parametrize("c,p", CASES)
def test_direct_fleet_matches_jax(c, p):
    w0, w1, lengths = packed_stack(c * 1000 + p + 1, 4, c, p)
    want_ref = jref.resolve_direct_fleet_ref(jnp.asarray(w0), jnp.asarray(w1),
                                             jnp.asarray(lengths))
    want_pal = resolve_direct_fleet_pallas(jnp.asarray(w0), jnp.asarray(w1),
                                           jnp.asarray(lengths), interpret=True)
    got = tref.resolve_direct_fleet_ref(tfmt.words(w0), tfmt.words(w1),
                                        torch.as_tensor(lengths))
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), _i32(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), _i32(want[2]))


def test_direct_length_zero_wraps_to_last_layer():
    """JAX indexes the active layer with ``length - 1`` and wraps -1 to the
    last layer; the port reproduces the wrap instead of faulting."""
    c, p = 8, 16
    e = np.zeros((2, c, p, 2), np.uint32)
    e[0, c - 1, :, 0] = jfmt.FLAG_ALLOCATED | 5
    e[0, c - 1, :, 1] = jfmt.FLAG_BFI_VALID | 7
    lengths = np.array([0, 1], np.int32)
    want = jref.resolve_direct_fleet_ref(jnp.asarray(e[..., 0]), jnp.asarray(e[..., 1]),
                                         jnp.asarray(lengths))
    got = tops.resolve_direct_fleet(tfmt.words(e[..., 0]), tfmt.words(e[..., 1]),
                                    torch.as_tensor(lengths))
    assert np.asarray(want[0])[0, 0] == 7
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_cpu_dispatch_takes_the_plain_version():
    w0, w1, lengths = packed_stack(5, 3, 4, 16)
    before = dict(_build.LAUNCHES)
    a = tops.resolve_vanilla_fleet(tfmt.words(w0), torch.as_tensor(lengths))
    b = tref.resolve_vanilla_fleet_ref(tfmt.words(w0), torch.as_tensor(lengths))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _build.LAUNCHES == before          # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tcr.resolve_vanilla_fleet_cuda(tfmt.words(w0), torch.as_tensor(lengths))

