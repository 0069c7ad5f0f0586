"""The port's L2 entry format against ``repro.core.format``, word for word."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import format as jfmt  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402


def _fields(rng, n):
    return dict(
        # past the 28-bit field too, so the masking is exercised
        ptr=rng.integers(0, 1 << 30, size=n, dtype=np.int64),
        bfi=rng.integers(0, 1 << 18, size=n, dtype=np.int64),
        allocated=rng.random(n) < 0.7,
        bfi_valid=rng.random(n) < 0.5,
        zero=rng.random(n) < 0.2,
        cold=rng.random(n) < 0.2,
    )


def _both(f):
    j = np.asarray(jfmt.pack_entry(
        jnp.asarray(f["ptr"].astype(np.uint32)), jnp.asarray(f["bfi"].astype(np.uint32)),
        allocated=f["allocated"], bfi_valid=f["bfi_valid"], zero=f["zero"],
        cold=f["cold"]))
    t = tfmt.pack_entry(
        torch.as_tensor(f["ptr"]), torch.as_tensor(f["bfi"]),
        allocated=torch.as_tensor(f["allocated"]),
        bfi_valid=torch.as_tensor(f["bfi_valid"]),
        zero=torch.as_tensor(f["zero"]), cold=torch.as_tensor(f["cold"]))
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_entry_word_for_word(seed):
    j, t = _both(_fields(np.random.default_rng(seed), 512))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
    # bit 31 (ALLOCATED) and bit 16 (BFI_VALID) really occur in the sample
    assert (t[..., 0] < 0).any() and ((t[..., 1] & tfmt.FLAG_BFI_VALID) != 0).any()


@pytest.mark.parametrize("accessor", ["entry_ptr", "entry_allocated", "entry_zero",
                                      "entry_cold", "entry_bfi", "entry_bfi_valid"])
def test_field_accessors_match(accessor):
    j, _ = _both(_fields(np.random.default_rng(7), 512))
    want = np.asarray(getattr(jfmt, accessor)(jnp.asarray(j)))
    got = getattr(tfmt, accessor)(tfmt.words(j)).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def test_words_round_trip_and_constants():
    raw = np.array([0, jfmt.FLAG_ALLOCATED | 5, 0xFFFFFFFF, jfmt.FLAG_BFI_VALID],
                   np.uint32)
    w = tfmt.words(raw)
    np.testing.assert_array_equal(w.numpy().view(np.uint32), raw)
    for name in ("PTR_MASK", "FLAG_ENCRYPTED", "FLAG_COLD", "FLAG_ZERO",
                 "FLAG_ALLOCATED", "BFI_MASK", "FLAG_BFI_VALID"):
        assert getattr(tfmt, name) == getattr(jfmt, name), name
    assert tfmt.FLAG_ALLOCATED_I32 == np.uint32(jfmt.FLAG_ALLOCATED).view(np.int32)
    assert tfmt.to_i32(jfmt.FLAG_ALLOCATED | 5) == int(
        np.uint32(jfmt.FLAG_ALLOCATED | 5).view(np.int32))


def test_cuda_macros_carry_the_layout():
    macros = dict(m[2:].split("=") for m in tfmt.cuda_macros())
    assert int(macros["FMT_FLAG_ALLOCATED"].rstrip("u"), 16) == jfmt.FLAG_ALLOCATED
    assert int(macros["FMT_PTR_MASK"].rstrip("u"), 16) == jfmt.PTR_MASK
    assert int(macros["FMT_BFI_MASK"].rstrip("u"), 16) == jfmt.BFI_MASK


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(
    ptr=st.integers(0, (1 << 32) - 1), bfi=st.integers(0, (1 << 32) - 1),
    allocated=st.booleans(), bfi_valid=st.booleans(), zero=st.booleans(),
    cold=st.booleans())
def test_pack_entry_property(ptr, bfi, allocated, bfi_valid, zero, cold):
    f = dict(ptr=np.array([ptr], np.int64), bfi=np.array([bfi], np.int64),
             allocated=np.array([allocated]), bfi_valid=np.array([bfi_valid]),
             zero=np.array([zero]), cold=np.array([cold]))
    j, t = _both(f)
    np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
