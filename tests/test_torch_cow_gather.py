"""The port's resolved-page gathers (K8 single-chain, K5 fleet) against the
JAX oracles and Pallas kernels (interpret mode), bit for bit.

On the CPU the port runs its plain versions (``test_torch_gpu.py`` holds
the CUDA kernel against them on the card). Unfound pages must come out as
+0.0 bit patterns, so every comparison is on the raw bytes.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.cow_gather import ref as jref  # noqa: E402
from repro.kernels.cow_gather.cow_gather import (  # noqa: E402
    gather_fleet_pallas, gather_pallas)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cow_gather import cow_gather as tcg  # noqa: E402
from repro_torch.kernels.cow_gather import ops as tops  # noqa: E402
from repro_torch.kernels.cow_gather import ref as tref  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _case(seed, rows, page, shape):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((rows, page)).astype(np.float32)
    # negative zeros in the pool must survive the copy as they are
    pool[0, :2] = -0.0
    idx = rng.integers(0, rows, shape).astype(np.int32)
    found = rng.random(shape) < 0.8
    return pool, idx, found


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,page", [(16, 128), (64, 256), (200, 512)])
def test_gather_matches_jax(jdt, tdt, rows, page):
    b = min(rows, 32)
    pool, idx, found = _case(rows + page, rows, page, (b,))
    jpool = jnp.asarray(pool).astype(jdt)
    want_ref = jref.gather_ref(jpool, jnp.asarray(idx), jnp.asarray(found))
    want_pal = gather_pallas(jpool, jnp.asarray(idx), jnp.asarray(found),
                             interpret=True)
    got = tref.gather_ref(torch.as_tensor(pool).to(tdt), torch.as_tensor(idx),
                          torch.as_tensor(found))
    assert got.dtype == tdt and tuple(got.shape) == (b, page)
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    assert not _bytes(got)[~found].any()          # +0.0 where not found


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,page,t,b", [(16, 128, 2, 8), (64, 256, 5, 17),
                                           (40, 4, 3, 1)])
def test_gather_fleet_matches_jax(jdt, tdt, rows, page, t, b):
    pool, idx, found = _case(rows * t + b, rows, page, (t, b))
    jpool = jnp.asarray(pool).astype(jdt)
    want_ref = jref.gather_fleet_ref(jpool, jnp.asarray(idx), jnp.asarray(found))
    want_pal = gather_fleet_pallas(jpool, jnp.asarray(idx), jnp.asarray(found),
                                   interpret=True)
    got = tops.gather_fleet(torch.as_tensor(pool).to(tdt), torch.as_tensor(idx),
                            torch.as_tensor(found))
    assert tuple(got.shape) == (t, b, page)
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(_bytes(got), _bytes(want))


def test_cpu_dispatch_takes_the_plain_version():
    pool, idx, found = _case(7, 12, 8, (3, 5))
    pool, idx, found = (torch.as_tensor(x) for x in (pool, idx, found))
    before = dict(_build.LAUNCHES)
    assert torch.equal(tops.gather(pool, idx[0], found[0]),
                       tref.gather_ref(pool, idx[0], found[0]))
    assert torch.equal(tops.gather_fleet(pool, idx, found),
                       tref.gather_fleet_ref(pool, idx, found))
    assert _build.LAUNCHES == before          # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tcg.gather_cuda(pool, idx[0], found[0])
    with pytest.raises(ValueError, match="CUDA"):
        tcg.gather_fleet_cuda(pool, idx, found)
    with pytest.raises(ValueError, match="CUDA"):
        tcg.gather_fleet_resolved_cuda(pool, idx, found, found, found)


# page bytes -> the kernel variant the wrapper picks (loads a lane a round,
# warps a page): odd sizes beside the system's 8, 16 and 64 KiB pages
PICKS = {2: "u1g1", 3: "u1g1", 16: "u1g1", 100: "u1g1", 511: "u1g1",
         512: "u1g1", 513: "u2g1", 1029: "u4g1", 2_048: "u4g1",
         4_096: "u4g2", 8_192: "u4g4", 8_193: "u8g4", 16_384: "u4g8",
         65_536: "u16g8", 65_537: "u16g8", 1 << 20: "u16g8"}


@pytest.mark.parametrize("page", sorted(PICKS))
def test_gather_variant_from_shape(page):
    """The kernel's variant from the page bytes alone: it takes an int,
    so it can read no tensor data, and the batch cannot move it."""
    assert tcg.gather_variant(page).name == PICKS[page]


def test_gather_variant_at_the_systems_shapes():
    """The picks at the main path's page sizes: the checkpoint chain's
    8 KiB pages, the disk's and the fleet's 64 KiB clusters, and a tiny
    page; between them they reach every instantiation of the kernel."""
    assert tcg.gather_variant(8_192).name == "u4g4"
    assert tcg.gather_variant(16_384).name == "u4g8"
    assert tcg.gather_variant(65_536).name == "u16g8"
    assert tcg.gather_variant(2).name == "u1g1"
    assert {tcg.gather_variant(p).units for p in PICKS} == set(tcg._UNITS)


def _leaves(seed, rows, t, b, kind):
    """A resolve's (T, B) leaves in the batch entry's layout (``ptr`` a
    plane of (3, T, B) int32 words, found/zero/cold the planes of (3, T, B)
    bool flags) over a pool of ``rows`` rows: every page found (``found``),
    found and ZERO (``zero``), found and COLD with host-tier rows
    (``cold``), missed with garbage or out-of-range ptrs (``miss``), or a
    mix of all four (``mixed``)."""
    rng = np.random.default_rng(seed)
    words = torch.as_tensor(rng.integers(0, rows, (3, t, b)).astype(np.int32))
    flags = torch.zeros((3, t, b), dtype=torch.bool)
    found, zero, cold = flags.unbind()
    ptr = words[1]
    draw = lambda q: torch.as_tensor(rng.random((t, b)) < q)
    found.copy_({"found": draw(1.0), "zero": draw(1.0), "cold": draw(1.0),
                 "miss": draw(0.0), "mixed": draw(0.7)}[kind])
    zero.copy_(found & draw({"zero": 1.0, "mixed": 0.2}.get(kind, 0.0)))
    cold.copy_(found & draw({"cold": 1.0, "mixed": 0.2}.get(kind, 0.0)))
    # a page not read from the pool may carry any ptr: far past the pool,
    # negative, or a host-tier row
    far = torch.as_tensor(rng.integers(-(1 << 20), 1 << 28, (t, b)).astype(np.int32))
    ptr.copy_(torch.where(found & ~zero & ~cold, ptr, far))
    return ptr, found, zero, cold


@pytest.mark.parametrize("kind", ["found", "zero", "cold", "miss", "mixed"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_fleet_resolved_is_the_fleet_gather_of_readable_rows(kind, tdt):
    """K5's entry on a resolve's leaves (its plain version, which ``ops``
    takes on the CPU) reads exactly the pages ``store.readable_rows``
    marks, bit for bit ``gather_fleet_ref`` of them: found pages from the
    pool, ZERO and COLD pages and misses (whatever their ``ptr``) as +0.0."""
    from repro_torch.core.resolve import ResolveResult
    from repro_torch.core.store import readable_rows

    rows, t, b = 40, 3, 17
    pool, _, _ = _case(len(kind) + rows, rows, 24, (1,))
    pool = torch.as_tensor(pool).to(tdt)
    ptr, found, zero, cold = _leaves(len(kind), rows, t, b, kind)
    res = ResolveResult(owner=ptr, ptr=ptr, found=found, zero=zero,
                        lookups=ptr, cold=cold)
    before = dict(_build.LAUNCHES)
    got = tops.gather_fleet_resolved(pool, ptr, found, zero, cold)
    want = tref.gather_fleet_ref(pool, *readable_rows(res))
    assert _build.LAUNCHES == before
    assert got.dtype == tdt and tuple(got.shape) == (t, b, 24)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    np.testing.assert_array_equal(
        _bytes(got), _bytes(tref.gather_fleet_resolved_ref(pool, ptr, found, zero, cold)))
    readable = found & ~zero & ~cold
    assert not _bytes(got)[~readable.numpy()].any()
    if kind == "mixed":
        assert bool(readable.any()) and not bool(readable.all())
    else:
        assert bool((readable == (kind == "found")).all())


def test_resolved_entry_keeps_k5s_name_and_counter():
    """The benchmark's layer map (``snapbench/layers/gather.json``) puts a
    kernel in the gather layer by a substring of its name and checks a
    trace's completeness by matching K5's launch counter to it. Both entries
    of ``csrc/cow_gather.cu`` launch the one kernel that carries it, and the
    entry on a resolve's leaves counts its launch under K5's counter and
    under its own key."""
    import inspect
    import json
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    layer = json.loads((root / "snapbench" / "layers" / "gather.json").read_text())
    source = (root / "src" / "repro_torch" / "csrc" / "cow_gather.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\)\s+)?(\w+)", source)
    assert kernels == ["gather_pages_kernel"]
    assert layer["launches"]["gather_fleet"] == "gather_pages_kernel"
    assert re.findall(r'extern "C" int (\w+)', source) == ["cow_gather", "cow_gather_resolved"]
    assert 'check_launch("gather_fleet", code, entry=RESOLVED_ENTRY)' in inspect.getsource(
        tcg.gather_fleet_resolved_cuda)
    assert tcg.RESOLVED_ENTRY in _build.LAUNCHES
