"""The port's chain-resolve kernels (K1/K2 fleet walk and direct lookup, K1's
batch entry, K6/K7 single-chain walk and direct lookup) against the JAX
oracles and Pallas kernels, bit for bit.

On the CPU the port runs its plain versions (``test_torch_gpu.py`` holds the
CUDA kernels against them on the card).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import fleet as jfleet  # noqa: E402
from repro.core import format as jfmt  # noqa: E402
from repro.core import resolve as jresolve  # noqa: E402
from repro.kernels.chain_resolve import ref as jref  # noqa: E402
from repro.kernels.chain_resolve.chain_resolve import (  # noqa: E402
    resolve_direct_fleet_pallas, resolve_direct_pallas,
    resolve_vanilla_fleet_pallas, resolve_vanilla_pallas)
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.core import resolve as tres  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_resolve import chain_resolve as tcr  # noqa: E402
from repro_torch.kernels.chain_resolve import ops as tops  # noqa: E402
from repro_torch.kernels.chain_resolve import ref as tref  # noqa: E402
from repro_torch.kernels.stream_merge import stream_merge as tsm  # noqa: E402


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



@pytest.mark.parametrize("c,p", [(1, 16), (7, 33), (64, 128)])
def test_vanilla_fleet_on_strided_words_matches_jax(c, p):
    """``ops.resolve_vanilla_fleet`` on the strided ``l2[..., 0]`` view of
    the packed (T, C, P, 2) words (what ``resolve_vanilla_stacked`` now
    passes, with no plane copy) against the Pallas kernel in interpret mode
    on the same words; a length-0 tenant and a full chain ride along."""
    w0, w1, lengths = packed_stack(c * 100 + p + 7, 5, c, p)
    l2 = torch.stack([tfmt.words(w0), tfmt.words(w1)], dim=-1)
    view = l2[..., 0]
    assert not view.is_contiguous() and tcr.word0_stride(view) == 2
    o_pal, h_pal = resolve_vanilla_fleet_pallas(jnp.asarray(w0), jnp.asarray(lengths),
                                                interpret=True)
    before = dict(_build.LAUNCHES)
    o, h = tops.resolve_vanilla_fleet(view, torch.as_tensor(lengths))
    assert _build.LAUNCHES == before
    assert lengths[0] == 0 and lengths[-1] == c
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_pal))
    np.testing.assert_array_equal(h.numpy(), _i32(h_pal))


def test_vanilla_fleet_wrapper_refuses_other_layouts():
    """The CUDA wrapper takes a contiguous (T, C, P) plane or the
    ``l2[..., 0]`` view of contiguous words, and raises on any other view
    before it looks at the device."""
    l2 = torch.zeros((3, 4, 8, 2), dtype=torch.int32)
    lengths = torch.full((3,), 4, dtype=torch.int32)
    assert tcr.word0_stride(l2[..., 0].contiguous()) == 1
    assert tcr.word0_stride(l2[..., 0]) == 2
    assert tcr.word0_stride(l2[1:2, ..., 0]) == 2      # a one-tenant view
    for bad in (l2[:, :3, :, 0], l2[:, :, ::2, 0], l2[..., 0].transpose(1, 2),
                l2.transpose(0, 1)[..., 0]):
        with pytest.raises(ValueError, match="strides"):
            tcr.resolve_vanilla_fleet_cuda(bad, lengths[:bad.shape[0]])
    with pytest.raises(ValueError, match="CUDA"):
        tcr.resolve_vanilla_fleet_cuda(l2[..., 0], lengths)


@pytest.mark.parametrize("c,p", [(1, 16), (7, 33), (64, 128)])
def test_direct_fleet_on_strided_words_matches_jax(c, p):
    """``ops.resolve_direct_fleet`` on the ``l2[..., 0]``/``l2[..., 1]``
    views of the packed (T, C, P, 2) words (what ``resolve_direct_stacked``
    now passes, with no plane copy) against the Pallas kernel in interpret
    mode and the JAX oracle, bit for bit; a length-0 tenant (it wraps to
    layer C-1) and a full chain ride along, and no kernel is launched."""
    w0, w1, lengths = packed_stack(c * 100 + p + 11, 5, c, p)
    l2 = torch.stack([tfmt.words(w0), tfmt.words(w1)], dim=-1)
    v0, v1 = l2[..., 0], l2[..., 1]
    assert not v0.is_contiguous()
    assert tcr.direct_fleet_stride(v0, v1) == 2
    args = [jnp.asarray(x) for x in (w0, w1, lengths)]
    want_ref = jref.resolve_direct_fleet_ref(*args)
    want_pal = resolve_direct_fleet_pallas(*args, interpret=True)
    before = dict(_build.LAUNCHES)
    got = tops.resolve_direct_fleet(v0, v1, torch.as_tensor(lengths))
    assert _build.LAUNCHES == before
    assert lengths[0] == 0 and lengths[-1] == c
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), _i32(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), _i32(want[2]))


def test_direct_fleet_wrapper_refuses_other_layouts():
    """K2's CUDA wrapper takes two contiguous planes or the ``l2[..., 0]``/
    ``l2[..., 1]`` pair of contiguous words, and raises on any other pair
    before it looks at the device."""
    l2 = torch.zeros((3, 4, 8, 2), dtype=torch.int32)
    other = torch.zeros_like(l2)
    lengths = torch.full((3,), 4, dtype=torch.int32)
    shifted = torch.zeros(l2.numel() + 1, dtype=torch.int32)[1:].view(l2.shape)
    assert shifted.data_ptr() % 8 == 4                 # an odd storage offset
    for bad in ((l2[..., 0], other[..., 1]),           # views of two tensors
                (l2[..., 1], l2[..., 0]),              # swapped words
                (l2[..., 0].contiguous(), l2[..., 1]),  # a plane with a view
                (l2[..., 0], l2[..., 1].contiguous()),
                (shifted[..., 0], shifted[..., 1]),    # misaligned base
                (l2[:, :3, :, 0], l2[:, :3, :, 1])):   # not a whole layer
        with pytest.raises(ValueError, match="layout|strides"):
            tcr.resolve_direct_fleet_cuda(*bad, lengths)
    for good in ((l2[..., 0], l2[..., 1]),
                 (l2[..., 0].contiguous(), l2[..., 1].contiguous())):
        with pytest.raises(ValueError, match="CUDA"):
            tcr.resolve_direct_fleet_cuda(*good, lengths)


def test_direct_fleet_layout_is_picked_from_shape_and_pointer():
    """K2's layout is read off strides and ``data_ptr`` alone: 1 for two
    contiguous planes (at any 4-byte offset), 2 for the packed words,
    a one-tenant slice ``l2[t:t + 1]`` (8·C·P·t bytes past the base, so
    8-byte aligned at every t, 16-byte aligned only where C·P·t is even)
    included."""
    l2 = torch.zeros((4, 3, 5, 2), dtype=torch.int32)      # C·P odd
    assert tcr.direct_fleet_stride(l2[..., 0], l2[..., 1]) == 2
    for t in range(4):
        assert tcr.direct_fleet_stride(l2[t:t + 1, ..., 0],
                                       l2[t:t + 1, ..., 1]) == 2
    planes = torch.zeros((2, 4, 3, 6), dtype=torch.int32)
    assert tcr.direct_fleet_stride(planes[0], planes[1]) == 1
    assert tcr.direct_fleet_stride(planes.view(-1)[1:73].view(4, 3, 6),
                                   planes[1]) == 1


@pytest.mark.parametrize("n_pages,t", [(33, 1), (32, 1), (32, 2)])
def test_fleet_read_pallas_direct_on_a_tenant_slice(n_pages, t):
    """``fleet.read(method="pallas_direct")`` on a one-tenant view whose
    l2 is ``l2[t:t + 1]`` (as ``PagedKVCache._resolve_tenant`` builds it;
    8·C·P·t bytes past the base: 8-byte aligned, 16-byte aligned only
    when C·P·t is even) reads as tenant t of the JAX fleet, bit for bit."""
    kw = dict(n_tenants=3, n_pages=n_pages, page_size=4, max_chain=7,
              pool_capacity=1024, lease_quantum=8, l2_per_table=n_pages,
              slice_len=1)
    jf = jfleet.create(jfleet.FleetSpec(dtype=jnp.float32, **kw))
    tf = tfleet.create(tfleet.FleetSpec(dtype=torch.float32, **kw), device="cpu")
    rng = np.random.default_rng(n_pages + t)
    for layer in range(5):
        ids = np.stack([rng.choice(n_pages, 6, replace=False)
                        for _ in range(3)]).astype(np.int32)
        data = rng.standard_normal((3, 6, 4)).astype(np.float32)
        jf = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data))
        tf = tfleet.write(tf, torch.as_tensor(ids), torch.as_tensor(data))
        if layer < 4:
            jf, tf = jfleet.snapshot(jf), tfleet.snapshot(tf)
    grid = np.broadcast_to(np.arange(n_pages, dtype=np.int32), (3, n_pages))
    jd, jres = jfleet.read(jf, jnp.asarray(grid), method="pallas_direct")
    per_tenant = ("l1", "l2", "lease_index", "lease_count", "alloc_count",
                  "length", "scalable", "overflow", "snap_dropped", "cold_count")
    view = dataclasses.replace(
        tf, spec=dataclasses.replace(tf.spec, n_tenants=1),
        **{f: getattr(tf, f)[t:t + 1] for f in per_tenant})
    assert tcr.direct_fleet_stride(view.l2[..., 0], view.l2[..., 1]) == 2
    td, tres = tfleet.read(view, torch.as_tensor(grid[t:t + 1].copy()),
                           method="pallas_direct")
    np.testing.assert_array_equal(td.numpy()[0].view(np.uint32),
                                  np.asarray(jd)[t].view(np.uint32))
    for field, w, g in zip(jres._fields, jres, tres):
        want = np.asarray(w)[t]
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(g.numpy()[0], want, err_msg=field)
    assert bool(tres.found.any())


def test_fleet_walk_is_picked_from_the_shape():
    """A warp a page at the decode state's few pages, a thread a page at a
    fleet read's million."""
    assert tcr.fleet_walk(8, 128) == "warp"
    assert tcr.fleet_walk(64, 16_384) == "thread"
    assert tcr.fleet_walk(1, tcr.WARP_WALK_MAX_PAGES) == "warp"
    assert tcr.fleet_walk(1, tcr.WARP_WALK_MAX_PAGES + 1) == "thread"


@pytest.mark.parametrize("c,n", [(1, 128), (4, 256), (16, 640), (64, 128)])
@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
def test_vanilla_single_chain_matches_jax(c, n, density):
    rng = np.random.default_rng(c * n + int(density * 100))
    alloc = (rng.random((c, n)) < density).astype(np.uint32)
    ptrs = rng.integers(0, 10_000, (c, n)).astype(np.uint32)
    for length in sorted({1, c // 2 or 1, c}):
        o_ref, p_ref = jref.resolve_vanilla_ref(jnp.asarray(alloc), jnp.asarray(ptrs),
                                                length)
        o_pal, p_pal = resolve_vanilla_pallas(jnp.asarray(alloc), jnp.asarray(ptrs),
                                              length, interpret=True)
        # the port takes the allocation map as int32 or bool
        for a in (tfmt.words(alloc), torch.as_tensor(alloc != 0)):
            o, p = tops.resolve_vanilla(a, tfmt.words(ptrs), length)
            for want_o, want_p in ((o_ref, p_ref), (o_pal, p_pal)):
                np.testing.assert_array_equal(o.numpy(), np.asarray(want_o))
                np.testing.assert_array_equal(p.numpy(), _i32(want_p))


def test_vanilla_single_chain_length_beyond_chain():
    """A length past C reads every layer (layers >= C do not exist), as the
    JAX oracle does; a length of 0 finds nothing."""
    rng = np.random.default_rng(4)
    alloc = (rng.random((6, 32)) < 0.3).astype(np.uint32)
    ptrs = rng.integers(0, 500, (6, 32)).astype(np.uint32)
    for length in (0, 6, 9, 100):
        o_ref, p_ref = jref.resolve_vanilla_ref(jnp.asarray(alloc), jnp.asarray(ptrs),
                                                length)
        o, p = tref.resolve_vanilla_ref(tfmt.words(alloc), tfmt.words(ptrs),
                                        torch.tensor(length))
        np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
        np.testing.assert_array_equal(p.numpy(), _i32(p_ref))


@pytest.mark.parametrize("n", [128, 384, 1024])
def test_direct_single_chain_matches_jax(n):
    rng = np.random.default_rng(n)
    alloc = (rng.random(n) < 0.6).astype(np.uint32)
    bfi = rng.integers(0, 500, n).astype(np.uint32)
    ptrs = rng.integers(0, 10_000, n).astype(np.uint32)
    args = [jnp.asarray(x) for x in (alloc, bfi, ptrs)]
    o_ref, p_ref = jref.resolve_direct_ref(*args)
    o_pal, p_pal = resolve_direct_pallas(*args, interpret=True)
    for a in (tfmt.words(alloc), torch.as_tensor(alloc != 0)):
        o, p = tops.resolve_direct(a, tfmt.words(bfi), tfmt.words(ptrs))
        for want_o, want_p in ((o_ref, p_ref), (o_pal, p_pal)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(want_o))
            np.testing.assert_array_equal(p.numpy(), _i32(want_p))


def test_single_chain_cpu_dispatch_takes_the_plain_version():
    rng = np.random.default_rng(8)
    alloc = torch.as_tensor(rng.random((4, 16)) < 0.5)
    ptrs = torch.as_tensor(rng.integers(0, 99, (4, 16)).astype(np.int32))
    before = dict(_build.LAUNCHES)
    a = tops.resolve_vanilla(alloc, ptrs, 3)
    b = tref.resolve_vanilla_ref(alloc, ptrs, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = tops.resolve_direct(alloc[0], ptrs[1], ptrs[2])
    b = tref.resolve_direct_ref(alloc[0], ptrs[1], ptrs[2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tcr.resolve_vanilla_cuda(alloc, ptrs, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tcr.resolve_direct_cuda(alloc[0], ptrs[1], ptrs[2])


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("n,offset,vec", [(4_096, 0, 4), (4_113, 0, 1),
                                          (4_096, 1, 1)])
def test_single_chain_pages_a_thread_pick(dtype, n, offset, vec):
    """K6 takes K9's planes pick: 4 pages a thread where 4 divides N and
    the map is aligned to 4 entries' bytes; 1 for N = 4,113 and for a view
    one entry past an aligned base. A batch holds 32 words of loads: 8
    layers of 4 int32 pages, 32 layers otherwise."""
    c = 7
    buf = torch.zeros(c * n + 4, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    alloc = buf[offset:offset + c * n].view(c, n)
    unroll = 8 if (vec, dtype) == (4, torch.int32) else 32
    assert tcr.vanilla_config(alloc) == (vec, unroll)
    assert tcr.vanilla_config(alloc)[0] == tsm.planes_config(alloc)[0]


# -- the batch entry: the auto resolve of a read's (T, B) pages ---------------


def mixed_image(seed, t, c, p, *, all_zero_holes=True):
    """(T, C, P, 2) packed words of a mixed image: trusted entries
    (ALLOCATED + BFI_VALID), allocated ones a vanilla tool wrote (no
    BFI_VALID), holes, ZERO and COLD clusters, and lengths with a length-0
    tenant (its active layer wraps to C-1) and a full chain (length C).
    In every tenant pages 0-2 are held by no layer, every layer holds
    pages 3 (ZERO) and 4 (COLD). With
    ``all_zero_holes`` an unallocated entry is all zeros, as the format
    has it; without, it carries random pointer and flag bits."""
    rng = np.random.default_rng(seed)
    shape = (t, c, p)
    alloc = rng.random(shape) < 0.3
    alloc[:, :, :3] = False
    zero, cold = rng.random(shape) < 0.1, rng.random(shape) < 0.1
    alloc[:, :, 3:5] = zero[:, :, 3] = cold[:, :, 4] = True
    e = np.array(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, 1 << 20, shape).astype(np.uint32)),
        jnp.asarray(rng.integers(0, c, shape).astype(np.uint32)),
        allocated=jnp.asarray(alloc),
        bfi_valid=jnp.asarray(rng.random(shape) < 0.6),
        zero=jnp.asarray(zero), cold=jnp.asarray(cold)))
    if all_zero_holes:
        e = np.where(alloc[..., None], e, np.uint32(0))
    lengths = rng.integers(1, c + 1, t).astype(np.int32)
    lengths[0], lengths[-1] = 0, c
    if t > 1:
        # the length-0 tenant's wrapped active layer holds trusted entries
        e[0, c - 1, :, 0] |= np.uint32(jfmt.FLAG_ALLOCATED)
        e[0, c - 1, :, 1] |= np.uint32(jfmt.FLAG_BFI_VALID)
    return e, lengths


def batch_ids(kind, seed, t, p, b):
    """(T, B) int32 page ids: drawn with replacement (duplicates within a
    row), one row expanded over the tenants (row stride 0), or every page
    (B = P, as ``fleet.materialize`` reads)."""
    rng = np.random.default_rng(seed)
    if kind == "drawn":
        return torch.as_tensor(rng.integers(0, p, (t, b)).astype(np.int32))
    if kind == "expanded":
        return torch.as_tensor(rng.integers(0, p, b).astype(np.int32))[None].expand(t, -1)
    assert kind == "every" and b == p
    return torch.arange(p, dtype=torch.int32)[None].expand(t, -1)


def _as_torch(e, lengths):
    return torch.as_tensor(e.view(np.int32)), torch.as_tensor(lengths)


def _jax_result(res):
    return [np.asarray(x).view(np.int32) if np.asarray(x).dtype == np.uint32
            else np.asarray(x) for x in res]


AUTO_CASES = [(4, 7, 128, 24, "drawn"), (5, 64, 16, 40, "drawn"),
              (3, 9, 128, 33, "expanded"), (4, 6, 128, 128, "every"),
              (2, 1, 16, 16, "every"), (6, 20, 33, 7, "expanded")]


@pytest.mark.parametrize("t,c,p,b,kind", AUTO_CASES)
def test_auto_batch_matches_the_auto_resolvers(t, c, p, b, kind):
    """The batch entry's plain version (the CPU's path of
    ``resolve_auto_stacked``) against the port's ``resolve_auto_tables``
    and the JAX package's ``resolve_auto_stacked`` (Pallas kernels in
    interpret mode) and vmapped ``resolve_auto_tables``, leaf for leaf,
    on a mixed image whose unallocated entries are all zeros. The one
    leaf the table helpers give otherwise, ``ptr`` on a miss (layer 0's
    pointer bits where the stacked resolvers give 0), is compared where
    found and pinned to 0 elsewhere."""
    e, lengths = mixed_image(t * 100 + c + p, t, c, p)
    l2, lens = _as_torch(e, lengths)
    ids = batch_ids(kind, t + p + b, t, p, b)
    before = dict(_build.LAUNCHES)
    got = tres.resolve_auto_stacked(l2, lens, ids)
    assert _build.LAUNCHES == before               # the plain version
    want_tables = tres.resolve_auto_tables(l2, lens, ids)
    jargs = (jnp.asarray(e), jnp.asarray(lengths), jnp.asarray(ids.numpy()))
    want_pallas = _jax_result(jresolve.resolve_auto_stacked(*jargs))
    want_jtables = _jax_result(jax.vmap(jresolve.resolve_auto_tables)(*jargs))
    found = got.found.numpy()
    trusted = tres.resolve_direct_tables(l2, lens, ids).found.numpy()
    walked_hit = found & ~trusted
    assert found.any() and (~found).any() and trusted.any() and walked_hit.any()
    assert got.zero.any() and got.cold.any()
    for field, g, wt, wp, wj in zip(got._fields, got, want_tables, want_pallas,
                                    want_jtables):
        np.testing.assert_array_equal(g.numpy(), wp, err_msg=field)
        if field == "ptr":
            for w in (wt.numpy(), wj):
                np.testing.assert_array_equal(g.numpy()[found], w[found])
            assert not g.numpy()[~found].any()
        else:
            np.testing.assert_array_equal(g.numpy(), wt.numpy(), err_msg=field)
            np.testing.assert_array_equal(g.numpy(), wj, err_msg=field)


@pytest.mark.parametrize("t,c,p,b,kind", AUTO_CASES)
def test_auto_batch_is_the_whole_map_pick_on_any_words(t, c, p, b, kind):
    """On words whose unallocated entries carry random bits, the batch
    entry's plain version still equals ``combine_auto`` over the whole-map
    resolvers (K2's and K1's plain versions, then the batch's takes),
    every leaf, as the CUDA kernel must."""
    e, lengths = mixed_image(t * 7 + c + p, t, c, p, all_zero_holes=False)
    l2, lens = _as_torch(e, lengths)
    ids = batch_ids(kind, t * 3 + p + b, t, p, b)
    got = tops.resolve_auto_batch(l2, lens, ids)
    direct = tres.resolve_direct_stacked(l2, lens, ids)
    want = tres.combine_auto(direct.found, direct,
                             tres.resolve_vanilla_stacked(l2, lens, ids))
    for field, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype, field
        assert torch.equal(g, w), field


@pytest.mark.parametrize("t", [0, 1, 3])
def test_auto_batch_on_a_tenant_slice(t):
    """The batch entry on a one-tenant view ``l2[t:t + 1]`` (as
    ``PagedKVCache._resolve_tenant`` builds it) reads as row t of the
    whole fleet's resolve."""
    e, lengths = mixed_image(41, 4, 6, 128)
    l2, lens = _as_torch(e, lengths)
    ids = batch_ids("drawn", 42, 4, 128, 30)
    whole = tres.resolve_auto_stacked(l2, lens, ids)
    view = l2[t:t + 1]
    assert tcr.direct_fleet_stride(view[..., 0], view[..., 1]) == 2
    part = tres.resolve_auto_stacked(view, lens[t:t + 1], ids[t:t + 1])
    for field, a, b in zip(whole._fields, whole, part):
        assert torch.equal(a[t:t + 1], b), field


@pytest.mark.parametrize("n_pages,t", [(128, 0), (128, 2)])
def test_fleet_read_auto_on_a_tenant_slice(n_pages, t):
    """``fleet.read(method="auto")`` on a one-tenant view (the batch
    entry's path on the CPU: ``n_pages`` a multiple of 128) reads as
    tenant t of the JAX fleet's auto read, bit for bit."""
    kw = dict(n_tenants=3, n_pages=n_pages, page_size=4, max_chain=7,
              pool_capacity=1024, lease_quantum=8, l2_per_table=n_pages,
              slice_len=1)
    scal = np.array([True, False, True])
    jf = jfleet.create(jfleet.FleetSpec(dtype=jnp.float32, **kw),
                       scalable=jnp.asarray(scal))
    tf = tfleet.create(tfleet.FleetSpec(dtype=torch.float32, **kw),
                       scalable=scal, device="cpu")
    rng = np.random.default_rng(n_pages + t)
    for layer in range(5):
        ids = np.stack([rng.choice(n_pages, 6, replace=False)
                        for _ in range(3)]).astype(np.int32)
        data = rng.standard_normal((3, 6, 4)).astype(np.float32)
        jf = jfleet.write(jf, jnp.asarray(ids), jnp.asarray(data))
        tf = tfleet.write(tf, torch.as_tensor(ids), torch.as_tensor(data))
        if layer < 4:
            jf, tf = jfleet.snapshot(jf), tfleet.snapshot(tf)
    grid = np.broadcast_to(np.arange(n_pages, dtype=np.int32), (3, n_pages))
    jd, jres_ = jfleet.read(jf, jnp.asarray(grid), method="auto")
    per_tenant = ("l1", "l2", "lease_index", "lease_count", "alloc_count",
                  "length", "scalable", "overflow", "snap_dropped", "cold_count")
    view = dataclasses.replace(
        tf, spec=dataclasses.replace(tf.spec, n_tenants=1),
        **{f: getattr(tf, f)[t:t + 1] for f in per_tenant})
    td, tres_ = tfleet.read(view, torch.as_tensor(grid[t:t + 1].copy()), method="auto")
    np.testing.assert_array_equal(td.numpy()[0].view(np.uint32),
                                  np.asarray(jd)[t].view(np.uint32))
    for field, w, g in zip(jres_._fields, jres_, tres_):
        want = np.asarray(w)[t]
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(g.numpy()[0], want, err_msg=field)
    assert bool(tres_.found.any())


def test_auto_batch_wrapper_refuses_other_layouts():
    """The CUDA wrapper takes contiguous (T, C, P, 2) int32 words on an
    8-byte boundary and (T, B) int32 ids, and raises on anything else (a
    view of the words, one word plane, a misaligned base, int64 words or
    ids, ids that are not (T, B)) before it looks at the device."""
    l2 = torch.zeros((3, 4, 8, 2), dtype=torch.int32)
    lengths = torch.full((3,), 4, dtype=torch.int32)
    ids = torch.zeros((3, 5), dtype=torch.int32)
    flat = torch.zeros(l2.numel() + 2, dtype=torch.int32)
    for bad in (l2[:, :3], l2[..., :1], l2[..., 0], l2.transpose(1, 2),
                flat[1:-1].view(l2.shape)):
        with pytest.raises(ValueError, match="layout|words"):
            tcr.resolve_auto_batch_cuda(bad, lengths, ids)
    for bad in ((l2.long(), ids), (l2, ids.long())):
        with pytest.raises(TypeError, match="int32"):
            tcr.resolve_auto_batch_cuda(bad[0], lengths, bad[1])
    for bad_ids in (ids[0], ids[None]):
        with pytest.raises(ValueError, match="ids"):
            tcr.resolve_auto_batch_cuda(l2, lengths, bad_ids)


def test_auto_batch_wrapper_takes_a_tenant_slice_and_ids_at_any_strides():
    """The words of a one-tenant slice ``l2[t:t + 1]`` and of an aligned
    base past the start of a buffer, and ids as columns apart, a
    transposed store or an expanded row, pass every check the wrapper
    makes before the device's."""
    l2 = torch.zeros((3, 4, 8, 2), dtype=torch.int32)
    lengths = torch.full((3,), 4, dtype=torch.int32)
    ids = torch.zeros((3, 5), dtype=torch.int32)
    flat = torch.zeros(l2.numel() + 2, dtype=torch.int32)
    for good in ((l2, lengths, ids), (l2[1:2], lengths[1:2], ids[1:2]),
                 (flat[2:].view(l2.shape), lengths, ids),
                 (l2, lengths, ids[:1].expand(3, -1)),
                 (l2, lengths, torch.zeros((5, 3), dtype=torch.int32).t()),
                 (l2, lengths, torch.zeros((3, 10), dtype=torch.int32)[:, ::2])):
        with pytest.raises(ValueError, match="CUDA"):
            tcr.resolve_auto_batch_cuda(*good)


@pytest.mark.parametrize("bad", [-1, 8, 2**31 - 1])
def test_auto_batch_plain_version_refuses_ids_outside_the_map(bad):
    """A page id outside [0, P) is an error, never another page's answer:
    the plain version and the CPU's ``resolve_auto_stacked`` raise (the
    kernel traps, ``tests/test_torch_gpu.py``)."""
    l2, lengths = _as_torch(*mixed_image(5, 3, 4, 8))
    ids = torch.zeros((3, 5), dtype=torch.int32)
    ids[1, 3] = bad
    with pytest.raises((IndexError, RuntimeError)):
        tref.resolve_auto_batch_ref(l2[..., 0], l2[..., 1], lengths, ids)
    with pytest.raises((IndexError, RuntimeError)):
        tres.resolve_auto_stacked(l2, lengths, ids)


def test_auto_batch_reads_ids_at_any_strides():
    """The auto resolve of ids held at other strides (columns apart, a
    transposed store, an expanded row) equals that of their contiguous
    copy, leaf for leaf."""
    l2, lengths = _as_torch(*mixed_image(6, 4, 16, 32))
    g = torch.Generator().manual_seed(6)
    base = torch.randint(0, 32, (4, 24), generator=g, dtype=torch.int32)
    for ids in (base[:, ::3], base.t().contiguous().t(), base[:1].expand(4, -1)):
        got = tres.resolve_auto_stacked(l2, lengths, ids)
        want = tres.resolve_auto_stacked(l2, lengths, ids.contiguous())
        for leaf, a, b in zip(got._fields, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), leaf


def test_auto_batch_kernels_keep_k1s_name_and_counter():
    """The benchmark's layer map (``snapbench/layers/resolve.json``) puts
    a kernel in the resolve layer by a substring of its name, and checks a
    trace's completeness by matching each launch counter to one
    substring. Each of the batch entry's kernels in ``csrc/chain_resolve.cu``
    contains exactly one of those substrings, ``vanilla_fleet_kernel``, and
    the wrapper counts its launch under that substring's counter."""
    import inspect
    import json
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    layer = json.loads((root / "snapbench" / "layers" / "resolve.json").read_text())
    source = (root / "src" / "repro_torch" / "csrc" / "chain_resolve.cu").read_text()
    kernels = set(re.findall(r"__global__ void (\w+)", source))
    batch = sorted(k for k in kernels if k.startswith("batch_"))
    assert batch == ["batch_vanilla_fleet_kernel", "batch_warp_vanilla_fleet_kernel"]
    for name in batch:
        assert [k for k in layer["launches"].values() if k in name] == \
            ["vanilla_fleet_kernel"], name
        assert any(k in name for k in layer["kernels"])
    assert layer["launches"][tcr.AUTO_BATCH_COUNTER] == "vanilla_fleet_kernel"
    assert "check_launch(AUTO_BATCH_COUNTER" in inspect.getsource(
        tcr.resolve_auto_batch_cuda)
