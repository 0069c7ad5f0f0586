"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case carries the ``gpu`` marker and skips where there is no CUDA
card (decided inside the fixture, never at import). This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

K1/K2/K6/K7 (chain resolve) and K1's batch entry, K5/K8 (page gather)
and K9 (streaming merge) must be bit-exact;
K3/K4 (attention) within the
tolerances of ``tests/test_kernels.py``: f32 2e-5, bf16 2e-2. The f32
bound holds on the card because the kernels accumulate in f32 and the
plain versions run with TF32 off.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import format as fmt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chain_resolve import chain_resolve as cr  # noqa: E402
from repro_torch.kernels.chain_resolve import ref as cr_ref  # noqa: E402
from repro_torch.kernels.cow_gather import cow_gather as cg  # noqa: E402
from repro_torch.kernels.cow_gather import ref as cg_ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as pa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.stream_merge import ref as sm_ref  # noqa: E402
from repro_torch.kernels.stream_merge import stream_merge as sm  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def packed_words(rng, t, c, p, nb, density):
    """(T, C, P) word0/word1 stacks in the entry layout, ptrs into [0, nb)."""
    e = fmt.pack_entry(
        torch.as_tensor(rng.integers(0, nb, (t, c, p))),
        torch.as_tensor(rng.integers(0, max(c, 1), (t, c, p))),
        allocated=torch.as_tensor(rng.random((t, c, p)) < density),
        bfi_valid=torch.as_tensor(rng.random((t, c, p)) < 0.7),
        zero=torch.as_tensor(rng.random((t, c, p)) < 0.1),
    )
    return e[..., 0].contiguous(), e[..., 1].contiguous()


@pytest.mark.parametrize("t,c,p", [(4, 1, 128), (8, 7, 16), (16, 64, 128),
                                   (128, 128, 128)])
def test_resolve_kernels_bit_exact(cuda, t, c, p):
    rng = np.random.default_rng(t + c + p)
    w0, w1 = (w.to(cuda) for w in packed_words(rng, t, c, p, 10_000, 0.5))
    lengths = rng.integers(0, c + 1, t).astype(np.int32)
    lengths[0], lengths[-1] = 0, c          # a free row and a full chain
    lens = torch.as_tensor(lengths, device=cuda)
    got = cr.resolve_vanilla_fleet_cuda(w0, lens) + cr.resolve_direct_fleet_cuda(
        w0, w1, lens)
    torch.cuda.synchronize()
    want = (cr_ref.resolve_vanilla_fleet_ref(w0, lens)
            + cr_ref.resolve_direct_fleet_ref(w0, w1, lens))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def tables_case(rng, b, h, hkv, d, bs, m, nb, dtype, device):
    return lengths_case(rng, [1, bs * m // 2 + 1, bs * m, 0][:b], h, hkv, d, bs,
                        m, nb, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,bs,m", [(8, 2, 64, 16, 4), (16, 1, 64, 8, 8),
                                          (4, 4, 128, 32, 2),
                                          (16, 2, 128, 16, 128)])
def test_paged_attention_kernel(cuda, dtype, h, hkv, d, bs, m):
    """K3 against its plain version; the length-0 row comes out zero."""
    args = tables_case(np.random.default_rng(h + m), 4, h, hkv, d, bs, m, 64,
                       dtype, cuda)
    before = _build.LAUNCHES["paged_attention"]
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attention"] == before + 1
    want = pa_ref.paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.count_nonzero(got[3]) == 0


def fused_case(rng, t, c, p, b, nb, bs, h, hkv, d, dtype, device, density):
    w0, _ = packed_words(rng, t, c, p, nb, density)
    q, pk, pv = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                 .to(device, dtype)
                 for s in ((b, h, d), (nb, bs, hkv, d), (nb, bs, hkv, d)))
    ints = (rng.integers(1, c + 1, t), rng.integers(0, t, b),
            rng.integers(1, p * bs + 1, b))
    return (q, pk, pv, w0.to(device),
            *(torch.as_tensor(x.astype(np.int32), device=device) for x in ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c,p,h,hkv,d,bs", [(4, 6, 128, 8, 2, 64, 8),
                                              (3, 1, 128, 16, 2, 128, 16),
                                              (5, 65, 128, 16, 2, 128, 16),
                                              (5, 9, 16, 16, 1, 64, 8)])
def test_fused_attention_kernel(cuda, dtype, t, c, p, h, hkv, d, bs):
    """K4 against its plain version, holes and all."""
    args = fused_case(np.random.default_rng(t + c), t, c, p, 4, 64, bs, h, hkv,
                      d, dtype, cuda, density=0.55)
    got = pa.fused_chain_attention_cuda(*args)
    torch.cuda.synchronize()
    want = pa_ref.fused_chain_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("long_rows", [False, True])
def test_fused_and_tables_kernels_bit_identical(cuda, dtype, long_rows):
    """K3 and K4 share one attention body, one split and one combine: fed
    the rows the walk resolves (no holes), they agree bit for bit, also on
    rows of 2,048 tokens over 128 splits."""
    q, pk, pv, w0, cl, tn, kl = fused_case(np.random.default_rng(9), 5, 65, 128,
                                           8, 256, 16, 16, 2, 128, dtype, cuda,
                                           density=1.0)
    if long_rows:
        kl.fill_(128 * 16)
    tables = pa_ref.fused_tables_ref(w0, cl, tn)
    assert (tables >= 0).all()
    fused = pa.fused_chain_attention_cuda(q, pk, pv, w0, cl, tn, kl)
    via_tables = pa.paged_attention_cuda(q, pk, pv, tables, kl)
    torch.cuda.synchronize()
    assert torch.equal(fused, via_tables)


def test_all_masked_fused_row_is_zero(cuda):
    q, pk, pv, w0, cl, tn, kl = fused_case(np.random.default_rng(77), 2, 3, 128,
                                           2, 16, 4, 4, 2, 32, torch.float32,
                                           cuda, density=0.55)
    w0[1] = 0                               # tenant 1 owns nothing anywhere
    tn = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    got = pa.fused_chain_attention_cuda(q, pk, pv, w0, cl, tn, kl)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[1]) == 0


def _close_to_plain(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def lengths_case(rng, lengths, h, hkv, d, bs, m, nb, dtype, device):
    """K3's inputs for the given row lengths: each row's pages drawn from
    the pool, -1 past its last page."""
    b = len(lengths)
    q, pk, pv = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                 .to(device, dtype)
                 for s in ((b, h, d), (nb, bs, hkv, d), (nb, bs, hkv, d)))
    lengths = np.asarray(lengths, np.int32)
    tables = np.where(np.arange(m)[None, :] * bs < lengths[:, None],
                      rng.integers(0, nb, (b, m)), -1).astype(np.int32)
    return q, pk, pv, torch.as_tensor(tables, device=device), torch.as_tensor(
        lengths, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_attention_split_widths(cuda, dtype, hkv, d, bs):
    """K3 over every KV-head count, head dim and page size: a length-0 row,
    a row ending on a split boundary, a row ending mid-page, a full row."""
    m = 64
    args = lengths_case(np.random.default_rng(hkv * d + bs), [0, bs, bs * 7 + 3,
                        bs * m], 4 * hkv, hkv, d, bs, m, 256, dtype, cuda)
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    _close_to_plain(got, pa_ref.paged_attention_ref(*args), dtype)
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["long", "batch1", "batch64", "batch64x4kv",
                                   "batch512", "batch512_d64", "batch512_d16",
                                   "group32", "head16"])
def test_paged_attention_split_shapes(cuda, dtype, shape):
    """K3 where the split matters: rows of 2,048 tokens (M 128, bs 16, one
    page a warp), batch 1, batch 64 with per-row lengths, batches whose
    (row, KV head) pairs outnumber the SMs (two pages a warp, a two-stage
    ring; at batch 512 the combine takes a warp a (row, head), also at head
    dims 64 and 16, where slices of lanes share a column), 32 query heads a
    KV head (two mma head tiles), and the smoke config's head dim 16."""
    rng = np.random.default_rng(len(shape))
    h, hkv, d, bs, m = 16, 2, 128, 16, 128
    if shape.startswith("batch512_d"):
        d = int(shape[len("batch512_d"):])
        shape = "batch512"
    if shape == "long":
        lengths = [2048] * 8
    elif shape == "batch1":
        lengths = [1500]
    elif shape in ("batch64", "batch64x4kv"):
        lengths = rng.integers(0, 2049, 64)
        hkv = 4 if shape == "batch64x4kv" else 2
    elif shape == "batch512":
        lengths = rng.integers(0, 2049, 512)
    elif shape == "group32":
        h, hkv, lengths = 32, 1, [0, 17, 300, 2048]
    else:
        h, hkv, d, bs, lengths = 4, 2, 16, 4, [0, 5, 4 * 128, 77]
    args = lengths_case(rng, lengths, h, hkv, d, bs, m, 2048, dtype, cuda)
    before = _build.LAUNCHES["paged_attention"]
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attention"] == before + 1
    _close_to_plain(got, pa_ref.paged_attention_ref(*args), dtype)
    split = pa.pages_per_split(len(lengths), hkv, pa.sm_count(cuda))
    assert (shape in ("batch64x4kv", "batch512")) == (split > 1)
    assert pa.plan(len(lengths), h, hkv, m, bs, dtype, pa.sm_count(
        cuda)).warp_combine == (shape == "batch512")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [8, 512])
def test_fused_attention_long_chain_and_split_of_holes(cuda, dtype, batch):
    """K4 on rows of 2,048 tokens through a 65-layer chain, where one row's
    tenant owns none of the pages of one whole split (one page a split at
    batch 8, two at batch 512)."""
    rng = np.random.default_rng(batch)
    q, pk, pv, w0, cl, tn, kl = fused_case(rng, 6, 65, 128, batch, 2048, 16,
                                           16, 2, 128, dtype, cuda, density=0.3)
    cl.fill_(65)
    kl.copy_(torch.as_tensor(rng.integers(1500, 2049, batch).astype(np.int32)))
    split = pa.pages_per_split(batch, 2, pa.sm_count(cuda))
    hole = slice(3 * split, 4 * split)
    w0[int(tn[0]), :, hole] = 0
    tables = pa_ref.fused_tables_ref(w0, cl, tn)
    assert (tables[0, hole] == -1).all()
    got = pa.fused_chain_attention_cuda(q, pk, pv, w0, cl, tn, kl)
    torch.cuda.synchronize()
    _close_to_plain(got, pa_ref.fused_chain_attention_ref(
        q, pk, pv, w0, cl, tn, kl), dtype)


def _same_bytes(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,p,t,b", [(16, 128, 2, 8), (64, 256, 5, 17),
                                     (40, 5, 3, 7), (9, 3, 1, 33),
                                     (300, 16384, 4, 64), (7, 1029, 2, 5)])
def test_gather_kernels_bit_exact(cuda, dtype, r, p, t, b):
    """K5 and K8 against their plain versions: ragged batches, page sizes
    whose rows are not 16-byte aligned (the narrower widths and the byte
    tail), bf16 pools, rows at R - 1, negative zeros in the pool, and
    +0.0 bytes wherever a page is not found."""
    rng = np.random.default_rng(r + p + t + b)
    pool = torch.as_tensor(rng.standard_normal((r, p)), dtype=torch.float32)
    pool[0, :2] = -0.0
    pool = pool.to(cuda, dtype)
    rows = torch.as_tensor(rng.integers(0, r, (t, b)).astype(np.int32),
                           device=cuda)
    rows[:, 0] = r - 1
    found = torch.as_tensor(rng.random((t, b)) < 0.7, device=cuda)
    # an unfound page may carry any row: the kernel never dereferences it
    rows = torch.where(found, rows, 1 << 20)
    launches = dict(_build.LAUNCHES)
    got_fleet = cg.gather_fleet_cuda(pool, rows, found)
    got_one = cg.gather_cuda(pool, rows[-1].contiguous(), found[-1].contiguous())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_fleet"] == launches["gather_fleet"] + 1
    assert _build.LAUNCHES["gather"] == launches["gather"] + 1
    assert _same_bytes(got_fleet, cg_ref.gather_fleet_ref(pool, rows, found))
    assert _same_bytes(got_one, cg_ref.gather_ref(pool, rows[-1], found[-1]))
    assert not got_fleet.view(torch.uint8)[~found].any()


def test_gather_all_unfound_and_empty(cuda):
    pool = torch.randn((8, 40), device=cuda)
    rows = torch.full((3, 6), -5, dtype=torch.int32, device=cuda)
    found = torch.zeros((3, 6), dtype=torch.bool, device=cuda)
    out = cg.gather_fleet_cuda(pool, rows, found)
    torch.cuda.synchronize()
    assert not out.view(torch.uint8).any()
    empty = cg.gather_cuda(pool, rows[0, :0], found[0, :0])
    assert tuple(empty.shape) == (0, 40)


def _gather_pool(cuda, dtype, r, row_bytes, offset, seed):
    """A contiguous (R, row_bytes) pool of random bits whose base lies
    ``offset`` elements past an aligned allocation (a misaligned view)."""
    elt = torch.empty((), dtype=dtype).element_size()
    p = row_bytes // elt
    rng = np.random.default_rng(seed)
    flat = torch.as_tensor(rng.integers(0, 256, (r * p + offset) * elt,
                                        dtype=np.uint8), device=cuda)
    return flat.view(dtype)[offset:].view(r, p)


def _gather_check(pool, rows, found, variant=None):
    """K5 on (T, B) and K8 on each tenant's (B,), bit for bit against the
    plain versions; a found row outside [0, R) must come out as zeros.
    ``variant`` forces one instantiation of the kernel (None: the pick)."""
    r = pool.shape[0]
    readable = found & (rows >= 0) & (rows < r)
    got = cg._launch("gather_fleet", pool, rows, found, variant)
    ones = [cg._launch("gather", pool, rows[i].contiguous(),
                       found[i].contiguous(), variant)
            for i in range(rows.shape[0])]
    torch.cuda.synchronize()
    assert _same_bytes(got, cg_ref.gather_fleet_ref(pool, rows, readable))
    for i, one in enumerate(ones):
        assert _same_bytes(one, got[i])
    assert not got.view(torch.uint8)[~readable].any()


_GATHER_DTYPES = [torch.float32, torch.bfloat16, torch.uint8]


def _gather_cases():
    """(dtype, R, row bytes, T, B, found, misaligned elements): pages of
    8 and 64 KiB, rows of 2, 4 and 8 bytes and odd byte counts, misaligned
    views, all / none found and found rows outside [0, R), B not a
    multiple of a block's pages."""
    cases = []
    for dt in _GATHER_DTYPES:
        elt = torch.empty((), dtype=dt).element_size()
        for rb in (2, 4, 8, 1029 * elt, 8_193 * elt):
            if rb % elt == 0:
                cases.append(pytest.param(dt, 50, rb, 3, 67, "some", 0,
                                          id=f"{dt}-row{rb}"))
        for found in ("all", "none", "outside"):
            cases.append(pytest.param(dt, 64, 8_192, 2, 129, found, 0,
                                      id=f"{dt}-8KiB-{found}"))
        cases += [
            pytest.param(dt, 40, 65_536, 2, 37, "some", 0, id=f"{dt}-64KiB"),
            pytest.param(dt, 300, 8_192, 5, 333, "some", 1,
                         id=f"{dt}-8KiB-misaligned"),
            pytest.param(dt, 30, 65_536 + 2 * elt, 1, 19, "outside", 3,
                         id=f"{dt}-64KiB-odd-misaligned"),
        ]
    return cases


@pytest.mark.parametrize("dtype,r,row_bytes,t,b,found,offset", _gather_cases())
def test_gather_cases_bit_exact(cuda, dtype, r, row_bytes, t, b, found, offset):
    pool = _gather_pool(cuda, dtype, r, row_bytes, offset, r + row_bytes + b)
    rng = np.random.default_rng(t * b + offset)
    rows = rng.integers(0, r, (t, b)).astype(np.int32)
    hit = {"all": np.ones((t, b), bool), "none": np.zeros((t, b), bool)}.get(
        found, rng.random((t, b)) < 0.7)
    if found == "outside":
        rows[:, ::3] = r + np.arange(rows[:, ::3].shape[1])
        rows[:, 1::5] = -1 - np.arange(rows[:, 1::5].shape[1])
        hit[:] = True
    rows[0, -1] = r - 1
    _gather_check(pool, torch.as_tensor(rows, device=cuda),
                  torch.as_tensor(hit, device=cuda))


@pytest.mark.parametrize("row_bytes,offset", [(8_192, 0), (65_536, 0),
                                              (1029, 1), (24, 0)])
def test_gather_every_variant_bit_exact(cuda, row_bytes, offset):
    """Each forced (loads a lane a round, warps a page) variant, on uint8
    pools: every instantiation of the kernel, aligned or not."""
    pool = _gather_pool(cuda, torch.uint8, 70, row_bytes, offset, row_bytes)
    rng = np.random.default_rng(row_bytes)
    rows = torch.as_tensor(rng.integers(-2, 72, (2, 301)).astype(np.int32),
                           device=cuda)
    found = torch.as_tensor(rng.random((2, 301)) < 0.8, device=cuda)
    for u in cg._UNITS:
        for g in cg._WARPS_PER_PAGE:
            _gather_check(pool, rows, found, cg.GatherVariant(u, g))


@pytest.mark.parametrize("dtype", _GATHER_DTYPES)
def test_gather_100k_pages_of_8KiB(cuda, dtype):
    """100,000 pages of 8 KiB (819 MB) through the wrapper's pick."""
    r, b = 100_000, 100_000
    pool = _gather_pool(cuda, dtype, r, 8_192, 0, 7)
    g = torch.Generator(device=cuda).manual_seed(7)
    rows = torch.randperm(r, generator=g, device=cuda).to(torch.int32)
    found = torch.rand(b, generator=g, device=cuda) < 0.9
    got = cg.gather_cuda(pool, rows, found)
    torch.cuda.synchronize()
    assert _same_bytes(got, cg_ref.gather_ref(pool, rows, found))
    assert cg.gather_variant(8_192).name == "u4g4"


def test_gather_refuses_what_it_cannot_take(cuda):
    pool = torch.zeros((4, 8), device=cuda)
    rows = torch.zeros(3, dtype=torch.int32, device=cuda)
    found = torch.ones(3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="variant"):
        cg._launch("gather", pool, rows, found, cg.GatherVariant(3, 1))
    with pytest.raises(ValueError, match="variant"):
        cg._launch("gather", pool, rows, found, cg.GatherVariant(16, 3))
    with pytest.raises(ValueError, match="contiguous"):
        cg.gather_cuda(pool[:, ::2], rows, found)
    with pytest.raises(TypeError, match="int32"):
        cg.gather_cuda(pool, rows.long(), found)


def _resolved_leaves(cuda, seed, r, t, b, found_share=0.7):
    """A resolve's (T, B) leaves in the batch entry's layout: ``ptr`` the
    second plane of (3, T, B) int32 words, found/zero/cold the planes of
    (3, T, B) bool flags. Found pages are ZERO or COLD one in five each;
    a page not read from the pool carries a garbage ``ptr`` (far past the
    pool, negative, or a host-tier row), and a few found pages a row
    outside [0, R)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    words = torch.randint(0, r, (3, t, b), generator=g, device=cuda,
                          dtype=torch.int32)
    flags = torch.rand((3, t, b), generator=g, device=cuda) < 0.2
    flags[0] = torch.rand((t, b), generator=g, device=cuda) < found_share
    found, zero, cold = flags.unbind()
    zero &= found
    cold &= found
    ptr = words[1]
    far = torch.randint(0, 1 << 28, (t, b), generator=g, device=cuda,
                        dtype=torch.int32)
    far[:, 1::7] = -1 - far[:, 1::7]
    ptr.copy_(torch.where(found & ~zero & ~cold, ptr, far))
    ptr[:, ::11] = torch.where(found[:, ::11], r + 3, ptr[:, ::11])
    return ptr, found, zero, cold


def _resolved_check(pool, ptr, found, zero, cold, variant=None):
    """K5's entry on the leaves, bit for bit K5 on ``store.readable_rows``
    of them (with the same variant forced, or both picking), one launch
    counted as K5's and as the entry's."""
    from repro_torch.core.resolve import ResolveResult
    from repro_torch.core.store import readable_rows

    res = ResolveResult(owner=ptr, ptr=ptr, found=found, zero=zero,
                        lookups=ptr, cold=cold)
    want = cg._launch("gather_fleet", pool, *readable_rows(res), variant)
    before = dict(_build.LAUNCHES)
    got = cg.gather_fleet_resolved_cuda(pool, ptr, found, zero, cold,
                                        variant=variant)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_fleet"] == before["gather_fleet"] + 1
    assert _build.LAUNCHES[cg.RESOLVED_ENTRY] == before[cg.RESOLVED_ENTRY] + 1
    assert _build.LAUNCHES["gather"] == before["gather"]
    assert _same_bytes(got, want)
    readable = found & ~zero & ~cold & (ptr >= 0) & (ptr < pool.shape[0])
    assert not got.view(torch.uint8)[~readable].any()
    assert _same_bytes(got, cg_ref.gather_fleet_ref(pool, ptr, readable))


@pytest.mark.parametrize("row_bytes,offset", [(8_192, 0), (65_536, 0),
                                              (1029, 1), (24, 0)])
def test_gather_resolved_every_variant_bit_exact(cuda, row_bytes, offset):
    """K5's entry on a resolve's leaves under each forced (loads a lane a
    round, warps a page) variant, on uint8 pools, aligned or not: found,
    ZERO and COLD pages, misses whose ``ptr`` is garbage or outside the
    pool, and found rows outside [0, R)."""
    pool = _gather_pool(cuda, torch.uint8, 70, row_bytes, offset, row_bytes)
    leaves = _resolved_leaves(cuda, row_bytes + offset, 70, 2, 301)
    for u in cg._UNITS:
        for g in cg._WARPS_PER_PAGE:
            _resolved_check(pool, *leaves, cg.GatherVariant(u, g))


@pytest.mark.parametrize("dtype", _GATHER_DTYPES)
@pytest.mark.parametrize("row_bytes,t,b,found_share", [
    (65_536, 64, 256, 1.0), (65_536, 8, 1_024, 0.9), (8_192, 5, 333, 0.0),
    (8_192, 3, 129, 0.7)])
def test_gather_resolved_at_the_reads_shapes_bit_exact(cuda, dtype, row_bytes, t,
                                                       b, found_share):
    """Through the wrapper's pick: the fleet read's YCSB-C batch (64 × 256
    clusters of 64 KiB), a dd batch's runs, every page missed, and 8 KiB
    pages, in f32, bf16 and uint8."""
    pool = _gather_pool(cuda, dtype, 600, row_bytes, 0, t * b)
    _resolved_check(pool, *_resolved_leaves(cuda, t + b, 600, t, b, found_share))


def test_gather_resolved_refuses_what_it_cannot_take(cuda):
    pool = torch.zeros((4, 8), device=cuda)
    ptr = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    flags = torch.zeros((3, 2, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="variant"):
        cg.gather_fleet_resolved_cuda(pool, ptr, *flags,
                                      variant=cg.GatherVariant(16, 3))
    with pytest.raises(ValueError, match="T, B"):
        cg.gather_fleet_resolved_cuda(pool, ptr[0], *flags[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        cg.gather_fleet_resolved_cuda(pool, ptr, flags[0], flags[1].t().contiguous().t(),
                                      flags[2])
    with pytest.raises(ValueError, match="bool"):
        cg.gather_fleet_resolved_cuda(pool, ptr, flags[0], flags[1].int(), flags[2])
    with pytest.raises(ValueError, match="CUDA"):
        cg.gather_fleet_resolved_cuda(pool, ptr, flags[0], flags[1], flags[2].cpu())
    with pytest.raises(TypeError, match="int32"):
        cg.gather_fleet_resolved_cuda(pool, ptr.long(), *flags)


def _card_and_cpu_fleets(cuda, scalable, seed):
    """The same fleet on the CPU and on the card: 4 tenants of 256 pages
    (a multiple of 128, so the CPU's ``auto`` read takes the kernels' plain
    versions and gives their leaves bit for bit), chains of 1 to 12 layers,
    holes, ZERO clusters and two tenants' snapshot layers demoted to the
    host tier."""
    import dataclasses

    from repro_torch.core import fleet as tfleet
    from repro_torch.core.store import TieredStore

    spec = tfleet.FleetSpec(n_tenants=4, n_pages=256, page_size=64,
                            max_chain=16, pool_capacity=4096, lease_quantum=32)
    fl = tfleet.create(spec, scalable=scalable, device="cpu")
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([1, 4, 9, 12])
    for layer in range(12):
        mask = lengths > layer
        if layer:
            tfleet.snapshot(fl, mask)
        ids = torch.argsort(torch.rand((4, 256), generator=g), dim=1)[:, :24]
        tfleet.write(fl, ids.to(torch.int32), torch.randn((4, 24, 64), generator=g), mask)
    fl.l2[3, :, :64, 0] |= fmt.FLAG_ZERO_I32
    store = TieredStore.for_fleet(spec)
    fl, rep = tfleet.demote_tenants(fl, store, [1, 2], max_rows=40)
    assert rep["rows_demoted"] > 0
    on_card = dataclasses.replace(fl, **{
        f.name: getattr(fl, f.name).to(cuda)
        for f in dataclasses.fields(fl) if f.name != "spec"})
    return fl, on_card, store


@pytest.mark.parametrize("scalable", [True, False, [True, False, True, False]],
                         ids=["sqemu", "qcow2", "mixed"])
def test_fleet_read_auto_on_the_card_equals_the_plain_read(cuda, scalable):
    """``fleet.read(method="auto")`` on the card (K1's batch entry, then
    K5 on its leaves) equals the CPU's read of the same fleet, data and
    every leaf bit for bit, and the card's plain read (``"vanilla"``, the
    plain gather) byte for byte, on both formats; ``materialize`` and
    ``read_tiered`` too. One auto read is one launch of each entry."""
    from repro_torch.core import fleet as tfleet

    fl, on_card, store = _card_and_cpu_fleets(cuda, scalable, 17)
    g = torch.Generator().manual_seed(18)
    ids = torch.randint(0, 256, (4, 300), generator=g, dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    data, res = tfleet.read(on_card, ids.to(cuda), method="auto")
    torch.cuda.synchronize()
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in launched.items() if v} == {
        "resolve_vanilla_fleet": 1, "resolve_auto_batch": 1,
        "gather_fleet": 1, cg.RESOLVED_ENTRY: 1}
    want, want_res = tfleet.read(fl, ids, method="auto")
    assert _same_bytes(data.cpu(), want)
    for leaf, a, b in zip(res._fields, res, want_res):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), leaf
    assert bool(want_res.cold.any()) and bool(want_res.zero.any())
    assert bool((~want_res.found).any())
    plain, _ = tfleet.read(on_card, ids.to(cuda), method="vanilla")
    assert _same_bytes(data, plain)
    assert _same_bytes(tfleet.materialize(on_card).cpu(), tfleet.materialize(fl))
    tiered, _ = tfleet.read_tiered(on_card, store, ids.to(cuda))
    assert _same_bytes(tiered.cpu(), tfleet.read_tiered(fl, store, ids)[0])


@pytest.mark.parametrize("c,n", [(1, 128), (7, 1000), (64, 4096), (512, 257)])
@pytest.mark.parametrize("alloc_dtype", [torch.int32, torch.bool])
def test_single_chain_resolve_kernels_bit_exact(cuda, c, n, alloc_dtype):
    """K6 and K7 against their plain versions, with lengths 0, 1, C/2, C
    and past C (layers >= C do not exist), int32 or bool allocation maps."""
    rng = np.random.default_rng(c + n)
    alloc = torch.as_tensor(rng.random((c, n)) < 0.2, device=cuda).to(alloc_dtype)
    ptrs = torch.as_tensor(rng.integers(0, 1 << 28, (c, n)).astype(np.int32),
                           device=cuda)
    bfi = torch.as_tensor(rng.integers(0, 1 << 16, n).astype(np.int32),
                          device=cuda)
    for length in (0, 1, c // 2, c, c + 3):
        for ln in (length, torch.tensor(length, device=cuda)):
            got = cr.resolve_vanilla_cuda(alloc, ptrs, ln)
            torch.cuda.synchronize()
            want = cr_ref.resolve_vanilla_ref(alloc, ptrs, length)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = cr.resolve_direct_cuda(alloc[c - 1], bfi, ptrs[0])
    torch.cuda.synchronize()
    want = cr_ref.resolve_direct_ref(alloc[c - 1], bfi, ptrs[0])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("alloc_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("n", [4_096, 4_113, 65_536])
def test_single_chain_walk_every_config_bit_exact(cuda, alloc_dtype, n):
    """K6 against its plain version at C = 1, 7 and 500, with 4 pages a
    thread and 1 (N = 4,113, and a view one entry past an aligned base),
    lengths 0, 1, C/2, C and C + 3 as ints and as 0-d CUDA tensors, and a
    500-deep chain whose pages mostly miss. Each call counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(n)
    for c, density in ((1, 0.5), (7, 0.3), (500, 0.004), (500, 0.0003)):
        alloc = (torch.rand((c, n), generator=g, device=cuda) < density
                 ).to(alloc_dtype)
        ptrs = torch.randint(-(1 << 31), 1 << 31, (c, n), generator=g,
                             device=cuda, dtype=torch.int32)
        for a, vec in ((alloc, 1 if n % 4 else 4), (shifted(alloc, 1), 1)):
            assert cr.vanilla_config(a)[0] == vec
            for length in (0, 1, c // 2, c, c + 3):
                want = cr_ref.resolve_vanilla_ref(a, ptrs, length)
                for ln in (length, torch.tensor(length, device=cuda)):
                    before = _build.LAUNCHES["resolve_vanilla"]
                    got = cr.resolve_vanilla_cuda(a, ptrs, ln)
                    torch.cuda.synchronize()
                    assert _build.LAUNCHES["resolve_vanilla"] == before + 1
                    for x, w in zip(got, want):
                        assert x.dtype == w.dtype and torch.equal(x, w), (c, length)
        if density < 0.001:
            # most pages miss: the walk reads the whole chain for them
            assert float((want[0] < 0).float().mean()) > 0.7


@pytest.mark.parametrize("k,n", [(1, 1000), (7, 33), (64, 4097), (512, 2_000)])
@pytest.mark.parametrize("alloc_dtype", [torch.int32, torch.bool])
def test_merge_kernel_bit_exact(cuda, k, n, alloc_dtype):
    """K9: K = 1 and K = 512, N not a multiple of 32, an all-unallocated
    and an all-allocated page column, bool and int32 allocation maps."""
    rng = np.random.default_rng(k * n)
    alloc = rng.random((k, n)) < 3.0 / k
    alloc[:, 0] = False
    alloc[:, -1] = True
    ptrs = torch.as_tensor(
        rng.integers(0, 2**32, (k, n), dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=cuda)
    a = torch.as_tensor(alloc, device=cuda).to(alloc_dtype)
    before = _build.LAUNCHES["merge"]
    got = sm.merge_cuda(a, ptrs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["merge"] == before + 1
    want = sm_ref.merge_ref(a, ptrs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[2][0]) == -1 and int(got[2][-1]) == k - 1


def device_entries(cuda, seed, k, n, density):
    """(K, N, 2) packed words made on the card (K x N reaches 134 M
    entries); page 0 allocated in no layer, the last page in every layer."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    alloc = torch.rand((k, n), generator=g, device=cuda) < density
    alloc[:, 0] = False
    alloc[:, -1] = True
    return fmt.pack_entry(
        torch.randint(0, 1 << 28, (k, n), generator=g, device=cuda),
        torch.randint(0, k, (k, n), generator=g, device=cuda),
        allocated=alloc,
        bfi_valid=torch.rand((k, n), generator=g, device=cuda) < 0.7,
        zero=torch.rand((k, n), generator=g, device=cuda) < 0.1)


@pytest.mark.parametrize("k", [1, 7, 64, 512])
@pytest.mark.parametrize("n", [33, 4_097, 262_144])
def test_merge_entries_kernel_bit_exact(cuda, k, n):
    """K9's word entry against its plain version, with an all-miss and an
    all-hit page column; the call counts one launch under ``merge``."""
    sub = device_entries(cuda, k * 31 + n, k, n, 3.0 / k)
    want = sm_ref.merge_entries_ref(sub)
    before = _build.LAUNCHES["merge"]
    got = sm.merge_entries_cuda(sub)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["merge"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[2][0]) == -1 and int(got[2][-1]) == k - 1
    assert torch.equal(got[0][0], sub[0, 0])


@pytest.mark.parametrize("alloc_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("n", [4_096, 4_113, 65_536])
def test_merge_planes_every_config_bit_exact(cuda, alloc_dtype, n):
    """K9's planes entry, bool and int32, at K = 1, 7 and 500 and at 4
    pages a thread and 1 (N not a multiple of 4)."""
    for k in (1, 7, 500):
        sub = device_entries(cuda, k + n, k, n, 2.0 / k)
        alloc = fmt.entry_allocated(sub).to(alloc_dtype)
        ptrs = fmt.entry_ptr(sub)
        assert sm.planes_config(alloc)[0] == (1 if n % 4 else 4)
        got = sm.merge_cuda(alloc, ptrs)
        torch.cuda.synchronize()
        want = sm_ref.merge_ref(alloc, ptrs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def deep_fleet_words(cuda, t, c, p, deep):
    """(T, C, P, 2) words: tenant 0 free (length 0), tenant 1 a chain
    ``deep`` layers long whose pages are owned near its bottom, the rest
    random lengths, the last tenant full."""
    rng = np.random.default_rng(t * c + p)
    w0, w1 = packed_words(rng, t, c, p, 10_000, 0.02)
    lengths = rng.integers(1, c + 1, t).astype(np.int32)
    lengths[0], lengths[-1] = 0, c
    if t > 2:
        lengths[1] = deep
        w0[1, 2:] &= ~fmt.FLAG_ALLOCATED_I32
    l2 = torch.stack([w0, w1], dim=-1).to(cuda)
    return l2, torch.as_tensor(lengths, device=cuda)


@pytest.mark.parametrize("t,c,p", [(8, 128, 128), (64, 512, 16_384), (6, 70, 333)])
def test_vanilla_fleet_walks_and_layouts_bit_exact(cuda, t, c, p):
    """K1 on the contiguous plane and on the strided ``l2[..., 0]`` view,
    with each walk forced and with the planner's pick, against its plain
    version: the decode state's shape with a 65-deep tenant, the fleet
    read's shape and an odd P."""
    l2, lens = deep_fleet_words(cuda, t, c, p, deep=65)
    want = cr_ref.resolve_vanilla_fleet_ref(l2[..., 0], lens)
    for w0 in (l2[..., 0], l2[..., 0].contiguous()):
        for walk in (*cr.WALKS, None):
            before = _build.LAUNCHES["resolve_vanilla_fleet"]
            got = cr.resolve_vanilla_fleet_cuda(w0, lens, walk=walk)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["resolve_vanilla_fleet"] == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        del w0
    assert bool((want[0][0] == -1).all())            # the length-0 tenant


def device_fleet_words(cuda, seed, t, c, p):
    """(T, C, P, 2) packed words made on the card, and lengths with a
    length-0 tenant (it wraps to layer C-1) and a full chain."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (t, c, p)
    l2 = fmt.pack_entry(
        torch.randint(0, 1 << 28, shape, generator=g, device=cuda),
        torch.randint(0, c, shape, generator=g, device=cuda),
        allocated=torch.rand(shape, generator=g, device=cuda) < 0.5,
        bfi_valid=torch.rand(shape, generator=g, device=cuda) < 0.7,
        zero=torch.rand(shape, generator=g, device=cuda) < 0.1)
    lens = torch.randint(0, c + 1, (t,), generator=g, device=cuda,
                         dtype=torch.int32)
    lens[0], lens[-1] = 0, c
    return l2.contiguous(), lens


def shifted(x, elems):
    """A contiguous copy of ``x`` whose storage starts ``elems`` elements
    past an allocation's (well-aligned) base."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("t,c,p", [(8, 128, 128), (64, 512, 16_384), (5, 7, 333)])
def test_direct_fleet_layouts_bit_exact(cuda, t, c, p):
    """K2 on both layouts (the ``l2[..., 0]``/``l2[..., 1]`` pair and two
    contiguous planes) against its plain version: the decode state's
    shape, the fleet read's shape, an odd P, a one-tenant slice (C·P·t odd
    at t = 1 of the odd shape) and words that start 8 bytes off a 16-byte
    boundary. Every call counts one launch under ``resolve_direct_fleet``."""
    l2, lens = device_fleet_words(cuda, t * c + p, t, c, p)
    off = shifted(l2, 2)
    cases = {
        "words": (l2[..., 0], l2[..., 1], lens),
        "planes": (l2[..., 0].contiguous(), l2[..., 1].contiguous(), lens),
        "slice": (l2[1:2, ..., 0], l2[1:2, ..., 1], lens[1:2]),
        "shifted": (off[..., 0], off[..., 1], lens),
    }
    for name, (w0, w1, ln) in cases.items():
        assert cr.direct_fleet_stride(w0, w1) == w0.stride(-1), name
        want = cr_ref.resolve_direct_fleet_ref(w0, w1, ln)
        before = _build.LAUNCHES["resolve_direct_fleet"]
        got = cr.resolve_direct_fleet_cuda(w0, w1, ln)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["resolve_direct_fleet"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        del want
    # the length-0 tenant read layer C-1
    assert torch.equal(cr.resolve_direct_fleet_cuda(l2[..., 0], l2[..., 1], lens)[1][0],
                       l2[0, c - 1, :, 0])


def mixed_fleet_words(cuda, seed, t, c, p, density):
    """(T, C, P, 2) packed words made on the card at an allocation
    ``density``, with trusted, untrusted, ZERO and COLD entries; tenant 0
    has length 0 (its active layer wraps to C-1), tenant 1 (where T > 2)
    a chain of C layers whose pages only the two bottom layers hold (the
    longest walks), the last tenant length C."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (t, c, p)
    rand = lambda: torch.rand(shape, generator=g, device=cuda)
    alloc = rand() < density
    if t > 2:
        alloc[1, 2:] = False
    l2 = fmt.pack_entry(
        torch.randint(0, 1 << 28, shape, generator=g, device=cuda),
        torch.randint(0, c, shape, generator=g, device=cuda),
        allocated=alloc, bfi_valid=rand() < 0.7, zero=rand() < 0.1,
        cold=rand() < 0.1)
    lens = torch.randint(1, c + 1, (t,), generator=g, device=cuda,
                         dtype=torch.int32)
    lens[0], lens[-1] = 0, c
    if t > 2:
        lens[1] = c
    return l2.contiguous(), lens


def batch_page_ids(cuda, seed, t, p, b, kind):
    """(T, B) int32 page ids on the card: drawn with replacement, runs of
    B contiguous pages from a drawn start (dd), one drawn row expanded
    over the tenants (row stride 0), or every page (B = P)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if kind == "drawn":
        return torch.randint(0, p, (t, b), generator=g, device=cuda, dtype=torch.int32)
    if kind == "runs":
        start = torch.randint(0, p, (t, 1), generator=g, device=cuda)
        return ((start + torch.arange(b, device=cuda)) % p).to(torch.int32)
    if kind == "expanded":
        row = torch.randint(0, p, (b,), generator=g, device=cuda, dtype=torch.int32)
        return row[None].expand(t, -1)
    assert kind == "every" and b == p
    return torch.arange(p, dtype=torch.int32, device=cuda)[None].expand(t, -1)


@pytest.mark.parametrize("t,c,p,b,kind,density", [
    (8, 128, 128, 16, "drawn", 0.02), (8, 128, 128, 128, "every", 0.5),
    (64, 512, 16_384, 256, "drawn", 0.02), (64, 512, 16_384, 1_024, "runs", 0.3),
    (6, 70, 333, 50, "expanded", 0.1)])
def test_auto_batch_walks_and_layouts_bit_exact(cuda, t, c, p, b, kind, density):
    """K1's batch entry (``resolve_auto_batch_cuda``) against its plain
    version, every leaf bit for bit, with each walk forced and with the
    planner's pick: on the packed words, on words 8 bytes off a 16-byte
    boundary and on a one-tenant slice, and with the ids' columns apart
    and transposed; at the decode state's shape, B = P, the fleet read's
    shape under YCSB-C's and dd's batches, and an odd P with expanded ids.
    Every call is one launch counted as K1's and as the entry's with
    T × B pages, and none of K2's."""
    l2, lens = mixed_fleet_words(cuda, t * c + p + b, t, c, p, density)
    ids = batch_page_ids(cuda, t + c + b, t, p, b, kind)
    cases = {
        "words": (l2, lens, ids),
        "shifted": (shifted(l2, 2), lens, ids),
        "slice": (l2[1:2], lens[1:2], ids[1:2]),
        "columns_apart": (l2, lens, torch.stack([ids, ids.flip(1)], -1)[..., 1]),
        "transposed": (l2, lens, ids.t().contiguous().t()),
    }
    for name, args in cases.items():
        want = cr_ref.resolve_auto_batch_ref(args[0][..., 0], args[0][..., 1],
                                             *args[1:])
        if name == "words":
            assert bool(want[2].any()) and bool((~want[2]).any())
        for walk in (*cr.WALKS, None):
            before, pages = dict(_build.LAUNCHES), dict(_build.PAGES)
            got = cr.resolve_auto_batch_cuda(*args, walk=walk)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["resolve_vanilla_fleet"] == \
                before["resolve_vanilla_fleet"] + 1
            assert _build.PAGES["resolve_vanilla_fleet"] == \
                pages["resolve_vanilla_fleet"] + args[2].numel()
            assert _build.LAUNCHES["resolve_direct_fleet"] == \
                before["resolve_direct_fleet"]
            assert _build.LAUNCHES["resolve_auto_batch"] == \
                before["resolve_auto_batch"] + 1
            assert _build.PAGES["resolve_auto_batch"] == \
                pages["resolve_auto_batch"] + args[2].numel()
            for leaf, g, w in zip(("owner", "ptr", "found", "zero", "lookups",
                                   "cold"), got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (name, walk, leaf)
        del want


def test_auto_batch_refuses_other_layouts(cuda):
    """The batch entry takes the packed words, contiguous and on an 8-byte
    boundary, and raises on a view of them, a word plane, a misaligned
    base and ids that are not (T, B); it reads (T, B) ids at any
    strides."""
    l2 = torch.zeros((3, 4, 8, 2), dtype=torch.int32, device=cuda)
    lens = torch.full((3,), 4, dtype=torch.int32, device=cuda)
    ids = torch.zeros((3, 5), dtype=torch.int32, device=cuda)
    off = shifted(l2, 1)
    for bad in (l2[:, :3], l2[..., :1], l2[..., 0], l2.transpose(1, 2), off):
        with pytest.raises(ValueError, match="layout|words"):
            cr.resolve_auto_batch_cuda(bad, lens, ids)
    # and K2 refuses the pairs of views those words would give
    other = torch.zeros_like(l2)
    for bad in ((l2[..., 0], other[..., 1]), (l2[..., 1], l2[..., 0]),
                (l2[..., 0].contiguous(), l2[..., 1]),
                (off[..., 0], off[..., 1]), (l2[:, :3, :, 0], l2[:, :3, :, 1])):
        with pytest.raises(ValueError, match="layout|strides"):
            cr.resolve_direct_fleet_cuda(*bad, lens)
    with pytest.raises(ValueError, match="ids"):
        cr.resolve_auto_batch_cuda(l2, lens, ids[0])
    got = cr.resolve_auto_batch_cuda(l2, lens, ids)
    apart = cr.resolve_auto_batch_cuda(l2, lens, ids[:, ::2])
    torch.cuda.synchronize()
    assert not bool(got[2].any())                       # every read a hole
    assert all(torch.equal(a, g[:, ::2]) for a, g in zip(apart, got))


TRAP_SCRIPT = """
import os, sys
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.chain_resolve import chain_resolve as cr
_build.build = lambda: _build.BUILD_DIR / _build.LIB_NAME   # the test's build
bad, walk = int(sys.argv[1]), sys.argv[2]
l2 = torch.zeros((2, 4, 8, 2), dtype=torch.int32, device="cuda")
lens = torch.full((2,), 3, dtype=torch.int32, device="cuda")
ids = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
ids[1, 3] = bad
cr.resolve_auto_batch_cuda(l2, lens, ids, walk=walk)
try:
    torch.cuda.synchronize()
except Exception as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0], flush=True)
    os._exit(3)
print("NO ERROR", flush=True)
os._exit(0)
"""


@pytest.mark.parametrize("bad,walk", [(-1, "thread"), (8, "warp"),
                                      (2**31 - 1, "thread")])
def test_auto_batch_traps_on_ids_outside_the_map(cuda, bad, walk):
    """A page id outside [0, P) stops the batch entry: the stream's next
    sync raises, as the bound check of a gather does, and no read answers
    with another page. A trap leaves the process's CUDA context unusable,
    so each case runs in a process of its own, on the library this
    process built."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _build.library()
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    out = subprocess.run([sys.executable, "-c", TRAP_SCRIPT, str(bad), walk],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 3 and "RAISED" in out.stdout, (out.stdout, out.stderr)


@pytest.mark.parametrize("n", [262_144, 1_000, 257])
@pytest.mark.parametrize("alloc_dtype", [torch.int32, torch.bool])
def test_direct_single_chain_misaligned_views_bit_exact(cuda, n, alloc_dtype):
    """K7 against its plain version on aligned planes and on views one
    entry past an aligned base (a row of a (C, 257) map is such a view)."""
    rng = np.random.default_rng(n)
    alloc = torch.as_tensor(rng.random(n) < 0.6, device=cuda).to(alloc_dtype)
    bfi, ptrs = (torch.as_tensor(rng.integers(0, hi, n).astype(np.int32),
                                 device=cuda) for hi in (1 << 16, 1 << 28))
    aligned = (alloc, bfi, ptrs)
    for planes in (aligned, tuple(shifted(x, 1) for x in aligned)):
        want = cr_ref.resolve_direct_ref(*planes)
        before = _build.LAUNCHES["resolve_direct"]
        got = cr.resolve_direct_cuda(*planes)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["resolve_direct"] == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prefix,suffix", [(392, 200), (392, 17), (16, 1)])
@pytest.mark.parametrize("h,hkv", [(16, 2), (16, 16), (28, 4)])
def test_paged_attention_suffix_prefill_shape(cuda, dtype, prefix, suffix, h,
                                              hkv):
    """K3 at the shape golden admission's suffix prefill hands it: the
    padded suffix bucket on the batch axis, every row the one sequence's
    table (a contiguous repeat), lengths prefix + i + 1 for the real rows
    and 1 for the padded ones; groups 8, 1 and 7. The shared-table entry,
    which the suffix prefill calls, on the one table: against K3's plain
    version and against K3 on the repeated table; its blocks take 1, 2 or
    4 query tiles across these buckets and groups."""
    rng = np.random.default_rng(prefix + suffix + h + hkv)
    d, bs, m, nb = 128, 16, 128, 1024
    pad = 1 << (suffix - 1).bit_length()
    lengths = np.ones(pad, np.int32)
    lengths[:suffix] = prefix + 1 + np.arange(suffix)
    q, pk, pv = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                 .to(cuda, dtype)
                 for s in ((pad, h, d), (nb, bs, hkv, d), (nb, bs, hkv, d)))
    row = rng.permutation(nb)[:m].astype(np.int32)
    row[-(-(prefix + suffix) // bs):] = -1
    tables = torch.as_tensor(np.repeat(row[None], pad, 0), device=cuda)
    table = torch.as_tensor(row, device=cuda)
    lens = torch.as_tensor(lengths, device=cuda)
    got = pa.paged_attention_cuda(q, pk, pv, tables, lens)
    before = _build.LAUNCHES["paged_attention"]
    shared = pa.paged_attention_shared_table_cuda(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attention"] == before + 1
    want = pa_ref.paged_attention_ref(q, pk, pv, tables, lens).float()
    assert torch.equal(pa_ref.paged_attention_shared_table_ref(
        q, pk, pv, table, lens).float(), want)
    _close_to_plain(got, want, dtype)
    _close_to_plain(shared, want, dtype)
    _close_to_plain(shared, got, dtype)
    # outputs over ~500 positions spread little: the relative L2 error is
    # what a dropped page or a short length would move
    for out in (got, shared):
        assert float((out.float() - want).norm() / want.norm()) <= 1e-2
    plan = pa.shared_plan(pad, h, hkv, m, bs, dtype, pa.sm_count(cuda))
    assert plan.warps == (min(pa.SHARED_WARPS, -(-pad * (h // hkv) // 16))
                          if dtype == torch.bfloat16 else 1)


def test_materialize_tenant_on_card_equals_cpu(cuda):
    """``materialize_tenant`` on the card (K1/K2 resolve, K5 gather, cold
    pages from the host tier) equals the CPU result for every tenant, and a
    migration between two card fleets verifies and lands those bytes."""
    import dataclasses

    from repro_torch.core import fleet as tfleet
    from repro_torch.core import migrate as tmigrate
    from repro_torch.core.store import TieredStore

    spec = tfleet.FleetSpec(n_tenants=4, n_pages=4096, page_size=64,
                            max_chain=40, pool_capacity=64 * 256,
                            lease_quantum=64)
    fl = tfleet.create(spec, scalable=[True, False, True, False], device="cpu")
    g = torch.Generator().manual_seed(0)
    lengths = torch.tensor([1, 8, 20, 39])
    for layer in range(39):
        mask = lengths > layer
        if layer:
            tfleet.snapshot(fl, mask)
        ids = torch.argsort(torch.rand((4, 4096), generator=g), dim=1)[:, :64]
        tfleet.write(fl, ids, torch.randn((4, 64, 64), generator=g), mask)
    store = TieredStore.for_fleet(spec)
    fl, rep = tfleet.demote_tenants(fl, store, [3], max_rows=300)
    assert rep["rows_demoted"] == 300
    on_card = dataclasses.replace(fl, **{
        f.name: getattr(fl, f.name).to(cuda)
        for f in dataclasses.fields(fl) if f.name != "spec"})
    before = _build.LAUNCHES["gather_fleet"]
    for t in range(4):
        got = tmigrate.materialize_tenant(on_card, t, store=store)
        assert got.is_cuda
        assert _same_bytes(got.cpu(), tmigrate.materialize_tenant(fl, t, store=store))
    assert _build.LAUNCHES["gather_fleet"] == before + 4
    dst = tfleet.create(dataclasses.replace(spec, n_tenants=2, lease_quantum=128),
                        scalable=False, device=cuda)
    dst_store = TieredStore.for_fleet(dst.spec)
    want = tmigrate.materialize_tenant(fl, 3, store=store)
    on_card, dst, report = tmigrate.migrate_tenant(
        on_card, 3, dst, 1, src_store=store, dst_store=dst_store)
    assert report["verified"] and report["rows_cold"] > 0
    assert _same_bytes(tmigrate.materialize_tenant(dst, 1, store=dst_store).cpu(),
                       want)


def _ckpt_state(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(
        w=torch.randn((67, 33), generator=g).to(torch.bfloat16).to(device),
        b=torch.randn((129,), generator=g).to(device),
        step=torch.tensor(seed, dtype=torch.int32, device=device),
    )


@pytest.mark.parametrize("scalable", [True, False])
def test_checkpoint_kernel_restore_on_card_equals_cpu(cuda, scalable):
    """The same delta saves on the card and on the CPU give the same chain,
    and a restore through the kernels (K1 or K2, then K8) equals the CPU's
    plain restore bit for bit."""
    from repro_torch.checkpoint.snapstore_ckpt import SnapshotCheckpointer

    cks = {dev: SnapshotCheckpointer(_ckpt_state(dev), page_size=64,
                                     max_chain=12, scalable=scalable, device=dev)
           for dev in ("cpu", cuda)}
    for i in range(6):
        for dev, ck in cks.items():
            state = _ckpt_state(dev)
            state["w"][i * 7:(i + 1) * 7] += 1
            state["step"].fill_(i)
            ck.save(state)
    for name in ("l1", "l2", "pool", "pool_cursor", "length"):
        assert torch.equal(getattr(cks[cuda].chain, name).cpu(),
                           getattr(cks["cpu"].chain, name)), name
    plain = "direct" if scalable else "vanilla"
    want = cks["cpu"].restore(method=plain)
    for method in (("pallas_direct", "pallas_vanilla") if scalable
                   else ("pallas_vanilla",)):
        kernel = "resolve_direct_fleet" if method == "pallas_direct" \
            else "resolve_vanilla_fleet"
        before = dict(_build.LAUNCHES)
        got = cks[cuda].restore(method=method)
        assert _build.LAUNCHES[kernel] == before[kernel] + 1
        assert _build.LAUNCHES["gather"] == before["gather"] + 1
        for k in want:
            assert got[k].is_cuda and got[k].dtype == want[k].dtype
            assert _same_bytes(got[k].cpu().reshape(-1), want[k].reshape(-1)), \
                (method, k)
    assert cks[cuda].resolve_cost("pallas_vanilla") == \
        cks["cpu"].resolve_cost("vanilla")


@pytest.mark.parametrize("n_slots", [1, 16, 256])
def test_cache_simulators_on_card_equal_cpu(cuda, n_slots):
    """Both cache simulators on the card equal the CPU field for field."""
    from repro_torch.core import cache, store

    g = torch.Generator().manual_seed(n_slots)
    chains = {}
    for scalable in (False, True):
        ch = store.create(4096, 4, max_chain=48, scalable=scalable,
                          pool_capacity=8192, device="cpu")
        for _ in range(40):
            ids = torch.randperm(4096, generator=g)[:64]
            store.write(ch, ids, torch.ones((64, 4)))
            store.snapshot(ch)
        chains[scalable] = ch
    reqs = torch.cat([torch.arange(2048), torch.randint(0, 4096, (1024,), generator=g)])
    for scalable, ch in chains.items():
        on_card = dataclasses.replace(ch, **{
            f.name: getattr(ch, f.name).to(cuda)
            for f in dataclasses.fields(ch) if f.name not in ("spec", "scalable")})
        for sim in (cache.simulate_vanilla, cache.simulate_unified):
            want = sim(ch, reqs, n_slots)
            got = sim(on_card, reqs.to(cuda), n_slots)
            for field, w, x in zip(want._fields, want, got):
                assert x.is_cuda and torch.equal(x.cpu(), w), (sim.__name__, field)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(16, 16), (32, 8), (48, 8), (28, 4), (64, 8),
                                   (32, 2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [16, 32])
def test_attention_kernels_at_the_family_head_layouts(cuda, dtype, h, hkv, d, bs):
    """K3 and K4 at the groups of the decoder-only configs: Qwen2-MoE's 16
    over 16 (group 1), Phi-3.5-MoE's 32 over 8 (4), Nemotron-4's 48 over 8
    (6), Qwen2-7B's 28 over 4 (7), Qwen2-72B's and Chameleon's 64 over 8
    (8), all with tokens on the mma's rows in bf16, and 32 over 2 (16:
    query heads on the rows); head dims 64 and 128, pages of 16 and 32. K3
    on a length-0 row, a partial page, a split boundary and a full row; K4
    with holes and with a tenant that owns nothing (all masked); then K3 on
    the tables K4's walk resolves, bitwise K4."""
    rng = np.random.default_rng(h * hkv + d + bs)
    m = 2048 // bs
    args = lengths_case(rng, [0, 17, 300, 2048], h, hkv, d, bs, m, 512,
                        dtype, cuda)
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    _close_to_plain(got, pa_ref.paged_attention_ref(*args), dtype)
    assert torch.count_nonzero(got[0]) == 0
    q, pk, pv, w0, cl, tn, kl = fused_case(rng, 4, 6, m, 4, 512, bs, h, hkv,
                                           d, dtype, cuda, density=0.55)
    w0[3] = 0                               # tenant 3 owns nothing anywhere
    tn[1] = 3
    got = pa.fused_chain_attention_cuda(q, pk, pv, w0, cl, tn, kl)
    torch.cuda.synchronize()
    _close_to_plain(got, pa_ref.fused_chain_attention_ref(
        q, pk, pv, w0, cl, tn, kl), dtype)
    assert torch.count_nonzero(got[1]) == 0
    q, pk, pv, w0, cl, tn, kl = fused_case(rng, 4, 6, m, 8, 512, bs, h, hkv,
                                           d, dtype, cuda, density=1.0)
    kl[0] = 2048
    tables = pa_ref.fused_tables_ref(w0, cl, tn)
    fused = pa.fused_chain_attention_cuda(q, pk, pv, w0, cl, tn, kl)
    via_tables = pa.paged_attention_cuda(q, pk, pv, tables, kl)
    torch.cuda.synchronize()
    assert torch.equal(fused, via_tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_apply_on_card_equals_cpu(cuda, arch, dtype):
    """``moe_apply`` of a smoke config on the card against the CPU on the
    same weights and tokens (64 tokens in two dispatch groups, capacity
    drops included): the same routing and drops, outputs within the
    dtype's tolerance, the same aux loss."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(smoke_config(arch), dispatch_groups=2,
                              capacity_factor=0.5)
    p = moe.moe_init(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=dtype)
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    p_card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()} if isinstance(v, dict)
                  else v.to(cuda)) for k, v in p.items()}
    want, want_aux = moe.moe_apply(cfg, p, x)
    got, got_aux = moe.moe_apply(cfg, p_card, x.to(cuda))
    xt = x.reshape(2, 32, cfg.d_model)
    cap = moe.capacity(32, cfg)
    (_, _, ti_cpu), (_, _, ti_card) = (moe.route(cfg, p, xt),
                                       moe.route(cfg, p_card, xt.to(cuda)))
    assert torch.equal(ti_card.cpu(), ti_cpu)
    slot_cpu = moe.dispatch(xt, ti_cpu, cfg.n_experts, cap)[1]
    slot_card = moe.dispatch(xt.to(cuda), ti_card, cfg.n_experts, cap)[1]
    assert torch.equal(slot_card.cpu(), slot_cpu)
    assert int((slot_cpu == cfg.n_experts * cap).sum()) > 0      # drops
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


def _grad_rel(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-moe-a2.7b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-base"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """One training step's loss and every gradient leaf on the card against
    the CPU on the same weights (bf16 compute on both; within bf16's 2e-2
    relative L2), the pipeline's tokens (and Whisper's frames) bitwise
    equal, and after one ``make_train_step`` step AdamW's ``m`` within the
    same bound."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import leaves, tree_map, unflatten

    model = get_model(smoke_config(arch))
    cpu_params = model.init(torch.Generator().manual_seed(1), device="cpu")
    card_params = tree_map(lambda x: x.to(cuda), cpu_params)
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32, global_batch=4)
    kw = dict(with_frames=model.cfg.enc_frames if model.cfg.family == "encdec" else 0,
              d_model=model.cfg.d_model)
    cpu_batch, card_batch = (batch_at(dcfg, 3, device=dev, **kw) for dev in ("cpu", cuda))
    for k in cpu_batch:
        assert torch.equal(card_batch[k].cpu(), cpu_batch[k])

    def value_and_grad(params, batch):
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = model.loss(unflatten(params, xs), batch)
        return loss, torch.autograd.grad(loss, xs, materialize_grads=True,
                                         allow_unused=True)

    want_loss, want = value_and_grad(cpu_params, cpu_batch)
    got_loss, got = value_and_grad(card_params, card_batch)
    assert _grad_rel(got_loss, want_loss) < 2e-2
    for a, b in zip(want, got):
        assert b.is_cuda and _grad_rel(b, a) < 2e-2
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3))
    _, cpu_opt, _ = step(cpu_params, adamw.init(cpu_params), cpu_batch)
    _, card_opt, _ = step(card_params, adamw.init(card_params), card_batch)
    for a, b in zip(leaves(cpu_opt["m"]), leaves(card_opt["m"])):
        assert _grad_rel(b, a) < 2e-2


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-base", "rwkv6-3b"])
def test_trainer_crash_restart_on_card(cuda, arch):
    """The smoke trainer on the card: crash after step 5, the kernel
    restores (K2 + K8, K1 + K8) equal the ``direct`` restore word for word
    and the last saved image, the resume lands at step 3, and the final
    loss equals the uninterrupted run's within the JAX test's 1e-5."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import store
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = get_model(smoke_config(arch))
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16, global_batch=2)
    tcfg = TrainerConfig(total_steps=9, ckpt_every=3, page_size=256)
    ref = Trainer(model, AdamWConfig(lr=1e-3), dcfg, tcfg, seed=0, device=cuda)
    ref.run()
    t = Trainer(model, AdamWConfig(lr=1e-3), dcfg, tcfg, seed=0, device=cuda)
    with pytest.raises(RuntimeError, match="simulated crash"):
        t.run(crash_after=5)
    direct = store.materialize(t.ckpt.chain, method="direct")
    assert torch.equal(direct, t.ckpt._shadow)
    _build.reset_launches()
    for method in ("pallas_vanilla", "pallas_direct"):
        assert torch.equal(store.materialize(t.ckpt.chain, method=method), direct)
    assert _build.LAUNCHES["resolve_direct_fleet"] > 0
    assert _build.LAUNCHES["resolve_vanilla_fleet"] > 0
    assert _build.LAUNCHES["gather"] > 0
    assert t.resume(method="pallas_direct") == 3
    t.run()
    np.testing.assert_allclose(t.losses[-1], ref.losses[-1], rtol=1e-5)


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank ``nccl`` host mesh for one test, destroyed after it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    yield make_host_mesh(device=cuda)
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-moe-a2.7b", "rwkv6-3b"])
def test_sharded_equals_plain_on_card(nccl_mesh, arch):
    """Parameters placed by ``param_shardings`` on the one-rank ``nccl``
    mesh, under ``use_rules``: prefill logits and a decode step bitwise
    the plain run's on the card (``chip_smoke.py`` phase 14b)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import get_model
    from repro_torch.models.api import make_batch

    cfg = smoke_config(arch)
    model = get_model(cfg)
    rules = sh.make_rules(nccl_mesh)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = make_batch(cfg, 0, 2, 8, device="cuda")
    dparams = sh.distribute(params, sh.param_shardings(params, rules))
    dbatch = sh.distribute(batch, sh.shardings_of(sh.batch_spec(batch, rules),
                                                  nccl_mesh))
    tok = batch["tokens"][:, :1]
    cache = model.init_cache(2, 12, device="cuda")
    dcache = sh.distribute(model.init_cache(2, 12, device="cuda"),
                           sh.shardings_of(sh.cache_specs(cache, rules), nccl_mesh))
    with torch.no_grad():
        logits, _ = model.prefill(params, batch)
        step, _ = model.decode_step(params, cache, tok)
        with sh.use_rules(rules):
            dlogits, _ = model.prefill(dparams, dbatch)
            dstep, _ = model.decode_step(dparams, dcache, sh.place(
                tok, sh.NamedSharding(nccl_mesh, sh.P("data", None))))
    assert isinstance(dlogits, DTensor)
    assert torch.equal(dlogits.full_tensor(), logits)
    assert torch.equal(dstep.full_tensor(), step)


def test_dp_step_is_train_step_on_card(nccl_mesh):
    """``make_dp_train_step(compress=False)`` on the one-rank ``nccl``
    group is bitwise ``make_train_step`` on the card, three steps, under
    deterministic algorithms (the embedding gradient's scatter-add sums in
    one order); with compression every residual is within its leaf's
    scale (``chip_smoke.py`` phase 14d)."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import compression as comp
    from repro_torch.models import get_model
    from repro_torch.models.api import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch.tree import leaves

    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3)

    def fresh():
        p = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        return p, adamw.init(p)

    ref = make_train_step(model, ocfg)
    dp = comp.make_dp_train_step(model, ocfg, nccl_mesh, compress=False)
    dpc = comp.make_dp_train_step(model, ocfg, nccl_mesh, compress=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (p1, o1), (p2, o2), (p3, o3) = fresh(), fresh(), fresh()
        e2, e3 = comp.init_error_state(p2), comp.init_error_state(p3)
        for i in range(3):
            b = make_batch(cfg, i, 4, 16, device="cuda")
            p1, o1, met = ref(p1, o1, b)
            p2, o2, e2, loss = dp(p2, o2, e2, b)
            assert torch.equal(loss, met["loss"])
            grads = value_and_grad(model.loss, p3, b)[1]
            scales = [comp.quantize_int8(g.float() + e)[1]
                      for g, e in zip(leaves(grads), leaves(e3))]
            p3, o3, e3, _ = dpc(p3, o3, e3, b)
            for e, s in zip(leaves(e3), scales):
                assert bool((e.abs() <= s).all())
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)
