"""The port's paged decode attention (K3 through tables, K4 fused with the
chain walk) against the JAX oracles and Pallas kernels.

Tolerances are those of ``tests/test_kernels.py``: f32 2e-5, bf16 2e-2.
On the CPU the port runs its plain versions (``test_torch_gpu.py`` holds the
CUDA kernels against them on the card).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import format as jfmt  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    fused_chain_attention_pallas, paged_attention_pallas)
from repro_torch.core import format as tfmt  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arr(x, jdt, tdt):
    """One numpy array handed to both packages in the working dtype."""
    j = jnp.asarray(x).astype(jdt)
    t = torch.as_tensor(np.asarray(j.astype(jnp.float32))).to(tdt)
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def tables_case(seed, b, h, hkv, d, bs, m, nb=64, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d))
    pk = rng.standard_normal((nb, bs, hkv, d))
    pv = rng.standard_normal((nb, bs, hkv, d))
    if lengths is None:
        lengths = [1, bs * m // 2 + 1, bs * m][:b]
    lengths = np.array(lengths, np.int32)
    tables = np.where(np.arange(m)[None, :] * bs < lengths[:, None],
                      rng.integers(0, nb, (b, m)), -1).astype(np.int32)
    return q, pk, pv, tables, lengths


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,hkv,d,bs,m", [
    (8, 2, 64, 16, 4),    # GQA 4:1
    (4, 4, 128, 32, 2),   # MHA
    (16, 1, 64, 8, 8),    # MQA
])
def test_paged_attention_matches_jax(dt, h, hkv, d, bs, m):
    _, jdt, tdt, tol = DTYPES[dt]
    q, pk, pv, tables, lengths = tables_case(h * d + m, 3, h, hkv, d, bs, m)
    (jq, tq), (jk, tk), (jv, tv) = (_arr(x, jdt, tdt) for x in (q, pk, pv))
    want_ref = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(tables),
                                        jnp.asarray(lengths))
    want_pal = paged_attention_pallas(jq, jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = tops.paged_attention(tq, tk, tv, torch.as_tensor(tables),
                               torch.as_tensor(lengths))
    assert got.dtype == tdt
    _close(got, want_ref.astype(jnp.float32), tol)
    _close(got, want_pal.astype(jnp.float32), tol)


def fused_case(seed, t, c, p, b, nb, bs, h, hkv, d, density=0.55):
    """A packed (T, C, P) index whose ptrs address a real KV pool (holes
    included), ragged chain lengths, a batch over a subset of tenants
    (repeats allowed), ragged kv lengths."""
    rng = np.random.default_rng(seed)
    w0 = np.array(jfmt.pack_entry(
        jnp.asarray(rng.integers(0, nb, (t, c, p)).astype(np.uint32)),
        jnp.asarray(rng.integers(0, c, (t, c, p)).astype(np.uint32)),
        allocated=jnp.asarray(rng.random((t, c, p)) < density),
        bfi_valid=jnp.asarray(rng.random((t, c, p)) < 0.7),
        zero=jnp.asarray(rng.random((t, c, p)) < 0.1),
    ))[..., 0]
    chain_lengths = rng.integers(1, c + 1, t).astype(np.int32)
    tenants = rng.integers(0, t, b).astype(np.int32)
    kv_lengths = rng.integers(1, p * bs + 1, b).astype(np.int32)
    q = rng.standard_normal((b, h, d))
    pk = rng.standard_normal((nb, bs, hkv, d))
    pv = rng.standard_normal((nb, bs, hkv, d))
    return q, pk, pv, w0, chain_lengths, tenants, kv_lengths


def _fused_both(case, dt):
    _, jdt, tdt, tol = DTYPES[dt]
    q, pk, pv, w0, cl, tn, kl = case
    (jq, tq), (jk, tk), (jv, tv) = (_arr(x, jdt, tdt) for x in (q, pk, pv))
    jargs = (jq, jk, jv, jnp.asarray(w0), jnp.asarray(cl), jnp.asarray(tn),
             jnp.asarray(kl))
    targs = (tq, tk, tv, tfmt.words(w0), torch.as_tensor(cl), torch.as_tensor(tn),
             torch.as_tensor(kl))
    return jargs, targs, tol


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t,c,p,h,hkv,d,bs", [
    (4, 6, 128, 8, 2, 64, 8),     # GQA 4:1, multi-layer chains, holes
    (3, 1, 128, 4, 4, 32, 4),     # MHA, C=1: direct-path degeneration
    (5, 9, 16, 16, 1, 64, 8),     # MQA, a narrow page axis
])
def test_fused_chain_attention_matches_jax(dt, t, c, p, h, hkv, d, bs):
    case = fused_case(t * c * p + h, t, c, p, 3, 32, bs, h, hkv, d)
    jargs, targs, tol = _fused_both(case, dt)
    want_ref = jref.fused_chain_attention_ref(*jargs)
    got = tops.fused_chain_attention(*targs)
    _close(got, want_ref.astype(jnp.float32), tol)
    if p % 128 == 0:      # the Pallas kernel tiles 128 page lanes
        want_pal = fused_chain_attention_pallas(*jargs, interpret=True)
        _close(got, want_pal.astype(jnp.float32), tol)
    # the resolved tables themselves are exact
    np.testing.assert_array_equal(
        tref.fused_tables_ref(targs[3], targs[4], targs[5]).numpy(),
        np.asarray(jref.fused_tables_ref(jargs[3], jargs[4], jargs[5])))


def test_fused_all_masked_row_is_zero():
    """A row whose chain misses everywhere comes out all-zero, as in the
    JAX kernel and oracle."""
    q, pk, pv, w0, cl, tn, kl = fused_case(77, 2, 3, 128, 2, 16, 4, 4, 2, 32)
    w0[1] = 0                      # tenant 1 owns nothing anywhere
    tn = np.array([0, 1], np.int32)
    jargs, targs, _ = _fused_both((q, pk, pv, w0, cl, tn, kl), "f32")
    want = fused_chain_attention_pallas(*jargs, interpret=True)
    got = tops.fused_chain_attention(*targs)
    assert torch.count_nonzero(got[1]) == 0
    _close(got, want, 2e-5)


def test_paged_attention_matches_dense_attention():
    """Paged attention over a contiguous table == the prefill attention."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(1)
    b, h, hkv, d, bs, m = 2, 8, 4, 32, 8, 4
    q = torch.as_tensor(rng.standard_normal((b, 1, h, d)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((b, bs * m, hkv, d)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((b, bs * m, hkv, d)), dtype=torch.float32)
    dense = L.attention_ref(q, k, v, causal=False, kv_len=19)[:, 0]
    tables = torch.arange(b * m, dtype=torch.int32).reshape(b, m)
    paged = tref.paged_attention_ref(q[:, 0], k.reshape(b * m, bs, hkv, d),
                                     v.reshape(b * m, bs, hkv, d), tables,
                                     torch.full((b,), 19, dtype=torch.int32))
    np.testing.assert_allclose(dense.numpy(), paged.numpy(), rtol=2e-5, atol=2e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; only ``ops`` hands CPU tensors
    to the plain versions."""
    q, pk, pv, tables, lengths = (torch.as_tensor(x) for x in
                                  tables_case(3, 3, 8, 2, 64, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(q.float(), pk.float(), pv.float(), tables, lengths)
    case = fused_case(4, 2, 3, 16, 2, 16, 4, 4, 2, 32)
    _, targs, _ = _fused_both(case, "f32")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.fused_chain_attention_cuda(*targs)



# -- the CUDA kernels' split algorithm, in plain PyTorch ----------------------


def split_case(seed, h, hkv, d, bs, m, pps):
    """Rows of length 0, one ending exactly on the first split boundary, a
    full row and one ending mid-page."""
    return tables_case(seed, 4, h, hkv, d, bs, m, lengths=[
        0, min(pps, m) * bs, bs * m, bs * m // 2 + 1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pps", [1, 3, 8, "M"])
@pytest.mark.parametrize("h,hkv,d,bs,m", [
    (8, 2, 64, 16, 12),   # GQA 4:1
    (16, 1, 32, 8, 9),    # MQA
])
def test_split_ref_matches_jax(dt, pps, h, hkv, d, bs, m):
    """Per-split partials folded in split order == the JAX oracle, for one
    page a split up to the whole table; the length-0 row is zeros."""
    _, jdt, tdt, tol = DTYPES[dt]
    pps = m if pps == "M" else pps
    q, pk, pv, tables, lengths = split_case(h + m + pps, h, hkv, d, bs, m, pps)
    (jq, tq), (jk, tk), (jv, tv) = (_arr(x, jdt, tdt) for x in (q, pk, pv))
    want = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(tables),
                                    jnp.asarray(lengths))
    got = tref.paged_attention_split_ref(tq, tk, tv, torch.as_tensor(tables),
                                         torch.as_tensor(lengths), pps)
    assert got.dtype == tdt
    _close(got, want.astype(jnp.float32), tol)
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pps", [1, 3, 8, "P"])
def test_split_ref_fused_composition_with_a_split_of_holes(dt, pps):
    """The fused composition on the split algorithm: a split whose pages
    are all holes contributes nothing, as in the JAX oracle."""
    t, c, p, bs = 3, 6, 24, 8
    pps = p if pps == "P" else pps
    q, pk, pv, w0, cl, tn, kl = fused_case(31 + pps, t, c, p, 3, 32, bs, 8, 2, 64)
    lo = pps if pps < p else 0
    w0[:, :, lo:lo + pps] = 0            # no layer owns this split's pages
    kl[:] = p * bs
    jargs, targs, tol = _fused_both((q, pk, pv, w0, cl, tn, kl), dt)
    want = jref.fused_chain_attention_ref(*jargs)
    tables = tref.fused_tables_ref(targs[3], targs[4], targs[5])
    assert (tables[:, lo:lo + pps] == -1).all()
    got = tref.paged_attention_split_ref(targs[0], targs[1], targs[2], tables,
                                         targs[6], pps)
    _close(got, want.astype(jnp.float32), tol)


# -- the shared-table entry ---------------------------------------------------


def suffix_case(seed, h, hkv, d, bs, prefix_pages=3, rows=32, padded=8,
                nb=64):
    """The suffix prefill's shape at a small size: ``rows`` positions of
    one sequence over ``prefix_pages`` full pages, lengths prefix + i + 1,
    the last ``padded`` rows at length 1; one table, -1 past its pages."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, h, d))
    pk = rng.standard_normal((nb, bs, hkv, d))
    pv = rng.standard_normal((nb, bs, hkv, d))
    real = rows - padded
    lengths = np.ones(rows, np.int32)
    lengths[:real] = prefix_pages * bs + 1 + np.arange(real)
    m = -(-(prefix_pages * bs + real) // bs) + 2
    table = np.full(m, -1, np.int32)
    table[:m - 2] = rng.permutation(nb)[:m - 2]
    return q, pk, pv, table, lengths


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,hkv", [(8, 8), (16, 2)])     # G 1 and G 8
def test_shared_table_entry_matches_jax(dt, h, hkv):
    """The shared-table entry's plain version (and ``ops`` on CPU tensors)
    == the JAX kernel and oracle on the table repeated for every row: 3
    prefix pages, 32 rows of which 8 are padded at length 1."""
    _, jdt, tdt, tol = DTYPES[dt]
    q, pk, pv, table, lengths = suffix_case(h + hkv, h, hkv, 64, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_arr(x, jdt, tdt) for x in (q, pk, pv))
    tables = np.repeat(table[None], len(lengths), 0)
    want_ref = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(tables),
                                        jnp.asarray(lengths))
    want_pal = paged_attention_pallas(jq, jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = tops.paged_attention_shared_table(tq, tk, tv, torch.as_tensor(table),
                                            torch.as_tensor(lengths))
    assert got.dtype == tdt and got.shape == tq.shape
    _close(got, want_ref.astype(jnp.float32), tol)
    _close(got, want_pal.astype(jnp.float32), tol)
    assert torch.equal(got, tref.paged_attention_ref(
        tq, tk, tv, torch.as_tensor(tables), torch.as_tensor(lengths)))


def test_suffix_prefill_reads_the_shared_table(monkeypatch):
    """``paged_suffix_prefill`` hands attention row 0 of its (S, M) tables
    through the shared-table entry, once a layer, and never the
    JAX-signature one; its logits and pools are bitwise those of the same
    pass through the per-row tables."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import paged_decode

    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    nb, bs, s, m = 32, 4, 8, 8
    rng = np.random.default_rng(0)
    pools = [torch.as_tensor(rng.standard_normal(
        (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)), dtype=torch.float32)
        for _ in range(2)]
    table = torch.as_tensor(rng.permutation(nb)[:m].astype(np.int32))
    lens = torch.as_tensor(np.r_[13 + np.arange(6), 1, 1].astype(np.int32))
    blk = table[(lens - 1) // bs].to(torch.int32)
    blk[6:] = 0
    off = (lens - 1) % bs
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s)))
    tables = table[None].repeat(s, 1)

    def run():
        pk, pv = (x.clone() for x in pools)
        return paged_decode.paged_suffix_prefill(cfg, params, pk, pv, tables,
                                                 blk, off, lens, tokens)

    per_row = paged_decode.pa_ops.paged_attention
    with monkeypatch.context() as mp:     # the same pass through the tables
        mp.setattr(paged_decode.pa_ops, "paged_attention_shared_table",
                   lambda q, pk, pv, t, n: per_row(q, pk, pv, tables, n))
        want = run()
    seen = []
    shared = paged_decode.pa_ops.paged_attention_shared_table

    def counted(q, pk, pv, t, n):
        seen.append(torch.equal(t, table) and n is lens)
        return shared(q, pk, pv, t, n)

    def refused(*args):
        raise AssertionError("the suffix prefill took the per-row tables")

    monkeypatch.setattr(paged_decode.pa_ops, "paged_attention_shared_table",
                        counted)
    monkeypatch.setattr(paged_decode.pa_ops, "paged_attention", refused)
    got = run()
    assert seen == [True] * cfg.n_layers
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the split planner ---------------------------------------------------------

# the serving engine's decode batch (chip_smoke.py phase 4): rows of 80-528
# tokens after 16 steps, padded to 8 with a length-1 row
ENGINE_LENGTHS = [80, 208, 336, 528, 80, 208, 336, 1]


def test_planner_depends_on_shapes_only_and_agrees_for_k3_and_k4():
    """K3 plans with its table width M, K4 with its page axis P: the layout,
    the pages a split covers, the ring and the combine are the same, so the
    two partition every row alike."""
    for b, hkv in [(1, 1), (8, 2), (64, 2), (256, 8), (4096, 8)]:
        for g in (1, 4, 6, 7, 8, 16):
            for dtype in (torch.bfloat16, torch.float32):
                k3 = tpa.plan(b, g * hkv, hkv, 128, 16, dtype, 132)
                k4 = tpa.plan(b, g * hkv, hkv, 256, 16, dtype, 132)
                assert (k3.layout, k3.warps, k3.pages_per_split, k3.stages,
                        k3.warp_combine, k3.grid[1:]) == (
                    k4.layout, 1, k4.pages_per_split, k4.stages,
                    k4.warp_combine, k4.grid[1:])
                assert k3.pages_per_split == tpa.pages_per_split(b, hkv, 132)
                assert k3.pages_per_split in (1, tpa.WIDE_PAGES_PER_SPLIT)
                assert k4.splits == -(-256 // k4.pages_per_split)
                assert k3 == tpa.plan(b, g * hkv, hkv, 128, 16, dtype, 132)


@pytest.mark.parametrize("g", [1, 4, 6, 7, 8, 12, 16, 32])
def test_planner_picks_the_layout_from_the_group(g):
    """bf16 puts tokens on the mma's rows for every group of the repo's
    configs (1-8) and query heads above 8; f32 keeps its FFMA body. Neither
    depends on the batch, the lengths or the table width; a block is one
    warp either way."""
    for b, m in [(1, 16), (8, 128), (512, 128)]:
        p = tpa.plan(b, 2 * g, 2, m, 16, torch.bfloat16, 132)
        assert p.layout == (tpa.TOKENS if g <= tpa.TOKENS_MAX_GROUP else tpa.HEADS)
        assert p.warps == 1
        assert p.grid[1] == 2 * -(-g // tpa.head_tile(torch.bfloat16, p.layout))
        f = tpa.plan(b, 2 * g, 2, m, 16, torch.float32, 132)
        assert (f.layout, f.warps) == (tpa.HEADS, 1)
        assert f.grid[1] == 2 * -(-g // 8)


def test_planner_takes_two_pages_a_split_once_the_pairs_outnumber_the_sms():
    """One page a split up to as many (row, KV head) pairs as SMs, then
    two; the suffix prefill's batch 64 over 2 KV heads stays at one."""
    assert tpa.pages_per_split(64, 2, 132) == 1
    assert tpa.pages_per_split(66, 2, 132) == 1
    assert tpa.pages_per_split(67, 2, 132) == tpa.WIDE_PAGES_PER_SPLIT == 2
    assert tpa.pages_per_split(64, 4, 132) == 2
    assert tpa.pages_per_split(4096, 8, 132) == 2


def test_planner_fills_the_card_at_the_engine_state():
    """Batch 8, 2 KV heads, M 128 (Qwen2.5-3B's decode): tokens on the
    mma's rows, one page a split; the blocks that attend over something
    cover the card's 132 SMs."""
    p = tpa.plan(8, 16, 2, 128, 16, torch.bfloat16, 132)
    assert p.pages_per_split == 1 and p.grid == (128, 2, 8)
    assert p.layout == tpa.TOKENS and not p.warp_combine
    assert p.working_blocks(ENGINE_LENGTHS, 16, 128) >= 132
    long = p.working_blocks([2048] * 8, 16, 128)
    assert long == 8 * 2 * 128


def test_planner_takes_the_warp_combine_for_many_pairs():
    """The combine takes a warp a (row, head) from 8 pairs an SM up: the
    suffix prefill's 256 rows and batch 512, not the engine's batch 8."""
    assert tpa.warp_combine(256, 16, 132) and tpa.warp_combine(512, 16, 132)
    assert not tpa.warp_combine(8, 16, 132) and not tpa.warp_combine(64, 16, 132)
    assert tpa.warp_combine(66, 16, 132) == (66 * 16 >= 8 * 132)
    assert tpa.plan(512, 16, 2, 128, 16, torch.bfloat16, 132).warp_combine


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_planner_ring_and_shared_memory(dtype, bs):
    """Stages never exceed the tiles of a split, and every head dim the
    kernels are built for fits a block's shared memory at every batch,
    also through the shared-table plan at every warp count it takes."""
    for b in (1, 8, 64, 4096):
        for d in tpa.HEAD_DIMS:
            p = tpa.plan(b, 16, 2, 128, bs, dtype, 132)
            assert 1 <= p.stages <= min(tpa.MAX_STAGES,
                                        -(-p.pages_per_split * bs // tpa.TILE))
            assert max(tpa._smem_bytes(dtype, d, p)) <= tpa._SMEM_LIMIT
            for rows in (b, 3, 7):       # 1 to 4 query tiles a block
                s = tpa.shared_plan(rows, 16, 2, 128, bs, dtype, 132)
                assert max(tpa._smem_bytes(dtype, d, s)) <= tpa._SMEM_LIMIT


@pytest.mark.parametrize("g", [1, 6, 8])
def test_shared_table_plan(g):
    """The shared table's bf16 plan: 16 (row, head) queries a warp, blocks
    of up to ``SHARED_WARPS`` query tiles over ``SHARED_PAGES_PER_SPLIT``
    pages; a query block works up to its longest row. f32 takes the decode
    plan of one-warp blocks."""
    s, hkv, m = 256, 2, 128
    p = tpa.shared_plan(s, g * hkv, hkv, m, 16, torch.bfloat16, 132)
    qt = -(-s * g // 16)
    w = min(tpa.SHARED_WARPS, qt)
    assert (p.layout, p.warps, p.group) == (tpa.HEADS, w, g)
    assert p.pages_per_split == tpa.SHARED_PAGES_PER_SPLIT
    assert p.grid == (-(-m // p.pages_per_split), hkv, -(-qt // w))
    lens = np.ones(s, np.int64)
    lens[:200] = 393 + np.arange(200)
    span = p.pages_per_split * 16
    per = 16 * w
    want = sum(-(-int(lens[z * per // g:-(-(z + 1) * per // g)].max()) // span)
               for z in range(p.grid[2])) * hkv
    assert p.working_blocks(lens, 16, m) == want
    assert tpa.shared_plan(4, 2 * g, 2, m, 16, torch.bfloat16, 132).warps \
        == min(tpa.SHARED_WARPS, -(-4 * g // 16))
    f = tpa.shared_plan(s, g * hkv, hkv, m, 16, torch.float32, 132)
    assert f == tpa.plan(s, g * hkv, hkv, m, 16, torch.float32, 132)
