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


# -- the split planner ---------------------------------------------------------

# the serving engine's decode batch (chip_smoke.py phase 4): rows of 80-528
# tokens after 16 steps, padded to 8 with a length-1 row
ENGINE_LENGTHS = [80, 208, 336, 528, 80, 208, 336, 1]


def test_planner_depends_on_shapes_only_and_agrees_for_k3_and_k4():
    """K3 plans with its table width M, K4 with its page axis P: the pages
    a split covers are the same, so the two partition every row alike."""
    for b, hkv in [(1, 1), (8, 2), (64, 2), (256, 8), (4096, 8)]:
        k3 = tpa.plan(b, 8 * hkv, hkv, 128, 16, torch.bfloat16, 132)
        k4 = tpa.plan(b, 8 * hkv, hkv, 256, 16, torch.bfloat16, 132)
        assert k3.pages_per_split == k4.pages_per_split \
            == tpa.pages_per_split(b, hkv, 132)
        assert k4.splits == -(-256 // k4.pages_per_split)
        assert k3.pages_per_split in (1, tpa.WIDE_PAGES_PER_SPLIT)
        assert k3 == tpa.plan(b, 8 * hkv, hkv, 128, 16, torch.bfloat16, 132)


def test_planner_takes_two_pages_a_split_once_the_pairs_outnumber_the_sms():
    """One page a split up to as many (row, KV head) pairs as SMs, then
    two; the suffix prefill's batch 64 over 2 KV heads stays at one."""
    assert tpa.pages_per_split(64, 2, 132) == 1
    assert tpa.pages_per_split(66, 2, 132) == 1
    assert tpa.pages_per_split(67, 2, 132) == tpa.WIDE_PAGES_PER_SPLIT == 2
    assert tpa.pages_per_split(64, 4, 132) == 2
    assert tpa.pages_per_split(4096, 8, 132) == 2


def test_planner_fills_the_card_at_the_engine_state():
    """Batch 8, 2 KV heads, M 128 (Qwen2.5-3B's decode): the blocks that
    attend over something cover the card's 132 SMs."""
    p = tpa.plan(8, 16, 2, 128, 16, torch.bfloat16, 132)
    assert p.pages_per_split == 1 and p.grid == (128, 2, 8)
    assert p.working_blocks(ENGINE_LENGTHS, 16, 128) >= 132
    long = p.working_blocks([2048] * 8, 16, 128)
    assert long == 8 * 2 * 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_planner_ring_and_shared_memory(dtype, bs):
    """Stages never exceed the tiles of a split, and every head dim the
    kernels are built for fits a block's shared memory at every batch."""
    for b in (1, 8, 64, 4096):
        for d in tpa.HEAD_DIMS:
            p = tpa.plan(b, 16, 2, 128, bs, dtype, 132)
            assert 1 <= p.stages <= min(tpa.MAX_STAGES,
                                        -(-p.pages_per_split * bs // tpa.TILE))
            assert max(tpa._smem_bytes(dtype, d, p)) <= tpa._SMEM_LIMIT
