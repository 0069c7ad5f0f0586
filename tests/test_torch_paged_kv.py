"""The port's ``PagedKVCache`` against ``repro.kvcache.paged``.

The op sequences of four ``tests/test_serve_fleet.py`` cases are replayed
on both packages, for both fork formats: block tables, owners,
``lookup_count``, ``blocks_in_use``, the fleet's L2 words and the KV
pools must match bit for bit after every step.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kvcache import paged as jpaged  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402

GEOM = dict(n_layers=1, n_kv_heads=1, head_dim=4, block_size=4, n_blocks=512)


class Pair:
    """One JAX cache and one port cache driven by the same ops."""

    def __init__(self, scalable, max_blocks=16):
        self.j = jpaged.PagedKVCache(
            jpaged.PagedKVConfig(max_blocks_per_seq=max_blocks, dtype=jnp.float32,
                                 **GEOM), scalable=scalable)
        self.t = tpaged.PagedKVCache(
            tpaged.PagedKVConfig(max_blocks_per_seq=max_blocks, dtype=torch.float32,
                                 **GEOM), scalable=scalable, device="cpu")

    def __getattr__(self, op):
        """Apply ``op`` to both caches; numpy arguments reach each package
        as its own arrays. Returns both results."""
        def both(*args):
            ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
            ta = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
            return getattr(self.j, op)(*ja), getattr(self.t, op)(*ta)
        return both

    def check(self, sids):
        jr, tr = self.j._resolve_all(), self.t._resolve_all()
        for name, a, b in zip(("tables", "owners", "lookups", "cold"), jr, tr):
            np.testing.assert_array_equal(b, a, err_msg=name)
        np.testing.assert_array_equal(self.t.fleet.l2.numpy(),
                                      np.asarray(self.j.fleet.l2).view(np.int32))
        np.testing.assert_array_equal(self.t.fleet.length.numpy(),
                                      np.asarray(self.j.fleet.length))
        np.testing.assert_array_equal(self.t.pool_k.numpy(), np.asarray(self.j.pool_k))
        jt, _ = self.j.batched_tables(sids)
        tt, _ = self.t.batched_tables(sids)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for sid in sids:
            np.testing.assert_array_equal(self.t._resolve_oracle(sid)[0],
                                          self.j._resolve_oracle(sid)[0])
            np.testing.assert_array_equal(self.t.block_table(sid).numpy(),
                                          np.asarray(self.j.block_table(sid)))
            assert self.t.seq_length(sid) == self.j.seq_length(sid)
        assert self.t.lookup_count == self.j.lookup_count
        assert self.t.blocks_in_use() == self.j.blocks_in_use()


def tok(val):
    return np.full((1, 1, 4), val, np.float32)


def prompt(n, base=1.0):
    k = np.arange(n, dtype=np.float32)[None, :, None, None] + base
    return np.ascontiguousarray(np.broadcast_to(k, (1, n, 1, 4)))


@pytest.mark.parametrize("scalable", [True, False])
@pytest.mark.parametrize("depth", [1, 8, 33])
def test_fork_chain_parity(scalable, depth):
    """Fork chains (every node appends, alternate parents retired) through
    tenant- and chain-axis growth."""
    c = Pair(scalable)
    sid, _ = c.new_seq()
    c.append_prefill(sid, prompt(6), prompt(6))
    live = [sid]
    val = 10.0
    for d in range(depth):
        child, tchild = c.fork(sid)
        assert child == tchild
        c.append(child, tok(val), tok(val))
        val += 1.0
        if d % 2 == 0:
            c.free_seq(sid)
            live.remove(sid)
        live.append(child)
        sid = child
    c.check(live)
    jk, _ = c.j.gather(sid)
    tk, _ = c.t.gather(sid)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("scalable", [True, False])
def test_parent_writes_propagate_to_forked_tables(scalable):
    c = Pair(scalable)
    g, _ = c.new_seq()
    c.append_prefill(g, prompt(6), prompt(6))
    a, _ = c.fork(g)
    for i in range(2):
        c.append(a, tok(20.0 + i), tok(20.0 + i))
    b, _ = c.fork(a)
    for i in range(5):
        c.append(a, tok(30.0 + i), tok(30.0 + i))
    c.check([g, a, b])
    c.append(b, tok(40.0), tok(40.0))
    c.check([g, a, b])


@pytest.mark.parametrize("scalable", [True, False])
def test_same_step_chained_ancestor_descendant_cow(scalable):
    c = Pair(scalable)
    g, _ = c.new_seq()
    c.append_prefill(g, prompt(1, base=7.0), prompt(1, base=7.0))
    a, _ = c.fork(g)
    b, _ = c.fork(a)
    jt, tt = c.prepare_step([g, a, b])
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    np.testing.assert_array_equal(tt[1].numpy(), np.asarray(jt[1]))
    for s in (a, b):
        assert float(c.t.gather(s)[0][0, 0, 0, 0]) == 7.0
    c.check([g, a, b])


@pytest.mark.parametrize("scalable", [True, False])
def test_prepare_step_fused_plan_matches_tables(scalable):
    c = Pair(scalable, max_blocks=128)
    sid, _ = c.new_seq()
    c.append_prefill(sid, prompt(6), prompt(6))
    a, _ = c.fork(sid)
    c.append(a, tok(2.0), tok(2.0))
    b, _ = c.fork(a)
    c.append(b, tok(3.0), tok(3.0))
    sids = sorted({sid, a, b})
    jt, tt = c.prepare_step(sids)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    jplan, tplan = c.prepare_step_fused(sids)
    np.testing.assert_array_equal(tplan.l2.numpy(),
                                  np.asarray(jplan.l2).view(np.int32))
    for f in ("chain_lengths", "tenants", "lengths", "write_blocks"):
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)), err_msg=f)
    from repro_torch.kernels.paged_attention import ref as tref
    derived = tref.fused_tables_ref(tplan.l2[..., 0], tplan.chain_lengths,
                                    tplan.tenants)
    np.testing.assert_array_equal(derived.numpy(), tt[0].numpy())
    c.check(sids)
