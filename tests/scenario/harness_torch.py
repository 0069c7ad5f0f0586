"""Seeded chaos/scenario harness for the PyTorch port (``repro_torch``):
the storm of ``tests/scenario/harness.py`` on the port's fleet, store,
golden registry, maintenance scheduler and paged KV cache.

Same events, same weights, same order of ``rng`` draws and the same
plain-primitive records as the JAX harness, so one seed gives one trace
on both packages (``tests/test_torch_scenario.py`` runs the two in
lockstep). The one added field is ``ScenarioConfig.device``: the device
of both fleets and both caches (``"cuda"`` drives the card's kernels,
``"cpu"`` their plain versions). The host tier (``TieredStore``) lives
on the host either way.

The port's fleet and cache ops update their tensors in place, where the
JAX package's are functional. So every value this harness keeps across
an op — a "before" count, an oracle row, a blob's words — is an owned
host copy (``_host``), never a view of a CPU tensor that the next op
rewrites. The data oracle stays numpy on the host and is never read back
from the system under test, except where the JAX harness re-syncs it
(an overflowed tenant).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import fleet as fleet_lib
from repro_torch.core import format as fmt
from repro_torch.core import migrate
from repro_torch.core import store as store_lib
from repro_torch.core.golden import GoldenRegistry
from repro_torch.core.invariants import (
    check_fleet_invariants,
    check_kv_invariants,
)
from repro_torch.core.scheduler import MaintenanceScheduler
from repro_torch.kvcache.paged import PagedKVCache, PagedKVConfig


def _host(x) -> np.ndarray:
    """An owned host copy: never a view of a tensor an op may rewrite."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    seed: int = 0
    events: int = 200
    #: full data-oracle comparison cadence (invariants run every event)
    check_data_every: int = 10

    # source fleet geometry
    n_tenants: int = 4
    n_pages: int = 32
    page_size: int = 4
    max_chain: int = 6
    pool_capacity: int = 384
    lease_quantum: int = 8

    # destination fleet: deliberately different geometry & lease state
    dst_tenants: int = 3
    dst_max_chain: int = 8
    dst_pool_capacity: int = 512
    dst_lease_quantum: int = 16

    # serving plane (model geometry shared; block/pool/format differ)
    kv_layers: int = 1
    kv_heads: int = 1
    kv_head_dim: int = 4
    kv_blocks: int = 96
    kv_block_size: int = 4
    kv_dst_blocks: int = 64
    kv_dst_block_size: int = 8
    kv_max_blocks: int = 8

    write_batch: int = 2     # fixed (T, B) write shape

    #: device of both fleets and both KV caches
    device: str = "cuda"


class ScenarioHarness:
    """One randomized run. ``run()`` fires ``config.events`` events and
    returns the trace; any invariant violation or oracle mismatch raises
    ``AssertionError`` at the event that caused it."""

    def __init__(self, config: ScenarioConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        c = config
        dev = self.device = torch.device(c.device)

        spec = fleet_lib.FleetSpec(
            n_tenants=c.n_tenants, n_pages=c.n_pages, page_size=c.page_size,
            max_chain=c.max_chain, pool_capacity=c.pool_capacity,
            lease_quantum=c.lease_quantum, l2_per_table=c.n_pages,
        )
        self.store = store_lib.TieredStore.for_fleet(spec)
        self.registry = GoldenRegistry()
        self.sched = MaintenanceScheduler(
            fleet_lib.create(spec, scalable=True, device=dev),
            max_tenants_per_tick=2, store=self.store,
            device_page_budget=c.pool_capacity // 2,
            demote_rows_per_tick=16, registry=self.registry,
        )
        dst_spec = fleet_lib.FleetSpec(
            n_tenants=c.dst_tenants, n_pages=c.n_pages,
            page_size=c.page_size, max_chain=c.dst_max_chain,
            pool_capacity=c.dst_pool_capacity,
            lease_quantum=c.dst_lease_quantum, l2_per_table=c.n_pages,
        )
        self.dst_fleet = fleet_lib.create(dst_spec, scalable=False,
                                          device=dev)
        self.dst_store = store_lib.TieredStore.for_fleet(dst_spec)

        kv_cfg = PagedKVConfig(
            n_layers=c.kv_layers, n_kv_heads=c.kv_heads,
            head_dim=c.kv_head_dim, block_size=c.kv_block_size,
            n_blocks=c.kv_blocks, max_blocks_per_seq=c.kv_max_blocks,
            dtype=torch.float32,
        )
        kv_dst_cfg = dataclasses.replace(
            kv_cfg, block_size=c.kv_dst_block_size, n_blocks=c.kv_dst_blocks,
        )
        # vanilla source: forks keep parent links, so freeing ancestors
        # exercises real tombstone cascades; scalable destination
        self.kv = PagedKVCache(kv_cfg, scalable=False, device=dev)
        self.kv_dst = PagedKVCache(kv_dst_cfg, scalable=True, device=dev)

        # independent oracles, maintained event by event
        self.expected: dict[int, dict[int, np.ndarray]] = {
            t: {} for t in range(c.n_tenants)
        }
        self.dst_expected: dict[int, dict[int, np.ndarray]] = {
            t: {} for t in range(c.dst_tenants)
        }
        # sid -> (k, v) numpy (L, length, H, D), per cache
        self.kv_expected: dict[int, tuple] = {}
        self.kv_dst_expected: dict[int, tuple] = {}
        self.kv_parked: set[int] = set()
        self.kv_golden: set[int] = set()

        self.trace: list[tuple] = []
        self.invariant_checks = 0
        self.guard_hits = 0        # mid-migration guards that fired
        self._step = 0
        # (event kind, event seconds, check seconds) on the host clock
        self.timings: list[tuple[str, float, float]] = []

        self._events = [
            (self.ev_write, 5),
            (self.ev_snapshot, 3),
            (self.ev_stream, 2),
            (self.ev_compact, 1),
            (self.ev_tick, 2),
            (self.ev_demote, 2),
            (self.ev_promote, 1),
            (self.ev_free_attach, 1),
            (self.ev_migrate, 2),
            (self.ev_mid_migration_write, 1),
            (self.ev_golden_register, 1),
            (self.ev_golden_fork, 2),
            (self.ev_golden_release, 1),
            (self.ev_kv_new, 2),
            (self.ev_kv_append, 5),
            (self.ev_kv_fork_storm, 2),
            (self.ev_kv_free, 2),
            (self.ev_kv_park, 1),
            (self.ev_kv_resume, 1),
            (self.ev_kv_migrate, 2),
            (self.ev_kv_mid_migration, 1),
            (self.ev_kv_golden_register, 1),
            (self.ev_kv_golden_admit, 2),
            (self.ev_kv_golden_release, 1),
        ]
        w = np.asarray([wt for _, wt in self._events], np.float64)
        self._weights = w / w.sum()

    def _dev(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), device=self.device)

    # -- fleet-plane events ---------------------------------------------------

    @property
    def fleet(self):
        return self.sched.fleet

    @fleet.setter
    def fleet(self, value):
        self.sched.fleet = value

    def _pick_tenant(self) -> int:
        return int(self.rng.integers(self.config.n_tenants))

    def _owner_mask(self) -> np.ndarray:
        return self.registry.golden_owner_mask(self.config.n_tenants)

    def ev_write(self):
        """COW write burst; partially-applied batches (lease exhaustion)
        reconcile the oracle against how many rows actually landed.
        Registered golden owners are content-frozen and never written;
        forks ARE written — their active volume overlays the shared base."""
        c = self.config
        tmask = (self.rng.random(c.n_tenants) < 0.7) & ~self._owner_mask()
        if not tmask.any():
            writable = np.flatnonzero(~self._owner_mask())
            tmask[int(self.rng.choice(writable))] = True
        ids = np.stack([
            self.rng.choice(c.n_pages, c.write_batch, replace=False)
            for _ in range(c.n_tenants)
        ]).astype(np.int32)
        data = self.rng.standard_normal(
            (c.n_tenants, c.write_batch, c.page_size)
        ).astype(np.float32)
        before = _host(self.fleet.alloc_count)
        self.fleet = fleet_lib.write(
            self.fleet, self._dev(ids), self._dev(data), self._dev(tmask),
        )
        landed = _host(self.fleet.alloc_count) - before
        for t in np.flatnonzero(tmask):
            # write grants rows batch-prefix-first: exactly the first
            # ``landed[t]`` pages of the batch hit the disk
            for i in range(int(landed[t])):
                self.expected[t][int(ids[t, i])] = data[t, i].copy()
        return ("write", tmask.tolist(), landed.tolist())

    def ev_snapshot(self):
        mask = (self.rng.random(self.config.n_tenants) < 0.5) \
            & ~self._owner_mask()
        self.fleet = fleet_lib.snapshot(self.fleet, self._dev(mask))
        return ("snapshot", mask.tolist())

    def ev_stream(self):
        mask = self.rng.random(self.config.n_tenants) < 0.5
        upto = int(self.rng.integers(0, self.config.max_chain - 1))
        self.fleet = fleet_lib.stream_tenants(self.fleet, mask, upto,
                                              registry=self.registry)
        return ("stream", mask.tolist(), upto)

    def ev_compact(self):
        self.fleet = fleet_lib.compact(self.fleet, registry=self.registry)
        return ("compact",)

    def ev_tick(self):
        rep = self.sched.tick()
        return ("tick", sorted(rep) if isinstance(rep, dict) else ())

    def ev_demote(self):
        # an owner pick demotes nothing (registry skip) and a fork pick
        # must leave the pinned base rows hot — both are the demote/fork
        # race the registry exists to win, so no masking here
        t = self._pick_tenant()
        self.fleet, rep = fleet_lib.demote_tenants(
            self.fleet, self.store, [t],
            max_rows=int(self.rng.integers(4, 17)),
            registry=self.registry,
        )
        return ("demote", t, rep["rows_demoted"])

    def ev_promote(self):
        t = self._pick_tenant()
        if int(self.fleet.cold_count[t]) == 0:
            return ("promote", t, "no_cold")
        try:
            self.fleet, rep = fleet_lib.promote_tenants(
                self.fleet, self.store, [t]
            )
        except RuntimeError:
            # device pool can't take the rows back right now — a legal
            # outcome under pressure, not an invariant violation
            return ("promote", t, "pool_exhausted")
        return ("promote", t, rep["rows_promoted"])

    def ev_free_attach(self):
        t = self._pick_tenant()
        if self.registry.is_golden_owner(t):
            return ("free_attach", t, "golden_owner")
        scalable = bool(self.rng.integers(2))
        # freeing a golden fork releases its pins inside free_tenant
        self.fleet = fleet_lib.free_tenant(self.fleet, t, store=self.store,
                                           registry=self.registry)
        self.fleet = fleet_lib.attach_tenant(self.fleet, t, scalable=scalable,
                                             registry=self.registry)
        self.expected[t] = {}
        return ("free_attach", t, scalable)

    def ev_migrate(self):
        """Move a tenant to the different-geometry destination fleet,
        bit-verified; a previous migrant in the landing slot is evicted
        (import resets the slot)."""
        t = self._pick_tenant()
        if self.registry.is_golden_owner(t):
            # a frozen base can't leave while forks may pin it
            return ("migrate", t, "golden_owner")
        d = int(self.rng.integers(self.config.dst_tenants))
        # migrating a fork is legal: export materializes the shared pages
        # into the blob and detach releases the pins
        self.fleet, self.dst_fleet, report = migrate.migrate_tenant(
            self.fleet, t, self.dst_fleet, d,
            src_store=self.store, dst_store=self.dst_store,
            src_registry=self.registry,
        )
        self.fleet = fleet_lib.attach_tenant(self.fleet, t, scalable=True,
                                             registry=self.registry)
        self.dst_expected[d] = self.expected[t]
        self.expected[t] = {}
        return ("migrate", t, d, report["rows_hot"], report["rows_cold"])

    def ev_mid_migration_write(self):
        """A write lands between export and detach: the stale-blob guard
        must refuse the detach and leave the source tenant intact."""
        c = self.config
        t = self._pick_tenant()
        if self.registry.is_golden_owner(t):
            return ("mid_migration_write", t, "golden_owner")
        blob = migrate.export_tenant(self.fleet, t, store=self.store)
        ids = np.broadcast_to(
            self.rng.choice(c.n_pages, c.write_batch,
                            replace=False).astype(np.int32),
            (c.n_tenants, c.write_batch),
        )
        data = self.rng.standard_normal(
            (c.n_tenants, c.write_batch, c.page_size)
        ).astype(np.float32)
        mask = np.zeros(c.n_tenants, bool)
        mask[t] = True
        before = int(self.fleet.alloc_count[t])
        self.fleet = fleet_lib.write(
            self.fleet, self._dev(ids), self._dev(data), self._dev(mask),
        )
        landed = int(self.fleet.alloc_count[t]) - before
        for i in range(landed):
            self.expected[t][int(ids[t, i])] = data[t, i].copy()
        if migrate.tenant_fingerprint(self.fleet, t) == blob.fingerprint:
            # pool-wedged tenant: nothing landed, the blob is still good
            return ("mid_migration_write", t, "wedged_no_change")
        try:
            migrate.detach_tenant(self.fleet, t, blob, store=self.store)
        except migrate.MigrationError:
            self.guard_hits += 1
            return ("mid_migration_write", t, "guard_fired")
        raise AssertionError(
            f"detach of tenant {t} accepted a stale export"
        )

    # -- fleet-plane golden events --------------------------------------------

    def ev_golden_register(self):
        """Freeze a tenant's chain as a golden base. Keeps at least two
        tenants writable so the write/snapshot churn never starves."""
        owners = np.flatnonzero(self._owner_mask())
        if owners.size >= self.config.n_tenants - 2:
            return ("golden_register", "enough_owners")
        cands = [t for t in range(self.config.n_tenants)
                 if self.registry.gid_of(t) is None]
        t = cands[int(self.rng.integers(len(cands)))]
        if int(self.fleet.cold_count[t]) > 0:
            # golden layers must be device-resident; promote first
            try:
                self.fleet, _ = fleet_lib.promote_tenants(
                    self.fleet, self.store, [t])
            except RuntimeError:
                return ("golden_register", t, "pool_exhausted")
        gid, created = self.registry.register(self.fleet, t,
                                              store=self.store)
        return ("golden_register", t, gid, created)

    def ev_golden_fork(self):
        """Fork a registered base into a free slot: the fork's layers
        alias the owner's pinned rows, its oracle starts as the owner's
        frozen view, and later writes overlay it copy-on-write."""
        gids = sorted(self.registry._chains)
        if not gids:
            return ("golden_fork", "no_chains")
        gid = gids[int(self.rng.integers(len(gids)))]
        ch = self.registry._chains[gid]
        cands = [t for t in range(self.config.n_tenants)
                 if self.registry.gid_of(t) is None]
        if not cands:
            return ("golden_fork", gid, "no_free_slot")
        dst = cands[int(self.rng.integers(len(cands)))]
        try:
            self.fleet = self.registry.fork(self.fleet, gid, dst,
                                            store=self.store)
        except ValueError:
            # chain too deep for a fresh active volume on top
            return ("golden_fork", gid, dst, "no_chain_room")
        self.expected[dst] = {
            p: row.copy() for p, row in self.expected[ch.tenant].items()
        }
        return ("golden_fork", gid, dst, ch.length)

    def ev_golden_release(self):
        """Free a live fork (releasing its pins), or unregister a base
        with no forks left — the full golden lifecycle unwinds."""
        forks = sorted(self.registry._forks)
        if forks:
            t = forks[int(self.rng.integers(len(forks)))]
            self.fleet = fleet_lib.free_tenant(
                self.fleet, t, store=self.store, registry=self.registry)
            self.fleet = fleet_lib.attach_tenant(
                self.fleet, t, scalable=True, registry=self.registry)
            self.expected[t] = {}
            return ("golden_release", "fork", t)
        idle = sorted(gid for gid, ch in self.registry._chains.items()
                      if not ch.fork_count)
        if not idle:
            return ("golden_release", "all_pinned")
        gid = idle[int(self.rng.integers(len(idle)))]
        self.registry.unregister(gid)
        return ("golden_release", "unregister", gid)

    # -- serving-plane events -------------------------------------------------

    def _kv_tokens(self, n: int):
        c = self.config
        shape = (c.kv_layers, n, c.kv_heads, c.kv_head_dim)
        return (self.rng.standard_normal(shape).astype(np.float32),
                self.rng.standard_normal(shape).astype(np.float32))

    def _kv_live(self, *, unparked: bool = False,
                 writable: bool = False) -> list[int]:
        sids = sorted(s for s, q in self.kv._seqs.items() if not q.freed)
        if unparked:
            sids = [s for s in sids if s not in self.kv_parked]
        if writable:
            # registered golden prefixes are frozen: no append, park,
            # free or migrate-away — they can only be forked or released
            sids = [s for s in sids if s not in self.kv_golden]
        return sids

    def _kv_room(self, blocks: int) -> bool:
        return len(self.kv._free) >= blocks + 2

    def ev_kv_new(self):
        sid = self.kv.new_seq()
        n = int(self.rng.integers(1, 5))
        bs = self.config.kv_block_size
        if not self._kv_room(-(-n // bs)):
            self.kv_expected[sid] = self._kv_tokens(0)
            return ("kv_new", sid, 0)
        k, v = self._kv_tokens(n)
        self.kv.append_prefill(sid, self._dev(k), self._dev(v))
        self.kv_expected[sid] = (k, v)
        return ("kv_new", sid, n)

    def ev_kv_append(self):
        sids = self._kv_live(unparked=True, writable=True)
        if not sids:
            return ("kv_append", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        n = int(self.rng.integers(1, 5))
        c, bs = self.config, self.config.kv_block_size
        seq = self.kv._seqs[sid]
        if (seq.length + n - 1) // bs >= c.kv_max_blocks:
            return ("kv_append", sid, "at_max")
        if not self._kv_room(-(-n // bs) + 2):
            return ("kv_append", sid, "pool_low")
        k, v = self._kv_tokens(n)
        self.kv.append_prefill(sid, self._dev(k), self._dev(v))
        ek, ev = self.kv_expected[sid]
        self.kv_expected[sid] = (np.concatenate([ek, k], axis=1),
                                 np.concatenate([ev, v], axis=1))
        return ("kv_append", sid, n)

    def ev_kv_fork_storm(self):
        """Fork a live sequence 1–3 times; forking a *parked* parent
        exercises the promote-on-fork race (a spilled table can't be
        shared by block id, so the cache un-spills it first)."""
        sids = self._kv_live()
        if not sids:
            return ("kv_fork_storm", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        n_children = int(self.rng.integers(1, 4))
        children = []
        for _ in range(n_children):
            # room for the promote-on-fork un-spill plus slack
            if not self._kv_room(len(self.kv._seqs[sid].cold) + 2):
                break
            child = self.kv.fork(sid)
            ek, ev = self.kv_expected[sid]
            self.kv_expected[child] = (ek.copy(), ev.copy())
            children.append(child)
        return ("kv_fork_storm", sid, children)

    def ev_kv_free(self):
        sids = self._kv_live(writable=True)
        if len(sids) <= 1:
            return ("kv_free", "too_few")
        sid = sids[int(self.rng.integers(len(sids)))]
        self.kv.free_seq(sid)
        self.kv_parked.discard(sid)
        del self.kv_expected[sid]
        return ("kv_free", sid)

    def ev_kv_park(self):
        sids = self._kv_live(unparked=True, writable=True)
        if not sids:
            return ("kv_park", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        spilled = self.kv.demote_seq(sid)
        self.kv_parked.add(sid)
        return ("kv_park", sid, spilled)

    def ev_kv_resume(self):
        if not self.kv_parked:
            return ("kv_resume", "none_parked")
        sids = sorted(self.kv_parked)
        sid = sids[int(self.rng.integers(len(sids)))]
        if not self._kv_room(len(self.kv._seqs[sid].cold)):
            return ("kv_resume", sid, "pool_low")
        promoted = self.kv.promote_seq(sid)
        self.kv_parked.discard(sid)
        return ("kv_resume", sid, promoted)

    def ev_kv_migrate(self):
        """Move a sequence (parked ones included — their spill is read in
        place) to the second cache, verify bit-identity, then free it on
        the source so tombstoned ancestors cascade."""
        sids = self._kv_live(writable=True)
        if not sids:
            return ("kv_migrate", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        seq = self.kv._seqs[sid]
        need = -(-seq.length // self.config.kv_dst_block_size)
        if len(self.kv_dst._free) < need + 2:
            return ("kv_migrate", sid, "dst_pool_low")
        blob = self.kv.export_seq(sid)
        new_sid = self.kv_dst.import_seq(blob)
        gk, gv = self.kv_dst.gather(new_sid)
        assert (_host(gk) == _host(blob["k"])).all() \
            and (_host(gv) == _host(blob["v"])).all(), (
            f"migrated sid {sid} not bit-identical on the destination"
        )
        self.kv.free_seq(sid)
        self.kv_parked.discard(sid)
        self.kv_dst_expected[new_sid] = self.kv_expected.pop(sid)
        return ("kv_migrate", sid, new_sid, seq.length)

    def ev_kv_mid_migration(self):
        """A decode-style append lands after export: the fingerprint must
        change, so the migration would abort rather than drop the source."""
        sids = self._kv_live(unparked=True, writable=True)
        if not sids:
            return ("kv_mid_migration", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        seq = self.kv._seqs[sid]
        bs = self.config.kv_block_size
        if (seq.length // bs >= self.config.kv_max_blocks
                or not self._kv_room(3)):
            return ("kv_mid_migration", sid, "at_max")
        blob = self.kv.export_seq(sid)
        k, v = self._kv_tokens(1)
        self.kv.append_prefill(sid, self._dev(k), self._dev(v))
        ek, ev = self.kv_expected[sid]
        self.kv_expected[sid] = (np.concatenate([ek, k], axis=1),
                                 np.concatenate([ev, v], axis=1))
        assert self.kv.seq_fingerprint(sid) != blob["fingerprint"], (
            f"sid {sid}: append landed after export but the fingerprint "
            "did not change — the mid-flight guard is blind"
        )
        self.guard_hits += 1
        return ("kv_mid_migration", sid, "guard_fired")

    # -- serving-plane golden events ------------------------------------------

    def ev_kv_golden_register(self):
        """Freeze a live sequence as a golden shared-prefix base."""
        if len(self.kv_golden) >= 3:
            return ("kv_golden_register", "enough_goldens")
        sids = [s for s in self._kv_live(unparked=True, writable=True)
                if self.kv.seq_length(s) > 0]
        if not sids:
            return ("kv_golden_register", "no_live")
        sid = sids[int(self.rng.integers(len(sids)))]
        h = self.kv.register_golden(sid)
        self.kv_golden.add(sid)
        return ("kv_golden_register", sid, h[:8])

    def ev_kv_golden_admit(self):
        """Prefix-hit admission: fork a golden base and append a short
        suffix — the engine's ``add_request`` fast path, KV-plane form.
        A zero-length suffix is the exact-match admission."""
        goldens = sorted(self.kv_golden)
        if not goldens:
            return ("kv_golden_admit", "no_goldens")
        sid = goldens[int(self.rng.integers(len(goldens)))]
        if not self._kv_room(4):
            return ("kv_golden_admit", sid, "pool_low")
        child = self.kv.fork(sid)
        ek, ev = self.kv_expected[sid]
        self.kv_expected[child] = (ek.copy(), ev.copy())
        n = int(self.rng.integers(0, 4))
        c, bs = self.config, self.config.kv_block_size
        if n and (self.kv.seq_length(child) + n - 1) // bs < c.kv_max_blocks:
            k, v = self._kv_tokens(n)
            self.kv.append_prefill(child, self._dev(k), self._dev(v))
            ek, ev = self.kv_expected[child]
            self.kv_expected[child] = (np.concatenate([ek, k], axis=1),
                                       np.concatenate([ev, v], axis=1))
        else:
            n = 0
        return ("kv_golden_admit", sid, child, n)

    def ev_kv_golden_release(self):
        """Unfreeze and free a golden base; children survive through
        their parent links (vanilla tombstone cascade)."""
        goldens = sorted(self.kv_golden)
        if not goldens:
            return ("kv_golden_release", "no_goldens")
        sid = goldens[int(self.rng.integers(len(goldens)))]
        self.kv.release_golden(sid)
        self.kv.free_seq(sid)
        self.kv_golden.discard(sid)
        del self.kv_expected[sid]
        return ("kv_golden_release", sid)

    # -- checking -------------------------------------------------------------

    def check(self, *, data: bool = False):
        """Run the shared invariant suite over every plane; with
        ``data=True`` also compare the independent oracles bit-for-bit."""
        check_fleet_invariants(self.fleet, store=self.store,
                               registry=self.registry)
        check_fleet_invariants(self.dst_fleet, store=self.dst_store)
        check_kv_invariants(self.kv)
        check_kv_invariants(self.kv_dst)
        self.invariant_checks += 1
        if data:
            self._check_fleet_data(self.fleet, self.store, self.expected,
                                   "src")
            self._check_fleet_data(self.dst_fleet, self.dst_store,
                                   self.dst_expected, "dst")
            self._check_kv_data(self.kv, self.kv_expected, "src")
            self._check_kv_data(self.kv_dst, self.kv_dst_expected, "dst")

    def _check_fleet_data(self, fl, st, expected, label):
        spec = fl.spec
        grid = torch.arange(spec.n_pages, dtype=torch.int32,
                            device=fl.device)[None].expand(spec.n_tenants,
                                                           spec.n_pages)
        got, _ = fleet_lib.read_tiered(fl, st, grid)
        got = _host(got)
        overflowed = _host(fl.overflow)
        for t, pages in expected.items():
            if overflowed[t]:
                # a wedged tenant may have dropped later writes the
                # oracle can't see the boundary of; structural invariants
                # still apply, the data oracle re-syncs
                for p in range(spec.n_pages):
                    expected[t][p] = np.array(got[t, p])
                continue
            want = np.zeros((spec.n_pages, spec.page_size), np.float32)
            for p, row in pages.items():
                want[p] = row
            assert (got[t] == want).all(), (
                f"{label} fleet tenant {t}: guest pages "
                f"{np.flatnonzero((got[t] != want).any(axis=1)).tolist()} "
                "differ from the event-by-event oracle"
            )

    def _check_kv_data(self, cache, expected, label):
        for sid, (ek, ev) in expected.items():
            gk, gv = cache.gather(sid)
            assert (_host(gk) == ek).all() and (_host(gv) == ev).all(), (
                f"{label} cache sid {sid}: gathered KV differs from the "
                "event-by-event oracle"
            )

    # -- driving --------------------------------------------------------------

    def step(self) -> tuple:
        i = int(self.rng.choice(len(self._events), p=self._weights))
        t0 = time.perf_counter()
        record = self._events[i][0]()
        t1 = time.perf_counter()
        self._step += 1
        self.trace.append((self._step,) + record)
        self.check(data=self._step % self.config.check_data_every == 0)
        self.timings.append((record[0], t1 - t0, time.perf_counter() - t1))
        return record

    def run(self) -> list[tuple]:
        for _ in range(self.config.events):
            self.step()
        self.check(data=True)
        return self.trace

    def stats(self) -> dict:
        return dict(
            events=self._step,
            invariant_checks=self.invariant_checks,
            guard_hits=self.guard_hits,
            live_seqs=len(self._kv_live()),
            fleet_rows=int(_host(self.fleet.alloc_count).sum()),
            host_rows=self.store.host_rows_in_use(),
            golden_chains=self.registry.stats()["golden_chains"],
            golden_forks=self.registry.stats()["golden_forks"],
            kv_goldens=len(self.kv_golden),
        )


# -- a storm's state, for holding two runs against each other ------------------

FLEET_FIELDS = ("l1", "l2", "length", "alloc_count", "cold_count", "overflow",
                "snap_dropped", "scalable", "lease_owner", "lease_index",
                "lease_count")


def _words(x) -> np.ndarray:
    """An owned host array of a tensor or any array (the JAX harness's
    too); 32-bit integers as ``uint32``, the index words' type."""
    a = _host(x)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


def referenced_rows(l2: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Device pool rows some live hot entry of any tenant references."""
    w0 = l2[..., 0]
    live = np.arange(l2.shape[1])[None, :, None] < length[:, None, None]
    data = (((w0 & np.uint32(fmt.FLAG_ALLOCATED)) != 0)
            & ((w0 & np.uint32(fmt.FLAG_ZERO)) == 0)
            & ((w0 & np.uint32(fmt.FLAG_COLD)) == 0) & live)
    return np.unique((w0[data] & np.uint32(fmt.PTR_MASK)).astype(np.int64))


def _rows(pool, rows: np.ndarray) -> np.ndarray:
    if isinstance(pool, torch.Tensor):
        return _words(pool[torch.as_tensor(rows, device=pool.device)])
    return _words(np.asarray(pool)[rows])


def state_of(h) -> dict:
    """Everything a storm leaves behind, keyed by field, as host values:
    both fleets' words and counters and the pool rows a live entry
    references, both host tiers' free lists, counters and rows in use,
    both KV caches (``_ref``, ``_free``, and per sequence its table,
    owner, length, cold set, tombstone flag, parent and, while live, its
    gathered K/V), and the registry's and the scheduler's stats. Reads a
    harness of this module or of ``harness.py`` alike."""
    out = {}
    for name, fl in (("fleet", h.fleet), ("dst_fleet", h.dst_fleet)):
        for f in FLEET_FIELDS:
            out[f"{name}.{f}"] = _words(getattr(fl, f))
        rows = referenced_rows(out[f"{name}.l2"],
                               out[f"{name}.length"].astype(np.int64))
        out[f"{name}.pool[referenced rows]"] = _rows(fl.pool, rows)
    for name, st in (("store", h.store), ("dst_store", h.dst_store)):
        free = set(st._free)
        used = np.asarray([r for r in range(st._top) if r not in free],
                          np.int64)
        out[f"{name}._free"] = list(st._free)
        out[f"{name}._top"] = st._top
        out[f"{name}.stats"] = st.stats()
        out[f"{name}.rows in use"] = (_words(st.get(used)) if used.size
                                      else np.zeros(0, np.float32))
    for name, kv in (("kv", h.kv), ("kv_dst", h.kv_dst)):
        out[f"{name}._ref"] = _words(kv._ref)
        out[f"{name}._free"] = list(kv._free)
        out[f"{name}.sids"] = sorted(kv._seqs)
        for sid, seq in kv._seqs.items():
            key = f"{name}.sid{sid}"
            out[f"{key}.meta"] = (seq.length, sorted(seq.cold), seq.freed,
                                  seq.parent)
            out[f"{key}.table"] = _words(seq.table)
            out[f"{key}.owner"] = _words(seq.owner)
            if not seq.freed:
                k, v = kv.gather(sid)
                out[f"{key}.k"], out[f"{key}.v"] = _words(k), _words(v)
    out["registry.stats"] = h.registry.stats()
    out["sched.stats"] = h.sched.stats()
    return out


def state_diffs(a: dict, b: dict) -> list[str]:
    """The keys of two ``state_of`` results whose values differ (arrays in
    shape, dtype or any byte)."""
    out = []
    for key in sorted(set(a) | set(b)):
        x, y = a.get(key), b.get(key)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and x.tobytes() == y.tobytes())
        else:
            same = x == y
        if not same:
            out.append(key)
    return out
