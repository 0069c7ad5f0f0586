"""MaintenanceScheduler: budgeted background streaming beside serving
(PyTorch port of ``repro.core.scheduler``).

The paper's §6.4 measures a ~100x guest-latency hit while a chain is
being streamed: the maintenance job competes with the guest for the data
path. Fleet-side, the equivalent anti-pattern is stop-the-world
maintenance — stream every tenant at once and eat one enormous tick.

The scheduler is the provider's background job queue instead.

**Tick budgeting.** Each ``tick()`` (driven by the serving loop between
decode steps, see ``serve/engine.py``) streams at most
``max_tenants_per_tick`` tenants, picked by occupancy — longest chains
first (they pay the worst Eq. 1 walk cost and pin the most superseded
rows), heaviest row footprint as the tie-break; chains shorter than
``stream_chain_threshold`` are left alone unless they are under
``overflow``/``snap_dropped`` pressure. The budget is what converts one
enormous stop-the-world pause into many small slices: the worst-case
tick cost is bounded by the budget, not the backlog
(``benchmarks/maintenance.py`` measures the amortization). Streaming
returns freed quanta to the fleet allocator's free list
(``fleet.stream_tenants``), and tenants that stay wedged (``overflow``
after streaming reclaimed nothing) trigger a targeted ``compact``.

**Priority aging (starvation guard).** Ranking by occupancy alone can
starve: a modest chain is outranked forever while heavier tenants keep
regrowing (write + snapshot between ticks). Every tick a tenant is a
candidate but not picked, its *age* grows, and age is added to its chain
length in the ranking (``aging_weight`` per tick of waiting, reset on
pick) — so any persistent candidate eventually outranks the churners and
gets its slice. ``aging_weight=0`` restores pure occupancy order.

**No-progress parking.** A tick that touches a tenant without changing
its occupancy fingerprint (chain length, rows held, quanta held, rows
demoted) parks that tenant: it is skipped by future ticks until
something about it changes (a write, a snapshot, a reclamation
elsewhere). Without parking, a length-2 chain (streaming shortens
nothing) or a latched overflow with nothing reclaimable would be
re-picked and futilely re-streamed every tick, and ``drain()`` would
never observe an empty backlog. Parking is what makes the queue
converge; progress anywhere un-parks automatically because the
fingerprint no longer matches.

**Demotion policy (tiering).** With a ``TieredStore`` and a
``device_page_budget``, each tick also checks the fleet's device-row
footprint against the budget and, while over it, demotes immutable
snapshot-layer pages to the host tier (``fleet.demote_tenants``) —
coldest layer first within a tenant, longest-chain tenants first across
the fleet (deep chains pin the most frozen state), and at most
``demote_rows_per_tick`` rows per tick so the transfer cost is paid in
budgeted slices like everything else here. The active COW layer is never
demoted (enforced by ``demote_tenants`` itself). Tenants whose demotion
attempt moves nothing are parked on their fingerprint like wedged
streams. See ``docs/memory.md``.

Port notes: the fleet ops update the fleet in place and return it, so
``self.fleet`` is the same object before and after a tick (a caller that
needs the pre-tick state clones it). The policy, the reports and
``stats()`` are the JAX package's, key for key. Streaming runs the merge
plan on the streaming-merge kernel K9 (``chain.plan_merge``). A golden
registry (``registry=``) keeps the maintenance plane off registered
owners and off the rows their forks pin, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import fleet as fleet_lib
from repro_torch.core.fleet import ChainFleet


class MaintenanceScheduler:
    """Budgeted queue of per-tenant streaming jobs over a ``ChainFleet``.

    The scheduler owns the fleet between ticks (the fleet ops update it in
    place and hand it back, and ``self.fleet`` is rebound to what they
    return). The serving path keeps reading/writing the same object
    through the scheduler::

        sched = MaintenanceScheduler(fl, max_tenants_per_tick=2)
        sched.fleet = fleet.write(sched.fleet, ids, data)   # serve
        sched.tick()                                        # maintain

    ``stream_chain_threshold``: chains shorter than this are left alone
    (streaming a length-2 chain buys little and costs a repack).
    ``compact_on_overflow``: run a fleet-wide GC when streaming alone did
    not clear a tenant's ``overflow``.
    ``aging_weight``: chain-length-equivalents of priority a passed-over
    candidate gains per tick (the starvation guard); 0 disables aging.
    ``store`` + ``device_page_budget``: enable the tiering demotion
    policy — while the fleet holds more device rows than the budget,
    ticks demote immutable-layer pages into the ``TieredStore``, at most
    ``demote_rows_per_tick`` rows per tick.
    ``registry``: the fleet's ``GoldenRegistry``, when it runs one.
    Registered golden owners are content-frozen, so every maintenance
    path here leaves them alone: they are dropped from the stream and
    demotion queues, and the registry rides along into
    ``stream_tenants``/``compact``/``demote_tenants`` so fork-pinned rows
    are never relocated or spilled (the demote/fork race guard).
    """

    def __init__(self, fleet: ChainFleet, *, max_tenants_per_tick: int = 1,
                 stream_chain_threshold: int = 3,
                 compact_on_overflow: bool = True,
                 aging_weight: int = 1,
                 store=None, device_page_budget: int | None = None,
                 demote_rows_per_tick: int = 64, registry=None):
        if max_tenants_per_tick < 1:
            raise ValueError("max_tenants_per_tick must be >= 1")
        if aging_weight < 0:
            raise ValueError("aging_weight must be >= 0")
        if stream_chain_threshold < 2:
            raise ValueError(
                "stream_chain_threshold must be >= 2 (a length-1 chain "
                "has nothing below its active volume to merge)"
            )
        if device_page_budget is not None and store is None:
            raise ValueError(
                "device_page_budget needs a TieredStore to demote into"
            )
        if demote_rows_per_tick < 1:
            raise ValueError("demote_rows_per_tick must be >= 1")
        self.fleet = fleet
        self.max_tenants_per_tick = max_tenants_per_tick
        self.stream_chain_threshold = stream_chain_threshold
        self.compact_on_overflow = compact_on_overflow
        self.aging_weight = aging_weight
        self.store = store
        self.device_page_budget = device_page_budget
        self.demote_rows_per_tick = demote_rows_per_tick
        self.registry = registry
        self.rows_demoted = 0
        # tenants whose demotion attempt moved nothing, parked at their
        # fingerprint (same convergence mechanism as _wedged)
        self._demote_parked: dict[int, tuple] = {}
        # ticks spent as an unpicked candidate, per tenant: the priority
        # boost that guarantees no candidate starves behind heavier
        # tenants that keep regrowing. Reset when the tenant is picked.
        self._age: dict[int, int] = {}
        self.ticks = 0
        self.tenants_streamed = 0
        self.compactions = 0
        self.quanta_reclaimed = 0
        # tenants a tick could not help, keyed by the occupancy
        # fingerprint they were parked at: they are skipped until their
        # state changes. This is what makes the queue converge — without
        # it a length-2 chain (streaming shortens nothing) or a latched
        # overflow with nothing reclaimable would be re-picked and
        # futilely streamed/compacted on every tick, and drain() would
        # never see an empty backlog.
        self._wedged: dict[int, tuple] = {}

    def _fingerprints(self, st) -> dict[int, tuple]:
        return {
            t: (int(st["length"][t]), int(st["alloc_count"][t]),
                int(st["lease_count"][t]), int(st["cold_count"][t]))
            for t in range(self.fleet.spec.n_tenants)
        }

    def _still_wedged(self, st) -> set[int]:
        """Drop wedged tenants whose occupancy changed; return the rest."""
        fp = self._fingerprints(st)
        self._wedged = {t: f for t, f in self._wedged.items() if fp[t] == f}
        return set(self._wedged)

    # -- queue policy --------------------------------------------------------

    def _free_quanta(self, st) -> int:
        # leases are disjoint (property-tested), so free = total - held
        return self.fleet.spec.n_quanta - int(np.sum(st["lease_count"]))

    def candidates(self, st=None) -> list[int]:
        """Tenants needing streaming, most urgent first.

        Ranking: longest chain first (worst vanilla walk cost, most
        superseded rows), then largest row footprint — with each
        candidate's *age* (ticks spent waiting unpicked, times
        ``aging_weight``) added to its chain length, so a modest tenant
        cannot starve behind heavier ones that keep regrowing. Tenants
        under pressure (``overflow``/``snap_dropped``) qualify regardless
        of the length threshold — they are the ones
        ``check_pool_capacity`` would raise for. Tenants a previous tick
        could not help are parked until their occupancy changes (see
        ``_wedged``).

        Pass ``st`` (a ``fleet.tenant_stats`` result) to reuse stats the
        caller already synced off the device.
        """
        st = fleet_lib.tenant_stats(self.fleet) if st is None else st
        wedged = self._still_wedged(st)
        streamable = st["length"] >= 2          # something below the active
        need = streamable & (
            (st["length"] >= self.stream_chain_threshold)
            | st["overflow"] | st["snap_dropped"]
        )
        # tenants holding demoted pages can't stream (the merge would
        # strand their host rows) — promotion un-parks them naturally
        need &= st["cold_count"] == 0
        if self.registry is not None:
            # golden owners are content-frozen while registered: a merge
            # would rewrite the base every live fork resolves through
            need &= ~self.registry.golden_owner_mask(len(need))
        age = np.asarray([self._age.get(t, 0)
                          for t in range(len(need))], np.int64)
        rank = st["length"].astype(np.int64) + self.aging_weight * age
        order = np.lexsort((-st["alloc_count"], -rank))
        return [int(t) for t in order if need[t] and int(t) not in wedged]

    def _compactable(self, st) -> list[int]:
        """Unparked overflowed tenants — work for the compact fallback
        even when they are too short to stream (length 1)."""
        if not self.compact_on_overflow:
            return []
        self._still_wedged(st)
        return [int(t) for t in np.flatnonzero(st["overflow"])
                if int(t) not in self._wedged]

    # -- tiering demotion policy ---------------------------------------------

    def _over_budget(self, st) -> int:
        """Device rows above the HBM page budget (0 when policy is off)."""
        if self.store is None or self.device_page_budget is None:
            return 0
        return max(int(np.sum(st["alloc_count"])) - self.device_page_budget, 0)

    def _demote_candidates(self, st) -> list[int]:
        """Tenants with demotable frozen state, coldest (longest chain)
        first; parked no-progress tenants are skipped until they change."""
        fp = self._fingerprints(st)
        self._demote_parked = {t: f for t, f in self._demote_parked.items()
                               if fp[t] == f}
        need = (st["length"] >= 2) & (st["alloc_count"] > 0)
        if self.registry is not None:
            # the demote/fork race guard, queue side: a registered golden
            # base never spills, and fork-pinned rows are excluded row by
            # row inside demote_tenants
            need &= ~self.registry.golden_owner_mask(len(need))
        order = np.lexsort((-st["alloc_count"], -st["length"]))
        return [int(t) for t in order
                if need[t] and int(t) not in self._demote_parked]

    def _demote_tick(self, st) -> int:
        """One budgeted demotion slice: spill up to
        ``demote_rows_per_tick`` rows across the candidates in a single
        batched ``fleet.demote_tenants`` call (coldest layers first
        within each tenant; one L2 sync + one repack per tick)."""
        remaining = min(self.demote_rows_per_tick, self._over_budget(st))
        if remaining <= 0:
            return 0
        fp = self._fingerprints(st)
        cands = self._demote_candidates(st)
        if not cands:
            return 0
        self.fleet, rep = fleet_lib.demote_tenants(
            self.fleet, self.store, cands, max_rows=remaining,
            registry=self.registry,
        )
        done = rep["rows_demoted"]
        if done < remaining:
            # the budget was not exhausted, so every candidate the call
            # left untouched has nothing below its active layer to
            # spill: park it at its fingerprint so the policy converges
            # instead of re-scanning it every tick. (When the budget IS
            # exhausted, untouched candidates may simply not have been
            # reached — parking them would strand their frozen rows.)
            moved = set(rep["tenants"])
            for t in cands:
                if t not in moved:
                    self._demote_parked[t] = fp[t]
        self.rows_demoted += done
        return done

    def backlog(self, st=None) -> int:
        """Outstanding maintenance work: stream candidates, tenants only
        the compact fallback can help, plus tenants the demotion policy
        still needs to spill while over the device budget."""
        st = fleet_lib.tenant_stats(self.fleet) if st is None else st
        work = set(self.candidates(st)) | set(self._compactable(st))
        if self._over_budget(st) > 0:
            work |= set(self._demote_candidates(st))
        return len(work)

    # -- one tick of background work -----------------------------------------

    def tick(self) -> dict:
        """Run one maintenance slice: demote a budgeted row batch if over
        the device page budget, stream at most K tenants, compact the
        ones wedged on overflow. Returns a report of the work done.
        A drained (or fully parked) queue ticks for free: one
        tenant_stats sync, no streaming, no repack, no transfers."""
        st0 = fleet_lib.tenant_stats(self.fleet)
        cands = self.candidates(st0)
        picks = cands[: self.max_tenants_per_tick]
        compactable = self._compactable(st0)
        need_demote = (self._over_budget(st0) > 0
                       and bool(self._demote_candidates(st0)))
        self.ticks += 1
        # starvation guard: passed-over candidates gain priority, picked
        # ones reset — any persistent candidate is eventually served. A
        # tenant that stopped qualifying (pressure relieved elsewhere,
        # e.g. by the compact path) drops its accumulated age: a stale
        # boost must not let it jump the queue when it next qualifies.
        cand_set = set(cands)
        self._age = {t: a for t, a in self._age.items() if t in cand_set}
        for t in cands[self.max_tenants_per_tick:]:
            self._age[t] = self._age.get(t, 0) + 1
        for t in picks:
            self._age.pop(t, None)
        if not picks and not compactable and not need_demote:
            return dict(streamed=[], compacted=False, quanta_reclaimed=0,
                        rows_demoted=0, backlog=0)

        fp_before = self._fingerprints(st0)
        free_before = self._free_quanta(st0)
        n_t = self.fleet.spec.n_tenants
        # spill first: demotion frees device rows through the same
        # _reclaim repack streaming uses, so a single tick's transfers
        # stay bounded by demote_rows_per_tick + the stream budget
        demoted = self._demote_tick(st0) if need_demote else 0
        if picks:
            mask = np.zeros(n_t, bool)
            mask[picks] = True
            # merge everything below each tenant's active volume
            upto = st0["length"] - 2
            self.fleet = fleet_lib.stream_tenants(self.fleet, mask, upto,
                                                  registry=self.registry)
        compacted = False
        still_over = np.flatnonzero(self.fleet.overflow.cpu().numpy())
        need_compact = [int(t) for t in still_over
                        if int(t) not in self._wedged]
        if self.compact_on_overflow and need_compact:
            # compact only the tenants that need it — a fleet-wide repack
            # inside one serving tick would be the stop-the-world cliff
            # this scheduler exists to avoid
            mask = np.zeros(n_t, bool)
            mask[need_compact] = True
            self.fleet = fleet_lib.compact(self.fleet, mask,
                                           registry=self.registry)
            compacted = True
        # park every touched tenant that made no progress (no-op stream,
        # unreclaimable overflow, ...) at its current occupancy, so it is
        # not re-picked until something about it changes
        st1 = fleet_lib.tenant_stats(self.fleet)
        fp_after = self._fingerprints(st1)
        for t in set(picks) | set(compactable):
            if fp_after[t] == fp_before[t]:
                self._wedged[t] = fp_after[t]
        reclaimed = self._free_quanta(st1) - free_before
        self.tenants_streamed += len(picks)
        self.compactions += int(compacted)
        self.quanta_reclaimed += max(reclaimed, 0)
        return dict(
            streamed=picks,
            compacted=compacted,
            quanta_reclaimed=reclaimed,
            rows_demoted=demoted,
            backlog=self.backlog(st1),
        )

    def drain(self, *, max_ticks: int = 10_000) -> int:
        """Tick until the queue is empty (tests / shutdown). Returns the
        number of ticks it took."""
        for i in range(max_ticks):
            if not self.backlog():
                return i
            self.tick()
        raise RuntimeError("maintenance backlog did not drain")

    def stats(self) -> dict:
        """Lifetime counters plus the fleet's current occupancy."""
        out = dict(
            ticks=self.ticks,
            tenants_streamed=self.tenants_streamed,
            compactions=self.compactions,
            quanta_reclaimed=self.quanta_reclaimed,
            rows_demoted=self.rows_demoted,
            max_wait=max(self._age.values(), default=0),
            **fleet_lib.fleet_stats(self.fleet),
        )
        if self.store is not None:
            out.update(self.store.stats())
        return out
