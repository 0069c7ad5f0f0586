"""Observability counters of the fleet plane (PyTorch port of part of
``repro.core.metrics``): the golden registry's dedup state.

The paper's Eq. 1/2 cost model and the tier-residency counters of the JAX
module are not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GoldenResidency:
    """One observation of the golden-prefix dedup state (core plane)."""

    golden_chains: int       # registered content-addressed bases
    golden_forks: int        # live tenants forked off a base
    golden_rows_pinned: int  # distinct device rows pinned by bases
    dedup_rows_saved: int    # rows a dedup-free fleet would also hold


def golden_residency(registry) -> GoldenResidency:
    """Golden-registry counters off a ``core.golden.GoldenRegistry``.

    ``dedup_rows_saved`` sums, over every live fork, the shared rows the
    fork aliases instead of copying: the device rows a registry-free fleet
    would additionally lease to back the same tenants.
    """
    st = registry.stats()
    return GoldenResidency(
        golden_chains=st["golden_chains"],
        golden_forks=st["golden_forks"],
        golden_rows_pinned=st["golden_rows_pinned"],
        dedup_rows_saved=st["dedup_rows_saved"],
    )
