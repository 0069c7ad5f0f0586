"""The paper's own evaluation configuration (§6.1), as data (PyTorch port of
``repro.configs.paper_chain``, same values).

These are the constants of the sQEMU testbed: ``core.metrics`` evaluates
Eq. 1 / Eq. 2 at paper scale with them, and ``headline_claims`` holds the
paper's numbers the reproduction is checked against.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    # virtual-disk geometry
    disk_sizes_bytes: tuple = (50 * 2**30, 150 * 2**30)
    cluster_bytes: int = 64 * 1024
    l2_entry_bytes: int = 8
    # chain workload (§3, §6.1)
    chain_lengths: tuple = (1, 50, 100, 500, 1000)
    streaming_threshold: int = 30          # provider policy, Take-away 2
    fill_fraction_micro: float = 0.90      # dd experiments
    fill_fraction_macro: float = 0.25      # RocksDB experiments
    # cache sweep (30%..100% of full-disk L2 coverage)
    cache_fracs: tuple = (0.3, 0.5, 0.75, 1.0)
    default_l2_cache_bytes: int = 1 << 20  # qemu default max
    # timing constants of their testbed (Eq. 1)
    t_ram_s: float = 100e-9
    t_disk_s: float = 80e-6
    t_layers_s: float = 1e-6

    def l2_cache_bytes_full(self, disk_bytes: int) -> int:
        """Cache size that indexes the whole disk (their 'otherwise
        indicated' default): 2.5 MB per 20 GB, i.e. 6.25 MB @ 50 GB."""
        n_clusters = disk_bytes // self.cluster_bytes
        return n_clusters * self.l2_entry_bytes


SETUP = PaperSetup()


def headline_claims() -> dict:
    """The paper's numbers the reproduction validates against."""
    return dict(
        rocksdb_throughput_gain_at_500=0.48,
        memory_reduction_at_500=15.2,
        memory_reduction_at_1000=17.6,
        dd_slowdown_vanilla_at_1000=0.84,
        boot_time_factor_vanilla_at_1000=4.0,
        boot_time_factor_scalable_at_1000=1.7,
        snapshot_overhead_bytes_50gb=6 * 2**20,
        snapshot_time_ratio_50gb=7.0,
    )
