"""Snapshot-chain core: entry format, chains, resolution, the fleet."""
