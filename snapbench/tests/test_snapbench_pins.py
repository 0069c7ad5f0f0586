"""The four read cells measure what they measured before mixes could
write: at the cells' own sizes and on two seeds, the set-up schedule,
the ring of reads, the bytes a batch needs, the bytes set-up writes, the
reservoir's picks and the reference's bytes of a set of clusters are
those taken before (sha-256 digests, first 16 hex digits), and a read
cell's compared numbers and limits are the same two."""

import hashlib
import io

import numpy as np
import pytest
from conftest import ROOT, TINY_CELLS

from snapbench import datagen, generator
from snapbench.bench import Bench
from snapbench.harness import Device, Sampler, run_cell
from snapbench.rooflines import bytes as rbytes

#: cell/seed: schedule, ring, batch bytes, set-up bytes, sampler
PINS = {
    "qcow2-fleet64.ycsb-c/7": ("35b4aabf0f17fc7d", "0c6aa11f3a278f18",
                               "4716221f903eb7ac", 38537527296, "9a364286d11dbcdc"),
    "qcow2-fleet64.ycsb-c/8589934597": ("f79bd562a800379c", "2bfee95ea516f7c5",
                                        "90c70765885082a7", 38537527296, "c0b858fe881dbc7f"),
    "sqemu-fleet64.ycsb-c/7": ("35b4aabf0f17fc7d", "0c6aa11f3a278f18",
                               "dba81a06fe576457", 38537527296, "9a364286d11dbcdc"),
    "sqemu-fleet64.ycsb-c/8589934597": ("f79bd562a800379c", "2bfee95ea516f7c5",
                                        "c08392f47fe36bca", 38537527296, "c0b858fe881dbc7f"),
    "qcow2-fleet64-fill90.dd/7": ("5df23e3880e9fd24", "96d81288c62760c2",
                                  "d4da840fe2945b3c", 66026995712, "136b5500d0c4ad46"),
    "qcow2-fleet64-fill90.dd/8589934597": ("f1668d2643610f2b", "386be1bf14ea0622",
                                           "9d5ebdfc532e0bd1", 66026995712,
                                           "17e3aafbee7d3559"),
    "sqemu-fleet64-fill90.dd/7": ("5df23e3880e9fd24", "96d81288c62760c2",
                                  "9a9ba3b3770c74f2", 66026995712, "136b5500d0c4ad46"),
    "sqemu-fleet64-fill90.dd/8589934597": ("f1668d2643610f2b", "386be1bf14ea0622",
                                           "8d3edc590dbf5425", 66026995712,
                                           "17e3aafbee7d3559"),
}
#: the reference's bytes of 11 clusters of batch 3, holes among them (seed 2**33 + 5)
EXPECTED = {"ycsb-c": "555e2b2524a65d47", "dd": "53c6f40f27f936e4"}


def digest(*arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        d.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return d.hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(PINS))
def test_read_cell_inputs_are_pinned(key):
    name, seed = key.split("/")
    seed = int(seed)
    bench = Bench(ROOT)
    cell = bench.cell(name)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    s = datagen.write_schedule(cfg, seed)
    ref = bench.reference(cfg)(cfg, s, seed)
    ring = generator.make_ring(mix, cfg, ref, seed)
    rb, gb = rbytes.batch_bytes(cfg["format"], ring, ref.version, ref.lengths,
                                cfg["cluster_bytes"])
    data_bytes = int(sum(s.base.shape[1] + cfg["layer_writes"]
                         * (s.targets.astype(np.int64) - 1))) * cfg["cluster_bytes"]
    sm = Sampler(seed, cfg["tenants"] * mix["reads_per_tenant"], 4, Device("cpu"))
    got = (digest(s.targets, s.base, s.layers), digest(ring), digest(rb, gb), data_bytes,
           digest(np.array([sm.offset]), sm.pos_host, sm.u))
    assert got == PINS[key]
    assert generator.make_write_ring(mix, cfg, ref, seed) is None
    if seed == 2**33 + 5:
        t = np.repeat(np.arange(cfg["tenants"]), 2)[::8]
        c = np.concatenate([ring[3][t, 0], [5, 77, 1000]])
        t = np.concatenate([t, [0, 31, 63]])
        want = hashlib.sha256(ref.expected(t, c, "cpu").numpy().tobytes()).hexdigest()
        assert want[:16] == EXPECTED[cell["traffic"]]


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_read_cell_compares_the_same_numbers(checkout, cell):
    r = run_cell(checkout, cell, 2**33 + 5, 0.05, False, device="cpu", log=io.StringIO())
    assert list(r["compared"]) == ["wrong_clusters", "checked_clusters"]
    assert r["compared"]["wrong_clusters"] == {"value": 0, "limit": 0}
    assert r["compared"]["checked_clusters"]["limit"] == 4 * (16 if "ycsb" in cell else 32)
    assert r["failed"] == 0 and r["attempted"] % r["compared"]["checked_clusters"]["limit"] == 0
