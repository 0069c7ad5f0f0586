"""The bytes a batch needs, from shapes: resolve bytes of each format for a
hit at each depth and for a hole, gather bytes of found clusters against
holes, and a cluster read twice in a batch counted once."""

import numpy as np
import pytest

from snapbench.rooflines import bytes as rb
from snapbench.rooflines.peaks import peaks

CB = 65536


@pytest.mark.parametrize("length", [1, 2, 7, 500])
def test_resolve_bytes_at_each_depth(length):
    owners = np.arange(length)
    # vanilla Qcow2: from the top (layer length - 1) down to the owner
    assert (rb.resolve_bytes("qcow2", length, owners) == 8 * (length - owners)).all()
    assert rb.resolve_bytes("qcow2", length, -1) == 8 * length       # a hole
    # sQemu: the top layer's entry alone, hit or hole
    assert (rb.resolve_bytes("sqemu", length, np.append(owners, -1)) == 8).all()
    with pytest.raises(ValueError):
        rb.resolve_bytes("vmdk", length, owners)


def test_gather_bytes_found_against_holes():
    assert rb.gather_bytes(found=0, outputs=10, cluster_bytes=CB) == 10 * CB
    assert rb.gather_bytes(found=10, outputs=10, cluster_bytes=CB) == 20 * CB


def test_batch_bytes_counts_each_input_once():
    version = np.array([[0, 3, -1, 1], [-1, -1, 0, 0]])
    lengths = np.array([4, 1])
    ids = np.array([[[1, 1, 2, 0], [3, 3, 3, 3]]])          # one batch, T 2, B 4
    resolve, gather = rb.batch_bytes("qcow2", ids, version, lengths, CB)
    # tenant 0 reads {0, 1, 2}: 4 + 1 + 4 entries; tenant 1 reads {3}: 1
    assert resolve.tolist() == [8 * (4 + 1 + 4 + 1)]
    # found and distinct: 2 + 1; every one of the 8 outputs is written
    assert gather.tolist() == [(3 + 8) * CB]
    resolve, gather = rb.batch_bytes("sqemu", ids, version, lengths, CB)
    assert resolve.tolist() == [8 * 4] and gather.tolist() == [(3 + 8) * CB]
    # a ring of batches gives one number a batch
    resolve, _ = rb.batch_bytes("qcow2", np.concatenate([ids, ids]), version, lengths, CB)
    assert resolve.shape == (2,)


def test_peaks_by_card_name():
    assert peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert peaks("cpu") is None
