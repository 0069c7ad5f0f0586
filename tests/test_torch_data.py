"""The port's data pipeline (``data/pipeline.py``, ``data/_threefry.py``)
and ``models.api.make_batch`` against the JAX package.

The port draws with its own numpy copy of JAX's Threefry-2x32, so every
comparison here is bitwise: raw keys, ``fold_in``, ``split``, the 32-bit
draws behind ``randint`` and ``uniform``, and the token batches of both
patterns, whole and sliced per process.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.api import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.data import _threefry as tf  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models.api import make_batch as t_make_batch  # noqa: E402

SEEDS = [0, 7, 123_456]


@pytest.mark.parametrize("seed", SEEDS + [-5, 2**31 - 1])
def test_prng_key_fold_in_split(seed):
    jkey = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for data in (0, 1, 9, 2**32 - 1):
        np.testing.assert_array_equal(tf.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(jkey, data)))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(tf.split(key, num),
                                      np.asarray(jax.random.split(jkey, num)))


@pytest.mark.parametrize("span", [(0, 256), (0, 151_936), (-3, 9), (0, 65_536),
                                  (0, 65_537), (4, 4), (9, 2)])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_randint_bitwise(span, shape):
    """Spans below, at and above 2^16 (above it the high draw's multiplier
    wraps to 0 in JAX's uint32 product), and empty spans (minval)."""
    lo, hi = span
    jkey = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    want = np.asarray(jax.random.randint(jkey, shape, lo, hi, dtype=jnp.int32))
    got = tf.randint(np.asarray(jkey), shape, lo, hi)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (5,), (4, 64), (3, 7, 2)])
def test_uniform_bitwise(shape):
    jkey = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.uniform(jkey, shape))
    got = tf.uniform(np.asarray(jkey), shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pattern", ["lcg", "uniform"])
def test_batch_at_bitwise(pattern, seed, step):
    """Whole batches and both halves of a two-process slice."""
    for n_proc, idx in ((1, 0), (2, 0), (2, 1)):
        kw = dict(vocab_size=256, seq_len=24, global_batch=4, seed=seed,
                  pattern=pattern, n_processes=n_proc, process_index=idx)
        want = jpipe.batch_at(jpipe.DataConfig(**kw), step)
        got = tpipe.batch_at(tpipe.DataConfig(**kw), step, device="cpu")
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert tuple(got[k].shape) == (4 // n_proc, 24)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_batch_at_full_vocabulary():
    """Qwen2.5-3B's vocabulary (a span above 2^16) at a longer sequence."""
    kw = dict(vocab_size=151_936, seq_len=512, global_batch=2, seed=3)
    want = jpipe.batch_at(jpipe.DataConfig(**kw), 4)
    got = tpipe.batch_at(tpipe.DataConfig(**kw), 4, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_batch_at_refuses_frames_and_unknown_patterns():
    cfg = tpipe.DataConfig(vocab_size=256, seq_len=8, global_batch=2)
    with pytest.raises(NotImplementedError, match="encdec"):
        tpipe.batch_at(cfg, 0, with_frames=12, d_model=64, device="cpu")
    with pytest.raises(ValueError, match="pattern"):
        tpipe.batch_at(dataclasses.replace(cfg, pattern="zipf"), 0, device="cpu")
    with pytest.raises(ValueError, match="split"):
        _ = dataclasses.replace(cfg, n_processes=3).local_batch


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-moe-a2.7b"])
def test_make_batch_bitwise(arch, seed):
    want = j_make_batch(j_smoke(arch), jax.random.PRNGKey(seed), 3, 20)
    got = t_make_batch(t_smoke(arch), seed, 3, 20, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_batch_refuses_encdec():
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), family="encdec")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        t_make_batch(cfg, 0, 2, 8, device="cpu")
