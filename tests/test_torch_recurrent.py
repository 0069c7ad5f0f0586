"""The port's recurrence helpers (``models/recurrent.py``) against the JAX
package's, bit for bit in float32.

``chunked_time_scan`` is held with a step function of multiplies and a
maximum only: XLA's CPU backend contracts a multiply feeding an add into
one fused multiply-add, which eager PyTorch does not, so a step with
``a * c + u`` would differ in the last bit for that reason alone (the
families' steps are held with tolerances in their own files). The scan's
own work — padding to whole chunks, the pad steps, the carries across
chunks and remat — is then bitwise. The depthwise conv spells the
contraction out (``addcmul``), so it is bitwise too.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402


def _step(mod):
    where = np.maximum if mod is np else torch.maximum

    def step(carry, inp):
        a, u = inp
        carry = where(carry * a, u)
        return carry, carry * 2.0
    return step


def _jstep(carry, inp):
    a, u = inp
    carry = jax.numpy.maximum(carry * a, u)
    return carry, carry * 2.0


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def jscan():
    """One compiled JAX scan per (chunk, remat), shared by the cases."""
    cache = {}

    def get(chunk, remat):
        if (chunk, remat) not in cache:
            cache[chunk, remat] = jax.jit(lambda c, a, u: jrec.chunked_time_scan(
                _jstep, c, (a, u), chunk=chunk, remat=remat))
        return cache[chunk, remat]
    return get


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("length,chunk", [(5, 16), (16, 16), (37, 16), (64, 16),
                                          (100, 64)])
def test_chunked_time_scan_bitwise(jscan, length, chunk, remat):
    """Below, at, a multiple of and not a multiple of ``chunk``: the carry
    (after the pad steps where the length is not a multiple) and every
    output equal JAX's bit for bit."""
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.5, (length, 3, 5)).astype(np.float32)
    u = rng.standard_normal((length, 3, 5)).astype(np.float32)
    c0 = rng.standard_normal((3, 5)).astype(np.float32)
    jc, jy = jscan(chunk, remat)(c0, a, u)
    tc, ty = trec.chunked_time_scan(
        _step(torch), torch.from_numpy(c0), (torch.from_numpy(a), torch.from_numpy(u)),
        chunk=chunk, remat=remat)
    assert tuple(ty.shape) == (length, 3, 5)
    np.testing.assert_array_equal(_bits(tc), _bits(jc))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


def test_chunked_time_scan_pad_steps_reach_the_carry():
    """A length not a multiple of ``chunk`` runs the zero-input pad steps on
    the carry, in both packages: with a multiplicative step the carry
    after them is max(0·c, 0) = 0, not the carry at the last real step."""
    c0 = torch.ones(2)
    xs = (torch.full((20, 2), 0.9), torch.full((20, 2), -5.0))
    carry, ys = trec.chunked_time_scan(_step(torch), c0, xs, chunk=8)
    assert torch.equal(carry, torch.zeros(2)) and bool((ys[-1] > 0).all())
    jc, _ = jrec.chunked_time_scan(_jstep, np.ones(2, np.float32),
                                   tuple(x.numpy() for x in xs), chunk=8)
    np.testing.assert_array_equal(np.asarray(jc), 0.0)


def test_chunked_time_scan_remat_gradients_bitwise():
    """The backward through remat chunks recomputes the same ops: the
    gradients with remat equal those without it, bit for bit."""
    rng = np.random.default_rng(3)
    a0 = torch.from_numpy(rng.uniform(0.5, 1.5, (50, 4)).astype(np.float32))
    u0 = torch.from_numpy(rng.standard_normal((50, 4)).astype(np.float32))
    grads = []
    for remat in (True, False):
        a, u = a0.clone().requires_grad_(True), u0.clone().requires_grad_(True)
        c, ys = trec.chunked_time_scan(_step(torch), torch.ones(4), (a, u),
                                       chunk=16, remat=remat)
        grads.append(torch.autograd.grad(c.sum() + ys.square().sum(), (a, u)))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


@pytest.fixture(scope="module")
def jconv():
    return jax.jit(lambda x, w, b, p: jrec.causal_depthwise_conv(x, w, b, prev=p))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("seq", [1, 37])
def test_causal_depthwise_conv_bitwise(jconv, k, with_prev, seq):
    """The output and the carried context, with zero history and with a
    context; one token (a decode step) and a sequence."""
    rng = np.random.default_rng(10 * k + seq)
    x = rng.standard_normal((2, seq, 24)).astype(np.float32)
    w = rng.standard_normal((k, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    prev = rng.standard_normal((2, k - 1, 24)).astype(np.float32) if with_prev else None
    jo, jp = jconv(x, w, b, prev)
    to, tp = trec.causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        prev=None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(_bits(to), _bits(jo))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))


@pytest.mark.parametrize("seq", [1, 9])
def test_token_shift_bitwise(seq):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((3, seq, 8)).astype(np.float32)
    prev = rng.standard_normal((3, 8)).astype(np.float32)
    js, jl = jrec.token_shift(x, prev)
    ts, tl = trec.token_shift(torch.from_numpy(x), torch.from_numpy(prev))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
