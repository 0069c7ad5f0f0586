"""The port's ``Engine`` against the JAX ``Engine`` on the same weights.

Both fork formats × both decode paths run the add / fork / step / finish
lifecycle of ``test_engine_deep_chain_lifecycle_matches_oracle`` (a fork
chain past depth 32 with interleaved finishes and steps), without
park/resume. Emitted tokens must be identical, and ``blocks_in_use``,
``lookup_count`` and the final tables must match.

Tokens are compared in float32 compute on both sides: bf16 rounds at other
places in the two frameworks and would flip near-tied argmaxes (bf16 is
held at the step level in ``test_torch_model.py``). The JAX side resolves
with ``"gather"`` to keep CPU time down; results are bit-identical across
resolvers.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

KW = dict(n_blocks=256, block_size=4, max_blocks_per_seq=128)


@pytest.fixture(scope="module")
def f32():
    """Float32 compute in both packages for this module's cases; JAX's
    compiled traces are cleared on both sides so no other test module
    sees an f32 trace."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tlayers, "COMPUTE_DTYPE", torch.float32)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    jcfg = j_smoke("qwen2.5-3b")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, t_smoke("qwen2.5-3b"), jparams, tparams


def _tables(eng, sids):
    tables = eng.kv._resolve_all()[0]
    return {s: tables[eng.kv._seqs[s].tenant] for s in sids}


@pytest.mark.parametrize("path", ["tables", "fused"])
@pytest.mark.parametrize("scalable", [True, False])
def test_engine_lifecycle_emits_identical_tokens(f32, weights, scalable, path):
    jcfg, tcfg, jparams, tparams = weights
    je = JEngine(jcfg, jparams, scalable=scalable, resolver="gather",
                 decode_path=path, **KW)
    te = TEngine(tcfg, tparams, scalable=scalable, decode_path=path,
                 device="cpu", **KW)
    assert je.decode_path == te.decode_path == path

    def both(op, *args):
        a, b = getattr(je, op)(*args), getattr(te, op)(*args)
        assert a == b, op
        return a

    def check():
        jm, tm = je.memory_stats(), te.memory_stats()
        for k in ("blocks_in_use", "lookups", "n_seqs"):
            assert tm[k] == jm[k], k
        assert te.active == je.active
        jt, tt = _tables(je, sorted(je.active)), _tables(te, sorted(te.active))
        for s in jt:
            np.testing.assert_array_equal(tt[s], jt[s])

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (5, 9, 3)]
    sids = [both("add_request", p) for p in prompts]
    both("fork_request", sids[1])            # a long-lived sibling rides along
    both("step")
    sid = sids[0]
    for depth in range(34):
        child = both("fork_request", sid)
        both("finish_request", sid)          # tombstone the parent
        sid = child
        if depth % 16 == 0:
            both("step")
            check()
    for _ in range(2):
        both("step")
    check()
    for s in sorted(je.active):
        both("finish_request", s)
    check()
    assert te.kv.blocks_in_use() == 0
    assert te.kv._seqs == {}
