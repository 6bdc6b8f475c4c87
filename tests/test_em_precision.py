"""The EM matmuls ask for full float32 (Precision.HIGHEST): on the GPU
anything less may run in TF32, and the integer counts they carry are
exact only in full float32."""

import jax
import jax.numpy as jnp
from jax.extend import core as jex_core

from lbzip2_tpu.core.constants import MAX_TREES
from lbzip2_tpu.ops import chain, huffenc

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    yield from _dots(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    yield from _dots(sub)


def _args(B=2, G=5):
    W = chain.WIDTH
    hist = jnp.ones((B, G, W), jnp.float32)
    ng = jnp.full((B,), G, jnp.int32)
    nt = jnp.full((B,), 2, jnp.int32)
    lengths = jnp.ones((B, MAX_TREES, W), jnp.int32)
    return hist, ng, nt, lengths


def test_estep_dots_full_precision():
    hist, ng, nt, lengths = _args()
    dots = list(_dots(jax.make_jaxpr(chain._em_estep_hist)(
        hist, ng, nt, lengths).jaxpr))
    assert len(dots) == 2
    for eqn in dots:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), eqn


def test_em_chain_dots_full_precision():
    hist, ng, nt, lengths = _args()
    as_arr = jnp.full((2,), 10, jnp.int32)
    jaxpr = jax.make_jaxpr(
        lambda *a: huffenc._em_chain(*a, cluster_factor=4))(
        hist, ng, nt, as_arr, lengths).jaxpr
    dots = list(_dots(jaxpr))
    assert dots, "em_chain traced no matmul"
    for eqn in dots:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), eqn

