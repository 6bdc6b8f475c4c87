"""MTF ranks as one Pallas-Triton program per row.

Same order-statistics identity as ops/mtf.py, but the chunk loop runs
inside the kernel: each program walks its row in CHUNK-symbol steps and
keeps the 256-entry last-occurrence vector in registers, so the carry
never goes through device memory and the whole batch is one launch.

Per chunk (C = CHUNK symbols x, chunk base position `base`):

  prev_in[i] = max{j < i : x[j] == x[i]} (or -1)      (C, C) compare
  d[i]       = i - prev_in[i]
  incl       = cumsum(onehot * d, axis=0) - 1  -> last index <= i, or -1
               (the d's of one symbol telescope to its latest position)
  comb       = max(base + exclusive incl, carried last[])   (C, 256)
  rank       = #{t: comb[t] > prev}              (seen before)
             | #seen + #{t < s: unseen}         (first occurrence)

Only cumsum, max/sum reductions and compares are used: Triton has no
cummax or roll.  Padding past a row's true length is symbol 0 and
cannot change the ranks before it (MTF is causal); the wrapper zeroes
those lanes.  Chunks of 32 with 4 warps keep the (C, 256) tiles in
registers; wider chunks spill (PERF.md "Kernel decisions" has the
H100 times against the lax.scan version).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

CHUNK = 32
NUM_WARPS = 4


def _kernel(x_ref, o_ref):
    n = x_ref.shape[0]
    alpha = jnp.arange(256, dtype=jnp.int32)[None, :]
    ii = jnp.arange(CHUNK, dtype=jnp.int32)

    def body(c, last):
        base = c * CHUNK
        x = pltriton.load(x_ref.at[pl.ds(base, CHUNK)])
        onehot = x[:, None] == alpha
        same = (x[:, None] == x[None, :]) & (ii[None, :] < ii[:, None])
        prev_in = jnp.max(jnp.where(same, ii[None, :], -1), axis=1)
        contrib = jnp.where(onehot, (ii - prev_in)[:, None], 0)
        csum = jnp.cumsum(contrib, axis=0)
        excl = csum - contrib - 1
        comb = jnp.maximum(jnp.where(excl >= 0, base + excl, -1),
                           last[None, :])
        prev = jnp.max(jnp.where(onehot, comb, -2), axis=1)
        seen = comb >= 0
        rank_seen = jnp.sum((comb > prev[:, None]).astype(jnp.int32),
                            axis=1)
        rank_first = (jnp.sum(seen.astype(jnp.int32), axis=1)
                      + jnp.sum(((alpha < x[:, None]) & ~seen)
                                .astype(jnp.int32), axis=1))
        pltriton.store(o_ref.at[pl.ds(base, CHUNK)],
                       jnp.where(prev >= 0, rank_seen, rank_first))
        tail = jnp.max(csum, axis=0) - 1   # last index in chunk, or -1
        return jnp.maximum(last, jnp.where(tail >= 0, base + tail, -1))

    jax.lax.fori_loop(0, n // CHUNK, body,
                      jnp.full((256,), -1, jnp.int32))


@functools.partial(jax.jit, static_argnames=("interpret",))
def mtf_ranks_rows_triton(syms: jnp.ndarray, ns: jnp.ndarray,
                          interpret: bool = False) -> jnp.ndarray:
    """MTF ranks of syms[b, :ns[b]] for a (B, N) batch, N a multiple
    of CHUNK; lanes >= ns[b] are 0."""
    B, N = syms.shape
    assert N % CHUNK == 0, "pad rows to a multiple of CHUNK"
    call = pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((N,), jnp.int32),
        grid=(),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="mtf_ranks",
    )
    ranks = jax.vmap(call)(syms.astype(jnp.int32))
    lanes = jnp.arange(N, dtype=jnp.int32)[None, :]
    return jnp.where(lanes < ns[:, None], ranks, 0)
