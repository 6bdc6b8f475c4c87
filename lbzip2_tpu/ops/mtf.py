"""On-device Move-To-Front ranks via chunked last-occurrence scanning.

The reference's do_mtf (src/encode.c:361-425) is a sequential 256-entry
list walk.  This kernel uses the order-statistics identity instead:

  rank_i(s) = #{t : last[t] > last[s]}            (s seen before)
  rank_i(s) = #{t : seen(t)} + #{t < s : !seen(t)} (first occurrence)

where last[t] is the position of t's most recent occurrence before i.
A lax.scan over fixed-size chunks carries the 256-entry `last` vector;
within a chunk, exclusive cumulative-max of one-hot positions gives
every row's last[] view, so all ranks in a chunk are computed with
dense (C, 256) vector ops, no sequential list.  This is the CPU
formulation; on the GPU ops/mtf_triton.py runs the same identity as
one kernel per row.

rank 0 == "same symbol again" and is exactly the RLE2 zero-run member;
the zero-run digits (bijective base-2) are emitted by the host/RLE2
stage from these ranks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_CHUNK = 512


@functools.partial(jax.jit, static_argnames=("chunk",))
def mtf_ranks(syms: jnp.ndarray, n: jnp.ndarray, chunk: int = _CHUNK):
    """MTF ranks of compacted symbols syms[:n] (padded to static N).

    Returns (N,) int32 ranks; entries >= n are 0.
    """
    N = syms.shape[0]
    assert N % chunk == 0, "pad block length to a multiple of chunk"
    n = jnp.asarray(n, jnp.int32)
    x = syms.astype(jnp.int32).reshape(N // chunk, chunk)
    alpha = jnp.arange(256, dtype=jnp.int32)

    def step(last, xc_and_base):
        xc, base = xc_and_base
        gpos = base + jnp.arange(chunk, dtype=jnp.int32)  # global positions
        onehot = xc[:, None] == alpha[None, :]  # (C, 256)
        pos = jnp.where(onehot, gpos[:, None], jnp.int32(-1))
        incl = jax.lax.cummax(pos, axis=0)
        excl = jnp.concatenate(
            [jnp.full((1, 256), -1, jnp.int32), incl[:-1]], axis=0)
        combined = jnp.maximum(excl, last[None, :])  # (C, 256) last[] views

        prev = jnp.take_along_axis(combined, xc[:, None], axis=1)[:, 0]
        seen = combined >= 0
        rank_seen = jnp.sum((combined > prev[:, None]).astype(jnp.int32),
                            axis=1)
        rank_first = (jnp.sum(seen.astype(jnp.int32), axis=1)
                      + jnp.sum(((alpha[None, :] < xc[:, None]) & ~seen)
                                .astype(jnp.int32), axis=1))
        rank = jnp.where(prev >= 0, rank_seen, rank_first)
        new_last = jnp.maximum(last, incl[-1])
        return new_last, rank

    bases = (jnp.arange(N // chunk, dtype=jnp.int32) * chunk)
    _, ranks = jax.lax.scan(step, jnp.full(256, -1, jnp.int32), (x, bases))
    ranks = ranks.reshape(N)
    return jnp.where(jnp.arange(N, dtype=jnp.int32) < n, ranks, 0)


mtf_ranks_batched = jax.jit(jax.vmap(lambda s, n: mtf_ranks(s, n)))
