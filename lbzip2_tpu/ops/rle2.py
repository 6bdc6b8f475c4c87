"""Device RLE2: MTF ranks -> padded MTF-value stream (zero-run coding).

Completes the on-device encode chain after ops.mtf: zero runs become
bijective base-2 RUNA/RUNB digits, nonzero rank r becomes symbol r+1,
EOB terminates (reference src/encode.c:361-425 RUN()/MTF() macros).

Formulation: every input position computes locally whether it emits an
output cell — the j-th zero of a run of length k emits digit j of k+1
iff j < floor(log2(k+1)), a nonzero rank always emits — and a single
stable sort compacts kept cells to the front in position order.  No
scatters (the previous formulation needed 21 of them per row; the sort
costs one).
Run extents come from two cumulative maxima (forward: run start;
backward: next nonzero).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_INF = jnp.int32(2 ** 31 - 1)


def _rle2_batch(ranks: jnp.ndarray, ns: jnp.ndarray, ninuse: jnp.ndarray):
    """ranks: (B, N) int32 MTF ranks (entries >= n ignored); ns: (B,)
    row lengths; ninuse: (B,) used-byte counts (EOB = ninuse + 1).

    Returns (mtfv (B, N+1) int32 compacted to the front (0 beyond nm),
    nm (B,) true MTF-value counts including EOB).
    """
    B, N = ranks.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None], (B, N))
    nB = jnp.asarray(ns, jnp.int32)[:, None]
    valid = pos < nB
    r = jnp.where(valid, ranks, 0)
    nz = valid & (r > 0)

    # run start: 1 + last nonzero position strictly before i
    last_nz_incl = jax.lax.cummax(jnp.where(nz, pos, -1), axis=1)
    last_nz_excl = jnp.pad(last_nz_incl[:, :-1], ((0, 0), (1, 0)),
                           constant_values=-1)
    runstart = last_nz_excl + 1
    # next nonzero position at or after i (n if none: tail run ends at n)
    nxt = jnp.flip(jax.lax.cummax(
        jnp.flip(jnp.where(nz, -pos, -_INF), axis=1), axis=1), axis=1)
    next_nz = jnp.minimum(-nxt, nB)

    # zero-run cells: the j-th zero of a run of length k carries digit j
    # of (k+1) (bijective base 2, top bit dropped), j < floor(log2(k+1))
    k = next_nz - runstart
    runpos = pos - runstart
    m = 31 - jax.lax.clz(jnp.maximum(k, 0) + 1)
    digit = ((k + 1) >> jnp.clip(runpos, 0, 30)) & 1
    keep_zero = valid & (~nz) & (runpos < m)
    keep = nz | keep_zero
    value = jnp.where(nz, r + 1, digit)

    # EOB cell at position n (extra lane so n == N still fits)
    pos_x = jnp.concatenate([jnp.where(keep, pos, _INF), nB], axis=1)
    val_x = jnp.concatenate([jnp.where(keep, value, 0),
                             ninuse[:, None] + 1], axis=1)
    _, mtfv = jax.lax.sort((pos_x, val_x), num_keys=1, dimension=1)
    nm = jnp.sum(keep, axis=1, dtype=jnp.int32) + 1
    mtfv = jnp.where(
        jnp.arange(N + 1, dtype=jnp.int32)[None] < nm[:, None], mtfv, 0)
    return mtfv, nm


rle2_batch = jax.jit(_rle2_batch)


@jax.jit
def rle2_from_ranks(ranks: jnp.ndarray, n: jnp.ndarray,
                    ninuse: jnp.ndarray):
    """Single-row wrapper: returns (mtfv (N+1,) int32, nm int32)."""
    mtfv, nm = _rle2_batch(ranks[None, :], jnp.asarray(n, jnp.int32)[None],
                           jnp.asarray(ninuse, jnp.int32)[None])
    return mtfv[0], nm[0]
