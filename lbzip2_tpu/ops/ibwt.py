"""On-device inverse BWT via pointer-doubling list ranking.

The reference chases the IBWT linked list sequentially
(src/decode.c:852-930 + emit).  A sequential chase leaves a wide device
idle; this kernel instead materializes the traversal order with Wyllie-style
pointer doubling: starting from P (the one-step successor permutation),
it repeatedly composes P with itself while doubling a known-prefix
visit sequence — O(n log n) gathers, all dense vector work.

visit[k] = P^k(start);  out[k] = bwt[visit[k]].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def ibwt_masked(bwt: jnp.ndarray, n: jnp.ndarray, idx: jnp.ndarray):
    """Inverse BWT of bwt[:n] (padded to static N) with primary index.

    Returns (N,) uint8 plain bytes (entries >= n zero).
    """
    N = bwt.shape[0]
    n = jnp.asarray(n, jnp.int32)
    pos = jnp.arange(N, dtype=jnp.int32)
    valid = pos < n

    # ptr[slot] = BWT position whose (char, position) pair is slot-th in
    # stable order = stable sort of chars carrying positions.
    key = jnp.where(valid, bwt.astype(jnp.int32), 256)
    _, ptr = jax.lax.sort((key, pos), num_keys=1)

    # Pointer doubling: seq holds visit order for the first L steps;
    # jump[i] = P^L(i).  Double L until L >= N.
    start = ptr[idx]
    seq = jnp.where(pos == 0, start, 0).astype(jnp.int32)
    jump = ptr

    def body(carry, _):
        seq, jump, length = carry
        # extend: seq[length + k] = jump[seq[k]] for k < length
        ext = jump[seq]
        shifted = jnp.roll(ext, length)
        take_ext = (pos >= length) & (pos < 2 * length)
        seq = jnp.where(take_ext, shifted, seq)
        jump = jump[jump]
        return (seq, jump, length * 2), None

    import math
    steps = max(1, math.ceil(math.log2(N)))
    (seq, _, _), _ = jax.lax.scan(body, (seq, jump, jnp.int32(1)),
                                  None, length=steps)

    out = jnp.where(valid, bwt[seq], 0).astype(jnp.uint8)
    return out


ibwt_batched = jax.jit(jax.vmap(ibwt_masked))
