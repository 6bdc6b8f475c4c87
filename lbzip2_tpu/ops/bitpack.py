"""Device bit packer: variable-length big-endian fields -> u32 words.

Data-parallel formulation of the reference transmitter's shift-register
loop (reference src/encode.c:1140-1281 PUTBIT/DUMP/SEND): instead of feeding
a sequential 64-bit buffer, every output *bit* finds its source field
with one sorted merge and reads its bit with a vectorized shift — no
data-dependent control flow, two device sorts + one gather total.

  starts  = exclusive cumsum of field lengths
  merge   = sort([field starts | output-bit grid]) tagging starts;
            running count of tags at each grid lane = its field id
  bit[p]  = (value[f] >> (end[f] - 1 - p)) & 1
  words   = (T/32, 32) @ MSB-first powers  (u32 big-endian words)

The byte-padding quirk that makes lbzip2 blocks byte-aligned
(reference src/encode.c:515-525) lives in the *field list* the encoder
emits, not here: the packer is exact for any (value, nbits) sequence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_INF = jnp.int32(2 ** 31 - 1)


@functools.partial(jax.jit, static_argnames=())
def pack_bits_device(values: jnp.ndarray, lens: jnp.ndarray,
                     nf: jnp.ndarray):
    """Pack fields (values[i] low lens[i] bits, MSB-first) into words.

    values: (N,) uint32; lens: (N,) int32 (0..32); nf: true field count
    (entries >= nf ignored).  Returns (words (N,) uint32 big-endian,
    total_bits int32).  Output capacity: N fields never produce more
    than 32*N bits, so (N,) words always suffice.
    """
    N = values.shape[0]
    T = 32 * N
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < nf
    ln = jnp.where(valid, lens, 0)
    ends = jnp.cumsum(ln, dtype=jnp.int32)
    starts = ends - ln
    total = ends[N - 1] if N > 0 else jnp.int32(0)

    # Merge field starts with the output-bit grid: one ascending sort
    # over positions, starts tagged 0 so they sort before grid lanes at
    # equal position.  After the merge, (#starts seen) - 1 at each grid
    # lane is its field id; a second sort by (tag, position) compacts
    # the grid lanes back to the front in position order.
    grid = jnp.arange(T, dtype=jnp.int32)
    pos_key = jnp.concatenate([jnp.where(valid & (ln > 0), starts, _INF),
                               grid])
    tag = jnp.concatenate([jnp.zeros(N, jnp.int32),
                           jnp.ones(T, jnp.int32)])
    fid = jnp.concatenate([idx, jnp.zeros(T, jnp.int32)])
    spos, stag, sfid = jax.lax.sort((pos_key, tag, fid), num_keys=2,
                                    dimension=0)
    # field id carried forward across grid lanes (cummax works: field
    # starts arrive in ascending id order because starts are monotone)
    run_fid = jax.lax.cummax(jnp.where(stag == 0, sfid, -1))
    _, bit_fid = jax.lax.sort((stag, run_fid), num_keys=1, dimension=0)
    # stable sort keeps position order within each tag; grid lanes
    # (tag 1) land after the N start entries (tag 0)
    bit_fid = jax.lax.slice_in_dim(bit_fid, N, N + T)

    f = jnp.clip(bit_fid, 0, N - 1)
    v = jnp.take(values.astype(jnp.uint32), f)
    e = jnp.take(ends, f)
    shift = jnp.clip(e - 1 - grid, 0, 31).astype(jnp.uint32)
    bits = ((v >> shift) & jnp.uint32(1)).astype(jnp.uint32)
    bits = jnp.where((grid < total) & (bit_fid >= 0), bits,
                     jnp.uint32(0))

    w = bits.reshape(N, 32)
    weights = (jnp.uint32(1) << (31 - jnp.arange(32, dtype=jnp.uint32)))
    words = jnp.sum(w * weights[None, :], axis=1, dtype=jnp.uint32)
    return words, total


def pack_bits_host(values, lens, nf=None) -> bytes:
    """Host wrapper: returns the packed big-endian byte string."""
    import numpy as np
    values = np.asarray(values, np.uint32)
    lens = np.asarray(lens, np.int32)
    if nf is None:
        nf = values.size
    words, total = pack_bits_device(jnp.asarray(values), jnp.asarray(lens),
                                    jnp.int32(nf))
    nbytes = (int(total) + 7) // 8
    return np.asarray(words).astype(">u4").tobytes()[:nbytes]
