"""Device Huffman decode: all groups of a block in parallel.

Device half of the speculative chunked decode plan (SURVEY §7.4;
reference retrieve being reproduced: src/decode.c:519-798).  bzip2's
selector-switched trees leave no bit-level synchronization points, so
the group *boundaries* come from a light sequential length-walk on the
host (native lbz2_retrieve_boundaries); given those starts, symbol
extraction — the bulk of retrieve — runs as a 50-step scan over all
~18k groups at once: each step peeks 20 bits per group cursor,
classifies the code length against the left-justified canonical bases
(src/decode.c:191-311 two-level table idea, re-expressed as compare
sums), and gathers the symbol from the permutation table.

Reconciliation: each group's final cursor must equal the next group's
host-walked start — the device path verifies its own speculation the
same way the block-level scanner/parser pair does (src/expand.c
design note at :31-52).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

GROUP_SIZE = 50
MAX_CODE_LENGTH = 20


@functools.partial(jax.jit, static_argnames=())
def decode_groups(words: jnp.ndarray, group_start: jnp.ndarray,
                  group_tree: jnp.ndarray, base: jnp.ndarray,
                  count: jnp.ndarray, perm: jnp.ndarray):
    """Decode 50 symbols per group, all groups in parallel.

    words: (W,) uint32 big-endian view of the input bytes;
    group_start: (G,) int32 absolute bit offsets; group_tree: (G,);
    base: (6, 22) uint32 left-justified 20-bit bases; count: (6, 22)
    int32 cumulative length counts; perm: (6, 258) int32.

    Returns (syms (G, 50) int32 internal symbol values, end (G,) int32
    cursor after each group's 50th symbol).  Symbols past a group's
    EOB are garbage; the host slices by total symbol count.
    """
    G = group_start.shape[0]
    t = group_tree.astype(jnp.int32)
    # per-group decode tables (small gathers, once per group)
    base_g = jnp.take(base.astype(jnp.uint32), t, axis=0)    # (G, 22)
    count_g = jnp.take(count.astype(jnp.int32), t, axis=0)   # (G, 22)
    perm_flat = perm.astype(jnp.int32).reshape(-1)            # (6*258,)

    def peek20(p):
        w = (p >> 5).astype(jnp.int32)
        o = (p & 31).astype(jnp.uint32)
        w0 = jnp.take(words, w, mode="clip")
        w1 = jnp.take(words, jnp.minimum(w + 1, words.shape[0] - 1),
                      mode="clip")
        v = jnp.where(o == 0, w0, (w0 << o) | (w1 >> (32 - o)))
        return v >> 12  # top 20 bits

    def step(p, _):
        v = peek20(p)
        # code length = #{k : v >= base[k+1]} + 1 over k = 1..20
        k = jnp.ones(G, jnp.int32)
        for kk in range(1, MAX_CODE_LENGTH + 1):
            k = k + (v >= base_g[:, kk + 1]).astype(jnp.int32)
        off = jnp.take_along_axis(count_g, k[:, None], axis=1)[:, 0]
        b = jnp.take_along_axis(base_g, k[:, None], axis=1)[:, 0]
        slot = off + ((v - b) >> (MAX_CODE_LENGTH - k)).astype(jnp.int32)
        sym = jnp.take(perm_flat, t * 258 + jnp.clip(slot, 0, 257))
        return p + k, sym

    end, syms = jax.lax.scan(step, group_start.astype(jnp.int32),
                             None, length=GROUP_SIZE)
    return jnp.transpose(syms), end


def decode_block_device(arr, nbits: int, payload_pos: int):
    """Full block decode with the Huffman stage on device.

    Host: boundary walk (C) -> device: parallel group decode ->
    reconcile cursors -> host: IMTF+RLE2 (C).  Returns (err, end_pos,
    bwt bytes, idx, rand) like native.retrieve_block."""
    import numpy as np

    from lbzip2_tpu import compile_cache, native

    compile_cache.enable_for_device()
    err, end_pos, meta = native.retrieve_boundaries(arr, nbits,
                                                    payload_pos)
    if err != 0:
        return err, payload_pos, None, 0, 0
    ng = meta["ngroups"]
    # Rebase bit offsets onto the block's own word window: cursors
    # stay in int32 for streams of any size (group offsets within one
    # block are < 2^24 bits), and the upload is bounded by the block's
    # payload instead of re-shipping the whole stream per block.
    starts_abs = meta["group_start"].astype(np.int64)
    base_word = int(starts_abs[0] // 32)
    end_word = (max(int(end_pos), int(starts_abs[ng - 1])) + 31) // 32
    lo, hi = 4 * base_word, min(4 * (end_word + 1), arr.size)
    win = arr[lo:hi]
    if win.size % 4:
        win = np.concatenate([win, np.zeros(4 - win.size % 4, np.uint8)])
    words = jnp.asarray(win.view(">u4").astype(np.uint32))
    starts_rel = (starts_abs - 32 * base_word).astype(np.int32)
    syms, end = decode_groups(
        words, jnp.asarray(starts_rel),
        jnp.asarray(meta["group_tree"].astype(np.int32)),
        jnp.asarray(meta["base"]), jnp.asarray(meta["count"]),
        jnp.asarray(np.asarray(meta["perm"], np.int32)))
    syms = np.asarray(syms)
    end = np.asarray(end)
    # reconcile: cursor after group g must hit group g+1's start
    # (the final group ends at EOB mid-group; the host walk's end
    # position bounds it instead)
    if ng > 1 and not np.array_equal(end[:ng - 1],
                                     starts_rel[1:ng]):
        from lbzip2_tpu.core.constants import Error
        return Error.ERR_PREFIX.value, payload_pos, None, 0, 0
    flat = syms[:ng].reshape(-1)[:meta["nsyms"]].astype(np.uint16)
    try:
        bwt = native.imtf_rle2(flat, meta["used"])
    except ValueError as e:
        from lbzip2_tpu.core.constants import Error
        return Error.ERR_OVERFLOW.value, payload_pos, None, 0, 0
    if meta["idx"] >= bwt.size:
        from lbzip2_tpu.core.constants import Error
        return Error.ERR_BWTIDX.value, payload_pos, None, 0, 0
    return 0, end_pos, bwt, meta["idx"], meta["rand"]
