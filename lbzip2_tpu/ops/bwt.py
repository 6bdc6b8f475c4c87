"""On-device Burrows-Wheeler transform via prefix-doubling rotation sort.

The reference's divsufsort (src/divbwt.c) is a recursive induced sort —
hostile to XLA.  This kernel instead sorts *rotations* by rank doubling:
each round sorts (rank[i], rank[(i+k) mod n]) pairs with jax.lax.sort
and re-densifies ranks, doubling k until all ranks are distinct.  Any
correct rotation sort yields the identical BWT string (only the primary
index is ambiguous for fully-periodic blocks; see SURVEY/tests notes).

Shapes are static: blocks are padded to a fixed N and masked with the
true length n (a traced scalar), so one compiled kernel serves every
block size and vmaps cleanly over block batches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_INF = jnp.int32(2 ** 30)


def _doubling_pass(rank: jnp.ndarray, k: jnp.ndarray, n: jnp.ndarray,
                   idx: jnp.ndarray) -> jnp.ndarray:
    """One rank-doubling round: sort by (rank_i, rank_{i+k mod n})."""
    valid = idx < n
    j = jnp.where(valid, idx + k, 0)
    j = jnp.where(j >= n, j - n, j)  # (i + k) mod n without div
    k1 = jnp.where(valid, rank, _INF)
    k2 = jnp.where(valid, rank[j], _INF)
    sk1, sk2, si = jax.lax.sort((k1, k2, idx), num_keys=2)
    neq = jnp.concatenate([
        jnp.zeros(1, jnp.int32),
        ((sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])).astype(jnp.int32)])
    dense = jnp.cumsum(neq)
    return jnp.zeros_like(rank).at[si].set(dense)


@functools.partial(jax.jit, static_argnames=("max_doublings",))
def bwt_masked(block: jnp.ndarray, n: jnp.ndarray,
               max_doublings: int | None = None):
    """BWT of block[:n] (block padded to static N).

    Returns (bwt_out, primary_idx):
      bwt_out: (N,) uint8, positions >= n are zero-filled
      primary_idx: int32 rank of rotation 0.
    """
    N = block.shape[0]
    n = jnp.asarray(n, jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n

    # Seed ranks with 4-byte cyclic keys: skips two doubling levels.
    # Packed key is uint32-ordered; bias to signed int32 for the fast
    # single-key sort path.
    def cyc(d):
        j = idx + d
        j = jnp.where(j >= n, j - n, j)
        return block[j].astype(jnp.uint32)

    ku = (block.astype(jnp.uint32) * jnp.uint32(1 << 24)
          + cyc(1) * jnp.uint32(1 << 16) + cyc(2) * jnp.uint32(1 << 8)
          + cyc(3))
    # flip the top bit so uint32 order survives the int32 reinterpret
    key0 = jax.lax.bitcast_convert_type(ku ^ jnp.uint32(1 << 31),
                                        jnp.int32)
    key0 = jnp.where(valid, key0, jnp.int32(2 ** 31 - 1))
    sk, si = jax.lax.sort((key0, idx), num_keys=1)
    neq = jnp.concatenate([
        jnp.zeros(1, jnp.int32), (sk[1:] != sk[:-1]).astype(jnp.int32)])
    rank = jnp.zeros(N, jnp.int32).at[si].set(jnp.cumsum(neq))

    def cond(carry):
        rank, k, done = carry
        return jnp.logical_and(k < n, jnp.logical_not(done))

    def body(carry):
        rank, k, _ = carry
        rank = _doubling_pass(rank, k, n, idx)
        maxr = jnp.max(jnp.where(valid, rank, -1))
        return rank, k * 2, maxr == n - 1

    rank, _, _ = jax.lax.while_loop(
        cond, body, (rank, jnp.int32(4), jnp.max(
            jnp.where(valid, rank, -1)) == n - 1))

    # Tie-break any residual equal ranks (fully periodic blocks) by
    # DESCENDING original index (matches ref/bwt.py and native/sais.c).
    k1 = jnp.where(valid, rank, _INF)
    _, _, si = jax.lax.sort((k1, N - 1 - idx, idx), num_keys=2)
    final_rank = jnp.zeros(N, jnp.int32).at[si].set(idx)

    prev = jnp.where(idx == 0, n - 1, idx - 1)
    out = jnp.zeros(N, jnp.uint8).at[
        jnp.where(valid, final_rank, N - 1)].set(
        jnp.where(valid, block[prev], 0).astype(jnp.uint8),
        mode="drop")
    # positions >= n hold garbage from masked scatter; zero them
    out = jnp.where(idx < n, out, 0).astype(jnp.uint8)
    primary_idx = final_rank[0]
    return out, primary_idx


bwt_batched = jax.jit(jax.vmap(lambda blk, n: bwt_masked(blk, n)))


def pack_u8_rows(out: jnp.ndarray) -> jnp.ndarray:
    """Bitcast (B, N) uint8 -> (B, N//4) int32 for host transfer.

    Packing on device keeps the fetch to 4-byte words.  Little-endian:
    host side unpacks with ndarray.view(np.uint8).
    """
    B, N = out.shape
    return jax.lax.bitcast_convert_type(
        out.reshape(B, N // 4, 4), jnp.int32)


_pack_u8_rows = jax.jit(pack_u8_rows)


# ---------------------------------------------------------------------------
# Sparse prefix doubling (the production batch kernel).
#
# Full-array doubling resorts all N positions every round even though
# rank ties vanish quickly (on text ~68% of positions are already
# unique after an 8-byte prefix, ~0.02% after 1 KiB).  This kernel
# keeps only the *unresolved* positions in a compacted working set and
# shrinks its static capacity as ties resolve, so each round's sort /
# gather / scan work is proportional to the surviving ties instead of
# N.  The capacity cascade runs inside jit (a lax.while_loop per
# capacity level) so the host only intervenes between levels, and those
# syncs are hidden by pipelining other batches.
#
# Rank invariant (same as divsufsort's ISA, src/divbwt.c trsort): the
# rank of a rotation is the SA slot of the first member of its
# equivalence class; a class of tied rotations occupies consecutive SA
# slots, so after sorting a class by the k-step rank, the run starting
# at in-class offset d gets rank r1 + d.  Ties surviving k >= n are
# true rotational equals (fully periodic block) and are broken by
# descending start position — one extra pass with r2 = n-1-pos.
#
# Lengths are per-row (ns (B,) int32): RLE1 blocks vary in size, so a
# batch mixes lengths freely; full-shape gathers implement the cyclic
# indexing.
# ---------------------------------------------------------------------------

_SEED_KEYS = 4  # 16-byte seed prefix (k starts at 16)
_MIN_CAP = 2048


def _seed_sparse(blocks: jnp.ndarray, ns: jnp.ndarray):
    """Initial rank assignment from a 4*_SEED_KEYS-byte cyclic prefix.

    Returns (ISA, r1, wpos, cnt): ISA (B,N) int32 current ranks
    (N at padded lanes); r1/wpos (B,N) the compacted unresolved set in
    sorted order (INF/N at dead lanes); cnt (B,) unresolved counts.
    """
    B, N = blocks.shape
    idx = jnp.arange(N, dtype=jnp.int32)
    idxB = jnp.broadcast_to(idx[None, :], (B, N))
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    nB = ns[:, None]
    valid = idxB < nB

    b0 = blocks.astype(jnp.uint32)

    def key(q):  # bytes 4q..4q+3, cyclic per-row ("%" covers n < 16)
        def sh(d):
            jv = idxB + jnp.int32(d)
            jv = jnp.where(jv >= nB, jv - nB, jv)
            jv = jnp.where(jv >= nB, jv % jnp.maximum(nB, 1), jv)
            return jnp.take_along_axis(b0, jnp.where(valid, jv, 0),
                                       axis=1)
        ku = (sh(4 * q) * jnp.uint32(1 << 24)
              + sh(4 * q + 1) * jnp.uint32(1 << 16)
              + sh(4 * q + 2) * jnp.uint32(1 << 8)
              + sh(4 * q + 3))
        k = jax.lax.bitcast_convert_type(ku ^ jnp.uint32(1 << 31),
                                         jnp.int32)
        return jnp.where(valid, k, jnp.int32(2 ** 31 - 1))

    keys = tuple(key(q) for q in range(_SEED_KEYS))
    # idxB participates as the last key: within an all-0xFF seed class
    # the INT32_MAX pad lanes (idx >= n) then sort strictly after the
    # valid members, so class slot indices stay correct.
    sorted_ops = jax.lax.sort(keys + (idxB,), num_keys=_SEED_KEYS + 1,
                              dimension=1)
    sk, spos = sorted_ops[:-1], sorted_ops[-1]

    neq = jnp.zeros((B, N), jnp.bool_).at[:, 0].set(True)
    for a in sk:
        neq = neq | jnp.pad(a[:, 1:] != a[:, :-1], ((0, 0), (1, 0)))
    # dense rank = SA slot of the first member of the class
    lane = idxB
    rank_sorted = jax.lax.cummax(jnp.where(neq, lane, 0), axis=1)
    ISA = jnp.full((B, N), N, jnp.int32).at[rows, spos].set(
        rank_sorted, mode="drop")

    run_end = jnp.pad(neq[:, 1:], ((0, 0), (0, 1)), constant_values=True)
    resolved = neq & run_end
    keep = (~resolved) & (spos < nB)
    cnt = jnp.sum(keep, axis=1, dtype=jnp.int32)
    # compact kept lanes to the front, preserving sorted order
    ck, r1, wpos = jax.lax.sort(
        ((~keep).astype(jnp.int32), rank_sorted, spos), num_keys=1,
        dimension=1)
    r1 = jnp.where(ck == 0, r1, _INF)
    wpos = jnp.where(ck == 0, wpos, N)
    return ISA, r1, wpos, cnt


def _sparse_level(ISA, r1, wpos, k, cnt, ns, *, tie_break: bool):
    """Doubling rounds at one static capacity C = r1.shape[1].

    Runs until every tie resolves, the count fits in C//2 (host then
    shrinks), or k >= max(ns) (host then runs the tie-break pass).
    """
    B, N = ISA.shape
    C = r1.shape[1]
    laneC = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None],
                             (B, C))
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    nB = ns[:, None]
    maxn = jnp.max(ns)

    def one_pass(carry):
        ISA, r1, wpos, k, cnt = carry
        dead = wpos >= nB
        if tie_break:
            r2 = jnp.where(dead, laneC - _INF, nB - 1 - wpos)
        else:
            j = (wpos + k) % jnp.maximum(nB, 1)
            r2 = jnp.take_along_axis(
                ISA, jnp.where(dead, 0, j), axis=1)
            r2 = jnp.where(dead, laneC - _INF, r2)  # dead: unique runs
        sr1, sr2, sw = jax.lax.sort((r1, r2, wpos), num_keys=2,
                                    dimension=1)
        g = jnp.pad(sr1[:, 1:] != sr1[:, :-1], ((0, 0), (1, 0)),
                    constant_values=True)
        s = g | jnp.pad(sr2[:, 1:] != sr2[:, :-1], ((0, 0), (1, 0)),
                        constant_values=True)
        grp = jax.lax.cummax(jnp.where(g, laneC, 0), axis=1)
        run = jax.lax.cummax(jnp.where(s, laneC, 0), axis=1)
        newr = sr1 + (run - grp)
        run_end = jnp.pad(s[:, 1:], ((0, 0), (0, 1)),
                          constant_values=True)
        resolved = s & run_end
        ISA = ISA.at[rows, sw].set(newr, mode="drop")  # sw=N pads drop
        keep = (~resolved) & (sw < nB)
        cnt = jnp.sum(keep, axis=1, dtype=jnp.int32)
        ck, nr1, nw = jax.lax.sort(
            ((~keep).astype(jnp.int32), newr, sw), num_keys=1,
            dimension=1)
        nr1 = jnp.where(ck == 0, nr1, _INF)
        nw = jnp.where(ck == 0, nw, N)
        return ISA, nr1, nw, k * 2, cnt

    if tie_break:
        return one_pass((ISA, r1, wpos, k, cnt))

    floor = C <= _MIN_CAP  # no smaller capacity available

    def cond(carry):
        _, _, _, k, cnt = carry
        m = jnp.max(cnt)
        shrinkable = jnp.bool_(True) if floor else (m > C // 2)
        return shrinkable & (k < maxn) & (m > 0)

    return jax.lax.while_loop(cond, one_pass, (ISA, r1, wpos, k, cnt))


@functools.partial(jax.jit, static_argnames=("tie_break",))
def _sparse_level_jit(ISA, r1, wpos, k, cnt, ns, tie_break=False):
    return _sparse_level(ISA, r1, wpos, k, cnt, ns, tie_break=tie_break)


@jax.jit
def _seed_sparse_jit(blocks, ns):
    return _seed_sparse(blocks, jnp.asarray(ns, jnp.int32))


@jax.jit
def _emit_sparse(blocks: jnp.ndarray, ISA: jnp.ndarray, ns):
    """BWT bytes from the final ISA; int32-packed for fast download."""
    B, N = blocks.shape
    idxB = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None],
                            (B, N))
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    nB = jnp.asarray(ns, jnp.int32)[:, None]
    valid = idxB < nB
    pidx = jnp.where(idxB == 0, nB - 1, idxB - 1)
    prev = jnp.take_along_axis(blocks, jnp.where(valid, pidx, 0),
                               axis=1)
    out = jnp.zeros((B, N), jnp.uint8).at[
        rows, jnp.where(valid, ISA, N)].set(
        jnp.where(valid, prev, 0).astype(jnp.uint8), mode="drop")
    primary = ISA[:, 0]
    return pack_u8_rows(out), primary


def _pow2ceil(x: int) -> int:
    c = _MIN_CAP
    while c < x:
        c *= 2
    return c


class SparseBwtTask:
    """Resumable sparse-doubling BWT of one (B, N) batch (row lengths
    ns may differ).

    step() advances the device program without blocking whenever the
    pending unresolved-count fetch is ready; the codec drives many
    tasks round-robin so the count round-trips of one batch are hidden
    behind the kernels of the others.
    """

    def __init__(self, blocks_np, ns):
        ns = np.broadcast_to(np.asarray(ns, np.int32),
                             (blocks_np.shape[0],))
        self.maxn = int(ns.max())
        self.N = blocks_np.shape[1]
        self.blocks = jnp.asarray(blocks_np)
        self.ns = jnp.asarray(ns)
        self.ISA, self.r1, self.wpos, self.cnt = _seed_sparse_jit(
            self.blocks, self.ns)
        self.k = jnp.int32(4 * _SEED_KEYS)
        self.out = None
        self.done = False

    def ready(self) -> bool:
        probe = self.out if self.out is not None else self.cnt
        try:
            return probe.is_ready()
        except AttributeError:
            return True

    def step(self) -> bool:
        """Advance once; returns True when the BWT is finished."""
        if self.done:
            return True
        if self.out is not None:
            self.done = True
            return True
        cnt = np.asarray(self.cnt)
        m = int(cnt.max())
        k = int(np.asarray(self.k))
        if m == 0:
            self.out = _emit_sparse(self.blocks, self.ISA, self.ns)
        elif k >= self.maxn:
            # fully periodic residue: descending-position tie-break
            (self.ISA, self.r1, self.wpos, self.k,
             self.cnt) = _sparse_level_jit(
                self.ISA, self.r1, self.wpos, self.k, self.cnt,
                self.ns, tie_break=True)
        else:
            cap = min(_pow2ceil(m), self.N)
            (self.ISA, self.r1, self.wpos, self.k,
             self.cnt) = _sparse_level_jit(
                self.ISA, self.r1[:, :cap], self.wpos[:, :cap],
                self.k, self.cnt, self.ns)
        return False

    def result(self):
        """(bwt_packed int32 (B, N//4) np, primary (B,) np)."""
        while not self.done:
            self.step()
        packed, primary = self.out
        return np.asarray(packed), np.asarray(primary)


def bwt_batched_sparse(blocks_np, ns):
    """Synchronous convenience wrapper around SparseBwtTask.

    Returns (bwt_out (B,N) uint8, primary (B,)) like
    bwt_batched_uniform; ns may be a scalar or per-row lengths.
    """
    t = SparseBwtTask(np.asarray(blocks_np), ns)
    packed, primary = t.result()
    B = packed.shape[0]
    out = packed.view(np.uint8).reshape(B, -1) if packed.dtype == \
        np.int32 else packed
    return out, primary


# ---------------------------------------------------------------------------
# Uniform-length batch kernel: all blocks share one length n (the common
# case: every non-final block is exactly max_block_size).  The doubling
# pass accesses rank[(i+k) mod n], which for a shared scalar n is a
# cyclic shift — implemented with dynamic_update_slice + dynamic_slice
# (pure copies) instead of a random gather.
# ---------------------------------------------------------------------------


def _shift_cyclic(rank: jnp.ndarray, k: jnp.ndarray, n: jnp.ndarray):
    """rank[:, (i+k) mod n] for i < n, batched, gather-free."""
    B, N = rank.shape
    buf = jnp.zeros((B, 2 * N), rank.dtype)
    buf = jax.lax.dynamic_update_slice(buf, rank, (0, 0))
    buf = jax.lax.dynamic_update_slice(buf, rank, (jnp.int32(0), n))
    return jax.lax.dynamic_slice(buf, (jnp.int32(0), k), (B, N))


@jax.jit
def bwt_batched_uniform(blocks: jnp.ndarray, n: jnp.ndarray):
    """BWT of a (B, N) batch where every block has the same length n."""
    B, N = blocks.shape
    n = jnp.asarray(n, jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = (idx < n)[None, :]
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]

    b0 = blocks.astype(jnp.uint32)
    ku = (b0 * jnp.uint32(1 << 24)
          + _shift_cyclic(b0, jnp.int32(1), n) * jnp.uint32(1 << 16)
          + _shift_cyclic(b0, jnp.int32(2), n) * jnp.uint32(1 << 8)
          + _shift_cyclic(b0, jnp.int32(3), n))
    key0 = jax.lax.bitcast_convert_type(ku ^ jnp.uint32(1 << 31),
                                        jnp.int32)
    key0 = jnp.where(valid, key0, jnp.int32(2 ** 31 - 1))

    idxB = jnp.broadcast_to(idx[None, :], (B, N))

    def dense_rank(k1, k2):
        sk1, sk2, si = jax.lax.sort((k1, k2, idxB), num_keys=2,
                                    dimension=1)
        neq = jnp.concatenate([
            jnp.zeros((B, 1), jnp.int32),
            ((sk1[:, 1:] != sk1[:, :-1]) |
             (sk2[:, 1:] != sk2[:, :-1])).astype(jnp.int32)], axis=1)
        dense = jnp.cumsum(neq, axis=1)
        rank = jnp.zeros((B, N), jnp.int32).at[rows, si].set(dense)
        return rank

    rank = dense_rank(key0, jnp.zeros((B, N), jnp.int32))

    def cond(carry):
        rank, k, done = carry
        return jnp.logical_and(k < n, jnp.logical_not(done))

    def body(carry):
        rank, k, _ = carry
        k2 = jnp.where(valid, _shift_cyclic(rank, k, n), _INF)
        k1 = jnp.where(valid, rank, _INF)
        rank = dense_rank(k1, k2)
        maxr = jnp.max(jnp.where(valid, rank, -1))
        # uniform n: all blocks resolve when every max rank == n-1
        done = jnp.min(jnp.max(jnp.where(valid, rank, -1),
                               axis=1)) == n - 1
        del maxr
        return rank, k * 2, done

    done0 = jnp.min(jnp.max(jnp.where(valid, rank, -1), axis=1)) == n - 1
    rank, _, _ = jax.lax.while_loop(cond, body,
                                    (rank, jnp.int32(4), done0))

    # final tie-break by descending index
    k1 = jnp.where(valid, rank, _INF)
    _, _, si = jax.lax.sort((k1, N - 1 - idxB, idxB), num_keys=2,
                            dimension=1)
    final_rank = jnp.zeros((B, N), jnp.int32).at[rows, si].set(idxB)

    prev = jnp.where(idx == 0, n - 1, idx - 1)[None, :]
    prev_chars = jnp.take_along_axis(blocks, prev, axis=1)
    out = jnp.zeros((B, N), jnp.uint8).at[
        rows, jnp.where(valid, final_rank, N - 1)].set(
        jnp.where(valid, prev_chars, 0).astype(jnp.uint8), mode="drop")
    out = jnp.where(valid, out, 0).astype(jnp.uint8)
    primary_idx = final_rank[:, 0]
    return out, primary_idx
