"""Device BWT v2: gather-free suffix doubling over Lyndon conjugates.

Replaces the rotation-sort formulation of ops/bwt.py with a *suffix*
sort: the host rotates each block to its least rotation (a Lyndon word
for primitive blocks), whose suffix order equals its rotation order, so
the device kernel never needs per-row cyclic indexing.  That keeps
random gathers and scatters out of the inner loop:

  - rank lookups ``ISA[i + k]`` become one ``dynamic_slice`` of an ISA
    array extended with position-coded end sentinels (past-end ranks
    are ``n - p - BIG``: strictly increasing toward shorter suffixes,
    so a shorter suffix — a prefix of a longer one — sorts first, and
    every tie at a sentinel resolves immediately);
  - each pass sorts 8 rank keys at once, so k multiplies by 8/pass;
  - the new ISA is rebuilt by a 1-key sort over positions or by a
    scatter (both implemented; flag below).  XLA:GPU hands that 1-key
    key/value sort to CUB's radix sort; the multi-key pass sorts use
    XLA's own comparison sort.

Spec note: any correct rotation sort yields the reference-identical
BWT string (see SURVEY §7.2); tie order for fully-periodic blocks is
host-side (those rows never reach this kernel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_INF = jnp.int32(2 ** 31 - 1)
_BIG = jnp.int32(1 << 30)

# ISA rebuild strategy: "sort" (1-key sort by position) or "scatter".
INVERT = "sort"


def _iota(B, N):
    return jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None], (B, N))


def _rows(B):
    return jnp.arange(B, dtype=jnp.int32)[:, None]


def _invert(newr, spos, nB, B, N):
    """ISA[pos] = rank for valid sorted lanes (spos < n per row)."""
    if INVERT == "sort":
        key = jnp.where(spos < nB, spos, _INF)
        _, isa = jax.lax.sort((key, newr), num_keys=1, dimension=1)
        return isa
    return jnp.zeros((B, N), jnp.int32).at[
        _rows(B), jnp.where(spos < nB, spos, N)].set(newr, mode="drop")


def _rank_from_sorted(starts, lane):
    """Rank = SA slot of the first member of each equal-key class."""
    return jax.lax.cummax(jnp.where(starts, lane, 0), axis=1)


def _starts(keys):
    """Class-start flags along lanes for a tuple of sorted key rows."""
    s = None
    for a in keys:
        d = jnp.pad(a[:, 1:] != a[:, :-1], ((0, 0), (1, 0)),
                    constant_values=True)
        s = d if s is None else (s | d)
    return s


def _unresolved(starts, spos, nB):
    """Per-row count of valid positions in classes of size >= 2."""
    run_end = jnp.pad(starts[:, 1:], ((0, 0), (0, 1)),
                      constant_values=True)
    singleton = starts & run_end
    return jnp.sum((~singleton) & (spos < nB), axis=1, dtype=jnp.int32)


def _seed16(blocks: jnp.ndarray, ns: jnp.ndarray):
    """Initial ISA from the 16-byte suffix prefix (k = 16 afterwards).

    blocks: (B, N) uint8 Lyndon conjugates; ns: (B,) row lengths.
    Returns (ISA (B,N) int32, cnt (B,) unresolved counts).

    Keys pack 4 raw bytes each (big-endian, sign-fixed for int32
    order).  Pad zeros beyond a row's end tie with real 0x00 bytes,
    which is safe: a pad byte is <= every byte value, so no strict
    order is ever wrong, and ties resolve in the rank passes whose
    end sentinels encode true suffix-length order.
    """
    B, N = blocks.shape
    idxB = _iota(B, N)
    nB = ns[:, None]
    bp = jnp.where(idxB < nB, blocks.astype(jnp.uint32), 0)
    ext = jnp.concatenate([bp, jnp.zeros((B, 16), jnp.uint32)], axis=1)

    def key(q):  # bytes 4q..4q+3, big-endian
        k = jnp.zeros((B, N), jnp.uint32)
        for j in range(4):
            k = (k << 8) | jax.lax.slice(ext, (0, 4 * q + j),
                                         (B, 4 * q + j + N))
        return (k ^ jnp.uint32(0x80000000)).astype(jnp.int32)

    k0 = jnp.where(idxB < nB, key(0), _INF)
    ops = jax.lax.sort((k0, key(1), key(2), key(3), idxB),
                       num_keys=4, dimension=1)
    sk, spos = ops[:-1], ops[-1]
    st = _starts(sk)
    newr = _rank_from_sorted(st, idxB)
    cnt = _unresolved(st, spos, nB)
    return _invert(newr, spos, nB, B, N), cnt


def _extend(ISA, idxB, nB, N):
    """ISA with end sentinels in-row and a sentinel tail (width 2N)."""
    B = ISA.shape[0]
    body = jnp.where(idxB < nB, ISA, nB - idxB - _BIG)
    tail = nB - (idxB + N) - _BIG
    return jnp.concatenate([body, tail], axis=1)


def _passx(ISA: jnp.ndarray, k: jnp.ndarray, ns: jnp.ndarray,
           nkeys: int):
    """One doubling pass: sort by ranks at offsets (0, k, .., (m-1)k).

    Returns (ISA', cnt) with rank distance advanced to m*k.
    Production uses m=8 (fewer passes, fewer invert sorts).
    """
    B, N = ISA.shape
    idxB = _iota(B, N)
    nB = ns[:, None]
    ext = _extend(ISA, idxB, nB, N)

    def at(off):
        off = jnp.minimum(off, jnp.int32(N))
        return jax.lax.dynamic_slice(ext, (jnp.int32(0), off), (B, N))

    rs = [jnp.where(idxB < nB, ISA, _INF)]  # pads sort last
    for j in range(1, nkeys):
        r = at(j * k)
        if j >= 2:
            # beyond-slice lanes (i+off >= 2N window) need sentinels
            r = jnp.where(idxB + j * k < 2 * N, r,
                          nB - (idxB + j * k) - _BIG)
        rs.append(r)
    out = jax.lax.sort(tuple(rs) + (idxB,), num_keys=nkeys, dimension=1)
    srs, spos = out[:-1], out[-1]
    st = _starts(srs)
    newr = _rank_from_sorted(st, idxB)
    cnt = _unresolved(st, spos, nB)
    return _invert(newr, spos, nB, B, N), cnt


def _pass4(ISA, k, ns):
    return _passx(ISA, k, ns, 4)


def _pass8(ISA, k, ns):
    return _passx(ISA, k, ns, 8)


def _emit2(blocks: jnp.ndarray, ISA: jnp.ndarray, ns: jnp.ndarray,
           ms: jnp.ndarray):
    """BWT output for download + primary index per row.

    Returns (tokens (B, TOK//2) int32, raw (B, N//4) int32,
    run_counts (B,), primary (B,)).  BWT strings are run-heavy (that is
    their purpose), so the preferred download is byte+length run tokens
    (u16 pairs, runs split at 255), smaller than the raw bytes when the
    mean run is >= 4.  The raw int32-packed rows
    are also materialized on device; the host fetches whichever the
    run counts say fits (tokens overflow on near-incompressible rows).

    ms: (B,) least-rotation offsets of the original blocks; the primary
    index is the rank of original rotation 0 = ISA[(n - m) mod n].
    """
    B, N = blocks.shape
    idxB = _iota(B, N)
    nB = ns[:, None]
    last = jnp.take_along_axis(blocks, nB - 1, axis=1)  # R[n-1]
    prev = jnp.concatenate([last, blocks[:, :N - 1].astype(jnp.uint8)],
                           axis=1)
    key = jnp.where(idxB < nB, ISA, _INF)
    _, sbwt = jax.lax.sort((key, prev.astype(jnp.int32)), num_keys=1,
                           dimension=1)
    out = sbwt.astype(jnp.uint8)
    raw = jax.lax.bitcast_convert_type(
        out.reshape(B, N // 4, 4), jnp.int32)

    # run tokens: starts at byte changes, plus synthetic splits so no
    # run exceeds 255 (token length field is 8 bits)
    valid = idxB < nB
    start = valid & jnp.pad(sbwt[:, 1:] != sbwt[:, :-1],
                            ((0, 0), (1, 0)), constant_values=True)
    runstart = jax.lax.cummax(jnp.where(start, idxB, 0), axis=1)
    start = start | (valid & ((idxB - runstart) % 255 == 0) &
                     (idxB != runstart))
    run_counts = jnp.sum(start, axis=1, dtype=jnp.int32)
    ck = jnp.where(start, idxB, _INF)
    spos, sbyte = jax.lax.sort((ck, sbwt), num_keys=1, dimension=1)
    nxt = jnp.concatenate([spos[:, 1:], jnp.full((B, 1), _INF)], axis=1)
    length = jnp.where(nxt >= _INF, nB - spos, nxt - spos)
    length = jnp.clip(length, 0, 255)  # dead lanes -> 0
    tok = (sbyte.astype(jnp.uint16) << 8) | length.astype(jnp.uint16)
    TOK = N // 4  # token capacity: mean run >= 4 fits
    tokens = jax.lax.bitcast_convert_type(
        tok[:, :TOK].reshape(B, TOK // 2, 2), jnp.int32)

    i0 = jnp.where(ms[:, None] == 0, 0, ns[:, None] - ms[:, None])
    primary = jnp.take_along_axis(ISA, i0, axis=1)[:, 0]
    return tokens, raw, run_counts, primary


def _emit_bytes(blocks: jnp.ndarray, ISA: jnp.ndarray, ns: jnp.ndarray,
                ms: jnp.ndarray):
    """BWT rows as device-resident bytes (device-chain mode).

    One sort instead of emit2's two: no run tokens are built because
    the bytes stay on device for the MTF/EM/pack chain (ops/chain.py)
    and only the compressed payload is downloaded.
    Returns (bwt (B, N) uint8, primary (B,))."""
    B, N = blocks.shape
    idxB = _iota(B, N)
    nB = ns[:, None]
    last = jnp.take_along_axis(blocks, nB - 1, axis=1)
    prev = jnp.concatenate([last, blocks[:, :N - 1].astype(jnp.uint8)],
                           axis=1)
    key = jnp.where(idxB < nB, ISA, _INF)
    _, sbwt = jax.lax.sort((key, prev.astype(jnp.int32)), num_keys=1,
                           dimension=1)
    i0 = jnp.where(ms[:, None] == 0, 0, ns[:, None] - ms[:, None])
    primary = jnp.take_along_axis(ISA, i0, axis=1)[:, 0]
    return sbwt.astype(jnp.uint8), primary


seed16 = jax.jit(_seed16)
pass4 = jax.jit(_pass4)
pass8 = jax.jit(_pass8)
emit2 = jax.jit(_emit2)
emit_bytes = jax.jit(_emit_bytes)


def _resolve_loop(blocks, ns):
    """seed16 + device while_loop of x8 passes until every row's ties
    resolve.  One dispatch: no per-pass unresolved-count download by
    the caller.  XLA:GPU reads the loop predicate back to the host each
    iteration, so the dispatching call returns only when the loop
    ends."""
    ISA, cnt = _seed16(blocks, ns)

    def cond(c):
        _, _, cnt = c
        return jnp.max(cnt) > 0

    def body(c):
        ISA, k, _ = c
        ISA, cnt = _pass8(ISA, k, ns)
        return ISA, k * 8, cnt

    ISA, _, _ = jax.lax.while_loop(cond, body, (ISA, jnp.int32(16), cnt))
    return ISA


@jax.jit
def bwt2_tokens(blocks: jnp.ndarray, ns: jnp.ndarray, ms: jnp.ndarray):
    """Whole batched BWT in ONE device program, emitting run tokens.

    The production compressor's device kernel (codec/encoder.py): the
    host uploads a (B, N) batch of Lyndon conjugates, dispatches this
    once, and downloads (tokens, run_counts, primary) — raw packed rows
    are fetched per-row only on token overflow.  Replaces the
    host-stepped Bwt2Task pipeline and its per-pass count round
    trips."""
    ISA = _resolve_loop(blocks, ns)
    return _emit2(blocks, ISA, ns, ms)


@jax.jit
def bwt2_bytes(blocks: jnp.ndarray, ns: jnp.ndarray, ms: jnp.ndarray):
    """One-dispatch batched BWT leaving rows on device (chain mode).

    Returns (bwt (B, N) uint8, primary (B,)) as device arrays for
    ops/chain.py's MTF/EM/pack chain."""
    ISA = _resolve_loop(blocks, ns)
    return _emit_bytes(blocks, ISA, ns, ms)


@jax.jit
def bwt2_full(blocks: jnp.ndarray, ns: jnp.ndarray, ms: jnp.ndarray):
    """Whole BWT in one program: seed + while_loop of x8 passes + emit.

    The variant used under shard_map for multi-chip block parallelism
    (each shard loops independently until its ties resolve); raw packed
    rows are returned (tokens are a download-size optimization; XLA
    dead-code-eliminates them here).
    """
    ISA = _resolve_loop(blocks, ns)
    _, raw, _, primary = _emit2(blocks, ISA, ns, ms)
    return raw, primary


class Bwt2Task:
    """Resumable device BWT of one (B, N) batch of Lyndon conjugates.

    Interface mirrors ops.bwt.SparseBwtTask: drive with ready()/step()
    round-robin across tasks so per-dispatch latency hides behind other
    batches' kernels; result() blocks.

    blocks_np: pre-rotated rows; ns: true lengths; ms: rotation offsets
    (from native.lyndon_prep).  Rows must be primitive (m >= 0).
    """

    # speculative dispatch-ahead depth: a pass applied to an already-
    # resolved ISA is the identity, so running one pass "too many"
    # while the previous pass's unresolved count is still in flight is
    # safe and hides the per-pass count-download round trip
    _AHEAD = 2

    def __init__(self, blocks_np, ns, ms, emit: str = "tokens"):
        B, N = blocks_np.shape
        self.N = N
        self.maxn = int(np.max(ns))
        self.blocks = jax.device_put(np.ascontiguousarray(blocks_np))
        self.ns = jax.device_put(np.asarray(ns, np.int32))
        self.ms = jax.device_put(np.asarray(ms, np.int32))
        self.ISA, cnt = seed16(self.blocks, self.ns)
        self.pending = [cnt]  # unread unresolved-counts, oldest first
        self.k = 16
        self.emit = emit  # "tokens" (host download) | "bytes" (chain)
        self.out = None
        self.done = False

    @staticmethod
    def _is_ready(a) -> bool:
        try:
            return a.is_ready()
        except AttributeError:
            return True

    def ready(self) -> bool:
        if self.out is not None:
            return self._is_ready(self.out[0])
        if self.pending and self._is_ready(self.pending[0]):
            return True
        # room to dispatch another speculative pass?
        return len(self.pending) < self._AHEAD and self.k <= 8 * self.N

    def _emit(self):
        if self.emit == "bytes":
            self.out = emit_bytes(self.blocks, self.ISA, self.ns,
                                  self.ms)
            return
        self.out = emit2(self.blocks, self.ISA, self.ns, self.ms)
        # start the d2h copies now so they overlap later batches'
        # kernels: metadata, plus the token payload itself (the big
        # transfer).  raw is fetched only on token
        # overflow (rare), so it is not copied eagerly.
        for a in (self.out[0], self.out[2], self.out[3]):
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass

    def step(self) -> bool:
        if self.done:
            return True
        if self.out is not None:
            self.done = True
            return True
        # consume any landed counts (oldest first)
        while self.pending and self._is_ready(self.pending[0]):
            if int(np.max(np.asarray(self.pending.pop(0)))) == 0:
                # resolved; later speculative passes were identities,
                # so the latest ISA equals the resolved one
                self.pending.clear()
                self._emit()
                return False
        if len(self.pending) < self._AHEAD and self.k <= 8 * self.N:
            # Full-width passes only: a compact-tail variant (work on
            # the unresolved set once it shrinks) compiles one program
            # per capacity; three programs per bucket (seed/pass/emit)
            # keep the compile surface flat (see git history for the
            # variant).
            self.ISA, cnt = pass8(self.ISA, jnp.int32(self.k), self.ns)
            self.pending.append(cnt)
            self.k *= 8
        elif not self.pending:
            # k exceeded every possible tie distance: resolved
            self._emit()
        else:
            # ahead-limit reached: block on the oldest count
            if int(np.max(np.asarray(self.pending.pop(0)))) == 0:
                self.pending.clear()
                self._emit()
        return False

    def result_device(self):
        """Device-resident (bwt (B, N) uint8, primary (B,)) — chain
        mode (emit="bytes"); nothing is downloaded."""
        assert self.emit == "bytes"
        while not self.done:
            self.step()
        return self.out

    def result(self):
        """(rows, primary): rows is a list of per-row uint8 BWT arrays.

        Downloads run tokens (~0.35x bytes on text) when every row fits
        the token capacity, else the raw packed rows."""
        assert self.emit == "tokens"
        while not self.done:
            self.step()
        tokens, raw, run_counts, primary = self.out
        counts = np.asarray(run_counts)
        ns = np.asarray(self.ns)
        cap = tokens.shape[1] * 2
        rows = []
        if int(counts.max()) <= cap:
            tok = np.asarray(tokens).view(np.uint16).reshape(
                counts.shape[0], -1)
            for b in range(counts.shape[0]):
                t = tok[b, :counts[b]]
                rows.append(np.repeat((t >> 8).astype(np.uint8),
                                      t & 0xFF)[:ns[b]])
        else:
            rb = np.asarray(raw).view(np.uint8).reshape(
                counts.shape[0], -1)
            for b in range(counts.shape[0]):
                rows.append(rb[b, :ns[b]])
        return rows, np.asarray(primary)


def bwt2_batch(blocks_np, ns, ms):
    """Synchronous wrapper: (bwt (B,N) uint8, primary (B,))."""
    t = Bwt2Task(np.asarray(blocks_np), ns, ms)
    rows, primary = t.result()
    N = np.asarray(blocks_np).shape[1]
    out = np.zeros((len(rows), N), np.uint8)
    for b, r in enumerate(rows):
        out[b, :r.size] = r
    return out, primary
