"""Device encode chain: BWT bytes -> MTF -> RLE2 -> EM -> packed payload.

Composes the per-stage kernels into the three fused device programs the
production encoder dispatches per batch (reference hot path being
reproduced: src/encode.c:361-425 do_mtf, :1005-1084 EM loop, :1140-1281
transmit):

  chain_mtf:   (bwt bytes, cmaps) -> mtfv, nm, mtf_freq histogram
  em_estep_batch: one EM expectation step with the spec's 10-bit-lane
               carry semantics, batched with per-row tree counts
  pack_groups: per-symbol Huffman codes -> payload bit groups packed
               into u32 words (two-level: 50-symbol groups into
               1024-bit slots, slots merged by group bit offsets)

The M-step (per-tree Huffman refit over <=259 symbols) stays on the
host between E-steps: it is tiny, sequential, and its exact tie-breaks
are already encoded in native/huffman2.c.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lbzip2_tpu.core.constants import GROUP_SIZE, MAX_ALPHA_SIZE, MAX_TREES
from lbzip2_tpu.ops.mtf import mtf_ranks
from lbzip2_tpu.ops.rle2 import _rle2_batch



def _mtf_ranks_rows(syms, ns):
    """Batched MTF ranks: one Pallas-Triton program per row on the GPU,
    the lax.scan formulation elsewhere (bit-identical)."""
    if jax.default_backend() == "gpu":
        from lbzip2_tpu.ops.mtf_triton import mtf_ranks_rows_triton
        return mtf_ranks_rows_triton(syms, ns)
    return jax.vmap(lambda s, n: mtf_ranks(s, n))(syms, ns)

_INF = jnp.int32(2 ** 31 - 1)
WIDTH = MAX_ALPHA_SIZE + 1  # 259: symbols 0..257 + per-row dummy `as`


def _compact_syms(bwt: jnp.ndarray, cmaps: jnp.ndarray) -> jnp.ndarray:
    """Map raw BWT bytes to compacted symbol ids (popcount-mask form
    instead of a 256-table gather)."""
    B, N = bwt.shape
    bits = cmaps.reshape(B, 8, 32).astype(jnp.uint32)
    w = jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32)[None, None],
                axis=2)  # (B, 8) bitmask words
    pc = jax.lax.population_count(w)
    pre = jnp.cumsum(pc, axis=1) - pc
    v = bwt.astype(jnp.uint32)
    hi = (v >> 5).astype(jnp.int32)
    lo = v & 31
    word = jnp.zeros_like(v)
    base = jnp.zeros_like(v)
    for k in range(8):
        sel = hi == k
        word = jnp.where(sel, w[:, k:k + 1], word)
        base = jnp.where(sel, pre[:, k:k + 1].astype(jnp.uint32), base)
    mask = jnp.where(lo == 0, jnp.uint32(0),
                     jnp.uint32(0xFFFFFFFF) >> (32 - lo))
    return (base + jax.lax.population_count(word & mask)).astype(jnp.int32)


def _hist_rows(ids: jnp.ndarray, valid: jnp.ndarray, nbins: int):
    """Per-row histogram of ids under a validity mask, via one sorted
    merge with bin probes (no scatter, no giant one-hot).

    ids: (B, L) int32 in [0, nbins); returns (B, nbins) int32 counts.
    """
    B, L = ids.shape
    probes = jnp.broadcast_to(jnp.arange(nbins, dtype=jnp.int32)[None],
                              (B, nbins))
    keys = jnp.concatenate([probes, jnp.where(valid, ids, nbins)], axis=1)
    tags = jnp.concatenate([jnp.zeros((B, nbins), jnp.int32),
                            jnp.ones((B, L), jnp.int32)], axis=1)
    skeys, stags = jax.lax.sort((keys, tags), num_keys=2, dimension=1)
    # probe positions in the merged order, in bin order (stable sort)
    lane = jnp.broadcast_to(jnp.arange(nbins + L, dtype=jnp.int32)[None],
                            (B, nbins + L))
    _, ppos = jax.lax.sort((stags, lane), num_keys=1, dimension=1)
    ppos = jax.lax.slice_in_dim(ppos, 0, nbins, axis=1)
    nxt = jnp.concatenate(
        [ppos[:, 1:], jnp.full((B, 1), nbins + L, jnp.int32)], axis=1)
    # between probe c and probe c+1 sit count[c] ids plus one probe
    counts = nxt - ppos - 1
    # invalid ids (key nbins) sort past the last probe and never count
    last = jnp.sum(valid, axis=1, dtype=jnp.int32) + nbins
    counts = counts.at[:, -1].set(last - ppos[:, -1] - 1)
    return counts


def _chain_mtf(bwt: jnp.ndarray, ns: jnp.ndarray, cmaps: jnp.ndarray):
    """BWT bytes -> (mtfv (B, N+1) int32, nm (B,), hist (B, WIDTH)).

    hist counts mtfv[:nm] per row (the global MTF frequency table the
    host uses for the initial equivalence classes)."""
    B, N = bwt.shape
    syms = _compact_syms(bwt, cmaps)
    ninuse = jnp.sum(cmaps.astype(jnp.int32), axis=1)
    ranks = _mtf_ranks_rows(syms, ns)
    mtfv, nm = _rle2_batch(ranks, ns, ninuse)
    lanes = jnp.arange(N + 1, dtype=jnp.int32)[None]
    hist = _hist_rows(mtfv, lanes < nm[:, None], WIDTH)
    return mtfv, nm, hist


chain_mtf = jax.jit(_chain_mtf)


def _group_hist(mtfv: jnp.ndarray, nm: jnp.ndarray,
                ninuse: jnp.ndarray):
    """Per-group symbol histogram (B, G, WIDTH) f32, plus the padded
    groups view and ngroups.  Computed ONCE per batch; every EM
    E-step then reduces it with two matmuls.  Counts are <= 50, and
    all downstream sums stay < 2^24, so f32 matmul arithmetic is
    exact integer arithmetic throughout."""
    B, NP = mtfv.shape
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    pad_to = G * GROUP_SIZE
    as_ = (ninuse + 2)[:, None]
    lanes = jnp.arange(pad_to, dtype=jnp.int32)[None]
    padded = jnp.where(
        lanes < nm[:, None],
        jnp.pad(mtfv, ((0, 0), (0, pad_to - NP))), as_)
    groups = padded.reshape(B, G, GROUP_SIZE)
    ngroups = (nm + GROUP_SIZE - 1) // GROUP_SIZE
    bi = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    gi = jnp.arange(G, dtype=jnp.int32)[None, :, None]
    hist = jnp.zeros((B, G, WIDTH), jnp.float32).at[
        bi, gi, jnp.minimum(groups, WIDTH - 1)].add(1.0)
    return hist, groups, ngroups


group_hist = jax.jit(_group_hist)

_EXACT = jax.lax.Precision.HIGHEST  # f32 matmuls exact for ints < 2^24


def _em_estep_hist(hist: jnp.ndarray, ngroups: jnp.ndarray,
                   nt: jnp.ndarray, lengths: jnp.ndarray):
    """One batched EM expectation step (exact spec semantics), as two
    matmuls over the per-group histogram (SURVEY §7.2: the
    reference's find_best_tree is a matmul-shaped reduction,
    src/encode.c:847-877).

    hist: (B, G, WIDTH) from group_hist; nt: (B,); lengths:
    (B, MAX_TREES, WIDTH) int32 code lengths (per-row dummy symbol 0).
    Returns (selectors (B, G) int32, freqs (B, MAX_TREES, WIDTH)
    int32).

    Spec: per 50-symbol group the per-tree costs are base-1024 lanes
    of a wrapping uint64 accumulator — carries from lower lanes
    pollute upper ones (reference src/encode.c:1044-1084); first
    minimum wins.  Integer sums commute, so packing the TRUE per-tree
    costs into the same two uint32 words reproduces the reference's
    per-symbol packed accumulation bit-for-bit.
    """
    B, G, _ = hist.shape
    # true per-tree group costs: (B, G, W) @ (B, W, T), full float32
    C = jax.lax.dot_general(
        hist, lengths.astype(jnp.float32),
        (((2,), (2,)), ((0,), (0,))), precision=_EXACT
    ).astype(jnp.uint32)  # (B, G, MAX_TREES)
    glo = C[..., 0] + (C[..., 1] << 10) + (C[..., 2] << 20)
    ghi = C[..., 3] + (C[..., 4] << 10) + (C[..., 5] << 20)
    ghi = ghi + (glo >> 30)  # lane-2 overflow crosses the word boundary
    # 10-bit lane extraction, first-min selection
    best = jnp.full((B, G), 0x400, jnp.uint32)
    bt = jnp.zeros((B, G), jnp.int32)
    for t in range(MAX_TREES):
        word = glo if t < 3 else ghi
        c = (word >> (10 * (t % 3))) & 0x3FF
        live = t < nt[:, None]
        better = live & ((t == 0) | (c < best))
        best = jnp.where(better, c, best)
        bt = jnp.where(better, t, bt)

    # per-selected-tree symbol totals: (B, T, G) @ (B, G, W) matmul
    gvalid = jnp.arange(G, dtype=jnp.int32)[None] < ngroups[:, None]
    onehot = ((bt[:, None, :] == jnp.arange(
        MAX_TREES, dtype=jnp.int32)[None, :, None]) &
        gvalid[:, None, :]).astype(jnp.float32)
    freqs = jax.lax.dot_general(
        onehot, hist, (((2,), (1,)), ((0,), (0,))), precision=_EXACT
    ).astype(jnp.int32)  # (B, MAX_TREES, WIDTH)
    return bt, freqs


em_estep_hist = jax.jit(_em_estep_hist)


def _em_estep_batch(mtfv: jnp.ndarray, nm: jnp.ndarray,
                    ninuse: jnp.ndarray, nt: jnp.ndarray,
                    lengths: jnp.ndarray):
    """One-shot E-step wrapper (tests, single iterations): builds the
    group histogram and runs one matmul E-step.  Production drivers
    build the histogram once and call em_estep_hist per iteration.
    Returns (selectors, freqs, ngroups)."""
    hist, _, ngroups = _group_hist(mtfv, nm, ninuse)
    bt, freqs = _em_estep_hist(hist, ngroups, nt, lengths)
    return bt, freqs, ngroups


em_estep_batch = jax.jit(_em_estep_batch)


# ---------------------------------------------------------------------------
# Device payload pack: two-level group packing.
# ---------------------------------------------------------------------------

_SLOT_WORDS = 32  # 1024 bits >= 50 codes * 20 bits + padding room


def _pack_groups(mtfv: jnp.ndarray, nm: jnp.ndarray,
                 ninuse: jnp.ndarray, ngroups: jnp.ndarray,
                 selectors: jnp.ndarray, codes: jnp.ndarray,
                 lens: jnp.ndarray, start_bit: jnp.ndarray,
                 W: int):
    """Pack every group's Huffman codes into the payload bit stream.

    mtfv: (B, NP) int32 padded with the dummy symbol (len 0 => emits
    nothing); selectors: (B, G) final tree per group; codes/lens:
    (B, MAX_TREES, WIDTH) final tables (dummy symbol len 0);
    start_bit: (B,) bit offset of the payload within its output word
    stream (0..31: the header's residual bit position, so the host can
    OR the first word over the header tail).

    Returns (words (B, W) uint32 big-endian payload words,
    total_bits (B,) payload bits including the leading start_bit skew).
    """
    B, NP = mtfv.shape
    G = (NP + GROUP_SIZE - 1) // GROUP_SIZE
    as_ = (ninuse + 2)[:, None]
    lanes = jnp.arange(G * GROUP_SIZE, dtype=jnp.int32)[None]
    padded = jnp.where(lanes < nm[:, None],
                       jnp.pad(mtfv, ((0, 0),
                                      (0, G * GROUP_SIZE - NP))), as_)
    groups = padded.reshape(B, G, GROUP_SIZE)

    # per-symbol code + length via ONE small-table gather: canonical
    # codes are < 2^20 and lengths <= 20, so (len << 24) | code packs
    # into int32 — halves the dominant 28.8M-element gather traffic
    tree = jnp.clip(selectors, 0, MAX_TREES - 1)
    flat_sym = (tree[:, :, None] * WIDTH + groups).reshape(B, -1)
    packed_tab = ((lens.astype(jnp.int32) << 24) |
                  codes.astype(jnp.int32)).reshape(B, MAX_TREES * WIDTH)
    pv = jnp.take_along_axis(packed_tab, flat_sym, axis=1).reshape(
        B, G, GROUP_SIZE)
    cv = (pv & 0x00FFFFFF).astype(jnp.uint32)
    lv = pv >> 24
    gvalid = (jnp.arange(G, dtype=jnp.int32)[None] < ngroups[:, None])
    lv = jnp.where(gvalid[:, :, None], lv, 0)

    # level 1: pack 50 codes into a 1024-bit slot per group.
    # ends[i] = bit offset after code i within the group
    ends = jnp.cumsum(lv, axis=2)
    gbits = ends[:, :, -1]  # (B, G) <= 1000
    starts = ends - lv
    # each code contributes to words s>>5 and s>>5 + 1 of its slot:
    # aligned = code << (64 - (s & 31) - len), split into hi/lo words
    s_in = starts & 31
    widx = starts >> 5
    # align each code into a 64-bit window at bit s_in (MSB-first),
    # in pure u32 (jax x64 is off): hi = bits [0,32), lo = [32,64)
    end_in = s_in + lv
    hi = jnp.where(end_in <= 32,
                   cv << jnp.clip(32 - end_in, 0, 31).astype(jnp.uint32),
                   cv >> jnp.clip(end_in - 32, 0, 31).astype(jnp.uint32))
    lo = jnp.where(end_in <= 32, jnp.uint32(0),
                   cv << jnp.clip(64 - end_in, 0, 31).astype(jnp.uint32))
    # accumulate into (B, G, 33) slot words with two scatter-adds (one
    # for each code's hi/lo word).  Codes' bit ranges never overlap, so
    # integer add == or, carry-free — int32 scatter-add is exact
    # (bitcast from u32; wraparound identical)
    bi = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    gi = jnp.arange(G, dtype=jnp.int32)[None, :, None]
    slots = jnp.zeros((B, G, _SLOT_WORDS + 1), jnp.int32)
    slots = slots.at[bi, gi, widx].add(
        jax.lax.bitcast_convert_type(hi, jnp.int32))
    slots = slots.at[bi, gi, widx + 1].add(
        jax.lax.bitcast_convert_type(lo, jnp.int32))
    slots = jax.lax.bitcast_convert_type(slots, jnp.uint32)

    # level 2: every group scatter-adds its <=34 shifted slot words
    # into the output at its word offset.  Slot bits beyond gbits are
    # zero by construction and group bit ranges are disjoint, so
    # integer add == or (scatter cost scales with G, not W).
    S = _SLOT_WORDS + 1
    gends = jnp.cumsum(gbits, axis=1) + start_bit[:, None]
    gstarts = gends - gbits
    total = gends[:, -1] if G > 0 else start_bit
    sh2 = (gstarts & 31).astype(jnp.uint32)[:, :, None]      # (B,G,1)
    wbase = (gstarts >> 5)[:, :, None]
    su = slots
    prevw = jnp.pad(su[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
    val = jnp.where(sh2 == 0, su,
                    (su >> sh2) | (prevw << ((32 - sh2) & 31)))
    # one spill word past the slot (bits pushed right by the shift)
    spill = jnp.where(sh2 == 0, jnp.uint32(0),
                      su[:, :, -1:] << ((32 - sh2) & 31))
    val = jnp.concatenate([val, spill], axis=2)              # (B,G,S+1)
    ji = jnp.arange(S + 1, dtype=jnp.int32)[None, None]
    # W (static) is the output word capacity per row; the caller knows
    # each row's exact payload bits before dispatch and falls back to
    # the host encoder when a row exceeds it, so invalid/overflow
    # contributions land in the W+1 dump slot and nothing real is
    # silently truncated.
    widx = jnp.where(gvalid[:, :, None], wbase + ji, W + 1)
    bi2 = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    out = jnp.zeros((B, W + 2), jnp.int32)
    out = out.at[bi2, jnp.minimum(widx, W + 1)].add(
        jax.lax.bitcast_convert_type(val, jnp.int32))
    words = jax.lax.bitcast_convert_type(
        jax.lax.slice_in_dim(out, 0, W, axis=1), jnp.uint32)
    wpos = (jnp.arange(W, dtype=jnp.int32) * 32)[None]
    words = jnp.where(wpos < total[:, None], words, 0)
    return words, total


import functools

pack_groups = jax.jit(_pack_groups, static_argnames=("W",))


def _chain_mtf2(bwt: jnp.ndarray, ns: jnp.ndarray, cmaps: jnp.ndarray):
    """chain_mtf + group_hist in one dispatch; the flat MTF histogram
    (host initial-tree input) is the group histogram's group-sum, so
    no separate histogram pass runs.
    Lanes >= as hold padding counts; the host only reads 0..as-1."""
    B, N = bwt.shape
    syms = _compact_syms(bwt, cmaps)
    ninuse = jnp.sum(cmaps.astype(jnp.int32), axis=1)
    ranks = _mtf_ranks_rows(syms, ns)
    mtfv, nm = _rle2_batch(ranks, ns, ninuse)
    hist_g, _, ngroups = _group_hist(mtfv, nm, ninuse)
    hist = jnp.sum(hist_g, axis=1).astype(jnp.int32)
    return mtfv, nm, hist, hist_g, ngroups


chain_mtf2 = jax.jit(_chain_mtf2)

# Flat-download chunking: the compacted payload comes down in fixed
# 2 MB chunks (ONE compiled shape regardless of batch fill), so the
# copy moves ceil(real_payload / 2 MB) chunks instead of a fixed
# worst-case array.  3.5M words = 14 MB remains the capacity bound
# (~3.9 bits/input byte on a full 32x900k batch).
FLAT_W = 3_500_032
FLAT_CHUNK = 524_288  # words = 2 MB per download chunk


@functools.partial(jax.jit, static_argnames=("F",))
def _flatten_words(words: jnp.ndarray, ends: jnp.ndarray, F: int,
                   base: jnp.ndarray | int = 0):
    """Compact per-row payload words into flat slots [base, base+F).

    ends: (B,) inclusive prefix sum of per-row word counts (int32).
    Flat slot f belongs to row r = searchsorted(ends, f, 'right') at
    word index f - start_r.  Downloading the compacted array moves
    only the real payload bytes instead of B * PACK_W.
    """
    B, W = words.shape
    f = jnp.arange(F, dtype=jnp.int32) + jnp.asarray(base, jnp.int32)
    r = jnp.searchsorted(ends, f, side="right").astype(jnp.int32)
    rc = jnp.minimum(r, B - 1)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), ends[:-1]])
    idx = jnp.clip(f - starts[rc], 0, W - 1)
    return jnp.where(r < B, words[rc, idx], 0)


def _flatten_download(words, ends_dev, needed: int):
    """Device-compact and download only ceil(needed/FLAT_CHUNK) fixed-
    size chunks; returns a host uint32 array of >= needed words."""
    import numpy as np
    nch = (needed + FLAT_CHUNK - 1) // FLAT_CHUNK
    chunks = [_flatten_words(words, ends_dev, FLAT_CHUNK,
                             i * FLAT_CHUNK) for i in range(nch)]
    for c in chunks:
        try:
            c.copy_to_host_async()
        except AttributeError:
            pass
    return np.concatenate([np.asarray(c) for c in chunks]) \
        if chunks else np.zeros(0, np.uint32)

# Default payload word capacity per row: 5.7 bits/symbol average.  The
# host knows each row's exact payload bits before dispatching the pack
# and falls back to the host encoder for rows that exceed this.
PACK_W = 160768
# Small pack variant: 80384 words = 321.5 KB/row (~2.9 bits per input
# byte at -9) covers typical text batches; rows needing more re-pack at
# full width via the two-shape dispatch in chain_payloads.
PACK_W_SMALL = 80384


def chain_payloads(bwt_dev, ns, cmaps, idxs, crcs,
                   cluster_factor: int = 8, pack_w: int = PACK_W,
                   _force_full_pack: bool = False,
                   times: dict | None = None,
                   mesh_axis=None):
    """Drive the full device entropy chain for one resolved BWT batch.

    bwt_dev: (B, N) uint8 device array of BWT rows; ns/idxs/crcs: (B,)
    host arrays; cmaps: (B, 256) uint8.  Returns a list of B payload
    byte strings (None for rows that exceeded pack_w — caller re-encodes
    those on the host).

    Device: MTF + RLE2 + EM E-steps + group bit-pack.  Host (C): EM
    M-steps, final code assignment, header build, stream splice.
    """
    import time as _time

    import numpy as np

    from lbzip2_tpu import native
    from lbzip2_tpu.ref.huffman import generate_initial_trees, num_trees_for

    _t = _time.time

    def _mark(key, t0):
        if times is not None:
            times[key] = round(_t() - t0, 3)
        return _t()

    t0 = _t()
    B, N = bwt_dev.shape
    if mesh_axis is not None:
        # sharded mode (multi-chip dryrun / pod): batch-major aux
        # arrays follow bwt_dev's block sharding so every chain stage
        # (chain_mtf2, em_chain, pack_groups) partitions per device
        from jax.sharding import NamedSharding, PartitionSpec
        mesh, axis = mesh_axis

        def _put(x):
            x = jnp.asarray(x)
            spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
    else:
        # aux uploads must land on bwt_dev's device (the engine round-
        # robins batches across all local devices)
        try:
            _dev = list(bwt_dev.devices())[0]
            if len(jax.local_devices()) == 1:
                _dev = None      # single device: default fast path
        except Exception:  # noqa: BLE001 — non-jax arrays in tests
            _dev = None

        def _put(x):
            return jax.device_put(x, _dev)

    ns = np.asarray(ns, np.int32)
    cmaps_u8 = np.ascontiguousarray(cmaps, np.uint8)
    ns_dev = _put(jnp.asarray(ns))
    cm_dev = _put(jnp.asarray(cmaps_u8))

    mtfv, nm, hist, hist_g, ngroups_dev = chain_mtf2(
        bwt_dev, ns_dev, cm_dev)
    t0 = _mark("dispatch_mtf", t0)
    nm_h = np.asarray(nm)
    hist_h = np.asarray(hist)
    t0 = _mark("wait_mtf", t0)  # blocks on BWT+MTF device kernels
    ninuse = cmaps_u8.sum(axis=1, dtype=np.int32)
    as_arr = ninuse + 2
    nt_arr = np.array([num_trees_for(int(v)) for v in nm_h], np.int32)
    ngroups = (nm_h + GROUP_SIZE - 1) // GROUP_SIZE

    # hist rows carry padding counts at lane `as` (group padding in
    # _group_hist); zero them so the initial-class split sees exactly
    # the spec's unpadded frequencies (nz_total / prefix sums)
    lane = np.arange(WIDTH, dtype=np.int32)[None]
    hist_h = np.where(lane < as_arr[:, None], hist_h, 0)
    lengths = np.ones((B, MAX_TREES, WIDTH), np.uint8)
    for b in range(B):
        lengths[b] = generate_initial_trees(
            hist_h[b].astype(np.int64), int(nm_h[b]), int(nt_arr[b]))
        lengths[b, :, as_arr[b]:] = 0

    ninuse_dev = _put(ninuse)
    nt_dev = _put(nt_arr)
    # group histogram once, then the WHOLE EM loop (E-steps, Huffman
    # refit M-steps, fixed-point cutoff) as one device program, with
    # no host round trip per iteration (ops/huffenc.py; bit-identical
    # to the native/huffman2.c M-step by differential test)
    from lbzip2_tpu.ops.huffenc import em_chain
    t0 = _mark("init_trees", t0)
    sel, freqs, lengths_dev, _ = em_chain(
        hist_g, ngroups_dev, nt_dev, _put(as_arr.astype(np.int32)),
        _put(lengths.astype(np.int32)), cluster_factor)
    t0 = _mark("dispatch_em", t0)
    freqs_h = np.asarray(freqs).astype(np.uint32)
    lengths = np.ascontiguousarray(
        np.asarray(lengths_dev), np.uint8).reshape(B, MAX_TREES, WIDTH)
    sel_h = np.asarray(sel.astype(jnp.uint8))
    t0 = _mark("wait_em", t0)  # blocks on the on-chip EM loop
    codes, hdr, hdr_bits, payload_bits = native.chain_finish(
        sel_h, ngroups, freqs_h, as_arr, nt_arr, cmaps_u8,
        np.asarray(idxs, np.int32), np.asarray(crcs, np.uint32), lengths)
    t0 = _mark("finish_c", t0)

    start_bit = (hdr_bits % 32).astype(np.int32)
    fits = (payload_bits + start_bit) <= 32 * pack_w
    # the pack's output-side work scales with the static word capacity;
    # typical text batches need < PACK_W_SMALL words/row, so pick the
    # small variant when every row fits (exactly two compiled shapes)
    need = np.where(fits, (payload_bits + start_bit + 31) // 32, 0)
    pw = PACK_W_SMALL if (B and need.max() <= PACK_W_SMALL and
                          pack_w == PACK_W and
                          not _force_full_pack) else pack_w
    fits = (payload_bits + start_bit) <= 32 * pw
    words, total = pack_groups(
        mtfv, nm, ninuse_dev, _put(ngroups.astype(np.int32)),
        sel, _put(codes), _put(lengths.astype(np.int32)),
        _put(start_bit), pw)
    t0 = _mark("dispatch_pack", t0)

    # download only the used words: device-side flat compaction at one
    # fixed shape (the full (B, pack_w) array is ~20 MB; real payloads
    # are ~8-11 MB)
    wcnt = np.where(fits, (payload_bits + start_bit + 31) // 32,
                    0).astype(np.int32)
    assert not B or wcnt.max() <= pw
    ends = np.cumsum(wcnt).astype(np.int32)
    if B and ends[-1] <= FLAT_W:
        flat_h = _flatten_download(words, _put(ends), int(ends[-1]))
        rows = [flat_h[(ends[b] - wcnt[b]):ends[b]] for b in range(B)]
    else:
        words_h = np.asarray(words)
        rows = [words_h[b, :wcnt[b]] for b in range(B)]
    t0 = _mark("wait_pack", t0)  # blocks on pack kernel + download

    out = []
    for b in range(B):
        if not fits[b]:
            out.append(None)
            continue
        hb = (int(hdr_bits[b]) + 7) // 8
        w0 = int(hdr_bits[b]) // 32
        total_bytes = (int(hdr_bits[b]) + int(payload_bits[b])) // 8
        buf = np.zeros(total_bytes, np.uint8)
        buf[:hb] = hdr[b, :hb]
        pb = rows[b].astype(">u4").view(np.uint8)
        buf[4 * w0:] |= pb[:total_bytes - 4 * w0]
        out.append(buf.tobytes())
    _mark("splice", t0)
    return out
