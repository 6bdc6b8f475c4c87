"""Device Huffman code-length kernel + fused device EM loop.

Moves the EM maximization step (per-tree Huffman refit) onto the device
so the whole cluster_factor EM loop runs as ONE device program: the
refit itself is tiny, but on the host it forced a device->host freqs
download and host->device lengths upload every iteration (reference
hot path: src/encode.c:714-766 make_code_lengths inside the
:1044-1084 EM loop).

Bit-exactness contract (same as native/huffman2.c, which remains the
differential oracle): node order is the lexicographic key
(freq, height, nleaf mod 256, tag) with tag = MAX_ALPHA - symbol for
leaves and the j-th merge carrying the tag of the j-th smallest leaf;
lengths come from the two-queue procedure preferring leaves on ties,
re-assigned by rank profile (d-th smallest leaf gets the d-th largest
depth).

The construction is sequential over <= as-1 merge steps, but every
step is O(1), so it vectorizes across the B*MAX_TREES rows of a batch:
one fori_loop whose body does a handful of (R,)-shaped gathers and
masked scatters.  Keys carry as two int32 planes (f, t=h<<17|nl<<9|tag)
compared lexicographically — a packed u64 would need x64 mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lbzip2_tpu.core.constants import MAX_ALPHA_SIZE, MAX_TREES

MAX_ALPHA = 258
W = MAX_ALPHA_SIZE + 1          # 259 lanes (symbols 0..257 + dummy)
_NLEAF = MAX_ALPHA              # max leaves per tree (as <= 258)
_NMERGE = _NLEAF - 1
_HLIM = 30                      # MAX_HUFF_LEN2 profile clamp
_INF32 = jnp.int32(0x7FFFFFFF)


def _lt(fa, ta, fb, tb):
    """Lexicographic (f, t) <."""
    return (fa < fb) | ((fa == fb) & (ta < tb))


def _le(fa, ta, fb, tb):
    return ~_lt(fb, tb, fa, ta)


def _make_code_lengths_rows(freqs: jnp.ndarray, as_arr: jnp.ndarray):
    """Batched make_code_lengths2: freqs (R, W) int32, as_arr (R,).

    Returns lengths (R, W) int32 with symbols >= as zeroed.  Exact
    tie-break parity with native/huffman2.c make_code_lengths2.
    """
    R = freqs.shape[0]
    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]        # (1, W)
    live = lanes < as_arr[:, None]                          # (R, W)
    f = jnp.where(live, jnp.maximum(freqs, 1), 0)
    tag = MAX_ALPHA - lanes                                 # (1, W) bcast

    # ascending sort by (f, tag): f < 2^20, tag < 2^9 -> one int32 key
    key = jnp.where(live, (f << 9) | jnp.broadcast_to(tag, f.shape),
                    _INF32)
    skey = jax.lax.sort(key, dimension=1)                   # (R, W)
    lf = jnp.where(skey == _INF32, _INF32, skey >> 9)       # leaf freqs
    ltag = jnp.where(skey == _INF32, 0, skey & 511)         # leaf tags
    # leaf node planes: t = 0<<17 | 1<<9 | tag
    lt_ = jnp.where(skey == _INF32, _INF32, (1 << 9) | ltag)

    # node storage: slots 0.._NLEAF-1 = sorted leaves (padded +inf),
    # slots _NLEAF.. = merges in creation order
    NN = _NLEAF + _NMERGE
    nf = jnp.full((R, NN), _INF32, jnp.int32)
    nt_ = jnp.full((R, NN), _INF32, jnp.int32)
    nf = nf.at[:, :W].set(lf[:, :W])
    nt_ = nt_.at[:, :W].set(lt_[:, :W])
    child0 = jnp.zeros((R, _NMERGE), jnp.int32)
    child1 = jnp.zeros((R, _NMERGE), jnp.int32)

    rows = jnp.arange(R, dtype=jnp.int32)
    nmerge = jnp.maximum(as_arr - 1, 0)                     # (R,)

    def merge_step(s, carry):
        nf, nt_, child0, child1, li, ii = carry
        act = s <= nmerge                                   # 1-based step
        g = lambda arr, idx: arr[rows, idx]                 # noqa: E731
        lf0, lt0 = g(nf, li), g(nt_, li)
        lf1, lt1 = g(nf, jnp.minimum(li + 1, NN - 1)), \
            g(nt_, jnp.minimum(li + 1, NN - 1))
        if0, it0 = g(nf, _NLEAF + ii), g(nt_, _NLEAF + ii)
        if1, it1 = g(nf, jnp.minimum(_NLEAF + ii + 1, NN - 1)), \
            g(nt_, jnp.minimum(_NLEAF + ii + 1, NN - 1))
        nleaf = as_arr - li
        nint = (s - 1) - ii                                 # merges so far
        # decision table (huff_pick_pair): ties prefer leaves
        pick_ii = (nleaf == 0) | ((nint >= 2) & _lt(if1, it1, lf0, lt0))
        pick_ll = ~pick_ii & ((nint == 0) |
                              ((nleaf >= 2) & _le(lf1, lt1, if0, it0)))
        pick_il = ~pick_ii & ~pick_ll
        c0 = jnp.where(pick_ll, li, _NLEAF + ii)
        c1 = jnp.where(pick_ii, _NLEAF + ii + 1,
                       jnp.where(pick_il, li, li + 1))
        li_n = jnp.where(act, li + jnp.where(pick_ii, 0,
                                             jnp.where(pick_ll, 2, 1)),
                         li)
        ii_n = jnp.where(act, ii + jnp.where(pick_ii, 2,
                                             jnp.where(pick_ll, 0, 1)),
                         ii)
        # merged node key
        f0, t0 = g(nf, c0), g(nt_, c0)
        f1, t1 = g(nf, c1), g(nt_, c1)
        h0, h1 = t0 >> 17, t1 >> 17
        nl0, nl1 = (t0 >> 9) & 255, (t1 >> 9) & 255
        mtag = g(jnp.broadcast_to(ltag, (R, W)),
                 jnp.minimum(s - 1, W - 1))    # tag of (s)-th smallest
        mf = f0 + f1
        mt = ((jnp.maximum(h0, h1) + 1) << 17) | \
             (((nl0 + nl1) & 255) << 9) | mtag
        slot = _NLEAF + (s - 1)
        nf = nf.at[rows, slot].set(jnp.where(act, mf, g(nf, slot)))
        nt_ = nt_.at[rows, slot].set(jnp.where(act, mt, g(nt_, slot)))
        child0 = child0.at[rows, s - 1].set(
            jnp.where(act, c0, child0[rows, s - 1]))
        child1 = child1.at[rows, s - 1].set(
            jnp.where(act, c1, child1[rows, s - 1]))
        return nf, nt_, child0, child1, li_n, ii_n

    li0 = jnp.zeros((R,), jnp.int32)
    ii0 = jnp.zeros((R,), jnp.int32)
    nf, nt_, child0, child1, _, _ = jax.lax.fori_loop(
        1, _NMERGE + 1, merge_step,
        (nf, nt_, child0, child1, li0, ii0))

    # top-down depth propagation: merge ids descend from root
    # (children of merge j have id < _NLEAF + j, so a reverse sweep
    # resolves all depths in one pass)
    depth = jnp.zeros((R, NN), jnp.int32)

    def depth_step(k, depth):
        j = _NMERGE - 1 - k                                 # merge id
        act = j <= nmerge - 1
        j_ = jnp.maximum(j, 0)
        d = depth[rows, _NLEAF + j_] + 1
        c0 = child0[rows, j_]
        c1 = child1[rows, j_]
        # root (j == nmerge-1) keeps depth 0; others were set by parent
        d = jnp.where(act, d, 0)
        depth = depth.at[rows, c0].set(
            jnp.where(act, d, depth[rows, c0]))
        depth = depth.at[rows, c1].set(
            jnp.where(act, d, depth[rows, c1]))
        return depth

    depth = jax.lax.fori_loop(0, _NMERGE, depth_step, depth)

    # leaf depths by rank, clamped; rank profile: ascending rank gets
    # descending depth (sort depths of live ranks descending)
    ldep = jnp.minimum(depth[:, :W], _HLIM)
    liver = lanes < as_arr[:, None]
    ldep = jnp.where(liver, ldep, -1)
    sdep = -jax.lax.sort(-ldep, dimension=1)               # descending
    # scatter: symbol = MAX_ALPHA - ltag[rank]
    sym = jnp.where(liver, MAX_ALPHA - ltag, W - 1)
    out = jnp.zeros((R, W), jnp.int32)
    out = out.at[rows[:, None], sym].set(jnp.where(liver, sdep, 0),
                                         mode="drop")
    # lane W-1 may have been hit by padding scatters; recompute it
    # honestly: symbol W-1 (=258) is never a real symbol (as <= 258)
    out = out.at[:, W - 1].set(0)
    return out


make_code_lengths_rows = jax.jit(_make_code_lengths_rows)


# ---------------------------------------------------------------------------
# fused EM loop (E-steps + M-steps + fixed-point cutoff on device)
# ---------------------------------------------------------------------------


def _em_chain(hist_g: jnp.ndarray, ngroups: jnp.ndarray,
              nt: jnp.ndarray, as_arr: jnp.ndarray,
              lengths0: jnp.ndarray, cluster_factor: int):
    """Run the full EM loop on device.

    hist_g: (B, G, W) f32 per-group histograms (from chain.group_hist);
    ngroups/nt/as_arr: (B,) int32; lengths0: (B, MAX_TREES, W) int32
    initial class lengths.  Returns (selectors (B, G) int32, freqs
    (B, MAX_TREES, W) int32, lengths (B, MAX_TREES, W) int32 = the
    input of the last executed E-step, iters int32).

    Loop semantics mirror native/entropy.c: E-step, break if selectors
    reproduce the previous iteration (the already-applied M-step's
    lengths are then final), else M-step unless this was the last
    iteration.
    """
    from lbzip2_tpu.ops.chain import _em_estep_hist

    B, G, _ = hist_g.shape
    R = B * MAX_TREES
    as_rows = jnp.repeat(as_arr, MAX_TREES)
    tree_live = (jnp.arange(MAX_TREES, dtype=jnp.int32)[None, :] <
                 nt[:, None])                                # (B, T)

    def mstep(freqs, lengths):
        rows = freqs.reshape(R, W)
        new = _make_code_lengths_rows(rows, as_rows).reshape(
            B, MAX_TREES, W)
        # trees >= nt keep their previous lengths (C updates t < nt)
        return jnp.where(tree_live[:, :, None], new, lengths)

    def body(carry):
        it, lengths, prev_sel, _, _, _ = carry
        sel, freqs = _em_estep_hist(hist_g, ngroups, nt, lengths)
        conv = (it > 0) & jnp.all(sel == prev_sel)
        last = it >= cluster_factor - 1
        lengths_n = jax.lax.cond(conv | last,
                                 lambda: lengths,
                                 lambda: mstep(freqs, lengths))
        return (it + 1, lengths_n, sel, sel, freqs, conv)

    def cond(carry):
        it, _, _, _, _, conv = carry
        return (it < cluster_factor) & ~conv

    sel0 = jnp.full((B, G), -1, jnp.int32)
    freqs0 = jnp.zeros((B, MAX_TREES, W), jnp.int32)
    it, lengths, _, sel, freqs, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), lengths0, sel0, sel0, freqs0,
                     jnp.bool_(False)))
    return sel, freqs, lengths, it


em_chain = jax.jit(_em_chain, static_argnames=("cluster_factor",))
