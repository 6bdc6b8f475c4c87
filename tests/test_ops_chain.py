"""Device encode chain vs the native C encoder, payload-byte exact.

The chain (ops/chain.py) must reproduce native.encode_payload exactly:
same EM trajectory (10-bit-lane carry semantics), same final codes,
same header padding quirk, same packed bits.  Reference behavior being
reproduced: src/encode.c:361-425, 1005-1281.
"""

import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ref.rle1 import transform_span
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


def _mk_blocks(specs, N):
    """specs: list of (n, kind) -> (bwt batch, ns, cmaps, idxs, crcs)."""
    B = len(specs)
    bwts = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    cmaps = np.zeros((B, 256), np.uint8)
    idxs = np.zeros(B, np.int32)
    crcs = np.zeros(B, np.uint32)
    blocks = []
    rng = np.random.default_rng(7)
    for i, (n, kind) in enumerate(specs):
        if kind == "text":
            raw = np.frombuffer(corpus.text(n, 8), np.uint8)
        elif kind == "narrow":
            raw = rng.integers(0, 4, n, dtype=np.uint8)
        elif kind == "runs":
            raw = np.repeat(rng.integers(0, 255, n // 60 + 1,
                                         dtype=np.uint8), 60)[:n]
        elif kind == "binary":
            # heavily skewed 2-symbol source: tiny alphabet, mostly
            # RUNA/RUNB symbols, nm % 50 != 0 padding lanes
            raw = np.where(rng.random(n) < 0.93, 65, 66).astype(np.uint8)
        elif kind == "skew3":
            raw = rng.choice(np.array([10, 10, 10, 10, 10, 10, 200, 201],
                                      np.uint8), n).astype(np.uint8)
        else:  # random
            raw = rng.integers(0, 256, n, dtype=np.uint8)
        blk, cmap = transform_span(raw)
        brow, bidx = native.bwt(blk)
        bwts[i, :blk.size] = brow
        ns[i] = blk.size
        cmaps[i] = np.asarray(cmap, np.uint8)
        idxs[i] = bidx
        crcs[i] = (native.crc32_block(raw) ^ 0xFFFFFFFF) & 0xFFFFFFFF
        blocks.append(blk)
    return bwts, ns, cmaps, idxs, crcs, blocks


def _check(specs, N=16384):
    import jax.numpy as jnp

    from lbzip2_tpu.ops.chain import chain_payloads

    bwts, ns, cmaps, idxs, crcs, blocks = _mk_blocks(specs, N)
    got = chain_payloads(jnp.asarray(bwts), ns, cmaps, idxs, crcs)
    for i in range(len(specs)):
        want = native.encode_payload(bwts[i, :ns[i]], cmaps[i],
                                     int(idxs[i]), int(crcs[i]), 8)
        assert got[i] is not None
        assert got[i] == want, \
            f"row {i} ({specs[i]}): {len(got[i])}B vs {len(want)}B"


def test_text_blocks():
    _check([(12000, "text"), (9000, "text"), (15999, "text")])


def test_mixed_content():
    _check([(8000, "narrow"), (8000, "random"), (8000, "runs"),
            (5000, "text")])


def test_tiny_blocks():
    # 1-2 trees, dummy-tree path, tiny group counts
    _check([(30, "text"), (120, "narrow"), (600, "runs"),
            (2, "random")])


def test_single_row():
    _check([(10000, "text")])


def test_low_diversity_padding_lane():
    """Regression (round-4 advisor, high): the fused chain_mtf2 flat
    histogram carries group-padding counts at lane `as`; feeding it to
    generate_initial_trees unzeroed shifted the initial-class split on
    low-diversity blocks, breaking device/host bit-identity.  Sizes
    chosen so nm % 50 != 0 across tree counts 2..6."""
    _check([(4000, "binary"), (7001, "binary"), (12345, "binary"),
            (6000, "skew3"), (9013, "skew3"), (15997, "binary")])


def test_padding_lane_em_divergence():
    """Regression (round-4 advisor, high), exact repro: a crafted BWT
    row with a late-heavy MTF histogram (ninuse=6, counts
    {2:842, 3:183, 4:421, 5:1437, 6:758}) where the padding-polluted
    initial-class split survives all 8 EM iterations and the device
    chain emitted a 1028-byte payload vs the host C encoder's 1023.
    Fuzz-found; any row shuffle of the same rank multiset may wash out
    through EM, so the exact row is pinned as test data."""
    import os

    import jax.numpy as jnp

    from lbzip2_tpu.ops.chain import chain_payloads

    row = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "chain_padding_trigger.npy"))
    n = row.size
    rows = np.zeros((1, 8192), np.uint8)
    rows[0, :n] = row
    cmaps = np.zeros((1, 256), np.uint8)
    cmaps[0, :6] = 1
    got = chain_payloads(jnp.asarray(rows), np.array([n], np.int32),
                         cmaps, np.array([3], np.int32),
                         np.array([0xABCD1234], np.uint32))
    want = native.encode_payload(row, cmaps[0], 3, 0xABCD1234, 8)
    assert got[0] == want, f"{len(got[0])}B vs {len(want)}B"


def test_pack_overflow_fallback():
    """Random bytes at high entropy exceed a tiny pack_w -> None."""
    import jax.numpy as jnp

    from lbzip2_tpu.ops.chain import chain_payloads

    bwts, ns, cmaps, idxs, crcs, _ = _mk_blocks([(8000, "random")], 16384)
    got = chain_payloads(jnp.asarray(bwts), ns, cmaps, idxs, crcs,
                         pack_w=64)
    assert got[0] is None
