"""Sparse prefix-doubling BWT kernel vs the sequential oracle."""

import numpy as np
import pytest

from lbzip2_tpu.ref import bwt as ref_bwt
from tests import corpus


def _pad_batch(blocks, N):
    out = np.zeros((len(blocks), N), dtype=np.uint8)
    for i, b in enumerate(blocks):
        out[i, :b.size] = b
    return out


@pytest.mark.parametrize("seed,n,hi", [
    (0, 1, 256), (1, 2, 256), (2, 5, 256), (3, 100, 256),
    (4, 1000, 256), (5, 4096, 4), (6, 7777, 256), (7, 5000, 2),
    (8, 8192, 256),
])
def test_sparse_bwt_matches_oracle(seed, n, hi):
    from lbzip2_tpu.ops.bwt import bwt_batched_sparse
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, hi, n, dtype=np.uint8) for _ in range(3)]
    out, idx = bwt_batched_sparse(_pad_batch(blocks, 8192), n)
    for row, blk in enumerate(blocks):
        exp_out, exp_idx = ref_bwt.bwt(blk)
        np.testing.assert_array_equal(out[row, :n], exp_out)
        assert int(idx[row]) == exp_idx


def test_sparse_bwt_periodic_tie_break():
    # Fully periodic blocks exercise the k >= n descending-position
    # tie-break pass (true rotational equals).
    from lbzip2_tpu.ops.bwt import bwt_batched_sparse
    pat = np.frombuffer(b"abcabcabcabc" * 64, np.uint8)  # period 3
    n = pat.size
    out, idx = bwt_batched_sparse(_pad_batch([pat, pat], 1024), n)
    exp_out, exp_idx = ref_bwt.bwt(pat)
    np.testing.assert_array_equal(out[0, :n], exp_out)
    assert int(idx[0]) == exp_idx
    np.testing.assert_array_equal(out[1, :n], exp_out)


def test_sparse_bwt_mixed_lengths():
    # Per-row lengths in one batch (RLE1 blocks vary in size).
    from lbzip2_tpu.ops.bwt import bwt_batched_sparse
    rng = np.random.default_rng(21)
    ns = [8192, 4097, 1, 700]
    blocks = [rng.integers(0, 256, n, dtype=np.uint8) for n in ns]
    out, idx = bwt_batched_sparse(_pad_batch(blocks, 8192),
                                  np.asarray(ns, np.int32))
    for row, blk in enumerate(blocks):
        exp_out, exp_idx = ref_bwt.bwt(blk)
        np.testing.assert_array_equal(out[row, :blk.size], exp_out)
        assert int(idx[row]) == exp_idx


def test_sparse_bwt_text_block():
    from lbzip2_tpu.ops.bwt import bwt_batched_sparse
    blk = np.frombuffer(corpus.text(30000, 9), np.uint8)
    n = blk.size
    out, idx = bwt_batched_sparse(_pad_batch([blk], 32768), n)
    exp_out, exp_idx = ref_bwt.bwt(blk)
    np.testing.assert_array_equal(out[0, :n], exp_out)
    assert int(idx[0]) == exp_idx
