"""Device BWT v2 (Lyndon + suffix doubling) vs the host oracle."""
import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ops import bwt2
from lbzip2_tpu.ref.bwt import bwt as ref_bwt
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native lyndon_prep")


def _mk_batch(blocks):
    N = 1
    while N < max(b.size for b in blocks) or N % 8:
        N = max(N * 2, 8)
    B = len(blocks)
    rot = np.zeros((B, N), np.uint8)
    ns = np.empty(B, np.int32)
    ms = np.empty(B, np.int32)
    for i, b in enumerate(blocks):
        r, m = native.lyndon_prep(b)
        assert m >= 0, "periodic test block"
        rot[i, :b.size] = r
        ns[i] = b.size
        ms[i] = m
    return rot, ns, ms


def _check(blocks):
    rot, ns, ms = _mk_batch(blocks)
    out, primary = bwt2.bwt2_batch(rot, ns, ms)
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        np.testing.assert_array_equal(out[i, :b.size], exp_bwt)
        assert int(primary[i]) == exp_idx, f"row {i}"


def test_bwt2_random_mixed_lengths():
    rng = np.random.default_rng(0)
    blocks = [rng.integers(0, 256, n, np.uint8)
              for n in (1, 2, 3, 7, 8, 9, 100, 1000, 4096, 5000)]
    _check(blocks)


def test_bwt2_small_alphabet():
    rng = np.random.default_rng(1)
    blocks = [rng.integers(97, 99, n, np.uint8)
              for n in (50, 333, 2048, 6000)]
    _check(blocks)


def test_bwt2_deep_repeats():
    rng = np.random.default_rng(2)
    page = rng.integers(0, 256, 256, np.uint8)
    b = np.tile(page, 20).copy()
    b[-1] ^= 1  # keep primitive
    text = np.frombuffer(
        corpus.text(5000, 2),
        np.uint8).copy()
    _check([b, text])


def test_bwt2_runs():
    blocks = [np.array([7] * 499 + [9], np.uint8),
              np.array([255] * 100 + [0] * 100 + [255], np.uint8)]
    _check(blocks)


def test_bwt2_invert_scatter_matches():
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 4, 3000, np.uint8)]
    old = bwt2.INVERT
    try:
        bwt2.INVERT = "scatter"
        _check(blocks)
    finally:
        bwt2.INVERT = old


def test_bwt2_task_stepping():
    rng = np.random.default_rng(4)
    blocks = [rng.integers(0, 8, 7000, np.uint8) for _ in range(3)]
    rot, ns, ms = _mk_batch(blocks)
    t = bwt2.Bwt2Task(rot, ns, ms)
    steps = 0
    while not t.step():
        steps += 1
        assert steps < 64
    rows, primary = t.result()
    for i, b in enumerate(blocks):
        exp_bwt, exp_idx = ref_bwt(b)
        np.testing.assert_array_equal(rows[i][:b.size], exp_bwt)
        assert int(primary[i]) == exp_idx
