"""Device Huffman decode (parallel group extraction) vs host retrieve.

decode_block_device must produce the identical BWT bytes/index/flags
as native.retrieve_block on real streams (reference behavior:
src/decode.c:519-798).
"""

import bz2

import numpy as np
import pytest

from lbzip2_tpu import native
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


def _first_block(stream: bytes):
    """(arr, nbits, payload_pos) of the stream's first block."""
    arr = np.frombuffer(stream, np.uint8)
    return arr, arr.size * 8, 32 + 48 + 32  # header+magic+crc


def _check(data: bytes, level: int = 9):
    from lbzip2_tpu.ops.huffdec import decode_block_device

    stream = bz2.compress(data, level)
    arr, nbits, pos = _first_block(stream)
    e1, p1, bwt1, idx1, r1 = native.retrieve_block(arr, nbits, pos)
    e2, p2, bwt2, idx2, r2 = decode_block_device(arr, nbits, pos)
    assert (e1, p1, idx1, r1) == (e2, p2, idx2, r2)
    assert np.array_equal(bwt1, bwt2)


def test_text_block():
    _check(corpus.text(60_000, 4))


def test_narrow_alphabet():
    rng = np.random.default_rng(0)
    _check(bytes(rng.integers(97, 101, 50000, dtype=np.uint8)))


def test_long_codes():
    # skewed frequencies force deep codes and the >10-bit slow path
    rng = np.random.default_rng(1)
    vals = np.where(rng.random(80000) < 0.995, 120,
                    rng.integers(0, 256, 80000)).astype(np.uint8)
    _check(bytes(vals))


def test_runs_and_multi_tree():
    rng = np.random.default_rng(2)
    data = np.repeat(rng.integers(0, 256, 4000, dtype=np.uint8),
                     rng.integers(1, 40, 4000))
    _check(bytes(data))


def test_tiny_block():
    _check(b"abracadabra")


def test_adversarial_corpus_blocks():
    """First blocks of the reference corpus's valid streams."""
    import glob
    import subprocess
    from lbzip2_tpu.ops.huffdec import decode_block_device

    for f in sorted(glob.glob("/root/reference/tests/*.bz2")):
        blob = open(f, "rb").read()
        if len(blob) < 12 or blob[:3] != b"BZh":
            continue
        arr, nbits, pos = _first_block(blob)
        e1, p1, bwt1, idx1, r1 = native.retrieve_block(arr, nbits, pos)
        e2, p2, bwt2, idx2, r2 = decode_block_device(arr, nbits, pos)
        assert e1 == e2, f
        if e1 == 0:
            assert (p1, idx1, r1) == (p2, idx2, r2), f
            assert np.array_equal(bwt1, bwt2), f
