"""Production encoder with the device entropy chain enabled.

LBZ2_DEVICE_CHAIN=1 routes device-bucket blocks through ops/chain.py
(device MTF+RLE2+EM+pack, host M-step/header); the stream must stay
bit-identical to the in-repo oracle encoder (ref.encoder).
"""

import importlib

import numpy as np
import pytest

from lbzip2_tpu import native
from lbzip2_tpu.ref.encoder import compress as ref_compress
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

@pytest.fixture()
def chain_encoder(monkeypatch):
    monkeypatch.setenv("LBZ2_DEVICE_CHAIN", "1")
    monkeypatch.setenv("LBZ2_HOST_STEAL", "0")
    from lbzip2_tpu.codec import encoder
    importlib.reload(encoder)
    yield encoder
    monkeypatch.delenv("LBZ2_DEVICE_CHAIN")
    monkeypatch.delenv("LBZ2_HOST_STEAL")
    importlib.reload(encoder)


def _ref(data, level):
    return ref_compress(data, level)


def test_chain_block_bit_exact(chain_encoder):
    data = corpus.text(7800, 6)
    out = chain_encoder.compress(data, 9)
    assert out == _ref(data, 9)
    assert chain_encoder.last_stats["device_blocks"] == 1


def test_chain_multi_block_batch(chain_encoder):
    # several <=8k blocks via tiny level-1 windows of a crafted stream
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(48, 58, 6000, dtype=np.uint8))
    out = chain_encoder.compress(data, 9)
    assert out == _ref(data, 9)


def test_chain_narrow_alphabet(chain_encoder):
    data = bytes(np.repeat(np.frombuffer(b"abcd", np.uint8), 500))
    out = chain_encoder.compress(data, 9)
    assert out == _ref(data, 9)
