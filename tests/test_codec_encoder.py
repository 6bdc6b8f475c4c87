"""Production (device-path) compressor vs the oracle: bit-exactness."""

import bz2

import numpy as np
import pytest

from lbzip2_tpu.codec.encoder import compress as dev_compress
from lbzip2_tpu.ref.encoder import compress as ref_compress
from tests import corpus


@pytest.mark.parametrize("name", ["hello", "random", "small_alpha",
                                  "runs", "text"])
def test_device_pipeline_bit_exact(name):
    rng = np.random.default_rng(5)
    data = {
        "hello": b"hello, world\n",
        "random": rng.integers(0, 256, 30000, dtype=np.uint8).tobytes(),
        "small_alpha": rng.integers(0, 4, 60000, dtype=np.uint8).tobytes(),
        "runs": b"abc" * 10 + b"x" * 5000 + b"yz" * 700,
        "text": corpus.text(40_000, 5),
    }[name]
    out = dev_compress(data, 9)
    assert out == ref_compress(data, 9)
    assert bz2.decompress(out) == data


def test_device_pipeline_multiblock():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 16, 350000, dtype=np.uint8).tobytes()
    out = dev_compress(data, 1)
    assert out == ref_compress(data, 1)


def test_python_fallback_branch(monkeypatch):
    """Exercise the no-native (device MTF + oracle entropy) path."""
    from lbzip2_tpu import native as native_mod
    monkeypatch.setattr(native_mod, "native_available", lambda: False)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 5, 20000, dtype=np.uint8).tobytes()
    assert dev_compress(data, 9) == ref_compress(data, 9)
