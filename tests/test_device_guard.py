"""The device engine never runs quietly on XLA:CPU or without its C
host kernels: it raises instead."""

import pytest

from lbzip2_tpu import native
from lbzip2_tpu.codec import encoder


def test_refuses_cpu_backend_without_explicit_platform(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(RuntimeError, match="no accelerator"):
        encoder.compress(b"hello, world\n", 9, use_device=True)
    with pytest.raises(RuntimeError, match="no accelerator"):
        encoder.warm_device(rows=(8,), bucket=8192)


def test_explicit_cpu_platform_allowed(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    encoder.check_device_backend()


def test_host_engine_needs_no_accelerator(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    import bz2
    out = encoder.compress(b"abc" * 1000, 9, use_device=False)
    assert bz2.decompress(out) == b"abc" * 1000


def test_device_engine_needs_c_kernels(monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="C host kernels"):
        encoder.compress(b"hello", 9, use_device=True)


def test_cli_device_engine_raises_without_c_kernels(monkeypatch, tmp_path):
    from lbzip2_tpu import cli
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setenv("LBZIP2_TPU_ENGINE", "device")
    with pytest.raises(RuntimeError, match="C host kernels"):
        cli._engine_compress(b"hello", cli.Options())
