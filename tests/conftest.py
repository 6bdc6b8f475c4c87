"""Test configuration.

JAX runs on a virtual 8-device CPU mesh unless JAX_PLATFORMS says
otherwise, so sharding/collective tests run hermetically and fast.
Tests marked `chip` need a GPU and skip without one; run them on the
card with:  JAX_PLATFORMS=cuda python -m pytest -m chip tests/
This must run before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_DIR = pathlib.Path("/root/reference")
REFERENCE_BIN = pathlib.Path("/tmp/refbuild/lbzip2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU (skips without one); run with "
        "JAX_PLATFORMS=cuda python -m pytest -m chip tests/")


@pytest.fixture()
def gpu():
    """The first GPU, or skip: decided when the test runs."""
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX found {d.platform}")
    return d


@pytest.fixture(scope="session")
def reference_corpus():
    """Paths of the reference's adversarial .bz2 corpus (read-only)."""
    d = REFERENCE_DIR / "tests"
    if not d.is_dir():
        pytest.skip("reference corpus not available")
    return sorted(d.glob("*.bz2"))


def pytest_sessionfinish(session, exitstatus):
    """Engine threads (lbz2-device / lbz2-fetch*) may still sit inside
    an XLA call when the last test finishes — by design they are
    abandonable daemons.  A daemon inside jax native code during
    interpreter teardown aborts the C++ runtime ("FATAL: exception not
    rethrown"), so give them a bounded join and hard-exit with the
    session status if any remain."""
    import os
    import sys
    import threading
    import time

    deadline = time.time() + 20
    for t in threading.enumerate():
        if t.name.startswith("lbz2-") and t is not threading.main_thread():
            t.join(timeout=max(0.0, deadline - time.time()))
    if any(t.name.startswith("lbz2-") and t.is_alive()
           for t in threading.enumerate()):
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(exitstatus))
