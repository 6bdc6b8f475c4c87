"""Signal-subsystem parity with the reference (src/signals.c).

SIGPIPE and SIGXFSZ are blocked process-wide so EPIPE/EFBIG surface as
write errors; the failure path prints nothing for them, removes any
partial output, and then dies BY the promoted signal — callers observe
death-by-SIGPIPE/SIGXFSZ exactly as with the reference binary.
SIGINT/SIGTERM clean up and re-raise (death by signal)."""

import os
import resource
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from lbzip2_tpu import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native kernels")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_env():
    env = dict(os.environ)
    env["LBZ2_DEVICE"] = "0"  # host-only: no accelerator needed
    return env


def test_epipe_dies_by_sigpipe(tmp_path):
    """Closing the read end of stdout mid-write must kill the CLI with
    SIGPIPE (not a traceback), silently, like the reference binary."""
    f = tmp_path / "in.bin"
    rng = np.random.default_rng(0)
    f.write_bytes(rng.integers(0, 256, 2_000_000, np.uint8).tobytes())
    p = subprocess.Popen(
        [sys.executable, "-m", "lbzip2_tpu.cli", "-1", "-c", str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=_cli_env())
    p.stdout.read(1024)  # ensure the writer is alive and producing
    p.stdout.close()     # reader goes away -> EPIPE in the writer
    _, err = p.communicate(timeout=120)
    assert p.returncode == -signal.SIGPIPE, (p.returncode, err[-500:])
    assert err == b"", err[-500:]


def test_efbig_dies_by_sigxfsz_and_unlinks(tmp_path):
    """RLIMIT_FSIZE overflow on the output file: silent death by
    SIGXFSZ with the partial output removed (reference cleanup())."""
    f = tmp_path / "in.bin"
    rng = np.random.default_rng(1)
    f.write_bytes(rng.integers(0, 256, 400_000, np.uint8).tobytes())

    def limit_fsize():
        resource.setrlimit(resource.RLIMIT_FSIZE, (65536, 65536))

    p = subprocess.Popen(
        [sys.executable, "-m", "lbzip2_tpu.cli", "-1", "-k", str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=_cli_env(), preexec_fn=limit_fsize)
    _, err = p.communicate(timeout=120)
    assert p.returncode == -signal.SIGXFSZ, (p.returncode, err[-500:])
    assert err == b"", err[-500:]
    assert not (tmp_path / "in.bin.bz2").exists(), "partial output kept"
    assert f.exists(), "input must never be unlinked on failure"


def test_sigterm_dies_by_signal_and_unlinks(tmp_path):
    """SIGTERM mid-compress: partial output removed, death by signal
    (re-raise, reference terminate())."""
    f = tmp_path / "in.bin"
    rng = np.random.default_rng(2)
    f.write_bytes(rng.integers(0, 256, 30_000_000, np.uint8).tobytes())
    p = subprocess.Popen(
        [sys.executable, "-m", "lbzip2_tpu.cli", "-9", "-k", str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=_cli_env())
    # wait for the output file to appear (work started), then interrupt
    out = tmp_path / "in.bin.bz2"
    deadline = time.time() + 60
    while not out.exists() and time.time() < deadline:
        time.sleep(0.05)
        assert p.poll() is None, p.communicate()[1][-500:]
    p.send_signal(signal.SIGTERM)
    p.communicate(timeout=120)
    assert p.returncode == -signal.SIGTERM
    assert not out.exists(), "partial output kept after SIGTERM"
    assert f.exists()
