"""Real multi-process multihost tests: jax.distributed CPU processes.

Exercises compress_multihost with process_count() > 1:
  - 4 processes over the point-to-point gather-to-host-0 exchange
    (the production path: O(total payload) wire traffic)
  - 2 processes over the padded-allgather fallback
Both must reproduce the single-host stream byte-for-byte."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lbzip2_tpu import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs native kernels")

_WORKER = r"""
import os, sys
import numpy as np
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
nproc = int(sys.argv[4])
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=nproc,
                           process_id=int(sys.argv[2]))
assert jax.process_count() == nproc
from lbzip2_tpu.parallel import multihost as MH

rng = np.random.default_rng(7)
data = rng.integers(0, 24, 3 * 100000 + 1234, np.uint8).tobytes()
a, b = MH.shard_bounds(len(data), 1, nproc, int(sys.argv[2]))
out = MH.compress_multihost(data[a:b], level=1, n_workers=1)
if int(sys.argv[2]) == 0:
    assert out is not None
    open(sys.argv[3], "wb").write(out)
else:
    assert out is None
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_multihost(tmp_path, nproc, extra_env):
    addr = f"127.0.0.1:{_free_port()}"
    outfile = tmp_path / "mh.bz2"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no virtual-device forcing in workers
    env.update(extra_env)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, addr, str(i), str(outfile),
         str(nproc)],
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(nproc)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    # must equal the single-host stream byte-for-byte
    from lbzip2_tpu.parallel.encode import compress_parallel
    rng = np.random.default_rng(7)
    data = rng.integers(0, 24, 3 * 100000 + 1234, np.uint8).tobytes()
    assert outfile.read_bytes() == compress_parallel(data, 1)


def test_four_process_p2p(tmp_path):
    _run_multihost(tmp_path, 4, {
        "LBZ2_MULTIHOST_EXCHANGE": "p2p",
        "LBZ2_MULTIHOST_PORT": str(_free_port()),
    })


def test_two_process_allgather(tmp_path):
    _run_multihost(tmp_path, 2,
                   {"LBZ2_MULTIHOST_EXCHANGE": "allgather"})
