"""Hybrid device+host work pool: never-lose scheduling properties.

The reference's worst-case guarantee is that the parallel path never
loses to the sequential one (src/parse.c:56-69).  Here that maps to:
a wedged or slow device engine must never stall the stream — host
workers steal device-claimed blocks back, first result wins, and late
duplicates are dropped.
"""

import bz2
import importlib
import time

import numpy as np
import pytest

from lbzip2_tpu import native
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


@pytest.fixture()
def enc(monkeypatch):
    monkeypatch.setenv("LBZ2_DEVICE_BATCH", "4")
    from lbzip2_tpu.codec import encoder
    importlib.reload(encoder)
    yield encoder
    monkeypatch.delenv("LBZ2_DEVICE_BATCH")
    importlib.reload(encoder)


def _data(n=400_000, seed=1):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(97, 123, size=n, dtype=np.uint8))


def _small_buckets(enc):
    # level-1 blocks (~50-100k) become device-eligible on the CPU backend
    enc._BUCKETS = (8192, 131072)
    enc._MID_CUTOFF = 8192


def test_stealback_completes_wedged_device(enc):
    """A dispatch that never returns must not stall the stream; the
    host steals the claimed blocks back well before the watchdog."""
    _small_buckets(enc)
    from lbzip2_tpu.ops import bwt2

    def wedged(*a, **kw):
        time.sleep(3600)

    orig = bwt2.bwt2_tokens
    bwt2.bwt2_tokens = wedged
    try:
        data = _data()
        t0 = time.time()
        out = enc.compress(data, level=1)
        dt = time.time() - t0
        assert bz2.decompress(out) == data
        assert dt < 60, f"steal-back should beat the watchdog ({dt:.0f}s)"
        assert enc.last_stats["device_blocks"] == 0
    finally:
        bwt2.bwt2_tokens = orig


def test_device_pipeline_bit_exact_multibatch(enc, monkeypatch):
    """Multi-batch one-dispatch path (incl. end-of-stream drain): all
    blocks through the device, output bit-identical to the oracle."""
    _small_buckets(enc)
    monkeypatch.setattr(enc, "_HOST_STEAL", False)
    data = _data()
    out = enc.compress(data, level=1)
    from lbzip2_tpu.ref.encoder import compress as ref_compress
    assert out == ref_compress(data, level=1)
    s = enc.last_stats
    assert s["host_blocks"] == 0
    assert s["device_blocks"] >= 4  # several batches
    assert s["batch_trace"], "per-batch telemetry recorded"
    for t in s["batch_trace"]:
        assert {"prep_s", "dispatch_s", "ready_s", "done_t"} <= set(t)


def test_device_token_and_raw_paths(enc, monkeypatch):
    """Both fetch paths through the engine: text blocks download run
    tokens; high-entropy rows overflow the token capacity and fall
    back to per-row raw fetches.  Output bit-exact either way."""
    _small_buckets(enc)
    monkeypatch.setattr(enc, "_HOST_STEAL", False)
    rng = np.random.default_rng(7)
    text = corpus.text(200_000, 3)
    noise = rng.integers(0, 256, 200_000, np.uint8).tobytes()
    data = text[:200_000] + noise  # token rows + raw-overflow rows
    out = enc.compress(data, level=1)
    from lbzip2_tpu.ref.encoder import compress as ref_compress
    assert out == ref_compress(data, level=1)
    assert enc.last_stats["host_blocks"] == 0
    assert enc.last_stats["device_blocks"] >= 4


def test_contended_first_result_wins(enc):
    """Both engines race for the same queue; duplicates are dropped and
    the stream is still bit-exact."""
    _small_buckets(enc)
    data = _data(n=800_000, seed=3)
    out = enc.compress(data, level=1)
    from lbzip2_tpu.ref.encoder import compress as ref_compress
    assert out == ref_compress(data, level=1)
    s = enc.last_stats
    n_blocks = s["device_blocks"] + s["host_blocks"] + s["stale_rows"]
    assert n_blocks >= s["device_blocks"]  # accounting sane


def test_task_priority_order(enc):
    """Explicit scheduling policy under contention (reference spec:
    ordered task table src/process.c:422-435): entropy work beats tail
    stealing, and within entropy the smallest block id (EDF) pops
    first — even when queued out of order."""
    pool = enc._WorkPool(np.zeros(1, np.uint8), list(range(8)), 8, 0,
                         True)
    # tail blocks available AND entropy queued out of order
    pool.entropy_q.put((5, None, None, -1))
    pool.entropy_q.put((2, None, None, -1))
    pool.entropy_q.put((7, None, None, -1))
    kinds = [pool._next_task() for _ in range(5)]
    assert [k for k, _ in kinds[:3]] == ["entropy"] * 3
    assert [item[0] for _, item in kinds[:3]] == [2, 5, 7]  # EDF
    assert kinds[3][0] == "steal"  # only then the tail
    assert kinds[3][1] == 7  # tail steals youngest block first
    # duplicate ids must not break the heap (span objects are not
    # comparable; arrival order breaks the tie)
    pool.entropy_q.put((3, object(), None, -1))
    pool.entropy_q.put((3, object(), None, -1))
    a = pool.entropy_q.get(block=False)
    b = pool.entropy_q.get(block=False)
    assert a[0] == b[0] == 3


def test_late_duplicate_dropped(enc):
    """put_result drops results for blocks already delivered."""
    pool = enc._WorkPool(np.zeros(1, np.uint8), [], 8, 0, False)
    pool.put_result(0, (b"a", 1))
    with pool.res_cv:
        pool.next_deliver = 1
        pool.results.pop(0)
    pool.put_result(0, (b"b", 2))  # stale: already delivered
    assert 0 not in pool.results
    pool.put_result(1, (b"c", 3))
    pool.put_result(1, (b"d", 4))  # duplicate: first wins
    assert pool.results[1] == (b"c", 3)
