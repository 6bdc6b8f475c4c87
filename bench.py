"""Compress and decompress throughput of the host and device engines.

Prints ONE JSON line: device-engine compress MB/s as the headline, with
host-only compress and decompress MB/s beside it, all on the host clock
end to end from the caller's side, and the device JAX found.  The
device leg needs an accelerator: without one (and without
JAX_PLATFORMS=cpu naming the CPU on purpose), or when it fails, the
bench raises instead of reporting host numbers alone.

Corpus: tests/corpus.mixed, seeded (text, binary, markup, noise in
4 KiB pages).  Every stream is validated with libbzip2.

Run:  python bench.py          (BENCH_SIZE bytes, default 1120 x 900000)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import bz2

    from tests import corpus

    # ~1 GB: the stream must outlast the device pipeline's fill latency
    # by a wide margin, or the hybrid engine measures as its own warmup
    size = int(os.environ.get("BENCH_SIZE", str(1120 * 900000)))
    level = 9
    data = corpus.mixed(size, 0)

    # Host-only pipeline (C two-stage BWT + entropy threads), min of 3.
    from lbzip2_tpu.parallel.encode import compress_parallel
    _ = compress_parallel(data[:900000], level)
    host_dt = None
    for _rep in range(3):
        t0 = time.time()
        out = compress_parallel(data, level)
        dt = time.time() - t0
        host_dt = dt if host_dt is None else min(host_dt, dt)
    assert bz2.decompress(out) == data, "host output failed validation"
    host_mbps = len(data) / host_dt / 1e6

    # Decompress leg, measured before anything touches jax.
    from lbzip2_tpu.parallel.decode import decompress_parallel
    dec_dt = None
    for _rep in range(2):
        t0 = time.time()
        rt = decompress_parallel(out)
        dt = time.time() - t0
        dec_dt = dt if dec_dt is None else min(dec_dt, dt)
    assert rt == data, "decompress round-trip failed"
    dec_mbps = len(data) / dec_dt / 1e6

    # Hybrid device+host pipeline.  warm_device compiles every shape the
    # timed run needs outside the timed window; a small end-to-end warm
    # run follows, and the device drains before the timed stream.
    import jax

    from lbzip2_tpu.codec import encoder
    warm_s = encoder.warm_device()
    _ = encoder.compress(data[:56 * 900000], level)
    encoder._chip_wait_idle(timeout_s=180.0, max_inflight=0)
    t0 = time.time()
    dev_out = encoder.compress(data, level)
    dev_dt = time.time() - t0
    assert dev_out == out, "device-engine stream differs from host-only"
    dev_mbps = len(data) / dev_dt / 1e6
    dev_stats = dict(encoder.last_stats)

    # Telemetry goes to a side file; the headline line stays small.
    with open("bench_telemetry.json", "w") as fh:
        json.dump({"device_stats": dev_stats, "warm_s": warm_s}, fh,
                  indent=1)
    d = jax.devices()[0]
    line = json.dumps({
        "metric": "compress_MBps_device_engine_level9",
        "value": round(dev_mbps, 2),
        "unit": "MB/s",
        "host_MBps": round(host_mbps, 2),
        "decompress_MBps": round(dec_mbps, 2),
        "device_blocks": dev_stats["device_blocks"],
        "host_blocks": dev_stats["host_blocks"],
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    })
    print(line, flush=True)
    # engine threads are daemons; skip interpreter teardown under them
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
