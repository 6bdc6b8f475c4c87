#!/usr/bin/env python3
"""The chain's MTF stage on one GPU: the Pallas-Triton kernel against the
lax.scan formulation, each in its own jitted copy of chain_mtf2.

  python tools/mtf_probe.py compile
      AOT-compile bwt2_bytes and both chain_mtf2 variants at the -9
      bucket (32 x 901120); print seconds and whether the persistent
      compile cache served each.  Run it twice with one
      JAX_COMPILATION_CACHE_DIR (the second time from a copy of the
      checkout at another path) to see what a later process pays.

  python tools/mtf_probe.py time [--reps N] [--size-mb MB]
      On one batch of seeded 880-900 KB blocks, in turns scan / triton /
      triton / scan: chain_mtf2 alone, the whole entropy chain
      (chain_payloads), and the device engine end to end
      (codec.encoder.compress with host stealing off) over a seeded
      mixed corpus.  Outputs must agree between variants and with the
      host-only stream.

Times are host-clock wall times around calls that end in a blocking
fetch.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS, BUCKET = 32, 901120
ORDER = ("scan", "triton", "triton", "scan")

_hits: list[str] = []


def _on_event(event, **kw):
    if event == "/jax/compilation_cache/cache_hits":
        _hits.append(event)


def variant(name: str):
    """A separately traced jit of chain._chain_mtf2 using one MTF."""
    import jax

    from lbzip2_tpu.ops import chain
    from lbzip2_tpu.ops.mtf import mtf_ranks
    from lbzip2_tpu.ops.mtf_triton import mtf_ranks_rows_triton

    rows = {"scan": lambda s, n: jax.vmap(mtf_ranks)(s, n),
            "triton": mtf_ranks_rows_triton}[name]

    def fn(bwt, ns, cmaps):
        saved = chain._mtf_ranks_rows
        chain._mtf_ranks_rows = rows
        try:
            return chain._chain_mtf2(bwt, ns, cmaps)
        finally:
            chain._mtf_ranks_rows = saved

    fn.__name__ = f"chain_mtf2_{name}"
    return jax.jit(fn)


def aot(name, fn, *args):
    n0 = len(_hits)
    t0 = time.time()
    compiled = fn.lower(*args).compile()
    sec = time.time() - t0
    hit = len(_hits) > n0
    print(f"compile {name}: {sec:.3f} s, cache {'hit' if hit else 'miss'}",
          flush=True)
    return compiled, {"compile_s": sec, "cache_hit": hit}


def compile_all() -> dict:
    import jax
    import jax.numpy as jnp

    from lbzip2_tpu.ops.bwt2 import bwt2_bytes

    rows = jax.ShapeDtypeStruct((ROWS, BUCKET), jnp.uint8)
    vec = jax.ShapeDtypeStruct((ROWS,), jnp.int32)
    cm = jax.ShapeDtypeStruct((ROWS, 256), jnp.uint8)
    out = {"bwt2_bytes": aot("bwt2_bytes", bwt2_bytes, rows, vec, vec)[1]}
    for name in ("scan", "triton"):
        out[name] = aot(f"chain_mtf2[{name}]", variant(name), rows, vec,
                        cm)[1]
    return out


def _times(label, fn, reps):
    fn()   # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ms = sorted(1e3 * t for t in ts)
    print(f"{label}: median {ms[len(ms) // 2]:.2f} ms, min {ms[0]:.2f}, "
          f"max {ms[-1]:.2f} ({reps} reps)", flush=True)
    return ms


def time_all(reps: int, size_mb: int, seed: int = 0) -> dict:
    import jax

    import chip_smoke
    from lbzip2_tpu.codec import encoder
    from lbzip2_tpu.ops import chain
    from lbzip2_tpu.ops.bwt2 import bwt2_bytes
    from lbzip2_tpu.parallel.encode import compress_parallel
    from tests import corpus

    blocks = chip_smoke.make_blocks(ROWS, 880_000, 899_981, seed)
    rows_np, ns, ms, cmaps, crcs = chip_smoke._batch(blocks, BUCKET)
    args = [jax.device_put(x) for x in (rows_np, ns, ms)]
    bwt_dev, primary = bwt2_bytes(*args)
    primary = np.asarray(primary)
    cm_dev = jax.device_put(cmaps)

    fns = {}
    for name in ("scan", "triton"):
        fns[name], _ = aot(f"chain_mtf2[{name}]", variant(name), bwt_dev,
                           args[1], cm_dev)
    ref = [np.asarray(x) for x in fns["scan"](bwt_dev, args[1], cm_dev)]
    got = [np.asarray(x) for x in fns["triton"](bwt_dev, args[1], cm_dev)]
    for a, b in zip(ref, got):
        assert np.array_equal(a, b), "variants disagree"

    res = {name: {"mtf2_ms": [], "chain_ms": [], "engine_s": []}
           for name in fns}
    for name in ORDER:
        f = fns[name]
        res[name]["mtf2_ms"] += _times(
            f"chain_mtf2[{name}]",
            lambda: jax.block_until_ready(f(bwt_dev, args[1], cm_dev)),
            reps)
    saved = chain.chain_mtf2
    try:
        pays = {}
        for name in ORDER:
            chain.chain_mtf2 = fns[name]
            res[name]["chain_ms"] += _times(
                f"chain_payloads[{name}]",
                lambda: pays.__setitem__(name, chain.chain_payloads(
                    bwt_dev, ns, cmaps, primary, crcs)),
                max(3, reps // 2))
        assert pays["scan"] == pays["triton"], "chain payloads disagree"

        data = corpus.mixed(size_mb << 20, seed)
        want = compress_parallel(data, 9)
        encoder._HOST_STEAL = False
        chain.chain_mtf2 = fns["scan"]
        assert encoder.compress(data[:64 * 900_000], 9) == \
            compress_parallel(data[:64 * 900_000], 9)   # compiles the rest
        for name in ORDER:
            chain.chain_mtf2 = fns[name]
            t0 = time.perf_counter()
            out = encoder.compress(data, 9)
            dt = time.perf_counter() - t0
            assert out == want, f"engine stream differs ({name})"
            st = encoder.last_stats
            print(f"engine[{name}]: {len(data)} B in {dt:.3f} s "
                  f"({len(data) / dt / 1e6:.2f} MB/s), device blocks "
                  f"{st['device_blocks']}, host {st['host_blocks']}",
                  flush=True)
            res[name]["engine_s"].append(dt)
    finally:
        chain.chain_mtf2 = saved
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("compile", "time"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--size-mb", type=int, default=128)
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        print("mtf_probe: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from lbzip2_tpu import compile_cache
    print(f"card: {chip_smoke.card_line()}", flush=True)
    print(f"compile cache: {compile_cache.enable()}, checkout "
          f"{os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}",
          flush=True)
    jax.monitoring.register_event_listener(_on_event)
    res = compile_all() if args.mode == "compile" else time_all(
        args.reps, args.size_mb)
    print(json.dumps({"mode": args.mode, "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    # engine threads are daemons; skip interpreter teardown under them
    os._exit(code)
