#!/usr/bin/env python3
"""Smoke run of the device compress engine on one GPU.

Drives the production path once at full width and checks every output
byte; nothing is compared with a tolerance.

  kernels  one 32 x 901120 batch (the -9 bucket) of seeded 880-900 KB
           blocks (text, binary, runs, markup, repeats, incompressible)
           through bwt2_bytes + chain_payloads, and through bwt2_tokens
           (the LBZ2_DEVICE_CHAIN=0 route; every repeats row must go
           through its run tokens), against the C encoder
  main     the CLI at -9 with LBZIP2_TPU_ENGINE=device over a seeded
           mixed corpus, twice: hybrid (as users run it) and with host
           stealing off.  Each stream must equal host-only
           compress_parallel and round-trip through bz2 and the CLI -d.
  decode   device IBWT and device Huffman decode over 16 blocks of that
           stream, against the host decode

  --four   only the 4-card path: the engine round-robins 4 local cards
           (against host-only), and __graft_entry__.dryrun_multichip(4)
           on the GPU (against the C encoder and libbzip2)

Usage:  python chip_smoke.py [--four] [--size-mb MB] [--seed S]

One process owns the card(s).  The last stdout line is
{"ok": true, "device": {...}}; a failed phase exits 1, and a run where
JAX finds no GPU exits 2 without a result.
"""

from __future__ import annotations

import argparse
import bz2
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROWS, BUCKET = 32, 901120


def log(*a):
    print(*a, flush=True)


# --- compile accounting -----------------------------------------------------

_compiles: list[tuple[str, float]] = []


def _on_event(event, duration, **kw):
    if event == "/jax/core/compile/backend_compile_duration":
        _compiles.append((kw.get("fun_name", "?"), duration))


def _report_compiles(phase):
    for name, sec in _compiles:
        log(f"[{phase}] compile {name}: {sec:.3f} s")
    _compiles.clear()


def _aot(name, fn, *args, **static):
    """Compile fn for args ahead of time; print seconds and memory."""
    t0 = time.time()
    compiled = fn.lower(*args, **static).compile()
    log(f"compile {name} (AOT): {time.time() - t0:.3f} s")
    log(f"memory {name}: {compiled.memory_analysis()}")
    return compiled


# --- inputs -----------------------------------------------------------------

# repeats rows have long BWT runs, so the token route carries them
_KINDS = ("text", "binary", "runs", "noise", "text", "markup", "binary",
          "repeats")


def make_blocks(rows: int, n_lo: int, n_hi: int, seed: int):
    """rows RLE1-domain blocks of n_lo..n_hi bytes, cycling through the
    corpus classes; returns [(kind, block)]."""
    from lbzip2_tpu.ref.rle1 import transform_span
    from tests import corpus

    rng = np.random.default_rng(seed)
    out = []
    for r in range(rows):
        kind = _KINDS[r % len(_KINDS)]
        n = int(rng.integers(n_lo, n_hi + 1))
        raw = getattr(corpus, kind)(n * (6 if kind == "runs" else 2),
                                    seed * 1000 + r)
        blk, _ = transform_span(np.frombuffer(raw, np.uint8))
        out.append((kind, np.ascontiguousarray(blk[:n])))
    return out


def _batch(blocks, bucket):
    from lbzip2_tpu import native
    B = len(blocks)
    rows = np.zeros((B, bucket), np.uint8)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    cmaps = np.zeros((B, 256), np.uint8)
    crcs = np.zeros(B, np.uint32)
    for b, (_, blk) in enumerate(blocks):
        _, m = native.lyndon_prep(blk, out=rows[b, :blk.size])
        assert m >= 0, f"row {b} is periodic"
        ns[b], ms[b] = blk.size, m
        cmaps[b, np.unique(blk)] = 1
        crcs[b] = (native.crc32_block(blk) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    return rows, ns, ms, cmaps, crcs


def _c_reference(blocks, cmaps, crcs):
    """(bwt, primary, payload) per row from the C encoder."""
    from lbzip2_tpu import native

    def one(b):
        bw, idx = native.bwt(blocks[b][1])
        return bw, idx, native.encode_payload(bw, cmaps[b], idx,
                                              int(crcs[b]), 8)

    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        return list(ex.map(one, range(len(blocks))))


# --- phases -----------------------------------------------------------------

def phase_kernels(rows: int = ROWS, bucket: int = BUCKET, seed: int = 0,
                  n_range: tuple[int, int] = (880_000, 899_981)):
    """Device BWT + entropy chain and the token route vs the C encoder."""
    import jax

    from lbzip2_tpu.ops import chain
    from lbzip2_tpu.ops.bwt2 import bwt2_bytes, bwt2_tokens

    t0 = time.time()
    blocks = make_blocks(rows, *n_range, seed)
    rows_np, ns, ms, cmaps, crcs = _batch(blocks, bucket)
    want = _c_reference(blocks, cmaps, crcs)
    log(f"kernels: {rows} rows x {bucket} lanes, kinds "
        f"{[k for k, _ in blocks]}, inputs + C reference "
        f"{time.time() - t0:.3f} s")

    args = [jax.device_put(x) for x in (rows_np, ns, ms)]
    f_bytes = _aot("bwt2_bytes", bwt2_bytes, *args)
    t0 = time.time()
    bwt_dev, primary = f_bytes(*args)
    primary = np.asarray(primary)
    log(f"bwt2_bytes run: {time.time() - t0:.3f} s")
    cm_dev = jax.device_put(cmaps)
    _aot("chain_mtf2", chain.chain_mtf2, bwt_dev, args[1], cm_dev)
    for b, (_, idx, _) in enumerate(want):
        assert primary[b] == idx, (b, int(primary[b]), idx)

    # chain, full-width pack: binary rows need more than PACK_W_SMALL
    t0 = time.time()
    pays = chain.chain_payloads(bwt_dev, ns, cmaps, primary, crcs)
    log(f"chain_payloads (first call) {time.time() - t0:.3f} s")
    t0 = time.time()
    pays = chain.chain_payloads(bwt_dev, ns, cmaps, primary, crcs)
    log(f"chain_payloads (warm) {time.time() - t0:.3f} s")
    full = 0
    for b, (_, _, pay) in enumerate(want):
        if pays[b] is None:   # over the pack capacity: host re-encodes
            assert 8 * len(pay) > 32 * chain.PACK_W - 64, b
        else:
            assert pays[b] == pay, f"chain payload row {b} differs"
            full += 1
    need_small = [b for b, (_, _, p) in enumerate(want)
                  if 8 * len(p) <= 32 * chain.PACK_W_SMALL - 4096]
    if bucket == BUCKET:
        assert len(need_small) < rows, "batch never needs the full pack"

    # chain, small pack: replay the rows that fit PACK_W_SMALL
    sel = np.array([need_small[b % len(need_small)] for b in range(rows)])
    pays_s = chain.chain_payloads(bwt_dev[jax.device_put(sel)], ns[sel],
                                  cmaps[sel], primary[sel], crcs[sel])
    for b, s in enumerate(sel):
        assert pays_s[b] == want[s][2], f"small-pack row {b} differs"

    # token route (LBZ2_DEVICE_CHAIN=0)
    f_tok = _aot("bwt2_tokens", bwt2_tokens, *args)
    tokens, raw, counts, tprim = f_tok(*args)
    counts, tprim = np.asarray(counts), np.asarray(tprim)
    tok = np.asarray(tokens).view(np.uint16).reshape(rows, -1)
    raw_h = np.asarray(raw).view(np.uint8).reshape(rows, -1)
    via_tok = 0
    for b, (bw, idx, _) in enumerate(want):
        assert tprim[b] == idx, b
        fits = counts[b] <= tok.shape[1]
        assert fits or blocks[b][0] != "repeats", \
            f"repeats row {b} overflowed the token budget"
        if fits:
            t = tok[b, :counts[b]]
            got = np.repeat((t >> 8).astype(np.uint8), t & 0xFF)
            via_tok += 1
        else:
            got = raw_h[b, :ns[b]]
        assert np.array_equal(got, bw), f"token-route BWT row {b} differs"
    assert via_tok > 0, "no row went through the run tokens"
    log(f"kernels: {full}/{rows} chain payloads byte-identical (rest over "
        f"pack capacity), {len(sel)} small-pack rows identical, "
        f"primaries identical; token route {via_tok} rows via tokens, "
        f"{rows - via_tok} raw, all BWTs identical")
    return {"bwt_dev": bwt_dev, "ns": ns, "cmaps": cmaps,
            "primary": primary, "crcs": crcs,
            "payloads": [w[2] for w in want]}


def _cli(argv):
    from lbzip2_tpu import cli
    rc = cli.main(["lbzip2", *argv])
    assert rc == 0, f"lbzip2 {' '.join(argv)} exited {rc}"


def phase_main(data: bytes, want: bytes, level: int = 9,
               host_steal: bool = True) -> bytes:
    """CLI -level with the device engine; returns the stream."""
    from lbzip2_tpu.codec import encoder

    saved = os.environ.get("LBZIP2_TPU_ENGINE"), encoder._HOST_STEAL
    os.environ["LBZIP2_TPU_ENGINE"] = "device"
    encoder._HOST_STEAL = host_steal
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "corpus")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.time()
            _cli([f"-{level}", "-k", "-f", path])
            dt = time.time() - t0
            with open(path + ".bz2", "rb") as f:
                out = f.read()
            stats = dict(encoder.last_stats)
            os.remove(path)
            _cli(["-d", "-k", "-f", path + ".bz2"])
            with open(path, "rb") as f:
                assert f.read() == data, "CLI -d round trip differs"
    finally:
        encoder._HOST_STEAL = saved[1]
        if saved[0] is None:
            os.environ.pop("LBZIP2_TPU_ENGINE", None)
        else:
            os.environ["LBZIP2_TPU_ENGINE"] = saved[0]
    assert out == want, "device-engine stream differs from host-only"
    assert bz2.decompress(out) == data, "bz2 round trip differs"
    assert stats["device_blocks"] > 0, "the device encoded no block"
    assert not stats["abandoned"], "the watchdog abandoned the device"
    if not host_steal:
        assert stats["host_blocks"] == 0, stats["host_blocks"]
    devs = sorted({t["dev"] for t in stats["batch_trace"]})
    log(f"main (host_steal={host_steal}): {len(data)} B -> {len(out)} B "
        f"in {dt:.3f} s (host clock, CLI incl. file I/O); blocks "
        f"device {stats['device_blocks']}, host {stats['host_blocks']}, "
        f"periodic {stats['periodic_blocks']}, stale device rows "
        f"{stats['stale_rows']}; batches {len(stats['batch_trace'])} on "
        f"devices {devs}; identical to host-only, bz2 and CLI -d OK")
    return out


def phase_decode(data: bytes, level: int = 9, nblocks: int = 16):
    """Device IBWT and device Huffman decode vs the host decode."""
    from lbzip2_tpu.parallel import decode
    from lbzip2_tpu.parallel.encode import compress_parallel

    part = data[:nblocks * level * 100_000]
    stream = compress_parallel(part, level)
    host = decode.decompress_parallel(stream)
    assert host == part
    t0 = time.time()
    assert decode.decompress_parallel(stream, device_ibwt=True) == host, \
        "device IBWT decode differs"
    t_ibwt = time.time() - t0
    saved = decode.DEVICE_HUFF
    decode.DEVICE_HUFF = True
    try:
        t0 = time.time()
        assert decode.decompress_parallel(stream) == host, \
            "device Huffman decode differs"
        t_huff = time.time() - t0
    finally:
        decode.DEVICE_HUFF = saved
    log(f"decode: {len(part)} B ({nblocks} blocks) device IBWT "
        f"{t_ibwt:.3f} s, device Huffman {t_huff:.3f} s (host clock, "
        f"first calls incl. compile); both identical to host decode")


def phase_four(data: bytes, want: bytes, level: int = 9):
    """The engine over 4 local cards, then the sharded dry run."""
    import jax

    from lbzip2_tpu.codec import encoder

    saved = encoder._HOST_STEAL
    encoder._HOST_STEAL = False
    try:
        t0 = time.time()
        out = encoder.compress(data, level)
        dt = time.time() - t0
    finally:
        encoder._HOST_STEAL = saved
    stats = dict(encoder.last_stats)
    devs = sorted({t["dev"] for t in stats["batch_trace"]})
    assert out == want, "4-card stream differs from host-only"
    assert devs == list(range(len(jax.local_devices()))), devs
    log(f"four: {len(data)} B in {dt:.3f} s, {len(stats['batch_trace'])} "
        f"batches on devices {devs}, {stats['device_blocks']} device "
        f"blocks; identical to host-only")
    os.environ["LBZ2_DRYRUN_PLATFORM"] = jax.devices()[0].platform
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)


# --- driver -----------------------------------------------------------------

def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card path")
    # 256 MiB: on a 16-core host the host-only pipeline finishes 128 MiB
    # in under a second, about when the first device batch lands; twice
    # that keeps the hybrid's device share well clear of zero
    ap.add_argument("--size-mb", type=int, default=256,
                    help="corpus size of the main path (MiB)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    want_n = 4 if args.four else 1
    if devs[0].platform != "gpu" or len(devs) < want_n:
        print(f"chip_smoke: needs {want_n} GPU(s), JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        return 2
    if not args.four:
        devs = devs[:1]
    log(f"card: {card_line()}")
    from lbzip2_tpu import compile_cache
    log(f"compile cache: {compile_cache.enable()}")
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    log(f"jax {jax.__version__}, devices {devs}")

    from lbzip2_tpu.parallel.encode import compress_parallel
    from tests import corpus

    size = args.size_mb << 20
    t0 = time.time()
    data = corpus.mixed(size, args.seed)
    want = compress_parallel(data, 9)
    log(f"corpus: {size} B mixed (seed {args.seed}) -> host-only "
        f"{len(want)} B, set-up {time.time() - t0:.3f} s")

    if args.four:
        phases = [("four", lambda: phase_four(data, want))]
    else:
        phases = [
            ("kernels", lambda: phase_kernels(seed=args.seed)),
            ("main_hybrid", lambda: phase_main(data, want)),
            ("main_no_steal", lambda: phase_main(data, want,
                                                 host_steal=False)),
            ("decode", lambda: phase_decode(data)),
        ]
    verdicts = {}
    for name, fn in phases:
        t0 = time.time()
        try:
            fn()
            verdicts[name] = "ok"
        except Exception:  # noqa: BLE001 — reported, then exit 1
            traceback.print_exc()
            verdicts[name] = "FAILED"
        _report_compiles(name)
        log(f"phase {name}: {verdicts[name]} ({time.time() - t0:.3f} s)")
    if any(v != "ok" for v in verdicts.values()):
        log(f"chip_smoke: failed phases "
            f"{[k for k, v in verdicts.items() if v != 'ok']}")
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    # engine threads are daemons; skip interpreter teardown under them
    os._exit(code)
