"""Production compressor: hybrid device + host work pool.

Stage map vs the reference pipeline (src/compress.c tasks):
  collect   -> rle1 block split + least-rotation prep (native C)
  encode    -> ops.bwt2 gather-free suffix doubling (device) and/or
               host SA-IS BWT, + MTF/RLE2/EM/Huffman (native C)
  transmit  -> native bit packer
  reorder   -> in-order assembly + combined CRC fold

Scheduling is the lbzip2 work pool (src/process.c:436-462) over
heterogeneous engines: a device engine groups blocks into fixed-shape
(B, N) batches, each resolved by ONE device program (ops/bwt2.py
bwt2_tokens: seed + on-chip while_loop of rank passes + token emit),
with several batches in flight so uploads, kernels, downloads, and
host token expansion overlap.  Host workers run the C entropy stage
for finished device BWTs and — whenever no entropy work is queued —
steal whole blocks from the tail of the queue for host-side encode.
The device takes blocks from the head, the host from the tail; they
meet in the middle, so each engine contributes its full throughput.

The hybrid can never lose to host-only (the reference's worst-case
property, src/parse.c:56-69): device-*claimed* blocks stay stealable —
when the host would otherwise idle (cold compile, a stalled device,
end-of-stream drain) it steals claimed blocks back and encodes them
itself; whichever engine finishes a block first wins and the loser's
late duplicate is dropped.  Fully-periodic blocks (no
Lyndon conjugate) always take the host path — their tie order is a
host-side convention.
"""

from __future__ import annotations

import heapq
import os
import queue
import threading
import time

import numpy as np

from lbzip2_tpu import native
from lbzip2_tpu.core import crc32
from lbzip2_tpu.core.constants import CLUSTER_FACTOR
from lbzip2_tpu.ref import rle1
from lbzip2_tpu.ref.encoder import encode_block_payload
from lbzip2_tpu.ref.mtf import make_cmap

# Static device shape buckets.  Every (rows, bucket) pair is a separate
# compile, so the surface is kept minimal: one production bucket (covers
# MAX_BLOCK_SIZE with ~0.1% padding) and one tiny bucket so CPU-backend
# tests exercise the device path cheaply.  Mid-size blocks (level < 9,
# stream tails) go to the host engine.
_BUCKETS = (8192, 901120)
_MID_CUTOFF = 262144  # blocks in (8192, _MID_CUTOFF] -> host engine

# Device-batch rows per dispatch: one compiled shape per bucket; short
# batches are padded with copies of row 0.  Large batches amortize the
# per-dispatch cost and keep the sort lanes full.
_BATCH = int(os.environ.get("LBZ2_DEVICE_BATCH", "32"))

# Batches kept in flight on the device queue simultaneously, so the
# device stays fed across fetch/dispatch gaps (not measured on the
# H100).
_INFLIGHT = int(os.environ.get("LBZ2_DEVICE_INFLIGHT", "3"))

_DEVICE = os.environ.get("LBZ2_DEVICE", "1") != "0"

# Diagnostic: disable host tail-stealing (device-only block encode).
_HOST_STEAL = os.environ.get("LBZ2_HOST_STEAL", "1") != "0"

# Steal-back of device-claimed blocks when the host would otherwise
# idle.  Grace period: steal only when the device has not completed a
# batch for this long (0 completions ever = steal immediately, which
# covers the cold-compile window).  The 10 s default is not measured
# on the H100.
_STEALBACK = os.environ.get("LBZ2_STEALBACK", "1") != "0"
_STEALBACK_GRACE_S = float(os.environ.get("LBZ2_STEALBACK_GRACE_S",
                                          "10"))

# Drain guard (take_head): stop device claims when the host pool would
# finish the remaining queue faster than one device batch round trip.
# The latency estimate is fitted from observed batch completions but
# never below this floor — a couple of freak fast batches must not
# talk the guard into claiming at the drain.  The 2 s floor is not
# measured on the H100.
_DRAIN_LAT_FLOOR_S = float(os.environ.get("LBZ2_DRAIN_LAT_FLOOR_S",
                                          "2.0"))

# Device entropy chain: run MTF+RLE2+EM+bit-pack on device and download
# only compressed payloads (ops/chain.py), instead of downloading BWT
# run tokens and running the C entropy stage on the host.
# LBZ2_DEVICE_CHAIN=0 selects the token path (device BWT + host token
# entropy).  Which of the two wins on the H100 is not measured.
_DEVICE_CHAIN = os.environ.get("LBZ2_DEVICE_CHAIN", "1") == "1"

# Cross-pool chip gate: compress() returns as soon as the stream is
# whole, deliberately leaving its last in-flight device batches to
# finish (or be abandoned) in the background.  A NEW pool's device
# pipeline must not queue behind that leftover chip work — back-to-back
# compress() calls otherwise measure the second stream's device leg as
# dead (the first batch lands after the stream already finished on the
# host).  The counter tracks dispatched-but-unfetched batches globally;
# a fresh pipeline waits (bounded — a stalled device must not block
# forever) for it to drain before its first dispatch.  The 60 s bound
# is not measured on the H100.
_chip_inflight = 0
_chip_cv = threading.Condition()
_warmed = False  # warm_device() ran in this process


def _chip_inc():
    global _chip_inflight
    with _chip_cv:
        _chip_inflight += 1


def _chip_dec():
    global _chip_inflight
    with _chip_cv:
        # clamp: _chip_wait_idle resets a timed-out (presumed wedged)
        # counter to 0; a straggler batch completing after that reset
        # must not drive the counter negative
        _chip_inflight = max(0, _chip_inflight - 1)
        _chip_cv.notify_all()


def _chip_wait_idle(timeout_s: float = 60.0, max_inflight: int = 1):
    """Wait until at most max_inflight leftover batches remain.

    Default 1 (not 0): a fresh stream's first dispatch may interleave
    with the previous pool's LAST in-flight batch — waiting for full
    idle can forfeit the device leg entirely on streams shorter than
    drain + first-batch latency."""
    global _chip_inflight
    deadline = time.time() + timeout_s
    with _chip_cv:
        while _chip_inflight > max_inflight:
            left = deadline - time.time()
            if left <= 0:
                # the previous pool's in-flight work never completed
                # within the bound (stalled device or a fetch worker
                # that died with items still queued).  Reset so ONE
                # stall costs 60 s, not every subsequent compress().
                _chip_inflight = 0
                return
            _chip_cv.wait(timeout=min(1.0, left))


def _bucket_for(n: int) -> int | None:
    """Device bucket for a block of n bytes; None -> host engine."""
    if n <= _BUCKETS[0]:
        return _BUCKETS[0]
    if n <= _MID_CUTOFF:
        return None
    if n <= _BUCKETS[-1]:
        return _BUCKETS[-1]
    raise ValueError(f"block too large: {n}")


def _entropy_payload(buf, span, bwt_row, bwt_idx, cluster_factor):
    """Host entropy stage for one block (C kernels when available).

    bwt_row is either the BWT byte row, or ("tok", u16_run_tokens) —
    the device download format, consumed directly by the token MTF
    (no 900k byte-row expansion on the host)."""
    n = span.data.size
    if native.native_available():
        crc_stored = (native.crc32_block(buf[span.start:span.end])
                      ^ 0xFFFFFFFF) & 0xFFFFFFFF
        if isinstance(bwt_row, tuple):
            payload = native.encode_payload_from_tokens(
                bwt_row[1], np.asarray(span.cmap, np.uint8),
                int(bwt_idx), crc_stored, cluster_factor, n_bytes=n)
        else:
            payload = native.encode_payload(
                bwt_row[:n], np.asarray(span.cmap, np.uint8),
                int(bwt_idx), crc_stored, cluster_factor)
        return payload, crc_stored
    # Pure-Python fallback (slow; used when no C toolchain).
    from lbzip2_tpu.ref.mtf import mtf_rle2
    if isinstance(bwt_row, tuple):
        t = bwt_row[1]
        bwt_row = np.repeat((t >> 8).astype(np.uint8), t & 0xFF)
    mtfv = mtf_rle2(bwt_row[:n], make_cmap(span.cmap),
                    int(span.cmap.sum()))
    crc_stored = crc32.crc_of(buf[span.start:span.end])
    payload = encode_block_payload(mtfv, span.cmap, int(bwt_idx),
                                   crc_stored, cluster_factor)
    return payload, crc_stored


def _host_block(buf, span, cluster_factor):
    if native.native_available():
        brow, bidx = native.bwt(span.data, scratch=True)
    else:
        from lbzip2_tpu.ref.bwt import bwt as py_bwt
        brow, bidx = py_bwt(span.data)
    return _entropy_payload(buf, span, brow, bidx, cluster_factor)


class _EdfQueue:
    """EDF priority queue for entropy work: items pop smallest block id
    first (the reference's earliest-deadline-first pqueues keyed on
    struct position, src/process.c:36-63), so the block the in-order
    consumer needs next is always finished first.  close() replaces a
    sticky sentinel: after close, get() returns None once drained."""

    def __init__(self):
        self._h: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._seq = 0  # tie-break: duplicate ids pop in arrival order

    def put(self, item):
        with self._cv:
            self._seq += 1
            heapq.heappush(self._h, (item[0], self._seq, item))
            self._cv.notify()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def get(self, block=True, timeout=None):
        """Smallest-id item, else None (empty+non-blocking, closed, or
        timed out — callers re-poll their higher-priority sources)."""
        with self._cv:
            if self._h:
                return heapq.heappop(self._h)[2]
            if not block or self._closed:
                return None
            self._cv.wait(timeout)
            if self._h:
                return heapq.heappop(self._h)[2]
            return None

    def empty(self):
        with self._cv:
            return not self._h


class _WorkPool:
    """Hybrid scheduler: device head-consumer + host tail-stealers."""

    def __init__(self, buf, blocks, cluster_factor, host_workers,
                 use_device):
        self.buf = buf
        self.blocks = blocks
        self.cf = cluster_factor
        self.results: dict[int, tuple[bytes, int]] = {}
        self.res_lock = threading.Lock()
        self.res_cv = threading.Condition(self.res_lock)
        self.error: BaseException | None = None
        # shared deque of block ids: device pops head, host pops tail
        self.ids = list(range(len(blocks)))
        self.head = 0
        self.tail = len(blocks)
        self.q_lock = threading.Lock()
        self.entropy_q = _EdfQueue()
        self.device_done = not use_device
        self.host_workers = host_workers
        self.use_device = use_device
        self.claimed: set[int] = set()  # device-claimed, undelivered
        self.abandoned = False
        self.complete = False  # every block delivered; engines may bail
        self.next_deliver = 0  # results below this are stale duplicates
        self.last_batch_t = 0.0  # monotonic t of last device completion
        self.lat_ema = 0.0     # claim->deliver latency estimate (s)
        self.fetch_q: queue.Queue = queue.Queue()
        self.fetch_pending = 0  # dispatched batches not yet fetched
        self.stats = {"device_blocks": 0, "host_blocks": 0,
                      "abandoned": False,
                      "periodic_blocks": 0, "stale_rows": 0,
                      "host_idle_s": 0.0, "device_batches": [],
                      "batch_trace": [], "t0": time.time()}

    # --- queue primitives -------------------------------------------------
    def take_head(self, k: int) -> list[int]:
        """Device claim: full batches while the queue is deep, batches
        of 8 near the end, at most half the remainder — so host
        tail-stealing always keeps its share of a short queue.

        Drain guard: once live rates are known, don't claim blocks the
        host pool would finish faster than one device batch round
        trip — otherwise the end of every stream runs at device batch
        latency."""
        with self.q_lock:
            if self.abandoned:  # watchdog fired: stop claiming
                return []
            remaining = self.tail - self.head
            el = time.time() - self.stats["t0"]
            hb = self.stats["host_blocks"]
            db = self.stats["device_batches"]
            if hb and len(db) >= 2 and el > 0:
                host_bps = hb / el                       # blocks/s
                # latency = observed claim->deliver time (ready_s EMA),
                # NOT completion spacing: with several batches pipelined
                # the cadence reads shorter than the time a claim takes
                # to come back
                lat = max(_DRAIN_LAT_FLOOR_S, self.lat_ema)
                if remaining < k + host_bps * lat:
                    return []
            if not db and hb >= remaining:
                # the unproven engine is being outpaced: the host has
                # already encoded more blocks than remain — a short
                # stream will end before the first batch lands, and
                # every claim is steal-back work at the drain
                return []
            if remaining < 2 * k:
                k = 8 if remaining >= 16 else max(1, remaining // 2)
            got = self.ids[self.head:min(self.head + k, self.tail)]
            self.head += len(got)
            self.claimed.update(got)
            return got

    def take_tail(self) -> int | None:
        with self.q_lock:
            if self.tail <= self.head:
                return None
            self.tail -= 1
            return self.ids[self.tail]

    def take_claimed(self) -> int | None:
        """Steal back a device-claimed block (cold compile, stalled
        device, end-of-stream drain).  Takes the youngest claim: the
        device completes oldest batches first, so the youngest is the
        least likely to be seconds from delivery.  First result wins;
        the loser's late duplicate is dropped by put_result."""
        with self.q_lock:
            queue_empty = self.tail <= self.head
        if not queue_empty and self.last_batch_t and \
                time.time() - self.last_batch_t < _STEALBACK_GRACE_S:
            return None  # device is streaming AND there is tail work:
            # don't duplicate.  With an empty tail the host has nothing
            # else to do, so racing the device is a free win (first
            # result wins; the loser's duplicate is dropped).
        with self.q_lock:
            if not self.claimed:
                return None
            i = max(self.claimed)
            self.claimed.discard(i)
            return i

    def unclaim(self, i):
        with self.q_lock:
            self.claimed.discard(i)

    def is_stale(self, i) -> bool:
        """True once some engine already produced block i."""
        with self.res_cv:
            return i < self.next_deliver or i in self.results

    def put_result(self, i, payload_crc):
        with self.q_lock:  # claimed is mutated under q_lock only
            self.claimed.discard(i)
        with self.res_cv:
            # first result wins; a slower engine's duplicate is dropped
            if i >= self.next_deliver and i not in self.results:
                self.results[i] = payload_crc
            self.res_cv.notify_all()

    def fail(self, exc):
        with self.res_cv:
            if self.error is None:
                self.error = exc
            self.res_cv.notify_all()

    # --- device engine ----------------------------------------------------
    def device_loop(self):
        try:
            self._device_pipeline()
        except BaseException as e:  # noqa: BLE001
            # after watchdog abandonment (or completion via steal-back)
            # the stream is already whole; a late error from the wedged
            # engine must not fail it
            if not (self.abandoned or self.complete):
                self.fail(e)
        finally:
            self.device_done = True
            self.entropy_q.close()  # wake idle workers for shutdown

    def _device_pipeline(self):
        """One bwt2_tokens/bwt2_bytes dispatch per batch.

        This thread claims, preps, uploads, and dispatches; daemon
        fetch workers block on the d2h copies and expand tokens, so
        the copies and the host expansion overlap the next batches'
        kernels.  In-flight depth stays at 1 until the first batch
        completes (a cold compile); with host steal-back of claimed
        blocks a cold cache therefore costs the stream little.
        """
        import jax
        from lbzip2_tpu.ops.bwt2 import bwt2_bytes, bwt2_tokens
        # drive EVERY local device: round-robin batches, one extra
        # in-flight slot per additional device (single-chip boxes are
        # the degenerate 1-device case; a virtual CPU mesh exercises
        # the same dispatch path in tests)
        _chip_wait_idle()  # don't queue behind a previous pool's tail
        devs = jax.local_devices()
        disp = 0
        nfetchers = 2
        for w in range(nfetchers):
            threading.Thread(target=self._fetch_worker,
                             name=f"lbz2-fetch{w}", daemon=True).start()
        try:
            while not (self.abandoned or self.complete):
                if self.error is not None:
                    break
                # depth 1 while cold: don't queue claims behind an
                # unproven (possibly compiling/wedged) first batch.
                # warm_device() in this process proves the programs
                # compile and run, so skip the ramp and pipeline the
                # second batch's upload under the first one's kernels.
                cap = (_INFLIGHT + len(devs) - 1) \
                    if (self.stats["device_batches"] or _warmed) else 1
                if self.fetch_pending >= cap:
                    time.sleep(0.005)
                    continue
                ids = self.take_head(_BATCH)
                if not ids:
                    break  # fall through to the drain: the sticky
                    # entropy sentinel must trail every in-flight
                    # fetch's items or host workers exit early
                built = self._build_batch(ids)
                if built is None:
                    continue
                ids, spans, batch, ns, ms, tele = built
                # explicit placement only when there is actually more
                # than one device: the committed-array path is the
                # round-robin mechanism, and single-device boxes keep
                # the default (uncommitted) fast path
                dev = devs[disp % len(devs)] if len(devs) > 1 else None
                tele["dev"] = disp % len(devs)
                disp += 1

                def _up(x, dev=dev):
                    return jax.device_put(x) if dev is None else \
                        jax.device_put(x, dev)

                t0 = time.time()
                if _DEVICE_CHAIN:
                    outs = bwt2_bytes(_up(batch), _up(ns), _up(ms))
                else:
                    outs = bwt2_tokens(_up(batch), _up(ns), _up(ms))
                    # start d2h of everything except the raw fallback
                    # rows so the copies overlap later batches' kernels
                    for a in (outs[0], outs[2], outs[3]):
                        try:
                            a.copy_to_host_async()
                        except AttributeError:
                            pass
                tele["dispatch_s"] = round(time.time() - t0, 3)
                _chip_inc()
                with self.q_lock:
                    self.fetch_pending += 1
                self.fetch_q.put((ids, spans, outs, tele))
            # drain: fetch workers finish in the background; bail early
            # if the stream completes or the watchdog fires
            while self.fetch_pending > 0 and not (self.abandoned or
                                                  self.complete):
                time.sleep(0.05)
        finally:
            if self.abandoned or self.error is not None:
                # both workers may be stuck inside a device call and
                # never consume the queued tail — release it here
                self._drain_fetch_q()
            for _ in range(nfetchers):
                self.fetch_q.put(None)

    def _drain_fetch_q(self):
        """Release the global in-flight accounting for dispatched
        batches nobody will consume (worker died / pool failed), so
        the counter can't leak and stall the NEXT pool's first
        dispatch in _chip_wait_idle.  Stops at the first sentinel and
        re-queues it for any still-alive sibling worker."""
        while True:
            try:
                item = self.fetch_q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                self.fetch_q.put(None)
                return
            _chip_dec()
            with self.q_lock:
                self.fetch_pending -= 1

    def _fetch_worker(self):
        while True:
            item = self.fetch_q.get()
            if item is None:
                return
            try:
                if _DEVICE_CHAIN:
                    self._fetch_chain(*item)
                else:
                    self._fetch_tokens(*item)
            except BaseException as e:  # noqa: BLE001
                if not (self.abandoned or self.complete):
                    self.fail(e)
                self._drain_fetch_q()
                return
            finally:
                _chip_dec()
                with self.q_lock:
                    self.fetch_pending -= 1

    def _fetch_tokens(self, ids, spans, outs, tele):
        """Blocking half of a batch: wait for the program + d2h copies,
        expand run tokens to BWT rows, queue entropy work."""
        tokens, raw, run_counts, primary = outs
        t0 = time.time()
        counts = np.asarray(run_counts)  # sync point: program + d2h
        prim = np.asarray(primary)
        tele["ready_s"] = round(time.time() - t0, 3)
        t1 = time.time()
        cap = tokens.shape[1] * 2
        tok = None
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            if self.is_stale(i):  # host steal-back beat us to it
                stale += 1
                continue
            n = span.data.size
            if counts[row] <= cap:
                if tok is None:
                    tok = np.asarray(tokens).view(np.uint16).reshape(
                        counts.shape[0], -1)
                # hand the run tokens straight to the C token-MTF: no
                # 900k byte-row expansion on the host
                brow = ("tok", tok[row, :counts[row]])
            else:  # near-incompressible row: fetch its raw bytes only
                brow = np.asarray(raw[row]).view(np.uint8)[:n]
            self.entropy_q.put((i, span, brow, int(prim[row])))
            fresh += 1
        tele["expand_s"] = round(time.time() - t1, 3)
        tele["done_t"] = round(time.time() - self.stats["t0"], 2)
        self.last_batch_t = time.time()
        self.lat_ema = tele["ready_s"] if not self.lat_ema else \
            0.5 * self.lat_ema + 0.5 * tele["ready_s"]
        self.stats["device_blocks"] += fresh
        self.stats["stale_rows"] += stale
        self.stats["device_batches"].append((fresh, tele["done_t"]))
        self.stats["batch_trace"].append(tele)

    def _fetch_chain(self, ids, spans, outs, tele):
        """Device-chain completion: entropy-code on device, download
        payloads; rows that overflow the pack capacity re-encode on
        the host via the entropy queue."""
        from lbzip2_tpu.ops.chain import chain_payloads
        bwt_dev, primary = outs
        t0 = time.time()
        ns = np.array([s.data.size for s in spans], np.int32)
        cmaps = np.stack([np.asarray(s.cmap, np.uint8) for s in spans])
        crcs = np.array(
            [(native.crc32_block(self.buf[s.start:s.end]) ^ 0xFFFFFFFF)
             & 0xFFFFFFFF for s in spans], np.uint32)
        # pad rows (batch longer than ids) replay row 0
        B = bwt_dev.shape[0]
        if B > len(spans):
            ns = np.concatenate([ns, np.repeat(ns[:1], B - len(spans))])
            cmaps = np.concatenate(
                [cmaps, np.repeat(cmaps[:1], B - len(spans), axis=0)])
            crcs = np.concatenate(
                [crcs, np.repeat(crcs[:1], B - len(spans))])
        stage_times: dict = {}
        payloads = chain_payloads(bwt_dev, ns, cmaps,
                                  np.asarray(primary, np.int32), crcs,
                                  self.cf, times=stage_times)
        tele["chain_stages"] = stage_times
        fresh = stale = 0
        for row, (i, span) in enumerate(zip(ids, spans)):
            if self.is_stale(i):
                stale += 1
                continue
            if payloads[row] is None:  # pack overflow: host re-encode
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))
            else:
                self.put_result(i, (payloads[row], int(crcs[row])))
            fresh += 1
        tele["ready_s"] = round(time.time() - t0, 3)
        tele["done_t"] = round(time.time() - self.stats["t0"], 2)
        self.last_batch_t = time.time()
        self.lat_ema = tele["ready_s"] if not self.lat_ema else \
            0.5 * self.lat_ema + 0.5 * tele["ready_s"]
        self.stats["device_blocks"] += fresh
        self.stats["stale_rows"] += stale
        self.stats["device_batches"].append((fresh, tele["done_t"]))
        self.stats["batch_trace"].append(tele)

    def _build_batch(self, ids):
        """Lyndon-prep ids into one padded (rows, bucket) batch;
        periodic and mid-size blocks route to the host immediately.

        The least rotation is written straight into the batch row
        (lyndon_prep's out buffer), so no block is copied twice."""
        t0 = time.time()
        eligible = []
        bucket = _BUCKETS[0]
        for i in ids:
            span = self.blocks[i]
            bucket_i = _bucket_for(span.data.size)
            if bucket_i is None:
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))  # host BWT
                continue
            eligible.append((i, span))
            bucket = max(bucket, bucket_i)
        if not eligible:
            return None
        # one compiled row count per bucket: the production bucket
        # always ships full-width batches (short end-of-stream claims
        # ride as pad rows); only the tiny CPU-test bucket keeps a cheap
        # 8-row shape
        nrows = 8 if (len(eligible) <= 8 and bucket == _BUCKETS[0]) \
            else _BATCH
        batch = np.zeros((nrows, bucket), np.uint8)
        ns = np.empty(nrows, np.int32)
        ms = np.empty(nrows, np.int32)
        kept = []
        row = 0
        for i, span in eligible:
            n = span.data.size
            _, m = native.lyndon_prep(span.data, out=batch[row, :n])
            if m < 0:  # fully periodic: host convention, reuse the row
                batch[row, :n] = 0
                self.unclaim(i)
                self.entropy_q.put((i, span, None, -1))
                continue
            ns[row] = n
            ms[row] = m
            kept.append((i, span))
            row += 1
        if not kept:
            return None
        for r in range(row, nrows):
            # pad rows replay row 0 (resolve identically)
            batch[r] = batch[0]
            ns[r] = ns[0]
            ms[r] = ms[0]
        tele = {"rows": len(kept), "shape": [nrows, bucket],
                "prep_s": round(time.time() - t0, 3),
                "t": round(time.time() - self.stats["t0"], 2)}
        return ([i for i, _ in kept], [span for _, span in kept],
                batch, ns, ms, tele)

    # --- host workers -----------------------------------------------------
    def _next_task(self):
        """Ordered scheduling policy: highest-priority available task,
        or None when the pool is finished.

        Static priority between task types (the reference's ordered
        task table, src/process.c:422-435 over compress.c:353-359),
        EDF within a type:
          1. entropy    — finish a device-BWT'd block (smallest id
                          first: feeds the in-order consumer and drains
                          device inventory)
          2. steal      — whole block from the tail of the shared queue
          3. steal_back — device-claimed block, gated by take_claimed's
                          streaming-grace (cold compile / outage only)
        Blocks (with a 1 s re-poll so the gates above are re-evaluated)
        when nothing is ready but work may still appear."""
        while True:
            item = self.entropy_q.get(block=False)
            if item is not None:
                return ("entropy", item)
            if _HOST_STEAL:
                i = self.take_tail()
                if i is not None:
                    return ("steal", i)
                if _STEALBACK and not self.device_done:
                    i = self.take_claimed()
                    if i is not None:
                        return ("steal_back", i)
            if self.device_done and self.entropy_q.empty():
                return None
            t = time.time()
            item = self.entropy_q.get(block=True, timeout=1.0)
            self.stats["host_idle_s"] += time.time() - t
            if item is not None:
                return ("entropy", item)

    def host_loop(self):
        try:
            while True:
                task = self._next_task()
                if task is None:
                    return
                kind, item = task
                if kind == "entropy":
                    self._do_entropy(item)
                else:  # steal / steal_back: whole-block host encode
                    self.stats["host_blocks"] += 1
                    self.put_result(item, _host_block(
                        self.buf, self.blocks[item], self.cf))
        except BaseException as e:  # noqa: BLE001
            self.fail(e)

    def _do_entropy(self, item):
        i, span, bwt_row, bidx = item
        if self.is_stale(i):  # another engine already produced it
            return
        if bwt_row is None:  # periodic block: full host encode
            self.put_result(i, _host_block(self.buf, span, self.cf))
        else:
            self.put_result(i, _entropy_payload(
                self.buf, span, bwt_row, bidx, self.cf))

    # --- driver -----------------------------------------------------------
    def run(self):
        threads = []
        if self.use_device:
            t = threading.Thread(target=self.device_loop,
                                 name="lbz2-device", daemon=True)
            t.start()
            threads.append(t)
        for w in range(self.host_workers):
            t = threading.Thread(target=self.host_loop,
                                 name=f"lbz2-host{w}", daemon=True)
            t.start()
            threads.append(t)
        # Watchdog: if the device engine stops delivering while blocks
        # it claimed are outstanding, requeue them as host work so the
        # stream always completes (the stuck engine's late duplicates,
        # if any, are discarded at pop time).  The 300 s default sits
        # above a cold compile; it is not measured on the H100.
        stall_s = float(os.environ.get("LBZ2_DEVICE_STALL_S", "300"))
        delivered = 0
        waited = 0.0
        seen = 0  # results observed at last stall check
        for i in range(len(self.blocks)):
            with self.res_cv:
                while i not in self.results and self.error is None:
                    self.res_cv.wait(timeout=5.0)
                    if i in self.results or self.error is not None:
                        break
                    progress = delivered + len(self.results)
                    if progress != seen:  # stream alive: reset clock
                        seen = progress
                        waited = 0.0
                        continue
                    waited += 5.0
                    if waited >= stall_s and not self.abandoned and \
                            self.claimed:
                        # order matters for liveness: stop new claims
                        # (abandoned), requeue the stuck work, and only
                        # then set device_done — a worker observing
                        # (device_done and empty queue) between these
                        # steps would exit with work still pending
                        self.abandoned = True
                        self.stats["abandoned"] = True
                        with self.q_lock:  # take_head mutates claimed
                            stuck = sorted(self.claimed)
                        for j in stuck:
                            self.entropy_q.put(
                                (j, self.blocks[j], None, -1))
                        self.device_done = True
                if self.error is not None:
                    raise self.error
            delivered += 1
            with self.res_cv:
                self.next_deliver = i + 1
                payload = self.results.pop(i)
            yield payload
        self.complete = True
        for t in threads:
            # a device thread still fetching (or stuck in a device
            # call) must not hold up a stream that is already whole;
            # every thread is a daemon and every late result is
            # discarded as stale, so a short grace join suffices
            t.join(timeout=None if not self.use_device else 2.0)
        if self.error is not None:
            raise self.error


def warm_device(rows=(_BATCH,), bucket: int = _BUCKETS[-1]) -> float:
    """Pre-compile the device programs for the production shapes.

    A stream shorter than the cold compile finishes on the host before
    the first device batch lands, so a caller that times the engine
    warms it outside the timed window.  Returns seconds spent.
    """
    import jax
    from lbzip2_tpu.ops.bwt2 import bwt2_bytes, bwt2_tokens
    global _warmed
    check_device_backend()
    t0 = time.time()
    for r in sorted(set(rows)):
        batch = np.zeros((r, bucket), np.uint8)
        batch[:, -1] = 1  # genuine Lyndon rows: R = 0^(n-1) 1, least rotation
        ns = np.full(r, 4, np.int32)
        ms = np.zeros(r, np.int32)
        fn = bwt2_bytes if _DEVICE_CHAIN else bwt2_tokens
        outs = fn(jax.device_put(batch), jax.device_put(ns),
                  jax.device_put(ms))
        np.asarray(outs[-1])  # block until the program really ran
        if _DEVICE_CHAIN:
            # compile the whole entropy chain too (chain_mtf2,
            # em_chain, pack_groups, flatten): shape-dependent only,
            # so tiny Lyndon rows warm the production programs
            from lbzip2_tpu.ops.chain import chain_payloads
            cmaps = np.zeros((r, 256), np.uint8)
            cmaps[:, :2] = 1
            crcs = np.zeros(r, np.uint32)
            chain_payloads(outs[0], ns, cmaps,
                           np.asarray(outs[1], np.int32), crcs)
            # also compile the full-width pack (near-incompressible
            # batches) so no shape ever cold-compiles mid-stream
            chain_payloads(outs[0], ns, cmaps,
                           np.asarray(outs[1], np.int32), crcs,
                           _force_full_pack=True)
    _warmed = True
    return time.time() - t0


def check_device_backend() -> None:
    """Refuse to run the device engine where JAX found no accelerator.

    Without a GPU, JAX would run the device programs on XLA:CPU and the
    engine would look alive while the host did all the work.  That is
    allowed only when JAX_PLATFORMS names cpu explicitly (the tests).
    Also points JAX at the compile cache before the first compile."""
    import jax

    from lbzip2_tpu import compile_cache
    explicit = os.environ.get("JAX_PLATFORMS", "").split(",")
    if jax.default_backend() == "cpu" and "cpu" not in explicit:
        raise RuntimeError(
            "device engine: JAX found no accelerator (backend cpu); set "
            "JAX_PLATFORMS=cpu to run the device programs on the CPU "
            "deliberately, or LBZ2_DEVICE=0 for the host engine")
    compile_cache.enable_for_device()


def compress_blocks_hybrid(data: bytes | np.ndarray, level: int = 9,
                           cluster_factor: int = CLUSTER_FACTOR,
                           sequential_split: bool = False,
                           entropy_workers: int | None = None,
                           use_device: bool | None = None
                           ) -> tuple[list[bytes], list[int]]:
    """Encode all blocks with the hybrid device+host pool; returns
    (payloads, stored block CRCs) in block order — the building block
    for both the stream assembler below and the multihost driver
    (each process runs its own engine over its shard)."""
    assert 1 <= level <= 9
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(
            data, dtype=np.uint8)
    mbs = level * 100000

    if native.native_available():
        # arena views: the spans live only for this call; skips a
        # full-stream copy plus the fresh-allocation page-fault tax
        # (~3.5 s on a 1 GB stream, paid inside the timed pipeline)
        blocks = [rle1.BlockSpan(a, b, blk, cmap) for a, b, blk, cmap in
                  native.rle1_collect(buf, mbs,
                                      None if sequential_split else mbs,
                                      reuse_arena=True)]
    else:
        blocks = rle1.rle1_blocks(buf, mbs,
                                  None if sequential_split else -1)
    if entropy_workers is None:
        entropy_workers = max(2, os.cpu_count() or 2)
    if use_device is None:
        use_device = _DEVICE and native.native_available()
    elif use_device and not native.native_available():
        raise RuntimeError("device engine needs the C host kernels "
                           "(gcc); none could be built")
    if use_device:
        check_device_backend()

    pool = _WorkPool(buf, blocks, cluster_factor, entropy_workers,
                     use_device)
    global last_stats
    last_stats = pool.stats  # telemetry: engine split of the last call
    payloads = []
    crcs = []
    for payload, crc_stored in pool.run():
        payloads.append(payload)
        crcs.append(crc_stored)
    return payloads, crcs


def compress(data: bytes | np.ndarray, level: int = 9,
             cluster_factor: int = CLUSTER_FACTOR,
             sequential_split: bool = False,
             entropy_workers: int | None = None,
             use_device: bool | None = None) -> bytes:
    """Compress into a .bz2 stream using the hybrid device+host pool.

    Bit-identical to ref.encoder.compress (and the reference binary).
    """
    payloads, crcs = compress_blocks_hybrid(
        data, level, cluster_factor, sequential_split, entropy_workers,
        use_device)
    parts = [bytes([0x42, 0x5A, 0x68, 0x30 + level])]
    combined = 0
    for payload, crc_stored in zip(payloads, crcs):
        parts.append(payload)
        combined = crc32.combine_crc(combined, crc_stored)

    trailer = bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90]) + \
        combined.to_bytes(4, "big")
    parts.append(trailer)
    return b"".join(parts)
