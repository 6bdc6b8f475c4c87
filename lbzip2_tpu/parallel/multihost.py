"""Multi-host compression: jax.distributed + DCN reassembly on host 0.

The reference's pthread pipeline is single-machine; the scaling axis
here (SURVEY §2 communication backend) is: one JAX process per host,
each host compresses an input shard (window-aligned so block
boundaries match the single-host result), and host 0 reassembles
payloads in stream order and folds the combined CRC.

One process per host, never two: a JAX process reserves most of each
card's memory when it first uses it, so a second process on the same
host fails for want of device memory.  That process drives all of its
host's local cards (the device engine round-robins them).

Payload exchange is point-to-point: workers stream their (ragged)
payloads straight to a reassembly socket on host 0, so the wire
carries O(total payload) bytes — only host 0 needs the data, and no
process pads to the global max.  The padded process_allgather survives
as a fallback (LBZ2_MULTIHOST_EXCHANGE=allgather, or when no
coordinator address is known to locate host 0).

Runs unchanged with a single process (the exchange degenerates to
identity), which is how CI exercises it; multi-host runs call
``initialize_distributed`` first.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from lbzip2_tpu.core import crc32

_P2P_PORT = int(os.environ.get("LBZ2_MULTIHOST_PORT", "29747"))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host run."""
    import jax
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def shard_bounds(total_size: int, level: int, num_processes: int,
                 process_id: int) -> tuple[int, int]:
    """Window-aligned input shard for this process.

    Shards are multiples of in_granul (= level*100000) so every process
    produces exactly the blocks the single-host encoder would."""
    granul = level * 100000
    windows = (total_size + granul - 1) // granul
    per = (windows + num_processes - 1) // num_processes
    a = min(process_id * per * granul, total_size)
    b = min((process_id + 1) * per * granul, total_size)
    return a, b


def compress_multihost(shard: bytes | np.ndarray, level: int = 9,
                       n_workers: int | None = None,
                       engine: str | None = None) -> bytes | None:
    """Compress this host's (window-aligned) shard and reassemble on
    host 0.  Returns the full stream on process 0, None elsewhere.

    engine: "hybrid" drives the production device+host pool
    (codec.encoder) per process — each host's engine round-robins its
    local devices; "host" uses the C-only pipeline; None (default)
    reads LBZ2_MULTIHOST_ENGINE (default "hybrid" — the multi-host
    composition the reference's one-machine pool cannot express)."""
    import jax
    from jax.experimental import multihost_utils

    from lbzip2_tpu.parallel.encode import compress_blocks

    if engine is None:
        engine = os.environ.get("LBZ2_MULTIHOST_ENGINE", "hybrid")

    buf = np.frombuffer(bytes(shard), np.uint8) if not isinstance(
        shard, np.ndarray) else shard
    if engine == "hybrid":
        from lbzip2_tpu.codec.encoder import compress_blocks_hybrid
        block_payloads, crcs = compress_blocks_hybrid(
            buf, level, entropy_workers=n_workers)
    else:
        block_payloads, crcs = compress_blocks(buf, level,
                                               n_workers=n_workers)
    payload = b"".join(block_payloads)

    nproc = jax.process_count()
    if nproc == 1:
        return _assemble([payload], [crcs], level)

    pid = jax.process_index()
    host0 = _host0_address()
    if host0 is not None and \
            os.environ.get("LBZ2_MULTIHOST_EXCHANGE", "p2p") == "p2p":
        got = _gather_to_zero(payload, list(crcs), pid, nproc, host0)
        if pid != 0:
            return None
        payloads, crclists = got
        return _assemble(payloads, crclists, level)

    # Fallback: padded allgather over DCN collectives (O(P*max) wire).
    ln = np.asarray([len(payload)], np.int64)
    all_len = np.asarray(multihost_utils.process_allgather(ln)).reshape(-1)
    maxlen = int(all_len.max())
    padded = np.zeros(maxlen, np.uint8)
    padded[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    ncrc = np.asarray([len(crcs)], np.int64)
    all_ncrc = np.asarray(multihost_utils.process_allgather(ncrc)).reshape(-1)
    maxc = int(max(1, all_ncrc.max()))
    cpad = np.zeros(maxc, np.uint32)
    cpad[:len(crcs)] = np.asarray(crcs, np.uint32)
    gcrcs = np.asarray(multihost_utils.process_allgather(cpad))

    if jax.process_index() != 0:
        return None
    payloads = [gathered[p, :all_len[p]].tobytes() for p in range(nproc)]
    crclists = [gcrcs[p, :all_ncrc[p]].tolist() for p in range(nproc)]
    return _assemble(payloads, crclists, level)


def _host0_address() -> str | None:
    """Host running process 0 (where the jax.distributed coordinator
    lives), or an explicit LBZ2_HOST0_ADDR override."""
    addr = os.environ.get("LBZ2_HOST0_ADDR")
    if addr:
        return addr
    try:
        from jax._src.distributed import global_state
        caddr = global_state.coordinator_address
        if caddr:
            return caddr.rsplit(":", 1)[0]
    except Exception:  # noqa: BLE001 — fall back to allgather
        pass
    return None


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = conn.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def _gather_to_zero(payload: bytes, crcs: list[int], pid: int,
                    nproc: int, host0: str, timeout_s: float = 600.0):
    """Point-to-point ragged gather: every worker streams
    (pid, payload, crcs) to a TCP socket on host 0; total wire traffic
    is O(sum of payloads).  Returns (payloads, crclists) in process
    order on process 0, None elsewhere."""
    hdr = struct.Struct("<qqq")  # pid, payload_len, ncrc
    if pid == 0:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("", _P2P_PORT))
        srv.listen(nproc)
        srv.settimeout(timeout_s)
        payloads: list[bytes | None] = [None] * nproc
        crclists: list[list[int] | None] = [None] * nproc
        payloads[0] = payload
        crclists[0] = crcs
        try:
            remaining = nproc - 1
            while remaining:
                conn, _ = srv.accept()
                with conn:
                    p, plen, ncrc = hdr.unpack(
                        _recv_exact(conn, hdr.size))
                    payloads[p] = _recv_exact(conn, plen)
                    crclists[p] = np.frombuffer(
                        _recv_exact(conn, 4 * ncrc),
                        np.uint32).tolist()
                remaining -= 1
        finally:
            srv.close()
        return payloads, crclists
    # worker: connect (host 0 may not be listening yet: retry)
    deadline = time.time() + timeout_s
    last = None
    while True:
        try:
            conn = socket.create_connection((host0, _P2P_PORT),
                                            timeout=10.0)
            break
        except OSError as e:  # noqa: PERF203
            last = e
            if time.time() > deadline:
                raise TimeoutError(
                    f"cannot reach host 0 at {host0}:{_P2P_PORT}"
                ) from last
            time.sleep(0.2)
    with conn:
        conn.sendall(hdr.pack(pid, len(payload), len(crcs)))
        conn.sendall(payload)
        conn.sendall(np.asarray(crcs, np.uint32).tobytes())
    return None


def _assemble(payloads: list[bytes], crclists: list[list[int]],
              level: int) -> bytes:
    combined = 0
    for crcs in crclists:
        for c in crcs:
            combined = crc32.combine_crc(combined, c)
    return (bytes([0x42, 0x5A, 0x68, 0x30 + level]) + b"".join(payloads)
            + bytes([0x17, 0x72, 0x45, 0x38, 0x50, 0x90])
            + combined.to_bytes(4, "big"))
