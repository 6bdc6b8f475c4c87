"""Multi-chip block parallelism: shard_map over a 1-D device mesh.

lbzip2's primary parallel axis is independent bzip2 blocks across worker
threads (SURVEY §2 "parallelism strategies" #1, src/compress.c).  The
device mapping is data parallelism over a 1-D `blocks` mesh axis (the
cards of a host are joined all to all, so the mesh follows the
algorithm alone): a batch of padded blocks is sharded across cards,
each card runs the block kernels on its shard, and results are
gathered in block order on the host (the reorder stage).  No
collectives are needed in the compute path — ordering and stream CRC
folding happen host-side.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _block_stage(block: jnp.ndarray, n: jnp.ndarray):
    """Per-block device stage: BWT + MTF ranks (+ symbol histogram)."""
    from lbzip2_tpu.ops.bwt import bwt_masked
    from lbzip2_tpu.ops.mtf import mtf_ranks

    bwt_out, idx = bwt_masked(block, n)
    # Compact symbols on device: map via the block's own used-byte set.
    hist = jnp.bincount(block.astype(jnp.int32), length=256)
    used = hist > 0
    # Padding zeros inflate hist[0]; a byte is "used" iff it appears in
    # block[:n].  Correct by checking hist[0] against padding count.
    pad = block.shape[0] - n
    used = used.at[0].set(hist[0] > pad)
    cmap = jnp.cumsum(used.astype(jnp.int32)) - used.astype(jnp.int32)
    syms = cmap[bwt_out.astype(jnp.int32)]
    ranks = mtf_ranks(syms, n)
    return bwt_out, idx, ranks


def sharded_encode_step(mesh: Mesh, axis: str = "blocks"):
    """Build the pjit'd sharded block-encode step for `mesh`.

    Input batch (B, N) uint8 and lengths (B,) are sharded along B;
    outputs keep the same sharding; host gathers in order.
    """
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis, None)),
        check_vma=False)
    def step(blocks, ns):
        return jax.vmap(_block_stage)(blocks, ns)

    return jax.jit(step)


def sharded_encode_step_v2(mesh: Mesh, axis: str = "blocks"):
    """Sharded production BWT (ops.bwt2 suffix doubling): blocks, row
    lengths, and least-rotation offsets shard along B; each device
    loops its own shard to convergence (no collectives in the compute
    path).  Returns (int32-packed BWT rows, primary indices)."""
    from lbzip2_tpu.ops.bwt2 import bwt2_full

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis)),
        check_vma=False)
    def step(blocks, ns, ms):
        return bwt2_full(blocks, ns, ms)

    return jax.jit(step)


def sharded_encode_step_tokens(mesh: Mesh, axis: str = "blocks"):
    """Sharded production BWT with the run-token emit (the single-card
    download format, ops/bwt2.py emit2).  Each device loops
    its own shard to convergence; no collectives in the compute path.
    Returns (tokens (B, T) uint32-packed u16 pairs, raw-packed rows,
    run counts, primary indices), all sharded along B."""
    from lbzip2_tpu.ops.bwt2 import bwt2_tokens

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis), P(axis)),
        check_vma=False)
    def step(blocks, ns, ms):
        return bwt2_tokens(blocks, ns, ms)

    return jax.jit(step)


def encode_batch_sharded_tokens(blocks: np.ndarray, ns: np.ndarray,
                                ms: np.ndarray,
                                mesh: Mesh | None = None):
    """Sharded token-emit BWT; returns (tokens u16 (B, 2T), counts,
    raw rows (B, N) uint8, primary) on host."""
    if mesh is None:
        mesh = make_mesh()
    naxis = mesh.devices.size
    B = blocks.shape[0]
    padB = (-B) % naxis
    if padB:
        blocks = np.concatenate([blocks, np.tile(blocks[:1], (padB, 1))])
        ns = np.concatenate([ns, np.repeat(ns[:1], padB)])
        ms = np.concatenate([ms, np.repeat(ms[:1], padB)])
    step = sharded_encode_step_tokens(mesh)
    tokens, raw, counts, primary = step(
        jax.device_put(blocks, NamedSharding(mesh, P("blocks", None))),
        jax.device_put(np.asarray(ns, np.int32),
                       NamedSharding(mesh, P("blocks"))),
        jax.device_put(np.asarray(ms, np.int32),
                       NamedSharding(mesh, P("blocks"))))
    tok = np.asarray(tokens).view(np.uint16).reshape(tokens.shape[0], -1)
    rawb = np.asarray(raw).view(np.uint8).reshape(raw.shape[0], -1)
    return (tok[:B], np.asarray(counts)[:B], rawb[:B],
            np.asarray(primary)[:B])


def encode_batch_sharded_v2(blocks: np.ndarray, ns: np.ndarray,
                            ms: np.ndarray, mesh: Mesh | None = None):
    """Sharded v2 BWT; returns ((B, N) uint8 BWT rows, primary) on host."""
    if mesh is None:
        mesh = make_mesh()
    naxis = mesh.devices.size
    B = blocks.shape[0]
    padB = (-B) % naxis
    if padB:
        blocks = np.concatenate(
            [blocks, np.tile(blocks[:1], (padB, 1))])
        ns = np.concatenate([ns, np.repeat(ns[:1], padB)])
        ms = np.concatenate([ms, np.repeat(ms[:1], padB)])
    step = sharded_encode_step_v2(mesh)
    packed, primary = step(
        jax.device_put(blocks, NamedSharding(mesh, P("blocks", None))),
        jax.device_put(np.asarray(ns, np.int32),
                       NamedSharding(mesh, P("blocks"))),
        jax.device_put(np.asarray(ms, np.int32),
                       NamedSharding(mesh, P("blocks"))))
    out = np.asarray(packed).view(np.uint8).reshape(packed.shape[0], -1)
    return out[:B], np.asarray(primary)[:B]


def sharded_decode_step(mesh: Mesh, axis: str = "blocks"):
    """Sharded batched inverse-BWT: the device half of the expansion
    pipeline (retrieve stays host/native; IBWT list-ranking on chips)."""
    from lbzip2_tpu.ops.ibwt import ibwt_masked

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=P(axis, None),
        check_vma=False)
    def step(bwts, ns, idxs):
        return jax.vmap(ibwt_masked)(bwts, ns, idxs)

    return jax.jit(step)


def decode_batch_sharded(bwts: np.ndarray, ns: np.ndarray,
                         idxs: np.ndarray, mesh: Mesh | None = None):
    """Run the sharded IBWT; returns host numpy plain-byte blocks."""
    if mesh is None:
        mesh = make_mesh()
    naxis = mesh.devices.size
    B = bwts.shape[0]
    padB = (-B) % naxis
    if padB:
        bwts = np.concatenate(
            [bwts, np.zeros((padB,) + bwts.shape[1:], bwts.dtype)])
        ns = np.concatenate([ns, np.ones(padB, ns.dtype)])
        idxs = np.concatenate([idxs, np.zeros(padB, idxs.dtype)])
    step = sharded_decode_step(mesh)
    out = step(
        jax.device_put(bwts, NamedSharding(mesh, P("blocks", None))),
        jax.device_put(ns, NamedSharding(mesh, P("blocks"))),
        jax.device_put(idxs, NamedSharding(mesh, P("blocks"))))
    return np.asarray(out)[:B]


def encode_batch_sharded(blocks: np.ndarray, ns: np.ndarray,
                         mesh: Mesh | None = None):
    """Run the sharded encode stage; returns host numpy arrays in order."""
    if mesh is None:
        mesh = make_mesh()
    naxis = mesh.devices.size
    B = blocks.shape[0]
    padB = (-B) % naxis
    if padB:
        blocks = np.concatenate(
            [blocks, np.zeros((padB,) + blocks.shape[1:], blocks.dtype)])
        ns = np.concatenate([ns, np.ones(padB, ns.dtype)])
    step = sharded_encode_step(mesh)
    sharding = NamedSharding(mesh, P("blocks", None))
    blocks_d = jax.device_put(blocks, sharding)
    ns_d = jax.device_put(ns, NamedSharding(mesh, P("blocks")))
    bwt_out, idx, ranks = step(blocks_d, ns_d)
    return (np.asarray(bwt_out)[:B], np.asarray(idx)[:B],
            np.asarray(ranks)[:B])
