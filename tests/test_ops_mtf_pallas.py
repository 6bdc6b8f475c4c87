"""MTF rank kernels vs a sequential list MTF: the Pallas-Triton kernel
(interpret mode on the CPU) and the lax.scan formulation."""

import jax
import numpy as np
import pytest

from lbzip2_tpu.ops.mtf import mtf_ranks
from lbzip2_tpu.ops.mtf_triton import CHUNK, mtf_ranks_rows_triton


def _list_ranks(syms):
    """Rank of each symbol in a move-to-front list that starts 0..255."""
    order = list(range(256))
    out = []
    for c in syms:
        r = order.index(c)
        out.append(r)
        del order[r]
        order.insert(0, c)
    return out


def _rows(seed, n, hi, N=2048):
    rng = np.random.default_rng(seed)
    ns = np.array([n, n // 2], np.int32)
    syms = np.zeros((2, N), np.int32)
    for b in range(2):
        syms[b, :ns[b]] = rng.integers(0, hi, ns[b])
    want = np.zeros((2, N), np.int32)
    for b in range(2):
        want[b, :ns[b]] = _list_ranks(syms[b, :ns[b]].tolist())
    return syms, ns, want


@pytest.mark.parametrize("seed,n,hi", [
    (0, 256, 4), (1, 1000, 256), (2, 2048, 16), (3, 700, 2),
])
def test_pallas_mtf_matches(seed, n, hi):
    syms, ns, want = _rows(seed, n, hi)
    got = np.asarray(mtf_ranks_rows_triton(syms, ns, interpret=True))
    np.testing.assert_array_equal(got, want)
    scan = np.stack([np.asarray(mtf_ranks(syms[b], ns[b]))
                     for b in range(2)])
    np.testing.assert_array_equal(scan, want)


@pytest.mark.parametrize("period", [CHUNK, 3 * CHUNK + 5])
def test_triton_mtf_chunk_sizes(period):
    """The carried last[] vector crosses chunk boundaries: rows many
    CHUNKs long where each symbol recurs only `period` lanes later, so
    most ranks read a last occurrence from an earlier chunk."""
    N = 64 * CHUNK
    ns = np.array([N, N - 7], np.int32)
    rng = np.random.default_rng(period)
    syms = np.zeros((2, N), np.int32)
    want = np.zeros((2, N), np.int32)
    for b in range(2):
        cycle = rng.permutation(256)[:period % 256 or 256]
        syms[b, :ns[b]] = np.resize(cycle, ns[b])
        want[b, :ns[b]] = _list_ranks(syms[b, :ns[b]].tolist())
    got = np.asarray(mtf_ranks_rows_triton(syms, ns, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_chain_picks_scan_off_gpu():
    """On the CPU the chain traces the lax.scan MTF (no pallas_call)."""
    from lbzip2_tpu.ops import chain
    syms, ns, _ = _rows(5, 512, 8)
    jaxpr = jax.make_jaxpr(chain._mtf_ranks_rows)(syms, ns)
    assert "pallas_call" not in str(jaxpr)
    assert "scan" in str(jaxpr)
