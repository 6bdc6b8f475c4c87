"""chip_smoke.py's phases at the 8192 bucket on the CPU, its refusal to
run without a GPU, and (marked chip) the full-width kernel phase."""

import numpy as np
import pytest

import chip_smoke
from lbzip2_tpu import native
from lbzip2_tpu.parallel.encode import compress_parallel
from tests import corpus

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


def test_make_blocks_seeded():
    a = chip_smoke.make_blocks(8, 7000, 8100, 3)
    b = chip_smoke.make_blocks(8, 7000, 8100, 3)
    assert [k for k, _ in a] == list(chip_smoke._KINDS)
    for (ka, xa), (kb, xb) in zip(a, b):
        assert ka == kb and np.array_equal(xa, xb)
        assert 7000 <= xa.size <= 8100


def test_phase_kernels_small_bucket():
    st = chip_smoke.phase_kernels(rows=8, bucket=8192, seed=1,
                                  n_range=(7000, 8100))
    assert st["bwt_dev"].shape == (8, 8192)
    assert len(st["payloads"]) == 8


def test_phase_main_small_block():
    """The no-steal variant: deterministic at one 8 KB block (in the
    hybrid the host may take that block before the device claims it)."""
    data = corpus.mixed(6000, 2)
    want = compress_parallel(data, 9)
    assert chip_smoke.phase_main(data, want, host_steal=False) == want


def test_phase_main_rejects_wrong_stream():
    data = corpus.text(5000, 3)
    with pytest.raises(AssertionError, match="differs from host-only"):
        chip_smoke.phase_main(data, b"BZh9", host_steal=False)


def test_phase_decode_small():
    chip_smoke.phase_decode(corpus.mixed(250_000, 4), level=1, nblocks=2)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "needs 1 GPU" in out.err
    assert out.out == ""


@pytest.mark.chip
def test_phase_kernels_full_width(gpu):
    chip_smoke.phase_kernels()
