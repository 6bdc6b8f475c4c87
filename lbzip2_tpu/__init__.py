"""lbzip2_tpu — a bzip2-compatible parallel compressor with JAX device kernels.

A from-scratch reimplementation of the capabilities of lbzip2 (C99,
pthreads) whose per-block work runs as JAX device programs on a GPU:

- per-block codec kernels (RLE1, BWT suffix sort, MTF+RLE2, multi-table
  canonical Huffman with EM clustering, big-endian bit packing, CRC32)
  implemented as JAX/XLA device programs (one Pallas-Triton kernel, the
  MTF) and C host kernels, with a spec-exact
  sequential reference implementation (``lbzip2_tpu.ref``) serving as the
  correctness oracle (the analogue of the reference's tests/minbzcat.c);
- a sharded block scheduler that data-parallelizes independent bzip2 blocks
  across the cards and hosts of a device mesh with in-order gather and
  combined
  stream CRCs (the analogue of the reference's pthread pipeline,
  src/process.c + src/compress.c/expand.c);
- a speculative-scan parallel decoder (analogue of src/parse.c scan());
- an lbzip2-compatible CLI (lbzip2/lbunzip2/lbzcat personalities).
"""

__version__ = "0.1.0"

from lbzip2_tpu.core import constants  # noqa: F401
