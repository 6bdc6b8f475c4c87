"""Seeded synthetic corpora: the repository's only test and smoke input.

Nothing here reads a file: every byte comes from numpy's PCG64 seeded
by the caller, so the device-path tests, chip_smoke.py and bench.py
run the same data everywhere.

  text(n, seed)    English-like prose: a Zipf-ranked pseudo-word
                   vocabulary with punctuation and line breaks
  binary(n, seed)  executable-like pages: skewed opcode bytes, small
                   little-endian int tables and zero padding
  markup(n, seed)  XML-ish records
  runs(n, seed)    long byte runs (RLE1-heavy, deep BWT ties)
  repeats(n, seed) a text sample repeated ~24 times with sparse byte
                   edits: long BWT runs, so its run tokens fit N // 4
  noise(n, seed)   incompressible bytes
  mixed(n, seed)   text 50%, binary 25%, markup 15%, noise 10%,
                   shuffled in 4 KiB pages so every 900k block sees a
                   mix of classes
"""

from __future__ import annotations

import numpy as np

_SYL = (b"th e an re on in er st al ing ed ou it co de pro ti ve ar le "
        b"se ma ne ra to us ly io ex un wh sh ch qu").split()
_SEP = (b" ", b" ", b" ", b" ", b" ", b" ", b" ", b", ", b". ", b".\n",
        b"\n", b"; ", b" (", b") ")
PAGE = 4096


def _tokens(rng, vocab, probs, n):
    """Concatenate tokens drawn from vocab with probabilities probs
    until n bytes; vectorised gather over one flat buffer."""
    lens = np.array([len(w) for w in vocab], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    k = int(n / max(1.0, float(lens @ probs))) + 64
    ids = rng.choice(len(vocab), k, p=probs)
    ln = lens[ids]
    ends = np.cumsum(ln)
    k = int(np.searchsorted(ends, n)) + 1
    ids, ln, ends = ids[:k], ln[:k], ends[:k]
    pos = np.arange(ends[-1]) - np.repeat(ends - ln - offs[ids], ln)
    return flat[pos][:n].tobytes()


def text(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    syl = np.array(_SYL, dtype=object)
    words = sorted({b"".join(rng.choice(syl, int(rng.integers(1, 4))))
                    for _ in range(3000)})
    rng.shuffle(words)
    wp = 1.0 / np.arange(1, len(words) + 1)
    sp = np.array([8.0] * 7 + [1.0] * (len(_SEP) - 7))
    # one token per (word, separator) pair: Zipf words, mostly spaces
    vocab = [w + s for w in words for s in _SEP]
    probs = (wp[:, None] * sp[None, :]).reshape(-1)
    return _tokens(rng, vocab, probs / probs.sum(), n)


def binary(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    npages = (n + PAGE - 1) // PAGE
    p = 1.0 / np.arange(1, 257) ** 1.2
    p /= p.sum()
    perm = rng.permutation(256).astype(np.uint8)
    code = perm[rng.choice(256, npages * PAGE, p=p)]
    ints = rng.integers(0, 4096, npages * PAGE // 4).astype("<u4").view(
        np.uint8)
    kind = rng.integers(0, 8, npages)   # 0-4 code, 5-6 tables, 7 zeros
    pages = np.where((kind < 5)[:, None], code.reshape(npages, PAGE),
                     ints.reshape(npages, PAGE))
    pages[kind == 7] = 0
    return pages.reshape(-1)[:n].tobytes()


def markup(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    keys = text(1 << 16, seed + 1).split()[:512] or [b"k"]
    out, total, i = [], 0, 0
    while total < n:
        rec = b'<rec id="%d"><k>%s</k><v>%d</v></rec>\n' % (
            i, keys[int(rng.integers(len(keys)))],
            int(rng.integers(1 << 30)))
        out.append(rec)
        total += len(rec)
        i += 1
    return b"".join(out)[:n]


def runs(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    k = n // 8 + 16
    vals = rng.integers(0, 256, k, dtype=np.uint8)
    lens = rng.geometric(1 / 24, k)
    return np.repeat(vals, lens)[:n].tobytes().ljust(n, b"\0")


def repeats(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    unit = np.frombuffer(text(max(64, n // 24), seed), np.uint8)
    out = np.resize(unit, n)
    k = n // 4096 + 1
    out[rng.integers(0, n, k)] = rng.integers(0, 256, k, dtype=np.uint8)
    return out.tobytes()


def noise(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def mixed(n: int, seed: int = 0) -> bytes:
    parts = [gen(int(n * share) + PAGE, seed + i) for i, (gen, share) in
             enumerate(((text, 0.50), (binary, 0.25), (markup, 0.15),
                        (noise, 0.10)))]
    blob = np.frombuffer(b"".join(parts), np.uint8)
    npages = blob.size // PAGE
    order = np.random.default_rng(seed).permutation(npages)
    out = blob[:npages * PAGE].reshape(npages, PAGE)[order].reshape(-1)
    return out[:n].tobytes()
