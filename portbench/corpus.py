"""Inputs the benchmark makes from a seed: the mixed corpus and the edge
cases of the LZS format.

``make_corpus`` and ``selftest_cases`` are copies of ``bench.py``'s, kept
here so that a change to the program cannot move the yardstick;
``portbench/tests/test_portbench_corpus.py`` pins both by SHA-256.
``make_corpus(1 << 23)`` at its default seed hashes to ``CORPUS_SHA``.

The cells read ``make_file``: the same mix, with its plan (the vocabulary,
and each piece's kind and size) fixed and only the contents (which words,
which bytes) drawn from the seed, so that every seed gives the codec the
same amount of work.
"""

from __future__ import annotations

import numpy as np

# SHA-256 of make_corpus(1 << 23) at seed 2026
CORPUS_SHA = "2a852df4b8f7fa933e24ac6b21bfc0769e6e58a72db998cf64fe84f12536ead1"


def make_corpus(size: int, seed: int = 2026) -> bytes:
    """Deterministic self-contained corpus (no external files)."""
    rng = np.random.default_rng(seed)
    # pseudo-text: Zipfian draws from a generated vocabulary
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz_", np.uint8)
    vocab = [bytes(rng.choice(letters, rng.integers(2, 12)))
             for _ in range(400)]
    ranks = 1.0 / np.arange(1, len(vocab) + 1)
    probs = ranks / ranks.sum()
    parts = []
    total = 0
    while total < size:
        k = rng.integers(0, 10)
        if k < 5:  # text
            words = rng.choice(len(vocab), rng.integers(300, 3000), p=probs)
            piece = b" ".join(vocab[w] for w in words)
        elif k < 7:  # RLE runs
            piece = bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(50, 4000))
        elif k < 9:  # structured records with shared 12-byte prefixes
            rec = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            piece = b"".join(
                rec[:12] + bytes([int(rng.integers(0, 256))]) * 4
                for _ in range(int(rng.integers(20, 200))))
        else:  # incompressible
            piece = bytes(rng.integers(0, 256, int(rng.integers(500, 5000)),
                                       dtype=np.uint8))
        parts.append(piece)
        total += len(piece)
    return b"".join(parts)[:size]


def selftest_cases() -> list[bytes]:
    """Adversarial parity cases for the COMPILED on-chip kernels.

    Mirrors the reference's four decoder harnesses and closed-form
    property tests (test-lzs.c:93-167, test-lzs-decompression.c:106-290)
    plus the failure shapes found during development: steal-heavy small
    alphabets, RLE run ends, deep overlapped-copy chains, the exact
    window limit, and block-capacity edges.
    """
    rng = np.random.default_rng(404)
    cases: list[bytes] = [b"", b"A", b"AB", b"ABAB" * 3]
    # repeated-byte closed-form family (extension-nibble chains + RLE)
    for k in (1, 7, 8, 9, 22, 23, 37, 300, 2047, 2048, 4095, 4096):
        cases.append(b"X" * k)
    # no-repeated-2-gram sequence: literals only, exact 9/8 expansion
    seq = bytearray()
    for i in range(1, 250):
        seq += bytes([0, i])
    cases.append(bytes(seq[:506]))
    # steal-heavy tiny alphabets and periodic data with perturbed tails
    for a in (2, 3, 4):
        cases.append(bytes(rng.integers(97, 97 + a, 4000,
                                        dtype=np.uint8)))
    cases.append((b"abcdefg" * 600)[:4000])
    cases.append((b"ab" * 2000)[:3999] + b"Q")
    # RLE run ends followed by near-miss tails
    cases.append(b"Q" * 2000 + b"QRQS" * 20 + b"Q" * 100)
    cases.append(b"\x00" * 3000 + b"\x01" + b"\x00" * 1000)
    # window-limit pins: match at exactly 2047, miss at 2048
    probe = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    cases.append(probe + b"\xAA" * (2047 - len(probe)) + probe)
    cases.append(probe + b"\xAA" * (2048 - len(probe)) + probe)
    # deep overlapped-copy chains (offset < length, repeated extension)
    cases.append(b"zy" + b"zy" * 1800)
    cases.append(b"abc" + b"abc" * 1300 + b"abd")
    # structured records with shared 12-byte prefixes (plateau chains)
    rec = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    cases.append(b"".join(
        rec[:12] + bytes([int(v)]) * 4
        for v in rng.integers(0, 256, 200)))
    # incompressible and mixed
    cases.append(bytes(rng.integers(0, 256, 4096, dtype=np.uint8)))
    cases.append(bytes(rng.integers(0, 256, 4093, dtype=np.uint8)))
    for _ in range(12):
        parts, total = [], 0
        while total < 3500:
            k = int(rng.integers(0, 4))
            if k == 0:
                parts.append(bytes([int(rng.integers(0, 256))])
                             * int(rng.integers(1, 400)))
            elif k == 1:
                parts.append(bytes(rng.integers(97, 103,
                                                int(rng.integers(10, 600)),
                                                dtype=np.uint8)))
            elif k == 2 and parts:
                prev = b"".join(parts)
                parts.append(prev[:int(rng.integers(0, min(len(prev),
                                                           900) + 1))])
            else:
                parts.append(bytes(rng.integers(0, 256,
                                                int(rng.integers(1, 300)),
                                                dtype=np.uint8)))
            total = sum(map(len, parts))
        cases.append(b"".join(parts)[:4096])
    return [c[:4096] for c in cases]




def make_file(size: int, seed: int, plan_seed: int = 2026) -> bytes:
    """``make_corpus``'s mix of ``size`` bytes: the vocabulary and each
    piece's kind and size from ``plan_seed``, its contents from ``seed``."""
    plan = np.random.default_rng(plan_seed)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz_", np.uint8)
    vocab = [bytes(plan.choice(letters, plan.integers(2, 12)))
             for _ in range(400)]
    ranks = 1.0 / np.arange(1, len(vocab) + 1)
    probs = ranks / ranks.sum()
    parts = []
    total = 0
    while total < size:
        k = plan.integers(0, 10)
        if k < 5:  # text
            words = rng.choice(len(vocab), plan.integers(300, 3000), p=probs)
            piece = b" ".join(vocab[w] for w in words)
        elif k < 7:  # RLE runs
            piece = bytes([int(rng.integers(0, 256))]) * int(
                plan.integers(50, 4000))
        elif k < 9:  # structured records with shared 12-byte prefixes
            rec = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            piece = b"".join(
                rec[:12] + bytes([int(rng.integers(0, 256))]) * 4
                for _ in range(int(plan.integers(20, 200))))
        else:  # incompressible
            piece = bytes(rng.integers(0, 256, int(plan.integers(500, 5000)),
                                       dtype=np.uint8))
        parts.append(piece)
        total += len(piece)
    return b"".join(parts)[:size]
