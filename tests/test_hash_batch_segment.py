"""Vectorized hash family (batch/multiseed/fill_random incl. the device AES
path) and UTF-8 segmentation — differential vs the scalar bit-exact paths
and UAX expectations."""

import numpy as np

from stringzilla_tpu.ops.hash_device import fill_random_device
from stringzilla_tpu.ops.hash import fill_random, hash_batch, hash_multiseed, sz_hash
from stringzilla_tpu.ops.utf8_segment import (
    utf8_linebreaks,
    utf8_sentences,
    utf8_wordbreaks,
    utf8_words,
)


def test_hash_batch_matches_scalar(rng):
    items = [bytes(rng.integers(0, 256, int(rng.integers(0, 65))).astype(np.uint8))
             for _ in range(200)]
    items += [bytes(rng.integers(0, 256, int(rng.integers(65, 300))).astype(np.uint8))
              for _ in range(10)]
    out = hash_batch(items, seed=7)
    for i, s in enumerate(items):
        assert out[i] == sz_hash(s, 7)


def test_hash_multiseed_matches_scalar(rng):
    short = b"The quick brown fox"
    long = bytes(rng.integers(0, 256, 1000).astype(np.uint8))
    for data in (short, long, b""):
        ms = hash_multiseed(data, range(8))
        for s in range(8):
            assert ms[s] == sz_hash(data, s)


def test_fill_random_device_bit_identical():
    for L, nonce in ((1, 0), (16, 5), (100, 7), (5000, 123456789), (40000, 2**63 + 9)):
        dev = bytes(np.asarray(fill_random_device(L, nonce)))
        assert dev == fill_random(L, nonce)


def test_words():
    b = "The quick-brown fox can't jump 32.5 feet, right?".encode()
    words = [bytes(b[o : o + l]).decode() for o, l in utf8_words(b)]
    assert words == ["The", "quick", "brown", "fox", "can't", "jump",
                     "32.5", "feet", "right"]
    assert utf8_wordbreaks(b"ab cd") == [2, 3]
    assert len(utf8_words("русский текст 123".encode())) == 3


def test_sentences():
    s = "Hello world. No caps here. it continues! Done.".encode()
    sents = [bytes(s[o : o + l]).decode() for o, l in utf8_sentences(s)]
    assert sents[0] == "Hello world. "
    assert any("here. it" in x for x in sents)  # SB8 lowercase continuation
    u = "U.S. Government".encode()
    # strict UAX-29: SB7 merges only directly-adjacent Upper ATerm Upper, so
    # the inner "U.S" dots merge but ". G" (with a space) still splits
    assert utf8_sentences(u) == [(0, 5), (5, 10)]
    assert len(utf8_sentences(b"U.S.A is big")) == 1


def test_linebreaks():
    lb = utf8_linebreaks(b"foo bar-baz qux")
    assert 4 in lb and 8 in lb and 12 in lb
    assert 1 not in lb  # no break inside a word
    assert len(utf8_linebreaks("日本語テスト".encode())) >= 4
    assert utf8_linebreaks(b"a\nb")[0] == 2  # mandatory after LF


def test_hash_batch_device_kernel(rng):
    """The device token-hash path is bit-identical."""
    from stringzilla_tpu.ops.hash_device import hash_batch_device

    items = [bytes(rng.integers(0, 256, int(rng.integers(0, 65))).astype(np.uint8))
             for _ in range(100)]
    got = hash_batch_device(items, 42)
    for i, s in enumerate(items):
        assert got[i] == sz_hash(s, 42)


def test_hash_long_device_kernel(rng):
    """The four-lane long path (> 64 B) is bit-identical, across
    chunk-count buckets and the deferred-tail edge lengths (reference
    ``hash/serial.h:443-500``)."""
    from stringzilla_tpu.ops.hash_device import hash_batch_device

    lens = [65, 100, 127, 128, 129, 191, 192, 193, 200, 255, 256, 300, 500]
    items = [bytes(rng.integers(0, 256, l).astype(np.uint8)) for l in lens]
    got = hash_batch_device(items, 9)
    for i, s in enumerate(items):
        assert got[i] == sz_hash(s, 9), (i, len(s))


def test_batch_entry_points_threaded(rng, monkeypatch):
    """The native batch tape loops fan out across cores (TC_THREADS); the
    partition is by byte mass, so one huge doc among tiny ones still lands
    every row exactly once. Differential: forced 4-thread vs forced-serial
    runs must be bit-identical (reference analog: ForkUnion batch fan-out,
    include/stringzillas/types.hpp:133-234)."""
    from stringzilla_tpu.utils import native

    if native.lib() is None:
        import pytest

        pytest.skip("native library unavailable")
    items = [bytes(rng.integers(0, 256, int(n)).astype(np.uint8))
             for n in list(rng.integers(0, 500, 300)) + [200_000, 3, 70_000]]
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in items], out=offsets[1:])
    blob = np.frombuffer(b"".join(items), dtype=np.uint8)
    monkeypatch.setenv("TC_THREADS", "1")
    h1 = native.hash_tape(blob, offsets, 42).copy()
    s1 = native.sha256_tape(blob, offsets).copy()
    b1 = native.hash_bounds(blob, offsets[:-1], offsets[1:], 42).copy()
    monkeypatch.setenv("TC_THREADS", "4")
    assert np.array_equal(native.hash_tape(blob, offsets, 42), h1)
    assert np.array_equal(native.sha256_tape(blob, offsets), s1)
    assert np.array_equal(
        native.hash_bounds(blob, offsets[:-1], offsets[1:], 42), b1)
