"""Exact-search tests: XLA path, the device-mirror search tier, and the Str
front-end — all differential vs Python's bytes built-ins, the same
"every tier vs serial oracle" strategy as the reference test suite
(reference ``test/find.cpp``, ``test/test_find.py``)."""

import numpy as np
import pytest

from stringzilla_tpu.ops import find as F
from stringzilla_tpu.ops.find import byteset_mask
from stringzilla_tpu.ops.find import (
    BLOCK_ROWS,
    LANES,
    MAX_OFFSETS,
    find_long,
    search_positions,
)


@pytest.fixture(scope="module")
def corpus(rng):
    n_rows = BLOCK_ROWS * 2
    n = n_rows * LANES - 777
    buf = rng.integers(97, 101, n_rows * LANES).astype(np.uint8)
    buf[n:] = 0
    return bytes(buf[:n]), buf.reshape(n_rows, LANES), n


# ---------------------------------------------------------------------------
# XLA tier (ops.find)
# ---------------------------------------------------------------------------


def test_find_xla_differential(rng):
    for _ in range(40):
        n = int(rng.integers(1, 300))
        hay = bytes(rng.integers(97, 100, n).astype(np.uint8))
        k = int(rng.integers(1, 10))
        if rng.random() < 0.5 and n >= k:
            s = int(rng.integers(0, n - k + 1))
            needle = hay[s : s + k]
        else:
            needle = bytes(rng.integers(97, 101, k).astype(np.uint8))
        assert F.find(hay, needle) == hay.find(needle)
        assert F.rfind(hay, needle) == hay.rfind(needle)
        assert F.count(hay, needle, allowoverlap=False) == hay.count(needle)


def test_find_xla_long_needles(rng):
    for _ in range(5):
        n = int(rng.integers(300, 800))
        hay = bytes(rng.integers(97, 99, n).astype(np.uint8))
        k = int(rng.integers(65, 120))
        s = int(rng.integers(0, n - k + 1))
        needle = hay[s : s + k]
        assert F.find(hay, needle) == hay.find(needle)
        assert F.rfind(hay, needle) == hay.rfind(needle)
        assert F.find(hay, needle[:-1] + b"\xff") == -1


def test_find_edges():
    assert F.find(b"", b"x") == -1
    assert F.find(b"abc", b"") == 0
    assert F.rfind(b"abc", b"") == 3
    assert F.count(b"aaaa", b"aa", allowoverlap=True) == 3
    assert F.count(b"aaaa", b"aa", allowoverlap=False) == 2
    assert F.find_byte(b"hello", ord("l")) == 2
    assert F.rfind_byte(b"hello", ord("l")) == 3
    assert F.count_byte(b"hello", ord("l")) == 2
    assert F.find_byteset(b"hello world", b" \t") == 5
    assert F.rfind_byteset(b"hello world", b"o") == 7
    assert F.find_byteset(b"abc", b"xyz") == -1


# ---------------------------------------------------------------------------
# Device-mirror search tier (search_positions / find_long)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 13, 16])
def test_pallas_short_needles(corpus, rng, k):
    hay, h2d, n = corpus
    import jax.numpy as jnp

    h2d = jnp.asarray(h2d)
    s = int(rng.integers(0, n - k))
    needle = np.frombuffer(hay[s : s + k], dtype=np.uint8)
    assert int(search_positions(h2d, n, "first", needle=needle)) == hay.find(bytes(needle))
    assert int(search_positions(h2d, n, "last", needle=needle)) == hay.rfind(bytes(needle))


def test_pallas_count_and_missing(corpus):
    hay, h2d, n = corpus
    import jax.numpy as jnp

    h2d = jnp.asarray(h2d)
    needle = np.frombuffer(b"ab", dtype=np.uint8)
    exp = sum(1 for p in range(n - 1) if hay[p : p + 2] == b"ab")
    assert int(search_positions(h2d, n, "count", needle=needle)) == exp
    missing = np.frombuffer(b"zzzzz", dtype=np.uint8)
    assert int(search_positions(h2d, n, "first", needle=missing)) == -1


@pytest.mark.parametrize("k", [17, 130])
def test_pallas_long_needles(corpus, rng, k):
    hay, h2d, n = corpus
    import jax.numpy as jnp

    h2d = jnp.asarray(h2d)
    s = int(rng.integers(0, n - k))
    needle = np.frombuffer(hay[s : s + k], dtype=np.uint8)
    assert k > MAX_OFFSETS
    assert find_long(h2d, n, needle) == hay.find(bytes(needle))
    assert find_long(h2d, n, needle, reverse=True) == hay.rfind(bytes(needle))
    miss = np.frombuffer(bytes(needle[:-1]) + b"\xff", dtype=np.uint8)
    assert find_long(h2d, n, miss) == -1


def test_pallas_byteset(corpus):
    hay, h2d, n = corpus
    import jax.numpy as jnp

    h2d = jnp.asarray(h2d)
    ws = byteset_mask(b"ab")
    first = min(x for x in (hay.find(b"a"), hay.find(b"b")) if x >= 0)
    assert int(search_positions(h2d, n, "first", byteset_words=ws)) == first
    assert int(search_positions(h2d, n, "last", byteset_words=ws)) == max(
        hay.rfind(b"a"), hay.rfind(b"b")
    )


def test_pallas_bounds(corpus):
    """lo/hi bounds mirror Python's find(needle, start, end)."""
    hay, h2d, n = corpus
    import jax.numpy as jnp

    h2d = jnp.asarray(h2d)
    needle = np.frombuffer(hay[1000:1005], dtype=np.uint8)
    exp = hay.find(bytes(needle), 1001)
    assert int(search_positions(h2d, n, "first", needle=needle, lo=1001)) == exp
