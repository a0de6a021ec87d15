"""Myers bit-parallel distances — the Pallas kernel (interpret mode here)
and the plain XLA form — vs the Wagner-Fischer oracle, plus the engine
dispatch that routes unit-cost configs to it (the reference's Myers
dispatch, ``serial.hpp:2620-2720``)."""

import numpy as np
import pytest

from stringzilla_tpu.ops import myers as M
from stringzilla_tpu.ops.myers import myers_distances

from .oracles import levenshtein


def _pack(qs, cs, rows, cand_len):
    import jax.numpy as jnp

    nq, nc = len(qs), len(cs)
    q_t = np.full((rows, nq), -1, dtype=np.int32)
    qlens = np.zeros((nq, 1), np.int32)
    for i, s in enumerate(qs):
        q_t[: len(s), i] = np.frombuffer(s, np.uint8)
        qlens[i, 0] = len(s)
    c_t = np.zeros((cand_len, nc), np.int32)
    clens = np.zeros((1, nc), np.int32)
    for j, s in enumerate(cs):
        c_t[: len(s), j] = np.frombuffer(s, np.uint8)
        clens[0, j] = len(s)
    return (jnp.asarray(q_t), jnp.asarray(qlens), jnp.asarray(c_t),
            jnp.asarray(clens))


@pytest.mark.parametrize("rows,cand_len", [(32, 16), (64, 48), (128, 80)])
def test_myers_differential(rng, rows, cand_len):
    nq, nc = 3, 128
    qs = [bytes(rng.integers(97, 101, rng.integers(0, rows + 1)).astype(np.uint8))
          for _ in range(nq)]
    cs = [bytes(rng.integers(97, 101, rng.integers(0, cand_len + 1)).astype(np.uint8))
          for _ in range(nc)]
    out = np.asarray(myers_distances(*_pack(qs, cs, rows, cand_len)))
    for i in range(nq):
        for j in range(nc):
            assert out[i, j] == levenshtein(qs[i], cs[j]), (qs[i], cs[j])


def test_myers_multiword_boundary(rng):
    """Lengths straddling the 32-bit word boundary exercise the carry chain."""
    qs = [b"a" * 31, b"a" * 32, b"a" * 33, b"ab" * 32]
    cs = [b"a" * 31, b"a" * 33, b"b" * 40, b"ba" * 20, b""]
    cs = cs + [bytes(rng.integers(97, 99, 64).astype(np.uint8)) for _ in range(123)]
    out = np.asarray(myers_distances(*_pack(qs, cs, 64, 64)))
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert out[i, j] == levenshtein(q, c)


@pytest.mark.parametrize("words", [8, 32, 128])
def test_myers_high_word_counts(rng, words):
    """The engine routes queries up to 4096 chars (128 words) to Myers; the
    carry prefix and the end-only score must hold at every word count."""
    rows = words * 32
    m = rows - rng.integers(0, 17)
    qs = [bytes(rng.integers(97, 100, m).astype(np.uint8)),
          bytes(rng.integers(97, 100, rows - 33).astype(np.uint8))]
    cand_len = 40
    cs = [bytes(rng.integers(97, 100, int(l)).astype(np.uint8))
          for l in rng.integers(0, cand_len + 1, size=127)]
    cs.append(qs[0][: min(len(qs[0]), cand_len)])  # near-identical candidate
    out = np.asarray(myers_distances(*_pack(qs, cs, rows, cand_len)))
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert out[i, j] == levenshtein(q, c), (words, i, j)


def test_engine_routes_unit_cost_to_myers(rng):
    from stringzilla_tpu import LevenshteinDistances

    eng = LevenshteinDistances()
    assert eng._is_unit_cost
    qs = [b"kitten", b"sitting" * 8, b""]
    cs = [b"sitting", b"kitten", b"flour", b""]
    out = eng(qs, cs)
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert out[i, j] == levenshtein(q, c)
    # non-unit costs must NOT route to Myers
    assert not LevenshteinDistances(mismatch=2)._is_unit_cost
    assert not LevenshteinDistances(open=2, extend=2)._is_unit_cost


def test_engine_symmetric_and_utf8():
    from stringzilla_tpu import LevenshteinDistances, LevenshteinDistancesUTF8

    seqs = [b"abcd", b"abce", b"zzzz"]
    out = LevenshteinDistances()(seqs)
    assert out.shape == (3, 3) and (out == out.T).all() and (np.diag(out) == 0).all()

    eng = LevenshteinDistancesUTF8()
    a, b = "héllo".encode(), "hello".encode()
    out = eng([a], [b])
    assert out[0, 0] == 1  # one rune substitution, not two byte edits


def _rand_pack(rng, words, nq, nc, cand_len, alphabet=b"abcd"):
    rows = 32 * words
    pool = np.frombuffer(alphabet, np.uint8)
    qs = [bytes(rng.choice(pool, int(rng.integers(0, rows + 1))))
          for _ in range(nq)]
    cs = [bytes(rng.choice(pool, int(rng.integers(0, cand_len + 1))))
          for _ in range(nc)]
    return qs, cs, _pack(qs, cs, rows, cand_len)


@pytest.mark.parametrize("words", [1, 2, 4, 8])
def test_kernel_matches_reference(rng, words):
    """The Pallas kernel (interpret mode) equals the plain XLA form exactly,
    and both equal Wagner-Fischer on a sample."""
    qs, cs, args = _rand_pack(rng, words, 3, 2 * M.LANE_BLOCK, 40)
    got = np.asarray(M.myers_kernel(*args))
    want = np.asarray(M.myers_reference(*args))
    np.testing.assert_array_equal(got, want)
    for i in range(len(qs)):
        for j in range(0, len(cs), 37):
            assert want[i, j] == levenshtein(qs[i], cs[j])


def test_kernel_wrapper_pads_and_unsorts(rng):
    """A candidate count that is not a LANE_BLOCK multiple is padded, and
    the length sort's permutation is undone: column j stays candidate j."""
    qs, cs, args = _rand_pack(rng, 2, 2, M.LANE_BLOCK + 37, 50)
    got = np.asarray(M.myers_kernel(*args))
    assert got.shape == (2, M.LANE_BLOCK + 37)
    for i, q in enumerate(qs):
        for j in (0, 1, M.LANE_BLOCK - 1, M.LANE_BLOCK, M.LANE_BLOCK + 36):
            assert got[i, j] == levenshtein(q, cs[j])


def test_rune_codes(rng):
    """UTF-32 runes map to ranks of the query rune set; runes no query
    holds share the all-zero PEQ row — kernel and XLA form agree."""
    import jax.numpy as jnp

    q_t = np.full((32, 2), -1, np.int32)
    q_t[:3, 0] = [0x4E00, 0x430, 97]
    q_t[:5, 1] = 0x1F600
    qlens = np.array([[3], [5]], np.int32)
    c_t = np.zeros((8, 3), np.int32)
    c_t[:3, 0] = [0x4E00, 98, 97]
    c_t[:2, 1] = [0x1F600, 0x1F601]
    clens = np.array([[3, 2, 0]], np.int32)
    args = tuple(jnp.asarray(x) for x in (q_t, qlens, c_t, clens))
    q_codes, c_codes, A = M.encode(args[0], args[2], None)
    assert A >= 16 and int(c_codes[1, 1]) == A - 1  # U+1F601: absent
    want = np.array([[1, 3, 3], [5, 4, 5]])
    np.testing.assert_array_equal(
        np.asarray(myers_distances(*args, alphabet=None)), want)
    np.testing.assert_array_equal(
        np.asarray(M.myers_kernel(q_codes, args[1], c_codes, args[3], A)), want)


def test_kernel_routing(monkeypatch):
    """The kernel serves the GPU up to MAX_KERNEL_WORDS; the CPU and longer
    queries take the XLA form."""
    from stringzilla_tpu.utils import platform

    monkeypatch.setattr(platform, "_FORCED", "gpu")
    assert M.use_kernel(1) and M.use_kernel(M.MAX_KERNEL_WORDS)
    assert not M.use_kernel(M.MAX_KERNEL_WORDS * 2)
    monkeypatch.setattr(platform, "_FORCED", "cpu")
    assert not M.use_kernel(1)


@pytest.mark.gpu
def test_kernel_compiled_matches_reference(gpu, rng):
    """On a card: the compiled kernel equals the XLA form at the benchmark
    word count."""
    qs, cs, args = _rand_pack(rng, 4, 8, 4 * M.LANE_BLOCK, 128,
                              alphabet=bytes(range(97, 123)))
    np.testing.assert_array_equal(np.asarray(M.myers_kernel(*args)),
                                  np.asarray(M.myers_reference(*args)))
