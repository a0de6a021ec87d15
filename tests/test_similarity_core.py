"""Differential tests: the block and batched DP drivers vs NumPy DP."""

import numpy as np
import pytest

import jax.numpy as jnp

from stringzilla_tpu.ops.similarity import (
    AffineGaps,
    ClassCosts,
    LinearGaps,
    SimilarityConfig,
    UniformCosts,
    score_batch,
    score_block,
)

from . import oracles


def pack_block(strings, length, lanes, dtype=np.int32):
    """(length, lanes) transposed block + (1, lanes) lengths."""
    block = np.zeros((length, lanes), dtype=dtype)
    lens = np.zeros((1, lanes), dtype=np.int32)
    for i, s in enumerate(strings):
        arr = np.frombuffer(s, dtype=np.uint8)
        block[: len(arr), i] = arr
        lens[0, i] = len(arr)
    return block, lens


def pack_query(q, rows, dtype=np.int32):
    q_ext = np.zeros((rows, 1), dtype=dtype)
    arr = np.frombuffer(q, dtype=np.uint8)
    q_ext[1 : 1 + len(arr), 0] = arr
    return q_ext


def run_block(q, cands, cfg, rows=None, length=None, lanes=None, table=None, use_pallas=False):
    rows = rows or max(len(q) + 1, 8)
    length = length or max(max((len(c) for c in cands), default=1), 8)
    lanes = lanes or max(len(cands), 128)
    block, lens = pack_block(cands, length, lanes)
    q_ext = pack_query(q, rows)
    if cfg.uses_classes:
        b2c = cfg.costs.byte_to_class_np()
        block = b2c[block.astype(np.uint8)].astype(np.int32)
        q_ext2 = q_ext.copy()
        q_ext2[1 : 1 + len(q), 0] = b2c[np.frombuffer(q, dtype=np.uint8)]
        q_ext = q_ext2
        table = cfg.costs.table_np()
    if use_pallas:
        out = score_batch(
            jnp.asarray(q_ext), jnp.asarray([[len(q)]], dtype=jnp.int32),
            jnp.asarray(block), jnp.asarray(lens), cfg,
            table=None if table is None else jnp.asarray(table),
        )
        return np.asarray(out)[0, : len(cands)]
    out = score_block(
        jnp.asarray(q_ext), jnp.int32(len(q)), jnp.asarray(block),
        jnp.asarray(lens), cfg,
        table=None if table is None else jnp.asarray(table),
    )
    return np.asarray(out)[0, : len(cands)]


CASES = [
    (b"", b""),
    (b"", b"abc"),
    (b"abc", b""),
    (b"abc", b"abc"),
    (b"kitten", b"sitting"),
    (b"flaw", b"lawn"),
    (b"a" * 50, b"a" * 49 + b"b"),
    (b"abcdabcdabcd", b"dcba"),
]


def test_levenshtein_oracle_matches_numpy():
    cfg = SimilarityConfig("min", "global", LinearGaps(1), UniformCosts(0, 1))
    queries = sorted({q for q, _ in CASES}, key=len)
    cands = [c for _, c in CASES]
    for q in queries:
        got = run_block(q, cands, cfg)
        want = [oracles.levenshtein(q, c) for c in cands]
        np.testing.assert_array_equal(got, want)


def test_levenshtein_random_vs_numpy(rng):
    cfg = SimilarityConfig("min", "global", LinearGaps(1), UniformCosts(0, 1))
    cands = oracles.random_strings(rng, 40, 0, 30, b"abc")
    for q in oracles.random_strings(rng, 6, 0, 30, b"abc"):
        got = run_block(q, cands, cfg)
        want = [oracles.levenshtein(q, c) for c in cands]
        np.testing.assert_array_equal(got, want)


def test_weighted_distance_costs(rng):
    cfg = SimilarityConfig("min", "global", LinearGaps(3), UniformCosts(0, 2))
    cands = oracles.random_strings(rng, 20, 0, 20, b"ab")
    for q in oracles.random_strings(rng, 4, 0, 20, b"ab"):
        got = run_block(q, cands, cfg)
        want = [
            oracles.score_linear(q, c, lambda x, y: 0 if x == y else 2, 3, "min", False)
            for c in cands
        ]
        np.testing.assert_array_equal(got, want)


def _toy_class_costs():
    # 4-letter alphabet mapped to classes 0..3, BLOSUM-style signed costs.
    b2c = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(b"acgt"):
        b2c[ch] = i
    table = np.full((32, 32), -3, dtype=np.int32)
    np.fill_diagonal(table, 5)
    table[0, 1] = table[1, 0] = 1  # a~c mildly similar
    return ClassCosts.from_arrays(b2c, table), b2c, table


def _nw_sub(b2c, table):
    return lambda x, y: int(table[b2c[x], b2c[y]])


def test_needleman_wunsch_vs_numpy(rng):
    costs, b2c, table = _toy_class_costs()
    cfg = SimilarityConfig("max", "global", LinearGaps(-4), costs)
    cands = oracles.random_strings(rng, 24, 0, 24, b"acgt")
    for q in oracles.random_strings(rng, 4, 0, 24, b"acgt"):
        got = run_block(q, cands, cfg)
        want = [oracles.score_linear(q, c, _nw_sub(b2c, table), -4, "max", False) for c in cands]
        np.testing.assert_array_equal(got, want)


def test_smith_waterman_vs_numpy(rng):
    costs, b2c, table = _toy_class_costs()
    cfg = SimilarityConfig("max", "local", LinearGaps(-4), costs)
    cands = oracles.random_strings(rng, 24, 0, 24, b"acgt")
    for q in oracles.random_strings(rng, 4, 0, 24, b"acgt"):
        got = run_block(q, cands, cfg)
        want = [oracles.score_linear(q, c, _nw_sub(b2c, table), -4, "max", True) for c in cands]
        np.testing.assert_array_equal(got, want)


def test_affine_levenshtein_vs_numpy(rng):
    cfg = SimilarityConfig("min", "global", AffineGaps(3, 1), UniformCosts(0, 1))
    cands = oracles.random_strings(rng, 16, 0, 20, b"abc")
    for q in oracles.random_strings(rng, 4, 0, 20, b"abc"):
        got = run_block(q, cands, cfg)
        want = [
            oracles.score_affine(q, c, lambda x, y: 0 if x == y else 1, 3, 1, "min", False)
            for c in cands
        ]
        np.testing.assert_array_equal(got, want)


def test_affine_nw_sw_vs_numpy(rng):
    costs, b2c, table = _toy_class_costs()
    for locality in ("global", "local"):
        cfg = SimilarityConfig("max", locality, AffineGaps(-6, -1), costs)
        cands = oracles.random_strings(rng, 12, 0, 18, b"acgt")
        for q in oracles.random_strings(rng, 3, 0, 18, b"acgt"):
            got = run_block(q, cands, cfg)
            want = [
                oracles.score_affine(q, c, _nw_sub(b2c, table), -6, -1, "max", locality == "local")
                for c in cands
            ]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "cfg",
    [
        SimilarityConfig("min", "global", LinearGaps(1), UniformCosts(0, 1)),
        SimilarityConfig("min", "global", AffineGaps(2, 1), UniformCosts(0, 1)),
        SimilarityConfig("max", "global", LinearGaps(-4), _toy_class_costs()[0]),
        SimilarityConfig("max", "local", LinearGaps(-4), _toy_class_costs()[0]),
        SimilarityConfig("max", "local", AffineGaps(-6, -1), _toy_class_costs()[0]),
    ],
    ids=["lev", "lev-affine", "nw", "sw", "sw-affine"],
)
def test_pallas_interpret_matches_oracle(rng, cfg):
    alphabet = b"acgt" if cfg.uses_classes else b"abc"
    cands = oracles.random_strings(rng, 130, 0, 24, alphabet)
    for q in oracles.random_strings(rng, 2, 0, 24, alphabet):
        got_o = run_block(q, cands, cfg, lanes=256, use_pallas=False)
        got_p = run_block(q, cands, cfg, lanes=256, use_pallas=True)
        np.testing.assert_array_equal(got_p, got_o)
