"""Mesh-parallel cross-product scoring.

The reference parallelizes cross-products over a NUMA thread pool
(``cross_in_parallel_``, reference ``similarities/serial.hpp:3296-3395``).
Here the candidate axis is sharded over the scope's mesh with ``shard_map``:
queries are replicated (the "shared query broadcast" of the lane walker),
candidates and the result matrix are sharded along ``data``, and the only
communication is gathering the results.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import myers
from ..ops.similarity import SimilarityConfig, score_batch

__all__ = [
    "sharded_similarity",
    "sharded_myers",
    "sharded_find",
    "sharded_count",
    "sharded_hashes",
    "sharded_argsort",
]


def sharded_myers(q_t, qlens, cands_t, clens, mesh: Mesh,
                  alphabet: int | None = 256):
    """Candidate-sharded Myers bit-parallel distances: queries replicated,
    candidates and results split along the mesh's ``data`` axis. Characters
    are mapped to PEQ codes once, outside the shards."""
    q_codes, c_codes, A = myers.encode(q_t, cands_t, alphabet)
    form = (myers.myers_kernel if myers.use_kernel(q_t.shape[0] // 32)
            else myers.myers_reference)

    def run(q, ql, c, cl):
        return form(q, ql, c, cl, A)

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(None, "data"), P(None, "data")),
        out_specs=P(None, "data"), check_vma=False,
    )
    return fn(q_codes, qlens, c_codes, clens)


def sharded_similarity(
    q_ext_t,  # (rows, n_queries) replicated
    qlens,  # (n_queries, 1) replicated
    cands_t,  # (cand_len, n_cands) — n_cands divisible by ndev
    clens,  # (1, n_cands)
    cfg: SimilarityConfig,
    mesh: Mesh,
    table=None,
):
    """Returns ``(n_queries, n_cands) int32`` sharded along the candidate axis."""
    has_table = table is not None

    def run(q, ql, c, cl, *tb):
        return score_batch(q, ql, c, cl, cfg, tb[0] if has_table else None)

    in_specs = [P(None, None), P(None, None), P(None, "data"), P(None, "data")]
    if has_table:
        in_specs.append(P(None, None))
    fn = shard_map(
        run, mesh=mesh, in_specs=tuple(in_specs), out_specs=P(None, "data"),
        check_vma=False,
    )
    args = (q_ext_t, qlens, cands_t, clens) + ((table,) if has_table else ())
    return fn(*args)


def _halo_blocks(hay: np.ndarray, ndev: int, halo: int):
    """Split a byte buffer into ``ndev`` equal shards, each extended by a
    ``halo``-byte overlap into the next shard (so every match straddling a
    shard boundary is visible to exactly one shard). Returns
    ``(blocks (ndev, shard+halo) u8, shard_len, valid_bytes (ndev,) i32)``."""
    n = hay.shape[0]
    shard = -(-n // ndev)
    block_len = shard + halo
    blocks = np.zeros((ndev, block_len), np.uint8)
    for d in range(ndev):
        seg = hay[d * shard : d * shard + block_len]
        blocks[d, : seg.shape[0]] = seg
    valid = np.clip(n - np.arange(ndev) * shard, 0, block_len).astype(np.int32)
    return blocks, shard, valid


def _hay_np(haystack) -> np.ndarray:
    if isinstance(haystack, str):
        haystack = haystack.encode("utf-8")
    if isinstance(haystack, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(haystack), np.uint8)
    return np.asarray(haystack, dtype=np.uint8)


def _sharded_match_stats(haystack, needle, mesh: Mesh):
    """Shared driver: shards the haystack with a (k-1)-byte halo over the
    ``data`` axis, computes the dense shifted-compare match mask per shard
    (``ops.find`` dense tier) and reduces (first, last, count) with
    ``pmin``/``pmax``/``psum`` collectives — SURVEY §7's all-gather-needle /
    psum-counts design (reference single-node analog: ``find/serial.h:35``)."""
    from ..ops.find import _needle_arr

    hay = _hay_np(haystack)
    nd, k = _needle_arr(needle)
    n = int(hay.shape[0])
    ndev = int(np.prod(mesh.devices.shape))
    if k == 0 or n < k:
        return None, n, k
    blocks, shard, valid = _halo_blocks(hay, ndev, k - 1)
    big = np.int32(n + 1)

    def run(blk, vl, ndl):
        h = blk[0].astype(jnp.int32)
        mask = jnp.ones(h.shape, jnp.bool_)
        for a in range(k):
            mask = mask & ((jnp.roll(h, -a) if a else h) == ndl[0, a])
        pos = jnp.arange(h.shape[0], dtype=jnp.int32)
        mask = mask & (pos <= vl[0, 0] - k) & (pos < shard)
        d = jax.lax.axis_index("data").astype(jnp.int32)
        gpos = jnp.where(mask, d * shard + pos, big)
        first = jax.lax.pmin(jnp.min(gpos), "data")
        last = jax.lax.pmax(jnp.max(jnp.where(mask, d * shard + pos, -1)), "data")
        cnt = jax.lax.psum(jnp.sum(mask.astype(jnp.int32)), "data")
        return jnp.stack([jnp.where(first < big, first, -1), last, cnt]).reshape(1, 3)

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P(None, None)),
        out_specs=P(None, None), check_vma=False,
    )
    stats = np.asarray(fn(blocks, valid.reshape(ndev, 1),
                          np.asarray(nd, np.int32).reshape(1, k)))[0]
    return stats, n, k


def sharded_find(haystack, needle, mesh: Mesh) -> int:
    """Mesh-sharded ``sz_find``: haystack split over ``data`` with a
    (k-1)-byte halo, first-match indices combined with a min collective
    across the mesh. Dense tier only (needle ≤ 64 B)."""
    stats, n, k = _sharded_match_stats(haystack, needle, mesh)
    if k == 0:
        return 0
    if stats is None:
        return -1
    return int(stats[0])


def sharded_rfind(haystack, needle, mesh: Mesh) -> int:
    stats, n, k = _sharded_match_stats(haystack, needle, mesh)
    if k == 0:
        return n
    if stats is None:
        return -1
    return int(stats[1])


def sharded_count(haystack, needle, mesh: Mesh) -> int:
    """Overlapping occurrence count via a psum over per-shard popcounts."""
    stats, n, k = _sharded_match_stats(haystack, needle, mesh)
    if k == 0:
        return n + 1
    if stats is None:
        return 0
    return int(stats[2])


def sharded_hashes(data2d: np.ndarray, lengths: np.ndarray, seed: int,
                   n_blocks: int, mesh: Mesh) -> np.ndarray:
    """Token hashes sharded over the lanes (tokens) axis: each device
    hashes its lane slice; results concatenate along ``data``. Lanes must be
    divisible by ndev."""
    from ..ops.hash_device import hash_tokens_raw

    def run(d2d, lens):
        return hash_tokens_raw(d2d, lens[0], seed, n_blocks)

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data")),
        out_specs=P(None, "data"), check_vma=False,
    )
    return fn(data2d, np.asarray(lengths, np.int32).reshape(1, -1))


def sharded_argsort(keys, mesh: Mesh, num_keys: int | None = None):
    """Argsort of packed pgram keys with the key matrix sharded over the
    mesh — jitted with sharded inputs so XLA/GSPMD inserts the gather
    collectives (the counterpart of the reference's parallel stable sort,
    ``sort.h``). ``keys`` is ``(n, w)`` with lexicographic priority on
    columns (``ops.sort.pack_pgram_keys`` layout)."""
    keys = jnp.asarray(keys)
    nk = num_keys if num_keys is not None else keys.shape[1]
    sharding = NamedSharding(mesh, P("data", None))
    keys = jax.device_put(keys, sharding)

    @jax.jit
    def run(k):
        n = k.shape[0]
        operands = [k[:, j] for j in range(k.shape[1])]
        operands.append(jnp.arange(n, dtype=jnp.int32))
        out = jax.lax.sort(operands, num_keys=nk)
        return out[-1]

    return run(keys)


def sharded_fingerprints(docs_t, lens, widths, group_sizes, mult, m_limbs,
                         fd_limbs, inv_m, mesh: Mesh):
    """Document-sharded MinHash fingerprints: the dimension parameters are
    replicated, documents and outputs split along ``data`` — the analog of
    the reference's docs×dim-groups thread fan-out
    (``floating_rolling_hashers_in_parallel_``, ``fingerprints/serial.hpp:994``)."""
    from ..ops.fingerprints import fingerprint_all_groups

    def run(d, l, w, mu, ml, fl, im):
        return fingerprint_all_groups(d, l, w, group_sizes, mu, ml, fl, im)

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data"), P(None, None),
                  P(None, None), P(None, None, None), P(None, None, None),
                  P(None, None)),
        out_specs=(P(None, "data"), P(None, "data")), check_vma=False,
    )
    return fn(docs_t, lens, widths, mult, m_limbs, fd_limbs, inv_m)
