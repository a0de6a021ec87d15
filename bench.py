#!/usr/bin/env python
"""Headline benchmark: batched unit-cost Levenshtein throughput in GCUPS.

Mirrors the reference's ``bench/similarities.cpp`` workload (~100-byte ASCII
lines, all-pairs batch, CUPS accounting = sum(len_q*len_c)/second). Baseline:
the reference's single-socket AVX-512 figure of 3.434 GCUPS on Sapphire Rapids
(reference ``README.md:266-283``, BASELINE.md). For scale: the reference's
H100 CUDA engine reports 93.66 GCUPS on the same workload.

The path under test is ``ops.myers.myers_distances`` — the Myers bit-parallel
Pallas kernel that ``szs.LevenshteinDistances`` dispatches unit costs to.
Runs only on a GPU: with no GPU it exits non-zero and prints no result.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "GCUPS", "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": N}}

Env knobs (reference's STRINGWARS_* protocol, ``bench/similarities.cpp:16-31``):
    STRINGWARS_SEED     RNG seed                     (default 42)
    STRINGWARS_QUERIES  number of queries            (default 128)
    STRINGWARS_CANDS    number of candidates         (default 32768)
    STRINGWARS_LEN      mean string length           (default 100)
    STRINGWARS_DURATION target seconds of timed work (default 10)
"""

import json
import os
import time

import numpy as np


def main():
    seed = int(os.environ.get("STRINGWARS_SEED", "42"))
    n_queries = int(os.environ.get("STRINGWARS_QUERIES", "128"))
    n_cands = int(os.environ.get("STRINGWARS_CANDS", "32768"))
    mean_len = int(os.environ.get("STRINGWARS_LEN", "100"))
    duration = float(os.environ.get("STRINGWARS_DURATION", "10"))

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    from stringzilla_tpu.ops.myers import myers_distances

    rng = np.random.default_rng(seed)
    # Length cap at 1.28x the mean (≈ mean + 2.2σ) keeps the Myers word
    # count minimal: mean 100 → 128 chars → 4 words per lane.
    rows = max(32, -(-int(mean_len * 1.28) // 32) * 32)
    cand_len = max(8, -(-int(mean_len * 1.28) // 8) * 8)

    def make_batch(count, maxlen):
        lens = np.clip(rng.normal(mean_len, mean_len / 8, count).astype(np.int32),
                       8, maxlen)
        chars = rng.integers(97, 123, size=(maxlen, count), dtype=np.int32)
        mask = np.arange(maxlen)[:, None] < lens[None, :]
        return np.where(mask, chars, 0), lens

    q_chars, q_lens = make_batch(n_queries, rows)
    q_t = np.where(np.arange(rows)[:, None] < q_lens[None, :], q_chars, -1)
    c_chars, c_lens = make_batch(n_cands, cand_len)

    args = (
        jnp.asarray(q_t.astype(np.int32)),
        jnp.asarray(q_lens.reshape(-1, 1)),
        jnp.asarray(c_chars),
        jnp.asarray(c_lens.reshape(1, -1)),
    )

    q_j, ql_j, c_j, cl_j = args

    def run():
        return myers_distances(q_j, ql_j, c_j, cl_j)

    warm = np.asarray(run())  # compile + warm
    # sanity: distances bounded by max(len_q, len_c)
    assert warm.max() <= max(int(q_lens.max()), int(c_lens.max()))

    cells = float(np.outer(q_lens.astype(np.int64), c_lens.astype(np.int64)).sum())

    # calibrate the iteration count from one call, then measure in one shot
    t0 = time.perf_counter()
    run().block_until_ready()
    per_call = max(time.perf_counter() - t0, 1e-4)
    iters = max(int(duration / per_call), 3)

    start = time.perf_counter()
    for _ in range(iters):
        out = run()
    out.block_until_ready()
    elapsed = time.perf_counter() - start
    gcups = cells * iters / elapsed / 1e9

    baseline_gcups = 3.434427548  # reference SPR single-socket, README.md:266-283
    print(json.dumps({
        "metric": "batched_levenshtein_throughput",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / baseline_gcups, 3),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
