#!/usr/bin/env python
"""Fuzzy join of two string collections by edit distance.

The reference's headline batch workload (``szs.LevenshteinDistances``):
score every (query, candidate) pair on the GPU and pick the best match
per query under a distance budget.

    python examples/fuzzy_join.py
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stringzilla_tpu as sz  # noqa: E402


def main():
    rng = np.random.default_rng(3)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)

    candidates = [bytes(rng.choice(alphabet, int(l)))
                  for l in rng.integers(8, 40, 20000)]
    # queries: mutated copies of random candidates
    queries = []
    truth = []
    for _ in range(64):
        i = int(rng.integers(0, len(candidates)))
        q = bytearray(candidates[i])
        for p in rng.choice(len(q), max(1, len(q) // 10), replace=False):
            q[p] = int(rng.choice(alphabet))
        queries.append(bytes(q))
        truth.append(i)

    engine = sz.LevenshteinDistances()
    dists = engine(queries, candidates)  # (64, 20000) on device

    best = np.argmin(dists, axis=1)
    hits = sum(int(dists[r, best[r]]) <= int(dists[r, truth[r]])
               for r in range(len(queries)))
    print(f"{hits}/{len(queries)} queries matched a candidate at least as "
          f"close as their mutation source")
    for r in range(5):
        print(f"  {queries[r][:24]!r}... -> {candidates[best[r]][:24]!r}... "
              f"(distance {int(dists[r, best[r]])})")


if __name__ == "__main__":
    main()
