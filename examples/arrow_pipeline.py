#!/usr/bin/env python
"""Zero-copy Arrow interop: pyarrow in → device engines → Arrow out.

The reference's Python binding speaks the Arrow PyCapsule protocol on
``Strs`` (``python/stringzilla.c:15``); here the same protocol connects any
Arrow producer (pyarrow, polars, duckdb) straight to the batch engines, and
exports results back without copying the data blob.

    python examples/arrow_pipeline.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stringzilla_tpu as sz  # noqa: E402


def main():
    try:
        import pyarrow as pa
    except ImportError:
        print("pyarrow not installed; this example needs it")
        return

    rng = np.random.default_rng(42)
    words = [bytes(rng.integers(97, 123, int(n)).astype(np.uint8))
             for n in rng.integers(4, 20, 20_000)]

    # 1. Arrow producer -> Strs without materializing Python objects
    arrow_col = pa.array(words, type=pa.binary())
    strs = sz.Strs(arrow_col)
    print(f"imported {len(strs)} strings from a pyarrow {arrow_col.type} column")

    # 2. Run batch work on the collection
    order = strs.order()
    top = [bytes(strs[int(i)]) for i in order[:3]]
    print(f"argsort over the tape: first 3 = {top}")

    queries = strs[:4].to_list()
    dists = sz.LevenshteinDistances()(queries, strs[:512].to_list())
    print(f"levenshtein {dists.shape}: row0 min={int(np.min(dists[0]))}")

    # 3. Export back to Arrow zero-copy (capsules alias the tape buffers)
    out = pa.array(strs)
    assert out.to_pylist() == words
    print(f"round-tripped to pyarrow: {out.type}, {len(out)} items, "
          f"{out.nbytes} bytes shared zero-copy")


if __name__ == "__main__":
    main()
