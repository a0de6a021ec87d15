"""Arrow-style string tapes — the device-resident string collection format.

The reference's batch ABI takes strings either through a callback ``sz_sequence_t``
or as Arrow tapes: one contiguous data blob plus ``count+1`` offsets
(``sz_sequence_u32tape_t`` / ``u64tape_t``, reference
``include/stringzillas/stringzillas.h:61-76``). The tape layout is exactly what a
device wants — a dense ``u8`` device array plus an offsets array — so it is the
native container here, not a compatibility shim.

Ragged→dense conversion happens through *length-bucketed packing*: strings are
grouped into dyadic length buckets (the same <2× spread rule the reference uses to
bound transpose zero-padding in ``candidate_length_bucket_``, reference
``include/stringzillas/similarities/serial.hpp:3437-3444``) and padded to the
bucket's max length, so every Pallas kernel sees static shapes with bounded
padding waste.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Tape", "pack_dense", "dyadic_bucket", "round_up"]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def ladder(n: int, mantissa_bits: int = 3) -> int:
    """Smallest value >= n of the form m * 2^e with m < 2^(mantissa_bits+1)
    — a coarse dyadic ladder (waste <= 2^-mantissa_bits) that bounds the
    number of distinct padded shapes (and therefore kernel compiles) to
    O(2^mantissa_bits * log n) across arbitrarily-sized inputs."""
    n = max(int(n), 1)
    if n < (1 << (mantissa_bits + 1)):
        return n
    e = n.bit_length() - 1 - mantissa_bits
    return -(-n >> e) << e


def _as_bytes(item) -> bytes:
    if isinstance(item, bytes):
        return item
    if isinstance(item, bytearray):
        return bytes(item)
    if isinstance(item, memoryview):
        return bytes(item)
    if isinstance(item, str):
        return item.encode("utf-8")
    if isinstance(item, np.ndarray) and item.dtype == np.uint8:
        return item.tobytes()
    raise TypeError(f"can't interpret {type(item)!r} as a byte string")


@dataclasses.dataclass(frozen=True)
class Tape:
    """A collection of byte strings as ``(data, offsets)`` arrays.

    ``data`` is ``uint8[total_bytes]`` (host numpy or device jax array);
    ``offsets`` is ``int64[count+1]`` with ``offsets[0] == 0``. String ``i``
    occupies ``data[offsets[i]:offsets[i+1]]``.
    """

    data: np.ndarray
    offsets: np.ndarray

    @classmethod
    def from_strings(cls, items: Iterable) -> "Tape":
        blobs = [_as_bytes(s) for s in items]
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        if blobs:
            np.cumsum([len(b) for b in blobs], out=offsets[1:])
        data = np.frombuffer(b"".join(blobs), dtype=np.uint8).copy()
        return cls(data=data, offsets=offsets)

    @classmethod
    def from_arrow(cls, obj) -> "Tape":
        """Build a tape from any Arrow array producer (an object exposing
        ``__arrow_c_array__`` — pyarrow/polars/duckdb binary or string
        arrays). One buffer copy; the reference consumes the same capsules
        in its ``Strs`` constructor (``python/stringzilla.c:8537``)."""
        from ..models.arrow import tape_arrays_from_arrow

        data, offsets = tape_arrays_from_arrow(obj)
        return cls(data=data, offsets=offsets)

    def __arrow_c_array__(self, requested_schema=None):
        """Zero-copy Arrow PyCapsule export as ``large_binary`` (the
        reference's ``Strs.__arrow_c_array__``, ``python/stringzilla.c:15``).
        Device-resident tapes are pulled to host first."""
        from ..models.arrow import export_tape_capsules

        return export_tape_capsules(np.asarray(self.offsets),
                                    np.asarray(self.data))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return np.asarray(self.data[lo:hi]).tobytes()

    def to_list(self) -> list[bytes]:
        return [self[i] for i in range(len(self))]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def total_bytes(self) -> int:
        return int(self.offsets[-1])


def pack_dense(
    tape: Tape,
    indices: Sequence[int] | np.ndarray | None = None,
    pad_length: int | None = None,
    pad_count_multiple: int = 1,
    transpose: bool = False,
    fill: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack (a subset of) a tape into a dense padded matrix.

    Returns ``(chars, lengths)`` where ``chars`` is ``uint8[count_padded, L]``
    (or ``[L, count_padded]`` when ``transpose``, the column-major layout the
    lane-packed DP kernels consume — candidates across lanes, characters down
    rows, mirroring ``candidate_lanes_block`` in the reference,
    ``include/stringzillas/types.hpp:316-330``).
    """
    if indices is None:
        indices = np.arange(len(tape))
    indices = np.asarray(indices, dtype=np.int64)
    lengths = (tape.offsets[indices + 1] - tape.offsets[indices]).astype(np.int32)
    max_len = int(lengths.max()) if len(lengths) else 0
    length = pad_length if pad_length is not None else max_len
    if length < max_len:
        raise ValueError(f"pad_length {length} < longest string {max_len}")
    count = round_up(len(indices), pad_count_multiple)
    chars = np.full((count, max(length, 1)), fill, dtype=np.uint8)
    data = np.asarray(tape.data)
    offsets = tape.offsets
    for row, idx in enumerate(indices):
        lo, hi = int(offsets[idx]), int(offsets[idx + 1])
        chars[row, : hi - lo] = data[lo:hi]
    lengths_padded = np.zeros(count, dtype=np.int32)
    lengths_padded[: len(indices)] = lengths
    if transpose:
        chars = np.ascontiguousarray(chars.T)
    return chars, lengths_padded


def dyadic_bucket(length: int, minimum: int = 8) -> int:
    """Smallest power-of-two padded length ≥ ``length`` (and ≥ ``minimum``).

    Bounds per-bucket padding waste below 2×, the same dyadic grouping rule as
    the reference's ``candidate_length_bucket_`` (reference
    ``similarities/serial.hpp:3442-3444``), and bounds the number of distinct
    jit specializations to O(log max_len).
    """
    n = max(int(length), minimum)
    return 1 << (n - 1).bit_length()


def group_by_dyadic_length(lengths: np.ndarray, minimum: int = 8) -> dict[int, np.ndarray]:
    """Map dyadic bucket size → indices of strings belonging to it."""
    lengths = np.asarray(lengths)
    buckets: dict[int, list[int]] = {}
    padded = np.maximum(lengths, minimum).astype(np.int64)
    exponents = np.ceil(np.log2(np.maximum(padded, 1))).astype(np.int64)
    sizes = (1 << exponents).astype(np.int64)
    for bucket in np.unique(sizes):
        buckets[int(bucket)] = np.nonzero(sizes == bucket)[0]
    return buckets
