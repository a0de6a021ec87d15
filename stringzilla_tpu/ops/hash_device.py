"""Batched ``sz_hash`` and ``fill_random`` on the device.

The reference hashes one string per call with AES-NI (reference
``hash/serial.h:506-599``; throughput numbers in ``bench/token.cpp``) and
fills buffers with an AES-CTR stream (``sz_fill_random``,
``hash/serial.h:953``). Here a whole collection advances together: token
bytes are laid out as ``(16·B, lanes)`` int32 byte planes (byte ``b`` of
token ``l`` at ``[b, l]``), and every AES round is plain XLA over all
lanes:

* SubBytes is a gather from the 256-entry S-box; ShiftRows a fixed row
  gather; MixColumns the 4-byte group rotation of ``ops.hash.aesenc``;
* the sum lane's u64 addition carries across two u32 words;
* the length-dependent final key is built lane-wise from the runtime
  length vector.

Tokens are bucketed by 16-byte block count (1..4 for the <= 64 B short path,
the bulk of token workloads); longer strings take the four-lane long path,
a ``scan`` over 64-byte chunks bucketed by dyadic chunk count. Outputs are
bit-identical to ``ops.hash.sz_hash`` / ``fill_random`` for every length
and seed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .hash import PI, SBOX, SHIFTROWS_SRC, SHUFFLE, sz_hash

__all__ = ["aes_round", "fill_random_device", "hash_tokens_raw",
           "hash_batch_device", "hash_bounds_device", "hash_long_device"]

LANES_BLOCK = 1024  # lane-count granularity of the token buckets


def _groups(x):
    """``(16·G, L)`` → ``(G, 16, L)``."""
    return x.reshape(-1, 16, x.shape[-1])


def aes_round(state: jnp.ndarray, key: jnp.ndarray) -> jnp.ndarray:
    """One AESENC round (SubBytes ∘ ShiftRows ∘ MixColumns ⊕ key) on
    ``(16·G, lanes)`` int32 byte planes (values 0..255), each 16-row group
    one block — bit-identical to ``ops.hash.aesenc``."""
    sub = jnp.take(jnp.asarray(SBOX.astype(np.int32)), state)
    shifted = jnp.take(_groups(sub), jnp.asarray(SHIFTROWS_SRC), axis=1)
    cols = shifted.reshape(shifted.shape[0], 4, 4, shifted.shape[-1])
    g2 = cols ^ jnp.roll(cols, -1, axis=2)
    xor_all = g2 ^ jnp.roll(g2, -2, axis=2)
    dbl = ((g2 << 1) ^ (((g2 >> 7) & 1) * 0x1B)) & 0xFF
    return (cols ^ xor_all ^ dbl).reshape(state.shape) ^ key


def _u32_words(planes):
    """``(8·W, L)`` byte planes → ``(W, 2, L)`` uint32 (lo, hi) words."""
    b = planes.reshape(-1, 2, 4, planes.shape[-1]).astype(jnp.uint32)
    sh = jnp.asarray([0, 8, 16, 24], jnp.uint32)[None, None, :, None]
    return (b << sh).sum(axis=2, dtype=jnp.uint32)


def _byte_planes(words):
    """Inverse of :func:`_u32_words`."""
    sh = jnp.asarray([0, 8, 16, 24], jnp.uint32)[None, None, :, None]
    b = (words[:, :, None, :] >> sh) & jnp.uint32(0xFF)
    return b.reshape(-1, words.shape[-1]).astype(jnp.int32)


def _sum_update(summ, data):
    """shuffle(sum) + data as wrapping little-endian u64 lanes
    (``hash/serial.h:299-302``)."""
    shuffled = jnp.take(_groups(summ), jnp.asarray(SHUFFLE), axis=1)
    a = _u32_words(shuffled.reshape(summ.shape))
    b = _u32_words(data)
    lo = a[:, 0] + b[:, 0]
    hi = a[:, 1] + b[:, 1] + (lo < a[:, 0]).astype(jnp.uint32)
    return _byte_planes(jnp.stack([lo, hi], axis=1))


def _key_with_length(seed_words, lens):
    """``(16, L)`` planes of the u64 pair (seed + len, seed)."""
    seed_lo, seed_hi = seed_words[0], seed_words[1]
    lo = seed_lo + lens.astype(jnp.uint32)
    hi = seed_hi + (lo < seed_lo).astype(jnp.uint32)
    L = lens.shape[0]
    words = jnp.stack([jnp.stack([lo, hi]),
                       jnp.broadcast_to(jnp.stack([seed_lo, seed_hi])[:, None],
                                        (2, L))])
    return _byte_planes(words)


def _seed_planes(seed: int, rows: int) -> np.ndarray:
    """``(rows, 2)`` byte columns of seed ^ PI for the aes and sum lanes."""
    k = rows // 8
    with np.errstate(over="ignore"):
        aes = (np.uint64(seed) ^ PI[0:k]).astype("<u8").view(np.uint8)
        summ = (np.uint64(seed) ^ PI[8:8 + k]).astype("<u8").view(np.uint8)
    return np.stack([aes, summ], axis=1).astype(np.int32)


def _seed_words(seed: int) -> np.ndarray:
    return np.array([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF],
                    dtype=np.uint32)


def _digest_words(out):
    """``(16, L)`` final planes → ``(2, L)`` int32 lo/hi digest words, so the
    host pull is 8 B/token."""
    return _u32_words(out[:8])[0].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _hash_short(data, lens, seed_words, pib, n_blocks: int):
    L = data.shape[1]
    aes = jnp.broadcast_to(pib[:, 0:1], (16, L))
    summ = jnp.broadcast_to(pib[:, 1:2], (16, L))
    for b in range(n_blocks):
        block = data[b * 16:(b + 1) * 16]
        aes = aes_round(aes, block)
        summ = _sum_update(summ, block)
    kwl = _key_with_length(seed_words, lens)
    mixed = aes_round(summ, aes)
    return aes_round(aes_round(mixed, kwl), mixed)


def hash_tokens_raw(data2d, lengths, seed: int, n_blocks: int):
    """Device-resident short path: ``data2d`` is ``(16*n_blocks, n) int32``
    zero-padded token bytes (tokens across lanes), ``lengths (n,)``;
    returns ``(16, n)`` int32 byte planes — no host transfer."""
    return _hash_short(jnp.asarray(data2d), jnp.asarray(lengths).reshape(-1),
                       jnp.asarray(_seed_words(seed)),
                       jnp.asarray(_seed_planes(seed, 16)), n_blocks=n_blocks)


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _hash_short_tape(blob, offs, lens, seed_words, pib, n_blocks: int):
    """Gather the bucket's bytes from the resident blob, then hash."""
    from .pack_device import pack_on_device

    data = pack_on_device(blob, offs, lens, row_len=16 * n_blocks,
                          transpose=True)
    return _digest_words(_hash_short(data, lens, seed_words, pib,
                                     n_blocks=n_blocks))


@functools.partial(jax.jit, static_argnames=("ncm",))
def _hash_long_tape(blob, offs, lens, seed_words, pi8, ncm: int):
    """Long path (> 64 B): 512-bit state as four stacked AES lanes
    (64 rows), a ``scan`` over up to ``ncm`` full 64-byte chunks, each lane
    masked live below its own chunk count; then the deferred (zero-padded)
    final block and the reference's lane-collapse finalization
    (``hash/serial.h:443-500``)."""
    from .pack_device import pack_on_device

    L = lens.shape[0]
    chunks = jnp.maximum(lens - 1, 0) // 64
    data = pack_on_device(blob, offs, chunks * 64, row_len=64 * ncm,
                          transpose=True).reshape(ncm, 64, L)
    fin = pack_on_device(blob, offs + chunks * 64, lens - chunks * 64,
                         row_len=64, transpose=True)
    aes0 = jnp.broadcast_to(pi8[:, 0:1], (64, L))
    sum0 = jnp.broadcast_to(pi8[:, 1:2], (64, L))

    def absorb(carry, inp):
        aes, summ = carry
        k, blk = inp
        live = k < chunks
        return (jnp.where(live, aes_round(aes, blk), aes),
                jnp.where(live, _sum_update(summ, blk), summ)), None

    (aes, summ), _ = jax.lax.scan(absorb, (aes0, sum0),
                                  (jnp.arange(ncm), data))
    mixed = aes_round(_sum_update(summ, fin), aes_round(aes, fin))
    m01 = aes_round(mixed[0:16], mixed[16:32])
    m23 = aes_round(mixed[32:48], mixed[48:64])
    mall = aes_round(m01, m23)
    kwl = _key_with_length(seed_words, lens)
    return _digest_words(aes_round(aes_round(mall, kwl), mall))


def _u64_from_u32_pair(out: np.ndarray, n: int) -> np.ndarray:
    """(2, L) int32 device pull → u64[n] (lo word row 0, hi word row 1)."""
    lo = out[0, :n].astype(np.uint32).astype(np.uint64)
    hi = out[1, :n].astype(np.uint32).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def _lanes_for(n: int) -> int:
    """Dyadic lane count (a compile key) in LANES_BLOCK multiples."""
    total = max(1 << max(n - 1, 1).bit_length(), LANES_BLOCK)
    return -(-total // LANES_BLOCK) * LANES_BLOCK


def _hash_short_bucket(dt, idx, seed: int, n_blocks: int):
    offs, lens = dt.bucket_arrays(np.asarray(idx, dtype=np.int64),
                                  _lanes_for(len(idx)))
    return _hash_short_tape(dt.data, offs, lens,
                            jnp.asarray(_seed_words(seed)),
                            jnp.asarray(_seed_planes(seed, 16)),
                            n_blocks=n_blocks)


def _hash_long_bucket(dt, idx, seed: int, ncm: int):
    # dyadic lane count: the packed chunks take 256 B per lane per chunk
    offs, lens = dt.bucket_arrays(np.asarray(idx, dtype=np.int64),
                                  max(8, 1 << (len(idx) - 1).bit_length()))
    return _hash_long_tape(dt.data, offs, lens,
                           jnp.asarray(_seed_words(seed)),
                           jnp.asarray(_seed_planes(seed, 64)), ncm=ncm)


# Strings up to 2 MiB run on device; bigger ones take the host path.
LONG_DEVICE_MAX = 2 << 20


def _hash_tape_core(dt, seed: int, get_bytes) -> np.ndarray:
    lens = dt.lengths
    n = len(dt)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    short = lens <= 64
    nb_short = np.maximum(1, -(-lens // 16))
    long_mask = (~short) & (lens <= LONG_DEVICE_MAX)
    huge = np.nonzero((~short) & (~long_mask))[0]
    chunk_count = np.maximum(lens - 1, 0) // 64
    ncm_long = np.zeros(n, dtype=np.int64)
    nz = long_mask.nonzero()[0]
    if len(nz):
        ncm_long[nz] = 1 << np.ceil(
            np.log2(np.maximum(chunk_count[nz], 1))).astype(np.int64)
    pending = []
    for nb in np.unique(nb_short[short]):
        idx = np.nonzero(short & (nb_short == nb))[0]
        pending.append((idx, _hash_short_bucket(dt, idx, seed, int(nb))))
    for ncm in np.unique(ncm_long[long_mask]):
        idx = np.nonzero(long_mask & (ncm_long == ncm))[0]
        pending.append((idx, _hash_long_bucket(dt, idx, seed, int(ncm))))
    for idx, dev in pending:  # all buckets enqueued before the first pull
        out[idx] = _u64_from_u32_pair(np.asarray(dev), len(idx))
    for i in huge:
        out[i] = sz_hash(get_bytes(int(i)), seed)
    return out


def hash_batch_device(items, seed: int = 0) -> np.ndarray:
    """Device-batched ``sz_hash`` over a collection (bit-identical to the
    reference, golden-vector-tested). Accepts a list of byte strings or a
    :class:`~stringzilla_tpu.ops.tape.Tape`. The blob goes to the device
    once; gather/packing happens there."""
    from .pack_device import device_tape
    from .tape import Tape

    tape = items if isinstance(items, Tape) else Tape.from_strings(
        [bytes(s) for s in items])
    return _hash_tape_core(device_tape(tape), seed, lambda i: tape[i])


def hash_long_device(items: list[bytes], seed: int, ncm: int) -> np.ndarray:
    """Hash strings > 64 B on device in one ``ncm``-chunk bucket. Returns
    u64 digests in input order."""
    from .pack_device import device_tape
    from .tape import Tape

    dt = device_tape(Tape.from_strings(items))
    out = np.asarray(_hash_long_bucket(dt, np.arange(len(items)), seed, ncm))
    return _u64_from_u32_pair(out, len(items))


def hash_bounds_device(buf, starts, ends, seed: int = 0) -> np.ndarray:
    """``sz_hash`` over (start, end) spans of one buffer — the zero-copy
    ``Strs.hashes`` path: the parent buffer mirrors to the device once and
    every span is gathered there."""
    from .pack_device import DeviceTape

    buf = np.asarray(buf, dtype=np.uint8)
    dt = DeviceTape.from_bounds(buf, starts, ends)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    return _hash_tape_core(dt, seed,
                           lambda i: buf[starts[i]:ends[i]].tobytes())


# ---------------------------------------------------------------------------
# fill_random: AES-CTR
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _fill(nonce_words, pib, n_blocks: int):
    """Block ``l`` is ``AESENC(nonce+l ‖ nonce+l, nonce ^ PI[2(l%4)..])``."""
    lane = jnp.arange(n_blocks, dtype=jnp.uint32)
    lo = nonce_words[0] + lane
    hi = nonce_words[1] + (lo < nonce_words[0]).astype(jnp.uint32)
    ctr = jnp.stack([lo, hi])  # one u64 lane, repeated in both halves
    inp = _byte_planes(jnp.stack([ctr, ctr]))
    nonce = _byte_planes(jnp.broadcast_to(
        jnp.stack([nonce_words, nonce_words])[:, :, None], (2, 2, 1)))
    key = jnp.take(pib, lane.astype(jnp.int32) & 3, axis=1) ^ nonce
    return aes_round(inp, key)


def fill_random_device(length: int, nonce: int = 0) -> jnp.ndarray:
    """Device-resident ``sz_fill_random``: returns ``uint8[length]`` on the
    device, bit-identical to the host path."""
    if length <= 0:
        return jnp.zeros(0, jnp.uint8)
    n_blocks = -(-length // 16)
    n_blocks = -(-n_blocks // LANES_BLOCK) * LANES_BLOCK  # bounded compiles
    pi_bytes = PI[:8].astype("<u8").view(np.uint8).reshape(4, 16)
    pib = np.ascontiguousarray(pi_bytes.T).astype(np.int32)  # (16, 4)
    out = _fill(jnp.asarray(_seed_words(nonce)), jnp.asarray(pib),
                n_blocks=n_blocks)
    # (16, blocks) byte planes → linear bytes: position = lane*16 + row
    return out.T.reshape(-1).astype(jnp.uint8)[:length]
