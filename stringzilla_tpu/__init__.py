"""stringzilla_tpu — a batch string-processing framework for GPUs.

A JAX/XLA/Pallas re-design of the capabilities of StringZilla v5: batch
similarity scoring, rolling MinHash fingerprints, exact search, hashing,
sorting, and Unicode processing, device-resident over Arrow-style tapes and
sharded across device meshes.

Layout (mirrors the reference's two-tier split, ``README.md:368-376``):

* ``stringzilla_tpu.ops``     — kernels: plain XLA forms + Pallas kernels
* ``stringzilla_tpu.models``  — engine classes (the ``szs.*`` public API)
* ``stringzilla_tpu.parallel``— mesh sharding / collectives
* ``stringzilla_tpu.utils``   — platform dispatch, helpers
"""

from .models.device_scope import DeviceScope
from .models.str_api import (
    File,
    FindSplits,
    Str,
    Strs,
    Utf8Delimiters,
    Utf8Newlines,
    Utf8SplitDelimiters,
    Utf8SplitNewlines,
    Utf8SplitWhitespaces,
    Utf8Whitespaces,
    Utf8Wordbreaks,
)
from .models.fingerprints import Fingerprints
from .models.similarities import (
    LevenshteinDistances,
    LevenshteinDistancesUTF8,
    NeedlemanWunsch,
    NeedlemanWunschScores,
    SmithWaterman,
    SmithWatermanScores,
)
from .ops import find as _find
from .ops.hash import Hasher, Sha256, bytesum, fill_random, hash_multiseed, hmac_sha256, random, sz_hash
from .ops.compare import batch_equal, batch_order, equal
from .ops.compare import order as compare_order
from .ops.intersect import intersect
from .ops.sort import argsort_strings
from .ops import utf8 as _u
from .ops import utf8_segment as _useg
from .ops.tape import Tape
from .utils import platform

# Module-level function surface mirroring the reference binding
# (``python/stringzilla.c:9531-9612``). find/rfind/count dispatch through
# ``Str`` so big buffers take the same device tier as ``Str.find``.


def find(haystack, needle) -> int:
    """Offset of the first occurrence, -1 if absent (``sz_find``)."""
    s = haystack if isinstance(haystack, Str) else Str(haystack)
    return s.find(needle)


def rfind(haystack, needle) -> int:
    """Offset of the last occurrence (``sz_rfind``)."""
    s = haystack if isinstance(haystack, Str) else Str(haystack)
    return s.rfind(needle)


def count(haystack, needle, allowoverlap: bool = False) -> int:
    """Occurrence count (non-overlapping by default, matching ``Str.count``
    and the reference binding's ``sz.count``)."""
    s = haystack if isinstance(haystack, Str) else Str(haystack)
    return s.count(needle, allowoverlap=allowoverlap)



def split(text, separator=b" ", maxsplit: int = -1, keepseparator: bool = False):
    """Split into a zero-copy ``Strs`` view (binding ``Str.split``)."""
    s = text if isinstance(text, Str) else Str(text)
    return s.split(separator, maxsplit=maxsplit, keepseparator=keepseparator)


def split_iter(text, separator=b" ", keepseparator: bool = False):
    """Lazy split iterator (binding ``Str.split_iter``; ``find_splits_view``,
    reference ``stringzilla.hpp:742``)."""
    s = text if isinstance(text, Str) else Str(text)
    return s.split_iter(separator, keepseparator=keepseparator)


def splitlines(text, keeplinebreaks: bool = False):
    s = text if isinstance(text, Str) else Str(text)
    return s.splitlines(keeplinebreaks=keeplinebreaks)


def translate(text, lut) -> bytes:
    """256-byte LUT transform (``sz_lookup``; binding ``Str.translate``)."""
    s = text if isinstance(text, Str) else Str(text)
    return bytes(s.translate(lut))


def sha256(data) -> bytes:
    """One-shot SHA-256 digest (own FIPS 180-4 implementation)."""
    return Sha256(bytes(data) if not isinstance(data, (bytes, bytearray))
                  else data).digest()


def reset_capabilities(*caps) -> None:
    """Restrict/restore the backend tier (binding ``sz.reset_capabilities``,
    reference ``README.md:954-962``): ``reset_capabilities('serial')`` forces
    the host/interpreted tier, ``reset_capabilities('gpu')`` the compiled
    GPU tier, ``reset_capabilities()`` restores detection."""
    if not caps or caps == ("all",):
        platform.force_backend(None)
    elif "serial" in caps or "interpret" in caps:
        platform.force_backend("cpu")
    elif "gpu" in caps:
        platform.force_backend("gpu")
    else:
        raise ValueError(f"unknown capability set {caps!r}")


find_byteset = _find.find_byteset
rfind_byteset = _find.rfind_byteset
hash = sz_hash  # noqa: A001 - intentional API parity with the reference
order = compare_order  # reference binding name
argsort = argsort_strings
lookup = translate
utf8_is_normalized = _u.utf8_is_normalized
utf8_find_cased = _u.utf8_find_cased


def utf8_valid(data) -> bool:
    """Well-formed UTF-8 check (device pass for big ``Str`` buffers)."""
    from .ops.utf8_device import utf8_valid as _uv

    return _uv(data)


def _via_str(name):
    def fn(text, *args, **kwargs):
        s = text if isinstance(text, Str) else Str(text)
        return getattr(s, name)(*args, **kwargs)

    fn.__name__ = name
    fn.__doc__ = f"Module-level form of ``Str.{name}`` (reference binding)."
    return fn


count_byteset = _via_str("count_byteset")
utf8_codepoints = _via_str("utf8_codepoints")
utf8_split_whitespaces = _via_str("utf8_split_whitespaces")
utf8_split_newlines = _via_str("utf8_split_newlines")
utf8_split_delimiters = _via_str("utf8_split_delimiters")
utf8_uncased_fold = _via_str("utf8_uncased_fold")
utf8_uncased_search = _via_str("utf8_uncased_search")
utf8_uncased_matches = _via_str("utf8_uncased_matches")
utf8_count = _u.utf8_count
utf8_decode = _u.utf8_decode
utf8_seek = _u.utf8_seek
utf8_fold = _u.utf8_fold
utf8_norm = _u.utf8_norm
utf8_find_denormalized = _u.utf8_find_denormalized
utf8_uncased_find = _u.utf8_uncased_find
utf8_uncased_order = _u.utf8_uncased_order
utf8_words = _useg.utf8_words
# The reference binding's module-level segmenters yield Str views
# (python/stringzilla.c: "Iterator yielding Str objects ..."). The
# offset/span-returning kernels remain at ops.utf8 / ops.utf8_segment.
utf8_newlines = _via_str("utf8_newlines")
utf8_whitespaces = _via_str("utf8_whitespaces")
utf8_delimiters = _via_str("utf8_delimiters")
utf8_graphemes = _via_str("utf8_graphemes")
utf8_wordbreaks = _via_str("utf8_wordbreaks")
utf8_sentences = _via_str("utf8_sentences")
utf8_linebreaks = _via_str("utf8_linebreaks")

__version__ = "0.1.0"


def __capabilities__():
    return platform.capabilities()


def __getattr__(name):
    # Lazy: the reference exports __capabilities_str__ as a module string
    # constant (python/stringzilla.c:9695); computing it touches the JAX
    # backend, so defer until first access rather than at import.
    if name == "__capabilities_str__":
        return ",".join(platform.capabilities())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FindSplits",
    "Utf8Wordbreaks",
    "Utf8Newlines",
    "Utf8Whitespaces",
    "Utf8Delimiters",
    "Utf8SplitNewlines",
    "Utf8SplitWhitespaces",
    "Utf8SplitDelimiters",
    "DeviceScope",
    "File",
    "Str",
    "Strs",
    "Hasher",
    "Sha256",
    "argsort_strings",
    "bytesum",
    "count",
    "fill_random",
    "random",
    "find",
    "find_byteset",
    "hash",
    "hash_multiseed",
    "hmac_sha256",
    "batch_equal",
    "batch_order",
    "compare_order",
    "equal",
    "intersect",
    "order",
    "argsort",
    "lookup",
    "translate",
    "split",
    "split_iter",
    "splitlines",
    "sha256",
    "reset_capabilities",
    "rfind",
    "rfind_byteset",
    "utf8_is_normalized",
    "utf8_find_cased",
    "utf8_valid",
    "count_byteset",
    "utf8_codepoints",
    "utf8_split_whitespaces",
    "utf8_split_newlines",
    "utf8_split_delimiters",
    "utf8_uncased_fold",
    "utf8_uncased_search",
    "utf8_uncased_matches",
    "utf8_count",
    "utf8_decode",
    "utf8_seek",
    "utf8_fold",
    "utf8_norm",
    "utf8_find_denormalized",
    "utf8_uncased_find",
    "utf8_uncased_order",
    "utf8_newlines",
    "utf8_whitespaces",
    "utf8_delimiters",
    "utf8_graphemes",
    "utf8_words",
    "utf8_wordbreaks",
    "utf8_sentences",
    "utf8_linebreaks",
    "Fingerprints",
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunsch",
    "NeedlemanWunschScores",
    "SmithWaterman",
    "SmithWatermanScores",
    "Tape",
    "__capabilities__",
]
