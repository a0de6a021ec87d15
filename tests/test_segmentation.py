"""UAX-29 / UAX-14 conformance.

Graphemes are differential against the independent ``regex`` engine's
``\\X`` (a true extended-grapheme-cluster oracle). Word boundaries are
dual-implementation: the vectorized tier (ops/segment.py) vs a sequential
rule engine written here straight from the UAX-29 §4 rule list — same
generated UCD classes, completely different evaluation — over BreakTest-
style pair matrices and fuzz strings. (``regex``'s ``(?w)\\b`` is tailored
— leading quotes/joiners attach — so it is used only for real-text word
token sanity, not raw boundaries.)"""

import numpy as np
import pytest

regex = pytest.importorskip("regex")

from stringzilla_tpu.ops import segment as S
from stringzilla_tpu.ops import ucd
from stringzilla_tpu.ops.utf8 import utf8_fold, utf8_graphemes, utf8_uncased_find
from stringzilla_tpu.ops.utf8_segment import (
    utf8_linebreaks,
    utf8_sentences,
    utf8_words,
)

SAMPLES = [
    0x0041, 0x0061, 0x0027, 0x2019, 0x0022, 0x05D0, 0x05F4,  # letters/quotes
    0x0031, 0x002C, 0x002E, 0x003A, 0x005F, 0x0020, 0x00A0,  # digits/mid/space
    0x000A, 0x000D, 0x0085, 0x2028, 0x200D, 0x200C, 0x00AD,  # seps/joiners
    0x0301, 0x0308, 0x0903, 0x1100, 0x1160, 0x11A8, 0xAC00, 0xAC01,  # marks/hangul
    0x1F1E6, 0x1F1E7, 0x1F600, 0x2764, 0xFE0F, 0x261D, 0x1F3FB,  # RI/emoji
    0x30A2, 0x4E00, 0x3042, 0x0E01, 0x0644, 0x0928, 0x093C, 0x094D,  # scripts
]


def grapheme_oracle(s: str):
    pos = [len(s[: m.end()].encode()) for m in regex.finditer(r"\X", s)]
    return pos[:-1] if pos else []


# ---------------------------------------------------------------------------
# Independent sequential WB engine (UAX-29 §4, rule-by-rule)
# ---------------------------------------------------------------------------


def _wb_name(r: int) -> str:
    return ucd.WB_VALUES[ucd.wb_classes()[r]]


def word_breaks_sequential(s: str):
    """Rune-at-a-time UAX-29 word boundaries, written independently of the
    vectorized formulation."""
    runes = [ord(c) for c in s]
    n = len(runes)
    if n == 0:
        return []
    cls = [_wb_name(r) for r in runes]
    ep = ucd.gcb_ext_pict()
    # WB4 collapse into elements (E/F/Z attach unless after sot/CR/LF/Newline)
    elements = []  # (rune_index, class)
    for i, (r, c) in enumerate(zip(runes, cls)):
        if (c in ("Extend", "Format", "ZWJ") and elements
                and elements[-1][1] not in ("CR", "LF", "Newline")):
            continue
        elements.append((i, c))
    AHL = ("ALetter", "Hebrew_Letter")
    MIDL = ("MidLetter", "MidNumLet", "Single_Quote")
    MIDN = ("MidNum", "MidNumLet", "Single_Quote")
    breaks = []
    ri = 0
    for k in range(1, len(elements)):
        i, cur = elements[k]
        _, prev = elements[k - 1]
        p2 = elements[k - 2][1] if k >= 2 else None
        nxt = elements[k + 1][1] if k + 1 < len(elements) else None
        ri = ri + 1 if prev == "Regional_Indicator" else 0
        if prev == "CR" and cur == "LF":
            continue  # WB3
        if prev in ("CR", "LF", "Newline") or cur in ("CR", "LF", "Newline"):
            breaks.append(i)  # WB3a/b
            continue
        if cls[i - 1] == "ZWJ" and ep[runes[i]]:
            continue  # WB3c (raw adjacency)
        if prev == "WSegSpace" and cur == "WSegSpace":
            continue  # WB3d
        if prev in AHL and cur in AHL:
            continue  # WB5
        if prev in AHL and cur in MIDL and nxt in AHL:
            continue  # WB6
        if p2 in AHL and prev in MIDL and cur in AHL:
            continue  # WB7
        if prev == "Hebrew_Letter" and cur == "Single_Quote":
            continue  # WB7a
        if prev == "Hebrew_Letter" and cur == "Double_Quote" and nxt == "Hebrew_Letter":
            continue  # WB7b
        if p2 == "Hebrew_Letter" and prev == "Double_Quote" and cur == "Hebrew_Letter":
            continue  # WB7c
        if prev == "Numeric" and cur == "Numeric":
            continue  # WB8
        if prev in AHL and cur == "Numeric":
            continue  # WB9
        if prev == "Numeric" and cur in AHL:
            continue  # WB10
        if p2 == "Numeric" and prev in MIDN and cur == "Numeric":
            continue  # WB11
        if prev == "Numeric" and cur in MIDN and nxt == "Numeric":
            continue  # WB12
        if prev == "Katakana" and cur == "Katakana":
            continue  # WB13
        if (prev in AHL + ("Numeric", "Katakana", "ExtendNumLet")
                and cur == "ExtendNumLet"):
            continue  # WB13a
        if prev == "ExtendNumLet" and cur in AHL + ("Numeric", "Katakana"):
            continue  # WB13b
        if (prev == "Regional_Indicator" and cur == "Regional_Indicator"
                and ri % 2 == 1):
            continue  # WB15/16
        breaks.append(i)  # WB999
    # rune index -> byte offset
    byte_off = np.cumsum([0] + [len(chr(r).encode()) for r in runes])
    return [int(byte_off[i]) for i in breaks]


def test_grapheme_pairs_conformance():
    bad = []
    for a in SAMPLES:
        for b in SAMPLES:
            s = chr(a) + chr(b)
            got = list(S.grapheme_breaks(s.encode()))
            if got != grapheme_oracle(s):
                bad.append((hex(a), hex(b), got, grapheme_oracle(s)))
    assert not bad, bad[:10]


def test_word_pairs_dual_implementation():
    bad = []
    for a in SAMPLES:
        for b in SAMPLES:
            s = chr(a) + chr(b)
            got = list(S.word_breaks(s.encode()))
            want = word_breaks_sequential(s)
            if got != want:
                bad.append((hex(a), hex(b), got, want))
    assert not bad, bad[:10]


def test_word_triples_dual_implementation(rng):
    """Random triples stress the two-sided context rules (WB6/7/11/12/7b/7c)."""
    pool = np.asarray(SAMPLES, dtype=np.int64)
    for _ in range(800):
        s = "".join(chr(int(c)) for c in rng.choice(pool, 3))
        got = list(S.word_breaks(s.encode()))
        want = word_breaks_sequential(s)
        assert got == want, s.encode("unicode_escape")


def test_grapheme_fuzz(rng, iterations):
    pool = np.asarray(SAMPLES + [0x62, 0x39, 0x1F468, 0x1F469, 0x200D,
                                 0x1F3FD, 0x0300], dtype=np.int64)
    for it in range(iterations(60)):
        n = int(rng.integers(1, 40))
        s = "".join(chr(int(c)) for c in rng.choice(pool, n))
        got = list(S.grapheme_breaks(s.encode()))
        assert got == grapheme_oracle(s), (it, s.encode("unicode_escape"))


def test_word_fuzz_dual(rng, iterations):
    pool = np.asarray(SAMPLES, dtype=np.int64)
    for it in range(iterations(60)):
        n = int(rng.integers(1, 40))
        s = "".join(chr(int(c)) for c in rng.choice(pool, n))
        got = list(S.word_breaks(s.encode()))
        want = word_breaks_sequential(s)
        assert got == want, (it, s.encode("unicode_escape"))


def test_word_tokens_real_text():
    t = b"The quick (\"brown\") fox can't jump 32.3 feet."
    toks = [t[a : a + l] for a, l in utf8_words(t)]
    assert toks == [b"The", b"quick", b"brown", b"fox", b"can't", b"jump",
                    b"32.3", b"feet"]
    s = "can’t".encode()
    assert utf8_words(s) == [(0, len(s))]
    heb = "מנכ\"ל".encode()  # gershayim inside a word (WB7b/c)
    assert utf8_words(heb) == [(0, len(heb))]
    heb2 = "צה'".encode()  # trailing geresh sticks (WB7a)
    assert utf8_words(heb2) == [(0, len(heb2))]
    assert utf8_words(b"a_b 0xFF") == [(0, 3), (4, 4)]


def test_sentences_exact_rules():
    t = b"He said hi. Then Dr. Smith left! Was it 3.5 p.m.? Yes."
    texts = [t[a : a + l] for a, l in utf8_sentences(t)]
    # strict UAX-29 splits after "Dr. " (SB7 only merges the no-space form)
    assert texts == [b"He said hi. ", b"Then Dr. ", b"Smith left! ",
                     b"Was it 3.5 p.m.? ", b"Yes."]
    # SB8: lowercase continuation after ATerm suppresses the break
    t2 = b"It was approx. fifty units. Done."
    assert len(utf8_sentences(t2)) == 2
    # SB7 merges the INNER dots of "U.S.A" (Upper ATerm x Upper); the final
    # ". C" still splits per strict UAX-29 (SB7 needs direct adjacency)
    t3 = b"The U.S.A. Capitol is big."
    assert utf8_sentences(t3) == [(0, 11), (11, 15)]
    # paragraph separators always terminate (SB4)
    t4 = b"one two\nthree"
    assert [t4[a : a + l] for a, l in utf8_sentences(t4)] == [
        b"one two\n", b"three"]
    # SB8a: ellipsis continuation
    t5 = b"Wait... really?"
    assert len(utf8_sentences(t5)) == 1


def test_linebreaks_core():
    offs = utf8_linebreaks(b"foo bar-baz, qux")
    assert 4 in offs and 8 in offs and 13 in offs  # after space / hyphen
    assert 11 not in offs  # never before the comma
    offs2, mand = S.line_breaks(b"a\nb c")
    assert list(offs2) == [2, 4] and list(mand) == [True, False]
    offs3 = utf8_linebreaks(b"pi is 3,141.59 ok")
    assert all(o not in offs3 for o in range(7, 15))  # number stays whole
    cjk = "日本語".encode()
    assert utf8_linebreaks(cjk) == [3, 6]  # ID x ID breaks
    assert utf8_linebreaks(b"a\xc2\xa0b") == []  # GL glue (NBSP)


def test_fold_and_uncased_native_paths(rng):
    pool = list("AaBbZzÄäßΣσςЖжİı") + [chr(0x1E9E), chr(0xFB03), chr(0x0130)]
    for _ in range(50):
        s = "".join(rng.choice(pool) for _ in range(int(rng.integers(0, 60))))
        assert utf8_fold(s.encode()).decode() == s.casefold()
    hay = "The STRAßE was LOUD".encode()
    off, ln = utf8_uncased_find(hay, b"strasse")
    assert hay[off : off + ln].decode() == "STRAßE"
    hay2 = "ßß find ME".encode()
    off, ln = utf8_uncased_find(hay2, b"me")
    assert hay2[off : off + ln] == b"ME"


def test_graphemes_public_api():
    assert len(utf8_graphemes("👩‍🚀🇺🇸🇫🇷".encode())) == 3
    assert utf8_graphemes(b"a\r\nb") == [(0, 1), (1, 2), (3, 1)]


def test_ucd_tables_sane():
    W = ucd.WB_VALUES
    wb = ucd.wb_classes()
    assert W[wb[0x27]] == "Single_Quote"
    assert W[wb[0x2019]] == "MidNumLet"
    assert W[wb[0x05D0]] == "Hebrew_Letter"
    assert ucd.gcb_ext_pict()[0x1F600] == 1
    assert ucd.GCB_VALUES[ucd.gcb_classes()[0xAC00]] == "LV"
    assert ucd.SB_VALUES[ucd.sb_classes()[0x2E]] == "ATerm"
    assert ucd.LB_VALUES[ucd.lb_classes()[0x2014]] == "B2"


def test_uncased_device_tier(rng):
    """Device tier of uncased search (LUT fold + streaming find + native
    patches around non-ASCII runs) vs the native scanner, on the CPU."""
    from stringzilla_tpu.ops.utf8 import _uncased_find_device, utf8_uncased_find
    from stringzilla_tpu.ops import utf8 as U

    # mostly-ASCII corpus with a handful of unicode islands (the tier bails
    # to the native scan by design when islands are dense)
    ascii_words = [b"alpha", b"BETA", b"Gamma", b"delta", b"epsilon"]
    uni_words = ["ß".encode(), "École".encode(),
                 b"Kelvin\xe2\x84\xaa"]  # U+212A folds to k
    parts = [ascii_words[int(i)] for i in rng.integers(0, 5, 400)]
    for slot, w in zip((50, 170, 290), uni_words):
        parts[slot] = w
    cases = []
    base = b" ".join(parts)
    cases.append((base, "beta"))
    cases.append((base, "GAMMA d"))
    cases.append((base, "ss"))            # matches ß via patch
    cases.append((base, "kelvink"))       # needs the U+212A patch
    cases.append((base, "zzznope"))
    cases.append((b"x" * 3000, "xXx"))
    cases.append((b"x" * 3000 + "préfixe".encode() + b"NEEDLE one",
                  "needle"))
    for hay, nd in cases:
        nd_f, _, _ = U._folded_with_spans(nd.encode())
        got = _uncased_find_device(hay, nd_f, min_bytes=0,
                                   allow_cpu=True)
        want = utf8_uncased_find(hay, nd)
        assert got is not None, (nd,)
        assert got == want, (nd, got, want)


def test_native_vs_vectorized_segmentation(rng, iterations):
    """The native streaming automata (tc_wb_breaks / tc_gb_breaks) vs the
    vectorized numpy tier — same boundaries on mixed-script fuzz strings
    and plain text (the numpy tier is itself conformance-tested above)."""
    from stringzilla_tpu.utils import native

    if native.lib() is None:
        pytest.skip("native library unavailable")
    pool = np.asarray(SAMPLES, dtype=np.int64)
    for it in range(iterations(80)):
        n = int(rng.integers(1, 48))
        buf = "".join(chr(int(c)) for c in rng.choice(pool, n)).encode()
        assert list(S.word_breaks(buf)) == list(S._word_breaks_py(buf)), (
            it, buf)
        assert list(S.grapheme_breaks(buf)) == list(
            S._grapheme_breaks_py(buf)), (it, buf)
    text = b"Word boundaries; 3.14 can't stop -- \"quoted\" text.\n" * 40
    assert list(S.word_breaks(text)) == list(S._word_breaks_py(text))
    assert list(S.grapheme_breaks(text)) == list(S._grapheme_breaks_py(text))
