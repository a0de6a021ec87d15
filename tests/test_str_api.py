"""Str / Strs / File binding-surface tests, mirroring the reference's Python
suite structure (reference ``test/test_stringzilla.py``) with Python built-ins
as the oracle."""

import hashlib

import numpy as np
import pytest

from stringzilla_tpu.models.str_api import File, Str, Strs
from stringzilla_tpu.ops.sort import argsort_strings


def test_str_basics():
    s = Str("hello world, hello GPU")
    assert len(s) == 22
    assert bytes(s[0:5]) == b"hello"
    assert s[1] == ord("e")
    assert s == Str(b"hello world, hello GPU")
    assert Str(b"abc") < Str(b"abd")
    assert Str(b"abc").order(b"abd") == -1
    assert Str(b"abc").order(b"abc") == 0


def test_str_find_family():
    s = Str("hello world, hello GPU")
    data = bytes(s)
    assert s.find("hello") == 0
    assert s.rfind("hello") == 13
    assert s.find("hello", 1) == data.find(b"hello", 1)
    assert s.find("zzz") == -1
    assert "world" in s and "mars" not in s
    assert s.count("hello") == 2
    assert s.count("l") == data.count(b"l")
    assert Str(b"aaaa").count(b"aa", allowoverlap=True) == 3
    assert s.startswith("hello") and s.endswith("GPU")
    with pytest.raises(ValueError):
        s.index("zzz")


def test_str_byteset_family():
    s = Str("hello world")
    assert s.find_first_of(b" owd") == 4
    assert s.find_last_of(b"lo") == 9
    assert s.find_first_not_of(b"hel") == 4
    assert s.find_last_not_of(b"ld") == 8


def test_str_split_family():
    s = Str("a,b,,c")
    assert s.split(",").to_list() == [b"a", b"b", b"", b"c"]
    assert s.split(",", maxsplit=1).to_list() == [b"a", b"b,,c"]
    assert s.rsplit(",", maxsplit=1).to_list() == [b"a,b,", b"c"]
    assert Str("x y\tz").split_byteset(b" \t").to_list() == [b"x", b"y", b"z"]
    assert Str(b"a\nbb\r\nccc").splitlines().to_list() == [b"a", b"bb", b"ccc"]
    assert Str(b"a\nbb").splitlines(keeplinebreaks=True).to_list() == [b"a\n", b"bb"]
    left, sep, right = Str("k=v").partition("=")
    assert (bytes(left), bytes(sep), bytes(right)) == (b"k", b"=", b"v")


def test_str_transforms():
    lut = bytes(range(256)).upper()
    assert bytes(Str(b"abc, xyz").translate(lut)) == b"ABC, XYZ"
    s = Str(b"The quick brown fox")
    assert s.bytesum() == sum(bytes(s))
    assert s.sha256() == hashlib.sha256(bytes(s)).digest()
    assert isinstance(s.hash(), int)
    assert s.hash(7) != s.hash(8)


def test_strs_collection(rng):
    words = [bytes(rng.integers(97, 123, rng.integers(1, 15)).astype(np.uint8))
             for _ in range(300)]
    words += [b"app", b"apple", b"ap\x00", b"ap", b""]
    coll = Strs(words)
    assert len(coll) == len(words)
    assert bytes(coll[0]) == words[0]
    assert bytes(coll[-1]) == words[-1]
    assert coll.to_list() == words
    assert [words[i] for i in coll.order()] == sorted(words)
    assert [words[i] for i in coll.order(reverse=True)] == sorted(words, reverse=True)
    assert coll.sort().to_list() == sorted(words)
    assert len(coll.sample(10, seed=0)) == 10
    assert sorted(coll.shuffle(seed=0).to_list()) == sorted(words)


def test_argsort_uncased_and_topk():
    mixed = [b"Apple", b"apple", b"BANANA", b"banana", b"Cherry"]
    perm = argsort_strings(mixed, uncased=True)
    assert [mixed[i].lower() for i in perm] == sorted(m.lower() for m in mixed)
    top = argsort_strings(mixed, top_count=2)
    assert [mixed[i] for i in top] == sorted(mixed)[:2]


def test_argsort_topk_pruned(rng):
    """The pruned partial-sort path (top_count << n) must agree with the
    full stable sort — including tie-heavy corpora where the leading key
    word doesn't discriminate and the pruning threshold keeps every tie."""
    for npool, k in ((6, 50), (300, 25), (2, 10)):
        words = [bytes(rng.integers(97, 97 + npool,
                                    int(rng.integers(0, 12))).astype("uint8"))
                 for _ in range(1000)]
        got = argsort_strings(words, top_count=k)
        full = argsort_strings(words)
        assert list(got) == list(full[:k])
        got_r = argsort_strings(words, top_count=k, reverse=True)
        full_r = argsort_strings(words, reverse=True)
        assert list(got_r) == list(full_r[:k])


def test_argsort_uncased_full_unicode(rng):
    """Full-Unicode fold-on-export ordering (reference sort.h:18-22,114):
    differential vs a stable sort on the casefolded decoded string, with
    malformed UTF-8 ordering as U+FFFD."""
    pool = ["Straße", "STRASSE", "straße", "ﬃn", "FFI", "ffi", "Ωμέγα",
            "ωμεγα", "İstanbul", "istanbul", "ĿL", "l·l", "ΣΊΣΥΦΟΣ",
            "σίσυφος", "apple", "Apple", "Ꮳherokee", "ꮳherokee", ""]
    items = [w.encode() for w in pool]
    items += [bytes(rng.integers(0x20, 0x7F, rng.integers(0, 12),
                                 dtype=np.uint8)) for _ in range(40)]
    items += [b"\xff\xfe raw", b"ok \xc3", "mixß\xc4".encode()[:-1]]

    def fold_key(s: bytes) -> bytes:
        return s.decode("utf-8", errors="replace").casefold().encode()

    oracle = sorted(range(len(items)), key=lambda i: fold_key(items[i]))
    perm = argsort_strings(items, uncased=True)
    assert list(perm) == oracle
    rperm = argsort_strings(items, uncased=True, reverse=True)
    roracle = sorted(range(len(items)),
                     key=lambda i: fold_key(items[i]), reverse=True)
    # descending with stable original-index ties: group by key
    assert [fold_key(items[i]) for i in rperm] == \
           [fold_key(items[i]) for i in roracle]


def test_file_mmap(tmp_path):
    p = tmp_path / "f.txt"
    data = b"memory mapped haystack with needle inside"
    p.write_bytes(data)
    f = File(str(p))
    assert f.find("needle") == data.find(b"needle")
    assert len(f) == len(data)
    f.close()
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    assert len(File(str(empty))) == 0


def test_strs_append_extend_and_hashes(rng):
    c = Strs([b"a", b"b"])
    c.append(b"c").extend(["d", b"e"])
    assert c.to_list() == [b"a", b"b", b"c", b"d", b"e"]
    from stringzilla_tpu.ops.hash import sz_hash

    items = [bytes(rng.integers(0, 256, int(rng.integers(0, 40))).astype(np.uint8))
             for _ in range(50)]
    h = Strs(items).hashes(seed=3)
    assert all(h[i] == sz_hash(s, 3) for i, s in enumerate(items))


def test_lazy_iterator_views():
    """Lazy match/split ranges (reference ``stringzilla.hpp:543-875``,
    binding ``split_iter``/``rsplit_iter``)."""
    s = Str(b"one,two,,three,")
    assert [bytes(x) for x in s.split_iter(b",")] == b"one,two,,three,".split(b",")
    assert ([bytes(x) for x in s.rsplit_iter(b",")]
            == list(reversed(b"one,two,,three,".split(b","))))
    assert ([bytes(x) for x in s.split_iter(b",", keepseparator=True)]
            == [b"one,", b"two,", b",", b"three,", b""])
    assert ([bytes(x) for x in s.rsplit_iter(b",", keepseparator=True)]
            == [b"", b"three,", b",", b"two,", b"one,"])
    t = Str(b"aaaa")
    assert list(t.find_all(b"aa")) == [0, 2]
    assert list(t.find_all(b"aa", allowoverlap=True)) == [0, 1, 2]
    assert list(t.rfind_all(b"aa")) == [2, 0]
    assert list(t.rfind_all(b"aa", allowoverlap=True)) == [2, 1, 0]
    assert list(Str(b"abc").find_all(b"zz")) == []
    assert [bytes(x) for x in Str(b"aaa").split_iter(b"aa")] == [b"", b"a"]
    gen = s.split_iter(b",")  # lazily evaluated, one find per next()
    assert bytes(next(gen)) == b"one"


def test_module_binding_surface():
    """The reference binding's module-level function names all resolve and
    behave (``python/stringzilla.c:9531-9612``)."""
    import hashlib

    import stringzilla_tpu as sz

    assert sz.sha256(b"abc") == hashlib.sha256(b"abc").digest()
    assert bytes(sz.translate(b"abc", bytes(range(256)).upper())) == b"ABC"
    assert [bytes(p) for p in sz.split(b"a b c")] == [b"a", b"b", b"c"]
    assert [bytes(p) for p in sz.split_iter(b"a b c")] == [b"a", b"b", b"c"]
    assert [bytes(p) for p in sz.splitlines(b"x\ny")] == [b"x", b"y"]
    assert sz.order(b"a", b"b") == -1 and sz.order(b"b", b"a") == 1
    assert list(sz.argsort([b"b", b"a"])) == [1, 0]
    assert sz.utf8_is_normalized("café") and sz.utf8_find_cased(b"abC") == 2
    sz.reset_capabilities("serial")
    try:
        assert sz.find(b"xxhayxx", b"hay") == 2
    finally:
        sz.reset_capabilities()


def test_binding_surface_extras():
    """The remaining reference binding methods: strips, byteset counting and
    splitting, pointer offsets, codepoints, uncased matches, Strs sugar."""
    import stringzilla_tpu as sz

    s = sz.Str(b"  hello world  ")
    assert bytes(s.strip()) == b"hello world"
    assert bytes(s.lstrip()) == b"hello world  "
    assert bytes(s.rstrip()) == b"  hello world"
    assert bytes(sz.Str(b"xxabcxx").strip(b"x")) == b"abc"
    assert bytes(sz.Str(b"xxx").strip(b"x")) == b""

    assert sz.Str(b"a,b;c").count_byteset(b",;") == 2
    assert [bytes(p) for p in sz.Str(b"a,b;c").rsplit_byteset(b",;")] == \
        [b"a", b"b", b"c"]
    assert [bytes(p) for p in sz.Str(b"a,b;c").rsplit_byteset(b",;", 1)] == \
        [b"a,b", b"c"]
    assert [bytes(p) for p in sz.Str(b"a,b").split_byteset_iter(b",")] == \
        [b"a", b"b"]

    s2 = sz.Str(b"hello")
    assert s2.contains(b"ell") and s2.equal(b"hello")
    assert s2.decode() == "hello"

    parent = sz.Str(b"0123456789")
    view = parent[3:7]
    assert view.offset_within(parent) == 3

    assert list(sz.Str("AB".encode()).utf8_codepoints()) == [65, 66]
    ws = sz.Str("a b c".encode()).utf8_split_whitespaces()
    assert [bytes(p) for p in ws] == [b"a", b"b", "c".encode()]

    hay = sz.Str("The THE the".encode())
    matches = list(hay.utf8_uncased_matches("the"))
    assert matches == [(0, 3), (4, 3), (8, 3)]
    assert hay.utf8_uncased_search("THE") == (0, 3)
    assert bytes(sz.Str("Straße".encode()).utf8_uncased_fold()) == \
        "straße".encode().replace("ß".encode(), b"ss")

    ss = sz.Strs([b"b", b"a", b"c"])
    assert ss.to_pylist() == [b"b", b"a", b"c"]
    assert ss.sorted().to_list() == [b"a", b"b", b"c"]
    assert sorted(ss.shuffled(seed=1).to_list()) == [b"a", b"b", b"c"]
    assert ss.tape.to_list() == [b"b", b"a", b"c"]

    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "out.bin")
        s2.write_to(p)
        assert open(p, "rb").read() == b"hello"


def test_str_segmentation_methods():
    """Str.utf8_wordbreaks/graphemes/sentences/linebreaks yield zero-copy
    Str views — the reference binding's contract ("Iterator yielding Str
    objects ...", python/stringzilla.c:5469/5592/5654/5715) — consistent
    with the offset/span kernels in ops."""
    import stringzilla_tpu as szt
    from stringzilla_tpu.ops import utf8 as u8
    from stringzilla_tpu.ops import utf8_segment as useg

    raw = "Hello world. Déjà vu! 👩‍👩‍👧 end".encode()
    s = szt.Str(raw)

    # wordbreaks: segments between boundary offsets, concatenating to the text
    words = s.utf8_wordbreaks()
    assert isinstance(words, szt.Utf8Wordbreaks)
    assert b"".join(bytes(w) for w in words) == raw
    offs = useg.utf8_wordbreaks(raw)
    assert [len(w) for w in words][:-1] == list(
        np.diff([0] + [o for o in offs if 0 < o < len(raw)]))

    # graphemes: views over the span kernel, one per cluster
    graphemes = s.utf8_graphemes()
    assert [(raw.index(bytes(g), o), len(g)) for o, g in
            zip((sp[0] for sp in u8.utf8_graphemes(raw)), graphemes)] \
        == u8.utf8_graphemes(raw)
    assert b"".join(bytes(g) for g in graphemes) == raw

    # sentences: views over the sentence spans
    sentences = s.utf8_sentences()
    assert [(bytes(x)) for x in sentences] == \
        [raw[o:o + l] for o, l in useg.utf8_sentences(raw)]

    # linebreaks: segments between opportunity offsets, covering the text
    segs = s.utf8_linebreaks()
    assert b"".join(bytes(x) for x in segs) == raw
    assert len(words) and len(graphemes)

    # reference iteration contract: 'world' is a yielded token
    assert any(str(w) == "world" for w in szt.utf8_wordbreaks("Hi, world"))
    # empty input yields no segments
    assert len(szt.Str(b"").utf8_wordbreaks()) == 0


def test_typed_lazy_iterators():
    """Module-level iterator/view types exist and are returned by the
    corresponding calls (reference module exports, python/stringzilla.c:9744+:
    FindSplits, Utf8Newlines/Whitespaces/Delimiters and the Split variants)."""
    import stringzilla_tpu as szt

    s = szt.Str(b"one two\nthree, four\n")
    it = s.split_iter(b" ")
    assert isinstance(it, szt.FindSplits)
    assert [bytes(p) for p in it] == [b"one", b"two\nthree,", b"four\n"]
    assert isinstance(s.rsplit_iter(b" "), szt.FindSplits)

    assert isinstance(s.utf8_newlines(), szt.Utf8Newlines)
    assert isinstance(s.utf8_whitespaces(), szt.Utf8Whitespaces)
    assert isinstance(s.utf8_delimiters(), szt.Utf8Delimiters)
    assert isinstance(s.utf8_split_newlines(), szt.Utf8SplitNewlines)
    assert isinstance(s.utf8_split_whitespaces(), szt.Utf8SplitWhitespaces)
    assert isinstance(s.utf8_split_delimiters(), szt.Utf8SplitDelimiters)
    # newline tokens are the two \n views; split segments rejoin to the text
    assert [bytes(t) for t in s.utf8_newlines()] == [b"\n", b"\n"]
    # module-level forms mirror the methods and share the types
    assert isinstance(szt.utf8_newlines(bytes(s)), szt.Utf8Newlines)

    # __capabilities_str__ mirrors __capabilities__() (reference module
    # constant, python/stringzilla.c:9695)
    assert szt.__capabilities_str__ == ",".join(szt.__capabilities__())


def test_buffer_introspection_and_layout():
    """Str.address/nbytes + Strs tape/offsets getters (reference
    python/stringzilla.c:2115-2116, 8525-8530)."""
    import stringzilla_tpu as szt

    s = szt.Str(b"hello world")
    assert s.nbytes == 11 and s.address != 0
    assert s[6:].address == s.address + 6  # views point into the parent

    ss = szt.Strs([b"aa", b"bb", b"ccc"])
    assert ss.tape_nbytes == 7 and ss.tape_address != 0
    assert ss.offsets_are_large is True
    assert ss.offsets_nbytes == 3 * 8
    assert "U64_TAPE" in ss.__layout__ and "count=3" in ss.__layout__
    empty = szt.Strs()
    assert empty.tape_nbytes == 0 and empty.offsets_address == 0


def test_module_random_alphabet():
    """sz.random(length, nonce, alphabet=...) == fill_random remapped by
    alphabet[b % len(alphabet)] (reference python/stringzilla.c:1781)."""
    import stringzilla_tpu as szt

    assert szt.random(64, 9) == szt.fill_random(64, 9)
    raw = szt.fill_random(256, 3)
    mapped = szt.random(256, 3, alphabet="acgt")
    assert mapped == bytes(b"acgt"[b % 4] for b in raw)
    assert set(mapped) <= set(b"acgt")
    import pytest
    with pytest.raises(ValueError):
        szt.random(8, alphabet="")
