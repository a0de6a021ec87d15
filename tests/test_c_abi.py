"""The native runtime's C ABI (tapecraft.h) — proven by an actual foreign
consumer: a C program compiled against the header and linked to the same
shared library the Python package builds (the analog of the reference's
binding test strategy: every binding validated against the C core)."""

import os
import subprocess

import numpy as np
import pytest

from stringzilla_tpu.utils import native

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "stringzilla_tpu", "native")

C_CONSUMER = r"""
#include <stdio.h>
#include <string.h>
#include "tapecraft.h"

int main(void) {
    if (tc_version() < 3) { puts("BAD version"); return 1; }

    const char* text = "hello GPU world";
    unsigned long long s = tc_bytesum((const uint8_t*)text, 15);
    unsigned long long want = 0;
    for (int i = 0; i < 15; ++i) want += (unsigned char)text[i];
    if (s != want) { puts("BAD bytesum"); return 1; }

    int64_t bounds[8];
    int64_t ntok = tc_tokenize_ws((const uint8_t*)text, 15, bounds, 4);
    if (ntok != 3 || bounds[0] != 0 || bounds[1] != 5) {
        puts("BAD tokenize"); return 1;
    }

    /* tape pack: two strings into a 2x8 matrix */
    const uint8_t blob[] = "abcdefgh";
    int64_t offs[3] = {0, 3, 8};
    uint8_t mat[16];
    memset(mat, 0xAA, sizeof mat);
    tc_pack_u8(blob, offs, NULL, 2, mat, 2, 8, 0);
    if (mat[0] != 'a' || mat[3] != 0 || mat[8] != 'd' || mat[12] != 'h') {
        puts("BAD pack"); return 1;
    }

    uint32_t runes[16];
    int32_t roffs[17];
    int64_t nr = tc_utf8_decode((const uint8_t*)"a\xC3\xA9z", 4, runes, roffs);
    if (nr != 3 || runes[1] != 0xE9 || roffs[2] != 3) {
        puts("BAD decode"); return 1;
    }
    puts("C ABI OK");
    return 0;
}
"""


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
def test_c_consumer(tmp_path):
    so = native._build()
    src = tmp_path / "consumer.c"
    src.write_text(C_CONSUMER)
    exe = tmp_path / "consumer"
    subprocess.run(
        ["g++", "-x", "c", str(src), "-x", "none", "-I", NATIVE_DIR, str(so),
         "-o", str(exe)],
        check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60, env={**os.environ})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "C ABI OK" in out.stdout


def test_header_covers_every_export():
    """Every extern-C symbol in tapecraft.cpp is declared in tapecraft.h."""
    cpp = open(os.path.join(NATIVE_DIR, "tapecraft.cpp")).read()
    hdr = open(os.path.join(NATIVE_DIR, "tapecraft.h")).read()
    import re

    body = cpp.split('extern "C"', 1)[1]
    # Any identifier-soup return type (incl. pointers): "unsigned long *" etc.
    # `static` definitions are internal helpers, not ABI exports.
    for m in re.finditer(r"^(?!static\b)[A-Za-z_][\w ]*?\s*\*?\s*\b(tc_\w+)\s*\(",
                         body, re.M):
        assert m.group(1) in hdr, f"{m.group(1)} missing from tapecraft.h"


C_TABLE_CONSUMER = r"""
/* Second compiled consumer: the table-passing surface — caller-supplied UCD
 * tables (4 MB fold1 + multi-char expansions + WB/EP class planes) fed to
 * tc_utf8_fold_bytes and tc_wb_breaks from plain C, results compared against
 * the in-process path byte for byte. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "tapecraft.h"

static void* slurp(const char* path, long* n) {
    FILE* f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "open %s\n", path); exit(1); }
    fseek(f, 0, SEEK_END); *n = ftell(f); fseek(f, 0, SEEK_SET);
    void* buf = malloc(*n ? (size_t)*n : 1);
    if ((long)fread(buf, 1, (size_t)*n, f) != *n) { fprintf(stderr, "read %s\n", path); exit(1); }
    fclose(f);
    return buf;
}

int main(int argc, char** argv) {
    if (argc != 10) { puts("BAD argc"); return 1; }
    long nf1, nmk, nmo, nmv, nwb, nep, nin, nwantf, nwantb;
    uint32_t* fold1 = (uint32_t*)slurp(argv[1], &nf1);
    uint32_t* mkeys = (uint32_t*)slurp(argv[2], &nmk);
    int64_t*  moffs = (int64_t*)slurp(argv[3], &nmo);
    uint32_t* mvals = (uint32_t*)slurp(argv[4], &nmv);
    uint8_t*  wb    = (uint8_t*)slurp(argv[5], &nwb);
    uint8_t*  ep    = (uint8_t*)slurp(argv[6], &nep);
    uint8_t*  input = (uint8_t*)slurp(argv[7], &nin);
    uint8_t*  wantf = (uint8_t*)slurp(argv[8], &nwantf);
    int64_t*  wantb = (int64_t*)slurp(argv[9], &nwantb);
    int64_t mcount = nmk / 4;
    if (nf1 != 0x110000L * 4 || nwb != 0x110000L || nep != 0x110000L) {
        puts("BAD table sizes"); return 1;
    }

    uint8_t* folded = (uint8_t*)malloc((size_t)(3 * nin + 16));
    int64_t m = tc_utf8_fold_bytes(input, nin, fold1, mkeys, moffs, mvals,
                                   mcount, folded);
    if (m != nwantf || memcmp(folded, wantf, (size_t)m) != 0) {
        puts("BAD fold"); return 1;
    }

    int64_t nbreaks = nwantb / 8;
    int64_t* breaks = (int64_t*)malloc((size_t)(nin + 1) * 8);
    int64_t cnt = tc_wb_breaks(input, nin, wb, ep, breaks, nin + 1);
    if (cnt != nbreaks || memcmp(breaks, wantb, (size_t)nwantb) != 0) {
        puts("BAD wb_breaks"); return 1;
    }
    /* drain mode (count only, no output array) must agree */
    if (tc_wb_breaks(input, nin, wb, ep, NULL, 0) != cnt) {
        puts("BAD drain count"); return 1;
    }
    puts("TABLE ABI OK");
    return 0;
}
"""


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
def test_c_table_consumer(tmp_path):
    """The trickiest ABI surface — caller-supplied UCD tables — exercised
    from a separately compiled C program (VERDICT r3 ask #10): full fold
    with multi-char expansions (ss, ffi, i+combining-dot) and UAX-29 word
    breaks over mixed-script text, bit-compared to the in-process path."""
    from stringzilla_tpu.ops import ucd
    from stringzilla_tpu.ops.utf8 import _fold_tables

    fold1, mkeys, moffs, mvals = _fold_tables()
    wb, ep = ucd.wb_classes(), ucd.gcb_ext_pict()
    text = ("Straße ﬃne İstanbul HELLO, wörld! 123 can't "
            "שלום עולם — ハロー・ワールド 👋🏽 end.").encode("utf-8")
    data = np.frombuffer(text, dtype=np.uint8)
    want_fold = bytes(native.utf8_fold_bytes(data, fold1, mkeys, moffs, mvals))
    want_breaks = np.asarray(native.wb_breaks(data, wb, ep), dtype=np.int64)
    assert len(want_fold) and len(want_breaks)

    paths = []
    for name, arr in [("fold1", fold1), ("mkeys", mkeys), ("moffs", moffs),
                      ("mvals", mvals), ("wb", wb), ("ep", ep),
                      ("input", data),
                      ("wantf", np.frombuffer(want_fold, dtype=np.uint8)),
                      ("wantb", want_breaks)]:
        p = tmp_path / f"{name}.bin"
        np.ascontiguousarray(arr).tofile(p)
        paths.append(str(p))

    so = native._build()
    src = tmp_path / "table_consumer.c"
    src.write_text(C_TABLE_CONSUMER)
    exe = tmp_path / "table_consumer"
    subprocess.run(
        ["g++", "-x", "c", str(src), "-x", "none", "-I", NATIVE_DIR, str(so),
         "-o", str(exe)],
        check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe), *paths], capture_output=True, text=True,
                         timeout=60, env={**os.environ})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TABLE ABI OK" in out.stdout
