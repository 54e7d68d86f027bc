"""Port parity of the string expressions (``exprs/strings.py``) and
``Md5`` (``exprs/hash.py``) against the JAX package on the CPU, bit for
bit on both engines.

Both engines get the same numpy columns: a device batch (capacity 64, 53
live rows, NULLs, a dead tail) and a host batch of the live rows, each in
both packages. Each expression's device result compares buffer for
buffer (the byte matrix with its width, lengths, validity, data under
dead rows), its host result row by row (bytes and lengths, validity).

The inputs are the reference's edge inputs (``tests/test_exprs.py``
``TestStrings``, ``TestNewStringExprs``, ``TestSplitSubstringIndex``,
``TestMd5``) and: 2-, 3- and 4-byte UTF-8 characters; empty strings,
NULLs, all-space strings and a row at the full column width; a delimiter
longer than the string; ``repeat`` by 0 and by a negative count;
``locate`` from a start below 1 and with an empty needle; MD5 at 0, 55,
56, 63, 64 and 119 bytes.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.exprs import base as jbase

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.exprs import base as tbase
from spark_rapids_tpu_torch.exprs import strings as TS

CAP, LIVE, WIDTH = 64, 53, 32

# Every row of the pool fits WIDTH bytes; the first is exactly WIDTH.
POOL = [
    "ab,cd,ef,gh,ij,kl,mn,op,qr,st,uv",     # 32 bytes: the full width
    "hello", "WORLD", "héllo", "", "   ", "  pad  ", "  x  y  ",
    "banana", "a1b22c", "100-200", "7-8", "foo", "aaa", "aabaa", "aaaa",
    "xaay", "aa", "abcba", "xyz", "a,b,c", "abab", "abab,ab", "hello world",
    "fOO bAR", "a b c", "日本語テキスト", "é,日,,ab", "𝄞music𝄞 é",
    "Customer#000000042", "13-715-945-6730", "the lol of the ly",
    "x日本y日本z", "ééé", ",,", "Brand#12", "AUTOMOBILE", " é ", "ab", "l",
]
assert max(len(s.encode()) for s in POOL) == WIDTH


def _string_column(rng, valid):
    picked = [POOL[i] for i in range(len(POOL))] + \
        [POOL[i] for i in rng.integers(0, len(POOL), CAP - len(POOL))]
    data = np.zeros((CAP, WIDTH), np.uint8)
    lens = np.zeros(CAP, np.int32)
    for i, s in enumerate(picked):
        b = s.encode()
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    data = np.where(valid[:, None], data, 0).astype(np.uint8)
    return data, np.where(valid, lens, 0).astype(np.int32)


def _columns(seed=0):
    """[s, t] string columns and an int32 start column, as numpy
    (data, validity, lengths) with NULLs and a dead tail."""
    rng = np.random.default_rng(seed)
    live = np.arange(CAP) < LIVE
    v1 = live.copy()
    v1[rng.choice(np.arange(len(POOL), LIVE), 5, replace=False)] = False
    v2 = live & (rng.random(CAP) < 0.8)
    s = _string_column(rng, v1)
    t = _string_column(np.random.default_rng(seed + 1), v2)
    t = (np.roll(t[0], 7, axis=0) * v2[:, None].astype(np.uint8),
         np.roll(t[1], 7) * v2)
    start = np.where(live, rng.integers(-1, 6, CAP), 0).astype(np.int32)
    return [("string", s[0], v1, s[1]), ("string", t[0], v2, t[1]),
            ("int32", start, live.copy(), None)]


def _device(cols):
    jb = jbatch.DeviceBatch(tuple(
        jbatch.DeviceColumn(jdt.type_named(n), jnp.asarray(d),
                            jnp.asarray(v),
                            None if ln is None else jnp.asarray(ln))
        for n, d, v, ln in cols), jnp.asarray(LIVE, jnp.int32))
    tb = thost.from_jax_batch_arrays(
        [tdt.type_named(n) for n, _, _, _ in cols],
        [(d, v, ln) for _, d, v, ln in cols], LIVE, device="cpu")
    return jb, tb


def _host(cols):
    names = ("s", "t", "start")
    jcs, tcs = [], []
    for n, d, v, ln in cols:
        d, v = d[:LIVE], v[:LIVE]
        if n == "string":
            jcs.append(jhost.HostColumn(jdt.STRING, None, v.copy(),
                                        str_matrix=d.copy(),
                                        str_lengths=ln[:LIVE].copy()))
            tcs.append(thost.HostColumn(tdt.STRING, None, v.copy(),
                                        str_matrix=d.copy(),
                                        str_lengths=ln[:LIVE].copy()))
        else:
            jcs.append(jhost.HostColumn(jdt.INT32, d.copy(), v.copy()))
            tcs.append(thost.HostColumn(tdt.INT32, d.copy(), v.copy()))
    return jhost.HostBatch(names, jcs), thost.HostBatch(names, tcs)


def _cases():
    """name -> builder(M, D) of one expression over s (0), t (1) and
    start (2)."""
    def s(M, D):
        return M.BoundReference(0, D.STRING)

    def t(M, D):
        return M.BoundReference(1, D.STRING)

    cases = {
        "upper": lambda M, D: M.Upper(s(M, D)),
        "lower": lambda M, D: M.Lower(s(M, D)),
        "initcap": lambda M, D: M.InitCap(s(M, D)),
        "length": lambda M, D: M.Length(s(M, D)),
        "reverse": lambda M, D: M.StringReverse(s(M, D)),
        "trim": lambda M, D: M.StringTrim(s(M, D)),
        "ltrim": lambda M, D: M.StringTrimLeft(s(M, D)),
        "rtrim": lambda M, D: M.StringTrimRight(s(M, D)),
        "concat": lambda M, D: M.ConcatStrings(s(M, D), M.lit("_"),
                                               t(M, D)),
        "concat_one": lambda M, D: M.ConcatStrings(s(M, D)),
        "concat_ws": lambda M, D: M.ConcatWs("-", s(M, D), t(M, D)),
        "concat_ws_multi": lambda M, D: M.ConcatWs(
            ", ", s(M, D), M.Literal(D.STRING, None), t(M, D),
            M.lit("é")),
        "concat_ws_empty_sep": lambda M, D: M.ConcatWs("", t(M, D),
                                                       s(M, D)),
        "concat_ws_none": lambda M, D: M.ConcatWs("-"),
        "repeat3": lambda M, D: M.StringRepeat(s(M, D), 3),
        "repeat0": lambda M, D: M.StringRepeat(s(M, D), 0),
        "repeat_negative": lambda M, D: M.StringRepeat(s(M, D), -2),
        "repeat_literal": lambda M, D: M.StringRepeat(
            s(M, D), M.Literal(D.INT32, 2)),
        "replace": lambda M, D: M.StringReplace(s(M, D), "an", "AN"),
        "replace_multibyte": lambda M, D: M.StringReplace(s(M, D), "日本",
                                                          "é"),
        "replace_empty_search": lambda M, D: M.StringReplace(s(M, D), "",
                                                             "x"),
        "regexp_replace": lambda M, D: M.RegExpReplace(s(M, D), r"\d+",
                                                       "#"),
        "regexp_replace_dash": lambda M, D: M.RegExpReplace(s(M, D), "-",
                                                            ""),
        "regexp_extract1": lambda M, D: M.RegExpExtract(
            s(M, D), r"(\d+)-(\d+)", 1),
        "regexp_extract2": lambda M, D: M.RegExpExtract(
            s(M, D), r"(\d+)-(\d+)", 2),
        "regexp_extract_country": lambda M, D: M.RegExpExtract(
            s(M, D), r"^(\d+)-", 1),
        "regexp_extract_multibyte": lambda M, D: M.RegExpExtract(
            s(M, D), "(é+)", 1),
        "translate": lambda M, D: M.Translate(s(M, D), "abx", "AB"),
        "translate_multibyte": lambda M, D: M.Translate(s(M, D), "日é𝄞",
                                                        "月e"),
        "lpad": lambda M, D: M.StringLPad(s(M, D), 5, "*"),
        "rpad": lambda M, D: M.StringRPad(s(M, D), 5, "*"),
        "lpad_multibyte": lambda M, D: M.StringLPad(s(M, D), 12, "é日"),
        "rpad_multibyte": lambda M, D: M.StringRPad(s(M, D), 9, "𝄞"),
        "lpad_truncate": lambda M, D: M.StringLPad(s(M, D), 3),
        "lpad_zero": lambda M, D: M.StringLPad(s(M, D), 0, "*"),
        "rpad_negative": lambda M, D: M.StringRPad(s(M, D), -1, "*"),
        "rpad_empty_pad": lambda M, D: M.StringRPad(s(M, D), 40, ""),
        "locate": lambda M, D: M.StringLocate(M.lit("l"), s(M, D),
                                              M.lit(1)),
        "locate_from4": lambda M, D: M.StringLocate(M.lit("l"), s(M, D),
                                                    M.lit(4)),
        "locate_multibyte": lambda M, D: M.StringLocate(
            M.lit("日本"), s(M, D), M.lit(2)),
        "locate_start_column": lambda M, D: M.StringLocate(
            M.lit("a"), s(M, D), M.BoundReference(2, D.INT32)),
        "locate_empty_needle": lambda M, D: M.StringLocate(
            M.lit(""), s(M, D), M.BoundReference(2, D.INT32)),
        "locate_start0": lambda M, D: M.StringLocate(M.lit("l"), s(M, D),
                                                     M.lit(0)),
        "locate_start_negative": lambda M, D: M.StringLocate(
            M.lit("l"), s(M, D), M.lit(-2)),
        "locate_null_needle": lambda M, D: M.StringLocate(
            M.Literal(D.STRING, None), s(M, D), M.lit(1)),
        "md5": lambda M, D: M.Md5(s(M, D)),
    }
    for d in (",", "ab", "aa", "é", "日本", "a much longer delimiter than "
              "any row"):
        for i in (0, 1, 2, 5, -1):
            cases[f"split[{d}][{i}]"] = lambda M, D, d=d, i=i: \
                M.StringSplit(s(M, D), d, i)
        for c in (1, 2, -1, -2, 0):
            cases[f"substring_index[{d}][{c}]"] = lambda M, D, d=d, c=c: \
                M.SubstringIndex(s(M, D), d, c)
    return cases


CASES = _cases()


def _assert_device_equal(jc, tc, name):
    want, got = np.asarray(jc.data), tc.data.numpy()
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (name, want.shape, got.shape, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jc.validity),
                                  tc.validity.numpy(), err_msg=name)
    if jc.lengths is not None:
        np.testing.assert_array_equal(np.asarray(jc.lengths),
                                      tc.lengths.numpy(), err_msg=name)
    # Padding rows stay invalid.
    assert not tc.validity.numpy()[LIVE:].any(), name


def _host_rows(col):
    """(validity, [bytes or value]) of a host column."""
    validity = np.asarray(col.validity, np.bool_)
    if col.dtype.is_string:
        vals = [bytes(b) if ok else None for b, ok in zip(
            col.data, validity)]
    else:
        vals = [np.asarray(col.data)[i].item() if ok else None
                for i, ok in enumerate(validity)]
    return validity, vals


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_matches_reference(name):
    jb, tb = _device(_columns())
    je, te = CASES[name](JE, jdt), CASES[name](TE, tdt)
    jc = jbase.as_device_column(je.eval(jb), jb)
    tc = tbase.as_device_column(te.eval(tb), tb)
    _assert_device_equal(jc, tc, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_matches_reference(name):
    jh, th = _host(_columns())
    je, te = CASES[name](JE, jdt), CASES[name](TE, tdt)
    jv, jr = _host_rows(jbase.as_host_column(je.eval_host(jh), jh))
    tv, tr = _host_rows(tbase.as_host_column(te.eval_host(th), th))
    np.testing.assert_array_equal(jv, tv, err_msg=name)
    assert tr == jr, name


@pytest.mark.parametrize("name", ["upper", "reverse", "concat_ws",
                                  "regexp_extract1", "lpad_multibyte",
                                  "md5", "split[aa][1]",
                                  "substring_index[é][-1]"])
def test_engines_agree(name):
    """The port's device half and host half give the same rows."""
    cols = _columns(3)
    _, tb = _device(cols)
    _, th = _host(cols)
    te = CASES[name](TE, tdt)
    tc = tbase.as_device_column(te.eval(tb), tb)
    hb = thost.device_to_host(tbatch.DeviceBatch((tc,), tb.num_rows))
    assert _host_rows(hb.columns[0])[1] == \
        _host_rows(tbase.as_host_column(te.eval_host(th), th))[1]


def test_inputs_are_not_vacuous():
    """The pool reaches the edges it is meant to: a full-width row,
    multibyte characters of 2, 3 and 4 bytes, empty and all-space rows,
    NULLs among the live rows, overlapping 'aa' delimiters."""
    (_, d, v, ln), _, _ = _columns()
    assert ln[0] == WIDTH and v[0]
    rows = [d[i, :ln[i]].tobytes() for i in range(LIVE) if v[i]]
    lead = {b >> 4 for r in rows for b in r if b >= 0xC0}
    assert {0xC, 0xE, 0xF} <= lead
    assert b"" in rows and b"   " in rows and b"aaaa" in rows
    assert not v[:LIVE].all() and not v[LIVE:].any()


def test_greedy_matches_overlapping_multibyte_delimiter():
    """The reference's TestSplitSubstringIndex case: 'aa' in 'aaa' and
    'aaaa' matches greedily left to right, not overlapping."""
    vals = [b"aaa", b"aabaa", b"aaaa", b"xaay", b"", b"aa"]
    data = np.zeros((len(vals), 8), np.uint8)
    for i, b in enumerate(vals):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(b) for b in vals], np.int32)
    hits = TS._sliding_match_host(data, lens, b"aa")
    want = TS._greedy_matches(np, hits, 2)
    got = TS._greedy_matches(torch, torch.from_numpy(hits), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0].nonzero()[0].tolist() == [0]
    assert want[2].nonzero()[0].tolist() == [0, 2]


MD5_LENGTHS = (0, 1, 3, 54, 55, 56, 57, 63, 64, 65, 119, 120, 127)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_md5_padding_boundaries(engine):
    """MD5 at every chunk edge (55 / 56 / 63 / 64 bytes, 119 and 120),
    multibyte text and NULLs, against hashlib and the JAX package."""
    rng = np.random.default_rng(5)
    n = 24
    width = 128
    lens = np.array(list(MD5_LENGTHS) + list(rng.integers(
        0, width + 1, n - len(MD5_LENGTHS))), np.int32)
    data = rng.integers(0, 256, (n, width)).astype(np.uint8)
    data[:, :8] = np.frombuffer("日本é".encode()[:8], np.uint8)
    data[np.arange(width)[None, :] >= lens[:, None]] = 0
    valid = np.ones(n, np.bool_)
    valid[[4, 11]] = False
    data[~valid] = 0
    lens = np.where(valid, lens, 0).astype(np.int32)
    want = [hashlib.md5(data[i, :lens[i]].tobytes()).hexdigest().encode()
            if valid[i] else None for i in range(n)]
    if engine == "device":
        jb = jbatch.DeviceBatch((jbatch.DeviceColumn(
            jdt.STRING, jnp.asarray(data), jnp.asarray(valid),
            jnp.asarray(lens)),), jnp.asarray(n, jnp.int32))
        tb = thost.from_jax_batch_arrays([tdt.STRING],
                                         [(data, valid, lens)], n,
                                         device="cpu")
        jc = JE.Md5(JE.BoundReference(0, jdt.STRING)).eval(jb)
        tc = TE.Md5(TE.BoundReference(0, tdt.STRING)).eval(tb)
        _assert_device_equal(jc, tc, "md5")
        got = [tc.data.numpy()[i, :32].tobytes() if valid[i] else None
               for i in range(n)]
    else:
        th = thost.HostBatch(("s",), [thost.HostColumn(
            tdt.STRING, None, valid, str_matrix=data, str_lengths=lens)])
        jh = jhost.HostBatch(("s",), [jhost.HostColumn(
            jdt.STRING, None, valid, str_matrix=data, str_lengths=lens)])
        tcol = TE.Md5(TE.BoundReference(0, tdt.STRING)).eval_host(th)
        jcol = JE.Md5(JE.BoundReference(0, jdt.STRING)).eval_host(jh)
        assert _host_rows(tcol) == _host_rows(jcol)
        got = _host_rows(tcol)[1]
    assert got == want


def test_md5_launches_per_chunk():
    """Each 64-byte chunk costs a few hundred torch ops (the message words
    built once from one padded matrix), counted through the dispatcher on
    the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    from spark_rapids_tpu_torch.exprs.hash import md5_hex_matrix
    per = []
    for w in (8, 64):       # one chunk, then two
        data = torch.zeros((16, w), dtype=torch.uint8)
        lens = torch.full((16,), w, dtype=torch.int32)
        Count.n = 0
        with Count():
            md5_hex_matrix(torch, data, lens)
        per.append(Count.n)
    chunk = per[1] - per[0]
    assert 500 < chunk < 900, per


def test_host_roundtrip_counts_into_the_operator():
    """A roundtrip kind inside a ProjectExec counts its rows and bytes in
    the operator's metrics, on the device engine only."""
    from spark_rapids_tpu_torch.ops import ExecContext, InMemorySourceExec
    from spark_rapids_tpu_torch.ops import ProjectExec
    _, th = _host(_columns())
    src = InMemorySourceExec((("s", tdt.STRING), ("t", tdt.STRING),
                              ("start", tdt.INT32)), [[th]], device="cpu")
    proj = ProjectExec(src, [("r", TE.StringLPad(
        TE.BoundReference(0, tdt.STRING), 6, "*"))])
    ctx = ExecContext()
    rows = proj.collect(ctx, device=True)
    m = ctx.metrics_for(proj).values
    assert m["island.lpad.rows"] == LIVE == len(rows)
    assert m["island.lpad.bytesDown"] > 0 and m["island.lpad.bytesUp"] > 0
    ctx = ExecContext()
    proj.collect(ctx, device=False)
    assert not any(k.startswith("island.") for k in
                   ctx.metrics_for(proj).values)
