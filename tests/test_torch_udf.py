"""Port parity of the UDF tier: the AST compiler (``udf/compiler.py``) and
the host-evaluated ``PythonUDF`` (``exprs/pyudf.py``) against the JAX
package's, on the CPU.

- Compiler: for every construct of the subset and every rejection, the
  same function through both packages' ``udf`` gives the same
  ``.compiled`` and ``.compile_error``, and a compiled one builds the
  same expression tree (``resolve`` in both, compared node by node). The
  compiled columns give the reference's rows exactly under the
  all-device conf and under the default conf. The fuzzed equivalence of
  ``tests/test_udf.py`` (8 seeds) holds the port against the reference
  (exactly) and against Python (``pytest.approx``'s default, rel 1e-6).
  The cases where a compiled UDF answers otherwise than the Python
  function (the engine's ``%``, ``/``, ``round``, ``.strip()``,
  ``min`` / ``max``, NULL, case maps) are pinned one by one: the port
  gives the reference's answer, not Python's.
- ``PythonUDF``: after a filter (a selection vector), with None passed
  through, with a string return type, the "failed on row i" error, the
  explain note (the reference's text) and the ``island.pyudf.*`` counts.
  Rows equal the reference's exactly, device half and host half.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import importlib.util
import math
import random
import re

import numpy as np
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.udf import udf as judf

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.host import HostBatch, host_to_device
from spark_rapids_tpu_torch.ops.base import Metrics, timed
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.udf import UdfCompileError, compile_udf, udf

from harness import assert_rows_equal
from test_torch_logical import _same_expr
from test_torch_placement import REF_OFF

SCHEMA = (("a", "double"), ("b", "double"), ("i", "int64"), ("j", "int64"),
          ("s", "string"))
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
              "spark.rapids.sql.incompatibleOps.enabled": True}
CONFS = {"device": ALL_DEVICE, "default": {}}
WORDS = ["Ab", "cD", " pad ", "x", "", "straße", "MiXeD case"]


def _data(n: int, seed: int) -> dict:
    """Columns of ``SCHEMA`` with NULLs in every column."""
    rng = np.random.default_rng(seed)

    def nul(v, p=0.15):
        return [None if rng.random() < p else x for x in v]
    return {"a": nul(np.round(rng.uniform(-5, 5, n), 3).tolist()),
            "b": nul(np.round(rng.uniform(-5, 5, n), 3).tolist()),
            "i": nul(rng.integers(-20, 20, n).tolist()),
            "j": nul(rng.integers(1, 6, n).tolist()),
            "s": nul([WORDS[k] for k in rng.integers(0, len(WORDS), n)])}


def _frames(data: dict, conf: dict, parts: int = 2):
    """The same data as a reference and a port DataFrame."""
    js = JSession(dict(conf, **REF_OFF))
    ts = TpuSession(conf, device="cpu")
    jdf = js.create_dataframe(data, [(n, jdt.type_named(t))
                                     for n, t in SCHEMA],
                              num_partitions=parts)
    tdf = ts.create_dataframe(data, [(n, tdt.type_named(t))
                                     for n, t in SCHEMA],
                              num_partitions=parts)
    return jdf, tdf


# ---------------------------------------------------------------------------
# The compiler: one function a line, so its source can be read back.
# ---------------------------------------------------------------------------

K_FLOAT = 7.0
K_TEXT = "Ab"
TABLE = {1: 2}


def _closure(k):
    return lambda a: a * k


def clamp(a, lo, hi):
    return lo if a < lo else (hi if a > hi else a)


def documented(a):
    """A docstring is skipped."""
    return a + 1.0


def looped(a):
    out = 0
    for _ in range(3):
        out += a
    return out


def two_statements(a):
    b = a + 1.0
    return b


def bare(a):
    return


def star(*a):
    return a


f_arith = lambda a, b: a * 2.0 + b - 1.5  # noqa: E731
f_div = lambda a, b: a / b  # noqa: E731
f_mod = lambda i, j: i % j  # noqa: E731
f_pow = lambda a: a ** 2  # noqa: E731
f_unary = lambda a: -a + (+a)  # noqa: E731
f_not = lambda a, b: not (a > b)  # noqa: E731
f_cmp = lambda a, b: (a < b) == (a <= b)  # noqa: E731
f_ge = lambda a, b: a >= b  # noqa: E731
f_ne = lambda i, j: i != j  # noqa: E731
f_chain = lambda a, b: 0.0 < a < b  # noqa: E731
f_bool = lambda a, b: a > 0.0 and b > 0.0 or a < -1.0  # noqa: E731
f_ifexp = lambda i: 1 if i > 3 else 0  # noqa: E731
f_calls = lambda a, b: min(abs(a), max(b, 1.0)) + round(a)  # noqa: E731
f_len = lambda s: len(s)  # noqa: E731
f_methods = lambda s: s.upper() == s.lower().strip()  # noqa: E731
f_trims = lambda s: s.lstrip() == s.rstrip()  # noqa: E731
f_strlit = lambda s: s == "Ab"  # noqa: E731
f_boollit = lambda a: True if a > 0.0 else False  # noqa: E731
f_captured = lambda a: a + K_FLOAT  # noqa: E731
f_captured_str = lambda s: s == K_TEXT  # noqa: E731
f_nonliteral = lambda a: TABLE  # noqa: E731
f_module = lambda a: math.erf(a)  # noqa: E731
f_unknown_call = lambda a: sum(a)  # noqa: E731
f_keyword = lambda a: round(a, ndigits=1)  # noqa: E731
f_arity = lambda a: round(a, 1)  # noqa: E731
f_none = lambda a: a if a > 0.0 else None  # noqa: E731
f_complex = lambda a: a + 1j  # noqa: E731
f_floordiv = lambda i, j: i // j  # noqa: E731
f_bitand = lambda i, j: i & j  # noqa: E731
f_invert = lambda i: ~i  # noqa: E731
f_in = lambda i: i in (1, 2)  # noqa: E731
f_is = lambda a: a is None  # noqa: E731
f_default = lambda a, b=1.0: a + b  # noqa: E731
f_subscript = lambda s: s[0]  # noqa: E731
f_computed = lambda a: [abs][0](a)  # noqa: E731
f_method_args = lambda s: s.strip("x")  # noqa: E731
f_unknown_method = lambda s: s.title()  # noqa: E731
f_free = lambda a: a + undefined_name_in_this_module  # noqa: E731,F821
f_eval = eval("lambda a: a + 1.0")
f_min = lambda a, b: min(a, b)  # noqa: E731
f_max = lambda a, b: max(a, b)  # noqa: E731
f_ipow = lambda i, j: i ** j  # noqa: E731

# name -> (function, argument columns, outcome). "compiles": native
# columns; "refused": ``.compiled`` is False and a call gives a ``pyudf``
# (the checks made when ``udf`` is called: source, parameters, captures,
# one return); "raises": ``.compiled`` is True, and building the columns
# raises UdfCompileError (the body is walked when the UDF is applied, in
# both packages).
COMPILER = {
    "arith": (f_arith, "ab", "compiles"), "div": (f_div, "ab", "compiles"),
    "mod": (f_mod, "ij", "compiles"), "pow": (f_pow, "a", "compiles"),
    "unary": (f_unary, "a", "compiles"), "not": (f_not, "ab", "compiles"),
    "cmp": (f_cmp, "ab", "compiles"), "ge": (f_ge, "ab", "compiles"),
    "ne": (f_ne, "ij", "compiles"), "chain": (f_chain, "ab", "compiles"),
    "bool": (f_bool, "ab", "compiles"), "ifexp": (f_ifexp, "i", "compiles"),
    "calls": (f_calls, "ab", "compiles"), "len": (f_len, "s", "compiles"),
    "methods": (f_methods, "s", "compiles"),
    "trims": (f_trims, "s", "compiles"),
    "strlit": (f_strlit, "s", "compiles"),
    "boollit": (f_boollit, "a", "compiles"),
    "captured": (f_captured, "a", "compiles"),
    "captured_str": (f_captured_str, "s", "compiles"),
    "closure": (_closure(3.0), "a", "compiles"),
    "def": (clamp, "aab", "compiles"),
    "docstring": (documented, "a", "compiles"),
    "loop": (looped, "a", "refused"),
    "two_statements": (two_statements, "a", "refused"),
    "varargs": (star, "a", "refused"),
    "default": (f_default, "a", "refused"),
    "nonliteral": (f_nonliteral, "a", "refused"),
    "module": (f_module, "a", "refused"),
    "free": (f_free, "a", "refused"),
    "no_source": (f_eval, "a", "refused"),
    "bare_return": (bare, "a", "raises"),
    "unknown_call": (f_unknown_call, "a", "raises"),
    "keyword": (f_keyword, "a", "raises"), "arity": (f_arity, "a", "raises"),
    "none": (f_none, "a", "raises"), "complex": (f_complex, "a", "raises"),
    "floordiv": (f_floordiv, "ij", "raises"),
    "bitand": (f_bitand, "ij", "raises"),
    "invert": (f_invert, "i", "raises"), "in": (f_in, "i", "raises"),
    "is": (f_is, "a", "raises"), "subscript": (f_subscript, "s", "raises"),
    "computed": (f_computed, "a", "raises"),
    "method_args": (f_method_args, "s", "raises"),
    "unknown_method": (f_unknown_method, "s", "raises"),
}


def _schema(P):
    return tuple((n, P.type_named(t)) for n, t in SCHEMA)


@pytest.mark.parametrize("name", sorted(COMPILER))
def test_compile_matches_reference(name):
    fn, args, outcome = COMPILER[name]
    j, t = judf(fn), udf(fn)
    assert (t.compiled, t.compile_error) == (j.compiled, j.compile_error)
    assert t.compiled is (outcome != "refused"), t.compile_error
    jcols = [JL.col(c) for c in args]
    tcols = [L.col(c) for c in args]
    if outcome == "refused":
        with pytest.raises(UdfCompileError,
                           match=re.escape(t.compile_error)):
            compile_udf(fn)
        assert t(*tcols).node[0] == j(*jcols).node[0] == "pyudf"
        assert t(*tcols).node[4] == t.compile_error
        return
    if outcome == "raises":
        with pytest.raises(Exception) as want:
            j(*jcols)
        with pytest.raises(UdfCompileError) as got:
            t(*tcols)
        assert type(want.value).__name__ == "UdfCompileError"
        assert str(got.value) == str(want.value)
        return
    want = JL.resolve(j(*jcols), _schema(jdt))
    got = L.resolve(t(*tcols), _schema(tdt))
    _same_expr(want, got)


def test_lambda_isolated_from_its_line():
    """A lambda whose line does not parse alone (an entry of a dict)
    compiles through the reference's isolation of its text, up to the
    first comma: with one parameter it compiles, with two the text stops
    inside the parameters and both packages raise SyntaxError."""
    made = {
        "one": lambda a: a + 1.0,
        "two": lambda a, b: a + b,
    }
    for u in (udf, judf):
        assert u(made["one"]).compiled
        with pytest.raises(SyntaxError):
            u(made["two"])


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_compiled_rows_match_reference(conf):
    """Every compiled case in one select, on 60 seeded rows with NULLs in
    each column; rows exact, but ``pow`` (``a ** 2``, the engine's Pow)
    within rtol 1e-14, as ``tests/test_torch_math.py`` holds the
    transcendentals (XLA's and torch's libm differ in the last bits)."""
    jdf, tdf = _frames(_data(60, 5), CONFS[conf])
    names = sorted(n for n, (_, _, how) in COMPILER.items()
                   if how == "compiles")
    ip = names.index("pow")

    def cols(u, M):
        return [u(COMPILER[n][0])(*[M.col(c) for c in COMPILER[n][1]])
                .alias(n) for n in names]

    def split(rows):
        return ([r[:ip] + r[ip + 1:] for r in rows],
                np.array([np.nan if r[ip] is None else r[ip]
                          for r in rows]))
    want, want_pow = split(jdf.select(*cols(judf, JL)).collect())
    q = tdf.select(*cols(udf, L))
    for rows in (q.collect(), q.collect_host()):
        got, got_pow = split(rows)
        assert_rows_equal(got, want, msg=conf)
        np.testing.assert_allclose(got_pow, want_pow, rtol=1e-14, atol=0)
    assert "pyudf" not in q.explain()


class TestFuzzedEquivalence:
    """The grammar of ``tests/test_udf.py``'s fuzzer: random expressions
    over arithmetic, abs/min/max and conditionals of two doubles."""

    def _gen_expr(self, rng, depth=0):
        leaves = ["a", "b", "1.5", "2.0", "0.25"]
        if depth > 2 or rng.random() < 0.3:
            return rng.choice(leaves)
        kind = rng.choice(["bin", "call", "cond"])
        if kind == "bin":
            op = rng.choice(["+", "-", "*"])
            return (f"({self._gen_expr(rng, depth + 1)} {op} "
                    f"{self._gen_expr(rng, depth + 1)})")
        if kind == "call":
            fn = rng.choice(["abs", "min", "max"])
            if fn == "abs":
                return f"abs({self._gen_expr(rng, depth + 1)})"
            return (f"{fn}({self._gen_expr(rng, depth + 1)}, "
                    f"{self._gen_expr(rng, depth + 1)})")
        return (f"({self._gen_expr(rng, depth + 1)} if "
                f"{self._gen_expr(rng, depth + 1)} > 0.0 else "
                f"{self._gen_expr(rng, depth + 1)})")

    @pytest.mark.parametrize("seed", range(8))
    def test_fuzzed(self, seed, tmp_path):
        rng = random.Random(seed)
        src = f"lambda a, b: {self._gen_expr(rng)}"
        mod = tmp_path / f"udf_fuzz_{seed}.py"
        mod.write_text(f"f = {src}\n")
        spec = importlib.util.spec_from_file_location(
            f"torch_udf_fuzz_{seed}", mod)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        f = m.f
        tf, jf = udf(f), judf(f)
        assert tf.compiled and jf.compiled, src
        xs = [rng.uniform(-5, 5) for _ in range(40)]
        ys = [rng.uniform(-5, 5) for _ in range(40)]
        data = {"a": xs, "b": ys}
        js = JSession(REF_OFF)
        want = [r[0] for r in js.create_dataframe(
            data, [("a", jdt.FLOAT64), ("b", jdt.FLOAT64)],
            num_partitions=2).select(
                jf(JL.col("a"), JL.col("b")).alias("z")).collect()]
        tdf = TpuSession(device="cpu").create_dataframe(
            data, [("a", tdt.FLOAT64), ("b", tdt.FLOAT64)],
            num_partitions=2)
        got = [r[0] for r in tdf.select(
            tf(L.col("a"), L.col("b")).alias("z")).collect()]
        assert got == want, src
        assert got == pytest.approx([f(x, y) for x, y in zip(xs, ys)]), src


# ---------------------------------------------------------------------------
# Compiled UDFs answer with the engine's semantics, not Python's
# ---------------------------------------------------------------------------

NAN = float("nan")
# name -> (function, [(column, type)], rows, Python's answers (an exception
# class where Python raises), the engine's answers).
DIVERGENT = {
    "remainder_sign": (f_mod, [("i", "int64"), ("j", "int64")],
                       [(-7, 3), (7, -3), (5, 0)], [2, -2, ZeroDivisionError],
                       [-1, 1, None]),
    "float_remainder": (f_mod, [("a", "double"), ("b", "double")],
                        [(-7.5, 2.0), (5.0, 0.0)], [0.5, ZeroDivisionError],
                        [-1.5, None]),
    "round_half_up": (lambda a: round(a), [("a", "double")],
                      [(2.5,), (-2.5,), (0.5,), (1.5,)], [2, -2, 0, 2],
                      [3.0, -3.0, 1.0, 2.0]),
    "strip_spaces_only": (lambda s: s.strip(), [("s", "string")],
                          [("\t x \n",), ("  y  ",)], ["x", "y"],
                          ["\t x \n", "y"]),
    "divide_by_zero": (f_div, [("a", "double"), ("b", "double")],
                       [(1.0, 0.0), (0.0, 0.0), (7.0, 2.0)],
                       [ZeroDivisionError, ZeroDivisionError, 3.5],
                       [None, None, 3.5]),
    "min_skips_null": (f_min, [("a", "double"), ("b", "double")],
                       [(None, 1.0), (NAN, 1.0), (1.0, NAN)],
                       [TypeError, NAN, 1.0], [1.0, 1.0, 1.0]),
    "max_nan_greatest": (f_max, [("a", "double"), ("b", "double")],
                         [(NAN, 1.0), (1.0, NAN)], [NAN, 1.0], [NAN, NAN]),
    "null_arithmetic": (lambda a: a * 2.0, [("a", "double")], [(None,)],
                        [TypeError], [None]),
    "null_condition": (f_ifexp, [("i", "int64")], [(None,), (4,)],
                       [TypeError, 1], [0, 1]),
    "ascii_case_map": (lambda s: s.upper(), [("s", "string")],
                       [("é",), ("straße",)], ["É", "STRASSE"],
                       ["é", "STRAßE"]),
    "pow_is_double": (f_ipow, [("i", "int64"), ("j", "int64")],
                      [(2, 3), (2, -1)], [8, 0.5], [8.0, 0.5]),
}


def _same_values(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g)
        else:
            assert g == w and type(g) is type(w), (got, want)


@pytest.mark.parametrize("name", sorted(DIVERGENT))
def test_compiled_divergence_from_python_pinned(name):
    fn, schema, rows, py, engine = DIVERGENT[name]
    for r, p in zip(rows, py):
        if isinstance(p, type):
            with pytest.raises(p):
                fn(*r)
        else:
            _same_values([fn(*r)], [p])
    tf, jf = udf(fn), judf(fn)
    assert tf.compiled and jf.compiled
    conf = {"spark.rapids.sql.incompatibleOps.enabled": True}
    jdf = JSession(dict(conf, **REF_OFF)).create_dataframe(
        rows, [(n, jdt.type_named(t)) for n, t in schema])
    tdf = TpuSession(conf, device="cpu").create_dataframe(
        rows, [(n, tdt.type_named(t)) for n, t in schema])
    want = [r[0] for r in jdf.select(
        jf(*[JL.col(n) for n, _ in schema]).alias("z")).collect()]
    q = tdf.select(tf(*[L.col(n) for n, _ in schema]).alias("z"))
    _same_values(want, engine)
    _same_values([r[0] for r in q.collect()], engine)
    _same_values([r[0] for r in q.collect_host()], engine)


# ---------------------------------------------------------------------------
# PythonUDF: the host-evaluated fallback
# ---------------------------------------------------------------------------

def erf_or_none(a):
    return math.erf(a) if a is not None else None


def reverse_or_none(s):
    if s is None:
        return None
    return s[::-1]


def none_to_minus_one(a):
    if a is None:
        return -1.0
    return a * 10.0


def count_vowels(s):
    n = 0
    for ch in s or "":
        n += ch in "aeiou"
    return n


FALLBACK = {
    "erf": (erf_or_none, "double", "a"),
    "string_result": (reverse_or_none, "string", "s"),
    "none_passed": (none_to_minus_one, "double", "b"),
    "loop_int": (count_vowels, "int64", "s"),
}


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("name", sorted(FALLBACK))
def test_python_udf_after_filter_matches_reference(name, conf):
    """A filter in front (selection vectors on the device half), then the
    UDF and an aggregate over its result; rows exact (the float sum to
    the harness's tolerance) and each UDF row the Python function's."""
    fn, rt, arg = FALLBACK[name]
    data = _data(80, 11)
    jdf, tdf = _frames(data, CONFS[conf], parts=3)
    ju, tu = judf(fn, return_type=rt), udf(fn, return_type=rt)
    assert not tu.compiled and tu.compile_error == ju.compile_error

    def query(df, u, M):
        return df.filter(M.col("i") > -5).select(
            "i", M.col(arg).alias("x"), u(M.col(arg)).alias("z"))
    want = sorted(query(jdf, ju, JL).collect(), key=repr)
    q = query(tdf, tu, L)
    assert q._physical().host_fallback_nodes() == []
    for rows in (q.collect(), q.collect_host()):
        assert_rows_equal(sorted(rows, key=repr), want, msg=name)
    live = [x for i, x in zip(data["i"], data[arg])
            if i is not None and i > -5]
    assert len(want) == len(live)
    for _i, x, z in want:
        _same_values([z], [fn(x)])
    agg = q.group_by("i").agg(L.agg_count(L.col("z")).alias("n"))
    jagg = query(jdf, ju, JL).group_by("i").agg(
        JL.agg_count(JL.col("z")).alias("n"))
    assert sorted(agg.collect()) == sorted(jagg.collect())


def inverse_distance(a):
    d = a - 3.0
    return 1.0 / d


def test_python_udf_error_names_the_row():
    f = udf(inverse_distance, return_type="double")
    jf = judf(inverse_distance, return_type="double")
    assert not f.compiled
    data = {"a": [1.0, 2.0, 3.0, 4.0]}
    tdf = TpuSession(device="cpu").create_dataframe(
        data, [("a", tdt.FLOAT64)])
    jdf = JSession(REF_OFF).create_dataframe(data, [("a", jdt.FLOAT64)])
    with pytest.raises(RuntimeError) as want:
        jdf.select(jf(JL.col("a")).alias("z")).collect()
    for run in ("collect", "collect_host"):
        with pytest.raises(RuntimeError) as got:
            getattr(tdf.select(f(L.col("a")).alias("z")), run)()
        assert str(got.value) == str(want.value)
        assert "failed on row 2: float division by zero" in str(got.value)


def test_explain_note_matches_reference():
    jdf, tdf = _frames(_data(10, 2), {})
    report = tdf.select(udf(erf_or_none)(L.col("a")).alias("z")).explain()
    jreport = jdf.select(judf(erf_or_none)(JL.col("a")).alias("z")) \
        .explain()
    note = [ln.strip() for ln in report.splitlines() if "python UDF" in ln]
    jnote = [ln.strip() for ln in jreport.splitlines() if "python UDF" in ln]
    assert len(note) == 1 and note == jnote
    assert "captured variable 'math' is not a literal constant" in note[0]


def test_island_counts_and_result_device():
    """``island.pyudf.*`` count the selected rows downloaded and the column
    uploaded, into the running operator's metrics; the result lies on the
    batch's device, at its capacity, NULL under dead rows."""
    data = {"a": [float(k) for k in range(20)]}
    hb = HostBatch.from_pydict([("a", tdt.FLOAT64)], data)
    batch = host_to_device(hb, device="cpu")
    keep = np.arange(batch.capacity) % 3 == 0
    batch = batch.with_sel(torch.from_numpy(keep))
    e = TE.PythonUDF(none_to_minus_one, tdt.FLOAT64,
                     [TE.BoundReference(0, tdt.FLOAT64)])
    m = Metrics("ProjectExec")
    with timed(m):
        out = e.eval(batch)
    assert out.data.device == batch.device
    assert out.data.shape[0] == batch.capacity
    live = (np.arange(batch.capacity) < 20) & keep
    assert m.values["island.pyudf.rows"] == int(live.sum()) == 7
    assert m.values["island.pyudf.bytesDown"] > 0
    assert m.values["island.pyudf.bytesUp"] == batch.capacity * 9
    np.testing.assert_array_equal(out.validity.numpy(), live)
    np.testing.assert_array_equal(out.data.numpy()[live],
                                  np.arange(20)[keep[:20]] * 10.0)
    sel_free = DeviceBatch(batch.columns, batch.num_rows)
    assert e.eval(sel_free).validity.numpy()[:20].all()
