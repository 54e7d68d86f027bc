"""Port parity of ``GenerateExec`` (``ops/generate.py``: explode,
posexplode, explode_outer of an inline array) against the JAX package's
``GenerateExec`` on the CPU, and of its front end (``explode`` /
``posexplode`` / ``explode_outer`` through ``TpuSession``).

- Device half: the same input device batches (NULL elements, rows whose
  every element is NULL, string elements of different widths, a dead
  tail) give the same output batches, buffer for buffer: capacity
  ``bucket_capacity(cap * K)``, live rows, data, validity, lengths.
- Host half: the port's numpy expansion gives the rows, in order, of the
  reference's per-row Python loop (the oracle), on several batches.
- The planner's ``skip_nulls = outer``: explode emits K rows a row, NULLs
  included; explode_outer drops NULL elements and emits one all-NULL row
  for an all-NULL row. Explode over a child the default conf puts on the
  host runs on the card above a bridge; a task-context expression among
  the elements raises the reference's analysis error.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops.base import ExecContext as JCtx
from spark_rapids_tpu.ops.generate import GenerateExec as JGenerate
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import ExecContext as TCtx
from spark_rapids_tpu_torch.ops import GenerateExec, InMemorySourceExec
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_placement import REF_OFF, _shape

SCHEMA = (("k", "int64"), ("s", "string"), ("a", "int32"), ("b", "int32"),
          ("c", "int32"), ("x", "string"), ("y", "string"), ("d", "date"),
          ("e", "date"))
WORDS = ["", "a", "bb", "é日", "ccc dddd", "xxxxxxxxxxxxxxxxxxxxxxxx",
         "𝄞 music"]


def _data(n: int, seed: int) -> dict:
    """Columns of ``SCHEMA`` with NULL elements and all-NULL rows (every
    fifth row's ints and strings)."""
    rng = np.random.default_rng(seed)

    def ints():
        return [None if (i % 5 == 0 or rng.random() < 0.3) else
                int(rng.integers(-50, 50)) for i in range(n)]

    def strs(pool):
        return [None if (i % 5 == 0 or rng.random() < 0.3) else
                pool[int(rng.integers(0, len(pool)))] for i in range(n)]
    return {"k": list(range(n)), "s": [WORDS[i % 3] for i in range(n)],
            "a": ints(), "b": ints(), "c": ints(),
            "x": strs(WORDS[:4]), "y": strs(WORDS),
            "d": [None if i % 4 == 0 else 10_000 + i for i in range(n)],
            "e": [None if i % 5 == 0 else -3_000 - i for i in range(n)]}


def _batches(P, sizes, seed=0):
    schema = [(n, (jdt if P == "jax" else tdt).type_named(t))
              for n, t in SCHEMA]
    H = jhost.HostBatch if P == "jax" else thost.HostBatch
    out = []
    for i, n in enumerate(sizes):
        out.append(H.from_pydict(schema, _data(n, seed + i)))
    return tuple(schema), out


CASES = {
    "explode_int": (("a", "b", "c"), False, False),
    "posexplode_int": (("a", "b", "c"), True, False),
    "explode_outer_int": (("a", "b", "c"), False, True),
    "posexplode_outer_int": (("a", "b", "c"), True, True),
    "explode_string": (("x", "y"), False, False),
    "explode_outer_string": (("x", "y"), False, True),
    "posexplode_string": (("y", "x", "s"), True, False),
    "explode_date": (("d", "e"), False, False),
    "explode_outer_one": (("a",), False, True),
}


def _execs(case, sizes, seed=0):
    names, position, outer = CASES[case]
    jschema, jbatches = _batches("jax", sizes, seed)
    tschema, tbatches = _batches("port", sizes, seed)
    ji = {n: i for i, (n, _) in enumerate(jschema)}
    jx = JGenerate(jbase.InMemorySourceExec(jschema, [jbatches]),
                   [JE.BoundReference(ji[n], jschema[ji[n]][1])
                    for n in names], position=position, outer=outer,
                   element_name="v", skip_nulls=outer)
    tx = GenerateExec(InMemorySourceExec(tschema, [tbatches], device="cpu"),
                      [TE.BoundReference(ji[n], tschema[ji[n]][1])
                       for n in names], position=position, outer=outer,
                      element_name="v", skip_nulls=outer)
    return jx, tx


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_batches_match_reference(case):
    jx, tx = _execs(case, (37, 8, 100))
    assert [(n, t.name) for n, t in tx.schema] == \
        [(n, t.name) for n, t in jx.schema]
    jout = list(jx.execute_device(JCtx(), 0))
    tout = list(tx.execute_device(TCtx(), 0))
    assert len(tout) == len(jout) == 3
    for a, b in zip(tout, jout):
        assert a.capacity == b.capacity
        assert int(a.num_rows) == int(b.num_rows)
        assert (a.sel is None) == (b.sel is None)
        for c, d in zip(a.columns, b.columns):
            assert c.data.numpy().tobytes() == np.asarray(d.data).tobytes()
            assert c.data.shape == tuple(d.data.shape)
            np.testing.assert_array_equal(c.validity.numpy(),
                                          np.asarray(d.validity))
            if d.lengths is not None:
                np.testing.assert_array_equal(c.lengths.numpy(),
                                              np.asarray(d.lengths))


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_rows_match_reference_loop(case):
    jx, tx = _execs(case, (37, 0, 100, 1), seed=4)
    want = [hb.to_pylist() for hb in jx.execute_host(JCtx(), 0)]
    got = [hb.to_pylist() for hb in tx.execute_host(TCtx(), 0)]
    assert got == want
    assert sum(map(len, got)) > 0


def test_semantics():
    """explode keeps NULL elements (K rows a row); explode_outer drops them
    and gives an all-NULL row one NULL element row; positions follow the
    element order."""
    _, tx = _execs("posexplode_int", (25,))
    rows = [r for hb in tx.execute_host(TCtx(), 0) for r in hb.to_pylist()]
    assert len(rows) == 25 * 3
    assert [r[-2] for r in rows[:6]] == [0, 1, 2, 0, 1, 2]
    data = _data(25, 0)
    _, tx = _execs("explode_outer_int", (25,))
    rows = [r for hb in tx.execute_host(TCtx(), 0) for r in hb.to_pylist()]
    for k in range(25):
        mine = [r[-1] for r in rows if r[0] == k]
        vals = [v for v in (data["a"][k], data["b"][k], data["c"][k])
                if v is not None]
        assert mine == (vals or [None])
    assert any(r[-1] is None for r in rows)


# ---------------------------------------------------------------------------
# The front end
# ---------------------------------------------------------------------------

def _frames(build, conf, n=400):
    data = _data(n, 9)
    t = TpuSession(conf, device="cpu").create_dataframe(
        data, [(c, tdt.type_named(ty)) for c, ty in SCHEMA],
        num_partitions=2)
    j = JSession(dict(conf, **REF_OFF, **{
        "spark.rapids.sql.shuffle.partitions": 1})).create_dataframe(
        data, [(c, jdt.type_named(ty)) for c, ty in SCHEMA],
        num_partitions=2)
    return build(L, t), build(JL, j)


FRONT = {
    "posexplode_by_pos": lambda M, df: df.select(
        M.col("k"), M.posexplode(M.col("a"), M.col("b")).alias("v")
    ).group_by(M.col("v__pos")).agg(M.agg_count().alias("n"),
                                    M.agg_sum(M.col("v")).alias("s"))
    .order_by("v__pos"),
    "explode_outer_strings": lambda M, df: df.select(
        M.col("k"), M.explode_outer(M.col("x"), M.col("y")).alias("w")
    ).order_by("k", "w"),
    "explode_with_column": lambda M, df: df.with_column(
        "v", M.explode(M.col("d"), M.col("e"))).filter(
        M.col("v").isNotNull()).select(M.col("k"), M.col("v"))
    .order_by("k", "v"),
    # The default conf puts the upper() projection on the host engine; the
    # generate above it runs on the card over a bridge.
    "generate_over_host_child": lambda M, df: df.select(
        M.col("k"), M.upper(M.col("x")).alias("ux"), M.col("y")).select(
        M.col("k"), M.explode(M.col("ux"), M.col("y")).alias("w")
    ).group_by("w").agg(M.agg_count().alias("n")).order_by("w"),
}
CONFS = {"device": {"spark.rapids.sql.incompatibleOps.enabled": True},
         "default": {}}


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("q", sorted(FRONT))
def test_front_end_matches_reference(q, conf):
    tdf, jdf = _frames(FRONT[q], CONFS[conf])
    tphys, jphys = tdf._physical(), jdf._physical()
    assert tphys.host_fallback_nodes() == jphys.host_fallback_nodes()
    assert _shape(tphys.root) == _shape(jphys.root)
    assert "GenerateExec" in tphys.tree()
    want = jdf.collect()
    assert want
    assert tdf.collect() == want
    assert tdf.collect_host() == jdf.collect_host() == want
    if q == "generate_over_host_child" and conf == "default":
        assert tphys.host_fallback_nodes() == ["LogicalProject"]
        assert "HostToDeviceExec" in tphys.tree()


def test_schema_names_position_column():
    tdf, jdf = _frames(lambda M, df: df.select(
        M.posexplode(M.col("a"), M.col("b")).alias("v")), {})
    assert tdf.columns == jdf.columns == ["v__pos", "v"]


def test_forbid_contextual_on_explode_elements():
    def bad(M, df):
        return df.select(M.explode(M.rand(3), M.col("a").cast("double"))
                         .alias("v"))
    tdf, jdf = _frames(bad, {})
    with pytest.raises(JL.ResolutionError, match="task-context") as je:
        jdf.collect()
    with pytest.raises(L.ResolutionError, match="task-context") as te:
        tdf.collect()
    assert str(te.value) == str(je.value)
    assert "explode elements" in str(te.value)


def test_size_estimate_counts_elements():
    """The port's estimate above a generate is K times its child's (the
    reference has none there)."""
    from spark_rapids_tpu_torch.plan.pruning import estimate_bytes
    tdf, _ = _frames(lambda M, df: df.select(
        M.col("k"), M.explode(M.col("a"), M.col("b"), M.col("c"))
        .alias("v")), {})
    gen = tdf._plan.children[0]
    assert isinstance(gen, L.LogicalGenerate)
    assert estimate_bytes(gen) == 3 * estimate_bytes(gen.child)
