"""Port parity: the ``spark.rapids.sql.native.*`` gates and each kernel's
library route (``spark_rapids_tpu_torch/ops/native.py``).

- Each library route (a gate off) against the JAX package's XLA route (its
  gates at their default, which on the CPU take XLA), bit for bit: K1 a
  stable ``torch.sort`` vs ``jnp.argsort`` through ``_radix_perm``, K2 a
  ``scatter_reduce_`` vs ``jax.ops.segment_*`` through ``segment_reduce``,
  K3 two ``torch.searchsorted`` vs ``jnp.searchsorted`` through
  ``probe_ranges``, K4 ``searchsorted`` + gather vs the wire decode's
  non-native branch through the upload funnel.
- Each plain version (a live gate on a CPU tensor) against the JAX
  package's Pallas kernel under ``native.forced()``, bit for bit.
- Gate precedence as ``tests/test_native.py`` pins it (conf over env over
  the default, the master switch, ``forced``), K4 under its gate at any
  run count (``rleDecode.maxRuns`` is read by nothing), and
  ``native.fingerprint()`` following the live gates.
- Routing with the device test stubbed: tensors on the ``meta`` device
  take the non-CPU branch, whose kernel entries are replaced by
  recorders, as are the plain versions. A live gate must reach the
  kernel entry and no plain version; a gate that is off the library
  route, which for K3 and K4 is their plain version.

Tolerance: bit-identical everywhere (no float sum takes any of these
routes).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.columnar import wire as jwire
from spark_rapids_tpu.ops import kernels as jkernels
from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.columnar import wire as twire
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.ops import kernels as tkernels
from spark_rapids_tpu_torch.ops import native as tnative


def _bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(np.uint8)


def _same(want, got, msg=""):
    w, g = np.asarray(want), np.asarray(got)
    assert w.shape == g.shape, (msg, w.shape, g.shape)
    assert np.array_equal(_bits(w), _bits(g)), (msg, w[:8], g[:8])


@pytest.fixture(autouse=True)
def _gates_at_default():
    tnative.maybe_configure(TpuConf())
    tnative.reset_counters()
    yield
    tnative.maybe_configure(TpuConf())


# ---------------------------------------------------------------------------
# Library routes against the JAX package's XLA routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,hi,words", [(12, 5, 1), (384, 2 ** 32, 2),
                                          (768, 9, 3), (3000, 2 ** 32, 2)])
def test_k1_library_route_matches_xla(cap, hi, words):
    rng = np.random.default_rng(cap + words)
    passes = [rng.integers(0, hi, cap, dtype=np.uint64)
              for _ in range(words)]
    assert not jnative.kernel_enabled("radixSort")   # XLA's jnp.argsort
    want = jkernels._radix_perm(
        [jnp.asarray(p.astype(np.uint32)) for p in passes], cap)
    with tnative.forced(radixSort=False):
        got = tkernels._radix_perm(
            [torch.from_numpy(p.astype(np.int64)) for p in passes], cap)
    _same(np.asarray(want).astype(np.int64), got.numpy(), "perm")
    assert tnative.library_counters()["radix_sort"] == words
    assert tnative.counters()["radix_sort"] == 0


def _seg_inputs(dtype, cap, rng):
    gid = np.sort(rng.integers(0, max(cap // 3, 1), cap)).astype(np.int64)
    if np.issubdtype(dtype, np.floating):
        # No -0.0 beside 0.0 in a group: XLA's segment_min/max keeps
        # whichever comes first, the total-order routes -0.0 below 0.0.
        v = rng.choice(np.array([1.5, -2.25, np.nan, np.inf, -np.inf,
                                 -0.0, 7.0], dtype), cap)
    elif dtype == np.bool_:
        v = rng.integers(0, 2, cap).astype(np.bool_)
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, cap, dtype=dtype,
                         endpoint=True)
    valid = rng.random(cap) > 0.2
    return gid, v, valid


# Float sums take neither route (a scatter-add), so they are not here.
K2_CASES = [(k, d) for k in ("sum", "min", "max")
            for d in (np.int8, np.int32, np.int64, np.float32, np.float64)
            if not (k == "sum" and np.issubdtype(d, np.floating))]


@pytest.mark.parametrize("kind,dtype", K2_CASES,
                         ids=[f"{k}-{np.dtype(d).name}" for k, d in K2_CASES])
def test_k2_library_route_matches_xla(kind, dtype):
    rng = np.random.default_rng(len(kind) * 7 + np.dtype(dtype).itemsize)
    cap = 96
    gid, v, valid = _seg_inputs(dtype, cap, rng)
    if np.issubdtype(dtype, np.floating):
        v = np.where(v == 0, np.asarray(0.0, dtype), v)     # no -0.0
    assert not jnative.kernel_enabled("segmentReduce")
    jagg, jcnt = jkernels.segment_reduce(
        jnp.asarray(v), jnp.asarray(valid), jnp.asarray(gid.astype(np.int32)),
        cap, kind)
    with tnative.forced(segmentReduce=False):
        tagg, tcnt = tkernels.segment_reduce(
            torch.from_numpy(v), torch.from_numpy(valid),
            torch.from_numpy(gid), cap, kind)
    _same(jagg, tagg.numpy(), f"{kind} agg")
    _same(np.asarray(jcnt).astype(np.int64), tcnt.numpy(), f"{kind} count")
    assert tnative.library_counters()["seg_reduce"] >= 1
    assert tnative.counters()["seg_reduce"] == 0


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("bits", [32, 64])
def test_k2_library_route_matches_plain(kind, bits):
    """The library route and the kernel's plain version: one function,
    ids past the capacity dropped, unsigned order for min/max."""
    rng = np.random.default_rng(bits + len(kind))
    n, capacity = 300, 70
    gid = torch.from_numpy(np.sort(rng.integers(0, 90, n)).astype(np.int64))
    dtype = torch.int32 if bits == 32 else torch.int64
    keys = torch.from_numpy(rng.integers(-2 ** (bits - 1), 2 ** (bits - 1),
                                         n, dtype=np.int64)).to(dtype)
    identity = {"sum": 0, "min": -1, "max": 0}[kind]
    want = tnative.seg_reduce_plain(gid, keys, kind, capacity, identity)
    got = tnative.segment_reduce_library(gid, keys, kind, capacity,
                                         identity)
    assert torch.equal(want, got)


def test_k3_library_route_matches_xla():
    from spark_rapids_tpu.columnar import host as jh
    from spark_rapids_tpu.ops import join as jjoin
    from spark_rapids_tpu_torch.ops import join as tjoin
    from spark_rapids_tpu_torch.columnar.host import host_to_device
    rng = np.random.default_rng(11)
    build = {"k": [int(x) for x in rng.integers(0, 6, 40)]}
    pvals = [int(x) for x in rng.integers(0, 9, 64)]
    pvals[3] = None
    jb = jh.host_to_device(jh.HostBatch.from_pydict([("k", jdt.INT64)],
                                                     build))
    jp = jh.host_to_device(jh.HostBatch.from_pydict([("k", jdt.INT64)],
                                                     {"k": pvals}))
    tb = host_to_device(thost.HostBatch.from_pydict([("k", tdt.INT64)],
                                                    build), device="cpu")
    tp = host_to_device(thost.HostBatch.from_pydict([("k", tdt.INT64)],
                                                    {"k": pvals}),
                        device="cpu")
    assert not jnative.kernel_enabled("joinProbe")
    want = jjoin.probe_ranges(jjoin.build_side(jb, [0]), jp, [0])
    with tnative.forced(joinProbe=False):
        got = tjoin.probe_ranges(tjoin.build_side(tb, [0]), tp, [0])
    for w, g in zip(want, got):
        w = np.asarray(w)
        _same(w, g.numpy().astype(w.dtype))
    assert tnative.library_counters()["join_probe"] == 1
    assert tnative.counters()["join_probe"] == 0


def test_k3_library_route_u64_order():
    """Fingerprints above 2^63 (negative as int64) sort last in u64 order;
    the sign flip keeps them there."""
    b = np.sort(np.array([1, 5, 5, 2 ** 63, 2 ** 64 - 2, 2 ** 64 - 1,
                          2 ** 64 - 1], np.uint64))
    q = np.array([0, 5, 2 ** 63, 2 ** 64 - 1, 2 ** 62, 2 ** 64 - 2],
                 np.uint64)
    lo, hi = tnative.searchsorted_u64_pair_plain(
        torch.from_numpy(b.view(np.int64)), torch.from_numpy(q.view(np.int64)))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(b, q, "left"))
    np.testing.assert_array_equal(hi.numpy(), np.searchsorted(b, q, "right"))


RLE_COLUMNS = {
    "float64": (jdt.FLOAT64, [float(x) for x in np.repeat(
        [1.5, -0.0, 2.5, float("nan")], 30)]),
    "int32": (jdt.INT32, [int(x) for x in np.repeat([7, -9, 2 ** 30], 40)]),
    "int8": (jdt.INT8, [int(x) for x in np.repeat([1, 2, -3, 4], 25)]),
}


@pytest.mark.parametrize("name", sorted(RLE_COLUMNS))
def test_k4_library_route_matches_xla(name):
    """A run-coded column through the real upload funnel: the port's
    library route (gate off) vs the JAX package's XLA decode."""
    t, vals = RLE_COLUMNS[name]
    jhb = jhost.HostBatch.from_pydict([("v", t)], {"v": vals})
    thb = thost.HostBatch.from_pydict([("v", tdt.type_named(t.name))],
                                      {"v": vals})
    assert not jnative.kernel_enabled("rleDecode")
    want = jwire.upload_packed(jwire.pack_batch(jhb)).columns[0]
    enc = twire.pack_batch(thb)
    assert any(s[0] == "rle" for s in enc.specs), enc.specs
    with tnative.forced(rleDecode=False):
        got = twire.upload_packed(enc, device="cpu").columns[0]
    _same(want.data, got.data.numpy(), name)
    _same(want.validity, got.validity.numpy(), name)
    assert tnative.library_counters()["rle_decode"] >= 1


def _many_runs_batch(runs: int = 6000, length: int = 4):
    """One int64 column of ``runs`` runs of ``length`` rows, distinct
    random values over the whole int64 range, so RLE leads the codecs."""
    rng = np.random.default_rng(17)
    vals = rng.integers(-2 ** 62, 2 ** 62, runs, dtype=np.int64)
    col = [int(x) for x in np.repeat(vals, length)]
    return thost.HostBatch.from_pydict([("v", tdt.INT64)], {"v": col}), col


@pytest.mark.parametrize("max_runs", [None, 4])
def test_k4_takes_any_run_count_under_its_gate(max_runs):
    """A run table above the JAX package's 4,096-run bound goes to K4's
    entry under a live gate, whatever ``rleDecode.maxRuns`` says; only the
    gate sends it to the library route."""
    thb, col = _many_runs_batch()
    enc = twire.pack_batch(thb)
    spec = next(s for s in enc.specs if s[0] == "rle")
    assert spec[3] > 4096, spec
    conf = {} if max_runs is None else {
        "spark.rapids.sql.native.rleDecode.maxRuns": max_runs}
    tnative.maybe_configure(TpuConf(conf))
    got = twire.upload_packed(enc, device="cpu").columns[0].data
    assert tnative.library_counters()["rle_decode"] == 0
    assert got[:len(col)].tolist() == col
    with tnative.forced(rleDecode=False):
        off = twire.upload_packed(enc, device="cpu").columns[0].data
    assert tnative.library_counters()["rle_decode"] == 1
    assert torch.equal(got, off)


# ---------------------------------------------------------------------------
# Plain versions against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------

def test_plain_versions_match_pallas():
    rng = np.random.default_rng(5)
    cap = 384
    keys = rng.integers(0, 2 ** 32, cap, dtype=np.uint64)
    keys[rng.random(cap) < 0.3] = 7
    with jnative.forced():
        want = jnative.stable_argsort_u32(jnp.asarray(keys.astype(np.uint32)))
    got = tnative.stable_argsort_u32(torch.from_numpy(keys.astype(np.int64)))
    _same(want, got.numpy(), "K1")

    b = np.sort(rng.integers(0, 2 ** 63, 96).astype(np.uint64))
    b[-2:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    q = rng.choice(np.concatenate([b, rng.integers(0, 2 ** 63, 24)
                                   .astype(np.uint64)]), 24)
    with jnative.forced():
        jlo, jhi = jnative.searchsorted_u64_pair(jnp.asarray(b),
                                                 jnp.asarray(q))
    tlo, thi = tnative.searchsorted_u64_pair(
        torch.from_numpy(b.view(np.int64)), torch.from_numpy(q.view(np.int64)))
    _same(jlo, tlo.numpy(), "K3 lo")
    _same(jhi, thi.numpy(), "K3 hi")

    gid = np.sort(rng.integers(0, 30, 96)).astype(np.int32)
    v = rng.choice(np.array([1.5, -0.0, 0.0, np.nan, -3.0]), 96)
    with jnative.forced():
        jm = jnative.segment_minmax_sorted(jnp.asarray(v), jnp.asarray(gid),
                                           96, "min")
    tm = tnative.segment_minmax_sorted(torch.from_numpy(v),
                                       torch.from_numpy(gid.astype(np.int64)),
                                       96, "min")
    _same(jm, tm.numpy(), "K2 min")

    run_vals = np.array([3.5, -0.0, np.nan, 0, 0, 0, 0, 0], np.float64)
    ends = np.array([10, 25, 40, 64, 64, 64, 64, 64], np.int32)
    with jnative.forced():
        jd = jnative.rle_decode(jnp.asarray(run_vals), jnp.asarray(ends), 64,
                                jnp.asarray(40, jnp.int32))
    td = tnative.rle_decode(torch.from_numpy(run_vals),
                            torch.from_numpy(ends), 64, 40)
    _same(jd, td.numpy(), "K4")
    assert set(tnative.counters().values()) == {0}
    assert set(tnative.library_counters().values()) == {0}


# ---------------------------------------------------------------------------
# Gate precedence, as tests/test_native.py pins it
# ---------------------------------------------------------------------------

def test_gates_default_on():
    assert tnative.master_enabled() and tnative.available()
    assert all(tnative.kernel_enabled(k) for k in tnative.KERNELS)
    assert tnative.fingerprint() == ("native", tnative.KERNELS)
    assert tnative.gate_counters() == {"nativeEnabled": True,
                                       "nativeKernels": list(tnative.KERNELS)}


def test_conf_keys_gate_individually():
    tnative.maybe_configure(TpuConf(
        {"spark.rapids.sql.native.radixSort.enabled": False}))
    assert not tnative.kernel_enabled("radixSort")
    assert tnative.kernel_enabled("joinProbe")
    assert tnative.gate_counters()["nativeKernels"] == [
        "joinProbe", "rleDecode", "segmentReduce"]


def test_master_kill_switch():
    tnative.maybe_configure(TpuConf({"spark.rapids.sql.native.enabled":
                                     "false"}))
    assert not any(tnative.kernel_enabled(k) for k in tnative.KERNELS)
    assert tnative.fingerprint() == ()
    assert tnative.gate_counters()["nativeEnabled"] is False


def test_env_kill_switches(monkeypatch):
    monkeypatch.setenv("SRT_NATIVE", "0")
    assert not tnative.master_enabled()
    assert tnative.fingerprint() == ()
    monkeypatch.setenv("SRT_NATIVE", "1")
    monkeypatch.setenv("SRT_NATIVE_JOINPROBE", "0")
    assert not tnative.kernel_enabled("joinProbe")
    assert tnative.kernel_enabled("rleDecode")
    # An explicitly set conf key beats the env.
    tnative.maybe_configure(TpuConf(
        {"spark.rapids.sql.native.joinProbe.enabled": True}))
    assert tnative.kernel_enabled("joinProbe")
    tnative.maybe_configure(TpuConf({"spark.rapids.sql.native.enabled":
                                     True}))
    monkeypatch.setenv("SRT_NATIVE", "0")
    assert tnative.master_enabled()


def test_forced_hook_scopes():
    with tnative.forced(radixSort=False):
        assert not tnative.kernel_enabled("radixSort")
        assert tnative.kernel_enabled("rleDecode")
        with tnative.forced(master=False):
            assert tnative.fingerprint() == ()
        assert tnative.kernel_enabled("segmentReduce")
    assert tnative.kernel_enabled("radixSort")


def test_collect_adopts_the_query_gates():
    from spark_rapids_tpu_torch.api import TpuSession
    s = TpuSession({"spark.rapids.sql.native.radixSort.enabled": False},
                   device="cpu")
    df = s.create_dataframe({"k": [3, 1, 2]}, [("k", tdt.INT64)])
    assert df.order_by("k").collect() == [(1,), (2,), (3,)]
    assert not tnative.kernel_enabled("radixSort")
    assert tnative.library_counters()["radix_sort"] > 0


def test_fingerprint_follows_the_live_gates():
    """``native.fingerprint()`` names the live kernels, so a cache of
    composed steps keyed on it never serves a step composed under the
    other gate setting."""
    assert tnative.fingerprint() == ("native", tnative.KERNELS)
    with tnative.forced(rleDecode=False):
        assert tnative.fingerprint() == (
            "native", ("radixSort", "joinProbe", "segmentReduce"))
    with tnative.forced(master=False):
        assert tnative.fingerprint() == ()


# ---------------------------------------------------------------------------
# Routing with the device test stubbed
# ---------------------------------------------------------------------------

PLAIN_OF = {"stable_argsort_u32_plain": "K1", "seg_reduce_plain": "K2",
            "searchsorted_u64_pair_plain": "K3", "rle_decode_plain": "K4"}


@pytest.fixture
def stubbed(monkeypatch):
    """Meta tensors take the non-CPU branch: its kernel entries record
    their calls, as ``K1``-``K4``, and so do the plain versions, as
    ``plain K1``-``plain K4``."""
    calls = []

    def plain(name):
        def record(*a, **k):
            calls.append(f"plain {PLAIN_OF[name]}")
            if name == "searchsorted_u64_pair_plain":
                n = a[1].numel()
                return (torch.empty(n, dtype=torch.int32, device=a[1].device),
                        torch.empty(n, dtype=torch.int32, device=a[1].device))
            if name == "rle_decode_plain":
                return torch.empty(a[2], dtype=a[0].dtype, device=a[0].device)
            raise AssertionError(f"{name} ran for a non-CPU tensor")
        return record
    for name in PLAIN_OF:
        monkeypatch.setattr(tnative, name, plain(name))

    def sort_cuda(keys, perm):
        calls.append("K1")
        return torch.empty(keys.numel(), device=keys.device,
                           dtype=torch.int32 if perm is None
                           else torch.int64)

    def seg(gid, keys, kind, capacity, identity):
        calls.append("K2")
        return torch.empty(capacity, dtype=keys.dtype, device=keys.device)

    def probe(built_fp, probe_fp):
        calls.append("K3")
        n = probe_fp.numel()
        return (torch.empty(n, dtype=torch.int32, device=probe_fp.device),
                torch.empty(n, dtype=torch.int32, device=probe_fp.device))

    def rle(run_vals, run_ends, num_rows, out):
        calls.append("K4")
    monkeypatch.setattr(tnative, "_stable_argsort_u32_cuda", sort_cuda)
    monkeypatch.setattr(tnative, "seg_reduce", seg)
    monkeypatch.setattr(tnative, "_searchsorted_u64_pair_cuda", probe)
    monkeypatch.setattr(tnative, "rle_expand", rle)
    return calls


def _call_sites(meta):
    """K1 and K2 through their call sites in ``ops/kernels.py``; K3 and K4
    through the gated choice ``ops/join.py`` ``probe_ranges`` and
    ``columnar/wire.py``'s RLE arm make."""
    words = [torch.zeros(64, dtype=torch.int64, device=meta)
             for _ in range(2)]
    tkernels._radix_perm(words, 64)
    gid = torch.zeros(64, dtype=torch.int64, device=meta)
    tkernels._seg_minmax(torch.zeros(64, dtype=torch.int64, device=meta),
                         gid, 64, "min")
    tkernels._seg_sum(torch.zeros(64, dtype=torch.int32, device=meta), gid,
                      64)
    fp = torch.zeros(64, dtype=torch.int64, device=meta)
    if tnative.kernel_enabled("joinProbe"):
        tnative.searchsorted_u64_pair(fp, fp)
    else:
        tnative.count_library("join_probe")
        tnative.searchsorted_u64_pair_plain(fp, fp)
    ends = torch.zeros(8, dtype=torch.int32, device=meta)
    vals = torch.zeros(8, dtype=torch.int64, device=meta)
    if tnative.kernel_enabled("rleDecode"):
        tnative.rle_decode(vals, ends, 64, 60)
    else:
        tnative.count_library("rle_decode")
        tnative.rle_decode_plain(vals, ends, 64, 60)


def test_device_tensors_launch_or_take_the_library_route(stubbed):
    _call_sites("meta")
    assert stubbed == ["K1", "K1", "K2", "K2", "K3", "K4"]
    assert set(tnative.library_counters().values()) == {0}
    stubbed.clear()
    with tnative.forced(master=False):
        _call_sites("meta")
    # K3's and K4's library routes are their plain versions.
    assert stubbed == ["plain K3", "plain K4"]
    assert tnative.library_counters() == {"radix_sort": 2, "join_probe": 1,
                                          "seg_reduce": 2, "rle_decode": 1}
    tnative.reset_counters()
    stubbed.clear()
    with tnative.forced(segmentReduce=False, rleDecode=False):
        _call_sites("meta")
    assert stubbed == ["K1", "K1", "K3", "plain K4"]
    assert tnative.library_counters()["seg_reduce"] == 2


def test_new_modules_import_no_jax():
    """The slice's modules import neither jax nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import spark_rapids_tpu_torch.ops.native, "
            "spark_rapids_tpu_torch.ops.kernel_cache, "
            "spark_rapids_tpu_torch.ops.fused, "
            "spark_rapids_tpu_torch.exprs.bindslots, "
            "spark_rapids_tpu_torch.plan.fusion, "
            "spark_rapids_tpu_torch.plan.plan_cache\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'spark_rapids_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True)
