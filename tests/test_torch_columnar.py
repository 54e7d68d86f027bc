"""Port parity: columnar core (capacity ladder, host<->device round trip,
row movement) of spark_rapids_tpu_torch against the JAX package.

Both engines get the same numpy inputs; device buffers compare one for
one (bit views, so -0.0 and NaN payloads count), host rows compare as
python values.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.columnar import rowmove as jrowmove
from spark_rapids_tpu.columnar import wire as jwire

from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost

CPU = "cpu"


def _bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(np.uint8)


def assert_bits(want, got, msg=""):
    w, g = np.asarray(want), np.asarray(got)
    assert w.shape == g.shape, (msg, w.shape, g.shape)
    assert w.dtype == g.dtype, (msg, w.dtype, g.dtype)
    assert np.array_equal(_bits(w), _bits(g)), (msg, w[:6], g[:6])


def assert_batch_equal(jb, tb, msg=""):
    """JAX DeviceBatch vs port DeviceBatch, buffer for buffer."""
    assert jb.capacity == tb.capacity, msg
    assert int(jb.num_rows) == int(tb.num_rows), msg
    assert (jb.sel is None) == (tb.sel is None), msg
    if jb.sel is not None:
        assert_bits(np.asarray(jb.sel), tb.sel.numpy(), msg + " sel")
    for i, (jc, tc) in enumerate(zip(jb.columns, tb.columns)):
        assert jc.dtype.name == tc.dtype.name
        assert_bits(np.asarray(jc.data), tc.data.numpy(), f"{msg} c{i} data")
        assert_bits(np.asarray(jc.validity), tc.validity.numpy(),
                    f"{msg} c{i} validity")
        if jc.dtype.is_string:
            assert_bits(np.asarray(jc.lengths).astype(np.int32),
                        tc.lengths.numpy(), f"{msg} c{i} lengths")


def _ladder_values(name, n, rng):
    """Values of one dtype with nulls and that type's edge cases."""
    if name == "string":
        vals = [bytes(rng.integers(0, 256, int(rng.integers(0, 41)),
                                   dtype=np.uint8)) for _ in range(n)]
        vals[:3] = [b"", b"a" * 40, "été".encode()]
    elif name == "bool":
        vals = [bool(x) for x in rng.integers(0, 2, n)]
    elif name in ("float32", "float64"):
        vals = [float(x) for x in rng.normal(0, 1e3, n)]
        vals[:6] = [-0.0, 0.0, float("nan"), float("inf"), -float("inf"),
                    5e-324 if name == "float64" else 1e-45]
    else:
        t = tdt.type_named(name)
        info = np.iinfo(t.np_dtype)
        lo, hi = (-1000, 1000) if name == "date" else (info.min, info.max)
        vals = [int(x) for x in rng.integers(lo, hi, n, dtype=np.int64)]
        vals[:2] = [int(info.min), int(info.max)]
    for i in range(6, n, 5):
        vals[i] = None
    return vals


LADDER = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
          "date", "timestamp", "string"]


def _pair_batches(schema_names, data):
    js = [(c, jdt.type_named(t)) for c, t in schema_names]
    ts = [(c, tdt.type_named(t)) for c, t in schema_names]
    return (jhost.HostBatch.from_pydict(js, data),
            thost.HostBatch.from_pydict(ts, data))


def test_bucket_capacity_matches_reference():
    ns = range(1, 100_001)
    assert [tbatch.bucket_capacity(n) for n in ns] == \
        [jbatch.bucket_capacity(n) for n in ns]


@pytest.mark.parametrize("name", LADDER)
def test_round_trip_dtype_ladder(name, monkeypatch):
    rng = np.random.default_rng(7)
    n = 37
    vals = _ladder_values(name, n, rng)
    jhb, thb = _pair_batches([("x", name)], {"x": vals})
    tb = thost.host_to_device(thb, device=CPU)
    # Plain codec: the JAX upload lands the identical device buffers.
    monkeypatch.setattr(jwire, "_CODEC_OVERRIDE", "plain")
    jb = jhost.host_to_device(jhb)
    assert_batch_equal(jb, tb, name)
    got = thost.device_to_host(tb).to_pylist()
    assert repr(got) == repr(jhost.device_to_host(jb).to_pylist())
    # The default (v2) codec round trip gives the same host values.
    monkeypatch.setattr(jwire, "_CODEC_OVERRIDE", "v2")
    want = jhost.device_to_host(jhost.host_to_device(jhb)).to_pylist()
    assert repr(got) == repr(want)


def _jax_arrays(jb):
    cols = [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in jb.columns]
    sel = None if jb.sel is None else np.asarray(jb.sel)
    return [c.dtype for c in jb.columns], cols, int(jb.num_rows), sel


def _port_of(jb):
    dts, cols, n, sel = _jax_arrays(jb)
    return thost.from_jax_batch_arrays(
        [tdt.type_named(t.name) for t in dts], cols, n, device=CPU, sel=sel)


def _mixed_jax_batch(n, seed):
    rng = np.random.default_rng(seed)
    data = {"i": [None if k % 4 == 0 else int(v) for k, v in
                  enumerate(rng.integers(-50, 50, n))],
            "f": [None if k % 5 == 0 else float(v) for k, v in
                  enumerate(rng.normal(0, 10, n))],
            "s": [None if k % 6 == 0 else bytes(rng.integers(
                97, 123, int(rng.integers(0, 12)), dtype=np.uint8))
                for k in range(n)]}
    jhb, _ = _pair_batches([("i", "int64"), ("f", "float64"),
                            ("s", "string")], data)
    return jhost.host_to_device(jhb)


def test_from_jax_batch_arrays_round_trip():
    jb = _mixed_jax_batch(50, 1)
    tb = _port_of(jb)
    assert_batch_equal(jb, tb)
    assert repr(thost.device_to_host(tb).to_pylist()) == \
        repr(jhost.device_to_host(jb).to_pylist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_movement_parity(seed):
    """with_sel / compact / gather_rows / concat / shrink_all produce the
    JAX package's buffers one for one."""
    rng = np.random.default_rng(seed)
    jb = _mixed_jax_batch(45, seed)
    tb = _port_of(jb)
    keep = rng.random(jb.capacity) < 0.6
    jk, tk = jnp.asarray(keep), torch.from_numpy(keep)
    # selection vector + live count
    js, ts = jb.with_sel(jk), tb.with_sel(tk)
    assert int(js.live_count()) == int(ts.live_count())
    assert_bits(np.asarray(js.row_mask()), ts.row_mask().numpy())
    # compaction
    assert_batch_equal(jb.compact(jk), tb.compact(tk), "compact")
    # gather with clipping and a dead tail
    idx = rng.integers(-3, jb.capacity + 3, 32).astype(np.int32)
    assert_batch_equal(
        jrowmove.gather_rows(jb, jnp.asarray(idx), jnp.asarray(20)),
        tb.gather(torch.from_numpy(idx), torch.tensor(20)),
        "gather")
    # concat of a sel batch and a dense one
    jb2 = _mixed_jax_batch(20, seed + 10)
    tb2 = _port_of(jb2)
    cap = jbatch.bucket_capacity(js.capacity + jb2.capacity)
    assert_batch_equal(jbatch.concat_batches([js, jb2], cap),
                       tbatch.concat_batches([ts, tb2], cap), "concat")
    # sizes-then-shrink
    (jsh,), jc = jbatch.shrink_all([js])
    (tsh,), tc = tbatch.shrink_all([ts])
    assert jc == tc
    assert_batch_equal(jsh, tsh, "shrink")


def test_download_applies_selection_on_host():
    jb = _mixed_jax_batch(30, 3)
    keep = np.arange(jb.capacity) % 3 != 0
    js = jb.with_sel(jnp.asarray(keep))
    ts = _port_of(jb).with_sel(torch.from_numpy(keep))
    assert repr(thost.download_batches([ts], ["i", "f", "s"])[0]
                .to_pylist()) == \
        repr(jhost.download_batches([js], ["i", "f", "s"])[0].to_pylist())


def test_upload_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    _, thb = _pair_batches([("x", "int32")], {"x": [1, 2, 3]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thost.host_to_device(thb)
