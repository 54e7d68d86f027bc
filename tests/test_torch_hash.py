"""Port parity: murmur3 ``hash_column`` and the grouping ``key_fingerprint``
of spark_rapids_tpu_torch are bit-identical to the JAX package's device
path for every dtype, including null rows, -0.0 vs 0.0, NaN payloads,
subnormal doubles (the JAX path's flush to zero) and string tails.

Inputs are numpy arrays handed to both engines as device columns. The JAX
package's u32 results are compared as int64, the port's u32 carrier.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.exprs import hash as jhash
from spark_rapids_tpu.ops import kernels as jkernels

from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.exprs import hash as thash
from spark_rapids_tpu_torch.ops import kernels as tkernels

CAP = 96


def _f64_edges():
    v = np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, 2.2e-308,
                  -1e-310, 2.2250738585072014e-308, 1.0, -1.0, 1e308],
                 np.float64)
    nans = np.array([0x7FF8000000000000, 0xFFF8000000000001,
                     0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF],
                    np.uint64).view(np.float64)
    return np.concatenate([v, nans])


def _column_arrays(name, rng):
    """(data, validity, lengths) of one dtype with its edge cases."""
    validity = rng.random(CAP) < 0.8
    lengths = None
    if name == "string":
        lengths = rng.integers(0, 11, CAP).astype(np.int32)
        data = rng.integers(0, 256, (CAP, 12)).astype(np.uint8)
        data[np.arange(12)[None, :] >= lengths[:, None]] = 0
    elif name == "float64":
        data = rng.normal(0, 1e6, CAP)
        e = _f64_edges()
        data[:len(e)] = e
    elif name == "float32":
        data = rng.normal(0, 1e3, CAP).astype(np.float32)
        e = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-40],
                     np.float32)
        nans = np.array([0x7FC00000, 0xFFC00001, 0x7F800001],
                        np.uint32).view(np.float32)
        data[:9] = np.concatenate([e, nans])
    elif name == "bool":
        data = rng.random(CAP) < 0.5
    else:
        t = tdt.type_named(name)
        info = np.iinfo(t.np_dtype)
        data = rng.integers(info.min, info.max, CAP, dtype=np.int64,
                            endpoint=True).astype(t.np_dtype)
        data[:2] = [info.min, info.max]
    validity[:3] = True
    return data, validity, lengths


def _columns(name, data, validity, lengths):
    jc = jbatch.DeviceColumn(
        jdt.type_named(name), jnp.asarray(data), jnp.asarray(validity),
        None if lengths is None else jnp.asarray(lengths))
    tc = tbatch.DeviceColumn(
        tdt.type_named(name), torch.from_numpy(np.array(data)),
        torch.from_numpy(np.array(validity)),
        None if lengths is None else torch.from_numpy(np.array(lengths)))
    return jc, tc


LADDER = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
          "date", "timestamp", "string"]


@pytest.mark.parametrize("name", LADDER)
def test_hash_column_bit_identical(name):
    rng = np.random.default_rng(LADDER.index(name))
    jc, tc = _columns(name, *_column_arrays(name, rng))
    seeds = rng.integers(0, 2 ** 32, CAP, dtype=np.uint64)
    want = np.asarray(jhash.hash_column(
        jnp, jc, jc.dtype, jnp.asarray(seeds.astype(np.uint32))))
    got = thash.hash_column(tc, tc.dtype,
                            torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


def test_double_bits_matches_device_path():
    """Real bitcast with subnormals flushed to +/-0 equals the JAX
    package's arithmetic decomposition, bit for bit."""
    rng = np.random.default_rng(3)
    x = np.concatenate([_f64_edges(), rng.normal(0, 1e200, 64),
                        rng.normal(0, 1e-300, 64)])
    want = np.asarray(jhash._double_bits_device(jnp.asarray(x)))
    got = thash._double_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want, got)


def test_string_tail_signed_bytes():
    """Every tail length 0..7 past each block count, high bytes (signed
    in the JVM tail) included."""
    n = 64
    lengths = (np.arange(n) % 16).astype(np.int32)
    data = np.full((n, 16), 0xF3, np.uint8)
    data[np.arange(16)[None, :] >= lengths[:, None]] = 0
    jc, tc = _columns("string", data, np.ones(n, np.bool_), lengths)
    want = np.asarray(jhash.hash_column(jnp, jc, jc.dtype,
                                        jnp.full((n,), 42, jnp.uint32)))
    got = thash.hash_column(tc, tc.dtype,
                            torch.full((n,), 42, dtype=torch.int64))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("names", [
    ["int32"], ["float64"], ["string"], ["bool"], ["float32"], ["timestamp"],
    ["string", "int32"], ["float64", "string", "int64"],
    ["date", "int8", "int16"]])
def test_key_fingerprint_bit_identical(names):
    rng = np.random.default_rng(len(names) * 7 + len(names[0]))
    jcols, tcols = [], []
    for name in names:
        jc, tc = _columns(name, *_column_arrays(name, rng))
        jcols.append(jc)
        tcols.append(tc)
    ja, jb = jkernels.key_fingerprint(jcols, CAP)
    ta, tb = tkernels.key_fingerprint(tcols, CAP)
    np.testing.assert_array_equal(np.asarray(ja).astype(np.int64), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64), tb.numpy())


def test_fingerprint_groups_zero_signs_and_nans_together():
    """-0.0/0.0 and every NaN payload fingerprint alike (grouping
    equality), nulls alike whatever data they carry."""
    x = np.array([0.0, -0.0] + list(_f64_edges()[-4:]) + [7.0, 3.0])
    valid = np.array([True] * 6 + [False, False])
    _, tc = _columns("float64", x, valid, None)
    ha, hb = tkernels.key_fingerprint([tc], len(x))
    assert ha[0] == ha[1] and hb[0] == hb[1]
    assert len(set(ha[2:6].tolist())) == 1
    assert ha[6] == ha[7] and hb[6] == hb[7]
