"""The port's hash-pid plain version and Spark murmur3 against the JAX
package: bit-exact with the Pallas kernel (interpret mode) and with
hash_columns + pmod.  The CUDA kernel itself is held against this plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.columnar.batch import DeviceColumn as JaxColumn
from auron_tpu.exprs import hashing as JH
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ops import kernels_pallas as KP
from auron_tpu_torch.columnar.batch import DeviceColumn
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.ir.schema import DataType
from auron_tpu_torch.ops import kernels_cuda as K


def _keys(n: int, seed: int, null_frac: float = 0.1):
    rng = np.random.default_rng(seed)
    data = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                        dtype=np.int64, endpoint=True)
    return data, rng.random(n) >= null_frac


def _port_pids(data, validity, n_parts):
    return K.hash_partition_ids_i64(torch.from_numpy(data),
                                    torch.from_numpy(validity),
                                    n_parts).numpy()


# the cases of tests/test_pallas_kernels.py
@pytest.mark.parametrize("cap,n_parts", [(128, 8), (1024, 7), (4096, 200)])
def test_plain_pid_matches_pallas_kernel(cap, n_parts):
    rng = np.random.default_rng(cap)
    data = rng.integers(-2**62, 2**62, cap, dtype=np.int64)
    validity = rng.random(cap) > 0.1
    exp = np.asarray(KP.hash_partition_ids_i64(
        jnp.asarray(data), jnp.asarray(validity), n_parts, interpret=True))
    got = _port_pids(data, validity, n_parts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, exp)


def test_plain_pid_null_rows_match_pallas_kernel():
    cap, n_parts = 256, 13
    data = np.arange(cap, dtype=np.int64)
    validity = np.zeros(cap, bool)
    exp = np.asarray(KP.hash_partition_ids_i64(
        jnp.asarray(data), jnp.asarray(validity), n_parts, interpret=True))
    got = _port_pids(data, validity, n_parts)
    np.testing.assert_array_equal(got, exp)
    assert (got == 42 % n_parts).all()


@pytest.mark.parametrize("n", [1, 127, 1000, 4097])
@pytest.mark.parametrize("n_parts", [1, 7, 200])
def test_plain_pid_matches_hash_columns_pmod(n, n_parts):
    data, validity = _keys(n, seed=n * 1000 + n_parts)
    col = JaxColumn(JDT.int64(), jnp.asarray(data), jnp.asarray(validity))
    exp = np.asarray(JH.pmod(JH.hash_columns([col], seed=42), n_parts))
    np.testing.assert_array_equal(_port_pids(data, validity, n_parts), exp)


_SEEDS = np.random.default_rng(5).integers(0, 2**32, 9, dtype=np.uint64)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_hash_int32_matches():
    v = np.array([0, 1, -1, 2**31 - 1, -2**31, 42, 7, -123456, 99],
                 np.int32)
    exp = np.asarray(JH.hash_int32(jnp.asarray(v),
                                   jnp.asarray(_SEEDS.astype(np.uint32))))
    got = H.hash_int32(torch.from_numpy(v),
                       torch.from_numpy(_SEEDS.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), exp)


def test_hash_int64_matches():
    v = np.array([0, 1, -1, 2**63 - 1, -2**63, 2**32, -2**32, 42, 7],
                 np.int64)
    exp = np.asarray(JH.hash_int64(jnp.asarray(v),
                                   jnp.asarray(_SEEDS.astype(np.uint32))))
    got = H.hash_int64(torch.from_numpy(v),
                       torch.from_numpy(_SEEDS.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), exp)


def test_hash_float64_matches_incl_signed_zero_and_nan():
    v = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25,
                  2.2250738585072014e-308, 1.7976931348623157e308],
                 np.float64)
    exp = np.asarray(JH.hash_float64(jnp.asarray(v),
                                     jnp.asarray(_SEEDS.astype(np.uint32))))
    got = H.hash_float64(torch.from_numpy(v),
                         torch.from_numpy(_SEEDS.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), exp)
    # -0.0 hashes as 0.0
    z = H.hash_float64(torch.tensor([0.0, -0.0]), torch.tensor([42, 42]))
    assert int(z[0]) == int(z[1])


def test_hash_float64_subnormal_hashes_its_bits():
    """Spark hashes doubleToLongBits, subnormals included.  The JAX
    package on the CPU flushes subnormals to zero before hashing (its
    5e-324 hashes like 0.0); the port keeps Spark's semantics."""
    v = np.array([5e-324, 1e-310], np.float64)
    seed = torch.tensor([42, 42])
    got = H.hash_float64(torch.from_numpy(v), seed)
    bits = H.hash_int64(torch.from_numpy(v.view(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy(), bits.numpy())
    assert int(got[0]) != int(H.hash_float64(torch.tensor([0.0]), seed[:1]))


def test_hash_columns_chain_with_nulls_matches():
    rng = np.random.default_rng(3)
    n = 300
    i32 = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    i64, _ = _keys(n, seed=4)
    f64 = rng.normal(size=n) * 1e6
    f64[::17] = -0.0
    vals = [rng.random(n) > 0.2 for _ in range(3)]
    jcols = [JaxColumn(dt, jnp.asarray(np.where(v, a, 0)), jnp.asarray(v))
             for dt, a, v in zip((JDT.int32(), JDT.int64(), JDT.float64()),
                                 (i32, i64, f64), vals)]
    pcols = [DeviceColumn(dt, torch.from_numpy(np.where(v, a, 0)),
                          torch.from_numpy(v))
             for dt, a, v in zip((DataType.int32(), DataType.int64(),
                                  DataType.float64()),
                                 (i32, i64, f64), vals)]
    exp = np.asarray(JH.hash_columns(jcols, seed=42))
    got = H.hash_columns(pcols, seed=42)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(H.pmod(got, 200).numpy(),
                                  np.asarray(JH.pmod(jnp.asarray(exp), 200)))


@pytest.mark.parametrize("n_parts", [1, 16])
def test_partitioner_two_keys_matches(n_parts):
    """The several-keys branch (hash_columns + pmod in torch) and the
    num_partitions <= 1 branch, against the JAX partitioner."""
    from auron_tpu.columnar.batch import Batch as JaxBatch
    from auron_tpu.ops.shuffle.partitioner import PartitionIdComputer as JPC
    from auron_tpu.ir.schema import Field as JF, Schema as JS
    from auron_tpu_torch.columnar.batch import from_numpy
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    rng = np.random.default_rng(n_parts)
    n = 1500
    a = rng.integers(0, 50, n, dtype=np.int64)
    b = rng.integers(-5, 5, n, dtype=np.int64).astype(np.int32)
    va, vb = rng.random(n) > 0.1, rng.random(n) > 0.1
    jschema = JS.of(JF("a", JDT.int64()), JF("b", JDT.int32()))
    part = JP.Partitioning(mode="hash", num_partitions=n_parts,
                           expressions=(JE.col("a"), JE.col("b")))
    exp = np.asarray(JPC(part, jschema)(
        JaxBatch.from_numpy(jschema, [a, b], [va, vb])))[:n]
    from auron_tpu.ir import serde as jserde
    ppart = serde.from_json(jserde.to_json(part))
    pschema = serde.from_json(jserde.to_json(
        JP.FFIReader(schema=jschema))).schema
    got = PartitionIdComputer(ppart, pschema)(
        from_numpy(pschema, [a, b], [va, vb], device="cpu"))
    np.testing.assert_array_equal(got.numpy(), exp)
