"""Range partition ids, auron_tpu_torch against auron_tpu's
PartitionIdComputer on the same batch, plan and sampled bounds: int64,
float64 and two-key orders, with rows tied to bounds and null keys in
rows and bounds."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ops.shuffle.partitioner import PartitionIdComputer as JPids
from auron_tpu_torch.columnar.batch import from_numpy
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer

import torch_parity as TP

N = 2000


def _data(seed):
    """k: int64 in -50..50, p: float64 on a 0.5 grid, both with nulls."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 51, N, dtype=np.int64)
    p = np.round(rng.random(N) * 40) / 2 - 5.0 + 0.0
    p[::13] = np.inf
    p[5::17] = np.nan
    valid = [rng.random(N) >= 0.1, rng.random(N) >= 0.1]
    return [k, p], valid


def _bounds_from(cols, valid, keys, n_parts, seed):
    """Bound rows drawn from the data itself, so that rows tie with them,
    null where the drawn row is null.  They need not be sorted: the id
    is the count of bounds below the row either way."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(N, n_parts - 1, replace=False)
    out = []
    for r in rows:
        row = []
        for ki in keys:
            v = cols[ki][r]
            row.append(None if not valid[ki][r] else
                       (float(v) if cols[ki].dtype.kind == "f" else int(v)))
        out.append(tuple(row))
    return tuple(out)


ORDERS = {
    "int64": ((0, True, True),),
    "int64_desc_nulls_last": ((0, False, False),),
    "float64": ((1, True, False),),
    "float64_desc": ((1, False, True),),
    "two_keys": ((1, False, False), (0, True, True)),
}
NAMES = ("k", "p")
SCHEMA = JS.of(JF("k", JDT.int64()), JF("p", JDT.float64()))


def _ids_both(cols, valid, orders, n_parts, bounds, n=N):
    part = JP.Partitioning(
        mode="range", num_partitions=n_parts,
        sort_orders=tuple(JE.SortExpr(child=JE.col(NAMES[ki]), asc=asc,
                                      nulls_first=nf)
                          for ki, asc, nf in orders),
        range_bounds=bounds)
    rb = TP.to_arrow(cols, valid, SCHEMA)
    jax = np.asarray(JPids(part, SCHEMA)(JBatch.from_arrow(rb)))[:n]
    port_part = serde.from_json(serde.to_json(part))
    port_schema = serde.from_json(serde.to_json(JP.IpcReader(
        schema=SCHEMA))).schema
    batch = from_numpy(port_schema, cols, valid, device="cpu")
    port = PartitionIdComputer(port_part, port_schema)(batch)
    return port.numpy(), jax


@pytest.mark.parametrize("n_parts", [2, 8, 33])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_range_ids_match_jax(order, n_parts):
    cols, valid = _data(seed=n_parts)
    keys = [ki for ki, _, _ in ORDERS[order]]
    bounds = _bounds_from(cols, valid, keys, n_parts, seed=n_parts + 1)
    port, jax = _ids_both(cols, valid, ORDERS[order], n_parts, bounds)
    assert port.dtype == np.int32 and port.shape == (N,)
    np.testing.assert_array_equal(port, jax)
    assert port.min() >= 0 and port.max() <= n_parts - 1
    assert len(set(port.tolist())) > 1


def test_ties_go_to_the_lower_partition():
    cols = [np.array([1, 2, 3, 3, 4, 5], np.int64),
            np.zeros(6, np.float64)]
    valid = [np.ones(6, bool), np.ones(6, bool)]
    port, jax = _ids_both(cols, valid, ((0, True, True),), 3,
                          ((3,), (4,)), n=6)
    np.testing.assert_array_equal(port, [0, 0, 0, 0, 1, 2])
    np.testing.assert_array_equal(port, jax)


@pytest.mark.parametrize("dtype,bound", [(np.int64, 2.5), (np.int32, 1 << 40),
                                         (np.float64, "x")])
def test_bounds_outside_the_key_type_raise(dtype, bound):
    """A bound the key's type cannot hold would land rows in the wrong
    partition: the writer refuses the plan instead."""
    schema = JS.of(JF("k", JDT.int64() if dtype == np.int64 else
                      JDT.int32() if dtype == np.int32 else JDT.float64()))
    part = JP.Partitioning(
        mode="range", num_partitions=3,
        sort_orders=(JE.SortExpr(child=JE.col("k")),),
        range_bounds=((0,), (bound,)))
    port_schema = serde.from_json(serde.to_json(
        JP.IpcReader(schema=schema))).schema
    with pytest.raises((ValueError, OverflowError)):
        PartitionIdComputer(serde.from_json(serde.to_json(part)),
                            port_schema)


def test_int32_keys_use_their_own_key_space():
    """Reference fault (ROADMAP Queue 3): over an int32 key the JAX
    package puts every row into partition 0, because it encodes the
    Python-int bounds as int64 words against the rows' u32 words.  Spark,
    the pyarrow oracle (count of bounds below the key) and the port give
    [0, 0, 0, 1, 1, 2, 2, 3]; so does the JAX package over int64 keys."""
    keys = np.array([-5, 0, 3, 10, 20, 50, 99, 100], np.int32)
    bounds = ((3,), (20,), (99,))
    schema = JS.of(JF("k", JDT.int32()))
    part = JP.Partitioning(
        mode="range", num_partitions=4,
        sort_orders=(JE.SortExpr(child=JE.col("k")),), range_bounds=bounds)
    rb = pa.RecordBatch.from_arrays([pa.array(keys)], names=["k"])
    jax = np.asarray(JPids(part, schema)(JBatch.from_arrow(rb)))[:8]
    port_schema = serde.from_json(serde.to_json(
        JP.IpcReader(schema=schema))).schema
    port = PartitionIdComputer(serde.from_json(serde.to_json(part)),
                               port_schema)(
        from_numpy(port_schema, [keys], device="cpu")).numpy()
    arr = pa.array(keys)
    oracle = np.sum([pc.less(pa.scalar(b[0], pa.int32()), arr).to_numpy(
        zero_copy_only=False) for b in bounds], axis=0)
    np.testing.assert_array_equal(port, oracle)
    np.testing.assert_array_equal(port, [0, 0, 0, 1, 1, 2, 2, 3])
    np.testing.assert_array_equal(jax, np.zeros(8))
    wide, wide_jax = _ids_both([keys.astype(np.int64), np.zeros(8)],
                               [np.ones(8, bool)] * 2, ((0, True, True),),
                               4, bounds, n=8)
    np.testing.assert_array_equal(wide_jax, oracle)
    np.testing.assert_array_equal(wide, oracle)
