"""The FFI reader's import of pyarrow RecordBatches, auron_tpu_torch
against auron_tpu (`Batch.from_arrow`): date32 as int32 days, timestamps
as int64 microseconds and bool as bool, each with its validity (ROADMAP
Queue 3 item 5: the port raised on all three)."""

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ir.schema import TypeId as JT
from auron_tpu_torch.ops.scan.ipc import arrow_to_numpy

import torch_parity as TP

SCHEMA = JS.of(JF("d", JDT(JT.DATE32)), JF("ts", JDT(JT.TIMESTAMP_US)),
               JF("b", JDT.bool_()), JF("i", JDT.int32()),
               JF("f", JDT.float64()))


def _batch(n, seed, ts_unit="us"):
    rng = np.random.default_rng(seed)
    mask = [rng.random(n) < 0.2 for _ in range(5)]
    return pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-40000, 40000, n, dtype=np.int32),
                 type=pa.date32(), mask=mask[0]),
        pa.array(rng.integers(-2**50, 2**50, n, dtype=np.int64),
                 type=pa.timestamp(ts_unit), mask=mask[1]),
        pa.array(rng.random(n) < 0.5, mask=mask[2]),
        pa.array(rng.integers(-9, 9, n, dtype=np.int32), mask=mask[3]),
        pa.array(rng.normal(size=n), mask=mask[4])],
        names=["d", "ts", "b", "i", "f"])


def test_queue_inputs_import():
    """The queue's inputs: [1, None, 3] as date32 and timestamp[us],
    [True, None, False] as bool."""
    rb = pa.RecordBatch.from_arrays([
        pa.array([1, None, 3], type=pa.date32()),
        pa.array([1, None, 3], type=pa.timestamp("us")),
        pa.array([True, None, False])], names=["d", "ts", "b"])
    arrays, valid = arrow_to_numpy(rb)
    assert [a.tolist() for a in arrays] == [[1, 0, 3], [1, 0, 3],
                                            [True, False, False]]
    assert arrays[0].dtype == np.int32 and arrays[1].dtype == np.int64
    assert [v.tolist() for v in valid] == [[True, False, True]] * 3


@pytest.mark.parametrize("n,batches", [(1, 1), (777, 3), (5000, 2)])
def test_ffi_reader_imports_like_the_reference(n, batches):
    rbs = [_batch(n, seed=s) for s in range(batches)]
    plan = JP.FFIReader(schema=SCHEMA, resource_id="src")
    port, jax = TP.run_both(plan, rbs, rbs)
    names = ("d", "ts", "b", "i", "f")
    TP.assert_same_rows(port.to_numpy(), TP.jax_columns(jax.batches, names),
                        names)


def test_timestamp_units_become_microseconds():
    rb = pa.RecordBatch.from_arrays(
        [pa.array([-5, None, 7], type=pa.timestamp("ms"))], names=["ts"])
    arrays, valid = arrow_to_numpy(rb)
    assert arrays[0].tolist() == [-5000, 0, 7000]
    assert valid[0].tolist() == [True, False, True]
