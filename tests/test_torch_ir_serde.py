"""The IR wire format between the engines: TaskDefinitions serialized by
auron_tpu deserialize in auron_tpu_torch to the same JSON, and back."""

import struct
import sys
import zlib

import pytest

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir import serde

import torch_parity as TP


def _tasks():
    return [JP.TaskDefinition(plan=TP.map_plan(200), stage_id=1,
                              partition_id=3, num_partitions=8),
            JP.TaskDefinition(plan=TP.reduce_plan(), stage_id=2,
                              partition_id=17, num_partitions=200)]


@pytest.mark.parametrize("codec", ["raw", "zlib"])
@pytest.mark.parametrize("which", [0, 1])
def test_jax_task_bytes_deserialize_in_port(codec, which):
    task = _tasks()[which]
    node = serde.deserialize(jserde.serialize(task, codec=codec))
    assert isinstance(node, P.TaskDefinition)
    assert serde.to_json(node) == jserde.to_json(task)


@pytest.mark.parametrize("codec", ["raw", "zlib"])
@pytest.mark.parametrize("which", [0, 1])
def test_port_task_bytes_deserialize_in_jax(codec, which):
    task = _tasks()[which]
    port_task = serde.from_json(jserde.to_json(task))
    back = jserde.deserialize(serde.serialize(port_task, codec=codec))
    assert back == task


def test_zstd_envelope_reads_when_zstandard_imports():
    task = _tasks()[0]
    data = jserde.serialize(task, codec="zstd")   # zlib if zstd is absent
    assert serde.to_json(serde.deserialize(data)) == jserde.to_json(task)


def test_zstd_envelope_without_zstandard_raises(monkeypatch):
    data = serde.MAGIC + struct.pack("<BB", serde.VERSION, 1) + b"\0" * 8
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        serde.deserialize(data)


def test_bad_envelopes_raise():
    good = serde.serialize(serde.from_json(jserde.to_json(_tasks()[1])))
    with pytest.raises(ValueError, match="magic"):
        serde.deserialize(b"XXXX" + good[4:])
    with pytest.raises(ValueError, match="version"):
        serde.deserialize(good[:4] + b"\x09" + good[5:])
    with pytest.raises(ValueError, match="codec"):
        serde.deserialize(good[:5] + b"\x07" + good[6:])
    with pytest.raises(ValueError, match="codec"):
        serde.serialize(P.TaskDefinition(), codec="zstd")
    assert zlib.decompress(good[6:])


def test_node_kind_outside_the_slice_raises():
    plan = JP.Generate(child=TP.reduce_plan(), generator="explode",
                       args=(JE.col("ss_customer_sk"),),
                       generator_output_names=("x",),
                       generator_output_types=(JDT.int64(),))
    with pytest.raises(NotImplementedError, match="generate"):
        serde.deserialize(jserde.serialize(
            JP.TaskDefinition(plan=plan), codec="zlib"))
