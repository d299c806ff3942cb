"""The port's foreign plans (`auron_tpu_torch/frontend/foreign.py`) and
query builders (`auron_tpu_torch/it/`) against the JAX package's.

- Every one of the 103 IT queries, built by `auron_tpu.it.queries` over
  `it/datagen.py::generate` tables (SF 0.01, seed 7), reads back through
  the port's `ForeignNode.from_json` and writes the same JSON, byte for
  byte; a plan the port writes reads back in the JAX package too.
- Every builder of the port (all 103, in the reference's order) over a
  port `Catalog` of the same table definitions gives the JAX package's
  JSON.
- Type strings: every type the JAX package writes parses to the port's
  `DataType` of that type id and back; an unknown one raises naming it.
"""

import pytest

from auron_tpu.frontend import foreign as JF
from auron_tpu.ir.node import _encode as jencode
from auron_tpu.it import datagen, queries
from auron_tpu_torch.frontend import foreign as PF
from auron_tpu_torch.ir.node import _decode as pdecode
from auron_tpu_torch.ir.schema import DataType, Field, TypeId
from auron_tpu_torch.it import datagen as pdatagen
from auron_tpu_torch.it import queries as pqueries

SF = 0.01


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def port_catalog(cat) -> pdatagen.Catalog:
    """The port's catalog of the same table definitions."""
    return pdatagen.Catalog(cat.data_dir, {
        name: pdatagen.TableDef(name, pdecode(jencode(t.schema)),
                                list(t.chunks))
        for name, t in cat.tables.items()})


@pytest.mark.parametrize("name", queries.names())
def test_foreign_plan_round_trips(name, catalog):
    ref = queries.build(name, catalog).to_json()
    port = PF.ForeignNode.from_json(ref)
    assert port.to_json() == ref
    assert JF.ForeignNode.from_json(port.to_json()).to_json() == ref


def test_the_corpus_is_103_queries():
    assert len(queries.names()) == 103


@pytest.mark.parametrize("name", pqueries.names())
def test_query_builder_is_the_references(name, catalog):
    assert pqueries.build(name, port_catalog(catalog)).to_json() == \
        queries.build(name, catalog).to_json()


def test_builders_are_the_three_card_queries():
    # the port has every builder now, in the reference's order; the
    # three queries phase 26 runs on the card are among them
    assert pqueries.names() == queries.names()
    assert {"q01", "q65w", "q13a"} <= set(pqueries.names())


def test_scan_parts_cut_the_groups(catalog):
    ref = catalog.scan("store_sales", ["ss_item_sk"], parts=3)
    port = port_catalog(catalog).scan("store_sales", ["ss_item_sk"],
                                      parts=3)
    assert port.to_json() == ref.to_json()
    assert len(port.attrs["file_groups"]) == 3


TYPE_STRINGS = ("null", "boolean", "tinyint", "smallint", "int", "bigint",
                "float", "double", "string", "binary", "date", "timestamp",
                "decimal(12,2)", "decimal(38,10)", "array<bigint>",
                "map<string,double>", "array<map<int,decimal(7,2)>>",
                "struct<a:int,b:string>",
                "struct<x:array<int>,y:map<string,struct<z:date>>>")


@pytest.mark.parametrize("s", TYPE_STRINGS)
def test_type_string_round_trips(s):
    ref = JF._dtype_from_str(s)
    port = PF._dtype_from_str(s)
    assert PF._dtype_to_str(port) == JF._dtype_to_str(ref) == s
    assert port == pdecode(jencode(ref))


def test_nested_types_are_the_references():
    assert PF._dtype_from_str("decimal(9,3)") == DataType.decimal(9, 3)
    assert PF._dtype_from_str("array<int>") == \
        DataType.list_(DataType.int32())
    m = PF._dtype_from_str("map<string,bigint>")
    assert m.id == TypeId.MAP and m.children[0] == Field(
        "key", DataType.string(), nullable=False)
    assert PF._dtype_from_str("float") == DataType.float32()


@pytest.mark.parametrize("s", ["interval", "varchar(10)", "decimal(1)",
                               "array<uuid>"])
def test_unknown_type_string_raises_naming_it(s):
    with pytest.raises(ValueError, match="cannot parse dtype string") as err:
        PF._dtype_from_str(s)
    assert {"array<uuid>": "'uuid'"}.get(s, repr(s)) in str(err.value)


def test_attrs_round_trip_every_tag():
    """@fexpr, @fnode, @dtype, @schema and @bytes inside attrs, a pickled
    evaluator on an expression, written by either package."""
    i64 = JF._dtype_from_str("bigint")
    inner = JF.ForeignNode("LocalTableScanExec", output=None,
                           attrs={"rows": [{"a": 1}]})
    ref = JF.ForeignNode(
        "ProjectExec", children=(inner,),
        attrs={"e": JF.fcall("Add", JF.fcol("a", i64), JF.flit(2)),
               "n": inner, "t": i64,
               "s": queries.Schema((queries.Field("a", i64),)),
               "b": b"\x00\x01", "deep": {"l": [JF.flit("x"), 3]},
               "py": JF.ForeignExpr("MyUdf", py_fn=b"fn", dtype=i64)})
    port = PF.ForeignNode.from_json(ref.to_json())
    assert port.attrs["e"].children[1].dtype == DataType.int32()
    assert port.attrs["b"] == b"\x00\x01"
    assert port.attrs["py"].py_fn == b"fn"
    assert port.to_json() == ref.to_json()
    assert JF.ForeignNode.from_json(port.to_json()).to_json() == \
        ref.to_json()


def test_builders_make_the_references_nodes():
    i64 = DataType.int64()
    pairs = [
        (PF.fcol("a", i64, nullable=False),
         JF.fcol("a", JF._dtype_from_str("bigint"), nullable=False)),
        (PF.flit(2**40), JF.flit(2**40)),
        (PF.flit(None), JF.flit(None)),
        (PF.falias(PF.flit(1.5), "x"), JF.falias(JF.flit(1.5), "x")),
        (PF.fcall("In", PF.flit("a"), PF.flit("b"), negated=True),
         JF.fcall("In", JF.flit("a"), JF.flit("b"), negated=True)),
    ]
    for port, ref in pairs:
        assert port.to_dict() == ref.to_dict()


def test_traversal_orders():
    leaf = PF.ForeignNode("A")
    mid = PF.ForeignNode("B", children=(leaf, PF.ForeignNode("C")))
    root = PF.ForeignNode("D", children=(mid,))
    pre, post = [], []
    root.foreach(lambda n: pre.append(n.op))
    root.foreach_up(lambda n: post.append(n.op))
    assert pre == ["D", "B", "A", "C"]
    assert post == ["A", "C", "B", "D"]
    assert root.pretty() == "D\n  B\n    A\n    C"
