"""The port's convert strategy and converters (`auron_tpu_torch/frontend/
strategy.py`, `converters.py`, `expr_convert.py`) against the JAX
package's, with no execution.

- The corpus: for every one of the 103 IT queries (SF 0.01, seed 7),
  the plan goes across as the JAX package's JSON.  The tags (strategy
  and reason, node by node in `foreach` order), the converted tree (each
  native plan through `ir/serde.py`, each foreign section by its node),
  every exchange's child and partitioning, every broadcast's child,
  every source, each stage's part count and every resource id equal the
  JAX package's.  Both contexts draw ids from the same `_uid`.
- Configuration variants: each `auron.enable.<op>` switch the corpus
  reaches, off one at a time, and `auron.force.shuffled.hash.join` on,
  over six queries: the same tags and trees, the C2N readers that a
  switched-off op creates included.
- Expressions: one sample per registered expression name, aggregate
  function and join type; where the port's IR lacks the kind the JAX
  package emits, the port raises NotConvertible naming it.
- Providers: a registered scan provider claims the scans in both
  packages alike.
"""

import json

import pytest

from auron_tpu import config as jconfig
from auron_tpu.frontend import converters as JC
from auron_tpu.frontend import expr_convert as JEC
from auron_tpu.frontend import foreign as JF
from auron_tpu.frontend import strategy as JS
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JField
from auron_tpu.it import datagen, queries
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.frontend import expr_convert as PEC
from auron_tpu_torch.frontend import foreign as PF
from auron_tpu_torch.frontend import strategy as PS
from auron_tpu_torch.ir import serde as pserde

from torch_parity import scan_provider

SF = 0.01
UID = "t0"


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def convert(plan, S, C):
    tags = S.apply(plan)
    ctx = C.ConvertContext()
    ctx._uid = UID
    return plan, tags, C.convert_recursively(plan, tags, ctx), ctx


def both(ref_plan):
    port_plan = PF.ForeignNode.from_json(ref_plan.to_json())
    return convert(ref_plan, JS, JC), convert(port_plan, PS, PC)


def tag_list(plan, tags):
    out = []
    plan.foreach(lambda n: out.append(
        (n.op, tags.strategy[id(n)].value, tags.reason(n))))
    return out


def tree(c, serde, ctx):
    """A converted tree as JSON-able data with each native stage's part
    count: a native plan by its serde JSON, a foreign section by its
    node."""
    if isinstance(c, (JC.ForeignWrap, PC.ForeignWrap)):
        return {"foreign": c.node.to_dict(),
                "children": [tree(x, serde, ctx) for x in c.children]}
    return {"plan": json.loads(serde.to_json(c)), "parts": ctx.parts(c)}


def summary(converted, ctx, serde):
    return {
        "root": tree(converted, serde, ctx),
        "exchanges": {rid: {"child": tree(j.child, serde, ctx),
                            "partitioning": json.loads(
                                serde.to_json(j.partitioning)),
                            "schema": None if j.schema is None else
                            [f.name for f in j.schema.fields]}
                      for rid, j in ctx.exchanges.items()},
        "broadcasts": {rid: tree(j.child, serde, ctx)
                       for rid, j in ctx.broadcasts.items()},
        "sources": {rid: None if s.node is None else
                    tree(s.node, serde, ctx)
                    for rid, s in ctx.sources.items()},
    }


def assert_same_conversion(ref_plan):
    (jp, jt, jr, jc), (pp, pt, pr, pc) = both(ref_plan)
    assert tag_list(pp, pt) == tag_list(jp, jt)
    assert summary(pr, pc, pserde) == summary(jr, jc, jserde)
    return pr, pc


@pytest.mark.parametrize("name", queries.names())
def test_corpus_conversion_is_the_references(name, catalog):
    root, ctx = assert_same_conversion(queries.build(name, catalog))
    # the corpus converts whole: every node native, every scan a
    # data-only parquet scan the session refuses without a provider
    assert not isinstance(root, PC.ForeignWrap)
    assert all(s.node is None or not s.node.children
               for s in ctx.sources.values())


VARIANT_QUERIES = ("q01", "q13a", "q65w", "q27r", "q33b", "q96")
SWITCHES = ("project", "filter", "sort", "agg", "limit", "union", "expand",
            "window", "shuffle", "smj", "shj", "bhj", "parquet.scan")


def _scoped(kv):
    class Both:
        def __enter__(self):
            self.a = conf.scoped(kv)
            self.b = jconfig.conf.scoped(kv)
            self.a.__enter__()
            self.b.__enter__()

        def __exit__(self, *exc):
            self.b.__exit__(*exc)
            self.a.__exit__(*exc)
            return False
    return Both()


@pytest.mark.parametrize("name", VARIANT_QUERIES)
@pytest.mark.parametrize("switch", SWITCHES)
def test_switched_off_op_converts_as_the_reference(name, switch, catalog):
    with _scoped({f"auron.enable.{switch}": False}):
        assert_same_conversion(queries.build(name, catalog))


@pytest.mark.parametrize("name", VARIANT_QUERIES)
def test_forced_shuffled_hash_join_converts_as_the_reference(name, catalog):
    with _scoped({"auron.force.shuffled.hash.join": True}):
        assert_same_conversion(queries.build(name, catalog))


def test_variants_make_foreign_sections(catalog):
    """The switches do reach the corpus: with the window off, q65w's
    window and everything above it stay foreign over a C2N-free native
    exchange; with the parquet scan off, every scan is a foreign
    source under a C2N reader."""
    with _scoped({"auron.enable.window": False}):
        root, ctx = assert_same_conversion(queries.build("q65w", catalog))
    assert isinstance(root, PC.ForeignWrap)
    with _scoped({"auron.enable.parquet.scan": False}):
        root, ctx = assert_same_conversion(queries.build("q13a", catalog))
    assert any(rid.startswith("c2n:") for rid in ctx.sources)


def test_forced_shuffled_hash_join_rewrites_the_sort_merge_join(catalog):
    with _scoped({"auron.force.shuffled.hash.join": True}):
        _, ctx = assert_same_conversion(queries.build("q01", catalog))
    kinds = {n.kind for j in ctx.exchanges.values()
             for n in PC.stage_nodes(j.child)}
    assert "hash_join" in kinds and "sort_merge_join" not in kinds


def test_adjacency_needs_the_cost_model(catalog):
    """The JAX package asks its adaptive cost model; the port has none
    and refuses the scan, naming it."""
    plan = PF.ForeignNode.from_json(
        queries.build("q13a", catalog).to_json())
    with conf.scoped({"auron.adaptive.fuse.adjacency.enable": True}):
        reasons = []
        tags = PS.apply(plan)
        plan.foreach(lambda n: reasons.append(tags.reason(n)))
    assert any(r and "adaptive cost model" in r for r in reasons)


# -- providers ------------------------------------------------------------------

@pytest.fixture
def providers():
    jp, pp = scan_provider(JC), scan_provider(PC)
    JC.register_provider(jp)
    PC.register_provider(pp)
    yield
    JC.unregister_provider(jp)
    PC.unregister_provider(pp)


@pytest.mark.parametrize("name", ("q01", "q13a", "q65w", "q33b"))
def test_provider_claims_scans_alike(name, catalog, providers):
    root, ctx = assert_same_conversion(queries.build(name, catalog))
    scans = [s for s in ctx.sources.values()
             if s.node is not None and s.node.node.op == "FileSourceScanExec"]
    assert scans and len(scans) == len(ctx.sources)
    assert not PC.ext_convert_supported(PF.ForeignNode("ProjectExec"))


def test_unregistered_provider_claims_nothing(catalog):
    p = scan_provider(PC)
    PC.register_provider(p)
    PC.unregister_provider(p)
    PC.unregister_provider(p)
    scan = PF.ForeignNode.from_json(catalog.scan(
        "store", ["s_store_sk"]).to_json())
    assert not PC.ext_convert_supported(scan)


# -- expressions ----------------------------------------------------------------

F64, I64, I32 = JDT.float64(), JDT.int64(), JDT.int32()
STR, BOOL = JDT.string(), JDT.bool_()
STRUCT = JDT.struct((JField("a", I32), JField("b", STR)))


def _col(name, dt):
    return JF.fcol(name, dt)


def sample(name):
    """One foreign expression of the registered name."""
    a, b, s = _col("a", F64), _col("b", F64), _col("s", STR)
    special = {
        "AttributeReference": a,
        "BoundReference": JF.ForeignExpr("BoundReference", value=2,
                                         dtype=I64),
        "Literal": JF.flit(3.5),
        "Alias": JF.falias(a, "x"),
        "ScalarSubquery": JF.ForeignExpr("ScalarSubquery", value=7,
                                         dtype=I64),
        "In": JF.fcall("In", s, JF.flit("x"), JF.flit("y"), negated=True),
        "InSet": JF.fcall("InSet", _col("k", I64), hset=[1, 2, 3]),
        "If": JF.fcall("If", _col("c", BOOL), a, b, dtype=F64),
        "CaseWhen": JF.fcall("CaseWhen", _col("c", BOOL), a,
                             _col("d", BOOL), b, JF.flit(0.0), dtype=F64),
        "Like": JF.fcall("Like", s, JF.flit("a%"), dtype=BOOL),
        "StartsWith": JF.fcall("StartsWith", s, JF.flit("ab"), dtype=BOOL),
        "EndsWith": JF.fcall("EndsWith", s, JF.flit("ab"), dtype=BOOL),
        "Contains": JF.fcall("Contains", s, JF.flit("ab"), dtype=BOOL),
        "Sha2": JF.fcall("Sha2", s, JF.flit(384), dtype=STR),
        "Murmur3Hash": JF.fcall("Murmur3Hash", a, s, seed=7, dtype=I32),
        "XxHash64": JF.fcall("XxHash64", a, seed=9, dtype=I64),
        "GetArrayItem": JF.fcall("GetArrayItem",
                                 _col("arr", JDT.list_(I64)), JF.flit(1),
                                 dtype=I64),
        "GetStructField": JF.ForeignExpr(
            "GetStructField", children=(_col("st", STRUCT),), dtype=I32,
            attrs={"name": "a"}),
        "GetMapValue": JF.fcall("GetMapValue",
                                _col("m", JDT.map_(STR, F64)),
                                JF.flit("k"), dtype=F64),
        "CreateNamedStruct": JF.fcall("CreateNamedStruct", JF.flit("a"),
                                      _col("i", I32), JF.flit("b"), s,
                                      dtype=STRUCT),
        "BloomFilterMightContain": JF.fcall(
            "BloomFilterMightContain", _col("bf", JDT.binary()),
            _col("k", I64), dtype=BOOL),
        "Not": JF.fcall("Not", _col("c", BOOL), dtype=BOOL),
    }
    return special.get(name, JF.fcall(name, a, b, dtype=F64))


def _kinds(node):
    """The IR kinds of a tree, a UDAF's aggregate call as "udaf"."""
    out = {"udaf" if getattr(node, "fn", None) == "udaf" else node.kind}
    for c in node.children_nodes():
        out |= _kinds(c)
    return out


def assert_same_expr(ref_fe, jfn, pfn):
    port_fe = PF.ForeignExpr.from_dict(json.loads(json.dumps(
        ref_fe.to_dict())))
    try:
        ref = jfn(ref_fe)
    except JEC.NotConvertible as e:
        with pytest.raises(PEC.NotConvertible) as got:
            pfn(port_fe)
        assert str(got.value) == str(e)
        return None
    missing = sorted(_kinds(ref) & set(PEC._MISSING))
    if missing:
        with pytest.raises(PEC.NotConvertible,
                           match=f"IR kind {missing[-1]}|IR kind "
                                 f"{missing[0]}"):
            pfn(port_fe)
        return missing
    assert pserde.to_json(pfn(port_fe)) == jserde.to_json(ref)
    return []


def test_registries_are_the_references():
    assert set(PEC._CONVERTERS) == set(JEC._CONVERTERS)
    assert PEC._AGG_FNS == JEC._AGG_FNS
    assert PEC._JOIN_TYPES == JEC._JOIN_TYPES
    assert PEC._SIMPLE_FNS == JEC._SIMPLE_FNS


@pytest.mark.parametrize("name", sorted(JEC._CONVERTERS))
def test_expression_converts_as_the_reference(name):
    fe = sample(name)
    assert_same_expr(fe, JEC.convert_expr_with_fallback,
                     PEC.convert_expr_with_fallback)
    assert_same_expr(fe, JEC.convert_expr, PEC.convert_expr)


def test_missing_kinds_name_their_roadmap_item():
    for name, kind in (("Like", "like"), ("BoundReference",
                                          "bound_reference"),
                       ("CreateNamedStruct", "named_struct")):
        fe = PF.ForeignExpr.from_dict(sample(name).to_dict())
        with pytest.raises(PEC.NotConvertible) as err:
            PEC.convert_expr(fe)
        assert f"IR kind {kind} " in str(err.value)
        assert "ROADMAP Queue 1 item" in str(err.value)


def test_udf_fallback_stays_foreign():
    """An unconvertible node with a pickled evaluator: the JAX package
    wraps it (PyUdfWrapper), the port names the wrapper it lacks; with
    the JAX package's fallback off it refuses too, and the port, which
    has no such switch, still names the wrapper."""
    fe = JF.ForeignExpr("MyUdf", children=(_col("a", F64),), dtype=F64,
                        py_fn=b"pickled")
    assert JEC.convert_expr_with_fallback(fe).kind == "py_udf_wrapper"
    assert_same_expr(fe, JEC.convert_expr_with_fallback,
                     PEC.convert_expr_with_fallback)
    with jconfig.conf.scoped({"auron.udf.fallback.enable": False}):
        with pytest.raises(JEC.NotConvertible):
            JEC.convert_expr_with_fallback(fe)
    with pytest.raises(PEC.NotConvertible, match="IR kind py_udf_wrapper"):
        PEC.convert_expr_with_fallback(
            PF.ForeignExpr.from_dict(fe.to_dict()))


@pytest.mark.parametrize("kv,name", [
    ({"auron.decimal.arith.enable": False}, "Add"),
    ({"auron.decimal.arith.enable": False}, "CheckOverflow"),
    ({"auron.caseconvert.functions.enable": False}, "Lower"),
    ({"auron.datetime.extract.enable": False}, "Hour"),
])
def test_gated_expressions_refuse_alike(kv, name):
    fe = JF.fcall(name, _col("a", JDT.decimal(12, 2)),
                  _col("b", JDT.decimal(12, 2)), dtype=JDT.decimal(13, 2))
    assert_same_expr(fe, JEC.convert_expr, PEC.convert_expr)
    with _scoped(kv):
        with pytest.raises(JEC.NotConvertible):
            JEC.convert_expr(fe)
        assert_same_expr(fe, JEC.convert_expr, PEC.convert_expr)


def _agg(fn, *children, dtype=F64, distinct=False, **attrs):
    return JF.ForeignExpr("AggregateExpression", children=(
        JF.fcall(fn, *children, dtype=dtype, **attrs),),
        attrs={"distinct": distinct})


@pytest.mark.parametrize("fn", sorted(JEC._AGG_FNS) + ["FirstIgnoreNulls",
                                                       "Distinct", "Udaf",
                                                       "Unknown"])
def test_aggregate_converts_as_the_reference(fn):
    a = _col("a", F64)
    fe = {"FirstIgnoreNulls": _agg("First", a, ignore_nulls=True),
          "Distinct": _agg("Sum", a, distinct=True),
          "Udaf": JF.ForeignExpr("AggregateExpression", children=(
              JF.ForeignExpr("MyAgg", children=(a,), dtype=F64,
                             py_fn=b"x"),)),
          "Unknown": _agg("Median", a)}.get(fn) or _agg(fn, a)
    assert_same_expr(fe, JEC.convert_agg_expr, PEC.convert_agg_expr)


@pytest.mark.parametrize("name", sorted(JEC._JOIN_TYPES) + ["Lateral"])
def test_join_type_converts_as_the_reference(name):
    try:
        ref = JEC.convert_join_type(name)
    except JEC.NotConvertible:
        with pytest.raises(PEC.NotConvertible):
            PEC.convert_join_type(name)
        return
    assert PEC.convert_join_type(name) == ref


def test_sort_order_converts_as_the_reference():
    for attrs in ({}, {"asc": False}, {"asc": False, "nulls_first": True}):
        fe = JF.ForeignExpr("SortOrder", children=(_col("a", F64),),
                            attrs=attrs)
        assert_same_expr(fe, JEC.convert_sort_order, PEC.convert_sort_order)
    assert_same_expr(_col("a", F64), JEC.convert_sort_order,
                     PEC.convert_sort_order)


@pytest.mark.parametrize("op,attrs,item", [
    ("GenerateExec", {"generator": JF.fcall("Explode", _col("a", F64)),
                      "generator_output_names": ["x"],
                      "generator_output_types": [F64]}, "Queue 1 item 4"),
    ("DataWritingCommandExec", {"format": "parquet", "output_dir": "/o"},
     "Queue 1 item 13"),
    ("DataWritingCommandExec", {"format": "orc", "output_dir": "/o"},
     "Queue 1 item 13"),
    ("InsertIntoHiveTableExec", {"storage": {"format": "orc",
                                             "location": "/w"}},
     "Queue 1 item 13"),
])
def test_unported_ops_stay_foreign_naming_their_item(op, attrs, item):
    """The JAX package converts these; the port's converter refuses them,
    so the strategy leaves them to the foreign engine."""
    child = JF.ForeignNode("LocalTableScanExec", output=queries.Schema(
        (JField("a", F64),)), attrs={"rows": []})
    ref = JF.ForeignNode(op, children=(child,), output=child.output,
                         attrs=attrs)
    assert JC.dry_run_convertible(ref) is None
    port = PF.ForeignNode.from_json(ref.to_json())
    reason = PC.dry_run_convertible(port)
    assert reason is not None and item in reason
    tags = PS.apply(port)
    assert tags.is_never_convert(port)


def test_the_planner_and_the_session_refuse_file_scans():
    from auron_tpu_torch.ir import plan as PP
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    from auron_tpu_torch.runtime.planner import PhysicalPlanner
    scan = PP.ParquetScan(schema=Schema.of(Field("a", DataType.int64())),
                          file_groups=(PP.FileGroup(paths=("x",)),))
    for node in (scan, PP.OrcScan(schema=scan.schema,
                                  file_groups=scan.file_groups)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            PhysicalPlanner().create_plan(node)
    assert PP.scan_output_schema(PP.ParquetScan(
        schema=Schema.of(Field("a", DataType.int64()),
                         Field("b", DataType.string())),
        projection=(1,), partition_schema=Schema.of(
            Field("p", DataType.int32())))).names() == ("b", "p")
