"""The joins of auron_tpu_torch against auron_tpu on the CPU.

- The kernel: `join_key_hash`, the build sort (`sorted_hashes`, `perm`),
  `probe_ranges`, `expand_pairs` and `verify_pairs` bit for bit against
  the JAX package's, on seeded keys of every flat type with 10% nulls,
  one and two keys, under both build-sort strategies.  The port holds
  the u64 hash words with the top bit flipped; the comparison undoes
  the flip.  Float keys here hold -0.0, 0.0 and the infinities but no
  NaN, whose hash and equality differ by design (below).
- Every join type through BroadcastJoin (with its build-map stage),
  HashJoin (build left and build right) and SortMergeJoin (streaming and
  whole-side), as the same serialized TaskDefinition bytes in both
  engines, small batches so that a probe batch spans several pair
  chunks and the merge several windows: the rows in the same order as
  the reference's (`compare_tables(ordered=True)`, floats to relative
  1e-12), and as a plain-Python join computes them (unordered).
- An empty build side, all-null keys, one build per broadcast cache id
  across the tasks of a stage.
- Float64 keys with -0.0, 0.0 and NaNs of both signs and payloads
  through the merge's frontier and through equality, held to Spark's
  join (-0.0 joins 0.0, NaN joins NaN); the JAX package joins no NaN
  key (ROADMAP Queue 3 item 15).
- A string join key, which joins as the reference's; NotImplementedError
  for the `partitioned` probe strategy and the merge's giant-group
  escape.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu import config as jconfig
from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.it import compare
from auron_tpu.ops.joins import kernel as JK
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.columnar.batch import from_numpy
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId
from auron_tpu_torch.ops.joins import exec as PX
from auron_tpu_torch.ops.joins import kernel as PK
from auron_tpu_torch.ops.radix_sort import SIGN64
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

FLOAT_REL = 1e-12        # payloads are copied, never computed: exact
CAP = 1024               # batch capacity of the kernel-level tests


def _port_schema(js):
    return Schema(tuple(Field(f.name, DataType(TypeId[f.dtype.id.name]),
                              f.nullable) for f in js.fields))


def _unflip(h: torch.Tensor) -> np.ndarray:
    return (h ^ SIGN64).numpy().view(np.uint64)


def _keys(rng, t: str, n: int, span: int):
    """n keys of type t over a domain of about 2 x span values (so keys
    repeat and match), -0.0 and the infinities among the floats."""
    if t == "bool":
        return rng.integers(0, 2, n).astype(bool)
    if t == "float64":
        pool = np.array([-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf] +
                        list(np.arange(40) * 0.75))
        return pool[rng.integers(0, min(len(pool), 2 * span), n)]
    dt = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
          "date32": np.int32, "int64": np.int64,
          "timestamp_us": np.int64}[t]
    return rng.integers(-span, span, n).astype(dt)


def _jtype(t):
    return getattr(JDT, "bool_" if t == "bool" else t)()


KEY_TYPES = [("bool",), ("int8",), ("int16",), ("int32",), ("date32",),
             ("int64",), ("timestamp_us",), ("float64",),
             ("int64", "int32"), ("float64", "date32", "int8")]


def _batches(types, seed, n):
    rng = np.random.default_rng(seed)
    span = 30 if len(types) == 1 else 3
    arrays = [_keys(rng, t, n, span) for t in types]
    valid = [rng.random(n) >= 0.1 for _ in types]
    js = JS.of(*(JF(f"k{i}", _jtype(t)) for i, t in enumerate(types)))
    return (JBatch.from_numpy(js, arrays, valid, capacity=CAP),
            from_numpy(_port_schema(js), arrays, valid, device="cpu",
                       capacity=CAP))


@pytest.mark.parametrize("strategy", ["argsort", "radix"])
@pytest.mark.parametrize("types", KEY_TYPES, ids="-".join)
def test_kernel_is_bit_exact(types, strategy):
    jb, pb = _batches(types, 1, 700)
    jp, pp = _batches(types, 2, 900)
    with jconfig.conf.scoped({"auron.kernel.sort.strategy": strategy}), \
            conf.scoped({"auron.kernel.sort.strategy": strategy}):
        jt = JK.BuildTable.build(jb, jb.columns)
        pt = PK.BuildTable.build(pb, pb.columns)
    jh, jv = JK.join_key_hash(jb.columns, CAP)
    ph, pv = PK.join_key_hash(pb.columns)
    np.testing.assert_array_equal(_unflip(ph), np.asarray(jh))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_unflip(pt.sorted_hashes),
                                  np.asarray(jt.sorted_hashes))
    np.testing.assert_array_equal(pt.perm.numpy(), np.asarray(jt.perm))
    jph, jpv = JK.join_key_hash(jp.columns, CAP)
    pph, ppv = PK.join_key_hash(pp.columns)
    live = torch.arange(CAP) < pp.num_rows
    jlo, jc = JK.probe_ranges(jt.sorted_hashes, jph, jpv, jp.row_mask())
    plo, pc = PK.probe_ranges(pt.sorted_hashes, pph, ppv, live)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    total = int(pc.sum())
    assert total > CAP          # the pairs span several chunks
    for start in range(0, total, CAP):
        jpi, joff, jlive = JK.expand_pairs(jlo, jc, start, CAP)
        ppi, poff, plive = PK.expand_pairs(plo, pc, start, CAP)
        np.testing.assert_array_equal(ppi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
        np.testing.assert_array_equal(plive.numpy(), np.asarray(jlive))
        pbi = pt.perm[torch.clamp(plo[ppi] + poff, 0, CAP - 1)]
        jbi = np.asarray(jt.perm)[np.clip(np.asarray(jlo)[np.asarray(jpi)]
                                          + np.asarray(joff), 0, CAP - 1)]
        ok = PK.verify_pairs(pp.columns, pt.key_cols, ppi, pbi, plive)
        jok = JK.verify_pairs(jp.columns, jt.key_cols, jpi, jbi, jlive)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_compaction_and_matched_flags():
    mask = torch.tensor([False, True, True, False, True])
    idx, n = PK.compact_padded(mask, 5)
    assert int(n) == 3 and idx[:3].tolist() == [1, 2, 4]
    flags = PK.mark_matched(torch.zeros(4, dtype=torch.bool),
                            torch.tensor([2, 2, 0, 2, 3]),
                            torch.tensor([False, True, False, False, False]))
    assert flags.tolist() == [False, False, True, False]


# -- the operators through TaskDefinition bytes -------------------------------

I64, I32, STR = JDT.int64(), JDT.int32(), JDT.string()
JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti",
              "right_semi", "right_anti", "existence"]
OPS = ["broadcast", "hash_right", "hash_left", "smj", "smj_whole"]
# small batches: the merge runs many windows, and a probe batch of 500
# rows spans two chunks of bucket_capacity(256) = 1,024 pairs
SMALL = {"auron.batch.size": 256}


def _sides(key_type=I64):
    left = JS.of(JF("lk", key_type), JF("lv", I32), JF("ls", STR))
    right = JS.of(JF("rk", key_type), JF("rv", I64), JF("rs", STR))
    return left, right


# the sides a broadcast join may build on, by join type (the JAX
# package's plan verifier, runtime/adaptive.py::_BCAST_SAFE_TYPES): the
# other types would emit the build side's unmatched rows in every task
BROADCAST_RIGHT = ("inner", "left", "left_semi", "left_anti", "existence")
BROADCAST_LEFT = ("right", "right_semi", "right_anti")


def _build_side(op, jt):
    if op == "hash_left" or (op == "broadcast" and jt in BROADCAST_LEFT) \
            or (op.startswith("smj") and jt in ("right_semi", "right_anti")):
        return "left"
    return "right"


def _valid(op, jt):
    if op == "broadcast":
        return jt != "full"
    if _build_side(op, jt) == "left":
        return jt not in ("left_semi", "left_anti", "existence")
    return op.startswith("smj") or jt not in ("right_semi", "right_anti")


CASES = [(op, jt) for op in OPS for jt in JOIN_TYPES if _valid(op, jt)]


def join_plan(op, jt, key_type=I64, cache_id="bhm:t:1"):
    ls, rs = _sides(key_type)
    left = JP.FFIReader(schema=ls, resource_id="left")
    right = JP.FFIReader(schema=rs, resource_id="right")
    on = JP.JoinOn(left_keys=(JE.col("lk"),), right_keys=(JE.col("rk"),))
    side = _build_side(op, jt)
    if op == "broadcast":
        bhm = JP.BroadcastJoinBuildHashMap(
            child=left if side == "left" else right,
            keys=on.left_keys if side == "left" else on.right_keys,
            cache_id=cache_id)
        left, right = (bhm, right) if side == "left" else (left, bhm)
        return JP.BroadcastJoin(left=left, right=right, on=on, join_type=jt,
                                broadcast_side=side,
                                cached_build_hash_map_id=cache_id)
    if op.startswith("hash"):
        return JP.HashJoin(left=left, right=right, on=on, join_type=jt,
                           build_side=side)
    return JP.SortMergeJoin(
        left=JP.Sort(child=left, sort_exprs=(JE.SortExpr(child=JE.col("lk")),)),
        right=JP.Sort(child=right,
                      sort_exprs=(JE.SortExpr(child=JE.col("rk")),)),
        on=on, join_type=jt, sort_options=((True, True),))


def _side_rows(seed, n, n_keys, null_frac=0.05, key_pool=None):
    """(keys, key validity, int payload, string payload): keys over
    n_keys values with duplicates (some past the other side's range, so
    they match nothing), a few nulls in every column."""
    rng = np.random.default_rng(seed)
    if key_pool is None:
        k = rng.integers(0, n_keys, n).astype(np.int64)
    else:
        k = key_pool[rng.integers(0, len(key_pool), n)]
    kv = rng.random(n) >= null_frac
    v = rng.integers(-1000, 1000, n)
    s = np.array([f"s{int(x) % 37}" * (1 + int(x) % 3) for x in v],
                 dtype=object)
    return k, kv, v, s, rng.random(n) >= null_frac


def _records(schema, cols, size):
    """Record batches of `size` rows."""
    k, kv, v, s, vv = cols
    n = len(k)
    arrays = [pa.array(k, type=to_arrow_type(schema[0].dtype), mask=~kv),
              pa.array(v, type=to_arrow_type(schema[1].dtype), mask=~vv),
              pa.array(list(s), type=pa.string(), mask=~vv)]
    t = pa.Table.from_arrays(arrays, names=list(schema.names()))
    return [rb for rb in t.to_batches(max_chunksize=size)] if n else []


def _port_table(results, schema):
    from test_torch_corpus_stages import _Port
    return _Port.table(results, schema)


def run_join(plan, left_rbs, right_rbs, extra_conf=None, tasks=1):
    """The plan through both engines, `tasks` tasks sharing one resource
    registry per engine (the broadcast cache), the same record batches
    to each.  Returns (port table, JAX table)."""
    data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
    kv = dict(SMALL, **(extra_conf or {}))
    jres, res = JaxResources(), ResourceRegistry()
    port_out, jax_out = [], []
    with jconfig.conf.scoped(kv), conf.scoped(kv):
        for _ in range(tasks):
            for r in (jres, res):
                r.put("left", list(left_rbs))
                r.put("right", list(right_rbs))
            port_out.append(execute_task_bytes(data, res, device="cpu"))
            jax_out.append(jax_execute(data, jres))
    port = _port_table(port_out, _schema_of(plan))
    ref = [b for r in jax_out for b in r.batches]
    return port, pa.Table.from_batches(ref) if ref else port.slice(0, 0)


def _schema_of(plan):
    from auron_tpu.runtime.planner import PhysicalPlanner as JaxPlanner
    return JaxPlanner().create_plan(plan).schema


def oracle_join(jt, left: pa.Table, right: pa.Table, spark_floats=True):
    """Plain-Python join of two tables on column 0 of each: rows as
    tuples; a null key matches nothing; with spark_floats, -0.0 joins
    0.0 and NaN joins NaN."""
    def norm(k):
        if k is None:
            return None
        if isinstance(k, float) and spark_floats:
            return "nan" if k != k else k + 0.0
        return k
    L, R = left.to_pylist(), right.to_pylist()
    lk, rk = left.column_names[0], right.column_names[0]
    index = {}
    for j, r in enumerate(R):
        if norm(r[rk]) is not None:
            index.setdefault(norm(r[rk]), []).append(j)
    lnull = (None,) * len(left.column_names)
    rnull = (None,) * len(right.column_names)
    out, matched_r = [], set()
    for r in L:
        hits = index.get(norm(r[lk]), []) if norm(r[lk]) is not None else []
        lt = tuple(r.values())
        if jt in ("inner", "left", "right", "full"):
            for j in hits:
                out.append(lt + tuple(R[j].values()))
            if not hits and jt in ("left", "full"):
                out.append(lt + rnull)
        elif jt == "left_semi" and hits or jt == "left_anti" and not hits:
            out.append(lt)
        elif jt == "existence":
            out.append(lt + (bool(hits),))
        matched_r.update(hits)
    if jt in ("right", "full"):
        out += [lnull + tuple(R[j].values()) for j in range(len(R))
                if j not in matched_r]
    if jt in ("right_semi", "right_anti"):
        out += [tuple(R[j].values()) for j in range(len(R))
                if (j in matched_r) == (jt == "right_semi")]
    return out


def _assert_oracle(port, jt, left_rbs, right_rbs, ls, rs):
    def table(rbs, schema):
        return pa.Table.from_batches(rbs) if rbs else \
            pa.Table.from_pylist([], schema=pa.schema(
                [(f.name, to_arrow_type(f.dtype)) for f in schema.fields]))
    exp = oracle_join(jt, table(left_rbs, ls), table(right_rbs, rs))
    # values by repr: every NaN reads "nan", -0.0 stays apart from 0.0
    got = sorted(tuple(map(repr, r.values())) for r in port.to_pylist())
    assert got == sorted(tuple(map(repr, r)) for r in exp)
    return len(exp)


def _default_sides():
    ls, rs = _sides()
    left = _side_rows(10, 1500, 300)
    right = _side_rows(11, 1200, 260)
    return ls, rs, _records(ls, left, 500), _records(rs, right, 400)


@pytest.mark.parametrize("op,jt", CASES)
def test_join_matches_reference_and_oracle(op, jt):
    ls, rs, left_rbs, right_rbs = _default_sides()
    extra = {"auron.smj.streaming.enable": op != "smj_whole"}
    port, ref = run_join(join_plan(op, jt), left_rbs, right_rbs, extra)
    assert compare.compare_tables(port, ref, rel_tol=FLOAT_REL, abs_tol=0,
                                  ordered=True) is None
    assert _assert_oracle(port, jt, left_rbs, right_rbs, ls, rs) > 0


def test_probe_batches_span_several_chunks(monkeypatch):
    """An inner hash join whose probe batches each give more pairs than a
    chunk holds: the chunks, counted, and the rows as the reference's."""
    ls, rs, left_rbs, right_rbs = _default_sides()
    chunks = []
    real = PK.pair_chunk
    monkeypatch.setattr(PX, "pair_chunk",
                        lambda *a, **k: chunks.append(k["is_final"]) or
                        real(*a, **k))
    port, ref = run_join(join_plan("hash_right", "inner"), left_rbs,
                         right_rbs)
    assert compare.compare_tables(port, ref, ordered=True) is None
    # 3 probe batches of 500 rows, 1,100-2,048 pairs each, chunks of
    # 1,024: two chunks a batch
    assert len(chunks) == 2 * 3 and port.num_rows > 3 * 1024


EMPTY_CASES = [(op, jt) for op in OPS
               for jt in ("inner", "left", "full", "left_anti", "existence")
               if _valid(op, jt)]


@pytest.mark.parametrize("op,jt", EMPTY_CASES)
def test_empty_right_side(op, jt):
    """No right rows: the build side of every operator but hash_left,
    whose probe side it is."""
    ls, rs, left_rbs, _ = _default_sides()
    port, ref = run_join(join_plan(op, jt), left_rbs, [],
                         {"auron.smj.streaming.enable": op != "smj_whole"})
    assert compare.compare_tables(port, ref, ordered=True) is None
    _assert_oracle(port, jt, left_rbs, [], ls, rs)


@pytest.mark.parametrize("op", ["broadcast", "hash_right", "smj"])
def test_all_null_keys(op):
    ls, rs = _sides()
    left = _records(ls, _side_rows(12, 700, 50, null_frac=1.0), 300)
    right = _records(rs, _side_rows(13, 600, 50), 300)
    for jt in ("inner", "full", "left_anti"):
        if not _valid(op, jt):
            continue
        port, ref = run_join(join_plan(op, jt), left, right)
        assert compare.compare_tables(port, ref, ordered=True) is None
        n = _assert_oracle(port, jt, left, right, ls, rs)
        assert n == {"inner": 0, "full": 1300, "left_anti": 700}[jt]


def test_broadcast_builds_once_per_cache_id(monkeypatch):
    """Four tasks of a broadcast stage sharing the device's registry
    build the table once; the JAX package builds it twice on the first
    task (the build-map stage, then the join again)."""
    builds = []
    real = PK.BuildTable.build
    monkeypatch.setattr(PK.BuildTable, "build", staticmethod(
        lambda *a, **k: builds.append(1) or real(*a, **k)))
    ls, rs, left_rbs, right_rbs = _default_sides()
    port, ref = run_join(join_plan("broadcast", "inner"), left_rbs,
                         right_rbs, tasks=4)
    assert len(builds) == 1
    assert compare.compare_tables(port, ref, ordered=True) is None


# -- float keys: Spark's equality, the merge's frontier -----------------------

NAN_NEG = np.frombuffer(np.uint64(0xFFF8000000000000).tobytes(), np.float64)[0]
NAN_PAYLOAD = np.frombuffer(np.uint64(0x7FF8000000000001).tobytes(),
                            np.float64)[0]
FLOAT_POOL = np.array([-0.0, 0.0, np.nan, NAN_NEG, NAN_PAYLOAD, 1.0, -1.0,
                       np.inf, -np.inf, 2.5])


def _float_sides():
    ls, rs = _sides(JDT.float64())
    left = _records(ls, _side_rows(20, 900, 0, key_pool=FLOAT_POOL), 200)
    right = _records(rs, _side_rows(21, 700, 0, key_pool=FLOAT_POOL), 200)
    return ls, rs, left, right


def _port_only(plan, left, right, extra=None):
    data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
    res = ResourceRegistry()
    res.put("left", left)
    res.put("right", right)
    with conf.scoped(dict(SMALL, **(extra or {}))):
        out = execute_task_bytes(data, res, device="cpu")
    return _port_table([out], _schema_of(plan))


@pytest.mark.parametrize("op", ["smj", "smj_whole", "hash_right",
                                "broadcast"])
@pytest.mark.parametrize("jt", ["inner", "full", "left_semi"])
def test_float_keys_join_as_spark(op, jt):
    """-0.0 joins 0.0 and every NaN joins every NaN, through the merge's
    frontier (small batches: many windows, key groups across batches)
    and through the hash path; the streaming merge equals the whole-side
    join."""
    ls, rs, left, right = _float_sides()
    port = _port_only(join_plan(op, jt, JDT.float64()), left, right,
                      {"auron.smj.streaming.enable": op != "smj_whole"})
    _assert_oracle(port, jt, left, right, ls, rs)
    if op == "smj":
        whole = _port_only(join_plan("smj", jt, JDT.float64()), left, right,
                           {"auron.smj.streaming.enable": False})
        assert compare.compare_tables(port, whole, ordered=False) is None


def test_reference_joins_no_nan_key():
    """ROADMAP Queue 3 item 15: the JAX package's `verify_pairs` compares
    keys with `==` and its hash keeps a NaN's bits, so no NaN key joins;
    Spark (and the port) join NaN to NaN."""
    ls, rs, left, right = _float_sides()
    plan = join_plan("hash_right", "inner", JDT.float64())
    port, ref = run_join(plan, left, right)
    nan = lambda t: sum(1 for x in t.column("lk").to_pylist()  # noqa: E731
                        if x is not None and x != x)
    assert nan(ref) == 0 and nan(port) > 0
    zeros = lambda t: sorted({(repr(a), repr(b)) for a, b in zip(  # noqa: E731
        t.column("lk").to_pylist(), t.column("rk").to_pylist())
        if a == 0.0})
    # -0.0 joins 0.0 in both
    assert len(zeros(port)) == 4 and zeros(port) == zeros(ref)


# -- what the port refuses ----------------------------------------------------

def test_string_join_key_is_refused():
    """A string key was refused until `string_eq` came to the port; it
    now joins as the reference does (tests/test_torch_string_compare.py
    holds every join type and width)."""
    from auron_tpu_torch.ir import serde
    ls, rs, left_rbs, right_rbs = _default_sides()
    plan = dataclasses.replace(
        join_plan("hash_right", "inner"),
        on=JP.JoinOn(left_keys=(JE.col("ls"),), right_keys=(JE.col("rs"),)))
    data = jserde.serialize(JP.TaskDefinition(plan=plan))
    assert serde.deserialize(data).plan.on.left_keys[0].name == "ls"
    port, ref = run_join(plan, left_rbs, right_rbs)
    assert port.num_rows > 0
    assert compare.compare_tables(port, ref, ordered=True) is None


def test_partitioned_probe_is_refused():
    ls, rs, left_rbs, right_rbs = _default_sides()
    with pytest.raises(NotImplementedError, match="partitioned probe"):
        _port_only(join_plan("hash_right", "inner"), left_rbs, right_rbs,
                   {"auron.kernel.join.probe.strategy": "partitioned"})


def test_giant_group_escape_is_refused():
    """A merge window past auron.smj.window.max.rows under one key."""
    ls, rs = _sides()
    one = np.array([7], np.int64)
    left = _records(ls, _side_rows(30, 300, 0, 0.0, key_pool=one), 100)
    right = _records(rs, _side_rows(31, 600, 0, 0.0, key_pool=one), 100)
    with pytest.raises(NotImplementedError, match="_join_giant_group"):
        _port_only(join_plan("smj", "inner"), left, right,
                   {"auron.smj.window.max.rows": 500})
    # under the cap the same rows join whole: 300 x 600 pairs
    assert _port_only(join_plan("smj", "inner"), left,
                      right).num_rows == 180_000
