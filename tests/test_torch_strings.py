"""String and binary columns, auron_tpu_torch against auron_tpu on the
same seeded inputs, bit for bit: the numpy import of `from_numpy` (no
pyarrow) against the JAX package's `Batch.from_numpy` (through pyarrow),
the `to_numpy` round trip, Spark's string hash (`hash_bytes`,
`hash_columns`) at every length 0-40 and at widths 8-64, the string sort
words and their order under both of the port's sort forms, and a value
longer than `auron.string.device.max.width`, which raises."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu.columnar.batch import Batch as JBatch
from auron_tpu.columnar.batch import DeviceStringColumn as JStr
from auron_tpu.config import conf as jconf
from auron_tpu.exprs import hashing as JH
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ops import sort_keys as JK
from auron_tpu_torch.columnar.batch import (
    DeviceStringColumn, bucket_width, column_to_numpy, from_numpy,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops import sort_keys as SK
from torch_parity import run_both

WIDTHS = (8, 16, 32, 64)
EDGE = ["", "ab", "ab\x00", "\x00", "é", "ÿþ", "日本語",
        "a" * 8, "a" * 9, "zz", "Z", "\x7f", "\x80x"]


def _random_strings(rng, n, max_len=40):
    """n strings of 0..max_len characters: ASCII, NUL and non-ASCII code
    points (UTF-8 lead bytes >= 0x80), cut to max_len bytes."""
    alphabet = ["a", "b", "A", "~", "\x00", "é", "ß", "€", "日", "\U0001f600"]
    out = []
    for _ in range(n):
        s = "".join(rng.choice(alphabet, rng.integers(0, max_len + 1)))
        while len(s.encode()) > max_len:
            s = s[:-1]
        out.append(s)
    return out


def _objects(values):
    a = np.empty(len(values), dtype=object)
    a[:] = values
    return a


def _string_inputs(seed, n=400, kind="string"):
    rng = np.random.default_rng(seed)
    vals = EDGE + _random_strings(rng, n - len(EDGE))
    if kind == "binary":
        vals = [v.encode() for v in vals]
    valid = rng.random(n) >= 0.15
    valid[:len(EDGE)] = True
    return _objects(vals), valid


@pytest.mark.parametrize("kind", ["string", "binary"])
def test_import_matches_the_reference(kind):
    """bytes, lengths and validity of the numpy import equal the JAX
    package's arrow import, the empty string, `"ab\\x00"`, non-ASCII and
    nulls among the values; null rows hold zero bytes and length 0."""
    vals, valid = _string_inputs(1, kind=kind)
    dt = DataType.string() if kind == "string" else DataType.binary()
    jdt = JDT.string() if kind == "string" else JDT.binary()
    port = from_numpy(Schema.of(Field("s", dt)), [vals], [valid],
                      device="cpu").columns[0]
    ref = JBatch.from_numpy(JS.of(JF("s", jdt)), [vals], [valid]).columns[0]
    assert isinstance(port, DeviceStringColumn) and isinstance(ref, JStr)
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(port.validity.numpy(),
                                  np.asarray(ref.validity))
    assert port.lengths[1] == 2 and port.lengths[2] == 3     # "ab\x00"
    assert int(port.lengths[~port.validity].abs().sum()) == 0
    assert int(port.data[~port.validity].sum()) == 0


@pytest.mark.parametrize("kind", ["string", "binary"])
def test_to_numpy_round_trips(kind):
    vals, valid = _string_inputs(2, kind=kind)
    dt = DataType.string() if kind == "string" else DataType.binary()
    b = from_numpy(Schema.of(Field("s", dt)), [vals], [valid], device="cpu")
    [got], [gv] = b.to_numpy()
    np.testing.assert_array_equal(gv, valid)
    empty = "" if kind == "string" else b""
    assert list(got) == [v if ok else empty for v, ok in zip(vals, valid)]
    assert all(type(v) is (str if kind == "string" else bytes) for v in got)


def test_import_takes_none_as_null():
    vals = _objects(["x", None, "yz"])
    b = from_numpy(Schema.of(Field("s", DataType.string())), [vals],
                   device="cpu")
    assert b.columns[0].validity[:3].tolist() == [True, False, True]
    assert b.columns[0].lengths[:3].tolist() == [1, 0, 2]


def test_width_is_the_bucket_of_the_longest_value():
    for longest, w in ((0, 8), (1, 8), (8, 8), (9, 16), (40, 64),
                       (256, 256)):
        vals = _objects(["a" * longest, "b"])
        b = from_numpy(Schema.of(Field("s", DataType.string())), [vals],
                       device="cpu")
        assert b.columns[0].width == w == bucket_width(max(longest, 1))


def test_a_string_longer_than_the_maximum_width_raises():
    vals = _objects(["a", "x" * 257])
    with pytest.raises(NotImplementedError, match="max.width"):
        from_numpy(Schema.of(Field("s", DataType.string())), [vals],
                   device="cpu")
    with conf.scoped({"auron.string.device.max.width": 16}):
        with pytest.raises(NotImplementedError, match="HostColumn"):
            from_numpy(Schema.of(Field("s", DataType.string())),
                       [_objects(["y" * 17])], device="cpu")
    # past the widest bucket a value would be cut: it raises too
    with conf.scoped({"auron.string.width.buckets": "8,16"}):
        with pytest.raises(NotImplementedError, match="bucket"):
            from_numpy(Schema.of(Field("s", DataType.string())),
                       [_objects(["z" * 17])], device="cpu")


def _matrix(rows, w):
    """rows of bytes as a zero-padded uint8[n, w] matrix and lengths."""
    mat = np.zeros((len(rows), w), np.uint8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = np.frombuffer(r, np.uint8)
    return mat, np.array([len(r) for r in rows], np.int32)


@pytest.mark.parametrize("w", WIDTHS)
def test_hash_bytes_matches_the_reference(w):
    """Every length 0..min(w, 40), random bytes (half of them >= 0x80, so
    the signed tail bytes matter), seeds of 32 random bits."""
    rng = np.random.default_rng(w)
    rows = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in range(min(w, 40) + 1) for _ in range(6)]
    mat, lens = _matrix(rows, w)
    seed = rng.integers(0, 1 << 32, len(rows), dtype=np.uint64)
    got = H.hash_bytes(torch.from_numpy(mat), torch.from_numpy(lens),
                       torch.from_numpy(seed.astype(np.int64)))
    exp = JH.hash_bytes(jnp.asarray(mat), jnp.asarray(lens),
                        jnp.asarray(seed.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(exp).astype(np.int64))


def test_hash_does_not_depend_on_the_width():
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in range(9)]
    seed = torch.full((len(rows),), 42, dtype=torch.int64)
    outs = [H.hash_bytes(*map(torch.from_numpy, _matrix(rows, w)), seed)
            for w in WIDTHS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_spark_docs_hash_example():
    """Spark's documentation of `hash`: `hash('Spark', array(123), 2)` is
    -1321691492.  An array hashes its elements into the running seed, so
    a one-element array hashes as its element: an int32 column."""
    b = from_numpy(Schema.of(Field("s", DataType.string()),
                             Field("a", DataType.int32()),
                             Field("b", DataType.int32())),
                   [_objects(["Spark"]), np.array([123], np.int32),
                    np.array([2], np.int32)], device="cpu")
    assert H.hash_columns(b.columns)[0].item() == -1321691492


@pytest.mark.parametrize("kind", ["string", "binary"])
def test_hash_columns_match_the_reference(kind):
    """A string key chained with an int64 key, nulls keeping the seed."""
    vals, valid = _string_inputs(3, kind=kind)
    rng = np.random.default_rng(3)
    ints = rng.integers(-5, 5, len(vals), dtype=np.int64)
    iv = rng.random(len(vals)) >= 0.1
    dt = DataType.string() if kind == "string" else DataType.binary()
    jdt = JDT.string() if kind == "string" else JDT.binary()
    port = from_numpy(Schema.of(Field("s", dt), Field("i", DataType.int64())),
                      [vals, ints], [valid, iv], device="cpu")
    ref = JBatch.from_numpy(JS.of(JF("s", jdt), JF("i", JDT.int64())),
                            [vals, ints], [valid, iv])
    for order in ((0, 1), (1, 0), (0,)):
        got = H.hash_columns([port.columns[i] for i in order])
        exp = JH.hash_columns([ref.columns[i] for i in order])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(exp).view(np.int32))


def _as_port_word(w):
    a = np.asarray(w)
    if a.dtype == np.uint64:
        return (a ^ np.uint64(1 << 63)).view(np.int64)
    return a.astype(np.int64)


def _key_columns(seed, n=500, w=None):
    """A string key with many ties (a few distinct values, prefixes of
    each other, trailing NULs, non-ASCII) in both engines; `w` widens the
    port's matrix past its bucket."""
    rng = np.random.default_rng(seed)
    pool = EDGE + _random_strings(rng, 20, max_len=20)
    vals = _objects([pool[i] for i in rng.integers(0, len(pool), n)])
    valid = rng.random(n) >= 0.2
    port = from_numpy(Schema.of(Field("s", DataType.string())), [vals],
                      [valid], device="cpu").columns[0]
    ref = JBatch.from_numpy(JS.of(JF("s", JDT.string())), [vals],
                            [valid]).columns[0]
    if w is not None:
        port = DeviceStringColumn(port.dtype, port.widened(w), port.lengths,
                                  port.validity)
        ref = JStr(ref.dtype, jnp.pad(ref.data,
                                      ((0, 0), (0, w - ref.data.shape[1]))),
                   ref.lengths, ref.validity)
    return port, ref, vals, valid


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("asc", [True, False])
def test_string_words_match_the_reference(asc, nulls_first):
    port, ref, _, _ = _key_columns(7)
    got = SK.encode_key_column(port, asc, nulls_first)
    exp = JK.encode_key_column(ref, asc, nulls_first)
    assert len(got) == len(exp) == 1 + port.width // 8 + 1
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), _as_port_word(e))
    assert SK.encode_key_column_bits(port) == JK.encode_key_column_bits(ref)


def _spark_order(vals, valid, asc, nulls_first):
    """Python's stable sort of the rows by UTF-8 bytes (Spark's binary
    string order), nulls placed as asked."""
    def key(i):
        if not valid[i]:
            return (0 if nulls_first else 2,)
        return (1, vals[i].encode())
    idx = sorted(range(len(vals)), key=key)
    if not asc:         # descending values, nulls where asked, stable
        nulls = [i for i in idx if not valid[i]]
        live = sorted((i for i in idx if valid[i]),
                      key=lambda i: vals[i].encode(), reverse=True)
        # reverse=True keeps equal keys in input order
        idx = nulls + live if nulls_first else live + nulls
    return idx


@pytest.mark.parametrize("strategy", ["radix", "argsort"])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("w", [None, 64])
def test_string_order_matches_the_reference(strategy, asc, nulls_first, w):
    """The port's permutation under each sort form equals the JAX
    package's and Spark's binary order (Python's sort of the bytes)."""
    port, ref, vals, valid = _key_columns(11, w=w)
    n = len(vals)
    kv = {"auron.kernel.sort.strategy": strategy}
    order = [(asc, nulls_first)]
    with conf.scoped(kv), jconf.scoped(kv):
        got = SK.lexsort_indices(SK.encode_sort_keys([port], order), n,
                                 port.capacity,
                                 SK.encode_sort_keys_bits([port]))
        exp = JK.lexsort_indices(JK.encode_sort_keys([ref], order), n,
                                 ref.capacity, JK.encode_sort_keys_bits([ref]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got[:n].tolist() == _spark_order(vals, valid, asc, nulls_first)


def test_non_ascii_sorts_after_ascii():
    """A first byte >= 0x80 sorts after every ASCII byte (unsigned bytes,
    the word's top bit flipped), "ab" before "ab\\x00" before "abc"."""
    vals = _objects(["é", "A", "ab\x00", "ab", "abc", "", "\x7f"])
    b = from_numpy(Schema.of(Field("s", DataType.string())), [vals],
                   device="cpu")
    c = b.columns[0]
    perm = SK.lexsort_indices(SK.encode_sort_keys([c], [(True, True)]),
                              len(vals), c.capacity,
                              SK.encode_sort_keys_bits([c]))
    assert [vals[i] for i in perm[:len(vals)].tolist()] == \
        ["", "A", "ab", "ab\x00", "abc", "\x7f", "é"]


# -- strings through the operators --------------------------------------------

def _string_batches(seed, n_batches=4, n=200):
    """Record batches of (s string, q int32): short and long strings in
    alternate batches (widths 8 and up to 64), nulls in both."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_batches):
        vals = _random_strings(rng, n, max_len=8 if j % 2 == 0 else 40)
        out.append(pa.RecordBatch.from_arrays(
            [pa.array(vals, type=pa.string(), mask=rng.random(n) < 0.1),
             pa.array(rng.integers(0, 100, n).astype(np.int32),
                      type=pa.int32(), mask=rng.random(n) < 0.1)],
            names=["s", "q"]))
    return out


SRC = JS.of(JF("s", JDT.string()), JF("q", JDT.int32()))


def _run(plan, batches):
    port, ref = run_both(plan, batches, batches)
    return (pa.Table.from_batches([b for b in ref.batches]),
            {n: list(port.to_numpy()[n][0]) for n in port.to_numpy()},
            port.to_numpy())


def _column(table, name):
    return table.column(name).to_pylist()


def test_string_case_and_literals_match_the_reference():
    """CASE with string branches, a nested CASE, a null-literal branch
    and a branch passing a string column through; a string literal."""
    s, q = JE.col("s"), JE.col("q")

    def lit(v, t):
        return JE.Literal(value=v, dtype=t)
    band = JE.Case(branches=(
        JE.WhenThen(when=JE.BinaryExpr(left=q, op="<", right=lit(20, JDT.int32())),
                    then=lit("low", JDT.string())),
        JE.WhenThen(when=JE.BinaryExpr(left=q, op="<", right=lit(40, JDT.int32())),
                    then=lit(None, JDT.null())),
        JE.WhenThen(when=JE.BinaryExpr(left=q, op="<", right=lit(60, JDT.int32())),
                    then=s)),
        else_expr=JE.Case(branches=(JE.WhenThen(
            when=JE.BinaryExpr(left=q, op="<", right=lit(80, JDT.int32())),
            then=lit("ab\x00", JDT.string())),),
            else_expr=lit("a much longer literal, past 16", JDT.string())))
    plan = JP.Projection(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        exprs=(band, lit("const", JDT.string()), s, JE.IsNull(child=s)),
        names=("band", "c", "s", "null_s"))
    ref, got, raw = _run(plan, _string_batches(21))
    for name in ("band", "c", "s", "null_s"):
        exp = _column(ref, name)
        valid = raw[name][1]
        assert [v if ok else None for v, ok in zip(got[name], valid)] == exp


@pytest.mark.parametrize("kind", ["binary", "not", "negative", "sc_and",
                                  "in_list", "cast", "case", "CASE"])
def test_other_kinds_over_strings_raise(kind):
    """Raised where the expression is built, before any batch: `binary`
    an arithmetic op of strings, `in_list` a string IN a list of ints,
    `case` with a string condition, `CASE` a string CASE with an int
    branch (a comparison of strings and a string IN string values run
    since string equality came to the port)."""
    from auron_tpu_torch.exprs.compiler import build_evaluator
    from auron_tpu_torch.ir import expr as E
    s, b = E.col("s"), E.col("b")
    one = E.Literal(value=1, dtype=DataType.int32())
    expr = {"binary": E.BinaryExpr(left=s, op="+", right=s),
            "not": E.Not(child=s),
            "negative": E.Negative(child=s),
            "sc_and": E.ScAnd(left=b, right=s),
            "in_list": E.InList(child=s, values=(one,)),
            "cast": E.Cast(child=s, dtype=DataType.int32()),
            "case": E.Case(branches=(E.WhenThen(when=s, then=one),)),
            "CASE": E.Case(branches=(E.WhenThen(when=b, then=s),),
                           else_expr=one)}[kind]
    schema = Schema.of(Field("s", DataType.string()),
                       Field("b", DataType.bool_()))
    with pytest.raises(NotImplementedError, match=kind):
        build_evaluator((E.IsNull(child=expr),), schema)


def test_a_string_literal_is_built_once_per_capacity():
    from auron_tpu_torch.exprs.compiler import build_evaluator
    from auron_tpu_torch.ir import expr as E
    schema = Schema.of(Field("s", DataType.string()))
    ev = build_evaluator((E.Literal(value="ab\x00", dtype=DataType.string()),),
                         schema)

    def batch(n, cap):
        return from_numpy(schema, [_objects(["x"] * n)], device="cpu",
                          capacity=cap)
    [a], [b], [c] = ev(batch(3, 128)), ev(batch(5, 128)), ev(batch(300, 384))
    assert a is b and a.capacity == 128
    assert c is not a and c.capacity == 384
    assert column_to_numpy(c, 300).tolist() == ["ab\x00"] * 300


@pytest.mark.parametrize("fetch,offset", [(None, 0), (50, 0), (30, 15)])
@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
def test_sort_by_string_matches_the_reference(asc, nulls_first, fetch,
                                              offset):
    """SortExec by (s, q) over batches of different widths, the fetch
    limit and offset as the JAX operator applies them."""
    plan = JP.Sort(child=JP.FFIReader(schema=SRC, resource_id="src"),
                   sort_exprs=(JE.SortExpr(child=JE.col("s"), asc=asc,
                                           nulls_first=nulls_first),
                               JE.SortExpr(child=JE.col("q"))),
                   fetch_limit=fetch, fetch_offset=offset)
    ref, got, raw = _run(plan, _string_batches(22))
    for name in ("s", "q"):
        valid = raw[name][1]
        assert [v if ok else None for v, ok in zip(got[name], valid)] == \
            _column(ref, name)


def test_shuffle_blocks_carry_strings_and_count_their_bytes():
    """The writer splits a string column with its rows; its `bytes`
    column counts W + 4 + 1 bytes a string row and 4 + 1 an int32 row;
    the reduce side reads the blocks back unchanged."""
    from auron_tpu.ir import serde as jserde
    from auron_tpu_torch.ops.shuffle.writer import (
        InProcessShuffleService, PartitionedBlocks,
    )
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    batches = _string_batches(23, n_batches=2)
    plan = JP.RssShuffleWriter(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        partitioning=JP.Partitioning(mode="hash", num_partitions=3,
                                     expressions=(JE.col("s"),)),
        rss_resource_id="w")
    svc = InProcessShuffleService()
    res = ResourceRegistry()
    res.put("src", batches)
    res.put("w", svc.rss_writer("x", 0))
    out = execute_task_bytes(jserde.serialize(JP.TaskDefinition(plan=plan)),
                             res, device="cpu").to_numpy()
    widths = [8, 64]                  # the two batches' string widths
    blocks = [svc.reduce_blocks("x", p) for p in range(3)]
    rows = np.zeros(3, np.int64)
    nbytes = np.zeros(3, np.int64)
    for rb, w in zip(batches, widths):
        h = H.hash_columns([from_numpy(
            Schema.of(Field("s", DataType.string())),
            [_objects(rb.column(0).to_pylist())], device="cpu").columns[0]])
        pid = H.pmod(h[:rb.num_rows], 3).numpy()
        for p in range(3):
            rows[p] += (pid == p).sum()
            nbytes[p] += (pid == p).sum() * (w + 4 + 1 + 4 + 1)
    assert out["rows"][0].tolist() == rows.tolist()
    assert out["bytes"][0].tolist() == nbytes.tolist()
    reader = PartitionedBlocks(blocks)
    got = []
    for p in range(3):
        for b in reader.for_partition(p):
            arrays, valids = b.to_numpy()
            got += [v for v, ok in zip(arrays[0], valids[0]) if ok]
    exp = [v for rb in batches for v in rb.column(0).to_pylist()
           if v is not None]
    assert sorted(got) == sorted(exp)


def test_range_partitioning_by_a_string_raises():
    from auron_tpu_torch.ops.shuffle.partitioner import encoded_range_bounds
    with pytest.raises(NotImplementedError, match="range partitioning"):
        encoded_range_bounds([("a",)], [DataType.string()], [(True, True)])


def test_only_count_aggregates_a_string():
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.runtime.planner import PhysicalPlanner
    src = P.FFIReader(schema=Schema.of(Field("s", DataType.string()),
                                       Field("k", DataType.int64())),
                      resource_id="src")

    def agg(fn, out):
        return P.Agg(child=src, exec_mode="single", grouping=(E.col("k"),),
                     grouping_names=("k",),
                     aggs=(E.AggExpr(fn=fn, children=(E.col("s"),),
                                     return_type=out),),
                     agg_names=("a",))
    PhysicalPlanner().create_plan(agg("count", DataType.int64()))
    for fn, out in (("min", DataType.string()), ("max", DataType.string()),
                    ("first", DataType.string()), ("sum", DataType.float64()),
                    ("avg", DataType.float64())):
        with pytest.raises(NotImplementedError):
            PhysicalPlanner().create_plan(agg(fn, out))
