"""TPC-DS q13a, q65w, q27r and q33b whole (string equality, the window,
expand and union) through auron_tpu_torch and auron_tpu on the CPU, and
the plans chip_smoke.py runs for them on the card.

- Each query, converted by the JAX package's converter over
  `it/datagen.py` data at SF 0.01 (seed 7), runs whole in both engines,
  every task as the same serialized TaskDefinition bytes
  (`test_torch_corpus_all.py::run_query`), and both equal the pyarrow
  oracle under `compare_tables(ordered=True)` (relative 1e-4, absolute
  1e-6: float sums and averages in another order).
- Each stage `chip_smoke.join_query_plans` builds for the query in the
  port's IR serializes to the JSON of the stage the converter lowers,
  with each scan an FFIReader of its table and the converter's ids under
  the query's name; q33b's union with the catalog's partitions of each
  channel.
"""

import dataclasses

import pytest

from auron_tpu.ir import plan as JP
from auron_tpu.ir.node import Node as JNode
from auron_tpu.it import compare, datagen, queries
from auron_tpu_torch.ops import kernels_cuda as K

import chip_smoke
from test_torch_corpus_aggs import _oracle_table
from test_torch_corpus_all import run_query
from test_torch_corpus_joins import _JaxE, _PortE, _card_id
from test_torch_corpus_stages import _convert, _jax_json, _port_json
from torch_parity import one_thread  # noqa: F401  (autouse)

SF = 0.01
QUERIES = list(chip_smoke.SLICE9_QUERIES)
# scan tables by column prefix, the longest prefixes first
TABLES = (("ss_", "store_sales"), ("cs_", "catalog_sales"),
          ("ws_", "web_sales"), ("s_", "store"), ("i_", "item"),
          ("d_", "date_dim"))


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_the_reference_and_the_oracle(name, catalog):
    K.reset_launches()
    port = run_query(_PortE, name, catalog)
    ref = run_query(_JaxE, name, catalog)
    orc = _oracle_table(queries.build(name, catalog))
    assert port.num_rows > 0
    assert compare.compare_tables(port, orc, ordered=True) is None
    assert compare.compare_tables(port, ref, ordered=True) is None
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}


def _card_plan(node, name):
    """The converter's plan as the card runs it: each scan an FFIReader
    of its table, each exchange, broadcast and cache id renamed."""
    if isinstance(node, tuple):
        return tuple(_card_plan(x, name) for x in node)
    if not isinstance(node, JNode):
        return node
    if node.kind == "parquet_scan":
        first = node.schema.names()[0]
        table = next(t for p, t in TABLES if first.startswith(p))
        return JP.FFIReader(schema=node.schema, resource_id=table)
    kw = {}
    if node.kind == "ipc_reader":
        kw["resource_id"] = _card_id(node.resource_id, name)
    if node.kind == "broadcast_join":
        kw["cached_build_hash_map_id"] = _card_id(
            node.cached_build_hash_map_id, name)
    if node.kind == "broadcast_join_build_hash_map":
        kw["cache_id"] = _card_id(node.cache_id, name)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, (JNode, tuple)) and f.name not in kw:
            kw[f.name] = _card_plan(v, name)
    return dataclasses.replace(node, **kw) if kw else node


def _parts(root, ctx):
    """Each channel's partitions in the union of q33b's converted plan."""
    def walk(n):
        if isinstance(n, tuple):
            for x in n:
                yield from walk(x)
        elif isinstance(n, JNode):
            yield n
            for f in dataclasses.fields(n):
                yield from walk(getattr(n, f.name))
    plans = [root] + [j.child for j in ctx.exchanges.values()]
    union = next(n for p in plans for n in walk(p) if n.kind == "union")
    out = {}
    for inp in union.inputs:
        scan = next(n for n in walk(inp.child) if n.kind == "parquet_scan")
        table = next(t for p, t in TABLES
                     if scan.schema.names()[0].startswith(p))
        out[table] = out.get(table, 0) + 1
    return out


@pytest.mark.parametrize("name", QUERIES)
def test_chip_smoke_plans_are_the_converters(name, catalog):
    _, root, ctx = _convert(name, catalog)
    parts = _parts(root, ctx) if name == "q33b" else None
    built = chip_smoke.join_query_plans(name, parts)
    want = {}
    for j in ctx.exchanges.values():
        want[_card_id(j.rid, name)] = JP.RssShuffleWriter(
            child=_card_plan(j.child, name), partitioning=j.partitioning,
            rss_resource_id="shuffle_writer")
    for j in ctx.broadcasts.values():
        want[_card_id(j.rid, name)] = _card_plan(j.child, name)
    want["root"] = _card_plan(root, name)
    assert set(built) == set(want)
    for rid, plan in want.items():
        assert _port_json(built[rid]) == _jax_json(plan), rid
