"""Partial and final aggregation of auron_tpu_torch against auron_tpu on
the same batches: null keys, null values, a group whose values are all
null, staged merges across many batches, and partial-agg skipping."""

import numpy as np
import pytest

from auron_tpu.config import conf as jconf
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.config import conf
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

import torch_parity as TP

PARTIAL_COLS = ("ss_customer_sk", "sum_sales#sum", "cnt_sales#count")


def _run_both(plan, jax_items, port_items):
    data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
    jres = JaxResources()
    jres.put(plan_source(plan), jax_items)
    res = ResourceRegistry()
    res.put(plan_source(plan), port_items)
    port = execute_task_bytes(data, res, device="cpu")
    jax = jax_execute(data, jres)
    return port, jax


def plan_source(plan):
    while not hasattr(plan, "resource_id"):
        plan = plan.child
    return plan.resource_id


@pytest.mark.parametrize("batch_rows", [700, 4096])
def test_partial_agg_matches(batch_rows):
    cols, valid = TP.make_sales(12000, seed=batch_rows, n_keys=400)
    valid[0][::50] = False                   # null keys: one group
    parts = TP.chunks(cols, valid, batch_rows)
    plan = TP.partial_agg(TP.projection(
        JP.FFIReader(schema=TP.SRC_SCHEMA, resource_id="src")))
    port, jax = _run_both(plan, [TP.to_arrow(*p) for p in parts], parts)
    got = port.to_numpy()
    exp = TP.jax_columns(jax.batches, PARTIAL_COLS)
    TP.assert_same_groups(got, exp, float_names=("sum_sales#sum",),
                          names=PARTIAL_COLS[1:])
    rows = TP.keyed_rows(got, "ss_customer_sk", PARTIAL_COLS[1:])
    assert rows[7][0] is None and rows[7][1] == 0    # all-null values
    assert None in rows                              # the null-key group


def _states(n: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 300, n, dtype=np.int64)
    sums = np.round(rng.normal(size=n) * 1e4, 2)
    counts = rng.integers(1, 6, n, dtype=np.int64)
    kv = rng.random(n) > 0.03
    sv = (rng.random(n) > 0.1) & (keys != 11)        # key 11: sums all null
    counts = np.where(sv, counts, 0)
    return [keys, sums, counts], [kv, sv, np.ones(n, bool)]


def test_final_agg_matches():
    cols, valid = _states(9000, seed=1)
    parts = TP.chunks(cols, valid, 1000)
    arrow = [TP.to_arrow(*p, schema=TP.STATE_SCHEMA) for p in parts]
    plan = TP.final_agg(JP.FFIReader(schema=TP.STATE_SCHEMA,
                                     resource_id="states"))
    port, jax = _run_both(plan, arrow, arrow)        # the port reads arrow
    names = ("ss_customer_sk",) + TP.AGG_NAMES
    got = port.to_numpy()
    TP.assert_same_groups(got, TP.jax_columns(jax.batches, names))
    rows = TP.keyed_rows(got, "ss_customer_sk", TP.AGG_NAMES)
    assert rows[11] == (None, 0)
    assert None in rows


def test_partial_agg_skipping_matches():
    """Nearly unique keys above skipping.min.rows: both engines emit what
    they hold and pass the rest through, grouped batch by batch."""
    cols, valid = TP.make_sales(12000, seed=9, n_keys=10**7, null_frac=0.0)
    parts = TP.chunks(cols, valid, 1000)
    plan = TP.partial_agg(TP.projection(
        JP.FFIReader(schema=TP.SRC_SCHEMA, resource_id="src")),
        skipping=True)
    kv = {"auron.partial.agg.skipping.min.rows": 2048}
    with jconf.scoped(kv), conf.scoped(kv):
        port, jax = _run_both(plan, [TP.to_arrow(*p) for p in parts], parts)
    assert port.metrics.get("partial_skipped") == 1
    got = port.to_numpy()
    exp = TP.jax_columns(jax.batches, PARTIAL_COLS)
    assert len(port.batches) > 1
    assert len(got["ss_customer_sk"][0]) == len(exp["ss_customer_sk"][0])

    def rows(c):
        k, kv_ = c["ss_customer_sk"]
        s, sv = c["sum_sales#sum"]
        return sorted(zip(np.where(kv_, k, -1).tolist(),
                          c["cnt_sales#count"][0].tolist(),
                          np.where(sv, s, np.nan).tolist(), sv.tolist()))
    for g, e in zip(rows(got), rows(exp)):
        assert g[:2] == e[:2] and g[3] == e[3]
        assert (np.isnan(g[2]) and np.isnan(e[2])) or \
            abs(g[2] - e[2]) <= 1e-9 * abs(e[2])


def test_partial_agg_below_ratio_does_not_skip():
    cols, valid = TP.make_sales(6000, seed=2, n_keys=100)
    parts = TP.chunks(cols, valid, 1000)
    plan = TP.partial_agg(TP.projection(
        JP.FFIReader(schema=TP.SRC_SCHEMA, resource_id="src")),
        skipping=True)
    kv = {"auron.partial.agg.skipping.min.rows": 2048}
    with conf.scoped(kv):
        res = ResourceRegistry()
        res.put("src", parts)
        out = execute_task_bytes(jserde.serialize(
            JP.TaskDefinition(plan=plan), codec="zlib"), res, device="cpu")
    assert "partial_skipped" not in out.metrics
    assert len(out.batches) == 1
