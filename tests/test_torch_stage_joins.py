"""The port's stage executor against the JAX package's on the joins:
every join type each join operator takes on the stage path (broadcast:
inner, left, left semi and anti, existence; shuffled hash and
sort-merge: those and full and right outer), on int64 and on string
keys, over a build side with duplicate keys (a probe row matches up to
three build rows) and nulls on both sides.  The tables, plans and
comparison are test_torch_stage.py's.
"""

import pytest

from test_torch_stage import JOIN_CASES, check, join_query, tables  # noqa: F401
from torch_parity import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("op,jt,keys", JOIN_CASES,
                         ids=["-".join(c) for c in JOIN_CASES])
def test_join(tables, op, jt, keys):  # noqa: F811
    port, _ = check(join_query(op, jt, keys), tables)
    if jt in ("inner", "left", "full", "right"):
        # duplicate build keys: many probe rows match two or three
        assert port.num_rows > tables["fact"].num_rows * 0.6


def test_nan_join_keys_match_as_sparks():
    """Float keys on the stage path: -0.0 joins 0.0 and a NaN joins every
    NaN, as in Spark and the port's serial joins; the reference's stage
    path compares keys with `==` (`parallel/stage.py::_cols_eq`), so no
    NaN key matches there (ROADMAP Queue 3 item 15)."""
    import numpy as np
    import pyarrow as pa

    from auron_tpu.ir import expr as JE
    from auron_tpu.ir import plan as JP
    from auron_tpu.ir.schema import DataType as JDT
    from auron_tpu.ir.schema import Field as JF
    from auron_tpu.ir.schema import Schema as JS

    from test_torch_stage import Query, hashed, port_result, sources_of

    neg_nan = np.copysign(np.nan, -1.0)
    f64, i64 = JDT.float64(), JDT.int64()
    tabs = {"l": pa.table({"a": [0.0, -0.0, np.nan, neg_nan, 1.0],
                           "i": np.arange(5, dtype=np.int64)}),
            "r": pa.table({"b": [-0.0, np.nan, 2.0],
                           "j": np.arange(3, dtype=np.int64)})}
    ls, rs = JS.of(JF("a", f64), JF("i", i64)), JS.of(JF("b", f64),
                                                      JF("j", i64))
    q = Query(None, {"x": (JP.FFIReader(schema=ls, resource_id="l"),
                           hashed("a")),
                     "y": (JP.FFIReader(schema=rs, resource_id="r"),
                           hashed("b"))})
    q.plan = JP.HashJoin(
        left=q.reader("x", ls), right=q.reader("y", rs),
        on=JP.JoinOn(left_keys=(JE.col("a"),), right_keys=(JE.col("b"),)),
        join_type="inner")
    port = port_result(q.run_port(sources_of(tabs)))
    ref = q.run_ref(tabs)

    def pairs(t):
        return sorted(zip(t.column("i").to_pylist(),
                          t.column("j").to_pylist()))
    assert pairs(port) == [(0, 0), (1, 0), (2, 1), (3, 1)]
    assert pairs(ref) == [(0, 0), (1, 0)]
