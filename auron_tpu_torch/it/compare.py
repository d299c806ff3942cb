"""Result comparison with float tolerance (counterpart of
auron_tpu/it/compare.py, without pyarrow): rows are canonicalized
(row-sorted unless the query is ordered), floats compared within
relative tolerance, None and NaN equal to themselves.

A table is a `HostTable`: its column names and its rows as tuples of
Python values (None where null; a date as its int days, as the port's
results and the expected-results file hold it).  For the same rows,
`compare_tables` gives the JAX package's verdict and first-difference
message.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class HostTable:
    names: List[str]
    rows: List[Tuple]

    @property
    def num_rows(self) -> int:
        return len(self.rows)

    @classmethod
    def from_columns(cls, names: Sequence[str], arrays: Sequence,
                     validities: Sequence) -> "HostTable":
        """Columns as numpy arrays and their validities (None: no nulls)."""
        cols = []
        for a, v in zip(arrays, validities):
            vals = np.asarray(a).tolist()
            if v is not None:
                vals = [x if ok else None
                        for x, ok in zip(vals, np.asarray(v, bool).tolist())]
            cols.append(vals)
        n = len(arrays[0]) if len(arrays) else 0
        return cls(list(names), list(zip(*cols)) if cols else [()] * n)

    @classmethod
    def from_result(cls, res) -> "HostTable":
        """A `SessionResult`'s columns, in its schema's order."""
        names = list(res.schema.names())
        return cls.from_columns(names, [res.columns[n][0] for n in names],
                                [res.columns[n][1] for n in names])


def _norm_value(v: Any) -> Any:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        return v
    return v


def _rows(table: HostTable) -> List[Tuple]:
    return [tuple(_norm_value(v) for v in r) for r in table.rows]


def _value_eq(a: Any, b: Any, rel_tol: float, abs_tol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if a == "NaN" or b == "NaN":
        return a == b
    if isinstance(a, float) or isinstance(b, float):
        try:
            return math.isclose(float(a), float(b), rel_tol=rel_tol,
                                abs_tol=abs_tol)
        except (TypeError, ValueError):
            return False
    return a == b


def _sort_key(row: Tuple) -> Tuple:
    # floats are rounded to well below the compare tolerance before keying:
    # two tolerant-equal values that stringify differently must land in the
    # same sorted position on both sides, or the positional zip below
    # reports spurious first-differences
    out = []
    for v in row:
        if isinstance(v, float) and not math.isnan(v):
            out.append((v is None, "float", f"{v + 0.0:.3e}"))  # -0.0 == 0.0
        else:
            out.append((v is None, str(type(v).__name__), str(v)))
    return tuple(out)


# foreign plan roots that pass row order through to their output; the
# walk below descends them looking for a top-level sort
_ORDER_PRESERVING_ROOTS = (
    "ProjectExec", "GlobalLimitExec", "LocalLimitExec",
    "CollectLimitExec", "ColumnarToRowExec", "InputAdapter",
    "WholeStageCodegenExec",
)
_ORDERED_ROOTS = ("TakeOrderedAndProjectExec", "SortExec")


def plan_is_ordered(plan) -> bool:
    """Does this foreign plan promise a total output order — a top-level
    ORDER BY (Sort/TakeOrderedAndProject root, possibly under
    order-preserving projections/limits)?  Ordered queries must compare
    row-by-row: the reference's QueryResultComparator checks emitted
    order, and row-sorting both sides would let a wrong-order engine
    result pass the differential gate."""
    cur = plan
    while cur is not None:
        op = getattr(cur, "op", None)
        if op is None:
            return False
        if op in _ORDERED_ROOTS:
            return True
        children = getattr(cur, "children", ())
        if op in _ORDER_PRESERVING_ROOTS and len(children) == 1:
            cur = children[0]
            continue
        return False
    return False


def compare_tables(actual: HostTable, expected: HostTable,
                   rel_tol: float = 1e-4, abs_tol: float = 1e-6,
                   ordered: bool = False) -> Optional[str]:
    """None when equal; otherwise a human-readable first-difference."""
    if actual.num_rows != expected.num_rows:
        return (f"row count differs: actual={actual.num_rows} "
                f"expected={expected.num_rows}")
    if actual.names != expected.names:
        return (f"column names differ: {actual.names} vs "
                f"{expected.names}")
    a_rows, e_rows = _rows(actual), _rows(expected)
    if not ordered:
        a_rows = sorted(a_rows, key=_sort_key)
        e_rows = sorted(e_rows, key=_sort_key)
    for i, (ar, er) in enumerate(zip(a_rows, e_rows)):
        for c, (av, ev) in enumerate(zip(ar, er)):
            if not _value_eq(av, ev, rel_tol, abs_tol):
                col = actual.names[c]
                return (f"row {i} col {col!r}: actual={av!r} "
                        f"expected={ev!r}")
    return None
