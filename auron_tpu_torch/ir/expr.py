"""Physical expression IR nodes (counterpart of auron_tpu/ir/expr.py).

The kinds the port evaluates: column reference, literal, the binary
node (arithmetic, bitwise, comparison and Kleene logic), null tests,
not, negative, cast and try_cast, case, in-list, the scalar function
call and the short-circuit and/or, plus the aggregate call and the sort
order of a Sort or a range partitioning.  Field names, defaults and `kind` tags are the JAX
package's, so their JSON is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional, Tuple

from auron_tpu_torch.ir.node import Node, register
from auron_tpu_torch.ir.schema import DataType


@dataclass(frozen=True)
class Expr(Node):
    kind: ClassVar[str] = "expr"


@register
@dataclass(frozen=True)
class Column(Expr):
    """Column reference by name (resolved against the input schema)."""
    kind: ClassVar[str] = "column"
    name: str = ""


@register
@dataclass(frozen=True)
class Literal(Expr):
    kind: ClassVar[str] = "literal"
    value: Any = None
    dtype: DataType = field(default_factory=DataType.null)


@register
@dataclass(frozen=True)
class BinaryExpr(Expr):
    """op in {+,-,*,/,%,==,!=,<,<=,>,>=,<=>,and,or,&,|,^,<<,>>}."""
    kind: ClassVar[str] = "binary"
    left: Expr = None  # type: ignore[assignment]
    op: str = "+"
    right: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class IsNull(Expr):
    kind: ClassVar[str] = "is_null"
    child: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class IsNotNull(Expr):
    kind: ClassVar[str] = "is_not_null"
    child: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class Not(Expr):
    kind: ClassVar[str] = "not"
    child: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class Negative(Expr):
    kind: ClassVar[str] = "negative"
    child: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class Cast(Expr):
    """Spark-semantics cast (integral overflow wraps)."""
    kind: ClassVar[str] = "cast"
    child: Expr = None  # type: ignore[assignment]
    dtype: DataType = field(default_factory=DataType.null)


@register
@dataclass(frozen=True)
class TryCast(Expr):
    kind: ClassVar[str] = "try_cast"
    child: Expr = None  # type: ignore[assignment]
    dtype: DataType = field(default_factory=DataType.null)


@register
@dataclass(frozen=True)
class WhenThen(Node):
    kind: ClassVar[str] = "when_then"
    when: Expr = None  # type: ignore[assignment]
    then: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class Case(Expr):
    kind: ClassVar[str] = "case"
    branches: Tuple[WhenThen, ...] = ()
    else_expr: Optional[Expr] = None


@register
@dataclass(frozen=True)
class InList(Expr):
    kind: ClassVar[str] = "in_list"
    child: Expr = None  # type: ignore[assignment]
    values: Tuple[Expr, ...] = ()
    negated: bool = False


@register
@dataclass(frozen=True)
class ScalarFunctionCall(Expr):
    """A named scalar function (exprs/functions.py holds the port's)."""
    kind: ClassVar[str] = "scalar_function"
    name: str = ""
    args: Tuple[Expr, ...] = ()
    return_type: DataType = field(default_factory=DataType.null)


@register
@dataclass(frozen=True)
class ScAnd(Expr):
    """Short-circuit AND (right side only evaluated where left is true)."""
    kind: ClassVar[str] = "sc_and"
    left: Expr = None  # type: ignore[assignment]
    right: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class ScOr(Expr):
    kind: ClassVar[str] = "sc_or"
    left: Expr = None  # type: ignore[assignment]
    right: Expr = None  # type: ignore[assignment]


@register
@dataclass(frozen=True)
class SortExpr(Node):
    """One sort key: its expression, direction and null placement."""
    kind: ClassVar[str] = "sort_expr"
    child: Expr = None  # type: ignore[assignment]
    asc: bool = True
    nulls_first: bool = True


@register
@dataclass(frozen=True)
class AggExpr(Node):
    """Aggregate call: fn is an AggFunction value string.  `udaf` and
    `wire` stay None in the port; they are kept so the JSON matches."""
    kind: ClassVar[str] = "agg_expr"
    fn: str = "sum"
    children: Tuple[Expr, ...] = ()
    return_type: DataType = field(default_factory=DataType.null)
    distinct: bool = False
    udaf: Optional[bytes] = None
    wire: Optional[Node] = None


def col(name: str) -> Column:
    return Column(name=name)



def _infer_literal_type(value: Any) -> DataType:
    if value is None:
        return DataType.null()
    if isinstance(value, bool):
        return DataType.bool_()
    if isinstance(value, int):
        if value < -(2**63) or value > 2**63 - 1:
            raise OverflowError(f"integer literal {value} exceeds int64 range")
        if -(2**31) <= value <= 2**31 - 1:
            return DataType.int32()
        return DataType.int64()
    if isinstance(value, float):
        return DataType.float64()
    if isinstance(value, str):
        return DataType.string()
    if isinstance(value, bytes):
        return DataType.binary()
    raise TypeError(f"cannot infer literal type for {value!r}")
