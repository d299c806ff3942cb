"""Foreign (host-engine) physical plan descriptor (counterpart of
auron_tpu/frontend/foreign.py).

The wire boundary a JVM or engine bridge targets: an engine-agnostic,
JSON-able description of an already optimized physical plan, the
stand-in for Spark's `SparkPlan`.  Ops use Spark's exec-class names
("ProjectExec", "ShuffleExchangeExec", ...) and expressions Spark's
expression-class names ("Add", "AttributeReference", ...), so the
convert strategy's per-op rules carry over one to one.  The JSON form
is the JAX package's: a plan serialized by either package reads back
in the other byte for byte.

A type string parses to the port's `DataType` of that `TypeId` (the
port's schema keeps every type id of the wire, decimal, float32 and the
nested types included, though its device layer holds only the flat
ones); any other string raises naming it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId


@dataclass
class ForeignExpr:
    """One node of a foreign expression tree.

    `name` = Spark expression class name.  Payload fields:
    - value/dtype: literals, casts
    - attrs: op-specific scalars (e.g. "pattern", "offset", "field")
    - py_fn: optional pickled python callable used by the UDF fallback
      wrapper when this node itself is not convertible (the analogue of the
      reference round-tripping unconvertible exprs to the JVM,
      NativeConverters.scala:277-324).
    """
    name: str
    children: Tuple["ForeignExpr", ...] = ()
    value: Any = None
    dtype: Optional[DataType] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    py_fn: Optional[bytes] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"e": self.name}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.value is not None:
            out["value"] = self.value
        if self.dtype is not None:
            out["dtype"] = _dtype_to_str(self.dtype)
        if self.attrs:
            out["attrs"] = self.attrs
        if self.py_fn is not None:
            import base64
            out["py_fn"] = base64.b64encode(self.py_fn).decode("ascii")
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ForeignExpr":
        py_fn = None
        if "py_fn" in d:
            import base64
            py_fn = base64.b64decode(d["py_fn"])
        return ForeignExpr(
            name=d["e"],
            children=tuple(ForeignExpr.from_dict(c)
                           for c in d.get("children", [])),
            value=d.get("value"),
            dtype=_dtype_from_str(d["dtype"]) if "dtype" in d else None,
            attrs=d.get("attrs", {}),
            py_fn=py_fn)


@dataclass
class ForeignNode:
    """One node of a foreign physical plan.

    `output` is the node's output schema (attribute name -> type), the
    analogue of SparkPlan.output.  `attrs` carries op-specific payloads
    (exprs, join keys, file groups, limits, partitioning...).
    """
    op: str
    children: Tuple["ForeignNode", ...] = ()
    output: Optional[Schema] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    # -- traversal (SparkPlan.foreach/foreachUp analogues) ----------------

    def foreach(self, fn) -> None:
        fn(self)
        for c in self.children:
            c.foreach(fn)

    def foreach_up(self, fn) -> None:
        for c in self.children:
            c.foreach_up(fn)
        fn(self)

    def pretty(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.op]
        for c in self.children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    # -- serde ------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"op": self.op}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.output is not None:
            out["output"] = [[f.name, _dtype_to_str(f.dtype), f.nullable]
                             for f in self.output.fields]
        if self.attrs:
            out["attrs"] = _encode_attrs(self.attrs)
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ForeignNode":
        output = None
        if "output" in d:
            output = Schema(tuple(
                Field(n, _dtype_from_str(t), bool(nl))
                for n, t, nl in d["output"]))
        return ForeignNode(
            op=d["op"],
            children=tuple(ForeignNode.from_dict(c)
                           for c in d.get("children", [])),
            output=output,
            attrs=_decode_attrs(d.get("attrs", {})))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "ForeignNode":
        return ForeignNode.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# attr encoding: ForeignExpr values inside attrs are tagged so the whole
# plan round-trips through JSON
# ---------------------------------------------------------------------------

def _encode_attrs(v: Any) -> Any:
    if isinstance(v, ForeignExpr):
        return {"@fexpr": v.to_dict()}
    if isinstance(v, ForeignNode):
        return {"@fnode": v.to_dict()}
    if isinstance(v, DataType):
        return {"@dtype": _dtype_to_str(v)}
    if isinstance(v, Schema):
        return {"@schema": [[f.name, _dtype_to_str(f.dtype), f.nullable]
                            for f in v.fields]}
    if isinstance(v, bytes):
        import base64
        return {"@bytes": base64.b64encode(v).decode("ascii")}
    if isinstance(v, dict):
        return {k: _encode_attrs(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_attrs(x) for x in v]
    return v


def _decode_attrs(v: Any) -> Any:
    if isinstance(v, dict):
        if "@fexpr" in v:
            return ForeignExpr.from_dict(v["@fexpr"])
        if "@fnode" in v:
            return ForeignNode.from_dict(v["@fnode"])
        if "@dtype" in v:
            return _dtype_from_str(v["@dtype"])
        if "@schema" in v:
            return Schema(tuple(Field(n, _dtype_from_str(t), bool(nl))
                                for n, t, nl in v["@schema"]))
        if "@bytes" in v:
            import base64
            return base64.b64decode(v["@bytes"])
        return {k: _decode_attrs(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_attrs(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# compact textual type names (Spark DDL-ish), for the JSON form
# ---------------------------------------------------------------------------

_SIMPLE = {
    TypeId.NULL: "null", TypeId.BOOL: "boolean", TypeId.INT8: "tinyint",
    TypeId.INT16: "smallint", TypeId.INT32: "int", TypeId.INT64: "bigint",
    TypeId.FLOAT32: "float", TypeId.FLOAT64: "double",
    TypeId.STRING: "string", TypeId.BINARY: "binary", TypeId.DATE32: "date",
    TypeId.TIMESTAMP_US: "timestamp",
}
_SIMPLE_REV = {v: k for k, v in _SIMPLE.items()}


def _dtype_to_str(dt: DataType) -> str:
    if dt.id in _SIMPLE:
        return _SIMPLE[dt.id]
    if dt.id == TypeId.DECIMAL:
        return f"decimal({dt.precision},{dt.scale})"
    if dt.id == TypeId.LIST:
        return f"array<{_dtype_to_str(dt.children[0].dtype)}>"
    if dt.id == TypeId.MAP:
        return (f"map<{_dtype_to_str(dt.children[0].dtype)},"
                f"{_dtype_to_str(dt.children[1].dtype)}>")
    if dt.id == TypeId.STRUCT:
        inner = ",".join(f"{f.name}:{_dtype_to_str(f.dtype)}"
                         for f in dt.children)
        return f"struct<{inner}>"
    raise ValueError(f"unsupported dtype {dt}")


def _dtype_from_str(s: str) -> DataType:
    s = s.strip()
    if s in _SIMPLE_REV:
        return DataType(_SIMPLE_REV[s])
    if s.startswith("decimal(") and s.endswith(")"):
        try:
            p, sc = s[len("decimal("):-1].split(",")
            return DataType.decimal(int(p), int(sc))
        except ValueError:
            raise ValueError(f"cannot parse dtype string {s!r}") from None
    if s.startswith("array<") and s.endswith(">"):
        return DataType.list_(_dtype_from_str(s[len("array<"):-1]))
    if s.startswith("map<") and s.endswith(">"):
        k, v = _split_top(s[len("map<"):-1])
        return DataType.map_(_dtype_from_str(k), _dtype_from_str(v))
    if s.startswith("struct<") and s.endswith(">"):
        fields = []
        for part in _split_all(s[len("struct<"):-1]):
            name, t = part.split(":", 1)
            fields.append(Field(name, _dtype_from_str(t), True))
        return DataType.struct(tuple(fields))
    raise ValueError(f"cannot parse dtype string {s!r}")


def _split_top(s: str) -> Tuple[str, str]:
    depth = 0
    for i, ch in enumerate(s):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == "," and depth == 0:
            return s[:i], s[i + 1:]
    raise ValueError(f"expected two type args in {s!r}")


def _split_all(s: str) -> List[str]:
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    if s[start:]:
        out.append(s[start:])
    return out


# -- convenience builders (used by tests and the query builders) -----------

def fcol(name: str, dtype: DataType, nullable: bool = True) -> ForeignExpr:
    return ForeignExpr("AttributeReference", value=name, dtype=dtype,
                       attrs={"nullable": nullable})


def flit(value: Any, dtype: Optional[DataType] = None) -> ForeignExpr:
    if dtype is None:
        from auron_tpu_torch.ir.expr import _infer_literal_type
        dtype = _infer_literal_type(value)
    return ForeignExpr("Literal", value=value, dtype=dtype)


def falias(child: ForeignExpr, name: str) -> ForeignExpr:
    return ForeignExpr("Alias", children=(child,), value=name)


def fcall(name: str, *children: ForeignExpr, **attrs) -> ForeignExpr:
    dtype = attrs.pop("dtype", None)
    value = attrs.pop("value", None)
    return ForeignExpr(name, children=tuple(children), value=value,
                       dtype=dtype, attrs=attrs)
