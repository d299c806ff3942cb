"""Base machinery for IR nodes: a registry and a reflective dict serde
(counterpart of auron_tpu/ir/node.py).

Every node is a frozen dataclass with a unique `kind` tag, and
`to_dict`/`from_dict` produce the same canonical form as the JAX
package's, so a plan serialized by either engine decodes in the other.
"""

from __future__ import annotations

import base64
import dataclasses
import math
from typing import Any, ClassVar, Dict, Type

from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId

_REGISTRY: Dict[str, Type["Node"]] = {}


def register(cls: Type["Node"]) -> Type["Node"]:
    if cls.kind in _REGISTRY:
        raise ValueError(f"duplicate IR node kind {cls.kind!r}")
    _REGISTRY[cls.kind] = cls
    return cls


def _encode(v: Any) -> Any:
    if isinstance(v, Node):
        return v.to_dict()
    if isinstance(v, DataType):
        out: Dict[str, Any] = {"@type": v.id.name}
        if v.id == TypeId.DECIMAL:
            out["precision"], out["scale"] = v.precision, v.scale
        if v.children:
            out["children"] = [_encode(f) for f in v.children]
        return out
    if isinstance(v, Field):
        return {"@field": v.name, "dtype": _encode(v.dtype),
                "nullable": v.nullable}
    if isinstance(v, Schema):
        return {"@schema": [_encode(f) for f in v.fields]}
    if isinstance(v, (tuple, list)):
        return [_encode(x) for x in v]
    if isinstance(v, bytes):
        return {"@bytes": base64.b64encode(v).decode("ascii")}
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        # JSON has no inf/nan literal; tag them
        if math.isnan(v):
            return {"@float": "nan"}
        return {"@float": "inf" if v > 0 else "-inf"}
    return v


_SPECIAL_FLOATS = {"nan": float("nan"), "inf": float("inf"),
                   "-inf": float("-inf")}


def _decode(v: Any) -> Any:
    if isinstance(v, dict):
        if "@kind" in v:
            return Node.from_dict(v)
        if "@type" in v:
            return DataType(TypeId[v["@type"]],
                            precision=v.get("precision", 0),
                            scale=v.get("scale", 0),
                            children=tuple(_decode(c) for c in
                                           v.get("children", [])))
        if "@field" in v:
            return Field(v["@field"], _decode(v["dtype"]),
                         v.get("nullable", True))
        if "@schema" in v:
            return Schema(tuple(_decode(f) for f in v["@schema"]))
        if "@bytes" in v:
            return base64.b64decode(v["@bytes"])
        if "@float" in v:
            if v["@float"] not in _SPECIAL_FLOATS:
                raise ValueError(f"bad @float tag {v['@float']!r}")
            return _SPECIAL_FLOATS[v["@float"]]
        if "@decimal" in v:
            raise NotImplementedError(
                "decimal literals are not in auron_tpu_torch yet")
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_decode(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class Node:
    kind: ClassVar[str] = "node"

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"@kind": self.kind}
        for f in dataclasses.fields(self):
            out[f.name] = _encode(getattr(self, f.name))
        return out

    def children_nodes(self):
        """All direct child Nodes (exprs or plans), for tree walks."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Node):
                out.append(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, Node):
                        out.append(x)
                    elif isinstance(x, tuple):
                        out.extend(y for y in x if isinstance(y, Node))
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Node":
        kind = d["@kind"]
        cls = _REGISTRY.get(kind)
        if cls is None:
            raise NotImplementedError(
                f"IR node kind {kind!r} is not in auron_tpu_torch yet")
        kwargs = {f.name: _decode(d[f.name])
                  for f in dataclasses.fields(cls) if f.name in d}
        return cls(**kwargs)
