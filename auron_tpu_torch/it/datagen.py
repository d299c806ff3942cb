"""Table definitions of the TPC-DS subset (counterpart of the data
classes of auron_tpu/it/datagen.py).

`Catalog` knows each table's schema and its chunk files and builds the
`FileSourceScanExec` a Spark bridge would hand the converter, as the
JAX package's does.  It is data only: nothing here writes or reads a
file.  A caller whose tables live elsewhere (in memory, on the card)
names the chunks as it likes, and a convert provider with a foreign
engine of its own serves the scans (chip_smoke.py does that).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from auron_tpu_torch.frontend.foreign import ForeignExpr, ForeignNode
from auron_tpu_torch.ir.schema import Field, Schema


@dataclass
class TableDef:
    name: str
    schema: Schema
    chunks: List[str] = field(default_factory=list)   # parquet paths


@dataclass
class Catalog:
    """Every table's schema and file chunks; builds the scans."""

    data_dir: str
    tables: Dict[str, TableDef] = field(default_factory=dict)

    def scan(self, table: str, columns: Optional[Sequence[str]] = None,
             pushed_filters: Sequence[ForeignExpr] = (),
             parts: Optional[int] = None) -> ForeignNode:
        t = self.tables[table]
        cols = list(columns) if columns is not None else t.schema.names()
        fields = {f.name: f for f in t.schema.fields}
        out = Schema(tuple(fields[c] for c in cols))
        n = parts or len(t.chunks)
        groups: List[List[str]] = [[] for _ in range(min(n, len(t.chunks)))]
        for i, path in enumerate(t.chunks):
            groups[i % len(groups)].append(path)
        return ForeignNode(
            "FileSourceScanExec", output=out,
            attrs={"format": "parquet",
                   "file_groups": [list(g) for g in groups],
                   "pushed_filters": list(pushed_filters)})

    def field(self, table: str, column: str) -> Field:
        for f in self.tables[table].schema.fields:
            if f.name == column:
                return f
        raise KeyError(f"{table}.{column}")
