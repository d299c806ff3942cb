"""EXPLAIN ANALYZE: merge per-task metric trees, render the executed
plan annotated per operator (counterpart of
auron_tpu/runtime/explain_analyze.py).

The session's collected trees (one per (stage, partition) task, the
exchange map tasks' among them) are merged by structure (metric trees
mirror the operator tree, so the tasks of one plan share a shape) and
rendered indented with the rows, batches, compute time, spill and
memory metrics inline.  Compute times are the host clock's
(`elapsed_compute_ns`, ops/base.py): on a GPU the host's dispatch plus
any synchronization inside the operator, not device time.

Two render modes, with the JAX package's text forms:

- human (default): every metric, durations in ms, the debugging view.
- canonical (`normalize=True`): values that vary run to run (wall-clock
  ns, cache deltas, byte counts that move with the format, memory
  peaks) are dropped, so the text is stable run to run.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from auron_tpu_torch.runtime.metrics import MetricNode

__all__ = ["merge_metric_trees", "metric_totals", "metric_max",
           "render_analyzed", "render_analyzed_dicts", "explain_analyze",
           "diff_metric_trees", "render_diff"]

# values that vary run-to-run (timings, process-global cache state,
# codec-dependent byte counts, memory peaks that move with padding/
# platform): excluded from the canonical form.  The memory COLUMNS that
# survive canonicalization are the deterministic counts (mem_spill_count).
# The set is the JAX package's, whole, so that both engines render one
# tree to one text; the keys of JAX features the port lacks never occur
# in its own trees.
_VOLATILE_KEYS = frozenset({
    "kernel_cache_hits", "kernel_cache_misses", "ffi_ingest_cache_hits",
    "mem_spill_size", "disk_spill_size", "mem_peak",
    # cold-vs-warm process state: a first run traces, a repeat traces 0
    "jit_compiles",
    # exchange wire bytes: codec- and format-version-dependent
    "shuffle_write_bytes", "shuffle_read_bytes",
    # observed exchange histograms (session ExchangeStats marker
    # nodes): byte values move with codec/format, rows_out/partitions
    # stay canonical
    "bytes_out", "part_bytes_max", "part_bytes_min",
    # the JAX package's perfscope kernel accounting: estimated kernel
    # bytes move with batch padding/strategy and only appear when armed
    "perf_bytes",
})

# byte-valued metrics: rendered human-readable in the non-canonical form
_BYTE_KEYS = frozenset({"mem_peak", "mem_spill_size", "disk_spill_size",
                        "shuffle_write_bytes", "shuffle_read_bytes",
                        "bytes_out", "part_bytes_max",
                        "part_bytes_min", "perf_bytes"})

# render order: row/batch flow first, then time, then memory, then the
# rest sorted
_KEY_ORDER = ("output_rows", "output_batches", "input_rows",
              "input_batches", "elapsed_compute_ns", "mem_peak",
              "mem_spill_count", "mem_spill_size")


def _volatile(key: str) -> bool:
    return key.endswith("_ns") or key in _VOLATILE_KEYS


def _signature(node: MetricNode) -> Tuple:
    return (node.name, tuple(_signature(c) for c in node.children))


def _merge_into(dst: MetricNode, src: MetricNode) -> None:
    src._settle()
    for k, v in src.values.items():
        dst.add(k, v)
    for dc, sc in zip(dst.children, src.children):
        _merge_into(dc, sc)


def _clone_shape(node: MetricNode) -> MetricNode:
    out = MetricNode(node.name)
    out.children = [_clone_shape(c) for c in node.children]
    return out


def merge_metric_trees(trees: List[MetricNode]
                       ) -> List[Tuple[MetricNode, int]]:
    """Group trees by structural signature (same plan => same shape) and
    sum each group element-wise.  Returns [(merged tree, task count)]
    in first-seen order: the root plan's group first, then exchange map
    sides, then any marker nodes (SpmdFallback)."""
    groups: Dict[Tuple, Tuple[MetricNode, int]] = {}
    order: List[Tuple] = []
    for t in trees:
        sig = _signature(t)
        if sig not in groups:
            groups[sig] = (_clone_shape(t), 0)
            order.append(sig)
        merged, n = groups[sig]
        _merge_into(merged, t)
        groups[sig] = (merged, n + 1)
    return [groups[sig] for sig in order]


def metric_totals(trees: List[MetricNode]) -> Dict[str, int]:
    """Flat sum of every metric over every node of every tree — the
    per-query totals the query history records and Prometheus exports."""
    totals: Dict[str, int] = {}

    def walk(n: MetricNode) -> None:
        n._settle()
        for k, v in n.values.items():
            totals[k] = totals.get(k, 0) + int(v)
        for c in n.children:
            walk(c)

    for t in trees:
        walk(t)
    return totals


def metric_max(trees: List[MetricNode], key: str) -> int:
    """Largest single-node value of `key` over every tree — e.g. the
    biggest per-operator memory peak of a query (summing peaks across
    operators would overstate the pool: they rarely coincide)."""
    best = 0

    def walk(n: MetricNode) -> None:
        nonlocal best
        n._settle()
        v = int(n.values.get(key, 0))
        if v > best:
            best = v
        for c in n.children:
            walk(c)

    for t in trees:
        walk(t)
    return best


def _fmt_bytes(value: int) -> str:
    if value >= 1 << 20:
        return f"{value / (1 << 20):.1f}MB"
    if value >= 1 << 10:
        return f"{value / (1 << 10):.1f}KB"
    return f"{value}B"


def _fmt_value(key: str, value: int) -> str:
    if key.endswith("_ns"):
        short = key[:-3].replace("elapsed_compute", "compute")
        return f"{short}={value / 1e6:.1f}ms"
    if key in _BYTE_KEYS:
        return f"{key}={_fmt_bytes(value)}"
    return f"{key}={value}"


def _derived_parts(values: Dict[str, Any], normalize: bool) -> List[str]:
    """Derived columns of the human render: achieved kernel bandwidth
    from the JAX package's perfscope accounting (bytes/ns IS GB/s, both
    1e9-scaled); the port records neither input.
    Dropped under normalize with the volatile inputs it derives from."""
    if normalize:
        return []
    nbytes = values.get("perf_bytes", 0)
    ns = values.get("perf_kernel_ns", 0)
    if nbytes and ns:
        return [f"kernel_gbps={nbytes / ns:.2f}"]
    return []


def _render_node(node: MetricNode, depth: int, lines: List[str],
                 normalize: bool) -> None:
    node._settle()
    keys = [k for k in _KEY_ORDER if k in node.values]
    keys += sorted(k for k in node.values if k not in _KEY_ORDER)
    parts = []
    for k in keys:
        v = node.values[k]
        if normalize and _volatile(k):
            continue
        if v == 0 and k not in ("output_rows", "output_batches"):
            continue
        parts.append(_fmt_value(k, v) if not normalize
                     else f"{k}={v}")
    parts += _derived_parts(node.values, normalize)
    pad = "  " * depth
    lines.append(f"{pad}{node.name}: " + (" ".join(parts) or "-"))
    for c in node.children:
        _render_node(c, depth + 1, lines, normalize)


def render_analyzed(trees: List[MetricNode], normalize: bool = False
                    ) -> str:
    """Render merged metric trees; each group is headed by its task
    count (`[N tasks]`)."""
    lines: List[str] = []
    for merged, n in merge_metric_trees(trees):
        lines.append(f"[{n} task{'s' if n != 1 else ''}]")
        _render_node(merged, 1, lines, normalize)
    return "\n".join(lines)


def _render_dict_node(node: Dict[str, Any], depth: int,
                      lines: List[str], normalize: bool) -> None:
    values = node.get("values") or {}
    keys = [k for k in _KEY_ORDER if k in values]
    keys += sorted(k for k in values if k not in _KEY_ORDER)
    parts = []
    for k in keys:
        v = values[k]
        if normalize and _volatile(k):
            continue
        if v == 0 and k not in ("output_rows", "output_batches"):
            continue
        parts.append(_fmt_value(k, v) if not normalize
                     else f"{k}={v}")
    parts += _derived_parts(values, normalize)
    pad = "  " * depth
    lines.append(f"{pad}{node.get('name')}: " + (" ".join(parts) or "-"))
    for c in node.get("children") or ():
        _render_dict_node(c, depth + 1, lines, normalize)


def render_analyzed_dicts(groups: List[Dict[str, Any]],
                          normalize: bool = False) -> str:
    """Render merged metric trees from their SERIALIZED form
    (QueryRecord.metric_trees: [{"tasks": n, "tree": dict}]), the
    shape that lives in the history ring, without the original
    MetricNode objects."""
    lines: List[str] = []
    for g in groups:
        n = int(g.get("tasks", 1))
        lines.append(f"[{n} task{'s' if n != 1 else ''}]")
        _render_dict_node(g.get("tree") or {}, 1, lines, normalize)
    return "\n".join(lines)


def explain_analyze(trees: List[MetricNode],
                    query_id: Optional[str] = None,
                    wall_s: Optional[float] = None,
                    rows: Optional[int] = None,
                    spmd: bool = False,
                    retries: int = 0,
                    fallbacks: int = 0,
                    aqe: Optional[List[Dict[str, Any]]] = None,
                    normalize: bool = False) -> str:
    """The full EXPLAIN ANALYZE text: a summary header + the annotated
    executed plan.  `normalize=True` omits the volatile header fields
    (query id, wall time) and metric values — the golden-comparable
    canonical form.  `aqe` lists adaptive replan decisions (the JAX
    package's adaptive execution; the port's session passes none yet);
    in the canonical form only the decision kind + exchange ordinal
    survive."""
    head = ["== EXPLAIN ANALYZE"]
    if not normalize:
        if query_id:
            head.append(f"query={query_id}")
        if wall_s is not None:
            head.append(f"wall={wall_s:.3f}s")
    if rows is not None:
        head.append(f"rows={rows}")
    head.append(f"mode={'spmd' if spmd else 'serial'}")
    head.append(f"retries={retries}")
    head.append(f"fallbacks={fallbacks}")
    out = [" ".join(head) + " =="]
    for d in aqe or ():
        line = f"aqe: {d.get('kind')} {d.get('exchange')}"
        if not normalize and d.get("reason"):
            line += f" ({d['reason']})"
        out.append(line)
    if not trees:
        out.append("(no per-operator metrics: the query compiled to one "
                   "SPMD stage program; run with "
                   "auron.spmd.singleDevice.enable=false for the "
                   "per-operator serial view)" if spmd else
                   "(no per-operator metrics collected)")
        return "\n".join(out)
    out.append(render_analyzed(trees, normalize=normalize))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# query diff: per-operator metric deltas between two runs of one plan
# shape
# ---------------------------------------------------------------------------
#
# Works over the DICT form of merged metric trees (QueryRecord.
# metric_trees: [{"tasks": n, "tree": MetricNode.to_dict()}]): records in
# the history ring are already settled and serializable, and the diff
# must not require the original MetricNode objects to still exist.

def _dict_signature(tree: Dict[str, Any]) -> Tuple:
    return (tree["name"],
            tuple(_dict_signature(c) for c in tree.get("children", ())))


def _flatten_nodes(tree: Dict[str, Any], depth: int = 0,
                   out: Optional[List] = None) -> List:
    if out is None:
        out = []
    out.append((depth, tree))
    for c in tree.get("children", ()):
        _flatten_nodes(c, depth + 1, out)
    return out


def diff_metric_trees(a: List[Dict[str, Any]], b: List[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Pair the two queries' merged metric-tree groups by structural
    signature and compute per-node, per-key (a, b, delta) triples.

    Raises ValueError when NO group shape matches — the two queries ran
    different plan shapes and a per-operator diff is meaningless.
    Partially matching runs (e.g. one run degraded SPMD->serial and grew
    a marker group) diff the matching groups and count the rest."""
    by_sig: Dict[Tuple, Dict[str, Any]] = {}
    order: List[Tuple] = []
    for g in a:
        sig = _dict_signature(g["tree"])
        if sig not in by_sig:
            by_sig[sig] = {"a": g, "b": None}
            order.append(sig)
    matched_b = 0
    for g in b:
        sig = _dict_signature(g["tree"])
        ent = by_sig.get(sig)
        if ent is not None and ent["b"] is None:
            ent["b"] = g
            matched_b += 1
    groups = []
    for sig in order:
        ent = by_sig[sig]
        if ent["b"] is None:
            continue
        ga, gb = ent["a"], ent["b"]
        nodes = []
        for (depth, na), (_d, nb) in zip(_flatten_nodes(ga["tree"]),
                                         _flatten_nodes(gb["tree"])):
            keys = sorted(set(na.get("values", {}))
                          | set(nb.get("values", {})))
            metrics = {}
            for k in keys:
                va = int(na.get("values", {}).get(k, 0))
                vb = int(nb.get("values", {}).get(k, 0))
                if va or vb:
                    metrics[k] = {"a": va, "b": vb, "delta": vb - va}
            nodes.append({"name": na["name"], "depth": depth,
                          "metrics": metrics})
        groups.append({"tasks_a": ga.get("tasks", 1),
                       "tasks_b": gb.get("tasks", 1), "nodes": nodes})
    if not groups:
        raise ValueError(
            "no matching plan shape between the two queries — "
            "per-operator diff requires runs of the same plan")
    return {"groups": groups,
            "unmatched_a": len(a) - len(groups),
            "unmatched_b": len(b) - matched_b}


def _fmt_delta(key: str, d: Dict[str, int]) -> str:
    if key.endswith("_ns"):
        return (f"{key[:-3]}={d['a'] / 1e6:.1f}ms->{d['b'] / 1e6:.1f}ms "
                f"({d['delta'] / 1e6:+.1f}ms)")
    if key in _BYTE_KEYS:
        return (f"{key}={_fmt_bytes(d['a'])}->{_fmt_bytes(d['b'])} "
                f"({d['delta']:+d}B)")
    return f"{key}={d['a']}->{d['b']} ({d['delta']:+d})"


def render_diff(diff: Dict[str, Any], query_a: str = "a",
                query_b: str = "b") -> str:
    lines = [f"== QUERY DIFF a={query_a} b={query_b} =="]
    for g in diff["groups"]:
        lines.append(f"[{g['tasks_a']} vs {g['tasks_b']} tasks]")
        for node in g["nodes"]:
            pad = "  " * (node["depth"] + 1)
            parts = [_fmt_delta(k, d)
                     for k, d in node["metrics"].items()]
            lines.append(f"{pad}{node['name']}: "
                         + (" ".join(parts) or "-"))
    if diff["unmatched_a"] or diff["unmatched_b"]:
        lines.append(f"(unmatched groups: {diff['unmatched_a']} in a, "
                     f"{diff['unmatched_b']} in b)")
    return "\n".join(lines)
