"""Foreign (Spark-named) expression tree -> IR Expr conversion
(counterpart of auron_tpu/frontend/expr_convert.py).

A dispatch by Spark expression-class name over the same ~90 kinds as
the JAX package, with its decimal, case-convert and datetime gating,
emitting the port's `ir/expr.py` kinds with the same JSON.  Where the
JAX package emits a kind the port's IR lacks (`_MISSING`), the port
raises `NotConvertible` naming the kind and its ROADMAP item, so the
convert strategy leaves the node to the foreign engine, as it does with
anything else it cannot convert.  That includes the partial fallback
into the Python UDF wrapper (`PyUdfWrapper`, the JAX package's
counterpart of Spark's `SparkUDFWrapperExpr`), and the UDAF fallback.
"""

from __future__ import annotations

from typing import Callable, Dict

from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend.foreign import ForeignExpr
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.expr import AggExpr, Expr, SortExpr
from auron_tpu_torch.ir.schema import DataType


class NotConvertible(Exception):
    """Raised when a foreign expression/plan has no native conversion."""


def _dt(fe: ForeignExpr) -> DataType:
    return fe.dtype if fe.dtype is not None else DataType.null()


# the JAX package's IR kinds the port's IR lacks, with their ROADMAP items
_MISSING = {
    "bound_reference": "Queue 1 item 4",
    "row_num": "Queue 1 item 4",
    "partition_id": "Queue 1 item 4",
    "monotonically_increasing_id": "Queue 1 item 4",
    "like": "Queue 1 item 11",
    "string_starts_with": "Queue 1 item 11",
    "string_ends_with": "Queue 1 item 11",
    "string_contains": "Queue 1 item 11",
    "scalar_subquery": "Queue 1 item 20",
    "get_indexed_field": "Queue 1 item 20",
    "get_map_value": "Queue 1 item 20",
    "named_struct": "Queue 1 item 20",
    "bloom_filter_might_contain": "Queue 1 item 8",
    "py_udf_wrapper": "Queue 1 item 21",
    "udaf": "Queue 1 item 21",
}


class _MissingKind(NotConvertible):
    """A kind the port's IR lacks: the message names it and its item."""


def _missing(kind: str):
    raise _MissingKind(f"IR kind {kind} is not in auron_tpu_torch yet "
                       f"(ROADMAP {_MISSING[kind]})")


# ---------------------------------------------------------------------------
# dispatch table: Spark expression class name -> builder(fe, conv) -> Expr
# `conv` converts a child (with fallback enabled so partial fallback nests).
# ---------------------------------------------------------------------------

_CONVERTERS: Dict[str, Callable[..., Expr]] = {}


def _reg(*names: str):
    def deco(fn):
        for n in names:
            _CONVERTERS[n] = fn
        return fn
    return deco


def _fn(name: str, fe: ForeignExpr, conv, args=None) -> Expr:
    return E.ScalarFunctionCall(
        name=name,
        args=tuple(conv(c) for c in (args if args is not None else fe.children)),
        return_type=_dt(fe))


# -- leaves -----------------------------------------------------------------

@_reg("AttributeReference")
def _attr(fe, conv):
    return E.Column(name=fe.value)


@_reg("BoundReference")
def _bound(fe, conv):
    return _missing("bound_reference")


@_reg("Literal")
def _literal(fe, conv):
    return E.Literal(value=fe.value, dtype=_dt(fe))


@_reg("Alias")
def _alias(fe, conv):
    # alias name is consumed at the plan level; the expr is transparent
    return conv(fe.children[0])


@_reg("PromotePrecision", "KnownFloatingPointNormalized", "KnownNotNull")
def _transparent(fe, conv):
    return conv(fe.children[0])


@_reg("SparkPartitionID")
def _pid(fe, conv):
    return _missing("partition_id")


@_reg("MonotonicallyIncreasingID")
def _monot(fe, conv):
    return _missing("monotonically_increasing_id")


@_reg("RowNumberLike", "RowNum")
def _rownum(fe, conv):
    return _missing("row_num")


@_reg("ScalarSubquery")
def _scalar_subquery(fe, conv):
    # the bridge pre-computes the subquery result and ships it as a value
    # (reference: PhysicalSparkScalarSubqueryWrapperExprNode)
    return _missing("scalar_subquery")


# -- casts ------------------------------------------------------------------

@_reg("Cast", "AnsiCast")
def _cast(fe, conv):
    return E.Cast(child=conv(fe.children[0]), dtype=_dt(fe))


@_reg("TryCast")
def _try_cast(fe, conv):
    return E.TryCast(child=conv(fe.children[0]), dtype=_dt(fe))


# -- arithmetic / comparison ------------------------------------------------

_BIN_OPS = {
    "Add": "+", "Subtract": "-", "Multiply": "*", "Divide": "/",
    "Remainder": "%", "EqualTo": "==", "LessThan": "<",
    "LessThanOrEqual": "<=", "GreaterThan": ">", "GreaterThanOrEqual": ">=",
    "BitwiseAnd": "&", "BitwiseOr": "|", "BitwiseXor": "^",
    "ShiftLeft": "<<", "ShiftRight": ">>",
}


def _binary(fe, conv):
    if fe.name in ("Add", "Subtract", "Multiply", "Divide") and \
            _dt(fe).is_decimal and not conf.get("auron.decimal.arith.enable"):
        raise NotConvertible("decimal arithmetic disabled by conf")
    return E.BinaryExpr(left=conv(fe.children[0]), op=_BIN_OPS[fe.name],
                        right=conv(fe.children[1]))


for _n in _BIN_OPS:
    _CONVERTERS[_n] = _binary


@_reg("And")
def _and(fe, conv):
    return E.ScAnd(left=conv(fe.children[0]), right=conv(fe.children[1]))


@_reg("Or")
def _or(fe, conv):
    return E.ScOr(left=conv(fe.children[0]), right=conv(fe.children[1]))


@_reg("Not")
def _not(fe, conv):
    return E.Not(child=conv(fe.children[0]))


@_reg("UnaryMinus")
def _neg(fe, conv):
    return E.Negative(child=conv(fe.children[0]))


@_reg("IsNull")
def _is_null(fe, conv):
    return E.IsNull(child=conv(fe.children[0]))


@_reg("IsNotNull")
def _is_not_null(fe, conv):
    return E.IsNotNull(child=conv(fe.children[0]))


@_reg("EqualNullSafe")
def _eq_null_safe(fe, conv):
    l, r = conv(fe.children[0]), conv(fe.children[1])
    both_null = E.ScAnd(left=E.IsNull(child=l), right=E.IsNull(child=r))
    neither = E.ScAnd(left=E.IsNotNull(child=l), right=E.IsNotNull(child=r))
    eq = E.ScAnd(left=neither, right=E.BinaryExpr(left=l, op="==", right=r))
    return E.ScOr(left=both_null, right=eq)


@_reg("In", "InSet")
def _in(fe, conv):
    if fe.name == "InSet":
        vals = tuple(E.Literal(value=v, dtype=_dt(fe.children[0]))
                     for v in fe.attrs.get("hset", ()))
    else:
        vals = tuple(conv(c) for c in fe.children[1:])
    return E.InList(child=conv(fe.children[0]), values=vals,
                    negated=bool(fe.attrs.get("negated", False)))


@_reg("If")
def _if(fe, conv):
    return E.Case(
        branches=(E.WhenThen(when=conv(fe.children[0]),
                             then=conv(fe.children[1])),),
        else_expr=conv(fe.children[2]))


@_reg("CaseWhen")
def _case_when(fe, conv):
    cs = fe.children
    has_else = len(cs) % 2 == 1
    pairs = cs[:-1] if has_else else cs
    branches = tuple(
        E.WhenThen(when=conv(pairs[i]), then=conv(pairs[i + 1]))
        for i in range(0, len(pairs), 2))
    return E.Case(branches=branches,
                  else_expr=conv(cs[-1]) if has_else else None)


@_reg("Like")
def _like(fe, conv):
    return _missing("like")


def _literal_value(fe, what: str):
    """The native string predicates take a constant pattern (the reference
    converts only literal-pattern StartsWith/EndsWith/Contains,
    NativeConverters.scala); a non-literal must fall back, not silently
    become a constant."""
    if fe.name != "Literal":
        raise NotConvertible(f"{what} requires a literal argument, "
                             f"got {fe.name}")
    return fe.value


@_reg("StartsWith")
def _starts(fe, conv):
    _literal_value(fe.children[1], "StartsWith prefix")
    return _missing("string_starts_with")


@_reg("EndsWith")
def _ends(fe, conv):
    _literal_value(fe.children[1], "EndsWith suffix")
    return _missing("string_ends_with")


@_reg("Contains")
def _contains(fe, conv):
    _literal_value(fe.children[1], "Contains infix")
    return _missing("string_contains")


# -- simple function-name mappings ------------------------------------------

_SIMPLE_FNS = {
    # math (NativeConverters.scala:826-893)
    "Sqrt": "sqrt", "Sin": "sin", "Cos": "cos", "Tan": "tan", "Asin": "asin",
    "Acos": "acos", "Acosh": "acosh", "Atan": "atan", "Atan2": "atan2",
    "Exp": "exp", "Expm1": "expm1", "Signum": "signum", "Pow": "power",
    "Log2": "log2", "Log10": "log10", "Log": "ln", "Logarithm": "log",
    "Hex": "hex", "Unhex": "unhex", "Factorial": "factorial",
    "IsNaN": "is_nan", "Least": "least", "Greatest": "greatest",
    "Floor": "floor", "Ceil": "ceil", "Abs": "abs",
    "NormalizeNaNAndZero": "normalize_nan_and_zero",
    "UnscaledValue": "unscaled_value",
    # conditional
    "Coalesce": "coalesce", "Nvl": "nvl", "Nvl2": "nvl2", "NullIf": "null_if",
    # strings
    "Lower": "lower", "Upper": "upper", "StringTrim": "trim",
    "StringTrimLeft": "ltrim", "StringTrimRight": "rtrim",
    "StringRepeat": "repeat", "StringSpace": "string_space",
    "StringLPad": "lpad", "StringRPad": "rpad",
    "StringTranslate": "translate", "StringReplace": "replace",
    "InitCap": "initcap", "Levenshtein": "levenshtein",
    "FindInSet": "find_in_set", "Ascii": "ascii", "BitLength": "bit_length",
    "OctetLength": "octet_length", "Chr": "chr", "Reverse": "reverse",
    "Length": "character_length", "Concat": "concat", "ConcatWs": "concat_ws",
    "Substring": "substr", "StringInstr": "strpos",
    "SplitPart": "split_part", "StringSplit": "string_split",
    "RegExpReplace": "regexp_replace", "RegExpExtract": "regexp_extract",
    # datetime
    "MakeDate": "make_date", "Year": "year", "Quarter": "quarter",
    "Month": "month", "DayOfMonth": "day", "DayOfWeek": "day_of_week",
    "WeekOfYear": "week_of_year", "MonthsBetween": "months_between",
    "DateAdd": "date_add", "DateSub": "date_sub", "DateDiff": "datediff",
    "LastDay": "last_day", "NextDay": "next_day",
    "UnixTimestamp": "unix_timestamp", "FromUnixTime": "from_unixtime",
    "TruncDate": "trunc", "TruncTimestamp": "date_trunc",
    # hashes / crypto
    "Md5": "md5", "Crc32": "crc32",
    # json
    "GetJsonObject": "get_json_object",
    # collections
    "CreateArray": "make_array", "CreateMap": "map",
    "MapFromArrays": "map_from_arrays", "StringToMap": "str_to_map",
    "MapConcat": "map_concat", "MapFromEntries": "map_from_entries",
    "SortArray": "sort_array", "Size": "size", "ElementAt": "element_at",
    "ArrayUnion": "array_union",
    # spark numerics
    "MakeDecimal": "make_decimal", "CheckOverflow": "check_overflow",
    "Bin": "bin",
}


def _simple_fn(fe, conv):
    name = _SIMPLE_FNS[fe.name]
    if fe.name in ("Lower", "Upper") and \
            not conf.get("auron.caseconvert.functions.enable"):
        raise NotConvertible("case-convert functions disabled by conf")
    if fe.name in ("MakeDecimal", "CheckOverflow") and \
            not conf.get("auron.decimal.arith.enable"):
        raise NotConvertible("decimal arithmetic disabled by conf")
    return _fn(name, fe, conv)


for _n in _SIMPLE_FNS:
    _CONVERTERS[_n] = _simple_fn


@_reg("Hour", "Minute", "Second")
def _dt_extract(fe, conv):
    if not conf.get("auron.datetime.extract.enable"):
        raise NotConvertible("datetime extract disabled by conf")
    return _fn(fe.name.lower(), fe, conv)


@_reg("Round")
def _round(fe, conv):
    return _fn("round", fe, conv)


@_reg("BRound")
def _bround(fe, conv):
    return _fn("bround", fe, conv)


@_reg("Sha2")
def _sha2(fe, conv):
    bits = _literal_value(fe.children[1], "Sha2 bit length") \
        if len(fe.children) > 1 else 256
    name = {0: "sha256", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}.get(bits)
    if name is None:
        raise NotConvertible(f"sha2 bit length {bits}")
    return _fn(name, fe, conv, args=fe.children[:1])


@_reg("Murmur3Hash")
def _murmur3(fe, conv):
    seed = fe.attrs.get("seed", 42)
    return E.ScalarFunctionCall(
        name="murmur3_hash",
        args=tuple(conv(c) for c in fe.children) +
             (E.Literal(value=int(seed), dtype=DataType.int32()),),
        return_type=_dt(fe))


@_reg("XxHash64")
def _xxhash(fe, conv):
    seed = fe.attrs.get("seed", 42)
    return E.ScalarFunctionCall(
        name="xxhash64",
        args=tuple(conv(c) for c in fe.children) +
             (E.Literal(value=int(seed), dtype=DataType.int64()),),
        return_type=_dt(fe))


@_reg("GetArrayItem")
def _get_array_item(fe, conv):
    return _missing("get_indexed_field")


@_reg("GetStructField")
def _get_struct_field(fe, conv):
    return _missing("get_indexed_field")


@_reg("GetMapValue")
def _get_map_value(fe, conv):
    return _missing("get_map_value")


@_reg("CreateNamedStruct")
def _named_struct(fe, conv):
    return _missing("named_struct")


@_reg("BloomFilterMightContain")
def _bloom_might_contain(fe, conv):
    return _missing("bloom_filter_might_contain")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def convert_expr(fe: ForeignExpr) -> Expr:
    """Strict conversion: NotConvertible on any unsupported node
    (the dry-run path the convert strategy uses)."""
    fn = _CONVERTERS.get(fe.name)
    if fn is None:
        raise NotConvertible(f"expression {fe.name} is not supported yet")
    return fn(fe, convert_expr)


def convert_expr_with_fallback(fe: ForeignExpr) -> Expr:
    """Conversion with per-node UDF fallback
    (NativeConverters.convertExprWithFallback:325-393): an unconvertible
    node that carries a pickled python evaluator becomes, in the JAX
    package, a PyUdfWrapper over its children, which the port lacks
    (NotConvertible naming it).  A kind the port lacks keeps its own
    message; any other failure gives the JAX package's."""
    def conv(c: ForeignExpr) -> Expr:
        return convert_expr_with_fallback(c)

    fn = _CONVERTERS.get(fe.name)
    missing = None
    if fn is not None:
        try:
            return fn(fe, conv)
        except _MissingKind as e:
            missing = e
        except NotConvertible:
            pass
    if fe.py_fn is not None:
        # the JAX package wraps it (auron.udf.fallback.enable); the port
        # has no wrapper yet, so such an expression stays foreign
        if fe.dtype is None:
            raise NotConvertible(
                f"fallback for {fe.name} requires a declared result type")
        return _missing("py_udf_wrapper")
    if missing is not None:
        raise missing
    raise NotConvertible(f"expression {fe.name} is not supported yet")


def convert_sort_order(fe: ForeignExpr) -> SortExpr:
    if fe.name != "SortOrder":
        raise NotConvertible(f"expected SortOrder, got {fe.name}")
    return SortExpr(child=convert_expr_with_fallback(fe.children[0]),
                    asc=bool(fe.attrs.get("asc", True)),
                    nulls_first=bool(fe.attrs.get("nulls_first",
                                                  fe.attrs.get("asc", True))))


# aggregate functions (NativeConverters.convertAggregateExpr:1228-1353)
_AGG_FNS = {
    "Max": "max", "Min": "min", "Sum": "sum", "Average": "avg",
    "StddevSamp": "stddev_samp", "VarianceSamp": "var_samp",
    "Count": "count", "First": "first", "CollectList": "collect_list",
    "CollectSet": "collect_set", "BloomFilterAggregate": "bloom_filter",
    "BrickhouseCollect": "brickhouse_collect",
    "BrickhouseCombineUnique": "brickhouse_combine_unique",
}


def convert_agg_expr(fe: ForeignExpr) -> AggExpr:
    """Foreign AggregateExpression node -> AggExpr.  Shape:
    ForeignExpr("AggregateExpression", children=(fn_node,),
    attrs={distinct}); fn_node.name in _AGG_FNS (or carries py_fn for the
    UDAF fallback, the SparkUDAFWrapper analogue)."""
    if fe.name != "AggregateExpression":
        raise NotConvertible(f"expected AggregateExpression, got {fe.name}")
    agg = fe.children[0]
    distinct = bool(fe.attrs.get("distinct", False))
    if distinct:
        # the engine has no device distinct accumulation; Spark's
        # optimizer rewrites distinct aggregates into two-level group-bys
        # (RewriteDistinctAggregates) before plans reach the converter, so
        # a surviving distinct flag means an unexpected plan shape — fall
        # back rather than silently computing the non-distinct value
        raise NotConvertible("distinct aggregates are not converted")
    if agg.name in _AGG_FNS:
        fn = _AGG_FNS[agg.name]
        if agg.name == "First" and agg.attrs.get("ignore_nulls"):
            fn = "first_ignores_null"
        return AggExpr(
            fn=fn,
            children=tuple(convert_expr_with_fallback(c)
                           for c in agg.children),
            return_type=_dt(agg), distinct=distinct)
    if agg.py_fn is not None:
        return _missing("udaf")
    raise NotConvertible(f"aggregate {agg.name} is not supported yet")


_JOIN_TYPES = {
    "Inner": "inner", "FullOuter": "full", "LeftOuter": "left",
    "RightOuter": "right", "LeftSemi": "left_semi", "LeftAnti": "left_anti",
    "RightSemi": "right_semi", "RightAnti": "right_anti",
    "ExistenceJoin": "existence", "Cross": "inner",
}


def convert_join_type(name: str) -> str:
    """NativeConverters.convertJoinType:1356 analogue."""
    if name not in _JOIN_TYPES:
        raise NotConvertible(f"join type {name} is not supported yet")
    return _JOIN_TYPES[name]
