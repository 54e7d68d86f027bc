"""Spark physical-plan ingestion, the plugin-mode slice (port of the JAX
package's ``plan/spark_ingest.py``; ref SQLPlugin.scala:28-31,
Plugin.scala:50-57, GpuOverrides.scala:1991-2012).

The reference plugin receives live Catalyst plans inside the JVM. This
engine runs outside one, so plugin mode ingests a captured plan: the
text a user gets from ``df.explain()`` / ``queryExecution.executedPlan``
on their Spark cluster (Spark 3.x formatted physical plan). The ingester
parses the operator tree and its expression strings back into this
engine's logical plan, re-plans it, and runs it against local copies of
the scanned tables: each captured scan becomes a ``session.read`` of the
paths ``table_paths`` gives its table.

Supported operators (the scan/filter/project/agg/join/sort/limit slice):
  FileScan parquet/orc/csv, Filter, Project, HashAggregate (partial /
  final pairs collapse: the planner re-inserts its own two-stage split),
  Exchange (dropped, re-planned), Sort (kept only when not join/agg
  plumbing), SortMergeJoin, ShuffledHashJoin, BroadcastHashJoin,
  BroadcastExchange (dropped), GlobalLimit/LocalLimit,
  TakeOrderedAndProject.

Expressions: attribute refs (``name#id``), int/float/string/bool
literals, arithmetic (+,-,*,/,%), comparisons (=,<,<=,>,>=,<=>, !=),
AND/OR/NOT, isnull/isnotnull, CASE WHEN, cast, substring, IN-lists, and
the sum/min/max/avg/count aggregates (with ``partial_``/``merge_``
prefixes from two-stage plans).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import Column, col, lit_col, when


class SparkPlanParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tree extraction: indentation-based operator lines
# ---------------------------------------------------------------------------

_STAR_RE = re.compile(r"\*\(\d+\)\s*")
_NAME_START_RE = re.compile(r"[A-Za-z]\w*")


class _Node:
    def __init__(self, name: str, rest: str, depth: int):
        self.name = name
        self.rest = rest
        self.depth = depth
        self.children: List["_Node"] = []

    def __repr__(self):  # pragma: no cover - debug
        return f"_Node({self.name}, depth={self.depth})"


def _parse_tree(text: str) -> _Node:
    """Spark's formatted tree: each level adds a 3-char structural marker
    ('+- ', ':- ', ':  ', '   ') before the operator name; the codegen
    '*(n) ' star is cosmetic."""
    roots: List[_Node] = []
    stack: List[_Node] = []
    for raw in text.splitlines():
        line = _STAR_RE.sub("", raw.rstrip())
        if not line.strip() or line.lstrip().startswith("=="):
            continue
        m = _NAME_START_RE.search(line)
        if m is None:
            continue
        prefix = line[:m.start()]
        if prefix.strip(" :+-"):
            continue                      # not an operator line
        if m.start() % 3 != 0:
            # Looks like an operator line (structural-marker prefix) but
            # the indent is not a multiple of the 3-char marker width:
            # silently dropping it would drop an OPERATOR and produce
            # wrong results downstream (e.g. a vanished Filter).
            raise SparkPlanParseError(
                f"operator line has malformed indentation "
                f"(column {m.start()} is not a multiple of 3): {raw!r}")
        depth = len(prefix) // 3
        head = line[m.start():]
        name = _NAME_START_RE.match(head).group(0)
        node = _Node(name, head[len(name):].strip(), depth)
        while stack and stack[-1].depth >= depth:
            stack.pop()
        if stack:
            stack[-1].children.append(node)
        else:
            roots.append(node)
        stack.append(node)
    if not roots:
        raise SparkPlanParseError("no operator lines found")
    return roots[0]


# ---------------------------------------------------------------------------
# Expression parsing
# ---------------------------------------------------------------------------

class _ExprParser:
    """Recursive-descent parser over Spark's expression pretty-print."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def eat(self, tok: str) -> bool:
        self._ws()
        if self.s[self.i:self.i + len(tok)].upper() == tok.upper():
            self.i += len(tok)
            return True
        return False

    def expect(self, tok: str):
        if not self.eat(tok):
            raise SparkPlanParseError(
                f"expected {tok!r} at ...{self.s[self.i:self.i + 40]!r}")

    def parse(self) -> Column:
        e = self.expr()
        self._ws()
        if self.i < len(self.s):
            # Silent truncation would turn a half-understood expression
            # into wrong results; refuse instead.
            raise SparkPlanParseError(
                f"trailing text in expression: "
                f"{self.s[self.i:self.i + 40]!r} (full: {self.s!r})")
        return e

    # OR < AND < NOT < comparison < additive < multiplicative < unary
    def expr(self) -> Column:
        e = self.and_expr()
        while self.eat(" OR ") or self.eat("OR "):
            e = e | self.and_expr()
        return e

    def and_expr(self) -> Column:
        e = self.not_expr()
        while True:
            self._ws()
            if self.s[self.i:self.i + 4].upper() == "AND ":
                self.i += 4
                e = e & self.not_expr()
            else:
                return e

    def not_expr(self) -> Column:
        self._ws()
        if self.s[self.i:self.i + 4].upper() == "NOT ":
            self.i += 4
            return ~self.not_expr()
        return self.cmp_expr()

    def cmp_expr(self) -> Column:
        e = self.add_expr()
        self._ws()
        for op in ("<=>", "<=", ">=", "!=", "=", "<", ">"):
            if self.s[self.i:self.i + len(op)] == op:
                self.i += len(op)
                rhs = self.add_expr()
                if op == "=":
                    return e == rhs
                if op == "!=":
                    return e != rhs
                if op == "<=":
                    return e <= rhs
                if op == ">=":
                    return e >= rhs
                if op == "<":
                    return e < rhs
                if op == ">":
                    return e > rhs
                if op == "<=>":     # null-safe equal ~= equal for ingest
                    return e == rhs
        if self.eat(" IN (") or self.eat("IN ("):
            vals = []
            while not self.eat(")"):
                v = self.primary()
                vals.append(v.node[1])
                self.eat(",")
            return e.isin(*vals)
        return e

    def add_expr(self) -> Column:
        e = self.mul_expr()
        while True:
            self._ws()
            c = self.peek()
            if c == "+":
                self.i += 1
                e = e + self.mul_expr()
            elif c == "-" and not self.s[self.i + 1:self.i + 2].isdigit():
                self.i += 1
                e = e - self.mul_expr()
            else:
                return e

    def mul_expr(self) -> Column:
        e = self.unary()
        while True:
            self._ws()
            c = self.peek()
            if c == "*":
                self.i += 1
                e = e * self.unary()
            elif c == "/":
                self.i += 1
                e = e / self.unary()
            elif c == "%":
                self.i += 1
                e = e % self.unary()
            else:
                return e

    def unary(self) -> Column:
        self._ws()
        if self.peek() == "-" and not self.s[self.i + 1:self.i + 2] \
                .isdigit():
            self.i += 1
            return -self.unary()
        return self.primary()

    _NAME_RE = re.compile(r"[A-Za-z_][\w.]*")

    def primary(self) -> Column:
        self._ws()
        c = self.peek()
        if c == "(":
            self.i += 1
            e = self.expr()
            self.expect(")")
            return e
        if c.isdigit() or (c == "-" and
                           self.s[self.i + 1:self.i + 2].isdigit()):
            return lit_col(self._number())
        if c in "'\"":
            return lit_col(self._string(c))
        m = self._NAME_RE.match(self.s, self.i)
        if not m:
            raise SparkPlanParseError(
                f"cannot parse expression at "
                f"...{self.s[self.i:self.i + 40]!r}")
        name = m.group(0)
        self.i = m.end()
        low = name.lower()
        # attribute ref: name#123 (optionally with L suffix)
        if self.peek() == "#":
            self.i += 1
            while self.i < len(self.s) and \
                    (self.s[self.i].isdigit() or self.s[self.i] == "L"):
                self.i += 1
            return col(name)
        if self.peek() == "(":
            self.i += 1
            return self._call(low)
        if low == "true":
            return lit_col(True)
        if low == "false":
            return lit_col(False)
        if low == "null":
            return lit_col(None)
        if low == "case":
            return self._case_tail()
        # A bare word inside a physical-plan expression is an UNQUOTED
        # string literal (Spark prints `c_mktsegment#3 = BUILDING`);
        # every attribute reference carries its #exprId. Multi-word
        # literals extend across following bare words ("SM CASE").
        words = [name]
        while True:
            save = self.i
            self._ws()
            m2 = self._NAME_RE.match(self.s, self.i)
            if m2 and self.s[m2.end():m2.end() + 1] not in "#(" and \
                    m2.group(0).upper() not in ("AND", "OR", "NOT", "IN",
                                                "THEN", "ELSE", "END",
                                                "WHEN", "AS"):
                words.append(m2.group(0))
                self.i = m2.end()
            else:
                self.i = save
                break
        return lit_col(" ".join(words))

    def _args(self) -> List[Column]:
        args = []
        if self.eat(")"):
            return args
        while True:
            args.append(self.expr())
            if self.eat(")"):
                return args
            self.expect(",")

    def _call(self, fn: str) -> Column:
        if fn == "cast":
            e = self.expr()
            self.expect("as")
            self._ws()
            m = self._NAME_RE.match(self.s, self.i)
            ty = m.group(0).lower()
            self.i = m.end()
            self.expect(")")
            return e.cast(_SPARK_TYPES.get(ty, ty))
        if fn == "isnotnull":
            a = self._args()
            return a[0].isNotNull()
        if fn == "isnull":
            a = self._args()
            return a[0].isNull()
        if fn == "substring":
            a = self._args()
            return a[0].substr(a[1].node[1], a[2].node[1])
        agg_fn = fn
        distinct = False
        for pre in ("partial_", "merge_", "finalmerge_"):
            if agg_fn.startswith(pre):
                agg_fn = agg_fn[len(pre):]
        if agg_fn.startswith("distinct "):
            agg_fn = agg_fn[len("distinct "):]
            distinct = True
        if agg_fn in ("sum", "min", "max", "avg", "count", "first",
                      "last"):
            args = self._args()
            child = args[0] if args else None
            if agg_fn == "count" and child is not None and \
                    child.node == ("lit", 1):
                child = None
            tag = "aggd" if distinct else "agg"
            return Column((tag, agg_fn, child))
        if agg_fn in _FUNCS:
            return _FUNCS[agg_fn](*self._args())
        raise SparkPlanParseError(f"unsupported function {fn!r}")

    def _case_tail(self) -> Column:
        builder = None
        while True:
            self._ws()
            if self.eat("WHEN "):
                cond = self.expr()
                self.expect("THEN")
                val = self.expr()
                builder = when(cond, val) if builder is None \
                    else builder.when(cond, val)
            elif self.eat("ELSE "):
                other = self.expr()
                self.expect("END")
                return builder.otherwise(other)
            elif self.eat("END"):
                return builder.otherwise(None)
            else:
                raise SparkPlanParseError(
                    f"bad CASE at ...{self.s[self.i:self.i + 30]!r}")

    _DATE_RE = re.compile(r"\d{4}-\d{2}-\d{2}")

    def _number(self):
        # Spark prints date literals unquoted ('1995-01-01'); they must
        # not half-parse as the int 1995.
        dm = self._DATE_RE.match(self.s, self.i)
        if dm:
            import datetime
            y, mo, d = map(int, dm.group(0).split("-"))
            self.i = dm.end()
            return (datetime.date(y, mo, d)
                    - datetime.date(1970, 1, 1)).days
        m = re.match(r"-?\d+(\.\d+)?([eE]-?\d+)?", self.s[self.i:])
        tok = m.group(0)
        self.i += len(tok)
        # type suffixes: L (long), D (double), S/B
        suffix = self.s[self.i:self.i + 1]
        if suffix in "LDSB":
            self.i += 1
        if "." in tok or "e" in tok or "E" in tok or suffix == "D":
            return float(tok)
        return int(tok)

    def _string(self, q: str):
        self.i += 1
        j = self.s.index(q, self.i)
        out = self.s[self.i:j]
        self.i = j + 1
        return out


_SPARK_TYPES = {
    "int": "int", "bigint": "long", "smallint": "int", "tinyint": "int",
    "double": "double", "float": "float", "string": "string",
    "date": "date", "boolean": "boolean", "decimal": "double",
}

_FUNCS: Dict[str, callable] = {}


def _parse_expr(s: str) -> Column:
    return _ExprParser(s).parse()


def _split_top(s: str, sep: str = ",") -> List[str]:
    """Split on sep at bracket depth 0."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def _clean_name(attr: str) -> str:
    """'l_quantity#4L' -> 'l_quantity'; 'sum(x#1)#33' -> 'sum(x)'."""
    return re.sub(r"#\d+L?", "", attr).strip()


# ---------------------------------------------------------------------------
# Operator mapping
# ---------------------------------------------------------------------------

def ingest_spark_plan(text: str, session,
                      table_paths: Dict[str, Sequence[str]]):
    """Parse a captured Spark physical plan (df.explain() text) into a
    DataFrame on this engine. ``table_paths`` maps a table name (matched
    against the captured FileScan's Location substring) to local file
    paths for that table."""
    from spark_rapids_tpu_torch.api.dataframe import DataFrame
    root = _parse_tree(text)
    plan = _convert(root, session, table_paths)
    return DataFrame(session, plan)


def _convert(node: _Node, session, tables) -> L.LogicalPlan:
    name = node.name
    rest = node.rest

    def child(i=0) -> L.LogicalPlan:
        return _convert(node.children[i], session, tables)

    if name in ("Exchange", "BroadcastExchange", "ShuffleQueryStage",
                "BroadcastQueryStage", "AQEShuffleRead", "InputAdapter",
                "WholeStageCodegen", "ReusedExchange", "ColumnarToRow",
                "AdaptiveSparkPlan"):
        # Plumbing: this engine re-plans distribution itself.
        return child()
    if name == "FileScan" or (name == "Scan" and not node.children):
        # 'FileScan parquet [cols]' (3.0) / 'Scan parquet tbl[cols]' (3.2+)
        return _convert_scan(rest, session, tables)
    if name == "Filter":
        return L.LogicalFilter(child(), _parse_expr(_strip_brackets(rest)))
    if name == "Project":
        projections = []
        for item in _split_top(_strip_brackets(rest)):
            projections.append(_parse_named(item))
        return L.LogicalProject(child(), projections)
    if name == "HashAggregate" or name == "SortAggregate" or \
            name == "ObjectHashAggregate":
        return _convert_aggregate(node, session, tables)
    if name in ("SortMergeJoin", "ShuffledHashJoin", "BroadcastHashJoin"):
        return _convert_join(node, session, tables)
    if name == "Sort":
        orders = _parse_orders(_strip_brackets(rest))
        kid = child()
        # Sorts under SMJ plumbing never reach here (join drops them).
        return L.LogicalSort(kid, orders)
    if name in ("GlobalLimit", "LocalLimit", "CollectLimit"):
        n = int(re.search(r"\d+", rest).group(0))
        kid = child()
        if name == "LocalLimit" and node.children and \
                node.children[0].name == "GlobalLimit":
            return kid
        return L.LogicalLimit(kid, n)
    if name == "TakeOrderedAndProject":
        m = re.search(r"limit=(\d+),\s*orderBy=\[(.*?)\],\s*"
                      r"output=\[(.*?)\]", rest)
        if not m:
            raise SparkPlanParseError(f"bad TakeOrderedAndProject: {rest}")
        limit, order_s, out_s = m.groups()
        kid = child()
        orders = _parse_orders(order_s)
        sort = L.LogicalSort(kid, orders)
        lim = L.LogicalLimit(sort, int(limit))
        projections = [_parse_named(x) for x in _split_top(out_s)]
        return L.LogicalProject(lim, projections)
    raise SparkPlanParseError(f"unsupported Spark operator {name!r}")


def _strip_brackets(s: str) -> str:
    s = s.strip()
    if s[:1] in "([" and s[-1:] in ")]":
        return s[1:-1]
    return s


def _parse_named(item: str) -> Tuple[str, Column]:
    """'(x#1 * 2) AS y#9' or bare 'l_orderkey#0L'."""
    m = re.search(r"\s+AS\s+([A-Za-z_]\w*(?:\(\w*\))?)#\d+L?$", item)
    if m:
        return m.group(1), _parse_expr(item[:m.start()])
    return _clean_name(item), _parse_expr(item)


def _parse_orders(s: str) -> List[Column]:
    orders = []
    for item in _split_top(s):
        m = re.match(r"(.*?)\s+(ASC|DESC)\s+NULLS\s+(FIRST|LAST)$",
                     item.strip())
        if m:
            e = _parse_expr(m.group(1))
            e = e.asc() if m.group(2) == "ASC" else e.desc()
        else:
            e = _parse_expr(item).asc()
        orders.append(e)
    return orders


def _convert_scan(rest: str, session, tables) -> L.LogicalPlan:
    m = re.match(r"(\w+)\s+\[(.*?)\]", rest)
    if not m:
        raise SparkPlanParseError(f"bad FileScan: {rest}")
    fmt, cols_s = m.groups()
    loc = re.search(r"Location:\s*\S*\[([^\]]*)\]", rest)
    location = loc.group(1) if loc else ""
    table = None
    for tname in tables:
        if tname in location or tname in rest:
            table = tname
            break
    if table is None:
        raise SparkPlanParseError(
            f"no local paths for scan location {location!r} "
            f"(have {list(tables)})")
    paths = tables[table]
    df = getattr(session.read, fmt.lower())(*list(paths))
    want = [_clean_name(c) for c in _split_top(cols_s)]
    have = set(df.columns)
    missing = [c for c in want if c not in have]
    if missing:
        # The captured plan scans columns the local file does not have:
        # silently filtering them out would execute a DIFFERENT query
        # (downstream operators reference the missing attrs or, worse,
        # quietly lose them).
        raise SparkPlanParseError(
            f"scan of table {table!r} wants columns {missing} that the "
            f"local {fmt} data lacks (file has {sorted(have)})")
    if want and set(want) != have:
        df = df.select(*want)
    return df._plan


def _is_partial_agg(node: _Node) -> bool:
    return "partial_" in node.rest


def _convert_aggregate(node: _Node, session, tables) -> L.LogicalPlan:
    rest = node.rest
    if _is_partial_agg(node):
        # Partial half of a two-stage pair: the FINAL node rebuilds the
        # whole aggregate over this node's input (this planner re-splits).
        return _convert(node.children[0], session, tables)
    keys_m = re.search(r"keys=\[(.*?)\]", rest)
    fns_m = re.search(r"functions=\[(.*?)\]", rest)
    out_m = re.search(r"output=\[(.*?)\]", rest)
    if fns_m is None:
        raise SparkPlanParseError(f"bad HashAggregate: {rest}")
    group_by = []
    if keys_m and keys_m.group(1).strip():
        for k in _split_top(keys_m.group(1)):
            group_by.append((_clean_name(k), _parse_expr(k)))
    fns = [f for f in _split_top(fns_m.group(1)) if f]
    # The output list names the user-visible attrs (keys first, then one
    # per aggregate) — downstream operators reference THOSE names.
    out_names = [_clean_name(o) for o in _split_top(out_m.group(1))] \
        if out_m else []
    aggs = []
    for i, f in enumerate(fns):
        oi = len(group_by) + i
        name_i = out_names[oi] if oi < len(out_names) else _clean_name(f)
        aggs.append((name_i, _parse_expr(f)))
    return L.LogicalAggregate(_convert(node.children[0], session, tables),
                              group_by, aggs)


def _convert_join(node: _Node, session, tables) -> L.LogicalPlan:
    rest = node.rest
    parts = _split_top(_strip_outer(rest))
    if len(parts) < 3:
        raise SparkPlanParseError(f"bad join: {rest}")
    lkeys = [_parse_expr(k) for k in _split_top(_strip_brackets(parts[0]))]
    rkeys = [_parse_expr(k) for k in _split_top(_strip_brackets(parts[1]))]
    jtype = parts[2].strip().lower()
    jtype = {"inner": "inner", "leftouter": "left", "rightouter": "right",
             "fullouter": "full", "leftsemi": "semi", "leftanti": "anti",
             "cross": "cross"}.get(jtype, jtype)
    cond = None
    for extra in parts[3:]:
        extra = extra.strip()
        if extra in ("", "BuildRight", "BuildLeft", "false", "true"):
            continue        # build-side marker / isSkewJoin flag
        cond = _parse_expr(extra)
        break
    kids = []
    for c in node.children:
        # Drop per-side Sort/Exchange plumbing under SMJ.
        while c.name in ("Sort", "Exchange", "InputAdapter",
                         "BroadcastExchange", "ColumnarToRow"):
            c = c.children[0]
        kids.append(_convert(c, session, tables))
    strategy = "broadcast" if node.name == "BroadcastHashJoin" else "auto"
    return L.LogicalJoin(kids[0], kids[1], lkeys, rkeys, jtype, cond,
                         strategy)


def _strip_outer(s: str) -> str:
    """Join rest: '[k1#1], [k2#2], Inner' or with surrounding brackets."""
    return s.strip()
