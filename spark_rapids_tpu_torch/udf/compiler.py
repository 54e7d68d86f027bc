"""Python-AST -> Column-DSL UDF compiler (port of the JAX package's
``udf/compiler.py``; CatalystExpressionBuilder analog, whose original
walks JVM bytecode, udf-compiler/.../Instruction.scala:1).

``compile_udf(f)`` returns a builder ``(*arg_columns) -> Column`` or
raises ``UdfCompileError`` naming the unsupported construct. ``udf(f)``
wraps that into a callable usable anywhere a Column is: compiled UDFs
become native expressions; uncompilable ones degrade to a host-evaluated
``pyudf`` expression with the failure reason attached (surfaced by
explain, the willNotWorkOnGpu discipline).

The subset, its error texts and the freezing of captured literals at
compile time are the reference's, unchanged, and so is the order of its
checks: ``udf`` checks the source, the parameters, the captures and the
single ``return`` up front; the body is walked when the UDF is applied to
columns, so a construct outside the subset there raises UdfCompileError
at that call. A compiled UDF has the engine's semantics, not Python's:
``%`` is ``Remainder`` (the dividend's sign), ``/`` is ``Divide`` (NULL
on a zero divisor), ``round`` is ``round_col`` (HALF_UP), ``.strip()`` is
``trim`` (spaces only), ``min`` / ``max`` are ``least`` / ``greatest``
(NULLs skipped), and NULL arguments give NULL where Python would
raise."""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, List, Optional

from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.logical import Column, _as_col


class UdfCompileError(ValueError):
    """The function uses constructs outside the compilable subset."""


_BINOPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul", ast.Div: "div",
    ast.Mod: "mod",
}
_CMPOPS = {
    ast.Lt: "lt", ast.LtE: "le", ast.Gt: "gt", ast.GtE: "ge",
    ast.Eq: "eq",
}

# Supported calls: name -> (arity, Column builder).
_CALLS = {
    "abs": (1, L.abs_col),
    "min": (2, lambda a, b: L.least(a, b)),
    "max": (2, lambda a, b: L.greatest(a, b)),
    "round": (1, L.round_col),
    "len": (1, L.length),
}
# Supported method calls on string-ish values.
_METHODS = {
    "upper": L.upper,
    "lower": L.lower,
    "strip": L.trim,
    "lstrip": L.ltrim,
    "rstrip": L.rtrim,
}


def _function_ast(f: Callable) -> ast.AST:
    try:
        src = textwrap.dedent(inspect.getsource(f))
    except (OSError, TypeError) as e:
        raise UdfCompileError(f"source unavailable: {e}")
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # A lambda in the middle of a call expression: isolate it.
        start = src.index("lambda")
        depth = 0
        end = len(src)
        for i, ch in enumerate(src[start:], start):
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                if depth == 0:
                    end = i
                    break
                depth -= 1
            elif ch == "," and depth == 0:
                end = i
                break
        tree = ast.parse(src[start:end].strip(), mode="eval")
    for node in ast.walk(tree):
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return node
    raise UdfCompileError("no function definition found in source")


class _Compiler(ast.NodeVisitor):
    def __init__(self, params: List[str], env: dict):
        self.params = params
        self.env = env

    def compile(self, node: ast.AST) -> Column:
        return self.visit(node)

    # -- structure ------------------------------------------------------
    def visit_Return(self, node: ast.Return) -> Column:
        if node.value is None:
            raise UdfCompileError("bare return")
        return self.visit(node.value)

    def visit_IfExp(self, node: ast.IfExp) -> Column:
        cond = self.visit(node.test)
        return L.when(cond, self.visit(node.body)) \
            .otherwise(self.visit(node.orelse))

    # -- leaves ---------------------------------------------------------
    def visit_Name(self, node: ast.Name) -> Column:
        if node.id in self.env:
            return self.env[node.id]
        raise UdfCompileError(f"unresolved name {node.id!r}")

    def visit_Constant(self, node: ast.Constant) -> Column:
        if node.value is None:
            raise UdfCompileError("None literal (use SQL null semantics "
                                  "via engine functions)")
        if isinstance(node.value, (bool, int, float, str)):
            return L.lit_col(node.value)
        raise UdfCompileError(
            f"unsupported constant {type(node.value).__name__}")

    # -- operators ------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp) -> Column:
        if isinstance(node.op, ast.Pow):
            return L.pow_col(self.visit(node.left),
                             self.visit(node.right))
        kind = _BINOPS.get(type(node.op))
        if kind is None:
            raise UdfCompileError(
                f"operator {type(node.op).__name__}")
        return Column((kind, self.visit(node.left),
                       self.visit(node.right)))

    def visit_UnaryOp(self, node: ast.UnaryOp) -> Column:
        v = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
        if isinstance(node.op, ast.Not):
            return ~v
        raise UdfCompileError(f"operator {type(node.op).__name__}")

    def visit_Compare(self, node: ast.Compare) -> Column:
        parts = []
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            lcol = self.visit(left)
            rcol = self.visit(right)
            if isinstance(op, ast.NotEq):
                parts.append(~(lcol == rcol))
            else:
                kind = _CMPOPS.get(type(op))
                if kind is None:
                    raise UdfCompileError(
                        f"comparison {type(op).__name__}")
                parts.append(Column((kind, lcol, rcol)))
            left = right
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out

    def visit_BoolOp(self, node: ast.BoolOp) -> Column:
        vals = [self.visit(v) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(node.op, ast.And) else (out | v)
        return out

    # -- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> Column:
        if node.keywords:
            raise UdfCompileError("keyword arguments in call")
        if isinstance(node.func, ast.Name):
            spec = _CALLS.get(node.func.id)
            if spec is None:
                raise UdfCompileError(f"call to {node.func.id!r}")
            arity, builder = spec
            if len(node.args) != arity:
                raise UdfCompileError(
                    f"{node.func.id}() expects {arity} args")
            return builder(*[self.visit(a) for a in node.args])
        if isinstance(node.func, ast.Attribute):
            builder = _METHODS.get(node.func.attr)
            if builder is None or node.args:
                raise UdfCompileError(
                    f"method .{node.func.attr}()")
            return builder(self.visit(node.func.value))
        raise UdfCompileError("computed call target")

    def generic_visit(self, node):
        raise UdfCompileError(f"syntax {type(node).__name__}")


def compile_udf(f: Callable) -> Callable[..., Column]:
    """Compile ``f`` into a Column-builder or raise UdfCompileError."""
    fn_node = _function_ast(f)
    args = fn_node.args
    if args.vararg or args.kwarg or args.kwonlyargs or args.defaults:
        raise UdfCompileError("only plain positional parameters")
    params = [a.arg for a in args.args]
    # Captured variables inline as constants FROZEN AT COMPILE TIME (the
    # reference's bytecode compiler does the same for lambda captures);
    # anything non-literal is rejected up front.
    captured = {}
    try:
        cv = inspect.getclosurevars(f)
        free = dict(cv.nonlocals)
        free.update({k: v for k, v in cv.globals.items()})
        unbound = set(cv.unbound)
    except TypeError:
        free, unbound = {}, set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load) and \
                node.id not in params and node.id not in _CALLS:
            if node.id in free:
                v = free[node.id]
                if isinstance(v, (bool, int, float, str)):
                    captured[node.id] = L.lit_col(v)
                else:
                    raise UdfCompileError(
                        f"captured variable {node.id!r} is not a "
                        "literal constant")
            elif node.id in unbound:
                raise UdfCompileError(f"free variable {node.id!r}")
    if isinstance(fn_node, ast.Lambda):
        body: ast.AST = fn_node.body
    else:
        stmts = [s for s in fn_node.body
                 if not isinstance(s, ast.Expr)     # skip docstring
                 or not isinstance(s.value, ast.Constant)]
        if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
            raise UdfCompileError(
                "function body must be a single return statement")
        body = stmts[0]

    def build(*cols) -> Column:
        if len(cols) != len(params):
            raise TypeError(
                f"udf takes {len(params)} args, got {len(cols)}")
        env = dict(captured)
        env.update({p: _as_col(c) for p, c in zip(params, cols)})
        return _Compiler(params, env).compile(body)

    build.__name__ = getattr(f, "__name__", "udf")
    return build


def udf(f: Optional[Callable] = None, return_type=None):
    """pyspark-style ``udf``: compiled to native expressions when the AST
    subset allows, host-evaluated ``pyudf`` expression otherwise (with the
    compile failure surfaced in explain)."""
    if f is None:
        return lambda g: udf(g, return_type)
    try:
        build = compile_udf(f)
        reason = None
    except UdfCompileError as e:
        build = None
        reason = str(e)

    def call(*cols) -> Column:
        if build is not None:
            return build(*cols)
        from spark_rapids_tpu_torch.columnar import dtypes as dt
        rt = return_type or dt.FLOAT64
        rt = dt.type_named(rt) if isinstance(rt, str) else rt
        return Column(("pyudf", f, rt,
                       tuple(_as_col(c) for c in cols), reason))

    call.compiled = build is not None
    call.compile_error = reason
    call.func = f
    return call
