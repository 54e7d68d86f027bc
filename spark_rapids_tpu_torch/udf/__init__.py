"""UDF tier of the port (port of the JAX package's ``udf/``).

``udf(f)`` walks the function's AST (udf/compiler.py) and translates a
restricted subset — arithmetic, comparisons, boolean logic,
conditionals, math/string builtins — into the engine's Column DSL, so a
compiled UDF is indistinguishable from native expressions and runs on
the card. When compilation fails, the call still works: it produces a
``pyudf`` expression (exprs/pyudf.py) that evaluates the original Python
function over host-side column values with a device roundtrip (the
GpuArrowEvalPythonExec pattern), and the planner's explain output carries
the compile-failure reason.
"""

from spark_rapids_tpu_torch.udf.compiler import (
    UdfCompileError, compile_udf, udf)

__all__ = ["udf", "compile_udf", "UdfCompileError"]
