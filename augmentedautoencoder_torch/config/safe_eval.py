"""Restricted expression evaluator for .cfg values.

Replaces the reference's pervasive `eval()` of config strings
(auto_pose/ae/ae_factory.py:35-37, auto_pose/ae/dataset.py:181-183,380-390)
with an AST whitelist. Supports the full grammar the reference templates use:

  * numbers, strings, booleans, None
  * lists / tuples, e.g. `[2, 2, 2, 2]`, `(720, 540)`
  * arithmetic, e.g. `[1075.65, 0, 720/2, ...]`
  * whitelisted names (np.pi, True/False)
  * whitelisted calls (augmenter constructors, np.random.rand)
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

_ALLOWED_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a**b,
}

_ALLOWED_UNARYOPS = {
    ast.USub: lambda a: -a,
    ast.UAdd: lambda a: +a,
}

#: Names resolvable without any caller-provided environment.
_BASE_ENV: Dict[str, Any] = {
    "True": True,
    "False": False,
    "None": None,
    "pi": np.pi,
}

#: Dotted names resolvable as constants / zero-arg-safe callables.
_BASE_DOTTED: Dict[str, Any] = {
    "np.pi": np.pi,
    "np.e": np.e,
    "np.random.rand": np.random.rand,  # reference quirk: sampled once at parse
                                        # (train_template.cfg:31)
    "np.random.uniform": np.random.uniform,
    "math.pi": np.pi,
}


class UnsafeExpressionError(ValueError):
    pass


def _dotted_name(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def safe_eval(
    expr: str,
    env: Optional[Mapping[str, Any]] = None,
    callables: Optional[Mapping[str, Callable]] = None,
) -> Any:
    """Evaluate `expr` under an AST whitelist.

    env:       extra bare names -> values
    callables: extra call targets, by bare or dotted name
    """
    names = dict(_BASE_ENV)
    if env:
        names.update(env)
    calls: Dict[str, Callable] = dict(_BASE_DOTTED)
    if callables:
        calls.update(callables)

    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as e:
        raise UnsafeExpressionError(f"cannot parse config expression: {expr!r}") from e

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, complex, str, bool, type(None))):
                return node.value
            raise UnsafeExpressionError(f"constant not allowed: {node.value!r}")
        if isinstance(node, (ast.List, ast.Tuple)):
            seq = [ev(e) for e in node.elts]
            return seq if isinstance(node, ast.List) else tuple(seq)
        if isinstance(node, ast.Dict):
            return {ev(k): ev(v) for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_BINOPS:
            return _ALLOWED_BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _ALLOWED_UNARYOPS:
            return _ALLOWED_UNARYOPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Name):
            if node.id in names:
                return names[node.id]
            if node.id in calls:
                return calls[node.id]
            raise UnsafeExpressionError(f"name not allowed: {node.id}")
        if isinstance(node, ast.Attribute):
            dotted = _dotted_name(node)
            if dotted is not None and dotted in calls:
                return calls[dotted]
            if dotted is not None and dotted in names:
                return names[dotted]
            raise UnsafeExpressionError(f"attribute not allowed: {dotted}")
        if isinstance(node, ast.Call):
            fn = None
            if isinstance(node.func, ast.Name) and node.func.id in calls:
                fn = calls[node.func.id]
            else:
                dotted = _dotted_name(node.func)
                if dotted is not None and dotted in calls:
                    fn = calls[dotted]
            if fn is None:
                raise UnsafeExpressionError(
                    f"call not allowed: {ast.dump(node.func)}"
                )
            args = [ev(a) for a in node.args]
            kwargs = {kw.arg: ev(kw.value) for kw in node.keywords if kw.arg}
            return fn(*args, **kwargs)
        raise UnsafeExpressionError(f"node not allowed: {type(node).__name__}")

    return ev(tree)
