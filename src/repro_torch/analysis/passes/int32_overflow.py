"""int32-overflow pass: products and accumulations narrowed to int32.

The vector/torch backends keep the whole tick state in int32 (an
intentional discipline — it is what makes the CUDA kernel and the
numpy path bit-compatible).  That makes silent wraparound the failure
mode: at fleet1024 scale a ``tick * n_lanes * requests``-shaped product
or a long ``cumsum`` can pass 2**31 while every operand is small.

Rules
-----
* ``INT32-CAST`` — an ``astype(int32)`` / ``np.int32(...)`` /
  ``jnp.int32(...)`` whose operand subtree contains multiplication,
  addition, or an accumulating call (``cumsum``/``sum``/``prod``/
  ``dot``/``matmul``): the arithmetic runs at a wider dtype (or
  overflows earlier) and the cast truncates the result.  Sites that
  clamp before casting suppress with a reason.
* ``INT32-PROD`` — ``acc += a * b`` where both factors mention
  scale-carrying names (tick/lane/rid/token/...): the classic
  ``vruntime += slice * weight``-style accumulator that only wraps
  after hours of simulated time.  Bare products are not flagged —
  one multiply of two in-range values is fine; the unbounded
  accumulation is what overflows.

Only serving/ and kernels/ are scanned by default (constructor takes
an alternative path-fragment tuple) — scale arithmetic lives there;
flagging every ``i * 2`` in launch scripts would be noise.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Rule
from repro_torch.analysis.framework import (AnalysisPass, ancestors, call_head,
                                      register_pass)

#: path fragments that select the files under scale discipline
DEFAULT_SCOPE = ("serving/", "kernels/")

#: calls that accumulate over an axis (overflow grows with length)
ACCUM_FNS = frozenset({"cumsum", "sum", "prod", "cumprod", "dot",
                       "matmul", "einsum"})

#: name substrings that mark a value as scaling with fleet/time size
SCALE_HINTS = ("tick", "rid", "vruntime", "lane", "token", "serv",
               "row", "step", "count", "total")


def _subtree_accumulates(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Mult,
                                                          ast.Add)):
            return True
        if isinstance(n, ast.Call):
            head = call_head(n)
            if head.split(".")[-1] in ACCUM_FNS:
                return True
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ACCUM_FNS:
                return True
    return False


def _scale_names(node):
    return {n.id.lower() for n in ast.walk(node)
            if isinstance(n, ast.Name)} | {
        n.attr.lower() for n in ast.walk(node)
        if isinstance(n, ast.Attribute)}


def _has_scale_hint(node) -> bool:
    names = _scale_names(node)
    return any(h in name for name in names for h in SCALE_HINTS)


@register_pass
class Int32OverflowPass(AnalysisPass):
    name = "int32-overflow"
    rules = (
        Rule("INT32-CAST", "warning",
             "arithmetic result narrowed to int32"),
        Rule("INT32-PROD", "warning",
             "scale-carrying product at int32"),
    )

    def __init__(self, scope=DEFAULT_SCOPE):
        super().__init__()
        self.scope = tuple(scope)

    def _in_scope(self, sfile) -> bool:
        path = sfile.path.as_posix()
        return any(frag in path for frag in self.scope)

    def run(self, project):
        out = []
        for sfile in project.files:
            if not self._in_scope(sfile):
                continue
            for node in ast.walk(sfile.tree):
                if isinstance(node, ast.Call):
                    out.extend(self._check_cast(sfile, node))
                elif isinstance(node, ast.BinOp) and isinstance(
                        node.op, ast.Mult):
                    out.extend(self._check_product(sfile, node))
        return out

    def _check_cast(self, sfile, node):
        """astype(...int32...) / np.int32(expr) / jnp.int32(expr)."""
        operand = None
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "astype":
            if any("int32" in ast.dump(a) for a in node.args) or any(
                    kw.value is not None and "int32" in ast.dump(kw.value)
                    for kw in node.keywords):
                operand = node.func.value
        else:
            head = call_head(node)
            if head.split(".")[-1] == "int32" and node.args:
                operand = node.args[0]
        if operand is None or not _subtree_accumulates(operand):
            return []
        return [self.finding(
            "INT32-CAST", sfile, node,
            "arithmetic feeds an int32 cast: the product/accumulation "
            "can exceed 2**31 at fleet1024 scale before truncation — "
            "clamp to a bound first or compute in int64 and check "
            "range (suppress with the clamp as the reason)")]

    def _check_product(self, sfile, node):
        """``acc += a * b`` where both factors carry scale hints."""
        if not (_has_scale_hint(node.left) and _has_scale_hint(node.right)):
            return []
        in_accum = any(
            isinstance(a, ast.AugAssign) and isinstance(a.op, ast.Add)
            for a in ancestors(node))
        if not in_accum:
            return []
        return [self.finding(
            "INT32-PROD", sfile, node,
            "accumulating a product of two scale-carrying values "
            "(ticks x lanes x requests grows past 2**31); bound one "
            "operand or widen the accumulator")]
