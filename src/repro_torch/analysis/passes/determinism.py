"""Determinism pass: the bug classes that silently break the
tick == vector == torch == DES equal-trace claim on some future seed.

Rules
-----
* ``DET-SEED`` — ``random.*`` / legacy ``np.random.*`` global-state
  calls.  All repo randomness must flow through a seeded
  ``np.random.default_rng`` (or a seeded ``torch.Generator``): global-state draws
  depend on import order and interleaving, so two backends stepping the
  same workload can diverge.
* ``DET-SET-ITER`` — ``for``/comprehension iteration directly over a
  ``set`` expression (literal, ``set(...)`` call, set algebra, or a
  local assigned one).  Set iteration order is hash-order; feeding it
  into ordered scheduler state (queues, picks, event emission) is
  exactly the Kaffes-style hidden nondeterminism this suite exists to
  catch.  Wrap in ``sorted(...)`` or iterate the ordered source.
* ``DET-FLOAT-EQ`` — ``==`` / ``!=`` against a float literal.  Float
  equality as a scheduling predicate flips on rounding differences
  between backends.
* ``DET-ID-ORDER`` — any ``id(...)`` call: object identity varies per
  process, so ordering or keying on it is never reproducible.
* ``DET-WALLCLOCK`` — ``time.time()``.  Wall-clock is non-monotonic
  (NTP steps move it backwards); durations must use
  ``time.perf_counter()``.  Sites that genuinely want a timestamp
  carry a suppression.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Rule
from repro_torch.analysis.framework import (AnalysisPass, call_head, dotted,
                                      import_aliases, register_pass,
                                      walk_no_nested)

#: functions on the stdlib ``random`` module that touch global state
RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "gauss", "normalvariate", "expovariate",
    "betavariate", "seed", "getrandbits", "triangular", "paretovariate",
})

#: legacy ``np.random`` global-state API (the Generator API is fine)
NP_LEGACY_FNS = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "choice", "shuffle", "permutation", "uniform", "normal",
    "exponential", "poisson", "binomial", "beta", "gamma", "standard_normal",
})


def _is_set_expr(node, set_vars) -> bool:
    """Syntactically set-typed: literal, comprehension, ``set()`` /
    ``frozenset()`` call, set algebra over set exprs, or a tracked local."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and call_head(node) in ("set",
                                                          "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)):
        return (_is_set_expr(node.left, set_vars)
                or _is_set_expr(node.right, set_vars))
    if isinstance(node, ast.Name):
        return node.id in set_vars
    return False


@register_pass
class DeterminismPass(AnalysisPass):
    name = "determinism"
    rules = (
        Rule("DET-SEED", "error",
             "unseeded global-state RNG call"),
        Rule("DET-SET-ITER", "error",
             "iteration over a set feeds ordered state"),
        Rule("DET-FLOAT-EQ", "warning",
             "float equality as a predicate"),
        Rule("DET-ID-ORDER", "error",
             "id()-based identity leaks process layout"),
        Rule("DET-WALLCLOCK", "warning",
             "time.time() used where monotonic time belongs"),
    )

    def run(self, project):
        out = []
        for sfile in project.files:
            out.extend(self._run_file(sfile))
        return out

    def _run_file(self, sfile):
        out = []
        modules, symbols = import_aliases(sfile.tree)
        random_mods = {a for a, m in modules.items() if m == "random"}
        numpy_mods = {a for a, m in modules.items() if m == "numpy"}
        # ``from numpy import random [as r]`` / ``from random import x``
        np_random_names = {a for a, (m, s) in symbols.items()
                           if m == "numpy" and s == "random"}
        random_syms = {a for a, (m, s) in symbols.items()
                       if m == "random" and s in RANDOM_FNS}
        time_mods = {a for a, m in modules.items() if m == "time"}
        time_syms = {a for a, (m, s) in symbols.items()
                     if m == "time" and s == "time"}

        for node in ast.walk(sfile.tree):
            if isinstance(node, ast.Call):
                out.extend(self._check_call(
                    sfile, node, random_mods, numpy_mods, np_random_names,
                    random_syms, time_mods, time_syms))
            elif isinstance(node, ast.Compare):
                out.extend(self._check_compare(sfile, node))

        # set-iteration needs per-scope tracking of set-typed locals
        scopes = [sfile.tree] + [
            n for n in ast.walk(sfile.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            out.extend(self._check_set_iteration(sfile, scope))
        return out

    # -- calls ----------------------------------------------------------
    def _check_call(self, sfile, node, random_mods, numpy_mods,
                    np_random_names, random_syms, time_mods, time_syms):
        head = call_head(node)
        parts = head.split(".")
        out = []
        # random.shuffle(...) / rnd.shuffle(...) via ``import random``
        if (len(parts) == 2 and parts[0] in random_mods
                and parts[1] in RANDOM_FNS):
            out.append(self.finding(
                "DET-SEED", sfile, node,
                f"global-state RNG call {head}(); use a seeded "
                "np.random.default_rng(seed) Generator instead"))
        # shuffle(...) via ``from random import shuffle``
        elif len(parts) == 1 and parts[0] in random_syms:
            out.append(self.finding(
                "DET-SEED", sfile, node,
                f"global-state RNG call random.{head}(); use a seeded "
                "np.random.default_rng(seed) Generator instead"))
        # np.random.rand(...) / numpy.random.seed(...)
        elif (len(parts) == 3 and parts[0] in numpy_mods
                and parts[1] == "random" and parts[2] in NP_LEGACY_FNS):
            out.append(self.finding(
                "DET-SEED", sfile, node,
                f"legacy numpy global-state RNG call {head}(); use a "
                "seeded np.random.default_rng(seed) Generator instead"))
        elif (len(parts) == 2 and parts[0] in np_random_names
                and parts[1] in NP_LEGACY_FNS):
            out.append(self.finding(
                "DET-SEED", sfile, node,
                f"legacy numpy global-state RNG call {head}(); use a "
                "seeded np.random.default_rng(seed) Generator instead"))
        # id(x)
        elif head == "id" and len(node.args) == 1:
            out.append(self.finding(
                "DET-ID-ORDER", sfile, node,
                "id() depends on process memory layout; order/key on a "
                "stable field (rid, name) instead"))
        # time.time()
        elif ((len(parts) == 2 and parts[0] in time_mods
               and parts[1] == "time")
              or (len(parts) == 1 and parts[0] in time_syms)):
            out.append(self.finding(
                "DET-WALLCLOCK", sfile, node,
                "time.time() is non-monotonic; use time.perf_counter() "
                "for durations (suppress where a real timestamp is "
                "wanted)"))
        return out

    # -- float equality -------------------------------------------------
    def _check_compare(self, sfile, node):
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            return []
        operands = [node.left] + list(node.comparators)
        for o in operands:
            if isinstance(o, ast.Constant) and isinstance(o.value, float):
                return [self.finding(
                    "DET-FLOAT-EQ", sfile, node,
                    f"equality against float literal {o.value!r}; "
                    "backends rounding differently flip this predicate "
                    "— compare with a tolerance or use integers")]
        return []

    # -- set iteration ---------------------------------------------------
    def _check_set_iteration(self, sfile, scope):
        out = []
        set_vars: set = set()
        # own statements only: defs/classes in the body are their own
        # scopes (walk_no_nested prunes below, not at, its root)
        body = [s for s in getattr(scope, "body", [])
                if not isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef))]
        # first sweep: locals assigned a set expression, in source order
        for stmt in body:
            for node in walk_no_nested(stmt):
                if isinstance(node, ast.Assign) and _is_set_expr(
                        node.value, set_vars):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            set_vars.add(t.id)
                elif isinstance(node, ast.AnnAssign) and node.value is not \
                        None and _is_set_expr(node.value, set_vars):
                    if isinstance(node.target, ast.Name):
                        set_vars.add(node.target.id)
        # second sweep: iteration sites
        for stmt in body:
            for node in walk_no_nested(stmt):
                iters = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    iters.extend(g.iter for g in node.generators)
                for it in iters:
                    if _is_set_expr(it, set_vars):
                        out.append(self.finding(
                            "DET-SET-ITER", sfile, it,
                            "iterating a set in hash order; wrap in "
                            "sorted(...) (or iterate the ordered source) "
                            "so downstream state is reproducible"))
        return out
