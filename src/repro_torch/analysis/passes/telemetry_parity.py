"""Telemetry-parity pass: the PR-7 observability contract, checked
statically.

Three claims the docs make that nothing previously enforced:

* ``TEL-KINDS`` — every backend (des / tick / vector / torch) emits every
  kind in ``core/telemetry.py::KINDS``.  A backend that silently stops
  emitting e.g. ``demote`` still passes the trace-equality tests when
  compared against itself — only cross-backend comparison or this check
  catches it.  The set is read from the KINDS tuple itself, so the
  lifecycle kinds (``cold_start``/``fail``/``requeue``/``scale``,
  docs/OBSERVABILITY.md) are enforced the moment they are declared: the
  tick-family backends satisfy them through the shared frontend
  (``serving/cluster.py`` is in every tick suffix set), the DES through
  its own emit sites in ``core/simulator.py``.  Emitted kinds are collected from ``emit``/``emit_rows``
  string arguments plus KINDS-member strings inside list/tuple
  containers (the torch backend drives ``emit_rows`` from a
  ``[("admit", "trace_adm"), ...]`` key table).
* ``TEL-GUARD`` — every emission site is reachable with tracing
  disabled, so it must sit under an ``... is not None`` guard (either
  an enclosing ``if`` testing ``is not None``, or an earlier
  ``if x is None: return/continue/raise`` in the same function).
* ``TEL-REGISTRY`` — every name registered on
  SCHEDULER/DISPATCH/PREDICTOR_REGISTRY appears (as a quoted literal)
  somewhere under ``tests/``: an unexercised policy is an untested
  policy.

Topology (kinds file, backend -> file suffixes, tests dir) is
constructor-configurable so fixtures can model a miniature repo; the
defaults describe this one.  Backends whose files are absent from the
scanned path set are skipped, not failed — scanning a single file
shouldn't complain about the rest of the repo.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Rule
from repro_torch.analysis.framework import (AnalysisPass, ancestors,
                                      enclosing_functions, register_pass)

DEFAULT_KINDS_FILE = "core/telemetry.py"

#: backend name -> file suffixes whose union must cover KINDS
DEFAULT_BACKENDS = {
    "des": ("core/simulator.py",),
    "tick": ("serving/cluster.py", "serving/schedulers.py",
             "serving/engine.py"),
    "vector": ("serving/cluster.py", "serving/vector_cluster.py"),
    "torch": ("serving/cluster.py", "serving/torch_cluster.py"),
}

EMIT_NAMES = ("emit", "emit_rows")


def _kind_literals(tree, kinds):
    """Kind strings this file emits: emit()/emit_rows() string args and
    KINDS members inside list/tuple/set containers (key tables)."""
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr in EMIT_NAMES:
            for a in node.args:
                if isinstance(a, ast.Constant) and a.value in kinds:
                    found.add(a.value)
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            for e in node.elts:
                if isinstance(e, ast.Constant) and e.value in kinds:
                    found.add(e.value)
    return found


def _is_guarded(call) -> bool:
    """True when the emit call sits under an ``is not None`` test or a
    preceding early exit on ``is None`` in the same function."""
    for a in ancestors(call):
        if isinstance(a, ast.If):
            for n in ast.walk(a.test):
                if isinstance(n, ast.Compare) and any(
                        isinstance(op, ast.IsNot) for op in n.ops):
                    return True
    fns = enclosing_functions(call)
    if not fns:
        return False
    body = getattr(fns[0], "body", [])
    if not isinstance(body, list):
        return False
    for stmt in body:
        if getattr(stmt, "lineno", 10**9) >= call.lineno:
            break
        if isinstance(stmt, ast.If) and any(
                isinstance(n, ast.Compare)
                and any(isinstance(op, ast.Is) for op in n.ops)
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in n.comparators)
                for n in ast.walk(stmt.test)):
            if stmt.body and isinstance(stmt.body[0], (
                    ast.Return, ast.Raise, ast.Continue)):
                return True
    return False


@register_pass
class TelemetryParityPass(AnalysisPass):
    name = "telemetry-parity"
    rules = (
        Rule("TEL-KINDS", "error",
             "backend does not emit every telemetry kind"),
        Rule("TEL-GUARD", "error",
             "emission site unguarded against trace=None"),
        Rule("TEL-REGISTRY", "warning",
             "registered name never exercised under tests/"),
    )

    def __init__(self, kinds_file=DEFAULT_KINDS_FILE,
                 backends=None, tests_dir=None):
        super().__init__()
        self.kinds_file = kinds_file
        self.backends = dict(backends if backends is not None
                             else DEFAULT_BACKENDS)
        self.tests_dir = tests_dir

    def run(self, project):
        out = []
        kinds_sf = project.file_by_suffix(self.kinds_file)
        kinds = self._load_kinds(kinds_sf) if kinds_sf else ()
        if kinds:
            out.extend(self._check_kinds(project, kinds))
            out.extend(self._check_guards(project))
        out.extend(self._check_registry(project))
        return out

    @staticmethod
    def _load_kinds(sfile):
        for node in ast.walk(sfile.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "KINDS"
                    for t in node.targets):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    return tuple(e.value for e in node.value.elts
                                 if isinstance(e, ast.Constant))
        return ()

    # -- TEL-KINDS -------------------------------------------------------
    def _check_kinds(self, project, kinds):
        out = []
        for backend, suffixes in sorted(self.backends.items()):
            sfiles = [project.file_by_suffix(s) for s in suffixes]
            sfiles = [s for s in sfiles if s is not None]
            if len(sfiles) < len(suffixes):
                continue    # backend not in the scanned path set
            emitted = set()
            for sf in sfiles:
                emitted |= _kind_literals(sf.tree, set(kinds))
            missing = [k for k in kinds if k not in emitted]
            if missing:
                out.append(self.finding(
                    "TEL-KINDS", sfiles[-1], 1,
                    f"backend {backend!r} never emits "
                    f"{', '.join(missing)} (files: "
                    f"{', '.join(suffixes)}); all four backends must "
                    "produce the full KINDS set or cross-backend trace "
                    "comparison is vacuous"))
        return out

    # -- TEL-GUARD -------------------------------------------------------
    def _check_guards(self, project):
        out = []
        seen = set()
        suffixes = sorted({s for sx in self.backends.values() for s in sx})
        for suffix in suffixes:
            sf = project.file_by_suffix(suffix)
            if sf is None or sf in seen:
                continue
            seen.add(sf)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) and \
                        node.func.attr in EMIT_NAMES:
                    if not _is_guarded(node):
                        out.append(self.finding(
                            "TEL-GUARD", sf, node,
                            f".{node.func.attr}() without an "
                            "'is not None' guard: every backend runs "
                            "with tracing disabled by default, so this "
                            "site raises AttributeError on None the "
                            "first time the event fires"))
        return out

    # -- TEL-REGISTRY ----------------------------------------------------
    def _check_registry(self, project):
        regs = []   # (name, registry, sfile, node)
        for sf in project.files:
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "register"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id.endswith("_REGISTRY")
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    regs.append((node.args[0].value,
                                 node.func.value.id, sf, node))
        if not regs:
            return []
        tests = self._find_tests_dir(project)
        if tests is None:
            return []
        blob = "\n".join(p.read_text() for p in sorted(tests.rglob("*.py")))
        out = []
        for name, registry, sf, node in regs:
            pat = re.compile(r"[\"']" + re.escape(name) + r"[\"']")
            if not pat.search(blob):
                out.append(self.finding(
                    "TEL-REGISTRY", sf, node,
                    f"{registry} name {name!r} is never mentioned under "
                    f"{tests.name}/ — an unexercised policy is an "
                    "untested policy (add a parity/spec test for it)"))
        return out

    def _find_tests_dir(self, project):
        if self.tests_dir is not None:
            p = Path(self.tests_dir)
            return p if p.is_dir() else None
        for root in project.roots:
            cur = root if root.is_dir() else root.parent
            for candidate in [cur, *cur.parents]:
                t = candidate / "tests"
                if t.is_dir():
                    return t
        return None
