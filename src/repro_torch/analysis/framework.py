"""Pass framework: source loading, parent-linked ASTs, suppressions,
the ``AnalysisPass`` base, and shared AST helpers.

Everything a pass needs hangs off :class:`Project` (the loaded file
set, module map for cross-file resolution) and :class:`SourceFile`
(text, parent-linked tree, per-line ``# schedlint: disable=<rule>``
suppressions).  Passes register with :func:`register_pass` and are
instantiated by the CLI; each returns plain :class:`Finding` lists, so
the framework — like everything in this package — stays stdlib-only.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding, Rule

#: ``# schedlint: disable=RULE[,RULE...]`` silences those rules on that
#: line; ``disable-file=`` silences them for the whole file.  ``all``
#: matches every rule.
SUPPRESS_RE = re.compile(
    r"#\s*schedlint:\s*disable(?P<scope>-file)?=(?P<rules>[A-Za-z0-9_\-, ]+)")

PARSE_RULE = Rule("PARSE", "error", "file failed to parse")


def _module_name(path: Path) -> str:
    """Dotted module path for cross-file import resolution.  Files under
    a ``src/`` root get their real import path (``repro.core.spec``);
    anything else (fixtures, scripts) falls back to the file stem."""
    parts = list(path.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class SourceFile:
    """One parsed source file: text, parent-linked AST, suppressions."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        try:
            self.rel = path.relative_to(root).as_posix()
        except ValueError:
            self.rel = path.as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._sl_parent = node
        self.module = _module_name(path)
        self.line_suppress: dict = {}
        self.file_suppress: set = set()
        for i, line in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(line)
            if m is None:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            if m.group("scope"):
                self.file_suppress |= rules
            else:
                self.line_suppress.setdefault(i, set()).update(rules)

    def snippet(self, line: int) -> str:
        if 0 < line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppresses(self, finding: Finding) -> bool:
        rules = self.file_suppress | self.line_suppress.get(finding.line,
                                                            set())
        return finding.rule in rules or "all" in rules


class Project:
    """The loaded file set plus cross-file lookup tables."""

    def __init__(self, roots, files, parse_failures=()):
        self.roots = list(roots)
        self.files = sorted(files, key=lambda f: f.path.as_posix())
        self.parse_failures = list(parse_failures)
        self.modules: dict = {}
        for f in self.files:
            self.modules.setdefault(f.module, f)
        self._by_path = {f.path.as_posix(): f for f in self.files}
        for f in self.files:
            self._by_path.setdefault(f.rel, f)

    def file_by_path(self, path: str):
        return self._by_path.get(str(path))

    def file_by_suffix(self, suffix: str):
        """First file whose posix path ends with ``suffix`` (how passes
        name repo files without hardcoding the checkout root)."""
        for f in self.files:
            if f.path.as_posix().endswith(suffix):
                return f
        return None

    def resolve_module(self, name: str, current=None):
        """Module file for an absolute dotted import name; one level of
        relative import (``from . import x`` / ``from .ops import x``)
        resolves against ``current``'s package."""
        if name.startswith("."):
            if current is None:
                return None
            pkg = current.module.rsplit(".", 1)[0] \
                if "." in current.module else current.module
            name = pkg + "." + name.lstrip(".") if name.strip(".") else pkg
        if name in self.modules:
            return self.modules[name]
        for mod, f in self.modules.items():
            if mod.endswith("." + name):
                return f
        return None


def load_project(paths) -> Project:
    """Recursively load ``*.py`` under each path (files load as
    themselves).  Unparseable files become PARSE findings rather than
    aborting the run — a lint suite must fail loudly, not crash."""
    files, failures, roots = [], [], []
    for p in paths:
        p = Path(p).resolve()
        roots.append(p)
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        root = p if p.is_dir() else p.parent
        for fp in candidates:
            try:
                files.append(SourceFile(fp, root))
            except SyntaxError as e:
                failures.append(Finding(
                    rule=PARSE_RULE.id, severity=PARSE_RULE.severity,
                    path=fp.as_posix(), line=int(e.lineno or 1), col=0,
                    message=f"syntax error: {e.msg}"))
            except (UnicodeDecodeError, OSError) as e:
                failures.append(Finding(
                    rule=PARSE_RULE.id, severity=PARSE_RULE.severity,
                    path=fp.as_posix(), line=1, col=0,
                    message=f"unreadable: {e}"))
    return Project(roots, files, failures)


# ---------------------------------------------------------------------------
# AST helpers shared by the passes
# ---------------------------------------------------------------------------


def parent(node):
    return getattr(node, "_sl_parent", None)


def ancestors(node):
    node = parent(node)
    while node is not None:
        yield node
        node = parent(node)


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def enclosing_functions(node):
    """Enclosing function nodes, innermost first."""
    return [a for a in ancestors(node) if isinstance(a, _FUNC_NODES)]


def dotted(node) -> str:
    """``a.b.c`` for Name/Attribute chains, else ``""``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_head(call: ast.Call) -> str:
    return dotted(call.func)


def walk_no_nested(root):
    """Walk ``root``'s subtree without descending into nested function
    or class definitions (their bodies are someone else's scope)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FUNC_NODES, ast.ClassDef)):
                # visible (so callers can see the def) but not entered
                yield child
                continue
            stack.append(child)


def import_aliases(tree):
    """``(modules, symbols)`` binding tables for a whole file (function
    -level imports included — the jitted tick body imports jnp inside
    the function).  ``modules``: local name -> dotted module.
    ``symbols``: local name -> (module, original symbol name)."""
    modules: dict = {}
    symbols: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                modules[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                symbols[a.asname or a.name] = (mod, a.name)
    return modules, symbols


# ---------------------------------------------------------------------------
# Pass base + registry
# ---------------------------------------------------------------------------


class AnalysisPass:
    """Base class: subclasses set ``name`` + ``rules`` and implement
    :meth:`run`.  ``finding`` builds a Finding with the rule's severity
    and the source line snippet filled in."""

    name: str = ""
    rules: tuple = ()

    def __init__(self):
        self._rules = {r.id: r for r in self.rules}

    def run(self, project: Project):
        raise NotImplementedError

    def finding(self, rule_id: str, sfile: SourceFile, node,
                message: str) -> Finding:
        rule = self._rules[rule_id]
        line = getattr(node, "lineno", None) or (node if isinstance(
            node, int) else 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule.id, severity=rule.severity,
                       path=sfile.path.as_posix(), line=int(line),
                       col=int(col), message=message,
                       snippet=sfile.snippet(int(line)))


#: name -> pass class, in registration order (dicts preserve it).
PASS_REGISTRY: dict = {}


def register_pass(cls):
    if not cls.name:
        raise ValueError(f"{cls.__name__} needs a non-empty name")
    PASS_REGISTRY[cls.name] = cls
    return cls
