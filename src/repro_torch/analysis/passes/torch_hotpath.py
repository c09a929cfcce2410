"""Torch hot-path pass: static checks on every function reachable from a
hot root of the port.

The counterpart of the JAX package's ``jax_hotpath`` pass.  No
syntactic transform marks the port's hot regions (eager PyTorch has no
``jit``), so a constructor-configurable table names them
(:data:`DEFAULT_ROOTS`: the fleet's tick body and gap jump, the cached
decode step, the kernels' launch wrappers).  Besides the table, any
function handed to ``torch.compile`` (decorator forms included,
``functools.partial`` unwrapped) or ``make_graphed_callables``, and
every call in the body of a ``with torch.cuda.graph(...)`` block, is a
root: what such a capture records must not sync with the host.

From the roots a conservative call graph is grown as the reference's
pass grows it: ``Name(...)`` calls resolve against nested defs, the
module's top-level functions, then imports (with one-hop re-export
chasing through ``__init__`` modules); ``module.attr(...)`` resolves
through ``import module`` and, here, through ``from pkg import module``
as well; ``self.method(...)`` resolves to the method of the enclosing
class.  Other attribute calls on objects are out of scope.

Rules (all scoped to hot functions only)
----------------------------------------
* ``TORCHHP-HOSTSYNC`` — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()``, ``torch.cuda.synchronize()``, ``float()/int()/bool()``
  on a tensor local, or any ``np.*`` call: each one waits for the
  device (or runs on the host) inside the region a CUDA graph would
  capture.
* ``TORCHHP-BRANCH`` — Python ``if``/``while``/``for`` over the value
  of a *tensor local* (a name assigned from a ``torch``/``F``
  expression in the same function, or a parameter annotated as a
  tensor).  Its metadata (``.shape``, ``.dtype``, ``.dim()``, ``is
  None`` ...) is static and not flagged.
* ``TORCHHP-DTYPE`` — ``torch.zeros/ones/empty/full/arange`` without a
  ``dtype`` in a file where the int32 tick state lives (``serving/`` by
  default): the float32 (int64 for ``arange``) default promotes the
  all-int32 tick state.
"""
from __future__ import annotations

import ast
import fnmatch
import functools

from repro_torch.analysis.findings import Rule
from repro_torch.analysis.framework import (AnalysisPass, ancestors,
                                            call_head, dotted,
                                            enclosing_functions,
                                            import_aliases, register_pass,
                                            walk_no_nested)

#: (path pattern, qualified-name pattern) of the hot roots, matched with
#: fnmatch against each file's posix path ("*/" + pattern) and each
#: function's qualified name (``Class.method`` for a method)
DEFAULT_ROOTS = (
    ("serving/torch_cluster.py", "_tick_core"),
    ("serving/torch_cluster.py", "_advance_core"),
    ("models/transformer.py", "Transformer.decode_step"),
    # what decode_step reaches through module calls (``blk(...)``,
    # ``self.layers[i].step(...)``), which the call graph does not follow
    ("models/transformer.py", "DecoderBlock.forward"),
    ("models/transformer.py", "MambaLayer.step"),
    ("models/mamba2.py", "MambaBlock.step"),
    ("models/moe.py", "MoE.forward"),
    ("kernels/*/kernel.py", "[!_]*"),        # the launch wrappers
)

#: path fragments of the files that hold int32 tick state
DEFAULT_DTYPE_SCOPE = ("serving/",)

#: call heads (last part) whose function arguments become roots
ROOT_CALLS = frozenset({"compile", "make_graphed_callables"})

#: torch constructors that take ``dtype=`` (keyword-only in torch)
_CTORS = frozenset({"zeros", "ones", "empty", "full", "arange"})

#: tensor attributes and methods that read metadata, not values
_META_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
    "layout", "is_sparse", "names", "grad_fn", "dim", "size", "numel",
    "stride", "is_contiguous", "element_size", "data_ptr", "nelement",
    "is_floating_point", "get_device", "storage_offset",
})

#: tensor methods whose result is a host value (flagged as host syncs)
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _qualname(fn) -> str:
    names = [fn.name]
    for a in ancestors(fn):
        if isinstance(a, (*_FUNC_NODES, ast.ClassDef)):
            names.append(a.name)
    return ".".join(reversed(names))


class _FileInfo:
    """Per-file lookup tables the resolver needs."""

    def __init__(self, sfile):
        self.sfile = sfile
        self.modules, self.symbols = import_aliases(sfile.tree)
        self.top_funcs = {n.name: n for n in sfile.tree.body
                          if isinstance(n, _FUNC_NODES)}
        self.torch_roots = {a for a, m in self.modules.items()
                            if m == "torch" or m.startswith("torch.")}
        self.torch_roots |= {a for a, (m, s) in self.symbols.items()
                             if m == "torch" or m.startswith("torch.")}
        self.np_roots = {a for a, m in self.modules.items()
                         if m == "numpy"}


@register_pass
class TorchHotpathPass(AnalysisPass):
    name = "torch-hotpath"
    rules = (
        Rule("TORCHHP-HOSTSYNC", "error",
             "host sync inside a hot-path function"),
        Rule("TORCHHP-BRANCH", "error",
             "python control flow on a tensor value"),
        Rule("TORCHHP-DTYPE", "warning",
             "tensor constructor without explicit dtype"),
    )

    def __init__(self, roots=DEFAULT_ROOTS,
                 dtype_scope=DEFAULT_DTYPE_SCOPE):
        super().__init__()
        self.roots = tuple(roots)
        self.dtype_scope = tuple(dtype_scope)

    def run(self, project):
        infos = {f: _FileInfo(f) for f in project.files}
        hot = self._reachable(project, infos)
        out = []
        for fn_node, sfile in hot:
            out.extend(self._check_function(fn_node, infos[sfile]))
        return out

    # -- roots and call graph --------------------------------------------
    def _table_roots(self, sfile):
        path = sfile.path.as_posix()
        pats = [q for p, q in self.roots if fnmatch.fnmatch(path, "*/" + p)
                or fnmatch.fnmatch(path, p)]
        if not pats:
            return []
        return [n for n in ast.walk(sfile.tree)
                if isinstance(n, _FUNC_NODES)
                and any(fnmatch.fnmatchcase(_qualname(n), q) for q in pats)]

    def _reachable(self, project, infos):
        """BFS the hot set from the table's roots and the capture roots."""
        hot: dict = {}            # fn node -> sfile (identity-keyed)
        work: list = []

        def add(fn_node, sfile):
            if fn_node is not None and fn_node not in hot:
                hot[fn_node] = sfile
                work.append((fn_node, sfile))

        for sfile in project.files:
            info = infos[sfile]
            for fn in self._table_roots(sfile):
                add(fn, sfile)
            for node in ast.walk(sfile.tree):
                if isinstance(node, ast.Call) and self._is_root_call(
                        node, info):
                    for arg in list(node.args) + [
                            kw.value for kw in node.keywords]:
                        for target in self._unwrap(arg, node, sfile,
                                                   project, infos):
                            add(*target)
                elif isinstance(node, _FUNC_NODES):
                    if any(self._is_compile(dec, info)
                           for dec in node.decorator_list):
                        add(node, sfile)
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        self._is_graph_capture(it.context_expr, info)
                        for it in node.items):
                    for stmt in node.body:
                        for sub in walk_no_nested(stmt):
                            if isinstance(sub, ast.Call):
                                add(*(self._resolve_call(
                                    sub, sfile, project, infos)
                                    or (None, None)))

        while work:
            fn_node, sfile = work.pop()
            for node in walk_no_nested(fn_node):
                if not isinstance(node, ast.Call):
                    continue
                resolved = self._resolve_call(node, sfile, project, infos,
                                              current_fn=fn_node)
                if resolved is not None:
                    add(*resolved)
        return list(hot.items())

    @staticmethod
    def _torch_head(head: str, info) -> bool:
        return bool(head) and head.split(".")[0] in info.torch_roots

    def _is_root_call(self, call, info) -> bool:
        head = call_head(call)
        return (head.split(".")[-1] in ROOT_CALLS
                and self._torch_head(head, info))

    def _is_compile(self, dec, info) -> bool:
        node = dec.func if isinstance(dec, ast.Call) else dec
        head = dotted(node)
        return (head.split(".")[-1] == "compile"
                and self._torch_head(head, info))

    def _is_graph_capture(self, expr, info) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        head = call_head(expr)
        return (head.split(".")[-1] == "graph"
                and self._torch_head(head, info))

    def _unwrap(self, arg, call, sfile, project, infos):
        """Function nodes referenced by one root-call argument."""
        if isinstance(arg, ast.Lambda):
            return [(arg, sfile)]
        if isinstance(arg, (ast.Tuple, ast.List)):
            out = []
            for e in arg.elts:
                out.extend(self._unwrap(e, call, sfile, project, infos))
            return out
        if isinstance(arg, ast.Call):
            if call_head(arg).split(".")[-1] == "partial":
                out = []
                for a in arg.args:
                    out.extend(self._unwrap(a, call, sfile, project,
                                            infos))
                return out
            return []
        if isinstance(arg, (ast.Name, ast.Attribute)):
            resolved = self._resolve_head(dotted(arg), call, sfile,
                                          project, infos)
            return [resolved] if resolved is not None else []
        return []

    def _resolve_call(self, call, sfile, project, infos, current_fn=None):
        return self._resolve_head(call_head(call), call, sfile, project,
                                  infos, current_fn)

    def _resolve_head(self, head, site, sfile, project, infos,
                      current_fn=None):
        if not head:
            return None
        info = infos[sfile]
        parts = head.split(".")
        scope = enclosing_functions(site) or (
            [current_fn] if current_fn is not None else [])
        if len(parts) == 1:
            name = parts[0]
            # nested defs of enclosing functions, innermost first
            for fn in scope:
                body = getattr(fn, "body", [])
                if not isinstance(body, list):
                    continue
                for stmt in body:
                    if isinstance(stmt, _FUNC_NODES) and stmt.name == name:
                        return (stmt, sfile)
            if name in info.top_funcs:
                return (info.top_funcs[name], sfile)
            if name in info.symbols:
                mod, orig = info.symbols[name]
                target = project.resolve_module(mod, sfile)
                if target is not None:
                    return self._resolve_symbol(target, orig, project,
                                                infos, 1)
            return None
        if len(parts) != 2:
            return None
        root, attr = parts
        if root == "self":
            return self._resolve_method(site, attr, sfile)
        if root in info.modules:
            target = project.resolve_module(info.modules[root], sfile)
        elif root in info.symbols:      # ``from pkg import module``
            mod, orig = info.symbols[root]
            target = project.resolve_module(
                f"{mod}.{orig}" if mod.strip(".") else mod + orig, sfile)
        else:
            return None
        if target is None:
            return None
        return self._resolve_symbol(target, attr, project, infos, 1)

    @staticmethod
    def _resolve_method(site, name, sfile):
        cls = next((a for a in ancestors(site)
                    if isinstance(a, ast.ClassDef)), None)
        if cls is None:
            return None
        for stmt in cls.body:
            if isinstance(stmt, _FUNC_NODES) and stmt.name == name:
                return (stmt, sfile)
        return None

    def _resolve_symbol(self, mod_file, name, project, infos, depth):
        if depth > 8:
            return None
        info = infos.get(mod_file)
        if info is None:
            info = infos[mod_file] = _FileInfo(mod_file)
        if name in info.top_funcs:
            return (info.top_funcs[name], mod_file)
        if name in info.symbols:       # re-export (``__init__`` façades)
            mod, orig = info.symbols[name]
            target = project.resolve_module(mod, mod_file)
            if target is not None:
                return self._resolve_symbol(target, orig, project, infos,
                                            depth + 1)
        return None

    # -- per-function checks --------------------------------------------
    def _check_function(self, fn_node, info):
        sfile = info.sfile
        out = []
        tensors = self._tensor_locals(fn_node, info)
        label = getattr(fn_node, "name", "<lambda>")
        dtype_scope = any(frag in sfile.path.as_posix()
                          for frag in self.dtype_scope)
        for node in walk_no_nested(fn_node):
            if isinstance(node, ast.Call):
                out.extend(self._check_hot_call(node, sfile, info, label,
                                                tensors, dtype_scope))
            elif isinstance(node, (ast.If, ast.While)):
                name = self._tensor_valued(node.test, tensors, info)
                if name is not None:
                    out.append(self.finding(
                        "TORCHHP-BRANCH", sfile, node,
                        f"python branch on tensor value {name!r} in hot "
                        f"{label}(); use torch.where — a branch on a "
                        "device value syncs with the host and cannot be "
                        "captured in a CUDA graph"))
            elif isinstance(node, ast.For):
                name = self._tensor_valued(node.iter, tensors, info)
                if name is not None:
                    out.append(self.finding(
                        "TORCHHP-BRANCH", sfile, node,
                        f"python loop over tensor value {name!r} in hot "
                        f"{label}(); iterating a device tensor copies "
                        "each element to the host"))
        return out

    def _check_hot_call(self, node, sfile, info, label, tensors,
                        dtype_scope):
        head = call_head(node)
        parts = head.split(".") if head else []
        out = []
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "item", "tolist", "cpu", "numpy") and not node.args:
            out.append(self.finding(
                "TORCHHP-HOSTSYNC", sfile, node,
                f".{node.func.attr}() inside hot {label}() waits for the "
                "device and copies to the host; keep the value on the "
                "device"))
        elif (len(parts) >= 2 and parts[-2:] == ["cuda", "synchronize"]
              and self._torch_head(head, info)):
            out.append(self.finding(
                "TORCHHP-HOSTSYNC", sfile, node,
                f"{head}() inside hot {label}() blocks the host on the "
                "device"))
        elif head in ("float", "int", "bool") and node.args and \
                self._tensor_valued(node.args[0], tensors, info) is not None:
            out.append(self.finding(
                "TORCHHP-HOSTSYNC", sfile, node,
                f"{head}() on a tensor value in hot {label}() copies it "
                "to the host (a sync); use .to(dtype) on the device "
                "instead"))
        elif parts and parts[0] in info.np_roots:
            out.append(self.finding(
                "TORCHHP-HOSTSYNC", sfile, node,
                f"numpy call {head}() inside hot {label}() runs on the "
                "host; use the torch equivalent on the device"))
        elif (dtype_scope and len(parts) == 2 and parts[1] in _CTORS
              and self._torch_head(head, info)
              and not any(kw.arg == "dtype" for kw in node.keywords)):
            out.append(self.finding(
                "TORCHHP-DTYPE", sfile, node,
                f"{head}() without an explicit dtype defaults to float32 "
                "(int64 for arange); the tick state is all-int32 — pass "
                "dtype=torch.int32"))
        return out

    # -- tensor-local inference -----------------------------------------
    def _tensor_locals(self, fn_node, info) -> set:
        """Parameters annotated as tensors, and names assigned a tensor
        value within this function (single forward sweep; transitively
        through other tensor locals)."""
        tensors: set = set()
        args = getattr(fn_node, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.annotation is not None and "Tensor" in ast.dump(
                        a.annotation):
                    tensors.add(a.arg)
        body = getattr(fn_node, "body", [])
        if not isinstance(body, list):
            return tensors
        for stmt in body:
            for node in walk_no_nested(stmt):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                            value, (ast.Tuple, ast.List)) and len(
                            t.elts) == len(value.elts):
                        pairs = zip(t.elts, value.elts)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        pairs = ((e, value) for e in t.elts)
                    else:
                        pairs = [(t, value)]
                    for e, v in pairs:
                        if isinstance(e, ast.Name) and self._tensor_valued(
                                v, tensors, info) is not None:
                            tensors.add(e.id)
        return tensors

    def _tensor_valued(self, e, tensors, info):
        """The tensor local (or ``"torch"``) that makes ``e`` a tensor
        value, else None.  A torch call, a tensor local, and an
        attribute, index, method call or arithmetic over one are tensor
        values; metadata (``x.shape``, ``x.dim()``), ``is``/``is not``
        tests, containers and calls of other functions are not."""
        tv = functools.partial(self._tensor_valued, tensors=tensors,
                               info=info)
        if isinstance(e, ast.Name):
            return e.id if e.id in tensors else None
        if isinstance(e, ast.Attribute):
            return None if e.attr in _META_ATTRS else tv(e.value)
        if isinstance(e, ast.Subscript):
            return tv(e.value)
        if isinstance(e, ast.Call):
            f = e.func
            if not isinstance(f, ast.Attribute) or f.attr in _META_ATTRS \
                    or f.attr in _HOST_METHODS:
                return None
            if self._torch_head(dotted(f), info):
                # torch.is_grad_enabled() and the like are host values
                return None if f.attr.startswith(("is_", "get_")) \
                    else "torch"
            return tv(f.value)
        if isinstance(e, ast.BinOp):
            return tv(e.left) or tv(e.right)
        if isinstance(e, ast.UnaryOp):
            return tv(e.operand)
        if isinstance(e, ast.BoolOp):
            return next(filter(None, map(tv, e.values)), None)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return None
            return next(filter(None, map(tv, [e.left, *e.comparators])),
                        None)
        if isinstance(e, ast.IfExp):
            return tv(e.body) or tv(e.orelse)
        return None
