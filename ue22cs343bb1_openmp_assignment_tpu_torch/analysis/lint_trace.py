"""AST linter for the port's device code (ops/, parallel/, models/).

The torch counterpart of the JAX package's ``analysis/lint_trace.py``:
the same machinery (a per-function forward taint pass, :class:`Finding`,
``lint_source``/``lint_file``/``lint_paths``/``default_targets``, the
``host-side`` docstring mark and the ``# lint: host`` opt-out), with the
rules given their PyTorch meanings. The engine's contract is that the
code of a cycle or a round is branch-free on tensors, reads nothing
back to the host, keeps the int32 lattice and is deterministic: a host
read inside a round blocks the stream and keeps a chunk of rounds from
being captured as one CUDA graph.

* ``traced-branch``: a Python ``if``/``while``/``assert`` (or a ternary
  / comprehension guard) whose condition is a tensor, and ``range()``/
  ``reversed()`` over a tensor length. Each is an implicit host sync,
  and breaks graph capture. Plain ``for`` over a tensor or a container
  of tensors is not flagged.
* ``host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  and ``int()``/``bool()``/``float()`` on a tensor: a blocking
  device-to-host transfer.
* ``host-call``: ``np.*`` or ``print`` inside device code.
* ``dtype-drift``: ``torch.arange``/``zeros``/``ones``/``empty``/
  ``full`` without ``dtype=``: torch's int64/float32 defaults are not
  the engine's int32 lattice.
* ``nondeterminism``: ``random``/``np.random``/``time``/``datetime``/
  ``os.urandom``/``uuid``/``secrets`` in device code, plus module-level
  imports of ``random``/``secrets``/``uuid`` anywhere in the linted
  packages. Results must be a pure function of (config, traces,
  fault_key).

Taint model (under-approximate, to stay quiet): function parameters
are tensors unless they are ``self``/``cls``/``cfg``/``config``/``mesh``/
``device``/``dev``, have a Python-literal default, or carry a scalar
Python annotation (``int``/``bool``/``float``/``str``); results of
``torch.*`` calls are tensors, except the host queries in
``_HOST_RESULT_CALLS``; taint propagates through arithmetic, subscripts,
attributes and method calls, and dies at ``.shape``/``.ndim``/
``.dtype``/``.device`` and the other static attributes, at the host
methods ``size()``/``numel()``/``dim()``/``data_ptr()``/``stride()``,
``len()``, identity tests (``is``/``is not``) and container literals
(a Python list of tensors is a host container; only its elements are
tensors). Unknown local calls are assumed to return host values.

Host-side functions opt out of the tracing rules (not of
``dtype-drift``) by saying so: the string ``host-side`` anywhere in the
docstring, or a ``# lint: host`` comment on the ``def`` line or the line
above. The escape hatch is visible in the diff, which is the point.

A separate boundary pass, ``no-torch``, guards the opposite contract:
the daemon's wire layer (``daemon/server.py``, ``daemon/client.py``) and
the live ops plane (``obs/events.py``, ``obs/promexpo.py``,
``obs/burnrate.py``, ``obs/fleet.py``) stay importable on machines with
no accelerator stack: socket + json only, torch reaches the process
solely through the engine the server drives. Any ``import torch``, any
``torch`` name reference, or an ``importlib.import_module("torch...")``
in those files is a finding.

Public API: :func:`lint_source` (unit tests), :func:`lint_file`,
:func:`lint_paths`, :func:`default_targets`, :func:`lint_no_torch` (and
:func:`lint_no_torch_source` for unit tests).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, List, Optional, Sequence

#: module roots whose call results are tensors
_TRACED_ROOTS = {"torch"}
#: parameter names that are never tensors
_HOST_PARAMS = {"self", "cls", "cfg", "config", "mesh", "layout", "device",
                "dev"}
#: scalar Python annotations that mark a parameter as a host value
_SCALAR_ANNOTATIONS = {"int", "bool", "float", "str", "bytes"}
#: container annotations: the parameter is a host container (only its
#: elements may be tensors)
_CONTAINER_ANNOTATIONS = {"list", "tuple", "dict", "set", "List", "Tuple",
                          "Dict", "Set", "Sequence", "Iterable"}
#: attribute reads that yield static (host) metadata even on tensors
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "layout", "is_cuda",
                 "requires_grad", "names"}
#: tensor methods whose result is host metadata (no sync, kills taint)
_HOST_METHODS = {"size", "numel", "dim", "data_ptr", "stride",
                 "element_size", "is_contiguous", "get_device",
                 "storage_offset", "nelement"}
#: builtins whose application to a tensor is a device->host sync
_SYNC_BUILTINS = {"int", "bool", "float", "complex"}
#: tensor methods that force a device->host sync
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: builtins returning host values (no finding, kills taint)
_HOST_BUILTINS = {"len", "isinstance", "getattr", "hasattr", "id", "repr",
                  "str", "format", "type", "max", "min", "abs", "round",
                  "sorted", "sum", "tuple", "list", "dict", "set", "range",
                  "zip", "enumerate", "divmod"}
#: builtins needing a concrete integer: a tensor argument syncs
#: (``reversed`` of a tensor is a flip on the device: not listed)
_CONCRETE_LEN_BUILTINS = {"range"}
#: torch calls whose result is a host value
_HOST_RESULT_CALLS = {"torch.device", "torch.Size", "torch.iinfo",
                      "torch.finfo", "torch.is_tensor",
                      "torch.get_default_dtype", "torch.cuda.is_available",
                      "torch.cuda.device_count",
                      "torch.cuda.get_device_name",
                      "torch.cuda.current_device",
                      "torch.cuda.current_stream",
                      "torch.cuda.get_device_properties"}
#: dotted prefixes that are host round-trips inside device code
_HOST_CALL_PREFIXES = ("np.", "numpy.")
#: dotted prefixes that are nondeterminism sources inside device code
_NONDET_PREFIXES = ("random.", "np.random.", "numpy.random.", "time.",
                    "datetime.", "os.urandom", "uuid.", "secrets.")
#: modules whose import is banned outright in the linted packages
_NONDET_IMPORTS = {"random", "secrets", "uuid"}
#: torch constructors that take their dtype from a default or the fill
#: value unless ``dtype=`` is given (keyword-only in torch)
_DTYPE_CTORS = {"arange", "zeros", "ones", "empty", "full"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter hit: ``file:line:col rule func: msg``."""

    file: str
    line: int
    col: int
    rule: str
    func: str
    msg: str

    def render(self) -> str:
        where = f"{self.file}:{self.line}:{self.col}"
        return f"{where}: [{self.rule}] in `{self.func}`: {self.msg}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c" (None for anything not a pure dotted name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_literal(e) for e in node.elts)
    return False


def _scalar_annotation(node: Optional[ast.AST]) -> bool:
    """A scalar (``int``, ``Optional[int]``, ``int | None``) or a host
    container (``tuple``, ``list[...]``) annotation."""
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id in _SCALAR_ANNOTATIONS | _CONTAINER_ANNOTATIONS
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _SCALAR_ANNOTATIONS
    if isinstance(node, ast.Subscript):
        if _dotted(node.value) in _CONTAINER_ANNOTATIONS:
            return True             # list[...], Sequence[...]
        return _scalar_annotation(node.slice)     # Optional[int] etc.
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return all(_scalar_annotation(side) or (
            isinstance(side, ast.Constant) and side.value is None)
            for side in (node.left, node.right))  # int | None
    return False


class _FunctionLint:
    """Lints one function body with a forward taint pass."""

    def __init__(self, fn: ast.AST, filename: str, src_lines: Sequence[str],
                 findings: List[Finding],
                 inherited: Optional[set] = None) -> None:
        self.fn = fn
        self.filename = filename
        self.src_lines = src_lines
        self.findings = findings
        self.qualname = fn.name
        self.host_side = self._host_exempt()
        self.tainted: set = set(inherited or ())
        self._seed_params()

    # -- setup ---------------------------------------------------------
    def _host_exempt(self) -> bool:
        doc = ast.get_docstring(self.fn) or ""
        if "host-side" in doc.lower() or "host side" in doc.lower():
            return True
        for ln in range(max(self.fn.lineno - 2, 1), self.fn.lineno + 1):
            if ln - 1 < len(self.src_lines) and \
                    "lint: host" in self.src_lines[ln - 1]:
                return True
        return False

    def _seed_params(self) -> None:
        a = self.fn.args
        params = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
        defaults = list(a.defaults)
        # align defaults with the tail of posonly+args
        pos = list(a.posonlyargs) + list(a.args)
        defaulted = {p.arg for p, d in zip(pos[len(pos) - len(defaults):],
                                           defaults) if _is_literal(d)}
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if d is not None and _is_literal(d):
                defaulted.add(p.arg)
        for p in params:
            if p.arg in _HOST_PARAMS or p.arg in defaulted:
                continue
            if _scalar_annotation(p.annotation):
                continue
            self.tainted.add(p.arg)
        if a.vararg:
            self.tainted.add(a.vararg.arg)

    # -- reporting -----------------------------------------------------
    def _hit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(
            self.filename, getattr(node, "lineno", self.fn.lineno),
            getattr(node, "col_offset", 0), rule, self.qualname, msg))

    # -- expression taint (records findings as a side effect) ----------
    def taint(self, node: ast.AST) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            base = self.taint(node.value)
            if node.attr in _STATIC_ATTRS:
                return False
            return base
        if isinstance(node, ast.Subscript):
            self.taint(node.slice)
            return self.taint(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            lt = self.taint(node.left)
            rt = self.taint(node.right)
            return lt or rt
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            return any([self.taint(v) for v in node.values])
        if isinstance(node, ast.Compare):
            t = self.taint(node.left)
            for c in node.comparators:
                t = self.taint(c) or t
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in node.ops):
                return False    # identity tests are host-decidable
            return t
        if isinstance(node, ast.IfExp):
            if self.taint(node.test) and not self.host_side:
                self._hit(node, "traced-branch",
                          "ternary on a tensor (use torch.where)")
            return self.taint(node.body) or self.taint(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                self.taint(e)
            return False        # a host container OF tensors
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                self.taint(k)
                self.taint(v)
            return False
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._comprehension(node)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                self.taint(v)
            return False
        if isinstance(node, ast.FormattedValue):
            if self.taint(node.value) and not self.host_side:
                self._hit(node, "host-sync",
                          "formatting a tensor forces a host sync")
            return False
        if isinstance(node, ast.Slice):
            t = self.taint(node.lower) or self.taint(node.upper)
            return self.taint(node.step) or t
        if isinstance(node, ast.NamedExpr):
            t = self.taint(node.value)
            if t:
                self.tainted.add(node.target.id)
            return t
        if isinstance(node, ast.Lambda):
            return False
        return False

    def _comprehension(self, node: ast.AST) -> bool:
        for gen in node.generators:
            it = self.taint(gen.iter)
            for tgt in ast.walk(gen.target):
                if isinstance(tgt, ast.Name):
                    if it:
                        self.tainted.add(tgt.id)
                    else:
                        self.tainted.discard(tgt.id)
            for guard in gen.ifs:
                if self.taint(guard) and not self.host_side:
                    self._hit(guard, "traced-branch",
                              "comprehension guard on a tensor")
        if isinstance(node, ast.DictComp):
            self.taint(node.key)
            self.taint(node.value)
        else:
            self.taint(node.elt)
        return False            # comprehensions build host containers

    def _call(self, node: ast.Call) -> bool:
        arg_taints = [self.taint(a) for a in node.args]
        for kw in node.keywords:
            arg_taints.append(self.taint(kw.value))
        any_tainted_arg = any(arg_taints)
        name = _dotted(node.func)

        if name is not None:
            root = name.split(".", 1)[0]
            self._check_dtype_ctor(node, name)
            if not self.host_side:
                self._check_host_call(node, name)
                self._check_nondet(node, name)
            if name in _SYNC_BUILTINS and any_tainted_arg:
                if not self.host_side:
                    self._hit(node, "host-sync",
                              f"{name}() on a tensor blocks on a "
                              "device->host transfer")
                return False
            if name in _CONCRETE_LEN_BUILTINS and any_tainted_arg and \
                    not self.host_side:
                self._hit(node, "traced-branch",
                          f"{name}() over a tensor length (a host sync; "
                          "use a static bound from cfg)")
            if name in _HOST_BUILTINS:
                return False
            if name in _HOST_RESULT_CALLS:
                return False
            if root in _TRACED_ROOTS:
                return True

        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _HOST_METHODS:
                self.taint(node.func.value)
                return False
            if node.func.attr in _SYNC_METHODS and \
                    self.taint(node.func.value):
                if not self.host_side:
                    self._hit(node, "host-sync",
                              f".{node.func.attr}() on a tensor blocks "
                              "on a device->host transfer")
                return False
            # method on a tensor (.to, .sum, .clamp, .index_add_)
            return self.taint(node.func.value)
        # unknown local helper: assume host result (under-approximate)
        return False

    # -- per-call rule checks ------------------------------------------
    def _check_dtype_ctor(self, node: ast.Call, name: str) -> None:
        parts = name.split(".")
        if len(parts) != 2 or parts[0] != "torch":
            return
        if parts[1] not in _DTYPE_CTORS:
            return
        if any(kw.arg == "dtype" for kw in node.keywords):
            return
        self._hit(node, "dtype-drift",
                  f"torch.{parts[1]} without an explicit dtype: torch's "
                  "int64/float32 defaults are not the engine's int32 "
                  "lattice")

    def _check_host_call(self, node: ast.Call, name: str) -> None:
        if name == "print":
            self._hit(node, "host-call",
                      "print() in device code is a host round-trip "
                      "(mark the function host-side)")
            return
        for pref in _HOST_CALL_PREFIXES:
            if name == pref.rstrip(".") or name.startswith(pref):
                self._hit(node, "host-call",
                          f"`{name}` in device code runs on the host "
                          "(a numpy op on device data is a host "
                          "round-trip)")
                return

    def _check_nondet(self, node: ast.Call, name: str) -> None:
        for pref in _NONDET_PREFIXES:
            if name == pref.rstrip(".") or name.startswith(pref):
                self._hit(node, "nondeterminism",
                          f"`{name}` in device code: simulation output "
                          "must be a pure function of (config, traces, "
                          "fault_key)")
                return

    # -- statements ----------------------------------------------------
    def run(self) -> None:
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _assign_target(self, tgt: ast.AST, tainted: bool) -> None:
        if isinstance(tgt, ast.Name):
            if tainted:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign_target(e, tainted)
        elif isinstance(tgt, ast.Starred):
            self._assign_target(tgt.value, tainted)
        # attribute/subscript targets: no local binding to track

    def _stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = _FunctionLint(stmt, self.filename, self.src_lines,
                                self.findings, inherited=self.tainted)
            sub.qualname = f"{self.qualname}.{stmt.name}"
            sub.host_side = sub.host_side or self.host_side
            sub.run()
            return
        if isinstance(stmt, (ast.Assign,)):
            t = self.taint(stmt.value)
            for tgt in stmt.targets:
                self._assign_target(tgt, t)
            return
        if isinstance(stmt, ast.AnnAssign):
            t = self.taint(stmt.value) if stmt.value is not None else False
            self._assign_target(stmt.target, t)
            return
        if isinstance(stmt, ast.AugAssign):
            t = self.taint(stmt.value)
            if isinstance(stmt.target, ast.Name):
                if t:
                    self.tainted.add(stmt.target.id)
            return
        if isinstance(stmt, ast.If):
            if self.taint(stmt.test) and not self.host_side:
                self._hit(stmt, "traced-branch",
                          "Python `if` on a tensor: a host sync (use "
                          "torch.where)")
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.While):
            if self.taint(stmt.test) and not self.host_side:
                self._hit(stmt, "traced-branch",
                          "Python `while` on a tensor: a host sync each "
                          "trip (read it once a chunk in a host-side "
                          "runner)")
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.For):
            # iterating a tensor is static unrolling (legal); only a
            # tensor *length* syncs, caught at range() above
            self._assign_target(stmt.target, self.taint(stmt.iter))
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Assert):
            if self.taint(stmt.test) and not self.host_side:
                self._hit(stmt, "traced-branch",
                          "assert on a tensor: a host sync (use "
                          "ops.invariants)")
            return
        if isinstance(stmt, ast.Return):
            self.taint(stmt.value)
            return
        if isinstance(stmt, ast.Expr):
            self.taint(stmt.value)
            return
        if isinstance(stmt, (ast.With,)):
            for item in stmt.items:
                self.taint(item.context_expr)
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody +
                      [h for hh in stmt.handlers for h in hh.body]):
                self._stmt(s)
            return
        if isinstance(stmt, ast.Raise):
            self.taint(stmt.exc)
            return
        # Pass / Import / Global / Nonlocal / Delete / Break / Continue


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Lint one module's source text; returns findings (possibly empty)."""
    tree = ast.parse(src, filename=filename)
    src_lines = src.splitlines()
    findings: List[Finding] = []

    for stmt in tree.body:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                if alias.name.split(".", 1)[0] in _NONDET_IMPORTS:
                    findings.append(Finding(
                        filename, stmt.lineno, stmt.col_offset,
                        "nondeterminism", "<module>",
                        f"module-level `import {alias.name}` — banned "
                        "nondeterminism source in engine code"))
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.module and stmt.module.split(".", 1)[0] in \
                    _NONDET_IMPORTS:
                findings.append(Finding(
                    filename, stmt.lineno, stmt.col_offset,
                    "nondeterminism", "<module>",
                    f"module-level `from {stmt.module} import ...` — "
                    "banned nondeterminism source in engine code"))

    def walk_defs(body, prefix=""):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fl = _FunctionLint(stmt, filename, src_lines, findings)
                if prefix:
                    fl.qualname = f"{prefix}.{stmt.name}"
                fl.run()
            elif isinstance(stmt, ast.ClassDef):
                walk_defs(stmt.body, prefix=f"{prefix}.{stmt.name}"
                          if prefix else stmt.name)

    walk_defs(tree.body)
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def lint_file(path) -> List[Finding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), filename=str(p))


def default_targets() -> List[pathlib.Path]:
    """The device-code packages this linter gates: the port's ops/,
    parallel/ and models/."""
    pkg = pathlib.Path(__file__).resolve().parents[1]
    return [pkg / d for d in ("ops", "parallel", "models") if
            (pkg / d).is_dir()]


def lint_paths(paths: Optional[Iterable] = None) -> List[Finding]:
    """Lint every ``*.py`` under the given files/dirs (default targets
    when none are given); returns all findings sorted by location."""
    targets = [pathlib.Path(p) for p in paths] if paths else \
        default_targets()
    findings: List[Finding] = []
    for t in targets:
        files = sorted(t.rglob("*.py")) if t.is_dir() else [t]
        for f in files:
            findings.extend(lint_file(f))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


# -- no-torch boundary lint ------------------------------------------------

#: module roots banned in the daemon wire layer and the ops plane
_TORCH_ROOTS = {"torch"}


def no_torch_targets() -> List[pathlib.Path]:
    """The files that must stay torch-free: the daemon's wire layer and
    the live ops plane. A client submitting a job, the server's
    admission loop, a watch stream, a Prometheus scrape or a fleet poll
    never pays torch's import time or pulls in the accelerator stack."""
    pkg = pathlib.Path(__file__).resolve().parents[1]
    return [pkg / "daemon" / "server.py", pkg / "daemon" / "client.py",
            pkg / "obs" / "events.py", pkg / "obs" / "promexpo.py",
            pkg / "obs" / "burnrate.py", pkg / "obs" / "fleet.py"]


def lint_no_torch_source(src: str,
                         filename: str = "<string>") -> List[Finding]:
    """Flag every route by which ``src`` could reach torch: direct
    imports (any depth: ``import torch.cuda``, ``from torch import
    ...``), bare ``torch`` name references, and literal
    ``importlib.import_module("torch...")``."""
    tree = ast.parse(src, filename=filename)
    findings: List[Finding] = []

    def hit(node, msg):
        findings.append(Finding(filename, node.lineno, node.col_offset,
                                "no-torch", "<module>", msg))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".", 1)[0] in _TORCH_ROOTS:
                    hit(node, f"`import {alias.name}` in the daemon "
                              "wire layer: socket + json only; torch "
                              "belongs behind the engine boundary")
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0 and \
                    node.module.split(".", 1)[0] in _TORCH_ROOTS:
                hit(node, f"`from {node.module} import ...` in the "
                          "daemon wire layer: socket + json only; torch "
                          "belongs behind the engine boundary")
        elif isinstance(node, ast.Name) and node.id in _TORCH_ROOTS and \
                isinstance(node.ctx, ast.Load):
            hit(node, f"`{node.id}` referenced in the daemon wire "
                      "layer: device work belongs behind the engine "
                      "boundary")
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in ("importlib.import_module", "import_module") and \
                    node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) and \
                    node.args[0].value.split(".", 1)[0] in _TORCH_ROOTS:
                hit(node, f"import_module({node.args[0].value!r}) in "
                          "the daemon wire layer")
    findings.sort(key=lambda f: (f.file, f.line, f.col))
    return findings


def lint_no_torch(paths: Optional[Iterable] = None) -> List[Finding]:
    """Run the no-torch boundary pass over ``paths`` (default: the
    daemon wire layer and the ops plane)."""
    targets = [pathlib.Path(p) for p in paths] if paths else \
        no_torch_targets()
    findings: List[Finding] = []
    for p in targets:
        findings.extend(lint_no_torch_source(p.read_text(),
                                             filename=str(p)))
    findings.sort(key=lambda f: (f.file, f.line, f.col))
    return findings
