"""The port's lint: a standard-library AST lint for the hazards of the
port's int-domain core and of `torch.compile`, the counterpart of the JAX
package's ``tools/jaxlint.py``.

    python -m repro_torch.lint src/repro_torch     # exit 1 on findings
    python -m repro_torch.lint a.py b.py
    python src/repro_torch/lint.py src/repro_torch  # without torch

Rules, each the counterpart of one of jaxlint's:

INT-DOMAIN PURITY (``int-domain``, carried over as it is) — the
  exact-arithmetic core (`circuit/ir.py`, `approx/rewrite.py`,
  `approx/analyze.py`) proves error bounds with Python ints. An import of
  numpy or torch (module- or function-level) or a true division (``/``)
  in those modules would bring float semantics into the proofs.

RECOMPILE HAZARDS (``compile-in-loop``, for ``jit-in-loop``) —
  ``torch.compile(...)`` built inside a loop body makes a fresh compiled
  wrapper, and on its first call a fresh trace and compile, every
  iteration; ``torch.compile(f)(x)`` built and called in one expression
  inside a function does the same on every call. Hoist the construction
  to module scope, an attribute or a cached factory. A compiled function
  built once and called many times in a loop is not flagged.

HOST SYNCS AND DATA-DEPENDENT BRANCHES (``sync-in-compiled``, for
  ``numpy-in-jit`` and ``tracer-branch``) — inside a function decorated
  with ``@torch.compile`` (bare, called, or through ``functools.partial``),
  ``.item()``, ``.cpu()``, ``.numpy()`` and ``.tolist()`` copy a tensor to
  the host and break the graph, and a Python ``if``/``while`` whose test
  reads a tensor parameter branches on the data. A parameter is taken to
  be a tensor unless it is annotated with another type or has a literal
  default (a knob, on which dynamo guards). Reading a parameter's
  ``.shape``, ``.ndim``, ``.dtype`` or ``.device``, ``.dim()``,
  ``.size()`` or ``.numel()`` in a test is static and not flagged.

OBSERVABILITY BOUNDARY (``obs-in-compiled``, for ``obs-in-jit``) —
  `repro_torch.obs` spans, events and metrics are host-side: they take
  wall-clock time and append to process state. Inside a compiled body
  they run when dynamo traces, or break the graph. Telemetry wraps the
  call of a compiled function, never its body.

``static-argnames`` has no counterpart: `torch.compile` takes no static
argument names (it guards on every Python value it reads), so there is no
list to keep in step with the signature.

Standard library only, so it runs before any heavy dependency installs.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Set, Tuple

# modules held to exact-Python-int purity
INT_DOMAIN_MODULES = (
    "repro_torch/circuit/ir.py",
    "repro_torch/approx/rewrite.py",
    "repro_torch/approx/analyze.py",
)

FORBIDDEN_IN_INT_DOMAIN = ("numpy", "torch")

# tensor methods that copy to the host inside a compiled body
HOST_SYNCS = ("item", "cpu", "numpy", "tolist")

# reads of a tensor that are static under torch.compile
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad")
_STATIC_METHODS = ("dim", "size", "numel")

_OBS_SUBMODULES = ("trace", "metrics", "ring", "report", "prof", "xprof")


class Finding(NamedTuple):
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# recognising torch.compile
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """'torch.compile' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _compile_names(tree: ast.Module) -> Set[str]:
    """The dotted names that mean `torch.compile` in this file: it under
    each name ``torch`` is imported as, and ``from torch import compile``
    (the builtin ``compile`` is not torch's)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name == "torch":
                    names.add(f"{al.asname or 'torch'}.compile")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for al in node.names:
                if al.name == "compile":
                    names.add(al.asname or "compile")
    return names or {"torch.compile"}


def _is_compile_ref(node: ast.AST, names: Set[str]) -> bool:
    return _dotted(node) in names


def _is_compile_construction(node: ast.AST, names: Set[str]) -> bool:
    """``torch.compile(...)`` or ``functools.partial(torch.compile, ...)``."""
    if not isinstance(node, ast.Call):
        return False
    if _is_compile_ref(node.func, names):
        return True
    return (_dotted(node.func) in ("functools.partial", "partial")
            and bool(node.args) and _is_compile_ref(node.args[0], names))


def _is_compiled(fn: ast.FunctionDef, names: Set[str]) -> bool:
    """Decorated by ``@torch.compile``, ``@torch.compile(...)`` or
    ``@functools.partial(torch.compile, ...)``."""
    return any(_is_compile_ref(dec, names)
               or _is_compile_construction(dec, names)
               for dec in fn.decorator_list)


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """Parameters taken to hold tensors: neither annotated with a type
    other than a Tensor nor given a literal default."""
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    defaults = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    out: Set[str] = set()
    for p in (*pos, *a.kwonlyargs):
        ann = _dotted(p.annotation) if p.annotation is not None else ""
        if p.annotation is not None and not ann.endswith("Tensor"):
            continue
        if isinstance(defaults.get(p.arg), ast.Constant):
            continue
        out.add(p.arg)
    return out


def _data_names(test: ast.AST) -> Set[str]:
    """Names a branch's test reads as data: not as the base of a static
    attribute (``x.shape``) or method (``x.dim()``)."""
    static: Set[int] = set()
    for node in ast.walk(test):
        base = None
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            base = node.value
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and \
                node.func.attr in _STATIC_METHODS:
            base = node.func.value
        if isinstance(base, ast.Name):
            static.add(id(base))
    return {n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and id(n) not in static}


def _obs_aliases(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases, function aliases) the file binds to
    `repro_torch.obs`: ``from repro_torch.obs import trace as TR`` and
    ``import repro_torch.obs`` give modules, ``from repro_torch.obs.trace
    import span`` a function."""
    mods: Set[str] = set()
    funcs: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name == "repro_torch.obs" or \
                        al.name.startswith("repro_torch.obs."):
                    mods.add((al.asname or al.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "repro_torch.obs" or mod.startswith("repro_torch.obs."):
                for al in node.names:
                    bound = al.asname or al.name
                    if mod == "repro_torch.obs" and \
                            al.name in _OBS_SUBMODULES:
                        mods.add(bound)
                    else:
                        funcs.add(bound)
            elif mod == "repro_torch":
                for al in node.names:
                    if al.name == "obs":
                        mods.add(al.asname or al.name)
    return mods, funcs


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _check_int_domain(path: str, tree: ast.Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.name.split(".")[0] in FORBIDDEN_IN_INT_DOMAIN:
                    out.append(Finding(
                        path, node.lineno, "int-domain",
                        f"import of '{al.name}' in a pure-int module — "
                        "the error-bound proofs must not touch "
                        "float/array semantics"))
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] in FORBIDDEN_IN_INT_DOMAIN:
                out.append(Finding(
                    path, node.lineno, "int-domain",
                    f"import from '{node.module}' in a pure-int module"))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            out.append(Finding(
                path, node.lineno, "int-domain",
                "true division ('/') in a pure-int module — use '//' or "
                "shifts; '/' yields float"))
    return out


def _check_compiled_body(path: str, fn: ast.FunctionDef,
                         obs: Tuple[Set[str], Set[str]]) -> List[Finding]:
    out: List[Finding] = []
    tensors = _tensor_params(fn)
    obs_mods, obs_funcs = obs
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While)):
            hit = sorted(_data_names(node.test) & tensors)
            if hit:
                kw = "if" if isinstance(node, ast.If) else "while"
                out.append(Finding(
                    path, node.lineno, "sync-in-compiled",
                    f"Python '{kw}' on tensor parameter(s) "
                    f"{', '.join(hit)} inside compiled {fn.name}() — a "
                    "data-dependent branch; use torch.where or torch.cond"))
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            root = dotted.split(".")[0]
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in HOST_SYNCS and not node.args:
                out.append(Finding(
                    path, node.lineno, "sync-in-compiled",
                    f"'.{node.func.attr}()' inside compiled {fn.name}() — "
                    "a copy to the host that breaks the graph; keep it "
                    "outside the compiled function"))
            elif ((root in obs_mods and "." in dotted)
                  or dotted in obs_funcs
                  or dotted.startswith("repro_torch.obs.")):
                out.append(Finding(
                    path, node.lineno, "obs-in-compiled",
                    f"obs call '{dotted}' inside compiled {fn.name}() — "
                    "spans/events/metrics are host-side and would run at "
                    "trace time only; wrap the call instead"))
    return out


def _check_compile_in_loop(path: str, tree: ast.Module,
                           names: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[int] = set()
    # (a) built inside a loop body: a fresh wrapper (and compile) an
    # iteration
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for node in ast.walk(loop):
            if _is_compile_construction(node, names) and \
                    node.lineno not in seen:
                seen.add(node.lineno)
                out.append(Finding(
                    path, node.lineno, "compile-in-loop",
                    "torch.compile built inside a loop body — every "
                    "iteration builds (and on its first call compiles) a "
                    "fresh function; hoist the construction out of the "
                    "loop"))
    # (b) built and called in one expression inside a function
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    _is_compile_construction(node.func, names) and \
                    node.lineno not in seen:
                seen.add(node.lineno)
                out.append(Finding(
                    path, node.lineno, "compile-in-loop",
                    f"torch.compile built and called in one expression "
                    f"inside {fn.name}() — every call traces and "
                    "compiles again; bind the compiled function once "
                    "(module scope, attribute or cached factory)"))
    return out


def lint_file(path: Path, *, rel: Optional[str] = None) -> List[Finding]:
    """Lint one file. ``rel`` (posix) or the file's own absolute path
    ending in one of `INT_DOMAIN_MODULES` puts it under int-domain
    purity."""
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding(str(path), e.lineno or 0, "syntax", str(e.msg))]
    out: List[Finding] = []
    where = (rel if rel is not None else path.as_posix(),
             path.resolve().as_posix())
    if any(w.endswith(m) for w in where for m in INT_DOMAIN_MODULES):
        out.extend(_check_int_domain(str(path), tree))
    names = _compile_names(tree)
    out.extend(_check_compile_in_loop(str(path), tree, names))
    obs = _obs_aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                _is_compiled(node, names):
            out.extend(_check_compiled_body(str(path), node, obs))
    return out


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            rel = f.relative_to(root).as_posix() if root.is_dir() \
                else f.as_posix()
            out.extend(lint_file(f, rel=rel))
    return sorted(out, key=lambda f: (f.path, f.line))


def main(argv: Sequence[str]) -> int:
    args = [a for a in argv if not a.startswith("-")]
    if not args:
        print(__doc__)
        return 2
    findings = lint_paths(args)
    for f in findings:
        print(f)
    if findings:
        print(f"repro_torch.lint: {len(findings)} finding(s)")
        return 1
    print(f"repro_torch.lint: clean ({', '.join(args)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
