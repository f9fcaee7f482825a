"""Repo lint pass of the port: AST-enforced invariants of ``src/repro_torch``
(the counterpart of ``repro.analysis.repolint``, in the port's terms).

These are the conventions the other passes, the CPU conformance tests and
``chip_smoke.py`` quietly depend on. Each is cheap to check with ``ast``
and expensive to discover broken on the card:

* **Every kernel ships its oracle.** A ``kernels/<name>/`` package with an
  ``ops.py`` (the dispatch by device) must have a sibling ``ref.py`` (the
  plain PyTorch version the CPU takes and the card is held against), the
  ``csrc/<library>.cu`` of every library its launch plans name
  (``LaunchPlan("<library>", ...)`` in ``kernel.py``), and a
  ``tests/test_torch_kernels_<name>.py`` carrying the ``kernels`` pytest
  marker: the card's conformance lane.

* **Configs stay frozen dataclasses.** ``*Config`` classes are hashed,
  compared and shared between threads and ranks; any
  ``@dataclasses.dataclass`` class named ``*Config`` must pass
  ``frozen=True``.

* **The device probe stays confined.** ``torch.cuda.is_available()`` is
  asked in ``repro_torch/__init__.py`` alone (``has_card``, behind
  ``resolve_device``): every other call is a device decision taken behind
  the caller's back, where the port's rule is that the caller names the
  device and a missing card raises.

* **Threads opt into the concurrency contract.** Any ``threading.Thread``
  creation site must sit inside a class that declares ``_GUARDED_BY`` (may
  be ``{}``): the opt-in to the four ``repro_torch.analysis.concurrency``
  passes.

* **No reference imports.** No module of the port imports ``jax``,
  ``jaxlib`` or the JAX package ``repro``, at any depth of the AST (inside
  functions too, and through ``importlib.import_module`` / ``__import__``
  with a literal name): the port runs where there is no JAX.

Advisory (warnings, never fail the run): module-level imports never
referenced in the file, and bare ``except:`` handlers.
"""
from __future__ import annotations

import ast
import functools
import os
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.report import Finding, error, info, warning

PORT = ("src/repro_torch",)
# the one sanctioned torch.cuda.is_available() call site (repo-relative)
_PROBE_ALLOWED = ("src/repro_torch/__init__.py",)
# top-level modules the port must never import
_REFERENCE = ("jax", "jaxlib", "repro")


def find_repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this package) to the directory
    holding ``pyproject.toml``."""
    here = os.path.abspath(start or os.path.dirname(__file__))
    d = here
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return here
        d = parent


def _py_files(root: str, subdirs: Tuple[str, ...]) -> Iterator[str]:
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _parse(path: str) -> Optional[ast.AST]:
    """The module's AST (parsed once a version of the file: each check walks
    every module), None if it cannot be read or parsed."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return _parse_version(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=1024)
def _parse_version(path: str, mtime_ns: int, size: int) -> Optional[ast.AST]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


# ----------------------------------------------------- kernel/oracle pairs --


def plan_libraries(tree: ast.AST) -> List[str]:
    """The libraries a kernel module's launch plans name: the first argument
    (or ``library=``) of every ``LaunchPlan(...)`` call, when a string."""
    libs: List[str] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else ""
        if name != "LaunchPlan":
            continue
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "library"), None)
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value not in libs:
            libs.append(arg.value)
    return libs


def check_kernel_oracles(root: str) -> List[Finding]:
    """kernels/<name>/ops.py ⇒ sibling ref.py, the csrc/*.cu its plans name,
    and a marked tests/test_torch_kernels_<name>.py."""
    findings: List[Finding] = []
    kdir = os.path.join(root, "src", "repro_torch", "kernels")
    csrc = os.path.join(root, "src", "repro_torch", "csrc")
    if not os.path.isdir(kdir):
        return findings
    names: List[str] = []
    for name in sorted(os.listdir(kdir)):
        pkg = os.path.join(kdir, name)
        if not os.path.isdir(pkg) or not os.path.exists(os.path.join(pkg, "ops.py")):
            continue
        names.append(name)
        where = f"src/repro_torch/kernels/{name}"
        if not os.path.exists(os.path.join(pkg, "ref.py")):
            findings.append(error(
                "lint.kernel-oracle",
                f"kernels/{name}/ops.py has no ref.py: every kernel needs the plain "
                "PyTorch version the CPU takes and the card is held against bit for "
                "bit (see kernels/gibbs/ref.py for the pattern)",
                location=where))
        tree = _parse(os.path.join(pkg, "kernel.py"))
        libs = plan_libraries(tree) if tree is not None else []
        if not libs:
            findings.append(error(
                "lint.kernel-source",
                f"kernels/{name} names no library in a LaunchPlan(...) of its kernel.py: "
                "every launch computes its plan first, naming the csrc/<library>.cu "
                "it builds", location=where))
        for lib in libs:
            if not os.path.exists(os.path.join(csrc, f"{lib}.cu")):
                findings.append(error(
                    "lint.kernel-source",
                    f"kernels/{name} plans launches of '{lib}' but "
                    f"src/repro_torch/csrc/{lib}.cu does not exist",
                    location=where, library=lib))
        test_path = os.path.join(root, "tests", f"test_torch_kernels_{name}.py")
        if not os.path.exists(test_path):
            findings.append(error(
                "lint.kernel-test",
                f"kernels/{name} has no tests/test_torch_kernels_{name}.py: the "
                "`-m kernels` lane is the card's conformance suite; add a "
                "kernel-vs-plain test carrying `pytestmark = pytest.mark.kernels` "
                "(or the marker on its card cases)", location=where))
        else:
            tree = _parse(test_path)
            if tree is None or "kernels" not in _pytest_markers(tree):
                findings.append(error(
                    "lint.kernel-test",
                    f"tests/test_torch_kernels_{name}.py exists but carries no `kernels` "
                    "pytest marker: its card cases would not run in the `-m kernels` lane",
                    location=f"tests/test_torch_kernels_{name}.py"))
    if not any(f.severity == "error" for f in findings):
        findings.append(info(
            "lint.kernel-oracle",
            f"all {len(names)} kernel packages ({', '.join(names)}) have ref.py plain "
            "versions, their csrc sources and marked `-m kernels` tests",
            location="src/repro_torch/kernels"))
    return findings


def _pytest_markers(tree: ast.AST) -> Set[str]:
    """Marker names from ``pytestmark = pytest.mark.X`` / list-of-marks /
    ``@pytest.mark.X`` decorators / ``pytest.param(..., marks=pytest.mark.X)``."""
    marks: Set[str] = set()

    def mark_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Call):
            node = node.func
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "mark":
            return node.attr
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "pytestmark" for t in node.targets):
                vals = node.value.elts if isinstance(node.value, (ast.List, ast.Tuple)) \
                    else [node.value]
                marks.update(m for m in map(mark_name, vals) if m)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            marks.update(m for m in map(mark_name, node.decorator_list) if m)
        elif isinstance(node, ast.keyword) and node.arg == "marks":
            vals = node.value.elts if isinstance(node.value, (ast.List, ast.Tuple)) \
                else [node.value]
            marks.update(m for m in map(mark_name, vals) if m)
    return marks


# --------------------------------------------------------- frozen configs ---


def _dataclass_frozen(dec: ast.AST) -> Optional[bool]:
    """``frozen=`` value if ``dec`` is a dataclass decorator, else None."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = target.attr if isinstance(target, ast.Attribute) else \
        target.id if isinstance(target, ast.Name) else ""
    if name != "dataclass":
        return None
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "frozen":
                return bool(getattr(kw.value, "value", False))
    return False


def check_frozen_configs(root: str, subdirs: Tuple[str, ...] = PORT) -> List[Finding]:
    findings: List[Finding] = []
    n_configs = 0
    for path in _py_files(root, subdirs):
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) or not node.name.endswith("Config"):
                continue
            verdicts = [v for v in map(_dataclass_frozen, node.decorator_list) if v is not None]
            if not verdicts:
                continue               # not a dataclass: out of scope
            n_configs += 1
            if not any(verdicts):
                findings.append(error(
                    "lint.frozen-config",
                    f"{node.name} is a mutable dataclass: *Config classes are hashed, "
                    "compared and handed to every rank; declare "
                    "@dataclasses.dataclass(frozen=True) and use dataclasses.replace "
                    "for variants",
                    location=f"{_rel(root, path)}:{node.lineno}", cls=node.name))
    if not findings:
        findings.append(info("lint.frozen-config",
                             f"all {n_configs} *Config dataclasses are frozen",
                             location=subdirs[0]))
    return findings


# ------------------------------------------------------- the device probe ---


def _is_device_probe(node: ast.AST) -> bool:
    """``<x>.cuda.is_available`` (``torch.cuda.is_available`` however
    ``torch`` is bound)."""
    return isinstance(node, ast.Attribute) and node.attr == "is_available" \
        and isinstance(node.value, ast.Attribute) and node.value.attr == "cuda"


def check_device_probes(root: str, subdirs: Tuple[str, ...] = PORT) -> List[Finding]:
    findings: List[Finding] = []
    for path in _py_files(root, subdirs):
        rel = _rel(root, path)
        if rel in _PROBE_ALLOWED:
            continue
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if _is_device_probe(node):
                findings.append(error(
                    "lint.device-probe",
                    "torch.cuda.is_available() outside repro_torch/__init__.py: the "
                    "caller names the device and resolve_device raises on a missing "
                    "card; ask repro_torch.has_card() where a pass must know whether a "
                    "card is there, never fall back quietly",
                    location=f"{rel}:{node.lineno}"))
    if not findings:
        findings.append(info("lint.device-probe",
                             "torch.cuda.is_available() confined to repro_torch/__init__.py",
                             location=subdirs[0]))
    return findings


# ------------------------------------------------- thread opt-in contract ---


def _is_thread_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr == "Thread" and isinstance(f.value, ast.Name) and f.value.id == "threading"
    return isinstance(f, ast.Name) and f.id == "Thread"


def check_thread_conventions(root: str, subdirs: Tuple[str, ...] = PORT) -> List[Finding]:
    """Every ``threading.Thread(...)`` site must live inside a class that
    declares ``_GUARDED_BY``: the opt-in to the §12 concurrency passes."""
    findings: List[Finding] = []
    n_sites = 0
    for path in _py_files(root, subdirs):
        tree = _parse(path)
        if tree is None:
            continue
        annotated: List[Tuple[int, int, str]] = []
        classes: List[Tuple[int, int, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                span = (node.lineno, node.end_lineno or node.lineno, node.name)
                classes.append(span)
                if any(isinstance(st, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "_GUARDED_BY" for t in st.targets)
                       for st in node.body):
                    annotated.append(span)
        for node in ast.walk(tree):
            if not _is_thread_call(node):
                continue
            n_sites += 1
            if any(lo <= node.lineno <= hi for lo, hi, _ in annotated):
                continue
            owner = next((name for lo, hi, name in classes if lo <= node.lineno <= hi), None)
            findings.append(error(
                "lint.thread-contract",
                f"threading.Thread created in {f'class {owner}' if owner else 'module scope'} "
                "without a _GUARDED_BY declaration: every thread-creating class must opt "
                "into the concurrency contract (DESIGN.md §12) by declaring "
                "`_GUARDED_BY = {...}` (or `{}` with `# atomic: <rationale>` per "
                "lock-free shared field); threads outside a class must move into one",
                location=f"{_rel(root, path)}:{node.lineno}", cls=owner))
    if not any(f.severity == "error" for f in findings):
        findings.append(info(
            "lint.thread-contract",
            f"all {n_sites} threading.Thread sites live in _GUARDED_BY-annotated classes "
            "(concurrency passes cover them)", location=subdirs[0]))
    return findings


# ------------------------------------------------------ reference imports ---


def _reference(module: str) -> bool:
    return module.split(".")[0] in _REFERENCE


def _imported_modules(tree: ast.AST) -> Iterator[Tuple[int, str]]:
    """(line, module) of every absolute import at any depth, and of every
    ``importlib.import_module("...")`` / ``__import__("...")`` with a literal
    name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def check_reference_imports(root: str, subdirs: Tuple[str, ...] = PORT) -> List[Finding]:
    findings: List[Finding] = []
    n_files = 0
    for path in _py_files(root, subdirs):
        tree = _parse(path)
        if tree is None:
            continue
        n_files += 1
        for line, module in _imported_modules(tree):
            if _reference(module):
                findings.append(error(
                    "lint.reference-import",
                    f"the port imports '{module}': no module of src/repro_torch may import "
                    "jax, jaxlib or the JAX package repro (the card's machine has no JAX); "
                    "keep a copy of what the port needs under repro_torch instead",
                    location=f"{_rel(root, path)}:{line}", module=module))
    if not findings:
        findings.append(info("lint.reference-import",
                             f"none of the port's {n_files} modules imports jax, jaxlib or "
                             "repro", location=subdirs[0]))
    return findings


# ------------------------------------------------------------- advisories ---


def _used_names(tree: ast.AST) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            base = node
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name):
                used.add(base.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # string annotations / __all__ entries / doctest refs
            used.update(node.value.replace(".", " ").replace("[", " ").replace("]", " ").split())
    return used


def check_advisories(root: str, subdirs: Tuple[str, ...] = PORT) -> List[Finding]:
    """Warnings only: unused module-level imports and bare excepts."""
    findings: List[Finding] = []
    for path in _py_files(root, subdirs):
        if os.path.basename(path) == "__init__.py":
            continue                   # re-export surface: imports ARE the API
        tree = _parse(path)
        if tree is None:
            continue
        used = _used_names(tree)
        for node in tree.body:         # module level only
            if isinstance(node, ast.Import):
                names = [(a.asname or a.name.split(".")[0], a.name) for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                names = [(a.asname or a.name, a.name) for a in node.names if a.name != "*"]
            else:
                continue
            for bound, orig in names:
                if bound not in used and not bound.startswith("_"):
                    findings.append(warning("lint.unused-import",
                                            f"'{orig}' imported but unused",
                                            location=f"{_rel(root, path)}:{node.lineno}"))
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                findings.append(warning(
                    "lint.bare-except",
                    "bare `except:` catches SystemExit/KeyboardInterrupt: name the "
                    "exceptions (or `except Exception:` at worst)",
                    location=f"{_rel(root, path)}:{node.lineno}"))
    return findings


# ------------------------------------------------------------------ entry ---


def lint_repo(root: Optional[str] = None, advisories: bool = True) -> List[Finding]:
    """All repo-lint findings for the port's tree at ``root`` (auto-detected)."""
    root = root or find_repo_root()
    findings = (check_kernel_oracles(root) + check_frozen_configs(root)
                + check_device_probes(root) + check_thread_conventions(root)
                + check_reference_imports(root))
    if advisories:
        findings += check_advisories(root)
    return findings
