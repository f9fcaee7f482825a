"""Concurrency contract analyzer: static race/deadlock checks (DESIGN.md §12;
the port's own copy of ``repro.analysis.concurrency``, AST only, pass for
pass, so that the port imports nothing of the JAX package).

The serving/data path is genuinely concurrent — ``TopicEngine``'s batching
loop + lock-free ``swap_model``, ``SnapshotWatcher``'s hot-swap poller,
``SegmentStream``'s semaphore-gated prefetch thread, ``CheckpointManager``'s
async host snapshots — and the §11 preflight says nothing about threads.
This module closes that gap with four AST-level passes over every module
that creates a ``threading.Thread``. Same line as §11: **abstract eval
only** — sources are parsed, never imported, and no thread is ever started.

The in-code conventions the passes check (annotate, don't suppress):

* ``_GUARDED_BY = {"_pending": "_cv", ...}`` — class attribute mapping each
  shared field to the lock that guards it. Presence of ``_GUARDED_BY``
  (even ``{}``) is the class's opt-in to the contract; ``repolint`` makes
  it mandatory for any class that creates a thread.
* ``self._model_ref = ...  # atomic: <rationale>`` — declares a field
  intentionally lock-free (single-reference publish, disjoint index sets,
  single-owner handle ...). The rationale is required and shows up in the
  analyzer's inventory; an ``# atomic:`` without one is a config error.
* ``def _wait_timeout(self, now):  # requires: _cv`` — the method must only
  be called with ``_cv`` held. The analyzer assumes the lock inside the
  method and checks every intra-class call site actually holds it.

Passes (each emits :class:`repro_torch.analysis.report.Finding`):

1. **guards** — dataflow over each method tracking the set of locks held
   (``with self.<lock>:`` blocks, ``# requires:`` contracts): every access
   to a ``_GUARDED_BY`` field must hold its lock (``__init__`` before the
   first ``.start()`` is exempt — no second thread exists yet), and any
   undeclared attribute touched by both the thread target and a public
   method is an error.
2. **lockorder** — builds the cross-class lock-acquisition graph (nested
   ``with``, calls made while holding a lock into methods that acquire
   others), fails on cycles and non-reentrant self-edges, and flags
   blocking calls while holding a lock: ``Future.result()``, ``.join()``,
   blocking ``Queue.put/get``, ``Event.wait`` and ``Condition.wait`` on a
   *different* condition than the one held.
3. **lifecycle** — every created thread needs a stop signal consulted
   inside its target's loop, a ``.join()`` path somewhere in the class
   (``close()``/``stop()``/``wait()``), a double-start guard when the
   handle is assigned outside ``__init__``, and an actual ``.start()``.
4. **waitnotify** — ``Condition.wait`` must sit inside a while-predicate
   loop and hold its own condition; ``notify``/``notify_all`` must be
   called with the condition held; ``Event.wait(timeout=...)`` retry loops
   must either consult a stop flag or be deadline-bounded (a comparison in
   the loop condition).

Entry points: :func:`run` (repo discovery → all four passes, the
``preflight --passes concurrency`` pass), :func:`analyze_source` (one
in-memory module — how the mutation tests seed violations).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.report import Finding, error, info, warning

# fields assigned one of these are self-synchronizing primitives: they never
# need a _GUARDED_BY entry, and their kind drives the wait/notify checks
_SYNC_KINDS = {
    "Condition": "condition", "Lock": "lock", "RLock": "rlock",
    "Event": "event", "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore", "Barrier": "barrier",
    "Queue": "queue", "SimpleQueue": "queue", "LifoQueue": "queue",
    "PriorityQueue": "queue",
}

# attribute-method calls that mutate their receiver (self.X.append(...) is a
# write to X for the shared-undeclared check, not just a read)
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft", "remove",
    "clear", "add", "discard", "update", "setdefault", "sort", "reverse",
    "put", "put_nowait",
}

# identifiers that look like a stop signal (thread-lifecycle pass)
_STOP_RE = re.compile(r"stop|shutdown|quit|closed|cancel", re.IGNORECASE)

# method names too generic to resolve cross-class (a `.start()` on a Thread
# must not be mistaken for SnapshotWatcher.start)
_GENERIC_METHODS = {
    "start", "stop", "join", "run", "wait", "set", "clear", "get", "put",
    "result", "acquire", "release", "notify", "notify_all", "is_set",
    "is_alive", "close", "cancel", "append", "pop", "items", "values",
    "keys", "copy", "update", "add",
}

_ATOMIC_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=]*)?=.*#\s*atomic:\s*(\S.*)$")
_ATOMIC_BARE_RE = re.compile(r"#\s*atomic:\s*$")
_REQUIRES_RE = re.compile(r"#\s*requires:\s*([\w,\s]+?)\s*$")


# ------------------------------------------------------------ scan records --


@dataclasses.dataclass
class _Access:
    """One ``self.<attr>`` touch: where, read-or-write, locks held."""

    attr: str
    lineno: int
    write: bool
    held: FrozenSet[str]
    func: str


@dataclasses.dataclass
class _CallRec:
    """One call site: dotted chain, locks held, enclosing loops."""

    chain: Tuple[str, ...]
    lineno: int
    held: FrozenSet[str]
    loops: Tuple[ast.AST, ...]        # enclosing While/For nodes, outer→inner
    has_timeout: bool                 # a timeout arg/kwarg (or any positional)
    nonblocking: bool                 # block=False / *_nowait
    func: str


@dataclasses.dataclass
class _FuncScan:
    """Everything the passes need from one function body."""

    qualname: str                     # "method" or "method.<locals>.worker"
    node: ast.AST
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    calls: List[_CallRec] = dataclasses.field(default_factory=list)
    # (held_before, lock_attr, lineno) per `with self.<lock>:`
    acquires: List[Tuple[FrozenSet[str], str, int]] = \
        dataclasses.field(default_factory=list)
    self_calls: Set[str] = dataclasses.field(default_factory=set)
    local_sync: Dict[str, str] = dataclasses.field(default_factory=dict)
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    nested: List[str] = dataclasses.field(default_factory=list)
    start_lineno: Optional[int] = None   # first `.start()` (for __init__)


@dataclasses.dataclass
class _ThreadSite:
    """One ``threading.Thread(...)`` creation."""

    lineno: int
    creating_func: str
    target: Optional[str]             # "self._run" / "worker" / None
    handle_attr: Optional[str]        # self.<H> the Thread is assigned to
    handle_local: Optional[str]       # local var it is assigned to


@dataclasses.dataclass
class _ClassInfo:
    rel: str
    name: str
    node: ast.ClassDef
    guarded: Optional[Dict[str, str]] = None
    atomic: Dict[str, str] = dataclasses.field(default_factory=dict)
    requires: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)
    sync_fields: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    scans: Dict[str, _FuncScan] = dataclasses.field(default_factory=dict)
    thread_sites: List[_ThreadSite] = dataclasses.field(default_factory=list)

    def loc(self, lineno: int) -> str:
        return f"{self.rel}:{lineno}"

    @property
    def lockish(self) -> Set[str]:
        out = {a for a, k in self.sync_fields.items()
               if k in ("lock", "rlock", "condition")}
        if self.guarded:
            out |= set(self.guarded.values())
        return out


# ----------------------------------------------------------------- parsing --


def _chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Dotted name chain of an expression: ``self._cv.notify`` →
    ('self', '_cv', 'notify'). None when the base is not a plain name
    (subscripts, call results...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_thread_ctor(call: ast.Call) -> bool:
    ch = _chain(call.func)
    return ch is not None and (ch == ("threading", "Thread")
                               or ch[-1:] == ("Thread",) and len(ch) <= 2)


def _sync_kind(value: ast.AST) -> Optional[str]:
    """'condition'/'lock'/... if ``value`` constructs a sync primitive."""
    if not isinstance(value, ast.Call):
        return None
    ch = _chain(value.func)
    if ch is None:
        return None
    return _SYNC_KINDS.get(ch[-1]) if ch[0] in ("threading", "queue") \
        or len(ch) == 1 else None


class _Scanner:
    """One function's dataflow walk: locks held through ``with`` blocks,
    enclosing loops, attribute accesses, call sites."""

    def __init__(self, cls: _ClassInfo, scan: _FuncScan,
                 collector: "_ClassCollector"):
        self.cls = cls
        self.scan = scan
        self.collector = collector

    # -- statements ---------------------------------------------------------
    def walk(self, stmts, held: FrozenSet[str],
             loops: Tuple[ast.AST, ...]) -> None:
        for st in stmts:
            self.stmt(st, held, loops)

    def stmt(self, st: ast.AST, held: FrozenSet[str],
             loops: Tuple[ast.AST, ...]) -> None:
        if isinstance(st, (ast.With, ast.AsyncWith)):
            now = set(held)
            for item in st.items:
                self.expr(item.context_expr, frozenset(now), loops)
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self.scan.acquires.append(
                        (frozenset(now), lock, item.context_expr.lineno))
                    now.add(lock)
                if item.optional_vars is not None:
                    self.expr(item.optional_vars, frozenset(now), loops)
            self.walk(st.body, frozenset(now), loops)
        elif isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(st, ast.While):
                self.expr(st.test, held, loops)
            else:
                self.expr(st.iter, held, loops)
                self.expr(st.target, held, loops)
            inner = loops + (st,)
            self.walk(st.body, held, inner)
            self.walk(st.orelse, held, loops)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: executes later (thread target / callback) with NO
            # locks inherited from the definition site
            self.collector.scan_function(
                self.cls, st, f"{self.scan.qualname}.<locals>.{st.name}")
            self.scan.nested.append(st.name)
        elif isinstance(st, ast.ClassDef):
            return                      # nested classes: out of scope
        elif isinstance(st, ast.Assign):
            self._record_assign(st)
            for child in ast.iter_child_nodes(st):
                self.expr(child, held, loops)
        else:
            # If / Try / simple statements: no held/loop changes — recurse
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    self.stmt(child, held, loops)
                elif isinstance(child, ast.excepthandler):
                    self.walk(child.body, held, loops)
                elif isinstance(child, getattr(ast, "match_case", ())):
                    self.walk(child.body, held, loops)
                else:
                    self.expr(child, held, loops)

    def _record_assign(self, st: ast.Assign) -> None:
        if len(st.targets) != 1:
            return
        tgt = st.targets[0]
        if isinstance(tgt, ast.Name):
            kind = _sync_kind(st.value)
            if kind is not None:
                self.scan.local_sync[tgt.id] = kind
            ch = _chain(st.value)
            if ch is not None and len(ch) == 2 and ch[0] == "self":
                self.scan.aliases[tgt.id] = ch[1]    # t = self._thread
        elif isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            kind = _sync_kind(st.value)
            if kind is not None:
                self.cls.sync_fields[tgt.attr] = kind
            if isinstance(st.value, ast.Name):
                # self._thread = t publishes a local: the local is an alias
                # for the attribute from here on
                self.scan.aliases[st.value.id] = tgt.attr

    # -- expressions --------------------------------------------------------
    def expr(self, e: ast.AST, held: FrozenSet[str],
             loops: Tuple[ast.AST, ...]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                self.scan.accesses.append(_Access(
                    attr=node.attr, lineno=node.lineno,
                    write=isinstance(node.ctx, (ast.Store, ast.Del)),
                    held=held, func=self.scan.qualname))
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                ch = _chain(node.value)
                if ch is not None and len(ch) == 2 and ch[0] == "self":
                    # self.z[idx] = ... mutates z
                    self.scan.accesses.append(_Access(
                        attr=ch[1], lineno=node.lineno, write=True,
                        held=held, func=self.scan.qualname))
            elif isinstance(node, ast.Call):
                self._record_call(node, held, loops)

    def _record_call(self, call: ast.Call, held: FrozenSet[str],
                     loops: Tuple[ast.AST, ...]) -> None:
        if _is_thread_ctor(call):
            self._record_thread_site(call)
        ch = _chain(call.func)
        if ch is None:
            return
        kwnames = {kw.arg for kw in call.keywords}
        nonblocking = ch[-1].endswith("_nowait") or any(
            kw.arg == "block"
            and isinstance(kw.value, ast.Constant) and kw.value.value is False
            for kw in call.keywords)
        has_timeout = "timeout" in kwnames or bool(
            call.args and ch[-1] in ("wait", "acquire", "join"))
        if ch[-1] in ("put", "get") and len(call.args) > 1:
            has_timeout = True
        self.scan.calls.append(_CallRec(
            chain=ch, lineno=call.lineno, held=held, loops=loops,
            has_timeout=has_timeout, nonblocking=nonblocking,
            func=self.scan.qualname))
        if len(ch) == 2 and ch[0] == "self":
            self.scan.self_calls.add(ch[1])
        if ch[-1] == "start" and self.scan.start_lineno is None:
            self.scan.start_lineno = call.lineno
        # self.X.append(...) and friends mutate X
        if len(ch) == 3 and ch[0] == "self" and ch[-1] in _MUTATORS:
            self.scan.accesses.append(_Access(
                attr=ch[1], lineno=call.lineno, write=True, held=held,
                func=self.scan.qualname))

    def _record_thread_site(self, call: ast.Call) -> None:
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                ch = _chain(kw.value)
                if ch is not None:
                    target = ".".join(ch)
        self.cls.thread_sites.append(_ThreadSite(
            lineno=call.lineno, creating_func=self.scan.qualname,
            target=target, handle_attr=None, handle_local=None))

    def _lock_of(self, ce: ast.AST) -> Optional[str]:
        ch = _chain(ce)
        if ch is not None and len(ch) == 2 and ch[0] == "self" and \
                ch[1] in self.cls.lockish:
            return ch[1]
        return None


class _ClassCollector:
    """Parses one module's classes into :class:`_ClassInfo` records."""

    def __init__(self, rel: str, tree: ast.Module, lines: List[str]):
        self.rel = rel
        self.tree = tree
        self.lines = lines
        self.config_errors: List[Finding] = []

    def collect(self) -> List[_ClassInfo]:
        out = []
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = self._collect_class(node)
                if ci.thread_sites or ci.guarded is not None:
                    out.append(ci)
        return out

    def _collect_class(self, node: ast.ClassDef) -> _ClassInfo:
        cls = _ClassInfo(rel=self.rel, name=node.name, node=node)
        for st in node.body:
            if isinstance(st, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
                    for t in st.targets):
                cls.guarded = self._parse_guarded(st, cls)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[st.name] = st
        self._parse_comments(node, cls)
        # two phases: sync fields are discovered while scanning __init__, so
        # scan it first, then everything else (lock_of needs sync_fields)
        order = sorted(cls.methods, key=lambda m: m != "__init__")
        for name in order:
            self.scan_function(cls, cls.methods[name], name)
        # thread handle attribution: which attr/local holds each Thread
        self._attribute_handles(cls)
        return cls

    def scan_function(self, cls: _ClassInfo, fn: ast.AST,
                      qualname: str) -> None:
        scan = _FuncScan(qualname=qualname, node=fn)
        cls.scans[qualname] = scan
        held: FrozenSet[str] = frozenset(
            cls.requires.get(qualname, ()))
        _Scanner(cls, scan, self).walk(fn.body, held, ())

    def _parse_guarded(self, st: ast.Assign,
                       cls: _ClassInfo) -> Dict[str, str]:
        try:
            val = ast.literal_eval(st.value)
            if not isinstance(val, dict) or not all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in val.items()):
                raise ValueError
            return val
        except (ValueError, SyntaxError):
            self.config_errors.append(error(
                "concurrency.config",
                f"{cls.name}._GUARDED_BY must be a literal "
                "{'field': 'lock'} dict of strings",
                location=cls.loc(st.lineno), cls=cls.name))
            return {}

    def _parse_comments(self, node: ast.ClassDef, cls: _ClassInfo) -> None:
        end = node.end_lineno or len(self.lines)
        for lineno in range(node.lineno, min(end, len(self.lines)) + 1):
            line = self.lines[lineno - 1]
            m = _ATOMIC_RE.search(line)
            if m:
                cls.atomic[m.group(1)] = m.group(2).strip()
            elif _ATOMIC_BARE_RE.search(line):
                self.config_errors.append(error(
                    "concurrency.config",
                    f"{cls.name}: `# atomic:` needs a rationale on the "
                    "same line (why is this field safe without its lock?) "
                    "and must annotate a `self.<field> = ...` assignment",
                    location=f"{self.rel}:{lineno}", cls=cls.name))
        for name, fn in cls.methods.items():
            line = self.lines[fn.lineno - 1] \
                if fn.lineno - 1 < len(self.lines) else ""
            m = _REQUIRES_RE.search(line)
            if m:
                cls.requires[name] = tuple(
                    s.strip() for s in m.group(1).split(",") if s.strip())

    def _attribute_handles(self, cls: _ClassInfo) -> None:
        """Match each thread site to the attr/local its Thread lands in by
        re-walking the creating function's assignments."""
        for site in cls.thread_sites:
            scan = cls.scans.get(site.creating_func)
            if scan is None:
                continue
            for node in ast.walk(scan.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and _is_thread_ctor(node.value)
                        and node.value.lineno == site.lineno):
                    continue
                tgt = node.targets[0]
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    site.handle_attr = tgt.attr
                elif isinstance(tgt, ast.Name):
                    site.handle_local = tgt.id
            if site.handle_local is not None:
                # `t = Thread(...); ...; self._thread = t` publishes the
                # local into an attribute — the attribute is the real handle
                for node in ast.walk(scan.node):
                    if isinstance(node, ast.Assign) and \
                            isinstance(node.value, ast.Name) and \
                            node.value.id == site.handle_local and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0], ast.Attribute) and \
                            isinstance(node.targets[0].value, ast.Name) and \
                            node.targets[0].value.id == "self":
                        site.handle_attr = node.targets[0].attr
                        site.handle_local = None
                        break


# -------------------------------------------------------------- discovery ---


def _module_creates_threads(tree: ast.Module) -> bool:
    return any(isinstance(n, ast.Call) and _is_thread_ctor(n)
               for n in ast.walk(tree))


def collect_repo(root: str, subdirs: Tuple[str, ...] = ("src",)
                 ) -> Tuple[List[_ClassInfo], List[Finding]]:
    """Every thread-creating module's classes, parsed — never imported."""
    classes: List[_ClassInfo] = []
    config_errors: List[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    with open(path, "r", encoding="utf-8") as fh:
                        src = fh.read()
                except OSError:
                    continue
                if "Thread(" not in src and "_GUARDED_BY" not in src:
                    continue
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                cs, errs = collect_source(src, rel)
                classes.extend(cs)
                config_errors.extend(errs)
    return classes, config_errors


def collect_source(src: str, rel: str = "<memory>"
                   ) -> Tuple[List[_ClassInfo], List[Finding]]:
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as exc:
        return [], [error("concurrency.parse",
                          f"module does not parse: {exc}", location=rel)]
    if not (_module_creates_threads(tree) or "_GUARDED_BY" in src):
        return [], []
    coll = _ClassCollector(rel, tree, src.splitlines())
    classes = coll.collect()
    return classes, coll.config_errors


# ----------------------------------------------------------- reachability ---


def _reachable(cls: _ClassInfo, roots: List[str]) -> List[_FuncScan]:
    """Scans reachable from ``roots`` via self-calls + nested defs."""
    seen: Set[str] = set()
    todo = [r for r in roots if r in cls.scans]
    while todo:
        q = todo.pop()
        if q in seen:
            continue
        seen.add(q)
        scan = cls.scans[q]
        for m in scan.self_calls:
            if m in cls.scans:
                todo.append(m)
        for n in scan.nested:
            todo.append(f"{q}.<locals>.{n}")
    return [cls.scans[q] for q in sorted(seen)]


def _worker_roots(cls: _ClassInfo) -> List[str]:
    roots = []
    for site in cls.thread_sites:
        if site.target is None:
            continue
        if site.target.startswith("self."):
            roots.append(site.target[len("self."):])
        else:
            roots.append(
                f"{site.creating_func}.<locals>.{site.target}")
    return roots


# -------------------------------------------------------------- pass 1 ------


def check_guards(classes: List[_ClassInfo]) -> List[Finding]:
    """Lock discipline: guarded fields accessed under their lock; shared
    undeclared fields are errors; ``# requires:`` call sites checked."""
    findings: List[Finding] = []
    n_guarded = 0
    for cls in classes:
        if cls.guarded is None:
            continue          # repolint owns the "must opt in" invariant
        n_guarded += len(cls.guarded)
        findings.extend(_check_guard_config(cls))
        init_scan = cls.scans.get("__init__")
        init_start = init_scan.start_lineno if init_scan else None
        for qual, scan in cls.scans.items():
            for acc in scan.accesses:
                findings.extend(_check_access(cls, qual, acc, init_start))
            for call in scan.calls:
                findings.extend(_check_requires_site(cls, call))
        findings.extend(_check_undeclared_shared(cls))
    if not any(f.severity == "error" for f in findings):
        findings.append(info(
            "concurrency.guards",
            f"lock discipline holds: {n_guarded} guarded fields across "
            f"{sum(1 for c in classes if c.guarded is not None)} annotated "
            "classes, every access under its declared lock",
            location="src"))
    return findings


def _check_guard_config(cls: _ClassInfo) -> List[Finding]:
    findings = []
    for field, lock in (cls.guarded or {}).items():
        if cls.sync_fields.get(lock) not in ("lock", "rlock", "condition"):
            findings.append(error(
                "concurrency.config",
                f"{cls.name}._GUARDED_BY maps '{field}' to '{lock}', but "
                f"no `self.{lock} = threading.Lock()/Condition()` "
                "assignment exists in the class",
                location=cls.loc(cls.node.lineno), cls=cls.name,
                field=field, lock=lock))
        if field in cls.atomic:
            findings.append(error(
                "concurrency.config",
                f"{cls.name}.{field} is declared both in _GUARDED_BY and "
                "`# atomic:` — pick one contract",
                location=cls.loc(cls.node.lineno), cls=cls.name,
                field=field))
    return findings


def _check_access(cls: _ClassInfo, qual: str, acc: _Access,
                  init_start: Optional[int]) -> List[Finding]:
    lock = (cls.guarded or {}).get(acc.attr)
    if lock is None or acc.attr in cls.atomic:
        return []
    if lock in acc.held:
        return []
    if qual == "__init__" and (init_start is None
                               or acc.lineno < init_start):
        return []              # single-threaded: the worker doesn't exist yet
    verb = "write to" if acc.write else "read of"
    return [error(
        "concurrency.guard",
        f"{cls.name}.{qual}: {verb} guarded field '{acc.attr}' without "
        f"holding '{lock}' (declared in _GUARDED_BY) — wrap the access in "
        f"`with self.{lock}:`, or declare the field `# atomic:` with a "
        "rationale if it is intentionally lock-free",
        location=cls.loc(acc.lineno), cls=cls.name, field=acc.attr,
        lock=lock, method=qual)]


def _check_requires_site(cls: _ClassInfo, call: _CallRec) -> List[Finding]:
    if len(call.chain) != 2 or call.chain[0] != "self":
        return []
    needed = cls.requires.get(call.chain[1], ())
    missing = [lk for lk in needed if lk not in call.held]
    if not missing:
        return []
    return [error(
        "concurrency.guard",
        f"{cls.name}.{call.func} calls {call.chain[1]}() which declares "
        f"`# requires: {', '.join(needed)}` — but "
        f"{', '.join(missing)} is not held at the call site",
        location=cls.loc(call.lineno), cls=cls.name,
        method=call.func, callee=call.chain[1])]


def _check_undeclared_shared(cls: _ClassInfo) -> List[Finding]:
    worker_scans = _reachable(cls, _worker_roots(cls))
    if not worker_scans:
        return []
    public = [m for m in cls.methods
              if not m.startswith("_") or m == "__init__"]
    public_scans = _reachable(cls, [m for m in public if m != "__init__"])

    def attrs(scans: List[_FuncScan]) -> Dict[str, _Access]:
        out: Dict[str, _Access] = {}
        for s in scans:
            for a in s.accesses:
                out.setdefault(a.attr, a)
        return out

    worker_attrs = attrs(worker_scans)
    public_attrs = attrs(public_scans)
    written_outside_init = {
        a.attr for s in cls.scans.values() for a in s.accesses
        if a.write and s.qualname != "__init__"}
    findings = []
    for attr in sorted(set(worker_attrs) & set(public_attrs)):
        if attr in (cls.guarded or {}) or attr in cls.atomic or \
                attr in cls.sync_fields or attr in cls.methods:
            continue
        if attr not in written_outside_init:
            continue           # immutable after __init__: no race possible
        w, p = worker_attrs[attr], public_attrs[attr]
        findings.append(error(
            "concurrency.undeclared-shared",
            f"{cls.name}.{attr} is touched by the thread target "
            f"(via {w.func}, line {w.lineno}) AND a public method "
            f"(via {p.func}, line {p.lineno}) but is neither in "
            "_GUARDED_BY nor declared `# atomic:` — every field shared "
            "with a worker thread needs an explicit contract",
            location=cls.loc(min(w.lineno, p.lineno)), cls=cls.name,
            field=attr, worker=w.func, public=p.func))
    return findings


# -------------------------------------------------------------- pass 2 ------


def check_lock_order(classes: List[_ClassInfo]) -> List[Finding]:
    """Cross-class lock-acquisition graph: cycles, non-reentrant
    self-acquisition, and blocking calls while holding a lock."""
    findings: List[Finding] = []
    locks_of = _transitive_locks(classes)
    by_method: Dict[str, List[_ClassInfo]] = {}
    for cls in classes:
        for m in cls.methods:
            by_method.setdefault(m, []).append(cls)

    edges: Dict[Tuple[str, str], str] = {}   # (from, to) -> provenance

    def add_edge(frm: str, to: str, loc: str) -> None:
        if frm != to:
            edges.setdefault((frm, to), loc)

    for cls in classes:
        for qual, scan in cls.scans.items():
            for held_before, lock, lineno in scan.acquires:
                node = f"{cls.name}.{lock}"
                for h in held_before:
                    add_edge(f"{cls.name}.{h}", node, cls.loc(lineno))
                if lock in held_before and \
                        cls.sync_fields.get(lock) != "rlock":
                    findings.append(error(
                        "concurrency.lock-order",
                        f"{cls.name}.{qual} re-acquires non-reentrant "
                        f"'{lock}' while already holding it — "
                        "threading.Lock/Condition self-deadlock",
                        location=cls.loc(lineno), cls=cls.name, lock=lock))
            for call in scan.calls:
                if not call.held:
                    continue
                findings.extend(_check_blocking(cls, call))
                for callee_locks in _resolve_call_locks(
                        cls, call, locks_of, by_method):
                    for h in call.held:
                        add_edge(f"{cls.name}.{h}", callee_locks,
                                 cls.loc(call.lineno))

    findings.extend(_find_cycles(edges))
    if not any(f.severity == "error" for f in findings):
        n = len({n for e in edges for n in e})
        findings.append(info(
            "concurrency.lock-order",
            f"lock-acquisition graph is acyclic ({n} locks, "
            f"{len(edges)} ordered edges) and no blocking call is made "
            "while holding a lock", location="src"))
    return findings


def _transitive_locks(classes: List[_ClassInfo]) -> Dict[Tuple[str, str],
                                                         Set[str]]:
    """(class, method) → every 'Cls.lock' it may acquire, via self-calls."""
    locks: Dict[Tuple[str, str], Set[str]] = {}
    for cls in classes:
        for qual, scan in cls.scans.items():
            locks[(cls.name, qual)] = {
                f"{cls.name}.{lk}" for _, lk, _ in scan.acquires}
    changed = True
    while changed:
        changed = False
        for cls in classes:
            for qual, scan in cls.scans.items():
                cur = locks[(cls.name, qual)]
                for m in scan.self_calls:
                    extra = locks.get((cls.name, m), set()) - cur
                    if extra:
                        cur |= extra
                        changed = True
    return locks


def _resolve_call_locks(cls: _ClassInfo, call: _CallRec,
                        locks_of: Dict[Tuple[str, str], Set[str]],
                        by_method: Dict[str, List[_ClassInfo]]
                        ) -> Iterator[str]:
    meth = call.chain[-1]
    if len(call.chain) == 2 and call.chain[0] == "self":
        yield from locks_of.get((cls.name, meth), ())
        return
    if meth in _GENERIC_METHODS:
        return
    for other in by_method.get(meth, ()):
        if other.name != cls.name:
            yield from locks_of.get((other.name, meth), ())


def _check_blocking(cls: _ClassInfo, call: _CallRec) -> List[Finding]:
    meth = call.chain[-1]
    held = ", ".join(sorted(call.held))
    base = call.chain[-2] if len(call.chain) >= 2 else ""

    def blocked(what: str, fix: str) -> Finding:
        return error(
            "concurrency.blocking-while-locked",
            f"{cls.name}.{call.func}: {what} while holding '{held}' — "
            f"every other thread needing the lock stalls behind it; {fix}",
            location=cls.loc(call.lineno), cls=cls.name, call=meth,
            held=sorted(call.held))

    if meth == "result":
        return [blocked("Future.result()",
                        "resolve the future outside the critical section")]
    if meth == "join":
        return [blocked(".join()",
                        "snapshot the handle under the lock, join outside")]
    scan = cls.scans.get(call.func)
    base_kind = cls.sync_fields.get(base) if call.chain[0] == "self" else \
        (scan.local_sync.get(call.chain[0]) if scan and len(call.chain) == 2
         else None)
    if meth in ("put", "get") and base_kind == "queue" and \
            not (call.nonblocking or call.has_timeout):
        return [blocked(f"blocking Queue.{meth}()",
                        "use a timeout (retry loop) or block=False")]
    if meth == "wait" and base_kind == "condition" and \
            [h for h in call.held if h != base]:
        others = ", ".join(h for h in sorted(call.held) if h != base)
        return [blocked(f"Condition.wait on '{base}' (only releases "
                        f"'{base}', still holds '{others}')",
                        "never sleep on one lock while holding another")]
    if meth == "wait" and base_kind == "event" and not call.has_timeout:
        return [blocked("unbounded Event.wait()",
                        "wait outside the lock, or use a timeout loop")]
    return []


def _find_cycles(edges: Dict[Tuple[str, str], str]) -> List[Finding]:
    adj: Dict[str, List[str]] = {}
    for frm, to in edges:
        adj.setdefault(frm, []).append(to)
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    findings: List[Finding] = []

    def dfs(node: str, path: List[str]) -> None:
        color[node] = GREY
        path.append(node)
        for nxt in adj.get(node, ()):
            if color.get(nxt, WHITE) == WHITE:
                dfs(nxt, path)
            elif color.get(nxt) == GREY:
                cyc = path[path.index(nxt):] + [nxt]
                prov = [edges.get((a, b), "?")
                        for a, b in zip(cyc, cyc[1:])]
                findings.append(error(
                    "concurrency.lock-order",
                    "lock-order cycle: " + " -> ".join(cyc) + " (acquired "
                    "at " + "; ".join(prov) + ") — two threads taking "
                    "these locks in opposite orders deadlock; pick one "
                    "global order and restructure the nested acquisition",
                    location=prov[0] if prov else "",
                    cycle=cyc))
        path.pop()
        color[node] = BLACK

    for node in sorted(adj):
        if color.get(node, WHITE) == WHITE:
            dfs(node, [])
    return findings


# -------------------------------------------------------------- pass 3 ------


def check_lifecycle(classes: List[_ClassInfo]) -> List[Finding]:
    """Stop signal in the target loop, a join path, double-start guards."""
    findings: List[Finding] = []
    n_threads = 0
    for cls in classes:
        for site in cls.thread_sites:
            n_threads += 1
            findings.extend(_check_site(cls, site))
    if not any(f.severity == "error" for f in findings):
        findings.append(info(
            "concurrency.lifecycle",
            f"all {n_threads} thread-creation sites have stop signals, "
            "join paths and double-start guards", location="src"))
    return findings


def _check_site(cls: _ClassInfo, site: _ThreadSite) -> List[Finding]:
    findings: List[Finding] = []
    loc = cls.loc(site.lineno)
    if site.target is None:
        return [warning(
            "concurrency.lifecycle",
            f"{cls.name}.{site.creating_func} creates a Thread whose "
            "target the analyzer cannot resolve (pass `target=` a method "
            "or a local function)", location=loc, cls=cls.name)]
    root = site.target[len("self."):] if site.target.startswith("self.") \
        else f"{site.creating_func}.<locals>.{site.target}"
    scans = _reachable(cls, [root])
    if not scans:
        return [warning(
            "concurrency.lifecycle",
            f"{cls.name}.{site.creating_func}: thread target "
            f"'{site.target}' not found in the class",
            location=loc, cls=cls.name)]
    findings.extend(_check_stop_signal(cls, site, scans, loc))
    findings.extend(_check_join_path(cls, site, loc))
    findings.extend(_check_double_start(cls, site, loc))
    started = any(
        c.chain[-1] == "start" and len(c.chain) >= 2
        and (c.chain[-2] == site.handle_attr
             or c.chain[0] == site.handle_local
             or (site.handle_attr and c.chain[0] in
                 s.aliases and s.aliases.get(c.chain[0])
                 == site.handle_attr))
        for s in cls.scans.values() for c in s.calls)
    if not started and (site.handle_attr or site.handle_local):
        findings.append(warning(
            "concurrency.lifecycle",
            f"{cls.name}.{site.creating_func}: thread is created but "
            "never .start()ed", location=loc, cls=cls.name))
    return findings


def _loops_in(scan: _FuncScan) -> List[ast.AST]:
    return [n for n in ast.walk(scan.node)
            if isinstance(n, (ast.While, ast.For, ast.AsyncFor))
            and not isinstance(scan.node, ast.While)]


def _mentions_stop(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and _STOP_RE.search(n.id):
            return True
        if isinstance(n, ast.Attribute) and _STOP_RE.search(n.attr):
            return True
    return False


def _check_stop_signal(cls: _ClassInfo, site: _ThreadSite,
                       scans: List[_FuncScan], loc: str) -> List[Finding]:
    whiles = [w for s in scans for w in _loops_in(s)
              if isinstance(w, ast.While)]
    if not whiles:
        return []              # run-to-completion thread: nothing to stop
    # the stop flag must be consulted inside SOME loop of the target's
    # reachable code — an unconditional `while True:` worker is unstoppable
    for s in scans:
        for loop in _loops_in(s):
            if _mentions_stop(loop):
                return []
    return [error(
        "concurrency.thread-stop",
        f"{cls.name}: thread target '{site.target}' (started at "
        f"{loc}) loops without ever consulting a stop signal — close() "
        "can never terminate it; check a threading.Event (or a guarded "
        "stop flag) in the loop",
        location=loc, cls=cls.name, target=site.target)]


def _check_join_path(cls: _ClassInfo, site: _ThreadSite,
                     loc: str) -> List[Finding]:
    if site.handle_attr is not None:
        for s in cls.scans.values():
            for c in s.calls:
                if c.chain[-1] != "join":
                    continue
                base = c.chain[:-1]
                if base == ("self", site.handle_attr):
                    return []
                if len(base) == 1 and \
                        s.aliases.get(base[0]) == site.handle_attr:
                    return []
        return [error(
            "concurrency.thread-join",
            f"{cls.name}: thread stored in self.{site.handle_attr} "
            f"(created at {loc}) is never joined — close()/stop() must "
            "join the handle so shutdown is observable and the worker "
            "can't outlive its owner silently",
            location=loc, cls=cls.name, handle=site.handle_attr)]
    if site.handle_local is not None:
        scan = cls.scans.get(site.creating_func)
        if scan and any(c.chain[-1] == "join"
                        and c.chain[0] == site.handle_local
                        for c in scan.calls):
            return []
        return [error(
            "concurrency.thread-join",
            f"{cls.name}.{site.creating_func}: local thread "
            f"'{site.handle_local}' is never joined — join it in a "
            "finally: block so the worker can't outlive the function",
            location=loc, cls=cls.name, handle=site.handle_local)]
    return [warning(
        "concurrency.thread-join",
        f"{cls.name}.{site.creating_func}: Thread is not kept in a "
        "handle — nothing can ever join or observe it",
        location=loc, cls=cls.name)]


def _check_double_start(cls: _ClassInfo, site: _ThreadSite,
                        loc: str) -> List[Finding]:
    if site.handle_attr is None or site.creating_func == "__init__":
        return []              # __init__: no concurrent caller exists yet
    scan = cls.scans.get(site.creating_func)
    if scan is None:
        return []
    fn = scan.node
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and node.lineno < site.lineno:
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Attribute) and \
                        sub.attr == site.handle_attr:
                    return []
                if isinstance(sub, ast.Name) and \
                        scan.aliases.get(sub.id) == site.handle_attr:
                    return []
    # a prior call to a method that joins the handle also guards (wait())
    for c in scan.calls:
        if c.lineno >= site.lineno or len(c.chain) != 2 or \
                c.chain[0] != "self":
            continue
        callee = cls.scans.get(c.chain[1])
        if callee and any(
                cc.chain[-1] == "join" and site.handle_attr in cc.chain
                for cc in callee.calls):
            return []
    return [error(
        "concurrency.double-start",
        f"{cls.name}.{site.creating_func} assigns self."
        f"{site.handle_attr} = Thread(...) without first checking the "
        "handle — two concurrent callers spawn two workers (RuntimeError "
        "at best, a duplicate poller at worst); guard with `if self."
        f"{site.handle_attr} is not None and self.{site.handle_attr}"
        ".is_alive(): return` (or join the old handle first)",
        location=loc, cls=cls.name, handle=site.handle_attr)]


# -------------------------------------------------------------- pass 4 ------


def check_wait_notify(classes: List[_ClassInfo]) -> List[Finding]:
    """Condition.wait in a while-predicate loop + held; notify under the
    lock; Event.wait(timeout) loops stop-checked or bounded."""
    findings: List[Finding] = []
    n_sites = 0
    for cls in classes:
        for qual, scan in cls.scans.items():
            for call in scan.calls:
                kind, base = _sync_base(cls, scan, call)
                if kind is None:
                    continue
                meth = call.chain[-1]
                if kind == "condition" and meth == "wait":
                    n_sites += 1
                    findings.extend(_check_cv_wait(cls, call, base))
                elif kind == "condition" and meth in ("notify",
                                                      "notify_all"):
                    n_sites += 1
                    findings.extend(_check_notify(cls, call, base))
                elif kind == "event" and meth == "wait" and \
                        call.has_timeout:
                    n_sites += 1
                    findings.extend(_check_event_wait(cls, call, base))
    if not any(f.severity == "error" for f in findings):
        findings.append(info(
            "concurrency.wait-notify",
            f"wait/notify protocol holds at all {n_sites} sites: waits "
            "sit in predicate loops under their condition, notifies hold "
            "the lock, timed Event waits are stop-checked or bounded",
            location="src"))
    return findings


def _sync_base(cls: _ClassInfo, scan: _FuncScan,
               call: _CallRec) -> Tuple[Optional[str], str]:
    if len(call.chain) == 3 and call.chain[0] == "self":
        return cls.sync_fields.get(call.chain[1]), call.chain[1]
    if len(call.chain) == 2:
        name = call.chain[0]
        return scan.local_sync.get(name), name
    return None, ""


def _check_cv_wait(cls: _ClassInfo, call: _CallRec,
                   base: str) -> List[Finding]:
    findings = []
    if base not in call.held:
        findings.append(error(
            "concurrency.wait-loop",
            f"{cls.name}.{call.func}: Condition.wait on '{base}' without "
            f"holding it — `with self.{base}:` must wrap the wait "
            "(RuntimeError at runtime, and the predicate is unprotected)",
            location=cls.loc(call.lineno), cls=cls.name, field=base))
    if not call.loops:
        findings.append(error(
            "concurrency.wait-loop",
            f"{cls.name}.{call.func}: Condition.wait on '{base}' outside "
            "a while-predicate loop — wakeups are spurious and notify "
            "races the wait; re-check the predicate in a `while` around "
            "the wait",
            location=cls.loc(call.lineno), cls=cls.name, field=base))
    return findings


def _check_notify(cls: _ClassInfo, call: _CallRec,
                  base: str) -> List[Finding]:
    if base in call.held:
        return []
    return [error(
        "concurrency.notify-unlocked",
        f"{cls.name}.{call.func}: {call.chain[-1]}() on '{base}' without "
        f"holding it — a waiter can miss the wakeup between its predicate "
        f"check and its wait; notify inside `with self.{base}:`",
        location=cls.loc(call.lineno), cls=cls.name, field=base)]


def _check_event_wait(cls: _ClassInfo, call: _CallRec,
                      base: str) -> List[Finding]:
    if not call.loops:
        return []               # one bounded wait: fine
    loop = call.loops[-1]
    if _mentions_stop(loop):
        return []               # the retry loop consults a stop signal
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return []               # data-bounded iteration
    if any(isinstance(n, ast.Compare) for n in ast.walk(loop.test)):
        return []               # deadline-bounded predicate loop
    return [error(
        "concurrency.event-wait-loop",
        f"{cls.name}.{call.func}: Event.wait(timeout) retry loop on "
        f"'{base}' neither checks a stop flag nor is deadline-bounded — "
        "on shutdown it spins forever; gate the loop on the stop signal "
        "or a deadline comparison",
        location=cls.loc(call.lineno), cls=cls.name, field=base)]


# ------------------------------------------------------------------ entry ---


def analyze(classes: List[_ClassInfo],
            config_errors: List[Finding]) -> List[Finding]:
    return (list(config_errors)
            + check_guards(classes)
            + check_lock_order(classes)
            + check_lifecycle(classes)
            + check_wait_notify(classes))


def analyze_source(src: str, rel: str = "<memory>") -> List[Finding]:
    """All four passes over one in-memory module (mutation-test entry)."""
    classes, errs = collect_source(src, rel)
    return analyze(classes, errs)


def run(root: Optional[str] = None,
        subdirs: Tuple[str, ...] = ("src",)) -> List[Finding]:
    """Discovery + all four passes over the repo — the preflight pass."""
    from repro_torch.analysis import repolint

    root = root or repolint.find_repo_root()
    classes, errs = collect_repo(root, subdirs)
    findings = analyze(classes, errs)
    findings.append(info(
        "concurrency.inventory",
        f"analyzed {len(classes)} thread-bearing classes "
        f"({', '.join(sorted(c.name for c in classes))}), "
        f"{sum(len(c.thread_sites) for c in classes)} thread-creation "
        f"sites, {sum(len(c.atomic) for c in classes)} `# atomic:` "
        "declarations — zero threads started, sources never imported",
        location="src"))
    return findings
