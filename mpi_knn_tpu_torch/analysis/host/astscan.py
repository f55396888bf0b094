"""AST scanner for the host concurrency lint.

One pass over a module's source produces a :class:`ModuleScan`: per
function (qualified by its lexical nesting, e.g.
``frontend.server._http_handler.Handler.do_POST``) the attribute
accesses with the lock context they happen under, the calls (with held
locks — the ingredient of the H2 acquisition graph), the thread spawns
(``threading.Thread(target=...)``, ``ThreadPoolExecutor.map/submit`` —
the auto-detected thread roots), and the file-write sites H4 prices.

The scanner is purely syntactic and deliberately conservative: it
resolves only what Python's surface syntax pins down — ``self``
attributes, module-level names, locals bound by ``x = ClassName(...)``
or ``x = self.attr`` (typed via the guard map's ``attr_types``). What it
cannot resolve it records as unresolved rather than guessing; the rules
treat unresolved edges as absent and the guard map carries explicit
hints (``name_types``, ``callbacks``) where the real modules need them.

Two additions over the JAX package's scanner, both for locks the port
hands out from functions rather than holding in attributes: a
``with f(...):`` scope records the raw token ``call:<scope>:<f>``
(the rules resolve it through the guard map's ``lock_factories`` and
drop it when ``f`` is no declared lock factory), and imports inside a
function body are recorded per function, so ``from m import f`` followed
by ``f(...)`` resolves as a call into ``m``.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import field

# method names that mutate their receiver in place: a call
# ``self.X.append(...)`` is a WRITE to ``X`` for lock-discipline
# purposes (the reference itself never rebinds)
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "remove", "discard",
    "clear", "update", "setdefault", "pop", "popleft", "popitem", "sort",
})

# modes of ``open`` that truncate/replace the target — the publication
# hazard H4 exists for ("a" appends, "r"/"x" never clobber a reader)
TRUNCATING_MODES = ("w", "wb", "w+", "wb+", "w+b")


@dataclasses.dataclass(frozen=True)
class Access:
    """One attribute (or tracked module-global) touch."""

    owner: str  # syntactic owner: "self", a local/closure name, or "" (global)
    attr: str  # first attribute link ("" for module globals: name in chain)
    chain: str  # full dotted chain after the owner (attr included)
    kind: str  # "read" | "write"
    lineno: int
    func: str  # qualname of the containing function
    cls: str | None  # innermost enclosing class qualname
    held: tuple[str, ...]  # raw lock tokens held at the access site


@dataclasses.dataclass(frozen=True)
class LockAcquire:
    """One ``with <lock>:`` entry."""

    lock: str  # raw token ("<cls>.<attr>" or "<module>:<name>")
    held: tuple[str, ...]  # tokens already held when this one is taken
    lineno: int
    func: str


@dataclasses.dataclass(frozen=True)
class Call:
    """One call site, with the locks held across it."""

    owner: str | None  # None = bare name; "self"; "self.X[.Y]"; local; alias
    name: str  # called function/method name
    held: tuple[str, ...]
    lineno: int
    func: str
    cls: str | None


@dataclasses.dataclass(frozen=True)
class Spawn:
    """One thread-root creation site."""

    target: str  # "self._run", "_warm", "self.warm", ... (syntactic)
    kind: str  # "thread" | "pool"
    lineno: int
    func: str


@dataclasses.dataclass(frozen=True)
class FileWrite:
    """One H4-relevant write site."""

    what: str  # "open-w" | "write_text" | "write_bytes"
    lineno: int
    func: str


@dataclasses.dataclass
class FunctionInfo:
    qual: str
    cls: str | None
    lineno: int
    calls: list[Call] = field(default_factory=list)
    accesses: list[Access] = field(default_factory=list)
    acquires: list[LockAcquire] = field(default_factory=list)
    spawns: list[Spawn] = field(default_factory=list)
    writes: list[FileWrite] = field(default_factory=list)
    calls_os_replace: bool = False
    # local name -> class qualname, from `x = ClassName(...)` and
    # (via guard-map attr_types, applied by the rules) `x = self.attr`
    local_ctors: dict[str, str] = field(default_factory=dict)
    local_self_aliases: dict[str, str] = field(default_factory=dict)
    # alias -> dotted, from imports inside the function body
    imports: dict[str, str] = field(default_factory=dict)


@dataclasses.dataclass
class ClassInfo:
    qual: str
    lineno: int
    methods: dict[str, str] = field(default_factory=dict)  # name -> func qual
    init_attrs: set[str] = field(default_factory=set)  # assigned in __init__
    lock_attrs: set[str] = field(default_factory=set)  # threading.Lock()/RLock()
    cond_aliases: dict[str, str] = field(default_factory=dict)  # Condition(x)
    local_attrs: set[str] = field(default_factory=set)  # threading.local()


@dataclasses.dataclass
class ModuleScan:
    module: str  # dotted key, e.g. "frontend.server"
    path: str
    functions: dict[str, FunctionInfo] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    module_locks: set[str] = field(default_factory=set)  # module-level Lock()s
    mutable_globals: set[str] = field(default_factory=set)  # written via global
    imports: dict[str, str] = field(default_factory=dict)  # alias -> dotted


def _is_threading_call(node: ast.expr, names: tuple[str, ...]) -> bool:
    """Whether ``node`` is a call to ``threading.<name>`` (or a bare
    imported ``<name>``) for any of ``names``."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id == "threading" and f.attr in names
    if isinstance(f, ast.Name):
        return f.id in names
    return False


def _dotted(node: ast.expr) -> str | None:
    """``a.b.c`` as a string, for Name/Attribute chains only."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Scanner:
    """Recursive walker with explicit scope, class, and held-lock state."""

    def __init__(self, module: str, path: str, tree: ast.Module) -> None:
        self.scan = ModuleScan(module=module, path=path)
        self._scope: list[str] = []  # lexical names (classes + functions)
        self._class_stack: list[ClassInfo] = []
        self._func_stack: list[FunctionInfo] = []
        self._held: list[str] = []
        self._collect_module_level(tree)
        for node in tree.body:
            self._visit(node)

    # -- module-level pre-pass -------------------------------------------

    def _collect_module_level(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                self.scan.mutable_globals.update(node.names)
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._record_import(node)
            if isinstance(node, ast.Assign) and _is_threading_call(
                node.value, ("Lock", "RLock")
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.scan.module_locks.add(t.id)

    def _record_import(self, node: ast.Import | ast.ImportFrom,
                       into: dict[str, str] | None = None) -> None:
        into = self.scan.imports if into is None else into
        if isinstance(node, ast.Import):
            for a in node.names:
                into[a.asname or a.name.split(".")[0]] = a.name
        else:
            mod = node.module or ""
            for a in node.names:
                into[a.asname or a.name] = f"{mod}.{a.name}"

    def _visit_Import(self, node: ast.Import) -> None:
        if self._fn is not None:
            self._record_import(node, self._fn.imports)

    def _visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if self._fn is not None:
            self._record_import(node, self._fn.imports)

    # -- scope helpers ----------------------------------------------------

    def _qual(self, name: str) -> str:
        return ".".join([self.scan.module, *self._scope, name])

    @property
    def _cls(self) -> ClassInfo | None:
        return self._class_stack[-1] if self._class_stack else None

    @property
    def _fn(self) -> FunctionInfo | None:
        return self._func_stack[-1] if self._func_stack else None

    # -- dispatch ---------------------------------------------------------

    def _visit(self, node: ast.AST) -> None:
        meth = getattr(self, f"_visit_{type(node).__name__}", None)
        if meth is not None:
            meth(node)
        else:
            self._generic(node)

    def _generic(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    # -- definitions ------------------------------------------------------

    def _visit_ClassDef(self, node: ast.ClassDef) -> None:
        info = ClassInfo(qual=self._qual(node.name), lineno=node.lineno)
        self.scan.classes[info.qual] = info
        self._scope.append(node.name)
        self._class_stack.append(info)
        held = self._held
        self._held = []  # a class body never runs under a caller's lock
        try:
            for child in node.body:
                self._visit(child)
        finally:
            self._held = held
            self._class_stack.pop()
            self._scope.pop()

    def _visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._def_function(node)

    def _visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._def_function(node)

    def _def_function(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef
    ) -> None:
        qual = self._qual(node.name)
        info = FunctionInfo(
            qual=qual,
            cls=self._cls.qual if self._cls else None,
            lineno=node.lineno,
        )
        self.scan.functions[qual] = info
        if self._cls is not None and len(self._func_stack) == 0:
            self._cls.methods[node.name] = qual
        self._scope.append(node.name)
        self._func_stack.append(info)
        held = self._held
        self._held = []  # lock context is not inherited lexically
        try:
            for child in node.body:
                self._visit(child)
        finally:
            self._held = held
            self._func_stack.pop()
            self._scope.pop()

    # -- locks / with -----------------------------------------------------

    def _lock_token(self, expr: ast.expr) -> str | None:
        """The raw lock token of a with-context expression, or None when
        the expression is not a recognizable lock (a chained attribute,
        a subscript, …)."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self._cls is not None
        ):
            return f"{self._cls.qual}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.scan.module_locks:
            return f"{self.scan.module}:{expr.id}"
        if isinstance(expr, ast.Call):
            dotted = _dotted(expr.func)
            if dotted is not None:
                # a lock handed out by a function (resolved, or dropped,
                # by the rules against the guard map's lock_factories),
                # scoped by the function whose imports name it
                scope = self._fn.qual if self._fn else self.scan.module
                return f"call:{scope}:{dotted}"
        return None

    def _visit_With(self, node: ast.With) -> None:
        tokens: list[str] = []
        for item in node.items:
            tok = self._lock_token(item.context_expr)
            self._visit(item.context_expr)
            if item.optional_vars is not None:
                self._note_with_alias(item)
                self._visit(item.optional_vars)
            if tok is not None:
                if self._fn is not None:
                    self._fn.acquires.append(LockAcquire(
                        lock=tok,
                        held=tuple(self._held),
                        lineno=item.context_expr.lineno,
                        func=self._fn.qual,
                    ))
                self._held.append(tok)
                tokens.append(tok)
        try:
            for child in node.body:
                self._visit(child)
        finally:
            for _ in tokens:
                self._held.pop()

    def _note_with_alias(self, item: ast.withitem) -> None:
        """``with ThreadPoolExecutor(...) as pool:`` — remember the pool
        name so ``pool.map(f, ...)`` registers a spawn."""
        fn = self._fn
        if fn is None or not isinstance(item.optional_vars, ast.Name):
            return
        ctx = item.context_expr
        if isinstance(ctx, ast.Call):
            dotted = _dotted(ctx.func) or ""
            if dotted.endswith("ThreadPoolExecutor"):
                fn.local_ctors[item.optional_vars.id] = "<ThreadPoolExecutor>"

    # -- assignments ------------------------------------------------------

    def _target_chain(self, t: ast.expr) -> tuple[str, str] | None:
        """(owner, chain) of an assignment target rooted at a name."""
        if isinstance(t, ast.Subscript):
            t = t.value
        dotted = _dotted(t)
        if dotted is None or "." not in dotted:
            return None
        owner, chain = dotted.split(".", 1)
        return owner, chain

    def _record_access(
        self, owner: str, chain: str, kind: str, lineno: int
    ) -> None:
        fn = self._fn
        if fn is None:
            return
        fn.accesses.append(Access(
            owner=owner,
            attr=chain.split(".")[0] if chain else "",
            chain=chain,
            kind=kind,
            lineno=lineno,
            func=fn.qual,
            cls=self._cls.qual if self._cls else None,
            held=tuple(self._held),
        ))

    def _visit_Assign(self, node: ast.Assign) -> None:
        self._handle_assign(node.targets, node.value, node.lineno)
        self._visit(node.value)
        for t in node.targets:
            self._visit_store_target(t)

    def _visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._handle_assign([node.target], None, node.lineno)
        self._visit(node.value)
        self._visit_store_target(node.target)

    def _visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        # `self.x: dict = {}` — same write semantics as a bare Assign
        if node.value is not None:
            self._handle_assign([node.target], node.value, node.lineno)
            self._visit(node.value)
        self._visit_store_target(node.target)

    def _visit_store_target(self, t: ast.expr) -> None:
        # subscript indices / nested tuples still contain reads
        if isinstance(t, ast.Subscript):
            self._visit(t.slice)
            self._visit_store_target(t.value)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._visit_store_target(e)
        elif isinstance(t, ast.Attribute):
            # the OWNER side of `self.a.b = x` is a read of `a`; the
            # write itself was recorded by _handle_assign
            pass
        # bare Name stores are locals/globals; globals recorded below

    def _handle_assign(
        self,
        targets: list[ast.expr],
        value: ast.expr | None,
        lineno: int,
    ) -> None:
        fn = self._fn
        for t in targets:
            pair = self._target_chain(t)
            if pair is not None:
                owner, chain = pair
                if owner == "self":
                    self._record_access(owner, chain, "write", lineno)
                    self._note_self_assign(t, value, chain)
                elif fn is not None:
                    self._record_access(owner, chain, "write", lineno)
            elif isinstance(t, ast.Name):
                if (
                    fn is not None
                    and t.id in self.scan.mutable_globals
                ):
                    self._record_access("", t.id, "write", lineno)
                self._note_local_bind(t.id, value)

    def _note_self_assign(
        self, target: ast.expr, value: ast.expr | None, chain: str
    ) -> None:
        """Track __init__ attrs, lock attrs, Condition aliases,
        threading.local attrs on the enclosing class."""
        cls = self._cls
        fn = self._fn
        if cls is None or fn is None or "." in chain:
            return
        attr = chain
        if fn.qual.endswith(".__init__") and fn.cls == cls.qual:
            cls.init_attrs.add(attr)
        if value is None:
            return
        if _is_threading_call(value, ("Lock", "RLock")):
            cls.lock_attrs.add(attr)
        elif _is_threading_call(value, ("Condition",)):
            cls.lock_attrs.add(attr)
            call = value
            assert isinstance(call, ast.Call)
            if call.args:
                inner = _dotted(call.args[0])
                if inner is not None and inner.startswith("self."):
                    cls.cond_aliases[attr] = inner.split(".", 1)[1]
        elif _is_threading_call(value, ("local",)):
            cls.local_attrs.add(attr)

    def _note_local_bind(self, name: str, value: ast.expr | None) -> None:
        """``x = ClassName(...)`` / ``x = self.attr`` local typing."""
        fn = self._fn
        if fn is None or value is None:
            return
        if isinstance(value, ast.Call):
            dotted = _dotted(value.func)
            if dotted is not None and dotted[:1].isupper():
                fn.local_ctors[name] = dotted  # same-module class name
            elif dotted is not None and dotted.endswith(
                "ThreadPoolExecutor"
            ):
                fn.local_ctors[name] = "<ThreadPoolExecutor>"
        else:
            dotted = _dotted(value)
            if dotted is not None and dotted.startswith("self.") \
                    and dotted.count(".") == 1:
                fn.local_self_aliases[name] = dotted.split(".", 1)[1]

    # -- names / attributes ----------------------------------------------

    def _visit_Name(self, node: ast.Name) -> None:
        if (
            isinstance(node.ctx, ast.Load)
            and node.id in self.scan.mutable_globals
            and self._fn is not None
        ):
            self._record_access("", node.id, "read", node.lineno)

    def _visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = _dotted(node)
        if dotted is None:
            self._generic(node)
            return
        owner, _, chain = dotted.partition(".")
        fn = self._fn
        if chain and fn is not None:
            # record for ANY named owner: the rules resolve what the
            # guard map types (locals, closures, name_types hints) and
            # drop the rest — recording narrowly here would blind H1 to
            # hinted owners the scanner cannot type itself
            self._record_access(owner, chain, "read", node.lineno)
        # no recursion: the whole chain is consumed

    # -- calls ------------------------------------------------------------

    def _visit_Call(self, node: ast.Call) -> None:
        fn = self._fn
        f = node.func
        dotted = _dotted(f)
        if fn is not None:
            self._record_call(node, dotted)
            self._detect_spawn(node, dotted)
            self._detect_write(node, dotted)
        # receiver chains are accesses too (``self.X.append`` reads X —
        # recorded as a WRITE below when the method mutates); visit args
        if dotted is None:
            self._visit(f)
        elif fn is not None and "." in dotted:
            owner, _, chain = dotted.partition(".")
            prefix = chain.rsplit(".", 1)[0] if "." in chain else ""
            meth = chain.rsplit(".", 1)[-1]
            if owner == "self":
                if meth in MUTATOR_METHODS and prefix:
                    self._record_access("self", prefix, "write", node.lineno)
                elif prefix:
                    self._record_access("self", prefix, "read", node.lineno)
            elif prefix and (
                owner in fn.local_ctors or owner in fn.local_self_aliases
            ):
                kind = "write" if meth in MUTATOR_METHODS else "read"
                self._record_access(owner, prefix, kind, node.lineno)
        for a in node.args:
            self._visit(a)
        for kw in node.keywords:
            self._visit(kw.value)

    def _record_call(self, node: ast.Call, dotted: str | None) -> None:
        fn = self._fn
        assert fn is not None
        if dotted is None:
            return  # chained call like f(...)(...): unresolvable
        if "." not in dotted:
            fn.calls.append(Call(
                owner=None, name=dotted, held=tuple(self._held),
                lineno=node.lineno, func=fn.qual,
                cls=self._cls.qual if self._cls else None,
            ))
            return
        owner_path, name = dotted.rsplit(".", 1)
        if owner_path == "os" and name == "replace":
            fn.calls_os_replace = True
        fn.calls.append(Call(
            owner=owner_path, name=name, held=tuple(self._held),
            lineno=node.lineno, func=fn.qual,
            cls=self._cls.qual if self._cls else None,
        ))

    def _detect_spawn(self, node: ast.Call, dotted: str | None) -> None:
        fn = self._fn
        assert fn is not None
        if _is_threading_call(node, ("Thread",)):
            for kw in node.keywords:
                if kw.arg == "target":
                    target = _dotted(kw.value)
                    if target is not None:
                        fn.spawns.append(Spawn(
                            target=target, kind="thread",
                            lineno=node.lineno, func=fn.qual,
                        ))
            return
        if dotted is not None and "." in dotted:
            owner_path, name = dotted.rsplit(".", 1)
            if (
                name in ("map", "submit")
                and fn.local_ctors.get(owner_path) == "<ThreadPoolExecutor>"
                and node.args
            ):
                target = _dotted(node.args[0])
                if target is not None:
                    fn.spawns.append(Spawn(
                        target=target, kind="pool",
                        lineno=node.lineno, func=fn.qual,
                    ))

    def _detect_write(self, node: ast.Call, dotted: str | None) -> None:
        fn = self._fn
        assert fn is not None
        if dotted == "open" or (dotted or "").endswith(".open"):
            mode = None
            if len(node.args) >= 2 and isinstance(
                node.args[1], ast.Constant
            ):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if isinstance(mode, str) and any(
                mode.startswith(m) for m in TRUNCATING_MODES
            ):
                fn.writes.append(FileWrite(
                    what="open-w", lineno=node.lineno, func=fn.qual,
                ))
            return
        if dotted is not None and "." in dotted:
            name = dotted.rsplit(".", 1)[1]
            if name in ("write_text", "write_bytes"):
                fn.writes.append(FileWrite(
                    what=name, lineno=node.lineno, func=fn.qual,
                ))


def scan_module(module: str, path: str) -> ModuleScan:
    """Parse and scan one source file into a :class:`ModuleScan`."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    return _Scanner(module, path, tree).scan
