"""The host-lint rules (H1–H4) over scanned modules + the guard map.

All four rules share one :class:`Program`: the merged module scans with
a name-resolution layer (class methods, typed attributes, import
aliases, declared callbacks), the thread-root set (auto-detected spawn
sites plus declared HTTP-handler roots), per-root reachability over the
call graph, and the lock-acquisition graph (nested ``with`` scopes
propagated through calls).

Resolution is deliberately optimistic where syntax runs out: an
unresolvable call contributes no edge, an unresolvable attribute chain
stops at the last typed link. That can only HIDE a finding, never
invent one — and the guard map's hints (``attr_types``, ``name_types``,
``callbacks``) close the gaps the real modules need, while the witness
layer (``witness.py``) covers the dynamic remainder at test time.

Three additions over the JAX package's rules, each driven by a guard
map field that is empty there (so the same fixtures under the same map
give the same findings): ``lock_factories`` turns ``with f(...):``
scopes into lock tokens (the port's per-index ``engine.mutation_lock``
and entry locks are handed out by functions), ``reentrant`` names the
RLock tokens whose re-acquisition is no self-deadlock, and
``call_guards`` makes every call of a function hold a lock (H1) — on
entry, or lexically at the call site, or because every caller holds it
when it calls in. Bare-name calls also resolve through the module's and
the function's own imports.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import field

from mpi_knn_tpu_torch.analysis.host.astscan import (
    Access,
    Call,
    FunctionInfo,
    ModuleScan,
)
from mpi_knn_tpu_torch.analysis.host.guards import ClassGuard, GuardMap

RULES = {
    "H1-lock-discipline": "every shared mutable attribute of a "
    "thread-crossing class is declared (guard map) and every access "
    "site holds its declared lock",
    "H2-lock-order": "the static lock-acquisition graph (nested with "
    "scopes through the call graph) is acyclic",
    "H3-confinement": "attributes declared confined to one thread root "
    "are unreachable from every other root",
    "H4-atomic-publish": "file writes in threaded modules flow through "
    "the atomic temp+os.replace helper",
}


@dataclasses.dataclass
class HostFinding:
    """One host-lint violation."""

    rule: str
    module: str
    where: str  # function qualname (or class qualname for map-level)
    message: str
    lineno: int = 0
    attr: str | None = None

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "module": self.module,
            "where": self.where,
            "lineno": self.lineno,
            "attr": self.attr,
            "message": self.message,
        }


@dataclasses.dataclass
class LockGraph:
    nodes: list[str] = field(default_factory=list)
    edges: list[tuple[str, str]] = field(default_factory=list)
    cycles: list[list[str]] = field(default_factory=list)

    @property
    def acyclic(self) -> bool:
        return not self.cycles

    def to_json(self) -> dict:
        return {
            "nodes": self.nodes,
            "edges": [list(e) for e in self.edges],
            "cycles": self.cycles,
            "acyclic": self.acyclic,
        }


class Program:
    """Merged scans + guard map with resolution, roots, reachability."""

    def __init__(self, scans: list[ModuleScan], guards: GuardMap) -> None:
        self.scans = scans
        self.guards = guards
        self.functions: dict[str, FunctionInfo] = {}
        self.func_module: dict[str, str] = {}
        self.classes = {}
        self.class_module: dict[str, str] = {}
        self.modules: dict[str, ModuleScan] = {}
        for scan in scans:
            self.modules[scan.module] = scan
            for qual, fn in scan.functions.items():
                self.functions[qual] = fn
                self.func_module[qual] = scan.module
            for qual, ci in scan.classes.items():
                self.classes[qual] = ci
                self.class_module[qual] = scan.module
        self.problems: list[str] = []
        for qual in sorted(guards.lock_factories):
            if qual not in self.functions:
                self.problems.append(
                    f"guard map lock factory {qual} is not a scanned "
                    "function (stale guard map?)"
                )
        self._edges: dict[str, set[str]] = {}
        self._build_edges()
        # root name -> member functions; multi_roots = roots that are
        # concurrent with THEMSELVES (several member functions — the
        # HTTP handler pair, the warm pool — or one target spawned from
        # several sites): a shared write reachable from one of those is
        # already a race without any second root
        self.multi_roots: set[str] = set()
        self.roots: dict[str, set[str]] = self._find_roots()
        self.roots_of: dict[str, set[str]] = self._reach()

    # -- lock token normalization ----------------------------------------

    def norm_lock(self, token: str) -> str | None:
        """Collapse Condition aliases (auto-detected and declared) onto
        their underlying lock; a ``with f(...)`` token becomes its
        declared factory's lock, or None when ``f`` hands out no declared
        lock."""
        if token.startswith("call:"):
            return self._factory_lock(token)
        if ":" in token or "." not in token:
            return token
        cls, attr = token.rsplit(".", 1)
        ci = self.classes.get(cls)
        if ci is not None and attr in ci.cond_aliases:
            return f"{cls}.{ci.cond_aliases[attr]}"
        cg = self.guards.classes.get(cls)
        if cg is not None and attr in cg.aliases:
            return f"{cls}.{cg.aliases[attr]}"
        return token

    def norm_held(self, held: tuple[str, ...]) -> set[str]:
        return {n for n in map(self.norm_lock, held) if n is not None}

    def _factory_lock(self, token: str) -> str | None:
        _, scope, dotted = token.split(":", 2)
        fn = self.functions.get(scope)
        module = scope if fn is None else self.func_module[scope]
        qual = self._resolve_dotted(module, dotted, fn)
        return None if qual is None else self.guards.lock_factories.get(qual)

    def _resolve_dotted(self, module: str, dotted: str,
                        fn: FunctionInfo | None) -> str | None:
        """A ``name`` or ``alias.name`` callee named through an import (of
        ``fn`` or of ``module``), or a module-level function of
        ``module``: its function qual."""
        if "." not in dotted:
            if f"{module}.{dotted}" in self.functions:
                return f"{module}.{dotted}"
            owner, name = None, dotted
        else:
            owner, name = dotted.rsplit(".", 1)
        imports = dict(self.modules[module].imports) if module in \
            self.modules else {}
        if fn is not None:
            imports.update(fn.imports)
        if owner is None:
            target = imports.get(name)
            if target is None or "." not in target:
                return None
            owner_dotted, name = target.rsplit(".", 1)
        else:
            owner_dotted = imports.get(owner)
            if owner_dotted is None:
                return None
        for key in self.modules:
            if owner_dotted == key or owner_dotted.endswith("." + key):
                qual = f"{key}.{name}"
                return qual if qual in self.functions else None
        return None

    def guard_token(self, cls: str, value: str) -> str:
        """A ``guarded=`` / ``serialized_by=`` value as a full token:
        bare attr names bind to the declaring class."""
        if ":" in value or "." in value:
            return self.norm_lock(value)
        return self.norm_lock(f"{cls}.{value}")

    # -- name resolution --------------------------------------------------

    def _class_of_local(self, fn: FunctionInfo, name: str) -> str | None:
        module = self.func_module[fn.qual]
        ctor = fn.local_ctors.get(name)
        if ctor is not None and ctor != "<ThreadPoolExecutor>":
            qual = ctor if ctor in self.classes else f"{module}.{ctor}"
            return qual if qual in self.classes else None
        alias = fn.local_self_aliases.get(name)
        if alias is not None and fn.cls is not None:
            return self.guards.attr_types.get(f"{fn.cls}.{alias}")
        hinted = self.guards.name_types.get(module, {}).get(name)
        if hinted is not None:
            return hinted
        return None

    def _module_key_of_import(self, module: str, alias: str) -> str | None:
        scan = self.modules.get(module)
        if scan is None:
            return None
        dotted = scan.imports.get(alias)
        if dotted is None:
            return None
        for key in self.modules:
            if dotted == key or dotted.endswith("." + key):
                return key
        return None

    def _resolve_nested(self, caller: str, name: str) -> str | None:
        """``name(...)`` — a lexically visible function: a nested
        sibling (walking out through the caller's nesting), then a
        module-level function, then a module-level class constructor."""
        module = self.func_module[caller]
        local = caller[len(module) + 1:].split(".")
        for i in range(len(local), -1, -1):
            qual = ".".join([module, *local[:i], name])
            if qual in self.functions:
                return qual
            ci = self.classes.get(qual)
            if ci is not None:
                return ci.methods.get("__init__")
        return None

    def resolve_call(self, call: Call) -> str | None:
        fn = self.functions[call.func]
        if call.owner is None:
            return self._resolve_nested(call.func, call.name) or \
                self._resolve_dotted(self.func_module[call.func], call.name,
                                     fn)
        if call.owner == "self":
            if fn.cls is None:
                return None
            ci = self.classes.get(fn.cls)
            if ci is not None and call.name in ci.methods:
                return ci.methods[call.name]
            return self._callback(fn.cls, call.name)
        if call.owner.startswith("self."):
            cls = self._walk_chain(fn.cls, call.owner[5:].split("."))
            if cls is None:
                return None
            ci = self.classes.get(cls)
            if ci is not None and call.name in ci.methods:
                return ci.methods[call.name]
            return self._callback(cls, call.name)
        # local variable or import alias
        cls = self._class_of_local(fn, call.owner)
        if cls is not None:
            ci = self.classes.get(cls)
            if ci is not None and call.name in ci.methods:
                return ci.methods[call.name]
            return self._callback(cls, call.name)
        modkey = self._module_key_of_import(
            self.func_module[call.func], call.owner
        )
        if modkey is not None:
            qual = f"{modkey}.{call.name}"
            if qual in self.functions:
                return qual
            ci = self.classes.get(qual)
            if ci is not None:
                return ci.methods.get("__init__")
        return self._resolve_dotted(self.func_module[call.func],
                                    f"{call.owner}.{call.name}", fn)

    def _callback(self, cls: str | None, name: str) -> str | None:
        if cls is None:
            return None
        target = self.guards.callbacks.get(f"{cls}.{name}")
        if target is not None and target not in self.functions:
            self.problems.append(
                f"guard map callback {cls}.{name} -> {target}: no such "
                "function in the scanned modules"
            )
            return None
        return target

    def _walk_chain(
        self, cls: str | None, links: list[str]
    ) -> str | None:
        cur = cls
        for link in links:
            if cur is None:
                return None
            cur = self.guards.attr_types.get(f"{cur}.{link}")
        return cur

    def resolve_access_pairs(
        self, access: Access
    ) -> list[tuple[str, str, str]]:
        """(class, attr, kind) pairs along an access chain — each typed
        link is an access to that class (intermediates read, the final
        link carries the recorded kind)."""
        fn = self.functions[access.func]
        if access.owner == "self":
            cur: str | None = access.cls
        elif access.owner == "":
            return []  # module globals are handled separately
        else:
            cur = self._class_of_local(fn, access.owner)
        if cur is None:
            return []
        links = access.chain.split(".")
        out: list[tuple[str, str, str]] = []
        for i, link in enumerate(links):
            kind = access.kind if i == len(links) - 1 else "read"
            out.append((cur, link, kind))
            nxt = self.guards.attr_types.get(f"{cur}.{link}")
            if nxt is None:
                break
            cur = nxt
        return out

    # -- call graph / roots / reachability --------------------------------

    def _build_edges(self) -> None:
        for qual, fn in self.functions.items():
            targets = self._edges.setdefault(qual, set())
            for call in fn.calls:
                t = self.resolve_call(call)
                if t is not None:
                    targets.add(t)

    def _resolve_spawn_target(
        self, fn: FunctionInfo, target: str
    ) -> str | None:
        if target.startswith("self."):
            links = target[5:].split(".")
            if len(links) == 1 and fn.cls is not None:
                ci = self.classes.get(fn.cls)
                if ci is not None:
                    return ci.methods.get(links[0])
                return None
            cls = self._walk_chain(fn.cls, links[:-1])
            if cls is None:
                return None
            ci = self.classes.get(cls)
            return None if ci is None else ci.methods.get(links[-1])
        if "." not in target:
            return self._resolve_nested(fn.qual, target)
        return None

    def _find_roots(self) -> dict[str, set[str]]:
        roots: dict[str, set[str]] = {}
        declared_names: dict[str, str] = {}
        spawn_sites: dict[str, int] = {}
        for name, quals in self.guards.roots.items():
            for q in quals:
                if q not in self.functions:
                    self.problems.append(
                        f"guard map root {name!r} names {q}, which is not "
                        "a scanned function (stale guard map?)"
                    )
                    continue
                declared_names[q] = name
                roots.setdefault(name, set()).add(q)
        for fn in self.functions.values():
            for spawn in fn.spawns:
                target = self._resolve_spawn_target(fn, spawn.target)
                if target is None:
                    continue
                name = declared_names.get(target, f"thread:{target}")
                roots.setdefault(name, set()).add(target)
                spawn_sites[name] = spawn_sites.get(name, 0) + 1
        for name, funcs in roots.items():
            if len(funcs) >= 2 or spawn_sites.get(name, 0) >= 2:
                self.multi_roots.add(name)
        return roots

    def _reach(self) -> dict[str, set[str]]:
        roots_of: dict[str, set[str]] = {q: set() for q in self.functions}
        for name, funcs in self.roots.items():
            seen: set[str] = set()
            dq = deque(funcs)
            while dq:
                cur = dq.popleft()
                if cur in seen:
                    continue
                seen.add(cur)
                dq.extend(self._edges.get(cur, ()))
            for q in seen:
                roots_of[q].add(name)
        return roots_of

    # -- lock graph -------------------------------------------------------

    def acquired_within(self) -> dict[str, set[str]]:
        """Per function: every lock token acquired by it or anything it
        (transitively) calls — fixpoint over the call graph."""
        acq = {
            q: self.norm_held(tuple(a.lock for a in fn.acquires))
            for q, fn in self.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for q in self.functions:
                for t in self._edges.get(q, ()):
                    extra = acq.get(t, set()) - acq[q]
                    if extra:
                        acq[q].update(extra)
                        changed = True
        return acq

    def lock_graph(self) -> tuple[LockGraph, list[HostFinding]]:
        acq = self.acquired_within()
        edges: set[tuple[str, str]] = set()
        findings: list[HostFinding] = []
        seen_self_edge: set[tuple[str, str]] = set()

        def add_edges(
            held: tuple[str, ...], acquired: set[str],
            fn: FunctionInfo, lineno: int,
        ) -> None:
            for h in self.norm_held(held):
                for a in acquired:
                    if h == a and h in self.guards.reentrant:
                        continue  # an RLock taken again by its holder
                    if h == a:
                        key = (fn.qual, h)
                        if key not in seen_self_edge:
                            seen_self_edge.add(key)
                            findings.append(HostFinding(
                                rule="H2-lock-order",
                                module=self.func_module[fn.qual],
                                where=fn.qual,
                                lineno=lineno,
                                attr=h,
                                message=f"{h} is (re)acquired while "
                                "already held — a non-reentrant "
                                "self-deadlock",
                            ))
                    else:
                        edges.add((h, a))

        for fn in self.functions.values():
            for a in fn.acquires:
                add_edges(a.held, self.norm_held((a.lock,)), fn, a.lineno)
            for call in fn.calls:
                if not call.held:
                    continue
                t = self.resolve_call(call)
                if t is not None:
                    add_edges(call.held, acq.get(t, set()), fn, call.lineno)

        nodes = sorted({n for e in edges for n in e} | {
            n
            for fn in self.functions.values()
            for n in self.norm_held(tuple(a.lock for a in fn.acquires))
        })
        graph = LockGraph(nodes=nodes, edges=sorted(edges))
        graph.cycles = _find_cycles(nodes, edges)
        for cyc in graph.cycles:
            findings.append(HostFinding(
                rule="H2-lock-order",
                module="*",
                where=" -> ".join(cyc),
                message="lock-acquisition cycle (potential deadlock): "
                + " -> ".join([*cyc, cyc[0]]),
            ))
        return graph, findings


def _find_cycles(
    nodes: list[str], edges: set[tuple[str, str]]
) -> list[list[str]]:
    """Cycles in the lock graph via iterative Tarjan SCC (an SCC with
    more than one node, or a self-loop, is a cycle)."""
    adj: dict[str, list[str]] = {n: [] for n in nodes}
    for a, b in sorted(edges):
        adj[a].append(b)
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        work: list[tuple[str, int]] = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            for i in range(pi, len(adj[node])):
                w = adj[node][i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or (node, node) in edges:
                    sccs.append(sorted(scc))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for n in nodes:
        if n not in index:
            strongconnect(n)
    return sccs


# ---------------------------------------------------------------------------
# H1 / H3: attribute discipline


def _class_guard(guards: GuardMap, cls: str) -> ClassGuard:
    return guards.classes.get(cls) or ClassGuard()


def check_attr_discipline(
    prog: Program, target_modules: set[str]
) -> tuple[list[HostFinding], list[dict]]:
    """H1 (lock discipline, enforced guard map, serialized classes,
    module globals) and H3 (confinement) over every scanned class of the
    target modules. Returns (findings, waivers-used)."""
    findings: list[HostFinding] = []
    waivers: list[dict] = []
    guards = prog.guards

    # resolved accesses grouped per owning class: (cls, attr) ->
    # list[(Access, kind)]
    by_class: dict[str, list[tuple[Access, str, str]]] = {}
    for fn in prog.functions.values():
        for access in fn.accesses:
            for cls, attr, kind in prog.resolve_access_pairs(access):
                by_class.setdefault(cls, []).append((access, attr, kind))

    serial_groups: dict[str, set[str]] = {}
    for cls, cg in guards.classes.items():
        if cg.serialized_by is not None:
            serial_groups.setdefault(
                prog.guard_token(cls, cg.serialized_by), set()
            ).add(cls)

    for cls in sorted(prog.classes):
        module = prog.class_module[cls]
        if module not in target_modules:
            continue
        ci = prog.classes[cls]
        cg = _class_guard(guards, cls)
        if cg.instance_per_thread is not None:
            continue  # per-thread instances: nothing shared to check
        accesses = by_class.get(cls, [])
        token = (
            None if cg.serialized_by is None
            else prog.guard_token(cls, cg.serialized_by)
        )
        if token is not None:
            group = serial_groups.get(token, {cls})
            findings.extend(_check_serialized(
                prog, cls, ci, token, group, accesses
            ))
            continue
        findings.extend(_check_guarded(prog, cls, ci, cg, accesses))
        findings.extend(_check_confined(prog, cls, cg, accesses))
        findings.extend(
            _check_undeclared(prog, cls, ci, cg, accesses)
        )
        for attr, why in sorted(cg.waivers.items()):
            waivers.append(
                {"where": f"{cls}.{attr}", "rationale": why}
            )
    # serialized / per-thread classes still surface declared waivers
    for cls in sorted(prog.classes):
        if prog.class_module[cls] not in target_modules:
            continue
        cg = _class_guard(guards, cls)
        if cg.serialized_by is not None or cg.instance_per_thread:
            for attr, why in sorted(cg.waivers.items()):
                waivers.append(
                    {"where": f"{cls}.{attr}", "rationale": why}
                )

    findings.extend(_check_globals(prog, target_modules, waivers))
    findings.extend(_check_call_guards(prog, target_modules))
    _check_stale_classes(prog, by_class)
    return findings, waivers


def _check_stale_classes(
    prog: Program, by_class: dict[str, list[tuple[Access, str, str]]]
) -> None:
    """A class entry of the map whose module was scanned must name a
    scanned class, and each attribute it guards, confines or waives must
    be one the source touches: an entry the code no longer matches would
    hollow the lint silently, so it is a problem (the report is not
    ok)."""
    scanned = set(prog.modules)
    for cls, cg in sorted(prog.guards.classes.items()):
        module = next(
            (m for m in sorted(scanned, key=len, reverse=True)
             if cls.startswith(m + ".")), None
        )
        if module is None:
            continue
        ci = prog.classes.get(cls)
        if ci is None:
            prog.problems.append(
                f"guard map class {cls} is not a class of the scanned "
                f"module {module} (stale guard map?)"
            )
            continue
        touched = {attr for _a, attr, _k in by_class.get(cls, [])}
        touched |= ci.init_attrs
        declared = set(cg.guarded) | set(cg.confined) | set(cg.waivers)
        for attr in sorted(declared - touched):
            prog.problems.append(
                f"guard map entry {cls}.{attr} names an attribute the "
                "scanned source never touches (stale guard map?)"
            )


def _held_on_entry(prog: Program, token: str) -> set[str]:
    """Functions entered with ``token`` held on every path: each has a
    resolved caller, is no thread root, and every resolved call into it
    holds the token (lexically, or because its caller is such a function
    too) — the greatest fixpoint over the call graph."""
    callers: dict[str, list[Call]] = {}
    for fn in prog.functions.values():
        for call in fn.calls:
            t = prog.resolve_call(call)
            if t is not None:
                callers.setdefault(t, []).append(call)
    rooted = {q for funcs in prog.roots.values() for q in funcs}
    held = set(callers) - rooted
    changed = True
    while changed:
        changed = False
        for q in sorted(held):
            if any(
                token not in prog.norm_held(c.held) and c.func not in held
                for c in callers[q]
            ):
                held.discard(q)
                changed = True
    return held


def _check_call_guards(
    prog: Program, target_modules: set[str]
) -> list[HostFinding]:
    """Every call of a ``call_guards`` function from a target module holds
    its lock: lexically at the call site, or on entry to the caller."""
    findings: list[HostFinding] = []
    for qual, lock in sorted(prog.guards.call_guards.items()):
        if qual not in prog.functions:
            prog.problems.append(
                f"guard map call guard names {qual}, which is not a "
                "scanned function (stale guard map?)"
            )
            continue
        token = prog.norm_lock(lock)
        entry = _held_on_entry(prog, token)
        for fn in prog.functions.values():
            if prog.func_module[fn.qual] not in target_modules:
                continue
            for call in fn.calls:
                if prog.resolve_call(call) != qual:
                    continue
                if token in prog.norm_held(call.held) or fn.qual in entry:
                    continue
                findings.append(HostFinding(
                    rule="H1-lock-discipline",
                    module=prog.func_module[fn.qual],
                    where=fn.qual,
                    lineno=call.lineno,
                    attr=qual,
                    message=f"{qual} must be called holding {token}, but "
                    f"{fn.qual} calls it without (held: "
                    f"{sorted(prog.norm_held(call.held)) or 'nothing'})",
                ))
    return findings


def _is_state_attr(ci: object, cg: ClassGuard, attr: str) -> bool:
    """Whether ``attr`` is data (not a method, lock, alias or
    thread-local)."""
    methods = getattr(ci, "methods", {})
    locks = getattr(ci, "lock_attrs", set())
    locals_ = getattr(ci, "local_attrs", set())
    return (
        attr not in methods
        and attr not in locks
        and attr not in locals_
        and attr not in cg.aliases
    )


def _check_serialized(
    prog: Program,
    cls: str,
    ci: object,
    token: str,
    group: set[str],
    accesses: list[tuple[Access, str, str]],
) -> list[HostFinding]:
    """Every touch of an externally-serialized class from outside its
    serialization group must hold the serializing lock."""
    findings = []
    cg = _class_guard(prog.guards, cls)
    for access, attr, _kind in accesses:
        if access.cls in group:
            continue  # intra-group: the boundary is the contract
        if not _is_state_attr(ci, cg, attr):
            continue
        if access.func.endswith(".__init__"):
            # construction precedes sharing: an out-of-group constructor
            # seeding a serialized class's state runs before any thread
            # can reach the object (in-group ctors were skipped above)
            continue
        if token not in prog.norm_held(access.held):
            findings.append(HostFinding(
                rule="H1-lock-discipline",
                module=prog.func_module[access.func],
                where=access.func,
                lineno=access.lineno,
                attr=f"{cls}.{attr}",
                message=f"access to externally-serialized {cls}.{attr} "
                f"without holding {token} (held: "
                f"{sorted(prog.norm_held(access.held)) or 'nothing'})",
            ))
    # method CALLS into the group from outside it
    for fn in prog.functions.values():
        if fn.cls in group:
            continue
        for call in fn.calls:
            t = prog.resolve_call(call)
            if t is None:
                continue
            t_cls = prog.functions[t].cls
            if t_cls != cls or t.endswith(".__init__"):
                continue
            if token not in prog.norm_held(call.held):
                findings.append(HostFinding(
                    rule="H1-lock-discipline",
                    module=prog.func_module[call.func],
                    where=call.func,
                    lineno=call.lineno,
                    attr=f"{cls}.{call.name}",
                    message=f"call into externally-serialized "
                    f"{cls}.{call.name} without holding {token}",
                ))
    return findings


def _check_guarded(
    prog: Program,
    cls: str,
    ci: object,
    cg: ClassGuard,
    accesses: list[tuple[Access, str, str]],
) -> list[HostFinding]:
    findings = []
    for access, attr, _kind in accesses:
        lock = cg.guarded.get(attr)
        if lock is None:
            continue
        if access.func.endswith(".__init__") and access.cls == cls:
            continue
        fname = access.func.rsplit(".", 1)[-1]
        if fname in cg.confined_methods:
            continue
        token = prog.guard_token(cls, lock)
        held = prog.norm_held(access.held)
        if token not in held:
            what = (
                f"under the WRONG lock ({sorted(held)})" if held
                else "with no lock held"
            )
            findings.append(HostFinding(
                rule="H1-lock-discipline",
                module=prog.func_module[access.func],
                where=access.func,
                lineno=access.lineno,
                attr=f"{cls}.{attr}",
                message=f"{cls}.{attr} is declared guarded by {token} "
                f"but accessed {what}",
            ))
    return findings


def _check_confined(
    prog: Program,
    cls: str,
    cg: ClassGuard,
    accesses: list[tuple[Access, str, str]],
) -> list[HostFinding]:
    findings = []
    for access, attr, _kind in accesses:
        root = cg.confined.get(attr)
        if root is None:
            continue
        if access.func.endswith(".__init__") and access.cls == cls:
            continue
        foreign = sorted(
            r for r in prog.roots_of.get(access.func, set()) if r != root
        )
        if foreign:
            findings.append(HostFinding(
                rule="H3-confinement",
                module=prog.func_module[access.func],
                where=access.func,
                lineno=access.lineno,
                attr=f"{cls}.{attr}",
                message=f"{cls}.{attr} is declared {root}-confined but "
                f"{access.func} is reachable from thread root(s) "
                f"{foreign}",
            ))
    return findings


def _check_undeclared(
    prog: Program,
    cls: str,
    ci: object,
    cg: ClassGuard,
    accesses: list[tuple[Access, str, str]],
) -> list[HostFinding]:
    """The enforcement teeth: an attribute NOT in the guard map, written
    outside __init__, and touched from >= 2 thread roots."""
    crossing_roots: set[str] = set()
    for m in getattr(ci, "methods", {}).values():
        crossing_roots |= prog.roots_of.get(m, set())
    declared = (
        set(cg.guarded) | set(cg.confined) | set(cg.waivers)
    )
    by_attr: dict[str, list[tuple[Access, str]]] = {}
    for access, attr, kind in accesses:
        if not _is_state_attr(ci, cg, attr) or attr in declared:
            continue
        if access.func.endswith(".__init__") and access.cls == cls:
            continue
        by_attr.setdefault(attr, []).append((access, kind))
    findings = []
    if (
        len(crossing_roots) < 2
        and not (crossing_roots & prog.multi_roots)
        and not cg.force_thread_crossing
    ):
        return findings
    for attr, uses in sorted(by_attr.items()):
        writes = [a for a, k in uses if k == "write"]
        if not writes:
            continue
        roots: set[str] = set()
        for a, _k in uses:
            roots |= prog.roots_of.get(a.func, set())
        if len(roots) >= 2 or roots & prog.multi_roots:
            w = writes[0]
            findings.append(HostFinding(
                rule="H1-lock-discipline",
                module=prog.class_module[cls],
                where=w.func,
                lineno=w.lineno,
                attr=f"{cls}.{attr}",
                message=f"undeclared shared attribute {cls}.{attr}: "
                f"mutated outside __init__ and touched from thread "
                f"roots {sorted(roots)}; declare it in the guard map "
                "(guarded/confined) or waive it with a rationale",
            ))
    return findings


def _check_globals(
    prog: Program, target_modules: set[str], waivers: list[dict]
) -> list[HostFinding]:
    findings = []
    for module in sorted(target_modules):
        scan = prog.modules.get(module)
        if scan is None:
            continue
        declared = prog.guards.module_guards.get(module, {})
        waived = prog.guards.module_waivers.get(module, {})
        for name, why in sorted(waived.items()):
            waivers.append({"where": f"{module}:{name}", "rationale": why})
        names = scan.mutable_globals - scan.module_locks
        for name in sorted(names):
            uses = [
                a
                for fn in scan.functions.values()
                for a in fn.accesses
                if a.owner == "" and a.attr == name
            ]
            lock = declared.get(name)
            if lock is not None:
                token = prog.norm_lock(lock)
                for a in uses:
                    if token not in prog.norm_held(a.held):
                        findings.append(HostFinding(
                            rule="H1-lock-discipline",
                            module=module,
                            where=a.func,
                            lineno=a.lineno,
                            attr=f"{module}:{name}",
                            message=f"module global {name} is declared "
                            f"guarded by {token} but accessed without it",
                        ))
                continue
            if name in waived:
                continue
            roots: set[str] = set()
            writes = [a for a in uses if a.kind == "write"]
            for a in uses:
                roots |= prog.roots_of.get(a.func, set())
            if writes and (len(roots) >= 2 or roots & prog.multi_roots):
                findings.append(HostFinding(
                    rule="H1-lock-discipline",
                    module=module,
                    where=writes[0].func,
                    lineno=writes[0].lineno,
                    attr=f"{module}:{name}",
                    message=f"undeclared shared module global {name}: "
                    f"written and touched from thread roots "
                    f"{sorted(roots)}; guard it (module_guards) or "
                    "waive it with a rationale",
                ))
    return findings


# ---------------------------------------------------------------------------
# H4: atomic publish


def check_atomic_publish(
    prog: Program, target_modules: set[str]
) -> tuple[list[HostFinding], list[dict]]:
    findings: list[HostFinding] = []
    waivers: list[dict] = []
    for module in sorted(target_modules):
        scan = prog.modules.get(module)
        if scan is None:
            continue
        for fn in scan.functions.values():
            for w in fn.writes:
                if fn.calls_os_replace:
                    continue  # the temp+replace idiom, in-function
                why = prog.guards.h4_waivers.get(fn.qual)
                if why is not None:
                    waivers.append(
                        {"where": f"{fn.qual}:{w.lineno}",
                         "rationale": why}
                    )
                    continue
                findings.append(HostFinding(
                    rule="H4-atomic-publish",
                    module=module,
                    where=fn.qual,
                    lineno=w.lineno,
                    attr=w.what,
                    message=f"truncating file write ({w.what}) in a "
                    "threaded module without the atomic temp+os.replace "
                    "idiom — route it through "
                    "mpi_knn_tpu_torch.utils.atomicio or waive it",
                ))
    return findings, waivers
