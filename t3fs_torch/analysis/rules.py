"""The t3fslint rule set: one AST pass per file with async-context tracking.

Each rule is a method on ``FileLinter`` keyed by a rule id; the engine
(engine.py) parses files, runs the linter, and applies pragma/allowlist
suppression.  Rules are deliberately codebase-specific — the registries
below name *this repo's* RPC and status-returning surfaces so the rules
stay precise instead of pattern-matching half of asyncio.

Rule catalog (failure stories in docs/static_analysis.md):

  task-leak                   create_task/ensure_future result dropped on
                              the floor — asyncio holds only a weak ref,
                              so the GC can reap the task mid-flight.
  swallowed-cancellation      an except clause in an async def that eats
                              asyncio.CancelledError: bare ``except:``,
                              ``except BaseException``, or a tuple mixing
                              CancelledError with ordinary exceptions,
                              without re-raising.
  thread-lock-across-await    a threading.Lock/RLock held at an await —
                              every other coroutine that touches the lock
                              deadlocks the event loop.
  blocking-in-async           synchronous blocking work (time.sleep, sync
                              file I/O, subprocess, Future.result) on the
                              event loop thread — the static twin of
                              testing/race.py's LoopStallDetector.
  async-lock-await-discipline awaiting a network RPC while holding an
                              asyncio lock: the lock hold time becomes a
                              network RTT (or a retry storm).  Deliberate
                              sites (the CRAQ write pipeline) carry
                              pragmas with justification.
  status-discarded            an IOResult-returning write/remove/forward
                              call whose result is discarded — per-IO
                              failures travel in the result, not as
                              exceptions, so dropping it loses errors.
  naked-wait                  an unbounded wait primitive (Event.wait,
                              Queue.get, bare future) inside an
                              @rpc_method handler with no wait_for/timeout
                              — one lost wakeup wedges the RPC slot
                              forever.
  bare-create-task-in-handler spawning outside a class's tracked-task
                              ``_spawn`` helper (net/conn.py,
                              fuse/ring_worker.py pattern) — untracked
                              spawns dodge the teardown cancel/complete
                              machinery.
  span-not-closed             a tracing ``Span(...)`` constructed directly,
                              or a manual ``start_span(...)`` in a function
                              that never calls ``.finish()`` — an unfinished
                              span never reaches the SpanBuffer, so its
                              whole trace silently loses a leg.  Use the
                              ``span()``/``start_root()`` scopes, which
                              finish on exit.
  buffer-release-leak         ``handle, release = ....acquire(...)`` whose
                              release callable is never referenced again in
                              the enclosing function — the registered
                              buffer never returns to the BufferPool, and
                              a stale one-sided op can land in whoever
                              reuses the memory.  Call release() in a
                              finally (discard=True on failure paths) or
                              hand it to an owner.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# registries: this codebase's remote-I/O and status-carrying surfaces

# method/function names that perform (or directly drive) cross-node I/O;
# leading underscores are ignored when matching (self._forward -> forward)
RPC_CALL_NAMES = frozenset({
    "call", "post", "forward", "relay_frag", "remote_read", "remote_write",
    "batched_read", "batched_write", "submit_batched_write",
    "batch_read", "write_chunk", "read_chunk", "update_rpc", "drain",
    "sock_connect", "sock_accept",
})

# calls whose return value carries an IOResult / per-IO status that the
# write/remove/forward paths must check (exceptions only cover transport
# and gating failures, not per-IO outcomes)
STATUS_CALL_NAMES = frozenset({
    "write_chunk", "write_file_range", "remove_keys", "apply_update",
    "forward", "run_update",
})

TASK_SPAWN_NAMES = frozenset({"create_task", "ensure_future"})

# unbounded wait primitives for naked-wait (inside @rpc_method handlers)
WAIT_METHOD_NAMES = frozenset({"wait", "join"})

BLOCKING_CALLS = {
    ("time", "sleep"): "time.sleep() blocks the event loop; use "
                       "asyncio.sleep()",
    ("os", "system"): "os.system() blocks the event loop",
    ("os", "fsync"): "os.fsync() blocks the event loop; run it on a "
                     "worker (asyncio.to_thread / run_in_executor)",
    ("subprocess", "run"): "subprocess.run() blocks the event loop",
    ("subprocess", "call"): "subprocess.call() blocks the event loop",
    ("subprocess", "check_call"): "subprocess.check_call() blocks the "
                                  "event loop",
    ("subprocess", "check_output"): "subprocess.check_output() blocks "
                                    "the event loop",
    ("socket", "create_connection"): "socket.create_connection() blocks "
                                     "the event loop",
}

ALL_RULES = (
    "task-leak",
    "swallowed-cancellation",
    "thread-lock-across-await",
    "blocking-in-async",
    "async-lock-await-discipline",
    "status-discarded",
    "naked-wait",
    "bare-create-task-in-handler",
    "span-not-closed",
    "buffer-release-leak",
)
DEFAULT_RULES = frozenset(ALL_RULES)
# benchmarks/ and tests/ run a subset: they legitimately block, hold
# results loosely, and drive private surfaces — but a leaked task or a
# swallowed cancellation corrupts them exactly like production code
TEST_RULES = frozenset({
    "task-leak", "swallowed-cancellation", "thread-lock-across-await",
})


@dataclass
class RawFinding:
    line: int
    rule: str
    message: str
    # additional lines where a pragma also suppresses this finding (e.g.
    # the `async with` header of the lock hold an await sits inside)
    also_lines: tuple[int, ...] = ()


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_attr_name(call: ast.Call) -> str:
    """Trailing callee name of a call, underscores stripped:
    ``self._forward(...)`` -> ``forward``; ``foo(...)`` -> ``foo``."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr.lstrip("_")
    if isinstance(fn, ast.Name):
        return fn.id.lstrip("_")
    return ""


def _is_spawn_call(call: ast.Call) -> bool:
    name = _call_attr_name(call)
    return name in TASK_SPAWN_NAMES


def _lock_factory(call: ast.AST) -> str | None:
    """'thread' / 'async' if the expression constructs a lock.

    asyncio semaphores are deliberately NOT locks here: a Semaphore is an
    admission window, and holding one across I/O is its entire purpose
    (ckpt stripe windows, kvcache gc_concurrency) — only mutual-exclusion
    primitives make awaited I/O a serialization hazard."""
    if not isinstance(call, ast.Call):
        return None
    dotted = _dotted(call.func)
    tail = dotted.rsplit(".", 1)[-1]
    if dotted.startswith("threading.") and tail in ("Lock", "RLock"):
        return "thread"
    if dotted.startswith("asyncio.") and tail in ("Lock", "Condition"):
        return "async"
    return None


class _AwaitScanner(ast.NodeVisitor):
    """Collect Await nodes lexically inside a statement list, without
    descending into nested function definitions."""

    def __init__(self) -> None:
        self.awaits: list[ast.Await] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_Await(self, node: ast.Await) -> None:
        self.awaits.append(node)
        self.generic_visit(node)


def _awaits_in(stmts: list[ast.stmt]) -> list[ast.Await]:
    sc = _AwaitScanner()
    for s in stmts:
        sc.visit(s)
    return sc.awaits


class ModuleFacts(ast.NodeVisitor):
    """Pre-pass over a module: symbol tables the rules consult.

    - ``thread_locks``: names/attrs assigned ``threading.Lock()``/``RLock()``
    - ``async_locks``: names/attrs assigned asyncio Lock/Condition/Semaphore
    - ``spawn_classes``: classes defining a ``_spawn`` tracked-task helper
    - ``rpc_transitive``: function names that lexically await a registry
      RPC call, closed transitively over module-local calls — so a helper
      like ``_locked_update`` (which awaits ``self._forward``) counts as
      remote I/O at its own call sites.
    """

    def __init__(self, tree: ast.Module) -> None:
        self.thread_locks: set[str] = set()
        self.async_locks: set[str] = set()
        self.spawn_classes: set[str] = set()
        self._class_stack: list[str] = []
        self._fn_calls: dict[str, set[str]] = {}
        self._fn_rpc: set[str] = set()
        self._fn_stack: list[str] = []
        self.visit(tree)
        self.rpc_transitive = self._close_rpc()

    # -- assignments -> lock tables --

    def _record_target(self, target: ast.AST, kind: str) -> None:
        table = self.thread_locks if kind == "thread" else self.async_locks
        if isinstance(target, ast.Name):
            table.add(target.id)
        elif isinstance(target, ast.Attribute):
            table.add(target.attr)    # self._lock -> "_lock" (module-wide)

    def visit_Assign(self, node: ast.Assign) -> None:
        kind = _lock_factory(node.value)
        if kind:
            for t in node.targets:
                self._record_target(t, kind)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            kind = _lock_factory(node.value)
            if kind:
                self._record_target(node.target, kind)
        self.generic_visit(node)

    # -- class / function structure --

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name == "_spawn":
                self.spawn_classes.add(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node) -> None:
        self._fn_stack.append(node.name)
        self._fn_calls.setdefault(node.name, set())
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_attr_name(node)
        if self._fn_stack and name:
            self._fn_calls[self._fn_stack[-1]].add(name)
        self.generic_visit(node)

    def visit_Await(self, node: ast.Await) -> None:
        if self._fn_stack and isinstance(node.value, ast.Call):
            if _call_attr_name(node.value) in RPC_CALL_NAMES:
                self._fn_rpc.add(self._fn_stack[-1])
        self.generic_visit(node)

    def _close_rpc(self) -> set[str]:
        """Functions whose awaits reach an RPC call through module-local
        helpers (fixpoint over the intra-module call graph, by name)."""
        transitive = set(self._fn_rpc)
        changed = True
        local = {n.lstrip("_"): n for n in self._fn_calls}
        while changed:
            changed = False
            for fn, calls in self._fn_calls.items():
                if fn in transitive:
                    continue
                for c in calls:
                    callee = local.get(c)
                    if callee in transitive:
                        transitive.add(fn)
                        changed = True
                        break
        return transitive


class FileLinter(ast.NodeVisitor):
    """One pass over one module; findings accumulate in ``self.findings``."""

    def __init__(self, tree: ast.Module, rules: frozenset[str]) -> None:
        self.rules = rules
        self.facts = ModuleFacts(tree)
        self.findings: list[RawFinding] = []
        # context stacks
        self._fn: list[tuple[ast.AST, bool, bool]] = []   # (node, async, rpc)
        self._class: list[str] = []
        self.visit(tree)

    # -- helpers --

    def _emit(self, node: ast.AST, rule: str, message: str,
              also_lines: tuple[int, ...] = ()) -> None:
        if rule in self.rules:
            self.findings.append(RawFinding(
                getattr(node, "lineno", 0), rule, message, also_lines))

    def _in_async(self) -> bool:
        return bool(self._fn) and self._fn[-1][1]

    def _in_rpc_handler(self) -> bool:
        return bool(self._fn) and self._fn[-1][2]

    @staticmethod
    def _is_rpc_method(node) -> bool:
        for dec in node.decorator_list:
            if _dotted(dec).rsplit(".", 1)[-1] == "rpc_method":
                return True
        return False

    def _lockish(self, expr: ast.AST) -> str | None:
        """Classify an async-with context expr: 'async' lock, or None.
        Matches names/attrs assigned an asyncio lock type in this module,
        plus anything whose trailing name contains 'lock' (chunk_lock(...),
        _send_lock) — protocol knowledge beats type inference here."""
        e = expr
        if isinstance(e, ast.Call):
            name = _call_attr_name(e)
            if "lock" in name.lower():
                return "async"
            return None
        tail = e.attr if isinstance(e, ast.Attribute) else (
            e.id if isinstance(e, ast.Name) else "")
        if not tail:
            return None
        if tail in self.facts.async_locks or "lock" in tail.lower():
            return "async"
        return None

    @staticmethod
    def _same_object(await_call: ast.Call, lock_expr: ast.AST) -> bool:
        """True when the awaited call is a method of the lock object
        itself (cond.wait()/wait_for() release the lock — not a hold)."""
        fn = await_call.func
        if not isinstance(fn, ast.Attribute):
            return False
        return _dotted(fn.value) != "" and _dotted(fn.value) == _dotted(
            lock_expr)

    # -- function scaffolding --

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fn.append((node, False, False))
        self.generic_visit(node)
        self._fn.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._fn.append((node, True, self._is_rpc_method(node)))
        self.generic_visit(node)
        self._fn.pop()

    # -- buffer-release-leak --

    def visit_Assign(self, node: ast.Assign) -> None:
        if "buffer-release-leak" in self.rules:
            self._check_buffer_release(node)
        self.generic_visit(node)

    def _check_buffer_release(self, node: ast.Assign) -> None:
        """``handle, release = ....acquire(...)`` is the BufferPool
        protocol (net/rdma.py): the second element is the release
        callable that returns the registered buffer to its tier.  If the
        enclosing function never references it again — not called, not
        stored, not handed to anyone — the buffer leaks out of the pool
        AND stays registered, so a stale one-sided op can land in
        whatever reuses that memory.  Awaited acquires (channel/semaphore
        protocols) and scalar acquires (SlotAllocator) don't match."""
        v = node.value
        if not (isinstance(v, ast.Call) and _call_attr_name(v) == "acquire"):
            return
        if len(node.targets) != 1:
            return
        t = node.targets[0]
        if not (isinstance(t, ast.Tuple) and len(t.elts) == 2
                and all(isinstance(e, ast.Name) for e in t.elts)):
            return
        rel = t.elts[1].id
        fn_node = self._fn[-1][0] if self._fn else None
        if fn_node is None:
            return
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Name) and n.id == rel \
                    and isinstance(n.ctx, ast.Load):
                return    # called, stored, or handed to an owner
        self._emit(
            node, "buffer-release-leak",
            f"release callable `{rel}` from acquire() is never used in "
            "this function: the registered buffer never returns to the "
            "pool, and a stale one-sided op can land in whoever reuses "
            "the memory — release() in a finally (discard=True on "
            "failure paths), or pass it to an owner")

    # -- task-leak + bare-create-task-in-handler --

    def visit_Expr(self, node: ast.Expr) -> None:
        v = node.value
        call = v.value if isinstance(v, ast.Await) else v
        if isinstance(call, ast.Call) and _is_spawn_call(call):
            self._emit(
                node, "task-leak",
                "create_task result dropped: asyncio holds only a weak "
                "reference, so the GC can reap the task mid-flight — "
                "retain it or add a done-callback (see Connection._spawn)")
        if isinstance(v, ast.Await) and isinstance(v.value, ast.Call):
            name = _call_attr_name(v.value)
            if name in STATUS_CALL_NAMES:
                self._emit(
                    node, "status-discarded",
                    f"result of {name}() discarded: per-IO failures "
                    "travel in the returned IOResult/status, not as "
                    "exceptions — check it or the error is lost")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if "span-not-closed" in self.rules:
            self._check_span_closed(node)
        if _is_spawn_call(node) and self._class \
                and self._class[-1] in self.facts.spawn_classes:
            fn_node = self._fn[-1][0] if self._fn else None
            fn_name = getattr(fn_node, "name", "")
            if fn_name != "_spawn" and not self._assigned_to_self_attr(node):
                self._emit(
                    node, "bare-create-task-in-handler",
                    f"direct {_call_attr_name(node)}() in a class with a "
                    "_spawn tracked-task helper: spawn through _spawn (or "
                    "a self.<attr> slot) so teardown can cancel/await it")
        self.generic_visit(node)

    def _assigned_to_self_attr(self, call: ast.Call) -> bool:
        """True if this spawn call's value lands in a ``self.x`` slot or a
        container (list/dict element) — i.e. someone owns the task."""
        parent = getattr(call, "_t3fs_parent", None)
        while parent is not None:
            if isinstance(parent, ast.Assign):
                return True
            if isinstance(parent, (ast.List, ast.Tuple, ast.Dict, ast.Set,
                                   ast.Return, ast.Await, ast.keyword)):
                return True
            if isinstance(parent, ast.Call) and parent is not call:
                return True    # passed as an argument: the callee owns it
            if isinstance(parent, (ast.Expr, ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Module)):
                return False
            parent = getattr(parent, "_t3fs_parent", None)
        return False

    # -- span-not-closed --

    def _check_span_closed(self, node: ast.Call) -> None:
        """Two shapes leak spans: constructing ``Span(...)`` directly
        (nothing ever finishes it — the scope helpers exist precisely to
        pair construction with finish), and calling the manual
        ``start_span(...)`` API in a function that never calls
        ``.finish()`` on anything (the span sits in the buffer's trace
        state until TTL eviction and the trace loses the leg).  Handing
        the span across functions is the pragma path."""
        tail = _dotted(node.func).rsplit(".", 1)[-1]
        if tail == "Span":
            self._emit(
                node, "span-not-closed",
                "bare Span(...) constructed: nothing finishes it, so it "
                "never reaches the SpanBuffer and its trace silently "
                "loses this leg — use tracing.span()/start_root() scopes "
                "(finish on exit) or start_span() + finish()")
            return
        if tail != "start_span":
            return
        fn_node = self._fn[-1][0] if self._fn else None
        if fn_node is not None and self._fn_calls_finish(fn_node):
            return
        self._emit(
            node, "span-not-closed",
            "start_span(...) without a .finish() in the same function: "
            "the span never completes, so it is dropped at TTL expiry "
            "and its trace loses this leg — call finish() on every path "
            "(try/finally), or use the tracing.span() scope")

    @staticmethod
    def _fn_calls_finish(fn_node: ast.AST) -> bool:
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "finish":
                return True
        return False

    # -- swallowed-cancellation --

    def visit_Try(self, node: ast.Try) -> None:
        if self._in_async():
            cancelled_consumed = False
            for handler in node.handlers:
                if not cancelled_consumed:
                    self._check_handler(handler)
                # an earlier clause naming CancelledError (or BaseException,
                # or bare) catches it first — later clauses never see it
                tails = {n.rsplit(".", 1)[-1]
                         for n in self._caught_names(handler.type)}
                if handler.type is None or tails & {
                        "CancelledError", "BaseException"}:
                    cancelled_consumed = True
        self.generic_visit(node)

    def _check_handler(self, handler: ast.ExceptHandler) -> None:
        names = self._caught_names(handler.type)
        reraises = self._reraises(handler)
        if reraises:
            return
        if handler.type is None:
            self._emit(handler, "swallowed-cancellation",
                       "bare `except:` in an async def swallows "
                       "asyncio.CancelledError — the task becomes "
                       "uncancellable; re-raise or narrow the clause")
            return
        tails = {n.rsplit(".", 1)[-1] for n in names}
        if "BaseException" in tails:
            self._emit(handler, "swallowed-cancellation",
                       "`except BaseException` in an async def without "
                       "re-raise swallows asyncio.CancelledError — the "
                       "task becomes uncancellable")
        elif "CancelledError" in tails and len(tails) > 1:
            self._emit(handler, "swallowed-cancellation",
                       "except clause mixes CancelledError with ordinary "
                       "exceptions: the generic error path eats "
                       "cancellation — split the clause (catch "
                       "CancelledError alone; log unexpected exceptions)")

    @staticmethod
    def _caught_names(type_node: ast.AST | None) -> list[str]:
        if type_node is None:
            return []
        if isinstance(type_node, ast.Tuple):
            return [_dotted(e) for e in type_node.elts]
        return [_dotted(type_node)]

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        for stmt in ast.walk(ast.Module(body=handler.body,
                                        type_ignores=[])):
            if isinstance(stmt, ast.Raise):
                if stmt.exc is None:
                    return True
                if isinstance(stmt.exc, ast.Name) \
                        and stmt.exc.id == handler.name:
                    return True
                if isinstance(stmt.exc, ast.Call):
                    return True    # raise make_error(...) from e — surfaced
        return False

    # -- thread-lock-across-await --

    def visit_With(self, node: ast.With) -> None:
        if self._in_async():
            for item in node.items:
                e = item.context_expr
                tail = e.attr if isinstance(e, ast.Attribute) else (
                    e.id if isinstance(e, ast.Name) else "")
                if tail and tail in self.facts.thread_locks:
                    for aw in _awaits_in(node.body):
                        self._emit(
                            aw, "thread-lock-across-await",
                            f"await while holding threading lock "
                            f"`{tail}`: every coroutine contending on it "
                            "blocks the event loop thread — deadlock; "
                            "release before awaiting or switch to "
                            "asyncio.Lock",
                            also_lines=(node.lineno,))
        self.generic_visit(node)

    # -- async-lock-await-discipline --

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        for item in node.items:
            kind = self._lockish(item.context_expr)
            if kind != "async":
                continue
            for aw in _awaits_in(node.body):
                if not isinstance(aw.value, ast.Call):
                    continue
                call = aw.value
                if self._same_object(call, item.context_expr):
                    continue    # cond.wait()/wait_for() releases the lock
                name = _call_attr_name(call)
                if name in RPC_CALL_NAMES \
                        or name in self.facts.rpc_transitive \
                        or ("_" + name) in self.facts.rpc_transitive:
                    self._emit(
                        aw, "async-lock-await-discipline",
                        f"network I/O ({name}) awaited while holding "
                        "an asyncio lock: the critical section now spans "
                        "an RTT (or a retry storm) and serializes every "
                        "contender — move the I/O outside the lock, or "
                        "pragma the `async with` line with a "
                        "justification if the protocol requires it",
                        also_lines=(node.lineno,))
        self.generic_visit(node)

    # -- blocking-in-async, naked-wait --

    def visit_Await(self, node: ast.Await) -> None:
        if self._in_rpc_handler() and "naked-wait" in self.rules:
            self._check_naked_wait(node)
        self.generic_visit(node)

    def _check_naked_wait(self, node: ast.Await) -> None:
        v = node.value
        if not isinstance(v, ast.Call):
            return
        fn = v.func
        if not isinstance(fn, ast.Attribute):
            return
        if fn.attr not in WAIT_METHOD_NAMES:
            return
        if _dotted(fn.value).startswith("asyncio"):
            return    # asyncio.wait(...) takes a timeout kwarg path
        if any(kw.arg == "timeout" for kw in v.keywords):
            return
        self._emit(
            node, "naked-wait",
            f"unbounded `await ....{fn.attr}()` inside an @rpc_method "
            "handler: one lost wakeup (peer died, event never set) wedges "
            "this RPC slot forever — wrap in asyncio.wait_for or pass a "
            "timeout")

    def _blocking_message(self, call: ast.Call) -> str | None:
        dotted = _dotted(call.func)
        if dotted:
            parts = tuple(dotted.rsplit(".", 2)[-2:])
            if parts in BLOCKING_CALLS:
                return BLOCKING_CALLS[parts]
            if dotted == "open":
                return ("sync file I/O (open) on the event loop — use "
                        "asyncio.to_thread or the engine's worker")
            if dotted.endswith(".Popen"):
                return "subprocess.Popen blocks the event loop"
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr == "result" \
                and not call.args and not call.keywords:
            return ("Future.result() blocks the event loop if the future "
                    "is not done — await it instead")
        return None

    def generic_visit(self, node: ast.AST) -> None:
        # blocking-in-async runs on every Call inside async functions;
        # hooked here so visit_Call overrides above still see the node
        if isinstance(node, ast.Call) and self._in_async() \
                and "blocking-in-async" in self.rules:
            msg = self._blocking_message(node)
            if msg is not None:
                self._emit(node, "blocking-in-async", msg)
        super().generic_visit(node)


def _link_parents(tree: ast.Module) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._t3fs_parent = parent


def lint_module(tree: ast.Module, rules: frozenset[str]) -> list[RawFinding]:
    _link_parents(tree)
    return FileLinter(tree, rules).findings
