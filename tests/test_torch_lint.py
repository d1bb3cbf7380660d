"""The port's linter (t3fs_torch.analysis) against the JAX package's
(t3fs.analysis): every case of tests/test_t3fslint.py run on the port
(every rule catches its target shape on a positive fixture and stays
silent on the idiomatic fix; suppression via pragma and allowlist works;
the tree scans clean), then both linters give the same findings and the
same suppressed count on every fixture of that file under each rule set,
`python -m t3fs_torch.analysis t3fs_torch` reports 0 findings, and the
port's benchmarks keep checking the IOResults the linter once found
discarded.
"""

import textwrap
from pathlib import Path

from t3fs_torch.analysis import ALL_RULES, DEFAULT_RULES, lint_tree
from t3fs_torch.analysis.engine import (
    AllowlistEntry, lint_paths, lint_source, main,
)

REPO_ROOT = Path(__file__).resolve().parents[1]


def _lint(source: str, rules=DEFAULT_RULES, path="t3fs_torch/mod.py"):
    findings, suppressed = lint_source(
        textwrap.dedent(source), path, frozenset(rules))
    return findings, suppressed


def _rules_fired(source: str, rules=DEFAULT_RULES):
    findings, _ = _lint(source, rules)
    return {f.rule for f in findings}


# ---- one positive + one negative fixture per rule ----

def test_task_leak_positive_and_negative():
    pos = """
        import asyncio
        async def f(work):
            asyncio.create_task(work())
    """
    neg = """
        import asyncio
        async def f(self, work):
            self._task = asyncio.create_task(work())
    """
    assert "task-leak" in _rules_fired(pos)
    assert "task-leak" not in _rules_fired(neg)


def test_swallowed_cancellation_positive_and_negative():
    pos = """
        import asyncio
        async def stop(task):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
    """
    neg = """
        import asyncio
        async def stop(task):
            try:
                await task
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
    """
    assert "swallowed-cancellation" in _rules_fired(pos)
    assert "swallowed-cancellation" not in _rules_fired(neg)


def test_swallowed_cancellation_earlier_clause_consumes():
    # BaseException AFTER a clause that catches CancelledError is safe:
    # cancellation never reaches it
    neg = """
        import asyncio
        async def f(op):
            try:
                await op()
            except asyncio.CancelledError:
                raise
            except BaseException:
                pass
    """
    assert "swallowed-cancellation" not in _rules_fired(neg)


def test_thread_lock_across_await_positive_and_negative():
    pos = """
        import threading
        class C:
            def __init__(self):
                self._mu = threading.Lock()
            async def f(self, io):
                with self._mu:
                    await io()
    """
    neg = """
        import threading
        class C:
            def __init__(self):
                self._mu = threading.Lock()
            async def f(self, io):
                with self._mu:
                    x = 1
                await io()
    """
    assert "thread-lock-across-await" in _rules_fired(pos)
    assert "thread-lock-across-await" not in _rules_fired(neg)


def test_blocking_in_async_positive_and_negative():
    pos = """
        import time
        async def f():
            time.sleep(1.0)
    """
    neg_sync = """
        import time
        def f():
            time.sleep(1.0)
    """
    neg_async = """
        import asyncio
        async def f():
            await asyncio.sleep(1.0)
    """
    assert "blocking-in-async" in _rules_fired(pos)
    assert "blocking-in-async" not in _rules_fired(neg_sync)
    assert "blocking-in-async" not in _rules_fired(neg_async)


def test_async_lock_await_discipline_positive_and_negative():
    pos = """
        import asyncio
        class C:
            def __init__(self):
                self._lock = asyncio.Lock()
            async def f(self):
                async with self._lock:
                    await self.client.call("op")
    """
    neg_local = """
        import asyncio
        class C:
            def __init__(self):
                self._lock = asyncio.Lock()
            async def f(self):
                async with self._lock:
                    await asyncio.sleep(0)
    """
    neg_semaphore = """
        import asyncio
        async def f(client):
            window = asyncio.Semaphore(4)
            async with window:
                await client.call("op")
    """
    assert "async-lock-await-discipline" in _rules_fired(pos)
    assert "async-lock-await-discipline" not in _rules_fired(neg_local)
    # a Semaphore is an admission window, not a lock
    assert "async-lock-await-discipline" not in _rules_fired(neg_semaphore)


def test_async_lock_discipline_sees_transitive_rpc():
    # helper awaits self._forward (an RPC name); holding the lock across
    # the HELPER call must still fire
    pos = """
        import asyncio
        class C:
            def __init__(self):
                self._lock = asyncio.Lock()
            async def _locked_update(self, u):
                await self._forward(u)
            async def f(self, u):
                async with self._lock:
                    await self._locked_update(u)
    """
    assert "async-lock-await-discipline" in _rules_fired(pos)


def test_status_discarded_positive_and_negative():
    pos = """
        async def f(sc, cid, data):
            await sc.write_chunk(cid, data)
    """
    neg = """
        async def f(sc, cid, data):
            r = await sc.write_chunk(cid, data)
            return r.status
    """
    assert "status-discarded" in _rules_fired(pos)
    assert "status-discarded" not in _rules_fired(neg)


def test_naked_wait_positive_and_negative():
    pos = """
        class S:
            @rpc_method
            async def handler(self, req):
                await self._ready.wait()
    """
    neg_bounded = """
        import asyncio
        class S:
            @rpc_method
            async def handler(self, req):
                await asyncio.wait_for(self._ready.wait(), 5.0)
    """
    neg_not_handler = """
        class S:
            async def helper(self):
                await self._ready.wait()
    """
    assert "naked-wait" in _rules_fired(pos)
    assert "naked-wait" not in _rules_fired(neg_bounded)
    assert "naked-wait" not in _rules_fired(neg_not_handler)


def test_bare_create_task_in_handler_positive_and_negative():
    rules = {"bare-create-task-in-handler"}
    pos = """
        import asyncio
        class Conn:
            def _spawn(self, coro):
                t = asyncio.create_task(coro)
                self._tasks.add(t)
                return t
            async def on_frame(self, frame):
                asyncio.create_task(self._dispatch(frame))
    """
    neg_via_spawn = """
        import asyncio
        class Conn:
            def _spawn(self, coro):
                t = asyncio.create_task(coro)
                self._tasks.add(t)
                return t
            async def on_frame(self, frame):
                self._spawn(self._dispatch(frame))
    """
    neg_no_helper = """
        import asyncio
        class Plain:
            async def on_frame(self, frame):
                asyncio.create_task(self._dispatch(frame))
    """
    assert "bare-create-task-in-handler" in _rules_fired(pos, rules)
    assert "bare-create-task-in-handler" not in _rules_fired(
        neg_via_spawn, rules)
    assert "bare-create-task-in-handler" not in _rules_fired(
        neg_no_helper, rules)


def test_span_not_closed_positive_and_negative():
    rules = {"span-not-closed"}
    pos_bare_ctor = """
        from t3fs_torch.utils.tracing import Span
        def f():
            sp = Span(trace_id=1, span_id=2, parent_id=0, name="x")
            return sp
    """
    pos_unfinished = """
        from t3fs_torch.utils import tracing
        async def f(io):
            sp = tracing.start_span("leg")
            await io()
    """
    neg_finished = """
        from t3fs_torch.utils import tracing
        async def f(io):
            sp = tracing.start_span("leg")
            try:
                await io()
            finally:
                sp.finish()
    """
    neg_scope = """
        from t3fs_torch.utils import tracing
        async def f(io):
            with tracing.span("leg"):
                await io()
    """
    assert "span-not-closed" in _rules_fired(pos_bare_ctor, rules)
    assert "span-not-closed" in _rules_fired(pos_unfinished, rules)
    assert "span-not-closed" not in _rules_fired(neg_finished, rules)
    assert "span-not-closed" not in _rules_fired(neg_scope, rules)


def test_buffer_release_leak_positive_and_negative():
    rules = {"buffer-release-leak"}
    pos = """
        async def push(pool, sc, data):
            handle, release = pool.acquire(len(data))
            await sc.write(handle, data)
    """
    pos_discarded = """
        def stage(pool, n):
            h, _ = pool.acquire(n)
            return h
    """
    neg_released = """
        async def push(pool, sc, data):
            handle, release = pool.acquire(len(data))
            try:
                await sc.write(handle, data)
            finally:
                release(discard=True)
    """
    neg_handed_off = """
        def stage(pool, owner, n):
            h, rel = pool.acquire(n)
            owner.adopt(h, rel)
            return h
    """
    # scalar/awaited acquire protocols are different contracts: no match
    neg_scalar = """
        def fill(alloc):
            slot = alloc.acquire()
            return slot
    """
    neg_awaited = """
        async def send(self):
            channel, seq = await self.channels.acquire()
            return channel, seq
    """
    assert "buffer-release-leak" in _rules_fired(pos, rules)
    assert "buffer-release-leak" in _rules_fired(pos_discarded, rules)
    for neg in (neg_released, neg_handed_off, neg_scalar, neg_awaited):
        assert "buffer-release-leak" not in _rules_fired(neg, rules)


def test_buffer_release_leak_pragma_marks_long_lived_hold():
    # an arena that lives for the process (RingClient's staging arena
    # analog) keeps its buffer registered on purpose — pragma the site
    src = """
        def boot(pool):
            # t3fslint: allow(buffer-release-leak) — arena lives forever
            arena, release = pool.acquire(1 << 20)
            return arena
    """
    findings, suppressed = _lint(src, {"buffer-release-leak"})
    assert not findings and suppressed == 1


def test_span_not_closed_pragma_marks_handoff():
    # handing the span to another function to finish is the pragma path
    src = """
        from t3fs_torch.utils import tracing
        def f(ledger):
            # t3fslint: allow(span-not-closed) — finished by ledger.close
            sp = tracing.start_span("leg")
            ledger.attach(sp)
    """
    findings, suppressed = _lint(src, {"span-not-closed"})
    assert not findings and suppressed == 1


# ---- suppression: pragmas ----

def test_pragma_same_line_suppresses():
    src = """
        import time
        async def f():
            time.sleep(1.0)  # t3fslint: allow(blocking-in-async)
    """
    findings, suppressed = _lint(src)
    assert not findings and suppressed == 1


def test_pragma_line_above_suppresses():
    src = """
        import time
        async def f():
            # t3fslint: allow(blocking-in-async) — one-shot startup write
            time.sleep(1.0)
    """
    findings, suppressed = _lint(src)
    assert not findings and suppressed == 1


def test_pragma_on_async_with_header_covers_awaits_inside():
    # the finding anchors on the await line, but the pragma belongs on
    # the lock hold (also_lines) — one pragma per deliberate section
    src = """
        import asyncio
        class C:
            def __init__(self):
                self._lock = asyncio.Lock()
            async def f(self):
                async with self._lock:  # t3fslint: allow(async-lock-await-discipline)
                    await self.client.call("op")
    """
    findings, suppressed = _lint(src)
    assert not findings and suppressed == 1


def test_pragma_suppresses_only_named_rule():
    src = """
        import asyncio, time
        async def f(work):
            # t3fslint: allow(blocking-in-async)
            time.sleep(1.0)
            asyncio.create_task(work())
    """
    findings, suppressed = _lint(src)
    assert suppressed == 1
    assert [f.rule for f in findings] == ["task-leak"]


# ---- suppression: allowlist ----

def test_allowlist_entry_suppresses_matching_finding(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(textwrap.dedent("""
        import time
        async def f():
            time.sleep(1.0)
    """))
    hit = lint_paths(tmp_path, [bad], allowlist=[])
    assert [f.rule for f in hit.findings] == ["blocking-in-async"]
    entry = AllowlistEntry(path="mod.py", rule="blocking-in-async")
    ok = lint_paths(tmp_path, [bad], allowlist=[entry])
    assert ok.ok and ok.suppressed == 1
    # an entry for a different rule must not match
    other = AllowlistEntry(path="mod.py", rule="task-leak")
    still = lint_paths(tmp_path, [bad], allowlist=[other])
    assert not still.ok


# ---- the gate itself ----

def test_repo_scans_clean():
    """The CI contract: zero unsuppressed findings across the tree."""
    result = lint_tree(REPO_ROOT)
    assert result.ok, "\n".join(f.render() for f in result.findings)
    assert not result.errors, result.errors
    assert result.files > 150          # the scan actually covered the tree


def test_reintroducing_fixed_bugs_fails_lint():
    """Putting back a fixed task-leak or swallowed-cancellation instance
    must turn the gate red again."""
    old_ring_worker_stop = """
        import asyncio
        class Ring:
            async def stop(self):
                self._drainer.cancel()
                try:
                    await self._drainer
                except (asyncio.CancelledError, Exception):
                    pass
    """
    old_kernel_dispatch = """
        import asyncio
        class Kernel:
            def _on_readable(self, msg):
                asyncio.get_running_loop().create_task(self._dispatch(msg))
    """
    assert "swallowed-cancellation" in _rules_fired(old_ring_worker_stop)
    assert "task-leak" in _rules_fired(old_kernel_dispatch)


def test_cli_list_rules_and_exit_codes(tmp_path, capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule in out

    bad = tmp_path / "mod.py"
    bad.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    assert main([str(bad), "--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "blocking-in-async" in out and "1 finding(s)" in out

    bad.write_text("async def f():\n    return 1\n")
    assert main([str(bad), "--root", str(tmp_path)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


# ---- the port against the reference ----

import ast                                                   # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402

import pytest                                                # noqa: E402

from t3fs.analysis import engine as ref_engine               # noqa: E402
from t3fs.analysis import rules as ref_rules                 # noqa: E402
from t3fs_torch.analysis import engine as port_engine        # noqa: E402
from t3fs_torch.analysis import rules as port_rules          # noqa: E402


def _fixtures() -> list[str]:
    """Every multi-line string of tests/test_t3fslint.py that parses as a
    module with a function in it: the positive and negative fixtures."""
    tree = ast.parse((REPO_ROOT / "tests" / "test_t3fslint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and "def " in node.value:
            try:
                ast.parse(textwrap.dedent(node.value))
            except SyntaxError:
                continue
            out.append(textwrap.dedent(node.value))
    return out


FIXTURES = _fixtures()


def _findings(engine, source, path, rules):
    found, suppressed = engine.lint_source(source, path, frozenset(rules))
    return [(f.path, f.line, f.rule, f.message) for f in found], suppressed


def test_rule_catalogs_equal():
    assert port_rules.ALL_RULES == ref_rules.ALL_RULES
    assert port_rules.DEFAULT_RULES == ref_rules.DEFAULT_RULES
    assert port_rules.TEST_RULES == ref_rules.TEST_RULES
    assert port_engine.PRAGMA_PREFIX == ref_engine.PRAGMA_PREFIX


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_fixture_findings_equal_across_packages(i):
    source = FIXTURES[i]
    for path in ("t3fs/mod.py", "t3fs_torch/mod.py", "tests/mod.py",
                 "benchmarks/mod.py"):
        for rules in (ref_rules.DEFAULT_RULES, ref_rules.TEST_RULES,
                      ref_rules.ALL_RULES):
            assert _findings(port_engine, source, path, rules) == \
                _findings(ref_engine, source, path, rules), (i, path)
        # each linter picks its rule set from the path the same way
        assert port_engine._rules_for(path) == ref_engine._rules_for(path)


def test_port_tree_lints_clean_from_the_command_line():
    r = subprocess.run([sys.executable, "-m", "t3fs_torch.analysis",
                        "t3fs_torch"], cwd=REPO_ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert " 0 finding(s)" in r.stdout.splitlines()[-1]


@pytest.mark.parametrize("rel,calls", [
    ("t3fs_torch/benchmarks/health_smoke.py", 1),
    ("t3fs_torch/benchmarks/kvcache_scale_bench.py", 1),
    ("t3fs_torch/benchmarks/sort_bench.py", 2),
    ("t3fs_torch/benchmarks/storage_bench.py", 3)])
def test_benchmarks_check_the_results_they_once_discarded(rel, calls):
    """The port's benchmarks check every write and remove result the
    reference's linter found dropped there (a failed write fails the
    bench): the full rule set finds no discarded status, and the file
    still makes the calls it checks."""
    source = (REPO_ROOT / rel).read_text()
    found, _ = _findings(port_engine, source, rel, port_rules.DEFAULT_RULES)
    assert not [f for f in found if f[2] == "status-discarded"], found
    names = ("write_chunk(", "write_file_range(", "remove_keys(")
    assert sum(source.count(n) for n in names) >= calls
