"""The port's soak harness (t3fs_torch/soak/, t3fs_torch/benchmarks/
{soak_bench,health_bench}.py) against the reference's on the CPU, every
node on the host CRC and every EC codec on its plain versions
(checksum_backend="cpu"):

- both shipped scenarios and the splice case parse to equal fields;
- `jain_fairness`, `summarize` and `grade` give equal values and gate
  details on seeded op logs (numpy seeds 0-5) and the reference test's;
- the fault schedule, replayed on a pinned fake clock against a recording
  injector, gives equal events in both packages, and LiveInjector's bit-rot
  picks are equal from the same seeded stream;
- `block_bytes` and the kvcache driver's keys and values are equal bytes
  over a seeded grid;
- twins of the reference's driver-mechanics, crash-mid-checkpoint and
  soak-status tests, the crash case steadied as the port's other cluster
  tests are (a heartbeat timeout test load cannot reach; no node is killed);
- the graysort driver: the reference's op raises on every call (its
  IOResult status has no raise_if_error), the port's checks the Status;
- one short seeded soak end to end through the port's soak_bench cell
  runner (soak_smoke.toml, faults on, 6 s), and both packages'
  health_bench cells at a small size.

Every comparison is exact equality."""

import asyncio
import dataclasses
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import t3fs.soak.drivers as ref_drivers
import t3fs.soak.faults as ref_faults
import t3fs.soak.harvest as ref_harvest
import t3fs.soak.spec as ref_spec
import t3fs_torch.soak.drivers as port_drivers
import t3fs_torch.soak.faults as port_faults
import t3fs_torch.soak.harvest as port_harvest
import t3fs_torch.soak.spec as port_spec
from t3fs_torch.soak.drivers import Driver, SoakContext, build_driver
from t3fs_torch.soak.spec import SoakSpec, WorkloadSpec, load_spec
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode, make_error

ROOT = Path(__file__).resolve().parent.parent
SOAK = str(ROOT / "configs" / "soak.toml")
SMOKE = str(ROOT / "configs" / "soak_smoke.toml")
SPLICE = """
name = "t"
duration_s = 5.0
[slo]
min_fairness = 0.7
[[workload]]
kind = "dataloader"
[[workload]]
kind = "dataloader"
mode = "closed"
[[fault]]
at_s = 3.0
kind = "bitrot"
[[fault]]
at_s = 1.0
kind = "crash"
"""
PACKAGES = {
    "ref": SimpleNamespace(spec=ref_spec, drivers=ref_drivers,
                           faults=ref_faults, harvest=ref_harvest),
    "port": SimpleNamespace(spec=port_spec, drivers=port_drivers,
                            faults=port_faults, harvest=port_harvest),
}


def run(coro):
    return asyncio.run(coro)


# ------------------------------------------------------------- specs

@pytest.mark.parametrize("text", [SOAK, SMOKE, SPLICE],
                         ids=["soak", "soak_smoke", "splice"])
def test_load_spec_equal_across_packages(text):
    ref = ref_spec.load_spec(text)
    port = port_spec.load_spec(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [type(w).__name__ for w in port.workloads] == \
        [type(w).__name__ for w in ref.workloads]


def test_load_spec_splices_and_refuses_like_the_reference():
    spec = load_spec(SPLICE)
    assert [w.name for w in spec.workloads] == ["dataloader", "dataloader1"]
    assert [f.kind for f in spec.faults] == ["crash", "bitrot"]  # sorted
    assert spec.slo.min_fairness == 0.7
    for bad in ('[[workload]]\nkind = "nope"\n',
                '[[fault]]\nkind = "meteor"\n',
                '[[workload]]\nname = "a"\n[[workload]]\nname = "a"\n'):
        with pytest.raises(Exception) as ref_e:
            ref_spec.load_spec(bad)
        with pytest.raises(Exception) as port_e:
            load_spec(bad)
        assert type(port_e.value).__name__ == type(ref_e.value).__name__
        assert str(port_e.value) == str(ref_e.value)


def test_shipped_scenarios_parse_and_validate():
    full = load_spec(SOAK)
    assert len(full.workloads) == 6 and len(full.faults) == 6
    assert {f.kind for f in full.faults} == {"straggler", "crash", "bitrot",
                                             "node_add", "node_drain"}
    assert {w.data_plane for w in full.workloads} == {"rpc", "ring"}
    assert full.rebalance and full.duration_s == 75.0
    smoke = load_spec(SMOKE)
    assert len(smoke.workloads) == 3 and len(smoke.faults) == 1
    assert smoke.duration_s <= 15.0


# ------------------------------------------------------------- harvest

def test_jain_fairness_math_and_equal_across_packages():
    jf = port_harvest.jain_fairness
    assert jf([0.5, 0.5, 0.5]) == pytest.approx(1.0)
    assert jf([1.0, 0.0, 0.0, 0.0]) == pytest.approx(0.25)
    assert jf([]) == 1.0
    assert jf([0.0, 0.0]) == 0.0
    assert jf([0.2, 0.4]) == pytest.approx(jf([0.5, 1.0]))
    assert 0.8 < jf([1.0, 1.0, 0.5, 1.0]) < 1.0
    rng = np.random.default_rng(0)
    cases = [[], [0.0], [0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.2, 0.4],
             [1.0, 1.0, 0.5, 1.0]]
    for _ in range(64):
        x = rng.random(int(rng.integers(1, 12)))
        x[rng.random(len(x)) < 0.2] = 0.0
        cases.append([float(v) for v in np.minimum(1.0, x * 1.3)])
    for shares in cases:
        assert jf(shares) == ref_harvest.jain_fairness(shares), shares


class FakeDriver:
    def __init__(self, name, wl, ops, wrong=0, errors=0, shed=0,
                 cancelled=0):
        self.name, self.wl, self.ops = name, wl, ops
        self.errors, self.shed, self.cancelled = errors, shed, cancelled
        self.wrong_bytes = wrong


def graded(pkg: str, seed: int, require_fairness: bool):
    """(report dict, gates) of one seeded op log, built from `pkg`'s own
    spec, OpRecord, summarize and grade."""
    p = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    spec = p.spec.SoakSpec()
    spec.slo = p.spec.SLOSpec(
        min_fairness=float(rng.random()),
        min_ops_per_window=int(rng.integers(0, 3)),
        progress_windows=int(rng.integers(1, 6)),
        max_p99_ms=float(rng.choice([0.0, 20.0, 50.0])))
    elapsed = float(rng.uniform(2.0, 20.0))
    drivers = []
    for i in range(int(rng.integers(1, 6))):
        wl = p.spec.WorkloadSpec(
            name=f"w{i}", kind=str(rng.choice(p.spec.WORKLOAD_KINDS)),
            mode=str(rng.choice(["open", "closed"])),
            demand_ops_s=float(rng.uniform(0.2, 50.0)))
        n = int(rng.integers(0, 200))
        ops = [p.drivers.OpRecord(float(t), float(lat), bool(ok), int(nb))
               for t, lat, ok, nb in zip(
                   np.sort(rng.uniform(0, elapsed, n)),
                   rng.exponential(0.01, n), rng.random(n) < 0.9,
                   rng.integers(0, 1 << 20, n))]
        drivers.append(FakeDriver(
            wl.name, wl, ops, wrong=int(rng.random() < 0.2) * 7,
            errors=int(rng.integers(0, 5)), shed=int(rng.integers(0, 5)),
            cancelled=int(rng.integers(0, 3))))
    spec.workloads = [d.wl for d in drivers]
    rep = p.harvest.grade(p.harvest.summarize(spec, drivers, elapsed), spec,
                          require_fairness=require_fairness)
    return rep.to_dict(), rep.gates, rep.fairness, [
        (w.p50_ms, w.p99_ms, w.achieved_ops_s, w.share) for w in rep.workloads]


@pytest.mark.parametrize("seed", range(6))
def test_summarize_and_grade_equal_across_packages(seed):
    for require_fairness in (False, True):
        assert graded("port", seed, require_fairness) == \
            graded("ref", seed, require_fairness)


def test_grade_gates_progress_and_wrong_bytes():
    """Twin of the reference's grade test, and its gate details equal."""
    outs = []
    for pkg in ("ref", "port"):
        p = PACKAGES[pkg]
        spec = p.spec.SoakSpec()
        spec.workloads = [p.spec.WorkloadSpec(name="a"),
                          p.spec.WorkloadSpec(name="b")]
        good = [p.drivers.OpRecord(t, 0.01, True, 64)
                for t in np.linspace(0.1, 8.9, 30)]
        starved = [p.drivers.OpRecord(t, 0.01, True, 64)
                   for t in np.linspace(0.1, 2.0, 10)]
        drivers = [FakeDriver("a", spec.workloads[0], good),
                   FakeDriver("b", spec.workloads[1], starved)]
        rep = p.harvest.grade(p.harvest.summarize(spec, drivers, 9.0), spec,
                              require_fairness=False)
        ok, detail = rep.gates["progress"]
        assert not ok and "b" in detail
        assert rep.gates["zero_wrong_bytes"][0]
        assert "fairness" not in rep.gates
        drivers[0].wrong_bytes = 3
        rep2 = p.harvest.grade(p.harvest.summarize(spec, drivers, 9.0), spec,
                               require_fairness=True)
        assert not rep2.gates["zero_wrong_bytes"][0]
        assert "fairness" in rep2.gates
        outs.append((rep.to_dict(), rep2.to_dict()))
    assert outs[0] == outs[1]


# ------------------------------------------- driver lifecycle discipline

class WedgeDriver(Driver):
    """one_op parks on an event until released; counts completions."""

    def __init__(self, spec, wl, idx, ctx):
        super().__init__(spec, wl, idx, ctx)
        self.gate = asyncio.Event()
        self.started = 0
        self.finished = 0

    async def one_op(self, worker: int) -> int:
        self.started += 1
        await self.gate.wait()
        self.finished += 1
        return 1

    async def teardown(self) -> None:
        pass


def _mini_spec(**wl_kw) -> tuple[SoakSpec, WorkloadSpec]:
    spec = SoakSpec()
    wl = WorkloadSpec(name="w", **wl_kw)
    spec.workloads = [wl]
    return spec, wl


def test_open_loop_sheds_beyond_inflight_cap_and_drain_cancels():
    async def body():
        spec, wl = _mini_spec(mode="open", demand_ops_s=200.0,
                              concurrency=2)        # cap = max(4, 8) = 8
        d = WedgeDriver(spec, wl, 0, None)
        d.start()
        t0 = time.monotonic()
        while d.shed < 5 and time.monotonic() - t0 < 5.0:
            await asyncio.sleep(0.01)
        assert d.shed >= 5, "arrivals past the cap must shed"
        assert d.started <= 8, d.started      # cap respected, no queue
        d.request_stop()
        await d.drain(timeout_s=0.2)          # ops still wedged: cancel
        assert d.cancelled == d.started
        assert d.finished == 0
        names = {t.get_name() for t in asyncio.all_tasks()}
        assert not any(n.startswith("soak-w") for n in names), names
    run(body())


def test_closed_loop_drain_waits_for_inflight_then_counts_ok():
    async def body():
        spec, wl = _mini_spec(mode="closed", concurrency=3)
        d = WedgeDriver(spec, wl, 0, None)
        d.start()
        t0 = time.monotonic()
        while d.started < 3 and time.monotonic() - t0 < 5.0:
            await asyncio.sleep(0.01)
        d.request_stop()
        d.gate.set()                  # release mid-drain
        await d.drain(timeout_s=5.0)
        assert d.cancelled == 0
        assert d.finished == 3        # one per worker, none restarted
        assert len([o for o in d.ops if o.ok]) == 3
    run(body())


def test_driver_errors_counted_not_fatal():
    async def body():
        spec, wl = _mini_spec(mode="closed", concurrency=1)

        class FlakyDriver(Driver):
            async def one_op(self, worker):
                if len(self.ops) % 2 == 0:
                    raise RuntimeError("transient")
                return 1

            async def teardown(self):
                pass

        d = FlakyDriver(spec, wl, 0, None)
        d.start()
        t0 = time.monotonic()
        while len(d.ops) < 10 and time.monotonic() - t0 < 5.0:
            await asyncio.sleep(0.01)
        d.request_stop()
        await d.drain(timeout_s=2.0)
        assert d.errors >= 4
        assert len([o for o in d.ops if o.ok]) >= 4
    run(body())


# ---------------------------------------------------------- driver bytes

def test_block_bytes_equal_across_packages():
    rng = np.random.default_rng(1)
    grid = [(0, 0, 0, 0), (13, 1, 0, 1), (13, 1, 0, 31), (13, 1, 0, 32),
            (13, 1, 0, 33)]
    grid += [(int(s), int(i), int(b), int(n)) for s, i, b, n in zip(
        rng.integers(0, 1 << 31, 48), rng.integers(0, 1 << 62, 48),
        rng.integers(0, 1 << 20, 48), rng.integers(0, 70000, 48))]
    for seed, inode, index, n in grid:
        got = port_drivers.block_bytes(seed, inode, index, n)
        assert len(got) == n
        assert got == ref_drivers.block_bytes(seed, inode, index, n)


def test_kvcache_keys_and_values_equal_across_packages():
    rng = np.random.default_rng(2)
    for _ in range(12):
        seed, idx = int(rng.integers(0, 1 << 20)), int(rng.integers(0, 8))
        value_bytes = int(rng.integers(64, 40000))
        drivers = []
        for p in (PACKAGES["ref"], PACKAGES["port"]):
            spec = p.spec.SoakSpec(seed=seed)
            wl = p.spec.WorkloadSpec(name=f"kv{idx}", kind="kvcache",
                                     value_bytes=value_bytes)
            spec.workloads = [wl]
            drivers.append(p.drivers.build_driver(spec, wl, idx, None))
        ref, port = drivers
        assert type(port).__name__ == "KVCacheDriver"
        for key_i in [int(k) for k in rng.integers(0, 1 << 16, 16)]:
            assert port._key(key_i) == ref._key(key_i)
            for ver in (1, 2, int(rng.integers(3, 1 << 30))):
                v = port._value(key_i, ver)
                assert len(v) == value_bytes
                assert v == ref._value(key_i, ver)


# --------------------------------------------- fault schedule determinism

class FakeClock:
    def __init__(self):
        self.t = 100.0               # arbitrary epoch: schedule is relative

    def __call__(self):
        return self.t

    async def sleep(self, d):
        self.t += d


class RecordingInjector:
    def __init__(self):
        self.calls = []

    async def straggler(self, node, delay_s):
        self.calls.append(("straggler", node, delay_s))
        return f"delay={delay_s}"

    async def straggler_clear(self, node):
        self.calls.append(("clear", node, 0))
        return ""

    async def crash(self, node):
        self.calls.append(("crash", node, 0))
        return "restarted"

    async def bitrot(self, node, chunks):
        self.calls.append(("bitrot", node, chunks))
        return f"{chunks} shards"

    async def node_add(self, node):
        self.calls.append(("node_add", node, 0))
        return f"node {node or 6} up (empty)"

    async def node_drain(self, node):
        self.calls.append(("node_drain", node, 0))
        return "tagged drain"


def _fault_spec(pkg, seed: int, all_kinds: bool = False):
    p = PACKAGES[pkg].spec
    spec = p.SoakSpec()
    spec.seed = seed
    spec.nodes = 5
    # node=0 everywhere: every pick comes from the seeded stream
    spec.faults = [p.FaultSpec(at_s=1.0, kind="crash"),
                   p.FaultSpec(at_s=2.0, kind="bitrot", chunks=3),
                   p.FaultSpec(at_s=3.0, kind="straggler",
                               duration_s=2.0, delay_ms=10.0),
                   p.FaultSpec(at_s=4.0, kind="crash")]
    if all_kinds:
        spec.faults += [p.FaultSpec(at_s=2.5, kind="node_add"),
                        p.FaultSpec(at_s=3.5, kind="node_drain"),
                        p.FaultSpec(at_s=3.6, kind="node_drain", node=3),
                        p.FaultSpec(at_s=3.7, kind="straggler", node=2,
                                    duration_s=0.1, delay_ms=1.0)]
        spec.faults.sort(key=lambda f: f.at_s)
    return spec


def replay(pkg: str, seed: int, all_kinds: bool = False, injector=None):
    async def body():
        clock = FakeClock()
        inj = injector() if injector else RecordingInjector()
        sched = PACKAGES[pkg].faults.FaultSchedule(
            _fault_spec(pkg, seed, all_kinds), inj, clock=clock,
            sleep=clock.sleep)
        events = await sched.run()
        return [(e.t, e.kind, e.node, e.ok, e.detail) for e in events], \
            inj.calls
    return run(body())


@pytest.mark.parametrize("seed,all_kinds", [(13, False), (14, False),
                                            (13, True), (99, True)])
def test_fault_schedule_equal_across_packages(seed, all_kinds):
    assert replay("port", seed, all_kinds) == replay("ref", seed, all_kinds)


def test_fault_schedule_is_deterministic_under_seeded_clock():
    ev_a, calls_a = replay("port", 13)
    ev_b, calls_b = replay("port", 13)
    assert ev_a == ev_b
    assert calls_a == calls_b
    main_a = [e for e in ev_a if e[1] != "straggler-clear"]
    assert [(e[0], e[1]) for e in main_a] == [
        (1.0, "crash"), (2.0, "bitrot"), (3.0, "straggler"),
        (4.0, "crash")]
    assert all(1 <= e[2] <= 5 for e in ev_a)
    assert all(e[3] for e in ev_a)
    strag = next(e for e in ev_a if e[1] == "straggler")
    clear = next(e for e in ev_a if e[1] == "straggler-clear")
    assert clear[2] == strag[2]
    ev_c, _ = replay("port", 14)
    assert [(e[1], e[2]) for e in ev_c] != [(e[1], e[2]) for e in ev_a]
    # node_add with no node asks the injector for a fresh id (0)
    ev_d, calls_d = replay("port", 13, all_kinds=True)
    assert ("node_add", 0, 0) in calls_d
    assert ("node_drain", 3, 0) in calls_d


def test_fault_schedule_survives_injector_failure():
    class Boom(RecordingInjector):
        async def crash(self, node):
            raise RuntimeError("node already down")

    events, _ = replay("port", 13, injector=Boom)
    crashes = [e for e in events if e[1] == "crash"]
    assert len(crashes) == 2 and not any(e[3] for e in crashes)
    assert "node already down" in crashes[0][4]
    assert any(e[1] == "bitrot" and e[3] for e in events)
    assert replay("ref", 13, injector=Boom) == (events, _)


def test_bitrot_skips_stale_picks_and_retries():
    """Twin of the reference's stale-pick test, each package's injector over
    its own ECLayout: the same picks, details and errors."""
    from t3fs.client.ec_client import ECLayout as RefLayout
    from t3fs_torch.client.ec_client import ECLayout as PortLayout

    def scrub_of(layout_cls):
        lay = layout_cls.create(k=4, m=2, chunk_size=2048,
                                chains=[11, 12, 13, 14, 15, 16])
        return lay, SimpleNamespace(_targets={
            "ck/step-4/a": SimpleNamespace(name="ck/step-4/a", layout=lay,
                                           inode=76, stripe_lens={0: 8192}),
            "ck/step-5/a": SimpleNamespace(name="ck/step-5/a", layout=lay,
                                           inode=77,
                                           stripe_lens={0: 8192, 1: 8192})})

    class FlakyCluster:
        def __init__(self, stale_before):
            self.calls = 0
            self.stale_before = stale_before
            self.rotted = []

        def corrupt_chunk_on_disk(self, chain_id, chunk_id):
            self.calls += 1
            if self.calls <= self.stale_before:
                return False
            self.rotted.append((chain_id, chunk_id.inode, chunk_id.index))
            return True

    outs = []
    for pkg, layout_cls in (("ref", RefLayout), ("port", PortLayout)):
        lay, scrub = scrub_of(layout_cls)
        faults = PACKAGES[pkg].faults

        async def body():
            cl = FlakyCluster(stale_before=2)
            inj = faults.LiveInjector(cl, scrub=scrub,
                                      rng=np.random.default_rng(7))
            detail = await inj.bitrot(0, chunks=2)
            assert detail == "2 shards (2 stale picks)", detail
            lay77 = {lay.shard_chunk(77, s, i).inode
                     for s in (0, 1) for i in range(lay.k)}
            assert {r[1] for r in cl.rotted} <= lay77
            cl2 = FlakyCluster(stale_before=10**9)
            inj2 = faults.LiveInjector(cl2, scrub=scrub,
                                       rng=np.random.default_rng(7))
            with pytest.raises(RuntimeError, match="no live EC shard") as e:
                await inj2.bitrot(0, chunks=2)
            return detail, cl.rotted, cl2.calls, str(e.value)

        outs.append(run(body()))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ graysort

class MemStorageClient:
    """Files as byte strings: what GraySortDriver's op needs of a
    StorageClient, with write results in the given package's IOResult."""

    def __init__(self, io_result, fail_after: int | None = None,
                 fail_status=None):
        self.files: dict[int, bytes] = {}
        self.io_result = io_result
        self.fail_after, self.fail_status = fail_after, fail_status
        self.writes = 0

    async def write_file_range(self, lay, inode, offset, data):
        assert offset == 0
        self.writes += 1
        if self.fail_after is not None and self.writes > self.fail_after:
            return [self.io_result(status=self.fail_status)]
        self.files[inode] = bytes(data)
        return [self.io_result(length=len(data))]

    async def read_file_range(self, lay, inode, offset, length):
        return self.files.get(inode, b"")[offset:offset + length], None

    async def remove_file_chunks(self, lay, inode):
        self.files.pop(inode, None)

    async def close(self):
        pass


def _graysort(pkg: str, sc):
    p = PACKAGES[pkg]
    spec = p.spec.SoakSpec(seed=13)
    wl = p.spec.WorkloadSpec(name="graysort", kind="graysort", mode="closed",
                             sort_mb=1, sort_partitions=4)
    spec.workloads = [wl]
    ctx = SimpleNamespace(repl_chains=[1, 2], make_client=lambda **kw: sc)
    return p.drivers.build_driver(spec, wl, 5, ctx)


def test_graysort_op_checks_write_status_where_the_reference_raises():
    """The reference's op calls raise_if_error on an IOResult's WireStatus,
    which has none: every op raises AttributeError, so its graysort driver
    never completes one (its full soak's progress gate starves it).  The
    port checks the Status the WireStatus names: an op sorts, verifies and
    cleans up, and a failed run write fails the op with its StatusError."""
    from t3fs.storage.types import IOResult as RefIOResult
    from t3fs_torch.net.wire import WireStatus
    from t3fs_torch.storage.types import IOResult
    from t3fs_torch.utils.status import StatusError

    async def body():
        ref = _graysort("ref", MemStorageClient(RefIOResult))
        await ref.setup()
        with pytest.raises(AttributeError, match="raise_if_error"):
            await ref.one_op(0)
        sc = MemStorageClient(IOResult)
        port = _graysort("port", sc)
        await port.setup()
        assert ref.in_sum == port.in_sum and ref.nrec == port.nrec
        for _ in range(2):
            assert await port.one_op(0) == 4 * port.nrec * 100
        assert port.wrong_bytes == 0
        assert list(sc.files) == [port.in_inode]     # runs + outputs removed
        bad = MemStorageClient(IOResult, fail_after=2,
                               fail_status=WireStatus(
                                   int(StatusCode.TIMEOUT), "injected"))
        failing = _graysort("port", bad)
        await failing.setup()
        with pytest.raises(StatusError, match="injected"):
            await failing.one_op(0)
        assert failing.wrong_bytes == 0
    run(body())


# ------------------------------------- checkpoint crash-cycle resume

def test_crash_mid_checkpoint_cycle_resumes_same_step():
    """Twin of the reference's test: a save that dies partway (every write
    failing after the first 12) leaves the step counter untouched; the
    next cycle saves the SAME step and skips the committed stripes.
    Steadied: no node is killed, so the cluster runs at a heartbeat timeout
    test load cannot reach (a loaded loop then never fences a node and
    fails the first 12 writes, which left nothing to resume)."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, num_chains=2,
                               with_meta=True, ec_chains=6,
                               heartbeat_timeout_s=60.0,
                               checksum_backend="cpu")
        await cluster.start()
        try:
            spec = SoakSpec()
            spec.nodes = 3
            spec.chains = 2
            spec.ec_chains = 6
            spec.ec_k = 4
            spec.ec_m = 2
            spec.ec_chunk_size = 2048
            wl = WorkloadSpec(name="ck", kind="checkpoint", tree_kb=64,
                              keep_last=2)
            spec.workloads = [wl]
            ctx = SoakContext(cluster, spec, repl_chains=[1, 2],
                              ec_chain_ids=[3, 4, 5, 6, 7, 8],
                              checksum_backend="cpu")
            drv = build_driver(spec, wl, 0, ctx)
            await drv.setup()
            try:
                assert drv.ec.codec.device.type == "cpu"
                assert await drv.one_op(0) > 0       # step 1 full cycle
                assert drv.step == 2

                real_write = drv.sc.write_chunk
                calls = {"n": 0}

                async def flaky(*a, **kw):
                    calls["n"] += 1
                    if calls["n"] > 12:
                        raise make_error(StatusCode.TIMEOUT,
                                         "injected crash")
                    return await real_write(*a, **kw)

                drv.sc.write_chunk = flaky
                drv.writer.shard_retries = 0
                with pytest.raises(Exception):
                    await drv.one_op(0)
                assert drv.step == 2, "failed cycle must not advance"

                drv.sc.write_chunk = real_write      # fabric heals
                before = drv.resumed_stripes
                assert await drv.one_op(0) > 0
                assert drv.step == 3
                assert drv.resumed_stripes > before, \
                    "resume must skip committed stripes, not restart"
                steps = await drv.store.list_steps()
                assert 2 in steps
                assert set(drv.ec.codec.codec_counts) <= {
                    "cuda-encode-words", "cuda-decode-words"}
            finally:
                await drv.teardown()
        finally:
            await cluster.stop()
    run(body())


# ------------------------------------------------- end to end

class SteadyCluster(LocalCluster):
    """The runner's LocalCluster at a heartbeat timeout test load cannot
    reach: the smoke kills no node, so a loaded loop must not fence one."""

    def __init__(self, *a, **kw):
        kw["heartbeat_timeout_s"] = 60.0
        super().__init__(*a, **kw)


def test_short_seeded_soak_end_to_end(monkeypatch):
    """soak_smoke.toml, faults on, 6 s, through the port's soak_bench cell
    runner on the host CRC and the codec's plain versions: zero wrong bytes,
    every gate held, the straggler applied and cleared, a worst trace."""
    import t3fs_torch.testing.cluster as cluster_mod
    from t3fs_torch.benchmarks import soak_bench

    monkeypatch.setattr(cluster_mod, "LocalCluster", SteadyCluster)
    spec = load_spec(SMOKE)
    spec.duration_s = 6.0
    t0 = time.monotonic()
    d = run(soak_bench.run_cell(spec, True, 1, False, checksum_backend="cpu"))
    assert time.monotonic() - t0 < 30.0
    assert d["wrong_bytes"] == 0
    assert d["gates"] and all(g["ok"] for g in d["gates"].values()), \
        d["gates"]
    assert d["passed"]
    assert set(d["gates"]) == {"zero_wrong_bytes", "progress"}
    assert all(w["ops_ok"] > 0 for w in d["workloads"].values())
    assert [f["kind"] for f in d["faults"]] == ["straggler",
                                                "straggler-clear"]
    assert all(f["ok"] for f in d["faults"])
    assert d["faults"][0]["detail"] == "read_delay_s=0.015"
    assert d["worst_trace_excerpt"].startswith("trace 0x")


@pytest.mark.slow
def test_soak_smoke_end_to_end():
    """Twin of the reference's slow-marked smoke, on the host CRC."""
    async def body():
        from t3fs_torch.soak.runner import SoakRunner
        spec = load_spec(SMOKE)
        spec.duration_s = 8.0
        spec.faults[0].at_s = 2.0
        spec.faults[0].duration_s = 2.0
        rep = await SoakRunner(spec, progress=lambda m: None,
                               checksum_backend="cpu").run()
        assert rep.wrong_bytes == 0
        assert rep.gates["zero_wrong_bytes"][0]
        assert rep.gates["progress"][0], rep.gates
        assert all(w.ops_ok > 0 for w in rep.workloads)
        kinds = [e.kind for e in rep.fault_events]
        assert kinds == ["straggler", "straggler-clear"]
        assert all(e.ok for e in rep.fault_events)
        assert rep.passed
    run(body())


def test_runner_takes_cuda_or_cpu():
    from t3fs_torch.soak.runner import SoakRunner

    spec = load_spec(SMOKE)
    assert SoakRunner(spec, checksum_backend="cpu").checksum_backend == "cpu"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        SoakRunner(spec, checksum_backend="tpu")


# ------------------------------------------------- health_bench

def test_health_bench_cells_equal_keys_across_packages():
    """Both packages' health_bench at --trials 8 --warm-reads 20
    --steady-reads 40 --steady-repeat 1 (the port's on --cpu): the same
    cells and keys, each cold trial's read answered OK (the bench asserts
    it), the trial and read counts as asked.  Timings are not compared."""
    from benchmarks import health_bench as ref_hb
    from t3fs_torch.benchmarks import health_bench as port_hb

    argv = ["--trials", "8", "--warm-reads", "20", "--steady-reads", "40",
            "--steady-repeat", "1"]
    ref = run(ref_hb.amain(ref_hb.parse_args(argv)))
    port = run(port_hb.amain(port_hb.parse_args(argv + ["--cpu"])))
    assert list(port) == list(ref) == ["cold_first_read", "steady_state"]
    for cell in port:
        assert list(port[cell]) == list(ref[cell]), cell
    c = port["cold_first_read"]
    assert c["priors_off_trials"] == c["priors_on_trials"] == 8
    assert (c["straggler_ms"], c["nodes"]) == (10.0, 3)
    s = port["steady_state"]
    assert s["plane_off_reads"] == s["plane_on_reads"] == 40
    assert s["plane_off_runs"] == s["plane_on_runs"] == 1
