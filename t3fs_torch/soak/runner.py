"""SoakRunner: build one live fabric, run every driver + the fault
schedule against it, grade the wreckage.

Orchestration order matters and is documented inline: tracing first
(drivers' client spans must be sampled from op one), then the cluster,
then driver setup (pre-writes files/trees/keys), then the maintenance
plane (scrub with manifest discovery + CheckWorker sinks — BEFORE
faults, so a bit-rot injection always has a discovered registry to pick
from), then drivers + faults concurrently, then the drain discipline,
then harvest.

The runner also feeds a MonitorCollectorServer: once a second it writes
``soak.<workload>.{ops,errors,p50_ms}`` metric rows, so `python -m
t3fs_torch.cli.admin --monitor <addr> soak-status` can watch a run live
from another terminal.

The port of t3fs/soak/runner.py, with two differences.  `checksum_backend`
("cuda" by default, or "cpu") goes to the cluster (every node's CRCs on B1
or on the host CRC) and to every EC client the runner or a driver builds
(TorchECCodec on the card or on its plain versions); without a GPU and
without "cpu" the runner raises.  On the card, the CUDA context and the
kernel libraries are made before the cluster starts, and every node's
backend warmup is awaited before the drivers' setup: built on the event
loop, the first CUDA backend stalls the loop past the nodes' 0.3 s
self-fence.
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.soak.drivers import SoakContext, build_driver
from t3fs_torch.soak.faults import FaultSchedule, LiveInjector
from t3fs_torch.soak.harvest import (SoakReport, capture_worst_trace, grade,
                               summarize)
from t3fs_torch.soak.spec import SoakSpec
from t3fs_torch.utils import tracing
from t3fs_torch.utils.tracing import TraceConfig

log = logging.getLogger("t3fs_torch.soak")


def warm_card() -> None:
    """The CUDA context and every kernel library, built and loaded: run
    off the event loop, before a cluster on the card starts."""
    from t3fs_torch.ops import _build

    _build.build_all()
    for name in _build.SIGNATURES:
        _build.library(name)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


class SoakRunner:
    def __init__(self, spec: SoakSpec, progress=None,
                 checksum_backend: str = "cuda"):
        if checksum_backend not in ("cuda", "cpu"):
            raise ValueError(f"checksum_backend {checksum_backend!r}: "
                             f"'cuda' or 'cpu'")
        # the card unless asked for the CPU: raises where no GPU is present
        resolve_device(checksum_backend)
        self.checksum_backend = checksum_backend
        self.spec = spec
        self.progress = progress or (lambda msg: log.info("%s", msg))
        self.cluster = None
        self.drivers = []
        self.scrub = None
        self.collector = None
        self.reporter = None
        self.metrics_collector = None
        self._maint_sc = None
        self.monitor_address: str | None = None
        self.migration = None
        self.rebalancer = None
        self._mig_client = None

    async def run(self, require_fairness: bool | None = None
                  ) -> SoakReport:
        """Run the whole scenario; returns the graded report.  By
        default the fairness gate applies only to a faults-off spec (a
        crash SHOULD dent the victim's share); pass require_fairness
        explicitly to override."""
        from t3fs_torch.monitor.service import MonitorCollectorServer
        from t3fs_torch.storage.scrub_scheduler import ScrubScheduler
        from t3fs_torch.testing.cluster import LocalCluster

        spec = self.spec
        if require_fairness is None:
            require_fairness = not spec.faults

        # 1. tracing before any client exists: tail sampling self-selects
        # slow/errored traces into the buffer the harvest drains.  The
        # same config goes to the cluster: storage nodes install THEIR
        # cfg.trace process-wide on every (re)start, so without it a
        # node start — including a crash fault's restart — would reset
        # sampling to zero mid-run.
        trace_cfg = TraceConfig(sample_rate=spec.trace_sample_rate,
                                export="tail", slow_ms=spec.trace_slow_ms)
        tracing.configure(trace_cfg)
        tracing.BUFFER.drain(10 ** 9)        # start from an empty buffer

        self.progress(f"soak '{spec.name}': {spec.nodes} nodes, "
                      f"{len(spec.workloads)} workloads, "
                      f"{len(spec.faults)} faults, {spec.duration_s:.0f}s")
        if self.checksum_backend == "cuda":
            await asyncio.to_thread(warm_card)
        cluster = self.cluster = LocalCluster(
            num_nodes=spec.nodes, replicas=spec.replicas,
            num_chains=spec.chains, with_meta=True,
            ec_chains=spec.ec_chains, trace=trace_cfg,
            checksum_backend=self.checksum_backend)
        await cluster.start()
        ctx = SoakContext(
            cluster, spec,
            repl_chains=list(range(1, spec.chains + 1)),
            ec_chain_ids=list(range(spec.chains + 1,
                                    spec.chains + spec.ec_chains + 1)),
            checksum_backend=self.checksum_backend)
        report: SoakReport | None = None
        try:
            # each node's checksum backend warms up in a thread (on the
            # card: the tables and pinned staging); let it finish before
            # any traffic
            for ss in list(cluster.storage.values()):
                warmup = getattr(ss, "_warmup_task", None)
                if warmup is not None:
                    await warmup
            # 2. drivers pre-write their working sets against the live
            # fabric (zipf files, checkpoint trees, kvcache namespaces,
            # metascan trees, sort inputs)
            self.drivers = [build_driver(spec, wl, i, ctx)
                            for i, wl in enumerate(spec.workloads)]
            await asyncio.gather(*(d.setup() for d in self.drivers))
            self.progress(f"setup done: {[d.name for d in self.drivers]}")

            # 3. maintenance plane: scrub targets auto-derive from the
            # checkpoint drivers' manifest directories (nothing is
            # manually registered), CheckWorkers feed bit-rot
            # finds into the scheduler
            maint_sc = self._maint_sc = ctx.make_client()
            ec = ctx.make_ec(maint_sc)
            ckpt_dirs = [d.directory for d in self.drivers
                         if d.wl.kind == "checkpoint"]
            from t3fs_torch.ckpt.scrub import manifest_discovery
            fs = ctx.filesystem(maint_sc)
            self.scrub = ScrubScheduler(
                ec, repair_mode="subshard",
                budget_mbps=spec.repair_budget_mbps,
                period_s=spec.scrub_period_s,
                discovery=manifest_discovery(fs, ckpt_dirs))

            async def wire_check(node_id: int) -> None:
                cw = cluster.storage[node_id].check
                cw.corrupt_sink = self.scrub.note_corrupt
                cw.period_s = spec.check_period_s
                cw.verify_chunks_per_tick = 64

            for node_id in list(cluster.storage):
                await wire_check(node_id)
            await self.scrub.refresh_targets()   # registry ready pre-fault
            await self.scrub.start()

            # 4. live-status surface for `admin soak-status`
            self.collector = MonitorCollectorServer()
            await self.collector.start()
            self.monitor_address = self.collector.server.address
            self.progress(f"monitor: {self.monitor_address}")
            # feed the collector's health plane: a reporter ships the
            # rpc.latency samples + tail-promoted spans the rollup pass
            # digests, so `admin soak-status` shows per-node health while
            # the fault schedule runs.  Note tail sampling
            # biases span-sourced rollups toward slow traces — exactly
            # what straggler detection wants to see.
            from t3fs_torch.monitor.reporter import MonitorReporter
            from t3fs_torch.utils.metrics import Collector
            self.reporter = MonitorReporter(self.monitor_address,
                                            node_id=0, node_type="soak")
            self.metrics_collector = Collector(period_s=1.0,
                                               reporters=[self.reporter])
            self.metrics_collector.start()

            # 4.5 elastic membership: the online rebalancer
            # turns node_add/node_drain faults into live chain moves,
            # paced so they cannot starve the foreground drivers
            if spec.rebalance:
                from t3fs_torch.migration.rebalancer import Rebalancer
                from t3fs_torch.migration.service import MigrationService
                from t3fs_torch.net.client import Client
                self._mig_client = Client()
                self.migration = MigrationService(
                    cluster.mgmtd_rpc.address, client=self._mig_client,
                    poll_period_s=0.1, sync_timeout_s=spec.duration_s,
                    flap_timeout_s=5.0)
                self.rebalancer = Rebalancer(
                    self.migration,
                    budget_mbps=spec.rebalance_budget_mbps,
                    plan_period_s=spec.rebalance_period_s)
                await self.migration.start()
                await self.rebalancer.start()

            async def wire_new_node(node_id: int) -> None:
                # a node_add fault's fresh server needs the same
                # CheckWorker sink wiring as a crash-restart's
                if node_id in cluster.storage:
                    await wire_check(node_id)

            injector = LiveInjector(
                cluster, self.scrub,
                rng=np.random.default_rng(spec.seed ^ 0xB17),
                on_restart=wire_new_node)
            schedule = FaultSchedule(spec, injector)

            # 5. traffic + faults, concurrently, for duration_s
            t0 = time.monotonic()
            for d in self.drivers:
                d.start()
            fault_task = asyncio.create_task(schedule.run(),
                                             name="soak-faults")
            reporter = asyncio.create_task(self._report_loop(t0),
                                           name="soak-reporter")
            await asyncio.sleep(spec.duration_s)

            # 6. drain discipline: stop arrivals everywhere first, then
            # give in-flight ops drain_timeout_s, then cancel + count
            for d in self.drivers:
                d.request_stop()
            elapsed = time.monotonic() - t0
            await asyncio.gather(
                *(d.drain(spec.drain_timeout_s) for d in self.drivers))
            reporter.cancel()
            await asyncio.gather(reporter, return_exceptions=True)
            if not fault_task.done():
                try:
                    await asyncio.wait_for(fault_task, spec.drain_timeout_s)
                except asyncio.TimeoutError:
                    fault_task.cancel()
                    await asyncio.gather(fault_task,
                                         return_exceptions=True)

            # 7. harvest: stats, fairness, gates, worst-p99 trace
            report = summarize(spec, self.drivers, elapsed)
            report.fault_events = list(schedule.events)
            report.worst_trace_root, report.worst_trace_rendered = \
                capture_worst_trace(db=self.collector.db)
            grade(report, spec, require_fairness=require_fairness)
            for gate, (ok, detail) in report.gates.items():
                self.progress(f"gate {gate}: "
                              f"{'PASS' if ok else 'FAIL'} ({detail})")
            return report
        finally:
            await self._teardown()

    async def _report_loop(self, t0: float) -> None:
        """Once a second: per-workload live rows into the collector DB
        (the soak-status query surface) + a progress line."""
        while True:
            await asyncio.sleep(1.0)
            now = time.time()
            rows = []
            for d in self.drivers:
                ok = [o for o in d.ops if o.ok]
                lat = sorted(o.lat_s for o in ok[-256:])
                p50 = lat[len(lat) // 2] * 1000 if lat else 0.0
                rows += [
                    {"name": f"soak.{d.name}.ops", "value": len(ok)},
                    {"name": f"soak.{d.name}.errors", "value": d.errors},
                    {"name": f"soak.{d.name}.p50_ms",
                     "value": round(p50, 3)},
                ]
            if self.collector is not None:
                self.collector.db.insert(0, "soak", now, rows)
            t = time.monotonic() - t0
            if int(t) % 10 == 0:
                line = " ".join(
                    f"{d.name}={len([o for o in d.ops if o.ok])}"
                    for d in self.drivers)
                self.progress(f"[{t:5.0f}s] {line}")

    async def _teardown(self) -> None:
        for d in self.drivers:
            try:
                await d.teardown()
            except Exception:                    # noqa: BLE001
                log.exception("soak: driver %s teardown failed", d.name)
        if self.rebalancer is not None:
            await self.rebalancer.stop()
            self.rebalancer = None
        if self.migration is not None:
            await self.migration.stop()
            self.migration = None
        if self._mig_client is not None:
            await self._mig_client.close()
            self._mig_client = None
        if self.scrub is not None:
            await self.scrub.stop()
            await self.scrub.ec.close()
        if self._maint_sc is not None:
            await self._maint_sc.close()
        if self.metrics_collector is not None:
            self.metrics_collector.stop()
            self.metrics_collector = None
        if self.reporter is not None:
            self.reporter.close()
            self.reporter = None
        if self.collector is not None:
            await self.collector.stop()
        if self.cluster is not None:
            await self.cluster.stop()
