"""The port's rebalance drill (t3fs_torch/benchmarks/rebalance_drill_bench.py)
on the CPU: `--smoke --cpu` at the reference's defaults (3 nodes, 2
replicas, 6 CR and 4 RS(2+1) chains, 8 KiB chunks and 16 KiB writes, 2
writers, 2 readers), its baseline window cut from 4 s to 2 s so the test
stays well inside a minute.  Four gates hold here: zero wrong bytes, zero
foreground errors, paced within budget, converged.  The fifth, the drill's
read p50 within 1.3x of the baseline's + 0.5 ms, compares two windows
taken seconds apart on the host's clock; beside the suite's other workers
they see different CPU contention (the ratio read 1.17-1.53 with seven busy
processes beside the drill, 1.02 alone), so it is held where the drill
runs alone: `chip_smoke.py --rebalance-drill RUNS` on the card fails
unless all five hold in every run.  Here the gate's value is checked to
be the bench's own formula.

The drill kills and restarts the node it adds.  Here the bench's
LocalCluster is swapped, by monkeypatch in the bench's module, for a
subclass whose heartbeat timeout test load cannot reach and which declares
a node dead when it is killed (mgmtd's liveness check fails for it until
it starts again), as tests/test_torch_recovery_benches.py does: a stalled
loop never fences a live node, and the flap is seen at once."""

import asyncio

import pytest

import t3fs_torch.benchmarks.rebalance_drill_bench as rdb
from t3fs_torch.testing.cluster import LocalCluster


class SteadyCluster(LocalCluster):
    def __init__(self, *args, **kw):
        kw["heartbeat_timeout_s"] = 30.0
        super().__init__(*args, **kw)
        self.declared_dead: set[int] = set()

    async def start(self):
        await super().start()
        alive = self.mgmtd.state.node_alive
        self.mgmtd.state.node_alive = (
            lambda n: n not in self.declared_dead and alive(n))

    async def kill_storage_node(self, node_id):
        await super().kill_storage_node(node_id)
        self.declared_dead.add(node_id)

    async def start_storage_node(self, node_id, with_targets=True):
        self.declared_dead.discard(node_id)
        return await super().start_storage_node(node_id, with_targets)


@pytest.fixture
def steady_cluster(monkeypatch):
    monkeypatch.setattr(rdb, "LocalCluster", SteadyCluster)


def test_rebalance_drill_smoke_cpu(steady_cluster):
    args = rdb.parse_args(["--smoke", "--cpu", "--baseline-s", "2"])
    res = asyncio.run(rdb.run_bench(args))
    gates = dict(res["gates"])
    p50 = gates.pop("fg_p50_within_1p3x")
    assert gates == {"zero_wrong_bytes": True, "zero_fg_errors": True,
                     "paced_within_budget": True, "converged": True}, res
    assert res["smoke"] and res["stripes"] == 6
    base, drill = res["cells"]
    assert 0 < base["fg_read_p50_ms"] and 0 < drill["fg_read_p50_ms"]
    assert p50 == (drill["fg_read_p50_ms"]
                   <= base["fg_read_p50_ms"] * 1.3 + 0.5)
    assert res["verified"] == p50
    assert base["name"] == "no_rebalance" and base["fg_reads"] > 0
    assert drill["name"] == "rebalance_drill" and drill["flapped"]
    assert drill["new_node"] == 4 and drill["new_node_targets"] >= 1
    assert drill["drained_node_targets"] == 0
    assert drill["moves_done"] >= 1 and drill["bytes_submitted"] > 0


def test_drill_cli_defaults_match_the_reference():
    """The same flags and defaults as benchmarks/rebalance_drill_bench.py,
    plus --cpu and --device."""
    import benchmarks.rebalance_drill_bench as ref

    port, want = vars(rdb.parse_args([])), vars(ref.parse_args([]))
    assert {k: v for k, v in port.items() if k not in ("cpu", "device")} \
        == want
    assert port["cpu"] is False and port["device"] is False
