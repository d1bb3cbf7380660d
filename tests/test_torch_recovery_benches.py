"""The port's ec_recovery_bench cluster phases and repair_drill_bench
(t3fs_torch/benchmarks/{ec_recovery_bench,repair_drill_bench}.py) on the
CPU (--cpu: the nodes' CRCs on the host, TorchECCodec on its plain
versions): the drill smokes of tests/test_scrub_scheduler.py with the same
assertions, and each bench run through both packages at the same arguments
(the reference on its numpy codec) with the deterministic fields equal.

Both benches kill a node of a one-loop LocalCluster and wait for mgmtd to
notice.  Here each package's LocalCluster is swapped, by monkeypatch in the
bench's module, for a subclass whose heartbeat timeout test load cannot
reach and which declares a node dead when it is killed (mgmtd's liveness
check fails for it until it starts again): a stalled loop then never
fences a live node, and the damage, the plan and the repair traffic depend
on the arguments alone.  Neither package changes for it."""

import asyncio

import pytest

import benchmarks.ec_recovery_bench as ref_ecb
import benchmarks.repair_drill_bench as ref_drill
import t3fs_torch.benchmarks.ec_recovery_bench as ecb
import t3fs_torch.benchmarks.repair_drill_bench as drill
from t3fs.testing.cluster import LocalCluster as RefCluster
from t3fs_torch.testing.cluster import LocalCluster as PortCluster


def steady(cluster_cls):
    class Steady(cluster_cls):
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

    return Steady


@pytest.fixture
def steady_clusters(monkeypatch):
    for mod, cls in ((ref_ecb, RefCluster), (ref_drill, RefCluster),
                     (ecb, PortCluster), (drill, PortCluster)):
        monkeypatch.setattr(mod, "LocalCluster", steady(cls))


DRILL = ["--stripes", "6", "--chunk-size", "16384", "--readers", "1",
         "--warm-s", "0.2"]


def test_repair_drill_bench_smoke(steady_clusters):
    """The drill end to end, tiny budget: kill a node under live reads,
    A/B subshard vs full on identical damage; reduced repair moves < 0.5x
    the survivor bytes of full-k, everything verified."""
    res = asyncio.run(drill.run_bench(drill.parse_args(
        [*DRILL, "--budget-mbps", "1.0", "--cpu"])))
    assert res["verified"]
    assert res["lost_shards"] > 0
    assert res["repair_traffic_ratio"] is not None
    assert res["repair_traffic_ratio"] < 0.5, res["repair_traffic_ratio"]
    cells = {(c["mode"], c["budget_mbps"]): c for c in res["cells"]}
    assert cells[("subshard", 0.0)]["fallback_shards"] == 0
    assert cells[("full", 0.0)]["reduced_shards"] == 0
    for c in res["cells"]:
        assert c["bytes_repaired"] == res["lost_bytes"]


@pytest.mark.slow
def test_repair_drill_bench_msr_smoke(steady_clusters):
    """The same drill on a pm-msr layout: projection repair moves < 0.7x
    the survivor bytes of full-k (analytically d*beta/alpha = 0.5625), with
    zero wrong bytes and every rebuilt shard through the pm-msr repair
    step."""
    res = asyncio.run(drill.run_bench(drill.parse_args(
        ["--layout", "pm-msr", *DRILL, "--budget-mbps", "-1", "--cpu"])))
    assert res["verified"]
    assert res["lost_shards"] > 0
    assert res["read_errors"] == 0
    assert res["repair_traffic_ratio"] is not None
    assert res["repair_traffic_ratio"] < 0.7, res["repair_traffic_ratio"]
    cells = {(c["mode"], c["budget_mbps"]): c for c in res["cells"]}
    assert cells[("subshard", 0.0)]["fallback_shards"] == 0
    assert cells[("full", 0.0)]["reduced_shards"] == 0
    for c in res["cells"]:
        assert c["bytes_repaired"] == res["lost_bytes"]
    counts = res["codec_stats"]["counts"]
    assert counts.get("cuda-msr-repair", 0) >= 1, counts


CELL_KEYS = ("mode", "budget_mbps", "bytes_read", "bytes_repaired",
             "read_amplification", "reduced_shards", "fallback_shards",
             "sub_reads")
DRILL_KEYS = ("k", "m", "chunk_size", "stripes", "local_scheme", "group_size",
              "slots", "chains", "nodes", "lost_shards", "lost_bytes",
              "repair_traffic_ratio", "verified")


@pytest.mark.parametrize("layout", ["lrc-xor", "pm-msr"])
def test_repair_drill_matches_reference(layout, steady_clusters):
    """The drill through both packages at the same arguments: the damage
    (lost shards and bytes), and each cell's survivor bytes read, bytes
    rebuilt, reduced and full-k shards and sub-range reads are equal, and
    so is the headline ratio.  Not compared, being the host's clock or the
    background readers' schedule: the walls, MB/s, the paced waits, the
    foreground and healthy latencies and sample counts, read_errors."""
    argv = ["--layout", layout, *DRILL, "--budget-mbps", "1.0"]
    ref = asyncio.run(ref_drill.run_bench(ref_drill.parse_args(argv)))
    port = asyncio.run(drill.run_bench(drill.parse_args([*argv, "--cpu"])))
    assert port.keys() == ref.keys()
    assert {k: port[k] for k in DRILL_KEYS} == {k: ref[k] for k in DRILL_KEYS}
    assert len(port["cells"]) == len(ref["cells"]) == 4
    for pc, rc in zip(port["cells"], ref["cells"]):
        assert pc.keys() == rc.keys()
        assert {k: pc[k] for k in CELL_KEYS} == {k: rc[k] for k in CELL_KEYS}
    assert port["lost_shards"] > 0 and port["verified"]


EC_KEYS = ("k", "m", "chunk_size", "stripes", "bytes", "repaired_shards",
           "repair_bytes_read", "repair_bytes_repaired",
           "repair_stripes_failed", "repair_read_amplification",
           "survivor_read_imbalance", "survivor_reads_max_min", "verified")


def test_ec_recovery_bench_matches_reference(steady_clusters):
    """ec_recovery_bench's cluster phases through both packages at the
    same arguments: the bytes written, the shards and bytes repaired, the
    survivor bytes the repair read and their balance are equal, every
    stripe verified after the repair.  Not compared: the walls and MB/s
    (the host's clock), and the codec's stats (the reference's numpy codec
    has none)."""
    argv = ["--chunk-size", "16384", "--stripes", "6"]
    ref = asyncio.run(ref_ecb.run_bench(ref_ecb.parse_args(argv)))
    port = asyncio.run(ecb.run_bench(ecb.parse_args([*argv, "--cpu"])))
    assert port.keys() == ref.keys()
    assert {k: port[k] for k in EC_KEYS} == {k: ref[k] for k in EC_KEYS}
    assert port["repaired_shards"] > 0 and port["repair_stripes_failed"] == 0
    assert port["degraded_read_MB_s"] > 0 and port["write_MB_s"] > 0
    counts = port["codec_stats"]["counts"]
    assert counts.get("cuda-encode-words", 0) >= 1, counts
    assert counts.get("cuda-decode-words", 0) >= 1, counts


def test_ec_recovery_bench_main_prints_the_degraded_read_rate(capsys, steady_clusters):
    """`--cpu` runs the cluster phases and no microbench; the closing
    decode_metric line carries the measured degraded-read MB/s."""
    import json

    assert ecb.main(["--cpu", "--chunk-size", "16384", "--stripes", "4",
                     "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res, metric = json.loads(lines[0]), json.loads(lines[-1])["decode_metric"]
    assert res["verified"] and res["codec"] == "cpu"
    assert "decode_microbench" not in res
    assert metric == {"rs8+2_reconstruct_GB_s": None,
                      "degraded_read_MB_s": res["degraded_read_MB_s"]}
    assert metric["degraded_read_MB_s"] > 0


@pytest.mark.parametrize("nodes,chains,replicas", [(5, 10, 1), (6, 12, 3),
                                                   (16, 16, 1), (9, 24, 3)])
def test_recovery_weights_match_reference(nodes, chains, replicas):
    """ec_recovery_bench's chain_recovery_weights against the reference's
    (t3fs/mgmtd/placement.py) on the reference's balanced chain table, with
    one and two nodes down."""
    from t3fs.mgmtd import placement as ref_pl
    from t3fs.mgmtd import types as ref_types
    from t3fs_torch.mgmtd import types as port_types

    table = ref_pl.build_chain_table(nodes, chains, replicas, seed=3)

    def routing(types):
        r = types.RoutingInfo(version=1)
        for c, members in enumerate(table, start=1):
            r.chains[c] = types.ChainInfo(chain_id=c, chain_ver=1, targets=[
                types.ChainTargetInfo(ref_pl.target_id(n, c), n,
                                      types.PublicTargetState.SERVING)
                for n in members])
        return r

    port_r, ref_r = routing(port_types), routing(ref_types)
    for failed in ({nodes}, {1, nodes}):
        got = ecb.chain_recovery_weights(port_r, failed)
        assert got == ref_pl.chain_recovery_weights(ref_r, failed)
        assert sum(got.values()) == sum(
            sum(n in failed for n in members) for members in table)
