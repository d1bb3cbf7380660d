"""The port's CRAQ schedule explorer (t3fs_torch.testing.craq_sim, over the
port's ChunkReplica, ChunkEngine and next_chain_state) against the JAX
package's: every case of tests/test_craq_sim.py run on the port, then each
family's schedules run in both packages seed by seed with equal results
(violations, the chain's final membership and states, every write's
version and ack, each serving replica's chunk metas and bytes, and the
schedule's random stream at its end).

CRAQ protocol model checking via seeded deterministic schedules.

Reference analog: specs/DataStorage P-spec test schedules (specs/README.md).
The simulator drives the REAL ChunkReplica state machine and the REAL
next_chain_state transition function; these seeds historically exposed:
  - committed-chunk regression to DIRTY by a same-version late REPLACE
  - missing full-chunk forward fallback after a mid-write resync promotion
  - undetected fast restarts (generation change inside the heartbeat window)
  - resync sending stale checksums after a concurrent write
"""

import pytest

from t3fs_torch.testing.craq_sim import CraqSim, run_schedules


def test_no_crash_schedules_converge():
    assert run_schedules(20, crashes=0) == {}


def test_single_crash_schedules():
    assert run_schedules(60, crashes=1) == {}


def test_double_crash_schedules():
    assert run_schedules(60, crashes=2) == {}


def test_crash_with_disk_wipe_schedules():
    """Worst case: the restarted node lost its disk entirely."""
    assert run_schedules(40, crashes=1, wipe_on_crash=True) == {}
    assert run_schedules(40, crashes=2, wipe_on_crash=True) == {}


def test_two_replica_chain_schedules():
    assert run_schedules(30, crashes=1, replicas=2) == {}


def test_five_replica_chain_schedules():
    assert run_schedules(20, crashes=2, replicas=5, writes=8) == {}


@pytest.mark.slow
def test_schedule_soak():
    """Wider sweep (a few hundred schedules, still < 10 s)."""
    assert run_schedules(150, seed0=1000, crashes=2) == {}
    assert run_schedules(100, seed0=5000, crashes=2,
                         wipe_on_crash=True, writes=10, chunks=3) == {}


def test_mgmtd_restart_schedules():
    """Manager restarts mid-protocol: persisted chains + node generations
    must carry restart detection across the failover; the startup grace
    (everyone presumed alive) must not break safety."""
    assert run_schedules(60, crashes=1, mgmtd_restarts=1) == {}
    assert run_schedules(40, crashes=2, mgmtd_restarts=2) == {}


def test_disk_failure_schedules():
    """Disk dies under a live node (local OFFLINE via write-error/CheckWorker),
    chain pulls the target, operator replaces the disk, resync refills it —
    acked writes must survive throughout."""
    assert run_schedules(60, crashes=0, disk_fails=1) == {}
    assert run_schedules(40, crashes=1, disk_fails=1) == {}


def test_wide_sweep_regression_seeds():
    """Seeds the 10k-schedule sweep caught in round 2: abandoned-update
    DIRTY wedge (fixed by the replica ADVANCE rule), vacuous ack in a
    zero-membership window (sim fix), dead-disk LASTSRV wedge (chain
    state-machine fix), authority-loss accounting."""
    from t3fs_torch.testing.craq_sim import CraqSim
    for seed, kw in ((100862, dict(crashes=2)),
                     (101070, dict(crashes=2)),
                     (101149, dict(crashes=2)),
                     (300586, dict(crashes=1, mgmtd_restarts=1)),
                     (400006, dict(crashes=2, disk_fails=1)),
                     (400014, dict(crashes=2, disk_fails=1)),
                     (400024, dict(crashes=2, disk_fails=1)),
                     (400025, dict(crashes=2, disk_fails=1)),
                     # round-4 hard-matrix find: a restarted (wiped)
                     # LASTSRV reseated as SERVING while the chain had
                     # already promoted another authority — acked-write
                     # loss + empty-disk resync propagation (fixed:
                     # superseded LASTSRV rejoins as SYNCING)
                     (990583, dict(crashes=2, wipe_on_crash=True,
                                   disk_fails=1))):
        sim = CraqSim(seed, **kw)
        sim.run()
        assert not sim.violations, (seed, sim.violations)


def test_mixed_failure_schedules():
    """Harshest mix the wide sweeps ran clean: disk failures combined with
    wipes, mgmtd restarts, and thin 2-replica chains."""
    assert run_schedules(40, seed0=600000, crashes=2, disk_fails=1,
                         wipe_on_crash=True) == {}
    assert run_schedules(40, seed0=900000, crashes=1, disk_fails=1,
                         mgmtd_restarts=1) == {}
    assert run_schedules(30, seed0=800000, crashes=2, replicas=2) == {}


# ---- the port against the reference, seed by seed ----

from t3fs.testing import craq_sim as ref_sim            # noqa: E402
from t3fs_torch.testing import craq_sim as port_sim     # noqa: E402

FAMILIES = {
    "no_crash": dict(crashes=0),
    "single_crash": dict(crashes=1),
    "double_crash": dict(crashes=2),
    "wipe": dict(crashes=2, wipe_on_crash=True),
    "two_replicas": dict(crashes=1, replicas=2),
    "five_replicas": dict(crashes=2, replicas=5, writes=8),
    "mgmtd_restart": dict(crashes=2, mgmtd_restarts=2),
    "disk_failure": dict(crashes=1, disk_fails=1),
    "mixed": dict(crashes=2, disk_fails=1, wipe_on_crash=True),
}
WIDE_SWEEP = ((100862, dict(crashes=2)), (101070, dict(crashes=2)),
              (101149, dict(crashes=2)),
              (300586, dict(crashes=1, mgmtd_restarts=1)),
              (400006, dict(crashes=2, disk_fails=1)),
              (400014, dict(crashes=2, disk_fails=1)),
              (400024, dict(crashes=2, disk_fails=1)),
              (400025, dict(crashes=2, disk_fails=1)),
              (990583, dict(crashes=2, wipe_on_crash=True, disk_fails=1)))


def _outcome(module, seed, **kw):
    """One schedule's result and the state it ends in, read just before
    the run closes its engines."""
    class Sim(module.CraqSim):
        def check_invariants(self):
            super().check_invariants()
            self.end = {
                "chain": (self.chain.chain_ver, [
                    (t.target_id, t.node_id, t.public_state.name)
                    for t in self.chain.targets]),
                "writes": sorted((op.chunk.encode(), op.ver, op.acked)
                                 for op in self.done),
                "replicas": {
                    tid: sorted((m.chunk_id.encode(), m.update_ver,
                                 m.commit_ver, m.checksum, m.length,
                                 n.engine.read(m.chunk_id))
                                for m in n.engine.all_metas())
                    for tid, n in sorted(self.nodes.items())
                    if n.alive and n.disk_ok},
                "rng": self.rng.getstate(),
            }

    sim = Sim(seed, **kw)
    violations = sim.run()
    return violations, sim.end


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_schedules_equal_across_packages(family):
    kw = FAMILIES[family]
    seed0 = 1000 * (sorted(FAMILIES).index(family) + 1)
    for seed in range(seed0, seed0 + 8):
        ref, port = _outcome(ref_sim, seed, **kw), _outcome(port_sim, seed,
                                                            **kw)
        assert ref[0] == port[0] == [], (family, seed, ref[0], port[0])
        assert ref[1] == port[1], (family, seed)
    assert ref_sim.run_schedules(6, seed0=seed0, **kw) == \
        port_sim.run_schedules(6, seed0=seed0, **kw) == {}


@pytest.mark.parametrize("seed,kw", WIDE_SWEEP,
                         ids=[str(seed) for seed, _ in WIDE_SWEEP])
def test_wide_sweep_seeds_equal_across_packages(seed, kw):
    ref, port = _outcome(ref_sim, seed, **kw), _outcome(port_sim, seed, **kw)
    assert ref[0] == port[0] == []
    assert ref[1] == port[1]
