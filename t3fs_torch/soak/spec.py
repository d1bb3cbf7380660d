"""Declarative soak scenario specs (configs/soak*.toml).

A scenario is one TOML file: fabric shape, run length, a list of
``[[workload]]`` tables (each one driver instance with its own rate
control and its own StorageClient), a list of ``[[fault]]`` tables (the
live injection schedule), and an ``[slo]`` table (the grade gates).
`ConfigBase` handles scalar validation; the array-of-tables nesting
(`workload`/`fault`) is spliced here because TOML arrays of tables have
no ConfigBase analog.

`demand_ops_s` double-duties by design: it is the open-loop pacing rate
AND the fairness normalizer — a workload's goodput share is
`achieved_ops_s / demand_ops_s` capped at 1.0, so Jain's index measures
demand *satisfaction*, not raw ops (a checkpoint cycle and a 64 KiB
read are not comparable in ops/s).  Closed-loop drivers declare a
nominal demand for the same reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from t3fs_torch.utils.config import ConfigBase, cchoice, citem, cobj

WORKLOAD_KINDS = ("dataloader", "checkpoint", "kvcache", "metascan",
                  "graysort")
FAULT_KINDS = ("straggler", "crash", "bitrot", "node_add", "node_drain")


@dataclass
class WorkloadSpec(ConfigBase):
    name: str = citem("")
    kind: str = citem("dataloader", validator=cchoice(*WORKLOAD_KINDS))
    # open = paced at demand_ops_s (arrivals independent of completions);
    # closed = `concurrency` workers issue back-to-back
    mode: str = citem("open", validator=cchoice("open", "closed"))
    demand_ops_s: float = citem(20.0, validator=lambda v: v > 0)
    concurrency: int = citem(4, validator=lambda v: v >= 1)
    # rpc or the zero-copy ring plane, per driver
    data_plane: str = citem("rpc", validator=cchoice("rpc", "ring"))
    read_hedging: str = citem("off", validator=cchoice("off", "on"))
    # dataloader: zipf random reads over a pre-written file
    file_mb: int = citem(8, validator=lambda v: v >= 1)
    read_size: int = citem(65536, validator=lambda v: v >= 512)
    zipf_a: float = citem(1.2, validator=lambda v: v > 1.0)
    # checkpoint: save/restore cycles of a pytree this big
    tree_kb: int = citem(256, validator=lambda v: v >= 16)
    keep_last: int = citem(2, validator=lambda v: v >= 1)
    # kvcache: put/get churn; byte_budget_kb > 0 turns on eviction pressure
    value_bytes: int = citem(16384, validator=lambda v: v >= 64)
    keys: int = citem(256, validator=lambda v: v >= 8)
    get_batch: int = citem(8, validator=lambda v: v >= 1)
    put_ratio: float = citem(0.25, validator=lambda v: 0.0 <= v <= 1.0)
    byte_budget_kb: int = citem(0, validator=lambda v: v >= 0)
    # metascan: directory listings + stat sweeps over a seeded tree
    dirs: int = citem(4, validator=lambda v: v >= 1)
    files_per_dir: int = citem(16, validator=lambda v: v >= 1)
    # graysort: one op = a whole mini two-phase sort job
    sort_mb: int = citem(2, validator=lambda v: v >= 1)
    sort_partitions: int = citem(4, validator=lambda v: v >= 1)


@dataclass
class FaultSpec(ConfigBase):
    at_s: float = citem(10.0, validator=lambda v: v >= 0)
    kind: str = citem("straggler", validator=cchoice(*FAULT_KINDS))
    # 0 = the schedule picks deterministically from its seeded RNG
    node: int = citem(0, validator=lambda v: v >= 0)
    duration_s: float = citem(5.0, validator=lambda v: v > 0)  # straggler
    delay_ms: float = citem(20.0, validator=lambda v: v > 0)   # straggler
    chunks: int = citem(2, validator=lambda v: v >= 1)         # bitrot


@dataclass
class SLOSpec(ConfigBase):
    # Jain fairness over demand-satisfaction shares (faults-off bar)
    min_fairness: float = citem(0.8, validator=lambda v: 0.0 <= v <= 1.0)
    # starvation gate: every driver must complete >= this many ops in
    # EVERY progress window (run split into `progress_windows` slices)
    min_ops_per_window: int = citem(1, validator=lambda v: v >= 0)
    progress_windows: int = citem(3, validator=lambda v: v >= 1)
    # 0 disables the latency gate; per-workload override via workloads
    max_p99_ms: float = citem(0.0, validator=lambda v: v >= 0)


@dataclass
class SoakSpec(ConfigBase):
    name: str = citem("soak")
    duration_s: float = citem(60.0, validator=lambda v: v > 0)
    seed: int = citem(13)
    # fabric shape: replicated chains in table 1 (meta/data), single-
    # replica EC chains in table 2 (checkpoint shards; crash faults
    # lose them so scrub/repair has real work)
    nodes: int = citem(5, validator=lambda v: v >= 3)
    replicas: int = citem(3, validator=lambda v: v >= 1)
    chains: int = citem(5, validator=lambda v: v >= 1)
    ec_chains: int = citem(8, validator=lambda v: v >= 0)
    chunk_size: int = citem(65536, validator=lambda v: v >= 512)
    ec_k: int = citem(4, validator=lambda v: v >= 2)
    ec_m: int = citem(2, validator=lambda v: v >= 1)
    ec_chunk_size: int = citem(16384, validator=lambda v: v >= 512)
    # scrub: auto-derived targets (ckpt manifests), paced repair
    scrub_period_s: float = citem(2.0, validator=lambda v: v > 0)
    repair_budget_mbps: float = citem(8.0, validator=lambda v: v >= 0)
    # run the online rebalancer during the soak — node_add /
    # node_drain faults then exercise live chain moves under traffic,
    # paced by rebalance_budget_mbps (0 = unpaced)
    rebalance: bool = citem(False)
    rebalance_budget_mbps: float = citem(8.0, validator=lambda v: v >= 0)
    rebalance_period_s: float = citem(1.0, validator=lambda v: v > 0)
    check_period_s: float = citem(1.0, validator=lambda v: v > 0)
    # tail sampling: slow/errored traces self-select into the
    # harvest so the worst p99 spike ships with its critical path
    trace_sample_rate: float = citem(0.05,
                                     validator=lambda v: 0.0 <= v <= 1.0)
    trace_slow_ms: float = citem(50.0, validator=lambda v: v >= 0)
    # drain discipline: in-flight ops get this long after stop before
    # they are cancelled and counted
    drain_timeout_s: float = citem(15.0, validator=lambda v: v > 0)
    slo: SLOSpec = cobj(SLOSpec)
    workloads: list = field(default_factory=list)
    faults: list = field(default_factory=list)

    def validate(self) -> None:
        super().validate()
        names = [w.name for w in self.workloads]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate workload names: {names}")
        for w in self.workloads:
            w.validate()
        for f in self.faults:
            f.validate()


def load_spec(text_or_path: str) -> SoakSpec:
    """Parse a scenario TOML: ``[[workload]]`` / ``[[fault]]`` arrays
    splice into WorkloadSpec/FaultSpec lists, everything else is plain
    SoakSpec fields.  Workloads without a name get `kind` or `kindN`."""
    try:
        import tomllib
    except ImportError:                      # Python < 3.11
        import tomli as tomllib  # type: ignore[no-redef]
    if "\n" not in text_or_path and text_or_path.endswith(".toml"):
        with open(text_or_path, "rb") as f:
            d = tomllib.load(f)
    else:
        d = tomllib.loads(text_or_path)
    workloads = [WorkloadSpec.from_dict(w) for w in d.pop("workload", [])]
    faults = [FaultSpec.from_dict(f) for f in d.pop("fault", [])]
    spec = SoakSpec.from_dict(d)
    seen: dict[str, int] = {}
    for w in workloads:
        if not w.name:
            n = seen.get(w.kind, 0)
            seen[w.kind] = n + 1
            w.name = w.kind if n == 0 else f"{w.kind}{n}"
    spec.workloads = workloads
    spec.faults = sorted(faults, key=lambda f: f.at_s)
    spec.validate()
    return spec
