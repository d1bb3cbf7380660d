"""Mixed-workload soak harness: the port of t3fs/soak/.

One live fabric, many scenario drivers, live fault injection, graded
output.  See docs/soak.md for the scenario-spec format, the fault
matrix, and grading semantics.  The fabric is the port's LocalCluster:
every node's CRCs on the CUDA checksum backend (B1) and every EC client's
codec TorchECCodec on the card, unless SoakRunner is given
checksum_backend="cpu".

- ``spec``    — declarative scenario configs (configs/soak*.toml)
- ``drivers`` — workload drivers (dataloader, checkpoint, kvcache,
                metascan, graysort) with open/closed-loop rate control
- ``faults``  — the deterministic fault schedule (straggler, crash,
                bit-rot) driven against LocalCluster fault hooks
- ``harvest`` — per-workload p50/p99/throughput, Jain fairness, SLO
                gates, worst-p99 trace capture
- ``runner``  — orchestration: build the fabric, run everything, grade
"""

from t3fs_torch.soak.spec import (FaultSpec, SLOSpec, SoakSpec, WorkloadSpec,
                            load_spec)
from t3fs_torch.soak.harvest import jain_fairness
from t3fs_torch.soak.runner import SoakRunner

__all__ = [
    "FaultSpec", "SLOSpec", "SoakSpec", "WorkloadSpec", "load_spec",
    "jain_fairness", "SoakRunner",
]
