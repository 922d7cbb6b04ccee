"""TMSN core: certificates, stopping rules, protocol, the event
simulator, the single-device round engine and the engine sharded over a
1-D or a two-tier (pod, workers) worker mesh, and TMSN-SGD (the
transformer worker and its oracle); counterpart of
``src/repro/core``."""

from repro_torch.core.ess import effective_sample_size
from repro_torch.core.stopping import (
    StoppingRuleParams,
    stopping_rule_fires,
    stopping_threshold,
)
from repro_torch.core.protocol import Certificate, TMSNMessage, accepts, improves
from repro_torch.core.result import SimResult, TrafficCounters
from repro_torch.core.simulator import (
    SimulatorConfig,
    WorkerSpec,
    TMSNSimulator,
)
from repro_torch.core.worker import (
    BatchedTMSNWorker,
    TMSNWorker,
    export_payload_rows,
    has_resample_hooks,
    payload_bytes_from_export,
    resolve_payload_bytes,
)
from repro_torch.core.engine import (
    AUTO_CAPACITY_HEADROOM,
    EngineConfig,
    FaultPlan,
    MembershipPlan,
    TMSNEngine,
    make_engine,
    quantize_latency,
)
from repro_torch.core.engine_sharded import ShardedTMSNEngine, sharded_engine_available
from repro_torch.core.tmsn_sgd import OracleResult, TMSNSGDConfig, make_oracle_round, oracle_run
from repro_torch.core.sgd_worker import BatchedSGDState, BatchedSGDWorker, lm_sgd_worker

__all__ = [
    "effective_sample_size",
    "StoppingRuleParams",
    "stopping_rule_fires",
    "stopping_threshold",
    "Certificate",
    "TMSNMessage",
    "accepts",
    "improves",
    "SimulatorConfig",
    "WorkerSpec",
    "TMSNSimulator",
    "SimResult",
    "TrafficCounters",
    "TMSNWorker",
    "BatchedTMSNWorker",
    "export_payload_rows",
    "has_resample_hooks",
    "payload_bytes_from_export",
    "resolve_payload_bytes",
    "AUTO_CAPACITY_HEADROOM",
    "EngineConfig",
    "FaultPlan",
    "MembershipPlan",
    "TMSNEngine",
    "make_engine",
    "quantize_latency",
    "ShardedTMSNEngine",
    "sharded_engine_available",
    "TMSNSGDConfig",
    "OracleResult",
    "make_oracle_round",
    "oracle_run",
    "BatchedSGDState",
    "BatchedSGDWorker",
    "lm_sgd_worker",
]
