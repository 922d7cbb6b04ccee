"""TMSN core: certificates, stopping rules, protocol, the event
simulator and the single-device round engine; counterpart of
``src/repro/core`` (the sharded engine is not ported yet)."""

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
    EngineConfig,
    TMSNEngine,
    make_engine,
    quantize_latency,
)

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
    "EngineConfig",
    "TMSNEngine",
    "make_engine",
    "quantize_latency",
]
