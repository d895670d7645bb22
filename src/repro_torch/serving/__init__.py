from repro_torch.serving.engine import Engine, EngineConfig, StepHandle
from repro_torch.serving.frontend import FrontendConfig, OnlineFrontend
from repro_torch.serving.request import (
    TERMINAL_STATES,
    Request,
    RequestState,
    SessionStats,
)
from repro_torch.serving.scheduler import (
    ChunkingScheduler,
    PrefillChunk,
    SchedulerConfig,
    StepPlan,
)
from repro_torch.serving.server import (
    AsymCacheServer,
    ScriptedSource,
    ServerConfig,
    reference_logits,
)
from repro_torch.serving.sessions import (
    AgentSession,
    OnlineTelemetry,
    SessionState,
)
from repro_torch.serving.workload import (
    AgenticConfig,
    SessionScript,
    SharedPrefixConfig,
    StressConfig,
    TurnScript,
    WorkloadConfig,
    agentic_session_scripts,
    agentic_workload,
    control_plane_stress_scripts,
    decode_burst_workload,
    multi_turn_workload,
    requests_from_scripts,
    shared_prefix_workload,
)

__all__ = [
    "Engine", "EngineConfig", "StepHandle", "Request", "RequestState",
    "SessionStats", "TERMINAL_STATES",
    "ChunkingScheduler", "PrefillChunk", "SchedulerConfig", "StepPlan",
    "AsymCacheServer", "ScriptedSource", "ServerConfig", "reference_logits",
    "FrontendConfig", "OnlineFrontend",
    "AgentSession", "OnlineTelemetry", "SessionState",
    "AgenticConfig", "SessionScript", "SharedPrefixConfig", "StressConfig",
    "TurnScript", "WorkloadConfig", "agentic_session_scripts",
    "agentic_workload", "control_plane_stress_scripts",
    "decode_burst_workload", "multi_turn_workload", "requests_from_scripts",
    "shared_prefix_workload",
]
