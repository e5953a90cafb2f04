"""MARS core: unified info stream, external control plane (AIMD admission +
pressure-aware queue packing), internal agent-centric scheduler (windowed
MLFQ + opportunistic co-scheduler), and the baseline policies."""

from repro_torch.core.admission import ControlPlaneConfig, ExternalControlPlane
from repro_torch.core.coscheduler import CoSchedulerConfig, OpportunisticCoScheduler
from repro_torch.core.events import Event, EventBus
from repro_torch.core.mlfq import MLFQConfig, PriorityCoordinator
from repro_torch.core.policies import (KVAction, MARSConfig, MARSPolicy, Policy,
                                 make_policy)
from repro_torch.core.session import KVState, Phase, Round, Session, make_session
from repro_torch.core.telemetry import Telemetry, TelemetryConfig
