"""Runtime support of the port: seeded fault injection (``chaos``), the
training supervisor (``failure``) and the straggler monitor
(``straggler``)."""
from .chaos import (
    ALL_SITES,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RequestError,
    SystemError_,
    current_plan,
    install_plan,
    maybe_fault,
    plan_from_spec,
    should_fault,
)
from .failure import SimulatedFault, Supervisor, SupervisorReport
from .straggler import StragglerMonitor

__all__ = [
    "SimulatedFault", "Supervisor", "SupervisorReport", "StragglerMonitor",
    "ALL_SITES", "FaultPlan", "FaultSpec", "InjectedFault",
    "RequestError", "SystemError_", "current_plan", "install_plan",
    "maybe_fault", "plan_from_spec", "should_fault",
]
