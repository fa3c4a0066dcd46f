"""Runtime support of the port: seeded fault injection (``chaos``)."""
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

__all__ = [
    "ALL_SITES", "FaultPlan", "FaultSpec", "InjectedFault",
    "RequestError", "SystemError_", "current_plan", "install_plan",
    "maybe_fault", "plan_from_spec", "should_fault",
]
