"""Runtime support of the port: seeded fault injection (``chaos``), the
training supervisor (``failure``), the straggler monitor (``straggler``)
and int8 gradient compression for the data-parallel all-reduce
(``compress``)."""
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
from .compress import (
    BLOCK,
    compress_tree,
    compressed_all_reduce,
    compression_ratio,
    dequantize_int8,
    quantize_int8,
)
from .failure import SimulatedFault, Supervisor, SupervisorReport
from .straggler import StragglerMonitor

__all__ = [
    "BLOCK", "compress_tree", "compressed_all_reduce", "compression_ratio",
    "dequantize_int8", "quantize_int8",
    "SimulatedFault", "Supervisor", "SupervisorReport", "StragglerMonitor",
    "ALL_SITES", "FaultPlan", "FaultSpec", "InjectedFault",
    "RequestError", "SystemError_", "current_plan", "install_plan",
    "maybe_fault", "plan_from_spec", "should_fault",
]
