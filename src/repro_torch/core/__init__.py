"""Forge-UGC core: the four-phase compiler (capture, passes, RGIR
lowering, Phase-4 scheduling/liveness/allocation/executors) and its
autotuner, the compile cache (memory and disk tiers) and the background
compile service, the bucketed multi-program front with its buffer pool,
and the paged-KV page pool."""
from .autotune import AutotuningCompiler, TuneCandidate, TuneResult
from .backends import available_backends, get_backend
from .cache import CompileCache, DiskCacheStore, get_compile_cache
from .capture import CaptureResult, trace_to_graph
from .compile_service import CompileService, get_compile_service
from .compiler import (
    BucketedModule,
    BufferPool,
    CompilationResult,
    CompiledModule,
    ForgeCompiler,
    forge_compile,
    forge_compile_bucketed,
)
from .executor import CompiledExecutor, ExecutorStats, analyze_program
from .graph import Graph
from .lowering import RGIRProgram, lower_to_rgir
from .cost_model import CostBreakdown, roofline_score, score_graph
from .passes import PipelineConfig, default_passes, run_forge_passes
from .shapekey import PolyAxis, ShapeKey, get_bucket_policy

__all__ = [
    "AutotuningCompiler",
    "TuneCandidate",
    "TuneResult",
    "available_backends",
    "BucketedModule",
    "BufferPool",
    "CompileCache",
    "CompileService",
    "DiskCacheStore",
    "get_compile_cache",
    "get_compile_service",
    "forge_compile_bucketed",
    "PolyAxis",
    "ShapeKey",
    "get_bucket_policy",
    "get_backend",
    "CaptureResult",
    "trace_to_graph",
    "CompilationResult",
    "CompiledModule",
    "ForgeCompiler",
    "forge_compile",
    "CompiledExecutor",
    "ExecutorStats",
    "analyze_program",
    "Graph",
    "RGIRProgram",
    "lower_to_rgir",
    "run_forge_passes",
    "PipelineConfig",
    "default_passes",
    "CostBreakdown",
    "score_graph",
    "roofline_score",
]
