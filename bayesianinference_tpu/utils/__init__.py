from .config import (
    EvidenceOptions,
    MCMCOptions,
    NestedSamplingOptions,
    compilation_cache_dir,
    enable_compilation_cache,
)
from .graph import ModelGraph, dependency_data, model_graph
from .profiling import timed, trace
from .validation import check_traceable, distribution_dimension

__all__ = [
    "timed",
    "trace",
    "EvidenceOptions",
    "MCMCOptions",
    "NestedSamplingOptions",
    "compilation_cache_dir",
    "enable_compilation_cache",
    "ModelGraph",
    "dependency_data",
    "model_graph",
    "check_traceable",
    "distribution_dimension",
]
