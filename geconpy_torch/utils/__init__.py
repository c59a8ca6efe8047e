"""Host-side utilities (mirrors ``geconpy_tpu/utils``): reports and
notebook rendering, labelled matrices, the persistent cache of the CUDA
build, profiler tables and device-memory accounting."""

from .compile_cache import enable_persistent_cache, persistent_cache_enabled
from .formatting import LabeledMatrix, matrix_to_dataframe
from .memory import format_bytes, program_memory
from .profiling import TraceTable, load_trace_events, summarize_trace
from .reporting import (block_to_html, build_report, model_to_html,
                        print_gcn_file, print_steady_state)

__all__ = ["block_to_html", "build_report", "model_to_html",
           "print_steady_state", "load_trace_events", "summarize_trace",
           "print_gcn_file", "matrix_to_dataframe", "LabeledMatrix",
           "enable_persistent_cache", "persistent_cache_enabled",
           "format_bytes", "program_memory", "TraceTable"]
