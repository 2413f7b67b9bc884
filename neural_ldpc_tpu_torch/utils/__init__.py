from .checkpoint import CheckpointManager
from .metrics_logger import MetricsLogger
from .profiling import BenchResult, Timer, benchmark, trace
