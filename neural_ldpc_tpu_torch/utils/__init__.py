from .checkpoint import CheckpointManager
from .metrics_logger import MetricsLogger
