"""Append-only training metrics log.

Port of ``neural_ldpc_tpu/utils/metrics_logger.py``.  The on-disk format is
the reference's ``checkpoints/training_metrics.txt``
(src/checkpoint_utils/MetricsLogger.py:21-71): a config header block on
epoch 0, ``%.6e`` for any metric whose key contains "ber", ``%.6f``
otherwise, and a trailing checkpoint-file column; the lines are byte for
byte the JAX package's.  Formatting lives in pure functions (tested with an
injected clock); the logger is a thin appender around them.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Any, Callable, Optional

_RULE = "-" * 120
_TIMESTAMP_FMT = "%Y-%m-%d %H:%M:%S"


def format_metric(key: str, value: float) -> str:
    """BER-like metrics in scientific notation, everything else fixed-point."""
    return f"{value:.6e}" if "ber" in key.lower() else f"{value:.6f}"


def format_header(config: dict[str, Any], metric_keys, started_at: datetime) -> str:
    """The epoch-0 header block (reference :37-42)."""
    config_cells = ", ".join(f"{k}={v}" for k, v in config.items())
    columns = ", ".join(metric_keys)
    return (
        f"# Training started: {started_at.strftime(_TIMESTAMP_FMT)}\n"
        f"# Config: {config_cells}\n"
        f"# Columns: Epoch, Timestamp, {columns}, Checkpoint_File\n"
        f"{_RULE}\n"
    )


def format_row(
    epoch: int, metrics: dict[str, float], checkpoint_filename: str, at: datetime
) -> str:
    """One epoch row (reference :44-56)."""
    cells = [f"{epoch:4d}", at.strftime(_TIMESTAMP_FMT)]
    cells += [format_metric(k, v) for k, v in metrics.items()]
    cells.append(checkpoint_filename)
    return ", ".join(cells) + "\n"


class MetricsLogger:
    def __init__(
        self,
        log_dir: str = "checkpoints",
        filename: str = "training_metrics.txt",
        clock: Callable[[], datetime] = datetime.now,
    ):
        self.log_file = os.path.join(log_dir, filename)
        os.makedirs(log_dir, exist_ok=True)
        self._clock = clock
        self.best_ber = float("inf")

    def log(
        self,
        epoch: int,
        metrics: dict[str, float],
        checkpoint_filename: str,
        config: Optional[dict[str, Any]] = None,
    ):
        now = self._clock()
        text = ""
        if epoch == 0 and config is not None:
            text = format_header(config, metrics.keys(), now)
        text += format_row(epoch, metrics, checkpoint_filename, now)
        # a header epoch truncates: a restart from scratch starts a fresh log
        # (the reference opens with mode "w", :37)
        mode = "w" if (epoch == 0 and config is not None) else "a"
        with open(self.log_file, mode) as f:
            f.write(text)

    def is_best(self, ber: float) -> bool:
        """Track the running-best BER (reference :58-71)."""
        if ber < self.best_ber:
            self.best_ber = ber
            return True
        return False
