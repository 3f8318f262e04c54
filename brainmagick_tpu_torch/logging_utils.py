"""Metric sinks of the training loop.

Port of ``MetricSinks`` of ``brainmagick_tpu/logging_utils.py`` without
its optional backends: the port's record of a run is the history its
checkpoint and ``history-torch.json`` keep (``Solver.commit``), and
asking for wandb or TensorBoard raises.
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

logger = logging.getLogger(__name__)


class MetricSinks:
    """Logs each epoch's stage metrics."""

    def __init__(self, folder: Path, use_wandb: bool = False,
                 use_tensorboard: bool = False) -> None:
        if use_wandb or use_tensorboard:
            raise NotImplementedError(
                "wandb and tensorboard sinks are not ported to "
                "brainmagick_tpu_torch; the history is in "
                "history-torch.json")
        self.folder = folder

    def log(self, epoch: int, stages: tp.Dict[str, tp.Dict[str, float]]
            ) -> None:
        flat = {f"{stage}/{k}": v for stage, metrics in stages.items()
                for k, v in metrics.items() if isinstance(v, (int, float))}
        logger.info("epoch %d metrics: %s", epoch, flat)
