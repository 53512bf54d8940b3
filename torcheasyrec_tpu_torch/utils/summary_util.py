"""TensorBoard summaries of the train loop.

Counterpart of torcheasyrec_tpu/utils/summary_util.py as the JAX loop
uses it: ``train_config.tensorboard_summaries`` picks ``loss`` and
``learning_rate`` (both by default); the eval is always written. The
JAX writer's parameter and gradient-norm summaries have no caller in
its loop and are not ported. Writes through ``torch.utils.tensorboard``;
where that does not import (it needs the ``tensorboard`` package) the
writer logs a warning and writes nothing. Tags: ``loss/<name>`` for
every logged loss, ``learning_rate`` and ``eval/<metric>``.
"""

import logging
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger("tzrec_tpu_torch")


class SummaryWriter:
    def __init__(self, log_dir: str,
                 summaries: Optional[Sequence[str]] = None) -> None:
        self._summaries = set(summaries or ["loss", "learning_rate"])
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._w = TBWriter(log_dir=log_dir)
        except Exception as e:  # noqa: BLE001 - no tensorboard: no summaries
            logger.warning(f"tensorboard unavailable: {e}")
            self._w = None

    def log_scalars(self, step: int, losses: Dict[str, Any],
                    lr: Optional[float] = None) -> None:
        if self._w is None:
            return
        if "loss" in self._summaries:
            for k, v in losses.items():
                self._w.add_scalar(f"loss/{k}", float(v), step)
        if lr is not None and "learning_rate" in self._summaries:
            self._w.add_scalar("learning_rate", float(lr), step)

    def log_eval(self, step: int, result: Dict[str, float]) -> None:
        if self._w is None:
            return
        for k, v in result.items():
            try:
                self._w.add_scalar(f"eval/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
