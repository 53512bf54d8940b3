"""Checkpoints: save, restore, and the cadence and retention of saves.

Counterpart of torcheasyrec_tpu/utils/checkpoint_util.py. A checkpoint
is one file, ``<model_dir>/model.ckpt-<step>.pt``, independent of the
embedding engine's layout: the model's ``state_dict`` (tables in their
canonical ``[rows, dim]`` form), the sparse optimizer state per table,
the dense optimizer state, the step and epoch, the dataloader
watermark ``{source_id: last row consumed}`` that a resume skips, and
where the train state has them the accumulated dense gradients
(``accum_grads``) and the grad scaler's state (``scaler``).
"""

import glob
import os
import re
from typing import Any, Dict, List, Optional

import torch

CKPT_PREFIX = "model.ckpt-"
# an export artifact's weights, under its ``model/`` directory
MODEL_FILE = "model.pt"
# train state entries a checkpoint carries where the state has them
_OPTIONAL_STATE = ("accum_grads", "scaler")


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"{CKPT_PREFIX}{step}.pt")


def list_checkpoints(model_dir: str) -> List[int]:
    """Steps of the checkpoints in ``model_dir``, ascending."""
    steps = []
    for path in glob.glob(os.path.join(model_dir, f"{CKPT_PREFIX}*.pt")):
        m = re.search(rf"{re.escape(CKPT_PREFIX)}(\d+)\.pt$", path)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``model_dir``, else None."""
    steps = list_checkpoints(model_dir)
    return checkpoint_path(model_dir, steps[-1]) if steps else None


def save_checkpoint(model_dir: str, model, tx, state: Dict[str, Any],
                    dataloader_state: Optional[Dict[int, int]] = None) -> str:
    """Write ``model.ckpt-<step>.pt`` into ``model_dir``; returns its
    path. Row state of packed groups is read out of their rows, so a
    checkpoint written packed loads unpacked and back."""
    path = checkpoint_path(model_dir, state["step"])
    torch.save(
        {"model": model.state_dict(),
         "sparse_opt": model.embedding_group.opt_state_dict(
             state["sparse_opt"]),
         "dense_opt": tx.state_dict(), "step": state["step"],
         "epoch": state.get("epoch", 0),
         "dataloader_state": {int(k): int(v) for k, v in
                              (dataloader_state or {}).items()},
         **{k: state[k] for k in _OPTIONAL_STATE if k in state}},
        path,
    )
    return path


def load_model_weights(path: str, model, strict: bool = True
                       ) -> Dict[str, Any]:
    """Load the model's weights from a checkpoint of ``save_checkpoint``
    or a bare state_dict; returns what the file held. Without
    ``strict``, weights the file lacks keep their values and names the
    model lacks are ignored (shapes must still agree)."""
    dev = next(iter(model.embedding_group.engine_tables().values())).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ckpt.get("model", ckpt), strict=strict)
    return ckpt


def save_model(path: str, state: Dict[str, torch.Tensor]) -> str:
    """An export artifact's weights: ``state`` (a ``state_dict``, or a
    part of one) saved as ``<path>/model.pt``; returns that file."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, MODEL_FILE)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, out)
    return out


def restore_model(path: str, model, strict: bool = True) -> None:
    """Load ``<path>/model.pt`` of ``save_model`` into ``model``. Without
    ``strict``, weights the file lacks keep their values (a tower
    artifact holds its own tables only, a quantized one none)."""
    dev = next(iter(model.embedding_group.engine_tables().values())).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE),
                                     map_location=dev, weights_only=True),
                          strict=strict)


def restore_checkpoint(path: str, model, tx=None, strict: bool = True
                       ) -> Dict[str, Any]:
    """Load a checkpoint into a model built for training (and into
    ``tx``); returns the train state beside the model: ``sparse_opt``,
    ``step``, ``epoch`` and ``dataloader_state``, and ``accum_grads`` and
    ``scaler`` where the file has them. Without ``strict`` it
    is the JAX package's partial restore: what the file lacks (the
    optimizer states and the step of a bare state_dict, a table, a
    layer) keeps its current or initial value."""
    ckpt = load_model_weights(path, model, strict=strict)
    if tx is not None and (strict or "dense_opt" in ckpt):
        tx.load_state_dict(ckpt["dense_opt"])
    eg = model.embedding_group
    if strict or "sparse_opt" in ckpt:
        sparse_opt = eg.load_opt_state_dict(ckpt["sparse_opt"])
    else:
        sparse_opt = eg.init_opt_state()
    return {"sparse_opt": sparse_opt, "step": int(ckpt.get("step", 0)),
            "epoch": int(ckpt.get("epoch", 0)),
            "dataloader_state": {int(k): int(v) for k, v in
                                 ckpt.get("dataloader_state", {}).items()},
            **{k: ckpt[k] for k in _OPTIONAL_STATE if k in ckpt}}


class CheckpointManager:
    """When to save (every ``save_checkpoints_steps`` steps, at the end
    of every ``save_checkpoints_epochs`` epochs, and on event time: every
    ``save_checkpoints_timestamp_interval`` of the data's timestamps, and
    when the data passes each of ``save_checkpoints_timestamps``), and
    how many checkpoints to keep (``keep_checkpoint_max``, 0 for all;
    the oldest go first)."""

    def __init__(
        self,
        model_dir: str,
        save_checkpoints_steps: int = 1000,
        save_checkpoints_epochs: int = 0,
        keep_checkpoint_max: int = 0,
        save_checkpoints_timestamp_interval: int = 0,
        save_checkpoints_timestamps: Optional[List[int]] = None,
    ) -> None:
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self._steps = save_checkpoints_steps
        self._epochs = save_checkpoints_epochs
        self._keep_max = keep_checkpoint_max
        self._ts_interval = save_checkpoints_timestamp_interval
        self._ts_targets = sorted(save_checkpoints_timestamps or [])
        self._last_trigger_time: Optional[int] = None

    def should_save(self, step: int, epoch_end: bool = False,
                    data_timestamp: Optional[int] = None) -> bool:
        if epoch_end and self._epochs:
            return True
        if self._steps and step > 0 and step % self._steps == 0:
            return True
        if data_timestamp is not None:
            if self._ts_interval:
                if self._last_trigger_time is None:
                    self._last_trigger_time = data_timestamp
                elif (data_timestamp - self._last_trigger_time
                      >= self._ts_interval):
                    self._last_trigger_time = data_timestamp
                    return True
            if self._ts_targets and data_timestamp >= self._ts_targets[0]:
                self._ts_targets.pop(0)
                return True
        return False

    def save(self, model, tx, state: Dict[str, Any],
             dataloader_state: Optional[Dict[int, int]] = None) -> str:
        path = save_checkpoint(self.model_dir, model, tx, state,
                               dataloader_state)
        self._prune()
        return path

    def _prune(self) -> None:
        if not self._keep_max:
            return
        steps = list_checkpoints(self.model_dir)
        while len(steps) > self._keep_max:
            os.remove(checkpoint_path(self.model_dir, steps.pop(0)))
