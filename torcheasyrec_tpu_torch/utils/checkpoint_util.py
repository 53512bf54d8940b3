"""Checkpoints: save, restore, and the cadence and retention of saves.

Counterpart of torcheasyrec_tpu/utils/checkpoint_util.py. A checkpoint
is one file, ``<model_dir>/model.ckpt-<step>.pt``, independent of the
embedding engine's layout: the model's ``state_dict`` (tables in their
canonical ``[rows, dim]`` form), the sparse optimizer state per table,
the dense optimizer state, the step and epoch, the dataloader
watermark ``{source_id: last row consumed}`` that a resume skips, and
where the train state has them the accumulated dense gradients
(``accum_grads``) and the grad scaler's state (``scaler``). The ZCH
mappings (``state["zch"]``) are buffers of the model and travel in its
``state_dict``; the host spill stores, where the model has them, travel
as ``zch_spill`` (the JAX package starts them empty on a resume), so a
resumed run continues as the straight run would. Over several ranks the
mappings are replicated and saved once; every save first checks that
they are equal, bit for bit, on every rank. ``zch_spill`` is then the
ranks' stores merged into one (``EmbeddingGroup.spill_state_dict``), and
a restore splits it again by row ownership at the restoring world size.

Over several ranks (a model whose engine has a ``ShardContext``) the
checkpoint is the same file: every rank takes part in gathering each
table, one at a time, to the host, and rank 0 writes it, with the ranks'
dataloader watermarks merged (each input file belongs to one rank). A
restore memory-maps the file and each rank copies only its own rows
and columns, so a checkpoint loads at any world size and any plan.
"""

import glob
import os
import re
from typing import Any, Dict, List, Optional

import torch

from torcheasyrec_tpu_torch.utils import dist_util

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
    checkpoint written packed loads unpacked and back. Over several ranks
    every rank calls it and rank 0 writes."""
    shard = model.embedding_group.engine.shard
    path = checkpoint_path(model_dir, state["step"])
    loader_state: Dict[int, int] = {}
    for part in dist_util.gather_host_objects(shard, dataloader_state or {}):
        for k, v in part.items():
            loader_state[int(k)] = max(loader_state.get(int(k), -1), int(v))
    ckpt = {"model": model.state_dict(),
            "sparse_opt": model.embedding_group.opt_state_dict(
                state["sparse_opt"]),
            "dense_opt": tx.state_dict(), "step": state["step"],
            "epoch": state.get("epoch", 0),
            "dataloader_state": loader_state,
            **{k: state[k] for k in _OPTIONAL_STATE if k in state}}
    eg = model.embedding_group
    if eg.has_zch and shard is not None and shard.world > 1:
        digests = dist_util.gather_host_objects(shard, eg.zch_digest())
        if len(set(digests)) != 1:
            raise RuntimeError(
                f"ZCH mappings differ between the ranks at step "
                f"{state['step']}: {digests}")
    if eg.spill is not None:
        ckpt["zch_spill"] = {
            t: {k: torch.from_numpy(v) for k, v in part.items()}
            for t, part in eg.spill_state_dict().items()}
    if dist_util.is_main_process(shard):
        # written aside and renamed: a restore may hold the old file of
        # this step mapped, which truncating it in place would break
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
    dist_util.barrier(shard)
    return path


def load_model_weights(path: str, model, strict: bool = True
                       ) -> Dict[str, Any]:
    """Load the model's weights from a checkpoint of ``save_checkpoint``
    or a bare state_dict; returns what the file held. Without
    ``strict``, weights the file lacks keep their values and names the
    model lacks are ignored (shapes must still agree)."""
    dev = model.embedding_group.device
    if model.embedding_group.engine.shard is not None:
        # each rank copies its own rows out of the mapped file
        ckpt = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    else:
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
    dev = model.embedding_group.device
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
    dev = model.embedding_group.device
    if tx is not None and (strict or "dense_opt" in ckpt):
        tx.load_state_dict(_to_device(ckpt["dense_opt"], dev))
    eg = model.embedding_group
    if eg.spill is not None and "zch_spill" in ckpt:
        eg.load_spill_state_dict({
            t: {k: v.cpu().numpy() for k, v in part.items()}
            for t, part in ckpt["zch_spill"].items()})
    if strict or "sparse_opt" in ckpt:
        sparse_opt = eg.load_opt_state_dict(ckpt["sparse_opt"])
    else:
        sparse_opt = eg.init_opt_state()
    return {"sparse_opt": sparse_opt, "step": int(ckpt.get("step", 0)),
            "epoch": int(ckpt.get("epoch", 0)),
            "dataloader_state": {int(k): int(v) for k, v in
                                 ckpt.get("dataloader_state", {}).items()},
            **{k: _to_device(ckpt[k], dev) for k in _OPTIONAL_STATE
               if k in ckpt}}


def _to_device(x, dev):
    """Tensors of a nested list or dict copied to ``dev`` (never views of
    a mapped checkpoint file)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    return x


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
        shard=None,
    ) -> None:
        self.model_dir = model_dir
        self._shard = shard
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
        if not self._keep_max or not dist_util.is_main_process(self._shard):
            return
        steps = list_checkpoints(self.model_dir)
        while len(steps) > self._keep_max:
            os.remove(checkpoint_path(self.model_dir, steps.pop(0)))
