"""Entry points: build a model from its pipeline config, train, evaluate,
predict.

Counterpart of torcheasyrec_tpu/main.py (``_create_features``,
``_compute_dtype``, ``_build_model_and_optim``, ``_init_state``,
``make_train_step``, ``make_eval_step``, ``train_and_evaluate`` on one
device, ``_run_eval``, ``evaluate`` and ``predict_checkpoint``). Entry
points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asked for ``"cpu"``. Every entry point reads
its input through the dataloader of ``datasets/dataset.py``.

PyTorch updates in place, so the train state is not a pytree threaded
through the step: the dense parameters and the tables live in the model,
the dense optimizer holds its own state, and ``state`` carries the sparse
optimizer state, the step and the epoch. Not ported, and raising where a
config asks for them: the FP16 grad scaler, gradient accumulation,
gradient clipping, the multi-step scan dispatch, ZCH and host-offloaded
tables. Train metrics are not computed.
"""

import glob
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from torcheasyrec_tpu_torch.datasets.dataset import (
    create_dataloader,
    create_writer,
)
from torcheasyrec_tpu_torch.datasets.parquet_dataset import _expand_paths
from torcheasyrec_tpu_torch.datasets.utils import Batch, BatchInfo
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.models import create_model
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    DenseOptimizer,
    create_dense_optimizer,
    create_sparse_optimizer,
)
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

logger = logging.getLogger("tzrec_tpu_torch")


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def _create_features(pipeline_config):
    """The config's features; with a negative sampler, those it appends
    to (its ``attr_fields``, else its ``item_id_field``) and the item-side
    ones join ``NEG_DATA_GROUP``."""
    data_config = pipeline_config.data_config
    neg_fields = None
    sampler_type = data_config.WhichOneof("sampler")
    if sampler_type is not None:
        sampler_cfg = getattr(data_config, sampler_type)
        neg_fields = list(sampler_cfg.attr_fields) or [
            sampler_cfg.item_id_field]
    return create_features(
        list(pipeline_config.feature_configs),
        fg_mode=data_config.fg_mode,
        fg_encoded_multival_sep=data_config.fg_encoded_multival_sep or None,
        neg_fields=neg_fields,
    )


def _compute_dtype(train_config) -> torch.dtype:
    mp = (getattr(train_config, "mixed_precision", "") or "").upper()
    if mp == "BF16":
        return torch.bfloat16
    if mp == "FP16":
        raise NotImplementedError("FP16 mixed precision is not ported")
    return torch.float32


def _build_model_and_optim(pipeline_config, device="cuda", for_train=True,
                           seed: int = 42, packed: bool = True,
                           dense_lane_rows: int = 32768):
    """(model on ``device``, features, sparse lr schedule). Weights are
    drawn from a ``torch.Generator`` seeded with ``seed``; the same
    generator later draws the dropout masks. With ``for_train`` the
    config's sparse optimizer is built into the model's embedding engine
    and the model is left in training mode; without, the model is in eval
    mode, its engine keeps no optimizer row state and the schedule is
    None. ``packed`` and ``dense_lane_rows`` go to the embedding engine
    (``parallel/emb_engine.py``)."""
    dev = resolve_device(device)
    features = _create_features(pipeline_config)
    train_config = pipeline_config.train_config
    if for_train:
        sparse_opt, sparse_sched = create_sparse_optimizer(
            train_config.sparse_optimizer)
    else:
        # no optimizer row state: packed rows hold weights only
        sparse_opt, sparse_sched = SparseOptimizer("sgd", {"lr": 0.0}), None
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    model = create_model(
        pipeline_config.model_config,
        features,
        list(pipeline_config.data_config.label_fields),
        list(pipeline_config.data_config.sample_weight_fields),
        compute_dtype=_compute_dtype(train_config),
        generator=generator,
        sparse_optimizer=sparse_opt,
        packed=packed,
        dense_lane_rows=dense_lane_rows,
    )
    return model.train(for_train), features, sparse_sched


def build_model(pipeline_config, device="cuda",
                seed: int = 42) -> Tuple[BaseModel, list]:
    """(model in eval mode on ``device``, features), for eval and predict."""
    model, features, _ = _build_model_and_optim(
        pipeline_config, device, for_train=False, seed=seed)
    return model, features


def _init_state(model: BaseModel) -> Dict[str, Any]:
    """The train state beside the model: the sparse optimizer state of
    every embedding group, and the step counter."""
    return {"sparse_opt": model.embedding_group.init_opt_state(), "step": 0}


def make_train_step(model: BaseModel, tx: DenseOptimizer, sparse_sched,
                    dense_sched, grad_accum_steps: int = 1,
                    grad_scaler_cfg=None):
    """train_step(state, batch) -> (state, metrics). One step: embedding
    lookup; forward and loss in the model's compute dtype; gradients for
    the dense parameters and for the looked-up embedding rows (never a
    dense table gradient); the fused sparse update of the touched rows
    with the sparse schedule's multiplier; the dense update with the
    dense schedule's multiplier; step + 1. ``metrics`` holds
    ``total_loss`` and the per-task losses as detached scalars."""
    if grad_accum_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    if grad_scaler_cfg is not None:
        raise NotImplementedError("the FP16 grad scaler is not ported")
    eg = model.embedding_group
    params = tx.params

    def train_step(state: Dict[str, Any], batch: Batch):
        model.train()
        step, epoch = state["step"], state.get("epoch")
        with torch.no_grad():
            emb_out, residuals = eg.lookup(batch)
        keys = list(emb_out)
        leaves = [emb_out[k].requires_grad_(True) for k in keys]
        grouped = eg.assemble(dict(zip(keys, leaves)), batch,
                              model.compute_dtype)
        preds = model.predict(grouped, batch)
        losses = model.loss(preds, batch)
        total = model.total_loss(losses)
        grads = torch.autograd.grad(total, list(params) + leaves,
                                    allow_unused=True)
        dgrads = grads[:len(params)]
        # an output the loss does not reach has a zero gradient, which
        # still moves the moments of adam-like sparse optimizers
        emb_grads = {
            k: torch.zeros_like(leaf) if g is None else g
            for k, leaf, g in zip(keys, leaves, grads[len(params):])
        }
        by_epoch = sparse_sched.get("by_epoch") and epoch is not None
        lr_scale = sparse_sched["fn"](epoch if by_epoch else step)
        eg.engine.update(eg.engine_tables(), state["sparse_opt"], residuals,
                         emb_grads, lr_scale)
        tx.step(dgrads, dense_sched["fn"](step, epoch))
        state["step"] = step + 1
        metrics = {"total_loss": total.detach()}
        metrics.update({k: v.detach() for k, v in losses.items()})
        return state, metrics

    return train_step


def make_eval_step(model: BaseModel, with_loss: bool = True
                   ) -> Callable[[Batch], Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]]:
    """batch on the model's device -> (predictions, losses); the losses
    are empty without ``with_loss`` (predict has no labels)."""

    def eval_step(batch: Batch):
        model.eval()
        with torch.inference_mode():
            preds = model(batch)
            losses = model.loss(preds, batch) if with_loss else {}
        return preds, losses

    return eval_step


def train_epoch(
    train_step,
    state: Dict[str, Any],
    batches: Iterable[Tuple[Batch, BatchInfo]],
    dataloader_state: Dict[int, int],
    num_steps: int = 0,
    after_step: Optional[Callable[[Dict[str, Any], BatchInfo], None]] = None,
    log_every: int = 0,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor], bool]:
    """The body of the training loop over one epoch's (batch, info)
    items: a train step per batch, the dataloader watermark
    (``dataloader_state``, {source_id: last row consumed}) raised to the
    batch's ``checkpoint_info``, a log line every ``log_every`` steps,
    then ``after_step(state, info)``. Stops after step ``num_steps``
    (when > 0). Returns (state, the last step's metrics, whether it
    stopped at ``num_steps``). Writes nothing itself."""
    metrics: Dict[str, torch.Tensor] = {}
    t0, examples = time.perf_counter(), 0
    for batch, info in batches:
        state, metrics = train_step(state, batch)
        examples += info.batch_size
        for sid, row in info.checkpoint_info.items():
            dataloader_state[sid] = max(dataloader_state.get(sid, -1), row)
        step = state["step"]
        if log_every and step % log_every == 0:
            rate = examples / max(time.perf_counter() - t0, 1e-9)
            losses = " ".join(f"{k}={float(v):.5f}"
                              for k, v in metrics.items())
            logger.info(f"step {step}: {losses} ({rate:.0f} ex/s)")
        if after_step is not None:
            after_step(state, info)
        if num_steps and step >= num_steps:
            return state, metrics, True
    return state, metrics, False


def _run_eval(model: BaseModel, eval_step, eval_dl, num_steps: int = 0,
              model_dir: Optional[str] = None, step: int = 0
              ) -> Dict[str, float]:
    """One pass over the eval loader (``num_steps`` > 0 stops early):
    the model's metrics, and every loss averaged over the batches as
    ``loss_<name>``. Batch N-1's metrics are updated on the host while
    batch N computes on the device. With ``model_dir``, the result is
    appended to ``<model_dir>/train_eval_result_v2.txt`` as a
    ``{"global_step": step, ...}`` line."""
    metrics = model.init_metrics()
    loss_sums: Dict[str, float] = {}
    n = 0

    def _drain(pending) -> None:
        preds, losses, batch = pending
        model.update_metrics(metrics, preds, batch)
        for k, v in losses.items():
            loss_sums[k] = loss_sums.get(k, 0.0) + float(v)

    pending = None
    batches = eval_dl()
    try:
        for batch, _ in batches:
            preds, losses = eval_step(batch)
            if pending is not None:
                _drain(pending)
            pending = (preds, losses, batch)
            n += 1
            if num_steps and n >= num_steps:
                break
    finally:
        batches.close()
    if pending is not None:
        _drain(pending)
    result = model.compute_metrics(metrics)
    result.update({f"loss_{k}": v / max(n, 1) for k, v in loss_sums.items()})
    if model_dir:
        with open(os.path.join(model_dir, "train_eval_result_v2.txt"),
                  "a") as f:
            f.write(json.dumps({"global_step": step, **result}) + "\n")
    logger.info(f"eval @ step {step}: {result}")
    return result


def _check_train_options(train_config) -> None:
    for field, what in (("grad_scaler", "the FP16 grad scaler"),
                        ("grad_clipping", "gradient clipping")):
        if train_config.HasField(field):
            raise NotImplementedError(f"{what} is not ported")
    if (train_config.gradient_accumulation_steps or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    if (train_config.steps_per_dispatch or 1) > 1:
        raise NotImplementedError("the multi-step dispatch is not ported")


def _eval_input(pipeline_config, explicit: bool) -> Optional[str]:
    """The eval input of ``train_and_evaluate``: the config's
    ``eval_input_path`` (files, directories, globs) when it names files
    that exist. Where it does not, an explicit argument raises; a path
    from the config is skipped with a warning, as before directories and
    globs were read."""
    path = pipeline_config.eval_input_path
    if not path:
        return None
    try:
        missing = [p for p in _expand_paths(path) if not os.path.exists(p)]
    except FileNotFoundError:
        missing = [path]
    if not missing:
        return path
    if explicit:
        raise FileNotFoundError(f"eval_input_path: {missing} not found")
    logger.warning(f"eval_input_path {path}: {missing} not found; no eval")
    return None


def train_and_evaluate(
    pipeline_config_path: str,
    train_input_path: Optional[str] = None,
    eval_input_path: Optional[str] = None,
    continue_train: bool = False,
    fine_tune_checkpoint: Optional[str] = None,
    edit_config_json: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """Train from parquet input with checkpoints and evals; returns the
    step count, the last step's losses and the last eval's result.

    ``edit_config_json`` ({path: value}, ``config_util.edit_config``) is
    applied first. The input paths (files, directories, globs, comma
    lists) default to the config's. Trains for ``train_config.num_steps``
    steps (or ``num_epochs`` passes) on ``device`` through the
    dataloader (remainder dropped, ``shuffle`` and ``num_workers`` as
    ``data_config`` says). Saves ``<model_dir>/model.ckpt-<step>.pt``
    every ``save_checkpoints_steps`` steps, after every
    ``save_checkpoints_epochs`` epochs and at the end, keeping the last
    ``keep_checkpoint_max``; each save is followed by an eval on the eval
    input (where there is one; see ``_eval_input``), which appends a line
    to ``<model_dir>/train_eval_result_v2.txt``. ``continue_train``
    resumes from the latest checkpoint of ``model_dir``: weights,
    optimizer states, step, epoch, and the rows of that epoch already
    consumed. ``fine_tune_checkpoint`` (else the config's) starts from a
    checkpoint or a bare state_dict, restoring what it holds."""
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if edit_config_json:
        config_util.edit_config(pipeline_config, json.loads(edit_config_json))
    if train_input_path:
        pipeline_config.train_input_path = train_input_path
    if eval_input_path:
        pipeline_config.eval_input_path = eval_input_path
    train_config = pipeline_config.train_config
    data_config = pipeline_config.data_config
    _check_train_options(train_config)
    eval_path = _eval_input(pipeline_config, bool(eval_input_path))

    dev = resolve_device(device)
    model, features, sparse_sched = _build_model_and_optim(
        pipeline_config, dev, for_train=True)
    tx, dense_sched = create_dense_optimizer(
        train_config.dense_optimizer,
        [p for p in model.parameters() if p.requires_grad])
    state = _init_state(model)
    state["epoch"] = 0
    model_dir = pipeline_config.model_dir
    ckpt_manager = checkpoint_util.CheckpointManager(
        model_dir,
        save_checkpoints_steps=train_config.save_checkpoints_steps,
        save_checkpoints_epochs=train_config.save_checkpoints_epochs,
        keep_checkpoint_max=train_config.keep_checkpoint_max,
        save_checkpoints_timestamp_interval=(
            train_config.save_checkpoints_timestamp_interval),
        save_checkpoints_timestamps=list(
            train_config.save_checkpoints_timestamps),
    )
    dataloader_state: Dict[int, int] = {}
    latest = checkpoint_util.latest_checkpoint(model_dir)
    resumed = bool(continue_train and latest)
    fine_tune = fine_tune_checkpoint or train_config.fine_tune_checkpoint
    if resumed or fine_tune:
        restored = checkpoint_util.restore_checkpoint(
            latest if resumed else fine_tune, model, tx, strict=resumed)
        if resumed:
            dataloader_state = restored["dataloader_state"]
        del restored["dataloader_state"]
        state.update(restored)
    from google.protobuf import text_format

    with open(os.path.join(model_dir, "pipeline.config"), "w") as f:
        f.write(text_format.MessageToString(pipeline_config))

    train_dl = create_dataloader(
        data_config, features, pipeline_config.train_input_path,
        mode="train", resume_state=dataloader_state, device=dev)
    eval_dl = None
    if eval_path:
        eval_dl = create_dataloader(data_config, features, eval_path,
                                    mode="eval", device=dev)
    train_step = make_train_step(model, tx, sparse_sched, dense_sched)
    eval_step = make_eval_step(model)
    eval_result: Dict[str, float] = {}

    def save_and_eval() -> None:
        nonlocal eval_result
        ckpt_manager.save(model, tx, state, dataloader_state)
        if eval_dl is not None:
            eval_result = _run_eval(
                model, eval_step, eval_dl,
                pipeline_config.eval_config.num_steps or 0, model_dir,
                state["step"])

    def after_step(state, info: BatchInfo) -> None:
        if ckpt_manager.should_save(state["step"],
                                    data_timestamp=info.data_timestamp):
            save_and_eval()

    num_steps = train_config.num_steps or 0
    num_epochs = train_config.num_epochs or (1 if not num_steps else 10 ** 9)
    # a resume continues the epoch its checkpoint was taken in
    start_epoch = min(state["epoch"], max(num_epochs - 1, 0)) if resumed else 0
    metrics: Dict[str, torch.Tensor] = {}
    for epoch in range(start_epoch, num_epochs):
        if epoch > start_epoch:
            # the positions belong to one pass: the next replays all rows
            dataloader_state.clear()
        state["epoch"] = epoch
        before = state["step"]
        batches = train_dl()
        try:
            state, epoch_metrics, stop = train_epoch(
                train_step, state, batches, dataloader_state, num_steps,
                after_step, train_config.log_step_count_steps)
        finally:
            batches.close()
        metrics = epoch_metrics or metrics
        # done, or the input is empty (a resumed epoch may have no rows
        # left: the next one replays them all)
        if stop or (state["step"] == before
                    and not (resumed and epoch == start_epoch)):
            break
        if train_config.save_checkpoints_epochs and (
                (epoch + 1) % train_config.save_checkpoints_epochs == 0):
            save_and_eval()

    save_and_eval()
    result = {"step": float(state["step"])}
    result.update({k: float(v) for k, v in metrics.items()})
    result.update(eval_result)
    return result


def evaluate(
    pipeline_config_path: str,
    checkpoint_path: Optional[str] = None,
    eval_input_path: Optional[str] = None,
    eval_result_filename: str = "eval_result.txt",
    device="cuda",
) -> Dict[str, float]:
    """Evaluate a checkpoint (``checkpoint_path``, else the latest of the
    config's ``model_dir``, else the seeded init) on ``eval_input_path``
    (else the config's; files, directories, globs) in batches of
    ``eval_batch_size`` (else ``batch_size``); writes the result as JSON
    to ``<model_dir>/<eval_result_filename>`` and returns it."""
    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if eval_input_path:
        pipeline_config.eval_input_path = eval_input_path
    model_dir = pipeline_config.model_dir
    model, features = build_model(pipeline_config, dev)
    ckpt = checkpoint_path or checkpoint_util.latest_checkpoint(model_dir)
    step = 0
    if ckpt:
        step = int(checkpoint_util.load_model_weights(ckpt, model).get(
            "step", 0))
    eval_dl = create_dataloader(
        pipeline_config.data_config, features,
        pipeline_config.eval_input_path, mode="eval", device=dev)
    result = _run_eval(model, make_eval_step(model), eval_dl,
                       pipeline_config.eval_config.num_steps or 0, None, step)
    if model_dir:
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, eval_result_filename), "w") as f:
            f.write(json.dumps(result))
    return result


def predict_checkpoint(
    pipeline_config_path: str,
    predict_input_path: str,
    predict_output_path: str,
    checkpoint_path: Optional[str] = None,
    reserved_columns: Optional[str] = None,
    output_columns: Optional[str] = None,
    batch_size: Optional[int] = None,
    device="cuda",
) -> int:
    """Batch inference over parquet input (files, directories, globs);
    writes ``probs_*`` and ``logits_*`` (after the ``reserved_columns`` of
    the input, carried through unchanged) to ``predict_output_path`` (a
    ``.parquet`` file, else ``<path>/part-0.parquet``).

    ``checkpoint_path`` is a file written by ``train_and_evaluate``, or a
    bare state_dict saved with ``torch.save`` (for example
    ``utils/convert.from_jax_state``'s output). Without one, the latest
    ``model.ckpt-<step>.pt`` of the config's ``model_dir`` is taken, and
    where there is none the model runs from its seeded init.
    ``batch_size`` replaces ``data_config.batch_size`` (as in the JAX
    package, ``eval_batch_size`` takes precedence where set). Batches
    come from the predict-mode loader; a writer thread converts and
    writes batch N while batch N+1 computes. Returns the rows predicted.
    """
    import pyarrow as pa

    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if batch_size:
        pipeline_config.data_config.batch_size = batch_size
    model, features = build_model(pipeline_config, dev)
    checkpoint_path = checkpoint_path or checkpoint_util.latest_checkpoint(
        pipeline_config.model_dir)
    if checkpoint_path:
        checkpoint_util.load_model_weights(checkpoint_path, model)
    elif glob.glob(os.path.join(pipeline_config.model_dir, "model.ckpt-*")):
        raise NotImplementedError(
            f"{pipeline_config.model_dir} holds JAX checkpoints; convert "
            "them with utils/convert.from_jax_state and pass checkpoint_path"
        )
    reserved = [c.strip() for c in (reserved_columns or "").split(",")
                if c.strip()]
    out_cols = [c.strip() for c in (output_columns or "").split(",")
                if c.strip()]
    dl = create_dataloader(pipeline_config.data_config, features,
                           predict_input_path, mode="predict",
                           reserved_columns=reserved, device=dev)
    eval_step = make_eval_step(model, with_loss=False)

    def convert(preds, reserved_cols) -> Dict[str, pa.Array]:
        # the reserved input columns first, so predictions stay joinable
        out: Dict[str, pa.Array] = dict(reserved_cols)
        for k, v in preds.items():
            if k.startswith("__") or (out_cols and k not in out_cols):
                continue
            v = v.float().cpu().numpy()
            out[k] = pa.array(v) if v.ndim == 1 else pa.array(list(v))
        return out

    writer = _AsyncPredictWriter(
        create_writer(predict_output_path, "ParquetWriter"), convert)
    n = 0
    batches = dl()
    try:
        for batch, info in batches:
            preds, _ = eval_step(batch)
            writer.put(preds, info.reserved)
            n += info.batch_size
    finally:
        batches.close()
        writer.close()
    return n


class _AsyncPredictWriter:
    """Converts and writes predictions on a thread, so the device computes
    the next batch meanwhile; the bounded queue keeps at most ``maxsize``
    batches of predictions in flight. A failure in the thread is raised
    by the next ``put`` or by ``close``."""

    def __init__(self, writer, convert, maxsize: int = 4) -> None:
        import queue
        import threading

        self._writer = writer
        self._convert = convert
        self._q: Any = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain the rest after a failure
            try:
                self._writer.write(self._convert(*item))
            except BaseException as e:  # noqa: BLE001 - raised by put/close
                self._err = e

    def put(self, *item: Any) -> None:
        if self._err is not None:
            raise self._err
        self._q.put(item)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        try:
            self._writer.close()
        except BaseException:  # noqa: BLE001
            # a writer broken mid-write may fail to close as well; the
            # first failure is the one to raise
            if self._err is None:
                raise
        if self._err is not None:
            raise self._err
