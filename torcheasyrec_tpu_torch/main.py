"""Entry points: build a model from its pipeline config, train, evaluate,
predict.

Counterpart of torcheasyrec_tpu/main.py (``_create_features``,
``_compute_dtype``, ``_build_model_and_optim``, ``_init_state``,
``make_train_step``, ``make_eval_step``, a reduced ``train_and_evaluate``
and ``predict_checkpoint``). Entry points take ``device`` (default
``"cuda"``) and raise when CUDA is absent unless the caller asked for
``"cpu"``.

PyTorch updates in place, so the train state is not a pytree threaded
through the step: the dense parameters and the tables live in the model,
the dense optimizer holds its own state, and ``state`` carries the sparse
optimizer state and the step counter. Not ported, and raising where a
config asks for them: the FP16 grad scaler, gradient accumulation,
gradient clipping, the multi-step scan dispatch, ZCH and host-offloaded
tables, train metrics, the eval loop, resume and fine-tune restore, and
the JAX package's data loaders (the trainer reads parquet directly).
"""

import glob
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.models import create_model
from torcheasyrec_tpu_torch.models.model import BaseModel
from torcheasyrec_tpu_torch.optim.optimizer_builder import (
    DenseOptimizer,
    create_dense_optimizer,
    create_sparse_optimizer,
)
from torcheasyrec_tpu_torch.utils import config_util


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def _create_features(pipeline_config):
    data_config = pipeline_config.data_config
    if data_config.WhichOneof("sampler") is not None:
        raise NotImplementedError("negative samplers are not ported")
    return create_features(
        list(pipeline_config.feature_configs),
        fg_mode=data_config.fg_mode,
        fg_encoded_multival_sep=data_config.fg_encoded_multival_sep or None,
    )


def _compute_dtype(train_config) -> torch.dtype:
    mp = (getattr(train_config, "mixed_precision", "") or "").upper()
    if mp == "BF16":
        return torch.bfloat16
    if mp == "FP16":
        raise NotImplementedError("FP16 mixed precision is not ported")
    return torch.float32


def _build_model_and_optim(pipeline_config, device="cuda", for_train=True,
                           seed: int = 42):
    """(model on ``device``, features, sparse lr schedule). Weights are
    drawn from a ``torch.Generator`` seeded with ``seed``; the same
    generator later draws the dropout masks. With ``for_train`` the
    config's sparse optimizer is built into the model's embedding engine
    and the model is left in training mode; without, the model is in eval
    mode and the schedule is None."""
    dev = resolve_device(device)
    features = _create_features(pipeline_config)
    train_config = pipeline_config.train_config
    sparse_opt = sparse_sched = None
    if for_train:
        sparse_opt, sparse_sched = create_sparse_optimizer(
            train_config.sparse_optimizer)
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


def make_eval_step(model: BaseModel) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """batch on the model's device -> predictions (no losses)."""

    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return model(batch)

    return eval_step


def _iter_parquet(paths: List[str], batch_size: int):
    import pyarrow.parquet as pq

    for path in paths:
        for rb in pq.ParquetFile(path).iter_batches(batch_size=batch_size):
            yield {name: rb.column(i) for i, name in enumerate(rb.schema.names)}


def _iter_train_batches(paths: List[str], batch_size: int):
    """Full batches of every file in turn; the remainder of each file is
    dropped, as the JAX package's train mode does."""
    for cols in _iter_parquet(paths, batch_size):
        if len(next(iter(cols.values()))) == batch_size:
            yield cols


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The ``model.ckpt-<step>.pt`` of the highest step in ``model_dir``."""
    best, best_step = None, -1
    for path in glob.glob(os.path.join(model_dir, "model.ckpt-*.pt")):
        m = re.search(r"model\.ckpt-(\d+)\.pt$", path)
        if m and int(m.group(1)) > best_step:
            best, best_step = path, int(m.group(1))
    return best


def train_and_evaluate(
    pipeline_config_path: str,
    train_input_path: Optional[str] = None,
    eval_input_path: Optional[str] = None,
    continue_train: bool = False,
    fine_tune_checkpoint: Optional[str] = None,
    edit_config_json: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """Train from parquet input and write one checkpoint.

    Reads ``train_input_path`` (one parquet file or a comma-separated
    list) in batches of ``data_config.batch_size``,
    dropping the remainder, for ``train_config.num_steps`` steps (or
    ``num_epochs`` passes) on ``device``, then writes
    ``<model_dir>/model.ckpt-<step>.pt`` with ``torch.save``: the model's
    ``state_dict``, the sparse and dense optimizer state and the step.
    ``predict_checkpoint`` loads that file. Returns the step count and
    the last step's losses. The eval loop is not ported
    (``eval_input_path`` is accepted and unused); resume, fine-tune and
    config edits raise."""
    if continue_train or fine_tune_checkpoint or edit_config_json:
        raise NotImplementedError(
            "continue_train, fine_tune_checkpoint and edit_config_json are "
            "not ported")
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if train_input_path:
        pipeline_config.train_input_path = train_input_path
    train_config = pipeline_config.train_config
    for field, what in (("grad_scaler", "the FP16 grad scaler"),
                        ("grad_clipping", "gradient clipping"),
                        ("fine_tune_checkpoint", "fine-tune restore")):
        if train_config.HasField(field):
            raise NotImplementedError(f"{what} is not ported")
    if (train_config.gradient_accumulation_steps or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    if (train_config.steps_per_dispatch or 1) > 1:
        raise NotImplementedError("the multi-step dispatch is not ported")

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    dev = resolve_device(device)
    model, features, sparse_sched = _build_model_and_optim(
        pipeline_config, dev, for_train=True)
    tx, dense_sched = create_dense_optimizer(
        train_config.dense_optimizer,
        [p for p in model.parameters() if p.requires_grad])
    state = _init_state(model)
    train_step = make_train_step(model, tx, sparse_sched, dense_sched)
    parser = DataParser(
        features, labels=list(pipeline_config.data_config.label_fields))
    batch_size = int(pipeline_config.data_config.batch_size)
    paths = pipeline_config.train_input_path.split(",")

    num_steps = train_config.num_steps or 0
    num_epochs = train_config.num_epochs or (1 if not num_steps else 10 ** 9)
    metrics: Dict[str, torch.Tensor] = {}
    for epoch in range(num_epochs):
        state["epoch"] = epoch
        before = state["step"]
        for cols in _iter_train_batches(paths, batch_size):
            batch = parser.parse_to_batch(cols).to(dev)
            state, metrics = train_step(state, batch)
            if num_steps and state["step"] >= num_steps:
                break
        if (num_steps and state["step"] >= num_steps) or (
                state["step"] == before):  # done, or the input is empty
            break

    model_dir = pipeline_config.model_dir
    os.makedirs(model_dir, exist_ok=True)
    from google.protobuf import text_format

    with open(os.path.join(model_dir, "pipeline.config"), "w") as f:
        f.write(text_format.MessageToString(pipeline_config))
    torch.save(
        {"model": model.state_dict(), "sparse_opt": state["sparse_opt"],
         "dense_opt": tx.state_dict(), "step": state["step"]},
        os.path.join(model_dir, f"model.ckpt-{state['step']}.pt"),
    )
    result = {"step": float(state["step"])}
    result.update({k: float(v) for k, v in metrics.items()})
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
    """Batch inference over parquet input; writes ``probs_*`` and
    ``logits_*`` (plus reserved input columns) to a parquet file.

    ``checkpoint_path`` is a file written by ``train_and_evaluate``, or a
    bare state_dict saved with ``torch.save`` (for example
    ``utils/convert.from_jax_state``'s output). Without one, the latest
    ``model.ckpt-<step>.pt`` of the config's ``model_dir`` is taken, and
    where there is none the model runs from its seeded init.
    ``predict_input_path`` is one parquet file or a comma-separated list.
    Returns the rows predicted.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    bs = int(batch_size or pipeline_config.data_config.batch_size)
    model, features = build_model(pipeline_config, dev)
    checkpoint_path = checkpoint_path or latest_checkpoint(
        pipeline_config.model_dir)
    if checkpoint_path:
        ckpt = torch.load(checkpoint_path, map_location=dev,
                          weights_only=True)
        model.load_state_dict(ckpt.get("model", ckpt))
    elif glob.glob(os.path.join(pipeline_config.model_dir, "model.ckpt-*")):
        raise NotImplementedError(
            f"{pipeline_config.model_dir} holds JAX checkpoints; convert "
            "them with utils/convert.from_jax_state and pass checkpoint_path"
        )
    parser = DataParser(features)
    eval_step = make_eval_step(model)
    reserved = [c.strip() for c in (reserved_columns or "").split(",")
                if c.strip()]
    out_cols = [c.strip() for c in (output_columns or "").split(",")
                if c.strip()]
    writer = None
    n = 0
    try:
        for cols in _iter_parquet(predict_input_path.split(","), bs):
            preds = eval_step(parser.parse_to_batch(cols).to(dev))
            out: Dict[str, pa.Array] = {k: cols[k] for k in reserved}
            for k, v in preds.items():
                if k.startswith("__") or (out_cols and k not in out_cols):
                    continue
                v = v.float().cpu().numpy()
                out[k] = pa.array(v) if v.ndim == 1 else pa.array(list(v))
            table = pa.table(out)
            if writer is None:
                writer = pq.ParquetWriter(predict_output_path, table.schema)
            writer.write_table(table)
            n += len(next(iter(cols.values())))
    finally:
        if writer is not None:
            writer.close()
    return n
