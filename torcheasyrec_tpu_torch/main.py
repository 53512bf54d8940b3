"""Entry points: build a model from its pipeline config, evaluate, predict.

Counterpart of the serving half of torcheasyrec_tpu/main.py
(``_create_features``, ``_compute_dtype``, the model half of
``_build_model_and_optim``, ``make_eval_step`` and ``predict_checkpoint``).
Entry points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asked for ``"cpu"``. Training, evaluation
metrics, export and the JAX package's data loaders arrive later.
"""

import glob
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.models import create_model
from torcheasyrec_tpu_torch.models.model import BaseModel
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


def build_model(pipeline_config, device="cuda",
                seed: int = 42) -> Tuple[BaseModel, list]:
    """(model in eval mode on ``device``, features). Weights are drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    features = _create_features(pipeline_config)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    model = create_model(
        pipeline_config.model_config,
        features,
        list(pipeline_config.data_config.label_fields),
        list(pipeline_config.data_config.sample_weight_fields),
        compute_dtype=_compute_dtype(pipeline_config.train_config),
        generator=generator,
    )
    return model.eval(), features


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

    ``checkpoint_path`` is a state_dict saved with ``torch.save`` (for
    example ``utils/convert.from_jax_state``'s output); without one the
    model runs from its seeded init. ``predict_input_path`` is one
    parquet file or a comma-separated list. Returns the rows predicted.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    bs = int(batch_size or pipeline_config.data_config.batch_size)
    model, features = build_model(pipeline_config, dev)
    if checkpoint_path:
        model.load_state_dict(
            torch.load(checkpoint_path, map_location=dev, weights_only=True)
        )
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
