"""Entry points: build a model from its pipeline config, train, evaluate,
predict.

Counterpart of torcheasyrec_tpu/main.py (``_create_features``,
``_compute_dtype``, ``_build_model_and_optim``, ``_init_state``,
``make_train_step``, ``make_eval_step``, ``train_and_evaluate`` on one
device, ``_run_eval``, ``evaluate``, ``predict_checkpoint``, ``export``
and the artifact ``predict``). Entry
points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asked for ``"cpu"``. Every entry point reads
its input through the dataloader of ``datasets/dataset.py``.

PyTorch updates in place, so the train state is not a pytree threaded
through the step: the dense parameters and the tables live in the model,
the dense optimizer holds its own state, and ``state`` carries the sparse
optimizer state, the step and the epoch, and where the config asks for
them the accumulated dense gradients and the grad scaler's state. The
train config's options: ``mixed_precision`` BF16 or FP16, the grad
scaler (FP16 only), gradient clipping, gradient accumulation, per-part
dense optimizers, train metrics, ``is_profiling``, the delta
embedding dump (``utils/delta_embedding_dump.py``) and TensorBoard
summaries (``use_tensorboard``, default on: ``<model_dir>/tb``, the
losses and the sparse learning rate every ``log_step_count_steps``
steps, the last eval at the end; ``utils/summary_util.py``);
``steps_per_dispatch`` > 1 runs as single steps, with a warning.

Two overlaps, each the same numbers as the loop without it: over
several ranks, ``sparse_dist_overlap`` exchanges the next batch's
embedding ids with their owners while the step runs
(``EmbeddingGroup.stage_route``; the TrainPipelineSparseDist analogue),
on where the ranks are more than one and no table is host-offloaded,
else the loop runs unpipelined with a warning; with host-offloaded
tables the next batch's rows are gathered on a thread while the step
runs and repaired after its host update (``_HostRowPrefetcher``; on
unless ``TZREC_HOST_PREFETCH=0``). The loop then hands each step the
next batch (``_paired``). A staged route is never saved, and dropped at
an epoch's end; the evals are not pipelined.

ZCH and dynamic embeddings: the train step remaps the raw ids
of ``zch``/``dynamicemb`` features before the lookup at the state's
step (``EmbeddingGroup.remap_zch``), gathers the rows that the remap
evicted from spill tables before the sparse update writes the tables in
place, and after the update stores them on the host and writes back the
rows of readmitted keys, before the next step. Eval, predict and the
serving program remap read-only. Host-offloaded tables: the step gathers
the batch's rows on the host from the loader's host copy of its ids,
into page-locked memory, and applies their row gradients on the host.
Over several ranks the train remap runs on the global batch (every rank
advances the same mappings; ``modules/embedding.py``), the spill stores
are per rank, and host-offloaded tables are refused, as in the JAX
package.

Several ranks (``torch.distributed.run --nproc_per_node N``, or a
``shard`` the caller made with ``utils/dist_util.init_distributed``):
the model is built twice, first for its table specs, then with the
planner's plan (``parallel/planner.py``; ``sharding_plan.json`` in the
model dir, reloaded by ``continue_train``); each rank reads input shard
``rank`` of ``world``; the train step averages the dense gradients over
the ranks (one bucketed ``all_reduce``) and scales the embedding
gradients by 1 / world, since each rank's loss is its share of the
global batch's mean (``models/model.BaseModel._reduce``); the ranks stop
together when one runs out of input; the eval runs the ranks in step
(a rank out of rows repeats its last batch without counting it) and
gathers the metrics; rank 0 writes canonical checkpoints, which load at
any world size and plan; the delta embedding dump writes, from rank 0,
the files of the global batch's touched rows. Export and predict run on
one rank only.

An export artifact holds the weights (``model/model.pt``), the
``pipeline.config``, ``fg.json`` and the serving program: a
``torch.export`` ``ExportedProgram`` of the eval forward over the flat
tensors of one batch, saved as ``predict_fn.pt2`` (a match model's
towers: ``<tower>/tower_fn.pt2``; TDM's node embedding:
``embedding/tower_fn.pt2``) beside ``serving_spec.json``. It is
traced at the static shapes of a mock batch of ``eval_batch_size`` (else
``batch_size``) rows, as the JAX package traces its StableHLO; a batch
of other shapes is refused by the program. The attention forward is the
operator ``torch.ops.tzrec_tpu_torch.hstu_attention_fwd`` in it, so the
program runs kernel #1 on the card; it loads only where
``torcheasyrec_tpu_torch.ops.hstu`` has been imported. ``predict``
itself rebuilds the model from the artifact's config and weights, as
the JAX package's does.
"""

import glob
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from torcheasyrec_tpu_torch.datasets.csv_dataset import expand_csv_paths
from torcheasyrec_tpu_torch.datasets.dataset import (
    _infer_type,
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
from torcheasyrec_tpu_torch.parallel import planner
from torcheasyrec_tpu_torch.parallel.emb_engine import HOST_OFFLOAD
from torcheasyrec_tpu_torch.parallel.mesh import ShardContext
from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer
from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util, dist_util
from torcheasyrec_tpu_torch.utils.convert import dense_param_paths
from torcheasyrec_tpu_torch.utils.delta_embedding_dump import (
    DeltaEmbeddingDumper,
)

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
        return torch.float16
    return torch.float32


def _build_model_and_optim(pipeline_config, device="cuda", for_train=True,
                           seed: int = 42, packed: bool = True,
                           dense_lane_rows: int = 32768,
                           shard: Optional[ShardContext] = None,
                           plan: Optional[Dict[str, str]] = None):
    """(model on ``device``, features, sparse lr schedule). Weights are
    drawn from a ``torch.Generator`` seeded with ``seed``; the same
    generator later draws the dropout masks. With ``for_train`` the
    config's sparse optimizer is built into the model's embedding engine
    and the model is left in training mode; without, the model is in eval
    mode, its engine keeps no optimizer row state and the schedule is
    None. ``packed`` and ``dense_lane_rows`` go to the embedding engine
    (``parallel/emb_engine.py``). With ``shard`` the model lives on the
    rank's device and its tables take their layouts from ``plan``, else
    (over several ranks) from the planner's plan of the table specs, as
    the JAX package's two-phase build does; ``model.sharding_plan`` holds
    it."""
    dev = shard.device if shard is not None else resolve_device(device)
    features = _create_features(pipeline_config)
    train_config = pipeline_config.train_config
    if for_train:
        sparse_opt, sparse_sched = create_sparse_optimizer(
            train_config.sparse_optimizer)
    else:
        # no optimizer row state: packed rows hold weights only
        sparse_opt, sparse_sched = SparseOptimizer("sgd", {"lr": 0.0}), None

    def build(plan_, build_tables=True):
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        return create_model(
            pipeline_config.model_config,
            features,
            list(pipeline_config.data_config.label_fields),
            list(pipeline_config.data_config.sample_weight_fields),
            compute_dtype=_compute_dtype(train_config),
            generator=generator,
            sparse_optimizer=sparse_opt,
            packed=packed,
            dense_lane_rows=dense_lane_rows,
            shard=shard, plan=plan_, build_tables=build_tables,
        )

    if shard is not None and plan is None and shard.world > 1:
        eg = build(None, build_tables=False).embedding_group
        plan = plan_tables(eg.table_specs(), shard, pipeline_config,
                           sparse_opt.kind, set(eg._zch_cfgs))
    model = build(plan)
    model.sharding_plan = plan
    model.attach_shard()
    return model.train(for_train), features, sparse_sched


def _dense_bf16(model: BaseModel, shard: Optional[ShardContext]) -> bool:
    """Whether the loader's wire carries dense features as bf16, as the
    JAX loop's ``_to_device`` packs them: on one rank under BF16; over
    ranks the JAX mesh path puts them as they are."""
    return ((shard is None or shard.world <= 1)
            and model.compute_dtype == torch.bfloat16)


def plan_tables(specs, shard: ShardContext, pipeline_config,
                optimizer_kind: str,
                host_excluded: Optional[set] = None) -> Dict[str, str]:
    """The planner's {table: layout} for ``specs`` over the ranks of
    ``shard``, its estimate logged. ``host_excluded`` (the ZCH tables,
    whose ids are remapped on the device) never go to the host tier,
    which the planner offers on one rank only. Where ranks share a card,
    each plans with its share of the card's memory (unless
    ``HBM_CAPACITY`` is set)."""
    spg = shard.local_world
    while shard.world % spg:
        spg -= 1
    hbm = None
    if (shard.device.type == "cuda" and "HBM_CAPACITY" not in os.environ
            and shard.local_world > torch.cuda.device_count()):
        hbm = (torch.cuda.get_device_properties(shard.device).total_memory
               * torch.cuda.device_count() / shard.local_world)
    plan, cost, _ = planner.plan_cost(
        specs, n_devices=shard.world,
        batch_size=int(pipeline_config.data_config.batch_size),
        optimizer_kind=optimizer_kind, shards_per_host=max(spg, 1),
        host_excluded=set(host_excluded or ()), hbm_budget=hbm)
    if dist_util.is_main_process(shard):
        logger.info(f"sharding plan over {shard.world} ranks "
                    f"(est {cost * 1e3:.3f} ms/step): {plan}")
    return plan


def build_model(pipeline_config, device="cuda", seed: int = 42,
                shard: Optional[ShardContext] = None,
                plan: Optional[Dict[str, str]] = None
                ) -> Tuple[BaseModel, list]:
    """(model in eval mode on ``device``, features), for eval and predict."""
    model, features, _ = _build_model_and_optim(
        pipeline_config, device, for_train=False, seed=seed, shard=shard,
        plan=plan)
    return model, features


def uses_grad_scaler(model: BaseModel, grad_scaler_cfg) -> bool:
    """The grad scaler runs only when the compute dtype is FP16; under
    BF16 or FP32 a ``grad_scaler`` block is ignored."""
    return (grad_scaler_cfg is not None
            and model.compute_dtype == torch.float16)


def _init_state(model: BaseModel, tx: Optional[DenseOptimizer] = None,
                grad_accum_steps: int = 1,
                grad_scaler_cfg=None) -> Dict[str, Any]:
    """The train state beside the model: the sparse optimizer state of
    every embedding group and the step counter; with
    ``grad_accum_steps`` > 1 the accumulated dense gradients (zeros, one
    per parameter of ``tx``); with the grad scaler (``uses_grad_scaler``)
    its ``scale`` (``init_scale``) and ``good_steps``, 0-d tensors on the
    model's device. A model with ZCH tables adds ``zch``, the mappings
    (``EmbeddingGroup.zch_states``: the model's buffers, which the train
    step advances in place)."""
    eg = model.embedding_group
    state = {"sparse_opt": eg.init_opt_state(), "step": 0}
    if eg.has_zch:
        state["zch"] = eg.zch_states()
    if grad_accum_steps > 1:
        state["accum_grads"] = [torch.zeros_like(p, dtype=torch.float32)
                                for p in tx.params]
    if uses_grad_scaler(model, grad_scaler_cfg):
        dev = eg.device
        state["scaler"] = {
            "scale": torch.tensor(float(grad_scaler_cfg.init_scale),
                                  device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev)}
    return state


def _dense_optimizer(model: BaseModel, train_config):
    """(DenseOptimizer, schedule) of the model's trainable parameters,
    with the config's part optimizers (matched against the parameters'
    JAX paths) and gradient clipping."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    paths = dense_param_paths(model)
    return create_dense_optimizer(
        train_config.dense_optimizer, [p for _, p in named],
        [paths[n] for n, _ in named],
        train_config.grad_clipping if train_config.HasField("grad_clipping")
        else None)


def make_train_step(model: BaseModel, tx: DenseOptimizer, sparse_sched,
                    dense_sched, grad_accum_steps: int = 1,
                    grad_scaler_cfg=None):
    """train_step(state, batch) -> (state, metrics). One step: embedding
    lookup; forward (the groups through ``build_input``'s variational
    dropout, whose ``<group>_feature_p_loss`` terms join the losses; the
    batch norms' running statistics move once) and loss in the model's
    compute dtype; gradients for
    the dense parameters and for the looked-up embedding rows (never a
    dense table gradient); the fused sparse update of the touched rows
    with the sparse schedule's multiplier; the dense update (through
    ``tx``'s clipping) with the dense schedule's multiplier; step + 1.
    ``metrics`` holds ``total_loss`` and the per-task losses as detached
    scalars, and ``__preds``, the detached predictions, where the model
    has train metrics.

    With the grad scaler (``uses_grad_scaler``) the loss is multiplied by
    ``state["scaler"]["scale"]`` and the gradients divided by it; if any
    dense or embedding gradient is not finite, all are zeroed, the sparse
    lr multiplier is 0 (the sparse optimizer still runs: adam-like
    moments decay) and the dense update is multiplied by 0 while the
    dense optimizer's state moves forward, as in the JAX package. The
    scale grows by ``growth_factor`` after ``growth_interval`` finite
    steps in a row and backs off by ``backoff_factor`` on a non-finite
    one. The flag and the scale stay on the device.

    With ``grad_accum_steps`` = k > 1 the sparse rows update at every
    step; the dense gradients add into ``state["accum_grads"]`` and their
    mean updates the parameters, and the dense optimizer's state, at
    steps where (step + 1) % k == 0 (with the scaler: and the step's
    gradients are finite; the sum then carries into the next window).

    Over several ranks (``model.shard``) each rank's loss is its share of
    the global batch's (their mean is the global loss): the dense
    gradients are averaged over the ranks in one ``all_reduce``, the
    embedding gradients are scaled by 1 / world before they travel to
    the rows' owners, the grad scaler's finite flag is the ranks' AND and
    the reported losses are the ranks' mean.

    ZCH: the batch's raw ids are remapped at ``state["step"]`` first (the
    mappings advance in place); the spill tables' evicted rows are
    gathered before the sparse update and handed to the host spill tier
    after it (``EmbeddingGroup.spill_step``), which writes readmitted
    keys' rows back. Host-offloaded tables: the step gathers the batch's
    rows on the host (``EmbeddingGroup.host_gather``).

    ``train_step(state, batch, next_batch)``: with the batch the loop
    will step on next, its work starts during this step. Host-offloaded
    tables: its rows are gathered on a thread (``_HostRowPrefetcher``),
    repaired after this step's host update. Several ranks: its owner
    routes are exchanged (``EmbeddingGroup.stage_route``) and kept as
    ``state["staged"]``, which the next step's lookup takes."""
    eg = model.embedding_group
    shard = model.shard
    params = tx.params
    use_scaler = uses_grad_scaler(model, grad_scaler_cfg)
    k_accum = max(int(grad_accum_steps or 1), 1)
    want_preds = bool(model.init_train_metrics())
    host_pipe = (_HostRowPrefetcher(eg) if eg.engine.has_host_groups
                 else None)

    def train_step(state: Dict[str, Any], batch: Batch,
                   next_batch: Optional[Batch] = None):
        model.train()
        step, epoch = state["step"], state.get("epoch")
        staged = state.pop("staged", None)
        host_rows = None
        if host_pipe is not None:
            host_rows = host_pipe.rows_for(batch)
        spill_rec = None
        if eg.has_zch:
            batch, spills = eg.remap_zch(batch, step, training=True,
                                         collect_spill=eg.has_host_spill)
            if spills:
                # the evicted keys' rows before this step's update
                spill_rec = eg.gather_spill_rows(spills)
        with torch.no_grad():
            emb_out, residuals = eg.lookup(batch, host_rows=host_rows,
                                           staged=staged)
        keys = list(emb_out)
        leaves = [emb_out[k].requires_grad_(True) for k in keys]
        grouped, vd_losses = model.build_input(
            eg.assemble(dict(zip(keys, leaves)), batch, model.compute_dtype),
            batch)
        preds = model.predict(grouped, batch)
        losses = model.loss(preds, batch)
        losses.update(vd_losses)
        total = model.total_loss(losses)
        scale = state["scaler"]["scale"] if use_scaler else None
        if total.requires_grad:
            grads = torch.autograd.grad(
                total if scale is None else total * scale,
                list(params) + leaves, allow_unused=True)
        else:
            # a loss that reaches no weight (RQ-KMeans' logged error)
            grads = [None] * (len(params) + len(leaves))
        if next_batch is not None:
            # the next batch's work starts once this step's device work is
            # queued, beside its first waits for the card (the gradients'
            # exchange, the host update): a thread that ran beside the
            # forward's launches would slow them
            if host_pipe is not None:
                host_pipe.start(next_batch)
            else:
                state["staged"] = eg.stage_route(next_batch)
        if scale is not None:
            inv = 1.0 / scale
            grads = [None if g is None else g * inv for g in grads]
        dgrads = list(grads[:len(params)])
        # an output the loss does not reach has a zero gradient, which
        # still moves the moments of adam-like sparse optimizers
        emb_grads = {
            k: torch.zeros_like(leaf) if g is None else g
            for k, leaf, g in zip(keys, leaves, grads[len(params):])
        }
        if shard is not None:
            dgrads = _mean_over_ranks(dgrads, shard)
            emb_grads = {k: g * (1.0 / shard.world)
                         for k, g in emb_grads.items()}
        by_epoch = sparse_sched.get("by_epoch") and epoch is not None
        lr_scale = sparse_sched["fn"](epoch if by_epoch else step)
        finite = None
        if scale is not None:
            finite = torch.stack([
                torch.isfinite(g).all()
                for g in dgrads + list(emb_grads.values()) if g is not None
            ]).all()
            if shard is not None:
                finite = shard.all_reduce(
                    finite.float(), op=torch.distributed.ReduceOp.MIN) > 0
            # zeroed, so that 0 * inf = NaN reaches no table or state
            zero = scale.new_zeros(())
            dgrads = [None if g is None else torch.where(finite, g, zero)
                      for g in dgrads]
            emb_grads = {k: torch.where(finite, g, zero.to(g.dtype))
                         for k, g in emb_grads.items()}
            lr_scale = torch.where(finite, scale.new_tensor(lr_scale), zero)
        eg.engine.update(eg.engine_tables(), state["sparse_opt"], residuals,
                         emb_grads, lr_scale)
        if host_pipe is not None:
            host_pipe.repair({gk: r[2] for gk, r in residuals.items()
                              if eg.engine.groups[gk].sharding
                              == HOST_OFFLOAD})
        if spill_rec is not None:
            eg.spill_step(spill_rec)
        mult = dense_sched["fn"](step, epoch)
        gate = None if finite is None else finite.float()
        if k_accum == 1:
            tx.step(dgrads, mult, gate=gate)
        else:
            accum = state["accum_grads"]
            for a, g in zip(accum, dgrads):
                if g is not None:
                    a.add_(g.float())
            if (step + 1) % k_accum == 0:
                tx.step([a / k_accum for a in accum], mult, gate=gate,
                        keep=finite)
                for a in accum:
                    if gate is None:
                        a.zero_()
                    else:
                        a.mul_(1.0 - gate)
        if scale is not None:
            state["scaler"] = _next_scaler_state(state["scaler"], finite,
                                                 grad_scaler_cfg)
        state["step"] = step + 1
        metrics = {"total_loss": total.detach()}
        metrics.update({k: v.detach() for k, v in losses.items()})
        if shard is not None:
            names = list(metrics)
            vals = shard.all_reduce(torch.stack(
                [metrics[n].float() for n in names])) / shard.world
            metrics = dict(zip(names, vals))
        if want_preds:
            metrics["__preds"] = {k: v.detach() for k, v in preds.items()
                                  if isinstance(v, torch.Tensor)}
        return state, metrics

    return train_step


class _HostRowPrefetcher:
    """The overlapped gather of host-offloaded rows, exact. The rows of
    the next batch are gathered on a thread while the step runs; after
    the step's host update, the rows of the ids that update touched are
    read again (``engine.host_refresh``): a row the thread read before or
    during the update is one of those, every other row was never
    written. So the rows equal a gather after the update, bit for bit.
    ``TZREC_HOST_PREFETCH=0`` turns it off (every step gathers its own
    rows)."""

    def __init__(self, eg) -> None:
        self.eg = eg
        self.enabled = os.environ.get("TZREC_HOST_PREFETCH", "1") != "0"
        self._thread: Optional[threading.Thread] = None
        self._batch: Optional[Batch] = None
        self._out: Optional[Dict[str, Any]] = None

    def start(self, batch: Optional[Batch]) -> None:
        """Begin gathering ``batch``'s rows on a thread."""
        if not self.enabled or batch is None:
            return

        def run():
            self._out = self.eg.host_gather(batch)

        self._batch, self._out = batch, None
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._out is None:  # the gather raised on its thread
                self._batch = None

    def repair(self, touched: Dict[str, torch.Tensor]) -> None:
        """After the host update of ids ``touched`` ({group: ids}): the
        prefetched rows of those ids read again."""
        self._join()
        if self._out is not None:
            self.eg.engine.host_refresh(self.eg.engine_tables(), self._out,
                                        touched)

    def rows_for(self, batch: Batch) -> Dict[str, Any]:
        """{host group: (rows, ids)} of ``batch``: the repaired prefetch
        where it was made for this batch, else a gather now."""
        self._join()
        if self._batch is batch and self._out is not None:
            out = self._out
        else:
            out = self.eg.host_gather(batch)
        self._batch, self._out = None, None
        return out


def _mean_over_ranks(grads: List[Optional[torch.Tensor]],
                     shard: ShardContext) -> List[Optional[torch.Tensor]]:
    """Each gradient averaged over the ranks, through one fp32 buffer and
    one ``all_reduce``; a None (no rank's loss reaches the parameter)
    stays None."""
    live = [g for g in grads if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.float().reshape(-1) for g in live])
    flat = shard.all_reduce(flat) / shard.world
    out, pos = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        n = g.numel()
        out.append(flat[pos:pos + n].view(g.shape).to(g.dtype))
        pos += n
    return out


def _next_scaler_state(sc: Dict[str, torch.Tensor], finite: torch.Tensor,
                       cfg) -> Dict[str, torch.Tensor]:
    """The grad scaler after a step whose gradients were ``finite`` (a
    0-d bool tensor): growth after ``growth_interval`` finite steps in a
    row, backoff on a non-finite one, on the device."""
    interval = int(cfg.growth_interval)
    good = torch.where(finite, sc["good_steps"] + 1,
                       sc["good_steps"].new_zeros(()))
    grown = good >= interval
    scale = torch.where(
        finite,
        torch.where(grown, sc["scale"] * float(cfg.growth_factor),
                    sc["scale"]),
        sc["scale"] * float(cfg.backoff_factor))
    return {"scale": scale,
            "good_steps": torch.where(grown, good.new_zeros(()), good)}


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
    model: Optional[BaseModel] = None,
    train_metrics: Optional[List[Dict[str, Any]]] = None,
    delta_dumper: Optional[DeltaEmbeddingDumper] = None,
    shard: Optional[ShardContext] = None,
    tb=None,
    lr_fn: Optional[Callable[[int], Any]] = None,
    pipelined: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor], bool]:
    """The body of the training loop over one epoch's (batch, info)
    items: a train step per batch, the step's predictions into the
    model's ``train_metrics`` (on the host), the batch's ids into
    ``delta_dumper`` and its dump on its interval, the dataloader watermark
    (``dataloader_state``, {source_id: last row consumed}) raised to the
    batch's ``checkpoint_info``, a log line every ``log_every`` steps
    (the losses, and each train metric as ``train_<name>``), then
    ``after_step(state, info)``. A model that samples its input for a
    fit at the end of training (RQ-KMeans) gets each batch through its
    ``collect_from_batch``. Stops after step ``num_steps`` (when >
    0). Returns (state, the last step's metrics, whether it stopped at
    ``num_steps``). Writes nothing itself. Over several ranks (``shard``)
    every rank steps only while every rank has a batch, so the ranks
    stop together on uneven input, and a batch's ``data_timestamp`` is
    the ranks' least (the event-time quorum of the checkpoints). With
    ``tb`` (``utils/summary_util.SummaryWriter``) each log step also
    writes the losses and ``lr_fn(step)``, the sparse learning-rate
    multiplier. With ``pipelined`` the loop reads one batch ahead
    (``_paired``) and steps with ``train_step(state, batch,
    next_batch)``."""
    metrics: Dict[str, torch.Tensor] = {}
    t0, examples = time.perf_counter(), 0
    items = _in_step(batches, shard)
    for batch, info, next_batch in (
            _paired(items) if pipelined
            else ((b, i, None) for b, i in items)):
        state, metrics = (train_step(state, batch, next_batch) if pipelined
                          else train_step(state, batch))
        if hasattr(model, "collect_from_batch"):
            model.collect_from_batch(batch)
        preds = metrics.pop("__preds", None)
        if train_metrics and preds is not None:
            model.update_metrics(train_metrics, preds, batch)
        examples += info.batch_size
        if delta_dumper is not None:
            delta_dumper.observe(batch)
            delta_dumper.maybe_dump(state["step"],
                                    model.embedding_group.engine_tables())
        for sid, row in info.checkpoint_info.items():
            dataloader_state[sid] = max(dataloader_state.get(sid, -1), row)
        step = state["step"]
        if log_every and step % log_every == 0:
            rate = examples / max(time.perf_counter() - t0, 1e-9)
            line = " ".join(f"{k}={float(v):.5f}"
                            for k, v in metrics.items())
            if train_metrics:
                line += "".join(
                    f" train_{k}={v:.4f}"
                    for k, v in model.compute_metrics(train_metrics).items()
                    if np.isfinite(v))
            logger.info(f"step {step}: {line} ({rate:.0f} ex/s)")
            if tb is not None:
                tb.log_scalars(step, metrics,
                               None if lr_fn is None else float(lr_fn(step)))
        if after_step is not None:
            after_step(state, info)
        if num_steps and step >= num_steps:
            return state, metrics, True
    return state, metrics, False


def _in_step(batches, shard: Optional[ShardContext]):
    """``batches`` while every rank has one (all of them on one rank)."""
    if shard is None or shard.world <= 1:
        yield from batches
        return
    it = iter(batches)
    while True:
        item = next(it, None)
        if not dist_util.all_workers_have_data(shard, item is not None):
            return
        batch, info = item
        info.data_timestamp = dist_util.global_min_int(
            shard, info.data_timestamp)
        yield batch, info


def _paired(items):
    """(batch, info) items -> (batch, info, the next item's batch, None
    for the last): one item read ahead, for the overlaps. Over several
    ranks ``items`` are ``_in_step``'s, so every rank reads ahead at the
    same point and meets the last item at the same step."""
    it = iter(items)
    cur = next(it, None)
    while cur is not None:
        nxt = next(it, None)
        yield cur[0], cur[1], None if nxt is None else nxt[0]
        cur = nxt


def _drop_staged(state: Dict[str, Any]) -> None:
    """The route staged for a batch the loop will not step on (the
    epoch's, or the run's, end), waited for and dropped: every rank
    issued it, and the side group's next exchange must not meet it."""
    staged = state.pop("staged", None)
    if staged is not None:
        staged.wait()


def _run_eval(model: BaseModel, eval_step, eval_dl, num_steps: int = 0,
              model_dir: Optional[str] = None, step: int = 0,
              shard: Optional[ShardContext] = None) -> Dict[str, float]:
    """One pass over the eval loader (``num_steps`` > 0 stops early):
    the model's metrics, and every loss averaged over the batches as
    ``loss_<name>``. Batch N-1's metrics are updated on the host while
    batch N computes on the device. With ``model_dir``, the result is
    appended to ``<model_dir>/train_eval_result_v2.txt`` as a
    ``{"global_step": step, ...}`` line. Over several ranks see
    ``_run_eval_ranks``; every rank returns the result, rank 0 writes
    it."""
    if shard is not None and shard.world > 1:
        result = _run_eval_ranks(model, eval_step, eval_dl, num_steps, shard)
        _write_eval(result, model_dir if shard.rank == 0 else None, step)
        return result
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
    _write_eval(result, model_dir, step)
    return result


def _write_eval(result: Dict[str, float], model_dir: Optional[str],
                step: int) -> None:
    if model_dir:
        with open(os.path.join(model_dir, "train_eval_result_v2.txt"),
                  "a") as f:
            f.write(json.dumps({"global_step": step, **result}) + "\n")
    logger.info(f"eval @ step {step}: {result}")


def _run_eval_ranks(model: BaseModel, eval_step, eval_dl, num_steps: int,
                    shard: ShardContext) -> Dict[str, float]:
    """The eval over several ranks, each on its input shard. The lookups
    are collective, so the ranks step together: a rank out of rows runs
    its last batch again without counting it (the reference's dummy
    batch), until no rank has rows left or a rank has none to repeat.
    The metrics are gathered from every rank (``sync_metrics``); each
    loss is the mean over the steps of the ranks' mean, the global
    batch's loss (a repeated batch counts, as the JAX package counts its
    padded replays)."""
    from torcheasyrec_tpu_torch.metrics import sync_metrics

    metrics = model.init_metrics()
    loss_sums: Dict[str, float] = {}
    n, last = 0, None
    batches = eval_dl()
    try:
        while True:
            item = next(batches, None)
            feed = item[0] if item is not None else last
            if not dist_util.any_worker_has_data(shard, item is not None):
                break
            if not dist_util.all_workers_have_data(shard, feed is not None):
                break
            last = feed
            preds, losses = eval_step(feed)
            if item is not None:
                model.update_metrics(metrics, preds, feed)
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            n += 1
            if num_steps and n >= num_steps:
                break
    finally:
        batches.close()
    sync_metrics(metrics, shard)
    result = model.compute_metrics(metrics)
    names = sorted(loss_sums)
    sums = dist_util.gather_host_sum(shard, *(loss_sums[k] for k in names))
    result.update({f"loss_{k}": v / shard.world / max(n, 1)
                   for k, v in zip(names, sums)})
    return result


def _eval_input(pipeline_config, explicit: bool) -> Optional[str]:
    """The eval input of ``train_and_evaluate``: the config's
    ``eval_input_path`` (files, directories, globs) when it names files
    that exist. Where it does not, an explicit argument raises; a path
    from the config is skipped with a warning, as before directories and
    globs were read."""
    path = pipeline_config.eval_input_path
    if not path:
        return None
    from torcheasyrec_tpu_torch.protos import data_pb2

    kind = pipeline_config.data_config.dataset_type or _infer_type(path)
    expand = (expand_csv_paths if kind == data_pb2.DatasetType.CsvDataset
              else _expand_paths)
    try:
        missing = [p for p in expand(path) if not os.path.exists(p)]
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
    shard: Optional[ShardContext] = None,
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
    consumed, with the accumulated gradients and the grad scaler where
    the config has them. ``fine_tune_checkpoint`` (else the config's)
    starts from a checkpoint or a bare state_dict, restoring what it
    holds. The train metrics of the config are logged every
    ``log_step_count_steps``; ``is_profiling`` writes a
    ``torch.profiler`` trace of steps 3-5
    (``<model_dir>/profile/trace.json``). ``delta_embedding_dump_config``
    writes the rows the steps touched every ``dump_interval_steps``
    steps and at the end (``<model_dir>/delta_embedding_dump`` unless it
    names an ``output_dir``).

    Over several ranks (``shard``, else torchrun's environment when
    ``WORLD_SIZE`` > 1, whose process group is then left when the
    function returns; the module docstring says what runs where) every
    rank calls it with the same arguments."""
    own_group = shard is None and dist_util.launched_world_size() > 1
    if own_group:
        shard = dist_util.init_distributed(device)
    try:
        return _train_and_evaluate(
            pipeline_config_path, train_input_path, eval_input_path,
            continue_train, fine_tune_checkpoint, edit_config_json, device,
            shard)
    finally:
        if own_group:
            dist_util.destroy_distributed()


def _train_and_evaluate(pipeline_config_path, train_input_path,
                        eval_input_path, continue_train,
                        fine_tune_checkpoint, edit_config_json, device,
                        shard):
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if edit_config_json:
        config_util.edit_config(pipeline_config, json.loads(edit_config_json))
    if train_input_path:
        pipeline_config.train_input_path = train_input_path
    if eval_input_path:
        pipeline_config.eval_input_path = eval_input_path
    train_config = pipeline_config.train_config
    data_config = pipeline_config.data_config
    eval_path = _eval_input(pipeline_config, bool(eval_input_path))

    dev = shard.device if shard is not None else resolve_device(device)
    multi = shard is not None and shard.world > 1
    model_dir = pipeline_config.model_dir
    saved_plan = planner.load_plan(model_dir) if continue_train and multi \
        else None
    model, features, sparse_sched = _build_model_and_optim(
        pipeline_config, dev, for_train=True, shard=shard, plan=saved_plan)
    if model.sharding_plan and dist_util.is_main_process(shard):
        os.makedirs(model_dir, exist_ok=True)
        planner.save_plan(model.sharding_plan, model_dir)
    tx, dense_sched = _dense_optimizer(model, train_config)
    grad_accum = int(train_config.gradient_accumulation_steps or 1)
    scaler_cfg = (train_config.grad_scaler
                  if train_config.HasField("grad_scaler") else None)
    # the accumulated gradients and the scaler exist before a restore
    # reads them from the checkpoint
    state = _init_state(model, tx, grad_accum, scaler_cfg)
    state["epoch"] = 0
    if (train_config.steps_per_dispatch or 1) > 1:
        logger.warning(
            f"steps_per_dispatch {train_config.steps_per_dispatch}: the "
            "steps of one dispatch run as single steps (the same numbers)")
    has_host = model.embedding_group.engine.has_host_groups
    # sparse-input-dist overlap (TrainPipelineSparseDist analogue): the
    # next batch's id exchange runs while the step does
    sparse_overlap = (bool(train_config.sparse_dist_overlap) and multi
                      and (train_config.steps_per_dispatch or 1) == 1
                      and not has_host)
    if train_config.sparse_dist_overlap and not sparse_overlap:
        logger.warning(
            "sparse_dist_overlap requires several ranks, per-batch "
            "stepping and no host_offload groups; running unpipelined")
    if sparse_overlap:
        shard.side()  # the staging group, made by every rank here
    ckpt_manager = checkpoint_util.CheckpointManager(
        model_dir,
        save_checkpoints_steps=train_config.save_checkpoints_steps,
        save_checkpoints_epochs=train_config.save_checkpoints_epochs,
        keep_checkpoint_max=train_config.keep_checkpoint_max,
        save_checkpoints_timestamp_interval=(
            train_config.save_checkpoints_timestamp_interval),
        save_checkpoints_timestamps=list(
            train_config.save_checkpoints_timestamps),
        shard=shard,
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
    if dist_util.is_main_process(shard):
        config_util.save_message(pipeline_config,
                                 os.path.join(model_dir, "pipeline.config"))

    # each rank reads its shard of the input (create_dataloader's default)
    dense_bf16 = _dense_bf16(model, shard)
    train_dl = create_dataloader(
        data_config, features, pipeline_config.train_input_path,
        mode="train", resume_state=dataloader_state, device=dev,
        dense_bf16=dense_bf16)
    eval_dl = None
    if eval_path:
        eval_dl = create_dataloader(data_config, features, eval_path,
                                    mode="eval", device=dev,
                                    dense_bf16=dense_bf16)
    train_step = make_train_step(model, tx, sparse_sched, dense_sched,
                                 grad_accum, scaler_cfg)
    eval_step = make_eval_step(model)
    train_metrics = model.init_train_metrics()
    profiler = _step_profiler(model_dir, dev) if train_config.is_profiling \
        else None
    tb = None
    if train_config.use_tensorboard and dist_util.is_main_process(shard):
        from torcheasyrec_tpu_torch.utils.summary_util import SummaryWriter

        tb = SummaryWriter(os.path.join(model_dir, "tb"),
                           list(train_config.tensorboard_summaries) or None)
    eval_result: Dict[str, float] = {}
    delta_dumper = None
    if train_config.HasField("delta_embedding_dump_config"):
        # over several ranks its dumps are collective and rank 0 writes
        dcfg = train_config.delta_embedding_dump_config
        delta_dumper = DeltaEmbeddingDumper(
            dcfg.output_dir or os.path.join(model_dir,
                                            "delta_embedding_dump"),
            model.embedding_group, dcfg.dump_interval_steps,
            dcfg.file_prefix)

    def save_and_eval() -> None:
        nonlocal eval_result
        ckpt_manager.save(model, tx, state, dataloader_state)
        if eval_dl is not None:
            eval_result = _run_eval(
                model, eval_step, eval_dl,
                pipeline_config.eval_config.num_steps or 0, model_dir,
                state["step"], shard)

    def after_step(state, info: BatchInfo) -> None:
        if profiler is not None:
            profiler.step()
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
                after_step, train_config.log_step_count_steps, model,
                train_metrics, delta_dumper, shard, tb,
                lambda t: sparse_sched["fn"](t),
                pipelined=sparse_overlap or has_host)
            _drop_staged(state)
        finally:
            state.pop("staged", None)
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

    if profiler is not None:
        profiler.stop()
    if delta_dumper is not None:
        delta_dumper.dump(state["step"], model.embedding_group.engine_tables())
    if hasattr(model, "on_train_end"):
        # RQ-KMeans fits its codebooks, before the final save and eval
        model.on_train_end()
    save_and_eval()
    if tb is not None:
        tb.log_eval(state["step"], eval_result)
        tb.close()
    result = {"step": float(state["step"])}
    result.update({k: float(v) for k, v in metrics.items()})
    result.update(eval_result)
    return result


def _step_profiler(model_dir: str, dev: torch.device):
    """A started ``torch.profiler`` that skips the first step, warms up
    on the second and records steps 3-5 (CPU, and CUDA on the card),
    then writes ``<model_dir>/profile/trace.json``; the loop calls its
    ``step()`` after every train step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out_dir = os.path.join(model_dir, "profile")
    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(
        activities=activities,
        schedule=schedule(skip_first=1, wait=0, warmup=1, active=3, repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(
            os.path.join(out_dir, "trace.json")))
    prof.start()
    return prof


def evaluate(
    pipeline_config_path: str,
    checkpoint_path: Optional[str] = None,
    eval_input_path: Optional[str] = None,
    eval_result_filename: str = "eval_result.txt",
    device="cuda",
    shard: Optional[ShardContext] = None,
) -> Dict[str, float]:
    """Evaluate a checkpoint (``checkpoint_path``, else the latest of the
    config's ``model_dir``, else the seeded init) on ``eval_input_path``
    (else the config's; files, directories, globs) in batches of
    ``eval_batch_size`` (else ``batch_size``); writes the result as JSON
    to ``<model_dir>/<eval_result_filename>`` and returns it. Over several
    ranks (``shard``, else torchrun's environment) the tables take the
    model dir's ``sharding_plan.json`` (else the planner's plan), each
    rank reads its rows of the checkpoint and its input shard, and rank
    0 writes the gathered result."""
    own_group = shard is None and dist_util.launched_world_size() > 1
    if own_group:
        shard = dist_util.init_distributed(device)
    try:
        return _evaluate(pipeline_config_path, checkpoint_path,
                         eval_input_path, eval_result_filename, device, shard)
    finally:
        if own_group:
            dist_util.destroy_distributed()


def _evaluate(pipeline_config_path, checkpoint_path, eval_input_path,
              eval_result_filename, device, shard):
    dev = shard.device if shard is not None else resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    if eval_input_path:
        pipeline_config.eval_input_path = eval_input_path
    model_dir = pipeline_config.model_dir
    multi = shard is not None and shard.world > 1
    model, features = build_model(
        pipeline_config, dev, shard=shard,
        plan=planner.load_plan(model_dir) if multi and model_dir else None)
    ckpt = checkpoint_path or checkpoint_util.latest_checkpoint(model_dir)
    step = 0
    if ckpt:
        step = int(checkpoint_util.load_model_weights(ckpt, model).get(
            "step", 0))
    eval_dl = create_dataloader(
        pipeline_config.data_config, features,
        pipeline_config.eval_input_path, mode="eval", device=dev,
        dense_bf16=_dense_bf16(model, shard))
    result = _run_eval(model, make_eval_step(model), eval_dl,
                       pipeline_config.eval_config.num_steps or 0, None, step,
                       shard)
    if model_dir and dist_util.is_main_process(shard):
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
    return _predict_preds(pipeline_config, model, features,
                          predict_input_path, predict_output_path,
                          reserved_columns, output_columns, dev)


def _predict_preds(pipeline_config, model: BaseModel, features,
                   input_path: str, output_path: str,
                   reserved_columns: Optional[str],
                   output_columns: Optional[str], dev) -> int:
    """The model's predictions over the predict-mode loader, after the
    reserved input columns (carried through, so predictions stay
    joinable): every output but the ``__`` and list ones, or those of
    ``output_columns``; [B, K] outputs as list columns (the SID models'
    ``codes`` [B, L] as ``list<int64>``)."""
    import pyarrow as pa

    out_cols = _parse_list(output_columns)
    eval_step = make_eval_step(model, with_loss=False)

    def convert(preds, reserved_cols) -> Dict[str, pa.Array]:
        out: Dict[str, pa.Array] = dict(reserved_cols)
        for k, v in preds.items():
            if (k.startswith("__") or (out_cols and k not in out_cols)
                    or isinstance(v, (list, tuple))):
                continue
            v = (v.float() if v.is_floating_point() else v).cpu().numpy()
            out[k] = pa.array(v) if v.ndim == 1 else pa.array(list(v))
        return out

    return _predict_loop(pipeline_config, features, input_path, output_path,
                         reserved_columns, dev,
                         lambda batch: eval_step(batch)[0], convert)


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


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

PREDICT_PROGRAM = "predict_fn.pt2"
TOWER_PROGRAM = "tower_fn.pt2"
SERVING_SPEC = "serving_spec.json"


def _artifact_model(pipeline_config, dev) -> Tuple[BaseModel, list]:
    """(model in eval mode, features) for export and the artifact
    ``predict``: built with the config's sparse optimizer, so a packed
    group has the layout of the trainer's (and of the JAX package's),
    which the quantized tables' rows follow."""
    model, features, _ = _build_model_and_optim(pipeline_config, dev,
                                                for_train=True)
    return model.eval(), features


def _parse_list(columns: Optional[str]) -> List[str]:
    return [c.strip() for c in (columns or "").split(",") if c.strip()]


def export(
    pipeline_config_path: str,
    export_dir: str,
    checkpoint_path: Optional[str] = None,
    device="cuda",
) -> None:
    """Write the serving artifact of a trained model to ``export_dir``:
    the weights of ``checkpoint_path`` (else, with ``exporter_type:
    "best"``, the checkpoint of the best eval line, else the latest of
    ``model_dir``, else the seeded init), the config, ``fg.json`` and the
    serving program traced on ``device``. A match model writes one
    artifact per tower (``user/``, ``item/``) and the whole model at the
    root; TDM writes ``embedding/`` (tree node features -> node
    embeddings, for tree building) and ``model/`` (the whole model, which
    scores (user, node) pairs). ``QUANT_EMB`` (INT8, INT4, INT2, FP16)
    quantizes the tables into ``quant_tables/`` and writes no program, as
    in the JAX package. A failed program serialization raises unless
    ``TZREC_EXPORT_BEST_EFFORT=1``."""
    from torcheasyrec_tpu_torch.models.match_model import MatchModel
    from torcheasyrec_tpu_torch.models.tdm import TDM

    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(pipeline_config_path)
    model_dir = pipeline_config.model_dir
    model, features = _artifact_model(pipeline_config, dev)
    ckpt = checkpoint_path
    if ckpt is None and pipeline_config.export_config.exporter_type == "best":
        ckpt = _best_checkpoint(pipeline_config, model_dir)
    if ckpt is None:
        ckpt = checkpoint_util.latest_checkpoint(model_dir)
    if ckpt:
        checkpoint_util.load_model_weights(ckpt, model)
    if isinstance(model, MatchModel):
        for tower, spec in model.tower_specs().items():
            _export_tower(pipeline_config, model, features,
                          os.path.join(export_dir, tower), tower, spec)
    if isinstance(model, TDM):
        _export_tdm_embedding(pipeline_config, model, features,
                              os.path.join(export_dir, "embedding"))
        export_dir = os.path.join(export_dir, "model")
    _export_artifact(pipeline_config, model, features, export_dir)


def _write_config_and_fg(pipeline_config, features, out_dir: str) -> None:
    from torcheasyrec_tpu_torch.features import create_fg_json

    os.makedirs(out_dir, exist_ok=True)
    config_util.save_message(pipeline_config,
                             os.path.join(out_dir, "pipeline.config"))
    with open(os.path.join(out_dir, "fg.json"), "w") as f:
        json.dump(create_fg_json(features), f, indent=2)


def _export_artifact(pipeline_config, model: BaseModel, features,
                     export_dir: str) -> None:
    """The whole model's artifact; with ``QUANT_EMB`` the tables go
    rowwise-quantized into ``quant_tables/<group>.npz`` (``values``,
    ``scales``; ``quant_meta.json`` holds the dtype and each group's rows
    and dim) and ``model/`` holds the dense weights only."""
    from torcheasyrec_tpu_torch.acc.quant_util import quantize_rowwise

    _write_config_and_fg(pipeline_config, features, export_dir)
    state = model.state_dict()
    quant_dtype = os.environ.get("QUANT_EMB", "").upper()
    if quant_dtype:
        eg = model.embedding_group
        mats = eg.engine.export_weight_matrices(eg.engine_tables())
        qdir = os.path.join(export_dir, "quant_tables")
        os.makedirs(qdir, exist_ok=True)
        meta = {"dtype": quant_dtype, "groups": {}}
        for gk, w in mats.items():
            q = quantize_rowwise(w, quant_dtype)
            np.savez(os.path.join(qdir, f"{gk}.npz"), values=q["values"],
                     scales=q["scales"])
            meta["groups"][gk] = {"rows": int(w.shape[0]),
                                  "dim": int(w.shape[1])}
        with open(os.path.join(export_dir, "quant_meta.json"), "w") as f:
            json.dump(meta, f)
        state = {k: v for k, v in state.items()
                 if not k.startswith("embedding_group.tables.")}
    checkpoint_util.save_model(os.path.join(export_dir, "model"), state)
    if not quant_dtype:
        _export_program(pipeline_config, model, features, export_dir)
    logger.info(f"exported model to {export_dir}"
                + (f" (tables {quant_dtype})" if quant_dtype else ""))


def _tower_weights(model: BaseModel, table_names) -> Dict[str, torch.Tensor]:
    """The dense weights and the tower's own tables (the others stay at
    their init where the artifact is loaded; the tower never reads
    them)."""
    prefix = "embedding_group.tables."
    return {k: v for k, v in model.state_dict().items()
            if not k.startswith(prefix) or k[len(prefix):] in table_names}


def _tower_fn(model: BaseModel, tower: str, groups: List[str],
              output: str) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """batch of the tower's features -> {output: fp32 embedding}."""

    def fn(batch: Batch) -> Dict[str, torch.Tensor]:
        grouped = model.embedding_group(batch, model.compute_dtype, groups)
        grouped, _ = model.build_input(grouped, batch)
        return {output: model.predict_tower(grouped, batch, tower).float()}

    return fn


def _export_tower(pipeline_config, model: BaseModel, features,
                  tower_dir: str, tower: str, spec: Dict[str, Any]) -> None:
    """One tower's artifact: the dense weights with the tower's tables,
    the config, the tower's ``fg.json``, ``tower.json`` (tower, groups,
    output key, features) and the program of the tower function."""
    eg = model.embedding_group
    groups = eg.groups_closure(spec["groups"])
    feat_names = eg.features_for_groups(groups)
    tower_features = [f for f in features if f.name in set(feat_names)]
    _write_config_and_fg(pipeline_config, tower_features, tower_dir)
    checkpoint_util.save_model(
        os.path.join(tower_dir, "model"),
        _tower_weights(model, eg.tables_for_groups(groups)))
    with open(os.path.join(tower_dir, "tower.json"), "w") as f:
        json.dump({"tower": tower, "groups": groups,
                   "output": spec["output"], "features": feat_names},
                  f, indent=2)
    _serialize_program(pipeline_config, tower_features,
                       _tower_fn(model, tower, groups, spec["output"]),
                       model, tower_dir, TOWER_PROGRAM)
    logger.info(f"exported the {tower} tower to {tower_dir}")


class _NodeEmbedding(torch.nn.Module):
    """TDM's node embedding as a module of its own: an embedding group of
    the query features alone (one DEEP group, ``node``), holding a copy
    of their tables and nothing else, so that its program carries those
    tables only. Its output is ``EmbeddingGroup.node_embedding``'s."""

    GROUP = "node"

    def __init__(self, model: BaseModel) -> None:
        from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
        from torcheasyrec_tpu_torch.protos import model_pb2

        super().__init__()
        eg = model.embedding_group
        names = eg.query_features(model.seq_group)
        group = model_pb2.FeatureGroupConfig(
            group_name=self.GROUP, feature_names=names,
            group_type=model_pb2.DEEP)
        fused = eg.engine_tables()
        dev = eg.device
        self.embedding_group = EmbeddingGroup(
            [f for f in model._features if f.name in set(names)], [group],
            torch.Generator(device=dev),
            sparse_optimizer=SparseOptimizer("sgd", {"lr": 0.0}),
            **model._engine_options)
        sub = self.embedding_group
        want = eg.engine.tables_for_features(set(names))
        if set(sub.engine._specs) != want:
            raise ValueError(f"node tables {sorted(sub.engine._specs)}, "
                             f"the model's query tables {sorted(want)}")
        for name in want:
            sub.engine.write_table(sub.engine_tables(), name,
                                   eg.engine.extract_table(fused, name))
        self._dtype = model.compute_dtype

    def forward(self, batch: Batch) -> torch.Tensor:
        return self.embedding_group(batch, self._dtype,
                                    [self.GROUP])[self.GROUP]


def _export_tdm_embedding(pipeline_config, model: BaseModel, features,
                          emb_dir: str) -> None:
    """TDM's ``embedding/`` artifact: the dense weights with the query
    features' tables, the config, those features' ``fg.json``,
    ``tower.json`` (tower ``embedding``, the sequence group, output
    ``item_emb``, the features) and ``tower_fn.pt2``, the program of
    ``_NodeEmbedding``."""
    eg = model.embedding_group
    feat_names = eg.query_features(model.seq_group)
    node_features = [f for f in features if f.name in set(feat_names)]
    _write_config_and_fg(pipeline_config, node_features, emb_dir)
    checkpoint_util.save_model(
        os.path.join(emb_dir, "model"),
        _tower_weights(model, eg.engine.tables_for_features(set(feat_names))))
    with open(os.path.join(emb_dir, "tower.json"), "w") as f:
        json.dump({"tower": "embedding", "seq_group": model.seq_group,
                   "output": "item_emb", "features": feat_names},
                  f, indent=2)
    node = _NodeEmbedding(model)
    _serialize_program(pipeline_config, node_features,
                       lambda batch: {"item_emb": node(batch).float()},
                       node, emb_dir, TOWER_PROGRAM)
    logger.info(f"exported TDM's embedding artifact to {emb_dir}")


def _export_program(pipeline_config, model: BaseModel, features,
                    export_dir: str) -> None:
    """``predict_fn.pt2``: the eval forward without the ``__`` outputs
    and the list outputs."""

    def serve_fn(batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in model(batch).items()
                if not k.startswith("__") and not isinstance(v, (list, tuple))}

    _serialize_program(pipeline_config, features, serve_fn, model,
                       export_dir, PREDICT_PROGRAM)


class _FlatServe(torch.nn.Module):
    """``serve_fn`` over the flat tensors of a batch: what is exported.
    The model is a submodule, so its weights go into the program."""

    def __init__(self, model: BaseModel, serve_fn, spec) -> None:
        super().__init__()
        self.model = model
        self._serve_fn = serve_fn
        self._spec = spec

    def forward(self, *flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        import torch.utils._pytree as pytree

        return self._serve_fn(pytree.tree_unflatten(list(flat), self._spec))


def serving_batch(pipeline_config, features, device) -> Tuple[int, Batch]:
    """(rows, batch) the serving program is traced over: a mock table
    (``utils/test_util``, seed 0) of ``eval_batch_size`` (else
    ``batch_size``) rows, parsed as the loader parses, on ``device``.
    The program takes parsed batches, so FG features are mocked by their
    encoded (FG_NONE) form."""
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils.test_util import generate_mock_table

    dc = pipeline_config.data_config
    bs = int(dc.eval_batch_size or dc.batch_size)
    features = [f.encoded() for f in features]
    tbl = generate_mock_table(features, bs, [], seed=0)
    batch = DataParser(features, labels=[]).parse_to_batch(
        {name: tbl.column(i) for i, name in enumerate(tbl.schema.names)})
    return bs, batch.to(device)


def _serialize_program(pipeline_config, features, serve_fn,
                       model: torch.nn.Module, export_dir: str,
                       filename: str) -> None:
    """Export ``serve_fn(batch)`` over the flat tensors of the serving
    batch (``torch.export``, static shapes, no gradient; ``model``, which
    has an ``embedding_group``, is the module whose weights the program
    holds) and save it with
    ``torch.export.save``, beside ``serving_spec.json`` (``batch_size``,
    ``platforms``, ``num_inputs``, ``input_tree``). Raises on failure: an
    artifact must not ship without its program, unless
    ``TZREC_EXPORT_BEST_EFFORT=1`` downgrades the failure to a
    warning."""
    import torch.utils._pytree as pytree

    try:
        dev = model.embedding_group.device
        bs, batch = serving_batch(pipeline_config, features, dev)
        leaves, spec = pytree.tree_flatten(batch)
        # the weights take no gradient, so the attention runs as its
        # forward operator (not the autograd function)
        model.requires_grad_(False)
        program = torch.export.export(
            _FlatServe(model, serve_fn, spec), tuple(leaves))
        torch.export.save(program, os.path.join(export_dir, filename))
        with open(os.path.join(export_dir, SERVING_SPEC), "w") as f:
            json.dump({"batch_size": bs, "platforms": [dev.type],
                       "num_inputs": len(leaves), "input_tree": str(spec)},
                      f)
        logger.info(f"wrote {filename}")
    except Exception as e:  # noqa: BLE001 - raised again below
        if os.environ.get("TZREC_EXPORT_BEST_EFFORT") == "1":
            logger.warning(f"program export skipped: {e}")
            return
        raise RuntimeError(
            f"serving program export failed for {export_dir}: {e}") from e


def _best_checkpoint(pipeline_config, model_dir: str) -> Optional[str]:
    """The checkpoint whose eval line in ``train_eval_result_v2.txt`` has
    the best ``best_exporter_metric`` (default auc; larger or smaller as
    ``metric_larger_is_better`` says); None where there is no such line
    or its checkpoint is gone."""
    ec = pipeline_config.export_config
    metric = ec.best_exporter_metric or "auc"
    larger = ec.metric_larger_is_better
    path = os.path.join(model_dir, "train_eval_result_v2.txt")
    if not os.path.exists(path):
        return None
    best_step, best_val = None, None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if metric not in rec:
                continue
            v = float(rec[metric])
            if best_val is None or (v > best_val if larger else v < best_val):
                best_val, best_step = v, int(rec["global_step"])
    if best_step is None or (
            best_step not in checkpoint_util.list_checkpoints(model_dir)):
        return None
    logger.info(f"best exporter: step {best_step} ({metric}={best_val:.5f})")
    return checkpoint_util.checkpoint_path(model_dir, best_step)


# ---------------------------------------------------------------------------
# predict from an artifact
# ---------------------------------------------------------------------------


def predict(
    predict_input_path: str,
    predict_output_path: str,
    scripted_model_path: str,
    reserved_columns: Optional[str] = None,
    output_columns: Optional[str] = None,
    batch_size: Optional[int] = None,
    device="cuda",
) -> int:
    """Batch inference from an export artifact (``scripted_model_path``,
    the directory ``export`` wrote): the model is rebuilt from its
    ``pipeline.config`` and ``model/`` weights, with the tables
    dequantized from ``quant_tables/`` where ``quant_meta.json`` is
    present; a tower artifact (``tower.json``) writes its tower's
    embeddings. Output and columns as ``predict_checkpoint``; returns the
    rows predicted.

    The artifact's ``.pt2`` program is not run here. To run it
    elsewhere, import ``torcheasyrec_tpu_torch.ops.hstu`` before
    ``torch.export.load``: the program names the attention operator that
    module registers."""
    from torcheasyrec_tpu_torch.acc.quant_util import dequantize_rowwise

    dev = resolve_device(device)
    pipeline_config = config_util.load_pipeline_config(
        os.path.join(scripted_model_path, "pipeline.config"))
    if batch_size:
        pipeline_config.data_config.batch_size = batch_size
    tower_meta_path = os.path.join(scripted_model_path, "tower.json")
    if os.path.exists(tower_meta_path):
        with open(tower_meta_path) as f:
            tower_meta = json.load(f)
        return _predict_tower_artifact(
            pipeline_config, scripted_model_path, tower_meta,
            predict_input_path, predict_output_path, reserved_columns, dev)
    model, features = _artifact_model(pipeline_config, dev)
    model_dir = os.path.join(scripted_model_path, "model")
    quant_meta_path = os.path.join(scripted_model_path, "quant_meta.json")
    if os.path.exists(quant_meta_path):
        with open(quant_meta_path) as f:
            quant_meta = json.load(f)
        checkpoint_util.restore_model(model_dir, model, strict=False)
        mats = {}
        for gk, meta in quant_meta["groups"].items():
            z = np.load(os.path.join(scripted_model_path, "quant_tables",
                                     f"{gk}.npz"))
            mats[gk] = dequantize_rowwise(
                {"values": z["values"], "scales": z["scales"]},
                quant_meta["dtype"], meta["dim"])
        eg = model.embedding_group
        stores = eg.engine_tables()
        with torch.no_grad():
            for gk, t in eg.engine.import_weight_matrices(mats, dev).items():
                stores[gk].copy_(t)
    else:
        checkpoint_util.restore_model(model_dir, model)
    return _predict_preds(pipeline_config, model, features,
                          predict_input_path, predict_output_path,
                          reserved_columns, output_columns, dev)


def _predict_loop(pipeline_config, features, input_path: str,
                  output_path: str, reserved_columns: Optional[str], dev,
                  step, convert) -> int:
    """The predict-mode loader over ``input_path`` through ``step``,
    written by a thread through ``convert(outputs, reserved columns)``;
    returns the rows."""
    dl = create_dataloader(pipeline_config.data_config, features, input_path,
                           mode="predict",
                           reserved_columns=_parse_list(reserved_columns),
                           device=dev)
    writer = _AsyncPredictWriter(
        create_writer(output_path, "ParquetWriter"), convert)
    n = 0
    batches = dl()
    try:
        for batch, info in batches:
            writer.put(step(batch), info.reserved)
            n += info.batch_size
    finally:
        batches.close()
        writer.close()
    return n


def _predict_tower_artifact(pipeline_config, tower_dir: str,
                            tower_meta: Dict[str, Any], input_path: str,
                            output_path: str,
                            reserved_columns: Optional[str], dev) -> int:
    """One tower's embeddings from its artifact: the input holds that
    tower's features only (an item table for the index, user requests
    for queries, TDM's tree nodes for tree building); [B, K, D]
    multi-interest outputs are written as [B, K * D]."""
    import pyarrow as pa

    model, features = _artifact_model(pipeline_config, dev)
    checkpoint_util.restore_model(os.path.join(tower_dir, "model"), model,
                                  strict=False)
    out_key = tower_meta["output"]
    feat_set = set(tower_meta["features"])
    tower_features = [f for f in features if f.name in feat_set]
    if tower_meta["tower"] == "embedding":  # TDM's node embeddings

        def tower_fn(batch: Batch) -> Dict[str, torch.Tensor]:
            return {out_key: model.embedding_group.node_embedding(
                batch, model.compute_dtype, tower_meta["seq_group"]).float()}
    else:
        tower_fn = _tower_fn(model, tower_meta["tower"],
                             tower_meta["groups"], out_key)

    def step(batch: Batch) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return tower_fn(batch)[out_key]

    def convert(emb, reserved_cols) -> Dict[str, pa.Array]:
        emb = emb.cpu().numpy()
        if emb.ndim == 3:
            emb = emb.reshape(emb.shape[0], -1)
        out: Dict[str, pa.Array] = dict(reserved_cols)
        out[out_key] = pa.array(list(emb))
        return out

    return _predict_loop(pipeline_config, tower_features, input_path,
                         output_path, reserved_columns, dev, step, convert)
