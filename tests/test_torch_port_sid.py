"""Semantic-ID generation of the port against the JAX package (fp32, CPU;
one config text and the same numpy-seeded inputs for both; the JAX
weights cross through utils/convert.py).

- The residual quantizer under l2, cosine, ``normalize_residuals`` and
  Sinkhorn (training mode): codes equal, quantized values and distances
  within 1e-5 of each tensor's max.
- RQ-VAE's forward and gradients under each reconstruction loss (l2, l1,
  cos), commitment weights, and the contrastive loss with and without
  the pair-flag group: the loss and every output within 1e-5 of its
  max, codes equal, every dense gradient within 1e-4 of its max; the
  codebooks' gradients exactly 0 in both packages (``ste``).
- Three RQ-VAE train steps (adam, eps 1e-4): losses and every parameter
  within 1e-4 of each tensor's max.
- The gumbel-softmax forward against the JAX formula evaluated on the
  noise the port drew from its generator (1e-5).
- RQ-KMeans' ``on_train_end`` against the JAX numpy fit on the same
  samples: codebooks within 1e-5 of each one's max, assignments equal
  (plain, normalised residuals, more centroids than samples).
- ``train_and_evaluate`` of both models from the JAX init (batch 64,
  a few steps), the eval metrics within rtol 1e-4 of the JAX run's,
  ``evaluate`` equal to the trainer's, ``predict_checkpoint``'s ``codes``
  equal to the JAX package's and ``recon`` within 1e-5; ``predict`` from
  the port's export equal to its ``predict_checkpoint``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import (
    PairedTrainers,
    assert_close_to_max,
    converted_state,
    jax_model_and_state,
    jax_train_loss,
    port_train_loss,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.sid import quantizer as jq
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.modules.sid import quantizer as pq_
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
FIT_TOL = 1e-5
EVAL_RTOL = 1e-4
DIM = 16
LABELS = ["label"]

_LOSSES = "  losses { recon_loss {} }\n  losses { commitment_loss {} }\n"


def sid_cols(n: int, seed: int, pair: bool = False):
    """Item vectors around 8 fixed centres in 16-d (chr(3)-joined strings,
    as the JAX package's SID test writes them); with ``pair`` a pair
    vector near each item (a list<float> column) and a 0/1 pair flag."""
    r = np.random.default_rng(seed)
    centres = np.random.default_rng(0).normal(size=(8, DIM)) * 4
    x = centres[r.integers(0, 8, n)] + r.normal(size=(n, DIM)) * 0.3
    cols = {
        "item_emb": pa.array([chr(3).join(f"{v:.4f}" for v in row)
                              for row in x]),
        "label": pa.array(np.zeros(n, np.float32)),
    }
    if pair:
        px = (x + r.normal(size=x.shape) * 0.2).astype(np.float32)
        cols["pair_emb"] = pa.array(list(px), pa.list_(pa.float32()))
        cols["pair_flag"] = pa.array((r.random(n) < 0.7).astype(np.float32))
    return cols


def sid_config_text(model: str, batch_size: int = 64, train="unused",
                    evalp="unused", model_dir="unused", num_steps: int = 0,
                    losses: str = _LOSSES, pair: str = "") -> str:
    """A SID config over the 16-d ``item_emb`` (group "all"); ``pair``
    "pair" adds the pair group, "flag" the pair and the flag groups."""
    feats = 'feature_configs { raw_feature { feature_name: "item_emb" ' \
            f"value_dim: {DIM} }} }}\n"
    groups = ('  feature_groups { group_name: "all" feature_names: '
              '"item_emb" group_type: DEEP }\n')
    if pair:
        feats += ('feature_configs { raw_feature { feature_name: "pair_emb" '
                  f"value_dim: {DIM} }} }}\n")
        groups += ('  feature_groups { group_name: "pair" feature_names: '
                   '"pair_emb" group_type: DEEP }\n')
    if pair == "flag":
        feats += ('feature_configs { raw_feature { feature_name: '
                  '"pair_flag" } }\n')
        groups += ('  feature_groups { group_name: "flag" feature_names: '
                   '"pair_flag" group_type: DEEP }\n')
    steps = f"num_steps: {num_steps}" if num_steps else "num_epochs: 1"
    return f"""
train_input_path: "{train}"
eval_input_path: "{evalp}"
model_dir: "{model_dir}"
train_config {{
    sparse_optimizer {{ adagrad_optimizer {{ lr: 0.01 }}
                        constant_learning_rate {{}} }}
    dense_optimizer {{ adam_optimizer {{ lr: 0.005 eps: 1e-4 }}
                       constant_learning_rate {{}} }}
    {steps}
    save_checkpoints_steps: 100000
    use_tensorboard: false
}}
data_config {{
    batch_size: {batch_size}
    dataset_type: ParquetDataset
    fg_mode: FG_NONE
    label_fields: "label"
}}
{feats}model_config {{
{groups}  {model}
{losses}}}
"""


RQVAE = "sid_rqvae { embed_dim: 8 hidden_dims: [32] codebook: [16, 16] }"
CONTRASTIVE = ('sid_rqvae { embed_dim: 8 hidden_dims: [32] codebook: [16, 16]'
               ' contrastive_config { pair_feature_group: "pair"'
               ' pair_flag_feature_group: "flag" } }')


def _pair(text_model):
    return "flag" if "contrastive" in text_model else ""


class Pair:
    """The JAX model and the port's from one config text, the port
    holding the JAX init's weights."""

    def __init__(self, text: str) -> None:
        self.text = text
        (_, self.jmodel, jfeatures, self.dense,
         self.tables) = jax_model_and_state(text)
        self.model, features, _ = port_main._build_model_and_optim(
            parse_pipeline_config(text), "cpu", for_train=True)
        self.model.load_state_dict(converted_state(
            self.jmodel, self.dense, self.tables, []))
        self.jparser = JaxParser(jfeatures, labels=LABELS)
        self.parser = DataParser(features, labels=LABELS)

    def batches(self, cols):
        return self.jparser.parse_to_batch(cols), \
            self.parser.parse_to_batch(cols)


# --- the quantizer -----------------------------------------------------------


@pytest.mark.parametrize("case", ["l2", "cosine", "normalize", "sinkhorn"])
def test_residual_quantizer_matches_jax(case):
    r = np.random.default_rng(3)
    x = r.normal(size=(48, 8)).astype(np.float32)
    kw = {"distance_type": "cosine" if case == "cosine" else "l2",
          "normalize_residuals": case == "normalize",
          "sinkhorn_iters": 5 if case == "sinkhorn" else 0,
          "sinkhorn_epsilon": 0.5}
    jrq = jq.ResidualQuantizer(8, [12, 6], **kw)
    params = jrq.init(jax.random.PRNGKey(1))
    ctx = JM.Context(training=True, rng=jax.random.PRNGKey(0),
                     compute_dtype=jnp.float32)
    jzq, jcodes, jlevels = jax.jit(lambda p_, x_: jrq(p_, x_, ctx))(
        params, jnp.asarray(x))
    rq = pq_.ResidualQuantizer(8, [12, 6], torch.Generator(), **kw)
    with torch.no_grad():
        for i in range(2):
            getattr(rq, f"vq_{i}").codebook.copy_(torch.from_numpy(
                np.array(params[f"vq_{i}"]["codebook"])))
    rq.train()
    zq, codes, levels = rq(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert_close_to_max(zq.detach().numpy(), np.asarray(jzq), "zq", FWD_TOL)
    for (r_in, q), (jr, jqv) in zip(levels, jlevels):
        assert_close_to_max(r_in.detach().numpy(), np.asarray(jr), "r",
                            FWD_TOL)
        assert_close_to_max(q.detach().numpy(), np.asarray(jqv), "q",
                            FWD_TOL)
    # distances of the first level, as the quantizer computes them
    jd = jq._pairwise_dist(jnp.asarray(x), params["vq_0"]["codebook"],
                           kw["distance_type"])
    d = pq_.pairwise_dist(torch.from_numpy(x), rq.vq_0.codebook.detach(),
                          kw["distance_type"])
    assert_close_to_max(d.numpy(), np.asarray(jd), "dist", FWD_TOL)
    if case == "sinkhorn":
        ja = jq.sinkhorn_assign(jd, 5, 0.5)
        assert_close_to_max(pq_.sinkhorn_assign(d, 5, 0.5).numpy(),
                            np.asarray(ja), "assign", FWD_TOL)


# --- RQ-VAE: forward, losses, gradients, steps --------------------------------

_RQVAE_CASES = {
    "l2": (RQVAE, _LOSSES),
    "l1": (RQVAE, '  losses { recon_loss { recon_type: "l1" } }\n'
           "  losses { commitment_loss { latent_weight: [0.7, 0.2] } }\n"),
    "cos": (RQVAE.replace("codebook: [16, 16]", 'codebook: [16, 16] '
                          'distance_type: "cosine" normalize_residuals: true'),
            '  losses { recon_loss { recon_type: "cos" } }\n'
            "  losses { commitment_loss {} }\n"),
    "contrastive_flag": (CONTRASTIVE, _LOSSES),
    "contrastive": (CONTRASTIVE, _LOSSES),
}


@pytest.mark.parametrize("case", list(_RQVAE_CASES))
def test_rqvae_forward_and_grads_match_jax(case):
    model_text, losses = _RQVAE_CASES[case]
    pair = _pair(model_text)
    text = sid_config_text(model_text, losses=losses, pair=pair)
    p = Pair(text)
    cols = sid_cols(64, 5, pair=bool(pair))
    if case == "contrastive":
        # the flag group's column absent from the batch: no weights
        p.jmodel._contrastive_groups = ("pair", "no_flag")
        p.model._contrastive_groups = ("pair", "no_flag")
    jbatch, batch = p.batches(cols)
    (jtotal, jpreds), jgrads = jax.jit(jax.value_and_grad(
        jax_train_loss(p.jmodel, p.tables, jbatch), has_aux=True))(p.dense)
    total, preds = port_train_loss(p.model, batch)
    assert_close_to_max(float(total), float(jtotal), "loss", FWD_TOL)
    np.testing.assert_array_equal(preds["codes"].numpy(),
                                  np.asarray(jpreds["codes"]))
    for k in ("recon", "__z", "__x"):
        assert_close_to_max(preds[k].detach().numpy(),
                            np.asarray(jpreds[k]), k, FWD_TOL)
    assert ("__pair_flag" in preds) == (case == "contrastive_flag")
    assert ("__pair_z" in preds) == case.startswith("contrastive")
    # each loss term on its own
    jlosses = p.jmodel.loss(jpreds, jbatch)
    losses_ = p.model.loss(preds, batch)
    assert set(losses_) == set(jlosses)
    for k, v in losses_.items():
        assert_close_to_max(float(v.detach()), float(jlosses[k]), k,
                            FWD_TOL)
    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    ref = from_jax_state(jax.device_get(jgrads), {})
    params = dict(p.model.named_parameters())
    assert set(params) == set(ref)
    for n, prm in params.items():
        got = torch.zeros_like(prm) if prm.grad is None else prm.grad
        if n.endswith(".codebook"):
            # ste: no loss reaches a codebook, in either package
            assert not np.asarray(ref[n]).any(), n
            assert not got.any(), n
            continue
        assert_close_to_max(got.numpy(), ref[n].numpy(), f"grad {n}",
                            GRAD_TOL)


def test_rqvae_three_steps_match_jax():
    text = sid_config_text(CONTRASTIVE, pair="flag")
    t = PairedTrainers(text, [], LABELS)
    for i in range(3):
        jm, m = t.step(sid_cols(64, 10 + i, pair=True))
        for k in ("recon_loss", "commitment_loss", "contrastive_loss"):
            assert_close_to_max(float(m[k]), float(jm[k]), k, STEP_TOL)
    t.assert_close(STEP_TOL)


def test_gumbel_softmax_against_the_jax_formula():
    """The JAX package draws the noise from its step key; the port from
    its generator. The JAX formula on the port's draw gives the port's
    output."""
    r = np.random.default_rng(4)
    x = r.normal(size=(32, 8)).astype(np.float32)
    cb = r.normal(size=(10, 8)).astype(np.float32)
    gen = torch.Generator()
    vq = pq_.VectorQuantizer(8, 10, gen, forward_mode="gumbel_softmax")
    with torch.no_grad():
        vq.codebook.copy_(torch.from_numpy(cb))
    vq.train()
    gen.manual_seed(5)
    xt = torch.from_numpy(x).requires_grad_(True)
    q, codes, dist = vq(xt)
    u = jnp.asarray(pq_.gumbel_uniform(
        (32, 10), torch.Generator().manual_seed(5)).numpy())
    jdist = jq._pairwise_dist(jnp.asarray(x), jnp.asarray(cb), "l2")
    g = -jnp.log(-jnp.log(u + 1e-9))
    jqv = jnp.dot(jax.nn.softmax((-jdist + g) / 0.5, axis=-1),
                  jnp.asarray(cb))
    assert_close_to_max(q.detach().numpy(), np.asarray(jqv), "q", FWD_TOL)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jnp.argmin(jdist, -1)))
    # the soft assignment carries gradient to the codebook and to x
    q.sum().backward()
    assert vq.codebook.grad.abs().sum() > 0 and xt.grad.abs().sum() > 0


# --- RQ-KMeans: the fit -----------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "normalize", "more_centroids"])
def test_rqkmeans_fit_matches_jax(case):
    codebook = "[8, 8]" if case != "more_centroids" else "[8, 4]"
    norm = " normalize_residuals: true" if case == "normalize" else ""
    text = sid_config_text(f"sid_rqkmeans {{ codebook: {codebook}{norm} }}")
    p = Pair(text)
    n = 6 if case == "more_centroids" else 300
    cols = sid_cols(n, 7)
    jbatch, batch = p.batches(cols)
    x = batch.dense_features["item_emb"].values.numpy()
    p.jmodel.collect(x)
    p.model.collect_from_batch(batch)
    dense = p.jmodel.on_train_end(jax.device_get(p.dense))
    p.model.on_train_end()
    for i in range(2):
        assert_close_to_max(
            getattr(p.model.rq, f"vq_{i}").codebook.detach().numpy(),
            np.asarray(dense["rq"][f"vq_{i}"]["codebook"]), f"vq_{i}",
            FIT_TOL)
    ctx = JM.Context(training=False, rng=jax.random.PRNGKey(0),
                     compute_dtype=jnp.float32)
    _, jcodes, _ = jax.jit(lambda d_, x_: p.jmodel.rq(d_, x_, ctx))(
        dense["rq"], jnp.asarray(x))
    p.model.eval()
    _, codes, _ = p.model.rq(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


# --- the entry points -----------------------------------------------------------


@pytest.fixture(scope="module")
def sid_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid")
    paths = {"train": str(root / "train.parquet"),
             "eval": str(root / "eval.parquet")}
    pq.write_table(pa.table(sid_cols(384, 20, pair=True)), paths["train"])
    pq.write_table(pa.table(sid_cols(128, 21, pair=True)), paths["eval"])
    return str(root), paths


_ENTRY_MODELS = {
    "rqvae": (RQVAE, _LOSSES, 4),
    "rqkmeans": ("sid_rqkmeans { codebook: [8, 8] train_sample_size: 200 }",
                 _LOSSES, 0),
}


@pytest.fixture(scope="module")
def entry_runs(sid_files):
    """Each model's ``train_and_evaluate`` in both packages from the JAX
    init, then each package's ``predict_checkpoint`` of its checkpoint,
    and the port's ``evaluate``, ``export`` and ``predict`` from the
    artifact."""
    root, paths = sid_files
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_main, "maybe_mesh", lambda: None)
        for name, (model, losses, steps) in _ENTRY_MODELS.items():
            res = {}
            for pkg in ("jax", "port"):
                d = os.path.join(root, f"{name}_{pkg}")
                text = sid_config_text(
                    model, 64, paths["train"], paths["eval"], d, steps,
                    losses, pair=_pair(model))
                cfg = os.path.join(root, f"{name}_{pkg}.config")
                with open(cfg, "w") as f:
                    f.write(text)
                pred = os.path.join(root, f"{name}_{pkg}_pred.parquet")
                if pkg == "jax":
                    res["jax"] = jax_main.train_and_evaluate(cfg)
                    jax_main.predict_checkpoint(cfg, paths["eval"], pred)
                else:
                    p = Pair(text)
                    init = os.path.join(root, f"{name}_init.pt")
                    torch.save(p.model.state_dict(), init)
                    res["port"] = port_main.train_and_evaluate(
                        cfg, fine_tune_checkpoint=init, device="cpu")
                    res["evaluate"] = port_main.evaluate(cfg, device="cpu")
                    port_main.predict_checkpoint(cfg, paths["eval"], pred,
                                                 device="cpu")
                    export = os.path.join(root, f"{name}_export")
                    port_main.export(cfg, export, device="cpu")
                    art = os.path.join(root, f"{name}_artifact.parquet")
                    port_main.predict(paths["eval"], art, export,
                                      device="cpu")
                    res["artifact_pred"] = pq.read_table(art)
                res[f"{pkg}_pred"] = pq.read_table(pred)
            out[name] = res
    return out


@pytest.mark.parametrize("name", list(_ENTRY_MODELS))
def test_train_and_evaluate_matches_jax(name, entry_runs):
    res = entry_runs[name]
    ours, ref = res["port"], res["jax"]
    for k in ("unique_ratio", "rel_loss"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=EVAL_RTOL,
                                   err_msg=k)
    assert {k: ours[k] for k in res["evaluate"]} == res["evaluate"]


@pytest.mark.parametrize("name", list(_ENTRY_MODELS))
def test_predict_checkpoint_codes_match_jax(name, entry_runs):
    res = entry_runs[name]
    ours, ref = res["port_pred"], res["jax_pred"]
    assert ours.column_names == ["codes", "recon"]
    assert pa.types.is_integer(ours.schema.field("codes").type.value_type)
    np.testing.assert_array_equal(
        np.stack(ours.column("codes").to_numpy(zero_copy_only=False)),
        np.stack(ref.column("codes").to_numpy(zero_copy_only=False)))
    assert_close_to_max(
        np.stack(ours.column("recon").to_numpy(zero_copy_only=False)),
        np.stack(ref.column("recon").to_numpy(zero_copy_only=False)),
        "recon", FWD_TOL)


@pytest.mark.parametrize("name", list(_ENTRY_MODELS))
def test_predict_from_export_equals_predict_checkpoint(name, entry_runs):
    res = entry_runs[name]
    assert res["artifact_pred"].equals(res["port_pred"])
