"""The generative-recommendation family of the port against the JAX
package: DLRM-HSTU with each preprocessor, SLA and attention truncation,
ULTRA-HSTU, ``truncate_uih``, attention dropout, the eval metrics (F6),
the hstu_synth generator and config. fp32 on the CPU; the JAX attention
runs its XLA reference there, the port its plain version.

Tolerances: forward and loss within 1e-5 of each output's max, the dense
gradients within 1e-4 of each gradient's max; after one optimizer step
(the config's adam at eps 1e-4, see ADAM_EPS, and rowwise adagrad) the
dense parameters within 1e-4 and the tables and row state within 1e-3 of
each tensor's max, the tables' bound of tests/test_torch_port_train.py
(rowwise adagrad's first step divides a row's gradient by its own root
mean square); AUCs within 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import replace_block
from torch_port_helpers import (
    PairedTrainers,
    assert_close_to_max,
    assert_forward_and_grads_match,
    converted_state,
    hstu_synth_config_text,
    hstu_synth_train_config_text,
    jax_model_and_state,
    synth_cols,
)
from torcheasyrec_tpu import main as jax_main
from torcheasyrec_tpu.benchmark import synthetic as jax_synthetic
from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
from torcheasyrec_tpu.modules.gr import stu as jstu
from torcheasyrec_tpu.ops import hstu as jhstu
from torcheasyrec_tpu.optim import optimizer_builder as jax_builder
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.benchmark import synthetic as port_synthetic
from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.modules.gr import stu as pstu
from torcheasyrec_tpu_torch.ops import hstu as phstu
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config
from torcheasyrec_tpu_torch.utils.convert import dense_param_paths

BATCH = 4
LABELS = ["unused_label"]
STEP_TOL = 1e-4
TABLE_STEP_TOL = 1e-3
# adam's eps in the step comparison: at the published 1e-8 a gradient
# element at rounding level (a cancelled sum) becomes a step of lr whose
# sign the two libraries need not share (ROADMAP section 3)
ADAM_EPS = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIG = os.path.join(REPO, "torcheasyrec_tpu_torch", "benchmark",
                           "configs", "hstu_synth", "dlrm_hstu.config")


# -- model variants ------------------------------------------------------------

INTERLEAVE = """input_preprocessor {{
        contextual_interleave_preprocessor {{
          action_encoder {{ simple_action_encoder {{
            action_embedding_dim: 16 action_weights: [1, 2] }} }}
          action_mlp {{ simple_mlp {{ hidden_dim: 32 }} }}
          content_encoder {{ {content_encoder} }}
          content_mlp {{ {content_mlp} }}
        }}
      }}"""
TRUNCATION = ("attn_truncation_split_layer: 1\n"
              "      attn_truncation_tail_len: 16\n      ")
SLA = "sla_k1: 8 sla_k2: 4"


def _interleave(text, content_mlp, content_encoder="slice_content_encoder {}"):
    text = replace_block(text, "input_preprocessor {", INTERLEAVE.format(
        content_encoder=content_encoder, content_mlp=content_mlp))
    # interleaving doubles the tokens a step
    return text.replace("max_seq_len: 48", "max_seq_len: 96")


def _truncate(text):
    return text.replace("input_preprocessor {",
                        TRUNCATION + "input_preprocessor {", 1)


def _ultra(text):
    """Two channels: the base one with max_attn_len 8, a one-layer one
    with SLA."""
    start = text.index("    hstu {")
    end = len(replace_block(text, "    hstu {", ""))
    block = text[start:start + len(text) - end]
    second = block.replace("max_attn_len: 8", SLA).replace(
        "num_layers: 2", "num_layers: 1")
    text = text[:start] + block + "\n" + second + text[start + len(block):]
    return text.replace("dlrm_hstu {", "ultra_hstu {")


def variant_text(name: str, batch: int = BATCH) -> str:
    """The hstu_synth config cut to 2 layers and ``batch`` with one
    option set: the published contextual preprocessor, SLA with
    truncation, interleaving (a simple content MLP), a parameterized
    content MLP, the options of the card's check (an MLP content
    encoder, a parameterized MLP, SLA, truncation) or ULTRA-HSTU."""
    base = hstu_synth_train_config_text(
        batch, stu_extra="max_attn_len: 8" if name == "ultra" else
        SLA if name in ("sla_truncation", "options") else "")
    param = "parameterized_mlp { hidden_dim: 32 contextual_dropout_ratio: 0 }"
    return {
        "hstu_synth": lambda t: t,
        "sla_truncation": _truncate,
        "interleave": lambda t: _interleave(t, "simple_mlp { hidden_dim: 32 }"),
        "parameterized_mlp": lambda t: _interleave(t, param),
        "options": lambda t: _truncate(_interleave(
            t, param, "mlp_content_encoder { uih_mlp { hidden_units: [48] } "
            "target_mlp { hidden_units: [48] } }")),
        "ultra": lambda t: _truncate(_ultra(t)),
    }[name](base)


VARIANTS = ["hstu_synth", "sla_truncation", "interleave",
            "parameterized_mlp", "options", "ultra"]
MODEL_CLASS = {"ultra": "UltraHSTU"}


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request):
    """(name, text, JAX model, dense, tables, JAX features, port model,
    port features) with the JAX initial weights in the port model."""
    text = variant_text(request.param)
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(text)
    model, features, _ = port_main._build_model_and_optim(
        parse_pipeline_config(text), "cpu", for_train=True)
    model.load_state_dict(converted_state(
        jmodel, dense, tables, list(model.embedding_group.tables)))
    return (request.param, text, jmodel, dense, tables, jfeatures, model,
            features)


def _batches(jfeatures, features, seed):
    cols = synth_cols(BATCH, seed=seed)
    return (JaxParser(jfeatures, labels=LABELS).parse_to_batch(cols),
            DataParser(features, labels=LABELS).parse_to_batch(cols))


def test_variant_builds_as_the_jax_model(variant):
    name, _, jmodel, _, _, _, model, _ = variant
    assert type(model).__name__ == type(jmodel).__name__ == MODEL_CLASS.get(
        name, "DlrmHSTU")
    pre, jpre = model.transducer.pre, jmodel.transducer.pre
    assert type(pre).__name__ == type(jpre).__name__
    assert pre.n_ctx == jpre.n_ctx == 1
    assert (model.transducer.trunc_split, model.transducer.trunc_tail) == (
        jmodel.transducer.trunc_split, jmodel.transducer.trunc_tail)
    layer = model.transducer.stack.layers[0]
    jlayer = jmodel.transducer.stack.layer
    for attr in ("max_attn_len", "sla_k1", "sla_k2", "contextual_seq_len"):
        assert getattr(layer, attr) == getattr(jlayer, attr), attr
    if name == "ultra":
        assert [s.num_layers for s in model.extra_stacks] == [
            s.num_layers for s in jmodel.extra_stacks] == [1]
        assert model.extra_stacks[0].layers[0].sla_k1 == 8
    # every dense parameter under its JAX path (part optimizers match them)
    assert sorted(dense_param_paths(model).values()) == sorted(
        jax_builder._param_paths(variant[3]))


def test_variant_forward_and_gradients_match_jax(variant):
    _, _, jmodel, dense, tables, jfeatures, model, features = variant
    jbatch, batch = _batches(jfeatures, features, seed=3)
    preds = assert_forward_and_grads_match(model, batch, jmodel, dense,
                                           tables, jbatch)
    assert torch.isfinite(preds["logits_is_click"]).all()


def test_variant_eval_forward_matches_jax(variant):
    """Eval mode (interleaved targets stay single tokens)."""
    _, _, jmodel, dense, tables, jfeatures, model, features = variant
    jbatch, batch = _batches(jfeatures, features, seed=4)
    jpreds, jlosses = jax_main.make_eval_step(jmodel, jnp.float32)(
        {"dense": dense, "tables": tables}, jbatch)
    preds, losses = port_main.make_eval_step(model)(batch)
    for k, v in preds.items():
        assert_close_to_max(v.numpy(), np.asarray(jpreds[k]), k, 1e-5)
    for k, v in losses.items():
        assert_close_to_max(float(v), float(jlosses[k]), k, 1e-5)
    model.train()


def test_variant_one_train_step_matches_jax(variant):
    text = variant[1].replace("adam_optimizer { lr: 0.002 }",
                              f"adam_optimizer {{ lr: 0.002 eps: {ADAM_EPS} }}")
    tables = ["user_id_emb", "video_id_emb"]
    pair = PairedTrainers(text, tables, LABELS)
    jm, m = pair.step(synth_cols(BATCH, seed=5))
    for k, v in m.items():
        if not k.startswith("__"):
            assert_close_to_max(float(v), float(jm[k]), k, 1e-5)
    pair.assert_close(STEP_TOL, table_tol=TABLE_STEP_TOL)


# -- truncate_uih, the layer range, attention dropout --------------------------


@pytest.mark.parametrize("b,n,tail,n_ctx,max_targets,seed", [
    (5, 40, 16, 1, 10, 0),
    (6, 33, 4, 0, 8, 1),
    (4, 20, 30, 2, 6, 2),  # the tail longer than every history
    (7, 50, 1, 1, 20, 3),  # interleaved targets count twice
])
def test_truncate_uih_matches_jax(b, n, tail, n_ctx, max_targets, seed):
    r = np.random.default_rng(seed)
    targets = r.integers(0, max_targets + 1, b).astype(np.int32)
    hist = r.integers(0, n - n_ctx - max_targets + 1, b)
    lengths = (n_ctx + hist + targets).astype(np.int32)
    x = r.normal(size=(b, n, 6)).astype(np.float32)
    jx, jl, (jsafe, jvalid) = jstu.truncate_uih(
        jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(targets), tail,
        n_ctx, max_targets)
    px, pl, (psafe, pvalid) = pstu.truncate_uih(
        torch.from_numpy(x), torch.from_numpy(lengths),
        torch.from_numpy(targets), tail, n_ctx, max_targets)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(psafe.numpy(), np.asarray(jsafe))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    assert px.shape[1] == min(n, n_ctx + tail + max_targets)


def test_stu_stack_runs_a_layer_range():
    g = torch.Generator().manual_seed(0)
    stack = pstu.stu_from_config(dict(embedding_dim=16, hidden_dim=8,
                                      attention_dim=8, num_heads=2,
                                      num_layers=3), g)
    x = torch.randn(2, 12, 16, generator=g)
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    full = stack(x, lengths, None, 20)
    split = stack(stack(x, lengths, None, 20, end=1), lengths, None, 20,
                  start=1)
    torch.testing.assert_close(split, full, rtol=0, atol=0)


def _dropout_inputs(seed=0, b=2, n=24, h=2, d=8):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(b, n, h, d)).astype(np.float32)
               for _ in range(3))
    lengths = np.array([n, n - 7], np.int32)
    targets = np.array([3, 2], np.int32)
    return q, k, v, lengths, targets


def test_attention_dropout_matches_jax_formula():
    """With the keep mask the JAX path draws (``jax.random.bernoulli`` of
    its key over [B, H, N, N]), the port gives the JAX output and its
    gradients."""
    p = 0.3
    q, k, v, lengths, targets = _dropout_inputs()
    key = jax.random.PRNGKey(11)
    keep = np.array(jax.random.bernoulli(
        key, 1 - p, (2, 2, q.shape[1], q.shape[1])))
    args = dict(alpha=0.25, causal=True, max_attn_len=0,
                contextual_seq_len=1, min_full_attn_seq_len=0,
                scaling_seqlen=30)

    def jout(q_, k_, v_):
        return jhstu.hstu_mha(q_, k_, v_, jnp.asarray(lengths),
                              num_targets=jnp.asarray(targets),
                              dropout_pr=p, dropout_rng=key, **args)

    do = np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
    ref, vjp = jax.vjp(jout, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = phstu.hstu_mha(*t, torch.from_numpy(lengths),
                         num_targets=torch.from_numpy(targets),
                         dropout_pr=p, dropout_keep=torch.from_numpy(keep),
                         **args)
    assert_close_to_max(got.detach().numpy(), np.asarray(ref), "out", 1e-5)
    got.backward(torch.from_numpy(do))
    for name, a, jg in zip("qkv", t, jgrads):
        assert_close_to_max(a.grad.numpy(), np.asarray(jg), f"d{name}", 1e-4)
    # without dropout the same call is the plain attention
    plain = phstu.hstu_mha(*[torch.from_numpy(a) for a in (q, k, v)],
                           torch.from_numpy(lengths),
                           num_targets=torch.from_numpy(targets), **args)
    assert not torch.allclose(plain, got.detach())


def test_attention_dropout_keeps_one_minus_p_from_the_generator():
    p = 0.2
    q, k, v, lengths, targets = _dropout_inputs(n=64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    g = torch.Generator().manual_seed(3)
    b, n, h, _ = q.shape
    keep = torch.rand((b, h, n, n), generator=g) < 1 - p
    share = float(keep.float().mean())
    sd = (p * (1 - p) / keep.numel()) ** 0.5
    assert abs(share - (1 - p)) < 3 * sd
    # hstu_mha draws the same mask from a generator of the same seed
    kw = dict(alpha=0.25, num_targets=torch.from_numpy(targets),
              dropout_pr=p)
    a = phstu.hstu_mha(*t, torch.from_numpy(lengths),
                       generator=torch.Generator().manual_seed(3), **kw)
    ref = phstu.hstu_mha(*t, torch.from_numpy(lengths), dropout_keep=keep,
                         **kw)
    torch.testing.assert_close(a, ref, rtol=0, atol=0)


# -- F6: the eval metrics --------------------------------------------------------


def test_f6_dlrm_hstu_eval_metrics_match_jax(tmp_path):
    """F6: the port's DlrmHSTU reports ``auc_is_click`` and
    ``auc_is_like`` over the real candidates, equal to the JAX model's:
    from the same predictions through ``update_metrics``, and through
    ``evaluate`` of the JAX weights on the same rows."""
    n = 64
    jtext = hstu_synth_config_text(n)
    with open(PORT_CONFIG) as f:
        ptext = f.read().replace("batch_size: 128", f"batch_size: {n}")
    _, jmodel, jfeatures, dense, tables = jax_model_and_state(jtext)
    cfg = parse_pipeline_config(ptext)
    model, features = port_main.build_model(cfg, "cpu")
    state = converted_state(jmodel, dense, tables,
                            list(model.embedding_group.tables))
    model.load_state_dict(state)
    cols = synth_cols(n, seed=21)
    jbatch = JaxParser(jfeatures, labels=LABELS).parse_to_batch(cols)
    batch = DataParser(features, labels=LABELS).parse_to_batch(cols)
    jpreds, _ = jax_main.make_eval_step(jmodel, jnp.float32)(
        {"dense": dense, "tables": tables}, jbatch)
    jmetrics, metrics = jmodel.init_metrics(), model.init_metrics()
    jmodel.update_metrics(jmetrics, jpreds, jbatch)
    model.update_metrics(metrics, {k: torch.from_numpy(np.array(v))
                                   for k, v in jpreds.items()}, batch)
    want = jmodel.compute_metrics(jmetrics)
    got = model.compute_metrics(metrics)
    assert list(got) == list(want) == ["auc_is_click", "auc_is_like"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)

    # the entry point, from the JAX weights saved as a state_dict
    data = tmp_path / "eval.parquet"
    import pyarrow as pa

    pq.write_table(pa.table(cols), data)
    ckpt = tmp_path / "jax_weights.pt"
    torch.save(state, ckpt)
    cfg_path = tmp_path / "pipeline.config"
    cfg_path.write_text(ptext.replace(
        "hstu_synth_model/dlrm_hstu", str(tmp_path / "model")))
    result = port_main.evaluate(str(cfg_path), checkpoint_path=str(ckpt),
                                eval_input_path=str(data), device="cpu")
    for k in want:
        np.testing.assert_allclose(result[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# -- the hstu_synth generator and config ---------------------------------------


def test_generate_hstu_writes_the_jax_rows(tmp_path):
    a = port_synthetic.generate_hstu(str(tmp_path / "port.parquet"), 300,
                                     seed=11)
    b = jax_synthetic.generate_hstu(str(tmp_path / "jax.parquet"), 300,
                                    seed=11)
    ta, tb = pq.read_table(a), pq.read_table(b)
    assert ta.column_names == tb.column_names
    assert ta.equals(tb)
    paths = port_synthetic.ensure_hstu_dataset(str(tmp_path / "d"), 64, 32)
    assert pq.read_table(paths["train"]).equals(pq.read_table(
        jax_synthetic.generate_hstu(str(tmp_path / "t.parquet"), 64, 11)))
    assert pq.read_table(paths["eval"]).num_rows == 32


def test_hstu_synth_config_copy_and_label():
    with open(PORT_CONFIG) as f:
        ptext = f.read()
    jpath = os.path.join(REPO, "torcheasyrec_tpu", "benchmark", "configs",
                         "hstu_synth", "dlrm_hstu.config")
    with open(jpath) as f:
        jtext = f.read()
    differ = [(a, b) for a, b in zip(ptext.splitlines(), jtext.splitlines())
              if a != b]
    assert len(ptext.splitlines()) == len(jtext.splitlines())
    assert [a.split(":")[0] for a, _ in differ] == [
        "train_input_path", "eval_input_path", "model_dir"]
    labels = {}
    for pkg in ("torcheasyrec_tpu_torch", "torcheasyrec_tpu"):
        with open(os.path.join(REPO, pkg, "benchmark", "configs",
                               "base_eval_metric.json")) as f:
            labels[pkg] = json.load(f)[
                f"{pkg}/benchmark/configs/hstu_synth/dlrm_hstu.config"]
    assert labels["torcheasyrec_tpu_torch"] == labels["torcheasyrec_tpu"]
    model, _ = port_main.build_model(parse_pipeline_config(ptext), "cpu")
    assert [m["name"] for m in model.init_metrics()] == list(
        labels["torcheasyrec_tpu"]["metrics"])
