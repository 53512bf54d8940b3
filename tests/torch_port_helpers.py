"""Shared helpers of the torcheasyrec_tpu_torch parity tests: one config
text and one set of Arrow columns fed to both packages."""

import numpy as np
import pyarrow as pa
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CONFIG_PATH = "torcheasyrec_tpu/benchmark/configs/hstu_synth/dlrm_hstu.config"
N_USERS, VOCAB, MAX_SEQ, N_CAND = 2000, 5000, 32, 10


def hstu_synth_config_text(batch_size: int = 8, kernel: str = "") -> str:
    """The hstu_synth DLRM-HSTU config (E=128, 32-dim heads, 3 layers,
    seq 32) at ``batch_size``, optionally with ``model_config.kernel``."""
    with open(CONFIG_PATH) as f:
        text = f.read()
    text = text.replace("batch_size: 128", f"batch_size: {batch_size}")
    if kernel:
        text = text.replace("model_config {", f"model_config {{\n  kernel: {kernel}", 1)
    return text


def synth_cols(n: int, seed: int, min_len: int = 1, max_len: int = MAX_SEQ):
    """Kuairand-shaped Arrow columns at the hstu_synth widths, in the
    shape of benchmark/bench_dlrm_hstu._synth_cols."""
    r = np.random.default_rng(seed)
    cols = {
        "user_id": pa.array(r.integers(0, N_USERS, n)),
        "unused_label": pa.array(np.zeros(n, np.float32)),
    }
    lens = r.integers(min_len, max_len + 1, n)
    hists, acts, tss = [], [], []
    for lu in lens:
        hists.append(";".join(map(str, r.integers(0, VOCAB, lu))))
        acts.append(";".join(map(str, r.integers(0, 4, lu))))
        tss.append(";".join(map(str, np.sort(r.integers(0, 10**6, lu)))))
    cands, qts, ws = [], [], []
    for _ in range(n):
        lc = int(r.integers(1, N_CAND + 1))
        cands.append(";".join(map(str, r.integers(0, VOCAB, lc))))
        qts.append(";".join(["1000000"] * lc))
        ws.append(";".join(map(str, r.integers(0, 4, lc))))
    cols["video_id"] = pa.array(hists)
    cols["action_weight"] = pa.array(acts)
    cols["action_timestamp"] = pa.array(tss)
    cols["item_video_id"] = pa.array(cands)
    cols["item_query_time"] = pa.array(qts)
    cols["item_action_weight"] = pa.array(ws)
    return cols


def jax_model_and_state(cfg_text: str):
    """(JAX pipeline config, model, dense params, tables) from one text."""
    from google.protobuf import text_format

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.protos import pipeline_pb2

    cfg = text_format.Parse(cfg_text, pipeline_pb2.EasyRecConfig())
    model, features, _ = jax_main._build_model_and_optim(cfg, None)
    dense, tables, _ = jax_main._init_state(model, cfg)
    return cfg, model, features, dense, tables


def converted_state(jax_model, dense, tables, table_names):
    """The JAX model's weights as a torch state_dict."""
    import jax

    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    eng = jax_model.embedding_group.engine
    canon = {
        name: np.asarray(eng.extract_table(tables, name))
        for name in table_names
    }
    return from_jax_state(jax.device_get(dense), canon)


def hstu_synth_train_config_text(batch_size: int = 4, num_layers: int = 2,
                                 stu_extra: str = "", kernel: str = "",
                                 input_dropout: float = 0.0) -> str:
    """The hstu_synth config cut to ``num_layers`` STU layers for the
    training tests, with the input dropout set explicitly (the proto's
    default is 0.2) and ``stu_extra`` spliced into the STU block."""
    text = hstu_synth_config_text(batch_size, kernel)
    text = text.replace("num_layers: 3", f"num_layers: {num_layers}\n{stu_extra}")
    assert "    hstu {" in text
    return text.replace(
        "    hstu {", f"    hstu {{\n input_dropout_ratio: {input_dropout}", 1)


def jax_train_loss(jmodel, tables, jbatch, training: bool = True):
    """fn(dense) -> (total loss, predictions) of the JAX model's forward
    in training (or eval) mode, for ``jax.value_and_grad``; fp32, the
    dropout ratios 0."""
    import jax
    import jax.numpy as jnp

    from torcheasyrec_tpu.modules import module as JM

    def fn(dense):
        ctx = JM.Context(training=training, rng=jax.random.PRNGKey(0),
                         compute_dtype=jnp.float32)
        grouped, _ = jmodel.embedding_group.forward(
            tables, jbatch, dense["embedding_group"], ctx)
        grouped, vd_losses = jmodel.build_input(dense, grouped, jbatch, ctx)
        preds = jmodel.predict(dense, grouped, jbatch, ctx)
        losses = jmodel.loss(preds, jbatch)
        losses.update(vd_losses)
        return jmodel.total_loss(losses), preds

    return fn


def port_train_loss(model, batch, training: bool = True):
    """(total loss, predictions) of the port's forward in training (or
    eval) mode, the dense parameters' gradients accumulated into
    ``.grad``; the tables take no gradient."""
    eg = model.embedding_group
    model.train(training)
    model.zero_grad()
    with torch.no_grad():
        emb_out, _ = eg.lookup(batch)
    grouped, vd_losses = model.build_input(
        eg.assemble(emb_out, batch, model.compute_dtype), batch)
    preds = model.predict(grouped, batch)
    losses = model.loss(preds, batch)
    losses.update(vd_losses)
    total = model.total_loss(losses)
    total.backward()
    return total.detach(), preds


def assert_forward_and_grads_match(model, batch, jmodel, dense, tables,
                                   jbatch, fwd_tol=1e-5, grad_tol=1e-4,
                                   training: bool = True):
    """The loss and every prediction within ``fwd_tol`` of its max, every
    dense parameter's gradient within ``grad_tol`` of its max, against
    the JAX model at ``dense`` on the same batch. Returns the port's
    predictions."""
    import jax

    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    (jtotal, jpreds), jgrads = jax.jit(jax.value_and_grad(
        jax_train_loss(jmodel, tables, jbatch, training), has_aux=True))(
        dense)
    total, preds = port_train_loss(model, batch, training)
    assert_close_to_max(float(total), float(jtotal), "loss", fwd_tol)
    assert set(preds) == set(jpreds)
    for k, v in preds.items():
        assert_close_to_max(v.detach().float().numpy(), np.asarray(jpreds[k]),
                            k, fwd_tol)
    ref = from_jax_state(jax.device_get(jgrads), {})
    params = dict(model.named_parameters())
    assert set(params) == {k for k in ref if "tables." not in k}
    for n, p in params.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert_close_to_max(got.numpy(), ref[n].numpy(), f"grad {n}",
                            grad_tol)
    return preds


def jax_train_setup(cfg_text: str):
    """(cfg, model, features, state, jitted train step) of the JAX
    package in fp32; the state holds dense, tables, sparse_opt,
    dense_opt and step."""
    import jax
    import jax.numpy as jnp
    from google.protobuf import text_format

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.optim.optimizer_builder import (
        create_dense_optimizer,
    )
    from torcheasyrec_tpu.protos import pipeline_pb2

    cfg = text_format.Parse(cfg_text, pipeline_pb2.EasyRecConfig())
    model, features, sparse_sched = jax_main._build_model_and_optim(cfg, None)
    dense, tables, sparse_opt = jax_main._init_state(model, cfg)
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer, dense)
    state = {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
             "dense_opt": tx.init(dense), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jax_main.make_train_step(
        model, tx, sparse_sched, dense_sched, jnp.float32))
    return cfg, model, features, state, step


def jax_options_setup(cfg_text: str):
    """(cfg, model, features, state, jitted train step) of the JAX package
    with the train config's options as its ``train_and_evaluate`` sets
    them up: the compute dtype, the grad clipper chained before the
    dense optimizer, the accumulated gradients and the grad scaler's
    state (FP16 only)."""
    import jax
    import jax.numpy as jnp
    import optax
    from google.protobuf import text_format

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu.optim.optimizer_builder import (
        create_dense_optimizer,
        create_grad_clipper,
    )
    from torcheasyrec_tpu.protos import pipeline_pb2

    cfg = text_format.Parse(cfg_text, pipeline_pb2.EasyRecConfig())
    tc = cfg.train_config
    model, features, sparse_sched = jax_main._build_model_and_optim(cfg, None)
    dense, tables, sparse_opt = jax_main._init_state(model, cfg)
    tx, dense_sched = create_dense_optimizer(tc.dense_optimizer, dense)
    if tc.HasField("grad_clipping"):
        clipper = create_grad_clipper(tc.grad_clipping)
        if clipper is not None:
            tx = optax.chain(clipper, tx)
    compute_dtype = jax_main._compute_dtype(tc)
    accum = int(tc.gradient_accumulation_steps or 1)
    scaler_cfg = tc.grad_scaler if tc.HasField("grad_scaler") else None
    state = {"dense": dense, "tables": tables, "sparse_opt": sparse_opt,
             "dense_opt": tx.init(dense), "step": jnp.zeros((), jnp.int32)}
    if accum > 1:
        state["accum_grads"] = jax.tree_util.tree_map(jnp.zeros_like, dense)
    if scaler_cfg is not None and compute_dtype == jnp.float16:
        state["scaler"] = {"scale": jnp.float32(scaler_cfg.init_scale),
                           "good_steps": jnp.int32(0)}
    step = jax.jit(jax_main.make_train_step(
        model, tx, sparse_sched, dense_sched, compute_dtype,
        grad_accum_steps=accum, grad_scaler_cfg=scaler_cfg))
    return cfg, model, features, state, step


def port_options_setup(cfg_text: str, jax_model, jax_state, table_names,
                       **engine_options):
    """(model, features, tx, state, train step) of the port on the CPU
    with the train config's options, from the weights of a JAX state."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(cfg_text)
    tc = cfg.train_config
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cpu", for_train=True, **engine_options)
    model.load_state_dict(converted_state(
        jax_model, jax_state["dense"], jax_state["tables"], table_names))
    tx, dense_sched = port_main._dense_optimizer(model, tc)
    accum = int(tc.gradient_accumulation_steps or 1)
    scaler_cfg = tc.grad_scaler if tc.HasField("grad_scaler") else None
    state = port_main._init_state(model, tx, accum, scaler_cfg)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched,
                                     accum, scaler_cfg)
    return model, features, tx, state, step


class PairedTrainers:
    """The JAX package's train step and the port's from one config text
    and the same weights (``jax_options_setup``, ``port_options_setup``),
    fed the same Arrow columns by ``step``."""

    def __init__(self, cfg_text: str, table_names, labels,
                 **engine_options) -> None:
        from torcheasyrec_tpu.datasets.data_parser import (
            DataParser as JaxParser,
        )
        from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

        (_, self.jmodel, jfeatures, self.jstate,
         self._jstep) = jax_options_setup(cfg_text)
        (self.model, features, self.tx, self.state,
         self._step) = port_options_setup(cfg_text, self.jmodel, self.jstate,
                                          table_names, **engine_options)
        self.table_names = table_names
        self._jparser = JaxParser(jfeatures, labels=labels)
        self._parser = DataParser(features, labels=labels)

    def step(self, cols):
        """One step of each on ``cols``: (JAX metrics, port metrics)."""
        import jax

        self.jstate, jmetrics, _ = self._jstep(
            self.jstate, self._jparser.parse_to_batch(cols),
            jax.random.key(0))
        self.state, metrics = self._step(
            self.state, self._parser.parse_to_batch(cols))
        return jmetrics, metrics

    def assert_close(self, tol, param_tol=None, table_tol=None):
        assert_state_matches_jax(self.model, self.state, self.jmodel,
                                 self.jstate, self.table_names, tol,
                                 param_tol, table_tol)


def assert_close_to_max(got, ref, name, tol):
    """max |got - ref| <= tol * max |ref| (float64)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


def assert_state_matches_jax(model, state, jax_model, jax_state,
                             table_names, tol, param_tol=None,
                             table_tol=None):
    """Dense parameters (within ``param_tol``, else ``tol``), tables
    (``table_tol``, else ``tol``) and the sparse optimizer state of every
    table (``tol``) of the port, each relative to the max of the JAX
    package's tensor."""
    import jax

    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    eng = jax_model.embedding_group.engine
    jtables = {n: np.asarray(eng.extract_table(jax_state["tables"], n),
                             np.float32) for n in table_names}
    ref = from_jax_state(jax.device_get(jax_state["dense"]), jtables)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for name, r in ref.items():
        assert_close_to_max(
            sd[name].float().numpy(), r.numpy(), name,
            (table_tol or tol) if "tables." in name else param_tol or tol)
    peng = model.embedding_group.engine
    fused = model.embedding_group.engine_tables()
    for n in table_names:
        jst = eng.extract_table_state(jax_state["tables"],
                                      jax_state["sparse_opt"], n)
        pst = peng.extract_table_state(fused, state["sparse_opt"], n)
        assert set(jst) == set(pst), n
        for k, v in jst.items():
            v = np.asarray(v)
            assert_close_to_max(pst[k].float().numpy().reshape(v.shape), v,
                                f"{n}.{k}", tol)


# --- DeepFM on Criteo-shaped data, at a small size --------------------------
DEEPFM_BUCKETS = (3000, 50, 7, 2000, 120, 3)
DEEPFM_N_DENSE = 3


DEEPFM_DENSE_OPT = ("adam_optimizer { lr: 0.01 }"
                    " constant_learning_rate {}")


def deepfm_config_text(batch_size: int = 64, buckets=DEEPFM_BUCKETS,
                       emb_dim: int = 8, sparse_opt: str =
                       "rowwise_adagrad_optimizer { lr: 0.05 }",
                       model_dir: str = "unused", num_steps: int = 0,
                       mixed_precision: str = "",
                       dense_opt: str = DEEPFM_DENSE_OPT,
                       train_extra: str = "", feature_extra: str = "",
                       wide_extra: str = "") -> str:
    """The Criteo DeepFM config of the repo's train benchmark (WIDE, fm
    and deep groups over the same id features, dense features in deep,
    deep and final MLPs, BCE, AUC) with small tables and narrow MLPs.
    ``dense_opt`` is the dense optimizer block's body, ``train_extra``
    more train_config fields, ``feature_extra`` more fields of every
    id_feature and ``wide_extra`` of the deepfm block."""
    lines = [
        'train_input_path: "unused"',
        'eval_input_path: "unused"',
        f'model_dir: "{model_dir}"',
        "train_config {",
        f"  sparse_optimizer {{ {sparse_opt} constant_learning_rate {{}} }}",
        f"  dense_optimizer {{ {dense_opt} }}",
        f"  num_steps: {num_steps}" if num_steps else "  num_epochs: 1",
        f'  mixed_precision: "{mixed_precision}"',
        train_extra,
        "}",
        "data_config {",
        f"  batch_size: {batch_size}",
        "  dataset_type: ParquetDataset",
        "  fg_mode: FG_NONE",
        '  label_fields: "label"',
        "}",
    ]
    for i in range(DEEPFM_N_DENSE):
        lines.append(
            f'feature_configs {{ raw_feature {{ feature_name: "int_{i}" }} }}')
    for i, n in enumerate(buckets):
        lines.append(
            f'feature_configs {{ id_feature {{ feature_name: "cat_{i}" '
            f"num_buckets: {n} embedding_dim: {emb_dim} {feature_extra}}} }}")
    cat_names = "".join(
        f'    feature_names: "cat_{i}"\n' for i in range(len(buckets)))
    int_names = "".join(
        f'    feature_names: "int_{i}"\n' for i in range(DEEPFM_N_DENSE))
    lines.append(
        "model_config {\n"
        '  feature_groups {\n    group_name: "wide"\n' + cat_names +
        "    group_type: WIDE\n  }\n"
        '  feature_groups {\n    group_name: "fm"\n' + cat_names +
        "    group_type: DEEP\n  }\n"
        '  feature_groups {\n    group_name: "deep"\n' + cat_names + int_names +
        "    group_type: DEEP\n  }\n"
        "  deepfm {\n"
        "    deep { hidden_units: [32, 16] }\n"
        "    final { hidden_units: [16, 8] }\n"
        f"    wide_embedding_dim: 4 {wide_extra}\n"
        "  }\n"
        "  num_class: 1\n"
        "  losses { binary_cross_entropy {} }\n"
        "  metrics { auc {} }\n"
        "}")
    return "\n".join(lines)


def deepfm_table_names(buckets=DEEPFM_BUCKETS):
    return ([f"cat_{i}_emb" for i in range(len(buckets))]
            + [f"cat_{i}_emb__wide" for i in range(len(buckets))])


def deepfm_cols(n: int, seed: int, buckets=DEEPFM_BUCKETS):
    """Criteo-shaped Arrow columns whose label depends on the features:
    a fixed random score per id of the two small tables plus one dense
    feature decides the click probability."""
    r = np.random.default_rng(seed)
    w = np.random.default_rng(1234)  # the same hidden scores for every seed
    score_1 = w.normal(size=buckets[1])
    score_4 = w.normal(size=buckets[4])
    cats = [r.integers(0, b, n) for b in buckets]
    ints = [r.normal(size=n).astype(np.float32)
            for _ in range(DEEPFM_N_DENSE)]
    logit = 1.5 * score_1[cats[1]] + score_4[cats[4]] + ints[0]
    label = (r.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    cols = {"label": pa.array(label)}
    for i, v in enumerate(ints):
        cols[f"int_{i}"] = pa.array(v)
    for i, v in enumerate(cats):
        cols[f"cat_{i}"] = pa.array(v)
    return cols


# --- the Criteo ranking and multi-task zoo, at a small size ----------------
# narrowed copies of the criteo_synth configs: 6 id features (tables on
# both sides of ZOO_DENSE_LANE), 3 raw features, batch 64, MLPs of 8-32
ZOO_BUCKETS = (500, 50, 7, 300, 120, 3)
ZOO_N_DENSE = 3
ZOO_EMB_DIM = 8
ZOO_DENSE_LANE = 100  # the tables of more rows take the sorted row write
ZOO_GROUPING_KEY = "cat_1"
# the sequence configs' target item and click history, one table
ZOO_ITEMS, ZOO_SEQ_LEN = 200, 6
ZOO_SESSION_KEY = "cat_2"  # jrc_loss's sessions: 7 ids

_CATS = [f"cat_{i}" for i in range(len(ZOO_BUCKETS))]
_INTS = [f"int_{i}" for i in range(ZOO_N_DENSE)]


def _group(name, feats, kind="DEEP"):
    names = "".join(f'    feature_names: "{f}"\n' for f in feats)
    return (f'  feature_groups {{\n    group_name: "{name}"\n{names}'
            f"    group_type: {kind}\n  }}\n")


_RANK_HEAD = (
    "  num_class: 1\n  losses { binary_cross_entropy {} }\n"
    "  metrics { auc {} }\n"
    f'  metrics {{ grouped_auc {{ grouping_key: "{ZOO_GROUPING_KEY}" }} }}\n')


def _seq_group(encoders: str = "") -> str:
    return ('  feature_groups {\n    group_name: "seq"\n'
            '    feature_names: "tgt_item"\n    feature_names: "click_seq"\n'
            f"    group_type: SEQUENCE\n{encoders}  }}\n")


_DIN_MLP = "attn_mlp { hidden_units: [16, 8] }"


def _tasks(relation: str = "",
           ctr_loss: str = "losses { binary_cross_entropy {} }") -> str:
    return (
        '  task_towers { tower_name: "ctr" label_name: "label"\n'
        "    mlp { hidden_units: [16, 8] }\n"
        f"    {ctr_loss} metrics {{ auc {{}} }}\n"
        f'    metrics {{ grouped_auc {{ grouping_key: "{ZOO_GROUPING_KEY}" '
        "} } }\n"
        '  task_towers { tower_name: "cvr" label_name: "conversion"\n'
        f"{relation}"
        "    mlp { hidden_units: [16, 8] } weight: 0.5\n"
        "    losses { binary_cross_entropy {} } metrics { auc {} } }\n")


_DBMTL = ("    bottom_mlp { hidden_units: [32] }\n"
          "    expert_mlp { hidden_units: [32, 16] }\n    num_expert: 3\n"
          + _tasks('    relation_tower_names: "ctr"\n'
                   "    relation_mlp { hidden_units: [8] }\n"))
_MASK = ("n_mask_blocks: 3 mask_block { hidden_dim: 32 aggregation_dim: 16 }"
         " top_mlp { hidden_units: [32, 16] }")

# model key -> (groups, model block, head); the key names the parity case
ZOO_MODELS = {
    "wide_and_deep": (
        _group("wide", _CATS, "WIDE") + _group("fm", _CATS)
        + _group("deep", _CATS + _INTS),
        "wide_and_deep { deep { hidden_units: [32, 16] }"
        " final { hidden_units: [16, 8] } wide_embedding_dim: 4 }",
        _RANK_HEAD),
    "dlrm": (
        _group("sparse", _CATS) + _group("dense", _INTS),
        "dlrm { dense_mlp { hidden_units: [16, 8] }"
        " final { hidden_units: [32, 16] } }", _RANK_HEAD),
    "dcn_v1": (
        _group("all", _CATS + _INTS),
        "dcn_v1 { cross { cross_num: 2 } deep { hidden_units: [32, 16] }"
        " final { hidden_units: [16, 8] } }", _RANK_HEAD),
    "dcn_v2": (
        _group("all", _CATS + _INTS),
        "dcn_v2 { backbone { hidden_units: [32] }"
        " cross { cross_num: 3 low_rank: 8 } deep { hidden_units: [32, 16] }"
        " final { hidden_units: [16, 8] } }", _RANK_HEAD),
    "mask_net": (
        _group("all", _CATS + _INTS),
        f"mask_net {{ mask_net_module {{ {_MASK} }} }}", _RANK_HEAD),
    "mask_net_serial": (
        _group("all", _CATS + _INTS),
        "mask_net { mask_net_module { n_mask_blocks: 2 use_parallel: false"
        " mask_block { hidden_dim: 16 reduction_ratio: 0.5 }"
        " top_mlp { hidden_units: [16] } } }", _RANK_HEAD),
    "simple_multi_task": (
        _group("all", _CATS + _INTS),
        "simple_multi_task {\n" + _tasks() + "}", ""),
    "mmoe": (
        _group("all", _CATS + _INTS),
        "mmoe {\n    expert_mlp { hidden_units: [32, 16] }\n"
        "    gate_mlp { hidden_units: [8] }\n    num_expert: 3\n"
        + _tasks() + "}", ""),
    "ple": (
        _group("all", _CATS + _INTS),
        "ple {\n"
        '    extraction_networks { network_name: "l1"\n'
        "      expert_num_per_task: 2 share_num: 2\n"
        "      task_expert_net { hidden_units: [32, 16] }\n"
        "      share_expert_net { hidden_units: [32, 16] } }\n"
        '    extraction_networks { network_name: "l2"\n'
        "      expert_num_per_task: 1 share_num: 1\n"
        "      task_expert_net { hidden_units: [16] } }\n"
        + _tasks() + "}", ""),
    "dbmtl": (_group("all", _CATS + _INTS), "dbmtl {\n" + _DBMTL + "}", ""),
    "dbmtl_masknet": (
        _group("all", _CATS + _INTS),
        f"dbmtl {{\n    mask_net {{ {_MASK} }}\n" + _DBMTL + "}", ""),
}

# the sequence layer and the rest of the criteo_synth zoo; apart from
# ZOO_MODELS, whose parity tests take every output as [B]
ZOO_SEQ_MODELS = {
    # a DEEP group with a nested sequence group and two encoders on it
    "multi_tower": (
        _group("user", _CATS[:3]).replace(
            "    group_type: DEEP\n",
            '    group_type: DEEP\n    sequence_groups { group_name: "hist"\n'
            '      feature_names: "tgt_item" feature_names: "click_seq" }\n'
            f'    sequence_encoders {{ din_encoder {{ input: "hist" '
            f"{_DIN_MLP} }} }}\n"
            '    sequence_encoders { pooling_encoder { input: "hist"'
            ' pooling_type: "sum" } }\n')
        + _group("item", _CATS[3:] + _INTS),
        'multi_tower { towers { input: "user" mlp { hidden_units: [16] } }'
        ' towers { input: "item" mlp { hidden_units: [16, 8] } }'
        " final { hidden_units: [16, 8] } }", _RANK_HEAD),
    "multi_tower_din": (
        _group("all", _CATS + _INTS) + _seq_group(),
        'multi_tower_din { towers { input: "all" mlp { hidden_units: [32, 16] } }'
        f' din_towers {{ input: "seq" {_DIN_MLP} }}'
        " final { hidden_units: [16, 8] } }", _RANK_HEAD),
    "rocket_launching": (
        _group("all", _CATS + _INTS),
        "rocket_launching { share_mlp { hidden_units: [32] }"
        " booster_mlp { hidden_units: [16, 8] } light_mlp { hidden_units: [6] }"
        " feature_based_distillation: true }", _RANK_HEAD),
    "rocket_launching_logits": (
        _group("all", _CATS + _INTS),
        "rocket_launching { booster_mlp { hidden_units: [16, 8] }"
        " light_mlp { hidden_units: [8] } }", _RANK_HEAD),
    # the DIN encoder on the SEQUENCE group is never built (the JAX
    # package's behaviour): MMoE reads the "all" group only
    "mmoe_has_sequence": (
        _group("all", _CATS + _INTS) + _seq_group(
            f'    sequence_encoders {{ din_encoder {{ input: "seq" '
            f"{_DIN_MLP} }} }}\n"),
        "mmoe {\n    expert_mlp { hidden_units: [32, 16] }\n    num_expert: 3\n"
        + _tasks() + "}", ""),
    "dbmtl_jrc": (
        _group("all", _CATS + _INTS),
        "dbmtl {\n    bottom_mlp { hidden_units: [32] }\n"
        "    expert_mlp { hidden_units: [32, 16] }\n    num_expert: 3\n"
        + _tasks('    relation_tower_names: "ctr"\n'
                 "    relation_mlp { hidden_units: [8] }\n",
                 "num_class: 2\n    losses { jrc_loss { session_name: "
                 f'"{ZOO_SESSION_KEY}" }} }}')
        + "}", ""),
}


# the rest of the ranking and multi-task zoo, narrowed from the
# criteo_synth-shaped configs of chip_smoke.py's train_zoo_rest phase;
# dropout ratios 0 (the intervention's default is 0.1)
_WUKONG_LAYER = ("wukong_layers {{ lcb_feature_num: {lcb} fmb_feature_num: 6"
                 " compressed_feature_num: 3"
                 " feature_num_mlp {{ hidden_units: [16] }} }}")
ZOO_REST_MODELS = {
    "xdeepfm": (
        _group("wide", _CATS, "WIDE") + _group("fm", _CATS)
        + _group("deep", _CATS + _INTS),
        "xdeepfm { cin { cin_layer_size: [8, 6, 4] }"
        " deep { hidden_units: [32, 16] use_bn: true }"
        " final { hidden_units: [16, 8] } wide_embedding_dim: 4 }",
        _RANK_HEAD),
    # 6 sparse features and the dense MLP's 2: the first layer projects
    # its residual to 10 features, the second keeps them
    "wukong": (
        _group("sparse", _CATS) + _group("dense", _INTS),
        "wukong { dense_mlp { hidden_units: [16] } "
        + _WUKONG_LAYER.format(lcb=4) + " " + _WUKONG_LAYER.format(lcb=4)
        + ' final { hidden_units: [16, 8] activation: "nn.PReLU" } }',
        _RANK_HEAD + "  variational_dropout { regularization_lambda: 0.01 }\n"),
    "pepnet": (
        _group("all", _CATS + _INTS) + _group("domain", ["cat_5", "cat_2"])
        + _group("ppnet", ["cat_0", "cat_3"]),
        "pepnet {\n    epnet_hidden_unit: 16\n"
        "    ppnet_hidden_units: [16, 8]\n" + _tasks() + "}",
        "  use_pareto_loss_weight: true\n"),
    "dc2vr": (
        _group("all", _CATS + _INTS),
        "dc2vr {\n"
        '    bottom_mlp { hidden_units: [32] activation: "nn.Dice" }\n'
        "    expert_mlp { hidden_units: [16, 8] }\n    num_expert: 2\n"
        '  task_towers { tower_name: "ctr" label_name: "label"\n'
        "    mlp { hidden_units: [8] } low_rank_dim: 4 dropout_ratio: 0.0\n"
        "    losses { binary_cross_entropy {} } metrics { auc {} } }\n"
        '  task_towers { tower_name: "cvr" label_name: "conversion"\n'
        '    mlp { hidden_units: [8] } intervention_tower_names: "ctr"\n'
        "    low_rank_dim: 4 dropout_ratio: 0.0\n"
        '    task_space_indicator_label: "label" out_task_space_weight: 0.1\n'
        "    losses { binary_cross_entropy {} } metrics { auc {} } }\n"
        "}", ""),
}


def _zoo_spec(model: str):
    for specs in (ZOO_MODELS, ZOO_SEQ_MODELS, ZOO_REST_MODELS):
        if model in specs:
            return specs[model]
    raise KeyError(model)


def zoo_config_text(model: str, batch_size: int = 64,
                    model_dir: str = "unused", num_steps: int = 0,
                    train_path: str = "unused", eval_path: str = "unused",
                    train_extra: str = "") -> str:
    """The criteo_synth config of ``model`` (a ``ZOO_MODELS`` or
    ``ZOO_SEQ_MODELS`` key) at the small size, fp32, labels ``label`` and
    ``conversion``."""
    groups, block, head = _zoo_spec(model)
    lines = [
        f'train_input_path: "{train_path}"',
        f'eval_input_path: "{eval_path}"',
        f'model_dir: "{model_dir}"',
        "train_config {",
        "  sparse_optimizer { rowwise_adagrad_optimizer { lr: 0.01 }"
        " constant_learning_rate {} }",
        "  dense_optimizer { adam_optimizer { lr: 0.001 }"
        " constant_learning_rate {} }",
        f"  num_steps: {num_steps}" if num_steps else "  num_epochs: 1",
        train_extra,
        "}",
        "data_config {",
        f"  batch_size: {batch_size}",
        "  dataset_type: ParquetDataset",
        "  fg_mode: FG_NONE",
        '  label_fields: "label"',
        '  label_fields: "conversion"',
        "}",
    ]
    lines += [f'feature_configs {{ raw_feature {{ feature_name: "{f}" }} }}'
              for f in _INTS]
    lines += [f'feature_configs {{ id_feature {{ feature_name: "cat_{i}" '
              f"num_buckets: {n} embedding_dim: {ZOO_EMB_DIM} }} }}"
              for i, n in enumerate(ZOO_BUCKETS)]
    if "click_seq" in groups:
        lines += [
            'feature_configs { id_feature { feature_name: "tgt_item" '
            f"num_buckets: {ZOO_ITEMS} embedding_dim: {ZOO_EMB_DIM} "
            'embedding_name: "item_emb" } }',
            'feature_configs { sequence_id_feature { feature_name: '
            f'"click_seq" num_buckets: {ZOO_ITEMS} embedding_dim: '
            f"{ZOO_EMB_DIM} sequence_length: {ZOO_SEQ_LEN} "
            'embedding_name: "item_emb" } }']
    lines.append("model_config {\n" + groups + "  " + block + "\n" + head
                 + "}")
    return "\n".join(lines)


def zoo_table_names(model: str):
    names = [f"cat_{i}_emb" for i in range(len(ZOO_BUCKETS))]
    if model in ("wide_and_deep", "xdeepfm"):
        names += [f"{n}__wide" for n in names]
    if "click_seq" in _zoo_spec(model)[0]:
        names.append("item_emb")
    return names


def zoo_cols(n: int, seed: int):
    """``deepfm_cols`` at the zoo's buckets, with a ``conversion`` label
    that fires only on clicks, more often for some ids of ``cat_4``."""
    cols = deepfm_cols(n, seed, ZOO_BUCKETS)
    r = np.random.default_rng(seed + 7)
    w = np.random.default_rng(4321).normal(size=ZOO_BUCKETS[4])
    p = 1.0 / (1.0 + np.exp(-(w[cols["cat_4"].to_numpy()] - 0.5)))
    cols["conversion"] = pa.array(
        (cols["label"].to_numpy() * (r.random(n) < p)).astype(np.float32))
    # histories of 0 to ZOO_SEQ_LEN + 2 items (cut to ZOO_SEQ_LEN)
    cols["tgt_item"] = pa.array(r.integers(0, ZOO_ITEMS, n))
    cols["click_seq"] = pa.array([
        ";".join(map(str, r.integers(0, ZOO_ITEMS, k)))
        for k in r.integers(0, ZOO_SEQ_LEN + 3, n)])
    return cols


# --- DeepFM with ZCH, dynamicemb and host-offloaded tables ----------------
# cat_0/1/3: zch under the three policies (cat_3 at eviction interval 2);
# cat_4: dynamicemb (the spill tier); cat_5: dynamicemb with frequency
# admission; cat_2 host_offload. The sizes sit below each feature's id
# space, so eviction, spill and readmission all happen in a few steps.
ZCH_FEATURES = {
    0: "zch { zch_size: 256 lfu {} }",
    1: "zch { zch_size: 40 distance_lfu { decay_exponent: 1.0 } }",
    3: "zch { zch_size: 200 lru { decay_exponent: 0.8 } "
       "eviction_interval: 2 }",
    4: 'dynamicemb { max_capacity: 64 score_strategy: "STEP" }',
    5: 'dynamicemb { max_capacity: 3 score_strategy: "LFU" '
       "frequency_admission_strategy { threshold: 2 } }",
}
HOST_OFFLOAD_FEATURES = (2,)


def zch_deepfm_config_text(train: str = "unused", evalp: str = "unused",
                           **kw) -> str:
    """``deepfm_config_text`` with ``ZCH_FEATURES`` in place of their
    ``num_buckets`` and ``HOST_OFFLOAD_FEATURES`` host-offloaded."""
    text = deepfm_config_text(**kw)
    for i, n in enumerate(DEEPFM_BUCKETS):
        old = f'feature_name: "cat_{i}" num_buckets: {n}'
        if i in ZCH_FEATURES:
            text = text.replace(old,
                                f'feature_name: "cat_{i}" {ZCH_FEATURES[i]}')
        elif i in HOST_OFFLOAD_FEATURES:
            text = text.replace(old, old + " embedding_constraints { "
                                'sharding_types: "host_offload" }')
    return (text.replace('train_input_path: "unused"',
                         f'train_input_path: "{train}"')
            .replace('eval_input_path: "unused"',
                     f'eval_input_path: "{evalp}"'))
