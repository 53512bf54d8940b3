"""Every metric of the port against the JAX package's, on the host, from
the same numpy predictions, labels and grouping keys over uneven updates.

XAUC and GroupedXAUC draw their pairs from ``np.random.default_rng(0)``
in both packages: their values must be equal. The other metrics are the
same float64 formulas: within 1e-6 relative (in practice equal). The
train metrics' decayed running value (``TrainMetricWrapper``) is held
the same way, and so are the names ``create_metric`` gives and those a
model's ``init_train_metrics`` gives."""

import numpy as np
import pytest
from google.protobuf import text_format

from torch_port_helpers import deepfm_config_text, zoo_config_text
from torcheasyrec_tpu import metrics as jax_metrics
from torcheasyrec_tpu.protos import metric_pb2 as jax_metric_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch import metrics as port_metrics
from torcheasyrec_tpu_torch.protos import metric_pb2
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

N = 700
SPLITS = (0, 13, 300, 301, N)


def _data(kind: str, seed: int):
    """(preds, labels, keys) of one metric's input kind."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, 9, N)
    if kind == "multiclass":
        logits = r.normal(size=(N, 4))
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return p.astype(np.float32), r.integers(0, 4, N).astype(
            np.float32), keys
    if kind == "continuous":  # XAUC's watch times, with ties
        y = np.round(r.exponential(3.0, N), 1).astype(np.float32)
        return (y + r.normal(0, 2, N)).astype(np.float32), y, keys
    p = r.random(N).astype(np.float32)
    return p, (r.random(N) < p).astype(np.float32), keys


# metric config text -> input kind
CASES = {
    "auc {}": "binary",
    "multiclass_auc {}": "multiclass",
    'multiclass_auc { average: "weighted" }': "multiclass",
    'grouped_auc { grouping_key: "k" }': "binary",
    "xauc {}": "continuous",
    "xauc { sample_ratio: 0.01 }": "continuous",
    "xauc { sample_ratio: 0.5 max_pairs: 3000 }": "continuous",
    'grouped_xauc { grouping_key: "k" }': "continuous",
    "normalized_entropy {}": "binary",
    "recall_at_k { top_k: 2 }": "multiclass",
    "accuracy {}": "binary",
    "accuracy { threshold: 0.3 }": "binary",
    "accuracy { top_k: 2 }": "multiclass",
    "mean_absolute_error {}": "continuous",
    "mean_squared_error {}": "continuous",
}


def _both(text: str):
    port = port_metrics.create_metric(
        text_format.Parse(text, metric_pb2.MetricConfig()))
    ref = jax_metrics.create_metric(
        text_format.Parse(text, jax_metric_pb2.MetricConfig()))
    return port, ref


@pytest.mark.parametrize("text", sorted(CASES))
def test_metric_matches_jax(text):
    port, ref = _both(text)
    assert port["name"] == ref["name"]
    assert port["config"] == ref["config"]
    preds, labels, keys = _data(CASES[text], seed=len(text))
    for a, b in zip(SPLITS[:-1], SPLITS[1:]):
        for m in (port["metric"], ref["metric"]):
            m.update(preds[a:b], labels[a:b], grouping_key=keys[a:b])
    got, want = port["metric"].compute(), ref["metric"].compute()
    assert np.isfinite(want)
    if "xauc" in text:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    port["metric"].reset()
    port["metric"].update(preds[:50], labels[:50], grouping_key=keys[:50])
    ref["metric"].reset()
    ref["metric"].update(preds[:50], labels[:50], grouping_key=keys[:50])
    np.testing.assert_allclose(port["metric"].compute(),
                               ref["metric"].compute(), rtol=1e-6)


@pytest.mark.parametrize("pairs", [1, 7, 10 ** 6])
def test_grouped_xauc_pairs_per_group_matches_jax(pairs):
    """``max_pairs_per_group`` from the config: the JAX package's
    ``create_metric`` hands the uint64 on as a string its compute cannot
    take, so the reference here is its class built with the number."""
    port = port_metrics.create_metric(text_format.Parse(
        f'grouped_xauc {{ grouping_key: "k" max_pairs_per_group: {pairs} }}',
        metric_pb2.MetricConfig()))["metric"]
    ref = jax_metrics.GroupedXAUC("k", max_pairs_per_group=pairs)
    preds, labels, keys = _data("continuous", seed=pairs)
    for m in (port, ref):
        m.update(preds, labels, grouping_key=keys)
    assert port.compute() == ref.compute()


@pytest.mark.parametrize("decay_step", [1, 3, 50])
@pytest.mark.parametrize("text", ["auc {}", "mean_squared_error {}",
                                  "xauc { sample_ratio: 0.1 }"])
def test_train_metric_wrapper_matches_jax(text, decay_step):
    port, ref = _both(text)
    wrapped = port_metrics.TrainMetricWrapper(port["metric"], 0.8,
                                              decay_step)
    jwrapped = jax_metrics.TrainMetricWrapper(ref["metric"], 0.8, decay_step)
    preds, labels, keys = _data("continuous" if "xauc" in text or "mean" in
                                text else "binary", seed=decay_step)
    for i in range(0, N, 64):
        for m in (wrapped, jwrapped):
            m.update(preds[i:i + 64], labels[i:i + 64])
        got, want = wrapped.compute(), jwrapped.compute()
        if np.isnan(want):
            assert np.isnan(got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_empty_metrics():
    ne = port_metrics.NormalizedEntropy()
    assert np.isnan(ne.compute())
    assert port_metrics.MeanAbsoluteError().compute() == 0.0
    # one class only: no group has a positive and a negative
    g = port_metrics.GroupedXAUC("k")
    g.update(np.ones(4), np.ones(4), grouping_key=np.arange(4))
    assert np.isnan(g.compute())


@pytest.mark.parametrize("model", ["deepfm", "mmoe"])
def test_init_train_metrics_names(model):
    """A model's train metrics: the config's, each in a
    TrainMetricWrapper with its decay, named as the JAX package names
    them (per tower for the multi-task models)."""
    extra = ("  train_metrics { auc {} decay_rate: 0.5 decay_step: 7 }\n"
             "  train_metrics { mean_squared_error {} }\n")
    if model == "deepfm":
        text = deepfm_config_text().replace(
            "  metrics { auc {} }", "  metrics { auc {} }\n" + extra)
        want = ["auc", "mean_squared_error"]
    else:
        text = zoo_config_text("mmoe").replace(
            "metrics { auc {} } }", "metrics { auc {} }\n" + extra + "}")
        want = ["auc_cvr", "mean_squared_error_cvr"]
    m, _ = port_main.build_model(parse_pipeline_config(text), "cpu")
    got = m.init_train_metrics()
    assert [x["name"] for x in got] == want
    assert all(isinstance(x["metric"], port_metrics.TrainMetricWrapper)
               for x in got)
    assert got[0]["metric"]._decay_step == 7
    assert got[1]["metric"]._decay_step == 100
