"""The port's KafkaReader (datasets/kafka_dataset.py) against the JAX
package's, on one in-memory topic: the fake librdkafka consumer of
tests/test_kafka_dataset.py (its classes copied here, that module not
imported), installed as ``confluent_kafka`` for each test.

- The same record batches and checkpoint columns from both readers: a
  two-partition stream, a resume at offset + 1, a resume across a
  compacted topic's offset gap, a ``start_ts`` seek, broker errors and
  bad JSON skipped. Every test takes a fixed number of batches: the
  readers poll forever.
- Without ``confluent_kafka`` both raise ImportError at construction.
- Several workers: the JAX reader ignores its worker id and count, so
  each of two workers reads every message; the port's reader and loader
  refuse more than one (ROADMAP §3).
- A DeepFM trained from the topic through ``train_and_evaluate``: the
  checkpoint's watermark holds the last offset per partition, and a
  ``continue_train`` resumes at offset + 1, bit-equal to the straight
  run.
"""

import json
import sys
import time
import types

import pytest
import torch

from torcheasyrec_tpu.datasets import kafka_dataset as jax_kafka
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets import kafka_dataset
from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
from torcheasyrec_tpu_torch.utils import checkpoint_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

from torch_port_helpers import deepfm_cols, deepfm_config_text

_OFFSET_INVALID = -1001


class _FakeMessage:
    def __init__(self, partition, offset, ts_ms, value):
        self._p, self._o, self._ts, self._v = partition, offset, ts_ms, value

    def error(self):
        return None

    def value(self):
        return self._v

    def timestamp(self):
        return (1, self._ts)

    def partition(self):
        return self._p

    def offset(self):
        return self._o


class _ErrMessage(_FakeMessage):
    def error(self):
        return types.SimpleNamespace(code=lambda: 3,
                                     str=lambda: "_PARTITION_EOF")


class _FakeTopicPartition:
    def __init__(self, topic, partition, offset=_OFFSET_INVALID):
        self.topic, self.partition, self.offset = topic, partition, offset


class _FakeConsumer:
    """Round-robin in-memory consumer over {partition: [(off, ts, val)]}."""

    topics = {}
    with_errors = False

    def __init__(self, conf):
        self.conf = conf
        self.assigned = []
        self.closed = False
        self._cursors = {}

    def list_topics(self, topic, timeout=None):
        parts = {p: None for p in type(self).topics[topic]}
        return types.SimpleNamespace(
            topics={topic: types.SimpleNamespace(partitions=parts)})

    def offsets_for_times(self, tps, timeout=None):
        out = []
        for tp in tps:
            msgs = type(self).topics[tp.topic][tp.partition]
            off = next((o for o, ts, _ in msgs if ts >= tp.offset),
                       msgs[-1][0] + 1)
            out.append(_FakeTopicPartition(tp.topic, tp.partition, off))
        return out

    def assign(self, tps):
        self.assigned = list(tps)
        for tp in tps:
            msgs = type(self).topics[tp.topic][tp.partition]
            if tp.offset == _OFFSET_INVALID:
                pos = 0
            else:
                pos = next((i for i, (o, _, _) in enumerate(msgs)
                            if o >= tp.offset), len(msgs))
            self._cursors[(tp.topic, tp.partition)] = pos

    def consume(self, num_messages, timeout=None):
        out = []
        for (topic, part), pos in sorted(self._cursors.items()):
            msgs = type(self).topics[topic][part]
            take = msgs[pos:pos + num_messages - len(out)]
            self._cursors[(topic, part)] = pos + len(take)
            out.extend(_FakeMessage(part, o, ts, v) for o, ts, v in take)
            if len(out) >= num_messages:
                break
        if type(self).with_errors:
            out = [_ErrMessage(0, -1, 0, b"")] + out
        if not out:
            # a broker's empty poll waits up to its timeout
            time.sleep(0.005)
        return out

    def close(self):
        self.closed = True


@pytest.fixture()
def fake_kafka(monkeypatch):
    mod = types.ModuleType("confluent_kafka")
    mod.Consumer = _FakeConsumer
    mod.TopicPartition = _FakeTopicPartition
    monkeypatch.setitem(sys.modules, "confluent_kafka", mod)
    monkeypatch.setattr(jax_kafka, "_HAS_KAFKA", True)
    monkeypatch.setattr(_FakeConsumer, "topics", {})
    monkeypatch.setattr(_FakeConsumer, "with_errors", False)
    return _FakeConsumer


def _fill_topic(fake, topic, per_part=40, parts=2, gap_at=None):
    data = {}
    for p in range(parts):
        msgs, off = [], 0
        for i in range(per_part):
            if gap_at is not None and i == gap_at:
                off += 3  # a compacted topic's offset gap
            val = json.dumps({"user_id": p * 1000 + i,
                              "label": float(i % 2)}).encode()
            msgs.append((off, 1_700_000_000_000 + i * 1000, val))
            off += 1
        data[p] = msgs
    fake.topics[topic] = data
    return data


def _bad_json_topic(fake):
    fake.topics["events"] = {0: [
        (0, 1_700_000_000_000, b"not json"),
        (1, 1_700_000_001_000, json.dumps({"user_id": 7,
                                           "label": 1.0}).encode()),
        (2, 1_700_000_002_000, b"\xff\xfe"),
        (3, 1_700_000_002_000, json.dumps({"user_id": 8,
                                           "label": 0.0}).encode()),
    ]}


# name -> (topic set-up, path, batch size, resume state, batches)
CASES = {
    "stream": (lambda f: _fill_topic(f, "events"),
               "kafka://b1,b2/events?group=g1", 16, None, 4),
    "resume": (lambda f: _fill_topic(f, "events", 30, 1),
               "kafka://b/events", 10, {0: 14}, 1),
    "gaps": (lambda f: _fill_topic(f, "events", 30, 1, gap_at=10),
             "kafka://b/events", 8, {0: 12}, 2),
    "start_ts": (lambda f: _fill_topic(f, "events", 30, 2),
                 f"kafka://b/events?start_ts={1_700_000_000_000 + 20_000}",
                 10, None, 1),
    "errors": (lambda f: (_fill_topic(f, "events", 4, 1),
                          setattr(f, "with_errors", True)),
               "kafka://b/events", 4, None, 1),
    "bad_json": (_bad_json_topic, "kafka://b/events", 2, None, 1),
}


def _take(reader, n):
    it = reader.to_batches()
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_record_batches_match_jax(case, fake_kafka):
    setup, path, bs, resume, n = CASES[case]
    setup(fake_kafka)
    readers = [kafka_dataset.KafkaReader(path, batch_size=bs),
               jax_kafka.KafkaReader(path, batch_size=bs)]
    got = []
    for r in readers:
        if resume:
            r.load_state(resume)
        got.append(_take(r, n))
    ours, theirs = got
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in b:
            assert a[k].to_pylist() == b[k].to_pylist(), (case, k)
    assert readers[0]._offsets == readers[1]._offsets
    if case == "resume":
        uid = ours[0]["user_id"].to_pylist()
        assert uid == list(range(15, 25))


def test_missing_wheel_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    monkeypatch.setattr(jax_kafka, "_HAS_KAFKA", False)
    for cls in (kafka_dataset.KafkaReader, jax_kafka.KafkaReader):
        with pytest.raises(ImportError, match="confluent-kafka"):
            cls("kafka://b/t", batch_size=8)


def test_several_workers(fake_kafka):
    """The JAX reader's two workers each read every message; the port
    refuses a second reader, in the reader and in the loader."""
    _fill_topic(fake_kafka, "events", 24, 2)
    rows = []
    for w in range(2):
        it = jax_kafka.KafkaReader("kafka://b/events", batch_size=16
                                   ).to_batches(worker_id=w, num_workers=2)
        rows.append(sorted(v for _ in range(3)
                           for v in next(it)["user_id"].to_pylist()))
        it.close()
    assert rows[0] == rows[1] and len(set(rows[0])) == 48
    it = kafka_dataset.KafkaReader("kafka://b/events", batch_size=16
                                   ).to_batches(worker_id=1, num_workers=2)
    with pytest.raises(ValueError, match="every partition"):
        next(it)
    cfg = parse_pipeline_config(_stream_text("unused", 2))
    cfg.data_config.num_workers = 2
    with pytest.raises(ValueError, match="cannot split"):
        create_dataloader(cfg.data_config, [], "kafka://b/events",
                          num_workers=1, worker_id=0)


# --- a DeepFM fed from the topic ------------------------------------------------

STREAM_B = 32


def _deepfm_topic(fake, rows_per_part=96):
    """Two partitions of JSON rows of the DeepFM's columns."""
    fake.topics["clicks"] = {}
    for p in range(2):
        cols = deepfm_cols(rows_per_part, 70 + p)
        names = list(cols)
        vals = [cols[k].to_pylist() for k in names]
        fake.topics["clicks"][p] = [
            (i, 1_700_000_000_000 + i * 1000, json.dumps(
                dict(zip(names, (v[i] for v in vals)))).encode())
            for i in range(rows_per_part)]


def _stream_text(model_dir, steps):
    text = deepfm_config_text(batch_size=STREAM_B, model_dir=model_dir,
                              num_steps=steps,
                              train_extra="  save_checkpoints_steps: 3\n"
                                          "  use_tensorboard: false")
    return (text.replace('train_input_path: "unused"',
                         'train_input_path: "kafka://b/clicks"')
            .replace('eval_input_path: "unused"\n', "")
            .replace("dataset_type: ParquetDataset",
                     "dataset_type: KafkaDataset"))


def test_deepfm_resume_from_the_stream(fake_kafka, tmp_path):
    _deepfm_topic(fake_kafka)
    paths = {}
    for name in ("straight", "resumed"):
        paths[name] = str(tmp_path / f"{name}.config")
        with open(paths[name], "w") as f:
            f.write(_stream_text(str(tmp_path / name), 6))
    port_main.train_and_evaluate(paths["straight"], device="cpu")
    port_main.train_and_evaluate(
        paths["resumed"], device="cpu",
        edit_config_json=json.dumps({"train_config.num_steps": 3}))
    ck3 = torch.load(checkpoint_util.latest_checkpoint(
        str(tmp_path / "resumed")), weights_only=True)
    # the consumer hands partition 0's 96 messages over first: 3 batches
    assert ck3["step"] == 3 and ck3["dataloader_state"] == {0: 95}
    port_main.train_and_evaluate(paths["resumed"], device="cpu",
                                 continue_train=True)
    a, b = (torch.load(checkpoint_util.latest_checkpoint(
        str(tmp_path / d)), weights_only=True)
        for d in ("straight", "resumed"))
    assert a["step"] == b["step"] == 6
    assert a["dataloader_state"] == b["dataloader_state"] == {0: 95, 1: 95}
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
