"""Kafka streaming reader.

Counterpart of torcheasyrec_tpu/datasets/kafka_dataset.py. Input paths
are ``kafka://broker1,broker2/topic`` with optional ``?group=...`` (the
consumer group, default ``tzrec-tpu``) and ``&start_ts=...`` (a message
time in milliseconds). Messages are JSON objects, one row each; a
message whose ``error()`` is set, or whose value is not JSON, is skipped
(broker errors with a warning). The reader polls forever: a stream has
no end, so ``num_steps`` ends training.

Rows are emitted in record batches of one partition each, each row
carrying its message's real offset as its checkpoint row index
(``CKPT_SOURCE_ID`` is the partition), so a compacted topic's gaps
resume right: a restore's watermark ({partition: last offset consumed},
``load_state``) resumes each partition at offset + 1. Without one,
``start_ts`` seeks every partition through ``offsets_for_times``, else
the consumer starts at the earliest offset. ``DATA_TIMESTAMP`` is the
message time in seconds (0 where the broker gave none), which drives the
loop's event-time checkpoints. ``stop`` (the loader's ``close``) ends the
poll at its next empty poll.

It needs ``confluent_kafka`` (librdkafka), which is imported when the
reader is built: without it the construction raises ``ImportError``.

One reader reads every partition (the JAX reader ignores its worker id
and worker count, so each of several workers or processes reads every
message). The port refuses that: the reader raises for more than one
worker or rank, and the loader for ``num_workers`` > 1 (ROADMAP §3).
"""

import json
import logging
import urllib.parse
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from torcheasyrec_tpu_torch.datasets.dataset import BaseReader
from torcheasyrec_tpu_torch.datasets.utils import (
    CKPT_ROW_IDX,
    CKPT_SOURCE_ID,
    DATA_TIMESTAMP,
    pa_from_numpy,
)

logger = logging.getLogger("tzrec_tpu_torch")

_PARTITION = "__kafka_partition__"
_OFFSET = "__kafka_offset__"


class KafkaReader(BaseReader):
    # every reader reads every partition: the input cannot be split
    # between loader workers or ranks
    splittable = False

    def __init__(
        self,
        input_path: str,
        batch_size: int,
        selected_cols: Optional[List[str]] = None,
        poll_timeout: float = 1.0,
        max_poll_records: int = 4096,
        **kwargs: Any,
    ) -> None:
        super().__init__(input_path, batch_size, selected_cols, **kwargs)
        try:
            import confluent_kafka  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "confluent-kafka is required for KafkaDataset; it is not "
                "installed in this environment") from e
        parsed = urllib.parse.urlparse(input_path)
        if parsed.scheme != "kafka":
            raise ValueError(f"not a kafka:// path: {input_path}")
        self._brokers = parsed.netloc
        self._topic = parsed.path.lstrip("/")
        qs = urllib.parse.parse_qs(parsed.query)
        self._group = qs.get("group", ["tzrec-tpu"])[0]
        self._start_ts = int(qs.get("start_ts", [0])[0])
        self._poll_timeout = poll_timeout
        self._max_poll = max_poll_records
        # resume state: partition -> last consumed offset
        self._offsets: Dict[int, int] = {}

    def load_state(self, state: Dict[int, int]) -> None:
        self._offsets = {int(k): int(v) for k, v in (state or {}).items()}

    def _make_consumer(self):
        from confluent_kafka import Consumer, TopicPartition

        c = Consumer({
            "bootstrap.servers": self._brokers,
            "group.id": self._group,
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
        })
        md = c.list_topics(self._topic, timeout=10)
        tps = []
        for p in md.topics[self._topic].partitions:
            if p in self._offsets:
                tps.append(TopicPartition(self._topic, p,
                                          self._offsets[p] + 1))
            elif self._start_ts:
                tps.append(TopicPartition(self._topic, p, self._start_ts))
            else:
                tps.append(TopicPartition(self._topic, p))
        if self._start_ts and not self._offsets:
            tps = c.offsets_for_times(tps, timeout=10)
        c.assign(tps)
        return c

    def _iter_record_batches(
        self, worker_id: int, num_workers: int
    ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        if num_workers > 1:
            raise ValueError(
                f"KafkaDataset: {num_workers} readers (loader workers times "
                "ranks) would each read every partition of "
                f"{self._topic!r}; read a Kafka input with one worker on "
                "one rank")
        consumer = self._make_consumer()
        rows: List[Dict[str, Any]] = []
        try:
            while True:
                msgs = consumer.consume(num_messages=self._max_poll,
                                        timeout=self._poll_timeout)
                if not msgs:
                    if rows:
                        yield from self._emit(rows)
                        rows = []
                    if self._stopping.is_set():
                        return
                    continue
                for m in msgs:
                    if m.error():
                        logger.warning(f"kafka error: {m.error()}")
                        continue
                    row = self._parse(m.value())
                    if row is None:
                        continue
                    ts = m.timestamp()[1]
                    row[DATA_TIMESTAMP] = ts // 1000 if ts > 0 else 0
                    row[_PARTITION] = m.partition()
                    row[_OFFSET] = m.offset()
                    self._offsets[m.partition()] = m.offset()
                    rows.append(row)
                if len(rows) >= self._batch_size:
                    yield from self._emit(rows)
                    rows = []
        finally:
            consumer.close()

    @staticmethod
    def _parse(value: bytes) -> Optional[Dict[str, Any]]:
        try:
            return json.loads(value)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None

    @staticmethod
    def _emit(rows) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        """One record batch per partition, in the order the partitions
        first appear, each row with its message's offset."""
        by_part: Dict[int, list] = {}
        for r in rows:
            by_part.setdefault(int(r.get(_PARTITION, 0)), []).append(r)
        for partition, part_rows in by_part.items():
            cols: Dict[str, list] = {}
            for r in part_rows:
                for k, v in r.items():
                    if k != _PARTITION:
                        cols.setdefault(k, []).append(v)
            rb = pa.RecordBatch.from_pydict(
                {k: pa.array(v) for k, v in cols.items()})
            yield partition, int(part_rows[0][_OFFSET]), rb

    def _inject_ckpt_cols(self, rb: pa.RecordBatch, source_id: int,
                          start_row: int) -> pa.RecordBatch:
        """The real offsets, not ``BaseReader``'s running row index."""
        n = rb.num_rows
        offsets = rb.column(rb.schema.get_field_index(_OFFSET))
        rb = rb.drop_columns([_OFFSET])
        rb = rb.append_column(
            CKPT_SOURCE_ID, pa_from_numpy(np.full(n, source_id, np.int64)))
        return rb.append_column(CKPT_ROW_IDX, offsets.cast(pa.int64()))
