"""Readers, writers, the dataset and the dataloader.

Counterpart of torcheasyrec_tpu/datasets/dataset.py and of
torcheasyrec_tpu/datasets/mp_loader.py. A reader buffers Arrow record
batches across its files and slices them into batches of ``batch_size``
rows (or fewer, where a cost budget caps them), optionally through a
shuffle pool, and injects the checkpoint-position columns
(``CKPT_SOURCE_ID``, ``CKPT_ROW_IDX``) that resume reads back. The dataset
parses each batch into a ``Batch`` of CPU tensors and a ``BatchInfo``.
The loader produces them either on a background thread
(``PrefetchIterator``) or, when ``data_config.num_workers`` asks for it,
in ``torch.utils.data.DataLoader`` worker processes, each reading a
disjoint shard. The producers pack each batch into one narrow wire
buffer (``datasets/pack.py``: the thread loader pinned where the batches
go to a card, a worker as a numpy array the parent pins), which moves
to the card in one copy on a side stream and is unpacked there; on the
CPU it is unpacked on the host.
"""

import os
import queue
import random
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import pyarrow as pa
import torch

from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
from torcheasyrec_tpu_torch.datasets.pack import (
    PackedBatch,
    pack_batch,
    unify_spec,
    unpack_batch,
)
from torcheasyrec_tpu_torch.datasets.utils import (
    CKPT_ROW_IDX,
    CKPT_SOURCE_ID,
    DATA_TIMESTAMP,
    HARD_NEG_INDICES,
    Batch,
    BatchInfo,
    pa_from_numpy,
)
from torcheasyrec_tpu_torch.features.feature import BaseFeature
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_READER_CLASS_MAP: Dict[str, type] = {}
_WRITER_CLASS_MAP: Dict[str, type] = {}

_reader_meta = get_register_class_meta(_READER_CLASS_MAP)
_writer_meta = get_register_class_meta(_WRITER_CLASS_MAP)

# a worker process that sends no batch for this long fails the run (the
# first batch of a spawned worker includes its start-up: imports, reader)
WORKER_TIMEOUT_S = 600
# batches read ahead: by the prefetch thread, and by each worker process
PREFETCH = 4


class BaseReader(metaclass=_reader_meta):
    """Buffered reader over one or more input sources."""

    # whether ``worker_id`` of ``num_workers`` reads a disjoint part of
    # the input (a stream that every reader reads whole is not)
    splittable = True

    def __init__(
        self,
        input_path: str,
        batch_size: int,
        selected_cols: Optional[List[str]] = None,
        drop_remainder: bool = False,
        shuffle: bool = False,
        shuffle_buffer_size: int = 32,
        sample_cost_field: Optional[str] = None,
        batch_cost_size: int = 0,
        **kwargs: Any,
    ) -> None:
        self._input_path = input_path
        self._batch_size = batch_size
        self._selected_cols = selected_cols
        self._drop_remainder = drop_remainder
        self._shuffle = shuffle
        self._shuffle_buffer_size = shuffle_buffer_size
        # cost-capped batches: at most batch_cost_size of summed cost
        self._sample_cost_field = sample_cost_field
        self._batch_cost_size = int(batch_cost_size or 0)
        # resume state: source_id -> the last row index already consumed
        self._resume_state: Dict[int, int] = {}
        # set by ``stop``: a reader that waits on its source returns
        self._stopping = threading.Event()

    def load_state(self, state: Dict[int, int]) -> None:
        self._resume_state = dict(state or {})

    def stop(self) -> None:
        """Ask a running ``to_batches`` to end at its next wait on the
        source (a stream's empty poll); the next ``to_batches`` runs."""
        self._stopping.set()

    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def _iter_record_batches(
        self, worker_id: int, num_workers: int
    ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        """Yield (source_id, start_row, record_batch)."""
        raise NotImplementedError

    def to_batches(
        self, worker_id: int = 0, num_workers: int = 1
    ) -> Iterator[Dict[str, pa.Array]]:
        """Column dicts of ``batch_size`` rows (fewer under a cost cap,
        and the final remainder unless dropped), with the checkpoint
        columns injected. Rows carry over from one file into the next
        file's batch. With ``shuffle``, record batches pass through a
        pool of ``shuffle_buffer_size`` drawn by ``random.Random(
        worker_id)``, so the order is the JAX package's, bit for bit."""
        buf: List[pa.RecordBatch] = []
        buffered = 0
        shuffle_pool: List[pa.RecordBatch] = []
        rng = random.Random(worker_id)

        def _cost_rows(tbl) -> int:
            """Rows fitting the batch cost budget (else batch_size)."""
            if not (self._batch_cost_size and self._sample_cost_field
                    and self._sample_cost_field in tbl.schema.names):
                return self._batch_size
            costs = tbl.column(self._sample_cost_field).to_numpy(
                zero_copy_only=False
            )[: self._batch_size]
            cum = np.cumsum(np.nan_to_num(costs.astype(np.float64)))
            n = int(np.searchsorted(cum, self._batch_cost_size,
                                    side="right"))
            return max(min(n, self._batch_size), 1)

        def _slice_out() -> Iterator[Dict[str, pa.Array]]:
            nonlocal buf, buffered
            while buffered >= self._batch_size:
                tbl = pa.Table.from_batches(buf)
                take = _cost_rows(tbl)
                head = tbl.slice(0, take)
                rest = tbl.slice(take)
                buf = rest.combine_chunks().to_batches()
                buffered = rest.num_rows
                yield {
                    name: head.column(i)
                    for i, name in enumerate(head.schema.names)
                }

        self._stopping.clear()
        # resume positions apply only to the first pass after a restore;
        # later epochs replay every row
        resume, self._resume_state = self._resume_state, {}
        for source_id, start_row, rb in self._iter_record_batches(
            worker_id, num_workers
        ):
            consumed = resume.get(source_id, -1)
            if start_row + rb.num_rows <= consumed + 1:
                continue
            if start_row <= consumed:
                skip = consumed + 1 - start_row
                rb = rb.slice(skip)
                start_row += skip
            rb = self._inject_ckpt_cols(rb, source_id, start_row)
            if self._shuffle:
                shuffle_pool.append(rb)
                if len(shuffle_pool) >= self._shuffle_buffer_size:
                    rng.shuffle(shuffle_pool)
                    take = shuffle_pool.pop(0)
                    buf.append(take)
                    buffered += take.num_rows
                    yield from _slice_out()
            else:
                buf.append(rb)
                buffered += rb.num_rows
                yield from _slice_out()

        rng.shuffle(shuffle_pool)
        for rb in shuffle_pool:
            buf.append(rb)
            buffered += rb.num_rows
            yield from _slice_out()
        if buffered > 0 and not self._drop_remainder:
            tbl = pa.Table.from_batches(buf)
            yield {
                name: tbl.column(i) for i, name in enumerate(tbl.schema.names)
            }

    def _inject_ckpt_cols(
        self, rb: pa.RecordBatch, source_id: int, start_row: int
    ) -> pa.RecordBatch:
        n = rb.num_rows
        rb = rb.append_column(
            CKPT_SOURCE_ID, pa_from_numpy(np.full(n, source_id, np.int64))
        )
        return rb.append_column(
            CKPT_ROW_IDX,
            pa_from_numpy(np.arange(start_row, start_row + n, dtype=np.int64)),
        )


class BaseWriter(metaclass=_writer_meta):
    def __init__(self, output_path: str, **kwargs: Any) -> None:
        self._output_path = output_path
        self._lock = threading.Lock()

    def write(self, output_dict: Dict[str, pa.Array]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class BaseDataset:
    """Iterable over (Batch, BatchInfo) of one input shard: worker
    ``worker_id`` of ``num_workers`` reads a disjoint part of the input.

    The parser takes labels outside predict only, ``is_training`` in
    train mode, ``data_config.fg_threads`` for the FG DAG, and INPUT_TILE
    in predict mode where the environment's ``INPUT_TILE`` is 2 or 3 (a
    request's user-side features are parsed once). The JAX parser's
    ``force_base_data_group`` is stored and never read, so it does not
    reach this parser. A ``sampler`` (``create_sampler``)
    appends its negatives to each batch's columns before the parse; the
    hard negatives' indices go to ``batch.additional``."""

    def __init__(
        self,
        data_config: Any,
        features: List[BaseFeature],
        reader: BaseReader,
        mode: str = "train",
        worker_id: int = 0,
        num_workers: int = 1,
        reserved_columns: Optional[List[str]] = None,
        sampler: Optional[Any] = None,
    ) -> None:
        self._reader = reader
        self._sampler = sampler
        self._mode = mode
        self._worker_id = worker_id
        self._num_workers = num_workers
        self._reserved_columns = list(reserved_columns or [])
        self._parser = DataParser(
            features,
            labels=list(data_config.label_fields) if mode != "predict" else [],
            sample_weights=list(data_config.sample_weight_fields),
            is_training=mode == "train",
            input_tile=(mode == "predict" and os.environ.get(
                "INPUT_TILE", "") in ("2", "3")),
            fg_threads=int(data_config.fg_threads or 1),
        )

    def __iter__(self) -> Iterator[Tuple[Batch, BatchInfo]]:
        if self._sampler is not None:
            self._sampler.init()
        for columns in self._reader.to_batches(
            worker_id=self._worker_id, num_workers=self._num_workers
        ):
            yield self._build_batch(columns)

    def _build_batch(
        self, columns: Dict[str, pa.Array]
    ) -> Tuple[Batch, BatchInfo]:
        info = BatchInfo()
        if CKPT_SOURCE_ID in columns:
            sid = columns.pop(CKPT_SOURCE_ID).to_numpy(zero_copy_only=False)
            ridx = columns.pop(CKPT_ROW_IDX).to_numpy(zero_copy_only=False)
            for s in np.unique(sid):
                info.checkpoint_info[int(s)] = int(ridx[sid == s].max())
        if DATA_TIMESTAMP in columns:
            ts = columns.pop(DATA_TIMESTAMP).to_numpy(zero_copy_only=False)
            if len(ts):
                info.data_timestamp = int(np.max(ts))
        for col in self._reserved_columns:
            if col in columns:
                info.reserved[col] = columns[col]
        info.batch_size = len(next(iter(columns.values())))
        hard_neg_indices = None
        if self._sampler is not None:
            columns = self._sampler.process(columns)
            hard_neg_indices = columns.pop(HARD_NEG_INDICES, None)
        batch = self._parser.parse_to_batch(columns)
        if hard_neg_indices is not None:
            batch.additional["hard_neg_indices"] = torch.from_numpy(
                hard_neg_indices)
        return batch, info


class _DeviceCopy:
    """Copies a packed batch's pinned wire to a CUDA device on a side
    stream, in one transfer, and unpacks it there: the copy of batch N+1
    runs under step N, the compute stream waits for it on an event, and
    each unpacked storage is recorded on the compute stream so the
    allocator keeps its memory until the step that reads it is done. Runs
    on the consumer's thread, as the JAX loader's device_put does: issuing
    copies from the producer thread would queue them behind its parsing
    under the interpreter lock. The pinned wire is not reused before the
    copy has read it (the caching host allocator records the copy's event
    on it, and the host batch holds it). The copy's ``host`` is the batch
    rebuilt from the pinned wire at its first read: the host-offloaded
    tables read its ids, with no copy back from the device."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stream = torch.cuda.Stream(device)

    def __call__(self, packed: PackedBatch) -> Batch:
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = unpack_batch(packed, packed.wire.to(self.device,
                                                      non_blocking=True))
        compute.wait_stream(self._stream)
        # once per storage: an unpacked batch's leaves are views of a few
        seen = set()
        for t in out.tensors():
            ptr = t.untyped_storage().data_ptr()
            if ptr not in seen:
                seen.add(ptr)
                t.record_stream(compute)
        out.set_host(lambda: unpack_batch(packed))
        return out


def _deliver(packed: PackedBatch, copy: Optional[_DeviceCopy]) -> Batch:
    """The batch on the card through ``copy``, else unpacked on the
    host."""
    return unpack_batch(packed) if copy is None else copy(packed)


class PrefetchIterator:
    """(Batch, BatchInfo) items produced on a background thread, which
    reads and parses (pyarrow and numpy release the interpreter lock) and
    packs each batch (``dense_bf16``: ``pack_batch``'s), pinned where
    ``copy`` is set; ``copy`` moves it to the device at ``__next__``. A
    failure in the thread is raised at the consumer's next
    ``__next__``."""

    def __init__(self, iterable, prefetch: int = PREFETCH,
                 copy: Optional[_DeviceCopy] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 dense_bf16: bool = False) -> None:
        self._copy = copy
        self._on_close = on_close
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False
        pin = copy is not None

        def _put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _worker() -> None:
            try:
                for batch, info in iterable:
                    batch = pack_batch(batch, dense_bf16, pin=pin)
                    if not _put((batch, info)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised by __next__
                self._err = e
            finally:
                # the done sentinel must not be lost to a full queue
                _put(self._done)

        self._t = threading.Thread(target=_worker, daemon=True)
        self._t.start()

    def close(self) -> None:
        """Stop the thread and drop queued batches. Safe on an abandoned
        iterator: the thread never blocks on a full queue for good, and
        ``on_close`` (the reader's ``stop``) ends a reader that waits on
        a stream."""
        self._stop.set()
        if self._on_close is not None:
            self._on_close()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join()

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[Batch, BatchInfo]:
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, info = item
        return _deliver(batch, self._copy), info


class _WorkerShards(torch.utils.data.IterableDataset):
    """The dataset of a ``DataLoader`` worker pool: worker ``w`` of ``k``
    reads global shard ``base_wid * k + w`` of ``base_nw * k`` of the
    input, so rows stay disjoint across hosts and workers. It holds only
    protos, features and plain values, all of which pickle."""

    def __init__(self, data_config, features, input_path, mode,
                 reserved_columns, selected_cols, batch_size, base_wid,
                 base_nw, sampler=None, dense_bf16: bool = False) -> None:
        super().__init__()
        self.data_config = data_config
        self.features = features
        self.input_path = input_path
        self.mode = mode
        self.reserved_columns = reserved_columns
        self.selected_cols = selected_cols
        self.batch_size = batch_size
        self.base_wid = base_wid
        self.base_nw = base_nw
        self.sampler = sampler
        self.dense_bf16 = dense_bf16

    def shard(self) -> BaseDataset:
        """This worker's dataset (called in the worker)."""
        info = torch.utils.data.get_worker_info()
        w, k = (0, 1) if info is None else (info.id, info.num_workers)
        reader = _reader_for(self.data_config, self.input_path,
                             self.batch_size, self.selected_cols, self.mode)
        return BaseDataset(
            self.data_config, self.features, reader, self.mode,
            worker_id=self.base_wid * k + w, num_workers=self.base_nw * k,
            reserved_columns=self.reserved_columns, sampler=self.sampler)

    def __iter__(self) -> Iterator[Tuple[PackedBatch, BatchInfo]]:
        # a numpy wire reaches the parent pickled through the worker's
        # pipe; a tensor would go as a shared-memory file descriptor,
        # fetched over a socket connection per descriptor
        for batch, batch_info in self.shard():
            yield pack_batch(batch, self.dense_bf16).to_numpy(), batch_info


class _LoaderIter:
    """A ``DataLoader``'s iterator with the device copy applied at
    ``__next__`` and a ``close`` that stops its workers, then unlinks the
    sampler's shared tables (``sampler``, where it published them for the
    workers)."""

    def __init__(self, loader, copy: Optional[_DeviceCopy],
                 sampler: Optional[Any] = None) -> None:
        self._sampler = sampler
        try:
            self._it = iter(loader)  # spawns the workers
        except BaseException:
            self._close_sampler()
            raise
        self._copy = copy
        # the wire kinds seen so far: each worker keeps envelopes of its own
        self._kinds: Dict[Any, List[str]] = {}

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[Batch, BatchInfo]:
        batch, info = next(self._it)
        # a pinned tensor already, on CUDA
        batch = unify_spec(batch.from_numpy(), self._kinds)
        return _deliver(batch, self._copy), info

    def close(self) -> None:
        try:
            self._it._shutdown_workers()
        finally:
            self._close_sampler()

    def _close_sampler(self) -> None:
        if self._sampler is not None:
            self._sampler.close_shared()


def create_reader(
    input_path: str,
    batch_size: int,
    selected_cols: Optional[List[str]] = None,
    dataset_type: Optional[int] = None,
    **kwargs: Any,
) -> BaseReader:
    from torcheasyrec_tpu_torch.datasets import (  # noqa: F401
        csv_dataset,
        kafka_dataset,
        odps_dataset,
        parquet_dataset,
    )
    from torcheasyrec_tpu_torch.protos import data_pb2

    if input_path.startswith("kafka://"):
        # a stream's path names its reader whatever the config's type (a
        # Kafka-fed run keeps its parquet eval files)
        dataset_type = data_pb2.DatasetType.KafkaDataset
    name = data_pb2.DatasetType.Name(dataset_type or _infer_type(input_path))
    cls = _READER_CLASS_MAP.get(name.replace("Dataset", "Reader"))
    if cls is None:
        raise NotImplementedError(
            f"no reader for {name} is ported; available "
            f"{sorted(k for k in _READER_CLASS_MAP if k[0].isupper())}")
    return cls(input_path, batch_size, selected_cols, **kwargs)


def create_writer(output_path: str, writer_type: str,
                  **kwargs: Any) -> BaseWriter:
    from torcheasyrec_tpu_torch.datasets import (  # noqa: F401
        csv_dataset,
        odps_dataset,
        parquet_dataset,
    )

    cls = _WRITER_CLASS_MAP.get(writer_type)
    if cls is None:
        raise NotImplementedError(
            f"no writer {writer_type} is ported; available "
            f"{sorted(k for k in _WRITER_CLASS_MAP if k[0].isupper())}")
    return cls(output_path, **kwargs)


def _infer_type(input_path: str) -> int:
    from torcheasyrec_tpu_torch.protos import data_pb2

    if ".csv" in input_path:
        return data_pb2.DatasetType.CsvDataset
    return data_pb2.DatasetType.ParquetDataset


def _reader_for(data_config, input_path: str, batch_size: int, selected_cols,
                mode: str, resume_state=None) -> BaseReader:
    """The one place where reader options come from a data_config, for
    the thread loader and the worker processes alike: the remainder is
    dropped in train mode (and elsewhere when ``drop_remainder`` asks),
    and only train mode shuffles."""
    r = create_reader(
        input_path,
        batch_size,
        selected_cols=selected_cols,
        dataset_type=data_config.dataset_type,
        drop_remainder=data_config.drop_remainder or (mode == "train"),
        shuffle=data_config.shuffle and mode == "train",
        shuffle_buffer_size=data_config.shuffle_buffer_size,
        delimiter=data_config.delimiter,
        with_header=data_config.with_header,
        input_fields=list(data_config.input_fields),
        sample_cost_field=data_config.sample_cost_field or None,
        batch_cost_size=data_config.batch_cost_size,
    )
    if resume_state:
        r.load_state(resume_state)
    return r


def create_sampler(data_config: Any, mode: str,
                   features: Sequence[Any] = ()) -> Optional[Any]:
    """The sampler ``data_config`` names, for train and eval
    (``num_eval_sample`` outside train); None in predict or where it
    names none. The TDM sampler writes its labels into the first label
    field. Where the ``item_id_field`` is a grouped sequence's
    sub-feature among ``features``, the sampler reads that column's rows
    as positives joined by the sequence's delimiter."""
    which = data_config.WhichOneof("sampler")
    if which is None or mode == "predict":
        return None
    from torcheasyrec_tpu_torch.datasets import sampler as sampler_mod

    cfg = getattr(data_config, which)
    cls_name = type(cfg).__name__
    extra = {}
    if cls_name == "TDMSampler" and len(data_config.label_fields):
        extra["label_field"] = data_config.label_fields[0]
    seq_delim = next((f.sequence_delim or ";" for f in features
                      if f.name == cfg.item_id_field and f.sequence_name),
                     None)
    return sampler_mod.BaseSampler.create_class(cls_name)(
        cfg, is_training=mode == "train", seq_delim=seq_delim, **extra)


def num_loader_workers(data_config: Any, mode: str = "train") -> int:
    """Worker processes the loader runs, 0 for the thread loader. Opt-in:
    the proto's default ``num_workers`` (8) does not turn them on; an
    explicitly set ``num_workers`` or ``TZREC_MP_LOADER=<n>`` does, and
    ``TZREC_MP_LOADER=0`` turns them off. Predict never runs them unless
    the environment asks."""
    env = os.environ.get("TZREC_MP_LOADER", "")
    if env != "":
        try:
            return max(int(env), 0)
        except ValueError:
            return 0
    if mode == "predict":
        return 0
    if data_config.HasField("num_workers"):
        return max(int(data_config.num_workers), 0)
    return 0


def create_dataloader(
    data_config: Any,
    features: List[BaseFeature],
    input_path: str,
    mode: str = "train",
    reserved_columns: Optional[List[str]] = None,
    resume_state: Optional[Dict[int, int]] = None,
    worker_id: Optional[int] = None,
    num_workers: Optional[int] = None,
    device=None,
    dense_bf16: bool = False,
) -> Callable[[], Iterator[Tuple[Batch, BatchInfo]]]:
    """A zero-argument factory of one epoch's iterator over
    (Batch, BatchInfo), carrying ``.dataset``, ``.reader`` and
    ``.mp_workers``; each iterator has ``close()``.

    Outside train mode the batch size is ``eval_batch_size`` where set.
    The input shard is ``worker_id`` of ``num_workers``; by default this
    rank's of the ranks of ``torch.distributed`` (the whole input outside
    a process group), as the JAX package defaults to its process. Rank r
    of N with K loader workers: worker w reads shard r * K + w of N * K.
    Every batch travels as one narrow wire buffer (``datasets/pack.py``;
    with ``dense_bf16`` its dense features as bf16, arriving as fp32 of
    the rounded values). With ``device`` on CUDA the batches arrive
    there, the wire copied from pinned memory on a side stream in one
    transfer and unpacked there; else they are unpacked on the CPU.
    ``resume_state`` ({source_id: last row consumed}) skips those rows in
    the first epoch only.

    Worker processes (``num_loader_workers``) run a ``DataLoader`` over
    ``_WorkerShards``; the epoch that resumes runs on the thread loader,
    because one consumer-side watermark cannot be replayed into workers
    that lag by different amounts. The workers are spawned, never forked:
    the parent has initialised CUDA and runs threads (the prefetch and
    pin-memory threads, CUDA's own), and a fork copies their locks in
    whatever state they are; a spawned worker starts from a fresh
    interpreter and never touches CUDA (its tensors stay on the CPU; the
    parent pins and copies them). A sampler (``create_sampler``) is built
    here, one for the loader: each worker draws from its pickled copy.
    With workers, each epoch's iterator publishes the sampler's tables in
    shared memory before it spawns them (``prepare_shared``: the workers'
    copies attach to one table) and unlinks them in its ``close``, which
    the loop calls in a ``finally``."""
    if worker_id is None or num_workers is None:
        import torch.distributed as dist

        on = dist.is_available() and dist.is_initialized()
        worker_id = dist.get_rank() if on else 0
        num_workers = dist.get_world_size() if on else 1
    batch_size = int(data_config.batch_size)
    if mode != "train" and data_config.HasField("eval_batch_size"):
        batch_size = int(data_config.eval_batch_size)
    selected_cols = _selected_columns(data_config, features, mode,
                                      reserved_columns)
    reader = _reader_for(data_config, input_path, batch_size, selected_cols,
                         mode, resume_state)
    sampler = create_sampler(data_config, mode, features)
    dataset = BaseDataset(data_config, features, reader, mode,
                          worker_id=worker_id, num_workers=num_workers,
                          reserved_columns=reserved_columns, sampler=sampler)
    mp_workers = num_loader_workers(data_config, mode)
    if mp_workers > 1 and not reader.splittable:
        raise ValueError(
            f"{type(reader).__name__} cannot split its input between "
            f"{mp_workers} loader workers (each would read all of it); "
            "set data_config.num_workers to 1 or 0")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    resumed_epoch_pending = [bool(resume_state) and mp_workers > 1]

    def _make_iter():
        copy = _DeviceCopy(dev) if dev.type == "cuda" else None
        if mp_workers > 1 and not resumed_epoch_pending[0]:
            loader = torch.utils.data.DataLoader(
                _WorkerShards(data_config, features, input_path, mode,
                              list(reserved_columns or []), selected_cols,
                              batch_size, worker_id, num_workers, sampler,
                              dense_bf16),
                batch_size=None, num_workers=mp_workers,
                pin_memory=copy is not None, timeout=WORKER_TIMEOUT_S,
                multiprocessing_context="spawn", prefetch_factor=PREFETCH)
            if sampler is not None:
                # one table for the workers, unlinked by the iterator's close
                sampler.prepare_shared()
            return _LoaderIter(loader, copy, sampler)
        resumed_epoch_pending[0] = False
        return PrefetchIterator(iter(dataset), prefetch=PREFETCH, copy=copy,
                                on_close=reader.stop, dense_bf16=dense_bf16)

    _make_iter.dataset = dataset
    _make_iter.reader = reader
    _make_iter.mp_workers = mp_workers
    return _make_iter


def _selected_columns(
    data_config: Any,
    features: List[BaseFeature],
    mode: str,
    reserved: Optional[List[str]],
) -> List[str]:
    cols: List[str] = []
    for f in features:
        for c in f.inputs:
            if c not in cols:
                cols.append(c)
    if mode != "predict":
        for label in data_config.label_fields:
            if label not in cols:
                cols.append(label)
        for w in data_config.sample_weight_fields:
            if w not in cols:
                cols.append(w)
    if data_config.sample_cost_field and (
        data_config.sample_cost_field not in cols
    ):
        cols.append(data_config.sample_cost_field)
    for r in reserved or []:
        if r not in cols:
            cols.append(r)
    return cols
