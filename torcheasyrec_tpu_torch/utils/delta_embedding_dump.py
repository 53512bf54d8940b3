"""Delta embedding dump: the rows that training touched, for an online
system to sync instead of reloading whole tables.

Counterpart of torcheasyrec_tpu/utils/delta_embedding_dump.py, with the
same files: every ``dump_interval_steps`` steps and once at the end of
training, each table whose rows a batch looked up since the last dump
gets ``<file_prefix>-<table>-<step>.parquet`` with columns ``id``
(int64, ascending) and ``embedding`` (list<float32>, the row after that
step). Features that share a table share its shard.

The ids are marked on the device, one flag per table row (the batches
are already there), so a step adds no wait for the host; a dump reads
the flags and the touched rows back.

Over several ranks (the engine's ``shard``) a dump is collective: the
ranks' touched ids are gathered into the global batch's union, each
rank fills the rows it holds of those ids (``engine.read_rows``: only
the touched rows travel, never a whole table) and rank 0 alone writes
the files, the same files under every layout.
"""

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from torcheasyrec_tpu_torch.datasets.utils import Batch
from torcheasyrec_tpu_torch.parallel.mesh import gather_rows


class DeltaEmbeddingDumper:
    def __init__(self, output_dir: str, embedding_group,
                 dump_interval_steps: int = 1000,
                 file_prefix: str = "delta_embedding") -> None:
        self._dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._eg = embedding_group
        self._interval = dump_interval_steps
        self._prefix = file_prefix
        engine = embedding_group.engine
        self._feature_to_table = {
            lk.feature_name: lk.table_name
            for lks in engine._lookups_by_group.values() for lk in lks}
        self._rows = {name: engine.table_rows(name)[2]
                      for name in set(self._feature_to_table.values())}
        # per table: a flag per row and a last one that out-of-range and
        # padding ids mark
        self._touched: Dict[str, torch.Tensor] = {}

    def observe(self, batch: Batch) -> None:
        """Mark the rows the batch's id features look up."""
        fields = (list(batch.sparse_features.items())
                  + list(batch.sequence_sparse_features.items()))
        for name, field in fields:
            table = self._feature_to_table.get(name)
            if table is None:
                continue
            rows = self._rows[table]
            ids = field.values.reshape(-1).long()
            flags = self._touched.get(table)
            if flags is None:
                flags = self._touched[table] = torch.zeros(
                    rows + 1, dtype=torch.bool, device=ids.device)
            ids = torch.where((ids >= 0) & (ids < rows), ids,
                              ids.new_full((), rows))
            flags.index_fill_(0, ids, True)

    def maybe_dump(self, step: int, tables: Dict[str, torch.Tensor]) -> bool:
        if self._interval <= 0 or step % self._interval != 0:
            return False
        self.dump(step, tables)
        return True

    def dump(self, step: int, tables: Dict[str, torch.Tensor]) -> None:
        """Write the touched rows of ``tables`` (the engine's group
        storage) and forget them. Collective over several ranks: every
        rank calls it at the same step."""
        engine = self._eg.engine
        shard = engine.shard
        # every table in one order on every rank: the gathers pair up
        for table in sorted(self._rows):
            flags = self._touched.get(table)
            ids = (torch.nonzero(flags[:-1]).reshape(-1) if flags is not None
                   else torch.zeros(0, dtype=torch.long))
            ids = torch.unique(gather_rows(ids, shard))
            if ids.numel() == 0:
                continue
            rows = engine.read_rows(tables, table, ids)
            if shard is not None and shard.rank != 0:
                continue
            pq.write_table(pa.table({
                "id": pa.array(ids.cpu().numpy().astype(np.int64)),
                "embedding": pa.array(list(rows.cpu().numpy())),
            }), os.path.join(self._dir,
                             f"{self._prefix}-{table}-{step}.parquet"))
        self._touched.clear()
