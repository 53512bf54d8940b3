"""Parquet reader and writer.

Counterpart of torcheasyrec_tpu/datasets/parquet_dataset.py. An input
path is a comma-separated list of files, directories (every
``*.parquet`` below them, sorted) and globs (sorted); a source id is a
file's index in that list, which checkpoint positions refer to.
"""

import glob
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

from torcheasyrec_tpu_torch.datasets.dataset import BaseReader, BaseWriter


def _expand_paths(input_path: str, suffix: str = "parquet",
                  recursive: bool = True) -> List[str]:
    """The files ``input_path`` names, a directory giving its
    ``*.<suffix>`` files (below it, with ``recursive``); raises when it
    names none."""
    paths: List[str] = []
    for part in input_path.split(","):
        part = part.strip()
        if not part:
            continue
        if os.path.isdir(part):
            pattern = (os.path.join(part, "**", f"*.{suffix}") if recursive
                       else os.path.join(part, f"*.{suffix}"))
            paths.extend(sorted(glob.glob(pattern, recursive=recursive)))
        elif any(ch in part for ch in "*?["):
            paths.extend(sorted(glob.glob(part)))
        else:
            paths.append(part)
    if not paths:
        raise FileNotFoundError(f"no {suffix} files match {input_path}")
    return paths


class ParquetReader(BaseReader):
    def __init__(
        self,
        input_path: str,
        batch_size: int,
        selected_cols: Optional[List[str]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(input_path, batch_size, selected_cols, **kwargs)
        self._paths = _expand_paths(input_path)

    def schema(self) -> pa.Schema:
        return pq.read_schema(self._paths[0])

    def _iter_record_batches(
        self, worker_id: int, num_workers: int
    ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        schema_names = set(self.schema().names)
        cols = None
        if self._selected_cols:
            cols = [c for c in self._selected_cols if c in schema_names]
        # whole files per shard when there are enough of them, else
        # interleaved row groups, so every shard still gets rows
        by_file = num_workers <= 1 or len(self._paths) >= num_workers
        rg_counter = 0
        for source_id, path in enumerate(self._paths):
            if by_file and source_id % num_workers != worker_id:
                continue
            with pq.ParquetFile(path) as pf:
                # resume: skip whole row groups already consumed
                consumed = self._resume_state.get(source_id, -1)
                row = 0
                for rg in range(pf.num_row_groups):
                    rg_rows = pf.metadata.row_group(rg).num_rows
                    if not by_file:
                        take = rg_counter % num_workers == worker_id
                        rg_counter += 1
                        if not take:
                            row += rg_rows
                            continue
                    if row + rg_rows <= consumed + 1:
                        row += rg_rows
                        continue
                    tbl = pf.read_row_group(rg, columns=cols)
                    for rb in tbl.to_batches():
                        yield source_id, row, rb
                        row += rb.num_rows


class ParquetWriter(BaseWriter):
    """Writes column dicts to ``output_path``, or to
    ``<output_path>/part-0.parquet`` when the path does not end in
    ``.parquet``."""

    def __init__(self, output_path: str, **kwargs: Any) -> None:
        super().__init__(output_path, **kwargs)
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        self._writer: Optional[pq.ParquetWriter] = None

    def write(self, output_dict: Dict[str, pa.Array]) -> None:
        arrays = {
            k: (v.combine_chunks() if isinstance(v, pa.ChunkedArray) else v)
            for k, v in output_dict.items()
        }
        tbl = pa.Table.from_pydict(arrays)
        with self._lock:
            if self._writer is None:
                path = self._output_path
                if not path.endswith(".parquet"):
                    os.makedirs(path, exist_ok=True)
                    path = os.path.join(path, "part-0.parquet")
                self._writer = pq.ParquetWriter(path, tbl.schema)
            self._writer.write_table(tbl)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
