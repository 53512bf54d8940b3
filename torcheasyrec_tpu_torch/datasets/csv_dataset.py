"""CSV reader and writer.

Counterpart of torcheasyrec_tpu/datasets/csv_dataset.py. An input path
is a comma-separated list of files, directories (every ``*.csv`` in
them, sorted, not recursive) and globs (sorted); a source id is a file's
index in that list, which checkpoint positions refer to. A file without
a header takes its column names from ``data_config.input_fields``, and
an ``input_type`` there fixes a column's type (else Arrow infers it).
Every column is read, as in the JAX package (``selected_cols`` is not
applied); the dataset parses the ones it needs. The writer writes one
``part-0.csv`` (or the ``.csv`` path it is given) with a header row;
list columns cannot be written (Arrow's CSV has no list type), so the
SID tools encode them as strings first.
"""

import csv as _csv
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import pyarrow as pa
import pyarrow.csv as pacsv

from torcheasyrec_tpu_torch.datasets.dataset import BaseReader, BaseWriter
from torcheasyrec_tpu_torch.datasets.parquet_dataset import _expand_paths

# data.proto's FieldType -> Arrow type
_FIELD_TYPE_TO_PA = {
    0: pa.int32(),     # INT32
    1: pa.int64(),     # INT64
    2: pa.string(),    # STRING
    3: pa.float32(),   # FLOAT
    4: pa.float64(),   # DOUBLE
}


def expand_csv_paths(input_path: str) -> List[str]:
    """The files ``input_path`` names (a directory's ``*.csv``, not
    recursive); raises when it names none."""
    return _expand_paths(input_path, "csv", recursive=False)


class CsvReader(BaseReader):
    def __init__(
        self,
        input_path: str,
        batch_size: int,
        selected_cols: Optional[List[str]] = None,
        delimiter: str = ",",
        with_header: bool = False,
        input_fields: Optional[List[Any]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(input_path, batch_size, selected_cols, **kwargs)
        self._delimiter = delimiter or ","
        self._with_header = with_header
        self._input_fields = list(input_fields or [])
        self._paths = expand_csv_paths(input_path)

    def _read_opts(self):
        column_names = None
        if not self._with_header:
            if not self._input_fields:
                raise ValueError(
                    "csv without header requires data_config.input_fields"
                )
            column_names = [f.input_name for f in self._input_fields]
        column_types = {
            f.input_name: _FIELD_TYPE_TO_PA.get(f.input_type, pa.string())
            for f in self._input_fields if f.HasField("input_type")
        }
        return (
            pacsv.ReadOptions(column_names=column_names,
                              autogenerate_column_names=False),
            pacsv.ParseOptions(delimiter=self._delimiter),
            pacsv.ConvertOptions(column_types=column_types),
        )

    def _open(self, path: str):
        ro, po, co = self._read_opts()
        return pacsv.open_csv(path, read_options=ro, parse_options=po,
                              convert_options=co)

    def schema(self) -> pa.Schema:
        with self._open(self._paths[0]) as reader:
            return reader.schema

    def _iter_record_batches(
        self, worker_id: int, num_workers: int
    ) -> Iterator[Tuple[int, int, pa.RecordBatch]]:
        # whole files per shard when there are enough of them, else
        # interleaved record batches (each shard parses every file, and
        # keeps its own batches, so rows stay disjoint)
        by_file = num_workers <= 1 or len(self._paths) >= num_workers
        rb_counter = 0
        for source_id, path in enumerate(self._paths):
            if by_file and source_id % num_workers != worker_id:
                continue
            row = 0
            with self._open(path) as reader:
                for rb in reader:
                    if rb.num_rows == 0:
                        continue
                    if not by_file:
                        take = rb_counter % num_workers == worker_id
                        rb_counter += 1
                        if not take:
                            row += rb.num_rows
                            continue
                    yield source_id, row, rb
                    row += rb.num_rows


class CsvWriter(BaseWriter):
    """Writes column dicts to ``output_path``, or to
    ``<output_path>/part-0.csv`` when the path does not end in ``.csv``,
    after a header row of the first dict's keys."""

    def __init__(self, output_path: str, **kwargs: Any) -> None:
        super().__init__(output_path, **kwargs)
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        self._f = None
        self._writer = None

    def write(self, output_dict: Dict[str, pa.Array]) -> None:
        cols = {
            k: (v.combine_chunks() if isinstance(v, pa.ChunkedArray) else v)
            for k, v in output_dict.items()
        }
        with self._lock:
            if self._writer is None:
                path = self._output_path
                if not path.endswith(".csv"):
                    os.makedirs(path, exist_ok=True)
                    path = os.path.join(path, "part-0.csv")
                self._f = open(path, "w", newline="")
                self._writer = _csv.writer(self._f)
                self._writer.writerow(list(cols))
            pylists = [c.to_pylist() for c in cols.values()]
            self._writer.writerows(zip(*pylists))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
            self._writer = None
