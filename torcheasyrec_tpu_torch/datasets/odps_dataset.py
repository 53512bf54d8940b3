"""ODPS (MaxCompute) reader and writer stubs.

Counterpart of torcheasyrec_tpu/datasets/odps_dataset.py, a stub there
too: the ODPS path needs Alibaba Cloud's wheels (pyodps, common_io),
which neither package depends on. The classes register, so a config
with ``dataset_type: OdpsDataset`` (or ``OdpsDatasetV1``, or the
``OdpsWriter``) fails with the advice to export the table to Parquet
instead of a registry miss.
"""

from typing import Any, List, Optional

from torcheasyrec_tpu_torch.datasets.dataset import BaseReader, BaseWriter

_MSG = (
    "OdpsDataset requires Alibaba MaxCompute wheels (pyodps/common_io) "
    "which are not part of this package. Export the table to Parquet "
    "(odps tunnel / pyodps DataFrame.to_pandas) and use "
    "dataset_type: ParquetDataset."
)


class OdpsReader(BaseReader):
    def __init__(self, input_path: str, batch_size: int,
                 selected_cols: Optional[List[str]] = None,
                 **kwargs: Any) -> None:
        raise NotImplementedError(_MSG)


class OdpsReaderV1(OdpsReader):
    pass


class OdpsWriter(BaseWriter):
    def __init__(self, output_path: str, **kwargs: Any) -> None:
        raise NotImplementedError(_MSG)
