#!/usr/bin/env python3
"""Builds of the row-write kernel compared on one NVIDIA card, in turns.

    python3 tools/row_write_turns/turns.py [SOURCE[:NVCC_FLAG...]] ...

Run from the repository root. Each SOURCE is a CUDA file with the C
interface of torcheasyrec_tpu_torch/ops/csrc/row_write.cu; nvcc flags
for it may follow after colons, as in
``design_a_persistent.cu:-DRW_ROWS_PER_BATCH=8:-DRW_UNROLL=8``. With no
argument the builds are the package's kernel, design A (a persistent
grid, ``design_a_persistent.cu``) at (rows per warp, loads in flight per
lane) = (32, 8), (8, 8), (16, 16) and (32, 32), and design B (a
bulk-copy ring, ``design_b_bulk_ring.cu``).

All are compiled at once with the package's nvcc flags into
``torcheasyrec_tpu_torch/build/turns/``. Each is checked bit for bit as
phase ``kernel_row_write`` of chip_smoke.py checks the package's kernel;
then all are timed at that phase's shapes, warm and cold, in the given
order and then in reverse (the mean of the two). One JSON line per build
and per shape, each with the card's name and power limit.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torcheasyrec_tpu_torch.ops import cuda_build  # noqa: E402
from torcheasyrec_tpu_torch.ops.row_write import (  # noqa: E402
    check_write_inputs,
)

DESIGN_A = (HERE / "design_a_persistent.cu").relative_to(ROOT)
DEFAULT_BUILDS = [
    str((cuda_build.CSRC_DIR / "row_write.cu").relative_to(ROOT)),
    str(DESIGN_A),
    f"{DESIGN_A}:-DRW_ROWS_PER_BATCH=8:-DRW_UNROLL=8",
    f"{DESIGN_A}:-DRW_ROWS_PER_BATCH=16:-DRW_UNROLL=16",
    f"{DESIGN_A}:-DRW_ROWS_PER_BATCH=32:-DRW_UNROLL=32",
    str((HERE / "design_b_bulk_ring.cu").relative_to(ROOT)),
]


def build_all(builds):
    """{build: (library, nvcc's report)}, one nvcc per build, all at once."""
    out_dir = cuda_build.BUILD_DIR / "turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, build in enumerate(builds):
        src, *flags = build.split(":")
        lib = out_dir / f"librow_write_turn{i}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags,
               "-I", str(cuda_build.CSRC_DIR), "-o", str(lib), src]
        procs[build] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for build, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{build}: nvcc exited {proc.returncode}\n{log}")
        built[build] = (lib, log)
    return built


def writer(lib_path):
    """``write(table, ids, rows)`` through the library at ``lib_path``."""
    lib = ctypes.CDLL(str(lib_path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.row_write.argtypes = [p, p, p, ll, ll, i, i, p]
    lib.row_write.restype = i
    lib.row_write_error_string.argtypes = [i]
    lib.row_write_error_string.restype = ctypes.c_char_p

    def write(table, ids, rows):
        check_write_inputs(table, ids, rows)
        if ids.shape[0] == 0:
            return
        rc = lib.row_write(
            table.data_ptr(), ids.data_ptr(), rows.data_ptr(), ids.shape[0],
            table.shape[0], table.shape[1], int(ids.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"row_write launch failed: "
                               f"{lib.row_write_error_string(rc).decode()}")
    return write


def main(builds) -> int:
    if not torch.cuda.is_available():
        print("turns: CUDA is not available", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    built = build_all(builds)
    writers = {}
    for build, (lib, log) in built.items():
        chip_smoke.emit({"build": build, "card": smi, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]})
        writers[build] = writer(lib)
    bench = chip_smoke.RowWriteBench()
    for build in builds:
        chip_smoke.emit({"build": build,
                         "cases_bit_equal": bench.check(writers[build])})
    del bench.ref, bench.ref4
    torch.cuda.empty_cache()
    for name, table, ids, scratch in bench.timing_shapes():
        runs = {build: [] for build in builds}
        for build in builds + builds[::-1]:
            runs[build].append(chip_smoke.write_times(writers[build], table,
                                                      ids))
        chip_smoke.emit({"shape": name, "card": smi,
                         **bench.describe(table, ids, scratch), "ms": {
                             build: {f"{key}_ms": float(np.mean(
                                 [r[f"{key}_ms"] for r in rs]))
                                 for key in ("warm", "cold")}
                             | {"runs": [[r["warm_ms"], r["cold_ms"]]
                                         for r in rs]}
                             for build, rs in runs.items()}})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULT_BUILDS))
