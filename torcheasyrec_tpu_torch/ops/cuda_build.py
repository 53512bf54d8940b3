"""Build and load the hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into
``torcheasyrec_tpu_torch/build/lib<name>-<source hash>.so`` and loaded
with ctypes; an edit of the source, of a shared ``csrc/*.cuh`` header or
of the flags changes the hash and so rebuilds. nvcc's output (with
``ptxas``'s registers, shared memory and spills per kernel) is kept
beside the library as ``.log``; ``ptxas_usage`` reads it. Nothing
here runs at import time, so the package imports where there is no
``nvcc`` and no card.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns seconds per kernel built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def _short(mangled: str) -> str:
    """The kernel's own name of an Itanium-mangled symbol, with its integer
    template arguments: ``hstu_bwd_bf16<128,128>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:Li\d+E)+)", mangled[i:])
    if args:
        values = re.findall(r"Li(\d+)E", args.group(1))
        name += "<" + ",".join(values) + ">"
    return name


def ptxas_usage(name: str) -> List[dict]:
    """Per kernel of library ``name`` (built): registers per thread, static
    shared memory and spill bytes as ``ptxas -v`` reported them. Dynamic
    shared memory is set at launch and is not in ptxas's report."""
    log = library_path(name).with_suffix(".log")
    rows, entry, spills = [], None, (0, 0)
    for line in log.read_text().splitlines() if log.exists() else []:
        if m := _ENTRY.search(line):
            entry, spills = _short(m.group(1)), (0, 0)
        elif (m := _SPILLS.search(line)) and entry:
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := _USED.search(line)) and entry:
            rows.append({"kernel": entry, "registers": int(m.group(1)),
                         "static_smem_bytes": int(m.group(2) or 0),
                         "spill_store_bytes": spills[0],
                         "spill_load_bytes": spills[1]})
            entry = None
    return rows
