"""Named shared-memory packs of numpy arrays.

Counterpart of torcheasyrec_tpu/utils/shm_pack.py (plain numpy and the
standard library). One segment holds many flat arrays behind a header
(the pickled {name: (dtype, shape, offset)}): ``build`` creates and fills
it once, ``attach`` gives zero-copy numpy views of it in any process of
the host, ``unlink`` removes it. The samplers publish their item and
edge tables this way, so the loader's worker processes share one copy.
"""

import atexit
import mmap
import os
import pickle
import struct
from multiprocessing import shared_memory
from typing import Dict, Tuple

import numpy as np

_HDR = struct.Struct("<Q")  # header length
# segments this process created, by name; ``attach`` in the creating
# process reads through them
_OWNED: Dict[str, shared_memory.SharedMemory] = {}


def _attach_buf(name: str):
    """An mmap of an existing segment, without ``SharedMemory``: attaching
    through ``multiprocessing`` registers the segment with the resource
    tracker, which would unlink it when the attaching worker exits
    (Python < 3.13 has no ``track=False``). POSIX segments are files
    under /dev/shm."""
    try:
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
    except FileNotFoundError:
        # a POSIX system without /dev/shm: attach through multiprocessing
        seg = shared_memory.SharedMemory(name=name)
        _OWNED.setdefault(f"__attached__{name}", seg)
        return seg.buf
    try:
        return mmap.mmap(fd, os.fstat(fd).st_size)
    finally:
        os.close(fd)


def build(name: str, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Creates segment ``name`` holding ``arrays`` (a segment of that
    name is replaced); returns views into it. It lasts until ``unlink``,
    or the exit of this process."""
    unlink(name)
    arrays = {k: np.ascontiguousarray(a) for k, a in arrays.items()}
    meta: Dict[str, Tuple[str, tuple, int]] = {}
    off = 0
    for k, a in arrays.items():
        meta[k] = (a.dtype.str, a.shape, off)
        off += a.nbytes
    header = pickle.dumps(meta)
    base = _HDR.size + len(header)
    shm = shared_memory.SharedMemory(create=True, size=max(base + off, 1),
                                     name=name)
    _OWNED[name] = shm
    shm.buf[:_HDR.size] = _HDR.pack(len(header))
    shm.buf[_HDR.size:base] = header
    views: Dict[str, np.ndarray] = {}
    for k, a in arrays.items():
        dt, shape, o = meta[k]
        v = np.ndarray(shape, dtype=dt, buffer=shm.buf, offset=base + o)
        v[...] = a
        views[k] = v
    return views


def attach(name: str) -> Dict[str, np.ndarray]:
    """Zero-copy numpy views of an existing segment."""
    buf = _OWNED[name].buf if name in _OWNED else _attach_buf(name)
    (hlen,) = _HDR.unpack_from(buf, 0)
    meta = pickle.loads(bytes(buf[_HDR.size:_HDR.size + hlen]))
    base = _HDR.size + hlen
    return {k: np.ndarray(shape, dtype=dt, buffer=buf, offset=base + o)
            for k, (dt, shape, o) in meta.items()}


def segment_bytes(name: str) -> int:
    """The size of segment ``name`` as the system holds it."""
    if name in _OWNED:
        return _OWNED[name].size
    return os.stat(f"/dev/shm/{name}").st_size


def unlink(name: str) -> None:
    """Removes segment ``name``: its name goes at once, its memory when
    the last view of it in any process is gone."""
    shm = _OWNED.pop(name, None)
    if shm is None:
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            return
    try:
        shm.unlink()
    except FileNotFoundError:
        pass
    try:
        shm.close()
    except BufferError:
        # views of it are still alive here: the mapping goes with them
        pass


def _cleanup() -> None:
    for name in [n for n in _OWNED if not n.startswith("__attached__")]:
        unlink(name)


atexit.register(_cleanup)
