"""Process-group set-up and host-side collectives of a training job.

Counterpart of torcheasyrec_tpu/utils/dist_util.py. The port runs one
process per rank, launched as the reference launches it
(``python -m torch.distributed.run --nproc_per_node N -m
torcheasyrec_tpu_torch.train_eval ...``): ``init_distributed`` reads
torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``, or takes them
as arguments (with a ``FileStore`` path in place of the address, as
tests and ``chip_smoke.py`` spawn their ranks). A rank's device is
``cuda:{LOCAL_RANK % device_count}``. The backend is NCCL when every
rank of the host has a card of its own, and gloo when ranks share a
card or run on the CPU (NCCL refuses two ranks on one card); the choice
is logged.

The host-side helpers (``barrier``, ``broadcast_host_data``,
``gather_host_array``, ``gather_host_sum``, ``all_workers_have_data``)
take the ``ShardContext`` and are the identity at world size 1 or
without one. ``spawn_ranks`` runs a function on N spawned ranks with a
``FileStore`` rendezvous and a time limit (the tests and
``chip_smoke.py`` use it in place of torchrun).
"""

import datetime
import logging
import os
import pickle
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from torcheasyrec_tpu_torch.parallel.mesh import ShardContext

logger = logging.getLogger("tzrec_tpu_torch")

# how long a collective waits for the other ranks before it raises: a
# rank that died inside a collective must not hang the others for ever
DEFAULT_TIMEOUT_S = 600


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v != "" else default


def launched_world_size() -> int:
    """``WORLD_SIZE`` as torchrun sets it; 1 outside torchrun."""
    return _env_int("WORLD_SIZE", 1)


def pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when the ranks of a host each have a card, else gloo."""
    if (device.type == "cuda" and torch.cuda.is_available()
            and local_world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_distributed(device: Any = "cuda", rank: Optional[int] = None,
                     world: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world: Optional[int] = None,
                     store_path: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardContext:
    """Join the job's process group and return this rank's
    ``ShardContext``. The arguments default to torchrun's environment;
    ``store_path`` rendezvous through a ``FileStore`` (no port),
    else ``MASTER_ADDR``/``MASTER_PORT`` through the environment.
    ``device`` "cuda" gives the rank ``cuda:{local_rank %
    device_count}`` and raises without CUDA; "cpu" keeps it on the
    host. ``backend`` overrides ``pick_backend``."""
    rank = _env_int("RANK", 0) if rank is None else rank
    world = launched_world_size() if world is None else world
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None \
        else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE", world) \
        if local_world is None else local_world
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or pick_backend(dev, local_world)
    kwargs = {"backend": backend, "rank": rank, "world_size": world,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if store_path is not None:
        kwargs["store"] = dist.FileStore(store_path, world)
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        kwargs["device_id"] = dev
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)
    logger.info(f"rank {rank} of {world}: backend {backend} on {dev}")
    return ShardContext(rank=rank, world=world, device=dev,
                        local_world=local_world, backend=backend)


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process(shard: Optional[ShardContext]) -> bool:
    return shard is None or shard.rank == 0


def _multi(shard: Optional[ShardContext]) -> bool:
    return shard is not None and shard.world > 1


def barrier(shard: Optional[ShardContext]) -> None:
    if _multi(shard):
        shard.barrier()


def broadcast_host_data(shard: Optional[ShardContext], data: Any) -> Any:
    """Rank 0's ``data`` (any picklable object) on every rank."""
    if not _multi(shard):
        return data
    box = [data]
    dist.broadcast_object_list(box, src=0, group=shard.group,
                               device=shard._stage(torch.zeros(1)).device)
    return box[0]


def gather_host_array(shard: Optional[ShardContext], arr) -> np.ndarray:
    """Every rank's rows of ``arr`` concatenated in rank order, on every
    rank (the row counts travel first; each rank pads to the largest and
    the padding is trimmed)."""
    a = np.asarray(arr)
    if not _multi(shard):
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    out, _ = shard.all_gather_var(t)
    return out.numpy()


def gather_host_objects(shard: Optional[ShardContext], obj: Any) -> list:
    """Every rank's ``obj`` (any picklable object), in rank order."""
    if not _multi(shard):
        return [obj]
    out = [None] * shard.world
    dist.all_gather_object(out, obj, group=shard.group)
    return out


def gather_host_sum(shard: Optional[ShardContext], *vals) -> tuple:
    """Each value summed over the ranks, in float64."""
    if not _multi(shard):
        return tuple(float(v) for v in vals)
    t = shard.all_reduce(torch.tensor([float(v) for v in vals],
                                      dtype=torch.float64))
    return tuple(float(v) for v in t.tolist())


def all_workers_have_data(shard: Optional[ShardContext],
                          has_data: bool) -> bool:
    """True only when every rank has a batch: the ranks stop together
    on uneven input (the reference's ``check_all_workers_data_status``)."""
    if not _multi(shard):
        return bool(has_data)
    t = shard.all_reduce(torch.tensor([1 if has_data else 0]),
                         op=dist.ReduceOp.MIN)
    return bool(int(t.item()))


def any_worker_has_data(shard: Optional[ShardContext],
                        has_data: bool) -> bool:
    if not _multi(shard):
        return bool(has_data)
    t = shard.all_reduce(torch.tensor([1 if has_data else 0]),
                         op=dist.ReduceOp.MAX)
    return bool(int(t.item()))


def global_min_int(shard: Optional[ShardContext],
                   value: Optional[int]) -> Optional[int]:
    """The smallest of the ranks' values (None where a rank has none);
    None when no rank has one. The event-time quorum of checkpoints."""
    if not _multi(shard):
        return value
    big = np.iinfo(np.int64).max
    t = shard.all_reduce(
        torch.tensor([big if value is None else int(value)],
                     dtype=torch.int64), op=dist.ReduceOp.MIN)
    v = int(t.item())
    return None if v == big else v


def _rank_main(rank: int, world: int, fn: Callable, args: Sequence,
               store_path: str, device: str, backend: Optional[str],
               timeout_s: float, out) -> None:
    import faulthandler

    faulthandler.enable()  # a rank that crashes leaves its stack on stderr
    try:
        shard = init_distributed(device, rank=rank, world=world,
                                 local_rank=rank, local_world=world,
                                 store_path=store_path, backend=backend,
                                 timeout_s=timeout_s)
        # plain pickle bytes: a tensor put as it is would travel as a
        # shared-memory handle that dies with this process
        out.put((rank, True, pickle.dumps(fn(shard, *args))))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        destroy_distributed()


class RankJob:
    """``world`` spawned ranks running ``fn(shard, *args)`` (see
    ``start_ranks``); ``wait`` collects their results."""

    def __init__(self, fn: Callable, world: int, args: Sequence,
                 store_dir: Optional[str], device: str = "cuda",
                 backend: Optional[str] = None,
                 timeout_s: float = 120.0) -> None:
        import tempfile

        import torch.multiprocessing as mp

        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            # as ``init_distributed`` would in every rank, before a spawn
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the ranks "
                "on the CPU")

        ctx = mp.get_context("spawn")
        self._out = ctx.Queue()
        fd, self._store = tempfile.mkstemp(prefix="rank_store_",
                                           dir=store_dir)
        os.close(fd)
        os.remove(self._store)
        self._world, self._timeout = world, timeout_s
        self._deadline = time.monotonic() + timeout_s
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, world, fn, tuple(args), self._store, device,
                              backend, timeout_s, self._out), daemon=True)
            for r in range(world)]
        for p in self._procs:
            p.start()

    def wait(self) -> List[Any]:
        """Each rank's result, in rank order. A rank that raises, or the
        time limit, kills every rank and raises RuntimeError with the
        ranks' tracebacks."""
        results, errors, first_error = {}, [], 0.0
        try:
            while len(results) + len(errors) < self._world:
                left = self._deadline - time.monotonic()
                if errors:
                    # the other ranks' errors follow the first one's
                    left = min(left, 3.0 - (time.monotonic() - first_error))
                if left <= 0:
                    if not errors:
                        errors.append(
                            f"ranks timed out after {self._timeout} s")
                    break
                try:
                    rank, ok, val = self._out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if p.exitcode not in (None, 0)]
                    if dead and not errors:
                        errors.append(f"a rank exited with {dead[0]} and "
                                      "no result")
                        first_error = time.monotonic()
                    continue
                if ok:
                    results[rank] = pickle.loads(val)
                else:
                    if not errors:
                        first_error = time.monotonic()
                    errors.append(f"rank {rank} raised:\n{val}")
        finally:
            for p in self._procs:
                p.join(timeout=0.1 if errors else 10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            if os.path.exists(self._store):
                os.remove(self._store)
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(self._world)]


def start_ranks(fn: Callable, world: int, args: Sequence = (),
                store_dir: Optional[str] = None, device: str = "cuda",
                backend: Optional[str] = None,
                timeout_s: float = 120.0) -> RankJob:
    """Spawn ``world`` ranks running ``fn(shard, *args)`` (a
    ``FileStore`` under ``store_dir`` for the rendezvous; ``fn`` must be
    importable by name) and return at once; the time limit runs from
    now. Each rank's device is as ``init_distributed`` gives it: a card
    by default (RuntimeError here without CUDA), the host with
    ``device="cpu"``."""
    return RankJob(fn, world, args, store_dir, device, backend, timeout_s)


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                store_dir: Optional[str] = None, device: str = "cuda",
                backend: Optional[str] = None,
                timeout_s: float = 120.0) -> List[Any]:
    """``start_ranks(...).wait()``: every rank's result, in rank order."""
    return start_ranks(fn, world, args, store_dir, device, backend,
                       timeout_s).wait()
