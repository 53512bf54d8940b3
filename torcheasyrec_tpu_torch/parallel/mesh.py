"""The ranks of one training job and the collectives the port runs over
them.

Counterpart of torcheasyrec_tpu/parallel/mesh.py. The JAX package runs
one SPMD program over a ``Mesh`` of devices; the port runs one process
per rank (``torchrun``), each on its own part of the global batch. A
``ShardContext`` stands where the JAX ``Mesh`` stands: the rank, the
world size, the process group, the ranks of one host and the rank's
device. Only the flat layout is ported: the two-level ``("dcn",
"ici")`` mesh and its hierarchical exchange are not.

Every collective of the port goes through three calls of
``torch.distributed``: ``all_reduce``, ``all_gather`` and
``all_to_all_single``, so NCCL (one card per rank) and gloo (ranks that
share a card, or run on the CPU) run the same code. Under gloo a card
tensor is copied to the host for the collective and back.
``all_to_all`` takes variable splits: the split sizes travel first, in
one small exchange, so no side needs a fixed capacity.
``ShardContext.sent_bytes`` counts the bytes this rank has handed to
the collectives (its own contribution to each), for the exchange-bytes
metric.
"""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class ShardContext:
    rank: int
    world: int
    device: torch.device
    local_world: int = 1
    group: Optional[object] = None  # a ProcessGroup; None = the default
    backend: str = "gloo"
    sent_bytes: int = 0
    # ``side()``'s context, made at its first call
    _side: Optional["ShardContext"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _count(self, t: torch.Tensor) -> None:
        self.sent_bytes += t.numel() * t.element_size()

    # -- plain collectives -----------------------------------------------

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor where the backend takes it: on the host for gloo,
        on the rank's card for NCCL."""
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        return t.to(dev).contiguous()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """A new tensor: ``t`` reduced over the ranks."""
        buf = self._stage(t).clone()
        self._count(buf)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` staged, its 16-bit floats as int16 bits under gloo (which
        has no bf16 reduction-free transfer of its own)."""
        src = self._stage(t)
        if self.backend == "gloo" and src.dtype in (torch.bfloat16,
                                                   torch.float16):
            return src.view(torch.int16)
        return src

    def all_gather_list(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on every rank), in rank
        order."""
        src = self._wire(t)
        self._count(src)
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src, group=self.group)
        return [o.view(t.dtype).to(t.device) for o in out]

    def all_gather_var(self, t: torch.Tensor):
        """(every rank's ``t`` concatenated along dim 0 in rank order,
        each rank's row count): the counts travel first, then the rows
        padded to the largest count."""
        n = torch.tensor([t.shape[0]], dtype=torch.int64)
        counts = [int(c) for c in
                  torch.cat(self.all_gather_list(n)).tolist()]
        top = max(counts)
        padded = t.new_zeros((top,) + tuple(t.shape[1:]))
        padded[:t.shape[0]] = t
        parts = self.all_gather_list(padded)
        return torch.cat([p[:c] for p, c in zip(parts, counts)]), counts

    def exchange_counts(self, send: Sequence[int]) -> List[int]:
        """What each rank will send to this one, given what this one
        sends to each rank."""
        s = self._stage(torch.tensor(list(send), dtype=torch.int64))
        self._count(s)
        r = torch.empty_like(s)
        dist.all_to_all_single(r, s, group=self.group)
        return [int(x) for x in r.tolist()]

    def all_to_all(self, t: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        """Rows ``t`` split by ``send`` (consecutive blocks, one a rank)
        out; ``sum(recv)`` rows in, in rank order."""
        src = self._wire(t)
        self._count(src)
        out = src.new_empty((int(sum(recv)),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, src, list(map(int, recv)),
                               list(map(int, send)), group=self.group)
        return out.view(t.dtype).to(t.device)

    def side(self) -> "ShardContext":
        """A context over the same ranks on a process group of its own,
        for collectives that a thread issues beside the ones of the
        thread that runs the step (the staged id route): two groups never
        match one group's collectives against the other's. Made at the
        first call, which is collective: every rank calls it at the same
        point. Its ``sent_bytes`` count apart."""
        if self._side is None:
            ranks = (None if self.group is None
                     else dist.get_process_group_ranks(self.group))
            group = dist.new_group(ranks, backend=self.backend)
            self._side = dataclasses.replace(self, group=group, sent_bytes=0,
                                             _side=None)
        return self._side

    def barrier(self) -> None:
        # an all_reduce, not ``dist.barrier``: NCCL's barrier guesses the
        # card from the rank, which is wrong where ranks share a card
        self.all_reduce(torch.zeros(1))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, with the sum of the upstream gradients as the
    gradient (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce(g), None


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in rank order; the gradient of a
    rank's own rows is the sum over the ranks of the gradients of those
    rows (an ``all_reduce`` of the whole gradient, then this rank's
    slice: no ``reduce_scatter``, which gloo refuses on the card)."""

    @staticmethod
    def forward(ctx, x, shard):
        out, counts = shard.all_gather_var(x)
        ctx.shard = shard
        ctx.lo = sum(counts[:shard.rank])
        ctx.n = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        full = ctx.shard.all_reduce(g.contiguous())
        return full[ctx.lo:ctx.lo + ctx.n], None


def all_reduce_with_grad(x: torch.Tensor,
                         shard: Optional[ShardContext]) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself at world
    size 1."""
    if shard is None or shard.world <= 1:
        return x
    return _AllReduceSum.apply(x, shard)


def all_gather_with_grad(x: torch.Tensor,
                         shard: Optional[ShardContext]) -> torch.Tensor:
    """Every rank's rows of ``x`` (any counts) in rank order,
    differentiable; ``x`` itself at world size 1."""
    if shard is None or shard.world <= 1:
        return x
    return _AllGatherRows.apply(x, shard)


def gather_rows(x: torch.Tensor,
                shard: Optional[ShardContext]) -> torch.Tensor:
    """Every rank's rows of ``x`` (any counts) in rank order, without a
    gradient (labels, session ids); ``x`` itself at world size 1."""
    if shard is None or shard.world <= 1:
        return x
    return shard.all_gather_var(x.detach())[0]


def row_offset(n: int, shard: Optional[ShardContext]) -> int:
    """The global row of this rank's first row, given its ``n`` rows: the
    rows of the ranks before it (0 at world size 1)."""
    if shard is None or shard.world <= 1:
        return 0
    counts = shard.all_gather_list(torch.tensor([n]))
    return int(sum(int(c) for c in counts[:shard.rank]))


def logsumexp_rows(x: torch.Tensor,
                   shard: Optional[ShardContext]) -> torch.Tensor:
    """``torch.logsumexp(x, dim=0, keepdim=True)`` over the global batch
    (the rows of every rank), differentiable: the columns' max is
    all-reduced first, then the shifted sums of exponentials."""
    if shard is None or shard.world <= 1:
        return torch.logsumexp(x, dim=0, keepdim=True)
    top = shard.all_reduce(x.detach().amax(dim=0, keepdim=True),
                           op=dist.ReduceOp.MAX)
    top = torch.where(torch.isfinite(top), top, top.new_zeros(()))
    total = all_reduce_with_grad((x - top).exp().sum(dim=0, keepdim=True),
                                 shard)
    return top + total.log()


def gather_host_steps(parts: Sequence[np.ndarray],
                      shard: Optional[ShardContext]) -> np.ndarray:
    """Host buffers that each rank filled one step at a time (``parts[j]``
    its rows of step j, every rank's of the same width), as one array in
    global batch order: step 0's rows of rank 0, of rank 1, ..., then step
    1's. A rank may hold fewer steps than another. The parts concatenated
    at world size 1."""
    if not parts:
        return np.zeros((0, 0), np.float32)
    local = np.concatenate(parts)
    if shard is None or shard.world <= 1:
        return local
    rows, _ = shard.all_gather_var(torch.from_numpy(local))
    step_counts, per_rank = shard.all_gather_var(
        torch.tensor([len(p) for p in parts], dtype=torch.int64))
    rows, step_counts = rows.numpy(), step_counts.tolist()
    blocks, pos = [], 0
    for n_steps in per_rank:
        mine = []
        for c in step_counts[:n_steps]:
            mine.append(rows[pos:pos + c])
            pos += c
        step_counts = step_counts[n_steps:]
        blocks.append(mine)
    return np.concatenate([b[j] for j in range(max(per_rank))
                           for b in blocks if j < len(b)])


def global_count(x, shard: Optional[ShardContext]) -> torch.Tensor:
    """A count or sum of weights over the ranks, without a gradient."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if shard is None or shard.world <= 1:
        return x
    return shard.all_reduce(x.detach())


def batch_mean(numer: torch.Tensor, denom,
               shard: Optional[ShardContext], eps: float = 0.0
               ) -> torch.Tensor:
    """A mean over the global batch from this rank's sum ``numer`` and
    count (or weight sum) ``denom``, scaled so that the mean of the
    ranks' values is the global mean: ``numer * world / sum(denom)``,
    the sum clamped at ``eps``. ``numer / denom`` at world size 1."""
    if shard is None or shard.world <= 1:
        return numer / (denom.clamp(min=eps) if eps else denom)
    total = global_count(denom, shard).to(numer.device)
    return numer * shard.world / (total.clamp(min=eps) if eps else total)
