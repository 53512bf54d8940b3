"""One narrow wire buffer per batch, copied to the device in one transfer.

Counterpart of torcheasyrec_tpu/datasets/pack.py. A batch of some forty
small tensors costs forty copies from pinned memory, each with its own
fixed host cost; packed, it costs one. ``pack_batch`` flattens a host
``Batch`` (``torch.utils._pytree``) into one ``uint8`` tensor: every
integer leaf goes in the narrowest type its value envelope allows
(u8/i8/u16/i16/i32, i64 only where the envelope leaves int32), and with
``dense_bf16`` the dense features go as bf16 (under BF16 mixed precision
the model rounds them so anyway). The envelope is sticky per (batch
structure, leaf): it only ever widens, so the spec stays the same from
batch to batch. Sections are laid out widest item first (8-, 4-, 2-,
then 1-byte), so every section's offset is a multiple of its item size
and ``Tensor.view(dtype)`` reads it in place; within one width, leaves
of one (wire kind, dtype) lie side by side.

``unpack_batch`` rebuilds the batch from a wire on any device: each run
of sections of one (wire kind, dtype) viewed as its wire type and
restored to the leaves' own dtype in one conversion (ids to their int32
or int64, bools to bool; bf16 dense leaves to fp32, holding the rounded
values), each leaf a view of it. On a card that is a handful of small
kernels on the caller's stream, where leaf-by-leaf restores would cost
one launch or two a leaf (more host time than the copies they save).

The loader (``datasets/dataset.py``) is the one caller: its producers
pack every batch, its consumer copies the wire and unpacks it on the
card (on the host without one), and the copied batch's ``host`` (for
the consumers that read ids on the host: host-offloaded tables, metrics,
the SID models) is rebuilt from the pinned wire at its first read.
``put_packed``, ``pack_and_put``, ``maybe_unpack`` and
``stack_packed``/``PackedBatchGroup`` are not ported: the port packs
only in the loader's producers and steps one batch at a time.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

# widening envelopes, checked in order
_INT_KINDS = (
    ("u8", 0, 2**8 - 1),
    ("i8", -(2**7), 2**7 - 1),
    ("u16", 0, 2**16 - 1),
    ("i16", -(2**15), 2**15 - 1),
    ("i32", -(2**31), 2**31 - 1),
)
# the wire type of each kind (u16 travels as int16 bits and is widened
# with a mask: uint16 is a shell dtype with few kernels)
_WIRE_DTYPES = {
    "u8": torch.uint8, "i8": torch.int8, "u16": torch.int16,
    "i16": torch.int16, "i32": torch.int32, "i64": torch.int64,
    "f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
    "f64": torch.float64,
}
_FLOAT_KINDS = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64"}
_ITEMSIZE = {k: torch.empty(0, dtype=d).element_size()
             for k, d in _WIRE_DTYPES.items()}

# treespec -> {leaf index: (lo, hi)} value envelopes seen so far
_ENVELOPES: Dict[Any, Dict[int, Tuple[int, int]]] = {}


def _int_kind(lo: int, hi: int) -> str:
    for kind, klo, khi in _INT_KINDS:
        if lo >= klo and hi <= khi:
            return kind
    return "i64"  # the envelope leaves int32: never narrowed


class PackedBatch:
    """One ``uint8`` wire tensor (or numpy array, between a loader worker
    and its parent) and a hashable spec ``(treespec, metas)``;
    ``metas[i] = (kind, byte offset, shape, restore dtype name)``, or
    ``("py", value)`` for a leaf that is no tensor."""

    __slots__ = ("wire", "spec")

    def __init__(self, wire, spec) -> None:
        self.wire = wire
        self.spec = spec

    @property
    def nbytes(self) -> int:
        return int(self.wire.nbytes)

    def to_numpy(self) -> "PackedBatch":
        """The wire as a numpy array and the structure as a string (a
        loader worker's pickle)."""
        treespec, metas = self.spec
        return PackedBatch(self.wire.numpy(),
                           (pytree.treespec_dumps(treespec), metas))

    def pin_memory(self) -> "PackedBatch":
        """The wire in page-locked memory (``DataLoader``'s pin-memory
        thread calls this on a worker's hand-over)."""
        return PackedBatch(torch.as_tensor(self.wire).pin_memory(),
                           _parsed(self.spec))

    def from_numpy(self) -> "PackedBatch":
        """Inverse of ``to_numpy`` (after ``pin_memory`` or not)."""
        return PackedBatch(torch.as_tensor(self.wire), _parsed(self.spec))


_TREESPECS: Dict[str, Any] = {}


def _parsed(spec):
    """``spec`` with the structure a worker sent as a string parsed (once
    per structure)."""
    treespec, metas = spec
    if not isinstance(treespec, str):
        return spec
    if treespec not in _TREESPECS:
        _TREESPECS[treespec] = pytree.treespec_loads(treespec)
    return _TREESPECS[treespec], metas


def _section_key(kind: str, restore: str):
    """Widest item first; within a width, one (kind, dtype) together."""
    return -_ITEMSIZE[kind], kind, restore


def _dense_leaf_ids(batch) -> set:
    return {id(f.values) for attr in ("dense_features",
                                      "sequence_dense_features")
            for f in getattr(batch, attr).values()}


def pack_batch(batch, dense_bf16: bool = False,
               pin: bool = False) -> PackedBatch:
    """A host batch as one narrow wire (page-locked with ``pin``)."""
    leaves, treespec = pytree.tree_flatten(batch)
    bf16_ids = _dense_leaf_ids(batch) if dense_bf16 else set()
    envs = _ENVELOPES.setdefault(treespec, {})
    plan = []  # (flat tensor, kind, restore) or ("py", value)
    for idx, leaf in enumerate(leaves):
        if not isinstance(leaf, (torch.Tensor, np.ndarray)):
            plan.append(("py", leaf))
            continue
        a = torch.as_tensor(leaf)
        if a.device.type != "cpu":
            raise ValueError(f"pack_batch: leaf {idx} lies on {a.device}; "
                             "the wire is built on the host")
        restore = str(a.dtype).removeprefix("torch.")
        if a.dtype == torch.bool:
            kind = "u8"
        elif a.dtype.is_floating_point:
            kind = ("bf16" if id(leaf) in bf16_ids
                    else _FLOAT_KINDS.get(a.dtype))
            if kind is None:
                raise ValueError(f"pack_batch: leaf {idx} has dtype "
                                 f"{a.dtype}, which no wire kind carries")
        else:
            env = envs.get(idx)
            seen = _int_kind(*env) if env is not None else None
            if seen == "i64" or (seen == "i32" and a.element_size() <= 4):
                # as wide as the leaf's type lets it get: no scan can
                # widen it further
                kind = seen
            else:
                lo, hi = ((int(a.min()), int(a.max())) if a.numel()
                          else (0, 0))
                if env is not None:
                    lo, hi = min(lo, env[0]), max(hi, env[1])
                envs[idx] = (lo, hi)
                kind = _int_kind(lo, hi)
        plan.append((a.reshape(-1), kind, restore))
    # a leaf that is no tensor keeps its value in the spec
    metas: List[Any] = [p if isinstance(p[0], str) else None for p in plan]
    order = sorted((i for i, m in enumerate(metas) if m is None),
                   key=lambda i: _section_key(*plan[i][1:]))
    off = 0
    for i in order:
        a, kind, restore = plan[i]
        metas[i] = (kind, off, tuple(leaves[i].shape), restore)
        off += a.numel() * _ITEMSIZE[kind]
    wire = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
    for i in order:
        a, kind, _ = plan[i]
        o = metas[i][1]
        nb = a.numel() * _ITEMSIZE[kind]
        if nb:
            wire[o:o + nb].view(_WIRE_DTYPES[kind]).copy_(a)
    return PackedBatch(wire, (treespec, tuple(metas)))


def unpack_batch(packed: PackedBatch, wire: Optional[torch.Tensor] = None):
    """The batch from ``wire`` (default: the packed batch's own), on the
    wire's device: each run of adjacent sections of one (wire kind,
    dtype) viewed as its wire type and restored to that dtype at once
    (no copy where they agree), each leaf a view of the result."""
    treespec, metas = packed.spec
    wire = torch.as_tensor(packed.wire if wire is None else wire)
    leaves = [m[1] if m[0] == "py" else None for m in metas]
    runs: List[list] = []  # [kind, restore, first byte, end byte, leaves]
    for i in sorted((i for i, m in enumerate(metas) if m[0] != "py"),
                    key=lambda i: metas[i][1]):
        kind, off, shape, restore = metas[i]
        n = int(np.prod(shape)) if shape else 1
        end = off + n * _ITEMSIZE[kind]
        if runs and runs[-1][:2] == [kind, restore] and runs[-1][3] == off:
            runs[-1][3] = end
            runs[-1][4].append((i, n, shape))
        else:
            runs.append([kind, restore, off, end, [(i, n, shape)]])
    for kind, restore, a, b, members in runs:
        part = wire[a:b].view(_WIRE_DTYPES[kind])
        if kind == "u16":
            part = part.to(torch.int32) & 0xFFFF
        want = getattr(torch, restore)
        if part.dtype != want:
            part = part.to(want)
        parts = part.split([n for _, n, _ in members])
        for (i, _, shape), x in zip(members, parts):
            leaves[i] = x.view(shape)
    return pytree.tree_unflatten(leaves, treespec)


def unify_spec(packed: PackedBatch,
               kind_state: Dict[Any, List[str]]) -> PackedBatch:
    """Keep one wire kind per (structure, leaf) across the loader's
    workers, each of which keeps envelopes of its own: ``kind_state``
    holds the kinds seen so far, and a batch whose integer leaf came
    narrower, or two that disagree, go to i32 (i64 where either is).
    Float and bool kinds must agree."""
    treespec, metas = packed.spec
    kinds = [m[0] for m in metas]
    cur = kind_state.get(treespec)
    if cur is None:
        kind_state[treespec] = kinds
        return packed
    target = list(cur)
    for i, (a, b) in enumerate(zip(cur, kinds)):
        if a == b:
            continue
        restore = metas[i][3] if metas[i][0] != "py" else None
        if restore is None or restore in ("bool",) or (
                getattr(torch, restore).is_floating_point):
            raise ValueError(
                f"pack spec mismatch on leaf {i}: {a} vs {b} (restore "
                f"{restore}): the loader's workers disagree on a wire "
                "kind that is no integer's")
        target[i] = "i64" if "i64" in (a, b) else "i32"
    kind_state[treespec] = target
    if target == kinds:
        return packed
    return _repack(packed, target)


def _repack(packed: PackedBatch, target: List[str]) -> PackedBatch:
    """The wire re-encoded with the given kinds (on the host)."""
    treespec, metas = packed.spec
    wire = torch.as_tensor(packed.wire)
    order = sorted((i for i, m in enumerate(metas) if m[0] != "py"),
                   key=lambda i: _section_key(target[i], metas[i][3]))
    new_metas = list(metas)
    off = 0
    for i in order:
        _, _, shape, restore = metas[i]
        new_metas[i] = (target[i], off, shape, restore)
        off += (int(np.prod(shape)) if shape else 1) * _ITEMSIZE[target[i]]
    new_wire = torch.empty(off, dtype=torch.uint8,
                           pin_memory=wire.is_pinned())
    for i in order:
        kind, o, shape, _ = metas[i]
        n = int(np.prod(shape)) if shape else 1
        if not n:
            continue
        src = wire[o:o + n * _ITEMSIZE[kind]].view(_WIRE_DTYPES[kind])
        if kind == "u16":
            src = src.to(torch.int32) & 0xFFFF
        to = new_metas[i][1]
        new_wire[to:to + n * _ITEMSIZE[target[i]]].view(
            _WIRE_DTYPES[target[i]]).copy_(src)
    return PackedBatch(new_wire, (treespec, tuple(new_metas)))

