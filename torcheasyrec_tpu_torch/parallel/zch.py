"""Zero-collision hashing: raw ids remapped to slots of a fixed-size table.

Counterpart of torcheasyrec_tpu/parallel/zch.py. The mapping is an
open-addressing table held as tensors on the model's device (``keys``,
``count``, ``last``, and with frequency admission ``admit_cnt``). Each
id probes K = 8 double-hashed slots; resolution is match > empty >
evict the probe slot of least score. Eviction happens on insert.

Eviction scores (feature.proto ZeroCollisionHash):
  lfu:          score = access count
  lru:          score = 1 / (step - last) ** decay
  distance_lfu: score = count / (step - last) ** decay

``eviction_interval`` > 1: an occupied slot may be displaced only on
steps where ``step % interval == 0``; between sweeps an unmatched id
without an empty probe slot maps to -1 (a zero row, no update).
Frequency admission counts ids in a hashed counter of ``counter_size``
slots; an id below ``admit_threshold`` maps to -1.
``threshold_filtering_func`` is a lambda string over the batch's
per-id occurrence counts returning a keep mask (or (mask, threshold));
it is evaluated with ``torch`` bound to the names ``jnp`` and ``np``.

Everything the JAX reference leaves to its scatter semantics is made
explicit here, so that the card and the CPU agree bit for bit:

- raw ids are cast to int32 as the reference casts them (an id of 2^31
  or more wraps; one that wraps negative is padding);
- the uint32 hashes run in int64, masked to 32 bits after each multiply;
- when several ids of one batch write the same slot, the element of the
  largest flat position wins (XLA's CPU scatter is last-writer-wins);
  the count of a slot is reset to 0 where any writer is fresh, then
  raised by 1 per writer, in that order;
- ``argmax``/``argmin`` over the K probes take the first index.
"""

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

N_PROBES = 8
_M32 = 0xFFFFFFFF

State = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ZchConfig:
    size: int
    policy: str = "lfu"  # lfu | lru | distance_lfu
    decay_exponent: float = 1.0
    eviction_interval: int = 1  # evict only when step % interval == 0
    admit_threshold: int = 0  # frequency admission (0 = admit all)
    counter_size: int = 0  # admission counter slots
    filter_fn: Any = None  # threshold_filtering_func lambda string


def init_state(size: int, counter_size: int = 0, device=None) -> State:
    st = {
        "keys": torch.full((size,), -1, dtype=torch.int32, device=device),
        "count": torch.zeros(size, dtype=torch.float32, device=device),
        "last": torch.zeros(size, dtype=torch.int32, device=device),
    }
    if counter_size > 0:
        st["admit_cnt"] = torch.zeros(counter_size, dtype=torch.float32,
                                      device=device)
    return st


def wrap_int32(ids: torch.Tensor) -> torch.Tensor:
    """int64 ids cast to int32 two's complement, kept as int64."""
    v = ids.long() & _M32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v)


def _batch_counts(flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per element: how often its id occurs in the batch (the invalid
    elements count as one id)."""
    ids = torch.where(valid, flat, flat.new_full((), -2))
    _, inv, counts = torch.unique(ids, return_inverse=True,
                                  return_counts=True)
    return counts[inv].float()


def _apply_filter_fn(fn: Any, counts: torch.Tensor) -> torch.Tensor:
    """threshold_filtering_func -> bool keep mask."""
    if isinstance(fn, str):
        fn = eval(fn, {"jnp": torch, "np": torch,  # noqa: S307
                       "torch": torch})
    try:
        out = fn(counts)
    except AttributeError as e:
        raise NotImplementedError(
            f"threshold_filtering_func needs a jnp function torch lacks: "
            f"{e}") from e
    if isinstance(out, tuple):
        mask, thr = out[0], out[1]
        if mask is None:
            return counts > thr
        return torch.as_tensor(mask).bool() & (counts > thr)
    return torch.as_tensor(out).bool()


def _hash1(ids: torch.Tensor, size: int) -> torch.Tensor:
    x = ids & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    return x % size


def _hash2(ids: torch.Tensor, size: int) -> torch.Tensor:
    x = ids & _M32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    x = ((x ^ (x >> 12)) * 0x297A2D39) & _M32
    x = x ^ (x >> 15)
    return x % max(size - 1, 1) + 1


def _scores(state: State, cfg: ZchConfig, step: int) -> torch.Tensor:
    age = torch.clamp((step - state["last"]).float(), min=1.0)
    if cfg.policy == "lru":
        return age ** (-cfg.decay_exponent)
    if cfg.policy == "distance_lfu":
        return state["count"] / (age ** cfg.decay_exponent)
    return state["count"]  # lfu


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1, or K where there is none."""
    ext = torch.cat([mask, mask.new_ones(mask.shape[0], 1)], dim=1)
    return torch.argmax(ext.to(torch.int32), dim=1)


def _scatter_padded(base: torch.Tensor, idx: torch.Tensor,
                    vals) -> torch.Tensor:
    """``base`` with ``base[idx] = vals`` where idx < len(base); idx ==
    len(base) is dropped. Callers give each kept index one value."""
    out = torch.cat([base, base.new_zeros(1)])
    out[idx] = vals if isinstance(vals, torch.Tensor) else out.new_full(
        (), vals)
    return out[:-1]


def lookup_insert(
    state: State, cfg: ZchConfig, ids: torch.Tensor, step: int,
    training: bool, collect_spill: bool = False,
) -> Union[Tuple[torch.Tensor, State],
           Tuple[torch.Tensor, State, Dict[str, torch.Tensor]]]:
    """(slots shaped like ``ids``, int32, -1 where the id reads a zero
    row; the new state). The state is not modified in place.

    With ``collect_spill`` also the host-spill record, per element:
    ``evicted_keys`` (the raw key this element displaced from its slot,
    else -1), ``fresh_keys`` (the raw key newly inserted at its slot,
    else -1) and ``slots``, all int32 [N]."""
    shape = ids.shape
    flat = wrap_int32(ids.reshape(-1))
    n = flat.shape[0]
    dev = flat.device
    size = state["keys"].shape[0]
    valid = flat >= 0
    step = int(step)

    new_admit = state.get("admit_cnt")
    if cfg.admit_threshold > 0 and new_admit is not None:
        csize = new_admit.shape[0]
        cslots = _hash1(flat, csize)
        if training:
            new_admit = new_admit + torch.zeros(
                csize + 1, device=dev).index_add_(
                    0, torch.where(valid, cslots, cslots.new_full((), csize)),
                    torch.ones(n, device=dev))[:csize]
        valid = valid & (new_admit[cslots] >= cfg.admit_threshold)

    writable = valid
    if cfg.filter_fn and training:
        writable = valid & _apply_filter_fn(cfg.filter_fn,
                                            _batch_counts(flat, valid))

    h1 = _hash1(flat, size)
    h2 = _hash2(flat, size)
    probes = (h1[:, None] + torch.arange(N_PROBES, device=dev)[None, :]
              * h2[:, None]) % size  # [N, K]
    keys_at = state["keys"][probes].long()
    # padding (-1) must never match the empty-slot sentinel (-1)
    is_match = (keys_at == flat[:, None]) & valid[:, None]
    is_empty = keys_at == -1
    match_k = _first_true(is_match)
    empty_k = _first_true(is_empty)
    evict_k = torch.argmin(_scores(state, cfg, step)[probes], dim=1)
    has_match = match_k < N_PROBES
    has_empty = empty_k < N_PROBES
    chosen_k = torch.where(
        has_match, match_k.clamp(max=N_PROBES - 1),
        torch.where(has_empty, empty_k.clamp(max=N_PROBES - 1), evict_k))
    slots = probes.gather(1, chosen_k[:, None])[:, 0]
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)

    if not training:
        # read-only: an unmatched id reads probe 0; padding stays -1
        ro = torch.where(has_match, slots, probes[:, 0])
        ro = torch.where(valid, ro, ro.new_full((), -1)).to(torch.int32)
        if new_admit is not None:
            state = dict(state, admit_cnt=new_admit)
        if collect_spill:
            return ro.reshape(shape), state, {
                "evicted_keys": none, "fresh_keys": none, "slots": ro}
        return ro.reshape(shape), state

    needs_evict = ~has_match & ~has_empty
    blocked = ~has_match & ~writable
    if cfg.eviction_interval > 1 and step % cfg.eviction_interval != 0:
        blocked = blocked | needs_evict
    write = writable & ~blocked
    valid = valid & ~blocked

    w_slots = torch.where(write, slots, slots.new_full((), size))
    pos = torch.arange(n, device=dev)
    # one winner per slot: the writer of the largest flat position
    win = torch.full((size + 1,), -1, dtype=torch.long,
                     device=dev).scatter_reduce(0, w_slots, pos, "amax")
    is_winner = write & (win[w_slots] == pos)
    keys = _scatter_padded(
        state["keys"], torch.where(is_winner, w_slots, w_slots.new_full(
            (), size)), flat.to(torch.int32))
    fresh = write & ~has_match
    reset = _scatter_padded(
        torch.zeros(size, dtype=torch.bool, device=dev),
        torch.where(fresh, w_slots, w_slots.new_full((), size)), True)
    writers = torch.zeros(size + 1, device=dev).index_add_(
        0, w_slots, write.float())[:size]
    count = torch.where(reset, state["count"].new_zeros(()),
                        state["count"]) + writers
    last = _scatter_padded(state["last"], w_slots, step)
    new_state = {"keys": keys, "count": count, "last": last}
    if new_admit is not None:
        new_state["admit_cnt"] = new_admit
    slots = torch.where(valid, slots, slots.new_full((), -1)).to(torch.int32)
    if collect_spill:
        old_key = keys_at.gather(1, chosen_k[:, None])[:, 0]
        spill = {
            "evicted_keys": torch.where(fresh & (old_key >= 0), old_key,
                                        old_key.new_full((), -1)
                                        ).to(torch.int32),
            "fresh_keys": torch.where(fresh, flat, flat.new_full((), -1)
                                      ).to(torch.int32),
            "slots": slots,
        }
        return slots.reshape(shape), new_state, spill
    return slots.reshape(shape), new_state
