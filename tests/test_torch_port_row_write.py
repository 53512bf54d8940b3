"""The row write of the port against the JAX package (CPU).

``_torch_write_rows`` (the plain version that ``write_rows`` runs on CPU
tensors, and that the CUDA kernel is held against on the card) gives
the bits of the JAX ``write_rows`` on its CPU path
(``table.at[ids].set(rows, mode="drop")``) over a sweep of id patterns.
A copy has no tolerance: every comparison is exact.

Where ids repeat, which row wins is undefined in both packages, so
repeated targets carry equal rows here. The JAX scatter wraps negative
ids numpy-style before it drops out-of-bounds ones; the port drops them
(the engine never sends one). So the JAX side gets an id past the table
in their place, which it drops, and the port's drop is checked
separately."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheasyrec_tpu.ops.pallas.row_write import write_rows as jax_write_rows
from torcheasyrec_tpu_torch.ops.row_write import (
    _torch_write_rows,
    supports_row_write,
    write_rows,
)


def _case(name):
    """(rows of the table, lanes, ids) of one sweep case."""
    r = np.random.default_rng(zlib.crc32(name.encode()))
    p = 61  # 60 real rows and the scratch row
    if name == "unique":
        return p, 128, r.permutation(p - 1)[:40]
    if name == "duplicates_on_scratch":
        ids = r.permutation(p - 1)[:40]
        ids[r.random(40) < 0.6] = p - 1
        return p, 128, ids
    if name == "negative_and_too_large":
        ids = r.permutation(p - 1)[:40]
        ids[::5] = -1
        ids[1::7] = p
        ids[2::11] = p + 1000
        return p, 128, ids
    if name == "k_1":
        return p, 128, np.array([17])
    if name == "k_not_a_block_multiple":
        return p, 128, r.permutation(p - 1)[:13]
    if name == "last_real_row":
        return p, 128, np.array([p - 2, 0, p - 1, p - 1])
    if name == "two_row_table":
        return 2, 128, np.array([0, 1, 1])
    if name == "256_lanes":
        return p, 256, r.permutation(p - 1)[:20]
    raise KeyError(name)


CASES = ["unique", "duplicates_on_scratch", "negative_and_too_large", "k_1",
         "k_not_a_block_multiple", "last_real_row", "two_row_table",
         "256_lanes"]


def _inputs(name):
    p, lanes, ids = _case(name)
    r = np.random.default_rng(7)
    table = r.normal(size=(p, lanes)).astype(np.float32)
    # one row per target, so that repeated targets carry equal rows
    by_target = r.normal(size=(p + 2000, lanes)).astype(np.float32)
    rows = by_target[np.clip(ids, 0, None)]
    return table, ids, rows


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", CASES)
def test_plain_write_rows_matches_jax_bit_for_bit(name, ids_dtype):
    table, ids, rows = _inputs(name)
    p = table.shape[0]
    jax_ids = np.where(ids < 0, p + 5, ids).astype(np.int32)
    ref = np.asarray(jax_write_rows(
        jnp.asarray(table), jnp.asarray(jax_ids), jnp.asarray(rows),
        scratch_id=p - 1, use_pallas=False))
    got = torch.from_numpy(table.copy())
    out = _torch_write_rows(got, torch.from_numpy(ids).to(ids_dtype),
                            torch.from_numpy(rows))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), ref)
    # what was written, and nothing else
    hit = np.unique(ids[(ids >= 0) & (ids < p)])
    rest = np.setdiff1d(np.arange(p), hit)
    np.testing.assert_array_equal(got.numpy()[rest], table[rest])
    assert not np.array_equal(got.numpy()[hit], table[hit])


@pytest.mark.parametrize("name", CASES)
def test_write_rows_on_cpu_runs_the_plain_version(name):
    table, ids, rows = _inputs(name)
    a, b = torch.from_numpy(table.copy()), torch.from_numpy(table.copy())
    before = write_rows.launches
    out = write_rows(a, torch.from_numpy(ids), torch.from_numpy(rows))
    _torch_write_rows(b, torch.from_numpy(ids), torch.from_numpy(rows))
    assert out is a and torch.equal(a, b)
    assert write_rows.launches == before  # no kernel on CPU tensors


def test_negative_and_too_large_ids_are_dropped_not_clamped():
    table = torch.zeros(4, 128)
    rows = torch.ones(3, 128)
    write_rows(table, torch.tensor([-1, 4, 100]), rows)
    assert (table == 0).all()
    write_rows(table, torch.tensor([-1, 2, 4]), rows)
    assert (table[2] == 1).all() and table.sum() == 128


def test_k_0_returns_the_table_untouched():
    table = torch.randn(5, 128)
    before = table.clone()
    out = write_rows(table, torch.zeros(0, dtype=torch.int64),
                     torch.zeros(0, 128))
    assert out is table and torch.equal(table, before)


@pytest.mark.parametrize("bad", [
    "lanes_64", "lanes_192", "row_width", "k_mismatch", "table_dtype",
    "rows_dtype", "ids_dtype", "table_not_contiguous", "rows_not_contiguous",
    "table_misaligned", "ids_2d",
])
def test_write_rows_raises_on_what_the_kernel_does_not_take(bad):
    table = torch.zeros(6, 128)
    ids = torch.tensor([1, 2])
    rows = torch.ones(2, 128)
    if bad == "lanes_64":
        table, rows = torch.zeros(6, 64), torch.ones(2, 64)
    elif bad == "lanes_192":
        table, rows = torch.zeros(6, 192), torch.ones(2, 192)
    elif bad == "row_width":
        rows = torch.ones(2, 256)
    elif bad == "k_mismatch":
        rows = torch.ones(3, 128)
    elif bad == "table_dtype":
        table = table.double()
    elif bad == "rows_dtype":
        rows = rows.bfloat16()
    elif bad == "ids_dtype":
        ids = ids.to(torch.int16)
    elif bad == "table_not_contiguous":
        table = torch.zeros(6, 256)[:, :128]
    elif bad == "rows_not_contiguous":
        rows = torch.ones(128, 2).t()
    elif bad == "table_misaligned":
        table = torch.zeros(6 * 128 + 1)[1:].view(6, 128)
        assert table.data_ptr() % 16
    elif bad == "ids_2d":
        ids = ids[None]
    with pytest.raises(ValueError):
        write_rows(table, ids, rows)


def test_supports_row_write_as_the_jax_package():
    from torcheasyrec_tpu.ops.pallas.row_write import supports_pallas_write

    for lanes in (64, 127, 128, 192, 256, 512):
        assert supports_row_write(lanes) == supports_pallas_write(lanes)
