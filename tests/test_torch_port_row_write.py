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


def test_ids_off_the_16_byte_line_are_taken():
    """The kernel reads ids with ordinary loads, so an ids slice whose data
    pointer is off the 16-byte line is taken as it is."""
    for dtype in (torch.int32, torch.int64):
        ids = torch.tensor([9, 4, 0, 2, 7], dtype=dtype)[1:]
        assert ids.data_ptr() % 16
        table = torch.zeros(8, 128)
        rows = torch.arange(4 * 128, dtype=torch.float32).view(4, 128)
        write_rows(table, ids, rows)
        assert torch.equal(table[ids.long()], rows)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, to reach the CUDA
    route of the wrapper where there is no card."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    """The kernel library's C interface: records each call's arguments and
    returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def row_write(self, *args):
        self.calls.append(args)
        return self.rc

    @staticmethod
    def row_write_error_string(code):
        return b"invalid value"


def _fake_card(monkeypatch, lib):
    import contextlib
    import types

    from torcheasyrec_tpu_torch.ops import row_write

    monkeypatch.setattr(row_write, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(row_write, "_torch_write_rows", None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_write_rows_on_a_cuda_tensor_launches_and_counts(monkeypatch,
                                                         ids_dtype):
    """A CUDA table never takes the plain version: each call with K > 0
    is one launch and one count, with the rows of the tensor it was given
    (a leading-row view drops the ids past it); K = 0 is neither."""
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    table = torch.zeros(6, 128).as_subclass(_FakeCuda)
    before = write_rows.launches
    write_rows(table, torch.tensor([1, 2], dtype=ids_dtype),
               torch.ones(2, 128))
    write_rows(table[:5], torch.tensor([1, 5, 5], dtype=ids_dtype),
               torch.ones(3, 128))
    write_rows(table, torch.zeros(0, dtype=ids_dtype), torch.ones(0, 128))
    # k, p, lanes and the id width as the C interface takes them
    wide = int(ids_dtype == torch.int64)
    assert [c[3:7] for c in lib.calls] == [(2, 6, 128, wide),
                                           (3, 5, 128, wide)]
    assert lib.calls[1][0] == table.data_ptr()
    assert write_rows.launches == before + 2
    write_rows.launches = before


def test_launch_raises_with_the_kernel_library_message(monkeypatch):
    _fake_card(monkeypatch, _FakeLib(rc=1))
    table = torch.zeros(6, 128).as_subclass(_FakeCuda)
    before = write_rows.launches
    with pytest.raises(RuntimeError, match="invalid value"):
        write_rows(table, torch.tensor([1, 2]), torch.ones(2, 128))
    assert write_rows.launches == before


def test_kernel_lib_declares_pointers_as_64_bit(monkeypatch):
    import ctypes
    import types

    from torcheasyrec_tpu_torch.ops import cuda_build, row_write

    lib = types.SimpleNamespace(row_write=types.SimpleNamespace(),
                                row_write_error_string=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    assert row_write._kernel_lib() is lib
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert lib.row_write.argtypes == [p, p, p, ll, ll, i, i, p]
    assert lib.row_write.restype is i
    assert lib.row_write_error_string.restype is ctypes.c_char_p


def test_ptxas_report_names_each_id_type_of_the_kernel(tmp_path, monkeypatch):
    """The kernel is instantiated for int32 and int64 ids: the env line of
    chip_smoke.py keeps the two apart."""
    from torcheasyrec_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    log = []
    for code, regs in (("i", 30), ("x", 32)):
        mangled = (f"_ZN12_GLOBAL__N_116row_write_kernelI{code}EEvP6float4"
                   "PKT_PKS1_xxi")
        log += [f"ptxas info    : Compiling entry function '{mangled}' for "
                "'sm_90a'",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads",
                f"ptxas info    : Used {regs} registers, used 0 barriers"]
    cuda_build.library_path("row_write").with_suffix(".log").write_text(
        "\n".join(log))
    rows = cuda_build.ptxas_usage("row_write")
    assert [(r["kernel"], r["registers"]) for r in rows] == [
        ("row_write_kernel<int>", 30), ("row_write_kernel<long long>", 32)]


def _deepfm_step(monkeypatch):
    """A small DeepFM-like engine (tables on both sides of the dense lane's
    32768 rows), one update of a seeded batch of 300 through it with the
    row writes captured as (table, ids) and then performed; returns
    (buckets, batch, the engine's tables before and after, captured)."""
    import chip_smoke
    from torcheasyrec_tpu_torch.datasets.utils import SparseField
    from torcheasyrec_tpu_torch.ops import row_write
    from torcheasyrec_tpu_torch.parallel.emb_engine import LookupSpec

    buckets, batch = [40000, 39060, 17, 3, 50000, 100, 33000], 300
    lookups = [LookupSpec(f"cat_{i}:{d}", f"cat_{i}", f"cat_{i}_dim{d}",
                          "sum") for d in (16, 4) for i in range(len(buckets))]
    eng = chip_smoke.deepfm_engine(buckets, lookups)
    tables = eng.init_tables(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tables.items()}
    state = eng.init_opt_state()
    cols = chip_smoke.criteo_cols(buckets, 0, batch)
    sparse = {name: SparseField(
        torch.tensor(cols[name].to_numpy()).int()[:, None])
        for name in (f"cat_{i}" for i in range(len(buckets)))}
    outputs, residuals = eng.lookup(tables, sparse)
    written = []
    write = row_write.write_rows

    def capture(table, ids, rows):
        written.append((table, ids.clone()))
        return write(table, ids, rows)

    monkeypatch.setattr(row_write, "write_rows", capture)
    eng.update(tables, state, residuals,
               {k: torch.ones_like(v) for k, v in outputs.items()}, 1.0)
    return buckets, batch, before, tables, written


def test_chip_smoke_rebuilds_the_row_writes_of_a_deepfm_step(monkeypatch):
    """chip_smoke.py times the kernel at the DeepFM step's own targets,
    rebuilt from the seeded batch without the model: per packed group,
    they are the ids that the engine's update of that batch hands to
    write_rows, with the table less its scratch row (the last)."""
    import chip_smoke

    buckets, batch, _, tables, written = _deepfm_step(monkeypatch)
    want = chip_smoke.step_row_write_targets(buckets, batch, device="cpu")
    assert [t.shape[0] for t, _ in written] == [p - 1 for p, _ in
                                                want.values()]
    for (table, got), (p, tgt) in zip(written, want.values()):
        assert torch.equal(got, tgt)
        assert (tgt == p - 1).sum() > 1  # duplicates on the scratch row
        assert any(table.data_ptr() == t.data_ptr() for t in tables.values())


def test_deepfm_step_leaves_the_scratch_row_as_it_was(monkeypatch):
    """The engine drops its writes to the scratch row: after an update,
    the last physical row of each packed group keeps its bits, and the
    heads of the touched physical rows changed."""
    _, _, before, tables, written = _deepfm_step(monkeypatch)
    assert len(written) == 2
    for (table, ids), (key, after) in zip(written, tables.items()):
        p = after.shape[0]
        assert torch.equal(after[p - 1], before[key][p - 1])
        heads = ids[ids < p - 1]
        assert not (after[heads] == before[key][heads]).all(dim=1).any()


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", CASES)
def test_view_without_the_scratch_row_matches_jax_on_every_other_row(
        name, ids_dtype):
    """Through ``table[:-1]``, as the engine calls it, the port drops the
    writes to the scratch row (the last), where the JAX ``write_rows``
    performs them: every other row holds the JAX result bit for bit, and
    the scratch row keeps its bits."""
    table, ids, rows = _inputs(name)
    p = table.shape[0]
    jax_ids = np.where(ids < 0, p + 5, ids).astype(np.int32)
    ref = np.asarray(jax_write_rows(
        jnp.asarray(table), jnp.asarray(jax_ids), jnp.asarray(rows),
        scratch_id=p - 1, use_pallas=False))
    for fn in (write_rows, _torch_write_rows):
        got = torch.from_numpy(table.copy())
        fn(got[:-1], torch.from_numpy(ids).to(ids_dtype),
           torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy()[:-1], ref[:-1])
        np.testing.assert_array_equal(got.numpy()[-1], table[-1])
