"""HSTU attention in the port against the JAX package (fp32, CPU).

The port's plain ``hstu_mha`` (what the CUDA kernel is held against on
the card) must match ``_jax_hstu_mha`` and the Pallas kernel run in
interpret mode, over the whole mask family, at the tolerance of
tests/test_hstu_ops.py. ``valid_attn_mask`` must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_helpers  # noqa: F401  (sets the TF32 flags)
from torcheasyrec_tpu.ops.hstu import _jax_hstu_mha
from torcheasyrec_tpu.ops.hstu import valid_attn_mask as jax_mask
from torcheasyrec_tpu.ops.pallas.hstu_attention import pallas_hstu_mha
from torcheasyrec_tpu_torch.ops import Kernel, normalize_kernel, uses_cuda_kernel
from torcheasyrec_tpu_torch.ops import hstu as port

MASK_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, max_attn_len=16),
    dict(causal=True, contextual_seq_len=4),
    dict(causal=True, num_targets=True),
    dict(causal=True, max_attn_len=16, min_full_attn_seq_len=8),
    dict(causal=False, max_attn_len=16, num_targets=True),
    dict(causal=True, contextual_seq_len=2, num_targets=True),
    dict(causal=True, sla_k1=8, sla_k2=4),
    dict(causal=True, sla_k1=8, sla_k2=0, contextual_seq_len=3,
         num_targets=True),
]


def _inputs(b=2, n=128, h=2, d=32, vd=32, seed=0, targets=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, n, h, d)).astype(np.float32)
    v = rng.normal(size=(b, n, h, vd)).astype(np.float32)
    lengths = rng.integers(1, n + 1, size=b).astype(np.int32)
    nt = np.minimum(lengths // 4 + 1, lengths).astype(np.int32) if targets else None
    return q, k, v, lengths, nt


def _kw(case):
    case = dict(case)
    case.pop("num_targets", None)
    return dict(
        causal=case.pop("causal"),
        max_attn_len=case.pop("max_attn_len", 0),
        contextual_seq_len=case.pop("contextual_seq_len", 0),
        min_full_attn_seq_len=case.pop("min_full_attn_seq_len", 0),
        sla_k1=case.pop("sla_k1", 0),
        sla_k2=case.pop("sla_k2", 0),
    )


def _port_plain(q, k, v, lengths, nt, alpha, scale, kw):
    t = torch.from_numpy
    return port.hstu_mha(
        t(q), t(k), t(v), t(lengths), alpha=alpha,
        num_targets=None if nt is None else t(nt), scaling_seqlen=scale,
        **kw,
    ).numpy()


@pytest.mark.parametrize("case", MASK_CASES)
def test_valid_attn_mask_bitwise(case):
    _, _, _, lengths, nt = _inputs(b=3, n=40, seed=1,
                                   targets=case.get("num_targets", False))
    kw = _kw(case)
    ref = jax_mask(40, jnp.asarray(lengths),
                   num_targets=None if nt is None else jnp.asarray(nt), **kw)
    got = port.valid_attn_mask(
        40, torch.from_numpy(lengths),
        num_targets=None if nt is None else torch.from_numpy(nt), **kw,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", MASK_CASES)
def test_plain_matches_jax_reference(case):
    q, k, v, lengths, nt = _inputs(seed=2, targets=case.get("num_targets", False))
    kw = _kw(case)
    alpha, scale = 0.08, 160
    ref = _jax_hstu_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        alpha, kw["causal"], None if nt is None else jnp.asarray(nt),
        kw["max_attn_len"], kw["contextual_seq_len"],
        kw["min_full_attn_seq_len"], scale,
        sla_k1=kw["sla_k1"], sla_k2=kw["sla_k2"],
    )
    got = _port_plain(q, k, v, lengths, nt, alpha, scale, kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case,vd", [(c, 32) for c in MASK_CASES] + [
    (dict(causal=True, contextual_seq_len=1, num_targets=True), 64),
])
def test_plain_matches_pallas_interpret(case, vd):
    q, k, v, lengths, nt = _inputs(seed=3, vd=vd,
                                   targets=case.get("num_targets", False))
    kw = _kw(case)
    alpha, n = 0.08, q.shape[1]
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_hstu_mha(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), alpha=alpha,
            num_targets=None if nt is None else jnp.asarray(nt),
            scaling_seqlen=n, **kw,
        )
    got = _port_plain(q, k, v, lengths, nt, alpha, n, kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v, lengths, _ = _inputs(seed=4)
    before = port.hstu_attention_fwd.launches
    for kernel in Kernel:
        port.hstu_mha(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(lengths),
                      alpha=0.1, kernel=kernel)
    assert port.hstu_attention_fwd.launches == before
    # the kernel wrapper itself refuses CPU tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA tensors only"):
        port.hstu_attention_fwd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lengths), None, 0.1, True, 0, 0, 0, 128,
        )
    assert port.hstu_attention_fwd.launches == before


def test_attention_dropout_raises():
    q, k, v, lengths, _ = _inputs(seed=5)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError):
        port.hstu_mha(t(q), t(k), t(v), t(lengths), alpha=0.1, dropout_pr=0.1)


def test_kernel_enum_keeps_the_proto_order():
    from torcheasyrec_tpu_torch.protos import model_pb2

    for name in ("TRITON", "PYTORCH", "CUTLASS", "JAX", "PALLAS"):
        value = model_pb2.Kernel.Value(name)
        assert normalize_kernel(value) is Kernel[name]
    assert [uses_cuda_kernel(k) for k in Kernel] == [
        True, False, True, False, True
    ]


def _bad_inputs(kind):
    q, k, v, lengths, nt = (torch.from_numpy(x) for x in
                            _inputs(seed=6, targets=True))
    if kind == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif kind == "mixed dtypes":
        v = v.to(torch.bfloat16)
    elif kind == "3-d q":
        q = q[:, :, 0]
    elif kind == "head dim 48":
        q, k = q[..., :24].repeat(1, 1, 1, 2), k[..., :24].repeat(1, 1, 1, 2)
    elif kind == "head dim 16":
        q, k = q[..., :16].contiguous(), k[..., :16].contiguous()
    elif kind == "v head dim 256":
        v = torch.cat([v] * 8, -1)
    elif kind == "misaligned k":  # 4 bytes past a 16-byte boundary
        buf = torch.zeros(k.numel() + 4)
        k = buf[1:1 + k.numel()].view(k.shape).copy_(k)
    elif kind == "non-contiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "int64 lengths":
        lengths = lengths.long()
    elif kind == "targets of another batch":
        nt = nt[:1]
    return q, k, v, lengths, nt


@pytest.mark.parametrize("kind,match", [
    ("fp16", "fp32 or bf16"), ("mixed dtypes", "share one dtype"),
    ("3-d q", r"\[B, N, H, D\]"), ("head dim 48", "head dims"),
    ("head dim 16", "head dims"), ("v head dim 256", "head dims"),
    ("misaligned k", "16-byte aligned"),
    ("non-contiguous", "contiguous"), ("int64 lengths", "lengths"),
    ("targets of another batch", "num_targets"),
    ("cpu", "CUDA tensors only"),
])
def test_kernel_input_checks(kind, match):
    with pytest.raises(ValueError, match=match):
        port.check_kernel_inputs(*_bad_inputs(kind))


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    from torcheasyrec_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    target = cuda_build.library_path("hstu_attention_fwd")
    assert target.parent == tmp_path and "hstu_attention_fwd-" in target.name
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        cuda_build.load("hstu_attention_fwd")
    assert not target.exists()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, to reach the CUDA route's
    input checks and build step where there is no card."""

    @property
    def is_cuda(self):
        return True


def _fake_cuda_inputs(dtype, d, vd, b=2, n=24, h=2):
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.normal(size=(b, n, h, d))).to(dtype)
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, n, h, vd))).to(dtype)
    lengths = torch.tensor([n, n // 2], dtype=torch.int32)
    targets = torch.tensor([2, 1], dtype=torch.int32)
    fake = [t.as_subclass(_FakeCuda) for t in (q, k, v)]
    return fake, lengths, targets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,vd", [(d, vd) for d in (32, 64, 128)
                                  for vd in (32, 64, 128)])
def test_kernels_take_every_head_dim_pair(dtype, d, vd):
    """The wrappers take what they took before the Hopper redesign: fp32
    and bf16, D and V each in {32, 64, 128}, contiguous and 16-byte
    aligned, int32 lengths and targets."""
    (q, k, v), lengths, targets = _fake_cuda_inputs(dtype, d, vd)
    port.check_kernel_inputs(q, k, v, lengths, targets)
    port.check_kernel_inputs(q, k, v, lengths, None)


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    """phase env of chip_smoke.py reports registers, shared memory and
    spills per kernel from the log nvcc -Xptxas -v leaves beside the
    library."""
    from torcheasyrec_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert "-v" in cuda_build.NVCC_FLAGS
    mangled = ("_ZN54_GLOBAL__N__bf2e810d_21_hstu_attention_bwd_cu_ed097d2213"
               "hstu_bwd_bf16ILi128ELi64EEEv14CUtensorMap_stS1_PfiiffE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled}",
        "    528 bytes stack frame, 2308 bytes spill stores, 2328 bytes "
        "spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers, 528 bytes "
        "cumulative stack size, 128 bytes smem",
        "ptxas info    : Compiling entry function '_Z9row_writePfPKlii' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z9row_writePfPKlii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers",
    ])
    cuda_build.library_path("hstu_attention_bwd").with_suffix(".log") \
        .write_text(log)
    assert cuda_build.ptxas_usage("hstu_attention_bwd") == [
        {"kernel": "hstu_bwd_bf16<128,64>", "registers": 168,
         "static_smem_bytes": 128, "spill_store_bytes": 2308,
         "spill_load_bytes": 2328},
        {"kernel": "row_write", "registers": 24, "static_smem_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0},
    ]
    assert cuda_build.ptxas_usage("hstu_attention_fwd") == []


def test_library_name_follows_the_flags(monkeypatch):
    """A change of nvcc's flags renames the library, so it rebuilds."""
    from torcheasyrec_tpu_torch.ops import cuda_build

    first = cuda_build.library_path("hstu_attention_fwd")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        [f for f in cuda_build.NVCC_FLAGS if f != "-v"])
    assert cuda_build.library_path("hstu_attention_fwd") != first
