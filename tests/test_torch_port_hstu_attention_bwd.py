"""HSTU attention backward in the port against the JAX package (fp32,
CPU).

The port's plain backward ``_torch_hstu_mha_bwd`` (what the CUDA backward
kernel is held against on the card) must match autograd of the port's
plain forward, ``jax.grad`` of ``_jax_hstu_mha`` and the Pallas backward
kernel run in interpret mode, over the whole mask family, at the
tolerance of tests/test_hstu_ops.py's gradient test (rtol 5e-4 /
atol 5e-5: the sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_helpers  # noqa: F401  (sets the TF32 flags)
from torcheasyrec_tpu.ops.hstu import _jax_hstu_mha
from torcheasyrec_tpu.ops.pallas.hstu_attention import pallas_hstu_mha
from torcheasyrec_tpu_torch.ops import Kernel, cuda_build
from torcheasyrec_tpu_torch.ops import hstu as port

from test_torch_port_hstu_attention import MASK_CASES, _FakeCuda, _inputs, _kw

TOL = dict(rtol=5e-4, atol=5e-5)
ALPHA = 0.08


def _upstream(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_bwd(q, k, v, do, lengths, nt, scale, kw):
    t = torch.from_numpy
    return port._torch_hstu_mha_bwd(
        t(q), t(k), t(v), t(do), t(lengths), ALPHA, kw["causal"],
        None if nt is None else t(nt), kw["max_attn_len"],
        kw["contextual_seq_len"], kw["min_full_attn_seq_len"], scale,
        kw["sla_k1"], kw["sla_k2"],
    )


def _assert_grads_close(got, ref):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", MASK_CASES)
def test_plain_bwd_matches_autograd_of_plain_fwd(case):
    q, k, v, lengths, nt = _inputs(seed=11, n=96, vd=48,
                                   targets=case.get("num_targets", False))
    kw, scale = _kw(case), 120
    do = _upstream(v.shape, 12)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port._torch_hstu_mha(
        *leaves, torch.from_numpy(lengths), ALPHA, kw["causal"],
        None if nt is None else torch.from_numpy(nt), kw["max_attn_len"],
        kw["contextual_seq_len"], kw["min_full_attn_seq_len"], scale,
        kw["sla_k1"], kw["sla_k2"],
    )
    ref = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = _port_bwd(q, k, v, do, lengths, nt, scale, kw)
    _assert_grads_close([g.numpy() for g in got], [r.numpy() for r in ref])


@pytest.mark.parametrize("case", MASK_CASES)
def test_plain_bwd_matches_jax_grad(case):
    q, k, v, lengths, nt = _inputs(seed=13,
                                   targets=case.get("num_targets", False))
    kw, scale = _kw(case), 160
    do = _upstream(v.shape, 14)

    def fwd(q_, k_, v_):
        return _jax_hstu_mha(
            q_, k_, v_, jnp.asarray(lengths), ALPHA, kw["causal"],
            None if nt is None else jnp.asarray(nt), kw["max_attn_len"],
            kw["contextual_seq_len"], kw["min_full_attn_seq_len"], scale,
            sla_k1=kw["sla_k1"], sla_k2=kw["sla_k2"],
        )

    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _port_bwd(q, k, v, do, lengths, nt, scale, kw)
    _assert_grads_close([g.numpy() for g in got], ref)


@pytest.mark.parametrize("case,vd", [(c, 32) for c in MASK_CASES] + [
    (dict(causal=True, contextual_seq_len=1, num_targets=True), 64),
])
def test_plain_bwd_matches_pallas_interpret(case, vd):
    q, k, v, lengths, nt = _inputs(seed=15, vd=vd,
                                   targets=case.get("num_targets", False))
    kw, n = _kw(case), q.shape[1]
    do = _upstream(v.shape, 16)

    def fwd(q_, k_, v_):
        return pallas_hstu_mha(
            q_, k_, v_, jnp.asarray(lengths), alpha=ALPHA,
            num_targets=None if nt is None else jnp.asarray(nt),
            scaling_seqlen=n, **kw,
        )

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref = vjp(jnp.asarray(do))
    got = _port_bwd(q, k, v, do, lengths, nt, n, kw)
    _assert_grads_close([g.numpy() for g in got], ref)


def test_padded_rows_of_the_upstream_gradient_do_not_leak():
    """Rows at or past the length are masked: whatever finite values the
    upstream gradient carries there changes nothing."""
    q, k, v, lengths, _ = _inputs(seed=17)
    lengths[:] = [70, 33]
    kw = _kw(dict(causal=True))
    do = _upstream(v.shape, 18)
    ref = _port_bwd(q, k, v, do, lengths, None, 128, kw)
    do2 = do.copy()
    do2[0, 70:] = 1e3
    do2[1, 33:] = -1e3
    got = _port_bwd(q, k, v, do2, lengths, None, 128, kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for g in got:  # and padded positions get zero gradients
        assert (g[0, 70:] == 0).all() and (g[1, 33:] == 0).all()


@pytest.mark.parametrize("case", [MASK_CASES[0], MASK_CASES[7]])
def test_function_on_cpu_uses_the_plain_versions(case):
    """hstu_mha goes through HstuAttentionFunction when a gradient is
    required; on CPU tensors neither kernel launches, and the gradients
    are those of plain autograd."""
    q, k, v, lengths, nt = _inputs(seed=19,
                                   targets=case.get("num_targets", False))
    kw = _kw(case)
    t = torch.from_numpy
    nt_t = None if nt is None else t(nt)
    do = t(_upstream(v.shape, 20))
    before = (port.hstu_attention_fwd.launches,
              port.hstu_attention_bwd.launches)
    grads = {}
    for kernel in (Kernel.PALLAS, Kernel.PYTORCH):
        leaves = [t(x).clone().requires_grad_(True) for x in (q, k, v)]
        out = port.hstu_mha(*leaves, t(lengths), alpha=ALPHA,
                            num_targets=nt_t, scaling_seqlen=128,
                            kernel=kernel, **kw)
        is_function = type(out.grad_fn).__name__.startswith(
            "HstuAttentionFunction")
        assert is_function == (kernel is Kernel.PALLAS)
        grads[kernel] = torch.autograd.grad(out, leaves, do)
    _assert_grads_close([g.numpy() for g in grads[Kernel.PALLAS]],
                        [g.numpy() for g in grads[Kernel.PYTORCH]])
    assert before == (port.hstu_attention_fwd.launches,
                      port.hstu_attention_bwd.launches)


def test_function_saves_no_score_matrix():
    q, k, v, lengths, _ = _inputs(seed=21)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port.hstu_mha(*leaves, torch.from_numpy(lengths), alpha=ALPHA)
    saved = [tuple(s.shape) for s in out.grad_fn.saved_tensors
             if s is not None]
    assert saved == [q.shape, k.shape, v.shape, lengths.shape]


def test_no_grad_call_skips_the_function():
    q, k, v, lengths, _ = _inputs(seed=22)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        out = port.hstu_mha(*leaves, torch.from_numpy(lengths), alpha=ALPHA)
    assert out.grad_fn is None and not out.requires_grad


def test_bwd_wrapper_refuses_cpu_tensors():
    q, k, v, lengths, _ = (torch.from_numpy(x) if x is not None else None
                           for x in _inputs(seed=23))
    before = port.hstu_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        port.hstu_attention_bwd(q, k, v, torch.zeros_like(v), lengths, None,
                                0.1, True, 0, 0, 0, 128)
    assert port.hstu_attention_bwd.launches == before


def test_cuda_route_raises_when_the_build_fails(monkeypatch):
    """On the CUDA route a failed build raises: nothing falls back to the
    plain version."""
    def failing_build(names):
        raise RuntimeError("CUDA kernel build failed: nvcc exited 1")

    monkeypatch.setattr(cuda_build, "build", failing_build)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(port, "check_kernel_inputs", lambda *a: None)
    q, k, v, lengths, _ = _inputs(seed=24)
    fake = [torch.from_numpy(x).as_subclass(_FakeCuda) for x in (q, k, v)]
    lengths = torch.from_numpy(lengths)
    before = (port.hstu_attention_fwd.launches,
              port.hstu_attention_bwd.launches)
    with pytest.raises(RuntimeError, match="build failed"):
        port.hstu_attention_bwd(*fake, torch.zeros_like(fake[2]), lengths,
                                None, 0.1, True, 0, 0, 0, 128)
    with pytest.raises(RuntimeError, match="build failed"):
        port.hstu_mha(*fake, lengths, alpha=0.1)
    assert before == (port.hstu_attention_fwd.launches,
                      port.hstu_attention_bwd.launches)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit of a shared csrc/*.cuh header renames the built library,
    so both kernels rebuild."""
    for name in ("a.cu", "common.cuh"):
        (tmp_path / name).write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    first = cuda_build.library_path("a")
    assert first == cuda_build.library_path("a")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert cuda_build.library_path("a") != first
