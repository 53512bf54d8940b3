"""The cached HSTU decode of the port against the JAX package:
``delta_hstu_mha`` and ``STUStack.cached_forward`` (a prefill, then
one-token decodes) under converted weights (fp32, CPU). Each tensor is
compared to 1e-5 of its max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the TF32 flags)
from torch_port_helpers import assert_close_to_max
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.gr import stu as jstu
from torcheasyrec_tpu.ops import hstu as jops
from torcheasyrec_tpu_torch.modules.gr import stu as pstu
from torcheasyrec_tpu_torch.ops import hstu as pops
from torcheasyrec_tpu_torch.utils.convert import from_jax_state

B, N, E, H, LD, AD = 2, 24, 32, 2, 16, 16
TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_targets=np.array([2, 1], np.int32), max_attn_len=5,
         contextual_seq_len=2),
    dict(sla_k1=4, sla_k2=3),
])
def test_delta_hstu_mha_matches_jax(kw):
    r = np.random.default_rng(0)
    b, n, h, d, ld = 2, 16, 2, 8, 3
    q = _np(r.normal(size=(b, ld, h, d)))
    k = _np(r.normal(size=(b, n, h, d)))
    v = _np(r.normal(size=(b, n, h, d)))
    lengths = np.array([16, 10], np.int32)
    nt = kw.pop("num_targets", None)
    ref = jops.delta_hstu_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        0.2, num_targets=None if nt is None else jnp.asarray(nt),
        scaling_seqlen=n, **kw)
    got = pops.delta_hstu_mha(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), 0.2,
        num_targets=None if nt is None else torch.from_numpy(nt),
        scaling_seqlen=n, **kw)
    assert tuple(got.shape) == (b, ld, h, d)
    assert_close_to_max(got.numpy(), np.asarray(ref), "delta", TOL)


def _stacks(**kw):
    jstack = jstu.STUStack(jstu.STULayer(E, LD, AD, num_heads=H, **kw), 2)
    params = jstack.init(jax.random.key(0))
    g = torch.Generator().manual_seed(0)
    pstack = pstu.STUStack([pstu.STULayer(E, LD, AD, g, num_heads=H, **kw)
                            for _ in range(2)])
    state = {k.replace("layer_", "layers.", 1): v for k, v in
             from_jax_state(jax.device_get(params), {}).items()}
    pstack.load_state_dict(state)
    return jstack, params, pstack.eval()


@pytest.mark.parametrize("kw", [dict(), dict(max_attn_len=6)])
def test_stu_stack_cached_decode_matches_jax(kw):
    """A prefill of 16 tokens, then 2 one-token decodes, each against the
    JAX package's, and the decoded rows against the full forward's."""
    jstack, params, pstack = _stacks(**kw)
    x = _np(np.random.default_rng(1).normal(size=(B, N, E)))
    ctx = JM.Context(training=False)
    jcaches = jstack.init_cache(B, N)
    pcaches = pstack.init_cache(B, N)
    steps = [(0, 16), (16, 17), (17, 18)]
    for lo, hi in steps:
        lengths = np.full((B,), hi, np.int32)
        jy, jcaches = jstack.cached_forward(
            params, jnp.asarray(x[:, lo:hi]), jnp.asarray(lengths), jcaches,
            ctx, scaling_seqlen=N)
        with torch.no_grad():
            py, pcaches = pstack.cached_forward(
                torch.from_numpy(x[:, lo:hi]), torch.from_numpy(lengths),
                pcaches, scaling_seqlen=N)
        assert_close_to_max(py.numpy(), np.asarray(jy), f"y[{lo}:{hi}]", TOL)
        for i, (jc, pc) in enumerate(zip(jcaches, pcaches)):
            for key in ("k", "v"):
                assert_close_to_max(pc[key].numpy(), np.asarray(jc[key]),
                                    f"layer {i} {key}", TOL)
    with torch.no_grad():
        full = pstack(torch.from_numpy(x[:, :18]),
                      torch.full((B,), 18, dtype=torch.int32),
                      scaling_seqlen=N)
    assert_close_to_max(py.numpy(), full[:, 17:18].numpy(), "vs full", TOL)


def test_cached_decode_places_the_cache_start_as_jax():
    """A prefill wider than a sample's length: its negative cache start
    wraps by the cache length and is clamped, as JAX's
    dynamic_update_slice takes it, and the new tokens' rows are placed as
    the JAX package places them (the last Ld of the length). The outputs
    and both caches equal the JAX package's."""
    jstack, params, pstack = _stacks()
    x = _np(np.random.default_rng(2).normal(size=(B, 14, E)))
    lengths = np.array([9, 14], np.int32)
    jy, jcaches = jstack.cached_forward(
        params, jnp.asarray(x), jnp.asarray(lengths), jstack.init_cache(B, N),
        JM.Context(training=False), scaling_seqlen=N)
    with torch.no_grad():
        py, pcaches = pstack.cached_forward(
            torch.from_numpy(x), torch.from_numpy(lengths),
            pstack.init_cache(B, N), scaling_seqlen=N)
    assert_close_to_max(py.numpy(), np.asarray(jy), "y", TOL)
    for i, (jc, pc) in enumerate(zip(jcaches, pcaches)):
        for key in ("k", "v"):
            assert_close_to_max(pc[key].numpy(), np.asarray(jc[key]),
                                f"layer {i} {key}", TOL)
