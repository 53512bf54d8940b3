"""STU ops, STULayer and HSTUTransducer of the port against the JAX
package under converted weights (fp32, CPU, rtol 1e-4 / atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the TF32 flags)
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.gr import encoders as jenc
from torcheasyrec_tpu.modules.gr import hstu_transducer as jtr
from torcheasyrec_tpu.modules.gr import stu as jstu
from torcheasyrec_tpu.ops import hstu as jops
from torcheasyrec_tpu_torch.modules.gr import encoders as penc
from torcheasyrec_tpu_torch.modules.gr import hstu_transducer as ptr
from torcheasyrec_tpu_torch.modules.gr import stu as pstu
from torcheasyrec_tpu_torch.ops import hstu as pops
from torcheasyrec_tpu_torch.utils.convert import from_jax_state

B, N, E, H, LD, AD = 3, 24, 64, 2, 32, 32
TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _gen():
    return torch.Generator().manual_seed(0)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def _load(module, jax_params):
    state = from_jax_state(jax.device_get(jax_params), {})
    module.load_state_dict(state)
    return module.eval()


def test_compute_uqvk_matches():
    r = _rng(0)
    x = _np(r.normal(size=(B, N, E)))
    scale, bias = _np(r.normal(size=E)), _np(r.normal(size=E))
    w = _np(r.normal(size=(E, 2 * H * LD + 2 * H * AD)) * 0.1)
    wb = _np(r.normal(size=2 * H * LD + 2 * H * AD))
    ref = jops.hstu_compute_uqvk(jnp.asarray(x), scale, bias, w, wb, H, LD, AD)
    got = pops.hstu_compute_uqvk(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(wb),
        H, LD, AD,
    )
    for g, rf in zip(got, ref):
        assert tuple(g.shape) == rf.shape
        _close(g, rf)


@pytest.mark.parametrize("group_norm", [False, True])
def test_compute_output_matches(group_norm):
    r = _rng(1)
    attn = _np(r.normal(size=(B, N, H, LD)))
    u = _np(r.normal(size=(B, N, H * LD)))
    x = _np(r.normal(size=(B, N, E)))
    scale, bias = _np(r.normal(size=H * LD)), _np(r.normal(size=H * LD))
    w = _np(r.normal(size=(H * LD, E)) * 0.1)
    ref = jops.hstu_compute_output(
        jnp.asarray(attn), jnp.asarray(u), jnp.asarray(x), scale, bias, w,
        group_norm=group_norm, num_heads=H, linear_dim=LD,
    )
    t = torch.from_numpy
    got = pops.hstu_compute_output(
        t(attn), t(u), t(x), t(scale), t(bias),
        t(np.ascontiguousarray(w.T)), group_norm=group_norm, num_heads=H,
        linear_dim=LD,
    )
    _close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_attn_len=6, contextual_seq_len=2, use_group_norm=True),
    dict(sla_k1=5, sla_k2=2),
])
def test_stu_layer_matches(kw):
    r = _rng(2)
    jl = jstu.STULayer(E, LD, AD, num_heads=H, **kw)
    params = jl.init(jax.random.key(3))
    pl = _load(pstu.STULayer(E, LD, AD, _gen(), num_heads=H, **kw), params)
    x = _np(r.normal(size=(B, N, E)))
    lengths = np.array([N, 7, 15], np.int32)
    nt = np.array([3, 1, 2], np.int32)
    ref = jl(params, jnp.asarray(x), jnp.asarray(lengths), JM.Context(),
             jnp.asarray(nt), scaling_seqlen=40)
    got = pl(torch.from_numpy(x), torch.from_numpy(lengths),
             torch.from_numpy(nt), scaling_seqlen=40)
    _close(got, ref)


def test_stu_layer_training_with_dropout_raises():
    """Output dropout runs in training mode (it raised while the port
    only served): two calls draw two masks, eval is deterministic. What
    still raises is attention-probability dropout, which bypasses the
    kernel in the JAX package too and which the STU never asks for."""
    layer = pstu.STULayer(E, LD, AD, _gen(), num_heads=H,
                          output_dropout_ratio=0.1)
    x = torch.from_numpy(_np(_rng(9).normal(size=(B, N, E))))
    lengths = torch.full((B,), N, dtype=torch.int32)
    a, b = layer(x, lengths), layer(x, lengths)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    layer.eval()
    assert torch.equal(layer(x, lengths), layer(x, lengths))
    q = torch.zeros(B, N, H, AD)
    with pytest.raises(NotImplementedError):
        pops.hstu_mha(q, q, q, lengths, alpha=0.1, dropout_pr=0.1)


def test_hstu_transducer_matches():
    r = _rng(4)
    lu, lc, uih_dim, cand_dim, ctx_dim = 12, 4, 24, 16, 8
    jpre = jtr.ContextualPreprocessor(
        E, uih_dim, cand_dim, contextual_dim=ctx_dim, n_contextual_tokens=1,
        action_encoder=jenc.SimpleActionEncoder(4, [1, 2]),
        input_dropout_ratio=0.2,
    )
    jstack = jstu.STUStack(jstu.STULayer(E, LD, AD, num_heads=H), 2)
    jstack.layer.contextual_seq_len = 1
    jt = jtr.HSTUTransducer(
        jpre, jstack, jenc.PositionalEncoder(E, 16, 8, True),
        jenc.OutputPostprocessor("layer_norm", E), max_seq_len=lu + lc + 4,
    )
    params = jt.init(jax.random.key(5))
    g = _gen()
    ppre = ptr.ContextualPreprocessor(
        E, uih_dim, cand_dim, g, contextual_dim=ctx_dim,
        n_contextual_tokens=1,
        action_encoder=penc.SimpleActionEncoder(4, [1, 2], g),
        input_dropout_ratio=0.2,
    )
    pstack = pstu.STUStack([pstu.STULayer(E, LD, AD, g, num_heads=H)
                            for _ in range(2)])
    pstack.set_contextual_seq_len(1)
    pt = _load(ptr.HSTUTransducer(
        ppre, pstack, penc.PositionalEncoder(E, 16, g, 8, True),
        penc.OutputPostprocessor("layer_norm", E, g), max_seq_len=lu + lc + 4,
    ), params)

    inputs = dict(
        uih_emb=_np(r.normal(size=(B, lu, uih_dim))),
        uih_lengths=np.array([lu, 5, 1], np.int32),
        cand_emb=_np(r.normal(size=(B, lc, cand_dim))),
        cand_lengths=np.array([lc, 2, 3], np.int32),
        contextual_emb=_np(r.normal(size=(B, ctx_dim))),
        action_weights=r.integers(0, 4, (B, lu)).astype(np.float32),
        uih_timestamps=np.sort(r.integers(0, 10**4, (B, lu))).astype(np.float32),
        cand_timestamps=np.full((B, lc), 2e4, np.float32),
    )
    ref = jt(params, JM.Context(), **{k: jnp.asarray(v)
                                      for k, v in inputs.items()})
    got = pt(torch.float32, **{k: torch.from_numpy(v)
                               for k, v in inputs.items()})
    _close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("kind", ["l2_norm", "layer_norm",
                                  "timestamp_layer_norm"])
def test_output_postprocessor_matches(kind):
    r = _rng(6)
    jpost = jenc.OutputPostprocessor(kind, E)
    params = jpost.init(jax.random.key(7))
    ppost = _load(penc.OutputPostprocessor(kind, E, _gen()), params)
    x = _np(r.normal(size=(B, N, E)))
    ts = r.integers(0, 10**6, (B, N)).astype(np.float32)
    ref = jpost(params, jnp.asarray(x), jnp.asarray(ts), JM.Context())
    got = ppost(torch.from_numpy(x), torch.from_numpy(ts), torch.float32)
    _close(got, ref)


@pytest.mark.parametrize("activation,use_ln", [
    ("nn.ReLU", False), ("gelu", True), ("nn.SiLU", False),
    ("tanh", True), ("leaky_relu", False), ("sigmoid", False),
])
def test_mlp_matches(activation, use_ln):
    from torcheasyrec_tpu.modules.mlp import MLP as JaxMLP
    from torcheasyrec_tpu_torch.modules.mlp import MLP

    r = _rng(8)
    jm = JaxMLP(E, [48, 16], activation=activation, use_ln=use_ln,
                dropout_ratio=[0.3])
    params = jm.init(jax.random.key(9))
    pm = _load(MLP(E, [48, 16], _gen(), activation=activation,
                   use_ln=use_ln, dropout_ratio=[0.3]), params)
    x = _np(r.normal(size=(B, E)))
    ref = jm(params, jnp.asarray(x), JM.Context())
    got = pm(torch.from_numpy(x), torch.float32)
    _close(got, ref)
