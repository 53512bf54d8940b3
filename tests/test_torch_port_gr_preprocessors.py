"""The GR preprocessor family of the port against the JAX package's:
content encoders, contextualized MLPs, the interleave/sum preprocessor,
the UIH preprocessor and the factory. Each case of
tests/test_gr_preprocessors.py, on the same numpy inputs, with the JAX
module's initial parameters carried across by utils/convert.py; fp32 on
the CPU. Forward within 1e-5 of each output's max, gradients within 1e-4
of each gradient's max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import assert_close_to_max
from torcheasyrec_tpu.modules import module as JM
from torcheasyrec_tpu.modules.gr import encoders as jenc
from torcheasyrec_tpu.modules.gr import hstu_transducer as jtr
from torcheasyrec_tpu.modules.gr import preprocessors as jpre
from torcheasyrec_tpu.protos import module_pb2 as jmodule_pb2
from torcheasyrec_tpu_torch.modules.gr import encoders as penc
from torcheasyrec_tpu_torch.modules.gr import hstu_transducer as ptr
from torcheasyrec_tpu_torch.modules.gr import preprocessors as ppre
from torcheasyrec_tpu_torch.protos import module_pb2
from torcheasyrec_tpu_torch.utils.convert import from_jax_state

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
F32 = torch.float32


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ctx(training=True, seed=0):
    return JM.Context(training=training, rng=jax.random.PRNGKey(seed))


def _load(module, params):
    """The JAX parameters into the port module (every one of them)."""
    module.load_state_dict(from_jax_state(jax.device_get(params), {}))
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, ref, name, tol=FWD_TOL):
    assert_close_to_max(got.detach().numpy(), np.asarray(ref), name, tol)


def _mlp_cfg(text):
    return (text_format.Parse(text, jmodule_pb2.GRContextualizedMLP()),
            text_format.Parse(text, module_pb2.GRContextualizedMLP()))


# -- content encoders ----------------------------------------------------------


def test_slice_content_encoder():
    j = jpre.SliceContentEncoder(uih_dim=4, cand_dim=6)
    p = ppre.SliceContentEncoder(uih_dim=4, cand_dim=6)
    assert p.output_dim() == j.output_dim() == 4
    u = np.ones((2, 3, 4), np.float32)
    c = np.arange(24, dtype=np.float32).reshape(2, 2, 6)
    juo, jco = j({}, jnp.asarray(u), jnp.asarray(c), _ctx())
    uo, co = p(_t(u), _t(c), F32)
    np.testing.assert_array_equal(uo.numpy(), np.asarray(juo))
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    for cls in (jpre.SliceContentEncoder, ppre.SliceContentEncoder):
        with pytest.raises(ValueError):
            cls(uih_dim=8, cand_dim=6)


def test_pad_content_encoder():
    j = jpre.PadContentEncoder(uih_dim=4, cand_dim=6)
    jp = j.init(jax.random.PRNGKey(0))
    p = _load(ppre.PadContentEncoder(4, 6, _gen()), jp)
    assert p.output_dim() == j.output_dim() == 6
    u = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32)
    c = np.ones((2, 2, 6), np.float32)
    juo, jco = j(jp, jnp.asarray(u), jnp.asarray(c), _ctx())
    uo, co = p(_t(u), _t(c), F32)
    assert uo.shape == (2, 3, 6)
    np.testing.assert_array_equal(uo.detach().numpy(), np.asarray(juo))
    np.testing.assert_array_equal(co.numpy(), np.asarray(jco))
    with pytest.raises(ValueError):
        ppre.PadContentEncoder(6, 6, _gen())


def test_mlp_content_encoder():
    kw = dict(uih_mlp={"hidden_units": [8]}, target_mlp={"hidden_units": [8]})
    j = jpre.MLPContentEncoder(uih_dim=4, cand_dim=6, **kw)
    jp = j.init(jax.random.PRNGKey(0))
    p = _load(ppre.MLPContentEncoder(4, 6, generator=_gen(), **kw), jp)
    assert p.output_dim() == j.output_dim() == 8
    r = np.random.default_rng(1)
    u = r.normal(size=(2, 3, 4)).astype(np.float32)
    c = r.normal(size=(2, 2, 6)).astype(np.float32)
    juo, jco = j(jp, jnp.asarray(u), jnp.asarray(c), _ctx(False))
    uo, co = p(_t(u), _t(c), F32)
    assert uo.shape == (2, 3, 8) and co.shape == (2, 2, 8)
    _close(uo, juo, "uih")
    _close(co, jco, "target")
    with pytest.raises(ValueError):
        ppre.MLPContentEncoder(4, 6, {"hidden_units": [8]},
                               {"hidden_units": [9]}, _gen())


# -- contextualized MLPs -------------------------------------------------------


def test_simple_contextualized_mlp_shape():
    j = jpre.SimpleContextualizedMLP(in_dim=4, out_dim=6, hidden_dim=8)
    jp = j.init(jax.random.PRNGKey(0))
    p = _load(ppre.SimpleContextualizedMLP(4, 6, 8, _gen()), jp)
    x = np.random.default_rng(2).normal(size=(2, 5, 4)).astype(np.float32)
    y = p(_t(x), None, F32)
    assert y.shape == (2, 5, 6)
    _close(y, j(jp, jnp.asarray(x), None, _ctx(False)), "y")
    # the final LayerNorm: per-token zero mean
    np.testing.assert_allclose(y.detach().mean(-1).numpy(), np.zeros((2, 5)),
                               atol=1e-5)

    # the gradient of every parameter and of the input, of a fixed random
    # projection (the final LayerNorm makes a sum of squares constant)
    proj = np.random.default_rng(5).normal(size=y.shape).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(j(params, xx, None, _ctx(False)) * proj)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (p(xt, None, F32) * _t(proj)).sum().backward()
    ref = from_jax_state(jax.device_get(jg), {})
    for n, par in p.named_parameters():
        _close(par.grad, ref[n], n, GRAD_TOL)
    _close(xt.grad, jgx, "x", GRAD_TOL)


def test_parameterized_contextualized_mlp_matches_manual():
    j = jpre.ParameterizedContextualizedMLP(
        ctx_dim=3, in_dim=4, out_dim=5, hidden_dim=8,
        contextual_dropout_ratio=0.0)
    jp = j.init(jax.random.PRNGKey(1))
    p = _load(ppre.ParameterizedContextualizedMLP(3, 4, 5, 8, _gen(), 0.0),
              jp)
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 6, 4)).astype(np.float32)
    c = r.normal(size=(2, 3)).astype(np.float32)
    ctx = _ctx(False)
    y = p(_t(x), _t(c), F32)
    _close(y, j(jp, jnp.asarray(x), jnp.asarray(c), ctx), "y")
    w, b = p._weights(_t(c), F32)
    jw, jb = j._weights(jp, jnp.asarray(c), ctx)
    _close(w, jw, "W")
    _close(b, jb, "b")
    manual = np.einsum("bli,bio->blo", x, w.detach().numpy()) + \
        b.detach().numpy()[:, None, :]
    np.testing.assert_allclose(y.detach().numpy(), manual, rtol=1e-4,
                               atol=1e-5)
    # per-sample weights differ across samples
    assert not np.allclose(w[0].detach().numpy(), w[1].detach().numpy())

    def jloss(params, xx, cc):
        return jnp.sum(j(params, xx, cc, ctx) ** 2)

    jg, jgx, jgc = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(c))
    xt, ct = _t(x).requires_grad_(True), _t(c).requires_grad_(True)
    (p(xt, ct, F32) ** 2).sum().backward()
    ref = from_jax_state(jax.device_get(jg), {})
    for n, par in p.named_parameters():
        _close(par.grad, ref[n], n, GRAD_TOL)
    _close(xt.grad, jgx, "x", GRAD_TOL)
    _close(ct.grad, jgc, "contextual", GRAD_TOL)
    with pytest.raises(ValueError):
        p(_t(x), None, F32)


def test_parameterized_mlp_contextual_dropout_draws_from_the_generator():
    """Training mode drops the contextual input with masks drawn from
    the module's generator: two calls differ, a generator of the same
    seed repeats them, and eval mode is the identity."""
    r = np.random.default_rng(4)
    x = _t(r.normal(size=(2, 6, 4)).astype(np.float32))
    c = _t(r.normal(size=(2, 3)).astype(np.float32))
    p = ppre.ParameterizedContextualizedMLP(3, 4, 5, 8, _gen(7), 0.5)
    a, b = p(x, c, F32), p(x, c, F32)
    assert not torch.equal(a, b)
    q = ppre.ParameterizedContextualizedMLP(3, 4, 5, 8, _gen(7), 0.5)
    assert torch.equal(q(x, c, F32), a)
    p.eval()
    assert torch.equal(p(x, c, F32), p(x, c, F32))


# -- the interleave preprocessor -----------------------------------------------


def _build(enable_interleaving, n_ctx=0, ctx_dim=0):
    """(JAX preprocessor, its params, the port's with those params)."""
    jc, pc = _mlp_cfg("simple_mlp { hidden_dim: 8 }")
    ja, pa_ = _mlp_cfg("simple_mlp { hidden_dim: 8 }")
    j = jpre.ContextualInterleavePreprocessor(
        embedding_dim=6, uih_content_dim=4, cand_content_dim=4,
        content_encoder=jpre.SliceContentEncoder(4, 4),
        content_mlp_cfg=jc, contextual_dim=ctx_dim,
        n_contextual_tokens=n_ctx,
        action_encoder=jenc.SimpleActionEncoder(4, [1, 2]),
        action_mlp_cfg=ja, enable_interleaving=enable_interleaving,
        input_dropout_ratio=0.0)
    jp = j.init(jax.random.PRNGKey(0))
    g = _gen()
    p = ppre.ContextualInterleavePreprocessor(
        6, 4, 4, ppre.SliceContentEncoder(4, 4), pc, g,
        contextual_dim=ctx_dim, n_contextual_tokens=n_ctx,
        action_encoder=penc.SimpleActionEncoder(4, [1, 2], g),
        action_mlp_cfg=pa_, enable_interleaving=enable_interleaving,
        input_dropout_ratio=0.0)
    return j, jp, _load(p, jp)


def _inputs(b=2, lu_max=5, lc_max=3, seed=0):
    r = np.random.default_rng(seed)
    return dict(
        uih_emb=r.normal(size=(b, lu_max, 4)).astype(np.float32),
        uih_lengths=np.array([5, 3], np.int32),
        cand_emb=r.normal(size=(b, lc_max, 4)).astype(np.float32),
        cand_lengths=np.array([3, 2], np.int32),
        action_weights=r.integers(0, 4, (b, lu_max)).astype(np.int32),
        uih_timestamps=np.cumsum(r.integers(1, 100, (b, lu_max)),
                                 axis=1).astype(np.float32),
        cand_timestamps=np.full((b, lc_max), 1e6, np.float32),
    )


def _run(j, jp, p, ins, training):
    """Both preprocessors on ``ins``: (JAX outputs, port outputs)."""
    jout = j(jp, ctx=_ctx(training), **{k: jnp.asarray(v)
                                        for k, v in ins.items()})
    p.train(training)
    pout = p(compute_dtype=F32, **{k: _t(v) for k, v in ins.items()})
    return jout, pout


def _assert_same(jout, pout):
    jx, jl, jn, jts = jout
    x, lengths, num_targets, ts = pout
    assert x.shape == jx.shape
    _close(x, jx, "x")
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(num_targets.numpy(), np.asarray(jn))
    if jts is None:
        assert ts is None
    else:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))


def test_interleave_train_doubles_all_tokens():
    j, jp, p = _build(True)
    jout, pout = _run(j, jp, p, _inputs(), True)
    _assert_same(jout, pout)
    x, lengths, num_targets, ts = pout
    np.testing.assert_array_equal(lengths.numpy(), [16, 10])
    np.testing.assert_array_equal(num_targets.numpy(), [6, 4])
    assert x.shape == (2, 2 * 5 + 2 * 3, 6)
    # the timestamps repeat per pair
    np.testing.assert_array_equal(ts[:, 0].numpy(), ts[:, 1].numpy())
    np.testing.assert_array_equal(ts[:, 2].numpy(), ts[:, 3].numpy())


def test_interleave_eval_keeps_targets_single():
    j, jp, p = _build(True)
    jout, pout = _run(j, jp, p, _inputs(), False)
    _assert_same(jout, pout)
    x, lengths, num_targets, _ = pout
    np.testing.assert_array_equal(lengths.numpy(), [13, 8])
    np.testing.assert_array_equal(num_targets.numpy(), [3, 2])
    assert x.shape == (2, 2 * 5 + 3, 6)


def test_interleave_order_and_candidate_stride():
    """Even offsets carry content tokens, odd ones action tokens, and
    extract_candidates with stride 2 gives the content tokens' rows, in
    both packages."""
    j, jp, p = _build(True)
    ins = _inputs()
    jout, pout = _run(j, jp, p, ins, True)
    _assert_same(jout, pout)
    x, lengths, num_targets, _ = pout
    u_c, c_c = p.content_encoder(_t(ins["uih_emb"]), _t(ins["cand_emb"]), F32)
    content_u = p.content_mlp(u_c, None, F32)
    action_u = p.action_mlp(p.action(_t(ins["action_weights"])), None, F32)
    for k in range(5):
        _close(x[0, 2 * k], content_u[0, k].detach().numpy(), f"c{k}")
        _close(x[0, 2 * k + 1], action_u[0, k].detach().numpy(), f"a{k}")
    content_c = p.content_mlp(c_c, None, F32)
    got = ptr.extract_candidates(x, 0, lengths - num_targets, 3, stride=2)
    jgot = jtr.extract_candidates(jout[0], 0, jout[1] - jout[2], 3, stride=2)
    _close(got, jgot, "extract")
    for row, lc in ((0, 3), (1, 2)):
        for c in range(lc):
            _close(got[row, c], content_c[row, c].detach().numpy(), "cand")


def test_non_interleave_sums_paths():
    j, jp, p = _build(False)
    ins = _inputs()
    jout, pout = _run(j, jp, p, ins, True)
    _assert_same(jout, pout)
    x, lengths, num_targets, _ = pout
    np.testing.assert_array_equal(lengths.numpy(), [8, 5])
    np.testing.assert_array_equal(num_targets.numpy(), [3, 2])
    u_c, _ = p.content_encoder(_t(ins["uih_emb"]), _t(ins["cand_emb"]), F32)
    want = (p.content_mlp(u_c, None, F32)
            + p.action_mlp(p.action(_t(ins["action_weights"])), None, F32))
    _close(x[0, 0], want[0, 0].detach().numpy(), "sum")


def test_target_action_embedding_used():
    """The targets carry the learned target-action vector through the
    action MLP; the gradient reaches it alike in both packages."""
    j, jp, p = _build(True)
    ins = _inputs()
    jout, pout = _run(j, jp, p, ins, True)
    x = pout[0]
    a_c = p.target_action.expand(2, 3, 8)
    action_c = p.action_mlp(a_c, None, F32)
    # row 0: the first target pair starts at 2 * lu = 10; action at 11
    _close(x[0, 11], action_c[0, 0].detach().numpy(), "target action")

    # a fixed random projection of the tokens: a sum of squares of
    # LayerNorm outputs is constant, and its gradient rounding noise
    proj = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(params):
        return jnp.sum(j(params, ctx=_ctx(True), **{
            k: jnp.asarray(v) for k, v in ins.items()})[0] * proj)

    jg = from_jax_state(jax.device_get(jax.grad(jloss)(jp)), {})
    p.zero_grad()
    (p(compute_dtype=F32, **{k: _t(v) for k, v in ins.items()})[0]
     * _t(proj)).sum().backward()
    assert set(n for n, _ in p.named_parameters()) == set(jg)
    for n, par in p.named_parameters():
        _close(par.grad, jg[n], n, GRAD_TOL)
    assert float(p.target_action.grad.abs().sum()) > 0


def test_contextual_prefix_tokens():
    j, jp, p = _build(True, n_ctx=2, ctx_dim=6)
    ins = _inputs()
    ins["contextual_emb"] = np.random.default_rng(9).normal(
        size=(2, 6)).astype(np.float32)
    jout, pout = _run(j, jp, p, ins, True)
    _assert_same(jout, pout)
    np.testing.assert_array_equal(pout[1].numpy(), [18, 12])
    # the contextual tokens' timestamps are zero
    np.testing.assert_array_equal(pout[3][:, :2].numpy(), np.zeros((2, 2)))


def test_interleave_requires_action_encoder():
    jc, pc = _mlp_cfg("simple_mlp { hidden_dim: 8 }")
    with pytest.raises(ValueError):
        jpre.ContextualInterleavePreprocessor(
            embedding_dim=6, uih_content_dim=4, cand_content_dim=4,
            content_encoder=jpre.SliceContentEncoder(4, 4),
            content_mlp_cfg=jc, enable_interleaving=True)
    with pytest.raises(ValueError, match="action_encoder"):
        ppre.ContextualInterleavePreprocessor(
            6, 4, 4, ppre.SliceContentEncoder(4, 4), pc, _gen(),
            enable_interleaving=True)


# -- the UIH preprocessor ------------------------------------------------------


def test_uih_preprocessor():
    ja, pa_ = _mlp_cfg("simple_mlp { hidden_dim: 8 }")
    j = jpre.UIHPreprocessor(
        embedding_dim=6, uih_content_dim=4, contextual_dim=6,
        n_contextual_tokens=2,
        action_encoder=jenc.SimpleActionEncoder(4, [1, 2]),
        action_mlp_cfg=ja)
    jp = j.init(jax.random.PRNGKey(0))
    g = _gen()
    p = _load(ppre.UIHPreprocessor(
        6, 4, g, contextual_dim=6, n_contextual_tokens=2,
        action_encoder=penc.SimpleActionEncoder(4, [1, 2], g),
        action_mlp_cfg=pa_), jp)
    ins = _inputs()
    ctx_emb = np.random.default_rng(4).normal(size=(2, 6)).astype(np.float32)
    keys = ("uih_emb", "uih_lengths", "action_weights", "uih_timestamps")
    jout = j(jp, ctx=_ctx(False), contextual_emb=jnp.asarray(ctx_emb),
             **{k: jnp.asarray(ins[k]) for k in keys})
    p.eval()
    pout = p(compute_dtype=F32, contextual_emb=_t(ctx_emb),
             **{k: _t(ins[k]) for k in keys})
    _assert_same(jout, pout)
    assert pout[0].shape == (2, 2 + 5, 6)
    np.testing.assert_array_equal(pout[1].numpy(), [7, 5])
    np.testing.assert_array_equal(pout[2].numpy(), [0, 0])
    assert not p.interleave_targets(True)
    with pytest.raises(ValueError, match="action_mlp"):
        ppre.UIHPreprocessor(6, 4, g,
                             action_encoder=penc.SimpleActionEncoder(
                                 4, [1, 2], g))


# -- the factory ---------------------------------------------------------------

FULL_FAMILY = """
%s {
    action_encoder {
        simple_action_encoder { action_embedding_dim: 4
                                action_weights: [1, 2] }
    }
    action_mlp { simple_mlp { hidden_dim: 8 } }
    content_encoder { slice_content_encoder {} }
    content_mlp { simple_mlp { hidden_dim: 8 } }
}
"""


def _factories(pre_text):
    kw = dict(embedding_dim=6, uih_content_dim=4, cand_content_dim=4,
              contextual_dim=0, n_contextual_tokens=0)
    j = jpre.preprocessor_from_config(text_format.Parse(
        pre_text, jmodule_pb2.GRInputPreprocessor()), **kw)
    p = ppre.preprocessor_from_config(text_format.Parse(
        pre_text, module_pb2.GRInputPreprocessor()), generator=_gen(), **kw)
    return j, p


def test_factory_oneof_mapping():
    """contextual_preprocessor: interleaving off;
    contextual_interleave_preprocessor: on; uih_preprocessor: the UIH
    class; nothing set: None. The built modules compute the JAX ones'
    outputs."""
    for which, on in (("contextual_preprocessor", False),
                      ("contextual_interleave_preprocessor", True)):
        j, p = _factories(FULL_FAMILY % which)
        assert isinstance(p, ppre.ContextualInterleavePreprocessor)
        assert p.enable_interleaving is on is j.enable_interleaving
        jp = j.init(jax.random.PRNGKey(0))
        _assert_same(*_run(j, jp, _load(p, jp), _inputs(), True))
    j, p = _factories("uih_preprocessor {}")
    assert isinstance(p, ppre.UIHPreprocessor) and p.action is None
    assert _factories("") == (None, None)


def test_interleave_tokens_helper():
    a = np.arange(6, dtype=np.float32).reshape(1, 3, 2)
    out = ppre.interleave_tokens(_t(a), _t(-a))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jpre.interleave_tokens(jnp.asarray(a),
                                                       jnp.asarray(-a))))
    np.testing.assert_array_equal(out[0, ::2].numpy(), a[0])
    np.testing.assert_array_equal(out[0, 1::2].numpy(), -a[0])
    ts = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(ppre.repeat2(_t(ts)).numpy(),
                                  np.asarray(jpre.repeat2(jnp.asarray(ts))))
