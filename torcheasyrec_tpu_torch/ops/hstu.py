"""HSTU core ops: uvqk projection, pointwise-SiLU attention, output.

Counterpart of torcheasyrec_tpu/ops/hstu.py. Sequences are padded dense
``[B, N, ...]`` with per-sample ``lengths``; the attention masks follow
``valid_attn_mask`` of the JAX package bit for bit.

``hstu_mha`` dispatches: a CUDA tensor goes to the hand-written kernel
(``ops/csrc/hstu_attention_fwd.cu``, which replaces the Pallas kernel
``torcheasyrec_tpu/ops/pallas/hstu_attention.py:_fwd_kernel``) unless
the config asked for the plain version (Kernel.PYTORCH / Kernel.JAX); a
CPU tensor goes to the plain version ``_torch_hstu_mha``. The kernel
path checks its inputs and raises; it never falls back.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torcheasyrec_tpu_torch.ops import Kernel, uses_cuda_kernel
from torcheasyrec_tpu_torch.ops import cuda_build

_KERNEL_HEAD_DIMS = (32, 64, 128)


def valid_attn_mask(
    n: int,
    lengths: torch.Tensor,  # [B]
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,  # [B]
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
    sla_k1: int = 0,
    sla_k2: int = 0,
) -> torch.Tensor:
    """[B, N, N] bool mask, row i attending column j. Rows and columns at
    or past the length are masked, so padded rows output zeros.

    With sla_k1 or sla_k2 > 0, Semi-Local Attention replaces the causal
    mask: history rows attend the prefix [0, min(eff_k2, i + 1)) and the
    window [max(eff_k2, i - k1 + 1), i + 1), where
    eff_k2 = max(sla_k2, contextual_seq_len); target rows attend all
    history only.
    """
    b = lengths.shape[0]
    dev = lengths.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(n, dtype=torch.int32, device=dev)[None, None, :]
    len_b = lengths.to(torch.int32).reshape(b, 1, 1)
    col_valid = (cols < len_b) & (rows < len_b)

    if sla_k1 > 0 or sla_k2 > 0:
        eff_k2 = max(sla_k2, contextual_seq_len)
        t = (
            num_targets.to(torch.int32).reshape(b, 1, 1)
            if num_targets is not None
            else torch.zeros((b, 1, 1), dtype=torch.int32, device=dev)
        )
        h_bound = torch.clamp(len_b - t, min=0)
        hist = (cols < torch.clamp(rows + 1, max=eff_k2)) | (
            (cols >= torch.clamp(rows - sla_k1 + 1, min=eff_k2))
            & (cols <= rows)
        )
        tgt = cols < h_bound
        mask = torch.where(rows < h_bound, hist, tgt)
        return (mask & col_valid).expand(b, n, n)

    ids_r, ids_c = rows, cols
    max_ids = len_b
    if contextual_seq_len > 0:
        ids_r = torch.clamp(ids_r - contextual_seq_len + 1, min=0)
        ids_c = torch.clamp(ids_c - contextual_seq_len + 1, min=0)
        max_ids = max_ids - contextual_seq_len + 1
    if num_targets is not None:
        max_ids = max_ids - num_targets.to(torch.int32).reshape(b, 1, 1)
        ids_r = torch.minimum(ids_r, max_ids)
        ids_c = torch.minimum(ids_c, max_ids)
    dist = ids_r - ids_c
    if not causal:
        dist = dist.abs()
    mask = (rows == cols) | (dist > 0)
    if max_attn_len > 0:
        if min_full_attn_seq_len > 0:
            mask = mask & (
                (dist <= max_attn_len)
                | (ids_r >= max_ids - min_full_attn_seq_len)
            )
        else:
            mask = mask & (dist <= max_attn_len)
    if contextual_seq_len > 0:
        mask = mask | ((ids_r == 0) & (ids_c < max_ids))
    return (mask & col_valid).expand(b, n, n)


def hstu_mha(
    q: torch.Tensor,  # [B, N, H, D]
    k: torch.Tensor,  # [B, N, H, D]
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # [B]
    alpha: float,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    min_full_attn_seq_len: int = 0,
    scaling_seqlen: int = -1,
    dropout_pr: float = 0.0,
    kernel: Kernel = Kernel.PALLAS,
    sla_k1: int = 0,
    sla_k2: int = 0,
) -> torch.Tensor:
    """Pointwise-SiLU attention. Returns [B, N, H, V] in v's dtype."""
    if dropout_pr > 0.0:
        raise NotImplementedError("attention dropout (training) is not ported")
    if scaling_seqlen == -1:
        scaling_seqlen = q.shape[1]
    if q.is_cuda and uses_cuda_kernel(kernel):
        return hstu_attention_fwd(
            q, k, v, lengths.to(torch.int32).contiguous(),
            None if num_targets is None
            else num_targets.to(torch.int32).contiguous(),
            alpha, causal, max_attn_len, contextual_seq_len,
            min_full_attn_seq_len, scaling_seqlen, sla_k1, sla_k2,
        )
    return _torch_hstu_mha(
        q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
        contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
        sla_k1, sla_k2,
    )


def _torch_hstu_mha(
    q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
    contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
    sla_k1=0, sla_k2=0,
) -> torch.Tensor:
    """Plain version of the attention: materializes [B, H, N, N] scores.
    Counterpart of ``_jax_hstu_mha``; the scores are cast to v's dtype
    before the second product, both products accumulate in fp32."""
    n = q.shape[1]
    qk = torch.einsum("bxhd,byhd->bhxy", q.float(), k.float()) * alpha
    attn = F.silu(qk) / scaling_seqlen
    mask = valid_attn_mask(
        n, lengths, causal, num_targets, max_attn_len, contextual_seq_len,
        min_full_attn_seq_len, sla_k1=sla_k1, sla_k2=sla_k2,
    )
    attn = attn * mask[:, None].to(attn.dtype)
    out = torch.einsum(
        "bhxy,byhv->bxhv", attn.to(v.dtype).float(), v.float()
    )
    return out.to(v.dtype)


def check_kernel_inputs(q, k, v, lengths, num_targets) -> None:
    """Raise unless the CUDA kernel takes these tensors as they are."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hstu_attention_fwd takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or (
        v.shape[:3] != q.shape[:3]
    ):
        raise ValueError(
            f"expected q, k [B, N, H, D] and v [B, N, H, V], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[3] not in _KERNEL_HEAD_DIMS or v.shape[3] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head dims must be in {_KERNEL_HEAD_DIMS}, got D={q.shape[3]} "
            f"V={v.shape[3]}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("lengths", lengths), ("num_targets", num_targets)):
        if t is None:
            continue
        if (t.dtype != torch.int32 or t.shape != (q.shape[0],)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous int32 [B] tensor on {q.device}"
            )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not q.is_cuda:
        raise ValueError("hstu_attention_fwd takes CUDA tensors only")


def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("hstu_attention_fwd")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hstu_attention_fwd.argtypes = (
            [p] * 6 + [i] * 6 + [f, f] + [i] * 6 + [p]
        )
        lib.hstu_attention_fwd.restype = i
        lib.hstu_attention_error_string.argtypes = [i]
        lib.hstu_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def hstu_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    num_targets: Optional[torch.Tensor],
    alpha: float,
    causal: bool,
    max_attn_len: int,
    contextual_seq_len: int,
    min_full_attn_seq_len: int,
    scaling_seqlen: int,
    sla_k1: int = 0,
    sla_k2: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Counts its launches
    in ``hstu_attention_fwd.launches``."""
    check_kernel_inputs(q, k, v, lengths, num_targets)
    b, n, h, d = q.shape
    vd = v.shape[3]
    out = torch.empty((b, n, h, vd), dtype=v.dtype, device=v.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hstu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            b, n, h, d, vd, int(q.dtype == torch.bfloat16),
            float(alpha), 1.0 / float(scaling_seqlen), int(bool(causal)),
            int(max_attn_len), int(contextual_seq_len),
            int(min_full_attn_seq_len), int(sla_k1), int(sla_k2), stream,
        )
    if rc != 0:
        msg = lib.hstu_attention_error_string(rc).decode()
        raise RuntimeError(f"hstu_attention_fwd launch failed: {msg} ({rc})")
    hstu_attention_fwd.launches += 1
    return out


hstu_attention_fwd.launches = 0


def hstu_compute_uqvk(
    x: torch.Tensor,  # [B, N, E]
    norm_weight: torch.Tensor,
    norm_bias: torch.Tensor,
    uvqk_weight: torch.Tensor,  # [U + V + Q + K, E]
    uvqk_bias: torch.Tensor,
    num_heads: int,
    linear_dim: int,
    attn_dim: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm (fp32, then cast to x's dtype) -> fused uvqk projection
    -> SiLU(u). Returns u [B, N, H*linear_dim] and contiguous
    v [B, N, H, linear_dim], q and k [B, N, H, attn_dim]."""
    b, n, e = x.shape
    normed = F.layer_norm(x.float(), (e,), norm_weight, norm_bias, eps)
    normed = normed.to(x.dtype)
    uvqk = (
        F.linear(normed, uvqk_weight.to(x.dtype)).float() + uvqk_bias
    ).to(x.dtype)
    h, ld, ad = num_heads, linear_dim, attn_dim
    u, v, q, k = torch.split(uvqk, [h * ld, h * ld, h * ad, h * ad], dim=-1)
    u = F.silu(u)
    v = v.reshape(b, n, h, ld).contiguous()
    q = q.reshape(b, n, h, ad).contiguous()
    k = k.reshape(b, n, h, ad).contiguous()
    return u, v, q, k


def hstu_compute_output(
    attn: torch.Tensor,  # [B, N, H, linear_dim]
    u: torch.Tensor,  # [B, N, H*linear_dim]
    x: torch.Tensor,  # [B, N, E] residual
    norm_weight: torch.Tensor,
    norm_bias: torch.Tensor,
    output_weight: torch.Tensor,  # [E, H*linear_dim]
    group_norm: bool = False,
    num_heads: int = 1,
    linear_dim: int = 0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Norm(attn) * u -> output projection -> residual."""
    b, n = attn.shape[0], attn.shape[1]
    a = attn.reshape(b, n, -1).float()
    if group_norm:
        ah = a.reshape(b, n, num_heads, linear_dim)
        normed = F.layer_norm(ah, (linear_dim,), eps=eps).reshape(b, n, -1)
        normed = normed * norm_weight + norm_bias
    else:
        normed = F.layer_norm(a, (a.shape[-1],), norm_weight, norm_bias, eps)
    gated = normed.to(u.dtype) * u
    y = F.linear(gated, output_weight.to(gated.dtype)).to(x.dtype)
    return x + y
