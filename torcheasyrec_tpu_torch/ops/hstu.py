"""HSTU core ops: uvqk projection, pointwise-SiLU attention, output.

Counterpart of torcheasyrec_tpu/ops/hstu.py. Sequences are padded dense
``[B, N, ...]`` with per-sample ``lengths``; the attention masks follow
``valid_attn_mask`` of the JAX package bit for bit.

``hstu_mha`` dispatches: a CUDA tensor goes to the hand-written kernels
unless the config asked for the plain version (Kernel.PYTORCH /
Kernel.JAX, differentiated by plain autograd); a CPU tensor goes to the
plain versions. The forward goes through the operator
``torch.ops.tzrec_tpu_torch.hstu_attention_fwd`` (``hstu_attention_op``),
whose CUDA implementation launches the kernel and whose CPU one is the
plain version, so that ``torch.export`` keeps it in an exported program
on either device. The forward kernel ``ops/csrc/hstu_attention_fwd.cu``
replaces the Pallas kernel
``torcheasyrec_tpu/ops/pallas/hstu_attention.py:_fwd_kernel``; the fused
backward kernel ``ops/csrc/hstu_attention_bwd.cu`` replaces
``_bwd_dv_dk_kernel`` there. When a gradient is required the call goes
through ``HstuAttentionFunction``, which saves q, k, v and the lengths
only (no score matrix) and recomputes the scores tile by tile in its
backward. The kernels take fp32, bf16 and fp16 (``DTYPE_CODES``); the
kernel paths check their inputs and raise; they never fall back. The
plain versions beside them are ``_torch_hstu_mha`` and
``_torch_hstu_mha_bwd``, in every dtype.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torcheasyrec_tpu_torch.modules.module import (
    apply_dropout,
    dropout_keep_mask,
)
from torcheasyrec_tpu_torch.ops import Kernel, uses_cuda_kernel
from torcheasyrec_tpu_torch.ops import cuda_build

# head dims the kernels take: 16 (HSTU-Match's towers) on the fp32
# kernels only, whose tiles have no width floor
_KERNEL_HEAD_DIMS = (32, 64, 128)
_F32_KERNEL_HEAD_DIMS = (16,) + _KERNEL_HEAD_DIMS
# the kernels' dtype code (their C interface): fp32 on the CUDA cores,
# bf16 and fp16 through wgmma
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    row_pos: Optional[torch.Tensor] = None,  # [B, R] row subset
) -> torch.Tensor:
    """[B, N, N] bool mask, row i attending column j, or [B, R, N] for
    the rows ``row_pos`` selects (the cached decode's new tokens). Rows
    and columns at or past the length are masked, so padded rows output
    zeros.

    With sla_k1 or sla_k2 > 0, Semi-Local Attention replaces the causal
    mask: history rows attend the prefix [0, min(eff_k2, i + 1)) and the
    window [max(eff_k2, i - k1 + 1), i + 1), where
    eff_k2 = max(sla_k2, contextual_seq_len); target rows attend all
    history only.
    """
    b = lengths.shape[0]
    dev = lengths.device
    if row_pos is None:
        rows = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    else:
        rows = row_pos.to(torch.int32)[:, :, None]
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
        return (mask & col_valid).expand(b, rows.shape[1], n)

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
    return (mask & col_valid).expand(b, rows.shape[1], n)


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
    dropout_keep: Optional[torch.Tensor] = None,  # bool [B, H, N, N]
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Pointwise-SiLU attention. Returns [B, N, H, V] in v's dtype.

    With ``dropout_pr`` > 0 the masked scores are dropped (the kept ones
    scaled by 1 / (1 - p)) before the second product, on the plain path
    only, as the JAX package runs it: on CUDA tensors the caller asks for
    it with ``Kernel.PYTORCH`` (a kernel route raises ValueError). The
    keep mask is ``dropout_keep``, else drawn from ``generator``; with
    neither it raises ValueError. No config reaches this: the STU drops
    its output, not the attention probabilities."""
    if scaling_seqlen == -1:
        scaling_seqlen = q.shape[1]
    if dropout_pr > 0.0:
        if q.is_cuda and uses_cuda_kernel(kernel):
            raise ValueError(
                "attention dropout has no kernel: pass kernel=Kernel.PYTORCH "
                "to run it on the plain path")
        if dropout_keep is None:
            b, n, h, _ = q.shape
            dropout_keep = dropout_keep_mask((b, h, n, n), dropout_pr,
                                             q.device, generator)
        return _torch_hstu_mha(
            q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
            contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
            sla_k1, sla_k2, dropout_pr, dropout_keep,
        )
    if uses_cuda_kernel(kernel):
        lengths = lengths.to(torch.int32).contiguous()
        if num_targets is not None:
            num_targets = num_targets.to(torch.int32).contiguous()
        if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad
        ):
            return HstuAttentionFunction.apply(
                q, k, v, lengths, num_targets, alpha, causal, max_attn_len,
                contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
                sla_k1, sla_k2,
            )
        return _attention_forward(
            q, k, v, lengths, num_targets, alpha, causal, max_attn_len,
            contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
            sla_k1, sla_k2,
        )
    return _torch_hstu_mha(
        q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
        contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
        sla_k1, sla_k2,
    )


def _torch_hstu_mha(
    q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
    contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
    sla_k1=0, sla_k2=0, dropout_pr=0.0, dropout_keep=None,
) -> torch.Tensor:
    """Plain version of the attention: materializes [B, H, N, N] scores.
    Counterpart of ``_jax_hstu_mha``; the scores are cast to v's dtype
    before the second product, both products accumulate in fp32. With
    ``dropout_keep`` (bool [B, H, N, N]) and ``dropout_pr`` > 0 the masked
    scores are dropped as the JAX package drops them."""
    n = q.shape[1]
    qk = torch.einsum("bxhd,byhd->bhxy", q.float(), k.float()) * alpha
    attn = F.silu(qk) / scaling_seqlen
    mask = valid_attn_mask(
        n, lengths, causal, num_targets, max_attn_len, contextual_seq_len,
        min_full_attn_seq_len, sla_k1=sla_k1, sla_k2=sla_k2,
    )
    attn = attn * mask[:, None].to(attn.dtype)
    if dropout_pr > 0.0 and dropout_keep is not None:
        attn = apply_dropout(attn, dropout_keep, dropout_pr)
    out = torch.einsum(
        "bhxy,byhv->bxhv", attn.to(v.dtype).float(), v.float()
    )
    return out.to(v.dtype)


def delta_hstu_mha(
    delta_q: torch.Tensor,  # [B, Ld, H, D]: the new tokens' queries
    k: torch.Tensor,  # [B, N, H, D]: cached and new keys
    v: torch.Tensor,  # [B, N, H, V]
    lengths: torch.Tensor,  # [B] valid tokens, the new ones included
    alpha: float,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    contextual_seq_len: int = 0,
    scaling_seqlen: int = -1,
    sla_k1: int = 0,
    sla_k2: int = 0,
) -> torch.Tensor:
    """The cached decode's attention, counterpart of the JAX package's
    ``delta_hstu_mha`` (plain there too: no Pallas kernel). The Ld new
    tokens sit at positions [lengths - Ld, lengths) and attend the cached
    sequence causally; only their Ld mask rows are built. Returns
    [B, Ld, H, V] in v's dtype."""
    ld = delta_q.shape[1]
    n = k.shape[1]
    if scaling_seqlen == -1:
        scaling_seqlen = n
    qk = torch.einsum("bxhd,byhd->bhxy", delta_q.float(), k.float()) * alpha
    attn = F.silu(qk) / scaling_seqlen
    row_pos = torch.clamp(
        lengths.to(torch.int32)[:, None] - ld
        + torch.arange(ld, dtype=torch.int32, device=lengths.device)[None],
        0, n - 1)
    mask = valid_attn_mask(
        n, lengths, True, num_targets, max_attn_len, contextual_seq_len, 0,
        sla_k1=sla_k1, sla_k2=sla_k2, row_pos=row_pos)
    attn = attn * mask[:, None].to(attn.dtype)
    out = torch.einsum(
        "bhxy,byhv->bxhv", attn.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _torch_hstu_mha_bwd(
    q, k, v, do, lengths, alpha, causal, num_targets, max_attn_len,
    contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
    sla_k1=0, sla_k2=0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the attention backward, written out from the
    formulas of the Pallas kernel ``_bwd_dv_dk_kernel`` (no autograd):
    with z = alpha q k^T and s = mask SiLU(z) / scale,
    dv = s^T do, dz = mask (do v^T) SiLU'(z) alpha / scale, dk = dz^T q,
    dq = dz k. s and dz are cast to the inputs' dtype before the second
    products; every product accumulates in fp32. Materializes
    [B, H, N, N]. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    n = q.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    z = torch.einsum("bxhd,byhd->bhxy", qf, kf) * alpha
    mask = valid_attn_mask(
        n, lengths, causal, num_targets, max_attn_len, contextual_seq_len,
        min_full_attn_seq_len, sla_k1=sla_k1, sla_k2=sla_k2,
    )[:, None]
    sig = torch.sigmoid(z)
    zero = z.new_zeros(())
    s = torch.where(mask, z * sig / scaling_seqlen, zero)
    dv = torch.einsum("bhxy,bxhv->byhv", s.to(do.dtype).float(), dof)
    dattn = torch.einsum("bxhv,byhv->bhxy", dof, vf)
    dsilu = sig * (1.0 + z * (1.0 - sig))
    dz = torch.where(mask, dattn * dsilu * (alpha / scaling_seqlen), zero)
    dz = dz.to(q.dtype).float()
    dk = torch.einsum("bhxy,bxhd->byhd", dz, qf)
    dq = torch.einsum("bhxy,byhd->bxhd", dz, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class HstuAttentionFunction(torch.autograd.Function):
    """The attention with its hand-written backward. CUDA tensors run the
    forward and backward kernels, CPU tensors their plain versions. Saves
    q, k, v, lengths and num_targets only, as the JAX package's
    ``_fwd_rule`` does."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, num_targets, alpha, causal,
                max_attn_len, contextual_seq_len, min_full_attn_seq_len,
                scaling_seqlen, sla_k1, sla_k2):
        ctx.save_for_backward(q, k, v, lengths, num_targets)
        ctx.mask_args = (causal, max_attn_len, contextual_seq_len,
                         min_full_attn_seq_len, scaling_seqlen, sla_k1,
                         sla_k2)
        ctx.alpha = alpha
        return _attention_forward(
            q, k, v, lengths, num_targets, alpha, causal, max_attn_len,
            contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
            sla_k1, sla_k2,
        )

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, num_targets = ctx.saved_tensors
        (causal, max_attn_len, contextual_seq_len, min_full_attn_seq_len,
         scaling_seqlen, sla_k1, sla_k2) = ctx.mask_args
        if q.is_cuda:
            grads = hstu_attention_bwd(
                q, k, v, do.contiguous(), lengths, num_targets, ctx.alpha,
                causal, max_attn_len, contextual_seq_len,
                min_full_attn_seq_len, scaling_seqlen, sla_k1, sla_k2,
            )
        else:
            grads = _torch_hstu_mha_bwd(
                q, k, v, do, lengths, ctx.alpha, causal, num_targets,
                max_attn_len, contextual_seq_len, min_full_attn_seq_len,
                scaling_seqlen, sla_k1, sla_k2,
            )
        return (*grads,) + (None,) * 10


def check_kernel_inputs(q, k, v, lengths, num_targets) -> None:
    """Raise unless the CUDA kernels take these tensors as they are."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(
            f"the hstu attention kernels take fp32, bf16 or fp16, got "
            f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or (
        v.shape[:3] != q.shape[:3]
    ):
        raise ValueError(
            f"expected q, k [B, N, H, D] and v [B, N, H, V], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    dims = (_F32_KERNEL_HEAD_DIMS if q.dtype == torch.float32
            else _KERNEL_HEAD_DIMS)
    if q.shape[3] not in dims or v.shape[3] not in dims:
        raise ValueError(
            f"head dims must be in {dims} for {q.dtype}, got D={q.shape[3]} "
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
        raise ValueError("the hstu attention kernels take CUDA tensors only")


def _kernel_lib(name: str, n_pointers: int) -> ctypes.CDLL:
    """The library of kernel ``name``, whose C function of the same name
    takes ``n_pointers`` pointers, then b, n, h, d, v_dim, the dtype code
    (``DTYPE_CODES``), alpha,
    1/scale, the six mask ints and the stream."""
    lib = cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_pointers + [i] * 6 + [f, f] + [i] * 6 + [p]
        fn.restype = i
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
    lib = _kernel_lib("hstu_attention_fwd", 6)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hstu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            b, n, h, d, vd, DTYPE_CODES[q.dtype],
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


@torch.library.custom_op("tzrec_tpu_torch::hstu_attention_fwd",
                         mutates_args=(), device_types="cpu")
def hstu_attention_op(
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
    sla_k1: int,
    sla_k2: int,
) -> torch.Tensor:
    """The attention forward as an operator of its own,
    ``torch.ops.tzrec_tpu_torch.hstu_attention_fwd``, so that
    ``torch.export`` keeps it as one node of the graph (it traces its
    fake version) and the exported program runs the kernel. The CPU
    implementation is the plain version; the CUDA one launches the kernel
    through ``hstu_attention_fwd`` (it raises on inputs the kernel does
    not take). A saved program that names the operator loads only in a
    process that has imported this module. The backward kernel stays
    on ``HstuAttentionFunction``: training is not exported."""
    return _torch_hstu_mha(
        q, k, v, lengths, alpha, causal, num_targets, max_attn_len,
        contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
        sla_k1, sla_k2,
    )


def _attention_forward(q, k, v, lengths, num_targets, alpha, causal,
                       max_attn_len, contextual_seq_len,
                       min_full_attn_seq_len, scaling_seqlen, sla_k1,
                       sla_k2) -> torch.Tensor:
    """The operator with its scalars in the schema's types."""
    return hstu_attention_op(
        q, k, v, lengths, num_targets, float(alpha), bool(causal),
        int(max_attn_len), int(contextual_seq_len),
        int(min_full_attn_seq_len), int(scaling_seqlen), int(sla_k1),
        int(sla_k2))


@hstu_attention_op.register_kernel("cuda")
def _hstu_attention_op_cuda(q, k, v, lengths, num_targets, alpha, causal,
                            max_attn_len, contextual_seq_len,
                            min_full_attn_seq_len, scaling_seqlen, sla_k1,
                            sla_k2):
    return hstu_attention_fwd(
        q, k, v, lengths, num_targets, alpha, causal, max_attn_len,
        contextual_seq_len, min_full_attn_seq_len, scaling_seqlen,
        sla_k1, sla_k2,
    )


@hstu_attention_op.register_fake
def _hstu_attention_op_fake(q, k, v, lengths, num_targets, alpha, causal,
                            max_attn_len, contextual_seq_len,
                            min_full_attn_seq_len, scaling_seqlen, sla_k1,
                            sla_k2):
    return v.new_empty(tuple(q.shape[:3]) + (v.shape[3],))


def hstu_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused backward CUDA kernel on the current stream:
    (dq, dk, dv) for the upstream gradient ``do`` [B, N, H, V]. dq is
    summed by the kernel into a zeroed fp32 buffer with atomics and cast
    to q's dtype here. Counts its launches in
    ``hstu_attention_bwd.launches``."""
    check_kernel_inputs(q, k, v, lengths, num_targets)
    if (do.shape != v.shape or do.dtype != v.dtype or do.device != v.device
            or not do.is_contiguous() or do.data_ptr() % 16):
        raise ValueError(
            "do must be a contiguous, 16-byte aligned tensor of v's shape, "
            f"dtype and device, got {tuple(do.shape)} {do.dtype} {do.device}"
        )
    b, n, h, d = q.shape
    vd = v.shape[3]
    dq = torch.zeros((b, n, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib("hstu_attention_bwd", 9)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hstu_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lengths.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            b, n, h, d, vd, DTYPE_CODES[q.dtype],
            float(alpha), 1.0 / float(scaling_seqlen), int(bool(causal)),
            int(max_attn_len), int(contextual_seq_len),
            int(min_full_attn_seq_len), int(sla_k1), int(sla_k2), stream,
        )
    if rc != 0:
        msg = lib.hstu_attention_error_string(rc).decode()
        raise RuntimeError(f"hstu_attention_bwd launch failed: {msg} ({rc})")
    hstu_attention_bwd.launches += 1
    return dq.to(q.dtype), dk, dv


hstu_attention_bwd.launches = 0


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
    dropout_pr: float = 0.0,
    dropout_keep: Optional[torch.Tensor] = None,  # bool [B, N, H*linear_dim]
) -> torch.Tensor:
    """Norm(attn) * u -> dropout -> output projection -> residual. The
    caller draws ``dropout_keep`` in training mode (the JAX package passes
    a key); without it there is no dropout."""
    b, n = attn.shape[0], attn.shape[1]
    a = attn.reshape(b, n, -1).float()
    if group_norm:
        ah = a.reshape(b, n, num_heads, linear_dim)
        normed = F.layer_norm(ah, (linear_dim,), eps=eps).reshape(b, n, -1)
        normed = normed * norm_weight + norm_bias
    else:
        normed = F.layer_norm(a, (a.shape[-1],), norm_weight, norm_bias, eps)
    gated = normed.to(u.dtype) * u
    if dropout_keep is not None and dropout_pr > 0.0:
        gated = apply_dropout(gated, dropout_keep, dropout_pr)
    y = F.linear(gated, output_weight.to(gated.dtype)).to(x.dtype)
    return x + y
