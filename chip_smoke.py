#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths (torcheasyrec_tpu_torch) with seeded random
weights: DLRM-HSTU serving and training at the full width of the repo's
DLRM-HSTU lane (benchmark/bench_dlrm_hstu.py: batch 32, tables
10k x 256 and 100k x 256, STU 512/128/128, 4 heads, 3 layers, histories
up to 4000 tokens and 16 candidates, max_seq_len 4032, BF16, sparse
rowwise_adagrad lr 0.01, dense adam lr 0.001), and DeepFM training on
Criteo-shaped data (the config of the repo's train benchmark, bench.py:
26 id features at dim 16 plus their WIDE copies at dim 4, 13 dense
features, batch 8192, deep 512-256-128, final 128-64, BF16, sparse
rowwise_adagrad and dense adam at lr 0.001) with the tables at the
reference's real bucket sizes, uncapped, fp32 and packed. Phases, one
JSON line each:

1. env: the card, CUDA and torch versions; every CUDA kernel of the
   paths is built from the sources here (one nvcc per source, in
   parallel), with each kernel's registers, static shared memory and
   spills as ``ptxas -v`` reports them.
2. kernel, kernel_bwd: each attention kernel against its plain PyTorch
   version on the card, at the slice's shapes and over a sweep of every
   mask variant, head-dim pair, lengths at the 64- and 128-row tile
   edges, an SLA window shorter than a tile and batches wider than the
   card, fp32 and bf16; and with NaN in the padded rows of every input,
   where the result must be finite and equal to the plain version's on
   the inputs with those rows zero. Tolerance: max|kernel - plain| <=
   1e-4 * max|plain| in fp32 (TF32 off), <= 2e-2 * max|plain| in bf16
   (bf16 keeps ~3 significant digits and the sums run in another order),
   per output or gradient. kernel_bwd also holds both kernels, through
   the autograd Function, against autograd of the plain forward.
   kernel_row_write: the row-write kernel against its plain version,
   bit-equal over the whole table (a copy has no tolerance), at the
   DeepFM step's shape (the dim-16 group's table of 29.2 M physical rows
   of 128 lanes, 73 728 rows written) and over a sweep: unique ids, many
   duplicates on the scratch row, negative and too-large ids, one row,
   a row count that is no multiple of the block, the last real row
   (past the 2^32-byte line), int32 ids, a 2-row table, 256 lanes; with
   the times of the kernel, the plain version and ``index_copy_``.
3. slice: 4 requests of 32 through the port's eval step, then 2 of them
   again through ``predict_checkpoint`` (parquet in, parquet out), with
   the kernel launch counts set to 0 just before and read just after;
   outputs must be finite with probabilities in (0, 1), the two entry
   points must agree, and the whole model with the kernel must match the
   whole model with the plain attention on a batch of 8 at the bf16
   tolerance.
4. train: 6 steps of 32 through ``make_train_step``, then 2 steps through
   ``train_and_evaluate`` from a parquet file and a
   ``predict_checkpoint`` of its checkpoint, again with the launch counts
   set to 0 just before and read just after. Every loss must be finite,
   the loss on a repeated batch must fall (all dropout ratios are 0),
   rows the batches never touched must keep their bits and their
   accumulator its initial value, touched rows must change, each kernel
   must launch once per STU layer and step. On a batch of 8 the dense
   gradients of the whole model with the kernels are held against those
   with the plain attention: in fp32 within 1e-4 of each gradient's max;
   in bf16 against the noise floor, since two bf16 forwards that differ
   only in rounding already move these gradients by several percent (ReLU
   gates flip, sums of random signs cancel): each gradient's distance
   from the fp32 gradient must be at most three times the plain bf16
   model's (the two are equal within a factor of 1.5 when the kernels are
   right, tens apart when they are not).
5. timing, timing_train: median request and step time, each kernel's time
   beside the plain version's and the card's bound at the slice's shapes
   (with its TFLOP/s, its share of the bound and the time of the WMMA
   kernel it replaced), and a profile of one forward and of one train step
   by device kernel.
6. train_deepfm: warm-up and 30 timed steps on a resident batch through
   ``make_train_step`` at the uncapped sizes (19.1 GB of packed tables
   with their in-row accumulators), the same with the dense lane off;
   then, with the five 40 M-row tables capped at 10 M so that several
   models fit side by side and the checkpoint stays at 5 GB, 3 steps over
   distinct batches from a parquet file, an eval pass and the checkpoint
   through ``train_and_evaluate``, ``evaluate`` of that checkpoint, and a
   restore into a fresh model. The row-write launch count is set to 0
   before the driven steps and read after them. Checks: finite losses;
   the loss on the repeated batch falls; exactly 2 row-write launches
   per step; sampled physical rows that the batch did not touch keep
   their bits and touched ones change; in fp32 steps from the same
   weights and batches the packed engine agrees with the unpacked one,
   and the dense lane on with off, per table through ``extract_table``
   and ``extract_table_state``: within 1e-5 of each table's largest
   magnitude after 1 step; after 3 steps within 1e-3 of it, with at
   most 1e-5 of all elements beyond 1e-5 (atomic sums make even two
   runs of one layout differ, and rowwise adagrad's first update of a
   row amplifies that where a gradient nearly cancels; a second run of
   the packed engine is reported beside the other layouts; fp32 so that
   bf16 rounding flips add nothing); ``evaluate`` reproduces the AUC of
   ``train_and_evaluate``; the restored model holds the checkpoint's
   tables and row state bit for bit.

Then a ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and as the last line the device record. Any failure raises
and exits non-zero; without CUDA it exits non-zero before any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# --- the bench_dlrm_hstu.py lane ------------------------------------------
BATCH = 32
MAX_SEQ = 4000
N_CAND = 16
VOCAB = 100_000
N_USERS = 10_000
N_REQUESTS = 4
N_TRAIN_STEPS = 6
N_FILE_STEPS = 2
SEED = 7

# published dense peaks of one H100 SXM (bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FP32_TOL = 1e-4
BF16_TOL = 2e-2

KERNELS = ["hstu_attention_fwd", "hstu_attention_bwd", "row_write"]
# the attention kernels' times at the slice's shapes before their Hopper
# redesign (WMMA fragments, scores through shared memory), as this script
# read them on an NVIDIA H100 80GB HBM3 at 700 W, for the timing lines
WMMA_FWD_MS, WMMA_BWD_MS = 2.18, 6.76

# --- the DeepFM lane: the config of the repo's train benchmark --------------
# Criteo-Terabyte bucket sizes of the reference config, uncapped
CRITEO_RAW = [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
    40000000, 590152, 12973, 108, 36,
]
CRITEO_CAP = 10_000_000  # for the phases that hold several models
DEEPFM_BATCH = 8192
DEEPFM_DIM = 16
DEEPFM_WARMUP = 5
DEEPFM_STEPS = 30
LAYOUT_TOL = 1e-5
LAYOUT_TOL_3_STEPS = 1e-3

_CONFIG = """
train_input_path: "{train_path}"
eval_input_path: "unused"
model_dir: "{model_dir}"
train_config {{
    sparse_optimizer {{
        rowwise_adagrad_optimizer {{ lr: 0.01 }}
        constant_learning_rate {{}}
    }}
    dense_optimizer {{
        adam_optimizer {{ lr: 0.001 }}
        constant_learning_rate {{}}
    }}
    num_steps: {num_steps}
    mixed_precision: "{mixed_precision}"
}}
data_config {{
    batch_size: {batch}
    dataset_type: ParquetDataset
    fg_mode: FG_NONE
    label_fields: "unused_label"
}}
feature_configs {{
    id_feature {{ feature_name: "user_id" num_buckets: {users}
                  embedding_dim: 256 }}
}}
feature_configs {{
    sequence_id_feature {{ feature_name: "video_id" num_buckets: {vocab}
                           embedding_dim: 256 sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_id_feature {{ feature_name: "item_video_id"
                           num_buckets: {vocab} embedding_dim: 256
                           sequence_length: {n_cand}
                           embedding_name: "video_id_emb" }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "action_weight"
                            sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "action_timestamp"
                            sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "item_query_time"
                            sequence_length: {n_cand} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "item_action_weight"
                            sequence_length: {n_cand} }}
}}
model_config {{
    kernel: {kernel}
    feature_groups {{
        group_name: "contextual"
        feature_names: "user_id"
        group_type: DEEP
    }}
    feature_groups {{
        group_name: "uih"
        feature_names: "video_id"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "candidate"
        feature_names: "item_video_id"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "uih_action"
        feature_names: "action_weight"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "uih_timestamp"
        feature_names: "action_timestamp"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "candidate_timestamp"
        feature_names: "item_query_time"
        group_type: JAGGED_SEQUENCE
    }}
    dlrm_hstu {{
        hstu {{
            stu {{
                embedding_dim: 512
                hidden_dim: 128
                attention_dim: 128
                num_heads: 4
                num_layers: 3
                recompute_uvqk: false
                recompute_y: false
            }}
            input_dropout_ratio: {input_dropout}
            positional_encoder {{
                num_position_buckets: 8192
                num_time_buckets: 2048
                use_time_encoding: true
            }}
            input_preprocessor {{
                contextual_preprocessor {{
                    action_encoder {{
                        simple_action_encoder {{
                            action_embedding_dim: 8
                            action_weights: [1, 2]
                        }}
                    }}
                }}
            }}
            output_postprocessor {{
                layernorm_postprocessor {{}}
            }}
        }}
        fusion_mtl_tower {{
            mlp {{ hidden_units: [512] }}
            task_configs {{
                task_name: "is_click"
                label_name: "item_action_weight"
                task_bitmask: 1
                losses {{ binary_cross_entropy {{}} }}
            }}
            task_configs {{
                task_name: "is_like"
                label_name: "item_action_weight"
                task_bitmask: 2
                losses {{ binary_cross_entropy {{}} }}
            }}
        }}
        max_seq_len: {total_seq}
        item_embedding_hidden_dim: 512
    }}
}}
"""

# the mask family of ops/pallas/hstu_attention.py:_mask_block
MASK_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, max_attn_len=16),
    dict(causal=True, contextual_seq_len=4),
    dict(causal=True, targets=True),
    dict(causal=True, max_attn_len=16, min_full_attn_seq_len=8),
    dict(causal=False, max_attn_len=16, targets=True),
    dict(causal=True, contextual_seq_len=2, targets=True),
    dict(causal=True, sla_k1=8, sla_k2=4),
    dict(causal=True, sla_k1=8, contextual_seq_len=3, targets=True),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def config_text(kernel: str, input_dropout: float = 0.2,
                model_dir: str = "unused", train_path: str = "unused",
                num_steps: int = 1, mixed_precision: str = "BF16") -> str:
    """The lane's config. ``input_dropout`` defaults to the proto's 0.2;
    the training phases set it to 0 (the STU's output dropout and the
    MLP's are 0 in the lane already). An empty ``mixed_precision`` runs
    the dense stack in fp32."""
    return _CONFIG.format(
        batch=BATCH, users=N_USERS, vocab=VOCAB, max_seq=MAX_SEQ,
        n_cand=N_CAND, total_seq=MAX_SEQ + N_CAND * 2, kernel=kernel,
        input_dropout=input_dropout, model_dir=model_dir,
        train_path=train_path, num_steps=num_steps,
        mixed_precision=mixed_precision,
    )


def synth_cols(n: int, seed: int, min_len: int = 512,
               max_len: int = MAX_SEQ - 100):
    """Kuairand-shaped Arrow columns with long histories: the port's own
    copy of benchmark/bench_dlrm_hstu._synth_cols."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    cols = {
        "user_id": pa.array(r.integers(0, N_USERS, n)),
        "unused_label": pa.array(np.zeros(n, np.float32)),
    }
    lens = r.integers(min_len, max_len, n)
    hists, acts, tss = [], [], []
    for lu in lens:
        hists.append(";".join(map(str, r.integers(0, VOCAB, lu))))
        acts.append(";".join(map(str, r.integers(0, 4, lu))))
        tss.append(";".join(map(str, np.sort(r.integers(0, 10**6, lu)))))
    cands, qts, ws = [], [], []
    for _ in range(n):
        lc = int(r.integers(4, N_CAND))
        cands.append(";".join(map(str, r.integers(0, VOCAB, lc))))
        qts.append(";".join(["1000000"] * lc))
        ws.append(";".join(map(str, r.integers(0, 4, lc))))
    cols["video_id"] = pa.array(hists)
    cols["action_weight"] = pa.array(acts)
    cols["action_timestamp"] = pa.array(tss)
    cols["item_video_id"] = pa.array(cands)
    cols["item_query_time"] = pa.array(qts)
    cols["item_action_weight"] = pa.array(ws)
    return cols


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, max |ref|)."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def check(name: str, got, ref, tol: float) -> float:
    err, scale = rel_err(got, ref)
    ok = bool(np.isfinite(err)) and err <= tol * max(scale, 1e-30)
    if not ok:
        raise AssertionError(
            f"{name}: max|kernel - plain| {err} > {tol} * max|plain| {scale}"
        )
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(b, n, h, d, vd, dtype, lengths, targets, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, n, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, n, h, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, n, h, vd, device="cuda", generator=g).to(dtype)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    if targets is not None:
        targets = torch.as_tensor(targets, dtype=torch.int32, device="cuda")
    return q, k, v, lengths, targets


def slice_attention_inputs():
    """q, k, v at the slice's shapes, lengths drawn like the request
    data: 1 contextual token + 512..3899 history + 4..15 candidates."""
    r = np.random.default_rng(SEED)
    lc = r.integers(4, N_CAND, BATCH)
    lengths = 1 + r.integers(512, MAX_SEQ - 100, BATCH) + lc
    n = 1 + MAX_SEQ + N_CAND
    return attn_inputs(BATCH, n, 4, 128, 128, torch.bfloat16, lengths, lc,
                       seed=SEED)


def slice_upstream_grad(v):
    """A seeded upstream gradient of the attention output, at the scale
    the loss sends back (small against the activations)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return (torch.randn(v.shape, device="cuda", generator=g) * 0.01).to(
        v.dtype)


def mask_sweep():
    """(name, tolerance, q, k, v, lengths, targets, mask arguments), in fp32
    then bf16: every mask variant and head-dim pair at B=3, N=300, H=2 with
    ragged lengths; then at the bf16 kernels' 128-row tile edges and the
    fp32 kernels' 64-row ones, lengths 127, 128, 129, 255, 256 and 1000 in
    N=1000; an SLA window shorter than a tile (sla_k1=64, sla_k2=16, with
    targets) at N=1000; 70 samples x 2 heads (more blocks per tile index
    than the card has SMs) and 300 samples (more than the kernels' in-block
    ranking by length takes)."""
    ctx_tg = dict(causal=True, contextual_seq_len=1, targets=True)
    sweep = [(case, 64, 64, 3, 300, 2, None) for case in MASK_CASES] + [
        (ctx_tg, d, vd, 3, 300, 2, None)
        for d, vd in ((32, 32), (128, 128), (32, 128), (128, 64))
    ] + [
        (ctx_tg, 128, 128, 6, 1000, 2, [127, 128, 129, 255, 256, 1000]),
        (dict(causal=True, sla_k1=64, sla_k2=16, targets=True), 128, 128, 3,
         1000, 2, None),
        (ctx_tg, 64, 64, 70, 200, 2, None),
        (dict(causal=True), 32, 32, 300, 130, 1, None),
    ]
    r = np.random.default_rng(1)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for i, (case, d, vd, b, n, h, lens) in enumerate(sweep):
            if lens is None:
                lens = r.integers(1, n + 1, b)
                lens[0] = n
            lens = np.asarray(lens)
            tg = (np.minimum(lens // 4 + 1, lens) if case.get("targets")
                  else None)
            q, k, v, lengths, targets = attn_inputs(b, n, h, d, vd, dtype,
                                                    lens, tg, seed=100 + i)
            m = {key: case.get(key, 0) for key in (
                "max_attn_len", "contextual_seq_len",
                "min_full_attn_seq_len", "sla_k1", "sla_k2")}
            m["causal"] = case.get("causal", True)
            yield (f"{dtype} B={b} N={n} H={h} D={d} V={vd} {case}", tol, q,
                   k, v, lengths, targets, m)


def nan_padded_inputs(dtype):
    """q, k, v, do at B=3, N=1000, H=2, D=V=128 with lengths 1000, 700,
    129 and targets, whose rows at or past the length hold NaN; and the
    same with those rows zero, for the plain version."""
    lens = np.array([1000, 700, 129])
    q, k, v, lengths, targets = attn_inputs(3, 1000, 2, 128, 128, dtype,
                                            lens, lens // 8 + 1, seed=77)
    do = torch.randn(v.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(78)
                     ).to(dtype)
    padded = (torch.arange(1000, device="cuda")[None, :]
              >= lengths[:, None])[:, :, None, None]
    nan = [t.masked_fill(padded, float("nan")) for t in (q, k, v, do)]
    zero = [t.masked_fill(padded, 0.0) for t in (q, k, v, do)]
    return nan, zero, lengths, targets


def check_finite(name: str, *tensors) -> None:
    for t in tensors:
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name}: non-finite values")


def phase_env():
    from torcheasyrec_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    seconds = cuda_build.build(KERNELS)
    build_s = time.perf_counter() - t0
    # registers per thread, static shared memory and spills of every kernel,
    # as ptxas -v reported them (dynamic shared memory is set at launch)
    ptxas = {
        row.pop("kernel"): row
        for name in KERNELS for row in cuda_build.ptxas_usage(name)
    }
    emit({
        "phase": "env", "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_s": seconds, "build_s": build_s, "ptxas": ptxas,
    })
    return smi


def phase_kernel():
    """hstu_attention_fwd against _torch_hstu_mha on the card."""
    from torcheasyrec_tpu_torch.ops import hstu

    alpha = 128 ** -0.5
    scale = MAX_SEQ + 2 * N_CAND
    q, k, v, lengths, targets = slice_attention_inputs()
    kw = dict(causal=True, max_attn_len=0, contextual_seq_len=1,
              min_full_attn_seq_len=0, scaling_seqlen=scale)
    out = hstu.hstu_attention_fwd(q, k, v, lengths, targets, alpha,
                                  kw["causal"], kw["max_attn_len"],
                                  kw["contextual_seq_len"],
                                  kw["min_full_attn_seq_len"], scale)
    torch.cuda.synchronize()
    n_cmp = 8
    ref = hstu._torch_hstu_mha(
        q[:n_cmp], k[:n_cmp], v[:n_cmp], lengths[:n_cmp], alpha,
        kw["causal"], targets[:n_cmp], kw["max_attn_len"],
        kw["contextual_seq_len"], kw["min_full_attn_seq_len"], scale,
    )
    slice_err = check("slice shapes bf16", out[:n_cmp], ref, BF16_TOL)
    emit({"phase": "kernel", "case": "slice", "shape": list(q.shape),
          "dtype": "bf16", "samples_compared": n_cmp,
          "max_abs_err": slice_err, "max_abs_plain": rel_err(ref, ref)[1],
          "tol_rel": BF16_TOL})
    del ref

    worst = {}
    n_cases = 0
    for name, tol, q, k, v, lengths, targets, m in mask_sweep():
        got = hstu.hstu_attention_fwd(
            q, k, v, lengths, targets, 0.1, m["causal"], m["max_attn_len"],
            m["contextual_seq_len"], m["min_full_attn_seq_len"], 500,
            m["sla_k1"], m["sla_k2"])
        ref = hstu._torch_hstu_mha(
            q, k, v, lengths, 0.1, m["causal"], targets, m["max_attn_len"],
            m["contextual_seq_len"], m["min_full_attn_seq_len"], 500,
            m["sla_k1"], m["sla_k2"])
        err = check(name, got, ref, tol)
        worst[str(q.dtype)] = max(worst.get(str(q.dtype), 0.0), err)
        n_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel", "case": "mask sweep", "cases": n_cases // 2,
          "shapes": "B=3 N=300 H=2 over D, V; B=6, 3 N=1000; B=70 N=200; "
                    "B=300 N=130", "max_abs_err": worst,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # padded rows of q, k and v hold NaN: the output must be finite and
    # equal to the plain version's on the same inputs with those rows zero
    nan_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        nan, zero, lengths, targets = nan_padded_inputs(dtype)
        args = (0.1, True, 0, 1, 0, 1000)
        got = hstu.hstu_attention_fwd(*nan[:3], lengths, targets, *args)
        check_finite(f"NaN-padded {dtype}", got)
        ref = hstu._torch_hstu_mha(*zero[:3], lengths, 0.1, True, targets,
                                   0, 1, 0, 1000)
        nan_errs[str(dtype)] = check(f"NaN-padded {dtype}", got, ref, tol)
    emit({"phase": "kernel", "case": "NaN in padded rows of q, k, v",
          "shape": [3, 1000, 2, 128, 128], "lengths": [1000, 700, 129],
          "max_abs_err": nan_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})
    return slice_err


def phase_kernel_bwd():
    """hstu_attention_bwd against _torch_hstu_mha_bwd on the card."""
    from torcheasyrec_tpu_torch.ops import hstu

    alpha = 128 ** -0.5
    scale = MAX_SEQ + 2 * N_CAND
    q, k, v, lengths, targets = slice_attention_inputs()
    do = slice_upstream_grad(v)
    got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, alpha,
                                  True, 0, 1, 0, scale)
    torch.cuda.synchronize()
    n_cmp, chunk = 8, 4  # the plain version holds [B, H, N, N] several times
    slice_errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    plain_max = dict(slice_errs)
    for s in range(0, n_cmp, chunk):
        e = s + chunk
        ref = hstu._torch_hstu_mha_bwd(
            q[s:e], k[s:e], v[s:e], do[s:e], lengths[s:e], alpha, True,
            targets[s:e], 0, 1, 0, scale)
        for name, g, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = check(f"slice shapes bf16 {name}", g[s:e], r_, BF16_TOL)
            slice_errs[name] = max(slice_errs[name], err)
            plain_max[name] = max(plain_max[name], rel_err(r_, r_)[1])
        del ref
    emit({"phase": "kernel_bwd", "case": "slice", "shape": list(q.shape),
          "dtype": "bf16", "samples_compared": n_cmp,
          "max_abs_err": slice_errs, "max_abs_plain": plain_max,
          "tol_rel": BF16_TOL})

    worst = {}
    n_cases = 0
    for name, tol, q, k, v, lengths, targets, m in mask_sweep():
        g = torch.Generator(device="cuda").manual_seed(n_cases)
        do = torch.randn(v.shape, device="cuda", generator=g).to(v.dtype)
        args = (m["causal"], m["max_attn_len"], m["contextual_seq_len"],
                m["min_full_attn_seq_len"], 500, m["sla_k1"], m["sla_k2"])
        got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, 0.1,
                                      *args)
        ref = hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, 0.1,
                                       m["causal"], targets, *args[1:])
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = check(f"{name} {gname}", g_, r_, tol)
            key = f"{q.dtype} {gname}"
            worst[key] = max(worst.get(key, 0.0), err)
        n_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_bwd", "case": "mask sweep", "cases": n_cases // 2,
          "shapes": "B=3 N=300 H=2 over D, V; B=6, 3 N=1000; B=70 N=200; "
                    "B=300 N=130", "max_abs_err": worst,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # padded rows of q, k, v and do hold NaN: finite gradients, equal to
    # the plain version's on the same inputs with those rows zero
    nan_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        nan, zero, lengths, targets = nan_padded_inputs(dtype)
        args = (0.1, True, 0, 1, 0, 1000)
        got = hstu.hstu_attention_bwd(*nan, lengths, targets, *args)
        check_finite(f"NaN-padded {dtype}", *got)
        ref = hstu._torch_hstu_mha_bwd(*zero, lengths, 0.1, True, targets,
                                       0, 1, 0, 1000)
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            nan_errs[f"{dtype} {gname}"] = check(
                f"NaN-padded {dtype} {gname}", g_, r_, tol)
    emit({"phase": "kernel_bwd", "case": "NaN in padded rows of q, k, v, do",
          "shape": [3, 1000, 2, 128, 128], "lengths": [1000, 700, 129],
          "max_abs_err": nan_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # both kernels through the autograd Function against autograd of the
    # plain forward, at a small shape
    fn_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v, lengths, targets = attn_inputs(
            2, 200, 2, 64, 64, dtype, [200, 131], [5, 3], seed=11)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = hstu.hstu_mha(*leaves, lengths, 0.1, num_targets=targets,
                            contextual_seq_len=1, scaling_seqlen=256)
        do = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, do)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = hstu._torch_hstu_mha(*leaves, lengths, 0.1, True, targets,
                                       0, 1, 0, 256)
        ref = torch.autograd.grad(ref_out, leaves, do)
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            fn_errs[f"{dtype} {gname}"] = check(
                f"Function {dtype} {gname}", g_, r_, tol)
    emit({"phase": "kernel_bwd", "case": "autograd Function vs autograd of "
          "the plain forward", "shape": [2, 200, 2, 64, 64],
          "max_abs_err": fn_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})
    return max(slice_errs.values())


def phase_slice():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text("PALLAS"))
    model, features = port_main.build_model(cfg, "cuda", seed=SEED)
    parser = DataParser(features, labels=["unused_label"])
    eval_step = port_main.make_eval_step(model, with_loss=False)
    requests = [synth_cols(BATCH, SEED + i) for i in range(N_REQUESTS + 1)]
    n_tokens = [
        sum(len(s.as_py().split(";")) for s in c["video_id"]) for c in requests
    ]

    def answer(cols):
        batch = parser.parse_to_batch(cols).to("cuda")
        preds, _ = eval_step(batch)
        return {k: v.float().cpu() for k, v in preds.items()}

    answer(requests[0])  # warm-up: cuBLAS handles, allocator
    with tempfile.TemporaryDirectory() as tmp:
        # the batch-predict entry point reads the first two requests back
        # from parquet with the same weights
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(config_text("PALLAS"))
        ckpt = os.path.join(tmp, "model.pt")
        torch.save(model.state_dict(), ckpt)
        inp = os.path.join(tmp, "requests.parquet")
        pq.write_table(pa.concat_tables(
            [pa.table(requests[1]), pa.table(requests[2])]), inp)
        out_path = os.path.join(tmp, "predictions.parquet")
        torch.cuda.synchronize()

        hstu.hstu_attention_fwd.launches = 0
        times, outs = [], []
        for cols in requests[1:]:
            t0 = time.perf_counter()
            outs.append(answer(cols))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n_rows = port_main.predict_checkpoint(
            cfg_path, inp, out_path, checkpoint_path=ckpt, device="cuda")
        launches = hstu.hstu_attention_fwd.launches
        written = pq.read_table(out_path)

    n_layers = len(model.transducer.stack.layers)
    n_batches = N_REQUESTS + 2
    if n_rows != 2 * BATCH or launches != n_layers * n_batches:
        raise AssertionError(
            f"kernel launched {launches} times for {n_batches} batches of "
            f"{n_layers} STU layers ({n_rows} rows through predict_checkpoint)"
        )
    predict_errs = {}
    for key in ("probs_is_click", "probs_is_like"):
        col = torch.from_numpy(
            np.stack(written[key].to_numpy(zero_copy_only=False)))
        ref = torch.cat([outs[0][key], outs[1][key]])
        predict_errs[key] = check(f"predict_checkpoint {key}", col, ref,
                                  BF16_TOL)
    for preds in outs:
        for key in ("probs_is_click", "probs_is_like", "logits_is_click",
                    "logits_is_like"):
            v = preds[key]
            if v.shape != (BATCH, N_CAND) or not torch.isfinite(v).all():
                raise AssertionError(f"{key}: shape {tuple(v.shape)} or "
                                     "non-finite values")
            if key.startswith("probs") and not ((v > 0) & (v < 1)).all():
                raise AssertionError(f"{key} outside (0, 1)")

    # the same weights with the plain attention, on a batch of 8
    plain_model, _ = port_main.build_model(
        parse_pipeline_config(config_text("PYTORCH")), "cuda", seed=SEED)
    plain_model.load_state_dict(model.state_dict())
    small = parser.parse_to_batch(synth_cols(8, SEED + 100)).to("cuda")
    with torch.inference_mode():
        got = model(small)
        ref = plain_model(small)
    errs = {k: check(f"model {k}", got[k], ref[k], BF16_TOL)
            for k in got if k.startswith(("probs_", "logits_"))}
    del plain_model, got, ref
    # the device-side forward alone (parse and copy done beforehand)
    dev_batch = parser.parse_to_batch(requests[1]).to("cuda")
    fwd_ms = cuda_ms(lambda: eval_step(dev_batch), 5)
    emit({"phase": "slice", "requests": N_REQUESTS, "batch": BATCH,
          "n_padded": 1 + MAX_SEQ + N_CAND,
          "history_tokens": n_tokens[1:], "request_ms": times,
          "median_request_ms": float(np.median(times)),
          "forward_ms": fwd_ms, "kernel_launches": launches,
          "predict_checkpoint_rows": n_rows,
          "predict_checkpoint_vs_eval_step_max_abs_err": predict_errs,
          "model_vs_plain_max_abs_err": errs, "tol_rel": BF16_TOL,
          "forward_profile": profile_forward(lambda: eval_step(dev_batch))})
    return launches, float(np.median(times))


def build_trainer(cfg, seed=SEED, **engine_options):
    """(model, features, dense optimizer, state, train step) of the port
    on the card, from the config's optimizers; ``engine_options`` are the
    embedding engine's (``packed``, ``dense_lane_rows``)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.optim.optimizer_builder import (
        create_dense_optimizer,
    )

    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, "cuda", for_train=True, seed=seed, **engine_options)
    tx, dense_sched = create_dense_optimizer(
        cfg.train_config.dense_optimizer,
        [p for p in model.parameters() if p.requires_grad])
    state = port_main._init_state(model)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched)
    return model, features, tx, state, step


def dense_grads(model, batch):
    """Loss and gradients of the dense parameters, by the train step's own
    forward (lookup, assemble, predict, loss) without any update."""
    eg = model.embedding_group
    model.train()
    with torch.no_grad():
        emb_out, _ = eg.lookup(batch)
    preds = model.predict(eg.assemble(emb_out, batch, model.compute_dtype),
                          batch)
    total = model.total_loss(model.loss(preds, batch))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return (float(total.detach()),
            {n: g for n, g in zip(names, grads) if g is not None})


def batch_row_ids(model, batch) -> torch.Tensor:
    """Rows of the model's one fused table that ``batch`` looks up."""
    with torch.no_grad():
        _, residuals = model.embedding_group.lookup(batch)
    (flat_ids, _), = residuals.values()
    return flat_ids[flat_ids >= 0]


def phase_train():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text("PALLAS", input_dropout=0.0))
    model, features, tx, state, train_step = build_trainer(cfg)
    parser = DataParser(features, labels=["unused_label"])
    n_layers = len(model.transducer.stack.layers)
    # three different batches, then the first one again and again: its
    # loss must fall
    cols = [synth_cols(BATCH, SEED + 200 + i) for i in range(3)]
    order = [0, 1, 2] + [0] * (N_TRAIN_STEPS - 3)
    batches = [parser.parse_to_batch(c).to("cuda") for c in cols]
    (gk, table), = model.embedding_group.engine_tables().items()
    table_before = table.clone()
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    for b in batches:
        touched[batch_row_ids(model, b)] = True
    acc_init = float(state["sparse_opt"][gk]["acc"][0, 0])
    torch.cuda.synchronize()

    hstu.hstu_attention_fwd.launches = 0
    hstu.hstu_attention_bwd.launches = 0
    losses, step_ms = [], []
    for i in order:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    step_launches = (hstu.hstu_attention_fwd.launches,
                     hstu.hstu_attention_bwd.launches)

    # the trainer entry point: 2 steps from a parquet file, then a batch
    # predict of the checkpoint it wrote
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "train.parquet")
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[:2]]), inp)
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(config_text(
                "PALLAS", input_dropout=0.0, train_path=inp,
                model_dir=os.path.join(tmp, "model"), num_steps=N_FILE_STEPS))
        result = port_main.train_and_evaluate(cfg_path, device="cuda")
        ckpt = port_main.latest_checkpoint(os.path.join(tmp, "model"))
        out_path = os.path.join(tmp, "predictions.parquet")
        n_rows = port_main.predict_checkpoint(cfg_path, inp, out_path,
                                              device="cuda")
        written = pq.read_table(out_path)
    fwd_launches = hstu.hstu_attention_fwd.launches
    bwd_launches = hstu.hstu_attention_bwd.launches

    n_steps = N_TRAIN_STEPS + N_FILE_STEPS
    n_predict = n_rows // BATCH
    if step_launches != (n_layers * N_TRAIN_STEPS,) * 2:
        raise AssertionError(
            f"(forward, backward) kernels launched {step_launches} times in "
            f"{N_TRAIN_STEPS} steps of {n_layers} STU layers")
    if (bwd_launches != n_layers * n_steps
            or fwd_launches != n_layers * (n_steps + n_predict)):
        raise AssertionError(
            f"kernels launched {fwd_launches} (forward) and {bwd_launches} "
            f"(backward) times for {n_steps} steps and {n_predict} predict "
            f"batches of {n_layers} STU layers")
    if result["step"] != N_FILE_STEPS or not ckpt or n_rows != 2 * BATCH:
        raise AssertionError(
            f"train_and_evaluate: {result}, checkpoint {ckpt}, {n_rows} "
            "rows predicted")
    for key in ("probs_is_click", "probs_is_like"):
        col = np.stack(written[key].to_numpy(zero_copy_only=False))
        if col.shape != (2 * BATCH, N_CAND) or not (
                np.isfinite(col).all() and (col > 0).all() and (col < 1).all()):
            raise AssertionError(f"predict_checkpoint {key}: bad values")
    flat = [v for step in losses for v in step.values()] + [
        v for k, v in result.items() if k != "step"]
    if not np.isfinite(flat).all():
        raise AssertionError(f"non-finite loss: {losses} {result}")
    repeated = [l["total_loss"] for l, i in zip(losses, order) if i == 0]
    if not repeated[-1] < repeated[0]:
        raise AssertionError(f"loss on the repeated batch did not fall: "
                             f"{repeated}")

    same = (table == table_before).all(dim=1)
    acc = state["sparse_opt"][gk]["acc"][:, 0]
    changed_share = float((~same[touched]).float().mean())
    if not same[~touched].all() or not (acc[~touched] == acc_init).all():
        raise AssertionError("rows no batch touched changed, or their "
                             "accumulator did")
    if changed_share < 0.999 or not (acc[touched] > acc_init).all():
        raise AssertionError(
            f"only {changed_share} of the touched rows changed")
    del table_before

    # the whole model's dense gradients on a batch of 8: kernels against
    # plain attention, same weights, fp32 then bf16
    weights = model.state_dict()
    small_cols = synth_cols(8, SEED + 300)
    hstu_counts = (hstu.hstu_attention_fwd.launches,
                   hstu.hstu_attention_bwd.launches)

    def grads_of(kernel: str, mixed_precision: str):
        m, feats, _, _, _ = build_trainer(parse_pipeline_config(config_text(
            kernel, input_dropout=0.0, mixed_precision=mixed_precision)))
        m.load_state_dict(weights)
        small = DataParser(feats, labels=["unused_label"]).parse_to_batch(
            small_cols).to("cuda")
        return dense_grads(m, small)

    loss32_k, g32_k = grads_of("PALLAS", "")
    loss32_p, g32_p = grads_of("PYTORCH", "")
    loss16_k, g16_k = grads_of("PALLAS", "BF16")
    loss16_p, g16_p = grads_of("PYTORCH", "BF16")
    hstu.hstu_attention_fwd.launches, hstu.hstu_attention_bwd.launches = (
        hstu_counts)  # comparisons do not count
    if not set(g32_k) == set(g32_p) == set(g16_k) == set(g16_p):
        raise AssertionError("the models' gradients differ in names")
    fp32_errs = {
        n: check(f"fp32 dense gradient {n}", g32_k[n], g32_p[n], FP32_TOL)
        / max(rel_err(g32_p[n], g32_p[n])[1], 1e-30) for n in g32_p}

    def dist(a, b):  # relative L2 distance from the fp32 gradient b
        return float((a.float() - b).norm() / b.norm().clamp(min=1e-30))

    noise = {n: (dist(g16_k[n], g32_p[n]), dist(g16_p[n], g32_p[n]))
             for n in g32_p}
    for n, (d_kernel, d_plain) in noise.items():
        if not d_kernel <= 3.0 * d_plain + 1e-3:
            raise AssertionError(
                f"bf16 dense gradient {n}: {d_kernel} from the fp32 gradient "
                f"with the kernels, {d_plain} with the plain attention")
    worst32 = max(fp32_errs, key=fp32_errs.get)
    worst16 = max(noise, key=lambda n: noise[n][0] / max(noise[n][1], 1e-30))
    grad_report = {
        "batch": 8, "tensors": len(noise),
        "fp32": {"loss_kernels": loss32_k, "loss_plain": loss32_p,
                 "worst_err_rel_to_max": fp32_errs[worst32],
                 "worst_tensor": worst32, "tol_rel": FP32_TOL},
        "bf16": {"loss_kernels": loss16_k, "loss_plain": loss16_p,
                 "l2_distance_from_fp32_gradient": {
                     "kernels_median": float(np.median(
                         [v[0] for v in noise.values()])),
                     "plain_median": float(np.median(
                         [v[1] for v in noise.values()])),
                     "worst_ratio_tensor": worst16,
                     "worst_ratio": noise[worst16][0]
                     / max(noise[worst16][1], 1e-30)},
                 "kernels_vs_plain_worst_err_rel_to_max": max(
                     rel_err(g16_k[n], g16_p[n])[0]
                     / max(rel_err(g16_p[n], g16_p[n])[1], 1e-30)
                     for n in g16_p),
                 "bound": "kernels <= 3 x plain + 1e-3, per tensor"}}
    del g32_k, g32_p, g16_k, g16_p, weights

    emit({"phase": "train", "steps": N_TRAIN_STEPS, "batch": BATCH,
          "batch_order": order, "losses": losses, "step_ms": step_ms,
          "repeated_batch_total_loss": repeated,
          "kernel_launches": {"forward": fwd_launches,
                              "backward": bwd_launches},
          "train_and_evaluate": result, "predict_checkpoint_rows": n_rows,
          "rows_touched": int(touched.sum()), "rows": int(table.shape[0]),
          "touched_rows_changed_share": changed_share,
          "untouched_rows_bit_equal": True,
          "dense_gradients_vs_plain": grad_report})
    return (fwd_launches, bwd_launches, float(np.median(step_ms[1:])),
            (model, state, train_step, batches))


def phase_timing_train(trainer, step_median_ms):
    from torcheasyrec_tpu_torch.ops import hstu

    model, state, train_step, batches = trainer
    q, k, v, lengths, targets = slice_attention_inputs()
    do = slice_upstream_grad(v)
    alpha, scale = 128 ** -0.5, MAX_SEQ + 2 * N_CAND
    args = (alpha, True, 0, 1, 0, scale)
    kernel_ms = cuda_ms(
        lambda: hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, *args),
        10)

    # the plain version materializes [B, H, N, N] several times over: run
    # it in chunks of 4 samples and sum
    def plain():
        for s in range(0, BATCH, 4):
            e = s + 4
            hstu._torch_hstu_mha_bwd(q[s:e], k[s:e], v[s:e], do[s:e],
                                     lengths[s:e], alpha, True, targets[s:e],
                                     0, 1, 0, scale)
    plain_ms = cuda_ms(plain, 2)
    # work this run's data needs: five products over the unmasked (row,
    # column) pairs; bytes: q, k, v, do read once, dq, dk, dv written once
    pairs = unmasked_pairs(q.shape[1], lengths, targets)
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    flops = 2.0 * pairs * h * (3 * d + 2 * vd)
    nbytes = 2.0 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
    bound_ms, bound_by = card_bound(flops, nbytes)

    def one_step():
        train_step(state, batches[0])
    emit({"phase": "timing_train", "median_step_ms": step_median_ms,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_note": "8 calls of 4 samples", "flops": flops,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_tflops": flops / kernel_ms / 1e9,
          "bound_share": bound_ms / kernel_ms,
          "wmma_kernel_ms": WMMA_BWD_MS,
          "dq": "fp32 atomics into a zeroed buffer, cast afterwards",
          "step_profile": profile_forward(one_step)})
    return kernel_ms, plain_ms, bound_ms, bound_by


def profile_forward(fn) -> dict:
    """Device time of one call by kernel, from torch.profiler's CUDA
    activity; busy share = summed kernel time / host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not by_name:
        return {"device_time": "not measured (no CUDA events traced)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def unmasked_pairs(n, lengths, targets) -> int:
    """Unmasked (row, column) pairs of the slice's mask (causal, one
    contextual token, num_targets) summed over the samples."""
    from torcheasyrec_tpu_torch.ops import hstu

    return sum(
        int(hstu.valid_attn_mask(n, lengths[s:s + 1], True,
                                 targets[s:s + 1], 0, 1).sum())
        for s in range(lengths.shape[0])
    )


def card_bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def phase_timing():
    from torcheasyrec_tpu_torch.ops import hstu

    q, k, v, lengths, targets = slice_attention_inputs()
    alpha, scale = 128 ** -0.5, MAX_SEQ + 2 * N_CAND
    args = (alpha, True, 0, 1, 0, scale)
    kernel_ms = cuda_ms(
        lambda: hstu.hstu_attention_fwd(q, k, v, lengths, targets, *args), 10)
    # the plain version materializes [B, H, N, N] scores: run it in
    # chunks of 8 samples and sum
    def plain():
        for s in range(0, BATCH, 8):
            hstu._torch_hstu_mha(q[s:s + 8], k[s:s + 8], v[s:s + 8],
                                 lengths[s:s + 8], alpha, True,
                                 targets[s:s + 8], 0, 1, 0, scale)
    plain_ms = cuda_ms(plain, 2)
    # work this run's data needs: the two products over the unmasked
    # (row, column) pairs; bytes: q, k, v read once, out written once
    pairs = unmasked_pairs(q.shape[1], lengths, targets)
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    flops = 2.0 * pairs * h * (d + vd)
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + v.numel())
    bound_ms, bound_by = card_bound(flops, nbytes)
    emit({"phase": "timing", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_note": "4 calls of 8 samples", "flops": flops,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_tflops": flops / kernel_ms / 1e9,
          "bound_share": bound_ms / kernel_ms,
          "wmma_kernel_ms": WMMA_FWD_MS})
    return kernel_ms, plain_ms, bound_ms, bound_by


# --- the DeepFM lane: config, data, and the row-write kernel ----------------

def deepfm_config_text(buckets, model_dir: str = "unused",
                       train_path: str = "unused", eval_path: str = "unused",
                       num_steps: int = 0, mixed_precision: str = "BF16"):
    """The Criteo DeepFM config of the repo's train benchmark (the port's
    own copy of bench.py:build_config), with ``buckets`` rows per id
    feature."""
    lines = [
        f'train_input_path: "{train_path}"',
        f'eval_input_path: "{eval_path}"',
        f'model_dir: "{model_dir}"',
        "train_config {",
        "  sparse_optimizer { rowwise_adagrad_optimizer { lr: 0.001 }"
        " constant_learning_rate {} }",
        "  dense_optimizer { adam_optimizer { lr: 0.001 }"
        " constant_learning_rate {} }",
        f"  num_steps: {num_steps}" if num_steps else "  num_epochs: 1",
        f'  mixed_precision: "{mixed_precision}"',
        "}",
        "data_config {",
        f"  batch_size: {DEEPFM_BATCH}",
        "  dataset_type: ParquetDataset",
        "  fg_mode: FG_NONE",
        '  label_fields: "label"',
        "}",
    ]
    for i in range(13):
        lines.append(
            f'feature_configs {{ raw_feature {{ feature_name: "int_{i}" }} }}')
    for i, n in enumerate(buckets):
        lines.append(
            f'feature_configs {{ id_feature {{ feature_name: "cat_{i}" '
            f"num_buckets: {n} embedding_dim: {DEEPFM_DIM} }} }}")
    cat_names = "".join(
        f'    feature_names: "cat_{i}"\n' for i in range(len(buckets)))
    int_names = "".join(f'    feature_names: "int_{i}"\n' for i in range(13))
    lines.append(
        "model_config {\n"
        '  feature_groups {\n    group_name: "wide"\n' + cat_names +
        "    group_type: WIDE\n  }\n"
        '  feature_groups {\n    group_name: "fm"\n' + cat_names +
        "    group_type: DEEP\n  }\n"
        '  feature_groups {\n    group_name: "deep"\n' + cat_names + int_names +
        "    group_type: DEEP\n  }\n"
        "  deepfm {\n"
        "    deep { hidden_units: [512, 256, 128] }\n"
        "    final { hidden_units: [128, 64] }\n"
        "    wide_embedding_dim: 4\n"
        "  }\n"
        "  num_class: 1\n"
        "  losses { binary_cross_entropy {} }\n"
        "  metrics { auc {} }\n"
        "}")
    return "\n".join(lines)


def criteo_cols(buckets, seed: int, n: int = DEEPFM_BATCH):
    """Criteo-shaped Arrow columns (bench.py's synthetic batch): a coin
    label, 13 normal dense features, 26 uniform ids."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    cols = {"label": pa.array((r.random(n) > 0.5).astype(np.float32))}
    for i in range(13):
        cols[f"int_{i}"] = pa.array(r.normal(size=n).astype(np.float32))
    for i, b in enumerate(buckets):
        cols[f"cat_{i}"] = pa.array(r.integers(0, b, n))
    return cols


def slice_row_write_shape():
    """(physical rows of the dim-16 group's packed table, rows one step
    writes) of the DeepFM lane, from the engine's own layout: slot 17,
    7 logical rows per physical row, the 9 tables above the dense lane's
    32768 rows times the batch."""
    from torcheasyrec_tpu_torch.parallel.emb_engine import (
        EmbeddingEngine,
        TableSpec,
    )
    from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

    eng = EmbeddingEngine(
        [TableSpec(f"cat_{i}", n, DEEPFM_DIM) for i, n in enumerate(CRITEO_RAW)],
        [], SparseOptimizer("rowwise_adagrad", {"lr": 0.001}))
    (g,) = eng.groups.values()
    n_big = sum(1 for n in CRITEO_RAW if n > 32768)
    return g.p_rows, n_big * DEEPFM_BATCH


def phase_kernel_row_write():
    """write_rows (the CUDA kernel) against _torch_write_rows on the card,
    bit-equal over the whole table."""
    from torcheasyrec_tpu_torch.ops.row_write import (
        _torch_write_rows,
        write_rows,
    )

    p_rows, k = slice_row_write_shape()
    scratch = p_rows - 1
    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = torch.empty(p_rows, 128, device="cuda").uniform_(generator=g)
    ref = table.clone()
    if (p_rows - 2) * 512 <= 2 ** 32:
        raise AssertionError("the slice's table does not cross 2^32 bytes")

    def rand_rows(n, lanes=128):
        return torch.randn(n, lanes, device="cuda", generator=g)

    def unique_ids(n, hi):
        return torch.randperm(hi, device="cuda", generator=g)[:n]

    def same_row_per_target(ids, lanes=128):
        """Rows that are a function of the target, so that targets that
        repeat carry equal rows and the result does not depend on which
        write wins."""
        base = ids.clamp(min=0).float()[:, None]
        return (base * 1e-3 + torch.arange(lanes, device="cuda")).contiguous()

    # the step's shape: sorted physical rows, the duplicates of a step
    # (later slots of one physical row) sent to the scratch row
    step_ids = torch.sort(torch.randint(
        0, scratch, (k,), device="cuda", generator=g))[0]
    dup = torch.zeros(k, dtype=torch.bool, device="cuda")
    dup[1:] = step_ids[1:] == step_ids[:-1]
    dup |= torch.rand(k, device="cuda", generator=g) < 0.3
    step_ids = torch.where(dup, step_ids.new_full((), scratch), step_ids)
    step_rows = rand_rows(k)
    step_rows[dup] = 0.5  # equal rows on the racing target

    ids_many_dups = unique_ids(5000, scratch)
    ids_many_dups[torch.rand(5000, device="cuda", generator=g) < 0.9] = scratch
    ids_bad = unique_ids(4000, scratch)
    ids_bad[::3] = -1
    ids_bad[1::5] = p_rows
    ids_bad[2::7] = p_rows + 12345
    ids_bad[3::11] = -(2 ** 40)
    cases = {
        "slice": (step_ids, step_rows),
        "unique": (unique_ids(k, scratch), None),
        "duplicates_on_scratch": (ids_many_dups, None),
        "negative_and_too_large": (ids_bad, None),
        "k_1": (torch.tensor([scratch // 2], device="cuda"), None),
        "k_not_a_block_multiple": (unique_ids(1003, scratch), None),
        "last_real_row": (torch.tensor([scratch - 1, 0, scratch, scratch],
                                       device="cuda"), None),
        "int32_ids": (unique_ids(2048, scratch).int(), None),
    }
    launches = write_rows.launches
    checked = []
    for name, (ids, rows) in cases.items():
        rows = same_row_per_target(ids) if rows is None else rows
        write_rows(table, ids, rows)
        _torch_write_rows(ref, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(table, ref):
            raise AssertionError(f"row_write {name}: kernel != plain version")
        checked.append(name)
    last_real = scratch - 1
    if not torch.equal(table[last_real], same_row_per_target(
            torch.tensor([last_real], device="cuda"))[0]):
        raise AssertionError("row_write: the last real row was not written")

    # racing writes of different rows to the scratch row: every other row
    # is as the plain version leaves it, the scratch row's neighbour too
    race_ids = torch.cat([unique_ids(3000, scratch),
                          torch.full((20000,), scratch, device="cuda")])
    race_rows = rand_rows(race_ids.shape[0])
    write_rows(table, race_ids, race_rows)
    _torch_write_rows(ref, race_ids, race_rows)
    torch.cuda.synchronize()
    if not torch.equal(table[:scratch], ref[:scratch]):
        raise AssertionError("row_write: racing scratch writes reached "
                             "another row")
    checked.append("racing_scratch_row")
    ref[scratch] = table[scratch]
    written_err = float((table[step_ids.clamp(max=scratch)]
                         - ref[step_ids.clamp(max=scratch)]).abs().max())

    # small tables: 2 rows, and 256 lanes
    for name, p, lanes, ids in (
            ("two_row_table", 2, 128, torch.tensor([1, 0, 1], device="cuda")),
            ("256_lanes", 300, 256, unique_ids(200, 300))):
        a = torch.randn(p, lanes, device="cuda", generator=g)
        b = a.clone()
        rows = same_row_per_target(ids, lanes)
        write_rows(a, ids, rows)
        _torch_write_rows(b, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"row_write {name}: kernel != plain version")
        checked.append(name)
    n_checked = write_rows.launches - launches
    before = write_rows.launches
    write_rows(table, step_ids[:0], step_rows[:0])
    if write_rows.launches != before:
        raise AssertionError("row_write: K = 0 launched the kernel")

    # times at the step's shape; the rows (38 MB) fit the L2 cache, as
    # they do in the step, where they were just computed
    kernel_ms = cuda_ms(lambda: write_rows(table, step_ids, step_rows), 50)
    plain_ms = cuda_ms(
        lambda: _torch_write_rows(table, step_ids, step_rows), 20)
    library_ms = cuda_ms(
        lambda: table.index_copy_(0, step_ids, step_rows), 50)
    one_id = step_ids[:1].contiguous()
    one_row = step_rows[:1].contiguous()
    bare_launch_ms = cuda_ms(lambda: write_rows(table, one_id, one_row), 200)
    write_rows.launches = launches + n_checked  # timing does not count
    # bytes the function must move: K rows read, K rows written, the ids
    nbytes = 2.0 * k * 128 * 4 + k * step_ids.element_size()
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    emit({"phase": "kernel_row_write", "table": [p_rows, 128],
          "table_gb": p_rows * 512 / 1e9, "rows_written": k,
          "cases_bit_equal": checked, "launches_checked": n_checked,
          "max_abs_err_on_written_rows": written_err,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "library": "Tensor.index_copy_",
          "bare_launch_ms": bare_launch_ms, "bytes": nbytes,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "kernel_gb_per_s": nbytes / kernel_ms / 1e6})
    del table, ref
    torch.cuda.empty_cache()
    return written_err, (kernel_ms, plain_ms, bound_ms, "bytes"), library_ms


# --- DeepFM training ---------------------------------------------------------

def timed_steps(train_step, state, batch, n_warmup, n_steps):
    """(losses of every step, ms of each timed step with a synchronise
    after it, ms per step of a second window of ``n_steps`` that
    synchronises only at its end)."""
    losses, step_ms = [], []
    for i in range(n_warmup + n_steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= n_warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = train_step(state, batch)
    losses.append(float(metrics["total_loss"]))  # waits for the window
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    return losses, step_ms, window_ms


def phase_train_deepfm():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    cfg = parse_pipeline_config(deepfm_config_text(CRITEO_RAW))
    model, features, _, state, train_step = build_trainer(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    eg = model.embedding_group
    groups = {gk: {"dim": g.dim, "slot": g.slot, "rows_per_physical_row": g.spr,
                   "physical_rows": g.p_rows, "dense_lane_rows": g.dense_rows,
                   "gb": g.p_rows * 512 / 1e9}
              for gk, g in eg.engine.groups.items()}
    if not all(g.packed for g in eg.engine.groups.values()):
        raise AssertionError("a DeepFM group did not pack")
    batch = DataParser(features, labels=["label"]).parse_to_batch(
        criteo_cols(CRITEO_RAW, 0)).to("cuda")

    # sampled physical rows, to see after the steps which ones changed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        _, residuals = eg.lookup(batch)
    samples = {}
    for gk, store in eg.engine_tables().items():
        g = eg.engine.groups[gk]
        flat_ids = residuals[gk][0]
        touched = torch.div(flat_ids[flat_ids >= 0], g.spr,
                            rounding_mode="floor")
        # half random rows, half the batch's own rows and their neighbours
        idx = torch.cat([
            torch.randint(0, g.p_rows - 1, (100_000,), device="cuda",
                          generator=gen),
            touched[:50_000], (touched[:50_000] + 1).clamp(max=g.p_rows - 2),
        ])
        is_touched = torch.isin(idx, touched)
        samples[gk] = (idx, is_touched, store[idx].clone())
    torch.cuda.synchronize()

    write_rows.launches = 0
    losses, step_ms, window_ms = timed_steps(
        train_step, state, batch, DEEPFM_WARMUP, DEEPFM_STEPS)
    n_driven = DEEPFM_WARMUP + 2 * DEEPFM_STEPS
    step_launches = write_rows.launches
    if step_launches != 2 * n_driven:
        raise AssertionError(
            f"row_write launched {step_launches} times in {n_driven} steps "
            "of 2 packed groups")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"DeepFM losses on the repeated batch: {losses}")
    sample_report = {}
    for gk, store in eg.engine_tables().items():
        idx, is_touched, before = samples[gk]
        same = (store[idx] == before).all(dim=1)
        if not same[~is_touched].all():
            raise AssertionError(f"{gk}: physical rows the batch did not "
                                 "touch changed")
        changed = float((~same[is_touched]).float().mean())
        if changed < 0.999:
            raise AssertionError(f"{gk}: only {changed} of the touched "
                                 "physical rows changed")
        sample_report[gk] = {
            "sampled": int(idx.shape[0]),
            "untouched_bit_equal": int((~is_touched).sum()),
            "touched_changed": int(is_touched.sum())}
    del samples

    def one_step():
        train_step(state, batch)
    step_profile = profile_forward(one_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, state, train_step, eg
    torch.cuda.empty_cache()

    # the same steps with the dense lane off (every table's ids sorted)
    model_off, _, _, state_off, step_off = build_trainer(
        cfg, dense_lane_rows=0)
    _, off_ms, off_window_ms = timed_steps(
        step_off, state_off, batch, DEEPFM_WARMUP, DEEPFM_STEPS // 2)
    del model_off, state_off, step_off
    torch.cuda.empty_cache()
    main_launches = write_rows.launches  # lane off: 2 a step as well

    # --- capped sizes: several models side by side --------------------------
    capped = [min(n, CRITEO_CAP) for n in CRITEO_RAW]
    cols = [criteo_cols(capped, 10 + i) for i in range(5)]
    cfg32 = parse_pipeline_config(deepfm_config_text(capped,
                                                     mixed_precision=""))
    variants = {
        "packed": build_trainer(cfg32),
        "packed_again": build_trainer(cfg32),
        "unpacked": build_trainer(cfg32, packed=False),
        "dense_lane_off": build_trainer(cfg32, dense_lane_rows=0),
    }
    ref_model = variants["packed"][0]
    weights = ref_model.state_dict()
    for name, (m, _, _, _, _) in variants.items():
        if name != "packed":
            m.load_state_dict(weights)
    del weights
    batches = [DataParser(variants["packed"][1], labels=["label"])
               .parse_to_batch(c).to("cuda") for c in cols[:3]]
    table_names = list(ref_model.embedding_group.engine._specs)

    def per_table(variant):
        m, _, _, st, _ = variants[variant]
        eng = m.embedding_group.engine
        fused = m.embedding_group.engine_tables()
        for name in table_names:
            yield (name, eng.extract_table(fused, name),
                   eng.extract_table_state(fused, st["sparse_opt"], name))

    def layout_err(other):
        """(largest |packed - other| over every table and its row state,
        relative to that tensor's largest magnitude; the share of all
        elements farther apart than LAYOUT_TOL of that magnitude)."""
        worst, beyond, total = 0.0, 0, 0
        for (name, w_a, st_a), (_, w_b, st_b) in zip(per_table("packed"),
                                                     per_table(other)):
            if set(st_a) != set(st_b):
                raise AssertionError(f"{name}: state names differ")
            for a, b in [(w_a, w_b)] + [(st_a[k], st_b[k]) for k in st_a]:
                diff = (a.float() - b.float()).abs()
                scale = max(float(b.float().abs().max()), 1e-30)
                worst = max(worst, float(diff.max()) / scale)
                beyond += int((diff > LAYOUT_TOL * scale).sum())
                total += diff.numel()
        return worst, beyond / total

    # After 1 step the variants differ only by the layouts' rounding and
    # the order of the atomic sums over duplicate ids: 1e-5 holds as it
    # stands. By step 3 even a second run of the same packed engine is
    # farther away than that in a few hundred elements (measured between
    # 8e-6 and 1.2e-4 from run to run): rowwise adagrad's first update of a
    # row is lr * g / (|g| + 1e-10), and a sample whose gradient nearly
    # cancels turns a rounding difference into one of up to lr / 4. So
    # after step 3 the bound is 1e-3 of the table's largest weight (a row
    # updated once too often or not at all is off by lr = 1e-3, about 0.45
    # of that magnitude), and at most 1e-5 of all elements may be farther
    # apart than 1e-5.
    layout_errs = {}
    for i, b in enumerate(batches):
        for m, _, _, st, step in variants.values():
            step(st, b)
        if i not in (0, len(batches) - 1):
            continue
        limit = LAYOUT_TOL if i == 0 else LAYOUT_TOL_3_STEPS
        errs = {}
        for other in variants:
            if other == "packed":
                continue
            err, share = layout_err(other)
            errs[other] = {"max_err": err, "share_beyond_1e-5": share}
            if not (err <= limit and share <= LAYOUT_TOL):
                raise AssertionError(
                    f"packed vs {other} after step {i + 1}: {err} of the "
                    f"table's max (limit {limit}), {share} of the elements "
                    f"beyond {LAYOUT_TOL} (limit {LAYOUT_TOL})")
        layout_errs[f"after_step_{i + 1}"] = errs
    launches_after_compare = write_rows.launches
    del variants, ref_model, batches
    torch.cuda.empty_cache()
    write_rows.launches = main_launches  # comparisons do not count

    # the trainer entry point: 3 steps over distinct batches from a parquet
    # file, an eval pass, the checkpoint; then evaluate() and a restore
    with tempfile.TemporaryDirectory() as tmp:
        train_path = os.path.join(tmp, "train.parquet")
        eval_path = os.path.join(tmp, "eval.parquet")
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[:3]]),
                       train_path)
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[3:]]),
                       eval_path)
        model_dir = os.path.join(tmp, "model")
        text = deepfm_config_text(capped, model_dir=model_dir,
                                  train_path=train_path, eval_path=eval_path,
                                  num_steps=3)
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        result = port_main.train_and_evaluate(cfg_path, device="cuda")
        file_launches = write_rows.launches - main_launches
        train_eval_s = time.perf_counter() - t0
        ckpt = port_main.latest_checkpoint(model_dir)
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        t0 = time.perf_counter()
        again = port_main.evaluate(cfg_path, device="cuda")
        fresh, _, tx, _, _ = build_trainer(
            parse_pipeline_config(text), seed=SEED + 1)
        restored = port_main.restore_checkpoint(ckpt, fresh, tx)
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)
        reload_s = time.perf_counter() - t0
    if file_launches != 2 * 3 or result["step"] != 3:
        raise AssertionError(
            f"train_and_evaluate: {result}, {file_launches} row-write "
            "launches for 3 steps")
    wanted = ("total_loss", "auc", "loss_binary_cross_entropy")
    if not all(np.isfinite(result.get(k, np.nan)) for k in wanted) or not (
            0.0 < result["auc"] < 1.0):
        raise AssertionError(f"train_and_evaluate: {result}")
    if again["auc"] != result["auc"]:
        raise AssertionError(
            f"evaluate() of the checkpoint: auc {again['auc']} against "
            f"{result['auc']} at the end of training")
    feg = fresh.embedding_group
    for name in table_names:
        w = feg.engine.extract_table(feg.engine_tables(), name)
        acc = feg.engine.extract_table_state(
            feg.engine_tables(), restored["sparse_opt"], name)["acc"]
        if not (torch.equal(w, saved["model"][f"embedding_group.tables.{name}"])
                and torch.equal(acc, saved["sparse_opt"][name]["acc"])):
            raise AssertionError(f"{name}: the restored model does not hold "
                                 "the checkpoint's bits")
    if restored["step"] != 3 or tx.count != 3:
        raise AssertionError("the restored step counts are not 3")
    del fresh, saved, restored
    torch.cuda.empty_cache()

    launches = write_rows.launches
    step_median = float(np.median(step_ms))
    emit({"phase": "train_deepfm", "batch": DEEPFM_BATCH,
          "buckets": "uncapped", "total_rows": int(sum(CRITEO_RAW)),
          "groups": groups, "init_s": init_s, "losses_first_last":
          [losses[0], losses[-1]], "steps_driven": n_driven,
          "step_ms_median": step_median,
          "step_ms_range": [min(step_ms), max(step_ms)],
          "window_step_ms": window_ms,
          "examples_per_s": DEEPFM_BATCH / window_ms * 1e3,
          "max_memory_allocated_gb": peak_gb,
          "row_write_launches_per_step": step_launches / n_driven,
          "sampled_physical_rows": sample_report,
          "step_profile": step_profile,
          "dense_lane_off": {"step_ms_median": float(np.median(off_ms)),
                             "step_ms_range": [min(off_ms), max(off_ms)],
                             "window_step_ms": off_window_ms},
          "capped_at": CRITEO_CAP,
          "layout_max_err_rel_to_table_max": layout_errs,
          "layout_tol": {"after_step_1": LAYOUT_TOL,
                         "after_step_3": LAYOUT_TOL_3_STEPS,
                         "share_beyond_1e-5": LAYOUT_TOL},
          "layout_dtype": "fp32",
          "layout_compare_launches_not_counted":
          launches_after_compare - main_launches,
          "train_and_evaluate": result, "train_and_evaluate_s": train_eval_s,
          "checkpoint_gb": ckpt_gb, "evaluate_auc": again["auc"],
          "evaluate_and_restore_s": reload_s,
          "restored_bit_equal_tables": len(table_names),
          "row_write_launches": launches})
    return launches, step_median


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import torcheasyrec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_env()
    fwd_err = phase_kernel()
    bwd_err = phase_kernel_bwd()
    write_err, write_timing, write_library_ms = phase_kernel_row_write()
    serve_launches, _ = phase_slice()
    train_fwd_launches, bwd_launches, step_ms, trainer = phase_train()
    fwd_timing = phase_timing()
    bwd_timing = phase_timing_train(trainer, step_ms)
    del trainer
    torch.cuda.empty_cache()
    write_launches, _ = phase_train_deepfm()

    def kernel_row(name, replaces, launches, err, timing, library_ms=None,
                   **extra):
        kernel_ms, plain_ms, bound_ms, bound_by = timing
        return {
            "name": name, "route": "cuda",
            "source": f"torcheasyrec_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"torcheasyrec_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra,
        }

    emit({"kernels": [
        # no single PyTorch call computes SiLU (softmax-free) attention or
        # its backward: library_ms is null for both
        kernel_row("hstu_attention_fwd", "hstu_attention.py:114",
                   serve_launches + train_fwd_launches, fwd_err, fwd_timing,
                   launches_by_path={"serving": serve_launches,
                                     "training": train_fwd_launches}),
        kernel_row("hstu_attention_bwd", "hstu_attention.py:207",
                   bwd_launches, bwd_err, bwd_timing),
        # Tensor.index_copy_ computes the same function
        kernel_row("row_write", "row_write.py:35", write_launches, write_err,
                   write_timing, write_library_ms),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
