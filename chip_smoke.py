#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's DLRM-HSTU serving path (torcheasyrec_tpu_torch) at the
full width of the repo's DLRM-HSTU lane (benchmark/bench_dlrm_hstu.py:
batch 32, STU 512/128/128, 4 heads, 3 layers, histories up to 4000 tokens
and 16 candidates, max_seq_len 4032, BF16) with seeded random weights.
Phases, one JSON line each:

1. env: the card, CUDA and torch versions; every CUDA kernel of the path
   is built from the sources here (one nvcc per source, in parallel).
2. kernel: each kernel against its plain PyTorch version on the card, at
   the slice's shapes and over a sweep of every mask variant, fp32 and
   bf16. Tolerance: max|kernel - plain| <= 1e-4 * max|plain| in fp32 (TF32
   off), <= 2e-2 * max|plain| in bf16 (bf16 keeps ~3 significant digits
   and the sums run in another order).
3. slice: 4 requests of 32 through the port's eval step, then 2 of them
   again through ``predict_checkpoint`` (parquet in, parquet out), with
   the kernel launch counts set to 0 just before and read just after;
   outputs must be finite with probabilities in (0, 1), the two entry
   points must agree, and the whole model with the kernel must match the
   whole model with the plain attention on a batch of 8 at the bf16
   tolerance.
4. timing: median request time, and the kernel's time beside the plain
   version's and the card's bound at the slice's shapes.

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
SEED = 7

# published dense peaks of one H100 SXM (bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FP32_TOL = 1e-4
BF16_TOL = 2e-2

KERNELS = ["hstu_attention_fwd"]

_CONFIG = """
train_input_path: "unused"
eval_input_path: "unused"
model_dir: "unused"
train_config {{ mixed_precision: "BF16" }}
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
            }}
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
            }}
            task_configs {{
                task_name: "is_like"
                label_name: "item_action_weight"
                task_bitmask: 2
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


def config_text(kernel: str) -> str:
    return _CONFIG.format(
        batch=BATCH, users=N_USERS, vocab=VOCAB, max_seq=MAX_SEQ,
        n_cand=N_CAND, total_seq=MAX_SEQ + N_CAND * 2, kernel=kernel,
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


def phase_env():
    from torcheasyrec_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    seconds = cuda_build.build(KERNELS)
    emit({
        "phase": "env", "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_s": seconds, "build_s": time.perf_counter() - t0,
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

    sweep = [(case, 64, 64) for case in MASK_CASES] + [
        (dict(causal=True, contextual_seq_len=1, targets=True), d, vd)
        for d, vd in ((32, 32), (128, 128), (32, 128), (128, 64))
    ]
    worst = {}
    r = np.random.default_rng(1)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for i, (case, d, vd) in enumerate(sweep):
            case = dict(case)
            b, n = 3, 300
            lens = r.integers(1, n + 1, b)
            lens[0] = n
            tg = np.minimum(lens // 4 + 1, lens) if case.pop("targets", False) else None
            q, k, v, lengths, targets = attn_inputs(b, n, 2, d, vd, dtype,
                                                    lens, tg, seed=100 + i)
            args = dict(causal=case.get("causal", True),
                        max_attn_len=case.get("max_attn_len", 0),
                        contextual_seq_len=case.get("contextual_seq_len", 0),
                        min_full_attn_seq_len=case.get(
                            "min_full_attn_seq_len", 0),
                        sla_k1=case.get("sla_k1", 0),
                        sla_k2=case.get("sla_k2", 0))
            got = hstu.hstu_attention_fwd(
                q, k, v, lengths, targets, 0.1, args["causal"],
                args["max_attn_len"], args["contextual_seq_len"],
                args["min_full_attn_seq_len"], 500, args["sla_k1"],
                args["sla_k2"])
            ref = hstu._torch_hstu_mha(
                q, k, v, lengths, 0.1, args["causal"], targets,
                args["max_attn_len"], args["contextual_seq_len"],
                args["min_full_attn_seq_len"], 500, args["sla_k1"],
                args["sla_k2"])
            name = f"{dtype} D={d} V={vd} {case}"
            err = check(name, got, ref, tol)
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    torch.cuda.synchronize()
    emit({"phase": "kernel", "case": "mask sweep", "cases": len(sweep),
          "shape": [3, 300, 2, "D", "V"], "max_abs_err": worst,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})
    return slice_err


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
    eval_step = port_main.make_eval_step(model)
    requests = [synth_cols(BATCH, SEED + i) for i in range(N_REQUESTS + 1)]
    n_tokens = [
        sum(len(s.as_py().split(";")) for s in c["video_id"]) for c in requests
    ]

    def answer(cols):
        batch = parser.parse_to_batch(cols).to("cuda")
        preds = eval_step(batch)
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
    pairs = sum(
        int(hstu.valid_attn_mask(q.shape[1], lengths[s:s + 1], True,
                                 targets[s:s + 1], 0, 1).sum())
        for s in range(BATCH)
    )
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    flops = 2.0 * pairs * h * (d + vd)
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + v.numel())
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES else "bytes"
    emit({"phase": "timing", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_note": "4 calls of 8 samples", "flops": flops,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_tflops": flops / kernel_ms / 1e9})
    return kernel_ms, plain_ms, bound_ms, bound_by


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
    max_err = phase_kernel()
    launches, _ = phase_slice()
    kernel_ms, plain_ms, bound_ms, bound_by = phase_timing()
    emit({"kernels": [{
        "name": "hstu_attention_fwd",
        "route": "cuda",
        "source": "torcheasyrec_tpu_torch/ops/csrc/hstu_attention_fwd.cu",
        "replaces": "torcheasyrec_tpu/ops/pallas/hstu_attention.py:114",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes SiLU (softmax-free) attention
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
