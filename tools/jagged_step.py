#!/usr/bin/env python3
"""The resident train step of the Criteo DeepFM with jagged lookups.

    python3 tools/jagged_step.py [--root DIR] [--steps N] [--warmup N]
        [--batch B] [--cap ROWS] [--max-values K] [--device cuda|cpu]

Times ``chip_smoke.py``'s Criteo DeepFM (26 x 16 plus WIDE x 4, 13 dense,
BF16, tables capped at ``--cap`` rows) on one resident batch whose 26
categorical columns are multi-valued: each cell holds 0 to ``--max-values``
ids (uniform), so every id feature is jagged and its sum pooling runs the
embedding engine's jagged path. (A column of at most one id per row
parses to a fixed [B, 1] field, missing ids -1, and never takes that
path.) The columns are encoded (FG_NONE), so any checkout of the port
since its data layer can be timed.

``--root`` names the checkout whose ``torcheasyrec_tpu_torch`` and
``chip_smoke.py`` are imported (default: this script's), so that one
call on one card can time two commits: unpack the other one with
``git archive`` into a directory that ``.gitignore`` lists and run
parent, change, change, parent. Prints one JSON line: the package's
path, the card's name and power limit, the jagged features counted,
each timed step's ms (a synchronise after each) and the ms per step of
a second window that synchronises only at its end.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--cap", type=int, default=10_000_000)
    ap.add_argument("--max-values", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import pyarrow as pa
    import torch

    import chip_smoke
    import torcheasyrec_tpu_torch
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    if args.device == "cuda" and not torch.cuda.is_available():
        print("jagged_step: CUDA is not available", file=sys.stderr)
        return 1
    chip_smoke.DEEPFM_BATCH = args.batch
    capped = [min(n, args.cap) for n in chip_smoke.CRITEO_RAW]
    cfg = parse_pipeline_config(chip_smoke.deepfm_config_text(capped))
    features = port_main._create_features(cfg)

    r = np.random.default_rng(7)
    n = args.batch
    cols = {"label": pa.array((r.random(n) > 0.5).astype(np.float32))}
    for i in range(13):
        cols[f"int_{i}"] = pa.array(r.normal(size=n).astype(np.float32))
    for i, b in enumerate(capped):
        lengths = r.integers(0, args.max_values + 1, n)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        cols[f"cat_{i}"] = pa.ListArray.from_arrays(
            offsets, pa.array(r.integers(0, b, int(offsets[-1]))))
    batch = DataParser(features, labels=["label"]).parse_to_batch(cols)
    jagged = sum(not f.is_fixed for f in batch.sparse_features.values())
    if jagged != len(capped):
        raise AssertionError(f"{jagged} of {len(capped)} id features jagged")
    batch = batch.to(args.device)

    _, _, _, state, step = chip_smoke.build_trainer(cfg, device=args.device)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    losses, step_ms = [], []
    for i in range(args.warmup + args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        if i >= args.warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    losses.append(float(metrics["total_loss"]))
    sync()
    window_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")

    smi = None
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "package": os.path.dirname(torcheasyrec_tpu_torch.__file__),
        "nvidia_smi": smi, "device": args.device, "batch": n,
        "capped_at": args.cap, "max_values": args.max_values,
        "jagged_features": jagged,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms": step_ms, "window_step_ms": window_ms,
        "last_loss": losses[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
