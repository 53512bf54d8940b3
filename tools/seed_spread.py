#!/usr/bin/env python3
"""A pinned config's eval metrics after training, over initial-weight seeds.

    python3 tools/seed_spread.py [--config dssm|hstu_synth]
        [--package port|jax|port_from_jax] [--seeds 42,1,2,3]
        [--repeats N] [--perturb EPS] [--device cpu|cuda] [--data DIR]

Run from the repository root. ``--config`` picks the published config:
``dssm`` (criteo_synth's dssm.config, one epoch; recall@1 and recall@5;
data from ``benchmark/synthetic.ensure_dataset``, default directory
``criteo_synth_data``) or ``hstu_synth`` (hstu_synth's dlrm_hstu.config,
two epochs; auc_is_click and auc_is_like; data from
``ensure_hstu_dataset``, default ``hstu_synth_data``). It writes the data
under ``--data`` and trains the config once per seed through
``train_and_evaluate``, one JSON line per run with the config's pinned
metrics and the device it ran on, then one line with their mean,
standard deviation, minimum and maximum over all runs. ``--repeats``
trains each seed's weights that many times: on the card, whose sums over
duplicate ids are not reproducible bit for bit, the repeats show the
run-to-run spread from the same weights. With ``--perturb``, every repeat
but the first multiplies each initial dense weight by 1 + EPS x N(0, 1)
(tables untouched; noise seeded by the repeat), so the repeats show how
far rounding-sized differences in the start move the metrics.

- ``port``: the port's initial weights of seed ``s``, drawn on the CPU
  (``main.build_model(..., device="cpu", seed=s)``) whatever
  ``--device`` is, so a CPU run and a card run of one seed start from
  the same numbers; trained through ``train_and_evaluate`` from them;
- ``jax``: the JAX package's, its ``_init_state`` seeded with ``s``
  (CPU only; the JAX package's own copy of the config with its data
  paths redirected);
- ``port_from_jax``: the port trained from the JAX package's initial
  weights of seed ``s`` (``utils/convert.py``), so the two packages
  start from the same numbers.

The JAX modes import the JAX package; the port's own code never does.
Model directories go under a temporary directory.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (config under benchmark/configs, its tables, default data dir)
CONFIGS = {
    "dssm": ("criteo_synth/dssm.config",
             ["user_taste_emb", "item_id_emb", "item_cluster_emb"],
             "criteo_synth_data"),
    "hstu_synth": ("hstu_synth/dlrm_hstu.config",
                   ["user_id_emb", "video_id_emb"], "hstu_synth_data"),
}


def config_paths(name):
    """(the port's config, the JAX package's copy)."""
    rel = os.path.join("benchmark", "configs", CONFIGS[name][0])
    return (os.path.join(REPO, "torcheasyrec_tpu_torch", rel),
            os.path.join(REPO, "torcheasyrec_tpu", rel))


def metric_names(name):
    """The config's pinned metrics, from the port's base_eval_metric.json."""
    path = os.path.join(REPO, "torcheasyrec_tpu_torch", "benchmark",
                        "configs", "base_eval_metric.json")
    with open(path) as f:
        labels = json.load(f)
    key = "torcheasyrec_tpu_torch/benchmark/configs/" + CONFIGS[name][0]
    return list(labels[key]["metrics"])


def ensure_data(name, root):
    from torcheasyrec_tpu_torch.benchmark import synthetic

    if name == "dssm":
        return synthetic.ensure_dataset(root)
    return synthetic.ensure_hstu_dataset(root)


def _edits(paths, model_dir):
    edits = {"model_dir": model_dir}
    if "items" in paths:
        edits["data_config.negative_sampler.input_path"] = paths["items"]
    return json.dumps(edits)


def perturbed_checkpoint(init, rep, eps, tmp) -> str:
    """``init``'s state_dict with each dense weight (not a table) times
    1 + eps x N(0, 1), drawn from a generator seeded with 1000 + rep."""
    import torch

    gen = torch.Generator().manual_seed(1000 + rep)
    state = {k: v if k.startswith("embedding_group.") else
             v * (1 + eps * torch.randn(v.shape, generator=gen))
             for k, v in torch.load(init).items()}
    path = os.path.join(tmp, f"perturbed{rep}.pt")
    torch.save(state, path)
    return path


def run_port(config, paths, tag, tmp, device, init):
    from torcheasyrec_tpu_torch import main as port_main

    return port_main.train_and_evaluate(
        config_paths(config)[0], train_input_path=paths["train"],
        eval_input_path=paths["eval"],
        edit_config_json=_edits(paths, os.path.join(tmp, f"port{tag}")),
        fine_tune_checkpoint=init, device=device)


def port_init_checkpoint(config, seed, tmp) -> str:
    """The port's initial weights of ``seed``, drawn on the CPU, as a
    state_dict file."""
    import torch

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    model, _ = port_main.build_model(
        load_pipeline_config(config_paths(config)[0]), device="cpu",
        seed=seed)
    path = os.path.join(tmp, f"port_init{seed}.pt")
    torch.save(model.state_dict(), path)
    return path


def run_jax(config, paths, seed, tag, tmp, rep=0, eps=0.0):
    import jax

    from torcheasyrec_tpu import main as jax_main

    init_state = jax_main._init_state

    def seeded(model, cfg, **kw):
        dense, tables, sparse_opt = init_state(model, cfg, seed=seed)
        if eps and rep:
            leaves, tree = jax.tree_util.tree_flatten(dense)
            keys = jax.random.split(jax.random.key(1000 + rep), len(leaves))
            dense = jax.tree_util.tree_unflatten(tree, [
                w * (1 + eps * jax.random.normal(k, w.shape, w.dtype))
                for w, k in zip(leaves, keys)])
        return dense, tables, sparse_opt

    jax_main.maybe_mesh = lambda: None
    jax_main._init_state = seeded
    try:
        return jax_main.train_and_evaluate(
            config_paths(config)[1], train_input_path=paths["train"],
            eval_input_path=paths["eval"],
            edit_config_json=_edits(paths, os.path.join(tmp, f"jax{tag}")))
    finally:
        jax_main._init_state = init_state


def jax_init_checkpoint(config, seed, tmp) -> str:
    """The JAX package's initial weights of ``seed`` as a port state_dict
    file."""
    import jax
    import torch

    from torcheasyrec_tpu import main as jax_main
    from torcheasyrec_tpu_torch.utils.convert import from_jax_state

    cfg = jax_main.config_util.load_pipeline_config(config_paths(config)[1])
    model, _, _ = jax_main._build_model_and_optim(cfg, None)
    dense, tables, _ = jax_main._init_state(model, cfg, seed=seed)
    eng = model.embedding_group.engine
    canon = {n: np.asarray(eng.extract_table(tables, n))
             for n in CONFIGS[config][1]}
    path = os.path.join(tmp, f"jax_init{seed}.pt")
    torch.save(from_jax_state(jax.device_get(dense), canon), path)
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dssm", choices=sorted(CONFIGS))
    ap.add_argument("--package", default="port",
                    choices=["port", "jax", "port_from_jax"])
    ap.add_argument("--seeds", default="42,1,2,3,4,5,6,7")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--data", default=None)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    if args.package != "port" and args.device != "cpu":
        raise SystemExit("the JAX modes run on the CPU")
    device = args.device
    if device == "cuda":
        import torch

        device_name = torch.cuda.get_device_name(0)
    else:
        device_name = "cpu"
    paths = ensure_data(args.config, args.data or CONFIGS[args.config][2])
    values = {m: [] for m in metric_names(args.config)}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in [int(s) for s in args.seeds.split(",")]:
            init = None
            if args.package == "port":
                init = port_init_checkpoint(args.config, seed, tmp)
            elif args.package == "port_from_jax":
                init = jax_init_checkpoint(args.config, seed, tmp)
            for rep in range(args.repeats):
                tag = f"{seed}_{rep}"
                if args.package == "jax":
                    res = run_jax(args.config, paths, seed, tag, tmp, rep,
                                  args.perturb)
                else:
                    start = (perturbed_checkpoint(init, rep, args.perturb, tmp)
                             if args.perturb and rep else init)
                    res = run_port(args.config, paths, tag, tmp, device,
                                   start)
                for m in values:
                    values[m].append(float(res[m]))
                print(json.dumps({"config": args.config,
                                  "package": args.package, "seed": seed,
                                  "repeat": rep, "device": device_name,
                                  **{m: float(res[m]) for m in values}}),
                      flush=True)
    summary = {"config": args.config, "package": args.package,
               "device": device_name, "seeds": args.seeds,
               "repeats": args.repeats, "perturb": args.perturb}
    for m, v in values.items():
        v = np.asarray(v)
        summary[m] = {"mean": float(v.mean()),
                      "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
                      "min": float(v.min()), "max": float(v.max())}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
