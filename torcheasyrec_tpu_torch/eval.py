"""CLI: ``python -m torcheasyrec_tpu_torch.eval --pipeline_config_path
<cfg> [--checkpoint_path model.ckpt-N.pt] [--eval_input_path data/]
[--device cpu]``. Evaluates the checkpoint (default: the latest of the
config's ``model_dir``) on parquet files, directories or globs, in
batches of ``eval_batch_size``, and prints the metrics as one JSON
line. Under
``python -m torch.distributed.run --nproc_per_node N`` each rank
evaluates its shard of the input, the metrics are gathered and rank 0
writes the result."""

import argparse
import json

from torcheasyrec_tpu_torch.main import evaluate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline_config_path", required=True)
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--eval_input_path", default=None)
    ap.add_argument("--eval_result_filename", default="eval_result.txt")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(evaluate(
        a.pipeline_config_path, a.checkpoint_path, a.eval_input_path,
        a.eval_result_filename, device=a.device)))


if __name__ == "__main__":
    main()
