"""Train CLI: train and evaluate a model from a pipeline config.

    python -m torcheasyrec_tpu_torch.train_eval \
        --pipeline_config_path cfg.config [--train_input_path data/] \
        [--eval_input_path 'eval/part-*.parquet'] [--continue_train] \
        [--fine_tune_checkpoint model.pt] \
        [--edit_config_json '{"train_config.num_steps": 100}'] [--device cpu]

Input paths are parquet files, directories (every ``*.parquet`` below
them), globs, or comma-separated lists of these; they default to the
config's. ``--continue_train`` resumes from the latest checkpoint of the
config's ``model_dir``, mid-epoch where it was taken.
"""

import argparse
import logging

from torcheasyrec_tpu_torch.main import train_and_evaluate

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", type=str, required=True)
    parser.add_argument("--train_input_path", type=str, default=None)
    parser.add_argument("--eval_input_path", type=str, default=None)
    parser.add_argument("--continue_train", action="store_true")
    parser.add_argument("--fine_tune_checkpoint", type=str, default=None)
    parser.add_argument("--edit_config_json", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    result = train_and_evaluate(
        args.pipeline_config_path,
        train_input_path=args.train_input_path,
        eval_input_path=args.eval_input_path,
        continue_train=args.continue_train,
        fine_tune_checkpoint=args.fine_tune_checkpoint,
        edit_config_json=args.edit_config_json,
        device=args.device,
    )
    print(result)
