"""Train CLI: train a model from a pipeline config over parquet input.

    python -m torcheasyrec_tpu_torch.train_eval \
        --pipeline_config_path cfg.config [--train_input_path in.parquet] \
        [--device cpu]
"""

import argparse

from torcheasyrec_tpu_torch.main import train_and_evaluate

if __name__ == "__main__":
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
