"""Predict CLI: batch inference from a pipeline config over parquet input.

    python -m torcheasyrec_tpu_torch.predict \
        --pipeline_config_path cfg.config --predict_input_path data/ \
        --predict_output_path out.parquet [--checkpoint_path model.pt] \
        [--reserved_columns request_id]

The input is parquet files, directories or globs; the reserved columns
are copied from it beside the predictions.
"""

import argparse

from torcheasyrec_tpu_torch.main import predict_checkpoint

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", type=str, required=True)
    parser.add_argument("--predict_input_path", type=str, required=True)
    parser.add_argument("--predict_output_path", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--reserved_columns", type=str, default=None)
    parser.add_argument("--output_columns", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    n = predict_checkpoint(
        args.pipeline_config_path,
        args.predict_input_path,
        args.predict_output_path,
        checkpoint_path=args.checkpoint_path,
        reserved_columns=args.reserved_columns,
        output_columns=args.output_columns,
        batch_size=args.batch_size,
        device=args.device,
    )
    print(f"predicted {n} rows -> {args.predict_output_path}")
