"""Predict CLI: batch inference over parquet input, from an export
artifact or from a pipeline config and its checkpoint.

    python -m torcheasyrec_tpu_torch.predict \
        --scripted_model_path export/ --predict_input_path data/ \
        --predict_output_path out.parquet [--reserved_columns request_id]

    python -m torcheasyrec_tpu_torch.predict \
        --pipeline_config_path cfg.config --predict_input_path data/ \
        --predict_output_path out.parquet [--checkpoint_path model.pt]

With ``--scripted_model_path`` (the directory ``export`` wrote) it calls
``main.predict``, else ``main.predict_checkpoint``. The input is parquet
files, directories or globs; the reserved columns are copied from it
beside the predictions.
"""

import argparse

from torcheasyrec_tpu_torch.main import predict, predict_checkpoint

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--scripted_model_path", type=str, default=None)
    parser.add_argument("--pipeline_config_path", type=str, default=None)
    parser.add_argument("--predict_input_path", type=str, required=True)
    parser.add_argument("--predict_output_path", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--reserved_columns", type=str, default=None)
    parser.add_argument("--output_columns", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    common = dict(reserved_columns=args.reserved_columns,
                  output_columns=args.output_columns,
                  batch_size=args.batch_size, device=args.device)
    if args.scripted_model_path:
        n = predict(args.predict_input_path, args.predict_output_path,
                    args.scripted_model_path, **common)
    elif args.pipeline_config_path:
        n = predict_checkpoint(
            args.pipeline_config_path, args.predict_input_path,
            args.predict_output_path, checkpoint_path=args.checkpoint_path,
            **common)
    else:
        parser.error("pass --scripted_model_path or --pipeline_config_path")
    print(f"predicted {n} rows -> {args.predict_output_path}")
