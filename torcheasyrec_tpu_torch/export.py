"""Export CLI: the serving artifact of a trained model.

    python -m torcheasyrec_tpu_torch.export \
        --pipeline_config_path cfg.config --export_dir export/ \
        [--checkpoint_path model.ckpt-100.pt] [--device cpu]

``QUANT_EMB=INT8`` (INT4, INT2, FP16) in the environment quantizes the
tables; ``main.export`` says what the artifact holds.
"""

import argparse

from torcheasyrec_tpu_torch.main import export

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_config_path", type=str, required=True)
    parser.add_argument("--export_dir", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    export(args.pipeline_config_path, export_dir=args.export_dir,
           checkpoint_path=args.checkpoint_path, device=args.device)
