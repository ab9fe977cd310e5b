"""Hugging Face Hub checkpoint upload/download CLI for the PyTorch port.

The argument surface and messages of scripts/hf_model.py; delegates to
orv_tpu_torch.utils.hub, which raises a clear error where huggingface_hub
is not installed.

    python scripts/hf_model_torch.py --repo_id user/repo --upload --folder_path outputs/run/checkpoint
    python scripts/hf_model_torch.py --repo_id user/repo --download --file_path checkpoint/diffusion_pytorch_model.safetensors --save_path ckpts/
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo_id", type=str, required=True)
    parser.add_argument("--upload", action="store_true")
    parser.add_argument("--download", action="store_true")
    parser.add_argument("--folder_path", type=str, default=None)
    parser.add_argument("--file_path", type=str, default=None)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--token", type=str, default=None)
    parser.add_argument("--path_in_repo", type=str, default=None)
    args = parser.parse_args(argv)

    from orv_tpu_torch.utils import hub

    token = args.token or os.getenv("HF_TOKEN") or os.getenv("hf_token")
    if not (args.folder_path or args.file_path):
        raise SystemExit("choose either --folder_path or --file_path")
    if len(args.repo_id.split("/")) != 2:
        raise SystemExit(f"invalid repo_id {args.repo_id!r}: use user/repo")

    if args.upload:
        if args.folder_path:
            hub.upload_folder(args.folder_path, args.repo_id,
                              path_in_repo=args.path_in_repo or "", token=token)
        if args.file_path:
            hub.upload_file(args.file_path, args.repo_id, token=token)
    if args.download:
        if args.file_path:
            hub.download_file(args.repo_id, args.file_path,
                              save_path=args.save_path, token=token)
        elif args.folder_path:
            hub.download_folder(args.repo_id, args.folder_path, token=token)


if __name__ == "__main__":
    main()
