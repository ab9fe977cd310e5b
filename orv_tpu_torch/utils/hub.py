"""Hugging Face Hub checkpoint upload/download helper.

Counterpart of `orv_tpu/utils/hub.py` (reference scripts/hf_model.py), with
its signatures and calls: the port's checkpoints are diffusers folders
(`checkpoint/`, `checkpoint_ema/`) and `TrainCheckpointer` step folders,
uploaded and downloaded as files. huggingface_hub is optional and imported
inside each call; without it each call raises RuntimeError, and a machine
without network gets the library's own error.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from orv_tpu_torch.utils.logging import CONSOLE


def _api():
    try:
        from huggingface_hub import HfApi

        return HfApi()
    except ImportError as e:
        raise RuntimeError("huggingface_hub not installed") from e


def upload_folder(local_dir: str, repo_id: str, path_in_repo: str = "",
                  token: Optional[str] = None, private: bool = True):
    api = _api()
    api.create_repo(repo_id, exist_ok=True, private=private, token=token)
    api.upload_folder(folder_path=local_dir, repo_id=repo_id,
                      path_in_repo=path_in_repo, token=token)
    CONSOLE.log(f"uploaded {local_dir} -> {repo_id}/{path_in_repo}")


def upload_file(file_path: str, repo_id: str, token: Optional[str] = None,
                private: bool = True):
    """Single-file upload: lands at the repo root under its basename."""
    api = _api()
    api.create_repo(repo_id, exist_ok=True, private=private, token=token)
    api.upload_file(path_or_fileobj=file_path,
                    path_in_repo=Path(file_path).name,
                    repo_id=repo_id, repo_type="model", token=token)
    CONSOLE.log(f"uploaded {file_path} -> {repo_id}")


def download_file(repo_id: str, filename: str, save_path: Optional[str] = None,
                  token: Optional[str] = None) -> str:
    """Single-file download; with `save_path`, the cached file is copied to
    `save_path/filename` and that path returned."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub not installed") from e
    path = hf_hub_download(repo_id=repo_id, filename=filename, token=token)
    if save_path:
        import shutil

        dest = Path(save_path) / filename
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dest)
        path = str(dest)
    CONSOLE.log(f"downloaded {repo_id}/{filename} -> {path}")
    return path


def download_folder(repo_id: str, local_dir: str, allow_patterns=None,
                    token: Optional[str] = None) -> str:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub not installed") from e
    path = snapshot_download(repo_id, local_dir=local_dir,
                             allow_patterns=allow_patterns, token=token)
    CONSOLE.log(f"downloaded {repo_id} -> {path}")
    return path
