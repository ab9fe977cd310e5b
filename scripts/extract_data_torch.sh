#!/usr/bin/env bash
# TFDS -> mp4 + annotations (reference extract_data_tfds.sh).
# The PyTorch port's extract_data.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
python -m orv_tpu_torch.pipelines.data_process "$@"
