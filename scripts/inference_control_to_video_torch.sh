#!/usr/bin/env bash
# Demo inference entry (reference inference_control_to_video.sh)
# The PyTorch port's inference_control_to_video.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
python -m orv_tpu_torch.pipelines.inference "$@"
