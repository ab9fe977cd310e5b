#!/usr/bin/env bash
# Scratch 1.4B with RoPE.
# The PyTorch port's train_control_traj-image_scratch.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
python -m orv_tpu_torch.pipelines.train \
  --experiment traj_image_1.4b_scratch \
  --dataset_type "$DATASET_TYPE" "$@"
