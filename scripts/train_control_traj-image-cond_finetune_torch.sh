#!/usr/bin/env bash
# Stage 2: occupancy (depth+label) conditioned finetune.
# The PyTorch port's train_control_traj-image-cond_finetune.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
python -m orv_tpu_torch.pipelines.train \
  --experiment traj_image_condfull_2b_finetune \
  --dataset_type "$DATASET_TYPE" "$@"
