#!/usr/bin/env bash
# Stage 3: multiview (only mv_blocks train).
# The PyTorch port's train_control_traj-image_multiview.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2_2}
python -m orv_tpu_torch.pipelines.train \
  --experiment traj_image_2b_multiview \
  --dataset_type "$DATASET_TYPE" "$@"
