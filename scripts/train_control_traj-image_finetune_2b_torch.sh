#!/usr/bin/env bash
# Stage 1: action-to-video finetune of CogVideoX-2b (reference
# scripts/train_control_traj-image_finetune_2b.sh equivalent).
# DEBUG=1 runs the tiny debug overlay (reference debug-launch block).
# The PyTorch port's train_control_traj-image_finetune_2b.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
EXTRA=("$@")
if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train \
  --experiment traj_image_2b_finetune \
  --dataset_type "$DATASET_TYPE" \
  "${EXTRA[@]}"
