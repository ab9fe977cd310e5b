#!/usr/bin/env bash
# Condition-from-scratch 1.4B recipe (reference train_control_traj-image-cond_scratch.sh)
# The PyTorch port's train_control_traj-image-cond_scratch.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
EXTRA=("$@"); if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train --experiment traj_image_depth_1.4b_finetune \
  --dataset_type "$DATASET_TYPE" "${EXTRA[@]}"
