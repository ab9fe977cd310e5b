#!/usr/bin/env bash
# CogVideoX1.5-5b-I2V finetune (reference train_control_traj-image_finetune_5b.sh)
# The PyTorch port's train_control_traj-image_finetune_5b.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
EXTRA=("$@"); if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train --experiment traj_image_5b_finetune \
  --dataset_type "$DATASET_TYPE" "${EXTRA[@]}"
