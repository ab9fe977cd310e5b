#!/usr/bin/env bash
# Multi-ref 1.4B scratch (reference train_control_traj-image_ref1-5-9_scratch.sh)
# The PyTorch port's train_control_traj-image_ref1-5-9_scratch.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
EXTRA=("$@"); if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train --experiment traj_image_1.4b_ref1-5-9_scratch \
  --dataset_type "$DATASET_TYPE" "${EXTRA[@]}"
