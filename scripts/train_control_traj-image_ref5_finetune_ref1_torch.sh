#!/usr/bin/env bash
# Single-ref finetune of the multi-ref model (reference train_control_traj-image_ref5_finetune_ref1.sh)
# The PyTorch port's train_control_traj-image_ref5_finetune_ref1.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
EXTRA=("$@"); if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train --experiment traj_image_1.4b_ref5_finetune_ref1 \
  --dataset_type "$DATASET_TYPE" "${EXTRA[@]}"
