#!/usr/bin/env bash
# Bridge-2 480x640 finetune (reference train_control_traj-image_bridge2_480-640_finetune_2b.sh)
# The PyTorch port's train_control_traj-image_bridge2_480-640_finetune_2b.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
EXTRA=("$@"); if [[ "${DEBUG:-0}" == "1" ]]; then EXTRA+=(--debug); fi
python -m orv_tpu_torch.pipelines.train --experiment traj_image_bridge2_480-640_2b_finetune \
  --dataset_type bridgev2 "${EXTRA[@]}"
