#!/usr/bin/env bash
# Long-horizon cascaded rollout (reference eval_control_to_video_cascaded_long.sh).
# The PyTorch port's eval_control_to_video_cascaded_long.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
python -m orv_tpu_torch.pipelines.evaluate --dataset_type "$DATASET_TYPE" \
  evaluation.cascaded=true evaluation.batch_size=1 "$@"
