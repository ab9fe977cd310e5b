#!/usr/bin/env bash
# The PyTorch port's encode_dataset.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
python -m orv_tpu_torch.pipelines.encode_dataset --dataset_type "$DATASET_TYPE" "$@"
