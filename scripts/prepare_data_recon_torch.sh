#!/usr/bin/env bash
# Occupancy reconstruction stage (reference prepare_data_recon.sh)
# The PyTorch port's prepare_data_recon.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
DATA_ROOT=${DATA_ROOT:-./data/bridge/renderings}
python -m orv_tpu_torch.pipelines.prepare_dataset --action reconstruction \
  --data_root "$DATA_ROOT" "$@"
