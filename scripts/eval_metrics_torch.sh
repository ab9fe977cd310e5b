#!/usr/bin/env bash
# The PyTorch port's eval_metrics.sh (orv_tpu_torch, on the CUDA card).
set -euo pipefail
python -m orv_tpu_torch.pipelines.metrics "$@"
