#!/usr/bin/env bash
# Distributed evaluation (reference eval_control_to_video_dist.sh) with the
# PyTorch port: torchrun starts NPROC_PER_NODE processes (default 1), and
# the eval entry shards its work list by their torch.distributed rank.
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
torchrun --nproc_per_node "${NPROC_PER_NODE:-1}" -m orv_tpu_torch.pipelines.evaluate --dataset_type "$DATASET_TYPE" "$@"
