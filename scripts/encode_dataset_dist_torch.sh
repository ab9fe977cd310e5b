#!/usr/bin/env bash
# Multi-process offline encoding (reference encode_dataset_dist.sh) with the
# PyTorch port: torchrun starts NPROC_PER_NODE processes (default 1), and
# each encodes its share of the slices, split by its torch.distributed rank.
set -euo pipefail
DATASET_TYPE=${DATASET_TYPE:-bridgev2}
torchrun --nproc_per_node "${NPROC_PER_NODE:-1}" -m orv_tpu_torch.pipelines.encode_dataset --dataset_type "$DATASET_TYPE" "$@"
