#!/usr/bin/env bash
# Checkpoint evaluation on the PyTorch port (the reference's
# scripts/test_dist.sh) over the GPUs of one host: each rank extracts its
# slice of the gallery and the kNN runs sharded (torchrun, NCCL).
#   GPUS=8 scripts/test_torch.sh <checkpoint> [dataset] [scale] [extra flags]
set -euo pipefail
cd "$(dirname "$0")/.."

CKPT=${1:?usage: test_torch.sh <checkpoint> [dataset] [scale]}
DATASET=${2:-pitts}
SCALE=${3:-250k}
shift $(( $# > 3 ? 3 : $# ))
GPUS=${GPUS:-$(nvidia-smi -L | wc -l)}

torchrun --nproc-per-node="$GPUS" examples/test_model_torch.py \
  -d "$DATASET" --scale "$SCALE" --checkpoint "$CKPT" \
  --n-devices "$GPUS" "$@"
