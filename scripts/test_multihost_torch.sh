#!/usr/bin/env bash
# Multi-node distributed evaluation on the PyTorch port (the reference's
# scripts/test_dist.sh / test_slurm.sh): each rank extracts its contiguous
# slice of the gallery, the descriptors are all-gathered and the kNN runs
# sharded over the ranks. One process per GPU, NCCL. Two launch modes:
#
#   Slurm:   PARTITION=<part> NODES=<n> GPUS_PER_NODE=8 \
#              scripts/test_multihost_torch.sh pitts 250k <ckpt>
#   Manual:  on every node, with host 0's address as MASTER_ADDR:
#              NODES=<n> NODE_RANK=<i> MASTER_ADDR=<host0> GPUS_PER_NODE=8 \
#              scripts/test_multihost_torch.sh pitts 250k <ckpt>
set -euo pipefail
cd "$(dirname "$0")/.."

DATASET=${1:-pitts}
SCALE=${2:-250k}
CHECKPOINT=${3:?usage: test_multihost_torch.sh <dataset> <scale> <checkpoint>}
shift 3 || true
NODES=${NODES:-1}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
GPUS=$((NODES * GPUS_PER_NODE))
export MASTER_PORT=${MASTER_PORT:-29500}
ARGS=(-d "$DATASET" --scale "$SCALE" --checkpoint "$CHECKPOINT" \
      --n-devices "$GPUS" "$@")

if [[ -n "${PARTITION:-}" ]]; then
  srun --partition="$PARTITION" \
    --nodes="$NODES" --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
    --gpus-per-task=1 --kill-on-bad-exit=1 \
    python examples/test_model_torch.py "${ARGS[@]}"
else
  exec torchrun --nnodes="$NODES" --node-rank="${NODE_RANK:-0}" \
    --nproc-per-node="$GPUS_PER_NODE" \
    --master-addr="${MASTER_ADDR:-127.0.0.1}" --master-port="$MASTER_PORT" \
    examples/test_model_torch.py "${ARGS[@]}"
fi
