#!/usr/bin/env bash
# Multi-node SFRS training on the PyTorch port under Slurm (the
# reference's scripts/train_sfrs_slurm.sh:29-40): one task per GPU, NCCL.
#   PARTITION=<part> NODES=<n> GPUS_PER_NODE=8 \
#     scripts/train_sfrs_slurm_torch.sh [pitts] [30k]
set -euo pipefail
cd "$(dirname "$0")/.."

PARTITION=${PARTITION:?set PARTITION}
NODES=${NODES:-1}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
DATASET=${1:-pitts}
SCALE=${2:-30k}
GPUS=$((NODES * GPUS_PER_NODE))
TUPLE_SIZE=${TUPLE_SIZE:-$GPUS}  # global tuples a step, a multiple of GPUS
export MASTER_PORT=${MASTER_PORT:-29500}

srun --partition="$PARTITION" \
  --nodes="$NODES" --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
  --gpus-per-task=1 --kill-on-bad-exit=1 \
  python examples/train_sfrs_torch.py -d "$DATASET" --scale "$SCALE" \
    --loss-type sare_ind \
    --tuple-size "$TUPLE_SIZE" --neg-num 10 --neg-pool 1000 --cache-size 1000 \
    --pos-num 10 --pos-pool 20 \
    --lr 0.001 --momentum 0.9 --weight-decay 0.001 \
    --epochs 5 --step-size 5 --margin 0.1 \
    --generations 4 --temperature 0.07 0.07 0.06 0.05 --soft-weight 0.5 \
    --n-devices "$GPUS" --logs-dir "logs/sfrs-torch/${DATASET}${SCALE}"
