#!/usr/bin/env bash
# Multi-node baseline training on the PyTorch port under Slurm (the
# reference's scripts/train_baseline_slurm.sh:28-38): one task per GPU,
# NCCL; maybe_init_distributed() reads SLURM_PROCID / SLURM_NTASKS /
# SLURM_NODELIST and fails loudly on a partial environment.
#   PARTITION=<part> NODES=<n> GPUS_PER_NODE=8 \
#     scripts/train_baseline_slurm_torch.sh [pitts] [30k] [sare_ind]
set -euo pipefail
cd "$(dirname "$0")/.."

PARTITION=${PARTITION:?set PARTITION}
NODES=${NODES:-1}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
DATASET=${1:-pitts}
SCALE=${2:-30k}
LOSS=${3:-sare_ind}
GPUS=$((NODES * GPUS_PER_NODE))
# tuple_size is the global tuples a step, a multiple of the GPUs: one a
# GPU, the reference's per-GPU tuple_size=1 (train_baseline_dist.sh:30)
TUPLE_SIZE=${TUPLE_SIZE:-$GPUS}
export MASTER_PORT=${MASTER_PORT:-29500}

srun --partition="$PARTITION" \
  --nodes="$NODES" --ntasks="$GPUS" --ntasks-per-node="$GPUS_PER_NODE" \
  --gpus-per-task=1 --kill-on-bad-exit=1 \
  python examples/train_baseline_torch.py -d "$DATASET" --scale "$SCALE" \
    --loss-type "$LOSS" \
    --tuple-size "$TUPLE_SIZE" --neg-num 10 --neg-pool 1000 --cache-size 1000 \
    --lr 0.001 --momentum 0.9 --weight-decay 0.001 \
    --epochs 5 --step-size 5 --margin 0.1 --n-devices "$GPUS" \
    --logs-dir "logs/netvlad-torch/${DATASET}${SCALE}-${LOSS}"
