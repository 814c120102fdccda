#!/usr/bin/env bash
# Published baseline recipe on the PyTorch port (the reference's
# scripts/train_baseline_dist.sh): SARE/triplet on Pitts30k over the GPUs
# of one host, one process each (torchrun, NCCL). Each rank trains on its
# share of every global tuple batch; one tuple per GPU by default.
#   GPUS=4 scripts/train_baseline_torch.sh [pitts] [30k] [sare_ind] [extra flags]
set -euo pipefail
cd "$(dirname "$0")/.."

GPUS=${GPUS:-$(nvidia-smi -L | wc -l)}
DATASET=${1:-pitts}
SCALE=${2:-30k}
LOSS=${3:-sare_ind}   # triplet | sare_ind | sare_joint
shift $(( $# > 3 ? 3 : $# ))
TUPLE_SIZE=${TUPLE_SIZE:-$GPUS}

torchrun --nproc-per-node="$GPUS" examples/train_baseline_torch.py \
  -d "$DATASET" --scale "$SCALE" --loss-type "$LOSS" \
  --tuple-size "$TUPLE_SIZE" --neg-num 10 --neg-pool 1000 --cache-size 1000 \
  --lr 0.001 --momentum 0.9 --weight-decay 0.001 \
  --epochs 5 --step-size 5 --margin 0.1 --n-devices "$GPUS" \
  --logs-dir "logs/netvlad-torch/${DATASET}${SCALE}-${LOSS}" "$@"
