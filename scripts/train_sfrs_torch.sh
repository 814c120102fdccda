#!/usr/bin/env bash
# Published SFRS recipe on the PyTorch port (the reference's
# scripts/train_sfrs_dist.sh): 4 generations, temperatures
# 0.07/0.07/0.06/0.05, over the GPUs of one host (torchrun, NCCL).
#   GPUS=4 scripts/train_sfrs_torch.sh [pitts] [30k] [extra flags]
set -euo pipefail
cd "$(dirname "$0")/.."

GPUS=${GPUS:-$(nvidia-smi -L | wc -l)}
DATASET=${1:-pitts}
SCALE=${2:-30k}
shift $(( $# > 2 ? 2 : $# ))
TUPLE_SIZE=${TUPLE_SIZE:-$GPUS}

torchrun --nproc-per-node="$GPUS" examples/train_sfrs_torch.py \
  -d "$DATASET" --scale "$SCALE" --loss-type sare_ind \
  --tuple-size "$TUPLE_SIZE" --neg-num 10 --neg-pool 1000 --cache-size 1000 \
  --pos-num 10 --pos-pool 20 \
  --lr 0.001 --momentum 0.9 --weight-decay 0.001 \
  --epochs 5 --step-size 5 --margin 0.1 \
  --generations 4 --temperature 0.07 0.07 0.06 0.05 --soft-weight 0.5 \
  --n-devices "$GPUS" --logs-dir "logs/sfrs-torch/${DATASET}${SCALE}" "$@"
