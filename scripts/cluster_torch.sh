#!/usr/bin/env bash
# NetVLAD centroid bootstrap on the PyTorch port (the reference's
# scripts/cluster.sh), on the card.
#   scripts/cluster_torch.sh [pitts] [extra flags]
set -euo pipefail
cd "$(dirname "$0")/.."
DATASET=${1:-pitts}
shift $(( $# > 0 ? 1 : 0 ))
python examples/cluster_torch.py -d "$DATASET" "$@"
