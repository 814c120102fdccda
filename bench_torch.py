"""Throughput and latency of the PyTorch port on one card, under bench.py's
metric names (the twin of bench.py, which stays the JAX package's).

  python bench_torch.py --metric extract|query|train|sfrs [...]
  python bench_torch.py --metric query --device cpu --height 64 --width 64 \\
      --gallery-size 256 --iters 2 --dtype float32

Without ``--device`` it runs on the card and raises without one. The
options and the output are ``openibl_tpu_torch/tools/bench.py``'s.
"""

import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from openibl_tpu_torch.tools.bench import main  # noqa: E402

if __name__ == "__main__":
    main()
