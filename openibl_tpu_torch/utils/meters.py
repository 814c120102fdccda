"""Scalar running-average meters for wall-clock / loss reporting (copy of
openibl_tpu/utils/meters.py)."""


class AverageMeter:
    """Tracks current value, running sum, count and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
