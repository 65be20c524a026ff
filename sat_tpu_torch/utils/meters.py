"""Running-average meter with the reference's semantics (reference
utils.py:4-19), copied from sat_tpu/utils/meters.py: `update(val, n)`
records the raw value and a running mean weighted by `n` (the batch's
count of non-special tokens)."""


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0
