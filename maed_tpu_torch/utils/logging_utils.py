"""Logging/metering helpers (AverageMeter, logger, timestamped output dirs).

Port of ``maed_tpu/utils/logging_utils.py`` (the original MAED's
``lib/utils/utils.py``); :class:`StepTimer` waits for the card with
``torch.cuda.synchronize`` where the JAX package blocked on its arrays.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import time


class AverageMeter:
    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def create_logger(logdir: str, phase: str = "train") -> logging.Logger:
    os.makedirs(logdir, exist_ok=True)
    log_file = osp.join(logdir, f"{phase}_log.txt")
    logging.basicConfig(
        filename=log_file,
        format="%(asctime)s %(message)s",
        level=logging.INFO,
        force=True,
    )
    logger = logging.getLogger()
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.addHandler(console)
    return logger


def prepare_output_dir(output_dir: str, exp_name: str, cfg_dump: str = "") -> str:
    logtime = time.strftime("%d-%m-%Y_%H-%M-%S")
    logdir = osp.join(output_dir, f"{logtime}_{exp_name}")
    os.makedirs(logdir, exist_ok=True)
    if cfg_dump:
        with open(osp.join(logdir, "config.yaml"), "w") as f:
            f.write(cfg_dump)
    return logdir


class StepTimer:
    """Wall-clock section timing that can wait for the card first."""

    def __init__(self):
        self.times = {}
        self._start = None

    def start(self):
        self._start = time.time()

    def mark(self, name, block_on=None):
        """Time since the last mark; ``block_on`` (a tensor) waits for the
        work that makes it first."""
        if block_on is not None and block_on.is_cuda:
            import torch

            torch.cuda.synchronize(block_on.device)
        now = time.time()
        self.times[name] = now - self._start
        self._start = now
