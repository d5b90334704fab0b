"""Training log and parameter table (counterpart of
``openpsg_tpu/utils/logging.py``): a timestamped log file in the work
directory, and a parameter count per top-level group."""

from __future__ import annotations

import logging
import os
import time
from typing import Dict

import torch


def setup_logger(work_dir: str, name: str = "openpsg_tpu_torch") -> logging.Logger:
    """A logger writing to the console and to ``work_dir/<timestamp>.log``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    fh = logging.FileHandler(os.path.join(work_dir, f"{time.strftime('%Y%m%d_%H%M%S')}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


def param_table(groups: Dict[str, Dict[str, torch.Tensor]]) -> str:
    """{group: {name: tensor}} (``PSGv4.param_groups``) → a table of
    parameter and tensor counts per group."""
    lines = ["parameter groups:"]
    total = 0
    for group, tensors in groups.items():
        n = sum(t.numel() for t in tensors.values())
        total += n
        lines.append(f"  {group:>12}: {n:>14,} params, {len(tensors)} tensors")
    lines.append(f"  {'TOTAL':>12}: {total:>14,}")
    return "\n".join(lines)
