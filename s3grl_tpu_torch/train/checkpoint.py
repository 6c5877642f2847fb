"""Checkpoint and resume.

Port of ``s3grl_tpu/train/checkpoint.py``, in the reference's own form:
--checkpoint_training saves the model's and the optimizer's ``state_dict``
as ``run{r}_model_checkpoint{epoch}.pth`` and
``run{r}_optimizer_checkpoint{epoch}.pth`` each log step
(sgrl_link_pred.py:1411-1417); --continue_from reloads both and offsets the
epochs (:1328-1338). The model's state holds its batch-norm buffers.
"""
from __future__ import annotations

import glob
import os
import re

import torch

MODEL_PATTERN = "run{run}_model_checkpoint{epoch}.pth"
OPTIMIZER_PATTERN = "run{run}_optimizer_checkpoint{epoch}.pth"


def checkpoint_paths(res_dir: str, run: int, epoch: int) -> tuple[str, str]:
    """(model path, optimizer path) of one run's checkpoint at ``epoch``."""
    return (
        os.path.join(res_dir, MODEL_PATTERN.format(run=run, epoch=epoch)),
        os.path.join(res_dir, OPTIMIZER_PATTERN.format(run=run, epoch=epoch)),
    )


def save_checkpoint(res_dir: str, run: int, epoch: int, model, optimizer) -> None:
    os.makedirs(res_dir, exist_ok=True)
    model_path, opt_path = checkpoint_paths(res_dir, run, epoch)
    torch.save(model.state_dict(), model_path)
    torch.save(optimizer.state_dict(), opt_path)


def load_checkpoint(res_dir: str, run: int, epoch: int, model, optimizer, device) -> None:
    """Restore ``model`` and ``optimizer`` in place from a checkpoint, its
    tensors mapped to ``device``."""
    model_path, opt_path = checkpoint_paths(res_dir, run, epoch)
    model.load_state_dict(torch.load(model_path, map_location=device, weights_only=True))
    optimizer.load_state_dict(torch.load(opt_path, map_location=device, weights_only=True))


def saved_epochs(res_dir: str, run: int) -> list[int]:
    """The epochs of ``run``'s saved model checkpoints, in order."""
    pattern = os.path.join(res_dir, MODEL_PATTERN.format(run=run, epoch="*"))
    found = (re.search(r"checkpoint(\d+)\.pth$", p) for p in glob.glob(pattern))
    return sorted(int(m.group(1)) for m in found if m)
