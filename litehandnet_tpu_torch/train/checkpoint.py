"""Checkpoint and resume (port of ``litehandnet_tpu/train/checkpoint.py``).

The reference contract (dist_train.py:89-127, 212-233): a ``checkpoint``
slot saved every ``CHECKPOINT.interval`` epochs and at the last epoch, a
``best`` slot gated on the validation loss, and a resume that restores the
state, the epoch and the best-loss floor, cross-checking the run's
``config.json`` ID. Each slot is ``<slot>.pt`` (``torch.save`` of
``TrainState.state_dict()``) beside ``<slot>.meta.json`` (epoch,
min_val_loss, step). The tree is ``save_root/<dataset>/<model>/<ID>/``.

Under a process group the chief alone writes the slots, ``config.json`` and
the meta files (JAX :65, :86), and every rank waits at a barrier before it
reads a slot, onto its own device. JAX's orbax save is a collective that
elects its writer; the chief-only write gives the same files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from litehandnet_tpu_torch.train.distributed import is_chief


def run_dir(cfg) -> str:
    return os.path.join(
        cfg.CHECKPOINT.get("save_root", "checkpoints/"),
        str(cfg.DATASET.name),
        str(cfg.MODEL.name),
        str(cfg.get("ID", 0)),
    )


class CheckpointManager:
    """``checkpoint`` and ``best`` slots in one run directory."""

    def __init__(self, directory: str, cfg: Optional[Any] = None,
                 read_only: bool = False):
        """Creates the directory and writes ``cfg`` to its ``config.json``;
        with ``read_only`` (consumers that only restore, such as
        ``tools/test``) it does neither, so the run's ``config.json`` stays
        the training run's.

        Raises:
            ValueError: the directory's ``config.json`` has another ID.
        """
        self.directory = os.path.abspath(directory)
        self.cfg = cfg
        if not read_only:
            os.makedirs(self.directory, exist_ok=True)
        if cfg is not None:
            # cross-check before overwriting: rewriting config.json first
            # would make the resume-time check compare the config to itself
            self._check_id()
            if not read_only and is_chief():
                path = self._config_path()
                with open(path + ".tmp", "w") as f:
                    json.dump(cfg.to_dict(), f, indent=2, default=str)
                os.replace(path + ".tmp", path)

    def _config_path(self) -> str:
        return os.path.join(self.directory, "config.json")

    def _check_id(self) -> None:
        path = self._config_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                saved_id = json.load(f).get("ID")
        except (OSError, ValueError):
            return
        if saved_id is not None and saved_id != self.cfg.get("ID"):
            raise ValueError(
                f"run directory {self.directory} belongs to config "
                f"ID={saved_id}, not ID={self.cfg.get('ID')}: refusing to mix "
                "experiments in one run directory (dist_train.py:102-103)")

    def _slot(self, best: bool) -> str:
        return os.path.join(self.directory, "best" if best else "checkpoint")

    def save(self, state, epoch: int, min_val_loss: float = float("inf"),
             best: bool = False) -> None:
        """Write ``state`` and its meta file; each file is replaced whole.
        Only the chief writes; the other ranks return at once."""
        if not is_chief():
            return
        path = self._slot(best)
        meta = {"epoch": epoch, "min_val_loss": float(min_val_loss),
                "step": int(state.step)}
        torch.save(state.state_dict(), path + ".pt.tmp")
        os.replace(path + ".pt.tmp", path + ".pt")
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")

    def restore(self, state, best: bool = False):
        """Load the slot into ``state`` in place: ``(state, meta)``, or
        ``(None, None)`` when the slot is absent."""
        raw, meta = self.restore_raw(best)
        if raw is None:
            return None, None
        state.load_state_dict(raw)
        return state, meta

    def restore_raw(self, best: bool = False
                    ) -> Tuple[Optional[Dict[str, Any]], Optional[dict]]:
        """The slot's saved dict (tensors on the CPU) and meta, without a
        state to load into; ``(None, None)`` when absent. Under a process
        group every rank calls it: each waits for the others (and so for
        the chief's last write) first.

        Raises:
            ValueError: the run's ``config.json`` has another ID.
        """
        if dist.is_initialized():
            dist.barrier()
        path = self._slot(best)
        if not os.path.exists(path + ".pt"):
            return None, None
        raw = torch.load(path + ".pt", map_location="cpu", weights_only=True)
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        if self.cfg is not None:
            self._check_id()
        return raw, meta
