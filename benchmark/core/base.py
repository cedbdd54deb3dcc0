"""What every traffic mix's loop shares: the device, seeds, the check."""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for a part of the run, from ``--seed`` and keys."""
    ss = np.random.SeedSequence([seed % (1 << 64)] + [int(k) for k in keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class LoopBase:
    """A cell's loop: ``__init__`` makes the inputs, ``warm`` runs one unit
    of the cell's own shapes, ``unit`` runs one timed unit and returns its
    work counts (``failed`` true for a unit that gave no answer), ``check``
    compares a sample of the window's answers with the plain reference."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        raise NotImplementedError

    def unit(self) -> dict:
        raise NotImplementedError

    def trace_units(self) -> int:
        return int(self.mix["trace_units"])

    def info(self) -> dict:
        """The static shapes the per-layer readers need."""
        return {}

    def free(self):
        """Drop what only the timed path needs, before the reference runs."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> Dict[str, float]:
        raise NotImplementedError

    def controls(self) -> Dict[str, Dict[str, float]]:
        """Each control's numbers, by its name: what the check reads with
        the control in the program's place (``readings.py``, the control
        tests); the benchmark's own runs do not run them."""
        raise NotImplementedError

    def check(self, limits: Dict[str, float]) -> Dict[str, dict]:
        self.free()
        return checks_from(self.readings(), limits)

    def card_text(self) -> str:
        """The card's name and power limit, as ``nvidia-smi`` reads them."""
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi unavailable ({e})"


def checks_from(values: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    """The numbers that the cell's limits file (``benchmark/limits/
    <workload>.json``) names, each beside its limit; a named number the
    check did not read counts as infinite."""
    if not limits:
        raise ValueError("the cell's limits file names no number")
    return {k: {"value": float(values.get(k, float("inf"))),
                "limit": float(limits[k])} for k in limits}


def frame_seed(seed: int, position: int) -> int:
    """The generator seed of the frame at ``position``, as the
    ``feature_extractor`` CLI seeds each image from ``--seed``."""
    return int(np.random.SeedSequence([seed, position]).generate_state(
        1, np.uint64)[0])
