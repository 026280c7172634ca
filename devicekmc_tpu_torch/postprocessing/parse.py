"""Parsers for output.txt and snapshot xyz files.

Both this framework's engine and the reference binary emit the same log
lines (``Applied Voltage = X V``, ``Current [uA]: v``, ``KMC time is: t``,
``Z - calculation time - <module> [s]: dt`` ...), so one parser serves both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class BiasPointTrace:
    voltage: float
    kmc_time: List[float] = field(default_factory=list)
    step_numbers: List[int] = field(default_factory=list)
    series: Dict[str, List[float]] = field(default_factory=dict)

    def get(self, key: str) -> np.ndarray:
        return np.asarray(self.series.get(key, []))


@dataclass
class OutputTrace:
    bias_points: List[BiasPointTrace] = field(default_factory=list)

    @property
    def voltages(self) -> np.ndarray:
        return np.asarray([bp.voltage for bp in self.bias_points])

    def final_per_bias(self, key: str) -> np.ndarray:
        """Last value of ``key`` at each bias point (e.g. the I-V curve)."""
        out = []
        for bp in self.bias_points:
            vals = bp.series.get(key, [])
            out.append(vals[-1] if vals else np.nan)
        return np.asarray(out)

    def concat(self, key: str) -> np.ndarray:
        return np.concatenate(
            [bp.get(key) for bp in self.bias_points if key in bp.series]
            or [np.empty(0)]
        )

    def concat_time(self) -> np.ndarray:
        """Global KMC clock across bias points (each bias resets to 0)."""
        out, offset = [], 0.0
        for bp in self.bias_points:
            t = np.asarray(bp.kmc_time)
            out.append(t + offset)
            if len(t):
                offset += t[-1]
        return np.concatenate(out) if out else np.empty(0)


def parse_output(path: str) -> OutputTrace:
    trace = OutputTrace()
    bp: Optional[BiasPointTrace] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Applied Voltage ="):
                bp = BiasPointTrace(voltage=float(line.split()[3]))
                trace.bias_points.append(bp)
                continue
            if bp is None:
                continue
            if line.startswith("KMC step count:"):
                bp.step_numbers.append(int(float(line.split()[-1])))
            elif line.startswith("KMC time is:"):
                bp.kmc_time.append(float(line.split()[-1]))
            elif ":" in line:
                key, _, val = line.rpartition(":")
                key = key.strip()
                try:
                    bp.series.setdefault(key, []).append(float(val))
                except ValueError:
                    pass
    return trace


def parse_snapshot(path: str):
    """Read a snapshot xyz -> dict of element strings, coords, potential,
    power (reference snapshot columns: src/Device.cpp:236-252)."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        f.readline()
        elements, coords, potential, power = [], [], [], []
        for _ in range(n):
            parts = f.readline().split()
            elements.append(parts[0])
            coords.append([float(x) for x in parts[1:4]])
            potential.append(float(parts[4]) if len(parts) > 4 else np.nan)
            power.append(float(parts[5]) if len(parts) > 5 else np.nan)
    return {
        "elements": np.asarray(elements),
        "coords": np.asarray(coords),
        "potential": np.asarray(potential),
        "power": np.asarray(power),
    }
