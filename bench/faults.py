"""Fault schedules: a schedule's data file in, crash and rejoin times out.

A schedule (``bench/faults/<name>.json``) lists its crashes as fractions of
the window (``"crashes"``), the class of server each one kills
(``"targets"``: ``"critical"`` kills a server that holds a critical
application's primary, ``"standard"`` one that holds a standard
application's, ``"any"`` either), and after what fraction of the window
the killed server rejoins (``"rejoin_after"``). Which server of a class
dies is drawn from the run's seed when the crash comes, from the servers
that hold such a primary then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Crash:
    t: float                 # seconds after the window opens
    target: str              # critical | standard | any
    rejoin_t: Optional[float]


def crashes(spec: Dict, seconds: float) -> List[Crash]:
    fracs = spec.get("crashes", [])
    targets = spec.get("targets", ["any"] * len(fracs))
    if len(targets) != len(fracs):
        raise ValueError("a fault schedule needs one target per crash")
    after = spec.get("rejoin_after")
    return [Crash(f * seconds, tgt,
                  None if after is None else (f + after) * seconds)
            for f, tgt in zip(fracs, targets)]


class VictimPicker:
    """Draws each crash's server from the run's seed."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed & (2**63 - 1), 0x6661756c])

    def pick(self, target: str, holders: Dict[str, Sequence[str]]
             ) -> Optional[str]:
        """``holders`` maps ``critical`` / ``standard`` to the live servers
        that hold such a primary now. A server of the wanted class (``any``:
        of both), else of the other class; None when no server holds a
        primary."""
        both = sorted(set(holders["critical"]) | set(holders["standard"]))
        pool = both if target == "any" else (sorted(holders[target]) or both)
        return pool[int(self.rng.integers(len(pool)))] if pool else None
