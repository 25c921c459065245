"""Kidnap detection + multi-world bookkeeping (host-side state machine).

Mirrors the semantics of the reference's kidnap thread
(src/Cerebro.cpp:2235-2475, spawn src/cerebro_node.cpp:515) and the
DataManager's input-gap detector (src/DataManager.cpp:263-291):

  * kidnap begins when the tracked-feature count drops below
    ``feature_threshold`` (ref THRESH_N_FEATS=15) and stays there for
    ``sustain_s`` (ref 3 s) — the "kidnap" event carries the *start* stamp,
    exactly like the reference publishes FALSE stamped with the kidnap
    start (src/Cerebro.cpp:2355-2365);
  * recovery fires when the count comes back above threshold — a new world
    (coordinate frame) is opened (ref :2367-2381, new world after VINS
    restart);
  * an input-stream gap > ``stream_gap_s`` (ref >1 s between images, the
    multi-bag replay case) triggers the same kidnap->recover pair
    automatically.

The reference runs this as a 5 Hz polling thread over shared state; here it
is a pure per-frame fold: ``feed`` returns the events so the pipeline can
segment the descriptor DB by world id deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from cerebro_tpu_torch.config import KidnapConfig

NORMAL = "normal"
CANDIDATE = "candidate"
KIDNAPPED = "kidnapped"


@dataclasses.dataclass(frozen=True)
class KidnapEvent:
    kind: str  # "kidnap" | "recover"
    stamp: float  # kidnap: start-of-kidnap stamp; recover: recovery stamp
    world_id: int  # world id AFTER the event


class KidnapMonitor:
    def __init__(self, cfg: Optional[KidnapConfig] = None):
        self.cfg = cfg or KidnapConfig()
        self.state = NORMAL
        self.world_id = 0
        self.candidate_start: Optional[float] = None
        self.last_stamp: Optional[float] = None
        # recorded [start, end] intervals (ref kidnap_info_as_json,
        # src/Cerebro.cpp:2408-2425)
        self.intervals: List[List[float]] = []

    def feed(self, stamp: float, n_tracked: int) -> List[KidnapEvent]:
        events: List[KidnapEvent] = []
        cfg = self.cfg

        # input-stream gap => forced kidnap/recover pair (bag-restart path)
        if (
            self.last_stamp is not None
            and stamp - self.last_stamp > cfg.stream_gap_s
            and self.state != KIDNAPPED
        ):
            start = self.last_stamp
            self.world_id += 1
            self.intervals.append([start, stamp])
            events.append(KidnapEvent("kidnap", start, self.world_id - 1))
            events.append(KidnapEvent("recover", stamp, self.world_id))
            self.state = NORMAL
            self.candidate_start = None
            self.last_stamp = stamp
            return events
        self.last_stamp = stamp

        if n_tracked < cfg.feature_threshold:
            if self.state == NORMAL:
                self.state = CANDIDATE
                self.candidate_start = stamp
            elif self.state == CANDIDATE:
                if stamp - self.candidate_start >= cfg.sustain_s:
                    self.state = KIDNAPPED
                    events.append(
                        KidnapEvent("kidnap", self.candidate_start, self.world_id)
                    )
        else:
            if self.state == CANDIDATE:
                self.state = NORMAL
                self.candidate_start = None
            elif self.state == KIDNAPPED:
                self.intervals.append([self.candidate_start, stamp])
                self.world_id += 1
                self.state = NORMAL
                self.candidate_start = None
                events.append(KidnapEvent("recover", stamp, self.world_id))
        return events

    def is_kidnapped(self) -> bool:
        return self.state == KIDNAPPED

    def info(self) -> dict:
        """JSON-able dump (parity: kidnap_info_as_json)."""
        return {
            "state": self.state,
            "world_id": self.world_id,
            "intervals": [list(iv) for iv in self.intervals],
        }
