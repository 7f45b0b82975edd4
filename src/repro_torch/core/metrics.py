"""Evaluation metrics (§8.1): downtime, ETTR, GPU-hours wasted/week.

The Fig. 9 projection math: events arrive at rate 168h / MTTF(N) per
week; the expected:unexpected split is 1:8.9 [17]; every event costs
(downtime + infra reschedule) x N GPU-hours; dedicated standbys burn
standby_count x machine_gpus x 168 GPU-hours of reservation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.cluster.costmodel import CostModel, DEFAULT

WEEK_H = 168.0


@dataclass(frozen=True)
class WastePoint:
    gpus: int
    system: str
    downtime_expected_s: float
    downtime_unexpected_s: float
    gpu_hours_week: float
    events_week: float


def events_per_week(gpus: int, cost: CostModel = DEFAULT) -> float:
    return WEEK_H / cost.mttf_hours(gpus)


def gpu_hours_wasted_week(gpus: int, downtime_expected_s: float,
                          downtime_unexpected_s: float,
                          standby_gpus: int = 0,
                          infra_reschedule_s: float = 120.0,
                          cost: CostModel = DEFAULT,
                          system: str = "") -> WastePoint:
    ev = events_per_week(gpus, cost)
    frac_exp = cost.expected_to_unexpected / (1 + cost.expected_to_unexpected)
    frac_unexp = 1.0 - frac_exp
    per_event = (frac_exp * downtime_expected_s
                 + frac_unexp * downtime_unexpected_s
                 + infra_reschedule_s)
    waste = ev * per_event / 3600.0 * gpus
    waste += standby_gpus * WEEK_H
    return WastePoint(gpus, system, downtime_expected_s,
                      downtime_unexpected_s, waste, ev)


def ettr(productive_seconds: float, wall_seconds: float) -> float:
    return productive_seconds / max(wall_seconds, 1e-9)


def ettr_under_events(gpus: int, downtime_s: float,
                      cost: CostModel = DEFAULT,
                      infra_reschedule_s: float = 120.0) -> float:
    """Steady-state ETTR when every MTTF-interval event costs
    downtime_s (+ infra) — the Fig. 2 / Fig. 9 translation."""
    mttf_s = cost.mttf_hours(gpus) * 3600.0
    return mttf_s / (mttf_s + downtime_s + infra_reschedule_s)


def rebalance_ettr(interval_s: float, downtime_s: float) -> float:
    """Fig. 16: periodic rebalancing every interval_s."""
    return interval_s / (interval_s + downtime_s)
