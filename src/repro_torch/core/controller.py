"""GridPilot composition: the grid-facing control layer, the port of
``repro.core.controller``.

In-cluster power managers divide a fixed envelope among jobs; GridPilot
is the orthogonal layer that decides what the envelope *should be*.  This
controller produces ``PowerPlan``s from grid signals through the three
tiers and exposes the safety island for sub-second FFR shedding; the
serving launcher (``repro_torch.launch.serve``) consumes them.

The plan actuates by load shaping -- duty cycle (sheddable step
fraction), token-budget thinning, and elastic replica count -- Algorithm
1's mechanism set.  ``device=`` (default CUDA) places the Tier-2 RLS
state and the Tier-3 search; the island stays numpy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import repro_torch.core.ar4 as ar4_lib
import repro_torch.core.island as island_lib
import repro_torch.core.plant as plant_lib
import repro_torch.core.pue as pue_lib
import repro_torch.core.tier3 as tier3_lib
from repro_torch import resolve_device


@dataclass(frozen=True)
class PowerPlan:
    """What the trainer actuates for the next control interval."""

    mu: float                 # operating fraction of design compute
    rho: float                # committed FFR reserve band
    duty_cycle: float         # fraction of steps that run (1.0 = all)
    replica_scale: float      # elastic data-parallel width multiplier
    cap_tokens_frac: float    # token-budget thinning factor (1.0 = full)
    ffr_shed: bool = False    # True while an FFR activation is being served

    @property
    def effective_fraction(self) -> float:
        f = self.duty_cycle * self.cap_tokens_frac
        return (self.mu - self.rho) * f if self.ffr_shed else self.mu * f


def plan_from_operating_point(mu: float, rho: float,
                              ffr_shed: bool = False) -> PowerPlan:
    """Map a Tier-3 point onto load-shaping actuators.

    The reserve band rho is held as *instantly sheddable duty-cycled
    steps*: in normal operation the cluster runs at mu via duty cycle;
    during an FFR activation the duty cycle drops by rho/mu immediately
    (a step boundary is <1 s at these scales -- checkpoint-consistent).
    """
    mu = float(mu)
    rho = float(rho)
    duty = max(mu - rho, tier3_lib.MIN_RESIDUAL_LOAD) / mu if ffr_shed else 1.0
    return PowerPlan(
        mu=mu, rho=rho,
        duty_cycle=duty,
        replica_scale=round(mu / 0.9, 2),
        cap_tokens_frac=1.0,
        ffr_shed=ffr_shed,
    )


class GridPilot:
    """Three tiers + island, wired for a (simulated or real) fleet."""

    def __init__(self, n_hosts: int, chips_per_host: int,
                 *, chip_tdp: float = plant_lib.TDP,
                 pue_aware: bool = True,
                 pue_design: float = pue_lib.PUE_DESIGN,
                 price_aware: bool = False,
                 product: str = "FFR",
                 island_port: int = island_lib.DEFAULT_PORT,
                 start_island: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_hosts = n_hosts
        self.chips_per_host = chips_per_host
        self.n_chips = n_hosts * chips_per_host
        self.chip_tdp = chip_tdp
        self.design_it_w = self.n_chips * chip_tdp
        # price_aware feeds the reserve-settlement revenue term back into
        # the Tier-3 grid search (the engine's closed Tier-3 loop)
        self.selector = tier3_lib.Tier3Selector(
            pue_aware=pue_aware, pue_design=pue_design,
            w_rev=tier3_lib.W_REV_DEFAULT if price_aware else 0.0,
            product=product, device=self.device)

        # island: (mu x rho) grid flattened to rows of per-chip caps
        per_host = tier3_lib.cap_table(
            chips_per_host, chips_per_host * chip_tdp,
            plant_lib.CAP_MIN, plant_lib.CAP_MAX,
        )  # (6, 4) per-chip cap
        rows = per_host.reshape(-1)  # 24 operating points
        table = np.repeat(rows[:, None], self.n_chips, axis=1)
        self.island = island_lib.SafetyIsland(self.n_chips, table,
                                              port=island_port)
        self._island_started = False
        if start_island:
            self.island.start()
            self._island_started = True
        self.rls = ar4_lib.init_rls(n_hosts, device=self.device)
        self.current_op: Optional[tier3_lib.OperatingPoint] = None
        self.current_row = 0
        self._seen_triggers = 0

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        if self._island_started:
            self.island.stop()
            self._island_started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- Tier-3 (hourly) --------------------------------------------------------
    def hourly_plan(self, ci_forecast_24h, t_amb_forecast_24h) -> PowerPlan:
        op = self.selector.select_day(ci_forecast_24h, t_amb_forecast_24h)
        mu = float(op.mu.reshape(-1)[0])
        rho = float(op.rho.reshape(-1)[0])
        self.current_op = tier3_lib.OperatingPoint(mu, rho)
        i = int(np.argmin(np.abs(tier3_lib.MU_GRID - mu)))
        j = int(np.argmin(np.abs(tier3_lib.RHO_GRID - rho)))
        self.current_row = i * len(tier3_lib.RHO_GRID) + j
        self.island.arm(self.current_row)
        return plan_from_operating_point(mu, rho)

    # -- Tier-2 (1 Hz) ----------------------------------------------------------
    def observe_host_power(self, host_power_w) -> torch.Tensor:
        """Feed 1 Hz host telemetry; returns the per-host one-second
        prediction, on the controller's device."""
        u = torch.as_tensor(np.asarray(host_power_w, np.float32),
                            device=self.device)
        self.rls, _ = ar4_lib.rls_update(self.rls, u)
        return ar4_lib.predict(self.rls)

    # -- island (sub-second) -----------------------------------------------------
    def poll_ffr(self) -> Optional[PowerPlan]:
        """Returns a shed plan if the island fired since the last poll."""
        if self.island.trigger_count > self._seen_triggers:
            self._seen_triggers = self.island.trigger_count
            op = self.current_op or tier3_lib.OperatingPoint(0.9, 0.2)
            return plan_from_operating_point(
                float(op.mu), float(op.rho), ffr_shed=True)
        return None

    def fire_test_trigger(self, freq_hz: float = 49.5) -> None:
        self.island.send_trigger(self.current_row, freq_hz)
