"""European frequency-response product definitions + trigger generation.

Activation budgets from the paper's Sect. 1-2: the Nordic FFR requires full
reserve delivery within 700 ms of the frequency crossing 49.7 Hz; FCR has a
30 s budget; aFRR/mFRR are the slower restoration products (PICASSO/MARI).

The trigger generator produces Poisson under-frequency excursions with a
realistic ROCOF so E7 and the twin replay TSO-style activations.

A numpy copy of ``repro.grid.markets``: the port imports nothing of the
JAX package.  The float32 tables are cast to tensors where they are used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NOMINAL_HZ = 50.0


@dataclass(frozen=True)
class FRProduct:
    name: str
    activation_budget_ms: float
    trigger_hz: float           # activation threshold
    full_delivery_hz: float     # frequency at which full reserve is due
    min_duration_s: float       # sustain requirement
    # capacity (availability) price in EUR per committed meter-MW per hour,
    # Nordic/ENTSO-E auction order of magnitude: the fast products clear
    # high because few assets pre-qualify.
    capacity_price_eur_mw_h: float = 10.0


FR_PRODUCTS: dict[str, FRProduct] = {
    # Nordic Fast Frequency Reserve: the strictest European product
    "FFR": FRProduct("FFR", 700.0, 49.7, 49.5, 30.0, 45.0),
    "FCR-D": FRProduct("FCR-D", 5_000.0, 49.9, 49.5, 60.0, 18.0),
    "FCR": FRProduct("FCR", 30_000.0, 49.98, 49.8, 900.0, 15.0),
    "aFRR": FRProduct("aFRR", 300_000.0, 49.99, 49.9, 3600.0, 9.0),
    "mFRR": FRProduct("mFRR", 750_000.0, 49.99, 49.9, 3600.0, 5.0),
}

# Stable product indexing for the batched reserve engine: a scenario's
# product is carried as an int32 index into this tuple on device.
PRODUCT_ORDER: tuple[str, ...] = tuple(FR_PRODUCTS)

# Product constant tables in PRODUCT_ORDER, indexable by a traced int32
# product index.  Shared by the reserve replay scan, the Tier-3 revenue
# term, and the frequency synthesiser, so the rules live in one place.
_P = [FR_PRODUCTS[n] for n in PRODUCT_ORDER]
TRIGGER_HZ = np.asarray([p.trigger_hz for p in _P], np.float32)
BUDGET_MS = np.asarray([p.activation_budget_ms for p in _P], np.float32)
MIN_DURATION_S = np.asarray([p.min_duration_s for p in _P], np.float32)
CAPACITY_PRICE_EUR_MW_H = np.asarray(
    [p.capacity_price_eur_mw_h for p in _P], np.float32)
del _P


class FFRTriggerGen:
    """Poisson under-frequency events.

    Each event: frequency ramps down at `rocof` Hz/s from 50.0, bottoms at
    `nadir`, recovers over `recovery_s`.  Events per day follows the Nordic
    activation statistics order of magnitude (a few per week at the FFR
    threshold; more at FCR-D).
    """

    def __init__(self, events_per_day: float = 4.0, seed: int = 0,
                 rocof_hz_s: float = 0.2):
        self.rate = events_per_day
        self.rocof = rocof_hz_s
        self.rng = np.random.default_rng(seed)

    def sample_day(self, product: FRProduct = FR_PRODUCTS["FFR"]):
        """Returns a list of (t_event_s, nadir_hz, recovery_s)."""
        n = self.rng.poisson(self.rate)
        out = []
        for _ in range(n):
            t = float(self.rng.uniform(0.0, 86_400.0))
            nadir = float(self.rng.uniform(product.full_delivery_hz - 0.1,
                                           product.trigger_hz - 0.02))
            rec = float(self.rng.uniform(60.0, 600.0))
            out.append((t, nadir, rec))
        return sorted(out)

    def frequency_trace(self, events, n_seconds: int) -> np.ndarray:
        """Grid frequency at 1 Hz over the horizon with the sampled events.

        Events are applied in list order with overwrite semantics (a later
        event's ramp wins on overlapping seconds); each event is two slice
        assignments, not a per-second loop.
        """
        f = np.full(n_seconds, NOMINAL_HZ)
        f += 0.01 * np.cumsum(
            self.rng.standard_normal(n_seconds)
        ) / np.sqrt(np.arange(1, n_seconds + 1))
        for (t, nadir, rec) in events:
            t0 = int(t)
            fall_s = max(int((NOMINAL_HZ - nadir) / self.rocof), 1)
            kf = np.arange(max(min(t0 + fall_s, n_seconds) - t0, 0))
            f[t0:t0 + kf.size] = NOMINAL_HZ - self.rocof * kf
            r0 = t0 + fall_s
            kr = np.arange(max(min(r0 + int(rec), n_seconds) - r0, 0))
            f[r0:r0 + kr.size] = nadir + (NOMINAL_HZ - nadir) * kr / rec
        return f
