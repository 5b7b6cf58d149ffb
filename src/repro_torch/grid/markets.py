"""European frequency-response product definitions + trigger generation.

Activation budgets from the paper's Sect. 1-2: the Nordic FFR requires full
reserve delivery within 700 ms of the frequency crossing 49.7 Hz; FCR has a
30 s budget; aFRR/mFRR are the slower restoration products (PICASSO/MARI).

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

