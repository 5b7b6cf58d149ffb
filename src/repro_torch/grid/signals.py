"""Synthetic hourly grid signals for six European grids (paper E8).

CI is synthesised from EEA/Ember country means shaped by the 2020-2024
ENTSO-E diurnal envelope (paper Sect. 4): a double-humped daily profile
(morning/evening peaks, solar midday dip scaled by the country's solar
share) modulated by multi-day wind events (AR(1), ~30 h correlation).

Ambient temperature couples to the wind events with a *negative* sign --
cold fronts bring wind -- which produces the free-cooling alignment the
composite CI x PUE signal exploits (paper Sect. 3.3: "cold-weather wind
events that produce low CI also produce low PUE through chiller bypass").

The released kit also ships a real-CI fetcher (ENTSO-E A75 with IPCC AR5
lifecycle factors); offline, `synthesize_ci` is the drop-in stand-in.

A numpy copy of ``repro.grid.signals``: the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

# country -> (mean CI gCO2/kWh [EEA/Ember-style means], solar share,
#             wind share, winter/summer mean temp degC, relative CI
#             volatility).  Volatility reflects the marginal fleet:
#             hydro/nuclear-buffered grids (SE, CH) are nearly flat;
#             gas-marginal grids with big renewables (DE, IT) swing hard;
#             coal baseload (PL) is flat-ish at a high level.
COUNTRIES: dict[str, dict] = {
    "SE": dict(ci_mean=25.0, solar=0.02, wind=0.25, t_winter=-4.0,
               t_summer=17.0, ci_vol=0.25),
    "CH": dict(ci_mean=38.0, solar=0.06, wind=0.02, t_winter=0.0,
               t_summer=19.0, ci_vol=0.35),
    "FR": dict(ci_mean=56.0, solar=0.05, wind=0.09, t_winter=5.0,
               t_summer=21.0, ci_vol=0.6),
    "IT": dict(ci_mean=280.0, solar=0.12, wind=0.08, t_winter=8.0,
               t_summer=25.0, ci_vol=1.0),
    "DE": dict(ci_mean=380.0, solar=0.12, wind=0.25, t_winter=2.0,
               t_summer=19.0, ci_vol=1.3),
    "PL": dict(ci_mean=660.0, solar=0.08, wind=0.12, t_winter=-1.0,
               t_summer=19.0, ci_vol=0.45),
}
COUNTRY_ORDER = ["SE", "CH", "FR", "IT", "DE", "PL"]  # by mean CI


def _country_seed(country: str, seed: int) -> int:
    """Deterministic per-(country, seed) rng seed.

    Python's built-in `hash(str)` is randomised per process (PYTHONHASHSEED),
    which made every trace -- and every benchmark number derived from it --
    change between runs.  crc32 is stable everywhere.
    """
    return seed * 101 + zlib.crc32(country.encode()) % 2**16


def _wind_events(n_hours: int, rng: np.random.Generator,
                 corr_h: float = 30.0) -> np.ndarray:
    """AR(1) multi-day wind anomaly in [-1, 1]-ish."""
    phi = np.exp(-1.0 / corr_h)
    sig = np.sqrt(1 - phi * phi)
    x = np.zeros(n_hours)
    v = rng.standard_normal(n_hours)
    for t in range(1, n_hours):
        x[t] = phi * x[t - 1] + sig * v[t]
    return np.tanh(0.8 * x)


def _diurnal(hours: np.ndarray, solar_share: float) -> np.ndarray:
    """ENTSO-E-style normalised daily CI envelope (mean ~1)."""
    h = hours % 24
    # demand humps at ~08 h and ~19 h push CI up; night trough
    demand = 0.10 * np.cos(2 * np.pi * (h - 19.0) / 24.0) + 0.06 * np.cos(
        4 * np.pi * (h - 8.0) / 24.0
    )
    # solar dip centred at 13 h, scaled by solar share
    dip = -2.2 * solar_share * np.exp(-0.5 * ((h - 13.0) / 2.6) ** 2)
    return 1.0 + demand + dip


def synthesize_ci(country: str, n_hours: int, seed: int = 0,
                  start_day_of_year: int = 15) -> np.ndarray:
    """Hourly carbon intensity (gCO2/kWh) for `country`."""
    c = COUNTRIES[country]
    rng = np.random.default_rng(_country_seed(country, seed))
    hours = np.arange(n_hours, dtype=np.float64) + 24.0 * start_day_of_year
    vol = c["ci_vol"]
    env = 1.0 + vol * (_diurnal(hours, c["solar"]) - 1.0)
    wind = _wind_events(n_hours, rng)
    # wind events displace the marginal fossil plant: CI drops when windy
    wind_pull = 1.0 - vol * 0.4 * c["wind"] / 0.25 * wind
    noise = 1.0 + 0.03 * vol * rng.standard_normal(n_hours)
    ci = c["ci_mean"] * env * wind_pull * noise
    return np.clip(ci, 0.05 * c["ci_mean"], 3.0 * c["ci_mean"])


def synthesize_t_amb(country: str, n_hours: int, seed: int = 0,
                     start_day_of_year: int = 15) -> np.ndarray:
    """Hourly ambient (dry-bulb ~ wet-bulb proxy) temperature, degC.

    Shares the wind-event stream with `synthesize_ci` (same seed) so cold
    fronts coincide with low CI -- the free-cooling alignment effect.
    """
    c = COUNTRIES[country]
    rng = np.random.default_rng(_country_seed(country, seed))
    hours = np.arange(n_hours, dtype=np.float64)
    doy = (float(start_day_of_year) + hours / 24.0) % 365.0
    season = 0.5 - 0.5 * np.cos(2 * np.pi * (doy - 15.0) / 365.0)  # 0 winter
    base = c["t_winter"] + (c["t_summer"] - c["t_winter"]) * season
    diurnal = 4.5 * np.sin(2 * np.pi * ((hours % 24) - 9.0) / 24.0)
    wind = _wind_events(n_hours, rng)      # same stream as CI (same rng seq)
    front = -3.5 * wind                    # windy => cold front
    noise = 1.2 * rng.standard_normal(n_hours)
    return base + diurnal + front + noise


@dataclass(frozen=True)
class GridSignals:
    country: str
    ci: np.ndarray        # (H,) gCO2/kWh
    t_amb: np.ndarray     # (H,) degC

    @property
    def hours(self) -> int:
        return len(self.ci)

    def greenness(self) -> np.ndarray:
        lo, hi = self.ci.min(), self.ci.max()
        return 1.0 - (self.ci - lo) / max(hi - lo, 1e-9)


def make_grid(country: str, n_hours: int = 7 * 24, seed: int = 0,
              start_day_of_year: int = 15) -> GridSignals:
    return GridSignals(
        country=country,
        ci=synthesize_ci(country, n_hours, seed, start_day_of_year),
        t_amb=synthesize_t_amb(country, n_hours, seed, start_day_of_year),
    )
