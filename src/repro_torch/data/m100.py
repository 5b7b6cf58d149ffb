"""Marconi100-style job-trace synthesiser (the paper's scheduling
substrate): a numpy copy of ``repro.data.m100``.

Lognormal durations (median ~1.5 h, heavy tail), power-law node counts
(mostly 1-4 nodes, rare large jobs), a diurnal submission rate with an
office-hours peak, ~30 % elastic-capable jobs, per-node power near the
4xV100+POWER9 node envelope (~2 kW IT).  The same seed gives the
reference's trace job for job.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dispatch import Job

M100_NODE_POWER_W = 2000.0  # 4x V100 + POWER9 host, IT only


def synthesize_m100_trace(n_jobs: int, horizon_h: float, total_nodes: int,
                          seed: int = 0, target_util: float = 0.75) -> list:
    """Returns a list of ``repro_torch.core.dispatch.Job`` covering
    ``horizon_h``."""
    rng = np.random.default_rng(seed)

    # diurnal arrivals: thinned Poisson with an office-hours peak
    t = rng.uniform(0.0, horizon_h, size=4 * n_jobs)
    hour = t % 24.0
    accept_p = 0.45 + 0.55 * np.exp(-0.5 * ((hour - 14.0) / 5.0) ** 2)
    t = t[rng.uniform(size=t.size) < accept_p][:n_jobs]
    t.sort()

    # durations: lognormal, median 1.5 h, sigma 1.1; clip to 36 h
    dur = np.clip(rng.lognormal(np.log(1.5), 1.1, size=t.size), 0.05, 36.0)
    # node counts: zipf-ish
    nodes = np.minimum(rng.zipf(1.9, size=t.size), max(total_nodes // 4, 1))
    # calibrate total work to target_util of the fleet
    work = float(np.sum(dur * nodes))
    budget = target_util * total_nodes * horizon_h
    scale = budget / max(work, 1e-9)
    dur = np.clip(dur * min(scale, 1.5), 0.05, 48.0)

    elastic = rng.uniform(size=t.size) < 0.30
    d_max = np.clip(rng.lognormal(np.log(12.0), 0.6, size=t.size), 2.0, 48.0)
    power = rng.normal(M100_NODE_POWER_W, 120.0, size=t.size).clip(1200, 2400)

    return [
        Job(jid=i, submit_h=float(t[i]), duration_h=float(dur[i]),
            nodes=int(nodes[i]), power_node_w=float(power[i]),
            elastic=bool(elastic[i]), d_max_h=float(d_max[i]))
        for i in range(t.size)
    ]
