"""Render observability reports: latency-budget compliance tables and
histogram summaries, from either a rollout's telemetry dict or a
host-side JSONL trace.  The port of ``repro.obs.report``.

    # run the full 288-scenario-day E9 sweep with telemetry taps on and
    # render the per-event trigger-to-target histogram vs the FFR budget
    # (on the card; --device cpu runs it on the CPU)
    python -m repro_torch.obs.report --sweep [--fast] [--save tel.json]

    # re-render a saved telemetry dict (no rollout)
    python -m repro_torch.obs.report --telemetry tel.json

    # summarise a host-side trace exported by Tracer.export_jsonl
    python -m repro_torch.obs.report --trace serve_trace.jsonl

The sweep mirrors the E9 bench batch (COUNTRY_ORDER x seeds(0,1,2) x
{FFR, FCR-D} x rho {0,0.1,0.2,0.3} x event seeds (0,1), 24 h horizons =
288 scenario-days) without importing the benchmarks package, so the CLI
works from a bare ``PYTHONPATH=src`` checkout.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.obs import telemetry as tel_lib
from repro_torch.obs import trace as trace_lib

BAR_W = 40


# ---------------------------------------------------------------------------
# Telemetry dict <-> JSON
# ---------------------------------------------------------------------------


def save_telemetry(tel: dict, path: str) -> str:
    """Serialise a rollout's telemetry dict (numpy or tensor leaves) to
    JSON."""
    payload = {k: _np(v).tolist() for k, v in tel.items()}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_telemetry(path: str) -> dict:
    with open(path) as f:
        payload = json.load(f)
    return {k: np.asarray(v) for k, v in payload.items()}


# ---------------------------------------------------------------------------
# Telemetry rendering
# ---------------------------------------------------------------------------


def _product_name(budget_ms: float) -> str:
    import repro_torch.grid.markets as markets

    for name, p in markets.FR_PRODUCTS.items():
        if abs(p.activation_budget_ms - budget_ms) < 0.5:
            return name
    return f"budget={budget_ms:.0f}ms"


def _bucket_labels(edges) -> list[str]:
    # histogram buckets are (-inf, e0], (e0, e1], ..., (eK, inf): the
    # upper edge is inclusive (t == budget IS compliant)
    labels = [f"<= {edges[0]:g}"]
    labels += [f"({lo:g}, {hi:g}]" for lo, hi in zip(edges, edges[1:])]
    labels.append(f"> {edges[-1]:g}")
    return labels


def _bar(count: float, total: float) -> str:
    n = int(round(BAR_W * count / total)) if total else 0
    return "#" * n


def response_rows(tel: dict) -> list[dict]:
    """Per-product compliance summary rows from a telemetry dict."""
    budgets = np.asarray(tel["resp_budget_ms"], np.float32)
    valid = np.asarray(tel["resp_valid"], bool)
    ms = np.asarray(tel["resp_ms"], np.float32)
    hist = np.asarray(tel["resp_hist"], np.float32)
    n_ok = np.asarray(tel["n_budget_ok"])
    # the histogram edge at 1.0 IS the deadline: compliant mass is every
    # bucket strictly below it
    n_under = tel_lib.RESP_FRAC_EDGES.index(1.0) + 1
    rows = []
    for b in sorted(set(budgets.tolist())):
        sel = budgets == b
        v = valid[sel]
        x = ms[sel][v]
        h = hist[sel].sum(0)
        n_ev = int(v.sum())
        rows.append(dict(
            product=_product_name(b), budget_ms=float(b), n_events=n_ev,
            n_budget_ok=int(np.sum(n_ok[sel])),
            p50_ms=float(np.percentile(x, 50)) if n_ev else 0.0,
            p95_ms=float(np.percentile(x, 95)) if n_ev else 0.0,
            max_ms=float(x.max()) if n_ev else 0.0,
            mean_ms=float(x.mean()) if n_ev else 0.0,
            compliance=float(h[:n_under].sum() / h.sum()) if h.sum() else 1.0,
            hist=h,
        ))
    return rows


def render_response(tel: dict, out=sys.stdout) -> None:
    """The paper's Table-1 view: trigger-to-target vs activation budget."""
    labels = _bucket_labels(tel_lib.RESP_FRAC_EDGES)
    print("\n== trigger-to-target response vs activation budget ==", file=out)
    hdr = (f"{'product':>8} {'budget_ms':>9} {'events':>7} {'p50_ms':>8} "
           f"{'p95_ms':>8} {'max_ms':>8} {'in_budget':>9} {'compliance':>10}")
    print(hdr, file=out)
    for r in response_rows(tel):
        print(f"{r['product']:>8} {r['budget_ms']:>9.0f} "
              f"{r['n_events']:>7d} {r['p50_ms']:>8.1f} {r['p95_ms']:>8.1f} "
              f"{r['max_ms']:>8.1f} {r['n_budget_ok']:>9d} "
              f"{r['compliance']:>10.1%}", file=out)
        total = r["hist"].sum()
        n_under = tel_lib.RESP_FRAC_EDGES.index(1.0) + 1
        print(f"  t_response / budget ({r['product']}):", file=out)
        for i, (lab, c) in enumerate(zip(labels, r["hist"])):
            marker = " <- deadline (1.0 x budget)" if i == n_under else ""
            print(f"    {lab:>12} {int(c):>7d} {_bar(c, total)}{marker}",
                  file=out)


def render_health(tel: dict, out=sys.stdout) -> None:
    """Controller-health moments: hour-weighted means over the sweep."""
    n_h = np.asarray(tel["hour_n"], np.float32)
    w = n_h / max(n_h.sum(), 1.0)

    def wmean(k):
        return float((np.asarray(tel[k], np.float32) * w).sum())

    print("\n== controller health (hour-weighted over sweep) ==", file=out)
    print(f"  twin RLS residual RMS      {wmean('rls_rms_h'):.5f} "
          "(per-unit of host design power)", file=out)
    print(f"  tracking error RMS         {wmean('track_rms_h'):.5f}",
          file=out)
    print(f"  cap-saturation fraction    {wmean('sat_frac_h'):.3f}", file=out)
    print(f"  power slew extremes        "
          f"max {float(np.max(tel['slew_max_h'])):+.3f} / "
          f"min {float(np.min(tel['slew_min_h'])):+.3f} (pu/s)", file=out)
    hist = np.asarray(tel["track_hist"], np.float32).sum(0)
    labels = _bucket_labels(tel_lib.TRACK_ERR_EDGES)
    total = hist.sum()
    print("  tracking-error distribution (warm seconds):", file=out)
    for lab, c in zip(labels, hist):
        print(f"    {lab:>14} {int(c):>9d} {_bar(c, total)}", file=out)


def render_telemetry(tel: dict, out=sys.stdout) -> None:
    n = np.asarray(tel["hour_n"]).shape[0]
    hours = float(np.asarray(tel["hour_n"]).sum() / 3600.0)
    print(f"telemetry: {n} scenarios, {hours:.1f} scenario-hours "
          f"({hours / 24.0:.1f} scenario-days)", file=out)
    render_response(tel, out)
    render_health(tel, out)


# ---------------------------------------------------------------------------
# JSONL trace rendering
# ---------------------------------------------------------------------------


def render_trace(records: list[dict], out=sys.stdout) -> None:
    spans: dict[str, list[float]] = {}
    events: dict[str, int] = {}
    counters, observations = [], []
    for r in records:
        kind = r.get("kind")
        if kind == "span":
            spans.setdefault(r["name"], []).append(float(r.get("wall_s", 0)))
        elif kind == "event":
            events[r["name"]] = events.get(r["name"], 0) + 1
        elif kind == "counter":
            counters.append(r)
        elif kind == "observation":
            observations.append(r)
    if spans:
        print("\n== spans ==", file=out)
        print(f"{'name':<32} {'count':>6} {'total_s':>10} {'mean_s':>10} "
              f"{'p95_s':>10} {'max_s':>10}", file=out)
        for name in sorted(spans):
            xs = np.asarray(spans[name], np.float64)
            print(f"{name:<32} {xs.size:>6d} {xs.sum():>10.4f} "
                  f"{xs.mean():>10.4f} {np.percentile(xs, 95):>10.4f} "
                  f"{xs.max():>10.4f}", file=out)
    if events:
        print("\n== events ==", file=out)
        for name in sorted(events):
            print(f"{name:<32} {events[name]:>6d}", file=out)
    if counters:
        print("\n== counters ==", file=out)
        for r in sorted(counters, key=lambda r: r["name"]):
            print(f"{r['name']:<32} {r['value']:>12g}", file=out)
    if observations:
        print("\n== observations ==", file=out)
        for r in sorted(observations, key=lambda r: r.get("name", "")):
            if r.get("count"):
                print(f"{r['name']:<32} n={r['count']:<6d} "
                      f"mean={r['mean']:.6f} p95={r['p95']:.6f} "
                      f"max={r['max']:.6f}", file=out)
    _render_service(counters, observations, out)


def _render_service(counters: list[dict], observations: list[dict],
                    out=sys.stdout) -> None:
    """Online-service health block: fleet counters + the trigger-to-target
    distribution vs the FFR activation budget (``repro.service``)."""
    c = {r["name"]: r["value"] for r in counters
         if str(r.get("name", "")).startswith("service.")}
    o = {r["name"]: r for r in observations
         if str(r.get("name", "")).startswith("service.") and r.get("count")}
    if not c and not o:
        return
    print("\n== online service ==", file=out)
    print(f"  ticks {c.get('service.ticks', 0):g}"
          f"  triggers {c.get('service.triggers', 0):g}"
          f"  admitted {c.get('service.admitted', 0):g}"
          f"  evicted {c.get('service.evicted', 0):g}"
          f"  quarantined {c.get('service.quarantined', 0):g}"
          f"  recovered {c.get('service.recovered', 0):g}", file=out)
    lat = o.get("service.trigger_to_target_ms")
    if lat:
        p99 = lat.get("p99", lat.get("p95", 0.0))
        print(f"  trigger-to-target  p50 {lat['p50']:.2f}  "
              f"p99 {p99:.2f}  max {lat['max']:.2f} ms "
              "(FFR activation budget 700 ms)", file=out)
    step = o.get("service.step_ms")
    if step:
        print(f"  batched tick       p50 {step['p50']:.2f}  "
              f"max {step['max']:.2f} ms", file=out)


# ---------------------------------------------------------------------------
# The sweep entry point (mirrors the E9 bench batch)
# ---------------------------------------------------------------------------


def sweep_telemetry(fast: bool = False, device="cuda",
                    hours: int | None = None) -> dict:
    """Run the E9-shaped sweep with ``telemetry=True`` on ``device``;
    returns the telemetry dict as numpy (288 scenario-days full, 1.5
    fast).  ``hours`` cuts the horizon (24 h full, 6 h fast)."""
    import repro_torch.core.engine as engine_lib
    from repro_torch import resolve_device
    from repro_torch.grid.scenarios import build_scenario_batch, product_specs
    from repro_torch.grid.signals import COUNTRY_ORDER

    dev = resolve_device(device)
    if fast:
        specs = product_specs(countries=("SE", "DE", "PL"), seeds=(0,),
                              horizon_h=hours or 6, products=("FFR",),
                              reserve_rhos=(0.0, 0.2), event_seeds=(0,))
    else:
        specs = product_specs(countries=tuple(COUNTRY_ORDER), seeds=(0, 1, 2),
                              horizon_h=hours or 24,
                              products=("FFR", "FCR-D"),
                              reserve_rhos=(0.0, 0.1, 0.2, 0.3),
                              event_seeds=(0, 1))
    batch = build_scenario_batch(specs, device=dev)
    cfg = engine_lib.EngineConfig(
        n_hosts=2, chips_per_host=2, e_max=24,
        events_per_day=24.0 if fast else 4.0, telemetry=True)
    with trace_lib.span("obs.sweep", n_scenarios=batch.n,
                        scenario_days=batch.n * int(batch.h_max) / 24.0,
                        **trace_lib.device_context()):
        out = engine_lib.engine_rollout(cfg, batch, device=dev)
        out = {k: _np(v) for k, v in out["telemetry"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--sweep", action="store_true",
                     help="run the 288-scenario-day E9 sweep with telemetry")
    src.add_argument("--telemetry", metavar="FILE",
                     help="render a saved telemetry dict (JSON)")
    src.add_argument("--trace", metavar="FILE",
                     help="render a host-side JSONL trace")
    ap.add_argument("--fast", action="store_true",
                    help="with --sweep: the 6 h smoke slice")
    ap.add_argument("--save", metavar="FILE",
                    help="with --sweep: also save the telemetry dict")
    ap.add_argument("--device", default="cuda",
                    help="with --sweep: the torch device to run on "
                         "(default cuda)")
    args = ap.parse_args(argv)
    if args.trace:
        render_trace(trace_lib.read_jsonl(args.trace))
        return 0
    if args.telemetry:
        render_telemetry(load_telemetry(args.telemetry))
        return 0
    tel = sweep_telemetry(fast=args.fast, device=args.device)
    if args.save:
        save_telemetry(tel, args.save)
        print(f"saved telemetry -> {args.save}")
    render_telemetry(tel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
