"""Serving launcher: batched prefill + decode with power-aware batching;
the port of ``repro.launch.serve``.

`python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 16`

Serves the reduced config on one card: prefill a batch of prompts by
teacher-forcing them through the decode step, then decode tokens step by
step.  An enc-dec arch (whisper-medium) first encodes a batch of frames
drawn from the run's generator and fills the cache's cross K/V from the
encoder's output.  With --gridpilot, an FFR trigger fired mid-decode sheds the token
budget (batch thinning) within one decode step -- the serving-side
analogue of the trainer's duty-cycle shed.

Instrumented with ``repro_torch.obs.trace``: prefill/decode are spans
(each ends after the device has finished its work), the
trigger-to-thinning path is a ``serve.ffr_response`` span whose wall time
is the serving-side trigger-to-target latency (compare against the 700 ms
FFR activation budget), and the shed itself is a traced ``serve.shed``
event.  ``run_serve`` returns the stats dict so tests can drive the full
path in-process; its ``cfg=`` serves another arch config (the full-width
one on a card) than the reduced default, and ``params=`` weights the
caller holds already (``Model.init(0)``'s when not given; yi-9b's f32
weights are 35 GB, so a caller that holds them passes them on).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.obs import trace


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--gridpilot", action="store_true")
    ap.add_argument("--island-port", type=int, default=47311,
                    help="UDP port for the GridPilot safety island")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serve(args, *, cfg=None, params=None, device="cuda") -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_arch(args.arch).reduced()
    model = build_model(cfg, compute_dtype=torch.float32, device=dev)
    if params is None:
        params = model.init(0)

    b, s = args.requests, args.prompt_len
    total = s + args.decode_tokens
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)

    gp = None
    if args.gridpilot:
        from repro_torch.core.controller import GridPilot
        gp = GridPilot(n_hosts=1, chips_per_host=1,
                       island_port=args.island_port, device=dev)
        gp.current_row = 23
        gp.island.arm(23)

    try:
        # prefill: warm the decode cache by teacher-forcing the prompt --
        # one pass over the prompt, no separate full forward whose logits
        # would be thrown away.
        t0 = time.perf_counter()
        with trace.span("serve.prefill", arch=args.arch, batch=b,
                        prompt_len=s):
            cache = model.init_cache(b, total)
            if cfg.family == "encdec":
                from repro_torch.models import encdec as encdec_lib
                frames = 0.02 * torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                            generator=gen, device=dev)
                with torch.no_grad():
                    enc = encdec_lib.encode(cfg, params, frames,
                                            dtype=torch.float32)
                    cache["xk"], cache["xv"] = \
                        encdec_lib.precompute_cross_kv(cfg, params, enc)
            for i in range(s):
                _, cache = model.decode_step(params, cache, tokens[:, i])
            _sync(dev)
        t_prefill = time.perf_counter() - t0

        outs = []
        shed_at = None
        response_ms = None
        t0 = time.perf_counter()
        cur = tokens[:, -1]
        active = b
        with trace.span("serve.decode",
                        steps=args.decode_tokens) as dec_attrs:
            for i in range(args.decode_tokens):
                if gp is not None and i == args.decode_tokens // 2:
                    with trace.span("serve.ffr_response",
                                    step=i) as resp_attrs:
                        gp.fire_test_trigger()
                        # bounded poll to the FFR activation budget: the
                        # span measures the real trigger-to-thinning time
                        # instead of a hard-coded 5 ms floor
                        deadline = time.perf_counter() + 0.7
                        plan = gp.poll_ffr()
                        while plan is None and \
                                time.perf_counter() < deadline:
                            time.sleep(0.0002)
                            plan = gp.poll_ffr()
                        if plan is not None:
                            active = max(1, int(b * plan.duty_cycle))
                            shed_at = i
                            resp_attrs["duty_cycle"] = plan.duty_cycle
                            resp_attrs["shed"] = True
                    if shed_at is not None:
                        # span wall time IS the trigger-to-thinning latency
                        rec = trace.get_tracer().spans(
                            "serve.ffr_response")[-1]
                        response_ms = rec["wall_s"] * 1e3
                        trace.event("serve.shed", step=i, batch_from=b,
                                    batch_to=active,
                                    duty_cycle=plan.duty_cycle,
                                    response_ms=response_ms)
                        trace.metrics.inc("serve.sheds")
                logits, cache = model.decode_step(params, cache, cur)
                cur = torch.argmax(logits, dim=-1)
                outs.append(cur[:active].cpu().numpy())  # waits for the step
            dec_attrs["batch_final"] = active
        t_decode = time.perf_counter() - t0
        trace.metrics.observe("serve.decode_ms_per_tok",
                              t_decode / args.decode_tokens * 1e3)

        print(f"prefill {b}x{s}: {t_prefill*1e3:.1f} ms; "
              f"decode {args.decode_tokens} steps: {t_decode*1e3:.1f} ms "
              f"({t_decode/args.decode_tokens*1e3:.2f} ms/tok)")
        if shed_at is not None:
            print(f"FFR shed at decode step {shed_at}: batch {b} -> "
                  f"{active} "
                  f"(token-budget thinning, {response_ms:.1f} ms "
                  "trigger-to-thinning)")
    finally:
        if gp is not None:
            gp.close()
    return dict(t_prefill_s=t_prefill, t_decode_s=t_decode,
                shed_at=shed_at, batch=b, active=active,
                response_ms=response_ms, device=str(dev))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_serve(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
