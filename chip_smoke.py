#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-only   # build and flash_attention only
    python3 chip_smoke.py --ssd-only     # build and ssd_scan only
    python3 chip_smoke.py --train-only   # build, flash_bwd, train, ssd_bwd,
                                         # train_ssm, train_fsdp, train_tp,
                                         # train_hybrid, train_cuts and
                                         # train_encdec/_vlm/_moe only

Phases, each printing one JSON line; any failure ends the run with a
nonzero exit and no result line:

  build       compile every CUDA kernel of the port with nvcc (sm_90a)
              into build/kernels/, one nvcc per source, all at once
  kernel      each kernel against its plain torch version on the card at
              the main path's shapes, with its device time and the plain
              version's taken with a cold L2 (inputs cycled through more
              than the L2 holds), and the least time the card could take
              for the work (the bound); pid_update's L2-warm time; for
              flash_attention the time of one PyTorch call computing the
              same function (scaled_dot_product_attention, a yardstick
              the port never calls), also at zamba2-2.7b's head dim 80,
              with the ratio to it, TFLOP/s, the share of the bound, the
              kernel's name, registers, shared memory and spills, and
              its earlier time; flash_attention also checked at the bf16
              kernel's edges at prefill length (ragged Sq, Sq > Sk,
              narrow windows, GQA group 6), and at the MoE, VLM and
              enc-dec families' calls: head dim 96 (phi-3-vision-4.2b's
              (2, 4096, 32, 32, 96), timed) and whisper-medium's
              non-causal encoder (2, 1500, 16, 16, 64) and cross (Sq 448
              against Sk 1500) calls, timed beside SDPA with
              is_causal=False;
              ssd_scan at the reference's test shapes, at the bf16
              kernels' edges (chunk 8-64, hd 16/32, ds 16/128) and at
              both full-width prefill calls (mamba2-1.3b, zamba2-2.7b) in
              f32 and bf16, against its plain version (bf16: a
              norm-relative error against the f32 plain version on the
              same inputs) and the sequential recurrence, with the device
              time of each of the bf16 path's three kernels and their
              launches per call (no PyTorch call computes the SSD scan)
  kernel_long flash_attention and ssd_scan at the registered long shapes'
              calls, the kernels' longest: attention at qwen2-1.5b's and
              yi-9b's prefill_32k calls (2, 32768, 12, 2, 128) and (1,
              32768, 32, 4, 128) and zamba2-2.7b's windowed (4,096) calls
              at 32,768 and 524,288 positions, and the other archs'
              prefill_32k calls: phi-3-vision-4.2b's (1, 32768, 32, 32,
              96), olmoe-1b-7b's (1, 32768, 16, 16, 128), the mixtral cut's
              (1, 32768, 48, 8, 128) window 4,096, whisper-medium's causal
              (1, 32768, 16, 16, 64) and non-causal cross (Sq 32,768, Sk
              1,500), smollm-135m's (2, 32768, 9, 3, 64);
              in f32 and bf16 against
              the plain version on three 512-row bands (the first rows, a
              middle band off the 128-row q-tiles against the keys it
              sees, the last rows; f32 2e-5, bf16 2e-2); the scan at
              mamba2-1.3b's and zamba2-2.7b's calls at 32,768 (128
              chunks) and 524,288 positions (2,048 chunks) against the
              plain version on 32,768-position segments chained through
              initial_state (f32 1e-4, bf16 1e-2 norm-relative); each
              call's cold-L2 device time, the plain version's over every
              band or segment, SDPA's where one call computes the same
              function (no window) and the bound
  tier1       the Tier-1 closed loop: pid_rollout_grid over the (4 targets
              x 3 loads) product, 32768 chips per cell (a ~10 MW site of
              300 W chips), 200 ticks = 1 s of the 200 Hz loop; counts the
              pid_update launches and checks that every cell settles to
              min(demand, target)
  prefill     Model.forward of qwen2-1.5b at full width (random weights
              from a seed, bf16 compute) on (2, 4096) tokens, last_only:
              ms per forward, peak memory, exactly 28 flash_attention
              launches, finite logits
  decode_vs_forward
              the same weights in f32 at B = 2, S = 64: teacher-forced
              decode_step logits against the full forward's (2e-3); for
              the SSM and hybrid families also a bf16 forward of the same
              weights, its last logits against the f32 forward's, held to
              1.25x the distance of the same bf16 forward through the
              kernels' plain versions (norm-relative; printed beside the
              tests' 2e-2)
  serve       run_serve at full qwen2-1.5b width, 8 requests, 32 prompt
              and 32 decode tokens, GridPilot on: the FFR shed at decode
              step 16 with its trigger-to-thinning time under 700 ms
  prefill_ssm, decode_vs_forward_ssm, serve (mamba2-1.3b)
              the same three at full mamba2-1.3b width and depth: exactly
              48 ssd_scan launches per forward; decode against forward at
              S = 256 (a multiple of the 256-token SSD chunk) on its first
              64 positions (the cut printed: 256 host-bound steps at 48
              layers took ~22 s)
  prefill_hybrid, decode_vs_forward_hybrid
              zamba2-2.7b at full width and depth: exactly 54 ssd_scan and
              9 flash_attention launches per forward; decode against
              forward at S = 256 on its first 64 positions (~32 s for all
              256 at 54 layers)
  prefill_moe olmoe-1b-7b at full width and depth (bf16 over f32, (2,
              4096) tokens, last_only): exactly 16 flash_attention
              launches, the slots its capacity drops per layer; then
              mixtral-8x22b at full width cut to 2 of its 56 layers on
              (1, 8192) tokens, so that its 4096 window masks: exactly 2
              launches, the cut printed as "reduced"
  decode_vs_forward_moe, serve (olmoe-1b-7b)
              olmoe in f32: teacher-forced decode against the forward
              (2e-3) on every position of a (1, 4) call (no slot can
              drop) and on the drop-free prefix of a (2, 64) call (its
              length and the dropped slots printed); each decode step
              takes the forward's picks of its token, the slots whose own
              pick differed counted; run_serve as for qwen2-1.5b
  prefill_vlm phi-3-vision-4.2b at full width and depth: 576 image
              embeddings and 3,520 tokens, 4,096 positions: exactly 32
              launches
  prefill_encdec, decode_vs_forward_encdec, serve (whisper-medium)
              whisper-medium at full width and depth, (2, 1500, 1024)
              frames and (2, 448) tokens: exactly 72 launches (24
              non-causal encoder, 24 causal decoder, 24 non-causal cross);
              in f32 at S = 64, teacher-forced decode after encode and
              precompute_cross_kv against decode_train (2e-3); run_serve,
              its frames encoded into the cache's cross K/V first
  prefill_32k the registered 32,768-position prefill, bf16, last_only, on
              the weights of the prefill phases: qwen2-1.5b and
              mamba2-1.3b at 2 rows, zamba2-2.7b at 1 (printed as the cut
              from the registered 32): exactly 28 flash_attention, 48
              ssd_scan, 54 ssd_scan + 9 flash_attention launches, finite
              logits, ms and peak memory of a first forward, a second
              one's ms and a third's device ms under the profiler; then
              (printed after serve (whisper)) olmoe-1b-7b (16 launches, the
              slots its capacity drops per layer), the mixtral cut (2),
              phi-3-vision-4.2b (576 embeddings + 32,192 tokens, 32),
              whisper-medium (32,768 decoder tokens beside (1, 1500, 1024)
              frames, 72) at 1 row and smollm-135m at 2 (its own weights,
              30)
  long_500k   the registered 524,288-position shape (sub_quadratic archs,
              one row): a bf16 forward of mamba2-1.3b and zamba2-2.7b at
              full depth (the same launches, finite logits, ms, peak
              memory); then 12 decode steps from cur 524,280 of
              mamba2-1.3b, zamba2-2.7b (its shared attention a 4,096-slot
              ring) and the mixtral-8x22b cut (2 layers, window 4,096),
              the cache seeded in the state a 524,280-token prompt leaves
              (the ring's slots with their pos_buf): each step's bf16
              logits against an f32 step on the same values and token,
              norm-relative, within a fixed limit per arch
              (LONG_BF16_LIMIT: bf16 compute alone moves full-depth
              random-weight logits 2-8 %), which the same weights' step
              on a shallow 64-position cache also meets; the ring's
              pos_buf after the wrap
  yi9b        yi-9b at full width and depth (48 layers, its 35 GB of f32
              weights drawn once): prefill_32k at (1, 32768) (48
              launches, finite logits), decode against forward in f32 at
              S = 64 (2e-3), run_serve with its FFR shed under 700 ms
  decode_32k  decode steps against a full 32,768-position bf16 cache of
              seeded K/V (pos_buf 0..32,766, cur 32,767): qwen2-1.5b at 32
              rows, yi-9b at 8 (the cut from the registered 128 printed);
              ms a token, the cache's bytes and the bytes a step must read
              over 3.35 TB/s; row 0's bf16 logits against an f32 step on
              the same values, gated as long_500k's
  flash_bwd   flash_attention's two backward wrappers (flash_bwd_dq,
              flash_bwd_dkdv; in bf16 the wgmma kernels and, when the GQA
              group is split, flash_bwd_dkdv_sum) against autograd through
              the plain version (f32 1e-4, bf16 2e-2) at qwen2-1.5b's
              prefill call (2, 4096, 12, 2, 128) and training call (2,
              2048, ...) bf16 causal, zamba2-2.7b's training call (1, 2048,
              32, 32, 80) and at small and odd shapes (head
              dims 64, 80 and 96, windows, S not a multiple of 64, Sq >
              Sk), phi-3-vision-4.2b's training call (1, 2048, 32, 32, 96)
              and whisper-medium's non-causal encoder and cross calls
              (Sk 1500, each timed beside SDPA's backward),
              every case run twice and held to bitwise equality, the
              forward's LSE against the plain one, SDPA's backward's own
              error at the prefill call (printed, not a gate); at both
              calls each wrapper's cold-L2 device time per call (the sum
              of its kernels), TFLOP/s and share of its bound (3 and 4
              products over the visible pairs; the pair's 5 products are
              257.7 GFLOP, 0.261 ms at the prefill call), the split used,
              SDPA's backward (the yardstick) and at the prefill call the
              plain version's backward; the kernels' registers, shared
              memory and local memory as the CUDA runtime reports them,
              failing on local memory (a spill) in a bf16 kernel at D =
              96 or 128, and ptxas' report when this process ran nvcc
  train       the Trainer at full qwen2-1.5b width and depth (bf16 compute
              over f32 parameters, remat "dots", AdamW on the card) for 8
              steps of (2, 2048) tokens with a GridPilot attached and an
              FFR trigger after step 3: fails unless every loss is finite,
              steps were shed with an ffr_shed event, and each run step
              launched the attention forward 56 times (twice per layer
              under "dots") and each backward kernel 28 times; ms per
              step, tokens/s, peak memory, one profiled step's device time,
              busy share and top kernels; a 2-layer cut through the kernels
              against the plain versions (bf16: 2e-2 norm-relative per leaf;
              f32: 1e-4 per leaf; the plain versions in float64 beside
              them);
              smollm-135m at full width checkpointed after 4 steps and
              restarted to 6 against an unbroken run (1e-5)
  train_dp    the int8-compressed data-parallel step
              (build_step_bundle(mesh=make_local_mesh(), compressed=True))
              at full qwen2-1.5b width and depth on a world of one on
              NCCL, bf16 over f32, remat "dots", 4 steps of (2, 2048):
              fails unless every loss is finite, each step launched the
              attention forward 56 times and each backward kernel 28, and
              each step issued 2 all-reduces a parameter leaf (the
              scale's MAX, the int32 counts' SUM) and 4 means (loss, ce,
              zloss, aux); ms per step and tokens/s beside the train
              phase's, peak memory, one profiled step's device time and
              busy share, the all-reduce bytes a step; a 2-layer cut in
              f32 on the card against the same cut on the CPU (plain
              versions, a gloo group) after 2 steps: loss and gradient
              norm 1e-4; each residual element within one shared scale
              and each weight within two AdamW steps (the quanta), plus
              1e-4 of its leaf's largest value; at most 1e-3 of the
              payload's elements a quantum off (counted)
  ssd_bwd     ssd_scan's backward (ssd_scan_bwd: bf16 ssd_bwd_tc_states,
              _pass, _chunk, _bc, _sum on the tensor cores; f32
              ssd_bwd_chunk_state, _state_pass, _chunk, _sum) against its
              plain version
              (ssd_scan_bwd_ref) and autograd through ssd_scan_ref, f32
              1e-4 of each gradient's scale (its norm and its largest
              element) and bf16 norm-relative within 1.25x the plain
              version's own bf16 error from the f32 inputs' gradient, at
              mamba2-1.3b's and zamba2-2.7b's training calls (1, 2048, 64,
              64, 128) and (1, 2048, 80, 64, 64), mamba2's prefill call
              and small and odd shapes (chunks 8-256), every case twice
              and bitwise equal; the tensor-core kernels' registers and
              local memory from the CUDA runtime (fails on a spill or on
              fewer than two blocks an SM at ds 128); the cold-L2 device
              time per kernel at those three calls beside the bound, the
              plain version's and the earlier f32-FMA kernels' (no
              PyTorch call computes the scan or its gradient)
  train_ssm, train_hybrid
              the train phase's Trainer at full mamba2-1.3b and zamba2-2.7b
              width and depth (their plan: remat "dots", 4 microbatches)
              for 4 steps of (4, 2048) tokens, an FFR trigger after step
              1: fails unless every loss is finite, steps were shed, and
              each step launched the scan's forward twice per Mamba-2
              layer and microbatch, its backward once (and zamba2's shared
              attention once each way per block and microbatch); ms per
              step, tokens/s, peak memory, one profiled step's busy share;
              the train phase's 2-layer cut (the hybrid's with one shared
              block) on one microbatch; in the hybrid's, a leaf whose bf16
              gradient is ill-conditioned (the plain versions' bf16
              gradient more than 2e-2 from float64, and rounding the
              weights alone to bf16 moving their f32 gradient more than
              2e-2) may miss 2e-2 if every backward kernel call of the
              cut's bf16 step lies within 1e-2 of its plain version on
              the call's own inputs (per gradient, norm-relative)
  train_fsdp  the sharded training state (after train_ssm): (a) the
              Trainer at full mamba2-1.3b width and depth on
              make_local_mesh() -- a world of one on NCCL, (1, 1) -- its
              parameters and moments DTensors placed by the fsdp_tp plan,
              for 3 steps of train_ssm's (4, 2048) tokens in 4
              microbatches: fails on a non-finite loss, on other than 384
              / 192 scan launches a step, on resident bytes other than
              the shards' by placement, or on losses more than 2e-2 from
              train_ssm's at the same steps (same seed and tokens); ms a
              step against train_ssm's (the DTensor path's host cost),
              peak memory, the collectives' bytes and seconds; (b) two
              worker processes of this script sharing the card on gloo
              under the REPRO_* contract, a (data 2, model 1) mesh,
              mamba2-1.3b at full width cut to 2 layers, a global batch of
              (8, 2048) in 4 microbatches, in bf16 and in f32: 4
              replicated steps past the warm-up (ids 146-149, lr 3e-4)
              give both runs nonzero moments and moved weights, then
              step 150 runs sharded and replicated from that state (cut
              from steps 150 and 151 for the run time, printed in
              `reduced`); fails unless each rank's resident bytes equal
              its shards' by placement, every loss is finite, and the
              loss, grad norm and every leaf after the step meet one
              process's replicated step on the same global batch (f32
              1e-4 norm-relative per leaf, the parameters' change too;
              bf16 2e-2); the collectives are
              torch.distributed's
              on CUDA tensors over gloo (DTensor's own redistribution
              faults there on torch 2.11), their bytes and seconds
              printed
  train_tp    tensor parallelism (after train_fsdp): for each of
              mamba2-1.3b and yi-9b (both at once) two worker processes
              of this script sharing the card on gloo under the REPRO_*
              contract, a (data 1, model 2) mesh, full width cut to 2
              layers, (8, 2048) in 4
              microbatches, bf16 and f32: 4 replicated steps warm the state
              (ids 146-149), then steps 150 and 151 run tensor-parallel --
              each rank its 32 of 64 scan heads, or its 16 query and 2 kv
              heads, its MLP and vocabulary columns -- and replicated;
              fails unless every loss is finite, the losses, grad norms and
              every leaf meet train_fsdp (b)'s gates, each rank's resident
              bytes are its shards', every flash_attention / ssd_scan call
              and backward ran at the rank's head count as often as the
              plan launches them, the kernels at those shapes meet their
              plain versions (and the scan backward's float32 dB and dC
              round to its bf16 ones), and each rank's matmul FLOPs are at
              most 0.55x the replicated step's; prints the ms, device and
              GEMM time a step (the four ranks time-slice the card), the
              forward products' time at a rank's widths with the card to
              itself, and the all-reduce, all-gather and reduce-scatter
              bytes and seconds
  train_cuts  one step's loss and gradient at full width, 2 layers (and
              2 encoder layers), through the kernels and through the plain
              versions, every leaf held at 2e-2 norm-relative in bf16 and
              1e-4 in f32, each kernel's launches enforced: olmoe-1b-7b
              on (1, 2048) tokens (no remat; the plain run takes the
              kernels' run's picks, the slots whose own pick differed
              printed), phi-3-vision-4.2b on 576 embeddings and 1,472
              tokens (the D = 96 backward), whisper-medium on (1, 448)
              tokens and (1, 1500, 1024) frames (the non-causal backward)
  train_encdec, train_vlm, train_moe
              the train phase's Trainer for the enc-dec, VLM and MoE
              families under their configs' plan: whisper-medium at full
              depth on (4, 448) tokens and (4, 1500, 1024) frames (1
              microbatch, its attention not under remat), phi-3-vision-4.2b
              at full depth on (4, 2048) (576 embeddings and 1,472 tokens a
              row; 4 microbatches, remat "dots"), olmoe-1b-7b at 8 of its
              16 layers on (4, 2048) (4 microbatches, remat "dots"; 16
              layers are 110.8 GB of f32 state, printed in "reduced"); 3
              steps (cut from 4 for the run time), an FFR trigger after
              step 1 shedding step 2: fails unless every loss
              is finite, steps were shed, each kernel launched as the plan
              says, and the step-0 loss lies within 2e-2 of the step's
              loss of the same batch and initial weights through the plain
              versions (no gradient, bf16); ms a step, peak memory, one
              profiled step's busy share
  The phases engine to e8 below are host-bound: they run in four
  processes of this script (--host-group 0: engine, reserve; 1: mesh,
  service; 2: bidding, fr_latency, e8, cpu_vs_gpu; 3: sweep,
  tier1_bench, twin; three groups ran 122-133 s beside a 72 s build on a
  fast host) started beside the build, and their records are printed
  when they are joined, before kernel, followed by
  host_groups each group's phases and seconds, and the wait for them

  engine      engine_rollout(reduce="summary") on the full E9 batch (288
              scenarios, 6 countries x 3 seeds x 2 products x 4 bands x 2
              event draws) over 24 h, or the longest whole number of hours
              the time budget allows (printed as a cut); then 100 ticks of
              engine_step with the host-sync detector set to raise
  cpu_vs_gpu  6 scenarios over 1 h on the CPU and on the card, with the
              same frequency, demand and plant-noise inputs
  sweep       engine_sweep over the 6 E9-fast specs in chunks of 5 against
              the monolithic rollout
  mesh        the reference's distributed smoke on one card: two worker
              processes of this script under the REPRO_* contract on
              localhost (a gloo group: the ranks share the card) each
              sweep their process_slice with engine_sweep(chunk_size=8,
              mesh="auto", finalize=False) -- 36 scenario-days of hourly
              tiers, and the seconds tier (telemetry on) on 6 of them cut
              to 1 h; fails unless each worker counted only its slice, the
              slices cover the specs and the merged aggregates meet the
              single-process sweep (hourly rtol 1e-4 / atol 1e-5; seconds
              1e-3, RLS 2e-2, counts exact); then engine_rollout over two
              lanes of the card (6 scenarios) against mesh=None; each
              worker's seconds and backend
  bidding     the reference bidding bench's three arms on its fast E9 slice
              (SE/DE/PL, FFR, bands 0/0.2, event draw 0; 6 h cut to 2 h):
              the
              price-blind and price-aware Tier-3 grid searches and
              bids_for_batch (n_ens 8, n_iter 48), all settled by one
              engine_rollout(ops=...) on a stacked copy of the slice per
              arm; fails unless every bid lies inside the floor and the
              box, the incumbent never falls below the grid search on its
              own ensemble and the settlement commits the bid; prints the
              bid arm's net against the price-aware grid's (the reference
              bench's gate, not enforced: see PERF.md); then
              optimize_bids alone over the full E9 batch
              (288 x 24 = 6,912 scenario-hours): ms, device time and
              kernel launches per opt step, device busy share
  service     the reference service bench: 1,024 sites (FFR and FCR-D)
              admitted over a 24 h horizon, churn (32 out, 32 in, a
              trigger storm, a quarantine pattern), then LoadGen's 600
              timed ticks (bulk feed, Poisson FFR arrivals, storms of 64):
              ticks/s, ms per tick, p50/p99 trigger-to-target, the device
              time and kernels of one CUDA-graph replay beside an eager
              tick's; fails unless p99 < 700 ms, the tick was captured
              once, RSS grew < 64 MB and device memory not at all over the
              window, and 10 captured ticks equal 10 eager ticks of the
              same state bit for bit

  tier1_bench E2 and E4 of the paper (benchmarks/e2_step_response.py,
              e4_closed_loop.py): the settle medians of the 280 -> 200 W
              cap step per workload, then the 30 s closed loop at 200 Hz
              (3 chips x 3 seeds per workload), the tracking error beside
              the paper's; fails unless inference and matmul track inside
              the 5 % band and bursty above it, unless pid_update
              launched exactly once per tick, and unless bursty's loop
              run again through pid_update's plain version gives the same
              host-power traces and tracking errors
  fr_latency  E7 (benchmarks/e7_fr_latency.py): 90 FFR triggers through the
              port's SafetyIsland on UDP, trigger-to-caps wall time plus
              the plant's settle on the card; fails unless 90/90 are under
              the 700 ms budget; then the contrast arm, PythonSupervisor
              under AllocationChurn (printed, not enforced)
  twin        Fig. 4 (benchmarks/cluster_24h.py): 100 hosts x 3 chips on the
              DE grid, seeds 0-2 as one run_twin_batch over 24 h or the
              longest whole number of hours the phase's 25 s allow
              (printed as a cut): scenario-seconds per wall second, ms per
              tick, one tick's device time and launches, peak memory, seed
              0's summary beside the paper's, the net-CO2 decomposition at
              50 MW for CH/IT/DE, and 1 h of seed 0 on the CPU and on the
              card with the same inputs
  reserve     E9's separate replay: reserve_replay_batch over the full E9
              batch (288 x 24 h), 8 lanes against the per-event oracle,
              the event counts against the engine phase's, then
              report.sweep_telemetry(fast=True, hours=2) rendered
  e8          E8 (benchmarks/e8_multicountry.py, paper Fig. 5 with E9's
              PUE design axis): the full 144-scenario x 672 h batch on the
              card in one batched sweep, its median time and scenarios/s,
              the headline (drag closed, delta per grid and MW, E9's drag
              per design) beside the paper's 2.5-5.8 pp (not enforced);
              the fast batch on the CPU and on the card (totals and CFE
              rtol 1e-3, pp 1e-3, picks equal but for near-ties)

  dryrun      (started after ssd_bwd, in two CPU processes beside the
              train phases; read last) python -m repro_torch.launch.dryrun
              --mesh single for mamba2-1.3b x train_4k and qwen2-1.5b x
              decode_32k: one step each as rank 0 of a fake 256-rank
              world on meta tensors; fails unless both exit 0 with status
              ok; their records printed

Then a run_time line (the build's and the whole run's seconds), a
{"kernels": [...]} line, the card's name and power limit as
nvidia-smi reports them, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_BYTES = 50 * 2**20              # H100 SXM, where torch does not report it
# wall time the 24 h rollout may spend (cut from 150 s, then 100, then 70,
# then 60, then 45, then 30, to make room for the later phases; the
# horizon it allows is printed as a cut)
ENGINE_BUDGET_S = 30.0
KERNEL_TOL = dict(atol=1e-4, rtol=1e-5)
# E4's closed loop through pid_update against the same loop through its
# plain version: a 1-ulp change of every tick's PID outputs moves the
# 30 s host-power traces by at most 9.2e-4 W and the tracking errors by
# 2.3e-5 % (CPU runs of experiments.e4_trace_batch), so these hold a
# 10x margin and still catch a wrong gain, clamp or branch.
E4_TRACE_TOL = dict(atol=1e-2, rtol=1e-5)
E4_ERR_ATOL_PCT = 1e-3
TENSOR_CORE_BF16_FLOP_S = 989e12   # H100 SXM data sheet, dense
FP32_FLOP_S = 67e12                # H100 SXM data sheet, outside tensor cores
# flash_attention against its plain version: the reference's kernel
# tolerances (tests/test_kernels.py), f32 held to 1e-4 at S >= 1000
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FLASH_TOL_LONG_F32 = dict(atol=1e-4, rtol=1e-4)
PREFILL_SHAPE = (2, 4096, 12, 2, 128)    # qwen2-1.5b's heads at S = 4096
ZAMBA2_ATTN_SHAPE = (2, 4096, 32, 32, 80)  # zamba2-2.7b's shared block
PHI3_ATTN_SHAPE = (2, 4096, 32, 32, 96)    # phi-3-vision-4.2b's prefill
WHISPER_ENC_SHAPE = (2, 1500, 16, 16, 64)  # whisper-medium's encoder
# its cross-attention: 448 decoder rows (its context) against Sk = 1500
WHISPER_CROSS_SHAPE, WHISPER_CROSS_SK = (2, 448, 16, 16, 64), 1500
# flash_attention's bf16 time at those two calls by head dim, from an
# earlier call of this script on another card (the earlier mma.sync kernel,
# NVIDIA H100 80GB HBM3, 700 W): only the ratio to the library call
# timed in the same run compares across cards
FLASH_PREV_MS = {128: 0.924, 80: 1.372}
# ptxas' report of flash_fwd_tma before its PTX helpers moved into
# csrc/hopper.cuh (an earlier call of this script): the move must leave it
FLASH_PREV_PTXAS = {128: "Used 188 registers, used 16 barriers",
                    80: "Used 162 registers, used 16 barriers"}
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_models.py
# decode_vs_forward_ssm and _hybrid: the f32 forward at S = 256 (one SSD
# chunk), teacher-forced decode at full depth on its first 64 positions
# (each step is host-bound, one step a layer: 256 steps at 48 and 54
# layers took ~22 and ~32 s)
DECODE_SSM_STEPS = 64
# olmoe-1b-7b's decode-vs-forward calls: (1, 4) cannot drop a slot (one
# group of 4 tokens, capacity 4), (2, 64) may from position 0 on
MOE_DECODE_CALLS = ((1, 4), (2, 64))
# mixtral-8x22b's prefill: full width, 2 of its 56 layers (21.6 GB of f32
# weights), on (1, 8192) tokens so that its 4096 window masks
MIXTRAL_CUT_LAYERS = 2
MIXTRAL_PREFILL_SHAPE = (1, 8192)
WHISPER_PREFILL_SHAPE = (2, 448)   # decoder tokens: whisper's context
# ssd_scan: the reference's kernel tolerances (tests/test_kernels.py)
SSD_TOL = {"chunked": dict(atol=1e-4, rtol=1e-4),
           "oracle": dict(atol=5e-4, rtol=5e-3),
           "bfloat16": dict(atol=0.15, rtol=0.1)}
# the bf16 path (three kernels) against the f32 plain version on the same
# bf16 inputs, ||y - y_plain|| / ||y_plain||
SSD_BF16_REL = 1e-2
# (b, s, nh, hd, ds, chunk) of the prefill's calls at (2, 4096) tokens
SSD_PREFILL = {"mamba2-1.3b": (2, 4096, 64, 64, 128, 256),
               "zamba2-2.7b": (2, 4096, 80, 64, 64, 256)}
# ssd_scan's bf16 time at those calls, from an earlier call of this script
# on another card (the one-block-per-(b, head) f32-FMA kernel before the
# chunk-parallel redesign, NVIDIA H100 80GB HBM3, 700 W)
SSD_PREV_MS = {"mamba2-1.3b": 3.136, "zamba2-2.7b": 3.139}
# a bf16 forward against the f32 forward of the same weights, norm-relative
# on the last logits: the SSM families' bf16 gate of
# tests/test_torch_models.py, printed beside the distance of the same bf16
# forward with the kernels' plain versions (at full depth with random
# weights bf16 compute alone misses 2e-2); the kernels' bf16 forward is
# held to 1.25x that distance, the tests' SSM_BF16_VS_REF_NOISE
SSM_BF16_REL = 2e-2
SSM_BF16_VS_PLAIN = 1.25
# the reference's gates: benchmarks/bidding_bench.py, service_bench.py
BIDDING_MIN_NET_EUR_GAIN = 0.0   # bid arm's net over the price-aware grid
SERVICE_MAX_P99_MS = 700.0       # FFR activation budget
SERVICE_MAX_RSS_GROWTH_MB = 64.0
PROFILED_STEPS = 8               # opt steps in the bidder's profiled run
# the paper's experiments (benchmarks/e2, e4, e7, cluster_24h, e9)
FR_LATENCY_PORT = 47661          # UDP port of fr_latency's island
TWIN_BUDGET_S = 25.0             # wall time of the whole twin phase (was 55)
SLICE_HOURS = 2                  # the fast E9 slice's 6 h, in bidding and
                                 # reserve's report: its seconds tier settles
                                 # at about 3.5 ms a tick
TWIN_SEEDS = (0, 1, 2)
TWIN_PAPER = {"ar4_mae_norm": 0.036, "ar4_p95_norm": 0.09, "q_ffr": 1.0,
              "mean_mu_green": 0.90, "mean_mu_dirty": 0.40,
              "mean_rho": 0.2}
CO2_PAPER_PCT = {"CH": 21, "IT": 20, "DE": 26}
TWIN_TOL = {"energy": 1e-3, "rls": 2e-2}
RESERVE_ORACLE_LANES = 8
RESERVE_FLOAT_RTOL = 1e-3


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's record also gets ``t_s``, this process's
    seconds since it started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def cuda_time_ms(torch, fn, reps=100):
    """Median device time of one call of ``fn`` over ``reps`` calls, each
    between its own pair of CUDA events."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_calls(torch, fn, reps, match=(), groups=None, require=(),
                  once=False, warm=True):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI): device time
    and kernel launches per call, the device time per call and per launch
    of the kernels whose name holds each string of ``match`` (the latter
    does not move when CUPTI drops an event of the window), for each
    label of ``groups`` the device time per call of the kernels whose
    base name (``kernel_base``) is one of its names, each kernel's mean
    per launch times its launches per call rounded, and the five ops with
    the most host time (inflated by the profiler; for ranking only).  A
    window is taken again (six at most) where CUPTI lost so many events
    that the rounded time per call reads zero, where a grouped kernel's
    events were mostly lost, or where a group of ``require`` has no
    kernel in it.  With ``once`` (each grouped kernel launches once a
    call) a group's time per call is its kernels' means per launch, which
    CUPTI's dropped events do not move, and a window is taken again only
    where it holds no device time or a group of ``require`` no kernel.
    Under start_host_groups the windows of the groups' processes take
    turns (PROFILE_LOCK_ENV).  ``warm=False`` skips the call before the
    first window (a call that took seconds has warmed it already)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import kernel_base
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    def whole(kernels):
        # device time in the window, per call once the rounding drops what
        # CUPTI lost, and no grouped kernel mostly lost
        if once:
            return sum(dev_us(e) for e in kernels) > 0
        return sum(dev_us(e) / max(e.count, 1) * round(e.count / reps)
                   for e in kernels) > 0 and not any(
            e.count and not round(e.count / reps) for e in kernels
            if any(kernel_base(e.key) in n for n in (groups or {}).values()))

    def seen(kernels, names):
        return any(kernel_base(e.key) in names for e in kernels)

    def windows(fn):
        # CUPTI now and then delivers no device events, or drops most of
        # a kernel's: a window where a group's kernels are missing is taken
        # again (three in a row once lost flash_bwd's whisper cross call)
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    fn(i)
                torch.cuda.synchronize()
            ev = prof.key_averages()
            kernels = [e for e in ev if e.device_type == cuda]
            if whole(kernels) and all(seen(kernels, groups[label])
                                      for label in require):
                return ev, kernels
        raise RuntimeError("the profiler recorded no device time, or none "
                           "of a group's kernels, in six windows")

    if warm:
        fn()
    torch.cuda.synchronize()
    lock = os.environ.get(PROFILE_LOCK_ENV)
    if lock:
        import fcntl
        held = open(lock, "a")
        fcntl.flock(held, fcntl.LOCK_EX)
    try:
        ev, kernels = windows(fn)
    finally:
        if lock:
            held.close()            # releases the lock
    top = sorted((e for e in ev if e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    return {
        "device_us_per_call": sum(dev_us(e) for e in kernels) / reps,
        # each kernel's mean per launch times its launches per call
        # rounded, which a dropped event does not move
        "rounded_us_per_call": sum(
            dev_us(e) / max(e.count, 1) * round(e.count / reps)
            for e in kernels),
        "matched_us_per_call": {m: sum(dev_us(e) for e in kernels
                                       if m in e.key) / reps
                                for m in match},
        "matched_us_per_launch": {
            m: sum(dev_us(e) for e in kernels if m in e.key)
            / max(sum(e.count for e in kernels if m in e.key), 1)
            for m in match},
        "group_us_per_call": {
            label: sum(dev_us(e) / max(e.count, 1)
                       * (1 if once else round(e.count / reps))
                       for e in kernels if kernel_base(e.key) in names)
            for label, names in (groups or {}).items()},
        "group_kernels": {
            label: sorted({kernel_base(e.key) for e in kernels
                           if kernel_base(e.key) in names})
            for label, names in (groups or {}).items()},
        "matched_launches_per_call": {
            m: sum(e.count for e in kernels if m in e.key) / reps
            for m in match},
        "launches_per_call": sum(e.count for e in kernels) / reps,
        "kernels": {e.key[:60]: dev_us(e) / max(e.count, 1)
                    for e in sorted(kernels, key=dev_us, reverse=True)[:5]},
        "top_host_ops_us": {e.key: e.self_cpu_time_total / reps
                            for e in top},
    }


def cycled(sets, f, kept):
    """A call of ``f`` on the next of ``sets`` each time (the cold-L2
    pattern), its output kept alive so the allocator cannot hand back
    lines still in L2."""
    turn = itertools.count()

    def call(_i=0):
        kept.append(f(*sets[next(turn) % len(sets)]))
    return call


def l2_bytes(torch) -> int:
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   L2_BYTES)


def all_finite(torch, tree) -> bool:
    if isinstance(tree, dict):
        return all(all_finite(torch, v) for v in tree.values())
    if isinstance(tree, tuple):
        return all(all_finite(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return bool(torch.isfinite(tree).all())
    return True


def demangle(raw):
    """flash_fwd_tma<128> for the mangled name of that instantiation (through
    c++filt; the mangled name where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt"], input=raw, capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return raw
    name = out.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ") or raw


def ptxas_by_kernel(log):
    """ptxas -v's report of one library, per entry function: its lines on
    registers, shared memory and spills."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = demangle(m.group(1))
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.replace("ptxas info    :", "").strip())
    return out


def phase_build():
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    paths = _build.build_all(names)
    ptxas = {k: ptxas_by_kernel(v) for k, v in _build.PTXAS_REPORT.items()}
    emit({"phase": "build", "kernels": names,
          "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), ROOT)
                        for k, v in paths.items()},
          "ptxas": ptxas, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})
    return time.perf_counter() - t0


def phase_kernel(torch):
    from repro_torch.core.pid import GAINS
    from repro_torch.kernels import pid_update as pk
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for n in (7, 9, 1024, 2500, 393_216):
        def u(lo, hi):
            return lo + (hi - lo) * torch.rand(n, device="cuda",
                                               generator=g)
        args = (u(100, 300), u(50, 310), u(30, 95), u(-60, 60), u(-50, 50))
        got = pk.pid_update(*args, GAINS)
        want = pk.pid_update_ref(*args, GAINS)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **KERNEL_TOL)
        worst = max(worst, err)
        rows.append({"n": n, "max_abs_err": err})
    launch_ms = cuda_time_ms(torch, lambda: pk.pid_update(*args, GAINS))
    plain_launch_ms = cuda_time_ms(
        torch, lambda: pk.pid_update_ref(*args, GAINS))
    n = args[0].numel()
    # Cold-L2 device time, to match the HBM bound: each call reads the
    # next of enough input sets that four L2s of traffic pass between two
    # reads of one set, and writes fresh outputs (kept alive, so the
    # allocator cannot hand back lines still in L2).
    k = math.ceil(4 * l2_bytes(torch) / (32 * n))
    sets = [tuple(torch.rand(n, device="cuda", generator=g) * 100 + 100
                  for _ in range(5)) + (GAINS,) for _ in range(k)]
    kept = []
    prof_k = profile_calls(torch, cycled(sets, pk.pid_update, kept), 100)
    kept.clear()
    prof_p = profile_calls(torch, cycled(sets, pk.pid_update_ref, kept),
                           100)
    kept.clear()
    prof_w = profile_calls(torch, lambda i=0: pk.pid_update(*args, GAINS),
                           100)
    ms = prof_k["device_us_per_call"] / 1e3
    plain_ms = prof_p["device_us_per_call"] / 1e3
    bound_ms = 32.0 * n / HBM_BYTES_PER_S * 1e3
    rec = {"name": "pid_update", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/pid_update.cu",
           "replaces": "src/repro/kernels/pid_update.py:75",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
           "n": n}
    emit({"phase": "kernel", "name": "pid_update", "checks": rows,
          "tol": KERNEL_TOL, "n": n, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": "bytes", "cold_sets": k,
          "l2_warm_ms": prof_w["device_us_per_call"] / 1e3,
          "launch_ms": launch_ms, "plain_launch_ms": plain_launch_ms,
          "plain_launches_per_call": prof_p["launches_per_call"],
          "library": "no single PyTorch call computes this function"})
    return rec


def phase_tier1(torch):
    import repro_torch.core.pid as pid
    import repro_torch.core.plant as plant
    from repro_torch.kernels.pid_update import pid_update
    targets_w, loads = (120.0, 180.0, 240.0, 300.0), (0.6, 0.8, 0.97)
    S, H, n, T = len(targets_w), len(loads), 32_768, 200
    dev = torch.device("cuda")

    def grid(x):
        return x.expand(S, H, n).contiguous()

    st = pid.PIDState(*(grid(x) for x in pid.init_pid(n, 250.0,
                                                      device=dev)))
    p0 = plant.init_plant(n, cap=300.0, device=dev)
    pl = plant.PlantState(**{k: grid(v) for k, v in vars(p0).items()})
    tg = torch.tensor(targets_w, device=dev)[:, None, None, None].expand(
        S, H, T, n)
    ld = torch.tensor(loads, device=dev)[None, :, None, None].expand(
        S, H, T, n)
    # warm-up on the first ticks (first launches of each op), not counted
    pid.pid_rollout_grid(st, pl, tg[:, :, :5], ld[:, :, :5], device=dev)
    torch.cuda.synchronize()
    pid_update.launches = 0
    t0 = time.perf_counter()
    _, _, trace = pid.pid_rollout_grid(st, pl, tg, ld, tau_ms=6.0,
                                       device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pid_update.launches
    if launches != T:
        raise RuntimeError(f"pid_update launched {launches} times in "
                           f"{T} ticks")
    final = trace[:, :, -1, :]
    demand = plant.power_model(plant.F_NOMINAL,
                               torch.tensor(loads, device=dev))
    expect = torch.minimum(demand[None, :],
                           torch.tensor(targets_w, device=dev)[:, None])
    torch.testing.assert_close(final, expect[:, :, None].expand_as(final),
                               rtol=0.02, atol=4.0)
    tail = (trace[:, :, -20:, :] - final[:, :, None, :]).abs().max()
    if float(tail) >= 4.0:
        raise RuntimeError(f"Tier-1 cells still move {float(tail)} W")
    emit({"phase": "tier1", "cells": [S, H], "chips_per_cell": n,
          "ticks": T, "launches": launches,
          "settled_w": final[:, :, 0].tolist(),
          "expect_w": expect.tolist(), "ms_per_tick": wall / T * 1e3,
          "wall_s": wall})
    return launches


def flash_cases():
    """(shape (B, S, H, Hkv, D), dtype name, window, Sk or None for Sk = S,
    causal) of the kernel check: the reference's test shapes in both
    dtypes, its windows, the padded head_dim-128 GQA case, the prefill
    shape and zamba2-2.7b's shared block (head dim 80, window 4096); then
    the bf16 TMA kernel's edges at prefill length: Sq not a multiple of
    its 128-row q-tile, Sq > Sk, windows narrower than a kv tile, GQA
    group 6; then the calls of the MoE, VLM and enc-dec families: head
    dim 96 (phi-3-vision-4.2b's prefill call, and small with a window and
    a ragged Sq in both dtypes), whisper-medium's non-causal encoder call
    in both dtypes and its cross call (Sq 448 against Sk 1500: no kv tile
    divides 1500), and a non-causal call at D = 96 whose Sk is not a
    multiple of the kv tile."""
    cases = [(shape, dt, 0, None) for shape in ((1, 128, 4, 4, 32),
                                                (2, 256, 4, 2, 64),
                                                (1, 256, 8, 1, 64),
                                                (2, 192, 6, 3, 16))
             for dt in ("float32", "bfloat16")]
    cases += [((1, 256, 2, 2, 32), "float32", w, None) for w in (32, 64, 100)]
    cases += [((1, 1000, 12, 2, 128), "float32", 0, None),
              (PREFILL_SHAPE, "bfloat16", 0, None),
              (ZAMBA2_ATTN_SHAPE, "bfloat16", 4096, None)]
    cases += [((2, 4160, 12, 2, 128), "bfloat16", 0, None),
              ((1, 4160, 32, 32, 80), "bfloat16", 0, None),
              ((1, 4096, 12, 2, 128), "bfloat16", 0, 2000),
              ((1, 4096, 32, 32, 80), "bfloat16", 0, 2000),
              ((1, 4096, 12, 2, 128), "bfloat16", 100, None),
              ((1, 4096, 32, 32, 80), "bfloat16", 16, None),
              ((1, 4096, 12, 12, 128), "bfloat16", 0, None)]
    cases = [c + (True,) for c in cases]
    cases += [(PHI3_ATTN_SHAPE, "bfloat16", 0, None, True)]
    cases += [((1, 300, 4, 2, 96), dt, 64, None, True)
              for dt in ("float32", "bfloat16")]
    cases += [(WHISPER_ENC_SHAPE, dt, 0, None, False)
              for dt in ("float32", "bfloat16")]
    cases += [(WHISPER_CROSS_SHAPE, dt, 0, WHISPER_CROSS_SK, False)
              for dt in ("float32", "bfloat16")]
    cases += [((1, 300, 4, 2, 96), "bfloat16", 0, 1000, False)]
    return cases


def flash_inputs(torch, g, shape, dtype, sk=None):
    b, s, h, hkv, d = shape
    return tuple(torch.randn(b, n_s, n, d, device="cuda", generator=g)
                 .to(dtype) for n_s, n in ((s, h), (sk or s, hkv),
                                           (sk or s, hkv)))


def flash_bound_ms(shape, dtype, window=0, causal=True, sk=None):
    """The least time of one call: 4 B H D flop per visible (row, col)
    pair (causal: the diagonal and below, within the window; non-causal:
    all S x Sk) at the dtype's peak, against reading q, k, v once and
    writing o once at the HBM rate; the larger of the two."""
    b, s, h, hkv, d = shape
    sk = sk or s
    rows = range(s)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in rows) \
        if causal else s * sk
    flops = 4.0 * b * h * d * pairs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * d * (2 * h * s + 2 * hkv * sk)
    peak = TENSOR_CORE_BF16_FLOP_S if dtype == "bfloat16" else FP32_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def time_flash(torch, g, shape, window, causal=True, sk=None):
    """Cold-L2 device times at one bf16 shape (enough input sets that four
    L2s of traffic pass between two reads of one set): the kernel, its
    plain version and scaled_dot_product_attention on (B, H, S, D) copies
    laid out before the clock starts; non-causal calls with ``sk`` keys."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(torch, g, shape, torch.bfloat16, sk)
    set_bytes = sum(x.numel() * x.element_size() for x in (q, k, v))
    n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
    sets = [flash_inputs(torch, g, shape, torch.bfloat16, sk)
            for _ in range(n_sets)]
    sdpa_sets = [tuple(x.transpose(1, 2).contiguous() for x in st)
                 for st in sets]
    if 0 < window < shape[1]:
        raise ValueError("the causal SDPA yardstick computes the same "
                         "function only for a window of 0 or >= S")

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def plain(q, k, v):
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    kept = []
    # the call launches its one kernel once: timed by its mean per launch,
    # which the events CUPTI drops do not move (a window that kept none
    # of its events is taken again)
    name = fa.KERNELS[torch.bfloat16]
    prof_k = profile_calls(torch, cycled(sets, kernel, kept), 20,
                           groups={name: (name,)}, require=(name,),
                           once=True)
    kept.clear()
    prof_p = profile_calls(torch, cycled(sets, plain, kept), 3)
    kept.clear()
    prof_l = profile_calls(torch, cycled(sdpa_sets, sdpa, kept), 20)
    kept.clear()
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(shape, "bfloat16",
                                                       window, causal, sk)
    ms = prof_k["group_us_per_call"][name] / 1e3
    library_ms = prof_l["rounded_us_per_call"] / 1e3
    return {"shape": list(shape), "dtype": "bfloat16", "window": window,
            "causal": causal, "sk": sk or shape[1],
            "ms": ms, "plain_ms": prof_p["rounded_us_per_call"] / 1e3,
            "ms_all_events": prof_k["device_us_per_call"] / 1e3,
            "library_ms": library_ms, "ms_over_library": ms / library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "tflop_s": flops / (ms * 1e-3) / 1e12,
            "kernel": [k for k in prof_k["kernels"] if "flash_fwd" in k],
            "build": fa.kernel_info(torch.bfloat16, shape[4]),
            "ptxas": ptxas_by_kernel(_build.PTXAS_REPORT.get(
                "flash_attention", "")).get(
                    f"{fa.KERNELS[torch.bfloat16]}<{shape[4]}>"),
            "ptxas_prev": FLASH_PREV_PTXAS.get(shape[4]),
            "prev_ms": FLASH_PREV_MS.get(shape[4]),
            "prev_ms_from": "an earlier call on another card (the mma.sync "
                            "kernel before the TMA + wgmma redesign)",
            "cold_sets": n_sets,
            "plain_launches_per_call": prof_p["launches_per_call"],
            "library_kernels": prof_l["kernels"]}


def phase_flash_kernel(torch):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    checks, worst = [], 0.0
    for shape, dt, window, sk, causal in flash_cases():
        dtype = getattr(torch, dt)
        q, k, v = flash_inputs(torch, g, shape, dtype, sk)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        # the long causal f32 case of earlier slices keeps its 1e-4; the
        # calls of the MoE, VLM and enc-dec families are held at 2e-5
        tol = FLASH_TOL_LONG_F32 if dt == "float32" and causal and \
            shape[1] >= 1000 else FLASH_TOL[dt]
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **tol)
        worst = max(worst, err)
        checks.append({"shape": list(shape), "dtype": dt, "window": window,
                       "sk": sk or shape[1], "causal": causal,
                       "max_abs_err": err, "tol": tol})
        del q, k, v, got, want
    torch.cuda.empty_cache()
    t = time_flash(torch, g, PREFILL_SHAPE, 0)
    d80 = time_flash(torch, g, ZAMBA2_ATTN_SHAPE, ZAMBA2_ATTN_SHAPE[1])
    d96 = time_flash(torch, g, PHI3_ATTN_SHAPE, 0)
    enc = time_flash(torch, g, WHISPER_ENC_SHAPE, 0, causal=False)
    cross = time_flash(torch, g, WHISPER_CROSS_SHAPE, 0, causal=False,
                       sk=WHISPER_CROSS_SK)
    calls = {"phi-3-vision-4.2b": d96, "whisper-medium encoder": enc,
             "whisper-medium cross": cross, "zamba2-2.7b": d80}
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:139",
           "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"], "shape": list(PREFILL_SHAPE),
           "dtype": "bfloat16",
           "calls": {name: {k: c[k] for k in (
               "shape", "causal", "sk", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")} for name, c in calls.items()}}
    emit({"phase": "kernel", "name": "flash_attention", "checks": checks,
          **t, "library": "torch.nn.functional.scaled_dot_product_attention("
                          "is_causal=causal, enable_gqa=True) on (B, H, S, "
                          "D)",
          "head_dim_80": d80, "head_dim_96": d96, "whisper_encoder": enc,
          "whisper_cross": cross,
          "build_f32": {d: fa.kernel_info(torch.float32, d)
                        for d in (64, 96)}})
    return rec


def ssd_inputs(torch, g, b, s, nh, hd, ds, dtype):
    """x, dt = softplus(N), A = -exp(0.5 N), B, C as the reference's kernel
    tests draw them; x, B and C in ``dtype`` (B and C as the model passes
    them: halves of one (b, s, 2 ds) projection), dt and A float32."""
    def n(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    x = n(b, s, nh, hd).to(dtype)
    dt = torch.nn.functional.softplus(n(b, s, nh))
    A = -torch.exp(0.5 * n(nh))
    B, C = n(b, s, 2 * ds).to(dtype).chunk(2, dim=-1)
    return x, dt, A, B, C


def ssd_bound_ms(shape, dtype):
    """The least work of one call: C B^T once per (b, chunk) and, per
    head, (L * S) dt x, B^T (w x) and C . state, causal halves counted
    once; against reading x, dt, B, C once and writing y once.  Returns
    the bound at the dtype's peak (bf16: tensor cores, f32: the CUDA
    cores), which of the two sets it, the f32 CUDA-core time of the same
    operations, flop and bytes."""
    b, s, nh, hd, ds, q = shape
    nc = s // q
    tri = q * (q + 1) // 2
    macs = b * nc * (tri * ds + nh * (tri * hd + 2 * q * hd * ds))
    flops = 2.0 * macs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * (2 * b * s * nh * hd + 2 * b * s * ds) + 4 * (b * s * nh
                                                                  + nh)
    peak = TENSOR_CORE_BF16_FLOP_S if dtype == "bfloat16" else FP32_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            flops / FP32_FLOP_S * 1e3, flops, nbytes)


def time_ssd(torch, g, shape):
    """Cold-L2 device time of one bf16 call of the scan at ``shape`` (the
    sum of its three kernels' means per launch) and of its plain
    version's, beside the bound."""
    from repro_torch.kernels import ssd_scan as sk
    *dims, chunk = shape
    one = ssd_inputs(torch, g, *dims, torch.bfloat16)
    set_bytes = sum(x.numel() * x.element_size() for x in one)
    n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
    sets = [ssd_inputs(torch, g, *dims, torch.bfloat16)
            for _ in range(n_sets)]
    kept = []
    # a window where CUPTI lost most of a kernel's events is taken again
    prof_k = profile_calls(torch, cycled(
        sets, lambda *a: sk.ssd_scan(*a, chunk=chunk), kept), 10,
        match=sk.KERNELS, groups={k: (k,) for k in sk.KERNELS},
        require=sk.KERNELS)
    kept.clear()
    prof_p = profile_calls(torch, cycled(
        sets, lambda *a: sk.ssd_scan_ref(*a, chunk)[0], kept), 3)
    kept.clear()
    del one, sets
    torch.cuda.empty_cache()
    # each kernel launches once a call: CUPTI may drop an event of the
    # window, which lowers the launches seen (so each kernel's count is
    # rounded), while another kernel (a fill) would raise them; the time
    # is the sum of the three kernels' means per launch
    per_launch = prof_k["matched_us_per_launch"]
    if any(round(n) != 1 for n in
           prof_k["matched_launches_per_call"].values()) or \
            prof_k["launches_per_call"] > len(sk.KERNELS) or \
            not all(per_launch.values()):
        raise RuntimeError(f"ssd_scan at {shape}: "
                           f"{prof_k['launches_per_call']} device "
                           f"launches per call "
                           f"({prof_k['matched_us_per_call']} us), "
                           f"expected one of each of {sk.KERNELS}")
    bound_ms, bound_by, f32_ms, flops, nbytes = ssd_bound_ms(shape,
                                                             "bfloat16")
    ms = sum(per_launch.values()) / 1e3
    return {"shape": list(shape), "dtype": "bfloat16", "ms": ms,
            "kernel_ms": {k: v / 1e3 for k, v in per_launch.items()},
            "window_ms_per_call": prof_k["device_us_per_call"] / 1e3,
            "device_launches_per_call": prof_k["launches_per_call"],
            "plain_ms": prof_p["device_us_per_call"] / 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "f32_cuda_core_bound_ms": f32_ms,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "tflop_s": flops / (ms * 1e-3) / 1e12, "cold_sets": n_sets,
            "plain_launches_per_call": prof_p["launches_per_call"]}


def phase_ssd_kernel(torch):
    """ssd_scan against its plain version (chunked, 1e-4 in f32; bf16 a
    norm-relative 1e-2 against the f32 plain version) and the sequential
    recurrence (5e-4/5e-3 in f32, 0.15/0.1 in bf16), then its cold-L2
    device time at both prefill calls in bf16, per device kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [((1, 64, 4, 16, 16, 16), "float32"),
             ((2, 128, 8, 16, 32, 32), "float32"),
             ((1, 256, 16, 32, 64, 64), "float32"),
             ((2, 96, 4, 16, 16, 32), "float32"),
             ((1, 128, 4, 16, 32, 32), "bfloat16")]
    # the bf16 kernels' edges: chunks below and at one 64-row tile, narrow
    # heads, the smallest and largest state
    cases += [((2, 64, 4, 16, 16, 8), "bfloat16"),
              ((2, 128, 4, 32, 128, 16), "bfloat16"),
              ((1, 256, 8, 16, 128, 64), "bfloat16"),
              ((1, 256, 4, 32, 16, 64), "bfloat16"),
              ((2, 512, 4, 64, 128, 128), "bfloat16")]
    cases += [(shape, dt) for shape in SSD_PREFILL.values()
              for dt in ("float32", "bfloat16")]
    checks, worst = [], 0.0
    for shape, dt in cases:
        *dims, chunk = shape
        args = ssd_inputs(torch, g, *dims, getattr(torch, dt))
        got = sk.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        oracle = sk.ssd_ref(args[0].float(), *args[1:])
        row = {"shape": list(shape), "dtype": dt}
        if dt == "float32":
            want = sk.ssd_scan_ref(*args, chunk)[0]
            torch.testing.assert_close(got, want, **SSD_TOL["chunked"])
            torch.testing.assert_close(got, oracle, **SSD_TOL["oracle"])
            row["max_abs_err"] = float((got - want).abs().max())
            row["max_abs_err_oracle"] = float((got - oracle).abs().max())
        else:
            torch.testing.assert_close(got.float(), oracle,
                                       **SSD_TOL["bfloat16"])
            want = sk.ssd_scan_ref(args[0].float(), *args[1:], chunk)[0]
            rel = float((got.float() - want).norm() / want.norm())
            if not rel <= SSD_BF16_REL:
                raise RuntimeError(f"ssd_scan bf16 at {shape}: norm-relative "
                                   f"error {rel} > {SSD_BF16_REL}")
            row["rel_err"] = rel
            row["max_abs_err"] = float((got.float() - want).abs().max())
            row["max_abs_err_oracle"] = float((got.float() - oracle)
                                              .abs().max())
        worst = max(worst, row["max_abs_err"])
        row["y_absmax"] = float(oracle.abs().max())
        checks.append(row)
        del args, got, oracle, want
    torch.cuda.empty_cache()
    ptxas = {k: v for k, v in ptxas_by_kernel(
        _build.PTXAS_REPORT.get("ssd_scan", "")).items()
        if k.startswith(sk.KERNELS) and ("<64, " in k or "<" not in k)}
    timed = {arch: time_ssd(torch, g, shape)
             for arch, shape in SSD_PREFILL.items()}
    for arch, t in timed.items():
        t["prev_ms"] = SSD_PREV_MS[arch]
    m = timed["mamba2-1.3b"]
    rec = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:105",
           "max_abs_err": worst, "ms": m["ms"], "plain_ms": m["plain_ms"],
           "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
           "library_ms": None, "shape": m["shape"], "dtype": "bfloat16",
           "device_launches_per_call": m["device_launches_per_call"],
           "bf16_max_rel_err": max(r.get("rel_err", 0.0) for r in checks)}
    emit({"phase": "kernel", "name": "ssd_scan", "checks": checks,
          "tol": {**SSD_TOL, "bfloat16_rel": SSD_BF16_REL}, "timed": timed,
          "ptxas": ptxas, "prev_ms_from":
              "an earlier call on another card (the f32-FMA kernel before "
              "the chunk-parallel redesign)",
          "library": "none: no PyTorch call computes the SSD scan"})
    return rec


def launch_counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan}


def count_launches(torch, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    returns its result and the counts just after."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def check_launches(phase, got, want):
    for name, n in want.items():
        if got[name] != n:
            raise RuntimeError(f"{phase}: {name} launched {got[name]} times, "
                               f"expected {n}")
    for name, n in got.items():
        if name not in want and n:
            raise RuntimeError(f"{phase}: {name} launched {n} times, "
                               "expected none")


def get_cfg(name):
    from repro_torch.configs import get_arch
    return get_arch(name)


def prefill_batch(torch, cfg, b, s, g):
    """The inputs of a (b, s) prefill drawn from ``g``: s tokens; for the
    VLM its frontend embeddings in front of s - frontend_tokens tokens;
    for the enc-dec family s decoder tokens beside (b, encoder_seq, D)
    frames (the frontend inputs 0.02 x normals, as the data pipeline
    draws them)."""
    front = cfg.frontend_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - front),
                                     generator=g, device="cuda")}
    if front:
        batch["embeds"] = 0.02 * torch.randn(b, front, cfg.d_model,
                                             generator=g, device="cuda")
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                             generator=g, device="cuda")
    return batch


def moe_routing(torch, fn, pinned=None):
    """Run ``fn`` with the MoE layers' ``moe_ffn`` wrapped: each call's
    routing (G, S, k) and its dropped slots per token (B, S) recorded in
    call order, or with ``pinned`` (a list in call order) fed in as its
    picks (``topi=``), counting the slots whose own pick differs.  Returns
    (fn's result, the picks, the dropped slots, the differing slots)."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.moe_ffn
    picks, dropped, differ = [], [], [0]

    def wrap(cfg, lp, x, topi=None):
        b, s, d = x.shape
        with torch.no_grad():
            own = moe_lib.route(lp["router"], x.detach().reshape(
                -1, min(moe_lib.GROUP_SIZE, b * s), d), cfg.top_k)[2]
            dropped.append(moe_lib.dropped_slots(cfg, lp, x.detach()))
        if pinned is not None:
            topi = pinned[len(picks)]
            differ[0] += int((own.sort(-1).values
                              != topi.sort(-1).values).sum())
        picks.append(own if topi is None else topi)
        return orig(cfg, lp, x, topi=topi)

    moe_lib.moe_ffn = wrap
    try:
        out = fn()
    finally:
        moe_lib.moe_ffn = orig
    return out, picks, dropped, differ[0]


def phase_prefill(torch, phase, cfg, expect, shape=None, extra=None,
                  params=None, show=True):
    """Model.forward at full width (bf16 compute, last_only) on ``shape``
    (default (2, 4096)) positions, on ``params`` where given, else on
    weights drawn from a seed: the launches of the first forward
    (enforced), finite (B, 1, V) logits, its ms and the peak memory; for
    the MoE family the slots its capacity drops per layer.  Then as many
    timed forwards as the length allows (3 up to 8,192 positions, 1 up to
    32,768, none beyond) and, after any, a profiled one's device ms.
    Returns the record, printed as its own line with ``show``, and the
    (f32) parameters."""
    from repro_torch.models import build_model
    model = build_model(cfg, compute_dtype=torch.bfloat16, device="cuda")
    init_s = None
    if params is None:
        t0 = time.perf_counter()
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in all_tensors(params))
    b, s = shape or PREFILL_SHAPE[:2]
    reps = 3 if s <= 8192 else 1 if s <= PREFILL_32K_SEQ else 0
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = prefill_batch(torch, cfg, b, s, g)

    def forward():
        return model.forward(params, batch, last_only=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (logits, _, dropped, _), launches = count_launches(
        torch, lambda: moe_routing(torch, forward))
    first_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(f"{phase} {cfg.name} ({b}, {s})", launches, expect)
    if tuple(logits.shape) != (b, 1, cfg.padded_vocab) or \
            not all_finite(torch, logits):
        raise RuntimeError(f"{phase} {cfg.name} ({b}, {s}): logits "
                           f"{tuple(logits.shape)} are not finite (B, 1, V)")
    if cfg.is_moe:
        extra = dict(extra or {}, dropped_slots_per_layer=[
            int(d.sum()) for d in dropped], slots_per_layer=b * s * cfg.top_k)
    rec = {"phase": phase, "arch": cfg.name, "params": n_params,
           "param_gb_f32": n_params * 4 / 1e9, "init_s": init_s,
           "batch": b, "seq": s, "depth": cfg.num_layers,
           "compute_dtype": "bfloat16", "launches": launches,
           "first_ms": first_ms, "peak_gb": peak_gb,
           "logits_absmax": float(logits[..., :cfg.vocab_size].abs().max())}
    del logits
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times) if times else first_ms
    rec.update(ms_per_forward=ms, forwards_ms=times,
               tokens_per_s=b * s / (ms * 1e-3))
    if reps:
        prof = profile_calls(torch, lambda i=0: forward(), 1,
                             match=("flash_fwd", "ssd_scan"), warm=False)
        rec.update(device_ms_per_forward=prof["device_us_per_call"] / 1e3,
                   kernel_device_ms={k: v / 1e3 for k, v in
                                     prof["matched_us_per_call"].items()},
                   launches_per_forward=prof["launches_per_call"],
                   top_kernels_us=prof["kernels"])
    rec.update(extra or {})
    del batch
    torch.cuda.empty_cache()
    if show:
        emit(rec)
    return rec, params


def all_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from all_tensors(v)
        else:
            yield v


def phase_decode_vs_forward(torch, phase, cfg, params, seq, expect,
                            show=True, steps=None):
    """Full width, f32: teacher-forced decode logits against the forward's
    at S = ``seq`` (the kernels against the decode path, on the card,
    without JAX), on the first ``steps`` positions where given (the
    forward is causal); for the SSM and hybrid families also the bf16
    forward against the f32.  Returns the record, printed as its own line
    with ``show``."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_ref
    from repro_torch.models import build_model
    model = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    b = 2
    steps = steps or seq
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, seq), generator=g,
                           device="cuda")
    full, launches = count_launches(
        torch, lambda: model.forward(params, {"tokens": tokens}))
    check_launches(phase, launches, expect)
    cache = model.init_cache(b, seq)
    dec = []
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, tokens[:, i])
        dec.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    dec = torch.stack(dec, 1)
    # where a decode step's time goes: one step on a cache of its own
    prof_cache = model.init_cache(b, 4)
    prof = profile_calls(torch, lambda i=0: model.decode_step(
        params, prof_cache, tokens[:, 0]), 2)
    v = cfg.vocab_size
    err = float((dec[..., :v] - full[:, :steps, :v]).abs().max())
    torch.testing.assert_close(dec, full[:, :steps], **DECODE_TOL)
    bf16 = {}
    if cfg.family in ("ssm", "hybrid"):
        # the same weights in a bf16 forward through the kernels' bf16
        # paths, and through their plain versions
        from repro_torch.kernels import ops
        model_bf = build_model(cfg, compute_dtype=torch.bfloat16,
                               device="cuda")
        out_bf, launches_bf = count_launches(
            torch, lambda: model_bf.forward(params, {"tokens": tokens}))
        check_launches(phase, launches_bf, expect)
        kernels = ops.ssd_scan, ops.flash_attention
        ops.ssd_scan = lambda x, dt, A, B, C, *, chunk=256: \
            ssd_scan_ref(x, dt, A, B, C, chunk)[0]
        ops.flash_attention = flash_attention_ref
        try:
            out_plain = model_bf.forward(params, {"tokens": tokens})
        finally:
            ops.ssd_scan, ops.flash_attention = kernels
        last = full[:, -1, :v]

        def rel(out):
            return float((out[:, -1, :v].float() - last).norm()
                         / last.norm())
        rel_k, rel_p = rel(out_bf), rel(out_plain)
        if not rel_k <= SSM_BF16_VS_PLAIN * rel_p:
            raise RuntimeError(f"{phase}: the kernels' bf16 last logits "
                               f"miss the f32 forward's by {rel_k}, more "
                               f"than {SSM_BF16_VS_PLAIN} x the plain "
                               f"versions' {rel_p}")
        bf16 = {"bf16_last_logits_rel_err": rel_k,
                "bf16_plain_last_logits_rel_err": rel_p,
                "bf16_within_rel": rel_k <= SSM_BF16_REL,
                "bf16_tol": {"rel": SSM_BF16_REL,
                             "vs_plain": SSM_BF16_VS_PLAIN},
                "bf16_launches": launches_bf}
    rec = {"phase": phase, "arch": cfg.name, "batch": b, "seq": seq,
           "decoded": steps, "dtype": "float32", "depth": cfg.num_layers,
           "max_abs_err": err, "tol": DECODE_TOL, "launches": launches,
           **bf16,
           "decode_ms_per_step": step_ms,
           "decode_device_ms_per_step": prof["device_us_per_call"] / 1e3,
           "decode_launches_per_step": prof["launches_per_call"],
           "decode_top_host_ops_us": prof["top_host_ops_us"],
           "logits_absmax": float(full[..., :v].abs().max())}
    if steps < seq:
        rec["reduced"] = {
            "decoded_positions": [seq, steps],
            "why": "the smoke's run time (ROADMAP 19): each teacher-forced "
                   "step is host-bound, one step a layer; the forward is "
                   "causal, so its first positions are compared"}
    if show:
        emit(rec)
    return rec


def phase_serve(torch, arch, params=None, show=True):
    """run_serve at full width with GridPilot on (on ``params`` where
    given, else weights it draws); fails unless the FFR shed lands at the
    middle decode step under budget.  Returns the record, printed as its
    own line with ``show``."""
    from repro_torch.launch.serve import build_parser, run_serve
    from repro_torch.obs import trace
    args = build_parser().parse_args(["--gridpilot", "--arch", arch])
    trace.get_tracer().clear()
    out = run_serve(args, cfg=get_cfg(arch), params=params, device="cuda")
    budget_ms = 700.0  # FFR activation budget
    if out["shed_at"] != args.decode_tokens // 2 or \
            not out["active"] < out["batch"] or out["response_ms"] is None \
            or not out["response_ms"] < budget_ms:
        raise RuntimeError(f"serve: no FFR shed within budget: {out}")
    rec = {"phase": "serve", "arch": args.arch, "requests": args.requests,
           "prompt_len": args.prompt_len,
           "decode_tokens": args.decode_tokens,
           "prefill_ms": out["t_prefill_s"] * 1e3,
           "decode_ms_per_tok": out["t_decode_s"] / args.decode_tokens
           * 1e3,
           "shed_at": out["shed_at"], "batch": out["batch"],
           "active": out["active"], "response_ms": out["response_ms"],
           "budget_ms": budget_ms,
           "sheds": trace.metrics.counters.get("serve.sheds")}
    if show:
        emit(rec)
    return rec


def phase_decode_vs_forward_moe(torch, cfg, params):
    """olmoe-1b-7b at full width and depth in f32: teacher-forced decode
    logits against the forward's (2e-3).  The forward drops the slots over
    capacity and the decode step drops none, so decode is held on the
    positions before the first token that lost a slot in some layer: every
    position of a (1, 4) call (a group of 4 tokens cannot drop), the
    drop-free prefix of a (2, 64) one.  Each decode step takes the
    forward's picks of its token (the routing's last bits differ between
    the two paths' products); the slots whose own pick differed are
    counted."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    t_phase = time.perf_counter()
    model = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    calls = []
    for b, seq in MOE_DECODE_CALLS:
        tokens = torch.randint(0, cfg.vocab_size, (b, seq), generator=g,
                               device="cuda")
        (full, picks, dropped, _), launches = count_launches(
            torch, lambda: moe_routing(torch, lambda: model.forward(
                params, {"tokens": tokens})))
        check_launches("decode_vs_forward_moe", launches,
                       {"flash_attention": cfg.num_layers})
        lost = torch.stack(dropped).sum(dim=(0, 1))       # per position
        keep = int(lost.nonzero()[0, 0]) if lost.any() else seq
        if b * seq <= 4 and keep != seq:
            raise RuntimeError(f"decode_vs_forward_moe: a (1, 4) call "
                               f"dropped slots at position {keep}")
        picks = [p.reshape(b, seq, -1) for p in picks]
        orig = moe_lib.moe_ffn_decode
        step, layer, differ = [0], [0], [0]

        def pinned(cfg_, lp, x, topi=None):
            want = picks[layer[0]][:, step[0]]
            own = moe_lib.route(lp["router"], x, cfg_.top_k)[2]
            differ[0] += int((own.sort(-1).values
                              != want.sort(-1).values).sum())
            layer[0] = (layer[0] + 1) % cfg.num_layers
            return orig(cfg_, lp, x, topi=want)

        cache = model.init_cache(b, seq)
        dec = []
        moe_lib.moe_ffn_decode = pinned
        try:
            for i in range(seq):
                step[0] = i
                logits, cache = model.decode_step(params, cache,
                                                  tokens[:, i])
                dec.append(logits)
        finally:
            moe_lib.moe_ffn_decode = orig
        dec = torch.stack(dec, 1)
        v = cfg.vocab_size
        err = float((dec[:, :keep, :v] - full[:, :keep, :v]).abs().max()) \
            if keep else None
        torch.testing.assert_close(dec[:, :keep], full[:, :keep],
                                   **DECODE_TOL)
        calls.append({"batch": b, "seq": seq, "launches": launches,
                      "dropped_slots_per_layer": [int(d.sum())
                                                  for d in dropped],
                      "slots_per_layer": b * seq * cfg.top_k,
                      "drop_free_prefix": keep, "max_abs_err": err,
                      "decode_picks_differing_from_forward": differ[0]})
        del full, dec, cache
    emit({"phase": "decode_vs_forward_moe", "arch": cfg.name,
          "dtype": "float32", "depth": cfg.num_layers, "calls": calls,
          "tol": DECODE_TOL, "seconds": time.perf_counter() - t_phase})


def phase_decode_vs_forward_encdec(torch, cfg, params):
    """whisper-medium at full width and depth in f32 on S = 64 decoder
    tokens and (2, 1500, 1024) frames: teacher-forced decode logits
    (after encode and precompute_cross_kv) against decode_train's (2e-3);
    the forward's 72 attention launches (24 encoder, non-causal; 24
    decoder, causal; 24 cross, non-causal)."""
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    t_phase = time.perf_counter()
    model = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    b, seq = 2, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = prefill_batch(torch, cfg, b, seq, g)
    full, launches = count_launches(torch,
                                    lambda: model.forward(params, batch))
    check_launches("decode_vs_forward_encdec", launches,
                   {"flash_attention": cfg.encoder_layers
                    + 2 * cfg.num_layers})
    cache = model.init_cache(b, seq)
    with torch.no_grad():
        enc = encdec.encode(cfg, params, batch["frames"],
                            dtype=torch.float32)
        cache["xk"], cache["xv"] = encdec.precompute_cross_kv(cfg, params,
                                                              enc)
    dec = []
    t0 = time.perf_counter()
    for i in range(seq):
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, i])
        dec.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / seq * 1e3
    dec = torch.stack(dec, 1)
    v = cfg.vocab_size
    err = float((dec[..., :v] - full[..., :v]).abs().max())
    torch.testing.assert_close(dec, full, **DECODE_TOL)
    emit({"phase": "decode_vs_forward_encdec", "arch": cfg.name,
          "batch": b, "seq": seq, "encoder_seq": cfg.encoder_seq,
          "dtype": "float32", "depth": [cfg.encoder_layers, cfg.num_layers],
          "max_abs_err": err, "tol": DECODE_TOL, "launches": launches,
          "decode_ms_per_step": step_ms,
          "seconds": time.perf_counter() - t_phase})


def e9_specs(hours):
    from repro_torch.grid.scenarios import product_specs
    from repro_torch.grid.signals import COUNTRY_ORDER
    return product_specs(countries=tuple(COUNTRY_ORDER), seeds=(0, 1, 2),
                         horizon_h=hours, products=("FFR", "FCR-D"),
                         reserve_rhos=(0.0, 0.1, 0.2, 0.3),
                         event_seeds=(0, 1))


def phase_engine(torch):
    import repro_torch.core.engine as eng
    import repro_torch.core.twin as twin
    from repro_torch.grid.scenarios import build_scenario_batch
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=4.0)
    # rate probe: one simulated hour of the full batch
    probe = build_scenario_batch(e9_specs(1), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.engine_rollout(cfg, probe, device="cuda")
    torch.cuda.synchronize()
    s_per_h = time.perf_counter() - t0
    hours = max(1, min(24, int(ENGINE_BUDGET_S // s_per_h)))
    batch = build_scenario_batch(e9_specs(hours), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.engine_rollout(cfg, batch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all_finite(torch, out):
        raise RuntimeError("engine_rollout produced a non-finite output")
    n_events = int(out["n_events"].sum())
    if n_events <= 0:
        raise RuntimeError("no reserve event in the E9 batch")
    # the tick under the host-sync detector: any wait on the device raises
    params, _, _ = eng.engine_params(cfg, probe)
    state = eng.engine_init(cfg, probe.seed, device="cuda")
    lp = twin.host_load_params(cfg.n_hosts, probe.seed)
    rows = twin.host_loads_block(lp, 0)
    below = torch.zeros(probe.n, dtype=torch.bool, device="cuda")
    in_hor = torch.ones(probe.n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(100):
            state, _ = eng.engine_step(cfg, params, state,
                                       (rows[:, t], below, in_hor, t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # where a tick's time goes: 100 ticks under the profiler, their plant
    # noise drawn beforehand in one block as the rollout draws it per hour
    box = [state]
    noise = twin.plant_noise(probe.seed, 0, 100, cfg.n_hosts,
                             cfg.chips_per_host)

    def tick(t=0):
        box[0], _ = eng.engine_step(cfg, params, box[0],
                                    (rows[:, t], below, in_hor, t),
                                    noise=noise[:, t])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(100):
        tick(t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 100 * 1e3
    prof = profile_calls(torch, tick, 100)
    tick_ms = wall / (hours * 3600) * 1e3
    emit({"phase": "engine", "scenarios": batch.n, "hours": hours,
          "cut": None if hours == 24 else
          f"horizon cut from 24 h to {hours} h by the time budget",
          "probe_s_per_hour": s_per_h, "wall_s": wall,
          "s_per_sim_hour": wall / hours,
          "ms_per_tick": tick_ms,
          "engine_step_ms": step_ms,
          "engine_step_device_busy_share":
              prof["device_us_per_call"] / 1e3 / step_ms,
          "tick_profile": prof,
          "n_events": n_events,
          "compliance": int(out["n_compliant"].sum()) / n_events,
          "net_eur": float(out["net_eur"].sum()),
          "it_mwh": float(out["it_mwh"].sum()),
          "sync_free_ticks": 100})
    return {"hours": hours, "n_events": out["n_events"], "mu_h": out["mu_h"]}


CPU_VS_GPU_TOL = {"energy": 1e-3, "rls": 2e-2}


def fast_specs():
    """The 6 E9-fast scenarios (SE/DE/PL x bands 0/0.2, FFR) over 1 h.
    Event draw 7 is the first whose trace crosses the FFR trigger inside
    the hour at 24 events/day, so the event paths are exercised."""
    from repro_torch.grid.scenarios import product_specs
    return product_specs(countries=("SE", "DE", "PL"), seeds=(0,),
                         horizon_h=1, products=("FFR",),
                         reserve_rhos=(0.0, 0.2), event_seeds=(7,))


def phase_cpu_vs_gpu(torch):
    import repro_torch.core.engine as eng
    import repro_torch.core.twin as twin
    from repro_torch.grid import frequency
    from repro_torch.grid.scenarios import (build_scenario_batch,
                                            frequency_seeds)
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=24.0)
    specs = fast_specs()
    cpu_b = build_scenario_batch(specs, device="cpu")
    T = cpu_b.h_max * 3600
    freq, _ = frequency.synthesize_frequency_batch(
        frequency_seeds(cpu_b), cpu_b.product_idx, n_seconds=T,
        events_per_day=cfg.events_per_day, device="cpu")
    loads = eng.base_loads(cfg, cpu_b)
    noise = twin.plant_noise(cpu_b.seed, 0, T, cfg.n_hosts,
                             cfg.chips_per_host)
    kw = dict(reduce="summary", freq=freq, loads=loads, noise=noise)
    a = eng.engine_rollout(cfg, cpu_b, device="cpu", **kw)
    b = eng.engine_rollout(cfg, cpu_b, device="cuda", **kw)
    worst = {}
    for k, tol in (("it_mwh", "energy"), ("fac_mwh", "energy"),
                   ("net_eur", "energy"), ("capacity_eur", "energy"),
                   ("mean_mu", "energy"), ("chip_power_mean", "energy"),
                   ("tokens_mtok", "energy"), ("ar4_mae_norm", "rls"),
                   ("tracking_err_mean", "rls")):
        x, y = a[k].double(), b[k].cpu().double()
        torch.testing.assert_close(y, x, rtol=CPU_VS_GPU_TOL[tol], atol=0.0)
        worst[k] = float(((y - x).abs() / x.abs().clamp(min=1e-12)).max())
    for k in ("n_events", "n_compliant", "active_s"):
        if not torch.equal(a[k], b[k].cpu()):
            raise RuntimeError(f"cpu vs gpu: {k} differs")
    if not torch.equal(a["events"].t_event_s, b["events"].t_event_s.cpu()):
        raise RuntimeError("cpu vs gpu: event trigger seconds differ")
    emit({"phase": "cpu_vs_gpu", "scenarios": cpu_b.n, "hours": 1,
          "n_events": int(a["n_events"].sum()), "max_rel_err": worst,
          "tol": CPU_VS_GPU_TOL})


def phase_sweep(torch):
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=24.0)
    specs = fast_specs()
    swept = eng.engine_sweep(cfg, specs, chunk_size=5, device="cuda")
    batch = build_scenario_batch(specs, device="cuda")
    mono = eng.sweep_finalize(eng.chunk_summary(
        cfg, eng.engine_rollout(cfg, batch, device="cuda"), batch))
    worst = 0.0
    for k, v in mono.items():
        if isinstance(v, dict):
            continue
        d = abs(swept[k] - v) / max(abs(v), 1e-9)
        if d > 1e-5 and abs(swept[k] - v) > 1e-6:
            raise RuntimeError(f"sweep vs monolithic: {k} {swept[k]} {v}")
        worst = max(worst, d)
    emit({"phase": "sweep", "specs": len(specs), "chunk_size": 5,
          "max_rel_err": worst, "net_eur": swept["net_eur"],
          "n_events": swept["n_events"]})


# --- mesh: the sweep split over two processes sharing the card -------------

MESH_WORKER_TIMEOUT_S = 150        # each worker, rendezvous to result
MESH_CHUNK = 8
MESH_HOURLY_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_engine_sharded.py
MESH_SECONDS_TOL = {"energy": 1e-3, "rls": 2e-2}
MESH_RLS_KEYS = ("ar4_mae_norm", "tracking_err_mean", "rls_rms",
                 "track_rms", "track_hist")
MESH_EXACT_KEYS = ("n_scenarios", "n_events", "n_compliant", "active_s",
                   "n_budget_ok")


def mesh_jobs():
    """The reference's distributed smoke (benchmarks/engine_fleet.py):
    36 scenario-days (6 grids x seeds 0-5, 24 h) under its hourly-tier
    fleet_cfg, and its seconds_cfg on the first 6 of those specs cut to
    1 h.  Built through the port: that file imports JAX."""
    import dataclasses
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import product_specs
    specs = product_specs(seeds=range(6), horizon_h=24)
    return {
        "hourly": (eng.EngineConfig(n_hosts=2, chips_per_host=2,
                                    with_seconds=False), specs),
        "seconds_tier": (
            eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=8,
                             events_per_day=48.0, telemetry=True),
            [dataclasses.replace(s, horizon_h=1) for s in specs[:6]]),
    }


def mesh_worker(out_dir):
    """One rank of the mesh phase (REPRO_* set by the parent): this
    process's raw aggregates of engine_sweep(mesh="auto",
    finalize=False) for each job, its slice, backend and seconds."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core.engine as eng
    from repro_torch.launch import mesh as mesh_lib
    rec = {}
    for name, (cfg, specs) in mesh_jobs().items():
        t0 = time.perf_counter()
        agg = eng.engine_sweep(cfg, specs, chunk_size=MESH_CHUNK,
                               mesh="auto", finalize=False, device="cuda")
        torch.cuda.synchronize()
        rec[name] = {"agg": {k: v.tolist() for k, v in agg.items()},
                     "slice": mesh_lib.process_slice(len(specs)),
                     "seconds": time.perf_counter() - t0}
    rec.update(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(),
               lanes=[str(d) for d in mesh_lib.resolve_mesh(
                   "auto", device="cuda").devices])
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def mesh_compare(got, want, hourly):
    """Finalized sweep metrics against the single process's: hourly at
    rtol 1e-4 / atol 1e-5; the seconds tier at 1e-3 for energy and money,
    2e-2 for the RLS metrics, counts exact.  Returns the worst relative
    error per key."""
    flat_g = {**got, **{f"telemetry.{k}": v
                        for k, v in got.get("telemetry", {}).items()}}
    flat_w = {**want, **{f"telemetry.{k}": v
                         for k, v in want.get("telemetry", {}).items()}}
    worst = {}
    for k, w in flat_w.items():
        if k == "telemetry":
            continue
        g, w = np.asarray(flat_g[k], np.float64), np.asarray(w, np.float64)
        base = k.split(".")[-1]
        if not hourly and base in MESH_EXACT_KEYS:
            ok = np.array_equal(g, w)
        else:
            rtol = (MESH_HOURLY_TOL["rtol"] if hourly else
                    MESH_SECONDS_TOL["rls" if base in MESH_RLS_KEYS
                                     else "energy"])
            atol = MESH_HOURLY_TOL["atol"] if hourly else 1e-4
            ok = bool(np.all(np.abs(g - w) <= atol + rtol * np.abs(w)))
        if not ok:
            raise RuntimeError(f"mesh: {k} {g} against {w}")
        worst[k] = float(np.max(np.abs(g - w) / np.maximum(np.abs(w),
                                                           1e-12)))
    return worst


def phase_mesh(torch):
    """The sweep over the mesh layer on one card: two worker processes
    (REPRO_* on localhost, a gloo group, as the ranks share the card) each
    sweep their process_slice of mesh_jobs(), their raw aggregates merged
    through summary_merge against the single-process sweep; then
    engine_rollout over two lanes on the card (N = 6 on 2 lanes; the
    seconds job's 6 specs) against mesh=None."""
    import tempfile
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch
    from repro_torch.launch.mesh import ScenarioMesh
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the workers open contexts of their own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        t0 = time.perf_counter()
        recs = spawn_workers("--mesh-worker", d, MESH_WORKER_TIMEOUT_S)
        workers_s = time.perf_counter() - t0
    rec = {"phase": "mesh", "workers_s": workers_s,
           "workers": [{"rank": r["rank"], "world": r["world"],
                        "backend": r["backend"], "lanes": r["lanes"],
                        **{name: {"slice": r[name]["slice"],
                                  "seconds": r[name]["seconds"]}
                           for name in mesh_jobs()}}
                       for r in recs]}
    for name, (cfg, specs) in mesh_jobs().items():
        aggs = [{k: torch.tensor(v, dtype=torch.float32)
                 for k, v in r[name]["agg"].items()} for r in recs]
        slices = [tuple(r[name]["slice"]) for r in recs]
        for (lo, hi), a in zip(slices, aggs):
            if float(a["n_scenarios"]) != hi - lo:
                raise RuntimeError(f"mesh: {name}: a worker counted "
                                   f"{float(a['n_scenarios'])} scenarios "
                                   f"of its slice [{lo}, {hi})")
        if slices[0][0] != 0 or slices[-1][1] != len(specs) or any(
                a[1] != b[0] for a, b in zip(slices, slices[1:])):
            raise RuntimeError(f"mesh: {name}: slices {slices} do not "
                               f"cover {len(specs)} specs")
        merged = eng.sweep_finalize(eng.summary_merge(*aggs))
        t0 = time.perf_counter()
        single = eng.sweep_finalize(eng.engine_sweep(
            cfg, specs, chunk_size=MESH_CHUNK, finalize=False,
            device="cuda"))
        rec[name] = {"specs": len(specs), "slices": slices,
                     "single_process_s": time.perf_counter() - t0,
                     "n_events": merged.get("n_events"),
                     "max_rel_err": mesh_compare(merged, single,
                                                 name == "hourly")}
    cfg, specs = mesh_jobs()["seconds_tier"]
    batch = build_scenario_batch(specs, device="cuda")
    lanes = ScenarioMesh((torch.device("cuda", 0),) * 2)
    t0 = time.perf_counter()
    split = eng.engine_rollout(cfg, batch, mesh=lanes, device="cuda")
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = eng.engine_rollout(cfg, batch, device="cuda")
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    worst = {}
    for k, w in whole.items():
        if not isinstance(w, torch.Tensor):
            continue
        g = split[k]
        if g.shape != w.shape:
            raise RuntimeError(f"mesh: rollout {k} {g.shape} {w.shape}")
        if k in ("n_events", "active_s", "n_compliant"):
            ok = torch.equal(g, w)
        else:
            rtol = MESH_SECONDS_TOL["rls" if k in MESH_RLS_KEYS
                                    else "energy"]
            g64, w64 = g.double(), w.double()
            ok = bool(((g64 - w64).abs() <= 1e-4 + rtol * w64.abs()).all())
            worst[k] = float(((g64 - w64).abs()
                              / w64.abs().clamp_min(1e-12)).max())
        if not ok:
            raise RuntimeError(f"mesh: engine_rollout on 2 lanes, {k}")
    if not torch.equal(split["events"].t_event_s,
                       whole["events"].t_event_s):
        raise RuntimeError("mesh: the 2-lane rollout's trigger seconds "
                           "differ")
    rec["rollout_2_lanes"] = {"scenarios": batch.n, "hours": 1,
                              "split_s": split_s, "whole_s": whole_s,
                              "max_rel_err": worst}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


def bid_specs():
    """The reference bidding bench's fast E9 slice: SE/DE/PL, seed 0, FFR,
    bands 0 and 0.2, event draw 0 (benchmarks/e9_reserve.py), its 6 h cut
    to SLICE_HOURS."""
    from repro_torch.grid.scenarios import product_specs
    return product_specs(countries=("SE", "DE", "PL"), seeds=(0,),
                         horizon_h=SLICE_HOURS, products=("FFR",),
                         reserve_rhos=(0.0, 0.2), event_seeds=(0,))


def stacked(batch, k):
    """The batch ``k`` times over: a scenario draws the same frequency,
    demand and plant noise in any batch, so each copy settles as the batch
    alone would."""
    import dataclasses
    return type(batch)(**{f.name: getattr(batch, f.name).repeat(
        (k,) + (1,) * (getattr(batch, f.name).dim() - 1))
        for f in dataclasses.fields(batch)})


def phase_bidding(torch):
    """The three arms of the reference's bidding bench on the card, then
    the optimiser alone over the full E9 batch."""
    import dataclasses
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch
    from repro_torch.optim import bidding
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=24.0, rho_mode="tier3",
                           price_aware=True)
    blind = dataclasses.replace(cfg, price_aware=False)
    t_phase = time.perf_counter()
    batch = build_scenario_batch(bid_specs(), device="cuda")
    bcfg = bidding.BidConfig()
    arms = {"grid_blind": eng.engine_params(blind, batch)[1],
            "grid": eng.engine_params(cfg, batch)[1]}
    arms = {k: (v["mu_h"], v["rho_h"]) for k, v in arms.items()}
    bidding.bids_for_batch(cfg, batch, config=dataclasses.replace(
        bcfg, n_iter=2))                     # first-touch warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arms["bid"], launches = count_launches(
        torch, lambda: bidding.bids_for_batch(cfg, batch, config=bcfg))
    bid_s = time.perf_counter() - t0
    check_launches("bidding", launches, {})
    check_bids(torch, cfg, batch, bcfg, arms["bid"])
    # the three arms settled in one rollout, each on its own copy of the
    # slice: the same realised traces, one tick loop
    names = list(arms)
    ops = tuple(torch.cat([arms[k][i] for k in names]) for i in (0, 1))
    t0 = time.perf_counter()
    out = eng.engine_rollout(cfg, stacked(batch, len(names)), ops=ops)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    if not all_finite(torch, out):
        raise RuntimeError("bidding: the settlement is not finite")
    n = batch.n
    nets = {k: float(out["net_eur"][i * n:(i + 1) * n].sum())
            for i, k in enumerate(names)}
    pens = {k: float(out["penalty_eur"][i * n:(i + 1) * n].sum())
            for i, k in enumerate(names)}
    sold = out["rho_h"][2 * n:]
    if not torch.allclose(sold, arms["bid"][1] * batch.mask, atol=1e-7):
        raise RuntimeError("bidding: the settlement did not commit the bid")
    full = optimizer_alone(torch, cfg, bcfg)
    gain = nets["bid"] - nets["grid"]
    emit({"phase": "bidding", "scenarios": n, "hours": batch.h_max,
          "n_ens": bcfg.n_ens, "n_iter": bcfg.n_iter, "net_eur": nets,
          "penalty_eur": pens, "net_eur_gain": gain,
          # the reference bench's revenue gate, printed and not enforced:
          # it holds on one realised event day, and the port draws its own
          "bid_net_ge_grid": gain >= BIDDING_MIN_NET_EUR_GAIN,
          "n_events": int(out["n_events"].sum()),
          "bid_s": bid_s, "ms_per_opt_step": bid_s / bcfg.n_iter * 1e3,
          "settle_s": settle_s, "settled_lanes": len(names) * n,
          "full_e9": full, "seconds": time.perf_counter() - t_phase})


def check_bids(torch, cfg, batch, bcfg, ops):
    """What the bidder guarantees, on the card: every bid inside the box
    and under the residual-load floor, and (on the slice's forecasts) the
    incumbent never below the grid search's cell on its own ensemble and
    monotone over the iterations."""
    from repro_torch.core import tier3
    from repro_torch.optim import bidding
    mu, bid = ops
    eps = 1e-6
    inside = [(mu >= bidding.MU_LO - eps).all(),
              (mu <= bidding.MU_HI + eps).all(), (bid >= -eps).all(),
              (mu - bid >= tier3.MIN_RESIDUAL_LOAD - eps).all()]
    green = tier3.greenness_from_ci(batch.ci, batch.mask).reshape(-1)
    res = bidding.optimize_bids(green, batch.t_amb.reshape(-1), key=1,
                                config=bcfg, weights=(
                                    tier3.W_FFR, tier3.W_CFE, cfg.w_rev))
    inside += [(res.mu - res.rho >= tier3.MIN_RESIDUAL_LOAD - eps).all(),
               (res.bid <= res.rho + eps).all(), (res.j >= res.j_grid).all()]
    if not (all(bool(x) for x in inside)
            and np.all(np.diff(res.history, axis=0) >= 0.0)):
        raise RuntimeError("bidding: a bid left the floor or the box, or "
                           "the incumbent fell below the grid search")


def optimizer_alone(torch, cfg, bcfg):
    """optimize_bids over the full E9 batch (288 scenarios x 24 h), not
    settled: wall time per opt step (a run of n_iter steps less a run of
    none), and the profiler's device time and kernel launches per step
    from a run of PROFILED_STEPS steps less a run of none (a whole run's
    ~80,000 kernel events would cost the profiler a minute)."""
    import dataclasses
    from repro_torch.grid.scenarios import build_scenario_batch
    from repro_torch.optim import bidding
    batch = build_scenario_batch(e9_specs(24), device="cuda")
    none = dataclasses.replace(bcfg, n_iter=0)

    def run(c):
        def call(_i=0):
            bidding.bids_for_batch(cfg, batch, config=c)
        return call

    walls = {}
    for c in (none, bcfg, none, bcfg):
        run(c)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(c)()
        torch.cuda.synchronize()
        walls.setdefault(c.n_iter, []).append(time.perf_counter() - t0)
    wall0, wall = min(walls[0]), min(walls[bcfg.n_iter])
    k = PROFILED_STEPS
    p0 = profile_calls(torch, run(none), 1)
    p1 = profile_calls(torch, run(dataclasses.replace(bcfg, n_iter=k)), 1)
    step_ms = (wall - wall0) / bcfg.n_iter * 1e3
    dev_us = (p1["device_us_per_call"] - p0["device_us_per_call"]) / k
    return {"hours": batch.n * batch.h_max, "wall_s": wall,
            "init_wall_s": wall0, "ms_per_opt_step": step_ms,
            "device_us_per_opt_step": dev_us,
            "launches_per_opt_step": (p1["launches_per_call"]
                                      - p0["launches_per_call"]) / k,
            "device_busy_share": dev_us / 1e3 / step_ms,
            "step_kernels": p1["kernels"]}


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 2**20


def phase_service(torch):
    """The reference's service bench on the card: 1,024 sites over a 24 h
    horizon, churn, then the load generator's timed window; then 10
    captured ticks against 10 eager ticks of the same state."""
    import asyncio
    from torch.utils import _pytree as pytree
    from repro_torch.obs import trace
    from repro_torch.service import (LoadGen, LoadGenConfig, ServiceConfig,
                                     ServiceServer, demo_batch)
    n_sites, n_ticks = 1024, 600
    t_phase = time.perf_counter()
    server = ServiceServer(ServiceConfig(capacity=n_sites, horizon_h=24,
                                         seed=0))
    store = server.store
    slots = server.admit_sites(demo_batch(n_sites, 24,
                                          products=("FFR", "FCR-D")))
    # capture and first touch outside the windows; churn: 32 sites out
    # and 32 in, a trigger storm, a quarantined lane
    for _ in range(2):
        server.step_once()
    for s in slots[:32]:
        server.evict_site(s)
    slots = slots[32:] + server.admit_sites(demo_batch(32, 24))
    for s in slots[:64]:
        server.ingest_trigger(s)
    server.step_once()
    store.step(enabled=np.arange(n_sites) % 7 != 0)
    torch.cuda.synchronize()
    gen = LoadGen(LoadGenConfig(n_ticks=n_ticks, warmup_ticks=2,
                                trigger_rate_per_site_day=400.0,
                                storm_every=n_ticks // 6, storm_sites=64,
                                seed=0))
    rss0, mem0 = rss_mb(), torch.cuda.memory_allocated()
    stats, launches = count_launches(
        torch, lambda: asyncio.run(gen.drive(server, slots)))
    rss_growth = rss_mb() - rss0
    mem1 = torch.cuda.memory_allocated()
    check_launches("service", launches, {})
    cache = store.step_cache_size()
    step_ms = trace.metrics.series("service.step_ms")[-n_ticks:]
    # one replay and its device time, and the eager tick beside it
    rng = np.random.default_rng(0)
    below = rng.random((64, n_sites)) < 0.05
    prof = profile_calls(torch, lambda i=0: store.step(below[i % 64]), 50)
    eager = profile_calls(torch, lambda i=0: store._tick(), 50)
    walls = {}
    for name, tick in (("replay", lambda: store.step()),
                       ("eager", store._tick)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            tick()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 10.0
    # 10 captured ticks against 10 eager ticks from the same state
    leaves = pytree.tree_leaves(store.state)
    start = [x.clone() for x in leaves]
    got = []
    for i in range(10):
        got.append([x.clone() for x in store.step(below[i])])
    end = [x.clone() for x in leaves]
    for x, y in zip(leaves, start):
        x.copy_(y)
    same = True
    for i in range(10):
        store._inputs[0].copy_(torch.from_numpy(below[i]))
        store._inputs[1].fill_(True)
        store._tick()
        same &= all(torch.equal(a, b) for a, b in zip(got[i], store.out))
    same &= all(torch.equal(a, b) for a, b in zip(end, leaves))
    server.close()
    res = {"phase": "service", "sites": n_sites, "ticks": stats["ticks"],
           "ticks_per_s": stats["ticks_per_s"],
           "ms_per_tick": 1e3 / stats["ticks_per_s"],
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "n_triggers": stats["n_triggers"], "n_storms": stats["n_storms"],
           "n_resolved": stats["n_resolved"],
           "p50_trigger_to_target_ms": stats["p50_trigger_to_target_ms"],
           "p99_trigger_to_target_ms": stats["p99_trigger_to_target_ms"],
           "max_trigger_to_target_ms": stats["max_trigger_to_target_ms"],
           "step_cache_size": cache, "rss_growth_mb": rss_growth,
           "device_mem_delta_bytes": mem1 - mem0,
           "replay_ms": walls["replay"],
           "replay_device_us": prof["device_us_per_call"],
           "replay_kernels": prof["launches_per_call"],
           "replay_top_kernels_us": prof["kernels"],
           "eager_tick_ms": walls["eager"],
           "eager_tick_device_us": eager["device_us_per_call"],
           "eager_tick_launches": eager["launches_per_call"],
           "captured_equals_eager": same,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not (stats["n_resolved"] > 0
            and stats["p99_trigger_to_target_ms"] < SERVICE_MAX_P99_MS
            and cache == 1 and rss_growth < SERVICE_MAX_RSS_GROWTH_MB
            and mem1 == mem0 and same):
        raise RuntimeError(f"service: a gate failed: {res}")


def phase_tier1_bench(torch):
    """E2 and E4 of the paper on the card: the settle medians of the
    280 -> 200 W step per workload, then the 30 s closed loop at 200 Hz
    (3 chips x 3 seeds per workload, one batch each), counting the
    pid_update launches: exactly one per tick.  Bursty's batch (the one
    that drives the integral into its clamp and u onto its ceiling) runs
    again with pid_update's plain version on the same loads: the
    host-power traces and tracking errors must agree."""
    import repro_torch.core.plant as plant
    import repro_torch.experiments as ex
    from repro_torch.kernels import ops
    from repro_torch.kernels.pid_update import pid_update, pid_update_ref
    t_phase = time.perf_counter()
    e2 = {w: float(np.median(ex.e2_settle_ms(w, device="cuda")))
          for w in plant.WORKLOADS}
    n_ticks = int(ex.E4_HORIZON_S * plant.CONTROL_HZ)
    env = ex.e4_envelope(n_ticks)
    loads = {w: ex.e4_loads(w, ex.E4_SEEDS, n_ticks, device="cuda")
             for w in plant.WORKLOADS}
    ex.e4_trace_batch(loads["matmul"][:, :5], env[:5], 6.0, device="cuda")
    torch.cuda.synchronize()
    pid_update.launches = 0
    t0 = time.perf_counter()
    traces = {w: ex.e4_trace_batch(loads[w], env, plant.workload_tau_ms(w),
                                   device="cuda") for w in plant.WORKLOADS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pid_update.launches
    ticks = n_ticks * len(plant.WORKLOADS)
    errs = {w: ex.e4_tracking_err(traces[w], loads[w], env)
            for w in plant.WORKLOADS}
    kernel = ops.pid_update
    ops.pid_update = pid_update_ref
    try:
        plain_trace = ex.e4_trace_batch(
            loads["bursty"], env, plant.workload_tau_ms("bursty"),
            device="cuda")
    finally:
        ops.pid_update = kernel
    plain_err = ex.e4_tracking_err(plain_trace, loads["bursty"], env)
    trace_err = float((traces["bursty"] - plain_trace).abs().max())
    err_diff = float((errs["bursty"] - plain_err).abs().max())
    errs = {w: v.cpu().numpy() for w, v in errs.items()}
    flags = ex.e4_in_band(errs)
    emit({"phase": "tier1_bench",
          "e2_settle_ms_median": e2, "e2_paper_ms": ex.E2_PAPER_MS,
          "e4_seeds": list(ex.E4_SEEDS), "e4_chips": ex.E4_CHIPS,
          "e4_ticks": ticks,
          "e4_tracking_err_pct": {w: float(v[0]) for w, v in errs.items()},
          "e4_tracking_err_pct_seed_mean": {w: float(v.mean())
                                            for w, v in errs.items()},
          "e4_paper_pct": ex.E4_PAPER_PCT, **flags,
          "pid_update_launches": launches, "e4_wall_s": wall,
          "e4_ms_per_tick": wall / ticks * 1e3,
          "bursty_vs_plain": {"host_power_max_abs_w": trace_err,
                              "tracking_err_max_abs_pct": err_diff,
                              "tol": {"host_power": E4_TRACE_TOL,
                                      "tracking_err_atol_pct":
                                      E4_ERR_ATOL_PCT}},
          "seconds": time.perf_counter() - t_phase})
    if launches != ticks:
        raise RuntimeError(f"tier1_bench: pid_update launched {launches} "
                           f"times in {ticks} ticks")
    if not all(flags.values()):
        raise RuntimeError(f"tier1_bench: an in-band flag failed: {flags}")
    torch.testing.assert_close(traces["bursty"], plain_trace,
                               **E4_TRACE_TOL)
    if not err_diff <= E4_ERR_ATOL_PCT:
        raise RuntimeError(f"tier1_bench: bursty's tracking errors through "
                           f"the kernel and its plain version differ by "
                           f"{err_diff} %")
    return launches


def phase_fr_latency(torch):
    """E7 on the card's host: 90 FFR triggers through the port's
    SafetyIsland on UDP (trigger-to-caps wall time plus the plant's settle
    on the card), all under the 700 ms budget; then the contrast arm, the
    same trigger through PythonSupervisor under AllocationChurn (printed,
    not enforced)."""
    import repro_torch.core.plant as plant
    import repro_torch.experiments as ex
    t_phase = time.perf_counter()
    res = ex.e7_island_trials(FR_LATENCY_PORT, device="cuda")
    per = res["per_workload"]
    lat = np.concatenate([per[w] for w in plant.WORKLOADS])
    disp = np.asarray(res["dispatch_us"])
    budget = ex.E7_BUDGET_MS
    n_under = int((lat < budget).sum())
    sup = ex.e7_supervisor_trials(res["rng"], 90)
    median = float(np.median(lat))
    emit({"phase": "fr_latency", "trials": int(lat.size),
          "under_budget": f"{n_under}/{lat.size}", "budget_ms": budget,
          "median_ms": median, "max_ms": float(lat.max()),
          "margin_x": budget / median,
          "median_ms_by_workload": {w: float(np.median(per[w]))
                                    for w in plant.WORKLOADS},
          "paper": ex.E7_PAPER,
          "island_dispatch_us_median": float(np.median(disp)),
          "island_dispatch_us_p99": float(np.percentile(disp, 99)),
          "supervisor_triggers": int(sup.size),
          "supervisor_dispatch_ms_median": float(np.median(sup)),
          "supervisor_dispatch_ms_p99": float(np.percentile(sup, 99)),
          "island_vs_supervisor_p99_x": float(
              np.percentile(sup, 99)
              / max(np.percentile(disp, 99) / 1e3, 1e-6)),
          "seconds": time.perf_counter() - t_phase})
    if lat.size != 3 * ex.E7_TRIALS_PER_WORKLOAD or n_under != lat.size:
        raise RuntimeError(f"fr_latency: {n_under}/{lat.size} trials under "
                           f"the {budget} ms budget")


def twin_tick_profile(torch, twin, cfg, inp):
    """Wall time, device time, launches and busy share of one twin tick
    over the stacked scenarios (100 ticks; plant noise drawn beforehand
    in one block, as the loop draws it per hour)."""
    n, H, C = inp.loads.shape[0], cfg.n_hosts, cfg.chips_per_host
    noise = twin.plant_noise(inp.seed, 0, 100, H, C)
    box = [twin.twin_carry_init(H, C, n, inp.loads.device)]

    def tick(t=0):
        box[0], _ = twin.twin_tick(
            H, C, cfg.chip_tdp, cfg.pue_design, box[0], inp.loads[:, t],
            inp.mu_sec[:, t], inp.rho_sec[:, t], inp.ffr_sec[:, t],
            inp.t_amb_sec[:, t], noise[:, t])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(100):
        tick(t)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / 100 * 1e3
    prof = profile_calls(torch, tick, 100)
    return {"tick_ms": tick_ms,
            "device_us": prof["device_us_per_call"],
            "launches": prof["launches_per_call"],
            "device_busy_share": prof["device_us_per_call"] / 1e3 / tick_ms,
            "kernels": prof["kernels"]}


def phase_twin(torch):
    """Fig. 4 on the card: a probe hour, one tick's profile, the net-CO2
    decomposition at 50 MW for CH/IT/DE and 1 h of seed 0 on the CPU and
    on the card with the same inputs; then benchmarks/cluster_24h.py's
    configuration (100 hosts x 3 chips, the DE grid, seeds 0-2 as one
    run_twin_batch) over 24 h or the longest whole number of hours the
    probe says fits what is left of the phase's budget."""
    import dataclasses
    import repro_torch.core.twin as twin
    from repro_torch.grid import signals
    t_phase = time.perf_counter()
    grid = signals.make_grid("DE", 48, seed=0)
    cfg1 = twin.TwinConfig(n_hosts=100, chips_per_host=3, seconds=3600,
                           seed=0)

    def scenarios(cfg, device="cuda"):
        return [twin.prepare_scenario(cfg, grid, seed=s, device=device)
                for s in TWIN_SEEDS]

    # rate probe: one simulated hour of the three seeds
    probe = scenarios(cfg1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin.run_twin_batch(cfg1, probe)
    torch.cuda.synchronize()
    s_per_h = time.perf_counter() - t0
    prof = twin_tick_profile(torch, twin, cfg1,
                             twin.stack_scenarios(probe))
    cfg50 = twin.TwinConfig(n_hosts=int(50e6 / (3 * 300.0) / 10),
                            chips_per_host=3, seconds=86_400, seed=0)
    co2 = {c: twin.net_co2_decomposition(
        cfg50, signals.make_grid(c, 48, seed=0), {}, device="cuda")
        for c in CO2_PAPER_PCT}
    cpu_vs_gpu = twin_cpu_vs_gpu(torch, twin, cfg1, grid)
    left_s = TWIN_BUDGET_S - (time.perf_counter() - t_phase)
    hours = max(1, min(24, int(left_s // s_per_h)))
    cfg = dataclasses.replace(cfg1, seconds=hours * 3600)
    t0 = time.perf_counter()
    scens = scenarios(cfg)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, summaries = twin.run_twin_batch(cfg, scens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (all_finite(torch, tuple(out))
            and all(math.isfinite(v) or k.startswith("mean_mu")
                    or k == "q_ffr" for s in summaries
                    for k, v in s.items())):
        raise RuntimeError("twin: a non-finite output")
    sim_s = len(TWIN_SEEDS) * cfg.seconds
    res = {"phase": "twin", "hosts": cfg.n_hosts,
           "chips_per_host": cfg.chips_per_host,
           "scenarios": len(TWIN_SEEDS), "hours": hours,
           "cut": None if hours == 24 else
           f"horizon cut from 24 h to {hours} h by the time budget",
           "probe_s_per_hour": s_per_h, "prepare_s": prep_s, "wall_s": wall,
           "scenario_s_per_wall_s": sim_s / wall,
           "ms_per_tick": wall / cfg.seconds * 1e3,
           "tick_profile": prof, "peak_mem_bytes": peak,
           "summary_seed0": {k: v if math.isfinite(v) else None
                             for k, v in summaries[0].items()},
           "paper": TWIN_PAPER,
           "ar4_mae_norm_seed_std": float(np.std(
               [s["ar4_mae_norm"] for s in summaries])),
           "net_co2_50mw": {c: {"net_savings_pct": d["net_savings_pct"],
                                "exogenous_savings_pct":
                                    d["exogenous_savings_pct"],
                                "paper_net_pct": CO2_PAPER_PCT[c]}
                            for c, d in co2.items()},
           "cpu_vs_gpu": cpu_vs_gpu}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)


def twin_cpu_vs_gpu(torch, twin, cfg, grid):
    """1 h of seed 0 on the CPU and on the card with the same demand,
    plant noise, FFR events and schedule, held at the CPU tolerances."""
    scen = twin.prepare_scenario(cfg, grid, seed=0, device="cpu")
    noise = twin.plant_noise(scen.inputs.seed[None], 0, cfg.seconds,
                             cfg.n_hosts, cfg.chips_per_host)[0]
    kw = dict(loads=scen.inputs.loads, noise=noise,
              ops=(scen.mu_h, scen.rho_h))
    out_c, a = twin.run_twin(cfg, grid, scen.events, device="cpu", **kw)
    out_g, b = twin.run_twin(cfg, grid, scen.events, device="cuda", **kw)
    if not torch.equal(out_c.ffr_active, out_g.ffr_active.cpu()):
        raise RuntimeError("twin cpu vs gpu: FFR flags differ")
    worst = {}
    for k, tol in (("it_energy_mwh", "energy"),
                   ("facility_energy_mwh", "energy"),
                   ("chip_power_mean", "energy"), ("q_ffr", "energy"),
                   ("ar4_mae_norm", "rls"), ("ar4_p95_norm", "rls"),
                   ("tracking_err_mean", "rls")):
        d = abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
        if not d <= TWIN_TOL[tol]:
            raise RuntimeError(f"twin cpu vs gpu: {k} {a[k]} vs {b[k]}")
        worst[k] = d
    return {"hours": cfg.seconds // 3600, "n_events": len(scen.events),
            "max_rel_err": worst, "tol": TWIN_TOL}


def phase_reserve(torch, engine):
    """E9's separate reserve replay on the card: reserve_replay_batch over
    the full E9 batch (288 scenarios x 24 h of 1 Hz frequency) at the
    Tier-3 selection's hourly mu; 8 lanes against the per-event oracle;
    the event counts against the fused engine's on the engine phase's
    horizon; then report.sweep_telemetry(fast=True) over SLICE_HOURS
    rendered."""
    import dataclasses
    import io
    import repro_torch.core.engine as eng
    import repro_torch.core.reserve as reserve
    from repro_torch.grid import frequency
    from repro_torch.grid.scenarios import (build_scenario_batch,
                                            frequency_seeds)
    from repro_torch.obs import report
    t_phase = time.perf_counter()
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=4.0)

    def replay(hours, mu_h=None):
        batch = build_scenario_batch(e9_specs(hours), device="cuda")
        T = hours * 3600
        freq, _ = frequency.synthesize_frequency_batch(
            frequency_seeds(batch), batch.product_idx, n_seconds=T,
            events_per_day=cfg.events_per_day,
            max_events=cfg.max_freq_events, device="cuda")
        if mu_h is None:
            mu_h = eng.engine_rollout(dataclasses.replace(
                cfg, with_seconds=False), batch, device="cuda")["mu_h"]
        args = (freq, mu_h, batch.t_amb, batch.hours * 3600,
                batch.product_idx, batch.reserve_rho, batch.mw,
                batch.pue_design)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reserve.reserve_replay_batch(*args, e_max=cfg.e_max,
                                           device="cuda")
        torch.cuda.synchronize()
        return out, args, time.perf_counter() - t0

    out, args, wall = replay(24)
    if not all_finite(torch, out["events"]._asdict()):
        raise RuntimeError("reserve: a non-finite verdict")
    n = args[0].shape[0]
    lanes = np.linspace(0, n - 1, RESERVE_ORACLE_LANES).astype(int)
    host = [a.cpu().numpy() for a in args]
    worst = 0.0
    for i in lanes:
        ref = reserve.reserve_replay_reference(
            *(a[i] for a in host), e_max=cfg.e_max)
        got = {k: v[i].cpu().numpy() for k, v in out["events"]._asdict()
               .items()}
        same = (int(out["n_events"][i]) == ref["n_events"]
                and int(out["active_s"][i]) == ref["active_s"]
                and all(np.array_equal(got[k], getattr(ref["events"], k))
                        for k in ("t_event_s", "valid", "budget_ok",
                                  "sustain_ok", "delivered_ok",
                                  "compliant")))
        if not same:
            raise RuntimeError(f"reserve: lane {i} differs from the oracle")
        for k in ("t_full_ms", "sustain_s", "delivered_mw",
                  "delivered_frac"):
            np.testing.assert_allclose(got[k], getattr(ref["events"], k),
                                       rtol=RESERVE_FLOAT_RTOL, atol=1e-6)
            worst = max(worst, float(np.max(
                np.abs(got[k] - getattr(ref["events"], k))
                / np.maximum(np.abs(getattr(ref["events"], k)), 1e-6))))
    # the same frequency and operating points through the fused engine:
    # its detection runs in its tick, so the event counts must agree
    if engine["hours"] == 24:
        out_e = out
    else:
        out_e, _, _ = replay(engine["hours"], engine["mu_h"])
    if not torch.equal(out_e["n_events"], engine["n_events"]):
        raise RuntimeError("reserve: event counts differ from the engine's")
    t0 = time.perf_counter()
    tel = report.sweep_telemetry(fast=True, device="cuda",
                                 hours=SLICE_HOURS)
    buf = io.StringIO()
    report.render_telemetry(tel, out=buf)
    report_s = time.perf_counter() - t0
    text = buf.getvalue()
    if "deadline" not in text or "FFR" not in text:
        raise RuntimeError("reserve: the telemetry report is incomplete")
    emit({"phase": "reserve", "scenarios": n, "hours": 24,
          "freq_bytes": args[0].numel() * args[0].element_size(),
          "wall_s": wall, "ms_per_batch": wall * 1e3,
          "scenario_days_per_s": n / wall,
          "ms_per_tick": wall / (24 * 3600) * 1e3,
          "n_events": int(out["n_events"].sum()),
          "n_compliant": int((out["events"].valid
                              & out["events"].compliant).sum()),
          "oracle_lanes": lanes.tolist(), "oracle_float_max_rel_err": worst,
          "engine_hours": engine["hours"],
          "engine_event_counts_equal": True,
          "report_s": report_s, "report_lines": text.count("\n"),
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# Training: flash_attention's backward kernels and the trainer
# ---------------------------------------------------------------------------

# the backward's gradients against autograd through the plain version
FLASH_BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
                 "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# products of the backward over the visible pairs: flash_bwd_dq recomputes
# S and does dP and dq (3), flash_bwd_dkdv S, dP, dv and dk (4); the least
# work of the whole gradient is 5 (S, dP, dq, dk, dv), 2.5x the forward's
FLASH_BWD_PRODUCTS = {"flash_bwd_dq": 3, "flash_bwd_dkdv": 4, "pair": 5}
TRAIN_ATTN_SHAPE = (2, 2048, 12, 2, 128)  # qwen2-1.5b's call in training
# train_tp's calls at a rank's heads (yi-9b: 16 of 32 query heads, 2 of 4
# kv heads; mamba2-1.3b: 32 of 64 heads), timed alone with the card to
# this process in flash_bwd and ssd_bwd (the ranks time-slice it there)
TP_ATTN_SHAPE = (2, 2048, 16, 2, 128)
TP_SSD_SHAPE = (2, 2048, 32, 64, 128, 256)
# the backward wrappers' bf16 ms at the prefill call and (per launch) in
# the train phase's profiled step, from an earlier call of this script on
# another card (the scalar f32-FMA kernels before the wgmma redesign,
# NVIDIA H100 80GB HBM3, 700 W)
FLASH_BWD_PREV_MS = {"prefill": {"flash_bwd_dq": 9.717,
                                 "flash_bwd_dkdv": 10.635},
                     "train": {"flash_bwd_dq": 2.58, "flash_bwd_dkdv": 4.90}}
TRAIN_SHAPE = (2, 2048)            # global batch x seq of the train phase
TRAIN_STEPS = 8
TRAIN_TRIGGER_AFTER = 3            # fire_test_trigger after this step
TRAIN_ISLAND_PORT = 47681          # UDP port of the train phase's island
TRAIN_CUT_LAYERS = 2               # the kernels-vs-plain check's depth
# the MoE, VLM and enc-dec families' cuts: (arch, (batch, positions));
# phi-3-vision's 2048 positions are 576 image embeddings and 1472 tokens,
# whisper's 448 decoder tokens come with (1, 1500, 1024) frames
TRAIN_CUTS = (("olmoe-1b-7b", (1, 2048)), ("phi-3-vision-4.2b", (1, 2048)),
              ("whisper-medium", (1, 448)))
TRAIN_CUT_REL = 2e-2               # bf16, norm-relative per leaf
# the hybrid's third conditioning witness: each backward kernel call of
# the cut's bf16 step within 1e-2 of its plain version on the call's own
# inputs, per gradient, norm-relative (the scan's bf16 gate, SSD_BF16_REL)
TRAIN_CUT_CALL_REL = 1e-2
TRAIN_CUT_F32_REL = 1e-4           # the same cut in f32 compute, per leaf
# the SSM and hybrid train phases: mamba2-1.3b and zamba2-2.7b under their
# configs' plan (remat "dots", 4 microbatches), one 2048-token sequence per
# microbatch
TRAIN_SSM_SHAPE = (4, 2048)
TRAIN_SSM_STEPS = 4
TRAIN_SSM_TRIGGER_AFTER = 1
# a shed quantum of 2 steps, so the shed skips a step inside so short a run
# (the trainer's default quantum of 10 would run all of steps 2-3)
TRAIN_SSM_DUTY_QUANTUM = 2
TRAIN_SSM_PORTS = {"train_ssm": 47682, "train_hybrid": 47683}
# the MoE, VLM and enc-dec families through the Trainer at full width:
# (phase, arch, (batch, positions), layers, or None for the config's
# depth); whisper's 448 decoder tokens come with (4, 1500, 1024) frames,
# phi-3-vision's 2048 positions are 576 image embeddings and 1,472 tokens;
# olmoe-1b-7b at 8 of its 16 layers: 16 are 110.8 GB of f32 parameters,
# moments and gradients
TRAIN_FAMILIES = (("train_encdec", "whisper-medium", (4, 448), None),
                  ("train_vlm", "phi-3-vision-4.2b", (4, 2048), None),
                  ("train_moe", "olmoe-1b-7b", (4, 2048), 8))
# 3 steps (cut from train_ssm's 4 for the run time), an FFR trigger after
# step 1 and a shed quantum of 3: steps 0 and 1 run, the shed skips step 2
TRAIN_FAMILY_STEPS = 3
TRAIN_FAMILY_DUTY_QUANTUM = 3
TRAIN_FAMILY_PORTS = {"train_encdec": 47684, "train_vlm": 47685,
                      "train_moe": 47686}
# the trainer's step-0 loss against the plain versions' on the same batch
# and weights, bf16 (tests/test_torch_train.py's BF16_LOSS)
STEP0_LOSS_TOL = dict(rtol=2e-2, atol=2e-2)
CKPT_ARCH, CKPT_SHAPE = "smollm-135m", (2, 512)
CKPT_STEPS, CKPT_RESTART_STEPS = 4, 6
CKPT_LOSS_RTOL = 1e-5


def flash_bwd_cases():
    """(shape (B, S, H, Hkv, D), dtype name, window, Sk or None, causal)
    of the backward check: qwen2-1.5b's prefill and training calls and
    zamba2-2.7b's training call (head dim 80), then small and odd shapes
    in both dtypes -- head dims 64 and 80, windows, S not a multiple of
    the 64-row tiles, Sq > Sk; then phi-3-vision-4.2b's training call
    (head dim 96), a small D = 96 case with a window in both dtypes, and
    whisper-medium's non-causal encoder and cross calls (Sk = 1500)."""
    cases = ([(PREFILL_SHAPE, "bfloat16", 0, None),
              (TRAIN_ATTN_SHAPE, "bfloat16", 0, None),
              (ZAMBA2_TRAIN_ATTN_SHAPE, "bfloat16", 0, None)]
             + [(shape, dt, w, None)
                for shape, w in (((2, 256, 4, 2, 64), 0),
                                 ((1, 200, 6, 2, 80), 24),
                                 ((1, 300, 12, 2, 128), 0),
                                 ((1, 1000, 12, 2, 128), 100))
                for dt in ("float32", "bfloat16")]
             + [((1, 256, 4, 2, 64), "bfloat16", 0, 100)])
    return ([c + (True,) for c in cases]
            + [(PHI3_TRAIN_ATTN_SHAPE, "bfloat16", 0, None, True)]
            + [((1, 200, 4, 2, 96), dt, 24, None, True)
               for dt in ("float32", "bfloat16")]
            + [(WHISPER_ENC_SHAPE, dt, 0, None, False)
               for dt in ("float32", "bfloat16")]
            + [(WHISPER_CROSS_SHAPE, "bfloat16", 0, WHISPER_CROSS_SK,
                False)])


def flash_bwd_bound(shape, products, window=0, causal=True, sk=None):
    """(ms, bound_by, flop) of ``products`` bf16 products over the visible
    pairs against reading q, k, v, o, dO and the LSE once and writing dq,
    dk, dv once."""
    b, s, h, hkv, d = shape
    sk = sk or s
    _, _, fwd_flops, _ = flash_bound_ms(shape, "bfloat16", window, causal,
                                        sk)
    flops = fwd_flops / 2 * products        # the forward is 2 products
    nbytes = 2 * b * d * (3 * h * s + 2 * hkv * sk) + 2 * b * d * (
        h * s + 2 * hkv * sk) + 4 * b * h * s
    t_ops = flops / TENSOR_CORE_BF16_FLOP_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", flops


def sm_count(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def plain_grads(torch, q, k, v, do, window, causal=True):
    from repro_torch.kernels import flash_attention as fa
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, do)


def sdpa_grads(torch, q, k, v, do):
    """dq, dk, dv through scaled_dot_product_attention (causal, GQA) on
    (B, H, S, D) copies, returned in (B, S, H, D)."""
    import torch.nn.functional as F
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(True)
              for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
    return [x.transpose(1, 2) for x in grads]


def time_flash_bwd(torch, g, shape, plain_reps, causal=True, sk=None):
    """Cold-L2 device times at one bf16 call (non-causal with ``sk`` keys
    where asked): the two wrappers
    (each the sum of its kernels per call, flash_bwd_dkdv_sum included
    when the call splits) and together, the plain version's backward
    (autograd through flash_attention_ref; skipped for plain_reps = 0)
    and SDPA's backward (the yardstick; the port never calls it), each
    through torch.autograd.grad where autograd is involved; each
    wrapper's TFLOP/s and share of its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hkv, _ = shape

    def one_set():
        q, k, v = flash_inputs(torch, g, shape, torch.bfloat16, sk)
        do = torch.randn_like(q)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        return q, k, v, o, do, lse
    first = one_set()
    set_bytes = sum(x.numel() * x.element_size() for x in first)
    n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
    sets = [first] + [one_set() for _ in range(n_sets - 1)]

    def kernels(q, k, v, o, do, lse):
        return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)

    def graphs(fwd, layout):
        out = []
        for q, k, v, _, do, _ in sets:
            leaves = [layout(x).detach().requires_grad_(True)
                      for x in (q, k, v)]
            out.append((fwd(*leaves), leaves, layout(do)))
        return out

    def grad_call(built):
        turn = itertools.count()

        def call(_i=0):
            o, leaves, do = built[next(turn) % len(built)]
            kept.append(torch.autograd.grad(o, leaves, do,
                                            retain_graph=True))
        return call

    kept = []
    # each kernel the call launches, once a call (dkdv's sum only where
    # the call splits its GQA group): timed by its mean per launch
    splits = fa.dkdv_splits(b, hkv, h // hkv, sk or s, sm_count(torch))
    groups = {name: tuple(k for k in ks if splits > 1
                          or k != "flash_bwd_dkdv_sum")
              for name, ks in fa.BWD_KERNELS[torch.bfloat16].items()}
    launched = {k: (k,) for ks in groups.values() for k in ks}
    prof_k = profile_calls(torch, cycled(sets, kernels, kept), 10,
                           groups=launched, require=tuple(launched),
                           once=True)
    kept.clear()
    sdpa = graphs(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True),
        lambda x: x.transpose(1, 2).contiguous())
    prof_l = profile_calls(torch, grad_call(sdpa), 10)
    kept.clear()
    del sdpa
    plain_ms = None
    if plain_reps:
        plain = graphs(lambda q, k, v: fa.flash_attention_ref(
            q, k, v, causal=causal), lambda x: x)[:1]
        prof_p = profile_calls(torch, grad_call(plain), plain_reps)
        plain_ms = prof_p["rounded_us_per_call"] / 1e3
        kept.clear()
        del plain
    del sets, first
    torch.cuda.empty_cache()
    per = {m: sum(prof_k["group_us_per_call"][k] for k in ks) / 1e3
           for m, ks in groups.items()}
    rec = {}
    for name, ms in per.items():
        bound_ms, bound_by, flops = flash_bwd_bound(
            shape, FLASH_BWD_PRODUCTS[name], 0, causal, sk)
        rec[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / ms, "gflop": flops / 1e9,
                     "tflop_s": flops / (ms * 1e-3) / 1e12,
                     "kernels": list(groups[name])}
    pair_bound, _, pair_flops = flash_bwd_bound(
        shape, FLASH_BWD_PRODUCTS["pair"], 0, causal, sk)
    pair_ms = sum(per.values())
    library_ms = prof_l["rounded_us_per_call"] / 1e3
    return {"shape": list(shape), "dtype": "bfloat16", "window": 0,
            "causal": causal, "sk": sk or s,
            "splits": splits, "kernels": rec, "ms": per,
            "pair_ms": pair_ms,
            "pair_bound_ms": pair_bound, "pair_bound_share":
                pair_bound / pair_ms,
            "pair_tflop_s_5_products": pair_flops / (pair_ms * 1e-3) / 1e12,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "pair_over_library": pair_ms / library_ms,
            "library_kernels": prof_l["kernels"], "cold_sets": n_sets}


def phase_flash_bwd(torch):
    """flash_attention's two backward wrappers against autograd through the
    plain version (f32 1e-4, bf16 2e-2) at qwen2-1.5b's prefill and
    training calls, zamba2-2.7b's and phi-3-vision-4.2b's training calls,
    whisper-medium's non-causal encoder and cross calls and at small and
    odd shapes, each run twice and held to bitwise equality, the forward's
    LSE against the plain one, SDPA's backward's own error at the prefill
    call (context, not a gate), the device times at those six calls and
    at train_tp's rank call (TP_ATTN_SHAPE, forward too) beside the bound
    and SDPA's, and the bf16 kernels' resources from
    the CUDA runtime (no local memory at D = 96 or 128); returns the two
    wrappers' records of the {"kernels": ...} line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(11)
    checks, worst = [], {"flash_bwd_dq": 0.0, "flash_bwd_dkdv": 0.0}
    sdpa_err = None
    for shape, dt, window, sk, causal in flash_bwd_cases():
        dtype = getattr(torch, dt)
        q, k, v = flash_inputs(torch, g, shape, dtype, sk)
        do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                             window=window)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                     window=window)
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window)
        want = plain_grads(torch, q, k, v, do, window, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"flash_bwd: two runs at {shape} {dt} "
                               f"window {window} differ")
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(),
                                       **FLASH_BWD_TOL[dt])
        _, lse_plain = fa.flash_attention_lse_ref(q, k, v, causal=causal,
                                                  window=window)
        lse_err = float((lse - lse_plain).abs().max())
        torch.testing.assert_close(lse, lse_plain, atol=1e-3, rtol=1e-4)
        if shape == PREFILL_SHAPE and dt == "bfloat16":
            sdpa_err = [float((a.float() - b.float()).abs().max())
                        for a, b in zip(sdpa_grads(torch, q, k, v, do),
                                        want)]
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
        worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"], *errs[1:])
        b, s, h, hkv, _ = shape
        checks.append({"shape": list(shape), "dtype": dt, "window": window,
                       "sk": sk or s, "causal": causal,
                       "max_abs_err_dq_dk_dv": errs,
                       "lse_max_abs_err": lse_err,
                       "splits": fa.dkdv_splits(b, hkv, h // hkv, sk or s,
                                                sm_count(torch))
                       if dt == "bfloat16" else 1,
                       "bitwise_equal_twice": True,
                       "tol": FLASH_BWD_TOL[dt]})
        del q, k, v, do, o, lse, got, again, want
    torch.cuda.empty_cache()
    t = time_flash_bwd(torch, g, PREFILL_SHAPE, plain_reps=4)
    t_train = time_flash_bwd(torch, g, TRAIN_ATTN_SHAPE, plain_reps=0)
    t_hybrid = time_flash_bwd(torch, g, ZAMBA2_TRAIN_ATTN_SHAPE, plain_reps=0)
    t_phi3 = time_flash_bwd(torch, g, PHI3_TRAIN_ATTN_SHAPE, plain_reps=0)
    t_enc = time_flash_bwd(torch, g, WHISPER_ENC_SHAPE, plain_reps=2,
                           causal=False)
    t_cross = time_flash_bwd(torch, g, WHISPER_CROSS_SHAPE, plain_reps=2,
                             causal=False, sk=WHISPER_CROSS_SK)
    t_tp = time_flash_bwd(torch, g, TP_ATTN_SHAPE, plain_reps=0)
    t_tp_fwd = time_flash(torch, g, TP_ATTN_SHAPE, 0)
    build = {d: fa.bwd_kernel_info(torch.bfloat16, d) for d in (80, 96, 128)}
    spilled = {(d, k): v for d in (96, 128) for k, v in build[d].items()
               if v["local_bytes"]}
    if spilled:
        raise RuntimeError(f"flash_bwd: the bf16 kernels at D = 96 or 128 "
                           f"use local memory (spills): {spilled}")
    # printed as context only: empty when this process found the library
    # already built
    ptxas = {k: v for k, v in ptxas_by_kernel(_build.PTXAS_REPORT.get(
        "flash_attention_bwd", "")).items() if "flash_bwd" in k
        and ("128" in k or "80" in k or "96" in k or "_sum" in k)}
    recs = []
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        k_pre, k_train = t["kernels"][name], t_train["kernels"][name]
        recs.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:139",
            "max_abs_err": worst[name], "ms": k_pre["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": k_pre["bound_ms"],
            "bound_by": k_pre["bound_by"], "library_ms": t["library_ms"],
            "shape": list(PREFILL_SHAPE), "dtype": "bfloat16",
            "kernels_bf16": list(fa.BWD_KERNELS[torch.bfloat16][name]),
            "splits": t["splits"], "ms_train_call": k_train["ms"],
            "ms_train_call_d80": t_hybrid["kernels"][name]["ms"],
            "calls": {label: {"shape": c["shape"], "causal": c["causal"],
                              "sk": c["sk"],
                              "ms": c["kernels"][name]["ms"],
                              "bound_ms": c["kernels"][name]["bound_ms"],
                              "bound_by": c["kernels"][name]["bound_by"],
                              "plain_ms_pair": c["plain_ms"],
                              "library_ms_pair": c["library_ms"]}
                      for label, c in (("phi-3-vision-4.2b", t_phi3),
                                       ("whisper-medium encoder", t_enc),
                                       ("whisper-medium cross", t_cross),
                                       ("train_tp rank, yi-9b", t_tp))}})
    emit({"phase": "flash_bwd", "checks": checks,
          "prefill_call": t, "train_call": t_train,
          "train_call_hybrid": t_hybrid, "train_call_phi3": t_phi3,
          "whisper_encoder": t_enc, "whisper_cross": t_cross,
          "train_tp_rank_call": t_tp,
          "train_tp_rank_call_forward": {k: t_tp_fwd[k] for k in (
              "shape", "ms", "plain_ms", "library_ms", "ms_over_library",
              "bound_ms", "bound_by", "bound_share", "tflop_s")},
          "sdpa_max_abs_err_dq_dk_dv": sdpa_err,
          "kernels_max_abs_err": worst,
          "prev_ms": FLASH_BWD_PREV_MS,
          "prev_ms_from": "an earlier call of this script on another card "
                          "(the scalar f32-FMA kernels before the wgmma "
                          "redesign; the training call's from the train "
                          "phase's profiled step)",
          "plain": "autograd through flash_attention_ref (dq, dk, dv "
                   "together)",
          "library": "torch.autograd.grad through scaled_dot_product_"
                     "attention(is_causal=causal, enable_gqa=True) on "
                     "(B, H, S, D): dq, dk and dv together",
          "build": build, "ptxas": ptxas,
          "seconds": time.perf_counter() - t_phase})
    return recs


# the scan's gradient against its plain version (ssd_scan_bwd_ref) and
# autograd through ssd_scan_ref.  f32: 1e-4 of each gradient's scale, as
# ||k - p|| <= 1e-4 ||p|| and max |k - p| <= 1e-4 max |p| (elementwise
# 1e-4 does not hold even between the plain version and autograd: the
# gradients reach |g| ~ 1e4 at the training calls, and elements that cancel
# keep ~1e-3 of rounding; all three sit ~3e-7 from the float64 gradient).
# bf16: norm-relative per gradient within 1.25x the plain version's own
# bf16 error from the f32 inputs' gradient (as the bf16 forward is held).
SSD_BWD_F32 = 1e-4
SSD_BWD_BF16_VS_PLAIN = 1.25
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
# (b, s, nh, hd, ds, chunk) of the training calls: one sequence of 2048 per
# microbatch of the (4, 2048) global batch
SSD_TRAIN = {"mamba2-1.3b": (1, 2048, 64, 64, 128, 256),
             "zamba2-2.7b": (1, 2048, 80, 64, 64, 256)}
# the bf16 backward's time at those calls and mamba2's prefill call before
# its tensor-core kernels (the four f32-FMA kernels, from an earlier call
# of this script on another card; tools/ssd_bwd_variants.py times both in
# one call)
SSD_BWD_PREV_MS = {"mamba2-1.3b": 3.118, "zamba2-2.7b": 2.236,
                   "prefill mamba2-1.3b": 13.11}
ZAMBA2_TRAIN_ATTN_SHAPE = (1, 2048, 32, 32, 80)  # its shared block, training
PHI3_TRAIN_ATTN_SHAPE = (1, 2048, 32, 32, 96)    # phi-3-vision's, training


def ssd_bwd_cases():
    """(shape, dtype name) of the backward check: both training calls and
    mamba2's prefill call, then small and odd shapes (chunks 8-256, hd 16-64,
    ds 16-128, b 1-2) in both dtypes."""
    return ([(shape, dt) for shape in SSD_TRAIN.values()
             for dt in ("bfloat16", "float32")]
            + [(SSD_PREFILL["mamba2-1.3b"], "bfloat16")]
            + [(shape, dt) for shape in ((1, 64, 4, 16, 16, 8),
                                         (2, 128, 8, 16, 32, 16),
                                         (2, 96, 4, 16, 16, 32),
                                         (1, 256, 16, 32, 64, 64),
                                         (2, 48, 3, 32, 128, 16),
                                         (2, 512, 4, 64, 128, 128),
                                         (1, 512, 3, 64, 64, 256))
               for dt in ("float32", "bfloat16")])


def ssd_bwd_inputs(torch, g, b, s, nh, hd, ds, dtype):
    """(x, dt, A, B, C, dy) in ``dtype`` (dt, A float32; B and C halves of
    one (b, s, 2 ds) projection, as the model passes them) and the same in
    float32 before the cast."""
    def n(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    x, dy = n(b, s, nh, hd), n(b, s, nh, hd)
    dt = torch.nn.functional.softplus(n(b, s, nh))
    A = -torch.exp(0.5 * n(nh))
    bc = n(b, s, 2 * ds)
    f32 = (x, dt, A, *bc.chunk(2, dim=-1), dy)
    B, C = bc.to(dtype).chunk(2, dim=-1)
    return (x.to(dtype), dt, A, B, C, dy.to(dtype)), f32


def ssd_bwd_bound_ms(shape, dtype):
    """The least work of the gradient of one call, causal halves counted
    once: per (b, chunk) C B^T and the dB and dC products over the
    triangle (B and C are shared by every head, so dC_i = sum_j W_ij B_j
    and dB_j = sum_i W_ij C_i with W_ij = sum_h L^h_ij dt^h_j dyx^h_ij
    summed elementwise first); per head dy x^T and the decayed weights
    into dx (2 products over the triangle), and five (hd x Q) . (Q x ds)
    products with the states (the chunk state to recompute, its dy-side
    gradient, the state read into dC, dS into dx and into dB); against
    reading x, dt, B, C, dy once and writing dx, ddt, dB, dC once.
    Returns (ms at the dtype's peak, bound_by, flop, bytes)."""
    b, s, nh, hd, ds, q = shape
    nc = s // q
    tri = q * (q + 1) // 2
    macs = b * nc * (3 * tri * ds + nh * (2 * tri * hd + 5 * q * hd * ds))
    flops = 2.0 * macs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * (3 * b * s * nh * hd + 4 * b * s * ds) + 4 * (
        2 * b * s * nh + 2 * nh)
    peak = TENSOR_CORE_BF16_FLOP_S if dtype == "bfloat16" else FP32_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def ssd_autograd(torch, args, chunk):
    """dx, ddt, dA, dB, dC by autograd through ssd_scan_ref."""
    from repro_torch.kernels import ssd_scan as sk
    leaves = [t.detach().clone().requires_grad_(True) for t in args[:5]]
    y = sk.ssd_scan_ref(*leaves, chunk)[0]
    return torch.autograd.grad(y, leaves, args[5])


def rel_err(torch, a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def time_ssd_bwd(torch, g, shape):
    """Cold-L2 device time of one bf16 call of the backward (the sum of its
    five kernels) and of the plain version's, at ``shape``."""
    from repro_torch.kernels import ssd_scan as sk
    *dims, chunk = shape
    first = ssd_bwd_inputs(torch, g, *dims, torch.bfloat16)[0]
    set_bytes = sum(x.numel() * x.element_size() for x in first)
    n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
    sets = [first] + [ssd_bwd_inputs(torch, g, *dims, torch.bfloat16)[0]
                      for _ in range(n_sets - 1)]
    kept = []
    prof_k = profile_calls(torch, cycled(
        sets, lambda *a: sk.ssd_scan_bwd(*a, chunk=chunk), kept), 10,
        groups={k: (k,) for k in sk.BWD_KERNELS[torch.bfloat16]},
        require=tuple(sk.BWD_KERNELS[torch.bfloat16]), once=True)
    kept.clear()
    prof_p = profile_calls(torch, cycled(
        sets, lambda *a: sk.ssd_scan_bwd_ref(*a, chunk), kept), 2)
    kept.clear()
    del sets, first
    torch.cuda.empty_cache()
    # each kernel launches once a call: a dropped event lowers the
    # launches seen, another kernel (a fill) would raise them
    per = {k: v / 1e3 for k, v in prof_k["group_us_per_call"].items()}
    names = sk.BWD_KERNELS[torch.bfloat16]
    if prof_k["launches_per_call"] > len(names) or not all(per.values()):
        raise RuntimeError(f"ssd_bwd at {shape}: "
                           f"{prof_k['launches_per_call']} device launches "
                           f"per call ({per}), expected one of each of "
                           f"{names}")
    ms = sum(per.values())
    plan = sk.bwd_plan(*shape, sk.sm_count(torch.device("cuda")))
    bound_ms, bound_by, flops, nbytes = ssd_bwd_bound_ms(shape, "bfloat16")
    f32_bound_ms = flops / FP32_FLOP_S * 1e3
    return {"shape": list(shape), "dtype": "bfloat16", "ms": ms,
            "kernel_ms": per,
            "device_launches_seen_per_call": prof_k["launches_per_call"],
            "plain_ms": prof_p["rounded_us_per_call"] / 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "tflop_s": flops / (ms * 1e-3) / 1e12,
            "f32_cuda_core_bound_ms": f32_bound_ms,
            "f32_cuda_core_share": f32_bound_ms / ms, "cold_sets": n_sets,
            "plan": {k: plan[k] for k in ("heads_per_group", "groups",
                                          "ksplits", "chunk_blocks",
                                          "bc_blocks", "partial_bytes")}}


def ssd_bwd_checks(torch, cases):
    """Each (shape, dtype name) case of the backward twice through the
    kernels, against its plain version and autograd through ssd_scan_ref:
    bitwise equal twice; f32 within SSD_BWD_F32 of each gradient's scale;
    bf16 within SSD_BWD_BF16_VS_PLAIN x the plain version's (and
    autograd's) error from the f32 inputs' gradient.  Raises on a miss;
    returns (one row per case, the worst f32 error against the plain
    version)."""
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device="cuda").manual_seed(21)
    checks, worst = [], 0.0
    for shape, dt in cases:
        *dims, chunk = shape
        args, f32 = ssd_bwd_inputs(torch, g, *dims, getattr(torch, dt))
        got = sk.ssd_scan_bwd(*args, chunk=chunk)
        again = sk.ssd_scan_bwd(*args, chunk=chunk)
        plain = sk.ssd_scan_bwd_ref(*args, chunk)[:5]
        auto = ssd_autograd(torch, args, chunk)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"ssd_bwd: two runs at {shape} {dt} differ")
        row = {"shape": list(shape), "dtype": dt,
               "bitwise_equal_twice": True}
        if dt == "float32":
            for name, k, p, a in zip(SSD_BWD_NAMES, got, plain, auto):
                for ref, label in ((p, "plain"), (a, "autograd")):
                    err = float((k - ref).abs().max())
                    rel = rel_err(torch, k, ref)
                    if not (rel <= SSD_BWD_F32 and err <= SSD_BWD_F32 *
                            float(ref.abs().max())):
                        raise RuntimeError(
                            f"ssd_bwd f32 at {shape}: {name} against the "
                            f"{label} version: norm-relative {rel}, max "
                            f"{err} of {float(ref.abs().max())}")
            row["max_abs_err"] = {n: float((k - p).abs().max())
                                  for n, k, p in zip(SSD_BWD_NAMES, got,
                                                     plain)}
            row["rel_err"] = {n: rel_err(torch, k, p)
                              for n, k, p in zip(SSD_BWD_NAMES, got, plain)}
            row["rel_err_autograd"] = {
                n: rel_err(torch, k, a)
                for n, k, a in zip(SSD_BWD_NAMES, got, auto)}
            worst = max(worst, *row["max_abs_err"].values())
        else:
            exact = sk.ssd_scan_bwd_ref(*f32, chunk)[:5]
            rel = {}
            for name, k, p, a, e in zip(SSD_BWD_NAMES, got, plain, auto,
                                        exact):
                rk, rp, ra = (rel_err(torch, v, e) for v in (k, p, a))
                if not (rk <= SSD_BWD_BF16_VS_PLAIN * rp
                        and rk <= SSD_BWD_BF16_VS_PLAIN * ra):
                    raise RuntimeError(
                        f"ssd_bwd bf16 at {shape}: {name} is {rk} from the "
                        f"f32 gradient, the plain version {rp}, autograd "
                        f"{ra} (limit {SSD_BWD_BF16_VS_PLAIN}x)")
                rel[name] = {"kernels": rk, "plain": rp, "autograd": ra}
            row["rel_err_from_f32"] = rel
            row["max_abs_err"] = {n: float((k.float() - p.float()).abs()
                                           .max())
                                  for n, k, p in zip(SSD_BWD_NAMES, got,
                                                     plain)}
        checks.append(row)
        del args, f32, got, again, plain, auto
        torch.cuda.empty_cache()
    return checks, worst


def ssd_bwd_build_check(torch):
    """The tensor-core kernels' registers, shared memory, local memory
    and resident blocks an SM at the training calls' widths (hd 64, ds 128
    and 64), from the CUDA runtime; fails on local memory (a spill) or, at
    ds 128, on a chunk or dB/dC kernel with fewer than two blocks an
    SM."""
    from repro_torch.kernels import ssd_scan as sk
    info = {f"64x{ds}": sk.bwd_kernel_info(64, ds) for ds in (128, 64)}
    for dims, kernels in info.items():
        for name, k in kernels.items():
            if k["local_bytes"]:
                raise RuntimeError(f"ssd_bwd: {name} at {dims} uses "
                                   f"{k['local_bytes']} bytes of local "
                                   f"memory (a spill): {k}")
    for name in ("ssd_bwd_tc_chunk", "ssd_bwd_tc_bc"):
        k = info["64x128"][name]
        if k["blocks_per_sm"] < 2:
            raise RuntimeError(f"ssd_bwd: {name} has {k['blocks_per_sm']} "
                               f"block an SM at ds 128: {k}")
    return info


def phase_ssd_bwd(torch):
    """ssd_scan's backward against its plain version and autograd through
    ssd_scan_ref at both training calls, mamba2's prefill call and small
    and odd shapes, f32 and bf16, every case twice and bitwise equal
    (:func:`ssd_bwd_checks`); the tensor-core kernels' registers and
    spills (:func:`ssd_bwd_build_check`); then the cold-L2 device time at
    the training calls, the prefill call and train_tp's rank call
    (TP_SSD_SHAPE, forward too) beside the bound, the plain version's and
    the earlier f32-FMA kernels'.  Returns the record of the
    {"kernels": ...}
    line (mamba2-1.3b's training call)."""
    from repro_torch.kernels import ssd_scan as sk
    t_phase = time.perf_counter()
    checks, worst = ssd_bwd_checks(torch, ssd_bwd_cases())
    build = ssd_bwd_build_check(torch)
    g = torch.Generator(device="cuda").manual_seed(22)
    timed = {arch: time_ssd_bwd(torch, g, shape)
             for arch, shape in SSD_TRAIN.items()}
    timed["prefill mamba2-1.3b"] = time_ssd_bwd(torch, g,
                                                SSD_PREFILL["mamba2-1.3b"])
    timed["train_tp rank, mamba2-1.3b"] = time_ssd_bwd(torch, g,
                                                       TP_SSD_SHAPE)
    tp_fwd = time_ssd(torch, g, TP_SSD_SHAPE)
    for call, t in timed.items():
        t["prev_ms"] = SSD_BWD_PREV_MS.get(call)
    m = timed["mamba2-1.3b"]
    rec = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:105",
           "max_abs_err": worst, "ms": m["ms"], "plain_ms": m["plain_ms"],
           "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
           "library_ms": None, "shape": m["shape"], "dtype": "bfloat16",
           "kernels_bf16": list(sk.BWD_KERNELS[torch.bfloat16]),
           "ms_zamba2_train_call": timed["zamba2-2.7b"]["ms"]}
    emit({"phase": "ssd_bwd", "checks": checks,
          "tol": {"float32_scale_rel": SSD_BWD_F32,
                  "bfloat16_vs_plain": SSD_BWD_BF16_VS_PLAIN},
          "timed": timed, "build": build,
          "train_tp_rank_call_forward": {k: tp_fwd[k] for k in (
              "shape", "ms", "plain_ms", "bound_ms", "bound_by",
              "bound_share", "tflop_s")},
          "prev_ms_from": "the f32-FMA kernels that ran the bf16 path "
                          "before the tensor-core ones, in an earlier call "
                          "of this script on another card",
          "plain": "ssd_scan_bwd_ref (the explicit chunked backward in "
                   "torch); autograd through ssd_scan_ref as a second check",
          "library": "none: no PyTorch call computes the SSD scan or its "
                     "gradient",
          "seconds": time.perf_counter() - t_phase})
    return rec


def train_launch_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    return {"flash_attention": fa.flash_attention,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkdv": fa.flash_bwd_dkdv,
            "ssd_scan": sk.ssd_scan, "ssd_scan_bwd": sk.ssd_scan_bwd}


def train_launches_expected(cfg, runs, microbatches=None):
    """Each kernel's launches in ``runs`` training steps of ``cfg``: a
    forward and a backward per microbatch, and under remat "dots" or
    "full" each remat layer's forward again in the backward -- every layer
    of the dense and SSM families, the Mamba-2 layers of the hybrid (its
    shared attention block is not under remat)."""
    m = cfg.plan.microbatches if microbatches is None else microbatches
    again = 2 if cfg.plan.remat in ("dots", "full") else 1
    ssd = attn = 0
    if cfg.family in ("dense", "moe", "vlm"):
        attn = cfg.num_layers
        attn_fwd = attn * again
    elif cfg.family == "encdec":   # no remat, as in the reference
        attn = attn_fwd = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        ssd = cfg.num_layers
        if cfg.family == "hybrid":
            attn = cfg.num_layers // cfg.hybrid_period
        attn_fwd = attn
    n = runs * m
    return {"flash_attention": n * attn_fwd, "flash_bwd_dq": n * attn,
            "flash_bwd_dkdv": n * attn, "ssd_scan": n * ssd * again,
            "ssd_scan_bwd": n * ssd}


@contextlib.contextmanager
def plain_ops():
    """Within the block the models' kernels are their plain versions
    (``ops.flash_attention``, ``ops.ssd_scan``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    kernels = ops.flash_attention, ops.ssd_scan
    ops.flash_attention = fa.flash_attention_ref
    ops.ssd_scan = (lambda x, dt, A, B, C, *, chunk=256:
                    sk.ssd_scan_ref(x, dt, A, B, C, chunk)[0])
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = kernels


def cut_grads(torch, model, params, batch, plain):
    """loss and gradients of one batch through the kernels or, with
    ``plain``, through their plain versions."""
    from repro_torch.train.step import loss_and_grads
    if not plain:
        return loss_and_grads(model, params, batch)
    with plain_ops():
        return loss_and_grads(model, params, batch)


def plain_step_loss(torch, model, params, batch, microbatches):
    """The train step's loss of ``batch`` through the plain versions, no
    gradient, in the model's compute dtype: ``Model.loss`` of each of the
    ``microbatches`` the step splits it into, averaged as the step
    averages them."""
    total = 0.0
    with plain_ops(), torch.no_grad():
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            total += float(model.loss(params, mb)[0])
    return total / microbatches


def leaf_rels(torch, got, want):
    """{leaf: ||got - want|| / ||want||}."""
    from repro_torch._tree import leaves_with_paths
    wl = dict(leaves_with_paths(want))
    return {"/".join(path): float(
        (g.float() - wl[path].float()).norm()
        / wl[path].float().norm().clamp_min(1e-30))
        for path, g in leaves_with_paths(got)}


class _SavedOnce:
    """An autograd context whose saved tensors were unpacked already (a
    checkpointed node's may be unpacked once): the same context to its
    backward otherwise."""

    def __init__(self, ctx, saved):
        self._ctx, self.saved_tensors = ctx, saved

    def __getattr__(self, name):
        return getattr(self._ctx, name)


@contextlib.contextmanager
def recorded_backwards(calls):
    """Each backward of the model kernels' autograd nodes inside the block
    appended to ``calls``: (kernel, the plain version's arguments, its
    keyword arguments, the kernels' gradients)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    orig = {fa.FlashAttentionFn: fa.FlashAttentionFn.backward,
            sk.SsdScanFn: sk.SsdScanFn.backward}

    def flash(ctx, do):
        q, k, v, out, lse = saved = ctx.saved_tensors
        grads = orig[fa.FlashAttentionFn](_SavedOnce(ctx, saved), do)
        calls.append(("flash_attention_bwd", (q, k, v, out, do, lse),
                      {"causal": ctx.causal, "window": ctx.window},
                      grads[:3]))
        return grads

    def scan(ctx, dy):
        saved = ctx.saved_tensors
        grads = orig[sk.SsdScanFn](_SavedOnce(ctx, saved), dy)
        calls.append(("ssd_scan_bwd", (*saved, dy), {"chunk": ctx.chunk},
                      grads[:5]))
        return grads
    fa.FlashAttentionFn.backward = staticmethod(flash)
    sk.SsdScanFn.backward = staticmethod(scan)
    try:
        yield calls
    finally:
        for fn, backward in orig.items():
            fn.backward = staticmethod(backward)


def backward_call_rels(torch, calls):
    """Each recorded backward call's gradients against its plain version
    on the same inputs (ssd_scan_bwd_ref, flash_attention_bwd_ref),
    norm-relative per gradient."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    out = []
    with torch.no_grad():
        for name, args, kw, got in calls:
            if name == "ssd_scan_bwd":
                names, want = SSD_BWD_NAMES, sk.ssd_scan_bwd_ref(
                    *args, kw["chunk"])[:5]
            else:
                names, want = ("dq", "dk", "dv"), \
                    fa.flash_attention_bwd_ref(*args, **kw)
            out.append({"kernel": name, "shape": list(args[0].shape),
                        "rel": {n: rel_err(torch, g, w)
                                for n, g, w in zip(names, got, want)}})
    return out


def cut_readings(torch, cfg, batch_shape, seed=0):
    """A TRAIN_CUT_LAYERS-layer cut of ``cfg`` at full width (the hybrid's
    with one shared block), its weights and batch drawn from ``seed``:
    the first step's loss and gradients on ``batch_shape`` tokens
    through the kernels and through the plain versions in bf16 (the main
    path) and in f32, and through the plain versions in float64 (the
    yardstick no kernel touches).  Returns the losses, each kernel's
    launches in the bf16 kernels' run, the launches
    :func:`train_launches_expected` gives, per leaf the norm-relative
    distances: kernels from plain in bf16 and in f32, and each of the
    four from the float64 gradient, and how far rounding the weights to
    bf16 alone moves the plain versions' f32 gradient; and each backward
    kernel call of the bf16 kernels' run against its plain version on
    the call's own inputs (backward_call_rels)."""
    import dataclasses
    from repro_torch._tree import tree_map
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import build_model
    over = {"num_layers": TRAIN_CUT_LAYERS}
    if cfg.family == "hybrid":
        over["hybrid_period"] = TRAIN_CUT_LAYERS
    cut = dataclasses.replace(cfg, **over)
    model = build_model(cut, device="cuda")
    params = model.init(seed)
    b, s = batch_shape
    batch = TokenPipeline(b, s, cut.vocab_size, seed=seed,
                          device="cuda").batch_at(0)
    counters = train_launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    with recorded_backwards([]) as calls:
        loss_k, _, kb = cut_grads(torch, model, params, batch, False)
    torch.cuda.synchronize()
    launched = {k: c.launches - before[k] for k, c in counters.items()}
    call_rels = backward_call_rels(torch, calls)
    del calls
    loss_p, _, pb = cut_grads(torch, model, params, batch, True)
    m32 = build_model(cut, compute_dtype=torch.float32, device="cuda")
    m64 = build_model(cut, compute_dtype=torch.float64, device="cuda")
    grads = {"kernels_bf16": kb, "plain_bf16": pb,
             "kernels_f32": cut_grads(torch, m32, params, batch, False)[2],
             "plain_f32": cut_grads(torch, m32, params, batch, True)[2],
             "plain_f64": cut_grads(torch, m64, params, batch, True)[2],
             "plain_f32_bf16_weights": cut_grads(
                 torch, m32, tree_map(lambda p: p.to(torch.bfloat16).float(),
                                      params), batch, True)[2]}
    torch.cuda.synchronize()
    rels = {"bf16": leaf_rels(torch, kb, pb),
            "f32": leaf_rels(torch, grads["kernels_f32"],
                             grads["plain_f32"])}
    for k in ("kernels_bf16", "plain_bf16", "kernels_f32", "plain_f32"):
        rels[f"{k}_from_f64"] = leaf_rels(torch, grads[k],
                                          grads["plain_f64"])
    rels["bf16_weights_move_f32"] = leaf_rels(
        torch, grads["plain_f32_bf16_weights"], grads["plain_f32"])
    leaves = {leaf: {k: r[leaf] for k, r in rels.items()}
              for leaf in rels["bf16"]}
    del grads, kb, pb
    return {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "launches": launched, "backward_calls": call_rels,
            "launches_expected": train_launches_expected(cut, 1,
                                                         microbatches=1),
            "leaves": leaves}


def train_cut_check(torch, cfg, phase, batch_shape, conditioned=False):
    """:func:`cut_readings`, held to: the loss and every leaf's bf16
    gradient within TRAIN_CUT_REL of the plain versions', every leaf's f32
    gradient within TRAIN_CUT_F32_REL, and each kernel launched as
    expected.  With ``conditioned`` (the hybrid, whose bf16 gradient is
    ill-conditioned) a leaf that misses TRAIN_CUT_REL in bf16 passes only
    on two witnesses of its conditioning that involve no kernel -- the
    plain versions' bf16 gradient lies more than TRAIN_CUT_REL from the
    float64 one, and rounding the weights alone to bf16 moves their f32
    gradient more than TRAIN_CUT_REL -- and a third that holds the
    kernels where the leaf's conditioning does not reach: every backward
    kernel call of the bf16 step within TRAIN_CUT_CALL_REL of its plain
    version on the call's own inputs, per gradient."""
    r = cut_readings(torch, cfg, batch_shape)
    leaves = r["leaves"]
    loss_rel = abs(r["loss_kernels"] - r["loss_plain"]) / abs(
        r["loss_plain"])
    calls_worst = max((v for c in r["backward_calls"]
                       for v in c["rel"].values()), default=0.0)
    missed = {leaf: v for leaf, v in leaves.items()
              if not v["bf16"] <= TRAIN_CUT_REL}
    held = {leaf: v for leaf, v in missed.items() if conditioned
            and v["plain_bf16_from_f64"] > TRAIN_CUT_REL
            and v["bf16_weights_move_f32"] > TRAIN_CUT_REL
            and calls_worst <= TRAIN_CUT_CALL_REL}
    bad = [leaf for leaf in missed if leaf not in held]
    bad += [f"{leaf} (f32)" for leaf, v in leaves.items()
            if not v["f32"] <= TRAIN_CUT_F32_REL]
    if bad or not loss_rel <= TRAIN_CUT_REL:
        raise RuntimeError(f"{phase}: the {TRAIN_CUT_LAYERS}-layer cut's "
                           f"kernels miss the plain versions: loss "
                           f"{loss_rel}, leaves {bad} (backward calls' "
                           f"worst {calls_worst}: {r['backward_calls']}): "
                           f"{leaves}")
    if r["launches"] != r["launches_expected"]:
        raise RuntimeError(f"{phase}: the cut launched {r['launches']}, "
                           f"expected {r['launches_expected']}")
    worst = max(leaves, key=lambda k: leaves[k]["bf16"])
    worst_f32 = max(leaves, key=lambda k: leaves[k]["f32"])
    return {"layers": TRAIN_CUT_LAYERS, "batch_x_seq": list(batch_shape),
            "loss_kernels": r["loss_kernels"], "loss_plain": r["loss_plain"],
            "loss_rel_err": loss_rel,
            "grad_rel_err_max": leaves[worst]["bf16"],
            "grad_rel_err_leaf": worst, "tol_rel": TRAIN_CUT_REL,
            "held_by_conditioning": held,
            "backward_calls": r["backward_calls"],
            "backward_calls_worst": calls_worst,
            "backward_calls_tol_rel": TRAIN_CUT_CALL_REL,
            "f32_grad_rel_err_max": leaves[worst_f32]["f32"],
            "f32_grad_rel_err_leaf": worst_f32,
            "f32_worst_leaf_from_f64": {
                k: leaves[worst_f32][k]
                for k in ("kernels_f32_from_f64", "plain_f32_from_f64")},
            "f32_tol_rel": TRAIN_CUT_F32_REL, "launches": r["launches"]}


def family_cut_check(torch, arch, batch_shape):
    """One step's loss and gradient of a TRAIN_CUT_LAYERS-layer cut of
    ``arch`` at full width (the enc-dec family's encoder cut alike) on
    ``batch_shape`` positions through the kernels and through their plain
    versions, in bf16 (held per leaf at TRAIN_CUT_REL, norm-relative) and
    in f32 (TRAIN_CUT_F32_REL); fails on a non-finite loss or a kernel
    launched other than expected.  The MoE cut runs without remat and its
    plain run takes the kernels' run's picks (a discrete pick is pinned
    through its inputs): the slots whose own pick differed are printed."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import build_model
    cfg = get_cfg(arch)
    over = {"num_layers": TRAIN_CUT_LAYERS}
    if cfg.family == "encdec":
        over["encoder_layers"] = TRAIN_CUT_LAYERS
    if cfg.is_moe:
        over["plan"] = dataclasses.replace(cfg.plan, remat="none")
    cut = dataclasses.replace(cfg, **over)
    b, s = batch_shape
    front = cut.frontend_tokens if cut.family == "vlm" else 0
    batch = TokenPipeline(
        b, s - front, cut.vocab_size, frontend_tokens=front,
        d_model=cut.d_model if front or cut.family == "encdec" else 0,
        encoder_seq=cut.encoder_seq if cut.family == "encdec" else 0,
        device="cuda").batch_at(0)
    params = build_model(cut, device="cuda").init(0)
    counters = train_launch_counters()
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = build_model(cut, compute_dtype=dtype, device="cuda")
        before = {k: c.launches for k, c in counters.items()}
        (loss_k, _, gk), picks, dropped, _ = moe_routing(
            torch, lambda: cut_grads(torch, model, params, batch, False))
        torch.cuda.synchronize()
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        (loss_p, _, gp), _, _, differ = moe_routing(
            torch, lambda: cut_grads(torch, model, params, batch, True),
            pinned=picks if cut.is_moe else None)
        rels = leaf_rels(torch, gk, gp)
        worst = max(rels, key=rels.get)
        tol = TRAIN_CUT_REL if name == "bf16" else TRAIN_CUT_F32_REL
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        want = train_launches_expected(cut, 1, microbatches=1)
        if not (np.isfinite(float(loss_k)) and np.isfinite(float(loss_p))):
            raise RuntimeError(f"train_cuts: {arch} {name}: a non-finite "
                               f"loss {float(loss_k)}, {float(loss_p)}")
        bad = {k: v for k, v in rels.items() if not v <= tol}
        if bad or not loss_rel <= tol:
            raise RuntimeError(f"train_cuts: {arch} {name}: the kernels "
                               f"miss the plain versions: loss {loss_rel}, "
                               f"leaves {bad}")
        if launched != want:
            raise RuntimeError(f"train_cuts: {arch} {name}: launched "
                               f"{launched}, expected {want}")
        out[name] = {"loss_kernels": float(loss_k),
                     "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
                     "grad_rel_err_max": rels[worst],
                     "grad_rel_err_leaf": worst, "tol_rel": tol,
                     "launches": launched}
        if cut.is_moe:
            out[name]["slots_routed_differently"] = differ
            out[name]["dropped_slots_per_layer"] = [int(d.sum())
                                                    for d in dropped]
        del gk, gp
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": TRAIN_CUT_LAYERS,
            "encoder_layers": cut.encoder_layers or None,
            "batch_x_positions": list(batch_shape),
            "batch": {k: list(v.shape) for k, v in batch.items()},
            "remat": "none" if cut.family == "encdec" else cut.plan.remat,
            **out}


def phase_train_cuts(torch):
    """:func:`family_cut_check` for the MoE, VLM and enc-dec families:
    olmoe-1b-7b, phi-3-vision-4.2b (its attention backward at head dim 96)
    and whisper-medium (the non-causal backward at Sk = 1500)."""
    t_phase = time.perf_counter()
    cuts = [family_cut_check(torch, arch, shape)
            for arch, shape in TRAIN_CUTS]
    emit({"phase": "train_cuts", "cuts": cuts,
          "reduced": {"layers": TRAIN_CUT_LAYERS,
                      "why": "one step's gradient at full width, checked "
                             "against the plain versions in bf16, f32"},
          "seconds": time.perf_counter() - t_phase})


def run_trainer(torch, phase, cfg, batch_shape, steps, trigger_after, port,
                duty_quantum_steps=10, step0=False):
    """The Trainer at full width and depth (bf16 compute over f32
    parameters, the config's remat and microbatches, random weights from
    seed 0, AdamW state on the card) for ``steps`` steps of ``batch_shape``
    tokens with a port GridPilot attached and an FFR trigger fired after
    step ``trigger_after`` (the shed runs the first duty x
    ``duty_quantum_steps`` steps of each quantum); fails unless every loss
    is finite, steps were shed with an ffr_shed event and each kernel
    launched as
    :func:`train_launches_expected` says.  Then one more step under the
    profiler.  With ``step0``, before training the step's loss of the
    trainer's first batch on the initial weights through the plain
    versions (:func:`plain_step_loss`), which the trainer's step-0 loss
    must meet within STEP0_LOSS_TOL.  Returns the run's numbers and
    launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.controller import GridPilot
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.grid.signals import make_grid
    from repro_torch.train.trainer import Trainer, TrainerConfig
    b, s = batch_shape
    shape = ShapeConfig(f"smoke_{phase}", s, b, "train")
    gp = GridPilot(n_hosts=1, chips_per_host=1, island_port=port,
                   device="cuda")
    try:
        grid = make_grid("DE", 24)
        plan = gp.hourly_plan(grid.ci, grid.t_amb)
        trainer = Trainer(cfg, shape, tcfg=TrainerConfig(
            steps=steps, log_every=0, duty_quantum_steps=duty_quantum_steps),
            gridpilot=gp, device="cuda")
        params, opt = trainer.init_state()
        torch.cuda.synchronize()
        plain0 = None
        if step0:
            plain0 = plain_step_loss(torch, trainer.bundle.model, params,
                                     trainer._pipeline().batch_at(0),
                                     cfg.plan.microbatches)
            torch.cuda.empty_cache()

        def on_step(step, metrics):
            if step == trigger_after:
                gp.fire_test_trigger()
                time.sleep(0.05)  # the UDP trigger reaches the island

        counters = train_launch_counters()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = trainer.train(params, opt, on_step=on_step)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params, opt = out["params"], out["opt"]
        hist, skipped = out["history"], out["skipped"]
        losses = [h["loss"] for h in hist]
        runs = len(hist)
        want = train_launches_expected(cfg, runs)
        shed = any(e["event"] == "ffr_shed" for e in out["events"])
        if not all(np.isfinite(losses)) or not skipped > 0 or \
                not shed or launches != want:
            raise RuntimeError(
                f"{phase}: losses {losses}, skipped {skipped}, "
                f"ffr_shed {shed}, launches {launches} (expected {want})")
        gate0 = None
        if step0:
            got0 = hist[0]["loss"]
            gate0 = {"step": hist[0]["step"], "trainer": got0,
                     "plain": plain0, "abs_err": abs(got0 - plain0),
                     "tol": STEP0_LOSS_TOL}
            if hist[0]["step"] != 0 or not np.isclose(got0, plain0,
                                                      **STEP0_LOSS_TOL):
                raise RuntimeError(f"{phase}: the step-0 loss misses the "
                                   f"plain versions': {gate0}")
        # where a step's time goes: one more step under the profiler
        batch = trainer._pipeline().batch_at(steps)
        step_fn = trainer.bundle.step_fn
        t1 = time.perf_counter()
        step_fn(params, opt, batch, steps)
        torch.cuda.synchronize()
        step_wall_ms = (time.perf_counter() - t1) * 1e3
        groups = {**fa.BWD_KERNELS[torch.bfloat16],
                  "ssd_scan_bwd": sk.BWD_KERNELS[torch.bfloat16]}
        # the step just timed warms the profiled one
        prof = profile_calls(
            torch, lambda i=0: step_fn(params, opt, batch, steps + 1), 1,
            match=("flash_fwd", "ssd_scan"), groups=groups, warm=False)
    finally:
        gp.close()
    del params, opt, out, trainer
    torch.cuda.empty_cache()
    dts = [h["dt"] for h in hist]
    ms = statistics.median(dts[1:]) * 1e3
    return {"arch": cfg.name, "params": cfg.param_count(), "batch": b,
            "seq": s, "steps": steps, "run_steps": runs, "skipped": skipped,
            "microbatches": cfg.plan.microbatches,
            "duty_quantum_steps": duty_quantum_steps,
            "compute_dtype": "bfloat16", "param_dtype": "float32",
            "remat": cfg.plan.remat,
            "plan": {"mu": plan.mu, "rho": plan.rho},
            "losses": losses, "ms_per_step": ms, "step0_loss": gate0,
            "loss_by_step": {h["step"]: h["loss"] for h in hist},
            "step_ms": [d * 1e3 for d in dts], "wall_s": wall_s,
            "tokens_per_s": b * s / (ms * 1e-3), "peak_gb": peak_gb,
            "launches": launches, "launches_expected": want,
            "launches_per_step": {k: v / runs for k, v in launches.items()},
            "profiled_step_wall_ms": step_wall_ms,
            "device_ms_per_step": prof["device_us_per_call"] / 1e3,
            "busy_share": prof["device_us_per_call"] / 1e3 / step_wall_ms,
            "kernel_device_ms": {k: v / 1e3 for k, v in
                                 {**prof["matched_us_per_call"],
                                  **prof["group_us_per_call"]}.items()},
            "bwd_kernels": prof["group_kernels"],
            "launches_per_profiled_step": prof["launches_per_call"],
            "top_kernels_us": prof["kernels"]}


def ckpt_restart_check(torch):
    """smollm-135m at full width: 4 steps with a checkpoint directory, a
    new trainer that restores and runs to 6, against an unbroken run to 6
    (its losses at steps 4-5, the 5th and 6th steps, within 1e-5)."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_cfg(CKPT_ARCH)
    shape = ShapeConfig("smoke_ckpt", CKPT_SHAPE[1], CKPT_SHAPE[0], "train")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    try:
        def run(steps, ckpt_dir):
            t = Trainer(cfg, shape, tcfg=TrainerConfig(
                steps=steps, ckpt_dir=ckpt_dir, log_every=0), device="cuda")
            return t, t.train()
        run(CKPT_STEPS, root)
        t2, out2 = run(CKPT_RESTART_STEPS, root)
        _, full = run(CKPT_RESTART_STEPS, None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    restarted = [h["loss"] for h in out2["history"]]
    unbroken = [h["loss"] for h in full["history"][CKPT_STEPS:]]
    restored = any(e["event"] == "restored" for e in t2.events)
    steps = [h["step"] for h in out2["history"]]
    ok = restored and steps == list(range(CKPT_STEPS, CKPT_RESTART_STEPS)) \
        and np.allclose(restarted, unbroken, rtol=CKPT_LOSS_RTOL, atol=0)
    if not ok:
        raise RuntimeError(f"train: the restart did not continue the run: "
                           f"restored {restored}, steps {steps}, losses "
                           f"{restarted} against {unbroken}")
    return {"arch": CKPT_ARCH, "batch": CKPT_SHAPE[0], "seq": CKPT_SHAPE[1],
            "steps": [CKPT_STEPS, CKPT_RESTART_STEPS],
            "restarted_losses": restarted, "unbroken_losses": unbroken,
            "rtol": CKPT_LOSS_RTOL, "restored_event": restored,
            "seconds": time.perf_counter() - t0}


def phase_train(torch):
    """:func:`run_trainer` at full qwen2-1.5b width and depth for
    TRAIN_STEPS steps of TRAIN_SHAPE tokens (the attention forward 56
    times a step under remat "dots", each backward kernel 28); then the
    2-layer kernels-vs-plain check and the smollm-135m restart check.
    Returns the trainer's run (each kernel's launches under
    ``launches``)."""
    from repro_torch.core.plant import train_step_cost
    t_phase = time.perf_counter()
    cfg = get_cfg("qwen2-1.5b")
    b, s = TRAIN_SHAPE
    res = run_trainer(torch, "train", cfg, TRAIN_SHAPE, TRAIN_STEPS,
                      TRAIN_TRIGGER_AFTER, TRAIN_ISLAND_PORT)
    flops, _ = train_step_cost(cfg, b, s)
    ms = res["ms_per_step"]
    cut = train_cut_check(torch, cfg, "train", TRAIN_SHAPE)
    torch.cuda.empty_cache()
    restart = ckpt_restart_check(torch)
    emit({"phase": "train", **res,
          "cut": {"batch_x_seq": [b, s], "reference_train_4k": [256, 4096],
                  "why": "one card; the reference's train_4k is 256 x "
                         "4096 on a pod"},
          "model_tflop_per_step": flops / 1e12,
          "model_tflop_s": flops / (ms * 1e-3) / 1e12,
          "mfu_vs_989": flops / (ms * 1e-3) / TENSOR_CORE_BF16_FLOP_S,
          "cut_check": cut, "restart_check": restart,
          "seconds": time.perf_counter() - t_phase})
    return res


def phase_train_families(torch):
    """:func:`run_trainer` for the MoE, VLM and enc-dec families
    (TRAIN_FAMILIES: whisper-medium and phi-3-vision-4.2b at full depth,
    olmoe-1b-7b at 8 of 16 layers) under their configs' plan (phi-3-vision
    and olmoe 4 microbatches and remat "dots"; whisper 1, its attention
    not under remat) for TRAIN_FAMILY_STEPS steps, an FFR trigger after
    step 1 that sheds step 2, each with the step-0 gate; one line each.
    Returns each phase's launches."""
    import dataclasses
    launches = {}
    for phase, arch, shape, layers in TRAIN_FAMILIES:
        t_phase = time.perf_counter()
        full = get_cfg(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        res = run_trainer(torch, phase, cfg, shape, TRAIN_FAMILY_STEPS,
                          TRAIN_SSM_TRIGGER_AFTER, TRAIN_FAMILY_PORTS[phase],
                          TRAIN_FAMILY_DUTY_QUANTUM, step0=True)
        reduced = {"batch_x_seq": [list(shape), [256, 4096]],
                   "why": "one card; the reference's train_4k is 256 x "
                          "4096 on a pod",
                   "steps": [TRAIN_SSM_STEPS, TRAIN_FAMILY_STEPS],
                   "why_steps": "the smoke's run time"}
        if layers is not None:
            reduced.update(
                num_layers=[full.num_layers, layers],
                state_gb_f32={n: 16 * dataclasses.replace(
                    full, num_layers=n).param_count() / 1e9
                    for n in (full.num_layers, layers)},
                why_layers="parameters, AdamW moments and one gradient "
                           "tree in f32 (16 B a parameter): the full depth "
                           "does not fit one 80 GB card")
        emit({"phase": phase, **res, "reduced": reduced,
              "seconds": time.perf_counter() - t_phase})
        launches[phase] = res["launches"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches


# --- train_dp: the int8-compressed data-parallel step at full width ----------

TRAIN_DP_STEPS = 4
TRAIN_DP_CUT_SHAPE = (1, 128)      # the 2-layer cut's tokens, card and CPU
TRAIN_DP_CUT_STEPS = (100, 101)    # past warm-up: AdamW moves every weight
TRAIN_DP_CUT_REL = 1e-4            # f32, per leaf, plus one quantum
TRAIN_DP_CUT_FLIPS = 1e-3          # share of elements that may need it


def count_all_reduces(torch):
    """Wrap ``torch.distributed.all_reduce`` to record each call's dtype
    and element count; returns (records, undo)."""
    import torch.distributed as dist
    calls, orig = [], dist.all_reduce

    def counting(t, *a, **kw):
        calls.append((t.dtype, t.numel()))
        return orig(t, *a, **kw)

    dist.all_reduce = counting
    return calls, lambda: setattr(dist, "all_reduce", orig)


def train_dp_cut(torch, cfg, rules):
    """A 2-layer cut of ``cfg`` at full width through the compressed step
    (on the world of one that ``rules`` names) in f32, on the card (the
    kernels, NCCL) and on the CPU (the plain versions, a gloo group of
    the same rank), from the same weights and tokens, for two steps past
    warm-up.  The loss and the all-reduced gradient's norm at
    TRAIN_DP_CUT_REL.  A payload element one quantum off between the two
    devices moves its residual by one shared scale (the residual's
    quantum: the leaf's largest scale over the steps and devices) and
    its weight by up to twice the steps' learning rates (the weight's
    quantum: an AdamW step moves a weight by about lr whatever its
    gradient's size).  So every element must lie within its quantum plus
    TRAIN_DP_CUT_REL of its leaf's largest value (for the residual, of
    the compensated gradient it came from), and at most
    TRAIN_DP_CUT_FLIPS of the residual's elements more than half a scale
    away (a flipped payload element: float noise moves a residual far
    less, a wrong gradient flips most)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch._tree import leaves_with_paths, tree_map
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import step as st
    cut = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS)
    gloo = dist.new_group(backend="gloo")
    runs = {}
    params0 = None
    b, s = TRAIN_DP_CUT_SHAPE
    tokens = TokenPipeline(b, s, cut.vocab_size, device="cpu").batch_at(0)
    scales, requantize_sum = [], st.requantize_sum

    def recording(q, s_local, group=None):
        scales.append(float(s_local))     # a world of one: the shared one
        return requantize_sum(q, s_local, group)

    st.requantize_sum = recording
    try:
        for dev, group in (("cuda", None), ("cpu", gloo)):
            model = build_model(cut, compute_dtype=torch.float32, device=dev)
            step = st.make_compressed_train_step(model, rules, group=group)
            if params0 is None:
                params0 = tree_map(lambda p: p.cpu(), model.init(0))
            params = tree_map(lambda p: p.to(dev).clone(), params0)
            opt = adamw_init(params)
            res = st.init_residual(model, rules)
            batch = {k: v.to(dev) for k, v in tokens.items()}
            metrics, lrs = [], []
            for i in TRAIN_DP_CUT_STEPS:
                params, opt, res, m = step(params, opt, res, batch, i)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                lrs.append(float(m["lr"]))
            runs[dev] = (metrics, dict(leaves_with_paths(params)),
                         dict(leaves_with_paths(res)))
            del model, params, opt, res
    finally:
        st.requantize_sum = requantize_sum
        dist.destroy_process_group(gloo)
    n_leaves = len(runs["cpu"][2])
    leaf_scale = np.asarray(scales).reshape(-1, n_leaves).max(axis=0)
    (mg, pg, rg), (mw, pw, rw) = runs["cuda"], runs["cpu"]
    for (lg, ng), (lw, nw) in zip(mg, mw):
        if abs(lg - lw) > TRAIN_DP_CUT_REL * abs(lw) or \
                abs(ng - nw) > TRAIN_DP_CUT_REL * abs(nw):
            raise RuntimeError(f"train_dp: the cut's loss / grad norm "
                               f"{mg} against the CPU's {mw}")
    flips = total = 0
    worst = {"res": 0.0, "params": 0.0}
    for path, scale in zip(rw, leaf_scale):
        quanta = {"res": float(scale), "params": 2 * sum(lrs)}
        for name, g, w in (("res", rg[path], rw[path]),
                           ("params", pg[path], pw[path])):
            err = (g.cpu().double() - w.double()).abs()
            # 1e-4 of the leaf's largest value: for the residual, of the
            # gradient plus residual it was taken from (127 scales)
            slack = TRAIN_DP_CUT_REL * (127 * quanta[name] if name == "res"
                                        else float(w.abs().max()))
            if float(err.max()) > quanta[name] + slack:
                raise RuntimeError(f"train_dp: the cut's {name} "
                                   f"{'/'.join(path)} off by "
                                   f"{float(err.max())}, quantum "
                                   f"{quanta[name]}")
            worst[name] = max(worst[name], float(err.max()) / quanta[name])
            if name == "res":
                flips += int((err > quanta[name] / 2).sum())
                total += err.numel()
    if flips > TRAIN_DP_CUT_FLIPS * total:
        raise RuntimeError(f"train_dp: {flips} of the cut's {total} "
                           f"payload elements were a quantum off")
    return {"layers": TRAIN_CUT_LAYERS, "batch_x_seq": list(
                TRAIN_DP_CUT_SHAPE), "steps": list(TRAIN_DP_CUT_STEPS),
            "loss_grad_norm_card": mg, "loss_grad_norm_cpu": mw,
            "payload_elements_a_quantum_off": flips,
            "payload_elements": total,
            "max_err_in_quanta": worst, "lr": lrs,
            "tol_rel": TRAIN_DP_CUT_REL, "tol_flips": TRAIN_DP_CUT_FLIPS}


def phase_train_dp(torch, train):
    """The int8-compressed data-parallel step (make_compressed_train_step
    through build_step_bundle(mesh=make_local_mesh(), compressed=True)) at
    full qwen2-1.5b width and depth on a world of one on NCCL: bf16
    compute over f32 parameters, remat "dots", TRAIN_DP_STEPS steps of
    TRAIN_SHAPE tokens.  Fails unless every loss is finite, each step
    launched the attention forward 56 times and each backward kernel 28,
    and each step issued 2 all-reduces a parameter leaf (the scale's MAX,
    the int32 counts' SUM) and 4 means (loss, ce, zloss, aux); then the
    2-layer cut against the CPU.  ``train`` is the train phase's record,
    printed beside this one's."""
    import torch.distributed as dist
    from repro_torch._tree import leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train import step as st
    t_phase = time.perf_counter()
    cfg = get_cfg("qwen2-1.5b")
    b, s = TRAIN_SHAPE
    mesh = make_local_mesh("cuda")
    backend = dist.get_backend()
    try:
        bundle = st.build_step_bundle(
            cfg, ShapeConfig("smoke_train_dp", s, b, "train"),
            device="cuda", mesh=mesh, compressed=True)
        # the moments ZeRO-1 DTensors, as the reference's compressed
        # bundle places them (whole on a world of one)
        params, opt = bundle.init_state(0)
        res = st.init_residual(bundle.model, bundle.rules)
        n_leaves = len(leaves(params))
        pipe = TokenPipeline(b, s, cfg.vocab_size, device="cuda")
        torch.cuda.synchronize()
        counters = train_launch_counters()
        for c in counters.values():
            c.launches = 0
        calls, undo = count_all_reduces(torch)
        torch.cuda.reset_peak_memory_stats()
        losses, dts = [], []
        try:
            for i in range(TRAIN_DP_STEPS):
                t0 = time.perf_counter()
                params, opt, res, m = bundle.step_fn(
                    params, opt, res, pipe.batch_at(i), i)
                losses.append(float(m["loss"]))   # waits for the step
                dts.append(time.perf_counter() - t0)
        finally:
            undo()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {k: c.launches for k, c in counters.items()}
        want = train_launches_expected(cfg, TRAIN_DP_STEPS)
        per_step = 2 * n_leaves + 4
        bytes_step = sum(dt.itemsize * n for dt, n in calls) / TRAIN_DP_STEPS
        int32_bytes = sum(dt.itemsize * n for dt, n in calls
                          if dt == torch.int32) / TRAIN_DP_STEPS
        if not all(np.isfinite(losses)) or launches != want or \
                len(calls) != per_step * TRAIN_DP_STEPS:
            raise RuntimeError(
                f"train_dp: losses {losses}, launches {launches} (expected "
                f"{want}), {len(calls)} all-reduces (expected "
                f"{per_step * TRAIN_DP_STEPS})")
        batch = pipe.batch_at(TRAIN_DP_STEPS)
        t1 = time.perf_counter()
        bundle.step_fn(params, opt, res, batch, TRAIN_DP_STEPS)
        torch.cuda.synchronize()
        step_wall_ms = (time.perf_counter() - t1) * 1e3
        prof = profile_calls(
            torch, lambda i=0: bundle.step_fn(params, opt, res, batch,
                                              TRAIN_DP_STEPS + 1), 1)
        del params, opt, res, bundle
        torch.cuda.empty_cache()
        cut = train_dp_cut(torch, cfg, MeshRules(cfg.plan, mesh))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    ms = statistics.median(dts[1:]) * 1e3
    emit({"phase": "train_dp", "arch": cfg.name, "params": cfg.param_count(),
          "backend": backend, "world": 1, "batch": b, "seq": s,
          "steps": TRAIN_DP_STEPS, "compute_dtype": "bfloat16",
          "param_dtype": "float32", "remat": cfg.plan.remat,
          "losses": losses, "ms_per_step": ms,
          "step_ms": [d * 1e3 for d in dts],
          "tokens_per_s": b * s / (ms * 1e-3), "peak_gb": peak_gb,
          "train_phase": {"ms_per_step": train["ms_per_step"],
                          "tokens_per_s": train["tokens_per_s"],
                          "peak_gb": train["peak_gb"]},
          "launches": launches, "launches_expected": want,
          "launches_per_step": {k: v / TRAIN_DP_STEPS
                                for k, v in launches.items()},
          "parameter_leaves": n_leaves,
          "all_reduces_per_step": len(calls) / TRAIN_DP_STEPS,
          "all_reduces_expected": per_step,
          "all_reduce_bytes_per_step": bytes_step,
          "all_reduce_int32_bytes_per_step": int32_bytes,
          "profiled_step_wall_ms": step_wall_ms,
          "device_ms_per_step": prof["device_us_per_call"] / 1e3,
          "busy_share": prof["device_us_per_call"] / 1e3 / step_wall_ms,
          "launches_per_profiled_step": prof["launches_per_call"],
          "top_kernels_us": prof["kernels"], "cut_check": cut,
          "seconds": time.perf_counter() - t_phase})
    return launches


def phase_train_ssm(torch, phase, arch):
    """:func:`run_trainer` at full width and depth of an SSM or hybrid
    config (mamba2-1.3b, zamba2-2.7b: remat "dots", 4 microbatches of one
    2048-token sequence) for TRAIN_SSM_STEPS steps of TRAIN_SSM_SHAPE
    tokens, every scan's gradient through ssd_scan_bwd (and the hybrid's
    shared attention through the attention backward); then the 2-layer
    kernels-vs-plain check on one microbatch.  Returns the trainer's
    record (each kernel's launches under "launches")."""
    t_phase = time.perf_counter()
    cfg = get_cfg(arch)
    b, s = TRAIN_SSM_SHAPE
    res = run_trainer(torch, phase, cfg, TRAIN_SSM_SHAPE, TRAIN_SSM_STEPS,
                      TRAIN_SSM_TRIGGER_AFTER, TRAIN_SSM_PORTS[phase],
                      TRAIN_SSM_DUTY_QUANTUM)
    cut = train_cut_check(torch, cfg, phase,
                          (b // cfg.plan.microbatches, s),
                          conditioned=cfg.family == "hybrid")
    torch.cuda.empty_cache()
    emit({"phase": phase, **res,
          "cut": {"batch_x_seq": [b, s], "reference_train_4k": [256, 4096],
                  "why": "one card; the reference's train_4k is 256 x "
                         "4096 on a pod"},
          "cut_check": cut, "seconds": time.perf_counter() - t_phase})
    return res


E8_REPS = 20                 # timed sweeps of the full batch
E8_PP_ATOL = 1e-3            # CPU against card, pp metrics
E8_RTOL = 1e-3               # CPU against card, replay totals and CFE
E8_TIE_REL = 1e-5            # a pick may differ only on such a near-tie


def e8_compare(torch, ex, cpu, gpu, batch_gpu, noise_gpu):
    """The card's E8 metrics against the CPU's on the same batch: totals
    and CFE at rtol 1e-3, pp metrics at 1e-3 pp, shed-depth picks equal
    unless the CPU's two candidates tie within 1e-5 (then the card's run
    is repeated with the CPU's picks, as the tests pin them)."""
    n_lo = len(ex.LO_LEVELS)
    cols = {"shed_depth_blind": ("co2_it_candidates", 0),
            "shed_depth_aware": ("co2_candidates", n_lo)}
    los = torch.tensor(ex.LO_LEVELS)
    picks, flipped = [], 0
    for key, (tot, off) in cols.items():
        pc = torch.bucketize(cpu[key], los)
        pg = torch.bucketize(gpu[key].cpu(), los)
        t = cpu[tot][:, off:off + n_lo]
        rows = torch.arange(len(pc))
        diff = pc != pg
        a, b = t[rows, pg][diff], t[rows, pc][diff]
        if not bool(((a - b).abs() <= E8_TIE_REL * b.abs()).all()):
            raise RuntimeError(f"e8: the card's {key} differs from the "
                               f"CPU's beyond a near-tie")
        flipped += int(diff.sum())
        picks.append(pc.cuda())
    pinned = ex.e8_metrics(batch_gpu, noise_gpu, picks=tuple(picks))
    worst = {}
    for k in (*ex.METRIC_KEYS, "co2_candidates", "co2_it_candidates"):
        got, want = pinned[k].cpu().double(), cpu[k].double()
        err = float((got - want).abs().max())
        if k.endswith("_pp"):
            ok = err <= E8_PP_ATOL
        elif k.startswith("shed_depth"):
            ok = err == 0.0
        else:
            ok = bool(((got - want).abs() <= E8_RTOL * want.abs()).all())
        if not ok:
            raise RuntimeError(f"e8: CPU against card, {k} off by {err}")
        worst[k] = err
    return {"max_abs_err": worst, "picks_pinned_on_near_ties": flipped}


def phase_e8(torch):
    """E8 (benchmarks/e8_multicountry.py, paper Fig. 5, with E9's PUE
    design axis): the full 144-scenario x 672 h batch built on the card and
    swept in one batched call: the median time of E8_REPS sweeps,
    scenarios per second, one sweep's device time and launches, the
    headline rows beside the paper's 2.5-5.8 pp (printed, not enforced, as
    the reference enforces nothing); then the fast batch (26 scenarios) on
    the CPU and on the card."""
    import repro_torch.experiments as ex
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    batch, groups = ex.build_e8_batch(False, device="cuda")
    noise = ex.e8_noise(batch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    metrics = ex.e8_metrics(batch, noise)
    torch.cuda.synchronize()
    times = []
    for _ in range(E8_REPS):
        t0 = time.perf_counter()
        metrics = ex.e8_metrics(batch, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_calls(torch, lambda i=0: ex.e8_metrics(batch, noise), 3)
    if not all_finite(torch, metrics):
        raise RuntimeError("e8: the sweep's metrics are not finite")
    rows = ex.e8_group_rows(metrics, groups)
    head = ex.e8_summary(rows)
    fast_cpu, _ = ex.build_e8_batch(True, device="cpu")
    fast_gpu, _ = ex.build_e8_batch(True, device="cuda")
    cpu = ex.e8_metrics(fast_cpu, ex.e8_noise(fast_cpu))
    gpu_noise = ex.e8_noise(fast_gpu)
    gpu = ex.e8_metrics(fast_gpu, gpu_noise)
    check = e8_compare(torch, ex, cpu, gpu, fast_gpu, gpu_noise)
    ms = statistics.median(times)
    emit({"phase": "e8", "scenarios": batch.n, "hours": batch.h_max,
          "groups": len(groups), "build_s": build_s,
          "ms_per_sweep": ms, "sweeps_ms": times,
          "scenarios_per_s": batch.n / (ms * 1e-3),
          "device_ms_per_sweep": prof["device_us_per_call"] / 1e3,
          "launches_per_sweep": prof["launches_per_call"],
          "busy_share": prof["device_us_per_call"] / 1e3 / ms,
          "headline": head, "rows": rows,
          "paper_envelope_pp": list(ex.E8_PAPER_PP),
          "enforced": "no: the reference bench prints its headline",
          "cpu_vs_gpu_fast": {"scenarios": fast_cpu.n, **check,
                              "tol": {"pp_atol": E8_PP_ATOL,
                                      "rtol": E8_RTOL,
                                      "tie_rel": E8_TIE_REL}},
          "seconds": time.perf_counter() - t_phase})


def phase_families(torch, flash_rec, free, long):
    """The MoE, VLM and enc-dec families at full width: prefill_moe
    (olmoe-1b-7b, then mixtral-8x22b cut to MIXTRAL_CUT_LAYERS layers on
    MIXTRAL_PREFILL_SHAPE tokens), decode_vs_forward_moe and serve on
    olmoe, prefill_vlm (phi-3-vision-4.2b: 576 image embeddings and 3,520
    tokens), prefill_encdec (whisper-medium, (2, 448) tokens and (2, 1500,
    1024) frames), decode_vs_forward_encdec and serve on whisper; each
    forward's flash_attention launches enforced and added to
    ``flash_rec``; on the mixtral cut's weights long_500k's decode steps
    (long_decode), after which the long_500k line is printed; on each
    arch's weights (smollm-135m's its own) its prefill_32k part, after
    which the prefill_32k line is printed."""
    import dataclasses
    from repro_torch.models import build_model
    olmoe = get_cfg("olmoe-1b-7b")
    rec, params = phase_prefill(torch, "prefill_moe", olmoe,
                                {"flash_attention": olmoe.num_layers})
    flash_rec["launches_olmoe"] = rec["launches"]["flash_attention"]
    phase_decode_vs_forward_moe(torch, olmoe, params)
    long["prefill_32k"].append(prefill_32k_run(
        torch, olmoe, params, {"flash_attention": olmoe.num_layers}))
    del params
    free()
    phase_serve(torch, "olmoe-1b-7b")
    free()
    full = get_cfg("mixtral-8x22b")
    mixtral = dataclasses.replace(full, num_layers=MIXTRAL_CUT_LAYERS)
    rec, params = phase_prefill(
        torch, "prefill_moe", mixtral, {"flash_attention": MIXTRAL_CUT_LAYERS},
        shape=MIXTRAL_PREFILL_SHAPE,
        extra={"reduced": {"num_layers": [full.num_layers,
                                          MIXTRAL_CUT_LAYERS],
                           "params_full": full.param_count(),
                           "why": "full width on one 80 GB card: 2 layers "
                                  "are 21.6 GB of f32 weights, 56 would be "
                                  "563 GB"}})
    flash_rec["launches_mixtral_cut"] = rec["launches"]["flash_attention"]
    cut = {"num_layers": [full.num_layers, MIXTRAL_CUT_LAYERS],
           "why": "as prefill_moe's cut: 2 of 56 layers are 21.6 GB of "
                  "f32 weights"}
    long["long_500k"].append({
        "arch": full.name, "decode": long_decode(torch, mixtral, params),
        "reduced": cut})
    long["prefill_32k"].append(prefill_32k_run(
        torch, mixtral, params, {"flash_attention": MIXTRAL_CUT_LAYERS},
        reduced=cut))
    del params
    free()
    emit({"phase": "long_500k", "runs": long["long_500k"]})
    phi3 = get_cfg("phi-3-vision-4.2b")
    rec, params = phase_prefill(torch, "prefill_vlm", phi3,
                                {"flash_attention": phi3.num_layers})
    flash_rec["launches_phi3"] = rec["launches"]["flash_attention"]
    long["prefill_32k"].append(prefill_32k_run(
        torch, phi3, params, {"flash_attention": phi3.num_layers}))
    del params
    free()
    whisper = get_cfg("whisper-medium")
    encdec = {"flash_attention": whisper.encoder_layers
              + 2 * whisper.num_layers}
    rec, params = phase_prefill(torch, "prefill_encdec", whisper, encdec,
                                shape=WHISPER_PREFILL_SHAPE)
    flash_rec["launches_whisper"] = rec["launches"]["flash_attention"]
    phase_decode_vs_forward_encdec(torch, whisper, params)
    long["prefill_32k"].append(prefill_32k_run(torch, whisper, params,
                                               encdec))
    del params
    free()
    phase_serve(torch, "whisper-medium")
    free()
    smollm = get_cfg("smollm-135m")
    params = build_model(smollm, device="cuda").init(0)
    long["prefill_32k"].append(prefill_32k_run(
        torch, smollm, params, {"flash_attention": smollm.num_layers}))
    del params
    free()
    emit({"phase": "prefill_32k", "runs": long["prefill_32k"]})


# ---------------------------------------------------------------------------
# The registered long shapes (src/repro/configs/base.py SHAPES): prefill_32k,
# decode_32k and long_500k on one card, and the kernels at their calls
# ---------------------------------------------------------------------------

PREFILL_32K_SEQ = 32_768
PREFILL_32K_GLOBAL = 32          # prefill_32k's registered global batch
# the rows each arch runs of it on one card
PREFILL_32K_ROWS = {"qwen2-1.5b": 2, "mamba2-1.3b": 2, "zamba2-2.7b": 1,
                    "yi-9b": 1, "phi-3-vision-4.2b": 1, "olmoe-1b-7b": 1,
                    "mixtral-8x22b": 1, "whisper-medium": 1,
                    "smollm-135m": 2}
LONG_SEQ = 524_288               # long_500k: one row, sub_quadratic archs
LONG_CUR = 524_280               # the decode steps' first position
# past a 4,096-slot ring's wrap: slot 4,088 at 524,280, slot 0 at 524,288
LONG_DECODE_STEPS = 12
DECODE_32K_SEQ = 32_768
DECODE_32K_GLOBAL = 128          # decode_32k's registered global batch
DECODE_32K_ROWS = {"qwen2-1.5b": 32, "yi-9b": 8}
DECODE_32K_STEPS = 4             # timed steps after a first one
# bf16 decode logits against an f32 step on the same cache values and token
# (an MoE's f32 step on the bf16 step's expert picks), norm-relative: a
# fixed limit per arch, held by every deep step and by the same weights'
# step on the FLOOR_ROWS rows of a shallow FLOOR_SEQ-position cache (no
# deep position in it), so a fault at every depth fails too.  At full
# depth with random weights bf16 compute alone moves the logits 2-8 % at
# any cache depth (qwen2-1.5b 3.9-4.9 % on the CPU, 64 to 1,024
# positions), past the 2e-2 of the SSM families' forward (SSM_BF16_REL).
# Each limit is 1.25x the largest shallow reading of this script's earlier
# runs on an H100, rounded up (PERF.md, section 6, lists the readings)
LONG_BF16_LIMIT = {"mamba2-1.3b": 0.051, "zamba2-2.7b": 0.076,
                   "mixtral-8x22b": 0.033, "qwen2-1.5b": 0.064,
                   "yi-9b": 0.098}
FLOOR_ROWS, FLOOR_SEQ = 8, 64
FLASH_BAND = 512                 # query rows of a plain-version band
SSD_SEGMENT = 32_768             # positions of a plain-version segment
# flash_attention at the new calls: (call, (B, S, H, Hkv, D), window), and
# for a non-causal (cross) call the keys' length Sk after the window
LONG_FLASH_CALLS = (
    ("qwen2-1.5b prefill_32k", (2, 32_768, 12, 2, 128), 0),
    ("yi-9b prefill_32k", (1, 32_768, 32, 4, 128), 0),
    ("zamba2-2.7b prefill_32k", (1, 32_768, 32, 32, 80), 4096),
    ("zamba2-2.7b long_500k", (1, LONG_SEQ, 32, 32, 80), 4096),
    ("phi-3-vision-4.2b prefill_32k", (1, 32_768, 32, 32, 96), 0),
    ("olmoe-1b-7b prefill_32k", (1, 32_768, 16, 16, 128), 0),
    ("mixtral-8x22b prefill_32k", (1, 32_768, 48, 8, 128), 4096),
    ("whisper-medium prefill_32k", (1, 32_768, 16, 16, 64), 0),
    ("whisper-medium prefill_32k cross", (1, 32_768, 16, 16, 64), 0, 1500),
    ("smollm-135m prefill_32k", (2, 32_768, 9, 3, 64), 0))
# ssd_scan at the new calls: (call, (b, s, nh, hd, ds, chunk))
LONG_SSD_CALLS = (
    ("mamba2-1.3b prefill_32k", (2, 32_768, 64, 64, 128, 256)),
    ("mamba2-1.3b long_500k", (1, LONG_SEQ, 64, 64, 128, 256)),
    ("zamba2-2.7b prefill_32k", (1, 32_768, 80, 64, 64, 256)),
    ("zamba2-2.7b long_500k", (1, LONG_SEQ, 80, 64, 64, 256)))


def flash_bands(s):
    """(r0, r1) of the bands the plain version checks: the first rows, a
    middle band that starts off the kernel's 128-row q-tiles, the last
    rows."""
    mid = s // 2 + 37
    return ((0, FLASH_BAND), (mid, mid + FLASH_BAND), (s - FLASH_BAND, s))


def flash_band_ref(q, k, v, window, r0, r1, causal=True):
    """The plain version on query rows r0:r1 of a causal call, against
    the keys they can see (from the window's first, else from 0); of a
    non-causal call, against every key."""
    from repro_torch.kernels import flash_attention as fa
    if not causal:
        return fa.flash_attention_ref(q[:, r0:r1], k, v, causal=False)
    c0 = max(0, r0 - window + 1) if window else 0
    return fa.flash_attention_ref(q[:, r0:r1], k[:, c0:r1], v[:, c0:r1],
                                  causal=True, window=window, q_start=r0,
                                  k_start=c0)


def event_ms(torch, fn):
    """Device time of one call of ``fn`` between two CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def flash_long(torch, g, name, shape, window, sk=None):
    """flash_attention at one long call (causal, or with ``sk`` keys a
    non-causal cross call): in bf16 and f32 against its plain version on
    three bands of rows (f32 2e-5, bf16 2e-2); the bf16 kernel's cold-L2
    device time (one input set is more than four L2s), the plain
    version's over every band of the call, SDPA's where one PyTorch call
    computes the same function (no window), and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s = shape[:2]
    causal = sk is None
    checks = []
    for dt in ("float32", "bfloat16"):
        q, k, v = flash_inputs(torch, g, shape, getattr(torch, dt), sk)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        worst = 0.0
        for r0, r1 in flash_bands(s):
            want = flash_band_ref(q, k, v, window, r0, r1, causal)
            part = got[:, r0:r1].float()
            torch.testing.assert_close(part, want.float(), **FLASH_TOL[dt],
                                       msg=lambda m: f"{name} {dt} rows "
                                       f"{r0}:{r1}: {m}")
            worst = max(worst, float((part - want.float()).abs().max()))
        checks.append({"dtype": dt, "bands": flash_bands(s),
                       "max_abs_err": worst, "tol": FLASH_TOL[dt]})
        if dt == "float32":
            del q, k, v, got
            torch.cuda.empty_cache()
    prof_k = profile_calls(torch, lambda i=0: fa.flash_attention(
        q, k, v, causal=causal, window=window), 3 if s > 100_000 else 10)

    def plain_all():
        for r0 in range(0, s, FLASH_BAND):
            flash_band_ref(q, k, v, window, r0, min(s, r0 + FLASH_BAND),
                           causal)
    plain_ms = event_ms(torch, plain_all)
    library_ms, library = None, (
        "none: SDPA takes a window only as a dense (Sq, Sk) mask, "
        f"{s * s / 1e9:.0f} G entries here")
    if not window:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        prof_l = profile_calls(torch, lambda i=0: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
        library_ms = prof_l["rounded_us_per_call"] / 1e3
        library = ("torch.nn.functional.scaled_dot_product_attention("
                   f"is_causal={causal}, enable_gqa=True) on (B, H, S, D)")
        del qt, kt, vt
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(
        shape, "bfloat16", window, causal, sk)
    ms = prof_k["rounded_us_per_call"] / 1e3
    del q, k, v, got
    torch.cuda.empty_cache()
    return {"call": name, "shape": list(shape), "window": window,
            "causal": causal, "sk": sk or s,
            "checks": checks, "ms": ms, "plain_ms": plain_ms,
            "plain": f"the plain version over every {FLASH_BAND}-row band "
                     "(CUDA events)",
            "library_ms": library_ms, "library": library,
            "ms_over_library": ms / library_ms if library_ms else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9,
            "tflop_s": flops / (ms * 1e-3) / 1e12,
            "kernel": [k for k in prof_k["kernels"] if "flash_fwd" in k]}


def ssd_long(torch, g, name, shape):
    """ssd_scan at one long call, against its plain version on segments of
    SSD_SEGMENT positions chained through ``initial_state`` (the plain
    version's (L, L) blocks of the whole call would not fit): f32 1e-4,
    bf16 1e-2 norm-relative against the f32 plain version on the same
    inputs; the bf16 path's device time (each of its three kernels' mean
    per launch), the chained plain version's and the bound."""
    from repro_torch.kernels import ssd_scan as sk
    *dims, chunk = shape
    s = dims[1]
    checks = []
    for dt in ("float32", "bfloat16"):
        x, dtt, A, B, C = ssd_inputs(torch, g, *dims, getattr(torch, dt))
        got = sk.ssd_scan(x, dtt, A, B, C, chunk=chunk)
        num = den = worst = 0.0
        state = None
        for s0 in range(0, s, SSD_SEGMENT):
            sl = slice(s0, s0 + SSD_SEGMENT)
            want, state = sk.ssd_scan_ref(x[:, sl].float(), dtt[:, sl], A,
                                          B[:, sl], C[:, sl], chunk,
                                          initial_state=state)
            part = got[:, sl].float()
            if dt == "float32":
                torch.testing.assert_close(part, want, **SSD_TOL["chunked"])
            d = part - want
            num += float(d.pow(2).sum())
            den += float(want.pow(2).sum())
            worst = max(worst, float(d.abs().max()))
            del want, part, d
        rel = math.sqrt(num / den)
        if dt == "bfloat16" and not rel <= SSD_BF16_REL:
            raise RuntimeError(f"ssd_scan bf16 at {name} {shape}: "
                               f"norm-relative error {rel} > {SSD_BF16_REL}")
        checks.append({"dtype": dt, "segments": -(-s // SSD_SEGMENT),
                       "max_abs_err": worst, "rel_err": rel,
                       "tol": SSD_TOL["chunked"] if dt == "float32"
                       else {"rel": SSD_BF16_REL}})
        del got
        if dt == "float32":
            del x, dtt, A, B, C
            torch.cuda.empty_cache()
    prof = profile_calls(torch, lambda i=0: sk.ssd_scan(
        x, dtt, A, B, C, chunk=chunk), 3, match=sk.KERNELS)
    per_launch = prof["matched_us_per_launch"]
    if not all(per_launch.values()):
        raise RuntimeError(f"ssd_scan at {name}: kernels missing from the "
                           f"profile: {per_launch}")

    def plain_all():
        state = None
        for s0 in range(0, s, SSD_SEGMENT):
            sl = slice(s0, s0 + SSD_SEGMENT)
            _, state = sk.ssd_scan_ref(x[:, sl], dtt[:, sl], A, B[:, sl],
                                       C[:, sl], chunk, initial_state=state)
    plain_ms = event_ms(torch, plain_all)
    bound_ms, bound_by, _, flops, nbytes = ssd_bound_ms(shape, "bfloat16")
    ms = sum(per_launch.values()) / 1e3
    del x, dtt, A, B, C
    torch.cuda.empty_cache()
    return {"call": name, "shape": list(shape), "chunks": s // chunk,
            "checks": checks, "ms": ms,
            "kernel_ms": {k: v / 1e3 for k, v in per_launch.items()},
            "plain_ms": plain_ms,
            "plain": f"the plain version over {SSD_SEGMENT}-position "
                     "segments chained by initial_state (CUDA events)",
            "library_ms": None,
            "library": "none: no PyTorch call computes the SSD scan",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gbytes": nbytes / 1e9,
            "gflop": flops / 1e9}


def phase_kernel_long(torch, flash_rec, ssd_rec):
    """flash_attention and ssd_scan at the long shapes' calls (the
    kernels' longest): the checks and times of flash_long and ssd_long,
    added to the kernels' records under ``long_calls``."""
    g = torch.Generator(device="cuda").manual_seed(6)
    fl = [flash_long(torch, g, *c) for c in LONG_FLASH_CALLS]
    ss = [ssd_long(torch, g, *c) for c in LONG_SSD_CALLS]
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    flash_rec["long_calls"] = {r["call"]: {k: r[k] for k in keys + (
        "window", "causal", "sk")} for r in fl}
    ssd_rec["long_calls"] = {r["call"]: {k: r[k] for k in keys} for r in ss}
    for rec, rows in ((flash_rec, fl), (ssd_rec, ss)):
        rec["max_abs_err"] = max(rec["max_abs_err"], max(
            c["max_abs_err"] for r in rows for c in r["checks"]))
    emit({"phase": "kernel_long", "flash_attention": fl, "ssd_scan": ss})


def seeded_cache(torch, model, b, total, cur, g):
    """``model.init_cache(b, total)`` in the state a prompt of ``cur``
    tokens leaves, with seeded values (no prefill writes the cache: the
    reference fills it by teacher forcing): every K/V slot drawn and the
    ring's last positions in ``pos_buf`` at their slots ``p % slots``;
    the SSM state and the conv window drawn; ``cur`` set."""
    cache = model.init_cache(b, total)
    if "pos_buf" in cache:
        slots = cache["pos_buf"].shape[0]
        pos = torch.arange(max(0, cur - slots), cur, device="cuda")
        cache["pos_buf"][pos % slots] = pos.to(torch.int32)
        for name in ("k", "v"):
            cache[name].normal_(0.0, 0.5, generator=g)
    if "ssm" in cache:
        cache["ssm"].normal_(0.0, 0.1, generator=g)
        cache["conv"].normal_(0.0, 0.5, generator=g)
    cache["cur"] = cur
    return cache


def as_f32_cache(torch, cache, rows=None):
    """The same cache values in float32 (rows ``:rows`` of each batch
    dimension where given), for the f32 step the bf16 one is held to."""
    out = {}
    for k, v in cache.items():
        if k == "cur" or k == "pos_buf":
            out[k] = v if k == "cur" else v.clone()
            continue
        part = v[:, :rows] if rows is not None else v
        out[k] = part.to(torch.float32, copy=True)
    return out


def rel_norm(torch, got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def decode_pair(torch, cfg, params, m16, m32, c16, c32, tok, times=None):
    """One bf16 and one f32 decode step of ``tok`` on caches holding the
    same values; for an MoE arch the f32 step takes the bf16 step's
    expert picks in each layer (``moe_ffn_decode(topi=)``), so a pick
    that bf16 rounding flips does not read as an error.  Returns both
    logits and how many picks the f32 router would have made otherwise
    (0 off the MoE family); appends the bf16 step's wall ms to
    ``times`` where given."""
    def bf16_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m16.decode_step(params, c16, tok)[0]
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        return out

    if not cfg.is_moe:
        return bf16_step(), m32.decode_step(params, c32, tok)[0], 0
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.moe_ffn_decode
    picks, differ = [], [0]

    def record(cfg_, lp, x, *, topi=None):
        out = orig(cfg_, lp, x, topi=topi)
        picks.append(moe_lib.route(lp["router"], x, cfg_.top_k)[2])
        return out

    def replay(cfg_, lp, x, *, topi=None):
        own = moe_lib.route(lp["router"], x, cfg_.top_k)[2]
        pin = picks[replay.i]
        replay.i += 1
        differ[0] += int((own.sort(-1).values != pin.sort(-1).values).sum())
        return orig(cfg_, lp, x, topi=pin)
    replay.i = 0
    try:
        moe_lib.moe_ffn_decode = record
        l16 = bf16_step()
        moe_lib.moe_ffn_decode = replay
        l32 = m32.decode_step(params, c32, tok)[0]
    finally:
        moe_lib.moe_ffn_decode = orig
    return l16, l32, differ[0]


def bf16_floor(torch, cfg, params, m16, m32, phase):
    """The bf16 decode step's own distance from the f32 one on these
    weights where no deep position enters: one step (decode_pair) of
    FLOOR_ROWS rows of a FLOOR_SEQ-position cache seeded as seeded_cache
    seeds one (cur FLOOR_SEQ - 1), the largest of the rows' norm-relative
    distances, held to the arch's LONG_BF16_LIMIT.  Returns it and the
    limit."""
    g = torch.Generator(device="cuda").manual_seed(10)
    c16 = seeded_cache(torch, m16, FLOOR_ROWS, FLOOR_SEQ, FLOOR_SEQ - 1, g)
    c32 = as_f32_cache(torch, c16)
    tok = torch.randint(0, cfg.vocab_size, (FLOOR_ROWS,), generator=g,
                        device="cuda")
    l16, l32, _ = decode_pair(torch, cfg, params, m16, m32, c16, c32, tok)
    v = cfg.vocab_size
    floor = max(rel_norm(torch, l16[i, :v], l32[i, :v])
                for i in range(FLOOR_ROWS))
    limit = LONG_BF16_LIMIT[cfg.name]
    if not floor <= limit:
        raise RuntimeError(f"{phase} {cfg.name}: bf16 decode logits on a "
                           f"{FLOOR_SEQ}-position cache miss f32 by "
                           f"{floor} > {limit}")
    return floor, limit


def long_decode(torch, cfg, params, steps=LONG_DECODE_STEPS):
    """long_500k's decode: ``steps`` bf16 decode steps from a seeded
    cache at ``cur`` LONG_CUR (total context LONG_SEQ, one row), each
    beside an f32 step from the same values (the bf16 cache's, copied)
    and token; each step's bf16 logits within the arch's LONG_BF16_LIMIT
    (norm-relative) of the f32 ones, as bf16_floor's shallow step, no
    kernel launched; ms a token of
    the bf16 steps, the cache's bytes and the ring's pos_buf after the
    steps."""
    from repro_torch.models import build_model
    g = torch.Generator(device="cuda").manual_seed(8)
    m16 = build_model(cfg, compute_dtype=torch.bfloat16, device="cuda")
    m32 = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    floor, gate = bf16_floor(torch, cfg, params, m16, m32, "long_500k")
    c16 = seeded_cache(torch, m16, 1, LONG_SEQ, LONG_CUR, g)
    tok = torch.randint(0, cfg.vocab_size, (steps, 1), generator=g,
                        device="cuda")
    v = cfg.vocab_size
    rels, times, flips = [], [], []

    def run():
        for i in range(steps):
            c32 = as_f32_cache(torch, c16)
            l16, l32, n = decode_pair(torch, cfg, params, m16, m32, c16,
                                      c32, tok[i], times)
            flips.append(n)
            if not all_finite(torch, l16):
                raise RuntimeError(f"long_500k {cfg.name}: step {i} logits "
                                   "are not finite")
            rels.append(rel_norm(torch, l16[:, :v], l32[:, :v]))
    _, launches = count_launches(torch, run)
    check_launches(f"long_500k decode {cfg.name}", launches, {})
    if not max(rels) <= gate:
        raise RuntimeError(f"long_500k {cfg.name}: bf16 decode logits miss "
                           f"f32 by {max(rels)} > {gate} (the shallow "
                           f"cache's {floor})")
    rec = {"arch": cfg.name, "cur_from": LONG_CUR, "steps": steps,
           "cur_after": c16["cur"], "bf16_rel_err": rels,
           "bf16_floor": floor, "tol_rel": gate,
           "moe_picks_f32_would_differ": flips if cfg.is_moe else None,
           "ms_per_token": statistics.median(times[1:]),
           "first_step_ms": times[0],
           "cache_gb": sum(t.numel() * t.element_size() for k, t in
                           c16.items() if k != "cur") / 1e9}
    if "pos_buf" in c16:
        pos = c16["pos_buf"]
        last = LONG_CUR + steps - 1
        if int(pos.max()) != last or int(pos[last % pos.shape[0]]) != last \
                or int(pos.min()) != last - pos.shape[0] + 1:
            raise RuntimeError(f"long_500k {cfg.name}: the ring's pos_buf "
                               f"spans {int(pos.min())}..{int(pos.max())}")
        rec.update(ring_slots=pos.shape[0], pos_buf_span=[
            int(pos.min()), int(pos.max())])
    del c16
    torch.cuda.empty_cache()
    return rec


def decode_32k(torch, cfg, params):
    """decode_32k on one card: DECODE_32K_ROWS[cfg.name] rows of a bf16
    cache of DECODE_32K_SEQ positions filled with seeded K/V, pos_buf
    0 .. 32,766 and cur 32,767, stepped again and again at cur 32,767
    (each step rewrites slot 32,767 and attends over the whole cache):
    ms a token beside the bytes a step must read at least (the K/V cache
    and the f32 weights it casts) over the HBM rate; row 0's bf16
    logits within the arch's LONG_BF16_LIMIT of an f32 step on the same
    values, as bf16_floor's shallow step."""
    from repro_torch.models import build_model
    rows = DECODE_32K_ROWS[cfg.name]
    cur = DECODE_32K_SEQ - 1
    g = torch.Generator(device="cuda").manual_seed(9)
    m16 = build_model(cfg, compute_dtype=torch.bfloat16, device="cuda")
    m32 = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    floor, gate = bf16_floor(torch, cfg, params, m16, m32, "decode_32k")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c16 = seeded_cache(torch, m16, rows, DECODE_32K_SEQ, cur, g)
    tok = torch.randint(0, cfg.vocab_size, (rows,), generator=g,
                        device="cuda")
    times = []

    def run():
        out = None
        for i in range(DECODE_32K_STEPS + 1):
            c16["cur"] = cur
            t0 = time.perf_counter()
            logits, _ = m16.decode_step(params, c16, tok)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out = logits if out is None else out
        return out
    l16, launches = count_launches(torch, run)
    check_launches(f"decode_32k {cfg.name}", launches, {})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all_finite(torch, l16):
        raise RuntimeError(f"decode_32k {cfg.name}: logits are not finite")
    kv_bytes = sum(c16[k].numel() * c16[k].element_size() for k in ("k", "v"))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in all_tensors(params))
    c32 = as_f32_cache(torch, c16, rows=1)
    del c16
    torch.cuda.empty_cache()
    c32["cur"] = cur
    l32, _ = m32.decode_step(params, c32, tok[:1])
    v = cfg.vocab_size
    rel = rel_norm(torch, l16[:1, :v], l32[:, :v])
    if not rel <= gate:
        raise RuntimeError(f"decode_32k {cfg.name}: row 0's bf16 logits "
                           f"miss f32 by {rel} > {gate} (the shallow "
                           f"cache's {floor})")
    del c32
    torch.cuda.empty_cache()
    ms = statistics.median(times[1:])
    step_bytes = kv_bytes + param_bytes
    return {"arch": cfg.name, "rows": rows, "seq": DECODE_32K_SEQ,
            "cur": cur, "cache_dtype": "bfloat16",
            "reduced": {"batch": [DECODE_32K_GLOBAL, rows],
                        "why": "the registered batch's cache does not fit "
                               "one card: "
                               f"{kv_bytes / rows * DECODE_32K_GLOBAL / 1e9:.1f}"
                               " GB of K/V at 128 rows"},
            "ms_per_token": ms, "first_step_ms": times[0],
            "steps_ms": times, "cache_gb": kv_bytes / 1e9,
            "param_gb_f32": param_bytes / 1e9,
            "step_read_gb_min": step_bytes / 1e9,
            "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_share": step_bytes / HBM_BYTES_PER_S * 1e3 / ms,
            "peak_gb": peak_gb, "row0_bf16_rel_err": rel,
            "bf16_floor": floor, "tol_rel": gate}


def prefill_32k_reduced(cfg):
    rows = PREFILL_32K_ROWS[cfg.name]
    return {"batch": [PREFILL_32K_GLOBAL, rows],
            "why": f"{rows} of the registered {PREFILL_32K_GLOBAL} rows at "
                   "full depth on one 80 GB card; the rows are independent"}


def part(rec):
    """A phase's part, on stderr as it completes (the phase's line on
    stdout comes once its last part has run)."""
    print(json.dumps({"part": rec, "t_s": time.perf_counter() - T_START}),
          file=sys.stderr, flush=True)
    return rec


def prefill_32k_run(torch, cfg, params, expect, reduced=None):
    """prefill_32k's part of one arch: phase_prefill at its rows of
    (PREFILL_32K_GLOBAL, PREFILL_32K_SEQ) on ``params`` (an MoE's slots
    dropped per layer with it); ``reduced`` adds the arch's other cuts."""
    rec, _ = phase_prefill(
        torch, "prefill_32k", cfg, expect,
        shape=(PREFILL_32K_ROWS[cfg.name], PREFILL_32K_SEQ),
        extra={"reduced": {**prefill_32k_reduced(cfg), **(reduced or {})}},
        params=params, show=False)
    return part(rec)


def long_500k_run(torch, cfg, params, expect):
    """long_500k's part of an SSM or hybrid arch at full depth: a bf16
    forward at (1, LONG_SEQ) (phase_prefill, one call) and the decode
    steps from LONG_CUR (long_decode)."""
    fwd, _ = phase_prefill(torch, "long_500k", cfg, expect,
                           shape=(1, LONG_SEQ), params=params, show=False)
    return {"arch": cfg.name, "forward": part(fwd),
            "decode": part(long_decode(torch, cfg, params))}


def long_launches(long, flash_rec, ssd_rec):
    """Each kernel's launches per forward in the long phases' runs, into
    its record of the kernels line."""
    runs = {"prefill_32k": long["prefill_32k"],
            "long_500k": [r["forward"] for r in long["long_500k"]
                          if "forward" in r]}
    for key, rs in runs.items():
        for rec in (flash_rec, ssd_rec):
            rec[f"launches_{key}"] = {
                r["arch"]: r["launches"][rec["name"]] for r in rs
                if r["launches"].get(rec["name"])}


def phase_yi9b(torch, long, flash_rec):
    """yi-9b at full width and depth (48 layers, 35 GB of f32 weights,
    drawn once): prefill_32k at (1, 32768) (48 flash_attention launches,
    finite logits), decode against forward in f32 at S = 64 (2e-3),
    decode_32k's 8 rows, and run_serve with its FFR shed under 700 ms;
    prints the yi9b line, then decode_32k's (qwen2-1.5b's part taken
    earlier in ``long``)."""
    from repro_torch.models import build_model
    cfg = get_cfg("yi-9b")
    expect = {"flash_attention": cfg.num_layers}
    t0 = time.perf_counter()
    params = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pre = prefill_32k_run(torch, cfg, params, expect)
    flash_rec["launches_yi9b_prefill_32k"] = pre["launches"][
        "flash_attention"]
    dvf = phase_decode_vs_forward(torch, "decode_vs_forward", cfg, params,
                                  64, expect, show=False)
    long["decode_32k"].append(decode_32k(torch, cfg, params))
    serve = phase_serve(torch, "yi-9b", params=params, show=False)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "yi9b", "arch": cfg.name, "depth": cfg.num_layers,
          "init_s": init_s, "prefill_32k": pre, "decode_vs_forward": dvf,
          "serve": serve})
    emit({"phase": "decode_32k", "runs": long["decode_32k"]})


TRAIN_FSDP_STEPS = 3              # (a): the sharded trainer's steps
TRAIN_FSDP_REL = 2e-2             # (a) against train_ssm; (b) bf16 per leaf
TRAIN_FSDP_F32_REL = 1e-4         # (b) in f32 compute, per leaf
# (b) runs in train_tp's mamba2-1.3b world (the same 2-layer cut, batch
# and steps): on a (2, 1) mesh, 4 rows a rank, 1 a microbatch
TRAIN_FSDP_ARCH = "mamba2-1.3b"
TRAIN_FSDP_WARM_IDS = (146, 147, 148, 149)  # (b): replicated, past warm-up
TRAIN_FSDP_STEP_IDS = (150, 151)  # train_tp's steps against replicated
TRAIN_FSDP_B_STEP_IDS = TRAIN_FSDP_STEP_IDS[:1]  # (b)'s: the run time
DRYRUN_CELLS = (("mamba2-1.3b", "train_4k"), ("qwen2-1.5b", "decode_32k"))
DRYRUN_TIMEOUT_S = 900


def leaf_places(bundle, mesh) -> list:
    """(placements or None, the ranks holding each element) of every leaf
    of the training state (parameters, then AdamW's mu and nu) that
    ``bundle`` places on ``mesh``, in leaf order: None where every
    placement replicates the leaf."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding import fsdp

    def by_leaf(tree):
        return [x for k in sorted(tree) for x in by_leaf(tree[k])] \
            if isinstance(tree, dict) else [tree]
    out = []
    for pl in (by_leaf(bundle.param_placements)
               + by_leaf(bundle.opt_placements.mu)
               + by_leaf(bundle.opt_placements.nu)):
        shards_n = math.prod(mesh.size(i) for i, q in enumerate(pl)
                             if not isinstance(q, Replicate))
        out.append((None, mesh.size()) if fsdp.replicated(pl)
                   else (pl, mesh.size() // shards_n))
    return out


def fsdp_run(torch, bundle, mesh, warm, warm_step, tokens, chunks, places,
             names, rep, rep_norms):
    """train_fsdp (b), in train_tp's mamba2-1.3b world: the warm state
    (``warm``: parameters, mu, nu on the host; ``warm_step``) placed by
    ``bundle`` on the (2, 1) ``mesh`` -- FSDP over ``data`` -- takes
    TRAIN_FSDP_B_STEP_IDS on this rank's rows.  Each rank holds its shard
    of every leaf against ``chunks``, its chunk of the replicated state
    after the same steps (whose losses and grad norms are ``rep`` and
    ``rep_norms``), and the ranks' squared sums are added (each element
    once), so no leaf is gathered for the comparison; in f32 also each
    parameter's change over the steps."""
    from repro_torch._tree import leaves, tree_map
    from repro_torch.optim import AdamWState
    from repro_torch.sharding import fsdp
    from repro_torch.train import step as st
    t_run = time.perf_counter()

    def put(tree, pls):
        return tree_map(lambda t, pl: fsdp.place(
            t.to("cuda", copy=True), mesh, pl), tree, pls)
    params = put(warm[0], bundle.param_placements)
    opt = AdamWState(step=warm_step.clone(),
                     mu=put(warm[1], bundle.opt_placements.mu),
                     nu=put(warm[2], bundle.opt_placements.nu))
    held = fsdp.shard_bytes((params, opt.mu, opt.nu))
    n_p = len(leaves(params))
    before = [fsdp.local(x).detach().to("cpu", copy=True)
              for x in leaves(params)]
    rows = st.batch_rows(bundle.rules, bundle.shape.global_batch,
                         mesh.get_coordinate(), bundle.cfg.plan.microbatches)
    batch = {"tokens": tokens[rows].cuda()}
    losses, norms, dts = [], [], []
    coll = fsdp.reset_collective_stats()
    torch.cuda.synchronize()
    for i in TRAIN_FSDP_B_STEP_IDS:
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, batch, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        dts.append(time.perf_counter() - t0)
    coll = {"bytes_by_op_per_step": {k: v / len(dts) for k, v in
                                     coll["bytes_by_op"].items()},
            "calls_per_step": coll["calls"] / len(dts),
            "seconds_per_step": coll["seconds"] / len(dts)}
    shards = [fsdp.local(x).detach().cpu()
              for x in leaves((params, opt.mu, opt.nu))]
    del params, opt
    torch.cuda.empty_cache()
    rels = shard_rels(torch, shards, chunks, places)
    moved = shard_rels(
        torch, [a - w for a, w in zip(shards[:n_p], before)],
        [a - w for a, w in zip(chunks[:n_p], before)], places[:n_p])
    order = sorted(range(len(rels)), key=lambda k: -rels[k])
    worst_moved = max(range(n_p), key=lambda k: moved[k])
    return {"resident_bytes": held, "placed_bytes": bundle.state_bytes(),
            "losses": losses, "grad_norms": norms, "step_s": dts,
            "replicated_losses": rep, "replicated_grad_norms": rep_norms,
            "loss_rel": max(abs(a - r) / abs(r)
                            for a, r in zip(losses, rep)),
            "grad_norm_rel": max(abs(a - r) / abs(r)
                                 for a, r in zip(norms, rep_norms)),
            "leaves": len(rels), "worst_leaf_rel": max(rels),
            "worst_leaf": names[order[0]],
            "worst_leaves": {names[k]: rels[k] for k in order[:6]},
            "worst_change_rel": moved[worst_moved],
            "worst_change_leaf": names[worst_moved],
            "gathers_and_scatters": coll,
            "seconds": time.perf_counter() - t_run}


def shard_rels(torch, got, want, places) -> list:
    """Each leaf's |got - want| / |want| over the whole leaf, from this
    rank's chunks: the squared sums of every rank added by one
    all-reduce, each divided by the ranks holding the same elements."""
    import torch.distributed as dist
    sums = torch.tensor([[float((g.double() - w.double()).square().sum()),
                          float(w.double().square().sum())]
                         for g, w in zip(got, want)], dtype=torch.float64)
    sums /= torch.tensor([[n] for _, n in places], dtype=torch.float64)
    dist.all_reduce(sums)
    return [float((d / max(r, 1e-300)) ** 0.5) for d, r in sums.tolist()]


def spawn_workers(flag, worlds, timeout_s, n=2):
    """``n`` processes of this script with ``flag`` under the REPRO_*
    contract on a free localhost port, for one world (``worlds`` its out
    dir) or for several at once (``worlds`` a list of (out dir, the
    worker's other arguments...), each world on its own port); fails if
    one fails or outlives ``timeout_s`` (all are killed then).  Returns
    each rank's record, a list per world for several."""
    import socket
    single = isinstance(worlds, str)
    args = [(worlds,)] if single else [tuple(w) for w in worlds]
    procs = []
    try:
        for argv in args:
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            for r in range(n):
                env = dict(os.environ, REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                           REPRO_NUM_PROCESSES=str(n),
                           REPRO_PROCESS_ID=str(r))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), flag, *argv],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise RuntimeError(f"{flag}: worker {r} exited "
                                   f"{p.returncode}: {out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = []
    for argv in args:
        world = []
        for r in range(n):
            with open(os.path.join(argv[0], f"rank{r}.json")) as f:
                world.append(json.load(f))
        recs.append(world)
    return recs[0] if single else recs


def phase_train_fsdp(torch, ssm):
    """The sharded training state on the card: (a) the Trainer at full
    mamba2-1.3b width and depth on make_local_mesh() (a world of one on
    NCCL) for TRAIN_FSDP_STEPS steps of train_ssm's batch, against
    ``ssm``, train_ssm's record.  (b), two ranks sharing the card on gloo,
    runs in train_tp's mamba2-1.3b world (fsdp_run).  Returns (a)'s
    launches."""
    import torch.distributed as dist
    from repro_torch._tree import leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import fsdp
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = get_cfg("mamba2-1.3b")
    b, s = TRAIN_SSM_SHAPE
    mesh = make_local_mesh("cuda")
    backend = dist.get_backend()
    try:
        trainer = Trainer(cfg, ShapeConfig("smoke_train_fsdp", s, b,
                                           "train"),
                          mesh,
                          TrainerConfig(steps=TRAIN_FSDP_STEPS, log_every=0),
                          device="cuda")
        torch.cuda.reset_peak_memory_stats()
        params, opt = trainer.init_state()
        held = fsdp.shard_bytes((params, opt.mu, opt.nu))
        want_bytes = trainer.bundle.state_bytes()
        sharded = sum(fsdp.is_sharded(x) for x in leaves(params))
        counters = train_launch_counters()
        for c in counters.values():
            c.launches = 0
        coll = fsdp.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train(params, opt)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = out["history"]
        del params, opt, out, trainer
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    want = train_launches_expected(cfg, len(hist))
    ref = {int(k): v for k, v in ssm["loss_by_step"].items()}
    common = [h["step"] for h in hist if h["step"] in ref]
    rel = {st: abs(h["loss"] - ref[st]) / abs(ref[st])
           for h in hist for st in [h["step"]] if st in ref}
    if not all(np.isfinite(losses)) or launches != want or \
            held != want_bytes or len(common) < 2 or \
            max(rel.values()) > TRAIN_FSDP_REL:
        raise RuntimeError(
            f"train_fsdp: losses {losses}, launches {launches} (expected "
            f"{want}), resident {held} B (by placement {want_bytes}), "
            f"against train_ssm at steps {common}: {rel}")
    ms = statistics.median([h["dt"] for h in hist][1:]) * 1e3
    world_one = {
        "backend": backend, "mesh": {"data": 1, "model": 1},
        "arch": cfg.name, "batch": b, "seq": s,
        "microbatches": cfg.plan.microbatches, "steps": len(hist),
        "dtensor_param_leaves": sharded, "resident_bytes": held,
        "placed_bytes": want_bytes, "losses": losses,
        "train_ssm_losses": {st: ref[st] for st in common},
        "loss_rel_to_train_ssm": rel, "ms_per_step": ms,
        "train_ssm_ms_per_step": ssm["ms_per_step"],
        "dtensor_host_cost_ms_per_step": ms - ssm["ms_per_step"],
        "step_ms": [h["dt"] * 1e3 for h in hist], "wall_s": wall_s,
        "peak_gb": peak_gb, "train_ssm_peak_gb": ssm["peak_gb"],
        "launches": launches, "launches_expected": want,
        "gathers_and_scatters": dict(coll)}
    emit({"phase": "train_fsdp", "part": "world_of_one", **world_one,
          "seconds": time.perf_counter() - t_phase})
    return launches


# train_tp: two ranks on a (data 1, model 2) mesh, tensor parallelism
TRAIN_TP_ARCHS = ("mamba2-1.3b", "yi-9b")   # scan; attention at GQA 8
TRAIN_TP_LAYERS = 2               # full width, depth cut to 2 layers
TRAIN_TP_SHAPE = (8, 2048)        # 4 microbatches of (2, 2048), every row
TRAIN_TP_MESH = (1, 2)            # on both ranks
TRAIN_TP_FLOP_RATIO = 0.55        # a rank's matmul FLOPs / replicated
TP_WORKER_TIMEOUT_S = 420
# decode_tp, in train_tp's worlds after their steps: decode_32k's 8 rows
# a rank and its 32,768-position cache, a 64-token prompt teacher-forced,
# then 32 tokens; yi-9b in its registered layout (4 kv heads on 2: by
# heads) and by positions ("seq"); the ids fed are the replicated run's
DECODE_TP_ROWS, DECODE_TP_POSITIONS = 8, 32_768
DECODE_TP_PROMPT, DECODE_TP_GEN = 64, 32
DECODE_TP_LAYOUTS = {"yi-9b": (None, "seq"), "mamba2-1.3b": (None,)}
DECODE_TP_F32 = dict(atol=1e-4, rtol=1e-4)   # tests/test_torch_models.py
DECODE_TP_BF16_REL = 2e-2                    # norm-relative, per step


def tp_kernel_calls():
    """Record the shapes of every call of the model kernels' entry points
    (``kernels/ops.py``: the forwards; the backwards where the autograd
    Functions call them): {name: [(shapes), ...]}; each call goes on to
    its kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    calls = {k: [] for k in ("flash_attention", "flash_attention_bwd",
                             "ssd_scan", "ssd_scan_bwd")}
    f_fwd, f_bwd, s_fwd, s_bwd = (ops.flash_attention, fa._bwd,
                                  ops.ssd_scan, sk.ssd_scan_bwd)

    def flash(q, k, v, **kw):
        calls["flash_attention"].append((list(q.shape), list(k.shape)))
        return f_fwd(q, k, v, **kw)

    def flash_bwd(q, k, v, o, do, lse, **kw):
        calls["flash_attention_bwd"].append((list(q.shape), list(k.shape)))
        return f_bwd(q, k, v, o, do, lse, **kw)

    def scan(x, dt, A, B, C, **kw):
        calls["ssd_scan"].append((list(x.shape), list(B.shape)))
        return s_fwd(x, dt, A, B, C, **kw)

    def scan_bwd(x, dt, A, B, C, dy, **kw):
        calls["ssd_scan_bwd"].append((list(x.shape), list(B.shape)))
        return s_bwd(x, dt, A, B, C, dy, **kw)
    ops.flash_attention, fa._bwd = flash, flash_bwd
    # ssd_scan_bwd counts its launches on the module's name, which is the
    # recorder's now: it takes the count over
    scan_bwd.launches = s_bwd.launches
    ops.ssd_scan, sk.ssd_scan_bwd = scan, scan_bwd
    return calls


def tp_kernel_checks(torch, cfg, dname, m):
    """The kernels at the shapes a rank of a ``model`` of ``m`` calls them
    with in cfg's training step (this rank's heads, one microbatch),
    against their plain versions at the kernels' tolerances: the forward
    and both backwards.  Raises on a miss; returns the errors."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    dtype = getattr(torch, dname)
    b, s = TRAIN_TP_SHAPE[0] // 4, TRAIN_TP_SHAPE[1]
    g = torch.Generator(device="cuda").manual_seed(31)
    if cfg.family == "ssm":
        shape = (b, s, cfg.ssm_n_heads // m, cfg.ssm_head_dim,
                 cfg.ssm_state, cfg.ssm_chunk)
        *dims, chunk = shape
        args = ssd_inputs(torch, g, *dims, dtype)
        got = sk.ssd_scan(*args, chunk=chunk)
        if dname == "float32":
            want = sk.ssd_scan_ref(*args, chunk)[0]
            torch.testing.assert_close(got, want, **SSD_TOL["chunked"])
            err = {"fwd_max_abs_err": float((got - want).abs().max())}
        else:
            want = sk.ssd_scan_ref(args[0].float(), *args[1:], chunk)[0]
            rel = float((got.float() - want).norm() / want.norm())
            if not rel <= SSD_BF16_REL:
                raise RuntimeError(f"train_tp: ssd_scan bf16 at {shape}: "
                                   f"{rel} > {SSD_BF16_REL}")
            err = {"fwd_rel_err": rel}
        del args, got, want
        bwd, _ = ssd_bwd_checks(torch, [(shape, dname)])
        return {"shape": list(shape), **err, "bwd": bwd[0]}
    shape = (b, s, *tp_local_heads(cfg, m), cfg.resolved_head_dim)
    q, k, v = flash_inputs(torch, g, shape, dtype)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL_LONG_F32 if dname == "float32" else FLASH_TOL[dname]
    torch.testing.assert_close(got, want, **tol)
    do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    plain = plain_grads(torch, q, k, v, do, 0)
    for a, p_ in zip(grads, plain):
        torch.testing.assert_close(a.float(), p_.float(),
                                   **FLASH_BWD_TOL[dname])
    return {"shape": list(shape),
            "fwd_max_abs_err": float((got.float() - want.float()).abs()
                                     .max()),
            "bwd_max_abs_err_dq_dk_dv": [float((a.float() - p_.float())
                                               .abs().max())
                                         for a, p_ in zip(grads, plain)]}


def tp_product_ms(torch, cfg, dtype, m):
    """Device ms of one microbatch's forward weight products of one layer
    and of the vocabulary (2 x 2048 tokens), at the whole widths and at a
    rank's widths on a ``model`` of ``m`` (CUDA events over 20 runs, the
    rank alone on the card): the products' share that tensor parallelism
    leaves a rank, without the other rank's kernels in its window."""
    d, t = cfg.d_model, TRAIN_TP_SHAPE[0] // 4 * TRAIN_TP_SHAPE[1]
    if cfg.family == "ssm":
        di = cfg.ssm_d_inner
        # (K, N, split): w_zx, w_dt column-split; w_bc whole; w_out rows
        prods = [(d, 2 * di, "n"), (d, cfg.ssm_n_heads, "n"),
                 (d, 2 * cfg.ssm_state, None), (di, d, "k")]
    else:
        hd = cfg.resolved_head_dim
        q, kv, f = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff
        prods = [(d, q, "n"), (d, kv, "n"), (d, kv, "n"), (q, d, "k"),
                 (d, f, "n"), (d, f, "n"), (f, d, "k")]
    prods.append((d, cfg.padded_vocab, "n"))

    def run(split):
        mats = []
        for k, n, how in prods:
            k2 = k // m if split and how == "k" else k
            n2 = n // m if split and how == "n" else n
            mats.append((torch.randn(t, k2, device="cuda", dtype=dtype),
                         torch.randn(k2, n2, device="cuda", dtype=dtype)))
        for a, b in mats:
            a @ b
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(20):
            for a, b in mats:
                a @ b
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20
    whole, local = run(False), run(True)
    return {"tokens": t, "whole_ms": whole, "rank_ms": local,
            "ratio": local / whole}


def step_profile(torch, fn):
    """Wall ms of ``fn()`` (one training step) under torch.profiler, its
    device time and the device time of the GEMMs (cuBLAS's and CUTLASS's
    kernels), of the port's model kernels and of the copies (gloo moves
    CUDA tensors through the host)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]

    def dev(keys):
        return sum((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0))
                   for e in kernels
                   if keys is None or any(k in e.key.lower() for k in keys))
    return out, {"ms": wall * 1e3, "device_ms": dev(None) / 1e3,
                 "gemm_device_ms": dev(("gemm", "xmma", "cutlass",
                                        "nvjet")) / 1e3,
                 "kernel_device_ms": dev(("flash_", "ssd_")) / 1e3,
                 "memcpy_device_ms": dev(("memcpy",)) / 1e3,
                 "launches": sum(e.count for e in kernels)}


def tp_worker(out_dir, arch):
    """One rank of train_tp's world for ``arch`` (REPRO_* set by the
    parent; the ranks share the card, so gloo): ``arch`` at full width
    cut to TRAIN_TP_LAYERS layers on a (data 1, model 2) mesh -- tensor
    parallelism: each rank computes its heads, its MLP columns and its
    vocabulary columns (``sharding/tp.py``) --, in bf16 and then f32
    compute: one process's replicated step warms the state through
    TRAIN_FSDP_WARM_IDS on the whole TRAIN_TP_SHAPE batch; that state,
    placed, takes TRAIN_FSDP_STEP_IDS tensor-parallel, the replicated
    step beside.  Step 150 of each runs under FlopCounterMode (the matmul
    FLOPs), step 151 under the profiler (device time; the replicated ones
    one rank after the other).  Records each kernel call's shapes, the
    launches and the collectives a step.  For TRAIN_FSDP_ARCH the same
    warm state also takes TRAIN_FSDP_B_STEP_IDS on a (2, 1) mesh
    (train_fsdp (b), fsdp_run), then decode_tp's runs follow
    (decode_tp_runs)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch._tree import leaves, leaves_with_paths, tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import ensure_distributed
    from repro_torch.optim import AdamWState
    from repro_torch.sharding import fsdp
    from repro_torch.train import step as st
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ensure_distributed("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(TRAIN_TP_MESH),
                      mesh_dim_names=("data", "model"))
    calls = tp_kernel_calls()
    counters = train_launch_counters()
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "runs": {}}
    fmesh = None
    if arch == TRAIN_FSDP_ARCH:           # train_fsdp (b): FSDP over data
        fmesh = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                           mesh_dim_names=("data", "model"))
        rec["fsdp_runs"] = {}
    b, s = TRAIN_TP_SHAPE
    cfg = dataclasses.replace(get_cfg(arch), num_layers=TRAIN_TP_LAYERS)
    shape = ShapeConfig("smoke_train_tp", s, b, "train")
    tokens = torch.randint(cfg.vocab_size, (b, s), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7))
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        kw = dict(compute_dtype=dtype)
        t_run = time.perf_counter()
        rb = st.build_step_bundle(cfg, shape, device="cuda",
                                  model_kw=kw)
        p, o = rb.init_state(0)
        whole = {"tokens": tokens.cuda()}
        for i in TRAIN_FSDP_WARM_IDS:
            p, o, _ = rb.step_fn(p, o, whole, i)
        torch.cuda.synchronize()
        secs = {"init_and_warm": time.perf_counter() - t_run}
        bundle = st.build_step_bundle(cfg, shape, mesh, device="cuda",
                                      model_kw=kw)
        # the replicated steps first, from the warm state, which waits on
        # the host for the tensor-parallel steps: two worlds share the
        # card, and yi-9b's 2-layer state is 10.6 GB a rank
        warm = [tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
                for tree in (p, o.mu, o.nu)]
        warm_step = o.step.clone()
        i0, i1 = TRAIN_FSDP_STEP_IDS
        t0 = time.perf_counter()
        rep, rep_norms = [], []
        with FlopCounterMode(display=False) as fc:
            p, o, mr = rb.step_fn(p, o, whole, i0)
        rep_flops = fc.get_total_flops()
        rep.append(float(mr["loss"]))
        rep_norms.append(float(mr["grad_norm"]))
        if fmesh is not None:         # (b)'s chunks, after its one step
            fbundle = st.build_step_bundle(cfg, shape, fmesh, device="cuda",
                                           model_kw=kw)
            fplaces = leaf_places(fbundle, fmesh)
            fchunks = [(r_ if pl is None else fsdp.local_chunk(r_, fmesh, pl))
                       .detach().cpu() for (_, r_), (pl, _) in zip(
                           leaves_with_paths((p, o.mu, o.nu)), fplaces)]
        for r in range(world):        # one rank at a time on the card
            dist.barrier()
            if r == rank:
                (p, o, mr), rep_prof = step_profile(
                    torch, lambda: rb.step_fn(p, o, whole, i1))
        dist.barrier()
        rep.append(float(mr["loss"]))
        rep_norms.append(float(mr["grad_norm"]))
        places = leaf_places(bundle, mesh)
        named = list(leaves_with_paths((p, o.mu, o.nu)))
        names = ["/".join(path) for path, _ in named]
        chunks = [(r_ if pl is None else fsdp.local_chunk(r_, mesh, pl))
                  .detach().clone()
                  for (_, r_), (pl, _) in zip(named, places)]
        del p, o, rb, named, whole
        torch.cuda.empty_cache()
        secs["replicated_steps"] = time.perf_counter() - t0

        def put(tree, places):
            return tree_map(lambda t, pl: fsdp.place(
                t.to("cuda", copy=True), mesh, pl), tree, places)
        params = put(warm[0], bundle.param_placements)
        opt = AdamWState(step=warm_step.clone(),
                         mu=put(warm[1], bundle.opt_placements.mu),
                         nu=put(warm[2], bundle.opt_placements.nu))
        held = fsdp.shard_bytes((params, opt.mu, opt.nu))
        want_bytes = bundle.state_bytes()
        n_p = len(leaves(params))
        before = [fsdp.local(x).detach().clone()
                  for x in leaves(params)]
        rows = st.batch_rows(bundle.rules, b, mesh.get_coordinate(),
                             cfg.plan.microbatches)
        batch = {"tokens": tokens[rows].cuda()}
        losses, norms = [], []
        for v in calls.values():
            v.clear()
        start = {k: c.launches for k, c in counters.items()}
        coll = fsdp.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            params, opt, mt = bundle.step_fn(params, opt, batch, i0)
        tp_flops = fc.get_total_flops()
        losses.append(float(mt["loss"]))
        norms.append(float(mt["grad_norm"]))
        (params, opt, mt), prof = step_profile(
            torch, lambda: bundle.step_fn(params, opt, batch, i1))
        losses.append(float(mt["loss"]))
        norms.append(float(mt["grad_norm"]))
        launched = {k: c.launches - start[k]
                    for k, c in counters.items()}
        seen = {k: list(v) for k, v in calls.items()}
        coll = {"bytes_by_op_per_step": {
                    k: v / 2 for k, v in coll["bytes_by_op"].items()},
                "calls_per_step": coll["calls"] / 2,
                "seconds_per_step": coll["seconds"] / 2}
        shards = [fsdp.local(x).detach()
                  for x in leaves((params, opt.mu, opt.nu))]
        secs["tp_steps"] = time.perf_counter() - t0
        rels = shard_rels(torch, shards, chunks, places)
        moved = shard_rels(
            torch, [a - w for a, w in zip(shards[:n_p], before)],
            [a - w for a, w in zip(chunks[:n_p], before)],
            places[:n_p])
        order = sorted(range(len(rels)), key=lambda k: -rels[k])
        worst_moved = max(range(n_p), key=lambda k: moved[k])
        del shards, chunks, before, params, opt, bundle
        torch.cuda.empty_cache()
        rec["runs"][f"{arch}/{dname}"] = {
            "arch": arch, "family": cfg.family,
            "resident_bytes": held, "placed_bytes": want_bytes,
            "losses": losses, "grad_norms": norms,
            "replicated_losses": rep,
            "replicated_grad_norms": rep_norms,
            "loss_rel": max(abs(a - r_) / abs(r_)
                            for a, r_ in zip(losses, rep)),
            "grad_norm_rel": max(abs(a - r_) / abs(r_)
                                 for a, r_ in zip(norms, rep_norms)),
            "leaves": len(rels), "worst_leaf_rel": max(rels),
            "worst_leaf": names[order[0]],
            "worst_leaves": {names[k]: rels[k] for k in order[:6]},
            "worst_change_rel": moved[worst_moved],
            "worst_change_leaf": names[worst_moved],
            "matmul_flops": tp_flops,
            "replicated_matmul_flops": rep_flops,
            "flop_ratio": tp_flops / rep_flops,
            "step": prof, "replicated_step": rep_prof,
            "kernel_calls": seen, "launches": launched,
            "launches_expected": train_launches_expected(cfg, 2),
            "collectives": coll, "seconds": secs}
        if fmesh is not None:
            rec["fsdp_runs"][dname] = fsdp_run(
                torch, fbundle, fmesh, warm, warm_step, tokens, fchunks,
                fplaces, names, rep[:1], rep_norms[:1])
            del fbundle, fchunks
        del warm
    rec["decode"] = decode_tp_runs(torch, arch, mesh)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def decode_tp_run(torch, cfg, mesh, dtype):
    """One tensor-parallel decode run of ``cfg`` on ``mesh`` in ``dtype``:
    rank 0 first decodes alone on the whole parameters and cache
    (``Model.decode_step``, the replicated run; the other rank waits),
    then both ranks run the bundle's step (``make_decode_step``) on their
    ``model`` shards and ``cache_pspecs`` shards of the cache, fed the
    same ids.  Returns the readings; rank 0's hold the logits' distance
    from the replicated run's at every step."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.sharding import fsdp
    from repro_torch.train import step as st
    rank = dist.get_rank()
    b, steps = DECODE_TP_ROWS, DECODE_TP_PROMPT + DECODE_TP_GEN
    bundle = st.build_step_bundle(
        cfg, ShapeConfig("smoke_decode_tp", DECODE_TP_POSITIONS, b,
                         "decode"), mesh, device="cuda",
        model_kw=dict(compute_dtype=dtype))
    model = bundle.model
    v = cfg.vocab_size
    ids = torch.zeros((b, steps), dtype=torch.int32, device="cuda")
    ids[:, :DECODE_TP_PROMPT] = torch.randint(
        v, (b, DECODE_TP_PROMPT), dtype=torch.int32,
        generator=torch.Generator().manual_seed(17)).cuda()
    rep, rep_ms = [], None
    dist.barrier()
    if rank == 0:
        whole = model.init(0)
        rcache = model.init_cache(b, DECODE_TP_POSITIONS)
        with torch.no_grad():
            for t in range(steps):
                if t == DECODE_TP_PROMPT:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                logits, rcache = model.decode_step(whole, rcache, ids[:, t])
                rep.append(logits.float())
                if DECODE_TP_PROMPT <= t + 1 < steps:
                    ids[:, t + 1] = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        rep_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TP_GEN
        rep_cache_bytes = sum(x.numel() * x.element_size()
                              for k, x in rcache.items() if k != "cur")
        del whole, rcache
        torch.cuda.empty_cache()
    host = ids.cpu()
    dist.broadcast(host, 0)
    ids.copy_(host)
    params = model.init(0, mesh=mesh, placements=bundle.param_placements)
    cache = bundle.init_cache()
    resident = {k: x.numel() * x.element_size() for k, x in cache.items()
                if k != "cur"}
    seen = []
    decode = model.decode_step

    def recorded(p, c, t):
        out = decode(p, c, t)
        seen.append(out[0])
        return out
    model.decode_step = recorded
    worst, picks, finite = 0.0, [], True
    coll = None
    for t in range(steps):
        if t == DECODE_TP_PROMPT:
            torch.cuda.synchronize()
            coll = fsdp.reset_collective_stats()
            t0 = time.perf_counter()
        nxt, cache = bundle.step_fn(params, cache, ids[:, t])
        logits = seen.pop().float()
        finite &= bool(torch.isfinite(logits[:, :v]).all())
        if rank == 0:
            want = rep[t][:, :v]
            got = logits[:, :v]
            if dtype == torch.float32:
                err = float(((got - want).abs() - DECODE_TP_F32["rtol"]
                             * want.abs()).max())
                worst = max(worst, err)
            else:
                worst = max(worst, float((got - want).norm()
                                         / want.norm()))
            picks.append(bool(torch.equal(nxt.long(),
                                          torch.argmax(rep[t], -1))))
    torch.cuda.synchronize()
    tp_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TP_GEN
    out = {"layout": cfg.plan.decode_kv_shard, "dtype": str(dtype),
           "ms_per_token": tp_ms, "replicated_ms_per_token": rep_ms,
           "collectives_per_token": coll["calls"] / DECODE_TP_GEN,
           "collective_bytes_per_token": {
               k: x / DECODE_TP_GEN for k, x in coll["bytes_by_op"].items()},
           "collective_seconds_per_token": coll["seconds"] / DECODE_TP_GEN,
           "cache_bytes": sum(resident.values()),
           "cache_bytes_by_leaf": resident,
           "cache_bytes_placed": bundle.cache_bytes(),
           "finite": finite, "steps": steps}
    if rank == 0:
        out.update(worst=worst, rep_cache_bytes=rep_cache_bytes,
                   ids_equal=sum(picks), ids=len(picks))
    del params, cache, rep, seen
    torch.cuda.empty_cache()
    return out


def decode_tp_runs(torch, arch, mesh):
    """decode_tp's runs in a train_tp world: ``arch`` at full width cut
    to TRAIN_TP_LAYERS layers, each of DECODE_TP_LAYOUTS[arch] (None: the
    registered plan's layout), in bf16 and f32."""
    import dataclasses
    t0 = time.perf_counter()
    runs = {}
    for layout in DECODE_TP_LAYOUTS.get(arch, ()):
        cfg = dataclasses.replace(get_cfg(arch), num_layers=TRAIN_TP_LAYERS)
        if layout is not None:
            cfg = dataclasses.replace(cfg, plan=dataclasses.replace(
                cfg.plan, decode_kv_shard=layout))
        for dname in ("bfloat16", "float32"):
            runs[f"{arch}/{cfg.plan.decode_kv_shard}/{dname}"] = \
                decode_tp_run(torch, cfg, mesh, getattr(torch, dname))
    return {"runs": runs, "seconds": time.perf_counter() - t0}


def decode_tp_check(worlds):
    """decode_tp's gates over every rank's runs: the logits finite; rank
    0's against the replicated run's at every step (f32: allclose at
    DECODE_TP_F32, and every next id equal; bf16: DECODE_TP_BF16_REL
    norm-relative); each rank's resident cache its ``cache_pspecs``
    shard's bytes (a split K/V, SSM or conv leaf half the replicated
    one's).  Returns the failures."""
    failed = []
    for world in worlds:
        for r in world:
            for key, run in r["decode"]["runs"].items():
                ok = run["finite"] and \
                    run["cache_bytes"] == run["cache_bytes_placed"]
                if r["rank"] == 0:
                    f32 = run["dtype"] == "torch.float32"
                    ok = ok and run["worst"] <= (
                        DECODE_TP_F32["atol"] if f32 else DECODE_TP_BF16_REL)
                    ok = ok and (not f32 or run["ids_equal"] == run["ids"])
                    ok = ok and run["cache_bytes"] < run["rep_cache_bytes"]
                if not ok:
                    failed.append((r["rank"], key, {
                        k: run.get(k) for k in (
                            "finite", "worst", "ids_equal", "ids",
                            "cache_bytes", "cache_bytes_placed",
                            "rep_cache_bytes")}))
    return failed


def tp_local_heads(cfg, m):
    """(query heads, kv heads) of an attention call, or (heads, state) of
    a scan call, that rank 0 of a ``model`` of ``m`` makes."""
    if cfg.family == "ssm":
        return cfg.ssm_n_heads // m, cfg.ssm_state
    from repro_torch.models.transformer import rank_heads
    heads = rank_heads(cfg, m, 0)[1]
    return heads.q, heads.kv if heads.kv_idx is None else heads.q


def phase_train_tp(torch):
    """Tensor-parallel training on the card: a world of two tp_worker
    ranks for each of TRAIN_TP_ARCHS, both worlds at once (four processes
    sharing the card over gloo; their steps are gloo-bound, the card
    mostly idle), then, the card to itself, the kernels at the ranks'
    shapes against their plain versions and the forward products' time at
    a rank's widths.  Fails unless, for each arch and dtype, every loss is
    finite; the losses, grad norms and every leaf (f32 also each
    parameter's change) meet one process's replicated step (bf16 2e-2,
    f32 1e-4); each rank's resident bytes are its shards' by placement;
    every flash_attention / ssd_scan call and backward ran at the rank's
    local head count, as many as the plan's launches; the kernels at
    those shapes meet their plain versions; each rank's matmul FLOPs are
    at most TRAIN_TP_FLOP_RATIO of the replicated step's on the same
    rows.  Then it gates train_fsdp (b) (fsdp_run, in TRAIN_FSDP_ARCH's
    world) and decode_tp (decode_tp_check).  Returns the launches of the
    kernels over the two tensor-parallel steps (each world's rank 0)."""
    import dataclasses
    import tempfile
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the workers open contexts of their own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
        dirs = [os.path.join(d, str(i)) for i in range(len(TRAIN_TP_ARCHS))]
        for sub in dirs:
            os.makedirs(sub)
        t0 = time.perf_counter()
        worlds = spawn_workers("--tp-worker", list(zip(dirs, TRAIN_TP_ARCHS)),
                               TP_WORKER_TIMEOUT_S)
        workers_s = time.perf_counter() - t0
    m = TRAIN_TP_MESH[1]
    recs = [r for world in worlds for r in world]
    runs0 = {k: v for world in worlds for k, v in world[0]["runs"].items()}
    for key, run in runs0.items():         # the card to this process
        arch, dname = key.split("/")
        cfg = dataclasses.replace(get_cfg(arch), num_layers=TRAIN_TP_LAYERS)
        run["kernel_checks"] = tp_kernel_checks(torch, cfg, dname, m)
        run["products"] = tp_product_ms(torch, cfg, getattr(torch, dname), m)
        torch.cuda.empty_cache()
    failed = []
    for r in recs:
        for key, run in r["runs"].items():
            dname = key.split("/")[1]
            cfg = get_cfg(run["arch"])
            tol = TRAIN_FSDP_F32_REL if dname == "float32" else \
                TRAIN_FSDP_REL
            heads = tp_local_heads(cfg, m)
            want = run["launches_expected"]
            fwd = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
            bwd = fwd + "_bwd"
            shapes_ok = all(
                (q[2], kb[-1] if cfg.family == "ssm" else kb[2]) == heads
                for name in (fwd, bwd)
                for q, kb in run["kernel_calls"][name])
            counts_ok = len(run["kernel_calls"][fwd]) == want[fwd] and \
                len(run["kernel_calls"][bwd]) == (
                    want["ssd_scan_bwd"] if cfg.family == "ssm"
                    else want["flash_bwd_dq"]) and \
                run["launches"] == want
            ok = run["resident_bytes"] == run["placed_bytes"] and \
                all(np.isfinite(run["losses"])) and shapes_ok and \
                counts_ok and run["flop_ratio"] <= TRAIN_TP_FLOP_RATIO and \
                max(run["loss_rel"], run["grad_norm_rel"],
                    run["worst_leaf_rel"]) <= tol
            if dname == "float32":
                ok = ok and run["worst_change_rel"] <= tol
            if not ok:
                failed.append((r["rank"], key, {k: run[k] for k in (
                    "loss_rel", "grad_norm_rel", "worst_leaves",
                    "worst_change_rel", "worst_change_leaf",
                    "resident_bytes", "placed_bytes", "flop_ratio",
                    "launches", "launches_expected")},
                    {"shapes_ok": shapes_ok, "counts_ok": counts_ok,
                     "heads": heads}))
    emit({"phase": "train_tp", "archs": list(TRAIN_TP_ARCHS),
          "layers": TRAIN_TP_LAYERS,
          "reduced": f"depth cut to {TRAIN_TP_LAYERS} layers (full "
                     "width): two ranks an arch on one card over gloo, "
                     "whose CUDA tensors go through host memory (no "
                     "deployment's wire); the two archs' worlds run at "
                     "once",
          "mesh": {"data": TRAIN_TP_MESH[0], "model": TRAIN_TP_MESH[1]},
          "batch_x_seq": list(TRAIN_TP_SHAPE),
          "warm_steps": list(TRAIN_FSDP_WARM_IDS),
          "steps": list(TRAIN_FSDP_STEP_IDS), "workers_s": workers_s,
          "route": "torch.distributed on CUDA tensors over gloo",
          "ranks": [{**{k: v for k, v in r.items()
                        if k not in ("decode", "fsdp_runs")},
                     "runs": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "kernel_calls"}
                              for k, v in r["runs"].items()},
                     "kernel_call_shapes": {
                         k: sorted({json.dumps(c) for name, cs in
                                    v["kernel_calls"].items() for c in cs})
                         for k, v in r["runs"].items()}}
                    for r in recs]})
    emit({"phase": "train_tp", "part": "summary", **{
        key: {"ms_per_step": run["step"]["ms"],
              "device_ms": run["step"]["device_ms"],
              "gemm_device_ms": run["step"]["gemm_device_ms"],
              "replicated_ms": run["replicated_step"]["ms"],
              "replicated_device_ms": run["replicated_step"]["device_ms"],
              "replicated_gemm_device_ms":
                  run["replicated_step"]["gemm_device_ms"],
              "products": run["products"],
              "flop_ratio": run["flop_ratio"],
              "seconds": run["seconds"],
              "collectives_per_step": run["collectives"],
              "worst_leaf_rel": run["worst_leaf_rel"]}
        for key, run in runs0.items()},
        "seconds": time.perf_counter() - t_phase})
    if failed:
        raise RuntimeError(f"train_tp: {failed}")
    # train_fsdp (b), from TRAIN_FSDP_ARCH's world: every leaf, the loss
    # and the grad norm against the replicated step (bf16 2e-2, f32 1e-4
    # and each parameter's change), resident bytes those by placement
    fsdp_ranks = [{"rank": r["rank"], "backend": r["backend"],
                   "mesh": {"data": r["world"], "model": 1},
                   "runs": r["fsdp_runs"]} for r in recs if "fsdp_runs" in r]
    for r in fsdp_ranks:
        for dname, run in r["runs"].items():
            tol = TRAIN_FSDP_F32_REL if dname == "float32" else \
                TRAIN_FSDP_REL
            ok = run["resident_bytes"] == run["placed_bytes"] and \
                all(np.isfinite(run["losses"])) and \
                max(run["loss_rel"], run["grad_norm_rel"],
                    run["worst_leaf_rel"]) <= tol
            if dname == "float32":
                ok = ok and run["worst_change_rel"] <= tol
            if not ok:
                failed.append((r["rank"], dname, {k: run[k] for k in (
                    "loss_rel", "grad_norm_rel", "worst_leaves",
                    "worst_change_rel", "worst_change_leaf",
                    "resident_bytes", "placed_bytes")}))
    emit({"phase": "train_fsdp", "part": "two_ranks",
          "arch": TRAIN_FSDP_ARCH, "layers": TRAIN_TP_LAYERS,
          "reduced": f"depth cut to {TRAIN_TP_LAYERS} layers: two ranks on "
                     "one card over gloo, whose CUDA tensors go through "
                     "host memory (no deployment's wire); in train_tp's "
                     f"{TRAIN_FSDP_ARCH} world, from its warm state; "
                     f"{len(TRAIN_FSDP_B_STEP_IDS)} of its "
                     f"{len(TRAIN_FSDP_STEP_IDS)} steps (the smoke's run "
                     "time, ROADMAP 19)",
          "batch_x_seq": list(TRAIN_TP_SHAPE),
          "warm_steps": list(TRAIN_FSDP_WARM_IDS),
          "steps": list(TRAIN_FSDP_B_STEP_IDS),
          "route": "torch.distributed on CUDA tensors over gloo",
          "ranks": fsdp_ranks,
          "seconds": sum(run["seconds"]
                         for run in fsdp_ranks[0]["runs"].values())})
    if failed:
        raise RuntimeError(f"train_fsdp: two ranks: {failed}")
    decode_failed = decode_tp_check(worlds)
    emit({"phase": "decode_tp",
          "reduced": f"depth cut to {TRAIN_TP_LAYERS} layers (full "
                     "width), in train_tp's worlds: two ranks on one card "
                     "over gloo, so the ranks time-slice the card and no "
                     "device time is a rank's own",
          "rows_x_positions": [DECODE_TP_ROWS, DECODE_TP_POSITIONS],
          "prompt": DECODE_TP_PROMPT, "decoded": DECODE_TP_GEN,
          "route": "torch.distributed on CUDA tensors over gloo",
          "backends": sorted({r["backend"] for w in worlds for r in w}),
          "ranks": [{"rank": r["rank"], **r["decode"]}
                    for w in worlds for r in w],
          "seconds": max(r["decode"]["seconds"] for w in worlds
                         for r in w)})
    if decode_failed:
        raise RuntimeError(f"decode_tp: {decode_failed}")
    out = {}
    for run in runs0.values():
        for k, v in run["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


HOST_GROUP_TIMEOUT_S = 600       # each host group, start to exit
PROFILE_LOCK_ENV = "CHIP_SMOKE_PROFILE_LOCK"   # profile_calls' turn file


def host_group(i):
    """--host-group ``i``: the ``i``-th group of the host-bound phases, in
    order, in a process of its own (started by start_host_groups); each
    phase's record on stdout."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if i == 0:
        phase_reserve(torch, phase_engine(torch))
    elif i == 1:
        phase_mesh(torch)
        phase_service(torch)
    elif i == 2:
        phase_bidding(torch)
        phase_fr_latency(torch)
        phase_e8(torch)
        phase_cpu_vs_gpu(torch)
    else:
        phase_sweep(torch)
        phase_tier1_bench(torch)
        phase_twin(torch)
    return 0


def start_host_groups(n=4):
    """The host-bound phases (engine to e8: their ticks keep the card busy
    a tenth of the time or less) in ``n`` processes of this script, one
    per group of host_group, started beside the build and joined by
    join_host_groups before the first timed kernel; each one's output goes
    to a file; killed at exit if still running."""
    import atexit
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_host_")
    # one profiler window at a time across the groups
    env = dict(os.environ, **{PROFILE_LOCK_ENV: os.path.join(d, "profile")})
    runs = []
    for i in range(n):
        out = os.path.join(d, f"group{i}.log")
        with open(out, "w") as f:
            runs.append((i, out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--host-group",
                 str(i)], stdout=f, stderr=subprocess.STDOUT, text=True,
                env=env)))

    def stop():
        for _, _, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return {"runs": runs, "t0": time.perf_counter(), "stop": stop}


def join_host_groups(hosts):
    """Waits for the host groups and prints their records, group by group
    (other lines to stderr); fails if a group exited nonzero or outlived
    HOST_GROUP_TIMEOUT_S.  Returns the records by phase."""
    recs, groups = {}, []
    t_wait = time.perf_counter()
    try:
        for i, out, p in hosts["runs"]:
            left = HOST_GROUP_TIMEOUT_S - (time.perf_counter() - hosts["t0"])
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            with open(out) as f:
                lines = f.read().splitlines()
            phases = []
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    rec = None
                if isinstance(rec, dict) and "phase" in rec:
                    print(line, flush=True)
                    recs[rec["phase"]] = rec
                    phases.append((rec["phase"], rec["t_s"]))
                else:
                    print(line, file=sys.stderr, flush=True)
            if p.returncode != 0:
                raise RuntimeError(f"host group {i} exited {p.returncode}: "
                                   + "\n".join(lines[-60:]))
            groups.append({"phases": [k for k, _ in phases],
                           "seconds": max(t for _, t in phases)})
    finally:
        hosts["stop"]()
    emit({"phase": "host_groups", "groups": groups,
          "wall_s": time.perf_counter() - hosts["t0"],
          "waited_s": time.perf_counter() - t_wait})
    return recs


def start_dryruns():
    """The dry run of DRYRUN_CELLS, each in a CPU process of its own
    (python -m repro_torch.launch.dryrun --mesh single), started now and
    read by phase_dryrun; killed at exit if still running."""
    import atexit
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(d, f"{arch}_{shape}.json")
        runs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             "single", "--arch", arch, "--shape", shape, "--out", out],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))

    def stop():
        for *_, p in runs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    atexit.register(stop)
    return {"runs": runs, "t0": time.perf_counter(), "stop": stop}


def phase_dryrun(dryruns):
    """The dry-run processes' records: fails unless each exited 0 with
    its cell's status ok."""
    recs = []
    try:
        for arch, shape, out, p in dryruns["runs"]:
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - dryruns["t0"])
            text, _ = p.communicate(timeout=max(left, 1.0))
            if p.returncode != 0:
                raise RuntimeError(f"dryrun {arch} x {shape}: exit "
                                   f"{p.returncode}: {text[-3000:]}")
            with open(out) as f:
                rec = [r for r in json.load(f) if r["status"] != "skip"]
            if len(rec) != 1 or rec[0]["status"] != "ok":
                raise RuntimeError(f"dryrun {arch} x {shape}: {rec}")
            recs.append(rec[0])
    finally:
        dryruns["stop"]()
    emit({"phase": "dryrun", "mesh": "single (16 x 16, a fake world of "
                                     "256 ranks, meta tensors)",
          "wall_s": time.perf_counter() - dryruns["t0"], "cells": recs})


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--host-group"]:
        return host_group(int(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    whole = not {"--flash-only", "--ssd-only",
                 "--train-only"} & set(sys.argv[1:])
    if whole:
        # on the host's other cores beside the build: the host-bound
        # phases, read before the first timed kernel
        hosts = start_host_groups()
    build = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    if "--flash-only" in sys.argv[1:]:
        # the build and flash_attention's kernel phase alone, for work on
        # that kernel; prints no result line
        phase_flash_kernel(torch)
        return 0
    if "--ssd-only" in sys.argv[1:]:
        # the build and ssd_scan's kernel phase alone; no result line
        phase_ssd_kernel(torch)
        return 0
    if "--train-only" in sys.argv[1:]:
        # the build, the backward kernels' phases and the three train
        # phases alone; no result line
        phase_flash_bwd(torch)
        phase_train_dp(torch, phase_train(torch))
        phase_ssd_bwd(torch)
        phase_train_fsdp(torch, phase_train_ssm(torch, "train_ssm",
                                                "mamba2-1.3b"))
        phase_train_tp(torch)
        phase_train_ssm(torch, "train_hybrid", "zamba2-2.7b")
        phase_train_cuts(torch)
        phase_train_families(torch)
        return 0
    host = join_host_groups(hosts)
    pid_rec = phase_kernel(torch)
    flash_rec = phase_flash_kernel(torch)
    ssd_rec = phase_ssd_kernel(torch)
    phase_kernel_long(torch, flash_rec, ssd_rec)
    pid_rec["launches"] = phase_tier1(torch)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the long shapes' runs, each on the weights of its arch's phases,
    # printed as one line a phase once its last part has run
    long = {"prefill_32k": [], "long_500k": [], "decode_32k": []}
    qwen2 = get_cfg("qwen2-1.5b")
    dense = {"flash_attention": qwen2.num_layers}
    rec, params = phase_prefill(torch, "prefill", qwen2, dense)
    flash_rec["launches"] = rec["launches"]["flash_attention"]
    phase_decode_vs_forward(torch, "decode_vs_forward", qwen2, params, 64,
                            dense)
    long["prefill_32k"].append(prefill_32k_run(torch, qwen2, params, dense))
    long["decode_32k"].append(part(decode_32k(torch, qwen2, params)))
    del params
    free()
    phase_serve(torch, "qwen2-1.5b")
    free()
    mamba2 = get_cfg("mamba2-1.3b")
    ssm = {"ssd_scan": mamba2.num_layers}
    rec, params = phase_prefill(torch, "prefill_ssm", mamba2, ssm)
    ssd_rec["launches"] = rec["launches"]["ssd_scan"]
    phase_decode_vs_forward(torch, "decode_vs_forward_ssm", mamba2, params,
                            256, ssm, steps=DECODE_SSM_STEPS)
    long["prefill_32k"].append(prefill_32k_run(torch, mamba2, params, ssm))
    long["long_500k"].append(long_500k_run(torch, mamba2, params, ssm))
    del params
    free()
    phase_serve(torch, "mamba2-1.3b")
    free()
    zamba2 = get_cfg("zamba2-2.7b")
    hybrid = {"ssd_scan": zamba2.num_layers,
              "flash_attention": zamba2.num_layers // zamba2.hybrid_period}
    _, params = phase_prefill(torch, "prefill_hybrid", zamba2, hybrid)
    phase_decode_vs_forward(torch, "decode_vs_forward_hybrid", zamba2,
                            params, 256, hybrid, steps=DECODE_SSM_STEPS)
    long["prefill_32k"].append(prefill_32k_run(torch, zamba2, params,
                                               hybrid))
    long["long_500k"].append(long_500k_run(torch, zamba2, params, hybrid))
    del params
    free()
    phase_families(torch, flash_rec, free, long)
    phase_yi9b(torch, long, flash_rec)
    free()
    long_launches(long, flash_rec, ssd_rec)
    bwd_recs = phase_flash_bwd(torch)
    free()
    train = phase_train(torch)
    train_launches = train["launches"]
    free()
    dp_launches = phase_train_dp(torch, train)
    free()
    ssd_bwd_rec = phase_ssd_bwd(torch)
    free()
    # on the CPU beside the train phases, after the last kernel check
    # that counts CUPTI's events; read last
    dryruns = start_dryruns()
    ssm_rec = phase_train_ssm(torch, "train_ssm", "mamba2-1.3b")
    ssm = ssm_rec["launches"]
    free()
    fsdp_launches = phase_train_fsdp(torch, ssm_rec)
    free()
    tp_launches = phase_train_tp(torch)
    free()
    hybrid = phase_train_ssm(torch, "train_hybrid",
                             "zamba2-2.7b")["launches"]
    free()
    phase_train_cuts(torch)
    free()
    families = phase_train_families(torch)
    for rec in bwd_recs:
        rec["launches"] = train_launches[rec["name"]]
        rec["launches_train_dp"] = dp_launches[rec["name"]]
        rec["launches_train_hybrid"] = hybrid[rec["name"]]
    flash_rec["launches_train"] = train_launches["flash_attention"]
    flash_rec["launches_train_dp"] = dp_launches["flash_attention"]
    flash_rec["launches_train_hybrid"] = hybrid["flash_attention"]
    ssd_rec["launches_train_ssm"] = ssm["ssd_scan"]
    ssd_rec["launches_train_fsdp"] = fsdp_launches["ssd_scan"]
    ssd_rec["launches_train_hybrid"] = hybrid["ssd_scan"]
    ssd_bwd_rec["launches"] = ssm["ssd_scan_bwd"]
    ssd_bwd_rec["launches_train_fsdp"] = fsdp_launches["ssd_scan_bwd"]
    ssd_bwd_rec["launches_train_hybrid"] = hybrid["ssd_scan_bwd"]
    # the two tensor-parallel steps of train_tp, at each rank's heads
    for rec in bwd_recs:
        rec["launches_train_tp"] = tp_launches[rec["name"]]
    flash_rec["launches_train_tp"] = tp_launches["flash_attention"]
    ssd_rec["launches_train_tp"] = tp_launches["ssd_scan"]
    ssd_bwd_rec["launches_train_tp"] = tp_launches["ssd_scan_bwd"]
    # the MoE, VLM and enc-dec families' trainer runs
    for phase, got in families.items():
        for rec in (flash_rec, *bwd_recs):
            rec[f"launches_{phase}"] = got[rec["name"]]
    pid_rec["launches_e4"] = host["tier1_bench"]["pid_update_launches"]
    phase_dryrun(dryruns)
    emit({"phase": "run_time", "build_s": build,
          "total_s": time.perf_counter() - T_START})
    emit({"kernels": [pid_rec, flash_rec, ssd_rec, *bwd_recs, ssd_bwd_rec]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
