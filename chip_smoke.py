#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

run from the root of a checkout (it adds ``src`` to ``sys.path`` itself).
Phases, each printing one JSON line and raising on any failure:

  1. device   the card (nvidia-smi's name and power limit, on a line of its
              own), torch and CUDA versions; TF32 is switched off.
  2. build    nvcc builds the kernels from ``src/repro_torch/csrc``.
  3. flash_identity_probe
              B2's wgmma kernel on one tile with V the identity: O must be
              softmax(S) element by element.
     grs / flash_attention / flash_attention_f32 / pack / fused_round /
     ssm_scan
              each kernel against its plain PyTorch version on the card, at
              the main path's shape and at edge shapes: max abs error,
              kernel / plain / library times (each call after a 64 MB L2
              flush: CUDA events around each call, and device time under
              torch.profiler) and the card's bound for the same work.
              flash_attention (bf16, the wgmma kernel) also at the
              hymba-1.5b shapes (causal, window 1024 and full), with its
              build (registers, spills, shared memory);
              flash_attention_f32 is B2's float32 kernel (two designs:
              3xTF32 tensor cores, and (batch, head) pairs packed into
              blocks for Lq, Sk <= 64) at both hymba_f32 shapes, with the
              design each call launched. grs (B1) and
              fused_round's B6 also at a view one float into its storage
              and at rows longer than a cluster holds, with the device
              kernels one call runs (one), and the row geometry with the
              clusters the card keeps resident.
  4. denoiser the full-width ``paper-pixel-dit`` denoiser at PIXEL_DEPTH of
              its 24 layers (random weights from a seed; phases 4-6 use
              it): one forward through the flash kernel against the same
              forward through the naive attention.
     asd      ``asd_sample_batched`` (4 chains, theta 8, K 64) with the
              launch counts of both kernels during that run, then the
              sequential baseline on the same chains.
     reference
              the same sampler on a small denoiser, on the card and on the
              CPU with the same noise: counters equal, samples close.
     Both samplers (here and in every phase below) replay a captured CUDA
     graph of one round (one step), reading the positions on the host once
     per bound of rounds.
  5. serve    ``ContinuousASDEngine`` on the same denoiser, packed
              execution (6 requests on 4 slots, theta 8, K 64, budget 16,
              4 rounds a superstep), once with round_impl "packed" and once
              "fused" on the same per-request noise: launch counts of every
              kernel per round, equal counters and samples in the two runs;
              then one superstep of each round_impl profiled, and one of
              each (in buffer and in counter noise, and an unpacked one in
              counter noise) with host syncs made errors, eagerly and as a
              warm replay of an engine's graph.  On the card every engine
              superstep is a captured CUDA graph (``serving/programs.py``),
              here and in every phase below that serves.
     branched the same denoiser with B 2 draft branches (counter noise):
              ``asd_sample_batched`` (4 chains, theta 8, K 64) at B 1 and 2
              from one key, and one round from the same states (the
              branched advance never shorter), profiled warm at B 1 and 2
              (branched_profile); the engine (6 keyed
              requests, 4 slots, R 4) at budgets 32 (one window a slot:
              branches shed) and 64 (covering) in both round_impls, equal
              counters and sample bits between them, launches of every
              kernel per round; one superstep of each round with host
              syncs made errors; and B 1 asked for explicitly against the
              serve phase: the same bits, counters and launches.
     sampler_graphs
              the sampler's loop and the K-step baseline as replayed CUDA
              graphs (one round, one step) against the eager loops written
              out in this script, at pixel-dit (4 chains, theta 8, K 64) in
              buffer and counter noise at B 1 and 2 (the asd and branched
              phases' calls, and buffer B 2 here): sample and trajectory
              bits, counters, launches and rounds run equal, host reads at
              most the rounds, a warm replay with host syncs made errors;
              capture ms, walls, peak memory, and one profiled call of two
              configurations (idle share).  A planted fault, the first
              bound one round too long on the serve CLI's model (every
              proposal accepted, so that bound is the whole run), must fail
              the rounds gate.
     serve_graphs
              the superstep programs as graphs against their eager bodies
              in the same run: pixel-dit at SERVE_GRAPHS_DEPTH layers (6
              keyed requests, 4 slots, theta
              8, K 64, R 4, counter noise) at budgets 16 and 64, both
              round_impls, B 1 and 2, and with both auto ladders: one
              capture per key within the ladders' bound, capture ms, peak
              memory, wall, samples/s (at B 1 below budget 64 beside an
              eager engine serving the same requests: equal sample bits,
              counters, launches and keys); a warm replay against the
              eager body from the same states with host syncs made errors,
              and one profiled superstep of each (idle share); a planted
              fault (the fused tier baked into the graph as an int,
              replayed at another tier) must fail that gate.  Then the
              serve CLI's model the same way, the in-program sync packet
              and the admission programs (widths 1, 2, 4) against the eager
              versions kept here (serve_graphs_boundary), and
              ``serve.main`` with 8 profiled supersteps with graphs at R 1
              and R 4 and eagerly at R 1: round ms, samples/s, idle share,
              and the host ms of admission, launch, packet and harvest.
     sharded_serve
              the same denoiser behind ``ShardedASDEngine`` (2 shards of 2
              slots, budget 16 a shard, 6 keyed requests, counter noise,
              R 4), per-shard dispatch with packed rounds and fused
              dispatch (one captured graph a boundary, a side-stream
              branch a shard) with fused rounds: shards 1 equal to
              ``ContinuousASDEngine`` in bits, shards 2 equal to shards 1
              (4 slots, the covering 32) in bits, fused equal to
              per-shard (served, and every slot field after 2 boundaries,
              where a planted fused body that skips the last shard's
              write-back must fail), graph replays a warm boundary (1
              fused, 2 per shard) with host syncs made errors; warm round
              ms, samples/s, the idle share over 8 profiled boundaries,
              capture ms, peak memory, the fused boundary's busy ms
              against the shards' bodies one after another, and whether a
              model call's rows (and its parts') are the same bits at 36
              and 18 points.
     serve_reference
              the same engine on a small denoiser, on the card and on the
              CPU with the same noise, in both round_impls.
     branched_reference
              branched serving (B 3, counter noise, static and gain branch
              controllers) on the small denoiser, card against CPU from
              the same keys: counters, drafted points and branch counts
              equal, samples within 2e-3; a planted fault (branch 1 drawn
              with branch 2's salt) must exceed that.
     prng     the port's threefry (``core/prng.py``) on the card against the
              CPU: keys, splits, folds, bits and uniforms equal, normals
              within ``NORMAL_ULPS``, at paper-pixel-dit's event and at 1, 5
              and 4097 elements; one round's counter window (4 slots,
              theta 8) timed.
     serve_counter_memory
              paper-pixel-dit through the serve CLI's engine (counter
              noise) in counter and in buffer mode: 6 requests at K 64
              (round wall ms, one profiled round), then 4 requests admitted
              at K 1000 and 2 supersteps: peak device memory, counter mode
              at least 90 % of the buffers' bytes below buffer mode.
     cli_kernels
              B1 and B2 (bf16) against their plain versions at the serve
              CLI's shapes (GRS rows of 224 floats; attention over 36
              points of 16 tokens, 8 heads of 64), timed as in phase 3.
     serve_cli
              ``repro_torch.launch.serve.main`` at the CLI's defaults
              (paper-diffusion-policy at full width, 8 requests, 4 slots,
              theta 8, K 100) and each variant (the fused engine, packed
              rounds with budget 24 in both round_impls, aimd and
              accept-rate, R 4, the metrics endpoint, the trace, a
              profile with the device's idle share): launches of every
              kernel per round, finite samples.
     serve_cli_branched
              the same at --num-branches 2, at 4 with the gain branch
              controller, and at 2 with packed fused rounds, each profiled:
              samples/s, round ms, idle share, branch depth and waste
              beside the B 1 profiled run.
     sharded_serve_cli
              ``serve.main`` at 8 slots and 16 keyed requests, unsharded
              (unpacked, and packed fused rounds at R 2), at 2 shards
              round-robin, 2 shards with fused dispatch and packed fused
              rounds at R 2, and 4 shards, each with 8 profiled warm
              supersteps: sample bits, retired, depth, window and accept
              rate equal to the unsharded run with the same round flags;
              launches of every kernel per round, round ms, idle share.
     model_parallel
              serving model parallelism over a model group of two ranks
              sharing this card (``repro_torch.distributed.group.run_group``:
              gloo over pinned host copies, so every collective time is
              host-staged, not NVLink), the card's name and power limit on
              each line: the full-width pixel-dit (PIXEL_DEPTH layers) TP2
              and SP2 forwards of 16 points against the replicated forward
              on the card (relative L2 under MP_BF16_GATE, the ranks and a
              second call equal in bits, B2 once a layer at 8 local heads,
              each rank's resident weight bytes); a planted fault (rank 1
              keeps its own ``wo`` partial sum) the TP2 check must catch;
              the TP2 ``ShardedASDEngine`` at full width and MP_ENGINE_DEPTH
              layers (4 keyed requests, 4 slots, theta 8, K 64, packed
              fused rounds at budget 16),
              twice: every request retired, the same bits on both ranks and
              in both runs, launches per round the replicated engine's,
              warm round ms, the calibrated psum and all_to_all ms a round;
              the float32 engines (policy smoke TP2, and SP2 over two shards
              in fused dispatch with packed fused rounds, MoE smoke EP2 and
              EP2+SP2) against the replicated engine on the card:
              counters equal, samples within MP_F32_TOL, launches per round
              equal.  The ranks' supersteps are eager (a host-staged
              collective cannot be captured), so the host-sync-as-error
              checks of the captured phases do not apply.  Then the serve
              CLI's mesh over the batch axes (mesh_serve) on the same two
              ranks, each against its 1 x 1 run in this process: the
              pixel-dit ``ContinuousASDEngine`` at MP_ENGINE_DEPTH layers
              with ``state_sharding`` on 2x1 (unpacked, counter noise, 4
              slots, theta 8, K 64, RPS rounds a superstep, 6 keyed
              requests, served twice), ``asd_sample_batched`` over 4 of its
              chains on 2x1 (each rank its block of the chains' keys), and
              the float32 policy engine of policy_tp2 on 2x1x1: each
              request's sample equal in bits and its counters equal, half
              the slot-state bytes a rank, every warm superstep a replayed
              graph, B1 and B2 as often a round as 1 x 1, finite samples;
              the warm round ms by rank and at 1 x 1, the boundary gathers'
              seconds and share, peak memory by rank.  Then the LM
              trainer's meshes (mesh_train) on the same two ranks:
              tinyllama-1.1b at published widths and MESH_TRAIN_DEPTH of
              its 22 layers, batch 8 x 128, 3 steps, on 2x1 (data
              parallelism, ZeRO-1), 1x2 (TP on the attention and FFN
              leaves, the vocab leaves gathered at use) and 2x1 FSDP, each
              against the 1 x 1 trainer in this process from the same
              seed-0 params and batches: every loss within
              MESH_LOSS_GATE (relative), every leaf's step-1 gradient
              within MESH_BF16_GATE and its update over the run (final
              minus initial params) within MESH_UPDATE_GATE (relative L2),
              the ranks' losses and replicated leaves equal in bits, each
              rank's resident bytes of params and mu / nu exactly the
              layout's; the warm step, the seconds inside collectives and
              their share, peak memory by rank.
     serve_keys_reference
              the counter-noise engine on a small denoiser, on the card
              and on the CPU from the same keys (keyed and unkeyed
              requests, static and aimd): counters equal, samples within
              2e-3; a planted fault (one xi draw off by one step) must
              exceed that.
  6. hymba    the full-width ``hymba-1.5b`` LM (random weights from a seed):
              ``lm_prefill`` of 2 prompts of 4096 tokens into caches of
              4112, 16 greedy ``lm_decode_step`` calls, then ``lm_fwd`` on
              the 4112 tokens; the launch counts of B7 and B2 in each;
              decode logits against forward logits; warm times; one
              profiled prefill, decode step and mamba mixer.  The mixer
              scans in chunks of 1024 (B7 once a chunk a layer: 4 a layer
              in the prefill, 5 in the forward).
              Two planted decode faults (window ignored, SSM state one
              token stale): the gate must see the first.  The greedy decode
              again as one captured step (token and position on the card,
              the argmax written inside the graph) replayed 16 times: the
              eager decode's tokens and logit bits, ms a step, idle share
              (hymba_decode_graph).
     hymba_long_prefill
              ``lm_prefill`` of 1 x 32,768 tokens (A11's 32k prefill cell
              at batch 1): B7 32 times a layer, B2 once, finite logits,
              the peak above the weights, the first call's wall and a warm
              call.
     hymba_f32
              the same full-width run in float32 (B2's float32 kernel in
              its tensor-core design): decode against forward within a
              tight bound that both planted faults must exceed; warm
              prefill and forward times.
     hymba_reference
              the reduced hymba in float32 on the card and on the CPU with
              the same params: greedy tokens equal, logits close.
 6b. flash_attention_lm
              B2 (bf16) against its plain version at the lm-zoo prefill
              shapes (head dims 64, 128 and 256; gemma2's softcap 50 with
              window 4096 and full; llama-vision's 4096 x 6400 cross
              attention), timed as in phase 3, SDPA where no softcap is on.
     lm_weights, lm_arch, lm_profile
              for each of xlstm-125m (mLSTM and sLSTM blocks, plain
              PyTorch), tinyllama-1.1b, yi-6b, gemma2-9b, qwen2.5-14b
              (all 48 layers), llama-3.2-vision-11b (stub vision
              embeddings 2 x 6400) and musicgen-medium (stub frames) at
              full width: the parameter count, prefill of 2 x 4096 tokens
              (gemma2: 1 x 8192, twice its window; qwen3-moe-30b-a3b,
              every expert on the card, bf16 leaves drawn in bf16 in runs
              of 256 MiB: 1 x 4096; dbrx-132b the same at 8 of its 40
              layers, 27.3 B params), 16 greedy decode
              steps eagerly and as one captured step replayed (tokens and
              logit bits equal), the forward over prompt and generated
              positions; B2 once an attention layer in the prefill and
              the forward (xlstm: never), never in a decode step; decode
              against forward within the hymba bf16 gate (not
              llama-vision: the JAX package's xattn forward ropes, its
              prefill and step do not; nor the MoE archs: their prefill and
              forward drop (token, expert) pairs at their capacity, their
              decode steps none, and the counts are printed); warm ms
              (xlstm's prefill: its first call), peak memory, idle share,
              the prefill's and a decode step's bounds from the port's
              analytic model, one profiled prefill (xlstm: of 128
              positions; the MoE archs: with the device ms of their MoE
              steps by group, routing, gather, expert products and
              combine).  For the MoE archs also one MoE layer at the
              prefill's and a decode step's shape: two calls and a
              captured call equal in bits, warm ms, and the bounds of its
              expert products and of a decode step.
     xlstm_mixers
              one mLSTM and one sLSTM layer of xlstm-125m at the prefill's
              shape: event ms, device busy ms and idle share (the sLSTM
              loop profiled over 128 positions).
     lm_reference
              each arch's reduced config in float32 on the card and on
              the CPU with the same params (greedy tokens equal, logits
              within 2e-4), reduced gemma2 at head dim 256 in bf16 (B2's
              four-chunk kernel in a model; a planted ignored window must
              exceed the gate), and reduced xlstm in bf16: decode logits
              from ``lm_compute_params`` (cast leaf by leaf by path) equal
              in bits to those of the uncast params.  Reduced
              qwen3-moe-30b-a3b (E 4, top 2: nothing drops) is one of
              them, decode against forward included.
     moe_denoiser
              qwen3-moe-a3b-smoke (random weights): ``asd_sample_batched``
              in buffer noise mode (K 64, theta 8, 8 chains) on the card
              against the CPU from the same inputs (counters equal,
              samples within 2e-3); a point's output the same bits alone,
              in 18 and in 36 (the denoiser runs in blocks of 16 points;
              an expert product unblocked at 1 and 18 points' rows
              against 36 is printed beside it); one MoE layer twice and
              captured, equal bits;
              ``serve.main`` at the model at its defaults and packed: B1
              once a round, B2's float32 kernel once a layer a block.
     ssm_scan_backward
              B7's backward kernel (csrc/ssm_scan_bwd.cu) at hymba-1.5b's
              training shape (8, 128, 25,600): under autograd h, da and db
              against autograd through the plain loop (1e-5 of each
              tensor's scale), one launch and one device kernel a backward
              call; da and db equal in bits to the plain reverse loop there,
              at edge shapes and for a gradient that is not contiguous; the
              kernel timed as in phase 3 with its bound and its build's
              registers and spills; B7's forward at the same shape
              (ssm_scan_training_shape).
     lm_train ``python -m repro_torch.launch.train --scale full --steps 12
              --batch 8 --seq 128`` in process for tinyllama-1.1b (the
              CLI's default), xlstm-125m (--seq 32) and hymba-1.5b (B7
              forward, recomputed and backward): losses finite, ms a step
              without the host's MarkovLM time, tokens/s, peak memory,
              launches; a second xlstm call resumed from the first's
              step-10 checkpoint equal to it within 1e-5.
     lm_train_moe
              qwen3-moe-30b-a3b at published widths and 4 of its 48 layers
              (3.11 B params, every expert on the card) trained 10 steps of
              8 x 128 through the CLI's build and loop.run: losses and
              moe_aux finite, ms a step, tokens/s, peak memory, the step's
              bound from the port's analytic model, one more warm step
              profiled (lm_train_moe_profile: device ms by group, idle
              share); then the CLI at --scale smoke for qwen3-moe-30b-a3b
              and dbrx-132b.
     lm_train_profile
              one warm hymba-1.5b training step at that shape under
              torch.profiler (B7 forward, B7 backward, matmuls, other,
              idle share), and the upstream gradient a full-width mamba
              mixer hands B7's backward (mamba_scan_gradient: contiguous).
     lm_train_reference
              one lm_loss gradient of every arch's reduced config in
              float32, card against CPU: loss within 1e-5, each leaf's
              gradient within 1e-4 of its scale, moe_aux within 1e-5 (the
              MoE archs, and reduced qwen3-moe once more at
              capacity_factor 1.0, where pairs drop and no positive tie
              sits at the capacity's edge).
     dryrun   ``repro_torch.launch.dryrun.run_cell`` into a temporary
              directory for tinyllama-1.1b's train_4k, prefill_32k and
              decode_32k, hymba-1.5b's train_4k and long_500k, the policy's
              and pixel-dit's (memopt) ASD cells and dbrx-132b's
              prefill_32k: every cell reckoned to fit measured ok, no
              fraction of its bound above 1.05, dbrx too large with nothing
              allocated, B2 once an attention layer a prefill, B7's forward
              and backward in hymba's step, B1 once and B2 twice a layer an
              ASD round; tinyllama's train_4k under the fsdp variant refused
              naming ROADMAP A13.  Then, against their plain versions and
              timed as in phase 3 (dryrun_kernels): B2 at the 32k prefill's
              (1, 32768, 32, 64) causal (its plain version a head at a
              time), GRS at the ASD rounds' (4096, 224) and (512, 196608)
              rows and B2 at their eager head and verification calls, B7
              forward and backward at the training step's chunk (1, 1024,
              25600).
  7. train_full_width
              the full-width ``paper-pixel-dit`` (PIXEL_DEPTH layers)
              trained through
              ``repro_torch.training.loop.run`` (5 steps of sl_denoiser_loss
              and AdamW on BlobImages of its shape, bf16, remat, naive
              attention, checkpoints every 3 steps under build/): losses,
              warm ms a step by CUDA events, TFLOP/s, peak memory; every
              leaf's step-2 gradient finite and nonzero; a run resumed from
              the step-3 checkpoint within 1e-5 of the unbroken one; the
              last checkpoint equal to the live state bit for bit.
     standin_kernels
              B1 and B2's float32 kernel against their plain versions at the
              shapes the stand-ins' verification calls give them (head dims
              32 and 24; rows of 32 and 1536 floats), timed as in phase 3.
     standin_policy, standin_pixel
              the JAX benchmarks' policy and pixel stand-ins trained on the
              card to their recipe (400 and 250 steps), then sampled
              sequentially and with ASD (policy: K 100, 8 chains,
              conditioned, theta 8 and 24 and the eager head, and table3's
              success rates over 96 episodes; pixel: K 200, 16 chains,
              theta 8): depth, accept rate, K / depth, wall seconds, and the
              launches of B1 and B2's float32 kernel (its packed design)
              per round.
     standin_branched
              the trained pixel stand-in at B 1, 2 and 4 (K 200, 16 chains,
              theta 8, one key): depth, K / depth, branch depth, waste,
              wall seconds; one round from the same states never advances
              less at B > 1, nor is the mean depth above B 1's.
     standin_reference
              the trained policy on the card and on the CPU with the same
              injected noise: counters equal, samples within 2e-5 of their
              scale; the model's output rounded to bf16 must fail that.
     branched_kernels
              B1-B6 against their plain versions at the branched rounds'
              shapes (rows of S x B x theta), timed as in phase 3; B3 and
              index_select timed again under a 256 MB flush
              (b3_index_select), B3's bound from the rows its indices
              read.
  8. kernels  one JSON line with every ported kernel's numbers, and rows
              at the branched shapes, the lm-zoo shapes, B7's training
              shape, forward and backward, and the dry run's shapes
              (``at``) with their launches there.
  9. the last line: {"ok": true, "device": {...}}.

It exits non-zero, printing no result, where there is no CUDA device or
no ``src/repro_torch`` beside it.  No JAX is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): bf16 tensor cores, float32 without
# tensor cores, TF32 tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12

K, THETA, CHAINS = 64, 8, 4
# the pixel-dit cell's depth (of the published 24 layers) in the sampler
# and serving phases: the script's whole run stays inside its time limit
PIXEL_DEPTH = 12
SEED = 0
OUT_SCALE = 1e-2  # out_proj = normal * OUT_SCALE / sqrt(d_model)
# the serve cell (pixel-dit-serve): slots, budget (half the covering 32),
# rounds per superstep, requests
SLOTS, BUDGET, RPS, REQUESTS = 4, 16, 4, 6
# the hymba cell (hymba-prefill): prompts, prompt length, greedy decode steps
HYMBA_BATCH, HYMBA_PROMPT, HYMBA_DECODE = 2, 4096, 16
# hymba-1.5b's parameter count (jax.eval_shape of the JAX package's lm_init)
HYMBA_PARAMS = 1_403_345_600
# the mamba mixer's scan chunk (mamba_fwd's default, the JAX package's):
# B7 runs ceil(L / MAMBA_CHUNK) times a layer in a prefill or a forward
MAMBA_CHUNK = 1024
# hymba_long_prefill: one prompt of A11's 32k cells through lm_prefill
HYMBA_LONG_PROMPT = 32768
# decode logits against forward logits, relative L2, set between the clean
# run and the planted faults (NVIDIA H100 80GB HBM3, 700 W): bf16, the main
# path, reads 0.0524 clean and 0.1015 with the window ignored in decode (a
# one-token-stale SSM state, 0.0539, hides under bf16 rounding); float32
# (hymba_f32) reads 1.05e-5 clean, 0.0081 stale and 0.085 window ignored
HYMBA_BF16_GATE, HYMBA_F32_GATE = 0.075, 1e-3
# the planted faults each gate must see
HYMBA_BF16_SEES = ("decode ignores the window",)
HYMBA_F32_SEES = ("decode ignores the window", "SSM state one token stale")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: ``reps`` calls launched back to back
    between two CUDA events, after ``warmup`` calls.  Where a call's device
    work is shorter than the host's time to launch it (a kernel of a few
    microseconds behind a Python wrapper), this measures the launch rate;
    ``device_ms`` gives the card's own time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# L2 flush between timed kernel calls: one in-place pass over 64 MB (more
# than the card's 50 MB L2), so each call reads its inputs from device
# memory as a caller that just ran other work would.  Its kernel is told
# apart from the timed ones by name.  A caller whose inputs are about the
# L2's size passes a larger flush (``flush_bytes``).
_FLUSH_BYTES = 64 << 20
_FLUSH_KERNEL = "bitwise_not"
_flush_bufs = {}


def _flush_l2(nbytes: int = _FLUSH_BYTES):
    import torch

    if nbytes not in _flush_bufs:
        _flush_bufs[nbytes] = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    _flush_bufs[nbytes].bitwise_not_()


def cold_ms(fn, reps: int = 10, flush_bytes: int = _FLUSH_BYTES) -> float:
    """Milliseconds per call of ``fn`` with a cold L2: CUDA events around
    each call, the flush outside them.  A sleep kernel first fills the
    stream so the host queues the calls ahead of the card; where the host
    still falls behind (a plain version of many small kernels) the time
    includes the card waiting for launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(20_000_000)  # cycles: time for the host to queue every call
    for start, end in events:
        _flush_l2(flush_bytes)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


# the port's kernels, by the names the profiler gives them
_PORT_KERNELS = ("grs_kernel", "flash_fwd", "gather_rows_kernel", "scatter_rows_kernel",
                 "fused_gather_kernel", "fvc_kernel", "ssm_scan_kernel", "ssm_scan_bwd_kernel")


def device_ms(fn, reps: int = 10, wrapper=None, flush_bytes: int = _FLUSH_BYTES):
    """(device milliseconds per call of ``fn`` with a cold L2, launch records
    the profiler lost).  Each kernel counts as the mean time of its recorded
    launches times its launches a call, and those launches are counted: the
    port's kernel by ``wrapper``'s ``launches`` counter over one call, every
    other kernel from that call run alone under torch.profiler.  The times
    come from ``reps`` calls under torch.profiler, each after an L2 flush
    (host gaps and the flush do not count).  The profiler now and then loses
    records (B2's float32 kernel once read 2/3 of its event time, SDPA at
    the full causal shape once read nothing): the second number counts the
    launches of the ``reps`` calls it did not record.  (None, 0) where three
    traces in a row recorded no kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    before = wrapper.launches if wrapper is not None else 0

    def one():
        _flush_l2(flush_bytes)
        fn()

    _, one_call = _profiled(torch, one)
    counted = wrapper.launches - before if wrapper is not None else None
    one_call = {k: (ms, n) for k, ms, n in one_call if _FLUSH_KERNEL not in k}

    def run():
        for _ in range(reps):
            _flush_l2(flush_bytes)
            fn()

    for _ in range(3):
        _, traced = _profiled(torch, run)
        traced = {k: (ms, n) for k, ms, n in traced if _FLUSH_KERNEL not in k}
        if traced:
            break
    else:
        return None, 0
    port = [k for k in {**one_call, **traced} if any(p in k for p in _PORT_KERNELS)]
    if wrapper is not None and len(port) > 1:
        fail(f"device_ms: one call ran more than one of the port's kernels: {port}")
    total, lost = 0.0, 0
    for k in {**one_call, **traced}:
        if k in port and wrapper is not None:
            per_call = counted
        elif k in one_call:
            per_call = one_call[k][1]
        else:  # in no record of the call run alone
            per_call = traced[k][1] / reps
        ms, n = traced.get(k, one_call.get(k))
        total += ms / n * per_call
        lost += max(0, round(per_call * reps) - traced.get(k, (0, 0))[1])
    return total, lost


def kernel_times(kernel, plain, library=None, reps: int = 20, wrapper=None,
                 flush_bytes: int = _FLUSH_BYTES) -> dict:
    """ms / device_ms of the kernel's wrapper, its plain version and the
    library call (None where there is none), each on the same inputs and
    each call after an L2 flush of ``flush_bytes`` (cold-cache times).
    ``wrapper`` is the port's wrapper that ``kernel`` calls, whose counter
    counts its launches; ``*device_records_lost`` counts launches the
    profiler did not record."""
    out = {}
    for prefix, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[prefix + "ms"] = None if fn is None else cold_ms(fn, reps, flush_bytes)
        out[prefix + "device_ms"], out[prefix + "device_records_lost"] = (
            (None, 0) if fn is None else device_ms(fn, reps, wrapper if not prefix else None,
                                                    flush_bytes))
    return out


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def f32_attention_bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations", the term that bounds it) for float32
    attention: max(bytes / 3.35 TB/s, min(flops / 67 TFLOP/s, 3 flops / 495
    TFLOP/s)), the lesser of float32 FMAs and the three TF32 products of
    3xTF32 on the tensor cores."""
    t_fma, t_tc = flops / PEAK_F32, 3 * flops / PEAK_TF32
    t_ops, term = (t_tc, "operations (3xTF32)") if t_tc <= t_fma else (
        t_fma, "operations (float32 FMA)")
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", "bytes"
    return t_ops * 1e3, "operations", term


# ---------------------------------------------------------------- phase 3


def _offset_view(torch, t, offset):
    """t's values in a view ``offset`` floats into its storage (offset 1:
    every row pointer 4 bytes past a 16-byte boundary)."""
    base = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    base[offset:].copy_(t.reshape(-1))
    return base[offset:].view(t.shape)


def _captured_work(torch, fn, keep=None):
    """The device work one call of ``fn`` queues, as (kind, name) pairs:
    the nodes of a CUDA graph that captures the call (after a warm-up call
    on a side stream), read from the graph's DOT dump.  A KERNEL node's
    name is its kernel's; MEMSET and MEMCPY nodes are device work as well.
    No profiler takes part, so no record can be lost.  ``keep``, a path,
    keeps the dump there."""
    import re
    import shutil
    import warnings

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # dumped before it is instantiated
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    path = Path(keep) if keep else _fresh_dir("captured_work") / "graph.dot"
    with warnings.catch_warnings():  # debug_dump warns that it was called
        warnings.simplefilter("ignore", UserWarning)
        graph.debug_dump(str(path))
    graph.reset()
    torch.cuda.synchronize()
    dot = path.read_text()
    if not keep:
        shutil.rmtree(path.parent, ignore_errors=True)
    work = []
    # a node's definition starts its line ("graph_0_node_0"[style=...); an
    # edge's line names two nodes with "->" between them
    for body in re.findall(r'^"graph_\d+_node_\d+"\[(.*?)\];$', dot, re.S | re.M):
        kind = re.search(r'label="\{(\w+)', body)
        name = re.search(r"\{ID \| [^|]*\| ([^\\|}]+)", body)
        work.append((kind.group(1) if kind else body[:40],
                     name.group(1)[:100] if name and kind and kind.group(1) == "KERNEL"
                     else None))
    return work


def _row_geometry(rows, D):
    """The geometry B1 and B6 launch for ``rows`` rows of D floats: cluster
    size, floats and shared bytes a block, threads, blocks, and the
    clusters of it the card keeps resident."""
    from repro_torch.kernels.grs.ops import THREADS, max_active_clusters, row_geometry

    geo = row_geometry(D)
    return dict(geo._asdict(), threads=THREADS, blocks=rows * geo.cluster,
                max_active_clusters=max_active_clusters(geo))


def _grs_inputs(torch, dev, R, D, seed, zero_rows=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(R, generator=g, device=dev)
    xi = torch.randn(R, D, generator=g, device=dev)
    mh = torch.randn(R, D, generator=g, device=dev)
    m = mh + 2.0 * torch.randn(R, D, generator=g, device=dev) / D ** 0.5
    sig = torch.rand(R, generator=g, device=dev) + 0.5
    if zero_rows and R > 3:
        sig[0] = 0.0  # sigma 0, v != 0: reject, z = m
        m[1] = mh[1]  # v 0: accept
        sig[2] = 0.0
        m[2] = mh[2]  # sigma 0 and v 0: accept
    return u, xi, mh, m, sig


def _near_threshold(torch, u, xi, mh, m, sig):
    """Rows whose GRS accept test lies within 1e-5 of its threshold (in
    float64), where float32 sums in another order may decide either way:
    u (R,), xi, mh, m (R, *event), sig (R,)."""
    R = u.shape[0]
    v = (mh - m).reshape(R, -1).double()
    vv, vx = (v * v).sum(-1), (v * xi.reshape(R, -1).double()).sum(-1)
    s = torch.where(sig > 0, sig, torch.ones_like(sig)).double()
    margin = (torch.log(torch.clamp(u.double(), min=1e-20))
              - torch.clamp(-(vx / s + vv / (2 * s * s)), max=0)).abs()
    return (margin < 1e-5) & (sig > 0)


def _grs_compare(torch, args):
    """B1 against its plain version: (max abs error of z, accepted rows);
    fails where z is off by more than 1e-5 or an accept bit differs on a
    row not within 1e-5 of the threshold."""
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs

    zk, ak = grs(*args)
    torch.cuda.synchronize()
    zp, ap = grs_plain(*args)
    xi = args[1]
    near = _near_threshold(torch, *args)
    if not torch.equal(ak[~near], ap[~near]):
        fail(f"grs: accept bits differ away from the threshold at {tuple(xi.shape)}")
    err = (zk - zp).abs().max().item()
    if not err <= 1e-5:
        fail(f"grs: max abs error {err} > 1e-5 at {tuple(xi.shape)}")
    return err, int(ak.sum())


def _grs_bound(R, D):
    return bound_ms(4.0 * R * D * 4 + 3 * R * 4, 10.0 * R * D, PEAK_F32)


def check_grs(torch, dev):
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs, grs_cuda

    def offset(args, off):
        u, xi, mh, m, sig = args
        return (u, *(_offset_view(torch, t, off) for t in (xi, mh, m)), sig)

    R, D = CHAINS * THETA, 1024 * 192
    edges = {}
    for name, (r, d, zero) in {"R=1": (1, 1000, False), "D=1": (8, 1, True),
                               "D=4097": (9, 4097, True),
                               "sigma0_v0_rows": (16, 5000, True)}.items():
        edges[name] = _grs_compare(torch, _grs_inputs(torch, dev, r, d, len(name), zero))[0]
    # a view one float into its storage (the kernel's 4-byte path), and
    # rows longer than a cluster holds (they stream)
    for name, (r, d, seed, off) in {"misaligned view (offset 1 float)": (R, D, 2, 1),
                                    "D=262144 (streams)": (4, 262144, 3, 0),
                                    "D=300001 (streams, offset 1 float)": (3, 300001, 4, 1),
                                    }.items():
        args = _grs_inputs(torch, dev, r, d, seed)
        edges[name] = _grs_compare(torch, offset(args, off) if off else args)[0]
    main = _grs_inputs(torch, dev, R, D, 1, zero_rows=False)
    err, accepted = _grs_compare(torch, main)
    times = kernel_times(lambda: grs(*main), lambda: grs_plain(*main), wrapper=grs)
    bms, by = _grs_bound(R, D)
    u, xi, mh, m, sig = main
    one_call = _captured_work(torch, lambda: grs_cuda(u, sig, xi, mh, m))
    if len(one_call) != 1 or one_call[0][0] != "KERNEL" or "grs_kernel" not in one_call[0][1]:
        fail(f"grs: one call queued {one_call}, expected one kernel")
    emit("grs", shape=[R, D], max_abs_err=err, accepted_rows=accepted,
         edge_max_abs_err=edges, tolerance="z atol 1e-5; accept bits equal "
         "except rows within 1e-5 of the threshold",
         **times, bound_ms=bms, bound_by=by, kernels_per_call=one_call,
         geometry=_row_geometry(R, D))
    return dict(name="grs", route="cuda", source="src/repro_torch/csrc/grs.cu",
                replaces="src/repro/kernels/grs/kernel.py:27", max_abs_err=err,
                **times, bound_ms=bms, bound_by=by)


# B2 and its plain version both compute in float32 and round the output to
# bf16 once, so an element differs by at most one bf16 ulp (2^-7 of its size)
# where the two float32 results round apart; 1e-4 more covers float32 sums in
# other orders near zero.  Rows that average over 1024-4096 keys have |o| of
# about 0.02-0.04, where a key too many or too few moves o by about 1e-3.
# The wgmma kernel's P = P_hi + P_lo is p within 2^-16 of it, far inside.
FLASH_ATOL, FLASH_RTOL = 1e-4, 2.0 ** -7
FLASH_TOLERANCE = "|kernel - plain| <= 1e-4 + 2^-7 |plain| per element (one bf16 ulp)"
# the float32 kernel: float32 sums in other orders, and 3xTF32 products
# within ~2^-21 of each product (a CPU emulation uses 1.5-2.7 % of this)
FLASH_F32_TOL = 2e-5
FLASH_F32_TOLERANCE = "|kernel - plain| <= 2e-5 + 2e-5 |plain| per element (float32)"
FLASH_WGMMA_SOURCE = "src/repro_torch/csrc/flash_attention_wgmma.cu"
FLASH_F32_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:27"


def _tflops(flops, times):
    """TFLOP/s of the kernel from its device time (its event time where the
    profiler recorded none)."""
    return flops / (times["device_ms"] or times["ms"]) / 1e9


def _flash_tolerance_used(ok, op, atol=FLASH_ATOL, rtol=FLASH_RTOL):
    """max |ok - op| / (atol + rtol |op|) over the elements: <= 1 passes."""
    op = op.float()
    return ((ok.float() - op).abs() / (atol + rtol * op.abs())).max().item()


def _flash_inputs(torch, dev, B, L, S, H, hd, seed, dtype=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, n, H, hd, generator=g, device=dev).to(dtype or torch.bfloat16)
            for n in (L, S, S)]


def _wgmma_build():
    """The wgmma kernel's launch configuration at dh 64, 128, 192 and 256
    (one instance each: one to four 64-column chunks) and, from the -Xptxas
    -v build log, each instance's registers and spills; fails where an
    instance spills."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import wgmma_launch_info

    log = (Path(_build.build_info["path"]).parent / "flash_attention_wgmma.log").read_text()
    instances = {}
    for m in re.finditer(r"flash_fwd_wgmmaILi(\d+)ELi(\d+)E\S*\n\s*(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
                         r"ptxas info\s*: Used (\d+) registers", log):
        nch, bk, stack, st, ld, regs = (int(x) for x in m.groups())
        instances[f"dh<={64 * nch}, BK {bk}"] = dict(registers=regs, spill_store_bytes=st,
                                                       spill_load_bytes=ld, stack_bytes=stack)
    launch = {hd: wgmma_launch_info(hd) for hd in (64, 128, 192, 256)}
    if (len(instances) != 4 or any(i["spill_store_bytes"] or i["spill_load_bytes"]
                                   for i in instances.values())
            or any(info["local_bytes"] for info in launch.values())):
        fail(f"flash wgmma build: instances {instances}, launch {launch} (no spills)")
    return dict(launch_by_head_dim=launch, ptxas=instances,
                setmaxnreg={"consumer": 240, "producer": 24})


def _f32_build():
    """B2's float32 kernel instances (design and template widths) with their
    registers and spills, from the -Xptxas -v build log."""
    import re

    from repro_torch.kernels import _build

    log = (Path(_build.build_info["path"]).parent / "flash_attention.log").read_text()
    out = {}
    for m in re.finditer(r"(flash_fwd_f32_(?:tc|packed))I(\w+?)EEEv\S*\n\s*(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
                         r"ptxas info\s*: Used (\d+) registers", log):
        name, targs, stack, st, ld, regs = m.groups()
        widths = ",".join(re.findall(r"Li(\d+)", targs))
        out[f"{name}<{widths}>"] = dict(registers=int(regs), spill_store_bytes=int(st),
                                        spill_load_bytes=int(ld), stack_bytes=int(stack))
    return out


def check_flash_identity_probe(torch, dev):
    """One tile with V the identity (S = dh = 64): O is softmax(Q K^T / 8)
    itself, so a wrong lane or column in the accumulator-to-A-fragment
    mapping of P, or in the V descriptor, shows element by element."""
    from repro_torch.kernels.flash_attention.ops import flash_mha

    q, k, _ = _flash_inputs(torch, dev, 1, 64, 64, 1, 64, SEED + 40)
    v = torch.eye(64, device=dev, dtype=torch.bfloat16)[None, :, None, :]
    o = flash_mha(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref = torch.softmax(q[0, :, 0].float() @ k[0, :, 0].float().T / 8.0, dim=-1)
    used = _flash_tolerance_used(o[0, :, 0], ref)
    err = (o[0, :, 0].float() - ref).abs().max().item()
    if not used <= 1.0:
        fail(f"flash identity probe: O != softmax(S), {used} of the tolerance used")
    emit("flash_identity_probe", shape=[1, 64, 1, 64], max_abs_err=err, tolerance_used=used,
         tolerance=FLASH_TOLERANCE + " against softmax(S) in float32")


def check_flash(torch, dev):
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma

    def inputs(B, L, S, H, hd, seed):
        return _flash_inputs(torch, dev, B, L, S, H, hd, seed)

    def compare(q, k, v, **opts):
        ok = flash_mha(q, k, v, **opts)
        torch.cuda.synchronize()
        op = attention_plain(q, k, v, **opts)
        used = _flash_tolerance_used(ok, op)
        if not used <= 1.0:
            fail(f"flash: {used} of the tolerance ({FLASH_TOLERANCE}) used at "
                 f"{tuple(q.shape)} {opts}")
        return (ok.float() - op.float()).abs().max().item()

    qkv = torch.randn(2, 200, 3, 8, 64, generator=torch.Generator(device=dev).manual_seed(11),
                      device=dev).to(torch.bfloat16)
    edges = {
        "L=16": compare(*inputs(4, 16, 16, 16, 64, 1), causal=False),
        "ragged L=40": compare(*inputs(4, 40, 40, 16, 64, 2), causal=False),
        "causal": compare(*inputs(2, 300, 300, 8, 64, 3), causal=True),
        "window 48": compare(*inputs(2, 300, 300, 8, 64, 4), causal=True, window=48),
        "softcap 30": compare(*inputs(2, 200, 200, 8, 64, 5), causal=False,
                              softcap=30.0),
        "dh=72": compare(*inputs(2, 256, 256, 16, 72, 6), causal=False),
        "dh=128 L=129 S=255": compare(*inputs(1, 129, 255, 4, 128, 12), causal=False),
        "L=127 S=1": compare(*inputs(2, 127, 1, 4, 64, 13), causal=False),
        "causal L=S=129": compare(*inputs(2, 129, 129, 4, 64, 14), causal=True),
        "true_seq_k 100 of S=255": compare(*inputs(2, 128, 255, 4, 64, 15), causal=False,
                                           true_seq_k=100),
        "q, k, v views of one qkv": compare(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                            causal=True),
    }
    # head dims past two chunks (gemma2's 256: 64-row query tiles whose
    # warpgroups split O's columns), with the options the archs use
    edges.update({
        "dh=136 causal window 40": compare(*inputs(2, 300, 300, 4, 136, 16), causal=True,
                                           window=40),
        "dh=192 causal softcap 50": compare(*inputs(2, 300, 300, 4, 192, 17), causal=True,
                                            softcap=50.0),
        "dh=256 causal window 100 softcap 50": compare(*inputs(2, 300, 300, 4, 256, 18),
                                                       causal=True, window=100,
                                                       softcap=50.0),
        "dh=256 L=300 S=200": compare(*inputs(2, 300, 200, 4, 256, 19), causal=False),
    })
    for n in (1, 127, 128, 129, 255):
        for causal in (False, True):
            edges[f"dh=256 L=S={n}{' causal' if causal else ''}"] = compare(
                *inputs(2, n, n, 3, 256, 20 + n), causal=causal)
    # hymba-1.5b: 25 heads (KV repeated from 5), ragged last tile of the
    # L + 16 forward, KV tiles skipped outside the 1024 band
    edges["hymba L=4112 window 1024"] = compare(*inputs(2, 4112, 4112, 25, 64, 8),
                                                causal=True, window=1024)
    edges["hymba L=4112 causal"] = compare(*inputs(2, 4112, 4112, 25, 64, 9), causal=True)
    B, L, H, hd = CHAINS * THETA, 1024, 16, 64
    q, k, v = inputs(B, L, L, H, hd, 7)
    err = compare(q, k, v, causal=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = kernel_times(lambda: flash_mha(q, k, v, causal=False),
                         lambda: attention_plain(q, k, v, causal=False),
                         lambda: sdpa(qt, kt, vt), reps=5, wrapper=flash_wgmma)
    flops = 4.0 * B * H * L * L * hd
    bms, by = bound_ms(4.0 * B * L * H * hd * 2, flops, PEAK_BF16)
    build = _wgmma_build()
    emit("flash_attention", variant="wgmma (bf16: TMA, wgmma, P = P_hi + P_lo)",
         shape=[B, L, H, hd], dtype="bfloat16", max_abs_err=err,
         edge_max_abs_err=edges, tolerance=FLASH_TOLERANCE, **times,
         library="scaled_dot_product_attention", bound_ms=bms, bound_by=by,
         design_floor_ms=1.5 * flops / PEAK_BF16 * 1e3, build=build,
         tflops=_tflops(flops, times))
    hymba = {}
    for name, window in (("window 1024", 1024), ("causal", 0)):
        hymba[name] = _flash_at_hymba_shape(torch, dev, window)
        emit("flash_attention_hymba", variant="wgmma", **hymba[name])
    return dict(name="flash_attention", route="cuda", source=FLASH_WGMMA_SOURCE,
                replaces=FLASH_REPLACES, variant="wgmma (bf16)",
                max_abs_err=err, **times, bound_ms=bms, bound_by=by, at_hymba_shape=hymba)


def _hymba_pairs(L, window):
    """(q, k) pairs a causal mask with ``window`` (0: full) keeps over L rows."""
    return sum(min(i + 1, window or L) for i in range(L))


def _flash_at_hymba_shape(torch, dev, window):
    """B2 as the hymba prefill launches it: (2, 4096, 25, 64) bf16, causal,
    ``window`` 1024 (29 layers) or 0 (3 layers).  Two planted faults show
    that the tolerance can see a wrong band: the kernel against the plain
    version with the window one key narrower and one wider (window 1024),
    or with the first KV tile dropped from the last 64 rows (full causal:
    the plain version's window L - 64).  The library call is SDPA with the
    boolean band mask; the bound counts the (q, k) pairs the mask keeps."""
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma
    from repro_torch.nn.attention import attn_mask

    B, L, H, hd = HYMBA_BATCH, HYMBA_PROMPT, 25, 64
    q, k, v = _flash_inputs(torch, dev, B, L, L, H, hd, 10 + window)
    ok = flash_mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    op = attention_plain(q, k, v, causal=True, window=window)
    used = _flash_tolerance_used(ok, op)
    err = (ok.float() - op.float()).abs().max().item()
    faults = ({"window 1023": window - 1, "window 1025": window + 1} if window else
              {"first KV tile dropped in the last 64 rows": L - 64})
    planted = {name: _flash_tolerance_used(ok, attention_plain(q, k, v, causal=True,
                                                               window=w))
               for name, w in faults.items()}
    del op
    if not used <= 1.0 or not all(u > 1.0 for u in planted.values()):
        fail(f"flash at the hymba shape, window {window}: {used} of the tolerance used, "
             f"planted faults {planted} (each must exceed 1)")
    mask = attn_mask(L, L, True, window, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = kernel_times(lambda: flash_mha(q, k, v, causal=True, window=window),
                         lambda: attention_plain(q, k, v, causal=True, window=window),
                         lambda: sdpa(qt, kt, vt, attn_mask=mask), reps=3, wrapper=flash_wgmma)
    pairs = _hymba_pairs(L, window)
    flops = 4.0 * B * H * pairs * hd
    bms, by = bound_ms(4.0 * B * L * H * hd * 2, flops, PEAK_BF16)
    return dict(shape=[B, L, H, hd], dtype="bfloat16", causal=True, window=window,
                max_abs_err=err, tolerance=FLASH_TOLERANCE, tolerance_used=used,
                planted_faults_tolerance_used=planted, **times,
                library="scaled_dot_product_attention with the boolean band mask",
                bound_ms=bms, bound_by=by, design_floor_ms=1.5 * flops / PEAK_BF16 * 1e3,
                attended_pairs=pairs, tflops=_tflops(flops, times))


def _f32_compare(torch, q, k, v, **opts):
    """B2's float32 kernel against its plain version: (share of the
    tolerance used, max abs error, the design the call launched)."""
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_f32, flash_mha

    before = dict(flash_f32.launches_by_design)
    ok = flash_mha(q, k, v, **opts)
    torch.cuda.synchronize()
    ran = [d for d, n in flash_f32.launches_by_design.items() if n != before[d]]
    op = attention_plain(q, k, v, **opts)
    used = _flash_tolerance_used(ok, op, FLASH_F32_TOL, FLASH_F32_TOL)
    if not used <= 1.0 or len(ran) != 1:
        fail(f"flash f32: {used} of the tolerance ({FLASH_F32_TOLERANCE}) used at "
             f"{tuple(q.shape)} {opts}, designs launched {ran}")
    return used, (ok - op).abs().max().item(), ran[0]


def _f32_timed(torch, q, k, v, opts, library, reps=20):
    """B2's float32 kernel at one shape: the compare, then cold-cache times of
    the kernel, the plain version and ``library`` (SDPA on the same inputs),
    and the bound, with the (q, k) pairs the mask keeps."""
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_f32, flash_mha

    used, err, design = _f32_compare(torch, q, k, v, **opts)
    times = kernel_times(lambda: flash_mha(q, k, v, **opts),
                         lambda: attention_plain(q, k, v, **opts), library, reps=reps,
                         wrapper=flash_f32)
    B, L, H, hd = q.shape
    S = k.shape[1]
    causal, window = opts.get("causal", False), opts.get("window", 0)
    pairs = _hymba_pairs(L, window) if causal else L * S  # causal here: L == S
    flops = 4.0 * B * H * pairs * hd
    bms, by, term = f32_attention_bound(4.0 * B * L * H * hd * 4, flops)
    return dict(shape=[B, L, H, hd], dtype="float32", causal=causal, window=window,
                design=design, max_abs_err=err, tolerance=FLASH_F32_TOLERANCE,
                tolerance_used=used, **times, bound_ms=bms, bound_by=by, bound_term=term,
                attended_pairs=pairs, tflops=_tflops(flops, times))


def check_flash_f32(torch, dev):
    """B2's float32 kernel against its plain version: edges of both designs
    (the packed design's limit of 64 on each side, head dims, the 4-byte
    copies of a view one float into its storage and of hd 18), then the two
    shapes ``hymba_f32`` launches it at, (2, 4096, 25, 64) causal with
    window 1024 (32 launches) and full (6 launches), tensor-core design.
    The library call is SDPA in float32 with the band mask; the bound is
    ``f32_attention_bound``."""
    from repro_torch.nn.attention import attn_mask

    f32 = torch.float32

    def offset(t):
        return _offset_view(torch, t, 1)

    edges = {}
    for name, (shape, opts) in {
            "packed ragged L=40 causal hd 16": ((2, 40, 40, 3, 16), dict(causal=True)),
            "packed L=64 S=63": ((3, 64, 63, 3, 32), dict(causal=False)),
            "packed L=S=64 window 9 softcap 5": ((3, 64, 64, 3, 24),
                                                 dict(causal=True, window=9, softcap=5.0)),
            "tensor_core L=64 S=65": ((3, 64, 65, 3, 32), dict(causal=False)),
            "tensor_core hd 72": ((2, 100, 100, 4, 72), dict(causal=False)),
            "tensor_core hd 128 true_seq_k 150 of 255": ((1, 129, 255, 2, 128),
                                                         dict(causal=False, true_seq_k=150)),
            "tensor_core hd 24 causal window 100": ((2, 300, 300, 2, 24),
                                                    dict(causal=True, window=100)),
    }.items():
        B, L, S, H, hd = shape
        q, k, v = _flash_inputs(torch, dev, B, L, S, H, hd, L + S + hd, f32)
        used, _, design = _f32_compare(torch, q, k, v, **opts)
        edges[name] = dict(tolerance_used=used, design=design)
        if L <= 64 or hd == 24:  # the same values one float into their storage
            used, _, design = _f32_compare(torch, offset(q), offset(k), offset(v), **opts)
            edges[name + ", offset views (4-byte copies)"] = dict(tolerance_used=used,
                                                                   design=design)
    q, k, v = _flash_inputs(torch, dev, 2, 90, 90, 3, 18, 18, f32)
    for L in (50, 90):
        used, _, design = _f32_compare(torch, q[:, :L], k[:, :L], v[:, :L], causal=True)
        edges[f"hd 18 L={L} (4-byte copies)"] = dict(tolerance_used=used, design=design)

    B, L, H, hd = HYMBA_BATCH, HYMBA_PROMPT, 25, 64
    q, k, v = _flash_inputs(torch, dev, B, L, L, H, hd, 23, f32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    for name, window in (("window 1024", 1024), ("causal", 0)):
        mask = attn_mask(L, L, True, window, dev)
        shapes[name] = _f32_timed(torch, q, k, v, dict(causal=True, window=window),
                                  lambda: sdpa(qt, kt, vt, attn_mask=mask), reps=3)
        del mask
        if shapes[name]["design"] != "tensor_core":
            fail(f"flash f32 at the hymba_f32 shape ({name}): design {shapes[name]['design']}")
        emit("flash_attention_f32", **shapes[name],
             library="scaled_dot_product_attention (float32) with the band mask",
             **({"edge_tolerance_used": edges, "build": _f32_build()} if window else {}))
    main = shapes["window 1024"]
    return dict(name="flash_attention_f32", route="cuda", source=FLASH_F32_SOURCE,
                replaces=FLASH_REPLACES, variant="float32: 3xTF32 tensor cores, or packed "
                "(batch, head) pairs for Lq, Sk <= 64", design=main["design"],
                max_abs_err=main["max_abs_err"],
                **{k: main[k] for k in ("ms", "device_ms", "device_records_lost", "plain_ms",
                                        "plain_device_ms", "library_ms", "library_device_ms",
                                        "bound_ms", "bound_by", "bound_term")},
                at_shapes={"hymba_f32 causal": shapes["causal"]})


def _serve_maps(torch, dev):
    """The pack maps of a budget-16 round over 4 slots of theta 8 (grants
    8, 3, 4, 1): the gather rows and the scatter's drop-row map."""
    from repro_torch.serving.packing import build_pack_maps

    maps = build_pack_maps(torch.tensor([8, 3, 4, 1], device=dev), BUDGET)
    src_rows = torch.where(maps.valid, maps.slot_id * THETA + maps.step_id, 0)
    return src_rows, maps.row_id(THETA)


def _edge_idx(torch, dev, N, M, seed):
    """Unique rows for the first M - 2 packed positions, then padding."""
    g = torch.Generator().manual_seed(seed)
    live = torch.randperm(N, generator=g)[: max(min(M - 2, N), 1)]
    pad = M - live.numel()
    return (torch.cat([live, torch.zeros(pad, dtype=torch.long)]).to(dev),
            torch.cat([live, N + torch.arange(pad)]).to(dev))


_EDGES = {"D=1": (5, 3, ()), "D=5 (scalar path)": (7, 11, (5,)), "D=4097": (9, 4, (4097,)),
          "rank-3 event": (6, 2, (2, 3, 8)), "M=13": (12, 13, (3, 7))}


def check_pack(torch, dev):
    """B3 gather and B4 scatter against their plain versions: equal bits."""
    from repro_torch.kernels.pack.ops import (gather_rows, gather_rows_plain, scatter_rows,
                                              scatter_rows_plain)

    def compare(src, vals, gidx, sidx, N):
        out, tbl = gather_rows(src, gidx), scatter_rows(vals, sidx, N)
        torch.cuda.synchronize()
        if not (torch.equal(out, gather_rows_plain(src, gidx))
                and torch.equal(tbl, scatter_rows_plain(vals, sidx, N))):
            fail(f"pack: kernel and plain version differ at {tuple(src.shape)}")
        dropped = scatter_rows(vals, torch.full_like(sidx, N), N)
        if dropped.any():
            fail("pack: a scatter with every row dropped left a nonzero row")

    g = torch.Generator(device=dev).manual_seed(SEED)
    for name, (N, M, ev) in _EDGES.items():
        gidx, sidx = _edge_idx(torch, dev, N, M, len(name))
        compare(torch.randn((N,) + ev, generator=g, device=dev),
                torch.randn((M,) + ev, generator=g, device=dev), gidx, sidx, N)
    N, D = SLOTS * THETA, 1024 * 192
    src = torch.randn(N, D, generator=g, device=dev)
    vals = torch.randn(BUDGET, D, generator=g, device=dev)
    gidx, sidx = _serve_maps(torch, dev)
    compare(src, vals, gidx, sidx, N)
    lines = []
    for name, fn, plain, lib, nbytes, replaces in (
            ("gather_rows", lambda: gather_rows(src, gidx),
             lambda: gather_rows_plain(src, gidx), lambda: torch.index_select(src, 0, gidx),
             2.0 * BUDGET * D * 4 + BUDGET * 8, "src/repro/kernels/pack/kernel.py:31"),
            ("scatter_rows", lambda: scatter_rows(vals, sidx, N),
             lambda: scatter_rows_plain(vals, sidx, N), None,
             BUDGET * D * 4.0 + N * D * 4 + BUDGET * 8, "src/repro/kernels/pack/kernel.py:59")):
        times = kernel_times(fn, plain, lib, wrapper=_counters()[name])
        bms, by = bound_ms(nbytes, 0.0, PEAK_F32)
        emit("pack", kernel=name, shape={"table_rows": N, "packed_rows": BUDGET, "D": D},
             max_abs_err=0.0, edges=sorted(_EDGES), tolerance="equal bits (data movement)",
             **times, library="index_select" if lib is not None else None, bound_ms=bms,
             bound_by=by)
        lines.append(dict(name=name, route="cuda", source="src/repro_torch/csrc/pack.cu",
                          replaces=replaces, max_abs_err=0.0, **times, bound_ms=bms,
                          bound_by=by))
    return lines


def check_fused_round(torch, dev):
    """B5 fused gather (equal bits) and B6 fused verify-commit (z within
    1e-5, accept bits equal away from the GRS threshold) against their
    plain versions."""
    from repro_torch.kernels.superstep.ops import (fused_gather, fused_gather_plain,
                                                   fused_verify_commit,
                                                   fused_verify_commit_cuda,
                                                   fused_verify_commit_plain)

    def commit_inputs(M, ev, g):
        r = lambda: torch.randn((M,) + ev, generator=g, device=dev)  # noqa: E731
        y, gg, xi = r(), r(), r()
        A = 1.0 + 0.1 * torch.rand(M, generator=g, device=dev)
        B = 0.5 * torch.rand(M, generator=g, device=dev)
        shape = (M,) + (1,) * len(ev)
        m = A.reshape(shape) * y + B.reshape(shape) * gg
        mh = m + 0.3 * r() / max(1, math.prod(ev)) ** 0.5
        sig = 0.2 + 0.3 * torch.rand(M, generator=g, device=dev)
        u = torch.rand(M, generator=g, device=dev)
        if M > 2:  # sigma 0 with v != 0 (reject) and with v == 0 (accept)
            sig[0] = 0.0
            sig[1], A[1], B[1] = 0.0, 1.0, 0.0
            mh[1] = y[1]
        return [y, gg, xi, mh, A, B, u, sig], m

    def compare(tbls, sc, gidx, args, m, sidx, N, off=0):
        args = [*(_offset_view(torch, t, off) for t in args[:4]), *args[4:]]
        got = fused_gather(*tbls, sc, gidx)
        zk, ak = fused_verify_commit(*args, sidx, N)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, fused_gather_plain(*tbls, sc, gidx))):
            fail(f"fused_round: fused gather differs from plain at {tuple(tbls[0].shape)}")
        zp, ap = fused_verify_commit_plain(*args, sidx, N)
        y, gg, xi, mh, A, B, u, sig = args
        near = torch.zeros(N, dtype=torch.bool, device=dev)
        live = sidx < N
        near[sidx[live]] = _near_threshold(torch, u, xi, mh, m, sig)[live]
        if not torch.equal(ak[~near], ap[~near]):
            fail(f"fused_round: accept bits differ away from the threshold at {tuple(y.shape)}")
        err = (zk - zp).abs().max().item()
        if not err <= 1e-5:
            fail(f"fused_round: z max abs error {err} > 1e-5 at {tuple(y.shape)}")
        return err

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    edges = {}
    for name, (N, M, ev) in _EDGES.items():
        gidx, sidx = _edge_idx(torch, dev, N, M, len(name))
        tbls = [torch.randn((N,) + ev, generator=g, device=dev) for _ in range(3)]
        args, m = commit_inputs(M, ev, g)
        edges[name] = compare(tbls, torch.randn(N, 5, generator=g, device=dev), gidx, args,
                              m, sidx, N)
    # B6 alone: rows longer than a cluster holds (they stream), one with
    # every (M, D) input a view one float into its storage
    for name, (N, M, ev, off) in {"D=262144 (streams)": (6, 4, (262144,), 0),
                                  "D=300001 (streams, offset 1 float)": (6, 4, (300001,), 1)
                                  }.items():
        gidx, sidx = _edge_idx(torch, dev, N, M, len(name))
        tbls = [torch.randn((N,) + ev, generator=g, device=dev) for _ in range(3)]
        args, m = commit_inputs(M, ev, g)
        edges[name] = compare(tbls, torch.randn(N, 5, generator=g, device=dev), gidx, args,
                              m, sidx, N, off)
    N, D, M, ev = SLOTS * THETA, 1024 * 192, BUDGET, (1024, 192)
    tbls = [torch.randn((N,) + ev, generator=g, device=dev) for _ in range(3)]
    sc = torch.randn(N, 5, generator=g, device=dev)
    gidx, sidx = _serve_maps(torch, dev)
    args, m = commit_inputs(M, ev, g)
    err = compare(tbls, sc, gidx, args, m, sidx, N)
    edges["misaligned view (offset 1 float)"] = compare(tbls, sc, gidx, args, m, sidx, N, 1)
    rows = [t.reshape(M, D) for t in args[:4]] + args[4:]
    one_call = _captured_work(torch, lambda: fused_verify_commit_cuda(*rows, sidx, N))
    if len(one_call) != 1 or one_call[0][0] != "KERNEL" or "fvc_kernel" not in one_call[0][1]:
        fail(f"fused_round: one B6 call queued {one_call}, expected one kernel")
    lines = []
    for name, fn, plain, nbytes, ops, replaces in (
            ("fused_gather", lambda: fused_gather(*tbls, sc, gidx),
             lambda: fused_gather_plain(*tbls, sc, gidx),
             2.0 * (3 * M * D * 4 + M * 5 * 4) + M * 8, 0.0,
             "src/repro/kernels/superstep/kernel.py:42"),
            ("fused_verify_commit", lambda: fused_verify_commit(*args, sidx, N),
             lambda: fused_verify_commit_plain(*args, sidx, N),
             4.0 * M * D * 4 + 4 * M * 4 + M * 8 + N * D * 4 + N * 4, 12.0 * M * D,
             "src/repro/kernels/superstep/kernel.py:84")):
        times = kernel_times(fn, plain, wrapper=_counters()[name])
        bms, by = bound_ms(nbytes, ops, PEAK_F32)
        commit = name != "fused_gather"
        e = err if commit else 0.0
        emit("fused_round", kernel=name, shape={"table_rows": N, "packed_rows": M, "D": D,
                                                 "scalars": 5},
             max_abs_err=e, edge_max_abs_err=edges if commit else None,
             edges=sorted(_EDGES),
             tolerance=("z atol 1e-5; accept bits equal except rows within 1e-5 of the "
                        "threshold" if commit else "equal bits"),
             **times, bound_ms=bms, bound_by=by,
             **(dict(kernels_per_call=one_call, geometry=_row_geometry(N, D)) if commit else {}))
        lines.append(dict(name=name, route="cuda", source="src/repro_torch/csrc/superstep.cu",
                          replaces=replaces, max_abs_err=e, **times, bound_ms=bms,
                          bound_by=by))
    return lines


def check_ssm_scan(torch, dev):
    """B7 against its plain loop.  Equal bits are expected (both round a*h,
    then add b, in float32); checked at atol 1e-5 + rtol 1e-5."""
    from repro_torch.kernels.ssm_scan.ops import linear_scan, ssm_scan_plain

    def inputs(B, L, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        a = 0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)
        return a, torch.randn(B, L, D, generator=g, device=dev)

    def compare(a, b):
        hk = linear_scan(a, b)
        torch.cuda.synchronize()
        hp = ssm_scan_plain(a, b)
        if not (torch.isfinite(hk).all() and torch.allclose(hk, hp, atol=1e-5, rtol=1e-5)):
            fail(f"ssm_scan: kernel and plain differ beyond atol 1e-5 + rtol 1e-5 at "
                 f"{tuple(a.shape)}")
        return (hk - hp).abs().max().item(), bool(torch.equal(hk, hp))

    edges = {name: compare(*inputs(*shape, len(name)))
             for name, shape in {"L=1": (2, 1, 25600), "L=100 D=70": (1, 100, 70),
                                 "D=25601 (not a multiple of 4)": (2, 37, 25601),
                                 "L=17 (ragged unroll tail)": (3, 17, 130),
                                 "D=1": (2, 50, 1),
                                 "L=16 (the forward's last chunk)": (2, 16, 25600),
                                 "L=4096 (the prefill unchunked)": (2, 4096, 25600)}.items()}
    # the hymba prefill's per-call shape: B 2, a chunk of L, din * N = 1600
    # * 16 (the mixer scans in chunks of MAMBA_CHUNK)
    B, L, D = HYMBA_BATCH, MAMBA_CHUNK, 1600 * 16
    a, b = inputs(B, L, D, 1)
    err, equal = compare(a, b)
    times = kernel_times(lambda: linear_scan(a, b), lambda: ssm_scan_plain(a, b), reps=3,
                         wrapper=linear_scan)
    bms, by = bound_ms(12.0 * B * L * D, 2.0 * B * L * D, PEAK_F32)
    emit("ssm_scan", shape=[B, L, D], dtype="float32", max_abs_err=err, equal_bits=equal,
         edge_max_abs_err={k: e for k, (e, _) in edges.items()},
         edge_equal_bits={k: q for k, (_, q) in edges.items()},
         tolerance="atol 1e-5 + rtol 1e-5; equal bits expected (no FMA contraction)",
         **times, library=None, bound_ms=bms, bound_by=by,
         gb_per_s=12.0 * B * L * D / times["ms"] / 1e6)
    return dict(name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan/kernel.py:27", max_abs_err=err,
                **times, bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------- phase 4


def run_slice(torch, dev):
    from repro_torch import pytree
    from repro_torch.configs.registry import paper_pixel_dit
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.core.sequential import sequential_sample_batched
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = paper_pixel_dit()
    published = dc.backbone.n_layers
    dc = dataclasses.replace(dc, backbone=dataclasses.replace(dc.backbone,
                                                              n_layers=PIXEL_DEPTH))
    cfg = dc.backbone
    t0 = time.perf_counter()
    params = init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pytree.leaves(params))
    emit("weights", model=cfg.name, params=n_params, seconds=time.perf_counter() - t0,
         layers=cfg.n_layers, published_layers=published, d_model=cfg.d_model,
         heads=cfg.n_heads, d_ff=cfg.d_ff, seq_len=dc.seq_len, d_data=dc.d_data, seed=SEED,
         out_scale=OUT_SCALE)

    flash_fn = make_sl_model_fn(params, dc)
    naive_fn = make_sl_model_fn(params, dc, attn_impl="naive")
    g = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.tensor([0.05, 0.5, 5.0, 50.0], device=dev)
    y = torch.randn(4, dc.seq_len, dc.d_data, generator=g, device=dev) * (t * t + t).sqrt()[:, None, None]
    with torch.no_grad():
        out_f, out_n = flash_fn(t, y), naive_fn(t, y)
    torch.cuda.synchronize()
    rel = ((out_f - out_n).norm() / out_n.norm()).item()
    if not (torch.isfinite(out_f).all() and rel <= 5e-2):
        fail(f"denoiser: flash vs naive relative L2 error {rel} > 5e-2")
    emit("denoiser", relative_l2_err=rel, max_abs_err=(out_f - out_n).abs().max().item(),
         out_abs_max=out_n.abs().max().item(),
         tolerance=f"relative L2 5e-2: bf16 compute over {cfg.n_layers} layers; the naive "
         "core rounds scores and probabilities to bf16, the kernel does not")

    sched = sl_geometric(K, t_min=0.05, t_max=50.0)
    y0 = torch.zeros(CHAINS, dc.seq_len, dc.d_data, device=dev)
    # each model call and the GRS step once, alone, for the time breakdown
    with torch.no_grad():
        pts = torch.randn(CHAINS * THETA, dc.seq_len, dc.d_data, generator=g, device=dev)
        tv = sched.t_model[:THETA].repeat(CHAINS).to(dev)
        verify_ms = cuda_ms(lambda: flash_fn(tv, pts), reps=3, warmup=1)
        propose_ms = cuda_ms(lambda: flash_fn(tv[:CHAINS], pts[:CHAINS]), reps=3, warmup=1)

        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        counters = _counters()
        base = _fresh_memory(torch)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = asd_sample_batched(flash_fn, sched, y0, THETA, eager_head=False,
                                 generator=g, device=dev)
        torch.cuda.synchronize()
        asd_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        asd_memory = _memory(torch, base)

        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        base = _fresh_memory(torch)
        _zero_counters(torch, counters)
        with _CaptureLog() as seq_captures:
            t0 = time.perf_counter()
            seq = sequential_sample_batched(flash_fn, sched, y0, generator=g, device=dev)
            torch.cuda.synchronize()
            seq_s = time.perf_counter() - t0
        seq_launches = _launches(counters)
        seq_memory = _memory(torch, base)

    rounds = res.rounds.tolist()
    head_calls = res.head_calls.tolist()
    depth = (res.rounds + res.head_calls).tolist()
    loop_rounds = max(rounds)
    model_calls = 2 * loop_rounds  # one proposal + one verification call a round
    finite = bool(torch.isfinite(res.sample).all() and torch.isfinite(seq).all())
    shape_ok = tuple(res.sample.shape) == (CHAINS, dc.seq_len, dc.d_data)
    if not (finite and shape_ok):
        fail(f"asd: finite={finite}, sample shape {tuple(res.sample.shape)}")
    if launches["grs"] < loop_rounds or launches["grs"] == 0:
        fail(f"asd: {launches['grs']} GRS launches for {loop_rounds} rounds")
    if launches["flash_attention"] != cfg.n_layers * model_calls:
        fail(f"asd: {launches['flash_attention']} flash launches, expected "
             f"{cfg.n_layers} x {model_calls} model calls")
    accepts, proposals = int(res.accepts.sum()), int(res.proposals.sum())
    emit("asd", K=K, theta=THETA, chains=CHAINS, eager_head=False,
         schedule="sl_geometric(K, t_min=0.05, t_max=50.0)",
         rounds=rounds, head_calls=head_calls, depth=depth,
         mean_depth=statistics.mean(depth),
         K_over_depth=[K / d for d in depth], accept_rate=accepts / max(proposals, 1),
         accepts=accepts, proposals=proposals, model_calls=model_calls,
         launches=launches, asd_wall_s=asd_s, sequential_wall_s=seq_s,
         sequential_model_calls=K, finite=finite,
         samples_per_s_asd=CHAINS / asd_s, samples_per_s_sequential=CHAINS / seq_s,
         asd_capture_ms=res.loop.capture_ms, sequential_capture_ms=seq_captures.ms,
         loop_rounds_run=res.loop.rounds, host_reads=res.loop.host_reads,
         note="both samplers replay captured CUDA graphs (one round, one step); each "
              "wall includes its capture")
    if res.loop.rounds != loop_rounds or res.loop.host_reads > loop_rounds:
        fail(f"asd: the loop ran {res.loop.rounds} rounds with {res.loop.host_reads} host "
             f"reads for {loop_rounds} rounds")
    emit("where_time_goes", round_wall_ms=asd_s / loop_rounds * 1e3,
         verification_call_ms=verify_ms, proposal_call_ms=propose_ms,
         note="each call timed alone (CUDA events around 3 calls back to back); the "
              "kernels' own times are in the kernel lines")
    profile_round(torch, dev, flash_fn, sched, y0)
    graph_runs = {
        "buffer_b1": dict(res=res, launches=launches, wall_s=asd_s, memory=asd_memory,
                          noise=dict(generator_seed=SEED + 1)),
        "sequential": dict(out=seq, launches=seq_launches, wall_s=seq_s, memory=seq_memory,
                           capture_ms=seq_captures.ms, generator_seed=SEED + 2)}
    return launches, flash_fn, sched, dc, graph_runs


# device kernels by what they do, matched on their names (the first group
# that matches wins: the wgmma kernel's name also starts with flash_fwd)
_KERNEL_GROUPS = (("flash_attention", ("flash_fwd_wgmma",)),
                  ("flash_attention_f32", ("flash_fwd_f32",)), ("grs", ("grs_",)),
                  ("pack", ("gather_rows_kernel", "scatter_rows_kernel")),
                  ("fused_round", ("fused_gather_kernel", "fvc_")),
                  ("ssm_scan", ("ssm_scan_kernel",)),
                  ("ssm_scan_backward", ("ssm_scan_bwd_kernel",)),
                  ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")))


def profile_round(torch, dev, model_fn, sched, y0):
    """One warm ASD round under torch.profiler: device time by kernel group
    and the device's idle share of the round's wall time."""
    from repro_torch.core.asd import asd_round, init_chain_state

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        st = init_chain_state(sched.to(dev), y0, THETA, generator=g)
        st = asd_round(model_fn, sched.to(dev), st, THETA)
        torch.cuda.synchronize()
        wall_ms, kernels = _profiled(torch, lambda: asd_round(model_fn, sched.to(dev), st,
                                                              THETA))
    _emit_profile(torch, "profile", wall_ms, kernels,
                  "one warm round (proposal + verification call, GRS, plan and commit) "
                  "under torch.profiler; kernels run on one stream")


def _profiled(torch, fn):
    """Wall ms of ``fn`` (ended by a synchronize) under torch.profiler, and
    the device kernels it ran as (name, ms, count)."""
    wall_ms, kernels, _ = _profiled_moe(torch, fn)
    return wall_ms, kernels


def _emit_profile(torch, phase, wall_ms, kernels, note, **extra):
    if not kernels:
        emit(phase, wall_ms=wall_ms, device_ms="not measured",
             note="the profiler recorded no device time", **extra)
        return
    busy = sum(ms for _, ms, _ in kernels)
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in kernels:
        group = next((name for name, marks in _KERNEL_GROUPS
                      if any(m in key for m in marks)), "other")
        groups[group] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=max(0.0, 1.0 - busy / wall_ms), device_ms_by_group=groups,
         top_kernels=[{"name": k[:80], "ms": ms, "count": n} for k, ms, n in top],
         note=note, **extra)


def check_reference(torch, dev):
    """The sampler on a small denoiser, on the card and on the CPU, with the
    same weights and noise: counters equal, samples within 2e-3 (float32
    sums in other orders, grown over the chained steps)."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = paper_diffusion_policy_smoke()
    k, theta, b = 16, 4, 3
    sched = sl_geometric(k, 0.05, 50.0)
    gen = torch.Generator().manual_seed(SEED)
    u = torch.rand(b, k + theta + 1, generator=gen)
    xi = torch.randn(b, k + theta + 1, dc.seq_len, dc.d_data, generator=gen)
    y0 = torch.zeros(b, dc.seq_len, dc.d_data)
    out = {}
    for where in ("cpu", dev):
        params = init_denoiser_params(dc, SEED, out_scale=1.0, device=where)
        with torch.no_grad():
            out[str(where)] = asd_sample_batched(
                make_sl_model_fn(params, dc), sched, y0, theta, u_buf=u, xi_buf=xi,
                device=where)
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            fail(f"reference: {name} differs between card and CPU")
    err = (card.sample.cpu() - cpu.sample).abs().max().item()
    if not err <= 2e-3 or not bool((cpu.accepts < cpu.proposals).any()):
        fail(f"reference: sample error {err} or no rejection")
    emit("reference", model=dc.backbone.name, K=k, theta=theta, chains=b,
         max_abs_err=err, tolerance=2e-3, rounds=cpu.rounds.tolist(),
         accepts=int(cpu.accepts.sum()), proposals=int(cpu.proposals.sum()))


# ---------------------------------------------------------------- phase 5


def _counters():
    """Every kernel wrapper, by the name the kernels line gives it."""
    from repro_torch.kernels.flash_attention.ops import flash_f32, flash_wgmma
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.kernels.pack.ops import gather_rows, scatter_rows
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.superstep.ops import fused_gather, fused_verify_commit

    return {"grs": grs, "flash_attention": flash_wgmma, "flash_attention_f32": flash_f32,
            "gather_rows": gather_rows,
            "scatter_rows": scatter_rows, "fused_gather": fused_gather,
            "fused_verify_commit": fused_verify_commit, "ssm_scan": linear_scan}


# launches of each kernel per round of the packed engine, by round_impl
# (flash: every layer x 2 model calls, the proposal and the verification)
def _per_round(n_layers):
    return {"packed": {"grs": 1, "gather_rows": 3, "scatter_rows": 1, "fused_gather": 0,
                       "fused_verify_commit": 0, "flash_attention": 2 * n_layers,
                       "flash_attention_f32": 0, "ssm_scan": 0},
            "fused": {"grs": 0, "gather_rows": 0, "scatter_rows": 0, "fused_gather": 1,
                      "fused_verify_commit": 1, "flash_attention": 2 * n_layers,
                      "flash_attention_f32": 0, "ssm_scan": 0}}


def _serve_requests(torch, dev, dc, k, theta, n, seed):
    """n requests with their noise drawn on the card from per-request
    generators, so every run serves the same chains."""
    from repro_torch.serving.engine import Request

    reqs = []
    for rid in range(n):
        g = torch.Generator(device=dev).manual_seed(seed + rid)
        reqs.append(Request(
            rid, u_buf=torch.rand(k + theta + 1, generator=g, device=dev),
            xi_buf=torch.randn((k + theta + 1, dc.seq_len, dc.d_data), generator=g,
                               device=dev)))
    return reqs


def run_serve(torch, dev, model_fn, sched, dc):
    """pixel-dit-serve: ContinuousASDEngine, packed execution, in both
    round_impls on the same requests."""
    from repro_torch.core import prng
    from repro_torch.core.asd import asd_superstep, init_chain_state
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.serving.packing import WaterfillingAllocator, packed_superstep

    counters = _counters()
    per_round = _per_round(dc.backbone.n_layers)
    event = (dc.seq_len, dc.d_data)
    reqs = _serve_requests(torch, dev, dc, K, THETA, REQUESTS, SEED + 100)
    runs, launches_by_run = {}, {}
    for impl in ("packed", "fused"):
        eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                  execution="packed", round_budget=BUDGET,
                                  rounds_per_sync=RPS, round_impl=impl, seed=SEED,
                                  device=dev)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        rounds = eng.stats.rounds_total
        want = {name: rounds * n for name, n in per_round[impl].items()}
        if launches != want:
            fail(f"serve {impl}: launches {launches}, expected {want} for {rounds} rounds")
        if sorted(out) != list(range(REQUESTS)) or not all(
                v.shape == event and np.isfinite(v).all() for v in out.values()):
            fail(f"serve {impl}: samples missing, misshapen or not finite")
        per_req = {m.rid: m for m in eng.stats.per_request}
        depth = [per_req[r].rounds + per_req[r].head_calls for r in range(REQUESTS)]
        emit("serve", round_impl=impl, model=dc.backbone.name, requests=REQUESTS,
             slots=SLOTS, theta=THETA, K=K, round_budget=BUDGET, rounds_per_sync=RPS,
             eager_head=True, wall_s=wall, samples_per_s=REQUESTS / wall,
             supersteps=eng.stats.supersteps, rounds=rounds,
             round_wall_ms=wall / rounds * 1e3,
             per_request_rounds=[per_req[r].rounds for r in range(REQUESTS)],
             per_request_depth=depth,
             per_request_accept_rate=[per_req[r].accept_rate for r in range(REQUESTS)],
             accepts=sum(m.accepts for m in per_req.values()),
             proposals=sum(m.proposals for m in per_req.values()),
             slot_occupancy=sum(m.rounds for m in per_req.values()) / (rounds * SLOTS),
             launches=launches)
        runs[impl] = (out, per_req, launches)
        launches_by_run[f"serve_{impl}"] = launches
    (out_p, req_p, _), (out_f, req_f, _) = runs["packed"], runs["fused"]
    for rid in range(REQUESTS):
        a, b = req_p[rid], req_f[rid]
        if (a.rounds, a.head_calls, a.accepts, a.proposals) != (
                b.rounds, b.head_calls, b.accepts, b.proposals):
            fail(f"serve: request {rid} counters differ between packed and fused")
    err = max(float(np.abs(out_p[r] - out_f[r]).max()) for r in range(REQUESTS))
    if err != 0.0:
        fail(f"serve: packed and fused samples differ by {err} (expected equal bits: "
             "both rounds run the same GRS row code on the same inputs)")
    emit("serve_parity", max_abs_err=err, tolerance="equal bits and equal counters",
         requests=REQUESTS)

    # one superstep of each round_impl, and in counter noise of the unpacked
    # round too, with every host sync an error
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    keys = prng.split(prng.PRNGKey(SEED + 7), SLOTS).to(dev)
    sched_dev = sched.to(dev)
    for mode, impl in (("buffer", "packed"), ("buffer", "fused"), ("counter", "packed"),
                       ("counter", "fused"), ("counter", "unpacked")):
        st = init_chain_state(sched_dev, torch.zeros((SLOTS,) + event, device=dev),
                              THETA, False, generator=g, noise_mode=mode,
                              key=keys if mode == "counter" else None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                if impl == "unpacked":
                    asd_superstep(model_fn, sched_dev, st, THETA, RPS, eager_head=True,
                                  keep_trajectory=False, noise_mode=mode)
                else:
                    packed_superstep(model_fn, sched_dev, st, None,
                                     torch.ones(SLOTS, device=dev), rounds=RPS, theta=THETA,
                                     budget=BUDGET,
                                     allocator=WaterfillingAllocator(theta_max=THETA),
                                     round_impl=impl, noise_mode=mode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # and a warm replay of the engine's graph of the same superstep
        kw = (dict(execution="unpacked") if impl == "unpacked" else
              dict(execution="packed", round_budget=BUDGET, round_impl=impl))
        eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                  rounds_per_sync=1, seed=SEED, noise_mode=mode,
                                  keep_trajectory=False, device=dev, **kw)
        _warm_replay_no_sync(torch, eng, [Request(i, key=prng.PRNGKey(SEED + 40 + i))
                                          for i in range(SLOTS)], f"serve {mode} {impl}")
        del eng
    emit("serve_no_host_sync", rounds=RPS,
         supersteps=["buffer packed", "buffer fused", "counter packed", "counter fused",
                     "counter unpacked"],
         note="one superstep each under torch.cuda.set_sync_debug_mode('error'), and a "
              "warm replay of each one's graph in an engine (one round)")

    # one warm superstep of the engine under the profiler, per round_impl
    for impl in ("packed", "fused"):
        eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                  execution="packed", round_budget=BUDGET,
                                  rounds_per_sync=RPS, round_impl=impl, seed=SEED,
                                  device=dev)
        for r in _serve_requests(torch, dev, dc, K, THETA, SLOTS, SEED + 200):
            eng.submit(r)
        eng.step()
        torch.cuda.synchronize()
        wall_ms, kernels = _profiled(torch, eng.step)
        _emit_profile(torch, "serve_profile", wall_ms, kernels,
                      f"one warm superstep ({RPS} rounds, harvest included) of the serve "
                      "cell under torch.profiler", round_impl=impl, rounds=RPS,
                      round_wall_ms=wall_ms / RPS)
    return launches_by_run, runs


# the branched cell (pixel-dit-branched): branches, and the packed engine's
# budgets: 32 gives each of the 4 slots one window (every branch past the
# first is shed), 64 covers slots x theta x branches
BRANCHES = 2
BRANCHED_BUDGETS = (32, SLOTS * THETA * BRANCHES)


def _branch_lanes(res):
    """Mean accepted prefix a round and the wasted share of the drafted
    points, over a batch of chains (an ASDResult)."""
    accepts = int(res.accepts.sum())
    return (accepts / max(int(res.rounds.sum()), 1),
            1.0 - accepts / max(int(res.draft_points.sum()), 1))


def run_branched(torch, dev, model_fn, sched, dc, serve_runs):
    """pixel-dit-branched: the full-width denoiser with B 2 draft branches.

    ``asd_sample_batched`` (4 chains, theta 8, K 64, counter noise) at B 1
    and 2 from the same key, with one round from the same states (the
    branched advance is never shorter); ``ContinuousASDEngine`` (packed, 6
    keyed requests on 4 slots, R 4) at budgets 32 and 64 in both
    round_impls, which must give equal counters and sample bits; one
    superstep of each round with host syncs made errors; and B 1 asked for
    explicitly (a gain branch controller beside it) against the serve
    phase's runs: the same bits, counters and launches."""
    from repro_torch.core import prng
    from repro_torch.core.asd import asd_round, asd_sample_batched, asd_superstep, init_chain_state
    from repro_torch.core.controller import GainBranches
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.serving.packing import WaterfillingAllocator, packed_superstep

    counters = _counters()
    n_layers = dc.backbone.n_layers
    event = (dc.seq_len, dc.d_data)
    sched_dev = sched.to(dev)
    key = prng.PRNGKey(SEED + 30)
    y0 = torch.zeros((CHAINS,) + event, device=dev)
    by_run, sampled, graph_runs = {}, {}, {}
    with torch.no_grad():
        for nb in (1, BRANCHES):
            base = _fresh_memory(torch)
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            res = asd_sample_batched(model_fn, sched, y0, THETA, eager_head=False, device=dev,
                                     key=key, noise_mode="counter", num_branches=nb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches(counters)
            loops = int(res.rounds.max())
            graph_runs[f"counter_b{nb}"] = dict(res=res, launches=launches, wall_s=wall,
                                                memory=_memory(torch, base),
                                                noise=dict(key=SEED + 30))
            want = dict.fromkeys(launches, 0)
            want.update(grs=loops, flash_attention=2 * n_layers * loops)
            if launches != want:
                fail(f"branched asd B {nb}: launches {launches}, expected {want}")
            if not (bool(torch.isfinite(res.sample).all())
                    and tuple(res.sample.shape) == (CHAINS,) + event):
                fail(f"branched asd B {nb}: samples not finite or misshapen")
            depth = (res.rounds + res.head_calls).tolist()
            accept_depth, waste = _branch_lanes(res)
            sampled[nb] = statistics.mean(depth)
            emit("branched", run="asd", branches=nb, K=K, theta=THETA, chains=CHAINS,
                 noise_mode="counter", eager_head=False, depth=depth,
                 mean_depth=sampled[nb], K_over_depth=K / sampled[nb],
                 accept_rate=int(res.accepts.sum()) / max(int(res.proposals.sum()), 1),
                 branch_accept_depth=accept_depth, wasted_draft_frac=waste,
                 draft_points=int(res.draft_points.sum()),
                 proposals=int(res.proposals.sum()), loop_rounds=loops, wall_s=wall,
                 round_wall_ms=wall / loops * 1e3, capture_ms=res.loop.capture_ms,
                 host_reads=res.loop.host_reads, launches=launches,
                 launches_per_round={k: v / loops for k, v in launches.items() if v},
                 grs_rows=CHAINS * nb * THETA,
                 flash_verify_points=CHAINS * nb * THETA)
            by_run[f"branched_asd_b{nb}"] = launches
        # one round from the same states: the longest of B prefixes is never
        # shorter than branch 0's, which is the single-draft round's
        st = init_chain_state(sched_dev, y0, THETA, False,
                              key=prng.split(key, CHAINS).to(dev), noise_mode="counter",
                              num_branches=BRANCHES)
        one = asd_round(model_fn, sched_dev, st, THETA, keep_trajectory=False,
                        noise_mode="counter")
        many = asd_round(model_fn, sched_dev, st, THETA, keep_trajectory=False,
                         noise_mode="counter", num_branches=BRANCHES)
        if bool((many.a < one.a).any()):
            fail(f"branched: one round advanced {many.a.tolist()} at B {BRANCHES}, below "
                 f"{one.a.tolist()} at B 1")
        # that round again under the profiler, warm, at B 1 and B 2
        for nb in (1, BRANCHES):
            wall_ms, kernels = _profiled(torch, lambda nb=nb: asd_round(
                model_fn, sched_dev, st, THETA, keep_trajectory=False, noise_mode="counter",
                num_branches=nb))
            _emit_profile(torch, "branched_profile", wall_ms, kernels,
                          "one warm round from the same states (proposal and verification "
                          "call, the counter window and branch draws, GRS, plan and commit) "
                          "under torch.profiler", branches=nb)
    emit("branched_round", branches=BRANCHES, advance_b1=one.a.tolist(),
         advance_branched=many.a.tolist(), depth_ratio=sampled[BRANCHES] / sampled[1],
         note="one round from the same states: the branched advance is never shorter")

    reqs = [Request(i, key=prng.PRNGKey(3000 + i)) for i in range(REQUESTS)]
    per_round = _per_round(n_layers)
    for budget in BRANCHED_BUDGETS:
        runs = {}
        for impl in ("packed", "fused"):
            eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                      execution="packed", round_budget=budget,
                                      rounds_per_sync=RPS, round_impl=impl, seed=SEED,
                                      noise_mode="counter", num_branches=BRANCHES,
                                      device=dev)
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            out = eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches(counters)
            rounds = eng.stats.rounds_total
            want = {name: rounds * n for name, n in per_round[impl].items()}
            if launches != want:
                fail(f"branched serve {impl} budget {budget}: launches {launches}, expected "
                     f"{want} for {rounds} rounds")
            if sorted(out) != list(range(REQUESTS)) or not all(
                    v.shape == event and np.isfinite(v).all() for v in out.values()):
                fail(f"branched serve {impl} budget {budget}: samples missing or not finite")
            per_req = {m.rid: m for m in eng.stats.per_request}
            s = eng.stats
            emit("branched", run="serve", round_impl=impl, branches=BRANCHES,
                 round_budget=budget, covering_budget=SLOTS * THETA * BRANCHES,
                 requests=REQUESTS, slots=SLOTS, theta=THETA, K=K, rounds_per_sync=RPS,
                 noise_mode="counter", wall_s=wall, samples_per_s=REQUESTS / wall,
                 rounds=rounds, round_wall_ms=wall / rounds * 1e3,
                 per_request_depth=[per_req[r].parallel_depth for r in range(REQUESTS)],
                 accept_rate=s.accept_rate(), branch_accept_depth=s.branch_accept_depth(),
                 wasted_draft_frac=s.wasted_draft_frac(), draft_points=s.draft_points_total,
                 proposals=s.proposals_total, launches=launches,
                 launches_per_round={k: v / rounds for k, v in launches.items() if v})
            runs[impl] = (out, {r: (m.rounds, m.head_calls, m.model_evals, m.accepts,
                                    m.proposals, m.draft_points) for r, m in per_req.items()})
            by_run[f"branched_serve_{impl}_b{budget}"] = launches
        (op, cp), (of, cf) = runs["packed"], runs["fused"]
        err = max(float(np.abs(op[r] - of[r]).max()) for r in range(REQUESTS))
        if cp != cf or err != 0.0:
            fail(f"branched serve budget {budget}: packed and fused differ (counters equal: "
                 f"{cp == cf}, samples by {err})")

    # one superstep of each round, B 2, with every host sync an error
    st = init_chain_state(sched_dev, torch.zeros((SLOTS,) + event, device=dev), THETA, False,
                          key=prng.split(prng.PRNGKey(SEED + 31), SLOTS).to(dev),
                          noise_mode="counter", num_branches=BRANCHES,
                          branch_controller=GainBranches())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            asd_superstep(model_fn, sched_dev, st, THETA, RPS, eager_head=True,
                          keep_trajectory=False, noise_mode="counter", num_branches=BRANCHES,
                          branch_controller=GainBranches())
            for impl in ("packed", "fused"):
                packed_superstep(model_fn, sched_dev, st, None, torch.ones(SLOTS, device=dev),
                                 rounds=RPS, theta=THETA, budget=BRANCHED_BUDGETS[0],
                                 allocator=WaterfillingAllocator(theta_max=THETA * BRANCHES),
                                 round_impl=impl, noise_mode="counter",
                                 num_branches=BRANCHES, branch_controller=GainBranches())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for impl in ("unpacked", "packed", "fused"):
        kw = (dict(execution="unpacked") if impl == "unpacked" else
              dict(execution="packed", round_budget=BRANCHED_BUDGETS[0], round_impl=impl))
        eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                  rounds_per_sync=1, seed=SEED, noise_mode="counter",
                                  keep_trajectory=False, num_branches=BRANCHES,
                                  branch_controller=GainBranches(), device=dev, **kw)
        _warm_replay_no_sync(torch, eng, [Request(i, key=prng.PRNGKey(SEED + 50 + i))
                                          for i in range(SLOTS)], f"branched {impl}")
        del eng
    emit("branched_no_host_sync", branches=BRANCHES, rounds=RPS,
         supersteps=["unpacked", "packed", "fused"], branch_controller="gain",
         note="one superstep each under torch.cuda.set_sync_debug_mode('error'), and a "
              "warm replay of each one's graph in an engine (one round)")

    # B 1 asked for explicitly: the serve phase's bits, counters and launches
    serve_reqs = _serve_requests(torch, dev, dc, K, THETA, REQUESTS, SEED + 100)
    for impl in ("packed", "fused"):
        eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                                  execution="packed", round_budget=BUDGET,
                                  rounds_per_sync=RPS, round_impl=impl, seed=SEED,
                                  num_branches=1, branch_controller=GainBranches(), device=dev)
        _zero_counters(torch, counters)
        out = eng.serve(serve_reqs)
        torch.cuda.synchronize()
        launches = _launches(counters)
        ref_out, ref_req, ref_launches = serve_runs[impl]
        got = {m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
               for m in eng.stats.per_request}
        want = {r: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
                for r, m in ref_req.items()}
        same = all(np.array_equal(out[r].view(np.int32), ref_out[r].view(np.int32))
                   for r in range(REQUESTS))
        if got != want or not same or launches != ref_launches:
            fail(f"branched B 1 {impl}: counters equal {got == want}, bits equal {same}, "
                 f"launches {launches} against {ref_launches}")
        if any(m.draft_points != m.proposals for m in eng.stats.per_request):
            fail(f"branched B 1 {impl}: drafted points differ from proposals")
    emit("branched_b1", round_impls=["packed", "fused"], requests=REQUESTS,
         note="num_branches=1 with a gain branch controller against the serve phase: "
              "equal sample bits, counters and launches")
    return by_run, graph_runs


# ---------------------------------------------------------------- graphs


class _Eager:
    """A program's body (a superstep's or an admission's) run eagerly at
    every call: what the graphs are held against (on the card an engine
    replays graphs)."""

    def __init__(self, prog):
        self.prog, self.calls = prog, 0
        self.stage = getattr(prog, "stage", None)  # an admission's staging tensors

    def __call__(self):
        self.calls += 1
        self.prog.body()
        return self.calls == 1


def _eager_engine():
    """``ContinuousASDEngine`` with every superstep (its sync packet
    included) and every admission run as its eager body: the engine as it
    ran before any boundary was a graph."""
    from repro_torch.serving.engine import ContinuousASDEngine

    class EagerEngine(ContinuousASDEngine):
        def _make_superstep(self, R, budget):
            return _Eager(super()._make_superstep(R, budget))

        def _get_admit(self, width):
            prog = self._admit_fns.get(width)
            if prog is None:
                prog = self._admit_fns[width] = _Eager(super()._get_admit(width))
            return prog

    return EagerEngine


def _slots(eng):
    """A copy of every slot tensor of an engine, by field."""
    st = eng._states
    return {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None}


def _set_slots(eng, snap):
    for name, v in snap.items():
        getattr(eng._states, name).copy_(v)


def _same_slots(torch, a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _key_args(eng):
    """The (R, budget) the engine's last superstep ran at."""
    return eng._rps, (eng.round_budget if eng.execution == "packed" else None)


def _replay_no_sync(torch, eng, R, B):
    """One call of the engine's superstep with every host sync an error;
    returns whether it was cold."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cold = eng._launch_superstep(R, B)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return cold


def _warm_replay_no_sync(torch, eng, requests, what):
    """Fill the slots, run two supersteps (the first captures), then one
    warm replay with every host sync an error."""
    for r in requests:
        eng.submit(r)
    eng.step()
    eng.step()
    if _replay_no_sync(torch, eng, *_key_args(eng)):
        fail(f"{what}: the third call of a program was cold")


def _graph_vs_eager(torch, eng, R, B, counters):
    """From the slot states as they stand: one warm replay (host syncs made
    errors), then from the same states one run of the eager body.  Returns
    (cold, equal bits in every slot field, replay launches, eager
    launches); the engine is left where the replay left it."""
    prog = eng._get_superstep(R, B)
    saved = _slots(eng)
    _zero_counters(torch, counters)
    cold = _replay_no_sync(torch, eng, R, B)
    replay = _launches(counters)
    got = _slots(eng)
    _set_slots(eng, saved)
    _zero_counters(torch, counters)
    prog.body()
    torch.cuda.synchronize()
    eager = _launches(counters)
    same = _same_slots(torch, got, _slots(eng))
    _set_slots(eng, got)
    return cold, same, replay, eager


def _check_programs(eng, what):
    """One capture per key, and no more programs than the ladders allow;
    returns the capture ms by key."""
    progs = eng._superstep_fns
    if (any(p.captures != 1 or p.graph is None for p in progs.values())
            or eng._compiled_supersteps != len(progs) or len(progs) > eng._program_bound()):
        fail(f"{what}: captures {[(k, p.captures) for k, p in progs.items()]}, "
             f"{eng._compiled_supersteps} programs, bound {eng._program_bound()}")
    return {str(k): p.capture_ms for k, p in progs.items()}


def _fresh_memory(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _memory(torch, base):
    """Peak allocated bytes above ``base`` since ``_fresh_memory``, and the
    bytes reserved now."""
    torch.cuda.synchronize()
    return dict(peak_bytes=torch.cuda.max_memory_allocated() - base,
                reserved_bytes=torch.cuda.memory_reserved())


class _CaptureLog:
    """The host ms of every program capture made while it is open (each
    program's own ``capture_ms``, collected), and of each whole capture
    call, its counter bookkeeping included."""

    def __enter__(self):
        from repro_torch import programs

        self.ms, self.call_ms = [], []
        self._orig = programs.SuperstepProgram._capture
        orig, log, log_call = self._orig, self.ms, self.call_ms

        def capture(prog):
            t0 = time.perf_counter()
            orig(prog)
            log_call.append((time.perf_counter() - t0) * 1e3)
            log.append(prog.capture_ms)

        programs.SuperstepProgram._capture = capture
        return self

    def __exit__(self, *exc):
        from repro_torch import programs

        programs.SuperstepProgram._capture = self._orig


# the sampler graph cell (pixel-dit-sampler-graphs): asd_sample_batched at
# 4 chains, theta 8, K 64 in buffer and counter noise at B 1 and 2, and the
# sequential baseline, each a replayed graph held against the eager loop;
# one call of the first and the last configuration is profiled (a cut:
# each profiled call costs a sampler call and more)
SAMPLER_CONFIGS = ("buffer_b1", "buffer_b2", "counter_b1", "counter_b2")
SAMPLER_PROFILED = ("buffer_b1", "counter_b2")
_COUNTER_FIELDS = ("rounds", "head_calls", "model_evals", "accepts", "proposals",
                   "draft_points")


def _bits(torch, a, b):
    """Equal shapes and equal float32 bits."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _eager_sampler(model_fn, sched, y0, theta, noise, nb, eager_head=False, keep=True,
                   generator=None, keys=None, conds=None):
    """The sampler's loop as it ran before it became a program, written out
    here: ``init_chain_state``, then ``asd_round`` with a host check after
    every round.  Returns (final state, rounds run)."""
    from repro_torch.core.asd import asd_round, chain_done, init_chain_state

    st = init_chain_state(sched, y0, theta, keep, generator=generator, key=keys,
                          noise_mode=noise, num_branches=nb)
    rounds = 0
    while not bool(chain_done(st, sched.K).all()):
        st = asd_round(model_fn, sched, st, theta, eager_head, keep, conds=conds,
                       noise_mode=noise, num_branches=nb)
        rounds += 1
    return st, rounds


def _eager_sequential(model_fn, sched, y, xi, conds=None):
    """The K-step loop as it ran before it became a program."""
    for i in range(sched.K):
        t = sched.t_model[i].expand(y.shape[0])
        g = model_fn(t, y) if conds is None else model_fn(t, y, conds)
        y = sched.A[i] * y + sched.B[i] * g + sched.sigma[i] * xi[i]
    return y


def run_sampler_graphs(torch, dev, model_fn, sched, dc, graph_runs):
    """The sampler's loop and the K-step baseline as replayed graphs against
    the eager loops written out above, on pixel-dit (4 chains, theta 8, K
    64).  The graph calls of ``buffer_b1`` and ``sequential`` are the asd
    phase's, those of ``counter_b1`` and ``counter_b2`` the branched
    phase's (each with its wall, launches and peak memory); ``buffer_b2`` is
    run here.  Gates in each: sample and trajectory bits, every counter,
    launches and the rounds run equal to the eager loop's, host reads at
    most the rounds, and a warm replay of a fresh loop's round with host
    syncs made errors.  Then the planted fault: on the serve CLI's model,
    whose proposals are all accepted (its zero out_proj), the first bound
    is the whole run, and one round more must fail the rounds gate."""
    from repro_torch.core import asd as asd_mod
    from repro_torch.core import prng
    from repro_torch.core.asd import SamplerLoop, asd_sample_batched, chain_sample, init_chain_state
    from repro_torch.core.schedules import ddpm
    from repro_torch.launch import serve

    counters = _counters()
    event = (dc.seq_len, dc.d_data)
    sched_dev = sched.to(dev)
    y0 = torch.zeros((CHAINS,) + event, device=dev)
    key = prng.PRNGKey(SEED + 30)
    keys = prng.split(prng.as_key(key, dev), CHAINS)

    def noise_of(name):
        return (dict(generator=torch.Generator(device=dev).manual_seed(SEED + 1))
                if name == "buffer_b1" else dict(keys=keys))

    def graph_call(name):
        noise, nb = name.split("_b")
        kw = (dict(generator=noise_of(name)["generator"]) if name == "buffer_b1"
              else dict(key=key))
        return asd_sample_batched(model_fn, sched, y0, THETA, eager_head=False, device=dev,
                                  noise_mode=noise, num_branches=int(nb), **kw)

    by_run = {}
    with torch.no_grad():
        base = _fresh_memory(torch)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        res = graph_call("buffer_b2")
        torch.cuda.synchronize()
        graph_runs["buffer_b2"] = dict(res=res, launches=_launches(counters),
                                       wall_s=time.perf_counter() - t0,
                                       memory=_memory(torch, base))
        by_run["sampler_graphs_buffer_b2"] = graph_runs["buffer_b2"]["launches"]
        for name in SAMPLER_CONFIGS:
            run, (noise, nb) = graph_runs[name], name.split("_b")
            nb = int(nb)
            base = _fresh_memory(torch)
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            st, rounds = _eager_sampler(model_fn, sched_dev, y0, THETA, noise, nb,
                                        **noise_of(name))
            torch.cuda.synchronize()
            eager = dict(wall_s=time.perf_counter() - t0, launches=_launches(counters),
                         memory=_memory(torch, base))
            res = run["res"]
            same = {"sample": _bits(torch, res.sample, chain_sample(st, K, True)),
                    "trajectory": _bits(torch, res.trajectory, st.y[:, :K + 1])}
            same.update({f: torch.equal(getattr(res, f), getattr(st, f))
                         for f in _COUNTER_FIELDS})
            if (not all(same.values()) or run["launches"] != eager["launches"]
                    or res.loop.rounds != rounds or res.loop.host_reads > rounds
                    or res.loop.capture_ms is None):
                fail(f"sampler_graphs {name}: equal {same}, launches {run['launches']} "
                     f"against {eager['launches']}, rounds {res.loop.rounds} against "
                     f"{rounds}, host reads {res.loop.host_reads}, capture "
                     f"{res.loop.capture_ms}")
            # a warm replay of a fresh loop's round, host syncs made errors
            loop = SamplerLoop(model_fn, sched_dev, init_chain_state(
                sched_dev, y0, THETA, generator=noise_of(name).get("generator"),
                key=None if name == "buffer_b1" else keys, noise_mode=noise,
                num_branches=nb), THETA, noise_mode=noise, num_branches=nb)
            loop.program()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loop.program()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            if loop.program.graph is None:
                fail(f"sampler_graphs {name}: the round was not captured")
            del loop
            profile = None
            if name in SAMPLER_PROFILED:
                torch.cuda.synchronize()
                wall_ms, kernels = _profiled(torch, lambda name=name: graph_call(name))
                busy = sum(ms for _, ms, _ in kernels)
                profile = dict(wall_ms=wall_ms, busy_ms=busy,
                               idle_share=max(0.0, 1.0 - busy / wall_ms) if busy else None,
                               round_busy_ms=busy / rounds)
            emit("sampler_graphs", model=dc.backbone.name, run=name, noise_mode=noise,
                 branches=nb, chains=CHAINS, theta=THETA, K=K, keep_trajectory=True,
                 rounds=rounds, host_reads=res.loop.host_reads,
                 capture_ms=res.loop.capture_ms,
                 graph=dict(wall_s=run["wall_s"], round_wall_ms=run["wall_s"] / rounds * 1e3,
                            **run["memory"], profiled_call=profile),
                 eager=dict(wall_s=eager["wall_s"],
                            round_wall_ms=eager["wall_s"] / rounds * 1e3, **eager["memory"]),
                 launches=run["launches"], equal=same,
                 gate="sample and trajectory bits, counters, launches and rounds equal to "
                      "the eager loop's; host reads <= rounds; a warm replay makes no host "
                      "sync")

        # the K-step baseline
        seq = graph_runs["sequential"]
        g = torch.Generator(device=dev).manual_seed(seq["generator_seed"])
        xi = torch.randn((K,) + tuple(y0.shape), generator=g, device=dev)
        base = _fresh_memory(torch)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        want = _eager_sequential(model_fn, sched_dev, y0, xi)
        torch.cuda.synchronize()
        eager_s, eager_launches = time.perf_counter() - t0, _launches(counters)
        eager_memory = _memory(torch, base)
        if not _bits(torch, seq["out"], want) or seq["launches"] != eager_launches:
            fail(f"sampler_graphs sequential: bits equal {_bits(torch, seq['out'], want)}, "
                 f"launches {seq['launches']} against {eager_launches}")
        emit("sampler_graphs", model=dc.backbone.name, run="sequential", chains=CHAINS, K=K,
             capture_ms=seq["capture_ms"],
             graph=dict(wall_s=seq["wall_s"], step_wall_ms=seq["wall_s"] / K * 1e3,
                        **seq["memory"]),
             eager=dict(wall_s=eager_s, step_wall_ms=eager_s / K * 1e3, **eager_memory),
             launches=seq["launches"], gate="sample bits and launches equal to the eager loop's")
        del want, xi

        # the planted fault: the first bound one round too long
        args = serve.parser().parse_args([])
        _, cdc, cfn = serve._build(args)
        csched = ddpm(args.K).to(dev)
        cy0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (SLOTS, cdc.seq_len, cdc.d_data), np.float32)).to(dev)
        ckey = prng.PRNGKey(1)
        ckw = dict(eager_head=True, keep_trajectory=False, device=dev, key=ckey,
                   noise_mode="counter")
        _, eager_rounds = _eager_sampler(cfn, csched, cy0, args.theta, "counter", 1, True,
                                         False, keys=prng.split(prng.as_key(ckey, dev), SLOTS))
        right = asd_sample_batched(cfn, csched, cy0, args.theta, **ckw)
        bound, first = asd_mod._rounds_bound, []

        def too_long(a, K_, theta):
            n = bound(a, K_, theta)
            if not first:
                first.append(n)
                return n + 1
            return n

        asd_mod._rounds_bound = too_long
        try:
            wrong = asd_sample_batched(cfn, csched, cy0, args.theta, **ckw)
        finally:
            asd_mod._rounds_bound = bound
        torch.cuda.synchronize()
        caught = wrong.loop.rounds != eager_rounds
        counters_same = all(torch.equal(getattr(wrong, f), getattr(right, f))
                            for f in _COUNTER_FIELDS)
        if right.loop.rounds != eager_rounds or not caught:
            fail(f"sampler_graphs planted fault: rounds {right.loop.rounds} and, one round "
                 f"too long, {wrong.loop.rounds} against the eager loop's {eager_rounds} "
                 f"(first bound {first})")
        emit("sampler_graphs_planted_fault", model="paper-diffusion-policy", K=args.K,
             theta=args.theta, chains=SLOTS, first_bound=first[0], eager_rounds=eager_rounds,
             rounds_right=right.loop.rounds, rounds_faulty=wrong.loop.rounds, caught=caught,
             counters_equal_despite_fault=counters_same,
             note="every proposal is accepted (zero out_proj), so the first bound is the "
                  "whole run; replaying one round more before the first read must fail the "
                  "rounds gate (finished chains are frozen, so bits and counters cannot)")
        del cfn
    return by_run


# the graph cell (pixel-dit-graphs): the serve engine at budgets 16 and 64,
# both round_impls, B 1 and 2, counter noise, graphs against eager bodies;
# and one run with both auto ladders
GRAPH_BUDGETS = (16, 64)
# serve_graphs' pixel-dit depth: its nine configurations each serve and
# replay the full-width model, so it runs half of PIXEL_DEPTH to keep the
# smoke inside its time limit (every gate compares graph and eager runs of
# the same model, whatever its depth)
SERVE_GRAPHS_DEPTH = PIXEL_DEPTH // 2
GRAPH_AUTO = dict(round_budget="auto", rounds_per_sync="auto")
GRAPH_CLI_PROFILE = 8  # warm CLI supersteps profiled, graphs and eager


def _eager_admit(torch, eng, placed):
    """Admission as it ran before it became a program, written out here: one
    ``init_chain_state`` a request, every field written into its slot, then
    its condition row."""
    from repro_torch.core import prng
    from repro_torch.core.asd import init_chain_state
    from repro_torch.core.sequential import init_y0

    for slot, req in placed:
        key = prng.as_key(req.key) if req.key is not None else eng._request_key(req.rid)
        key, k0 = prng.split(key, 2).unbind(0)
        y0 = init_y0(eng.schedule, eng.event_shape, device=eng.device, key=k0.to(eng.device))
        new = init_chain_state(eng.schedule, y0[None], eng.theta, eng.keep_trajectory,
                               eng.controller, key=key[None].to(eng.device),
                               noise_mode=eng.noise_mode, num_branches=eng.num_branches,
                               branch_controller=eng.branch_controller)
        for f in dataclasses.fields(new):
            if getattr(new, f.name) is not None:
                getattr(eng._states, f.name)[slot] = getattr(new, f.name)[0]
        if eng.d_cond:
            eng._conds[slot] = 0.0 if req.cond is None else torch.as_tensor(req.cond)


def _eager_packet(torch, eng):
    """The sync packet as it was built before it moved into the program."""
    from repro_torch.core.asd import chain_sample
    from repro_torch.serving.worker import _SYNC_ROWS

    st = eng._states
    return (torch.stack([getattr(st, n) for n in _SYNC_ROWS]).to(torch.int32).cpu(),
            chain_sample(st, eng.schedule.K, eng.keep_trajectory).clone())


class _HostSplit:
    """Host wall time of each call of the worker's boundary parts while
    open: admission, the superstep launch (a replay, or a cold dispatch),
    the packet copies and the harvest (which waits for the packet)."""

    PARTS = ("_admit_pending", "_launch_superstep", "_sync_packet", "_harvest")

    def __enter__(self):
        from repro_torch.serving.worker import ShardWorker

        self.ms = {p: [] for p in self.PARTS}
        self._orig = {p: getattr(ShardWorker, p) for p in self.PARTS}
        for part, orig in self._orig.items():
            def timed(eng, *a, _orig=orig, _log=self.ms[part]):
                t0 = time.perf_counter()
                out = _orig(eng, *a)
                _log.append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(ShardWorker, part, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.worker import ShardWorker

        for part, orig in self._orig.items():
            setattr(ShardWorker, part, orig)

    def summary(self, rounds):
        return {p.lstrip("_"): dict(calls=len(v), median_ms=statistics.median(v) if v else None,
                                    total_ms=sum(v), per_round_ms=sum(v) / max(rounds, 1))
                for p, v in self.ms.items()}


def _serve_graphs_model(torch, dev):
    """(model_fn, dc): the pixel-dit at full width and SERVE_GRAPHS_DEPTH
    layers, weights from SEED, for serve_graphs."""
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = _mp_pixel_dc(SERVE_GRAPHS_DEPTH)
    params = init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev)
    return make_sl_model_fn(params, dc), dc


def run_serve_graphs(torch, dev, model_fn, dc, sched):
    """The worker's superstep programs as captured CUDA graphs, held against
    their eager bodies in the same run.

    pixel-dit (6 keyed requests on 4 slots, theta 8, K 64, R 4, counter
    noise) at budgets 16 and 64 in both round_impls at B 1 and 2, and once
    with both auto ladders: one capture per key within the ladders' bound,
    capture ms, peak memory, wall and samples/s; at B 1 below budget 64 the
    engine that runs every superstep's eager body serves the same requests
    (equal sample bits, counters and launches).  Then, mid-flight, one warm
    replay (no host sync) against the eager body from the same states, and
    one superstep of each profiled.  The planted fault, a fused superstep
    captured with its tier as an int (the covering 64) and replayed at the
    ladder's lowest, must fail the same gate.  Last the serve CLI's
    paper-diffusion-policy: replay against eager body from the same states,
    and ``serve.main`` with 8 profiled supersteps with graphs and eagerly."""
    from repro_torch.core import prng
    from repro_torch.core.schedules import ddpm
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ContinuousASDEngine, Request

    Eager = _eager_engine()
    counters = _counters()
    event = (dc.seq_len, dc.d_data)
    reqs = [Request(i, key=prng.PRNGKey(4000 + i)) for i in range(REQUESTS)]
    mid = [Request(100 + i, key=prng.PRNGKey(4100 + i)) for i in range(SLOTS)]
    configs = [dict(num_branches=nb, round_budget=b, round_impl=impl, rounds_per_sync=RPS)
               for nb in (1, BRANCHES) for b in GRAPH_BUDGETS for impl in ("packed", "fused")]
    configs.append(dict(num_branches=1, round_impl="packed", **GRAPH_AUTO))
    by_run = {}
    for cfg in configs:
        name = (f"nb{cfg['num_branches']}_{cfg['round_impl']}_b{cfg['round_budget']}"
                f"_r{cfg['rounds_per_sync']}")

        def engine(cls):
            return cls(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                       execution="packed", seed=SEED, noise_mode="counter",
                       keep_trajectory=False, device=dev, **cfg)

        # the eager engine serves the same requests at B 1 where its wall is
        # short (budget 16, the auto ladders); every configuration holds
        # the replay against the eager body from the same states below
        kinds = (("graph", ContinuousASDEngine),) + (
            (("eager", Eager),) if cfg["num_branches"] == 1 and cfg["round_budget"] != 64
            else ())
        runs = {}
        for kind, cls in kinds:
            base = _fresh_memory(torch)
            eng = engine(cls)
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            out = eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_req = {m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts,
                               m.proposals, m.draft_points) for m in eng.stats.per_request}
            runs[kind] = dict(out=out, per_req=per_req, launches=_launches(counters),
                              rounds=eng.stats.rounds_total, wall_s=wall,
                              peak_bytes=torch.cuda.max_memory_allocated() - base,
                              reserved_bytes=torch.cuda.memory_reserved(),
                              keys=sorted(map(str, eng._superstep_fns)))
            if kind == "graph":
                capture_ms = _check_programs(eng, f"serve_graphs {name}")
            del eng
        g, e = runs["graph"], runs.get("eager")
        if sorted(g["out"]) != list(range(REQUESTS)) or not all(
                np.isfinite(v).all() for v in g["out"].values()):
            fail(f"serve_graphs {name}: samples missing or not finite")
        if e is not None:
            bits = all(np.array_equal(g["out"][r].view(np.int32),
                                      e["out"][r].view(np.int32)) for r in range(REQUESTS))
            if (not bits or g["per_req"] != e["per_req"] or g["launches"] != e["launches"]
                    or g["keys"] != e["keys"]):
                fail(f"serve_graphs {name}: graphs against eager: bits equal {bits}, "
                     f"counters equal {g['per_req'] == e['per_req']}, launches "
                     f"{g['launches']} against {e['launches']}, keys {g['keys']} against "
                     f"{e['keys']}")
        # mid-flight: a warm replay against the eager body from the same
        # states; then from one state a superstep of each profiled (the
        # engine's program swapped for its eager body for the second)
        eng = engine(ContinuousASDEngine)
        for r in mid:
            eng.submit(r)
        eng.step()  # the cold dispatch: the eager body, then the capture
        key_args = _key_args(eng)
        cold, same, replay, eager = _graph_vs_eager(torch, eng, *key_args, counters)
        if cold or not same or replay != eager or not any(replay.values()):
            fail(f"serve_graphs {name}: replay against eager body from the same states: "
                 f"cold {cold}, bits equal {same}, launches {replay} against {eager}")
        # the profiled steps run the key just replayed (an auto ladder
        # would re-pick it, and a new key's capture is not a replay)
        eng._auto_rps, eng._rps = False, key_args[0]
        if eng._budget_auto:
            eng._budget_auto, eng.round_budget = False, key_args[1]
        saved, profiles, built = _slots(eng), {}, eng._compiled_supersteps
        for kind in ("graph", "eager"):
            if kind == "eager":
                _set_slots(eng, saved)
                key = next(k for k, p in eng._superstep_fns.items()
                           if p is eng._get_superstep(*key_args))
                eng._superstep_fns[key] = _Eager(eng._superstep_fns[key])
            torch.cuda.synchronize()
            wall_ms, kernels = _profiled(torch, eng.step)
            busy = sum(ms for _, ms, _ in kernels)
            if busy <= 0 or eng._compiled_supersteps != built:
                fail(f"serve_graphs {name} {kind}: profiled busy {busy} ms, "
                     f"{eng._compiled_supersteps - built} programs built in the window")
            profiles[kind] = dict(wall_ms=wall_ms, busy_ms=busy,
                                  idle_share=max(0.0, 1.0 - busy / wall_ms))
        del eng
        emit("serve_graphs", model=dc.backbone.name, layers=dc.backbone.n_layers, run=name,
             requests=REQUESTS,
             slots=SLOTS, theta=THETA, K=K, noise_mode="counter", **cfg,
             keys=g["keys"], capture_ms=capture_ms, rounds=g["rounds"],
             launches_per_round={k: v / g["rounds"] for k, v in g["launches"].items() if v},
             graph=dict(wall_s=g["wall_s"], samples_per_s=REQUESTS / g["wall_s"],
                        round_wall_ms=g["wall_s"] / g["rounds"] * 1e3,
                        peak_bytes=g["peak_bytes"], reserved_bytes=g["reserved_bytes"],
                        superstep_profile=profiles["graph"]),
             eager=dict(superstep_profile=profiles["eager"], **({} if e is None else dict(
                 wall_s=e["wall_s"], samples_per_s=REQUESTS / e["wall_s"],
                 round_wall_ms=e["wall_s"] / e["rounds"] * 1e3,
                 peak_bytes=e["peak_bytes"], reserved_bytes=e["reserved_bytes"]))),
             gate="equal sample bits, counters, launches and keys; replay equal to the "
                  "eager body from the same states, no host sync")
        by_run[f"serve_graphs_{name}"] = g["launches"]

    # the planted fault: a fused superstep with its tier an int, baked into
    # the graph at the covering tier and replayed at a binding one
    eng = ContinuousASDEngine(model_fn, sched, event, num_slots=SLOTS, theta=THETA,
                              execution="packed", round_impl="fused", round_budget="auto",
                              rounds_per_sync=1, seed=SEED, noise_mode="counter",
                              keep_trajectory=False, num_branches=BRANCHES, device=dev)
    for r in mid:
        eng.submit(r)
    eng.step()
    top, low = eng._budget_ladder[-1], eng._budget_ladder[0]
    st = eng._states
    demand = int((st.b_live * torch.minimum(st.theta_live, K - st.a))[st.a < K].sum())
    if demand <= low:
        fail(f"serve_graphs planted fault: a demand of {demand} points does not bind tier {low}")
    cold, same, _, _ = _graph_vs_eager(torch, eng, 1, low, counters)
    if cold or not same:
        fail(f"serve_graphs planted fault: the real program at tier {low}: bits equal {same}")
    saved = _slots(eng)
    baked = eng._make_superstep(1, top)  # the tier as an int, not the 0-d tensor
    baked()  # runs at the top tier and captures it
    _set_slots(eng, saved)
    eng._budget_dev.fill_(low)
    baked()
    torch.cuda.synchronize()
    faulty = _slots(eng)
    _set_slots(eng, saved)
    eng._budget_dev.fill_(low)
    eng._get_superstep(1, low).body()
    torch.cuda.synchronize()
    caught = not _same_slots(torch, faulty, _slots(eng))
    if not caught:
        fail("serve_graphs: a graph with the tier baked in passed the gate")
    emit("serve_graphs_planted_fault", branches=BRANCHES, captured_tier=top, replayed_tier=low,
         demand=demand, caught=caught, proposals_faulty=faulty["proposals"].tolist(),
         proposals_right=eng._states.proposals.tolist(),
         note="a fused superstep captured with its tier as a Python int and replayed at "
              "another tier must differ from the eager body there")
    del eng, baked

    # the serve CLI's model: replay against eager body from the same states
    # in the CLI's engine, then the CLI with graphs and eagerly, profiled
    args = serve.parser().parse_args([])
    _, cdc, cfn = serve._build(args)
    eng = ContinuousASDEngine(cfn, ddpm(args.K), (cdc.seq_len, cdc.d_data), num_slots=4,
                              theta=args.theta, eager_head=True, noise_mode="counter",
                              keep_trajectory=False, device=dev)
    for i in range(4):
        eng.submit(Request(i, key=prng.PRNGKey(1000 + i)))
    eng.step()
    eng.step()
    cold, same, replay, eager = _graph_vs_eager(torch, eng, 1, None, counters)
    if cold or not same or replay != eager:
        fail(f"serve_graphs cli: replay against eager body: bits equal {same}, launches "
             f"{replay} against {eager}")
    # the packet each replay leaves, against the eager packet, twice (the
    # two buffers); the buffers are the ones made at start-up
    pinned = [h.data_ptr() for h in eng._info_out]
    packet_same = []
    for _ in range(2):
        eng._launch_superstep(1, None)
        host, ready, samples = eng._sync_packet()
        want_info, want_samples = _eager_packet(torch, eng)
        ready.synchronize()
        packet_same.append(torch.equal(host, want_info) and _bits(torch, samples, want_samples))
    if not all(packet_same) or [h.data_ptr() for h in eng._info_out] != pinned:
        fail(f"serve_graphs cli: packet equal to the eager packet {packet_same}")
    cli_capture = _check_programs(eng, "serve_graphs cli")
    del eng
    # admission at widths 1, 2 and 4 (3 padded), each a program, against the
    # per-field writes, on a fresh engine
    eng = ContinuousASDEngine(cfn, ddpm(args.K), (cdc.seq_len, cdc.d_data), num_slots=4,
                              theta=args.theta, eager_head=True, noise_mode="counter",
                              keep_trajectory=False, device=dev)
    admit_same, rid = {}, 0
    for n in (1, 2, 3):
        placed = [(slot, Request(rid + slot, key=prng.PRNGKey(1200 + rid + slot)))
                  for slot in range(n)]
        rid += n
        saved = _slots(eng)
        eng._admit(placed)
        got = _slots(eng)
        _set_slots(eng, saved)
        _eager_admit(torch, eng, placed)
        admit_same[n] = _same_slots(torch, got, _slots(eng))
    admit_progs = {w: p.graph is not None for w, p in eng._admit_fns.items()}
    if not all(admit_same.values()) or sorted(admit_progs) != [1, 2, 4] or not all(
            admit_progs.values()) or len(admit_progs) > eng._admit_bound():
        fail(f"serve_graphs cli: admission equal to the per-field writes {admit_same}, "
             f"programs {admit_progs}")
    admit_capture = {w: p.capture_ms for w, p in eng._admit_fns.items()}
    del eng
    # a warm serve, unprofiled: the CLI's engine serves its 8 requests once
    # (the captures), then 8 more timed, with the host split of that serve
    warm = {}
    for kind, R in (("graph", 1), ("eager", 1), ("graph", 4)):
        cls = Eager if kind == "eager" else ContinuousASDEngine
        eng = cls(cfn, ddpm(args.K), (cdc.seq_len, cdc.d_data), num_slots=4,
                  theta=args.theta, eager_head=True, noise_mode="counter",
                  keep_trajectory=False, rounds_per_sync=R, device=dev)
        eng.serve([Request(i, key=prng.PRNGKey(1000 + i)) for i in range(SERVE_CLI_REQUESTS)])
        rounds0 = eng.stats.rounds_total
        torch.cuda.synchronize()
        with _HostSplit() as split:
            t0 = time.perf_counter()
            out = eng.serve([Request(100 + i, key=prng.PRNGKey(1100 + i))
                             for i in range(SERVE_CLI_REQUESTS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rounds = eng.stats.rounds_total - rounds0
        if len(out) != SERVE_CLI_REQUESTS:
            fail(f"serve_graphs cli warm {kind} R {R}: {len(out)} samples")
        warm[kind if R == 1 else f"{kind}_r{R}"] = dict(
            rounds_per_sync=R, wall_s=wall, rounds=rounds, round_ms=wall / rounds * 1e3,
            samples_per_s=SERVE_CLI_REQUESTS / wall, host_split=split.summary(rounds))
        del eng
    emit("serve_graphs_cli_warm", model="paper-diffusion-policy", requests=SERVE_CLI_REQUESTS,
         slots=4, theta=args.theta, K=args.K, **warm,
         note="a second serve of 8 requests by a warm engine, no profiler: wall over its "
              "rounds; host_split is each boundary part's host ms in that serve (the "
              "harvest includes its wait for the packet)")
    del cfn
    emit("serve_graphs_boundary", model="paper-diffusion-policy",
         packet_equal=packet_same, admission_equal=admit_same,
         admission_capture_ms=admit_capture,
         gate="the in-program packet bit-equal to the eager packet in both buffers, no "
              "pinned buffer made after start-up; admission programs at widths 1, 2 and 4 "
              "bit-equal to one init_chain_state a request written field by field")
    summaries = {}
    argv = ["--profile-supersteps", str(GRAPH_CLI_PROFILE),
            "--profile-dir", str(ROOT / "build" / "serve_graphs_profile")]
    for kind, R in (("graph", 1), ("eager", 1), ("graph", 4)):
        _zero_counters(torch, counters)
        base = _fresh_memory(torch)
        if kind == "eager":
            serve.ContinuousASDEngine = Eager
        try:
            with _HostSplit() as split:
                summary = serve.main(argv + ["--rounds-per-sync", str(R)])
        finally:
            serve.ContinuousASDEngine = ContinuousASDEngine
        torch.cuda.synchronize()
        prof = summary["profile"]
        if not summary["finite"] or prof["programs_built"] or not prof["device_busy_ms"]:
            fail(f"serve_graphs cli {kind} R {R}: finite {summary['finite']}, profile {prof}")
        rounds_profiled = prof["supersteps"] * R
        name = kind if R == 1 else f"{kind}_r{R}"
        summaries[name] = dict(
            rounds_per_sync=R, samples_per_s=SERVE_CLI_REQUESTS / summary["wall_time_s"],
            round_ms=prof["wall_ms"] / rounds_profiled,
            device_busy_ms_per_round=prof["device_busy_ms"] / rounds_profiled,
            device_idle_share=prof["device_idle_share"], rounds=summary["rounds_total"],
            accept_rate=summary["accept_rate"], peak_bytes=torch.cuda.max_memory_allocated()
            - base, launches=_launches(counters),
            host_split=split.summary(summary["rounds_total"]))
        if kind == "graph":  # the eager run is the comparison, not the main path
            by_run[f"serve_graphs_cli_r{R}"] = summaries[name]["launches"]
    g, e = summaries["graph"], summaries["eager"]
    if (g["rounds"], g["accept_rate"], g["launches"]) != (e["rounds"], e["accept_rate"],
                                                           e["launches"]):
        fail(f"serve_graphs cli: graphs {g} against eager {e}")
    emit("serve_graphs_cli", model="paper-diffusion-policy", argv=argv,
         capture_ms=cli_capture, graph=g, eager=e, graph_r4=summaries["graph_r4"],
         round_ms_ratio=e["round_ms"] / g["round_ms"],
         samples_per_s_ratio=g["samples_per_s"] / e["samples_per_s"],
         note="host_split: host ms of each boundary part over the whole serve.main run "
              "(warm pool, profiled window and timed serve); the harvest includes its wait "
              "for the packet")
    return by_run


def check_serve_reference(torch, dev):
    """The engine on a small denoiser, on the card and on the CPU, with the
    same injected noise, in both round_impls: counters equal, samples
    within 2e-3, at least one rejection."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.weights import init_denoiser_params

    dc = paper_diffusion_policy_smoke()
    k, theta, slots, n = 16, 4, 3, 5
    sched = sl_geometric(k, 0.05, 50.0)
    gen = torch.Generator().manual_seed(SEED)
    noise = [(torch.rand(k + theta + 1, generator=gen),
              torch.randn(k + theta + 1, dc.seq_len, dc.d_data, generator=gen))
             for _ in range(n)]
    for impl in ("packed", "fused"):
        out = {}
        for where in ("cpu", dev):
            fn = make_sl_model_fn(init_denoiser_params(dc, SEED, out_scale=1.0, device=where),
                                  dc)
            eng = ContinuousASDEngine(fn, sched, (dc.seq_len, dc.d_data), num_slots=slots,
                                      theta=theta, execution="packed", round_budget=5,
                                      rounds_per_sync=2, round_impl=impl, device=where)
            samples = eng.serve([Request(i, u_buf=u, xi_buf=xi)
                                 for i, (u, xi) in enumerate(noise)])
            out[str(where)] = (samples, {m.rid: (m.rounds, m.head_calls, m.accepts,
                                                 m.proposals)
                                         for m in eng.stats.per_request})
        (s_cpu, c_cpu), (s_card, c_card) = out["cpu"], out[str(dev)]
        if c_cpu != c_card:
            fail(f"serve_reference {impl}: counters differ between card and CPU")
        err = max(float(np.abs(s_card[r] - s_cpu[r]).max()) for r in range(n))
        accepts = sum(c[2] for c in c_cpu.values())
        proposals = sum(c[3] for c in c_cpu.values())
        if not err <= 2e-3 or not accepts < proposals:
            fail(f"serve_reference {impl}: sample error {err} or no rejection")
        emit("serve_reference", round_impl=impl, model=dc.backbone.name, K=k, theta=theta,
             slots=slots, requests=n, round_budget=5, max_abs_err=err, tolerance=2e-3,
             accepts=accepts, proposals=proposals)


# ---------------------------------------------------------------- phase 5b
# counter noise, the serve CLI and its engine


PRNG_SHAPES = {"pixel_event": (1024, 192), "1": (1,), "5": (5,), "4097": (4097,)}


def _ulps(torch, a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def check_prng(torch, dev):
    """The port's threefry on the card against the CPU for a batch of keys:
    keys, splits, folds, bits and uniforms equal bit for bit, normals within
    ``prng.NORMAL_ULPS``; then one round's counter window at paper-pixel-dit
    (4 slots x theta 8 x (1024, 192)): card against CPU, and its time."""
    from repro_torch.core import prng
    from repro_torch.core.asd import _noise_window, init_chain_state
    from repro_torch.core.schedules import sl_geometric

    keys = prng.split(prng.PRNGKey(SEED + 11), SLOTS)
    normal_ulps = {}
    for name, shape in PRNG_SHAPES.items():
        for what, fn in (("split", lambda k: prng.split(k, 4)),
                         ("fold_in", lambda k: prng.fold_in(k, 2**31 + 5)),
                         ("random_bits", lambda k, s=shape: prng.random_bits(k, s))):
            if not torch.equal(fn(keys.to(dev)).cpu(), fn(keys)):
                fail(f"prng: {what} at {shape} differs between card and CPU")
        u_card, u_cpu = prng.uniform(keys.to(dev), shape).cpu(), prng.uniform(keys, shape)
        if not torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32)):
            fail(f"prng: uniform at {shape} differs between card and CPU")
        normal_ulps[name] = _ulps(torch, prng.normal(keys.to(dev), shape).cpu(),
                                  prng.normal(keys, shape))
    event = PRNG_SHAPES["pixel_event"]
    sched = sl_geometric(K, t_min=0.05, t_max=50.0)
    states = {}
    for where in ("cpu", dev):
        states[str(where)] = init_chain_state(
            sched.to(where), torch.zeros((SLOTS,) + event, device=where), THETA, False,
            key=keys.to(where), noise_mode="counter")
        states[str(where)].a.copy_(torch.tensor([0, 9, 31, 56]))
    (u_cpu, xi_cpu) = _noise_window(states["cpu"], THETA, "counter")
    (u_card, xi_card) = _noise_window(states[str(dev)], THETA, "counter")
    if not torch.equal(u_card.cpu().view(torch.int32), u_cpu.view(torch.int32)):
        fail("prng: the counter window's uniforms differ between card and CPU")
    normal_ulps["window"] = _ulps(torch, xi_card.cpu(), xi_cpu)
    if max(normal_ulps.values()) > prng.NORMAL_ULPS:
        fail(f"prng: normals {normal_ulps} ulps from the CPU's, bound {prng.NORMAL_ULPS}")
    st = states[str(dev)]
    window = lambda: _noise_window(st, THETA, "counter")  # noqa: E731
    ms = cold_ms(window, reps=10)
    dev_ms, lost = device_ms(window, reps=5)
    n = SLOTS * THETA * math.prod(event)
    emit("prng", shapes={k: list(v) for k, v in PRNG_SHAPES.items()}, keys=SLOTS,
         equal_bits=["split", "fold_in", "random_bits", "uniform"],
         normal_max_ulps=normal_ulps, normal_ulp_bound=prng.NORMAL_ULPS,
         window_shape=[SLOTS, THETA, *event], window_elements=n, window_ms=ms,
         window_device_ms=dev_ms, window_device_records_lost=lost,
         note="one round's counter window (u and xi of theta steps of every slot), "
              "plain torch ops; each call after an L2 flush")
    return dev_ms


def check_cli_kernels(torch, dev):
    """B1 and B2 (bf16, the wgmma kernel) against their plain versions at
    the shapes the serve CLI's default model gives them: GRS rows of 4 slots
    x theta 8 at D = 16 x 14 = 224 (one block a row), and the unpacked
    verification call's attention, 4 slots x (theta 8 + the eager head) =
    36 points of 16 tokens, 8 heads of 64 (one 128-row tile at 12.5 %).
    Times cold-cache as in phase 3; the library call is SDPA (bf16)."""
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma
    from repro_torch.kernels.grs.ops import grs

    dc = get_denoiser_config("paper-diffusion-policy")
    cfg = dc.backbone
    R, D = SLOTS * THETA, dc.seq_len * dc.d_data
    args = _grs_inputs(torch, dev, R, D, 51)
    err, accepted = _grs_compare(torch, args)
    times = kernel_times(lambda: grs(*args), lambda: grs_plain(*args), wrapper=grs)
    bms, by = _grs_bound(R, D)
    out = {"grs": dict(shape=[R, D], max_abs_err=err, **times, bound_ms=bms, bound_by=by,
                       geometry=_row_geometry(R, D))}
    emit("cli_kernels", kernel="grs", accepted_rows=accepted, **out["grs"])
    B, L, H, hd = SLOTS * (THETA + 1), dc.seq_len, cfg.n_heads, cfg.d_model // cfg.n_heads
    q, k, v = _flash_inputs(torch, dev, B, L, L, H, hd, 52)
    ok = flash_mha(q, k, v, causal=False)
    op = attention_plain(q, k, v, causal=False)
    used = _flash_tolerance_used(ok, op)
    if not used <= 1.0:
        fail(f"cli_kernels: B2 used {used} of the tolerance at {(B, L, H, hd)}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = kernel_times(lambda: flash_mha(q, k, v, causal=False),
                         lambda: attention_plain(q, k, v, causal=False),
                         lambda: sdpa(qt, kt, vt), wrapper=flash_wgmma)
    bms, by = bound_ms(4.0 * B * L * H * hd * 2, 4.0 * B * H * L * L * hd, PEAK_BF16)
    out["flash_attention"] = dict(shape=[B, L, H, hd], dtype="bfloat16",
                                  max_abs_err=(ok.float() - op.float()).abs().max().item(),
                                  tolerance_used=used, **times, bound_ms=bms, bound_by=by,
                                  library="scaled_dot_product_attention")
    emit("cli_kernels", kernel="flash_attention", **out["flash_attention"])
    return out


def check_branched_kernels(torch, dev):
    """B1-B6 against their plain versions at the shapes branched rounds give
    them, timed as in phase 3: GRS over (S x B x theta) rows (the CLI's 64
    and 128 rows of 224 at B 2 and 4; paper-pixel-dit's 64 rows of
    196,608 at B 2), B2 at the verification calls (the CLI's 72 and 144
    points of 16 tokens; pixel-dit's budget 64 plus 8 head lanes, 72
    points of 1024 tokens), and B3-B6 over pixel-dit's 64-row branch
    tables, with a packed batch of 64 (58 live rows, 6 padding).  Each row
    names the main-path runs at its shape, and the share of a run's
    launches made there (B2: the verification call, half a round's)."""
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.kernels.pack.ops import (gather_rows, gather_rows_plain, scatter_rows,
                                              scatter_rows_plain)
    from repro_torch.kernels.superstep.ops import (fused_gather, fused_gather_plain,
                                                   fused_verify_commit,
                                                   fused_verify_commit_plain)
    from repro_torch.serving.packing import build_branched_pack_maps

    cli = get_denoiser_config("paper-diffusion-policy")
    cli_D, cli_L = cli.seq_len * cli.d_data, cli.seq_len
    cli_H, cli_hd = cli.backbone.n_heads, cli.backbone.d_model // cli.backbone.n_heads
    pix_D = 1024 * 192
    rows = []

    def row(name, at, source, replaces, runs, err, times, nbytes, ops, peak, **extra):
        bms, by = bound_ms(nbytes, ops, peak)
        line = dict(name=name, at=at, route="cuda", source=source, replaces=replaces,
                    max_abs_err=err, **times, bound_ms=bms, bound_by=by, runs=runs, **extra)
        emit("branched_kernels", **line)
        rows.append(line)

    for at, R, D, runs in (
            ("serve CLI, B 2: (64, 224)", SLOTS * 2 * THETA, cli_D,
             {"serve_cli_branched_branches_2": 1.0}),
            ("serve CLI, B 4: (128, 224)", SLOTS * 4 * THETA, cli_D,
             {"serve_cli_branched_branches_4_gain": 1.0}),
            ("paper-pixel-dit, B 2: (64, 196608)", CHAINS * BRANCHES * THETA, pix_D,
             {f"branched_asd_b{BRANCHES}": 1.0,
              f"branched_serve_packed_b{BRANCHED_BUDGETS[-1]}": 1.0})):
        args = _grs_inputs(torch, dev, R, D, 60 + R)
        err, _ = _grs_compare(torch, args)
        times = kernel_times(lambda: grs(*args), lambda: grs_plain(*args), wrapper=grs)
        row("grs", at, "src/repro_torch/csrc/grs.cu", "src/repro/kernels/grs/kernel.py:27",
            runs, err, times, 4.0 * R * D * 4 + 3 * R * 4, 10.0 * R * D, PEAK_F32,
            geometry=_row_geometry(R, D))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for at, B, L, H, hd, runs in (
            ("serve CLI verification, B 2: (72, 16, 8, 64)", SLOTS * 2 * (THETA + 1), cli_L,
             cli_H, cli_hd, {"serve_cli_branched_branches_2": 0.5}),
            ("serve CLI verification, B 4: (144, 16, 8, 64)", SLOTS * 4 * (THETA + 1), cli_L,
             cli_H, cli_hd, {"serve_cli_branched_branches_4_gain": 0.5}),
            ("paper-pixel-dit packed verification, B 2 budget 64: (72, 1024, 16, 64)",
             BRANCHED_BUDGETS[-1] + SLOTS * BRANCHES, 1024, 16, 64,
             {f"branched_serve_{impl}_b{BRANCHED_BUDGETS[-1]}": 0.5
              for impl in ("packed", "fused")})):
        q, k, v = _flash_inputs(torch, dev, B, L, L, H, hd, 70 + B)
        ok = flash_mha(q, k, v, causal=False)
        op = attention_plain(q, k, v, causal=False)
        used = _flash_tolerance_used(ok, op)
        if not used <= 1.0:
            fail(f"branched_kernels: B2 used {used} of the tolerance at {(B, L, H, hd)}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        times = kernel_times(lambda: flash_mha(q, k, v, causal=False),
                             lambda: attention_plain(q, k, v, causal=False),
                             lambda: sdpa(qt, kt, vt), reps=5 if L > 64 else 20,
                             wrapper=flash_wgmma)
        row("flash_attention", at, FLASH_WGMMA_SOURCE, FLASH_REPLACES, runs,
            (ok.float() - op.float()).abs().max().item(), times, 4.0 * B * L * H * hd * 2,
            4.0 * B * H * L * L * hd, PEAK_BF16, dtype="bfloat16", tolerance_used=used,
            library="scaled_dot_product_attention")
        del q, k, v, ok, op

    # pixel-dit's branch tables: 4 slots x 2 branches x theta 8 rows; the
    # covering budget packs 58 live rows and 6 padding lanes
    N, M, ev = SLOTS * BRANCHES * THETA, BRANCHED_BUDGETS[-1], (1024, 192)
    maps = build_branched_pack_maps(torch.tensor([8, 8, 8, 5], device=dev),
                                    torch.full((SLOTS,), BRANCHES, device=dev), M)
    gidx = torch.where(maps.valid, (maps.slot_id * BRANCHES + maps.branch_id) * THETA
                       + maps.step_id, 0)
    sidx = maps.row_id(BRANCHES, THETA)
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    tbls = [torch.randn((N,) + ev, generator=g, device=dev) for _ in range(3)]
    sc = torch.randn(N, 5, generator=g, device=dev)
    vals = torch.randn((M,) + ev, generator=g, device=dev)
    at = f"paper-pixel-dit, B 2 budget 64: {N}-row tables, {M} packed rows"
    packed = {f"branched_serve_packed_b{M}": 1.0}
    fused = {f"branched_serve_fused_b{M}": 1.0}
    # B3's bytes: each row its indices name read once (the padding lanes
    # name row 0 again), every packed row written once
    unique = int(torch.unique(gidx).numel())
    for name, fn, plain, lib, nbytes, replaces, runs in (
            ("gather_rows", lambda: gather_rows(tbls[0], gidx),
             lambda: gather_rows_plain(tbls[0], gidx),
             lambda: torch.index_select(tbls[0], 0, gidx),
             (unique + M) * pix_D * 4.0 + M * 8, "src/repro/kernels/pack/kernel.py:31", packed),
            ("scatter_rows", lambda: scatter_rows(vals, sidx, N),
             lambda: scatter_rows_plain(vals, sidx, N), None,
             M * pix_D * 4.0 + N * pix_D * 4 + M * 8, "src/repro/kernels/pack/kernel.py:59",
             packed),
            ("fused_gather", lambda: fused_gather(*tbls, sc, gidx),
             lambda: fused_gather_plain(*tbls, sc, gidx), None,
             2.0 * (3 * M * pix_D * 4 + M * 5 * 4) + M * 8,
             "src/repro/kernels/superstep/kernel.py:42", fused)):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))):
            fail(f"branched_kernels: {name} differs from its plain version at {at}")
        times = kernel_times(fn, plain, lib, wrapper=_counters()[name])
        row(name, at, "src/repro_torch/csrc/pack.cu" if "rows" in name
            else "src/repro_torch/csrc/superstep.cu", replaces, runs, 0.0, times, nbytes, 0.0,
            PEAK_F32, tolerance="equal bits (data movement)",
            library="index_select" if lib is not None else None)
        if name == "gather_rows":
            rows[-1].update(unique_rows_read=unique,
                            flush_256mb=_b3_against_index_select(torch, fn, plain, lib, at,
                                                                 unique, M, times, nbytes))
    # B6 on inputs where the target sits near the proposal (some accepts)
    y, gg, xi = (torch.randn((M,) + ev, generator=g, device=dev) for _ in range(3))
    A = 1.0 + 0.1 * torch.rand(M, generator=g, device=dev)
    Bc = 0.5 * torch.rand(M, generator=g, device=dev)
    m = A[:, None, None] * y + Bc[:, None, None] * gg
    mh = m + 0.3 * torch.randn((M,) + ev, generator=g, device=dev) / pix_D ** 0.5
    u = torch.rand(M, generator=g, device=dev)
    sig = 0.2 + 0.3 * torch.rand(M, generator=g, device=dev)
    args = (y, gg, xi, mh, A, Bc, u, sig, sidx, N)
    (zk, ak), (zp, ap) = fused_verify_commit(*args), fused_verify_commit_plain(*args)
    torch.cuda.synchronize()
    err = (zk - zp).abs().max().item()
    live = sidx < N
    near = torch.zeros(N, dtype=torch.bool, device=dev)
    near[sidx[live]] = _near_threshold(torch, u, xi, mh, m, sig)[live]
    if not (err <= 1e-5 and torch.equal(ak[~near], ap[~near])):
        fail(f"branched_kernels: fused_verify_commit z error {err} or accept bits differ "
             "away from the threshold")
    times = kernel_times(lambda: fused_verify_commit(*args),
                         lambda: fused_verify_commit_plain(*args),
                         wrapper=fused_verify_commit)
    row("fused_verify_commit", at, "src/repro_torch/csrc/superstep.cu",
        "src/repro/kernels/superstep/kernel.py:84", fused, err, times,
        4.0 * M * pix_D * 4 + 4 * M * 4 + M * 8 + N * pix_D * 4 + N * 4, 12.0 * M * pix_D,
        PEAK_F32, tolerance="z atol 1e-5; accept bits equal except rows within 1e-5 of the "
        "threshold", accepted_rows=int(ak.sum()),
        geometry=_row_geometry(M, pix_D))
    return rows


def _b3_against_index_select(torch, fn, plain, lib, at, unique, M, times, nbytes):
    """B3 and ``index_select`` at pixel-dit's branched shape timed again
    with a 256 MB flush, five times the 50 MB table, where the 64 MB flush
    is about one table: the phase line ``b3_index_select`` gives both
    flushes' times, the bound of the rows these indices read, and whether
    B3 is the slower by device time.  Returns the 256 MB times."""
    from repro_torch.kernels.pack.ops import gather_rows

    big = kernel_times(fn, plain, lib, wrapper=gather_rows, flush_bytes=256 << 20)
    bms, _ = bound_ms(nbytes, 0.0, PEAK_F32)
    keys = ("ms", "device_ms", "device_records_lost", "library_ms", "library_device_ms",
            "library_device_records_lost")
    slower = {flush: (t["device_ms"] > t["library_device_ms"]
                      if t["device_ms"] is not None and t["library_device_ms"] is not None
                      else "not recorded")
              for flush, t in (("64mb", times), ("256mb", big))}
    emit("b3_index_select", at=at, unique_rows_read=unique, packed_rows=M, bound_ms=bms,
         bound_by="bytes", flush_64mb={k: times[k] for k in keys},
         flush_256mb={k: big[k] for k in keys}, b3_slower_by_device_time=slower,
         note="bound: the unique rows the indices name read once, every packed row "
              "written once, the indices read")
    return {k: big[k] for k in keys}


# launches of each kernel per round on the serve CLI's default model (bf16,
# so B2 is the wgmma kernel): unpacked rounds and the fused engine run B1 and
# B2 only; the packed round adds B3 and B4, the fused round B5 and B6
def _cli_per_round(n_layers, round_impl):
    flash = {"flash_attention": 2 * n_layers}
    if round_impl == "packed":
        return {**flash, "grs": 1, "gather_rows": 3, "scatter_rows": 1}
    if round_impl == "fused":
        return {**flash, "fused_gather": 1, "fused_verify_commit": 1}
    return {**flash, "grs": 1}


SERVE_CLI_PROFILE = 8  # warm supersteps under torch.profiler
SERVE_CLI_REQUESTS = 8  # the CLI's default --chains
SERVE_CLI_RUNS = (
    ("default", []),
    ("engine_fused", ["--engine", "fused"]),
    ("packed", ["--execution", "packed", "--round-budget", "24", "--round-impl", "packed"]),
    ("packed_fused_round", ["--execution", "packed", "--round-budget", "24",
                            "--round-impl", "fused"]),
    ("aimd", ["--theta-controller", "aimd"]),
    ("accept_rate", ["--theta-controller", "accept-rate"]),
    ("rounds_per_sync_4", ["--rounds-per-sync", "4"]),
    ("metrics", ["--metrics-port", "0"]),
    ("trace", ["--trace-out", str(ROOT / "build" / "serve_cli_trace.json")]),
    ("profile", ["--profile-supersteps", str(SERVE_CLI_PROFILE),
                 "--profile-dir", str(ROOT / "build" / "serve_cli_profile")]),
)


def _profiled_run(name):
    return ["--profile-supersteps", str(SERVE_CLI_PROFILE),
            "--profile-dir", str(ROOT / "build" / f"serve_cli_{name}_profile")]


# branched speculation at the CLI's defaults, each profiled as the B 1
# "profile" run is (the line compares them)
SERVE_CLI_BRANCHED_RUNS = (
    ("branches_2", ["--num-branches", "2", *_profiled_run("branches_2")]),
    ("branches_4_gain", ["--num-branches", "4", "--branch-controller", "gain",
                         *_profiled_run("branches_4_gain")]),
    ("branches_2_packed_fused_round", ["--execution", "packed", "--round-impl", "fused",
                                       "--num-branches", "2",
                                       *_profiled_run("branches_2_packed_fused_round")]),
)


def _cli_numbers(summary):
    """samples/s over the serve's wall, a round's ms (a profiled warm
    superstep of one round), the idle share, branch depth and waste."""
    prof = summary.get("profile") or {}
    n = prof.get("supersteps") or 0
    return dict(samples_per_s=SERVE_CLI_REQUESTS / summary["wall_time_s"],
                round_ms=prof["wall_ms"] / n if n else None,
                device_idle_share=prof.get("device_idle_share"),
                rounds=summary["rounds_total"],
                branch_accept_depth=summary["branch_accept_depth"],
                wasted_draft_frac=summary["wasted_draft_frac"])


def run_serve_cli(torch, dev, runs=SERVE_CLI_RUNS, phase="serve_cli", reference=None):
    """``repro_torch.launch.serve.main`` on the card at the CLI's defaults
    (paper-diffusion-policy at full width, 8 requests, 4 slots, theta 8,
    K 100, continuous, unpacked, counter noise), then each variant: the
    launches of every kernel per round, finite samples, and the summary.
    Returns the launches and the summaries by run; with ``reference`` (a
    summary) each line also gives its numbers beside the reference's."""
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.launch import serve

    n_layers = get_denoiser_config("paper-diffusion-policy").backbone.n_layers
    counters = _counters()
    by_run, summaries = {}, {}
    for name, argv in runs:
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        summary = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches(counters)
        impl = (None if "--execution" not in argv
                else argv[argv.index("--round-impl") + 1])
        rounds = summary["rounds_total"]
        want = {k: 0 for k in launches}
        want.update({k: n * rounds for k, n in _cli_per_round(n_layers, impl).items()})
        if launches != want:
            fail(f"{phase} {name}: launches {launches}, expected {want} for {rounds} rounds")
        if not summary["finite"]:
            fail(f"{phase} {name}: samples not finite")
        extra = {}
        if name == "metrics":
            if summary["metrics"]["healthz"] != "ok" or summary["metrics"]["samples"] < 10:
                fail(f"serve_cli metrics: self-scrape {summary['metrics']}")
            extra["metrics"] = summary["metrics"]
        if name == "trace":
            extra["trace"] = summary["trace"]
        if "--profile-supersteps" in argv:
            prof = summary["profile"]
            if (prof["device_idle_share"] is None or prof["supersteps"] != SERVE_CLI_PROFILE
                    or prof["programs_built"]):
                fail(f"{phase} {name}: profile {prof} (the window must hold replays only)")
            extra["profile"] = prof
        if reference is not None:
            numbers = _cli_numbers(summary)
            extra.update({k: numbers[k] for k in ("round_ms", "device_idle_share",
                                                  "branch_accept_depth", "wasted_draft_frac")},
                         b1=_cli_numbers(reference))
        # the requests the timed serve answered over its wall (a profiled
        # run's warm pool retires outside it but lands in the engine's stats)
        emit(phase, variant=name, argv=argv, model="paper-diffusion-policy",
             samples_per_s=SERVE_CLI_REQUESTS / summary["wall_time_s"],
             accept_rate=summary["accept_rate"],
             mean_live_window=summary["mean_window"], rounds=rounds,
             supersteps=summary.get("supersteps"), wall_s=wall,
             serve_wall_s=summary["wall_time_s"], launches=launches, **extra)
        by_run[f"{phase}_{name}"] = launches
        summaries[name] = summary
    return by_run, summaries


# the K 1000 cell's buffers: xi of (K + theta + 1) steps a slot, float32
MEMORY_K = 1000


def run_serve_counter_memory(torch, dev, model_fn, dc, window_device_ms):
    """paper-pixel-dit through the serve CLI's engine (counter noise, eager
    head, live window) at 4 slots and theta 8, in counter and in buffer
    mode: 6 requests to completion at K 64 (round wall ms), one warm round
    profiled (the counter window's share of its busy time), then 4 requests
    admitted at K 1000 and 2 supersteps run: peak device memory.  Counter
    mode's peak must lie below buffer mode's by 90 % of the buffers' bytes."""
    import gc

    from repro_torch.core import prng
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.serving.engine import ContinuousASDEngine, Request

    counters = _counters()
    event = (dc.seq_len, dc.d_data)
    by_run, walls = {}, {}

    def engine(k, mode):
        return ContinuousASDEngine(model_fn, sl_geometric(k, t_min=0.05, t_max=50.0), event,
                                   num_slots=SLOTS, theta=THETA, eager_head=True,
                                   noise_mode=mode, keep_trajectory=False, device=dev)

    for mode in ("counter", "buffer"):
        eng = engine(K, mode)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        out = eng.serve([Request(i, key=prng.PRNGKey(1000 + i)) for i in range(REQUESTS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(out) != list(range(REQUESTS)) or not all(
                np.isfinite(v).all() and v.shape == event for v in out.values()):
            fail(f"serve_counter_memory {mode}: samples missing, misshapen or not finite")
        rounds = eng.stats.rounds_total
        launches = _launches(counters)
        per = _cli_per_round(dc.backbone.n_layers, None)
        if any(launches[k] != n * rounds for k, n in per.items()):
            fail(f"serve_counter_memory {mode}: launches {launches} for {rounds} rounds")
        walls[mode] = wall / rounds * 1e3
        by_run[f"serve_{mode}_k{K}"] = launches
        extra = {}
        if mode == "counter":
            for r in range(SLOTS):
                eng.submit(Request(100 + r, key=prng.PRNGKey(3000 + r)))
            eng.step()
            torch.cuda.synchronize()
            wall_ms, kernels = _profiled(torch, eng.step)
            busy = sum(ms for _, ms, _ in kernels)
            extra = dict(profiled_round_wall_ms=wall_ms, profiled_round_busy_ms=busy,
                         counter_window_device_ms=window_device_ms,
                         counter_window_share_of_busy=(window_device_ms / busy
                                                       if busy and window_device_ms else None))
        emit("serve_counter_memory", K=K, noise_mode=mode, requests=REQUESTS, slots=SLOTS,
             theta=THETA, rounds=rounds, supersteps=eng.stats.supersteps, wall_s=wall,
             round_wall_ms=walls[mode], samples_per_s=REQUESTS / wall,
             accept_rate=eng.stats.accept_rate(), launches=launches, **extra)
        del eng, out
    peaks = {}
    for mode in ("counter", "buffer"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = engine(MEMORY_K, mode)
        for i in range(SLOTS):
            eng.submit(Request(i, key=prng.PRNGKey(2000 + i)))
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        peaks[mode] = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        if eng.stats.supersteps != 2 or eng.scheduler.queue_depth:
            fail(f"serve_counter_memory K {MEMORY_K} {mode}: not all admitted in 2 supersteps")
        emit("serve_counter_memory", K=MEMORY_K, noise_mode=mode, slots=SLOTS, theta=THETA,
             admitted=SLOTS, supersteps=2, peak_bytes_above_weights=peaks[mode],
             held_bytes_after=held, weights_bytes=base)
        del eng
    buffers = SLOTS * (MEMORY_K + THETA + 1) * math.prod(event) * 4
    saved = peaks["buffer"] - peaks["counter"]
    if saved < 0.9 * buffers:
        fail(f"serve_counter_memory: counter mode saves {saved} bytes of peak, less than "
             f"90 % of the buffers' {buffers}")
    emit("serve_counter_memory_check", K=MEMORY_K, buffers_bytes=buffers, saved_bytes=saved,
         gate="saved >= 0.9 x buffers", counter_peak=peaks["counter"],
         buffer_peak=peaks["buffer"], round_wall_ms_k64=walls)
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


SERVE_KEYS_TOL = 2e-3  # as serve_reference: float32 sums in other orders, chained
_FAULT_STEP = 3  # the planted fault draws this step's xi from the next step's key


def _off_by_one_step(torch, window):
    """A counter window whose xi of absolute step _FAULT_STEP is drawn one
    step late: the planted fault serve_keys_reference must see."""
    def faulty(st, theta, noise_mode):
        u, xi = window(st, theta, noise_mode)
        _, xi_late = window(dataclasses.replace(st, a=st.a + 1), theta, noise_mode)
        hit = st.a[:, None] + torch.arange(theta, device=st.a.device) == _FAULT_STEP
        return u, torch.where(hit.reshape(hit.shape + (1,) * (xi.ndim - 2)), xi_late, xi)
    return faulty


def check_serve_keys_reference(torch, dev):
    """The engine with counter noise on the smoke denoiser, on the card and
    on the CPU, from the same serve key and rids (odd ones keyed, even ones
    by fold_in(serve key, rid)), with the static and the aimd controller:
    per-request counters equal, samples within SERVE_KEYS_TOL; a planted
    fault (one xi draw off by one step) must exceed it."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.core import asd, prng
    from repro_torch.core.controller import make_controller
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.weights import init_denoiser_params

    dc = paper_diffusion_policy_smoke()
    k, theta, slots, n = 16, 4, 3, 5
    sched = sl_geometric(k, 0.05, 50.0)
    configs = {"static": dict(rounds_per_sync=2),
               "aimd": dict(execution="packed", round_impl="fused", round_budget=5,
                            rounds_per_sync=2)}

    def serve(where, ctl):
        fn = make_sl_model_fn(init_denoiser_params(dc, SEED, out_scale=1.0, device=where), dc)
        eng = ContinuousASDEngine(fn, sched, (dc.seq_len, dc.d_data), num_slots=slots,
                                  theta=theta, noise_mode="counter", seed=SEED + 5,
                                  controller=make_controller(ctl), device=where,
                                  **configs[ctl])
        out = eng.serve([Request(i, key=prng.PRNGKey(1000 + i) if i % 2 else None)
                         for i in range(n)])
        return out, {m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
                     for m in eng.stats.per_request}

    def error(a, b):
        if a[1] != b[1]:
            return math.inf  # counters differ
        return max(float(np.abs(a[0][r] - b[0][r]).max()) for r in range(n))

    window = asd._noise_window
    for ctl in configs:
        cpu, card = serve("cpu", ctl), serve(dev, ctl)
        err = error(card, cpu)
        accepts = sum(c[3] for c in cpu[1].values())
        proposals = sum(c[4] for c in cpu[1].values())
        if not err <= SERVE_KEYS_TOL or not accepts < proposals:
            fail(f"serve_keys_reference {ctl}: error {err} (inf: counters differ) or no "
                 "rejection")
        asd._noise_window = _off_by_one_step(torch, window)
        try:
            planted = error(serve(dev, ctl), cpu)
        finally:
            asd._noise_window = window
        if not planted > SERVE_KEYS_TOL:
            fail(f"serve_keys_reference {ctl}: the planted fault reads {planted}, within "
                 f"the tolerance {SERVE_KEYS_TOL}")
        emit("serve_keys_reference", controller=ctl, config=configs[ctl],
             model=dc.backbone.name, K=k, theta=theta, slots=slots, requests=n,
             keyed="odd rids; even rids fold_in(PRNGKey(seed), rid)", noise_mode="counter",
             max_abs_err=err, tolerance=SERVE_KEYS_TOL, accepts=accepts,
             proposals=proposals,
             planted_fault=f"xi of step {_FAULT_STEP} drawn from step {_FAULT_STEP + 1}",
             planted_fault_err=planted if math.isfinite(planted) else "counters differ")


def _branch_salt_fault(torch, branch_noise):
    """Branch noise whose branch 1 draws from salt _BRANCH_SALT + 2 (branch
    2's stream): the planted fault branched_reference must see."""
    def faulty(st, theta, num_branches):
        u, xi = branch_noise(st, theta, num_branches + 1)  # salts + 1 .. + B
        keep = slice(1, num_branches - 1)
        return (torch.cat([u[:, 1:2], u[:, keep]], dim=1),
                torch.cat([xi[:, 1:2], xi[:, keep]], dim=1))
    return faulty


def check_branched_reference(torch, dev):
    """Branched serving (B 3, counter noise) on the smoke denoiser, on the
    card and on the CPU from the same keys, with the static and the gain
    branch controller: per-request counters (drafted points included) and
    the slots' final branch counts and controller state equal, samples
    within SERVE_KEYS_TOL; a planted fault (branch 1 drawn with salt
    _BRANCH_SALT + 2) must exceed it."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.core import asd, prng
    from repro_torch.core.controller import make_branch_controller
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.weights import init_denoiser_params

    dc = paper_diffusion_policy_smoke()
    k, theta, slots, n, nb = 16, 4, 3, 5, 3
    sched = sl_geometric(k, 0.05, 50.0)
    configs = {"static": dict(rounds_per_sync=2),
               "gain": dict(execution="packed", round_impl="fused", round_budget=24,
                            rounds_per_sync=2)}

    def serve(where, ctl):
        fn = make_sl_model_fn(init_denoiser_params(dc, SEED, out_scale=1.0, device=where), dc)
        eng = ContinuousASDEngine(fn, sched, (dc.seq_len, dc.d_data), num_slots=slots,
                                  theta=theta, noise_mode="counter", seed=SEED + 6,
                                  num_branches=nb, branch_controller=make_branch_controller(ctl),
                                  device=where, **configs[ctl])
        out = eng.serve([Request(i, key=prng.PRNGKey(1100 + i) if i % 2 else None)
                         for i in range(n)])
        counts = {m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals,
                          m.draft_points) for m in eng.stats.per_request}
        final = (eng._states.b_live.tolist(), eng._states.bctrl.cpu().numpy().tobytes())
        return out, counts, final

    def error(a, b):
        if a[1:] != b[1:]:
            return math.inf  # counters, branch counts or controller state differ
        return max(float(np.abs(a[0][r] - b[0][r]).max()) for r in range(n))

    noise = asd._branch_noise
    for ctl in configs:
        cpu, card = serve("cpu", ctl), serve(dev, ctl)
        err = error(card, cpu)
        draft = sum(c[5] for c in cpu[1].values())
        proposals = sum(c[4] for c in cpu[1].values())
        if not err <= SERVE_KEYS_TOL or not draft > proposals:
            fail(f"branched_reference {ctl}: error {err} (inf: counters differ) or no "
                 "extra branch drafted")
        asd._branch_noise = _branch_salt_fault(torch, noise)
        try:
            planted = error(serve(dev, ctl), cpu)
        finally:
            asd._branch_noise = noise
        if not planted > SERVE_KEYS_TOL:
            fail(f"branched_reference {ctl}: the planted fault reads {planted}, within "
                 f"the tolerance {SERVE_KEYS_TOL}")
        emit("branched_reference", branch_controller=ctl, branches=nb, config=configs[ctl],
             model=dc.backbone.name, K=k, theta=theta, slots=slots, requests=n,
             noise_mode="counter", max_abs_err=err, tolerance=SERVE_KEYS_TOL,
             accepts=sum(c[3] for c in cpu[1].values()), proposals=proposals,
             draft_points=draft, final_b_live=cpu[2][0],
             planted_fault="branch 1 drawn with salt _BRANCH_SALT + 2",
             planted_fault_err=planted if math.isfinite(planted) else "counters differ")


# ---------------------------------------------------------------- phase 6


def _zero_counters(torch, counters):
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_design"):
            fn.launches_by_design.update(dict.fromkeys(fn.launches_by_design, 0))


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _f32_designs():
    """The launches of B2's float32 kernel by design since the last zeroing."""
    from repro_torch.kernels.flash_attention.ops import flash_f32

    return dict(flash_f32.launches_by_design)


def run_hymba(torch, dev):
    """hymba-prefill: the full-width hymba-1.5b through lm_prefill, 16
    greedy lm_decode_step calls and lm_fwd, with the launch counts of each
    run.  B7 and B2 run once per layer in the prefill and the forward and
    never in a decode step (its attention and recurrence are plain torch)."""
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import (lm_cache_init, lm_compute_params, lm_decode_step,
                                       lm_fwd, lm_prefill)
    from repro_torch.weights import init_lm_params

    cfg = get_config("hymba-1.5b")
    B, P, T = HYMBA_BATCH, HYMBA_PROMPT, HYMBA_DECODE
    t0 = time.perf_counter()
    params = init_lm_params(cfg, SEED, device=dev)
    n_params = sum(p.numel() for p in pytree.leaves(params))
    cp = lm_compute_params(params, cfg)
    del params  # the float32 copies of the cast leaves
    torch.cuda.synchronize()
    if n_params != HYMBA_PARAMS:
        fail(f"hymba: {n_params} params, expected {HYMBA_PARAMS}")
    emit("hymba_weights", model=cfg.name, params=n_params, seconds=time.perf_counter() - t0,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
         windows=list(cfg.group[0].window_per_repeat), seed=SEED,
         compute_dtype=cfg.compute_dtype, kv_cache_dtype="bfloat16")

    counters = _counters()
    # B2 once a layer; B7 once a chunk of MAMBA_CHUNK positions a layer (the
    # prefill's 4096: 4 a layer; the forward's 4112: 5)
    want = {run: dict({name: 0 for name in counters}, flash_attention=cfg.n_layers,
                      ssm_scan=cfg.n_layers * -(-n // MAMBA_CHUNK))
            for run, n in (("hymba_prefill", P), ("hymba_forward", P + T))}
    want["hymba_decode"] = {name: 0 for name in counters}
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    runs, wall = {}, {}
    with torch.no_grad():
        caches = lm_cache_init(cp, cfg, B, P + T)
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        logits, caches = lm_prefill(cp, prompt, caches, cfg)
        torch.cuda.synchronize()
        wall["prefill_s"] = time.perf_counter() - t0
        runs["hymba_prefill"] = _launches(counters)
        prefilled = pytree.map(torch.clone, caches)

        steps, seq = [logits[:, 0].float()], [prompt]
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        for i in range(T):
            tok = steps[-1].argmax(-1)
            seq.append(tok[:, None])
            logits, caches = lm_decode_step(cp, tok, caches, P + i, cfg)
            steps.append(logits[:, 0].float())
        torch.cuda.synchronize()
        wall["decode_s"] = time.perf_counter() - t0
        runs["hymba_decode"] = _launches(counters)

        seq = torch.cat(seq, dim=1)  # (B, P + T): the prompt and T greedy tokens
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        full = lm_fwd(cp, seq, cfg)
        torch.cuda.synchronize()
        wall["forward_s"] = time.perf_counter() - t0
        runs["hymba_forward"] = _launches(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for run, expected in want.items():
        if runs[run] != expected:
            fail(f"hymba: {run} launched {runs[run]}, expected {expected}")
    dec = torch.stack(steps, dim=1)  # logits at positions P-1 .. P+T-1
    ref = full[:, P - 1:].float()
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    rel = _rel_l2(dec, ref)
    agree = (dec.argmax(-1) == ref.argmax(-1)).float().mean().item()
    graph_decode = _captured_decode(torch, dev, cp, cfg, prefilled, steps, P, counters)
    with torch.no_grad():
        planted = _planted_decode_faults(torch, cp, cfg, prompt, seq, prefilled, dec[:, 0],
                                         ref)
    del prefilled
    if not (finite and tuple(full.shape) == (B, P + T, cfg.vocab_size)
            and rel <= HYMBA_BF16_GATE
            and all(planted[name] > HYMBA_BF16_GATE for name in HYMBA_BF16_SEES)):
        fail(f"hymba: finite={finite}, forward {tuple(full.shape)}, decode vs forward "
             f"relative L2 {rel}, planted faults {planted} (the gate {HYMBA_BF16_GATE} "
             f"must hold the first and not {HYMBA_BF16_SEES})")
    emit("hymba_decode_graph", model=cfg.name, batch=B, prompt=P, decode_steps=T,
         **graph_decode, gate="tokens equal and logits bit-equal to the eager greedy decode; "
         "no kernel of the port launched")
    emit("hymba", model=cfg.name, batch=B, prompt=P, decode_steps=T, cache_len=P + T,
         launches=runs, finite=finite, decode_vs_forward_relative_l2=rel,
         decode_vs_forward_max_abs_err=(dec - ref).abs().max().item(),
         planted_faults_relative_l2=planted,
         logits_abs_max=ref.abs().max().item(), greedy_argmax_agreement=agree,
         tolerance=f"relative L2 {HYMBA_BF16_GATE} over the prefill's and the 16 decode "
                   "steps' logits: bf16 over 32 layers, and decode rounds elsewhere than "
                   "the forward (its attention scores and probabilities in bf16, its conv "
                   "in float32); it sees the window ignored in decode, not a one-token-"
                   "stale SSM state, which hymba_f32 (the same run in float32) sees",
         peak_memory_gb=peak_gb, first_call_wall=wall)

    # warm times: CUDA events around calls launched back to back
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: lm_prefill(cp, prompt, caches, cfg), reps=3, warmup=1)
        tok = seq[:, P]
        decode_ms = cuda_ms(lambda: lm_decode_step(cp, tok, caches, P, cfg), reps=16)
        forward_ms = cuda_ms(lambda: lm_fwd(cp, seq, cfg), reps=2, warmup=1)
        emit("hymba_times", prefill_ms=prefill_ms, prefill_tokens_per_s=B * P / prefill_ms * 1e3,
             decode_ms_per_step=decode_ms, decode_tokens_per_s=B / decode_ms * 1e3,
             forward_ms=forward_ms, forward_tokens=B * (P + T),
             note="warm; a decode step is one token for each of the 2 sequences")

        torch.cuda.synchronize()
        wall_ms, kernels = _profiled(torch, lambda: lm_prefill(cp, prompt, caches, cfg))
        _emit_profile(torch, "hymba_profile", wall_ms, kernels,
                      "one warm lm_prefill (2 x 4096 tokens, 32 layers) under torch.profiler; "
                      "'other' holds the mamba elementwise kernels, norms, RoPE and casts",
                      prefill_tokens=B * P)
        wall_ms, kernels = _profiled(torch, lambda: lm_decode_step(cp, tok, caches, P, cfg))
        _emit_profile(torch, "hymba_decode_profile", wall_ms, kernels,
                      "one warm lm_decode_step (2 sequences at position 4096) under "
                      "torch.profiler", kernel_launches=sum(n for _, _, n in kernels))
        layer = {k: v[1] for k, v in cp["decoder"]["g0"]["mamba"].items()}
        h = torch.randn(B, P, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
        from repro_torch.nn.ssm import mamba_fwd

        chunked = mamba_fwd(layer, h, cfg)
        whole = mamba_fwd(layer, h, cfg, chunk=P)
        torch.cuda.synchronize()
        same = torch.equal(chunked.view(torch.int16), whole.view(torch.int16))
        del whole
        if not same:
            fail("hymba: the mixer at chunks of 1024 and in one scan differ in bits")
        wall_ms, kernels = _profiled(torch, lambda: mamba_fwd(layer, h, cfg))
        _emit_profile(torch, "hymba_mamba_profile", wall_ms, kernels,
                      "one mamba mixer (layer 1) at the prefill shape under torch.profiler "
                      f"(B7 once a chunk of {MAMBA_CHUNK}): 'other' is its elementwise "
                      "kernels (conv, SiLU, softplus, exp, the drive product and the "
                      "carry's fold, the C readout's product and sum, the D skip, the "
                      "gate) and casts; ssm_scan is B7", scan_elements=B * P * cfg.d_inner
                      * cfg.ssm_state, chunked_equals_one_scan_bits=same)
        del caches
    runs["hymba_long_prefill"] = _hymba_long_prefill(torch, dev, cp, cfg, counters)
    return runs


def _hymba_long_prefill(torch, dev, cp, cfg, counters):
    """hymba_long_prefill: hymba-1.5b through lm_prefill at 1 x
    HYMBA_LONG_PROMPT (A11's 32k prefill cell at batch 1), the bf16 KV cache
    sized for the prompt: B7 once a chunk a layer (32 a layer), B2 once a
    layer, finite last-position logits; the peak above the weights, the
    first call's wall and a warm call by CUDA events.  Whole, the mixer's
    decay, drive and h would be (1, 32768, 25600) float32 each."""
    from repro_torch.models.lm import lm_cache_init, lm_prefill

    L = HYMBA_LONG_PROMPT
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    prompt = torch.randint(0, cfg.vocab_size, (1, L), generator=g, device=dev)
    base = _fresh_memory(torch)
    with torch.no_grad():
        caches = lm_cache_init(cp, cfg, 1, L)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        logits, caches = lm_prefill(cp, prompt, caches, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _launches(counters)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        finite = bool(torch.isfinite(logits).all())
        warm_ms = cuda_ms(lambda: lm_prefill(cp, prompt, caches, cfg), reps=1, warmup=0)
    chunks = -(-L // MAMBA_CHUNK)
    want = dict({name: 0 for name in counters}, flash_attention=cfg.n_layers,
                ssm_scan=cfg.n_layers * chunks)
    if launches != want or not finite or tuple(logits.shape) != (1, 1, cfg.vocab_size):
        fail(f"hymba_long_prefill: launches {launches} (expected {want}), finite {finite}, "
             f"logits {tuple(logits.shape)}")
    D = cfg.d_inner * cfg.ssm_state
    emit("hymba_long_prefill", model=cfg.name, batch=1, prompt=L, chunk=MAMBA_CHUNK,
         launches={k: v for k, v in launches.items() if v}, finite=finite,
         peak_above_weights_gb=peak_gb, first_call_s=first_s, warm_ms=warm_ms,
         tokens_per_s=L / warm_ms * 1e3,
         scan_tensor_gb_per_chunk=4.0 * MAMBA_CHUNK * D / 1e9,
         scan_tensor_gb_whole=4.0 * L * D / 1e9,
         note="bf16 weights and KV cache; the mixer's decay, drive and h exist a chunk at a "
              "time (scan_tensor_gb_per_chunk each) where one scan over the prompt would "
              "hold scan_tensor_gb_whole each; warm_ms by CUDA events")
    return launches


def _captured_decode(torch, dev, cp, cfg, prefilled, steps, P, counters, frames=None):
    """The greedy decode as one captured ``lm_decode_step``: the token and
    ``pos`` are device tensors, the argmax is written into the token inside
    the graph, and the graph is replayed for the decode's T steps from the
    ``prefilled`` caches (at positions P .. P + T - 1).  With ``frames`` (B,
    P + T, d_model) the step reads its input frame at ``pos`` inside the
    graph instead, and the argmax is only recorded.  Its tokens and logits
    must equal the eager decode's (``steps``: the prefill's logits row,
    then one a step, each step fed the argmax of the row before) bit for
    bit.  Then T warm replays timed by CUDA events and T profiled (the
    position reset to P between runs, so the same cache rows are written
    again)."""
    from repro_torch import pytree
    from repro_torch.models.lm import lm_decode_step
    from repro_torch.programs import SuperstepProgram

    B, T = steps[0].shape[0], len(steps) - 1
    with torch.no_grad():
        caches = pytree.map(torch.clone, prefilled)
        tok = steps[0].argmax(-1)
        pos = torch.tensor(P, device=dev)
        logits = torch.empty((T, B, cfg.vocab_size), device=dev)
        tokens = torch.empty((T, B), dtype=tok.dtype, device=dev)

        def body():
            row = (pos - P).view(1)
            tokens.index_copy_(0, row, tok[None])
            x = tok if frames is None else frames.index_select(1, pos.view(1))
            lg, _ = lm_decode_step(cp, x, caches, pos, cfg)
            lg = lg[:, 0].float()
            logits.index_copy_(0, row, lg[None])
            tok.copy_(lg.argmax(-1))
            pos.add_(1)

        prog = SuperstepProgram(body, dev)
        _zero_counters(torch, counters)
        for _ in range(T):
            prog()
        torch.cuda.synchronize()
        launches = _launches(counters)
        same_tokens = torch.equal(tokens, torch.stack([st.argmax(-1) for st in steps[:T]]))
        same_logits = all(_bits(torch, logits[i], steps[i + 1]) for i in range(T))
        if not (same_tokens and same_logits) or any(launches.values()) or int(pos) != P + T:
            fail(f"{cfg.name} decode graph: tokens equal {same_tokens}, logits bit-equal "
                 f"{same_logits}, launches {launches}, pos {int(pos)}")

        def replay_all():
            pos.fill_(P)
            tok.copy_(steps[0].argmax(-1))
            for _ in range(T):
                prog()

        replay_all()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        replay_all()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        event_ms = start.elapsed_time(end)
        prof_ms, kernels = _profiled(torch, replay_all)
    busy = sum(ms for _, ms, _ in kernels)
    # the profiler slows the host around each replay; the unprofiled idle
    # share is one minus the profiled busy time over the event-timed steps
    return dict(capture_ms=prog.capture_ms, ms_per_step=event_ms / T,
                idle_share_unprofiled=max(0.0, 1.0 - busy / event_ms) if busy else None,
                host_ms_per_step=wall_ms / T, tokens_per_s=B * T / event_ms * 1e3,
                profiled=dict(wall_ms=prof_ms, busy_ms=busy, busy_ms_per_step=busy / T,
                              idle_share=max(0.0, 1.0 - busy / prof_ms) if busy else None,
                              kernel_launches=sum(n for _, _, n in kernels),
                              top_kernels_ms_per_step=[
                                  {"name": k[:80], "ms": ms / T, "count": n // T}
                                  for k, ms, n in sorted(kernels, key=lambda e: -e[1])[:6]]),
                tokens_equal=same_tokens, logits_bit_equal=same_logits)


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def _planted_decode_faults(torch, params, cfg, prompt, seq, prefilled, first, ref):
    """Relative L2 of the decode logits against the forward's (the rows of
    ``ref``: the prefill's last position, then the decode steps) when the
    decode steps, fed ``seq``'s tokens from the ``prefilled`` caches, carry
    a planted fault: they ignore the sliding window, or start from the SSM
    state after P - 1 tokens (the prefill's h[:, -2]).  ``first`` is the
    prefill's logits row, which neither fault touches."""
    from repro_torch import pytree
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_prefill

    B, P = prompt.shape
    T = seq.shape[1] - P
    desc = cfg.group[0]
    no_window = dataclasses.replace(
        cfg, group=(dataclasses.replace(desc, window_per_repeat=(0,) * cfg.n_repeats),))
    stale = lm_cache_init(params, cfg, B, P, dtype=prefilled["g0"]["kv"]["k"].dtype)
    _, stale = lm_prefill(params, prompt[:, :P - 1], stale, cfg)
    stale_state = pytree.map(torch.clone, prefilled)
    stale_state["g0"]["ssm"]["ssm"].copy_(stale["g0"]["ssm"]["ssm"])
    del stale
    out = {}
    for name, (caches, step_cfg) in (("decode ignores the window",
                                      (pytree.map(torch.clone, prefilled), no_window)),
                                     ("SSM state one token stale", (stale_state, cfg))):
        rows = [first]
        for i in range(T):
            logits, caches = lm_decode_step(params, seq[:, P + i], caches, P + i, step_cfg)
            rows.append(logits[:, 0].float())
        out[name] = _rel_l2(torch.stack(rows, dim=1), ref)
    return out


def check_hymba_f32(torch, dev):
    """The hymba-prefill run again at full width and depth in float32 (float32
    params, compute and KV cache; B7 and B2 in float32): prefill of the same
    2 x 4096 prompt, 16 decode steps fed greedy tokens, and the forward over
    the 4112, decode logits against forward logits within a bound that
    bf16's rounding would hide faults under; both planted faults must
    exceed it."""
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_fwd, lm_prefill
    from repro_torch.weights import init_lm_params

    cfg = dataclasses.replace(get_config("hymba-1.5b"), compute_dtype="float32")
    B, P, T = HYMBA_BATCH, HYMBA_PROMPT, HYMBA_DECODE
    params = init_lm_params(cfg, SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    counters = _counters()
    with torch.no_grad():
        caches = lm_cache_init(params, cfg, B, P + T, dtype=torch.float32)
        _zero_counters(torch, counters)
        logits, caches = lm_prefill(params, prompt, caches, cfg)
        prefilled = pytree.map(torch.clone, caches)
        steps, seq = [logits[:, 0]], [prompt]
        for i in range(T):
            tok = steps[-1].argmax(-1)
            seq.append(tok[:, None])
            logits, caches = lm_decode_step(params, tok, caches, P + i, cfg)
            steps.append(logits[:, 0])
        seq = torch.cat(seq, dim=1)
        full = lm_fwd(params, seq, cfg)
        torch.cuda.synchronize()
        launches, designs = _launches(counters), _f32_designs()
        dec, ref = torch.stack(steps, dim=1), full[:, P - 1:]
        rel = _rel_l2(dec, ref)
        planted = _planted_decode_faults(torch, params, cfg, prompt, seq, prefilled,
                                         dec[:, 0], ref)
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    # B2 in float32 takes the float32 kernel's tensor-core design (4096 and
    # 4112 rows): once a layer in the prefill and the forward, never the
    # wgmma kernel; B7 once a chunk a layer (4 in the prefill, 5 in the
    # forward)
    want = {name: 0 for name in counters}
    want.update(ssm_scan=cfg.n_layers * (-(-P // MAMBA_CHUNK) - (-(P + T) // MAMBA_CHUNK)),
                flash_attention_f32=2 * cfg.n_layers)
    if launches != want or designs != {"tensor_core": 2 * cfg.n_layers, "packed": 0}:
        fail(f"hymba_f32: launched {launches}, designs {designs}, expected {want}, all on "
             "the tensor cores")
    if not (finite and rel <= HYMBA_F32_GATE
            and all(planted[name] > HYMBA_F32_GATE for name in HYMBA_F32_SEES)):
        fail(f"hymba_f32: finite={finite}, decode vs forward relative L2 {rel}, planted "
             f"faults {planted} (the gate {HYMBA_F32_GATE} must hold the first and not "
             "the others)")
    # warm times: CUDA events around calls launched back to back
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: lm_prefill(params, prompt, caches, cfg), reps=2, warmup=1)
        forward_ms = cuda_ms(lambda: lm_fwd(params, seq, cfg), reps=2, warmup=1)
    emit("hymba_f32", model=cfg.name, compute_dtype="float32", kv_cache_dtype="float32",
         batch=B, prompt=P, decode_steps=T, prefill_ms=prefill_ms, forward_ms=forward_ms,
         decode_vs_forward_relative_l2=rel,
         decode_vs_forward_max_abs_err=(dec - ref).abs().max().item(),
         planted_faults_relative_l2=planted, tolerance=f"relative L2 {HYMBA_F32_GATE}",
         logits_abs_max=ref.abs().max().item(), launches=launches,
         f32_launches_by_design=designs)
    return {"hymba_f32": launches}, {"hymba_f32": designs}


def check_hymba_reference(torch, dev):
    """The reduced hymba (2 layers, d 64, windows (0, 32)) in float32 with
    the same params on the card (B7, B2) and on the CPU (plain versions):
    prefill of 48 tokens, 8 greedy decode steps, forward of the 56.  Greedy
    tokens equal; logits within 2e-4 (float32 sums in other orders; the JAX
    package's own decode == forward bound)."""
    from repro_torch import pytree
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_fwd, lm_prefill
    from repro_torch.weights import init_lm_params

    cfg = reduced(get_config("hymba-1.5b"))
    B, P, T = 2, 48, 8
    params_cpu = init_lm_params(cfg, SEED, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(SEED + 12))
    counters = _counters()
    out, launched = {}, {}
    for where in ("cpu", dev):
        params = pytree.map(lambda t: t.to(where), params_cpu)
        _zero_counters(torch, counters)
        with torch.no_grad():
            caches = lm_cache_init(params, cfg, B, P + T, dtype=torch.float32)
            logits, caches = lm_prefill(params, prompt.to(where), caches, cfg)
            steps, toks = [logits[:, 0]], []
            for i in range(T):
                toks.append(steps[-1].argmax(-1))
                logits, caches = lm_decode_step(params, toks[-1], caches, P + i, cfg)
                steps.append(logits[:, 0])
            full = lm_fwd(params, torch.cat([prompt.to(where), torch.stack(toks, 1)], 1), cfg)
        out[str(where)] = (torch.stack(toks, 1).cpu(), torch.stack(steps, 1).cpu(), full.cpu())
        launched[str(where)] = _launches(counters)
    (t_cpu, s_cpu, f_cpu), (t_card, s_card, f_card) = out["cpu"], out[str(dev)]
    if not torch.equal(t_cpu, t_card):
        fail("hymba_reference: greedy tokens differ between card and CPU")
    err = max((s_card - s_cpu).abs().max().item(), (f_card - f_cpu).abs().max().item())
    if not err <= 2e-4:
        fail(f"hymba_reference: logits differ by {err} > 2e-4")
    card = launched[str(dev)]
    if (card["ssm_scan"] != 2 * cfg.n_layers or card["flash_attention_f32"] != 2 * cfg.n_layers
            or card["flash_attention"] != 0):
        fail(f"hymba_reference: card launches {card}")
    emit("hymba_reference", model=cfg.name, prompt=P, decode_steps=T, max_abs_err=err,
         tolerance=2e-4, tokens=t_cpu.tolist(), logits_abs_max=f_cpu.abs().max().item(),
         card_launches={k: v for k, v in card.items() if v})


# ---------------------------------------------------------------- phase 6b

# The LM zoo's attention archs (the lm-zoo cells), each at the widths the
# JAX package publishes (src/repro/configs/archs.py:57-116), random weights
# from SEED: prompts, prompt length, and the full-width parameter count
# (jax.eval_shape of the JAX package's lm_init; qwen2.5's QKV biases and
# llama-vision's one gate a xattn layer included).  gemma2's prompt is twice
# its local window, so the band cuts in the kernel and in the decode step.
LM_ARCHS = {
    "xlstm-125m": (2, 4096, 172_980_528),
    "tinyllama-1.1b": (2, 4096, 1_100_048_384),
    "yi-6b": (2, 4096, 6_061_035_520),
    "gemma2-9b": (1, 8192, 9_241_404_928),
    "qwen2.5-14b": (2, 4096, 14_770_033_664),
    "llama-3.2-vision-11b": (2, 4096, 9_775_157_256),
    "musicgen-medium": (2, 4096, 1_362_249_216),
    # every expert on the card: 61.06 GB of bf16 weights, so one prompt
    "qwen3-moe-30b-a3b": (1, 4096, 30_532_110_336),
    # every expert on the card at LM_DEPTH's 8 of its 40 layers: 54.61 GB of
    # bf16 weights (the 40 layers, 131.6 B params, would take 263 GB)
    "dbrx-132b": (2, 4096, 27_305_809_920),
}
# the archs cut in depth to fit the card (published widths, fewer layers)
LM_DEPTH = {"dbrx-132b": 8}
LM_DECODE = 16
# The JAX package's xattn forward ropes its queries and the vision keys and
# its prefill and decode step do not (src/repro/models/blocks.py:128-197),
# so llama-vision's decode logits are not its forward's: no decode gate.
# qwen3-moe's capacity is per row from L (src/repro/nn/moe.py:68-70): a
# decode step (L 1, C 1) drops no (token, expert) pair, the 4096-token
# prefill (C 320) and the 4112-token forward (C 322) drop others, so its
# decode logits are not its forward's either (the reduced config, where C
# is L and nothing drops, holds decode to forward in lm_reference); nor
# are dbrx's (C 1280 at L 4096, 1285 at 4112, 1 in a decode step).
LM_NO_DECODE_GATE = ("llama-3.2-vision-11b", "qwen3-moe-30b-a3b", "dbrx-132b")
# the MoE draw's peak above the finished bf16 tree: init_lm_params draws a
# run of at most 256 MiB of float32 at a time
MOE_DRAW_SLACK_GB = 2.0
# xlstm's prefill and forward loop over positions in its sLSTM layers (a
# Python loop of ~22 small kernels a position, host-bound at ~0.35 ms a
# position a layer on the card): its prefill is timed once (the first
# call), and the profiled prefill cut to XLSTM_PROFILE_PROMPT positions (a
# 4096-token one records ~0.5 M kernel events, and the profiler's
# post-processing of them takes longer than the run)
LM_RECURRENT = ("xlstm-125m",)
XLSTM_PROFILE_PROMPT = 128


def _attention_layers(cfg):
    """The layers that run B2 once in a prefill or a forward."""
    return cfg.n_repeats * sum(d.kind in ("attn", "xattn", "hymba") for d in cfg.group)


def _cast_leaf_by_leaf(torch, tree, cfg, path=()):
    """``lm_compute_params`` one leaf at a time, in place: each float32 leaf
    is dropped as soon as its compute-dtype copy exists, so the peak is the
    float32 tree and one leaf (the whole-tree cast holds both trees, 88.6 GB
    for qwen2.5-14b: more than the card has).  Each leaf is cast by the rule
    of its path (xlstm's cells keep their gates' weights float32)."""
    from repro_torch.models.lm import lm_compute_params

    for key in list(tree):
        if isinstance(tree[key], dict):
            _cast_leaf_by_leaf(torch, tree[key], cfg, path + (key,))
        else:
            tree[key] = lm_compute_params({key: tree[key]}, cfg, path)[key]
    return tree


def _lm_inputs(torch, dev, cfg, B, n, seed):
    """(token ids (B, n), or the EnCodec stub's frames (B, n, d_model) in
    bf16; the vision stub's patch embeddings (B, Nv, d_model) in bf16 or
    None), drawn on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.embed_inputs:
        inputs = torch.randint(0, cfg.vocab_size, (B, n), generator=g, device=dev)
    else:
        inputs = torch.randn(B, n, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    vision = None
    if cfg.n_vision_tokens:
        vision = torch.randn(B, cfg.n_vision_tokens, cfg.d_model, generator=g,
                             device=dev).to(torch.bfloat16)
    return inputs, vision


def run_lm_arch(torch, dev, name):
    """One lm-zoo cell: ``name`` at full width (bf16, bf16 KV cache) through
    lm_prefill, LM_DECODE greedy lm_decode_step calls (musicgen: fed the
    stub's next frames), the same steps as one captured step replayed, and
    lm_fwd over the prompt and the generated positions.  B2 runs once a
    layer (self-attention or xattn) in the prefill and the forward and never
    in a decode step; decode logits against forward logits within the
    hymba gate (but llama-vision); warm times, peak memory and one
    profiled prefill."""
    from repro_torch import pytree
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_fwd, lm_prefill
    from repro_torch.weights import init_lm_params

    cfg = get_config(name)
    if name in LM_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[name])
    B, P, want_params = LM_ARCHS[name]
    T = LM_DECODE
    moe = bool(cfg.n_experts)
    base = _fresh_memory(torch)
    t0 = time.perf_counter()
    if moe:
        # its float32 tree would be 122 GB (dbrx's 8 layers: 109 GB): the
        # bf16 leaves are drawn into bf16 in runs, and no float32 tree exists
        cp = init_lm_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
        n_params = sum(p.numel() for p in pytree.leaves(cp))
    else:
        cp = init_lm_params(cfg, SEED, device=dev)
        n_params = sum(p.numel() for p in pytree.leaves(cp))
        _cast_leaf_by_leaf(torch, cp, cfg)
    torch.cuda.synchronize()
    weights = dict(seconds=time.perf_counter() - t0,
                   peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                   resident_gb=(torch.cuda.memory_allocated() - base) / 1e9)
    if n_params != want_params:
        fail(f"{name}: {n_params} params, expected {want_params}")
    if moe and weights["peak_gb"] - weights["resident_gb"] > MOE_DRAW_SLACK_GB:
        fail(f"{name}: the draw peaked {weights['peak_gb']} GB for a {weights['resident_gb']} "
             f"GB tree (more than {MOE_DRAW_SLACK_GB} GB above it)")
    emit("lm_weights", model=name, params=n_params, **weights, layers=cfg.n_layers,
         published_layers=get_config(name).n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, ffn=cfg.ffn_kind,
         vocab=cfg.vocab_size, group=[(d.kind, d.window) for d in cfg.group],
         experts=cfg.n_experts or None, top_k=cfg.top_k or None,
         seed=SEED, compute_dtype=cfg.compute_dtype, kv_cache_dtype="bfloat16",
         note=("bf16 leaves drawn in bf16 in runs of 256 MiB (init_lm_params(dtype=...)), "
               f"the draw's peak at most {MOE_DRAW_SLACK_GB} GB above the tree" if moe else
               "float32 init cast to bf16 leaf by leaf (chip_smoke's _cast_leaf_by_leaf)"))

    counters = _counters()
    inputs, vision = _lm_inputs(torch, dev, cfg, B, P + T, SEED + 21)
    frames = None if cfg.embed_inputs else inputs
    prompt = inputs[:, :P]
    per_layer = {n: 0 for n in counters}
    per_layer["flash_attention"] = _attention_layers(cfg)  # xlstm: none
    runs, wall, routed = {}, {}, {}
    with torch.no_grad():
        caches = lm_cache_init(cp, cfg, B, P + T)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        with _route_log(torch) as log:
            logits, caches = lm_prefill(cp, prompt, caches, cfg, vision=vision)
        torch.cuda.synchronize()
        wall["prefill_s"] = time.perf_counter() - t0
        runs[f"{name}_prefill"] = _launches(counters)
        routed["prefill"] = _dropped_pairs(torch, log)
        prefilled = pytree.map(torch.clone, caches)

        steps, toks = [logits[:, 0].float()], []
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        for i in range(T):
            toks.append(steps[-1].argmax(-1))
            x = toks[-1] if frames is None else frames[:, P + i:P + i + 1]
            logits, caches = lm_decode_step(cp, x, caches, P + i, cfg)
            steps.append(logits[:, 0].float())
        torch.cuda.synchronize()
        wall["decode_s"] = time.perf_counter() - t0
        runs[f"{name}_decode"] = _launches(counters)

        seq = torch.cat([prompt, torch.stack(toks, 1)], 1) if frames is None else frames
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        with _route_log(torch) as log:
            full = lm_fwd(cp, seq, cfg, vision=vision)
        torch.cuda.synchronize()
        wall["forward_s"] = time.perf_counter() - t0
        runs[f"{name}_forward"] = _launches(counters)
        routed["forward"] = _dropped_pairs(torch, log)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        ref = full[:, P - 1:].float()
        shape_ok = tuple(full.shape) == (B, P + T, cfg.vocab_size)
        finite = bool(torch.isfinite(full).all())
        del full

    for run, want in ((f"{name}_prefill", per_layer), (f"{name}_forward", per_layer),
                      (f"{name}_decode", {n: 0 for n in counters})):
        if runs[run] != want:
            fail(f"{name}: {run} launched {runs[run]}, expected {want}")
    dec = torch.stack(steps, dim=1)  # logits at positions P-1 .. P+T-1
    finite = finite and bool(torch.isfinite(dec).all())
    rel = _rel_l2(dec, ref)
    gated = name not in LM_NO_DECODE_GATE
    if not (finite and shape_ok and (rel <= HYMBA_BF16_GATE or not gated)):
        fail(f"{name}: finite={finite}, forward shape ok {shape_ok}, decode vs forward "
             f"relative L2 {rel} (gate {HYMBA_BF16_GATE}, applied: {gated})")
    graph_decode = _captured_decode(torch, dev, cp, cfg, prefilled, steps, P, counters,
                                    frames=frames)
    del prefilled
    moe_layer = _moe_layer(torch, dev, cp, cfg, P) if moe else None

    recurrent = name in LM_RECURRENT
    with torch.no_grad():
        x0 = toks[0] if frames is None else frames[:, P:P + 1]
        prefill_ms = wall["prefill_s"] * 1e3 if recurrent else cuda_ms(
            lambda: lm_prefill(cp, prompt, caches, cfg, vision=vision), reps=2, warmup=1)
        decode_ms = cuda_ms(lambda: lm_decode_step(cp, x0, caches, P, cfg), reps=4,
                            warmup=1)
        torch.cuda.synchronize()
        Pp = XLSTM_PROFILE_PROMPT if recurrent else P
        wall_ms, kernels, moe_ms = _profiled_moe(torch, lambda: lm_prefill(
            cp, prompt[:, :Pp], caches, cfg, vision=vision))
    extra = {}
    if moe:
        busy = sum(ms for _, ms, _ in kernels)
        extra = dict(moe_device_ms_by_group=moe_ms or "not measured",
                     outside_moe_device_ms=busy - sum(moe_ms.values()) if moe_ms else None)
    _emit_profile(torch, "lm_profile", wall_ms, kernels,
                  f"one warm lm_prefill of {name} ({B} x {Pp} tokens, {cfg.n_layers} layers) "
                  "under torch.profiler; 'other' holds norms, RoPE, activations and casts"
                  + ("; moe_device_ms_by_group: the device time of the kernels launched "
                     "inside each MoE step (record_function ranges; the expert products' "
                     "GEMMs also count in 'matmul')" if moe else ""),
                  model=name, prefill_tokens=B * Pp, **extra)
    if recurrent:
        _xlstm_mixer_profiles(torch, dev, cp, cfg, B, P)
    emit("lm_arch", model=name, batch=B, prompt=P, decode_steps=T, cache_len=P + T,
         inputs="token ids" if frames is None else "stub frames (bf16, from the seed)",
         vision=None if vision is None else list(vision.shape), launches=runs,
         finite=finite, decode_vs_forward_relative_l2=rel,
         decode_vs_forward_max_abs_err=(dec - ref).abs().max().item(),
         decode_gate=(f"relative L2 {HYMBA_BF16_GATE} (hymba's bf16 gate)" if gated else
                      "none: the prefill and the forward drop (token, expert) pairs at "
                      "their capacity, a decode step none" if moe else
                      "none: the JAX package's xattn forward ropes, its prefill and step "
                      "do not"),
         greedy_argmax_agreement=(dec.argmax(-1) == ref.argmax(-1)).float().mean().item(),
         logits_abs_max=ref.abs().max().item(), peak_memory_gb=peak_gb,
         first_call_wall=wall, prefill_ms=prefill_ms,
         prefill_timing="the first call's wall (host-bound)" if recurrent else
         "warm, CUDA events",
         prefill_tokens_per_s=B * P / prefill_ms * 1e3, decode_ms_per_step=decode_ms,
         decode_tokens_per_s=B / decode_ms * 1e3, captured_decode=graph_decode,
         **({} if not moe else dict(dropped_pairs=routed, moe_layer=moe_layer,
                                    bounds=_moe_bounds(cfg, B, P))),
         analytic_bounds=_analytic_bounds(cfg, B, P, n_params),
         note="warm times by CUDA events; a decode step is one position of each sequence")
    return runs


# the profile's MoE groups: (group, the nn.moe function whose kernels it holds)
MOE_RANGES = (("routing", "_route"), ("gather", "_gather"),
              ("expert_products", "_expert_ffn"), ("combine", "_combine"))


@contextlib.contextmanager
def _moe_ranges(torch):
    """Each MoE step of ``repro_torch.nn.moe`` run inside a
    ``record_function`` range named ``moe_<group>`` (the module's functions
    swapped for wrappers, and back)."""
    from repro_torch.nn import moe

    saved = {fn: getattr(moe, fn) for _, fn in MOE_RANGES}

    def ranged(group, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"moe_{group}"):
                return fn(*args, **kwargs)
        return call

    for group, fn in MOE_RANGES:
        setattr(moe, fn, ranged(group, saved[fn]))
    try:
        yield
    finally:
        for fn, orig in saved.items():
            setattr(moe, fn, orig)


def _profiled_moe(torch, fn):
    """Wall ms of ``fn`` (ended by a synchronize) under torch.profiler, the
    device kernels it ran as (name, ms, count), and the device ms of the
    kernels inside each MoE step by group (empty where no MoE ran, or the
    profiler tied no kernel to a range)."""
    from torch.profiler import ProfilerActivity, profile

    with _moe_ranges(torch), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    names = {f"moe_{group}": group for group, _ in MOE_RANGES}
    # the ranges show on the device's timeline too: not kernels
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in names]
    by_group = {names[e.key]: getattr(e, "device_time_total", 0.0) / 1e3
                for e in averages if e.key in names}
    return wall_ms, kernels, by_group if any(by_group.values()) else {}


@contextlib.contextmanager
def _route_log(torch):
    """Records each ``_route`` call's (routed, kept) (token, expert) pairs as
    a device tensor while the block runs."""
    from repro_torch.nn import moe

    log, route = [], moe._route

    def recorded(params, x, cfg, capacity=None):
        out = route(params, x, cfg, capacity)
        routed = torch.tensor(x.shape[0] * x.shape[1] * cfg.top_k, device=x.device)
        log.append(torch.stack([routed, out[2].sum()]))
        return out

    moe._route = recorded
    try:
        yield log
    finally:
        moe._route = route


def _dropped_pairs(torch, log):
    """The (token, expert) pairs the capacity dropped, from a ``_route_log``
    (None where no MoE layer ran)."""
    if not log:
        return None
    per = torch.stack(log).cpu()
    dropped = (per[:, 0] - per[:, 1]).tolist()
    return dict(calls=len(log), routed=int(per[:, 0].sum()), dropped=int(sum(dropped)),
                max_dropped_in_a_layer=int(max(dropped)), dropped_by_layer=dropped)


def _moe_bounds(cfg, B, P):
    """The card's least time for the MoE work this run does, every expert
    computing its C rows a batch row: the prefill's expert products (2 E C
    3 d ff flops a row and layer, at bf16's peak) and a decode step's read
    of every expert stack (bf16, at the memory rate)."""
    from repro_torch.nn.moe import capacity_of

    E, d, ff, n = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    C = capacity_of(cfg, P)
    flops = 2.0 * B * E * C * 3 * d * ff * n
    stack_bytes = 2.0 * E * 3 * d * ff * n
    return dict(capacity_prefill=C, prefill_expert_tflop=flops / 1e12,
                prefill_expert_products_bound_ms=flops / PEAK_BF16 * 1e3,
                decode_expert_gb=stack_bytes / 1e9,
                decode_step_bound_ms=stack_bytes / HBM_BYTES_PER_S * 1e3,
                note="my arithmetic from the config: the products at the capacity's rows, "
                     "and the expert stacks read once a decode step")


def _analytic_bounds(cfg, B, P, n_params):
    """The least times of this run's prefill (B x P) and of one decode step
    against a P-long cache, from the port's analytic model
    (repro_torch.analysis.analytic.analyze_cell): its flops at bf16's peak
    or its idealised bytes at the memory rate, whichever is longer."""
    from repro_torch.analysis.analytic import analyze_cell
    from repro_torch.configs.base import InputShape

    out = {}
    for kind in ("prefill", "decode"):
        cost = analyze_cell(cfg, InputShape(f"lm_arch_{kind}", P, B, kind), n_params)
        t_ops, t_bytes = cost.flops / PEAK_BF16 * 1e3, cost.hbm_bytes / HBM_BYTES_PER_S * 1e3
        out[kind] = dict(tflop=cost.flops / 1e12, gb=cost.hbm_bytes / 1e9,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
    out["note"] = ("analyze_cell of the run's config: its MoE flops count each token's "
                   "top_k experts, not the capacity's rows the port computes")
    return out


def _moe_bits(torch, p, x, cfg):
    """``moe_apply(p, x, cfg)`` twice, and captured in a CUDA graph (after a
    warm call on a side stream) and replayed: (its output, two calls equal
    in bits, the replay equal to the eager call in bits)."""
    from repro_torch.nn.moe import moe_apply

    with torch.no_grad():
        a, b = moe_apply(p, x, cfg)[0], moe_apply(p, x, cfg)[0]
        static_x = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_apply(p, static_x, cfg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = moe_apply(p, static_x, cfg)[0]
        graph.replay()
        torch.cuda.synchronize()
    return a, _bits(torch, a, b), _bits(torch, a, static_out)


def _moe_layer(torch, dev, cp, cfg, P):
    """One MoE layer (layer 0's router and stacks) on a (1, P, d) bf16 input,
    and on a (1, 1, d) decode-shaped one: two eager calls give equal bits,
    and a captured call replayed gives the eager bits (the combine adds in
    a fixed order, nothing reads back to the host); warm ms by CUDA
    events."""
    from repro_torch.nn.moe import moe_apply

    p = {k: v[0] for k, v in cp["decoder"]["g0"]["moe"].items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    out = {}
    for name, L in (("prefill_shape", P), ("decode_shape", 1)):
        x = torch.randn(1, L, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
        a, same, captured = _moe_bits(torch, p, x, cfg)
        with torch.no_grad():
            ms = cuda_ms(lambda: moe_apply(p, x, cfg), reps=5)
        if not (same and captured and bool(torch.isfinite(a).all())):
            fail(f"moe layer at {name}: two calls equal bits {same}, captured equal bits "
                 f"{captured}")
        out[name] = dict(tokens=L, two_calls_equal_bits=same, captured_equal_bits=captured,
                         ms=ms)
    return out


# moe_denoiser: the MoE smoke denoiser (qwen3-moe-a3b-smoke: 2 layers, d
# 64, E 8, top 2, float32), sampled by ASD (buffer noise, DDPM, K 64,
# theta 8, 8 chains) on the card against the port's CPU run of the same
# inputs (counters equal, samples within 2e-3, as serve_reference), and
# served by the CLI.  Its points run in blocks of 16 (models/diffusion.py).
MOE_DENOISER = "qwen3-moe-a3b-smoke"
MOE_K, MOE_CHAINS, MOE_TOL = 64, 8, 2e-3
MOE_CLI_RUNS = (("default", []),
                ("packed", ["--execution", "packed", "--round-budget", "24"]))


def run_moe_denoiser(torch, dev):
    """moe_denoiser: MOE_DENOISER at random weights (nonzero out_proj, so
    proposals are rejected): ``asd_sample_batched`` in buffer noise mode on
    the card and on the CPU from the same y0 and noise; a point's output the
    same bits alone and in a batch of 36 (and of 18), with the token
    product's rows beside it unblocked; one MoE layer's two calls and a
    captured call equal in bits; then ``serve.main`` at the model with the
    CLI's defaults and packed, launches per round.  B1 once a round, B2's
    float32 kernel once a layer a block of 16 points."""
    import contextlib as _ctx
    import io

    from repro_torch import pytree
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import ddpm
    from repro_torch.launch import serve
    from repro_torch.models.diffusion import make_ddpm_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = get_denoiser_config(MOE_DENOISER)
    cfg = dc.backbone
    params_cpu = init_denoiser_params(dc, SEED, out_scale=1.0, device="cpu")
    sched = ddpm(MOE_K)
    rng = np.random.default_rng(SEED + 31)
    n, ev = MOE_CHAINS, (dc.seq_len, dc.d_data)
    y0 = torch.from_numpy(rng.standard_normal((n,) + ev, dtype=np.float32))
    u = torch.from_numpy(rng.random((n, MOE_K + THETA + 1), dtype=np.float32))
    xi = torch.from_numpy(rng.standard_normal((n, MOE_K + THETA + 1) + ev, dtype=np.float32))
    counters = _counters()
    res, launches = {}, None
    for where in ("cpu", dev):
        fn = make_ddpm_model_fn(pytree.map(lambda t: t.to(where), params_cpu), dc)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        with torch.no_grad():
            r = asd_sample_batched(fn, sched, y0.to(where), THETA, keep_trajectory=False,
                                   u_buf=u.to(where), xi_buf=xi.to(where), device=where)
        if where != "cpu":
            torch.cuda.synchronize()
            launches = _launches(counters)
        res[str(where)] = (r, time.perf_counter() - t0)
    (rc, _), (rg, wall) = res["cpu"], res[str(dev)]
    counts = {k: (getattr(rc, k).tolist(), getattr(rg, k).tolist())
              for k in ("rounds", "accepts", "proposals", "model_evals")}
    err = (rg.sample.cpu() - rc.sample).abs().max().item()
    rounds = int(rg.rounds.max())
    if (any(a != b for a, b in counts.values()) or not err <= MOE_TOL
            or not int(rc.accepts.sum()) < int(rc.proposals.sum())
            or launches["grs"] != rounds or not launches["flash_attention_f32"]
            or launches["flash_attention_f32"] % cfg.n_layers or launches["flash_attention"]):
        fail(f"moe_denoiser asd: counters {counts}, sample error {err} ({MOE_TOL}), "
             f"launches {launches} for {rounds} rounds")
    asd = dict(chains=n, K=MOE_K, theta=THETA, rounds=rounds, wall_s=wall,
               accept_rate=float(rc.accepts.sum() / rc.proposals.sum()),
               max_abs_err_vs_cpu=err, tolerance=MOE_TOL, counters_equal=True,
               launches={k: v for k, v in launches.items() if v},
               b2_launches_per_round=launches["flash_attention_f32"] / rounds)

    params = pytree.map(lambda t: t.to(dev), params_cpu)
    fn = make_ddpm_model_fn(params, dc)
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    t = torch.randint(0, MOE_K, (36,), generator=g, device=dev).float()
    y = torch.randn((36,) + ev, generator=g, device=dev)
    w = torch.randn(cfg.n_experts, cfg.d_model, cfg.d_ff, generator=g, device=dev)
    xg = torch.randn(cfg.n_experts, 36 * dc.seq_len, cfg.d_model, generator=g, device=dev)
    with torch.no_grad():
        full = fn(t, y)
        invariance = {f"{m}_of_36": _bits(torch, fn(t[:m], y[:m]), full[:m]) for m in (1, 18)}
        # what the blocks are for: an expert product unblocked, a point's C
        # (= 8) rows alone against 36 points' rows (not gated)
        probe = {f"expert_product_rows_same_unblocked_{m}_of_36": _bits(
            torch, torch.bmm(xg[:, :m * dc.seq_len], w), torch.bmm(xg, w)[:, :m * dc.seq_len])
            for m in (1, 18)}
    layer = {k: v[0] for k, v in params["decoder"]["g0"]["moe"].items()}
    x = torch.randn(16, dc.seq_len, cfg.d_model, generator=g, device=dev)
    _, same, captured = _moe_bits(torch, layer, x, cfg)
    combine = dict(two_calls_equal_bits=same, captured_equal_bits=captured)
    if not all(invariance.values()) or not all(combine.values()):
        fail(f"moe_denoiser: a point alone and in a batch {invariance}, the MoE layer "
             f"{combine}")
    del params, fn

    cli, cli_launches = {}, {}
    for name, extra in MOE_CLI_RUNS:
        argv = ["--model", MOE_DENOISER, *extra]
        _zero_counters(torch, counters)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _ctx.redirect_stdout(buf):
            summary = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _launches(counters)
        rounds = summary["rounds_total"]
        packed = "--execution" in extra
        per_round = launched["flash_attention_f32"] / rounds
        if (not summary["finite"] or summary["retired"] != SERVE_CLI_REQUESTS
                or launched["grs"] != rounds or launched["flash_attention"]
                or per_round != int(per_round) or int(per_round) % cfg.n_layers
                or per_round < 2 * cfg.n_layers
                or packed != bool(launched["gather_rows"] and launched["scatter_rows"])):
            fail(f"moe_denoiser serve_cli {name}: finite {summary['finite']}, retired "
                 f"{summary['retired']}, launches {launched} for {rounds} rounds")
        cli_launches[f"moe_denoiser_cli_{name}"] = launched
        cli[name] = dict(argv=argv, rounds=rounds, retired=summary["retired"],
                         accept_rate=summary["accept_rate"],
                         samples_per_s=SERVE_CLI_REQUESTS / summary["wall_time_s"],
                         wall_s=wall, launches={k: v for k, v in launched.items() if v},
                         b2_launches_per_round=per_round,
                         printed=buf.getvalue().splitlines()[-2:])
    emit("moe_denoiser", model=MOE_DENOISER, experts=cfg.n_experts, top_k=cfg.top_k,
         capacity_factor=cfg.capacity_factor, point_block=16, asd_buffer=asd,
         batch_invariance=dict(invariance, **probe), moe_layer_16_points=combine,
         serve_cli=cli,
         gate="ASD counters equal card and CPU, samples within the tolerance, a rejection; "
              "a point's rows the same bits alone, at 18 and at 36; the MoE layer's two "
              "calls and its captured call equal in bits; the CLI's samples finite, every "
              "request retired, B1 once a round, B2 once a layer a block, B3 and B4 when "
              "packed")
    rows = _moe_denoiser_kernels(torch, dev, dc)
    return {"moe_denoiser_asd": launches, **cli_launches}, rows


def _moe_denoiser_kernels(torch, dev, dc):
    """B2's float32 kernel at the MoE denoiser's block (16 points of its 8
    tokens, 4 heads of 16; the packed design) and B1 at its ASD rounds'
    rows (8 chains x theta 8 of 8 x 4 floats), against their plain
    versions, timed as in phase 3; kernels-line rows with the runs whose
    launches are at each shape."""
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs

    sdpa = torch.nn.functional.scaled_dot_product_attention
    cfg = dc.backbone
    H = cfg.n_heads
    q, k, v = _flash_inputs(torch, dev, 16, dc.seq_len, dc.seq_len, H, cfg.d_model // H,
                            SEED + 33, torch.float32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    f32 = _f32_timed(torch, q, k, v, dict(causal=False), lambda: sdpa(qt, kt, vt))
    if f32["design"] != "packed":
        fail(f"moe_denoiser_kernels: B2 float32 launched {f32['design']}, not packed")
    emit("moe_denoiser_kernels", kernel="flash_attention_f32", **f32,
         library="scaled_dot_product_attention (float32)")
    R, D = MOE_CHAINS * THETA, dc.seq_len * dc.d_data
    args = _grs_inputs(torch, dev, R, D, SEED + 34)
    err, accepted = _grs_compare(torch, args)
    times = kernel_times(lambda: grs(*args), lambda: grs_plain(*args), wrapper=grs)
    bms, by = _grs_bound(R, D)
    emit("moe_denoiser_kernels", kernel="grs", shape=[R, D], max_abs_err=err,
         accepted_rows=accepted, **times, bound_ms=bms, bound_by=by,
         geometry=_row_geometry(R, D))
    block = [16, dc.seq_len, H, cfg.d_model // H]
    return [dict(name="flash_attention_f32", route="cuda", source=FLASH_F32_SOURCE,
                 replaces=FLASH_REPLACES, at=f"{MOE_DENOISER} block {block}", **f32,
                 runs={"moe_denoiser_asd": 1.0, "moe_denoiser_cli_default": 1.0,
                       "moe_denoiser_cli_packed": 1.0}),
            dict(name="grs", route="cuda", source="src/repro_torch/csrc/grs.cu",
                 replaces="src/repro/kernels/grs/kernel.py:27",
                 at=f"{MOE_DENOISER} ASD rounds ({R}, {D})", max_abs_err=err, **times,
                 library=None, bound_ms=bms, bound_by=by, runs={"moe_denoiser_asd": 1.0})]


def _xlstm_mixer_profiles(torch, dev, cp, cfg, B, P):
    """xlstm_mixers: one mLSTM and one sLSTM cell (layer 0 of each) on a
    (B, P, d_model) bf16 input, as in the prefill: the mLSTM's chunks
    profiled whole; the sLSTM's loop timed by CUDA events at P positions
    and profiled at XLSTM_PROFILE_PROMPT (device busy ms and idle share),
    with the prefill's share estimated from them (its layers times one)."""
    from repro_torch.nn.ssm import mlstm_fwd, slstm_fwd

    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    x = torch.randn(B, P, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    from repro_torch import pytree

    cells = {kind: pytree.map(lambda t: t[0], cp["decoder"][f"g{i}"]["cell"])
             for i, kind in enumerate(("mlstm", "slstm"))}
    layers = cfg.n_repeats
    out = {}
    with torch.no_grad():
        for kind, fwd, short in (("mlstm", mlstm_fwd, P), ("slstm", slstm_fwd,
                                                           XLSTM_PROFILE_PROMPT)):
            p = cells[kind]
            event_ms = cuda_ms(lambda: fwd(p, x, cfg), reps=1, warmup=0)  # warm: the prefill ran it
            torch.cuda.synchronize()
            wall_ms, kernels = _profiled(torch, lambda: fwd(p, x[:, :short], cfg))
            busy = sum(ms for _, ms, _ in kernels)
            out[kind] = dict(
                event_ms_at_prompt=event_ms, prompt=P, profiled_positions=short,
                profiled_wall_ms=wall_ms, device_busy_ms=busy or "not measured",
                device_idle_share=max(0.0, 1.0 - busy / wall_ms) if busy else None,
                kernel_launches=sum(n for _, _, n in kernels),
                prefill_layers=layers, prefill_event_ms_estimate=layers * event_ms,
                top_kernels=[{"name": k[:80], "ms": ms, "count": n} for k, ms, n in
                             sorted(kernels, key=lambda e: -e[1])[:5]])
            if kind == "slstm" and busy:
                out[kind]["device_busy_ms_per_position"] = busy / short
                out[kind]["prefill_device_ms_estimate"] = layers * P * busy / short
            elif busy:
                out[kind]["prefill_device_ms_estimate"] = layers * busy
    emit("xlstm_mixers", model=cfg.name, batch=B, **out,
         note="layer 0 of each cell at the prefill's shape (bf16 input); mLSTM: 4 chunks "
              "of 1024, profiled whole; sLSTM: event ms over the prompt, profiled over "
              f"{XLSTM_PROFILE_PROMPT} positions; estimates scale to the prefill's "
              f"{layers} layers of each")


# gemma2's reduced config at its published head dim 256 (d_model 64) in
# bf16: B2's four-chunk wgmma kernel inside a model, card against CPU.
# Both sides compute the attention core in float32 and every product in
# bf16 with float32 sums, so they differ where a sum's order flips a bf16
# rounding; the gate is a relative L2 over the logits, and a planted fault
# (the local layers' window ignored on the card) must exceed it.  Set
# between the clean run, 0.0063, and the planted fault, 0.0620 (NVIDIA
# H100 80GB HBM3, 700.00 W).
LM_HD256_GATE = 0.02


def check_lm_archs_reference(torch, dev):
    """Each lm-zoo arch's reduced config (2 repeats of the group, d 64, 4
    heads of 16, windows cut to 32, 16 vision tokens) in float32 with the
    same params on the card (B2's float32 kernel) and on the CPU (plain
    versions): prefill of 48 positions, 8 greedy decode steps (musicgen: the
    stub's frames), the forward over the 56.  Greedy tokens equal; logits
    within 2e-4 (float32 sums in other orders).  Then gemma2 at head dim 256
    in bf16 (LM_HD256_GATE)."""
    from repro_torch import pytree
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_fwd, lm_prefill
    from repro_torch.weights import init_lm_params

    B, P, T = 2, 48, 8
    counters = _counters()
    results = {}
    for name in LM_ARCHS:
        cfg = reduced(get_config(name))
        params_cpu = init_lm_params(cfg, SEED, device="cpu")
        g = torch.Generator().manual_seed(SEED + 22)
        inputs = (torch.randint(0, cfg.vocab_size, (B, P + T), generator=g)
                  if cfg.embed_inputs else torch.randn(B, P + T, cfg.d_model, generator=g))
        vision = (torch.randn(B, cfg.n_vision_tokens, cfg.d_model, generator=g)
                  if cfg.n_vision_tokens else None)
        out, launched = {}, {}
        for where in ("cpu", dev):
            params = pytree.map(lambda t: t.to(where), params_cpu)
            vis = None if vision is None else vision.to(where)
            _zero_counters(torch, counters)
            with torch.no_grad():
                caches = lm_cache_init(params, cfg, B, P + T, dtype=torch.float32)
                logits, caches = lm_prefill(params, inputs[:, :P].to(where), caches, cfg,
                                            vision=vis)
                steps, toks = [logits[:, 0]], []
                for i in range(T):
                    toks.append(steps[-1].argmax(-1))
                    x = toks[-1] if cfg.embed_inputs else inputs[:, P + i:P + i + 1].to(where)
                    logits, caches = lm_decode_step(params, x, caches, P + i, cfg)
                    steps.append(logits[:, 0])
                seq = (torch.cat([inputs[:, :P].to(where), torch.stack(toks, 1)], 1)
                       if cfg.embed_inputs else inputs.to(where))
                full = lm_fwd(params, seq, cfg, vision=vis)
            out[str(where)] = (torch.stack(toks, 1).cpu(), torch.stack(steps, 1).cpu(),
                               full.cpu())
            launched[str(where)] = _launches(counters)
        (t_cpu, s_cpu, f_cpu), (t_card, s_card, f_card) = out["cpu"], out[str(dev)]
        err = max((s_card - s_cpu).abs().max().item(), (f_card - f_cpu).abs().max().item())
        card = launched[str(dev)]
        if not torch.equal(t_cpu, t_card) or not err <= 2e-4:
            fail(f"lm_reference {name}: tokens equal {torch.equal(t_cpu, t_card)}, logits "
                 f"differ by {err} (2e-4)")
        if card["flash_attention_f32"] != 2 * _attention_layers(cfg) or \
                card["flash_attention"]:
            fail(f"lm_reference {name}: card launches {card}")
        results[name] = dict(max_abs_err=err, logits_abs_max=f_cpu.abs().max().item(),
                             card_launches={k: v for k, v in card.items() if v})
    results["gemma2-9b head_dim 256 bf16"] = _gemma2_hd256_reference(torch, dev)
    results["xlstm-125m bf16 compute params"] = _xlstm_bf16_cast_reference(torch, dev)
    emit("lm_reference", prompt=P, decode_steps=T, tolerance=2e-4, archs=results)


def _xlstm_bf16_cast_reference(torch, dev):
    """reduced(xlstm-125m) in bf16 on the card: prefill of 48 tokens and 8
    decode steps from ``lm_compute_params`` (leaf by leaf, as the lm_arch
    runs cast) give the logits of the uncast float32 params bit for bit;
    the cells' gate weights must stay float32 (mLSTM's decode step reads
    wq, wk and wv in float32: a cast by leaf name alone changes its
    logits)."""
    from repro_torch import pytree
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_cache_init, lm_decode_step, lm_prefill
    from repro_torch.weights import init_lm_params

    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")), compute_dtype="bfloat16")
    params = init_lm_params(cfg, SEED, device=dev)
    cast = _cast_leaf_by_leaf(torch, pytree.map(torch.clone, params), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 56), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 25))

    def decode(p):
        caches = lm_cache_init(p, cfg, 2, 56)
        with torch.no_grad():
            logits, caches = lm_prefill(p, tokens[:, :48], caches, cfg)
            rows = [logits[:, 0]]
            for i in range(48, 56):
                logits, caches = lm_decode_step(p, tokens[:, i], caches, i, cfg)
                rows.append(logits[:, 0])
        return torch.stack(rows, 1)

    ref, got = decode(params), decode(cast)
    kept = {k: str(v.dtype) for k, v in cast["decoder"]["g0"]["cell"].items()
            if k in ("wq", "wk", "wv", "up_proj")}
    same = _bits(torch, got.float(), ref.float())
    if not (same and kept["wq"] == "torch.float32" and kept["up_proj"] == "torch.bfloat16"):
        fail(f"lm_reference xlstm bf16: cast params' decode logits equal bits {same}, leaf "
             f"dtypes {kept}")
    return dict(decode_logits_bit_equal=True, leaf_dtypes=kept,
                logits_abs_max=ref.float().abs().max().item())


def _gemma2_hd256_reference(torch, dev):
    """reduced(gemma2-9b) at head dim 256 in bf16: the forward over 56
    tokens on the card (B2's wgmma kernel, four chunks, window 32 and full,
    softcap 50) against the CPU (plain versions), relative L2 of the logits
    within LM_HD256_GATE; the same forward on the card with the local
    layers' window ignored must exceed it."""
    from repro_torch import pytree
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import lm_fwd
    from repro_torch.weights import init_lm_params

    cfg = dataclasses.replace(reduced(get_config("gemma2-9b")), head_dim=256,
                              compute_dtype="bfloat16")
    no_window = dataclasses.replace(cfg, group=tuple(
        dataclasses.replace(d, window=0) for d in cfg.group))
    params_cpu = init_lm_params(cfg, SEED, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 56),
                           generator=torch.Generator().manual_seed(SEED + 23))
    counters = _counters()
    with torch.no_grad():
        ref = lm_fwd(params_cpu, tokens, cfg).float()
        params = pytree.map(lambda t: t.to(dev), params_cpu)
        _zero_counters(torch, counters)
        card = lm_fwd(params, tokens.to(dev), cfg).float().cpu()
        launches = _launches(counters)
        planted = lm_fwd(params, tokens.to(dev), no_window).float().cpu()
    rel, rel_planted = _rel_l2(card, ref), _rel_l2(planted, ref)
    if launches["flash_attention"] != cfg.n_layers or not (
            rel <= LM_HD256_GATE < rel_planted):
        fail(f"lm_reference gemma2 hd 256: launches {launches}, relative L2 {rel}, with the "
             f"window ignored {rel_planted} (gate {LM_HD256_GATE})")
    return dict(relative_l2=rel, planted_window_ignored_relative_l2=rel_planted,
                gate=LM_HD256_GATE, max_abs_err=(card - ref).abs().max().item(),
                greedy_argmax_agreement=(card.argmax(-1) == ref.argmax(-1)).float().mean()
                .item(), card_launches={k: v for k, v in launches.items() if v})


# B2 at the lm-zoo prefill shapes: (row, arch, (B, Lq, S, H, hd), causal,
# window, softcap, the row's share of the arch's B2 launches)
LM_FLASH_SHAPES = (
    ("tinyllama-1.1b", "tinyllama-1.1b", (2, 4096, 4096, 32, 64), True, 0, 0.0, 1.0),
    ("yi-6b", "yi-6b", (2, 4096, 4096, 32, 128), True, 0, 0.0, 1.0),
    ("qwen2.5-14b", "qwen2.5-14b", (2, 4096, 4096, 40, 128), True, 0, 0.0, 1.0),
    ("gemma2-9b local", "gemma2-9b", (1, 8192, 8192, 16, 256), True, 4096, 50.0, 0.5),
    ("gemma2-9b global", "gemma2-9b", (1, 8192, 8192, 16, 256), True, 0, 50.0, 0.5),
    ("llama-3.2-vision-11b self", "llama-3.2-vision-11b", (2, 4096, 4096, 32, 128), True,
     0, 0.0, 0.8),
    ("llama-3.2-vision-11b cross", "llama-3.2-vision-11b", (2, 4096, 6400, 32, 128),
     False, 0, 0.0, 0.2),
    ("musicgen-medium", "musicgen-medium", (2, 4096, 4096, 24, 64), True, 0, 0.0, 1.0),
    ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", (1, 4096, 4096, 32, 128), True, 0, 0.0,
     1.0),
    ("dbrx-132b", "dbrx-132b", (2, 4096, 4096, 48, 128), True, 0, 0.0, 1.0),
)


def _attended_pairs(Lq, S, causal, window):
    """(q, k) pairs the mask keeps (causal over equal lengths, or all)."""
    return _hymba_pairs(Lq, window) if causal else Lq * S


def check_flash_lm_shapes(torch, dev):
    """B2 (bf16, the wgmma kernel) against its plain version at each
    lm-zoo prefill shape, timed as in phase 3.  The library call is SDPA
    (is_causal, or the boolean band mask for a window) where no softcap is
    on; with gemma2's softcap there is no single call, and SDPA without the
    softcap is timed beside it for scale only.  Returns kernels-line rows
    with the runs whose launches are at each shape."""
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma
    from repro_torch.nn.attention import attn_mask

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (row, arch, (B, Lq, S, H, hd), causal, window, cap, share) in enumerate(
            LM_FLASH_SHAPES):
        q, k, v = _flash_inputs(torch, dev, B, Lq, S, H, hd, SEED + 60 + i)
        opts = dict(causal=causal, window=window, softcap=cap)
        ok = flash_mha(q, k, v, **opts)
        torch.cuda.synchronize()
        op = attention_plain(q, k, v, **opts)
        used = _flash_tolerance_used(ok, op)
        err = (ok.float() - op.float()).abs().max().item()
        del ok, op
        if not used <= 1.0:
            fail(f"flash at the {row} shape: {used} of the tolerance ({FLASH_TOLERANCE})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = attn_mask(Lq, S, True, window, dev) if window else None
        no_cap = (lambda: sdpa(qt, kt, vt, attn_mask=mask)) if window else (
            lambda: sdpa(qt, kt, vt, is_causal=causal))
        times = kernel_times(lambda: flash_mha(q, k, v, **opts),
                             lambda: attention_plain(q, k, v, **opts),
                             None if cap else no_cap, reps=3, wrapper=flash_wgmma)
        pairs = _attended_pairs(Lq, S, causal, window)
        flops = 4.0 * B * H * pairs * hd
        bms, by = bound_ms(2.0 * B * H * hd * (2 * Lq + 2 * S), flops, PEAK_BF16)
        library = ("none (no single call: softcap)" if cap else
                   "scaled_dot_product_attention" + (" with the boolean band mask" if window
                                                     else ""))
        extra = {}
        if cap:
            extra["sdpa_without_softcap_ms"] = cold_ms(no_cap, reps=3)
        del q, k, v, qt, kt, vt, mask
        emit("flash_attention_lm", row=row, shape=[B, Lq, S, H, hd], causal=causal,
             window=window, softcap=cap, max_abs_err=err, tolerance=FLASH_TOLERANCE,
             tolerance_used=used, **times, library=library, bound_ms=bms, bound_by=by,
             attended_pairs=pairs, tflops=_tflops(flops, times), **extra)
        rows.append(dict(name="flash_attention", route="cuda", source=FLASH_WGMMA_SOURCE,
                         replaces=FLASH_REPLACES, at=f"{row} prefill {[B, Lq, S, H, hd]}"
                         f"{' causal' if causal else ''}"
                         f"{f' window {window}' if window else ''}"
                         f"{f' softcap {cap:g}' if cap else ''}",
                         max_abs_err=err, **times, library=library, bound_ms=bms,
                         bound_by=by, **extra,
                         runs={f"{arch}_prefill": share, f"{arch}_forward": share}))
    return rows


# ---------------------------------------------------------------- phase 7

# The stand-ins the JAX benchmarks train for the paper's figures and
# tables, copied as data from benchmarks/common.py:97-116 (MODELS "policy"
# and "pixel"; backbone at :86-92: dense, no positions, float32, no remat)
# with the recipe of get_trained (:122-152): denoiser_init from seed 0,
# AdamW at 2e-3 without decay, sl_denoiser_loss on [0.05, 50], log time.
STANDINS = {
    "policy": dict(n_layers=4, d_model=128, n_heads=4, d_ff=512, seq_len=16, d_data=2,
                   d_cond=4, data=dict(kind="RobotReach", horizon=16, batch=128),
                   steps=400),
    "pixel": dict(n_layers=3, d_model=96, n_heads=4, d_ff=384, seq_len=64, d_data=24,
                  d_cond=0, data=dict(kind="BlobImages", grid=8, patch_dim=24, batch=32),
                  steps=250),
}
T_MIN, T_MAX = 0.05, 50.0
# standin_reference: card against CPU samples, relative to max |sample|.
# Float32 sums in other orders, chained over 100 steps: an H100 run
# (700 W) read 7.4e-6 (1.70e-4 at a scale of 22.9); on the CPU the float32
# run sits 5.8e-6 (1.32e-4) from the model computed in float64.
STANDIN_REF_TOL = 2e-5
STANDIN_LR = 2e-3
# the sampling settings of fig5 / table3 (K 100, 8 chains, theta 8 and 24,
# the eager head at 24, 96 episodes) and of fig4's quick run (K 200, theta 8)
POLICY_K, POLICY_CHAINS, POLICY_THETAS, POLICY_EPISODES = 100, 8, (8, 24), 96
PIXEL_K, PIXEL_CHAINS, PIXEL_THETA = 200, 16, 8
# train_full_width: paper-pixel-dit on BlobImages of its own shape
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_LR = 8, 5, 3, 1e-4
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"


def _fresh_dir(name):
    import shutil

    path = CKPT_ROOT / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _sl_loss_fn(dc):
    from repro_torch.models.diffusion import sl_denoiser_loss

    def loss_fn(p, batch, gen):
        return sl_denoiser_loss(p, dc, batch["x0"], gen, T_MIN, T_MAX,
                                cond=batch.get("cond")), {}

    return loss_fn


class _StepTimer:
    """Wraps a train step: CUDA events around each call, on the card."""

    def __init__(self, torch, step):
        self.torch, self.step, self.events = torch, step, []

    def __call__(self, *args):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.step(*args)
        ev[1].record()
        self.events.append(ev)
        return out

    def ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _grad_recorder(torch, opt, at_step):
    """The optimizer, recording for each leaf whether the gradient it gets
    at step ``at_step`` is finite and not all zero."""
    from repro_torch import pytree
    from repro_torch.training.optimizer import Optimizer

    seen = {}

    def update(grads, state, params):
        if int(state["step"]) + 1 == at_step:
            flat = pytree.leaves(grads)
            seen["finite"] = torch.stack([torch.isfinite(g).all() for g in flat]).tolist()
            seen["nonzero"] = torch.stack([g.abs().amax() > 0 for g in flat]).tolist()
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.schedule), seen


def run_train_full_width(torch, dev):
    """train_full_width: paper-pixel-dit at full width and PIXEL_DEPTH
    layers (bf16 compute, float32 params, remat) through repro_torch.training.loop.run: 5 steps of
    sl_denoiser_loss and AdamW on BlobImages of its own shape, async
    checkpoints every 3 steps; then a run resumed from the step-3
    checkpoint, and the last checkpoint restored against the live state."""
    import shutil

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.registry import paper_pixel_dit
    from repro_torch.data.pipeline import BlobImages
    from repro_torch.training import loop
    from repro_torch import pytree
    from repro_torch.training.optimizer import adamw, constant_schedule
    from repro_torch.training.train_step import make_train_step
    from repro_torch.weights import denoiser_init_params

    dc = paper_pixel_dit()
    dc = dataclasses.replace(dc, backbone=dataclasses.replace(dc.backbone,
                                                              n_layers=PIXEL_DEPTH))
    cfg = dc.backbone
    batch = TRAIN_BATCH
    grid = int(round(dc.seq_len ** 0.5))
    data = BlobImages(grid=grid, patch_dim=dc.d_data, batch=batch)
    if data.seq_len != dc.seq_len:
        fail(f"train_full_width: {grid}x{grid} patches for {dc.seq_len} tokens")
    opt, seen = _grad_recorder(torch, adamw(constant_schedule(TRAIN_LR)), at_step=2)
    step = _StepTimer(torch, make_train_step(_sl_loss_fn(dc), opt))
    batch_fn = lambda s: {"x0": data.batch_at(s)}
    fresh = lambda: denoiser_init_params(dc, torch.Generator(device=dev).manual_seed(SEED),
                                         device=dev)
    run_dir = _fresh_dir("train_full_width")
    params = fresh()
    n_params = sum(p.numel() for p in pytree.leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lcfg = loop.LoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=str(run_dir / "a"),
                           ckpt_every=TRAIN_CKPT_EVERY, keep=3)
    params, opt_state, last, hist = loop.run(step, params, opt.init(params), batch_fn,
                                             SEED, lcfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = step.ms()
    losses = [h["loss"] for h in hist]
    if last != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"train_full_width: {last} steps, losses {losses}")
    names = [".".join(path) for path, _ in pytree.paths(params)]
    if not seen or not all(seen["finite"]) or not all(seen["nonzero"]):
        bad = [n for n, f, z in zip(names, seen.get("finite", []), seen.get("nonzero", []))
               if not (f and z)]
        fail(f"train_full_width: step 2 gradients not finite and nonzero for {bad or names}")

    # resumed: the step-3 checkpoint alone in a new directory, 2 more steps
    shutil.copytree(run_dir / "a" / f"step_{TRAIN_CKPT_EVERY:09d}",
                    run_dir / "b" / f"step_{TRAIN_CKPT_EVERY:09d}")
    p_b = fresh()
    p_b, s_b, last_b, hist_b = loop.run(make_train_step(_sl_loss_fn(dc), opt), p_b,
                                        opt.init(p_b), batch_fn, SEED,
                                        dataclasses.replace(lcfg, ckpt_dir=str(run_dir / "b")),
                                        device=dev)
    num = sum(float((a - b).double().square().sum()) for a, b in
              zip(pytree.leaves(p_b), pytree.leaves(params)))
    den = sum(float(b.double().square().sum()) for b in pytree.leaves(params))
    resume_rel = math.sqrt(num / den)
    if last_b != TRAIN_STEPS or [h["step"] for h in hist_b] != [4, 5] or \
            not resume_rel <= 1e-5:
        fail(f"train_full_width: resumed run at step {last_b}, relative L2 {resume_rel}")
    del p_b, s_b
    restored, manifest = ckpt.restore(str(run_dir / "a"), None,
                                      {"params": params, "opt": opt_state})
    live = pytree.leaves({"params": params, "opt": opt_state})
    same = all(torch.equal(a, b) for a, b in zip(pytree.leaves(restored), live))
    if manifest["step"] != TRAIN_STEPS or not same:
        fail(f"train_full_width: checkpoint of step {manifest['step']} is not the live "
             "state bit for bit")
    del restored
    shutil.rmtree(run_dir, ignore_errors=True)
    gen = loop.step_generator(SEED, TRAIN_STEPS, dev)
    x0 = {"x0": torch.from_numpy(data.batch_at(TRAIN_STEPS)).to(dev)}
    wall_ms, kernels = _profiled(torch, lambda: step.step(params, opt_state, x0, gen))
    _emit_profile(torch, "train_profile", wall_ms, kernels,
                  "one warm full-width training step (forward, recompute, backward, "
                  "AdamW) under torch.profiler")

    tokens = batch * dc.seq_len
    hd = cfg.d_model // cfg.n_heads
    # 4 passes over the products (forward, recompute, the backward's two),
    # 2 operations a multiply-add; naive attention's QK^T and PV the same way
    linear_flops = 8.0 * n_params * tokens
    attn_flops = 4 * 4.0 * batch * cfg.n_heads * dc.seq_len ** 2 * hd * cfg.n_layers
    warm = step_ms[1:]
    warm_ms = statistics.mean(warm)
    emit("train_full_width", model=cfg.name, params=n_params, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, d_ff=cfg.d_ff, seq_len=dc.seq_len,
         d_data=dc.d_data, compute_dtype=cfg.compute_dtype, remat=cfg.remat,
         batch=batch, tokens_per_step=tokens, lr=TRAIN_LR, steps=last, losses=losses,
         step_ms=step_ms, warm_step_ms=warm_ms, peak_memory_gb=peak_gb, wall_s=wall,
         step2_gradients="every leaf finite and nonzero", leaves=len(names),
         flop_per_step=linear_flops + attn_flops, linear_flop=linear_flops,
         attention_flop=attn_flops,
         tflops=(linear_flops + attn_flops) / (warm_ms * 1e-3) / 1e12,
         bound_ms_at_bf16_peak=(linear_flops + attn_flops) / PEAK_BF16 * 1e3,
         resumed_relative_l2=resume_rel, resumed_steps=[h["step"] for h in hist_b],
         checkpoint_restored="equal bits", checkpoint_every=TRAIN_CKPT_EVERY,
         note="warm step ms by CUDA events around train_step (steps 2-5); the loop "
              "adds the batch, the per-step generator and the metrics read")


# lm_train: the LM trainer's CLI at full width (its default arch, xlstm,
# and hymba through B7's forward and backward), 12 steps of 8 x 128 tokens
# (xlstm 8 x 32: its sLSTM loop runs forward, recomputed and backward at
# ~0.6 ms a position a layer, host-bound, 2.4 s a step at 128 on an NVIDIA
# H100 80GB HBM3, 700.00 W)
LM_TRAIN_ARCHS = ("tinyllama-1.1b", "xlstm-125m", "hymba-1.5b")
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 12, 8, 128
# the step the resumed run starts from: the CLI's checkpoint interval,
# max(10, steps / 4)
LM_TRAIN_RESUME_FROM = max(10, LM_TRAIN_STEPS // 4)
LM_TRAIN_SEQ_BY_ARCH = {"xlstm-125m": 32}
LM_TRAIN_RESUMED = "xlstm-125m"
# B7's backward at hymba-1.5b's training shape (batch, seq, din * N)
SCAN_BWD_SHAPE = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, 1600 * 16)


def _train_cli(torch, argv):
    """``repro_torch.launch.train.main(argv)`` in process, its printed lines
    captured: (its result, the lines)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train.main(list(argv))
    torch.cuda.synchronize()
    return res, buf.getvalue().splitlines()


def run_lm_train(torch, dev):
    """lm_train: ``python -m repro_torch.launch.train --scale full --steps
    12 --batch 8 --seq 128`` (xlstm: --seq 32) in process for each of
    LM_TRAIN_ARCHS
    (bf16 compute, float32 params and AdamW state, remat, naive attention):
    losses (all finite; whether they fall is recorded, not gated: step 0's
    learning rate is 0 and warmup takes 10 steps), ms a step with the host's
    MarkovLM time apart, tokens/s, peak memory, launches.  xlstm's run
    writes checkpoints (--ckpt-dir: steps 10 and 12); a second call to 12
    steps in a directory holding only its step-10 checkpoint resumes there,
    and its losses must equal the straight run's within 1e-5 relative
    (train_full_width's tolerance)."""
    import shutil

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssm_scan.ops import linear_scan

    counters = _counters()

    def args(name, steps=LM_TRAIN_STEPS):
        return ("--arch", name, "--scale", "full", "--steps", str(steps), "--batch",
                str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ_BY_ARCH.get(name, LM_TRAIN_SEQ)))

    runs, results = {}, {}
    ckpt_dir = _fresh_dir("lm_train")
    for name in LM_TRAIN_ARCHS:
        seq = LM_TRAIN_SEQ_BY_ARCH.get(name, LM_TRAIN_SEQ)
        base = _fresh_memory(torch)
        _zero_counters(torch, counters)
        linear_scan.backward_launches = 0
        t0 = time.perf_counter()
        res, lines = _train_cli(torch, args(name) + (
            ("--ckpt-dir", str(ckpt_dir / "straight")) if name == LM_TRAIN_RESUMED else ()))
        wall = time.perf_counter() - t0
        runs[f"lm_train_{name}"] = _launches(counters)
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        step_ms = [(h["time"] - d) * 1e3 for h, d in zip(hist, res["data_s"])]
        if res["last_step"] != LM_TRAIN_STEPS or len(losses) != LM_TRAIN_STEPS or \
                not all(math.isfinite(x) for x in losses):
            fail(f"lm_train {name}: {res['last_step']} steps, losses {losses}")
        warm = statistics.mean(step_ms[1:])
        results[name] = dict(
            seq=seq, first_loss=losses[0], last_loss=losses[-1], losses=losses,
            loss_fell=losses[-1] < losses[0], step_ms=step_ms, warm_step_ms=warm,
            host_data_ms=[d * 1e3 for d in res["data_s"]],
            tokens_per_s=LM_TRAIN_BATCH * seq / warm * 1e3,
            peak_memory_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, wall_s=wall,
            launches={k: v for k, v in runs[f"lm_train_{name}"].items() if v},
            scan_backward_launches=linear_scan.backward_launches, printed=lines[-2:])
        torch.cuda.empty_cache()
    hymba = results["hymba-1.5b"]
    # each hymba step runs B7 once a layer in the forward, the recompute
    # (remat) and the backward
    hcfg = get_config("hymba-1.5b")
    per_step = hcfg.n_layers * (3 if hcfg.remat else 2)
    if hymba["scan_backward_launches"] != hcfg.n_layers * LM_TRAIN_STEPS or \
            hymba["launches"].get("ssm_scan") != per_step * LM_TRAIN_STEPS:
        fail(f"lm_train hymba: B7 launches {hymba['launches']}, backward "
             f"{hymba['scan_backward_launches']}")

    half = f"step_{LM_TRAIN_RESUME_FROM:09d}"
    shutil.copytree(ckpt_dir / "straight" / half, ckpt_dir / "resumed" / half)
    second, _ = _train_cli(torch, args(LM_TRAIN_RESUMED)
                           + ("--ckpt-dir", str(ckpt_dir / "resumed")))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    straight = results[LM_TRAIN_RESUMED]["losses"][LM_TRAIN_RESUME_FROM:]
    resumed = [h["loss"] for h in second["history"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    if [h["step"] for h in second["history"]] != list(range(LM_TRAIN_RESUME_FROM + 1,
                                                            LM_TRAIN_STEPS + 1)) or \
            len(resumed) != len(straight) or not rel <= 1e-5:
        fail(f"lm_train resume: steps {[h['step'] for h in second['history']]}, losses "
             f"{resumed} against {straight} (max relative {rel})")
    emit("lm_train", archs=results, batch=LM_TRAIN_BATCH, steps=LM_TRAIN_STEPS,
         resumed=dict(
             model=LM_TRAIN_RESUMED, from_checkpoint=LM_TRAIN_RESUME_FROM,
             resumed_steps=[h["step"] for h in second["history"]],
             max_relative_loss_difference=rel, tolerance=1e-5),
         note="python -m repro_torch.launch.train in process (tinyllama-1.1b is its default "
              "arch); step ms is the loop's time a step less the host's MarkovLM batch, "
              f"warm over steps 2-{LM_TRAIN_STEPS}; the batch, its copy and the metrics read "
              "are in it")
    return runs, hymba["scan_backward_launches"]


# lm_train_moe: qwen3-moe-30b-a3b trained at its published widths, cut to
# LM_TRAIN_MOE_LAYERS of its 48 layers (3.11 B params: float32 params,
# gradients and AdamW moments take 49.8 GB), LM_TRAIN_MOE_STEPS steps of
# LM_TRAIN_BATCH x LM_TRAIN_SEQ MarkovLM tokens through the CLI's build and
# loop.run in process (the CLI has no depth flag, nor has the JAX one);
# then the CLI at --scale smoke for both MoE archs
LM_TRAIN_MOE = "qwen3-moe-30b-a3b"
LM_TRAIN_MOE_LAYERS, LM_TRAIN_MOE_STEPS = 4, 10
LM_TRAIN_MOE_SMOKE = (("qwen3-moe-30b-a3b", 4), ("dbrx-132b", 4))


def run_lm_train_moe(torch, dev):
    """lm_train_moe: LM_TRAIN_MOE at published widths and LM_TRAIN_MOE_LAYERS
    layers (bf16 compute, float32 params and AdamW state, remat, naive
    attention, every expert on the card): losses and ``moe_aux`` finite
    (the aux > 0), ms a step without the host's MarkovLM batch, tokens/s,
    peak memory, no kernel of the port launched (the loss takes the naive
    core), and the step's bound from the port's analytic model
    (analyze_cell at accum 1: its flops at bf16's peak or its idealised
    bytes at the memory rate); one more warm step profiled
    (lm_train_moe_profile).  Then ``python -m repro_torch.launch.train
    --arch <moe> --scale smoke --steps 4`` in process for both MoE archs:
    finite losses."""
    from repro_torch import pytree
    from repro_torch.analysis.analytic import analyze_cell
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.launch import train
    from repro_torch.training.loop import LoopConfig, run

    cfg = dataclasses.replace(get_config(LM_TRAIN_MOE), n_layers=LM_TRAIN_MOE_LAYERS)
    counters = _counters()
    base = _fresh_memory(torch)
    train_step, init, _ = train.build(cfg, None, 1, 3e-4, LM_TRAIN_MOE_STEPS, device=dev)
    params, opt_state = init()
    n_params = sum(p.numel() for p in pytree.leaves(params))
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    data = MarkovLM(vocab=cfg.vocab_size, seq_len=LM_TRAIN_SEQ, batch=LM_TRAIN_BATCH)
    data_s, logged = [], []

    def batch_fn(step):
        t0 = time.perf_counter()
        batch = data.batch_at(step)
        data_s.append(time.perf_counter() - t0)
        return batch

    _zero_counters(torch, counters)
    t0 = time.perf_counter()
    params, opt_state, last, hist = run(
        train_step, params, opt_state, batch_fn, train._SEED,
        LoopConfig(total_steps=LM_TRAIN_MOE_STEPS, log_every=1),
        log_fn=lambda s, m: logged.append(m), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(LM_TRAIN_MOE_STEPS).items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 29)

    def step():
        nonlocal params, opt_state
        params, opt_state, _ = train_step(params, opt_state, batch, g)

    wall_ms, kernels, moe_ms = _profiled_moe(torch, step)
    _emit_profile(torch, "lm_train_moe_profile", wall_ms, kernels,
                  f"one warm {LM_TRAIN_MOE} training step at {cfg.n_layers} layers (forward, "
                  "remat recompute, backward, AdamW; 8 x 128 tokens) under torch.profiler; "
                  "moe_device_ms_by_group: the device time inside each MoE step's ranges "
                  "(forward and recompute; the backward runs outside them)",
                  model=LM_TRAIN_MOE, tokens=LM_TRAIN_BATCH * LM_TRAIN_SEQ,
                  moe_device_ms_by_group=moe_ms or "not measured")
    params = opt_state = None
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    aux = [m["moe_aux"] for m in logged]
    step_ms = [(h["time"] - d) * 1e3 for h, d in zip(hist, data_s)]
    if last != LM_TRAIN_MOE_STEPS or len(losses) != LM_TRAIN_MOE_STEPS or \
            not all(math.isfinite(x) for x in losses + aux) or not min(aux) > 0 or \
            not all(m["finite"] for m in logged) or any(launches.values()):
        fail(f"lm_train_moe: {last} steps, losses {losses}, moe_aux {aux}, launches "
             f"{launches}")
    warm = statistics.mean(step_ms[1:])
    cost = analyze_cell(cfg, InputShape("lm_train_moe", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                        "train"), n_params, accum=1, remat=cfg.remat)
    t_ops, t_bytes = cost.flops / PEAK_BF16 * 1e3, cost.hbm_bytes / HBM_BYTES_PER_S * 1e3
    smoke = {}
    for name, steps in LM_TRAIN_MOE_SMOKE:
        res, lines = _train_cli(torch, ("--arch", name, "--scale", "smoke", "--steps",
                                        str(steps)))
        got = [h["loss"] for h in res["history"]]
        if res["last_step"] != steps or len(got) != steps or \
                not all(math.isfinite(x) for x in got):
            fail(f"lm_train_moe: the CLI at {name} --scale smoke: {res['last_step']} steps, "
                 f"losses {got}")
        smoke[name] = dict(steps=steps, losses=got, printed=lines[-1:])
    emit("lm_train_moe", model=LM_TRAIN_MOE, layers=cfg.n_layers,
         published_layers=get_config(LM_TRAIN_MOE).n_layers, params=n_params,
         experts=cfg.n_experts, top_k=cfg.top_k, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         steps=LM_TRAIN_MOE_STEPS, losses=losses, moe_aux=aux,
         nll=[m["nll"] for m in logged], step_ms=step_ms, warm_step_ms=warm,
         tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / warm * 1e3,
         host_data_ms=[d * 1e3 for d in data_s], wall_s=wall,
         params_and_adamw_state_gb=state_gb, peak_memory_gb=peak_gb,
         launches={k: v for k, v in launches.items() if v},
         bound=dict(tflop=cost.flops / 1e12, gb=cost.hbm_bytes / 1e9, ops_ms=t_ops,
                    bytes_ms=t_bytes, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    source="repro_torch.analysis.analytic.analyze_cell(accum=1, remat)"),
         cli_smoke=smoke,
         note="train.build + loop.run in process (LoopConfig log_every 1 for moe_aux); "
              "step ms is the loop's time a step less the host's MarkovLM batch, warm over "
              "steps 2-10")
    return {f"lm_train_{LM_TRAIN_MOE}": launches}


def ptxas_of(log, kernel):
    """Registers, spills and stack of ``kernel`` from an -Xptxas -v log, or
    None where the log has no line for it."""
    import re

    m = re.search(kernel + r"\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads\nptxas info\s*: Used (\d+) registers", log)
    if m is None:
        return None
    stack, st, ld, regs = (int(x) for x in m.groups())
    return dict(registers=regs, spill_store_bytes=st, spill_load_bytes=ld, stack_bytes=stack)


def _ptxas_info(stem, kernel):
    """``ptxas_of`` the build log of ``csrc/<stem>.cu``; fails where it has
    no line for ``kernel``."""
    from repro_torch.kernels import _build

    info = ptxas_of((Path(_build.build_info["path"]).parent / f"{stem}.log").read_text(),
                    kernel)
    if info is None:
        fail(f"build: no ptxas line for {kernel} in {stem}.log")
    return info


def _scan_inputs(torch, dev, B, L, D, seed, grad=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = 0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)
    b = torch.randn(B, L, D, generator=g, device=dev)
    G = torch.randn(B, L, D, generator=g, device=dev)
    return (a.requires_grad_(grad), b.requires_grad_(grad), G)


def check_ssm_scan_backward(torch, dev):
    """B7's backward kernel (``csrc/ssm_scan_bwd.cu``) at hymba-1.5b's
    training shape: under autograd, h, da and db against autograd through
    the plain loop within 1e-5 of each tensor's largest magnitude, and one
    forward and one backward launch; da and db equal in bits to
    ``ssm_scan_backward_plain`` there, at edge shapes and for an upstream
    gradient that is not contiguous; the device work of one call, read from
    a CUDA graph that captures it (the backward kernel alone; beside the
    forward kernel in a forward and backward; after one copy for a strided
    gradient); the kernel timed as in phase 3 against the plain reverse
    loop with its bound (a, h and G read once, da and db written once), the
    whole autograd call by events, and the build's registers and spills.
    Then B7's forward at the same shape, timed as in phase 3 with its bound
    (a and b read, h written).  Returns the two rows."""
    from repro_torch.kernels.ssm_scan.ops import (linear_scan, ssm_scan_backward_cuda,
                                                  ssm_scan_backward_plain, ssm_scan_plain)

    B, L, D = SCAN_BWD_SHAPE
    a, b, G = _scan_inputs(torch, dev, B, L, D, SEED + 26, grad=True)
    h = linear_scan(a, b)
    before = linear_scan.launches, linear_scan.backward_launches
    da, db = torch.autograd.grad(h, (a, b), G, retain_graph=True)
    torch.cuda.synchronize()
    launched = (linear_scan.launches - before[0], linear_scan.backward_launches - before[1])
    hp = ssm_scan_plain(a, b)
    rda, rdb = torch.autograd.grad(hp, (a, b), G, retain_graph=True)
    errs = {k: ((x - y).abs().max() / y.abs().max()).item()
            for k, x, y in (("h", h, hp), ("da", da, rda), ("db", db, rdb))}
    if launched != (1, 1) or not all(e <= 1e-5 for e in errs.values()):
        fail(f"ssm_scan_backward: relative errors {errs}, (launches, backward launches) "
             f"{launched}")
    err = max((da - rda).abs().max().item(), (db - rdb).abs().max().item())
    del hp, rda, rdb
    a0, h0 = a.detach(), h.detach()
    pa, pb = ssm_scan_backward_plain(a0, h0, G)
    equal = {"training shape, autograd": bool(torch.equal(da, pa) and torch.equal(db, pb))}
    for B_, L_, D_ in ((2, 37, 25601), (3, 17, 130), (2, 1, 25600), (2, 50, 1), (2, 33, 256)):
        ea, eb, eG = _scan_inputs(torch, dev, B_, L_, D_, B_ * L_ + D_)
        eh = ssm_scan_plain(ea, eb)
        got, want = ssm_scan_backward_cuda(ea, eh, eG), ssm_scan_backward_plain(ea, eh, eG)
        equal[f"{(B_, L_, D_)}"] = all(torch.equal(x, y) for x, y in zip(got, want))
    ea, eb, eG = _scan_inputs(torch, dev, 2, 40, 96, 5, grad=True)
    eh = linear_scan(ea, eb)
    got = torch.autograd.grad(eh, (ea, eb), eG.transpose(1, 2).contiguous().transpose(1, 2))
    want = ssm_scan_backward_plain(ea.detach(), eh.detach(), eG)
    equal["(2, 40, 96), G not contiguous"] = all(torch.equal(x, y) for x, y in zip(got, want))
    torch.cuda.synchronize()
    if not all(equal.values()):
        fail(f"ssm_scan_backward: kernel and plain backward differ in bits: {equal}")
    # the device work of one forward and backward through autograd (fresh
    # leaves, so the whole call is captured on one stream), of the
    # Function's backward alone, and of it for a strided gradient (one copy
    # more), each read from a CUDA graph that captures the call
    def autograd_call():
        fa, fb = a0.detach().requires_grad_(), b.detach().requires_grad_()
        return torch.autograd.grad(linear_scan(fa, fb), (fa, fb), G)

    G_strided = G.transpose(1, 2).contiguous().transpose(1, 2)
    calls = {"forward and backward through autograd.grad": _captured_work(torch, autograd_call),
             "backward": _captured_work(torch, lambda: h.grad_fn.apply(G)),
             "backward, strided gradient": _captured_work(
                 torch, lambda: h.grad_fn.apply(G_strided))}
    del G_strided
    kinds = {k: [(kind, name and ("ssm_scan_bwd_kernel" if "ssm_scan_bwd_kernel" in name else
                                  "ssm_scan_kernel" if "ssm_scan_kernel" in name else "other"))
                 for kind, name in c] for k, c in calls.items()}
    want = {"forward and backward through autograd.grad": [("KERNEL", "ssm_scan_kernel"),
                                                          ("KERNEL", "ssm_scan_bwd_kernel")],
            "backward": [("KERNEL", "ssm_scan_bwd_kernel")],
            "backward, strided gradient": [("KERNEL", "other"),
                                           ("KERNEL", "ssm_scan_bwd_kernel")]}
    if kinds != want:
        fail(f"ssm_scan_backward: captured device work {calls}, expected {want}")
    times = kernel_times(lambda: ssm_scan_backward_cuda(a0, h0, G),
                         lambda: ssm_scan_backward_plain(a0, h0, G), reps=20,
                         wrapper=linear_scan)
    autograd_ms = cold_ms(lambda: torch.autograd.grad(h, (a, b), G, retain_graph=True),
                          reps=20)
    n = B * L * D
    bms, by = bound_ms(20.0 * n, 3.0 * n, PEAK_F32)
    build = _ptxas_info("ssm_scan_bwd", "ssm_scan_bwd_kernel")
    emit("ssm_scan_backward", shape=[B, L, D], dtype="float32", max_abs_err=err,
         relative_errors=errs, equal_bits=equal,
         device_work_per_call=calls,
         **times, autograd_call_ms=autograd_ms, library=None, bound_ms=bms, bound_by=by,
         share_of_bound=bms / times["device_ms"] if times["device_ms"] else None,
         device_ms_below_bound=bool(times["device_ms"] and times["device_ms"] < bms),
         build=build, tolerance="1e-5 of each tensor's largest magnitude (h, da, db) "
                                "against autograd through the loop; equal bits against "
                                "ssm_scan_backward_plain",
         note="the kernel timed through its wrapper; plain is the reverse loop; "
              "autograd_call_ms is one torch.autograd.grad through linear_scan")
    del da, db, pa, pb
    bwd = dict(name="ssm_scan_backward", at=f"hymba-1.5b training {list(SCAN_BWD_SHAPE)}",
               route="cuda", source="src/repro_torch/csrc/ssm_scan_bwd.cu",
               replaces="none: src/repro/kernels/ssm_scan/ref.py:17 (the JAX package "
                        "differentiates its associative scan by autodiff)",
               max_abs_err=err, **times, bound_ms=bms, bound_by=by, build=build)

    a1, b1 = a.detach(), b.detach()
    hk = linear_scan(a1, b1)
    torch.cuda.synchronize()
    if not torch.equal(hk, ssm_scan_plain(a1, b1)):
        fail("ssm_scan: the forward differs from the plain loop at the training shape")
    ftimes = kernel_times(lambda: linear_scan(a1, b1), lambda: ssm_scan_plain(a1, b1), reps=20,
                          wrapper=linear_scan)
    fbms, fby = bound_ms(12.0 * n, 2.0 * n, PEAK_F32)
    emit("ssm_scan_training_shape", shape=[B, L, D], dtype="float32", equal_bits=True,
         **ftimes, bound_ms=fbms, bound_by=fby,
         share_of_bound=fbms / ftimes["device_ms"] if ftimes["device_ms"] else None)
    fwd = dict(name="ssm_scan", at=f"forward, hymba-1.5b training {list(SCAN_BWD_SHAPE)}",
               route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
               replaces="src/repro/kernels/ssm_scan/kernel.py:27", max_abs_err=0.0, **ftimes,
               bound_ms=fbms, bound_by=fby)
    return bwd, fwd


def run_lm_train_profile(torch, dev):
    """lm_train_profile: one warm hymba-1.5b training step at lm_train's
    shape (8 x 128 random tokens through the CLI's train step: lm_loss,
    remat, AdamW) under torch.profiler, device ms by group (B7 forward, B7
    backward, matmuls, other) and idle share; then the upstream gradient
    one full-width mamba mixer (layer 1) hands B7's backward at that shape:
    contiguous, so the backward copies nothing before its launch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.nn.ssm import mamba_fwd

    cfg = get_config("hymba-1.5b")
    train_step, init, _ = train.build(cfg, None, 1, 3e-4, LM_TRAIN_STEPS, device=dev)
    params, opt_state = init()
    g = torch.Generator(device=dev).manual_seed(SEED + 28)
    toks = torch.randint(0, cfg.vocab_size, (LM_TRAIN_BATCH, LM_TRAIN_SEQ + 1), generator=g,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params, opt_state, _ = train_step(params, opt_state, batch, g)  # warm-up
    torch.cuda.synchronize()

    def step():
        nonlocal params, opt_state
        params, opt_state, _ = train_step(params, opt_state, batch, g)

    wall_ms, kernels = _profiled(torch, step)
    _emit_profile(torch, "lm_train_profile", wall_ms, kernels,
                  "one warm hymba-1.5b training step (forward, remat recompute, backward, "
                  "AdamW; 8 x 128 tokens) under torch.profiler: ssm_scan is B7's forward "
                  "(twice a layer), ssm_scan_backward its backward kernel; 'other' the "
                  "elementwise kernels, norms, casts and AdamW", arch=cfg.name,
                  tokens=LM_TRAIN_BATCH * LM_TRAIN_SEQ)
    layer = {k: v[1].detach().requires_grad_() for k, v in
             params["decoder"]["g0"]["mamba"].items()}
    params = opt_state = None
    torch.cuda.empty_cache()
    x = torch.randn(LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.d_model, generator=g,
                    device=dev).to(torch.bfloat16).requires_grad_()
    out = mamba_fwd(layer, x, cfg)
    seen, stack, visited = [], [out.grad_fn], set()
    while stack:  # the scan's backward node, found in the mixer's graph
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        if type(node).__name__ == "_LinearScanBackward":
            node.register_prehook(lambda grads: seen.append(grads[0]))
        stack.extend(nxt for nxt, _ in node.next_functions)
    torch.autograd.grad(out, x, torch.randn_like(out))
    torch.cuda.synchronize()
    if len(seen) != 1 or not seen[0].is_contiguous():
        fail("lm_train_profile: the mixer's scan gradients "
             f"{[(tuple(t.shape), t.stride()) for t in seen]}")
    emit("mamba_scan_gradient", shape=list(seen[0].shape), stride=list(seen[0].stride()),
         contiguous=True, note="the upstream gradient of B7's output in one full-width "
                               "hymba-1.5b mamba mixer at the training shape")


@contextlib.contextmanager
def _route_inputs(torch):
    """Records each ``_route`` call's (params, x, cfg), detached, while the
    block runs."""
    from repro_torch.nn import moe

    log, route = [], moe._route

    def recorded(params, x, cfg, capacity=None):
        log.append(({k: v.detach() for k, v in params.items()}, x.detach(), cfg))
        return route(params, x, cfg, capacity)

    moe._route = recorded
    try:
        yield log
    finally:
        moe._route = route


def _drops_and_edge_ties(torch, log):
    """(pairs the capacity dropped, positive ties at its edge) over the
    routes of a ``_route_inputs`` log: a positive tie there would let two
    top-k's keep different tokens."""
    from repro_torch.nn import moe

    dropped = ties = 0
    with torch.no_grad():
        for params, x, cfg in log:
            keep = moe._route(params, x, cfg)[2]
            C, L = keep.shape[-1], x.shape[1]
            dropped += x.shape[0] * L * cfg.top_k - int(keep.sum())
            if C < L:
                w = moe._route(params, x, cfg, L)[0].sort(-1, descending=True).values
                ties += int(((w[..., C - 1] == w[..., C]) & (w[..., C] > 0)).sum())
    return dropped, ties


# lm_train_reference's case where the capacity drops (token, expert) pairs:
# reduced qwen3-moe at capacity_factor 1.0 (C 16 of 32 positions a row and
# expert), its routers scaled by 25 so the tokens' choices spread
MOE_DROP_CASE = ("qwen3-moe-30b-a3b", 1.0, 25.0)


def check_lm_train_reference(torch, dev):
    """lm_train_reference: one lm_loss gradient of every arch's reduced
    config in float32 (llama-vision with stub vision, musicgen with stub
    frames; the MoE archs with the router's aux term, and reduced qwen3-moe
    once more at capacity_factor 1.0, where the capacity drops pairs and no
    positive tie sits at its edge), the same params and batch on the card
    and on the CPU: the loss within 1e-5, every leaf's gradient within 1e-4
    of its largest magnitude (AdamW's first update, ~lr sign(g), would flip
    for gradients near 0), ``moe_aux`` within 1e-5.  B7 runs forward and
    backward for hymba; B2 never (the loss takes the naive core)."""
    from repro_torch import pytree
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.models.lm import lm_loss
    from repro_torch.weights import init_lm_params

    counters = _counters()
    results = {}
    drop_name, drop_cf, drop_router = MOE_DROP_CASE
    for name in list(ARCHS) + [f"{drop_name} capacity_factor {drop_cf:g}"]:
        dropping = name not in ARCHS
        cfg = reduced(get_config(drop_name if dropping else name))
        params = init_lm_params(cfg, SEED, device="cpu")
        if dropping:
            cfg = dataclasses.replace(cfg, capacity_factor=drop_cf)
            params["decoder"]["g0"]["moe"]["router"].mul_(drop_router)
        g = torch.Generator().manual_seed(SEED + 27)
        batch = {"tokens": (torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
                            if cfg.embed_inputs else torch.randn(2, 32, cfg.d_model,
                                                                 generator=g)),
                 "labels": torch.randint(0, cfg.vocab_size, (2, 32), generator=g)}
        if cfg.n_vision_tokens:
            batch["vision"] = torch.randn(2, cfg.n_vision_tokens, cfg.d_model, generator=g)
        out = {}
        _zero_counters(torch, counters)
        linear_scan.backward_launches = 0
        for where in ("cpu", dev):
            ps = [p.to(where).requires_grad_() for p in pytree.leaves(params)]
            with _route_inputs(torch) as routes:
                loss, metrics = lm_loss(pytree.unflatten(params, ps),
                                        {k: v.to(where) for k, v in batch.items()}, cfg)
            if where == "cpu":
                dropped, ties = _drops_and_edge_ties(torch, routes)
            out[str(where)] = (loss.item(), [t.cpu() for t in torch.autograd.grad(loss, ps)],
                               metrics["moe_aux"].item())
        torch.cuda.synchronize()
        (l_cpu, g_cpu, a_cpu), (l_card, g_card, a_card) = out["cpu"], out[str(dev)]
        rel = max(((c - p).abs().max() / p.abs().max()).item() for c, p in zip(g_card, g_cpu))
        launches = _launches(counters)
        scans = 2 * cfg.n_layers if name == "hymba-1.5b" else 0  # forward + backward
        moe = {}
        if cfg.n_experts:
            moe = dict(moe_aux=a_cpu, moe_aux_abs_err=abs(a_card - a_cpu),
                       capacity_factor=cfg.capacity_factor, dropped_pairs=dropped,
                       positive_edge_ties=ties)
            if not (a_cpu > 0 and abs(a_card - a_cpu) <= 1e-5 and ties == 0
                    and (dropped > 0) == dropping):
                fail(f"lm_train_reference {name}: moe_aux {a_card} against {a_cpu}, "
                     f"{dropped} pairs dropped, {ties} positive edge ties")
        elif a_cpu != 0.0 or a_card != 0.0:
            fail(f"lm_train_reference {name}: moe_aux {a_card}, {a_cpu} without MoE")
        if not (abs(l_card - l_cpu) <= 1e-5 and rel <= 1e-4) or launches["ssm_scan"] != scans \
                or linear_scan.backward_launches != scans // 2 or launches["flash_attention"] \
                or launches["flash_attention_f32"]:
            fail(f"lm_train_reference {name}: loss {l_card} against {l_cpu}, gradients "
                 f"{rel} of scale, launches {launches}")
        results[name] = dict(loss=l_cpu, loss_abs_err=abs(l_card - l_cpu),
                             max_grad_err_of_scale=rel, **moe,
                             card_launches={k: v for k, v in launches.items() if v})
    emit("lm_train_reference", batch=[2, 32], archs=results,
         tolerance="loss 1e-5; each leaf's gradient 1e-4 of its largest magnitude; "
                   "moe_aux 1e-5")


# the dry run's cells driven here: each kind, at its published shape
DRYRUN_CELLS = ("tinyllama-1.1b:train_4k", "tinyllama-1.1b:prefill_32k",
                "tinyllama-1.1b:decode_32k", "hymba-1.5b:train_4k", "hymba-1.5b:long_500k",
                "paper-diffusion-policy:asd", "paper-pixel-dit:asd:memopt",
                "dbrx-132b:prefill_32k")
DRYRUN_TOO_LARGE = ("dbrx-132b:prefill_32k",)
DRYRUN_REFUSED = "tinyllama-1.1b:train_4k:fsdp"
DRYRUN_FRACTION_LIMIT = 1.05  # no step beats its bound (5 % for the timing's spread)


def run_dryrun(torch, dev):
    """The dry run (``repro_torch.launch.dryrun``) through ``run_cell`` into
    a temporary directory, one DRYRUN_CELLS cell after another on the
    single-pod mesh.  Gates: every cell reckoned to fit measured ok and
    finite, no fraction of its bound above DRYRUN_FRACTION_LIMIT, the
    DRYRUN_TOO_LARGE cells too large with no byte allocated, B2 once an
    attention layer in each prefill and never in training (the naive
    core), B7's forward twice (remat) and its backward once a chunk a layer
    in hymba's step, B1 once and B2 twice a layer (the eager head's call
    and the verification call) in each ASD round; DRYRUN_REFUSED refused
    naming ROADMAP A13.  Returns
    the launches of each cell's run and B7's backward launches in hymba's
    step."""
    import tempfile

    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.launch import dryrun

    counters = _counters()
    by_run, summary = {}, {}
    scan_backward = 0
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        for spec in DRYRUN_CELLS:
            (arch, shape, variant), = dryrun.parse_cells(spec)
            _zero_counters(torch, counters)
            bwd0 = linear_scan.backward_launches
            allocated = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, "single", out, variant)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = f"dryrun_{arch}_{shape}"
            by_run[run] = _launches(counters)
            m = rec.get("measured", {})
            fields = {k: m.get(k) for k in ("status", "what", "ms", "bound_ms", "bound_by",
                                             "fraction", "tokens_per_s", "peak_gb",
                                             "reckoned_gb", "capture_ms", "finite")}
            per_run = {k: v for k, v in m.get("launches_per_run", {}).items() if v}
            emit("dryrun", cell=spec, wall_s=wall, record_status=rec["status"],
                 error=rec.get("error"), params_total=rec.get("params_total"),
                 dominant=rec.get("roofline", {}).get("dominant"),
                 roofline_bound_s=rec.get("roofline", {}).get("bound_s"), **fields,
                 launches_per_run=per_run, launches_in_run=by_run[run],
                 device=m.get("device"))
            summary[spec] = fields
            if rec["status"] != "ok":
                fail(f"dryrun {spec}: {rec.get('error')}")
            if spec in DRYRUN_TOO_LARGE:
                if m["status"] != "too_large" or torch.cuda.memory_allocated() != allocated:
                    fail(f"dryrun {spec}: {m['status']}, allocated "
                         f"{torch.cuda.memory_allocated() - allocated} bytes")
                continue
            if m["status"] != "ok" or not m["finite"] or \
                    not 0 < m["fraction"] <= DRYRUN_FRACTION_LIMIT:
                fail(f"dryrun {spec}: {fields}")
            cell = dryrun.resolve_cell(arch, shape, variant)
            cfg = cell.cfg
            if cell.kind == "asd" and per_run != {"grs": 1, "flash_attention": 2 * cfg.n_layers}:
                fail(f"dryrun {spec}: launches a round {per_run}, expected B1 once and B2 "
                     f"once a layer in the eager head's call and in the verification call "
                     f"({2 * cfg.n_layers})")
            if shape == "prefill_32k" and per_run != {"flash_attention": _attention_layers(cfg)}:
                fail(f"dryrun {spec}: launches a prefill {per_run}, expected B2 once in each "
                     f"of {_attention_layers(cfg)} attention layers")
            if shape == "train_4k" and arch == "hymba-1.5b":
                scan_backward = linear_scan.backward_launches - bwd0
                chunks = cfg.n_layers * -(-4096 // MAMBA_CHUNK)
                if per_run != {"ssm_scan": 2 * chunks, "ssm_scan_backward": chunks}:
                    fail(f"dryrun {spec}: launches a step {per_run}, expected B7's forward "
                         f"{2 * chunks} (remat) and backward {chunks}")
            elif shape == "train_4k" and per_run:
                fail(f"dryrun {spec}: launches a step {per_run}, expected none")
    try:
        dryrun.parse_cells(DRYRUN_REFUSED)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "A13" not in refused:
        fail(f"dryrun {DRYRUN_REFUSED}: not refused naming A13 ({refused})")
    emit("dryrun_summary", cells=summary, refused={DRYRUN_REFUSED: refused},
         fraction_limit=DRYRUN_FRACTION_LIMIT)
    return by_run, scan_backward


# the plain attention runs a group of heads at a time, as many as keep its
# float32 scores within this (one head's at a 32k prefill take 4.3 GB)
PLAIN_SCORE_BYTES = 1 << 32
# B2 at the 32k prefill shape the smoke holds against its plain version
# (tinyllama-1.1b's); tools/flash_prefill_32k.py takes the other archs'
DRYRUN_PREFILL_FLASH = ("tinyllama-1.1b", (1, 32768, 32768, 32, 64))
# the ASD cells of DRYRUN_CELLS whose B1 and B2 shapes get kernels-line rows
DRYRUN_ASD_CELLS = ("paper-diffusion-policy:asd", "paper-pixel-dit:asd:memopt")


def flash_shape_row(torch, dev, at, shape, causal, window=0, softcap=0.0, seed=SEED + 80,
                    reps=3):
    """B2 (bf16, the wgmma kernel) at one (B, Lq, S, H, hd) shape, held
    against its plain version within FLASH_TOLERANCE (fails outside it),
    the plain version a group of heads at a time (PLAIN_SCORE_BYTES); then
    the kernel, the plain version and the library call timed as in phase 3,
    with the bound (bf16 operations at 989 TFLOP/s or bytes at 3.35 TB/s).
    The library call is SDPA (is_causal, or the boolean band mask for a
    window); with a softcap there is none.  Returns the kernels-line row."""
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha, flash_wgmma
    from repro_torch.nn.attention import attn_mask

    B, Lq, S, H, hd = shape
    q, k, v = _flash_inputs(torch, dev, B, Lq, S, H, hd, seed)
    opts = dict(causal=causal, window=window, softcap=softcap)
    per = max(1, min(H, PLAIN_SCORE_BYTES // (4 * B * Lq * S)))

    def kernel():
        return flash_mha(q, k, v, **opts)

    def plain():
        return torch.cat([attention_plain(q[:, :, h:h + per], k[:, :, h:h + per],
                                          v[:, :, h:h + per], **opts)
                          for h in range(0, H, per)], dim=2)

    ok, op = kernel(), plain()
    torch.cuda.synchronize()
    used = _flash_tolerance_used(ok, op)
    err = (ok.float() - op.float()).abs().max().item()
    del ok, op
    where = (f"{at} {list(shape)}{' causal' if causal else ''}"
             f"{f' window {window}' if window else ''}{f' softcap {softcap:g}' if softcap else ''}")
    if not used <= 1.0:
        fail(f"flash at {where}: {used} of the tolerance ({FLASH_TOLERANCE})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = attn_mask(Lq, S, True, window, dev) if window else None
    library = None if softcap else (lambda: sdpa(qt, kt, vt, attn_mask=mask)) if window else (
        lambda: sdpa(qt, kt, vt, is_causal=causal))
    times = kernel_times(kernel, plain, library, reps=reps, wrapper=flash_wgmma)
    flops = 4.0 * B * H * _attended_pairs(Lq, S, causal, window) * hd
    bms, by = bound_ms(2.0 * B * H * hd * (2 * Lq + 2 * S), flops, PEAK_BF16)
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda", source=FLASH_WGMMA_SOURCE,
                replaces=FLASH_REPLACES, at=where, shape=list(shape), causal=causal,
                window=window, softcap=softcap, max_abs_err=err, tolerance=FLASH_TOLERANCE,
                tolerance_used=used, **times,
                library=("none (no single call: softcap)" if softcap else
                         "scaled_dot_product_attention"
                         + (" with the boolean band mask" if window else "")),
                bound_ms=bms, bound_by=by, tflops=_tflops(flops, times),
                share_of_bound=bms / times["device_ms"] if times["device_ms"] else None,
                note=f"plain: attention_plain {per} head(s) at a time")


def check_dryrun_kernels(torch, dev):
    """B1, B2 and B7 at the shapes the dry run's cells (phase ``dryrun``)
    give them, against their plain versions and timed as in phase 3, with
    their bounds: B2 at tinyllama-1.1b's 32k prefill (1, 32768, 32, 64)
    causal (``flash_shape_row``); in each DRYRUN_ASD_CELLS cell, GRS over
    its chains x theta rows of the event, within 1e-5, and B2 non-causal at
    the eager head's proposal call (the chains) and at the verification
    call (chains x (theta + 1) points), half a round's launches each; B7's
    forward and backward kernels at the chunk hymba-1.5b's train_4k step
    gives them, (1, 1024, 25600), in bits.  Returns (the B1 and B2 rows,
    each with the runs at its shape and its share of their launches; the
    two B7 rows)."""
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.kernels.ssm_scan.ops import (linear_scan, ssm_scan_backward_cuda,
                                                  ssm_scan_backward_plain, ssm_scan_plain)
    from repro_torch.launch import dryrun

    arch, shape = DRYRUN_PREFILL_FLASH
    row = flash_shape_row(torch, dev, f"{arch} prefill_32k", shape, causal=True)
    emit("dryrun_kernels", kernel="flash_attention", **row)
    rows = [dict(row, runs={f"dryrun_{arch}_prefill_32k": 1.0})]
    for i, spec in enumerate(DRYRUN_ASD_CELLS):
        (arch, shape_name, variant), = dryrun.parse_cells(spec)
        cell = dryrun.resolve_cell(arch, shape_name, variant)
        run = f"dryrun_{arch}_{shape_name}"
        dc, cfg, theta = cell.dc, cell.cfg, dryrun.ASD_THETA
        R, D = cell.n_chains * theta, dc.seq_len * dc.d_data
        args = _grs_inputs(torch, dev, R, D, SEED + 82 + i)
        err, accepted = _grs_compare(torch, args)
        times = kernel_times(lambda: grs(*args), lambda: grs_plain(*args), wrapper=grs)
        bms, by = _grs_bound(R, D)
        del args
        at = f"{spec} round: ({R}, {D})"
        emit("dryrun_kernels", kernel="grs", at=at, max_abs_err=err, accepted_rows=accepted,
             **times, bound_ms=bms, bound_by=by, geometry=_row_geometry(R, D))
        rows.append(dict(name="grs", route="cuda", source="src/repro_torch/csrc/grs.cu",
                         replaces="src/repro/kernels/grs/kernel.py:27", at=at,
                         max_abs_err=err, **times, library=None, bound_ms=bms, bound_by=by,
                         runs={run: 1.0}))
        for call, B in (("eager head", cell.n_chains),
                        ("verification", cell.n_chains * (theta + 1))):
            row = flash_shape_row(torch, dev, f"{spec} {call}",
                                  (B, dc.seq_len, dc.seq_len, cfg.n_heads,
                                   cfg.resolved_head_dim), causal=False, seed=SEED + 84 + i)
            emit("dryrun_kernels", kernel="flash_attention", **row)
            rows.append(dict(row, runs={run: 0.5}))

    B, L, D = 1, MAMBA_CHUNK, 1600 * 16
    a, b, G = _scan_inputs(torch, dev, B, L, D, SEED + 81)
    h = linear_scan(a, b)
    da, db = ssm_scan_backward_cuda(a, h, G)
    torch.cuda.synchronize()
    pda, pdb = ssm_scan_backward_plain(a, h, G)
    equal = {"forward": bool(torch.equal(h, ssm_scan_plain(a, b))),
             "backward": bool(torch.equal(da, pda) and torch.equal(db, pdb))}
    if not all(equal.values()):
        fail(f"dryrun_kernels: B7 at {[B, L, D]} differs from its plain version: {equal}")
    n = B * L * D
    at = f"hymba-1.5b train_4k chunk {[B, L, D]} (4 a layer at (1, 4096))"
    scans = []
    for name, kernel, plain_fn, nbytes, ops, source, replaces in (
            ("ssm_scan", lambda: linear_scan(a, b), lambda: ssm_scan_plain(a, b), 12.0 * n,
             2.0 * n, "src/repro_torch/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:27"),
            ("ssm_scan_backward", lambda: ssm_scan_backward_cuda(a, h, G),
             lambda: ssm_scan_backward_plain(a, h, G), 20.0 * n, 3.0 * n,
             "src/repro_torch/csrc/ssm_scan_bwd.cu",
             "none: src/repro/kernels/ssm_scan/ref.py:17 (the JAX package differentiates "
             "its associative scan by autodiff)")):
        # 5 calls: each plain call is ~3,000 launches, which the profiler
        # takes seconds to read back
        times = kernel_times(kernel, plain_fn, reps=5, wrapper=linear_scan)
        bms, by = bound_ms(nbytes, ops, PEAK_F32)
        emit("dryrun_kernels", kernel=name, at=at, equal_bits=True, **times, library=None,
             bound_ms=bms, bound_by=by,
             share_of_bound=bms / times["device_ms"] if times["device_ms"] else None)
        scans.append(dict(name=name, route="cuda", source=source, replaces=replaces, at=at,
                          max_abs_err=0.0, **times, library=None, bound_ms=bms, bound_by=by))
    return rows, scans


def _standin_dc(spec):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.diffusion import DenoiserConfig

    bb = ModelConfig(name=f"bench-{spec['n_layers']}x{spec['d_model']}",
                     family="dense", n_layers=spec["n_layers"],
                     d_model=spec["d_model"], n_heads=spec["n_heads"],
                     n_kv_heads=spec["n_heads"], d_ff=spec["d_ff"], vocab_size=1,
                     pos_embed="none", embed_inputs=False, compute_dtype="float32",
                     remat=False)
    return DenoiserConfig(backbone=bb, seq_len=spec["seq_len"], d_data=spec["d_data"],
                          d_cond=spec["d_cond"], time_log=True)


def _standin_data(spec):
    from repro_torch.data import pipeline

    opts = dict(spec["data"])
    return getattr(pipeline, opts.pop("kind"))(**opts)


def train_standin(torch, dev, kind):
    """Train a stand-in to the recipe of the JAX benchmarks through
    loop.run (checkpoints every 100 steps); returns (params, dc, data,
    losses)."""
    from repro_torch.training import loop
    from repro_torch.training.optimizer import adamw, constant_schedule
    from repro_torch.training.train_step import make_train_step
    from repro_torch.weights import denoiser_init_params

    spec = STANDINS[kind]
    dc, data = _standin_dc(spec), _standin_data(spec)
    steps = spec["steps"]
    opt = adamw(constant_schedule(STANDIN_LR), weight_decay=0.0)

    def batch_fn(s):
        b = data.batch_at(s)
        return {"x0": b[0], "cond": b[1]} if isinstance(b, tuple) else {"x0": b}

    params = denoiser_init_params(dc, torch.Generator(device=dev).manual_seed(0), device=dev)
    lcfg = loop.LoopConfig(total_steps=steps, ckpt_dir=str(_fresh_dir(f"standin_{kind}")),
                           ckpt_every=100, keep=2)
    t0 = time.perf_counter()
    params, _, last, hist = loop.run(make_train_step(_sl_loss_fn(dc), opt), params,
                                     opt.init(params), batch_fn, SEED, lcfg, device=dev)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    if last != steps or not all(math.isfinite(x) for x in losses):
        fail(f"standin_{kind}: {last} of {steps} steps, losses not finite")
    return params, dc, data, losses, wall


def _sample_runs(torch, dev, model_fn, sched, dc, B, runs, conds=None, seed=SEED,
                 eager_ref=False):
    """Sequential and ASD on the same B chains (zeros at t 0, buffer noise
    from seeded generators), with the launch counts of B1 and B2 in each
    ASD run checked per round.  ``runs``: (name, theta, eager).  With
    ``eager_ref`` the sequential call and the first ASD run are also run
    as the eager loops written out in this script: equal sample bits, and
    their walls beside the graphs'."""
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.sequential import sequential_sample_batched

    counters = {k: v for k, v in _counters().items()
                if k in ("grs", "flash_attention", "flash_attention_f32")}
    K, n_layers = sched.K, dc.backbone.n_layers
    y0 = torch.zeros(B, dc.seq_len, dc.d_data, device=dev)
    out, launches_by_run = {}, {}
    with torch.no_grad():
        _zero_counters(torch, counters)
        with _CaptureLog() as captures:
            t0 = time.perf_counter()
            seq = sequential_sample_batched(
                model_fn, sched, y0, device=dev, conds=conds,
                generator=torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            seq_s = time.perf_counter() - t0
        got, designs = _launches(counters), _f32_designs()
        if (got != {"grs": 0, "flash_attention": 0, "flash_attention_f32": n_layers * K}
                or designs["packed"] != n_layers * K):
            fail(f"sequential: launches {got}, designs {designs}, expected {n_layers} x {K} "
                 "float32 flash, packed")
        out["sequential"] = dict(depth=K, wall_s=seq_s, capture_ms=captures.ms,
                                 capture_call_ms=captures.call_ms, sample=seq,
                                 launches=got)
        designs_by_run = {"sequential": designs}
        for name, theta, eager in runs:
            _zero_counters(torch, counters)
            with _CaptureLog() as captures:
                t0 = time.perf_counter()
                res = asd_sample_batched(
                    model_fn, sched, y0, theta, eager_head=eager,
                    generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev,
                    conds=conds)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got, designs = _launches(counters), _f32_designs()
            loop_rounds = int(res.rounds.max())
            want = {"grs": loop_rounds, "flash_attention": 0,
                    "flash_attention_f32": n_layers * 2 * loop_rounds}
            if got != want or designs["packed"] != want["flash_attention_f32"]:
                fail(f"{name}: launches {got}, designs {designs}, expected {want} for "
                     f"{loop_rounds} rounds, packed")
            if not bool(torch.isfinite(res.sample).all()):
                fail(f"{name}: samples not finite")
            if res.loop.rounds != loop_rounds or res.loop.host_reads > loop_rounds:
                fail(f"{name}: the loop ran {res.loop.rounds} rounds with "
                     f"{res.loop.host_reads} host reads for {loop_rounds} rounds")
            depth = (res.rounds + res.head_calls).double()
            accepts, proposals = int(res.accepts.sum()), int(res.proposals.sum())
            out[name] = dict(theta=theta, eager_head=eager, depth=depth.mean().item(),
                             depth_per_chain=depth.tolist(), K_over_depth=K / depth.mean().item(),
                             accept_rate=accepts / max(proposals, 1), accepts=accepts,
                             proposals=proposals, loop_rounds=loop_rounds, wall_s=wall,
                             capture_ms=res.loop.capture_ms,
                             capture_call_ms=captures.call_ms,
                             host_reads=res.loop.host_reads,
                             speedup_vs_sequential_wall=seq_s / wall, sample=res.sample,
                             launches=got, launches_per_round={
                                 "grs": got["grs"] / loop_rounds,
                                 "flash_attention_f32": got["flash_attention_f32"] / loop_rounds})
            launches_by_run[name] = got
            designs_by_run[name] = designs
        launches_by_run["sequential"] = out["sequential"]["launches"]
        if eager_ref:
            sched_dev = sched.to(dev)
            xi = torch.randn((K,) + tuple(y0.shape),
                             generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = _eager_sequential(model_fn, sched_dev, y0, xi, conds)
            torch.cuda.synchronize()
            out["sequential"]["eager_wall_s"] = time.perf_counter() - t0
            name, theta, eager = runs[0]
            t0 = time.perf_counter()
            st, rounds = _eager_sampler(model_fn, sched_dev, y0, theta, "buffer", 1, eager,
                                        generator=torch.Generator(device=dev).manual_seed(
                                            seed + 1), conds=conds)
            torch.cuda.synchronize()
            out[name]["eager_wall_s"] = time.perf_counter() - t0
            from repro_torch.core.asd import chain_sample

            if not (_bits(torch, out["sequential"]["sample"], want)
                    and _bits(torch, out[name]["sample"], chain_sample(st, K, True))
                    and rounds == out[name]["loop_rounds"]):
                fail(f"{name} and sequential: the graphs' samples differ from the eager "
                     "loops'")
    return out, launches_by_run, designs_by_run


def _public(runs):
    return {k: {f: v for f, v in r.items() if f != "sample"} for k, r in runs.items()}


def run_standin_policy(torch, dev):
    """standin_policy: the policy stand-in trained on the card, then fig5's
    sampling (K 100, 8 chains, theta 8 and 24, the eager head at 24) and
    table3's success rates (sequential and theta 24 over 96 episodes)."""
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.data.pipeline import RobotReach
    from repro_torch.models.diffusion import make_sl_model_fn

    params, dc, data, losses, train_s = train_standin(torch, dev, "policy")
    if not losses[-1] * 5 <= losses[0]:
        fail(f"standin_policy: loss {losses[0]} at step 1, {losses[-1]} at the last step "
             "(must fall 5x)")
    sched = sl_geometric(POLICY_K, T_MIN, T_MAX)
    model_fn = make_sl_model_fn(params, dc)
    conds = torch.from_numpy(data.batch_at(999)[1][:POLICY_CHAINS]).to(dev)
    runs = [(f"asd_theta{t}", t, False) for t in POLICY_THETAS] + [
        (f"asd_theta{POLICY_THETAS[-1]}_eager", POLICY_THETAS[-1], True)]
    out, launches, designs = _sample_runs(torch, dev, model_fn, sched, dc, POLICY_CHAINS,
                                          runs, conds, eager_ref=True)

    episodes = POLICY_EPISODES
    obs = torch.from_numpy(data.batch_at(555)[1][:episodes]).to(dev)
    succ_runs, succ_launches, succ_designs = _sample_runs(
        torch, dev, model_fn, sched, dc, episodes, [("asd_theta24", 24, False)], obs,
        seed=SEED + 10)
    launches.update({f"success_{k}": v for k, v in succ_launches.items()})
    designs.update({f"success_{k}": v for k, v in succ_designs.items()})
    success = {name: RobotReach.success(r["sample"] / T_MAX, obs).double().mean().item()
               for name, r in succ_runs.items()}
    emit("standin_policy", model=dc.backbone.name, layers=dc.backbone.n_layers,
         d_model=dc.backbone.d_model, heads=dc.backbone.n_heads,
         head_dim=dc.backbone.d_model // dc.backbone.n_heads, seq_len=dc.seq_len,
         d_data=dc.d_data, d_cond=dc.d_cond, train_steps=len(losses),
         train_batch=data.batch, lr=STANDIN_LR, loss_first=losses[0], loss_last=losses[-1],
         loss_fall=losses[0] / losses[-1], train_wall_s=train_s,
         train_step_ms=train_s / len(losses) * 1e3, K=POLICY_K, chains=POLICY_CHAINS,
         schedule=f"sl_geometric({POLICY_K}, {T_MIN}, {T_MAX})", runs=_public(out),
         success_episodes=episodes, success_rate=success,
         success_runs={k: {f: r[f] for f in ("depth", "accept_rate", "wall_s")
                           if f in r} for k, r in succ_runs.items()})
    return (params, dc, {f"policy_{k}": v for k, v in launches.items()},
            {f"policy_{k}": v for k, v in designs.items()})


def run_standin_pixel(torch, dev):
    """standin_pixel: the pixel stand-in (d 96 over 4 heads: B2's float32
    kernel, packed design, at head dim 24) trained on the card, then ASD theta 8 and the sequential
    sampler at K 200 on 16 chains."""
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn

    params, dc, data, losses, train_s = train_standin(torch, dev, "pixel")
    K = PIXEL_K
    sched = sl_geometric(K, T_MIN, T_MAX)
    out, launches, designs = _sample_runs(
        torch, dev, make_sl_model_fn(params, dc), sched, dc, PIXEL_CHAINS,
        [(f"asd_theta{PIXEL_THETA}", PIXEL_THETA, False)], eager_ref=True)
    emit("standin_pixel", model=dc.backbone.name, layers=dc.backbone.n_layers,
         d_model=dc.backbone.d_model, heads=dc.backbone.n_heads,
         head_dim=dc.backbone.d_model // dc.backbone.n_heads, seq_len=dc.seq_len,
         d_data=dc.d_data, train_steps=len(losses), train_batch=data.batch,
         loss_first=losses[0], loss_last=losses[-1], train_wall_s=train_s,
         train_step_ms=train_s / len(losses) * 1e3, K=K, chains=PIXEL_CHAINS,
         schedule=f"sl_geometric({K}, {T_MIN}, {T_MAX})", runs=_public(out))
    return ({f"pixel_{k}": v for k, v in launches.items()},
            {f"pixel_{k}": v for k, v in designs.items()}, params, dc)


STANDIN_BRANCHES = (1, 2, 4)


def run_standin_branched(torch, dev, params, dc):
    """standin_branched: the pixel stand-in trained in standin_pixel, ASD
    theta 8 at K 200 on 16 chains from one key (counter noise) at B 1, 2
    and 4: depth, K / depth, the mean accepted prefix a round, the wasted
    share of the drafted points, wall seconds, and the launches of B1 and
    B2's float32 kernel a round.  A round from the same states never
    advances less at B > 1, and the mean depth over the chains is never
    above B 1's."""
    from repro_torch.core import prng
    from repro_torch.core.asd import asd_round, asd_sample_batched, init_chain_state
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn

    counters = {k: v for k, v in _counters().items()
                if k in ("grs", "flash_attention", "flash_attention_f32")}
    K, n_layers = PIXEL_K, dc.backbone.n_layers
    sched = sl_geometric(K, T_MIN, T_MAX)
    model_fn = make_sl_model_fn(params, dc)
    event = (dc.seq_len, dc.d_data)
    y0 = torch.zeros((PIXEL_CHAINS,) + event, device=dev)
    key = prng.PRNGKey(SEED + 40)
    runs, by_run, designs_by_run, advance = {}, {}, {}, {}
    with torch.no_grad():
        st = init_chain_state(sched.to(dev), y0, PIXEL_THETA, False,
                              key=prng.split(key, PIXEL_CHAINS).to(dev), noise_mode="counter",
                              num_branches=max(STANDIN_BRANCHES))
        for nb in STANDIN_BRANCHES:
            advance[nb] = asd_round(model_fn, sched.to(dev), st, PIXEL_THETA,
                                    keep_trajectory=False, noise_mode="counter",
                                    num_branches=nb).a
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            res = asd_sample_batched(model_fn, sched, y0, PIXEL_THETA, keep_trajectory=False,
                                     device=dev, key=key, noise_mode="counter",
                                     num_branches=nb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, designs = _launches(counters), _f32_designs()
            loops = int(res.rounds.max())
            want = {"grs": loops, "flash_attention": 0,
                    "flash_attention_f32": 2 * n_layers * loops}
            if got != want or designs["packed"] != want["flash_attention_f32"]:
                fail(f"standin_branched B {nb}: launches {got}, designs {designs}, "
                     f"expected {want}, packed")
            if not bool(torch.isfinite(res.sample).all()):
                fail(f"standin_branched B {nb}: samples not finite")
            depth = (res.rounds + res.head_calls).double()
            accept_depth, waste = _branch_lanes(res)
            runs[nb] = dict(depth=depth.mean().item(), depth_per_chain=depth.tolist(),
                            K_over_depth=K / depth.mean().item(),
                            accept_rate=int(res.accepts.sum()) / int(res.proposals.sum()),
                            branch_accept_depth=accept_depth, wasted_draft_frac=waste,
                            loop_rounds=loops, wall_s=wall, capture_ms=res.loop.capture_ms,
                            host_reads=res.loop.host_reads,
                            launches_per_round={k: v / loops for k, v in got.items() if v})
            if res.loop.rounds != loops:
                fail(f"standin_branched B {nb}: the loop ran {res.loop.rounds} rounds for "
                     f"{loops}")
            by_run[f"standin_branched_b{nb}"] = got
            designs_by_run[f"standin_branched_b{nb}"] = designs
    for nb in STANDIN_BRANCHES[1:]:
        if bool((advance[nb] < advance[1]).any()):
            fail(f"standin_branched: one round advanced {advance[nb].tolist()} at B {nb}, "
                 f"below {advance[1].tolist()} at B 1")
        if runs[nb]["depth"] > runs[1]["depth"]:
            fail(f"standin_branched: mean depth {runs[nb]['depth']} at B {nb} above "
                 f"{runs[1]['depth']} at B 1")
    emit("standin_branched", model=dc.backbone.name, K=K, chains=PIXEL_CHAINS,
         theta=PIXEL_THETA, noise_mode="counter", schedule=f"sl_geometric({K}, {T_MIN}, "
         f"{T_MAX})", runs={f"B{nb}": r for nb, r in runs.items()},
         one_round_advance={f"B{nb}": a.tolist() for nb, a in advance.items()})
    return by_run, designs_by_run


def check_standin_kernels(torch, dev):
    """B1 and B2's float32 kernel against their plain versions at the shapes
    the stand-ins' verification calls give them: the policy at theta 24 (8
    chains: 192 points of 16 tokens, 4 heads of 32; GRS rows of 16 x 2) and
    the pixel model at theta 8 (16 chains: 128 points of 64 tokens, 4 heads
    of 24; rows of 64 x 24); B2 takes its packed design at both.  Times
    cold-cache as in phase 3; the library call is SDPA in float32.  Returns
    B2's numbers by stand-in for the kernels line."""
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs

    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32_rows = {}
    for kind, theta, chains in (("policy", POLICY_THETAS[-1], POLICY_CHAINS),
                                ("pixel", PIXEL_THETA, PIXEL_CHAINS)):
        spec = STANDINS[kind]
        B, L, H = theta * chains, spec["seq_len"], spec["n_heads"]
        hd = spec["d_model"] // H
        q, k, v = _flash_inputs(torch, dev, B, L, L, H, hd, 31 + hd, torch.float32)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        f32_rows[kind] = _f32_timed(torch, q, k, v, dict(causal=False),
                                    lambda: sdpa(qt, kt, vt))
        if f32_rows[kind]["design"] != "packed":
            fail(f"standin_kernels: {kind} launched {f32_rows[kind]['design']}, not packed")
        emit("standin_kernels", kernel="flash_attention_f32", standin=kind,
             **f32_rows[kind], library="scaled_dot_product_attention (float32)")
        R, D = B, L * spec["d_data"]
        args = _grs_inputs(torch, dev, R, D, 41 + D)
        err, accepted = _grs_compare(torch, args)
        times = kernel_times(lambda: grs(*args), lambda: grs_plain(*args), wrapper=grs)
        bms, by = _grs_bound(R, D)
        emit("standin_kernels", kernel="grs", standin=kind, shape=[R, D], max_abs_err=err,
             accepted_rows=accepted, tolerance="z atol 1e-5; accept bits equal except "
             "rows within 1e-5 of the threshold", **times, bound_ms=bms, bound_by=by,
             geometry=_row_geometry(R, D))
    return f32_rows


def check_standin_reference(torch, dev, params, dc):
    """The trained policy weights on the card and copied to the CPU: ASD
    theta 8 on 8 chains with the same injected u_buf and xi_buf.  Counters
    equal (an accept bit may differ only on a row within float rounding of
    the GRS threshold: the rule of serve_reference, which finds none),
    samples within STANDIN_REF_TOL of their scale (max |sample|).  A planted
    fault must fail the gate: the card's run with the model's output rounded
    to bfloat16 on every call.  The line also gives the CPU float32 run's
    distance from the same chains with the model computed in float64: the
    size of float32 rounding here."""
    from repro_torch import pytree
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn

    theta, chains, K = POLICY_THETAS[0], POLICY_CHAINS, POLICY_K
    sched = sl_geometric(K, T_MIN, T_MAX)
    gen = torch.Generator().manual_seed(SEED + 20)
    n = K + theta + 1
    u = torch.rand(chains, n, generator=gen)
    xi = torch.randn(chains, n, dc.seq_len, dc.d_data, generator=gen)
    conds = torch.rand(chains, dc.d_cond, generator=gen) * 2 - 1
    y0 = torch.zeros(chains, dc.seq_len, dc.d_data)
    counters = ("rounds", "head_calls", "model_evals", "accepts", "proposals")

    def sample(model_fn, where):
        with torch.no_grad():
            return asd_sample_batched(model_fn, sched, y0, theta, u_buf=u, xi_buf=xi,
                                      device=where, conds=conds)

    def against_cpu(res):
        """(counters that differ from the CPU's, max abs sample error)"""
        differ = [n for n in counters if not torch.equal(getattr(res, n).cpu(),
                                                         getattr(cpu, n))]
        return differ, (res.sample.cpu() - cpu.sample).abs().max().item()

    params_cpu = pytree.map(lambda t: t.cpu(), params)
    cpu = sample(make_sl_model_fn(params_cpu, dc), "cpu")
    scale = cpu.sample.abs().max().item()
    card_fn = make_sl_model_fn(params, dc)
    differ, err = against_cpu(sample(card_fn, dev))
    if differ or not err <= STANDIN_REF_TOL * scale:
        fail(f"standin_reference: counters {differ} differ, sample error {err} against "
             f"{STANDIN_REF_TOL} x {scale}")
    f_differ, f_err = against_cpu(sample(lambda *a: card_fn(*a).bfloat16().float(), dev))
    if not (f_differ or f_err > STANDIN_REF_TOL * scale):
        fail(f"standin_reference: the gate passes the planted bf16 fault ({f_err})")
    # the float32 run's own rounding: the same chains with the model computed
    # in float64 on the CPU
    dc64 = dataclasses.replace(dc, backbone=dataclasses.replace(dc.backbone,
                                                                compute_dtype="float64"))
    p64 = pytree.map(lambda t: t.double(), params_cpu)
    with torch.no_grad():
        f64 = asd_sample_batched(make_sl_model_fn(p64, dc64, attn_impl="naive"), sched, y0,
                                 theta, u_buf=u, xi_buf=xi, device="cpu", conds=conds)
    emit("standin_reference", model=dc.backbone.name, K=K, theta=theta, chains=chains,
         max_abs_err=err, relative_err=err / scale,
         tolerance=f"{STANDIN_REF_TOL} x max |sample|",
         planted_fault={"fault": "model output rounded to bfloat16 on every call",
                        "max_abs_err": f_err, "relative_err": f_err / scale,
                        "counters_differ": f_differ},
         cpu_float32_vs_float64_model_max_abs_err=(cpu.sample - f64.sample).abs().max().item(),
         float64_counters_equal=all(torch.equal(getattr(f64, n), getattr(cpu, n))
                                    for n in ("rounds", "accepts", "proposals")),
         sample_abs_max=scale,
         rounds=cpu.rounds.tolist(), accepts=int(cpu.accepts.sum()),
         proposals=int(cpu.proposals.sum()))


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- the sharded front end

# the sharded cell (pixel-dit-sharded): 2 shards of 2 slots, the per-shard
# budget 16 (covering: 2 slots x theta 8), 6 keyed requests, counter noise
SHARDS, SHARD_SLOTS = 2, 2
SHARD_BUDGET = SHARD_SLOTS * THETA
SHARD_PROFILE = 8  # warm boundaries under torch.profiler
SHARD_GATE_STEPS = 2  # boundaries of the step-drive bits gate (and its planted fault)


def _device_intervals(prof):
    """(start, end) us of every device kernel the profiler recorded."""
    import torch

    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.end > e.time_range.start)


def _union_us(intervals):
    total, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _profile_kernels(torch, fn):
    """Wall ms of ``fn`` (ended by a synchronize) under torch.profiler, the
    device's busy ms (the union of its kernels' intervals: kernels that
    overlap count once) and the kernels' summed ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iv = _device_intervals(prof)
    busy, summed = _union_us(iv) / 1e3, sum(b - a for a, b in iv) / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy, kernels_ms=summed, kernels=len(iv),
                idle_share=max(0.0, 1.0 - busy / wall_ms) if busy > 0 else None)


def _shard_slots(eng):
    """A copy of every worker's slot tensors, by shard and field."""
    return [_slots(w) for w in eng.workers]


def _replays(torch):
    """Counts CUDAGraph.replay calls while open."""

    class Count:
        def __enter__(self):
            self.n, self._orig = 0, torch.cuda.CUDAGraph.replay
            orig = self._orig

            def replay(graph):
                self.n += 1
                return orig(graph)

            torch.cuda.CUDAGraph.replay = replay
            return self

        def __exit__(self, *exc):
            torch.cuda.CUDAGraph.replay = self._orig

    return Count()


def _faulty_fused_engine():
    """The planted fault: a fused body that runs the last shard's rounds but
    skips their write-back (its packet comes from the old state)."""
    from repro_torch.serving.sharded import ShardedASDEngine

    class Faulty(ShardedASDEngine):
        def _shard_body(self, w, R, budget):
            if w is not self.workers[-1]:
                return super()._shard_body(w, R, budget)
            w._run_rounds(w._states, R, w._budget_dev if budget == "data" else budget)
            w._pack_sync(w._states)

    return Faulty


def _capture_ms(eng):
    """Host ms of every capture a sharded engine made (its workers' programs
    and, in fused dispatch, its own)."""
    progs = [p for w in eng.workers
             for p in list(w._superstep_fns.values()) + list(w._admit_fns.values())]
    if eng.dispatch == "fused":
        progs += list(eng._fused_fns.values()) + list(eng._fused_admit_fns.values())
    return sum(p.capture_ms or 0.0 for p in progs)


def _batch_invariance(torch, dev, model_fn, dc):
    """Whether a point's row of the model call is the same bits at 36 points
    (one 4-slot shard at budget 32) and at 18 (a 2-slot shard at 16), and
    the same for parts of it: the time MLP's two float32 products (M =
    points), a bf16 token product (M = points x tokens) and B2."""
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.nn.layers import sinusoidal_embed

    cfg, n, h = dc.backbone, 18, 36
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def rows_same(fn, *xs):
        return torch.equal(fn(*xs)[:n], fn(*(x[:n] for x in xs)))

    t, y = torch.rand(h, generator=g, device=dev) * 50.0, rnd(h, dc.seq_len, dc.d_data)
    w1, w2 = rnd(dc.time_dim, cfg.d_model), rnd(cfg.d_model, cfg.d_model)
    w = rnd(cfg.d_model, cfg.d_model, dtype=torch.bfloat16)
    qkv = [rnd(h, dc.seq_len, cfg.n_heads, cfg.d_model // cfg.n_heads, dtype=torch.bfloat16)
           for _ in range(3)]
    with torch.no_grad():
        emb = sinusoidal_embed(t * 100.0, dc.time_dim)
        return dict(model_call=rows_same(model_fn, t, y),
                    time_mlp1_f32=rows_same(lambda e: e @ w1, emb),
                    time_mlp2_f32=rows_same(lambda e: torch.tanh(e @ w1) @ w2, emb),
                    token_product_bf16=rows_same(lambda x: x @ w,
                                                 rnd(h, dc.seq_len, cfg.d_model,
                                                     dtype=torch.bfloat16)),
                    flash_attention=rows_same(
                        lambda q, k, v: flash_mha(q, k, v, causal=False), *qkv))


# (run, dispatch, round_impl): the per-shard dispatch with the per-phase
# kernels (B1, B3, B4), the fused dispatch with the fused round (B5, B6);
# the two rounds give equal bits (the serve phase's gate)
SHARDED_RUNS = (("per_shard_packed", "per-shard", "packed"),
                ("fused_fused", "fused", "fused"))


def run_sharded_serve(torch, dev, model_fn, sched, dc):
    """pixel-dit behind ``ShardedASDEngine``: 2 shards of 2 slots, packed, the
    per-shard budget 16 (covering), counter noise, 6 keyed requests, K 64,
    R 4; per-shard dispatch with packed rounds and fused dispatch with fused
    rounds.  Gates: shards 1 equals ``ContinuousASDEngine`` in bits; shards
    2 equals shards 1 (4 slots, the covering 32) per request in bits and
    counters, which needs a point's row of the model call to be the same
    bits at 36 points as at 18 (probed first); fused equals per-shard in
    bits and counters, also at every slot field after 2 boundaries from the
    same requests in the fused round (a planted fused body that skips the
    last shard's write-back must fail that gate); a warm boundary replays 1
    graph fused and 2 per shard, with host syncs made errors.  Numbers: warm round ms and samples/s, the idle share over 8 profiled
    boundaries, capture ms, peak memory, and for fused dispatch one profiled
    boundary's busy ms against the per-shard bodies' sum."""
    from repro_torch.core import prng
    from repro_torch.serving.engine import ContinuousASDEngine, Request
    from repro_torch.serving.router import make_router
    from repro_torch.serving.sharded import ShardedASDEngine

    t_phase = time.perf_counter()
    counters = _counters()
    event = (dc.seq_len, dc.d_data)
    reqs = [Request(i, key=prng.PRNGKey(6000 + i)) for i in range(REQUESTS)]
    wave = SHARDS * SHARD_SLOTS
    warm = [Request(100 + i, key=prng.PRNGKey(6100 + i)) for i in range(wave)]
    common = dict(theta=THETA, execution="packed", rounds_per_sync=RPS, seed=SEED,
                  noise_mode="counter", keep_trajectory=False, device=dev)

    def sharded(shards, impl, dispatch="per-shard", cls=ShardedASDEngine):
        return cls(model_fn, sched, event, num_slots=wave, shards=shards,
                   round_budget=SHARD_BUDGET * SHARDS // shards, round_impl=impl,
                   dispatch=dispatch, router=make_router("round-robin"), **common)

    def served(eng, requests=reqs):
        out = eng.serve(requests)
        torch.cuda.synchronize()
        return out, {m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
                     for m in eng.stats.per_request}

    def same(a, b):
        return sorted(a) == sorted(b) and all(
            np.array_equal(a[r].view(np.int32), b[r].view(np.int32)) for r in a)

    # a point's row of the model call at 36 points and at 18: the shards-2
    # gate below holds only where these are the same bits
    invariance = _batch_invariance(torch, dev, model_fn, dc)
    emit("sharded_serve_batch_invariance", points=(36, 18), same_bits=invariance)
    # shards 1 against the continuous engine (4 slots, the covering 32)
    ref, ref_req = served(ContinuousASDEngine(model_fn, sched, event, num_slots=wave,
                                              round_budget=wave * THETA, round_impl="packed",
                                              **common))
    s1, s1_req = served(sharded(1, "packed"))
    if not same(s1, ref) or s1_req != ref_req:
        fail("sharded_serve: shards 1 differs from ContinuousASDEngine")
    by_run, runs = {}, {}
    for name, dispatch, impl in SHARDED_RUNS:
        base = _fresh_memory(torch)
        eng = sharded(SHARDS, impl, dispatch)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        out, per_req = served(eng)
        cold_wall = time.perf_counter() - t0
        launches = _launches(counters)
        mem = _memory(torch, base)
        if not same(out, s1) or per_req != s1_req:
            err = max(float(np.abs(out[r] - s1[r]).max()) for r in s1)
            fail(f"sharded_serve {name}: against shards 1 at its covering budget: max abs "
                 f"sample difference {err}, counters equal for "
                 f"{sum(per_req[r] == s1_req[r] for r in s1_req)} of {len(s1_req)} requests")
        # warm and unprofiled: one more wave of requests
        done = max(w.stats.supersteps for w in eng.workers)
        t0 = time.perf_counter()
        eng.serve(warm)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        warm_boundaries = max(w.stats.supersteps for w in eng.workers) - done
        capture = _capture_ms(eng)
        # a warm boundary mid-flight: the graphs it replays, host syncs made
        # errors (no admission: one boundary after the admitting one no
        # chain can have finished, 4 rounds of at most theta + 1 steps < K);
        # then 8 boundaries profiled (two waves hold the slots; the second
        # is never drained, the engine goes)
        for r in [Request(200 + i, key=prng.PRNGKey(6200 + i)) for i in range(2 * wave)]:
            eng.submit(r)
        eng.step()
        torch.cuda.synchronize()
        with _replays(torch) as rep:
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = (eng._dispatch_fused() if dispatch == "fused"
                           else [w._dispatch_superstep() for w in eng.workers])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = 1 if dispatch == "fused" else SHARDS
        if rep.n != want:
            fail(f"sharded_serve {name}: a warm boundary replayed {rep.n} graphs, "
                 f"expected {want}")
        if dispatch == "fused":
            eng._harvest_fused(pending)
        else:
            for w, p in zip(eng.workers, pending):
                w._harvest(p)
        prof = _profile_kernels(torch, lambda: [eng.step() for _ in range(SHARD_PROFILE)])
        if not prof["busy_ms"] or not eng.has_work():
            fail(f"sharded_serve {name}: the profiled boundaries ran dry or traced "
                 f"nothing: {prof}")
        extra = {}
        if dispatch == "fused":
            # one warm boundary's program alone, against the shards' bodies
            # run one after another
            budget = eng.workers[0].round_budget
            one = _profile_kernels(torch, eng._get_fused(RPS, budget))
            bodies = [_profile_kernels(torch, lambda w=w: eng._shard_body(w, RPS, budget))
                      for w in eng.workers]
            extra = dict(fused_boundary=one,
                         per_shard_bodies_busy_ms=[b["busy_ms"] for b in bodies],
                         per_shard_bodies_sum_ms=sum(b["busy_ms"] for b in bodies),
                         branches_overlap=one["busy_ms"] < one["kernels_ms"])
        torch.cuda.synchronize()
        runs[name] = dict(out=out, per_req=per_req)
        by_run[f"sharded_serve_{name}"] = launches
        emit("sharded_serve", run=name, model=dc.backbone.name, shards=SHARDS,
             slots_per_shard=SHARD_SLOTS, round_budget_per_shard=SHARD_BUDGET,
             round_impl=impl, dispatch=dispatch, requests=REQUESTS, K=K, theta=THETA,
             rounds_per_sync=RPS, noise_mode="counter", launches=launches,
             cold_wall_s=cold_wall, warm_wall_s=warm_wall, warm_requests=len(warm),
             warm_samples_per_s=len(warm) / warm_wall, warm_boundaries=warm_boundaries,
             warm_round_ms=warm_wall / (warm_boundaries * RPS) * 1e3,
             capture_ms=capture, graph_replays_a_boundary=rep.n, **mem,
             profile_8_boundaries=prof, **extra)
        del eng, pending, extra
    a, b = (runs[name] for name, _, _ in SHARDED_RUNS)
    if not same(a["out"], b["out"]) or a["per_req"] != b["per_req"]:
        fail("sharded_serve: fused dispatch differs from per-shard dispatch")

    # the step-drive bits gate: every slot field of every shard after the
    # same boundaries, fused against per-shard dispatch in the fused round;
    # the planted fault must fail it
    def stepped(eng):
        for r in reqs[:wave]:
            eng.submit(r)
        for _ in range(SHARD_GATE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        return _shard_slots(eng)

    def slots_equal(x, y):
        return all(_same_slots(torch, p, q) for p, q in zip(x, y))

    want = stepped(sharded(SHARDS, "fused", "per-shard"))
    held = slots_equal(stepped(sharded(SHARDS, "fused", "fused")), want)
    caught = not slots_equal(stepped(sharded(SHARDS, "fused", "fused", _faulty_fused_engine())),
                             want)
    if not held or not caught:
        fail(f"sharded_serve step gate: fused equal to per-shard {held}, planted fault "
             f"caught {caught}")
    missing = [k for k in ("grs", "flash_attention", "gather_rows", "scatter_rows",
                           "fused_gather", "fused_verify_commit")
               if not any(r.get(k) for r in by_run.values())]
    if missing:
        fail(f"sharded_serve: {missing} launched in no sharded run")
    emit("sharded_serve_gates", shards_1_equals_continuous=True,
         shards_2_equals_shards_1=True, fused_equals_per_shard=True,
         step_gate_held=held, planted_fault_caught=caught,
         planted_fault="the fused body skips the last shard's write-back",
         phase_wall_s=time.perf_counter() - t_phase)
    return by_run


SHARDED_CLI = ("--slots", "8", "--chains", "16",
               "--profile-supersteps", str(SERVE_CLI_PROFILE))
SHARDED_CLI_FUSED = ("--execution", "packed", "--round-impl", "fused",
                     "--rounds-per-sync", "2")
# (name, argv, reference run)
SHARDED_CLI_RUNS = (
    ("unsharded", [], None),
    ("unsharded_packed_fused_r2", list(SHARDED_CLI_FUSED), None),
    ("shards_2_round_robin", ["--shards", "2", "--router", "round-robin"], "unsharded"),
    ("shards_2_dispatch_fused", ["--shards", "2", "--dispatch", "fused",
                                 *SHARDED_CLI_FUSED], "unsharded_packed_fused_r2"),
    ("shards_4", ["--shards", "4"], "unsharded"),
)


def run_sharded_serve_cli(torch, dev):
    """``repro_torch.launch.serve.main`` at its defaults (full-width
    paper-diffusion-policy, K 100) with 8 slots and 16 keyed requests,
    unsharded and sharded (2 shards round-robin, 2 shards fused dispatch
    with packed fused rounds at R 2, 4 shards), each with 8 profiled warm
    supersteps: per-request samples equal to the unsharded run's with the
    same round flags in bits, and retired, per-request depth, live window
    and accept rate equal; launches of every kernel per round."""
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    n_layers = get_denoiser_config("paper-diffusion-policy").backbone.n_layers
    counters = _counters()
    by_run, summaries = {}, {}
    for name, argv, reference in SHARDED_CLI_RUNS:
        argv = [*SHARDED_CLI, *argv,
                "--profile-dir", str(ROOT / "build" / f"sharded_cli_{name}_profile")]
        base = _fresh_memory(torch)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        summary = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mem = _memory(torch, base)
        launches = _launches(counters)
        impl = None if "--execution" not in argv else "fused"
        R = int(argv[argv.index("--rounds-per-sync") + 1]) if "--rounds-per-sync" in argv else 1
        rounds = summary["rounds_total"]
        want = {k: 0 for k in launches}
        want.update({k: n * rounds for k, n in _cli_per_round(n_layers, impl).items()})
        if launches != want:
            fail(f"sharded_serve_cli {name}: launches {launches}, expected {want} for "
                 f"{rounds} rounds")
        if not summary["finite"] or len(summary["samples"]) != 16:
            fail(f"sharded_serve_cli {name}: samples missing or not finite")
        prof = summary["profile"]
        if prof["device_idle_share"] is None or prof["programs_built"]:
            fail(f"sharded_serve_cli {name}: profile {prof}")
        agree = None
        if reference is not None:
            ref = summaries[reference]
            keys = ("retired", "mean_parallel_depth", "mean_window", "accept_rate")
            bits = all(np.array_equal(summary["samples"][r].view(np.int32),
                                      ref["samples"][r].view(np.int32)) for r in range(16))
            agree = {k: summary[k] == ref[k] for k in keys}
            if not bits or not all(agree.values()):
                fail(f"sharded_serve_cli {name}: against {reference}: sample bits {bits}, "
                     f"{agree}")
        emit("sharded_serve_cli", variant=name, argv=argv, model="paper-diffusion-policy",
             reference=reference, samples_equal_bits=reference is not None or None,
             agree=agree, retired=summary["retired"], rounds_summed_over_shards=rounds,
             mean_parallel_depth=summary["mean_parallel_depth"],
             accept_rate=summary["accept_rate"], samples_per_s=16 / summary["wall_time_s"],
             warm_round_ms=summary["wall_time_s"] * 1e3 / (summary["serve_boundaries"] * R),
             profiled_round_ms=prof["wall_ms"] / (prof["supersteps"] * R),
             device_idle_share=prof["device_idle_share"], profile=prof, wall_s=wall,
             launches=launches, **mem)
        by_run[f"sharded_serve_cli_{name}"] = launches
        summaries[name] = summary
    emit("sharded_serve_cli_done", phase_wall_s=time.perf_counter() - t_phase)
    return by_run


# ------------------------------------------------------------ model_parallel
# serving model parallelism over a model group of two ranks sharing this card

MP_WORLD = 2
# points of the full-width forward checks: the engine's verification call
# (BUDGET points)
MP_POINTS = BUDGET
# relative L2 of the sharded full-width pixel-dit forward against the
# replicated one on the same card: each rank rounds its partial sum of each
# row-parallel product (wo, w_down; two a layer) to bf16 before the psum
# adds them, one more rounding of bf16's epsilon (2^-8) a product where the
# replicated forward rounds once; the roundings add in quadrature over the
# 2 x depth products, times 2 for the margin
MP_BF16_GATE = 2 * 2.0 ** -8 * math.sqrt(2 * PIXEL_DEPTH)
# the float32 engines against the replicated engine: samples within
# MP_F32_TOL + MP_F32_TOL |replicated| (the CPU tests' allclose)
MP_F32_TOL = 1e-5
# name -> (config, tensor, expert, sp, fused) of the float32 engines;
# fused: packed fused rounds at the covering budget, and the group's engine
# over two shards in fused dispatch
MP_F32_RUNS = {
    "policy_tp2": ("paper-diffusion-policy-smoke", True, False, 1, False),
    "policy_sp2_fused": ("paper-diffusion-policy-smoke", False, False, 2, True),
    "moe_ep2": ("qwen3-moe-a3b-smoke", False, True, 1, False),
    "moe_ep2_sp2": ("qwen3-moe-a3b-smoke", False, True, 2, False),
}
MP_F32_K, MP_F32_THETA, MP_F32_REQUESTS = 16, 4, 6
MP_ENGINE_REQUESTS = 4
# the full-width TP2 engine's layers: every row-parallel product's psum
# crosses the host (2.8 s a round at 12 layers on an NVIDIA H100 80GB HBM3,
# 700 W; PERF.md), so the engine runs a third of PIXEL_DEPTH to keep
# the smoke inside its limit; the forward checks run all PIXEL_DEPTH
MP_ENGINE_DEPTH = 4


# ------------------------------------------------------------ mesh_train
# the LM trainer's meshes (launch/train.py build, training/train_step.py
# MeshStep) on the model_parallel phase's two ranks, against the 1 x 1
# trainer in this process: tinyllama-1.1b (the JAX CLI's default arch) at
# published widths and 2 of its 22 layers
MESH_TRAIN_ARCH = "tinyllama-1.1b"
MESH_TRAIN_DEPTH = 2
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS, MESH_TRAIN_LR = 8, 128, 3, 3e-4
# (mesh, layout) of each run: data parallelism with ZeRO-1, the model axis
# (TP on the attention and FFN leaves, the vocab leaves gathered at use),
# and FSDP over (data, model) with ZeRO-1
MESH_TRAIN_RUNS = (("2x1", "param"), ("1x2", "param"), ("2x1", "fsdp"))
# relative L2 of a mesh run's step-1 gradient of every leaf (and of each
# loss) against the 1 x 1 run's: a leaf's gradient passes through up to 7
# bf16 products a layer forward and 7 backward (q, k, v, o, gate, up,
# down), and the mesh rounds each of them at most once more than the
# 1 x 1 run (a half batch's product, a rank's partial sum before the psum);
# bf16 roundings of epsilon 2^-8 add in quadrature over 2 x 7 x depth
# products, times 2 for the margin
MESH_BF16_GATE = 2 * 2.0 ** -8 * math.sqrt(2 * 7 * MESH_TRAIN_DEPTH)
# relative error of each loss against the 1 x 1 run's: at most 3.92e-5
# in this phase's runs on an H100, so 25 times that spread
MESH_LOSS_GATE = 1e-3
# relative L2 of each leaf's update over the run (final minus initial
# params) against the 1 x 1 run's, which a gate on the params cannot see
# at warmup's lr (a leaf's whole update is ~1 % of its norm).  AdamW's
# early updates are ~lr sign(g) an element, so the elements whose bf16
# gradient changes sign move apart; a ZeRO-1 half of two left without its
# update gives sqrt(1/2), a missing update 1: the gate is half the first
MESH_UPDATE_GATE = math.sqrt(0.5) / 2


def _mesh_train_setup(torch, dev):
    """(config, the steps' MarkovLM batches on ``dev``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import MarkovLM

    cfg = dataclasses.replace(get_config(MESH_TRAIN_ARCH), n_layers=MESH_TRAIN_DEPTH)
    data = MarkovLM(vocab=cfg.vocab_size, seq_len=MESH_TRAIN_SEQ, batch=MESH_TRAIN_BATCH)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
               for s in range(MESH_TRAIN_STEPS)]
    return cfg, batches


def _synced(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_mesh_train_reference(torch, dev, path):
    """The 1 x 1 trainer (``train.build(cfg, None, ...)``) from the seed-0
    params: its step-1 gradient of every leaf and each leaf's update over
    the steps, saved to ``path`` on the host for the ranks, and its
    losses and warm step."""
    from repro_torch import pytree
    from repro_torch.launch import train
    from repro_torch.models.lm import lm_loss

    cfg, batches = _mesh_train_setup(torch, dev)
    step, init, _ = train.build(cfg, None, 1, MESH_TRAIN_LR, MESH_TRAIN_STEPS, device=dev)
    params, opt = init()
    ps = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    with torch.enable_grad():
        loss, _ = lm_loss(pytree.unflatten(params, ps), batches[0], cfg)
        grads = torch.autograd.grad(loss, ps)
    names = ["/".join(path) for path, _ in pytree.paths(params)]
    saved = {k: g.cpu() for k, g in zip(names, grads)}
    del ps, grads
    start = [p.clone() for p in pytree.leaves(params)]
    losses, norms, times = [], [], []
    for batch in batches:
        (params, opt, m), dt = _synced(torch, step, params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(dt)
    saved.update({f"update/{k}": (p - p0).cpu()
                  for k, p, p0 in zip(names, pytree.leaves(params), start)})
    torch.save(saved, path)
    return dict(losses=losses, grad_norms=norms, warm_step_ms=1e3 * min(times[1:]))


def _checksums(torch, leaf):
    """Two int64 sums of a leaf's bits (plain and position-weighted): the
    same bits give the same pair."""
    v = leaf.contiguous().view(torch.int32).reshape(-1).long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return int(v.sum()), int((v * w).sum())


def _mesh_train_rank(torch, group, ref_path):
    """Each of MESH_TRAIN_RUNS on this rank: the step-1 gradient blocks
    against the reference's (sums for the relative L2), three steps, the
    param blocks' updates against the reference's (sums), the warm step,
    the seconds inside collectives, peak memory, resident bytes against
    the layout's, and the final blocks' checksums."""
    from repro_torch import pytree
    from repro_torch.distributed.group import collective_seconds, reset_collective_seconds
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.weights import lm_param_shapes

    dev = group.device
    ref = torch.load(ref_path, mmap=True, map_location="cpu", weights_only=True)
    cfg, batches = _mesh_train_setup(torch, dev)
    shapes = lm_param_shapes(cfg)
    out = {}
    for spec, layout in MESH_TRAIN_RUNS:
        t_run = time.perf_counter()
        base = _fresh_memory(torch)
        mesh = make_rank_mesh(group, spec)
        step, init, lay = train.build(cfg, mesh, 1, MESH_TRAIN_LR, MESH_TRAIN_STEPS, layout,
                                      device=dev)
        params, opt = init()
        # on the host, out of the rank's peak memory
        start = [p.to("cpu", copy=True) for p in pytree.leaves(params)]
        reset_collective_seconds()
        (loss, metrics, grads), grad_s = _synced(torch, step.gradients, params, batches[0])
        num, den = {}, {}
        for (path, blk), spec_o in zip(pytree.paths(grads), pytree.leaves(lay.opt["mu"])):
            r = ref["/".join(path)]
            want = r[block_slices(tuple(r.shape), spec_o, mesh)].to(dev)
            num["/".join(path)] = float(((blk - want) ** 2).sum())
            den["/".join(path)] = float((want ** 2).sum())
            del want
        (params, opt, m), apply_s = _synced(torch, step.apply, params, opt, loss, metrics,
                                            grads)
        del grads
        losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
        times, coll = [grad_s + apply_s], [collective_seconds()]
        for batch in batches[1:]:
            reset_collective_seconds()
            (params, opt, m), dt = _synced(torch, step, params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(dt)
            coll.append(collective_seconds())
        unum, uden = {}, {}
        for (path, p), p0, spec_p in zip(pytree.paths(params), start,
                                         pytree.leaves(lay.params)):
            r = ref["update/" + "/".join(path)]
            want = r[block_slices(tuple(r.shape), spec_p, mesh)].to(dev)
            unum["/".join(path)] = float(((p - p0.to(dev) - want) ** 2).sum())
            uden["/".join(path)] = float((want ** 2).sum())
            del want
        del start
        sums = {"/".join(path): (block_slices(shapes_of, spec_p, mesh), _checksums(torch, p))
                for (path, p), spec_p, shapes_of in zip(
                    pytree.paths(params), pytree.leaves(lay.params),
                    [tuple(x) for x in pytree.leaves(shapes)])}
        nbytes = lambda tree: sum(t.numel() * t.element_size() for t in pytree.leaves(tree))
        out[f"{spec}_{layout}"] = dict(
            losses=losses, grad_norms=norms, num=num, den=den, unum=unum, uden=uden,
            step_s=times,
            collective_s=coll, peak_bytes=torch.cuda.max_memory_allocated() - base,
            param_bytes=nbytes(params), mu_nu_bytes=nbytes(opt["mu"]) + nbytes(opt["nu"]),
            layout_param_bytes=lay.resident_bytes(shapes, lay.params),
            layout_mu_nu_bytes=2 * lay.resident_bytes(shapes, lay.opt["mu"]),
            full_param_bytes=4 * sum(math.prod(x) for x in pytree.leaves(shapes)),
            tp_leaves=len(lay.tp),
            sums={k: ([(sl.start, sl.stop) for sl in v[0]], v[1]) for k, v in sums.items()},
            wall_s=time.perf_counter() - t_run)
        del params, opt, step
    return out


def check_mesh_train(torch, card, ref, ranks):
    """The gates of each mesh run against the 1 x 1 reference, and its
    ``mesh_train`` line."""
    for key, r0 in ranks[0]["mesh_train"].items():
        runs = [r["mesh_train"][key] for r in ranks]
        problems = []
        if not all(r["losses"] == r0["losses"] for r in runs):
            problems.append("the ranks' losses differ")
        if not all(math.isfinite(x) for x in r0["losses"]):
            problems.append(f"losses not finite: {r0['losses']}")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
        if not max(loss_rel) <= MESH_LOSS_GATE:
            problems.append(f"losses {r0['losses']} against {ref['losses']}")
        rel = {k: math.sqrt(sum(r["num"][k] for r in runs) / sum(r["den"][k] for r in runs))
               for k in r0["num"]}
        over = {k: e for k, e in rel.items() if not e <= MESH_BF16_GATE}
        if over:
            problems.append(f"step-1 gradients over the gate: {over}")
        upd = {k: math.sqrt(sum(r["unum"][k] for r in runs)
                            / max(sum(r["uden"][k] for r in runs), 1e-300))
               for k in r0["unum"]}
        over = {k: e for k, e in upd.items() if not e <= MESH_UPDATE_GATE}
        if over:
            problems.append(f"param updates over the gate: {over}")
        for r in runs:
            if (r["param_bytes"], r["mu_nu_bytes"]) != (r["layout_param_bytes"],
                                                       r["layout_mu_nu_bytes"]):
                problems.append(f"resident bytes {r['param_bytes']}, {r['mu_nu_bytes']} "
                                f"against the layout's {r['layout_param_bytes']}, "
                                f"{r['layout_mu_nu_bytes']}")
        replicated = 0
        for k, (blk, sums) in r0["sums"].items():
            for r in runs[1:]:
                if r["sums"][k][0] == blk:
                    replicated += 1
                    if r["sums"][k][1] != sums:
                        problems.append(f"replicated leaf {k}: the ranks' bits differ")
        if problems:
            fail(f"mesh_train {key}: {problems}")
        warm = [sum(r["step_s"][1:]) / len(r["step_s"][1:]) for r in runs]
        coll = [sum(r["collective_s"][1:]) / len(r["collective_s"][1:]) for r in runs]
        emit("mesh_train", run=key, card=card, arch=MESH_TRAIN_ARCH, layers=MESH_TRAIN_DEPTH,
             batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ, steps=MESH_TRAIN_STEPS,
             losses=r0["losses"], reference_losses=ref["losses"],
             loss_relative_error=loss_rel, grad_norms=r0["grad_norms"],
             reference_grad_norms=ref["grad_norms"],
             step1_grad_relative_l2_max=max(rel.values()),
             step1_grad_relative_l2_worst_leaf=max(rel, key=rel.get),
             update_relative_l2_max=max(upd.values()),
             update_relative_l2_worst_leaf=max(upd, key=upd.get),
             gate=MESH_BF16_GATE, gate_rule=(
                 "2 x bf16 epsilon 2^-8 x sqrt(2 x 7 x depth): one more bf16 rounding of "
                 "each of 7 products a layer, forward and backward"),
             loss_gate=MESH_LOSS_GATE, loss_gate_rule="25 x the largest measured, 3.92e-5",
             update_gate=MESH_UPDATE_GATE, update_gate_rule=(
                 "half of sqrt(1/2), what a ZeRO-1 half of two left without its update "
                 "gives"),
             tensor_parallel_leaves=r0["tp_leaves"], replicated_leaf_blocks_equal=replicated,
             warm_step_ms_by_rank=[1e3 * w for w in warm],
             reference_warm_step_ms=ref["warm_step_ms"],
             collective_ms_per_warm_step_by_rank=[1e3 * c for c in coll],
             collective_share_of_warm_step_by_rank=[c / w for c, w in zip(coll, warm)],
             first_step_ms_by_rank=[1e3 * r["step_s"][0] for r in runs],
             peak_bytes_by_rank=[r["peak_bytes"] for r in runs],
             param_bytes_by_rank=[r["param_bytes"] for r in runs],
             mu_nu_bytes_by_rank=[r["mu_nu_bytes"] for r in runs],
             whole_param_bytes=r0["full_param_bytes"],
             run_wall_s_by_rank=[r["wall_s"] for r in runs],
             note=("the transport is host-staged gloo between two processes that share this "
                   "one card (pinned host copies), not NVLink; step ms: host wall with a "
                   "synchronize, the mean of steps 2 and 3; collective ms: wall inside the "
                   "groups' collectives in those steps"))


def _mp_pixel_dc(depth: int):
    from repro_torch.configs.registry import paper_pixel_dit

    dc = paper_pixel_dit()
    return dataclasses.replace(dc, backbone=dataclasses.replace(dc.backbone, n_layers=depth))


def _mp_specs(dc, world, tensor, expert=False):
    from repro_torch.distributed.sharding import mp_param_pspecs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import param_shapes

    return mp_param_pspecs(param_axes(dc), param_shapes(dc), Mesh((world,), ("model",), ()),
                           tensor=tensor, expert=expert)


def _mp_axes(group, tensor, expert, sp):
    return dict(tp_axis=group if tensor and sp == 1 else None,
                sp_axis=group if sp > 1 else None, sp_size=sp,
                ep_axis=group if expert else None)


def _tree_bytes(tree, only=None):
    from repro_torch import pytree

    return sum(t.numel() * t.element_size() for path, t in pytree.paths(tree)
               if only is None or only(path))


@contextlib.contextmanager
def _dropped_wo_psum(active):
    """The planted fault: where ``active``, attention's row-parallel ``wo``
    still joins the psum (the peer must not hang) but keeps its own partial
    sum instead of the total."""
    from repro_torch.nn import attention

    orig = attention._out

    def out(params, o, dtype, tp_axis=None, n_heads=0):
        B, L, H, hd = o.shape
        partial = o.reshape(B, L, H * hd) @ params["wo"].reshape(H * hd, -1).to(dtype)
        if tp_axis is not None and H != n_heads:
            tp_axis.psum(partial)
        return partial

    if active:
        attention._out = out
    try:
        yield
    finally:
        attention._out = orig


def _mp_pixel_forwards(torch, group, counters, dc, params):
    """TP2 and SP2 forwards of the full-width pixel-dit on this rank (and,
    on rank 0, the replicated forward), two calls each, then the TP2
    forward with rank 1's wo psum dropped."""
    from repro_torch import pytree
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.diffusion import make_sl_model_fn

    dev = group.device
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    t = torch.exp(torch.linspace(math.log(0.05), math.log(50.0), MP_POINTS)).to(dev)
    y = torch.randn(MP_POINTS, dc.seq_len, dc.d_data, generator=g, device=dev) * (
        t * t + t).sqrt()[:, None, None]
    res = {"full_bytes": _tree_bytes(params)}
    with torch.no_grad():
        if group.rank == 0:
            fn = make_sl_model_fn(params, dc)
            fn(t, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res["ref"] = fn(t, y)
            torch.cuda.synchronize()
            res["ref_ms"] = (time.perf_counter() - t0) * 1e3
            res["ref"] = res["ref"].cpu()
            del fn
        for mode, tensor, sp in (("tp2", True, 1), ("sp2", False, 2)):
            specs = _mp_specs(dc, group.world, tensor)
            local = shard_params(params, specs,
                                 MeshGroups((group.world,), ("model",), group.rank))
            sharded = {path for path, spec in pytree.paths(specs) if "model" in spec}
            fn = make_sl_model_fn(local, dc, **_mp_axes(group, tensor, False, sp))
            _zero_counters(torch, counters)
            t0 = time.perf_counter()
            out = fn(t, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _launches(counters)
            t0 = time.perf_counter()
            again = fn(t, y)
            torch.cuda.synchronize()
            res[mode] = dict(out=out.cpu(), again_equal=bool(torch.equal(out, again)),
                             first_ms=ms, warm_ms=(time.perf_counter() - t0) * 1e3,
                             launches=launches, resident_bytes=_tree_bytes(local),
                             sharded_bytes=_tree_bytes(params, lambda p: p in sharded),
                             sharded_leaves=len(sharded))
            if mode == "tp2":
                with _dropped_wo_psum(group.rank == 1):
                    res["tp2_fault"] = fn(t, y).cpu()
            del fn, local, out, again
    return res


def _mp_engine(group, dc, params, tensor, expert, sp, make_fn, sched, calibrate=True, **kw):
    from repro_torch.models.diffusion import mp_collective_payloads
    from repro_torch.serving.sharded import ShardedASDEngine

    specs = _mp_specs(dc, group.world, tensor, expert)
    axes = _mp_axes(group, tensor, expert, sp)
    return ShardedASDEngine(
        lambda p: make_fn(p, dc, **axes), sched, (dc.seq_len, dc.d_data),
        model_shards=group.world, model_group=group, params=params, param_specs=specs,
        collective_payloads=mp_collective_payloads(params, specs, dc, mp_size=group.world,
                                                   sp_size=sp) if calibrate else None,
        device=group.device, noise_mode="counter", keep_trajectory=False, **kw)


def _mp_serve(torch, eng, reqs, counters):
    _zero_counters(torch, counters)
    t0 = time.perf_counter()
    samples = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats
    return dict(samples=samples, wall_s=wall, rounds=s.rounds_total,
                supersteps=s.supersteps, launches=_launches(counters),
                counters={m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts,
                                  m.proposals) for m in s.per_request},
                collective_s=s.collective_s, collective_psum_s=s.collective_psum_s,
                collective_a2a_s=s.collective_a2a_s,
                eager=all(w._eager for w in getattr(eng, "workers", [eng])))


def _mp_f32_kwargs(name, shards):
    """The float32 engine's kwargs: unpacked rounds, or packed fused rounds
    at the covering budget over ``shards`` shards in fused dispatch."""
    if not MP_F32_RUNS[name][4]:
        return {}
    kw = dict(execution="packed", round_impl="fused",
              round_budget=SLOTS // shards * MP_F32_THETA)
    return kw if shards == 1 else dict(kw, shards=shards, dispatch="fused")


def _mp_f32_setup(torch, dev, name):
    """(dc, params, schedule, requests) of a float32 engine run: the
    weights from the numpy seed (the same on every process), keyed
    requests with their y0."""
    from repro_torch.configs.registry import get_denoiser_config
    from repro_torch.core.schedules import ddpm
    from repro_torch.serving.worker import Request
    from repro_torch.weights import init_denoiser_params

    dc = get_denoiser_config(MP_F32_RUNS[name][0])
    params = init_denoiser_params(dc, SEED, out_scale=1.0, device=dev)
    rng = np.random.default_rng(SEED + 300)
    reqs = [Request(i, key=np.array([0, 3000 + i], np.uint32),
                    y0=rng.standard_normal((dc.seq_len, dc.d_data)).astype(np.float32))
            for i in range(MP_F32_REQUESTS)]
    return dc, params, ddpm(MP_F32_K), reqs


# ------------------------------------------------------------ mesh_serve
# the serve CLI's --mesh over the batch axes (serving/worker.py
# state_sharding, core/asd.py asd_sample_batched(keys=)) on the
# model_parallel phase's two ranks, against the 1 x 1 engine and sampler
# in this process: run -> mesh.  The pixel-dit runs at MP_ENGINE_DEPTH
# layers (unpacked, counter noise, RPS rounds a superstep, REQUESTS keyed
# requests; the fused sampler over CHAINS chains), the pod run is the
# float32 policy engine of MP_F32_RUNS["policy_tp2"], unpacked
MESH_SERVE_RUNS = {"continuous": "2x1", "fused": "2x1", "pod": "2x1x1"}


def _mesh_serve_pixel(torch, dev):
    """(dc, model function, schedule, requests) of the pixel-dit runs."""
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.serving.worker import Request
    from repro_torch.weights import init_denoiser_params

    dc = _mp_pixel_dc(MP_ENGINE_DEPTH)
    fn = make_sl_model_fn(init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev), dc)
    reqs = [Request(i, key=np.array([0, 5000 + i], np.uint32)) for i in range(REQUESTS)]
    return dc, fn, sl_geometric(K, 0.05, 50.0), reqs


def _mesh_serve_engine(torch, run, dev, layout=None):
    """(engine, requests) of mesh_serve ``run`` on ``dev``, its slots laid
    out by ``layout`` (None: the 1 x 1 engine)."""
    from repro_torch.models.diffusion import make_ddpm_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine

    if run == "pod":
        dc, params, sched, reqs = _mp_f32_setup(torch, dev, "policy_tp2")
        fn, theta, rps = make_ddpm_model_fn(params, dc), MP_F32_THETA, 1
    else:
        dc, fn, sched, reqs = _mesh_serve_pixel(torch, dev)
        theta, rps = THETA, RPS
    eng = ContinuousASDEngine(fn, sched, (dc.seq_len, dc.d_data), num_slots=SLOTS, theta=theta,
                              noise_mode="counter", keep_trajectory=False, rounds_per_sync=rps,
                              device=dev, state_sharding=layout)
    return eng, reqs


def _state_bytes(st):
    return sum(t.numel() * t.element_size() for f in dataclasses.fields(st)
               if (t := getattr(st, f.name)) is not None)


def _mesh_serve_measure(torch, run, dev, counters, layout=None):
    """Two serves of ``run``'s requests on its engine (the first captures
    its programs, the second replays them): per serve the samples, each
    request's counters, rounds, supersteps, launches, host wall, the
    boundary gathers' seconds, and the superstep programs' captures and
    calls; the peak memory (weights included) and the slot-state bytes."""
    base = _fresh_memory(torch)
    eng, reqs = _mesh_serve_engine(torch, run, dev, layout)
    runs = []
    for _ in range(2):
        s, progs = eng.stats, eng._superstep_fns
        before = (s.rounds_total, s.supersteps, s.gather_s, len(s.per_request),
                  sum(p.captures for p in progs.values()), sum(p.calls for p in progs.values()))
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        samples = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(
            samples=samples, wall_s=wall, launches=_launches(counters),
            rounds=s.rounds_total - before[0], supersteps=s.supersteps - before[1],
            gather_s=s.gather_s - before[2],
            counters={m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
                      for m in s.per_request[before[3]:]},
            captures=sum(p.captures for p in progs.values()) - before[4],
            calls=sum(p.calls for p in progs.values()) - before[5]))
    return dict(runs=runs, peak_bytes=_memory(torch, base)["peak_bytes"],
                slot_bytes=_state_bytes(eng._states), eager=eng._eager)


def _mesh_serve_fused(torch, dev, counters, layout=None):
    """The fused sampler over CHAINS pixel-dit chains from zeros, or over
    ``layout``'s block of them with their rows of ``split(key, CHAINS)``,
    gathered to rank 0 as the serve CLI gathers them."""
    from repro_torch.core import prng
    from repro_torch.core.asd import asd_sample_batched

    base = _fresh_memory(torch)
    dc, fn, sched, _ = _mesh_serve_pixel(torch, dev)
    key = prng.PRNGKey(SEED + 600)
    y0 = torch.zeros(CHAINS, dc.seq_len, dc.d_data, device=dev)
    kw = dict(key=key)
    if layout is not None:
        rows = layout.rows(CHAINS)
        y0, kw = y0[rows], dict(keys=prng.split(key, CHAINS)[rows])
    _zero_counters(torch, counters)
    t0 = time.perf_counter()
    with torch.no_grad():
        res = asd_sample_batched(fn, sched, y0, THETA, eager_head=True, keep_trajectory=False,
                                 device=dev, noise_mode="counter", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    fields = [res.sample, res.rounds, res.head_calls]
    out = dict(block=[f.cpu() for f in fields], wall_s=wall, launches=launches,
               loop_rounds=res.loop.rounds, capture_ms=res.loop.capture_ms,
               state_bytes=res.trajectory.numel() * res.trajectory.element_size(),
               peak_bytes=_memory(torch, base)["peak_bytes"], gather_s=0.0)
    if layout is not None:
        t0 = time.perf_counter()
        every = [layout.group.gather_rows_to_lead(f, [y0.shape[0]] * layout.ranks)
                 for f in fields]
        out["gather_s"] = time.perf_counter() - t0
        out["gathered"] = every if layout.group.rank == 0 else None
    return out


def _mesh_serve_rank(torch, group, counters):
    """This rank's mesh_serve runs (see MESH_SERVE_RUNS)."""
    from repro_torch.distributed.sharding import chain_state_shardings
    from repro_torch.launch.mesh import make_rank_mesh

    t_start = time.perf_counter()
    layouts = {spec: chain_state_shardings(make_rank_mesh(group, spec))
               for spec in sorted(set(MESH_SERVE_RUNS.values()))}
    out = {}
    for run, spec in MESH_SERVE_RUNS.items():
        out[run] = (_mesh_serve_fused(torch, group.device, counters, layouts[spec])
                    if run == "fused" else
                    _mesh_serve_measure(torch, run, group.device, counters, layouts[spec]))
    out["wall_s"] = time.perf_counter() - t_start
    return out


def run_mesh_serve_reference(torch, dev, counters):
    """The 1 x 1 engines (two serves each) and the 1 x 1 sampler of the
    mesh_serve runs, here."""
    out = {run: (_mesh_serve_fused(torch, dev, counters) if run == "fused"
                 else _mesh_serve_measure(torch, run, dev, counters))
           for run in MESH_SERVE_RUNS}
    _fresh_memory(torch)
    return out


def _mesh_serve_bits(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[r].view(np.int32), b[r].view(np.int32)) for r in a)


def _tensor_bits(torch, a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_mesh_serve(torch, card, ref, ranks, f32_ref):
    """Every mesh_serve run against its 1 x 1 run: each request's sample
    bits (on rank 0) and counters (on every rank), half the slot-state
    bytes a rank, warm supersteps replayed (the engines), B1 and B2
    launched as often a round as 1 x 1, finite samples; one
    ``mesh_serve`` line a run.  Returns the launches by run (both ranks)."""
    by_run = {}
    for run, spec in MESH_SERVE_RUNS.items():
        one = ref[run]
        mine = [r["mesh_serve"][run] for r in ranks]
        flash = "flash_attention_f32" if run == "pod" else "flash_attention"
        problems = []
        if run == "fused":
            whole = one["block"]
            got = mine[0]["gathered"]
            if not all(_tensor_bits(torch, g, w) for g, w in zip(got, whole)):
                problems.append("the gathered chains differ from the 1 x 1 call")
            for i, m in enumerate(mine):
                rows = slice(i * CHAINS // len(mine), (i + 1) * CHAINS // len(mine))
                if not all(_tensor_bits(torch, b, w[rows]) for b, w in zip(m["block"], whole)):
                    problems.append(f"rank {i}'s block differs from the 1 x 1 rows")
                if m["state_bytes"] * len(mine) != one["state_bytes"]:
                    problems.append(f"rank {i}: chain state {m['state_bytes']} B of "
                                    f"{one['state_bytes']}")
            lpr = [{k: m["launches"][k] / m["loop_rounds"] for k in ("grs", flash)}
                   for m in mine + [one]]
            finite = bool(torch.isfinite(got[0]).all())
            warm = [(m["wall_s"] * 1e3 - (m["capture_ms"] or 0.0)) / m["loop_rounds"]
                    for m in mine + [one]]
            gather = [m["gather_s"] for m in mine]
            share = [m["gather_s"] / m["wall_s"] for m in mine]
            peaks = [m["peak_bytes"] for m in mine + [one]]
        else:
            for i, m in enumerate(mine):
                for j, r in enumerate(m["runs"]):
                    if r["counters"] != one["runs"][0]["counters"]:
                        problems.append(f"rank {i} serve {j}: counters differ")
                    if i == 0 and not _mesh_serve_bits(r["samples"], one["runs"][0]["samples"]):
                        problems.append(f"serve {j}: rank 0's samples differ from 1 x 1's")
                if m["slot_bytes"] * len(mine) != one["slot_bytes"]:
                    problems.append(f"rank {i}: slot state {m['slot_bytes']} B of "
                                    f"{one['slot_bytes']}")
                w = m["runs"][1]
                if m["eager"] or w["captures"] or w["calls"] != w["supersteps"]:
                    problems.append(f"rank {i}: warm serve not all replays (eager "
                                    f"{m['eager']}, captures {w['captures']}, calls "
                                    f"{w['calls']} for {w['supersteps']} supersteps)")
            if run == "pod":  # the 1 x 1 engine in this process is the phase's reference
                if not (_mesh_serve_bits(one["runs"][0]["samples"], f32_ref["samples"])
                        and one["runs"][0]["counters"] == f32_ref["counters"]):
                    problems.append("the 1 x 1 engine differs from refs['policy_tp2']")
            lpr = [{k: m["runs"][1]["launches"][k] / m["runs"][1]["rounds"]
                    for k in ("grs", flash)} for m in mine + [one]]
            finite = all(bool(np.isfinite(v).all()) for v in mine[0]["runs"][1]["samples"].values())
            warm = [m["runs"][1]["wall_s"] * 1e3 / m["runs"][1]["rounds"] for m in mine + [one]]
            gather = [m["runs"][1]["gather_s"] for m in mine]
            share = [m["runs"][1]["gather_s"] / m["runs"][1]["wall_s"] for m in mine]
            peaks = [m["peak_bytes"] for m in mine + [one]]
        if any(p != lpr[-1] for p in lpr) or not all(lpr[-1].values()):
            problems.append(f"launches a round (ranks, then 1 x 1) {lpr}")
        if not finite:
            problems.append("samples not finite")
        if problems:
            fail(f"mesh_serve {run} on {spec}: {problems}")
        emit("mesh_serve", run=run, mesh=spec, card=card,
             model="paper-diffusion-policy-smoke" if run == "pod" else "paper-pixel-dit",
             layers=None if run == "pod" else MP_ENGINE_DEPTH,
             dtype="float32" if run == "pod" else "bf16",
             slots=None if run == "fused" else SLOTS,
             chains=CHAINS if run == "fused" else None,
             requests=None if run == "fused" else len(one["runs"][0]["samples"]),
             theta=MP_F32_THETA if run == "pod" else THETA,
             K=MP_F32_K if run == "pod" else K,
             rounds_per_sync=None if run == "fused" else (1 if run == "pod" else RPS),
             equal_bits=True, counters_equal=True,
             state_bytes_by_rank=[m["state_bytes" if run == "fused" else "slot_bytes"]
                                  for m in mine],
             state_bytes_1x1=one["state_bytes" if run == "fused" else "slot_bytes"],
             warm_supersteps_replayed=None if run == "fused" else True,
             launches_per_round=lpr[-1],
             warm_round_ms_by_rank=warm[:-1], warm_round_ms_1x1=warm[-1],
             gather_s_by_rank=gather, gather_share_by_rank=share,
             peak_bytes_by_rank=peaks[:-1], peak_bytes_1x1=peaks[-1],
             note=("both ranks share this one card and meet over host-staged gloo (pinned "
                   "host copies) at each boundary; round ms: host wall of the second serve "
                   "/ its rounds" if run != "fused" else
                   "both ranks share this one card; the gathers to rank 0 are host-staged "
                   "gloo; round ms: host wall net of the loop's capture / the loop's rounds"))
        launches = ([m["launches"] for m in mine] if run == "fused" else
                    [r["launches"] for m in mine for r in m["runs"]])
        by_run[f"mesh_serve_{run}"] = {k: sum(n[k] for n in launches) for k in launches[0]}
    return by_run


# ------------------------------------------------------ mesh_serve (model)
# the serve mesh's model axis (distributed/sharding.py ServeLayout: the
# weights by param_pspecs over the mesh's model ranks, the tp_paths leaves'
# blocks computed tensor-parallel, every other cut leaf gathered at each
# model call; serving/worker.py slot blocks beside the mesh's model group;
# core/asd.py asd_sample_batched(eager=True)): run -> mesh.  "model" and
# "model_fused" are pixel-dit at its published widths and MESH_MODEL_DEPTH
# layers (every row-parallel product's psum and every gathered leaf
# crosses the host), unpacked, MESH_MODEL_K steps at θ MESH_MODEL_THETA:
# the verification call is SLOTS (or CHAINS) x (θ + 1) = 16 points at 8
# local heads, the shape of the model_parallel B2 row.  "model_policy" and
# "data_model" are the pod run's float32 policy engine; "data_model" runs
# on a group of four ranks sharing the card
MESH_MODEL_RUNS = {"model": "1x2", "model_fused": "1x2", "model_policy": "1x2",
                   "data_model": "2x2"}
MESH_MODEL_DEPTH, MESH_MODEL_K, MESH_MODEL_THETA, MESH_MODEL_REQUESTS = 2, 16, 3, 4
# the model call's relative L2 against the replicated call: MP_BF16_GATE's
# rule at MESH_MODEL_DEPTH layers
MESH_MODEL_BF16_GATE = 2 * 2.0 ** -8 * math.sqrt(2 * MESH_MODEL_DEPTH)


def _mesh_model_pixel(torch, dev):
    """(dc, params cast to the compute dtype, schedule, requests) of the
    pixel-dit model runs (the same weights on every process)."""
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import compute_params
    from repro_torch.serving.worker import Request
    from repro_torch.weights import init_denoiser_params

    dc = _mp_pixel_dc(MESH_MODEL_DEPTH)
    params = compute_params(init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev), dc)
    reqs = [Request(i, key=np.array([0, 6000 + i], np.uint32))
            for i in range(MESH_MODEL_REQUESTS)]
    return dc, params, sl_geometric(MESH_MODEL_K, 0.05, 50.0), reqs


def _serve_layout(dc, mesh):
    from repro_torch.distributed.sharding import ServeLayout
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import param_shapes

    return ServeLayout(param_axes(dc), param_shapes(dc), mesh)


def _mesh_model_engine(torch, run, dev, mesh=None):
    """(engine, requests, layout, whole params, dc, model-function maker) of
    model run ``run`` on ``dev``: on ``mesh`` its slots by
    ``chain_state_shardings`` and its weights by a ``ServeLayout`` (the
    engine keeps its blocks), else the 1 x 1 engine (layout None)."""
    from repro_torch.distributed.sharding import chain_state_shardings
    from repro_torch.models.diffusion import make_ddpm_model_fn, make_sl_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine

    if run == "model":
        dc, params, sched, reqs = _mesh_model_pixel(torch, dev)
        make, theta = make_sl_model_fn, MESH_MODEL_THETA
    else:
        dc, params, sched, reqs = _mp_f32_setup(torch, dev, "policy_tp2")
        make, theta = make_ddpm_model_fn, MP_F32_THETA
    kw = dict(num_slots=SLOTS, theta=theta, noise_mode="counter", keep_trajectory=False,
              rounds_per_sync=1, device=dev)
    event = (dc.seq_len, dc.d_data)
    if mesh is None:
        return ContinuousASDEngine(make(params, dc), sched, event, **kw), reqs, None, params, \
            dc, make
    layout = _serve_layout(dc, mesh)
    eng = ContinuousASDEngine(
        lambda p: make(p, dc, tp_axis=layout.tp_axis, at_use=layout.at_use), sched, event,
        state_sharding=chain_state_shardings(mesh), model_group=layout.model_group,
        params=params, param_specs=layout.specs, **kw)
    return eng, reqs, layout, params, dc, make


def _mesh_model_points(torch, dc, dev):
    """The model-call check's points: the verification call's 16, at noise
    levels over the schedule's range."""
    g = torch.Generator(device=dev).manual_seed(SEED + 95)
    n = SLOTS * (MESH_MODEL_THETA + 1)
    t = torch.exp(torch.linspace(math.log(0.05), math.log(50.0), n)).to(dev)
    y = torch.randn(n, dc.seq_len, dc.d_data, generator=g, device=dev) * (
        t * t + t).sqrt()[:, None, None]
    return t, y


def _mesh_model_measure(torch, run, dev, counters, mesh=None):
    """Run ``run`` on ``dev``, on this rank of ``mesh`` (None: the 1 x 1
    engine): on a mesh the weights' bytes (the rank's blocks, the layout's
    count, the whole tree) and, for pixel-dit, the model call on the
    check's points (and on rank 0 the replicated call); then two serves
    (each: samples, counters, rounds, launches, host wall, the
    collectives' wall, the gathers at use, the programs' captures and
    calls) and the peak memory."""
    from repro_torch.distributed.group import collective_seconds

    base = _fresh_memory(torch)
    eng, reqs, layout, params, dc, make = _mesh_model_engine(torch, run, dev, mesh)
    out = {}
    if layout is not None:
        out = dict(coords=dict(mesh.coords), resident_bytes=_tree_bytes(eng._params),
                   layout_bytes=layout.local_bytes(params), whole_bytes=_tree_bytes(params),
                   gathered_leaves=len(layout.gathered), tp_leaves=len(layout.tp),
                   eager=eng._eager)
        if run == "model":
            t, y = _mesh_model_points(torch, dc, dev)
            with torch.no_grad():
                out["call"] = eng._model_fn(t, y).cpu()
                if mesh.rank == 0:
                    out["replicated_call"] = make(params, dc)(t, y).cpu()
    del params

    def taken():
        progs = eng._superstep_fns.values()
        s, lay = eng.stats, layout
        return dict(rounds=s.rounds_total, supersteps=s.supersteps,
                    captures=sum(p.captures for p in progs)
                    + sum(p.captures for p in eng._admit_fns.values()),
                    calls=sum(p.calls for p in progs), collective_s=collective_seconds(),
                    gathers=lay.gathers if lay else 0,
                    gathered_elements=lay.gathered_elements if lay else 0,
                    gathered_bytes=lay.gathered_bytes if lay else 0)

    runs = []
    for _ in range(2):
        before, n_req = taken(), len(eng.stats.per_request)
        _zero_counters(torch, counters)
        t0 = time.perf_counter()
        samples = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(
            {k: v - before[k] for k, v in taken().items()}, samples=samples, wall_s=wall,
            launches=_launches(counters),
            counters={m.rid: (m.rounds, m.head_calls, m.model_evals, m.accepts, m.proposals)
                      for m in eng.stats.per_request[n_req:]}))
    out.update(runs=runs, peak_bytes=_memory(torch, base)["peak_bytes"])
    return out


def _mesh_model_fused(torch, dev, counters, mesh=None):
    """The fused sampler over CHAINS pixel-dit chains from zeros, each from
    its row of ``split(key, CHAINS)``: on this rank of ``mesh`` its block of
    the chains over its blocks of the weights, every round eager
    (``eager=True``: the model call's collectives are host-staged); with
    no mesh all of them over the whole weights, the round captured."""
    from repro_torch.core import prng
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.distributed.group import collective_seconds
    from repro_torch.distributed.sharding import chain_state_shardings
    from repro_torch.models.diffusion import make_sl_model_fn

    base = _fresh_memory(torch)
    dc, params, sched, _ = _mesh_model_pixel(torch, dev)
    rows, out, layout = slice(0, CHAINS), {}, None
    if mesh is None:
        fn = make_sl_model_fn(params, dc)
    else:
        layout = _serve_layout(dc, mesh)
        blocks = layout.shard(params)
        out = dict(resident_bytes=_tree_bytes(blocks), layout_bytes=layout.local_bytes(params))
        fn = make_sl_model_fn(blocks, dc, tp_axis=layout.tp_axis, at_use=layout.at_use)
        rows = chain_state_shardings(mesh).rows(CHAINS)
        del blocks
    del params
    y0 = torch.zeros(CHAINS, dc.seq_len, dc.d_data, device=dev)[rows]
    keys = prng.split(prng.PRNGKey(SEED + 650), CHAINS)[rows]
    _zero_counters(torch, counters)
    gathers, coll = layout.gathers if layout else 0, collective_seconds()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = asd_sample_batched(fn, sched, y0, MESH_MODEL_THETA, eager_head=True,
                                 keep_trajectory=False, device=dev, noise_mode="counter",
                                 keys=keys, eager=mesh is not None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(block=[f.cpu() for f in (res.sample, res.rounds, res.head_calls)], wall_s=wall,
               launches=_launches(counters), loop_rounds=res.loop.rounds,
               capture_ms=res.loop.capture_ms,
               gathers=(layout.gathers if layout else 0) - gathers,
               collective_s=collective_seconds() - coll,
               peak_bytes=_memory(torch, base)["peak_bytes"])
    return out


def _mesh_model_rank(torch, group, counters):
    """This rank's 1x2 model runs (MESH_MODEL_RUNS but data_model)."""
    from repro_torch.launch.mesh import make_rank_mesh

    t_start = time.perf_counter()
    mesh, dev = make_rank_mesh(group, "1x2"), group.device
    out = {"model": _mesh_model_measure(torch, "model", dev, counters, mesh),
           "model_fused": _mesh_model_fused(torch, dev, counters, mesh),
           "model_policy": _mesh_model_measure(torch, "model_policy", dev, counters, mesh)}
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _mesh_data_model_rank(group):
    """One rank of the 2x2 data_model run: a group of four ranks on the
    card."""
    import torch

    from repro_torch.launch.mesh import make_rank_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out = _mesh_model_measure(torch, "data_model", group.device, _counters(),
                              make_rank_mesh(group, "2x2"))
    out["wall_s"] = time.perf_counter() - t_start
    return out


def run_mesh_model_reference(torch, dev, counters):
    """The 1 x 1 pixel-dit engine (two serves) and fused sampler of the
    model runs, here; the policy runs' 1 x 1 is mesh_serve's pod run."""
    out = {"model": _mesh_model_measure(torch, "model", dev, counters),
           "model_fused": _mesh_model_fused(torch, dev, counters)}
    _fresh_memory(torch)
    return out


def _per_round_launches(m, flash):
    return {k: m["launches"][k] / m["rounds"] for k in ("grs", flash)}


def _mesh_model_per_round(run, flash, rows):
    """What a round launches on a rank of a model run: B1 once, and B2 once
    a layer for each block of 16 points of its two model calls (the
    proposal over the block's ``rows`` chains, the verification over rows
    x (θ + 1) points), which the mesh's model call runs in
    (``models/diffusion.py::_mesh_call``)."""
    pixel = run in ("model", "model_fused")
    layers = MESH_MODEL_DEPTH if pixel else 2
    theta = MESH_MODEL_THETA if pixel else MP_F32_THETA
    blocks = -(-rows // 16) + -(-rows * (theta + 1) // 16)
    return {"grs": 1.0, flash: float(layers * blocks)}


def check_mesh_serve_model(torch, card, ref, pod_ref, ranks, four):
    """The model runs against their 1 x 1 runs (see MESH_MODEL_RUNS): the
    model ranks of a block in the same bits, both serves alike; the pixel-dit
    model call within MESH_MODEL_BF16_GATE of the replicated call; the
    float32 policy within MP_F32_TOL of 1 x 1 with its counters, and 2x2
    with 1x2's bits; a rank's weight bytes the layout's; no capture; B1
    once a round and B2 once a layer a block of 16 points of a call (the
    1 x 1 eager body's count where a call fits one block: every pixel-dit
    run); finite samples.  One ``mesh_serve`` line a run.  Returns the
    launches by run (every rank)."""
    by_run = {}
    one_x_two = [r["mesh_serve_model"] for r in ranks]
    for run, spec in MESH_MODEL_RUNS.items():
        mine = four if run == "data_model" else [r[run] for r in one_x_two]
        one = ref.get(run) if run in ("model", "model_fused") else pod_ref
        flash = "flash_attention" if run in ("model", "model_fused") else "flash_attention_f32"
        problems, fields = [], {}
        if run == "model_fused":
            blocks = [m["block"] for m in mine]
            if not all(_tensor_bits(torch, a, b) for m in blocks[1:] for a, b in zip(m, blocks[0])):
                problems.append("the model ranks' chains differ in bits")
            if any(m["capture_ms"] is not None for m in mine) or one["capture_ms"] is None:
                problems.append(f"captures: ranks {[m['capture_ms'] for m in mine]}, 1 x 1 "
                                f"{one['capture_ms']}")
            for m in mine:
                if m["resident_bytes"] != m["layout_bytes"]:
                    problems.append(f"resident {m['resident_bytes']} B, layout "
                                    f"{m['layout_bytes']}")
            lpr = [{k: m["launches"][k] / m["loop_rounds"] for k in ("grs", flash)}
                   for m in mine + [one]]
            want = _mesh_model_per_round(run, flash, CHAINS)
            finite = bool(torch.isfinite(blocks[0][0]).all())
            warm = [m["wall_s"] * 1e3 / m["loop_rounds"] for m in mine] + [
                (one["wall_s"] * 1e3 - (one["capture_ms"] or 0.0)) / one["loop_rounds"]]
            sample_rel = _rel_l2(blocks[0][0].float(), one["block"][0].float())
            fields = dict(
                chains=CHAINS, rounds_by_rank=[m["loop_rounds"] for m in mine],
                rounds_1x1=one["loop_rounds"],
                rounds_equal_1x1=bool(torch.equal(blocks[0][1], one["block"][1])),
                sample_relative_l2_1x1=sample_rel, captures_by_rank=0,
                capture_ms_1x1=one["capture_ms"],
                gathers_by_rank=[m["gathers"] for m in mine],
                collective_s_by_rank=[m["collective_s"] for m in mine],
                collective_share_by_rank=[m["collective_s"] / m["wall_s"] for m in mine])
        else:
            lead = mine[0]["runs"][0]
            for i, m in enumerate(mine):
                if m["resident_bytes"] != m["layout_bytes"] or not m["resident_bytes"] < \
                        m["whole_bytes"]:
                    problems.append(f"rank {i}: resident {m['resident_bytes']} B, layout "
                                    f"{m['layout_bytes']}, whole {m['whole_bytes']}")
                if not m["eager"]:
                    problems.append(f"rank {i}: programs not eager")
                for j, r in enumerate(m["runs"]):
                    if r["captures"]:
                        problems.append(f"rank {i} serve {j}: {r['captures']} captures")
                    if r["counters"] != lead["counters"]:
                        problems.append(f"rank {i} serve {j}: counters differ from rank 0's")
                    if sorted(r["samples"]) != list(range(len(lead["counters"]))) and i == 0:
                        problems.append(f"serve {j}: rank 0 retired {sorted(r['samples'])}")
                    if not all(np.array_equal(v.view(np.int32), lead["samples"][rid].view(
                            np.int32)) for rid, v in r["samples"].items()):
                        problems.append(f"rank {i} serve {j}: samples differ from rank 0's")
            if run == "model":
                calls = [m["call"] for m in mine]
                rels = [_rel_l2(c.float(), mine[0]["replicated_call"].float()) for c in calls]
                if not all(torch.equal(c, calls[0]) for c in calls[1:]):
                    problems.append("the model ranks' model calls differ in bits")
                if not all(e <= MESH_MODEL_BF16_GATE for e in rels):
                    problems.append(f"model call relative L2 {rels} > {MESH_MODEL_BF16_GATE}")
                fields = dict(model_call_relative_l2_by_rank=rels,
                              model_call_gate=MESH_MODEL_BF16_GATE,
                              counters_equal_1x1=lead["counters"] == one["runs"][0]["counters"],
                              sample_relative_l2_1x1=max(
                                  _rel_l2(torch.from_numpy(v), torch.from_numpy(
                                      one["runs"][0]["samples"][rid])) for rid, v in
                                  lead["samples"].items()))
            else:  # float32: the 1 x 1 counters, within tolerance; 2x2 the 1x2 bits
                want = one["runs"][0]
                used = max(float((np.abs(v - want["samples"][rid])
                                  / (MP_F32_TOL + MP_F32_TOL * np.abs(want["samples"][rid]))).max())
                           for rid, v in lead["samples"].items())
                if lead["counters"] != want["counters"] or not used <= 1.0:
                    problems.append(f"against 1 x 1: counters equal "
                                    f"{lead['counters'] == want['counters']}, {used} of the "
                                    "tolerance")
                fields = dict(tolerance=f"{MP_F32_TOL} + {MP_F32_TOL} |1x1|",
                              tolerance_used=used, counters_equal_1x1=True)
                if run == "data_model":
                    base_ = one_x_two[0]["model_policy"]["runs"][0]
                    if lead["counters"] != base_["counters"] or not _mesh_serve_bits(
                            lead["samples"], base_["samples"]):
                        problems.append("2x2 differs from 1x2's bits or counters")
                    fields["equal_bits_1x2"] = True
                    fields["coords_by_rank"] = [m["coords"] for m in mine]
            lpr = [_per_round_launches(m["runs"][1], flash) for m in mine] + [
                _per_round_launches(one["runs"][1], flash)]
            want = _mesh_model_per_round(run, flash, SLOTS // (2 if run == "data_model" else 1))
            finite = all(bool(np.isfinite(v).all()) for v in lead["samples"].values())
            warm = [m["runs"][1]["wall_s"] * 1e3 / m["runs"][1]["rounds"] for m in mine] + [
                one["runs"][1]["wall_s"] * 1e3 / one["runs"][1]["rounds"]]
            w = [m["runs"][1] for m in mine]
            fields.update(
                slots=SLOTS, requests=len(lead["samples"]), rounds=w[0]["rounds"],
                supersteps=w[0]["supersteps"], ranks_equal_bits=True, captures_by_rank=0,
                resident_weight_bytes_by_rank=[m["resident_bytes"] for m in mine],
                layout_weight_bytes=mine[0]["layout_bytes"], resident_equals_layout=True,
                whole_weight_bytes=mine[0]["whole_bytes"],
                gathered_leaves=mine[0]["gathered_leaves"], tp_leaves=mine[0]["tp_leaves"],
                gathered_elements_per_round=w[0]["gathered_elements"] / w[0]["rounds"],
                gathered_bytes_per_round=w[0]["gathered_bytes"] / w[0]["rounds"],
                gathers_per_round=w[0]["gathers"] / w[0]["rounds"],
                collective_s_by_rank=[r["collective_s"] for r in w],
                collective_share_by_rank=[r["collective_s"] / r["wall_s"] for r in w])
        if any(p != want for p in lpr[:-1]) or lpr[-1]["grs"] != 1.0 or not lpr[-1][flash]:
            problems.append(f"launches a round (ranks, then 1 x 1) {lpr}, the blocks' {want}")
        if not finite:
            problems.append("samples not finite")
        if problems:
            fail(f"mesh_serve {run} on {spec}: {problems}")
        pixel = run in ("model", "model_fused")
        emit("mesh_serve", run=run, mesh=spec, card=card,
             model="paper-pixel-dit" if pixel else "paper-diffusion-policy-smoke",
             layers=MESH_MODEL_DEPTH if pixel else None, dtype="bf16" if pixel else "float32",
             theta=MESH_MODEL_THETA if pixel else MP_F32_THETA,
             K=MESH_MODEL_K if pixel else MP_F32_K, rounds_per_sync=1,
             launches_per_round=want, launches_per_round_1x1=lpr[-1],
             warm_round_ms_by_rank=warm[:-1],
             warm_round_ms_1x1=warm[-1],
             peak_gb_by_rank=[m["peak_bytes"] / 1e9 for m in mine],
             peak_gb_1x1=one["peak_bytes"] / 1e9, **fields,
             note=("the ranks share this one card and meet over host-staged gloo (pinned host "
                   "copies): the model call's psums and gathers at use, the boundary's; every "
                   "program eager by design; round ms: host wall of the second serve (the "
                   "fused sampler: its one run) / its rounds; collective s: wall inside the "
                   "groups' collectives in that serve"))
        launches = ([m["launches"] for m in mine] if run == "model_fused" else
                    [r["launches"] for m in mine for r in m["runs"]])
        by_run[f"mesh_serve_{run}"] = {k: sum(n[k] for n in launches) for k in launches[0]}
    return by_run


def _mp_rank(group, mesh_ref):
    """One rank of the phase: the full-width forwards and engine, the
    float32 engines, then the trainer's meshes against the reference at
    ``mesh_ref``; returns what the parent checks (on the host)."""
    import torch

    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_ddpm_model_fn, make_sl_model_fn
    from repro_torch.serving.worker import Request
    from repro_torch.weights import init_denoiser_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, counters = group.device, _counters()
    dc = _mp_pixel_dc(PIXEL_DEPTH)
    t0 = time.perf_counter()
    params = init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev)
    out = {"rank": group.rank, "weights_s": time.perf_counter() - t0}
    out["pixel"] = _mp_pixel_forwards(torch, group, counters, dc, params)
    del params
    torch.cuda.empty_cache()
    dc = _mp_pixel_dc(MP_ENGINE_DEPTH)
    params = init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev)
    sched = sl_geometric(K, 0.05, 50.0)
    runs = []
    for i in range(2):  # the second run for its bits: no calibration probe
        t0 = time.perf_counter()
        eng = _mp_engine(group, dc, params, True, False, 1, make_sl_model_fn, sched,
                         calibrate=i == 0, num_slots=SLOTS, theta=THETA,
                         execution="packed", round_impl="fused", round_budget=BUDGET)
        init_s = time.perf_counter() - t0
        reqs = [Request(i, key=np.array([0, 4000 + i], np.uint32))
                for i in range(MP_ENGINE_REQUESTS)]
        runs.append(dict(_mp_serve(torch, eng, reqs, counters), init_s=init_s,
                         calibrated=dict(eng.workers[0]._collective_kind_s)))
        del eng
    out["engine"] = runs
    del params
    torch.cuda.empty_cache()
    out["f32"] = {}
    for name, (_, tensor, expert, sp, _) in MP_F32_RUNS.items():
        f32_dc, f32_params, f32_sched, reqs = _mp_f32_setup(torch, dev, name)
        eng = _mp_engine(group, f32_dc, f32_params, tensor, expert, sp, make_ddpm_model_fn,
                         f32_sched, num_slots=SLOTS, theta=MP_F32_THETA,
                         **_mp_f32_kwargs(name, 2))
        out["f32"][name] = _mp_serve(torch, eng, reqs, counters)
    del eng, f32_params
    torch.cuda.empty_cache()
    out["mesh_serve"] = _mesh_serve_rank(torch, group, counters)
    out["mesh_serve_model"] = _mesh_model_rank(torch, group, counters)
    out["mesh_train"] = _mesh_train_rank(torch, group, mesh_ref)
    return out


def _mp_forward_problems(torch, ranks, key, ref):
    """What is wrong with the ranks' ``key`` forward against ``ref``: a
    relative L2 error above MP_BF16_GATE, ranks of other bits, a value not
    finite.  Returns (problems, relative L2 errors by rank)."""
    outs = [r["pixel"][key] if key.endswith("fault") else r["pixel"][key]["out"]
            for r in ranks]
    rels = [_rel_l2(o.float(), ref.float()) for o in outs]
    problems = [f"rank {i}: relative L2 {e:.4g} > {MP_BF16_GATE:.4g}"
                for i, e in enumerate(rels) if not e <= MP_BF16_GATE]
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        problems.append("the ranks' outputs differ in bits")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        problems.append("not finite")
    return problems, rels


def mesh_model_f32_row(torch, dev):
    """B2's float32 kernel at the policy runs' shape on the serve mesh's
    model axis: a block of 16 points of 8 tokens at 2 of the 4 heads of
    16, against its plain version, timed as in phase 3 with SDPA in
    float32; the kernels-line row (every B2 launch of those runs is at
    this shape)."""
    from repro_torch.configs.registry import get_denoiser_config

    dc = get_denoiser_config(MP_F32_RUNS["policy_tp2"][0])
    H, hd = dc.backbone.n_heads // 2, dc.backbone.d_model // dc.backbone.n_heads
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = _flash_inputs(torch, dev, 16, dc.seq_len, dc.seq_len, H, hd, SEED + 36,
                            torch.float32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    f32 = _f32_timed(torch, q, k, v, dict(causal=False), lambda: sdpa(qt, kt, vt))
    if f32["design"] != "packed":
        fail(f"mesh_serve f32 row: B2 float32 launched {f32['design']}, not packed")
    return dict(name="flash_attention_f32", route="cuda", source=FLASH_F32_SOURCE,
                replaces=FLASH_REPLACES,
                at=f"policy smoke serve mesh, model axis 2: a block of 16 points "
                   f"{[16, dc.seq_len, H, hd]}", **f32,
                library="scaled_dot_product_attention (float32)",
                runs={"mesh_serve_model_policy": 1.0, "mesh_serve_data_model": 1.0})

def run_model_parallel(torch, dev):
    """Serving model parallelism over a model group of two ranks on this one
    card (``repro_torch.distributed.group.run_group``, gloo over pinned
    host copies), phase ``model_parallel``: the full-width pixel-dit TP2
    and SP2 forwards against the replicated forward (B2 at 8 local heads
    inside each), a planted fault, the TP2 engine at full width, and the
    float32 engines against the replicated engine on the card.  Returns
    (launches by run, the kernels-line row of B2 at the sharded
    verification's shape)."""
    from repro_torch.distributed.group import run_group
    from repro_torch.models.diffusion import make_ddpm_model_fn
    from repro_torch.serving.engine import ContinuousASDEngine

    t_phase = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    emit("model_parallel_note", card=card, note=(
        "every collective of this phase is host-staged gloo between two processes "
        "sharing this one card (pinned host copies), not NVLink; a host-staged "
        "collective cannot be captured, so the ranks' supersteps run eagerly and the "
        "captured phases' host-sync-as-error checks do not apply to them"))
    counters = _counters()
    # the replicated float32 engines, here on the card (captured graphs)
    refs = {}
    for name in MP_F32_RUNS:
        dc, params, sched, reqs = _mp_f32_setup(torch, dev, name)
        eng = ContinuousASDEngine(make_ddpm_model_fn(params, dc), sched,
                                  (dc.seq_len, dc.d_data), num_slots=SLOTS,
                                  theta=MP_F32_THETA, noise_mode="counter",
                                  keep_trajectory=False, device=dev,
                                  **_mp_f32_kwargs(name, 1))
        refs[name] = _mp_serve(torch, eng, reqs, counters)
        del eng
    _fresh_memory(torch)
    t0 = time.perf_counter()
    mesh_serve_ref = run_mesh_serve_reference(torch, dev, counters)
    mesh_model_ref = run_mesh_model_reference(torch, dev, counters)
    mesh_serve_ref_s = time.perf_counter() - t0
    mesh_dir = ROOT / "build" / "chip_smoke_mesh"
    mesh_dir.mkdir(parents=True, exist_ok=True)
    mesh_ref_path = str(mesh_dir / "reference_grads.pt")
    t0 = time.perf_counter()
    mesh_ref = run_mesh_train_reference(torch, dev, mesh_ref_path)
    mesh_ref_s = time.perf_counter() - t0
    _fresh_memory(torch)
    t0 = time.perf_counter()
    try:
        ranks = run_group(_mp_rank, MP_WORLD, dev, (mesh_ref_path,))
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    group_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = run_group(_mesh_data_model_rank, 4, dev)
    four_s = time.perf_counter() - t0
    r0 = ranks[0]
    ref = r0["pixel"]["ref"]
    by_run = {}
    for mode in ("tp2", "sp2"):
        problems, rels = _mp_forward_problems(torch, ranks, mode, ref)
        p = r0["pixel"][mode]
        if problems or not all(r["pixel"][mode]["again_equal"] for r in ranks):
            fail(f"model_parallel {mode} forward: {problems}, second call equal "
                 f"{[r['pixel'][mode]['again_equal'] for r in ranks]}")
        if p["launches"]["flash_attention"] != PIXEL_DEPTH or any(
                n for k, n in p["launches"].items() if k != "flash_attention"):
            fail(f"model_parallel {mode}: launches {p['launches']}, expected B2 "
                 f"{PIXEL_DEPTH} (once a layer) and nothing else")
        full, res = r0["pixel"]["full_bytes"], p["resident_bytes"]
        want = full - p["sharded_bytes"] + p["sharded_bytes"] // MP_WORLD
        if any(r["pixel"][mode]["resident_bytes"] != want for r in ranks):
            fail(f"model_parallel {mode}: resident weight bytes "
                 f"{[r['pixel'][mode]['resident_bytes'] for r in ranks]}, expected {want}")
        emit("model_parallel", run=f"pixel_{mode}_forward", card=card,
             model="paper-pixel-dit", layers=PIXEL_DEPTH, points=MP_POINTS,
             local_heads=16 // MP_WORLD,
             relative_l2_by_rank=rels, gate=MP_BF16_GATE, gate_rule=(
                 "2 x bf16 epsilon 2^-8 x sqrt(2 x depth): one more bf16 rounding of "
                 "each row-parallel product's partial sums, two products a layer"),
             ranks_equal_bits=True, second_call_equal_bits=True,
             b2_launches_per_call=p["launches"]["flash_attention"],
             first_call_ms=p["first_ms"], warm_call_ms=p["warm_ms"],
             replicated_warm_call_ms=r0["pixel"]["ref_ms"],
             resident_weight_bytes_by_rank=[r["pixel"][mode]["resident_bytes"]
                                            for r in ranks],
             replicated_weight_bytes=full, sharded_leaves=p["sharded_leaves"],
             sharded_leaf_bytes=p["sharded_bytes"],
             note="host wall with a synchronize; both ranks run on this one card at once")
        by_run[f"model_parallel_{mode}_forward"] = p["launches"]
    problems, rels = _mp_forward_problems(torch, ranks, "tp2_fault", ref)
    if not problems:
        fail(f"model_parallel planted fault: the TP2 check passed with rank 1's wo psum "
             f"dropped (relative L2 {rels})")
    emit("model_parallel", run="planted_fault", card=card,
         fault="rank 1 keeps its own wo partial sum (the psum still runs)",
         relative_l2_by_rank=rels, gate=MP_BF16_GATE, check_failed_with=problems)
    # the engine at full width: both ranks, both runs, the same bits
    runs = [r["engine"] for r in ranks]
    first = runs[0][0]
    per_round = _per_round(MP_ENGINE_DEPTH)["fused"]
    for rank, rank_runs in enumerate(runs):
        for i, run in enumerate(rank_runs):
            if sorted(run["samples"]) != list(range(MP_ENGINE_REQUESTS)):
                fail(f"model_parallel engine rank {rank} run {i}: retired "
                     f"{sorted(run['samples'])}")
            same = all(np.array_equal(run["samples"][r].view(np.int32),
                                      first["samples"][r].view(np.int32))
                       for r in first["samples"])
            if not same or run["counters"] != first["counters"] or not run["eager"]:
                fail(f"model_parallel engine rank {rank} run {i}: bits {same}, counters "
                     f"{run['counters'] == first['counters']}, eager {run['eager']}")
            want = {k: per_round.get(k, 0) * run["rounds"] for k in run["launches"]}
            if run["launches"] != want:
                fail(f"model_parallel engine rank {rank} run {i}: launches "
                     f"{run['launches']}, the replicated engine's {want} for "
                     f"{run['rounds']} rounds")
            if i == 0 and not run["collective_psum_s"] > 0:
                fail(f"model_parallel engine: no collective lane ({run})")
    warm = runs[0][1]
    finite = all(bool(np.isfinite(s).all()) for s in warm["samples"].values())
    if not finite:
        fail("model_parallel engine: samples not finite")
    emit("model_parallel", run="pixel_tp2_engine", card=card, model="paper-pixel-dit",
         layers=MP_ENGINE_DEPTH, requests=MP_ENGINE_REQUESTS, slots=SLOTS, theta=THETA, K=K,
         round_budget=BUDGET, round_impl="fused", noise_mode="counter",
         retired=len(warm["samples"]), ranks_equal_bits=True, runs_equal_bits=True,
         rounds=warm["rounds"], supersteps=warm["supersteps"],
         launches_per_round={k: n / warm["rounds"] for k, n in warm["launches"].items()},
         warm_round_ms=warm["wall_s"] * 1e3 / warm["rounds"],
         first_run_round_ms=first["wall_s"] * 1e3 / first["rounds"],
         collective_psum_ms_per_round=first["collective_psum_s"] * 1e3 / first["rounds"],
         collective_a2a_ms_per_round=first["collective_a2a_s"] * 1e3 / first["rounds"],
         calibrated_s_per_round=first["calibrated"], engine_init_s=first["init_s"],
         engine_init_s_uncalibrated=warm["init_s"],
         accepts=sum(c[3] for c in warm["counters"].values()),
         proposals=sum(c[4] for c in warm["counters"].values()),
         note=("collective ms: the first run's calibrated probe (host-staged gloo on one "
               "card) x rounds; round ms: host wall of the second run / its rounds"))
    by_run["model_parallel_engine"] = {k: first["launches"][k] + warm["launches"][k]
                                       for k in first["launches"]}
    # the float32 engines against the replicated engine on the card
    for name, (cfg, tensor, expert, sp, fused) in MP_F32_RUNS.items():
        rep = refs[name]
        mp = [r["f32"][name] for r in ranks]
        bits = all(np.array_equal(m["samples"][i].view(np.int32),
                                  mp[0]["samples"][i].view(np.int32))
                   for m in mp for i in rep["samples"])
        err = max(float(np.abs(mp[0]["samples"][i] - rep["samples"][i]).max())
                  for i in rep["samples"])
        used = max(float((np.abs(mp[0]["samples"][i] - rep["samples"][i])
                          / (MP_F32_TOL + MP_F32_TOL * np.abs(rep["samples"][i]))).max())
                   for i in rep["samples"])
        lpr_mp = {k: n / mp[0]["rounds"] for k, n in mp[0]["launches"].items()}
        lpr_rep = {k: n / rep["rounds"] for k, n in rep["launches"].items()}
        if (mp[0]["counters"] != rep["counters"] or not bits or not used <= 1.0
                or lpr_mp != lpr_rep):
            fail(f"model_parallel {name}: counters equal "
                 f"{mp[0]['counters'] == rep['counters']}, ranks' bits {bits}, max abs "
                 f"error {err} ({used} of the tolerance), launches per round {lpr_mp} "
                 f"against {lpr_rep}")
        emit("model_parallel", run=f"f32_{name}", card=card, model=cfg, tensor=tensor,
             expert=expert, sp=sp, engine=_mp_f32_kwargs(name, 2) or "unpacked", K=MP_F32_K, theta=MP_F32_THETA, slots=SLOTS,
             requests=MP_F32_REQUESTS, counters_equal=True, ranks_equal_bits=True,
             max_abs_err=err, tolerance=f"{MP_F32_TOL} + {MP_F32_TOL} |replicated|",
             tolerance_used=used, launches_per_round=lpr_mp,
             accept_law="counters equal: no accept bit differed from the replicated engine",
             accepts=sum(c[3] for c in rep["counters"].values()),
             proposals=sum(c[4] for c in rep["counters"].values()),
             collective_s=mp[0]["collective_s"], round_ms=mp[0]["wall_s"] * 1e3 / mp[0]["rounds"],
             replicated_round_ms=rep["wall_s"] * 1e3 / rep["rounds"])
        by_run[f"model_parallel_f32_{name}"] = mp[0]["launches"]
    by_run.update(check_mesh_serve(torch, card, mesh_serve_ref, ranks, refs["policy_tp2"]))
    by_run.update(check_mesh_serve_model(torch, card, mesh_model_ref, mesh_serve_ref["pod"],
                                         ranks, four))
    check_mesh_train(torch, card, mesh_ref, ranks)
    row = flash_shape_row(torch, dev, "model_parallel TP2 / SP2 verification, 8 local heads",
                          (MP_POINTS, 1024, 1024, 16 // MP_WORLD, 64), False)
    # the verification call's share of a run's B2 launches (the engine: two
    # calls a round, 16 points and the proposal's 4; the serve mesh's model
    # runs pad the proposal to a block of 16 points)
    row["runs"] = {"model_parallel_tp2_forward": 1.0, "model_parallel_sp2_forward": 1.0,
                   "model_parallel_engine": 0.5, "mesh_serve_model": 1.0,
                   "mesh_serve_model_fused": 1.0}
    rows = [row, mesh_model_f32_row(torch, dev)]
    emit("model_parallel_done", card=card, group_s=group_s, rank_weights_s=r0["weights_s"],
         mesh_train_reference_s=mesh_ref_s, mesh_serve_reference_s=mesh_serve_ref_s,
         mesh_serve_rank_s=[r["mesh_serve"]["wall_s"] for r in ranks],
         mesh_serve_model_rank_s=[r["mesh_serve_model"]["wall_s"] for r in ranks],
         mesh_serve_data_model_group_s=four_s,
         mesh_serve_data_model_rank_s=[r["wall_s"] for r in four],
         mesh_train_rank_s=[sum(v["wall_s"] for v in r["mesh_train"].values()) for r in ranks],
         phase_wall_s=time.perf_counter() - t_phase)
    return by_run, rows


class PhaseClock:
    """Wall seconds since the previous mark, by the name given at each."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    from repro_torch.kernels import _build

    clock = PhaseClock()
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    emit("build", nvcc_seconds="cached" if info["seconds"] is None else info["seconds"],
         load_seconds=time.perf_counter() - t0, library=info["path"])
    clock("build")

    check_flash_identity_probe(torch, dev)
    kernels = [check_grs(torch, dev), check_flash(torch, dev), check_flash_f32(torch, dev),
               *check_pack(torch, dev), *check_fused_round(torch, dev),
               check_ssm_scan(torch, dev)]
    clock("kernel_checks")
    asd_launches, flash_fn, sched, dc, graph_runs = run_slice(torch, dev)
    clock("slice")
    check_reference(torch, dev)
    clock("reference")
    serve_launches, serve_runs = run_serve(torch, dev, flash_fn, sched, dc)
    clock("serve")
    by_run = {"asd": asd_launches, **serve_launches}
    branched_launches, branched_graph_runs = run_branched(torch, dev, flash_fn, sched, dc,
                                                          serve_runs)
    clock("branched")
    by_run.update(branched_launches)
    del serve_runs
    graph_runs.update(branched_graph_runs)
    by_run.update(run_sampler_graphs(torch, dev, flash_fn, sched, dc, graph_runs))
    clock("sampler_graphs")
    del graph_runs, branched_graph_runs
    by_run.update(run_serve_graphs(torch, dev, *_serve_graphs_model(torch, dev), sched))
    clock("serve_graphs")
    by_run.update(run_sharded_serve(torch, dev, flash_fn, sched, dc))
    clock("sharded_serve")
    check_serve_reference(torch, dev)
    clock("serve_reference")
    check_branched_reference(torch, dev)
    clock("branched_reference")
    window_device_ms = check_prng(torch, dev)
    clock("prng")
    cli_shapes = check_cli_kernels(torch, dev)
    clock("cli_kernels")
    by_run.update(run_serve_counter_memory(torch, dev, flash_fn, dc, window_device_ms))
    clock("serve_counter_memory")
    del flash_fn  # the denoiser's weights
    cli_launches, cli_summaries = run_serve_cli(torch, dev)
    by_run.update(cli_launches)
    clock("serve_cli")
    by_run.update(run_serve_cli(torch, dev, SERVE_CLI_BRANCHED_RUNS, "serve_cli_branched",
                                reference=cli_summaries["profile"])[0])
    clock("serve_cli_branched")
    by_run.update(run_sharded_serve_cli(torch, dev))
    clock("sharded_serve_cli")
    mp_launches, mp_rows = run_model_parallel(torch, dev)
    by_run.update(mp_launches)
    clock("model_parallel")
    check_serve_keys_reference(torch, dev)
    clock("serve_keys_reference")
    by_run.update(run_hymba(torch, dev))
    clock("hymba")
    hymba_f32_launches, designs_by_run = check_hymba_f32(torch, dev)
    by_run.update(hymba_f32_launches)
    clock("hymba_f32")
    check_hymba_reference(torch, dev)
    clock("hymba_reference")
    lm_rows = check_flash_lm_shapes(torch, dev)
    clock("flash_attention_lm")
    for name in LM_ARCHS:
        by_run.update(run_lm_arch(torch, dev, name))
        clock(f"lm_arch {name}")
    check_lm_archs_reference(torch, dev)
    clock("lm_reference")
    moe_launches, moe_rows = run_moe_denoiser(torch, dev)
    by_run.update(moe_launches)
    lm_rows += moe_rows + mp_rows
    clock("moe_denoiser")
    scan_backward, scan_train_fwd = check_ssm_scan_backward(torch, dev)
    clock("ssm_scan_backward")
    train_launches, scan_backward_launches = run_lm_train(torch, dev)
    by_run.update(train_launches)
    clock("lm_train")
    by_run.update(run_lm_train_moe(torch, dev))
    clock("lm_train_moe")
    run_lm_train_profile(torch, dev)
    clock("lm_train_profile")
    check_lm_train_reference(torch, dev)
    clock("lm_train_reference")
    dryrun_launches, dryrun_scan_backward = run_dryrun(torch, dev)
    by_run.update(dryrun_launches)
    clock("dryrun")
    dryrun_rows, dryrun_scans = check_dryrun_kernels(torch, dev)
    clock("dryrun_kernels")
    f32_standins = check_standin_kernels(torch, dev)
    clock("standin_kernels")
    run_train_full_width(torch, dev)
    clock("train_full_width")
    policy_params, policy_dc, policy_launches, policy_designs = run_standin_policy(torch, dev)
    by_run.update(policy_launches)
    designs_by_run.update(policy_designs)
    clock("standin_policy")
    pixel_launches, pixel_designs, pixel_params, pixel_dc = run_standin_pixel(torch, dev)
    by_run.update(pixel_launches)
    designs_by_run.update(pixel_designs)
    clock("standin_pixel")
    branched_launches, branched_designs = run_standin_branched(torch, dev, pixel_params,
                                                               pixel_dc)
    by_run.update(branched_launches)
    designs_by_run.update(branched_designs)
    clock("standin_branched")
    check_standin_reference(torch, dev, policy_params, policy_dc)
    clock("standin_reference")
    branched_rows = check_branched_kernels(torch, dev)
    clock("branched_kernels")
    for kern in kernels:
        per = {run: counts.get(kern["name"], 0) for run, counts in by_run.items()}
        if not any(per.values()):
            fail(f"kernels: {kern['name']} was launched in no main-path run")
        kern["launches"] = sum(per.values())
        kern["launches_by_run"] = per
        if kern["name"] in cli_shapes:
            kern["at_serve_cli_shape"] = cli_shapes[kern["name"]]
        if kern["name"] == "flash_attention_f32":
            # the tensor-core design on hymba_f32, the packed one on the stand-ins
            by_design = {d: sum(r[d] for r in designs_by_run.values())
                         for d in ("tensor_core", "packed")}
            if not all(by_design.values()):
                fail(f"kernels: flash_attention_f32 launches by design {by_design}")
            kern["launches_by_design"] = by_design
            kern["launches_by_design_by_run"] = designs_by_run
            kern["at_shapes"].update(f32_standins)
    for kern in branched_rows:
        # the launches of the runs at this row's shape (B2: the verification
        # call's share of a run's launches)
        per = {run: round(by_run[run].get(kern["name"], 0) * share)
               for run, share in kern.pop("runs").items()}
        if not all(per.values()):
            fail(f"kernels: {kern['name']} at {kern['at']} was launched in no run at its "
                 f"shape: {per}")
        kern["launches"] = sum(per.values())
        kern["launches_by_run"] = per
    for kern in lm_rows + dryrun_rows:
        per = {run: round(by_run[run][kern["name"]] * share)
               for run, share in kern.pop("runs").items()}
        if not all(per.values()):
            fail(f"kernels: {kern['name']} at {kern['at']} was launched in no run at its "
                 f"shape: {per}")
        kern["launches"] = sum(per.values())
        kern["launches_by_run"] = per
    # B7 at the training shape: its backward kernel once a layer a step in
    # the hymba training run, its forward the run's other launches (the
    # forward and the recompute)
    scan_backward["launches"] = scan_backward_launches
    scan_backward["launches_by_run"] = {"lm_train_hymba-1.5b": scan_backward_launches}
    fwd_launches = by_run["lm_train_hymba-1.5b"]["ssm_scan"] - scan_backward_launches
    scan_train_fwd["launches"] = fwd_launches
    scan_train_fwd["launches_by_run"] = {"lm_train_hymba-1.5b": fwd_launches}
    # B7 at the dry run's hymba train_4k chunk: its backward once a chunk a
    # layer, its forward the run's other launches (the forward and the
    # recompute)
    dryrun_train = "dryrun_hymba-1.5b_train_4k"
    for kern, n in zip(dryrun_scans, (by_run[dryrun_train]["ssm_scan"] - dryrun_scan_backward,
                                      dryrun_scan_backward)):
        kern["launches"] = n
        kern["launches_by_run"] = {dryrun_train: n}
    kernels += (branched_rows + lm_rows + [scan_train_fwd, scan_backward] + dryrun_rows
                + dryrun_scans)
    emit("phase_seconds", **clock.seconds, total=sum(clock.seconds.values()),
         note="wall seconds of each group of phases, in order, the build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
