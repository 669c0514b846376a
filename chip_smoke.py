#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py                       # all phases, one card
    python3 chip_smoke.py --out chip_smoke.json --profile

Phases, in order; any failure raises, so the exit code is not 0:

  (a) build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
               count the tensor-core instructions (HGMMA) in the SASS of
               the bf16 flash kernels (forward, dQ, dK/dV) when the
               toolkit has ``cuobjdump``; read each ``ef_factor_kernel``
               instance's registers, spills and shared memory from the
               ptxas log and hold them to ``lowrank.factor_plan``'s (no
               spills, the same resident blocks per SM); the same numbers
               for both ``gram_schmidt_kernel`` instances (no spills)
  (b) kernels  each PowerSGD kernel against its plain PyTorch version on
               the main path's shape groups, (j)'s per-stage groups, a
               ragged shape, and bf16,
               two calls bit-equal, with kernel (host-clock loop and device
               time), plain, library-call and bound times; for P and Q also
               TFLOP/s, GB/s and bound share per group and per step, the
               plan, and the time at each split count beside the plan's;
               for Gram-Schmidt the plan (cluster size, path, resident
               clusters), the time at each cluster size and path and per
               column,
               and more panels (ragged m, r = 1, the device-memory path);
               the pack/unpack kernels
               bit-exact against theirs at 4 and 8 bits (the tied wte
               payload, a ragged n, under 512 words)
  (c) main     ``Trainer.run`` for 4 steps on gpt2-2.5b at its published
               widths (depth cut to 8 layers, 2 per stage), policy fixed,
               rank 64, kernels on, bucketed, batch 8 x seq 1024, bf16
  (d) control  policy edgc, 12 steps, window 4, depth 4: the DAC window
               re-plan and the stacked-state resize, kernels on
  (f) wire     (c) again with ``wire="quant8"``: every sync payload coded
               through the pack kernels, losses held to (c)'s; then
               ``wire="entropy"`` on (d)'s run, bit width per window; then
               the pack kernels timed at 8 bits over one step's payloads
               of (c), beside the byte cast that computes the same words
  (e) check    a small fp32 model trained 3 steps on the card through the
               kernels agrees with the same run on the CPU (plain
               versions), raw and quant8
  (g) attention  the flash kernels through the kernel API
               (``flash_attention``, then ``flash_attention_train`` forward
               and backward under autograd) at the attention widths of
               gpt2-2.5b (20 heads of 96) and qwen2-0.5b (14 query heads,
               2 kv heads, of 64), bf16, causal, batch 8 x seq 1024; o, lse,
               dq, dk and dv against the plain versions; the same in fp32
               non-causal with Tq != Tk and at a ragged T = 1000 (bf16 runs
               the tensor-core kernels, fp32 the FMA ones: each counted by
               kernel); in bf16 at one key (Tk = 1) and one causal row (Tq
               = 1), where dq and dk vanish and are held against zero;
               then each kernel, its plain version and
               ``scaled_dot_product_attention`` timed at both widths, the
               bf16 kernels' TFLOP/s and share of their bounds (forward,
               dQ, dK/dV and the backward pair, beside SDPA's backward),
               and SDPA's forward under each backend that takes the inputs
  (h) histogram  ``hist_counts`` on the beta = 0.25 GDS sample of (c)'s
               gradient tree (about 113 M values), bit-equal to the plain
               version, and on a ragged, unaligned n and on outliers;
               ``ops.sampled_entropy_hist`` against the plain
               ``histogram_entropy``; the entropy probe on the card; the
               kernel timed against its bound
  (i) faults   the fault channel and telemetry: four steps queued in one
               ``run`` call at (c)'s widths with no recovery, with the
               per-step loss read alone, and with the guard; then (c)'s
               run for 9 steps with ``nan_grad@2,corrupt_payload@5``, the
               guard and ``fallback_after=2`` into a JSONL registry (event
               order, counters, finite weights, the fallback's bytes, the
               JSONL ledgers against the trainer's, the report), guarded
               and uncompressed step ms and peak memory beside (c)'s; a
               depth-2 run rolled back through a torn checkpoint (``_6``
               torn, restored from ``_3``), with seconds per save and
               restore and bytes per checkpoint; and (e)'s small model
               under ``nan_grad@1`` on the card against the CPU, raw (one
               skip) and quant8 (none, as the reference)
  (j) pipeline the pipelined executor with all S = 4 stage programs on the
               card (``LocalPipe``): (j1) (c)'s model and batch through
               ``Trainer(..., pipe=4)``, M = 4 microbatches of 2 x 1024,
               1F1B, replay, 4 steps, each loss held to (c)'s (the first
               within 2e-3, every one within 5e-2) and the bytes synced
               equal; step ms, peak memory per step and a profiled step's
               device-busy share; (j2) two steps each under (gpipe,
               replay), (1f1b, full) and (1f1b, every_k at k = 1, so
               its stash ring runs), held the same way, their peaks
               beside ``peak_activation_bytes``; (j3) edgc at depth 4
               (one layer per stage), window 4: a non-decreasing rank
               vector of S entries, per-stage bytes equal to 2 r (m + n)
               per compressed matrix worked out from the shapes and the
               stage ranks, the
               stage-stacked compressor state resized; (j4) (e)'s small
               model at S = 4 on the card against the CPU, raw and
               quant8; (j5) ``launch.train --pipe 2 --trace`` and
               ``launch.report --trace`` on the card, both traces holding
               one span per tick-table entry. One card runs the stages one
               after another: it shows the executor's work, not the
               pipeline's overlap or its bubble
  (k) overlap  the overlapped per-stage sync (``overlap_sync``, flat
               buckets split at ``K_CHUNK_BYTES``): (k1) (j1)'s run twice,
               each run's losses, final weights and compressor state equal
               to (j1)'s bit for bit, each stage's in-loop and residual
               chunk launches equal to ``plan_overlap``'s (in-loop counts
               [0, 1, 2, 3]), the PowerSGD launches equal to (j1)'s, step
               ms, peak memory and a profiled step's device-busy time
               beside (j1)'s, and the share of the side stream's kernel
               time that ran while the compute stream ran a kernel; (k2)
               (j3)'s edgc run with overlap: the DAC holds the planner's
               slack, the ``overlap_plan`` event is feasible at every
               stage, the applied ranks beside (j3)'s; (k3) ``launch.train
               --pipe 2 --overlap --chunk-bytes --trace`` on the card, its
               SYNC spans equal to the plan's in-loop launches and its
               sync-residual spans to the residual
  (l) families the MoE, dense and VLM families: (l1) ``Trainer.run`` for
               3 flat steps of qwen3-moe-235b-a22b at its published widths
               (depth cut to 1 of 94), policy fixed, rank 64, kernels on,
               bucketed, raw wire, batch 2 x 1024, bf16, remat: its four
               shape groups (388 matrices), 4 launches of each PowerSGD
               kernel a step, ``bytes_synced`` equal to 2 r (m + n) per
               compressed matrix and 2 B per other element, the loss and
               router aux per step, the seconds to initialise, the state by
               part and the peak; with ``--profile`` a fourth step's kernel
               launches, idle share and device time by part (sync kernels,
               experts, GShard dispatch and combine, router, attention,
               head and loss, AdamW, the rest), as (m1)-(m3); then each
               PowerSGD kernel against its plain version at the (256, 4096,
               1536) and (128, 1536, 4096) expert groups and at qwen3-32b's
               (4, 5120, 25600) and (2, 25600, 5120); (l2) two flat steps
               each of qwen2.5-3b (depth 4) and qwen3-32b (depth 2) at
               their published widths and llama3-405b's reduced config,
               batch 4 x 1024; (l3) the reduced MoE in fp32 on the card
               against the CPU, 3 steps, with the first step's top-k
               indices and dispatch masks compared and any routing flip
               counted; (l4) the same model at S = 2 on ``LocalPipe``,
               1F1B, M = 1 within 5e-3 of (l3)'s card run and M = 2 within
               the reference's 0.2 envelope; (l5) phi-3-vision-4.2b at its
               published widths (depth 8 of 32), batch 4 x (576 stub
               patches + 1024 tokens): the residual stream's dtype (fp32,
               as the reference's), losses, step ms and peak; then
               ``launch.train --arch phi-3-vision-4.2b --pipe 2`` on the
               reduced config
  (m) families the xLSTM, Zamba2 and Whisper families: (m1) 2 flat steps
               of xlstm-125m as published (12 layers, 2 stages' layout,
               bf16, remat), batch 8 x 1024, fixed rank 64, kernels on;
               (m2) zamba2-7b at its published widths, depth cut to 28 of
               81 (4 groups of 7, one per the config's 4 stages), batch 4
               x 1024, 3 steps; (m3) whisper-base as published, batch 8 x
               (1500 stub frames + 448 tokens), 3 steps: each with its
               shape groups,
               matrices and PowerSGD launches a step, ``bytes_synced``
               equal to 2 r (m + n) per compressed matrix and 2 B per other
               element, the seconds to initialise, the state by part, the
               peak, the loss and ms per step; with ``--profile`` a fourth
               step's kernel launches, idle share and device time by part
               (sync kernels, the recurrences, the sLSTM loop, attention,
               head and loss, AdamW, the rest; Mamba2's ops by the SSM's
               own layout, before attention's). (m2k) each PowerSGD kernel
               against its plain version at Zamba2's (28, 3584, 14576) and
               (28, 7168, 3584) groups, and Gram-Schmidt on 14576 x 64
               panels (the device slab; under the 4 MiB limit of
               ``ops``'s routing). (m4) the three reduced configs in fp32,
               card against CPU, 3 steps, within 5e-3; (m5) each family's
               stage adapter on ``LocalPipe`` at S = 2, M = 2, 1F1B (xlstm
               with two pairs, the ragged pp-zamba [2, 1], whisper-smoke
               encoder | decoder) within 5e-3 of its flat card run, then
               zamba2-7b at its published widths, depth 14 (2 groups),
               the first loss within 2e-3 of a flat run at that depth;
               (m6) ``launch.train --pipe 2`` on the reduced zamba2-7b and
               whisper-base, started with the phase and run beside it
  (n) elastic  the elastic (DiLoCo) outer loop: (n1) two pods of (c)'s
               model (published widths, depth 8, batch 8 x 1024 a pod,
               bf16, inner fixed rank 64, kernels on, bucketed) on the card
               through ``ElasticTrainer``, outer policy fixed at rank 32,
               quant8, K = 2, 4 rounds, ``pod_drop:1@r1,pod_join@r2``,
               recovery off (the donated step): pods [2, 1, 2, 2] and the
               membership events, finite losses, each round's coded and
               uncompressed bytes equal to a count from the leaf shapes and
               the rank, no parameter storage shared between pods or with
               the anchor; seconds per round and per resize, each outer
               round's ms and kernel launches, the outer sync alone (host
               and device ms), the peak beside its reckoning; (n2) each
               PowerSGD kernel against its plain version at (n1)'s
               pod-stacked groups; (n3) ``benchmarks/elastic_faults.py``'s
               bench-el fleet, the clean and four fault schedules, K = 5,
               4 rounds, 2 pods, on the card against the CPU: pod losses
               within 5e-3, 165132 / 657920 / 1706496 bytes a round, and the
               benchmark's checks; (n4) ``launch.train --outer-k 3 --pods 2
               --rounds 4`` with a drop and a join on the card, started
               with the phase and run beside (n1)-(n3), and
               ``launch.report``'s elastic line. (c) also runs one flat
               step twice from the same state and records whether the new
               states are bit-equal
  (o) serve    serving through ``serve.Engine`` (no port kernel runs: each
               wrapper's count is the same after the phase as before it;
               one host thread draws each configuration's weights on the
               CPU while the card decodes the ones before):
               (o1) gpt2-2.5b with all 52 layers, bf16, ``generate``
               greedily on batch 8, 128-token prompts, 128 new tokens, ms
               a token for the prompt replay and the generation (CUDA
               events after each ``decode_step``), tokens/s, the cache's
               bytes (818 MB) and the peak; the decode logits over the
               prompt within 2e-2 in norm of the port's teacher-forced
               forward, and no further from an fp32 forward of the same
               weights than 1.5 times the bf16 forward's own distance
               (largest element over the largest logit; the decode-
               against-forward distance by that measure is recorded);
               ``decode_benchmark`` at context 1008; one token profiled:
               launches, idle share, device ms by part (attention, MLP,
               head, the rest); (o2) qwen2.5-3b with all 36 layers,
               ``generate`` on batch 16, 256-token prompts, 64 new,
               ``decode_benchmark`` at 4096 and the ``long`` variant's at
               32768 (a ring of 8192 slots), one token profiled; (o3) one
               ``generate`` each of qwen3-moe-235b-a22b (depth 1),
               phi-3-vision-4.2b (32 layers), xlstm-125m and zamba2-7b
               (depth 28, with the reckoning for all 81 layers) at their
               published widths, and whisper-base's 64 greedy tokens from
               1500 stub frames; (o4) the 11 reduced configs in fp32 and
               two rings of 4 slots, card against CPU, logits within 5e-3
               and token flips counted; (o5) ``launch.serve`` at
               qwen2.5-3b's published widths and ``launch.serve_decode``
  (p) model axis  tensor parallelism on a ``(data, model)`` mesh of one
               card (NCCL, world size 1, set up and torn down in the phase;
               the DTensor placements and the model-group collectives run
               at model size 1): (p1) (c)'s run (gpt2-2.5b, depth 8, batch
               8 x 1024, rank 64, kernels on, bf16) with the per-leaf sync
               (``bucketed=False``) through ``Trainer(..., mesh=)``, 3
               steps against the same trainer without a mesh from the same
               state: losses within 5e-3, every state leaf within 2e-3 in
               norm (the largest differences recorded; bit-equal is
               expected), step ms of both, the host's ms to queue a step
               and to queue the loss's forward alone,
               the PowerSGD launches a step (4 a compressed leaf), the
               model-group collectives a step (``CommDebugMode``), the
               peak beside (c)'s, and, from one more step each under the
               allocator's history, the bytes live at each step's peak by
               the port's line that allocated them and the all-gathers'
               output bytes; (p2) ``make_train_step(mode="auto")``
               with FSDP and the ``none`` plan on the same mesh, 3 steps
               against the flat step with the ``none`` plan from the same
               state: losses within 5e-3, step ms and peak; (p3) the
               vocab-parallel embedding at gpt2-2.5b's vocab and width, its
               forward and the table's gradient against ``F.embedding``
               (bit-equality recorded, held within 1e-2 relative); (p4)
               ``torch.distributed.run --nproc_per_node 1 -m
               repro_torch.launch.train --arch gpt2 --variant reduced
               --model-mesh 1 --steps 3`` on the card, run beside (o5)'s
               launchers to share their wait
  (q) model axis, every family  on the same one-card mesh: (q1) the
               flat trainer (per-leaf sync, fixed r64, kernels on) at the
               published widths of phi-3-vision-4.2b (depth 4, batch 4 x
               1024), whisper-base (whole, 8 x 448), zamba2-7b (depth 7,
               4 x 1024) and xlstm-125m (depth 4, 8 x 1024, one step),
               each with and without the mesh from one draw: losses and state
               bit-equal, step and host ms both ways, the forward's host
               ms, PowerSGD launches a compressed leaf a step (4), one
               mesh step's model-group collectives (``CommDebugMode``;
               xlstm-125m's counted on a 1 x 256 batch) and the peaks;
               (q2) (j1)'s run on the mesh (LocalPipe, S = 4, M = 4):
               losses and bytes synced equal to (j1)'s and its state
               after the same 4 steps bit-equal, then (j1)'s profiled step
               and one more step's host ms; then
               whisper-base whole at S = 2 with and without the mesh
               (its two-tensor boundary), bit-equal; (q3) the launcher
               with ``--arch zamba2-7b --variant reduced --model-mesh 1``
               and ``--arch gpt2 --variant reduced --pipe 2 --model-mesh
               1`` in one process each, beside (o5)'s launchers
  (r) dry run  ``launch/dryrun.py`` (no kernel: each wrapper's count is
               the same after the phase as before it): (r1) (c)'s
               configuration (gpt2-2.5b, depth 8, batch 8 x 1024, fixed
               r64, bucketed, bf16, world 1, kernels off) through the dry
               run's train lowering on fake CUDA tensors, and one real
               step of it on the card under ``FlopCounterMode``: the FLOPs
               within 0.1%, the dry run's argument + temp bytes within
               ``R_MEMORY_TOL`` of the step's allocator peak, and the
               counted FLOPs over (c)'s median step as a share of 989
               TFLOP/s (a reading); (r2) the CLI on fake CUDA over fake
               worlds, in subprocesses beside (o5)'s launchers:
               qwen2.5-3b at train_4k, prefill_32k and decode_32k on the
               16 x 16 mesh, train_4k with ``--pipe 4``, and qwen2-0.5b
               at train_4k with ``--multi-pod --outer-k 2``, each exit 0
               with an OK line
  (s) audit    the collective-safety audit (``analysis``, ``launch/audit.py``):
               (s1) one more step of (c)'s trainer (its step config, the
               donated flat step, kernels on) with ``CollectiveSpy`` as
               the DP mean, under ``CollectiveLog`` with the CUDA sync
               debug mode: the spy's collectives equal the layout's (6
               factor calls at rank 64 for the three shape groups, one
               per flat bucket), every host sync by op and port line
               equals ``S_KNOWN_SYNCS``, every PowerSGD kernel launches;
               run right after (c), on its trainer; (s2) ``python -m
               repro_torch.launch.audit`` on the card, beside (o5)'s
               launchers: every built-in target, exit 0, ``0
               violation(s)``
  (t) pod axis the pod axis of the training mesh on one card (NCCL, world
               size 1): (t1) (c)'s run (gpt2-2.5b, depth 8, batch 8 x 1024,
               fixed r64, kernels on, bucketed, bf16) through ``Trainer``
               on ``make_host_mesh(pod=1, data=1)``, 3 steps, against the
               same trainer without a mesh from one draw of the weights:
               losses, bytes synced and every state leaf bit-equal; step
               ms, peaks and PowerSGD launches of both; (t2) the pipelined
               trainer (LocalPipe, S = 4, M = 4, 1F1B, replay) at depth
               ``T_PIPE_LAYERS`` on (pod 1, data 1, model 1) against (data
               1, model 1), the same; (t3) ``python -m
               repro_torch.launch.quickstart`` and ``python -m
               repro_torch.launch.train_gpt2_edgc`` on the card at the
               reference's step counts, started before (m) and run beside
               the phases (m) to (s): exit 0,
               finite losses, the quickstart's stage ranks out of the
               DAC's warm-up and DP-sync bytes saved > 0; train_gpt2_edgc's
               DAC stays in warm-up at its window, as the reference's does,
               so its edgc run equals the baseline (``_t_examples``). At
               world 1 no DP collective moves a byte: (t) checks the
               layout and the plumbing

The line before the card's line is ``{"kernels": [...]}``: one entry per
kernel, 10 in all. The PowerSGD and pack entries sum one main-path step's
work for that kernel (the three shape groups; the quant8 payloads; P and Q
add the step's rates, the plan's splits per group and the ptxas registers
and spills of their ``ef_factor_kernel`` instances; Gram-Schmidt its
cluster size and ms per column per group and its instances' ptxas
numbers), their
launches counted on the run that drives them: (c) for the PowerSGD
kernels, (f) quant8 for the pack kernels. The flash entries give one call
at gpt2-2.5b widths (one layer's attention) and ``hist_counts`` one pooled
sample; their launches are counted in (g) and (h), the drives of their
entry points (the training step does not call them: the model keeps its
plain-torch ``blockwise_attention``, as the reference's does). The
PowerSGD and pack entries add ``launches_pipelined``, their launches on
the pipelined paths of (j1) and (j4) quant8; the PowerSGD entries add
``launches_overlapped``, their launches on (k1)'s first run,
``launches_moe``, their launches on (l1)'s three steps,
``launches_families2``, their launches on (m1)-(m3)'s steps by
config, ``families``, their rows at (l)'s expert and qwen3-32b groups
and (m2k)'s Zamba2 groups, and ``elastic``, their rows at (n2)'s groups.
The PowerSGD and pack entries add ``launches_elastic``, their launches
on (n1)'s run (inner steps and outer syncs). Every entry adds
``launches_serve``, its launches in phase (o): zero, and ``launches_tp``,
its launches on (p1)'s mesh run (the PowerSGD kernels only); the
PowerSGD entries add ``launches_tp_families``, their launches on (q1)'s
four mesh runs, ``launches_tp_pipe``, on (q2)'s (j1) mesh run,
``launches_audit``, on (s1)'s audited step, and ``launches_pod`` and
``launches_pod_pipe``, on (t1)'s and (t2)'s pod-mesh runs. The last
line is ``{"ok":
true, "device": {...}}``. Without CUDA the script exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# (l1) runs within 6 GiB of the card's memory, where the caching allocator's
# fixed segments fragmented and a 6 GiB request failed; segments that grow
# in place do not fragment so (set before torch reaches the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
MAIN_GROUPS = [(32, 1920, 1920, 64), (8, 1920, 7680, 64), (8, 7680, 1920, 64)]
# (j)'s per-stage shape groups: depth 8 over S = 4 stages, 2 layers each
PIPE_GROUPS = [(8, 1920, 1920, 64), (2, 1920, 7680, 64), (2, 7680, 1920, 64)]
RAGGED = (3, 1000, 1030, 40)
# Gram-Schmidt panels (E, m, r) off the main path: ragged m (no cluster size
# divides it), r = 1, and the device-memory path (r = 128 at m = 7680, and
# the 4 MiB panel that ops routes to Gram-Schmidt)
GS_EXTRA = [(3, 1001, 24), (1, 1000, 24), (2, 1920, 1), (1, 7680, 128),
            (1, 16384, 64)]
REPLACES = {
    "lowrank_p": "src/repro/kernels/lowrank.py:188",
    "lowrank_q": "src/repro/kernels/lowrank.py:218",
    "decompress_residual": "src/repro/kernels/lowrank.py:247",
    "gram_schmidt": "src/repro/kernels/lowrank.py:288",
}
SOURCE = "src/repro_torch/kernels/csrc/lowrank.cu"
PACK_SOURCE = "src/repro_torch/kernels/csrc/pack.cu"
PACK_REPLACES = {"pack_words": "src/repro/kernels/pack.py:42",
                 "unpack_words": "src/repro/kernels/pack.py:61"}
# Pack correctness sizes: the tied wte member of gpt2-2.5b, a ragged n,
# under 512 words at either width, a few codes.
PACK_SIZES = [50257 * 1920, 512 * 8 + 3, 2047, 7]
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash.cu"
FLASH_FWD_SOURCE = "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu"
# the bf16 source of each flash kernel (fp32 inputs run FLASH_SOURCE)
BF16_SOURCE = {"flash_fwd": FLASH_FWD_SOURCE, "flash_dq": FLASH_BWD_SOURCE,
               "flash_dkv": FLASH_BWD_SOURCE}
HIST_SOURCE = "src/repro_torch/kernels/csrc/entropy_hist.cu"
NEW_REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_attention.py:75, "
                 "src/repro/kernels/flash_attention_bwd.py:153",
    "flash_dq": "src/repro/kernels/flash_attention_bwd.py:186",
    "flash_dkv": "src/repro/kernels/flash_attention_bwd.py:186",
    "hist_counts": "src/repro/kernels/entropy_hist.py:37",
}
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# (g) also checks in fp32 (B, Tq, Tk, H, Hkv, Dh, causal): the reference's
# cross-attention case (non-causal, Tq != Tk) and a ragged T at Dh 96.
ATTN_FP32 = [(2, 128, 384, 4, 1, 32, False), (2, 1000, 1000, 4, 2, 96, True)]
# ... and in bf16 at one key (Tk = 1) and at one causal row (Tq = 1): a row
# that sees one key has P = 1 and dS = 0, so dQ and dK vanish identically.
# They are held against zero with VANISH_ATOL (what is left is fp32
# rounding in dP - D, far below the unit-normal inputs' gradients of order
# 1); o, lse and dv keep the relative bar.
ATTN_VANISH = [(2, 300, 1, 4, 2, 64, False), (2, 1, 300, 4, 2, 96, True)]
VANISH_ATOL = 1e-3
# Kernel against plain version, as max|kernel - plain| / max|plain|. fp32
# products sum in another order than cuBLAS where the kernel splits the
# reduction (up to about 5e-6 relative at the main groups); bf16
# outputs of decompress round once (2**-8 relative), as do the flash
# kernels' bf16 outputs.
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "gram_schmidt": 1e-4}
# (h): sampled_entropy_hist against the plain histogram_entropy, in nats
# (the kernel bins by * (1 / width), the plain version by / width).
ENTROPY_TOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


def _import_port():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    src = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in src.parents:
        raise RuntimeError(f"repro_torch imported from {src}, not this checkout")


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` calls on the device's clock (CUDA
    events), after one warm-up. Where ``fn`` launches kernels faster than
    the host can issue them, this is the host's issue time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(calls, iters: int) -> float:
    """Device time of one pass over ``calls``: each call is timed on its
    own, with CUDA events around ``iters`` runs queued behind a device-side
    sleep of about 25 ms, so that the device runs them back to back. Unlike
    ``time_ms`` this leaves out the gaps in which the device waits for the
    host to launch, which dominate a run of small launches.

    The host's queueing time varies with the load on its cores (autograd
    calls cost milliseconds each), so a loop queued in more than half of
    its sleep is timed again behind a sleep four times its queueing time;
    a call that never fits (one that synchronises) raises."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    base_cycles = 50_000_000
    start.record()
    torch.cuda._sleep(base_cycles)
    end.record()
    torch.cuda.synchronize()
    ms_per_cycle = start.elapsed_time(end) / base_cycles
    total = 0.0
    for call in calls:
        call()
        torch.cuda.synchronize()
        cycles = base_cycles
        for _ in range(4):
            sleep_ms = cycles * ms_per_cycle
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                call()
            end.record()
            queued_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            if queued_ms < 0.5 * sleep_ms:
                break
            cycles = int(cycles * max(2.0, 4.0 * queued_ms / sleep_ms))
        else:
            raise AssertionError(f"queueing {iters} calls took {queued_ms:.1f} "
                                 f"ms, not well inside a {sleep_ms:.1f} ms sleep")
        total += start.elapsed_time(end) / iters
    return total


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


# ------------------------------------------------------------------ (a) build
def phase_build(report: dict) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    report["build"] = {"seconds": secs, "logs": logs,
                       "hgmma": count_hgmma(build)}
    log(f"(a) build: {secs:.2f} s ({', '.join(build.SOURCES)}) -> {build.BUILD_DIR}")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())
    report["build"]["factor_ptxas"] = check_factor_ptxas(build)
    report["build"]["gs_ptxas"] = check_gs_ptxas(build)


def check_factor_ptxas(build) -> dict:
    """Each ef_factor_kernel instance's registers, spills and shared memory
    from the ptxas log of lowrank.cu's library: no spills, the shared
    memory ``factor_smem`` states, and the resident blocks per SM that
    ``factor_plan`` reckons from ``FACTOR_REGS``."""
    from repro_torch.kernels import lowrank as lr
    found = lr.parse_factor_ptxas(build.build_log("lowrank"))
    if sorted(found) != sorted(lr.FACTOR_REGS):
        raise AssertionError(f"ef_factor_kernel instances in the ptxas log: "
                             f"{sorted(found)}, want {sorted(lr.FACTOR_REGS)}")
    out = {}
    for key, info in sorted(found.items()):
        dt, trans, vec = key
        name = f"{'q' if trans else 'p'}/{dt}/{'vector' if vec else 'scalar'}"
        smem = lr.factor_smem(lr.factor_k_tile(trans, vec))
        resident = lr.resident_blocks(info["registers"], info["smem"])
        stated = lr.resident_blocks(lr.FACTOR_REGS[key], smem)
        log(f"(a) ef_factor_kernel {name}: {info['registers']} registers "
            f"(plan states {lr.FACTOR_REGS[key]}), spill stores/loads "
            f"{info['spill_stores']}/{info['spill_loads']} B, {info['smem']} B "
            f"smem: {resident} blocks per SM (plan {stated})")
        if info["spill_stores"] or info["spill_loads"]:
            raise AssertionError(f"ef_factor_kernel {name} spills: {info}")
        if info["smem"] != smem or resident != stated:
            raise AssertionError(f"ef_factor_kernel {name}: {info} against the "
                                 f"plan's {lr.FACTOR_REGS[key]} registers, "
                                 f"{smem} B smem")
        out[name] = {**info, "resident_blocks": resident}
    return out


def check_gs_ptxas(build) -> dict:
    """Both gram_schmidt_kernel instances (shared-memory and device-memory
    slab) from the ptxas log of lowrank.cu's library: no spills."""
    from repro_torch.kernels import lowrank as lr
    found = lr.parse_gs_ptxas(build.build_log("lowrank"))
    if sorted(found) != ["device", "shared"]:
        raise AssertionError(f"gram_schmidt_kernel instances in the ptxas "
                             f"log: {sorted(found)}, want device and shared")
    for path, info in sorted(found.items()):
        log(f"(a) gram_schmidt_kernel {path}: {info['registers']} registers, "
            f"spill stores/loads {info['spill_stores']}/{info['spill_loads']} "
            f"B, {info['smem']} B static smem")
        if info["spill_stores"] or info["spill_loads"]:
            raise AssertionError(f"gram_schmidt_kernel {path} spills: {info}")
    return found


def count_hgmma(build) -> dict | None:
    """HGMMA (wgmma) instructions per kernel in the SASS of the bf16 flash
    kernels (the forward; dQ and dK/dV), read with ``cuobjdump -sass``;
    None without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).exists():
        log("(a) no cuobjdump: HGMMA count not taken")
        return None
    out = {}
    for source, kernels in (("flash_fwd_sm90", ("flash_fwd_sm90_kernel",)),
                            ("flash_bwd_sm90", ("flash_dq_sm90_kernel",
                                                "flash_dkv_sm90_kernel"))):
        sass = subprocess.run([tool, "-sass", str(build._target(source))],
                              capture_output=True, text=True, check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = 0
            elif "HGMMA" in line and name is not None:
                counts[name] += 1
        for fn, n in counts.items():
            log(f"(a) {source} SASS: {n} HGMMA in {fn}")
        # every instance of every kernel (mangled names hold the kernel's)
        for kern in kernels:
            found = {fn: n for fn, n in counts.items() if kern in fn}
            if not found or not all(found.values()):
                raise AssertionError(f"a bf16 {kern} instance has no HGMMA: "
                                     f"{counts}")
        out[source] = counts
    return out


# ---------------------------------------------------------------- (b) kernels
def _cases(e, m, n, r, dtype, dev):
    """The four kernels at one (E, m, n, r): kernel, plain and library calls,
    bytes and operations, and how to compare."""
    from repro_torch.kernels import lowrank as lr, ref
    gen = torch.Generator(device=dev).manual_seed(e * 7 + m + n + r)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    g = rand(e, m, n).to(dtype)
    err = (0.1 * rand(e, m, n)).to(dtype)
    q = rand(e, n, r)
    p_hat = torch.linalg.qr(rand(e, m, r))[0]
    isz = g.element_size()
    mn = e * m * n
    return {
        "lowrank_p": dict(
            kernel=lambda: lr.ef_lowrank_p(g, err, q),
            at_splits=lambda s: lr._launch_factor(lr.ef_lowrank_p, "repro_lowrank_p",
                                                  g, err, q, trans=False, splits=s),
            plan=lr.factor_plan(e, m, n, r, dtype, _sms(dev), trans=False,
                                ptrs=(g.data_ptr(), err.data_ptr(), q.data_ptr())),
            plain=lambda: ref.ef_lowrank_p(g, err, q),
            library=lambda: torch.bmm(g.float() + err.float(), q),
            nbytes=2 * mn * isz + 4 * e * (n * r + m * r),
            flops=mn + 2 * mn * r, tol=TOL["float32"]),
        "lowrank_q": dict(
            kernel=lambda: lr.ef_lowrank_q(g, err, p_hat),
            at_splits=lambda s: lr._launch_factor(lr.ef_lowrank_q, "repro_lowrank_q",
                                                  g, err, p_hat, trans=True, splits=s),
            plan=lr.factor_plan(e, m, n, r, dtype, _sms(dev), trans=True,
                                ptrs=(g.data_ptr(), err.data_ptr(),
                                      p_hat.data_ptr())),
            plain=lambda: ref.ef_lowrank_q(g, err, p_hat),
            library=lambda: torch.bmm((g.float() + err.float()).mT, p_hat),
            nbytes=2 * mn * isz + 4 * e * (m * r + n * r),
            flops=mn + 2 * mn * r, tol=TOL["float32"]),
        "decompress_residual": dict(
            kernel=lambda: lr.decompress_residual(p_hat, q, g, err),
            plain=lambda: tuple(t.to(dtype) for t in
                                ref.decompress_residual(p_hat, q, g, err)),
            library=lambda: _library_decompress(p_hat, q, g, err),
            nbytes=4 * mn * isz + 4 * e * (m * r + n * r),
            flops=2 * mn * r + 2 * mn,
            tol=TOL["float32"] if dtype == torch.float32 else TOL["bfloat16"]),
        "gram_schmidt": _gs_case(e, m, r, dev),
    }


def _gs_case(e, m, r, dev) -> dict:
    """Gram-Schmidt of an (E, m, r) panel stack, as ``_cases`` gives it."""
    from repro_torch.kernels import lowrank as lr
    gen = torch.Generator(device=dev).manual_seed(e * 7 + m + r)
    panel = torch.randn((e, m, r), generator=gen, device=dev)
    return dict(
        kernel=lambda: lr.gram_schmidt_panel(panel),
        at_cluster=lambda c, path: lr._launch_gs(panel, cluster=c, path=path),
        plan_at=lambda c, path: lr._gs_plan_for(panel, c, path),
        gs_plan=lr._gs_plan_for(panel),
        plain=lambda: lr.plain_gram_schmidt(panel),
        library=lambda: torch.linalg.qr(panel)[0],
        nbytes=2 * 4 * e * m * r,
        flops=e * (2 * m * r * (r - 1) + 3 * m * r), tol=TOL["gram_schmidt"])


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _library_decompress(p_hat, q, g, err):
    g_hat = torch.bmm(p_hat, q.mT)
    return g_hat.to(g.dtype), (g.float() + err.float() - g_hat).to(g.dtype)


def _check_orthonormal(u: torch.Tensor, plain: torch.Tensor) -> None:
    eye = torch.eye(u.shape[-1], device=u.device)
    gram = (u.mT @ u - eye).abs().max().item()
    span = ((u.mT @ plain).abs() - eye).abs().max().item()
    if gram > 2e-4 or span > 2e-3:
        raise AssertionError(f"gram_schmidt: |U^T U - I| = {gram:.2e} (2e-4), "
                             f"|U^T U_plain| - I = {span:.2e} (2e-3)")


def phase_kernels(report: dict, dev) -> None:
    rows = []
    shapes = [(s, torch.float32, True) for s in MAIN_GROUPS]
    shapes += [(s, torch.float32, False) for s in PIPE_GROUPS]
    shapes += [(RAGGED, torch.float32, False), (RAGGED, torch.bfloat16, False)]
    jobs = [(s, dtype, main, lambda s=s, dtype=dtype: _cases(*s, dtype, dev))
            for s, dtype, main in shapes]
    # Gram-Schmidt alone on panels off the main path (n plays no part)
    jobs += [((e, m, 0, r), torch.float32, False,
              lambda e=e, m=m, r=r: {"gram_schmidt": _gs_case(e, m, r, dev)})
             for e, m, r in GS_EXTRA]
    for shape, dtype, main, make in jobs:
        cases = make()
        for name, c in cases.items():
            rows.append(check_kernel(name, c, shape, dtype, main))
            rows[-1]["pipe_path"] = shape in PIPE_GROUPS
        del cases
        torch.cuda.empty_cache()
    report["kernel_rows"] = rows
    pipe = [r for r in rows if r["pipe_path"]]
    log(f"(b) (j)'s per-stage groups {PIPE_GROUPS}: {len(pipe)} kernel calls "
        f"held to their plain versions, worst "
        f"{max(r['rel_err'] / r['tol'] for r in pipe):.3f} of the bar")
    for name in ("lowrank_p", "lowrank_q", "gram_schmidt"):
        main = [r for r in rows if r["kernel"] == name and r["main_path"]]
        step = {key: sum(r[key] for r in main)
                for key in ("ms", "device_ms", "library_ms", "bound_ms", "flop",
                            "nbytes")}
        log(f"(b) {name} per step (3 groups): kernel {step['ms']:.4f} ms "
            f"(device {step['device_ms']:.4f}), library {step['library_ms']:.4f} "
            f"({step['library_ms'] / step['ms']:.2f}x the kernel), bound "
            f"{step['bound_ms']:.4f}; {_rates(step)}")
    report["pack_checks"] = check_pack(dev)


def check_kernel(name: str, c: dict, shape: tuple, dtype, main: bool) -> dict:
    """One kernel at one shape: against its plain version (and, for
    Gram-Schmidt, orthonormal), two calls bit-equal, then timed."""
    e, m, n, r = shape
    got, want = c["kernel"](), c["plain"]()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    abs_err, rel = max((rel_err(a, b) for a, b in pairs), key=lambda t: t[1])
    if name == "gram_schmidt":
        _check_orthonormal(got, want)
    if not rel <= c["tol"]:
        raise AssertionError(f"{name} {shape} {dtype}: error {rel:.3e} "
                             f"relative > {c['tol']:.0e}")
    again = c["kernel"]()
    same = all(torch.equal(a, b) for a, b in
               zip(*(t if isinstance(t, tuple) else (t,) for t in (got, again))))
    if not same:
        raise AssertionError(f"{name} {shape} {dtype}: two calls differ")
    del got, want, again
    slow = name == "gram_schmidt"
    row = dict(kernel=name, shape=list(shape), dtype=str(dtype)[6:],
               main_path=main, max_abs_err=abs_err, rel_err=rel, tol=c["tol"],
               ms=time_ms(c["kernel"], 20),
               device_ms=device_ms([c["kernel"]], 20),
               plain_ms=time_ms(c["plain"], 3 if slow else 10),
               library_ms=time_ms(c["library"], 3 if slow else 10))
    row["bound_ms"], row["bound_by"] = bound_ms(c["nbytes"], c["flops"])
    row.update(flop=c["flops"], nbytes=c["nbytes"], bit_equal=same)
    log(f"(b) {name:20s} E,m,n,r={e},{m},{n},{r} {row['dtype']:8s} "
        f"err {abs_err:.2e} abs {rel:.2e} rel (tol {c['tol']:.0e}), "
        f"two calls bit-equal | kernel {row['ms']:.4f} ms (device "
        f"{row['device_ms']:.4f}) plain {row['plain_ms']:.4f} "
        f"library {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']})")
    if "plan" in c:
        row["plan"] = dataclasses.asdict(c["plan"])
        log(f"(b)   {name} {_rates(row)}; plan {row['plan']}")
        if main:
            row["splits_ms"] = sweep_splits(name, c)
    if "gs_plan" in c:
        plan = c["gs_plan"]
        row["plan"] = dataclasses.asdict(plan)
        row["ms_per_column"] = row["device_ms"] / r
        log(f"(b)   gram_schmidt plan: cluster {plan.cluster} x {plan.rows} "
            f"rows (column stride {plan.ld}), {plan.path} slab, {plan.smem} B "
            f"smem, {plan.blocks} blocks, {plan.active} clusters resident "
            f"(cudaOccupancyMaxActiveClusters), {plan.waves} wave(s); "
            f"{1e3 * row['ms_per_column']:.3f} us per column")
        if main:
            row["clusters_ms"] = sweep_clusters(c)
    return row


def _rates(row: dict) -> str:
    """TFLOP/s, GB/s and bound share of a timed row (or a step's sum)."""
    return (f"{row['flop'] / row['ms'] * 1e-9:.1f} TFLOP/s, "
            f"{row['nbytes'] / row['ms'] * 1e-6:.0f} GB/s, "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound")


SWEEP_SPLITS = (1, 2, 3, 4, 6, 8)


def sweep_splits(name: str, case: dict) -> dict:
    """The P or Q kernel timed at each split count of ``SWEEP_SPLITS`` and
    the plan's, on the same inputs: what the plan's choice costs against
    the others."""
    chosen = case["plan"].splits
    out = {}
    for s in sorted(set(SWEEP_SPLITS) | {chosen}):
        out[s] = time_ms(lambda: case["at_splits"](s), 20)
    best = min(out, key=out.get)
    log(f"(b)   {name} by splits: " + ", ".join(
        f"{s}: {ms:.4f}{' (plan)' if s == chosen else ''}"
        for s, ms in out.items()) + f" ms; fastest {best}")
    return out


def sweep_clusters(case: dict) -> dict:
    """Gram-Schmidt's device time at each cluster size and path, forced, on
    the same inputs (the shared-memory slab where it fits, and the
    device-memory one): what the plan's choice costs against the others."""
    from repro_torch.kernels import lowrank as lr
    plan = case["gs_plan"]
    out = {}
    for c in lr.GS_CLUSTERS:
        for path in ("shared", "device"):
            try:
                at = case["plan_at"](c, path)
            except ValueError:      # the slab does not fit shared memory
                continue
            out[f"{c}/{path}"] = {
                "active": at.active, "waves": at.waves,
                "ms": device_ms([lambda: case["at_cluster"](c, path)], 10)}
    chosen = f"{plan.cluster}/{plan.path}"
    best = min(out, key=lambda k: out[k]["ms"])
    log("(b)   gram_schmidt by cluster/path (resident clusters, waves): " +
        ", ".join(f"{k} ({v['active']}, {v['waves']}): {v['ms']:.4f}"
                  f"{' (plan)' if k == chosen else ''}" for k, v in out.items())
        + f" ms; fastest {best}")
    return out


def check_pack(dev) -> list[dict]:
    """pack_words / unpack_words bit-exact against their plain versions on
    random codes over the full range [0, 2**bits), top code included."""
    from repro_torch.kernels import pack, ref
    out = []
    for bits in (4, 8):
        for n in PACK_SIZES:
            gen = torch.Generator(device=dev).manual_seed(n + bits)
            codes = torch.randint(0, 1 << bits, (n,), generator=gen,
                                  device=dev, dtype=torch.int32)
            codes[0] = (1 << bits) - 1
            words = pack.pack_words(codes, bits)
            back = pack.unpack_words(words, bits, n)
            plain_words = ref.pack_bits(codes, bits)
            plain_back = ref.unpack_bits(words, bits, n)
            torch.cuda.synchronize()
            as_u32 = lambda w: w.view(torch.int32).long() & 0xFFFFFFFF
            pack_err = (as_u32(words) - as_u32(plain_words)).abs().max().item()
            unpack_err = (back - plain_back).abs().max().item()
            ok = pack_err == 0 and unpack_err == 0 and torch.equal(back, codes)
            log(f"(b) pack/unpack bits {bits} n {n} ({words.numel()} words): "
                f"{'bit-exact' if ok else 'MISMATCH'} against the plain versions"
                f" (max abs err {pack_err}, {unpack_err})")
            if not ok:
                raise AssertionError(f"pack/unpack bits={bits} n={n} differ "
                                     "from their plain versions")
            out.append({"bits": bits, "n": n, "words": words.numel(),
                        "pack_words": pack_err, "unpack_words": unpack_err})
            del codes, words, back, plain_words, plain_back
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ trainers
def _trainer(model_cfg, policy, rank, steps, window, dev, wire="raw",
             log_every=1, pipe=None, mesh=None, params=None, **tkw):
    """A Trainer with the PowerSGD kernels on, AdamW at lr 1e-3; ``tkw``
    goes to ``TrainerConfig`` (faults, recovery, metrics, checkpoints, the
    pipeline's schedule and stash policy); ``pipe`` runs that many stages
    through the pipelined executor, ``mesh`` on a process mesh; ``params``
    (drawn on the card) start it in place of a fresh draw, copied."""
    from repro_torch.core import EDGCConfig, GDSConfig
    from repro_torch.core.dac import DACConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    edgc = EDGCConfig(policy=policy, fixed_rank=rank, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=window, adjust_limit=4),
                      num_stages=model_cfg.num_stages, use_kernels=True,
                      wire=wire)
    tcfg = TrainerConfig(total_steps=steps, log_every=log_every,
                         use_kernels=True, wire=wire,
                         adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps), **tkw)
    model = build_model(model_cfg)
    if params is not None:
        from repro_torch import tree
        model = model._replace(init=lambda seed, device: tree.tree_map(
            lambda t: t.clone(), params))
    return Trainer(model, edgc, tcfg, seed=0, device=dev, pipe=pipe,
                   mesh=mesh)


def _timed_steps(trainer, batches, steps: int) -> list[float]:
    """Host ms of each step, each ending in a device synchronise."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(batches, num_steps=1)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_check(report: dict, dev) -> None:
    """Small fp32 model: the kernel path on the card against the CPU, with
    the raw wire and with quant8 (the pack kernels against their plain
    versions inside a training run)."""
    from repro_torch.configs.gpt2 import GPT2_FIDELITY
    from repro_torch.data.pipeline import SyntheticLM
    report["check"] = {}
    for wire in ("raw", "quant8"):
        losses = {}
        for where in ("cpu", dev):
            tr = _trainer(GPT2_FIDELITY, "fixed", 8, 3, 50, where, wire=wire)
            hist = tr.run(SyntheticLM(GPT2_FIDELITY.vocab_size, 64, 4,
                                      seed=1).batches())
            losses[str(where)] = [h["loss"] for h in hist]
        cpu, gpu = losses["cpu"], losses[str(dev)]
        gap = max(abs(a - b) for a, b in zip(cpu, gpu))
        report["check"][wire] = {"cpu_loss": cpu, "gpu_loss": gpu,
                                 "max_gap": gap}
        log(f"(e) check gpt2-fidelity fp32 wire={wire}, 3 steps: card {gpu} "
            f"cpu {cpu} max gap {gap:.2e} (tol 5e-3)")
        if not gap < 5e-3 or not all(math.isfinite(x) for x in gpu):
            raise AssertionError(f"wire={wire}: the card's kernel path "
                                 "disagrees with the CPU")


def phase_main(report: dict, dev, profile: bool) -> dict:
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    tr = _trainer(cfg, "fixed", 64, 5, 50, dev)    # step 5: --profile
    groups = [(g.stack_size, g.m, g.n, g.rank) for g in tr._layout.groups]
    log(f"(c) main: {cfg.name} depth {cfg.num_layers} d_model {cfg.d_model} "
        f"heads {cfg.num_heads} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"{cfg.dtype} remat={cfg.remat}: {tr.n_params / 1e9:.3f} B params; "
        f"shape groups (E,m,n,r) {groups}")
    if sorted(groups) != sorted(MAIN_GROUPS):
        raise AssertionError(f"main-path groups {groups} != {MAIN_GROUPS}")
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in lr.KERNELS:
        k.launches = 0
    step_ms = _timed_steps(tr, batches, 4)
    launches = {k.__name__: k.launches for k in lr.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in tr.history]
    report["main"] = {"loss": losses, "step_ms": step_ms, "peak_bytes": peak,
                      "bytes_synced": [h["bytes_synced"] for h in tr.history],
                      "launches": launches, "groups": groups,
                      "n_params": tr.n_params, "payloads": _payloads(tr)}
    for h, ms in zip(tr.history, step_ms):
        log(f"    step {h['step']} loss {h['loss']:.4f} {ms:.1f} ms "
            f"bytes synced {h['bytes_synced']}")
    log(f"    peak memory {peak / 2**30:.2f} GiB; launches {launches}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != 4:
        raise AssertionError(f"main-path losses {losses}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    report["main"]["two_call"] = _two_call_check(tr, next(batches))
    # (s1) audits one more step of this trainer, while its state is here
    report["audit"] = {"s1": phase_audit_step(tr, batches, dev)}
    if profile:
        report["profile"] = profile_step(tr, batches, sorted(step_ms[1:])[1])
    return launches, pooled_grad_sample(tr, batches)


def _two_call_check(tr, batch) -> dict:
    """One flat step run twice from the same state on the same batch (the
    step updates its state in place, so each call gets its own copy):
    whether the new states are bit-equal, and the leaves that are not.
    Recorded, not held: it shows whether the embedding's backward (and
    every other kernel of the step) is deterministic on the card."""
    from repro_torch import tree
    copy = lambda t: tree.tree_map(lambda a: a.clone(), t)
    step = tr._get_step(False)
    start = copy(tr.state)
    device_batch = tr._device_batch(batch)
    outs = []
    for _ in range(2):
        state, _ = step(copy(start), device_batch)
        outs.append(state)
    diff = [path for (path, a), b in zip(tree.flatten_with_path(outs[0]),
                                         tree.leaves(outs[1]))
            if not torch.equal(a, b)]
    out = {"bit_equal": not diff, "leaves": len(tree.leaves(outs[0])),
           "differing": diff[:20]}
    log(f"(c) one flat step twice from the same state: "
        f"{'bit-equal' if not diff else f'{len(diff)} leaves differ'} over "
        f"{out['leaves']} state leaves{'' if not diff else f' {diff[:6]}'}")
    del start, outs, state
    _release()
    return out


def pooled_grad_sample(trainer, batches, beta: float = 0.25) -> torch.Tensor:
    """The GDS sample of the main path's gradient tree: one more batch's
    gradients at the trained weights, the strided beta-sample of every leaf
    (as ``core.entropy`` takes it), pooled in fp32. It waits in host memory
    for (h), so that (d), (f) and (e) run with the device memory they had."""
    from repro_torch import tree
    from repro_torch.core.entropy import strided_sample
    params = tree.tree_map(lambda t: t.detach().requires_grad_(True),
                           trainer.state["params"])
    batch = trainer._device_batch(next(batches))
    with torch.enable_grad():
        loss, _ = trainer.model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
    sample = torch.cat([strided_sample(g, beta).float() for g in grads
                        if g.numel() > 16]).cpu()
    del params, grads
    torch.cuda.empty_cache()
    return sample


def _payloads(trainer) -> list[int]:
    """Elements of each coded payload of one step: the P and Q factors of
    every shape group, then every flat-bucket member."""
    out = []
    for g in trainer._layout.groups:
        out += [g.stack_size * g.m * g.rank, g.stack_size * g.n * g.rank]
    for b in trainer._layout.buckets:
        out += [math.prod(shape) for _, shape in b.members]
    return out


def profile_step(trainer, batches, step_ms: float, top: int = 25,
                 streams: bool = False) -> dict:
    """One more main-path step under torch.profiler, with the program's
    spans recorded: device time by kernel; the device's busy time (the
    union of kernel intervals over every stream, ``bench.trace``) and its
    idle share of an unprofiled step of ``step_ms`` (the profiler's own
    host cost stretches the profiled step); busy and idle time by the span
    that launched or waited (``bench.spans``); with ``streams``, kernel
    time by CUDA stream and the part of the side streams' time that ran
    beside a compute-stream kernel (``bench.trace.side_overlap``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bench import spans as bench_spans
    from bench import trace as bench_trace
    from repro_torch.obs.trace import record_spans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_spans() as spans:
            trainer.run(batches, num_steps=1)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            obj = json.load(f)
    events = obj["traceEvents"]
    cap = bench_trace.from_events(events, None, 1)
    if not cap.kernels:
        raise AssertionError("the profiler's trace holds no kernel")
    busy_ms = bench_trace.busy_us(cap) / 1e3
    att = bench_spans.attribute(events, spans, int(obj.get("baseTimeNanoseconds", 0)), 1)
    log(f"    profiled step: {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms; "
        f"idle share of a {step_ms:.1f} ms unprofiled step "
        f"{1 - busy_ms / step_ms:.3f}")
    for key, ms, count in rows[:top]:
        log(f"      {ms:9.3f} ms {count:6d}x  {key[:90]}")
    by_span = att.by_span()
    log("    by span (busy ms, idle ms): " + ", ".join(
        f"{n} {1e3 * b:.2f}/{1e3 * i:.2f}" for n, b, i in by_span))
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "step_ms": step_ms,
           "by_kernel": [{"name": k, "ms": ms, "count": c} for k, ms, c in rows],
           "by_span": by_span}
    if streams:
        by = bench_trace.stream_time(cap.kernels)
        side, over = bench_trace.side_overlap(cap.kernels) or (0.0, 0.0)
        st = out["streams"] = {
            "by_stream_ms": {k: v / 1e3 for k, v in by.items()},
            "compute_stream": max(by, key=by.get),
            "side_ms": side / 1e3, "side_overlapped_ms": over / 1e3}
        log(f"    by stream: kernel ms {st['by_stream_ms']}; "
            f"kernels off the compute stream {st['side_ms']:.3f} ms, "
            f"{st['side_overlapped_ms']:.3f} ms of it while a compute-stream "
            f"kernel ran")
    return out


def phase_control(report: dict, dev) -> None:
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=4)
    tr = _trainer(cfg, "edgc", 64, 12, 4, dev)
    t0 = time.perf_counter()
    hist = tr.run(SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = [h["ranks"] for h in hist]
    report["control"] = {"ranks": ranks, "loss": [h["loss"] for h in hist],
                         "seconds": secs, "comm_savings": tr.comm_savings(),
                         "plan": tr.controller.describe()}
    log(f"(d) control: edgc 12 steps window 4 depth 4 in {secs:.1f} s; ranks "
        f"{ranks}; comm savings {tr.comm_savings():.4f}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("control-plane run gave a non-finite loss")
    if not ranks[-1]:
        raise AssertionError("the DAC never left warm-up in 12 steps")


def phase_wire(report: dict, dev, profile: bool) -> dict:
    """(c) with every payload coded (quant8), then entropy mode on (d)."""
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr, pack
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    tr = _trainer(cfg, "fixed", 64, 5, 50, dev, wire="quant8")
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in lr.KERNELS + pack.KERNELS:
        k.launches = 0
    step_ms = _timed_steps(tr, batches, 4)
    launches = {k.__name__: k.launches for k in lr.KERNELS + pack.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    raw = report["main"]["loss"]
    losses = [h["loss"] for h in tr.history]
    gaps = [abs(a - b) / max(1.0, b) for a, b in zip(losses, raw)]
    out = {"loss": losses, "raw_loss": raw, "rel_gap": gaps,
           "step_ms": step_ms, "peak_bytes": peak, "launches": launches,
           "bytes_synced": tr.bytes_synced, "bytes_wire_raw": tr.bytes_wire_raw,
           "codec": [tr._codec.bits, tr._codec.group]}
    log(f"(f) wire quant8: {cfg.name} depth {cfg.num_layers}, fixed r64, "
        f"batch 8 x 1024, kernels on")
    for h, ms, g in zip(tr.history, step_ms, gaps):
        log(f"    step {h['step']} loss {h['loss']:.4f} (raw {raw[h['step']]:.4f},"
            f" gap {g:.2e} of max(1, loss)) {ms:.1f} ms bytes synced "
            f"{h['bytes_synced']} raw payload {h['bytes_wire_raw']}")
    log(f"    peak memory {peak / 2**30:.2f} GiB; bytes_synced/bytes_wire_raw "
        f"{tr.bytes_synced}/{tr.bytes_wire_raw} = "
        f"{tr.bytes_synced / tr.bytes_wire_raw:.4f}; launches {launches}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != 4:
        raise AssertionError(f"quant8 losses {losses}")
    if not max(gaps) <= 0.05:
        raise AssertionError(f"quant8 strays from the raw run: {gaps}")
    if not all(launches[k.__name__] > 0 for k in pack.KERNELS):
        raise AssertionError(f"a pack kernel never launched: {launches}")
    if profile:
        out["profile"] = profile_step(tr, batches, sorted(step_ms[1:])[1])
    del tr
    torch.cuda.empty_cache()

    small = dataclasses.replace(GPT2_2_5B, num_layers=4)
    tr = _trainer(small, "edgc", 64, 12, 4, dev, wire="entropy")
    batches = SyntheticLM(small.vocab_size, 1024, 8, seed=0).batches()
    windows = []
    for _ in range(3):
        tr.run(batches, num_steps=4)
        windows.append(tr._codec.bits)
    torch.cuda.synchronize()
    hist = tr.history
    out["entropy"] = {"bits_per_window": windows,
                      "entropy": [h["entropy"] for h in hist],
                      "loss": [h["loss"] for h in hist],
                      "ranks": [h["ranks"] for h in hist],
                      "bytes_synced": tr.bytes_synced,
                      "bytes_wire_raw": tr.bytes_wire_raw}
    log(f"(f) wire entropy: edgc 12 steps window 4 depth 4; bit width after "
        f"each window {windows}; entropy "
        f"{[round(h['entropy'], 4) for h in hist]}; coded/raw "
        f"{tr.bytes_synced}/{tr.bytes_wire_raw}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("entropy-mode run gave a non-finite loss")
    del tr
    torch.cuda.empty_cache()
    out["timing"] = time_pack(report["main"]["payloads"], dev)
    report["wire"] = out
    return {k.__name__: launches[k.__name__] for k in pack.KERNELS}


def _byte_cast_pack(codes: torch.Tensor) -> torch.Tensor:
    """8-bit packing as one PyTorch call: each code in [0, 256) becomes a
    byte and four bytes one little-endian word (n % 4 == 0)."""
    return codes.to(torch.uint8).view(torch.uint32)


def _byte_cast_unpack(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.uint8).to(torch.int32)


def time_pack(payloads: list[int], dev) -> dict:
    """Kernel, plain and library times of pack/unpack at 8 bits over one
    main-path step's payloads (each coded on its own), as device time.

    The library call is the byte cast, which computes the same words at 8
    bits (``_byte_cast_pack``); it is held bit-exact against the kernel
    here and used nowhere in the port.
    """
    from repro_torch.kernels import pack, ref
    bits = 8
    if any(n % 4 for n in payloads):
        raise AssertionError("the byte cast needs n % 4 == 0 on every payload")
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = [torch.randint(0, 1 << bits, (n,), generator=gen, device=dev,
                           dtype=torch.int32) for n in payloads]
    words = [pack.pack_words(c, bits) for c in codes]
    for c, w in zip(codes, words):
        if not (torch.equal(_byte_cast_pack(c).view(torch.int32),
                            w.view(torch.int32))
                and torch.equal(_byte_cast_unpack(w), c)):
            raise AssertionError("the byte cast differs from the pack kernels")
    pairs = list(zip(codes, words))
    calls = {
        "pack_words": (
            [lambda c=c: pack.pack_words(c, bits) for c in codes],
            [lambda c=c: ref.pack_bits(c, bits) for c in codes],
            [lambda c=c: _byte_cast_pack(c) for c in codes]),
        "unpack_words": (
            [lambda c=c, w=w: pack.unpack_words(w, bits, c.numel())
             for c, w in pairs],
            [lambda c=c, w=w: ref.unpack_bits(w, bits, c.numel())
             for c, w in pairs],
            [lambda w=w: _byte_cast_unpack(w) for w in words]),
    }
    nbytes = sum(4 * c.numel() + 4 * w.numel() for c, w in pairs)
    bound, bound_by = bound_ms(nbytes, 0)
    log(f"(f) pack timing over one main-path step's payloads, bits {bits}:")
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        rows[name] = r = dict(
            ms=device_ms(kernel, 10), plain_ms=device_ms(plain, 3),
            library_ms=device_ms(library, 10), bound_ms=bound,
            bound_by=bound_by, nbytes=nbytes, payloads=len(codes),
            codes=sum(c.numel() for c in codes))
        log(f"    {name:12s} {len(codes)} payloads, {r['codes']} codes | "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} byte cast "
            f"{r['library_ms']:.4f} bound {bound:.4f} ms ({bound_by}), "
            "device time")
    del codes, words, pairs, calls
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------- (g) attention
def _pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def _attn_work(B, Tq, Tk, H, Hkv, Dh, causal, dtype) -> dict:
    """Least bytes and operations of the flash kernels at one shape: each
    input read once, each output written once, products counted over the
    (query, key) pairs the mask keeps (4 Dh FLOP per pair per product pair:
    the forward's QK^T and PV; dQ's QK^T, dO V^T and dS K; dK/dV's QK^T,
    dO V^T, P^T dO and dS^T Q)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    pairs = B * H * _pairs(Tq, Tk, causal)
    q_el, kv_el, rows = B * Tq * H * Dh, B * Tk * Hkv * Dh, B * H * Tq
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return {
        "flash_fwd": bound_ms(isz * (2 * q_el + 2 * kv_el), 4 * Dh * pairs, peak),
        "flash_dq": bound_ms(isz * (3 * q_el + 2 * kv_el) + 8 * rows,
                             6 * Dh * pairs, peak),
        "flash_dkv": bound_ms(isz * (2 * q_el + 4 * kv_el) + 8 * rows,
                              8 * Dh * pairs, peak),
        "backward_pair": bound_ms(isz * (3 * q_el + 4 * kv_el) + 8 * rows,
                                  10 * Dh * pairs, peak),
    }


def _attn_inputs(shape, dtype, dev):
    B, Tq, Tk, H, Hkv, Dh = shape
    gen = torch.Generator(device=dev).manual_seed(B * 7 + Tq + Tk + H + Dh)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    return (rand(B, Tq, H, Dh), rand(B, Tk, Hkv, Dh), rand(B, Tk, Hkv, Dh),
            rand(B, Tq, H, Dh))


def _drive_attention(q, k, v, do, causal):
    """The kernel API as a user calls it: flash_attention, then
    flash_attention_train forward and backward under autograd."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_train
    o_inf = flash_attention(q, k, v, causal=causal)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention_train(*leaves, causal)
    o.backward(do)
    return o_inf, o.detach(), [t.grad for t in leaves]


def check_attention(name, shape, causal, dtype, dev, vanish=()) -> dict:
    """Forward, LSE, dQ, dK and dV through the kernel API against the plain
    versions on the same inputs, as max|kernel - plain| / max|plain|; the
    outputs named in ``vanish`` instead as max|kernel| and max|plain|
    against ``VANISH_ATOL``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention_bwd import _fwd_with_stats
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    kernels = fa.KERNELS + fb.KERNELS
    q, k, v, do = _attn_inputs(shape, dtype, dev)
    for w in kernels:
        w.launches = 0
        w.launches_by_kernel.update(dict.fromkeys(w.launches_by_kernel, 0))
    o_inf, o, grads = _drive_attention(q, k, v, do, causal)
    launches = {w.__name__: w.launches for w in kernels}
    by_kernel = {n: c for w in kernels for n, c in w.launches_by_kernel.items()}
    # each dtype has one kernel per function: bf16 the tensor-core kernels,
    # fp32 flash.cu's FMA kernels
    suffix = "_sm90" if dtype == torch.bfloat16 else "_fma"
    for w in kernels:
        want = w.__name__ + suffix
        if w.launches_by_kernel[want] != launches[w.__name__]:
            raise AssertionError(f"{dtype} {w.__name__} launches "
                                 f"{w.launches_by_kernel}: all "
                                 f"{launches[w.__name__]} should be {want}")
    _, lse = _fwd_with_stats(q, k, v, causal=causal)
    p_o, p_lse = ref.flash_fwd(q, k, v, causal)
    plain = {"attention": ref.flash_reference(q, k, v, causal), "o": p_o,
             "lse": p_lse}
    plain.update(zip(("dq", "dk", "dv"), ref.flash_bwd(q, k, v, o, lse, do,
                                                       causal)))
    got = {"attention": o_inf, "o": o, "lse": lse, "dq": grads[0],
           "dk": grads[1], "dv": grads[2]}
    torch.cuda.synchronize()
    tol = TOL[str(dtype)[6:]]
    errs = {key: rel_err(got[key], plain[key]) for key in got
            if key not in vanish}
    zero = {key: (got[key].float().abs().max().item(),
                  plain[key].float().abs().max().item()) for key in vanish}
    log(f"(g) {name:10s} {list(shape)} causal={causal} {str(dtype)[6:]}: "
        + ", ".join(f"{key} {r:.2e}" for key, (_, r) in errs.items())
        + f" relative (tol {tol:.0e})"
        + "".join(f"; {key} max|kernel| {k:.2e} max|plain| {p:.2e} "
                  f"(vanishes; atol {VANISH_ATOL:.0e})"
                  for key, (k, p) in zero.items())
        + f"; launches by kernel {by_kernel}")
    bad = {key: r for key, (_, r) in errs.items() if not r <= tol}
    bad.update({key: v for key, v in zero.items()
                if not max(v) <= VANISH_ATOL})
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at {name} {shape}: {bad}")
    return {"shape": list(shape), "causal": causal, "dtype": str(dtype)[6:],
            "launches": launches, "launches_by_kernel": by_kernel,
            "rel_err": {key: r for key, (_, r) in errs.items()},
            "max_abs_err": {**{key: a for key, (a, _) in errs.items()},
                            **{key: abs(k - p) for key, (k, p) in zero.items()}},
            "vanish_max_abs": {key: k for key, (k, _) in zero.items()}}


def time_attention(shape, dtype, dev) -> dict:
    """Device time per call of each flash kernel, its plain version and
    the library call (``scaled_dot_product_attention``, causal, GQA, on
    (B, H, T, Dh) views), with the bounds of ``_attn_work``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v, do = _attn_inputs(shape, dtype, dev)
    o, lse = fb._fwd_with_stats(q, k, v, causal=True)
    delta = ref.flash_delta(o, do)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    out = sdpa(*leaves)
    dot = do.transpose(1, 2)
    with torch.no_grad():
        fwd_lib = lambda: sdpa(qt, kt, vt)
        rows = {
            "flash_fwd": dict(
                ms=device_ms([lambda: fa.flash_attention(q, k, v)], 10),
                plain_ms=device_ms([lambda: ref.flash_reference(q, k, v)], 3),
                library_ms=device_ms([fwd_lib], 10),
                fwd_lse_ms=device_ms([lambda: fb._fwd_with_stats(q, k, v)], 10)),
            "flash_dq": dict(
                ms=device_ms([lambda: fb.flash_dq(q, k, v, do, lse, delta)], 10),
                plain_ms=device_ms([lambda: ref.flash_dq(q, k, v, do, lse,
                                                         delta)], 3),
                library_ms=None),
            "flash_dkv": dict(
                ms=device_ms([lambda: fb.flash_dkv(q, k, v, do, lse, delta)], 10),
                plain_ms=device_ms([lambda: ref.flash_dkv(q, k, v, do, lse,
                                                          delta)], 3),
                library_ms=None),
        }
    # one library call computes dQ, dK and dV together: SDPA's backward.
    # Calls through autograd cost milliseconds of host time each, so few of
    # them are queued; device_ms lengthens its sleep when they need more.
    pair_lib = device_ms([lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True)], 5)
    fwd_bwd_lib = device_ms([lambda: torch.autograd.grad(
        sdpa(*leaves), leaves, dot)], 3)
    train_leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    fwd_bwd = device_ms([lambda: torch.autograd.grad(
        fb.flash_attention_train(*train_leaves), train_leaves, do)], 3)
    work = _attn_work(*shape, True, dtype)
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = work[name]
    # each kernel's own products: 2, 3 and 4 of 2 Dh FLOP per pair
    B, Tq, Tk, H, _, Dh = shape
    pairs = B * H * _pairs(Tq, Tk, True)
    for name, products in (("flash_fwd", 2), ("flash_dq", 3), ("flash_dkv", 4)):
        row = rows[name]
        row["flop"] = 2 * products * Dh * pairs
        row["tflop_per_s"] = row["flop"] / row["ms"] * 1e-9
        row["bound_share"] = row["bound_ms"] / row["ms"]
    rows["flash_fwd"]["sdpa_backend_ms"] = sdpa_backends(sdpa, qt, kt, vt)
    dq, dkv = rows["flash_dq"], rows["flash_dkv"]
    pair_ms = dq["ms"] + dkv["ms"]
    extra = {"fwd_bwd_ms": fwd_bwd, "fwd_bwd_library_ms": fwd_bwd_lib,
             "backward_library_ms": pair_lib,
             "backward_ms": pair_ms,
             "backward_tflop_per_s": (dq["flop"] + dkv["flop"]) / pair_ms * 1e-9,
             # against the pair's own 7 products, and the least work of the
             # function (5 products: dQ's dS K and dK/dV's four)
             "backward_bound_share": (dq["bound_ms"] + dkv["bound_ms"]) / pair_ms,
             "backward_bound_ms": work["backward_pair"][0]}
    del q, k, v, do, o, lse, delta, leaves, out, train_leaves
    torch.cuda.empty_cache()
    return {"rows": rows, **extra}


def sdpa_backends(sdpa, qt, kt, vt) -> dict:
    """Device ms of SDPA's forward pinned to each backend (flash, cuDNN,
    memory-efficient) with ``torch.nn.attention.sdpa_kernel``; None where
    the backend refuses these inputs. The default dispatch is
    ``library_ms``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return sdpa(qt, kt, vt)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as err:
            out[backend.name] = None
            log(f"(g)   SDPA {backend.name} refuses these inputs: "
                f"{str(err).splitlines()[0][:120]}")
            continue
        with torch.no_grad():
            out[backend.name] = device_ms([call], 10)
    return out


def _attn_shapes() -> list[tuple]:
    """(name, (B, Tq, Tk, H, Hkv, Dh)) at batch 8 x seq 1024 for the
    attention widths of gpt2-2.5b and qwen2-0.5b."""
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.configs.qwen2_0_5b import FULL as QWEN2_0_5B
    return [(c.name, (8, 1024, 1024, c.num_heads, c.num_kv_heads, c.hd))
            for c in (GPT2_2_5B, QWEN2_0_5B)]


def phase_attention(report: dict, dev) -> dict:
    """The flash kernels through the kernel API at the attention widths of
    gpt2-2.5b and qwen2-0.5b (bf16, causal), and two fp32 cases; then
    each kernel timed at both widths. Returns the launches of the drives
    (each case's counted from 0 around its drive, without the calls made
    to compare or time)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    kernels = fa.KERNELS + fb.KERNELS
    full = _attn_shapes()
    shapes = [(*c, True, torch.bfloat16) for c in full]
    shapes += [(f"fp32-{i}", c[:6], c[6], torch.float32)
               for i, c in enumerate(ATTN_FP32)]
    checks = [check_attention(name, shape, causal, dtype, dev)
              for name, shape, causal, dtype in shapes]
    checks += [check_attention(f"bf16-Tq{c[1]}-Tk{c[2]}", c[:6], c[6],
                               torch.bfloat16, dev, vanish=("dq", "dk"))
               for c in ATTN_VANISH]
    launches = {k.__name__: sum(c["launches"][k.__name__] for c in checks)
                for k in kernels}
    log(f"(g) launches {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a flash kernel never launched: {launches}")
    timing = {}
    for name, shape, _, dtype in shapes[:len(full)]:
        timing[name] = t = time_attention(shape, dtype, dev)
        for kname, row in t["rows"].items():
            lib = row["library_ms"]
            log(f"(g) {name:10s} {kname:9s} kernel {row['ms']:.4f} ms plain "
                f"{row['plain_ms']:.4f} library "
                f"{'none' if lib is None else f'{lib:.4f}'} bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), device time")
        for kname in ("flash_fwd", "flash_dq", "flash_dkv"):
            row = t["rows"][kname]
            log(f"(g) {name:10s} {kname} (bf16, tensor cores) "
                f"{row['tflop_per_s']:.1f} TFLOP/s of {row['flop'] / 1e9:.2f} "
                f"GFLOP; {row['bound_share']:.3f} of its bound")
        fwd = t["rows"]["flash_fwd"]
        log(f"(g) {name:10s} SDPA forward by backend " + ", ".join(
            f"{b} {'refused' if ms is None else f'{ms:.4f} ms'}"
            for b, ms in fwd["sdpa_backend_ms"].items()))
        log(f"(g) {name:10s} backward pair {t['backward_ms']:.4f} ms, "
            f"{t['backward_tflop_per_s']:.1f} TFLOP/s, "
            f"{t['backward_bound_share']:.3f} of its bound (SDPA backward "
            f"{t['backward_library_ms']:.4f}; 5-product bound "
            f"{t['backward_bound_ms']:.4f}); forward with LSE "
            f"{t['rows']['flash_fwd']['fwd_lse_ms']:.4f}; forward+backward "
            f"{t['fwd_bwd_ms']:.4f} ms (SDPA {t['fwd_bwd_library_ms']:.4f})")
    report["attention"] = {"checks": checks, "timing": timing,
                           "launches": launches}
    return launches


# ------------------------------------------------------------ (h) histogram
def phase_histogram(report: dict, dev, sample: torch.Tensor) -> dict:
    """hist_counts on the main path's pooled gradient sample, bit-equal to
    the plain version; sampled_entropy_hist against the plain
    histogram_entropy; a ragged, unaligned n and outliers; the entropy
    probe on the card; then the kernel timed against its bound."""
    from repro_torch.core.entropy import histogram_entropy
    from repro_torch.kernels import entropy_hist as eh
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import entropy_probe
    sample = sample.to(dev)
    n = sample.numel()
    mu, sigma = sample.mean(), sample.std(unbiased=False) + 1e-12
    lo, inv_w = mu - 8.0 * sigma, 1.0 / ((16.0 * sigma) / 256)
    ragged = sample[1:n - 4]                   # odd length, off 16 bytes
    gen = torch.Generator(device=dev).manual_seed(13)
    wild = sample[:1 << 20].clone()
    spots = torch.randperm(wild.numel(), generator=gen, device=dev)[:64]
    wild[spots[:32]], wild[spots[32:]] = 1e30, -1e30
    eh.hist_counts.launches = 0
    counts = {"pooled": eh.hist_counts(sample, lo, inv_w),
              "ragged": eh.hist_counts(ragged, lo, inv_w),
              "outliers": eh.hist_counts(wild, lo, inv_w)}
    entropy = ops.sampled_entropy_hist(sample)
    probe = entropy_probe.probe(dev)
    launches = {"hist_counts": eh.hist_counts.launches}
    # the plain counts in int64: exact, summing to n; the fp32 counts of
    # both versions round a bin above 2**24 to the nearest float
    samples = {"pooled": sample, "ragged": ragged, "outliers": wild}
    exact = {key: torch.bincount(ref.hist_bins(x, lo, inv_w), minlength=256)
             for key, x in samples.items()}
    want_h = histogram_entropy(sample)
    torch.cuda.synchronize()
    out = {"n": n, "launches": launches, "probe": probe}
    for key, c in counts.items():
        plain, size = exact[key].to(torch.float32), samples[key].numel()
        total = int(exact[key].sum().item())
        equal = torch.equal(c, plain) and total == size
        err = (c - plain).abs().max().item()
        big = int((exact[key] > 1 << 24).sum().item())
        log(f"(h) hist_counts {key:8s} n {size}: "
            f"{'bit-equal' if equal else 'MISMATCH'} to the plain version "
            f"(max abs err {err}); plain int64 counts sum to {total}, "
            f"{big} bins above 2**24")
        if not equal:
            raise AssertionError(f"hist_counts {key} differs from its plain "
                                 "version, or the plain counts lose elements")
        out[key] = {"n": size, "max_abs_err": err, "bins_over_2_24": big}
    outer = counts["outliers"][[0, -1]].tolist()
    if not outer[0] >= 32 or not outer[1] >= 32:
        raise AssertionError(f"outliers missed the end bins: {outer}")
    gap = abs(entropy.item() - want_h.item())
    log(f"(h) sampled_entropy_hist {entropy.item():.6f} nats, plain "
        f"histogram_entropy {want_h.item():.6f}: gap {gap:.2e} (tol "
        f"{ENTROPY_TOL:.0e}); probe on the card:")
    for line in probe:
        log(f"      {line}")
    if not gap <= ENTROPY_TOL or not math.isfinite(entropy.item()):
        raise AssertionError(f"sampled_entropy_hist strays {gap:.2e} nats")
    out["entropy"] = {"kernel": entropy.item(), "plain": want_h.item(),
                      "gap": gap}
    nbytes = sample.element_size() * n + 4 * 256
    bound, bound_by = bound_ms(nbytes, 3 * n)
    # the plain version's bincount waits for the device (it sizes its output
    # from the largest bin), so it is timed with its host round trips
    out["timing"] = row = dict(
        ms=device_ms([lambda: eh.hist_counts(sample, lo, inv_w)], 10),
        plain_ms=time_ms(lambda: ref.hist_counts(sample, lo, inv_w), 3),
        library_ms=None, bound_ms=bound, bound_by=bound_by)
    log(f"(h) hist_counts n {n}: kernel {row['ms']:.4f} ms (device time) "
        f"plain {row['plain_ms']:.4f} (with host round trips) library none (torch.histc drops out-of-range "
        f"values and bins by (x - min) * bins / (max - min)) bound "
        f"{bound:.4f} ms ({bound_by}); launches {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"hist_counts never launched: {launches}")
    report["histogram"] = out
    return launches


# --------------------------------------------------------------- (i) faults
def _reset_launches() -> tuple:
    from repro_torch.kernels import lowrank as lr, pack
    for k in lr.KERNELS + pack.KERNELS:
        k.launches = 0
    return lr.KERNELS + pack.KERNELS


def _read_ms(cfg, dev, recovery) -> float:
    """ms per step of four steps queued back to back in one ``run`` call
    (one flush, at its end): what the recovery policy's per-step read of
    the loss costs a loop that otherwise never waits for the device."""
    from repro_torch.data.pipeline import SyntheticLM
    tr = _trainer(cfg, "fixed", 64, 6, 50, dev, log_every=50,
                  recovery=recovery)
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    tr.run(batches, num_steps=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(batches, num_steps=4)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 4
    del tr
    torch.cuda.empty_cache()
    return ms


def phase_faults(report: dict, dev) -> None:
    """The fault channel and telemetry on the card: (i1) the guard, EF
    reset and fallback at (c)'s widths with a JSONL registry and the
    report; (i2) a rollback through a torn checkpoint; (i3) the small fp32
    fault runs on the card against the CPU, raw and quant8."""
    from repro_torch import tree
    from repro_torch.configs.gpt2 import GPT2_2_5B, GPT2_FIDELITY
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr, pack
    from repro_torch.launch.report import build_report
    from repro_torch.obs import (JsonlSink, MemorySink, MetricsRegistry,
                                 read_jsonl)
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.faults import RecoveryConfig, parse_inject
    out: dict = {}
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)

    # (i0) the per-step read: no recovery / the read alone / read + guard
    order = [("plain", None),
             ("read", RecoveryConfig(guard_nonfinite=False, rollback=False)),
             ("guard", RecoveryConfig(rollback=False)), ("plain", None)]
    queued = [(name, _read_ms(cfg, dev, rc)) for name, rc in order]
    out["queued_ms"] = queued
    log(f"(i0) four steps queued in one run call, ms per step (depth 8, "
        f"fixed r64, log_every 50): "
        + ", ".join(f"{n} {ms:.1f}" for n, ms in queued))

    # (i1) guard, EF reset, fallback at (c)'s widths; every device-to-host
    # copy the trainer makes is counted (its flushes and per-step reads)
    copies: list[int] = []
    real_fetch = trainer_mod.fetch
    trainer_mod.fetch = lambda ts: copies.append(len(ts)) or real_fetch(ts)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        reg = MetricsRegistry([JsonlSink(jsonl)])
        tr = _trainer(cfg, "fixed", 64, 9, 50, dev,
                      faults=parse_inject("nan_grad@2,corrupt_payload@5"),
                      recovery=RecoveryConfig(rollback=False, fallback_after=2),
                      metrics=reg)
        batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels = _reset_launches()
        try:
            step_ms = _timed_steps(tr, batches, 9)
        finally:
            trainer_mod.fetch = real_fetch
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated(dev)
        reg.close()
        records = read_jsonl(jsonl)
    reads = sum(1 for n in copies if n == 2)
    flushes = sum(1 for n in copies if n > 2)
    rs = tr.recovery.as_dict()
    seq = [(r["name"], r["step"]) for r in records if r["kind"] == "event"
           and r["name"] in ("fault_injected", "guard_skip", "ef_reset",
                             "recovered")]
    last = lambda name: [r for r in records if r["name"] == name][-1]
    lines = build_report(records)
    guarded = statistics.median(step_ms[i] for i in (1, 3, 4))
    fallback = statistics.median(step_ms[6:])
    main_ms = statistics.median(report["main"]["step_ms"][1:])
    main_peak = report["main"]["peak_bytes"]
    hist = tr.history
    out["guard"] = {"recovery": rs, "events": seq, "step_ms": step_ms,
                    "guarded_ms": guarded, "fallback_ms": fallback,
                    "main_step_ms": main_ms, "peak_bytes": peak,
                    "main_peak_bytes": main_peak, "flush_copies": flushes,
                    "step_reads": reads, "copies": copies,
                    "launches": launches, "records": len(records),
                    "loss": [h["loss"] for h in hist], "report": lines}
    log(f"(i1) guard + fallback: depth 8 fixed r64, nan_grad@2, "
        f"corrupt_payload@5, fallback_after 2, 9 steps: recovery {rs}")
    log(f"    events {seq}")
    for h, ms in zip(hist, step_ms):
        log(f"    step {h['step']} loss {h['loss']:.4f} {ms:.1f} ms bytes "
            f"synced {h['bytes_synced']} full {h['bytes_full']}")
    log(f"    guarded step (no fault; steps 1, 3, 4) {guarded:.1f} ms against "
        f"(c)'s unguarded {main_ms:.1f} ms; uncompressed step after the "
        f"fallback (steps 6-8) {fallback:.1f} ms")
    log(f"    peak memory {peak / 2**30:.2f} GiB against (c)'s "
        f"{main_peak / 2**30:.2f} GiB; device-to-host copies: {flushes} "
        f"flushes and {reads} per-step recovery reads; {len(records)} "
        f"records; launches {launches}")
    for line in lines:
        log(f"    report | {line}")
    want = [("fault_injected", 2), ("guard_skip", 2), ("ef_reset", 2),
            ("recovered", 3), ("fault_injected", 5), ("guard_skip", 5),
            ("ef_reset", 5), ("recovered", 6)]
    if seq != want:
        raise AssertionError(f"event order {seq} != {want}")
    if (rs["skipped_steps"], rs["ef_resets"], rs["anomalies"],
            rs["fallback"]) != (2, 2, 2, True):
        raise AssertionError(f"recovery after the guard run: {rs}")
    if not all(torch.isfinite(p.float()).all()
               for p in tree.leaves(tr.state["params"])):
        raise AssertionError("a parameter went non-finite under the guard")
    full = hist[-1]["bytes_full"] - hist[-2]["bytes_full"]
    for a, b in zip(hist[5:], hist[6:]):
        if b["bytes_synced"] - a["bytes_synced"] != full:
            raise AssertionError(f"step {b['step']} after the fallback synced "
                                 f"{b['bytes_synced'] - a['bytes_synced']} B, "
                                 f"not the uncompressed {full}")
    stage = [int(c) for c, _ in tr.stage_bytes()]
    got = (last("bytes_synced")["value"], last("bytes_full")["value"],
           last("stage_wire_bytes")["values"])
    if got != (tr.bytes_synced, tr.bytes_full, stage):
        raise AssertionError(f"JSONL ledgers {got} != the trainer's "
                             f"{(tr.bytes_synced, tr.bytes_full, stage)}")
    if "fault/recovery timeline:" not in lines:
        raise AssertionError(f"the report lacks the timeline: {lines}")
    if not all(launches[k.__name__] > 0 for k in lr.KERNELS):
        raise AssertionError(f"a PowerSGD kernel never launched: {launches}")
    del tr
    torch.cuda.empty_cache()

    # (i2) rollback through a torn checkpoint
    small = dataclasses.replace(GPT2_2_5B, num_layers=2, num_stages=2)
    with tempfile.TemporaryDirectory() as tmp:
        sink = MemorySink()
        tr = _trainer(small, "fixed", 64, 10, 50, dev, ckpt_every=3,
                      ckpt_path=os.path.join(tmp, "st"),
                      faults=parse_inject("torn_ckpt@4,nan_grad@6"),
                      recovery=RecoveryConfig(guard_nonfinite=False,
                                              ckpt_ring=2, fallback_after=99),
                      metrics=MetricsRegistry([sink]))
        saves, restores = [], []
        save, restore = tr.save_checkpoint, tr.restore_checkpoint

        def timed_save(path, step=None):
            t0 = time.perf_counter()
            save(path, step=step)
            saves.append((os.path.basename(path), time.perf_counter() - t0,
                          os.path.getsize(path + ".npz")
                          + os.path.getsize(path + ".json")))

        def timed_restore(path, load_recovery=True):
            t0, outcome = time.perf_counter(), "torn"
            try:
                step = restore(path, load_recovery=load_recovery)
                torch.cuda.synchronize()
                outcome = "ok"
                return step
            finally:
                restores.append((os.path.basename(path), outcome,
                                 time.perf_counter() - t0))

        tr.save_checkpoint, tr.restore_checkpoint = timed_save, timed_restore
        kernels = _reset_launches()
        t0 = time.perf_counter()
        hist = tr.run(SyntheticLM(small.vocab_size, 1024, 8, seed=0).batches())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
    rs = tr.recovery.as_dict()
    rollbacks = sink.events("rollback")
    out["rollback"] = {"recovery": rs, "seconds": secs, "saves": saves,
                       "restores": restores, "launches": launches,
                       "rollback_events": rollbacks,
                       "loss": [h["loss"] for h in hist],
                       "global_step": tr._global_step}
    log(f"(i2) rollback: depth 2 fixed r64, guard off, ckpt every 3, ring 2, "
        f"torn_ckpt@4, nan_grad@6, 10 steps in {secs:.1f} s: recovery {rs}")
    log(f"    saves (name, s, bytes) "
        f"{[(n, round(t, 3), b) for n, t, b in saves]}")
    log(f"    restores (name, outcome, s) "
        f"{[(n, o, round(t, 3)) for n, o, t in restores]}; rollback events "
        f"{[(e['step'], e['data']) for e in rollbacks]}; launches {launches}")
    if rs["rollbacks"] != 1 or tr._global_step != 10:
        raise AssertionError(f"rollback run: {rs}, step {tr._global_step}")
    if [e["data"] for e in rollbacks] != [{"restored_step": 3}]:
        raise AssertionError(f"rollback events {rollbacks}")
    if [(n, o) for n, o, _ in restores] != [("st_6", "torn"), ("st_3", "ok")]:
        raise AssertionError(f"restores {restores}")
    if not math.isfinite(hist[-1]["loss"]):
        raise AssertionError(f"final loss after the rollback {hist[-1]}")
    del tr
    torch.cuda.empty_cache()

    # (i3) the small fp32 fault runs: card against CPU, raw and quant8
    out["check"] = {}
    for wire, skips in (("raw", 1), ("quant8", 0)):
        runs = {}
        for where in ("cpu", dev):
            kernels = _reset_launches()
            tr = _trainer(GPT2_FIDELITY, "fixed", 8, 3, 50, where, wire=wire,
                          faults=parse_inject("nan_grad@1"),
                          recovery=RecoveryConfig(rollback=False))
            hist = tr.run(SyntheticLM(GPT2_FIDELITY.vocab_size, 64, 4,
                                      seed=1).batches())
            runs[str(where)] = (tr.recovery.as_dict(),
                                [h["loss"] for h in hist],
                                {k.__name__: k.launches for k in kernels})
        (cpu_rs, cpu, _), (gpu_rs, gpu, launches) = runs["cpu"], runs[str(dev)]
        gap = max(abs(a - b) for a, b in zip(cpu, gpu))
        out["check"][wire] = {"cpu": runs["cpu"][:2], "gpu": runs[str(dev)][:2],
                              "max_gap": gap, "launches": launches}
        log(f"(i3) gpt2-fidelity fp32 wire={wire}, nan_grad@1, 3 steps: card "
            f"{gpu_rs} loss {gpu}; cpu {cpu_rs} loss {cpu}; max gap "
            f"{gap:.2e} (tol 5e-3); card launches {launches}")
        ema_gap = abs(gpu_rs.pop("loss_ema") - cpu_rs.pop("loss_ema"))
        if gpu_rs != cpu_rs or gpu_rs["skipped_steps"] != skips:
            raise AssertionError(f"wire={wire}: card {gpu_rs} != cpu {cpu_rs} "
                                 f"or not {skips} skipped")
        if not (gap < 5e-3 and ema_gap < 5e-3):
            raise AssertionError(f"wire={wire}: the card's fault run strays "
                                 f"from the CPU's ({gap}, {ema_gap})")
        used = lr.KERNELS + (pack.KERNELS if wire != "raw" else ())
        if not all(launches[k.__name__] > 0 for k in used):
            raise AssertionError(f"wire={wire}: a kernel never launched on the "
                                 f"card: {launches}")
    report["faults"] = out


# ------------------------------------------------------------- (j) pipeline
# (j2): (schedule, stash policy, stash_every) beside (j1)'s (1f1b, replay);
# with 2 units per stage, every_k stashes only at k = 1
PIPE_CASES = [("gpipe", "replay", 2), ("1f1b", "full", 2),
              ("1f1b", "every_k", 1)]
PIPE_M = 4                     # microbatches: 2 x 1024 each of (c)'s batch


def _pipe_run(cfg, dev, main: dict, schedule: str, stash: str, steps: int,
              profile: bool, keep: dict | None = None, **tkw) -> dict:
    """(c)'s run through the pipelined executor: S stages on this card
    (``LocalPipe``), M = 4, ``steps`` timed steps, each loss held to
    ``main``'s, (c)'s (the first within 2e-3, every one within 5e-2), and
    the bytes synced equal; the stages' shape groups are (b)'s
    ``PIPE_GROUPS``; the PowerSGD kernels counted from zero. ``tkw`` goes
    to ``TrainerConfig``. ``keep`` receives host copies of the final
    weights and compressor state (``state``), the overlap plan and each
    step variant's last sync launches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr
    from repro_torch.pipeline import schedule as sched
    from repro_torch.pipeline.schedule import boundary_nbytes
    S = cfg.num_stages
    _release()
    before = torch.cuda.memory_allocated(dev)
    tr = _trainer(cfg, "fixed", 64, 5, 50, dev, pipe=S, schedule=schedule,
                  num_microbatches=PIPE_M, stash_policy=stash, **tkw)
    groups = sorted({(g.stack_size, g.m, g.n, g.rank)
                     for lay in tr._splans.layouts for g in lay.groups})
    if groups != sorted(PIPE_GROUPS):
        raise AssertionError(f"per-stage groups {groups} != (b)'s "
                             f"{PIPE_GROUPS}")
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    kernels = _reset_launches()
    step_ms, step_peaks = [], []
    for _ in range(steps):
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms += _timed_steps(tr, batches, 1)
        step_peaks.append(torch.cuda.max_memory_allocated(dev))
    launches = {k.__name__: k.launches for k in kernels}
    peak = max(step_peaks)
    hist = tr.history
    if keep is not None:
        from repro_torch import tree
        keep["state"] = [t.detach().cpu() for t in tree.leaves(
            [tr.state["stage_params"], tr.state["shared_params"],
             tr.state["comp"]])]
        keep["plan"] = tr.overlap_plan
        keep["sync_launches"] = [st.sync_launches
                                 for st in tr._step_cache.values()]
    losses = [h["loss"] for h in hist]
    gaps = [abs(a - b) for a, b in zip(losses, main["loss"])]
    mb = {"tokens": torch.empty((8 // PIPE_M, 1024))}
    n_units = tr._part.num_units()
    every = tr.pipeline_cfg.stash_every
    predicted = sched.peak_activation_bytes(
        schedule, S, PIPE_M, stash, boundary_bytes=boundary_nbytes(tr._part, mb),
        n_units=n_units, stash_every=every)
    row = {"schedule": schedule, "stash": stash, "loss": losses,
           "gaps": gaps, "step_ms": step_ms, "peak_bytes": peak,
           "start_bytes": start, "step_peak_bytes": step_peaks,
           "before_trainer_bytes": before,
           "launches": launches, "n_units": n_units,
           "segments": sched.stash_segments(stash, n_units, every),
           "predicted_activation_bytes": predicted,
           "bytes_synced": [h["bytes_synced"] for h in hist]}
    if profile:
        row["profile"] = profile_step(tr, batches,
                                      statistics.median(step_ms[1:]),
                                      streams=True)
    log(f"    {schedule}/{stash} (segments {row['segments']}): losses "
        f"{[round(x, 4) for x in losses]}, gaps to (c) "
        f"{[f'{g:.1e}' for g in gaps]}; step ms "
        f"{[round(x, 1) for x in step_ms]}; peak {peak / 2**30:.2f} GiB "
        f"(per step {[round(x / 2**30, 2) for x in step_peaks]}; allocated "
        f"before the trainer {before / 2**30:.2f}, with its state "
        f"{start / 2**30:.2f}); "
        f"ledger's saved activations per stage {predicted} B; launches "
        f"{launches}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{schedule}/{stash}: losses {losses}")
    if not (gaps[0] < 2e-3 and max(gaps) < 5e-2):
        raise AssertionError(f"{schedule}/{stash}: losses {losses} stray from "
                             f"(c)'s {main['loss']}")
    if row["bytes_synced"] != main["bytes_synced"][:steps]:
        raise AssertionError(f"{schedule}/{stash}: bytes synced "
                             f"{row['bytes_synced']} != (c)'s")
    if not all(launches[k.__name__] > 0 for k in lr.KERNELS):
        raise AssertionError(f"a PowerSGD kernel never launched on the "
                             f"pipelined path: {launches}")
    del tr
    _release()
    return row


def _release() -> None:
    """Free what earlier runs left: unreachable objects first (a dropped
    trainer can wait for the collector), then the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_pipeline(report: dict, dev, keep: dict) -> dict:
    """The pipelined executor on the card: (j1) (c)'s model at S = 4, M = 4
    through ``LocalPipe``, 1F1B, replay, 4 steps and one profiled; (j2)
    two steps under the other schedule and stash policies; (j3) edgc at
    depth 4 (one layer per stage), window 4; (j4) (e)'s small model at
    S = 4 on the card against the CPU, raw and quant8; (j5) the command
    line with ``--pipe 2 --trace`` and the report's ``--trace``. Returns
    the kernels' launches on the pipelined paths: (j1) for PowerSGD, (j4)
    quant8 for pack. ``keep`` receives (j1)'s final state (``_pipe_run``)."""
    from repro_torch.configs.gpt2 import GPT2_2_5B, GPT2_FIDELITY
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr, pack
    from repro_torch.obs import MemorySink, MetricsRegistry
    from repro_torch.obs.trace import (expected_span_count, load_trace,
                                       validate_trace)
    out: dict = {}
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    S = cfg.num_stages
    log(f"(j) pipeline: {cfg.name} widths, depth {cfg.num_layers}, S={S} "
        f"stages {cfg.stage_sizes()}, M={PIPE_M} (microbatch "
        f"{8 // PIPE_M} x 1024), LocalPipe on one card, fixed r64, kernels "
        f"on; one card runs the stages one after another (no overlap)")
    # (j1) the main pipelined path
    log("(j1) 1f1b/replay, 4 steps and one profiled")
    out["main"] = _pipe_run(cfg, dev, report["main"], "1f1b", "replay", 4,
                            profile=True, keep=keep)
    prof = out["main"]["profile"]
    main_ms = statistics.median(report["main"]["step_ms"][1:])
    pipe_ms = statistics.median(out["main"]["step_ms"][1:])
    log(f"    step {pipe_ms:.1f} ms against (c)'s flat {main_ms:.1f} ms "
        f"({pipe_ms / main_ms:.3f}x); device busy {prof['busy_ms']:.1f} ms, "
        f"idle share {1 - prof['busy_ms'] / prof['step_ms']:.3f}; peak "
        f"{out['main']['peak_bytes'] / 2**30:.2f} GiB against (c)'s "
        f"{report['main']['peak_bytes'] / 2**30:.2f} GiB")
    # (j2) the other schedule and stash policies, 2 steps each
    log("(j2) the other schedule and stash policies, 2 steps each")
    out["policies"] = [_pipe_run(cfg, dev, report["main"], sch, st, 2,
                                 profile=False, stash_every=every)
                       for sch, st, every in PIPE_CASES]

    # (j3) edgc: Algorithm 2's stage-aligned ranks on the pipelined trainer
    small = dataclasses.replace(GPT2_2_5B, num_layers=4)
    sink = MemorySink()
    tr = _trainer(small, "edgc", 64, 12, 4, dev, pipe=S,
                  num_microbatches=PIPE_M,
                  metrics=MetricsRegistry([sink]))
    t0 = time.perf_counter()
    # 11 of 12 steps: the last re-plan (step 7) is the plan steps 8-10 ran
    hist = tr.run(SyntheticLM(small.vocab_size, 1024, 8, seed=0).batches(),
                  num_steps=11)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = list(tr.controller.rank_history[-1][1]) \
        if tr.controller.rank_history else []
    plan = tr.controller.plan.as_dict()
    stage_b = tr.stage_bytes()
    # bf16 wire: 2 r (m + n) bytes per matrix of a compressed leaf at its
    # stage's rank (capped at half its smaller side), 2 per element else
    by_hand = [0] * S
    for l in tr.leaves:
        s = min(l.stage, S - 1)
        if l.path in plan:
            *lead, m, n = l.shape
            r = max(1, min(ranks[s], min(m, n) // 2))
            by_hand[s] += 2 * r * (m + n) * math.prod(lead)
        else:
            by_hand[s] += 2 * math.prod(l.shape)
    replans = [e for e in sink.events() if e["name"] == "plan_change"]
    q_ranks = sorted({int(v.q.shape[-1]) for v in tr.state["comp"].values()
                      if hasattr(v, "q")})
    out["edgc"] = {"ranks": ranks, "stage_bytes": stage_b,
                   "by_hand": by_hand, "replans": len(replans),
                   "q_ranks": q_ranks, "seconds": secs,
                   "loss": [h["loss"] for h in hist],
                   "stage_entropy": tr._last_stage_entropy}
    log(f"(j3) edgc depth 4 (one layer per stage), window 4, 11 of 12 steps "
        f"in {secs:.1f} s: applied ranks {ranks}; {len(replans)} re-plans; "
        f"compressor Q ranks {q_ranks}; stage bytes {stage_b}; by hand "
        f"{by_hand}; stage entropy {tr._last_stage_entropy}")
    if len(ranks) != S or ranks != sorted(ranks):
        raise AssertionError(f"applied rank vector {ranks} is not {S} "
                             "non-decreasing entries")
    if [c for c, _ in stage_b] != by_hand or hist[-1]["stage_bytes"] != stage_b:
        raise AssertionError(f"stage bytes {stage_b} / {hist[-1]['stage_bytes']}"
                             f" != stage_wire_bytes of the plan {by_hand}")
    for path, r in plan.items():
        leaf = next(l for l in tr.leaves if l.path == path)
        want = max(1, min(ranks[min(leaf.stage, S - 1)],
                          min(leaf.shape[-2:]) // 2))
        if r != want:
            raise AssertionError(f"{path}: rank {r}, stage rank gives {want}")
    if not replans or q_ranks != sorted({r for _, r in
                                         tr.controller.plan.ranks}):
        raise AssertionError(f"no re-plan resized the compressor state: "
                             f"{len(replans)} plan changes, Q ranks {q_ranks}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("the pipelined edgc run gave a non-finite loss")
    del tr
    _release()

    # (j4) (e)'s small fp32 model at S = 4: card against CPU
    out["check"] = {}
    pipe_launches = {}
    for wire in ("raw", "quant8"):
        runs = {}
        for where in ("cpu", dev):
            kernels = _reset_launches()
            tr = _trainer(GPT2_FIDELITY, "fixed", 8, 3, 50, where, wire=wire,
                          pipe=GPT2_FIDELITY.num_stages)
            h = tr.run(SyntheticLM(GPT2_FIDELITY.vocab_size, 64, 4,
                                   seed=1).batches())
            runs[str(where)] = ([x["loss"] for x in h],
                                {k.__name__: k.launches for k in kernels})
        (cpu, _), (gpu, launches) = runs["cpu"], runs[str(dev)]
        gap = max(abs(a - b) for a, b in zip(cpu, gpu))
        out["check"][wire] = {"cpu_loss": cpu, "gpu_loss": gpu,
                              "max_gap": gap, "launches": launches}
        log(f"(j4) gpt2-fidelity fp32 S=4 wire={wire}, 3 steps: card {gpu} "
            f"cpu {cpu} max gap {gap:.2e} (tol 5e-3); card launches "
            f"{launches}")
        if not gap < 5e-3 or not all(math.isfinite(x) for x in gpu):
            raise AssertionError(f"wire={wire}: the card's pipelined kernel "
                                 "path disagrees with the CPU")
        used = lr.KERNELS + (pack.KERNELS if wire != "raw" else ())
        if not all(launches[k.__name__] > 0 for k in used):
            raise AssertionError(f"wire={wire}: a kernel never launched on "
                                 f"the pipelined card run: {launches}")
        if wire == "quant8":
            pipe_launches.update({k.__name__: launches[k.__name__]
                                  for k in pack.KERNELS})
    pipe_launches.update({k.__name__: out["main"]["launches"][k.__name__]
                          for k in lr.KERNELS})

    # (j5) the command line: --pipe 2 --trace, then the report's --trace
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        trace_a, trace_b = os.path.join(tmp, "a.json"), os.path.join(tmp, "b.json")
        runs = os.path.join(tmp, "runs")
        t0 = time.perf_counter()
        cmds = [[sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "gpt2", "--variant", "reduced", "--policy", "fixed",
                 "--pipe", "2", "--micro", "2", "--steps", "4", "--batch",
                 "4", "--seq", "64", "--use-kernels", "--trace", trace_a,
                 "--metrics-dir", runs],
                [sys.executable, "-m", "repro_torch.launch.report", runs,
                 "--trace", trace_b]]
        logs = [subprocess.run(c, env=env, capture_output=True, text=True,
                               check=True, timeout=300).stdout for c in cmds]
        secs = time.perf_counter() - t0
        stats = [validate_trace(load_trace(t)) for t in (trace_a, trace_b)]
    want = expected_span_count("1f1b", 2, 2)
    got = [st["by_cat"].get("forward", 0) + st["by_cat"].get("backward", 0)
           for st in stats]
    out["cli"] = {"stats": stats, "expected_spans": want, "seconds": secs,
                  "train_tail": logs[0].splitlines()[-3:],
                  "report": logs[1].splitlines()}
    log(f"(j5) launch.train --pipe 2 --trace on the card, then "
        f"launch.report --trace, {secs:.1f} s: F/B spans {got} (tick table "
        f"{want}), tracks {[st['tracks'] for st in stats]}")
    for line in logs[1].splitlines():
        log(f"    report | {line}")
    if got != [want, want] or "pipeline: S=2 M=2 1f1b" not in logs[1]:
        raise AssertionError(f"trace spans {got} != {want} or the report "
                             "lacks the pipeline line")
    report["pipeline"] = out
    return pipe_launches


# -------------------------------------------------------- (k) overlapped sync
# chunks of at most 32 KiB of fp32: each stage's flat bucket (the norms and
# biases of its two layers, about 200 KB) splits into several
K_CHUNK_BYTES = 1 << 15


def _launch_counts(plan, launches) -> tuple[list[int], list[int]]:
    """Per stage, the chunks launched in the loop and after it."""
    S = plan.num_stages
    return ([sum(len(ids) for t, s, ids in launches if t >= 0 and s == st)
             for st in range(S)],
            [sum(len(ids) for t, s, ids in launches if t < 0 and s == st)
             for st in range(S)])


def phase_overlap(report: dict, dev, j1_state: list) -> dict:
    """The overlapped per-stage sync on the card (``LocalPipe``: the in-loop
    chunks run on the step's side stream while the other stages compute):
    (k1) (j1)'s run twice with ``overlap_sync``, each equal to (j1) bit for
    bit and each launch where ``plan_overlap`` puts it; (k2) (j3)'s edgc
    run with overlap, the DAC's slack and the plan's feasibility; (k3) the
    command line with ``--overlap --trace``. Returns the PowerSGD kernels'
    launches on (k1)'s first run."""
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr
    from repro_torch.obs import MemorySink, MetricsRegistry
    from repro_torch.obs.metrics import read_jsonl
    from repro_torch.obs.trace import load_trace, validate_trace
    out: dict = {}
    j = report["pipeline"]
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    S = cfg.num_stages
    log(f"(k) overlapped sync: (j1)'s run with overlap_sync, chunks of at "
        f"most {K_CHUNK_BYTES} B, the in-loop chunks on a side stream")
    runs = []
    for i in range(2):
        keep: dict = {}
        row = _pipe_run(cfg, dev, report["main"], "1f1b", "replay", 4,
                        profile=i == 0, keep=keep, overlap_sync=True,
                        chunk_bytes=K_CHUNK_BYTES)
        plan = keep["plan"]
        in_loop, residual = _launch_counts(plan, keep["sync_launches"][0])
        planned = ([sum(len(ids) for _, ids in plan.launches[s])
                    for s in range(S)],
                   [len(plan.residual[s]) for s in range(S)])
        same_launches = all(
            sorted(v) == sorted(keep["sync_launches"][0])
            for v in keep["sync_launches"])
        equal = (row["loss"] == j["main"]["loss"]
                 and len(keep["state"]) == len(j1_state)
                 and all(torch.equal(a, b)
                         for a, b in zip(keep["state"], j1_state)))
        row.update(in_loop=in_loop, residual=residual, planned=planned,
                   launch_ticks=[list(plan.launch_ticks(s)) for s in range(S)],
                   equal_to_j1=equal)
        log(f"(k1) run {i + 1}: losses equal to (j1)'s and final weights and "
            f"compressor state bit-equal: {equal}; chunks per stage in the "
            f"loop {in_loop} after it {residual} (plan {planned[0]} / "
            f"{planned[1]}, launch ticks {row['launch_ticks']}); PowerSGD "
            f"launches {row['launches']} ((j1) {j['main']['launches']})")
        if not equal:
            raise AssertionError(f"(k1) run {i + 1}: the overlapped run is not "
                                 "bit-equal to (j1)")
        if (in_loop, residual) != planned or in_loop != list(range(S))                 or not same_launches:
            raise AssertionError(f"(k1): launches {in_loop}/{residual} != the "
                                 f"plan's {planned} (or not [0..S-1])")
        if row["launches"] != j["main"]["launches"]:
            raise AssertionError(f"(k1): PowerSGD launches {row['launches']} "
                                 f"!= (j1)'s {j['main']['launches']}")
        runs.append(row)
    del j1_state[:]
    k1, j1 = runs[0], j["main"]
    k_ms = statistics.median(k1["step_ms"][1:])
    j_ms = statistics.median(j1["step_ms"][1:])
    kp, jp = k1["profile"], j1["profile"]
    log(f"    step {k_ms:.1f} ms (run 2 "
        f"{statistics.median(runs[1]['step_ms'][1:]):.1f}) against (j1)'s "
        f"{j_ms:.1f} ms ({k_ms / j_ms:.3f}x); device busy "
        f"{kp['busy_ms']:.1f} ms against {jp['busy_ms']:.1f}; side-stream kernels "
        f"{kp['streams']['side_ms']:.3f} ms, "
        f"{kp['streams']['side_overlapped_ms']:.3f} ms of it overlapping "
        f"compute; peak {k1['peak_bytes'] / 2**30:.2f} GiB against "
        f"{j1['peak_bytes'] / 2**30:.2f} GiB")
    out["main"] = runs

    # (k2) edgc at depth 4, window 4, with overlap
    small = dataclasses.replace(GPT2_2_5B, num_layers=4)
    sink = MemorySink()
    tr = _trainer(small, "edgc", 64, 12, 4, dev, pipe=S,
                  num_microbatches=PIPE_M, overlap_sync=True,
                  chunk_bytes=K_CHUNK_BYTES, metrics=MetricsRegistry([sink]))
    t0 = time.perf_counter()
    hist = tr.run(SyntheticLM(small.vocab_size, 1024, 8, seed=0).batches(),
                  num_steps=11)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = list(tr.controller.rank_history[-1][1]) \
        if tr.controller.rank_history else []
    event = next(e["data"] for e in sink.events() if e["name"] == "overlap_plan")
    slack = tr.controller.dac.slack_seconds
    t_mb = tr.controller.dac.t_micro_back
    out["edgc"] = {"ranks": ranks, "j3_ranks": j["edgc"]["ranks"],
                   "slack_seconds": slack, "overlap_plan": event,
                   "seconds": secs, "loss": [h["loss"] for h in hist]}
    log(f"(k2) edgc depth 4, window 4, overlap, 11 of 12 steps in {secs:.1f} "
        f"s: applied ranks {ranks} against (j3)'s {j['edgc']['ranks']}; DAC "
        f"slack {slack} s (t_micro_back {t_mb:.3e} s); overlap_plan {event}")
    if slack is None or slack != [t * t_mb for t in tr.overlap_plan.slack_seconds]:
        raise AssertionError(f"(k2): the DAC holds slack {slack}, not the "
                             "plan's")
    if not all(event["feasible"]) or len(ranks) != S \
            or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"(k2): feasible {event['feasible']}, ranks "
                             f"{ranks}")
    del tr
    _release()

    # (k3) the command line: --pipe 2 --overlap --chunk-bytes --trace
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        trace, runs_dir = os.path.join(tmp, "t.json"), os.path.join(tmp, "runs")
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "gpt2", "--variant", "reduced", "--policy", "fixed", "--pipe",
               "2", "--micro", "2", "--steps", "4", "--batch", "4", "--seq",
               "64", "--use-kernels", "--overlap", "--chunk-bytes", "4096",
               "--trace", trace, "--metrics-dir", runs_dir]
        tail = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              check=True, timeout=300).stdout.splitlines()[-3:]
        secs = time.perf_counter() - t0
        events = load_trace(trace)["traceEvents"]
        stats = validate_trace(load_trace(trace))
        plan = next(r["data"] for r in read_jsonl(
            os.path.join(runs_dir, "metrics.jsonl"))
            if r.get("name") == "overlap_plan")
    spans = {cat: [sum(1 for e in events if e.get("cat") == cat
                       and e["tid"] == s) for s in range(2)]
             for cat in ("sync", "sync-residual")}
    out["cli"] = {"spans": spans, "plan": plan, "stats": stats,
                  "seconds": secs, "train_tail": tail}
    log(f"(k3) launch.train --pipe 2 --overlap --chunk-bytes 4096 --trace on "
        f"the card, {secs:.1f} s: SYNC spans per stage {spans['sync']} "
        f"(plan's in-loop {plan['in_loop']}), sync-residual "
        f"{spans['sync-residual']} (plan's residual {plan['residual']})")
    if spans["sync"] != plan["in_loop"] \
            or spans["sync-residual"] != plan["residual"] \
            or sum(plan["in_loop"]) == 0:
        raise AssertionError(f"(k3): trace spans {spans} != the plan {plan}")
    report["overlap"] = out
    return runs[0]["launches"]


# ----------------------------------------------------------------- the lines
# ----------------------------------------------------------- (l) families
# qwen3-moe-235b-a22b at depth 1: (E, m, n, r) of wk/wv, wq/wo, down, and
# gate/up of 128 experts
MOE_GROUPS = [(2, 4096, 256, 64), (2, 4096, 4096, 64), (128, 1536, 4096, 64),
              (256, 4096, 1536, 64)]
MOE_CHECK = [(256, 4096, 1536, 64), (128, 1536, 4096, 64)]
# qwen3-32b at depth 2: the mlp's gate/up and down groups
QWEN3_CHECK = [(4, 5120, 25600, 64), (2, 25600, 5120, 64)]
MOE_PEAK_RECKONING_GIB = 72.0     # state from the leaf list plus the largest group's sync


def _state_gb(tr) -> dict:
    """GB (1e9 B) of the flat trainer's state by part."""
    from repro_torch import tree
    from repro_torch.core.powersgd import LowRankState
    size = lambda t: sum(a.numel() * a.element_size() for a in tree.leaves(t))
    comp = tr.state["comp"]
    return {"params": size(tr.state["params"]) / 1e9,
            "moments": (size(tr.state["opt_m"]) + size(tr.state["opt_v"])) / 1e9,
            "ef": sum(v.err.numel() * 4 for v in comp.values()
                      if isinstance(v, LowRankState)) / 1e9,
            "q": sum(v.q.numel() * 4 for v in comp.values()
                     if isinstance(v, LowRankState)) / 1e9}


def _bytes_by_hand(tr) -> int:
    """One raw step's wire bytes from the shapes: 2 r (m + n) per compressed
    (m, n) matrix, 2 per element of every other leaf."""
    from repro_torch import tree
    ranks = dict(tr.controller.plan.ranks)
    total = 0
    for path, a in tree.flatten_with_path(tr.state["params"]):
        if path in ranks:
            m, n = a.shape[-2:]
            total += 2 * ranks[path] * (m + n) * (a.numel() // (m * n))
        else:
            total += 2 * a.numel()
    return total


POWERSGD = ("ef_lowrank_p", "ef_lowrank_q", "decompress_residual",
            "gram_schmidt_panel")


def _family_batches(cfg, batch: int, seq: int, seed: int = 0):
    """SyntheticLM batches with the family's stub frames attached."""
    from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
    for b in SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batches():
        yield add_modality_stubs(b, cfg.family, audio_frames=cfg.audio_frames,
                                 num_patches=cfg.num_patches,
                                 d_model=cfg.d_model, seed=seed)


def _attention_tails(cfg, seq: int) -> set:
    """The (second-last, last) dims, size-1 dims left out, of attention's
    tensors, for the model's self- and cross-attention: the (tokens,
    heads, head dim) layout and RoPE's halves, the grouped query block
    (kv heads, rep, head dim), and the scores, values and their batched
    products (query block or rep x query block, keys, head dim)."""
    lens = [seq] + ([cfg.audio_frames] if cfg.family == "whisper" else [])
    hd, rep = cfg.hd, cfg.num_heads // cfg.num_kv_heads
    tails = {(h, d) for h in (cfg.num_heads, cfg.num_kv_heads, rep)
             for d in (hd, hd // 2)}
    for k in lens:
        for q in {min(cfg.block_q, n) for n in lens} | {
                n % cfg.block_q for n in lens if n % cfg.block_q}:
            for qq in {q, rep * q}:
                tails |= {(qq, k), (qq, hd), (hd, k), (k, hd)}
    return tails


def _squeezed(shape) -> tuple:
    return tuple(d for d in shape if d != 1)


def _mamba2_layout(cfg, batch: int, seq: int):
    """A rule that holds for the tensors of Mamba2's SSM by their own
    layout (size-1 dims left out), tried before attention's: (B, T, H),
    (B, N, H), (B, H) and (H,) for dt, log_a, the chunk decays and the
    per-head parameters; the heads H before the head or state dim; the
    chunked (N, C, H), (C, C, H), (H, C, C) and (N, H), and the chunk
    einsums' (N H, x) and batched (B N H, x, y), x and y the chunk or the
    head or state dim. Each holds the heads next to a dim that attention's
    tensors do not put there."""
    H, n, C = 2 * cfg.d_model // 64, cfg.ssm_state, cfg.chunk
    N = -(-seq // C)
    inner = {64, n, C}
    exact = {(batch, N * C, H), (batch, seq, H), (batch, N, H), (batch, H),
             (H,)}
    runs = [(H, 64), (H, n), (N, C, H), (C, C, H), (H, C, C), (N, H)] + [
        (N * H, x) for x in inner]

    def holds(u: tuple) -> bool:
        if u in exact or (len(u) == 3 and u[0] == batch * N * H
                          and set(u[1:]) <= inner):
            return True
        return any(u[i:i + len(r)] == r for r in runs
                   for i in range(len(u) - len(r) + 1))
    return lambda shapes, dims: any(holds(_squeezed(sh)) for sh in shapes)


def _family_rules(cfg, batch: int, seq: int) -> list:
    """(part, rule over an aten op's input shapes and their dims) for a
    profiled step of ``cfg``, tried in order. MoE: the experts' d_ff, the
    GShard dispatch and combine's E x C slots, the router's E over the
    tokens. xLSTM: the recurrence's chunked tensors (rank 4 or more with
    the chunk in them, mLSTM's normaliser column dh + 1); the sLSTM loop's
    per-token tensors (the batch's width and no time axis). Zamba2: the
    Mamba2 SSM's own layout (``_mamba2_layout``), before attention. Then
    attention by the tails of its tensors (``_attention_tails``)."""
    tails = _attention_tails(cfg, seq)
    attention = ("attention", lambda shapes, dims: any(
        len(u) >= 3 and u[-2:] in tails
        for u in map(_squeezed, shapes)))
    big = lambda shapes: max((len(sh) for sh in shapes), default=0) >= 4
    if cfg.family == "moe":
        from repro_torch.models import moe
        E = cfg.num_experts
        C = moe.capacity_of(cfg, min(cfg.moe_group, batch * seq))
        return [("experts", lambda shapes, dims: cfg.d_ff in dims),
                ("dispatch and combine",
                 lambda shapes, dims: E * C in dims or C in dims),
                ("router", lambda shapes, dims: E in dims
                 and batch * seq in dims),
                attention]
    if cfg.family == "xlstm":
        H, d = cfg.num_heads, cfg.d_model
        dh = 2 * d // H
        return [("recurrence (mLSTM)",
                 lambda shapes, dims: (dh + 1) in dims
                 or (big(shapes) and cfg.chunk in dims)),
                ("sLSTM loop",
                 lambda shapes, dims: seq not in dims and bool(
                     dims & {d, 4 * d, d // H}))]
    if cfg.family == "zamba":
        return [("recurrence (Mamba2)", _mamba2_layout(cfg, batch, seq)),
                attention]
    return [attention]


def _family_profile(tr, batches, cfg, batch: int, seq: int,
                    step_ms: float) -> dict:
    """One more step under the profiler: device ms and kernel-running aten
    ops by part (the PowerSGD kernels by name; every other op by the shapes
    of its inputs, ``_family_rules`` after AdamW's slices and the head's
    vocabulary; the profiler's own events, such as "Command Buffer Full",
    repeat kernel time and are left out), kernel launches, and the idle
    share of an unprofiled step of ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from repro_torch.optim import adam
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        tr.run(batches, num_steps=1)
        torch.cuda.synchronize()
    sync = ("ef_factor_kernel", "decompress_kernel", "gram_schmidt_kernel",
            "split_sum_kernel")
    ms = {"sync kernels": 0.0}
    ops = {"sync kernels": 0}
    launches, busy = 0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        busy += e.self_device_time_total / 1e3
        if any(k in e.key for k in sync):
            ms["sync kernels"] += e.self_device_time_total / 1e3
            ops["sync kernels"] += e.count
    rules = ([("adamw", lambda shapes, dims: adam.INPLACE_CHUNK in dims),
              ("head and loss", lambda shapes, dims: cfg.vocab_size in dims)]
             + _family_rules(cfg, batch, seq))
    other: dict[str, float] = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0 \
                or not e.key.startswith("aten::"):
            continue
        shapes = [sh for sh in (e.input_shapes or []) if isinstance(sh, list)]
        dims = {d for sh in shapes for d in sh if isinstance(d, int)}
        t = e.self_device_time_total / 1e3
        name = next((n for n, rule in rules if rule(shapes, dims)), "rest")
        ms[name] = ms.get(name, 0.0) + t
        ops[name] = ops.get(name, 0) + e.count
        if name == "rest":
            other[e.key] = other.get(e.key, 0.0) + t
    return {"ms_by_part": ms, "ops_by_part": ops, "launches": launches,
            "busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "rest_largest_ms": dict(sorted(other.items(),
                                           key=lambda kv: -kv[1])[:6])}


def _family_full(label: str, cfg, batch: int, seq: int, steps: int, dev,
                 profile: bool, want_groups: tuple | None = None,
                 note: str = "") -> dict:
    """(l1), (m1)-(m3): ``Trainer.run`` for ``steps`` flat steps of
    ``cfg``, fixed rank 64, kernels on, raw wire; groups (held to
    ``want_groups``, (groups, matrices), where given), launches, bytes
    against the hand count, state by part, peak, loss (and the MoE's aux)
    and step ms; with ``profile`` one more step's device time by part."""
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = _trainer(cfg, "fixed", 64, steps + 1, 50, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    groups = [(g.stack_size, g.m, g.n, g.rank) for g in tr._layout.groups]
    matrices = sum(g.stack_size for g in tr._layout.groups)
    compressed = sum(g.stack_size * g.m * g.n for g in tr._layout.groups)
    state = _state_gb(tr)
    state_bytes = torch.cuda.memory_allocated(dev)
    log(f"({label}) {cfg.name} (d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers, {cfg.num_stages} stages' layout, {cfg.dtype}, remat="
        f"{cfg.remat}), batch {batch} x {seq}: {tr.n_params} params, "
        f"{compressed} compressed in {matrices} matrices; initialised in "
        f"{init_s:.1f} s; shape groups (E,m,n,r) {groups}{note}")
    log(f"    state {sum(state.values()):.2f} GB: params {state['params']:.2f}, "
        f"moments {state['moments']:.2f}, EF {state['ef']:.2f}, Q "
        f"{state['q']:.3f} (allocated {state_bytes / 2**30:.2f} GiB)")
    if want_groups and (sorted(groups) != sorted(want_groups[0])
                        or matrices != want_groups[1]):
        raise AssertionError(f"({label}) groups {groups} ({matrices} "
                             f"matrices) != {want_groups}")
    batches = _family_batches(cfg, batch, seq)
    kernels = _reset_launches()
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    step_ms = _timed_steps(tr, batches, steps)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    # the caching allocator's frees and retries when a request does not fit
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                               0) - retries
    hist = tr.history
    by_hand = _bytes_by_hand(tr)
    syn = [h["bytes_synced"] for h in hist]
    per_step = [b - a for a, b in zip([0] + syn, syn)]
    row = {"label": label, "config": cfg.name, "num_layers": cfg.num_layers,
           "batch": [batch, seq], "init_s": init_s, "groups": groups,
           "matrices": matrices, "compressed_params": compressed,
           "n_params": tr.n_params, "state_gb": state,
           "loss": [h["loss"] for h in hist], "step_ms": step_ms,
           "peak_bytes": peak, "launches": launches,
           "bytes_per_step": per_step, "bytes_by_hand": by_hand,
           "opt_dtype": tr.tcfg.adam.opt_dtype, "alloc_retries": retries}
    if "aux" in hist[0]:
        row["aux"] = [h["aux"] for h in hist]
    for i, (h, ms_, b) in enumerate(zip(hist, step_ms, per_step)):
        aux = f" aux {row['aux'][i]:.4f}" if "aux" in row else ""
        log(f"    step {h['step']} loss {h['loss']:.4f}{aux} {ms_:.1f} ms, "
            f"bytes synced {b} (by hand {by_hand})")
    log(f"    peak {peak / 2**30:.2f} GiB, {retries} allocator retries; "
        f"PowerSGD launches in {steps} steps {launches}")
    if not all(math.isfinite(x) for x in row["loss"] + row.get("aux", [])) \
            or len(hist) != steps:
        raise AssertionError(f"({label}) losses {row['loss']} aux "
                             f"{row.get('aux')}")
    if any(b != by_hand for b in per_step):
        raise AssertionError(f"({label}) bytes synced {per_step} != {by_hand}")
    if any(launches[k] != steps * len(groups) for k in POWERSGD):
        raise AssertionError(f"({label}) launches {launches}: want "
                             f"{len(groups)} a step")
    if profile:
        steady = statistics.median(step_ms[1:])
        row["profile"] = _family_profile(tr, batches, cfg, batch, seq, steady)
        pr = row["profile"]
        log(f"    profiled step: {pr['launches']} kernel launches, device "
            f"busy {pr['busy_ms']:.1f} ms, idle share "
            f"{pr['idle_share']:.3f} of a {steady:.1f} ms step; device ms by "
            f"part { {k: round(v, 2) for k, v in sorted(pr['ms_by_part'].items(), key=lambda kv: -kv[1])} }; "
            f"kernel-running ops by part {pr['ops_by_part']}; largest of the "
            f"rest { {k: round(v, 2) for k, v in pr['rest_largest_ms'].items()} }")
    del tr
    _release()
    return row


def _moe_full(report: dict, dev, profile: bool) -> dict:
    """(l1): qwen3-moe-235b-a22b at its published widths, depth 1."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", "full"),
                              num_layers=1, num_stages=1)
    S = min(cfg.moe_group, 2 * 1024)
    note = (f"; {cfg.num_heads} heads of {cfg.hd}, {cfg.num_kv_heads} kv "
            f"heads, {cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
            f"{cfg.experts_per_token}, vocab {cfg.vocab_size}, depth 1 (of "
            f"94); dispatch groups G = {2 * 1024 // S} of S = {S}, capacity "
            f"C = {moe.capacity_of(cfg, S)}; peak reckoned about "
            f"{MOE_PEAK_RECKONING_GIB} GiB; state donated to the step")
    return _family_full("l1", cfg, 2, 1024, 3, dev, profile,
                        want_groups=(MOE_GROUPS, 388), note=note)


def _dense_full(report: dict, dev) -> list:
    """(l2): the dense configs of 9a, one flat step each at their widths."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    rows = []
    cases = [("qwen2.5-3b", "full", dict(num_layers=4)),
             ("qwen3-32b", "full", dict(num_layers=2, num_stages=2)),
             ("llama3-405b", "reduced", {})]
    log("(l2) llama3-405b runs its reduced config only: one layer at its "
        "published widths holds 57.4 GB of state and its embed and head "
        "58.8 GB, more than the card's 80 GB together")
    for arch, variant, cut in cases:
        cfg = dataclasses.replace(get_config(arch, variant), **cut)
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _trainer(cfg, "fixed", 64, 2, 50, dev)
        groups = [(g.stack_size, g.m, g.n, g.rank) for g in tr._layout.groups]
        batches = SyntheticLM(cfg.vocab_size, 1024, 4, seed=0).batches()
        kernels = _reset_launches()
        step_ms = _timed_steps(tr, batches, 2)
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in tr.history]
        rows.append({"config": cfg.name, "variant": variant, "cut": cut,
                     "groups": groups, "loss": losses, "step_ms": step_ms,
                     "peak_bytes": peak, "launches": launches,
                     "n_params": tr.n_params})
        log(f"(l2) {cfg.name} ({variant}, {cut or 'as published'}): "
            f"{tr.n_params} params, groups {groups}; losses "
            f"{[round(x, 4) for x in losses]}, step ms "
            f"{[round(x, 1) for x in step_ms]}, peak {peak / 2**30:.2f} GiB")
        if not all(math.isfinite(x) for x in losses) or not all(
                launches[k.__name__] > 0 for k in kernels
                if k.__name__ == "ef_lowrank_p"):
            raise AssertionError(f"(l2) {cfg.name}: losses {losses}, "
                                 f"launches {launches}")
        if arch == "qwen3-32b" and not set(QWEN3_CHECK) <= set(groups):
            raise AssertionError(f"(l2) qwen3-32b groups {groups} lack "
                                 f"{QWEN3_CHECK}")
        del tr
        _release()
    return rows


def _route_spy(calls: list):
    """Wrap ``moe.route`` so each call also records its top-k indices and
    dispatch mask on the host."""
    from repro_torch.models import moe
    orig = moe.route

    def spy(x_flat, ffn, cfg, group_size, capacity=None, **kw):
        out = orig(x_flat, ffn, cfg, group_size, capacity, **kw)
        with torch.no_grad():
            xg = out[0]
            probs = torch.softmax(torch.einsum(
                "gsd,de->gse", xg.float(), ffn["router"].float()), dim=-1)
            idx = torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices[..., :cfg.experts_per_token]
        calls.append((idx.cpu(), out[1].cpu()))
        return out
    return orig, spy


def _moe_small(report: dict, dev) -> dict:
    """(l3) the reduced MoE in fp32, card against CPU; (l4) pipelined."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", "reduced"),
                              num_stages=2)
    data = lambda: SyntheticLM(cfg.vocab_size, 64, 4, seed=1).batches()
    out, routes = {}, {}
    for where in ("cpu", dev):
        calls: list = []
        orig, spy = _route_spy(calls)
        tr = _trainer(cfg, "fixed", 8, 3, 50, where)
        batches = data()
        moe.route = spy
        try:
            tr.run(batches, num_steps=1)
        finally:
            moe.route = orig
        tr.run(batches, num_steps=2)
        out[str(where)] = [h["loss"] for h in tr.history]
        routes[str(where)] = calls
        del tr
    cpu, card = out["cpu"], out[str(dev)]
    gap = max(abs(a - b) for a, b in zip(cpu, card))
    pairs = list(zip(routes["cpu"], routes[str(dev)]))
    flips = sum(int((a[0] != b[0]).sum()) for a, b in pairs)
    mask_flips = sum(int((a[1] != b[1]).sum()) for a, b in pairs)
    n_idx = sum(a[0].numel() for a, _ in pairs)
    row = {"cpu_loss": cpu, "card_loss": card, "max_gap": gap,
           "route_calls": len(pairs), "topk_flips": flips,
           "dispatch_flips": mask_flips, "topk_entries": n_idx}
    log(f"(l3) {cfg.name} fp32 (2 stages' layout, flat), 3 steps, card "
        f"{card} cpu {cpu}: max gap {gap:.2e} (tol 5e-3); first step's "
        f"{len(pairs)} route calls: top-k indices differ in {flips} of "
        f"{n_idx}, dispatch masks in {mask_flips} entries"
        + ("" if flips == mask_flips == 0 else
           " -- a routing flip between the devices (finding)"))
    if len(routes["cpu"]) != len(routes[str(dev)]) or not pairs:
        raise AssertionError("(l3) the route calls differ in number")
    if not gap < 5e-3 or not all(math.isfinite(x) for x in card):
        raise AssertionError("(l3) the card's MoE run disagrees with the CPU")
    # (l4) pipelined on LocalPipe, S = 2, 1F1B
    row["pipelined"] = {}
    for micro, bar in ((1, 5e-3), (2, 0.2)):
        kernels = _reset_launches()
        tr = _trainer(cfg, "fixed", 8, 3, 50, dev, pipe=2, schedule="1f1b",
                      num_microbatches=micro, stash_policy="replay")
        hist = tr.run(data())
        losses = [h["loss"] for h in hist]
        g = max(abs(a - b) for a, b in zip(losses, card))
        launches = {k.__name__: k.launches for k in kernels}
        row["pipelined"][micro] = {"loss": losses, "max_gap": g, "bar": bar,
                                   "launches": launches}
        log(f"(l4) {cfg.name} pipe=2 (LocalPipe, 1F1B) M={micro}: losses "
            f"{[round(x, 5) for x in losses]}, max gap to (l3)'s card run "
            f"{g:.2e} (bar {bar}); launches {launches}")
        if not g < bar or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"(l4) M={micro}: gap {g} >= {bar}")
        del tr
    _release()
    return row


def _vlm(report: dict, dev) -> dict:
    """(l5): phi-3-vision at its published widths, depth 8, then the
    launcher's --pipe 2 on the reduced config."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
    from repro_torch.models import vlm
    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b", "full"),
                              num_layers=8)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = _trainer(cfg, "fixed", 64, 2, 50, dev)
    groups = [(g.stack_size, g.m, g.n, g.rank) for g in tr._layout.groups]
    batches = (add_modality_stubs(b, "vlm", num_patches=cfg.num_patches,
                                  d_model=cfg.d_model, seed=0)
               for b in SyntheticLM(cfg.vocab_size, 1024, 4, seed=0).batches())
    first = next(batches)
    probe = tr._device_batch(first)
    with torch.no_grad():
        stream = vlm._embed_multimodal(tr.state["params"], probe["patches"],
                                       probe["tokens"], cfg).dtype
    del probe
    kernels = _reset_launches()
    step_ms = _timed_steps(tr, itertools.chain([first], batches), 2)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in tr.history]
    row = {"config": cfg.name, "groups": groups, "loss": losses,
           "step_ms": step_ms, "peak_bytes": peak, "launches": launches,
           "stream_dtype": str(stream), "n_params": tr.n_params}
    log(f"(l5) {cfg.name} depth 8 (of 32), {cfg.dtype} weights, batch 4 x "
        f"({cfg.num_patches} patches + 1024 tokens): {tr.n_params} params, "
        f"groups {groups}; residual stream {stream} (the reference's "
        f"promotion); losses {[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in step_ms]}, peak {peak / 2**30:.2f} GiB")
    if stream != torch.float32 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(l5) stream {stream}, losses {losses}")
    del tr
    _release()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    tail = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi-3-vision-4.2b", "--variant", "reduced", "--policy", "fixed",
         "--rank", "8", "--pipe", "2", "--micro", "2", "--steps", "4",
         "--batch", "4", "--seq", "64", "--use-kernels"],
        env=env, capture_output=True, text=True, check=True,
        timeout=300).stdout.splitlines()
    row["cli"] = {"seconds": time.perf_counter() - t0, "tail": tail[-6:]}
    log(f"(l5) launch.train --arch phi-3-vision-4.2b --pipe 2 on the card, "
        f"{row['cli']['seconds']:.1f} s:")
    for line in tail[-6:]:
        log(f"    train | {line}")
    steps = [l for l in tail if l.startswith("step ")]
    if len(steps) != 4 or "pipe=2" not in tail[0]:
        raise AssertionError(f"(l5) the launcher's output: {tail}")
    return row


def phase_families(report: dict, dev, profile: bool) -> dict:
    """(l): the MoE, dense and VLM families on the card; returns the
    PowerSGD kernels' launches in (l1)."""
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = {"moe_full": _moe_full(report, dev, profile)}
    rows = []
    for shape in MOE_CHECK + QWEN3_CHECK:
        cases = _cases(*shape, torch.float32, dev)
        for name, c in cases.items():
            rows.append(check_kernel(name, c, shape, torch.float32, False))
            rows[-1]["group"] = "moe" if shape in MOE_CHECK else "qwen3-32b"
            log(f"(l)   {name} at {shape}: {_rates(rows[-1])}")
        del cases
        _release()
    out["kernel_rows"] = rows
    out["dense"] = _dense_full(report, dev)
    out["moe_small"] = _moe_small(report, dev)
    out["vlm"] = _vlm(report, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"(l) families: {out['seconds']:.1f} s")
    report["families"] = out
    return out["moe_full"]["launches"]


# ------------------------------------------- (m) recurrent and enc-dec
# zamba2-7b at depth 28: Mamba2 in_proj and out_proj of 28 layers
ZAMBA_CHECK = [(28, 3584, 14576, 64), (28, 7168, 3584, 64)]
# a Gram-Schmidt panel as wide as in_proj's Q factor (3.73 MB, under the
# 4 MiB limit past which ops hands a panel to linalg.qr): the device slab
ZAMBA_GS_WIDE = (28, 14576, 64)
# tests/test_pipeline.py's ragged hybrid: groups [2, 1] at S = 2
PP_ZAMBA = dict(name="pp-zamba", family="zamba", num_layers=3, d_model=128,
                num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
                ssm_state=16, chunk=16, attn_every=2, num_stages=2)
def _card_against_cpu(dev) -> list:
    """(m4): the three reduced configs in fp32, 3 flat steps each, on the
    card and on the CPU (the kernels' plain versions), losses within 5e-3."""
    from repro_torch.configs import get_config
    rows = []
    for arch in ("xlstm-125m", "zamba2-7b", "whisper-base"):
        cfg = get_config(arch, "reduced")
        out = {}
        for where in ("cpu", dev):
            tr = _trainer(cfg, "fixed", 8, 3, 50, where)
            out[str(where)] = [h["loss"] for h in
                               tr.run(_family_batches(cfg, 4, 64, seed=1))]
            del tr
        cpu, card = out["cpu"], out[str(dev)]
        gap = max(abs(a - b) for a, b in zip(cpu, card))
        rows.append({"config": cfg.name, "cpu_loss": cpu, "card_loss": card,
                     "max_gap": gap})
        log(f"(m4) {cfg.name} fp32, 3 steps: card {[round(x, 6) for x in card]}"
            f" cpu {[round(x, 6) for x in cpu]}, max gap {gap:.2e} (bar 5e-3)")
        if not gap < 5e-3 or len(card) != 3:
            raise AssertionError(f"(m4) {cfg.name}: card {card} cpu {cpu}")
    _release()
    return rows


def _flat_and_piped(cfg, dev, rank: int, steps: int, batch: int, seq: int,
                    bar: float, first_only: bool = False) -> dict:
    """A flat run and an S = cfg.num_stages run on ``LocalPipe`` (1F1B,
    M = 2, replay) of the same config on the card; the pipelined losses
    held to the flat ones (the first only when ``first_only``)."""
    S = cfg.num_stages
    runs, peaks = {}, {}
    for pipe in (None, S):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels = _reset_launches()
        kw = dict(pipe=pipe, schedule="1f1b", num_microbatches=2,
                  stash_policy="replay") if pipe else {}
        tr = _trainer(cfg, "fixed", rank, steps, 50, dev, **kw)
        runs[pipe] = [h["loss"] for h in
                      tr.run(_family_batches(cfg, batch, seq, seed=1))]
        peaks[pipe] = torch.cuda.max_memory_allocated(dev)
        launches = {k.__name__: k.launches for k in kernels}
        del tr
    flat, piped = runs[None], runs[S]
    gaps = [abs(a - b) for a, b in zip(flat, piped)]
    row = {"config": cfg.name, "num_layers": cfg.num_layers, "S": S,
           "flat_loss": flat, "pipe_loss": piped, "gaps": gaps, "bar": bar,
           "flat_peak_bytes": peaks[None], "pipe_peak_bytes": peaks[S],
           "pipe_launches": launches}
    log(f"(m5) {cfg.name} ({cfg.num_layers} layers) pipe={S} (LocalPipe, "
        f"1F1B, M=2) against flat, {steps} steps: pipe "
        f"{[round(x, 5) for x in piped]} flat {[round(x, 5) for x in flat]}, "
        f"gaps {[f'{g:.1e}' for g in gaps]} (bar {bar}"
        f"{', first step' if first_only else ''}); peak flat "
        f"{peaks[None] / 2**30:.2f} GiB, pipelined {peaks[S] / 2**30:.2f} "
        f"GiB; pipelined launches {launches}")
    held = gaps[:1] if first_only else gaps
    if not max(held) < bar or not all(math.isfinite(x) for x in piped):
        raise AssertionError(f"(m5) {cfg.name}: gaps {gaps} >= {bar}")
    if not all(launches[k] > 0 for k in POWERSGD):
        raise AssertionError(f"(m5) {cfg.name}: launches {launches}")
    return row


def _families2_pipelines(dev) -> list:
    """(m5): the three families' stage adapters on LocalPipe at S = 2, fp32
    small configs within 5e-3 of their flat card runs; then zamba2-7b at
    its published widths, depth 14 (2 groups), first loss within 2e-3."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models.model import ModelConfig
    # xlstm-smoke has one pair: two pairs make two stages
    small = [dc.replace(get_config("xlstm-125m", "reduced"), num_layers=4,
                        num_stages=2),
             ModelConfig(**PP_ZAMBA),
             dc.replace(get_config("whisper-base", "reduced"), num_stages=2)]
    rows = [_flat_and_piped(cfg, dev, 8, 3, 4, 64, 5e-3) for cfg in small]
    cfg = dc.replace(get_config("zamba2-7b", "full"), num_layers=14,
                     num_stages=2)
    rows.append(_flat_and_piped(cfg, dev, 64, 2, 4, 1024, 2e-3,
                                first_only=True))
    _release()
    return rows


def _start_all(cmds: list) -> tuple:
    """Start the port's launchers (``python -m <args>``) all at once on the
    card; ``_finish_all`` waits for them. A thread a process records when
    it ended, so a launcher started ahead of its phase reports its own
    seconds, not the time until the phase read it."""
    import threading
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in cmds]
    procs = [subprocess.Popen([sys.executable, "-m", *cmd], env=env,
                              stdout=o, stderr=e, text=True)
             for cmd, (o, e) in zip(cmds, files)]
    ended = [None] * len(procs)

    def watch(i):
        procs[i].wait()
        ended[i] = time.perf_counter() - t0
    threads = [threading.Thread(target=watch, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in threads:
        t.start()
    return cmds, procs, files, threads, ended


def _finish_all(started: tuple, timeout: float = 300) -> list:
    """(seconds, stdout lines) of each launcher ``_start_all`` started,
    raising where one fails or outlasts ``timeout`` from now."""
    cmds, procs, files, threads, ended = started
    out = []
    try:
        for cmd, proc, thread, (o, e), i in zip(cmds, procs, threads, files,
                                                itertools.count()):
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise AssertionError(f"{' '.join(cmd)} still running after "
                                     f"{timeout} s")
            o.seek(0)
            e.seek(0)
            if proc.returncode:
                raise AssertionError(f"{' '.join(cmd)} exited "
                                     f"{proc.returncode}: {o.read()[-3000:]}"
                                     f"{e.read()[-3000:]}")
            out.append((ended[i], o.read().splitlines()))
    finally:
        for proc, (o, e) in zip(procs, files):
            proc.kill()
            o.close()
            e.close()
    return out


def _kill_all(started: tuple) -> None:
    """Stop every launcher ``_start_all`` started (those that ended too)."""
    for proc, (o, e) in zip(started[1], started[2]):
        proc.kill()
        proc.wait()
        o.close()
        e.close()


def _run_all(cmds: list) -> list:
    """Run the port's launchers (``python -m <args>``) all at once on the
    card; (seconds, stdout lines) of each, raising where one fails."""
    return _finish_all(_start_all(cmds))


M6_ARCHS = ("zamba2-7b", "whisper-base")


def _families2_cli_cmds() -> list:
    """(m6)'s launchers: ``--pipe 2`` for the reduced zamba2-7b (a ragged
    [2, 1] plan) and whisper-base (encoder | decoder)."""
    return [["repro_torch.launch.train", "--arch", arch, "--variant",
             "reduced", "--policy", "fixed", "--rank", "8", "--pipe", "2",
             "--micro", "2", "--steps", "4", "--batch", "4", "--seq", "64",
             "--use-kernels"] for arch in M6_ARCHS]


def _families2_cli(runs: list) -> list:
    """(m6): the launchers' runs on the card (``_families2_cli_cmds``,
    started with the phase and run beside it)."""
    rows = []
    for arch, (seconds, tail) in zip(M6_ARCHS, runs):
        rows.append({"arch": arch, "seconds": seconds, "tail": tail[-6:]})
        log(f"(m6) launch.train --arch {arch} --variant reduced --pipe 2 on "
            f"the card, {rows[-1]['seconds']:.1f} s:")
        for line in tail[-6:]:
            log(f"    train | {line}")
        steps = [l for l in tail if l.startswith("step ")]
        if len(steps) != 4 or "pipe=2" not in tail[0]:
            raise AssertionError(f"(m6) the launcher's output: {tail}")
    return rows


def phase_families2(report: dict, dev, profile: bool) -> dict:
    """(m): xLSTM, Zamba2 and Whisper on the card; returns each PowerSGD
    kernel's launches in (m1)-(m3), by config."""
    _release()
    t0 = time.perf_counter()
    # (m6)'s launchers run beside the phase, in processes of their own
    cli = _start_all(_families2_cli_cmds())
    try:
        return _families2_phase(report, dev, profile, cli, t0)
    finally:
        _kill_all(cli)


def _families2_phase(report: dict, dev, profile: bool, cli: tuple,
                     t0: float) -> dict:
    import dataclasses as dc
    from repro_torch.configs import get_config
    zamba = dc.replace(get_config("zamba2-7b", "full"), num_layers=28)
    # xlstm-125m's step is bound by the host (its sLSTM loop launches
    # about 600k kernels a step): two steps
    full = [("m1", get_config("xlstm-125m", "full"), 8, 1024, 2, None),
            ("m2", zamba, 4, 1024, 3, (ZAMBA_CHECK, 56)),
            ("m3", get_config("whisper-base", "full"), 8, 448, 3, None)]
    out = {"full": [], "seconds_by_part": {}}
    clock = time.perf_counter()

    def took(part):
        nonlocal clock
        now = time.perf_counter()
        out["seconds_by_part"][part] = now - clock
        clock = now
    for label, cfg, batch, seq, steps, want in full:
        out["full"].append(_family_full(label, cfg, batch, seq, steps, dev,
                                        profile, want_groups=want))
        took(label)
        if label == "m2":
            out["kernel_rows"] = _zamba_kernels(dev)
            took("m2k")
    out["card_vs_cpu"] = _card_against_cpu(dev)
    took("m4")
    out["pipelines"] = _families2_pipelines(dev)
    took("m5")
    out["cli"] = _families2_cli(_finish_all(cli))
    took("m6")
    out["seconds"] = time.perf_counter() - t0
    log(f"(m) recurrent and encoder-decoder families: {out['seconds']:.1f} s "
        f"(by part { {k: round(v, 1) for k, v in out['seconds_by_part'].items()} })")
    report["families2"] = out
    return {k: {r["config"]: r["launches"][k] for r in out["full"]}
            for k in POWERSGD}


def _zamba_kernels(dev) -> list:
    """(m2k): each PowerSGD kernel against its plain version at Zamba2's
    two groups, fp32, and Gram-Schmidt on 14576 x 64 panels."""
    rows = []
    jobs = [(shape, lambda s=shape: _cases(*s, torch.float32, dev))
            for shape in ZAMBA_CHECK]
    from repro_torch.kernels import ops
    e, m, r = ZAMBA_GS_WIDE
    if any(ops._use_qr(mm, r) for mm in (m, 3584, 7168)):
        raise AssertionError("(m2k) a Zamba2 panel would go to linalg.qr")
    jobs.append(((e, m, 0, r),
                 lambda: {"gram_schmidt": _gs_case(e, m, r, dev)}))
    for shape, make in jobs:
        cases = make()
        for name, c in cases.items():
            rows.append(check_kernel(name, c, shape, torch.float32, False))
            rows[-1]["group"] = "zamba2-7b"
            if name == "gram_schmidt":
                rows[-1]["gs_path"] = rows[-1]["plan"]["path"]
            log(f"(m2k) {name} at {shape}: {_rates(rows[-1])}")
        del cases
        _release()
    return rows


# --------------------------------------------------- (n) elastic outer loop
EL_K, EL_ROUNDS, EL_OUTER_RANK = 2, 4, 32
EL_INJECT = "pod_drop:1@r1,pod_join@r2"
# two pods' state (about 12.7 GB), the outer momentum, EF and deltas (about
# 9 GB) and one step's activations: a reckoning to check, not a bar
EL_PEAK_RECKONING_GIB = (25.0, 35.0)
# benchmarks/elastic_faults.py's model and fault schedules
BENCH_EL = dict(name="bench-el", family="dense", num_layers=2, d_model=128,
                num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
BENCH_EL_FAULTS = {"clean": None, "nan_grad": "nan_grad@7",
                   "corrupt_payload": "corrupt_payload@9",
                   "pod_drop": "pod_drop:1@r2",
                   "pod_join": "pod_drop:1@r1,pod_join@r3"}
BENCH_EL_BYTES = (165132, 657920, 1706496)   # coded, raw, uncompressed a round


def _elastic_fleet(cfg, devices, k: int, rounds: int, inject, ckpt: str,
                   batch_fn, rank: int, outer_rank: int, recovery=None,
                   kernels: bool | None = None):
    """An ElasticTrainer of two pods: inner policy fixed at ``rank``, every
    step logged, AdamW lr 1e-3, kernels on (by default where the pods are
    on the card; a CPU rehearsal may force them); outer policy fixed at
    ``outer_rank``, quant8 wire (the default), window 2."""
    from repro_torch.core import EDGCConfig, GDSConfig
    from repro_torch.core.dac import DACConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.optim.outer import OuterConfig
    from repro_torch.train.elastic import ElasticTrainer
    from repro_torch.train.faults import parse_inject
    from repro_torch.train.trainer import TrainerConfig
    steps = k * rounds
    if kernels is None:
        kernels = torch.device(devices[0]).type == "cuda"
    edgc = EDGCConfig(policy="fixed", fixed_rank=rank, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=10, adjust_limit=4),
                      num_stages=cfg.num_stages, use_kernels=kernels)
    tcfg = TrainerConfig(total_steps=steps, log_every=1, ckpt_path=ckpt,
                         faults=parse_inject(inject) if inject else None,
                         recovery=recovery, use_kernels=kernels,
                         adam=AdamConfig(lr=1e-3, warmup_steps=min(5, steps),
                                         total_steps=steps))
    ocfg = OuterConfig(outer_k=k, policy="fixed", fixed_rank=outer_rank,
                       window=2, total_rounds=rounds)
    return ElasticTrainer(build_model(cfg), edgc, tcfg, ocfg, 2, batch_fn,
                          seed=0, devices=devices)


def _outer_bytes_by_hand(params, plan) -> tuple[int, int]:
    """One outer round's (coded, uncompressed) bytes from the leaf shapes:
    quant8 packs 4 codes a 32-bit word plus one fp32 scale per 1024
    elements of each leaf's payload, (m + n) r per compressed (m, n)
    matrix and every element of the rest; uncompressed is 4 B an element."""
    from repro_torch import tree
    coded = lambda n: 4 * -(-n // 4) + 4 * -(-n // 1024)
    ranks = dict(plan.ranks)
    synced = full = 0
    for path, a in tree.flatten_with_path(params):
        full += 4 * a.numel()
        if path in ranks:
            m, n = a.shape[-2:]
            synced += coded(ranks[path] * (m + n) * (a.numel() // (m * n)))
        else:
            synced += coded(a.numel())
    return synced, full


def _storage(et) -> list[int]:
    from repro_torch import tree
    return [a.untyped_storage().data_ptr()
            for t in [tr.state["params"] for tr in et.pods] + [et.anchor]
            for a in tree.leaves(t)]


def _elastic_full(dev, tmp: str) -> dict:
    """(n1): two pods of (c)'s model on the card through ElasticTrainer."""
    from repro_torch import tree
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.outer import make_outer_sync_step
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    et = _elastic_fleet(
        cfg, [dev, dev], EL_K, EL_ROUNDS, EL_INJECT, os.path.join(tmp, "n1"),
        lambda pod: SyntheticLM(cfg.vocab_size, 1024, 8,
                                seed=1000 * pod).batches(),
        rank=64, outer_rank=EL_OUTER_RANK)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = et.outer.plan
    shapes = {path: tuple(a.shape) for path, a in
              tree.flatten_with_path(et.anchor)}
    groups = sorted({(2 * (math.prod(shapes[p]) // (shapes[p][-2] * shapes[p][-1])),
                      shapes[p][-2], shapes[p][-1], r) for p, r in plan.ranks})
    by_hand = _outer_bytes_by_hand(et.anchor, plan)
    log(f"(n1) elastic: {cfg.name} depth {cfg.num_layers}, 2 pods x K={EL_K} "
        f"on one card, inner fixed rank 64, outer fixed rank {EL_OUTER_RANK} "
        f"quant8, {EL_ROUNDS} rounds, {EL_INJECT}, recovery off; fleet built "
        f"in {init_s:.1f} s; {len(plan.ranks)} compressed outer leaves, "
        f"pod-stacked groups (N L, m, n, r) {groups}; bytes a round by hand "
        f"{by_hand[0]} coded / {by_hand[1]} uncompressed")
    resize_s, outer = [], []
    parts = {"save": [], "build": [], "restore": []}

    def timed(fn, part):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            (resize_s if part is None else parts[part]).append(
                time.perf_counter() - t)
            return out
        return call
    orig_round = et.outer.round
    et.resize = timed(et.resize, None)
    et._build_pods = timed(et._build_pods, "build")
    # the resize's inner checkpoint round trip (a fleet checkpoints nothing
    # else in this run); the class methods come back below
    trainer_cls = type(et.pods[0])
    saved = trainer_cls.save_checkpoint, trainer_cls.restore_checkpoint
    trainer_cls.save_checkpoint = timed(saved[0], "save")
    trainer_cls.restore_checkpoint = timed(saved[1], "restore")

    def counted_round(anchor, deltas):
        before = {k.__name__: k.launches for k in kernels}
        outer.append({})
        if len(outer) == EL_ROUNDS:
            # the last round's inputs, for the outer sync timed alone after
            # the run (held from here on only, so the peak reads the fleet)
            outer[-1]["inputs"] = (deltas, dict(et.outer._comp))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_round(anchor, deltas)
        torch.cuda.synchronize()
        outer[-1]["ms"] = 1e3 * (time.perf_counter() - t)
        outer[-1]["launches"] = {k.__name__: k.launches - before[k.__name__]
                                 for k in kernels}
        return out
    et.outer.round = counted_round
    kernels = _reset_launches()
    round_s, aliasing = [], []
    for _ in range(EL_ROUNDS):
        ptrs = _storage(et)
        aliasing.append(len(ptrs) - len(set(ptrs)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        et.run_rounds(1)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t)
    launches = {k.__name__: k.launches for k in kernels}
    trainer_cls.save_checkpoint, trainer_cls.restore_checkpoint = saved
    ptrs = _storage(et)
    aliasing.append(len(ptrs) - len(set(ptrs)))
    peak = torch.cuda.max_memory_allocated(dev)
    hist = et.history
    row = {"config": cfg.name, "num_layers": cfg.num_layers, "k": EL_K,
           "rounds": EL_ROUNDS, "inject": EL_INJECT, "init_s": init_s,
           "round_s": round_s, "resize_s": resize_s,
           "resize_parts_s": parts, "peak_bytes": peak,
           "peak_reckoning_gib": list(EL_PEAK_RECKONING_GIB),
           "pods": [h["n_pods"] for h in hist],
           "events": [h["membership_events"] for h in hist],
           "pod_losses": [h["pod_losses"] for h in hist],
           "bytes": [[h["bytes_synced"], h["bytes_full"]] for h in hist],
           "bytes_by_hand": list(by_hand), "groups": groups,
           "outer_round_ms": [o["ms"] for o in outer],
           "outer_launches": [o["launches"] for o in outer],
           "launches": launches, "shared_storage": aliasing}
    for h, s_, o in zip(hist, round_s, outer):
        log(f"    round {h['round']} pods {h['n_pods']} loss "
            f"{[round(x, 4) for x in h['pod_losses']]} {s_:.1f} s (outer round "
            f"{o['ms']:.1f} ms, launches {o['launches']}) bytes "
            f"{h['bytes_synced']}/{h['bytes_full']} {h['membership_events']}")
    # the outer sync alone on the last round's inputs, device time
    deltas, comp = outer[-1].pop("inputs")
    stacked = tree.unflatten(deltas[0], [
        torch.stack([d.float() for d in ds])
        for ds in zip(*(tree.leaves(d) for d in deltas))])
    del deltas
    step = make_outer_sync_step(et.outer.mesh, plan, et.outer._edgc.gds,
                                codec=et.outer._codec, use_kernels=True)
    row["outer_sync_ms"] = time_ms(lambda: step(stacked, comp), 2)
    row["outer_sync_profile"] = _device_busy(lambda: step(stacked, comp))
    row["outer_sync_device_ms"] = row["outer_sync_profile"]["busy_ms"]
    del stacked, comp, step
    log(f"    resizes {[round(x, 1) for x in resize_s]} s (checkpoint save "
        f"{[round(x, 1) for x in parts['save']]}, fleet build "
        f"{[round(x, 1) for x in parts['build']]}, restores "
        f"{[round(x, 1) for x in parts['restore']]} s); peak "
        f"{peak / 2**30:.2f} GiB (reckoning {EL_PEAK_RECKONING_GIB[0]:.0f}-"
        f"{EL_PEAK_RECKONING_GIB[1]:.0f}); outer sync alone "
        f"{row['outer_sync_ms']:.1f} ms (device busy "
        f"{row['outer_sync_device_ms']:.1f} ms in "
        f"{row['outer_sync_profile']['launches']} kernels; largest "
        f"{[(t['name'][:40], round(t['ms'], 2), t['count']) for t in row['outer_sync_profile']['top'][:5]]}"
        f"); launches in the run {launches}; tensors shared between pods or "
        f"with the anchor, before each round and after the last: {aliasing}")
    if row["pods"] != [2, 1, 2, 2] or row["events"] != [[], ["pod_drop:1"],
                                                        ["pod_join"], []]:
        raise AssertionError(f"(n1) pods {row['pods']} events {row['events']}")
    if not all(math.isfinite(x) for ls in row["pod_losses"] for x in ls):
        raise AssertionError(f"(n1) losses {row['pod_losses']}")
    if any(b != list(by_hand) for b in row["bytes"]):
        raise AssertionError(f"(n1) bytes {row['bytes']} != {by_hand}")
    if any(aliasing):
        raise AssertionError(f"(n1) shared parameter storage {aliasing}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"(n1) a kernel never launched: {launches}")
    if any(o["launches"][k] != len(plan.ranks)
           for o in outer for k in POWERSGD):
        raise AssertionError(f"(n1) outer launches {row['outer_launches']}: "
                             f"want {len(plan.ranks)} of each a round")
    del et
    _release()
    return row


def _device_busy(fn, top: int = 8) -> dict:
    """Device time of one call of ``fn`` by kernel, under torch.profiler,
    for a call that waits for the device somewhere inside, which
    ``device_ms`` cannot queue behind a sleep (the outer sync does: on an
    H100 two calls took as long to queue as the 13 s sleep before them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return {"busy_ms": sum(ms for _, ms, _ in rows),
            "launches": sum(c for _, _, c in rows),
            "top": [{"name": k[:90], "ms": ms, "count": c}
                    for k, ms, c in rows[:top]]}


def _elastic_kernels(dev, groups: list) -> list:
    """(n2): each PowerSGD kernel against its plain version at (n1)'s
    pod-stacked groups, fp32 (the outer deltas' dtype)."""
    rows = []
    for shape in groups:
        cases = _cases(*shape, torch.float32, dev)
        for name, c in cases.items():
            rows.append(check_kernel(name, c, tuple(shape), torch.float32,
                                     False))
            rows[-1]["group"] = "elastic"
            log(f"(n2) {name} at {tuple(shape)}: {_rates(rows[-1])}")
        del cases
        _release()
    return rows


def _bench_el_runs(dev, tmp: str) -> list:
    """(n3): bench-el's clean and fault schedules, K = 5, 4 rounds, 2 pods,
    on the card (kernels) and on the CPU (plain versions)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import ModelConfig
    from repro_torch.train.faults import RecoveryConfig
    cfg = ModelConfig(**BENCH_EL)
    rows = []
    for name, inject in BENCH_EL_FAULTS.items():
        runs = {}
        for where in ("cpu", dev):
            # a fleet rebuild hands the new pods new data, as the benchmark's
            calls = [0]

            def batch_fn(pod, calls=calls):
                calls[0] += 1
                return SyntheticLM(cfg.vocab_size, 64, 4,
                                   seed=1000 * calls[0] + pod).batches()
            t0 = time.perf_counter()
            et = _elastic_fleet(cfg, [where, where], 5, 4, inject,
                                os.path.join(tmp, f"n3_{name}_{where}"),
                                batch_fn, rank=8, outer_rank=8,
                                recovery=RecoveryConfig(rollback=False))
            hist = et.run_rounds(4)
            runs[str(where)] = {
                "seconds": time.perf_counter() - t0,
                "pods": [h["n_pods"] for h in hist],
                "losses": [h["pod_losses"] for h in hist],
                "bytes": [(h["bytes_synced"], h["bytes_wire_raw"],
                           h["bytes_full"]) for h in hist],
                "recovery": hist[-1]["recovery"],
                "savings": et.outer.comm_savings()}
            del et
        cpu, card = runs["cpu"], runs[str(dev)]
        gap = max(abs(a - b) for la, lb in zip(cpu["losses"], card["losses"])
                  for a, b in zip(la, lb))
        row = {"schedule": name, "inject": inject, "cpu": cpu, "card": card,
               "max_gap": gap}
        rows.append(row)
        log(f"(n3) bench-el {name} ({inject}): pods {card['pods']}, final "
            f"losses card {[round(x, 5) for x in card['losses'][-1]]} cpu "
            f"{[round(x, 5) for x in cpu['losses'][-1]]}, max gap {gap:.2e} "
            f"(bar 5e-3); bytes a round {card['bytes'][0]}; recovery "
            f"{card['recovery']}; {card['seconds']:.1f} s card, "
            f"{cpu['seconds']:.1f} s cpu")
        if not gap < 5e-3 or cpu["pods"] != card["pods"]:
            raise AssertionError(f"(n3) {name}: card {card} cpu {cpu}")
        if any(b != BENCH_EL_BYTES for r in (cpu, card) for b in r["bytes"]):
            raise AssertionError(f"(n3) {name} bytes {card['bytes']} "
                                 f"{cpu['bytes']} != {BENCH_EL_BYTES}")
    by = {r["schedule"]: r["card"] for r in rows}
    checks = {"nan_grad skips a step": by["nan_grad"]["recovery"]["skipped_steps"] >= 1,
              "corrupt_payload resets EF": by["corrupt_payload"]["recovery"]["ef_resets"] >= 1,
              "pod_drop ends at 1 pod": by["pod_drop"]["pods"][-1] == 1,
              "pod_join ends at 2 pods": by["pod_join"]["pods"][-1] == 2}
    log(f"(n3) the benchmark's checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"(n3) {checks}")
    return rows


def _elastic_cli_cmd(tmp: str) -> list:
    """(n4)'s launcher: the elastic flags on the card (``_run_all``'s
    form), its checkpoints and metrics under ``tmp``."""
    return ["repro_torch.launch.train", "--arch", "gpt2", "--outer-k", "3",
            "--pods", "2", "--rounds", "4", "--inject", EL_INJECT,
            "--recover", "--use-kernels", "--ckpt-path",
            os.path.join(tmp, "n4_ckpt", "st"), "--metrics-dir",
            os.path.join(tmp, "n4")]


def _elastic_cli(tmp: str, run: tuple) -> dict:
    """(n4): the launcher's run (``_elastic_cli_cmd``, started with the
    phase and run beside it), then the report on its metrics."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    metrics = os.path.join(tmp, "n4")
    seconds, tail = run
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", metrics], env=env,
        capture_output=True, text=True, check=True,
        timeout=120).stdout.splitlines()
    elastic = [line for line in report if line.startswith("elastic:")]
    log(f"(n4) launch.train --outer-k 3 --pods 2 --rounds 4 --inject "
        f"{EL_INJECT} --recover --use-kernels on the card, {seconds:.1f} s:")
    for line in tail[-7:] + elastic:
        log(f"    | {line}")
    rounds = [line for line in tail if line.startswith("round ")]
    if len(rounds) != 4 or "['pod_drop:1']" not in rounds[1] \
            or "['pod_join']" not in rounds[2] or len(elastic) != 1 \
            or not elastic[0].startswith("elastic: 4 outer rounds, final n_pods=2"):
        raise AssertionError(f"(n4) the launcher's output: {tail} {report}")
    return {"seconds": seconds, "tail": tail[-7:], "elastic": elastic}


def phase_elastic(report: dict, dev) -> dict:
    """(n): the elastic outer loop on the card; returns each PowerSGD and
    pack kernel's launches in (n1)'s run."""
    _release()
    t0 = time.perf_counter()
    out = {"seconds_by_part": {}}
    clock = t0

    def took(part):
        nonlocal clock
        now = time.perf_counter()
        out["seconds_by_part"][part] = now - clock
        clock = now
    with tempfile.TemporaryDirectory() as tmp:
        # (n4)'s launcher runs beside (n1)-(n3), in a process of its own
        cli = _start_all([_elastic_cli_cmd(tmp)])
        try:
            out["full"] = _elastic_full(dev, tmp)
            took("n1")
            out["kernel_rows"] = _elastic_kernels(dev, out["full"]["groups"])
            took("n2")
            out["bench_el"] = _bench_el_runs(dev, tmp)
            took("n3")
            out["cli"] = _elastic_cli(tmp, _finish_all(cli)[0])
            took("n4")
        finally:
            _kill_all(cli)
    out["seconds"] = time.perf_counter() - t0
    log(f"(n) elastic outer loop: {out['seconds']:.1f} s (by part "
        f"{ {k: round(v, 1) for k, v in out['seconds_by_part'].items()} })")
    report["elastic"] = out
    return out["full"]["launches"]


# ------------------------------------------------------------------ (o) serve
GPT2_CACHE_BYTES = 52 * 2 * 8 * 256 * 1920 * 2    # (o1)'s K/V: 818 MB
# (o1): the bf16 decode logits against the bf16 forward's, relative in norm;
# and each against an fp32 forward of the same weights, the decode within
# 1.5x the forward's own distance (max element over the largest logit, as
# tests/_torch_families.bf16_forward_matches holds bf16 on the CPU)
DECODE_BAR = 2e-2
DECODE_FP32_FACTOR = 1.5
SERVE_CARD_CPU_BAR = 5e-3  # (o4): fp32 card against CPU, relative
SERVE_PARTS = ("attention", "mlp", "head")


class _TokenClock:
    """Stands in for a model's ``decode_step``: records a CUDA event after
    each call (no synchronise) and keeps the logits of the first ``keep``
    calls, so ``Engine.generate`` runs unchanged and is timed per token."""

    def __init__(self, model, keep: int = 0):
        self.inner, self.keep = model.decode_step, keep
        self.events: list = []
        self.logits: list = []
        self.model = model._replace(decode_step=self)

    def __call__(self, params, cache, tokens):
        logits, cache = self.inner(params, cache, tokens)
        if len(self.logits) < self.keep:
            self.logits.append(logits.clone())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        return logits, cache

    def ms_per_call(self, first: int, last: int) -> float:
        """Mean ms a call between the ends of calls ``first`` and ``last``."""
        return self.events[first].elapsed_time(self.events[last]) / (last - first)


def _kernel_wrappers() -> list:
    """Every port kernel's counting wrapper."""
    from repro_torch.kernels import entropy_hist, lowrank as lr, pack
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_dkv, flash_dq
    return list(lr.KERNELS + pack.KERNELS) + [flash_fwd, flash_dq, flash_dkv,
                                              entropy_hist.hist_counts]


def _cache_bytes(model, batch: int, max_len: int) -> int:
    """Bytes of a decode cache's tensors (the 0-d length left out)."""
    from repro_torch import tree
    cache = model.init_cache(batch, max_len, device="meta")
    return sum(a.numel() * a.element_size() for a in tree.leaves(cache)
               if a.ndim)


def _draw(model) -> tuple:
    """``model.init`` on the CPU, where the port draws every weight from a
    seeded generator before it moves them: phase (o) runs it on a host
    thread while the card decodes the configuration before."""
    t0 = time.perf_counter()
    params = model.init(0, "cpu")
    return params, time.perf_counter() - t0


def _on_card(drawn, dev) -> tuple:
    """The weights of ``_draw``'s future on the card: (params, seconds
    drawing them, seconds waiting for them and moving them, count)."""
    from repro_torch import tree
    from repro_torch.models.model import param_count
    t0 = time.perf_counter()
    cpu, draw_s = drawn.result()
    params = tree.tree_map(lambda a: a.to(dev), cpu)
    del cpu
    torch.cuda.synchronize(dev)
    return params, draw_s, time.perf_counter() - t0, param_count(params)


def _param_bytes(params) -> int:
    from repro_torch import tree
    return sum(a.numel() * a.element_size() for a in tree.leaves(params))


def _generate(label: str, model, params, batch: int, prompt: int, new: int,
              dev, keep: int = 0) -> tuple[dict, list, np.ndarray]:
    """``Engine.generate`` greedily on ``batch`` seeded prompts of
    ``prompt`` tokens, ``new`` new tokens, timed per token on the device's
    clock: the prompt replay (calls 1 to prompt - 1, past the first) and
    the generation; the peak and the cache's bytes. Returns the row, the
    first ``keep`` calls' logits and the prompts."""
    from repro_torch.serve import Engine, ServeConfig
    cfg = model.config
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    clock = _TokenClock(model, keep)
    eng = Engine(clock.model, params, ServeConfig(max_new_tokens=new),
                 device=dev)
    _release()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    calls = len(clock.events)
    if calls != prompt + new - 1 or out.shape != (batch, new) \
            or out.dtype != np.int32 or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        raise AssertionError(f"({label}) {calls} calls, tokens {out.shape} "
                             f"{out.dtype} in [{out.min()}, {out.max()}]")
    replay_ms = clock.ms_per_call(0, prompt - 1)
    gen_ms = clock.ms_per_call(prompt - 1, calls - 1)
    row = {"label": label, "config": cfg.name, "num_layers": cfg.num_layers,
           "batch": batch, "prompt": prompt, "new": new,
           "replay_ms_per_token": replay_ms, "gen_ms_per_token": gen_ms,
           "tokens_per_s": batch * 1e3 / gen_ms, "wall_s": wall,
           "peak_bytes": peak,
           "cache_bytes": _cache_bytes(model, batch, prompt + new),
           "first_row": out[0][:16].tolist()}
    log(f"({label}) {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) "
        f"Engine.generate batch {batch}, prompt {prompt}, {new} new: replay "
        f"{replay_ms:.3f} ms a token, generation {gen_ms:.3f} ms a token "
        f"({row['tokens_per_s']:.1f} tokens/s), {wall:.2f} s in all; cache "
        f"{row['cache_bytes'] / 1e6:.1f} MB, peak {peak / 2**30:.2f} GiB; "
        f"row 0 {row['first_row']}")
    return row, clock.logits, prompts


def _bench(label: str, eng, batch: int, context: int, dev) -> dict:
    """``decode_benchmark``: ms a token, the cache's bytes, and the peak
    beside what was allocated before it (the parameters)."""
    _release()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    s = eng.decode_benchmark(batch, context)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = eng.model.config
    row = {"label": label, "config": cfg.name, "batch": batch,
           "context": context, "ms_per_token": 1e3 * s, "peak_bytes": peak,
           "base_bytes": base,
           "cache_bytes": _cache_bytes(eng.model, batch, context + 9)}
    log(f"({label}) {cfg.name} decode_benchmark batch {batch}, context "
        f"{context}: {row['ms_per_token']:.3f} ms a token, cache "
        f"{row['cache_bytes'] / 1e6:.1f} MB, peak {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB allocated before)")
    return row


def _decode_profile(model, params, batch: int, max_len: int, dev,
                    token_ms: float) -> dict:
    """One decode token under torch.profiler: kernel launches, device-busy
    ms, the idle share of an unprofiled ``token_ms`` token, and device ms
    by part: ``layers.attn_decode`` (projections, cache write, scores,
    softmax, values), ``layers.mlp_apply``, ``transformer.final_logits``
    (final norm and the tied head), each under a ``record_function`` range,
    and the rest (norms, residual adds, the embedding)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L, transformer as TF
    sites = [(L, "attn_decode", "attention"), (L, "mlp_apply", "mlp"),
             (TF, "final_logits", "head")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]

    def tagged(fn, tag):
        def run(*args, **kw):
            with record_function(tag):
                return fn(*args, **kw)
        return run

    with torch.inference_mode():
        cache = model.init_cache(batch, max_len, device=dev)
        tok = torch.zeros((batch,), dtype=torch.int64, device=dev)
        for _ in range(2):
            _, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize(dev)
        try:
            for (mod, name, fn), (_, _, tag) in zip(saved, sites):
                setattr(mod, name, tagged(fn, tag))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, cache = model.decode_step(params, cache, tok)
                torch.cuda.synchronize(dev)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    parts = {tag: sum(e.device_time_total for e in prof.events()
                      if e.name == tag and e.device_type == DeviceType.CPU)
             / 1e3 for tag in SERVE_PARTS}
    parts["rest"] = busy - sum(parts.values())
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    out = {"launches": sum(e.count for e in rows), "busy_ms": busy,
           "token_ms": token_ms, "idle_share": 1 - busy / token_ms,
           "ms_by_part": parts,
           "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                    "count": e.count} for e in top]}
    log(f"    one decode token profiled: {out['launches']} kernel launches, "
        f"device busy {busy:.3f} ms, idle share {out['idle_share']:.3f} of a "
        f"{token_ms:.3f} ms token; device ms by part "
        f"{ {k: round(v, 3) for k, v in parts.items()} }")
    for r in out["top"]:
        log(f"      {r['ms']:8.3f} ms {r['count']:5d}x  {r['name']}")
    return out


def _serve_gpt2(dev, model, drawn) -> dict:
    """(o1): gpt2-2.5b, all 52 layers, bf16: ``Engine.generate`` greedily,
    batch 8, 128-token prompts, 128 new tokens; the decode logits over the
    prompt against the port's teacher-forced forward; ``decode_benchmark``
    at context 1008 (``max_position`` is 1024); one token profiled."""
    from repro_torch.models.model import build_model
    from repro_torch.serve import Engine
    params, init_s, move_s, n_params = _on_card(drawn, dev)
    B, T, N = 8, 128, 128
    row, logits, prompts = _generate("o1", model, params, B, T, N, dev,
                                     keep=T)
    row.update(init_s=init_s, move_s=move_s, n_params=n_params,
               param_bytes=_param_bytes(params))
    if row["cache_bytes"] != GPT2_CACHE_BYTES:
        raise AssertionError(f"(o1) cache {row['cache_bytes']} B, not "
                             f"{GPT2_CACHE_BYTES}")
    from repro_torch import tree
    plain = build_model(dataclasses.replace(model.config, remat=False))
    wide = build_model(dataclasses.replace(model.config, remat=False,
                                           dtype="float32"))
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=dev)}
        want = plain.forward(params, batch)
        got = torch.stack(logits, dim=1)
        del logits
        norm = lambda a, b: float(torch.linalg.vector_norm(a - b)
                                  / torch.linalg.vector_norm(b))
        row["decode_vs_forward"] = rel_err(got, want)
        row["decode_vs_forward_norm"] = norm(got, want)
        row["argmax_agree"] = float(
            (got.argmax(-1) == want.argmax(-1)).float().mean())
        # the same bf16 weights in fp32: how far each bf16 path lies from it
        truth = wide.forward(tree.tree_map(lambda a: a.float(), params), batch)
        row["forward_vs_fp32"] = rel_err(want, truth)[1]
        row["decode_vs_fp32"] = rel_err(got, truth)[1]
        row["forward_vs_fp32_norm"] = norm(want, truth)
        row["decode_vs_fp32_norm"] = norm(got, truth)
    del got, want, truth
    log(f"    {n_params / 1e9:.3f} B params ({row['param_bytes'] / 1e9:.2f} "
        f"GB), drawn in {init_s:.1f} s, on the card {move_s:.1f} s after "
        f"(o1) asked; decode logits over the prompt "
        f"against the forward: relative in norm "
        f"{row['decode_vs_forward_norm']:.3e} (bar {DECODE_BAR}), max abs "
        f"{row['decode_vs_forward'][0]:.3e}, over the largest logit "
        f"{row['decode_vs_forward'][1]:.3e}; argmax agrees at "
        f"{row['argmax_agree']:.4f} of positions; against the fp32 forward of "
        f"the same weights: decode {row['decode_vs_fp32']:.3e}, forward "
        f"{row['forward_vs_fp32']:.3e} (bar {DECODE_FP32_FACTOR}x; in norm "
        f"{row['decode_vs_fp32_norm']:.3e} and "
        f"{row['forward_vs_fp32_norm']:.3e})")
    if not (row["decode_vs_forward_norm"] < DECODE_BAR
            and row["decode_vs_fp32"]
            < DECODE_FP32_FACTOR * row["forward_vs_fp32"]):
        raise AssertionError(f"(o1) decode against forward {row}")
    eng = Engine(model, params, device=dev)
    row["bench"] = _bench("o1", eng, B, 1008, dev)
    row["profile"] = _decode_profile(model, params, B, T + N, dev,
                                     row["gen_ms_per_token"])
    del params, eng
    _release()
    return row


def _serve_qwen(dev, model, drawn) -> dict:
    """(o2): qwen2.5-3b, all 36 layers, bf16: ``generate`` batch 16, 256-
    token prompts, 64 new; ``decode_benchmark`` at 4096, and the ``long``
    variant's at 32768 (a ring of 8192 slots)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Engine
    params, init_s, move_s, n_params = _on_card(drawn, dev)
    B = 16
    row, _, _ = _generate("o2", model, params, B, 256, 64, dev)
    row.update(init_s=init_s, move_s=move_s, n_params=n_params,
               param_bytes=_param_bytes(params))
    log(f"    {n_params / 1e9:.3f} B params ({row['param_bytes'] / 1e9:.2f} "
        f"GB), drawn in {init_s:.1f} s, on the card {move_s:.1f} s after "
        f"(o2) asked")
    row["bench"] = _bench("o2", Engine(model, params, device=dev), B, 4096,
                          dev)
    long = build_model(get_config("qwen2.5-3b", "long"))
    ring = long.init_cache(1, 32777, device="meta")["stages"][0]["k"].shape[2]
    if ring != long.config.sliding_window:
        raise AssertionError(f"(o2) the long variant's ring has {ring} slots")
    row["bench_long"] = _bench("o2 long", Engine(long, params, device=dev),
                               B, 32768, dev)
    row["profile"] = _decode_profile(model, params, B, 320, dev,
                                     row["gen_ms_per_token"])
    del params
    _release()
    return row


def _serve_whisper(dev, model, drawn) -> dict:
    """(o3) whisper-base as published: the cross K/V of 1500 stub frames
    from ``encdec.init_cache``, then 64 greedy tokens, batch 8."""
    from repro_torch.models import encdec
    cfg = model.config
    params, init_s, move_s, n_params = _on_card(drawn, dev)
    B, N = 8, 64
    frames = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (B, cfg.audio_frames, cfg.d_model)) * 0.1).astype(np.float32)).to(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = encdec.init_cache(cfg, B, N, frames=frames, params=params,
                                  device=dev)
        torch.cuda.synchronize(dev)
        prefill_s = time.perf_counter() - t0
        tok = torch.zeros((B,), dtype=torch.int64, device=dev)
        events, toks = [], []
        for _ in range(N):
            logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        out = torch.stack(toks, dim=1).cpu()
    peak = torch.cuda.max_memory_allocated(dev)
    ms = events[0].elapsed_time(events[-1]) / (N - 1)
    row = {"label": "o3", "config": cfg.name, "num_layers": cfg.num_layers,
           "batch": B, "new": N, "frames": cfg.audio_frames,
           "init_s": init_s, "move_s": move_s, "n_params": n_params,
           "cross_kv_s": prefill_s, "gen_ms_per_token": ms,
           "tokens_per_s": B * 1e3 / ms, "peak_bytes": peak,
           "cross_kv_dtype": str(cache["cross_k"].dtype),
           "cache_bytes": _cache_bytes(model, B, N)
           + 2 * cache["cross_k"].numel() * cache["cross_k"].element_size()}
    log(f"(o3) {cfg.name} ({cfg.encoder_layers} + {cfg.num_layers} layers) "
        f"batch {B}, {cfg.audio_frames} stub frames: cross K/V "
        f"({row['cross_kv_dtype']}) in {prefill_s:.2f} s, then {N} greedy "
        f"tokens at {ms:.3f} ms a token; peak {peak / 2**30:.2f} GiB")
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"(o3) whisper tokens out of range: {out}")
    del params, cache
    _release()
    return row


# (o3): the other families at their published widths, depth cut as named
SERVE_FAMILIES = [("qwen3-moe-235b-a22b", dict(num_layers=1, num_stages=1)),
                  ("phi-3-vision-4.2b", {}), ("xlstm-125m", {}),
                  ("zamba2-7b", dict(num_layers=28)), ("whisper-base", {})]


def _serve_families(dev, models: list, drawn: list) -> list:
    """(o3): one ``generate`` per other family at published widths, batch
    8, 16-token prompts and 16 new tokens (32 decode steps):
    qwen3-moe-235b-a22b at depth 1, phi-3-vision-4.2b with all 32 layers,
    xlstm-125m as published, zamba2-7b at (m2)'s depth of 28 (with the
    reckoning for all 81 layers); then whisper-base (``_serve_whisper``).
    ``models`` and ``drawn`` (futures, taken from the list as they are
    used, so that each host copy is freed) follow ``SERVE_FAMILIES``."""
    from repro_torch.configs import get_config
    rows = []
    for (arch, _), model in zip(SERVE_FAMILIES[:-1], models):
        full = get_config(arch, "full")
        params, init_s, move_s, n_params = _on_card(drawn.pop(0), dev)
        row, _, _ = _generate("o3", model, params, 8, 16, 16, dev)
        row.update(init_s=init_s, move_s=move_s, n_params=n_params,
                   param_bytes=_param_bytes(params))
        note = ""
        if arch == "zamba2-7b":
            from repro_torch import tree
            per_layer = sum(a.numel() * a.element_size() for st in
                            params["stages"] for a in tree.leaves(st)) \
                / model.config.num_layers
            row["reckoned_bytes_all_layers"] = (
                row["param_bytes"] + (full.num_layers - model.config.num_layers)
                * per_layer)
            note = (f"; all {full.num_layers} layers reckoned at "
                    f"{row['reckoned_bytes_all_layers'] / 1e9:.2f} GB")
        log(f"    {n_params / 1e9:.3f} B params ({row['param_bytes'] / 1e9:.2f}"
            f" GB), drawn in {init_s:.1f} s, on the card {move_s:.1f} s "
            f"after (o3) asked{note}")
        rows.append(row)
        del params
        _release()
    rows.append(_serve_whisper(dev, models[-1], drawn.pop(0)))
    return rows


def _serve_card_against_cpu(dev) -> list:
    """(o4): the 11 reduced configs in fp32, and qwen2-0.5b and zamba2-7b
    at ``sliding_window=4`` (a ring that wraps), each decoding a 4-token
    prompt and 16 greedy tokens from the same weights on the CPU and on the
    card; the card is fed the CPU's tokens, so every step's logits compare
    (within 5e-3 relative) and a token flip is a step where the card's
    argmax differs from the CPU's."""
    from repro_torch import tree
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    cases = [(a, get_config(a, "reduced")) for a in sorted(ARCHS)]
    cases += [(a + " ring", dataclasses.replace(get_config(a, "reduced"),
                                                sliding_window=4))
              for a in ("qwen2-0.5b", "zamba2-7b")]
    rows = []
    for name, cfg in cases:
        model = build_model(cfg)
        params = {"cpu": model.init(0, "cpu")}
        params["card"] = tree.tree_map(lambda a: a.to(dev), params["cpu"])
        prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4))
        caches = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            if cfg.family == "whisper":
                frames = torch.from_numpy((np.random.default_rng(1)
                    .standard_normal((2, cfg.audio_frames, cfg.d_model))
                    * 0.1).astype(np.float32))
                caches[where] = encdec.init_cache(
                    cfg, 2, 20, frames=frames.to(d), params=params[where],
                    device=d)
            else:
                caches[where] = model.init_cache(2, 20, device=d)
        tok = torch.as_tensor(prompt[:, 0], dtype=torch.int64)
        worst, flips = 0.0, 0
        with torch.inference_mode():
            for t in range(20):
                cpu, caches["cpu"] = model.decode_step(params["cpu"],
                                                       caches["cpu"], tok)
                card, caches["card"] = model.decode_step(
                    params["card"], caches["card"], tok.to(dev))
                worst = max(worst, rel_err(card.cpu(), cpu)[1])
                nxt = torch.argmax(cpu, dim=-1)
                if t >= 3:
                    flips += int((torch.argmax(card, -1).cpu() != nxt).sum())
                tok = (torch.as_tensor(prompt[:, t + 1], dtype=torch.int64)
                       if t + 1 < 4 else nxt)
        rows.append({"config": name, "max_rel_err": worst,
                     "token_flips": flips})
        log(f"(o4) {name} fp32, 20 decode steps: card against CPU max "
            f"relative error {worst:.2e} (bar {SERVE_CARD_CPU_BAR}), "
            f"{flips} token flips of 34")
        if not worst < SERVE_CARD_CPU_BAR:
            raise AssertionError(f"(o4) {name}: {worst}")
    _release()
    return rows


def _serve_cli(also: list) -> tuple[list, list]:
    """(o5): ``launch.serve`` at qwen2.5-3b's published widths and
    ``launch.serve_decode``, on the card (their default device), both at
    once and beside ``also``'s launchers (a later phase's, run here to
    share the wait), whose (seconds, lines) come back unread."""
    cmds = [["repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--variant",
             "full", "--batch", "4", "--prompt-len", "16", "--new-tokens",
             "32", "--bench-context", "4096"],
            ["repro_torch.launch.serve_decode"]]
    runs = _run_all(cmds + list(also))
    rows = []
    for cmd, (seconds, lines) in zip(cmds, runs):
        rows.append({"cmd": cmd, "seconds": seconds, "lines": lines})
        log(f"(o5) {' '.join(cmd)} on the card, {rows[-1]['seconds']:.1f} s:")
        for line in lines:
            log(f"    serve | {line}")
    serve, decode = rows[0]["lines"], rows[1]["lines"]
    if not (len(serve) == 3 and serve[0].startswith("qwen2.5-3b: ")
            and serve[1].startswith("generated (4, 32) tokens")
            and serve[2].startswith("decode @ context=4096, batch=4: ")):
        raise AssertionError(f"(o5) launch.serve printed {serve}")
    if not (len(decode) == 2 and decode[0].startswith(
            "qwen2 reduced: generated (4, 16)")
            and decode[1].startswith("whisper reduced: decoded [[")):
        raise AssertionError(f"(o5) launch.serve_decode printed {decode}")
    return rows, runs[len(cmds):]


def phase_serve(report: dict, dev, also: list = ()) -> tuple[dict, list]:
    """(o): serving on the card. No port kernel runs there (the reference's
    serving calls no Pallas kernel): every wrapper's count is the same
    after the phase as before it. One host thread draws every
    configuration's weights on the CPU, in order, while the card decodes
    the ones before (``_draw``). ``also``: launchers run beside (o5)'s;
    their results come back with the launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.models.model import build_model
    _release()
    wrappers = _kernel_wrappers()
    before = {w.__name__: w.launches for w in wrappers}
    t0 = time.perf_counter()
    out = {"seconds_by_part": {}}
    clock = t0

    def took(part):
        nonlocal clock
        now = time.perf_counter()
        out["seconds_by_part"][part] = now - clock
        clock = now
    models = [build_model(GPT2_2_5B),
              build_model(get_config("qwen2.5-3b", "full"))]
    models += [build_model(dataclasses.replace(get_config(arch, "full"),
                                               **cut))
               for arch, cut in SERVE_FAMILIES]
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        drawn = [pool.submit(_draw, m) for m in models]
        out["gpt2"] = _serve_gpt2(dev, models[0], drawn.pop(0))
        took("o1")
        out["qwen"] = _serve_qwen(dev, models[1], drawn.pop(0))
        took("o2")
        out["families"] = _serve_families(dev, models[2:], drawn)
        took("o3")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    del drawn
    out["card_cpu"] = _serve_card_against_cpu(dev)
    took("o4")
    out["cli"], extra = _serve_cli(also)
    took("o5")
    launched = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
    out["kernel_launches"] = launched
    if any(launched.values()):
        raise AssertionError(f"(o) serving launched port kernels: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(f"(o) serve: {out['seconds']:.1f} s (by part "
        f"{ {k: round(v, 1) for k, v in out['seconds_by_part'].items()} }); "
        f"no port kernel launched")
    report["serve"] = out
    return launched, extra


# ---------------------------------------------------------- (p) model axis
TP_STEPS = 3


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _state_gap(a, b) -> dict:
    """The largest elementwise difference and the largest relative
    difference in norm over two states' leaves (DTensors gathered)."""
    from repro_torch import tree
    from repro_torch.train.step import full_state
    worst_abs, worst_rel, where = 0.0, 0.0, None
    for (path, x), y in zip(tree.flatten_with_path(full_state(a)),
                            tree.leaves(full_state(b))):
        x, y = x.float(), y.to(x.device).float()
        d = (x - y).abs().max().item() if x.numel() else 0.0
        rel = ((x - y).norm() / y.norm().clamp(min=1e-30)).item()
        worst_abs = max(worst_abs, d)
        if rel > worst_rel:
            worst_rel, where = rel, path
    return {"max_abs": worst_abs, "max_rel_norm": worst_rel, "leaf": where}


def _tp_steps(tr, batches, steps: int) -> dict:
    """``steps`` steps of a trainer's step function on its state: host ms
    to queue each step (before the device finishes it), step ms, losses."""
    step = tr._get_step(False)
    host, total, losses = [], [], []
    for _ in range(steps):
        batch = tr._device_batch(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, mets = step(tr.state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        total.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(mets["loss"]))
    return {"host_ms": host, "step_ms": total, "loss": losses}


def _alloc_site(frames: list) -> str:
    """The innermost frame of the port that allocated a block (file:line
    function), beside the innermost frame of all."""
    inner = frames[0]["name"] if frames else "autograd (no Python frame)"
    for f in frames:
        if f"{os.sep}repro_torch{os.sep}" in f["filename"]:
            return f"{Path(f['filename']).name}:{f['line']} {f['name']} <- {inner}"
    return inner


def _memory_at_peak(run, dev) -> dict:
    """Run ``run()`` with the allocator's history recorded: the bytes
    allocated before it, its peak, and the blocks live at the peak that it
    allocated, summed by ``_alloc_site``; also every block allocated under
    an all-gather (its output), by site."""
    mem = torch.cuda.memory
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem._record_memory_history(max_entries=1_000_000, stacks="python")
    try:
        run()
        torch.cuda.synchronize(dev)
        trace = mem._snapshot()["device_traces"][dev.index or 0]
    finally:
        mem._record_memory_history(enabled=None)
    live, cur, top, at_top, gathers = {}, 0, 0, {}, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > top:
                top, at_top = cur, dict(live)
            if any("all_gather" in f["name"] for f in ev.get("frames", [])):
                site = _alloc_site(ev["frames"])
                gathers[site] = gathers.get(site, 0) + ev["size"]
        elif ev["action"] == "free_completed":
            cur -= ev["size"]
            live.pop(ev["addr"], None)
    by_site: dict = {}
    for ev in at_top.values():
        site = _alloc_site(ev.get("frames", []))
        by_site[site] = by_site.get(site, 0) + ev["size"]
    return {"base_bytes": base,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "traced_peak_bytes": base + top,
            "live_at_peak": dict(sorted(by_site.items(),
                                        key=lambda kv: -kv[1])),
            "gather_bytes": gathers}


def _tp_trainer_pair(dev, mesh) -> dict:
    """(p1): (c)'s run with the per-leaf sync, without and with the mesh,
    3 steps each from the same state (seed); then one more step each under
    the allocator's history, and one more of the mesh run with its
    collectives counted."""
    from repro_torch import tree
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import tp
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    out, flat_end = {}, None
    for label, m in (("flat", None), ("mesh", mesh)):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _trainer(cfg, "fixed", 64, TP_STEPS + 2, 50, dev, bucketed=False,
                      mesh=m)
        batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
        wrappers = _kernel_wrappers()
        for w in wrappers:
            w.launches = 0
        res = _tp_steps(tr, batches, TP_STEPS)
        res["launches"] = {w.__name__: w.launches for w in wrappers}
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["compressed_leaves"] = len(tr.controller.plan.ranks)
        end = {k: tr.state[k] for k in ("params", "opt_m", "opt_v", "comp")}
        if m is None:
            # held on the host, so that the mesh run's peak is its own
            flat_end = tree.tree_map(lambda t: t.detach().to("cpu"), end)
        else:
            out["state_gap"] = _state_gap(end, flat_end)
            flat_end = None
        del end
        # the host's cost of queueing the loss's forward alone (the step's
        # own host time waits for the card: the CUDA embedding backward
        # reads its segment count back to the host)
        batch = tr._device_batch(next(batches))
        fwd = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad(), tp.model_context(m is not None):
                tr.model.loss_fn(tr.state["params"], batch)
            fwd.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        res["forward_host_ms"] = fwd
        # one more step with the allocator's history: what is live at its
        # peak, by the port's line that allocated it
        step = tr._get_step(False)
        batch = tr._device_batch(next(batches))

        def one():
            tr.state, _ = step(tr.state, batch)
        res["memory"] = _memory_at_peak(one, dev)
        if m is not None:
            # one more step, counted: every collective is the model
            # group's (the data group has one process)
            comm = CommDebugMode()
            with comm:
                tr.state, _ = tr._get_step(False)(
                    tr.state, tr._device_batch(next(batches)))
            torch.cuda.synchronize()
            res["collectives"] = {str(k): v for k, v in
                                  comm.get_comm_counts().items()}
            res["collectives_total"] = comm.get_total_counts()
        out[label] = res
        mem = res["memory"]
        log(f"(p1) {label}: one step's peak {mem['peak_bytes'] / 2**30:.2f} "
            f"GiB ({mem['base_bytes'] / 2**30:.2f} before it; traced "
            f"{mem['traced_peak_bytes'] / 2**30:.2f}); live at the peak by "
            f"site, GiB: " + "; ".join(
                f"{k} {v / 2**30:.3f}" for k, v in
                list(mem["live_at_peak"].items())[:8])
            + f"; all-gather outputs by site, GiB: "
            + "; ".join(f"{k} {v / 2**30:.3f}"
                        for k, v in mem["gather_bytes"].items()))
        log(f"(p1) {label}: losses {res['loss']} step ms "
            f"{[round(x, 1) for x in res['step_ms']]} host ms "
            f"{[round(x, 1) for x in res['host_ms']]} (the forward's "
            f"{[round(x, 1) for x in res['forward_host_ms']]}) peak "
            f"{res['peak_bytes'] / 2**30:.2f} GiB")
        del tr
    _release()
    out["loss_gap"] = max(abs(a - b) for a, b in zip(out["flat"]["loss"],
                                                     out["mesh"]["loss"]))
    # the mesh step's extra bytes at its peak, by site (mesh minus flat)
    sites = {**out["flat"]["memory"]["live_at_peak"],
             **out["mesh"]["memory"]["live_at_peak"]}
    extra = {k: out["mesh"]["memory"]["live_at_peak"].get(k, 0)
             - out["flat"]["memory"]["live_at_peak"].get(k, 0) for k in sites}
    out["extra_at_peak"] = dict(sorted(((k, v) for k, v in extra.items() if v),
                                       key=lambda kv: -abs(kv[1])))
    log("(p1) mesh minus flat, live at the peak by site, GiB: " + "; ".join(
        f"{k} {v / 2**30:+.3f}" for k, v in
        list(out["extra_at_peak"].items())[:10]))
    launched = out["mesh"]["launches"]
    out["powersgd_per_leaf_step"] = sum(launched[k] for k in POWERSGD) / (
        TP_STEPS * out["mesh"]["compressed_leaves"])
    return out


def _tp_auto(dev, mesh) -> dict:
    """(p2): the auto step (FSDP over data, TP over model, the none plan)
    against the flat dp_tp step with the none plan, 3 steps each from one
    state."""
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.core.compressor import NO_COMPRESSION
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim import adam
    from repro_torch.train.step import (TrainStepConfig, distribute_state,
                                        make_train_step)
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    model = build_model(cfg)
    acfg = adam.AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for label in ("flat", "auto"):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(0, dev)
        ost = adam.init(params, acfg)
        state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
                 "opt_step": ost.step, "comp": {}}
        scfg = TrainStepConfig(mode="dp_tp" if label == "flat" else "auto",
                               policy_plan=NO_COMPRESSION, remat=False,
                               adam=acfg)
        if label == "auto":
            state = distribute_state(state, mesh, fsdp=True)
            step = make_train_step(model, scfg, mesh=mesh)
        else:
            step = make_train_step(model, scfg, psum_mean=lambda x: x)
        batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
        ms, losses = [], []
        for _ in range(TP_STEPS):
            batch = {k: torch.as_tensor(v).long().to(dev)
                     for k, v in next(batches).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        out[label] = {"loss": losses, "step_ms": ms,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        log(f"(p2) {label}: losses {losses} step ms "
            f"{[round(x, 1) for x in ms]} peak "
            f"{out[label]['peak_bytes'] / 2**30:.2f} GiB")
        del state, params, ost, step
    out["loss_gap"] = max(abs(a - b) for a, b in zip(out["flat"]["loss"],
                                                     out["auto"]["loss"]))
    return out


def _tp_embedding(dev, mesh) -> dict:
    """(p3): the vocab-parallel embedding against ``F.embedding`` at
    gpt2-2.5b's vocab and width."""
    import torch.nn.functional as F
    from repro_torch.dist import sharding, tp
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (0.02 * torch.randn((50257, 1920), generator=gen, device=dev)
             ).to(torch.bfloat16)
    tokens = torch.randint(0, 50257, (8, 1024), generator=gen, device=dev)
    grad = torch.randn((8, 1024, 1920), generator=gen, device=dev
                       ).to(torch.bfloat16)
    want_t = table.clone().requires_grad_(True)
    want = F.embedding(tokens, want_t)
    want.backward(grad)
    split = sharding.distribute(table, sharding.to_placements(
        ("model", None), mesh["model"]), mesh["model"])
    split.requires_grad_(True)
    with tp.model_context():
        got = L.embedding(tokens, split)
        got.backward(tp.rewrap(got, grad))
    got_out, got_grad = got.full_tensor(), split.grad.full_tensor()
    res = {"forward_bit_equal": bool(torch.equal(got_out, want)),
           "grad_bit_equal": bool(torch.equal(got_grad, want_t.grad)),
           "forward_err": rel_err(got_out, want),
           "grad_err": rel_err(got_grad, want_t.grad)}
    log(f"(p3) vocab-parallel embedding (50257 x 1920, 8 x 1024 tokens): "
        f"forward bit-equal {res['forward_bit_equal']}, table gradient "
        f"bit-equal {res['grad_bit_equal']} (rel {res['grad_err'][1]:.2e})")
    if res["forward_err"][1] > 1e-2 or res["grad_err"][1] > 1e-2:
        raise AssertionError(f"(p3) vocab-parallel embedding: {res}")
    return res


def _tp_cli_cmd() -> list:
    """(p4)'s launcher: ``--model-mesh 1`` under ``torch.distributed.run``
    on the card (``_run_all``'s form: the arguments after ``-m``)."""
    return ["torch.distributed.run", "--nproc_per_node", "1", "--master-port",
            str(_free_port()), "-m", "repro_torch.launch.train", "--arch",
            "gpt2", "--variant", "reduced", "--model-mesh", "1", "--steps",
            "3"]


def _tp_cli(run: tuple) -> dict:
    """(p4): the launcher's run (``_tp_cli_cmd``; seconds, stdout lines),
    made beside (o5)'s launchers."""
    seconds, lines = run
    out = {"seconds": seconds,
           "lines": [l for l in lines if l.startswith(("step", "gpt2",
                                                       "final"))]}
    log(f"(p4) launch.train --model-mesh 1 under torch.distributed.run "
        f"(beside (o5)'s launchers): exit 0 in {seconds:.1f} s: "
        f"{out['lines']}")
    if not any("mesh data=1 x model=1" in l for l in lines):
        raise AssertionError(f"(p4) launcher printed {lines[-20:]}")
    return out


def phase_tp(report: dict, dev, cli: tuple) -> dict:
    """(p): the model axis on one card (NCCL, world size 1); ``cli`` is
    (p4)'s launcher run (``_tp_cli``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    _release()
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_host_mesh(data=1, model=1, device_type="cuda")
        out = _tp_trainer_pair(dev, mesh)
        m, f = out["mesh"], out["flat"]
        log(f"(p1) mesh against flat: loss gap {out['loss_gap']:.3e} (tol "
            f"5e-3); state {out['state_gap']} (tol 2e-3 in norm); PowerSGD "
            f"launches a compressed leaf a step "
            f"{out['powersgd_per_leaf_step']:.2f} over "
            f"{m['compressed_leaves']} leaves; model-group collectives a "
            f"step {m['collectives_total']} {m['collectives']}; peak "
            f"{m['peak_bytes'] / 2**30:.2f} GiB (flat "
            f"{f['peak_bytes'] / 2**30:.2f}, (c) "
            f"{report['main']['peak_bytes'] / 2**30:.2f})")
        if not out["loss_gap"] < 5e-3:
            raise AssertionError(f"(p1) losses {m['loss']} vs {f['loss']}")
        if not out["state_gap"]["max_rel_norm"] < 2e-3:
            raise AssertionError(f"(p1) state gap {out['state_gap']}")
        if out["powersgd_per_leaf_step"] != 4:
            raise AssertionError(f"(p1) PowerSGD launches {m['launches']}")
        out["auto"] = _tp_auto(dev, mesh)
        if not out["auto"]["loss_gap"] < 5e-3:
            raise AssertionError(f"(p2) auto losses {out['auto']}")
        out["embedding"] = _tp_embedding(dev, mesh)
    finally:
        dist.destroy_process_group()
    out["cli"] = _tp_cli(cli)
    out["seconds"] = time.perf_counter() - t0
    log(f"(p) model axis: {out['seconds']:.1f} s")
    report["tp"] = out
    return out["mesh"]["launches"]


# ------------------------------------- (q) the model axis, every family
# (q1): (arch, cut, batch, seq, steps) at the published widths, the
# depths cut so that the whole script stays within PR 25's time: phi-3-
# vision-4.2b to 4 of 32 layers, zamba2-7b to one group (7 of 81),
# xlstm-125m to 4 of 12, two (mLSTM, sLSTM) pairs (its step is bound by the
# host: about 50k launches a layer; 6 layers until phase (t) came), one
# step each way
Q_FLAT = [("phi-3-vision-4.2b", dict(num_layers=4), 4, 1024, 2),
          ("whisper-base", {}, 8, 448, 2),
          ("zamba2-7b", dict(num_layers=7), 4, 1024, 2),
          ("xlstm-125m", dict(num_layers=4), 8, 1024, 1)]
# the sequence the collectives of one xlstm-125m step are counted at (the
# count does not depend on it: the sLSTM loop issues none per token)
Q_COUNT_SEQ = 256


def _bit_equal(a, b) -> bool:
    """Two states' leaves equal bit for bit (DTensors gathered)."""
    from repro_torch import tree
    from repro_torch.train.step import full_state
    xs, ys = tree.leaves(full_state(a)), tree.leaves(full_state(b))
    return len(xs) == len(ys) and all(
        torch.equal(x.detach().cpu(), y.detach().cpu()) for x, y in zip(xs, ys))


def _q_flat(arch: str, cut: dict, batch: int, seq: int, steps: int, dev,
            mesh) -> dict:
    """(q1): one family at its published widths through the flat trainer
    (per-leaf sync, fixed r64, kernels on) without and with the (data 1,
    model 1) mesh, ``steps`` steps each from the same seed: losses and
    state bit-equal; step and forward host ms both ways, PowerSGD launches
    a compressed leaf a step, one mesh step's collectives, the peaks (both
    with the weights' first draw, held on the card for the second run)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.dist import tp
    from repro_torch.models.model import build_model
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = dataclasses.replace(get_config(arch, "full"), **cut)
    out, flat_end = {"config": cfg.name, "num_layers": cfg.num_layers,
                     "batch": [batch, seq]}, None
    # one draw of the weights on the card starts both runs
    params = build_model(cfg).init(0, dev)
    for label, m in (("flat", None), ("mesh", mesh)):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _trainer(cfg, "fixed", 64, steps + 3, 50, dev, bucketed=False,
                      mesh=m, params=params)
        batches = _family_batches(cfg, batch, seq)
        wrappers = _kernel_wrappers()
        for w in wrappers:
            w.launches = 0
        res = _tp_steps(tr, batches, steps)
        res["launches"] = {w.__name__: w.launches for w in wrappers}
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["compressed_leaves"] = len(tr.controller.plan.ranks)
        end = {k: tr.state[k] for k in ("params", "opt_m", "opt_v", "comp")}
        if m is None:
            flat_end = tree.tree_map(lambda t: t.detach().to("cpu"), end)
        else:
            out["bit_equal"] = _bit_equal(end, flat_end)
            out["state_gap"] = _state_gap(end, flat_end)
            flat_end = None
        del end
        probe = tr._device_batch(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), tp.model_context(m is not None):
            tr.model.loss_fn(tr.state["params"], probe)
        fwd = [1e3 * (time.perf_counter() - t0)]
        torch.cuda.synchronize()
        res["forward_host_ms"] = fwd
        del probe
        if m is not None:
            # one more step, counted: every collective is the model group's
            count = batches if arch != "xlstm-125m" else _family_batches(
                cfg, 1, Q_COUNT_SEQ)
            comm = CommDebugMode()
            with comm:
                tr.state, _ = tr._get_step(False)(
                    tr.state, tr._device_batch(next(count)))
            torch.cuda.synchronize()
            res["collectives"] = {str(k): v for k, v in
                                  comm.get_comm_counts().items()}
            res["collectives_total"] = comm.get_total_counts()
            res["collectives_batch"] = ([batch, seq] if count is batches
                                        else [1, Q_COUNT_SEQ])
        out[label] = res
        log(f"(q1) {cfg.name} depth {cfg.num_layers}, batch {batch} x {seq}, "
            f"{label}: losses {res['loss']} step ms "
            f"{[round(x, 1) for x in res['step_ms']]} host ms "
            f"{[round(x, 1) for x in res['host_ms']]} (the forward's "
            f"{[round(x, 1) for x in fwd]}) peak "
            f"{res['peak_bytes'] / 2**30:.2f} GiB")
        del tr
    del params
    _release()
    m_, f_ = out["mesh"], out["flat"]
    out["loss_gap"] = max(abs(a - b) for a, b in zip(f_["loss"], m_["loss"]))
    out["powersgd_per_leaf_step"] = sum(m_["launches"][k] for k in POWERSGD) / (
        steps * m_["compressed_leaves"])
    log(f"(q1) {cfg.name}: mesh against flat: loss gap {out['loss_gap']} "
        f"and state bit-equal {out['bit_equal']} ({out['state_gap']}); "
        f"PowerSGD launches a compressed leaf a step "
        f"{out['powersgd_per_leaf_step']:.2f} over {m_['compressed_leaves']} "
        f"leaves; model-group collectives a step {m_['collectives_total']} "
        f"(at batch {m_['collectives_batch']}) {m_['collectives']}")
    if not (out["loss_gap"] == 0 and out["bit_equal"]):
        raise AssertionError(f"(q1) {cfg.name}: mesh run not bit-equal: "
                             f"{m_['loss']} vs {f_['loss']}, {out['state_gap']}")
    # P, Q and the decompress once a leaf; Gram-Schmidt where the panel
    # takes it (``kernels.ops._use_qr`` sends the others to QR)
    per = {k: m_["launches"][k] / (steps * m_["compressed_leaves"])
           for k in POWERSGD}
    if any(per[k] != 1 for k in POWERSGD[:3]) or not 0 < per[POWERSGD[3]] <= 1:
        raise AssertionError(f"(q1) {cfg.name}: PowerSGD launches "
                             f"{m_['launches']}")
    return out


def _q_pipe(dev, mesh, j1: dict, j1_leaves: list) -> dict:
    """(q2): (j1)'s run (gpt2-2.5b widths, depth 8, S = 4, M = 4, 1F1B,
    replay, fixed r64, kernels on, LocalPipe) on the (data 1, model 1)
    mesh: its 4 timed steps, with losses and bytes synced equal to (j1)'s
    and the weights and compressor state after them equal bit for bit;
    then (j1)'s profiled step unprofiled, and one more step's host ms."""
    from repro_torch import tree
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.step import full_state
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    S = cfg.num_stages
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    # (j1)'s trainer: 5 steps (the AdamW schedule's length)
    tr = _trainer(cfg, "fixed", 64, 5, 50, dev, pipe=S, schedule="1f1b",
                  num_microbatches=PIPE_M, stash_policy="replay", mesh=mesh)
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    kernels = _reset_launches()
    step_ms = _timed_steps(tr, batches, 4)
    launches = {k.__name__: k.launches for k in kernels}
    hist = tr.history
    # (j1) keeps its state after its 4 timed steps
    st = full_state({k: tr.state[k] for k in ("stage_params",
                                               "shared_params", "comp")})
    named = tree.flatten_with_path([st["stage_params"], st["shared_params"],
                                    st["comp"]])
    differ = [p for (p, a), b in zip(named, j1_leaves)
              if not torch.equal(a.detach().cpu(), b)]
    equal = len(named) == len(j1_leaves) and not differ
    del st, named
    step_ms += _timed_steps(tr, batches, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    tr.state, _ = tr._get_step(False)(tr.state,
                                      tr._device_batch(next(batches)))
    host = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    row = {"loss": [h["loss"] for h in hist][:4],
           "bytes_synced": [h["bytes_synced"] for h in hist][:4],
           "step_ms": step_ms, "host_ms": host,
           "step6_ms": 1e3 * (time.perf_counter() - t0),
           "launches": launches, "peak_bytes": peak, "state_equal": equal,
           "leaves_differing": differ[:8]}
    del tr
    _release()
    log(f"(q2) (j1) on the (data 1, model 1) mesh: losses {row['loss']} "
        f"((j1) {j1['loss']}), bytes synced equal "
        f"{row['bytes_synced'] == j1['bytes_synced']}, state after 4 steps "
        f"bit-equal {equal} {differ[:8]}; step ms {[round(x, 1) for x in step_ms]} "
        f"((j1) {[round(x, 1) for x in j1['step_ms']]}); one more step's "
        f"host ms {host:.1f} of {row['step6_ms']:.1f}; launches {launches}; "
        f"peak {peak / 2**30:.2f} GiB ((j1) {j1['peak_bytes'] / 2**30:.2f})")
    if not (row["loss"] == j1["loss"][:4]
            and row["bytes_synced"] == j1["bytes_synced"][:4] and equal):
        raise AssertionError(f"(q2) mesh run against (j1): {row}")
    if not all(launches[k] > 0 for k in POWERSGD):
        raise AssertionError(f"(q2) launches {launches}")
    return row


def _q_whisper_pipe(dev, mesh) -> dict:
    """(q2): whisper-base whole at S = 2 (its two-tensor boundary) on
    LocalPipe, without and with the mesh, 2 steps each from one seed:
    losses, bytes synced and state bit-equal."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("whisper-base", "full"),
                              num_stages=2)
    runs = {}
    for label, m in (("flat", None), ("mesh", mesh)):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels = _reset_launches()
        tr = _trainer(cfg, "fixed", 64, 2, 50, dev, pipe=2, schedule="1f1b",
                      num_microbatches=2, stash_policy="replay", mesh=m)
        step_ms = _timed_steps(tr, _family_batches(cfg, 8, 448), 2)
        runs[label] = {
            "loss": [h["loss"] for h in tr.history],
            "bytes_synced": [h["bytes_synced"] for h in tr.history],
            "step_ms": step_ms, "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": {k.__name__: k.launches for k in kernels},
            "state": {k: tr.state[k] for k in ("stage_params",
                                                "shared_params", "comp")}}
        if m is None:
            runs[label]["state"] = tree.tree_map(lambda t: t.detach().cpu(),
                                                 runs[label]["state"])
        del tr
    equal = _bit_equal(runs["mesh"].pop("state"), runs["flat"].pop("state"))
    _release()
    row = {**runs, "state_equal": equal}
    log(f"(q2) whisper-base S = 2 on LocalPipe, mesh against none: losses "
        f"{runs['mesh']['loss']} vs {runs['flat']['loss']}, bytes synced "
        f"{runs['mesh']['bytes_synced']}, state bit-equal {equal}; step ms "
        f"{[round(x, 1) for x in runs['mesh']['step_ms']]} vs "
        f"{[round(x, 1) for x in runs['flat']['step_ms']]}; launches "
        f"{runs['mesh']['launches']}")
    if not (runs["mesh"]["loss"] == runs["flat"]["loss"] and equal
            and runs["mesh"]["bytes_synced"] == runs["flat"]["bytes_synced"]):
        raise AssertionError(f"(q2) whisper-base pipelined: {row}")
    return row


def _q_cli_cmds() -> list:
    """(q3)'s launchers in one process each (``_run_all``'s form): the flat
    step with a model axis for the reduced zamba2-7b, and the pipelined
    one (LocalPipe) on a (data 1, model 1) mesh for the reduced gpt2."""
    return [["repro_torch.launch.train", "--arch", "zamba2-7b", "--variant",
             "reduced", "--model-mesh", "1", "--steps", "3"],
            ["repro_torch.launch.train", "--arch", "gpt2", "--variant",
             "reduced", "--pipe", "2", "--micro", "2", "--model-mesh", "1",
             "--steps", "3"]]


def phase_tp_families(report: dict, dev, j1_leaves: list, cli: list) -> dict:
    """(q): the model axis for the other families and beside the pipe axis
    on one card (NCCL, world size 1); ``cli`` is (q3)'s launcher runs,
    made beside (o5)'s. Returns the PowerSGD launches of (q1) (summed over
    the families' mesh runs) and (q2)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    _release()
    t0 = time.perf_counter()
    out: dict = {"seconds_by_part": {}}
    clock = t0

    def took(part):
        nonlocal clock
        now = time.perf_counter()
        out["seconds_by_part"][part] = now - clock
        clock = now
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_host_mesh(data=1, model=1, device_type="cuda")
        out["flat"] = []
        for arch, cut, batch, seq, steps in Q_FLAT:
            out["flat"].append(_q_flat(arch, cut, batch, seq, steps, dev, mesh))
            took(arch)
        out["pipe"] = _q_pipe(dev, mesh, report["pipeline"]["main"], j1_leaves)
        took("j1")
        out["whisper_pipe"] = _q_whisper_pipe(dev, mesh)
        took("whisper_pipe")
    finally:
        dist.destroy_process_group()
    out["cli"] = []
    for cmd, (seconds, lines) in zip(_q_cli_cmds(), cli):
        tail = [l for l in lines if l.startswith(("step", "final"))
                or " params on " in l]
        out["cli"].append({"cmd": cmd, "seconds": seconds, "lines": tail})
        log(f"(q3) {' '.join(cmd)} (beside (o5)'s launchers): exit 0 in "
            f"{seconds:.1f} s: {tail}")
        want = ("mesh data=1 x model=1", "pipe=2" if "--pipe" in cmd else "")
        if not any(all(w in l for w in want) for l in lines) or len(
                [l for l in lines if l.startswith("step")]) != 3:
            raise AssertionError(f"(q3) {cmd} printed {lines[-20:]}")
    out["seconds"] = time.perf_counter() - t0
    log(f"(q) model axis, other families and pipe: {out['seconds']:.1f} s "
        f"(by part { {k: round(v, 1) for k, v in out['seconds_by_part'].items()} })")
    report["tp_families"] = out
    flat = {k: sum(r["mesh"]["launches"][k] for r in out["flat"])
            for k in POWERSGD}
    return {"flat": flat, "pipe": out["pipe"]["launches"]}


# ------------------------------------------------------------ (r) dry run
#: (r1): (c)'s configuration through the dry run's train lowering
R_SPEC = {"seq_len": 1024, "global_batch": 8, "kind": "train"}
#: (r1)'s bar on the dry run's memory against the real step's peak, as
#: PERF.md states it
R_MEMORY_TOL = 0.10
#: (r1)'s bar on the counted FLOPs against FlopCounterMode's
R_FLOP_TOL = 1e-3
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 (PERF.md's peak)


def _dryrun_cli_cmds() -> list:
    """(r2)'s dry runs (``_run_all``'s form) on fake CUDA tensors over fake
    worlds of 256 and 512 ranks: host work only, no card memory."""
    run = ["repro_torch.launch.dryrun", "--arch"]
    qwen = run + ["qwen2.5-3b", "--shape"]
    return [qwen + ["train_4k"], qwen + ["prefill_32k"],
            qwen + ["decode_32k"], qwen + ["train_4k", "--pipe", "4"],
            run + ["qwen2-0.5b", "--shape", "train_4k", "--multi-pod",
                   "--outer-k", "2"]]


def _dryrun_real_step(cfg, dev) -> dict:
    """(r1)'s real step: ``dryrun.train_inputs``'s step and state made on
    the card (a (data 1, model 1) NCCL mesh, world size 1, kernels off),
    one step on a SyntheticLM batch under ``FlopCounterMode``; its peak is
    the allocator's peak over what was allocated before the state."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step, state, batch, _, _ = dryrun.train_inputs(
            cfg, build_model(cfg), mesh, "dp_tp", R_SPEC, "fixed", 64,
            device=dev)
        real = next(SyntheticLM(cfg.vocab_size, R_SPEC["seq_len"],
                                R_SPEC["global_batch"], seed=0).batches())
        batch = {k: torch.as_tensor(real[k]).long().to(dev) for k in batch}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            state, mets = step(state, batch)
        loss = float(mets["loss"])
        torch.cuda.synchronize(dev)
        out = {"flops": float(fc.get_total_flops()),
               "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
               "loss": loss, "ms": 1e3 * (time.perf_counter() - t0)}
        del step, state, batch, mets
    finally:
        dist.destroy_process_group()
    _release()
    return out


def phase_dryrun(report: dict, dev, cli: list) -> None:
    """(r): the dry run (``launch/dryrun.py``). (r1) (c)'s configuration
    through its train lowering on fake CUDA tensors, against one real step
    of it: FLOPs within ``R_FLOP_TOL``, memory within ``R_MEMORY_TOL``,
    and an MFU reading over (c)'s step time. (r2) the CLI's runs
    (``_dryrun_cli_cmds``), made beside (o5)'s launchers (``cli``): each
    exits 0 with an OK line. No port kernel runs."""
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.launch import dryrun
    _release()
    wrappers = _kernel_wrappers()
    before = {w.__name__: w.launches for w in wrappers}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    rec = dryrun.lower_one("gpt2", "r1", device="cuda",
                           mesh_shape={"data": 1, "model": 1}, cfg=cfg,
                           spec=R_SPEC, policy="fixed", rank=64)
    dry_s = time.perf_counter() - t0
    real = _dryrun_real_step(cfg, dev)
    flops, mem = rec["flops_per_chip"], rec["memory"]
    dry_bytes = mem["argument_bytes"] + mem["temp_bytes"]
    flop_gap = abs(flops - real["flops"]) / real["flops"]
    mem_gap = dry_bytes / real["peak_bytes"] - 1
    step_ms = statistics.median(report["main"]["step_ms"][1:])
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    out = {"r1": {"record": rec, "dry_seconds": dry_s, "real": real,
                  "flop_gap": flop_gap, "memory_gap": mem_gap,
                  "c_step_ms": step_ms, "mfu": mfu}}
    log(f"(r1) dry run of (c)'s configuration ({cfg.name} depth "
        f"{cfg.num_layers}, 8 x 1024, fixed r64, bucketed, kernels off) on "
        f"fake CUDA tensors in {dry_s:.1f} s: {flops:.6e} FLOP; the real "
        f"step under FlopCounterMode {real['flops']:.6e} (gap {flop_gap:.2e}, "
        f"tol {R_FLOP_TOL:g}), loss {real['loss']:.4f}, {real['ms']:.1f} ms")
    log(f"(r1) memory: argument {mem['argument_bytes'] / 2**30:.3f} + temp "
        f"{mem['temp_bytes'] / 2**30:.3f} = {dry_bytes / 2**30:.3f} GiB "
        f"against the real step's peak {real['peak_bytes'] / 2**30:.3f} GiB: "
        f"gap {mem_gap:+.4f} (tol {R_MEMORY_TOL:g}); collectives "
        f"{rec['collective_bytes_per_chip']}")
    log(f"(r1) MFU reading on {report['card']}: {flops:.4e} FLOP over (c)'s "
        f"median step {step_ms:.1f} ms (kernels on) = {mfu:.4f} of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s (bf16 dense)")
    if not flop_gap <= R_FLOP_TOL:
        raise AssertionError(f"(r1) counted FLOPs {flops} against "
                             f"FlopCounterMode's {real['flops']}")
    if not abs(mem_gap) <= R_MEMORY_TOL or not math.isfinite(real["loss"]):
        raise AssertionError(f"(r1) dry-run memory {dry_bytes} against the "
                             f"peak {real['peak_bytes']}, loss {real['loss']}")
    out["r2"] = []
    for cmd, (seconds, lines) in zip(_dryrun_cli_cmds(), cli):
        ok = [l for l in lines if l.startswith("OK ")]
        out["r2"].append({"cmd": cmd, "seconds": seconds, "lines": ok})
        log(f"(r2) {' '.join(cmd[1:])} (beside (o5)'s launchers): exit 0 in "
            f"{seconds:.1f} s")
        for line in ok:
            log(f"    {line}")
        if len(ok) != 1 or not all(k in ok[0] for k in (
                "FLOP/chip", "B/chip", "MiB/chip", "GiB/chip")) or not any(
                l.startswith("done: 1 ok, 0 skipped, 0 failed") for l in lines):
            raise AssertionError(f"(r2) {cmd} printed {lines[-20:]}")
    launched = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
    if any(launched.values()):
        raise AssertionError(f"(r) the dry run launched port kernels: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(f"(r) dry run: {out['seconds']:.1f} s ((r2) ran beside (o5)); no "
        "port kernel launched")
    report["dryrun"] = out


# ------------------------------------------------------------- (s) audit
#: (s1)'s host syncs of (c)'s step, ``"op@port line"`` -> why: the phase
#: fails on a sync not listed here, and on a listed one that no longer
#: occurs (then this list and ROADMAP change together). None: the two the
#: audit found (a host scalar copied to the card for the entropy's count,
#: ``core/entropy.py``, and for the EF norm's sum, ``core/powersgd.py``)
#: are made on the card
S_KNOWN_SYNCS: dict[str, str] = {}

#: (s2)'s built-in targets: lint, the flat step's parity and host syncs,
#: two entropy gates, 7 overlapped steps x 3 checks, the trainer's window
S_TARGETS = 27


def phase_audit_step(tr, batches, dev) -> dict:
    """(s1): one more step of (c)'s trainer (its step config, kernels on,
    the donated flat step) with ``analysis.CollectiveSpy`` as the DP mean,
    under ``analysis.CollectiveLog`` with the CUDA sync debug mode: the
    spy against the bucket layout (6 factor calls at rank 64 for the three
    ``MAIN_GROUPS``, one per flat bucket), every host sync by op and port
    line against ``S_KNOWN_SYNCS``, and the PowerSGD launches of the
    step."""
    from repro_torch import analysis
    from repro_torch.kernels import lowrank as lr
    from repro_torch.train.step import make_train_step
    t0 = time.perf_counter()
    tr._get_step(True)
    scfg = tr.step_configs[(tr.controller.plan, True, tr.sync_cfg)]
    spy = analysis.CollectiveSpy()
    step = make_train_step(tr.model, scfg, psum_mean=spy, donate=True)
    batch = tr._device_batch(next(batches))
    _reset_launches()
    rec = analysis.CollectiveLog(sync_debug=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with rec:
        tr.state, mets = step(tr.state, batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1)
    launches = {k.__name__: k.launches for k in lr.KERNELS}
    loss = float(mets["loss"])
    layout = tr._layout
    spy_found = analysis.check_sync_spy(spy, layout, where="(c) step")
    syncs = [f"{h.op}@{h.path}" for h in rec.host_syncs]
    found = analysis.check_host_transfers(rec)
    out = {"spy_calls": len(spy.sync_calls),
           "spy_factor": len(spy.factor_calls),
           "spy_flat": len(spy.flat_calls), "ranks": spy.factor_ranks(),
           "layout_collectives": layout.num_collectives(),
           "buckets": len(layout.buckets), "host_syncs": syncs,
           "host_sync_how": [h.how for h in rec.host_syncs],
           "findings": [str(v) for v in found + spy_found],
           "launches": launches, "loss": loss, "step_ms": step_ms,
           "collectives": analysis.count_collectives(rec)}
    log(f"(s1) (c)'s step through CollectiveSpy: {out['spy_calls']} sync "
         f"collectives ({out['spy_factor']} factor at ranks {out['ranks']}, "
         f"{out['spy_flat']} flat) against the layout's "
         f"{out['layout_collectives']} (2 x {len(layout.groups)} groups + "
         f"{out['buckets']} buckets); loss {loss:.4f}, {step_ms:.1f} ms under "
         f"the sync debug mode; PowerSGD launches {launches}")
    log(f"(s1) host syncs of the step ({len(syncs)}), by op and port line:")
    for v in found:
        log(f"    {v}")
    for key, why in S_KNOWN_SYNCS.items():
        log(f"    known: {key}: {why}")
    if spy_found or out["spy_factor"] != 2 * len(MAIN_GROUPS) or \
            out["ranks"] != [64]:
        raise AssertionError(f"(s1) the spy against the layout: "
                             f"{[str(v) for v in spy_found]}, {out}")
    if set(syncs) != set(S_KNOWN_SYNCS):
        raise AssertionError(
            f"(s1) host syncs {sorted(set(syncs))} against the known list "
            f"{sorted(S_KNOWN_SYNCS)}: new {sorted(set(syncs) - set(S_KNOWN_SYNCS))}, "
            f"gone {sorted(set(S_KNOWN_SYNCS) - set(syncs))}")
    if not all(n > 0 for n in launches.values()) or not math.isfinite(loss):
        raise AssertionError(f"(s1) launches {launches}, loss {loss}")
    out["seconds"] = time.perf_counter() - t0
    log(f"(s1) audit of (c)'s step: {out['seconds']:.1f} s")
    return out


def _audit_cli_cmd() -> list:
    """(s2)'s audit (``_run_all``'s form): every built-in target on the
    card, the CLI's default device."""
    return ["repro_torch.launch.audit"]


def phase_audit_cli(report: dict, run: tuple) -> None:
    """(s2): ``python -m repro_torch.launch.audit`` on the card, run beside
    (o5)'s launchers: exit 0 (``_run_all`` raises otherwise), its
    ``S_TARGETS`` targets listed, ``0 violation(s)``."""
    waited, lines = run
    tail = lines[-1] if lines else ""
    rows = [l for l in lines if l.startswith("  ")]
    # the audit's own time: its targets run one after another, each line
    # ending in "(<seconds>s)"
    seconds = sum(float(l.rsplit("(", 1)[1].rstrip("s)")) for l in rows)
    out = {"seconds": seconds, "waited": waited, "targets": len(rows),
           "last": tail, "lines": lines}
    log(f"(s2) launch.audit on the card (beside (o5)'s launchers): exit 0, "
        f"{tail}, targets {seconds:.1f} s (done within {waited:.1f} s of "
        f"(o5)'s start)")
    for line in rows:
        log(f"    {line.strip()}")
    if lines[:1] != ["collective-safety audit"] or \
            tail != f"{S_TARGETS} target(s), 0 violation(s)" or \
            len(rows) != S_TARGETS:
        raise AssertionError(f"(s2) launch.audit printed {lines[-40:]}")
    report["audit"]["s2"] = out
    report["audit"]["seconds"] = report["audit"]["s1"]["seconds"]
    log(f"(s) audit: {report['audit']['seconds']:.1f} s in the main process "
        f"((s2) ran beside (o5))")


# ------------------------------------------- (t) the pod axis, examples
T_STEPS = 3
#: (t2)'s depth: one layer a stage (DTensor's dispatch makes the pipelined
#: step on a mesh host-bound at about 1 s a step at depth 8, (q2))
T_PIPE_LAYERS = 4


def _t_pair(label: str, cfg, dev, meshes: tuple, **kw) -> dict:
    """Two runs of ``cfg`` from one draw of the weights, ``T_STEPS`` steps
    each: on ``meshes[0]`` and on ``meshes[1]`` (a pod axis of size 1):
    losses, bytes synced and every state leaf held bit-equal; step ms,
    peaks and PowerSGD launches of each."""
    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.step import full_state
    params = build_model(cfg).init(0, dev)
    runs, first = {}, None
    for name, m in zip(("without", "pod"), meshes):
        _release()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _trainer(cfg, "fixed", 64, T_STEPS, 50, dev, mesh=m,
                      params=params, **kw)
        kernels = _reset_launches()
        step_ms = _timed_steps(tr, SyntheticLM(cfg.vocab_size, 1024, 8,
                                               seed=0).batches(), T_STEPS)
        keys = ([k for k in ("stage_params", "shared_params", "params",
                             "opt_m", "opt_v", "opt_step", "comp")
                 if k in tr.state])
        state = {k: tr.state[k] for k in keys}
        runs[name] = {
            "loss": [h["loss"] for h in tr.history],
            "bytes_synced": [h["bytes_synced"] for h in tr.history],
            "step_ms": step_ms, "world": tr.world,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": {k.__name__: k.launches for k in kernels}}
        if first is None:
            first = tree.tree_map(lambda t: t.detach().cpu(),
                                  full_state(state))
        else:
            runs["state_equal"] = _bit_equal(state, first)
            runs["leaves"] = len(tree.leaves(first))
        del tr, state
        r = runs[name]
        log(f"({label}) {name} mesh: losses {r['loss']} step ms "
            f"{[round(x, 1) for x in r['step_ms']]} peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; PowerSGD launches "
            f"{ {k: r['launches'][k] for k in POWERSGD} }")
    del params, first
    _release()
    a, b = runs["without"], runs["pod"]
    log(f"({label}) pod against without: losses equal {a['loss'] == b['loss']}, "
        f"bytes synced equal {a['bytes_synced'] == b['bytes_synced']}, "
        f"{runs['leaves']} state leaves bit-equal {runs['state_equal']}; DP "
        f"world {b['world']}")
    if not (a["loss"] == b["loss"] and a["bytes_synced"] == b["bytes_synced"]
            and runs["state_equal"] and b["world"] == 1):
        raise AssertionError(f"({label}) the pod mesh's run is not bit-equal "
                             f"to the run without it: {runs}")
    if not all(math.isfinite(x) for x in b["loss"]) or not all(
            b["launches"][k] > 0 for k in POWERSGD):
        raise AssertionError(f"({label}) losses {b['loss']}, launches "
                             f"{b['launches']}")
    return runs


def _t_examples_cmds() -> list:
    """(t3)'s launchers (``_run_all``'s form), on the card by default."""
    return [["repro_torch.launch.quickstart"],
            ["repro_torch.launch.train_gpt2_edgc"]]


def _t_examples(runs: list) -> dict:
    """(t3): the two training examples at the reference's step counts
    (quickstart 200 steps, train_gpt2_edgc 300 of none then of edgc), run
    beside phases (m) to (s): finite losses; the quickstart's stage ranks
    out of the DAC's warm-up and DP-sync bytes saved > 0. At its window of
    50 steps train_gpt2_edgc's DAC stays in warm-up for all 300 steps, in
    the reference too (CPU, an Auto-axis mesh: both final losses 4.4806,
    0.0% saved), so its edgc run compresses nothing: held to that, ranks
    empty, the same final loss as the baseline's and nothing saved, or,
    where the ranks leave the warm-up, bytes saved > 0."""
    import re
    (q_s, q), (e_s, e) = runs
    steps = [l for l in q if l.startswith("step")]
    losses = [float(l.split()[3]) for l in steps]
    ranks = [json.loads(l.split("stage-ranks", 1)[1]) for l in steps]
    q_saved = float(re.search(r"saved vs no compression: ([\d.]+)%",
                              "\n".join(q)).group(1)) / 100
    val = lambda pat: float(re.search(pat, "\n".join(e)).group(1))
    out = {"quickstart": {"seconds": q_s, "steps": [int(l.split()[1])
                                                     for l in steps],
                          "loss": losses, "ranks": ranks, "saved": q_saved},
           "train_gpt2_edgc": {
               "seconds": e_s,
               "loss_none": val(r"no-compression final loss : ([-\d.]+)"),
               "loss_edgc": val(r"EDGC +final loss : ([-\d.]+)"),
               "saved": val(r"bytes saved +: ([\d.]+)%") / 100,
               "ranks": json.loads(re.search(r"stage ranks at the end: "
                                             r"(\[[^]]*\])", "\n".join(e)
                                             ).group(1))}}
    t = out["train_gpt2_edgc"]
    t["gap"] = t["loss_edgc"] - t["loss_none"]
    log(f"(t3) quickstart on the card (beside (m) to (s)), exit 0 in "
        f"{q_s:.1f} s: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
        f"{len(steps)} logged steps, stage ranks {ranks[0]} -> {ranks[-1]}, "
        f"bytes saved {q_saved:.1%}")
    log(f"(t3) train_gpt2_edgc on the card, exit 0 in {e_s:.1f} s: final loss "
        f"none {t['loss_none']:.4f}, edgc {t['loss_edgc']:.4f} (gap "
        f"{t['gap']:+.4f}), bytes saved {t['saved']:.1%}, stage ranks "
        f"{t['ranks']}")
    finite = all(math.isfinite(x) for x in losses + [t["loss_none"],
                                                       t["loss_edgc"]])
    left = (len(t["ranks"]) == 4 and t["saved"] > 0) or (
        t["ranks"] == [] and t["saved"] == 0 and t["gap"] == 0)
    if not (finite and len(steps) == 11 and ranks[0] == []
            and len(ranks[-1]) == 4 and q_saved > 0 and left):
        raise AssertionError(f"(t3) examples: {out}")
    return out


def phase_pod(report: dict, dev, cli: list) -> dict:
    """(t): the pod axis of the training mesh on one card (NCCL, world 1):
    (t1) (c)'s run (gpt2-2.5b widths, depth 8, batch 8 x 1024, fixed r64,
    kernels on, bucketed, bf16) on ``make_host_mesh(pod=1, data=1)``
    against the same trainer without a mesh; (t2) the pipelined trainer
    (LocalPipe, S = 4, M = 4, 1F1B, replay) at depth ``T_PIPE_LAYERS`` on
    (pod 1, data 1, model 1) against (data 1, model 1); each bit-equal.
    ``cli`` is (t3)'s example runs, made beside (m) to (s). At world
    1 no DP collective moves a byte: this checks the layout and the
    plumbing. Returns the PowerSGD launches of (t1)'s and (t2)'s pod runs."""
    import torch.distributed as dist
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.launch.mesh import make_host_mesh
    _release()
    t0 = time.perf_counter()
    out: dict = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
        out["t1"] = _t_pair("t1", cfg, dev, (None, make_host_mesh(
            pod=1, data=1, device_type="cuda")))
        t1 = time.perf_counter()
        cfg = dataclasses.replace(GPT2_2_5B, num_layers=T_PIPE_LAYERS)
        out["t2"] = _t_pair(
            "t2", cfg, dev,
            (make_host_mesh(data=1, model=1, device_type="cuda"),
             make_host_mesh(pod=1, data=1, model=1, device_type="cuda")),
            pipe=cfg.num_stages, schedule="1f1b", num_microbatches=PIPE_M,
            stash_policy="replay")
        out["t2"]["num_layers"] = T_PIPE_LAYERS
        out["seconds_by_part"] = {"t1": t1 - t0,
                                  "t2": time.perf_counter() - t1}
    finally:
        dist.destroy_process_group()
    out["t3"] = _t_examples(cli)
    out["seconds"] = time.perf_counter() - t0
    log(f"(t) pod axis: {out['seconds']:.1f} s (by part "
        f"{ {k: round(v, 1) for k, v in out['seconds_by_part'].items()} })")
    report["pod"] = out
    return {"flat": out["t1"]["pod"]["launches"],
            "pipe": out["t2"]["pod"]["launches"]}


def kernels_line(report: dict, launches: dict, pack_launches: dict,
                 pipe_launches: dict, overlap_launches: dict,
                 moe_launches: dict, families2_launches: dict,
                 elastic_launches: dict, serve_launches: dict,
                 tp_launches: dict, tpf_launches: dict,
                 pod_launches: dict) -> dict:
    names = {"lowrank_p": "ef_lowrank_p", "lowrank_q": "ef_lowrank_q",
             "decompress_residual": "decompress_residual",
             "gram_schmidt": "gram_schmidt_panel"}
    out = []
    for name, wrapper in names.items():
        rows = [r for r in report["kernel_rows"]
                if r["kernel"] == name and r["main_path"]]
        total = lambda key: sum(r[key] for r in rows)
        bound_by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "launches": launches[wrapper],
                 "max_abs_err": max(r["max_abs_err"] for r in report["kernel_rows"]
                                    if r["kernel"] == name),
                 "ms": total("ms"), "plain_ms": total("plain_ms"),
                 "bound_ms": total("bound_ms"), "bound_by": bound_by,
                 "library_ms": total("library_ms"),
                 "launches_pipelined": pipe_launches[wrapper],
                 "launches_overlapped": overlap_launches[wrapper],
                 "launches_moe": moe_launches[wrapper],
                 "launches_families2": families2_launches[wrapper],
                 "launches_elastic": elastic_launches[wrapper],
                 "launches_serve": serve_launches[wrapper],
                 "launches_tp": tp_launches[wrapper],
                 "launches_tp_families": tpf_launches["flat"][wrapper],
                 "launches_tp_pipe": tpf_launches["pipe"][wrapper],
                 "launches_audit": report["audit"]["s1"]["launches"][wrapper],
                 "launches_pod": pod_launches["flat"][wrapper],
                 "launches_pod_pipe": pod_launches["pipe"][wrapper]}
        entry["device_ms"] = total("device_ms")
        # (l)'s groups (the MoE's expert stacks, qwen3-32b's mlp) and
        # (m2k)'s (zamba2-7b's Mamba2 projections)
        entry["families"] = [
            {key: r[key] for key in ("group", "shape", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err", "rel_err")}
            for r in report["families"]["kernel_rows"]
            + report["families2"]["kernel_rows"] if r["kernel"] == name]
        # (n2)'s groups: the outer sync's pod-stacked block leaves
        entry["elastic"] = [
            {key: r[key] for key in ("shape", "ms", "device_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err", "rel_err")}
            for r in report["elastic"]["kernel_rows"] if r["kernel"] == name]
        if name == "gram_schmidt":
            # the column chain: cluster size, device ms per column and
            # resident clusters per group; both instances' ptxas numbers
            entry.update(
                clusters=[r["plan"]["cluster"] for r in rows],
                paths=[r["plan"]["path"] for r in rows],
                active_clusters=[r["plan"]["active"] for r in rows],
                ms_per_column=[r["ms_per_column"] for r in rows],
                ptxas={k: {key: v[key] for key in ("registers", "spill_stores",
                                                   "spill_loads")}
                       for k, v in report["build"]["gs_ptxas"].items()})
        if name in ("lowrank_p", "lowrank_q"):
            # ef_factor_kernel: the step's rates, the plan's splits per
            # group, and each instance's ptxas numbers for this product
            kind = name[-1]
            entry.update(
                tflop_per_s=total("flop") / total("ms") * 1e-9,
                gb_per_s=total("nbytes") / total("ms") * 1e-6,
                bound_share=total("bound_ms") / total("ms"),
                splits=[r["plan"]["splits"] for r in rows],
                ptxas={k: {key: v[key] for key in ("registers", "spill_stores",
                                                   "spill_loads")}
                       for k, v in report["build"]["factor_ptxas"].items()
                       if k.startswith(kind + "/")})
        out.append(entry)
    for name, row in report["wire"]["timing"].items():
        out.append({"name": name, "route": "cuda", "source": PACK_SOURCE,
                    "replaces": PACK_REPLACES[name],
                    "launches": pack_launches[name],
                    "launches_pipelined": pipe_launches[name],
                    "launches_elastic": elastic_launches[name],
                    "launches_serve": serve_launches[name],
                    "launches_tp": tp_launches[name],
                    "max_abs_err": float(max(c[name] for c in
                                             report["pack_checks"])),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    # the flash kernels: per call at gpt2-2.5b widths (one layer's
    # attention), errors over every (g) case; the histogram: one pooled sample
    attn = report["attention"]
    outputs = {"flash_fwd": ("attention", "o", "lse"), "flash_dq": ("dq",),
               "flash_dkv": ("dk", "dv")}
    gpt2 = next(iter(attn["timing"].values()))
    for name, keys in outputs.items():
        row = gpt2["rows"][name]
        # the timed call is bf16; fp32 inputs run flash.cu's FMA kernels
        entry = {"name": name, "route": "cuda", "source": BF16_SOURCE[name],
                 "fp32_source": FLASH_SOURCE,
                 "replaces": NEW_REPLACES[name],
                 "launches": attn["launches"][name],
                 "launches_serve": serve_launches[name],
                 "launches_tp": tp_launches[name],
                 "max_abs_err": max(c["max_abs_err"][key]
                                    for c in attn["checks"] for key in keys),
                 **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "tflop_per_s")}}
        if name == "flash_fwd":
            entry.update(sdpa_backend_ms=row["sdpa_backend_ms"])
        else:
            # no library call computes dQ or dK/dV alone; SDPA's backward
            # computes both, beside the pair's sum
            entry.update(pair_ms=gpt2["backward_ms"],
                         pair_library_ms=gpt2["backward_library_ms"])
        out.append(entry)
    hist = report["histogram"]
    out.append({"name": "hist_counts", "route": "cuda", "source": HIST_SOURCE,
                "replaces": NEW_REPLACES["hist_counts"],
                "launches": hist["launches"]["hist_counts"],
                "launches_serve": serve_launches["hist_counts"],
                "launches_tp": tp_launches["hist_counts"],
                "max_abs_err": max(hist[k]["max_abs_err"]
                                   for k in ("pooled", "ragged", "outliers")),
                **{key: hist["timing"][key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path step, raw and quant8 "
                         "(torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's kernels need an NVIDIA "
              "Hopper card", file=sys.stderr)
        return 2
    _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    report: dict = {"card": smi, "torch": torch.__version__}
    t0 = time.perf_counter()
    phase_build(report)
    phase_kernels(report, dev)
    launches, grad_sample = phase_main(report, dev, args.profile)
    phase_control(report, dev)
    pack_launches = phase_wire(report, dev, args.profile)
    phase_check(report, dev)
    phase_attention(report, dev)
    phase_histogram(report, dev, grad_sample)
    del grad_sample
    phase_faults(report, dev)
    j1_state: dict = {}
    pipe_launches = phase_pipeline(report, dev, j1_state)
    # (k) frees its copy of (j1)'s final state; (q2) holds to it too
    j1_leaves = j1_state.pop("state")
    overlap_launches = phase_overlap(report, dev, list(j1_leaves))
    moe_launches = phase_families(report, dev, args.profile)
    # (t3)'s examples run beside (m) and the phases after it, in processes
    # of their own; (t) reads them
    t_cli = _start_all(_t_examples_cmds())
    try:
        families2_launches = phase_families2(report, dev, args.profile)
        elastic_launches = phase_elastic(report, dev)
        # (p4)'s, (q3)'s, (r2)'s and (s2)'s launchers run beside (o5)'s
        q_cmds = _q_cli_cmds()
        serve_launches, (tp_cli, *later_cli) = phase_serve(
            report, dev, also=[_tp_cli_cmd()] + q_cmds + _dryrun_cli_cmds()
            + [_audit_cli_cmd()])
        q_cli, r_cli = later_cli[:len(q_cmds)], later_cli[len(q_cmds):-1]
        audit_cli = later_cli[-1]
        tp_launches = phase_tp(report, dev, tp_cli)
        tpf_launches = phase_tp_families(report, dev, j1_leaves, q_cli)
        del j1_leaves
        phase_dryrun(report, dev, r_cli)
        phase_audit_cli(report, audit_cli)
        pod_launches = phase_pod(report, dev, _finish_all(t_cli))
    finally:
        _kill_all(t_cli)
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report, launches, pack_launches, pipe_launches,
                        overlap_launches, moe_launches, families2_launches,
                        elastic_launches, serve_launches, tp_launches,
                        tpf_launches, pod_launches)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**report, **line}, indent=1))
    log(f"all phases passed in {report['seconds']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
