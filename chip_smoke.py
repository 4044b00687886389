"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on its main paths: the live serving
pool of the paper's five models at full width (MT-WND on its kernel;
CANDLE, ResNet50, VGG19 and DIEN, which run no kernel of ours), the live
serve driver and recovery, RIBBON's own search over the FCFS pool
simulator for the paper's five models, its load-change adaptation (paper
§5.5) over the simulator's warm, routed and telemetry lanes, a streamed
million-query evaluation, the scenario engine's episodes, RIBBON over
H100 serving cells, the serving paths of the ten LMs of the registry at
full width (qwen2.5-3b, dense GQA, with a bf16 and with an int8 KV cache;
mamba2-130m, Mamba-2 SSM; zamba2-2.7b, Mamba-2 with a shared attention
block, also with a prompt longer than its window; minicpm3-4b, MLA;
olmoe-1b-7b, MoE; internvl2-1b, a VLM's patch prefix; whisper-tiny,
encoder-decoder; qwen2-7b, G 7; stablelm-3b, MHA at D 80; mixtral-8x22b,
top-2 MoE cut to 2 layers, with a prompt longer than its window), the
training path of mamba2-130m and internvl2-1b at full width and depth,
and the training of zamba2-2.7b (both kernels in one model), whisper-tiny
(non-causal and cross flash over its frames), olmoe-1b-7b and
minicpm3-4b (MoE and MLA, cut in depth) at full width, in phases that
each print a line and raise on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one nvcc per source, all started together);
3. kernels against their plain PyTorch versions: embedding_bag at the live
   path's shapes (V 200,000, D 64, bag 8, n_bags 1..256), fp32 and bf16,
   weighted and unweighted, indices over the whole vocabulary, over
   [0, 100) and repeated, for one table (V, D) and, bit for bit, for 1
   and 8 stacked tables (T, V, D) in one launch; flash_attention at the
   LM prefill's shape (B 4, S 2000, H 16, KH 2, D 128, causal) and
   window 256, MHA, MQA, D 80, S 1, non-causal S 333, packed q/k/v
   views, S 65, a window of 100 whose edge falls inside a tile, D 80
   non-causal, packed views at D 80, zamba2-2.7b's shared block
   (S 2048, H 32, D 80, window 4096), minicpm3-4b's MLA prefill (H 40,
   D 96, v zero beyond 64), the whisper encoder (S 1500, non-causal), its
   cross attention (S 400 over T 1500, non-causal) and internvl2-1b's
   prefill (H 14 over KH 2: G 7);
   decode_attention at the decode step's shape (B 4, T 2048, KH 2, G 8,
   D 128, the last 48 slots empty) and T 1999, MQA with D 80, MHA, empty
   slots at the front, a cache with no valid slot, T 127 and 193, G 1 at
   D 80 on a wrapped ring, in one split and in 8, 16 splits of which 8 are
   empty, G 32, G 7 at T 2096 (internvl2-1b) and T 1500 every slot valid
   (whisper's cross attention); ssd_scan at mamba2-130m's and zamba2-2.7b's prefill
   shapes (B 4, L 2048; H 24, N 128 and H 80, N 64; P 64, G 1) with x, b
   and c strided views of one packed conv output, a ragged L 2000, L 1,
   G 2 and a ragged P tile; each in fp32 and bf16 (bf16 on the
   tensor-core kernel, fp32 on the scalar one), y and the final state;
   bf16 attention and SSD scan also against the plain version in fp32;
   embedding_bag also on indices outside [0, V) (negative, >= V, the
   int32 extremes), bit for bit; fcfs_scan, bit for bit (QoS counts,
   latencies, start times, final carries), on 64 mtwnd pools x 1500
   queries, a 3-load-factor x 16-pool grid with one service table and
   with a table per row, pools at max_instances, all-zero pools, bursts
   of simultaneous queries with equal service times (ties), and 8, 64 and
   130 slots; then its routed, warm, traced and telemetry flavours, bit
   for bit (the dispatch trace and the telemetry counters too): the four
   named routing policies and a stacked P = 4 policy over 16 mtwnd pools,
   per-row carries on a 3-row grid (cold and routed), the dispatch trace,
   the counters with and without a policy, ties with absent slots, an
   all-zero pool and warm carries, and 130 slots (K = 8) with every flag
   on, and the identity policy against the cold flavour; then cases built
   to catch its vote-and-reduce pick out (one idle slot in the last k,
   every slot idle, a busy minimum tied on slots 7 and 37, routed keys
   negative, -0 and +0, S 40, 130 and 1024, a non-ascending or collapsed
   priority, negative arrivals with a busy key under an idle one), cold
   and with the trace and counters on; then its stream flavour bit for
   bit (final carry and count) on chunks of mtwnd's stream: cold, chained
   from a carry, the 10,000-query stream's partial last chunk, a rebase's
   shift, a bucketed table, S 8, 40 and 1024, batch rows outside the
   table (clamped), and StreamingSimulator's empty pool and empty stream
   on the card (no launch); and the bf16 attention and
   SSD-scan kernels on inputs they cannot read in place
   (ROADMAP C-F2: flash and decode attention at D 36 and D 100, ssd_scan
   at P 50, N 20, and views offset by one element), padded or copied by
   the wrappers, against the plain versions with the gates above, each
   timed beside an aligned call of the padded width;
4. MT-WND full-width forward, kernel path against plain path, per batch
   bucket 1..32, with forward times: eager (CUDA events, median of 30) and
   device-only (replayed from a CUDA graph, so without the host's launch
   cost);
4b. CANDLE, ResNet50, VGG19 and DIEN at full width, fp32 (TF32 off), per
   batch bucket 1..32: the card's output against a float64 copy of the
   same module on the card, and at bucket 2 against the same weights'
   forward on the CPU (each within 1e-3 x max |out|); eager (median of
   single runs, CUDA events) and device-only (CUDA graph) times, the fp32
   floor (``torch.utils.flop_counter``'s operations at 67 TFLOP/s), the
   weights' bytes;
5. live serving: ClusterEngine over three full-width cell types serves 80
   requests; prints the QoS rate and service percentiles;
6. RIBBON's ask/tell loop over the live pool (up to 16 rounds), and its GP
   posterior on the card against the same fit on the CPU;
5b. phase 5 for CANDLE, ResNet50, VGG19 and DIEN: each ClusterEngine warmed
   up, 80 requests at 150 qps on (1, 1, 1) within 30 ms, QoS and service
   percentiles, the memory its cells' weights hold;
6b. the serve driver, ``repro_torch.launch.serve.serve`` with the
   reference's defaults (60 queries at 40 qps, QoS within 200 ms against
   0.9, bounds (4, 3, 2), budget 12) for the five models: best pool, price,
   samples; then on mtwnd and vgg19 the recovery of
   ``examples/serve_cluster.py`` (``launch.serve.recover``: the incumbent's
   most-deployed type lost past its count, ``recover_from_failure`` with
   budget 10), gated: the new optimum fits the reduced bounds and meets the
   target, or the event says that none does;
7. RIBBON's search path (the quickstart) on the card: ``make_paper_setup``
   for each of the five paper models, the homogeneous optimum
   (``best_homogeneous``); for mtwnd also ``run_ribbon`` (budget 80, start
   (5, 0, 0)) and the exhaustive optimum; each held against the same path
   run on the CPU in this process: the same configs in the same order,
   the same QoS rates bit for bit, the same pools;
7b. RIBBON's load-change adaptation (paper §5.5) with the simulator on the
   card, and again on the CPU in this process, every result equal (rates
   and telemetry bit for bit): ``examples/autoscale_loadchange.py`` (the
   base-load search, the monitor's detection of the 1.5x load, the
   incumbent's QoS, the sequential ``rescale(budget=40)``), then the warm
   anchor under ``policy=None`` and ``"hedged"`` (the base pool's segment
   with telemetry, its carry after 1000 queries, ``rescale(budget=40,
   load_factors=[1.0, 1.5], warm_state=..., deployed=base,
   policy=...)``), the base and new pools' warm telemetry under both loads
   and ``tail_latency(base, 99)``; the BO's GP on the host in both runs;
7c. streaming: ``StreamingSimulator`` on mtwnd's (2, 3, 3) at 800 qps in
   chunks of 4096, 10,000 queries on the card and on the CPU (equal,
   0.9821), 1,000,000 on the card (981,041 within QoS, no rebase, one
   stream launch a chunk: 245 and no other launch; the host-clock time
   and its share spent making chunks printed), and (1, 0, 0) at 0.05 qps
   over 3 x 4096 + 100 queries on card and CPU (1.0, 4 rebases);
7d. RIBBON over pools of H100 serving cells (``serving.cells``, the
   reference's ``bench_tpu_cells`` procedure over ``H100_CELLS``, modelled
   rates): homogeneous baseline, exhaustive optimum, RIBBON's pick and
   samples; host code, printed, not gated;
8. LM serving, for each of the eight LMs, with random weights (and a
   VLM's patch or whisper's frame embeddings) from a seed: 4 requests
   (2000 prompt tokens, max_len 2048 for qwen2.5-3b with either cache;
   2048 and 2096 for the SSM, hybrid, MLA and MoE LMs, so the SSM LMs'
   plain path runs the reference's 256-token chunks; 256 patches and 1792
   tokens, 2096, for internvl2-1b; 1500 frames and 400 tokens, 448, for
   whisper-tiny), prefill then 48 greedy decode steps; qwen2-7b and
   stablelm-3b as qwen2.5-3b, 16 steps; the window that binds, B 1, a
   4608-token prompt (max_len 4672) into the 4096-slot ring of the
   window, 64 steps each over the full, wrapped ring: mixtral-8x22b at
   full width cut to 2 layers, zamba2-2.7b at full depth (the ring's
   positions and slots gated after the prefill and after the last step:
   exactly the last 4096 positions, p in slot p mod 4096; the oldest and
   newest printed).
   First in fp32, the kernel path against the plain path teacher-forced on
   the kernel path's tokens (prefill and every step's logits within 1e-4 x
   max |logits|, the same greedy tokens); then in bf16, the reference's
   serving type, twice, with prefill ms, decode ms per step and tokens/s
   of the second, the kernel path's agreement with the plain path's greedy
   tokens, and each bf16 path's agreement with the fp32 kernel path's
   tokens (printed); then device-only prefill and decode-step times from
   CUDA graphs (the qwen2-7b, stablelm-3b and windowed runs keep the
   gates and leave out the agreements and the CUDA graphs, for the
   smoke's time).  For the SSM and hybrid LMs the fp32 gate widens by the
   plain path's own distance from a run whose chunked scan is float64;
   for the MoE LMs the plain path runs the kernel path's expert picks
   (``RoutingTape``; the tokens whose own picks differ are counted); their
   bf16 serving holds every MoE router in float32;
8b. training (``repro_torch.launch``), mamba2-130m (the SSD-scan kernel)
   and internvl2-1b (flash attention; its Qwen2-0.5B backbone on tokens
   alone) at full width and depth, random weights from seed 0, B 4 x S
   2048 of the synthetic token stream of seed 0: (a) one fp32 (TF32 off)
   ``make_train_step`` on the kernel path against one on the reference's
   math (``use_kernel=False``) from the same weights and batch, the loss
   within 1e-5 relative and each leaf's gradient within 1e-4 x its max
   |g| (for mamba2-130m widened by twice the plain path's own distance
   from a step whose chunked scan is float64); (b) ``train()`` for 20
   bf16 steps (fp32 master) in 2 microbatches with an async checkpoint at
   step 10, then a run resumed from it: steps 11-20 equal bit for bit,
   the mean loss of steps 16-20 below steps 1-5's; (c) 20 timed bf16
   steps (eager, CUDA events), a microbatch's forward and backward, peak
   memory, launches a step;
8c. training of the other families through ``make_train_step`` at full
   width, bf16 with the float32 master, 2 microbatches, random weights from
   seed 0 (``TRAIN_ROWS``): zamba2-2.7b at full depth (54 Mamba-2 layers
   through ``ssd_scan``, the shared block's 9 flash calls), B 4 x S 2048;
   whisper-tiny, B 4 x its 448 decoder positions over 1500 stub frames
   (N(0, 0.5^2) from seed 0; non-causal flash in the encoder, causal self
   and S 448 x T 1500 cross flash in the decoder); olmoe-1b-7b cut to 4 of
   16 layers (64 experts, top 8) and minicpm3-4b to 16 of 62 (MLA, flash on
   q/k/v zero-padded to D 96), B 4 x S 2048: (a) phase 8b's fp32 gate
   (zamba2-2.7b's at 12 layers, widened by twice its fp64-scan noise;
   olmoe-1b-7b's and minicpm3-4b's at 2; olmoe-1b-7b's plain step replays
   the kernel step's expert picks, forward and recompute, every one used
   once, the flips printed); (b), (c) 10 timed bf16 steps whose mean loss
   over steps 6-10 lies below steps 1-5's, a microbatch's forward and
   backward, peak memory, launches a step;
10. the mesh layer (``launch.mesh``, ``launch.sharding``):
   ``make_local_mesh()`` is the 1 x 1 ("data", "model") mesh on cuda:0,
   ``make_production_mesh()`` raises on one card (its message printed);
   for each 8b model ``train()`` for 3 bf16 steps at 8b's shape and
   arguments with ``mesh=None`` and with the local mesh: losses, every
   parameter and the AdamW state (master and moments: every gradient)
   equal bit for bit, the losses also 8b's first 3; every parameter
   leaf's sharding replicated; launches held as 8b holds them;
11. the roofline (``repro_torch.roofline``) of every path phases 8 and 8b
   time, walked on the meta device with the same calls at the same shapes
   (each timed LM's bf16 prefill and one decode step, each model's bf16
   train step) in a CPU process started after phase 2, beside the card's
   work, and read here: flops, HBM bytes, compute and memory terms on one H100 beside
   the measured time (device-only; training eager), gated: (a) the walk's
   flops on the plain path (``use_kernel=False``) equal
   ``FlopCounterMode``'s for the same call, (b) each kernel's formula at
   ``PERF.md`` §6's shapes equals its closed form computed here, (c) no
   measured time below its path's compute term; the memory term is
   printed, not gated (an eager op's operands may be served from L2);
12. the multi-device half on one card: (a) the simulator's grid lane
   sharded over ``simulator.lane_devices`` forced to 4 x cuda:0 (and over
   the real cards where there are two or more), eight shapes of mtwnd's
   grid (W 3 and 4 workload-split, W 1 x B 63 lane-split with pad 1,
   stacked tables, policy folds of P 2 and 3) bit for bit against the
   unsharded dispatch on the card and the CPU's plain scan, phase 7b's
   warm anchors through the forced lanes, one sharded dispatch timed
   beside one on one lane; (b) 4 ranks (``launch.mesh.run_ranks``; on
   one card all on cuda:0 over gloo, their collectives staged through
   pinned host memory; with a card a rank, NCCL) on a (2, 2) ("data",
   "model") mesh serve olmoe-1b-7b at full width, the parameters placed
   by ``param_shardings``, the cache by ``cache_shardings`` and the
   tokens by ``data_sharding``: in fp32 cut to 4 layers, prefill 4 x
   2048 and 8 decode steps with ``moe_buffer_shard`` "none"
   (expert-parallel) and "local", each within 1e-4 x max |logits| of the
   one-rank run with the same greedy tokens (its expert picks replayed,
   C-R31; for "local" the one-rank run takes each MoE layer per data
   shard, as the local layer does, C-R37); then bf16 cut to 8 of its 16
   layers, prefill and decode steps timed, peak memory a rank; (c) mamba2-130m
   at full width trained on the 4 ranks (B 4 x S 2048): cut to 6 layers,
   one fp32 ``train(mesh=)`` step against the one-card step and against a
   float64 witness of it (loss within 1e-5; each leaf's gradient within
   1e-4 x its max |g| plus twice the one-card step's own distance from
   the witness, phase 8b's rule), then 1 bf16 step at full depth timed;
   (b') the 4
   ranks on a (1, 4) mesh, whose "model" axis does not divide the 2 KV
   heads (``sharding.split_heads`` gathers them, ROADMAP C-F6), serve
   qwen2.5-3b at full width in fp32 cut to 4 layers, prefill 4 x 2048
   and 8 decode steps within 1e-4 x max |logits| of the one-rank run
   with the same greedy tokens; (b'') on the same (1, 4) mesh, zamba2-2.7b
   at full width in fp32 cut to its first 6 Mamba-2 layers and the shared
   block, prefill 4 x 2048 and 8 decode steps, each step's Mamba-2 layers
   on each rank's 20 of the 80 SSM heads with in_proj and out_proj split
   over "model" (ROADMAP F-6a), within 1e-4 x max |logits| of the
   one-rank run with the same greedy tokens, the state split by heads,
   its staged collectives printed by kind; (c') mamba2-130m at full width cut to 4
   layers, bf16 ``train(mesh=)`` on the (2, 2) mesh, B 4 x S 512: 4
   steps with a checkpoint at steps 2 and 4 (each sharded leaf gathered,
   rank 0 writes), the step-4 one removed as if the run had been cut
   after step 2, then a resume for 2 more, bit for bit against the
   4-step run (losses, parameters, AdamW state), the gather's bytes and
   the save and restore times printed; (d) the multi-pod dry run
   (``launch.dryrun``) in a subprocess on the CPU: (b')'s and (b'')'s
   calls at their configurations, layers, batch, prompt and steps walked
   on the meta device over torch's fake group of 4 at (1, 4), each one's
   collectives by kind equal to those rank 0 staged through host memory
   in it;
   then qwen2.5-3b's ``decode_32k`` cell at the (16, 16) and
   (2, 16, 16) production meshes (fake groups of 256 and 512): per-device
   flops, bytes, collective bytes, the dominant term, the walk's
   seconds;
9. the scenario engine (``repro_torch.scenario``) over mtwnd's simulator
   plane, the engine's GP on the host: diurnal-day at n 2000 / window
   400, spot-churn and tier-outage (the tiered plane: ``serving/fault.py``
   and ``serving/tiers.py``) at n 500, on the card and on the CPU, equal
   reports at their anchors; then diurnal-day at full size (1,000,000
   queries, ``stream_chunk`` 4096) on the card at its anchors;
9b. the scenario engine over ``LivePlane``: spot-churn through a live
   ClusterEngine of the first two cell types (bounds (3, 2), streams at 40
   qps, 30-query probes, QoS within 30 ms) on mtwnd at n 500 and vgg19 at
   n 200, the engine's GP on the card; gated: the plane is "live", the
   phases and windows are the spec's, every window's, the last phase's and
   the episode's QoS equal the share of the engine's own records within
   30 ms (each committed segment's records, as the serve left them),
   no phase sweep, waits >= 0, at least one probe.

Launch counts are set to 0 just before phase 5 and read after phase 6
(every MT-WND forward makes one embedding-bag launch for its 8 tables),
set to 0 again just before phase 7 and read after it (one fcfs_scan
launch per simulator dispatch, and no other kernel), again just before
phase 7b and read after it (one fcfs_scan launch per simulator dispatch,
each of the cold, policy, telemetry and trace flavours launched, and no
other kernel), again just before phase 7c and read after it (one
stream-flavour launch per chunk, and no other launch), again just before
phase 9 and read after it (one fcfs_scan launch per plane dispatch,
printed by flavour, and no other kernel), again just before phase 5b and
read after it (no launch of any kernel of ours), just before each model's
serve driver in phase 6b and read after its recovery (embedding_bag for
mtwnd only, no other kernel), and just before each episode of phase 9b and
read after it (embedding_bag for mtwnd only, no fcfs_scan: the live plane
dispatches on the host), before each part of phase 8b and read after it
(per microbatch one launch of the model's kernel a layer in the forward
and one in remat's recompute, the fp32 step's in float32, the rest in
bfloat16; none on the plain paths), before each run of phase 10 and read
after it (as phase 8b's bf16 runs), before each part of each phase 8c
row and read after it (``train_launches``: per microbatch a forward's
flash and ``ssd_scan`` launches, twice with remat's recompute; zamba2-2.7b
54 ``ssd_scan`` and 9 flash, whisper-tiny 12 flash, the cut olmoe-1b-7b
and minicpm3-4b one flash a layer), just before phase 12(a) and read
after it (one fcfs_scan launch per unsharded dispatch and one a shard of
each sharded one, no other kernel), in each rank of phase 12(b), (b'),
(c) and (c') before each run and read after it (a rank's flash launch a
layer a prefill, decode launch a layer a step, ``ssd_scan`` launch a
layer in the forward and one in remat's recompute a step), and set to 0 again
just before each LM's serving runs and read just after
them (qwen2.5-3b: one flash-attention launch per layer per prefill and one
decode-attention launch per layer per step; mamba2-130m: one SSD-scan
launch per layer per prefill; zamba2-2.7b: one SSD-scan launch per Mamba-2
layer and one flash-attention launch per shared-block use per prefill, one
decode-attention launch per shared-block use per step; qwen2.5-3b with the
int8 cache as without, qwen2-7b, stablelm-3b and mixtral-8x22b alike;
minicpm3-4b: one flash-attention launch per layer per prefill, none in a step (MLA decodes in latent space, as the
reference, with no kernel); olmoe-1b-7b and internvl2-1b: one flash launch
per layer per prefill and one decode launch per layer per step;
whisper-tiny: per prefill one flash launch per encoder layer and two per
decoder layer (self and cross attention), per step two decode launches
per decoder layer; the attention and SSD-scan kernels' launches also by
input type: the fp32 run's in float32, the rest in bfloat16). Then one JSON line gives each kernel's design,
launches, error against its plain version and times at its path's shape
(for the attention and SSD-scan kernels also launches by type; for the
attention kernels also their times and bounds at the other paths'
shapes): kernel,
plain version and library call device-only (CUDA graph) and eager, and the
bound (bytes over the card's memory rate or operations over its rate for
their type, bf16 tensor or fp32, whichever is larger); for fcfs_scan also
each flavour's times beside its times before the redesign, ns a query,
bound and launches on the
load-change and scenario paths, the stream flavour's at a streamed
chunk's shape with its launches on the streaming path, and one batch
dispatch's host time, printed with the card's name and power limit.  The last line is
``{"ok": true, "device": {...}}``.  Float32 matrix products and
convolutions run in full float32 (TF32 off), as the JAX reference
computes.  Exits non-zero, with no result line, without a card or outside
the repository.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from functools import partial
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import RibbonOptimizer, SearchSpace, run_ribbon  # noqa: E402
from repro_torch.core.gp import gp_posterior  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.fcfs_scan import BIG as FCFS_BIG  # noqa: E402
from repro_torch.kernels.fcfs_scan import (FLAVOURS,  # noqa: E402
                                           fcfs_scan_cuda, tel_width)
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                     embedding_bag_ref, fcfs_scan_ref,
                                     fcfs_stream_ref, flash_attention_ref,
                                     per_head, ssd_scan_ref)
from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.launch import host_collectives  # noqa: E402
from repro_torch.launch import sharding as shp  # noqa: E402
from repro_torch.launch import train as train_module  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_process_mesh,
                                     make_production_mesh, run_ranks)
from repro_torch.launch.serve import recover, serve  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import layers as layers_module  # noqa: E402
from repro_torch.models import ssm as ssm_module  # noqa: E402
from repro_torch.models import transformer as transformer_module  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.models.paper_models import (MTWND_PRESETS,  # noqa: E402
                                             make_random_batch, mtwnd_apply,
                                             mtwnd_init)
from repro_torch.serving.engine import (DEFAULT_CELLS,  # noqa: E402
                                        ClusterEngine, _bucket)
from repro_torch.scenario import (LivePlane, ScenarioEngine,  # noqa: E402
                                  build_episode, paper_simulator_plane,
                                  tiered_simulator_plane)
from repro_torch.serving.instance import (AWS_INSTANCES,  # noqa: E402
                                          MODEL_PROFILES, PAPER_POOLS,
                                          bucketed_service_time_lut,
                                          service_table_for,
                                          service_time_lut)
from repro_torch.serving.autoscaler import LoadMonitor, rescale  # noqa: E402
from repro_torch.serving import cells as cell_catalog  # noqa: E402
from repro_torch.serving import checkpoint  # noqa: E402
from repro_torch.serving.cells import LLM_PROFILE, search_cells  # noqa: E402
from repro_torch.serving.instance import H100_CELLS  # noqa: E402
from repro_torch.serving.pool import (PoolEvaluator,  # noqa: E402
                                      best_homogeneous, make_paper_setup,
                                      paper_bucketed_spec, paper_spec,
                                      paper_workload)
from repro_torch.serving.routing import (NAMED_POLICIES,  # noqa: E402
                                         RoutingPolicy, named_policy)
from repro_torch.serving import simulator as sim_module  # noqa: E402
from repro_torch.serving.simulator import (StreamingSimulator,  # noqa: E402
                                           _cold_free0, _expand_slots,
                                           _fold_policy, _qos_threshold_f32)
from repro_torch.models.transformer import get_model, make_trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.roofline import op_walk  # noqa: E402
from repro_torch.roofline.analysis import (RooflineTerms,  # noqa: E402
                                           typed_compute_s)
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# Kernel vs plain version: both add the same float32 values in the same
# order with separate roundings, so they are expected to agree exactly;
# the gates allow one float32 rounding at these magnitudes and one bf16
# rounding of the output.
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
FORWARD_TOL = 1e-5             # MT-WND kernel path vs plain path
GP_TOL = (1e-5, 1e-4)          # GP mean, std: card vs CPU (float32 Cholesky)
BUCKETS = (1, 2, 4, 8, 16, 32)
CFG = MTWND_PRESETS["full"]
# Attention kernels vs their plain versions at inputs ~ N(0, 0.5^2): fp32
# differs by summation order and expf only; in bf16 both round every
# probability to bf16 before the p·v product, at different places (the
# kernels round exp(s - m) against a running max, the plain version the
# normalised probabilities), and the output once (the bf16 tolerance of
# tests/test_kernels.py).
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 is also held against the plain version run in fp32 on the same
# inputs ("exact").  Kernel and plain version each carry one bf16 rounding
# of every weight w_j (relative error d_j, |d_j| <= 2^-8) and one of the
# output.  The weights' term of an output, sum_j w_j d_j v_j, has for v
# drawn independently of the scores an rms of 2^-8/sqrt(3) x rms(exact),
# the same for both sides, so the two lie equally far from exact in
# distribution but not element by element.  Gates: the kernel's max |diff|
# to exact may exceed the plain version's by one bf16 step at max |exact|
# (the output rounding of one element), its mean |diff| by ATTN_MEAN_SLACK
# x mean |exact| (the weights' term, 2^-8/sqrt(3) x 0.8 ~ 0.46 x 2^-8 of
# it, with a 2x margin).  At T 2000 mean |exact| is about 0.01-0.02, so
# that slack is 4e-5-8e-5, while a key tile or split left out moves an
# output by about 0.5·sqrt(64)/T, some 2e-3: 25x the slack, and the mean
# gate fails.
ATTN_MEAN_SLACK = 2 ** -8
# (label, B, S, H, KH, D, causal, window, T): T keys (T = S but for cross
# attention).  "MLA" cases zero v beyond its 64 live dims, as MLA's prefill
# pads it to q's and k's 96.
FLASH_CASES = [("prefill", 4, 2000, 16, 2, 128, True, 0, 2000),
               ("window 256", 2, 1000, 16, 2, 128, True, 256, 1000),
               ("MHA", 2, 512, 8, 8, 64, True, 0, 512),
               ("MQA", 2, 512, 8, 1, 128, True, 0, 512),
               ("D 80", 2, 384, 4, 4, 80, True, 0, 384),
               ("S 1", 4, 1, 16, 2, 128, True, 0, 1),
               ("non-causal S 333", 1, 333, 4, 2, 128, False, 0, 333),
               ("packed qkv views", 2, 257, 8, 2, 128, True, 0, 257),
               ("S 65", 2, 65, 8, 2, 128, True, 0, 65),
               ("window 100, S 333", 2, 333, 8, 2, 128, True, 100, 333),
               ("D 80 non-causal S 200", 2, 200, 8, 8, 80, False, 0, 200),
               ("packed qkv views D 80", 2, 300, 32, 32, 80, True, 0, 300),
               ("zamba2 D 80 window 4096", 1, 2048, 32, 32, 80, True, 4096,
                2048),
               ("MLA prefill D 96, v 64 padded", 4, 2048, 40, 40, 96, True,
                0, 2048),
               ("whisper encoder", 4, 1500, 6, 6, 64, False, 0, 1500),
               ("cross S 400 T 1500", 4, 400, 6, 6, 64, False, 0, 1500),
               ("internvl2 G 7", 4, 2048, 14, 2, 64, True, 0, 2048),
               ("qwen2-7b G 7 D 128", 4, 2000, 28, 4, 128, True, 0, 2000),
               ("stablelm-3b MHA D 80", 4, 2000, 32, 32, 80, True, 0, 2000),
               # a window that binds: S 4608 against a window of 4096
               ("S 4608 zamba2 window 4096", 1, 4608, 32, 32, 80, True, 4096,
                4608),
               ("S 4608 mixtral G 6 window 4096", 1, 4608, 48, 8, 128, True,
                4096, 4608),
               # phase 8c's microbatches (B 2) at shapes no case above has
               ("train whisper self S 448", 2, 448, 6, 6, 64, True, 0, 448),
               ("train cross S 448 T 1500", 2, 448, 6, 6, 64, False, 0,
                1500),
               ("train olmoe MHA D 128", 2, 2048, 16, 16, 128, True, 0,
                2048)]
# (label, B, T, KH, G, D, empty slots: "tail", "head" or "all", how many;
# or "wrap": a ring whose first n slots hold its newest positions)
DECODE_CASES = [("decode", 4, 2048, 2, 8, 128, "tail", 48),
                ("T 1999", 4, 1999, 2, 8, 128, "tail", 48),
                ("MQA D 80", 2, 777, 1, 16, 80, "tail", 5),
                ("MHA", 2, 512, 4, 1, 64, "tail", 0),
                ("T 50, one split", 2, 50, 2, 8, 128, "tail", 3),
                ("ring wrapped", 4, 2048, 2, 8, 128, "head", 100),
                ("no valid slot", 1, 300, 1, 4, 128, "all", 300),
               ("G 8, T 127", 2, 127, 2, 8, 128, "tail", 3),
               ("G 8, T 193", 2, 193, 2, 8, 128, "tail", 0),
               ("G 1 D 80 wrapped ring", 4, 2096, 32, 1, 80, "wrap", 700),
               ("G 1 D 80, one split", 2, 100, 2, 1, 80, "tail", 5),
               ("G 1 D 80, 8 splits", 1, 2096, 2, 1, 80, "tail", 300),
               ("16 splits, 8 empty", 1, 4096, 1, 8, 128, "tail", 2000),
               ("G 32", 1, 500, 1, 32, 64, "head", 10),
               ("G 7, T 2096", 4, 2096, 2, 7, 64, "tail", 48),
               ("cross T 1500 all valid", 4, 1500, 6, 1, 64, "tail", 0),
               ("qwen2-7b G 7 D 128", 4, 2048, 4, 7, 128, "tail", 32),
               ("stablelm-3b KH 32 D 80", 4, 2048, 32, 1, 80, "tail", 32),
               # the window's full ring after 64 steps past a 4608-token
               # prompt: slots 0-575 hold positions 4096-4671
               ("ring 4096 zamba2 G 1 D 80", 1, 4096, 32, 1, 80, "wrap", 576),
               ("ring 4096 mixtral G 6", 1, 4096, 8, 6, 128, "wrap", 576)]
# SSD scan vs its plain version (the token-by-token recurrence), relative
# to max |want|.  fp32: the two sum the same fp32 products in another
# order (the kernel's running sum of dt·A is fp64): 9.2e-7 seen; a chunk
# left out moves y by O(1).
SSD_F32_TOL = 2e-5
# bf16, y against the plain bf16 version: two bf16 steps at the top.  Also
# against the plain version in fp32 on the same inputs ("exact"): the
# kernel rounds the score matrix to bf16 once more than the plain version,
# so its max |diff| may exceed the plain version's by one bf16 step at
# max |exact| and its mean |diff| by 2^-9 x mean |exact|.  A left-out
# 64-row chunk of 2048 moves the mean |diff| by mean |y| / 32, 15x that.
SSD_BF16_TOL = 2 ** -6
SSD_MEAN_SLACK = 2 ** -9
# (label, B, L, H, P, G, N, x/b/c as views of one packed tensor)
SSD_CASES = [("mamba2-130m prefill", 4, 2048, 24, 64, 1, 128, True),
             ("zamba2-2.7b prefill", 4, 2048, 80, 64, 1, 64, True),
             ("ragged L 2000", 2, 2000, 8, 64, 1, 128, False),
             ("L 1", 2, 1, 8, 64, 1, 128, False),
             ("G 2, H 8", 2, 300, 8, 64, 2, 64, False),
             ("P 80, N 32", 1, 130, 4, 80, 1, 32, False),
             ("zamba2-2.7b window L 4608", 1, 4608, 80, 64, 1, 64, True)]
# fp32 kernel path vs plain path, x max |logits|; for the SSM and hybrid
# LMs widened by the plain path's own distance from its scan in float64,
# measured in the same run (see lm_fp32): at zamba2-2.7b's 54 layers each
# fp32 scan lies up to about 2e-4 from exact.
LM_TOL = 1e-4


class LMRun(NamedTuple):
    """One LM's serving run and the kernel launches each prefill and each
    decode step must make on its kernel path.  ``extra`` rows of patch
    (VLM) or frame (encoder-decoder) embeddings are drawn from the run's
    seed; ``changes`` are (field, value) changes to the configuration.  A
    run that is not ``timed`` keeps every gate but leaves out what is only
    printed: the agreement passes, the device-only (CUDA graph) times and
    phase 11's walk."""
    arch: str
    batch: int
    prompt: int
    max_len: int
    steps: int
    per_prefill: dict
    per_step: dict
    extra: int = 0
    changes: tuple = ()
    timed: bool = True

    @property
    def label(self) -> str:
        """The arch and the changed fields, and the batch and prompt where
        an earlier run has the same arch and changes."""
        name = self.arch + "".join(f"-{k}" for k, _ in self.changes)
        first = next(r for r in LM_RUNS
                     if (r.arch, r.changes) == (self.arch, self.changes))
        return name if first == self else \
            f"{name} {self.batch} x {self.prompt}"


LM_RUNS = [
    LMRun("qwen2.5-3b", 4, 2000, 2048, 48,
          {"flash_attention": 36}, {"decode_attention": 36}),
    LMRun("mamba2-130m", 4, 2048, 2096, 48, {"ssd_scan": 24}, {}),
    LMRun("zamba2-2.7b", 4, 2048, 2096, 48,
          {"ssd_scan": 54, "flash_attention": 9}, {"decode_attention": 9}),
    # the int8 KV cache: decode dequantises each layer for the kernel
    LMRun("qwen2.5-3b", 4, 2000, 2048, 48,
          {"flash_attention": 36}, {"decode_attention": 36},
          changes=(("kv_quant_int8", True),)),
    # MLA: flash in prefill; decode in latent space, no kernel
    LMRun("minicpm3-4b", 4, 2048, 2096, 48, {"flash_attention": 62}, {}),
    LMRun("olmoe-1b-7b", 4, 2048, 2096, 48,
          {"flash_attention": 16}, {"decode_attention": 16}),
    # 256 patches in front of 1792 tokens: G 7 in both attention kernels
    LMRun("internvl2-1b", 4, 1792, 2096, 48,
          {"flash_attention": 24}, {"decode_attention": 24}, extra=256),
    # 4 encoder, 4 self and 4 cross flash launches a prefill; self and
    # cross attention through decode_attention in each step
    LMRun("whisper-tiny", 4, 400, 448, 48,
          {"flash_attention": 12}, {"decode_attention": 8}, extra=1500),
    # the registry's last three architectures (ROADMAP F-1, F-3), 16 steps
    # and untimed (the smoke's time limit): qwen2-7b, G 7 at D 128;
    # stablelm-3b, MHA at D 80; mixtral-8x22b at full width cut to 2 of its
    # 56 layers (8 experts of 6144 x 16384, top 2: 9.7 GB a layer in fp32),
    # at the windowed shape below
    LMRun("qwen2-7b", 4, 2000, 2048, 16,
          {"flash_attention": 28}, {"decode_attention": 28}, timed=False),
    LMRun("stablelm-3b", 4, 2000, 2048, 16,
          {"flash_attention": 32}, {"decode_attention": 32}, timed=False),
    # a window that binds (F-2): B 1, a 4608-token prompt into the ring of
    # the 4096-token window, then 64 steps, each over a full, wrapped ring
    LMRun("mixtral-8x22b", 1, 4608, 4672, 64,
          {"flash_attention": 2}, {"decode_attention": 2},
          changes=(("n_layers", 2),), timed=False),
    LMRun("zamba2-2.7b", 1, 4608, 4672, 64,
          {"ssd_scan": 54, "flash_attention": 9}, {"decode_attention": 9},
          timed=False),
]

# Training (slice 12): each model at full width and depth, B 4 x S 2048
# tokens of the synthetic stream of seed 0, random weights from seed 0
# (mamba2-130m runs ssd_scan, internvl2-1b flash: train_launches).
# internvl2-1b trains its Qwen2-0.5B backbone on tokens alone (no
# patches), as the reference's train does.
TRAIN_RUNS = ("mamba2-130m", "internvl2-1b")
TRAIN_B, TRAIN_S = 4, 2048
# (b): bf16 parameters with the float32 master, 2 microbatches, 20 steps
# through train(), an async checkpoint at step 10, then a resumed run of
# steps 11-20 that must repeat the first run's losses bit for bit.
TRAIN_STEPS, TRAIN_CUT, TRAIN_MICRO = 20, 10, 2
# (a): one fp32 step (TF32 off) on the kernel path against one on the
# reference's math: the loss within 1e-5 relative, each parameter's
# gradient (read as AdamW's first moment after the step, (1 - b1)·g)
# within TRAIN_GRAD_TOL x that leaf's max |g|.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# Leaves whose gradient is zero in exact arithmetic: the encoder-decoder's
# cross-attention key bias (a bias on every key, with no rope there,
# shifts each query's scores by one constant, which the softmax removes).
# Both paths give rounding noise there, so such a leaf's scale is floored
# at ZERO_GRAD_FLOOR x the model's largest max |g|, as
# tests/test_torch_train.py floors every leaf's.
ZERO_GRAD_LEAVES, ZERO_GRAD_FLOOR = ("xattn.bk",), 1e-3


class TrainRow(NamedTuple):
    """A training row of phase 8c: ``arch`` at full width through
    ``make_train_step``, cut by ``changes`` ((field, value) pairs, printed
    as LMRun's), B TRAIN_B x ``seq`` tokens (and an encoder-decoder's
    frames); its fp32 gate at ``gate_layers`` deep (0: the run's depth),
    in ``gate_micro`` microbatches."""
    arch: str
    changes: tuple = ()
    gate_layers: int = 0
    seq: int = TRAIN_S
    gate_micro: int = 1

    @property
    def label(self) -> str:
        return self.arch + "".join(f"-{k}" for k, _ in self.changes)


# Phase 8c (slice 19): the hybrid, encoder-decoder, MoE and MLA families,
# bf16 with the float32 master in TRAIN_MICRO microbatches, random weights
# from seed 0, tokens of the synthetic stream of seed 0.  bf16 training
# holds some 20 B a parameter (bf16 parameter 2; float32 master, m and v
# 12; float32 accumulator 4; bf16 gradient 2): zamba2-2.7b's 2.423e9
# parameters 48.5 GB, so it trains at full depth, while olmoe-1b-7b's
# 6.917e9 (138 GB) and minicpm3-4b's 4.262e9 (85 GB) are cut to 4 of 16
# and 16 of 62 layers (1.88e9 and 1.38e9).  The fp32 gate keeps three
# float32 copies of the model (kernel, plain and zamba2's fp64-scan path):
# zamba2-2.7b's at 12 layers (2 shared-block calls) in 4 microbatches (its
# remat block is a super-block: the plain paths' recompute of 6 chunked
# scans and the shared block's scores at B 4 ran the card out of memory),
# the MoE and MLA rows' at 2.  whisper-tiny: B 4 x its 448 decoder
# positions over its 1500 stub frames, N(0, FRAME_STD^2) from seed 0 (as
# tests/test_torch_train.py draws them), at full depth.
TRAIN_ROWS = (TrainRow("zamba2-2.7b", gate_layers=12, gate_micro=4),
              TrainRow("whisper-tiny", seq=448),
              TrainRow("olmoe-1b-7b", (("n_layers", 4),), gate_layers=2),
              TrainRow("minicpm3-4b", (("n_layers", 16),), gate_layers=2))
# Each row's bf16 run: these steps, timed as phase 8b's (c); the mean loss
# of the last 5 below that of the first 5.
TRAIN_ROW_STEPS = 10
FRAME_STD = 0.5
# Phase 10: train() steps under the one-card mesh and without one.
MESH_STEPS = 3
# Phase 11: each kernel's figure at its path's shape as PERF.md §6 prints
# it (flops of flash and ssd_scan, bytes of the rest), for the printout.
SECTION6 = {"flash_attention": "6.557e10 flop",
            "ssd_scan": "7.33e9 flop, 58.5 MB",
            "decode_attention": "8.23 MB (the 2000 valid slots)",
            "embedding_bag": "261 KB (the distinct rows)"}

# fcfs_scan at the batch lane's shape before its redesign (a 5-round
# shuffle argmin a query; chip_smoke.py on BEFORE_CARD): device-only and
# eager ms per flavour, and one 64-pool batch dispatch end to end when it
# copied latencies to the host.  Copied, not measured by this run, so
# printed in the ``[fcfs]`` text lines only, never in the kernels line.
FCFS_BEFORE_MS = {"cold": (0.3412, 0.3428), "policy": (0.7062, 0.7098),
                  "telemetry": (0.4565, 0.4589), "trace": (0.3469, 0.3505)}
FCFS_BEFORE_DISPATCH_MS = 1.072
BEFORE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# The card's name and power limit as nvidia-smi reads them (device_phase).
CARD = {"smi": "not read"}

PAPER_MODELS = ("mtwnd", "dien", "candle", "resnet50", "vgg19")
# The four paper models that run no kernel of ours (the reference runs no
# Pallas kernel for them), served at full width in phases 4b, 5b, 6b, 9b.
NO_KERNEL_MODELS = ("candle", "resnet50", "vgg19", "dien")
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores
# Phase 4b, fp32 forward on the card against a float64 copy of the same
# module on the card, and against the same weights' fp32 forward on the
# CPU, each relative to max |out|.  fp32 sums of up to 25,088 terms
# (VGG19's first fc layer) through up to 19 layers, and cuDNN's choice of
# conv algorithm (Winograd and FFT forms round more than a direct sum):
# 1e-3 leaves that room, while a wrong pad, a transposed weight or an NCHW
# flatten moves outputs by O(max |out|).
PAPER_FWD_TOL = 1e-3
# Phase 9b: spot-churn through LivePlane, qos_latency 30 ms (the example's
# 10 s was chosen for a CPU), 40 qps, 30-query probes, the first two cell
# types, bounds (3, 2).  mtwnd at the registry's n 500; vgg19 at n 200,
# whose queries take some 10-70 ms each on cell1.
LIVE_EPISODES = (("mtwnd", 500), ("vgg19", 200))
# The streaming path's anchors: mtwnd's Table 3 pool, seed 0, 800 qps,
# chunks of 4096; the reference's StreamingSimulator fed the port's stream
# (jax 0.9.0, on the CPU): 981,041 of 1,000,000 within QoS, no rebase; at
# 0.05 qps every chunk passes _MAX_HORIZON / 2, so (1, 0, 0) over
# 3 x 4096 + 100 queries rebases 4 times.
STREAM = dict(model="mtwnd", config=(2, 3, 3), small=10_000, small_rate=0.9821,
              full=1_000_000, full_hits=981_041, rebase_qps=0.05,
              rebase_config=(1, 0, 0), rebase_n=3 * 4096 + 100, rebases=4)
# The scenario path's anchors, mtwnd: the reference's ScenarioEngine on its
# simulator plane fed the port's streams (jax 0.9.0, on the CPU); qos,
# cost $, BO evaluations, windows, violating windows, final pool, actions.
# tier-outage takes 111 evaluations in the port where the reference takes
# 110: a recovery's sequential ask meets an EI near-tie (ROADMAP C-R20);
# every other field is the reference's.
SCENARIOS = {
    "diurnal-day-small": dict(
        episode="diurnal-day", kw=dict(n=2000, window=400), tiered=False,
        anchor=(0.9984, 0.013242827912236889, 25, 25, 0, (6, 0, 1), ())),
    "spot-churn": dict(
        episode="spot-churn", kw=dict(n=500), tiered=False,
        anchor=(0.8813333333333333, 0.001196530202707541, 124, 16, 3,
                (3, 2, 0), ("recover_preemption", "rescale_up", "restock",
                            "reprice"))),
    "tier-outage": dict(
        episode="tier-outage", kw=dict(n=500), tiered=True,
        anchor=(0.9465, 0.001508470218473671, 111, 23, 2, (0, 4, 0, 0),
                ("recover_outage", "rescale_down", "restock", "restock_trim",
                 "reprice"))),
}
# Full-size diurnal-day (5 x 200,000 queries, window 20,000, stream_chunk
# 4096) on the card: the same anchors, the cost within 1e-9 relative.
DIURNAL_DAY = dict(queries=1_000_000, qos=0.994136,
                   cost=1.4916108494636782, evals=62, windows=50,
                   violating=1, final=(4, 0, 12))
# The search path's anchor (the quickstart): mtwnd, 1500 queries, seed 0.
ANCHOR = dict(model="mtwnd", qos_target=0.99, budget=80, start=(5, 0, 0))


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs,
    after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``, with the host's launch cost
    taken out: ``calls`` calls are captured in one CUDA graph, which is
    replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def median_event_ms(fn, runs: int) -> float:
    """Median device milliseconds of single runs of ``fn``."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}, torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    CARD["smi"] = smi.splitlines()[0]
    print(CARD["smi"], flush=True)
    return name


def build_phase() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{name}.cu: " + " | ".join(usage))
    phase("build", f"{len(logs)} kernel source(s) built in {secs:.2f} s")


def kernel_phase() -> float:
    """embedding_bag against its plain version, for one table (within TOL)
    and for 1 and 8 stacked tables in one launch (bit for bit); returns
    the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_tables, v, d, bag = CFG["n_tables"], CFG["vocab"], CFG["emb"], CFG["bag"]
    tables32 = torch.randn(n_tables, v, d, generator=gen, device="cuda")
    worst, n_single, n_stacked = 0.0, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        tables = tables32.to(dtype)
        for n_bags in (1, 8, 32, 256):
            for hi, label in ((v, "full"), (100, "[0,100)"), (v, "repeat")):
                idx = torch.randint(0, hi, (n_bags, n_tables, bag),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32)
                if label == "repeat":
                    idx[..., bag // 2:] = idx[..., :1]
                w = torch.rand(n_bags, n_tables, bag, generator=gen,
                               device="cuda")
                for weights in (None, w):
                    name = (f"embedding_bag {dtype} n_bags={n_bags} "
                            f"idx={label} weighted={weights is not None}")
                    one = [idx[:, 0].contiguous(), tables[0],
                           None if weights is None else w[:, 0].contiguous()]
                    got = ops.embedding_bag(*one)
                    want = embedding_bag_ref(*one)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = max(1.0, want.float().abs().max().item())
                    if not err <= TOL[dtype] * scale:
                        raise AssertionError(
                            f"{name}: max |diff| {err} > {TOL[dtype] * scale}")
                    worst = max(worst, err)
                    n_single += 1
                    for t in (1, n_tables):
                        many = [idx[:, :t].contiguous(), tables[:t],
                                None if weights is None
                                else w[:, :t].contiguous()]
                        got = ops.embedding_bag(*many)
                        want = embedding_bag_ref(*many)
                        if got.shape != (n_bags, t * d) or \
                                not torch.equal(got, want):
                            raise AssertionError(
                                f"{name} T={t} stacked: max |diff| "
                                f"{(got.float() - want.float()).abs().max()}"
                                " (gate: bit for bit)")
                        n_stacked += 1
    phase("kernel", f"embedding_bag vs plain: {n_single} single-table cases "
                    f"agree, max |diff| {worst} (gates {TOL[torch.float32]} "
                    f"fp32, {TOL[torch.bfloat16]} bf16, relative to "
                    f"max(1, |sum|)); {n_stacked} stacked cases (T 1 and "
                    f"{n_tables}, one launch each) equal bit for bit")
    # Indices outside [0, V), as the reference takes them: a negative one
    # wraps once, then every one is clamped to [0, V - 1].
    n_out = 0
    for dtype in (torch.float32, torch.bfloat16):
        tables = tables32.to(dtype)
        idx = torch.randint(-2 * v, 2 * v, (32, n_tables, bag), generator=gen,
                            device="cuda", dtype=torch.int32)
        idx[0, :, :4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, v],
                                     dtype=torch.int32)
        for args in ((idx[:, 0].contiguous(), tables[0]), (idx, tables)):
            if not torch.equal(ops.embedding_bag(*args),
                               embedding_bag_ref(*args)):
                raise AssertionError(f"embedding_bag {dtype}, indices outside "
                                     "[0, V): kernel differs from plain")
            n_out += 1
    phase("kernel", f"embedding_bag on indices outside [0, V) (negative, "
                    f">= V, int32 extremes): {n_out} cases (one table and "
                    f"{n_tables} stacked, fp32 and bf16) equal bit for bit")
    return worst


def _case(cases, prefix: str):
    """The case whose label starts with ``prefix``."""
    return next(c for c in cases if c[0].startswith(prefix))


def _normal(gen, shape, dtype):
    return (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)


def _flash_inputs(gen, case, dtype):
    label, b, s, h, kh, d, _, _, t = case
    if label.startswith("packed qkv views"):
        # q, k and v as strided views of one projection, as a fused QKV
        # matmul would leave them.
        qkv = _normal(gen, (b, s, h + 2 * kh, d), dtype)
        return qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    v = _normal(gen, (b, t, kh, d), dtype)
    if label.startswith("MLA"):
        v[..., 64:] = 0
    return (_normal(gen, (b, s, h, d), dtype),
            _normal(gen, (b, t, kh, d), dtype), v)


def _decode_inputs(gen, case, dtype):
    _, b, t, kh, g, d, where, n_empty = case
    pos = torch.arange(t, device="cuda", dtype=torch.int32)
    if where == "tail":
        pos[t - n_empty:] = -1
    elif where == "head":
        pos[:n_empty] = -1
    elif where == "wrap":
        pos[:n_empty] += t
    else:
        pos[:] = -1
    return (_normal(gen, (b, 1, kh * g, d), dtype),
            _normal(gen, (b, t, kh, d), dtype),
            _normal(gen, (b, t, kh, d), dtype), pos)


def _gate(name: str, got, want, exact) -> float:
    """Hold a kernel's output ``got`` against its plain version's ``want``
    (max |diff| <= ATTN_TOL), and in bf16 against ``exact``, the plain
    version in fp32 on the same inputs (max |diff| within one bf16 step at
    max |exact| of the plain version's own, mean |diff| within
    ATTN_MEAN_SLACK x mean |exact| of it).  Returns max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= ATTN_TOL[got.dtype]:
        raise AssertionError(f"{name}: max |diff| {err} > {ATTN_TOL[got.dtype]}")
    if got.dtype == torch.bfloat16:
        mine = (got.float() - exact).abs()
        plain = (want.float() - exact).abs()
        top = exact.abs().max().item()
        step = 2.0 ** (math.floor(math.log2(top)) - 7)   # bf16 spacing there
        for stat, slack in ((torch.max, step), (torch.mean, ATTN_MEAN_SLACK *
                                                exact.abs().mean().item())):
            a, b = stat(mine).item(), stat(plain).item()
            if not a <= b + slack:
                raise AssertionError(
                    f"{name}: {stat.__name__} |diff| to fp32 {a} > the plain "
                    f"version's {b} + {slack}")
    return err


def attention_phase() -> dict:
    """flash_attention and decode_attention against their plain versions;
    returns each kernel's largest error per type."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"flash_attention": {}, "decode_attention": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            label, causal, window = case[0], case[6], case[7]
            q, k, v = _flash_inputs(gen, case, dtype)
            err = _gate(f"flash_attention {label} {dtype}",
                        ops.flash_attention(q, k, v, causal=causal,
                                            window=window),
                        flash_attention_ref(q, k, v, causal=causal,
                                            window=window),
                        flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=causal, window=window))
            w = worst["flash_attention"]
            w[dtype] = max(w.get(dtype, 0.0), err)
        for case in DECODE_CASES:
            q, k, v, pos = _decode_inputs(gen, case, dtype)
            err = _gate(f"decode_attention {case[0]} {dtype}",
                        ops.decode_attention(q, k, v, pos),
                        decode_attention_ref(q, k, v, pos),
                        decode_attention_ref(q.float(), k.float(), v.float(),
                                             pos))
            w = worst["decode_attention"]
            w[dtype] = max(w.get(dtype, 0.0), err)
    for name, cases in (("flash_attention", FLASH_CASES),
                        ("decode_attention", DECODE_CASES)):
        w = worst[name]
        phase("kernel", f"{name} vs plain: {2 * len(cases)} cases "
                        f"({', '.join(c[0] for c in cases)}; fp32 and bf16) "
                        f"agree, max |diff| {w[torch.float32]:.3g} fp32, "
                        f"{w[torch.bfloat16]:.3g} bf16 (gates "
                        f"{ATTN_TOL[torch.float32]}, "
                        f"{ATTN_TOL[torch.bfloat16]}; bf16 |diff| to fp32 "
                        f"within the plain version's plus one bf16 step at "
                        f"the top (max) and {ATTN_MEAN_SLACK} x mean |exact| "
                        f"(mean))")
    return worst


def _ssd_inputs(gen, case, dtype):
    """x, dt, a_log, b, c at a case's shape: x, b and c ~ N(0, 0.5^2) as
    views of one packed (B, L, H·P + 2·G·N) tensor, as the model's conv
    output passes them (contiguous copies when not ``packed``);
    dt = softplus(N(0, 1)); a_log = log(linspace(1, 16, H)), as the model
    initialises it."""
    _, b, l, h, p, g, n, packed = case
    xbc = _normal(gen, (b, l, h * p + 2 * g * n), dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    if not packed:
        x, bm, cm = x.contiguous(), bm.contiguous(), cm.contiguous()
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    return x, dt, a_log, bm, cm


def _ssd_gate(name: str, inputs) -> tuple[float, float]:
    """Run the kernel and hold its (y, state) against the plain version's:
    each within SSD_F32_TOL x max |want| (y within SSD_BF16_TOL in bf16),
    and in bf16 against the plain version in fp32 on the same inputs (see
    SSD_BF16_TOL).  Returns y's max |diff| and the largest relative one."""
    x, dt, a_log, b, c = inputs
    got = ops.ssd_scan(x, dt, a_log, b, c)
    want = ssd_scan_ref(x, dt, a_log, b, c)
    torch.cuda.synchronize()
    rels = []
    for part, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad {part} {tuple(g.shape)} "
                                 f"{g.dtype}")
        tol = SSD_BF16_TOL if g.dtype == torch.bfloat16 else SSD_F32_TOL
        top = w.float().abs().max().item()
        rels.append((g.float() - w.float()).abs().max().item() / top)
        if not rels[-1] <= tol:
            raise AssertionError(f"{name}: {part} max |diff| {rels[-1]} x "
                                 f"max |want| > {tol}")
    if x.dtype == torch.bfloat16:
        exact = ssd_scan_ref(x.float(), dt, a_log, b.float(), c.float())[0]
        mine = (got[0].float() - exact).abs()
        plain = (want[0].float() - exact).abs()
        top = exact.abs().max().item()
        step = 2.0 ** (math.floor(math.log2(top)) - 7)   # bf16 spacing there
        for stat, slack in ((torch.max, step), (torch.mean, SSD_MEAN_SLACK *
                                                exact.abs().mean().item())):
            a, ref = stat(mine).item(), stat(plain).item()
            if not a <= ref + slack:
                raise AssertionError(
                    f"{name}: {stat.__name__} |diff| to fp32 {a} > the plain "
                    f"version's {ref} + {slack}")
    return (got[0].float() - want[0].float()).abs().max().item(), max(rels)


def ssd_phase() -> dict:
    """ssd_scan against its plain version; returns per type the largest
    y error, absolute and relative to max |want|."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES:
            err, rel = _ssd_gate(f"ssd_scan {case[0]} {dtype}",
                                 _ssd_inputs(gen, case, dtype))
            a, r = worst.get(dtype, (0.0, 0.0))
            worst[dtype] = (max(a, err), max(r, rel))
    f32, bf16 = worst[torch.float32], worst[torch.bfloat16]
    phase("kernel", f"ssd_scan vs plain: {2 * len(SSD_CASES)} cases "
                    f"({', '.join(c[0] for c in SSD_CASES)}; fp32 and bf16; "
                    f"y and final state) agree, max |diff| {f32[1]:.3g} fp32, "
                    f"{bf16[1]:.3g} bf16 x max |want| (gates {SSD_F32_TOL}, "
                    f"{SSD_BF16_TOL}; bf16 max |diff| to fp32 within one bf16 "
                    f"step at the top of the plain version's, mean within "
                    f"{SSD_MEAN_SLACK} x mean |y|)")
    return worst


def _fcfs_inputs(model: str, configs, n_slots: int, factors=(1.0,),
                 dists=None):
    """fcfs_scan's operands on the card for a paper model's stream (1500
    queries, seed 0): arrivals (W, 1500) for the load ``factors`` (divided
    in float64, then cast), service (1, n_types, 1500) or, with ``dists``,
    one table per row from that batch distribution's stream (the same
    arrivals), and cold slot layouts of ``configs`` padded to ``n_slots``."""
    profile = MODEL_PROFILES[model]
    types = [AWS_INSTANCES[n] for n in PAPER_POOLS[model]["diverse"]]
    wl = paper_workload(model)
    arrivals = wl.arrivals[None] / np.asarray(factors, np.float64)[:, None]
    tables = [service_table_for(profile, types, wl)]
    if dists is not None:
        tables = []
        for dist in dists:
            other = paper_workload(model, batch_dist=dist)
            if not np.array_equal(other.arrivals, wl.arrivals):
                raise AssertionError(f"{dist} stream has other arrivals")
            tables.append(service_table_for(profile, types, other))
    tos, active = _expand_slots(configs, len(types), n_slots)

    def dev(x, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).cuda()

    return (dev(arrivals), dev(np.stack(tables)), dev(tos, np.int32),
            torch.arange(n_slots, dtype=torch.float32, device="cuda"),
            dev(_cold_free0(active)),
            _qos_threshold_f32(profile.qos_latency))


def _configs(rng, bounds, n: int) -> np.ndarray:
    return np.stack([rng.integers(0, b + 1, n) for b in bounds], axis=1)


def _fcfs_cases():
    """(label, operands) of the simulator kernel phase."""
    rng = np.random.default_rng(8)
    batch = _configs(rng, (8, 10, 12), 64)
    batch[0] = 0
    grid = batch[:16]
    ties = _fcfs_inputs("mtwnd", [(8, 10, 12), (20, 0, 0), (1, 1, 1),
                                  (0, 0, 0)], 40)
    # bursts of 50 queries at one instant, every service 5 ms: many idle
    # slots at once and many busy slots freeing at the same time
    ties = (torch.floor(torch.arange(1500, device="cuda") / 50)[None]
            .float() * 0.002, torch.full_like(ties[1], 0.005), *ties[2:])
    return [
        ("batch: 64 mtwnd configs x 1500 queries, S 40",
         _fcfs_inputs("mtwnd", batch, 40)),
        ("grid: 3 load factors x 16 configs, one table",
         _fcfs_inputs("mtwnd", grid, 40, factors=(0.8, 1.0, 1.3))),
        ("grid: 3 rows x 16 configs, a table per row",
         _fcfs_inputs("mtwnd", grid, 40, factors=(0.8, 1.0, 1.3),
                      dists=("lognormal", "gaussian", "bucketed-small"))),
        ("configs at max_instances 40",
         _fcfs_inputs("mtwnd", [(10, 10, 20), (40, 0, 0), (0, 0, 40)], 40)),
        ("all-zero rows", _fcfs_inputs("dien", [(0, 0, 0)] * 3 + [(2, 3, 4)],
                                       40)),
        ("ties: bursts at one instant, equal service", ties),
        ("S 64", _fcfs_inputs("candle", _configs(rng, (20, 20, 24), 32), 64)),
        ("S 8", _fcfs_inputs("vgg19", _configs(rng, (2, 3, 3), 16), 8)),
        ("S 130", _fcfs_inputs("resnet50", _configs(rng, (40, 40, 50), 16),
                               130)),
    ]


def _policy_ops(policy: RoutingPolicy, tos: torch.Tensor):
    """A policy folded over the slot layouts ``tos`` (L, S) as the
    simulator folds it: (type_of_slot, pref_slot, affinity, hedge) on the
    card, P·L lanes for a stacked policy."""
    host = tos.cpu().numpy()
    tos2, _, pref, aff, hed, _ = _fold_policy(policy, host,
                                              np.zeros(host.shape, np.float32))

    def dev(x, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).cuda()

    return dev(tos2, np.int32), (dev(pref), dev(aff), dev(hed))


def _warm_carries(tos, rows: int, seed: int):
    """Per-row warm carries for ``tos`` (L, S): each active slot busy until
    a draw from [0, 0.02) s or idle, absent slots 1e30, (rows, L, S)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    busy = torch.rand((rows, *tos.shape), generator=gen, device="cuda")
    free = torch.where(busy < 0.5, busy * 0.04, torch.zeros_like(busy))
    return free


def _fcfs_flavour_cases():
    """(label, operands, flags) of the routed, warm, traced and telemetry
    flavours: the four named policies and a stacked P = 4 policy over 16
    mtwnd pools, per-row carries on a 3-row grid, the dispatch trace, the
    telemetry counters with and without a policy, and ties, absent slots,
    all-zero pools and 130 slots (K = 8) with every flag on."""
    rng = np.random.default_rng(9)
    pools = _configs(rng, (8, 10, 12), 16)
    pools[0] = 0
    ops16 = _fcfs_inputs("mtwnd", pools, 40)
    prices = tuple(AWS_INSTANCES[n].price
                   for n in PAPER_POOLS["mtwnd"]["diverse"])
    cases = []
    for name in NAMED_POLICIES:
        tos, pol = _policy_ops(named_policy(name, prices), ops16[2])
        cases.append((f"policy {name}, 16 pools", (*ops16[:2], tos,
                                                    *ops16[3:]),
                      dict(policy=pol)))
    mixed = RoutingPolicy.from_order([2, 0, 1], affinity=40.0, hedge=0.5)
    stacked = RoutingPolicy.stack(
        [named_policy(n, prices) for n in NAMED_POLICIES[1:]] + [mixed])
    tos, pol = _policy_ops(stacked, ops16[2])
    free0 = ops16[4].repeat(4, 1)
    cases.append(("stacked P 4 x 16 pools", (*ops16[:2], tos, ops16[3], free0,
                                             ops16[5]), dict(policy=pol)))
    grid = _fcfs_inputs("mtwnd", pools, 40, factors=(0.8, 1.0, 1.3))
    absent = grid[4] > 1e29
    carries = torch.where(absent, grid[4],
                          _warm_carries(grid[2], 3, 4))       # (3, L, S)
    cases.append(("per-row carries, 3-row grid", (*grid[:4], carries,
                                                   grid[5]), {}))
    tos, pol = _policy_ops(mixed, grid[2])
    cases.append(("per-row carries, 3-row grid, routed",
                  (*grid[:2], tos, grid[3], carries, grid[5]),
                  dict(policy=pol)))
    n_active = torch.from_numpy(pools.sum(axis=1).astype(np.int32)).cuda()
    cases.append(("dispatch trace", ops16, dict(want_slot=True)))
    cases.append(("telemetry", grid, dict(n_active=n_active)))
    tos, pol = _policy_ops(named_policy("hedged", prices), ops16[2])
    cases.append(("telemetry, hedged", (*ops16[:2], tos, *ops16[3:]),
                  dict(policy=pol, n_active=n_active)))
    ties_pools = np.asarray([(8, 10, 12), (20, 0, 0), (1, 1, 1), (0, 0, 0),
                             (2, 0, 3)])
    ties = _fcfs_inputs("mtwnd", ties_pools, 40)
    ties = (torch.floor(torch.arange(1500, device="cuda") / 50)[None]
            .float() * 0.002, torch.full_like(ties[1], 0.005), *ties[2:])
    warm = torch.where(ties[4] > 1e29, ties[4],
                       _warm_carries(ties[2], 1, 5)[0] * 0.1)
    tos, pol = _policy_ops(mixed, ties[2])
    cases.append(("ties, absent slots, all-zero pool, warm, every flag",
                  (*ties[:2], tos, ties[3], warm, ties[5]),
                  dict(policy=pol, want_slot=True, n_active=torch.from_numpy(
                      ties_pools.sum(axis=1).astype(np.int32)).cuda())))
    wide_pools = _configs(rng, (40, 40, 50), 16)
    wide = _fcfs_inputs("resnet50", wide_pools, 130)
    tos, pol = _policy_ops(named_policy("affinity", prices), wide[2])
    cases.append(("S 130 (K 8), every flag", (*wide[:2], tos, *wide[3:]),
                  dict(policy=pol, want_slot=True, n_active=torch.from_numpy(
                      wide_pools.sum(axis=1).astype(np.int32)).cuda())))
    identity = _policy_ops(RoutingPolicy.fcfs(3), ops16[2])[1]
    return cases, (ops16, identity)


def _pick_ops(arrivals, service, tos, free0, priority=None):
    """fcfs_scan's operands on the card for a hand-built case: arrivals
    (nq,), service (n_types, nq), type_of_slot and free0 (L, S), priority
    (S,) (``arange(S)`` by default), QoS latency 20 ms."""
    def dev(x, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).cuda()

    n_s = tos.shape[1]
    prio = np.arange(n_s) if priority is None else priority
    return (dev(np.asarray(arrivals)[None]), dev(np.asarray(service)[None]),
            dev(tos, np.int32), dev(prio), dev(free0),
            _qos_threshold_f32(0.02))


def _fcfs_pick_cases():
    """(label, operands, flags) built to catch the vote-and-reduce pick
    out: exactly one idle slot, in the last k; every slot idle; equal
    next-free times on slots 7 and 37 as the only minimum (a pick by lowest
    thread would take 37); routed keys that are negative, -0 and +0; S 40,
    130 and 1024 (S not a multiple of 32, K up to 32), large pools and
    small ones padded with absent slots; a non-ascending priority and one
    that BIG's shift collapses; negative arrivals (the general key images),
    with a busy key under an idle one.  Each cold
    case runs plain and with the trace and the counters on."""
    rng = np.random.default_rng(18)
    nq, n_types = 300, 3
    cases = []

    def types(rows, n_s):
        return rng.integers(0, n_types, (rows, n_s))

    for n_s in (40, 130, 1024):
        last = np.arange((n_s - 1) // 32 * 32, n_s)
        at = last[np.linspace(0, len(last) - 1, min(8, len(last))).astype(int)]
        free0 = np.full((len(at), n_s), 10.0)
        free0[np.arange(len(at)), at] = 0.0
        cases.append((f"one idle slot in the last k, S {n_s}",
                      (np.arange(nq) * 0.001,
                       rng.uniform(0.04, 0.06, (n_types, nq)),
                       types(len(at), n_s), free0)))
        cases.append((f"every slot idle, S {n_s}",
                      (np.arange(nq) * 1.0, np.full((n_types, nq), 0.01),
                       types(4, n_s), np.zeros((4, n_s)))))
    for n_s, pairs in ((40, [(7, 37), (31, 32), (3, 35), (8, 33)]),
                       (1024, [(7, 37), (40, 1000)])):
        free0 = np.full((len(pairs), n_s), 5.0)
        for i, pair in enumerate(pairs):
            free0[i, list(pair)] = 2.0
        cases.append((f"busy minimum tied on slots {pairs}, S {n_s}",
                      (0.5 + np.arange(nq) * 0.001,
                       rng.uniform(0.01, 0.03, (n_types, nq)),
                       types(len(pairs), n_s), free0)))
    batch = _fcfs_inputs("mtwnd", _configs(rng, (8, 10, 12), 16), 40)
    host = [x.cpu().numpy() for x in batch[:5]]
    arr, svc, tos, _, fr0 = host[0][0], host[1][0], host[2], host[3], host[4]
    cases.append(("non-ascending priority, 16 mtwnd pools",
                  (arr, svc, tos, fr0, rng.permutation(40))))
    cases.append(("priority collapsed by the shift, 16 mtwnd pools",
                  (arr, svc, tos, fr0, np.arange(40) * 0.01)))
    low = np.full((2, 40), -999994.0)
    low[:, 10] = -999995.0
    cases.append(("negative arrivals, a busy key under an idle one",
                  (-999995.0 + np.arange(nq) * 0.0625,
                   np.full((n_types, nq), 0.125), types(2, 40), low)))
    profile = MODEL_PROFILES["resnet50"]
    wl = paper_workload("resnet50")
    res_types = [AWS_INSTANCES[n] for n in PAPER_POOLS["resnet50"]["diverse"]]
    res_svc = service_table_for(profile, res_types, wl)
    for label, bounds in (("large pools", (300, 300, 400)),
                          ("small pools padded with absent slots",
                           (2, 3, 2))):
        pools = _configs(rng, bounds, 8)
        tos, active = _expand_slots(pools, 3, 1024)
        busy = rng.uniform(size=tos.shape) < 0.5
        free0 = np.where(active, np.where(busy, rng.uniform(0, 0.05,
                                                           tos.shape), 0.0),
                         1e30)
        cases.append((f"S 1024 (K 32), {label}, warm",
                      (wl.arrivals, res_svc, tos, free0)))
    out, small = [], None
    for label, args in cases:
        ops_ = _pick_ops(*args[:4], *args[4:])
        if "absent slots" in label:
            small = ops_
        n_active = (ops_[4] < 1e29).sum(dim=1).to(torch.int32)
        out.append((label, ops_, {}))
        out.append((label + ", trace and counters", ops_,
                    dict(want_slot=True, n_active=n_active)))
    # routed keys that are negative, -0 and +0: signed-zero priorities and
    # preferences, affinity and hedge of -0, 0 and -1, arrivals below 0 and
    # next-free times of -0 and +0 among busy slots
    n_s, lanes = 40, 6
    zeros = np.array([-0.0, 0.0], np.float32)
    prio = zeros[np.arange(n_s) % 2]
    free0 = rng.choice(np.array([-0.0, 0.0, -2.0, 0.3], np.float32),
                       (lanes, n_s), p=[0.3, 0.3, 0.1, 0.3])
    ops_ = _pick_ops(-1.0 + np.arange(nq) * 0.002,
                     rng.uniform(0.003, 0.01, (n_types, nq)),
                     types(lanes, n_s), free0, prio)
    pol = tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
                for x in (rng.choice(np.array([-0.0, 0.0, -1.0], np.float32),
                                     (lanes, n_s)),
                          [-0.0, 0.0, -1.0, -0.0, 0.0, -1.0],
                          [-0.0, -0.0, -0.0, -1.0, -1.0, 0.5]))
    out.append(("routed keys negative, -0 and +0, S 40", ops_,
                dict(policy=pol)))
    out.append(("routed keys negative, -0 and +0, S 40, every flag", ops_,
                dict(policy=pol, want_slot=True,
                     n_active=torch.full((lanes,), n_s, dtype=torch.int32,
                                         device="cuda"))))
    tos, pol = _policy_ops(named_policy("hedged", tuple(
        t.price for t in res_types)), small[2])
    out.append(("S 1024 (K 32), small pools, hedged, every flag",
                (*small[:2], tos, *small[3:]),
                dict(policy=pol, want_slot=True,
                     n_active=(small[4] < 1e29).sum(dim=1).to(torch.int32))))
    return out


def _fcfs_check(label: str, got, want) -> None:
    for part, g, w in zip(("counts", "latencies", "start times",
                           "final carries", "dispatch trace",
                           "telemetry counters"), got, want):
        if (g is None) != (w is None) or (
                g is not None and (g.shape != w.shape
                                   or not torch.equal(g, w))):
            raise AssertionError(f"fcfs_scan {label}: {part} differ from "
                                 "the plain version (gate: bit for bit)")


def simulator_phase() -> int:
    """fcfs_scan against its plain version on the card, bit for bit:
    QoS counts, latencies, start times, final carries, and in the routed,
    warm, traced and telemetry flavours the dispatch trace and the
    counters; the identity policy against the cold flavour.  Returns the
    number of lanes checked."""
    lanes = 0
    cases = _fcfs_cases()
    for label, (arr, svc, tos, prio, free0, qos_t) in cases:
        got = ops.fcfs_scan(arr, svc, tos, prio, free0, qos_t, want_lat=True,
                            want_start=True)
        want = fcfs_scan_ref(arr, svc, tos, prio, free0, qos_t, FCFS_BIG,
                             want_lat=True, want_start=True)
        torch.cuda.synchronize()
        _fcfs_check(label, got, want)
        lanes += got.counts.numel()
    phase("kernel", f"fcfs_scan vs plain, cold: {len(cases)} cases "
                    f"({'; '.join(c[0] for c in cases)}), {lanes} lanes: "
                    "counts, latencies, start times and final carries equal "
                    "bit for bit")
    flavoured, (ops16, identity) = _fcfs_flavour_cases()
    before = dict(fcfs_scan_cuda.launches_by_flavour)
    n = 0
    for label, (arr, svc, tos, prio, free0, qos_t), kw in flavoured:
        got = ops.fcfs_scan(arr, svc, tos, prio, free0, qos_t, want_lat=True,
                            want_start=True, **kw)
        want = fcfs_scan_ref(arr, svc, tos, prio, free0, qos_t, FCFS_BIG,
                             want_lat=True, want_start=True, **kw)
        torch.cuda.synchronize()
        _fcfs_check(label, got, want)
        if "n_active" in kw and got.tel.shape[-1] != tel_width(svc.shape[1]):
            raise AssertionError(f"fcfs_scan {label}: telemetry width")
        n += got.counts.numel()
    arr, svc, tos, prio, free0, qos_t = ops16
    routed = ops.fcfs_scan(arr, svc, tos, prio, free0, qos_t, want_lat=True,
                           want_start=True, want_slot=True, policy=identity)
    cold = ops.fcfs_scan(arr, svc, tos, prio, free0, qos_t, want_lat=True,
                         want_start=True, want_slot=True)
    torch.cuda.synchronize()
    _fcfs_check("identity policy vs the cold flavour", routed, cold)
    ran = {f: fcfs_scan_cuda.launches_by_flavour[f] - before[f]
           for f in FLAVOURS if f != "stream"}
    if not all(ran.values()):
        raise AssertionError(f"fcfs_scan flavour cases missed a flavour: "
                             f"{ran}")
    phase("kernel", f"fcfs_scan vs plain, flavoured: {len(flavoured)} cases "
                    f"({'; '.join(c[0] for c in flavoured)}), {n} lanes, "
                    f"launches by flavour {ran}: counts, latencies, start "
                    "times, carries, traces and telemetry counters equal bit "
                    "for bit; the identity policy equals the cold flavour bit "
                    "for bit")
    picks = _fcfs_pick_cases()
    n_pick = 0
    for label, (arr, svc, tos, prio, free0, qos_t), kw in picks:
        got = ops.fcfs_scan(arr, svc, tos, prio, free0, qos_t, want_lat=True,
                            want_start=True, **kw)
        want = fcfs_scan_ref(arr, svc, tos, prio, free0, qos_t, FCFS_BIG,
                             want_lat=True, want_start=True, **kw)
        torch.cuda.synchronize()
        _fcfs_check(label, got, want)
        n_pick += got.counts.numel()
    phase("kernel", f"fcfs_scan vs plain, pick cases: {len(picks)} cases "
                    f"({'; '.join(c[0] for c in picks)}), {n_pick} lanes: "
                    "equal bit for bit")
    return lanes + n + n_pick


def _pool(model: str = "mtwnd"):
    return MODEL_PROFILES[model], [AWS_INSTANCES[n]
                                   for n in PAPER_POOLS[model]["diverse"]]


def _stream_layout(config, width: int):
    """A streamed pool's slot layout (1, width) and idle carry (1, 1,
    width) on the card, as ``StreamingSimulator`` builds them."""
    tos, active = _expand_slots(np.asarray([config]), len(config), width)
    return (torch.from_numpy(np.ascontiguousarray(tos)).cuda(),
            torch.from_numpy(np.ascontiguousarray(
                _cold_free0(active)[None])).cuda())


def _stream_cases():
    """(label, operands) of the stream flavour's checks: operands
    (arrivals (1, m), batch rows (1, m), lut, type_of_slot (1, S),
    priority (S,), free (1, 1, S), count (1, 1), shift, qos_t) on the
    card, from mtwnd's streams and tables (chunks of 4096)."""
    profile, types = _pool()
    qos_t = _qos_threshold_f32(profile.qos_latency)
    lut = torch.from_numpy(np.ascontiguousarray(np.asarray(
        service_time_lut(profile, types, profile.max_batch),
        np.float32).T)).cuda()

    def chunk(spec, c, base, m=None):
        arr, local, bat = spec.generate_chunk(c, base)[:3]
        m = len(arr) if m is None else m
        return (arr[:m].reshape(1, m).cuda(),
                bat[:m].to(torch.int32).reshape(1, m).cuda(), float(local[-1]))

    def case(arr, rows, table, config, width, free=None, count=0, shift=0.0):
        tos, idle = _stream_layout(config, width)
        return (arr, rows, table, tos,
                torch.arange(width, dtype=torch.float32, device="cuda"),
                idle if free is None else free,
                torch.full((1, 1), count, dtype=torch.int32, device="cuda"),
                shift, qos_t)

    spec = paper_spec("mtwnd", seed=0)
    a0, r0, last0 = chunk(spec, 0, 0.0)
    a1, r1, _ = chunk(spec, 1, last0)
    a2, r2, _ = chunk(spec, 2, last0, 1808)
    # The carry after chunk 0, for the warm cases: the plain version's.
    base = case(a0, r0, lut, STREAM["config"], 8)
    warm_count, warm = fcfs_stream_ref(*base[:7], 0.0, qos_t, FCFS_BIG)
    slow = paper_spec("mtwnd", seed=0, rate_qps=STREAM["rebase_qps"])
    s0, q0, slast = chunk(slow, 0, 0.0)
    s1, q1, _ = chunk(slow, 1, 0.0)
    rebase = case(s0, q0, lut, STREAM["rebase_config"], 8)
    r_count, r_free = fcfs_stream_ref(*rebase[:7], 0.0, qos_t, FCFS_BIG)
    shift = float(np.float32(np.float64(slast) / np.float64(slow.scale)))
    bspec = paper_bucketed_spec("mtwnd", "bucketed-small", seed=0)
    ba, bl, bb, bk = bspec.generate_chunk(0, 0.0)
    stride = int(bspec.max_batch) + 1
    blut = torch.from_numpy(np.ascontiguousarray(np.asarray(
        bucketed_service_time_lut(profile, types, bspec.max_batch,
                                  bspec.buckets), np.float32).T)).cuda()
    brows = (bk * stride + bb).to(torch.int32).reshape(1, -1).cuda()
    # Batch rows outside [0, n_lut): both sides clamp them, as jnp does.
    wild = r0.clone()
    wild[0, ::7] = -5
    wild[0, 3::7] = lut.shape[0] + 9
    return [
        ("chunk 0 of mtwnd's stream, (2, 3, 3), S 8, cold", base),
        ("chunk 1 from chunk 0's carry and count", case(
            a1, r1, lut, STREAM["config"], 8, warm, int(warm_count))),
        ("the 10,000-query stream's partial last chunk (1808 queries)",
         case(a2, r2, lut, STREAM["config"], 8, warm, int(warm_count))),
        ("a rebase: 0.05 qps, chunk 1 with a shift from chunk 0's carry",
         case(s1, q1, lut, STREAM["rebase_config"], 8, r_free, int(r_count),
              shift)),
        ("a bucketed table (bucketed-small, 4 buckets)",
         case(ba.reshape(1, -1).cuda(), brows, blut, STREAM["config"], 8)),
        ("S 40: (12, 12, 12)", case(a0, r0, lut, (12, 12, 12), 40)),
        ("S 1024: (400, 300, 300)", case(a0, r0, lut, (400, 300, 300), 1024)),
        ("batch rows outside [0, n_lut), clamped", case(
            a0, wild, lut, STREAM["config"], 8)),
    ]


def stream_phase() -> int:
    """The stream flavour against its plain version on the card, bit for
    bit (final carry and count), and StreamingSimulator's empty pool and
    empty stream on the card (no launch).  Returns the cases checked."""
    cases = _stream_cases()
    before = fcfs_scan_cuda.launches_by_flavour["stream"]
    for label, (arr, rows, lut, tos, prio, free, count, shift,
                qos_t) in cases:
        want_count, want_free = fcfs_stream_ref(arr, rows, lut, tos, prio,
                                                free, count, shift, qos_t,
                                                FCFS_BIG)
        got_free, got_count = free.clone(), count.clone()
        ops.fcfs_stream(arr, rows, lut, tos, prio, got_free, got_count,
                        shift, qos_t)
        torch.cuda.synchronize()
        if not (torch.equal(got_free, want_free)
                and torch.equal(got_count, want_count)):
            raise AssertionError(f"fcfs_scan stream flavour, {label}: the "
                                 "carry or the count differs from the plain "
                                 "version (gate: bit for bit)")
    ran = fcfs_scan_cuda.launches_by_flavour["stream"] - before
    if ran != len(cases):
        raise AssertionError(f"stream flavour: {ran} launches for "
                             f"{len(cases)} cases")
    profile, types = _pool()
    sim = StreamingSimulator(profile, types, paper_spec("mtwnd"),
                             device="cuda")
    empty, none = sim.qos((0, 0, 0), 100), sim.qos(STREAM["config"], 0)
    launched = fcfs_scan_cuda.launches_by_flavour["stream"] - before - ran
    if (empty.rate, empty.n_queries) != (0.0, 100) or not math.isnan(
            none.rate) or none.n_queries != 0 or launched:
        raise AssertionError(f"StreamingSimulator on the card: empty pool "
                             f"{empty}, empty stream {none}, {launched} "
                             "launches")
    phase("kernel", f"fcfs_scan stream flavour vs plain: {len(cases)} cases "
                    f"({'; '.join(c[0] for c in cases)}): final carries and "
                    "counts equal bit for bit; StreamingSimulator on the "
                    "card: an empty pool 0.0, an empty stream nan, no launch")
    return len(cases)


# C-F2: bf16 inputs the tensor-core kernels cannot read in place, padded or
# copied by the wrappers.  (label, kind, operands' shape)
CF2_CASES = [("flash D 36", "flash", (2, 300, 8, 2, 36)),
             ("flash D 100", "flash", (2, 257, 4, 4, 100)),
             ("decode D 36", "decode", (4, 1000, 2, 8, 36)),
             ("decode D 100", "decode", (2, 777, 4, 1, 100)),
             ("flash, k offset by one element", "flash", (2, 300, 8, 2, 64)),
             ("decode, k and pos offset by one element", "decode",
              (4, 1000, 2, 8, 64)),
             ("ssd_scan P 50, N 20", "ssd", (2, 300, 8, 50, 1, 20)),
             ("ssd_scan, x offset by one element", "ssd",
              (2, 300, 8, 64, 1, 64))]


def _offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose base lies one element past an aligned one."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def cf2_phase() -> dict:
    """ROADMAP C-F2 on the card: bf16 inputs with a head dim, P or N that
    is not a multiple of 8, or a view whose base is not 16-byte aligned,
    through the bf16 kernels (the wrappers pad or copy them) against the
    plain versions, with the attention and SSD gates.  Times each case
    device-only beside the same call on an aligned input of the padded
    width, the cost of the padding or copy.  Returns {label: (ms, aligned
    ms)}."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    times = {}
    before = {f.__name__: f.launches_by_dtype["bfloat16"]
              for f in (flash_attention_cuda, decode_attention_cuda,
                        ssd_scan_cuda)}
    for label, kind, shape in CF2_CASES:
        offset = "offset" in label
        if kind == "flash":
            b, s, h, kh, d = shape
            q, k, v = (_normal(gen, sh, bf16) for sh in
                       ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
            if offset:
                k = _offset_by_one(k)
            _gate(f"C-F2 {label}", ops.flash_attention(q, k, v),
                  flash_attention_ref(q, k, v),
                  flash_attention_ref(q.float(), k.float(), v.float()))
            aligned = [torch.zeros((*x.shape[:-1], -(-d // 8) * 8),
                                   dtype=bf16, device="cuda")
                       for x in (q, k, v)]
            fns = (lambda: ops.flash_attention(q, k, v),
                   lambda: ops.flash_attention(*aligned))
        elif kind == "decode":
            b, t, kh, g, d = shape
            q, k, v = (_normal(gen, sh, bf16) for sh in
                       ((b, 1, kh * g, d), (b, t, kh, d), (b, t, kh, d)))
            pos = torch.arange(t, device="cuda", dtype=torch.int32)
            pos[-9:] = -1
            if offset:
                k, pos = _offset_by_one(k), _offset_by_one(pos)
            _gate(f"C-F2 {label}", ops.decode_attention(q, k, v, pos),
                  decode_attention_ref(q, k, v, pos),
                  decode_attention_ref(q.float(), k.float(), v.float(), pos))
            aligned = [torch.zeros((*x.shape[:-1], -(-d // 8) * 8),
                                   dtype=bf16, device="cuda")
                       for x in (q, k, v)]
            pos0 = torch.arange(t, device="cuda", dtype=torch.int32)
            fns = (lambda: ops.decode_attention(q, k, v, pos),
                   lambda: ops.decode_attention(*aligned, pos0))
        else:
            b, l, h, p, g, n = shape
            x, dt, a_log, bm, cm = _ssd_inputs(
                gen, (label, b, l, h, p, g, n, False), bf16)
            if offset:
                x = _offset_by_one(x)
            _ssd_gate(f"C-F2 {label}", (x, dt, a_log, bm, cm))
            xa = torch.zeros((b, l, h, -(-p // 8) * 8), dtype=bf16,
                             device="cuda")
            ba = torch.zeros((b, l, g, -(-n // 8) * 8), dtype=bf16,
                             device="cuda")
            fns = (lambda: ops.ssd_scan(x, dt, a_log, bm, cm),
                   lambda: ops.ssd_scan(xa, dt, a_log, ba, ba))
        times[label] = tuple(graph_ms(fn, 5, 5) for fn in fns)
    ran = {name: f.launches_by_dtype["bfloat16"] - before[name]
           for name, f in (("flash_attention_cuda", flash_attention_cuda),
                           ("decode_attention_cuda", decode_attention_cuda),
                           ("ssd_scan_cuda", ssd_scan_cuda))}
    phase("kernel", "C-F2 on the bf16 kernels: " + "; ".join(
        f"{label} {ms:.5f} ms device-only (aligned input of the padded width "
        f"{al:.5f} ms)" for label, (ms, al) in times.items())
          + f"; every case within its kernel's gates against the plain "
            f"version; bf16 launches {ran}")
    return times


def forward_phase() -> None:
    """MT-WND full width, kernel path vs plain path per bucket."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = mtwnd_init(gen, "full", device="cuda")
    for b in BUCKETS:
        batch = make_random_batch("mtwnd", "full", b, device="cuda")
        kern = mtwnd_apply(model, batch)
        plain = mtwnd_apply(model, batch, use_kernel=False)
        diff = (kern - plain).abs().max().item()
        if kern.shape != (b, CFG["tasks"]) or not torch.isfinite(kern).all():
            raise AssertionError(f"MT-WND bucket {b}: bad output "
                                 f"{tuple(kern.shape)}")
        if not ((kern >= 0) & (kern <= 1)).all() or diff > FORWARD_TOL:
            raise AssertionError(f"MT-WND bucket {b}: max |diff| {diff}")
        k_ms = median_event_ms(lambda: mtwnd_apply(model, batch), 30)
        p_ms = median_event_ms(
            lambda: mtwnd_apply(model, batch, use_kernel=False), 30)
        k_dev = graph_ms(lambda: mtwnd_apply(model, batch), calls=20)
        phase("forward", f"bucket {b:2d}: max |diff| {diff:.3g}, forward "
                         f"{k_ms:.4f} ms (kernel path) / {p_ms:.4f} ms "
                         f"(plain path), eager median of 30; kernel path "
                         f"device-only {k_dev:.4f} ms (CUDA graph)")
    del model


def serve_phase(engine: ClusterEngine, wl, name: str = "mtwnd") -> int:
    engine.configure((1, 1, 1))
    rate = engine.serve(wl, qos_latency=0.03)
    lat, waits = engine.served_arrays()
    svc = (lat - waits) * 1e3
    if not 0.0 <= rate <= 1.0 or len(lat) != wl.n_queries:
        raise AssertionError(f"serve: rate {rate}, {len(lat)} records")
    phase("serve", f"{name} pool (1, 1, 1), {wl.n_queries} requests at 150 "
                   f"qps: QoS {rate:.4f} within 30 ms; service p50 "
                   f"{np.percentile(svc, 50):.4f} ms, p99 "
                   f"{np.percentile(svc, 99):.4f} ms; latency p99 "
                   f"{np.percentile(lat * 1e3, 99):.4f} ms")
    return sum(c.n_served for c in engine.cells)


def ribbon_phase(engine: ClusterEngine, wl) -> int:
    space = SearchSpace(bounds=(4, 3, 3),
                        prices=tuple(c.price for c in engine.cell_types))
    opt = RibbonOptimizer(space, qos_target=0.9, patience=6, device="cuda")
    forwards = 0
    for _ in range(16):
        cfg = opt.ask()
        if cfg is None or opt.done:
            break
        engine.configure(cfg)
        rate = engine.serve(wl, qos_latency=0.03)
        forwards += sum(c.n_served for c in engine.cells)
        if not 0.0 <= rate <= 1.0:
            raise AssertionError(f"RIBBON: QoS {rate} for {cfg}")
        opt.tell(cfg, rate)
        phase("ribbon", f"{cfg}: measured QoS {rate:.4f}, "
                        f"${engine.pool_price(cfg):.2f}/h")
    best = opt.trace.best_feasible()
    if best is None:
        raise AssertionError("RIBBON found no feasible pool")
    phase("ribbon", f"best pool {best.config} at ${best.cost:.2f}/h, QoS "
                    f"{best.qos_rate:.4f}, {opt.trace.n_samples} samples")
    # The GP fit on the card against the same fit on the CPU.
    x, y, mask = opt.gp.buffers()
    lattice = torch.tensor(space.enumerate(), dtype=torch.float32,
                           device="cuda")
    mean_d, std_d = gp_posterior(x, y, mask, lattice, opt.gp.denom)
    mean_h, std_h = gp_posterior(x.cpu(), y.cpu(), mask.cpu(), lattice.cpu(),
                                 opt.gp.denom.cpu())
    dm = (mean_d.cpu() - mean_h).abs().max().item()
    ds = (std_d.cpu() - std_h).abs().max().item()
    if dm > GP_TOL[0] or ds > GP_TOL[1]:
        raise AssertionError(f"GP card vs CPU: mean {dm}, std {ds}")
    phase("ribbon", f"GP posterior card vs CPU: max |diff| mean {dm:.3g}, "
                    f"std {ds:.3g} (gates {GP_TOL[0]}, {GP_TOL[1]})")
    return forwards


def _adaptive_ms(fn) -> tuple[float, float]:
    """Eager (median of single runs, CUDA events) and device-only (CUDA
    graph) milliseconds of ``fn``, with run counts scaled to its time so a
    heavy forward takes some 0.5 s to time."""
    fn()
    once = median_event_ms(fn, 3)
    runs = int(min(30, max(5, 300.0 / max(once, 1e-3))))
    calls = int(min(20, max(2, 100.0 / max(once, 1e-3))))
    replays = int(min(20, max(2, 300.0 / max(calls * once, 1e-3))))
    return median_event_ms(fn, runs), graph_ms(fn, calls=calls,
                                               replays=replays)


def _flops(apply, model, batch) -> int:
    """Floating-point operations of one forward, counted by
    ``torch.utils.flop_counter`` (products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        apply(model, batch)
    return counter.get_total_flops()


def _to64(batch: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


def paper_forward_phase() -> None:
    """Phase 4b: CANDLE, ResNet50, VGG19 and DIEN at full width, fp32, per
    batch bucket 1..32: the card's output against a float64 copy of the
    same module on the card; at bucket 2 against the same weights' fp32
    forward on the CPU; eager and device-only times, the fp32 floor, the
    parameter bytes."""
    for name in NO_KERNEL_MODELS:
        spec = pm.PAPER_MODELS[name]
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = spec.init(gen, "full", "cuda")
        size = sum(p.numel() * p.element_size() for p in model.parameters())
        exact = copy.deepcopy(model).double()
        worst, rows = 0.0, []
        for b in BUCKETS:
            batch = make_random_batch(name, "full", b, device="cuda")
            out = spec.apply(model, batch)
            want = spec.apply(exact, _to64(batch))
            if out.shape != want.shape or out.shape[0] != b or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"{name} bucket {b}: bad output "
                                     f"{tuple(out.shape)}")
            rel = ((out.double() - want).abs().max()
                   / want.abs().max()).item()
            if not rel <= PAPER_FWD_TOL:
                raise AssertionError(f"{name} bucket {b}: fp32 vs float64 "
                                     f"{rel} x max |out|")
            worst = max(worst, rel)
            if b == 2:
                at2 = batch, out
            eager, dev = _adaptive_ms(lambda: spec.apply(model, batch))
            flops = _flops(spec.apply, model, batch)
            rows.append(f"{b}: {eager:.4f} / {dev:.4f} ms, floor "
                        f"{flops / FP32_FLOPS_PER_S * 1e3:.4f} ms "
                        f"({flops / 1e9:.3f} GFLOP)")
        # On the CPU after the timings: its worker threads slow the host's
        # launches for a while after it (scripts/probe_paper_models.py).
        batch, out = at2
        cpu_out = spec.apply(copy.deepcopy(model).cpu(),
                             {k: v.cpu() for k, v in batch.items()})
        cpu_rel = ((out.cpu() - cpu_out).abs().max()
                   / cpu_out.abs().max()).item()
        if not cpu_rel <= PAPER_FWD_TOL:
            raise AssertionError(f"{name} bucket 2: card vs CPU "
                                 f"{cpu_rel} x max |out|")
        phase("forward", f"{name} full width, {size / 1e6:.1f} MB of "
                         f"fp32 weights: fp32 vs float64 on the card, max "
                         f"|diff| {worst:.3g} x max |out| over buckets "
                         f"1..32; card vs CPU at bucket 2 {cpu_rel:.3g} "
                         f"(gate {PAPER_FWD_TOL} each); per bucket, eager "
                         f"(median, CUDA events) / device-only (CUDA graph), "
                         f"fp32 floor at {FP32_FLOPS_PER_S / 1e12:.0f} "
                         f"TFLOP/s: " + "; ".join(rows)
                         + f"; on {CARD['smi']}")
        del model, exact
        torch.cuda.empty_cache()


def _launch_counts() -> dict:
    return {fn.__name__[:-5]: fn.launches for fn in COUNTED}


def paper_serve_phase(wl) -> None:
    """Phase 5b: phase 5's serving for CANDLE, ResNet50, VGG19 and DIEN at
    full width (three cell types, warm-up, 80 requests at 150 qps on
    (1, 1, 1) within 30 ms); no kernel of ours launches."""
    reset_counts()
    for name in NO_KERNEL_MODELS:
        t0 = time.perf_counter()
        engine = ClusterEngine(name, DEFAULT_CELLS, seed=0, device="cuda")
        engine.warmup(max_batch=BUCKETS[-1])
        weights = sum(p.numel() * p.element_size()
                      for m in engine._params.values()
                      for p in m.parameters())
        held = torch.cuda.memory_allocated() / 1e9
        serve_phase(engine, wl, name)
        phase("serve", f"{name}: {weights / 1e9:.3f} GB of weights for the "
                       f"three cell types ({held:.2f} GB allocated after "
                       f"the warm-up); {time.perf_counter() - t0:.2f} s "
                       f"(host clock, set-up and warm-up included); on "
                       f"{CARD['smi']}")
        del engine
        torch.cuda.empty_cache()
    launched = {k: n for k, n in _launch_counts().items() if n}
    if launched:
        raise AssertionError(f"live serving of {NO_KERNEL_MODELS}: kernels "
                             f"of ours launched {launched}")
    phase("launches", "no kernel of ours on the live serving of "
                      + ", ".join(NO_KERNEL_MODELS))


def serve_driver_phase() -> None:
    """Phase 6b: ``repro_torch.launch.serve.serve`` with the reference's
    defaults for the five paper models, then the recovery of
    ``examples/serve_cluster.py`` (the incumbent's type lost past its
    count, budget 10) on mtwnd and vgg19."""
    for name in PAPER_MODELS:
        reset_counts()
        t0 = time.perf_counter()
        opt, engine = serve(name, verbose=False, device="cuda")
        secs = time.perf_counter() - t0
        best = opt.trace.best_feasible()
        if best is None:
            raise AssertionError(f"serve {name}: no pool meets the target")
        msg = (f"{name}: best pool {best.config} at ${best.cost:.2f}/h, QoS "
               f"{best.qos_rate:.4f}, {opt.trace.n_samples} samples, "
               f"{secs:.2f} s (host clock, set-up and warm-up included)")
        if name in ("mtwnd", "vgg19"):
            t0 = time.perf_counter()
            new_opt, ev, lost_type, lost = recover(opt, engine)
            secs = time.perf_counter() - t0
            reduced = list(opt.space.bounds)
            reduced[lost_type] -= lost
            if ev.new_best is not None:
                new = new_opt.trace.best_feasible()
                if (tuple(new.config) != tuple(ev.new_best)
                        or any(c > b for c, b in zip(new.config, reduced))
                        or new.qos_rate < opt.qos_target):
                    raise AssertionError(f"recovery {name}: {new} in "
                                         f"bounds {reduced}")
                got = (f"{ev.new_best} at ${ev.new_cost:.2f}/h, QoS "
                       f"{new.qos_rate:.4f}")
            else:
                if new_opt.trace.best_feasible() is not None:
                    raise AssertionError(f"recovery {name}: the event says "
                                         "none is feasible, the trace not")
                got = "no feasible pool"
            msg += (f"; recovery after losing {lost} "
                    f"'{DEFAULT_CELLS[lost_type].name}' cell(s), bounds "
                    f"{tuple(reduced)}: {got} in {ev.samples_used} samples, "
                    f"{secs:.2f} s")
        counts = _launch_counts()
        bag = counts.pop("embedding_bag")
        if any(counts.values()) or (bag == 0) != (name != "mtwnd"):
            raise AssertionError(f"serve {name}: launches {counts}, "
                                 f"embedding_bag {bag}")
        phase("serve", f"driver {msg}; embedding_bag launches {bag}, no other"
                       f" kernel; on {CARD['smi']}")
        del opt, engine
        torch.cuda.empty_cache()


class _Served:
    """The latencies and waits of every segment a live plane measured, as
    the engine's own records held them right after its serve, cut to the
    prefix the scenario engine committed (the first ``commit`` after each
    ``measure``).  Search probes serve but never commit, so stay out."""

    def __init__(self, plane):
        self.segments = []
        measure, commit = plane.measure, plane.commit

        def spy_measure(*args, **kwargs):
            out = measure(*args, **kwargs)
            lat, waits = plane.engine.served_arrays()
            if len(lat) != len(out[0]):        # an empty pool: +inf
                lat, waits = out
            self.segments.append([lat, waits, None])
            return out

        def spy_commit(n):
            if self.segments and self.segments[-1][2] is None:
                self.segments[-1][2] = int(n)
            return commit(n)

        plane.measure, plane.commit = spy_measure, spy_commit

    def arrays(self):
        return (np.concatenate([s[0][:s[2]] for s in self.segments]),
                np.concatenate([s[1][:s[2]] for s in self.segments]))


def live_plane_phase() -> None:
    """Phase 9b: spot-churn through ``LivePlane`` over a live
    ``ClusterEngine`` (``examples/run_scenario.py --live``'s set-up, QoS
    within 30 ms) on mtwnd and vgg19 at full width; the report held to the
    spec and to the engine's own records; no fcfs_scan launch."""
    for name, n in LIVE_EPISODES:
        spec = build_episode("spot-churn", n=n)
        cells = DEFAULT_CELLS[:2]
        workloads = {d: paper_workload(name, seed=spec.seed,
                                       n_queries=spec.n_base_queries,
                                       rate_qps=40.0, batch_dist=d)
                     for d in spec.batch_dists}
        top = max(_bucket(int(w.batches.max())) for w in workloads.values())
        engine = ClusterEngine(name, cells, seed=spec.seed, device="cuda")
        engine.warmup(max_batch=top)
        qos = 0.03
        plane = LivePlane(engine, workloads, qos_latency=qos,
                          probe_queries=30)
        served = _Served(plane)
        space = SearchSpace(bounds=(3, 2),
                            prices=tuple(c.price for c in cells))
        reset_counts()
        t0 = time.perf_counter()
        rep = ScenarioEngine(spec, plane, space, device="cuda").run()
        secs = time.perf_counter() - t0
        d = rep.to_dict()
        lat, waits = served.arrays()
        hit = lat <= qos
        ends = [0]
        for ph in spec.phases:
            ends.append(ends[-1] + ph.n_queries)
        starts = [w["start"] for w in d["windows"]]
        checks = {
            "plane": rep.plane == "live",
            "phases": [(p.name, p.n_queries) for p in rep.phases]
            == [(p.name, p.n_queries) for p in spec.phases],
            "windows": starts == [0] + [w["end"] for w in d["windows"]][:-1]
            and d["windows"][-1]["end"] == ends[-1]
            and all(w["end"] - w["start"] <= spec.window
                    and not any(w["start"] < e < w["end"] for e in ends)
                    for w in d["windows"]),
            "served": len(lat) == d["total_queries"] == ends[-1],
            "last phase QoS": rep.phases[-1].qos_rate
            == float(np.mean(hit[-rep.phases[-1].n_queries:])),
            "window QoS": all(w["qos_rate"]
                              == float(np.mean(hit[w["start"]:w["end"]]))
                              for w in d["windows"]),
            "no sweep": rep.final_qos_by_phase is None,
            "waits": bool((waits >= 0).all()),
            "evaluations": plane.n_evals >= 1,
        }
        counts = _launch_counts()
        bag = counts.pop("embedding_bag")
        checks["launches"] = not any(counts.values()) and (
            (bag > 0) == (name == "mtwnd"))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"live plane {name}: {failed} failed; "
                                 f"launches {counts}, embedding_bag {bag}")
        ok = np.isfinite(lat)
        svc = (lat[ok] - waits[ok]) * 1e3
        phase("live", f"spot-churn n {n} on {name} (cells "
                      f"{[c.name for c in cells]}, bounds (3, 2), 40 qps, "
                      f"QoS within {qos * 1e3:.0f} ms, target "
                      f"{spec.qos_target}): QoS {d['qos_rate']!r}, "
                      f"${d['total_cost']!r}, {d['bo_evals']} evaluations "
                      f"({plane.n_evals} probes), {d['n_windows']} windows "
                      f"({d['violation_windows']} violating), final "
                      f"{tuple(d['final_config'])}, actions "
                      f"{[a['kind'] for a in d['actions']]}; service p50 "
                      f"{np.percentile(svc, 50):.4f} ms, p99 "
                      f"{np.percentile(svc, 99):.4f} ms; {secs:.2f} s (host "
                      f"clock, the GP on the card); every gate held; "
                      f"embedding_bag launches {bag}, no fcfs_scan; on "
                      f"{CARD['smi']}")
        del plane, engine
        torch.cuda.empty_cache()


def _search(model: str, device: str) -> dict:
    """RIBBON's search path for one paper model on ``device``:
    make_paper_setup, then the smallest homogeneous pool of the first type
    meeting the target (best_homogeneous); for the anchor model also the
    quickstart's search (run_ribbon, the evaluator's batch path given) and
    the exhaustive optimum."""
    t0 = time.perf_counter()
    ev, space, profile = make_paper_setup(model, device=device)
    out = {"ev": ev, "homog": best_homogeneous(ev, 0, space.prices,
                                               ANCHOR["qos_target"])}
    if model == ANCHOR["model"]:
        trace = run_ribbon(space, ev, ANCHOR["qos_target"],
                           budget=ANCHOR["budget"], start=ANCHOR["start"],
                           evaluate_qos_batch=ev.batch, device=device)
        out["evals"] = [(e.config, e.qos_rate) for e in trace.evaluations]
        out["best"] = trace.best_feasible()
        out["n_evals"] = ev.n_evals
        out["exhaustive"] = ev.exhaustive(space, ANCHOR["qos_target"])
    if device == "cuda":
        torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    return out


def search_path() -> int:
    """RIBBON's own main path on the card, for the five paper models, held
    against the same path on the CPU in this process: the same homogeneous
    pools, and for mtwnd the same evaluated configs in the same order with
    the same QoS rates bit for bit, the same best pool and the same
    exhaustive optimum.  Returns the simulator dispatches made on the
    card."""
    dispatches = 0
    for model in PAPER_MODELS:
        card, cpu = _search(model, "cuda"), _search(model, "cpu")
        dispatches += card["ev"].sim.n_dispatches
        for key in ("homog", "evals", "best", "n_evals", "exhaustive"):
            if card.get(key) != cpu.get(key):
                raise AssertionError(f"search {model}: {key} on the card "
                                     f"{card.get(key)} != CPU {cpu.get(key)}")
        count, cost = card["homog"]
        msg = (f"{model}: homogeneous optimum {count} x "
               f"{PAPER_POOLS[model]['diverse'][0]} at ${cost:.3f}/h")
        if "best" in card:
            best = card["best"]
            if best is None:
                raise AssertionError("search: no feasible pool")
            ex_cfg, ex_cost, _ = card["exhaustive"]
            msg += (f"; RIBBON best pool {best.config} at ${best.cost:.3f}/h, "
                    f"QoS {best.qos_rate}, after {len(card['evals'])} "
                    f"evaluations ({card['n_evals']} pools simulated, the "
                    f"homogeneous sweep included); exhaustive "
                    f"optimum {ex_cfg} at ${ex_cost:.3f}/h")
        phase("search", msg + f"; card {card['s']:.2f} s, CPU {cpu['s']:.2f} "
                              f"s (host clock, set-up included); the same "
                              "results on both")
    return dispatches


def _converge(opt: RibbonOptimizer, ev) -> RibbonOptimizer:
    """The example's base-load search: ask/tell until done."""
    while not opt.done:
        cfg = opt.ask()
        if cfg is None:
            break
        opt.tell(cfg, ev(cfg))
    return opt


def _tel_fields(tel) -> tuple:
    return tuple(np.asarray(getattr(tel, f)).tolist() for f in (
        "served", "miss", "busy_ms", "lat_hist", "wait_hist", "depth_sum",
        "depth_peak"))


def _load_change(device: str) -> dict:
    """RIBBON's load-change adaptation (paper §5.5) with the simulator on
    ``device``: ``examples/autoscale_loadchange.py`` (converge on mtwnd's
    base load from (5, 0, 0), detect the 1.5x load with the monitor,
    re-measure the incumbent, the sequential ``rescale(budget=40)``), then
    the warm anchor under ``policy=None`` and ``"hedged"`` (the base pool's
    segment with telemetry, its carry after 1000 queries rebased to the
    1000th arrival, ``rescale(budget=40, load_factors=[1.0, 1.5],
    warm_state=..., deployed=base, policy=...)``), the base and new pools'
    warm telemetry under both loads, and ``tail_latency(base, 99)``.  The
    BO's GP runs on the host in both runs (its card-vs-host agreement is
    phase 6's), so the two runs differ only in where the simulator runs."""
    t0 = time.perf_counter()
    ev, space, profile = make_paper_setup("mtwnd", device=device)

    def optimizer():
        return _converge(RibbonOptimizer(space, qos_target=0.99,
                                         start=(5, 0, 0), device="cpu"), ev)

    opt = optimizer()
    base = opt.trace.best_feasible()
    out = {"base": (base.config, base.cost, base.qos_rate,
                    opt.trace.n_samples)}
    hot = PoolEvaluator(profile, ev.types, ev.workload.scaled(1.5),
                        device=device)
    monitor = LoadMonitor(qos_target=0.99)
    lat0 = ev.sim.simulate(base.config).lat
    monitor.observe(lat0, np.zeros_like(lat0), profile.qos_latency)
    lat1 = hot.sim.simulate(base.config).lat
    detected = monitor.observe(lat1, np.maximum(lat1 - lat0, 0),
                               profile.qos_latency)
    event = rescale(opt, hot, budget=40)
    out["example"] = (detected, hot(base.config), vars(event))
    for name in (None, "hedged"):
        pol = None if name is None else named_policy(name, space.prices)
        opt = optimizer()
        seg = ev.sim.segment_from(ev.sim.initial_state(), base.config,
                                  policy=pol, telemetry=True)
        st = seg.state_at(1000).rebased(float(ev.workload.arrivals[1000]))
        event = rescale(opt, ev, budget=40, load_factors=[1.0, 1.5],
                        warm_state=st, deployed=base.config, policy=pol)
        pools = [base.config] + ([event.new_best] if event.new_best else [])
        view = ev.sim.qos(pools, workloads=[1.0, 1.5], state=st,
                          deployed=base.config, policy=pol, telemetry=True)
        out[name] = (vars(event), _tel_fields(seg.telemetry),
                     seg.telemetry.latency_percentile(99),
                     ev.sim.tail_latency(base.config, 99, policy=pol),
                     view.rates.tolist(), _tel_fields(view.telemetry))
    if device == "cuda":
        torch.cuda.synchronize()
    out["dispatches"] = ev.sim.n_dispatches + hot.sim.n_dispatches
    out["s"] = time.perf_counter() - t0
    return out


def load_change_path() -> int:
    """Paper §5.5 on the card, held against the same path on the CPU in
    this process: every result equal, rates bit for bit.  Returns the
    simulator dispatches made on the card."""
    card, cpu = _load_change("cuda"), _load_change("cpu")
    for key in ("base", "example", None, "hedged"):
        if card[key] != cpu[key]:
            raise AssertionError(f"load change {key}: card {card[key]} != "
                                 f"CPU {cpu[key]}")
    (cfg, cost, rate, n), (detected, incumbent, seq) = (card["base"],
                                                        card["example"])
    if not detected or seq["new_best"] is None:
        raise AssertionError(f"load change: detected {detected}, sequential "
                             f"rescale {seq}")
    phase("load", f"base load: {cfg} at ${cost:.3f}/h, QoS {rate}, after "
                  f"{n} samples; 1.5x load detected by the monitor "
                  f"({detected}), the incumbent's QoS under it {incumbent:.3f};"
                  f" sequential rescale(budget=40): {seq['new_best']} at "
                  f"${seq['new_cost']:.3f}/h in {seq['samples_used']} samples")
    for name in (None, "hedged"):
        e, _, p99, tail, rates, _ = card[name]
        phase("load", f"warm anchor, policy {name}: {e['new_best']} at "
                      f"${e['new_cost']}/h in {e['samples_used']} samples, "
                      f"qos_by_load {e['qos_by_load']}; segment telemetry "
                      f"p99 {p99} s, tail_latency(base, 99) {tail} s; base "
                      f"and new pools warm under loads 1.0 and 1.5: QoS "
                      f"{rates}")
    phase("load", f"card {card['s']:.2f} s, CPU {cpu['s']:.2f} s (host clock, "
                  f"set-up and the host's GP included), {card['dispatches']} "
                  "simulator dispatches each; every result equal, rates and "
                  "telemetry bit for bit")
    return card["dispatches"]


def _stream(device: str, spec, config, n: int):
    """One streamed QoS evaluation on ``device``: (result, simulator, host
    seconds)."""
    profile, types = _pool()
    sim = StreamingSimulator(profile, types, spec, device=device)
    t0 = time.perf_counter()
    res = sim.qos(config, n)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, sim, time.perf_counter() - t0


def stream_path() -> int:
    """The streaming path (phase 7c): mtwnd's (2, 3, 3) at 800 qps in
    chunks of 4096 over 10,000 queries on the card and on the CPU (equal,
    0.9821), over 1,000,000 on the card (981,041 hits, no rebase, exactly
    one stream launch a chunk and no other launch), and the rebase case at
    0.05 qps on the card and the CPU (1.0, 4 rebases).  Returns the
    launches (all stream flavour)."""
    spec, config = paper_spec(STREAM["model"], seed=0), STREAM["config"]
    small, small_sim, small_s = _stream("cuda", spec, config, STREAM["small"])
    small_cpu, _, small_cpu_s = _stream("cpu", spec, config, STREAM["small"])
    if small != small_cpu or (small.rate, small.rebases) != (
            STREAM["small_rate"], 0):
        raise AssertionError(f"stream {STREAM['small']}: card {small}, CPU "
                             f"{small_cpu}, anchor {STREAM['small_rate']}")
    before = {fn.__name__: fn.launches for fn in COUNTED}
    full, full_sim, full_s = _stream("cuda", spec, config, STREAM["full"])
    ran = {name: fn.launches - before[name] for fn, name in
           zip(COUNTED, before)}
    chunks = math.ceil(STREAM["full"] / spec.chunk)
    scans = ran.pop("fcfs_scan_cuda")
    if (full.rate, full.rebases) != (STREAM["full_hits"] / STREAM["full"], 0) \
            or scans != chunks or full_sim.n_dispatches != chunks \
            or any(ran.values()):
        raise AssertionError(f"stream {STREAM['full']}: {full}, "
                             f"{full_sim.n_dispatches} chunks; anchor "
                             f"{STREAM['full_hits']} hits in {chunks} "
                             f"launches; other kernels {ran}")
    slow = paper_spec(STREAM["model"], seed=0, rate_qps=STREAM["rebase_qps"])
    args = (slow, STREAM["rebase_config"], STREAM["rebase_n"])
    rebase, rebase_sim, _ = _stream("cuda", *args)
    rebase_cpu, _, _ = _stream("cpu", *args)
    if rebase != rebase_cpu or (rebase.rate, rebase.rebases) != (
            1.0, STREAM["rebases"]):
        raise AssertionError(f"stream rebase: card {rebase}, CPU "
                             f"{rebase_cpu}")
    phase("stream", f"mtwnd {config}, 800 qps, chunks of {spec.chunk}: "
                    f"{STREAM['small']:,} queries {small.rate} on the card "
                    f"({small_s:.3f} s) and the CPU ({small_cpu_s:.3f} s); "
                    f"{STREAM['full']:,} queries on the card: "
                    f"{round(full.rate * STREAM['full']):,} within QoS, "
                    f"{full.rebases} rebases, {full_sim.n_dispatches} "
                    f"launches, {full_s:.3f} s (host clock), "
                    f"{full_sim.gen_s / full_s:.1%} of it making chunks "
                    f"(threefry on the host, the copy up), "
                    f"{full_sim.scan_s / full_s:.1%} in the launches; at "
                    f"{STREAM['rebase_qps']} qps {STREAM['rebase_config']} "
                    f"over {STREAM['rebase_n']:,}: {rebase.rate}, "
                    f"{rebase.rebases} rebases on card and CPU; on "
                    f"{CARD['smi']}")
    return (small_sim.n_dispatches + full_sim.n_dispatches
            + rebase_sim.n_dispatches)


def _episode(name: str, device: str, stream_chunk=None) -> dict:
    """One registry episode on mtwnd's plane on ``device`` (``SCENARIOS``
    or full-size diurnal-day); the engine's GP on the host."""
    case = SCENARIOS.get(name, dict(episode=name, kw={}, tiered=False))
    spec = build_episode(case["episode"], **case["kw"])
    make = tiered_simulator_plane if case["tiered"] else paper_simulator_plane
    t0 = time.perf_counter()
    plane, space = make("mtwnd", spec, stream_chunk=stream_chunk,
                        device=device)
    rep = ScenarioEngine(spec, plane, space, device="cpu").run()
    if device == "cuda":
        torch.cuda.synchronize()
    return {"report": rep.to_dict(), "dispatches": plane.n_dispatches,
            "s": time.perf_counter() - t0}


def _anchor_of(d: dict) -> tuple:
    return (d["qos_rate"], d["total_cost"], d["bo_evals"], d["n_windows"],
            d["violation_windows"], tuple(d["final_config"]),
            tuple(a["kind"] for a in d["actions"]))


def scenario_path() -> int:
    """The scenario path (phase 9): diurnal-day at n 2000 / window 400,
    spot-churn and tier-outage at n 500 (the latter on the tiered plane:
    fault.py and tiers.py) on the card and on the CPU, equal reports equal
    to their anchors; then full-size diurnal-day (1,000,000 queries) on
    the card with stream_chunk 4096 against its anchors.  Returns the
    simulator dispatches made on the card."""
    dispatches = 0
    for name, case in SCENARIOS.items():
        card, cpu = _episode(name, "cuda"), _episode(name, "cpu")
        dispatches += card["dispatches"]
        if card["report"] != cpu["report"]:
            raise AssertionError(f"scenario {name}: the card's report "
                                 "differs from the CPU's")
        got = _anchor_of(card["report"])
        if got != case["anchor"]:
            raise AssertionError(f"scenario {name}: {got} != anchor "
                                 f"{case['anchor']}")
        phase("scenario", f"{name} {case['kw']}: QoS {got[0]}, ${got[1]}, "
                          f"{got[2]} evaluations, {got[3]} windows "
                          f"({got[4]} violating), final {got[5]}, actions "
                          f"{list(got[6])}; card {card['s']:.2f} s, CPU "
                          f"{cpu['s']:.2f} s (host clock), "
                          f"{card['dispatches']} dispatches; the same report "
                          "on both, equal to the anchors")
    full = _episode("diurnal-day", "cuda", stream_chunk=4096)
    dispatches += full["dispatches"]
    d, a = full["report"], DIURNAL_DAY
    got = (d["total_queries"], round(d["qos_rate"], 6), d["bo_evals"],
           d["n_windows"], d["violation_windows"], tuple(d["final_config"]))
    want = (a["queries"], a["qos"], a["evals"], a["windows"], a["violating"],
            a["final"])
    if got != want or abs(d["total_cost"] - a["cost"]) > 1e-9 * a["cost"]:
        raise AssertionError(f"diurnal-day full size: {got}, "
                             f"${d['total_cost']!r}; anchor {want}, "
                             f"${a['cost']!r}")
    phase("scenario", f"diurnal-day at full size (5 x 200,000 queries, "
                      f"window 20,000, stream_chunk 4096) on the card: "
                      f"{d['total_queries']:,} queries, QoS {d['qos_rate']}, "
                      f"${d['total_cost']!r}, {d['bo_evals']} evaluations, "
                      f"{d['n_windows']} windows ({d['violation_windows']} "
                      f"violating), final {tuple(d['final_config'])}: the "
                      f"anchors; {full['s']:.2f} s (host clock, set-up and "
                      f"the host's GP included), {full['dispatches']} "
                      f"dispatches; on {CARD['smi']}")
    return dispatches


def catalog_phase() -> None:
    """RIBBON over pools of H100 serving cells (``serving.cells``, the
    reference's ``bench_tpu_cells`` procedure over ``H100_CELLS``): host
    code, the simulator on the CPU; printed, not gated."""
    t0 = time.perf_counter()
    names = ("h100x8", "h100x4", "h100x1")
    res = search_cells([H100_CELLS[n] for n in names], device="cpu")
    homog = (f"{res.homog_count} x h100x8 at ${res.homog_cost:.2f}/h"
             if res.homog_count else "none of 1..6 x h100x8 meets it")
    phase("catalog", f"{LLM_PROFILE.name} over ({', '.join(names)}), QoS "
                     f"{cell_catalog.QOS_TARGET} within "
                     f"{LLM_PROFILE.qos_latency * 1e3:.0f} ms, "
                     f"{cell_catalog.N_QUERIES} queries at "
                     f"{cell_catalog.RATE_QPS} qps, "
                     f"bounds {cell_catalog.BOUNDS}: "
                     f"homogeneous {homog}; exhaustive optimum "
                     f"{res.best_config} at ${res.best_cost:.2f}/h (saving "
                     f"{res.saving_pct:.1f} %); RIBBON {res.ribbon_config} at "
                     f"${res.ribbon_cost:.2f}/h after {res.ribbon_samples} "
                     f"samples; {time.perf_counter() - t0:.2f} s on the host "
                     "(modelled cells, printed, not gated)")


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def _rel(got, want) -> float:
    """max |got - want| over max |got|."""
    return (got - want).abs().max().item() / got.abs().max().item()


def _lm_gate(name: str, got, want, tol: float) -> float:
    """Kernel path's logits against the plain path's: finite, within
    tol x max |logits|, the same greedy tokens.  Returns the relative
    difference."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"LM {name}: non-finite logits")
    rel = _rel(got, want)
    if not rel <= tol:
        raise AssertionError(f"LM {name}: max |diff| {rel} x max |logits| "
                             f"> {tol}")
    if not torch.equal(_greedy(got), _greedy(want)):
        raise AssertionError(f"LM {name}: greedy tokens differ")
    return rel


def _chunked_fp64(x, dt, a_log, b, c, chunk):
    """``ssm.ssd_chunked``'s math in float64 throughout, y cast back to x's
    type, the final state to float32: the exact side of the plain path's
    own rounding (float64 rounds 2^29 times finer than float32), which
    autograd can differentiate."""
    f = torch.float64
    bsz, slen, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = slen // chunk
    da = dt.to(f) * -torch.exp(a_log.to(f))
    xc = (x.to(f) * dt.to(f)[..., None]).reshape(bsz, nc, chunk, h, p)
    bh = per_head(b.to(f).reshape(bsz, nc, chunk, g, n), h, 3)
    ch = per_head(c.to(f).reshape(bsz, nc, chunk, g, n), h, 3)
    da_t = da.reshape(bsz, nc, chunk, h).movedim(-1, 2)
    lmat = torch.exp(ssm_module.segsum(da_t))
    scores = torch.einsum("bzqhn,bzkhn->bzhqk", ch, bh)
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", scores * lmat, xc)
    da_cum = torch.cumsum(da_t, dim=-1)
    states = torch.einsum("bzqhn,bzhq,bzqhp->bzhpn", bh,
                          torch.exp(da_cum[..., -1:] - da_cum), xc)
    chunk_decay = torch.exp(da_cum[..., -1])
    state = torch.zeros((bsz, h, p, n), dtype=f, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    y_off = torch.einsum("bzqhn,bzhpn,bzhq->bzqhp", ch,
                         torch.stack(prev, dim=1), torch.exp(da_cum))
    return ((y_diag + y_off).reshape(bsz, slen, h, p).to(x.dtype),
            state.float())


@contextmanager
def plain_scan_in_fp64():
    """Within: the plain path's scan (``ssm.ssd_chunked``) is
    ``_chunked_fp64``; nothing else of the path changes."""
    chunked = ssm_module.ssd_chunked
    ssm_module.ssd_chunked = _chunked_fp64
    try:
        yield
    finally:
        ssm_module.ssd_chunked = chunked


class RoutingTape:
    """The MoE layers' expert picks, recorded on the fp32 kernel path and
    replayed, call by call, on the plain path, so that the fp32 gate holds
    the two paths' arithmetic under one set of discrete decisions: the
    kernel path's attention differs from the plain path's by float32
    rounding, and where a token's 8th and 9th experts lie closer than
    that, its top-8 set flips, and with it the token's output and, through
    the experts' capacity, the drops of later tokens (on an H100 one flip
    in 134,144 routings of olmoe-1b-7b's fp32 run moved its prefill
    logits by 3 % of max |logits|).  The plain path still
    computes its own picks; ``flips`` counts the tokens whose own set
    differs from the replayed one, of ``routed``.  Probabilities are the
    plain path's own, at the replayed experts, renormalised."""

    def __init__(self):
        self.picks = deque()
        self.mode = None
        self.flips = self.routed = self.pushed = self.popped = 0

    def route(self, real, moe, xt, k):
        probs, topk_p, topk_e = real(moe, xt, k)
        if self.mode == "record":
            self.picks.append(topk_e)
            self.pushed += 1
        elif self.mode == "replay":
            forced = self.picks.popleft()
            self.popped += 1
            self.flips += int((forced.sort(-1).values
                               != topk_e.sort(-1).values).any(-1).sum())
            self.routed += topk_e.shape[0]
            topk_p = probs.gather(1, forced)
            topk_p = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)
            topk_e = forced
        return probs, topk_p, topk_e

    @contextmanager
    def installed(self):
        """Within: ``layers.moe_route`` goes through the tape."""
        real = layers_module.moe_route
        layers_module.moe_route = partial(self.route, real)
        try:
            yield self
        finally:
            layers_module.moe_route = real

    @contextmanager
    def recording(self, on: bool):
        self.mode = "record" if on else "replay"
        try:
            yield
        finally:
            self.mode = None

    def drained(self, label: str) -> None:
        """Every recorded call replayed once (else AssertionError): the
        paths routed in the same order, as many times."""
        if self.picks or self.popped != self.pushed:
            raise AssertionError(f"{label}: the routing tape holds "
                                 f"{len(self.picks)} picks after "
                                 f"{self.pushed} recorded and {self.popped} "
                                 "replayed calls")


def lm_fp32(api, params, batch, prefill_step, run: LMRun):
    """fp32 kernel path against the plain path, teacher-forced on the
    kernel path's tokens, within LM_TOL x max |logits| and the same greedy
    tokens.  For a model with Mamba-2 layers a third run, the plain path
    with its scan in float64, measures how far the plain path's own fp32
    scan lies from exact over the run; the gate widens by that much, since
    two fp32 scans that round differently can each lie that far from exact.
    A model without a scan keeps LM_TOL.  (Decode steps run no scan, so the
    third run differs from the plain one only in its prefill.)  Returns the
    kernel path's greedy tokens (B, 1 + steps)."""
    names = ["kernel", "plain"]
    if api.cfg.family in ("ssm", "hybrid"):
        names.append("fp64 scan")
    tape = RoutingTape()

    def routing(name):
        if not api.cfg.is_moe:
            return nullcontext()
        return tape.recording(name == "kernel")

    def prefill(name):
        if name == "kernel":
            return prefill_step(params, batch)
        with plain_scan_in_fp64() if name == "fp64 scan" else nullcontext():
            return api.prefill(params, batch["tokens"], run.max_len,
                               batch["extra"], use_kernel=False)

    caches, logits = {}, {}
    with tape.installed():
        for name in names:
            with routing(name):
                caches[name], out = prefill(name)
            logits[name] = [out]
        if logits["kernel"][0].shape != (run.batch, 1, api.cfg.vocab_size):
            raise AssertionError(f"LM prefill logits "
                                 f"{tuple(logits['kernel'][0].shape)}")
        tok = _greedy(logits["kernel"][0])
        # the decoder's positions: a VLM's patches go in front of its
        # tokens, whisper's frames to its encoder
        seq = run.prompt + (run.extra if api.cfg.family == "vlm" else 0)
        wraps = [ring_wrap(caches["kernel"], seq)]
        for _ in range(run.steps):
            for name in names:
                with routing(name):
                    out, caches[name] = api.decode_step(
                        params, caches[name], tok,
                        use_kernel=name == "kernel")
                logits[name].append(out)
            tok = _greedy(logits["kernel"][-1])
        wraps.append(ring_wrap(caches["kernel"], seq + run.steps))

    def farthest(a, b):
        return max(_rel(x, y) for x, y in zip(logits[a], logits[b]))

    noise = farthest("plain", "fp64 scan") if len(names) == 3 else 0.0
    worst = max(_lm_gate("fp32 prefill" if i == 0 else
                         f"fp32 decode step {i - 1}", k, p, LM_TOL + noise)
                for i, (k, p) in enumerate(zip(logits["kernel"],
                                               logits["plain"])))
    exact = "" if len(names) == 2 else (
        f"; from the fp64 scan's run the plain path lies up to {noise:.3g}, "
        f"the kernel path {farthest('kernel', 'fp64 scan'):.3g}")
    if api.cfg.is_moe:
        exact += (f"; the plain path ran the kernel path's expert picks: "
                  f"its own differ for {tape.flips} of {tape.routed} "
                  "token routings (near-ties)")
    phase("lm", f"{run.label} fp32, {run.batch} x {run.prompt} prompt tokens"
                f"{_extra_text(run)}, "
                f"{run.steps} decode steps: kernel path vs plain path max "
                f"|diff| {worst:.3g} x max |logits| (gate {LM_TOL} + "
                f"{noise:.3g}){exact}; the same greedy tokens at all "
                f"{run.steps + 1} positions")
    window = api.cfg.sliding_window
    if bool(window and seq > window) != all(wraps):
        raise AssertionError(f"{run.label}: window {window}, {seq} "
                             f"positions, ring wraps {wraps}")
    if all(wraps):
        phase("lm", f"{run.label}, a window of {window}: the prefill's flash "
                    f"attention lets through "
                    f"{op_walk.attention_pairs(seq, seq, True, window):,} of "
                    f"the {op_walk.attention_pairs(seq, seq, True, 0):,} "
                    f"causal (query, key) pairs of its {seq} positions; "
                    f"after the prefill {wraps[0]}; after {run.steps} steps "
                    f"{wraps[1]} (every step attends over the full ring)")
    return torch.cat([_greedy(out) for out in logits["kernel"]], dim=1)


def ring_wrap(cache: dict, t: int) -> str:
    """After ``t`` positions, where they outnumber the KV ring's W slots:
    the ring holds exactly positions t - W .. t - 1, position p in slot
    p mod W (else AssertionError); its oldest and newest positions with
    their slots, as text.  "" where the ring did not wrap."""
    w = cache["pos"].shape[0] if "pos" in cache else t
    if t <= w:
        return ""
    held = cache["pos"].long().cpu()
    want = torch.arange(t - w, t)
    if not torch.equal(held[want % w], want):
        raise AssertionError(f"KV ring after {t} positions holds "
                             f"{held.min().item()}..{held.max().item()}, "
                             f"expected {t - w}..{t - 1}")
    return (f"the ring of {w} slots holds positions {t - w}-{t - 1}: the "
            f"oldest, {t - w}, in slot {(t - w) % w}, the newest, {t - 1}, "
            f"in slot {(t - 1) % w}")


def lm_serve(params, batch, prefill_step, serve_step, steps: int):
    """One bf16 serving run on the kernel path: prefill, then greedy decode
    steps; returns (prefill ms, decode ms per step, tokens (B, 1 + steps))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = prefill_step(params, batch)
    tok = _greedy(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(steps):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps, torch.cat(out, 1)


def lm_agreement(api, params, batch, served, run: LMRun,
                 use_kernel: bool = False) -> float:
    """Share of the greedy tokens ``served`` (B, 1 + steps) that a path
    (the plain one by default), fed the same prefixes, also picks."""
    cache, logits = api.prefill(params, batch["tokens"], run.max_len,
                                batch["extra"], use_kernel=use_kernel)
    same = [_greedy(logits) == served[:, :1]]
    for i in range(run.steps):
        logits, cache = api.decode_step(params, cache, served[:, i:i + 1],
                                        use_kernel=use_kernel)
        same.append(_greedy(logits) == served[:, i + 1:i + 2])
    return torch.cat(same, 1).float().mean().item()


def lm_phase(api, params, batch, run: LMRun) -> dict:
    """The LM serving path: fp32 kernel vs plain, then bf16 serving runs.
    Returns the prefills and decode steps taken on the kernel path and the
    bf16 timings."""
    prefill_step = make_prefill_step(api, run.max_len)
    serve_step = make_decode_step(api)
    fp32_tokens = lm_fp32(api, params, batch, prefill_step, run)
    params.to(torch.bfloat16)
    routers = [b.dtype for n, b in params.named_buffers()
               if n.endswith("router")]
    if any(dt != torch.float32 for dt in routers):
        raise AssertionError(f"{run.label}: MoE routers {set(routers)} in bf16 "
                             "serving, expected float32")
    runs = [lm_serve(params, batch, prefill_step, serve_step, run.steps)
            for _ in range(2)]
    prefill_ms, step_ms, served = runs[-1]
    if not torch.equal(runs[0][2], served):
        raise AssertionError("LM bf16: two serving runs gave other tokens")
    agreement = ""
    if run.timed:
        agree = lm_agreement(api, params, batch, served, run)
        kern32, plain32 = (lm_agreement(api, params, batch, fp32_tokens,
                                        run, use_kernel=k)
                           for k in (True, False))
        agreement = (f"; kernel path agrees with the plain path on "
                     f"{agree:.4f} of {served.numel()} greedy tokens; of the "
                     f"fp32 kernel path's greedy tokens, fed the same "
                     f"prefixes, the bf16 kernel path picks {kern32:.4f} and "
                     f"the bf16 plain path {plain32:.4f} (printed, not "
                     "gated)")
    router = (f"; its {len(routers)} MoE routers stay float32"
              if routers else "")
    phase("lm", f"{run.label} bf16 serving (second of 2 runs, eager): "
                f"prefill {prefill_ms:.2f} ms for {run.batch} x {run.prompt} "
                f"tokens{_extra_text(run)}, decode {step_ms:.3f} ms per step = "
                f"{run.batch * 1e3 / step_ms:.1f} tokens/s{agreement}{router}")
    # kernel-path runs: the fp32 comparison, the bf16 serving runs and, in
    # a timed run, the bf16 kernel path's agreement with the fp32 tokens
    n_runs = 1 + len(runs) + run.timed
    return {"prefills": n_runs, "steps": n_runs * run.steps,
            "prefill_ms": prefill_ms, "step_ms": step_ms}


def lm_device_phase(api, params, batch, lm: dict, run: LMRun) -> dict:
    """Device-only bf16 prefill and decode-step times (CUDA graph replays,
    launched outside the counted run) against the eager times; returns the
    device-only ms by call."""
    tokens, extra = batch["tokens"], batch["extra"]
    cache, logits = api.prefill(params, tokens, run.max_len, extra)
    tok = _greedy(logits)
    step_dev = graph_ms(lambda: api.decode_step(params, cache, tok),
                        calls=4, replays=5)
    prefill_dev = graph_ms(lambda: api.prefill(params, tokens, run.max_len,
                                               extra),
                           calls=1, replays=3)
    phase("lm", f"{run.label} bf16 device-only (CUDA graph): prefill "
                f"{prefill_dev:.2f} ms, decode step {step_dev:.3f} ms; so "
                f"the card idles {1 - prefill_dev / lm['prefill_ms']:.1%} of "
                f"an eager prefill and {1 - step_dev / lm['step_ms']:.1%} of "
                f"an eager decode step")
    return {"prefill": prefill_dev, "decode step": step_dev}


def _extra_text(run: LMRun) -> str:
    if not run.extra:
        return ""
    kind = "patches" if get_arch(run.arch).family == "vlm" else "frames"
    return f" after {run.extra} {kind}"


def _lm_shape(cfg) -> str:
    """The architecture's shape, as lm_path prints it."""
    if cfg.family in ("ssm", "hybrid"):
        shape = f"{cfg.ssm_nheads} SSM heads of {cfg.ssm_headdim}, state " \
                f"{cfg.ssm_state}, d_inner {cfg.d_inner}"
    elif cfg.attention == "mla":
        shape = (f"MLA: {cfg.n_heads} heads, q/k {cfg.qk_nope_dim} + "
                 f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}, q_lora "
                 f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
                 f"d_ff {cfg.d_ff}")
    else:
        shape = f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of " \
                f"{cfg.d_head}, d_ff {cfg.d_ff}"
    if cfg.is_moe:
        shape += (f", {cfg.n_experts} experts top-{cfg.top_k} of "
                  f"{cfg.expert_ff}, capacity factor {cfg.moe_capacity_factor}")
    if cfg.kv_quant_int8:
        shape += ", int8 KV cache"
    if cfg.family == "vlm":
        shape += f", {cfg.n_patches} patches"
    if cfg.family == "encdec":
        shape += (f"; {cfg.n_encoder_layers} encoder layers over "
                  f"{cfg.encoder_seq} frames")
    if cfg.family == "hybrid":
        shape += (f"; {cfg.n_layers // cfg.attn_every} super-blocks of "
                  f"{cfg.attn_every}, each followed by the shared block of "
                  f"{cfg.n_heads} heads x {cfg.d_head}, window "
                  f"{cfg.sliding_window}, d_ff {cfg.d_ff}")
    return shape


def lm_path(run: LMRun) -> dict:
    """One LM's serving path at full width and depth, random weights (and
    patch or frame embeddings, N(0, 0.02^2) as the token embeddings) from
    seed 0: counts set to 0 just before its serving runs and read just
    after, each kernel's count held to ``run``'s launches per prefill and
    per step, and the attention kernels' counts by type to the fp32 run's
    1 prefill and ``run.steps`` steps, the rest bf16.  Returns the counts,
    the attention kernels' counts by type and the bf16 device-only ms of a
    prefill and a decode step (None for a run that is not timed)."""
    api = get_model(dataclasses.replace(get_arch(run.arch),
                                        **dict(run.changes)))
    cfg = api.cfg
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(gen, torch.float32, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (run.batch, run.prompt),
                           generator=gen, device="cuda", dtype=torch.int32)
    extra = None
    if run.extra:
        extra = torch.randn((run.batch, run.extra, cfg.d_model),
                            generator=gen, device="cuda") * 0.02
    batch = {"tokens": tokens, "extra": extra}
    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in params.parameters()) + sum(
        b.numel() for b in params.buffers())
    phase("lm", f"{run.label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"{_lm_shape(cfg)}, vocab {cfg.vocab_size}; "
                f"{n_params / 1e9:.3f} B parameters, random from seed 0")
    reset_counts()
    lm = lm_phase(api, params, batch, run)
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    for name, got in counts.items():
        want = (run.per_prefill.get(name, 0) * lm["prefills"]
                + run.per_step.get(name, 0) * lm["steps"])
        if got != want:
            raise AssertionError(
                f"{run.label} path: {name} launched {got} times, expected "
                f"{run.per_prefill.get(name, 0)} x {lm['prefills']} prefills "
                f"+ {run.per_step.get(name, 0)} x {lm['steps']} steps")
    by_dtype = {fn.__name__[:-5]: dict(fn.launches_by_dtype)
                for fn in COUNTED if hasattr(fn, "launches_by_dtype")}
    for name, got in by_dtype.items():
        per_p, per_s = run.per_prefill.get(name, 0), run.per_step.get(name, 0)
        want = {"float32": per_p + per_s * run.steps,
                "bfloat16": per_p * (lm["prefills"] - 1)
                + per_s * (lm["steps"] - run.steps)}
        if got != want:
            raise AssertionError(f"{run.label} path: {name} launches by type "
                                 f"{got}, expected {want}")
    phase("launches", f"{run.label} path: " + "; ".join(
        f"{name} {counts[name]} = {per} x {lm[unit]} {unit}"
        for per_unit, unit in ((run.per_prefill, "prefills"),
                               (run.per_step, "steps"))
        for name, per in per_unit.items()) + "; no other kernel" + "".join(
            f"; {name} by type {c}" for name, c in by_dtype.items()
            if any(c.values())))
    device_ms = (lm_device_phase(api, params, batch, lm, run) if run.timed
                 else None)
    phase("lm", f"{run.label}: {time.perf_counter() - t0:.1f} s from its "
                "weights drawn to here (host clock)")
    del params, batch
    torch.cuda.empty_cache()
    return counts, by_dtype, device_ms


def train_launches(cfg, n_micro: int = 1, steps: int = 1) -> dict:
    """Each kernel's launches in ``steps`` train steps of ``n_micro``
    microbatches of ``cfg`` on the kernel path.  A forward launches flash
    once an attention call (a decoder layer's; the hybrid's shared block
    once a super-block; the encoder-decoder's encoder layers, and its
    decoder layers twice, self and cross) and ``ssd_scan`` once a Mamba-2
    layer; with remat each block runs its forward again in the backward
    (the backward itself differentiates the plain math, no kernel)."""
    if cfg.family == "ssm":
        forward = {"ssd_scan": cfg.n_layers}
    elif cfg.family == "hybrid":
        forward = {"ssd_scan": cfg.n_layers,
                   "flash_attention": cfg.n_layers // cfg.attn_every}
    elif cfg.family == "encdec":
        forward = {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers}
    else:
        forward = {"flash_attention": cfg.n_layers}
    times = (2 if cfg.remat else 1) * n_micro * steps
    return {name: n * times for name, n in forward.items()}


def _train_model(cfg, device: str = "cuda"):
    """``cfg`` on ``device``, random float32 weights from seed 0, every
    parameter trainable."""
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    return api, make_trainable(api.init_params(gen, torch.float32, device))


def _train_batch(cfg, b: int = TRAIN_B, s: int = TRAIN_S,
                 device: str = "cuda", source=None, gen=None) -> dict:
    """tokens and labels (b, s), the next batch of ``source`` (default: the
    first of the synthetic stream of seed 0); for the encoder-decoder also
    its frames (b, encoder_seq, d_model), N(0, FRAME_STD^2) from ``gen``,
    on its device (default: seed 0 on ``device``)."""
    if source is None:
        source = SyntheticTokens(cfg.vocab_size, seed=0)
    chunk = torch.from_numpy(source.batch(b, s)).to(device)
    batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    if cfg.family == "encdec":
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        batch["extra"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                     generator=gen,
                                     device=gen.device) * FRAME_STD
    return batch


def _launched(label: str, wants: dict, dtype: str) -> None:
    """Hold the launch counts since the last reset to ``wants`` (kernel ->
    launches), all of ``dtype``, and no other kernel; then reset."""
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    by_dtype = {fn.__name__[:-5]: dict(fn.launches_by_dtype)
                for fn in COUNTED if fn.__name__[:-5] in wants}
    if any(n != wants.get(k, 0) for k, n in counts.items()) or any(
            by_dtype[k].get(dtype, 0) != n for k, n in wants.items()):
        raise AssertionError(f"training {label}: launches {counts} (by type "
                             f"{by_dtype}), expected {wants} in {dtype} and "
                             "no other kernel")
    for kernel, n in wants.items():
        TRAIN_LAUNCHES.setdefault(kernel, {"float32": 0, "bfloat16": 0})[
            dtype] += n
    reset_counts()


TRAIN_LAUNCHES: dict = {}


def fp32_gate_steps(api, params, batch, after, n_micro: int = 1) -> dict:
    """One fp32 ``make_train_step`` of ``n_micro`` microbatches from
    ``params`` and ``batch`` on the kernel path, on the reference's math
    (``use_kernel=False``) and, for a model with Mamba-2 layers, on that
    math with its chunked scan in float64; ``params`` is the kernel path's
    (the others take copies).  An MoE model's expert picks are recorded on
    the kernel path's step and replayed on the plain path's (RoutingTape,
    C-R31): under remat each layer routes in the forward and again in its
    recompute, in reverse layer order, on both paths alike, so the tape
    must end empty with every recorded call replayed once.  ``after(path)``
    runs after each path's step.  Returns {path: (loss, AdamW's first
    moment by name)} and, under "flips", the routings whose own picks
    differ from the replayed ones and all routings of the replay."""
    names = ["kernel", "plain"]
    if api.cfg.family in ("ssm", "hybrid"):
        names.append("fp64 scan")
    copies = {name: copy.deepcopy(params) for name in names[1:]}
    copies["kernel"] = params
    del params
    tape = RoutingTape()
    out = {}
    with tape.installed():
        for name in names:
            step = make_train_step(dataclasses.replace(
                api, loss=partial(api.loss, use_kernel=name == "kernel")),
                n_micro)
            p = copies.pop(name)
            opt = adamw.init(dict(p.named_parameters()))
            routing = tape.recording(name == "kernel") if api.cfg.is_moe \
                else nullcontext()
            scan = plain_scan_in_fp64() if name == "fp64 scan" \
                else nullcontext()
            with routing, scan:
                _, opt, metrics = step(p, opt, batch)
            out[name] = (float(metrics["loss"]), opt.m)
            after(name)
            del opt, p
            torch.cuda.empty_cache()
    if api.cfg.is_moe:
        tape.drained(f"training {api.cfg.name}")
        out["flips"] = (tape.flips, tape.routed)
    return out


def train_fp32_gate(cfg, label: str, n_micro: int = 1,
                    seq: int = TRAIN_S) -> None:
    """(a) ``fp32_gate_steps`` on the card from ``cfg``'s weights and first
    batch (B TRAIN_B x ``seq``), in ``n_micro`` microbatches: the losses
    within TRAIN_LOSS_RTOL, each leaf's gradient within TRAIN_GRAD_TOL x
    its max |g| (a ZERO_GRAD_LEAVES leaf: x at least ZERO_GRAD_FLOOR x
    the model's largest).  A model with
    Mamba-2 layers also takes the step with the plain path's chunked scan
    in float64 (forward and backward): the reference's chunked form in
    fp32 loses up to some 1e-3 of a gradient's size where
    exp(da_cum[-1] - da_cum) takes the difference of two cumulative sums
    of up to ~-3000 (the kernel keeps that sum in fp64), and both fp32
    paths differentiate that form.  The
    plain path's own largest distance from the float64 gradients, over
    every leaf, is that rounding's size; two fp32 evaluations may each lie
    that far, on either side, so there the gate widens by twice it (as
    ``lm_fp32`` widens the serving gate by the plain path's distance from
    a float64 scan).  The kernel path launches ``train_launches`` (each
    forward's launches twice: remat's recompute), the plain paths none."""
    api, params = _train_model(cfg)
    batch = _train_batch(cfg, s=seq)
    wants = train_launches(cfg, n_micro)

    def after(name: str) -> None:
        _launched(f"{label} fp32 {name} path", {
            k: n if name == "kernel" else 0 for k, n in wants.items()},
            "float32")

    out = fp32_gate_steps(api, params, batch, after, n_micro)
    del params

    def gap(a: str, b: str) -> dict:
        """max |a - b| over max |b|, leaf by leaf (of (1 - b1)·g); on a
        ZERO_GRAD_LEAVES leaf over at least ZERO_GRAD_FLOOR x the model's
        largest max |b|."""
        scale = {n: m.abs().max().item() for n, m in out[b][1].items()}
        floor = ZERO_GRAD_FLOOR * max(scale.values())
        return {n: (out[a][1][n] - m).abs().max().item()
                / max(scale[n], floor if n.endswith(ZERO_GRAD_LEAVES) else 0,
                      1e-30)
                for n, m in out[b][1].items()}

    loss_rel = abs(out["kernel"][0] - out["plain"][0]) / abs(out["plain"][0])
    between = gap("kernel", "plain")
    worst_name = max(between, key=between.get)
    tokens = tuple(batch["tokens"].shape)
    text = (f"{label} fp32 (TF32 off), {cfg.n_layers} layers, one step, "
            f"B {tokens[0]} x S {tokens[1]} in {n_micro} microbatch"
            f"{'es' if n_micro > 1 else ''}: loss kernel path "
            f"{out['kernel'][0]:.7f}, plain path {out['plain'][0]:.7f} (rel "
            f"{loss_rel:.3g}, gate {TRAIN_LOSS_RTOL}); gradients kernel vs "
            f"plain path, worst leaf {worst_name}: {between[worst_name]:.3g} "
            "x its max |g|")
    noise = 0.0
    if "fp64 scan" in out:
        kernel_off = gap("kernel", "fp64 scan")
        noise = max(gap("plain", "fp64 scan").values())
        text += (f"; from the fp64 scan's gradients the plain path lies up "
                 f"to {noise:.3g}, the kernel path up to "
                 f"{max(kernel_off.values()):.3g}")
    gate = TRAIN_GRAD_TOL + 2 * noise
    text += f" (gate {TRAIN_GRAD_TOL} + 2 x {noise:.3g})"
    zero = [n for n in between if n.endswith(ZERO_GRAD_LEAVES)]
    if zero:
        plain = out["plain"][1]
        size = max(plain[n].abs().max().item() for n in zero) / max(
            m.abs().max().item() for m in plain.values())
        text += (f"; {len(zero)} leaves {ZERO_GRAD_LEAVES} (zero gradient in "
                 f"exact arithmetic) gated against {ZERO_GRAD_FLOOR} x the "
                 f"model's largest max |g|: the plain path's max |g| there "
                 f"{size:.3g} of the largest, the paths "
                 f"{max(between[n] for n in zero):.3g} x the floor apart")
    if "flips" in out:
        flips, routed = out["flips"]
        text += (f"; the plain path ran the kernel path's expert picks "
                 f"(forward and recompute, every one replayed): its own "
                 f"differ for {flips} of {routed} token routings "
                 "(near-ties)")
    phase("train", text)
    if not loss_rel <= TRAIN_LOSS_RTOL or not between[worst_name] <= gate:
        raise AssertionError(f"training {label}: fp32 kernel path vs plain "
                             f"path loss {loss_rel:.3g}, gradient "
                             f"{between[worst_name]:.3g} ({worst_name})")
    del out
    torch.cuda.empty_cache()


def train_bf16_run(arch: str) -> list:
    """(b) ``train()`` for TRAIN_STEPS bf16 steps in TRAIN_MICRO
    microbatches, with an async checkpoint at step TRAIN_CUT (joined);
    its step-20 checkpoint is removed, as if the run had been cut after
    step TRAIN_CUT, and a second ``train(resume=True)`` runs steps
    TRAIN_CUT + 1 .. TRAIN_STEPS: its losses must be the first run's, bit
    for bit, and the mean loss of the last 5 steps below the first 5's."""
    per_step = train_launches(get_arch(arch), TRAIN_MICRO)
    kw = dict(batch_size=TRAIN_B, seq_len=TRAIN_S, smoke=False,
              n_micro=TRAIN_MICRO, param_dtype=torch.bfloat16, log_every=5,
              seed=0, device="cuda")
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt:
        t0 = time.perf_counter()
        _, _, losses = train(arch, steps=TRAIN_STEPS, ckpt_dir=ckpt,
                             ckpt_every=TRAIN_CUT, **kw)
        first_s = time.perf_counter() - t0
        _launched(f"{arch} bf16 run", {k: n * TRAIN_STEPS
                                       for k, n in per_step.items()},
                  "bfloat16")
        files = sorted(Path(ckpt).glob("step_*"))
        size = sum(f.stat().st_size for f in files) / 2 ** 30
        for f in Path(ckpt).glob(f"step_{TRAIN_STEPS:010d}.*"):
            f.unlink()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, _, resumed = train(arch, steps=TRAIN_STEPS - TRAIN_CUT,
                              ckpt_dir=ckpt, ckpt_every=10 * TRAIN_STEPS,
                              resume=True, **kw)
        resumed_s = time.perf_counter() - t0
        _launched(f"{arch} resumed run", {
            k: n * (TRAIN_STEPS - TRAIN_CUT) for k, n in per_step.items()},
            "bfloat16")
    torch.cuda.empty_cache()
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    equal = resumed == losses[TRAIN_CUT:]
    phase("train", f"{arch} bf16, {TRAIN_MICRO} microbatches, "
                   f"{TRAIN_STEPS} steps in {first_s:.1f} s (host clock, "
                   f"two checkpoints of {size / 2:.2f} GiB each written "
                   f"async), losses {' '.join(f'{x:.4f}' for x in losses)}; "
                   f"mean of steps 1-5 {first5:.4f}, of steps 16-20 "
                   f"{last5:.4f}; resumed from step {TRAIN_CUT} in "
                   f"{resumed_s:.1f} s: steps {TRAIN_CUT + 1}-{TRAIN_STEPS} "
                   + ("equal bit for bit" if equal else
                      f"DIFFER: {resumed} against {losses[TRAIN_CUT:]}"))
    if not last5 < first5:
        raise AssertionError(f"training {arch}: the loss did not fall "
                             f"({first5:.4f} -> {last5:.4f})")
    if not equal:
        raise AssertionError(f"training {arch}: the resumed run's losses "
                             f"{resumed} differ from {losses[TRAIN_CUT:]}")
    return losses


def train_timing(cfg, label: str, steps: int = TRAIN_STEPS,
                 seq: int = TRAIN_S) -> float:
    """(c) ``steps`` bf16 steps of B TRAIN_B x ``seq`` (the synthetic
    stream of seed 0; an encoder-decoder's frames from seed 0) in
    TRAIN_MICRO microbatches, timed: CUDA events around each step (median
    of steps 3 on) and tokens/s; the split into forward (the loss,
    autograd recording), backward (``autograd.grad``) and the rest
    (optimizer, accumulation, norm: the step less TRAIN_MICRO x forward +
    backward), each a median of 5; peak memory; the kernels' launches a
    step.  The mean loss of the last 5 steps must lie below the first 5's.
    Returns the step's ms."""
    api, params = _train_model(cfg)
    params.to(torch.bfloat16)
    opt = adamw.init(dict(params.named_parameters()))
    step = make_train_step(api, TRAIN_MICRO, param_dtype=torch.bfloat16)
    source = SyntheticTokens(cfg.vocab_size, seed=0)
    # tokens on the host (each step's copied before its events), frames on
    # the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [_train_batch(cfg, TRAIN_B, seq, "cpu", source, gen)
               for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for batch in batches:
        batch = {k: v.cuda() for k, v in batch.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, metrics = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = train_launches(cfg, TRAIN_MICRO)
    _launched(f"{label} timed steps", {k: n * steps
                                       for k, n in per_step.items()},
              "bfloat16")
    step_ms = float(np.median(times[2:]))
    mb = TRAIN_B // TRAIN_MICRO
    micro = {k: v[:mb] for k, v in batch.items()}
    leaves = [p for p in params.parameters()]

    def forward():
        return api.loss(params, micro["tokens"], micro["labels"],
                        micro.get("extra"))

    fwd_ms = median_event_ms(forward, 5)
    both_ms = median_event_ms(lambda: torch.autograd.grad(forward(), leaves),
                              5)
    reset_counts()
    rest_ms = step_ms - TRAIN_MICRO * both_ms
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    frames = (f" over {cfg.encoder_seq} frames"
              if cfg.family == "encdec" else "")
    phase("train", f"{label} bf16 step, {cfg.n_layers} layers, B {TRAIN_B} x "
                   f"S {seq}{frames} in {TRAIN_MICRO} microbatches, eager "
                   f"(CUDA events, median of steps 3-{steps}): "
                   f"{step_ms:.2f} ms, "
                   f"{TRAIN_B * seq / step_ms * 1e3:.0f} tokens/s; a "
                   f"microbatch's forward {fwd_ms:.2f} ms, backward "
                   f"{both_ms - fwd_ms:.2f} ms (remat's recompute in it); "
                   f"optimizer, accumulation and norm {rest_ms:.2f} ms; peak "
                   f"memory {peak:.2f} GiB; launches a step (bf16) "
                   + ", ".join(f"{k} {n}" for k, n in per_step.items())
                   + f" = {TRAIN_MICRO} microbatches x (forward + remat "
                   f"recompute) x " + ", ".join(
                       f"{n // (2 * TRAIN_MICRO)}" for n in per_step.values())
                   + f"; losses {' '.join(f'{x:.4f}' for x in losses)}, "
                   f"mean of steps 1-5 {first5:.4f}, of steps "
                   f"{steps - 4}-{steps} {last5:.4f}; {CARD['smi']}")
    if not last5 < first5:
        raise AssertionError(f"training {label}: the loss did not fall "
                             f"({first5:.4f} -> {last5:.4f})")
    del params, opt, leaves
    torch.cuda.empty_cache()
    return step_ms


def _launch_text(label: str, by_type: dict) -> str:
    return (f"training {label}: " + "; ".join(
        f"{k} {sum(v.values())} launches by type {v}"
        for k, v in by_type.items()) + "; no other kernel")


def train_path() -> tuple[dict, dict]:
    """The training path of each TRAIN_RUNS model, (a)-(c); counts set to 0
    before each part and held after it.  Returns each model's launches of
    its kernel, by type, and its bf16 run's losses and timed step ms."""
    by_path, runs = {}, {}
    for arch in TRAIN_RUNS:
        TRAIN_LAUNCHES.clear()
        reset_counts()
        train_fp32_gate(get_arch(arch), arch)
        losses = train_bf16_run(arch)
        runs[arch] = {"losses": losses,
                      "step_ms": train_timing(get_arch(arch), arch)}
        by_path[arch] = copy.deepcopy(TRAIN_LAUNCHES)
        phase("launches", _launch_text(arch, by_path[arch]))
    return by_path, runs


def train_rows_path() -> dict:
    """Phase 8c: each TRAIN_ROWS row's fp32 gate (a) at its gate depth and
    its bf16 run of TRAIN_ROW_STEPS steps, timed (c); counts set to 0
    before each part and held after it.  Returns each row's launches by
    kernel and type."""
    by_path = {}
    for row in TRAIN_ROWS:
        TRAIN_LAUNCHES.clear()
        reset_counts()
        t0 = time.perf_counter()
        full = get_arch(row.arch)
        cfg = dataclasses.replace(full, **dict(row.changes))
        gate_cfg = dataclasses.replace(
            full, n_layers=row.gate_layers or cfg.n_layers)
        n_params = sum(p.numel() for p in get_model(cfg).init_params(
            torch.Generator(), torch.float32, "meta").parameters())
        phase("train", f"{row.label}: {cfg.n_layers} of {full.n_layers} "
                       f"layers, d_model {cfg.d_model}, {_lm_shape(cfg)}, "
                       f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
                       f"parameters, random from seed 0; the fp32 gate at "
                       f"{gate_cfg.n_layers} layers")
        train_fp32_gate(gate_cfg, row.label, row.gate_micro, row.seq)
        train_timing(cfg, row.label, TRAIN_ROW_STEPS, row.seq)
        by_path[row.label] = copy.deepcopy(TRAIN_LAUNCHES)
        phase("launches", _launch_text(row.label, by_path[row.label]))
        phase("train", f"{row.label}: {time.perf_counter() - t0:.1f} s "
                       "(host clock)")
    return by_path


def mesh_phase(runs: dict) -> dict:
    """Phase 10: the local mesh on cuda:0, the production mesh refused on
    one card, and for each TRAIN_RUNS model ``train()`` for MESH_STEPS bf16
    steps at phase 8b's shape and arguments without a mesh and under the
    local mesh: the losses (also phase 8b's first MESH_STEPS), every
    parameter and the AdamW state (master and moments, which hold every
    gradient) equal bit for bit, every parameter leaf's sharding
    replicated, the kernel's launches held as phase 8b holds them.
    Returns each model's launches by type."""
    mesh = make_local_mesh()
    if mesh.devices != [torch.device("cuda", 0)] or \
            mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"the local mesh is {mesh}")
    try:
        make_production_mesh()
    except RuntimeError as err:
        refused = str(err)
    else:
        raise AssertionError("make_production_mesh() built a mesh on one card")
    phase("mesh", f"make_local_mesh(): axes {mesh.axis_names}, shape "
                  f"{mesh.shape} on {mesh.devices[0]}; make_production_mesh() "
                  f"raises: {refused}")
    by_path = {}
    kw = dict(steps=MESH_STEPS, batch_size=TRAIN_B, seq_len=TRAIN_S,
              smoke=False, n_micro=TRAIN_MICRO, param_dtype=torch.bfloat16,
              log_every=MESH_STEPS, seed=0)
    for arch in TRAIN_RUNS:
        per_run = train_launches(get_arch(arch), TRAIN_MICRO, MESH_STEPS)
        TRAIN_LAUNCHES.clear()
        reset_counts()
        t0 = time.perf_counter()
        out = {}
        for name, where in (("no mesh", {"device": "cuda"}),
                            ("local mesh", {"mesh": mesh})):
            out[name] = train(arch, **kw, **where)
            _launched(f"{arch} {name} run", per_run, "bfloat16")
        secs = time.perf_counter() - t0
        (p0, o0, l0), (p1, o1, l1) = out.values()
        s0, s1 = p0.state_dict(), p1.state_dict()
        same = {
            "losses": l0 == l1 == runs[arch]["losses"][:MESH_STEPS],
            "parameters": s0.keys() == s1.keys() and all(
                torch.equal(s0[n], s1[n]) for n in s0),
            "AdamW state": all(torch.equal(x[n], y[n])
                               for x, y in zip(o0[1:], o1[1:]) for n in x)}
        shardings = shp.param_shardings(p1, get_arch(arch), mesh)
        replicated = sum(not any(s.spec) for s in shardings.values())
        phase("mesh", f"{arch} bf16, {MESH_STEPS} steps of B {TRAIN_B} x S "
                      f"{TRAIN_S} in {TRAIN_MICRO} microbatches, with and "
                      f"without the local mesh ({secs:.1f} s, host clock): "
                      f"losses {' '.join(f'{x:.4f}' for x in l1)}; "
                      + "; ".join(f"{k} {'equal bit for bit' if v else 'DIFFER'}"
                                  for k, v in same.items())
                      + f" (losses also phase 8b's first {MESH_STEPS}); "
                      f"{replicated} of {len(shardings)} parameter leaves "
                      f"resolve to replicated; launches "
                      + ", ".join(f"{k} {v}" for k, v in
                                  TRAIN_LAUNCHES.items()))
        if not all(same.values()) or replicated != len(shardings):
            raise AssertionError(f"mesh {arch}: {same}, {replicated} of "
                                 f"{len(shardings)} leaves replicated")
        by_path[f"mesh {arch}"] = copy.deepcopy(TRAIN_LAUNCHES)
        del out, p0, p1, o0, o1, s0, s1
        torch.cuda.empty_cache()
    return by_path


def _walk(fn, *args, **kwargs):
    """(the op walk's counts, fn's result) of one call on meta tensors."""
    walk = op_walk.OpWalk()
    with walk:
        out = fn(*args, **kwargs)
    return walk.acc, out


def _plain_flops(label: str, fn, *args, **kwargs) -> None:
    """Gate (a): the walk's flops of ``fn`` equal FlopCounterMode's."""
    acc, _ = _walk(fn, *args, **kwargs)
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    if acc.flops != counter.get_total_flops():
        raise AssertionError(f"roofline {label}, plain path: the walk counts "
                             f"{acc.flops:.6g} flop, FlopCounterMode "
                             f"{counter.get_total_flops():.6g}")


def _formula_gate() -> None:
    """Gate (b): each kernel's formula in the walk at PERF.md §6's shapes
    against its closed form computed here from those shapes (a walk sees
    no data: decode attention counts every slot of the cache,
    embedding_bag every looked-up row, where §6 counts the valid slots
    and the distinct rows of its run's data)."""
    meta, bf16 = "meta", torch.bfloat16

    def empty(*shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device=meta)

    _, b, s, h, kh, d, causal, window, t = FLASH_CASES[0]
    q, k = empty(b, s, h, d), empty(b, t, kh, d)
    cases = {"flash_attention": (
        lambda: ops.flash_attention(q, k, k, causal=causal, window=window),
        4 * d * b * h * _valid_pairs(s, t, causal, window),
        2 * (2 * q.numel() + 2 * k.numel()))}
    _, b, t, kh, g, d, _, _ = DECODE_CASES[0]
    dq, dk, pos = empty(b, 1, kh * g, d), empty(b, t, kh, d), \
        empty(t, dtype=torch.int32)
    cases["decode_attention"] = (
        lambda: ops.decode_attention(dq, dk, dk, pos),
        4 * d * b * kh * g * t, 2 * (2 * dq.numel() + 2 * b * t * kh * d)
        + 4 * t)
    case = SSD_CASES[0]
    _, b, l, h, p, g, n, _ = case
    x, dt, a_log, bc = (empty(b, l, h, p), empty(b, l, h, dtype=torch.float32),
                        empty(h, dtype=torch.float32), empty(b, l, g, n))
    cases["ssd_scan"] = (lambda: ops.ssd_scan(x, dt, a_log, bc, bc),
                         *_ssd_work(case, 2))
    n_tables, v, d, bag, n_bags = (CFG["n_tables"], CFG["vocab"], CFG["emb"],
                                   CFG["bag"], 32)
    idx, tables = (empty(n_bags, n_tables, bag, dtype=torch.int32),
                   empty(n_tables, v, d, dtype=torch.float32))
    cases["embedding_bag"] = (
        lambda: ops.embedding_bag(idx, tables), 0,
        idx.numel() * 4 + idx.numel() * d * 4 + n_bags * n_tables * d * 4)
    for name, (fn, flops, nbytes) in cases.items():
        acc, _ = _walk(fn)
        got = (acc.kernels[name]["flops"], acc.kernels[name]["bytes"])
        phase("roofline", f"{name} formula at PERF.md §6's shape: {got[0]:.4g} "
                          f"flop, {got[1] / 1e6:.4f} MB; closed form "
                          f"{flops:.4g} flop, {nbytes / 1e6:.4f} MB; §6 "
                          f"prints {SECTION6[name]}")
        if got != (flops, nbytes) or acc.kernels[name]["calls"] != 1:
            raise AssertionError(f"roofline: {name} counted {got}, closed "
                                 f"form {(flops, nbytes)}")


def _meta_lm(run: LMRun):
    """``run``'s model in bf16 on meta (its MoE routers float32, as served)
    and its batch: tokens, and float32 patch or frame rows."""
    api = get_model(dataclasses.replace(get_arch(run.arch),
                                        **dict(run.changes)))
    params = api.init_params(torch.Generator(), torch.bfloat16, "meta")
    tokens = torch.empty((run.batch, run.prompt), dtype=torch.int32,
                         device="meta")
    extra = (torch.empty((run.batch, run.extra, api.cfg.d_model),
                         device="meta") if run.extra else None)
    return api, params, tokens, extra


def _lm_walks(run: LMRun) -> dict:
    """The walk's counts of ``run``'s bf16 prefill and one decode step (the
    calls phase 8 times), and gate (a) on both on the plain path."""
    api, params, tokens, extra = _meta_lm(run)
    tok = torch.empty((run.batch, 1), dtype=torch.int32, device="meta")
    prefill, (cache, _) = _walk(api.prefill, params, tokens, run.max_len,
                                extra)
    step, _ = _walk(api.decode_step, params, cache, tok)
    _, (plain_cache, _) = _walk(api.prefill, params, tokens, run.max_len,
                                extra, use_kernel=False)
    _plain_flops(f"{run.label} prefill", api.prefill, params, tokens,
                 run.max_len, extra, use_kernel=False)
    _plain_flops(f"{run.label} decode step", api.decode_step, params,
                 plain_cache, tok, use_kernel=False)
    return {"prefill": prefill, "decode step": step}


def _train_walk(arch: str):
    """The walk's counts of phase 8b's timed bf16 step, and gate (a) on the
    same step on the plain path."""
    api = get_model(get_arch(arch))
    params = make_trainable(api.init_params(torch.Generator(),
                                            torch.bfloat16, "meta"))
    opt = adamw.init(dict(params.named_parameters()))
    tokens = torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32,
                         device="meta")
    batch = {"tokens": tokens, "labels": tokens}
    acc, _ = _walk(make_train_step(api, TRAIN_MICRO,
                                   param_dtype=torch.bfloat16),
                   params, opt, batch)
    plain = make_train_step(dataclasses.replace(
        api, loss=partial(api.loss, use_kernel=False)), TRAIN_MICRO,
        param_dtype=torch.bfloat16)
    _plain_flops(f"{arch} train step", plain, params, opt, batch)
    return acc


def roofline_walks() -> dict:
    """Phase 11's walks on meta, in a CPU process of its own
    (``start_roofline_walks``): gate (b), then the counts of each timed LM
    run's bf16 prefill and decode step and of each 8b model's bf16 train
    step, with gate (a) on each; the counts by path."""
    _formula_gate()
    out = {}
    for run in LM_RUNS:
        if run.timed:
            for call, acc in _lm_walks(run).items():
                out[f"{run.label} {call}"] = acc.to_dict()
    for arch in TRAIN_RUNS:
        out[f"train {arch} step"] = _train_walk(arch).to_dict()
    return out


class CpuProcess:
    """Python ``code`` run in a subprocess on the CPU (no card visible to
    it), beside the card's work, from its start (``t0``, host clock).  Its
    output and its errors go to unnamed files in the checkout's
    ``chiprun_out/``, not to pipes: a pipe read only at the end could fill
    and stop it."""

    def __init__(self, code: str, *args: str):
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        self.out, self.err = (tempfile.TemporaryFile("w+", dir=out_dir)
                              for _ in range(2))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, *args], cwd=out_dir.parent,
            stdout=self.out, stderr=self.err,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        self.t0 = time.perf_counter()

    def result(self, name: str, timeout: float) -> tuple[list, object]:
        """Wait for the process (at most ``timeout`` s): the lines of its
        output but the last, and the last read as JSON.  Raises with the
        end of its errors where it failed."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        if rc != 0:
            raise AssertionError(f"{name}: {err[-3000:]}")
        *lines, last = out.strip().splitlines()
        return lines, json.loads(last)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def start_roofline_walks() -> CpuProcess:
    """``roofline_walks`` started in a CPU subprocess, so that the walks
    run beside the card's work."""
    return CpuProcess("import json, chip_smoke; print(json.dumps("
                      "chip_smoke.roofline_walks()))")


def roofline_phase(lm_ms: dict, runs: dict, walks: CpuProcess) -> None:
    """Phase 11: each timed path's roofline terms on one H100 beside its
    measured time (device-only for the LM calls, eager for the training
    steps), with gates (a)-(c), from the walks ``start_roofline_walks``
    started.  The memory term counts every eager op's operands from device
    memory; it is printed, not gated."""
    lines, walked = walks.result("roofline walks", 900)
    for line in lines:
        print(line, flush=True)
    measured = {f"{run.label} {call}": (lm_ms[run.label][call],
                                        "device-only")
                for run in LM_RUNS if run.timed
                for call in ("prefill", "decode step")}
    measured |= {f"train {arch} step": (runs[arch]["step_ms"], "eager")
                 for arch in TRAIN_RUNS}
    below = []
    for label, (ms, how) in measured.items():
        acc = walked[label]
        terms = RooflineTerms(acc["flops"], acc["hbm_bytes"],
                              acc["collective_wire_bytes"], 1)
        by_dtype = acc["flops_by_dtype"]
        typed = typed_compute_s(by_dtype)
        phase("roofline", f"{label}: {acc['flops']:.4g} flop "
                          f"({', '.join(f'{k} {v:.3g}' for k, v in by_dtype.items())}), "
                          f"{acc['hbm_bytes'] / 1e9:.4g} GB, {acc['n_ops']} "
                          f"ops; compute {terms.compute_s * 1e3:.4f} ms (fp32 "
                          f"products at 67 TFLOP/s: {typed * 1e3:.4f}), memory "
                          f"{terms.memory_s * 1e3:.4f} ms, {terms.dominant}; "
                          f"measured {ms:.4f} ms ({how}) = "
                          f"{ms / 1e3 / terms.compute_s:.2f} x compute, "
                          f"{ms / 1e3 / terms.bound_time_s:.2f} x the bound; "
                          f"kernels {acc['kernels']}")
        if ms / 1e3 < terms.compute_s:
            below.append(label)
    phase("roofline", f"{len(measured)} paths walked on meta in a CPU "
                      f"process beside the card's work, "
                      f"{time.perf_counter() - walks.t0:.1f} s from its "
                      "start to here (host clock); plain flops equal "
                      f"FlopCounterMode's on every path; {CARD['smi']}")
    if below:
        raise AssertionError(f"roofline: measured below the compute term on "
                             f"{below}: a count above the card's peak")


def kernel_line(launches: int, worst: float) -> dict:
    """embedding_bag at the live path's shape: the 8 tables' lookups of one
    MT-WND forward at batch 32 in one launch, indices from [0, 100) as the
    live path draws them.  Library: one F.embedding_bag over the stacked
    (T·V, D) table with the indices offset by t·V.  Also the same lookups
    as 8 single-table launches (PR 14's form), device-only."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_tables, v, d, bag, n_bags = (CFG["n_tables"], CFG["vocab"], CFG["emb"],
                                   CFG["bag"], 32)
    tables = torch.randn(n_tables, v, d, generator=gen, device="cuda")
    idx = torch.randint(0, 100, (n_bags, n_tables, bag), generator=gen,
                        device="cuda", dtype=torch.int32)
    flat = (idx.long() + torch.arange(n_tables, device="cuda")[:, None] * v
            ).reshape(n_bags * n_tables, bag)
    stacked = tables.reshape(n_tables * v, d)
    per_table = [idx[:, t].contiguous() for t in range(n_tables)]
    got = ops.embedding_bag(idx, tables)
    want = embedding_bag_ref(idx, tables)
    if not torch.equal(got, want):
        raise AssertionError("embedding_bag line: kernel differs from plain")
    err = (got - want).abs().max().item()
    fns = {"ms": lambda: ops.embedding_bag(idx, tables),
           "plain_ms": lambda: embedding_bag_ref(idx, tables),
           "library_ms": lambda: F.embedding_bag(flat, stacked, mode="sum")}
    times = {name: (graph_ms(fn), event_ms(fn, 500))
             for name, fn in fns.items()}
    eight = graph_ms(lambda: [ops.embedding_bag(i, tables[t])
                              for t, i in enumerate(per_table)])
    distinct = sum(int(torch.unique(idx[:, t]).numel())
                   for t in range(n_tables))
    nbytes = (idx.numel() * 4 + distinct * d * 4 + n_bags * n_tables * d * 4)
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:39",
            "design": "one launch for all tables: a block per (bag, table)",
            "launches": launches, "max_abs_err": max(err, worst),
            "ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": times["library_ms"][0],
            # one eager call after another: the host's launch cost included
            "eager_ms": times["ms"][1], "eager_plain_ms": times["plain_ms"][1],
            "eager_library_ms": times["library_ms"][1],
            "eight_launches_ms": eight,
            "shape": f"{n_tables} tables x (n_bags {n_bags}, bag {bag}) "
                     f"over ({v}, {d}) fp32, {distinct} distinct rows"}


def _valid_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through: the work this input needs
    (counted on the host, so that phase 11's walks need no card)."""
    q_pos = torch.arange(s)[:, None]
    k_pos = torch.arange(t)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return int(mask.sum())


def _kernel_only(fn, graph_calls, flops, nbytes, shape) -> dict:
    """A kernel's device-only time and bound at another path's shape."""
    by_ops, by_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"shape": shape, "ms": graph_ms(fn, *graph_calls),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _attention_line(name, launches, by_path, by_dtype, worst, fns,
                    graph_calls, eager_iters, flops, nbytes, err, shape,
                    design) -> dict:
    times = {key: (graph_ms(fn, *graph_calls), event_ms(fn, eager_iters))
             for key, fn in fns.items()}
    by_ops, by_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": {"flash_attention":
                         "src/repro/kernels/flash_attention.py:76",
                         "decode_attention":
                         "src/repro/kernels/decode_attention.py:61"}[name],
            "design": design,
            "launches": launches, "launches_by_path": by_path,
            "launches_by_dtype": by_dtype,
            "max_abs_err": max(err, *worst.values()),
            "max_abs_err_fp32": worst[torch.float32],
            "ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": times["library_ms"][0],
            "eager_ms": times["ms"][1], "eager_plain_ms": times["plain_ms"][1],
            "eager_library_ms": times["library_ms"][1],
            "flops": flops, "bytes": nbytes, "shape": shape}


def flash_line(launches: int, by_path: dict, by_dtype: dict,
               worst: dict) -> dict:
    """flash_attention at one layer of the LM prefill: B 4, S 2000, H 16,
    KH 2, D 128, causal, bf16.  Library: SDPA with enable_gqa."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    case = FLASH_CASES[0]
    _, b, s, h, kh, d, causal, window, _ = case
    q, k, v = _flash_inputs(gen, case, torch.bfloat16)
    err = _gate("flash_attention line", ops.flash_attention(q, k, v),
                flash_attention_ref(q, k, v),
                flash_attention_ref(q.float(), k.float(), v.float()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"ms": lambda: ops.flash_attention(q, k, v),
           "plain_ms": lambda: flash_attention_ref(q, k, v),
           "library_ms": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)}
    flops = 4 * d * b * h * _valid_pairs(s, s, causal, window)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    line = _attention_line("flash_attention", launches, by_path, by_dtype,
                           worst, fns, (4, 3), 10, flops, nbytes, err,
                           f"B {b}, S {s}, H {h}, KH {kh}, D {d}, causal, "
                           "bf16", "bf16: mma.sync m16n8k16, cp.async K/V "
                           "ring x2, ldmatrix; fp32: scalar FMAs")
    # the kernel alone at other paths' shapes: zamba2-2.7b's shared block,
    # olmoe-1b-7b's prefill (H = KH 16, D 128), minicpm3-4b's MLA prefill
    # (v padded from 64), the whisper encoder and its cross attention,
    # internvl2-1b's prefill (G 7, also its training forward), qwen2-7b's (G 7,
    # D 128), stablelm-3b's (MHA, D 80), and the window that binds at S 4608
    # (zamba2-2.7b's shared block; mixtral-8x22b, G 6 at D 128)
    for key, case in (
            ("zamba2_shape", ("zamba2", 4, 2048, 32, 32, 80, True, 4096,
                              2048)),
            ("olmoe_shape", ("olmoe", 4, 2048, 16, 16, 128, True, 0, 2048)),
            ("mla_shape", _case(FLASH_CASES, "MLA")),
            ("encoder_shape", _case(FLASH_CASES, "whisper encoder")),
            ("cross_shape", _case(FLASH_CASES, "cross")),
            ("internvl2_shape", _case(FLASH_CASES, "internvl2")),
            ("qwen2_7b_shape", _case(FLASH_CASES, "qwen2-7b")),
            ("stablelm_shape", _case(FLASH_CASES, "stablelm-3b")),
            ("zamba2_window_shape", _case(FLASH_CASES, "S 4608 zamba2")),
            ("mixtral_window_shape", _case(FLASH_CASES, "S 4608 mixtral"))):
        label, b, s, h, kh, d, causal, window, t = case
        q, k, v = _flash_inputs(gen, case, torch.bfloat16)
        flops = 4 * d * b * h * _valid_pairs(s, t, causal, window)
        line[key] = _kernel_only(
            lambda q=q, k=k, v=v, causal=causal, window=window:
            ops.flash_attention(q, k, v, causal=causal, window=window),
            (4, 3), flops, 2 * (2 * q.numel() + k.numel() + v.numel()),
            f"B {b}, S {s}, T {t}, H {h}, KH {kh}, D {d}, "
            f"{'causal' if causal else 'non-causal'}"
            + (f", window {window}" if window else "") + ", bf16")
    return line


def decode_line(launches: int, by_path: dict, by_dtype: dict,
                worst: dict) -> dict:
    """decode_attention at one layer of an LM decode step: B 4, T 2048,
    KH 2, G 8, D 128, the last 48 slots empty, bf16.  Library: SDPA with
    enable_gqa and a boolean pos >= 0 mask."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    case = DECODE_CASES[0]
    _, b, t, kh, g, d, _, _ = case
    q, k, v, pos = _decode_inputs(gen, case, torch.bfloat16)
    err = _gate("decode_attention line", ops.decode_attention(q, k, v, pos),
                decode_attention_ref(q, k, v, pos),
                decode_attention_ref(q.float(), k.float(), v.float(), pos))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (pos >= 0).view(1, 1, 1, t)
    fns = {"ms": lambda: ops.decode_attention(q, k, v, pos),
           "plain_ms": lambda: decode_attention_ref(q, k, v, pos),
           "library_ms": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)}
    n_valid = int((pos >= 0).sum())
    flops = 4 * d * b * kh * g * n_valid
    nbytes = 2 * (2 * q.numel() + 2 * b * n_valid * kh * d) + 4 * t
    line = _attention_line("decode_attention", launches, by_path, by_dtype,
                           worst, fns, (50, 20), 500, flops, nbytes, err,
                           f"B {b}, T {t} ({n_valid} valid), KH {kh}, G {g}, "
                           f"D {d}, bf16", "bf16: one launch, cp.async ring "
                           "x4, mma.sync (G >= 2) or two-lane dot products "
                           "(G 1), last block combines the splits; fp32: "
                           "split + combine kernels, scalar FMAs")
    # the kernel alone at other paths' shapes: zamba2-2.7b's shared block,
    # internvl2-1b's step (G 7), whisper's cross attention (T 1500 valid),
    # qwen2-7b's step (G 7, D 128), stablelm-3b's (MHA, D 80), and a full
    # ring of the window that binds (zamba2-2.7b's; mixtral-8x22b's, G 6)
    for key, case in (("zamba2_shape", ("zamba2", 4, 2096, 32, 1, 80, "tail",
                                        48)),
                      ("g7_shape", _case(DECODE_CASES, "G 7")),
                      ("cross_shape", _case(DECODE_CASES, "cross")),
                      ("qwen2_7b_shape", _case(DECODE_CASES, "qwen2-7b")),
                      ("stablelm_shape", _case(DECODE_CASES, "stablelm-3b")),
                      ("zamba2_window_shape",
                       _case(DECODE_CASES, "ring 4096 zamba2")),
                      ("mixtral_window_shape",
                       _case(DECODE_CASES, "ring 4096 mixtral"))):
        _, b, t, kh, g, d, _, _ = case
        q, k, v, pos = _decode_inputs(gen, case, torch.bfloat16)
        n_valid = int((pos >= 0).sum())
        line[key] = _kernel_only(
            lambda q=q, k=k, v=v, pos=pos: ops.decode_attention(q, k, v, pos),
            (50, 20), 4 * d * b * kh * g * n_valid,
            2 * (2 * q.numel() + 2 * b * n_valid * kh * d) + 4 * t,
            f"B {b}, T {t} ({n_valid} valid), KH {kh}, G {g}, D {d}, bf16")
    return line


def _ssd_work(case, elt: int) -> tuple[int, int]:
    """(flops, bytes) the SSD scan needs at a case's shape: each input read
    once (x, b, c in ``elt`` bytes, dt and a_log in fp32), y and the fp32
    final state written once; the products of the kernel's 64-row chunks,
    C·Bᵀ over the causal (i >= j) pairs once per group, (C·Bᵀ ∘ L)·xdt over
    those pairs, and the carried state's two Q x N x P products per head.
    Exponentials and scalings are not counted."""
    _, b, l, h, p, g, n, _ = case
    nbytes = (elt * (2 * b * l * h * p + 2 * b * l * g * n)
              + 4 * (b * l * h + h + b * h * p * n))
    flops = 0
    for t0 in range(0, l, SSD_CHUNK):
        q = min(SSD_CHUNK, l - t0)
        pairs = q * (q + 1) // 2
        flops += b * g * 2 * pairs * n + b * h * (2 * pairs * p + 4 * q * n * p)
    return flops, nbytes


def _ssd_times(case, gen) -> dict:
    """The SSD scan's bf16 kernel and plain version at ``case``'s shape
    (x, b, c packed as the model passes them): device-only and eager times,
    the bound and y's error."""
    inputs = _ssd_inputs(gen, case, torch.bfloat16)
    err, rel = _ssd_gate(f"ssd_scan line {case[0]}", inputs)
    fns = {"ms": lambda: ops.ssd_scan(*inputs),
           "plain_ms": lambda: ssd_scan_ref(*inputs)}
    graphs = {"ms": (10, 5), "plain_ms": (1, 2)}
    eager = {"ms": 20, "plain_ms": 2}
    times = {key: (graph_ms(fn, *graphs[key]), event_ms(fn, eager[key]))
             for key, fn in fns.items()}
    flops, nbytes = _ssd_work(case, 2)
    by_ops, by_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    _, b, l, h, p, g, n, _ = case
    return {"ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "eager_ms": times["ms"][1], "eager_plain_ms": times["plain_ms"][1],
            "flops": flops, "bytes": nbytes, "err": err, "rel_err": rel,
            "shape": f"B {b}, L {l}, H {h}, P {p}, G {g}, N {n}, bf16, x/b/c "
                     "views of one packed conv output"}


def ssd_line(launches: int, by_path: dict, by_dtype: dict,
             worst: dict) -> dict:
    """ssd_scan at one layer of mamba2-130m's prefill (B 4, L 2048, H 24,
    P 64, N 128, bf16: the tensor-core kernel), and the same numbers at
    zamba2-2.7b's (H 80, N 64) and at its windowed run's (B 1, L 4608).
    No single PyTorch call computes the SSD scan: library null."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    main, other, window = (_ssd_times(case, gen) for case in (
        *SSD_CASES[:2], _case(SSD_CASES, "zamba2-2.7b window")))
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "eager_ms",
            "eager_plain_ms", "flops", "bytes")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:70",
            "design": "bf16: mma.sync m16n8k16, 8 warps per 64 columns of "
                      "P (16 rows of P x half of N each), state in "
                      "registers, C·Bᵀ once per chunk, cp.async ring x2, "
                      "fp32 operands split hi + lo; fp32: scalar FMAs",
            "launches": launches, "launches_by_path": by_path,
            "launches_by_dtype": by_dtype,
            "max_abs_err": max(main["err"], *(a for a, _ in worst.values())),
            "max_abs_err_fp32": worst[torch.float32][0],
            "max_rel_err": max(main["rel_err"],
                               *(r for _, r in worst.values())),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "eager_ms": main["eager_ms"],
            "eager_plain_ms": main["eager_plain_ms"],
            "eager_library_ms": None,
            "flops": main["flops"], "bytes": main["bytes"],
            "shape": main["shape"],
            "zamba2_shape": {k: other[k] for k in keys},
            "zamba2_window_shape": {k: window[k] for k in keys}}


def fcfs_flavour_calls(tos, free0) -> dict:
    """fcfs_scan's flavours as the timing cases call them, name ->
    (type_of_slot, keyword arguments): cold (latencies written, the batch
    lane's call before it took counts), policy (from_order with affinity
    40 and hedge 0.5, latencies written), telemetry (the counters, no
    latencies: the grid lane's qos with telemetry) and trace (latencies,
    start times and winning slots: segment_from's call)."""
    mixed = RoutingPolicy.from_order([2, 0, 1], affinity=40.0, hedge=0.5)
    tos_p, pol = _policy_ops(mixed, tos)
    n_active = (free0 < 1e29).sum(dim=1).to(torch.int32)
    return {"cold": (tos, dict(want_lat=True)),
            "policy": (tos_p, dict(want_lat=True, policy=pol)),
            "telemetry": (tos, dict(n_active=n_active)),
            "trace": (tos, dict(want_lat=True, want_start=True,
                                want_slot=True))}


def _fcfs_flavour_times(arr, svc, tos, prio, free0, qos_t) -> dict:
    """Each flavour of fcfs_scan (``fcfs_flavour_calls``) at the batch
    lane's shape, kernel and plain version, device-only (CUDA graph) and
    eager, with its bound."""
    n_w, nq = arr.shape
    n_b, n_s = tos.shape
    n_types = svc.shape[1]
    lane_q = n_w * n_b * nq
    work = {
        # extra bytes beyond the cold inputs and counts, ops per slot and
        # per query-lane beyond them
        "cold": (4 * lane_q, 3 * n_s + 3),
        "policy": (4 * lane_q + 4 * n_b * (n_s + 2), 7 * n_s + 3),
        "telemetry": (4 * n_b + 4 * n_w * n_b * tel_width(n_types),
                      4 * n_s + 2 * 31 + 9),
        "trace": (12 * lane_q, 3 * n_s + 3)}
    base_bytes = 4 * (arr.numel() + svc.numel() + tos.numel() + prio.numel()
                      + free0.numel() + n_w * n_b * (1 + n_s))
    out = {}
    for name, (t, kw) in fcfs_flavour_calls(tos, free0).items():
        extra, per_step = work[name]

        def kernel(kw=kw, t=t):
            return ops.fcfs_scan(arr, svc, t, prio, free0, qos_t, **kw)

        def plain(kw=kw, t=t):
            return fcfs_scan_ref(arr, svc, t, prio, free0, qos_t, FCFS_BIG,
                                 **kw)

        _fcfs_check(f"{name} timing case", kernel(), plain())
        nbytes, n_ops = base_bytes + extra, lane_q * per_step
        by_ops, by_bytes = n_ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        ms = graph_ms(kernel, 20, 5)
        out[name] = {"ms": ms, "eager_ms": event_ms(kernel, 50),
                     "ns_per_query": ms * 1e6 / nq,
                     "plain_ms": graph_ms(plain, 1, 2),
                     "eager_plain_ms": event_ms(plain, 2),
                     "bound_ms": max(by_ops, by_bytes) * 1e3,
                     "bound_by": "operations" if by_ops >= by_bytes
                     else "bytes", "ops": n_ops, "bytes": nbytes}
    return out


def _stream_times() -> dict:
    """The stream flavour at the 1M-query stream's chunk shape (one lane,
    4096 queries, S 8: chunk 0 of mtwnd's stream, (2, 3, 3)), kernel and
    plain version, device-only (CUDA graph) and eager, with its bound.
    Each timed call first restores the two carries it updates in place (a
    copy of 36 bytes)."""
    _, (arr, rows, lut, tos, prio, free0, count0, shift,
        qos_t) = _stream_cases()[0]
    free, count = free0.clone(), count0.clone()

    def kernel():
        free.copy_(free0)
        count.copy_(count0)
        ops.fcfs_stream(arr, rows, lut, tos, prio, free, count, shift, qos_t)

    def plain():
        free.copy_(free0)
        count.copy_(count0)
        return fcfs_stream_ref(arr, rows, lut, tos, prio, free, count, shift,
                               qos_t, FCFS_BIG)

    nq, n_s = arr.shape[1], tos.shape[1]
    # arrivals and batch rows read, the table read once, the layout and
    # priorities read, the carries read and written
    nbytes = 4 * (2 * nq + lut.numel() + 2 * n_s + 2 * (n_s + 1))
    n_ops = nq * (3 * n_s + 3)
    by_ops, by_bytes = n_ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    ms = graph_ms(kernel, 20, 5)
    return {"ms": ms, "eager_ms": event_ms(kernel, 50),
            "ns_per_query": ms * 1e6 / nq, "plain_ms": graph_ms(plain, 1, 1),
            "eager_plain_ms": event_ms(plain, 1),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "ops": n_ops, "bytes": nbytes,
            "shape": f"W 1, L 1, nq {nq}, S {n_s}, {lut.shape[1]} types, "
                     f"n_lut {lut.shape[0]}, carries in place"}


def fcfs_line(launches: int, lanes: int, by_path: dict,
              by_flavour: dict, scenario_by_flavour: dict) -> dict:
    """fcfs_scan at the search path's batch shape: 64 mtwnd configs x 1500
    queries, S 40, latencies written (the batch lane), and without them
    (the grid lane's counts); each flavour's times and bound there
    (``_fcfs_flavour_times``) beside its launches on the load-change and
    scenario paths; the stream flavour's at the streamed chunk's shape
    (``_stream_times``) beside its launches on the streaming path.
    Also one batch-lane dispatch of the simulator end to end (host clock:
    slot layouts up, the kernel, the QoS counts down) on the card and on
    the CPU.  Prints each flavour's times beside its times before the
    redesign (``FCFS_BEFORE_MS``, in the text lines only), with the card's
    name and power limit.  No single PyTorch call computes the scan:
    library null."""
    _, (arr, svc, tos, prio, free0, qos_t) = _fcfs_cases()[0]
    n_w, nq = arr.shape
    n_b, n_s = tos.shape
    flavours = _fcfs_flavour_times(arr, svc, tos, prio, free0, qos_t)
    flavours["stream"] = _stream_times()
    for name, n in by_flavour.items():
        flavours[name]["launches_load_change_path"] = n
        flavours[name]["launches_scenario_path"] = scenario_by_flavour[name]
    flavours["stream"]["launches_stream_path"] = by_path["stream"]
    cold = flavours["cold"]
    counts_ms = graph_ms(lambda: ops.fcfs_scan(arr, svc, tos, prio, free0,
                                               qos_t), 20, 5)
    cfgs = _configs(np.random.default_rng(8), (8, 10, 12), 64)
    host = {}
    for device, runs in (("cuda", 20), ("cpu", 3)):
        sim = make_paper_setup("mtwnd", device=device)[0].sim
        sim.qos(cfgs)
        spans = []
        for _ in range(runs):
            t0 = time.perf_counter()
            sim.qos(cfgs)
            spans.append(time.perf_counter() - t0)
        host[device] = float(np.median(spans)) * 1e3
    for name, f in flavours.items():
        if name == "stream":
            phase("fcfs", f"stream ({f['shape']}): device-only "
                          f"{f['ms']:.4f} ms, eager {f['eager_ms']:.4f} ms, "
                          f"{f['ns_per_query']:.1f} ns a query, plain "
                          f"{f['plain_ms']:.2f} ms, bound "
                          f"{f['bound_ms']:.7f} ms ({f['bound_by']}); on "
                          f"{CARD['smi']}")
            continue
        before_ms, before_eager_ms = FCFS_BEFORE_MS[name]
        phase("fcfs", f"{name}: device-only {f['ms']:.4f} ms (before the "
                      f"redesign: {before_ms}, {BEFORE_CARD}), eager "
                      f"{f['eager_ms']:.4f} ms (before: {before_eager_ms}), "
                      f"{f['ns_per_query']:.1f} ns a query, bound "
                      f"{f['bound_ms']:.6f} ms ({f['bound_by']}); "
                      f"on {CARD['smi']}")
    phase("fcfs", f"one 64-pool batch dispatch end to end (host clock): "
                  f"{host['cuda']:.4f} ms on the card (before the redesign: "
                  f"{FCFS_BEFORE_DISPATCH_MS}, {BEFORE_CARD}), "
                  f"{host['cpu']:.2f} ms on the CPU; on {CARD['smi']}")
    ms = cold["ms"]
    return {"name": "fcfs_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/fcfs_scan.cu",
            "replaces": "src/repro/serving/simulator.py:313",
            "replaces_note": "no Pallas kernel: XLA lax.scan (_simulate_scan "
                             ":313, _grid_lane_qos_counts :395, "
                             "_stream_chunk :456, "
                             "_simulate_scan_policy :572, "
                             "_grid_lane_qos_counts_tel :503)",
            "design": "a warp per lane (workload row, pool), the slots' "
                      "carry in registers; a query's slot picked by one "
                      "redux.min over order-preserving key images and "
                      "equality ballots, the owner's record kept by "
                      "predicated shared-memory stores; latencies, counts, "
                      "outputs and telemetry once a chunk, 32 queries at a "
                      "time; the next query's arrival, service times and "
                      "routed idle keys a step ahead; a cp.async double "
                      "buffer a warp; policy, telemetry, trace and stream "
                      "(a chunk's service rows gathered from a table as it "
                      "is staged, the carries rebased and updated in "
                      "place) as template flavours",
            "card": CARD["smi"],
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": 0.0, "lanes_checked": lanes,
            "ms": ms, "plain_ms": cold["plain_ms"],
            "bound_ms": cold["bound_ms"], "bound_by": cold["bound_by"],
            "library_ms": None,
            "eager_ms": cold["eager_ms"],
            "eager_plain_ms": cold["eager_plain_ms"],
            "eager_library_ms": None,
            "counts_only_ms": counts_ms, "ns_per_query": ms * 1e6 / nq,
            "lanes_per_s": n_w * n_b / ms * 1e3,
            "plain_lanes_per_s": n_w * n_b / cold["plain_ms"] * 1e3,
            "dispatch_host_ms": host["cuda"], "dispatch_host_ms_cpu":
            host["cpu"],
            "ops": cold["ops"], "bytes": cold["bytes"],
            "flavours": flavours,
            "shape": f"W {n_w}, B {n_b}, nq {nq}, S {n_s}, 3 types, "
                     "latencies written"}


# ---------------------------------------------------------------------------
# Phase 12: the multi-device half on one card.
#
# (a) the simulator's sharded grid lanes: ``simulator.lane_devices`` forced
# to SHARD_LANES x cuda:0 (on a machine with two or more cards, then also
# the real cards); the reference's eight SHARD_CASES shapes at mtwnd's
# size, (factors, pools, stacked tables, policies): W 3 (pad 1), W 1 with
# B 63 (b-split, pad 1), stacked tables, policy folds of P 2 and 3.
SHARD_LANES = 4
SHARD_CASES = [((1.0, 1.2, 1.5), 3, False, 0), ((1.3,), 63, False, 0),
               ((1.0, 1.2, 1.5), 3, True, 0), ((1.3,), 63, True, 0),
               ((1.0, 1.1, 1.2, 1.5), 3, False, 2), ((1.3,), 21, False, 3),
               ((1.0, 1.1, 1.2, 1.5), 3, True, 2), ((1.3,), 21, True, 3)]
# phase 7b's warm anchors (policy: (pool, $/h))
WARM_ANCHORS = {None: ((6, 0, 1), 3.305), "hedged": ((1, 5, 1), 2.375)}
# (b), (c): MESH_RANKS ranks on a MESH_SHAPE ("data", "model") mesh: on one
# card all on cuda:0 over gloo (its collectives staged through pinned host
# memory, launch.host_collectives), with a card a rank over NCCL.
# olmoe-1b-7b at full width: the fp32 gate at SHARD_GATE_LAYERS layers,
# prefill SHARD_B x SHARD_S and SHARD_STEPS decode steps, held within
# SHARD_TOL x max |logits| of the one-rank run with its expert picks
# replayed (for the local MoE layer a one-rank run with each MoE layer
# run per data shard: its capacity counts the shard's tokens, so it drops
# other pairs than the global layer, C-R37); then bf16 cut to
# SHARD_BF16_LAYERS layers, timed.  (c): mamba2-130m at full width, B
# TRAIN_B x S TRAIN_S: cut to SHARD_TRAIN_GATE_LAYERS layers (the phase's
# time, ROADMAP G-3), one fp32 train() step against the one-card step and
# against a float64
# witness of it (the same weights and batch, float64 throughout on the
# plain path): losses within TRAIN_LOSS_RTOL; each leaf's AdamW first
# moment (1 - b1)·g, against the one-card step's and against the
# witness's, within TRAIN_GRAD_TOL x its max widened by phase 8b's rule,
# twice the one-card step's own distance from the witness, measured here.
# Then SHARD_TRAIN_STEPS bf16 steps at full depth, timed.
MESH_RANKS, MESH_SHAPE = 4, (2, 2)
SHARD_ARCH, SHARD_GATE_LAYERS = "olmoe-1b-7b", 4
SHARD_B, SHARD_S, SHARD_STEPS = 4, 2048, 8
SHARD_TOL = 1e-4
SHARD_TRAIN_ARCH, SHARD_TRAIN_STEPS = "mamba2-130m", 1
SHARD_TRAIN_GATE_LAYERS = 6
# (b'): HEADS_ARCH at full width on the same ranks as a HEADS_SHAPE mesh,
# whose "model" axis does not divide its KV heads, fp32 cut to
# SHARD_GATE_LAYERS layers: prefill SHARD_B x SHARD_S and SHARD_STEPS
# greedy decode steps fed the one-rank run's tokens, within SHARD_TOL x
# max |logits| of that run with the same greedy tokens.  (c'):
# SHARD_TRAIN_ARCH at full width cut to RESUME_LAYERS layers, bf16
# train(mesh=) on MESH_SHAPE, B TRAIN_B x S RESUME_S (the staged
# gather of the logits grows with S; the checkpoint does not):
# 2 x RESUME_AT steps with a checkpoint every RESUME_AT, the last removed
# (phase 8b's way), then a resume for RESUME_AT more, against the first
# run, bit for bit.
HEADS_ARCH, HEADS_SHAPE = "qwen2.5-3b", (1, 4)
# (b''): SSM_ARCH at full width cut to SSM_LAYERS layers (its first
# attn_every group: 6 Mamba-2 layers and the shared attention block), fp32,
# on the same ranks as the HEADS_SHAPE mesh, whose "model" axis divides its
# 80 SSM heads and 32 KV heads: each decode step on the reference's split
# (ROADMAP F-6a: in_proj column- and out_proj row-parallel, the state by
# heads), prefill SHARD_B x SHARD_S and SHARD_STEPS steps fed the one-rank
# run's greedy tokens, within SHARD_TOL x max |logits| of that run with
# the same greedy tokens
SSM_ARCH, SSM_LAYERS = "zamba2-2.7b", 6
RESUME_AT, RESUME_LAYERS, RESUME_S = 2, 4, 512
# (b)'s bf16 run: olmoe-1b-7b at full width cut to SHARD_BF16_LAYERS of
# its 16 layers (the phase's time, ROADMAP G-3)
SHARD_BF16_LAYERS = 8
# (d): the dry run (launch.dryrun) walks exactly (b')'s calls in a CPU
# process over torch's fake group of MESH_RANKS at HEADS_SHAPE; its
# collectives by kind must equal those rank 0 staged in (b'); then
# DRYRUN_ARCH's DRYRUN_SHAPE cell at both production meshes
DRYRUN_ARCH, DRYRUN_SHAPE = "qwen2.5-3b", "decode_32k"
# host_collectives' staged ops → the walk's collective kinds
STAGED_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


@contextmanager
def forced_lanes(devices):
    """Within: the grid lane's QoS counts shard over ``devices``."""
    real = sim_module.lane_devices
    sim_module.lane_devices = lambda device: list(devices)
    try:
        yield
    finally:
        sim_module.lane_devices = real


def _shard_rates(ev, case, cfgs, prices):
    factors, _, tables, n_pol = case
    kw = {"workloads": list(factors)}
    if tables:
        kw["service_tables"] = np.stack([ev.sim._service_host] * len(factors))
    if n_pol:
        kw["policy"] = RoutingPolicy.stack(
            [RoutingPolicy.fcfs(3), RoutingPolicy.hedged(3),
             RoutingPolicy.cost_aware(prices)][:n_pol])
    return ev.sim.qos(cfgs, **kw).rates


def _warm_anchors(ev, space) -> dict:
    """Phase 7b's warm anchors: converge on the base load (the GP on the
    host), then the warm rescale under each policy of WARM_ANCHORS."""
    out = {}
    for name in WARM_ANCHORS:
        opt = _converge(RibbonOptimizer(space, qos_target=0.99,
                                        start=(5, 0, 0), device="cpu"), ev)
        base = opt.trace.best_feasible().config
        pol = None if name is None else named_policy(name, space.prices)
        seg = ev.sim.segment_from(ev.sim.initial_state(), base, policy=pol)
        st = seg.state_at(1000).rebased(float(ev.workload.arrivals[1000]))
        event = rescale(opt, ev, budget=40, load_factors=[1.0, 1.5],
                        warm_state=st, deployed=base, policy=pol)
        out[name] = (event.new_best, event.new_cost, event.samples_used)
    return out


def _dispatch_ms(sim, cfgs, runs: int = 20) -> float:
    """Median host ms of one grid dispatch (3 load levels), counts to the
    host included."""
    sim.qos(cfgs, workloads=[1.0, 1.2, 1.5])
    spans = []
    for _ in range(runs):
        t0 = time.perf_counter()
        sim.qos(cfgs, workloads=[1.0, 1.2, 1.5])
        spans.append(time.perf_counter() - t0)
    return float(np.median(spans)) * 1e3


def sharded_lanes_phase() -> int:
    """Phase 12(a): the eight shapes' rates over SHARD_LANES forced lanes on
    cuda:0 equal, bit for bit, the unsharded dispatch on the card and the
    CPU's plain scan; phase 7b's warm anchors through the forced lanes;
    fcfs_scan launches = one a dispatch + one a shard of each sharded
    dispatch (counts set to 0 just before, read just after); one sharded
    dispatch timed beside the unsharded one.  Returns the launches."""
    card0 = [torch.device("cuda", 0)]
    ev, space, _ = make_paper_setup("mtwnd", device="cuda")
    cpu_ev = make_paper_setup("mtwnd", device="cpu")[0]
    rng = np.random.default_rng(12)
    cases = [(case, _configs(rng, (8, 10, 12), case[1]))
             for case in SHARD_CASES]
    want = [_shard_rates(cpu_ev, c, cfgs, space.prices) for c, cfgs in cases]
    with forced_lanes(card0):
        card = [_shard_rates(ev, c, cfgs, space.prices) for c, cfgs in cases]
    reset_counts()
    d0, s0 = ev.sim.n_dispatches, ev.sim.n_sharded
    with forced_lanes(card0 * SHARD_LANES):
        got = [_shard_rates(ev, c, cfgs, space.prices) for c, cfgs in cases]
        t0 = time.perf_counter()
        anchors = _warm_anchors(ev, space)
        anchor_s = time.perf_counter() - t0
    dispatches = ev.sim.n_dispatches - d0
    sharded = ev.sim.n_sharded - s0
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    launches = counts.pop("fcfs_scan")
    by_flavour = dict(fcfs_scan_cuda.launches_by_flavour)
    for (case, _), g, c, w in zip(cases, got, card, want):
        if not (np.array_equal(g, c) and np.array_equal(g, w)):
            raise AssertionError(f"sharded lanes {case}: {g} vs unsharded "
                                 f"card {c}, CPU {w}")
    want_launches = dispatches + (SHARD_LANES - 1) * sharded
    if sharded < len(SHARD_CASES) or launches != want_launches or any(
            counts.values()):
        raise AssertionError(f"sharded lanes: fcfs_scan launched {launches} "
                             f"times for {dispatches} dispatches of which "
                             f"{sharded} sharded; others {counts}")
    for name, (pool, cost) in WARM_ANCHORS.items():
        if anchors[name][:2] != (pool, cost):
            raise AssertionError(f"sharded lanes: warm anchor {name} "
                                 f"{anchors[name]}, expected {pool} ${cost}")
    cfgs64 = _configs(np.random.default_rng(8), (8, 10, 12), 64)
    with forced_lanes(card0):
        one_ms = _dispatch_ms(ev.sim, cfgs64)
    with forced_lanes(card0 * SHARD_LANES):
        four_ms = _dispatch_ms(ev.sim, cfgs64)
    phase("sharded", f"{len(SHARD_CASES)} grid shapes over {SHARD_LANES} "
                     "lanes forced on cuda:0 (W 3 and 4 workload-split, "
                     "W 1 x B 63 lane-split with pad 1, stacked tables, "
                     "policy folds P 2 and 3): rates equal bit for bit to "
                     "the unsharded dispatch on the card and to the CPU's "
                     "plain scan")
    phase("sharded", "warm anchors through the forced lanes: " + "; ".join(
        f"policy {n}: {p} at ${c}/h in {k} samples"
        for n, (p, c, k) in anchors.items()) + f" ({anchor_s:.2f} s)")
    phase("launches", f"fcfs_scan: {launches} launches = {dispatches} "
                      f"dispatches + {SHARD_LANES - 1} x {sharded} sharded "
                      f"ones (one a shard), by flavour {by_flavour}; no "
                      "other kernel")
    phase("sharded", f"one 64-pool x 3-level grid dispatch (host clock, "
                     f"counts to the host): {one_ms:.4f} ms on one lane, "
                     f"{four_ms:.4f} ms over {SHARD_LANES} lanes on cuda:0 "
                     f"(one after another on its stream); on {CARD['smi']}")
    if torch.cuda.device_count() > 1:
        devs = sim_module.lane_devices(torch.device("cuda"))
        real = [_shard_rates(ev, c, cfgs, space.prices) for c, cfgs in cases]
        if not all(np.array_equal(r, w) for r, w in zip(real, want)):
            raise AssertionError("sharded lanes over the real cards differ")
        phase("sharded", f"the same {len(SHARD_CASES)} shapes over the "
                         f"{len(devs)} real cards: equal bit for bit")
    else:
        phase("sharded", "one card: the run over real cards waits for a "
                         "machine with two or more")
    return launches


@contextmanager
def per_shard_moe(shards: int):
    """Within: each MoE layer runs as the global layer on each of
    ``shards`` batch shards in turn (capacity from the shard's tokens),
    the outputs concatenated and the aux losses averaged: on one device,
    what ``moe_layer_local`` computes on a mesh of ``shards`` data
    ranks."""
    real = transformer_module.moe_layer

    def layer(moe, x, cfg, capacity_factor=None, _global=False):
        outs, auxs = zip(*(real(moe, part, cfg, capacity_factor,
                                _global=True) for part in x.chunk(shards)))
        return torch.cat(outs), torch.stack(auxs).mean()
    transformer_module.moe_layer = layer
    try:
        yield
    finally:
        transformer_module.moe_layer = real


def mesh_settings(device: str = "cuda") -> dict:
    """Phase 12 (b) and (c)'s sizes and device, handed to every rank."""
    return dict(device=device, arch=SHARD_ARCH, gate_layers=SHARD_GATE_LAYERS,
                b=SHARD_B, s=SHARD_S, steps=SHARD_STEPS,
                train_arch=SHARD_TRAIN_ARCH,
                train_gate_layers=SHARD_TRAIN_GATE_LAYERS, train_b=TRAIN_B,
                train_s=TRAIN_S, train_steps=SHARD_TRAIN_STEPS, smoke=False,
                changes={}, heads_arch=HEADS_ARCH, ssm_arch=SSM_ARCH,
                ssm_layers=SSM_LAYERS, resume_at=RESUME_AT,
                resume_layers=RESUME_LAYERS, resume_s=RESUME_S,
                bf16_layers=SHARD_BF16_LAYERS)


def _arch(job: dict, name: str, **changes):
    cfg = get_arch(job[name])
    if job["smoke"]:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, **job["changes"], **changes)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def _rank_params(api, mesh, dtype, local_experts: bool):
    """The model from seed 0 on this rank's card, placed by
    ``param_shardings`` (the experts by ``layers.moe_local_specs`` for the
    local MoE layer, the layout it computes in); the ranks draw it one
    after another, so that one whole model at a time is on the card."""
    import torch.distributed as dist
    params = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            dev = mesh.devices[turn]
            gen = torch.Generator(device=dev).manual_seed(0)
            params = api.init_params(gen, dtype, dev)
            shardings = shp.param_shardings(params, api.cfg, mesh)
            if local_experts:
                specs = layers_module.moe_local_specs(api.cfg)
                for name in shardings:
                    if ".moe.experts." in name:
                        shardings[name] = shp.NamedSharding(
                            mesh, specs[name.rsplit(".", 1)[1]])
            shp.place_params(params, shardings)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return params


def _rank_counts() -> dict:
    return {fn.__name__[:-5]: (fn.launches, dict(getattr(
        fn, "launches_by_dtype", {}))) for fn in COUNTED[1:4]}


def _full(x) -> torch.Tensor:
    return (x.full_tensor() if shp.is_distributed(x) else x).detach().cpu()


def _sharded_serve(mesh, job: dict, mode: str) -> dict:
    """(b)'s fp32 gate in one MoE mode: prefill and teacher-forced decode
    steps with the one-rank run's expert picks replayed; every logits."""
    api = get_model(_arch(job, "arch", n_layers=job["gate_layers"],
                          moe_buffer_shard=mode))
    params = _rank_params(api, mesh, torch.float32, mode == "local")
    dev = mesh.devices[torch.distributed.get_rank()]
    picks = job["picks"][mode]
    if mode == "local":
        # the one-rank run routed each data shard in turn: this rank's
        # shard's routings
        shard = mesh.device_mesh.get_local_rank("data")
        picks = picks[shard::MESH_SHAPE[0]]
    tape = RoutingTape()
    tape.picks.extend(p.to(dev) for p in picks)
    reset_counts()
    with shp.activate(mesh), torch.no_grad(), tape.installed(), \
            tape.recording(False):
        tokens = shp.place(job["tokens"].to(dev), shp.data_sharding(
            job["tokens"].shape, mesh))
        cache, last = make_prefill_step(api, job["s"] + job["steps"])(
            params, {"tokens": tokens})
        logits = [_full(last)]
        for fed in job["fed"][mode]:
            out, cache = api.decode_step(params, cache, shp.place(
                fed.to(dev), shp.data_sharding(fed.shape, mesh)))
            logits.append(_full(out))
    _sync(dev)
    counts = _rank_counts()
    return {"logits": logits, "flips": tape.flips, "routed": tape.routed,
            "counts": counts}


def _bf16_layers(job: dict) -> int:
    return min(job["bf16_layers"], _arch(job, "arch").n_layers)


def _sharded_bf16(mesh, job: dict) -> dict:
    """(b)'s bf16 run cut to ``bf16_layers``: two serving runs (prefill,
    then greedy decode steps), the second timed on the host clock."""
    import torch.distributed as dist
    api = get_model(_arch(job, "arch", n_layers=_bf16_layers(job)))
    params = _rank_params(api, mesh, torch.bfloat16, False)
    dev = mesh.devices[dist.get_rank()]
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, api.cfg.vocab_size, (job["b"], job["s"]),
                           generator=gen, device=dev, dtype=torch.int32)
    prefill = make_prefill_step(api, job["s"] + job["steps"])
    serve_step = make_decode_step(api)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with shp.activate(mesh), torch.no_grad():
        tokens = shp.place(tokens, shp.data_sharding(tokens.shape, mesh))
        for _ in range(2):
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            cache, last = prefill(params, {"tokens": tokens})
            tok = _greedy(shp.constrain(last, "batch", None, None))
            _sync(dev)
            t1 = time.perf_counter()
            for _ in range(job["steps"]):
                tok, cache = serve_step(params, cache, tok)
            _sync(dev)
            t2 = time.perf_counter()
    return {"prefill_ms": (t1 - t0) * 1e3,
            "step_ms": (t2 - t1) * 1e3 / job["steps"],
            "counts": _rank_counts(), "peak_gb": _peak_gb(dev),
            "tokens": _full(tok)}


def _gate_train_cfg(job: dict):
    """(c)'s fp32 gate's configuration: the training architecture cut to
    ``train_gate_layers`` layers."""
    return _arch(job, "train_arch", n_layers=min(
        job["train_gate_layers"], _arch(job, "train_arch").n_layers))


def _fp32_train_step(job: dict, **where) -> tuple:
    """One fp32 train() step of (c)'s gate (``where``: the mesh, or the
    device): the loss and the AdamW first moments, full."""
    with train_config(job["train_arch"], _gate_train_cfg(job)):
        _, opt, losses = train(job["train_arch"], steps=1,
                               batch_size=job["train_b"],
                               seq_len=job["train_s"], smoke=False,
                               log_every=100, **where)
    return losses[0], {n: _full(t) for n, t in opt.m.items()}


@contextmanager
def float64_throughout():
    """Within: ``Tensor.float()`` leaves a float64 tensor as it is, and the
    plain path's chunked scan is ``_chunked_fp64``, so that a float64
    model's plain path runs in float64 throughout (the models take norms,
    softplus, the scan's sums and the loss in float32 by ``.float()``)."""
    real = torch.Tensor.float

    def keep64(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else real(self, *args,
                                                                **kwargs)
    torch.Tensor.float = keep64
    try:
        with plain_scan_in_fp64():
            yield
    finally:
        torch.Tensor.float = real


def _fp64_train_witness(job: dict) -> tuple:
    """(c)'s float64 witness: the one-card step's gradient, the same
    weights and batch as train()'s first step, in float64 throughout on
    the plain path (the kernels take no float64); the loss and (1 - b1)·g,
    the first moments an AdamW step would hold."""
    dev = torch.device(job["device"])
    api = get_model(_gate_train_cfg(job))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = make_trainable(api.init_params(gen, torch.float32, dev)).to(
        torch.float64)
    chunk = torch.from_numpy(SyntheticTokens(api.cfg.vocab_size, seed=0)
                             .batch(job["train_b"], job["train_s"])).to(dev)
    named = dict(params.named_parameters())
    with float64_throughout():
        loss = api.loss(params, chunk[:, :-1], chunk[:, 1:], use_kernel=False)
        grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), {n: ((1 - 0.9) * g).cpu()
                         for n, g in zip(named, grads)}


def _sharded_train(mesh, job: dict) -> dict:
    """(c): one fp32 train() step under the mesh (its AdamW first moments
    gathered on rank 0), then the bf16 steps timed."""
    import torch.distributed as dist
    reset_counts()
    loss, m = _fp32_train_step(job, mesh=mesh)
    fp32_counts = _rank_counts()
    api = get_model(_arch(job, "train_arch"))
    params = make_trainable(_rank_params(api, mesh, torch.bfloat16, False))
    opt = adamw.init(dict(params.named_parameters()))
    step = make_train_step(api, 1, param_dtype=torch.bfloat16)
    dev = mesh.devices[dist.get_rank()]
    chunk = torch.from_numpy(SyntheticTokens(api.cfg.vocab_size, seed=0)
                             .batch(job["train_b"], job["train_s"])).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    ms, bf16_losses = [], []
    with shp.activate(mesh):
        batch = {k: shp.place(v, shp.data_sharding(v.shape, mesh))
                 for k, v in (("tokens", chunk[:, :-1]),
                              ("labels", chunk[:, 1:]))}
        for _ in range(job["train_steps"]):
            _sync(dev)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            bf16_losses.append(float(_full(metrics["loss"])))
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"loss": loss, "m": m if dist.get_rank() == 0 else None,
            "fp32_counts": fp32_counts, "bf16_counts": _rank_counts(),
            "bf16_ms": ms, "bf16_losses": bf16_losses,
            "peak_gb": _peak_gb(dev)}


def _lm_calls(api, params, mesh, dev, tokens, fed, max_len: int,
              full) -> tuple:
    """(b') and (b'')'s calls on ``mesh``: the prompt placed, prefill,
    then one decode step for each token of ``fed``; every logits through
    ``full`` (each a gather of the DTensor) and the placements of the
    cache's k, v and SSM state."""
    with shp.activate(mesh), torch.no_grad():
        tokens = shp.place(tokens.to(dev), shp.data_sharding(tokens.shape,
                                                             mesh))
        cache, last = make_prefill_step(api, max_len)(params,
                                                      {"tokens": tokens})
        placements = {n: str(list(cache[n].placements))
                      for n in ("k", "v", "state") if n in cache}
        logits = [full(last)]
        for f in fed:
            out, cache = api.decode_step(params, cache, shp.place(
                f.to(dev), shp.data_sharding(f.shape, mesh)))
            logits.append(full(out))
    return logits, placements


# (b') and (b''): the architecture's job key and its depth's
MESH_LM_CASES = {"heads": ("heads_arch", "gate_layers"),
               "ssm": ("ssm_arch", "ssm_layers")}


def _case_api(job: dict, case: str):
    arch, layers = MESH_LM_CASES[case]
    return get_model(_arch(job, arch, n_layers=job[layers]))


def _sharded_lm(mesh, job: dict, case: str) -> dict:
    """(b') or (b''): the fp32 gate on the (1, 4) mesh: prefill and decode
    steps fed the one-rank run's greedy tokens; every logits, the cache's
    placements."""
    api = _case_api(job, case)
    params = _rank_params(api, mesh, torch.float32, False)
    dev = mesh.devices[torch.distributed.get_rank()]
    reset_counts()
    logits, placements = _lm_calls(
        api, params, mesh, dev, job[f"{case}_tokens"], job[f"{case}_fed"],
        job["s"] + job["steps"], _full)
    _sync(dev)
    return {"logits": logits, "counts": _rank_counts(),
            "cache": placements}


def dry_run_walks(job: dict) -> dict:
    """Phase 12(d), in a CPU process of its own (its fake groups must not
    meet phase 12's ranks): (b') and (b'')'s calls at their
    configurations, layers, batch, prompt and steps walked on the meta
    device (``roofline.op_walk``) over torch's fake group of MESH_RANKS
    at HEADS_SHAPE, the mesh of the cards' device type (``launch.mesh``,
    ``device="meta"``), each logits gathered as ``_full`` gathers it;
    then ``launch.dryrun.run_cell`` of DRYRUN_ARCH's DRYRUN_SHAPE at the
    single- and multi-pod meshes.  The collective counts by kind and the
    walk's seconds of each case, and the two records' numbers."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_process_mesh as process_mesh
    out = {"cases": {}, "records": {}}
    b, s = job["b"], job["s"]
    for case in MESH_LM_CASES:
        api = _case_api(job, case)
        t0 = time.perf_counter()
        with dryrun.fake_world(MESH_RANKS):
            mesh = process_mesh(HEADS_SHAPE, ("data", "model"),
                                device="meta")
            params = api.init_params(torch.Generator().manual_seed(0),
                                     torch.float32, "meta")
            shp.place_params(params, shp.param_shardings(params, api.cfg,
                                                         mesh))
            tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
            fed = [torch.empty((b, 1), dtype=torch.int32, device="meta")
                   for _ in range(job["steps"])]
            acc = op_walk.analyze(_lm_calls, api, params, mesh, "meta",
                                  tokens, fed, s + job["steps"],
                                  lambda x: x.full_tensor())
        out["cases"][case] = {
            "counts": {k: n for k, n in acc.collective_counts.items() if n},
            "walk_s": time.perf_counter() - t0}
    for kind in ("single", "multi"):
        with dryrun.fake_world(dryrun.WORLDS[kind]):
            rec = dryrun.run_cell(DRYRUN_ARCH, DRYRUN_SHAPE, kind)
        out["records"][kind] = {k: rec[k] for k in (
            "chips", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_counts", "walk_s",
            "split")} | {"dominant": rec["roofline"]["dominant"]}
    return out


def start_dry_run(job: dict) -> CpuProcess:
    """Phase 12(d)'s ``dry_run_walks`` started in a CPU subprocess, to run
    beside phase 12's ranks."""
    keys = ("heads_arch", "gate_layers", "ssm_arch", "ssm_layers", "b", "s",
            "steps", "smoke", "changes")
    return CpuProcess("import json, sys, chip_smoke; print(json.dumps("
                      "chip_smoke.dry_run_walks(json.loads(sys.argv[1]))))",
                      json.dumps({k: job[k] for k in keys}))


def dry_run_phase(job: dict, walks: CpuProcess, staged: dict,
                  on_card: bool) -> None:
    """Phase 12(d): the walks ``start_dry_run`` started, each case's
    collectives by kind against ``staged[case]``, the collectives rank 0
    staged through host memory in that part (every functional collective
    a gloo rank on a card runs: what the card's ranks ran); a CPU
    rehearsal stages none and compares nothing."""
    _, got = walks.result("dry run walks", 600)
    for case, (arch, layers) in MESH_LM_CASES.items():
        ran = {}
        for name, n in staged[case].items():
            kind = STAGED_KINDS.get(name, name)
            ran[kind] = ran.get(kind, 0) + n
        walked = got["cases"][case]["counts"]
        if on_card and (not ran or walked != ran):
            raise AssertionError(f"dry run: the walk of {case}'s calls "
                                 f"counts {walked}, rank 0 staged {ran}")
        phase("dryrun", f"{job[arch]} {job[layers]} layers fp32 (prefill "
                        f"{job['b']} x {job['s']}, {job['steps']} decode "
                        f"steps, each logits gathered) walked on meta over a "
                        f"fake group of {MESH_RANKS} at {HEADS_SHAPE}: "
                        f"collectives {walked}; rank 0 staged {ran}"
                        + (" (equal)" if on_card else
                           " (a CPU rehearsal stages none)")
                        + f"; walk {got['cases'][case]['walk_s']:.1f} s")
    phase("dryrun", f"the walks' subprocess "
                    f"{time.perf_counter() - walks.t0:.1f} s "
                    "(beside the ranks)")
    for kind, r in got["records"].items():
        phase("dryrun", f"{DRYRUN_ARCH} {DRYRUN_SHAPE} at the {kind} "
                        f"production mesh ({r['chips']} ranks, fake group, "
                        f"meta; counts, not times): per device "
                        f"{r['flops_per_device']:.6g} flops, "
                        f"{r['bytes_per_device']:.6g} HBM bytes, "
                        f"{r['collective_bytes_per_device']:.6g} collective "
                        f"wire bytes; dominant {r['dominant']}; split "
                        f"{r['split']}; walk {r['walk_s']} s")


@contextmanager
def train_config(name: str, cfg):
    """Within: ``train(name, smoke=False)`` trains ``cfg``."""
    real = train_module.get_arch
    train_module.get_arch = lambda arch: cfg if arch == name else real(arch)
    try:
        yield
    finally:
        train_module.get_arch = real


@contextmanager
def timed_checkpoints(record: dict):
    """Within: each ``checkpoint.save`` and ``restore`` timed into
    ``record`` ("save_s", "restore_s"), with the bytes a save gathers
    whole a rank ("gathered_gb": its DTensor leaves' global sizes) and
    those staged through host memory while it runs ("staged_gb")."""
    real_save, real_restore = checkpoint.save, checkpoint.restore

    def save(ckpt_dir, state, step, **kwargs):
        staged = sum(host_collectives.STAGED_BYTES.values())
        t0 = time.perf_counter()
        out = real_save(ckpt_dir, state, step, **kwargs)
        record["save_s"].append(time.perf_counter() - t0)
        record["gathered_gb"].append(sum(
            leaf.numel() * leaf.element_size()
            for leaf in checkpoint._flatten(state)
            if shp.is_distributed(leaf)) / 1e9)
        record["staged_gb"].append(
            (sum(host_collectives.STAGED_BYTES.values()) - staged) / 1e9)
        return out

    def restore(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_restore(*args, **kwargs)
        record["restore_s"].append(time.perf_counter() - t0)
        return out
    checkpoint.save, checkpoint.restore = save, restore
    try:
        yield
    finally:
        checkpoint.save, checkpoint.restore = real_save, real_restore


def _sharded_resume(mesh, job: dict) -> dict:
    """(c'): the bf16 run of 2 x RESUME_AT steps with a checkpoint every
    RESUME_AT in ``job["ckpt_dir"]``; its last checkpoint removed (by rank
    0), as if the run had been cut after step RESUME_AT; a resume for
    RESUME_AT more; what differs between the two, bit for bit."""
    k = job["resume_at"]
    cfg = _arch(job, "train_arch", n_layers=job["resume_layers"])
    kw = dict(batch_size=job["train_b"], seq_len=job["resume_s"],
              smoke=False, log_every=100, mesh=mesh,
              param_dtype=torch.bfloat16)
    record = {"save_s": [], "restore_s": [], "gathered_gb": [],
              "staged_gb": []}
    reset_counts()
    with train_config(job["train_arch"], cfg), timed_checkpoints(record):
        params, opt, losses = train(job["train_arch"], steps=2 * k,
                                    ckpt_dir=job["ckpt_dir"], ckpt_every=k,
                                    **kw)
        if torch.distributed.get_rank() == 0:
            for f in Path(job["ckpt_dir"]).glob(f"step_{2 * k:010d}.*"):
                f.unlink()
        again, opt2, resumed = train(job["train_arch"], steps=k,
                                     ckpt_dir=job["ckpt_dir"],
                                     ckpt_every=10 * k, resume=True, **kw)
    named = dict(params.named_parameters())
    return {
        "losses": losses, "resumed": resumed, "record": record,
        "steps": (int(opt.step), int(opt2.step)),
        "differ": [n for n, p in again.named_parameters()
                   if not torch.equal(_full(p), _full(named[n]))]
        + [(f, n) for f in ("master", "m", "v")
           for n, t in getattr(opt2, f).items()
           if not torch.equal(_full(t), _full(getattr(opt, f)[n]))],
        "off_mesh": [n for n, p in again.named_parameters()
                     if not shp.is_distributed(p)],
        "counts": _rank_counts()}


@contextmanager
def rank_part(out: dict, name: str):
    """Within: part ``name`` of a rank's run; its host seconds, the
    collectives it staged and the times ``sharding.split_heads`` or
    ``merge_heads`` gathered a dimension ("head_gathers") go to
    ``out["parts"][name]``."""
    gathers = []
    real = shp._whole_where_uneven

    def counted(x, dim, n):
        y = real(x, dim, n)
        if y is not x:
            gathers.append(1)
        return y
    staged = dict(host_collectives.STAGED)
    shp._whole_where_uneven = counted
    t0 = time.perf_counter()
    try:
        yield
    finally:
        shp._whole_where_uneven = real
        out.setdefault("parts", {})[name] = {
            "s": time.perf_counter() - t0, "head_gathers": len(gathers),
            "staged": {k: n - staged.get(k, 0)
                       for k, n in host_collectives.STAGED.items()
                       if n > staged.get(k, 0)}}


def _part(case: str) -> str:
    """The rank part of (b') ("heads") or (b'') ("ssm")."""
    return str(HEADS_SHAPE) + ("" if case == "heads" else f" {case}")


def mesh_ranks(rank: int, world: int, job: dict) -> dict:
    """Phase 12 (b), (b'), (b''), (c) and (c') on one rank of the spawned
    group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_process_mesh(MESH_SHAPE, ("data", "model"),
                             device=job["device"])
    out = {"backend": torch.distributed.get_backend(),
           "device": str(mesh.devices[rank])}
    with rank_part(out, "serving"):
        for mode in ("none", "local"):
            out[mode] = _sharded_serve(mesh, job, mode)
        out["bf16"] = _sharded_bf16(mesh, job)
    heads_mesh = make_process_mesh(HEADS_SHAPE, ("data", "model"),
                                   device=job["device"])
    for case in MESH_LM_CASES:
        with rank_part(out, _part(case)):
            out[case] = _sharded_lm(heads_mesh, job, case)
    with rank_part(out, "training"):
        out["train"] = _sharded_train(mesh, job)
    with rank_part(out, "resume"):
        out["resume"] = _sharded_resume(mesh, job)
    out["staged"] = dict(host_collectives.STAGED)
    out["staged_gb"] = sum(host_collectives.STAGED_BYTES.values()) / 1e9
    return out


def _one_rank_serve(job: dict, mode: str) -> dict:
    """The one-rank fp32 run of (b)'s gate in one MoE mode: the model cut
    to its gate depth, seed 0, prefill and greedy decode steps on the
    kernel path, its expert picks recorded.  "local" runs each MoE layer
    per data shard (``per_shard_moe``), the local layer's semantics."""
    dev = torch.device(job["device"])
    api = get_model(_arch(job, "arch", n_layers=job["gate_layers"]))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(gen, torch.float32, dev)
    tokens = torch.randint(0, api.cfg.vocab_size, (job["b"], job["s"]),
                           generator=torch.Generator(device=dev)
                           .manual_seed(2), device=dev, dtype=torch.int32)
    tape = RoutingTape()
    with tape.installed(), tape.recording(True), torch.no_grad(), (
            per_shard_moe(MESH_SHAPE[0]) if mode == "local"
            else nullcontext()):
        cache, last = make_prefill_step(api, job["s"] + job["steps"])(
            params, {"tokens": tokens})
        logits, fed = [last.cpu()], []
        for _ in range(job["steps"]):
            fed.append(_greedy(logits[-1]).cpu())
            out, cache = api.decode_step(params, cache, fed[-1].to(dev))
            logits.append(out.cpu())
    return {"tokens": tokens.cpu(), "fed": fed, "logits": logits,
            "picks": [p.cpu() for p in tape.picks]}


def _one_rank_lm(job: dict, case: str) -> dict:
    """The one-rank fp32 run of (b') ("heads") or (b'') ("ssm"): the
    architecture cut to its depth, seed 0, prefill and greedy decode
    steps on the kernel path."""
    dev = torch.device(job["device"])
    api = _case_api(job, case)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(gen, torch.float32, dev)
    seed = 3 + list(MESH_LM_CASES).index(case)
    tokens = torch.randint(0, api.cfg.vocab_size, (job["b"], job["s"]),
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed), device=dev, dtype=torch.int32)
    with torch.no_grad():
        cache, last = make_prefill_step(api, job["s"] + job["steps"])(
            params, {"tokens": tokens})
        logits, fed = [last.cpu()], []
        for _ in range(job["steps"]):
            fed.append(_greedy(logits[-1]).cpu())
            out, cache = api.decode_step(params, cache, fed[-1].to(dev))
            logits.append(out.cpu())
    return {"tokens": tokens.cpu(), "fed": fed, "logits": logits}


def _one_card_train(job: dict) -> dict:
    """(c)'s one-card fp32 step, train() at the same arguments with no
    mesh, and its float64 witness."""
    out = {}
    out["loss"], out["m"] = _fp32_train_step(job, device=job["device"])
    out["loss64"], out["m64"] = _fp64_train_witness(job)
    return out


def mesh_serving_phase(job: dict | None = None) -> dict:
    """Phase 12 (b)-(d): the one-rank runs here, then one spawn of
    MESH_RANKS ranks (``run_ranks``) for the sharded ones, (d)'s walks
    in a subprocess beside them; every gate on rank 0's gathered results
    and each rank's launches.  Returns the launches by path for the
    kernels line.  ``job`` (``mesh_settings``) sets the sizes and the
    device."""
    job = mesh_settings() if job is None else job
    walks = start_dry_run(job)
    try:
        return _mesh_serving(job, walks)
    finally:
        walks.stop()


def _mesh_serving(job: dict, walks: CpuProcess) -> dict:
    t0 = time.perf_counter()
    one = {mode: _one_rank_serve(job, mode) for mode in ("none", "local")}
    one_lm = {case: _one_rank_lm(job, case) for case in MESH_LM_CASES}
    one_train = _one_card_train(job)
    if job["device"] == "cuda":
        torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh-ckpt-") as ckpt_dir:
        ranks = run_ranks(mesh_ranks, MESH_RANKS, job | {
            "tokens": one["none"]["tokens"],
            "fed": {m: one[m]["fed"] for m in one},
            "picks": {m: one[m]["picks"] for m in one},
            **{f"{case}_{k}": one_lm[case][k] for case in MESH_LM_CASES
               for k in ("tokens", "fed")}, "ckpt_dir": ckpt_dir},
            device=job["device"], timeout=900)
    spawn_s = time.perf_counter() - t0
    head = ranks[0]
    layers_ = job["gate_layers"]
    full_layers = _arch(job, "arch").n_layers
    steps = job["steps"]
    on_card = job["device"] == "cuda"     # a CPU rehearsal launches nothing
    against = {"none": "", "local": " with each MoE layer per data shard"}
    for mode in ("none", "local"):
        got = head[mode]
        worst = max(_lm_gate(f"sharded {mode} {'prefill' if i == 0 else i}",
                             g, w, SHARD_TOL)
                    for i, (g, w) in enumerate(zip(got["logits"],
                                                   one[mode]["logits"])))
        for r in ranks:
            c = r[mode]["counts"]
            if on_card and (c["flash_attention"][0] != layers_ or c[
                    "decode_attention"][0] != layers_ * steps or c[
                    "ssd_scan"][0]):
                raise AssertionError(f"sharded {mode}: launches {c}")
        phase("mesh", f"{job['arch']} {layers_} layers fp32 on "
                      f"{MESH_RANKS} ranks {MESH_SHAPE} ({head['backend']}, "
                      f"{head['device']}), moe_buffer_shard {mode!r}: "
                      f"prefill {job['b']} x {job['s']} and {steps} "
                      f"decode steps within {worst:.3g} x max |logits| of "
                      f"the one-rank run{against[mode]} "
                      f"(gate {SHARD_TOL}), the same greedy "
                      f"tokens; expert picks replayed, {got['flips']} of "
                      f"{got['routed']} routings flip; per rank flash "
                      f"{layers_} + decode {layers_ * steps} launches")
    bf16 = [r["bf16"] for r in ranks]
    bf16_layers = _bf16_layers(job)
    for b in bf16:
        c = b["counts"]
        if on_card and (c["flash_attention"][0] != 2 * bf16_layers or c[
                "decode_attention"][0] != 2 * bf16_layers * steps):
            raise AssertionError(f"sharded bf16: launches {c}")
        if not torch.equal(b["tokens"], bf16[0]["tokens"]):
            raise AssertionError("sharded bf16: ranks hold other tokens")
    phase("mesh", f"{job['arch']} at full width cut to {bf16_layers} of its "
                  f"{full_layers} layers, bf16 on {MESH_RANKS} "
                  f"ranks: prefill {job['b']} x {job['s']} "
                  f"{bf16[0]['prefill_ms']:.1f} ms, decode "
                  f"{bf16[0]['step_ms']:.1f} ms a step (second run, host "
                  f"clock, rank 0); per rank flash {2 * bf16_layers} and "
                  f"decode {2 * bf16_layers * steps} launches; peak "
                  f"memory a rank " + ", ".join(f"{b['peak_gb']:.2f}"
                                                for b in bf16) + " GB")
    heads_layers = job["gate_layers"]
    heads_full = _arch(job, "heads_arch").n_layers
    phase("mesh", f"{job['heads_arch']} at full width, fp32, on the same "
                  f"{MESH_RANKS} ranks as a {HEADS_SHAPE} mesh: its "
                  f"{_arch(job, 'heads_arch').n_kv_heads} KV heads do not "
                  f"split over \"model\" ({HEADS_SHAPE[1]}); depth cut to "
                  f"{heads_layers} of its {heads_full} layers, as "
                  f"SHARD_GATE_LAYERS cuts olmoe-1b-7b's")
    got = head["heads"]
    worst = max(_lm_gate(f"sharded {HEADS_SHAPE} "
                         f"{'prefill' if i == 0 else i}", g, w, SHARD_TOL)
                for i, (g, w) in enumerate(zip(got["logits"],
                                               one_lm["heads"]["logits"])))
    for r in ranks:
        c = r["heads"]["counts"]
        if on_card and (c["flash_attention"][0] != heads_layers or c[
                "decode_attention"][0] != heads_layers * steps or c[
                "ssd_scan"][0]):
            raise AssertionError(f"sharded {HEADS_SHAPE}: launches {c}")
        if any("Replicate(), Replicate()" not in p
               for p in r["heads"]["cache"].values()):
            raise AssertionError(f"sharded {HEADS_SHAPE}: the KV cache split "
                                 f"its heads: {r['heads']['cache']}")
    phase("mesh", f"{job['heads_arch']} {heads_layers} layers fp32 on "
                  f"{MESH_RANKS} ranks {HEADS_SHAPE}: prefill {job['b']} x "
                  f"{job['s']} and {steps} decode steps within {worst:.3g} "
                  f"x max |logits| of the one-rank run (gate {SHARD_TOL}), "
                  f"the same greedy tokens; the KV cache whole on "
                  f"\"model\" ({got['cache']['k']}); per rank flash "
                  f"{heads_layers} + decode {heads_layers * steps} launches")
    ssm_cfg = _case_api(job, "ssm").cfg
    got = head["ssm"]
    worst = max(_lm_gate(f"sharded {HEADS_SHAPE} {job['ssm_arch']} "
                         f"{'prefill' if i == 0 else i}", g, w, SHARD_TOL)
                for i, (g, w) in enumerate(zip(got["logits"],
                                               one_lm["ssm"]["logits"])))
    n_super = ssm_cfg.n_layers // ssm_cfg.attn_every
    for r in ranks:
        c = r["ssm"]["counts"]
        if on_card and (c["flash_attention"][0] != n_super or c[
                "decode_attention"][0] != n_super * steps or c[
                "ssd_scan"][0] != ssm_cfg.n_layers):
            raise AssertionError(f"sharded {HEADS_SHAPE} {job['ssm_arch']}: "
                                 f"launches {c}")
        if "Shard" not in r["ssm"]["cache"]["state"]:
            raise AssertionError(f"sharded {HEADS_SHAPE} {job['ssm_arch']}: "
                                 f"the SSM state whole on \"model\": "
                                 f"{r['ssm']['cache']}")
    staged = head["parts"][_part("ssm")]["staged"]
    phase("mesh", f"{job['ssm_arch']} at full width cut to "
                  f"{ssm_cfg.n_layers} of its {_arch(job, 'ssm_arch').n_layers}"
                  f" layers ({n_super} super-block: {ssm_cfg.attn_every} "
                  f"Mamba-2 layers and the shared block) fp32 on "
                  f"{MESH_RANKS} ranks {HEADS_SHAPE}, the decode step on "
                  f"each rank's {ssm_cfg.ssm_nheads // HEADS_SHAPE[1]} of "
                  f"{ssm_cfg.ssm_nheads} SSM heads, in_proj and out_proj "
                  f"split over \"model\": prefill {job['b']} x {job['s']} "
                  f"and {steps} decode steps within {worst:.3g} x max "
                  f"|logits| of the one-rank run (gate {SHARD_TOL}), the same "
                  f"greedy tokens; the state {got['cache']['state']}; per "
                  f"rank ssd_scan {ssm_cfg.n_layers}, flash {n_super} + "
                  f"decode {n_super * steps} launches; rank 0 staged "
                  f"{staged}")
    tr = head["train"]

    def rel_loss(a: float, b: float) -> float:
        return abs(a - b) / abs(b)

    def grad_gap(got: dict, want: dict) -> tuple:
        """max over the leaves of max |got - want| / max |want|, and its
        leaf (the first moments of float32 steps against a float64 witness
        compared in float64)."""
        gap = {n: (got[n].double() - m.double()).abs().max().item()
               / max(m.abs().max().item(), 1e-30) for n, m in want.items()}
        worst = max(gap, key=gap.get)
        return gap[worst], worst
    rel = rel_loss(tr["loss"], one_train["loss"])
    rel64 = rel_loss(one_train["loss"], one_train["loss64"])
    gaps = {"sharded vs one card": grad_gap(tr["m"], one_train["m"]),
            "one card vs float64": grad_gap(one_train["m"], one_train["m64"]),
            "sharded vs float64": grad_gap(tr["m"], one_train["m64"])}
    # 8b's rule, its noise measured here: the one-card fp32 step's own
    # distance from the float64 witness; the sharded step may lie that far
    # on the other side
    noise = gaps["one card vs float64"][0]
    grad_gate = TRAIN_GRAD_TOL + 2 * noise
    if not (rel <= TRAIN_LOSS_RTOL and rel64 <= TRAIN_LOSS_RTOL
            and gaps["sharded vs one card"][0] <= grad_gate
            and gaps["sharded vs float64"][0] <= grad_gate):
        raise AssertionError(f"sharded train: loss rel {rel} (one card vs "
                             f"float64 {rel64}), gradients {gaps} x max |g| "
                             f"(gate {grad_gate})")
    per_layer = 2 if _arch(job, "train_arch").remat else 1
    n_ssd = _arch(job, "train_arch").n_layers * per_layer
    n_gate = _gate_train_cfg(job).n_layers * per_layer
    for r in ranks:
        t = r["train"]
        if on_card and (t["fp32_counts"]["ssd_scan"][0] != n_gate or t[
                "bf16_counts"]["ssd_scan"][0] != n_ssd * job["train_steps"]):
            raise AssertionError(f"sharded train: launches "
                                 f"{t['fp32_counts']} {t['bf16_counts']}")
    phase("mesh", f"{job['train_arch']} train() on {MESH_RANKS} ranks, B "
                  f"{job['train_b']} x S {job['train_s']}: cut to "
                  f"{_gate_train_cfg(job).n_layers} layers, fp32 step loss "
                  f"{tr['loss']:.6f} within {rel:.3g} of the one-card "
                  f"step's (the one-card step within {rel64:.3g} of its "
                  f"float64 witness's); gradients, worst leaf of max |a - "
                  f"b| / max |b|: " + "; ".join(
                      f"{k} {v:.3g} ({leaf})"
                      for k, (v, leaf) in gaps.items())
                  + f" (gate {TRAIN_GRAD_TOL} + 2 x {noise:.3g}, phase 8b's "
                  f"rule); {job['train_steps']} bf16 steps "
                  + ", ".join(f"{x:.1f}" for x in tr["bf16_ms"])
                  + f" ms (host clock), losses "
                  + " ".join(f"{x:.4f}" for x in tr["bf16_losses"])
                  + f" at full depth; ssd_scan {n_gate} launches in the fp32 "
                  f"step and {n_ssd} a bf16 step per rank; peak "
                  f"memory a rank {tr['peak_gb']:.2f} GB")
    rs = head["resume"]
    k = job["resume_at"]
    n_resume = job["resume_layers"] * (
        2 if _arch(job, "train_arch").remat else 1)
    if rs["steps"] != (2 * k, 2 * k) or rs["resumed"] != rs["losses"][k:] \
            or rs["differ"] or rs["off_mesh"]:
        raise AssertionError(f"sharded resume: steps {rs['steps']}, losses "
                             f"{rs['losses']} resumed {rs['resumed']}, "
                             f"differ {rs['differ'][:8]}, off the mesh "
                             f"{rs['off_mesh'][:8]}")
    for r in ranks:
        c = r["resume"]["counts"]
        if on_card and c["ssd_scan"][0] != n_resume * 3 * k:
            raise AssertionError(f"sharded resume: launches {c}")
    rec = rs["record"]
    phase("mesh", f"{job['train_arch']} at full width cut to "
                  f"{job['resume_layers']} layers, bf16 train() on "
                  f"{MESH_RANKS} ranks {MESH_SHAPE}, B {job['train_b']} x "
                  f"S {job['resume_s']}: a {2 * k}-step run checkpointed at "
                  f"steps {k} and {2 * k}, cut back to step {k} and "
                  f"resumed for {k} more, repeats its steps {k + 1}-{2 * k} "
                  f"bit for bit (losses "
                  + " ".join(f"{x:.6f}" for x in rs["losses"])
                  + f"; parameters, AdamW master, m and v); per rank "
                  f"ssd_scan {n_resume} launches a step")
    phase("mesh", f"checkpoint under the mesh, rank 0: save "
                  + ", ".join(f"{x:.2f}" for x in rec["save_s"])
                  + " s (gather and host copy; rank 0's write async), "
                  f"gathering {rec['gathered_gb'][0]:.3f} GB a rank whole "
                  f"(staged through host memory: "
                  + ", ".join(f"{x:.3f}" for x in rec["staged_gb"])
                  + " GB), restore "
                  + ", ".join(f"{x:.2f}" for x in rec["restore_s"])
                  + f" s (host clock); on {CARD['smi']}")
    # the head split gathers where "model" does not divide the attention
    # heads, and only there: in (b'), never on MESH_SHAPE, where every head
    # count divides it, nor in (b'') (32 heads and KV heads over 4)
    def heads_divide(case: str) -> bool:
        cfg = _case_api(job, case).cfg
        return not (cfg.n_heads % HEADS_SHAPE[1]
                    or cfg.n_kv_heads % HEADS_SHAPE[1])
    gathering = {_part(case): not heads_divide(case)
                 for case in MESH_LM_CASES}
    for r in ranks:
        gathers = {name: part["head_gathers"]
                   for name, part in r["parts"].items()}
        if any(bool(n) != gathering.get(name, False)
               for name, n in gathers.items()):
            raise AssertionError(f"head gathers by part: {gathers}")
    parts = head["parts"]
    phase("mesh", f"one-rank runs {one_s:.1f} s, the spawn {spawn_s:.1f} s "
                  "(" + ", ".join(f"{name} {part['s']:.1f} s"
                                  for name, part in parts.items())
                  + "); collectives staged through host memory on rank 0 "
                  "by part: " + "; ".join(f"{name} {part['staged']}"
                                          for name, part in parts.items())
                  + f" ({head['staged_gb']:.2f} GB copied in all); the "
                  f"head split gathered "
                  + ", ".join(f"{parts[name]['head_gathers']} times in "
                              f"{name}" for name, on in gathering.items()
                              if on)
                  + f", never on {MESH_SHAPE}; on {CARD['smi']}")
    dry_run_phase(job, walks, {case: parts[_part(case)]["staged"]
                               for case in MESH_LM_CASES}, on_card)

    def total(kernel, part):
        return sum(r[part]["counts"][kernel][0] for r in ranks)

    def by_dtype(kernel, parts):
        out = {}
        for r in ranks:
            for part in parts:
                for dt, n in r[part]["counts"][kernel][1].items():
                    out[dt] = out.get(dt, 0) + n
        return out
    return {
        "by_path": {
            f"sharded {job['arch']} ({MESH_RANKS} ranks)": {
                k: sum(total(k, p) for p in ("none", "local", "bf16"))
                for k in ("flash_attention", "decode_attention")},
            f"sharded {job['heads_arch']} {HEADS_SHAPE} ({MESH_RANKS} "
            f"ranks)": {k: total(k, "heads")
                        for k in ("flash_attention", "decode_attention")},
            f"sharded {job['ssm_arch']} {HEADS_SHAPE} ({MESH_RANKS} "
            f"ranks)": {k: total(k, "ssm")
                        for k in ("flash_attention", "decode_attention",
                                  "ssd_scan")},
            f"sharded train {job['train_arch']} ({MESH_RANKS} ranks)": {
                "ssd_scan": sum(r["train"]["fp32_counts"]["ssd_scan"][0]
                                + r["train"]["bf16_counts"]["ssd_scan"][0]
                                for r in ranks)},
            f"sharded resume {job['train_arch']} ({MESH_RANKS} ranks)": {
                "ssd_scan": total("ssd_scan", "resume")}},
        "by_dtype": {
            k: by_dtype(k, ("none", "local", "bf16", "heads", "ssm"))
            for k in ("flash_attention", "decode_attention")} | {
            "ssd_scan": {dt: sum(r["train"][part]["ssd_scan"][1].get(dt, 0)
                                 for r in ranks
                                 for part in ("fp32_counts", "bf16_counts"))
                         + sum(r[part]["counts"]["ssd_scan"][1].get(dt, 0)
                               for r in ranks for part in ("resume", "ssm"))
                         for dt in ("float32", "bfloat16")}}}


COUNTED = (embedding_bag_cuda, flash_attention_cuda, decode_attention_cuda,
           ssd_scan_cuda, fcfs_scan_cuda)


def reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
        for by in ("launches_by_dtype", "launches_by_flavour"):
            for key in getattr(fn, by, {}):
                getattr(fn, by)[key] = 0


def _ms(x) -> str:
    return "none" if x is None else f"{x:.5f} ms"


def main() -> int:
    started = time.perf_counter()
    name = device_phase()
    build_phase()
    walks = start_roofline_walks()
    try:
        _main(name, walks, started)
    finally:
        walks.stop()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _main(name: str, walks: CpuProcess, started: float) -> None:
    stages = [("start", started)]

    def stage(label: str) -> None:
        stages.append((label, time.perf_counter()))

    worst = kernel_phase()
    attn_worst = attention_phase()
    ssd_worst = ssd_phase()
    cf2_phase()
    fcfs_lanes = simulator_phase()
    stream_phase()
    forward_phase()
    paper_forward_phase()
    stage("phases 3-4b")

    # Main path 1: the MT-WND serving pool and RIBBON's search over it.
    engine = ClusterEngine("mtwnd", DEFAULT_CELLS, seed=0, device="cuda")
    wl = WorkloadSpec(seed=0, rate_qps=150.0, median_batch=8,
                      max_batch=32).realize(80)
    reset_counts()
    engine.warmup(max_batch=BUCKETS[-1])
    forwards = len(DEFAULT_CELLS) * len(BUCKETS)
    forwards += serve_phase(engine, wl)
    forwards += ribbon_phase(engine, wl)
    bag_launches = embedding_bag_cuda.launches
    if bag_launches == 0 or bag_launches != forwards:
        raise AssertionError(f"embedding_bag launched {bag_launches} times "
                             f"on the main path, expected one for each of "
                             f"{forwards} forwards")
    phase("launches", f"embedding_bag: {bag_launches} launches on the MT-WND "
                      f"path = 1 x {forwards} forwards (each pools all "
                      f"{CFG['n_tables']} tables)")
    del engine

    # Main path 1b: the other four paper models served live, the serve
    # driver over all five, and recovery on the live engine.
    paper_serve_phase(wl)
    serve_driver_phase()
    stage("phases 5-6b")

    # Main path 2: RIBBON's own search over the pool simulator.
    reset_counts()
    dispatches = search_path()
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    scan_launches = counts.pop("fcfs_scan")
    if scan_launches == 0 or scan_launches != dispatches or any(
            counts.values()):
        raise AssertionError(f"search path: fcfs_scan launched "
                             f"{scan_launches} times for {dispatches} "
                             f"simulator dispatches; others {counts}")
    phase("launches", f"fcfs_scan: {scan_launches} launches on the search "
                      f"path = 1 x {dispatches} simulator dispatches; no "
                      "other kernel")

    # Main path 2b: RIBBON's load-change adaptation over the simulator.
    reset_counts()
    lc_dispatches = load_change_path()
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    lc_launches = counts.pop("fcfs_scan")
    by_flavour = dict(fcfs_scan_cuda.launches_by_flavour)
    if lc_launches == 0 or lc_launches != lc_dispatches or any(
            counts.values()) or by_flavour["cold"] == 0 or any(
            by_flavour[f] == 0 for f in ("policy", "telemetry", "trace")):
        raise AssertionError(f"load-change path: fcfs_scan launched "
                             f"{lc_launches} times ({by_flavour}) for "
                             f"{lc_dispatches} simulator dispatches; others "
                             f"{counts}")
    phase("launches", f"fcfs_scan: {lc_launches} launches on the load-change "
                      f"path = 1 x {lc_dispatches} simulator dispatches, by "
                      f"flavour {by_flavour} (a launch counts once per "
                      "flavour it has; cold = none); no other kernel")

    # Main path 2c: streamed episodes, one stream-flavour launch a chunk.
    reset_counts()
    st_dispatches = stream_path()
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    st_launches = counts.pop("fcfs_scan")
    st_flavour = dict(fcfs_scan_cuda.launches_by_flavour)
    if st_launches == 0 or st_launches != st_dispatches or any(
            counts.values()) or st_flavour["stream"] != st_launches or any(
            n for f, n in st_flavour.items() if f != "stream"):
        raise AssertionError(f"streaming path: fcfs_scan launched "
                             f"{st_launches} times ({st_flavour}) for "
                             f"{st_dispatches} chunks; others {counts}")
    phase("launches", f"fcfs_scan: {st_launches} launches on the streaming "
                      f"path = 1 x {st_dispatches} chunks, all of the stream "
                      "flavour; no other kernel")

    catalog_phase()
    stage("phases 7-7d")

    # Main paths 3-5: the LMs' serving paths at full width and depth.
    by_path, by_dtype, lm_ms = {}, {}, {}
    for run in LM_RUNS:
        by_path[run.label], dtypes, lm_ms[run.label] = lm_path(run)
        for kernel, counts in dtypes.items():
            total = by_dtype.setdefault(kernel, dict.fromkeys(counts, 0))
            for dtype, n in counts.items():
                total[dtype] += n
    stage("phase 8")

    # Main path 5b: training at full width and depth, then under the
    # one-card mesh (counts held inside).
    train_counts, train_runs = train_path()
    mesh_counts = mesh_phase(train_runs)
    stage("phases 8b, 10")

    # Main path 5c: training of the hybrid, encoder-decoder, MoE and MLA
    # families (counts held inside).
    row_counts = train_rows_path()
    stage("phase 8c")
    for label, counts in ({f"train {arch}": c for arch, c in
                           (train_counts | row_counts).items()}
                          | mesh_counts).items():
        for kernel, dtypes in counts.items():
            by_path.setdefault(label, {})[kernel] = sum(dtypes.values())
            for dtype, n in dtypes.items():
                by_dtype[kernel][dtype] += n

    # Phase 11: the roofline of every timed path, walked on meta.
    roofline_phase(lm_ms, train_runs, walks)
    stage("phase 11")

    # Main path 6: the scenario engine over the simulator plane.
    reset_counts()
    sc_dispatches = scenario_path()
    counts = {fn.__name__[:-5]: fn.launches for fn in COUNTED}
    sc_launches = counts.pop("fcfs_scan")
    sc_flavour = dict(fcfs_scan_cuda.launches_by_flavour)
    if sc_launches == 0 or sc_launches != sc_dispatches or any(
            counts.values()):
        raise AssertionError(f"scenario path: fcfs_scan launched "
                             f"{sc_launches} times ({sc_flavour}) for "
                             f"{sc_dispatches} simulator dispatches; others "
                             f"{counts}")
    phase("launches", f"fcfs_scan: {sc_launches} launches on the scenario "
                      f"path = 1 x {sc_dispatches} simulator dispatches, by "
                      f"flavour {sc_flavour}; no other kernel")

    # Main path 6b: an episode through the live plane (counts read inside).
    live_plane_phase()
    stage("phases 9, 9b")

    # Phase 12: the multi-device half on one card: the simulator's sharded
    # grid lanes (counts read inside), then serving and training on four
    # ranks (each rank's counts set to 0 before each run, read after).
    sh_launches = sharded_lanes_phase()
    mesh12 = mesh_serving_phase()
    by_path.update(mesh12["by_path"])
    for kernel, dtypes in mesh12["by_dtype"].items():
        for dtype, n in dtypes.items():
            by_dtype[kernel][dtype] = by_dtype[kernel].get(dtype, 0) + n
    stage("phase 12")

    def launches(kernel: str) -> tuple[int, dict]:
        counts = {arch: c[kernel] for arch, c in by_path.items()
                  if c.get(kernel)}
        return sum(counts.values()), counts

    lines = [kernel_line(bag_launches, worst),
             flash_line(*launches("flash_attention"),
                        by_dtype["flash_attention"],
                        attn_worst["flash_attention"]),
             decode_line(*launches("decode_attention"),
                         by_dtype["decode_attention"],
                         attn_worst["decode_attention"]),
             ssd_line(*launches("ssd_scan"), by_dtype["ssd_scan"],
                      ssd_worst),
             fcfs_line(scan_launches + lc_launches + st_launches
                       + sc_launches + sh_launches, fcfs_lanes,
                       {"search": scan_launches, "load_change": lc_launches,
                        "stream": st_launches, "scenario": sc_launches,
                        "sharded": sh_launches},
                       by_flavour, sc_flavour)]
    for line in lines:
        phase("kernel", f"{line['name']} at its path's shape, device-only "
                        f"(CUDA graph): kernel {_ms(line['ms'])}, plain "
                        f"{_ms(line['plain_ms'])}, library "
                        f"{_ms(line['library_ms'])}, bound "
                        f"{line['bound_ms']:.6f} ms ({line['bound_by']}); "
                        f"eager: kernel {_ms(line['eager_ms'])}, plain "
                        f"{_ms(line['eager_plain_ms'])}, library "
                        f"{_ms(line['eager_library_ms'])}; design: "
                        f"{line['design']}")
    stage("kernels line")
    phase("time", f"the whole run {stages[-1][1] - started:.1f} s (host "
                  "clock) by stage: " + ", ".join(
                      f"{label} {t - t_prev:.1f} s" for (_, t_prev), (label, t)
                      in zip(stages, stages[1:])) + f"; {CARD['smi']}")
    print(json.dumps({"kernels": lines}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
