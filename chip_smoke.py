#!/usr/bin/env python3
"""Drive the PyTorch port of DeltaGrad on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and
nvcc.  The first run builds the kernels from ``src/repro_torch/csrc`` into
``src/repro_torch/_build``.  Phases:

  1. environment: the card, its power limit, versions, the kernels' build
     (flash_attention.cu's own nvcc seconds), and the tensor-core MMA
     instructions in the bf16 flash instances' SASS (cuobjdump): HGMMA in
     each wgmma instance, which must spill nothing (ptxas), HMMA in each
     of the mma.sync yardstick's;
  2. each CUDA kernel against its plain PyTorch version on the card, in f32
     and bf16, at the main path's shapes and a ragged one; the dequant
     kernels with q int8 and bf16, with and without a keyframe base; the
     update kernels also in the estimate form the online request calls;
     the wgmma flash instance bitwise the mma.sync yardstick at every bf16
     flash shape;
  3. each kernel's time on the card beside its bound, its plain version's
     and the matching PyTorch library call's; flash also beside the
     yardstick, in turns, at the LM's and Whisper's shapes (at most 0.65x
     its time at the LM's, less at Whisper's); the five p-length kernels
     also at the LM's p, cold;
  4. the main path (train -> BaseL -> DeltaGrad replay) on the paper MLP
     at full width (p = 238,510), n = 60,000, T = 40, r = 60, with the
     kernels' launch counts of that run, and the add-mode replay;
  5. the streamed path: the same training recorded to the host tier under
     every codec (and to the disk tier under delta_int8), each replayed
     from streamed windows in kernel and fetch mode at window 12 and at
     the auto window: the f32 replay bitwise the resident one, kernel mode
     bitwise fetch mode, the dequant kernels' launches;
  6. determinism: every repeated replay gives bitwise the same
     parameters; the spread of BaseL's and the replay's times;
  7. parity: the card's replay against the port's CPU run at a small size;
  8. a profile of the resident and of a streamed replay: the device's busy
     share, launches, top ops;
  9. the LM path: InternLM2-1.8B at full width, depth cut to 2 layers
     (p = 504,899,584), with the flash kernel on every forward pass:
     flash against blockwise attention at the model level, then train ->
     BaseL -> replay from a host-tier f32 history streamed in windows of 2
     steps, and a host-tier delta_int8 history replayed in kernel mode
     against fetch mode (the f32 path under the plain blockwise attention
     runs only under ``--lm-blockwise``, below); launch
     counts, memory, times, and a profile of one LM replay; then the
     p-length kernels ranked by launches x (ms - bound_ms) on the LM's
     main path.  Phase 2 holds the flash kernel against its plain
     version, phase 3 times it, phase 7 holds the LM replay on the card
     against the port's CPU run at a reduced size.  The recipe is the
     reference's (j0 = 6); each B v's ||Bv||/||v|| is printed;
 10. logistic regression at the rcv1.binary shape (n 20,242, d 47,236,
     3.8 GB of f32 features on the card) on the paper's recipe: delete,
     heavy-ball delete and add replays against BaseL and against the
     port's CPU run of the same replay, with the launches of fused_update,
     multidot and rank_update in each;
 11. Algorithm 3: delete, add and heavy-ball (lr 0.1) delete streams of 8
     requests at n 8000, d 4000, each against the port's CPU run of the
     same stream and against BaseL, with per-request times and launches;
     then a host-tier delta_int8 stream, kernel mode against fetch mode;
 12. the session surface (`UnlearnerSession`): at the rcv1.binary width, a
     coalesced delete burst (held to Algorithm 1's replay of the same
     rows), a serial stream of deletes and adds, each against the port's
     CPU run of the same session, the certificates and two publishes from
     one generator state, retrain_oracle bitwise BaseL and one
     descent_to_delete group; at quickstart's size, a snapshot restored
     mid-stream bitwise the uninterrupted session for each algorithm, and
     a host-tier delta_int8 session in kernel against fetch mode; then
     `from_config` on InternLM2 (2 layers, d_head 64) with flash, its
     counters against the CPU run's;
 13. the serving tier (`repro_torch.serve`): the ``unlearn`` entry point
     in-process at the rcv1.binary shape, 12 open-loop Poisson requests of
     mixed SLA classes at twice phase 12's serial rate with the span
     tracer on (per-class latency, deadline misses, batch sizes, the
     replay.scan measured/predicted ratio, the replay kernels' launches);
     one fixed trace through the scheduler under a virtual clock on the
     card and the CPU (same batches, counters and monitor summary); a
     snapshot before a threaded open-loop run re-serving its batches
     bitwise (quickstart's size); a host delta_int8 history through the
     scheduler, kernel decode bitwise fetch decode;
 14. the LM's decode path and the train CLI: `decode_main` in-process on
     InternLM2-1.8B at full width and all 24 layers (tokens/s, ms per
     decode step, memory; `prefill_fn` under flash, with its launches,
     and under blockwise against the stepped decode; a profile of the
     decode steps), qwen3-32b at its published widths and 2 of its 64
     layers, the card's decode against the port's CPU decode, the train
     CLI at 2 layers resumed from step 4 and held bitwise to the
     uninterrupted run, and its paper mode;
 15. the MoE family at its published widths: `decode_main` on
     qwen2-moe-a2.7b (4 of 24 layers) and moonshot-v1-16b-a3b (2 of 48),
     with `prefill_fn`'s flash launches (its gap to the stepped decode
     recorded: the two route under different capacities by the
     reference's design) and `prefill_fn` under flash against blockwise
     on the rows whose last token routes alike; the card against the
     port's CPU run (the reduced qwen2-moe in f32, one full-width
     `moe_apply` in bf16); the objective's gradient bitwise equal across
     two evaluations; train -> BaseL -> replay on qwen2-moe at 1 layer (p
     = 1,192,886,272) from a host f32 history, with the replay kernels'
     and flash's launches, and those three kernels against their plain
     versions at that p; and the train CLI at that cut, its step-0 loss
     split into cross-entropy and the router's aux term;
 16. multi-head latent attention, minicpm3-4b at its published widths:
     `decode_main` at 31 of 62 layers (tokens/s, ms per step, launches and
     busy share, memory, the latent cache's bytes), `prefill_fn` (the
     expanded form, no flash launch under flash) against the stepped
     absorbed decode, the card against the port's CPU run (full width at 2
     layers in bf16, the reduced model in f32), train -> BaseL -> replay on
     phase 9's recipe and main path at 2 of 62 layers (p = 501,406,208) and
     T 8, j0 4 (`LM_TIME_CUT`), the replay under the profiler, its
     d_ui/d_us against 1 (recorded in bf16, where both packages' replays
     fall either side of 1 by the draw), with the replay kernels' launches
     and those kernels against their plain versions at that p, and the
     train CLI at that cut resumed from step 4, held bitwise;
 17. the Mamba2 hybrid, zamba2-7b at its published widths: `decode_main` at
     7 of 13 units (42 layers; tokens/s, ms per step against the step's
     byte bound, launches and busy share, memory, the SSM, conv and KV
     states' bytes), `prefill_fn` (chunked SSD and the shared block's
     windowed blockwise attention, no flash launch) against the stepped
     decode in bf16 and, on 32 tokens, in f32, `torch.cumsum` on the card
     bitwise the SSD's sequential f32 sum, the card against the port's CPU
     run (full width at 6 layers in bf16, the reduced hybrid in f32), train
     -> BaseL -> replay on phase 9's recipe and main path at 1 of 13 units
     (p = 824,797,968) cut to T 8 and j0 4 (`LM_TIME_CUT`; host memory
     alone would allow T 10) and by the card's to windows of one step with
     per-block remat, the replay under the profiler, its d_ui/d_us recorded
     in bf16 (both packages' replays fall either side of 1 by the draw),
     with the replay kernels' launches and those kernels against their
     plain versions at that p, and the train CLI at that cut resumed from
     step 4, held bitwise;
 18. xLSTM, xlstm-350m at its published widths: `decode_main` at all 24
     layers (tokens/s, ms per step against the step's byte bound, launches
     and busy share, memory, the mLSTM's and sLSTM's state bytes),
     `prefill_fn` (the chunked mLSTM and the sLSTM's loop, no flash launch)
     against the stepped decode in bf16 and f32, the card against the
     port's CPU run (full width at 2 layers in bf16, and the reduced model
     in f32), train -> BaseL -> replay on phase 9's recipe and main path at
     2 of 24 layers and T 8, j0 4 (cut by the script's time: the sLSTM's
     loop is host-bound), its d_ui/d_us recorded (both packages' replays
     miss on the CPU), with the replay kernels' launches and those kernels
     against their plain versions at that p, the reduced model's f32 replay
     on the card against the port's CPU run (counters, parameters and
     d_ui/d_us), and the train CLI at that cut resumed from step 2, held
     bitwise;
 19. the encoder-decoder family, whisper-large-v3 at its published widths:
     32 encoder and 16 of the 32 decoder layers (cut by the script's time)
     encode 1500 frames once, fill the cross caches and decode 128 + 64
     tokens through `generate` (tokens/s, ms per step
     against the step's byte bound, launches and busy share, memory, the
     cross caches' bytes), `prefill_fn` (one flash launch per decoder
     layer under flash) against the stepped decode in bf16 and f32,
     `decode_main`'s audio branch (64 zero cross K/V slots, as the
     reference's CLI), the card against the port's CPU run (full width at
     1 + 1 layers in bf16, the reduced model in f32), train -> BaseL ->
     replay on phase 9's recipe and main path at 2 + 2 layers (rows of
     1500 frames and 448 tokens, per-block remat, flash on the decoder's
     self-attention), its d_ui/d_us against 1, with the replay kernels'
     and flash's launches and those kernels against their plain versions
     at that p, and the train CLI at that cut resumed from step 2, held
     bitwise;
 20. the port's five examples (``examples/torch/{quickstart,
     online_deletion,jackknife,unlearn_lm,serve_decode}.py``) through their
     ``main()`` on the card at their own sizes: finite numbers, every
     tensor on the card, each one's wall time against the phase's 20 s;
 21. the mesh-sharded replay on torch.distributed (ROADMAP 9g), each rank
     a spawned process on the card that loads the kernels built above and
     runs (a) and (b) in one process group, then (c) in another: (a)
     two ranks on cuda:0 over gloo, the paper MLP at phase 4's size on a
     2-rank data mesh (resident, add mode, the host f32 tier streamed,
     delta_int8 in kernel and fetch mode) against the same replays on one
     rank, with each rank's history bytes against its packed shard's, the
     per-tile update's tiles and every rank's launches; (b) the two
     ranks' online stream (delete, add, delete, delete) at phase 11's
     scale against one rank's; (c) one rank a card over NCCL, (a)'s
     resident replay.  Parameters bitwise equal across ranks.

Phase 1 also prints `roofline.analytic_cost` of every registered LM arch
under the four shape cells against the H100's peaks (arithmetic).  Each
decode (a) of phases 14-19 and each LM train CLI (14 (d), 15-19 (e))
prints a ``roofline ...`` line: `analytic_cost`'s bytes, FLOPs and bound
at that run's own batch, sequence (cache slots) and depth, beside the
phase's own byte bound and the measured ms a step.  Phase 13 prints the
``replay.scan`` spans' device time (CUDA events read at each replay's
end-of-replay sync) against their prediction, beside their host time.

Each train-CLI resume writes one checkpoint (the first one due) and reads
it: both runs are cut before their last step's write, so the CLI is timed
without that write.

Phase 2 also holds the bf16 flash kernel to the reference flash's f32 P:
its mean |err|/(1+|plain|) below a quarter of the bf16-P softmax's.

It prints one JSON line of per-kernel results, then the card's name and
power limit, and as its last line the JSON result.  It exits non-zero,
printing no result, when a phase fails or no card is present.

    python3 chip_smoke.py --moe-dg f32,6,2

runs phase 15 (d) alone at another cut (compute dtype, T, j0) and records
its replay against BaseL.

    python3 chip_smoke.py --mla-dg f32

runs phase 16 (d) alone in f32 compute (or bf16) and holds d_ui < d_us in
f32.

    python3 chip_smoke.py --hybrid

runs phase 17 alone, and

    python3 chip_smoke.py --hybrid-dg f32

phase 17 (d) alone in f32 compute (or bf16), holding d_ui < d_us in f32.

    python3 chip_smoke.py --xlstm

runs phase 18 alone, and

    python3 chip_smoke.py --xlstm-dg f32

phase 18 (d) alone in f32 compute (or bf16), recorded against d_us.

    python3 chip_smoke.py --whisper

runs phase 19 alone.

    python3 chip_smoke.py --examples

runs phase 20 alone.

    python3 chip_smoke.py --shard

runs phase 21 alone.

    python3 chip_smoke.py --lm-blockwise

runs phase 9's f32 host path again with the plain blockwise attention in
every forward pass, beside the flash run's w* and w_U (recorded: a second
12-step history of 2 GB vectors, held only to finite values).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (the kernels do f32 FMAs), dense, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # tensor cores, dense

MAIN = dict(n=60_000, steps=40, r=60, seed=0)
RESIDENT = ("fused_update", "multidot", "rank_update")  # the resident path's
STREAM_WINDOW = 12  # neither divides T = 40 nor the key interval 16
PARITY = dict(n=1200, d=20, hidden=32, classes=4, steps=24, r=12)
PARITY_TOL = 1e-5
CODECS = ("f32", "bf16", "int8", "delta_bf16", "delta_int8")
# the paper MLP's leaves in the flat order (b1, b2, w1, w2), and a ragged split
MLP_BOUNDS = (0, 300, 310, 235_510, 238_510)
RAGGED_BOUNDS = (0, 5, 50_001, 100_003)
REPEATS = 5  # timed BaseL / replay runs at full width
# the flash kernel's shapes (B, S, H, Hkv, D, causal): the reference's sweep
# (tests/test_kernels.py), the edges of the bf16 kernel's 64-row tiles
# (S = 1, 65, 127; causal S = 512 at G = 1 and 8; non-causal S = 256), the
# MoE family's (phase 15: MHA, 16 heads of 128, G = 1) in prefill_fn of
# qwen2-moe (16, 128) and moonshot (4, 32) and in the objective and the
# train step (32, 512), Whisper's decoder self-attention (phase 19: 20
# heads of 64, G = 1; 448 tokens, not whole 128-row blocks) in the
# objective (32, 448) and in prefill_fn (16, 128), and the LM's, last
FLASH_SHAPES = [(2, 128, 4, 2, 64, True), (1, 256, 8, 8, 32, True),
                (2, 100, 4, 1, 64, True), (1, 128, 2, 2, 128, False),
                (1, 64, 4, 4, 16, True), (3, 1, 4, 2, 64, True),
                (2, 65, 8, 2, 128, True), (1, 127, 4, 4, 32, False),
                (1, 512, 4, 4, 64, True), (2, 512, 8, 1, 128, True),
                (2, 256, 4, 2, 64, False), (16, 128, 16, 16, 128, True),
                (4, 32, 16, 16, 128, True), (32, 512, 16, 16, 128, True),
                (32, 448, 20, 20, 64, True), (16, 128, 20, 20, 64, True),
                (32, 512, 16, 8, 128, True)]
WHISPER_FLASH = (32, 448, 20, 20, 64)  # phase 3's second flash reading
FLASH_TOL = {"f32": 2e-5, "bf16": 3e-2}  # the outer, elementwise bar
# phase 2 holds the wgmma instance (every bf16 call) bitwise equal to the
# mma.sync instance kept as its yardstick: one wgmma gives bitwise the sums
# of the matching mma.sync calls (PERF.md section 6, the probe), and
# the two do the same arithmetic operation for operation.  Phase 3's bars
# on the wgmma instance against the yardstick, in one run: at most this
# share of its time at the LM's shape, and faster at Whisper's
FLASH_LM_SHARE = 0.65
# the LM phase: InternLM2-1.8B at its published widths, 2 of its 24 layers
LM = dict(layers=2, docs=128, seq=512, batch=32, steps=12, lr=0.01, seed=5,
          window=2, loss_chunk=128, n_params=504_899_584)
# the reference's LM recipe (benchmarks/bench_lm.py:59-61): lr 0.01, T0 = 4,
# j0 = 6, m = 2, the guard; explicit at t <= 6 and t = 10, approx at 7, 8, 9
# and 11
LM_DG = dict(period=4, burn_in=6, history_size=2, guard=True,
             curvature_eps=1e-8, stream_window=2)
# phase 10: logistic regression at the LIBSVM rcv1.binary training shape
# (paper §4.1), paper_logreg's recipe, B and T of benchmarks/common.py:43
LOGREG = dict(n=20242, d=47236, batch=4096, steps=60, r=20, seed=0)
# phase 11: Algorithm 3 at benchmarks/bench_online.py's paper scale
# (benchmarks/common.py:43 and :58), 8 requests per stream; the heavy-ball
# stream at lr 0.1, the reference's momentum test's (tests/test_online.py)
ONLINE = dict(n=8000, d=4000, batch=4096, steps=60, lr=0.3, l2=5e-3,
              period=5, burn_in=10, m=2, seed=0, requests=8, window=16,
              momentum_lr=0.1)
ONLINE_TOL = 1e-5  # card against the port's CPU run, max |gap| of w
# phase 12: the session surface.  At the rcv1.binary width (LOGREG, on
# paper_logreg's recipe): a coalesced burst of r rows, then a serial stream
# of 4 deletes and 1 add (cut from 8 and 2 by the script's time when phase
# 21 came in: each request also runs on the CPU, ~3.5 s there; the rows are
# drawn as for 8 and 2, `draws`, so the burst's rows are those of earlier
# runs); at quickstart's size (examples/quickstart.py), snapshots and the
# host tier; the tests' privacy constants (tests/test_algorithms.py:25)
SESSION = dict(stream_deletes=4, stream_adds=1, draws=(8, 2))
QUICK = dict(n=5000, d=200, steps=100, batch=1024, lr=0.3, period=5,
             burn_in=10, m=2, deleted=50, seed=0, window=12)
PRIVACY = dict(eps=1.0, delta=1e-5, mu=0.5, L=1.0, c0=0.1, c2=0.1)
NOISE_TOL = 0.02  # empirical std of the Laplace noise against b sqrt(2)
# from_config on InternLM2 at 2 layers, widths cut to d_head 64 (flash's
# set): 8 heads of 64 over d_model 512, 4 KV heads
SESSION_LM = dict(reduced=dict(n_layers=2, d_model=512, n_heads=8,
                               n_kv_heads=4, d_head=64, d_ff=1024, vocab=4096),
                  docs=64, seq=128, batch=16, steps=6, lr=0.01, seed=5,
                  rows=[3, 17, 40, 61])
# phase 13: the serving tier.  (a) the entry point at the rcv1.binary shape
# on phase 10's recipe: 12 Poisson requests of mixed SLA classes, a burst of
# 8; (b) a fixed trace of 6 requests (cut from 10 by the script's time when
# phase 21 came in: the trace also runs on the CPU, ~2.7 s a request there),
# 2 tenants, add_frac 0.25, inline under a virtual clock, and an open-loop
# threaded run at quickstart's size; (c) the fixed trace's deletes on a host
# delta_int8 history
SERVE = dict(requests=12, burst=8, fixed_events=6, interval_s=0.02,
             threaded_events=16, quick_rate=100.0,
             classes={"interactive": 0.5, "batch": 0.3, "bulk_gdpr": 0.2})
# the sections the reference CLI writes (src/repro/launch/serve.py:252-383)
SERVE_SECTIONS = ("config", "compile_s", "latency_ms", "accuracy",
                  "certificate", "published_accuracy", "coalesce", "serving")
# phase 14: the LM's decode path and the train CLI.  (a) `decode_main` on
# InternLM2-1.8B at full width and all 24 layers (p = 1,889,110,016; 7.56
# GB of f32 master weights, cast once to a 3.78 GB bf16 copy), greedy;
# (b) qwen3-32b (QK-norm) at its published widths, 2 of its 64 layers (the
# one cut; p = 2,531,026,432); (c) card against CPU at InternLM2's full
# width, 2 layers; (d) the train CLI's LM mode at phase 9's cut (2 of 24
# layers), resumed from step 4; (e) its paper mode at its defaults
DECODE = dict(batch=16, prompt=128, gen=64, n_params=1_889_110_016)
QWEN = dict(layers=2, batch=4, prompt=32, gen=16, n_params=2_531_026_432)
DECODE_PARITY = dict(layers=2, batch=2, prompt=8, gen=8)
TRAIN = dict(batch=8, seq=512, steps=8, every=4)
# prefill against the stepped decode of the same prompt, two bf16 programs
# that round at different places: |gap| of the logits, max and mean (the
# JAX package's own pair reads 0.080 / 0.015 at 24 layers on the CPU)
PREFILL_TOL = dict(max=0.25, mean=0.03)
# the card's decode against the port's CPU decode, same bf16 weights
DECODE_CPU_TOL = dict(max=0.1, mean=0.01)
# phase 15: the MoE family at its published widths.  (a) `decode_main` on
# qwen2-moe-a2.7b, 4 of its 24 layers (the one cut; p = 2,904,549,376: 11.6
# GB f32 cast once to 5.81 GB bf16; 24 layers are 57.3 GB of f32 and do not
# fit beside the init's copies); (b) moonshot-v1-16b-a3b, 2 of its 48 layers
# (p = 1,846,818,816); (c) card against CPU: the reduced qwen2-moe in f32,
# one full-width MoE layer's `moe_apply` in bf16, and (recorded) the model
# at 1 layer in bf16; (d) DeltaGrad on qwen2-moe, 1 of 24 layers (p =
# 1,192,886,272, 4.77 GB a vector) on phase 9's recipe but for two cuts: T
# with j0 (the host f32 history is T x 2 vectors, and the host has 96 GiB)
# and the stream window (1 step: the card holds two windows, the L-BFGS
# pairs and the step's gradients); at this cut the guard rejects every
# approx step, so the replay is held to BaseL bitwise (`moe_deltagrad`);
# (e) the train CLI at (d)'s cut
MOE_DECODE = dict(layers=4, batch=16, prompt=128, gen=64, n_params=2_904_549_376)
MOONSHOT = dict(layers=2, batch=4, prompt=32, gen=16, n_params=1_846_818_816)
MOE_PARITY = dict(batch=2, prompt=8, gen=8, x=(2, 64, 2048), tol=1e-4)
MOE_LM = dict(layers=1, n_params=1_192_886_272, steps=6, burn_in=2, window=1)
MOE_TRAIN = dict(batch=8, seq=512, steps=4)
# phase 16: multi-head latent attention, minicpm3-4b at its published widths
# (40 heads, qk 64 + 32, v 64, ranks 768 / 256).  (a) `decode_main` at 8 of
# its 62 layers (p = 877,455,872: 3.51 GB f32 cast once to 1.75 GB bf16; cut
# by the script's time: to 31 layers when phase 18 came in, to 8 when phase
# 19 did; all 62, p = 4,261,902,848, and 31 decoded in the runs that PERF.md
# section 5 cites) on phase 14 (a)'s shape; (b) `prefill_fn` (the expanded form) against the stepped
# absorbed decode; (c) card against CPU at full width and 2 layers (bf16), and
# the reduced model in f32; (d) DeltaGrad on phase 9's recipe and main path at
# 2 of 62 layers (the one cut; p = 501,406,208); (e) the train CLI at (d)'s cut
MLA_DECODE = dict(layers=8, batch=16, prompt=128, gen=64, n_params=877_455_872)
MLA_LM = dict(n_params=501_406_208)
# phases 16-18 (d) in the default run: T 8 and j0 4 (approx steps at 5, 6
# and 7 with T0 4), cut by the script's 1,200 s when phase 21 came in (the
# whole script took 1,035-1,098 s at phase 9's T 12 and j0 6, and the
# hybrid's T 10); their bf16 d_ui/d_us is recorded, not held.  The opt-in
# `--mla-dg`, `--hybrid-dg` and `--xlstm-dg` runs keep their recipes
LM_TIME_CUT = dict(steps=8, burn_in=4)
# in bf16 compute the replay's d_ui/d_us on this recipe falls either side of
# 1 by the draw, in both packages: the bf16 gradient's rounding enters the
# L-BFGS pairs (PERF.md section 7; `python tests/test_torch_mla.py
# 256,128,bf16,8` prints both packages over 8 draws on the CPU)
MLA_BF16_MISS = "PERF.md section 7, ROADMAP queue 3"
# phase 17: the Mamba2 hybrid, zamba2-7b at its published widths (d_model
# 3584, 13 units of five Mamba2 blocks and one shared attention block, 32
# heads of 112 attending in a 4096 window, SSM d_state 64, head_dim 64, chunk
# 128).  (a) `decode_main` at 2 of the 13 units, 12 of 78 layers (p =
# 1,214,688,288: 4.86 GB f32 cast once to 2.43 GB bf16; cut by the script's
# time: to 7 units when phase 18 came in, to 2 when phase 19 did; all 78, p =
# 5,503,481,808, and 42 decoded in the runs that PERF.md section 5 cites) on
# phase 14 (a)'s shape; (b) `prefill_fn`
# (chunked SSD, windowed blockwise attention) against the stepped decode;
# (c) card against CPU at full width and 6 layers (bf16), and the reduced
# hybrid in f32; (d) DeltaGrad on phase 9's recipe and main path at 1 of 13
# units (6 blocks, p = 824,797,968), cut by host memory: a step's f32 history
# is 6.6 GB, so T 10 and j0 4 (phase 9's T 12 would hold 79 GB of the 96 GiB
# host; j0 4 keeps four approx steps at T0 4); (e) the train CLI at (d)'s cut
HYBRID_DECODE = dict(layers=12, batch=16, prompt=128, gen=64, n_params=1_214_688_288)
# the card holds the replay only with the objective checkpointing each
# block's activations (`remat`: a Mamba2 block's chunked SSD keeps ~6-7 GB
# of f32 intermediates for the backward pass at B 32, S 512) and windows of
# one step (at 2, the staged windows took 26.4 GB and the replay 78.4 GB of
# the 80 GB card; the pairs are 4 vectors of 3.3 GB and their stacked copy)
HYBRID_LM = dict(layers=6, n_params=824_797_968, steps=10, burn_in=4, window=1,
                 remat=True)
# the reduced hybrid's f32 decode, card against CPU: its KV caches are bf16,
# and a k or v value near a bf16 tie rounds the other way on the other
# device, which moves the logits by up to ~3e-4 (the port against the JAX
# package on the CPU, tests/test_torch_mamba2.py); with f32 caches the two
# packages part by 4e-6
HYBRID_F32_TOL = 1e-3
# `prefill_fn` against the stepped decode.  In bf16 the hybrid's two forms
# round differently by the reference's design (prefill: the causal conv and
# SiLU in bf16; decode: the conv window and state in f32), and the gap grows
# with depth: at 78 layers of the reduced width (d_model 64, B 4, a 128
# prompt) the JAX package's own gap is max 0.23177 / mean 0.057679 and the
# port's 0.27939 / 0.054775; in f32 compute both read 2.76e-3 / 5.9e-4, the
# bf16 KV caches (`python tests/test_torch_mamba2.py prefill,78` on the CPU)
HYBRID_PREFILL_TOL = dict(max=0.5, mean=0.1)
HYBRID_PREFILL_F32 = dict(prompt=32, max=2e-2, mean=5e-3)
# 17 (d)'s d_ui < d_us, by compute dtype, against both packages on the CPU
# over 8 draws of the init and documents at d_model 128 (`python
# tests/test_torch_mamba2.py 128,128,bf16,8 128,128,f32,8`): in bf16 the
# JAX package misses in 2 draws and the port in 3, mostly different ones
# (the bf16 gradient's rounding in the pairs, as on MLA), so it is recorded;
# in f32 both miss in the same one draw, alike (140.76 / 140.61, the
# counters equal) and meet it in the other 7, and the card's draw meets it,
# so `--hybrid-dg f32` holds it there (True)
HYBRID_DG_BAR = {"bf16": "both packages miss in bf16 by the draw on the CPU, "
                         "PERF.md section 6", "f32": True}
# phase 18: xLSTM, xlstm-350m at its published widths (d_model 1024, 12 units
# of an mLSTM block (d_inner 2048, 4 heads of 512) and an sLSTM block (4 heads
# of 256, a gated MLP of 1365), vocab 50304).  (a) `decode_main` at 8 of the
# 24 layers (p = 216,368,160: 0.87 GB f32 cast once to 0.43 GB bf16; cut by
# the script's time when phase 19 came in; all 24, p = 443,057,248, decoded in
# the runs that PERF.md section 5 cites) on phase 14 (a)'s shape; (b) `prefill_fn` (the chunked mLSTM, the sLSTM's loop over
# time) against the stepped decode; (c) card against CPU at full width and 2
# layers (bf16), and the reduced model in f32; (d) DeltaGrad on phase 9's
# recipe and main path at 2 of the 24 layers (cut by time, below; the host
# would hold all 24: a step's f32 history is 3.5 GB, 42.5 GB at T 12), and the
# reduced model's f32 replay on the card against the port's CPU run; (e) the
# train CLI at (d)'s cut, 4 steps resumed from step 2 (`XLSTM_TRAIN`: a step
# takes ~1 s)
XLSTM_DECODE = dict(layers=8, batch=16, prompt=128, gen=64, n_params=216_368_160)
# (d) is cut by the script's time budget to 2 of the 24 layers (1 of 12 units,
# p = 131,359,752): the sLSTM's loop over time launches 26.9 kernels a step in
# the forward pass and 70.1 more in the backward (PERF.md section 5), so a
# gradient at B 32, S 512 is host-bound, 1.60-1.92 s at one unit with remat
# and 3.49 s at two (BaseL's 12 gradients) on the H100, 17.5 s at 24 layers,
# and the recipe takes ~36 gradients (train 12, BaseL 12, replay 12): 887 s
# at 24 layers (train_s, baseline_s and replay_s of a 24-layer run, PERF.md
# section 6), which the script's 1,200 s cannot hold beside phases 1-17 (at 4
# layers phase 18 took 199.2 s and the script 1,086 s).  The
# replay keeps phase 17's per-block remat (at 24 layers the card needs it:
# without it an sLSTM block keeps ~2.7 GB and an mLSTM block ~2 GB for the
# backward pass at B 32, S 512, 56 GB for the 24)
XLSTM_LM = dict(layers=2, n_params=131_359_752, remat=True)
XLSTM_TRAIN = dict(TRAIN, steps=4, every=2)
# `prefill_fn` against the stepped decode, against both packages' own pairs
# on the CPU at the published widths and 24 layers, B 16, a 128 prompt
# (`python tests/test_torch_xlstm_slice.py prefill,24,full,B16`).  In bf16 the
# chunked and the recurrent forms round the bf16 residual stream at different
# places, and the gap grows with depth: the JAX package's own gap is max
# 2.47247 / mean 0.301456 (the port's 1.95120 / 0.253985), and that bar is
# held; in f32 (every state f32 in both forms) JAX 3.10642e-3 / 1.98750e-4,
# the port 3.99703e-3 / 2.71702e-4: h = num / den with |den| small against
# its terms makes the two forms' f32 sums part, and the card's f32 rounding
# is another, so f32 is held at about three times the CPU's
XLSTM_PREFILL_TOL = dict(max=2.5, mean=0.31)
XLSTM_PREFILL_F32 = dict(prompt=128, max=1e-2, mean=1e-3)
# the reduced xLSTM's f32 decode, card against CPU: every state is f32, and
# the two devices' sums part by f32 rounding, which the mLSTM's first steps
# scale up (v (k.q) / max(|k.q|, exp(-i)) through the cell norm; the port
# against the JAX package on the CPU: 1.8e-5, tests/test_torch_xlstm_slice.py)
XLSTM_F32_TOL = 1e-4
# 18 (d)'s d_ui < d_us, by compute dtype, against both packages on the CPU
# over 8 draws of the init and documents at d_model 128 (`python
# tests/test_torch_xlstm_slice.py 128,128,bf16,8 128,128,f32,8`): both
# packages miss it in both dtypes in all 8 draws, so it is recorded, not
# held, and `--xlstm-dg f32` records the f32 replay; what the card's replay
# is held to is the port's CPU run of the same replay (XLSTM_REPLAY_PARITY)
XLSTM_DG_BAR = {"bf16": "both packages miss on the CPU in bf16, PERF.md section 6",
                "f32": "both packages miss on the CPU in f32, PERF.md section 6"}
# 18 (d) on the reduced model (one unit, d_model 64) in f32: the recipe of
# tests/test_torch_xlstm_slice.py's replay test, where the port's replay is
# held to the JAX package's (counters equal, parameters within 1e-5), run on
# the card and on the CPU from the same init; the card is held to the CPU's
# counters, its parameters within PARITY_TOL (|gap|/|w|) and its d_ui/d_us
# within `ratio` of the CPU's (a 1e-7 relative change of the init moves the
# parameters by 1e-7 to 5e-7 and d_ui/d_us by up to 5e-4 of itself, over 6
# draws on the CPU)
XLSTM_REPLAY_PARITY = dict(docs=32, seq=32, batch=8, steps=10, lr=0.001,
                           removed=(3, 11, 25), period=2, burn_in=4, ratio=1e-3)
# phase 19: the encoder-decoder family, whisper-large-v3 at its published
# widths (d_model 1280, 20 heads of 64, d_ff 5120, GELU, vocab 51866, 32
# encoder + 32 decoder layers; the conv frontend a stub of precomputed
# frames).  (a) all 32 encoder layers and 16 of the 32 decoder layers (p =
# 1,181,498,880: 4.73 GB f32 cast once to 2.36 GB bf16; the decoder cut by
# the script's time: all 32 + 32, p = 1,600,990,720, decoded in the runs
# that PERF.md section 5 cites), 1500 frames N(0, 1) encoded once and the
# cross caches filled (16 layers x B 16 x 1500 x 20 x 64 x bf16, K and V),
# then phase 14 (a)'s 128 + 64 greedy tokens; (b) `prefill_fn` against the stepped decode
# in bf16 and f32; (c) card against CPU at full width and 1 + 1 layers
# (bf16), and the reduced model in f32; (d) DeltaGrad on phase 9's recipe and
# main path at 2 + 2 of the 32 + 32 layers (p = 224,542,720), rows of 1500
# frames (Whisper's post-conv count for 30 s) and 448 tokens (its text
# context), with per-block remat (the encoder's blockwise scores at B 32 are
# ~2 GB a KV block in f32), so each gradient runs the decoder's flash twice,
# forward and recompute; (e) the train CLI at (d)'s cut, 4 steps of 448
# tokens (and 448 frames) resumed from step 2
WHISPER_DECODE = dict(layers=16, batch=16, frames=1500, prompt=128, gen=64,
                      n_params=1_181_498_880, cross_bytes=1_966_080_000)
WHISPER_LM = dict(layers=2, n_params=224_542_720, frames=1500, seq=448, remat=True,
                  flash_per_forward=4)
WHISPER_TRAIN = dict(batch=8, seq=448, steps=4, every=2)
WHISPER_PARITY_FRAMES = 1500
# the reduced model's f32 decode, card against CPU: its self and cross
# caches are bf16, and a value near a bf16 tie rounds the other way on the
# other device.  On the CPU alone, the port's init (seeds 0-3) scaled by 1 +
# 1.2e-7 N(0, 1), f32 rounding's size, moves these logits by 9.9e-05 to
# 2.497e-03 (seed 0, the card's draw: 1.04e-03 to 1.06e-03); the port against
# the JAX package, same weights: 5.1e-04 to 5.2e-04.  Held at twice the worst
WHISPER_F32_TOL = 5e-3
# `prefill_fn` against the stepped decode of the same frames and prompt,
# against both packages' own pairs on the CPU at the published widths, B 16,
# 1500 frames and a 128 prompt (`python tests/test_torch_encdec_slice.py
# prefill,2,B16 prefill,8,B16`): in bf16 JAX max / mean 3.13171e-2 /
# 4.67466e-3 at 2 + 2 layers and 3.78170e-2 / 6.10841e-3 at 8 + 8 (the port
# within 2 % of each), growing ~1.25x for 4x the depth, so ~4.7e-2 / 7.6e-3
# at 32 + 32 (the card read 5.86e-2 / 9.49e-3 there under flash, PERF.md
# section 6), held at about twice that; in f32 (both caches bf16, the
# reference's design) JAX 4.13096e-3 / 6.46049e-4 at 2 + 2 and 1.96576e-3 /
# 3.23451e-4 at 8 + 8; on the first 32 tokens (the f32 check's, cut by time)
# JAX 6.90114e-3 / 1.00193e-3 at 2 + 2 (the port 6.91736e-3 / 1.00267e-3),
# the gap shrinking with depth: held at 1e-2 / 1.5e-3
WHISPER_PREFILL_TOL = dict(max=0.1, mean=0.015)
WHISPER_PREFILL_F32 = dict(prompt=32, max=1e-2, mean=1.5e-3)
# 19 (d)'s d_ui < d_us against both packages on the CPU over 8 draws of the
# init, frames and documents at d_model 128, 64 frames, 32 tokens (`python
# tests/test_torch_encdec_slice.py 128,64,32,bf16,8 128,64,32,f32,8`): in
# bf16, the compute dtype of (d), both meet it in all 8 draws (JAX
# 0.041-0.177, the port 0.043-0.703), so it is held; in f32 both meet it in
# 7 draws and diverge alike in one (63.307 / 63.309, the counters equal)
WHISPER_DG_BAR = {"bf16": True, "f32": "both packages miss alike in 1 of 8 f32 "
                                      "draws on the CPU, PERF.md section 6"}
# phase 20: the port's five examples (examples/torch/*.py) through their
# main() on the card at their own sizes, the phase's budget in seconds
EXAMPLES = ("quickstart", "online_deletion", "jackknife", "unlearn_lm",
            "serve_decode")
EXAMPLES_BUDGET_S = 20.0
# phase 21: the mesh-sharded replay (ROADMAP 9g) on torch.distributed, every
# rank on the card.  (a) two ranks on cuda:0 over gloo (NCCL refuses two
# ranks on one device; gloo's all_reduce, all_gather and broadcast take CUDA
# tensors) at phase 4's MAIN: the resident replay, `SHARD["add"]` rows in add
# mode, the host f32 tier streamed in windows of STREAM_WINDOW, and
# delta_int8 in kernel and fetch mode, each on a 1-D data mesh of the two
# ranks, against the same replay on one rank on the card; (b) the two ranks'
# online stream (delete, add, delete, delete) at phase 11's scale; (c) one
# rank per card over NCCL: (a)'s resident replay.  The ranks start by spawn
# after the parent has built the kernels and drawn the datasets (saved for
# them), load the built libraries, and run (a), (b) and then (c) in one spawn
# (a process takes seconds to reach the card)
SHARD = dict(world=2, add=3, timeout_s=120, budget_s=45.0)
SHARD_STREAM = ("delete", "add", "delete", "delete")
# max |gap| of w, a mesh's replay (or stream) against one rank's on the card:
# ten times the largest of phase 21's first chip run on the H100 (2.980e-08
# resident, online and NCCL, 1.490e-08 add; PERF.md section 6): the mesh sums
# each gradient per rank, then across, in another order than one rank
SHARD_TOL = 3e-7
# the reduced LM of tests/test_lm.py, for the card-vs-CPU parity (f32)
LM_REDUCED = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab=64, d_head=8)
FAILURES: list = []
START = time.perf_counter()  # the script's start, for `mark`


def mark(what: str) -> None:
    """Say on stderr that `what` starts, with the seconds since the script
    started: a run stopped at its time limit shows where it was."""
    print(f"chip_smoke: {time.perf_counter() - START:.1f} s: {what}",
          file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print(f"FAIL: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one fn() in ms: `calls` calls captured in a CUDA graph
    and replayed, timed with CUDA events, so host launch overhead is out."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, calls: int = 200) -> float:
    """Wall time of one eager call in ms (host launch cost included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOP_PER_S):
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def run_cost(cfg, kind: str, batch: int, seq: int):
    """`roofline.analytic_cost` of `cfg` (at its own depth) for one step of
    a run's own batch and sequence (a decode's: its cache slots), with the
    parameters `count_params` gives."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import count_params
    from repro_torch.roofline import analytic_cost

    shape = ShapeConfig(name=f"{cfg.name} {kind} B{batch} S{seq}", seq_len=seq,
                        global_batch=batch, kind=kind)
    return analytic_cost(cfg, shape, n_params=count_params(cfg))


def roofline_line(smi, label: str, cfg, kind: str, batch: int, seq: int,
                  ms: float, own_ms=None, cost=None):
    """Print `run_cost`'s bytes, FLOPs and bound (the larger of the bytes
    over the HBM rate and the FLOPs over the bf16 tensor-core peak,
    `roofline.hw`) beside the phase's own bound and the measured ms a
    step; returns the cost."""
    from repro_torch.roofline import H100_SXM5_80GB as HW

    cost = cost or run_cost(cfg, kind, batch, seq)
    by_bytes = cost.bytes_global / HW.hbm_bw * 1e3
    by_flops = cost.flops_global / HW.peak_flops_bf16 * 1e3
    bound = max(by_bytes, by_flops)
    own = ("no bound of its own" if own_ms is None else
           f"its own bound {own_ms:.4f} ms ({ms / own_ms:.1f}x)")
    layers = (f"{cfg.n_encoder_layers} + {cfg.n_layers}" if cfg.n_encoder_layers
              else str(cfg.n_layers))
    print(f"roofline {label}: analytic_cost {kind} B={batch} S={seq} at "
          f"{layers} layers: {cost.bytes_global / 1e9:.4f} GB, {cost.flops_global:.4e} "
          f"FLOPs -> bound {bound:.4f} ms by "
          f"{'bytes' if by_bytes >= by_flops else 'operations'} (bytes "
          f"{by_bytes:.4f}, FLOPs {by_flops:.4f}); {own}; measured {ms:.4f} ms "
          f"a step ({ms / bound:.1f}x the analytic bound) | {smi}", flush=True)
    return cost


def roofline_table(smi) -> None:
    """`analytic_cost` of every registered LM arch at full size under the
    four shape cells, its compute and memory terms against the H100's
    peaks (`roofline.hw`): arithmetic, no card time."""
    from repro_torch.configs.registry import all_archs, all_shapes
    from repro_torch.models.registry import count_params
    from repro_torch.roofline import H100_SXM5_80GB as HW, analytic_cost

    shapes = all_shapes()
    for name, cfg in sorted(all_archs().items()):
        if cfg.family == "simple":
            continue
        n = count_params(cfg)
        cells = []
        for cell, shape in shapes.items():
            c = analytic_cost(cfg, shape, n_params=n)
            t_c = c.flops_global / HW.peak_flops_bf16 * 1e3
            t_m = c.bytes_global / HW.hbm_bw * 1e3
            cells.append(f"{cell} {c.flops_global:.4e} FLOP {c.bytes_global:.4e} B "
                         f"compute {t_c:.4f} ms memory {t_m:.4f} ms "
                         f"({'compute' if t_c >= t_m else 'memory'})")
        print(f"roofline table {name} (p={n}): " + "; ".join(cells), flush=True)
    print(f"roofline table: peaks {HW.name} bf16 {HW.peak_flops_bf16:.4g} FLOP/s, "
          f"HBM {HW.hbm_bw:.4g} B/s | {smi}", flush=True)


def tensor_core_instructions(lib: Path) -> dict:
    """{kernel symbol: {"HMMA": n, "HGMMA": n}}, its tensor-core MMA
    instructions (mma.sync's HMMA, wgmma's HGMMA) in the SASS of a built
    library, by the toolkit's cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run(
        [str(Path(CUDA_HOME or "", "bin", "cuobjdump")), "-sass", str(lib)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    return counts


def ptxas_report(log: str, instance) -> dict:
    """{instance(symbol): {"registers", "spill_stores", "spill_loads"}} from
    nvcc's -Xptxas -v log, for the entry functions `instance` names."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = instance(line)
            if fn:
                out[fn] = {}
        elif fn and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[fn]["spill_stores"], out[fn]["spill_loads"] = nums[1], nums[2]
        elif fn and "Used " in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def lm_leaf_bounds() -> tuple:
    """The flat offsets of the LM's leaves (InternLM2-1.8B at LM["layers"]
    layers) in the parameter order, from their shapes, allocating nothing."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import param_shapes
    from repro_torch.utils.tree import key_order

    shapes = param_shapes(dc.replace(get_config("internlm2-1.8b"),
                                     n_layers=LM["layers"]))
    bounds = [0]
    for key in key_order(shapes):
        bounds.append(bounds[-1] + math.prod(shapes[key]))
    return tuple(bounds)


def kernel_table() -> dict:
    """Every kernel of the port: its launch-counting wrapper, its CUDA
    source and the TPU kernel it replaces."""
    from repro_torch.kernels.dequant_update.ops import dequant_sub, dequant_update
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.fused_update.ops import update
    from repro_torch.kernels.lbfgs.ops import multidot, rank_update

    return {
        "fused_update": dict(wrapper=update, source="src/repro_torch/csrc/fused_update.cu",
                             replaces="src/repro/kernels/fused_update/kernel.py:33"),
        "multidot": dict(wrapper=multidot, source="src/repro_torch/csrc/lbfgs.cu",
                         replaces="src/repro/kernels/lbfgs/kernel.py:55"),
        "rank_update": dict(wrapper=rank_update, source="src/repro_torch/csrc/lbfgs.cu",
                            replaces="src/repro/kernels/lbfgs/kernel.py:103"),
        "dequant_update": dict(wrapper=dequant_update,
                               source="src/repro_torch/csrc/dequant_update.cu",
                               replaces="src/repro/kernels/dequant_update/kernel.py:68"),
        "dequant_sub": dict(wrapper=dequant_sub,
                            source="src/repro_torch/csrc/dequant_update.cu",
                            replaces="src/repro/kernels/dequant_update/kernel.py:90"),
        "flash_attention": dict(wrapper=attention,
                                source="src/repro_torch/csrc/flash_attention.cu",
                                replaces="src/repro/kernels/flash_attention/kernel.py:77"),
    }

def background(fn, *args, **kw):
    """fn(*args, **kw) started in a thread of its own: its future."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)  # the thread runs on to the end of fn
    return future


def timed(fn, *args, **kw):
    """(fn(*args, **kw), its wall time in s)."""
    t0 = time.perf_counter()
    return fn(*args, **kw), time.perf_counter() - t0


def mem_available_gb() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.configs.paper_mlp import CONFIG
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.synthetic import (binary_classification,
                                            multiclass_classification)
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant_update.ops import dequant_sub, dequant_update
    from repro_torch.kernels.dequant_update.ref import (dequant_ref,
                                                        dequant_sub_ref,
                                                        dequant_update_ref)
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_update.ops import update
    from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
    from repro_torch.kernels.lbfgs.ops import multidot, rank_update
    from repro_torch.kernels.lbfgs.ref import multidot_ref, rank_update_ref
    from repro_torch.models.registry import build
    from repro_torch.models.simple import mlp_accuracy, params_from_jax

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment and build ---------------------------------------------
    mark("phase 1. environment and build")
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    build_s = _build.build_all()
    print(f"build: {build_s:.2f} s for {', '.join(_build.sources())} "
          "(nvcc, sm_90a, one process per source)", flush=True)
    for name in _build.sources():
        log = _build.build_log(name).splitlines()
        regs = [int(x.split("Used ")[1].split()[0]) for x in log
                if "Used " in x and "registers" in x]
        spills = [x.strip() for x in log if "spill" in x and " 0 bytes spill stores" not in x]
        notes = [x.strip() for x in log if "registers" in x and "Used " not in x]
        print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}..{max(regs)} "
              f"registers, spills: {spills or 'none'}"
              + (f"; notes: {notes}" if notes else ""))
    # the analytic roofline of every LM arch under the four shape cells
    roofline_table(smi)
    # the bf16 flash instances must compute on the tensor cores: count the
    # MMA instructions in their SASS (the f32 instances use FMAs); the
    # wgmma instances (every bf16 call) must hold HGMMA and spill nothing,
    # the mma.sync yardstick HMMA
    def instance(symbol):
        hit = re.search(r"flash_fwd_(bf16_wgmma|bf16_mma|f32_fma)ILi(\d+)E", symbol)
        return f"{hit[1]} D={hit[2]}" if hit else None

    print(f"nvcc flash_attention.cu: {_build.NVCC_SECONDS.get('flash_attention', 0.0):.2f} s "
          "(its own process, beside the other sources')", flush=True)
    log = _build.build_log("flash_attention")
    ptxas = ptxas_report(log, instance)
    serial = [x.strip() for x in log.splitlines() if "wgmma" in x and "serializ" in x]
    sass = {instance(sym): n for sym, n in
            tensor_core_instructions(_build.library_path("flash_attention")).items()
            if instance(sym)}
    for name in sorted(sass):
        r = ptxas.get(name, {})
        print(f"sass flash_attention {name}: HMMA {sass[name]['HMMA']} HGMMA "
              f"{sass[name]['HGMMA']}; ptxas registers {r.get('registers')}, spill "
              f"stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B",
              flush=True)
    print(f"ptxas flash_attention wgmma serialization warnings: {serial or 'none'}",
          flush=True)
    wgmma = {k: v for k, v in sass.items() if k.startswith("bf16_wgmma")}
    yard = {k: v for k, v in sass.items() if k.startswith("bf16_mma")}
    if len(wgmma) != 4 or not all(v["HGMMA"] for v in wgmma.values()):
        fail(f"flash_attention: wgmma instances without HGMMA: {wgmma}")
    if len(yard) != 4 or not all(v["HMMA"] for v in yard.values()):
        fail(f"flash_attention: mma.sync instances without HMMA: {yard}")
    spilled = {k: r for k, r in ptxas.items() if k.startswith("bf16_wgmma")
               and (r.get("spill_stores") != 0 or r.get("spill_loads") != 0)}
    if spilled or len([k for k in ptxas if k.startswith("bf16_wgmma")]) != 4:
        fail(f"flash_attention: wgmma instances spill or lack a ptxas report: {spilled}")

    kernels = kernel_table()
    for k in kernels.values():
        k["max_abs_err"] = 0.0

    # phase 10's data, the rcv1.binary shape (~27 s of numpy's RNG on the
    # host), is drawn in a background thread while phases 2-9 run on the
    # card: numpy's bulk draws, its cast and the BLAS product release the GIL
    rcv1_data = background(timed, binary_classification, LOGREG["n"], LOGREG["d"],
                           seed=LOGREG["seed"])

    # -- 2. each kernel against its plain version ------------------------------
    mark("phase 2. each kernel against its plain version")
    gen = torch.Generator(device=dev).manual_seed(1234)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        dname = "f32" if dtype == torch.float32 else "bf16"
        for m, p in ((2, 238_510), (8, 238_510), (3, 100_003)):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=dev).to(dtype)

            dW, dG, v, w, g, gc = rnd(m, p), rnd(m, p), rnd(p), rnd(p), rnd(p), rnd(p)
            a = torch.randn(m, generator=gen, device=dev)
            b = torch.randn(m, generator=gen, device=dev)
            sigma = torch.rand((), generator=gen, device=dev)
            main_shape = dtype == torch.float32 and (m, p) == (2, 238_510)

            got = update(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0)
            ref = deltagrad_update_ref(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0)
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            print(f"check fused_update {dname} p={p}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} tol={tol}")
            if not rel <= tol:
                fail(f"fused_update {dname} p={p} rel_err {rel:.3e} > {tol}")
            if main_shape:
                kernels["fused_update"]["max_abs_err"] = err
            # the estimate form (the online request): the step and the estimate
            got = update(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0, with_g=True)
            ref = deltagrad_update_ref(w, g, v, gc, 0.1, 60000.0, 37.0, 1.0,
                                       with_g=True)
            rel = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item() for a, b in zip(got, ref))
            print(f"check fused_update with_g {dname} p={p}: rel_err={rel:.3e} "
                  f"tol={tol}")
            if not rel <= tol:
                fail(f"fused_update with_g {dname} p={p} rel_err {rel:.3e} > {tol}")

            sums = multidot(dW, dG, v)
            plain = multidot_ref(dW, dG, v)
            w64, g64, v64 = dW.double(), dG.double(), v.double()
            exact = (w64 @ w64.T, w64 @ g64.T, w64 @ v64, g64 @ v64)
            scale = (w64.abs() @ w64.abs().T, w64.abs() @ g64.abs().T,
                     w64.abs() @ v64.abs(), g64.abs() @ v64.abs())
            per_entry = max(((s.double() - e).abs() / c).max().item()
                            for s, e, c in zip(sums, exact, scale))
            err = max((s - q).abs().max().item() for s, q in zip(sums, plain))
            print(f"check multidot {dname} m={m} p={p}: per-entry "
                  f"|err|/sum|a*b| vs f64 = {per_entry:.3e} tol=1e-06; "
                  f"abs_err vs plain = {err:.3e}")
            if not per_entry <= 1e-6:
                fail(f"multidot {dname} m={m} p={p} per-entry {per_entry:.3e}")
            if main_shape:
                kernels["multidot"]["max_abs_err"] = err
            again = multidot(dW, dG, v)
            if not all(torch.equal(x, y) for x, y in zip(sums, again)):
                fail(f"multidot {dname} m={m} p={p} differs between two calls")

            got = rank_update(dW, dG, v, a, b, sigma)
            ref = rank_update_ref(dW, dG, v, a, b, sigma)
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            print(f"check rank_update {dname} m={m} p={p}: rel_err={rel:.3e} "
                  f"abs_err={err:.3e} tol={tol}")
            if not rel <= tol:
                fail(f"rank_update {dname} m={m} p={p} rel_err {rel:.3e} > {tol}")
            if main_shape:
                kernels["rank_update"]["max_abs_err"] = err
    torch.cuda.synchronize()

    def encoded(bounds, qdtype):
        """Random operands of the dequant kernels: w, bv, gc, base (f32),
        q (int8 with a scale per leaf, or bf16 without) and the scale."""
        p = bounds[-1]
        w, bv, gc, base = (torch.randn(p, generator=gen, device=dev) for _ in range(4))
        if qdtype == torch.int8:
            q = torch.randint(-127, 128, (p,), generator=gen, device=dev,
                              dtype=torch.int8)
            scale = torch.rand(len(bounds) - 1, generator=gen, device=dev) * 1e-2 + 1e-4
        else:
            q = (torch.randn(p, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
            scale = None
        return w, bv, gc, base, q, scale

    upd_args = (0.1, 60000.0, 37.0, 1.0)
    for bounds in (MLP_BOUNDS, RAGGED_BOUNDS):
        p = bounds[-1]
        for qdtype in (torch.int8, torch.bfloat16):
            w, bv, gc, base0, q, scale = encoded(bounds, qdtype)
            for base in (None, base0):
                what = (f"q={str(qdtype)[6:]} base={base is not None} p={p} "
                        f"leaves={len(bounds) - 1}")
                main_shape = (bounds == MLP_BOUNDS and qdtype == torch.int8
                              and base is not None)
                got = dequant_sub(w, q, scale, bounds, base)
                err = (got - dequant_sub_ref(w, q, scale, bounds, base)).abs().max().item()
                print(f"check dequant_sub {what}: abs_err vs plain = {err} (want 0)")
                if err != 0.0:
                    fail(f"dequant_sub {what} differs from its plain version by {err}")
                if main_shape:
                    kernels["dequant_sub"]["max_abs_err"] = err
                got = dequant_update(w, q, bv, gc, *upd_args, scale, bounds, base)
                ref = dequant_update_ref(w, q, bv, gc, *upd_args, scale, bounds, base)
                fused = update(w, dequant_ref(q, scale, bounds, base), bv, gc, *upd_args)
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                gap = (got - fused).abs().max().item()
                print(f"check dequant_update {what}: rel_err={rel:.3e} "
                      f"abs_err={err:.3e} tol=1e-05; vs fused_update on the "
                      f"decoded row {gap} (want 0)")
                if not rel <= 1e-5:
                    fail(f"dequant_update {what} rel_err {rel:.3e} > 1e-05")
                if gap != 0.0:
                    fail(f"dequant_update {what} differs from fused_update on "
                         f"the decoded row by {gap}")
                pair = dequant_update(w, q, bv, gc, *upd_args, scale, bounds,
                                      base, with_g=True)
                want = update(w, dequant_ref(q, scale, bounds, base), bv, gc,
                              *upd_args, with_g=True)
                ref = dequant_update_ref(w, q, bv, gc, *upd_args, scale,
                                         bounds, base, with_g=True)
                gap = max((a - b).abs().max().item() for a, b in zip(pair, want))
                rel = max(((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(pair, ref))
                print(f"check dequant_update with_g {what}: rel_err={rel:.3e} "
                      f"tol=1e-05; vs fused_update with_g on the decoded row "
                      f"{gap} (want 0)")
                if not (rel <= 1e-5 and gap == 0.0):
                    fail(f"dequant_update with_g {what}: rel_err {rel:.3e}, "
                         f"{gap} from fused_update with_g")
                if main_shape:
                    kernels["dequant_update"]["max_abs_err"] = err
    torch.cuda.synchronize()

    # flash: |kernel - plain| <= tol * (1 + |plain|), elementwise (the
    # reference sweep's allclose), and two calls bitwise equal.  In bf16 the
    # kernel must also keep the reference flash's f32 P: against the plain
    # version (f32 P) its MEAN |err|/(1+|plain|) stays below a quarter of
    # the same mean for the dense softmax with P rounded to bf16 before
    # P V.  The max cannot tell the two apart: both outputs are rounded to
    # bf16, and its one-ulp flips set the max of either; a flip's chance
    # grows with the f32 difference under it, so the mean follows that.
    def softmax_bf16_p(q, k, v, causal):  # (B, H, S, D)
        B_, H_, Sq, D_ = q.shape
        Hkv_, Sk = k.shape[1], k.shape[2]
        qg = q.reshape(B_, Hkv_, H_ // Hkv_, Sq, D_).float()
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D_)
        if causal:
            keep = (torch.arange(Sk, device=dev)[None, :]
                    <= torch.arange(Sq, device=dev)[:, None])
            sc = sc.masked_fill(~keep, float("-inf"))
        pb = torch.softmax(sc, dim=-1).to(torch.bfloat16).float()
        o = torch.einsum("bhgqk,bhkd->bhgqd", pb, v.float())
        return o.reshape(B_, H_, Sq, D_).to(q.dtype)

    for B, S, H, Hkv, D, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            tol = FLASH_TOL[dname]
            q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            got = attention(q, k, v, causal=causal)
            what = f"B={B} S={S} H={H} Hkv={Hkv} D={D} causal={causal} {dname}"
            if dtype == torch.bfloat16:
                yard = torch.empty_like(q)
                flash_kernel.flash_attention_mma(q, k, v, yard, causal)
                y_gap = (got.float() - yard.float()).abs()
                y_same = torch.equal(got, yard)
                print(f"check flash_attention wgmma against mma.sync {what}: "
                      f"bitwise={y_same} gap max={y_gap.max().item():.3e} "
                      f"mean={y_gap.mean().item():.3e}")
                if not y_same:
                    fail(f"flash_attention {what}: the wgmma instance is not bitwise "
                         "the mma.sync yardstick")
                del yard, y_gap
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ref = attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
            diff = (got.float() - ref.float()).abs()
            err = diff.max().item()
            rel = diff / (1 + ref.float().abs())
            worst, mean = rel.max().item(), rel.mean().item()
            same = torch.equal(got, attention(q, k, v, causal=causal))
            p_gap = ""
            if dtype == torch.bfloat16:
                bp = softmax_bf16_p(qt, kt, vt, causal).transpose(1, 2).float()
                g_rel = (bp - ref.float()).abs() / (1 + ref.float().abs())
                g_max, g_mean = g_rel.max().item(), g_rel.mean().item()
                p_gap = (f" bf16-P gap: max={g_max:.3e} mean={g_mean:.3e}; "
                         f"kernel mean={mean:.3e} (bar: <= gap mean / 4 = "
                         f"{g_mean / 4:.3e})")
                if not mean <= g_mean / 4:
                    fail(f"flash_attention {what}: mean |err|/(1+|plain|) "
                         f"{mean:.3e} not below a quarter of the bf16-P gap "
                         f"{g_mean:.3e}")
                del bp, g_rel
            print(f"check flash_attention {what}: abs_err={err:.3e} "
                  f"max|err|/(1+|plain|)={worst:.3e} tol={tol} "
                  f"repeat_bitwise={same}{p_gap}")
            if not worst <= tol:
                fail(f"flash_attention {what}: {worst:.3e} > {tol}")
            if not same:
                fail(f"flash_attention {what}: two calls differ")
            if (B, S, H, Hkv, D, causal) == FLASH_SHAPES[-1] and dtype == torch.bfloat16:
                kernels["flash_attention"]["max_abs_err"] = err
                flash_p = dict(mean=mean, max=worst, gap_mean=g_mean, gap_max=g_max)
            del q, k, v, got, ref, diff, rel
    torch.cuda.synchronize()

    # -- 3. time each kernel at the main path's shape (m = 2, f32) ----------------
    mark("phase 3. time each kernel at the main path's shape (m = 2, f32)")
    def replay_cases(p, bounds):
        """The five p-length kernels' calls at m = 2, f32 (the dequant pair
        on int8 codes with a scale per leaf over `bounds` and an f32
        keyframe: the streamed main path's delta_int8 case), with their plain
        versions, library calls, bytes and operations.  dW, dG and v are
        rows of one (2m + 1, p) buffer, which the library calls read in
        place.  No single PyTorch call computes fused_update or the dequant
        pair (per-leaf scales, a base)."""
        m, es, L = 2, 4, len(bounds) - 1
        Y = torch.randn(2 * m + 1, p, generator=gen, device=dev)
        X, dW, dG, v = Y[:2 * m], Y[:m], Y[m:2 * m], Y[2 * m]
        w, g, gc, base = (torch.randn(p, generator=gen, device=dev) for _ in range(4))
        a, b = torch.randn(m, device=dev), torch.randn(m, device=dev)
        coef = torch.cat([a, b])
        sigma = torch.tensor(0.5, device=dev)
        q8 = torch.randint(-127, 128, (p,), generator=gen, device=dev, dtype=torch.int8)
        s8 = torch.rand(L, generator=gen, device=dev) * 1e-2 + 1e-4
        n_terms = m * (m + 1) // 2 + m * m + 2 * m
        table = 4 * L + 8 * (L + 1)  # the scale row and the leaf bounds
        dense, coded = f"m={m} p={p} f32", f"p={p} q=int8 {L} leaves base=f32"
        cases = {
            "fused_update": dict(
                fn=lambda: update(w, g, v, gc, *upd_args),
                plain=lambda: deltagrad_update_ref(w, g, v, gc, *upd_args),
                library=None, shape=dense, nbytes=5 * p * es, flops=7 * p),
            "multidot": dict(
                fn=lambda: multidot(dW, dG, v),
                plain=lambda: multidot_ref(dW, dG, v),
                library=lambda: torch.mm(X, Y.T), shape=dense,
                nbytes=(2 * m + 1) * p * es + (2 * m * m + 2 * m) * 4,
                flops=2 * n_terms * p),
            "rank_update": dict(
                fn=lambda: rank_update(dW, dG, v, a, b, sigma),
                plain=lambda: rank_update_ref(dW, dG, v, a, b, sigma),
                library=lambda: torch.addmv(v, X.T, coef, beta=0.5, alpha=-1.0),
                shape=dense,
                nbytes=(2 * m + 1) * p * es + (2 * m + 1) * 4 + p * es,
                flops=(4 * m + 1) * p),
            "dequant_update": dict(
                fn=lambda: dequant_update(w, q8, v, gc, *upd_args, s8, bounds, base),
                plain=lambda: dequant_update_ref(w, q8, v, gc, *upd_args, s8,
                                                 bounds, base),
                library=None, shape=coded,
                nbytes=(4 + 1 + 4 + 4 + 4 + 4) * p + table, flops=9 * p),
            "dequant_sub": dict(
                fn=lambda: dequant_sub(w, q8, s8, bounds, base),
                plain=lambda: dequant_sub_ref(w, q8, s8, bounds, base),
                library=None, shape=coded, nbytes=(4 + 1 + 4 + 4) * p + table,
                flops=3 * p),
        }
        return cases, dict(w=w, q8=q8, s8=s8)

    timing, held = replay_cases(CONFIG.n_params, MLP_BOUNDS)
    for name, t in timing.items():
        k = kernels[name]
        k["ms"] = graph_ms(torch, t["fn"])
        k["plain_ms"] = graph_ms(torch, t["plain"])
        k["library_ms"] = graph_ms(torch, t["library"]) if t["library"] else None
        k["bound_ms"], k["bound_by"] = bound_ms(t["nbytes"], t["flops"])
        k["eager_call_ms"] = eager_ms(torch, t["fn"])
        print(f"time {name} {t['shape']} (CUDA graph, L2-warm): "
              f"kernel_ms={k['ms']:.5f} plain_ms={k['plain_ms']:.5f} "
              f"library_ms={k['library_ms']} bound_ms={k['bound_ms']:.5f} "
              f"({k['bound_by']}) eager_call_ms={k['eager_call_ms']:.5f}",
              flush=True)
    # beside the table: on one leaf without a base, dequant_sub is the one
    # call torch.add(w, q, alpha=-scale)
    p, w, q8 = CONFIG.n_params, held["w"], held["q8"]
    one = (0, p)
    s1 = held["s8"][:1].contiguous()
    sub1_ms = graph_ms(torch, lambda: dequant_sub(w, q8, s1, one))
    add1_ms = graph_ms(torch, lambda: torch.add(w, q8, alpha=-0.003))
    print(f"time dequant_sub one leaf, no base, p={p}: kernel_ms={sub1_ms:.5f} "
          f"torch.add(w, q, alpha=-s)_ms={add1_ms:.5f} bound_ms="
          f"{bound_ms(9 * p, 2 * p)[0]:.5f}", flush=True)

    # flash at the LM's shape, bf16; the bound counts the causal half of
    # both products and each operand read once, o written once
    def flash_operands(B, S, H, Hkv, D):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        return (q, k, v, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                2 * 2 * B * H * S * S * D / 2, 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D))

    # Whisper's decoder self-attention in the objective: a second reading.
    # Both flash readings time the mma.sync yardstick beside the kernel, in
    # turns (yardstick, kernel, kernel, yardstick), and print achieved
    # TFLOP/s on the causal work and on the tensor cores' (P as hi + lo:
    # 1.5x, the P V half done twice)
    def flash_pair(q, k, v):
        yard = torch.empty_like(q)
        fn = lambda: attention(q, k, v, causal=True)  # noqa: E731
        yd = lambda: flash_kernel.flash_attention_mma(q, k, v, yard, True)  # noqa: E731
        y1, k1, k2, y2 = graph_ms(torch, yd), graph_ms(torch, fn), graph_ms(torch, fn), graph_ms(torch, yd)
        return min(k1, k2), min(y1, y2), (y1, k1, k2, y2)

    q, k, v, qt, kt, vt, wf_flops, wf_bytes = flash_operands(*WHISPER_FLASH)
    wf = dict(plain_ms=graph_ms(torch, lambda: attention_ref(qt, kt, vt, causal=True)),
              library_ms=graph_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True)))
    wf["ms"], wf["yard_ms"], wf_turns = flash_pair(q, k, v)
    wf_bound = bound_ms(wf_bytes, wf_flops, PEAK_BF16_FLOP_PER_S)
    print(f"time flash_attention B={WHISPER_FLASH[0]} S={WHISPER_FLASH[1]} "
          f"H={WHISPER_FLASH[2]} Hkv={WHISPER_FLASH[3]} D={WHISPER_FLASH[4]} causal "
          f"bf16 (whisper's decoder; CUDA graph, L2-warm): kernel_ms={wf['ms']:.5f} "
          f"yardstick_ms(mma.sync)={wf['yard_ms']:.5f} (turns y/k/k/y "
          f"{'/'.join(f'{x:.5f}' for x in wf_turns)}; kernel/yardstick "
          f"{wf['ms'] / wf['yard_ms']:.3f}, bar < 1) "
          f"plain_ms={wf['plain_ms']:.5f} library_ms(sdpa)={wf['library_ms']:.5f} "
          f"bound_ms={wf_bound[0]:.5f} ({wf_bound[1]}: {wf_bytes / 1e6:.1f} MB, "
          f"{wf_flops / 1e9:.2f} GFLOP) achieved_tflops={wf_flops / wf['ms'] / 1e9:.2f} "
          f"(hi + lo {1.5 * wf_flops / wf['ms'] / 1e9:.2f}; yardstick "
          f"{wf_flops / wf['yard_ms'] / 1e9:.2f}) | {smi}", flush=True)
    if not wf["ms"] < wf["yard_ms"]:
        fail(f"flash_attention at Whisper's shape: {wf['ms']:.5f} ms, not faster than "
             f"the mma.sync yardstick's {wf['yard_ms']:.5f}")
    B, S, H, Hkv, D, _ = FLASH_SHAPES[-1]
    q, k, v, qt, kt, vt, fa_flops, fa_bytes = flash_operands(B, S, H, Hkv, D)
    k_fa = kernels["flash_attention"]
    k_fa["ms"], k_fa["yard_ms"], fa_turns = flash_pair(q, k, v)
    k_fa["plain_ms"] = graph_ms(torch, lambda: attention_ref(qt, kt, vt, causal=True))
    k_fa["library_ms"] = graph_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    k_fa["bound_ms"], k_fa["bound_by"] = bound_ms(fa_bytes, fa_flops, PEAK_BF16_FLOP_PER_S)
    k_fa["eager_call_ms"] = eager_ms(torch, lambda: attention(q, k, v, causal=True), calls=20)
    print(f"time flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} causal bf16 "
          f"(CUDA graph, L2-warm): kernel_ms={k_fa['ms']:.5f} yardstick_ms(mma.sync)="
          f"{k_fa['yard_ms']:.5f} (turns y/k/k/y {'/'.join(f'{x:.5f}' for x in fa_turns)}; "
          f"kernel/yardstick {k_fa['ms'] / k_fa['yard_ms']:.3f}, bar <= {FLASH_LM_SHARE}) "
          f"plain_ms={k_fa['plain_ms']:.5f} library_ms(sdpa)={k_fa['library_ms']:.5f} "
          f"bound_ms={k_fa['bound_ms']:.5f} ({k_fa['bound_by']}: {fa_bytes / 1e6:.1f} MB, "
          f"{fa_flops / 1e9:.2f} GFLOP; bf16 tensor-core floor "
          f"{fa_flops / PEAK_BF16_FLOP_PER_S * 1e3:.5f} ms, hi + lo "
          f"{1.5 * fa_flops / PEAK_BF16_FLOP_PER_S * 1e3:.5f} ms, f32-FMA floor "
          f"{fa_flops / PEAK_F32_FLOP_PER_S * 1e3:.5f} ms) "
          f"achieved_tflops={fa_flops / k_fa['ms'] / 1e9:.2f} (hi + lo "
          f"{1.5 * fa_flops / k_fa['ms'] / 1e9:.2f}; yardstick "
          f"{fa_flops / k_fa['yard_ms'] / 1e9:.2f}) "
          f"eager_call_ms={k_fa['eager_call_ms']:.5f}; against the f32-P plain "
          f"version mean|err|/(1+|plain|)={flash_p['mean']:.3e} "
          f"max={flash_p['max']:.3e}, bf16-P gap mean={flash_p['gap_mean']:.3e} "
          f"max={flash_p['gap_max']:.3e} | {smi}", flush=True)
    if not k_fa["ms"] <= FLASH_LM_SHARE * k_fa["yard_ms"]:
        fail(f"flash_attention at the LM's shape: {k_fa['ms']:.5f} ms, over "
             f"{FLASH_LM_SHARE} x the mma.sync yardstick's {k_fa['yard_ms']:.5f}")
    q, k, v = q.float(), k.float(), v.float()  # the f32 instance, on FMAs
    f32_ms = graph_ms(torch, lambda: attention(q, k, v, causal=True), calls=10, replays=5)
    f32_bound = bound_ms(2 * fa_bytes, fa_flops)  # f32 FMAs
    print(f"time flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} causal f32 "
          f"(CUDA graph, L2-warm): kernel_ms={f32_ms:.5f} bound_ms="
          f"{f32_bound[0]:.5f} ({f32_bound[1]}, f32 FMAs) "
          f"achieved_tflops={fa_flops / f32_ms / 1e9:.2f}", flush=True)
    del q, k, v, qt, kt, vt

    # the five p-length kernels at the LM's p, cold: each call streams 2 to
    # 10 GB through the 50 MB L2.  Their plain versions are not timed at
    # this p (each allocates several p-length temporaries); launches come
    # from phase 9
    lm_bounds = lm_leaf_bounds()
    if lm_bounds[-1] != LM["n_params"]:
        fail(f"lm leaf bounds end at {lm_bounds[-1]}, want {LM['n_params']}")
    cases, lm_held = replay_cases(lm_bounds[-1], lm_bounds)
    lm_p = {}
    for name, t in cases.items():
        r = lm_p[name] = dict(ms=graph_ms(torch, t["fn"], calls=5, replays=4))
        r["library_ms"] = (graph_ms(torch, t["library"], calls=5, replays=4)
                           if t["library"] else None)
        r["bound_ms"], r["bound_by"] = bound_ms(t["nbytes"], t["flops"])
        print(f"time {name} {t['shape']} (CUDA graph of 5 calls x 4, cold): "
              f"kernel_ms={r['ms']:.5f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) plain_ms not "
              "measured at this p", flush=True)
    del cases, lm_held, t, timing, held  # t's lambdas hold the 20 GB too
    torch.cuda.empty_cache()

    # -- 4. the main path at full width ---------------------------------------
    mark("phase 4. the main path at full width")
    obj, ds, params0, meta, cfg, removed = main_problem(torch, np, dev)
    T = MAIN["steps"]
    # warm-up, counted as set-up: cuBLAS and the solver's first calls, the
    # dataset's upload, every kernel's first launch
    warm_meta = HistoryMeta(n=ds.n, batch_size=ds.n, seed=0, steps=6,
                            lr_schedule=CONFIG.lr_schedule)
    _, warm_hist = dg.sgd_train_with_cache(obj, params0, ds, warm_meta)
    dg.baseline_retrain(obj, ds, warm_meta, params0, removed)
    dg.deltagrad_retrain(obj, warm_hist, ds, removed, dg.DeltaGradConfig(
        period=2, burn_in=1, history_size=2, guard=True, curvature_eps=1e-8))

    for k in kernels.values():
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, params0, ds, meta)
    train_s = time.perf_counter() - t0
    w_u, st_u = dg.baseline_retrain(obj, ds, meta, params0, removed)
    w_i, st = dg.deltagrad_retrain(obj, hist, ds, removed, cfg)
    launches = {n: k["wrapper"].launches for n, k in kernels.items()}
    for n in RESIDENT:
        kernels[n]["launches"] = launches[n]

    d_ui = (w_u.flat - w_i.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    print(f"full: paper-mlp p={w_i.numel} n={ds.n} T={T} r={MAIN['r']} "
          f"history {hist.nbytes() / 1e6:.1f} MB")
    print(f"full: train_s={train_s:.4f} baseline_s={st_u.wall_time_s:.4f} "
          f"replay_s={st.wall_time_s:.4f}")
    print(f"full: {' '.join(f'{k}={v}' for k, v in st.counters().items())} "
          f"theoretical_speedup={st.theoretical_speedup:.3f}")
    print(f"full: d_ui={d_ui:.4e} d_us={d_us:.4e} accuracy w*="
          f"{mlp_accuracy(w_star, ds):.4f} w_I={mlp_accuracy(w_i, ds):.4f}")
    print(f"full: launches {json.dumps(launches)}", flush=True)
    if not (w_i.flat.shape == (CONFIG.n_params,)
            and bool(torch.isfinite(w_i.flat).all())):
        fail("replay parameters are not finite of the expected shape")
    if not d_ui < 0.5 * d_us:
        fail(f"d_ui {d_ui:.3e} not below half of d_us {d_us:.3e}")
    for n, c in launches.items():
        want = st.approx_steps if n in RESIDENT else 0
        if n in RESIDENT and c <= 0:
            fail(f"{n} was not launched on the main path")
        elif st.guard_fallbacks == 0 and c != want:
            fail(f"{n}: {c} launches on the resident path, want {want}")

    n_add = MAIN["r"]
    ds_add = multiclass_classification(MAIN["n"], CONFIG.d_in, CONFIG.vocab,
                                       seed=MAIN["seed"])
    added = ds_add.append({k: c[removed] for k, c in ds_add.columns.items()})
    w_ua, _ = dg.baseline_retrain(obj, ds_add, meta, params0, added, mode="add")
    w_ia, st_a = dg.deltagrad_retrain(obj, hist, ds_add, added, cfg, mode="add")
    d_ui_a = (w_ua.flat - w_ia.flat).norm().item()
    d_us_a = (w_ua.flat - w_star.flat).norm().item()
    print(f"add: r={n_add} {' '.join(f'{k}={v}' for k, v in st_a.counters().items())} "
          f"replay_s={st_a.wall_time_s:.4f} d_ui={d_ui_a:.4e} d_us={d_us_a:.4e}")
    if not d_ui_a < 0.5 * d_us_a:
        fail(f"add: d_ui {d_ui_a:.3e} not below half of d_us {d_us_a:.3e}")

    # -- 5. the streamed path: host and disk tiers under every codec ---------
    mark("phase 5. the streamed path: host and disk tiers under every codec")
    dg.deltagrad_retrain(  # warm-up of the streamer (threads, pinned memory)
        obj, dg.sgd_train_with_cache(obj, params0, ds, warm_meta, tier="host",
                                     codec="delta_int8")[1],
        ds, removed, dg.DeltaGradConfig(period=2, burn_in=1, history_size=2,
                                        guard=True, curvature_eps=1e-8))
    resident_bytes = hist.nbytes()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    resident_s = dg.deltagrad_retrain(obj, hist, ds, removed, cfg)[1].wall_time_s
    peak = torch.cuda.max_memory_allocated() - before
    print(f"stream: resident replay_s={resident_s:.4f} resident history "
          f"{resident_bytes} B on the device max_memory_allocated_over_replay="
          f"{peak}", flush=True)
    streamed = {}
    for tier, codec in [("host", c) for c in CODECS] + [("disk", "delta_int8")]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_c, h_c = dg.sgd_train_with_cache(
            obj, params0, ds, meta, tier=tier, codec=codec,
            spill_dir="auto" if tier == "disk" else None)
        rec_s = time.perf_counter() - t0
        name = f"{tier}/{codec}"
        extra = f" disk {h_c.disk_nbytes()} B" if tier == "disk" else ""
        print(f"stream {name}: train_s={rec_s:.4f} host RAM {h_c.nbytes()} B"
              f"{extra}", flush=True)
        if not torch.equal(w_c.flat, w_star.flat):
            fail(f"{name}: recording to the {tier} tier changed the trained model")
        runs = {}
        for label, kw in ((f"kernel@{STREAM_WINDOW}",
                           dict(stream_window=STREAM_WINDOW, stream_decode="kernel")),
                          (f"fetch@{STREAM_WINDOW}",
                           dict(stream_window=STREAM_WINDOW, stream_decode="fetch")),
                          ("auto", {})):
            c = dataclasses.replace(cfg, **kw)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k["wrapper"].launches = 0
            w_s, st_s = dg.deltagrad_retrain(obj, h_c, ds, removed, c)
            n_launch = {n: k["wrapper"].launches for n, k in kernels.items()}
            peak = torch.cuda.max_memory_allocated() - before
            runs[label] = (w_s, st_s, n_launch)
            x = st_s.extra
            print(f"stream {name} {label}: replay_s={st_s.wall_time_s:.4f} "
                  f"(resident {resident_s:.4f}) decode={x['stream_decode']} "
                  f"windows={x['windows']} depth={x['prefetch_depth']} "
                  f"host_wait_s={x['host_wait_s']:.5f} "
                  f"host_stage_high={x['host_stage_high']} "
                  f"encoded_bytes_high={x['encoded_bytes_high']} "
                  f"compression_ratio={x['compression_ratio']:.4f} "
                  f"hbm_high_water={x['hbm_high_water']} "
                  f"max_memory_allocated_over_replay={peak} "
                  f"|w-w_resident|={(w_s.flat - w_i.flat).norm().item():.4e} "
                  + " ".join(f"{k}={v}" for k, v in st_s.counters().items())
                  + f" launches {json.dumps(n_launch)}", flush=True)
            if not bool(torch.isfinite(w_s.flat).all()):
                fail(f"{name} {label}: non-finite parameters")
            # about two windows on the device: below the resident history,
            # except where two windows are the whole path (f32, and the
            # auto window of 32 steps with its tail of 8 at T = 40)
            window = STREAM_WINDOW if "@" in label else min(T, 32)
            whole = codec == "f32" and 2 * window >= T
            if not (x["hbm_high_water"] <= resident_bytes if whole
                    else x["hbm_high_water"] < resident_bytes):
                fail(f"{name} {label}: hbm_high_water {x['hbm_high_water']} "
                     f"not below the resident history's {resident_bytes} B")
            kernel_mode = x["stream_decode"] == "kernel"
            want = {"fused_update": 0 if kernel_mode else st_s.approx_steps,
                    "dequant_update": st_s.approx_steps if kernel_mode else 0,
                    "dequant_sub": st_s.approx_steps if kernel_mode else 0}
            for n, v in want.items():
                if st_s.guard_fallbacks == 0 and n_launch[n] != v:
                    fail(f"{name} {label}: {n} launched {n_launch[n]} times, want {v}")
            if x["stream_decode"] != (
                    "fetch" if codec == "f32" or label.startswith("fetch") else "kernel"):
                fail(f"{name} {label}: decode mode {x['stream_decode']}")
        ref_w = runs[f"fetch@{STREAM_WINDOW}"][0]
        for label, (w_s, st_s, _) in runs.items():
            if codec == "f32" and not torch.equal(w_s.flat, w_i.flat):
                fail(f"{name} {label}: not bitwise the resident replay "
                     f"({(w_s.flat - w_i.flat).abs().max().item():.3e})")
            if not torch.equal(w_s.flat, ref_w.flat):
                fail(f"{name} {label}: not bitwise the fetch-mode replay "
                     f"({(w_s.flat - ref_w.flat).abs().max().item():.3e})")
        w_s, st_s, n_launch = runs["auto"]
        d_ui_c = (w_u.flat - w_s.flat).norm().item()
        print(f"stream {name}: d_ui={d_ui_c:.4e} d_us={d_us:.4e} "
              f"d_ui/d_us={d_ui_c / d_us:.4e}", flush=True)
        # Theorem 1's bound needs the exact cache: a lossy codec's error in
        # w_t, g_t exceeds what deleting 60 of 60,000 rows moves, and the
        # replay follows the decoded path (the JAX package does the same on
        # the same codes); lossy replays are held to parity instead (phase 7)
        if codec == "f32" and not d_ui_c < 0.5 * d_us:
            fail(f"{name}: d_ui {d_ui_c:.3e} not below half of d_us {d_us:.3e}")
        if codec == "delta_int8" and not st_s.extra["compression_ratio"] > 2:
            fail(f"{name}: compression_ratio {st_s.extra['compression_ratio']:.3f} <= 2")
        streamed[name] = (h_c, st_s, n_launch)
    # the dequant kernels' launches on the streamed main path: host tier,
    # delta_int8, kernel mode at the auto window
    for n in ("dequant_update", "dequant_sub"):
        kernels[n]["launches"] = streamed["host/delta_int8"][2][n]
        if kernels[n]["launches"] <= 0:
            fail(f"{n} was not launched on the streamed path")
    stream_hist = streamed["host/delta_int8"][0]

    # -- 6. determinism, and the spread of the end-to-end times ----------------
    mark("phase 6. determinism, and the spread of the end-to-end times")
    base_s, replay_s = [st_u.wall_time_s], [st.wall_time_s]
    worst = 0.0
    for _ in range(REPEATS - 1):  # BaseL and replay in turns
        base_s.append(dg.baseline_retrain(obj, ds, meta, params0, removed)[1]
                      .wall_time_s)
        w_i2, st2 = dg.deltagrad_retrain(obj, hist, ds, removed, cfg)
        replay_s.append(st2.wall_time_s)
        worst = max(worst, (w_i2.flat - w_i.flat).abs().max().item())
        if st2.counters() != st.counters():
            fail("a repeated replay counted differently")
    print(f"determinism: {REPEATS - 1} more replays, max |diff| to the first "
          f"= {worst}")
    if worst != 0.0:
        fail(f"repeated replays differ by {worst}")
    for name, xs in (("baseline_s", base_s), ("replay_s", replay_s)):
        print(f"repeat: {name} median={statistics.median(xs):.4f} "
              f"min={min(xs):.4f} max={max(xs):.4f} n={len(xs)} "
              f"all={[round(x, 4) for x in xs]}")

    # -- 7. parity: card against the port's CPU run --------------------------
    mark("phase 7. parity: card against the port's CPU run")
    rng = np.random.default_rng(6)
    P = PARITY
    p0 = {"w1": (rng.normal(size=(P["d"], P["hidden"])) / np.sqrt(P["d"])).astype(np.float32),
          "b1": np.zeros(P["hidden"], np.float32),
          "w2": (rng.normal(size=(P["hidden"], P["classes"])) / np.sqrt(P["hidden"])).astype(np.float32),
          "b2": np.zeros(P["classes"], np.float32)}
    # the resident path (delete, add) and streamed kernel-mode replays of
    # lossy codes: the same codes decode to the same bits on both sides
    for mode, codec in (("delete", None), ("add", None),
                        ("delete", "delta_int8"), ("delete", "bf16")):
        res = {}
        for where in ("cuda", "cpu"):
            dsp = multiclass_classification(P["n"], P["d"], P["classes"], seed=5)
            ch = np.random.default_rng(2).choice(P["n"], size=P["r"], replace=False)
            if mode == "add":
                ch = dsp.append({k: c[ch] for k, c in dsp.columns.items()})
            mp = HistoryMeta(n=P["n"], batch_size=P["n"], seed=7, steps=P["steps"],
                             lr_schedule=CONFIG.lr_schedule)
            cp = dg.DeltaGradConfig(period=2, burn_in=P["steps"] // 4,
                                    history_size=2, guard=True,
                                    curvature_eps=1e-8, stream_window=8,
                                    stream_decode="kernel")
            init = params_from_jax(p0, where)
            tier = dict(tier="host", codec=codec) if codec else {}
            _, hp = dg.sgd_train_with_cache(obj, init, dsp, mp, device=where,
                                            **tier)
            wp, sp = dg.deltagrad_retrain(obj, hp, dsp, ch, cp, mode=mode,
                                          device=where)
            res[where] = (wp.flat.cpu(), sp.counters())
        gap = (res["cuda"][0] - res["cpu"][0]).abs().max().item()
        same = res["cuda"][1] == res["cpu"][1]
        what = mode if codec is None else f"{mode} host/{codec} kernel-mode"
        print(f"parity {what}: card vs cpu params max |gap| {gap:.3e} "
              f"(tol {PARITY_TOL}); counters "
              + " ".join(f"{k}={res['cuda'][1][k]}/{res['cpu'][1][k]}"
                         for k in res["cpu"][1]))
        if not (gap <= PARITY_TOL and same):
            fail(f"parity {what}: gap {gap:.3e}, counters equal: {same}")

    # the LM (reduced widths, f32 compute, blockwise attention: the reduced
    # head dim 8 is not one of the flash kernel's): resident delete replay
    lm_small = build(get_config("internlm2-1.8b").reduced(**LM_REDUCED))
    replay_card_cpu(
        torch, np, dev, "parity lm reduced f32",
        lm_small.objective(loss_chunk=16, dtype=torch.float32),
        lm_small.init(seed=1, device="cpu"),
        token_stream(48, 16, LM_REDUCED["vocab"], seed=0),
        HistoryMeta(n=48, batch_size=16, seed=5, steps=12, lr_schedule=((0, 0.05),)),
        dg.DeltaGradConfig(period=2, burn_in=4, history_size=2, guard=True,
                           curvature_eps=1e-8),
        np.array([3, 11, 25, 40]))

    # -- 8. profile of the resident and of a streamed replay -----------------
    mark("phase 8. profile of the resident and of a streamed replay")
    profile_replay(torch, "replay", lambda: dg.deltagrad_retrain(
        obj, hist, ds, removed, cfg))
    profile_replay(torch, "streamed host/delta_int8 kernel-mode replay",
                   lambda: dg.deltagrad_retrain(obj, stream_hist, ds, removed, cfg))

    # -- 9. the LM path at full width --------------------------------------------
    mark("phase 9. the LM path at full width")
    del hist, stream_hist, streamed
    torch.cuda.empty_cache()
    lm_launches = lm_phase(torch, np, dev, kernels)

    # the p-length kernels ranked by their loss to the bound on the LM's
    # main path: launches x (ms - bound_ms)
    for name, r in lm_p.items():
        r["launches"] = lm_launches[name]
        r["loss_ms"] = r["launches"] * (r["ms"] - r["bound_ms"])
    rank = sorted(lm_p, key=lambda n: -lm_p[n]["loss_ms"])
    print(f"lm_p ranking by launches x (ms - bound_ms), p={LM['n_params']}: "
          + ", ".join(f"{n} {lm_p[n]['loss_ms']:.4f} ms" for n in rank), flush=True)
    print("lm_p " + json.dumps({"p": LM["n_params"], "kernels": [
        dict(name=n, **lm_p[n]) for n in rank]}), flush=True)

    # -- 10. logistic regression at the RCV1 shape; 11. Algorithm 3 ---------------
    mark("phase 10. logistic regression at the RCV1 shape; 11. Algorithm 3")
    gc_collect()
    rcv1 = logreg_phase(torch, np, dev, kernels, rcv1_data)
    gc_collect()
    online_phase(torch, np, dev, kernels)

    # -- 12. the session surface ------------------------------------------------------
    mark("phase 12. the session surface")
    gc_collect()
    serial_ms = session_phase(torch, np, dev, kernels, rcv1)

    # -- 13. the serving tier ----------------------------------------------------------
    mark("phase 13. the serving tier")
    gc_collect()
    serve_phase(torch, np, dev, kernels, rcv1, serial_ms)

    # -- 14. the LM's decode path and the train CLI ------------------------------------
    mark("phase 14. the LM's decode path and the train CLI")
    gc_collect()
    decode_train_phase(torch, np, dev, kernels)

    # -- 15. the MoE family -------------------------------------------------------------
    mark("phase 15. the MoE family")
    gc_collect()
    moe_phase(torch, np, dev, kernels)

    # -- 16. multi-head latent attention -------------------------------------------------
    mark("phase 16. multi-head latent attention")
    gc_collect()
    mla_phase(torch, np, dev, kernels)

    # -- 17. the Mamba2 hybrid ---------------------------------------------------------------
    mark("phase 17. the Mamba2 hybrid")
    gc_collect()
    hybrid_phase(torch, np, dev, kernels)

    # -- 18. xLSTM ------------------------------------------------------------------------------
    mark("phase 18. xLSTM")
    gc_collect()
    xlstm_phase(torch, np, dev, kernels)

    # -- 19. the encoder-decoder family ---------------------------------------------------------
    mark("phase 19. the encoder-decoder family")
    gc_collect()
    whisper_phase(torch, np, dev, kernels)

    # -- 20. the port's examples ------------------------------------------------------------
    mark("phase 20. the port's examples")
    gc_collect()
    examples_phase(torch, np, dev, kernels)

    # -- 21. the mesh-sharded replay on torch.distributed ------------------------------------
    mark("phase 21. the mesh-sharded replay on torch.distributed")
    gc_collect()
    shard_phase(torch, np, dev, kernels)

    # -- results ---------------------------------------------------------------------
    mark("results")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [dict(name=n, route="cuda",
                             **{k: v[k] for k in keys if k != "route"})
                        for n, v in kernels.items()]}
    print(json.dumps(line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _example_values(out):
    """Every tensor and number in an example's result (dicts, lists,
    FlatParams, tensors, numpy arrays, floats; other objects skipped)."""
    if isinstance(out, dict):
        return [v for x in out.values() for v in _example_values(x)]
    if isinstance(out, (list, tuple)):
        return [v for x in out for v in _example_values(x)]
    if hasattr(out, "flat") and hasattr(out, "shapes"):  # FlatParams
        return [out.flat]
    if hasattr(out, "dtype") or isinstance(out, (int, float)):
        return [out]
    return []


def examples_phase(torch, np, dev, kernels) -> None:
    """Phase 20: the port's five examples (`examples/torch/*.py`) through
    their `main()` on the card at their own sizes, with the launch counts
    zeroed just before each and read after: each must end with finite
    numbers and every tensor it returns on the card; prints each one's wall
    time (its device work synchronised inside it) beside the phase's
    budget."""
    import importlib.util

    smi = nvidia_smi()
    total = 0.0
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        def run():
            out = mod.main([])
            torch.cuda.synchronize()
            return out

        torch.cuda.synchronize()
        (out, n), wall = timed(counted_run, kernels, run)
        total += wall
        values = _example_values(out)
        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        finite = all(bool(torch.isfinite(v.float()).all()) if isinstance(v, torch.Tensor)
                     else bool(np.isfinite(np.asarray(v, dtype=np.float64)).all())
                     for v in values)
        where = sorted({v.device.type for v in tensors})
        print(f"examples {name}: wall {wall:.3f} s, {len(values)} values "
              f"({len(tensors)} tensors on {where}) finite: {finite}; launches "
              f"{json.dumps({k: v for k, v in n.items() if v})} | {smi}", flush=True)
        if not (tensors and finite and where == ["cuda"]):
            fail(f"examples {name}: finite {finite}, tensors on {where}")
        del out, values, tensors
        gc_collect()
    print(f"examples: phase wall time {total:.1f} s for {len(EXAMPLES)} examples "
          f"(budget {EXAMPLES_BUDGET_S:.0f} s{'' if total <= EXAMPLES_BUDGET_S else ', over'}) "
          f"| {smi}", flush=True)


def decode_train_phase(torch, np, dev, kernels) -> None:
    """Phase 14: the LM's batched KV-cache decode and the train CLI, through
    their entry points (`launch.serve.decode_main`, `launch.train.main`),
    each run with the launch counts zeroed just before and read after."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.launch import train
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    smi = nvidia_smi()

    # (a) InternLM2-1.8B at full width and all 24 layers
    cfg = get_config("internlm2-1.8b")
    label = f"{cfg.name} {cfg.n_layers} layers"
    res = decode_run(torch, kernels, smi, label, cfg, DECODE)
    prefill_check(torch, dev, kernels, smi, label, build(cfg), res, cfg.n_layers)
    decode_profile(torch, dev, smi, label, build(cfg), res)
    del res
    gc_collect()

    # (b) QK-norm at full width: qwen3-32b, 2 of its 64 layers
    qcfg = register(dc.replace(get_config("qwen3-32b"), name="qwen3-32b-2l",
                               n_layers=QWEN["layers"]))
    label = f"qwen3-32b {QWEN['layers']} of 64 layers"
    res = decode_run(torch, kernels, smi, label, qcfg, QWEN)
    prefill_check(torch, dev, kernels, smi, label, build(qcfg), res, qcfg.n_layers)
    del res
    gc_collect()

    # (c) the card against the port's CPU run, the same bf16 weights
    decode_cpu_parity(torch, np, dev, smi, dc.replace(cfg, n_layers=DECODE_PARITY["layers"]))

    # (d) the train CLI's LM mode at phase 9's cut, resumed from step 4
    tcfg = register(dc.replace(cfg, name="internlm2-1.8b-2l", n_layers=LM["layers"]))
    train_resume(torch, np, kernels, smi, tcfg, LM["n_params"], flash_per_step=LM["layers"])

    # (e) the train CLI's paper mode at its defaults
    out, n = counted_run(kernels, lambda: train.main(["--arch", "paper-logreg"]))
    print(f"train paper-logreg: acc={out['acc']:.4f} r={out['r']} "
          f"||w_U - w_I||={out['dist']:.6e} counters {out['stats'].counters()} "
          f"launches {json.dumps(n)} | {smi}", flush=True)
    st = out["stats"]
    if not (out["acc"] > 0.8 and np.isfinite(out["dist"]) and st.approx_steps > 0
            and (st.guard_fallbacks or n["fused_update"] == st.approx_steps)):
        fail(f"train paper-logreg: acc {out['acc']}, dist {out['dist']}, "
             f"launches {n}")
    print(f"decode/train: phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def replay_card_cpu(torch, np, dev, label, obj, init, docs, meta, dgc, removed,
                    ratio_tol=None) -> None:
    """The same resident train -> replay of `obj` from `init` (on the CPU)
    on the card and on the CPU.  Held: the counters equal, at least one
    approx step, and the card's parameters within PARITY_TOL of the CPU's
    (|gap|/|w|).  With `ratio_tol`, BaseL runs on both too and the card's
    d_ui/d_us is held within `ratio_tol` of the CPU's, relative."""
    from repro_torch.core import deltagrad as dg

    res = []
    for where in (dev, "cpu"):
        w0 = init.with_flat(init.flat.to(where, copy=True))
        w, hist = dg.sgd_train_with_cache(obj, w0, docs, meta, device=where)
        w_i, st = dg.deltagrad_retrain(obj, hist, docs, removed, dgc, device=where)
        ratio = None
        if ratio_tol is not None:
            w_u, _ = dg.baseline_retrain(obj, docs, meta, w0, removed, device=where)
            ratio = ((w_u.flat - w_i.flat).norm() / (w_u.flat - w.flat).norm()).item()
        res.append((w_i.flat.cpu(), st.counters(), ratio))
    card, cpu = res
    gap = ((card[0] - cpu[0]).norm() / cpu[0].norm()).item()
    same = card[1] == cpu[1]
    ratio_ok = ratio_tol is None or abs(card[2] - cpu[2]) <= ratio_tol * cpu[2]
    print(f"{label}: card vs cpu params |gap|/|w| {gap:.3e} (tol {PARITY_TOL}); "
          + ("" if ratio_tol is None else
             f"d_ui/d_us {card[2]:.6e} / {cpu[2]:.6e} (tol {ratio_tol} relative); ")
          + "counters " + " ".join(f"{k}={card[1][k]}/{cpu[1][k]}" for k in cpu[1]),
          flush=True)
    if not (gap <= PARITY_TOL and same and ratio_ok and cpu[1]["approx_steps"] > 0):
        fail(f"{label}: gap {gap:.3e}, counters equal: {same}, d_ui/d_us "
             f"{card[2]} against {cpu[2]}")


def decode_cpu_parity(torch, np, dev, smi, pcfg, fill=None) -> None:
    """The card's bf16 `generate` against the port's CPU run on the same
    bf16 weights of `pcfg` (full width, a few layers; an encoder-decoder's
    caches made by `fill` on each device): the logits after the
    prompt within `DECODE_CPU_TOL`, the greedy tokens equal before the
    first step whose top-2 margin (the margin of the logits that choose
    that step's token) is under the bar: from that step on, the two
    devices may order a near tie either way."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import flatten_nested, nested

    model = build(pcfg)
    params = cast_params(nested(model.init(seed=0, device=dev)), torch.bfloat16)
    params_cpu = {k: v.cpu() for k, v in flatten_nested(params).items()}
    prompt = np.random.default_rng(0).integers(
        0, pcfg.vocab, size=(DECODE_PARITY["batch"], DECODE_PARITY["prompt"]),
        dtype=np.int32)
    B, P, G = DECODE_PARITY["batch"], DECODE_PARITY["prompt"], DECODE_PARITY["gen"]
    card, cpu = (serve.generate(model, p, prompt, G, device=where, caches=None if fill is None
                                else fill(model, p, where, B, P + G, torch.bfloat16))
                 for p, where in ((params, dev), (params_cpu, "cpu")))
    gap = (card["prompt_logits"].cpu() - cpu["prompt_logits"]).abs()
    mx, mean = gap.max().item(), gap.mean().item()
    near = np.nonzero((card["margins"] < DECODE_CPU_TOL["max"]).any(axis=0))[0]
    upto = int(near[0]) if len(near) else DECODE_PARITY["gen"]
    same = np.array_equal(card["tokens"][:, :upto], cpu["tokens"][:, :upto])
    print(f"decode card vs cpu ({pcfg.name} full width, {pcfg.n_layers} "
          f"layers, B={DECODE_PARITY['batch']}, prompt {DECODE_PARITY['prompt']}, "
          f"gen {DECODE_PARITY['gen']}): logits max |gap| {mx:.6e} mean "
          f"{mean:.6e} (tol {DECODE_CPU_TOL['max']} / {DECODE_CPU_TOL['mean']}); "
          f"greedy tokens equal before step {upto} "
          f"({'first top-2 margin under the tol at step ' + str(upto) if len(near) else 'no margin under the tol'}): "
          f"{same}; all {DECODE_PARITY['gen']} equal: "
          f"{np.array_equal(card['tokens'], cpu['tokens'])} | {smi}", flush=True)
    if not (mx <= DECODE_CPU_TOL["max"] and mean <= DECODE_CPU_TOL["mean"] and same):
        fail(f"decode card vs cpu ({pcfg.name}): logits max {mx:.3e} mean {mean:.3e}, "
             f"tokens before step {upto} equal: {same}")
    del model, params, params_cpu, card, cpu
    gc_collect()


def train_resume(torch, np, kernels, smi, tcfg, n_params, flash_per_step,
                 run=TRAIN) -> None:
    """The train CLI's LM mode on `tcfg` (registered), `run`'s B, S and
    steps with a checkpoint every run["every"] steps, under flash, then
    re-run after a crash past the first checkpoint: the resumed run held
    bitwise to the uninterrupted one, `flash_per_step` flash launches a
    step and no other launch.  Each run is cut before its last step's
    checkpoint is written, as a crash after the last step would cut it
    (`checkpoint.save` is wrapped for the two runs): the first checkpoint
    due is the one write, and the resume reads it.  The wall times so
    cover the CLI without its last write."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.train import checkpoint as ckpt

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        state_bytes = 3 * n_params * 4  # params, m, v in f32
        free = shutil.disk_usage(ckpt_dir).free
        print(f"train: {ckpt_dir} has {free / 1e9:.1f} GB free; a checkpoint "
              f"is {state_bytes / 1e9:.2f} GB of npz", flush=True)
        if free < 4 * state_bytes:
            fail(f"train: {free / 1e9:.1f} GB free, need {4 * state_bytes / 1e9:.1f}")
            return
        argv = ["--arch", tcfg.name, "--batch", str(run["batch"]),
                "--seq", str(run["seq"]), "--steps", str(run["steps"]),
                "--ckpt", ckpt_dir, "--ckpt-every", str(run["every"]),
                "--log-every", "1"]
        save, writes = ckpt.save, []

        def save_but_the_last(path, step, state):
            if step != run["steps"]:
                writes.append(step)
                save(path, step, state)

        runs = {}
        for name in ("whole", "resumed"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ckpt.save = save_but_the_last
            try:
                with use_attention_impl("flash"):
                    out, n = counted_run(kernels, lambda: train.main(argv))
            finally:
                ckpt.save = save
            wall = time.perf_counter() - t0
            steps = len(out["losses"])
            runs[name] = out
            print(f"train {name} ({tcfg.name}: p={out['state'].params.numel}, "
                  f"B={run['batch']} S={run['seq']} AdamW warmup-cosine, "
                  f"flash): steps {out['start']}..{run['steps'] - 1}, "
                  f"p50 {out['timer'].percentile(0.5) * 1e3:.3f} ms/step "
                  f"(StepTimer), loss "
                  + " ".join(f"{s}:{v:.6f}" for s, v in sorted(out["losses"].items()))
                  + f"; flash launches {n['flash_attention']} "
                  f"({n['flash_attention'] / max(steps, 1):.2f}/step); "
                  f"max_memory_allocated={torch.cuda.max_memory_allocated()}; "
                  f"wall {wall:.2f} s with the checkpoints written at steps "
                  f"{writes} | {smi}", flush=True)
            if n["flash_attention"] != flash_per_step * steps or any(
                    v for k, v in n.items() if k != "flash_attention"):
                fail(f"train {name}: launches {n} for {steps} steps, want "
                     f"{flash_per_step} flash launches a step and nothing else")
        a, b = runs["whole"], runs["resumed"]
        roofline_line(smi, f"train {tcfg.name}", tcfg, "train", run["batch"],
                      run["seq"], a["timer"].percentile(0.5) * 1e3)
        same = (writes == [run["every"]] and b["start"] == run["every"]
                and a["state"].step == b["state"].step == run["steps"]
                and all(a["losses"][s] == b["losses"][s] for s in b["losses"])
                and torch.equal(a["state"].params.flat, b["state"].params.flat)
                and all(torch.equal(a["state"].opt_state[k], b["state"].opt_state[k])
                        for k in ("m", "v")))
        gaps = {k: (a["state"].opt_state[k] - b["state"].opt_state[k]).abs().max().item()
                for k in ("m", "v")}
        gaps["params"] = (a["state"].params.flat - b["state"].params.flat).abs().max().item()
        print(f"train resume from step {b['start']}: bitwise the uninterrupted "
              f"run: {same} (max |gap| {json.dumps(gaps)}); loss step 0 "
              f"{a['losses'][0]:.6f}, step {run['steps'] - 1} "
              f"{a['losses'][run['steps'] - 1]:.6f}", flush=True)
        if not same:
            fail(f"train: the resumed run is not bitwise the uninterrupted one {gaps}")
        if not (np.isfinite(list(a["losses"].values())).all()
                and a["losses"][run["steps"] - 1] < a["losses"][0]):
            fail(f"train {tcfg.name}: losses {a['losses']}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del runs, a, b
    gc_collect()


def moe_phase(torch, np, dev, kernels) -> None:
    """Phase 15: the MoE family at full width through the model facade's
    three paths, decode (`decode_main`), the DeltaGrad objective (train ->
    BaseL -> replay) and the train CLI, each run with the launch counts
    zeroed just before and read after; and the card against the port's CPU
    run.  An MoE FFN routes each token group under its own capacity, and
    the reference groups prefill's B*S tokens, a decode step's B and the
    objective's rows one by one, so `prefill_fn` and the stepped decode
    route differently by design: their gap is recorded, not held."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    # (d)'s replay fills the card (4.77 GB vectors: two windows, the pairs,
    # the step's gradients); from here on segments grow in place, so the
    # blocks earlier phases freed cannot fragment it
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    print(f"moe: MemAvailable {mem_available_gb():.1f} GiB at the start",
          flush=True)
    moe_decode(torch, dev, kernels, smi)
    moe_parity(torch, np, dev, smi)
    lcfg = moe_deltagrad(torch, np, dev, kernels, smi)
    moe_train(torch, np, dev, kernels, smi, lcfg)
    print(f"moe: phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def moe_decode(torch, dev, kernels, smi) -> None:
    """15 (a), (b): `decode_main` on qwen2-moe-a2.7b at 4 layers and on
    moonshot-v1-16b-a3b at 2, at their published widths."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.models import moe
    from repro_torch.models.registry import build

    base = get_config("qwen2-moe-a2.7b")
    for name, run in (("qwen2-moe-a2.7b", MOE_DECODE),
                      ("moonshot-v1-16b-a3b", MOONSHOT)):
        full = get_config(name)
        cfg = register(dc.replace(full, name=f"{name}-{run['layers']}l",
                                  n_layers=run["layers"]))
        label = f"{name} {cfg.n_layers} of {full.n_layers} layers"
        res = decode_run(torch, kernels, smi, label, cfg, run)
        tokens = run["batch"] * run["prompt"]
        print(f"decode {label}: capacity {moe.capacity_of(cfg.moe, tokens)} "
              f"slots an expert in prefill_fn ({tokens} tokens, one group), "
              f"{moe.capacity_of(cfg.moe, run['batch'])} in a decode step "
              f"({run['batch']} tokens)", flush=True)
        prefill_check(torch, dev, kernels, smi, label, build(cfg), res,
                      cfg.n_layers, tol=None, moe_cfg=cfg.moe)
        if cfg.name.startswith(base.name):
            decode_profile(torch, dev, smi, label, build(cfg), res)
        del res
        gc_collect()


def moe_parity(torch, np, dev, smi) -> None:
    """15 (c): the card against the port's CPU run: the reduced
    qwen2-moe-a2.7b decoding in f32 (held), one full-width MoE layer's
    `moe_apply` in bf16 (held), and the full-width model at 1 layer
    decoding in bf16 (recorded: one near-tie flip of the router changes a
    token's whole FFN output, so two bf16 programs of the model have no
    sound bar)."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import flatten_nested, nested

    base = get_config("qwen2-moe-a2.7b")
    B, P, G = MOE_PARITY["batch"], MOE_PARITY["prompt"], MOE_PARITY["gen"]

    rcfg = base.reduced()
    mx, same = reduced_f32_parity(torch, np, dev, rcfg)
    print(f"moe card vs cpu, reduced {base.name} in f32 (E "
          f"{rcfg.moe.num_experts}, top-{rcfg.moe.top_k}, B {B}, {P} + {G} "
          f"tokens): logits max |gap| {mx:.6e} (tol {MOE_PARITY['tol']}); "
          f"greedy tokens equal: {same}", flush=True)
    if not (mx <= MOE_PARITY["tol"] and same):
        fail(f"moe card vs cpu reduced f32: logits {mx:.3e}, tokens equal {same}")

    # the full-width model at 1 layer, bf16 weights on the card and the CPU
    m1 = build(dc.replace(base, n_layers=1))
    p1 = cast_params(nested(m1.init(seed=0, device=dev)), torch.bfloat16)
    p1_cpu = {k: v.cpu() for k, v in flatten_nested(p1).items()}
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(MOE_PARITY["x"], generator=g, device=dev).to(torch.bfloat16)
    x = x.reshape(1, -1, x.shape[-1])  # the batch as one token group
    got = {}
    for where, params in ((dev, p1), ("cpu", nested(p1_cpu))):
        w = {k: v[0] for k, v in flatten_nested(params["u0"]["mlp"]).items()}
        with torch.no_grad():
            out, aux = moe.moe_apply(nested(w), x.to(where), base.moe)
            idx = moe.route(nested(w), x.to(where), base.moe.top_k)[2]
        got[where] = (out.float().cpu(), aux.cpu(), idx.cpu())
    gap = (got[dev][0] - got["cpu"][0]).abs()
    mx, mean = gap.max().item(), gap.mean().item()
    same = torch.equal(got[dev][2], got["cpu"][2])
    C = moe.capacity_of(base.moe, x.shape[1])
    drops = int((moe.slot_ranks(got["cpu"][2].reshape(1, -1),
                                base.moe.num_experts) >= C).sum())
    print(f"moe card vs cpu, one {base.name} MoE layer at full width "
          f"(moe_apply, bf16 x {MOE_PARITY['x']}, one group, capacity {C}, "
          f"{drops} of {got['cpu'][2].numel()} choices dropped): top-k "
          f"indices equal: {same}; out max |gap| {mx:.6e} mean {mean:.6e} (tol "
          f"{DECODE_CPU_TOL['max']} / {DECODE_CPU_TOL['mean']}); aux "
          f"{got[dev][1].item():.6f} / {got['cpu'][1].item():.6f}", flush=True)
    if not (same and mx <= DECODE_CPU_TOL["max"] and mean <= DECODE_CPU_TOL["mean"]):
        fail(f"moe card vs cpu moe_apply: indices equal {same}, max {mx:.3e} "
             f"mean {mean:.3e}")

    prompt = np.random.default_rng(0).integers(0, base.vocab, size=(B, P),
                                               dtype=np.int32)
    card = serve.generate(m1, p1, prompt, G, device=dev)
    cpu = serve.generate(m1, p1_cpu, prompt, G, device="cpu")
    gap = (card["prompt_logits"].cpu() - cpu["prompt_logits"]).abs()
    differ = np.nonzero((card["tokens"] != cpu["tokens"]).any(axis=0))[0]
    print(f"moe card vs cpu, {base.name} at full width, 1 layer, bf16 "
          f"(recorded, not held): logits max |gap| {gap.max().item():.6e} mean "
          f"{gap.mean().item():.6e}; greedy tokens equal through step "
          f"{int(differ[0]) - 1 if len(differ) else G - 1} of {G} | {smi}",
          flush=True)
    del m1, p1, p1_cpu, card, cpu, got
    gc_collect()


def greedy_f32(torch, model, params, prompt, gen, device, fill=None):
    """The stepped decode in f32 compute, greedy: (tokens, the logits after
    the prompt and after each generated token).  `fill` (an
    encoder-decoder's, `whisper_fill`) makes the caches."""
    B, P = prompt.shape
    toks = torch.from_numpy(prompt).to(device)
    caches = (model.cache_init(B, P + gen, device=device) if fill is None else
              fill(model, params, device, B, P + gen, torch.float32))
    for t in range(P):
        logits, caches = model.decode_fn(params, {"tokens": toks[:, t:t + 1]},
                                         caches, dtype=torch.float32)
    seen, out = [logits], []
    for _ in range(gen):
        nxt = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        out.append(nxt)
        logits, caches = model.decode_fn(params, {"tokens": nxt}, caches,
                                         dtype=torch.float32)
        seen.append(logits)
    return torch.cat(out, dim=1).cpu().numpy(), torch.stack(seen).cpu()


def reduced_f32_parity(torch, np, dev, rcfg, fill=None) -> tuple:
    """The reduced model `rcfg` decoding greedily in f32 on the card and on
    the CPU, the same weights (MOE_PARITY's batch, prompt and gen; an
    encoder-decoder's caches made by `fill`): (max |gap| of the logits,
    greedy tokens equal)."""
    from repro_torch.models.registry import build

    B, P, G = MOE_PARITY["batch"], MOE_PARITY["prompt"], MOE_PARITY["gen"]
    rmodel = build(rcfg)
    rp = rmodel.init(seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab, size=(B, P),
                                               dtype=np.int32)
    (tok_c, log_c), (tok_h, log_h) = (greedy_f32(torch, rmodel, p, prompt, G, where, fill)
                                      for p, where in ((rp, dev), (rp.to("cpu"), "cpu")))
    return (log_c - log_h).abs().max().item(), np.array_equal(tok_c, tok_h)


def moe_deltagrad(torch, np, dev, kernels, smi, steps=MOE_LM["steps"],
                  burn_in=MOE_LM["burn_in"], dtype=None, main_path=True):
    """15 (d): DeltaGrad on qwen2-moe-a2.7b at full width, 1 of 24 layers,
    on phase 9's recipe (bf16 compute, flash on every forward pass): the
    objective's gradient twice on one batch, then train -> BaseL -> replay
    from a host f32 history, on the main path the replay under the
    profiler.  Returns the registered 1-layer config.

    The LM's bar d_ui < d_us is held when the replay took an approx step.
    At the main path's cut the guard rejects every one (each B v's
    ||Bv||/||v|| is past its clip), the replay is then BaseL, and that is
    held bitwise instead: the bar is empty there.  `steps`, `burn_in`
    and the compute `dtype` (None: the model's bf16) set another cut,
    which `--moe-dg` runs alone (`main_path` False): its numbers are
    recorded and the bar is not held (PERF.md section 7: on this recipe
    the approx steps of both packages diverge on an MoE)."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import moe
    from repro_torch.models.registry import build

    lcfg = register(dc.replace(get_config("qwen2-moe-a2.7b"),
                               name="qwen2-moe-a2.7b-1l", n_layers=MOE_LM["layers"]))
    docs = token_stream(LM["docs"], LM["seq"], lcfg.vocab, seed=0)
    meta = HistoryMeta(n=LM["docs"], batch_size=LM["batch"], seed=LM["seed"],
                       steps=steps, lr_schedule=((0, LM["lr"]),))
    dgc = dg.DeltaGradConfig(**{**LM_DG, "burn_in": burn_in,
                                "stream_window": MOE_LM["window"]})
    what = "bf16" if dtype is None else str(dtype).split(".")[-1]
    removed = np.linspace(3, 120, 4).astype(np.int64)
    model = build(lcfg)
    p0 = model.init(seed=0, device=dev)
    if p0.numel != MOE_LM["n_params"]:
        fail(f"moe lm: p = {p0.numel}, want {MOE_LM['n_params']}")
    print(f"moe lm: {lcfg.name} p={p0.numel} ({p0.numel * 4 / 1e9:.3f} GB a "
          f"f32 vector) {what} compute docs={LM['docs']}x{LM['seq']} B={LM['batch']} "
          f"T={meta.steps} T0={dgc.period} j0={dgc.burn_in} "
          f"m={dgc.history_size} window={dgc.stream_window} "
          f"removed={removed.tolist()}; each row its own token group of "
          f"{LM['seq']} (capacity {moe.capacity_of(lcfg.moe, LM['seq'])}); "
          f"the host f32 history needs {meta.steps * 2 * p0.numel * 4 / 1e9:.1f} "
          f"GB, MemAvailable {mem_available_gb():.1f} GiB", flush=True)
    obj = dg.Objective.from_model(model, loss_chunk=LM["loss_chunk"],
                                  attn_impl="flash", dtype=dtype)
    forwards = count_forwards(obj)

    # determinism: the objective's gradient on one batch, twice
    batch = {"tokens": docs.device_columns(dev)["tokens"][:LM["batch"]]}
    ones = torch.ones(LM["batch"], device=dev)
    g1 = obj.make_grad_fn()(p0, batch, ones)
    g2 = obj.make_grad_fn()(p0, batch, ones)
    same = torch.equal(g1, g2)
    print(f"moe lm: the objective's gradient on {LM['batch']} rows, two "
          f"evaluations bitwise equal: {same} (max |gap| "
          f"{(g1 - g2).abs().max().item():.3e}; |g| {g1.norm().item():.6e})",
          flush=True)
    if not same:
        fail("moe lm: two evaluations of the objective's gradient differ")
    del g1, g2, batch
    gc_collect()

    # the card holds one p-length result beside the replay's state: BaseL
    # runs before the replay for d_us and again after it for d_ui
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                           codec="f32", window=dgc.stream_window)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    w_u, st_u = dg.baseline_retrain(obj, docs, meta, p0, removed)
    d_us = (w_u.flat - w_star.flat).norm().item()
    del w_star, w_u
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    forwards[0] = 0
    # on the main path the one replay runs under the profiler
    def replay():
        return dg.deltagrad_retrain(obj, hist, docs, removed, dgc)

    with bv_ratios() as ratios:
        (w_i, st), n = counted_run(kernels, (lambda: profile_replay(
            torch, "moe lm host/f32 replay", replay)) if main_path else replay)
    peak = torch.cuda.max_memory_allocated()
    fwd = forwards[0]
    w_u, _ = dg.baseline_retrain(obj, docs, meta, p0, removed)
    del p0
    d_ui = (w_u.flat - w_i.flat).norm().item()
    print(replay_line(f"moe lm {what} compute, f32 host", train_s, st_u, st, d_ui,
                      d_us, ratios, dgc)
          + (" (replay_s under the profiler)" if main_path else "")
          + f" max_memory_allocated (replay)={peak} forward_passes={fwd} "
          f"launches {json.dumps(n)}; MemAvailable {mem_available_gb():.1f} GiB "
          f"with the history | {smi}", flush=True)
    if not (bool(torch.isfinite(w_i.flat).all()) and w_i.numel == MOE_LM["n_params"]):
        fail("moe lm: replay parameters are not finite of the expected shape")
    if not main_path:
        print(f"moe lm {what} compute: d_ui/d_us {d_ui / d_us:.4e} after "
              f"{st.approx_steps} approx steps (recorded, not held)", flush=True)
    elif st.approx_steps == 0:  # every approx step fell back: the replay is BaseL
        print(f"moe lm: no approx step was accepted, so the d_ui < d_us bar is "
              f"empty at this cut; held instead: the replay is BaseL bitwise: "
              f"{torch.equal(w_u.flat, w_i.flat)}", flush=True)
        if not torch.equal(w_u.flat, w_i.flat):
            fail(f"moe lm: no approx step, yet the replay is {d_ui:.3e} from BaseL")
    elif not d_ui < d_us:  # the LM's f32 bar (phase 9)
        fail(f"moe lm: d_ui {d_ui:.3e} not below d_us {d_us:.3e}")
    if not n["flash_attention"] == MOE_LM["layers"] * fwd > 0:
        fail(f"moe lm: flash launched {n['flash_attention']} times for {fwd} "
             f"forward passes of {MOE_LM['layers']} layer")
    check_replay_launches("moe lm", n, st)
    if n["dequant_update"] or n["dequant_sub"]:
        fail("moe lm: a dequant kernel ran on the f32 (fetch-mode) path")
    del w_i, w_u
    gc_collect()
    if not main_path:
        return lcfg
    replay_kernels_at(torch, dev, MOE_LM["n_params"])
    del hist, obj, model
    gc_collect()
    return lcfg


def replay_kernels_at(torch, dev, p: int, m: int = 2, label: str = "moe lm") -> None:
    """The replay's three kernels against their plain versions at the
    objective's p, f32, m pairs: fused_update and rank_update elementwise
    (|err| / max |plain|, phase 2's 1e-5); multidot's sums per entry
    against f64 sums taken in chunks, |err| / sum |a b|, where f32 sums of
    p terms drift by ~eps sqrt(p / threads), so the bar is 1e-5 (phase 2's
    1e-6 is at p = 238,510).  These are comparison launches: they do not
    count toward any path's launches."""
    from repro_torch.kernels.fused_update.ops import update
    from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
    from repro_torch.kernels.lbfgs.ops import multidot, rank_update
    from repro_torch.kernels.lbfgs.ref import multidot_ref, rank_update_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    dW, dG = (torch.randn(m, p, generator=gen, device=dev) for _ in range(2))
    v, w, g, gc = (torch.randn(p, generator=gen, device=dev) for _ in range(4))
    a, b = torch.randn(m, device=dev), torch.randn(m, device=dev)
    sigma = torch.tensor(0.5, device=dev)
    saved = {f: f.launches for f in (update, multidot, rank_update)}
    errs = {}
    args = (0.01, 32.0, 4.0, 1.0)  # lr, B, the batch's deleted rows, delete
    for name, fn, ref in (
            ("fused_update", lambda: update(w, g, v, gc, *args),
             lambda: deltagrad_update_ref(w, g, v, gc, *args)),
            ("rank_update", lambda: rank_update(dW, dG, v, a, b, sigma),
             lambda: rank_update_ref(dW, dG, v, a, b, sigma))):
        got = fn()
        want = ref()
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
        del got, want
    sums = multidot(dW, dG, v)
    plain = multidot_ref(dW, dG, v)
    exact = [torch.zeros(t.shape, dtype=torch.float64, device=dev) for t in sums]
    scale = [torch.zeros_like(t) for t in exact]
    step = 1 << 26
    for c in range(0, p, step):
        w64, g64, v64 = (x[..., c:c + step].double() for x in (dW, dG, v))
        for i, (x, y) in enumerate(((w64, w64.T), (w64, g64.T), (w64, v64), (g64, v64))):
            exact[i] += x @ y
            scale[i] += x.abs() @ y.abs()
        del w64, g64, v64
    per = [max(((s.double() - e).abs() / c).max().item()
               for s, e, c in zip(r, exact, scale)) for r in (sums, plain)]
    errs["multidot"] = per[0]
    for f, n in saved.items():
        f.launches = n
    print(f"{label}: the replay kernels against their plain versions at p={p}, "
          f"m={m}, f32: fused_update rel_err={errs['fused_update']:.3e} "
          f"rank_update rel_err={errs['rank_update']:.3e} (tol 1e-5); multidot "
          f"per-entry |err|/sum|a*b| vs f64 = {per[0]:.3e} (plain version "
          f"{per[1]:.3e}; tol 1e-5)", flush=True)
    for name, e in errs.items():
        if not e <= 1e-5:
            fail(f"{label}: {name} at p={p}: error {e:.3e} > 1e-5")
    del dW, dG, v, w, g, gc, sums, plain, exact, scale
    gc_collect()


def moe_train(torch, np, dev, kernels, smi, lcfg) -> None:
    """15 (e): the train CLI at (d)'s cut, no checkpoint; step 0's loss
    split into its cross-entropy and the router's aux term."""
    from repro_torch.data.sampler import batch_indices
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch import train
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import lm_loss_terms

    argv = ["--arch", lcfg.name, "--batch", str(MOE_TRAIN["batch"]),
            "--seq", str(MOE_TRAIN["seq"]), "--steps", str(MOE_TRAIN["steps"]),
            "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    with use_attention_impl("flash"):
        out, n = counted_run(kernels, lambda: train.main(argv))
    losses, steps = out["losses"], len(out["losses"])
    ms = out["timer"].percentile(0.5) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del out
    gc_collect()
    # step 0's loss term by term: the CLI's init and first batch
    corpus = token_stream(n_docs=max(MOE_TRAIN["batch"] * 8, 64),
                          seq_len=MOE_TRAIN["seq"], vocab=lcfg.vocab, seed=0)
    idx = batch_indices(0, 0, corpus.n, MOE_TRAIN["batch"])
    batch = {"tokens": torch.from_numpy(corpus.take(idx)["tokens"]).to(dev)}
    with use_attention_impl("flash"), torch.no_grad():
        ce, aux = (v.item() for v in lm_loss_terms(
            build(lcfg).init(0, device=dev), batch, lcfg, remat=False,
            loss_chunk=min(128, MOE_TRAIN["seq"])))
    print(f"train {lcfg.name} (p={MOE_LM['n_params']}, B={MOE_TRAIN['batch']} "
          f"S={MOE_TRAIN['seq']}, AdamW warmup-cosine, flash, no checkpoint): "
          f"p50 {ms:.3f} ms/step (StepTimer), loss "
          + " ".join(f"{s}:{v:.6f}" for s, v in sorted(losses.items()))
          + f"; step 0 = cross-entropy {ce:.6f} + router aux term {aux:.6e} "
          f"= {ce + aux:.6f}; flash launches {n['flash_attention']} "
          f"({n['flash_attention'] / max(steps, 1):.2f}/step); "
          f"max_memory_allocated={peak} | {smi}", flush=True)
    roofline_line(smi, f"train {lcfg.name}", lcfg, "train", MOE_TRAIN["batch"],
                  MOE_TRAIN["seq"], ms)
    if not (steps == MOE_TRAIN["steps"] and np.isfinite(list(losses.values())).all()):
        fail(f"train {lcfg.name}: losses {losses}")
    if not (aux > 0 and abs(ce + aux - losses[0]) <= 1e-6 * abs(losses[0])):
        fail(f"train {lcfg.name}: step 0's loss {losses[0]} is not its "
             f"cross-entropy {ce} + aux term {aux}")
    if n["flash_attention"] != MOE_LM["layers"] * steps or any(
            v for k, v in n.items() if k != "flash_attention"):
        fail(f"train {lcfg.name}: launches {n} for {steps} steps of "
             f"{MOE_LM['layers']} layer")


def mla_phase(torch, np, dev, kernels) -> None:
    """Phase 16: multi-head latent attention (minicpm3-4b) at its published
    widths through the model facade's three paths, decode (`decode_main`),
    the DeltaGrad objective (train -> BaseL -> replay) and the train CLI,
    each run with the launch counts zeroed just before and read after; and
    the card against the port's CPU run.  MLA's attention is blockwise
    whatever the flash switch (the reference's mla.py:79), so no path of
    this phase launches flash."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    print(f"mla: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    marks = [t_phase]

    def lap(part: str) -> None:  # where the phase's time goes
        marks.append(time.perf_counter())
        print(f"mla: {part} took {marks[-1] - marks[-2]:.1f} s", flush=True)

    # (a) 31 of the 62 layers (MLA_DECODE, cut by time); (b) the expanded
    # prefill against the absorbed decode
    cfg = get_config("minicpm3-4b")
    dcfg = register(dc.replace(cfg, name=f"{cfg.name}-{MLA_DECODE['layers']}l",
                               n_layers=MLA_DECODE["layers"]))
    label = f"{cfg.name} {dcfg.n_layers} of {cfg.n_layers} layers"
    res = decode_run(torch, kernels, smi, label, dcfg, MLA_DECODE)
    m, B = cfg.mla, MLA_DECODE["batch"]
    slots = MLA_DECODE["prompt"] + MLA_DECODE["gen"]
    per_pos = m.kv_lora_rank + m.qk_rope_head_dim
    expanded = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
    print(f"decode {label}: latent cache {dcfg.n_layers * B * slots * per_pos * 2} "
          f"bytes ({per_pos} bf16 values a position a layer, {slots} positions "
          f"x B {B} x {dcfg.n_layers} layers; expanded k and v would hold "
          f"{expanded}, {expanded / per_pos:.1f}x)", flush=True)
    lap(f"(a) decode_main at {dcfg.n_layers} layers")
    model = build(dcfg)
    prefill_check(torch, dev, kernels, smi, label, model, res, dcfg.n_layers)
    lap("(b) prefill_fn")
    # one step: ~6,000 launches, near as many events as phase 14's 8 steps
    decode_profile(torch, dev, smi, label, model, res, steps=1)
    del res, model
    gc_collect()
    lap("(a) the decode profile")

    # (c) the card against the port's CPU run
    decode_cpu_parity(torch, np, dev, smi,
                      dc.replace(cfg, n_layers=DECODE_PARITY["layers"]))
    rcfg = cfg.reduced()
    mx, same = reduced_f32_parity(torch, np, dev, rcfg)
    print(f"mla card vs cpu, reduced {cfg.name} in f32 (q_lora "
          f"{rcfg.mla.q_lora_rank}, kv_lora {rcfg.mla.kv_lora_rank}, B "
          f"{MOE_PARITY['batch']}, {MOE_PARITY['prompt']} + {MOE_PARITY['gen']} "
          f"tokens): logits max |gap| {mx:.6e} (tol {MOE_PARITY['tol']}); greedy "
          f"tokens equal: {same}", flush=True)
    if not (mx <= MOE_PARITY["tol"] and same):
        fail(f"mla card vs cpu reduced f32: logits {mx:.3e}, tokens equal {same}")
    lap("(c) card against CPU")

    # (d) DeltaGrad at 2 of 62 layers; (e) the train CLI at that cut
    lcfg = mla_deltagrad(torch, np, dev, kernels, smi)
    lap("(d) DeltaGrad at 2 layers")
    train_resume(torch, np, kernels, smi, lcfg, MLA_LM["n_params"], flash_per_step=0)
    lap("(e) the train CLI, resumed")
    print(f"mla: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


def mla_deltagrad(torch, np, dev, kernels, smi, dtype=None, main_path=True):
    """16 (d): DeltaGrad on minicpm3-4b at full width, 2 of its 62 layers,
    on phase 9's recipe and main path (``attn_impl="flash"``, which MLA
    never reaches; a host f32 history streamed in windows of 2 steps), on
    the main path at T 8 and j0 4 (`LM_TIME_CUT`), in the compute `dtype`
    (None: the model's bf16).  On the main path the
    replay runs once, under the profiler (its busy share; replay_s is read
    there), with the launch counts zeroed just before and read after.
    Held: no flash or dequant launch, each replay kernel launched once per
    approx step (at least once where the guard sent a segment back), on
    the main path those kernels against their plain versions at this p,
    and in f32 compute d_ui < d_us.  In bf16 d_ui/d_us is recorded against
    the bar of 1, not held (`MLA_BF16_MISS`).  ``--mla-dg f32`` runs this
    alone in f32 compute (`main_path` False).  Returns the 2-layer config,
    registered for the train CLI."""
    import dataclasses as dc

    from repro_torch.configs.registry import register
    from repro_torch.core import deltagrad as dg

    what = "bf16" if dtype is None else str(dtype).split(".")[-1]
    print(f"mla lm: MemAvailable {mem_available_gb():.1f} GiB at the start",
          flush=True)
    cfg, model, p0, docs, meta, dgc, removed, obj = lm_setup(
        torch, np, dev, "minicpm3-4b", dtype, **(LM_TIME_CUT if main_path else {}))
    lcfg = register(dc.replace(cfg, name=f"{cfg.name}-{cfg.n_layers}l"))
    if p0.numel != MLA_LM["n_params"]:
        fail(f"mla lm: p = {p0.numel}, want {MLA_LM['n_params']}")
    print(f"mla lm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
          f"mla={dc.asdict(cfg.mla)} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"layers={cfg.n_layers} of 62 p={p0.numel} ({p0.numel * 4 / 1e9:.3f} GB "
          f"a f32 vector) {what} compute docs={LM['docs']}x{LM['seq']} "
          f"B={LM['batch']} T={meta.steps} T0={dgc.period} j0={dgc.burn_in} "
          f"m={dgc.history_size} window={dgc.stream_window} "
          f"removed={removed.tolist()}; the host f32 history needs "
          f"{meta.steps * 2 * p0.numel * 4 / 1e9:.1f} GB", flush=True)
    forwards = count_forwards(obj)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                           codec="f32", window=dgc.stream_window)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    w_u, st_u = dg.baseline_retrain(obj, docs, meta, p0, removed)
    torch.cuda.reset_peak_memory_stats()
    forwards[0] = 0

    def replay():
        return dg.deltagrad_retrain(obj, hist, docs, removed, dgc)

    label = f"mla lm {what} compute, f32 host"
    with bv_ratios() as ratios:
        (w_i, st), n = counted_run(kernels, (lambda: profile_replay(
            torch, f"{label} replay", replay)) if main_path else replay)
    peak = torch.cuda.max_memory_allocated()
    d_ui = (w_u.flat - w_i.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    print(replay_line(label, train_s, st_u, st, d_ui, d_us, ratios, dgc)
          + (" (replay_s under the profiler)" if main_path else "")
          + f" max_memory_allocated (train)={train_peak} (replay)={peak} "
          f"host_bytes={hist.nbytes()} forward_passes={forwards[0]} launches "
          f"{json.dumps(n)}; MemAvailable {mem_available_gb():.1f} GiB with the "
          f"history | {smi}", flush=True)
    if not (bool(torch.isfinite(w_i.flat).all()) and w_i.numel == MLA_LM["n_params"]):
        fail("mla lm: replay parameters are not finite of the expected shape")
    # phase 9's bar, held in f32 compute; in bf16 recorded (MLA_BF16_MISS)
    print(f"mla lm {what} compute: d_ui/d_us = {d_ui / d_us:.4e}: "
          + ("below the bar of 1" if d_ui < d_us else "MISSES the bar of 1")
          + ("" if dtype is not None else f" (bf16: recorded, not held; {MLA_BF16_MISS})"),
          flush=True)
    if dtype is not None and not d_ui < d_us:
        fail(f"mla lm {what}: d_ui {d_ui:.3e} not below d_us {d_us:.3e}")
    if n["flash_attention"] or n["dequant_update"] or n["dequant_sub"]:
        fail(f"mla lm: launches {n}: MLA's attention is blockwise and the f32 "
             "history is fetched")
    check_replay_launches("mla lm", n, st)
    del w_star, w_u, w_i, p0, hist, obj, model
    gc_collect()
    if main_path:
        replay_kernels_at(torch, dev, MLA_LM["n_params"], label="mla lm")
    return lcfg


def hybrid_phase(torch, np, dev, kernels) -> None:
    """Phase 17: the Mamba2 hybrid (zamba2-7b) at its published widths
    through the model facade's three paths, decode (`decode_main`), the
    DeltaGrad objective (train -> BaseL -> replay) and the train CLI, each
    run with the launch counts zeroed just before and read after; and the
    card against the port's CPU run.  The shared block attends in a window,
    which goes to blockwise attention whatever the flash switch, as in the
    reference, and a Mamba2 block has no kernel of its own, so no path of
    this phase launches flash."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    print(f"hybrid: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    marks = [t_phase]

    def lap(part: str) -> None:  # where the phase's time goes
        marks.append(time.perf_counter())
        print(f"hybrid: {part} took {marks[-1] - marks[-2]:.1f} s", flush=True)

    # (a) 7 of the 13 units (HYBRID_DECODE, cut by time); (b) the chunked
    # prefill against the stepped decode
    cfg = get_config("zamba2-7b")
    dcfg = register(dc.replace(cfg, name=f"{cfg.name}-{HYBRID_DECODE['layers']}l",
                               n_layers=HYBRID_DECODE["layers"]))
    label = f"{cfg.name} {dcfg.n_layers} of {cfg.n_layers} layers"
    res = decode_run(torch, kernels, smi, label, dcfg, HYBRID_DECODE, roofline=False)
    hybrid_step_bound(torch, smi, label, dcfg, res)
    lap(f"(a) decode_main at {dcfg.n_layers} layers")
    model = build(dcfg)
    prefill_check(torch, dev, kernels, smi, label, model, res, dcfg.n_layers,
                  tol=HYBRID_PREFILL_TOL)
    prefill_f32(torch, dev, smi, label, model, res["prompt"], HYBRID_PREFILL_F32)
    cumsum_on_card(torch, dev, cfg)
    lap("(b) prefill_fn")
    decode_profile(torch, dev, smi, label, model, res, steps=1)
    del res, model
    gc_collect()
    lap("(a) the decode profile")

    # (c) the card against the port's CPU run
    decode_cpu_parity(torch, np, dev, smi,
                      dc.replace(cfg, n_layers=HYBRID_LM["layers"]))
    rcfg = cfg.reduced()
    mx, same = reduced_f32_parity(torch, np, dev, rcfg)
    print(f"hybrid card vs cpu, reduced {cfg.name} in f32 (one unit, d_model "
          f"{rcfg.d_model}, ssm {dc.asdict(rcfg.ssm)}, B {MOE_PARITY['batch']}, "
          f"{MOE_PARITY['prompt']} + {MOE_PARITY['gen']} tokens): logits max |gap| "
          f"{mx:.6e} (tol {HYBRID_F32_TOL}: bf16 KV caches); greedy tokens equal: "
          f"{same}", flush=True)
    if not (mx <= HYBRID_F32_TOL and same):
        fail(f"hybrid card vs cpu reduced f32: logits {mx:.3e}, tokens equal {same}")
    lap("(c) card against CPU")

    # (d) DeltaGrad at 1 of 13 units; (e) the train CLI at that cut
    lcfg = hybrid_deltagrad(torch, np, dev, kernels, smi)
    lap("(d) DeltaGrad at 6 layers")
    train_resume(torch, np, kernels, smi, lcfg, HYBRID_LM["n_params"], flash_per_step=0)
    lap("(e) the train CLI, resumed")
    print(f"hybrid: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


def prefill_f32(torch, dev, smi, label, model, prompt, bar) -> None:
    """(b) in f32 compute at full width and depth: `prefill_fn` on the
    first bar["prompt"] prompt tokens against the stepped decode of the
    same tokens, both from `decode_main`'s f32 master weights (seed 0),
    held to `bar`: the two forms agree to f32 rounding (the hybrid's to its
    bf16 KV caches' rounding), which shows the bf16 gap is rounding, not a
    fault."""
    n = bar["prompt"]
    params = model.init(seed=0, device=dev)
    toks = torch.from_numpy(prompt[:, :n]).to(dev)
    caches = model.cache_init(toks.shape[0], n, device=dev)
    for t in range(n):
        logits, caches = model.decode_fn(params, {"tokens": toks[:, t:t + 1]},
                                         caches, dtype=torch.float32)
    pre = model.prefill_fn(params, {"tokens": toks}, dtype=torch.float32)
    gap = (pre - logits).abs()
    mx, mean = gap.max().item(), gap.mean().item()
    print(f"decode {label} prefill_fn f32 compute, {tuple(toks.shape)} tokens: "
          f"against the stepped f32 decode's last logits max |gap| {mx:.6e} mean "
          f"{mean:.6e} (tol {bar['max']} / {bar['mean']}) | {smi}", flush=True)
    if not (mx <= bar["max"] and mean <= bar["mean"]):
        fail(f"decode {label}: f32 prefill_fn against the stepped decode: max "
             f"{mx:.3e} mean {mean:.3e}")
    del params, caches
    gc_collect()


def cumsum_on_card(torch, dev, cfg) -> None:
    """The SSD's within-chunk cumulative decay on the card, `torch.cumsum`
    over axis 2 of (B, chunks, Q, H), against `cumsum_by_adds` (one f32 add
    after another, the reference's order), bitwise, at 17 (d)'s shape."""
    from repro_torch.models.mamba2 import _dims, cumsum_by_adds

    _, H, _ = _dims(cfg.d_model, cfg.ssm)
    gen = torch.Generator(device=dev).manual_seed(17)
    a = -torch.rand(LM["batch"], LM["seq"] // cfg.ssm.chunk, cfg.ssm.chunk, H,
                    generator=gen, device=dev) * 16
    one, adds = torch.cumsum(a, dim=2), cumsum_by_adds(a)
    same = torch.equal(one, adds)
    print(f"hybrid: torch.cumsum over a chunk of {cfg.ssm.chunk} on the card "
          f"{tuple(a.shape)} against one f32 add after another: bitwise equal "
          f"{same} (max |gap| {(one - adds).abs().max().item():.3e})", flush=True)
    if not same:
        fail("hybrid: torch.cumsum on the card is not the sequential f32 sum")


def hybrid_step_bound(torch, smi, label, cfg, res) -> None:
    """The decode state's bytes and a step's byte bound on the hybrid: the
    bf16 weights, the shared block's once per occurrence (its weights are
    read by each unit), the embedding's B rows, and the state read and
    written (SSM and conv states) or read (the KV caches).  The states'
    bytes are the caches' own (allocated on the meta device); the SSM
    state read and written, the conv state read and the KV caches read
    are `analytic_cost`'s cache term (held to them), so the step adds the
    conv state's write to it."""
    from repro_torch.models.transformer import init_caches, layout_of, param_shapes

    unit, n_units = layout_of(cfg)
    B, slots = HYBRID_DECODE["batch"], HYBRID_DECODE["prompt"] + HYBRID_DECODE["gen"]
    n_mamba = unit.count("mamba2") * n_units
    meta = init_caches(cfg, B, slots, device="meta")
    size = lambda kind, key: sum(c[key].numel() * c[key].element_size()  # noqa: E731
                                 for pos, c in meta.items() if unit[int(pos[1:])] == kind)
    ssm, conv = size("mamba2", "ssm"), size("mamba2", "conv")
    kv = size("attn_shared", "k") + size("attn_shared", "v")
    shapes = param_shapes(cfg)
    shared = sum(math.prod(v) for k, v in shapes.items() if k.startswith("shared/"))
    p = sum(math.prod(v) for v in shapes.values())
    weights = p - math.prod(shapes["embed"]) + B * cfg.d_model + (n_units - 1) * shared
    cost = run_cost(cfg, "decode", B, slots)
    cache = cost.breakdown["bytes_cache"]
    step_bytes = 2 * weights + cache + conv
    bound, _ = bound_ms(step_bytes, 0.0)
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    print(f"decode {label}: state bytes: ssm {ssm} ({n_mamba} Mamba2 blocks x B {B} "
          f"x {H} heads x {cfg.ssm.head_dim} x {cfg.ssm.d_state} f32), conv {conv}, "
          f"KV caches {kv} ({n_units} shared-block occurrences, bf16, "
          f"{min(slots, cfg.attn_window)} slots); a step moves {step_bytes / 1e9:.3f} "
          f"GB (bf16 weights {2 * weights / 1e9:.3f} GB with the shared block "
          f"{n_units} times, analytic_cost's cache term {cache / 1e9:.3f} GB, the conv "
          f"state written): byte bound {bound:.4f} ms against "
          f"{res['ms_per_token']:.4f} ms a step ({res['ms_per_token'] / bound:.1f}x) "
          f"| {smi}", flush=True)
    roofline_line(smi, f"decode {label}", cfg, "decode", B, slots,
                  res["ms_per_token"], bound, cost=cost)
    # a unit's states at B 16: five Mamba2 blocks' SSM and conv states, and
    # the shared block's KV cache (all 13 units: 1,908,408,320, 91,054,080
    # and 572,522,496 bytes)
    if (ssm, conv, kv) != (n_units * 146_800_640, n_units * 7_004_160,
                           n_units * 44_040_192):
        fail(f"decode {label}: state bytes ssm {ssm} conv {conv} kv {kv}")
    if cache != 2 * ssm + conv + kv:
        fail(f"decode {label}: analytic_cost's cache term {cache} is not the SSM "
             f"state read and written, the conv state and the KV caches read "
             f"({2 * ssm + conv + kv})")


def xlstm_phase(torch, np, dev, kernels) -> None:
    """Phase 18: xLSTM (xlstm-350m) at its published widths through the
    model facade's three paths, decode (`decode_main`, all 24 layers), the
    DeltaGrad objective (train -> BaseL -> replay, 2 layers) and the train
    CLI (2 layers; timed without its last checkpoint write, as
    `train_resume` cuts it), each run with the launch counts zeroed just
    before and read after; and the card against the port's CPU run, in
    decode and in the reduced model's replay.  The stack has no attention
    block and its cells no kernel of their own (einsums and loops over
    chunks and over time, as the reference's scans), so no path of this
    phase launches flash; the replay launches its three kernels."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    print(f"xlstm: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    marks = [t_phase]

    def lap(part: str) -> None:  # where the phase's time goes
        marks.append(time.perf_counter())
        print(f"xlstm: {part} took {marks[-1] - marks[-2]:.1f} s", flush=True)

    # (a) 8 of the 24 layers (XLSTM_DECODE, cut by time); (b) the chunked
    # prefill against the stepped decode
    cfg = get_config("xlstm-350m")
    dcfg = register(dc.replace(cfg, name=f"{cfg.name}-{XLSTM_DECODE['layers']}l",
                               n_layers=XLSTM_DECODE["layers"]))
    label = f"{cfg.name} {dcfg.n_layers} of {cfg.n_layers} layers"
    res = decode_run(torch, kernels, smi, label, dcfg, XLSTM_DECODE, roofline=False)
    xlstm_step_bound(smi, label, dcfg, res)
    lap(f"(a) decode_main at {dcfg.n_layers} layers")
    model = build(dcfg)
    prefill_check(torch, dev, kernels, smi, label, model, res, dcfg.n_layers,
                  tol=XLSTM_PREFILL_TOL)
    prefill_f32(torch, dev, smi, label, model, res["prompt"], XLSTM_PREFILL_F32)
    lap("(b) prefill_fn")
    decode_profile(torch, dev, smi, label, model, res, steps=1)
    del res, model
    gc_collect()
    lap("(a) the decode profile")

    # (c) the card against the port's CPU run
    decode_cpu_parity(torch, np, dev, smi,
                      dc.replace(cfg, n_layers=DECODE_PARITY["layers"]))
    rcfg = cfg.reduced()
    mx, same = reduced_f32_parity(torch, np, dev, rcfg)
    print(f"xlstm card vs cpu, reduced {cfg.name} in f32 (one unit, d_model "
          f"{rcfg.d_model}, B {MOE_PARITY['batch']}, {MOE_PARITY['prompt']} + "
          f"{MOE_PARITY['gen']} tokens): logits max |gap| {mx:.6e} (tol "
          f"{XLSTM_F32_TOL}); greedy tokens equal: {same}", flush=True)
    if not (mx <= XLSTM_F32_TOL and same):
        fail(f"xlstm card vs cpu reduced f32: logits {mx:.3e}, tokens equal {same}")
    lap("(c) card against CPU")

    # (d) DeltaGrad at 2 of 24 layers (XLSTM_LM), and the reduced model's
    # f32 replay against the CPU's; (e) the train CLI at that cut
    lcfg = xlstm_deltagrad(torch, np, dev, kernels, smi)
    lap(f"(d) DeltaGrad at {XLSTM_LM['layers']} layers")
    xlstm_replay_parity(torch, np, dev, rcfg)
    lap("(d) the reduced replay, card against CPU")
    train_resume(torch, np, kernels, smi, lcfg, XLSTM_LM["n_params"], flash_per_step=0,
                 run=XLSTM_TRAIN)
    lap("(e) the train CLI, resumed")
    print(f"xlstm: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


def xlstm_replay_parity(torch, np, dev, rcfg) -> None:
    """18 (d) on the reduced xLSTM `rcfg` in f32: XLSTM_REPLAY_PARITY's
    recipe (the port's replay test's) on the card and on the CPU from the
    port's init (seed 0), through `replay_card_cpu`, d_ui/d_us included."""
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models.registry import build

    R = XLSTM_REPLAY_PARITY
    model = build(rcfg)
    replay_card_cpu(
        torch, np, dev, f"xlstm replay reduced f32 (one unit, d_model {rcfg.d_model}, "
        f"{R['docs']} docs of {R['seq']}, B {R['batch']}, T {R['steps']}, lr {R['lr']})",
        model.objective(loss_chunk=R["seq"], dtype=torch.float32),
        model.init(seed=0, device="cpu"),
        token_stream(R["docs"], R["seq"], rcfg.vocab, seed=0),
        HistoryMeta(n=R["docs"], batch_size=R["batch"], seed=5, steps=R["steps"],
                    lr_schedule=((0, R["lr"]),)),
        dg.DeltaGradConfig(period=R["period"], burn_in=R["burn_in"], history_size=2,
                           guard=True, curvature_eps=1e-8),
        np.array(R["removed"]), ratio_tol=R["ratio"])


def xlstm_step_bound(smi, label, cfg, res) -> None:
    """The decode state's bytes and a step's byte bound on xLSTM: the bf16
    weights but the embedding's, its B rows, and every state read and
    written (f32: an mLSTM block's C, n and m, an sLSTM block's c, n, h
    and m), beside `roofline_line` (whose cache term reads the mLSTM's C
    and the sLSTM's states once, held to the caches' bytes)."""
    from repro_torch.models.transformer import init_caches, layout_of, param_shapes

    _, n_units = layout_of(cfg)
    B = XLSTM_DECODE["batch"]
    meta = init_caches(cfg, B, 1, device="meta")
    state = {pos: sum(v.numel() * v.element_size() for v in c.values())
             for pos, c in meta.items()}
    mem = meta["u0"]["C"].numel() * 4
    shapes = param_shapes(cfg)
    p = sum(math.prod(v) for v in shapes.values())
    weights = p - math.prod(shapes["embed"]) + B * cfg.d_model
    step_bytes = 2 * weights + 2 * sum(state.values())
    bound, _ = bound_ms(step_bytes, 0.0)
    print(f"decode {label}: state bytes: mLSTM {state['u0']} (C {mem}: {n_units} "
          f"blocks x B {B} x {cfg.n_heads} heads x 512 x 512 f32), sLSTM "
          f"{state['u1']}; a step moves {step_bytes / 1e9:.3f} GB (bf16 weights "
          f"{2 * weights / 1e9:.3f} GB, the states read and written): byte bound "
          f"{bound:.4f} ms against {res['ms_per_token']:.4f} ms a step "
          f"({res['ms_per_token'] / bound:.1f}x) | {smi}", flush=True)
    cost = roofline_line(smi, f"decode {label}", cfg, "decode", B,
                         XLSTM_DECODE["prompt"] + XLSTM_DECODE["gen"],
                         res["ms_per_token"], bound)
    if mem != n_units * 67_108_864:  # all 12 units: 805,306,368
        fail(f"decode {label}: the mLSTM's C holds {mem} bytes, want "
             f"{n_units * 67_108_864}")
    if cost.breakdown["bytes_cache"] != mem + state["u1"]:
        fail(f"decode {label}: analytic_cost's cache term "
             f"{cost.breakdown['bytes_cache']} is not the mLSTM's C and the "
             f"sLSTM's states ({mem + state['u1']})")


def xlstm_deltagrad(torch, np, dev, kernels, smi, dtype=None, main_path=True):
    """18 (d): DeltaGrad on xlstm-350m at full width and 2 of its 24 layers
    (cut by time; on the main path also T 8 and j0 4, `LM_TIME_CUT`), on
    phase 9's recipe and main path, with per-block remat
    (`XLSTM_LM`), in the compute `dtype` (None: the model's bf16), through
    `stack_deltagrad`.  The replay is not profiled: its sLSTM steps launch
    ~27 kernels each, 512 a block a forward pass, ~1 M a replay.
    ``--xlstm-dg f32`` runs this alone in f32 compute (`main_path`
    False).  Returns the config, registered for the train CLI."""
    cut, note = XLSTM_LM, "1 of 12 units, cut by time"
    if main_path:
        cut, note = dict(XLSTM_LM, **LM_TIME_CUT), note + "; T and j0 cut by time"
    return stack_deltagrad(torch, np, dev, kernels, smi, "xlstm-350m", "xlstm lm",
                           cut, XLSTM_DG_BAR, note, dtype=dtype, main_path=main_path)


def hybrid_deltagrad(torch, np, dev, kernels, smi, dtype=None, main_path=True):
    """17 (d): DeltaGrad on zamba2-7b at full width, 1 of its 13 units (6
    blocks), on phase 9's recipe and main path (``attn_impl="flash"``,
    which the windowed shared block never reaches; a host f32 history)
    cut to T 10 and j0 4 by host memory (on the main path to T 8 by time,
    `LM_TIME_CUT`) and to windows of one step and
    per-block remat by the card's (`HYBRID_LM`), in the compute `dtype`
    (None: the model's bf16), through `stack_deltagrad`; on the main path
    the replay runs under the profiler.  ``--hybrid-dg f32`` runs this
    alone in f32 compute (`main_path` False).  Returns the 6-layer config,
    registered for the train CLI."""
    cut = dict(HYBRID_LM, **LM_TIME_CUT) if main_path else HYBRID_LM
    note = (f"1 of 13 units; cut from T {LM['steps']}, j0 {LM_DG['burn_in']}"
            + (" by host memory and time" if main_path else " by host memory"))
    return stack_deltagrad(torch, np, dev, kernels, smi, "zamba2-7b", "hybrid lm",
                           cut, HYBRID_DG_BAR, note, dtype=dtype,
                           main_path=main_path, profile=main_path)


def whisper_phase(torch, np, dev, kernels) -> None:
    """Phase 19: the encoder-decoder family (whisper-large-v3) at its
    published widths through the model facade's three paths, decode
    (`encode` -> `fill_cross_caches` -> `generate`, 32 + 16 of the 32 + 32
    layers, and `decode_main`'s audio branch), the DeltaGrad objective (train ->
    BaseL -> replay, 2 + 2 layers) and the train CLI (2 + 2 layers), each
    run with the launch counts zeroed just before and read after; and the
    card against the port's CPU run.  The decoder's causal self-attention
    takes the flash kernel on every full-sequence forward pass; the
    encoder's bidirectional attention and the cross-attention are
    blockwise, as in the reference."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, register
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    print(f"whisper: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    marks = [t_phase]

    def lap(part: str) -> None:  # where the phase's time goes
        marks.append(time.perf_counter())
        print(f"whisper: {part} took {marks[-1] - marks[-2]:.1f} s", flush=True)

    # (a) the 32 encoder layers and 16 of the 32 decoder layers
    # (WHISPER_DECODE, cut by time) against 1500 encoded frames; (b)
    # prefill_fn against the stepped decode, bf16 and f32
    cfg = get_config("whisper-large-v3")
    dcfg = register(dc.replace(cfg, name=f"{cfg.name}-{WHISPER_DECODE['layers']}d",
                               n_layers=WHISPER_DECODE["layers"]))
    res = whisper_decode(torch, np, dev, kernels, smi, dcfg)
    lap(f"(a) encode and decode at {dcfg.n_encoder_layers} + {dcfg.n_layers} layers")
    whisper_prefill(torch, dev, kernels, smi, dcfg, res)
    del res
    gc_collect()
    lap("(b) prefill_fn")
    # the reference's CLI: decode_main against 64 zero cross K/V slots, at
    # 1 + 1 layers (the CLI's audio branch; (a) is the depth's reading)
    one = register(dc.replace(cfg, name=f"{cfg.name}-1l", n_layers=1, n_encoder_layers=1))
    out, n = counted_run(kernels, lambda: serve.decode_main(
        ["--arch", one.name, "--batch", "4", "--prompt-len", "16", "--gen", "8"]))
    cross = out["params"]["dec"]["cross"]["wk"]
    print(f"decode {one.name} (decode_main's audio branch, 64 zero cross K/V "
          f"slots): tokens {out['tokens'].shape} finite logits "
          f"{bool(torch.isfinite(out['prompt_logits']).all())} launches {json.dumps(n)}",
          flush=True)
    if (sum(n.values()) or out["tokens"].shape != (4, 8) or cross.dtype != torch.bfloat16
            or not bool(torch.isfinite(out["prompt_logits"]).all())):
        fail(f"decode {one.name}: decode_main's audio branch: launches {n}, "
             f"tokens {out['tokens'].shape}")
    del out, cross
    gc_collect()

    # (c) the card against the port's CPU run: full width at 1 + 1 layers in
    # bf16, the reduced model in f32, each decoding against encoded frames
    decode_cpu_parity(torch, np, dev, smi, one, fill=whisper_fill(np, WHISPER_PARITY_FRAMES))
    rcfg = cfg.reduced()
    mx, same = reduced_f32_parity(torch, np, dev, rcfg, fill=whisper_fill(np, 48))
    print(f"whisper card vs cpu, reduced {cfg.name} in f32 (2 + 2 layers, d_model "
          f"{rcfg.d_model}, 48 frames, B {MOE_PARITY['batch']}, {MOE_PARITY['prompt']} "
          f"+ {MOE_PARITY['gen']} tokens): logits max |gap| {mx:.6e} (tol "
          f"{WHISPER_F32_TOL}: bf16 caches); greedy tokens equal: {same}", flush=True)
    if not (mx <= WHISPER_F32_TOL and same):
        fail(f"whisper card vs cpu reduced f32: logits {mx:.3e}, tokens equal {same}")
    lap("(c) card against CPU")

    # (d) DeltaGrad at 2 + 2 layers; (e) the train CLI at that cut
    lcfg = stack_deltagrad(torch, np, dev, kernels, smi, cfg.name, "whisper lm",
                           WHISPER_LM, WHISPER_DG_BAR, "2 + 2 of 32 + 32 layers")
    lap(f"(d) DeltaGrad at {WHISPER_LM['layers']} + {WHISPER_LM['layers']} layers")
    train_resume(torch, np, kernels, smi, lcfg, WHISPER_LM["n_params"],
                 flash_per_step=WHISPER_LM["layers"], run=WHISPER_TRAIN)
    lap("(e) the train CLI, resumed")
    print(f"whisper: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)


def whisper_fill(np, frames: int, seed: int = 3):
    """The parity helpers' `fill` for an encoder-decoder: `frames` frames
    N(0, 1) (from `seed`, the same on both devices) encoded in the compute
    dtype, and caches of `slots` self-attention slots with the memory's
    cross K/V (`encdec.fill_cross_caches`)."""
    def fill(model, params, where, batch, slots, dtype):
        import torch

        from repro_torch.models import encdec
        from repro_torch.models.transformer import cast_params
        from repro_torch.utils.tree import nested

        x = np.random.default_rng(seed).standard_normal(
            (batch, frames, model.cfg.d_model), dtype=np.float32)
        mem = encdec.encode(cast_params(nested(params), dtype),
                            torch.from_numpy(x).to(where).to(dtype), model.cfg)
        caches = model.cache_init(batch, slots, enc_len=0, device=where)
        caches["cross_k"], caches["cross_v"] = encdec.fill_cross_caches(params, mem, model.cfg)
        return caches

    return fill


def whisper_decode(torch, np, dev, kernels, smi, cfg) -> dict:
    """19 (a): whisper-large-v3's config `cfg` (32 encoder and 16 decoder
    layers), B 16: the f32 master
    weights cast once to bf16 (as `decode_main` does), 1500 frames N(0, 1)
    encoded once, the cross caches filled, then `generate` over a 128
    prompt and 64 greedy tokens, under flash, with the launch counts
    zeroed just before and read after (the encoder and the stepped decode
    launch none).  Prints tokens/s, ms a step against the step's byte
    bound, memory, the cross caches' bytes, and a profile of one step
    (launches, busy share).  Returns what (b) needs."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.models.registry import build, param_shapes
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import flatten_nested, nested

    W = WHISPER_DECODE
    B, P, G, S_enc = W["batch"], W["prompt"], W["gen"], W["frames"]
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = cast_params(nested(model.init(seed=0, device=dev)), torch.bfloat16)
    gc_collect()
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((B, S_enc, cfg.d_model),
                                                  dtype=np.float32)).to(dev)
    prompt = rng.integers(0, cfg.vocab, size=(B, P), dtype=np.int32)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mem = encdec.encode(params, frames.to(torch.bfloat16), cfg)
        caches = model.cache_init(B, P + G, enc_len=0, device=dev)
        caches["cross_k"], caches["cross_v"] = encdec.fill_cross_caches(params, mem, cfg)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        out = serve.generate(model, params, prompt, G, device=dev, caches=caches)
        return out, enc_s, caches

    with use_attention_impl("flash"), torch.no_grad():
        (res, enc_s, caches), n = counted_run(kernels, run)
    peak = torch.cuda.max_memory_allocated()
    p = sum(x.numel() for x in flatten_nested(params).values())
    cross_bytes = sum(caches[k].numel() * caches[k].element_size()
                      for k in ("cross_k", "cross_v"))
    shapes = param_shapes(cfg)
    dec_w = sum(math.prod(v) for k, v in shapes.items() if k.startswith("dec/"))
    kv = sum(caches["self"][k].numel() * 2 for k in ("k", "v"))
    # the caches read: analytic_cost's cache term (held to them below)
    cost = run_cost(cfg, "decode", B, P + G)
    step_bytes = (2 * (dec_w + math.prod(shapes["lm_head"]) + B * cfg.d_model)
                  + cost.breakdown["bytes_cache"])
    bound, _ = bound_ms(step_bytes, 0.0)
    ms = res["gen_s"] * 1e3 / G
    print(f"decode {cfg.name} {cfg.n_encoder_layers} + {cfg.n_layers} layers: "
          f"p={p} ({p * 4 / 1e9:.3f} GB f32 master, cast once to {p * 2 / 1e9:.3f} "
          f"GB bf16) B={B} frames={S_enc} prompt={P} gen={G} greedy: encode + "
          f"fill_cross_caches {enc_s:.4f} s, stepped prefill_s={res['prefill_s']:.4f} "
          f"generate_s={res['gen_s']:.4f} tokens/s={B * G / res['gen_s']:.2f} "
          f"ms/token={ms:.4f} (per decode step of the batch); a step moves "
          f"{step_bytes / 1e9:.3f} GB (decoder bf16 weights {2 * dec_w / 1e9:.3f} GB, "
          f"the head {2 * math.prod(shapes['lm_head']) / 1e9:.3f} GB, the self KV "
          f"caches {kv / 1e9:.3f} GB, the cross K/V {cross_bytes} bytes): byte bound "
          f"{bound:.4f} ms ({ms / bound:.1f}x) max_memory_allocated={peak} "
          f"launches {json.dumps(n)} | {smi}", flush=True)
    roofline_line(smi, f"decode {cfg.name} {cfg.n_encoder_layers} + {cfg.n_layers} "
                  "layers", cfg, "decode", B, P + G, ms, bound, cost=cost)
    if p != W["n_params"] or cross_bytes != W["cross_bytes"]:
        fail(f"decode {cfg.name}: p = {p}, cross K/V {cross_bytes} bytes, want "
             f"{W['n_params']} and {W['cross_bytes']}")
    if cost.breakdown["bytes_cache"] != kv + cross_bytes:
        fail(f"decode {cfg.name}: analytic_cost's cache term "
             f"{cost.breakdown['bytes_cache']} is not the self and cross caches' "
             f"{kv + cross_bytes} bytes")
    if sum(n.values()):
        fail(f"decode {cfg.name}: encode and the stepped decode launched {n}; "
             "their attention is blockwise and plain contractions")
    ok = (res["tokens"].shape == (B, G) and bool(torch.isfinite(res["prompt_logits"]).all())
          and ((0 <= res["tokens"]) & (res["tokens"] < cfg.vocab)).all())
    if not ok:
        fail(f"decode {cfg.name}: tokens {res['tokens'].shape} or logits not finite")
    # where a step's time goes: one step under the profiler
    one = model.cache_init(B, 1, enc_len=0, device=dev)
    one["cross_k"], one["cross_v"] = caches["cross_k"], caches["cross_v"]
    _, prof = profile_run(torch, lambda: serve.generate(
        model, params, prompt[:, :1], 0, device=dev, caches=one))
    print(f"decode {cfg.name} profile, 1 step: wall_ms={prof['wall_ms']:.3f} (under "
          f"the profiler) device_busy_ms={prof['busy_us'] / 1e3:.3f} busy_share="
          f"{prof['busy_us'] / 1e3 / prof['wall_ms']:.3f} cudaLaunchKernel="
          f"{prof['launches_host']} | {smi}", flush=True)
    return {"model": model, "params": params, "frames": frames, "prompt": prompt,
            "prompt_logits": res["prompt_logits"]}


def whisper_prefill(torch, dev, kernels, smi, cfg, res) -> None:
    """19 (b): `prefill_fn` (the encoder over the frames, the decoder over
    the prompt) against (a)'s stepped decode, under flash (held: one flash
    launch a decoder layer, none in the encoder) and under blockwise
    (none), in bf16 at WHISPER_PREFILL_TOL; then in f32 compute from the
    f32 master weights (seed 0), the stepped decode's caches filled from
    the same frames, at WHISPER_PREFILL_F32.  Both forms hold bf16 caches
    (the reference's design), so the f32 gap is the caches' rounding."""
    from repro_torch.models import encdec
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.models.transformer import cast_params
    from repro_torch.utils.tree import nested

    model, prompt = res["model"], torch.from_numpy(res["prompt"]).to(dev)
    batch = {"frames": res["frames"], "tokens": prompt}
    for impl in ("flash", "blockwise"):
        with use_attention_impl(impl):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, n = counted_run(kernels, lambda: model.prefill_fn(res["params"], batch))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        gap = (got - res["prompt_logits"]).abs()
        mx, mean = gap.max().item(), gap.mean().item()
        tol = WHISPER_PREFILL_TOL
        print(f"decode {cfg.name} prefill_fn {impl}: {ms:.3f} ms for {tuple(prompt.shape)} "
              f"tokens and {tuple(res['frames'].shape[:2])} frames; against the stepped "
              f"decode's last logits max |gap| {mx:.6e} mean {mean:.6e} (tol "
              f"{tol['max']} / {tol['mean']}); flash launches {n['flash_attention']} "
              f"| {smi}", flush=True)
        if not (mx <= tol["max"] and mean <= tol["mean"]):
            fail(f"decode {cfg.name}: prefill_fn ({impl}) against the stepped decode: "
                 f"max {mx:.3e} mean {mean:.3e}")
        want = cfg.n_layers if impl == "flash" else 0
        if n["flash_attention"] != want or sum(n.values()) != want:
            fail(f"decode {cfg.name}: prefill_fn ({impl}) launched {n}, want {want} "
                 "flash launches and nothing else")
    del res["params"]
    gc_collect()
    # f32 compute: the uncast master weights
    n_tok, bar = WHISPER_PREFILL_F32["prompt"], WHISPER_PREFILL_F32
    params = model.init(seed=0, device=dev)
    with torch.no_grad():
        mem = encdec.encode(cast_params(nested(params), torch.float32),
                            res["frames"], cfg)
        caches = model.cache_init(prompt.shape[0], n_tok, enc_len=0, device=dev)
        caches["cross_k"], caches["cross_v"] = encdec.fill_cross_caches(params, mem, cfg)
        del mem
        for t in range(n_tok):
            logits, caches = model.decode_fn(params, {"tokens": prompt[:, t:t + 1]},
                                             caches, dtype=torch.float32)
    pre = model.prefill_fn(params, {"frames": res["frames"], "tokens": prompt[:, :n_tok]},
                           dtype=torch.float32)
    gap = (pre - logits).abs()
    mx, mean = gap.max().item(), gap.mean().item()
    print(f"decode {cfg.name} prefill_fn f32 compute, {n_tok} tokens: against the "
          f"stepped f32 decode's last logits max |gap| {mx:.6e} mean {mean:.6e} (tol "
          f"{bar['max']} / {bar['mean']}: bf16 caches) | {smi}", flush=True)
    if not (mx <= bar["max"] and mean <= bar["mean"]):
        fail(f"decode {cfg.name}: f32 prefill_fn against the stepped decode: max "
             f"{mx:.3e} mean {mean:.3e}")
    del params, caches, pre, logits


def stack_deltagrad(torch, np, dev, kernels, smi, arch, tag, cut, bars, note,
                    dtype=None, main_path=True, profile=False):
    """DeltaGrad on `arch` at full width and cut["layers"] layers, on phase
    9's recipe and main path (``attn_impl="flash"``; a host f32 history),
    with the cut's T, j0, window and remat where it names them (phase 9's
    where not), in the compute `dtype` (None: the model's bf16).  On the
    main path the replay runs once with the launch counts zeroed just
    before and read after (under the profiler if `profile`), and the three
    replay kernels are held against their plain versions at this p.  Held:
    cut.get("flash_per_forward", 0) flash launches a forward pass (none
    where no plain attention block is reached) and no dequant launch (the
    f32 history is fetched), each replay kernel launched once per
    approx step (at least once where the guard sent a segment back), and
    d_ui < d_us where both packages meet it on the CPU (``bars[dtype]``
    True; else recorded).  Returns the cut config, registered for the
    train CLI."""
    import dataclasses as dc

    from repro_torch.configs.registry import register
    from repro_torch.core import deltagrad as dg

    what = "bf16" if dtype is None else "f32"
    print(f"{tag}: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    cfg, model, p0, docs, meta, dgc, removed, obj = lm_setup(
        torch, np, dev, arch, dtype, layers=cut["layers"],
        steps=cut.get("steps", LM["steps"]),
        burn_in=cut.get("burn_in", LM_DG["burn_in"]),
        window=cut.get("window", LM_DG["stream_window"]), remat=cut["remat"],
        seq=cut.get("seq", LM["seq"]), frames=cut.get("frames", 0))
    lcfg = register(dc.replace(cfg, name=f"{cfg.name}-{cfg.n_layers}l"))
    if p0.numel != cut["n_params"]:
        fail(f"{tag}: p = {p0.numel}, want {cut['n_params']}")
    print(f"{tag}: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} of "
          f"{cfg.head_dim} unit={cfg.layout_unit} layers={cfg.n_layers} "
          f"encoder_layers={cfg.n_encoder_layers} frames={cut.get('frames', 0)} "
          f"({note}) vocab={cfg.vocab} p={p0.numel} ({p0.numel * 4 / 1e9:.3f} GB a "
          f"f32 vector) {what} compute docs={LM['docs']}x{cut.get('seq', LM['seq'])} "
          f"B={LM['batch']} "
          f"T={meta.steps} T0={dgc.period} j0={dgc.burn_in} m={dgc.history_size} "
          f"window={dgc.stream_window} removed={removed.tolist()}; the host f32 "
          f"history needs {meta.steps * 2 * p0.numel * 4 / 1e9:.1f} GB; "
          f"remat={cut['remat']}", flush=True)
    forwards = count_forwards(obj)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                           codec="f32", window=dgc.stream_window)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    w_u, st_u = dg.baseline_retrain(obj, docs, meta, p0, removed)
    torch.cuda.reset_peak_memory_stats()
    forwards[0] = 0

    def replay():
        return dg.deltagrad_retrain(obj, hist, docs, removed, dgc)

    label = f"{tag} {what} compute, f32 host"
    with bv_ratios() as ratios:
        (w_i, st), n = counted_run(kernels, (lambda: profile_replay(
            torch, f"{label} replay", replay)) if profile else replay)
    peak = torch.cuda.max_memory_allocated()
    d_ui = (w_u.flat - w_i.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    print(replay_line(label, train_s, st_u, st, d_ui, d_us, ratios, dgc)
          + (" (replay_s under the profiler)" if profile else "")
          + f" max_memory_allocated (train)={train_peak} (replay)={peak} "
          f"host_bytes={hist.nbytes()} forward_passes={forwards[0]} launches "
          f"{json.dumps(n)}; MemAvailable {mem_available_gb():.1f} GiB with the "
          f"history | {smi}", flush=True)
    if not (bool(torch.isfinite(w_i.flat).all()) and w_i.numel == cut["n_params"]):
        fail(f"{tag}: replay parameters are not finite of the expected shape")
    held = bars[what]
    print(f"{tag} {what} compute: d_ui/d_us = {d_ui / d_us:.4e}: "
          + ("below the bar of 1" if d_ui < d_us else "MISSES the bar of 1")
          + (" (held)" if held is True else f" (recorded, not held; {held})"),
          flush=True)
    if held is True and not d_ui < d_us:
        fail(f"{tag} {what}: d_ui {d_ui:.3e} not below d_us {d_us:.3e}")
    if st.approx_steps <= 0:
        fail(f"{tag}: the replay took no approx step")
    want_flash = cut.get("flash_per_forward", 0) * forwards[0]
    if n["flash_attention"] != want_flash or n["dequant_update"] or n["dequant_sub"]:
        fail(f"{tag}: launches {n}: want {want_flash} flash launches "
             f"({cut.get('flash_per_forward', 0)} a forward pass) and no dequant "
             "launch (the f32 history is fetched)")
    check_replay_launches(tag, n, st)
    del w_star, w_u, w_i, p0, hist, obj, model
    gc_collect()
    if main_path:
        replay_kernels_at(torch, dev, cut["n_params"], label=tag)
    return lcfg


def decode_run(torch, kernels, smi, label, cfg, run, roofline=True) -> dict:
    """`launch.serve.decode_main` on `cfg` (registered) at ``run``'s batch,
    prompt and gen under flash, with the launch counts zeroed just before
    and read after: prints its times, memory and launches against the
    bf16 weights' byte bound (and, with `roofline`, `roofline_line` beside
    it), holds p and the stepped decode's launches, and returns its
    results."""
    from repro_torch.launch import serve
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.utils.tree import flatten_nested

    argv = ["--arch", cfg.name, "--batch", str(run["batch"]),
            "--prompt-len", str(run["prompt"]), "--gen", str(run["gen"])]
    torch.cuda.reset_peak_memory_stats()
    with use_attention_impl("flash"):
        res, n = counted_run(kernels, lambda: serve.decode_main(argv))
    peak = torch.cuda.max_memory_allocated()
    flat = flatten_nested(res["params"])
    p = sum(x.numel() for x in flat.values())
    dtypes = {x.dtype for x in flat.values()}
    # a step reads every bf16 weight once, and of an untied embedding only
    # its B rows
    read = p - (0 if cfg.tie_embeddings else
                flat["embed"].numel() - run["batch"] * cfg.d_model)
    bound, _ = bound_ms(read * 2, 0.0)
    print(f"decode {label}: p={p} ({p * 4 / 1e9:.3f} GB f32 master, cast "
          f"once to {p * 2 / 1e9:.3f} GB bf16; a step reads "
          f"{read * 2 / 1e9:.3f} GB) B={run['batch']} "
          f"prompt={res['prompt'].shape[1]} gen={run['gen']} greedy: stepped "
          f"prefill_s={res['prefill_s']:.4f} generate_s={res['gen_s']:.4f} "
          f"tokens/s={res['tok_s']:.2f} ms/token={res['ms_per_token']:.4f} "
          f"(per decode step of the batch; byte bound {bound:.4f} ms) "
          f"max_memory_allocated={peak} launches {json.dumps(n)} | {smi}",
          flush=True)
    if roofline:
        roofline_line(smi, f"decode {label}", cfg, "decode", run["batch"],
                      run["prompt"] + run["gen"], res["ms_per_token"], bound)
    if p != run["n_params"] or dtypes != {torch.bfloat16}:
        fail(f"decode {label}: p = {p} in {dtypes}, want {run['n_params']} in bf16")
    if sum(n.values()):
        fail(f"decode {label}: the stepped decode launched {n}; its "
             "attention is plain contractions")
    ok = (res["tokens"].shape == (run["batch"], run["gen"])
          and bool(torch.isfinite(res["prompt_logits"]).all())
          and ((0 <= res["tokens"]) & (res["tokens"] < cfg.vocab)).all())
    if not ok:
        fail(f"decode {label}: tokens {res['tokens'].shape} or logits not finite")
    return res


def prefill_check(torch, dev, kernels, smi, label, model, res, layers,
                  tol=PREFILL_TOL, moe_cfg=None) -> None:
    """`prefill_fn` on `decode_run`'s prompt under flash and blockwise:
    its time, its launches (held: one flash launch a layer under flash for
    a GQA model, none for MLA or for a windowed attention (the hybrid's
    shared block), whose attention is blockwise whatever the switch, and
    none under blockwise), and its last logits against the
    stepped decode's, held to `tol` (None: recorded only).  An xLSTM
    unit has no attention block, so no flash launch either.  For an MoE model
    (`moe_cfg`) also flash against blockwise: both route the B*S tokens as
    one group, so only the attention differs; see `moe_prefill_pair`."""
    from repro_torch.models import moe
    from repro_torch.models.attention_config import use_attention_impl
    from repro_torch.models.transformer import layout_of

    prompt = torch.from_numpy(res["prompt"]).to(dev)
    want = res["prompt_logits"]
    logits, routes = {}, {}
    for impl in ("flash", "blockwise"):
        with use_attention_impl(impl):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[impl], route = [], moe.route

            def recording(params, x, k):  # each layer's top-k, in order
                out = route(params, x, k)
                routes[impl].append(out[2])
                return out

            if moe_cfg is not None:
                moe.route = recording
            try:
                got, n = counted_run(kernels, lambda: model.prefill_fn(
                    res["params"], {"tokens": prompt}))
            finally:
                moe.route = route
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        logits[impl] = got
        gap = (got - want).abs()
        mx, mean = gap.max().item(), gap.mean().item()
        bar = (f"tol {tol['max']} / {tol['mean']}" if tol else
               "recorded, not held")
        print(f"decode {label} prefill_fn {impl}: {ms:.3f} ms for "
              f"{tuple(prompt.shape)} tokens; against the stepped decode's "
              f"last logits max |gap| {mx:.6e} mean {mean:.6e} ({bar}); flash "
              f"launches {n['flash_attention']} | {smi}", flush=True)
        if tol and not (mx <= tol["max"] and mean <= tol["mean"]):
            fail(f"decode {label}: prefill_fn ({impl}) against the stepped "
                 f"decode: max {mx:.3e} mean {mean:.3e}")
        # flash takes only a GQA block's causal attention without a window
        flash = (impl == "flash" and model.cfg.mla is None and not model.cfg.attn_window
                 and "attn" in layout_of(model.cfg)[0])
        want_launches = layers if flash else 0
        if n["flash_attention"] != want_launches or sum(n.values()) != want_launches:
            fail(f"decode {label}: prefill_fn ({impl}) launched {n}, want "
                 f"{want_launches} flash launches and nothing else")
    if moe_cfg is not None:
        moe_prefill_pair(torch, smi, label, moe_cfg, logits, routes, layers)


def moe_prefill_pair(torch, smi, label, cfg, logits, routes, layers) -> None:
    """An MoE `prefill_fn` under flash against blockwise, the same prompt
    and the same token group: a token whose k-th and (k+1)-th router
    probabilities are closer than the two attentions' rounding moves them
    routes differently (a flip: its top-k, or a choice's slot kept or
    dropped, differs in some layer), and a flip at a row's last token
    changes that row's whole last FFN output.  A flip also moves the
    token's hidden state, which later tokens of its row attend to and
    route on, so flips grow layer by layer.  Held to `PREFILL_TOL` on the
    rows whose last token flips in no layer (there must be one); the
    flips are counted per layer."""
    from repro_torch.models import moe

    B = logits["flash"].shape[0]
    flips = []  # per layer: (B, S) tokens routed differently
    for a, b in zip(routes["flash"], routes["blockwise"]):
        G, T, k = a.shape
        kept = [moe.slot_ranks(r.reshape(G, T * k), cfg.num_experts).reshape(
            G, T, k) < moe.capacity_of(cfg, T) for r in (a, b)]
        flips.append(((a != b) | (kept[0] != kept[1])).any(-1).reshape(B, -1))
    if len(flips) != layers:
        fail(f"decode {label}: {len(flips)} routed layers in prefill_fn, want {layers}")
        return
    flips = torch.stack(flips)  # (layers, B, S)
    last = flips[:, :, -1].any(0)  # (B,) rows whose last token flips
    gap = (logits["flash"] - logits["blockwise"]).abs().amax(-1)  # (B,)
    mean = (logits["flash"] - logits["blockwise"]).abs().mean(-1)
    held = ~last
    mx_h = gap[held].max().item() if held.any() else float("nan")
    mean_h = mean[held].mean().item() if held.any() else float("nan")
    print(f"decode {label} prefill_fn flash vs blockwise (one group of "
          f"{flips.shape[1] * flips.shape[2]} tokens): {int(flips.sum())} of "
          f"{flips.numel()} token-layers routed differently (by layer "
          f"{flips.sum((1, 2)).tolist()}), in "
          f"{int(flips.any(0).any(-1).sum())} of {B} rows; {int(last.sum())} "
          f"rows' last token; last logits max |gap| {gap.max().item():.6e} "
          f"mean {mean.mean().item():.6e} over all rows, {mx_h:.6e} / "
          f"{mean_h:.6e} over the {int(held.sum())} rows whose last token "
          f"routes alike (tol {PREFILL_TOL['max']} / {PREFILL_TOL['mean']}) "
          f"| {smi}", flush=True)
    if not (held.any() and mx_h <= PREFILL_TOL["max"]
            and mean_h <= PREFILL_TOL["mean"]):
        fail(f"decode {label}: prefill_fn flash vs blockwise over "
             f"{int(held.sum())} of {B} rows: max {mx_h:.3e} mean {mean_h:.3e}")


def decode_profile(torch, dev, smi, label, model, res, steps: int = 8) -> None:
    """Where a decode step's time goes: `steps` stepped tokens of
    `decode_run`'s prompt under the profiler."""
    from repro_torch.launch import serve

    _, prof = profile_run(torch, lambda: serve.generate(
        model, res["params"], res["prompt"][:, :steps], 0, device=dev))
    print(f"decode {label} profile, {steps} steps: "
          f"wall_ms={prof['wall_ms']:.3f} (under the profiler) "
          f"device_busy_ms={prof['busy_us'] / 1e3:.3f} busy_share="
          f"{prof['busy_us'] / 1e3 / prof['wall_ms']:.3f} cudaLaunchKernel="
          f"{prof['launches_host']} ({prof['launches_host'] / steps:.1f} a step) "
          f"| {smi}", flush=True)


def profile_replay(torch, label: str, run):
    """One replay (`run()` -> (params, stats)) under the profiler: prints
    its device busy share, launches, host waits and top device ops, and
    returns `run()`'s result."""
    out, prof = profile_run(torch, run)
    st_p = out[1]
    wall_ms, busy_us, rows = prof["wall_ms"], prof["busy_us"], prof["rows"]
    if busy_us <= 0:
        print(f"profile {label}: the profiler recorded no device time "
              "(busy share not measured)")
        return out
    waits = ""
    if "host_wait_s" in st_p.extra:
        waits = (f" host_wait_ms={st_p.extra['host_wait_s'] * 1e3:.3f} "
                 f"windows={st_p.extra['windows']}")
    print(f"profile {label}: wall_ms={wall_ms:.3f} (under the profiler) "
          f"device_busy_ms={busy_us / 1e3:.3f} "
          f"busy_share={busy_us / 1e3 / wall_ms:.3f} "
          f"device_ops={prof['device_ops']} "
          f"cudaLaunchKernel={prof['launches_host']}{waits}")
    for name, us, count in rows[:12]:
        print(f"profile {label}: device {us / 1e3:9.3f} ms x{count:<5d} {name[:70]}")
    return out


def profile_run(torch, fn):
    """fn() under torch.profiler (CPU and CUDA activity): (fn's result,
    {wall_ms, busy_us (the union of the device's busy spans), device_ops,
    launches_host (cudaLaunchKernel calls), rows ((name, device us, count)
    of each device op, the most device time first)}).  It reads the
    profiler's raw events: building its event tree (`events()`,
    `key_averages()`) took 10-40 s after an LM replay's ~10^5 device ops,
    and the raw events give the same spans, names and counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, ops, launches = [], {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start, us = e.start_ns() / 1e3, e.duration_ns() / 1e3
            spans.append((start, start + us))
            total, count = ops.get(e.name(), (0.0, 0))
            ops[e.name()] = (total + us, count + 1)
        elif e.name() == "cudaLaunchKernel":
            launches += 1
    spans.sort()
    busy_us, end_us = 0.0, float("-inf")
    for a, b in spans:
        if b > end_us:
            busy_us += b - max(a, end_us)
            end_us = b
    rows = sorted(((name, us, count) for name, (us, count) in ops.items()),
                  key=lambda r: -r[1])
    return out, {"wall_ms": wall_ms, "busy_us": busy_us,
                 "device_ops": len(spans), "rows": rows,
                 "launches_host": launches}


def gc_collect() -> None:
    """Free what an earlier phase left: host arrays, cached device blocks
    and cached pinned host blocks (PyTorch keeps the host tier's freed
    staging buffers, in power-of-two sizes that a later p does not reuse)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()


def counted_run(kernels, fn):
    """fn() with every kernel's launch count set to 0 just before and read
    just after: (fn's result, {kernel: launches})."""
    for k in kernels.values():
        k["wrapper"].launches = 0
    out = fn()
    return out, {n: k["wrapper"].launches for n, k in kernels.items()}


def count_forwards(obj) -> list:
    """Make `obj` count the model's forward passes: each call of its per-row
    loss adds one to the returned one-element counter."""
    forwards, per_row = [0], obj.per_example_loss

    def counted(params, batch):
        forwards[0] += 1
        return per_row(params, batch)

    obj.per_example_loss = counted
    return forwards


@contextlib.contextmanager
def bv_ratios():
    """Each B v's ||Bv|| / ||v|| while the block runs, read from the output
    of the engine's B v (multidot, solve, rank_update) as device scalars,
    and turned into floats in the yielded list when the block ends."""
    from repro_torch.core import engine

    ratios, plain = [], engine.lbfgs_hvp_fused

    def recording(dW, dG, v, valid=None):
        out = plain(dW, dG, v, valid)
        ratios.append(out.norm() / v.norm())
        return out

    engine.lbfgs_hvp_fused = recording
    try:
        yield ratios
    finally:
        engine.lbfgs_hvp_fused = plain
    ratios[:] = [r.item() for r in ratios]


def replay_line(label, train_s, st_u, st, d_ui, d_us, ratios, dgc) -> str:
    """A replay's numbers on one line: the times, the seven counters, the
    distances, each B v's ||Bv||/||v|| against the guard's clip, and the
    streamed store's counters."""
    x = st.extra
    return (f"{label}: train_s={train_s:.4f} baseline_s={st_u.wall_time_s:.4f} "
            f"replay_s={st.wall_time_s:.4f} "
            + " ".join(f"{k}={v}" for k, v in st.counters().items())
            + f" d_ui={d_ui:.6e} d_us={d_us:.6e} d_ui/d_us={d_ui / d_us:.4e} "
            f"||Bv||/||v|| {' '.join(f'{r:.4e}' for r in ratios)} (clip "
            f"{dgc.guard_norm_clip:g}) store={x['store']} windows={x['windows']} "
            f"host_wait_s={x['host_wait_s']:.4f} hbm_high_water={x['hbm_high_water']}")


def check_replay_launches(label: str, n: dict, st, names=RESIDENT) -> None:
    """Each of the replay's kernels `names` launched once per approx step,
    and at least once where the Algorithm-4 guard sent a segment back (its
    steps re-run as explicit steps)."""
    for k in names:
        if n[k] <= 0 or (st.guard_fallbacks == 0 and n[k] != st.approx_steps):
            fail(f"{label}: {k} launched {n[k]} times for {st.approx_steps} approx "
                 f"steps and {st.guard_fallbacks} guard fallbacks")


def logreg_phase(torch, np, dev, kernels, data) -> dict:
    """Phase 10: the paper's L2-regularised logistic regression at the
    LIBSVM rcv1.binary training shape (paper §4.1; synthetic features at
    that shape, dense f32 on the card), paper_logreg's recipe with B 4096
    and T 60: a delete and an add replay of r rows, and a heavy-ball
    (0.9) delete replay, each against BaseL on the changed data.  `data`
    is the future of (`timed`) `binary_classification` at that shape,
    drawn in the background since phase 2.  Returns the data set's first n
    rows (numpy) for phase 12."""
    from repro_torch.configs.paper_logreg import RECIPE
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.models.simple import (logreg_accuracy, logreg_init,
                                           logreg_objective)

    L = LOGREG
    t0 = time.perf_counter()
    ds, draw_s = data.result()
    wait_s = time.perf_counter() - t0
    cols = ds.device_columns(dev)
    cols["x"][-1, -1].item()  # the upload has landed
    print(f"logreg: rcv1.binary shape n={ds.n} d={L['d']} "
          f"({ds.columns['x'].nbytes / 1e9:.3f} GB f32 on the card) "
          f"B={L['batch']} T={L['steps']} r={L['r']} lr={RECIPE.lr} "
          f"l2={RECIPE.l2} T0={RECIPE.period} j0={RECIPE.burn_in} "
          f"m={RECIPE.history_size}; data set-up {time.perf_counter() - t0:.2f} s "
          f"(drawn in {draw_s:.2f} s in the background since phase 2, waited "
          f"{wait_s:.2f} s here)",
          flush=True)
    del cols
    obj = logreg_objective(l2=RECIPE.l2)
    p0 = logreg_init(L["d"], generator=torch.Generator().manual_seed(L["seed"]),
                     device=dev)
    cfg = dg.DeltaGradConfig(period=RECIPE.period, burn_in=RECIPE.burn_in,
                             history_size=RECIPE.history_size)
    changed = np.random.default_rng(L["seed"] + 1).choice(ds.n, size=L["r"],
                                                          replace=False)

    def meta(momentum=0.0, steps=L["steps"]):
        return HistoryMeta(n=L["n"], batch_size=L["batch"], seed=L["seed"],
                           steps=steps, lr_schedule=((0, RECIPE.lr),),
                           momentum=momentum)

    # warm-up, counted as set-up: cuBLAS, the solver, every kernel's first call
    _, h = dg.sgd_train_with_cache(obj, p0, ds, meta(steps=14), device=dev)
    dg.deltagrad_retrain(obj, h, ds, changed, cfg, device=dev)
    del h
    acc0 = logreg_accuracy(p0, ds)

    cpu = torch.device("cpu")

    def run(label, momentum, mode, trained=None):
        """Train (unless `trained` carries the card's and the CPU's
        (w*, history)), BaseL and the replay on the card, then the same
        replay in the port on the CPU, which the card's must equal."""
        m = meta(momentum)
        train_s = float("nan")
        if trained is None:
            ds.device_columns(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            w_star, hist = dg.sgd_train_with_cache(obj, p0, ds, m, device=dev)
            train_s = time.perf_counter() - t1
            trained = ((w_star, hist), dg.sgd_train_with_cache(
                obj, p0.to(cpu), ds, m, device=cpu))
        (w_star, hist), (_, hist_cpu) = trained
        ch = changed
        if mode == "add":  # the same rows again, appended
            ch = ds.append({k: c[changed] for k, c in ds.columns.items()})
        ds.device_columns(dev)  # the upload is set-up, not BaseL's time
        torch.cuda.synchronize()
        w_u, st_u = dg.baseline_retrain(obj, ds, m, p0, ch, mode=mode,
                                        device=dev)
        (w_i, st), n = counted_run(kernels, lambda: dg.deltagrad_retrain(
            obj, hist, ds, ch, cfg, mode=mode, device=dev))
        w_c, st_c = dg.deltagrad_retrain(obj, hist_cpu, ds, ch, cfg, mode=mode,
                                         device=cpu)
        gap = (w_i.flat.cpu() - w_c.flat).abs().max().item()
        same = st.counters() == st_c.counters()
        d_ui = (w_u.flat - w_i.flat).norm().item()
        d_us = (w_u.flat - w_star.flat).norm().item()
        print(f"logreg {label}: train_s={train_s:.4f} "
              f"baseline_s={st_u.wall_time_s:.4f} replay_s={st.wall_time_s:.4f} "
              + " ".join(f"{k}={v}" for k, v in st.counters().items())
              + f" theoretical_speedup={st.theoretical_speedup:.3f} "
              f"d_ui={d_ui:.6e} d_us={d_us:.6e} d_ui/d_us={d_ui / d_us:.4e} "
              f"accuracy w0={acc0:.4f} w*={logreg_accuracy(w_star, ds):.4f} "
              f"w_U={logreg_accuracy(w_u, ds):.4f} w_I={logreg_accuracy(w_i, ds):.4f} "
              f"card vs cpu: max |gap| {gap:.3e} (bar {PARITY_TOL}), ||gap||/d_ui "
              f"{(w_i.flat.cpu() - w_c.flat).norm().item() / d_ui:.3e}, counters "
              f"equal: {same}; launches {json.dumps(n)}", flush=True)
        if not (bool(torch.isfinite(w_i.flat).all()) and w_i.numel == L["d"] + 1):
            fail(f"logreg {label}: replay parameters are not finite of the "
                 "expected shape")
        if not (same and gap <= PARITY_TOL):
            fail(f"logreg {label}: card vs cpu gap {gap:.3e}, counters equal: "
                 f"{same}")
        # Theorem 1's direction for the SGD replays.  Its 0.5 is not held at
        # this shape (d 47,236 > n 20,242): the JAX package's own replay on
        # this recipe reads 0.35 to 3.62 (delete) at scaled copies of it
        # (tests/test_torch_models.py, run as a script), and the port's
        # equals it there to 1e-6.  The heavy-ball replay (the recipe's lr
        # 0.1, momentum 0.9) is recorded, not held: there the reference
        # reads 0.81 to 15
        if not momentum and not d_ui < d_us:
            fail(f"logreg {label}: d_ui {d_ui:.3e} not below d_us {d_us:.3e}")
        want = {"fused_update": 0 if momentum else st.approx_steps,
                "multidot": st.approx_steps, "rank_update": st.approx_steps}
        for k, v in want.items():
            if st.approx_steps <= 0 or n[k] != v:
                fail(f"logreg {label}: {k} launched {n[k]} times for "
                     f"{st.approx_steps} approx steps")
        return trained

    trained = run("delete", 0.0, "delete")
    run("momentum-0.9 delete", 0.9, "delete")
    run("add", 0.0, "add", trained=trained)  # appends: last
    return {k: v[:L["n"]] for k, v in ds.columns.items()}


def online_phase(torch, np, dev, kernels) -> None:
    """Phase 11: Algorithm 3 on logistic regression at bench_online.py's
    paper scale (n 8000, d 4000, T 60, B 4096, lr 0.3, T0 5, j0 10, m 2):
    8 delete requests, 8 add requests and a heavy-ball (0.9, lr 0.1) delete
    stream through `online_deltagrad`, each held against the port's CPU run of
    the same stream, and against BaseL on the changed data; then a
    host-tier delta_int8 delete stream in kernel mode against fetch mode."""
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.core.online import online_deltagrad
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import binary_classification
    from repro_torch.models.simple import logreg_init, logreg_objective

    O = ONLINE
    obj = logreg_objective(l2=O["l2"])
    cfg = dg.DeltaGradConfig(period=O["period"], burn_in=O["burn_in"],
                             history_size=O["m"])

    # every stream starts from the same draw (append builds new arrays, so
    # no stream sees another's rows); drawn once, not for each stream
    base = binary_classification(O["n"], O["d"], seed=O["seed"]).columns

    def stream(where, mode, momentum, tier=None, decode="auto"):
        ds = Dataset(dict(base))
        lr = O["momentum_lr"] if momentum else O["lr"]
        meta = HistoryMeta(n=O["n"], batch_size=O["batch"], seed=7,
                           steps=O["steps"], lr_schedule=((0, lr),),
                           momentum=momentum)
        p0 = logreg_init(O["d"], generator=torch.Generator().manual_seed(1),
                         device=where)
        w_star, hist = dg.sgd_train_with_cache(obj, p0, ds, meta, device=where,
                                               **(tier or {}))
        src = np.random.default_rng(11).choice(O["n"], O["requests"],
                                               replace=False)
        reqs = src.tolist() if mode == "delete" else ds.append(
            {k: v[src] for k, v in ds.columns.items()}).tolist()
        c = dataclasses.replace(cfg, stream_window=O["window"] if tier else 0,
                                stream_decode=decode)
        (w, st), n = counted_run(kernels, lambda: online_deltagrad(
            obj, hist, ds, reqs, c, mode=mode, device=where))
        return dict(ds=ds, meta=meta, p0=p0, w_star=w_star, w=w, st=st,
                    n=n, reqs=reqs)

    # warm-up, counted as set-up
    ds_w = binary_classification(600, O["d"], seed=O["seed"])
    mw = HistoryMeta(n=600, batch_size=256, seed=7, steps=12,
                     lr_schedule=((0, O["lr"]),))
    p_w = logreg_init(O["d"], device=dev)
    _, h_w = dg.sgd_train_with_cache(obj, p_w, ds_w, mw, device=dev)
    online_deltagrad(obj, h_w, ds_w, [1, 2],
                     dg.DeltaGradConfig(period=5, burn_in=4), device=dev)
    del ds_w, h_w
    for label, mode, momentum in (("delete", "delete", 0.0),
                                  ("add", "add", 0.0),
                                  ("momentum-0.9 lr-0.1 delete", "delete", 0.9)):
        card = stream(dev, mode, momentum)
        cpu = stream(torch.device("cpu"), mode, momentum)
        st, n = card["st"], card["n"]
        per_ms = [s.wall_time_s * 1e3 for s in st.per_request]
        gap = (card["w"].flat.cpu() - cpu["w"].flat).abs().max().item()
        same = ([s.counters() for s in st.per_request]
                == [s.counters() for s in cpu["st"].per_request])
        w_u, st_u = dg.baseline_retrain(obj, card["ds"], card["meta"],
                                        card["p0"], card["reqs"], mode=mode,
                                        device=dev)
        d_ui = (w_u.flat - card["w"].flat).norm().item()
        d_us = (w_u.flat - card["w_star"].flat).norm().item()
        approx = sum(s.approx_steps for s in st.per_request)
        print(f"online {label}: {len(per_ms)} requests, per-request ms "
              + ", ".join(f"{x:.3f}" for x in per_ms)
              + f" (median {statistics.median(per_ms):.3f}) stream_s="
              f"{st.wall_time_s:.4f} baseline_s={st_u.wall_time_s:.4f} "
              f"explicit={sum(s.explicit_steps for s in st.per_request)} "
              f"approx={approx} grad_examples={st.grad_examples} "
              f"grad_examples_baseline={st.grad_examples_baseline} "
              f"theoretical_speedup={st.theoretical_speedup:.3f} "
              f"card vs cpu: max |gap| {gap:.3e} (bar {ONLINE_TOL}), counters "
              f"equal per request: {same}; d_ui={d_ui:.6e} d_us={d_us:.6e} "
              f"d_ui/d_us={d_ui / d_us:.4e} launches {json.dumps(n)}", flush=True)
        if not (same and gap <= ONLINE_TOL):
            fail(f"online {label}: card vs cpu gap {gap:.3e}, counters equal: {same}")
        # Theorem 1's bar for the SGD streams; the heavy-ball stream is held
        # to its direction, as the reference's momentum test holds it
        bar = 1.0 if momentum else 0.5
        if not d_ui < bar * d_us:
            fail(f"online {label}: d_ui {d_ui:.3e} not below {bar} d_us {d_us:.3e}")
        want = {"fused_update": 0 if momentum else approx,
                "multidot": approx, "rank_update": approx}
        for k, v in want.items():
            if approx <= 0 or n[k] != v:
                fail(f"online {label}: {k} launched {n[k]} times for "
                     f"{approx} approx steps")
        del card, cpu
    # the host tier under delta_int8: a streamed online delete stream,
    # kernel mode (the dequant pair) against fetch mode
    host = dict(tier="host", codec="delta_int8", window=O["window"])
    runs = {d: stream(dev, "delete", 0.0, tier=host, decode=d)
            for d in ("kernel", "fetch")}
    k_run, f_run = runs["kernel"], runs["fetch"]
    bitwise = (torch.equal(k_run["w"].flat, f_run["w"].flat)
               and [s.counters() for s in k_run["st"].per_request]
               == [s.counters() for s in f_run["st"].per_request])
    approx = sum(s.approx_steps for s in k_run["st"].per_request)
    print(f"online host/delta_int8 delete: kernel mode "
          f"stream_s={k_run['st'].wall_time_s:.4f} fetch mode "
          f"stream_s={f_run['st'].wall_time_s:.4f} bitwise equal: {bitwise} "
          f"approx={approx} launches kernel {json.dumps(k_run['n'])} "
          f"fetch {json.dumps(f_run['n'])}", flush=True)
    if not bitwise:
        fail("online host/delta_int8: kernel mode is not bitwise fetch mode")
    for k in ("dequant_update", "dequant_sub", "multidot", "rank_update"):
        if approx <= 0 or k_run["n"][k] != approx:
            fail(f"online host/delta_int8 kernel: {k} launched "
                 f"{k_run['n'][k]} times for {approx} approx steps")


def lm_setup(torch, np, dev, arch="internlm2-1.8b", dtype=None,
             layers=LM["layers"], steps=LM["steps"], burn_in=LM_DG["burn_in"],
             window=LM_DG["stream_window"], remat=False, seq=LM["seq"], frames=0):
    """Phase 9's recipe on `arch` at full width and `layers` layers (an
    encoder-decoder: `layers` encoder and `layers` decoder layers), T
    `steps`, j0 `burn_in`, `window` steps a streamed window and documents
    of `seq` tokens (phase 9's unless a cut says otherwise), and for an
    encoder-decoder `frames` frames N(0, 1) a row beside its tokens: (cfg,
    model, p0, docs, meta, the DeltaGrad config, removed rows, the
    objective under flash, in the compute `dtype` (None is the model's
    bf16), with per-block activation checkpointing if `remat`)."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models.registry import build

    cfg = get_config(arch)
    cfg = dc.replace(cfg, n_layers=layers,
                     n_encoder_layers=layers if cfg.n_encoder_layers else 0)
    model = build(cfg)
    p0 = model.init(seed=0, device=dev)
    docs = token_stream(LM["docs"], seq, cfg.vocab, seed=0)
    if frames:
        docs = Dataset({"frames": np.random.default_rng(1).standard_normal(
            (LM["docs"], frames, cfg.d_model), dtype=np.float32),
            "tokens": docs.columns["tokens"]})
    meta = HistoryMeta(n=LM["docs"], batch_size=LM["batch"], seed=LM["seed"],
                       steps=steps, lr_schedule=((0, LM["lr"]),))
    dgc = dg.DeltaGradConfig(**{**LM_DG, "burn_in": burn_in,
                                "stream_window": window})
    removed = np.linspace(3, 120, 4).astype(np.int64)
    obj = dg.Objective.from_model(model, loss_chunk=LM["loss_chunk"],
                                  attn_impl="flash", dtype=dtype, remat=remat)
    return cfg, model, p0, docs, meta, dgc, removed, obj


def lm_phase(torch, np, dev, kernels) -> dict:
    """Phase 9: InternLM2-1.8B at full width (2 layers), the flash kernel
    on every forward pass, through the three entry points.  Returns the
    p-length kernels' launches on its main path."""
    import dataclasses as dc
    import gc

    from repro_torch.core import deltagrad as dg

    t_phase = time.perf_counter()
    print(f"lm: MemAvailable {mem_available_gb():.1f} GiB at the start", flush=True)
    cfg, model, p0, docs, meta, dgc, removed, obj = lm_setup(torch, np, dev)
    if p0.numel != LM["n_params"]:
        fail(f"lm: p = {p0.numel}, want {LM['n_params']}")
    forwards = count_forwards(obj)
    print(f"lm: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_head={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} layers={cfg.n_layers} of 24 p={p0.numel} "
          f"({p0.numel * 4 / 1e9:.3f} GB f32) docs={LM['docs']}x{LM['seq']} "
          f"B={LM['batch']} T={LM['steps']} removed={removed.tolist()}", flush=True)

    # model-level flash parity (and the warm-up of every op of the path)
    four = {"tokens": docs.device_columns(dev)["tokens"][:4]}
    ones = torch.ones(4, device=dev)
    blockwise = dg.Objective.from_model(model, loss_chunk=LM["loss_chunk"])
    vals = {}
    for name, o in (("flash", obj), ("blockwise", blockwise)):
        with torch.no_grad():
            loss = o.weighted_mean_loss(p0, four, ones).item()
        vals[name] = (loss, o.make_grad_fn()(p0, four, ones))
    dl = abs(vals["flash"][0] - vals["blockwise"][0])
    rel = ((vals["flash"][1] - vals["blockwise"][1]).norm()
           / vals["blockwise"][1].norm()).item()
    print(f"lm parity flash vs blockwise, 4 docs: loss {vals['flash'][0]:.6f} / "
          f"{vals['blockwise'][0]:.6f} |dloss|={dl:.3e} (tol 5e-3) "
          f"grad rel={rel:.3e} (tol 5e-2)", flush=True)
    if not (dl < 5e-3 and rel < 5e-2):
        fail(f"lm: flash vs blockwise loss {dl:.3e} grad {rel:.3e}")
    del vals, blockwise
    torch.cuda.synchronize()

    def launches():
        return {n: k["wrapper"].launches for n, k in kernels.items()}

    def zero():
        for k in kernels.values():
            k["wrapper"].launches = 0
        forwards[0] = 0

    # the main path: host-tier f32 history, streamed in windows of 2 steps
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    w_star, hist = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                           codec="f32", window=LM["window"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    w_u, st_u = dg.baseline_retrain(obj, docs, meta, p0, removed)
    with bv_ratios() as ratios:
        w_i, st = dg.deltagrad_retrain(obj, hist, docs, removed, dgc)
    n = launches()
    fwd = forwards[0]
    peak = torch.cuda.max_memory_allocated()
    kernels["flash_attention"]["launches"] = n["flash_attention"]
    d_ui = (w_u.flat - w_i.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    x = st.extra
    print(replay_line("lm f32 host", train_s, st_u, st, d_ui, d_us, ratios, dgc)
          + f" decode={x['stream_decode']} depth={x['prefetch_depth']} "
          f"host_stage_high={x['host_stage_high']} "
          f"compression_ratio={x['compression_ratio']:.4f} "
          f"host_bytes={hist.nbytes()} max_memory_allocated={peak} "
          f"forward_passes={fwd} launches {json.dumps(n)}", flush=True)
    if not (bool(torch.isfinite(w_i.flat).all()) and w_i.numel == LM["n_params"]):
        fail("lm: replay parameters are not finite of the expected shape")
    # Theorem 1's direction: the replay lands closer to BaseL than the
    # original model.  The MLP's bar of d_us / 2 is not met on this recipe
    # (PERF.md section 7), so it is printed, not held; the run is also held
    # to its card-vs-CPU parity (phase 7, the reduced LM)
    if not d_ui < d_us:
        fail(f"lm: d_ui {d_ui:.3e} not below d_us {d_us:.3e}")
    print(f"lm f32 host: d_ui/d_us = {d_ui / d_us:.4e} (held below 1; "
          f"{'below' if d_ui < 0.5 * d_us else 'not below'} the MLP's 0.5)",
          flush=True)
    if not n["flash_attention"] == LM["layers"] * fwd > 0:
        fail(f"lm: flash launched {n['flash_attention']} times for {fwd} "
             f"forward passes of {LM['layers']} layers")
    if st.approx_steps <= 0:
        fail("lm: the replay took no approx step")
    check_replay_launches("lm", n, st)
    if n["dequant_update"] or n["dequant_sub"]:
        fail("lm: a dequant kernel ran on the f32 (fetch-mode) path")
    f32_host_bytes = hist.nbytes()
    del hist, w_i
    gc.collect()
    torch.cuda.empty_cache()

    # host-tier delta_int8: kernel mode against fetch mode, the same history
    print(f"lm: MemAvailable {mem_available_gb():.1f} GiB before delta_int8",
          flush=True)
    t0 = time.perf_counter()
    w_c, h_c = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                       codec="delta_int8", window=LM["window"])
    rec_s = time.perf_counter() - t0
    print(f"lm delta_int8: train_s={rec_s:.4f} (rows encoded on the card) "
          f"host_bytes={h_c.nbytes()} same model as the f32 recording: "
          f"{torch.equal(w_c.flat, w_star.flat)}", flush=True)
    codec_on_card(torch, np, w_star.flat, p0.flat, h_c.bounds)
    runs = {}
    for mode in ("kernel", "fetch"):  # kernel mode under the profiler
        torch.cuda.reset_peak_memory_stats()
        zero()

        def replay():
            return dg.deltagrad_retrain(obj, h_c, docs, removed,
                                        dc.replace(dgc, stream_decode=mode))

        w_s, st_s = (profile_replay(torch, "lm host/delta_int8 kernel-mode replay",
                                    replay) if mode == "kernel" else replay())
        runs[mode] = (w_s, st_s, launches())
        x = st_s.extra
        print(f"lm delta_int8 {mode}: replay_s={st_s.wall_time_s:.4f} "
              + ("(under the profiler) " if mode == "kernel" else "")
              + " ".join(f"{k}={v}" for k, v in st_s.counters().items())
              + f" windows={x['windows']} host_wait_s={x['host_wait_s']:.4f} "
              f"hbm_high_water={x['hbm_high_water']} "
              f"encoded_bytes_high={x['encoded_bytes_high']} "
              f"compression_ratio={x['compression_ratio']:.4f} "
              f"d_ui={(w_u.flat - w_s.flat).norm().item():.6e} (d_us {d_us:.6e}) "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"launches {json.dumps(runs[mode][2])}", flush=True)
    (w_k, st_k, n_k), (w_f, st_f, _) = runs["kernel"], runs["fetch"]
    if not (torch.equal(w_k.flat, w_f.flat) and st_k.counters() == st_f.counters()):
        fail("lm delta_int8: kernel mode is not bitwise fetch mode "
             f"({(w_k.flat - w_f.flat).abs().max().item():.3e})")
    check_replay_launches("lm delta_int8 kernel", n_k, st_k,
                          ("dequant_update", "dequant_sub", "multidot", "rank_update"))
    # every window of 2 steps carries the f32 keyframes of its key window
    # (T = 12 < 16: one), so on the device the codes save little; in host
    # RAM the path is a third of the f32 one
    if not 2 * h_c.nbytes() < f32_host_bytes:
        fail(f"lm delta_int8: host bytes {h_c.nbytes()} not below half of "
             f"the f32 path's {f32_host_bytes}")
    del runs, w_k, w_f, w_u
    print(f"lm: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    # the p-length kernels' launches on the LM's main path: the f32 history
    # (resident update), and the delta_int8 one in kernel mode (dequant pair)
    return {"fused_update": n["fused_update"], "multidot": n["multidot"],
            "rank_update": n["rank_update"], "dequant_update": n_k["dequant_update"],
            "dequant_sub": n_k["dequant_sub"]}


def codec_on_card(torch, np, w, base, bounds) -> None:
    """The delta_int8 codec on one LM row, w - base: its encode on the card
    (what the recording runs) against its encode of the same numpy rows on
    the host's CPU (held bitwise to the JAX package's codec by
    tests/test_torch_history.py), codes and per-leaf scales bitwise."""
    from repro_torch.core.history import DeltaInt8Codec

    codec = DeltaInt8Codec()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = codec.encode_delta_tensor(w, base, bounds)
    card_s = time.perf_counter() - t0
    w_h, base_h = w.cpu().numpy(), base.cpu().numpy()
    t0 = time.perf_counter()
    host = codec.encode_delta(w_h, base_h, bounds)
    host_s = time.perf_counter() - t0
    same = (np.array_equal(card.q, host.q) and card.scale.dtype == host.scale.dtype
            and np.array_equal(card.scale.view(np.int32), host.scale.view(np.int32)))
    print(f"lm delta_int8 codec on one row of p={w.numel()} ({len(bounds) - 1} "
          f"leaves): the card's encode (with the copy of the codes to the host) "
          f"{card_s:.4f} s, the CPU's {host_s:.4f} s; codes and scales bitwise "
          f"equal: {same} (codes differing: {int((card.q != host.q).sum())})",
          flush=True)
    if not same:
        fail("lm delta_int8: the card's encode is not bitwise the numpy codec's")


def lm_blockwise(torch, np, dg, model, p0, docs, meta, dgc, removed, w_star,
                 w_u) -> None:
    """Phase 9's f32 host path with the plain blockwise attention in every
    forward pass, beside the flash run's w* and w_U: how far the replay's
    decisions hang on the attention's rounding (both attentions meet the
    model-level bar of phase 9).  Only ``--lm-blockwise`` runs it."""
    blockwise = dg.Objective.from_model(model, loss_chunk=LM["loss_chunk"])
    t0 = time.perf_counter()
    w_star_b, hist_b = dg.sgd_train_with_cache(blockwise, p0, docs, meta, tier="host",
                                               codec="f32", window=LM["window"])
    torch.cuda.synchronize()
    train_b = time.perf_counter() - t0
    w_u_b, st_u_b = dg.baseline_retrain(blockwise, docs, meta, p0, removed)
    w_i_b, st_b = dg.deltagrad_retrain(blockwise, hist_b, docs, removed, dgc)
    d_ui_b = (w_u_b.flat - w_i_b.flat).norm().item()
    d_us_b = (w_u_b.flat - w_star_b.flat).norm().item()
    d_us = (w_u.flat - w_star.flat).norm().item()
    print(f"lm f32 host blockwise attention: train_s={train_b:.4f} "
          f"baseline_s={st_u_b.wall_time_s:.4f} replay_s={st_b.wall_time_s:.4f} "
          + " ".join(f"{k}={v}" for k, v in st_b.counters().items())
          + f" d_ui={d_ui_b:.6e} d_us={d_us_b:.6e} d_ui/d_us={d_ui_b / d_us_b:.4e}; "
          f"flash vs blockwise |w*_f - w*_b|={(w_star.flat - w_star_b.flat).norm().item():.6e} "
          f"|w_U,f - w_U,b|={(w_u.flat - w_u_b.flat).norm().item():.6e} "
          f"(flash d_us {d_us:.6e})", flush=True)
    if not np.isfinite(d_ui_b):
        fail(f"lm blockwise: d_ui {d_ui_b} is not finite")


def lm_blockwise_main() -> int:
    """``--lm-blockwise``: phase 9's flash recording and BaseL (for w* and
    w_U), then its f32 host path again under the plain blockwise attention
    (`lm_blockwise`).  Recorded, not held beyond finite values."""
    def body(torch, np, dev):
        from repro_torch.core import deltagrad as dg

        _, model, p0, docs, meta, dgc, removed, obj = lm_setup(torch, np, dev)
        w_star, hist = dg.sgd_train_with_cache(obj, p0, docs, meta, tier="host",
                                               codec="f32", window=LM["window"])
        del hist
        gc_collect()
        w_u, _ = dg.baseline_retrain(obj, docs, meta, p0, removed)
        lm_blockwise(torch, np, dg, model, p0, docs, meta, dgc, removed, w_star, w_u)

    return opt_in_main(body)


def session_phase(torch, np, dev, kernels, rcv1: dict) -> float:
    """Phase 12: the session surface (`core.session.UnlearnerSession`).

    At the rcv1.binary width (phase 10's data and recipe, stacked tier):
    fit, BaseL on the burst's rows, one coalesced delete burst of r rows,
    a serial stream of 4 deletes and 1 add through `serve_stream`, each
    held against the port's CPU run of the same session; the certificate
    under the default constants (must refuse) and the tests' constants,
    and two publishes from one generator state; `retrain_oracle` against
    BaseL; one `descent_to_delete` group.  At quickstart's size: a
    snapshot mid-stream, restored and served on, bitwise the uninterrupted
    session for each algorithm, and a host-tier delta_int8 session in
    kernel mode against fetch mode.  Then `from_config` on the InternLM2
    architecture with the flash kernel.  Returns the serial stream's median
    per-request dispatch ms at the rcv1.binary width (phase 13's rate)."""
    import dataclasses as dc
    import tempfile

    from repro_torch.configs.paper_logreg import RECIPE
    from repro_torch.core.algorithms import DescentToDeleteConfig
    from repro_torch.core.deltagrad import DeltaGradConfig, deltagrad_retrain
    from repro_torch.core.privacy import PrivacyConfig, gaussian_sigma
    from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import binary_classification, token_stream
    from repro_torch.models.simple import logreg_init, logreg_objective

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    L = LOGREG
    obj = logreg_objective(l2=RECIPE.l2)
    p0 = logreg_init(L["d"], generator=torch.Generator().manual_seed(L["seed"]),
                     device=cpu)

    def session(where, algorithm="deltagrad", **kw):
        cfg = UnlearnerConfig(
            steps=L["steps"], batch_size=L["batch"], lr=RECIPE.lr,
            seed=L["seed"], algorithm=algorithm,
            deltagrad=DeltaGradConfig(period=RECIPE.period,
                                      burn_in=RECIPE.burn_in,
                                      history_size=RECIPE.history_size), **kw)
        s = UnlearnerSession(obj, p0, Dataset(dict(rcv1)), cfg, device=where)
        t0 = time.perf_counter()
        s.fit()
        return s, time.perf_counter() - t0

    def counters(stats):
        return [x.counters() for x in stats]

    rng = np.random.default_rng(L["seed"] + 2)
    drawn_dels, drawn_adds = SESSION["draws"]
    rows = rng.choice(L["n"], L["r"] + drawn_dels, replace=False)
    burst = rows[:L["r"]].tolist()
    dels = rows[L["r"]:L["r"] + SESSION["stream_deletes"]].tolist()
    add_src = rng.choice(L["n"], drawn_adds, replace=False)[:SESSION["stream_adds"]]

    # -- at the rcv1.binary width: burst, stream, certificate, publish --------
    card, fit_s = session(dev)
    host, _ = session(cpu)
    w_star = card.params.flat.clone()
    w_u, st_u = card.baseline(burst)
    # Algorithm 1 on the same rows and cached path, before the burst
    # rewrites the path: the group request must be this replay
    w_a1, _ = deltagrad_retrain(obj, card.history, card.dataset, burst,
                                card.config.deltagrad, device=dev)
    # how d_ui/d_us of Algorithm 1 spreads over other draws of r rows on
    # this recipe: phase 10's draw (seed + 1), then seeds 10 to 15
    spread = []
    for seed in [L["seed"] + 1] + list(range(10, 16)):
        other = np.random.default_rng(seed).choice(L["n"], L["r"], replace=False)
        w_o, _ = card.baseline(other)
        w_i, _ = deltagrad_retrain(obj, card.history, card.dataset, other,
                                   card.config.deltagrad, device=dev)
        spread.append((w_o.flat - w_i.flat).norm().item()
                      / (w_o.flat - w_star).norm().item())
    print("session rcv1: Algorithm 1's d_ui/d_us over other draws of "
          f"{L['r']} rows (seed {L['seed'] + 1}, 10..15): "
          + ", ".join(f"{x:.4f}" for x in spread), flush=True)
    del w_o, w_i
    resp, n = counted_run(kernels, lambda: card.delete(burst).result())
    resp_c = host.delete(burst).result()
    st = resp.stats[0]
    gap = (card.params.flat.cpu() - host.params.flat).abs().max().item()
    same = counters(resp.stats) == counters(resp_c.stats)
    d_ui = (w_u.flat - card.params.flat).norm().item()
    d_us = (w_u.flat - w_star).norm().item()
    d_a1 = (w_a1.flat - card.params.flat).abs().max().item()
    print(f"session rcv1 burst: fit_s={fit_s:.4f} baseline_s={st_u.wall_time_s:.4f} "
          f"group_size={resp.group_size} dispatch_s={resp.dispatch_s:.4f} "
          + " ".join(f"{k}={v}" for k, v in st.counters().items())
          + f" d_ui={d_ui:.6e} d_us={d_us:.6e} d_ui/d_us={d_ui / d_us:.4e} "
          f"(Algorithm 1 on these rows: "
          f"{(w_u.flat - w_a1.flat).norm().item() / d_us:.4e}; max |gap| to it "
          f"{d_a1:.3e}, bar {PARITY_TOL}) card vs cpu: max |gap| {gap:.3e} "
          f"(bar {PARITY_TOL}), counters equal: {same}; launches "
          f"{json.dumps(n)}", flush=True)
    if not (same and gap <= PARITY_TOL):
        fail(f"session rcv1 burst: card vs cpu gap {gap:.3e}, counters equal: {same}")
    # the first group request on the cached path is Algorithm 1's group
    # correction.  d_ui/d_us is recorded, not held: on this recipe it
    # depends on which r rows go (the spread printed above; PERF.md §7),
    # and phase 10 holds its own draw below 1
    if not (bool(torch.isfinite(card.params.flat).all()) and d_a1 <= PARITY_TOL):
        fail(f"session rcv1 burst: max |gap| {d_a1:.3e} to Algorithm 1's replay")
    for k in RESIDENT:  # one launch each per approx step (the estimate form)
        if st.approx_steps <= 0 or n[k] != st.approx_steps:
            fail(f"session rcv1 burst: {k} launched {n[k]} times for "
                 f"{st.approx_steps} approx steps")

    ops = [("delete", r) for r in dels]
    for s in (card, host):
        new = s.dataset.append({k: v[add_src] for k, v in rcv1.items()})
    ops += [("add", int(r)) for r in new]
    ost, n = counted_run(kernels, lambda: card.serve_stream(ops))
    ost_c = host.serve_stream(ops)
    gap = (card.params.flat.cpu() - host.params.flat).abs().max().item()
    same = counters(ost.per_request) == counters(ost_c.per_request)
    tickets = range(card._tickets - len(ops), card._tickets)
    dispatch = [card._responses[t].dispatch_s * 1e3 for t in tickets]
    approx = sum(x.approx_steps for x in ost.per_request)
    print(f"session rcv1 stream ({len(dels)} deletes, {len(new)} adds, "
          f"coalesce=False): per-request dispatch ms "
          + ", ".join(f"{x:.3f}" for x in dispatch)
          + f" (median {statistics.median(dispatch):.3f}); to the end of each "
          "request's device work (a request synchronises, so its handle "
          "is forced then) ms "
          + ", ".join(f"{x.wall_time_s * 1e3:.3f}" for x in ost.per_request)
          + f"; stream wall_s (to the forced end) {ost.wall_time_s:.4f}; per-request "
          + "; ".join(f"{op} e={x.explicit_steps} a={x.approx_steps}"
                      for (op, _), x in zip(ops, ost.per_request))
          + f"; card vs cpu: max |gap| {gap:.3e} (bar {PARITY_TOL}), counters "
          f"equal per request: {same}; launches {json.dumps(n)}", flush=True)
    if not (same and gap <= PARITY_TOL):
        fail(f"session rcv1 stream: card vs cpu gap {gap:.3e}, counters equal: {same}")
    for k in RESIDENT:
        if approx <= 0 or n[k] != approx:
            fail(f"session rcv1 stream: {k} launched {n[k]} times for "
                 f"{approx} approx steps")

    try:  # PrivacyConfig() defaults: mu = l2 = 5e-3 makes delta0's denominator < 0
        card.certificate()
        fail("session rcv1: the default certificate did not refuse")
    except ValueError as e:
        print(f"session rcv1 certificate, default constants: refused "
              f"(ValueError: {e})", flush=True)
    for s in (card, host):  # the algorithms read the session's config object
        s.config.privacy = PrivacyConfig(**PRIVACY)
    cert, cert_c = card.certificate(), host.certificate()
    gen = card._publish_generator()
    state = gen.get_state()
    w = card.params.flat.clone()
    t0 = time.perf_counter()
    pub1, c1 = card.publish()
    pub_s = time.perf_counter() - t0
    gen.set_state(state)
    pub2, _ = card.publish()
    noise = (pub1.flat - w).double()
    want = cert.noise_scale * math.sqrt(2.0)  # Laplace(b): std b sqrt(2)
    print(f"session rcv1 certificate {json.dumps(cert.as_dict())}; cpu equal: "
          f"{cert.as_dict() == cert_c.as_dict()}; publish_s={pub_s:.4f}, "
          f"two publishes from one generator state bitwise equal: "
          f"{torch.equal(pub1.flat, pub2.flat)}; noise std {noise.std().item():.6e} "
          f"against noise_scale*sqrt(2) {want:.6e} over {noise.numel()} "
          f"coordinates (bar {NOISE_TOL:.0%})", flush=True)
    if cert.as_dict() != cert_c.as_dict() or cert.removals != len(burst) + len(dels):
        fail(f"session rcv1: certificate {cert} (cpu {cert_c})")
    if not torch.equal(pub1.flat, pub2.flat):
        fail("session rcv1: publishes from one generator state differ")
    if not abs(noise.std().item() / want - 1.0) <= NOISE_TOL:
        fail(f"session rcv1: noise std {noise.std().item():.4e} against {want:.4e}")
    del card, host, w_u, pub1, pub2, noise
    gc_collect()

    # retrain_oracle: the engine under an all-explicit plan, against BaseL
    oracle, _ = session(dev, "retrain_oracle")
    resp, n = counted_run(kernels, lambda: oracle.delete(burst).result())
    w_b, st_b = oracle.baseline(burst)
    bitwise = torch.equal(oracle.params.flat, w_b.flat)
    print(f"session rcv1 retrain_oracle: dispatch_s={resp.dispatch_s:.4f} "
          f"baseline_s={st_b.wall_time_s:.4f} "
          + " ".join(f"{k}={v}" for k, v in resp.stats[0].counters().items())
          + f"; bitwise BaseL: {bitwise} (max |gap| "
          f"{(oracle.params.flat - w_b.flat).abs().max().item():.3e}); "
          f"certificate {json.dumps(oracle.certificate().as_dict())}; "
          f"launches {json.dumps(n)}", flush=True)
    if not bitwise:
        fail("session rcv1 retrain_oracle: not bitwise BaseL")
    del oracle
    gc_collect()

    d2d, _ = session(dev, "descent_to_delete", privacy=PrivacyConfig(**PRIVACY),
                     descent=DescentToDeleteConfig(finetune_steps=5, lr=RECIPE.lr))
    w0 = d2d.params.flat.clone()
    resp = d2d.delete(burst).result()
    cert = d2d.certificate()
    w_d = d2d.params.flat
    d_b = (w_d - w_b.flat).norm().item()
    d_0 = (w0 - w_b.flat).norm().item()
    print(f"session rcv1 descent_to_delete: I=5 full-batch steps over "
          f"{resp.stats[0].grad_examples // 5} live rows, wall_s="
          f"{resp.stats[0].wall_time_s:.4f}; ||w - w_U|| {d_b:.6e} (before "
          f"{d_0:.6e}); certificate {json.dumps(cert.as_dict())}", flush=True)
    if not (cert.mechanism == "gaussian" and cert.bound > 0.0
            and cert.noise_scale == gaussian_sigma(cert.bound, cert.eps, cert.delta)
            and bool(torch.isfinite(w_d).all())):
        fail(f"session rcv1 descent_to_delete: certificate {cert}")
    del d2d, w_b
    gc_collect()

    # -- at quickstart's size: snapshots, and the host tier --------------------
    Q = QUICK
    qcols = binary_classification(Q["n"], Q["d"], seed=Q["seed"]).columns
    qobj = logreg_objective(l2=5e-3)
    qp0 = logreg_init(Q["d"], generator=torch.Generator().manual_seed(1),
                      device=cpu)
    qrows = np.random.default_rng(3).choice(Q["n"], Q["deleted"], replace=False)
    first, rest = qrows[:Q["deleted"] // 2].tolist(), qrows[Q["deleted"] // 2:].tolist()

    def qsession(algorithm="deltagrad", dg=None, **kw):
        cfg = UnlearnerConfig(
            steps=Q["steps"], batch_size=Q["batch"], lr=Q["lr"], seed=Q["seed"],
            algorithm=algorithm, privacy=PrivacyConfig(**PRIVACY),
            deltagrad=DeltaGradConfig(period=Q["period"], burn_in=Q["burn_in"],
                                      history_size=Q["m"], **(dg or {})), **kw)
        s = UnlearnerSession(qobj, qp0, Dataset(dict(qcols)), cfg, device=dev)
        s.fit()
        return s

    def rest_of_stream(s):
        s.stream_delete(rest[1:6])
        s.delete(rest[6:]).result()
        s.add(data={k: v[:2] for k, v in qcols.items()}).result()
        out, _ = s.publish()
        return s.params.flat, out.flat, [
            x.counters() for e in s.log[-3:] for x in e["stats"]]

    for algorithm in ("deltagrad", "descent_to_delete", "retrain_oracle"):
        a = qsession(algorithm)
        a.delete(first).result()
        a.publish()  # the generator moves before the snapshot
        h = a.delete([rest[0]])
        with tempfile.TemporaryDirectory() as tmp:
            try:
                a.save(tmp, pending="refuse")
                fail(f"session snapshot {algorithm}: save(pending='refuse') "
                     "did not raise with a request pending")
            except RuntimeError:
                pass
            t0 = time.perf_counter()
            step_dir = a.save(tmp)  # drains the pending request
            save_s = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in Path(step_dir).iterdir())
            t0 = time.perf_counter()
            b = UnlearnerSession.restore(tmp, qobj, device=dev)
            restore_s = time.perf_counter() - t0
        wa, pa, sa = rest_of_stream(a)
        wb, pb, sb = rest_of_stream(b)
        ok = (h.done and torch.equal(wa, wb) and torch.equal(pa, pb)
              and sa == sb)
        print(f"session snapshot {algorithm}: {nbytes} bytes, save_s="
              f"{save_s:.4f} restore_s={restore_s:.4f}; the rest of the "
              f"stream bitwise the uninterrupted session's: {ok}", flush=True)
        if not ok:
            fail(f"session snapshot {algorithm}: restored session differs")
        del a, b

    runs = {}
    for mode in ("kernel", "fetch"):
        s = qsession(history_tier="host", history_codec="delta_int8",
                     dg=dict(stream_window=Q["window"], stream_decode=mode))
        resp, n = counted_run(kernels, lambda: s.delete(qrows.tolist()).result())
        runs[mode] = (s.params.flat, resp.stats[0], n)
    (wk, sk, nk), (wf, sf, nf) = runs["kernel"], runs["fetch"]
    bitwise = torch.equal(wk, wf) and sk.counters() == sf.counters()
    print(f"session host/delta_int8 burst of {len(qrows)}: kernel mode "
          f"bitwise fetch mode: {bitwise}; approx={sk.approx_steps} "
          f"stream_decode={sk.extra.get('stream_decode')}/"
          f"{sf.extra.get('stream_decode')}; launches "
          f"kernel {json.dumps(nk)} fetch {json.dumps(nf)}", flush=True)
    if not bitwise:
        fail("session host/delta_int8: kernel mode is not bitwise fetch mode")
    for k in ("dequant_update", "dequant_sub", "multidot", "rank_update"):
        if sk.approx_steps <= 0 or nk[k] != sk.approx_steps:
            fail(f"session host/delta_int8 kernel: {k} launched {nk[k]} "
                 f"times for {sk.approx_steps} approx steps")

    # -- from_config on the LM, flash on every forward pass --------------------
    M = SESSION_LM
    vocab = M["reduced"]["vocab"]

    def lm_config():
        return UnlearnerConfig(steps=M["steps"], batch_size=M["batch"],
                               lr=M["lr"], seed=M["seed"],
                               deltagrad=DeltaGradConfig(period=2, burn_in=2,
                                                         history_size=2))

    lm = UnlearnerSession.from_config(
        "internlm2-1.8b", token_stream(M["docs"], M["seq"], vocab, seed=0),
        reduced=M["reduced"], config=lm_config(), attn_impl="flash",
        loss_chunk=M["seq"], device=dev)
    lm_cpu = UnlearnerSession(
        lm.objective, lm.params0.to(cpu),
        token_stream(M["docs"], M["seq"], vocab, seed=0), lm_config(),
        device=cpu)
    _, n_fit = counted_run(kernels, lm.fit)
    lm_cpu.fit()
    resp, n = counted_run(kernels, lambda: lm.delete(M["rows"]).result())
    resp_c = lm_cpu.delete(M["rows"]).result()
    same = resp.stats[0].counters() == resp_c.stats[0].counters()
    gap = (lm.params.flat.cpu() - lm_cpu.params.flat).abs().max().item()
    print(f"session lm from_config: p={lm.params0.numel} head_dim="
          f"{lm.model.cfg.head_dim} "
          + " ".join(f"{k}={v}" for k, v in resp.stats[0].counters().items())
          + f" dispatch_s={resp.dispatch_s:.4f}; counters equal to the CPU "
          f"run's (plain attention): {same}; max |gap| {gap:.3e} (bf16, "
          f"recorded); flash launches fit {n_fit['flash_attention']} burst "
          f"{n['flash_attention']}; launches {json.dumps(n)}", flush=True)
    if not (same and bool(torch.isfinite(lm.params.flat).all())):
        fail(f"session lm from_config: counters equal {same}")
    if n["flash_attention"] <= 0 or n_fit["flash_attention"] <= 0:
        fail("session lm from_config: flash_attention was not launched")
    print(f"session: phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return statistics.median(dispatch)



class VirtualClock:
    """A deterministic scheduler clock: each read advances 1 ms; `t` may be
    moved forward to an arrival."""

    t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _drive_inline(sched, clock, events):
    """Serve a trace inline under a virtual clock: each event submitted at
    its arrival, the EDF policy deciding between arrivals (non-forced
    pumps), the tail drained once every hold has run out.  Returns the
    tickets."""
    tickets = []
    for ev in events:
        clock.t = max(clock.t, ev.t)
        tickets.append(sched.submit(op=ev.op, rows=ev.rows, data=ev.data,
                                    tenant=ev.tenant, sla_class=ev.sla_class))
        while sched.pump():
            pass
    clock.t += 10.0
    while sched.pump():
        pass
    sched.drain()
    return tickets


def _batch_seqs(tickets):
    """The request seqs of each batch, in batch order."""
    out = {}
    for tk in tickets:
        out.setdefault(tk.req.batch_id, []).append(tk.req.seq)
    return [out[b] for b in sorted(out)]


def serve_phase(torch, np, dev, kernels, rcv1: dict, serial_ms: float) -> None:
    """Phase 13: the serving tier (`repro_torch.serve`) and its traces.

    (a) The ``unlearn`` entry point in-process at the rcv1.binary shape on
    phase 10's recipe: 12 open-loop Poisson requests of mixed SLA classes
    at twice the serial service rate phase 12 measured, with the span
    tracer on; per-class latency, deadline misses, batch sizes, the
    ``replay.scan`` measured/predicted ratio and the replay kernels'
    launches.  (b) Determinism: one fixed trace through the scheduler
    under a virtual clock, inline, on the card and on the CPU (the same
    batches, counters and monitor summary; params within PARITY_TOL); and
    at quickstart's size a snapshot taken before an open-loop threaded
    run, restored, re-serves the run's logged batches inline bitwise.
    (c) A host-tier delta_int8 history served through the scheduler in
    kernel and fetch decode, bitwise, with the dequant pair launched."""
    import tempfile

    from repro_torch.configs.paper_logreg import RECIPE
    from repro_torch.core.deltagrad import DeltaGradConfig
    from repro_torch.core.session import UnlearnerConfig, UnlearnerSession
    from repro_torch.data import synthetic
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import binary_classification
    from repro_torch.launch.serve import unlearn_main
    from repro_torch.models.simple import logreg_init, logreg_objective
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import (LoadGenerator, QueuedRequest, ServeConfig,
                                   ServingScheduler, fixed_trace, materialize,
                                   poisson_trace)

    t_phase = time.perf_counter()
    L, S = LOGREG, SERVE
    cpu = torch.device("cpu")

    # -- (a) the entry point at full width, open loop ------------------------
    rate = 2.0 / (serial_ms / 1e3)
    print(f"serve: offered rate {rate:.4f} requests/s = 2 / phase 12's serial "
          f"median {serial_ms:.3f} ms", flush=True)
    obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    with tempfile.TemporaryDirectory() as tmp:
        bench, trace = f"{tmp}/serve.json", f"{tmp}/trace.json"
        argv = ["--device", str(dev), "--n", str(L["n"]), "--d", str(L["d"]),
                "--batch", str(L["batch"]), "--steps", str(L["steps"]),
                "--lr", str(RECIPE.lr), "--l2", str(RECIPE.l2),
                "--period", str(RECIPE.period),
                "--burn-in", str(RECIPE.burn_in), "--seed", str(L["seed"]),
                "--requests", str(S["requests"]), "--burst", str(S["burst"]),
                "--trace", "poisson", "--sla-class", "mixed",
                "--rate", repr(rate), "--bench-out", bench,
                "--trace-out", trace]
        # the CLI draws phase 10's data set again (n, d and seed are phase
        # 10's): it gets the columns drawn then, not ~30 s of numpy's RNG
        drawn = synthetic.binary_classification
        synthetic.binary_classification = lambda n, d, seed=0: (
            Dataset(dict(rcv1)) if (n, d, seed) == (L["n"], L["d"], L["seed"])
            else drawn(n, d, seed=seed))
        t0 = time.perf_counter()
        try:
            res, n = counted_run(kernels, lambda: unlearn_main(argv))
        finally:
            synthetic.binary_classification = drawn
        cli_s = time.perf_counter() - t0
        with open(bench) as f:
            written = json.load(f)
        with open(trace) as f:
            doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    sv = written.get("serving", {})
    per_class = sv.get("per_class", {})
    admitted = sv.get("admission", {}).get("admitted", -1)
    served = sum(c["served"] for c in per_class.values())
    failed = sum(c["failed"] for c in per_class.values())
    for cls, c in sorted(per_class.items()):
        d, e = c["dispatch_ms"], c["e2e_ms"]
        print(f"serve rcv1 {cls}: served {c['served']} failed {c['failed']} "
              f"deadline_misses {c['deadline_misses']}; dispatch_ms p50 "
              f"{d.get('p50', float('nan')):.3f} p99 {d.get('p99', float('nan')):.3f}; "
              f"e2e_ms p50 {e.get('p50', float('nan')):.3f} p99 "
              f"{e.get('p99', float('nan')):.3f}", flush=True)
    scans = [e["args"] for e in spans if e["name"] == "replay.scan"]
    ratio = statistics.median(a["roofline_ratio"] for a in scans) if scans \
        else float("nan")
    # the device's time of each segment, from CUDA events read at the
    # replay's end-of-replay sync (a span's own times are the host's)
    timed = [a for a in scans if "device_s" in a]
    device_ratio = statistics.median(a["device_roofline_ratio"] for a in timed) \
        if timed else float("nan")
    totals = {}
    for e in spans:
        if e["name"].startswith(("store.", "serve.", "replay.", "online.")):
            c, ms = totals.get(e["name"], (0, 0.0))
            totals[e["name"]] = (c + 1, ms + e["dur"] / 1e3)
    store = {k: v for k, v in totals.items() if k.startswith("store.")}
    print(f"serve rcv1: batches {json.dumps(sv.get('batches'))}; "
          f"deadline_misses_total {sv.get('deadline_misses_total')}; "
          f"add_capacity_retraces {sv.get('add_capacity_retraces')}; admitted "
          f"{admitted} served {served} failed {failed} rejected "
          f"{sv.get('rejected')}; lone tail served "
          f"{sv.get('lone_request_served')}; replay.scan {len(scans)} spans, "
          f"median measured/predicted {ratio:.6g} (median measured_s "
          f"{statistics.median(a['measured_s'] for a in scans) if scans else float('nan'):.6g}, "
          f"pred_s {statistics.median(a['pred_s'] for a in scans) if scans else float('nan'):.6g}; "
          f"device: {len(timed)} spans timed, median device/predicted "
          f"{device_ratio:.6g}, median device_s "
          f"{statistics.median(a['device_s'] for a in timed) if timed else float('nan'):.6g}); "
          f"store.* spans (count, ms): {json.dumps(store) if store else 'none (stacked tier)'}; "
          f"coalesce {json.dumps(written.get('coalesce'))}; cli wall_s "
          f"{cli_s:.2f}; launches {json.dumps(n)}", flush=True)
    print("serve rcv1 span totals (count, ms): " + json.dumps(
        {k: [c, round(ms, 3)] for k, (c, ms) in sorted(totals.items())})
        + "; serve.batch (op, size, ms) in order: " + json.dumps(
            [(e["args"]["op"], e["args"]["size"], round(e["dur"] / 1e3, 3))
             for e in spans if e["name"] == "serve.batch"]), flush=True)
    if set(written) != set(SERVE_SECTIONS):
        fail(f"serve rcv1: sections {sorted(written)}, want {sorted(SERVE_SECTIONS)}")
    if not (admitted > 0 and served == admitted and failed == 0
            and sv.get("lone_request_served")
            and res["config"] == written["config"]):
        fail(f"serve rcv1: admitted {admitted}, served {served}, failed "
             f"{failed}, lone tail {sv.get('lone_request_served')}")
    if not {"serve.batch", "replay.scan", "replay.explicit"} <= names:
        fail(f"serve rcv1: trace holds {sorted(names)}")
    if len(timed) != len(scans):
        fail(f"serve rcv1: {len(timed)} of {len(scans)} replay.scan spans carry "
             "their device time")
    for k in RESIDENT:
        if n[k] <= 0:
            fail(f"serve rcv1: {k} was not launched")
    gc_collect()

    # -- (b) determinism: card against CPU under a virtual clock ------------
    obj = logreg_objective(l2=RECIPE.l2)
    p0 = logreg_init(L["d"], generator=torch.Generator().manual_seed(L["seed"]),
                     device=cpu)

    def rcv1_session(where):
        cfg = UnlearnerConfig(
            steps=L["steps"], batch_size=L["batch"], lr=RECIPE.lr,
            seed=L["seed"], deltagrad=DeltaGradConfig(
                period=RECIPE.period, burn_in=RECIPE.burn_in,
                history_size=RECIPE.history_size))
        s = UnlearnerSession(obj, p0, Dataset(dict(rcv1)), cfg, device=where)
        s.fit()
        return s

    runs = {}
    for key, where in (("card", dev), ("cpu", cpu)):
        sess = rcv1_session(where)
        clock = VirtualClock()
        sched = ServingScheduler(sess, ServeConfig(add_capacity=4), clock=clock)
        events = materialize(fixed_trace(
            S["interval_s"], S["fixed_events"], L["seed"] + 5,
            tenants=("tenant-a", "tenant-b"), classes=S["classes"],
            add_frac=0.25), sess.dataset, seed=L["seed"] + 6)
        t0 = time.perf_counter()
        (tickets, n) = counted_run(kernels, lambda: _drive_inline(sched, clock, events))
        wall = time.perf_counter() - t0
        runs[key] = dict(
            seqs=_batch_seqs(tickets), log=[(r["op"], r["rows"]) for r in sched.batch_log],
            counters=[[x.counters() for x in e["stats"]] for e in sess.log],
            stats=sched.stats(), w=sess.params.flat.cpu(), n=n, wall=wall,
            errors=sum(tk.error is not None for tk in tickets))
        del sess, sched
        gc_collect()
    a, b = runs["card"], runs["cpu"]
    gap = (a["w"] - b["w"]).abs().max().item()
    same = {k: a[k] == b[k] for k in ("seqs", "log", "counters", "stats")}
    print(f"serve determinism rcv1 ({S['fixed_events']} fixed-trace requests, "
          f"virtual clock, inline): batches {a['seqs']}; card vs cpu equal "
          f"{json.dumps(same)}; max |gap| {gap:.3e} (bar {PARITY_TOL}); "
          f"wall_s card {a['wall']:.3f} cpu {b['wall']:.3f}; launches "
          f"{json.dumps(a['n'])}", flush=True)
    if not (all(same.values()) and gap <= PARITY_TOL and a["errors"] == 0):
        fail(f"serve determinism rcv1: equal {same}, gap {gap:.3e}, errors "
             f"{a['errors']}")
    if a["n"]["fused_update"] <= 0:
        fail("serve determinism rcv1: fused_update was not launched")
    del runs, a, b
    gc_collect()

    # at quickstart's size: snapshot, open-loop threaded run, restore and
    # re-serve the logged batches inline (bitwise)
    Q = QUICK
    qcols = binary_classification(Q["n"], Q["d"], seed=Q["seed"]).columns
    qobj = logreg_objective(l2=5e-3)
    qp0 = logreg_init(Q["d"], generator=torch.Generator().manual_seed(1),
                      device=cpu)

    def qsession(dg=None, **kw):
        cfg = UnlearnerConfig(
            steps=Q["steps"], batch_size=Q["batch"], lr=Q["lr"], seed=Q["seed"],
            deltagrad=DeltaGradConfig(period=Q["period"], burn_in=Q["burn_in"],
                                      history_size=Q["m"], **(dg or {})), **kw)
        s = UnlearnerSession(qobj, qp0, Dataset(dict(qcols)), cfg, device=dev)
        s.fit()
        return s

    sess = qsession()
    sched = ServingScheduler(sess, ServeConfig(add_capacity=8))
    with tempfile.TemporaryDirectory() as tmp:
        sched.save(tmp)
        events = materialize(poisson_trace(
            S["quick_rate"], S["threaded_events"], L["seed"] + 7,
            tenants={"tenant-a": 0.6, "tenant-b": 0.4}, classes=S["classes"],
            add_frac=0.25), sess.dataset, seed=L["seed"] + 8)
        sched.start()
        try:
            res = LoadGenerator(sched).open_loop(events)
            ok = all(tk.wait(timeout=60.0) and tk.error is None
                     for tk in res.tickets)
        finally:
            sched.stop()
        by_row = {(tk.req.op, r): tk.req for tk in res.tickets
                  for r in tk.req.rows}
        restored = UnlearnerSession.restore(tmp, qobj, device=dev)
    again = ServingScheduler(restored, ServeConfig(add_capacity=8))
    for rec in sched.batch_log:
        reqs = []
        for r in rec["rows"]:
            q = by_row[(rec["op"], r)]
            if not reqs or reqs[-1] is not q:
                reqs.append(q)
        again.executor.serve_batch([QueuedRequest(
            seq=i, tenant=q.tenant, sla_class=q.sla_class, op=q.op,
            rows=None if q.op == "add" else q.rows,
            data=q.data if q.op == "add" else None, coalesce=q.coalesce,
            t_enqueue=0.0, deadline=1e9) for i, q in enumerate(reqs)])
    bitwise = torch.equal(sess.params.flat, restored.params.flat)
    st = sched.stats()
    print(f"serve snapshot quickstart: {len(res.tickets)} open-loop requests "
          f"({res.rejected} rejected) at {S['quick_rate']} requests/s on the "
          f"executor thread, batches {st['batches']['size_hist']}, all served "
          f"without error: {ok}; the logged batches re-served inline on the "
          f"restored snapshot bitwise: {bitwise}", flush=True)
    if not (ok and bitwise and res.tickets):
        fail(f"serve snapshot quickstart: served ok {ok}, bitwise {bitwise}")
    del sess, sched, restored, again
    gc_collect()

    # -- (c) a host-tier delta_int8 history through the scheduler -------------
    out = {}
    for mode in ("kernel", "fetch"):
        sess = qsession(history_tier="host", history_codec="delta_int8",
                        dg=dict(stream_window=Q["window"], stream_decode=mode))
        clock = VirtualClock()
        sched = ServingScheduler(sess, ServeConfig(), clock=clock)
        events = materialize(fixed_trace(
            S["interval_s"], S["fixed_events"], L["seed"] + 9,
            tenants=("tenant-a", "tenant-b"), classes=S["classes"]),
            sess.dataset, seed=L["seed"] + 10)
        tracer = obs_trace.enable(obs_trace.Tracer())
        try:
            tickets, n = counted_run(
                kernels, lambda: _drive_inline(sched, clock, events))
        finally:
            obs_trace.disable()
        stores = {}
        for e in tracer.events():
            if e["name"].startswith("store."):
                c, ms = stores.get(e["name"], (0, 0.0))
                stores[e["name"]] = (c + 1, ms + e["dur"] / 1e3)
        out[mode] = (sess.params.flat, _batch_seqs(tickets),
                     [[x.counters() for x in e["stats"]] for e in sess.log],
                     n, stores, [e["stats"][0].extra.get("stream_decode")
                                 for e in sess.log])
        del sess, sched
    (wk, bk, ck, nk, sk, dk), (wf, bf, cf, nf, _, df) = out["kernel"], out["fetch"]
    bitwise = torch.equal(wk, wf) and bk == bf and ck == cf
    print(f"serve host/delta_int8 ({S['fixed_events']} deletes through the "
          f"scheduler): batches {bk}; kernel mode bitwise fetch mode: "
          f"{bitwise}; stream_decode {dk[0]}/{df[0]}; store.* spans (count, "
          f"ms) {json.dumps(sk)}; launches kernel {json.dumps(nk)} fetch "
          f"{json.dumps(nf)}", flush=True)
    if not bitwise:
        fail("serve host/delta_int8: kernel mode is not bitwise fetch mode")
    for k in ("dequant_update", "dequant_sub"):
        if nk[k] <= 0:
            fail(f"serve host/delta_int8 kernel: {k} was not launched")
    print(f"serve: phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def main_problem(torch, np, dev, columns=None):
    """Phase 4's main path on the paper MLP at full width: (objective,
    dataset, w_0, HistoryMeta, DeltaGradConfig, the removed rows); the
    dataset from `columns` (its columns as drawn) when given."""
    from repro_torch.configs.paper_mlp import CONFIG
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import multiclass_classification
    from repro_torch.models.simple import mlp_init, mlp_objective

    obj = mlp_objective(l2=CONFIG.l2)
    ds = (Dataset(dict(columns)) if columns is not None else
          multiclass_classification(MAIN["n"], CONFIG.d_in, CONFIG.vocab,
                                    seed=MAIN["seed"]))
    params0 = mlp_init(CONFIG.d_in, CONFIG.d_model, CONFIG.vocab,
                       generator=torch.Generator().manual_seed(MAIN["seed"]),
                       device=dev)
    T = MAIN["steps"]
    meta = HistoryMeta(n=ds.n, batch_size=ds.n, seed=MAIN["seed"], steps=T,
                       lr_schedule=CONFIG.lr_schedule)
    cfg = dg.DeltaGradConfig(period=CONFIG.period, burn_in=CONFIG.burn_in(T),
                             history_size=CONFIG.history_size,
                             guard=CONFIG.guard,
                             curvature_eps=CONFIG.curvature_eps)
    removed = np.random.default_rng(MAIN["seed"] + 1).choice(
        ds.n, size=MAIN["r"], replace=False)
    return obj, ds, params0, meta, cfg, removed


def shard_added(ds, removed):
    """`ds` with copies of the first SHARD["add"] removed rows appended:
    the rows the add-mode replay adds."""
    return ds.append({k: c[removed[:SHARD["add"]]] for k, c in ds.columns.items()})


def shard_online_problem(torch, np, dev, columns=None):
    """Phase 11's delete recipe and scale (logreg, n 8000, d 4000) with one
    appended row: (objective, dataset, w_0, meta, config, requests); the
    dataset from `columns` (its columns as drawn) when given."""
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.history import HistoryMeta
    from repro_torch.data.dataset import Dataset
    from repro_torch.data.synthetic import binary_classification
    from repro_torch.models.simple import logreg_init, logreg_objective

    O = ONLINE
    ds = (Dataset(dict(columns)) if columns is not None else
          binary_classification(O["n"], O["d"], seed=O["seed"]))
    meta = HistoryMeta(n=O["n"], batch_size=O["batch"], seed=7, steps=O["steps"],
                       lr_schedule=((0, O["lr"]),))
    p0 = logreg_init(O["d"], generator=torch.Generator().manual_seed(1), device=dev)
    rows = np.random.default_rng(11).choice(O["n"], len(SHARD_STREAM),
                                            replace=False).tolist()
    added = ds.append({k: v[rows[1:2]] for k, v in ds.columns.items()}).tolist()
    reqs = [(op, added[0] if op == "add" else row)
            for op, row in zip(SHARD_STREAM, rows)]
    cfg = dg.DeltaGradConfig(period=O["period"], burn_in=O["burn_in"],
                             history_size=O["m"])
    return logreg_objective(l2=O["l2"]), ds, p0, meta, cfg, reqs


def shard_rank(rank: int, out_dir: str, ports: dict) -> None:
    """One process of phase 21 (started by spawn), on the datasets the
    parent drew and saved in `out_dir`, with the libraries the parent
    built.  Ranks 0 and 1 run (a) and (b) on cuda:0 in a gloo group of
    SHARD["world"]; then ranks below the card count run (c), rank r on
    cuda:r in an NCCL group of one rank a card.  Each group meets at
    ``tcp://localhost:<ports[its tag]>``.  Its results and its stages'
    seconds are pickled to ``<out_dir>/rank<rank>.pkl``."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build

    torch.cuda.set_device(0)
    _build.build_all()  # nothing to compile: the parent's libraries load
    out = {"seconds": {"ready": time.perf_counter() - t0}}

    def columns(name):
        with np.load(Path(out_dir, f"{name}.npz")) as f:
            return {k: f[k] for k in f.files}

    def group(backend, world, tag, dev, body):
        t = time.perf_counter()
        torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{ports[tag]}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=SHARD["timeout_s"]))
        try:
            body()
        finally:
            dist.destroy_process_group()
        out["seconds"][tag] = time.perf_counter() - t

    mlp = columns("mlp")
    if rank < SHARD["world"]:
        def ab():
            out["mlp"] = shard_mlp_runs(torch, np, torch.device("cuda", 0), True, mlp)
            out["online"] = shard_online_run(torch, np, torch.device("cuda", 0),
                                             columns("logreg"))

        group("gloo", SHARD["world"], "ab", torch.device("cuda", 0), ab)
    n_cards = torch.cuda.device_count()
    if rank < n_cards:
        dev = torch.device("cuda", rank)

        def c():
            out["mlp_c"] = shard_mlp_runs(torch, np, dev, False, mlp)

        group("nccl", n_cards, "c", dev, c)
    with open(Path(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _shard_result(w, st, n, tiles):
    return dict(w=w.flat.cpu().numpy(), counters=st.counters(),
                replay_s=st.wall_time_s, launches=n, tiles=sorted(set(tiles)),
                extra={k: v for k, v in st.extra.items()
                       if isinstance(v, (int, float, str, dict))})


def shard_mlp_runs(torch, np, dev, full: bool, columns: dict) -> dict:
    """A rank's MLP replays on a 1-D data mesh over every rank: resident,
    and with `full` the add mode, the host f32 tier streamed and
    delta_int8 in kernel and fetch mode.  Each with its kernels' launches and the lengths of the vectors
    the per-tile update ran on."""
    import torch.distributed as dist

    from repro_torch.core import deltagrad as dg
    from repro_torch.core import store as store_mod
    from repro_torch.core.store import PlacementPolicy

    kernels = kernel_table()
    obj, ds, params0, meta, cfg, removed = main_problem(torch, np, dev, columns)
    pol = PlacementPolicy.local()
    tiles = []
    real_update = store_mod.fused_update

    def recorded(w, *args, **kw):
        tiles.append(w.numel())
        return real_update(w, *args, **kw)

    store_mod.fused_update = recorded
    # set-up: the pair solve's cuSOLVER handle and the group's first
    # collective, so the first replay's time is its own
    torch.linalg.solve_ex(torch.eye(2, device=dev), torch.ones(2, 1, device=dev))
    dist.all_reduce(torch.zeros(1, device=dev))
    _, hist = dg.sgd_train_with_cache(obj, params0, ds, meta)
    runs = {}

    def run(label, fn):
        tiles.clear()
        (w, st), n = counted_run(kernels, fn)
        runs[label] = _shard_result(w, st, n, tiles)

    run("resident", lambda: dg.deltagrad_retrain(obj, hist, ds, removed, cfg,
                                                 placement=pol))
    if full:
        ds_add = main_problem(torch, np, dev, columns)[1]
        new = shard_added(ds_add, removed)
        run("add", lambda: dg.deltagrad_retrain(obj, hist, ds_add, new, cfg,
                                                mode="add", placement=pol))
        for label, codec, decode in (("host/f32", "f32", "fetch"),
                                     ("host/delta_int8 kernel", "delta_int8", "kernel"),
                                     ("host/delta_int8 fetch", "delta_int8", "fetch")):
            if not label.endswith("fetch") or codec == "f32":
                _, h_c = dg.sgd_train_with_cache(obj, params0, ds, meta,
                                                 tier="host", codec=codec)
            c = dataclasses.replace(cfg, stream_window=STREAM_WINDOW,
                                    stream_decode=decode)
            run(label, lambda: dg.deltagrad_retrain(obj, h_c, ds, removed, c,
                                                    placement=pol))
    store_mod.fused_update = real_update
    return runs


def shard_online_run(torch, np, dev, columns: dict) -> dict:
    """A rank's online stream on a 1-D data mesh over every rank."""
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.online import online_deltagrad
    from repro_torch.core.store import PlacementPolicy

    obj, ds, p0, meta, cfg, reqs = shard_online_problem(torch, np, dev, columns)
    _, hist = dg.sgd_train_with_cache(obj, p0, ds, meta)
    (w, st), n = counted_run(kernel_table(), lambda: online_deltagrad(
        obj, hist, ds, reqs, cfg, placement=PlacementPolicy.local()))
    return dict(w=w.flat.cpu().numpy(), n=n,
                counters=[s.counters() for s in st.per_request],
                ms=[s.wall_time_s * 1e3 for s in st.per_request],
                stream_s=st.wall_time_s, mesh=st.per_request[0].extra.get("mesh"),
                hbm=st.per_request[0].extra["hbm_high_water"])


def spawn_ranks(n: int, data: dict) -> list:
    """`n` processes of `shard_rank` (spawn) over the datasets `data`
    ({name: columns}, saved for them), joined within SHARD["timeout_s"] (a
    rank's exception fails the script); their results in rank order."""
    import os
    import pickle
    import socket
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    ports = {"ab": free_port(), "c": free_port()}
    # the gloo group's sockets on the loopback device: every rank is on
    # this host, and gloo would otherwise take the address the host name
    # resolves to, which a machine without a network may not serve
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as d:
        for name, columns in data.items():
            np.savez(Path(d, f"{name}.npz"), **columns)
        ctx = mp.start_processes(shard_rank, args=(d, ports), nprocs=n, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + SHARD["timeout_s"]
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"phase 21: {n} ranks ran past "
                                   f"{SHARD['timeout_s']} s")
        out = []
        for r in range(n):
            with open(Path(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def shard_phase(torch, np, dev, kernels) -> None:
    """Phase 21: the mesh-sharded replay on torch.distributed (SHARD's
    note): each sub-phase's backend, world size, per-rank history bytes,
    replay_s and launches; the mesh's counters equal one rank's, its
    parameters within SHARD_TOL of one rank's and bitwise equal across
    ranks; the per-rank W and G bytes the packed shard's; the per-tile
    fused update's tiles; streamed bitwise resident and kernel decode
    bitwise fetch decode on the mesh."""
    from repro_torch.core import deltagrad as dg
    from repro_torch.core.online import online_deltagrad
    from repro_torch.dist.sharding import Mesh, make_plan, shard_index

    from repro_torch.data.dataset import Dataset

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    # one rank on the card: the replays and the stream the mesh is held to;
    # the datasets are drawn once, and the ranks read them from files
    obj, ds, params0, meta, cfg, removed = main_problem(torch, np, dev)
    data = {"mlp": dict(ds.columns)}
    _, hist = dg.sgd_train_with_cache(obj, params0, ds, meta)
    single = {"resident": dg.deltagrad_retrain(obj, hist, ds, removed, cfg)}
    ds_add = Dataset(data["mlp"])
    new = shard_added(ds_add, removed)
    single["add"] = dg.deltagrad_retrain(obj, hist, ds_add, new, cfg, mode="add")
    whole_bytes = hist.nbytes()  # W and G, (T, p) f32 each
    shapes, p, T = dict(hist.shapes), hist.final_params.numel, meta.steps
    del hist, ds_add
    o_obj, o_ds, o_p0, o_meta, o_cfg, reqs = shard_online_problem(torch, np, dev)
    data["logreg"] = {k: v[:ONLINE["n"]] for k, v in o_ds.columns.items()}
    _, o_hist = dg.sgd_train_with_cache(o_obj, o_p0, o_ds, o_meta)
    o_w, o_st = online_deltagrad(o_obj, o_hist, o_ds, reqs, o_cfg)
    del o_hist, o_ds
    print(f"shard: one rank on {dev}: resident replay_s="
          f"{single['resident'][1].wall_time_s:.4f} add replay_s="
          f"{single['add'][1].wall_time_s:.4f} online stream_s="
          f"{o_st.wall_time_s:.4f} per-request ms "
          + ", ".join(f"{s.wall_time_s * 1e3:.3f}" for s in o_st.per_request)
          + f"; history W+G {whole_bytes} B | {smi}", flush=True)

    def held(tag, ranks, label, ref, key="mlp"):
        """One mesh run of every rank (under `key`) against one rank's run
        `ref`."""
        r0 = ranks[0][key][label]
        w1, s1 = ref
        gap = float(np.abs(r0["w"] - w1.flat.cpu().numpy()).max())
        same = r0["counters"] == s1.counters()
        across = all(np.array_equal(r[key][label]["w"], r0["w"]) for r in ranks)
        x = r0["extra"]
        print(f"shard {tag} {label}: replay_s={r0['replay_s']:.4f} (one rank "
              f"{s1.wall_time_s:.4f}) store={x['store']} per-rank history "
              f"{x['hbm_high_water']} B mesh={x['mesh']['mesh_shape']} "
              f"fused_update tiles {r0['tiles']} counters "
              + " ".join(f"{k}={v}" for k, v in r0["counters"].items())
              + f"; vs one rank: max |gap| {gap:.3e} (bar {SHARD_TOL}), counters "
              f"equal: {same}; ranks bitwise equal: {across}; launches rank 0 "
              f"{json.dumps(r0['launches'])}", flush=True)
        if not (same and gap <= SHARD_TOL and across):
            fail(f"shard {tag} {label}: gap {gap:.3e}, counters equal {same}, "
                 f"ranks bitwise equal {across}")
        return r0

    def launches_ok(tag, label, ranks, world, key="mlp"):
        """Every rank launched fused_update once per approx step on a tile
        of ceil(p / world), the L-BFGS pair once per approx step, and no
        dequant kernel (a packed row is decoded before its gather)."""
        for r, res in enumerate(ranks):
            x = res[key][label]
            approx = x["counters"]["approx_steps"]
            if x["tiles"] != [-(-p // world)]:
                fail(f"shard {tag} {label} rank {r}: update tiles {x['tiles']}")
            for k, n in x["launches"].items():
                want = approx if k in RESIDENT else 0
                if (k in RESIDENT and n <= 0) or (
                        x["counters"]["guard_fallbacks"] == 0 and n != want):
                    fail(f"shard {tag} {label} rank {r}: {k} launched {n} "
                         f"times, want {want}")

    # one spawn: (a) and (b), two ranks on cuda:0 over gloo, then (c), one
    # rank a card over NCCL
    world, world_c = SHARD["world"], torch.cuda.device_count()
    t0 = time.perf_counter()
    procs = spawn_ranks(max(world, world_c), data)
    print(f"shard: {len(procs)} spawned ranks, spawn_to_join_s="
          f"{time.perf_counter() - t0:.2f}; seconds a stage (ready: start, "
          f"imports, card, libraries; ab: gloo group of {world} on cuda:0; c: "
          f"nccl group of {world_c}, one rank a card): "
          + "; ".join(f"rank {r} " + " ".join(f"{k}={v:.2f}" for k, v in
                                              x["seconds"].items())
                      for r, x in enumerate(procs)), flush=True)
    ranks, ranks_c = procs[:world], procs[:world_c]
    tag = f"(a) gloo world={world}"
    res = held(tag, ranks, "resident", single["resident"])
    held(tag, ranks, "add", single["add"])
    mesh = Mesh((world,), ("data",))
    packed = [shard_index(make_plan(mesh), shapes, (r,)).index.size
              for r in range(world)]
    for r, rk in enumerate(ranks):
        got = rk["mlp"]["resident"]["extra"]["hbm_high_water"]
        want = 2 * T * packed[r] * 4
        print(f"shard {tag} rank {r}: history W+G {got} B, packed shard "
              f"{packed[r]} of p={p} per step ({want} B), share of one "
              f"rank's {whole_bytes} B = {got / whole_bytes:.5f}", flush=True)
        if got != want:
            fail(f"shard {tag} rank {r}: history bytes {got} != packed {want}")
    for label in ("resident", "add", "host/f32", "host/delta_int8 kernel"):
        launches_ok(tag, label, ranks, world)
    for label in ("host/f32", "host/delta_int8 kernel", "host/delta_int8 fetch"):
        x = ranks[0]["mlp"][label]
        across = all(np.array_equal(r["mlp"][label]["w"], x["w"]) for r in ranks)
        print(f"shard {tag} {label}: replay_s={x['replay_s']:.4f} store="
              f"{x['extra']['store']} decode={x['extra']['stream_decode']} "
              f"windows={x['extra']['windows']} per-rank hbm_high_water="
              f"{x['extra']['hbm_high_water']} B compression_ratio="
              f"{x['extra']['compression_ratio']:.4f} ranks bitwise equal: "
              f"{across} launches rank 0 {json.dumps(x['launches'])}", flush=True)
        if not across or x["extra"]["store"] != "sharded_streamed":
            fail(f"shard {tag} {label}: store {x['extra']['store']}, ranks "
                 f"bitwise equal {across}")
    f32 = ranks[0]["mlp"]["host/f32"]
    if not np.array_equal(f32["w"], res["w"]):
        fail(f"shard {tag} host/f32: not bitwise the mesh-resident replay "
             f"({np.abs(f32['w'] - res['w']).max():.3e})")
    kern = ranks[0]["mlp"]["host/delta_int8 kernel"]
    fetch = ranks[0]["mlp"]["host/delta_int8 fetch"]
    print(f"shard {tag}: host/f32 bitwise the mesh-resident replay: "
          f"{np.array_equal(f32['w'], res['w'])}; delta_int8 kernel decode "
          f"bitwise fetch decode: {np.array_equal(kern['w'], fetch['w'])}",
          flush=True)
    if not (np.array_equal(kern["w"], fetch["w"])
            and kern["counters"] == fetch["counters"]):
        fail(f"shard {tag}: delta_int8 kernel decode is not bitwise fetch decode")
    on = ranks[0]["online"]
    gap = float(np.abs(on["w"] - o_w.flat.cpu().numpy()).max())
    same = on["counters"] == [s.counters() for s in o_st.per_request]
    across = all(np.array_equal(r["online"]["w"], on["w"]) for r in ranks)
    print(f"shard (b) gloo world={world} online {'/'.join(SHARD_STREAM)}: "
          f"stream_s={on['stream_s']:.4f} (one rank {o_st.wall_time_s:.4f}) "
          f"per-request ms " + ", ".join(f"{x:.3f}" for x in on["ms"])
          + f" per-rank history {on['hbm']} B mesh={on['mesh']['mesh_shape']}; "
          f"vs one rank: max |gap| {gap:.3e} (bar {SHARD_TOL}), counters equal "
          f"per request: {same}; ranks bitwise equal: {across}; launches rank 0 "
          f"{json.dumps(on['n'])}", flush=True)
    if not (same and gap <= SHARD_TOL and across):
        fail(f"shard (b) online: gap {gap:.3e}, counters equal {same}, ranks "
             f"bitwise equal {across}")

    tag = f"(c) nccl world={world_c}"
    held(tag, ranks_c, "resident", single["resident"], key="mlp_c")
    launches_ok(tag, "resident", ranks_c, world_c, key="mlp_c")
    took = time.perf_counter() - t_phase
    print(f"shard: phase 21 took {took:.2f} s (budget {SHARD['budget_s']} s) "
          f"| {smi}", flush=True)


def opt_in_main(body) -> int:
    """`body(torch, np, dev)` alone on the card, for an opt-in flag: the
    kernels built first; exits 0 unless a check fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import _build

    _build.build_all()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    # the pair solve's cuSOLVER handle, made before the replay fills the card
    torch.linalg.solve_ex(torch.eye(2, device="cuda"), torch.ones(2, 1, device="cuda"))
    body(torch, np, torch.device("cuda"))
    print(nvidia_smi())
    for f in FAILURES:
        print(f"  {f}", file=sys.stderr)
    return 1 if FAILURES else 0


def moe_dg_main(spec: str) -> int:
    """``--moe-dg DTYPE,T,J0``: phase 15 (d) alone at another cut, the
    compute dtype bf16 or f32, T steps and burn-in j0 (the host f32
    history is T x 2 vectors of 4.77 GB on a 96 GiB host: T <= 8).  Its
    numbers are recorded, not held against d_us."""
    name, steps, burn_in = spec.split(",")

    def body(torch, np, dev):
        dtype = {"bf16": None, "f32": torch.float32}[name]
        moe_deltagrad(torch, np, dev, kernel_table(), nvidia_smi(), steps=int(steps),
                      burn_in=int(burn_in), dtype=dtype, main_path=False)

    return opt_in_main(body)


def mla_dg_main(name: str) -> int:
    """``--mla-dg DTYPE``: phase 16 (d) alone in the compute dtype bf16 or
    f32, without the profile and the kernels' comparison; in f32 d_ui <
    d_us is held."""
    def body(torch, np, dev):
        dtype = {"bf16": None, "f32": torch.float32}[name]
        mla_deltagrad(torch, np, dev, kernel_table(), nvidia_smi(), dtype=dtype,
                      main_path=False)

    return opt_in_main(body)


def hybrid_dg_main(name: str) -> int:
    """``--hybrid-dg DTYPE``: phase 17 (d) alone in the compute dtype bf16
    or f32, without the profile and the kernels' comparison."""
    def body(torch, np, dev):
        dtype = {"bf16": None, "f32": torch.float32}[name]
        hybrid_deltagrad(torch, np, dev, kernel_table(), nvidia_smi(), dtype=dtype,
                         main_path=False)

    return opt_in_main(body)


def hybrid_main() -> int:
    """``--hybrid``: phase 17 alone."""
    return opt_in_main(lambda torch, np, dev: hybrid_phase(torch, np, dev,
                                                           kernel_table()))


def xlstm_dg_main(name: str) -> int:
    """``--xlstm-dg DTYPE``: phase 18 (d) alone in the compute dtype bf16
    or f32, without the kernels' comparison."""
    def body(torch, np, dev):
        dtype = {"bf16": None, "f32": torch.float32}[name]
        xlstm_deltagrad(torch, np, dev, kernel_table(), nvidia_smi(), dtype=dtype,
                        main_path=False)

    return opt_in_main(body)


def xlstm_main() -> int:
    """``--xlstm``: phase 18 alone."""
    return opt_in_main(lambda torch, np, dev: xlstm_phase(torch, np, dev,
                                                          kernel_table()))


def whisper_main() -> int:
    """``--whisper``: phase 19 alone."""
    return opt_in_main(lambda torch, np, dev: whisper_phase(torch, np, dev,
                                                            kernel_table()))


def examples_main() -> int:
    """``--examples``: phase 20 alone."""
    return opt_in_main(lambda torch, np, dev: examples_phase(torch, np, dev,
                                                             kernel_table()))


def shard_main() -> int:
    """``--shard``: phase 21 alone."""
    return opt_in_main(lambda torch, np, dev: shard_phase(torch, np, dev,
                                                          kernel_table()))


if __name__ == "__main__":
    if sys.argv[1:] == ["--hybrid"]:
        sys.exit(hybrid_main())
    if sys.argv[1:2] == ["--hybrid-dg"] and len(sys.argv) == 3:
        sys.exit(hybrid_dg_main(sys.argv[2]))
    if sys.argv[1:] == ["--xlstm"]:
        sys.exit(xlstm_main())
    if sys.argv[1:] == ["--whisper"]:
        sys.exit(whisper_main())
    if sys.argv[1:] == ["--examples"]:
        sys.exit(examples_main())
    if sys.argv[1:] == ["--shard"]:
        sys.exit(shard_main())
    if sys.argv[1:2] == ["--xlstm-dg"] and len(sys.argv) == 3:
        sys.exit(xlstm_dg_main(sys.argv[2]))
    if sys.argv[1:2] == ["--moe-dg"] and len(sys.argv) == 3:
        sys.exit(moe_dg_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mla-dg"] and len(sys.argv) == 3:
        sys.exit(mla_dg_main(sys.argv[2]))
    if sys.argv[1:] == ["--lm-blockwise"]:
        sys.exit(lm_blockwise_main())
    sys.exit(main())
