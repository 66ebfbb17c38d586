"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Fifteen phases, any failure exits non-zero:

1. build -- generate the translation units of every kernel, operator, map
   and dtype combination the run's paths use (kernels/_lib.py, from each
   operator's and map's device form) and compile them with nvcc, one
   process per unit, all started together; print the time and each unit's
   registers and spills (and, for the AFFINE and MAXPLUS_AFFINE f32 units
   that xlstm-1.3b's K6 calls build, each K6 kernel's), and check that
   K10's bf16 units hold HGMMA in their SASS and spill nothing.
2. kernels -- hold each kernel of the serving paths (K2 flat scan, K6
   channel scan's channel-tile route and its long-T path, K3 flat
   mapreduce, K7m batched
   mapreduce, K7s batched scan, K4 matvec and vecmat) and of the matvec
   family (K7's batched matvec and vecmat; K9, the quantized matvec and
   vecmat, flat and batched, for int8, fp8_e4m3 and fp8_e5m2 codes) and
   K10 (fused attention, every GQA prefill) against its plain PyTorch
   version on the card, at the serving path's shapes, at ragged sizes (B =
   1 and 3, n and p at the block +-1, a quantization block that does not
   divide n, every one of the 256 fp8 codes, int8 leaves; for K10 T = 1,
   S and T at a tile +-1, query blocks at their edge +-1, B = 2, S != T,
   rows that keep no key, windows that skip whole kv tiles, head_dim 16
   to 256, in bf16 (tensor-core body) and float32 (CUDA-core body))
   and at full width: recurrentgemma-2b's decode-attention GEMVs (40,
   2048, 256), (8, 4096, 4096), its unembed GEMV (2560, 256000) quantized
   at block 64 (K7's wrapper and public call in turns with torch.bmm,
   every GEMV's device time by torch.profiler), and the prefill attention
   of a 2,100-token prompt in
   gemma2-27b (32 query / 16 kv heads of 128, soft cap 50, global and
   window 4096), recurrentgemma-2b (10 / 1 heads of 256, window 2048),
   gemma3-4b (8 / 4 heads of 256, global and window 1024), minitron-4b (24
   / 8 of 128), moonshot-v1-16b-a3b (16 / 16 of 128), deepseek-v3-671b's
   MLA (128 heads, q and k 192 wide, v 128) and seamless-m4t-medium (16 /
   16 of 64: its encoder, not causal; its decoder's self attention; its
   cross attention, 64 queries over 2,100 keys) in bf16, with v narrower
   than q in both bodies at ragged shapes too; time
   the kernel, the plain version and one PyTorch library call of the same
   function with CUDA events (K2, K3, K7m and K7s in turns with the
   library call, the median of 7 rounds; SDPA for K10, with the backend
   its dispatch picks).  K2 is one
   launch at every n (a tile, or the single-pass lookback above it):
   int32 ADD and int32 AFFINE with odd multipliers bit-exact from n = 1
   to 2^24 on each side of both tile sizes, and the same call 1,000 times
   on one stream.  K6's channel-tile route at the RG-LRU's shapes: int32
   AFFINE bit-exact, f32 AFFINE within 1e-5 x max|h| of a float64 walk,
   device ms by torch.profiler beside the bound; and at xlstm-1.3b's
   shapes: the mLSTM's chunk states, (1, 33, 4,194,304) and (1, 33, 4096)
   f32 AFFINE, on the same route and bound, and its stabilizer, (1, 2112,
   4) and (1, 1024, 4) f32 MAXPLUS_AFFINE on the long-T path, both leaves
   within 1e-5 of their size of a float64 walk.  K3 and K7s are
   held on both sides of their small forms' limits (K3 n = 2,047 / 2,048
   / 2,049: one block in one launch, or the multi-block form; K7s a tile
   of 2,048 and one more: the single-tile form, or the three-phase one),
   with the form each call took; their public calls are timed beside
   them.  K7m at every launch kind (LANES, BLOCK, SPLIT) and load width
   (16, 8, 4 bytes and one element a load): int32 ADD and MAX bit-exact,
   f32, the masked pair and UnitFloat8 within 1e-5 of each row's sum of
   |values|, at B = 1, n = 1, odd n, leaves 4-8 bytes off their alignment
   and split rows of 4 to 256 chunks; each call's kind and width by the
   wrapper's counter against the host's rule; a split f32 sum the same
   bits on 20 calls; the served call one allocation; the split rule
   against every chunk count at eleven f32 rows (K7M_SWEEP: device µs
   and each count's sums); then its six rows
   (K7M_ROWS: the served scores, the reference's bench row, few long rows,
   many short rows, MAX, UnitFloat8 codes) timed beside their bound and
   library call.  The "[host]" line gives the host microseconds of each stage
   of one K3 call at (4,) and one K7s call at (4, 64), in the wrappers'
   earlier form and now.  Every GEMV form (K4's short, chunked and
   row-wide forms, the tall-narrow vecmat, K5's flat stream) is held
   against its plain version with 16-byte and with one-element loads (p %
   4 != 0; A 4-byte but not 16-byte aligned) at edges such as (1, p), (n,
   1), (3, 5000) and (5000, 3): int32 TIMES over ADD / MAX / MIN
   bit-exact, the AFFINE fold in order, f64; each call's form (kind and
   load width, by the launcher's counter) must be the host's rule's.  K9's
   kinds (COLUMNS, STRIPS) in each load width (16, 4, 1 codes) at ragged
   shapes, blocks of 16 to 128 rows, B = 1..3 and operands whose codes lie
   1-15 bytes or whose scales lie 4 bytes off their alignment (no copy
   allocated): ADD over TIMES within 1e-5, MIN over PLUS bit-exact; the
   order of every quantized and K7 fold through D4 matrices (signed
   permutations under MAT2_MUL, exact at any length) bit-exact at shapes
   of several chunks; all 256 codes of each mode through both kinds.  The
   "[host] GEMV" line gives the host microseconds of each stage of a K4
   call at (1000, 10000) and a K5 call at (10^6, 10).
3. primitives -- the primitive library's own path: the public API
   (copy, scan, mapreduce, semiring matvec/vecmat, linear_recurrence,
   Segmented scan and mapreduce, sort_pairs, top_k, quickstart's sequence,
   matvec/vecmat at Batched layout and over Quantized operands at both
   layouts) at the paper's sizes (n up to 10^9, matrices up to 10^4 x
   10^4) and the model's GEMV shapes, with every operator of STD_OPS and
   every semiring of STD_SEMIRINGS on the cuda route, and the reroute of
   mapreduce(quaternion_mul, layout=Batched()) at (64, 65536), which must
   launch K7s and not K7m.  Counts every kernel's launches on that run,
   checks its outputs, holds K1 copy, K5 packed matvec and K8 segmented
   scan and every kernel the generated functors re-instantiate against
   their plain versions, and times each call beside its bound and library
   call (the Table IV scans in turns with torch.cumsum and the Table V/VI
   GEMVs in turns with torch.mv, with each call's launches and GEMV form;
   every scan and GEMV wrapper call must be one launch).
4. serve -- serve recurrentgemma-2b at full width (26 layers, d_model 2560,
   vocab 256000, bf16 weights from a seed) through Engine.generate: 8 greedy
   requests on 4 slots, so slots recycle.  Checks every request's length and
   ids, the prefill logits of the cuda backend (K10 attention) against the
   plain torch backend (blockwise attention) on the card at 17, 1,024 and
   2,100 tokens, and that the serving run launched every kernel of its
   path (K10 once per attention layer of every prefill at least, every
   K3 launch on its small form); then profiles one prefill (its device
   ms and K6's share) and eight
   decode steps (torch.profiler) for where the time goes, and the decode
   loop's predicate: one K3 launch a call and no memset on the device.
   Then the same requests through Engine(prefill_buckets="pow2"): every
   prompt right-padded to a power of two (the 2,100-token one to 4,096,
   past the 2,048-slot ring) and read at its own length; the streams'
   digest must be the exact-length run's (serve_bucketed).
5. sampled serve -- the same model through Engine(temperature=0.8,
   top_k=40, top_p=0.95, seed=0): the first four prompts, 16 new tokens
   each, request seeds 0-3.  Checks lengths and ids, that a second run and
   request 2 served alone give the same tokens, that the cuda and torch
   backends agree bit for bit on top_k and on the sampled ids of one decode
   step's (4, 256000) logits, a one-request full-vocabulary run at
   temperature 1.0, and that the run launched every kernel of its path;
   then profiles one sampled decode step.
6. serve gemma2-27b -- recurrentgemma's tensors freed, gemma2-27b at full
   width (46 layers, d_model 4608, 32 query / 16 kv heads, d_ff 36864,
   vocab 256000, local window 4096 alternating with global attention,
   post-norms, 27,227,128,320 parameters, counted from its config by
   param_count, bf16 weights from a seed) through
   Engine.generate as in phase 4: 8 greedy requests on 4 slots of 4,096
   positions, the same checks, K10 in all 46 layers of every prefill, the
   peak device memory, the same profile and a "pow2" bucketed run; then,
   with its weights still loaded, phase 13.
7. serve xlstm-1.3b -- gemma2's tensors freed, xlstm-1.3b at full width
   (48 layers: 42 mLSTM with 4 heads of dh 1024, 6 sLSTM; d_model 2048,
   vocab 50304; 1,907,394,896 parameters, bf16 weights from a seed) as in
   phase 4: the same 8 greedy requests on 4 slots, the cuda backend's
   prefill logits against the torch backend's at 17, 1,024 and 2,100
   tokens within 2e-2 of max|logit|, every kernel of its path launched (K2,
   K3, K6 for the chunk states, K6-long for the stabilizer, K7m), the
   same profile (with K6-long's share of the prefill), and the host
   seconds of the sLSTM's loop over time in a 1,024-token prefill, and a
   bucketed run at buckets three tokens above each prompt (the 64-token
   one exact: 67 tokens would take its prefill from one mLSTM chunk to
   two, which rounds otherwise).
8-10. serve gemma3-4b, minitron-4b and moonshot-v1-16b-a3b -- each after
   the previous model's tensors are freed, at full width (3,880,099,328,
   4,190,309,376 and 28,386,595,776 parameters, each counted from its
   config by param_count, bf16 weights from a seed) as in phase 6: the
   same 8 greedy requests on 4 slots of 4,096 positions, the backends'
   prefill logits at 17, 1,024 and 2,100 tokens against the float32
   floor (f32_floor: their logits are small beside their bf16 noise, so
   in float32 activations the two backends within 1e-3 of max|logit|,
   and in bf16 within twice the torch backend's own distance from
   float32), every kernel of GEMMA2_PATH launched, K10 in every attention layer of every prefill, the peak
   memory and the same profile.  gemma3-4b: qk-norm, 5 local (a ring of
   1,024 keys, which the 1,500- and 2,100-token prompts overrun) : 1
   global layers at head_dim 256; minitron-4b: relu2, an untied 256,000 x
   3,072 unembedding; moonshot-v1-16b-a3b: 47 MoE layers (64 experts
   top-6, 2 shared, a sigmoid router in float32), whose two prefills of a
   prompt must give the same logits to the bit, and the count of tokens
   that choose other experts on the cuda route than on the torch one.
11. serve deepseek-v3-671b -- moonshot's tensors freed, every published
   width (d_model 7168, 128 heads of MLA: q-LoRA 1536, kv-LoRA 512, q/k
   192 and v 128 wide; vocab 129,280) at 4 of its 61 layers (3 mla_dense,
   1 mla_moe: 256 experts top-8, one shared, a sigmoid router; the MTP
   head in the tree, never run): 15,797,367,040 parameters, counted by
   param_count, bf16 from a seed.  The engine's caches are the latent
   ckv (4, 4,096, 512) and krope (4, 4,096, 64) in bf16 per layer; one
   prefill launches K10 once per MLA layer in its (bf16, 192, 128) unit;
   then as phases 8-10: the 8 requests, f32_floor, moonshot's MoE checks,
   the profile.
12. serve seamless-m4t-medium -- deepseek's tensors freed, the
   encoder-decoder at full width and depth (12 bidirectional encoder
   layers, 12 decoder layers of causal self and cross attention; d_model
   1024, 16 heads of 64, relu MLPs, vocab 256,206): 614,739,968
   parameters, counted by param_count, bf16 from a seed.  The same 8
   greedy requests through Engine.generate, which runs the padded path
   (generate_padded: left-padded prompts, one prefill a batch over a zero
   source, as the reference engine's, then one decode step at one
   position a token) in two batches of four: every length and id, K10 36
   times a prefill, K7m once a batch (the scores); the run twice, equal
   digests.  A zero source makes every cross attention exactly zero, so
   the model is checked directly too, with 0.1 N(0, 1) frames: prefill
   and four decode steps at one position, the cuda backend against the
   torch one by the float32 floor (hold_floor), at decoder prompt / source
   lengths 17 / 17, 1,024 / 1,024, 2,100 / 2,100 and 64 / 2,100; one
   prefill's K10 launches (12 encoder + 12 self + 12 cross) in the (bf16,
   64) unit; a decode step at one position equal to the bit to the same
   step at a (B,) vector of it; then the profile of one prefill and of
   eight decode steps of four rows.
13. strategies (phase_strategies, run inside phase 6 on gemma2-27b's
   FULL weights): the 8 requests at 16 new tokens at most, 4 slots of
   4,096.  Speculative decoding (k = 4) with the target as its own draft
   (acceptance exactly 1.0) and with recurrentgemma-2b FULL from the seed
   as the draft, both giving the gemma2 phase's streams cut to 16; the
   recurrentgemma draft again sampled over the full vocabulary at
   temperature 1 on the first four prompts (8 new tokens), equal to
   vanilla sampling at the same seeds, with proposals rejected and rolled
   back (greedy random-init streams repeat the prompt's last token, which
   any draft guesses).  Beam search (width 4, 2 slots of 2,048, two
   requests) equal to reference_beam to the bit, scores included.
   Constrained decoding (greedy, a seeded 3-state DFA allowing 1% of the
   256,000 tokens in each state, four requests): no masked id, equal to
   reference_constrained.  quantize_kv int8 and fp8_e4m3 with
   poison_on_evict, sampled over the full vocabulary: every request served
   in a recycled slot equals it on a fresh engine.  Each run: its launches (each of its path's kernels
   launched), peak memory (under 80 GB), decode tokens/s and the device ms
   of one loop iteration with the slots full (device_busy).
14. train (phase_train, after seamless's tensors are freed): K10's forward
   log-sum-exp and its gradient (csrc/flash_attention_bwd.cuh: bf16 on the
   tensor cores, wgmma on a TMA ring; f32 on the CUDA cores) against
   ``flash_attention_bwd_ref`` at recurrentgemma-2b's layer (S = 4,096,
   window 2,048), gemma2-27b's global layer, deepseek-v3's MLA and
   seamless's cross attention (each timed beside its bound, the plain
   version, the forward with its log-sum-exp and SDPA's forward and
   backward with the case's mask, SDPA's backend named), one kv head of ten
   query heads split and folded, and at the gradient's tile edges, rows
   that keep no key, windows that skip tiles, in bf16 and f32; each case
   twice, the two gradients equal to the bit; K6's gradient
   (csrc/linrec_grad.cuh, K6-grad: one call of its short-T, channel-tile
   or long-T form) against its plain version and a float64 serial walk,
   two calls equal to the bit, at (1, 4096, 2560) with and without h0, B
   = 3, T at the short form's limit +-1, xlstm-1.3b's two chunk states,
   the long-T form, a reverse recurrence and a bf16 dh, a backward through
   autograd launching that form's kernels and no other (torch.profiler);
   the first train step's loss, grad norm and three leaves' gradients,
   cuda route against torch route, at one unit of recurrentgemma-2b at full width (float32
   within 1e-3, bf16 within twice the torch route's own distance from
   float32); recurrentgemma-2b FULL (26 layers, f32 master weights from
   the seed, AdamW, full remat, bf16 activations and gradients, one
   sequence of 4,096 tokens a step) for four steps: loss and grad norm
   finite, wall ms, tokens/s, peak memory (under 80 GB), the launches of
   K6, its gradient, K10 and its gradient (each launched), one
   step's device ms and idle share, and K10's, K10-bwd's and K6-grad's
   device ms in it; then the Trainer at smoke size in a temporary
   directory: a fault recovered, a run cut and resumed equal to an uncut
   one to the bit.
   Then xlstm-1.3b, recurrentgemma's tensors freed: the mLSTM
   stabilizer's gradient (MAXPLUS_AFFINE, kernels/ops.py's
   MaxplusAffineScan: one launch of csrc/maxplus_grad.cuh, which walks the
   reference's combine tree) against its plain version to the bit and
   autograd through a float64 serial walk at (1, 1024, 4), (1, 2112, 4),
   B = 3, T at 192 +-1, a wide shape and T = 12,000 (its levels in the
   workspace), and the reference's chain of four ties to the bit; the
   first step cuda vs torch at one unit (7 mLSTM + 1 sLSTM layers) at
   full width, as recurrentgemma's; xlstm-1.3b FULL (48 layers,
   1,907,394,896 parameters, f32 master weights, AdamW, full remat, bf16)
   for three steps of one 1,024-token sequence: loss and grad norm finite,
   wall ms, tokens/s, peak memory (under 80 GB), one step's device ms and
   idle share, the launches of K6, its gradient, K6-long and the
   stabilizer's gradient, and K6-grad's device ms.
15. tune (phase_tune): the autotuner (core/tuning.py) on a temporary cache
   file, for every tuned route at a served or paper shape (K1 10^8 f32; K2
   10^7 f32 ADD; K3 10^8 int32; K7m (8, 2^24); K7s (4, 64); K8 10^7 with
   about 10^4 segments; K7's matvec and vecmat (8, 4096, 4096); K6's
   linear_recurrence (1, 1024, 2560); the sort of 10^6 uint32 keys): the
   first call races the ladder (every candidate's units built in one
   parallel build first), every candidate's output is held to the plain
   version (bit for bit on integer-valued data; K6 within 1e-5 of max|h|),
   the winner's time beside the untuned call's in turns, a second call and
   a fresh tuner on the same file hit the cache with the launches of one
   call at the winner's policy; a [tune] line per route (its key, each candidate's ms, the
   winner, the units built and their build seconds).

Each serve summary holds its token streams' digest ("streams"), and each
profile the device ms under the decode step's aten ops ("ops_ms":
clone, _to_copy, index_put_, einsum, bmm, mm, ...), so two trees' runs
compare.

The line before the card line holds {"kernels": [...]}.  A kernel's
"launches" are those of the path its slice made the main one, named by
"launches_path": the primitives path for K1-K9, as before, gemma2's
serving path for K10, which the primitives path does not run, and phase
14's four FULL train steps ("train") for linear_recurrence's gradient
(K6-grad, csrc/linrec_grad.cuh) and K10's gradient (K10-bwd), and its
three xlstm-1.3b steps ("train_xlstm") for the mLSTM stabilizer's
gradient (MAXPLUS-grad, csrc/maxplus_grad.cuh).  Beside them
stand the launches on every path (primitives, greedy, sampled, gemma2,
xlstm, gemma3, minitron, moonshot, deepseek, seamless; phase 13's
speculative, speculative_draft, speculative_sampled, beam, constrained,
quantized_int8 and quantized_fp8_e4m3; the bucketed runs
bucketed_greedy, bucketed_gemma2 and bucketed_xlstm; train, train_xlstm)
and their sum,
"launches_total"; K10's
row its time, bound and SDPA time at each served model's prefill layers
("shapes"); K6's and K6-long's rows add their
checks at xlstm-1.3b's shapes ("xlstm"); K3's and K7s's rows add their
small form's launches per path ("launches_small", "launches_single-tile") and
the public call's time at the same shape ("public_ms"); K7m's its
launches by kind and width per path ("launches_kinds") and its timed
rows ("rows").  The last line is
{"ok": true, "device":
{...}}.  The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.core import operators as alg  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import batched as batched_k  # noqa: E402
from repro_torch.kernels import copy as copy_k  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.core import primitives as forge  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.layout import Batched, Flat, Segmented  # noqa: E402
from repro_torch.kernels import mapreduce as mapreduce_k  # noqa: E402
from repro_torch.kernels import matvec as matvec_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from repro_torch.kernels import segmented as seg_k  # noqa: E402
from repro_torch.models import blocks as BK  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as moe_m  # noqa: E402
from repro_torch.models import recurrent as rec_m  # noqa: E402
from repro_torch.serving import sampling as SP  # noqa: E402
from repro_torch.serving import strategies as ST  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.data import (  # noqa: E402
    DataConfig, SyntheticDataset)
from repro_torch.training.trainer import RunConfig, Trainer  # noqa: E402
from repro_torch.serving.strategies.ref import (  # noqa: E402
    reference_beam, reference_constrained)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores (same rate
                               # taken for int32 ALU operations)
BF16_OPS_PER_S = 989e12        # dense bf16 on the tensor cores
SEED = 0
BATCH = 4                      # Engine slots: the flat kernels see n = 4
CACHE_LEN = 4096
PROMPT_LENS = (17, 64, 200, 511, 1024, 1500, 2100, 300)
MAX_NEW = (16, 24, 32, 40, 48, 20, 28, 36)
SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95, seed=0)
SAMPLED_NEW = 16
N_SORT = BATCH * 256000            # the sampled top-k's flat (B V,) stream

# Each kernel's launch counter: (wrapper, attribute).  K6's wrapper counts
# its channel-tile route and its long-T path apart.
COUNTERS = {
    "K1": (copy_k.copy_cuda, "launches"),
    "K2": (scan_k.scan_1d_cuda, "launches"),
    "K6": (scan_k.scan_channel_cuda, "launches"),
    "K6-long": (scan_k.scan_channel_cuda, "long_t_launches"),
    "K3": (mapreduce_k.mapreduce_1d_cuda, "launches"),
    "K7m": (batched_k.batched_mapreduce_cuda, "launches"),
    "K7s": (batched_k.batched_scan_cuda, "launches"),
    "K4-matvec": (matvec_k.matvec_cuda, "launches"),
    "K4-vecmat": (matvec_k.vecmat_cuda, "launches"),
    "K5": (matvec_k.matvec_packed_cuda, "launches"),
    "K8": (seg_k.segmented_scan_1d_cuda, "launches"),
    "K7-matvec": (batched_k.batched_matvec_cuda, "launches"),
    "K7-vecmat": (batched_k.batched_vecmat_cuda, "launches"),
    "K9-matvec": (matvec_k.matvec_quantized_cuda, "launches"),
    "K9-vecmat": (matvec_k.vecmat_quantized_cuda, "launches"),
    "K9-batched-matvec": (batched_k.batched_matvec_quantized_cuda,
                          "launches"),
    "K9-batched-vecmat": (batched_k.batched_vecmat_quantized_cuda,
                          "launches"),
    "K10": (flash_k.flash_attention_gqa, "launches"),
    # Training (phase 14): linear_recurrence's gradient, the mLSTM
    # stabilizer's gradient and K10's gradient.
    "K6-grad": (scan_k.linrec_grad_cuda, "launches"),
    "MAXPLUS-grad": (scan_k.maxplus_grad_cuda, "launches"),
    "K10-bwd": (flash_k.flash_attention_bwd, "launches"),
}
GREEDY_PATH = ("K2", "K6", "K3", "K7m", "K10")
# K4's vecmat shares matvec's source but nothing on the serving path calls
# it: mapreduce over axis 1 is its only user.
SAMPLED_PATH = ("K2", "K6", "K6-long", "K3", "K7m", "K7s", "K4-matvec",
                "K10")
GEMMA2_PATH = ("K2", "K3", "K7m", "K10")   # no recurrence: no K6
# xLSTM: the mLSTM's chunk states on K6's channel-tile route, its
# stabilizer (MAXPLUS_AFFINE) on the long-T path from 128 steps; no
# attention, so no K10.
XLSTM_PATH = ("K2", "K6", "K6-long", "K3", "K7m")
XLSTM_PARAMS = 1_907_394_896
# xLSTM's bucketed run: buckets three tokens above each prompt, but for the
# 64-token one, which stays exact.  The pads' gates are neutral and their
# products exact zeros, so such a prefill is the exact-length one to the bit
# (measured on the H100) -- except where the bucket takes the prompt from one
# mLSTM chunk of 64 to two: 67 tokens gave logits 0.0625 apart and a stream
# that parts at its eighth token.
XLSTM_BUCKETS = tuple(n if n == 64 else n + 3 for n in PROMPT_LENS)
# Phase 13, the strategies on gemma2-27b: max_new_tokens capped at 16 (the
# greedy streams are then the first 16 tokens of the gemma2 phase's);
# speculative with k = 4 (15 loop tokens = 3 rounds of 5 with a perfect
# draft); beam width 4 over 2 slots of 2,048 (8 cache rows); a 3-state DFA
# allowing 1% of the vocabulary in each state.
STRATEGY_NEW = 16
SPEC_K = 4
SPEC_SAMPLED_NEW = 8
# The random-init models' greedy and top-k / top-p streams repeat the
# prompt's last token (its logit, about 10, beside some 256,000 near 0):
# full-vocabulary sampling at temperature 1 gives streams that depend on
# their context, for the runs that must show a stale cache or state.
FULL_VOCAB = dict(temperature=1.0, seed=0)
BEAM_WIDTH, BEAM_BATCH, BEAM_CACHE = 4, 2, 2048
DFA_STATES, DFA_DENSITY = 3, 0.01
# The acceptance chain (K7s), the loop predicate (K3), the drain (K2,
# K7m), the prefills (K10).
SPEC_PATH = ("K2", "K3", "K7m", "K7s", "K10")

# Beam: two segmented radix sorts a round (K4's histogram, K6-long's
# ranks, K2's segment starts), the non-EOS rank (K7s); no K7m (the answer's
# score is an argmax, not a masked sum).
BEAM_PATH = ("K2", "K3", "K4-matvec", "K6-long", "K7s", "K10")
GEMMA2_PARAMS = 27_227_128_320
# The counters only training moves.
TRAIN_ONLY = ("K6-grad", "MAXPLUS-grad", "K10-bwd")
# The library's own path runs every kernel but the models' attention.
PRIMITIVES_PATH = tuple(k for k in COUNTERS
                        if k != "K10" and k not in TRAIN_ONLY)
# The path whose launches a kernel's "launches" report: its slice's main one.
MAIN_PATH = {k: "train_xlstm" if k == "MAXPLUS-grad" else
             "train" if k in TRAIN_ONLY else
             "primitives" if k in PRIMITIVES_PATH else "gemma2"
             for k in COUNTERS}
META = {
    "K1": ("copy", "src/repro_torch/csrc/copy.cuh",
           "src/repro/kernels/copy.py:24"),
    "K2": ("scan_1d", "src/repro_torch/csrc/scan.cuh",
           "src/repro/kernels/scan.py:139"),
    "K6": ("scan_channel", "src/repro_torch/csrc/scan.cuh",
           "src/repro/kernels/scan.py:227"),
    "K3": ("mapreduce_1d", "src/repro_torch/csrc/mapreduce.cuh",
           "src/repro/kernels/mapreduce.py:81"),
    "K7m": ("batched_mapreduce", "src/repro_torch/csrc/mapreduce.cuh",
            "src/repro/kernels/batched.py:121"),
    "K6-long": ("scan_channel long-T", "src/repro_torch/csrc/scan.cuh",
                "src/repro/kernels/scan.py:227"),
    "K7s": ("batched_scan", "src/repro_torch/csrc/scan.cuh",
            "src/repro/kernels/batched.py:85"),
    "K4-matvec": ("matvec", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/matvec.py:117"),
    "K4-vecmat": ("vecmat", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/matvec.py:386"),
    "K5": ("matvec_packed", "src/repro_torch/csrc/matvec.cuh",
           "src/repro/kernels/matvec.py:292"),
    "K8": ("segmented_scan_1d", "src/repro_torch/csrc/segmented.cuh",
           "src/repro/kernels/segmented.py:141"),
    "K7-matvec": ("batched_matvec", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/batched.py:173"),
    "K7-vecmat": ("batched_vecmat", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/batched.py:205"),
    "K9-matvec": ("matvec_quantized", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/matvec.py:189"),
    "K9-vecmat": ("vecmat_quantized", "src/repro_torch/csrc/matvec.cuh",
                  "src/repro/kernels/matvec.py:460"),
    "K9-batched-matvec": ("batched_matvec_quantized",
                          "src/repro_torch/csrc/matvec.cuh",
                          "src/repro/kernels/batched.py:237"),
    "K9-batched-vecmat": ("batched_vecmat_quantized",
                          "src/repro_torch/csrc/matvec.cuh",
                          "src/repro/kernels/batched.py:274"),
    "K10": ("flash_attention", "src/repro_torch/csrc/flash_attention.cuh",
            "src/repro/kernels/flash_attention.py:83"),
    "K6-grad": ("linrec_grad (linear_recurrence's gradient: the adjoint "
                "scan fused with its shift and products)",
                "src/repro_torch/csrc/linrec_grad.cuh",
                "src/repro/kernels/scan.py:227"),
    "MAXPLUS-grad": ("maxplus_grad (the mLSTM stabilizer's gradient, in "
                     "the reference's combine tree)",
                     "src/repro_torch/csrc/maxplus_grad.cuh",
                     "src/repro/kernels/scan.py:227"),
    "K10-bwd": ("flash_attention_bwd (K10's gradient)",
                "src/repro_torch/csrc/flash_attention_bwd.cuh",
                "src/repro/kernels/flash_attention.py:83"),
}


# The small forms' launches, counted again among their kernel's: K3's
# single block (n <= 2,048) and K7s's single tile (n <= one tile a row).
FORMS = {
    "K3 small": (mapreduce_k.mapreduce_1d_cuda, "small_launches"),
    "K7s single-tile": (batched_k.batched_scan_cuda, "single_tile_launches"),
}


def reset_counts() -> None:
    for obj, attr in (*COUNTERS.values(), *FORMS.values()):
        setattr(obj, attr, 0)
    matvec_k.form_launches.clear()
    batched_k.form_launches.clear()
    flash_k.unit_launches.clear()
    scan_k.linrec_grad_cuda.form_launches.update(
        dict.fromkeys(scan_k.LINREC_FORMS, 0))


def read_counts() -> dict:
    """Every counter: the kernels', their small forms', the GEMV and
    K7m launches by kind and load width ("GEMV columns/4", "GEMV tall/1",
    "K7m lanes/4") and K6-grad's by form ("K6-grad short")."""
    return {**{k: getattr(obj, attr)
               for k, (obj, attr) in (*COUNTERS.items(), *FORMS.items())},
            **{f"GEMV {k}": v for k, v in matvec_k.form_launches.items()},
            **{f"K7m {k}": v for k, v in batched_k.form_launches.items()},
            **{f"K6-grad {k}": v for k, v in
               scan_k.linrec_grad_cuda.form_launches.items()}}


class CheckFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, after a
    warm-up call, between CUDA events (includes the host side of a call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns: dict, rounds: int = 7, reps: int = 200) -> dict:
    """Milliseconds per call of each of ``fns`` at the serving path's tiny
    shapes, whose time is the host's and drifts within a run: ``rounds``
    rounds of ``reps`` back-to-back calls of each (time_ms), in turns, the
    order reversed every other round; the median round of each.  A kernel
    and its library call so see the same moments of the host."""
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(time_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(bytes_moved: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    got, want = torch.utils._pytree.tree_leaves(got), \
        torch.utils._pytree.tree_leaves(want)
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def expect(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)
    log(f"  ok  {msg}")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


# matvec's f(x, a) = (x, a): folding these pairs under AFFINE is an
# operator that does not commute, so K4 must keep row (column) order.
PAIR = alg.DeviceMap("pair", lambda u, v: (u, v), "return x;")
# Shear terms [[1, x a], [0, 1]] under MAT2_MUL, an operator that does not
# commute (tests/test_conformance.py's mat2_mul case); matvec's f(x, a) and
# vecmat's f(a, x).
SHEAR = alg.DeviceMap(
    "shear", lambda x, a: (1.0 + 0 * a, x * a, 0 * a, 1.0 + 0 * a),
    "Out r; r.v0 = __fadd_rn(1.0f, __fmul_rn(0.0f, x.v1)); "
    "r.v1 = rt::mul_rn(x.v0, x.v1); r.v2 = __fmul_rn(0.0f, x.v1); "
    "r.v3 = r.v0; return r;")
SHEAR_VM = alg.DeviceMap(
    "shear_vm", lambda a, x: (1.0 + 0 * a, a * x, 0 * a, 1.0 + 0 * a),
    "Out r; r.v0 = __fadd_rn(1.0f, __fmul_rn(0.0f, x.v0)); "
    "r.v1 = rt::mul_rn(x.v0, x.v1); r.v2 = __fmul_rn(0.0f, x.v0); "
    "r.v3 = r.v0; return r;")


def _d4(x, a):
    """The element of the dihedral group of order 8 that the integer x a
    picks (x a mod 8: a rotation by 90 (x a mod 4) degrees, reflected when
    bit 2 is set), as MAT2_MUL's (m00, m01, m10, m11)."""
    i = (x * a).to(torch.int32) & 7
    one = torch.ones_like(i, dtype=torch.float32)
    c = torch.where(i & 1 != 0, 0 * one, torch.where(i & 2 != 0, -one, one))
    s = torch.where(i & 1 != 0, torch.where(i & 2 != 0, -one, one), 0 * one)
    refl = i & 4 != 0
    return c, torch.where(refl, s, -s), s, torch.where(refl, -c, c)


# Signed permutation matrices under MAT2_MUL: a group that does not commute
# and whose products keep entries in {-1, 0, 1}, so a fold of any length is
# exact and a fold in another order gives another matrix (7 times in 8).
# x a must be an integer (small integers, power-of-two scales); the product
# is symmetric, so one map serves matvec's f(x, a) and vecmat's f(a, x).
D4 = alg.DeviceMap(
    "d4", _d4,
    "const int i = static_cast<int>(__fmul_rn(x.v0, x.v1)) & 7; "
    "const float c = (i & 1) ? 0.0f : ((i & 2) ? -1.0f : 1.0f); "
    "const float s = (i & 1) ? ((i & 2) ? -1.0f : 1.0f) : 0.0f; "
    "Out r; r.v0 = c; r.v2 = s; "
    "if (i & 4) { r.v1 = s; r.v3 = -c; } else { r.v1 = -s; r.v3 = c; } "
    "return r;")
# K7's GEMVs and K9's four forms: (kernel, wrapper, plain version, the
# shear map of its form or whether it is a matvec, batched).
K7_FORMS = (("K7-matvec", batched_k.batched_matvec_cuda,
             batched_k.batched_matvec_plain, SHEAR, True),
            ("K7-vecmat", batched_k.batched_vecmat_cuda,
             batched_k.batched_vecmat_plain, SHEAR_VM, False))
K9_FORMS = (("K9-matvec", matvec_k.matvec_quantized_cuda,
             matvec_k.matvec_quantized_plain, True, False),
            ("K9-vecmat", matvec_k.vecmat_quantized_cuda,
             matvec_k.vecmat_quantized_plain, False, False),
            ("K9-batched-matvec", batched_k.batched_matvec_quantized_cuda,
             batched_k.batched_matvec_quantized_plain, True, True),
            ("K9-batched-vecmat", batched_k.batched_vecmat_quantized_cuda,
             batched_k.batched_vecmat_quantized_plain, False, True))
QUANT_BLOCK = 64
UNEMBED = (2560, 256000)           # recurrentgemma-2b's unembed GEMV
ATTN = (40, 2048, 256)             # 4 slots x 10 heads, 2,048-token window
BIG_BATCHED = (8, 4096, 4096)
LEAVES = {"affine": 2, "maxplus_affine": 2, "softmax_merge": 3,
          "quaternion_mul": 4, "mat2_mul": 4}


def path_units() -> list:
    """Every generated unit the run's paths call, so that all of them
    compile at once, in parallel, before anything is timed."""
    f32, f64, i32, u8 = torch.float32, torch.float64, torch.int32, torch.uint8
    units = [_lib.unit("copy", "build")]
    for op in alg.STD_OPS.values():
        units.append(_lib.unit("scan", "build", op,
                               [f32] * LEAVES.get(op.name, 1)))
    for op in (alg.ADD, alg.MAX, alg.MIN, alg.MUL):
        units.append(_lib.unit("scan", "build", op, [i32]))
    units.append(_lib.unit("scan", "build", alg.AFFINE, [i32, i32]))
    units.append(_lib.unit("scan", "build", alg.ADD, [f64]))
    for op, dts in ((alg.ADD, [f32]), (alg.ADD, [i32]), (alg.MAX, [f32]),
                    (alg.QUATERNION_MUL, [f32] * 4)):
        units.append(_lib.unit("segscan", "build", alg.segmented(op),
                               [i32] + dts))

    def mapped(family, f, op, *dtypes, quant=None):
        likes = [torch.empty(0, dtype=d) for d in dtypes]
        if f is alg.masked_select:
            f, likes = f(0.0), [tuple(likes)]
        units.append(_lib.map_unit(family, "build", f, op, *likes,
                                   quant=quant)[0])

    mapped("mapreduce", alg.IDENTITY, alg.MAX, i32)
    mapped("mapreduce", alg.IDENTITY, alg.ADD, i32)
    mapped("mapreduce", alg.IDENTITY, alg.MAX, f32)
    mapped("mapreduce", alg.IDENTITY, alg.ADD, f32)
    mapped("mapreduce", alg.masked_select, alg.ADD, f32, i32)
    mapped("mapreduce", alg.unitfloat8_decode, alg.ADD, u8)
    for sr in alg.STD_SEMIRINGS.values():
        mapped("matvec", sr.f, sr.op, f32, f32)
    for op in (alg.ADD, alg.MAX, alg.MIN, alg.MUL):
        mapped("matvec", alg.TIMES, op, i32, i32)
    mapped("matvec", alg.IDENTITY, alg.ADD, i32)
    mapped("matvec", PAIR, alg.AFFINE, f32, f32)
    mapped("matvec", PAIR, alg.AFFINE, i32, i32)
    # K7 over ADD/TIMES and MIN/PLUS shares the flat units above.
    mapped("matvec", SHEAR, alg.MAT2_MUL, f32, f32)
    mapped("matvec", SHEAR_VM, alg.MAT2_MUL, f32, f32)
    mapped("matvec", D4, alg.MAT2_MUL, f32, f32)
    mapped("matvec", alg.TIMES, alg.ADD, torch.int8, torch.int8)
    mapped("matvec", alg.TIMES, alg.ADD, f64, f64)
    for mode in alg.QUANT_MODES:                         # K9, every form
        mapped("qmatvec", alg.TIMES, alg.ADD, f32, f32, quant=mode)
    mapped("qmatvec", alg.PLUS, alg.MIN, f32, f32, quant="int8")
    mapped("qmatvec", D4, alg.MAT2_MUL, f32, f32, quant="int8")
    for dtype, hd, dv in K10_UNITS:
        units.append(flash_k.flash_unit(dtype, hd, "build", dv))
    for dtype, hd, dv in K10B_UNITS:
        units.append(flash_k.flash_unit(dtype, hd, "build", dv))
        units.append(flash_k.flash_bwd_unit(dtype, hd, "build", dv))
    units.append(_lib.unit("maxplus_grad", "build"))
    for dh in sorted({c.dh for c in K6G_CASES}, key=str):
        units.append(_lib.unit("linrec_grad", "build", dtypes=(F32, dh)))
    return units


def sass_ops(lib, ops=("HGMMA", "HMMA")) -> dict:
    """How many of each tensor-core instruction a built library's SASS
    holds (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise CheckFailed(f"cuobjdump -sass {lib}: {out.stderr.strip()}")
    return {op: len(re.findall(rf"\b{op}\b", out.stdout)) for op in ops}


def phase_build() -> dict:
    units = path_units()
    t0 = time.perf_counter()
    _lib.build(units)
    seconds = time.perf_counter() - t0
    log(f"[build] {len(units)} generated units in {seconds:.2f} s "
        f"({_lib.BUILD_DIR})")
    worst = {"registers": 0, "spilled_units": []}
    spilled = {}
    for u in units:
        text = u.path.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
        log(f"  ptxas {u.label}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers and {max(smem, default=0)} "
            f"bytes of shared memory, {spills} bytes spilled")
        worst["registers"] = max(worst["registers"], max(regs, default=0))
        spilled[u.label] = spills
        if spills:
            worst["spilled_units"].append([u.label, spills])
    # K10's bf16 units run the tensor-core body: their SASS must hold the
    # warpgroup products, and none may spill.
    for dtype, hd, dv in K10_UNITS:
        if dtype != BF16:
            continue
        u = flash_k.flash_unit(dtype, hd, "build", dv)
        ops = sass_ops(u.path)
        log(f"  sass {u.label}: {ops}")
        expect(ops["HGMMA"] > 0, f"{u.label}: SASS holds HGMMA "
                                 f"({ops['HGMMA']} instructions)")
        expect(spilled[u.label] == 0, f"{u.label}: ptxas reports no spills")
    # So must K10's gradient's bf16 units (wgmma on a TMA ring).
    for dtype, hd, dv in K10B_UNITS:
        if dtype != BF16:
            continue
        u = flash_k.flash_bwd_unit(dtype, hd, "build", dv)
        ops = sass_ops(u.path)
        log(f"  sass {u.label}: {ops}")
        expect(ops["HGMMA"] > 0 and "TensorCores" in u.source,
               f"{u.label}: the tensor-core body, its SASS holds HGMMA "
               f"({ops['HGMMA']} instructions)")
        expect(spilled[u.label] == 0, f"{u.label}: ptxas reports no spills")
    # The units of xlstm-1.3b's K6 calls (AFFINE for the chunk states,
    # MAXPLUS_AFFINE for the stabilizer, f32): each K6 kernel's registers
    # and spilled bytes.
    xlstm = {}
    for op in (alg.AFFINE, alg.MAXPLUS_AFFINE):
        u = _lib.unit("scan", "build", op, [torch.float32] * 2)
        xlstm[u.label] = kernel_resources(u.path.with_suffix(".log")
                                          .read_text())
        log(f"  xlstm {u.label}: {json.dumps(xlstm[u.label])}")
    return {"units": len(units), "seconds": seconds, "prebuilt": {
        u.digest for u in units}, "xlstm_units": xlstm, **worst}


K6_KERNELS = ("scan_channel_tiles", "chunk_aggregates", "scan_totals",
              "chunk_rescan")


def kernel_resources(ptxas_log: str) -> dict:
    """Registers and spilled bytes (stores and loads) of each K6 kernel
    (``K6_KERNELS``) in a unit's ``-Xptxas -v`` log."""
    out = {}
    for block in ptxas_log.split("Compiling entry function")[1:]:
        entry = block.split("'")[1] if "'" in block else ""
        name = next((n for n in K6_KERNELS if n in entry), None)
        if name is None:
            continue
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", block)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", block))
        r = out.setdefault(name, {"registers": 0, "spill_bytes": 0})
        r["registers"] = max([r["registers"], *regs])
        r["spill_bytes"] += spills
    return out


# ---------------------------------------------------------------------------
# K7m's rows: the served call and five device-bound shapes, timed beside
# their bound and library call
# ---------------------------------------------------------------------------

# (label, (B, n), what): "masked" is the engine's per-slot scores (f32 and
# an int32 mask), "uf8" UnitFloat8 codes decoded to f32 and summed.
K7M_ROWS = (
    ("served", (BATCH, CACHE_LEN), "masked"),
    ("reference bench", (64, 16384), "add"),
    ("few long rows", (8, 1 << 24), "add"),
    ("many short rows", (1 << 18, 256), "add"),
    ("MAX", (4096, 65536), "max"),
    ("1-byte codes", (16384, 16384), "uf8"),
)


def k7m_operands(gen, B: int, n: int, what: str):
    """(map, operator, leaves, library call) of one K7m row."""
    dev = "cuda"
    if what == "masked":
        logp = -torch.rand(B, n, generator=gen, device=dev) * 12
        emitted = torch.randint(0, n + 1, (B,), generator=gen, device=dev)
        mask = (torch.arange(n, device=dev)[None] < emitted[:, None]).int()
        return alg.masked_select(0.0), alg.ADD, (logp, mask), \
            lambda: torch.sum(torch.where(mask != 0, logp, 0.0), dim=1)
    if what == "uf8":
        u = torch.randint(0, 256, (B, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        return alg.unitfloat8_decode, alg.ADD, u, \
            lambda: torch.sum(alg.unitfloat8_decode(u), dim=1)
    x = torch.randn(B, n, generator=gen, device=dev)
    if what == "max":
        return alg.IDENTITY, alg.MAX, x, lambda: torch.amax(x, dim=1)
    return alg.IDENTITY, alg.ADD, x, lambda: torch.sum(x, dim=1)


def k7m_row(gen, label: str, B: int, n: int, what: str) -> dict:
    """One K7m row: the wrapper and its library call in turns (CUDA events,
    median of 7 rounds), each one's device ms a call (torch.profiler), the
    plain version, the bound (each leaf read once, the (B,) f32 result
    written once) and its launch kind and width."""
    f, op, xs, library = k7m_operands(gen, B, n, what)
    leaves = torch.utils._pytree.tree_leaves(xs)
    nbytes = sum(l.nbytes for l in leaves) + 4 * B
    ops = B * n * {"add": 1, "max": 1, "masked": 2, "uf8": 3}[what]
    fn = lambda: batched_k.batched_mapreduce_cuda(f, op, xs)  # noqa: E731
    before = dict(batched_k.form_launches)
    fn()
    form = [k for k, v in batched_k.form_launches.items()
            if v != before.get(k, 0)]
    big = nbytes > 1 << 24
    row = {"row": label, "shape": f"({B}, {n}) {what}", "bytes": nbytes,
           **time_turns({"ms": fn, "library_ms": library},
                        reps=20 if big else 200),
           "device_ms": call_device_ms(fn),
           "library_device_ms": call_device_ms(library),
           "plain_ms": time_ms(lambda: batched_k.batched_mapreduce_plain(
               f, op, xs), 3 if big else 20),
           "bound": bound_ms(nbytes, ops), "form": form}
    row["x_bound"] = (row["device_ms"] or math.nan) / row["bound"][0]
    row["x_library"] = row["ms"] / row["library_ms"]
    log(f"[K7m] {json.dumps(row)}")
    return row


# check_k7m's cases: (B, n, what, leaf offset in elements, kind/width the
# host's rule gives).  "i32" / "i32max": int32 ADD / MAX, bit-exact; "f32",
# "masked", "uf8": within 1e-5 of each row's sum of |values|.  A leaf 1 or
# 2 f32 elements past its 16-byte boundary takes 4- or 8-byte loads.
K7M_CASES = (
    (8, 64, "i32", 0, "lanes/4"), (8, 64, "i32max", 0, "lanes/4"),
    (8, 64, "masked", 0, "lanes/4"), (1 << 12, 256, "f32", 0, "lanes/4"),
    (3, 257, "i32", 0, "lanes/1"), (3, 257, "f32", 0, "lanes/1"),
    (5, 1, "i32max", 0, "lanes/1"), (1, 1, "f32", 0, "lanes/1"),
    (1, 1, "masked", 0, "lanes/1"), (3, 257, "masked", 0, "lanes/1"),
    (7, 130, "f32", 0, "lanes/2"), (64, 512, "uf8", 0, "lanes/16"),
    (1, 400, "i32", 1, "lanes/1"), (9, 1000, "i32max", 2, "lanes/2"),
    (1, 2048, "i32", 1, "block/1"),
    (BATCH, CACHE_LEN, "masked", 0, "block/4"),
    (600, 4096, "i32", 0, "block/4"), (600, 4096, "i32max", 0, "block/4"),
    (300, 16384, "uf8", 0, "block/16"), (530, 4100, "masked", 1, "block/1"),
    (200, 24576, "i32", 0, "block/4"),
    (2, 4 * (5 * 8192 + 3), "i32", 0, "split/4"),
    (2, 4 * (5 * 8192 + 3), "i32max", 0, "split/4"),
    (5, 4 * (7 * 8192 + 5), "i32", 0, "split/4"),
    (8, 1 << 20, "f32", 0, "split/4"), (1, 1 << 20, "i32", 0, "split/4"),
    (8, 1 << 22, "i32", 0, "split/4"), (1, 1 << 23, "i32", 0, "split/4"),
    (2, 100001, "f32", 0, "split/1"), (3, 1 << 16, "i32", 1, "split/1"),
    (4, 1 << 20, "uf8", 0, "split/16"), (6, 1 << 16, "masked", 2,
                                          "split/2"),
)


def k7m_case(gen, B: int, n: int, what: str, offset: int):
    """(map, operator, leaves, per-row bound) of a check_k7m case; the
    leaves start ``offset`` elements past a 16-byte boundary."""
    dev = "cuda"

    def placed(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    if what in ("i32", "i32max"):
        x = placed(torch.randint(-2**31, 2**31 - 1, (B, n), generator=gen,
                                 device=dev, dtype=torch.int32))
        return alg.IDENTITY, alg.ADD if what == "i32" else alg.MAX, x, None
    if what == "uf8":
        u = placed(torch.randint(0, 256, (B, n), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint8))
        return alg.unitfloat8_decode, alg.ADD, u, \
            alg.unitfloat8_decode(u).abs().sum(1)
    v = placed(torch.randn(B, n, generator=gen, device=dev))
    if what == "f32":
        return alg.IDENTITY, alg.ADD, v, v.abs().sum(1)
    mask = placed((torch.rand(B, n, generator=gen, device=dev) > 0.3).int())
    return alg.masked_select(0.0), alg.ADD, (v, mask), \
        (v.abs() * mask).sum(1)


def check_k7m_forms(gen, note) -> None:
    """K7m, every launch kind and load width against its plain version
    (K7M_CASES: B = 1, n = 1, odd n, leaves off their alignment, split rows
    of 4, 5, 7, 8, 12, 32, 66 and 256 chunks, a last chunk shorter than the
    others), each call one launch of the kind and width the host's rule
    gives, a split launch leaving the stream's counters at 0; a split f32
    sum the same bits on every call (its chunks fold in order); the served
    call allocates its output and nothing else."""
    k7m = batched_k.batched_mapreduce_cuda
    for B, n, what, offset, form in K7M_CASES:
        f, op, xs, scale = k7m_case(gen, B, n, what, offset)
        before = dict(batched_k.form_launches)
        got = one_launch("K7m", lambda: k7m(f, op, xs))
        ran = [k for k, v in batched_k.form_launches.items()
               if v != before.get(k, 0)]
        want = batched_k.batched_mapreduce_plain(f, op, xs)
        err = max_err(got, want)
        note("K7m", err)
        if scale is None:
            ok, bound = torch.equal(got, want), "bit-exact"
        else:
            ok = bool(((got - want).abs() <= 1e-5 * scale).all())
            bound = "within 1e-5 x each row's sum|v|"
        if form.startswith("split"):
            # Each row's last block set its counter back to 0.
            counters = _lib.workspace(got, _lib.stream_ptr(got), 0, 0).counters
            ok = ok and int(counters.count_nonzero()) == 0
            bound += ", the stream's counters 0 at rest"
        expect(ok and ran == [form] and got.shape == (B,),
               f"K7m {what} ({B}, {n}), offset {offset}: {ran} "
               f"(want {form}), max abs err {err:.3g}, {bound}")
    f, op, xs, _ = k7m_case(gen, 8, 1 << 20, "f32", 0)
    first = k7m(f, op, xs)
    expect(all(torch.equal(k7m(f, op, xs), first) for _ in range(20)),
           "K7m f32 (8, 1048576), 32 chunks a row: 20 more calls give the "
           "same bits")
    f, op, xs, _ = k7m_case(gen, BATCH, CACHE_LEN, "masked", 0)
    k7m(f, op, xs)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    k7m(f, op, xs)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    expect(allocs == 1, f"K7m served ({BATCH}, {CACHE_LEN}) masked call: "
                        f"{allocs} allocation (its output)")


# The split rule's sweep (kernels/batched.py: SPLIT_LOADS, SPLIT_MIN): f32
# ADD rows around the rule's edges, each cut into every count of
# SWEEP_CHUNKS that gives a thread a load or more and the grid at most 8
# blocks a multiprocessor, and into the rule's own count.
K7M_SWEEP = ((64, 16384), (64, 131072), (64, 262144), (16, 65536),
             (16, 262144), (8, 1 << 20), (4, 1 << 20), (1, 65536),
             (1, 1 << 20), (1, 1 << 22), (200, 98304))
SWEEP_CHUNKS = (1, 2, 3, 4, 6, 8, 16, 32, 66, 132, 264, 528)


def k7m_sweep(gen, note) -> None:
    """Device µs a call (torch.profiler) of each K7M_SWEEP row at each
    chunk count, the call's planned geometry replaced by a hand-made one;
    each count's sums within 1e-5 of each row's sum|v|.  Prints one
    ``[K7m sweep]`` line a row: the rule's count, the fastest count and
    every count's µs."""
    k7m = batched_k.batched_mapreduce_cuda
    blocks = 8 * matvec_k.sms(0)
    for B, n in K7M_SWEEP:
        x = torch.randn(B, n, generator=gen, device="cuda")
        want, scale = batched_k.batched_mapreduce_plain(
            alg.IDENTITY, alg.ADD, x), x.abs().sum(1)
        batched_k._ROWS_CALLS.clear()
        k7m(alg.IDENTITY, alg.ADD, x)
        call, = batched_k._ROWS_CALLS.values()
        planned, planned_bytes = call.geo, call.partial_bytes
        vec, rule = planned[1], planned[5]
        loads = n // vec
        counts = sorted({c for c in SWEEP_CHUNKS
                         if c <= max(1, loads // batched_k.ROWS_THREADS)
                         and B * c <= blocks} | {rule})
        us = {}
        for c in counts:
            per = -(-loads // c)
            c = -(-loads // per)
            call.geo_array[:] = (batched_k.SPLIT if c > 1 else
                                 batched_k.BLOCK, vec, batched_k.ROWS_THREADS,
                                 B, n, c, per)
            call.partial_bytes = 4 * B * c if c > 1 else 0
            got = k7m(alg.IDENTITY, alg.ADD, x)
            note("K7m", max_err(got, want))
            expect(bool(((got - want).abs() <= 1e-5 * scale).all()),
                   f"K7m sweep ({B}, {n}) f32 ADD, {c} chunks a row: within "
                   f"1e-5 x each row's sum|v|")
            ms = call_device_ms(lambda: k7m(alg.IDENTITY, alg.ADD, x))
            us[c] = ms * 1e3 if ms else None
        call.geo_array[:], call.partial_bytes = planned, planned_bytes
        seen = {c: t for c, t in us.items() if t is not None}
        best = min(seen, key=seen.get) if seen else None
        log("[K7m sweep] " + json.dumps({
            "B": B, "n": n, "MB": x.nbytes / 1e6, "rule": rule, "best": best,
            "rule_over_best": us[rule] / us[best] if us[rule] and best
            else None, "us": us}))


def check_k7m(res, gen, note) -> None:
    """K7m's forms (check_k7m_forms), the split rule's sweep (k7m_sweep),
    then K7M_ROWS timed (k7m_row); the served row is the kernels line's,
    the others ride with it."""
    check_k7m_forms(gen, note)
    k7m_sweep(gen, note)
    rows = [k7m_row(gen, label, *shape, what)
            for label, shape, what in K7M_ROWS]
    served = rows[0]
    res["K7m"].update({k: served[k] for k in (
        "ms", "library_ms", "plain_ms", "bound", "device_ms", "shape")})
    res["K7m"]["rows"] = [{k: r[k] for k in (
        "row", "shape", "ms", "device_ms", "library_ms", "library_device_ms",
        "x_bound", "x_library", "form")} | {"bound_ms": r["bound"][0]}
        for r in rows]


def streams_digest(outs) -> str:
    """A short hash of a serve run's token streams, to compare two trees'."""
    return hashlib.sha256(json.dumps(outs).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------


def phase_kernels(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    res = {k: {"max_abs_err": 0.0} for k in COUNTERS}

    def ints(n):
        return torch.randint(-100, 100, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def note(k, err):
        res[k]["max_abs_err"] = max(res[k]["max_abs_err"], err)

    check_k2(res, gen, note)
    check_k6(res, gen, note)

    # -- K3: flat mapreduce.  MAX over int32 is bit-exact; the masked ADD leg
    # is f32 in another fold order, held at 1e-5 relative.  Up to one
    # block's 2,048 elements the small form runs, above it the multi-block
    # one; the counter says which ran.
    block = 256 * 8
    k3 = mapreduce_k.mapreduce_1d_cuda

    def k3_form(fn):
        small = k3.small_launches
        out = fn()
        return out, "small" if k3.small_launches > small else "multi-block"

    for n in (BATCH, 8, 1, block - 1, block, block + 1, 1 << 24):
        x = ints(n)
        got, form = k3_form(lambda: k3(alg.IDENTITY, alg.MAX, x))
        want = mapreduce_k.mapreduce_1d_plain(alg.IDENTITY, alg.MAX, x)
        err = max_err(got, want)
        note("K3", err)
        expect(err == 0 and int(got) == int(x.max()) and form == (
            "small" if n <= block else "multi-block"),
            f"K3 MAX int32 n={n}: bit-exact, {form} form")
    for n in (1000, 1 << 20):
        v = torch.randn(n, generator=gen, device=dev)
        m = (torch.rand(n, generator=gen, device=dev) > 0.5).int()
        got, form = k3_form(lambda: k3(alg.masked_select(0.0), alg.ADD,
                                       (v, m)))
        want = mapreduce_k.mapreduce_1d_plain(alg.masked_select(0.0),
                                              alg.ADD, (v, m))
        err = max_err(got, want)
        scale = float(v.abs().sum())
        expect(err <= 1e-5 * scale, f"K3 masked ADD f32 n={n}, {form} form: "
                                    f"max abs err {err:.3g} <= 1e-5 x sum|v| "
                                    f"{scale:.3g}")
    x = (torch.rand(BATCH, generator=gen, device=dev) > 0.5).int()
    res["K3"].update(time_turns({
        "ms": lambda: mapreduce_k.mapreduce_1d_cuda(alg.IDENTITY, alg.MAX, x),
        "library_ms": lambda: torch.amax(x),
        "public_ms": lambda: forge.mapreduce(alg.IDENTITY, alg.MAX, x)}))
    res["K3"]["plain_ms"] = time_ms(
        lambda: mapreduce_k.mapreduce_1d_plain(alg.IDENTITY, alg.MAX, x))
    res["K3"]["bound"] = bound_ms(4 * BATCH + 4, BATCH)
    res["K3"]["shape"] = f"({BATCH},) int32 MAX"
    big = ints(1 << 24)
    res["K3"]["large"] = {
        "n": 1 << 24, **time_turns({
            "ms": lambda: mapreduce_k.mapreduce_1d_cuda(alg.IDENTITY,
                                                        alg.MAX, big),
            "library_ms": lambda: torch.amax(big)}, reps=20),
        "plain_ms": time_ms(lambda: mapreduce_k.mapreduce_1d_plain(
            alg.IDENTITY, alg.MAX, big), 3),
        "bound_ms": bound_ms(4 * (1 << 24), 1 << 24)[0]}

    check_k7m(res, gen, note)
    check_k6_long(res, gen, note)
    check_k6_xlstm(res, gen, note)
    check_k4(res, gen, note)
    check_gemv_forms(gen, note)
    check_k7s(res, gen, note)
    host_stages(gen)
    host_stages_gemv(gen)
    check_k7_k9(res, gen, note)
    check_k10(res, gen, note)
    for k, r in res.items():
        if "ms" not in r:
            continue                   # K1, K5, K8: the primitives phase
        log(f"[kernels] {k} {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.6f} ms ({r['bound'][1]}); " + json.dumps(
                {x: v for x, v in r.items() if x in (
                    "large", "modes", "dense_mv_ms", "dense_bmm_ms",
                    "shapes", "public_ms", "device_ms", "public_ratio",
                    "library_device_ms", "library_innermost_ms", "rows",
                    "xlstm")}))
    return res


def device_ms(fn, calls: int = 5) -> tuple[float, float]:
    """Device milliseconds and device operations a call of ``fn``
    (torch.profiler: the sum of its kernels' times, and their count), after
    a warm-up call: a kernel's own time where the host's launch takes
    longer than the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(ops) / calls / 1e3, len(ops) / calls


def launch_ms(fn) -> float | None:
    """Device milliseconds of one kernel of ``fn``, a call that launches
    one (torch.profiler over 10 calls: their kernels' mean time, so an
    event the profiler drops at its window's edge does not count; a window
    that kept none is taken again, up to three times, then None)."""
    for _ in range(3):
        ms, ops = device_ms(fn, 10)
        if ops:
            return ms / ops
    return None


def call_device_ms(fn) -> float | None:
    """Device milliseconds a call of ``fn``: its kernels' mean time
    (torch.profiler, 20 calls a window) times the kernels a call launches,
    from the window that saw the most of them (at most three windows, the
    first that saw a whole number a call ends it: the profiler drops events
    at a window's edge).  None if no window saw any."""
    ms, ops = 0.0, 0.0
    for _ in range(3):
        w_ms, w_ops = device_ms(fn, 20)
        if w_ops > ops:
            ms, ops = w_ms, w_ops
        if ops >= 1 and float(ops).is_integer():
            break
    return ms / ops * max(1, round(ops)) if ops else None


def one_launch(k: str, fn):
    """``fn()``'s result, checked to launch kernel ``k`` exactly once."""
    obj, attr = COUNTERS[k]
    before = getattr(obj, attr)
    out = fn()
    launched = getattr(obj, attr) - before
    if launched != 1:
        raise CheckFailed(f"{k}: a call launched {launched} times, not once")
    return out


def check_k2(res, gen, note) -> None:
    """K2: every n is one launch -- one tile up to the single-tile limit,
    the decoupled lookback above it.  int32 ADD and int32 AFFINE with odd
    multipliers (wrapping products: every element reaches every later
    output, so a misordered or dropped tile shows) bit-exact at n = 1, 4,
    the limit and one past, a lookback tile and one past, 3 tiles + 7,
    10^6 + 3 and 2^24, inclusive and exclusive; f32 AFFINE within 1e-5 of
    the output's size and QUATERNION_MUL within 1e-3 (products of up to
    10^6 factors); then the same call 1,000 times on one stream, each
    result compared on the card, so that a ticket not reset or a stale
    flag shows."""
    dev = torch.device("cuda")
    k2 = scan_k.scan_1d_cuda
    lib = _lib.load(scan_k.scan_unit("K2", alg.ADD, [torch.empty(
        0, dtype=torch.int32)]))
    tile, lb = lib.rt_tile(), lib.rt_lookback_tile()
    for n in (1, BATCH, tile, tile + 1, lb, lb + 1, 3 * lb + 7, 10**6 + 3,
              1 << 24):
        x = torch.randint(-100, 100, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        a = odd_ints(gen, n)
        b = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        for inclusive in (True, False):
            err = max(max_err(one_launch("K2", lambda: k2(
                alg.ADD, x, inclusive=inclusive)), scan_k.scan_1d_plain(
                alg.ADD, x, inclusive=inclusive)),
                max_err(one_launch("K2", lambda: k2(
                    alg.AFFINE, (a, b), inclusive=inclusive)),
                    scan_k.scan_1d_plain(alg.AFFINE, (a, b),
                                         inclusive=inclusive)))
            note("K2", err)
            expect(err == 0, f"K2 n={n} inclusive={inclusive}: ADD and "
                             f"AFFINE (odd multipliers) int32 bit-exact, "
                             f"one launch")
    for n in (tile + 1, 3 * lb + 7):
        a = torch.empty(n, device=dev).uniform_(0.9, 1.0, generator=gen)
        b = torch.empty(n, device=dev).uniform_(-1, 1, generator=gen)
        want = scan_k.scan_1d_plain(alg.AFFINE, (a, b))
        err = max_err(k2(alg.AFFINE, (a, b)), want)
        note("K2", err)
        scale = max(float(want[1].abs().max()), 1.0)
        expect(err <= 1e-5 * scale, f"K2 scan AFFINE f32 n={n}: max abs err "
                                    f"{err:.3g} <= 1e-5 x {scale:.3g}")
    for n in (3 * lb + 7, 10**6 + 3):
        q = unit_quaternions(gen, n)
        err = max_err(k2(alg.QUATERNION_MUL, q),
                      scan_k.scan_1d_plain(alg.QUATERNION_MUL, q))
        expect(err <= 1e-3, f"K2 QUATERNION_MUL n={n} (unit quaternions): "
                            f"max abs err {err:.3g} <= 1e-3")
    x = torch.randint(-100, 100, (10**6 + 3,), generator=gen, device=dev,
                      dtype=torch.int32)
    want = [scan_k.scan_1d_plain(alg.ADD, x, inclusive=i)
            for i in (True, False)]
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1000):
        wrong += (k2(alg.ADD, x, inclusive=i % 2 == 0) != want[i % 2]).sum()
    expect(int(wrong) == 0, f"K2 n=10^6+3, 1,000 calls in a row on one "
                            f"stream (inclusive and exclusive in turn): "
                            f"{int(wrong)} wrong elements")
    # torch.profiler may drop an event at its window's edge (4 of 5 kernels
    # seen, once in 16 runs): a window that saw fewer than one a call is
    # taken again, at most three times; more than one always fails.
    for _ in range(3):
        ms, ops = device_ms(lambda: k2(alg.ADD, x))
        if ops >= 1:
            break
    expect(ops == 1, f"K2 n=10^6+3: {ops} device operations a call (one "
                     f"kernel, no memset), {ms * 1e3:.2f} us")
    x = torch.randint(-100, 100, (BATCH,), generator=gen, device=dev,
                      dtype=torch.int32)
    res["K2"].update(time_turns({
        "ms": lambda: k2(alg.ADD, x),
        "library_ms": lambda: torch.cumsum(x, 0, dtype=torch.int32),
        "public_ms": lambda: forge.scan(alg.ADD, x)}))
    res["K2"]["plain_ms"] = time_ms(lambda: scan_k.scan_1d_plain(alg.ADD, x))
    res["K2"]["bound"] = bound_ms(2 * 4 * BATCH, BATCH)
    res["K2"]["shape"] = f"({BATCH},) int32 ADD"
    big = torch.randint(-100, 100, (1 << 24,), generator=gen, device=dev,
                        dtype=torch.int32)
    res["K2"]["large"] = {
        "n": 1 << 24, **time_turns({
            "ms": lambda: k2(alg.ADD, big),
            "library_ms": lambda: torch.cumsum(big, 0, dtype=torch.int32)},
            reps=20),
        "plain_ms": time_ms(lambda: scan_k.scan_1d_plain(alg.ADD, big), 3),
        "bound_ms": bound_ms(2 * 4 * (1 << 24), 1 << 24)[0]}


# K6 at the RG-LRU's shapes (B, T, 2560): the serve phase's prompts of 17,
# 1,024 and 2,100 tokens, and 8 sequences of 2,048.
K6_SHAPES = ((1, 17, 2560), (1, 1024, 2560), (1, 2100, 2560),
             (8, 2048, 2560))


def check_k6(res, gen, note) -> None:
    """K6's channel-tile route, which reassociates as the reference's
    kernel does (runs of a chunk, then the carry).  int32 AFFINE with odd
    multipliers bit-exact against the plain serial walk, and f32 AFFINE
    within 1e-5 x max|h| of a float64 walk (the f32 plain walk's own error
    beside it), at the RG-LRU's shapes; (2, 61, 130) in each direction and
    form, (3, 1, 1), and shapes whose T spans four chunks (256 steps of
    an 8-byte element), forward and reverse.  Every call is one launch of
    the channel-tile route, none of the long-T path."""
    dev = torch.device("cuda")
    k6 = scan_k.scan_channel_cuda
    cases = [(shape, True, False) for shape in K6_SHAPES] + [
        ((2, 61, 130), inc, rev) for inc in (True, False)
        for rev in (False, True)] + [
        ((3, 1, 1), False, True), ((1, 1000, 2560), True, True),
        ((2, 1000, 600), False, False), ((2, 1000, 600), True, True)]
    for (B, T, C), inclusive, reverse in cases:
        kw = dict(inclusive=inclusive, reverse=reverse)
        long_t = k6.long_t_launches
        a = odd_ints(gen, B * T * C).view(B, T, C)
        b = torch.randint(-2**31, 2**31 - 1, (B, T, C), generator=gen,
                          device=dev, dtype=torch.int32)
        err = max_err(one_launch("K6", lambda: k6(alg.AFFINE, (a, b), **kw)),
                      scan_k.scan_channel_plain(alg.AFFINE, (a, b), **kw))
        note("K6", err)
        af = torch.empty(B, T, C, device=dev).uniform_(0.9, 0.999,
                                                       generator=gen)
        bf = torch.empty(B, T, C, device=dev).uniform_(-1, 1, generator=gen)
        got = one_launch("K6", lambda: k6(alg.AFFINE, (af, bf), **kw))
        walk = scan_k.scan_channel_plain(alg.AFFINE, (af.double(),
                                                      bf.double()), **kw)
        plain_err = max_err(scan_k.scan_channel_plain(alg.AFFINE, (af, bf),
                                                      **kw), walk)
        ferr = max_err(got, walk)
        scale = float(walk[1].abs().max())
        expect(err == 0 and ferr <= 1e-5 * scale and
               k6.long_t_launches == long_t,
               f"K6 ({B},{T},{C}) inclusive={inclusive} reverse={reverse}, "
               f"channel-tile route: int32 AFFINE bit-exact; f32 AFFINE max "
               f"abs err {ferr:.3g} <= 1e-5 x max|h| {scale:.3g} of the f64 "
               f"walk (the f32 plain walk's: {plain_err:.3g})")
    res["K6"]["shapes"] = {}
    for B, T, C in K6_SHAPES:
        a = torch.empty(B, T, C, device=dev).uniform_(0.9, 0.999,
                                                      generator=gen)
        b = torch.empty(B, T, C, device=dev).uniform_(-1, 1, generator=gen)
        elems = B * T * C
        row = {"ms": time_ms(lambda: k6(alg.AFFINE, (a, b))),
               "device_ms": device_ms(lambda: k6(alg.AFFINE, (a, b)))[0],
               "bound_ms": bound_ms(4 * 4 * elems, 3 * elems)[0]}
        res["K6"]["shapes"][f"({B}, {T}, {C})"] = row
        if (B, T, C) == (1, 1024, 2560):
            res["K6"].update(
                ms=row["ms"], device_ms=row["device_ms"],
                plain_ms=time_ms(lambda: scan_k.scan_channel_plain(
                    alg.AFFINE, (a, b)), 3),
                library_ms=None,    # no PyTorch call scans AFFINE pairs
                bound=bound_ms(4 * 4 * elems, 3 * elems),
                shape="(1, 1024, 2560) f32 AFFINE")


def onehot_digits(gen, n: int, buckets: int) -> torch.Tensor:
    """The radix pass's (n, buckets) int32 one-hot digit matrix."""
    digit = torch.randint(0, buckets, (n,), generator=gen, device="cuda")
    return (digit[:, None] == torch.arange(buckets, device="cuda")).int()


def check_k6_long(res, gen, note) -> None:
    """K6's long-T path: the radix sort's rank scans, (1, B V, 2^d) int32
    exclusive ADD, bit-exact; AFFINE through it reassociates float combines
    at chunk boundaries, held at 1e-5 of the output's size.  Every shape
    here takes the long-T path by the threshold (B C <= 1024, T >= 128).
    The serial plain walk runs up to T = 65,536; at T = B V the rank scans
    are held against the log-step reference scan and torch.cumsum."""
    k6l = scan_k.scan_channel_cuda
    for (B, T, C), inclusive, reverse in (
            ((1, 65536, 256), False, False), ((1, 5000, 4), False, False),
            ((2, 3001, 7), True, True), ((3, 300, 5), False, True)):
        expect(scan_k.uses_long_t(B, T, C),
               f"({B},{T},{C}) takes the long-T path by the threshold")
        x = torch.randint(0, 3, (B, T, C), generator=gen, device="cuda",
                          dtype=torch.int32)
        got = k6l(alg.ADD, x, inclusive=inclusive, reverse=reverse)
        want = scan_k.scan_channel_plain(alg.ADD, x, inclusive=inclusive,
                                         reverse=reverse)
        err = max_err(got, want)
        note("K6-long", err)
        expect(err == 0, f"K6-long ADD int32 ({B},{T},{C}) inclusive="
                         f"{inclusive} reverse={reverse}: bit-exact")
    a = torch.empty(2, 3000, 130, device="cuda").uniform_(0.9, 0.999,
                                                           generator=gen)
    b = torch.empty(2, 3000, 130, device="cuda").uniform_(-1, 1,
                                                           generator=gen)
    expect(scan_k.uses_long_t(2, 3000, 130),
           "(2,3000,130) takes the long-T path by the threshold")
    got = k6l(alg.AFFINE, (a, b))
    want = scan_k.scan_channel_plain(alg.AFFINE, (a, b))
    err = max_err(got, want)
    scale = float(want[1].abs().max())
    expect(err <= 1e-5 * scale, f"K6-long AFFINE f32 (2,3000,130): "
                                f"max abs err {err:.3g} <= 1e-5 x {scale:.3g}")
    # The segment-id pass: 4 buckets (B = 4 rows) over all B V elements.
    oh = onehot_digits(gen, N_SORT, 4)[None]
    expect(scan_k.uses_long_t(1, N_SORT, 4),
           f"(1, {N_SORT}, 4) takes the long-T path by the threshold")
    got = k6l(alg.ADD, oh, inclusive=False)
    err = max(max_err(got, ref.ref_scan(alg.ADD, oh, axis=1,
                                        inclusive=False)),
              max_err(got, torch.cumsum(oh, dim=1, dtype=torch.int32) - oh))
    note("K6-long", err)
    expect(err == 0, f"K6-long rank scan (1,{N_SORT},4) int32 exclusive: "
                     f"bit-exact against the reference scan and torch.cumsum")
    oh = onehot_digits(gen, N_SORT, 256)[None]
    expect(scan_k.uses_long_t(1, N_SORT, 256),
           f"(1, {N_SORT}, 256) takes the long-T path by the threshold")
    got = k6l(alg.ADD, oh, inclusive=False)
    err = max(max_err(got, ref.ref_scan(alg.ADD, oh, axis=1,
                                        inclusive=False)),
              max_err(got, torch.cumsum(oh, dim=1, dtype=torch.int32) - oh))
    note("K6-long", err)
    expect(err == 0, f"K6-long rank scan (1,{N_SORT},256) int32 exclusive: "
                     f"bit-exact against the reference scan and torch.cumsum")
    del got
    plain_in = oh[:, :65536].contiguous()
    res["K6-long"].update(
        ms=time_ms(lambda: k6l(alg.ADD, oh, inclusive=False), 10),
        plain_ms=time_ms(lambda: scan_k.scan_channel_plain(
            alg.ADD, plain_in, inclusive=False), 1),
        library_ms=time_ms(lambda: torch.cumsum(oh, dim=1,
                                                dtype=torch.int32), 10),
        bound=bound_ms(2 * 4 * N_SORT * 256, N_SORT * 256),
        shape=f"(1, {N_SORT}, 256) int32 ADD exclusive (plain at T = 65536)")
    # torch.cumsum along dim 1 of (1, T, 256) walks each of the 256 columns
    # in one thread; the same scan over the innermost axis of the
    # transposed tensor (its copy not timed) is the library's fast layout.
    ohT = oh.transpose(1, 2).contiguous()
    ms, kernels = device_ms(lambda: torch.cumsum(oh, dim=1,
                                                 dtype=torch.int32), 2)
    res["K6-long"].update(
        library_device_ms=ms / kernels if kernels else None,   # one a call
        library_innermost_ms=time_ms(lambda: torch.cumsum(
            ohT, dim=2, dtype=torch.int32), 10))
    del ohT


# xlstm-1.3b's K6 calls at a 2,100-token prompt (padded to 33 chunks of 64):
# the mLSTM's chunk states over H dh^2 = 4 x 1024^2 channels (C) and H dh =
# 4096 (n), on the channel-tile route; its stabilizer over (1, 2112, 4), 12
# neutral pad steps last, on the long-T path; and at 1,024 tokens.
XLSTM_STATES = ((1, 33, 4 * 1024 * 1024), (1, 33, 4096))
XLSTM_STABILIZER = (((1, 2112, 4), 12), ((1, 1024, 4), 0))


def stabilizer_gates(gen, B, T, H, pad=0):
    """The stabilizer's inputs as the mLSTM makes them: log forget gates
    log sigmoid(N(3, 1)) (open forget gates, bias 3), log input gates N(0,
    2), the last ``pad`` steps neutral (lf = 0, li = -1e30)."""
    lf = F.logsigmoid(torch.randn(B, T, H, generator=gen, device="cuda") + 3)
    li = 2 * torch.randn(B, T, H, generator=gen, device="cuda")
    if pad:
        lf[:, T - pad:] = 0.0
        li[:, T - pad:] = -1e30
    return lf, li


def check_k6_xlstm(res, gen, note) -> None:
    """K6 at xlstm-1.3b's shapes.  The chunk states, f32 AFFINE over 4.2 M
    channels (channel-tile route, one launch) as linear_recurrence calls it
    without h0: the B leaf alone written, the A leaf's output null.  B
    within 1e-5 x max|h| of a float64 walk as check_k6 holds the RG-LRU's;
    device ms by torch.profiler beside the bound (a, b read, h written
    once).  The
    stabilizer, MAXPLUS_AFFINE f32 over (1, 2112, 4) (a 2,100-token prompt
    with 12 neutral pad steps) and (1, 1024, 4), on the long-T path: its A
    leaf is a sum of the log forget gates, reassociated at chunk edges, and
    its B leaf a max of such sums, exact given them; both leaves within
    1e-5 x the larger of max|A| and max|B| of a float64 walk."""
    dev = torch.device("cuda")
    k6 = scan_k.scan_channel_cuda
    xl = res["K6"]["xlstm"] = {}
    for B, T, C in XLSTM_STATES:
        expect(not scan_k.uses_long_t(B, T, C),
               f"({B},{T},{C}) takes the channel-tile route by the threshold")
        a = torch.empty(B, T, C, device=dev).uniform_(0.01, 1.0,
                                                      generator=gen)
        b = torch.randn(B, T, C, generator=gen, device=dev)
        h_only = (False, True)
        got = one_launch("K6", lambda: k6(alg.AFFINE, (a, b), keep=h_only))
        walk = scan_k.scan_channel_plain(alg.AFFINE, (a.double(),
                                                      b.double()))[1]
        plain = scan_k.scan_channel_plain(alg.AFFINE, (a, b), keep=h_only)[1]
        err, plain_err = max_err(got[1], walk), max_err(plain, walk)
        scale = float(walk.abs().max())
        dropped = got[0] is None
        del got, walk, plain
        note("K6", err)
        expect(dropped and err <= 1e-5 * scale,
               f"K6 ({B},{T},{C}) f32 AFFINE, the mLSTM's chunk states, A "
               f"leaf not written: max abs err {err:.3g} <= 1e-5 x max|h| "
               f"{scale:.3g} of the f64 walk (the f32 plain walk's: "
               f"{plain_err:.3g})")
        elems = B * T * C
        xl[f"({B}, {T}, {C})"] = {
            "ms": time_ms(lambda: k6(alg.AFFINE, (a, b), keep=h_only), 10),
            "device_ms": device_ms(
                lambda: k6(alg.AFFINE, (a, b), keep=h_only))[0],
            # Both leaves written, as before linear_recurrence dropped A:
            # the same call's comparison (bound 4 arrays).
            "both_leaves_device_ms": device_ms(
                lambda: k6(alg.AFFINE, (a, b)))[0],
            "both_leaves_bound_ms": bound_ms(4 * 4 * elems, 3 * elems)[0],
            "plain_ms": time_ms(lambda: scan_k.scan_channel_plain(
                alg.AFFINE, (a, b), keep=h_only), 3),
            "bound_ms": bound_ms(3 * 4 * elems, 2 * elems)[0],
            "max_abs_err": err, "tolerance": 1e-5 * scale}
        del a, b
    xl = res["K6-long"]["xlstm"] = {}
    for (B, T, H), pad in XLSTM_STABILIZER:
        expect(scan_k.uses_long_t(B, T, H),
               f"({B},{T},{H}) takes the long-T path by the threshold")
        lf, li = stabilizer_gates(gen, B, T, H, pad)
        op = alg.MAXPLUS_AFFINE
        long_t = k6.long_t_launches
        got = k6(op, (lf, li))
        walk = scan_k.scan_channel_plain(op, (lf.double(), li.double()))
        plain = scan_k.scan_channel_plain(op, (lf, li))
        errs = [max_err(g, w) for g, w in zip(got, walk)]
        plain_err = max_err(plain, walk)
        scale = max(float(w.abs().max()) for w in walk)
        note("K6-long", max(errs))
        expect(k6.long_t_launches == long_t + 1 and
               max(errs) <= 1e-5 * scale,
               f"K6-long ({B},{T},{H}) f32 MAXPLUS_AFFINE, the mLSTM's "
               f"stabilizer, one long-T launch: max abs err A {errs[0]:.3g}, "
               f"B {errs[1]:.3g} <= 1e-5 x {scale:.3g} of the f64 walk (the "
               f"f32 plain walk's: {plain_err:.3g})")
        elems = B * T * H
        xl[f"({B}, {T}, {H})"] = {
            "ms": time_ms(lambda: k6(op, (lf, li))),
            "device_ms": call_device_ms(lambda: k6(op, (lf, li))),
            "plain_ms": time_ms(lambda: scan_k.scan_channel_plain(
                op, (lf, li)), 3),
            "bound_ms": bound_ms(4 * 4 * elems, 3 * elems)[0],
            "max_abs_err": max(errs), "tolerance": 1e-5 * scale}


def check_k4(res, gen, note) -> None:
    """K4: integer ops bit-exact against the plain fold; f32 ADD GEMV held
    at 1e-5 of sum_i |x_i A_ij| (another summation order)."""
    for n, p in ((1000, 37), (5, 3), (70000, 4), (3, 5000)):
        A = torch.randint(-9, 10, (n, p), generator=gen, device="cuda",
                          dtype=torch.int32)
        xv = torch.randint(-9, 10, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
        xz = torch.randint(-9, 10, (p,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for op in (alg.ADD, alg.MAX, alg.MIN, alg.MUL):
            for k, fn, plain, x in (
                    ("K4-matvec", matvec_k.matvec_cuda, matvec_k.matvec_plain,
                     xv),
                    ("K4-vecmat", matvec_k.vecmat_cuda, matvec_k.vecmat_plain,
                     xz)):
                err = max_err(fn(alg.TIMES, op, A, x),
                              plain(alg.TIMES, op, A, x))
                note(k, err)
                expect(err == 0, f"{k} times/{op.name} int32 ({n},{p}): "
                                 f"bit-exact")
    # The segment-id pass's histogram: 4 buckets over all B V elements.
    oh = onehot_digits(gen, N_SORT, 4)
    for k, fn, plain in (
            ("K4-matvec", matvec_k.matvec_cuda, matvec_k.matvec_plain),
            ("K4-vecmat", matvec_k.vecmat_cuda, matvec_k.vecmat_plain)):
        err = max_err(fn(alg.IDENTITY, alg.ADD, oh, None),
                      plain(alg.IDENTITY, alg.ADD, oh, None))
        note(k, err)
        expect(err == 0, f"{k} identity/add int32 ({N_SORT},4): bit-exact")
    oh = onehot_digits(gen, N_SORT, 256)
    for k, fn, plain, lib in (
            ("K4-matvec", matvec_k.matvec_cuda, matvec_k.matvec_plain,
             lambda: oh.sum(0, dtype=torch.int32)),
            ("K4-vecmat", matvec_k.vecmat_cuda, matvec_k.vecmat_plain,
             lambda: oh.sum(1, dtype=torch.int32))):
        got = fn(alg.IDENTITY, alg.ADD, oh, None)
        err = max(max_err(got, plain(alg.IDENTITY, alg.ADD, oh, None)),
                  max_err(got, lib()))
        note(k, err)
        expect(err == 0, f"{k} identity/add int32 ({N_SORT},256): bit-exact "
                         f"against the plain fold and the library sum")
        if k == "K4-matvec":
            res[k].update(
                ms=time_ms(lambda: fn(alg.IDENTITY, alg.ADD, oh, None), 20),
                plain_ms=time_ms(lambda: plain(alg.IDENTITY, alg.ADD, oh,
                                               None), 3),
                library_ms=time_ms(lib, 20),
                bound=bound_ms(4 * N_SORT * 256 + 4 * 256, N_SORT * 256),
                shape=f"({N_SORT}, 256) int32 ADD of A (the digit histogram)")
    A = torch.randn(8192, 8192, generator=gen, device="cuda")
    x = torch.randn(8192, generator=gen, device="cuda")
    for k, fn, plain, lib, scale in (
            ("K4-matvec", matvec_k.matvec_cuda, matvec_k.matvec_plain,
             lambda: torch.mv(A.t(), x), (x.abs()[:, None] * A.abs()).sum(0)),
            ("K4-vecmat", matvec_k.vecmat_cuda, matvec_k.vecmat_plain,
             lambda: torch.mv(A, x), (A.abs() * x.abs()[None]).sum(1))):
        got = fn(alg.TIMES, alg.ADD, A, x)
        errs = (got.double() - plain(alg.TIMES, alg.ADD, A, x).double()).abs()
        err = float(errs.max())
        note(k, err)
        expect(bool((errs <= 1e-5 * scale).all()),
               f"{k} f32 GEMV (8192, 8192): max abs err {err:.3g}, within "
               f"1e-5 x sum|x||A| of every output")
        timing = dict(
            ms=time_ms(lambda: fn(alg.TIMES, alg.ADD, A, x), 20),
            plain_ms=time_ms(lambda: plain(alg.TIMES, alg.ADD, A, x), 3),
            library_ms=time_ms(lib, 20))
        bound = bound_ms(4 * 8192 * 8192 + 8 * 8192, 2 * 8192 * 8192)
        if k == "K4-vecmat":           # its row's shape: vecmat is off the path
            res[k].update(timing, bound=bound,
                          shape="(8192, 8192) f32 times/ADD")
        else:
            res[k]["large"] = dict(timing, bound_ms=bound[0],
                                   shape="(8192, 8192) f32 times/ADD")


def gemv_form(fn):
    """``fn()``'s output and the GEMV kind and load width its one launch
    took (matvec_k.form_launches)."""
    before = dict(matvec_k.form_launches)
    out = fn()
    forms = [k for k, v in matvec_k.form_launches.items()
             if v != before.get(k, 0)]
    if len(forms) != 1 or matvec_k.form_launches[forms[0]] != \
            before.get(forms[0], 0) + 1:
        raise CheckFailed(f"one GEMV launch expected, got {forms}")
    return out, forms[0]


def expected_form(form: str, A: torch.Tensor) -> str:
    """The kind and load width the host must choose: 16-byte loads of
    4-byte leaves of a 16-byte aligned A (with p % 4 == 0, except for the
    flat-stream kinds), else one element a load."""
    p = A.shape[-1]
    kind = {"packed": "packed", "matvec": "columns"}.get(
        form, "tall" if p <= matvec_k.PACKED_MAX_COLS else "rows")
    wide = A.element_size() == 4 and A.data_ptr() % 16 == 0 and (
        p % 4 == 0 or kind in ("packed", "tall"))
    return f"{kind}/{4 if wide else 1}"


def check_gemv_forms(gen, note) -> None:
    """Every GEMV form against its plain version, with the form each call
    took checked against the host's rule: the short matvec (a few rows,
    each thread walks all of them), the chunked matvec and vecmat (the
    last block folds the partials), one warp to a whole block a row, the
    tall-narrow vecmat and K5's flat stream, each with 16-byte and with
    one-element loads (p % 4 != 0, and A 4-byte but not 16-byte aligned: a
    view one element into its buffer), at edges (1, p), (n, 1), (3, 5000),
    (5000, 3).  int32 TIMES over ADD / MAX / MIN bit-exact; the AFFINE fold
    of (x, a) pairs, an operator that does not commute, in order on each
    form, flat and batched: over int32 bit-exact, where odd multipliers and
    wrapping products keep every row's (column's) term in every output, so
    a chunk or row group folded out of order or left out changes it; and
    over f32 within 1e-4, the multipliers near 1; f64 ADD over TIMES within
    1e-12 of sum |x| |a| per output."""
    shapes = ((3, 5000), (5000, 3), (1, 4096), (1, 37), (4096, 1), (1, 1),
              (10, 100000), (100000, 10), (1000, 37), (2049, 64), (2048, 65),
              (600, 1), (10000, 1000), (1000, 10000))
    forms_seen = collections.Counter()

    def run(k, form, fn, plain, A, x, op, what):
        got, took = gemv_form(lambda: fn(alg.TIMES, op, A, x))
        want = expected_form(form, A)
        err = max_err(got, plain(alg.TIMES, op, A, x))
        note(k, err)
        forms_seen[took] += 1
        expect(err == 0 and took == want,
               f"{k} times/{op.name} int32 {what}: {took} (want {want}), "
               f"bit-exact")

    for n, p in shapes:
        buf = torch.randint(-9, 10, (n * p + 4,), generator=gen, device="cuda",
                            dtype=torch.int32)
        xv = torch.randint(-9, 10, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
        xz = torch.randint(-9, 10, (p,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for tag, A in (("aligned", buf[:n * p].view(n, p)),
                       ("at +4 bytes", buf[1:1 + n * p].view(n, p))):
            ops = (alg.ADD, alg.MAX, alg.MIN) if tag == "aligned" else \
                (alg.ADD,)
            for op in ops:
                what = f"({n}, {p}) {tag}"
                run("K4-matvec", "matvec", matvec_k.matvec_cuda,
                    matvec_k.matvec_plain, A, xv, op, what)
                run("K4-vecmat", "vecmat", matvec_k.vecmat_cuda,
                    matvec_k.vecmat_plain, A, xz, op, what)
                if p <= matvec_k.PACKED_MAX_COLS:
                    run("K5", "packed", matvec_k.matvec_packed_cuda,
                        matvec_k.matvec_packed_plain, A, xv, op, what)
        odd = odd_ints(gen, n * p + 4)
        for tag, A in (("aligned", odd[:n * p].view(n, p)),
                       ("at +4 bytes", odd[1:1 + n * p].view(n, p))):
            affine_int32(gen, note, forms_seen, A, f"({n}, {p}) {tag}")
        # matvec's multiplier is x, vecmat's is a: each near 1, so early
        # terms keep their weight in the f32 sum.
        Af = torch.empty(n, p, device="cuda").uniform_(0.9, 1.1, generator=gen)
        for k, form, fn, plain, m, A in (
                ("K4-matvec", "matvec", matvec_k.matvec_cuda,
                 matvec_k.matvec_plain, n, Af - 1.0),
                ("K4-vecmat", "vecmat", matvec_k.vecmat_cuda,
                 matvec_k.vecmat_plain, p, Af)):
            xf = torch.empty(m, device="cuda").uniform_(
                *((0.9, 1.1) if form == "matvec" else (-0.1, 0.1)),
                generator=gen)
            got, took = gemv_form(lambda: fn(PAIR, alg.AFFINE, A, xf))
            want = plain(PAIR, alg.AFFINE, A, xf)
            err = rel_err(got, want, 1 + want[1].abs().double())
            note(k, err)
            forms_seen[took] += 1
            expect(err <= 1e-4, f"{k} AFFINE fold of (x, a) pairs ({n}, {p}) "
                                f"on {took}, in order: err {err:.3g} <= 1e-4")
        if n * p <= 10**6:
            Ad = torch.randn(n, p, generator=gen, device="cuda",
                             dtype=torch.float64)
            for k, form, fn, plain, m, mv in (
                    ("K4-matvec", "matvec", matvec_k.matvec_cuda,
                     matvec_k.matvec_plain, n, True),
                    ("K4-vecmat", "vecmat", matvec_k.vecmat_cuda,
                     matvec_k.vecmat_plain, p, False)):
                xd = torch.randn(m, generator=gen, device="cuda",
                                 dtype=torch.float64)
                got, took = gemv_form(lambda: fn(alg.TIMES, alg.ADD, Ad, xd))
                err = rel_err(got, plain(alg.TIMES, alg.ADD, Ad, xd),
                              gemv_scale(Ad, xd, mv) + 1e-300)
                note(k, err)
                forms_seen[took] += 1
                expect(err <= 1e-12 and took == expected_form(form, Ad),
                       f"{k} ADD over TIMES f64 ({n}, {p}) on {took}: err "
                       f"{err:.3g} <= 1e-12 of sum|x||a| per output")
    for shape in ((2, 10000, 64), (2, 64, 50000), (3, 5000, 10)):
        odd = odd_ints(gen, math.prod(shape))
        affine_int32(gen, note, forms_seen, odd.view(shape),
                     f"{shape} batched")
    kinds = {f"{k}/{w}" for k in ("columns", "rows", "packed", "tall")
             for w in (1, 4)}
    expect(kinds <= set(forms_seen), f"every GEMV kind ran with both load "
                                     f"widths: {dict(forms_seen)}")


def odd_ints(gen, count: int) -> torch.Tensor:
    """``count`` odd int32 values over the whole range, on the card: units
    modulo 2^32, so no product of them wraps to 0."""
    return torch.randint(0, 2**31 - 1, (count,), generator=gen,
                         device="cuda", dtype=torch.int32) | 1


def affine_int32(gen, note, forms_seen, A, what) -> None:
    """The matvec and the vecmat of int32 AFFINE (x, a) pairs over ``A``
    ((n, p), or (B, n, p) for K7) and odd vectors, bit-exact against the
    plain version, on the form the host's rule picks."""
    batched = A.ndim == 3
    for k, form, fn, plain, m in (
            ("K7-matvec" if batched else "K4-matvec", "matvec",
             batched_k.batched_matvec_cuda if batched else
             matvec_k.matvec_cuda, batched_k.batched_matvec_plain if batched
             else matvec_k.matvec_plain, A.shape[-2]),
            ("K7-vecmat" if batched else "K4-vecmat", "vecmat",
             batched_k.batched_vecmat_cuda if batched else
             matvec_k.vecmat_cuda, batched_k.batched_vecmat_plain if batched
             else matvec_k.vecmat_plain, A.shape[-1])):
        xo = odd_ints(gen, A.shape[0] * m if batched else m).view(
            *A.shape[:-2], m)
        got, took = gemv_form(lambda: fn(PAIR, alg.AFFINE, A, xo))
        err = max_err(got, plain(PAIR, alg.AFFINE, A, xo))
        note(k, err)
        forms_seen[took] += 1
        want = expected_form(form, A)
        expect(err == 0 and took == want,
               f"{k} AFFINE fold of int32 (x, a) pairs {what} on {took} "
               f"(want {want}), in order: bit-exact")


def check_k7s(res, gen, note) -> None:
    """K7s: integer ADD bit-exact; the nucleus scan of probability rows
    (prefixes below 1) held at 1e-6 at (4, 64) and 1e-5 at 65,536 terms;
    AFFINE within 1e-6 of the output's size on both sides of the tile
    (2,048 4-byte elements, 2,048 8-byte pairs), where the single-tile form
    gives way to the three-phase one; the counter says which ran."""
    k7s = batched_k.batched_scan_cuda
    tile = _lib.load(scan_k.scan_unit("K7s", alg.ADD, [torch.empty(
        0, dtype=torch.int32)])).rt_tile()

    def k7s_form(fn, n):
        single = k7s.single_tile_launches
        out = fn()
        form = "single-tile" if k7s.single_tile_launches > single else \
            "three-phase"
        expect(form == ("single-tile" if n <= tile else "three-phase"),
               f"K7s n={n} takes the {form} form (tile {tile})")
        return out

    for B, n in ((4, 64), (4, 40), (3, 2049), (2, 2048), (1, 1), (64, 65536)):
        x = torch.randint(-100, 100, (B, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        for inclusive in (True, False):
            err = max_err(k7s_form(lambda: k7s(alg.ADD, x,
                                               inclusive=inclusive), n),
                          batched_k.batched_scan_plain(alg.ADD, x,
                                                       inclusive=inclusive))
            note("K7s", err)
            expect(err == 0, f"K7s ADD int32 ({B},{n}) inclusive="
                             f"{inclusive}: bit-exact")
    for B, n in ((4, 64), (3, tile), (3, tile + 1)):
        a = torch.empty(B, n, device="cuda").uniform_(0.9, 1.0, generator=gen)
        b = torch.empty(B, n, device="cuda").uniform_(-1, 1, generator=gen)
        got = k7s_form(lambda: k7s(alg.AFFINE, (a, b)), n)
        want = batched_k.batched_scan_plain(alg.AFFINE, (a, b))
        err = max_err(got, want)
        note("K7s", err)
        scale = max(float(want[1].abs().max()), 1.0)
        expect(err <= 1e-6 * scale, f"K7s AFFINE f32 ({B},{n}): max abs err "
                                    f"{err:.3g} <= 1e-6 x {scale:.3g}")
    probs = {}
    for (B, n), tol in (((BATCH, 64), 1e-6), ((64, 65536), 1e-5)):
        p = torch.softmax(torch.randn(B, n, generator=gen, device="cuda"), 1)
        probs[n] = p
        got = batched_k.batched_scan_cuda(alg.ADD, p, inclusive=False)
        err = max_err(got, batched_k.batched_scan_plain(alg.ADD, p,
                                                        inclusive=False))
        note("K7s", err)
        expect(err <= tol, f"K7s ADD f32 probabilities ({B},{n}) exclusive: "
                           f"max abs err {err:.3g} <= {tol}")
    p = probs[64]
    B, n = p.shape
    res["K7s"].update(time_turns({
        "ms": lambda: batched_k.batched_scan_cuda(alg.ADD, p,
                                                  inclusive=False),
        "library_ms": lambda: torch.cumsum(p, dim=1),
        "public_ms": lambda: forge.scan(alg.ADD, p, inclusive=False,
                                        layout=Batched())}),
        plain_ms=time_ms(lambda: batched_k.batched_scan_plain(
            alg.ADD, p, inclusive=False), 3),
        bound=bound_ms(2 * 4 * B * n, B * n),
        shape=f"({B}, {n}) f32 ADD exclusive")
    p = probs[65536]
    B, n = p.shape
    res["K7s"]["large"] = dict(
        time_turns({
            "ms": lambda: batched_k.batched_scan_cuda(alg.ADD, p,
                                                      inclusive=False),
            "library_ms": lambda: torch.cumsum(p, dim=1)}, reps=20),
        plain_ms=time_ms(lambda: batched_k.batched_scan_plain(
            alg.ADD, p, inclusive=False), 3),
        shape=f"({B}, {n}) f32 ADD exclusive",
        bound_ms=bound_ms(2 * 4 * B * n, B * n)[0])


def host_us(fn, reps: int = 10**4) -> float:
    """Mean host microseconds of ``fn`` over ``reps`` calls
    (time.perf_counter_ns), after 100 warm-up calls."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def host_stages(gen) -> dict:
    """Host microseconds of each stage of one K3 call at (4,) int32 MAX and
    one K7s call at (4, 64) f32 ADD exclusive: [before, after], where
    "before" re-times the calls the wrappers made at that stage before the
    launch plan and the small forms (a pytree walk, the equality-keyed unit
    lookup, a ctypes call for the grid or tile, three allocations, two
    ctypes pointer arrays, current_stream(dev), memset and launch through
    the array entry, unflatten) and "after" the wrapper's calls now.  Then
    the whole wrapper, the public call and the library call, as they are
    now."""
    dev = torch.device("cuda")
    pt = torch.utils._pytree

    def old_arrays(*lists):           # the earlier leaf_ptrs, per list
        return [(ctypes.c_void_p * 5)(*[t.data_ptr() for t in ts],
                                      *([None] * (5 - len(ts))))
                for ts in lists]

    x = (torch.rand(BATCH, generator=gen, device=dev) > 0.5).int()
    f, op, what = alg.IDENTITY, alg.MAX, "mapreduce@flat (cuda)"
    plan = _lib.plan("mapreduce", what, op, x, f)
    lib = plan.load()
    out = x.new_empty(())
    partials, ticket = _lib.scratch(1, 1, x), x.new_empty(1)
    arrays = old_arrays([x], [out])
    st = _lib.stream_ptr(x)
    k3 = {
        "walk": [host_us(lambda: pt.tree_leaves(x)),
                 host_us(lambda: isinstance(x, torch.Tensor))],
        "unit lookup / plan": [
            host_us(lambda: _lib.map_unit("mapreduce", what, f, op, x)),
            host_us(lambda: _lib.plan("mapreduce", what, op, x, f))],
        "grid ctypes call / plan.limit": [
            host_us(lambda: lib.rt_mapreduce_flat_grid(BATCH)),
            host_us(lambda: BATCH <= plan.limit)],
        "allocations": [
            host_us(lambda: (_lib.scratch(1, 1, x), torch.empty(
                1, dtype=torch.int32, device=dev), torch.empty(
                (), dtype=torch.int32, device=dev))),
            host_us(lambda: x.new_empty((), dtype=torch.int32))],
        "pointers": [host_us(lambda: old_arrays([x], [out])),
                     host_us(lambda: (_lib.ptrs([x]), _lib.ptrs([out])))],
        "stream": [host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
                   host_us(lambda: _lib.stream_ptr(x))],
        "C call": [host_us(lambda: lib.rt_mapreduce_flat(
            arrays[0], BATCH, partials.data_ptr(), ticket.data_ptr(),
            arrays[1], st)), host_us(lambda: lib.rt_mapreduce_small(
                x.data_ptr(), out.data_ptr(), BATCH, st))],
        "unflatten": [host_us(lambda: pt.tree_unflatten([out],
                                                        plan.out_spec)),
                      host_us(lambda: plan.outputs([out]))],
        "wrapper": host_us(lambda: mapreduce_k.mapreduce_1d_cuda(f, op, x)),
        "public": host_us(lambda: forge.mapreduce(f, op, x)),
        "amax": host_us(lambda: torch.amax(x)),
    }

    p = torch.softmax(torch.randn(BATCH, 64, generator=gen, device=dev), 1)
    swhat = "scan@batched (cuda)"
    splan = _lib.plan("scan", swhat, alg.ADD, p)
    slib = splan.load()
    pout = torch.empty_like(p)
    sarrays = old_arrays([p], [pout])
    k7s = {
        "walk": [host_us(lambda: pt.tree_flatten(p)),
                 host_us(lambda: isinstance(p, torch.Tensor))],
        "unit lookup / plan": [
            host_us(lambda: scan_k.scan_unit(swhat, alg.ADD, [p])),
            host_us(lambda: _lib.plan("scan", swhat, alg.ADD, p))],
        "tile ctypes call / plan.limit": [
            host_us(lambda: slib.rt_tile()),
            host_us(lambda: 64 <= splan.limit)],
        "allocations": [host_us(lambda: [torch.empty_like(p)])] * 2,
        "pointers": [host_us(lambda: old_arrays([p], [pout])),
                     host_us(lambda: (_lib.ptrs([p]), _lib.ptrs([pout])))],
        "stream": [host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
                   host_us(lambda: _lib.stream_ptr(p))],
        "C call": [host_us(lambda: slib.rt_scan_rows(
            sarrays[0], sarrays[1], BATCH, 64, 0, None, st)),
            host_us(lambda: slib.rt_scan_tile(
                p.data_ptr(), pout.data_ptr(), BATCH, 64, 0, st))],
        "unflatten": [host_us(lambda: pt.tree_unflatten(
            [pout], pt.tree_flatten(p)[1])),
            host_us(lambda: splan.outputs([pout]))],
        "wrapper": host_us(lambda: batched_k.batched_scan_cuda(
            alg.ADD, p, inclusive=False)),
        "public": host_us(lambda: forge.scan(alg.ADD, p, inclusive=False,
                                             layout=Batched())),
        "cumsum": host_us(lambda: torch.cumsum(p, dim=1)),
    }
    # The raw stream is the current one, on the default stream and inside
    # a stream scope.
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        on_side = _lib.stream_ptr(x) == side.cuda_stream
    expect(on_side and _lib.stream_ptr(x) ==
           torch.cuda.current_stream().cuda_stream,
           "the wrappers' stream is torch's current stream, also in a "
           "torch.cuda.stream scope")
    stages = {"K3 (4,) int32 MAX": k3, "K7s (4, 64) f32 ADD exclusive": k7s}
    log("[host] us per call, stage: [earlier form, now]; " +
        json.dumps(stages))
    return stages


def host_stages_gemv(gen) -> dict:
    """Host microseconds of each stage of a K4 matvec call at (1000, 10000)
    (chunked: seven chunks of rows) and a K5 call at (10^6, 10), f32 ADD
    over TIMES, as kernels/matvec.py's launch makes them: resolve (the
    resolved call's lookup and the checks of x and the operands), the one
    allocation, the stream, the workspace, the C call (the launch), the
    count; then the wrapper, the public call and torch.mv.  300 calls a
    stage, so the launch queue never fills and the device's time stays out
    of the host's."""
    stages = {}
    for label, (n, p), form, wrap in (
            ("K4 matvec (1000, 10000) f32", (1000, 10000), matvec_k.MATVEC,
             matvec_k.matvec_cuda),
            ("K5 (10^6, 10) f32", (10**6, 10), matvec_k.PACKED,
             matvec_k.matvec_packed_cuda)):
        A = torch.empty(n, p, device="cuda").uniform_(-1, 1, generator=gen)
        x = torch.empty(n, device="cuda").uniform_(-1, 1, generator=gen)
        f, op = alg.TIMES, alg.ADD
        wrap(f, op, A, x)
        call = matvec_k.resolve(form, label, f, op, A, x)
        lib, st = call.plan.lib, _lib.stream_ptr(A)
        out = torch.empty_like(call.template)
        w = _lib.workspace(A, st, call.grid_x, call.partial_bytes)
        cp, pp = w.counters.data_ptr(), w.partials.data_ptr()
        reps = 300
        stages[label] = {
            "geometry": list(call.geo),
            "resolve": host_us(lambda: matvec_k.resolve(form, label, f, op,
                                                        A, x), reps),
            "allocation": host_us(lambda: torch.empty_like(call.template),
                                  reps),
            "stream": host_us(lambda: _lib.stream_ptr(A), reps),
            "workspace": host_us(lambda: _lib.workspace(
                A, st, call.grid_x, call.partial_bytes), reps),
            "C call": host_us(lambda: lib.rt_gemv(
                x.data_ptr(), A.data_ptr(), out.data_ptr(), call.geo_ptr, cp,
                pp, st), reps),
            "count": host_us(lambda: matvec_k.form_launches.get(call.name, 0),
                             reps),
            "wrapper": host_us(lambda: wrap(f, op, A, x), reps),
            "public": host_us(lambda: forge.matvec(f, op, A, x), reps),
            "torch.mv": host_us(lambda: torch.mv(A.t(), x), reps),
        }
        del A
    log("[host] GEMV us per call, stage: " + json.dumps(stages))
    return stages


# ---------------------------------------------------------------------------
# The matvec family: K7's batched GEMVs and K9's quantized GEMVs
# ---------------------------------------------------------------------------

# Operations per matrix element, for the bound: the product and the sum;
# for a code also its conversion and its scale (int8), or the fp8 field
# decode (shifts, masks, the exponent's bits, three products, the sign).
QUANT_OPS = {"int8": 4, "fp8_e4m3": 12, "fp8_e5m2": 12}


def gemv_scale(A, x, matvec: bool) -> torch.Tensor:
    """sum |x| |a| per output of a (batched) matvec or vecmat: the size of
    an ADD over TIMES result, in float64."""
    if matvec:
        return (x.abs()[..., :, None] * A.abs()).sum(-2).double()
    return (A.abs() * x.abs()[..., None, :]).sum(-1).double()


def quant_bytes(n: int, p: int, B: int = 1) -> int:
    """Codes, scales and both vectors read once, the output written once."""
    nb = -(-n // QUANT_BLOCK)
    return B * (n * p + 4 * nb * p + 4 * n + 4 * p)


def check_gemv(k, note, got, want, scale, what, exact=False) -> None:
    """Bit-exact, or within 1e-5 of sum |x| |a| (plus 1 for the shear's
    constant leaves) per output."""
    err = max_err(got, want)
    note(k, err)
    if exact:
        expect(err == 0, f"{k} {what}: bit-exact")
    else:
        rel = rel_err(got, want, scale + 1)
        expect(rel <= 1e-5, f"{k} {what}: max abs err {err:.3g}, "
                            f"{rel:.3g} <= 1e-5 of sum|x||a| per output")


def expected_qform(form: str, q) -> str:
    """The kind and load width the host must choose for a quantized
    operand: COLUMNS for a matvec, STRIPS for a vecmat; 16 codes a load
    where codes and scales are 16-byte aligned and p % 16 == 0, 4 where the
    codes are 4-byte and the scales 16-byte aligned and p % 4 == 0, else
    one."""
    p = q.values.shape[-1]
    codes, scales = q.values.data_ptr(), q.scales.data_ptr()
    width = 1
    if scales % 16 == 0 and codes % 16 == 0 and p % 16 == 0:
        width = 16
    elif scales % 16 == 0 and codes % 4 == 0 and p % 4 == 0:
        width = 4
    return f"{'columns' if form == 'matvec' else 'strips'}/{width}"


def place_quantized(q, code_offset: int = 0, scale_offset: int = 0):
    """``q``'s codes and scales copied into buffers at ``code_offset``
    bytes and ``scale_offset`` floats past an aligned start, so that the
    operand lies misaligned on the card."""
    v = torch.empty(q.values.numel() + 16, dtype=q.values.dtype,
                    device="cuda")
    s = torch.empty(q.scales.numel() + 4, device="cuda")
    values = v[code_offset:code_offset + q.values.numel()].view(
        q.values.shape)
    scales = s[scale_offset:scale_offset + q.scales.numel()].view(
        q.scales.shape)
    values.copy_(q.values)
    scales.copy_(q.scales)
    return alg.Quantized(values, scales, q.block, q.mode)


def check_k9_forms(gen, note, qforms) -> None:
    """Every K9 form, kind and load width against its plain version: ragged
    shapes (n not a multiple of the block, n < block, p % 16 != 0, p < 16),
    blocks 16 / 32 / 64 / 128, B = 1..3, and operands whose codes lie 1-15
    bytes or whose scales lie 4 bytes off their alignment (a narrower load,
    and no copy: the call's peak allocation stays below the codes' size).
    ADD over TIMES within 1e-5 of sum |x||a| per output, MIN over PLUS
    bit-exact; each call one launch, on the host's kind and width."""
    seen = collections.Counter()
    # The stream's workspace at its largest first, so that a call's
    # allocations are its output alone.
    like = torch.empty(1, device="cuda")
    _lib.workspace(like, _lib.stream_ptr(like), 1 << 16, 1 << 26)

    def run(k, fn, plain, q, x, form, what, no_copy=False):
        scale = gemv_scale(q.dequantize(), x, form == "matvec")
        want = expected_qform(form, q)
        for f, op, exact in ((alg.TIMES, alg.ADD, False),
                             (alg.PLUS, alg.MIN, True)):
            if exact and q.mode != "int8":
                continue
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got, took = gemv_form(lambda: fn(f, op, q, x))
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            seen[took] += 1
            expect(took == want and (not no_copy or extra < q.values.nbytes),
                   f"{k} {f.name}/{op.name} {what}: on {took} (want "
                   f"{want}), {extra} bytes allocated")
            check_gemv(k, note, got, plain(f, op, q, x), None if exact
                       else scale, f"{f.name}/{op.name} {what} on {took}",
                       exact)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    shapes = ((1, 63, 33, 64), (3, 65, 31, 64), (3, 200, 5, 64),
              (1, 1, 1, 16), (3, 17, 40, 16), (1, 300, 3000, 64),
              (2, 100, 48, 32), (1, 129, 16, 128), (2, 40, 4096, 16),
              (3, 64, 1008, 64), (1, 33, 7, 32), (2, 300, 160, 128),
              (1, 5000, 64, 64), (1, 64, 100000, 64))
    for B, n, p, block in shapes:
        A = randn(B, n, p)
        for mode in alg.QUANT_MODES:
            qb = alg.quantize(A, mode=mode, block=block)
            qf = alg.quantize(A[0], mode=mode, block=block)
            for k, fn, plain, mv, batched in qforms:
                q = qb if batched else qf
                x = randn(*((B,) if batched else ()), n if mv else p)
                run(k, fn, plain, q, x, "matvec" if mv else "vecmat",
                    f"{mode} {tuple(q.shape)} block {block}")
    # Misaligned operands: the codes 1-15 bytes off, the scales 4 bytes off.
    for B, n, p, block, offsets in (
            (1, 300, 3000, 64, ((1, 0), (4, 0), (8, 0), (15, 0), (0, 1))),
            (2, 130, 512, 32, ((3, 0), (12, 0), (0, 1), (5, 1)))):
        A = randn(B, n, p)
        for mode in ("int8", "fp8_e4m3"):
            qs = {False: alg.quantize(A[0], mode=mode, block=block),
                  True: alg.quantize(A, mode=mode, block=block)}
            for co, so in offsets:
                for k, fn, plain, mv, batched in qforms:
                    q = place_quantized(qs[batched], co, so)
                    x = randn(*((B,) if batched else ()), n if mv else p)
                    run(k, fn, plain, q, x, "matvec" if mv else "vecmat",
                        f"{mode} {tuple(q.shape)} block {block}, codes "
                        f"+{co} bytes, scales +{4 * so} bytes", no_copy=True)
    forms = {f"{kind}/{w}" for kind in ("columns", "strips")
             for w in (1, 4, 16)}
    expect(forms <= set(seen), f"every K9 kind ran with every load width: "
                               f"{dict(seen)}")


def ordered_quantized(gen, shape, block):
    """An int8 operand whose dequantized values are exact integers: codes
    in [-127, 127], scales 1, 2 or 4."""
    values = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
    nb = -(-shape[-2] // block)
    scales = torch.pow(2.0, torch.randint(
        0, 3, (*shape[:-2], nb, shape[-1]), generator=gen,
        device="cuda").float())
    return alg.Quantized(values, scales, block, "int8")


def check_ordered_folds(gen, note, qforms, bmv) -> None:
    """The order of every fold: MAT2_MUL over D4, the signed permutation
    matrices that x a picks, an operator that does not commute, whose
    folds are exact at any length.  Bit-exact against the plain version on
    every K9 form (int8 codes, power-of-two scales, integer x) and on K7's
    dense forms (integer-valued f32), at shapes that take several chunks
    (the last block folds them in chunk order) and one, in each load
    width."""
    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen,
                             device="cuda").float()

    chunked = set()
    for B, n, p, block in ((1, 5000, 64, 64), (1, 64, 100000, 64),
                           (2, 3000, 48, 32), (2, 128, 20000, 128),
                           (3, 65, 31, 16), (1, 1000, 1000, 64)):
        qb = ordered_quantized(gen, (B, n, p), block)
        qf = alg.Quantized(qb.values[0], qb.scales[0], block, "int8")
        for co in (0, 4, 1):
            for k, fn, plain, mv, batched in qforms:
                q = qb if batched else qf
                if co:
                    q = place_quantized(q, co)
                x = ints(*((B,) if batched else ()), n if mv else p)
                call = matvec_k.resolve(
                    matvec_k.MATVEC if mv else matvec_k.VECMAT, "order", D4,
                    alg.MAT2_MUL, q, x, batched)
                got, took = gemv_form(lambda: fn(D4, alg.MAT2_MUL, q, x))
                if call.geo[7] > 1:
                    chunked.add(took)
                check_gemv(k, note, got, plain(D4, alg.MAT2_MUL, q, x), None,
                           f"d4/mat2_mul {tuple(q.shape)} block {block} codes "
                           f"+{co} on {took}, {call.geo[7]} chunks, in order",
                           exact=True)
    for shape in ((2, 10000, 64), (2, 64, 50000), (40, 2048, 256),
                  (3, 1000, 5), (1, 3, 3000)):
        A = ints(*shape)
        for k, fn, plain, _, mv in bmv:
            x = ints(shape[0], shape[1] if mv else shape[2])
            call = matvec_k.resolve(matvec_k.MATVEC if mv else matvec_k.VECMAT,
                                    "order", D4, alg.MAT2_MUL, A, x, True)
            got, took = gemv_form(lambda: fn(D4, alg.MAT2_MUL, A, x))
            if call.geo[7] > 1:
                chunked.add(took)
            check_gemv(k, note, got, plain(D4, alg.MAT2_MUL, A, x), None,
                       f"d4/mat2_mul f32 {shape} on {took}, {call.geo[7]} "
                       f"chunks, in order", exact=True)
    expect({"columns/16", "strips/16", "columns/4", "rows/4"} <= chunked,
           f"the ordered folds met chunked launches of every wide kind: "
           f"{sorted(chunked)}")


def check_k7_k9(res, gen, note) -> None:
    """K7's GEMVs and K9 against their plain versions: ragged sizes, every
    operator kind (ADD over TIMES within 1e-5 of sum |x||a|, MIN over PLUS
    bit-exact, MAT2_MUL's fold of shears), int8 leaves, every K9 kind and
    load width (check_k9_forms), the order of every fold
    (check_ordered_folds), every code of each mode, then the full-width
    shapes, timed: K7's wrapper and public call in turns with torch.bmm,
    and every form's device time (torch.profiler)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    bmv = K7_FORMS
    for B, n, p in ((1, 1, 1), (3, 65, 33), (1, 255, 257), (3, 1000, 5),
                    (2, 7, 3000), (3, 64, 31)):
        A = randn(B, n, p)
        for k, fn, plain, shear, mv in bmv:
            x = randn(B, n if mv else p)
            scale = gemv_scale(A, x, mv)
            for f, op, exact in ((alg.TIMES, alg.ADD, False),
                                 (alg.PLUS, alg.MIN, True),
                                 (shear, alg.MAT2_MUL, False)):
                check_gemv(k, note, fn(f, op, A, x), plain(f, op, A, x),
                           scale, f"{f.name}/{op.name} f32 ({B},{n},{p})",
                           exact)
    # int8 leaves: products and sums wrap, as torch's int8 arithmetic.
    A8 = torch.randint(-128, 128, (3, 100, 40), generator=gen,
                       device="cuda", dtype=torch.int32).to(torch.int8)
    for k, fn, plain, _, mv in bmv:
        x8 = A8[:, :, 0].contiguous() if mv else A8[:, 0, :].contiguous()
        check_gemv(k, note, fn(alg.TIMES, alg.ADD, A8, x8),
                   plain(alg.TIMES, alg.ADD, A8, x8), None,
                   "times/add int8 (3,100,40), wrapping", exact=True)
    expect(torch.equal(matvec_k.matvec_cuda(alg.TIMES, alg.ADD, A8[0],
                                            A8[0, :, 0].contiguous()),
                       matvec_k.matvec_plain(alg.TIMES, alg.ADD, A8[0],
                                             A8[0, :, 0].contiguous())),
           "K4 matvec times/add int8 (100, 40): bit-exact")

    qforms = K9_FORMS
    check_k9_forms(gen, note, qforms)
    check_ordered_folds(gen, note, qforms, bmv)
    # Every code of each mode through the device decode, scale 1, x = e_0:
    # a (256, 1) operand (STRIPS, one code a load), a (256, 16) one whose
    # row i holds code i (STRIPS, 16 codes a load) and its transpose
    # (COLUMNS, 16 codes a load).
    for mode in alg.QUANT_MODES:
        codes = torch.arange(256, dtype=torch.int32, device="cuda").to(
            alg.QUANT_DEVICE[mode][0])
        want = alg.Quantized(codes[:, None], torch.ones(16, 1, device="cuda"),
                             16, mode).decoded()[:, 0]
        e0 = torch.zeros(16, device="cuda")
        e0[0] = 1.0
        cases = (
            ("K9-vecmat", matvec_k.vecmat_quantized_cuda, alg.Quantized(
                codes[:, None].contiguous(), torch.ones(16, 1, device="cuda"),
                16, mode), torch.ones(1, device="cuda"), "strips/1"),
            ("K9-vecmat", matvec_k.vecmat_quantized_cuda, alg.Quantized(
                codes[:, None].expand(256, 16).contiguous(),
                torch.ones(16, 16, device="cuda"), 16, mode), e0,
             "strips/16"),
            ("K9-matvec", matvec_k.matvec_quantized_cuda, alg.Quantized(
                codes[None, :].expand(16, 256).contiguous(),
                torch.ones(1, 256, device="cuda"), 16, mode), e0,
             "columns/16"))
        for k, fn, q, x, form in cases:
            got, took = gemv_form(lambda: fn(alg.TIMES, alg.ADD, q, x))
            expect(torch.equal(got, want) and took == form and (
                mode != "fp8_e4m3" or float(got[0x7F]) == 480.0),
                f"{k} {mode} {tuple(q.shape)} on {took} (want {form}): all "
                f"256 codes decode as the codec does (e4m3 0x7F to 480)")

    # -- Full width.  K7: recurrentgemma-2b's decode-attention GEMVs (4 slots
    # x 10 heads against the 2,048-token window at head_dim 256) and
    # (8, 4096, 4096); library: one torch.bmm.
    bat = Batched()
    for k, fn, plain, _, mv in bmv:
        lib = (lambda A, x: torch.bmm(x[:, None, :], A)) if mv else \
            (lambda A, x: torch.bmm(A, x[:, :, None]))
        public = forge.matvec if mv else forge.vecmat
        for shape, key in ((ATTN, None), (BIG_BATCHED, "large")):
            B, n, p = shape
            A = randn(*shape)
            x = randn(B, n if mv else p)
            check_gemv(k, note, fn(alg.TIMES, alg.ADD, A, x),
                       plain(alg.TIMES, alg.ADD, A, x), gemv_scale(A, x, mv),
                       f"times/add f32 {shape}")
            timing = time_turns({
                "ms": lambda: fn(alg.TIMES, alg.ADD, A, x),
                "public_ms": lambda: public(alg.TIMES, alg.ADD, A, x,
                                            layout=bat),
                "library_ms": lambda: lib(A, x)},
                reps=100 if key is None else 20)
            timing.update(
                plain_ms=time_ms(lambda: plain(alg.TIMES, alg.ADD, A, x), 3),
                device_ms=launch_ms(lambda: fn(alg.TIMES, alg.ADD, A, x)),
                public_ratio=timing["public_ms"] / timing["library_ms"])
            bound = bound_ms(4 * (B * n * p + B * n + B * p), 2 * B * n * p)
            what = f"{shape} f32 ARITHMETIC"
            if key is None:
                res[k].update(timing, bound=bound, shape=what)
            else:
                res[k][key] = dict(timing, bound_ms=bound[0], shape=what)
            del A, x
    # K9 flat: the unembed GEMV (2560, 256000) in each mode, block 64;
    # library: dequantize then torch.mv (two calls), and the dense f32
    # torch.mv at the same shape.
    n, p = UNEMBED
    W = randn(n, p) * 0.02
    xs = {True: randn(n), False: randn(p)}
    for mode in alg.QUANT_MODES:
        q = alg.quantize(W, mode=mode, block=QUANT_BLOCK)
        for k, fn, plain, mv, batched in qforms[:2]:
            x = xs[mv]
            check_gemv(k, note, fn(alg.TIMES, alg.ADD, q, x),
                       plain(alg.TIMES, alg.ADD, q, x),
                       gemv_scale(q.dequantize(), x, mv),
                       f"times/add {mode} {UNEMBED} block {QUANT_BLOCK}")
            ms = time_ms(lambda: fn(alg.TIMES, alg.ADD, q, x), 20)
            bound = bound_ms(quant_bytes(n, p), QUANT_OPS[mode] * n * p)
            res[k].setdefault("modes", {})[mode] = {
                "ms": ms, "bound_ms": bound[0], "bound_by": bound[1],
                "device_ms": launch_ms(lambda: fn(alg.TIMES, alg.ADD, q, x)),
                "library_ms": time_ms(
                    lambda: torch.mv(q.dequantize().t() if mv else
                                     q.dequantize(), x), 5)}
            if mode == "int8":
                res[k].update(
                    ms=ms, bound=bound,
                    device_ms=res[k]["modes"][mode]["device_ms"],
                    plain_ms=time_ms(lambda: plain(alg.TIMES, alg.ADD, q, x),
                                     2),
                    library_ms=res[k]["modes"][mode]["library_ms"],
                    dense_mv_ms=time_ms(lambda: torch.mv(
                        W.t() if mv else W, x), 20),
                    shape=f"{UNEMBED} int8, block {QUANT_BLOCK} (library: "
                          f"dequantize + torch.mv)")
        del q
    del W, xs
    # K9 batched: (8, 4096, 4096) int8, block 64; library: dequantize then
    # torch.bmm (two calls).
    B, n, p = BIG_BATCHED
    A = randn(B, n, p)
    q = alg.quantize(A, mode="int8", block=QUANT_BLOCK)
    for k, fn, plain, mv, batched in qforms[2:]:
        x = randn(B, n if mv else p)
        check_gemv(k, note, fn(alg.TIMES, alg.ADD, q, x),
                   plain(alg.TIMES, alg.ADD, q, x),
                   gemv_scale(q.dequantize(), x, mv),
                   f"times/add int8 {BIG_BATCHED} block {QUANT_BLOCK}")
        lib = (lambda: torch.bmm(x[:, None, :], q.dequantize())) if mv else \
            (lambda: torch.bmm(q.dequantize(), x[:, :, None]))
        res[k].update(
            ms=time_ms(lambda: fn(alg.TIMES, alg.ADD, q, x), 20),
            device_ms=launch_ms(lambda: fn(alg.TIMES, alg.ADD, q, x)),
            plain_ms=time_ms(lambda: plain(alg.TIMES, alg.ADD, q, x), 3),
            library_ms=time_ms(lib, 10),
            dense_bmm_ms=time_ms(
                (lambda: torch.bmm(x[:, None, :], A)) if mv else
                (lambda: torch.bmm(A, x[:, :, None])), 10),
            bound=bound_ms(quant_bytes(n, p, B), QUANT_OPS["int8"] * B * n * p),
            shape=f"{BIG_BATCHED} int8, block {QUANT_BLOCK} (library: "
                  f"dequantize + torch.bmm)")
    del A, q


# K10's cases: (label, B, S, T, K, G, hd, dtype, causal, window, softcap[,
# dv]), dv the value head dim where it is not hd.
# The first eleven are timed (K10_TIMED), the first being the kernel's row:
# a gemma2-27b global layer's prefill of the 2,100-token prompt; then its
# local layers' and recurrentgemma-2b's (MQA, window 2048, which bites at
# 2,100 but skips no tile), gemma3-4b's global and local layers (8 / 4
# heads of 256, the local window 1024), minitron-4b's (24 / 8 heads: G = 3),
# moonshot-v1-16b-a3b's (16 / 16: G = 1), deepseek-v3-671b's MLA layer
# (128 heads, q and k 192 wide, v 128: the tensor-core body's three groups
# with a 192-wide QK^T) and seamless-m4t-medium's three (16 / 16 heads of
# 64: the encoder's bidirectional layer, the decoder's causal self
# attention, and its cross attention of a 64-token decoder prompt over
# 2,100 source frames, neither causal nor S = T).  The "value head" cases hold v narrower than q in
# both bodies: a value row padded by TMA's zero fill (48 of 64), the
# two-stage ring at head_dim 256, query blocks at their edge.  The "skips
# tiles" cases have query tiles whose window starts a whole kv tile or more
# after key 0.  bf16 runs the tensor-core body (query blocks of 192 rows up
# to a value head of 128, 128 above) and f32 the CUDA-core body (32 rows),
# so each edge has a case in both, and the bf16 query tiles meet T = 63 and
# 65 at a block's edge +-1.  head_dim 80 (one 64-wide box and one that
# TMA's zero fill pads) and 192 (three boxes, the largest ring in shared
# memory) reach the body's other forms.
BF16, F32 = torch.bfloat16, torch.float32
K10Case = collections.namedtuple(
    "K10Case", "label B S T K G hd dtype causal window softcap dv",
    defaults=(None,))
K10_CASES = tuple(K10Case(*c) for c in (
    ("gemma2-27b global", 1, 2100, 2100, 16, 2, 128, BF16, True, 0, 50.0),
    ("gemma2-27b local", 1, 2100, 2100, 16, 2, 128, BF16, True, 4096, 50.0),
    ("recurrentgemma-2b local", 1, 2100, 2100, 1, 10, 256, BF16, True, 2048,
     0.0),
    ("gemma3-4b global", 1, 2100, 2100, 4, 2, 256, BF16, True, 0, 0.0),
    ("gemma3-4b local", 1, 2100, 2100, 4, 2, 256, BF16, True, 1024, 0.0),
    ("minitron-4b", 1, 2100, 2100, 8, 3, 128, BF16, True, 0, 0.0),
    ("moonshot-v1-16b-a3b", 1, 2100, 2100, 16, 1, 128, BF16, True, 0, 0.0),
    ("deepseek-v3-671b MLA", 1, 2100, 2100, 128, 1, 192, BF16, True, 0, 0.0,
     128),
    ("seamless-m4t-medium encoder", 1, 2100, 2100, 16, 1, 64, BF16, False, 0,
     0.0),
    ("seamless-m4t-medium decoder self", 1, 2100, 2100, 16, 1, 64, BF16,
     True, 0, 0.0),
    ("seamless-m4t-medium cross", 1, 64, 2100, 16, 1, 64, BF16, False, 0,
     0.0),
    ("T = 1", 2, 1, 1, 16, 2, 128, BF16, True, 0, 50.0),
    ("S, T at a tile -1, +1", 2, 31, 65, 16, 2, 128, BF16, True, 0, 50.0),
    ("S, T at a tile +1, -1", 2, 33, 63, 1, 10, 256, BF16, True, 2048, 0.0),
    ("f32, window and soft cap", 2, 65, 65, 2, 2, 128, F32, True, 7, 30.0),
    ("f32, S > T, not causal", 1, 100, 37, 1, 3, 256, F32, False, 0, 0.0),
    ("f32, rows that keep no key", 1, 100, 20, 2, 2, 16, F32, True, 8, 0.0),
    ("bf16, window skips tiles", 1, 400, 400, 16, 2, 128, BF16, True, 100,
     50.0),
    ("bf16, window skips tiles, head_dim 256", 1, 1100, 1100, 1, 10, 256,
     BF16, True, 256, 0.0),
    ("f32, window skips tiles", 1, 400, 400, 2, 3, 64, F32, True, 100, 30.0),
    ("f32, window skips tiles, not causal", 1, 200, 200, 1, 2, 32, F32,
     False, 70, 0.0),
    ("bf16, rows that keep no key", 1, 100, 20, 2, 2, 16, BF16, True, 8, 0.0),
    ("bf16, rows that keep no key, head_dim 256", 1, 300, 40, 1, 2, 256,
     BF16, True, 30, 0.0),
    ("bf16, S > T, not causal", 1, 100, 37, 1, 3, 256, BF16, False, 0, 0.0),
    ("bf16, window skips tiles, head_dim 64", 1, 400, 400, 2, 3, 64, BF16,
     True, 100, 30.0),
    ("bf16, window skips tiles, not causal, head_dim 32", 1, 200, 200, 1, 2,
     32, BF16, False, 70, 0.0),
    ("bf16, query tile 127 against T = 63", 1, 127, 63, 2, 2, 64, BF16, True,
     0, 30.0),
    ("bf16, query tile 129 against T = 65", 2, 129, 65, 2, 3, 128, BF16,
     False, 0, 0.0),
    ("bf16, query block 191 against T = 63", 1, 191, 63, 2, 2, 128, BF16,
     True, 0, 50.0),
    ("bf16, query block 193 against T = 65", 1, 193, 65, 1, 2, 128, BF16,
     False, 0, 50.0),
    ("bf16, query block 127 against T = 65, head_dim 256", 1, 127, 65, 1, 2,
     256, BF16, True, 0, 0.0),
    ("bf16, query block 129 against T = 63, head_dim 256", 1, 129, 63, 1, 2,
     256, BF16, False, 0, 0.0),
    ("bf16, ragged T, window and soft cap, head_dim 80", 2, 150, 203, 2, 2,
     80, BF16, True, 90, 30.0),
    ("bf16, ragged T, window and soft cap, head_dim 192", 1, 300, 277, 1, 3,
     192, BF16, True, 200, 50.0),
    ("bf16, value head 128 of 192, ragged T, window and soft cap", 2, 150,
     203, 2, 2, 192, BF16, True, 90, 30.0, 128),
    ("bf16, value head 128 of 192, query block 193 against T = 65", 1, 193,
     65, 2, 1, 192, BF16, True, 0, 0.0, 128),
    ("bf16, value head 48 of 80, S > T, not causal", 1, 129, 65, 1, 2, 80,
     BF16, False, 0, 0.0, 48),
    ("bf16, value head 128 of 256 (two stages), window", 1, 300, 300, 1, 2,
     256, BF16, True, 100, 0.0, 128),
    ("f32, value head 128 of 192 (MLA)", 1, 100, 100, 4, 1, 192, F32, True,
     0, 0.0, 128),
    ("f32, value head 48 of 80, window and soft cap", 1, 70, 70, 2, 2, 80,
     F32, True, 16, 30.0, 48),
))
K10_TIMED = tuple(c.label for c in K10_CASES[:11])
K10_UNITS = sorted({(c.dtype, c.hd, c.dv or c.hd) for c in K10_CASES},
                   key=str)


def skips_window_tiles(c: K10Case) -> bool:
    """Whether a query block of K10 starts its keys past the first kv tile
    (csrc/flash_attention.cuh: KvRange's begin > 0): a window that ends a
    whole tile before the block's first query, in a block whose rows all
    keep a key."""
    S, T, window = c.S, c.T, c.window
    rows = _lib.load(flash_k.flash_unit(c.dtype, c.hd, "K10",
                                        c.dv)).rt_flash_rows()
    q0 = (S - 1) // rows * rows
    return window > 0 and S - 1 < T + window - 1 and \
        q0 - window + 1 >= flash_k.KV_BLOCK


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a mask keeps, positions from 0: what the
    scores and p . v of this input need."""
    qpos = np.arange(S)
    hi = np.minimum(T - 1, qpos) if causal else np.full(S, T - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k10_bound(B, S, T, K, G, hd, dtype, causal, window, dv=None):
    """q, k, v read once (k and v per kv head), out written once; 2 (hd +
    dv) operations per kept pair (the score over hd, p . v over the value
    head dim dv, hd where None) at the dtype's peak."""
    dv = dv or hd
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (B * S * K * G * (hd + dv) + B * T * K * (hd + dv))
    ops = 2 * (hd + dv) * B * K * G * attention_pairs(S, T, causal, window)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S if dtype == BF16
                    else F32_OPS_PER_S)


def k10_row_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the output rows (one
    query of one head, its hd elements)."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend SDPA picks for these inputs (its own dispatch,
    ``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name


def check_k10(res, gen, note) -> None:
    """K10 against its plain version (same kv tile, so both take the same
    running maxima), each output row against that row's norm.  In bf16 the
    two differ where a float32 difference in a score (sums in another
    order) moves p or an output element across a bf16 rounding boundary.
    One such step of an output element is at most 2^-7 of it, so a row
    stays within 2^-7 of its norm; a p that flips by 2^-8 moves a row by
    2^-8 p / l of a v row, far below that for random v.  float32 is held at
    1e-5 of the row's norm (score and p . v sums in another order).  A
    mask that wrongly keeps or drops k of the n keys a row averages moves
    it by about sqrt(k / n) of its norm: 0.022 for one key in 2,048, three
    times the bf16 bound."""
    for case in K10_CASES:
        label, B, S, T, K, G, hd, dtype, causal, window, cap, dv = case
        dv = dv or hd

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rn(B, S, K, G, hd), rn(B, T, K, hd), rn(B, T, K, dv)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_k.flash_attention_gqa(q, k, v, **kw)
        want = ref.flash_attention_gqa_ref(q, k, v, kv_block=flash_k.KV_BLOCK,
                                           **kw)
        note("K10", max_err(got, want))
        err = k10_row_err(got, want)
        tol = 2 ** -7 if dtype == BF16 else 1e-5
        expect(bool(torch.isfinite(got).all()) and err <= tol
               and tuple(got.shape) == (B, S, K, G, dv),
               f"K10 {label} ({B}, {S}/{T}, {K * G}/{K} heads, {hd}/{dv}) "
               f"{str(dtype)[6:]} causal={causal} window={window} softcap="
               f"{cap}: max row err / row norm {err:.3g} <= {tol:.3g} (max "
               f"abs err {max_err(got, want):.3g})")
        if label == "f32, window and soft cap":      # the (N, S, d) entry
            q3, k3, v3 = (x.permute(0, 2, 1, 3).reshape(B * K, -1, hd)
                          for x in (q[:, :, :, 0], k, v))
            got3 = flash_k.flash_attention(q3, k3, v3, **kw)
            want3 = ref.flash_attention_ref(q3, k3, v3,
                                            kv_block=flash_k.KV_BLOCK, **kw)
            note("K10", max_err(got3, want3))
            err3 = k10_row_err(got3, want3)
            expect(err3 <= tol, f"K10 (N, S, d) entry: max row err / row "
                                f"norm {err3:.3g} <= {tol:.3g}")
        if label not in K10_TIMED:
            continue
        qs = q.reshape(B, S, K * G, hd).transpose(1, 2).contiguous()
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        sdpa = dict(is_causal=causal, enable_gqa=True)
        timing = {
            "ms": time_ms(lambda: flash_k.flash_attention_gqa(q, k, v, **kw),
                          20),
            "plain_ms": time_ms(lambda: ref.flash_attention_gqa_ref(
                q, k, v, kv_block=flash_k.KV_BLOCK, **kw), 3),
            # A speed baseline only: SDPA has no soft cap and no window;
            # its mask is the case's (causal or not).
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, **sdpa), 20),
            "library_backend": sdpa_backend(qs, ks, vs, **sdpa)}
        bound = k10_bound(B, S, T, K, G, hd, dtype, causal, window, dv)
        what = (f"({B}, {S}, {K * G}/{K} heads, {hd}"
                + (f"/{dv}" if dv != hd else "") + f") {str(dtype)[6:]} "
                f"{label}"
                + (f" softcap {cap:g}" if cap else ""))
        if not res["K10"].get("shape"):
            res["K10"].update(timing, bound=bound, shape=what)
        res["K10"].setdefault("shapes", {})[label] = dict(
            timing, bound_ms=bound[0], bound_by=bound[1])
        del qs, ks, vs
    del q, k, v, got, want
    for dtype in (BF16, F32):
        expect(any(c.dtype == dtype and skips_window_tiles(c)
                   for c in K10_CASES),
               f"K10: a {str(dtype)[6:]} case skips kv tiles before its "
               f"window")


# ---------------------------------------------------------------------------
# Phase 3: the primitive library's own path at the paper's sizes
# ---------------------------------------------------------------------------

SCAN_SIZES = (10**6, 10**7, 10**8, 10**9)             # Table IV
MV_SHAPES = ((10**3, 10**4), (10**4, 10**3), (10, 10**6), (10**6, 10),
             (10**4, 10**4))                          # Tables V / VI
N_PAPER = 10**8
SEG_MEAN = 1000                  # mean segment length of the ragged stream
STD_N = 1 << 20                  # every STD_OPS operator's scan


def small_ints(gen, n, dtype=torch.float32):
    """Integers in [-8, 8] as ``dtype``.  Their partial sums are random
    walks far below 2^24, where float32 stops being exact, so every order
    of a scan or a sum gives the same bits: the checks can be bit-exact."""
    return torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                         dtype=torch.int32).to(dtype)


def unit_quaternions(gen, n):
    """Rotations: products of any length stay of size 1."""
    q = torch.randn(4, n, generator=gen, device="cuda")
    q = q / q.norm(dim=0)
    return tuple(q[i].contiguous() for i in range(4))


def csr_offsets(gen, n, mean):
    """CSR offsets of segments of random length, uniform in [1, 2 mean)."""
    lens = torch.randint(1, 2 * mean, (2 * n // mean + 16,), generator=gen,
                         device="cuda")
    ends = torch.cumsum(lens, 0)
    zero = torch.zeros(1, dtype=torch.long, device="cuda")
    return torch.cat([zero, ends[ends < n], zero + n]).to(torch.int32)


def std_operand(gen, name, n):
    """One operand per operator, in ranges where a scan of 2^20 stays
    finite (the operators' own ranges of tests/conftest.py, narrowed where
    products would overflow)."""
    def u(lo, hi):
        return torch.empty(n, device="cuda").uniform_(lo, hi, generator=gen)
    if name in ("add", "max", "min"):
        return u(-100, 100)
    if name == "mul":
        return u(0.999, 1.001)
    if name == "logsumexp":
        return u(-5, 5)
    if name == "affine":
        return (u(0.5, 1.0), u(-2, 2))
    if name == "maxplus_affine":
        return (u(-1, 0), u(-3, 3))
    if name == "softmax_merge":
        return (u(-3, 3), u(0.1, 2), u(-2, 2))
    if name == "quaternion_mul":
        return unit_quaternions(gen, n)
    angle = u(-3.1416, 3.1416)                    # mat2_mul: rotations
    c, s = torch.cos(angle), torch.sin(angle)
    return (c, s, -s, c)


def quickstart_data(gen):
    """examples/quickstart.py's inputs, on the card."""
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    W = torch.where(torch.rand(64, 64, generator=gen, device=dev) < 0.2,
                    torch.rand(64, 64, generator=gen, device=dev) * 10,
                    torch.full((64, 64), float("inf"), device=dev))
    W.fill_diagonal_(0.0)
    dist = torch.full((64,), float("inf"), device=dev)
    dist[0] = 0.0
    lens = torch.tensor([8, 3, 5, 1], device=dev)
    return {
        "x": rnd(1000),
        "q": tuple(rnd(256) * 0.1 + (1.0 if i == 0 else 0.0)
                   for i in range(4)),
        "u8": torch.randint(0, 256, (100_000,), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8),
        "W": W, "dist": dist,
        "logA": torch.log_softmax(rnd(32, 32), dim=1),
        "logp": torch.log_softmax(rnd(32), dim=0),
        "vals": torch.arange(10, dtype=torch.float32, device=dev),
        "offs": torch.tensor([0, 3, 8, 10], dtype=torch.int32, device=dev),
        "a": torch.rand(2, 128, 256, generator=gen, device=dev) * 0.09 + 0.9,
        "b": rnd(2, 128, 256),
        "probs": torch.softmax(rnd(4, 8), dim=-1),
        "mask": (torch.arange(8, device=dev)[None] < lens[:, None]).int(),
        "expert": torch.randint(0, 4, (24,), generator=gen, device=dev,
                                dtype=torch.int32),
        "tok": torch.arange(24, dtype=torch.int32, device=dev),
        "logits": rnd(10),
    }


def quickstart(q, backend=None) -> dict:
    """examples/quickstart.py sections 1-8 through the public API."""
    o = {"1 scan": forge.scan(alg.ADD, q["x"], backend=backend),
         "1 scan max exclusive": forge.scan(alg.MAX, q["x"], inclusive=False,
                                            backend=backend),
         "2 quaternion scan": forge.scan(alg.QUATERNION_MUL, q["q"],
                                         backend=backend),
         "3 UnitFloat8 sum": forge.mapreduce(alg.unitfloat8_decode, alg.ADD,
                                             q["u8"], backend=backend)}
    dist = q["dist"]
    for _ in range(4):
        dist = forge.semiring_matvec(alg.TROPICAL_MIN_PLUS, q["W"], dist,
                                     backend=backend)
    o["4 tropical 4-hop"] = dist
    o["5 log vecmat"] = forge.semiring_vecmat(alg.LOG_SEMIRING, q["logA"],
                                              q["logp"], backend=backend)
    seg = Segmented(offsets=q["offs"])
    o["6 segmented scan"] = forge.scan(alg.ADD, q["vals"], layout=seg,
                                       backend=backend)
    o["6 segmented sums"] = forge.mapreduce(alg.IDENTITY, alg.ADD, q["vals"],
                                            layout=seg, backend=backend)
    o["7 linear recurrence"] = forge.linear_recurrence(q["a"], q["b"],
                                                       backend=backend)
    o["7b batched exclusive"] = forge.scan(alg.ADD, q["probs"],
                                           inclusive=False, layout=Batched(),
                                           backend=backend)
    o["7b masked sums"] = forge.mapreduce(alg.masked_select(0.0), alg.ADD,
                                          (q["probs"], q["mask"]),
                                          layout=Batched(), backend=backend)
    o["8 sort_pairs"] = forge.sort_pairs(q["expert"], q["tok"],
                                         backend=backend)
    o["8 segmented top_k"] = forge.top_k(q["logits"], 2, layout=seg,
                                         backend=backend)
    return o


def primitives_data(gen) -> dict:
    d = {f"x{n}": small_ints(gen, n) for n in SCAN_SIZES}
    d["x64"] = small_ints(gen, N_PAPER, torch.float64)
    d["u8"] = torch.randint(0, 256, (N_PAPER,), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.uint8)
    d["q7"] = unit_quaternions(gen, 10**7)
    d["mv"] = {}
    for n, p in MV_SHAPES:
        d["mv"][(n, p)] = tuple(
            torch.empty(s, device="cuda").uniform_(-1, 1, generator=gen)
            for s in ((n, p), (n,), (p,)))
    d["Ai"] = torch.randint(-9, 10, (10**6, 10), generator=gen, device="cuda",
                            dtype=torch.int32)
    d["xi"] = torch.randint(-9, 10, (10**6,), generator=gen, device="cuda",
                            dtype=torch.int32)
    d["offs8"] = csr_offsets(gen, N_PAPER, SEG_MEAN)
    d["q6"] = unit_quaternions(gen, 10**6)
    d["offs6"] = csr_offsets(gen, 10**6, SEG_MEAN)
    d["std"] = {name: std_operand(gen, name, STD_N) for name in alg.STD_OPS}
    d["keys"] = torch.randn(10**6, generator=gen, device="cuda")
    d["iota"] = torch.arange(10**6, dtype=torch.int32, device="cuda")
    d["qs"] = quickstart_data(gen)
    d.update(gemv_data(gen, d["mv"][(10**4, 10**4)][0]))
    return d


def gemv_data(gen, A4) -> dict:
    """The matvec family's operands: K7's model shapes, shears, the unembed
    matrix quantized in each mode, the paper's (10^4, 10^4) matrix ``A4``
    quantized, (8, 4096, 4096) in int8, and (64, 65536) unit quaternions
    for the reroute."""
    def u(*shape, lo=-1.0):
        return torch.empty(*shape, device="cuda").uniform_(lo, 1.0,
                                                           generator=gen)
    d = {"bmv": {shape: (u(*shape), u(*shape[:2]), u(shape[0], shape[2]))
                 for shape in (ATTN, BIG_BATCHED)}}
    d["bmv_shear"] = (u(3, 1000, 64), u(3, 1000), u(3, 64))
    d["W"] = u(*UNEMBED) * 0.02
    d["unembed_x"] = (u(UNEMBED[0]), u(UNEMBED[1]))
    d["q_unembed"] = {m: alg.quantize(d["W"], mode=m, block=QUANT_BLOCK)
                      for m in alg.QUANT_MODES}
    d["q_paper"] = {m: alg.quantize(A4, mode=m, block=QUANT_BLOCK)
                    for m in alg.QUANT_MODES}
    d["qb"] = alg.quantize(d["bmv"][BIG_BATCHED][0], mode="int8",
                           block=QUANT_BLOCK)
    q = torch.randn(4, 64, 65536, generator=gen, device="cuda")
    q = q / q.norm(dim=0)
    d["quat64"] = tuple(q[i].contiguous() for i in range(4))
    return d


def drive_primitives(d) -> tuple[dict, dict]:
    """The library's own path, once, through the entry points a user calls:
    the paper's tables, every STD_OPS operator and STD_SEMIRINGS semiring,
    the Segmented layout, a radix sort, and quickstart's sequence.  Returns
    the outputs and each call's kernel launches."""
    o, per_call = {}, {}

    def run(name, fn):
        before = read_counts()
        o[name] = fn()
        after = read_counts()
        per_call[name] = {k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)}

    x8 = d[f"x{N_PAPER}"]
    run("copy", lambda: forge.copy(x8))
    for n in SCAN_SIZES:
        run(f"scan f32 {n}", lambda: forge.scan(alg.ADD, d[f"x{n}"]))
    run("scan f64", lambda: forge.scan(alg.ADD, d["x64"]))
    run("scan quaternion", lambda: forge.scan(alg.QUATERNION_MUL, d["q7"]))
    for name, op in alg.STD_OPS.items():
        run(f"scan {name}", lambda: forge.scan(op, d["std"][name]))
    run("mapreduce f32", lambda: forge.mapreduce(alg.IDENTITY, alg.ADD, x8))
    run("mapreduce UnitFloat8", lambda: forge.mapreduce(
        alg.unitfloat8_decode, alg.ADD, d["u8"]))
    for (n, p), (A, xv, xz) in d["mv"].items():
        run(f"matvec {n}x{p}", lambda: forge.semiring_matvec(
            alg.ARITHMETIC, A, xv))
        run(f"vecmat {n}x{p}", lambda: forge.semiring_vecmat(
            alg.ARITHMETIC, A, xz))
    A, xv, xz = d["mv"][(10**4, 10**4)]
    for name, sr in alg.STD_SEMIRINGS.items():
        run(f"{name} matvec", lambda: forge.semiring_matvec(sr, A, xv))
        run(f"{name} vecmat", lambda: forge.semiring_vecmat(sr, A, xz))
    run("matvec int32 packed", lambda: forge.matvec(alg.TIMES, alg.ADD,
                                                    d["Ai"], d["xi"]))
    seg8 = Segmented(offsets=d["offs8"])
    run("segmented scan", lambda: forge.scan(alg.ADD, x8, layout=seg8))
    run("segmented sums", lambda: forge.mapreduce(alg.IDENTITY, alg.ADD, x8,
                                                  layout=seg8))
    run("segmented quaternion", lambda: forge.scan(
        alg.QUATERNION_MUL, d["q6"], inclusive=False,
        layout=Segmented(offsets=d["offs6"])))
    run("sort_pairs", lambda: forge.sort_pairs(d["keys"], d["iota"]))
    run("quickstart", lambda: quickstart(d["qs"]))
    drive_gemvs(d, run)
    return o, per_call


def drive_gemvs(d, run) -> None:
    """The matvec family through the public API: Batched matvec / vecmat
    (K7) over three algebras, Quantized operands (K9) in every mode at
    Flat and Batched layout, and mapreduce with a non-commutative operator
    at Batched layout, which reroutes through scan@batched (K7s)."""
    bat = Batched()
    for shape, (A, xv, xz) in d["bmv"].items():
        run(f"batched matvec {shape}", lambda: forge.semiring_matvec(
            alg.ARITHMETIC, A, xv, layout=bat))
        run(f"batched vecmat {shape}", lambda: forge.semiring_vecmat(
            alg.ARITHMETIC, A, xz, layout=bat))
    A, xv, xz = d["bmv"][ATTN]
    run("batched tropical matvec", lambda: forge.semiring_matvec(
        alg.TROPICAL_MIN_PLUS, A, xv, layout=bat))
    run("batched tropical vecmat", lambda: forge.semiring_vecmat(
        alg.TROPICAL_MIN_PLUS, A, xz, layout=bat))
    A, xv, xz = d["bmv_shear"]
    run("batched mat2 matvec", lambda: forge.matvec(
        SHEAR, alg.MAT2_MUL, A, xv, layout=bat))
    run("batched mat2 vecmat", lambda: forge.vecmat(
        SHEAR_VM, alg.MAT2_MUL, A, xz, layout=bat))
    h, v = d["unembed_x"]
    for mode, q in d["q_unembed"].items():
        run(f"quantized {mode} matvec unembed", lambda: forge.matvec(
            alg.TIMES, alg.ADD, q, h))
        run(f"quantized {mode} vecmat unembed", lambda: forge.vecmat(
            alg.TIMES, alg.ADD, q, v))
    _, xv, xz = d["mv"][(10**4, 10**4)]
    for mode, q in d["q_paper"].items():
        run(f"quantized {mode} matvec 1e4", lambda: forge.semiring_matvec(
            alg.ARITHMETIC, q, xv))
        run(f"quantized {mode} vecmat 1e4", lambda: forge.semiring_vecmat(
            alg.ARITHMETIC, q, xz))
    run("quantized int8 tropical matvec 1e4", lambda: forge.semiring_matvec(
        alg.TROPICAL_MIN_PLUS, d["q_paper"]["int8"], xv))
    _, xv, xz = d["bmv"][BIG_BATCHED]
    run("quantized int8 batched matvec", lambda: forge.matvec(
        alg.TIMES, alg.ADD, d["qb"], xv, layout=bat))
    run("quantized int8 batched vecmat", lambda: forge.vecmat(
        alg.TIMES, alg.ADD, d["qb"], xz, layout=bat))
    run("reroute quaternion", lambda: forge.mapreduce(
        alg.IDENTITY, alg.QUATERNION_MUL, d["quat64"], layout=bat,
        backend="cuda"))


def rel_err(got, want, scale) -> float:
    """Max abs error over the leaves, over ``scale`` (a tensor or number)."""
    errs = [((g.double() - w.double()).abs() / scale).max()
            for g, w in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want))]
    return float(max(errs))


def check_primitives_path(o, d) -> None:
    """Every output of the path: the right shape and finite, and equal to
    its plain version or library call -- bit-exact for integer-valued data,
    copies, MAX/MIN and sorts, within the stated bound for floats."""
    x8 = d[f"x{N_PAPER}"]
    expect(torch.equal(o["copy"], x8), "copy 10^8 f32: bit-exact")
    for n in SCAN_SIZES:
        got = o[f"scan f32 {n}"]
        expect(got.shape == (n,) and torch.equal(got, torch.cumsum(
            d[f"x{n}"], 0)), f"scan ADD f32 n={n:.0e}: bit-exact against "
                             f"torch.cumsum (integer-valued data)")
    expect(torch.equal(o["scan f64"], torch.cumsum(d["x64"], 0)),
           "scan ADD f64 n=1e+08: bit-exact against torch.cumsum")
    # A product of n factors carries about sqrt(n) float32 roundings in any
    # association (2e-4 at n = 10^7): products are held at 1e-3 of their
    # size.
    err = max_err(o["scan quaternion"],
                  scan_k.scan_1d_plain(alg.QUATERNION_MUL, d["q7"]))
    expect(err <= 1e-3, f"scan QUATERNION_MUL n=1e+07 (unit quaternions): "
                        f"max abs err {err:.3g} <= 1e-3 against the plain scan")
    for name, op in alg.STD_OPS.items():
        want = scan_k.scan_1d_plain(op, d["std"][name])
        got = o[f"scan {name}"]
        if name in ("max", "min"):
            err, tol = max_err(got, want), 0.0
        else:
            scale = max(max(float(l.abs().max()) for l in
                            torch.utils._pytree.tree_leaves(want)), 1.0)
            err, tol = max_err(got, want) / scale, 1e-3
        expect(err <= tol, f"scan {name} f32 n=2^20 on the cuda route: err "
                           f"{err:.3g} <= {tol} (relative to max |output|)")
    got = o["mapreduce f32"]
    expect(float(got) == float(x8.double().sum()),
           "mapreduce ADD f32 n=1e+08: bit-exact (integer-valued data)")
    got = o["mapreduce UnitFloat8"]
    want = alg.unitfloat8_decode(d["u8"]).double().sum()
    err = abs(float(got) - float(want))
    expect(err <= 1e-6 * N_PAPER, f"mapreduce UnitFloat8 -> f32 ADD n=1e+08: "
                                  f"abs err {err:.4g} <= 1e-6 x n")
    for (n, p), (A, xv, xz) in d["mv"].items():
        for key, x, plain, scale in (
                ("matvec", xv, matvec_k.matvec_plain,
                 (xv.abs()[:, None] * A.abs()).sum(0).double()),
                ("vecmat", xz, matvec_k.vecmat_plain,
                 (A.abs() * xz.abs()[None]).sum(1).double())):
            err = rel_err(o[f"{key} {n}x{p}"], plain(alg.TIMES, alg.ADD, A, x),
                          scale)
            expect(err <= 1e-5, f"{key} ARITHMETIC f32 ({n}, {p}): max err "
                                f"{err:.3g} <= 1e-5 x sum|x||A| per output")
    A, xv, xz = d["mv"][(10**4, 10**4)]
    for name, sr in alg.STD_SEMIRINGS.items():
        for key, x, plain in (("matvec", xv, matvec_k.matvec_plain),
                              ("vecmat", xz, matvec_k.vecmat_plain)):
            got, want = o[f"{name} {key}"], plain(sr.f, sr.op, A, x)
            if name.startswith("tropical"):
                err, tol = max_err(got, want), 0.0
            elif name == "log":
                err, tol = rel_err(got, want, 1 + want.abs().double()), 1e-5
            else:
                continue                      # ARITHMETIC: checked above
            expect(err <= tol, f"{name} {key} f32 (10^4, 10^4): err {err:.3g}"
                               f" <= {tol}")
    got = o["matvec int32 packed"]
    expect(torch.equal(got, (d["Ai"] * d["xi"][:, None]).sum(0, dtype=torch.int32)),
           "matvec int32 (10^6, 10) on K5: bit-exact against the library sum")
    flags8 = seg_k.offsets_to_flags(d["offs8"], N_PAPER)
    want = ref.ref_segmented_scan(alg.ADD, x8, flags8)
    expect(torch.equal(o["segmented scan"], want),
           f"Segmented scan ADD f32 n=1e+08, {d['offs8'].numel() - 1} "
           f"segments: bit-exact against the plain version")
    ends = d["offs8"][1:].long() - 1
    expect(torch.equal(o["segmented sums"], want[ends]),
           "Segmented mapreduce ADD f32 n=1e+08: every segment's sum exact")
    del want
    flags6 = seg_k.offsets_to_flags(d["offs6"], 10**6)
    err = max_err(o["segmented quaternion"], ref.ref_segmented_scan(
        alg.QUATERNION_MUL, d["q6"], flags6, inclusive=False))
    expect(err <= 1e-4, f"Segmented scan QUATERNION_MUL exclusive n=1e+06: "
                        f"max abs err {err:.3g} <= 1e-4")
    keys, vals = o["sort_pairs"]
    want = torch.sort(d["keys"], stable=True)
    expect(torch.equal(keys, want.values) and torch.equal(
        vals, want.indices.int()), "sort_pairs f32 n=1e+06: keys and payload "
                                   "bit-exact against torch.sort(stable=True)")
    plain = quickstart(d["qs"], backend="torch")
    for key, got in o["quickstart"].items():
        want = plain[key]
        gl = torch.utils._pytree.tree_leaves(got)
        wl = torch.utils._pytree.tree_leaves(want)
        same = all(g.shape == w.shape for g, w in zip(gl, wl))
        if all(not g.dtype.is_floating_point for g in gl) or key in (
                "4 tropical 4-hop", "1 scan max exclusive"):
            ok, msg = same and all(torch.equal(g, w) for g, w in zip(gl, wl)), \
                "bit-exact"
        else:
            scale = max(max(float(w.abs().max()) for w in wl), 1.0)
            err = max_err(got, want) / scale
            ok, msg = same and err <= 1e-4, \
                f"max abs err {err:.3g} <= 1e-4 x max|output|"
        expect(ok, f"quickstart {key}: cuda route against the torch route, "
                   f"{msg}")


def check_gemvs(o, d, per_call) -> None:
    """The matvec family's outputs against their plain versions on the
    card: ADD over TIMES within 1e-5 of sum |x||a| per output, MIN over
    PLUS bit-exact, the quantized results also within the integrated
    dequantization bound of the dense result; the reroute launched K7s and
    not K7m, and agrees with the torch route."""
    def close(got, want, scale, what):
        err = rel_err(got, want, scale + 1)
        expect(err <= 1e-5, f"{what}: err {err:.3g} <= 1e-5 of sum|x||a| "
                            f"per output")

    bm, bv = batched_k.batched_matvec_plain, batched_k.batched_vecmat_plain
    for shape, (A, xv, xz) in d["bmv"].items():
        close(o[f"batched matvec {shape}"], bm(alg.TIMES, alg.ADD, A, xv),
              gemv_scale(A, xv, True), f"Batched matvec f32 {shape}")
        close(o[f"batched vecmat {shape}"], bv(alg.TIMES, alg.ADD, A, xz),
              gemv_scale(A, xz, False), f"Batched vecmat f32 {shape}")
    A, xv, xz = d["bmv"][ATTN]
    for key, plain, x in (("matvec", bm, xv), ("vecmat", bv, xz)):
        expect(torch.equal(o[f"batched tropical {key}"],
                           plain(alg.PLUS, alg.MIN, A, x)),
               f"Batched TROPICAL_MIN_PLUS {key} {ATTN}: bit-exact")
    A, xv, xz = d["bmv_shear"]
    close(o["batched mat2 matvec"], bm(SHEAR, alg.MAT2_MUL, A, xv),
          gemv_scale(A, xv, True), "Batched MAT2_MUL matvec of shears "
                                   "(3, 1000, 64), in row order")
    close(o["batched mat2 vecmat"], bv(SHEAR_VM, alg.MAT2_MUL, A, xz),
          gemv_scale(A, xz, False), "Batched MAT2_MUL vecmat of shears "
                                    "(3, 1000, 64), in column order")
    h, v = d["unembed_x"]
    for mode, q in d["q_unembed"].items():
        deq = q.dequantize()
        for key, x, mv, plain, bound in (
                ("matvec", h, True, matvec_k.matvec_plain,
                 ref.ref_quantized_matvec_bound),
                ("vecmat", v, False, matvec_k.vecmat_plain,
                 ref.ref_quantized_vecmat_bound)):
            got = o[f"quantized {mode} {key} unembed"]
            scale = gemv_scale(deq, x, mv)
            close(got, plain(alg.TIMES, alg.ADD, deq, x), scale,
                  f"Quantized {mode} {key} {UNEMBED}")
            gap = (got.double() - plain(alg.TIMES, alg.ADD, d["W"], x)
                   .double()).abs()
            limit = bound(q, x).double() + 1e-5 * scale
            expect(bool((gap <= limit).all()),
                   f"Quantized {mode} {key} {UNEMBED}: within the "
                   f"dequantization bound of the dense f32 result (max gap "
                   f"{float(gap.max()):.3g})")
        del deq
    A4, xv, xz = d["mv"][(10**4, 10**4)]
    for mode, q in d["q_paper"].items():
        deq = q.dequantize()
        close(o[f"quantized {mode} matvec 1e4"],
              matvec_k.matvec_plain(alg.TIMES, alg.ADD, deq, xv),
              gemv_scale(deq, xv, True), f"Quantized {mode} matvec (1e4, 1e4)")
        close(o[f"quantized {mode} vecmat 1e4"],
              matvec_k.vecmat_plain(alg.TIMES, alg.ADD, deq, xz),
              gemv_scale(deq, xz, False),
              f"Quantized {mode} vecmat (1e4, 1e4)")
    expect(torch.equal(o["quantized int8 tropical matvec 1e4"],
                       matvec_k.matvec_plain(
                           alg.PLUS, alg.MIN,
                           d["q_paper"]["int8"].dequantize(), xv)),
           "Quantized int8 TROPICAL_MIN_PLUS matvec (1e4, 1e4): bit-exact")
    deq = d["qb"].dequantize()
    _, xv, xz = d["bmv"][BIG_BATCHED]
    close(o["quantized int8 batched matvec"], bm(alg.TIMES, alg.ADD, deq, xv),
          gemv_scale(deq, xv, True), f"Quantized int8 Batched matvec "
                                     f"{BIG_BATCHED}")
    close(o["quantized int8 batched vecmat"], bv(alg.TIMES, alg.ADD, deq, xz),
          gemv_scale(deq, xz, False), f"Quantized int8 Batched vecmat "
                                      f"{BIG_BATCHED}")
    del deq
    calls = per_call["reroute quaternion"]
    expect(calls.get("K7s", 0) >= 1 and "K7m" not in calls,
           f"mapreduce(quaternion_mul, Batched) (64, 65536) on the cuda route "
           f"launched {calls}: K7s, not K7m")
    got = o["reroute quaternion"]
    want = forge.mapreduce(alg.IDENTITY, alg.QUATERNION_MUL, d["quat64"],
                           layout=Batched(), backend="torch")
    err = max_err(got, want)
    expect(all(g.shape == (64,) and bool(torch.isfinite(g).all())
               for g in got) and err <= 1e-3,
           f"mapreduce(quaternion_mul, Batched) (64, 65536) unit quaternions:"
           f" finite (64,) leaves, max abs err {err:.3g} <= 1e-3 against the "
           f"torch route")


def check_new_kernels(res, d, gen, note) -> None:
    """K1, K5 and K8 against their plain versions at the path's shapes, and
    K4's ordered fold for an operator that does not commute."""
    x8 = d[f"x{N_PAPER}"]
    for nitem in copy_k.NITEMS:
        got = copy_k.copy_cuda(x8, nitem=nitem)
        err = max_err(got, copy_k.copy_plain(x8))
        note("K1", err)
        expect(err == 0, f"K1 copy f32 n=1e+08 nitem={nitem}: bit-exact")
    odd = torch.randint(0, 255, (10**6 + 7,), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.uint8)
    for t in (odd, odd[1:]):           # ragged end; misaligned start
        expect(torch.equal(copy_k.copy_cuda(t), t),
               f"K1 copy uint8 n={t.numel()} at byte offset "
               f"{t.data_ptr() % 16}: bit-exact")
    res["K1"].update(
        ms=time_ms(lambda: copy_k.copy_cuda(x8), 20),
        plain_ms=time_ms(lambda: copy_k.copy_plain(x8), 20),
        library_ms=time_ms(lambda: x8.clone(), 20),
        bound=bound_ms(2 * 4 * N_PAPER, 0), shape="(10^8,) f32, nitem 8",
        nitem_ms={n: time_ms(lambda: copy_k.copy_cuda(x8, nitem=n), 20)
                  for n in copy_k.NITEMS})

    A, xv, _ = d["mv"][(10**6, 10)]
    expect(matvec_k.uses_packed(10**6, 10, alg.ADD),
           "(10^6, 10) ADD takes K5 by the route choice")
    got = matvec_k.matvec_packed_cuda(alg.TIMES, alg.ADD, A, xv)
    err = rel_err(got, matvec_k.matvec_packed_plain(alg.TIMES, alg.ADD, A, xv),
                  (xv.abs()[:, None] * A.abs()).sum(0).double())
    note("K5", err)
    expect(err <= 1e-5, f"K5 ARITHMETIC f32 (10^6, 10): err {err:.3g} <= 1e-5"
                        f" x sum|x||A| per output")
    for n, p in ((10**6, 10), (512, 64), (600, 1), (1000, 33)):
        Ai = torch.randint(-9, 10, (n, p), generator=gen, device="cuda",
                           dtype=torch.int32)
        xi = torch.randint(-9, 10, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for op in (alg.ADD, alg.MAX, alg.MIN):
            err = max_err(matvec_k.matvec_packed_cuda(alg.TIMES, op, Ai, xi),
                          matvec_k.matvec_packed_plain(alg.TIMES, op, Ai, xi))
            note("K5", err)
            expect(err == 0, f"K5 times/{op.name} int32 ({n}, {p}): "
                             f"bit-exact")
    res["K5"].update(
        time_turns({
            "ms": lambda: matvec_k.matvec_packed_cuda(alg.TIMES, alg.ADD, A,
                                                      xv),
            "library_ms": lambda: torch.mv(A.t(), xv),
            "public_ms": lambda: forge.semiring_matvec(alg.ARITHMETIC, A,
                                                       xv),
            "k4_ms": lambda: matvec_k.matvec_cuda(alg.TIMES, alg.ADD, A,
                                                  xv)}),
        plain_ms=time_ms(lambda: matvec_k.matvec_packed_plain(
            alg.TIMES, alg.ADD, A, xv), 5),
        bound=bound_ms(4 * (10**6 * 10 + 10**6 + 10), 2 * 10**6 * 10),
        shape="(10^6, 10) f32 ARITHMETIC")

    flags8 = seg_k.offsets_to_flags(d["offs8"], N_PAPER)
    for inclusive in (True, False):
        got = seg_k.segmented_scan_1d_cuda(alg.ADD, x8, flags8,
                                           inclusive=inclusive)
        err = max_err(got, seg_k.segmented_scan_1d_plain(
            alg.ADD, x8, flags8, inclusive=inclusive))
        note("K8", err)
        expect(err == 0, f"K8 ADD f32 n=1e+08 inclusive={inclusive}: "
                         f"bit-exact against the plain version")
        del got
    for n in (1, 2047, 2048, 2049, 70001):
        v = torch.randint(-100, 100, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        fl = (torch.rand(n, generator=gen, device="cuda") < 0.01).int()
        for inclusive in (True, False):
            err = max_err(seg_k.segmented_scan_1d_cuda(alg.ADD, v, fl,
                                                       inclusive=inclusive),
                          seg_k.segmented_scan_1d_plain(alg.ADD, v, fl,
                                                        inclusive=inclusive))
            note("K8", err)
            expect(err == 0, f"K8 ADD int32 n={n} inclusive={inclusive}: "
                             f"bit-exact")
    flags6 = seg_k.offsets_to_flags(d["offs6"], 10**6)
    for inclusive in (True, False):
        err = max_err(seg_k.segmented_scan_1d_cuda(
            alg.QUATERNION_MUL, d["q6"], flags6, inclusive=inclusive),
            seg_k.segmented_scan_1d_plain(alg.QUATERNION_MUL, d["q6"], flags6,
                                          inclusive=inclusive))
        note("K8", err)
        expect(err <= 1e-4, f"K8 QUATERNION_MUL n=1e+06 inclusive="
                            f"{inclusive}: max abs err {err:.3g} <= 1e-4")
    res["K8"].update(
        ms=time_ms(lambda: seg_k.segmented_scan_1d_cuda(alg.ADD, x8, flags8),
                   20),
        plain_ms=time_ms(lambda: seg_k.segmented_scan_1d_plain(
            alg.ADD, x8, flags8), 1),
        library_ms=None,                # no PyTorch call scans by segment
        bound=bound_ms(2 * 4 * N_PAPER + 4 * N_PAPER, N_PAPER),
        shape=f"(10^8,) f32 ADD, {d['offs8'].numel() - 1} segments of mean "
              f"length {SEG_MEAN}")

    for n, p in ((700, 300), (300, 700), (5, 3)):
        Af = torch.empty(n, p, device="cuda").uniform_(0.9, 1.1, generator=gen)
        for k, fn, plain, x in (
                ("K4-matvec", matvec_k.matvec_cuda, matvec_k.matvec_plain, n),
                ("K4-vecmat", matvec_k.vecmat_cuda, matvec_k.vecmat_plain, p)):
            xf = torch.empty(x, device="cuda").uniform_(-0.1, 0.1,
                                                        generator=gen)
            got, want = fn(PAIR, alg.AFFINE, Af, xf), plain(PAIR, alg.AFFINE,
                                                            Af, xf)
            err = rel_err(got, want, 1 + want[1].abs().double())
            note(k, err)
            expect(err <= 1e-4, f"{k} AFFINE fold of (x, a) pairs ({n}, {p})"
                                f", in order: err {err:.3g} <= 1e-4")


def paper_timings(d, res) -> list:
    """The paper's tables through the public API: ms beside the bound and
    the library call (None where no single PyTorch call computes it).  The
    GEMV rows of Tables V and VI are timed in turns with torch.mv, and
    carry the launches and the GEMV form of one call by the wrappers'
    counters; the worst ratio of each kernel's rows goes to its entry of
    ``res`` ("paper_worst")."""
    rows = []

    def row(what, fn, nbytes, ops, library=None, lib_name=None, reps=10,
            turns=False):
        bound = bound_ms(nbytes, ops)
        if turns:
            before = read_counts()
            fn()
            after = read_counts()
            t = time_turns({"ms": fn, "library_ms": library}, reps=reps)
            rows.append({"what": what, **t, "ratio": t["ms"] / t["library_ms"],
                         "launches": {k: after[k] - before.get(k, 0) for k in after
                                      if after[k] != before.get(k, 0)}})
        else:
            rows.append({"what": what, "ms": time_ms(fn, reps),
                         "library_ms": time_ms(library, reps) if library
                         else None})
        rows[-1].update(bound_ms=bound[0], bound_by=bound[1], library=lib_name)
        log(f"[paper] {json.dumps(rows[-1])}")

    x8 = d[f"x{N_PAPER}"]
    row("copy f32 1e8 (Fig. 1)", lambda: forge.copy(x8), 8 * N_PAPER, 0,
        lambda: x8.clone(), "x.clone()")
    for n in SCAN_SIZES:
        x = d[f"x{n}"]
        row(f"scan ADD f32 {n:.0e} (Table IV)", lambda: forge.scan(alg.ADD, x),
            8 * n, n, lambda: torch.cumsum(x, 0), "torch.cumsum",
            3 if n > N_PAPER else 10, turns=True)
    row("scan ADD f64 1e8 (Table IV)", lambda: forge.scan(alg.ADD, d["x64"]),
        16 * N_PAPER, N_PAPER, lambda: torch.cumsum(d["x64"], 0),
        "torch.cumsum", turns=True)
    for r in rows[1:]:             # K2: one launch a call at every n
        expect(r["launches"] == {"K2": 1}, f"{r['what']}: one K2 launch a "
                                           f"call, {r['launches']}")
    row("scan QUATERNION_MUL f32 1e7", lambda: forge.scan(
        alg.QUATERNION_MUL, d["q7"]), 32 * 10**7, 28 * 10**7)
    row("mapreduce ADD f32 1e8 (Table III)", lambda: forge.mapreduce(
        alg.IDENTITY, alg.ADD, x8), 4 * N_PAPER, N_PAPER,
        lambda: torch.sum(x8), "torch.sum")
    row("mapreduce UnitFloat8 -> f32 ADD 1e8 (Table III)",
        lambda: forge.mapreduce(alg.unitfloat8_decode, alg.ADD, d["u8"]),
        N_PAPER, 3 * N_PAPER,
        lambda: torch.sum(alg.unitfloat8_decode(d["u8"])),
        "torch.sum(decode(u)), two calls")
    for (n, p), (A, xv, xz) in d["mv"].items():
        reps = 20 if n * p > 10**7 else 200
        row(f"matvec ARITHMETIC f32 ({n}, {p}) (Table V)",
            lambda: forge.semiring_matvec(alg.ARITHMETIC, A, xv),
            4 * (n * p + n + p), 2 * n * p, lambda: torch.mv(A.t(), xv),
            "torch.mv(A.t(), x)", reps, turns=True)
        row(f"vecmat ARITHMETIC f32 ({n}, {p}) (Table VI)",
            lambda: forge.semiring_vecmat(alg.ARITHMETIC, A, xz),
            4 * (n * p + n + p), 2 * n * p, lambda: torch.mv(A, xz),
            "torch.mv(A, x)", reps, turns=True)
    for r in rows:
        for k in ("K4-matvec", "K4-vecmat", "K5"):
            if r.get("launches", {}).get(k) and r["ratio"] > res[k].get(
                    "paper_worst", {}).get("ratio", 0):
                res[k]["paper_worst"] = {x: r[x] for x in (
                    "what", "ms", "library_ms", "ratio", "bound_ms")}
    A, xv, xz = d["mv"][(10**4, 10**4)]
    nb = 4 * (10**8 + 2 * 10**4)
    row("matvec TROPICAL_MIN_PLUS f32 (1e4, 1e4)",
        lambda: forge.semiring_matvec(alg.TROPICAL_MIN_PLUS, A, xv), nb,
        2 * 10**8, lambda: (xv[:, None] + A).amin(0),
        "(x[:, None] + A).amin(0), two calls")
    row("vecmat LOG_SEMIRING f32 (1e4, 1e4)",
        lambda: forge.semiring_vecmat(alg.LOG_SEMIRING, A, xz), nb,
        2 * 10**8, lambda: torch.logsumexp(A + xz[None], 1),
        "torch.logsumexp(A + x[None], 1), two calls")
    seg8 = Segmented(offsets=d["offs8"])
    row("Segmented scan ADD f32 1e8", lambda: forge.scan(
        alg.ADD, x8, layout=seg8), 12 * N_PAPER, N_PAPER)
    gemv_timings(d, row)
    return rows


def gemv_timings(d, row) -> None:
    """The matvec family's calls: ms beside the bound and the library call
    (dequantize-then-torch.mv for quantized operands, two calls), with the
    dense f32 library call at the same shape."""
    bat = Batched()
    for (B, n, p), (A, xv, xz) in d["bmv"].items():
        nb, ops = 4 * (B * n * p + B * n + B * p), 2 * B * n * p
        row(f"Batched matvec ARITHMETIC f32 {(B, n, p)}",
            lambda: forge.semiring_matvec(alg.ARITHMETIC, A, xv, layout=bat),
            nb, ops, lambda: torch.bmm(xv[:, None, :], A),
            "torch.bmm(x[:, None], A)")
        row(f"Batched vecmat ARITHMETIC f32 {(B, n, p)}",
            lambda: forge.semiring_vecmat(alg.ARITHMETIC, A, xz, layout=bat),
            nb, ops, lambda: torch.bmm(A, xz[:, :, None]),
            "torch.bmm(A, x[:, :, None])")
    B, n, p = ATTN
    A, xv, xz = d["bmv"][ATTN]
    row(f"Batched matvec TROPICAL_MIN_PLUS f32 {ATTN}",
        lambda: forge.semiring_matvec(alg.TROPICAL_MIN_PLUS, A, xv,
                                      layout=bat),
        4 * (B * n * p + B * n + B * p), 2 * B * n * p,
        lambda: (xv[:, :, None] + A).amin(1),
        "(x[:, :, None] + A).amin(1), two calls")
    h, v = d["unembed_x"]
    n, p = UNEMBED
    for mode, q in d["q_unembed"].items():
        row(f"Quantized {mode} matvec {UNEMBED} block {QUANT_BLOCK}",
            lambda: forge.matvec(alg.TIMES, alg.ADD, q, h),
            quant_bytes(n, p), QUANT_OPS[mode] * n * p,
            lambda: torch.mv(q.dequantize().t(), h),
            "torch.mv(q.dequantize().t(), x), two calls")
        row(f"Quantized {mode} vecmat {UNEMBED} block {QUANT_BLOCK}",
            lambda: forge.vecmat(alg.TIMES, alg.ADD, q, v),
            quant_bytes(n, p), QUANT_OPS[mode] * n * p,
            lambda: torch.mv(q.dequantize(), v),
            "torch.mv(q.dequantize(), x), two calls")
    row(f"dense f32 matvec {UNEMBED} (the library call alone)",
        lambda: torch.mv(d["W"].t(), h), 4 * (n * p + n + p), 2 * n * p)
    _, xv, xz = d["mv"][(10**4, 10**4)]
    for mode, q in d["q_paper"].items():
        row(f"Quantized {mode} matvec (1e4, 1e4) block {QUANT_BLOCK}",
            lambda: forge.semiring_matvec(alg.ARITHMETIC, q, xv),
            quant_bytes(10**4, 10**4), QUANT_OPS[mode] * 10**8,
            lambda: torch.mv(q.dequantize().t(), xv),
            "torch.mv(q.dequantize().t(), x), two calls")
        row(f"Quantized {mode} vecmat (1e4, 1e4) block {QUANT_BLOCK}",
            lambda: forge.semiring_vecmat(alg.ARITHMETIC, q, xz),
            quant_bytes(10**4, 10**4), QUANT_OPS[mode] * 10**8,
            lambda: torch.mv(q.dequantize(), xz),
            "torch.mv(q.dequantize(), x), two calls")
    B, n, p = BIG_BATCHED
    _, xv, xz = d["bmv"][BIG_BATCHED]
    qb = d["qb"]
    row(f"Quantized int8 Batched matvec {BIG_BATCHED} block {QUANT_BLOCK}",
        lambda: forge.matvec(alg.TIMES, alg.ADD, qb, xv, layout=bat),
        quant_bytes(n, p, B), QUANT_OPS["int8"] * B * n * p,
        lambda: torch.bmm(xv[:, None, :], qb.dequantize()),
        "torch.bmm(x[:, None], q.dequantize()), two calls")
    row(f"Quantized int8 Batched vecmat {BIG_BATCHED} block {QUANT_BLOCK}",
        lambda: forge.vecmat(alg.TIMES, alg.ADD, qb, xz, layout=bat),
        quant_bytes(n, p, B), QUANT_OPS["int8"] * B * n * p,
        lambda: torch.bmm(qb.dequantize(), xz[:, :, None]),
        "torch.bmm(q.dequantize(), x[:, :, None]), two calls")
    row("mapreduce QUATERNION_MUL Batched (64, 65536), rerouted to K7s",
        lambda: forge.mapreduce(alg.IDENTITY, alg.QUATERNION_MUL,
                                d["quat64"], layout=bat),
        16 * 64 * 65536 + 16 * 64, 28 * 64 * 65536)


def phase_primitives(res, gen) -> dict:
    def note(k, err):
        res[k]["max_abs_err"] = max(res[k]["max_abs_err"], err)

    d = primitives_data(gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    o, per_call = drive_primitives(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log("[primitives] launches per call: " + json.dumps(per_call))
    # Every GEMV wrapper call (K4, K5, K7's GEMVs, K9) is one launch.
    gemv_kernels = [k for k in COUNTERS if k.startswith(("K4", "K5", "K7-",
                                                         "K9"))]
    for name, calls in per_call.items():
        gemv = sum(v for k, v in calls.items() if k.startswith("GEMV "))
        wrapped = sum(calls.get(k, 0) for k in gemv_kernels)
        if gemv or wrapped:
            expect(gemv == wrapped, f"{name}: {wrapped} GEMV wrapper calls, "
                                    f"{gemv} launches")
    for k in PRIMITIVES_PATH:
        expect(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                                f"primitives path")
    check_primitives_path(o, d)
    check_gemvs(o, d, per_call)
    del o
    check_new_kernels(res, d, gen, note)
    rows = paper_timings(d, res)
    for k in ("K1", "K5", "K8"):          # K7 and K9: the kernels phase
        r = res[k]
        log(f"[kernels] {k} {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.6f} ms ({r['bound'][1]}); "
            f"{ {x: v for x, v in r.items() if x.endswith('_ms')} }")
    summary = {"wall_s": wall, "launches": launches, "paper": rows}
    log("[primitives] " + json.dumps({"wall_s": wall, "launches": launches}))
    return summary


# ---------------------------------------------------------------------------
# Phase 4: serve recurrentgemma-2b FULL
# ---------------------------------------------------------------------------


def param_count(cfg) -> int:
    """The parameters of a model of GQA or MLA blocks from its config
    alone.  A GQA block: wq, wk, wv, wo; q_norm and k_norm over head_dim
    with qk-norm.  An MLA block: w_dq (d x q_lora), q_norm, w_uq (q_lora x
    H (nope + rope)), w_dkv (d x (kv_lora + rope)), kv_norm, w_uk and w_uv
    (kv_lora x H nope, x H v), wo (H v x d).  Either: two norms, two more
    with post-norms; a dense MLP (w_in, w_out and, for swiglu / geglu,
    w_gate), or an MoE: the router (d x E) and its bias, E experts of
    moe_d_ff and the shared experts as one MLP n_shared_experts times as
    wide.  The embedding, an untied unembedding, the final norm, and an MTP
    head's proj (2d x d), block and three norms.  An encoder-decoder's
    ``dec_attn`` block holds a second GQA block's projections (cross
    attention) and a third norm; its encoder, ``n_enc_layers`` blocks of
    GQA, two norms and a dense MLP, and the encoder's final norm."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if cfg.use_mla:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nd, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        attn = (d * qr + qr + qr * H * (nd + rd) + d * (kvr + rd) + kvr
                + kvr * H * (nd + vd) + H * vd * d)
    else:
        attn = 2 * d * H * hd + 2 * d * K * hd + (2 * hd if cfg.qk_norm
                                                  else 0)
    norms = (4 if cfg.post_norm else 2) * d
    dense = mats * d * cfg.d_ff
    moe = (d * cfg.n_experts + cfg.n_experts
           + (cfg.n_experts + cfg.n_shared_experts) * mats * d * cfg.moe_d_ff)

    def block(kind):
        if kind == "dec_attn":
            return 2 * attn + norms + d + dense
        return attn + norms + (moe if kind.endswith("_moe") else dense)

    blocks = sum(block(kind) for kind in cfg.layer_pattern())
    if cfg.is_encdec:
        blocks += cfg.n_enc_layers * block("enc_attn") + d
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    mtp = 2 * d * d + block("dense") + 3 * d if cfg.mtp_depth else 0
    return blocks + embed + d + mtp


def load_model(name: str = "recurrentgemma-2b", tag: str = "serve",
               n_params_want=None, cut=None):
    """The model's bf16 weights from SEED and the prompts; ``n_params_want``
    (a function of the config), where given, must count the parameters;
    ``cut``: fields of the FULL config replaced (its depth)."""
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(name), **(cut or {}))
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = lm.count_params(params)
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params_want is not None:
        want = n_params_want(cfg)
        expect(n_params == want, f"{name}: {n_params} parameters, "
                                 f"{want} as its config counts them")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return cfg, params, prompts


def f32_floor(params, cfg, toks, logits_c, logits_t, **inputs) -> dict:
    """The two backends' bf16 prefill logits held against the same model
    in float32 activations (the bf16 weights upcast in each product), for
    a model whose bf16 rounding noise is large beside its logits.  In
    float32 (K10's CUDA-core body) the backends compute the same function:
    within 1e-3 of max|logit|.  In bf16 each backend is a rounding of that
    function; where the torch backend lies D from it, the two lie at most
    about 2 D apart (|c - t| <= |c - f| + |f - t|, both terms bf16 noise of
    one size): the cuda backend's K10 adds no error of its own.
    ``inputs``: the prefill's other inputs (an encoder's ``src_embeds``)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    c32, _ = lm.prefill(params, cfg32, toks, cache_len=CACHE_LEN, **inputs)
    with ki.use_backend("torch"):
        f, _ = lm.prefill(params, cfg32, toks, cache_len=CACHE_LEN, **inputs)
    return hold_floor(f"prefill T={toks.shape[1]}", toks.shape[1], logits_c,
                      logits_t, c32, f)


def hold_floor(what, tokens, logits_c, logits_t, c32, f) -> dict:
    """f32_floor's two checks: the float32 runs ``c32`` (cuda backend) and
    ``f`` (torch) within 1e-3 of max|f|, and the bf16 runs ``logits_c``
    and ``logits_t`` within twice the torch backend's distance from f."""
    out = {"tokens": tokens, "max_logit_f32": float(f.abs().max()),
           "f32_cuda_vs_torch": float((c32 - f).abs().max()),
           "cuda_vs_f32": float((logits_c - f).abs().max()),
           "torch_vs_f32": float((logits_t - f).abs().max()),
           "cuda_vs_torch": float((logits_c - logits_t).abs().max())}
    expect(out["f32_cuda_vs_torch"] <= 1e-3 * out["max_logit_f32"],
           f"{what} in float32 activations: cuda vs torch backend "
           f"max abs err {out['f32_cuda_vs_torch']:.4g} <= 1e-3 x "
           f"max|logit| {out['max_logit_f32']:.4g}")
    expect(out["cuda_vs_torch"] <= 2 * out["torch_vs_f32"],
           f"{what} in bf16: cuda vs torch backend max abs err "
           f"{out['cuda_vs_torch']:.4g} <= 2 x the torch backend's own "
           f"error against float32 activations, {out['torch_vs_f32']:.4g} "
           f"(the cuda backend's {out['cuda_vs_f32']:.4g}); argmax "
           f"{int(logits_c.argmax())} vs {int(logits_t.argmax())} (float32 "
           f"{int(f.argmax())})")
    return out


def phase_serve(cfg, params, prompts, path=GREEDY_PATH,
                tag="serve", floor=False, buckets=None) -> dict:
    """``floor``: hold the backends' prefill logits to the float32 floor
    (f32_floor) instead of 2e-2 of their magnitude; ``buckets``: serve the
    requests again with ``Engine(prefill_buckets=buckets)``, whose streams
    must be the exact-length run's (serve_bucketed).  The summary's
    ``outs`` (not logged) holds the streams."""
    dev = torch.device("cuda")
    memory = {"weights_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()

    # The cuda backend (K10 attention) against the plain torch backend
    # (blockwise attention) on the card, at 17, 1,024 and 2,100 tokens (the
    # last past recurrentgemma's window).  bf16 activations round the
    # recurrence's and the attention's f32 outputs, so one ulp of f32
    # difference can flip a bf16 rounding and move through every layer:
    # held at 2e-2 of the logits' magnitude, or to the float32 floor.
    routes = []
    for p in (prompts[0], prompts[4], prompts[6]):
        toks = torch.tensor([p], dtype=torch.int64, device=dev)
        logits_c, _ = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
        with ki.use_backend("torch"):
            logits_t, _ = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
        expect(bool(torch.isfinite(logits_c).all()) and tuple(
            logits_c.shape) == (1, cfg.vocab_size),
            f"prefill T={len(p)}: finite logits of shape (1, {cfg.vocab_size})")
        err = float((logits_c - logits_t).abs().max())
        scale = float(logits_t.abs().max())
        if floor:
            routes.append(f32_floor(params, cfg, toks, logits_c, logits_t))
        else:
            expect(err <= 2e-2 * scale,
                   f"prefill T={len(p)}: cuda vs torch backend max abs err "
                   f"{err:.4g} <= 2e-2 x max|logit| {scale:.4g}; argmax "
                   f"{int(logits_c.argmax())} vs {int(logits_t.argmax())}")
            routes.append({"tokens": len(p), "cuda_vs_torch": err,
                           "max_logit": scale})
        del logits_c, logits_t
    memory["peak_prefill_checks_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    eng = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=BATCH,
                 device=dev)
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, m in zip(prompts, MAX_NEW)]
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stats = eng.last_stats
    memory["peak_generate_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for i, (o, r) in enumerate(zip(outs, reqs)):
        expect(len(o) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in o),
            f"request {i} (prompt {len(r.prompt)}): {len(o)} tokens == "
            f"max_new_tokens {r.max_new_tokens}, ids in the vocabulary")
    for k in path:
        expect(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                                f"{tag} path")
    expect(launches["K3 small"] == launches["K3"],
           f"all {launches['K3']} K3 launches of the {tag} path (the "
           f"decode loop's all-done predicate over {BATCH} slots) took the "
           f"small form")
    attn_layers = sum(kind in BK._ATTN_KINDS + BK._MLA_KINDS
                      for kind in cfg.layer_pattern())
    expect(launches["K10"] >= attn_layers * len(reqs),
           f"K10 launched {launches['K10']} times: at least once in each of "
           f"the {attn_layers} attention layers of {len(reqs)} prefills")
    profile = profile_serving(eng, params, cfg, prompts[4])
    if profile["prefill"]["measured"]:
        log(f"[{tag}] prefill T={PROMPT_LENS[4]}: {profile['prefill']['device_ms']:.3f} "
            f"device ms, K6 {profile['prefill']['k6_ms']:.4f} ms and K6-long "
            f"{profile['prefill']['k6_long_ms']:.4f} ms of it")
    memory["peak_generate_profile_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    prompt_tokens = sum(PROMPT_LENS)
    summary = {
        "model": cfg.name, "requests": len(reqs), "slots": BATCH,
        "cache_len": CACHE_LEN, "prompt_tokens": prompt_tokens,
        "generated_tokens": stats["total_tokens"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "serve_s": wall,
        "prefill_tok_per_s": prompt_tokens / stats["prefill_s"],
        "decode_tok_per_s": stats["decode_tok_per_s"],
        "decode_steps": stats["decode_steps"],
        "loop_dispatches": stats["loop_dispatches"],
        "launches": launches,
        "memory": memory,
        "profile": profile,
        "routes": routes,
        "streams": streams_digest(outs),
    }
    log(f"[{tag}] " + json.dumps(summary))
    if buckets is not None:
        summary["bucketed"] = serve_bucketed(cfg, params, reqs, buckets, tag,
                                             summary["streams"])
    summary["outs"] = outs
    return summary


def serve_bucketed(cfg, params, reqs, buckets, tag, digest) -> dict:
    """The phase's requests through ``Engine(prefill_buckets=buckets)``:
    each prompt right-padded to its bucket and read at its own length
    (``valid_len``).  The streams must be the exact-length run's."""
    eng = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=BATCH,
                 device="cuda", prefill_buckets=buckets)
    plen = [len(r.prompt) for r in reqs]
    padded = [len(eng._pad_prompt(r.prompt)[0][0]) for r in reqs]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.last_stats
    out = {"buckets": list(eng.prefill_buckets), "prompt_tokens": plen,
           "prefilled_tokens": padded, "prefill_s": stats["prefill_s"],
           "decode_s": stats["decode_s"], "serve_s": wall,
           "decode_tok_per_s": stats["decode_tok_per_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": read_counts(), "streams": streams_digest(outs)}
    log(f"[{tag} bucketed] " + json.dumps(out))
    expect(out["streams"] == digest,
           f"{tag}: the bucketed run (prompts of {plen} tokens prefilled at "
           f"{padded}) gives the exact-length run's streams, digest "
           f"{digest}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: serve xlstm-1.3b FULL
# ---------------------------------------------------------------------------


def xlstm_param_count(cfg) -> int:
    """xLSTM's parameters from its config alone.  An mLSTM block: the up
    and gate projections (d x 2d each), the conv (width x 2d and a bias),
    q, k and v (H blocks of dh^2 each), the input and forget gates (d x H
    and H each), the down projection (2d x d), the skip scale (2d), a norm.
    An sLSTM block: w_in (d x 4d), r (4 gates of H blocks of p^2), the gate
    bias (4 d), w_out (d x d), the gelu ffn (d x ff twice), a norm.  The
    tied embedding and the final norm."""
    d, H = cfg.d_model, cfg.n_heads
    inner = 2 * d
    ff = int(d * 4 / 3 / 64) * 64 or 64
    mlstm = (3 * d * inner + cfg.conv_width * inner + inner
             + 3 * inner * inner // H + 2 * (d * H + H) + inner + d)
    slstm = 4 * d * d + 4 * d * d // H + 4 * d + d * d + 2 * d * ff + d
    return sum(mlstm if kind == "mlstm" else slstm
               for kind in cfg.layer_pattern()) + cfg.vocab_size * d + d


def layer_divergence(params, cfg, prompt) -> dict:
    """Where the cuda and torch backends' prefills of ``prompt`` part, layer
    by layer.  Each block runs on both backends from the torch backend's
    input (``own``: the layer's own difference) and on the cuda backend
    from its own carried input (``carried``), each as max|difference| /
    max|torch output| with the share of elements that differ at all (the
    activations are bf16, so any difference is a flipped rounding of at
    least one bf16 step)."""
    prefix, unit, n_units, suffix = lm._dec_spec(cfg)
    dec = params["decoder"]
    layers = [*zip(prefix, dec["prefix"]),
              *[(k, u[j]) for u in dec["units"] for j, k in enumerate(unit)],
              *zip(suffix, dec["suffix"])]
    toks = torch.tensor([prompt], dtype=torch.int64,
                        device=params["embed"]["embedding"].device)
    h_t = L.embed(params["embed"], toks, cfg.embed_scale,
                  cfg.activation_dtype)
    h_c, rows = h_t, []
    for i, (kind, p) in enumerate(layers):
        def run(x):
            return BK.block_forward(p, kind, cfg, x, mode="train")[0]
        with ki.use_backend("torch"):
            nxt_t = run(h_t)
        own_c, h_c = run(h_t), run(h_c)
        scale = float(nxt_t.float().abs().max())
        rows.append({
            "layer": i, "kind": kind,
            "own": float((own_c.float() - nxt_t.float()).abs().max()) / scale,
            "own_differ": float((own_c != nxt_t).float().mean()),
            "carried": float((h_c.float() - nxt_t.float()).abs().max())
            / scale,
            "carried_differ": float((h_c != nxt_t).float().mean())})
        h_t = nxt_t
    first = [r["layer"] for r in rows if r["own_differ"] > 0]
    out = {"tokens": len(prompt), "first_own": first[0] if first else None,
           "worst_own": max(rows, key=lambda r: r["own"]), "layers": rows}
    log(f"[xlstm] layer divergence, prefill T={len(prompt)}: "
        + json.dumps(out))
    return out


def phase_xlstm() -> dict:
    """xlstm-1.3b FULL after gemma2's tensors are gone: 3.81 GB of bf16
    weights and four slots of float32 mLSTM state (0.7 GB a slot)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[xlstm] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before loading")
    cfg, params, prompts = load_model("xlstm-1.3b", "xlstm",
                                      xlstm_param_count)
    expect(lm.count_params(params) == XLSTM_PARAMS,
           f"xlstm-1.3b: {XLSTM_PARAMS} parameters, as the reference's tree")
    summary = phase_serve(cfg, params, prompts, XLSTM_PATH, "xlstm",
                          buckets=XLSTM_BUCKETS)
    # The sLSTM layers' loops over the profiled prefill's steps, a cell of
    # some twenty launches a step: host time, under the profiler.
    loop = summary["profile"]["prefill"]["ranges"].get("slstm loop", {})
    layers = sum(kind == "slstm" for kind in cfg.layer_pattern())
    expect(loop.get("count") == layers,
           f"the profiled prefill T={PROMPT_LENS[4]} ran the sLSTM loop "
           f"{loop.get('count')} times, once in each of its {layers} layers")
    summary["slstm"] = {
        "tokens": PROMPT_LENS[4], "slstm_layers": layers,
        "slstm_s": loop["host_ms"] / 1e3,
        "slstm_us_per_step": loop["host_ms"] * 1e3 / layers / PROMPT_LENS[4]}
    log(f"[xlstm] sLSTM loop, prefill T={PROMPT_LENS[4]}, under the "
        f"profiler: " + json.dumps(summary["slstm"]))
    summary["divergence"] = layer_divergence(params, cfg, prompts[4])
    summary["phase_s"] = time.perf_counter() - t0
    log(f"[xlstm] phase 7 took {summary['phase_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phases 6 and 8-10: serve gemma2-27b, then gemma3-4b, minitron-4b and
# moonshot-v1-16b-a3b FULL
# ---------------------------------------------------------------------------

# (config, tag, parameters by the reference's tree): gemma3-4b's qk-norm
# and 5 local : 1 global layers at head_dim 256, minitron-4b's relu2 MLP and
# untied 256,000 x 3,072 unembedding, moonshot-v1-16b-a3b's MoE (64 experts
# top-6 and 2 shared on 47 of its 48 layers, a sigmoid router).  Each runs
# GEMMA2_PATH: attention and MLPs, no recurrence.
MODELS = (("gemma3-4b", "gemma3", 3_880_099_328),
          ("minitron-4b", "minitron", 4_190_309_376),
          ("moonshot-v1-16b-a3b", "moonshot", 28_386_595_776))


def expert_choices(params, cfg, toks, backend) -> list:
    """Each MoE layer's selected experts for every token of one prefill on
    ``backend``, in ascending id, by a recording wrapper around the
    router's ``route`` for the length of the call."""
    seen, route = [], moe_m.route

    def recording(p, c, xf):
        out = route(p, c, xf)
        seen.append(out[3].sort(dim=1)[0])
        return out

    moe_m.route = recording
    try:
        with ki.use_backend(backend):
            lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
    finally:
        moe_m.route = route
    return seen


def moe_checks(params, cfg, prompts, tag) -> dict:
    """Two prefills of one prompt on the cuda route give the same logits
    to the bit (each token's experts summed in a fixed order, no atomics);
    and how many tokens of each prompt choose other experts in some MoE
    layer on the cuda route than on the torch one (the router runs in
    float32 on inputs that K10 and blockwise attention round apart)."""
    out = {"repeat": {}, "expert_choices": {}}
    for p in (prompts[4], prompts[6]):
        toks = torch.tensor([p], dtype=torch.int64, device="cuda")
        a, _ = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
        b, _ = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
        expect(torch.equal(a, b), f"{tag} prefill T={len(p)}: two runs "
                                  f"give bit-identical logits")
        out["repeat"][len(p)] = True
        del a, b
    for p in (prompts[0], prompts[4], prompts[6]):
        toks = torch.tensor([p], dtype=torch.int64, device="cuda")
        cuda = expert_choices(params, cfg, toks, "cuda")
        plain = expert_choices(params, cfg, toks, "torch")
        expect(len(cuda) == len(plain) == cfg.n_units,
               f"{tag} prefill T={len(p)}: {len(cuda)} MoE layers "
               f"routed on each route")
        differ = [(c != t).any(dim=1) for c, t in zip(cuda, plain)]
        per_layer = [int(d.sum()) for d in differ]
        out["expert_choices"][len(p)] = {
            "tokens": len(p), "moe_layers": len(per_layer),
            "tokens_differ_any_layer": int(torch.stack(differ).any(0).sum()),
            "layers_with_a_difference": sum(n > 0 for n in per_layer),
            "first_layer": next((i for i, n in enumerate(per_layer) if n),
                                None),
            "max_tokens_in_a_layer": max(per_layer),
            "per_layer": per_layer}
    log(f"[{tag}] " + json.dumps(out))
    return out


def phase_model(name: str, tag: str, n_params: int,
                floor: bool = True, buckets=None, after=None) -> dict:
    """A model of GQA blocks at full width after the previous phase's
    tensors are gone (gemma2-27b: 54.4 GB of bf16 weights and 6.2 GB of
    caches on the 80 GB card), served as phase_serve does; ``floor``: its
    backends' logits held to the float32 floor (f32_floor); ``buckets``:
    phase_serve's bucketed run; ``after(cfg, params, prompts, summary)``,
    where given, runs while the weights are loaded, its result the
    summary's ``after``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before loading")
    cfg, params, prompts = load_model(name, tag, param_count)
    expect(lm.count_params(params) == n_params,
           f"{name}: {n_params} parameters, as the reference's tree")
    summary = phase_serve(cfg, params, prompts, GEMMA2_PATH, tag, floor,
                          buckets)
    if after is not None:
        summary["after"] = after(cfg, params, prompts, summary)
    if cfg.n_experts:
        summary["moe"] = moe_checks(params, cfg, prompts, tag)
    summary["phase_s"] = time.perf_counter() - t0
    log(f"[{tag}] phase took {summary['phase_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 13: the decoding strategies and quantized caches on gemma2-27b
# ---------------------------------------------------------------------------


class _Profiled(Exception):
    """Raised out of a serve once its first loop iteration is profiled."""


def device_busy(fn, kernels=None) -> dict:
    """Run ``fn`` under torch.profiler's device activity alone and sum the
    device events' time straight from its raw results (a speculative round
    launches some 60,000 operations, which the parsed event list of
    profile_device takes minutes to build): the device ms, the wall ms and
    the idle share; with ``kernels`` (label -> a test of an event's name),
    each label's device ms and event count too ("kernel_ms")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ns, ops = 0, 0
    by = {k: [0, 0] for k in kernels or ()}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns = e.duration_ns() if hasattr(e, "duration_ns") \
                else e.duration_us() * 1000
            busy_ns += ns
            ops += 1
            for k, test in (kernels or {}).items():
                if test(e.name()):
                    by[k][0] += ns
                    by[k][1] += 1
    if not ops:
        return {"measured": False, "wall_ms": wall_ms}
    out = {"measured": True, "device_ms": busy_ns / 1e6, "wall_ms": wall_ms,
           "device_idle_share": 1.0 - busy_ns / 1e6 / wall_ms,
           "device_ops": ops}
    if kernels:
        out["kernel_ms"] = {k: {"device_ms": ns / 1e6, "events": n}
                            for k, (ns, n) in by.items()}
    return out


def profile_iteration(eng, reqs) -> dict:
    """Device ms of one loop iteration (a decode step, or a speculative or
    beam round) with the engine's slots full: serve ``reqs`` again, profile
    its first iteration (device_busy) and stop the serve there."""
    real, box = eng._dispatch_loop, {}

    def first(state, budget, stop_on_free):
        box.update(device_busy(lambda: real(state, 1, stop_on_free)))
        raise _Profiled

    eng._dispatch_loop = first
    try:
        eng.serve([(0, r) for r in reqs[:eng.batch_size]])
    except _Profiled:
        pass
    finally:
        eng._dispatch_loop = real
    return box


def strategy_run(label, eng, reqs, path):
    """One serve of ``reqs`` (all arriving at step 0) through ``eng``: its
    records, and a summary with the kernels' launches (each of ``path``
    must launch), the peak device memory (under 80 GB), the decode rate,
    and (profile_iteration, after the timed serve) the device ms of one
    loop iteration with the slots full."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    recs = eng.serve([(0, r) for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stats = dict(eng.last_stats)
    outs = [rec.tokens for rec in recs]
    summary = {
        "run": label, "strategy": eng.strategy.name,
        "quantize_kv": eng.quantize_kv, "requests": len(reqs),
        "slots": eng.batch_size, "cache_len": eng.cache_len,
        "generated_tokens": stats["total_tokens"],
        "decode_steps": stats["decode_steps"],
        "loop_dispatches": stats["loop_dispatches"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "serve_s": wall, "decode_tok_per_s": stats["decode_tok_per_s"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "streams": streams_digest(outs),
        "heads": [o[:6] for o in outs[:3]],
        **{k: v for k, v in stats.items() if k.startswith("spec_")}}
    summary["iteration"] = profile_iteration(eng, reqs)
    summary["peak_gb"] = max(summary["peak_gb"],
                             torch.cuda.max_memory_allocated() / 1e9)
    log("[strategies] " + json.dumps(summary))
    for i, (o, r) in enumerate(zip(outs, reqs)):
        expect(0 < len(o) <= r.max_new_tokens and all(
            0 <= t < eng.cfg.vocab_size for t in o),
            f"{label} request {i}: {len(o)} tokens of at most "
            f"{r.max_new_tokens}, ids in the vocabulary")
    for k in path:
        expect(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                                f"{label} path")
    expect(summary["peak_gb"] < 80,
           f"{label}: peak device memory {summary['peak_gb']:.2f} GB < 80")
    return summary, recs


def dfa_tables(vocab: int, seed: int = SEED):
    """A seeded DFA over the vocabulary: each state allows about
    DFA_DENSITY of it (token 0 always: no dead state)."""
    rng = np.random.default_rng(seed)
    allowed = rng.random((DFA_STATES, vocab)) < DFA_DENSITY
    allowed[:, 0] = True
    trans = rng.integers(0, DFA_STATES, (DFA_STATES, vocab)).astype(np.int32)
    return allowed, trans


def phase_strategies(cfg, params, prompts, gemma2) -> dict:
    """Speculative, beam and constrained decoding and quantized KV caches
    on gemma2-27b's FULL weights, still loaded after its serve phase."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    runs = {}

    def engine(batch=BATCH, cache_len=CACHE_LEN, **kw):
        return Engine(cfg, params, cache_len=cache_len, batch_size=batch,
                      device=dev, **kw)

    new = [min(m, STRATEGY_NEW) for m in MAX_NEW]
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, new)]
    # Greedy streams are batch-independent: the gemma2 phase's, cut to 16.
    want = [o[:m] for o, m in zip(gemma2["outs"], new)]

    # Speculative: the target as its own draft (shared tensors), then
    # recurrentgemma-2b FULL from the seed as the draft.
    s, recs = strategy_run("speculative", engine(
        strategy=ST.Speculative(cfg, params, k=SPEC_K)), reqs, SPEC_PATH)
    expect([r.tokens for r in recs] == want,
           f"speculative (k = {SPEC_K}, the target as its draft): the "
           f"vanilla streams, digest {streams_digest(want)}")
    expect(s["spec_acceptance_rate"] == 1.0,
           f"the perfect draft's acceptance {s['spec_acceptance_rate']} "
           f"== 1.0 ({s['spec_accepted']} of {s['spec_proposed']} in "
           f"{s['spec_rounds']} rounds)")
    runs["speculative"] = s
    dcfg = get_config("recurrentgemma-2b")
    dparams = lm.init_params(dcfg, seed=SEED, device=dev,
                             dtype=torch.bfloat16)
    s, recs = strategy_run("speculative_draft", engine(
        strategy=ST.Speculative(dcfg, dparams, k=SPEC_K)), reqs, SPEC_PATH)
    expect([r.tokens for r in recs] == want,
           f"speculative (k = {SPEC_K}, recurrentgemma-2b's draft, "
           f"acceptance {s['spec_acceptance_rate']:.4f}): the vanilla "
           f"streams, digest {streams_digest(want)}")
    runs["speculative_draft"] = s

    # Sampled over the full vocabulary, recurrentgemma-2b's draft: the
    # first four prompts.  The draft samples from its own key stream, so
    # proposals are rejected and the rollback runs.
    sreqs = [Request(prompt=p, max_new_tokens=SPEC_SAMPLED_NEW, seed=i)
             for i, p in enumerate(prompts[:BATCH])]
    van = engine(**FULL_VOCAB).generate(sreqs)
    s, recs = strategy_run("speculative_sampled", engine(
        strategy=ST.Speculative(dcfg, dparams, k=SPEC_K), **FULL_VOCAB),
        sreqs, SPEC_PATH)
    expect([r.tokens for r in recs] == van,
           f"sampled speculative (recurrentgemma-2b's draft, acceptance "
           f"{s['spec_acceptance_rate']:.4f}): vanilla's sampled streams at "
           f"the same seeds, digest {streams_digest(van)}")
    expect(s["spec_accepted"] < s["spec_proposed"],
           f"sampled speculative: {s['spec_proposed'] - s['spec_accepted']} "
           f"of {s['spec_proposed']} proposals rejected and rolled back")
    runs["speculative_sampled"] = s
    del dparams, recs

    # Beam search: two requests, width 4, over 2 slots of 2,048.
    breqs = [Request(prompt=prompts[i], max_new_tokens=STRATEGY_NEW)
             for i in (0, 4)]
    beng = engine(batch=BEAM_BATCH, cache_len=BEAM_CACHE,
                  strategy=ST.BeamSearch(width=BEAM_WIDTH))
    s, recs = strategy_run("beam", beng, breqs, BEAM_PATH)
    torch.cuda.reset_peak_memory_stats()
    for r, rec in zip(breqs, recs):
        toks, score = reference_beam(beng, r.prompt, width=BEAM_WIDTH,
                                     max_new=r.max_new_tokens)
        expect(rec.tokens == toks and rec.seq_logprob == score,
               f"beam (width {BEAM_WIDTH}, prompt {len(r.prompt)}): "
               f"{len(rec.tokens)} tokens, score {rec.seq_logprob:.6f}, the "
               f"oracle's {len(toks)} tokens and {score:.6f}")
    s["oracle_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    s["scores"] = [rec.seq_logprob for rec in recs]
    runs["beam"] = s
    del beng, recs

    # Constrained (greedy): a 3-state DFA allowing 1% of the vocabulary.
    allowed, trans = dfa_tables(cfg.vocab_size)
    creqs = reqs[:BATCH]
    ceng = engine(strategy=ST.Constrained(allowed, trans))
    s, recs = strategy_run("constrained", ceng, creqs, GEMMA2_PATH)
    for r, rec in zip(creqs, recs):
        state, masked = 0, 0
        for t in rec.tokens:
            masked += not allowed[state, t]
            state = trans[state, t]
        toks, _ = reference_constrained(
            ceng, r.prompt, 0, allowed=allowed, transitions=trans,
            max_new=r.max_new_tokens)
        expect(masked == 0 and rec.tokens == toks,
               f"constrained (prompt {len(r.prompt)}): {masked} masked ids "
               f"in {len(rec.tokens)}, the oracle's stream")
    s["allowed_per_state"] = allowed.sum(axis=1).tolist()
    runs["constrained"] = s
    del ceng, recs

    # Quantized KV with poisoned evictions, sampled over the full
    # vocabulary: 8 requests through 4 slots; each request served in a
    # recycled slot against a fresh engine.
    qreqs = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     seed=i) for i, r in enumerate(reqs)]
    for mode in ("int8", "fp8_e4m3"):
        s, recs = strategy_run(f"quantized_{mode}", engine(
            quantize_kv=mode, poison_on_evict=True, **FULL_VOCAB), qreqs,
            GEMMA2_PATH)
        recycled = [i for i, rec in enumerate(recs) if rec.admit_step > 0]
        fresh = engine(quantize_kv=mode, **FULL_VOCAB).generate(
            [qreqs[i] for i in recycled])
        expect(len(recycled) >= BATCH and all(
            recs[i].tokens == f for i, f in zip(recycled, fresh)),
            f"quantize_kv={mode}: the {len(recycled)} requests served in "
            f"recycled, poisoned slots give a fresh engine's streams")
        s["recycled"] = recycled
        runs[f"quantized_{mode}"] = s
    out = {"runs": runs, "phase_s": time.perf_counter() - t0}
    log(f"[strategies] phase 13 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: serve deepseek-v3-671b at full width, 4 of its 61 layers
# ---------------------------------------------------------------------------

# Every published width, cut to its 3 mla_dense layers and 1 mla_moe layer
# (256 experts top-8, one shared, a sigmoid router): 61 layers do not fit
# one card.  The MTP head is in the tree (686,265,344 parameters), and
# serving never runs it.
DEEPSEEK_CUT = dict(n_layers=4, n_units=1)
DEEPSEEK_PARAMS = 15_797_367_040


def check_latent_caches(cfg, params) -> dict:
    """The engine's zeroed caches: per MLA layer the latent ``ckv`` (slots,
    cache_len, kv_lora_rank) and ``krope`` (slots, cache_len,
    qk_rope_head_dim) in bf16, nothing else."""
    eng = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=BATCH,
                 device="cuda")
    caches = eng._fresh_state()["caches"]
    layers = [*caches["prefix"], *[c for u in caches["units"] for c in u],
              *caches["suffix"]]
    want = {"ckv": (BATCH, CACHE_LEN, cfg.kv_lora_rank),
            "krope": (BATCH, CACHE_LEN, cfg.qk_rope_head_dim)}
    for i, c in enumerate(layers):
        got = {k: tuple(t.shape) for k, t in c.items()}
        expect(got == want and all(t.dtype == BF16 for t in c.values()),
               f"deepseek layer {i}: latent cache {got} bf16, want {want}")
    per_layer = sum(t.numel() * t.element_size() for t in layers[0].values())
    out = {"layers": len(layers), "shapes": want, "bytes_per_layer": per_layer}
    log("[deepseek] latent caches " + json.dumps(out))
    del eng, caches, layers
    return out


def phase_deepseek() -> dict:
    """deepseek-v3-671b at every published width, 4 of its 61 layers,
    after moonshot's tensors are gone (31.59 GB of bf16 weights), served
    as phase_serve does with moonshot's MoE checks.  K10 runs each MLA
    layer's prefill attention at q/k 192 and v 128: once per layer of a
    prefill, in the (bf16, 192, 128) unit."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[deepseek] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before loading")
    cfg, params, prompts = load_model("deepseek-v3-671b", "deepseek",
                                      param_count, DEEPSEEK_CUT)
    expect(lm.count_params(params) == DEEPSEEK_PARAMS,
           f"deepseek-v3-671b cut to {cfg.n_layers} layers: "
           f"{DEEPSEEK_PARAMS} parameters, as the reference's tree")
    latent = check_latent_caches(cfg, params)
    mla_layers = sum(k in BK._MLA_KINDS for k in cfg.layer_pattern())
    unit = flash_k.flash_unit(BF16, cfg.qk_nope_head_dim
                              + cfg.qk_rope_head_dim, "deepseek",
                              cfg.v_head_dim)
    toks = torch.tensor([prompts[4]], dtype=torch.int64, device="cuda")
    reset_counts()
    lm.prefill(params, cfg, toks, cache_len=CACHE_LEN)
    torch.cuda.synchronize()
    k10 = read_counts()["K10"]
    expect(k10 == mla_layers == flash_k.unit_launches.get(unit.label),
           f"deepseek prefill T={len(prompts[4])}: K10 launched {k10} times, "
           f"once in each of its {mla_layers} MLA layers, in the "
           f"{unit.label} unit")
    summary = phase_serve(cfg, params, prompts, GEMMA2_PATH, "deepseek",
                          floor=True)
    summary["moe"] = moe_checks(params, cfg, prompts, "deepseek")
    summary["latent_caches"] = latent
    summary["k10_per_prefill"] = {"launches": k10, "unit": unit.label}
    summary["phase_s"] = time.perf_counter() - t0
    log(f"[deepseek] phase 11 took {summary['phase_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 12: serve seamless-m4t-medium, the encoder-decoder, at full width
# and depth
# ---------------------------------------------------------------------------

SEAMLESS_PARAMS = 614_739_968
SEAMLESS_PATH = ("K7m", "K10")    # the padded path: no loop predicate (K3)
# (decoder prompt, source frames) of the direct checks: equal lengths as the
# engine's prefill, and a short prompt over a long source.
SEAMLESS_CHECKS = ((17, 17), (1024, 1024), (2100, 2100), (64, 2100))
SEAMLESS_DECODE = 4               # decode steps held after a prefill


def seamless_source(gen, cfg, T) -> torch.Tensor:
    """A real source, 0.1 N(0, 1) frames (1, T, d_model) in float32, as
    the reference's tests draw one: the engine's own source is all zeros,
    which makes the encoder's output and every cross attention exactly
    zero (the encoder has no biases)."""
    return 0.1 * torch.randn(1, T, cfg.d_model, generator=gen,
                             device="cuda")


def prefill_and_decode(params, cfg, toks, src, steps, backend):
    """One prefill over ``src`` and ``steps`` decode steps at one position
    for the batch (the padded path's), fed ``toks``' next tokens; every
    step's logits, on ``backend``."""
    S = toks.shape[1] - steps
    with ki.use_backend(backend):
        logits, caches = lm.prefill(params, cfg, toks[:, :S],
                                    cache_len=CACHE_LEN, src_embeds=src)
        out = [logits]
        for t in range(steps):
            logits, caches = lm.decode_step(params, cfg, caches,
                                            toks[:, S + t:S + t + 1], S + t)
            out.append(logits)
    return out


def seamless_checks(params, cfg, prompts, gen) -> dict:
    """The model itself, with a real source: at each (prompt, source)
    length of SEAMLESS_CHECKS the cuda backend's prefill logits and
    SEAMLESS_DECODE steps after it at one position held against the torch
    backend's by the float32 floor (hold_floor); one prefill's K10
    launches, 12 encoder + 12 self + 12 cross layers in the (bf16, 64)
    unit; and a decode step at one position and at a (B,) vector of it
    equal to the bit."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {"floor": []}
    for S, T in SEAMLESS_CHECKS:
        toks = torch.randint(cfg.vocab_size, (1, S + SEAMLESS_DECODE),
                             generator=gen, device="cuda")
        src = seamless_source(gen, cfg, T)
        runs = {(c, b): prefill_and_decode(params, c, toks, src,
                                           SEAMLESS_DECODE, b)
                for c in (cfg, cfg32) for b in ("cuda", "torch")}
        for i in range(SEAMLESS_DECODE + 1):
            c, t = runs[cfg, "cuda"][i], runs[cfg, "torch"][i]
            expect(bool(torch.isfinite(c).all()) and tuple(c.shape) == (
                1, cfg.vocab_size), f"seamless S={S} T={T} step {i}: finite "
                                    f"logits of shape (1, {cfg.vocab_size})")
            what = (f"seamless prefill S={S} over T={T} frames" if i == 0
                    else f"seamless decode step {i} after S={S}, T={T}")
            row = hold_floor(what, S + i, c, t, runs[cfg32, "cuda"][i],
                             runs[cfg32, "torch"][i])
            out["floor"].append({"S": S, "T": T, "step": i, **row})
        del runs
    toks = torch.tensor([prompts[4]], dtype=torch.int64, device="cuda")
    src = seamless_source(gen, cfg, toks.shape[1])
    layers = cfg.n_enc_layers + 2 * cfg.n_units
    unit = flash_k.flash_unit(BF16, cfg.head_dim, "seamless")
    reset_counts()
    _, caches = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN,
                           src_embeds=src)
    torch.cuda.synchronize()
    k10 = read_counts()["K10"]
    expect(k10 == layers == flash_k.unit_launches.get(unit.label),
           f"seamless prefill T={toks.shape[1]}: K10 launched {k10} times, "
           f"once in each of its {cfg.n_enc_layers} encoder, "
           f"{cfg.n_units} self and {cfg.n_units} cross attention layers "
           f"({layers}), in the {unit.label} unit")
    out["k10_per_prefill"] = {"launches": k10, "unit": unit.label}
    copy = torch.utils._pytree.tree_map(torch.clone, caches)
    nxt = toks[:, -1:]
    a, _ = lm.decode_step(params, cfg, caches, nxt, toks.shape[1])
    b, _ = lm.decode_step(params, cfg, copy, nxt, torch.full(
        (1,), toks.shape[1], dtype=torch.int32, device="cuda"))
    expect(torch.equal(a, b), "seamless decode at one position and at a "
                              "(B,) vector of it: the same logits to the bit")
    out["vector_pos_equal"] = True
    log("[seamless] " + json.dumps(out))
    return out


def profile_seamless(params, cfg, prompt, steps: int = 8) -> dict:
    """Where the time goes: one prefill of ``prompt`` over a zero source of
    its length (the engine's), and ``steps`` decode steps at one position
    of a batch of four such prefills."""
    def batch(rows):
        toks = torch.tensor([prompt] * rows, dtype=torch.int64,
                            device="cuda")
        return toks, torch.zeros((*toks.shape, cfg.d_model), device="cuda")

    toks, src = batch(1)
    prefill = profile_device(
        f"seamless prefill T={len(prompt)}",
        lambda: lm.prefill(params, cfg, toks, cache_len=CACHE_LEN,
                           src_embeds=src), 1)
    toks, src = batch(BATCH)
    _, caches = lm.prefill(params, cfg, toks, cache_len=CACHE_LEN,
                           src_embeds=src)
    nxt = toks[:, -1:]

    def decode():
        for t in range(steps):
            lm.decode_step(params, cfg, caches, nxt, len(prompt) + t)

    decode()                                                 # warm-up
    return {"prefill": prefill,
            "decode_step": profile_device(f"seamless decode x{steps}",
                                          decode, steps)}


def serve_seamless(cfg, params, prompts) -> dict:
    """The 8 greedy requests through ``Engine.generate``, which runs the
    padded path in two batches of four (the source zeros, as the
    reference engine's)."""
    eng = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=BATCH,
                 device="cuda")
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, m in zip(prompts, MAX_NEW)]
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for i, (o, r) in enumerate(zip(outs, reqs)):
        expect(len(o) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in o),
            f"seamless request {i} (prompt {len(r.prompt)}): {len(o)} "
            f"tokens == max_new_tokens {r.max_new_tokens}, ids in the "
            f"vocabulary")
    batches = -(-len(reqs) // BATCH)
    expect(launches["K10"] == (cfg.n_enc_layers + 2 * cfg.n_units) * batches
           and launches["K7m"] == batches,
           f"seamless generate: K10 launched {launches['K10']} times (36 a "
           f"prefill, {batches} prefills), K7m {launches['K7m']} (the "
           f"scores of each batch)")
    for k in SEAMLESS_PATH:
        expect(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                                f"seamless path")
    stats = eng.last_stats
    return {"outs": outs, "launches": launches, "serve_s": wall,
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "generated_tokens": sum(len(o) for o in outs),
            "scores": eng.last_scores.tolist(),
            "streams": streams_digest(outs)}


def phase_seamless(gen) -> dict:
    """seamless-m4t-medium at full width and all 24 layers, after
    deepseek's tensors are gone (1.23 GB of bf16 weights): the served run
    twice (equal digests), the checks with a real source, the profile."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[seamless] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before loading")
    cfg, params, prompts = load_model("seamless-m4t-medium", "seamless",
                                      param_count)
    expect(lm.count_params(params) == SEAMLESS_PARAMS,
           f"seamless-m4t-medium: {SEAMLESS_PARAMS} parameters, as the "
           f"reference's tree")
    memory = {"weights_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    served = [serve_seamless(cfg, params, prompts) for _ in range(2)]
    memory["peak_generate_gb"] = torch.cuda.max_memory_allocated() / 1e9
    expect(served[0]["streams"] == served[1]["streams"],
           f"seamless: two served runs give the same streams "
           f"({served[0]['streams']}, {served[1]['streams']})")
    torch.cuda.reset_peak_memory_stats()
    checks = seamless_checks(params, cfg, prompts, gen)
    memory["peak_checks_gb"] = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_seamless(params, cfg, prompts[4])
    run = served[1]
    prompt_tokens = sum(PROMPT_LENS)
    summary = {
        "model": cfg.name, "requests": len(PROMPT_LENS), "slots": BATCH,
        "cache_len": CACHE_LEN, "prompt_tokens": prompt_tokens,
        # The padded path prefills each batch at its longest prompt.
        "padded_prompt_tokens": sum(
            BATCH * max(PROMPT_LENS[i:i + BATCH])
            for i in range(0, len(PROMPT_LENS), BATCH)),
        **{k: run[k] for k in ("generated_tokens", "prefill_s", "decode_s",
                               "serve_s", "decode_tok_per_s", "launches",
                               "streams", "scores")},
        "prefill_tok_per_s": prompt_tokens / run["prefill_s"],
        "serve_s_runs": [r["serve_s"] for r in served],
        "memory": memory, "profile": profile, "checks": checks}
    summary["phase_s"] = time.perf_counter() - t0
    log("[seamless] " + json.dumps(summary))
    log(f"[seamless] phase 12 took {summary['phase_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 5: sampled serving
# ---------------------------------------------------------------------------


def phase_sampled(cfg, params, prompts) -> dict:
    dev = torch.device("cuda")
    eng = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=BATCH,
                 device=dev, **SAMPLING)
    reqs = [Request(prompt=p, max_new_tokens=SAMPLED_NEW, seed=i)
            for i, p in enumerate(prompts[:BATCH])]
    eng.generate(reqs[:1])                               # warm-up
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stats = dict(eng.last_stats)
    for i, o in enumerate(outs):
        expect(len(o) == SAMPLED_NEW and all(0 <= t < cfg.vocab_size
                                             for t in o),
               f"sampled request {i}: {len(o)} tokens == {SAMPLED_NEW}, ids "
               f"in the vocabulary")
    for k in SAMPLED_PATH:
        expect(launches[k] > 0, f"{k} launched {launches[k]} times on the "
                                f"sampled serving path")
    again = eng.generate(reqs)
    expect(again == outs, "a second sampled run gives identical tokens")
    alone = eng.generate([reqs[2]])
    expect(alone[0] == outs[2], "request 2 served alone gives the tokens it "
                                "got in the batch of 4")

    # One decode step's (4, 256000) logits through both backends; then the
    # same on unit-normal logits, where no token dominates the draw.
    state = eng._fresh_state()
    state["pos"].copy_(torch.tensor([17, 600, 1500, 2100],
                                    dtype=torch.int32))
    state["tok"].copy_(torch.tensor([p[-1] for p in prompts[:BATCH]],
                                    dtype=torch.int32))
    logits, _ = eng._decode(eng.params, state["caches"],
                            state["tok"][:, None], state["pos"])
    offsets = torch.arange(BATCH + 1, dtype=torch.int32,
                           device=dev) * cfg.vocab_size
    seeds = torch.arange(BATCH, dtype=torch.int32, device=dev)
    steps = torch.full((BATCH,), 3, dtype=torch.int32, device=dev)
    knobs = dict(temperature=SAMPLING["temperature"], top_k=SAMPLING["top_k"],
                 top_p=SAMPLING["top_p"], top_p_candidates=64)
    noise = torch.randn(BATCH, cfg.vocab_size, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    for what, lg in (("a decode step's logits", logits),
                     ("unit-normal logits", noise)):
        flat = lg.float().reshape(-1)
        got = {}
        for backend in ("cuda", "torch"):
            with ki.use_backend(backend):
                v, i = forge.top_k(flat, SAMPLING["top_k"],
                                   layout=Segmented(offsets=offsets))
                ids = SP.sample_tokens(eng._base_key, lg, seeds, steps,
                                       **knobs)
            got[backend] = (v, i, ids)
        (vc, ic, sc), (vt, it, st) = got["cuda"], got["torch"]
        lib = torch.topk(flat.reshape(BATCH, -1), SAMPLING["top_k"], dim=1)
        expect(torch.equal(vc, vt) and torch.equal(ic, it),
               f"{what}: top_k (4, {cfg.vocab_size}) k={SAMPLING['top_k']}, "
               f"cuda and torch backends bit-identical in values and indices")
        expect(torch.equal(vc, lib.values),
               f"{what}: top_k values equal torch.topk's")
        expect(torch.equal(sc, st), f"{what}: sampled ids identical across "
                                    f"backends: {sc.tolist()}")

    full = Engine(cfg, params, cache_len=CACHE_LEN, batch_size=1,
                  device=dev, temperature=1.0, seed=1)
    one = full.generate([Request(prompt=prompts[0],
                                 max_new_tokens=SAMPLED_NEW, seed=5)])[0]
    expect(len(one) == SAMPLED_NEW and all(0 <= t < cfg.vocab_size
                                           for t in one),
           f"full-vocabulary Gumbel (temperature 1.0, no filter): "
           f"{len(one)} tokens in the vocabulary")
    expect(full.generate([Request(prompt=prompts[0],
                                  max_new_tokens=SAMPLED_NEW,
                                  seed=5)])[0] == one,
           "the full-vocabulary run repeats")

    state = eng._fresh_state()
    state["active"][:] = True
    state["max_new"][:] = eng.max_new_cap
    state["pos"].copy_(torch.tensor([17, 600, 1500, 2100], dtype=torch.int32))
    state, _ = eng._dispatch_loop(state, 2, False)          # warm-up
    ran = []
    profile = profile_device(
        "sampled decode x4",
        lambda: ran.append(eng._dispatch_loop(state, 4, False)[1]), 4)
    if ran != [4]:
        raise CheckFailed(f"the profiled sampled loop ran {ran} steps")
    summary = {
        "requests": len(reqs), "sampling": SAMPLING,
        "generated_tokens": stats["total_tokens"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "serve_s": wall, "decode_tok_per_s": stats["decode_tok_per_s"],
        "decode_steps": stats["decode_steps"],
        "distinct_tokens": len({t for o in outs for t in o}),
        "streams": streams_digest(outs),
        "launches": launches,
        "launches_per_request": {k: n / len(reqs)
                                 for k, n in launches.items()},
        "top_k_ms": time_ms(lambda: forge.top_k(
            flat, SAMPLING["top_k"], layout=Segmented(offsets=offsets)), 10),
        "torch_topk_ms": time_ms(lambda: torch.topk(
            flat.reshape(BATCH, -1), SAMPLING["top_k"], dim=1), 10),
        "profile": profile,
    }
    log("[sampled] " + json.dumps(summary))
    return summary


# The aten ops of a decode step whose device time profile_device reports:
# the cache clones, the upcasts, the slot writes, einsum and its products.
SPLIT_OPS = ("aten::clone", "aten::_to_copy", "aten::copy_", "aten::index_put_",
             "aten::einsum", "aten::bmm", "aten::mm", "aten::matmul",
             "aten::softmax", "aten::where", "aten::tanh")


# The profiler ranges the port's modules open (models/recurrent.py).
PORT_RANGES = ("slstm loop",)


def profile_device(label: str, fn, units: int) -> dict:
    """Run ``fn`` once under torch.profiler and report, per unit of work
    (a decode step, a prefill), the wall time, the device kernel time, the
    device's idle share, the device operations and the kernels that take
    the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    ops = memsets = 0
    # The port's own profiler ranges (record_function): host ms and count.
    ranges = collections.defaultdict(lambda: {"count": 0, "host_ms": 0.0})
    for e in prof.events():
        if e.name in PORT_RANGES:
            # A range is a host event, and its annotation on the device's
            # timeline spans the kernels launched in it: no device time.
            if e.device_type == torch.autograd.DeviceType.CPU:
                ranges[e.name]["count"] += 1
                ranges[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            ops += 1
            memsets += e.name.startswith("Memset")
    ranges = dict(ranges)
    if not ops:
        log(f"[profile {label}] device time not measured (no device events)")
        return {"measured": False, "ranges": ranges}
    busy_ms = sum(by_name.values())
    # The port's own kernels by family (rt::flash is K10, rt::scan K2/K6/
    # K7s, ...), whether or not they make the top eight.
    port = collections.Counter()
    for name, ms in by_name.items():
        m = re.search(r"\brt::(\w+)::", name)
        if m:
            port[m.group(1)] += ms / units
    # Device ms under each aten op, its children included (so einsum holds
    # its bmm and its own copies; copy_ runs under clone and _to_copy too).
    by_op = {}
    for e in prof.key_averages():
        if e.key in SPLIT_OPS:
            us = getattr(e, "device_time_total", None)
            by_op[e.key] = (us if us is not None else e.cuda_time_total) \
                / 1e3 / units
    out = {"measured": True, "units": units,
           "wall_ms_profiled": wall_ms / units,
           "device_ms": busy_ms / units,
           # K6's channel-tile route (the RG-LRU's recurrence, the mLSTM's
           # chunk states) and its long-T path's three kernels (the mLSTM's
           # stabilizer, the radix sort's rank scans).
           "k6_ms": sum(ms for name, ms in by_name.items()
                        if "scan_channel_tiles" in name) / units,
           "k6_long_ms": sum(ms for name, ms in by_name.items() if any(
               k in name for k in ("chunk_aggregates", "scan_totals",
                                   "chunk_rescan"))) / units,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops": ops / units, "memsets": memsets / units,
           "port_kernels_ms": dict(port), "ops_ms": by_op, "ranges": ranges,
           "top": [[name[:60], ms / units]
                   for name, ms in by_name.most_common(8)]}
    log(f"[profile {label}] " + json.dumps(out))
    return out


def profile_serving(eng, params, cfg, prompt, steps: int = 8) -> dict:
    """Where the time goes: one prefill of ``prompt``, and ``steps``
    iterations of the engine's decode loop with all four slots live
    (positions 17, 600, 1500 and 2100, the last past the 2048-slot ring)."""
    toks = torch.tensor([prompt], dtype=torch.int64, device="cuda")
    prefill = profile_device(
        f"prefill T={len(prompt)}",
        lambda: lm.prefill(params, cfg, toks, cache_len=CACHE_LEN), 1)
    state = eng._fresh_state()
    state["active"][:] = True
    state["max_new"][:] = eng.max_new_cap
    state["pos"].copy_(torch.tensor([17, 600, 1500, 2100], dtype=torch.int32))
    state, _ = eng._dispatch_loop(state, 2, False)          # warm-up
    ran = []
    decode = profile_device(
        f"decode x{steps}",
        lambda: ran.append(eng._dispatch_loop(state, steps, False)[1]), steps)
    if ran != [steps]:
        raise CheckFailed(f"the profiled decode loop ran {ran} steps, not "
                          f"{steps}")
    check_predicate(state)
    return {"prefill": prefill, "decode_step": decode}


def check_predicate(state) -> None:
    """The decode loop's predicate as the engine calls it, on the engine's
    flags: one launch of the small form a call (the counter), and on the
    device nothing else: K3's kernel, no memset.  torch.profiler misses
    events at the edge of its window (3 to 10 of 10 calls' kernels seen,
    once none), so 100 calls a window, a window profiled again (at most
    three) when it saw no device event, and at most one operation a
    call."""
    x = state["active"].to(torch.int32)
    calls, small = 100, mapreduce_k.mapreduce_1d_cuda.small_launches
    for windows in range(1, 4):
        ops = profile_device("predicate", lambda: [forge.mapreduce(
            alg.IDENTITY, alg.MAX, x, layout=Flat()) for _ in range(calls)],
            calls)
        if ops["measured"]:
            break
    small = mapreduce_k.mapreduce_1d_cuda.small_launches - small
    calls *= windows
    expect(small == calls and ops["measured"] and ops["device_ops"] <= 1
           and ops["memsets"] == 0
           and list(ops["port_kernels_ms"]) == ["mapreduce"],
           f"the serving predicate at ({BATCH},): {small} small-form "
           f"launches in {calls} calls; on the device "
           f"{ops.get('device_ops')} operations and {ops.get('memsets')} "
           f"memsets a call, all K3's")


# ---------------------------------------------------------------------------
# Phase 14: training -- K10's and K6's gradients, recurrentgemma-2b FULL
# train steps on the cuda backend, the trainer at smoke size
# ---------------------------------------------------------------------------

# K10's gradient cases (K10Case fields): the four timed layers -- the
# trained model's (recurrentgemma-2b at S = 4,096 > its window), gemma2's
# global layer (soft cap), deepseek-v3's MLA (v narrower than q/k) and
# seamless's cross attention (64 queries over 2,100 keys, not causal) --
# then one kv head of ten query heads whose 16 key tiles the dkv launch
# splits over 17 blocks a tile and folds; the edges of the gradient's
# tiles (64 and 128 query rows, 64 keys; the CUDA cores' 64 and 32): T =
# 1; S and T at a tile +-1 with B = 2; rows that keep no key; windows that
# skip whole tiles; S > T not causal; both bodies (bf16's tensor cores,
# f32's CUDA cores), forward and backward.
K10B_CASES = tuple(K10Case(*c) for c in (
    ("recurrentgemma-2b local", 1, 4096, 4096, 1, 10, 256, BF16, True, 2048,
     0.0),
    ("gemma2-27b global", 1, 2100, 2100, 16, 2, 128, BF16, True, 0, 50.0),
    ("deepseek-v3-671b MLA", 1, 2100, 2100, 128, 1, 192, BF16, True, 0, 0.0,
     128),
    ("seamless-m4t-medium cross", 1, 64, 2100, 16, 1, 64, BF16, False, 0,
     0.0),
    ("bf16, one kv head, split and folded", 1, 1000, 1000, 1, 10, 128, BF16,
     True, 0, 0.0),
    ("T = 1", 2, 1, 1, 16, 2, 128, BF16, True, 0, 50.0),
    ("S, T at a tile -1, +1", 2, 63, 33, 2, 2, 128, BF16, True, 0, 50.0),
    ("S, T at a tile +1, -1", 2, 65, 31, 1, 10, 256, BF16, False, 0, 0.0),
    ("bf16, rows that keep no key", 1, 100, 20, 2, 2, 16, BF16, True, 8,
     0.0),
    ("bf16, window skips tiles", 1, 400, 400, 16, 2, 128, BF16, True, 100,
     50.0),
    ("f32, rows that keep no key", 1, 100, 20, 2, 2, 16, F32, True, 8, 0.0),
    ("f32, window skips tiles, soft cap", 1, 400, 400, 2, 3, 64, F32, True,
     100, 30.0),
    ("f32, S > T, not causal", 1, 100, 37, 1, 3, 256, F32, False, 0, 0.0),
    ("f32, value head 128 of 192 (MLA)", 1, 100, 100, 4, 1, 192, F32, True,
     0, 0.0, 128),
))
K10B_TIMED = tuple(c.label for c in K10B_CASES[:4])
K10B_UNITS = sorted({(c.dtype, c.hd, c.dv or c.hd) for c in K10B_CASES}
                    | {(F32, 256, 256)}, key=str)
# K6's gradient (csrc/linrec_grad.cuh): the RG-LRU's width at S = 4,096
# with and without h0, B = 3, T at the short form's limit of 64 +-1,
# xlstm-1.3b's two chunk states at 1,024 tokens (16 chunks; no h0), the
# long-T form, reverse recurrences and a bf16 dh.  Float32 leaves.
K6GCase = collections.namedtuple("K6GCase", "B T C h0 reverse dh",
                                 defaults=(False, F32))
K6G_CASES = (K6GCase(1, 4096, 2560, False), K6GCase(1, 4096, 2560, True),
             K6GCase(3, 4096, 2560, True), K6GCase(3, 63, 2560, True),
             K6GCase(3, 65, 2560, False),
             K6GCase(1, 16, 4 * 1024 * 1024, False),
             K6GCase(1, 16, 4096, False), K6GCase(2, 4096, 256, True),
             K6GCase(1, 4096, 2560, True, True),
             K6GCase(2, 128, 256, True, True),
             K6GCase(1, 4096, 2560, False, False, BF16))
# The shapes whose times the kernels line carries: the RG-LRU's and
# xLSTM's larger chunk state.
K6G_TIMED = (K6G_CASES[0], K6G_CASES[5])
TRAIN_SEQ = 4096
TRAIN_STEPS = 4
# The first step's cuda-vs-torch check runs one unit (rglru, rglru,
# attn_local) at full width: the torch route's blockwise attention and
# log-step scan at S = 4,096 through all 26 layers would cost minutes.
TRAIN_CUT = dict(n_layers=3, n_units=1, suffix=())
# Leaves whose gradients the check holds, by path in the parameter tree.
TRAIN_LEAVES = {
    "embed.embedding": ("embed", "embedding"),
    "units.0.0.mixer.gate_a": ("decoder", "units", 0, 0, "mixer", "gate_a"),
    "units.0.2.attn.wq": ("decoder", "units", 0, 2, "attn", "wq"),
}


def k10b_bound(B, S, T, K, G, hd, dtype, causal, window, dv=None):
    """q, k, v, out, dout read once (lse and D aside), dq, dk, dv written
    once; per kept pair the four products (q . k and dout . v over hd and
    dv, dS K and dS^T q over hd, P^T dout over dv): 2 (3 hd + 2 dv)
    operations, at the dtype's peak."""
    dv = dv or hd
    size = torch.empty((), dtype=dtype).element_size()
    rows, keys = B * S * K * G, B * T * K
    nbytes = size * (rows * (2 * hd + 2 * dv) + keys * 2 * (hd + dv))
    ops = 2 * (3 * hd + 2 * dv) * B * K * G * attention_pairs(S, T, causal,
                                                               window)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S if dtype == BF16
                    else F32_OPS_PER_S)


def sdpa_fwd_bwd(q, k, v, dout, causal, window):
    """SDPA's forward and backward with the case's mask (a speed baseline
    only: no soft cap), in SDPA's (B, heads, length, d) layout."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    qs = q.reshape(B, S, K * G, hd).transpose(1, 2).detach().requires_grad_()
    ks = k.transpose(1, 2).detach().requires_grad_()
    vs = v.transpose(1, 2).detach().requires_grad_()
    dos = dout.reshape(B, S, K * G, -1).transpose(1, 2)
    kw = {"enable_gqa": True}
    if window:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        kw["attn_mask"] = ((qpos - kpos) < window) & (
            (qpos >= kpos) if causal else True)
    else:
        kw["is_causal"] = causal

    def run():
        out = F.scaled_dot_product_attention(qs, ks, vs, **kw)
        torch.autograd.grad(out, (qs, ks, vs), dos)

    return run, sdpa_backend(qs, ks, vs, **{x: y for x, y in kw.items()
                                            if x != "enable_gqa"})


def check_k10_bwd(res) -> None:
    """K10's forward log-sum-exp against its plain version's, and its
    gradient against ``flash_attention_bwd_ref`` on the same inputs (q, k,
    v, the kernel's out and lse, dout), on the body its dtype's unit runs
    (bf16: the tensor cores, float32: the CUDA cores).  The log-sum-exp of
    every row that keeps a key within 1e-4 (1 + |lse|) (scores summed in
    another order, ex2.approx in the tensor-core body).  Each of dq, dk, dv
    within tol x its largest entry (at T = 1, where dq and dk vanish, of
    dv's): bf16 2^-7 -- each output rounds to bf16 (2^-9 of itself at
    most), and P and dS round to bf16 before their products as the
    forward rounds p, each such rounding moving one term by 2^-9 of it;
    float32 1e-5, the sums in another order.  A mask that keeps or drops a
    wrong key moves a row's gradient by the size of its terms, far beyond
    either.  Each case runs the gradient twice: the two equal to the bit
    (no atomics; the split's fold sums in a fixed order).  The split case
    must split."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    r = res["K10-bwd"]
    r["units"] = sorted({flash_k.flash_bwd_unit(c.dtype, c.hd, "units",
                                                c.dv or c.hd).label + " on "
                         + flash_k.BODIES[c.dtype] for c in K10B_CASES})
    for case in K10B_CASES:
        label, B, S, T, K, G, hd, dtype, causal, window, cap, dv = case
        dv = dv or hd
        H = K * G
        body = flash_k.BODIES[dtype]
        unit = flash_k.flash_bwd_unit(dtype, hd, "check", dv)
        plan = flash_k.bwd_plan(B, S, T, H, K, hd, dv, causal, window, body,
                                matvec_k.sms(0))

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rn(B, S, K, G, hd), rn(B, T, K, hd), rn(B, T, K, dv)
        dout = rn(B, S, H, dv)
        kw = dict(causal=causal, window=window, softcap=cap)
        q4 = q.reshape(B, S, H, hd)
        before = flash_k.flash_attention_gqa.launches
        out, lse = flash_k.flash_attention_lse(q4, k, v, **kw)
        launched_fwd = flash_k.flash_attention_gqa.launches - before
        _, lse_ref = ref.flash_attention_gqa_ref(
            q, k, v, kv_block=flash_k.KV_BLOCK, return_lse=True, **kw)
        kept = lse_ref > -1e29
        lse_err = float(((lse - lse_ref).abs() / (1 + lse_ref.abs()))[kept]
                        .max()) if kept.any() else 0.0
        before = flash_k.flash_attention_bwd.launches
        got = flash_k.flash_attention_bwd(q4, k, v, out, lse, dout, **kw)
        again = flash_k.flash_attention_bwd(q4, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        launched = flash_k.flash_attention_bwd.launches - before
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        want = ref.flash_attention_bwd_ref(
            q4, k, v, out, lse, dout, empty_l=ref.flash_empty_l(
                T, flash_k.KV_BLOCK), **kw)
        tol = 2 ** -7 if dtype == BF16 else 1e-5
        errs = {n: max_err(g, w) / max(float(w.float().abs().max()), 1e-30)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        if T == 1:
            # One key a row: P = 1 and dS = dP - D = 0 exactly, so dq and
            # dk are the float32 rounding of two equal sums; held against
            # dv's scale instead of their own (about 0).
            scale = float(want[2].float().abs().max())
            errs.update({n: max_err(g, w) / scale for n, g, w in
                         zip(("dq", "dk"), got[:2], want[:2])})
        r["max_abs_err"] = max(r["max_abs_err"], max_err(got, want))
        split = "split" in label
        expect(launched == 2 and launched_fwd == 1 and lse_err <= 1e-4 and
               repeat and all(bool(torch.isfinite(g).all()) for g in got)
               and max(errs.values()) <= tol and
               tuple(got[2].shape) == (B, T, K, dv) and
               (body == "TensorCores") == ("TensorCores" in unit.source)
               and (plan.splits > 1 if split else True),
               f"K10-bwd {label} ({B}, {S}/{T}, {H}/{K} heads, {hd}/{dv}) "
               f"{str(dtype)[6:]} causal={causal} window={window} softcap={cap}"
               f" on {body}, dkv split {plan.splits}: lse err {lse_err:.3g} "
               f"<= 1e-4 (1 + |lse|); max err / max |grad| "
               + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
               + f" <= {tol:.3g}; two calls equal to the bit; one forward "
               f"launch, one backward launch a call")
        del want
        if label in K10B_TIMED:
            sdpa, backend = sdpa_fwd_bwd(q, k, v, dout, causal, window)

            def pair():
                o, l = flash_k.flash_attention_lse(q4, k, v, **kw)
                flash_k.flash_attention_bwd(q4, k, v, o, l, dout, **kw)

            timing = {
                "ms": time_ms(lambda: flash_k.flash_attention_bwd(
                    q4, k, v, out, lse, dout, **kw), 10),
                "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(
                    q4, k, v, out, lse, dout, **kw), 1),
                "library_ms": time_ms(sdpa, 5),
                "library_backend": backend,
                "forward_ms": time_ms(lambda: flash_k.flash_attention_lse(
                    q4, k, v, **kw), 10),
                "pair_ms": time_ms(pair, 10),
                "splits": plan.splits}
            bound = k10b_bound(B, S, T, K, G, hd, dtype, causal, window, dv)
            what = (f"({B}, {S}/{T}, {H}/{K} heads, {hd}"
                    + (f"/{dv}" if dv != hd else "") + f") "
                    f"{str(dtype)[6:]} {label}"
                    + (f" window {window}" if window else "")
                    + (f" softcap {cap:g}" if cap else ""))
            if not r.get("shape"):
                r.update(timing, bound=bound, shape=what)
            r.setdefault("shapes", {})[label] = dict(
                timing, bound_ms=bound[0], bound_by=bound[1])
            log(f"[K10-bwd] {what}: {timing['ms']:.4f} ms on {body} (dkv "
                f"split {plan.splits}), bound {bound[0]:.4f} ms "
                f"({bound[1]}), plain {timing['plain_ms']:.1f} ms; forward "
                f"with lse {timing['forward_ms']:.4f} ms, forward + backward "
                f"{timing['pair_ms']:.4f} ms against SDPA forward + backward "
                f"{timing['library_ms']:.4f} ms ({backend})")
        del q, k, v, q4, out, lse, dout, got
    gc.collect()
    torch.cuda.empty_cache()


def linrec_walk(a, b, h0):
    """The serial walk over T, h_t = a_t h_{t-1} + b_t, written without
    in-place writes so that autograd differentiates it (the plain
    version's recurrence; ``scan_channel_plain`` writes each step into its
    output in place, whose backward copies the whole output each step)."""
    h = h0 if h0 is not None else torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def k6g_bound(c: K6GCase) -> tuple[float, str]:
    """a, h and dh read, da and db written (h0 read and dh0 written where
    given); three operations a step."""
    elems, edge = c.B * c.T * c.C, c.B * c.C
    nbytes = 16 * elems + c.dh.itemsize * elems + 8 * edge * c.h0
    return bound_ms(nbytes, 3 * elems)


def device_kernels(fn, per_call: int, calls: int = 50) -> list[str]:
    """The names of the device kernels ``calls`` calls of ``fn`` launch,
    from the profiler's raw device events (as device_busy reads them: late
    in a run the parsed event list has come back empty for a window whose
    kernels ran), after a warm-up call; the first of three windows that saw
    ``per_call`` kernels a call, else the window that saw the most (a
    window's edge can drop an event)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    best = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        if len(names) == per_call * calls:
            return names
        best = max(best, names, key=len)
    return best


# The kernels of each form of csrc/linrec_grad.cuh, by name.
K6G_FORM_KERNELS = {"short": ("short_t",), "tiles": ("tiles",),
                    "long": ("long_aggregates", "scan_totals", "long_rescan")}


def check_k6_grad(res) -> None:
    """``linear_recurrence``'s gradient on the cuda route (K6 forward, one
    call of ``csrc/linrec_grad.cuh`` back: ``scan_k.linrec_grad_cuda``) at
    every ``K6G_CASES`` shape: da, db and dh0 within 1e-5 of each one's
    largest entry of autograd through the float64 serial walk (each form
    sums in runs and a carry, as K6 does; the float32 walk's own error
    beside it) and of the plain version ``linrec_grad_plain`` on the same
    inputs, two calls equal to the bit.  With a float32 dh the backward
    runs through ``autograd.grad`` of the public call: one call of the
    form ``linrec_grad_form`` picks, and at each form's first case a
    profiled backward launches that form's kernels (one; the long-T form's
    three) and no other kernel (a window of the profiler late in the run
    has seen no event of a 0.5 ms kernel, so a form is profiled once).  A
    bf16 dh (autograd hands a backward h's own dtype) goes to the wrapper
    directly, which reads it in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    grad = scan_k.linrec_grad_cuda
    r = res["K6-grad"]
    profiled = set()     # the forms whose backward the profiler has seen
    for c in K6G_CASES:
        B, T, C = c.B, c.T, c.C
        a = torch.empty(B, T, C, device="cuda").uniform_(0.9, 0.999,
                                                         generator=gen)
        b = torch.randn(B, T, C, generator=gen, device="cuda")
        h0 = torch.randn(B, C, generator=gen, device="cuda") if c.h0 \
            else None
        dh = torch.randn(B, T, C, generator=gen, device="cuda").to(c.dh)
        ins = [x.clone().requires_grad_() for x in (a, b, h0)
               if x is not None]
        h = forge.linear_recurrence(*ins[:2], *ins[2:], reverse=c.reverse,
                                    layout=Batched())
        form = scan_k.linrec_grad_form(B, T, C)
        before = grad.launches, dict(grad.form_launches)
        rev = scan_k.scan_channel_cuda.reverse_launches + \
            scan_k.scan_channel_cuda.long_t_reverse_launches
        if c.dh == F32:
            got = torch.autograd.grad(h, ins, dh, retain_graph=True)
        else:
            da, db, dh0 = grad(a, h.detach(), dh, h0, reverse=c.reverse)
            got = (da, db, dh0)[:len(ins)]
        torch.cuda.synchronize()
        launched = grad.launches - before[0]
        in_form = grad.form_launches[form] - before[1][form]
        rev = scan_k.scan_channel_cuda.reverse_launches + \
            scan_k.scan_channel_cuda.long_t_reverse_launches - rev
        again = grad(a, h.detach(), dh, h0, reverse=c.reverse)
        plain = scan_k.linrec_grad_plain(a, h.detach(), dh, h0,
                                         reverse=c.reverse)
        same = all(torch.equal(g, x) for g, x in zip(got, again))
        ins64 = [x.detach().double().requires_grad_() for x in ins]
        walk = linrec_walk if not c.reverse else (
            lambda a_, b_, h_: linrec_walk(a_.flip(1), b_.flip(1),
                                           h_).flip(1))
        want = torch.autograd.grad(walk(*ins64[:2], *(ins64[2:] or [None])),
                                   ins64, dh.double())
        ins32 = [x.detach().requires_grad_() for x in ins]
        walk32 = torch.autograd.grad(walk(*ins32[:2], *(ins32[2:] or [None])),
                                     ins32, dh.float())
        errs = [max_err(g, w) / float(w.abs().max()) for g, w in
                zip(got, want)]
        perr = [max_err(g, p) / float(w.abs().max()) for g, p, w in
                zip(got, plain, want)]
        wall = [max_err(g, w) / float(w.abs().max()) for g, w in
                zip(walk32, want)]
        r["max_abs_err"] = max(r["max_abs_err"], max_err(got, want))
        what = (f"K6 gradient ({B}, {T}, {C}) h0={c.h0} reverse={c.reverse} "
                f"dh {str(c.dh)[6:]}, {form} form")
        expect(max(errs) <= 1e-5 and max(perr) <= 1e-5 and same,
               f"{what}: max err / max |grad| {max(errs):.3g} against the "
               f"float64 walk (the float32 walk's {max(wall):.3g}), "
               f"{max(perr):.3g} against the plain version, each <= 1e-5; "
               f"two calls equal to the bit: {same}")
        expect(launched == in_form == 1 and rev == 0,
               f"{what}: one call of the gradient kernel in its form "
               f"({launched} calls, {in_form} in the form), no reverse K6 "
               f"launch ({rev})")
        if c.dh == F32 and form not in profiled:
            profiled.add(form)
            kinds = K6G_FORM_KERNELS[form]
            names = device_kernels(lambda: torch.autograd.grad(
                h, ins, dh, retain_graph=True), len(kinds))
            seen = {k for k in kinds for n in names if k in n}
            if not names:
                # Late in a run the profiler has recorded no device event
                # for such windows, three in a row, while the kernels ran
                # (the counters above saw the launch): nothing to hold.
                log(f"[K6-grad] {what}: the profiler recorded no device "
                    f"event in three windows of 50 backwards; the check "
                    f"that no other kernel runs is not measured here")
            else:
                # Every kernel the windows saw is one of the form's, each
                # of them was seen, and no more than fifty backwards launch.
                expect(all("linrec_grad" in n for n in names)
                       and seen == set(kinds)
                       and len(names) <= 50 * len(kinds),
                       f"{what}: fifty backwards launch the form's kernels "
                       f"{kinds} and no other ({len(names)} events seen, "
                       f"{sorted(set(names))})")
        if c in K6G_TIMED:
            timing = {
                "ms": time_ms(lambda: grad(a, h.detach(), dh, h0,
                                           reverse=c.reverse), 20),
                "device_ms": call_device_ms(lambda: grad(
                    a, h.detach(), dh, h0, reverse=c.reverse)),
                "autograd_ms": time_ms(lambda: torch.autograd.grad(
                    h, ins, dh, retain_graph=True), 20),
                "plain_ms": time_ms(lambda: scan_k.linrec_grad_plain(
                    a, h.detach(), dh, h0, reverse=c.reverse), 1),
                "form": form}
            bound = k6g_bound(c)
            shape = f"({B}, {T}, {C}) f32 AFFINE, {form} form"
            if c == K6G_TIMED[0]:
                r.update(timing, bound=bound, library_ms=None, shape=(
                    f"{shape}, the gradient of linear_recurrence (one "
                    f"call; autograd.grad through it in autograd_ms)"))
            r.setdefault("shapes", {})[f"({B}, {T}, {C})"] = dict(
                timing, bound_ms=bound[0], bound_by=bound[1])
            log(f"[K6-grad] {shape}: {timing['ms']:.4f} ms, device "
                f"{timing['device_ms'] or math.nan:.4f}, through autograd "
                f"{timing['autograd_ms']:.4f}, bound {bound[0]:.4f} ms "
                f"({bound[1]}), plain {timing['plain_ms']:.1f} ms")
        del a, b, h0, dh, ins, h, got, again, plain, want, ins64, ins32
        del walk32
        gc.collect()
        torch.cuda.empty_cache()


# The mLSTM stabilizer's gradient (MaxplusAffineScan's backward, one launch
# of csrc/maxplus_grad.cuh): xlstm-1.3b's train shape (1, 1024, 4 heads)
# and a long prompt's (1, 2112, 4), B = 3, T about a power of two +-1, a
# wide one, and T = 12,000, whose levels leave shared memory for the
# workspace.
MAXPLUS_GRAD_CASES = ((1, 1024, 4), (1, 2112, 4), (3, 1024, 4),
                      (1, 191, 4), (1, 193, 4), (1, 33, 4096),
                      (1, 12000, 2))
# xlstm-1.3b's training: three steps of one 1,024-token sequence (its sLSTM
# loop is host-bound under autograd), the first-step check at one unit of 7
# mLSTM and 1 sLSTM layers.
XLSTM_TRAIN_SEQ = 1024
XLSTM_TRAIN_STEPS = 3
XLSTM_TRAIN_CUT = dict(n_layers=8, n_units=1)
XLSTM_TRAIN_LEAVES = {
    "embed.embedding": ("embed", "embedding"),
    "units.0.0.mixer.w_igate": ("decoder", "units", 0, 0, "mixer",
                                "w_igate"),
    "units.0.0.mixer.w_fgate": ("decoder", "units", 0, 0, "mixer",
                                "w_fgate"),
    "units.0.7.mixer.r": ("decoder", "units", 0, 7, "mixer", "r"),
}
XLSTM_TRAIN_KERNELS = ("K6", "K6-grad", "K6-long", "MAXPLUS-grad")


def maxplus_walk(lf, li):
    """The stabilizer's scan as a serial walk over T that autograd
    differentiates: A_t = A_{t-1} + lf_t, Bm_t = max(Bm_{t-1} + lf_t, li_t)
    from (0, -inf)."""
    A = torch.zeros_like(lf[:, 0])
    Bm = torch.full_like(lf[:, 0], -math.inf)
    As, Bs = [], []
    for t in range(lf.shape[1]):
        A = A + lf[:, t]
        Bm = torch.maximum(Bm + lf[:, t], li[:, t])
        As.append(A)
        Bs.append(Bm)
    return torch.stack(As, dim=1), torch.stack(Bs, dim=1)


def check_maxplus_grad(res) -> None:
    """The MAXPLUS_AFFINE scan's gradient on the cuda route (K6 forward,
    one launch of the stabilizer-gradient kernel back, no K6 launch) against
    its plain version ``maxplus_grad_plain`` on the same inputs, bit for
    bit (the same float32 operations in the same tree: a share of 0, 1/2
    or 1 times an adjoint is exact, so no contraction moves a bit), and
    against autograd through the float64 serial walk, dlf and dli within
    1e-5 of each one's largest entry (the forget gates' sums in another
    order; the float32 walk's own error beside it).  Log forget gates in
    (-1.01, -0.01), input gates N(0, 1), dA and dB N(0, 1).  Then the
    reference's tie chain through the model's stabilizer, m = max(A, Bm):
    lf = 0, li = 1 over four steps, dm = (0, 0, 0, 1) -- dyadic gates, so
    every sum is exact -- gives the reference's dli = 1/4 each and dlf =
    (0, 1/4, 1/2, 3/4) to the bit, in every column of a (2, 4, 3) batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    k6, grad = scan_k.scan_channel_cuda, scan_k.maxplus_grad_cuda
    r = res["MAXPLUS-grad"]
    for shape in MAXPLUS_GRAD_CASES:
        B, T, H = shape
        lf = -torch.rand(*shape, generator=gen, device="cuda") - 0.01
        li = torch.randn(*shape, generator=gen, device="cuda")
        dA = torch.randn(*shape, generator=gen, device="cuda")
        dB = torch.randn(*shape, generator=gen, device="cuda")
        ins = [x.clone().requires_grad_() for x in (lf, li)]
        A, Bm = forge.scan(alg.MAXPLUS_AFFINE, tuple(ins), axis=1)
        rev = k6.reverse_launches + k6.long_t_reverse_launches
        launched = grad.launches
        got = torch.autograd.grad((A, Bm), ins, (dA, dB), retain_graph=True)
        torch.cuda.synchronize()
        launched = grad.launches - launched
        rev = k6.reverse_launches + k6.long_t_reverse_launches - rev
        plain = scan_k.maxplus_grad_plain(lf, li, dA, dB)
        exact = all(torch.equal(g, w) for g, w in zip(got, plain))
        ins64 = [x.detach().double().requires_grad_() for x in ins]
        want = torch.autograd.grad(maxplus_walk(*ins64), ins64,
                                   (dA.double(), dB.double()))
        ins32 = [x.detach().requires_grad_() for x in ins]
        walk32 = torch.autograd.grad(maxplus_walk(*ins32), ins32, (dA, dB))
        errs = [max_err(g, w) / float(w.abs().max()) for g, w in
                zip(got, want)]
        walk = [max_err(g, w) / float(w.abs().max()) for g, w in
                zip(walk32, want)]
        r["max_abs_err"] = max(r["max_abs_err"], max_err(got, plain))
        expect(launched == 1 and rev == 0 and exact and max(errs) <= 1e-5,
               f"MAXPLUS_AFFINE gradient {shape}: equal to the plain version "
               f"to the bit; max err / max |grad| {max(errs):.3g} <= 1e-5 "
               f"against the float64 walk (the float32 walk's "
               f"{max(walk):.3g}); one launch of the stabilizer-gradient "
               f"kernel, no K6 launch")
        if shape == MAXPLUS_GRAD_CASES[0]:
            elems = B * T * H
            r.update(
                ms=time_ms(lambda: grad(lf, li, dA, dB), 50),
                autograd_ms=time_ms(lambda: torch.autograd.grad(
                    (A, Bm), ins, (dA, dB), retain_graph=True), 20),
                plain_ms=time_ms(lambda: scan_k.maxplus_grad_plain(
                    lf, li, dA, dB), 5),
                library_ms=None,   # no PyTorch call runs the adjoint scan
                # lf, li, dA, dB read; dlf, dli written.
                bound=bound_ms(6 * 4 * elems, 10 * elems),
                shape=f"({B}, {T}, {H}) f32 MAXPLUS_AFFINE, the gradient of "
                      f"the mLSTM stabilizer (one launch; autograd.grad "
                      f"through it in autograd_ms)")
            log(f"[MAXPLUS-grad] {r['shape']}: {r['ms']:.4f} ms (through "
                f"autograd {r['autograd_ms']:.4f}), bound "
                f"{r['bound'][0]:.6f} ms, plain {r['plain_ms']:.2f} ms")
        del lf, li, dA, dB, ins, A, Bm, got, want, ins64, ins32, walk32
    lf = torch.zeros(2, 4, 3, device="cuda", requires_grad=True)
    li = torch.ones(2, 4, 3, device="cuda", requires_grad=True)
    dm = torch.zeros(2, 4, 3, device="cuda")
    dm[:, 3] = 1.0
    with ki.use_backend("cuda"):
        m = rec_m._mlstm_stabilizer(lf, li)
    dlf, dli = torch.autograd.grad(m, (lf, li), dm)
    want_lf = torch.tensor([0.0, 0.25, 0.5, 0.75], device="cuda")
    expect(torch.equal(dli, torch.full_like(dli, 0.25)) and torch.equal(
        dlf, want_lf[None, :, None].expand_as(dlf)),
        f"MAXPLUS_AFFINE gradient, the reference's chain of four ties: dli "
        f"{dli[0, :, 0].tolist()} and dlf {dlf[0, :, 0].tolist()} equal "
        f"(1/4, 1/4, 1/4, 1/4) and (0, 1/4, 1/2, 3/4) in every column")


def train_xlstm(res) -> dict:
    """xlstm-1.3b's training on the card, after recurrentgemma's tensors
    are freed: the stabilizer's gradient (check_maxplus_grad), the first
    step cuda vs torch at one unit, then XLSTM_TRAIN_STEPS FULL steps."""
    gc.collect()
    torch.cuda.empty_cache()
    check_maxplus_grad(res)
    cfg = get_config("xlstm-1.3b")
    data = SyntheticDataset(DataConfig(seq_len=XLSTM_TRAIN_SEQ,
                                       global_batch=1,
                                       vocab_size=cfg.vocab_size), cfg)
    batches = [data.batch(i) for i in range(XLSTM_TRAIN_STEPS)]
    out = {"first_step": first_step_check(
        batches[0], "xlstm-1.3b", XLSTM_TRAIN_CUT, XLSTM_TRAIN_LEAVES,
        "train xlstm")}
    log("[train xlstm] first step " + json.dumps(out["first_step"]))
    out.update(train_full(batches, "xlstm-1.3b", XLSTM_TRAIN_SEQ,
                          XLSTM_TRAIN_KERNELS, "train xlstm"))
    expect(out["params"] == XLSTM_PARAMS,
           f"[train xlstm] {out['params']} parameters, "
           f"{XLSTM_PARAMS} expected")
    expect(out["peak_gb"] < 80,
           f"[train xlstm] peak {out['peak_gb']:.2f} GB under 80")
    return out


def train_cfg(grad_dtype="bfloat16"):
    """AdamW (the reference's defaults but a one-step warmup, so that the
    four steps move the weights), full remat."""
    return TS.TrainConfig(optimizer=OPT.OptimizerConfig(warmup_steps=1),
                          remat="full", grad_dtype=grad_dtype)


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def first_step_check(batch, name="recurrentgemma-2b", cut=TRAIN_CUT,
                     leaves=TRAIN_LEAVES, tag="train") -> dict:
    """The first step's loss, grad norm and the named leaves' gradients
    (``leaves``: TRAIN_LEAVES) on the cuda and torch routes, at one unit of
    ``name`` at full width (``cut``: TRAIN_CUT), the same f32 weights from
    SEED and batch, held as
    hold_floor holds logits: both routes in float32 activations and
    gradients compute the same function (within 1e-3 of max|g| of the
    torch route's; the departures are K10 scaling the float32 product, not
    q before it, and sums in another order), and in bf16 each route is a
    rounding of that function, so the two lie within twice the torch
    route's own distance from it.  The loss and grad norm in bf16 within
    1e-2 relative: the loss averages 4,096 tokens' float32 cross entropy
    of bf16 logits (2^-8 a rounding), the norm sums 2.7 billion squares."""
    cfg = dataclasses.replace(get_config(name), **cut)
    out = {"depth": cfg.n_layers}
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    runs = {}
    for gd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=gd)
        for route in ("cuda", "torch"):
            with ki.use_backend(route):
                metrics, grads, spec = TS.value_and_grad(
                    c, train_cfg(gd), params, batch)
            tree = torch.utils._pytree.tree_unflatten(grads, spec)
            runs[gd, route] = {
                "loss": float(metrics["loss"]),
                "grad_norm": float(OPT.global_norm(grads)),
                **{n: leaf(tree, p).float().clone()
                   for n, p in leaves.items()}}
            del metrics, grads, tree
            torch.cuda.empty_cache()
    for n in ("loss", "grad_norm"):
        c32, t32 = runs["float32", "cuda"][n], runs["float32", "torch"][n]
        c, t = runs["bfloat16", "cuda"][n], runs["bfloat16", "torch"][n]
        out[n] = {"f32_cuda": c32, "f32_torch": t32, "cuda": c, "torch": t}
        expect(abs(c32 - t32) <= 1e-4 * abs(t32),
               f"[{tag}] first step {n} in float32: cuda {c32:.6g} vs torch "
               f"{t32:.6g} within 1e-4 relative")
        expect(abs(c - t) <= 1e-2 * abs(t),
               f"[{tag}] first step {n} in bf16: cuda {c:.6g} vs torch "
               f"{t:.6g} within 1e-2 relative")
    for n in leaves:
        f = runs["float32", "torch"][n]
        c32, c, t = (runs[k][n] for k in (("float32", "cuda"),
                                          ("bfloat16", "cuda"),
                                          ("bfloat16", "torch")))
        held = {"max_f32": float(f.abs().max()),
                "f32_cuda_vs_torch": float((c32 - f).abs().max()),
                "cuda_vs_f32": float((c - f).abs().max()),
                "torch_vs_f32": float((t - f).abs().max()),
                "cuda_vs_torch": float((c - t).abs().max())}
        expect(held["f32_cuda_vs_torch"] <= 1e-3 * held["max_f32"],
               f"[{tag}] first step, gradient of {n} in float32: cuda vs "
               f"torch max abs err {held['f32_cuda_vs_torch']:.4g} <= 1e-3 x "
               f"its largest entry {held['max_f32']:.4g}")
        expect(held["cuda_vs_torch"] <= 2 * held["torch_vs_f32"],
               f"[{tag}] first step, gradient of {n} in bf16: cuda vs torch "
               f"max abs err {held['cuda_vs_torch']:.4g} <= 2 x the torch "
               f"route's own error against float32, "
               f"{held['torch_vs_f32']:.4g} (the cuda route's "
               f"{held['cuda_vs_f32']:.4g})")
        out[n] = held
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The kernels a profiled train step breaks out, by their device events'
# names (mangled or not): K10's forward (rt::flash's attend), its gradient
# (rt::flash_bwd's rows, dq and dkv kernels; each launch apart too), the
# stabilizer's gradient, linear_recurrence's gradient (every kernel of
# linrec_grad.cuh, tile_scan.cuh's scan_totals over its maps too).
STEP_KERNELS = {
    "K10": lambda n: "flash" in n and "attend" in n and "flash_bwd" not in n,
    "K10-bwd": lambda n: "flash_bwd" in n,
    **{f"K10-bwd {x}": (lambda n, x=x: "flash_bwd" in n and
                        f"{x}_kernel" in n) for x in ("rows", "dq", "dkv")},
    "MAXPLUS-grad": lambda n: "maxplus_grad" in n,
    "K6-grad": lambda n: "linrec_grad" in n,
}
TRAIN_KERNELS = ("K6", "K6-grad", "K10", "K10-bwd")


def train_full(batches, name="recurrentgemma-2b", seq=TRAIN_SEQ,
               kernels=TRAIN_KERNELS, tag="train") -> dict:
    """``name`` FULL (recurrentgemma-2b: 26 layers) from f32 master
    weights of SEED: one AdamW step a batch of ``batches`` (one sequence of
    ``seq`` tokens), bf16 activations and gradients, full remat, the cuda
    backend.  Each step's loss and grad norm finite; its wall ms, tokens/s,
    peak memory and the launches of ``kernels`` (each launched); the third
    step profiled (device ms and idle share, and the device ms of K10, its
    gradient, the stabilizer's gradient and K6's: STEP_KERNELS).  Per
    recurrentgemma step K6 runs 34 times (18 RG-LRU layers, the 16 of the 8
    units again under remat), its gradient 18, K10 16 (8 local layers,
    twice) and its gradient 8."""
    cfg = get_config(name)
    tc = train_cfg()
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, tc, device="cuda")
    n_params = lm.count_params(state["params"])
    state_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, {n_params} f32 "
        f"parameters, state {state_gb:.2f} GB (params, mu, nu)")
    step_fn = TS.make_train_step(cfg, None, tc)
    steps, launches = [], {}
    for i in range(len(batches)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if i == 2:
            box = {}
            prof = device_busy(lambda: box.update(
                out=step_fn(state, batches[i])), STEP_KERNELS)
            state, metrics = box["out"]
        else:
            state, metrics = step_fn(state, batches[i])
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        launches = {k: launches.get(k, 0) + v for k, v in c.items()}
        row = {"step": i, "loss": loss, "grad_norm": gnorm,
               "lr": float(metrics["lr"]), "wall_ms": wall * 1e3,
               "tokens_per_s": seq / wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {k: c[k] for k in kernels}}
        if i == 2:
            row["profile"] = prof
        steps.append(row)
        log(f"[{tag}] step {i}: " + json.dumps(row))
        expect(math.isfinite(loss) and math.isfinite(gnorm),
               f"[{tag}] step {i}: loss {loss:.5f} and grad norm "
               f"{gnorm:.4f} finite")
        for k, n in row["launches"].items():
            expect(n > 0, f"[{tag}] step {i}: {k} launched {n} times")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers, "params": n_params,
            "state_gb": state_gb, "seq_len": seq, "steps": steps,
            "peak_gb": max(s["peak_gb"] for s in steps),
            "launches": launches}


def train_smoke_trainer() -> dict:
    """The Trainer at recurrentgemma-2b SMOKE size on the card, in a
    temporary directory: a fault injected at step 6 is recovered from the
    newest checkpoint; a run cut at step 6 and resumed to 10 ends in the
    state of an uncut 10-step run, to the bit."""
    import tempfile
    cfg = get_config("recurrentgemma-2b", smoke=True)
    tc = TS.TrainConfig(optimizer=OPT.OptimizerConfig(
        peak_lr=1e-2, warmup_steps=5, decay_steps=100), remat="full")
    data = SyntheticDataset(DataConfig(seq_len=64, global_batch=4,
                                       vocab_size=cfg.vocab_size), cfg)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        boom = {"armed": True}

        def fault(step):
            if step == 6 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected fault")

        run = RunConfig(total_steps=12, ckpt_dir=os.path.join(tmp, "fault"),
                        ckpt_every=4, log_every=100)
        t = Trainer(cfg, None, tc, run, data, fault_hook=fault)
        state = t.run()
        out["recoveries"] = t.recoveries
        expect(t.recoveries == 1 and int(state["step"]) == 12,
               f"[trainer] smoke: the fault at step 6 recovered "
               f"({t.recoveries} recovery), ended at step "
               f"{int(state['step'])}")
        run = RunConfig(total_steps=6, ckpt_dir=os.path.join(tmp, "cut"),
                        ckpt_every=3, log_every=100)
        Trainer(cfg, None, tc, run, data).run()
        run.total_steps = 10
        resumed = Trainer(cfg, None, tc, run, data).run()
        run = RunConfig(total_steps=10, ckpt_dir=os.path.join(tmp, "uncut"),
                        ckpt_every=3, log_every=100)
        uncut = Trainer(cfg, None, tc, run, data).run()
        la = torch.utils._pytree.tree_leaves(resumed)
        lb = torch.utils._pytree.tree_leaves(uncut)
        differ = sum(not torch.equal(x, y) for x, y in zip(la, lb))
        out["resume_leaves_differing"] = differ
        expect(len(la) == len(lb) and differ == 0,
               f"[trainer] smoke: cut at 6 and resumed to 10 equals the "
               f"uncut run to the bit ({differ} of {len(la)} leaves differ)")
    return out


def phase_train(res) -> dict:
    """Phase 14, after the serve phases have freed their models."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check_k10_bwd(res)
    check_k6_grad(res)
    cfg = get_config("recurrentgemma-2b")
    data = SyntheticDataset(DataConfig(seq_len=TRAIN_SEQ, global_batch=1,
                                       vocab_size=cfg.vocab_size), cfg)
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    summary = {"first_step": first_step_check(batches[0])}
    log("[train] first step " + json.dumps(summary["first_step"]))
    summary.update(train_full(batches))
    expect(summary["peak_gb"] < 80,
           f"[train] peak {summary['peak_gb']:.2f} GB under 80")
    summary["trainer"] = train_smoke_trainer()
    summary["xlstm"] = train_xlstm(res)
    summary["phase_s"] = time.perf_counter() - t0
    log(f"[train] phase 14 took {summary['phase_s']:.1f} s; " + json.dumps(
        {k: v for k, v in summary.items()
         if k not in ("steps", "launches", "xlstm")}))
    log("[train xlstm] " + json.dumps(
        {k: v for k, v in summary["xlstm"].items()
         if k not in ("steps", "launches")}))
    return summary


# ---------------------------------------------------------------------------
# Phase 15: the autotuner
# ---------------------------------------------------------------------------

TUNE_REPEATS = 10          # calls a candidate's CUDA-event timing spans


def tune_cases(gen) -> list:
    """(label, route, args, kwargs, the public call, the plain version's
    answer, tolerance) of each tuned route at a served or paper shape; a
    tolerance of 0 is bit for bit: integer data, or small integers whose
    float32 sums and products are exact in any order."""
    dev = "cuda"

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    x1 = torch.randn(10**8, generator=gen, device=dev)
    x2 = small_ints(gen, 10**7)
    x3 = ints(10**8)
    x7m = ints(8, 1 << 24)
    x7s = small_ints(gen, 4 * 64).reshape(4, 64)
    x8 = ints(10**7)
    offs = csr_offsets(gen, 10**7, 1000)
    A = small_ints(gen, BIG_BATCHED[0] * BIG_BATCHED[1] * BIG_BATCHED[2]
                   ).reshape(BIG_BATCHED)
    xv = small_ints(gen, BIG_BATCHED[0] * BIG_BATCHED[1]).reshape(
        BIG_BATCHED[:2])
    a = torch.empty(1, 1024, 2560, device=dev).uniform_(0.9, 0.999,
                                                        generator=gen)
    b = torch.randn(1, 1024, 2560, generator=gen, device=dev)
    keys = torch.randint(0, 2**32, (10**6,), generator=gen, device=dev,
                         dtype=torch.int64)
    keys_u = keys.to(torch.uint32)
    seg = Segmented(offsets=offs)
    TM, ID = alg.TIMES, alg.IDENTITY
    return [
        ("K1", "copy@flat", (x1,), {"nitem": None},
         lambda: forge.copy(x1), x1, 0),
        ("K2", "scan@flat", (alg.ADD, x2),
         {"axis": 0, "inclusive": True, "reverse": False},
         lambda: forge.scan(alg.ADD, x2),
         scan_k.scan_1d_plain(alg.ADD, x2), 0),
        ("K3", "mapreduce@flat", (ID, alg.ADD, x3), {"axis": None},
         lambda: forge.mapreduce(ID, alg.ADD, x3),
         mapreduce_k.mapreduce_1d_plain(ID, alg.ADD, x3), 0),
        ("K7m", "mapreduce@batched", (ID, alg.ADD, x7m), {},
         lambda: forge.mapreduce(ID, alg.ADD, x7m, layout=Batched()),
         batched_k.batched_mapreduce_plain(ID, alg.ADD, x7m), 0),
        ("K7s", "scan@batched", (alg.ADD, x7s),
         {"inclusive": True, "reverse": False},
         lambda: forge.scan(alg.ADD, x7s, layout=Batched()),
         batched_k.batched_scan_plain(alg.ADD, x7s), 0),
        ("K8", "scan@segmented", (alg.ADD, x8),
         {"inclusive": True, "flags": None, "offsets": offs},
         lambda: forge.scan(alg.ADD, x8, layout=seg),
         seg_k.segmented_scan_1d_plain(
             alg.ADD, x8, seg_k.offsets_to_flags(offs, x8.shape[0])), 0),
        ("K7-matvec", "matvec@batched", (TM, alg.ADD, A, xv), {},
         lambda: forge.matvec(TM, alg.ADD, A, xv, layout=Batched()),
         batched_k.batched_matvec_plain(TM, alg.ADD, A, xv), 0),
        ("K7-vecmat", "vecmat@batched", (TM, alg.ADD, A, xv), {},
         lambda: forge.vecmat(TM, alg.ADD, A, xv, layout=Batched()),
         batched_k.batched_vecmat_plain(TM, alg.ADD, A, xv), 0),
        ("K6", "linear_recurrence@batched", (a, b),
         {"h0": None, "reverse": False},
         lambda: forge.linear_recurrence(a, b, layout=Batched()),
         scan_k.scan_channel_plain(alg.AFFINE, (a, b))[1], 1e-5),
        ("sort", "sort@flat", (keys_u,),
         {"descending": False, "key_bits": None},
         lambda: forge.sort(keys_u),
         torch.sort(keys).values.to(torch.uint32), 0),
    ]


def held(got, want, tol) -> float:
    """max|got - want|, over max|want| where ``tol`` is not 0."""
    err = max_err(got, want)
    return err if not tol else err / float(want.double().abs().max())


def phase_tune(gen) -> dict:
    """Phase 15: the autotuner on a temporary cache file, route by route
    (tune_cases).  The untuned call's launches first (the tuner off); then
    the first call with the tuner on races the route's ladder; every
    candidate's output is held to the plain version; the winner's time
    beside the untuned call's in turns; a second call is a cache hit with
    the launches of one call at the winner's policy (the untuned call's,
    but for a sort whose winner has another digit width), and so is a
    fresh Autotuner's first call on the same file."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning.json")
        for label, route, args, kw, call, want, tol in tune_cases(gen):
            spec = tuning.TUNABLE[route]
            base = ki.resolve_tuning()
            tuning.disable()
            reset_counts()
            call()
            torch.cuda.synchronize()
            untuned = read_counts()
            tuner = tuning.enable(path, bench_repeats=TUNE_REPEATS)
            err = held(call(), want, tol)
            race = tuner.last_race
            expect(tuner.stats["benchmarks"] == 1 and race is not None and
                   len(race["candidates"]) == len(spec.candidates) and
                   err <= tol,
                   f"[tune] {label} {route}: the first call raced "
                   f"{len(race['candidates'])} of {len(spec.candidates)} "
                   f"candidates; its answer's err {err:.3g} <= {tol}")
            impl = ki.resolve_impl(route, "cuda")
            errs = {}
            for ov in spec.candidates:
                policy = dataclasses.replace(base, **ov)
                errs[json.dumps(ov)] = held(impl(*args, **kw, policy=policy),
                                            want, tol)
            expect(max(errs.values()) <= tol,
                   f"[tune] {label}: every candidate held to the plain "
                   f"version within {tol}: {errs}")
            winner = dataclasses.replace(base, **race["winner"])
            turns = time_turns({
                "untuned_ms": lambda: impl(*args, **kw, policy=base),
                "tuned_ms": lambda: impl(*args, **kw, policy=winner)},
                rounds=5, reps=20)
            reset_counts()
            impl(*args, **kw, policy=winner)
            torch.cuda.synchronize()
            at_winner = read_counts()
            reset_counts()
            call()
            torch.cuda.synchronize()
            hit = read_counts()
            # The sort's digit width sets its count of passes, so a winner
            # of another width launches another count than the default.
            expect(tuner.stats == {**tuner.stats, "benchmarks": 1,
                                   "hits": 1} and hit == at_winner,
                   f"[tune] {label}: a second call hits the cache "
                   f"({tuner.stats}) with the launches of one call at the "
                   f"winner's policy, no race (the default policy's too: "
                   f"{hit == untuned})")
            fresh = tuning.enable(path, bench_repeats=TUNE_REPEATS)
            call()
            expect(fresh.stats["benchmarks"] == 0 and
                   fresh.stats["hits"] == 1,
                   f"[tune] {label}: a fresh tuner on the same file hits "
                   f"({fresh.stats})")
            row = {"route": route, "key": race["key"],
                   "candidates_ms": {k: v * 1e3 for k, v in
                                     race["candidates"].items()},
                   "winner": race["winner"], "built": race["built"],
                   "build_s": race["build_s"], "errs": errs, **turns,
                   "tuned_over_untuned": turns["tuned_ms"]
                   / turns["untuned_ms"]}
            out[label] = row
            log(f"[tune] {label} " + json.dumps(row))
    tuning.disable()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[tune] phase 15 took {out['phase_s']:.1f} s")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    try:
        build = phase_build()
        res = phase_kernels(gen)
        prims = phase_primitives(res, gen)
        cfg, params, prompts = load_model()
        serve = phase_serve(cfg, params, prompts, buckets="pow2")
        sampled = phase_sampled(cfg, params, prompts)
        del params
        gemma2 = phase_model("gemma2-27b", "gemma2", GEMMA2_PARAMS,
                             floor=False, buckets="pow2",
                             after=phase_strategies)
        xlstm = phase_xlstm()
        models = {tag: phase_model(name, tag, n) for name, tag, n in MODELS}
        models["deepseek"] = phase_deepseek()
        models["seamless"] = phase_seamless(gen)
        train = phase_train(res)
        tuned = phase_tune(gen)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    lazy = [d for d in _lib._LOADED if d not in build["prebuilt"]]
    log(f"[build] {len(lazy)} units built during the run, not up front"
        + (f": {lazy}" if lazy else ""))
    # Phase 13's runs and the bucketed runs of phases 4, 6 and 7.
    slice16 = {**gemma2["after"]["runs"],
               "bucketed_greedy": serve["bucketed"],
               "bucketed_gemma2": gemma2["bucketed"],
               "bucketed_xlstm": xlstm["bucketed"]}
    kernels = []
    for k, r in res.items():
        name, source, replaces = META[k]
        paths = {"primitives": prims, "greedy": serve, "sampled": sampled,
                 "gemma2": gemma2, "xlstm": xlstm, **models, **slice16,
                 "train": train, "train_xlstm": train["xlstm"]}
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": paths[MAIN_PATH[k]]["launches"][k],
            "launches_path": MAIN_PATH[k],
            "launches_total": sum(p["launches"][k] for p in paths.values()),
            "launches_primitives": prims["launches"][k],
            "launches_greedy": serve["launches"][k],
            "launches_sampled": sampled["launches"][k],
            "launches_gemma2": gemma2["launches"][k],
            "launches_xlstm": xlstm["launches"][k],
            **{f"launches_{tag}": m["launches"][k]
               for tag, m in {**models, **slice16, "train": train,
                              "train_xlstm": train["xlstm"]}.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"]})
        for extra in ("public_ms", "paper_worst", "device_ms", "rows",
                      "xlstm", "shapes", "units", "autograd_ms"):
            if extra in r:   # the public call at the same shape; the worst
                kernels[-1][extra] = r[extra]    # Table V/VI row's ratio;
                # the kernel alone (torch.profiler) where the host's launch
                # takes longer; K7m's timed rows; K6's at xLSTM's shapes;
                # K10's at each served model's prefill layers; K10-bwd's
                # units and bodies; the stabilizer gradient through autograd
        if k in ("K7m", "K6-grad"):     # by kind or form, per path
            kernels[-1]["launches_kinds"] = {
                path: {x.split()[1]: v for x, v in p["launches"].items()
                       if x.startswith(f"{k} ")} for path, p in paths.items()}
        for form in FORMS:              # the small form's share, per path
            if form.startswith(f"{k} "):
                kernels[-1]["launches_" + form.split()[1]] = {
                    path: p["launches"][form] for path, p in paths.items()}
    log("[tune] " + json.dumps({k: {x: v[x] for x in (
        "winner", "untuned_ms", "tuned_ms", "tuned_over_untuned")}
        for k, v in tuned.items() if k != "phase_s"}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
