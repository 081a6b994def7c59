"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:
  1. environment: card, power limit, versions; build the CUDA kernels from
     src/repro_torch/kernels/csrc/ (one nvcc per source, in parallel),
     print ptxas' registers and spills and each library's count of HMMA
     (mma.sync), HGMMA (wgmma) and UTMALDG (TMA load) instructions: HMMA
     must not be 0 for WKV6 (its 3xTF32 products) and its backward, nor
     HGMMA and UTMALDG for flash attention and its backward (their Hopper
     bf16 bodies at every head dim), and the attention backward must have
     no HMMA (no mma.sync body is left in it) and no spill; WKV6's
     training forward's summaries and its chunked body must have HMMA in
     their own SASS, and none of its three kernels may spill;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes and in windowed, ragged, 3-D layout, hd 32 and 128,
     fp32, many-split, poisoned-cache and carried-state cases (flash
     attention also at S=333, not a multiple of its 128-row tile, with a
     window edge inside a tile, at hymba-1.5b's query group of 5; its bf16
     cases asserted to run the Hopper body, and every forward case run
     twice, bit-equal), with its
     time beside the plain version's and one PyTorch library call's where
     one computes the same function; flash decode is also timed at batch 1
     against a 32,768-slot cache; WKV6 also at its chunk edges (S of T-1,
     T, T+1, 2T+3, and S of 1 and 2 in the token body), with decays in
     the model's range and with exact 0s and 1s, a decay-one-step-late
     mutant; its token body at S of 1, 2 and T-1 at hd 16, 32 and 64, from
     a state and from zero, in place in a stacked cache's layer slice; and
     timed at the decode shape (B=4, S=1, H=40, hd=64) L2-warm and, walking
     the 32 layers of a (32, 4, 40, 64, 64) cache past the L2, cold; the
     fused Mamba scan (dt's softplus, the
     scan, the skip term, the gating) in bf16 and fp32 at hymba's serving
     prefill (B=4, S=4096, di=1600, n=16) from a zero and a carried state,
     at the decode shape (S=1) in place in a stacked state (its state
     bit-equal to the plain loop's), and on both sides of its body switch
     at the chunked body's tile edges (S of T-1, T, T+1, 2T+3), with two
     mutants (a decay one step late, the epilogue without d_skip), timed
     beside its plain version and its bound at the prefill and the decode
     shape; then both
     attention kernels at hd 96, 80 and 160, at the serving shapes of
     phi3-mini-3.8b (MHA), h2o-danube-1.8b (GQA 4x, 5120 tokens past its
     4096-token window, a full ring in decode) and pixtral-12b (GQA 4x),
     and at hymba-1.5b's (hd 64, 25/5 heads: a query group of 5, 4096
     tokens past its 1024-token window, a full ring in decode), bf16 and
     fp32, each with a mutant and timed beside its plain version, SDPA and
     its bound;
  3. serve each model of SERVED at full width and full depth (bf16, random
     weights from a seed) through Engine.generate: 4 requests, 32 new
     tokens, greedy; qwen3-8b (36 layers, d_model 4096) with 512 prompt
     tokens, rwkv6-3b (32 layers, d_model 2560) with 1024, phi3-mini-3.8b
     with 512, h2o-danube-1.8b with 5120 (past its window: the windowed
     prefill and the ring cache), moonshot-v1-16b-a3b (MoE, 64 experts
     top-6, 48 layers, 56 GB) with 512 and hymba-1.5b (hybrid: attention
     and Mamba heads side by side in each of 32 layers, d_model 1600)
     with 4096, 4x past its window; then the stub-frontend models of
     STUB_SERVED, which Engine refuses, through prefill and 32
     decode_steps fed embeddings made from the seed as train/data.py makes
     them: pixtral-12b (hd 160) and musicgen-large. The kernels' launch
     counters are zeroed just before and read just after, and must show
     one launch per layer of the model's prefill kernel and one per layer
     and decode step of its decode kernel (rwkv6: the same WKV6 kernel;
     hymba: and one of the Mamba scan per layer in both, its chunked body
     in prefill and its token body in decode), and none of the other
     kernels. A profile of one prefill (summed by kind of kernel)
     and one decode step shows where the device time goes, and their own
     counts must be one launch per layer. Then the prefill
     logits and three decode steps fed the same inputs, through the
     kernels and through impl="reference" (the plain versions, on the
     card), in bf16 and with the weights widened to fp32, must agree
     (compare_paths; where the fp32 copy of every layer does not fit
     beside the bf16 weights, at the first layers that fit; for MoE it
     prints the share of (token, layer) expert choices on which the two
     paths agree). Each model's weights are freed before the next;
  3b. every config at full width and depth 1, fp32: a prefill of 4 x
     SWEEP_LEN positions and 3 decode steps through the kernels (their
     launches counted) against the plain versions; arctic-480b's one layer
     (128 experts top-2 beside a dense residual) is 56 GB in fp32;
  4. small fp32 models (dense, MoE, RWKV and hybrid) served on the card
     and on the CPU must agree;
  5. training, after the served models are freed: the flash attention
     backward (FlashAttentionFn: the training forward, which also writes
     each row's log-sum-exp, and the backward kernels) against autograd
     through the plain version at the serving shape and at the training
     shapes of qwen3-8b (B=2, S=4096, 32/8 heads), hymba-1.5b (B=4,
     25/5 heads of 64, window 1024), moonshot-v1-16b-a3b (B=2, 16/16
     heads of 128), phi3-mini-3.8b (B=2, 32/32 heads of 96),
     h2o-danube-1.8b (B=4, 32/8 heads of 80, window 4096), pixtral-12b
     (B=1, 32/8 heads of 160) and musicgen-large (B=2, 32/32 heads of
     64), fp32 and bf16, with two mutants of the plain backward that must
     fail, bf16 asserted to run the Hopper (wgmma, TMA) bodies at each of
     them; the
     backward kernels against their plain version (flash_attention_bwd
     given the forward's out and log-sum-exp), two runs bit-equal, and
     timed beside it, beside the old torch-ops backward and SDPA's (causal
     where the window covers S), at each training shape; the kernel's bf16
     forward (the Hopper body, asserted) and log-sum-exp against their
     plain versions at qwen3-8b's, phi3's, h2o-danube's and pixtral's
     training shapes, two runs bit-equal, with the temperature mutant;
     qwen3-8b
     trained at full width
     and depth 8 (AdamW, bf16, 4 microbatches of 2 x 4096 tokens)
     through train_step, a warm-up step and 3 timed ones,
     each with its loss, grad norm, time, tokens/s, share of the step's
     bound (train_mfu) and peak memory, its launch counts (2 flash
     attention launches per layer and microbatch with remat and 1 of the
     attention backward, no other kernel's; the torch-ops backwards
     called 0 times) and a profile of one step; the first microbatch's loss and
     grads at depth 2 through the kernels and the plain versions, bf16 and
     fp32 (bf16 held by its mean loss, its tokens' losses, grad norm, the
     embedding's gradient and the other leaves' apart);
     run_training at the tiny preset on the card, 6 straight steps
     against 3, a commit, a resume and 3 more. The recurrences train
     through Wkv6Fn and MambaScanFn (the training forwards one C call a
     layer, WKV6's every 256-token chunk in flight at once, the scan's one
     launch writing each chunk's start state; the backwards the WKV6 and
     the Mamba scan backward kernels, one C call each): both held to
     autograd through the plain
     loops at full width across two chunks (WKV6 fp32, the scan fp32 and
     bf16), each with a mutant that does not carry the state's gradient
     across a chunk (its backward kernel run chunk by chunk); each
     backward kernel against its plain version (wkv6_bwd, with the
     model's decays and with exact 0s and 1s; mamba_scan_bwd in bf16;
     then both at B=1 over a ragged 1068 steps from a given final-state
     gradient, and the scan at n=8 in fp32; two runs bit-equal in every
     case); each forward at its model's training microbatch against the
     plain version chunk by chunk (y or out, the final state and every
     chunk's start; WKV6 also with exact 0 and 1 decays, the scan bit for
     bit against its kernel launched once a chunk), with two mutants of
     the starts that must fail (the carry without the fade, the starts
     one chunk late); each forward and backward timed at its model's
     training microbatch; rwkv6-3b and hymba-1.5b trained at full width
     and full depth as qwen3-8b is (their WKV6, Mamba scan, flash
     attention and backward kernel launches a step asserted, the
     torch-ops backwards called 0 times, and a nonzero gradient on every
     leaf that feeds a recurrence), each profiled over one microbatch;
     and their kernel and plain paths at depth 2, 2 x 2048 tokens, with
     rwkv6-3b's plain path also run in fp64 and each fp32 path's distance
     from it printed; phi3-mini-3.8b (32 layers, d_model 3072, MHA 32
     heads of 96) and h2o-danube-1.8b (24 layers, d_model 2560, GQA 32/8
     heads of 80, window 4096) trained at full width and full depth as
     qwen3-8b is (128 and 48 attention backward launches a step), their
     kernel and plain paths compared at depth 2 at their training
     microbatches; the stub-frontend family, fed embeddings made from the
     seed as train/data.py makes them: pixtral-12b (d_model 5120, GQA
     32/8 heads of 160) at depth 9 of 40, the largest whose step's peak
     phase 7 predicts at most 70 GB (8 microbatches of 1 x 4096), and
     musicgen-large (MHA 32 heads of 64) at its full 48 layers (4 of 2 x
     4096), trained as qwen3-8b is (72 and 192 attention backward launches
     a step, a nonzero gradient on every leaf but the unread token table,
     whose gradient is 0) and compared at depth 2 at their microbatches.
     moonshot-v1-16b-a3b
     (MoE, 64 experts top-6) is trained as qwen3-8b is, at depth 4 of 48
     (47.3 GB of state), with a profile of one microbatch that splits the
     MoE layer's device time into routing, one-hot and scan, scatter,
     gather and the expert bmms, and its kernel and plain paths compared
     at depth 2 with the bf16 paths routed as the fp32 plain path; then
     (5f) its group-local dispatch (``set_moe_groups``) against the flat
     one at depth 1 in fp32: equal drop-free, different at cf 1.25;
  6. the sharded path on a one-card (1, 1) mesh: an NCCL process group of
     one rank, ``make_local_mesh(1, 1)``, the sharding context set from
     it; qwen3-8b (6a, 6b), then rwkv6-3b, hymba-1.5b,
     moonshot-v1-16b-a3b and pixtral-12b (6c-6j), each trained one step
     at depth 2 on ``shard_tree(state, state_specs)`` and served on
     ``param_specs(mode="serve")`` with ``cache_specs`` caches (at full
     depth and their served prompt lengths, but moonshot at depth 4,
     where both copies of the weights fit), each against the unsharded
     run of the same weights:
     loss, grad norm and updated parameters, greedy ids and logits, every
     cache and recurrent state after the last decode step, and equal
     launch counts of every kernel (WKV6 and the Mamba scan under their
     Functions in training; the scan's token-body launches in decode),
     with the host-clock time of each step and run; the process group
     is destroyed after. One card moves no data between cards: this
     proves NCCL, DTensor dispatch and the kernels on local shards, not
     communication, nor the recurrent states' write-back (a redistribute
     across a mesh dim of size 1 keeps the local tensor, as torch 2.13
     does on the CPU, so the kernels write the caches in place; the CPU
     tests' 2 x 2 mesh holds the write-back);
  7. the roofline against the card: every model served in phase 3 and
     trained in phase 5, counted again on meta tensors at the shapes it
     ran (repro_torch.roofline; a train step at depths 1 and 2,
     extrapolated over its identical layers), its roofline terms printed
     beside the measured prefill ms, decode ms/token and step ms; the
     counted flops must hold serve_bounds' and train_bound's parts to
     FLOPS_TOL once the named cases where the path does more work are
     added from the shapes (remat, the MoE capacity rows, the backward
     kernels' recompute; decode attention is reported), the decode
     step's counted bytes must reach the bound's, and the predicted peak
     must be within PEAK_TOL of torch.cuda.max_memory_allocated(); then
     one decode_32k cell a family on the (16, 16) fake mesh, in a
     subprocess, its rows written under build/dryrun_rows/. The backward
     kernels' flops are held too: attention's seven products where the
     bound counts four (its dQ kernel recomputes S and dP), WKV6's and
     the scan's vjp plus the forward each recomputes.
Each phase prints its wall time, and the run its total. The last lines
are a JSON line of per-kernel numbers (the backward kernels' entries
also carry "torch_ops_ms", the torch-ops backward the card ran before
them; flash attention at the qwen3-8b
serving shape with the served prefill's launches, "flash_attention_train" at the training shape
with the timed train steps' launches, "wkv6_train" and "mamba_scan_train"
at rwkv6-3b's and hymba-1.5b's training microbatch with their timed train
steps' launches, "flash_attention_bwd" at qwen3-8b's training shape and
"_hymba", "_moonshot" at those models', "wkv6_backward" at rwkv6-3b's,
"mamba_scan_bwd" at hymba-1.5b's, "_phi3" and "_danube" for both the
backward and the training forward at those models' training shapes,
"_pixtral" for both at pixtral-12b's (hd 160) and "_musicgen" for the
backward at musicgen-large's, each with its model's timed train steps'
launches, both attention kernels
once more for
each of hd 96, 80 and 160, "_hd<n>", and for hymba's group of 5,
"_hymba", at the shape and with the launches of the model served there,
and the recurrences by body: "wkv6" at rwkv6-3b's serving prefill with
its chunked body's launches and "wkv6_decode" at S=1 with its token
body's (and "cold_ms", the token body's time a layer over a 32-layer
cache past the L2), both from rwkv6-3b's run; "mamba_scan" at hymba's
serving prefill with its chunked body's launches and
"mamba_scan_decode" at S=1 with its token body's, both from hymba's
run), the
card's name and power limit from nvidia-smi, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
# the models served in phase 3 through Engine.generate, each with its prompt
# length: rwkv6's recurrence is sequential in time, so its users' long
# prompts set the kernel's critical path; h2o-danube's users bring prompts
# longer than its 4096-token window; hymba's users run it for long prompts
# (its SSM state and 1024-token window keep decode cost flat), 4x past its
# window
SERVED = {"qwen3-8b": 512, "rwkv6-3b": 1024, "phi3-mini-3.8b": 512,
          "h2o-danube-1.8b": 5120, "moonshot-v1-16b-a3b": 512,
          "hymba-1.5b": 4096}
# stub-frontend models, which Engine refuses (they take embeddings): served
# through prefill and decode_step
STUB_SERVED = {"pixtral-12b": 512, "musicgen-large": 512}
# attention shapes beyond qwen3-8b's, {JSON suffix: model}: the head dims
# the kernels gained for phi3, h2o-danube and pixtral, and hymba's query
# group of 5 (25 heads over 5 KV heads, window 1024); each checked at its
# model's serving shape (phase 2), its launches counted where that model is
# served (phase 3)
ATTENTION_SHAPES = {"hd96": "phi3-mini-3.8b", "hd80": "h2o-danube-1.8b",
                    "hd160": "pixtral-12b", "hymba": "hymba-1.5b"}
SWEEP_LEN = 256                      # phase 3b's prompt length
REQUESTS, MAX_NEW = 4, 32
PROMPT_LEN = SERVED["qwen3-8b"]      # the attention kernels' checks
# rwkv6-3b's layers: its decode step walks one state slice a layer of a
# (32, 4, 40, 64, 64) fp32 cache, 84 MB, past the 50 MB L2
DECODE_LAYERS = 32
RWKV_HEADS, RWKV_HD = 40, 64         # rwkv6-3b: d_model 2560 in heads of 64
MAMBA_DI, MAMBA_N = 1600, 16         # hymba-1.5b: 25 x 64 channels, state 16
# the Mamba token body's cold time walks one state slice a layer of a
# (192, 4, 1600, 16) fp32 stack, 78.6 MB, past the 50 MB L2 (hymba's own
# 32 layers, 13.1 MB, would fit in it)
MAMBA_COLD_LAYERS = 192
# the Mamba scan against its plain version: the fp32 limits the tests hold
# JAX's scans to (atol 2e-5, rtol 1e-4), and REL_TOL's relative L2
SCAN_ATOL, SCAN_RTOL = 2e-5, 1e-4
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: max abs error (atol = rtol), and relative L2
# error a few times above what rounding the output to the dtype gives
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# Q and K are drawn at this scale, so scores have a std of QK_SCALE ** 2 and
# the softmax is peaked: a near-uniform one would make every output close
# to the mean of V, whatever the kernel did with the scores
QK_SCALE = 1.5
# a wrong softmax temperature by this factor, or a decay raised to this
# power, must fail REL_TOL (mutant checks)
MUTANT_TEMP = 1.02
# full-width logits against an fp32 run of the same weights (compare_paths)
FP32_REL_TOL = 1e-4
BF16_ERR_RATIO = 1.1
# phase 5: models trained at full width, each at the depth whose state
# fits one card's 80 GB (16 bytes a parameter: bf16 weights and grads, the
# fp32 accumulator, m and v): qwen3-8b cut to 8 of its 36 layers (44.6 GB
# against 131 GB at full depth), moonshot-v1-16b-a3b to 4 of its 48 (47.3
# GB: its embedding and LM head hold 0.335 B parameters each, each layer
# 0.570 B), rwkv6-3b (49.2 GB), hymba-1.5b (22.4 GB), phi3-mini-3.8b (32
# layers, a step's peak 64.31 GB predicted on meta) and h2o-danube-1.8b
# (24 layers, 34.10 GB predicted) at full depth; the stub-frontend family:
# pixtral-12b at the largest depth whose step's peak, as phase 7 predicts
# it on meta, is at most 70 GB: 9 of its 40 layers (67.96 GB predicted;
# 72.6 at 10; its unread token table and LM head hold 0.671 B parameters
# each, each layer 0.286 B), musicgen-large at full depth (48 layers,
# 57.96 GB predicted); TRAIN_4K's 4096 tokens a sequence, TRAIN_BATCH of
# its 256 sequences a step (the run's time limit) in each config's
# grad_accum microbatches (qwen3-8b, moonshot, rwkv6-3b and
# phi3-mini-3.8b: 4 of TRAIN_MICRO; hymba-1.5b, h2o-danube-1.8b and
# musicgen-large: 2 of 4; pixtral-12b: 8 of 1)
TRAINED = {"qwen3-8b": 8, "moonshot-v1-16b-a3b": 4, "rwkv6-3b": 32,
           "hymba-1.5b": 32, "phi3-mini-3.8b": 32, "h2o-danube-1.8b": 24,
           "pixtral-12b": 9, "musicgen-large": 48}
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 8, 2
# the kernel path against the plain one at depth 2, (model, S, B): qwen3-8b,
# moonshot, phi3-mini-3.8b, h2o-danube-1.8b, pixtral-12b and
# musicgen-large at their training microbatches; rwkv6-3b and hymba-1.5b
# at 2048 tokens (8 of the 256-step remat chunks, twice hymba's window),
# where the plain loops' 2048 steps under autograd take seconds, not
# minutes
COMPARED = (("qwen3-8b", TRAIN_SEQ, TRAIN_MICRO),
            ("moonshot-v1-16b-a3b", TRAIN_SEQ, TRAIN_MICRO),
            ("rwkv6-3b", 2048, 2), ("hymba-1.5b", 2048, 2),
            ("phi3-mini-3.8b", TRAIN_SEQ, TRAIN_MICRO),
            ("h2o-danube-1.8b", TRAIN_SEQ, 4), ("pixtral-12b", TRAIN_SEQ, 1),
            ("musicgen-large", TRAIN_SEQ, 2))
# models whose depth-2 comparison also runs the plain path in fp64, to tell
# which fp32 path carries the gap between them (ROADMAP.md queue 3, n)
FP64_COMPARED = ("rwkv6-3b",)
# phase 5f, the grouped MoE dispatch against the flat one: moonshot at
# depth 1 in fp32, GROUPED_SHAPE (B, S), MOE_GROUPS groups; drop-free
# (cf = E) its capacity buffers are E / 1.25 = 51x the served ones, which
# bounds the microbatch: 2 x 1024 tokens
GROUPED_SHAPE, MOE_GROUPS = (2, 1024), 4
# phase 6, the sharded path on a (1, 1) mesh: qwen3-8b trained one step at
# depth SHARDED_TRAIN_DEPTH ((B, S) a microbatch, grad_accum microbatches
# of the config), and served at full depth (PROMPT_LEN and 3 decode steps)
SHARDED_TRAIN_DEPTH, SHARDED_TRAIN_SHAPE = 2, (2, 2048)
# train steps of each run: the first step's host time holds DTensor's
# first sight of each operation, the second is the steady one
SHARDED_STEPS = 2
# then each family beside the dense one, trained as qwen3-8b is and served
# at {model: depth (None: full depth)} with its SERVED or STUB_SERVED
# prompt length: moonshot at 4 of its 48 layers, where the unsharded and
# the sharded weights both fit one card (56 GB each at full depth);
# pixtral's 24.5 GB fit twice at full depth
SHARDED_FAMILIES = {"rwkv6-3b": None, "hymba-1.5b": None,
                    "moonshot-v1-16b-a3b": 4, "pixtral-12b": None}
# the recurrence backwards against the plain loops: two remat chunks
RECURRENT_CHECK_SEQ = 512
# the leaves that feed each recurrence, which must all get a gradient
RECURRENT_LEAVES = {"tmix": ("w_r", "w_k", "w_v", "w_lora_a", "w_lora_b",
                             "w0", "bonus_u"),
                    "mamba": ("dt_a", "dt_b", "dt_bias", "a_log", "d_skip",
                              "w_bc", "conv_w")}
TIMED_STEPS = 3
# the bounds' parts that run in fp32: the recurrences, forward and backward
FP32_PARTS = ("wkv6", "mamba_scan", "Wkv6FnBackward", "MambaScanFnBackward",
              "router")
# bf16 attention gradients through the kernel path, and bf16 training
# paths, against fp32: within this factor of the plain path's own error
# (two bf16 paths round independently; the fp32 checks are the tight ones)
BWD_BF16_RATIO = 2.0
# the depth-2 check's mean loss: the bf16 kernel path's from the bf16 plain
# path's, relative to the fp32 loss. Not a ratio of their errors: each is
# a sum of signed terms that cancel, so the plain path's can sit near 0 by
# chance (pixtral-12b's first microbatch: 4.98e-5 against 1.14e-5). The
# eight compared models' gaps were 3.9e-6 to 3.84e-5 (pixtral-12b)
BF16_LOSS_GAP = 1e-4
# phase 5a: the attention backward at each trained attention model's
# training shape, {JSON suffix: model}: qwen3-8b's GQA 32/8 heads of 128,
# hymba-1.5b's 25/5 heads of 64 with its 1024-token window, moonshot's
# 16/16 heads of 128, phi3-mini-3.8b's 32/32 heads of 96, h2o-danube-1.8b's
# 32/8 heads of 80 with its 4096-token window (every causal pair of a
# 4096-token sequence), pixtral-12b's 32/8 heads of 160 (B=1) and
# musicgen-large's 32/32 heads of 64
ATTENTION_TRAINED = {"": "qwen3-8b", "_hymba": "hymba-1.5b",
                     "_moonshot": "moonshot-v1-16b-a3b",
                     "_phi3": "phi3-mini-3.8b",
                     "_danube": "h2o-danube-1.8b",
                     "_pixtral": "pixtral-12b",
                     "_musicgen": "musicgen-large"}
# the JSON suffixes of ATTENTION_TRAINED whose training forward phase 5a
# also checks and times (hd 128, 96, 80 and 160)
FORWARD_TRAINED = ("", "_phi3", "_danube", "_pixtral")
# the training forward's log-sum-exp against its plain version (natural
# log units; the scores' products sum in other orders)
LSE_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA
    events; warm L2 where the operands fit in it). A spin kernel holds the
    stream while the host queues every call, so the events time the device
    alone and not the host's launch rate; if the host was not done queueing
    when the spin ended, the spin is lengthened and the timing repeated."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cycles in (10 ** 8, 4 * 10 ** 8, 16 * 10 ** 8):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            break
    else:
        log("  (the host could not queue the calls ahead of the device: "
            "the next time includes launch gaps)")
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: dict) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations,
    ``{dtype: flops}``, over the peak rate of each type."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def assert_close(name: str, got, want) -> float:
    tol, rel_tol = TOL[want.dtype], REL_TOL[want.dtype]
    err, rel = max_err(got, want), rel_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) \
        and rel <= rel_tol and bool(torch.isfinite(got.float()).all())
    log(f"  {name}: max_abs_err {err:.3e} (atol=rtol={tol}), rel L2 "
        f"{rel:.3e} (limit {rel_tol}), rms of the plain output "
        f"{want.float().pow(2).mean().sqrt().item():.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, rel L2 {rel})")
    return err


def assert_mutant_caught(name: str, mutant, want,
                         what: str = f"q x {MUTANT_TEMP}") -> None:
    """The check has teeth: the plain version run with a 2 % error (the
    softmax temperature, or the decay) must fail the relative limit."""
    rel = rel_err(mutant, want)
    log(f"  mutant ({name}, {what}): rel L2 {rel:.3e} "
        f"(must exceed {REL_TOL[want.dtype]})")
    if rel <= REL_TOL[want.dtype]:
        raise AssertionError(f"{name}: the kernel check cannot tell the "
                             f"mutant {what}")


# ------------------------------------------------------------ phase 1
def environment() -> str:
    """Print the card and versions, build the kernels; returns the
    nvidia-smi line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in libs.values())})")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")
    counts = sass_counts(libs)
    for op, what in SASS_OPS.items():
        log(f"{op} instructions ({what}) in the SASS: {counts[op]}")
    for op, name, what in (
            ("HGMMA", "flash_attention", "Hopper bf16 body"),
            ("UTMALDG", "flash_attention", "Hopper bf16 body's TMA tiles"),
            ("HGMMA", "flash_attention_bwd", "Hopper bodies (every hd)"),
            ("UTMALDG", "flash_attention_bwd", "Hopper bodies' TMA tiles"),
            ("HMMA", "wkv6", "chunked body's 3xTF32 products"),
            ("HMMA", "wkv6_bwd", "3xTF32 state products")):
        if not counts[op][name]:
            raise AssertionError(f"{name}'s library has no {op}: its {what} "
                                 f"do not run as designed")
    # the attention backward's bf16 bodies are all on wgmma: an HMMA in its
    # library, or a spill in its Hopper kernels at hd 160 (whose dK and dV
    # take 160 registers a consumer thread), is a body that does not run
    # as designed
    check_wkv6_train_kernels(libs["wkv6"])
    spills = hopper_spills(libs["flash_attention_bwd"])
    for name, n in spills.items():
        log(f"  ptxas flash_attention_bwd: {name}: {n} bytes spill stores")
    at_160 = [n for name, n in spills.items() if "<160," in name]
    if counts["HMMA"]["flash_attention_bwd"] or len(at_160) != 2 \
            or any(at_160):
        raise AssertionError(
            f"flash_attention_bwd: {counts['HMMA']['flash_attention_bwd']} "
            f"HMMA instructions, spill stores {spills}")
    return smi


def hopper_spills(lib: Path) -> dict:
    """{Hopper kernel as name<template arguments>: bytes of spill stores}
    from a library's ptxas report."""
    props = re.findall(r"Function properties for \S*?(fa_bwd_\w+?_hopper_"
                       r"kernel)(I(?:Li\d+E)+)\S*\s+\d+ bytes stack frame, "
                       r"(\d+) bytes spill stores",
                       lib.with_suffix(".log").read_text())
    return {f"{name}<{','.join(re.findall(r'Li(\d+)E', args))}>": int(n)
            for name, args, n in props}


# WKV6's training forward (wkv6_train_launch): {kernel: must it run
# products on the tensor cores}
WKV6_TRAIN_KERNELS = {"wkv6_summary_kernel": True,
                      "wkv6_carry_kernel": False,
                      "wkv6_chunk_kernel": True}


def kernel_spills(lib: Path, names) -> dict:
    """{kernel as name<template arguments>: bytes of spill stores} of the
    kernels ``names`` in a library's ptxas report."""
    found = re.findall(r"Function properties for \S*?(" + "|".join(names)
                       + r")(\w*?)E?\s+\d+ bytes stack frame, (\d+) bytes "
                       r"spill stores", lib.with_suffix(".log").read_text())
    return {f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args + 'E'))}>":
            int(n) for name, args, n in found}


def sass_of(lib: Path, name: str) -> str:
    """The SASS of every function of a library whose name holds ``name``."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = Path(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return "".join(part for part in sass.split("Function : ")[1:]
                   if name in part.split("\n", 1)[0])


def check_wkv6_train_kernels(lib: Path) -> None:
    """WKV6's training forward as designed: its summaries and its chunked
    body run their products on the tensor cores (HMMA in their own SASS),
    and none of its kernels spills at any head dim (the chunked body's
    training instances, <hd,1>; its serving ones are printed)."""
    spills = kernel_spills(lib, WKV6_TRAIN_KERNELS)
    for name, n in spills.items():
        log(f"  ptxas wkv6: {name}: {n} bytes spill stores")
    train = {name: n for name, n in spills.items()
             if "chunk" not in name or name.endswith(",1>")}
    if len(train) != 7 or any(train.values()):
        raise AssertionError(f"wkv6's training kernels spill: {train}")
    for name, mma in WKV6_TRAIN_KERNELS.items():
        if mma:
            n = len(re.findall(r"\bHMMA\b", sass_of(lib, name)))
            log(f"  wkv6: {name}: {n} HMMA instructions")
            if not n:
                raise AssertionError(f"wkv6: {name} has no HMMA: its 3xTF32 "
                                     f"products do not run as designed")


# SASS opcodes counted per library: the tensor cores by mma.sync and by
# wgmma, and TMA loads
SASS_OPS = {"HMMA": "mma.sync", "HGMMA": "wgmma", "UTMALDG": "TMA loads"}


def sass_counts(libs: dict) -> dict:
    """{opcode of SASS_OPS: {kernel source: its count in cuobjdump -sass}}."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = Path(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    counts = {op: {} for op in SASS_OPS}
    for name, lib in libs.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for op in SASS_OPS:
            counts[op][name] = len(re.findall(rf"\b{op}\b", sass))
    return counts


# ------------------------------------------------------------ phase 2
def randn(gen, shape, dtype, scale=QK_SCALE):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def forward_twice(name: str, q, k, v, window):
    """The forward kernel's output (ops.flash_attention) on q, k, v, run
    twice: the two must be bit-equal (its sums run in a fixed order). In
    bf16 the library must report its Hopper (wgmma, TMA) body."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    if q.dtype == torch.bfloat16:
        body = fa.forward_body(q.shape[-1], q.dtype)
        if body != "wgmma":
            raise AssertionError(f"{name}: bf16 at hd {q.shape[-1]} runs "
                                 f"the {body} body, not the Hopper one")
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    return got


def check_flash_attention() -> dict:
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    gen = torch.Generator("cuda").manual_seed(0)
    log("flash_attention (prefill) vs its plain version (bf16: the Hopper "
        "body; every case run twice, bit-equal):")
    # (name, B, S, H, Hkv, hd, window, dtype, 3-D layout)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serving prefill", 4, PROMPT_LEN, 32, 8, 128, None, bf16,
              False),
             ("windowed", 2, 512, 8, 2, 64, 128, bf16, False),
             ("ragged S=193, hd 32", 2, 193, 6, 2, 32, None, bf16, False),
             ("(BH, S, hd), ragged S=193", 1, 193, 8, 2, 64, None, bf16,
              True),
             ("hd 128, S=300 (not a multiple of 64), windowed", 2, 300, 8,
              4, 128, 100, bf16, False),
             ("S=333 (not a multiple of 128), window 100 (an edge inside a "
              "128-row tile), group 5 (hymba's)", 2, 333, 10, 2, 64, 100,
              bf16, False),
             ("ragged fp32, (BH, S, hd)", 1, 193, 6, 2, 32, None, f32,
              True)]
    result = {}
    for name, b, s, h, hkv, hd, window, dtype, flat in cases:
        q = randn(gen, (b, s, h, hd), dtype)
        k = randn(gen, (b, s, hkv, hd), dtype)
        v = randn(gen, (b, s, hkv, hd), dtype, 1.0)
        if flat:   # the JAX kernel's (BH, S, hd) layout
            q, k, v = (t[0].transpose(0, 1).contiguous() for t in (q, k, v))
        got = forward_twice(name, q, k, v, window)
        want = ops.flash_attention(q, k, v, window=window, impl="reference")
        torch.cuda.synchronize()
        err = assert_close(name, got, want)
        if name == "serving prefill":
            result = {"q": q, "k": k, "v": v, "err": err}
            scores = q[0, :, 0].float() @ k[0, :, 0].float().T / hd ** 0.5
            log(f"  (scores of one head: std {scores.std().item():.3f})")
            assert_mutant_caught(name, ops.flash_attention(
                q * MUTANT_TEMP, k, v, impl="reference"), want)
    q, k, v = result["q"], result["k"], result["v"]
    b, s, h, hd = q.shape
    pairs = s * (s + 1) // 2                          # causal (q, k) pairs
    # Q, K, V read once, O (the size of Q) written once
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {q.dtype: 4 * b * h * hd * pairs})
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain = time_ms(lambda: ops.flash_attention(q, k, v, impl="reference"),
                    10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:75",
            "max_abs_err": result["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def check_decode_attention() -> dict:
    from repro_torch.kernels import ops
    gen = torch.Generator("cuda").manual_seed(1)
    log("decode_attention (flash decode) vs its plain version:")
    b, hkv, grp, s, hd, dtype = REQUESTS, 8, 4, PROMPT_LEN + MAX_NEW, 128, \
        torch.bfloat16
    q = randn(gen, (b, hkv, grp, hd), dtype)
    kc = randn(gen, (b, s, hkv, hd), dtype)
    vc = randn(gen, (b, s, hkv, hd), dtype, 1.0)
    lens = torch.tensor([s, s - 16, s - 24, PROMPT_LEN + 1], device="cuda",
                        dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, lens, impl="reference")
    err = assert_close("serving decode, ragged cache_len",
                       ops.decode_attention(q, kc, vc, lens), want)
    assert_mutant_caught("serving decode", ops.decode_attention(
        q * MUTANT_TEMP, kc, vc, lens, impl="reference"), want)
    # poison: slots at or past cache_len must not change the output
    plens = torch.tensor([300, 1, s, 129], device="cuda", dtype=torch.int32)
    dead = torch.arange(s, device="cuda")[None, :] >= plens[:, None].long()
    kp, vp = kc.clone(), vc.clone()
    kp[dead], vp[dead] = 99.0, -99.0
    clean = ops.decode_attention(q, kc, vc, plens)
    poisoned = ops.decode_attention(q, kp, vp, plens)
    assert_close("poisoned slots past cache_len", poisoned,
                 ops.decode_attention(q, kc, vc, plens, impl="reference"))
    if not torch.equal(clean, poisoned):
        raise AssertionError("decode kernel read slots past cache_len")
    # fp32, (BHkv, grp, hd) layout, wider group
    q3 = randn(gen, (4, 8, 64), torch.float32)
    k3 = randn(gen, (4, 384, 64), torch.float32)
    v3 = randn(gen, (4, 384, 64), torch.float32)
    l3 = torch.tensor([384, 200, 17, 1], device="cuda", dtype=torch.int32)
    assert_close("fp32 (BHkv, grp, hd), grp 8",
                 ops.decode_attention(q3, k3, v3, l3),
                 ops.decode_attention(q3, k3, v3, l3, impl="reference"))
    check_many_splits(gen)

    valid = int(lens.sum()) * hkv * hd                # K (and V) elements
    n_bytes = (2 * q.numel() + 2 * valid) * q.element_size() + 4 * b
    bound, by = bound_ms(n_bytes, {dtype: 4 * grp * valid})
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 200)
    plain = time_ms(lambda: ops.decode_attention(q, kc, vc, lens,
                                                 impl="reference"), 20)
    lib = time_ms(masked_sdpa(q, kc, vc, lens), 200)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    time_long_cache(gen)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def masked_sdpa(q, kc, vc, lens):
    """One PyTorch call computing flash decode's function, for its time:
    SDPA over the (B, H, S, hd) caches with a cache_len mask."""
    import torch.nn.functional as F
    b, hkv, grp, hd = q.shape
    s = kc.shape[1]
    qs = q.reshape(b, hkv * grp, 1, hd)
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def check_many_splits(gen) -> None:
    """A 4096-slot cache split over many blocks: cache_len 1 (every split
    but one empty), a cache_len that ends on a chunk boundary, and poison
    past cache_len."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import _sm_count, plan_splits
    b, hkv, grp, s, hd = 2, 8, 4, 4096, 128
    n_split, chunk = plan_splits(b * hkv, s, _sm_count(torch.device("cuda")))
    log(f"  4096-slot cache, {b * hkv} rows: {n_split} splits of {chunk} "
        f"slots")
    q = randn(gen, (b, hkv, grp, hd), torch.bfloat16)
    kc = randn(gen, (b, s, hkv, hd), torch.bfloat16)
    vc = randn(gen, (b, s, hkv, hd), torch.bfloat16, 1.0)
    lens = torch.tensor([1, 3 * chunk], device="cuda", dtype=torch.int32)
    assert_close(f"cache_len 1 and {3 * chunk} (a chunk boundary)",
                 ops.decode_attention(q, kc, vc, lens),
                 ops.decode_attention(q, kc, vc, lens, impl="reference"))
    plens = torch.tensor([chunk + 1, s - 5], device="cuda",
                         dtype=torch.int32)
    dead = torch.arange(s, device="cuda")[None, :] >= plens[:, None].long()
    clean = ops.decode_attention(q, kc, vc, plens)
    kc[dead], vc[dead] = 99.0, -99.0
    poisoned = ops.decode_attention(q, kc, vc, plens)
    torch.cuda.synchronize()
    if not torch.equal(clean, poisoned):
        raise AssertionError("split decode read slots past cache_len")
    log(f"  poisoned slots past cache_len {plens.tolist()} over {n_split} "
        f"splits: output bit-identical ok")


def time_long_cache(gen) -> None:
    """Batch-1 decode at qwen3-8b's shape against a full 32,768-slot
    cache, the shape the split exists for, beside masked SDPA and the
    bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import _sm_count, plan_splits
    b, hkv, grp, s, hd, dtype = 1, 8, 4, 32768, 128, torch.bfloat16
    q = randn(gen, (b, hkv, grp, hd), dtype)
    kc = randn(gen, (b, s, hkv, hd), dtype)
    vc = randn(gen, (b, s, hkv, hd), dtype, 1.0)
    lens = torch.full((b,), s, device="cuda", dtype=torch.int32)
    assert_close("batch 1, 32768 slots",
                 ops.decode_attention(q, kc, vc, lens),
                 ops.decode_attention(q, kc, vc, lens, impl="reference"))
    n_bytes = (2 * q.numel() + kc.numel() + vc.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {dtype: 4 * grp * kc.numel()})
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 100)
    lib = time_ms(masked_sdpa(q, kc, vc, lens), 100)
    n_split, chunk = plan_splits(b * hkv, s, _sm_count(q.device))
    log(f"decode batch 1, 32768-slot cache ({n_bytes / 1e6:.1f} MB, "
        f"{n_split} splits of {chunk}): kernel {ms:.4f} ms, SDPA "
        f"{lib:.4f} ms (masked), bound {bound:.4f} ms ({by})")


def check_wkv6() -> list:
    """WKV6 against its plain version at the serving prefill and the
    decode step, its edges (check_wkv6_chunks) and its token body
    (check_wkv6_token); timed. Returns the JSON entries "wkv6" (prefill)
    and "wkv6_decode"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import chunk_tokens
    gen = torch.Generator("cuda").manual_seed(2)
    log("wkv6 (RWKV6 WKV recurrence) vs its plain version:")

    def inputs(shape):
        """r, k, v at scale 0.5 and per-channel decays exp(-exp(x)) with
        x ~ N(-5, 2): from ~1 (state kept over the whole sequence) to ~0;
        u (heads, hd) for the model layout or (BH, hd) for the 3-D one."""
        r, k, v = (randn(gen, shape, torch.float32, 0.5) for _ in range(3))
        w = torch.exp(-torch.exp(randn(gen, shape, torch.float32, 2.0) - 5))
        u = randn(gen, shape[-2:] if len(shape) == 4 else
                  (shape[0], shape[-1]), torch.float32, 0.5)
        return r, k, v, w, u

    # the serving prefill shape; its state buffer starts at zero, as the
    # model's prefill gives it (read and written in place)
    b, s, h, hd = REQUESTS, SERVED["rwkv6-3b"], RWKV_HEADS, RWKV_HD
    r, k, v, w, u = inputs((b, s, h, hd))
    zero = torch.zeros((b, h, hd, hd), device="cuda")
    state = zero.clone()
    got, final = ops.wkv6(r, k, v, w, u, state)
    want, want_final = ops.wkv6(r, k, v, w, u, zero.clone(), impl="reference")
    torch.cuda.synchronize()
    err = assert_close("serving prefill, y", got, want)
    assert_close("serving prefill, final state", final, want_final)
    y0, _ = ops.wkv6(r, k, v, w, u)
    assert_close("serving prefill, no state given", y0, want)
    assert_mutant_caught("serving prefill", ops.wkv6(
        r, k, v, w ** MUTANT_TEMP, u, zero.clone(), impl="reference")[0],
        want, f"w ** {MUTANT_TEMP}")
    # ragged S from a nonzero state, hd 32
    r2, k2, v2, w2, u2 = inputs((2, 1000, 8, 32))
    start = randn(gen, (2, 8, 32, 32), torch.float32, 1.0)
    st_k, st_p = start.clone(), start.clone()
    y2, _ = ops.wkv6(r2, k2, v2, w2, u2, st_k)
    y2p, _ = ops.wkv6(r2, k2, v2, w2, u2, st_p, impl="reference")
    assert_close("S=1000 from a state, hd 32, y", y2, y2p)
    assert_close("S=1000 from a state, hd 32, final state", st_k, st_p)
    # decode: one step, the state a layer's slice of a stacked cache
    r3, k3, v3, w3, u3 = inputs((b, 1, h, hd))
    cache = randn(gen, (3, b, h, hd, hd), torch.float32, 1.0)
    before = cache.clone()
    y3, _ = ops.wkv6(r3, k3, v3, w3, u3, cache[1])
    plain_state = before[1].clone()
    y3p, _ = ops.wkv6(r3, k3, v3, w3, u3, plain_state, impl="reference")
    derr = assert_close("decode step, y", y3, y3p)
    assert_close("decode step, state in place", cache[1], plain_state)
    if not (torch.equal(cache[0], before[0])
            and torch.equal(cache[2], before[2])):
        raise AssertionError("wkv6 wrote outside its state slice")
    # the JAX kernel's (BH, S, hd) layout, hd 16
    r4, k4, v4, w4, u4 = inputs((12, 300, 16))
    assert_close("(BH, S, hd), hd 16", ops.wkv6(r4, k4, v4, w4, u4),
                 ops.wkv6(r4, k4, v4, w4, u4, impl="reference"))
    check_wkv6_chunks(gen, inputs)
    check_wkv6_token(gen, inputs)

    # r, k, v, w read once, y written once, the state read and written
    # once; 5 hd^2 fp32 flops per (token, head): 2 hd^2 for r^T S and
    # 3 hd^2 for S <- w * S + k v^T, as y_t = r_t^T S + (r_t . (u * k_t)) v_t
    n_bytes = (5 * r.numel() + 2 * zero.numel() + u.numel()) * 4
    bound, by = bound_ms(n_bytes, {torch.float32: 5 * hd * hd * b * s * h})
    ms = time_ms(lambda: ops.wkv6(r, k, v, w, u, state), 20)
    plain = time_ms(lambda: ops.wkv6(r, k, v, w, u, state, impl="reference"),
                    2, warmup=1)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, no single "
        f"PyTorch call computes it, bound {bound:.4f} ms ({by})")
    # the decode shape: one step from a carried state, the token body;
    # L2-warm (the slice just written), then cold: a layer's slice of a
    # stacked DECODE_LAYERS-layer cache past the L2, the layers walked one
    # after another as decode_step walks them
    n_bytes = (5 * r3.numel() + 2 * cache[1].numel() + u3.numel()) * 4
    dbound, dby = bound_ms(n_bytes, {torch.float32: 5 * hd * hd * b * h})
    dms = time_ms(lambda: ops.wkv6(r3, k3, v3, w3, u3, cache[1]), 200)
    dplain = time_ms(lambda: ops.wkv6(r3, k3, v3, w3, u3, cache[1],
                                      impl="reference"), 50)
    layers = randn(gen, (DECODE_LAYERS, b, h, hd, hd), torch.float32, 1.0)

    def walk():
        for layer in layers:
            ops.wkv6(r3, k3, v3, w3, u3, layer)
    cold = time_ms(walk, 10) / DECODE_LAYERS
    log(f"wkv6 decode step (B={b}, S=1, H={h}, hd={hd}, "
        f"{n_bytes / 1e6:.2f} MB): kernel {dms:.6f} ms (L2-warm), "
        f"{cold:.6f} ms a layer over a {DECODE_LAYERS}-layer cache of "
        f"{layers.numel() * 4 / 1e6:.1f} MB (cold), plain {dplain:.6f} ms, "
        f"bound {dbound:.6f} ms ({dby})")
    for steps in (2, chunk_tokens() - 1):
        rs, ks, vs, ws, us = inputs((b, steps, h, hd))
        t_steps = time_ms(lambda: ops.wkv6(rs, ks, vs, ws, us, cache[1]),
                          100)
        log(f"  token body at S={steps} (B={b}, H={h}, hd={hd}): "
            f"{t_steps:.6f} ms, {t_steps / steps:.6f} ms a step (L2-warm)")
    del layers
    entry = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
             "replaces": "src/repro/kernels/rwkv6.py:49", "library_ms": None}
    return [{"name": "wkv6", **entry, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": bound, "bound_by": by},
            {"name": "wkv6_decode", **entry, "max_abs_err": derr,
             "ms": dms, "cold_ms": cold, "plain_ms": dplain,
             "bound_ms": dbound, "bound_by": dby}]


def check_wkv6_chunks(gen, inputs) -> None:
    """The bodies' edges and decays, at the serving heads: S of 1, 2 and
    T-1 (the token body), T, T+1 and 2T+3 (a ragged last chunk) from a
    nonzero state; decays in the model's range (0.99-0.9999, a state kept
    over thousands of steps) in both bodies; decays with exact 0s (the
    state wiped) and 1s mixed in. A decay applied one step late, the slip
    a chunk's running products invite, must fail the check."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import chunk_tokens
    t = chunk_tokens()
    h, hd = RWKV_HEADS, RWKV_HD

    def case(name, s, decays):
        r, k, v, w, u = inputs((2, s, h, hd))
        if decays == "model":
            w = 0.99 + 0.0099 * torch.rand(w.shape, generator=gen,
                                            device="cuda")
        elif decays == "0 and 1":
            pick = torch.rand(w.shape, generator=gen, device="cuda")
            w = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, w))
        start = randn(gen, (2, h, hd, hd), torch.float32, 1.0)
        st_k, st_p = start.clone(), start.clone()
        y, _ = ops.wkv6(r, k, v, w, u, st_k)
        want, _ = ops.wkv6(r, k, v, w, u, st_p, impl="reference")
        assert_close(f"{name}, y", y, want)
        assert_close(f"{name}, final state", st_k, st_p)
        return r, k, v, w, u, start, want

    for s in (1, 2, t - 1, t, t + 1, 2 * t + 3):
        body = "token body" if s < t else "chunked body"
        case(f"S={s} from a state (chunk T={t}, {body})", s, "serving")
    r, k, v, w, u, start, want = case(f"S={t - 1}, decays 0.99-0.9999",
                                      t - 1, "model")
    late = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], dim=1)
    assert_mutant_caught(f"S={t - 1}", ops.wkv6(
        r, k, v, late, u, start.clone(), impl="reference")[0], want,
        "each decay one step late")
    case(f"S={t - 1}, exact 0 and 1 decays", t - 1, "0 and 1")
    r, k, v, w, u, start, want = case(f"S={2 * t + 3}, decays 0.99-0.9999",
                                      2 * t + 3, "model")
    late = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], dim=1)
    assert_mutant_caught("decays 0.99-0.9999", ops.wkv6(
        r, k, v, late, u, start.clone(), impl="reference")[0], want,
        "each decay one step late")
    case("S=1024, decays 0.99-0.9999", 1024, "model")
    case(f"S={2 * t + 3}, exact 0 and 1 decays", 2 * t + 3, "0 and 1")
    case("S=1000, exact 0 and 1 decays", 1000, "0 and 1")


def check_wkv6_token(gen, inputs) -> None:
    """WKV6's token body at every S it serves below the chunked body's T
    (1, 2 and T-1) and every head dim it takes (16, 32, 64), at the
    serving batch and heads: into layer 1's slice of a stacked (3, B, H,
    hd, hd) cache from the slice's contents, and from zero (the operator
    with has_state false: the slice, poisoned with NaN, is not read and
    gets the final state); y and the state against the plain version,
    layers 0 and 2 unchanged, each call counted as a token-body launch.
    The final state of the plain version with each decay one step late
    must fail the check."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import chunk_tokens, wkv6, wkv6_op
    b, h = REQUESTS, RWKV_HEADS
    for hd in (16, 32, 64):
        for steps in (1, 2, chunk_tokens() - 1):
            r, k, v, w, u = inputs((b, steps, h, hd))
            for start in ("a state", "zero"):
                cache = randn(gen, (3, b, h, hd, hd), torch.float32, 1.0)
                if start == "zero":
                    cache[1] = float("nan")
                before = cache.clone()
                counts = wkv6.launches, wkv6.token_launches
                if start == "a state":
                    y, _ = ops.wkv6(r, k, v, w, u, cache[1])
                    want_state = before[1].clone()
                    held = before[1].clone(), want_state
                else:
                    y = wkv6_op(r, k, v, w, u, cache[1], False)
                    want_state = torch.zeros_like(before[1])
                if (wkv6.launches - counts[0],
                        wkv6.token_launches - counts[1]) != (1, 1):
                    raise AssertionError(f"wkv6 S={steps}: the call did not "
                                         f"count one token-body launch")
                want, _ = ops.wkv6(r, k, v, w, u, want_state,
                                   impl="reference")
                what = f"token body S={steps} hd {hd} from {start}"
                assert_close(f"{what}, y", y, want)
                assert_close(f"{what}, state in place", cache[1],
                             want_state)
                if not (torch.equal(cache[0], before[0])
                        and torch.equal(cache[2], before[2])):
                    raise AssertionError(f"{what}: wrote outside its "
                                         f"state slice")
            mutant, want_state = held
            late = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], dim=1)
            ops.wkv6(r, k, v, late, u, mutant, impl="reference")
            assert_mutant_caught(f"token body S={steps} hd {hd} from a "
                                 f"state", mutant, want_state,
                                 "each decay one step late, the final state")


def assert_close_scan(name: str, got, want) -> float:
    """The Mamba scan against its plain version: an fp32 tensor within
    SCAN_ATOL and SCAN_RTOL pointwise and REL_TOL's fp32 relative L2,
    finite; a bf16 output as assert_close holds a kernel's bf16 output
    (the two round the same fp32 value, summed in another order, to bf16)."""
    if want.dtype != torch.float32:
        return assert_close(name, got, want)
    err, rel = max_err(got, want), rel_err(got, want)
    ok = torch.allclose(got, want, atol=SCAN_ATOL, rtol=SCAN_RTOL) \
        and rel <= REL_TOL[torch.float32] and bool(torch.isfinite(got).all())
    log(f"  {name}: max_abs_err {err:.3e} (atol {SCAN_ATOL}, rtol "
        f"{SCAN_RTOL}), rel L2 {rel:.3e} (limit {REL_TOL[torch.float32]}), "
        f"max |plain| {want.abs().max().item():.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, rel L2 {rel})")
    return err


def assert_state_equal(name: str, got, want) -> None:
    """The token body keeps JAX's step order: its state is the plain
    loop's, bit for bit."""
    same = torch.equal(got, want)
    log(f"  {name}: state bit-equal to the plain loop's: {same}")
    if not same:
        raise AssertionError(f"{name}: the token body's state differs from "
                             f"the plain loop's (max abs "
                             f"{max_err(got, want):.3e})")


def mamba_decay_late(dt_raw, dt_bias, b, c, x, z, a_log, d_skip, h):
    """The plain fused function with each step's decay applied one step
    late (the first step's taken as 1): the slip a tiled kernel's staging
    invites. Returns out."""
    import torch.nn.functional as F
    dt = F.softplus(dt_raw.float() + dt_bias)
    a, x_f = -torch.exp(a_log), x.float()
    cur, da, ys = h.clone(), torch.ones_like(h), []
    for t in range(dt.shape[1]):
        cur = da * cur + (dt[:, t] * x_f[:, t])[..., None] \
            * b[:, t, None, :].float()
        ys.append(torch.einsum("bdn,bn->bd", cur, c[:, t].float()))
        da = torch.exp(dt[:, t, :, None] * a[None])
    y = torch.stack(ys, dim=1) + d_skip * x_f
    return y.to(x.dtype) * F.silu(z)


def mamba_fused_cost(b: int, s: int, dtype) -> tuple[float, dict]:
    """Bytes and fp32 operations of the fused scan at hymba's widths from a
    carried state. Bytes: dt_raw, x and z read and out written (B, S, di),
    b and c read (B, S, n), in the model's dtype; a_log, dt_bias, d_skip
    read and the state read and written, fp32. Operations: 7 a (token,
    channel, state): dt * a, exp, da * h, (dt x) b, the sum, h c and its
    sum; 10 a (token, channel): the bias, softplus's exp and log1p, dt * x,
    the skip's product and sum, silu's exp, sum and quotient, the gate."""
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (4 * b * s * MAMBA_DI + 2 * b * s * MAMBA_N) * size \
        + (MAMBA_DI * MAMBA_N + 2 * MAMBA_DI
           + 2 * b * MAMBA_DI * MAMBA_N) * 4
    return n_bytes, {torch.float32: (7 * MAMBA_N + 10) * b * s * MAMBA_DI}


def check_mamba_scan() -> list:
    """The fused Mamba scan kernel (dt's softplus, the scan, the skip term,
    the gating) against its plain version in bf16 (the served dtype) and
    fp32: at hymba's serving prefill (B=4, S=4096, di=1600, n=16) from a
    zero state and from a carried one; at the decode shape (S=1) into a
    layer's slice of a stacked state; on both sides of its body switch at
    the chunked body's tile edges (S of T-1, T, T+1, 2T+3) from a carried
    state. The token body's state must equal the plain loop's bit for bit.
    Two mutants of the plain version must fail: each decay one step late,
    and the epilogue without the d_skip term. b and c are the two halves of
    one (B, S, 2n) projection and z the second half of a (B, S, 2 di) one,
    as the model passes them. The token body at each S and n it serves
    (check_mamba_token). Then timed in bf16 beside the plain version and
    its bound, at the prefill and the decode shape; the token body also
    cold (a layer of a MAMBA_COLD_LAYERS-layer stack of states walked in
    turn) and at S = 2, 15 and T-1. Returns the JSON entries "mamba_scan"
    (prefill) and "mamba_scan_decode" (with its cold time)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import time_tile
    gen = torch.Generator("cuda").manual_seed(4)
    log("mamba_scan (hymba's selective scan, fused with dt's softplus, the "
        "skip term and the gating) vs its plain version:")

    def inputs(b, s, dtype, n=MAMBA_N):
        """dt_raw ~ N(-2, 2) and dt_bias ~ N(0, 0.3): dt from ~0.005 (a
        decay near 1, the state kept for hundreds of steps) to ~6; x, z, b,
        c ~ N(0, 1), in ``dtype``; a_log = log(1..n) + N(0, 0.3), the
        model's init perturbed; d_skip ~ 1 + N(0, 0.5); a carried state
        ~ N(0, 1)."""
        f32 = torch.float32
        dt_raw = (randn(gen, (b, s, MAMBA_DI), f32, 2.0) - 2.0).to(dtype)
        dt_bias = randn(gen, (MAMBA_DI,), f32, 0.3)
        bc = randn(gen, (b, s, 2 * n), dtype, 1.0)
        x = randn(gen, (b, s, MAMBA_DI), dtype, 1.0)
        zz = randn(gen, (b, s, 2 * MAMBA_DI), dtype, 1.0)
        a_log = torch.log(torch.arange(1, n + 1, device="cuda").float()) \
            + randn(gen, (MAMBA_DI, n), f32, 0.3)
        d_skip = 1.0 + randn(gen, (MAMBA_DI,), f32, 0.5)
        h = randn(gen, (b, MAMBA_DI, n), f32, 1.0)
        return [dt_raw, dt_bias, bc[..., :n], bc[..., n:], x,
                zz[..., MAMBA_DI:], a_log, d_skip], h

    b, s, t = REQUESTS, SERVED["hymba-1.5b"], time_tile()
    errs, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        args, h = inputs(b, s, dtype)
        out, final = ops.mamba_scan(*args)
        want, want_final = ops.mamba_scan(*args, impl="reference")
        torch.cuda.synchronize()
        errs["prefill", dtype] = assert_close_scan(
            f"{tag} serving prefill from zeros, out", out, want)
        assert_close_scan(f"{tag} serving prefill from zeros, final state",
                          final, want_final)
        state = h.clone()
        out, final = ops.mamba_scan(*args, state)
        want, want_final = ops.mamba_scan(*args, h.clone(),
                                          impl="reference")
        if final is not state:
            raise AssertionError("mamba_scan did not write the given state")
        assert_close_scan(f"{tag} serving prefill from a state, out", out,
                          want)
        assert_close_scan(f"{tag} serving prefill from a state, final "
                          f"state", final, want_final)
        # decode: one step, the state a layer's slice of a stacked cache
        d_args, _ = inputs(b, 1, dtype)
        cache = randn(gen, (3, b, MAMBA_DI, MAMBA_N), torch.float32, 1.0)
        before = cache.clone()
        out_d, _ = ops.mamba_scan(*d_args, cache[1])
        plain_state = before[1].clone()
        want_d, _ = ops.mamba_scan(*d_args, plain_state, impl="reference")
        errs["decode", dtype] = assert_close_scan(
            f"{tag} decode step, out", out_d, want_d)
        assert_state_equal(f"{tag} decode step, in place", cache[1],
                           plain_state)
        if not (torch.equal(cache[0], before[0])
                and torch.equal(cache[2], before[2])):
            raise AssertionError("mamba_scan wrote outside its state slice")
        for steps in (t - 1, t, t + 1, 2 * t + 3):
            e_args, e_h = inputs(2, steps, dtype)
            st_k, st_p = e_h.clone(), e_h.clone()
            out_e, _ = ops.mamba_scan(*e_args, st_k)
            want_e, _ = ops.mamba_scan(*e_args, st_p, impl="reference")
            body = "token body" if steps < t else "chunked body"
            assert_close_scan(f"{tag} S={steps} from a state (tile T={t}, "
                              f"{body}), out", out_e, want_e)
            assert_close_scan(f"{tag} S={steps}, final state", st_k, st_p)
            if steps < t:
                assert_state_equal(f"{tag} S={steps}", st_k, st_p)
        if dtype == torch.float32:
            assert_mutant_caught(f"S={steps}", mamba_decay_late(
                *e_args, e_h), want_e, "each decay one step late")
            skipless = e_args[:7] + [torch.zeros_like(e_args[7])]
            assert_mutant_caught(f"S={steps}", ops.mamba_scan(
                *skipless, e_h.clone(), impl="reference")[0], want_e,
                "the epilogue without d_skip")
        timed[dtype] = (args, h, d_args, cache)
    check_mamba_token(gen, inputs)

    entries = []
    for label, s_run in (("prefill", s), ("decode", 1)):
        for dtype in (torch.bfloat16, torch.float32):
            args, h, d_args, cache = timed[dtype]
            run_args, state = (args, h.clone()) if s_run > 1 else \
                (d_args, cache[1])
            n_bytes, flops = mamba_fused_cost(b, s_run, dtype)
            bound, by = bound_ms(n_bytes, flops)
            iters = 20 if s_run > 1 else 200
            ms = time_ms(lambda: ops.mamba_scan(*run_args, state), iters)
            plain = time_ms(lambda: ops.mamba_scan(
                *run_args, state, impl="reference"),
                2 if s_run > 1 else 50, warmup=1)
            log(f"  {label} {str(dtype)[6:]} (B={b}, S={s_run}, "
                f"di={MAMBA_DI}, n={MAMBA_N}) time: kernel {ms:.6f} ms, "
                f"plain {plain:.6f} ms, no single PyTorch call computes "
                f"it, bound {bound:.6f} ms ({by}, {n_bytes / 1e6:.2f} MB, "
                f"{sum(flops.values()) / 1e9:.3f} GFLOP)")
            if dtype == torch.bfloat16:     # the served dtype
                entries.append({
                    "name": "mamba_scan" if s_run > 1 else
                    "mamba_scan_decode", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
                    # no Pallas kernel: the vmemkernel_mamba_scan lax.scan
                    "replaces": "src/repro/models/ssm.py:217",
                    "max_abs_err": errs[label, dtype], "ms": ms,
                    "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                    "library_ms": None})
    # the token body cold: a layer's slice of a stacked state past the L2,
    # the layers walked one after another as decode_step walks them; then
    # S = 2, 15 and T-1 from a carried state, L2-warm
    _, _, d_args, cache = timed[torch.bfloat16]
    layers = randn(gen, (MAMBA_COLD_LAYERS, b, MAMBA_DI, MAMBA_N),
                   torch.float32, 1.0)

    def walk():
        for layer in layers:
            ops.mamba_scan(*d_args, layer)
    # 3 walks: time_ms needs every timed launch queued behind its spin,
    # and 10 walks' 1920 launches were not
    cold = time_ms(walk, 3) / MAMBA_COLD_LAYERS
    entries[-1]["cold_ms"] = cold
    log(f"  decode bf16 token body: {cold:.6f} ms a layer over a "
        f"{MAMBA_COLD_LAYERS}-layer stack of states of "
        f"{layers.numel() * 4 / 1e6:.1f} MB (cold), against "
        f"{entries[-1]['ms']:.6f} ms L2-warm")
    del layers
    for steps in (2, 15, t - 1):
        s_args, _ = inputs(b, steps, torch.bfloat16)
        t_steps = time_ms(lambda: ops.mamba_scan(*s_args, cache[1]), 100)
        log(f"  token body at S={steps} (B={b}, di={MAMBA_DI}, n={MAMBA_N}, "
            f"bf16): {t_steps:.6f} ms, {t_steps / steps:.6f} ms a step "
            f"(L2-warm)")
    return entries


def check_mamba_token(gen, inputs) -> None:
    """The fused scan's token body at every S it serves below the chunked
    body's T (1, 2, 15 and T-1) and both n it takes (8, 16), in bf16 and
    fp32 at hymba's batch and channels: into layer 1's slice of a stacked
    (3, B, di, n) cache from the slice's contents, and from zero (the
    operator with has_state false: the slice, poisoned with NaN, is not
    read and gets the final state); out against the plain version, the
    state bit-equal to the plain loop's, layers 0 and 2 unchanged, each
    call counted as one token-body launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_op,
                                                time_tile)
    b = REQUESTS
    for dtype in (torch.bfloat16, torch.float32):
        for n in (8, 16):
            for steps in (1, 2, 15, time_tile() - 1):
                args, _ = inputs(b, steps, dtype, n)
                for start in ("a state", "zero"):
                    cache = randn(gen, (3, b, MAMBA_DI, n), torch.float32,
                                  1.0)
                    if start == "zero":
                        cache[1] = float("nan")
                    before = cache.clone()
                    counts = mamba_scan.launches, mamba_scan.token_launches
                    if start == "a state":
                        out, _ = ops.mamba_scan(*args, cache[1])
                        want_state = before[1].clone()
                    else:
                        out = mamba_scan_op(*args, cache[1], False)
                        want_state = None
                    what = (f"{str(dtype)[6:]} token body S={steps} n {n} "
                            f"from {start}")
                    if (mamba_scan.launches - counts[0],
                            mamba_scan.token_launches - counts[1]) != (1, 1):
                        raise AssertionError(f"{what}: the call did not "
                                             f"count one token-body launch")
                    want, want_final = ops.mamba_scan(*args, want_state,
                                                      impl="reference")
                    assert_close_scan(f"{what}, out", out, want)
                    assert_state_equal(what, cache[1], want_final)
                    if not (torch.equal(cache[0], before[0])
                            and torch.equal(cache[2], before[2])):
                        raise AssertionError(f"{what}: wrote outside its "
                                             f"state slice")


def sdpa_operands(q, k, v, window):
    """SDPA's (B, H, S, hd) operands and keyword arguments for causal
    attention of (B, S, H, hd) q, k, v with an optional window: is_causal
    (GQA by enable_gqa) where the window is None or covers the whole
    sequence, the same function on SDPA's fast path; else a boolean mask,
    with K and V repeated per query head (SDPA has no window), which runs
    its slow path."""
    s = q.shape[1]
    qt = q.transpose(1, 2).contiguous()
    if window is None or window >= s:
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        return (qt, kt, vt), {"is_causal": True, "enable_gqa": True}
    grp = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(grp, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    pos = torch.arange(s, device=q.device)
    return (qt, kt, vt), {"attn_mask": (pos[:, None] >= pos[None, :])
                         & (pos[:, None] - pos[None, :] < window)}


def prompt_len_of(arch: str) -> int:
    return {**SERVED, **STUB_SERVED}[arch]


def visible_pairs(s: int, window) -> int:
    """Causal (query, key) pairs of an S-token prefill, inside the window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def check_attention_shape(tag: str) -> list:
    """Both attention kernels at the serving shapes of the model
    ATTENTION_SHAPES names under ``tag`` (its head dim, heads, window,
    prompt length; decode against the cache the engine keeps after that
    prompt: a full ring of window slots for h2o-danube and hymba, else
    prompt + MAX_NEW slots with ragged cache_len), bf16 and fp32, each
    against its plain version with the temperature mutant (the prefill
    run twice, bit-equal, bf16 on the Hopper body); then timed in
    bf16 beside the plain version, one SDPA call (with a window mask, or
    masked by cache_len) and the bound. Returns the two kernels' JSON
    entries, named ``<kernel>_<tag>``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    arch = ATTENTION_SHAPES[tag]
    cfg = get_arch(arch)
    b, s, h, hkv, hd, window = REQUESTS, prompt_len_of(arch), cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    grp = h // hkv
    cap = min(s + MAX_NEW, window or s + MAX_NEW)
    lens = torch.tensor([cap, cap - 16, cap - 24, s + 1] if cap > s else
                        [cap] * b, device="cuda", dtype=torch.int32)
    if tag.startswith("hd") and cfg.hd != int(tag[2:]):
        raise AssertionError(f"{arch} has hd {cfg.hd}, not {tag[2:]}")
    gen = torch.Generator("cuda").manual_seed(hd)
    log(f"hd {hd} at {arch}'s serving shapes ({h}/{hkv} heads, window "
        f"{window}): prefill B={b} S={s}; decode grp {grp} against "
        f"{cap} slots, cache_len {lens.tolist()}:")
    pre, dec = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        q = randn(gen, (b, s, h, hd), dtype)
        k = randn(gen, (b, s, hkv, hd), dtype)
        v = randn(gen, (b, s, hkv, hd), dtype, 1.0)
        name = f"prefill hd {hd} {str(dtype)[6:]}"
        want = ops.flash_attention(q, k, v, window=window, impl="reference")
        got = forward_twice(name, q, k, v, window)
        torch.cuda.synchronize()
        err = assert_close(name, got, want)
        assert_mutant_caught(name, ops.flash_attention(
            q * MUTANT_TEMP, k, v, window=window, impl="reference"), want)
        if dtype == torch.bfloat16:
            pre = {"q": q, "k": k, "v": v, "err": err}
        qd = randn(gen, (b, hkv, grp, hd), dtype)
        kc = randn(gen, (b, cap, hkv, hd), dtype)
        vc = randn(gen, (b, cap, hkv, hd), dtype, 1.0)
        want = ops.decode_attention(qd, kc, vc, lens, impl="reference")
        name = f"decode hd {hd} {str(dtype)[6:]}"
        err = assert_close(name, ops.decode_attention(qd, kc, vc, lens), want)
        assert_mutant_caught(name, ops.decode_attention(
            qd * MUTANT_TEMP, kc, vc, lens, impl="reference"), want)
        if dtype == torch.bfloat16:
            dec = {"q": qd, "k": kc, "v": vc, "err": err}
    entries = []
    q, k, v = pre["q"], pre["k"], pre["v"]
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {q.dtype: 4 * b * h * hd
                                   * visible_pairs(s, window)})
    ms = time_ms(lambda: ops.flash_attention(q, k, v, window=window), 20)
    plain = time_ms(lambda: ops.flash_attention(q, k, v, window=window,
                                                impl="reference"), 3,
                    warmup=1)
    (qt, kt, vt), kw = sdpa_operands(q, k, v, window)
    masked = "attn_mask" in kw
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                  5 if masked else 20, warmup=1 if masked else 3)
    what = "SDPA, window mask" if masked else "SDPA"
    log(f"  prefill hd {hd} time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"{what} {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    entries.append({"name": f"flash_attention_{tag}", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:75",
                    "max_abs_err": pre["err"], "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib})
    del pre, q, k, v, qt, kt, vt
    qd, kc, vc = dec["q"], dec["k"], dec["v"]
    valid = int(lens.sum()) * hkv * hd                # K (and V) elements
    n_bytes = (2 * qd.numel() + 2 * valid) * qd.element_size() + 4 * b
    bound, by = bound_ms(n_bytes, {qd.dtype: 4 * grp * valid})
    ms = time_ms(lambda: ops.decode_attention(qd, kc, vc, lens), 200)
    plain = time_ms(lambda: ops.decode_attention(qd, kc, vc, lens,
                                                 impl="reference"), 20)
    lib = time_ms(masked_sdpa(qd, kc, vc, lens), 200)
    log(f"  decode hd {hd} time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms (masked), bound {bound:.4f} ms ({by})")
    entries.append({"name": f"decode_attention_{tag}", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:63",
                    "max_abs_err": dec["err"], "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib})
    return entries


# ------------------------------------------------------------ phase 3
def expected_counts(cfg, decode_steps: int, prefills: int = 1) -> dict:
    """One launch per layer of the prefill kernel per prefill, and of the
    decode kernel per decode step (a hybrid: and of the Mamba scan in
    both); none of the others."""
    prefill_kernel, decode_kernel = ("wkv6", "wkv6") if cfg.attn_free \
        else ("flash_attention", "decode_attention")
    from repro_torch.kernels.ops import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    want[prefill_kernel] += cfg.n_layers * prefills
    want[decode_kernel] += cfg.n_layers * decode_steps
    if cfg.hybrid_ssm:
        want["mamba_scan"] += cfg.n_layers * (prefills + decode_steps)
    return want


def check_counts(what: str, got: dict, want: dict) -> None:
    log(f"  launches in {what}: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")


def check_bodies(what: str, cfg, decode_steps: int) -> dict:
    """The recurrences' launches since the last reset split by body: a
    prefill's must run the chunked body and each decode step's the token
    body (WKV6's in an attention-free model, the Mamba scan's in a
    hybrid). Returns {"<kernel>_chunked": n, "<kernel>_token": n} for
    "wkv6" and "mamba_scan"."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.wkv6 import wkv6
    bodies = {}
    for name, fn, runs in (("wkv6", wkv6, cfg.attn_free),
                           ("mamba_scan", mamba_scan, cfg.hybrid_ssm)):
        token = fn.token_launches
        split = {f"{name}_chunked": fn.launches - token,
                 f"{name}_token": token}
        want = cfg.n_layers * decode_steps if runs else 0
        if runs:
            log(f"  {name} by body in {what}: {split} (token body expected "
                f"{want})")
        if token != want:
            raise AssertionError(f"{what}: {token} token-body launches of "
                                 f"{name}, expected {want}")
        bodies.update(split)
    return bodies


def serve_full_width(arch: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig, \
        preallocate_cache
    cfg, prompt_len = get_arch(arch), SERVED[arch]
    t0 = time.perf_counter()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    heads = f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of " \
        f"{cfg.rwkv_head_dim}" if cfg.attn_free else \
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, window " \
        f"{cfg.sliding_window}"
    if cfg.hybrid_ssm:
        heads += f", beside {cfg.n_heads * cfg.hd} Mamba channels of state " \
            f"{cfg.ssm_state}"
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, "
        f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params "
        f"({n_bytes / 1e9:.2f} GB) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=MAX_NEW),
                    device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (REQUESTS, prompt_len),
                            generator=gen, device="cuda")
    engine.generate(prompts[:, :16], max_new_tokens=2)     # warm-up

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ids = engine.generate(prompts)
    launches = ops.launch_counts()
    st = engine.stats
    log(f"generate: {REQUESTS} requests x {prompt_len} prompt tokens -> "
        f"{ids.shape[1]} new tokens each; prefill {st['prefill_ms']:.3f} ms, "
        f"decode {st['decode_ms_per_token']:.3f} ms/token "
        f"({REQUESTS * 1e3 / st['decode_ms_per_token']:.1f} tokens/s), "
        f"prefill {REQUESTS * prompt_len * 1e3 / st['prefill_ms']:.0f} "
        f"prompt tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    peak = torch.cuda.max_memory_allocated()
    check_counts("generate", launches, expected_counts(cfg, MAX_NEW - 1))
    launches.update(check_bodies("generate", cfg, MAX_NEW - 1))
    prefill_bound, decode_bound = serve_bounds(cfg, params, prompt_len)
    log(f"  bounds: prefill {prefill_bound[0]:.4f} ms ({prefill_bound[1]}), "
        f"decode {decode_bound[0]:.4f} ms/token ({decode_bound[1]})")
    if ids.shape != (REQUESTS, MAX_NEW) or ids.min() < 0 \
            or ids.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: {ids.shape}")

    toks = torch.as_tensor(ids, device="cuda").long()
    ops.reset_launches()
    by_kind(profile("prefill", lambda: prefill(params, cfg,
                                               {"tokens": prompts}),
                    st["prefill_ms"]))
    check_counts("one prefill", ops.launch_counts(), expected_counts(cfg, 0))
    check_bodies("one prefill", cfg, 0)
    _, pre, pos = prefill(params, cfg, {"tokens": prompts})
    caches = preallocate_cache(cfg, pre, prompt_len + MAX_NEW)
    del pre
    ops.reset_launches()
    profile("decode step", lambda: decode_step(params, cfg, toks[:, 0],
                                               caches, pos),
            st["decode_ms_per_token"])
    check_counts("one decode step", ops.launch_counts(),
                 expected_counts(cfg, 1, prefills=0))
    check_bodies("one decode step", cfg, 1)
    del caches
    compare_paths(params, cfg, {"tokens": prompts},
                  [toks[:, i] for i in range(3)])
    return {"launches": launches, "peak_bytes": peak, **st}


def serve_stub(arch: str) -> dict:
    """A stub-frontend model at full width and depth, which Engine refuses:
    prefill over REQUESTS x prompt embeddings, then MAX_NEW decode_steps
    each fed the next position's embeddings, all made from the seed as
    train/data.py makes a stub's batch; timed with CUDA events as Engine
    times its prefill and decode loop. Then the checks of
    serve_full_width."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import preallocate_cache
    from repro_torch.train.data import synth_batch
    cfg, prompt_len = get_arch(arch), STUB_SERVED[arch]
    t0 = time.perf_counter()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{arch} ({cfg.family}, embeddings from a stub frontend): "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.3f} B params ({n_bytes / 1e9:.2f} GB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    shape = ShapeConfig("stub_serve", "prefill", prompt_len + MAX_NEW,
                        REQUESTS)
    embeds = torch.from_numpy(synth_batch(cfg, shape, 0)["embeds"]).to(
        "cuda")
    prompts = embeds[:, :prompt_len]
    steps = [embeds[:, prompt_len + i] for i in range(MAX_NEW)]

    def serve(n_prompt: int, n_steps: int) -> tuple:
        with torch.no_grad():
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            logits, pre, pos = prefill(params, cfg,
                                       {"embeds": prompts[:, :n_prompt]})
            caches = preallocate_cache(cfg, pre, n_prompt + n_steps)
            del pre
            marks[1].record()
            for i in range(n_steps):
                logits, caches = decode_step(params, cfg, steps[i], caches,
                                             pos + i)
            marks[2].record()
            marks[2].synchronize()
        return logits, (marks[0].elapsed_time(marks[1]),
                        marks[1].elapsed_time(marks[2]) / max(1, n_steps))
    serve(16, 2)                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logits, (prefill_ms, decode_ms) = serve(prompt_len, MAX_NEW)
    launches = ops.launch_counts()
    st = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
          "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"prefill and {MAX_NEW} decode steps: {REQUESTS} x {prompt_len} "
        f"prompt positions; prefill {prefill_ms:.3f} ms, decode "
        f"{decode_ms:.3f} ms/step ({REQUESTS * 1e3 / decode_ms:.1f} "
        f"positions/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_counts("prefill and decode", launches,
                 expected_counts(cfg, MAX_NEW))
    prefill_bound, decode_bound = serve_bounds(cfg, params, prompt_len)
    log(f"  bounds: prefill {prefill_bound[0]:.4f} ms ({prefill_bound[1]}), "
        f"decode {decode_bound[0]:.4f} ms/token ({decode_bound[1]})")
    if logits.shape != (REQUESTS, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: last logits not finite or of shape "
                             f"{tuple(logits.shape)}")
    ops.reset_launches()
    profile("prefill", lambda: prefill(params, cfg, {"embeds": prompts}),
            prefill_ms)
    check_counts("one prefill", ops.launch_counts(), expected_counts(cfg, 0))
    _, pre, pos = prefill(params, cfg, {"embeds": prompts})
    caches = preallocate_cache(cfg, pre, prompt_len + MAX_NEW)
    del pre
    ops.reset_launches()
    profile("decode step", lambda: decode_step(params, cfg, steps[0],
                                               caches, pos), decode_ms)
    check_counts("one decode step", ops.launch_counts(),
                 expected_counts(cfg, 1, prefills=0))
    del caches
    compare_paths(params, cfg, {"embeds": prompts}, steps[:3])
    return {"launches": launches, **st}


def serve_bounds(cfg, params, prompt_len: int) -> tuple:
    """Least time for the prefill and for one decode step of the main path.
    Prefill: 2 flops per layer weight per prompt token, causal attention
    over the (query, key) pairs inside the window (or RWKV's fp32
    recurrence, ``wkv6_flops``), a hybrid's Mamba scan (``mamba_flops``),
    the LM head for the last token; it reads every weight but the
    embedding table once and writes a hybrid's Mamba states once. Decode:
    it reads the layer weights, the LM head, and the KV cache at its mean
    length over the decode loop, or the ring of a sliding window when that
    is shorter, once (or reads and writes RWKV's WKV states), and reads
    and writes a hybrid's Mamba states. Returns (prefill, decode), each
    (ms, bound by, work); work is {"flops": {part: flops}, "bytes": n},
    each part named as the roofline counter names its region ("dense":
    the matrix products; a kernel's name: its own work), so that phase 7
    holds the counted step to it."""
    from repro_torch.models.ssm import CONV_K
    layers = list(_leaves(params["layers"]))
    layer_params = sum(t.numel() for t in layers)
    layer_bytes = sum(t.numel() * t.element_size() for t in layers)
    # MoE: each token's products touch its k experts of E (the capacity's
    # padding is not counted); the reference's dispatch still runs every
    # expert's buffer through its weights, so a step reads all of them
    layer_flop_params = layer_params - cfg.n_layers * (
        cfg.n_experts - cfg.experts_per_token) * 3 * cfg.d_model * cfg.d_ff
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    head_bytes = head.numel() * head.element_size()
    L, tokens = cfg.n_layers, REQUESTS * prompt_len
    if cfg.attn_free:
        hd = cfg.rwkv_head_dim
        heads = cfg.d_model // hd
        seq = {"wkv6": L * wkv6_flops(tokens, heads, hd)[0]}
        step = {"wkv6": L * wkv6_flops(REQUESTS, heads, hd)[0]}
        cache_bytes = 2 * L * REQUESTS * heads * hd * hd * 4
    else:
        seq = {"flash_attention": 4 * REQUESTS * cfg.n_heads * cfg.hd * L
               * visible_pairs(prompt_len, cfg.sliding_window)}
        step = {}
        slots = prompt_len + MAX_NEW / 2
        if cfg.sliding_window is not None:
            slots = min(slots, cfg.sliding_window)
        cache_bytes = 2 * L * REQUESTS * slots * cfg.n_kv_heads \
            * cfg.hd * head.element_size()
    state_bytes = 0
    if cfg.hybrid_ssm:
        di = cfg.n_heads * cfg.hd
        seq["mamba_scan"] = L * mamba_flops(tokens, di, cfg.ssm_state)[0]
        step["mamba_scan"] = L * mamba_flops(REQUESTS, di, cfg.ssm_state)[0]
        state_bytes = 4 * L * REQUESTS * di * cfg.ssm_state \
            + L * REQUESTS * (CONV_K - 1) * di * head.element_size()
    prefill = {"dense": 2 * layer_flop_params * tokens
               + 2 * head.numel() * REQUESTS, **seq}
    decode = {"dense": 2 * (layer_flop_params + head.numel()) * REQUESTS,
              **step}
    out = []
    for parts, n_bytes in ((prefill, layer_bytes + head_bytes + state_bytes),
                           (decode, layer_bytes + head_bytes + cache_bytes
                            + 2 * state_bytes)):
        out.append((*bound_ms(n_bytes, typed_flops(parts)),
                    {"flops": parts, "bytes": n_bytes}))
    return tuple(out)


def typed_flops(parts: dict) -> dict:
    """{part: flops} -> {dtype: flops}: the recurrences run in fp32, the
    matrix products and attention in bf16."""
    fp32 = sum(v for k, v in parts.items() if k in FP32_PARTS)
    return {torch.bfloat16: sum(parts.values()) - fp32,
            torch.float32: fp32}


def model_logits(params, cfg, batch: dict, steps: list, impl: str) -> list:
    """Last-token logits of the prefill of ``batch`` ({"tokens"} or a stub's
    {"embeds"}), then of a decode step fed each of ``steps`` (ids (B,) or
    embeds (B, D); the same inputs for every path)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    logits, pre, pos = prefill(params, cfg, batch, impl=impl)
    caches = preallocate_cache(cfg, pre, next(iter(batch.values())).shape[1]
                               + MAX_NEW)
    del pre
    out = [logits]
    for i, x in enumerate(steps):
        logits, caches = decode_step(params, cfg, x, caches, pos + i,
                                     impl=impl)
        out.append(logits)
    return out


@contextlib.contextmanager
def routing(record=None, pinned=None):
    """Within the ``with`` block, every MoE call's (T, k) expert ids, in
    top-k order, are appended to ``record``; with ``pinned``, a list of
    such ids from another run of the same inputs, each call takes the next
    ids of it in place of its own top-k, its gates this call's router
    probabilities at those experts, renormalised as ``route`` does."""
    from repro_torch.models import moe
    real, pins = moe.route, iter(pinned or ())

    def route(p, x, cfg):
        gates, idx, probs = real(p, x, cfg)
        if pinned is not None:
            idx = next(pins)
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(dim=-1, keepdim=True)
        if record is not None:
            record.append(idx)
        return gates, idx, probs
    with mock.patch.object(moe, "route", route):
        yield


def routing_agreement(a: list, b: list) -> float:
    """Share of (token, layer) expert choices, as sets, equal in two
    runs."""
    same = sum(int((x.sort(dim=-1).values == y.sort(dim=-1).values)
                   .all(dim=-1).sum()) for x, y in zip(a, b))
    return same / sum(x.shape[0] for x in a)


def compare_depth(cfg, params, batch: dict) -> int:
    """The most layers whose fp32 copy (with the embedding and LM head's)
    fits the free device memory beside what is resident, leaving room for
    the activations: 4 GB and four fp32 score chunks of the plain
    attention."""
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    per_layer = 4 * sum(t.numel() for t in _leaves(params["layers"])) \
        / cfg.n_layers
    rest = 4 * sum(t.numel() for k, t in params.items() if k != "layers")
    b, s = next(iter(batch.values())).shape[:2]
    from repro_torch.kernels.flash_attention import PLAIN_CHUNK
    room = 4e9 + 4 * 4 * b * max(1, cfg.n_heads) * min(s, PLAIN_CHUNK) * s
    return max(1, min(cfg.n_layers, int((free - rest - room) // per_layer)))


def compare_paths(params, cfg, batch: dict, steps: list) -> None:
    """The served logits four ways: the bf16 weights, and the same weights
    widened to fp32, each through the kernels and through their plain
    versions (impl="reference") on the card. fp32 plain is the truth.
    Where the fp32 copy of every layer does not fit beside the bf16
    weights (moonshot, pixtral), all four run the first layers that fit.

    - fp32 kernels vs truth: relative L2 error <= FP32_REL_TOL; only the
      order of the attention (or WKV) sums differs.
    - bf16: rounding to bf16 in every layer of a random-init full-depth
      model moves the logits by ~1e-2 relative whichever kernel path
      runs, and the two paths round independently, so they are as far
      from each other as from the truth. The kernel path must be about as
      close to the truth as the plain path: error <= BF16_ERR_RATIO x the
      plain path's error. This is a loose guard; the fp32 comparison and
      the kernel checks of phase 2 are the tight ones.
    - MoE: top-k routing is discontinuous. At random init a token's 6th
      and 7th experts are often close, and a bf16 rounding that flips one
      changes that token's later layers, so two bf16 paths of moonshot
      differ in about a third of their (token, layer) choices, and their
      logits by far more than rounding (0.35 and 0.49 from the truth at
      depth 9 on an H100). The share of choices on which each dtype's two
      paths agree is printed, with the bf16 errors under each path's own
      routing; the bf16 guard then runs both bf16 paths again routed as
      the truth was (``routing(pinned=...)``: the same experts, each
      path's own gates), which leaves the kernels' rounding as the one
      difference. The fp32 check is unchanged: its paths route by
      themselves.
    """
    depth = compare_depth(cfg, params, batch)
    if depth < cfg.n_layers:
        log(f"  compare_paths at depth {depth} of {cfg.n_layers}: the fp32 "
            f"copy of every layer does not fit beside the bf16 weights")
        params = {**params, "layers": _map(params["layers"],
                                           lambda t: t[:depth])}
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params32 = _map(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    runs, routes = {}, {}
    for dt, p, c in (("bf16", params, cfg), ("fp32", params32, cfg32)):
        for impl in ("kernel", "reference"):
            routes[dt, impl] = []
            with routing(record=routes[dt, impl]):
                runs[dt, impl] = model_logits(p, c, batch, steps, impl)
    del params32
    guard = runs          # the runs the bf16 guard compares
    if cfg.is_moe:
        shares = {dt: routing_agreement(routes[dt, "kernel"],
                                        routes[dt, "reference"])
                  for dt in ("bf16", "fp32")}
        log("  MoE routing, share of (token, layer) expert choices equal on "
            "the kernel and plain paths: " + ", ".join(
                f"{dt} {share:.6f}" for dt, share in shares.items())
            + f" (of {sum(x.shape[0] for x in routes['fp32', 'kernel'])})")
        truth_routes = routes["fp32", "reference"]
        guard = dict(runs)
        for impl in ("kernel", "reference"):
            with routing(pinned=truth_routes):
                guard["bf16", impl] = model_logits(params, cfg, batch,
                                                   steps, impl)
    for i in range(4):
        name = "prefill" if i == 0 else f"decode {i}"
        truth = runs["fp32", "reference"][i]
        got = {key: run[i] for key, run in runs.items()}
        for key, t in [*got.items(), *((k, r[i]) for k, r in guard.items())]:
            if t.shape != (REQUESTS, cfg.vocab_size) or \
                    not torch.isfinite(t).all():
                raise AssertionError(f"{name} logits {key}: not finite or "
                                     f"wrong shape {tuple(t.shape)}")
        e32 = rel_err(got["fp32", "kernel"], truth)
        bk, br = guard["bf16", "kernel"][i], guard["bf16", "reference"][i]
        ek, er, ekr = rel_err(bk, truth), rel_err(br, truth), rel_err(bk, br)
        own = ""
        if cfg.is_moe:
            own = (f"; with their own routing: bf16 kernels "
                   f"{rel_err(got['bf16', 'kernel'], truth):.3e}, bf16 plain "
                   f"{rel_err(got['bf16', 'reference'], truth):.3e}")
        log(f"  logits {name} (rel L2 vs fp32 plain): fp32 kernels {e32:.3e} "
            f"(tol {FP32_REL_TOL}); bf16 kernels {ek:.3e}, bf16 plain "
            f"{er:.3e} (tol {BF16_ERR_RATIO} x plain"
            f"{', routed as the fp32 plain path' if cfg.is_moe else ''}); "
            f"bf16 kernels vs bf16 plain {ekr:.3e}, max abs "
            f"{max_err(bk, br):.3e} (|logit| max "
            f"{truth.abs().max().item():.2f}){own}")
        if e32 > FP32_REL_TOL or ek > BF16_ERR_RATIO * er:
            raise AssertionError(f"{name}: the kernel path's logits "
                                 f"disagree with the plain path's")


def profile(label: str, fn, step_ms: float, top: int = 8,
            shapes: bool = False):
    """Device time of one call by kernel, from torch.profiler, beside the
    call's time measured without the profiler (``step_ms``). Returns the
    profiler's averages by event (with ``shapes``, by event and input
    shapes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=shapes) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages(group_by_input_shape=shapes)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in averages
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"profile {label}: the profiler saw no kernels: device time "
            f"not measured")
        return averages
    log(f"profile {label}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
        f"({100 * busy / step_ms:.1f} %), {sum(r[1] for r in rows)} kernels;"
        f" by kernel:")
    for ms, n, key in rows[:top]:
        log(f"    {ms:9.3f} ms {n:5d}x  {key[:100]}")
    return averages


def dispatch_shares(averages, cfg) -> None:
    """The MoE layer's device time by part, forward, remat recompute and
    backward together, from a profile by operator and input shape: each
    operator's kernels, told from other layers' uses of the same operator
    by its first input's shape (the expert products' leading dim is E,
    the routing softmax's last dim E, the embedding's index and its
    gradient's scatter lead with the vocab)."""
    from torch.autograd import DeviceType
    e, v = cfg.n_experts, cfg.vocab_size

    def part(ev):
        shape = next(iter(ev.input_shapes or []), None) or []
        lead = shape[0] if shape else None
        if ev.key == "aten::bmm":
            # (E, rows, d or f) operands; attention's backward leads with
            # B x heads and ends with hd
            return "expert bmm" if lead == e and (
                cfg.d_model in shape or cfg.d_ff in shape) else None
        if ev.key == "aten::topk" or (
                ev.key in ("aten::_softmax", "aten::_softmax_backward_data")
                and shape and shape[-1] == e):
            return "routing (softmax, top-k)"
        if ev.key in ("aten::one_hot", "aten::cumsum"):
            return "one_hot and cumsum"
        if ev.key == "aten::_index_put_impl_":
            return "index_put_ (scatter)" if lead != v else None
        if ev.key == "aten::index" or (ev.key == "aten::gather"
                                       and lead == e):
            return "gather" if lead != v else None
        return None

    sums: dict = {}
    for ev in averages:
        name = part(ev) if ev.device_type == DeviceType.CPU else None
        if name:
            ms, n = sums.get(name, (0.0, 0))
            sums[name] = (ms + ev.device_time_total / 1e3, n + ev.count)
    busy = sum(ev.self_device_time_total for ev in averages
               if ev.device_type == DeviceType.CUDA) / 1e3
    dispatch = sum(ms for k, (ms, _) in sums.items() if k != "expert bmm")
    log(f"  MoE layer by part, of {busy:.1f} ms busy in the microbatch: "
        + "; ".join(f"{k} {ms:.1f} ms ({100 * ms / busy:.1f} %, {n} calls)"
                    for k, (ms, n) in sums.items())
        + f"; the dispatch (all but the expert bmm) {dispatch:.1f} ms "
        f"({100 * dispatch / busy:.1f} %)")
    if "expert bmm" not in sums or dispatch <= 0:
        raise AssertionError(f"the MoE profile found no expert bmm or no "
                             f"dispatch: {sums}")


def _leaves(tree) -> list:
    from repro_torch.bridge import flatten_tree
    return list(flatten_tree(tree).values())


# ----------------------------------------------------------- phase 3b
def sweep_depth_one() -> None:
    """Every config, at full width and depth 1 in fp32: a prefill of
    REQUESTS x SWEEP_LEN positions and 3 decode steps through the kernels,
    their launches counted, against the plain versions within
    FP32_REL_TOL. Each model is freed before the next."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train.data import synth_batch
    for name, full in ARCHS.items():
        cfg = dataclasses.replace(full, n_layers=1, param_dtype="float32")
        t0 = time.perf_counter()
        params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        data = synth_batch(cfg, ShapeConfig("sweep", "prefill",
                                            SWEEP_LEN + 3, REQUESTS), 0)
        key = "embeds" if cfg.embedding_stub else "tokens"
        x = torch.from_numpy(data[key]).to("cuda")
        if key == "tokens":
            x = x.long()
        batch, steps = {key: x[:, :SWEEP_LEN]}, [x[:, SWEEP_LEN + i]
                                                  for i in range(3)]
        ops.reset_launches()
        with torch.no_grad():
            got = model_logits(params, cfg, batch, steps, "kernel")
            counts = ops.launch_counts()
            want = model_logits(params, cfg, batch, steps, "reference")
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        heads = "no attention" if cfg.attn_free else \
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, window " \
            f"{cfg.sliding_window}"
        log(f"{name} depth 1 fp32 ({heads}; {n_bytes / 1e9:.2f} GB, "
            f"{time.perf_counter() - t0:.1f} s): rel L2 kernel vs plain, "
            f"prefill and 3 decode steps: "
            + ", ".join(f"{e:.3e}" for e in errs)
            + f" (tol {FP32_REL_TOL}); launches {counts}")
        check_counts(f"{name} depth 1", counts, expected_counts(cfg, 3))
        check_bodies(f"{name} depth 1", cfg, 3)
        if max(errs) > FP32_REL_TOL or not all(
                torch.isfinite(g).all() and g.shape == (REQUESTS,
                                                         cfg.vocab_size)
                for g in got):
            raise AssertionError(f"{name} depth 1: kernel and plain paths "
                                 f"disagree: {errs}")
        del params, got, want, batch, steps, x
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4
def small_models_cpu_vs_card() -> None:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig
    rwkv = dataclasses.replace(get_arch("rwkv6-3b").reduced(),
                               param_dtype="float32")
    # the reduced configs' hd 16 has no kernel instance: heads of 32
    moe = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").reduced(),
                              head_dim=32, param_dtype="float32")
    hybrid = dataclasses.replace(get_arch("hymba-1.5b").reduced(),
                                 head_dim=32, param_dtype="float32")
    for cfg in (PRESETS["tiny"], rwkv, moe, hybrid):
        params = init_params(torch.Generator("cpu").manual_seed(0), cfg)
        prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                                generator=torch.Generator("cpu").manual_seed(1))
        on_card = _map(params, lambda t: t.to("cuda"))
        cpu_logits, _, _ = prefill(params, cfg, {"tokens": prompts})
        gpu_logits, _, _ = prefill(on_card, cfg, {"tokens": prompts.to("cuda")})
        err = max_err(gpu_logits.cpu(), cpu_logits)
        scfg = ServeConfig(max_new_tokens=8)
        ids_cpu = Engine(cfg, params, scfg, device="cpu").generate(prompts)
        ids_gpu = Engine(cfg, on_card, scfg, device="cuda").generate(prompts)
        log(f"{cfg.name} fp32, card vs CPU: prefill logits max abs err "
            f"{err:.3e}; greedy ids equal: {(ids_cpu == ids_gpu).all()}")
        if err > 1e-3 or not (ids_cpu == ids_gpu).all():
            raise AssertionError(f"{cfg.name}: card and CPU disagree")


# ------------------------------------------------------------ phase 5
def attention_grads(q, k, v, dout, impl: str, window=None) -> list:
    """(dq, dk, dv) by autograd through ops.flash_attention: the training
    forward and the backward kernels, or the plain version (reference)."""
    from repro_torch.kernels import ops
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*leaves, window=window, impl=impl).backward(dout)
    return [t.grad for t in leaves]


def attention_train_shape(arch: str) -> dict:
    """``arch``'s attention in a train step: its microbatch of TRAIN_SEQ
    tokens, heads, head dim and window."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return {"b": TRAIN_BATCH // cfg.grad_accum, "s": TRAIN_SEQ,
            "h": cfg.n_heads, "hkv": cfg.n_kv_heads, "hd": cfg.hd,
            "window": cfg.sliding_window}


def check_backward_against_autograd(label: str, gen, b, s, h, hkv, hd,
                                    window, mutants: bool = False) -> list:
    """FlashAttentionFn (the training forward and the backward kernels)
    against autograd through the plain version at one shape: fp32 within
    REL_TOL (rel L2) for dq, dk, dv; bf16 within BWD_BF16_RATIO x the
    plain path's own bf16 error against fp32. With ``mutants``, two
    mutants of the plain backward (the sum(P dP) term dropped; a mask that
    lets each query see the next key) must fail the fp32 limit. Returns
    the bf16 inputs [q, k, v, dout]."""
    from repro_torch.kernels import flash_attention as fa
    q = randn(gen, (b, s, h, hd), torch.float32)
    k = randn(gen, (b, s, hkv, hd), torch.float32)
    v = randn(gen, (b, s, hkv, hd), torch.float32, 1.0)
    dout = randn(gen, (b, s, h, hd), torch.float32, 1.0)
    what = f"{label} B={b} S={s} {h}/{hkv} heads of {hd}, window {window}"
    truth = attention_grads(q, k, v, dout, "reference", window)
    got = attention_grads(q, k, v, dout, "kernel", window)
    errs = [rel_err(g, t) for g, t in zip(got, truth)]
    log(f"  {what} fp32: rel L2 dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
        f"{errs[2]:.3e} (limit {REL_TOL[torch.float32]})")
    if max(errs) > REL_TOL[torch.float32]:
        raise AssertionError(f"attention backward, {what}: {errs}")
    if mutants:
        real_mask = fa._mask
        cases = {
            "sum(P dP) dropped": ("_softmax_grad", lambda p, dp: dp.mul_(p)),
            "mask sees the next key": (
                "_mask", lambda qpos, kpos, w: real_mask(qpos + 1, kpos, w))}
        for name, (attr, fn) in cases.items():
            with mock.patch.object(fa, attr, fn):
                mut = fa.flash_attention_bwd(q, k, v, dout, window)
            rel = max(rel_err(g, t) for g, t in zip(mut, truth))
            log(f"  mutant ({name}): rel L2 {rel:.3e} (must exceed "
                f"{REL_TOL[torch.float32]})")
            if rel <= REL_TOL[torch.float32]:
                raise AssertionError(f"the backward check cannot tell the "
                                     f"mutant {name}")
    del truth, got
    bf = [t.to(torch.bfloat16) for t in (q, k, v, dout)]
    truth = attention_grads(*(t.float() for t in bf), "reference", window)
    got = attention_grads(*bf, "kernel", window)
    plain = attention_grads(*bf, "reference", window)
    for name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        ek, ep = rel_err(g, t), rel_err(p, t)
        log(f"  {what} bf16 {name}: rel L2 vs fp32 {ek:.3e}, plain path's "
            f"{ep:.3e} (limit {BWD_BF16_RATIO} x)")
        if ek > BWD_BF16_RATIO * ep or g.dtype != torch.bfloat16:
            raise AssertionError(f"attention backward bf16 {name}, {what}: "
                                 f"{ek} vs plain {ep}")
    return bf


def check_attention_backward() -> dict:
    """Phase 5a. The attention backward through FlashAttentionFn against
    autograd through the plain version at the serving shape (with the
    mutants) and at each ATTENTION_TRAINED model's training shape, where
    bf16 must run the Hopper (wgmma, TMA) bodies; the kernel's bf16 forward
    and log-sum-exp against their plain versions at the FORWARD_TRAINED
    models'; then, at each training shape, the backward kernels against
    their plain version, timed (``time_attention_backward``). Returns
    {"bwd_ms": {model: kernel ms}, "entries": JSON entries}."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(3)
    log("flash attention backward (FlashAttentionFn: the training forward "
        "and the backward kernels) vs autograd through the plain version:")
    check_backward_against_autograd("serving", gen, REQUESTS, PROMPT_LEN, 32,
                                    8, 128, None, mutants=True)
    bwd_ms, entries = {}, []
    for suffix, arch in ATTENTION_TRAINED.items():
        shape = attention_train_shape(arch)
        body = fa.backward_body(shape["hd"], torch.bfloat16)
        log(f"  {arch}: bf16 at hd {shape['hd']} runs the {body} bodies")
        if body != "wgmma":
            raise AssertionError(f"{arch}: bf16 at hd {shape['hd']} runs the "
                                 f"{body} bodies, not the Hopper ones")
        q, k, v, dout = check_backward_against_autograd(
            f"{arch} training", gen, **shape)
        window = shape["window"]
        entry = None
        if suffix in FORWARD_TRAINED:
            entry = check_training_forward(suffix, q, k, v, window)
        bwd = time_attention_backward(suffix, arch, q, k, v, dout, window)
        bwd_ms[arch] = bwd["ms"]
        entries += [e for e in (entry, bwd) if e is not None]
        del q, k, v, dout
        free()
    return {"bwd_ms": bwd_ms, "entries": entries}


def check_training_forward(suffix: str, q, k, v, window) -> dict:
    """The kernel's bf16 training forward at a training shape (the body
    each train step launches 2 x layers x microbatches times; the Hopper
    one, asserted, and two runs bit-equal) against its plain version, out
    with the temperature mutant and each row's log-sum-exp within
    LSE_ATOL; timed beside the plain forward, SDPA's
    forward (``sdpa_operands``) and its bound. Returns the JSON entry
    "flash_attention_train" + suffix."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hd = q.shape
    want, want_lse = fa.flash_attention_train_plain(q, k, v, window)
    name = f"training forward B={b} S={s} {h}/{k.shape[2]} heads of {hd}, " \
        f"window {window}, bf16"
    body = fa.forward_body(hd, q.dtype)
    out, lse = fa.flash_attention_train(q, k, v, window)
    again, lse_again = fa.flash_attention_train(q, k, v, window)
    same = torch.equal(out, again) and torch.equal(lse, lse_again)
    log(f"  {name}: the {body} body; two runs give the same bits: {same}")
    if body != "wgmma" or not same:
        raise AssertionError(f"{name}: the {body} body, bit-equal {same}")
    del again, lse_again
    err = assert_close(name, out, want)
    assert_mutant_caught(name, fa.flash_attention_plain(q * MUTANT_TEMP, k,
                                                        v, window), want)
    lse_err = max_err(lse, want_lse)
    log(f"  {name}, log-sum-exp: max_abs_err {lse_err:.3e} (limit "
        f"{LSE_ATOL})")
    if lse_err > LSE_ATOL or lse.dtype != torch.float32:
        raise AssertionError(f"{name}: log-sum-exp disagrees ({lse_err})")
    del want, want_lse, out, lse
    fwd_flops = 4 * b * h * hd * visible_pairs(s, window)
    # Q, K, V read once, O (the size of Q) written once
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {q.dtype: fwd_flops})
    fwd = time_ms(lambda: fa.flash_attention_train(q, k, v, window), 10)
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, window), 2,
                    warmup=1)
    operands, kw = sdpa_operands(q, k, v, window)
    lib = time_ms(lambda: F.scaled_dot_product_attention(*operands, **kw),
                  10)
    log(f"  {name}: kernel forward with log-sum-exp {fwd:.4f} ms (plain "
        f"{plain:.4f}, SDPA{' (window mask)' if 'attn_mask' in kw else ''} "
        f"{lib:.4f}, bound {bound:.4f} ms by {by}), {fwd / bound:.2f}x the "
        f"bound")
    return {"name": f"flash_attention_train{suffix}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:75",
            "max_abs_err": err, "ms": fwd, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def sdpa_backward(q, k, v, dout, window):
    """One PyTorch call computing the attention backward, for its time: a
    closure running SDPA's backward alone (its forward run once, its graph
    kept), on ``sdpa_operands``: causal where the window is None or covers
    S, else with a window mask."""
    import torch.nn.functional as F
    operands, kw = sdpa_operands(q, k, v, window)
    dt = dout.transpose(1, 2).contiguous()
    leaves = [t.detach().requires_grad_(True) for t in operands]
    out = F.scaled_dot_product_attention(*leaves, **kw)
    return lambda: torch.autograd.grad(out, leaves, dt, retain_graph=True)


def time_attention_backward(suffix: str, arch: str, q, k, v, dout,
                            window) -> dict:
    """The backward kernels at ``arch``'s training shape in bf16 against
    their plain version on the same inputs (``flash_attention_bwd`` given
    the training forward's out and log-sum-exp): each gradient within
    REL_TOL (rel L2) and TOL of its largest magnitude, and two runs
    bit-equal (the sums run in a fixed order); timed beside that
    plain version, the old torch-ops backward (``flash_attention_bwd``
    from q, k, v alone, which the Function ran on the card before the
    kernels), SDPA's backward and the bound: four products over the
    visible pairs (twice the forward's); q, k, v, out, its log-sum-exp and
    dout read once, dq, dk, dv written once. Returns the JSON entry
    "flash_attention_bwd" + suffix."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hd = q.shape
    out, lse = fa.flash_attention_train(q, k, v, window)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, window)
    again = fa.flash_attention_backward(q, k, v, out, lse, dout, window)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    want = fa.flash_attention_bwd(q, k, v, dout, window, out=out, lse=lse)
    what = f"flash_attention_backward, {arch} B={b} S={s} {h}/{k.shape[2]} " \
        f"heads of {hd}, window {window}, bf16"
    log(f"  {what}: two runs give the same bits: {same}")
    if not same:
        raise AssertionError(f"{what}: two runs on the same inputs differ")
    del again
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e, rel = max_err(g, w), rel_err(g, w)
        scale = w.float().abs().max().item()
        log(f"  {what} vs its plain version, {name}: max_abs_err {e:.3e} "
            f"(limit {TOL[torch.bfloat16]} x max |plain| {scale:.3e}), rel "
            f"L2 {rel:.3e} (limit {REL_TOL[torch.bfloat16]})")
        if e > TOL[torch.bfloat16] * scale or rel > REL_TOL[torch.bfloat16] \
                or not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{what} {name}: kernel disagrees with its "
                                 f"plain version ({e}, {rel})")
        err = max(err, e)
    del got, want
    pairs = visible_pairs(s, window)
    flops = 8 * b * h * hd * pairs
    n_bytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) \
        * q.element_size() + lse.numel() * 4
    bound, by = bound_ms(n_bytes, {q.dtype: flops})
    ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout,
                                                     window), 10)
    plain = time_ms(lambda: fa.flash_attention_bwd(
        q, k, v, dout, window, out=out, lse=lse), 3, warmup=1)
    old = time_ms(lambda: fa.flash_attention_bwd(q, k, v, dout, window), 3,
                  warmup=1)
    lib = time_ms(sdpa_backward(q, k, v, dout, window), 5, warmup=1)
    log(f"  {what}: kernels {ms:.4f} ms, plain version {plain:.4f} ms, "
        f"the old torch-ops backward {old:.4f} ms, SDPA's backward alone"
        f"{' (window mask)' if window and window < s else ''} {lib:.4f} ms, "
        f"bound {bound:.4f} ms ({by}), {ms / bound:.2f}x the bound")
    return {"name": f"flash_attention_bwd{suffix}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:91",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "torch_ops_ms": old}


def train_bound(cfg, seqs: int) -> tuple[float, str, float]:
    """Least time of one train step over ``seqs`` sequences of TRAIN_SEQ
    tokens: 6 flops per matmul parameter (layer projections and MLP, the
    k routed experts of a MoE layer and its fp32 router, or RWKV's
    channel mix, RWKV's time-mix projections and decay LoRA,
    Mamba's projections, the LM head; not the embedding gather) per token
    in bf16; causal attention's forward and its backward (2x) over the
    pairs inside the window, in bf16 (none for RWKV); the recurrence's
    fp32 flops, forward and backward (``wkv6_flops``, ``mamba_flops``).
    Bytes: the bf16 parameters read and written, the fp32 grad accumulator
    read, AdamW's m and v read and written, once each. Remat's recompute is
    not counted. Returns (ms, bound by, flops)."""
    parts = train_work(cfg, seqs)
    ms, by = bound_ms(cfg.param_count() * (2 * 2 + 4 + 2 * 8),
                      typed_flops(parts))
    return ms, by, sum(parts.values())


def train_work(cfg, seqs: int) -> dict:
    """``train_bound``'s flops by part, named as the roofline counter names
    its regions: "dense" (the bf16 matrix products), "router" (a MoE
    layer's fp32 router, in the counter's "dense"), a kernel's name for
    its forward, and the backward of its Function."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    tokens = seqs * TRAIN_SEQ
    parts = {}
    router = 0
    if cfg.attn_free:
        per_layer = 6 * d * d + 2 * d * f + 2 * d * 64
        fwd, bwd = wkv6_flops(tokens, d // cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim)
        parts.update(wkv6=fwd, Wkv6FnBackward=bwd)
    else:
        # MoE: the k experts a token is routed to, and arctic's dense
        # residual beside them; the fp32 router's flops below
        ffn = 3 * d * f * (cfg.experts_per_token + cfg.moe_dense_residual) \
            if cfg.is_moe else 3 * d * f
        per_layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
            + cfg.n_heads * hd * d + ffn
        if cfg.is_moe:
            router = 6 * d * cfg.n_experts * tokens
        attn = 4 * cfg.n_heads * hd * visible_pairs(TRAIN_SEQ,
                                                    cfg.sliding_window) * seqs
        parts.update(flash_attention=attn, FlashAttentionFnBackward=2 * attn)
    if cfg.hybrid_ssm:
        di, n = cfg.n_heads * hd, cfg.ssm_state
        per_layer += 3 * d * di + 2 * di * 64 + 2 * di * n
        fwd, bwd = mamba_flops(tokens, di, n)
        parts.update(mamba_scan=fwd, MambaScanFnBackward=bwd)
    if router:
        parts["router"] = router
    parts = {k: v * cfg.n_layers for k, v in parts.items()}
    matmul = cfg.n_layers * per_layer + d * cfg.vocab_size
    parts["dense"] = 6 * matmul * tokens
    return parts


def wkv6_flops(tokens: int, heads: int, hd: int) -> tuple[int, int]:
    """fp32 flops of the WKV6 recurrence over ``tokens`` tokens and
    ``heads`` heads, (forward, backward). Forward: 5 hd^2 a (token, head),
    as check_wkv6 counts. Backward, the vjp of the token loop: dS <- w dS +
    r dy^T (3 hd^2), dr = S dy, dk = dS v, dv = dS^T k, dw = the row sums
    of dS * S (2 hd^2 each): 11 hd^2."""
    return 5 * hd * hd * heads * tokens, 11 * hd * hd * heads * tokens


def mamba_flops(tokens: int, di: int, n: int) -> tuple[int, int]:
    """fp32 flops of the fused Mamba scan over ``tokens`` tokens of ``di``
    channels and ``n`` states, (forward, backward). Forward: 7 a (token,
    channel, state) and 10 a (token, channel), as mamba_fused_cost counts.
    Backward, the vjp of the token loop: dh <- da dh + c dy (3), d da =
    dh h (1) into d dt and d a_log (4), the gradients of dt x and of b
    (2 each), of c (2), and the vjps of softplus, the skip, silu and the
    gate: 14 a (token, channel, state) and 15 a (token, channel)."""
    return (7 * n + 10) * di * tokens, (14 * n + 15) * di * tokens


def recurrence_grads(fn, inputs: list, dout, impl: str) -> list:
    """The inputs' gradients by autograd through ``fn`` (ops.wkv6 or
    ops.mamba_scan, from zeros): the kernel's forward under its Function,
    or the plain loop (reference)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    fn(*leaves, impl=impl)[0].backward(dout)
    return [t.grad for t in leaves]


def chunk_by_chunk(bwd, inputs: list, seq: tuple, starts, dout) -> list:
    """A mutant of ``bwd`` (wkv6_backward or mamba_scan_backward): each
    TIME_CHUNK chunk's gradient from its own start state with the final
    gradient of the state taken as zero, so the state's gradient is not
    carried across the chunk boundary. ``seq`` are the indices of the
    (B, S, ...) inputs; the others' gradients are summed over the
    chunks."""
    from repro_torch.kernels.wkv6 import TIME_CHUNK
    parts = []
    for i in range(starts.shape[1]):
        part = slice(i * TIME_CHUNK, (i + 1) * TIME_CHUNK)
        sliced = [t[:, part] if j in seq else t for j, t in enumerate(inputs)]
        parts.append(bwd(*sliced, starts[:, i:i + 1], dout[:, part]))
    return [torch.cat(g, dim=1) if j in seq else sum(g)
            for j, g in enumerate(zip(*parts))]


def check_grads(what: str, got: list, truth: list) -> float:
    """Each gradient within REL_TOL (fp32, rel L2) of autograd through the
    plain loop, finite. Returns the largest rel L2."""
    errs = [rel_err(g, t) for g, t in zip(got, truth)]
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    log(f"  {what}: rel L2 per input " + ", ".join(f"{e:.3e}" for e in errs)
        + f" (limit {REL_TOL[torch.float32]})")
    if max(errs) > REL_TOL[torch.float32] or not finite:
        raise AssertionError(f"{what}: gradients disagree: {errs}")
    return max(errs)


def check_mutant_grads(what: str, mutant: list, truth: list) -> None:
    rel = max(rel_err(g, t) for g, t in zip(mutant, truth))
    log(f"  mutant ({what}): rel L2 {rel:.3e} (must exceed "
        f"{REL_TOL[torch.float32]})")
    if rel <= REL_TOL[torch.float32]:
        raise AssertionError(f"the backward check cannot tell the mutant "
                             f"{what}")


def wkv6_train_inputs(gen, b: int, s: int) -> list:
    """rwkv6-3b's recurrence inputs (H=40, hd=64, fp32), as check_wkv6
    draws them: r, k, v ~ N(0, 0.5), u ~ N(0, 0.5), and in the decay's
    place x ~ N(-5, 2), whose exp(-exp(x)) (``decay``) spans ~1 (the state
    kept over the whole sequence) to ~0 and at the far tail underflows to
    0, as the model's rwkv_decay would. Returns [r, k, v, x, u]."""
    shape = (b, s, RWKV_HEADS, RWKV_HD)
    r, k, v = (randn(gen, shape, torch.float32, 0.5) for _ in range(3))
    x = randn(gen, shape, torch.float32, 2.0) - 5
    return [r, k, v, x, randn(gen, shape[-2:], torch.float32, 0.5)]


def decay(inputs: list) -> list:
    """[r, k, v, x, u] -> [r, k, v, w = exp(-exp(x)), u]."""
    r, k, v, x, u = inputs
    return [r, k, v, torch.exp(-torch.exp(x)), u]


def wkv6_model(r, k, v, x, u, impl: str):
    """ops.wkv6 fed the model's decay of x: the gradient that reaches x is
    the one the model's rwkv_decay passes on. (Where exp(-exp(x))
    underflows, the backward kernel and wkv6_bwd give dw = 0; both paths
    then pass 0 on to x.)"""
    from repro_torch.kernels import ops
    return ops.wkv6(r, k, v, torch.exp(-torch.exp(x)), u, impl=impl)


def mamba_train_inputs(gen, b: int, s: int, dtype, n: int = MAMBA_N
                       ) -> list:
    """hymba-1.5b's fused-scan inputs (di=1600, n=16 unless given), as
    check_mamba_scan draws them: dt_raw ~ N(-2, 2), dt_bias ~ N(0, 0.3), b,
    c, x, z ~ N(0, 1) in ``dtype`` (b and c the halves of one projection,
    z the second half of another), a_log = log(1..n) + N(0, 0.3), d_skip
    ~ 1 + N(0, 0.5)."""
    f32 = torch.float32
    bc = randn(gen, (b, s, 2 * n), dtype, 1.0)
    zz = randn(gen, (b, s, 2 * MAMBA_DI), dtype, 1.0)
    a_log = torch.log(torch.arange(1, n + 1, device="cuda").float()) \
        + randn(gen, (MAMBA_DI, n), f32, 0.3)
    return [(randn(gen, (b, s, MAMBA_DI), f32, 2.0) - 2.0).to(dtype),
            randn(gen, (MAMBA_DI,), f32, 0.3), bc[..., :n], bc[..., n:],
            randn(gen, (b, s, MAMBA_DI), dtype, 1.0), zz[..., MAMBA_DI:],
            a_log, 1.0 + randn(gen, (MAMBA_DI,), f32, 0.5)]


def wkv6_plain_chain(r, k, v, w, u) -> tuple:
    """The plain recurrence (wkv6_plain) chunk by chunk, each TIME_CHUNK
    tokens from the last chunk's state: (y, final state, the state at each
    chunk's start)."""
    from repro_torch.kernels.wkv6 import TIME_CHUNK, wkv6_plain
    b, s, h, hd = r.shape
    state = torch.zeros((b, h, hd, hd), device=r.device)
    starts, ys = [], []
    for c0 in range(0, s, TIME_CHUNK):
        starts.append(state.clone())
        ys.append(wkv6_plain(*(t[:, c0:c0 + TIME_CHUNK] for t in (r, k, v, w)),
                             u, state)[0])
    return torch.cat(ys, 1), state, torch.stack(starts, 1)


def mamba_chain(plain: bool, dt, dt_bias, b, c, x, z, a_log, d_skip
                ) -> tuple:
    """The fused scan chunk by chunk, each TIME_CHUNK steps from the last
    chunk's state: its kernel launched once a chunk (the training
    forward's route before it kept the starts itself), or with ``plain``
    its plain version. Returns (out, final state, the state at each
    chunk's start)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels.wkv6 import TIME_CHUNK
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, a_log.shape[1]), device=dt.device)
    fn = ms.mamba_scan_plain if plain else ms.mamba_scan
    starts, outs = [], []
    for c0 in range(0, s, TIME_CHUNK):
        starts.append(h.clone())
        dt_c, b_c, c_c, x_c, z_c = (t[:, c0:c0 + TIME_CHUNK]
                                    for t in (dt, b, c, x, z))
        outs.append(fn(dt_c, dt_bias, b_c, c_c, x_c, z_c, a_log, d_skip,
                       h)[0])
    return torch.cat(outs, 1), h, torch.stack(starts, 1)


def check_starts(what: str, got, want, fade) -> None:
    """A training forward's starts (B, chunks, ...) against the plain
    chain's, within the scan's fp32 limits, and two mutants of the carry
    that must fail them: start_{c+1} = start_c + G_c, the carry without
    the fade (G_c = start_{c+1} - fade_c start_c, the chunk's own part),
    and every start written one chunk late. ``fade``: each chunk's decay
    of its start state, broadcast to a start's shape."""
    assert_close_scan(f"{what}, every chunk's start", got, want)
    g = want[:, 1:] - fade[:, :-1] * want[:, :-1]
    mutants = {"the carry without the fade":
               torch.cat([want[:, :1], want[:, :1] + g.cumsum(1)], 1),
               "the starts one chunk late":
               torch.cat([torch.zeros_like(want[:, :1]), want[:, :-1]], 1)}
    for name, mutant in mutants.items():
        assert_mutant_caught(f"{what}, starts", mutant, want, name)


def wkv6_fades(w, chunk: int) -> torch.Tensor:
    """Each chunk's decay of its start state, prod_t w_t (B, chunks, H, hd,
    1); S a multiple of ``chunk``."""
    b, s, h, hd = w.shape
    return w.view(b, s // chunk, chunk, h, hd).prod(2)[..., None]


def mamba_fades(dt_raw, dt_bias, a_log, chunk: int) -> torch.Tensor:
    """Each chunk's decay of its start state, exp(a * the chunk's sum of
    dt) (B, chunks, di, n); S a multiple of ``chunk``."""
    import torch.nn.functional as F
    b, s, di = dt_raw.shape
    dt = F.softplus(dt_raw.float() + dt_bias)
    return torch.exp(dt.view(b, s // chunk, chunk, di).sum(2)[..., None]
                     * -torch.exp(a_log))


def check_recurrence_backward() -> dict:
    """Wkv6Fn and MambaScanFn (the kernels' forward one launch per
    TIME_CHUNK steps; the backwards the two backward kernels) against
    autograd through the plain loops, at each family's full width across
    RECURRENT_CHECK_SEQ // 256 remat chunks: WKV6 in fp32, the scan in
    fp32 (rel L2 within REL_TOL) and bf16 (within BWD_BF16_RATIO x the
    plain path's own error against fp32). A mutant of each backward (the
    state's gradient not carried across the chunk boundary: each backward
    kernel run chunk by chunk) must fail the fp32 limit. Then each
    forward and backward is timed at its model's training microbatch.
    Returns {"entries": JSON entries "wkv6_train", "wkv6_backward",
    "mamba_scan_train" and "mamba_scan_bwd", "bwd_ms": {(backward,
    model): backward ms}}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator("cuda").manual_seed(6)
    b, s = TRAIN_MICRO, RECURRENT_CHECK_SEQ
    log(f"recurrence backwards (Wkv6Fn, MambaScanFn: the kernels' forward "
        f"per {wk.TIME_CHUNK}-step chunk, the backward kernels) vs "
        f"autograd through the plain loops, B={b}, S={s}:")
    inputs = wkv6_train_inputs(gen, b, s)
    dy = randn(gen, (b, s, RWKV_HEADS, RWKV_HD), torch.float32, 1.0)
    truth = recurrence_grads(wkv6_model, inputs, dy, "reference")
    check_grads(f"wkv6 H={RWKV_HEADS} hd={RWKV_HD} fp32, dr dk dv dx du "
                f"(x the decay's exp(-exp(x)))",
                recurrence_grads(wkv6_model, inputs, dy, "kernel"), truth)
    w = decay(inputs)
    _, _, starts = wk.wkv6_chunk_states(*w)
    mutant = chunk_by_chunk(wk.wkv6_backward, w, (0, 1, 2, 3), starts, dy)
    mutant[3] = mutant[3] * w[3] * -torch.exp(inputs[3])     # dw -> dx
    check_mutant_grads("wkv6_backward, dState not carried across a chunk",
                       mutant, truth)
    seq = (0, 2, 3, 4, 5)
    for dtype in (torch.float32, torch.bfloat16):
        inputs = mamba_train_inputs(gen, b, s, dtype)
        dout = randn(gen, (b, s, MAMBA_DI), dtype, 1.0)
        what = f"mamba_scan di={MAMBA_DI} n={MAMBA_N} {str(dtype)[6:]}"
        if dtype == torch.float32:
            truth = recurrence_grads(ops.mamba_scan, inputs, dout,
                                     "reference")
            check_grads(f"{what}, d dt_raw, dt_bias, b, c, x, z, a_log, "
                        f"d_skip", recurrence_grads(ops.mamba_scan, inputs,
                                                    dout, "kernel"), truth)
            _, _, starts = ms.mamba_chunk_states(*inputs)
            check_mutant_grads("mamba_scan_backward, dState not carried "
                               "across a chunk", chunk_by_chunk(
                                   ms.mamba_scan_backward, inputs, seq,
                                   starts, dout), truth)
            continue
        wide = [t.float() for t in inputs]
        truth = recurrence_grads(ops.mamba_scan, wide, dout.float(),
                                 "reference")
        got = recurrence_grads(ops.mamba_scan, inputs, dout, "kernel")
        plain = recurrence_grads(ops.mamba_scan, inputs, dout, "reference")
        names = ("dt_raw", "dt_bias", "b", "c", "x", "z", "a_log",
                 "d_skip")
        for name, g, p, t in zip(names, got, plain, truth):
            ek, ep = rel_err(g, t), rel_err(p, t)
            log(f"  {what}, d {name}: rel L2 vs fp32 {ek:.3e}, plain "
                f"path's {ep:.3e} (limit {BWD_BF16_RATIO} x)")
            if ek > BWD_BF16_RATIO * ep or g.dtype != p.dtype:
                raise AssertionError(f"{what} d {name}: {ek} vs plain "
                                     f"{ep}")
    del truth, inputs
    check_backward_edges()
    return time_recurrences_training()


def time_recurrences_training() -> dict:
    """Each recurrence's forward (the Function's: one kernel launch per
    TIME_CHUNK steps from the previous chunk's state) against its plain
    loop, and its backward, at its model's training microbatch of
    TRAIN_SEQ tokens: WKV6 B=2 (rwkv6-3b: 8 sequences in 4 microbatches),
    the scan B=4 in bf16 (hymba-1.5b: in 2); the scan's backward kernel
    against its plain version (mamba_scan_bwd, the torch-ops backward) on
    the same inputs, each gradient within REL_TOL (rel L2) and TOL of its
    largest magnitude, and timed beside it. Bounds: forward as the
    serving checks count it; backward: the inputs and dy read, their
    gradients written, the kept states read, and the flops of wkv6_flops
    or mamba_flops."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator("cuda").manual_seed(7)
    entries, bwd = [], {}
    b, s = TRAIN_BATCH // get_arch("rwkv6-3b").grad_accum, TRAIN_SEQ
    inputs = decay(wkv6_train_inputs(gen, b, s))
    dy = randn(gen, (b, s, RWKV_HEADS, RWKV_HD), torch.float32, 1.0)
    err = check_wkv6_train_forward(f"B={b} S={s}, the model's decays",
                                   inputs)
    y, final, starts = wk.wkv6_chunk_states(*inputs)
    fwd_f, bwd_f = wkv6_flops(b * s, RWKV_HEADS, RWKV_HD)
    size = inputs[0].numel() * 4
    # r, k, v, w read, y written; every chunk's start and the final state
    # written
    bound, by = bound_ms(5 * size + (starts.numel() + final.numel()) * 4,
                         {torch.float32: fwd_f})
    bbound, bby = bound_ms(9 * size + starts.numel() * 4,
                           {torch.float32: bwd_f})
    bwd_err = check_wkv6_backward(f"B={b} S={s}, the model's decays",
                                  inputs, starts, dy)
    # exact 0s (a decay that wipes the state) and 1s mixed in
    pick = torch.rand(inputs[3].shape, generator=gen, device="cuda")
    edges = [*inputs[:3], torch.where(pick < 0.05, 0.0, torch.where(
        pick > 0.9, 1.0, inputs[3])), inputs[4]]
    check_wkv6_train_forward(f"B={b} S={s}, exact 0 and 1 decays mixed in",
                             edges)
    check_wkv6_backward(f"B={b} S={s}, exact 0 and 1 decays mixed in",
                        edges, wk.wkv6_chunk_states(*edges)[2], dy)
    del edges, pick
    fwd = time_ms(lambda: wk.wkv6_chunk_states(*inputs), 10)
    plain = time_ms(lambda: wk.wkv6_plain(*inputs), 1, warmup=1)
    t_bwd = time_ms(lambda: wk.wkv6_backward(*inputs, starts, dy), 10)
    t_plain = time_ms(lambda: wk.wkv6_bwd(*inputs, starts, dy), 3, warmup=1)
    bwd["wkv6_backward", "rwkv6-3b"] = t_bwd
    log(f"  wkv6 training shape (B={b}, S={s}, H={RWKV_HEADS}, "
        f"hd={RWKV_HD}): forward {fwd:.4f} ms in 1 C call of "
        f"{starts.shape[1]} chunks (plain loop {plain:.4f} ms, bound "
        f"{bound:.4f} ms by {by}); "
        f"backward kernel {t_bwd:.4f} ms in 1 launch, its plain version "
        f"(the torch-ops wkv6_bwd) {t_plain:.4f} ms, bound {bbound:.4f} ms "
        f"({bby}), {t_bwd / bbound:.2f}x the bound")
    entries.append({"name": "wkv6_train", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/wkv6.cu",
                    "replaces": "src/repro/kernels/rwkv6.py:49",
                    "max_abs_err": err, "ms": fwd, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": None})
    entries.append({"name": "wkv6_backward", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                    "replaces": "src/repro/models/ssm.py:30",
                    "max_abs_err": bwd_err, "ms": t_bwd, "plain_ms": t_plain,
                    "bound_ms": bbound, "bound_by": bby, "library_ms": None,
                    "torch_ops_ms": t_plain})
    del inputs, dy, y, final, starts
    b = TRAIN_BATCH // get_arch("hymba-1.5b").grad_accum
    inputs = mamba_train_inputs(gen, b, s, torch.bfloat16)
    dout = randn(gen, (b, s, MAMBA_DI), torch.bfloat16, 1.0)
    err = check_mamba_train_forward(f"B={b} S={s} bf16", inputs)
    out, _, starts = ms.mamba_chunk_states(*inputs)
    n_bytes, flops = mamba_fused_cost(b, s, torch.bfloat16)
    # and every chunk's start written
    bound, by = bound_ms(n_bytes + starts.numel() * 4, flops)
    fwd_f, bwd_f = mamba_flops(b * s, MAMBA_DI, MAMBA_N)
    bbound, bby = bound_ms(2 * n_bytes + out.numel() * 2 + starts.numel() * 4,
                           {torch.float32: bwd_f})
    bwd_err = check_mamba_scan_backward(f"B={b} S={s} bf16", inputs, starts,
                                        dout)
    fwd = time_ms(lambda: ms.mamba_chunk_states(*inputs), 10)
    plain = time_ms(lambda: ms.mamba_scan_plain(*inputs), 1, warmup=1)
    t_bwd = time_ms(lambda: ms.mamba_scan_backward(*inputs, starts, dout),
                    10)
    t_plain = time_ms(lambda: ms.mamba_scan_bwd(*inputs, starts, dout), 3,
                      warmup=1)
    bwd["mamba_scan_backward", "hymba-1.5b"] = t_bwd
    log(f"  mamba_scan training shape (B={b}, S={s}, di={MAMBA_DI}, "
        f"n={MAMBA_N}, bf16): forward {fwd:.4f} ms in 1 launch of "
        f"{starts.shape[1]} chunks (plain loop {plain:.4f} ms, bound "
        f"{bound:.4f} ms by {by}); "
        f"backward kernel {t_bwd:.4f} ms in 1 launch, its plain version "
        f"(the torch-ops mamba_scan_bwd) {t_plain:.4f} ms, bound "
        f"{bbound:.4f} ms ({bby}), {t_bwd / bbound:.2f}x the bound")
    entries.append({"name": "mamba_scan_train", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
                    "replaces": "src/repro/models/ssm.py:217",
                    "max_abs_err": err, "ms": fwd, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": None})
    entries.append({"name": "mamba_scan_bwd", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "mamba_scan_bwd.cu",
                    "replaces": "src/repro/models/ssm.py:30",
                    "max_abs_err": bwd_err, "ms": t_bwd, "plain_ms": t_plain,
                    "bound_ms": bbound, "bound_by": bby, "library_ms": None,
                    "torch_ops_ms": t_plain})
    return {"entries": entries, "bwd_ms": bwd}


def check_wkv6_train_forward(what: str, inputs: list) -> float:
    """WKV6's training forward (wkv6_chunk_states: one C call, one launch
    counted) against the plain version chunk by chunk: y, the final state
    and every chunk's start within the scan's fp32 limits; the starts'
    mutants must fail. Returns y's max_abs_err."""
    from repro_torch.kernels import wkv6 as wk
    before = wk.wkv6.launches
    y, final, starts = wk.wkv6_chunk_states(*inputs)
    if wk.wkv6.launches != before + 1:
        raise AssertionError(f"wkv6 training forward: "
                             f"{wk.wkv6.launches - before} calls counted")
    want, want_final, want_starts = wkv6_plain_chain(*inputs)
    what = f"wkv6 training forward {what}"
    err = assert_close_scan(f"{what}, y", y, want)
    assert_close_scan(f"{what}, final state", final, want_final)
    check_starts(what, starts, want_starts,
                 wkv6_fades(inputs[3], wk.TIME_CHUNK))
    return err


def check_mamba_train_forward(what: str, inputs: list) -> float:
    """The scan's training forward (mamba_chunk_states: one launch that
    writes every chunk's start) bit for bit against its kernel launched
    once a chunk, and against the plain version chunk by chunk: out, the
    final state and every chunk's start within the scan's limits; the
    starts' mutants must fail. Returns out's max_abs_err."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels.wkv6 import TIME_CHUNK
    before = ms.mamba_scan.launches
    got = ms.mamba_chunk_states(*inputs)
    if ms.mamba_scan.launches != before + 1:
        raise AssertionError(f"mamba_scan training forward: "
                             f"{ms.mamba_scan.launches - before} launches")
    what = f"mamba_scan training forward {what}"
    same = [torch.equal(g, c) for g, c in zip(got, mamba_chain(False,
                                                               *inputs))]
    log(f"  {what}: out, final state, starts bit-equal to one launch a "
        f"chunk: {same}")
    if not all(same):
        raise AssertionError(f"{what}: differs from the chain of launches")
    out, final, starts = got
    want, want_final, want_starts = mamba_chain(True, *inputs)
    err = assert_close_scan(f"{what}, out", out, want)
    assert_close_scan(f"{what}, final state", final, want_final)
    check_starts(what, starts, want_starts,
                 mamba_fades(inputs[0], inputs[1], inputs[6], TIME_CHUNK))
    return err


def check_wkv6_backward(what: str, inputs: list, starts, dy,
                        dstate=None) -> float:
    """The WKV6 backward kernel against its plain version (``wkv6_bwd``)
    on the same inputs, kept states, dy and final-state gradient (None:
    zeros): dr, dk, dv, dw and du each within REL_TOL (rel L2) and TOL of
    its largest magnitude, finite; and a second run gives the same bits.
    Returns the largest max_abs_err."""
    from repro_torch.kernels import wkv6 as wk
    got = wk.wkv6_backward(*inputs, starts, dy, dstate)
    again = wk.wkv6_backward(*inputs, starts, dy, dstate)
    want = wk.wkv6_bwd(*inputs, starts, dy, dstate)
    worst = 0.0
    for name, g, a, w in zip(("dr", "dk", "dv", "dw", "du"), got, again,
                             want):
        e, rel = max_err(g, w), rel_err(g, w)
        scale = w.float().abs().max().item()
        same = torch.equal(g, a)
        log(f"  wkv6_backward {what} vs its plain version, {name}: "
            f"max_abs_err {e:.3e} (limit {TOL[torch.float32]} x max |plain| "
            f"{scale:.3e}), rel L2 {rel:.3e} (limit {REL_TOL[torch.float32]})"
            f", two runs bit-equal: {same}")
        if e > TOL[torch.float32] * scale or rel > REL_TOL[torch.float32] \
                or not same or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"wkv6_backward {what} {name}: kernel "
                                 f"disagrees with its plain version ({e}, "
                                 f"{rel}) or with itself ({same})")
        worst = max(worst, e)
    return worst


def check_mamba_scan_backward(what: str, inputs: list, starts, dout,
                              dh=None) -> float:
    """The scan's backward kernel against its plain version
    (``mamba_scan_bwd``) on the same inputs, kept states, dout and
    final-state gradient (None: zeros): each gradient in the plain
    version's dtype, within REL_TOL (rel L2) and TOL of its largest
    magnitude for the inputs' dtype, finite; and a second run gives the
    same bits. Returns the largest max_abs_err."""
    from repro_torch.kernels import mamba_scan as ms
    got = ms.mamba_scan_backward(*inputs, starts, dout, dh)
    again = ms.mamba_scan_backward(*inputs, starts, dout, dh)
    want = ms.mamba_scan_bwd(*inputs, starts, dout, dh)
    dtype, worst = inputs[0].dtype, 0.0
    names = ("dt_raw", "dt_bias", "b", "c", "x", "z", "a_log", "d_skip")
    for name, g, a, w in zip(names, got, again, want):
        e, rel = max_err(g, w), rel_err(g, w)
        scale = w.float().abs().max().item()
        same = torch.equal(g, a)
        log(f"  mamba_scan_backward {what} vs its plain version, d {name}: "
            f"max_abs_err {e:.3e} (limit {TOL[dtype]} x max |plain| "
            f"{scale:.3e}), rel L2 {rel:.3e} (limit {REL_TOL[dtype]}), two "
            f"runs bit-equal: {same}")
        if e > TOL[dtype] * scale or rel > REL_TOL[dtype] \
                or g.dtype != w.dtype or not same \
                or not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"mamba_scan_backward {what} d {name}: "
                                 f"kernel disagrees with its plain version "
                                 f"({e}, {rel}) or with itself ({same})")
        worst = max(worst, e)
    return worst


def check_backward_edges() -> None:
    """Both backward kernels at B=1 over a ragged 1068 steps (four chunks
    and 44 steps: a ragged last chunk, sub-chunk and time tile) from a
    given final-state gradient, WKV6 in fp32 with the model's decays and
    the scan in bf16 at full width; the scan also at n=8 in fp32 (B=2,
    S=300), each against its plain version, two runs bit-equal."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator("cuda").manual_seed(8)
    s = 4 * wk.TIME_CHUNK + 44
    inputs = decay(wkv6_train_inputs(gen, 1, s))
    dy = randn(gen, (1, s, RWKV_HEADS, RWKV_HD), torch.float32, 1.0)
    dstate = randn(gen, (1, RWKV_HEADS, RWKV_HD, RWKV_HD), torch.float32,
                   1.0)
    check_wkv6_backward(f"B=1 S={s}, dstate given", inputs,
                        wk.wkv6_chunk_states(*inputs)[2], dy, dstate)
    del inputs, dy, dstate
    for b, s, dtype, n in ((1, s, torch.bfloat16, MAMBA_N),
                           (2, 300, torch.float32, 8)):
        inputs = mamba_train_inputs(gen, b, s, dtype, n)
        dout = randn(gen, (b, s, MAMBA_DI), dtype, 1.0)
        dh = randn(gen, (b, MAMBA_DI, n), torch.float32, 1.0)
        check_mamba_scan_backward(f"B={b} S={s} n={n} {str(dtype)[6:]}, dh "
                                  f"given", inputs,
                                  ms.mamba_chunk_states(*inputs)[2], dout, dh)


def train_counts(cfg) -> dict:
    """Launches of one train step: remat runs
    each layer's forward twice, so 2 per layer and microbatch of flash
    attention, and of WKV6's and the Mamba scan's training forward (one
    call a forward, however many TIME_CHUNK chunks); 1 per layer and
    microbatch of each backward kernel (one per Function backward); none
    of the other kernels."""
    from repro_torch.kernels.ops import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    per = cfg.n_layers * cfg.grad_accum
    if cfg.attn_free:
        want["wkv6"] = 2 * per
        want["wkv6_backward"] = per
    else:
        want["flash_attention"] = 2 * per
        want["flash_attention_backward"] = per
    if cfg.hybrid_ssm:
        want["mamba_scan"] = 2 * per
        want["mamba_scan_backward"] = per
    return want


def check_recurrent_leaves(cfg, grads: dict) -> None:
    """Every leaf that feeds the recurrence got a nonzero gradient in every
    layer: the assertion that catches a gradient cut at a kernel."""
    mixer = "tmix" if cfg.attn_free else "mamba" if cfg.hybrid_ssm else None
    if mixer is None:
        return
    dead = {}
    for name in RECURRENT_LEAVES[mixer]:
        g = grads["layers"][mixer][name]
        per_layer = g.float().flatten(1).abs().amax(1)
        if not bool((per_layer > 0).all() & torch.isfinite(per_layer).all()):
            dead[name] = per_layer.tolist()
    log(f"  nonzero finite gradient in all {cfg.n_layers} layers of "
        f"{', '.join(RECURRENT_LEAVES[mixer])}: {not dead}")
    if dead:
        raise AssertionError(f"{cfg.name}: zero or non-finite recurrence "
                             f"gradients {dead}")


def check_stub_leaves(cfg, grads: dict) -> None:
    """A stub-frontend model reads embeddings in place of ids: every leaf
    but its unread token table got a nonzero finite gradient (a stacked
    layer leaf in every layer), and the table's gradient is 0 (as JAX's
    is)."""
    if not cfg.embedding_stub:
        return
    dead = []
    for path, g in _named_leaves(grads):
        if path == "embed":
            if bool(g.any()):
                raise AssertionError(f"{cfg.name}: the unread token table "
                                     f"has a nonzero gradient")
            continue
        g = g.float().flatten(1) if path.startswith("layers/") \
            else g.float().reshape(1, -1)
        per = g.abs().amax(1)
        if not bool((per > 0).all() & torch.isfinite(per).all()):
            dead.append(path)
    log(f"  nonzero finite gradient on every leaf but the unread token "
        f"table (whose gradient is 0), in all {cfg.n_layers} layers: "
        f"{not dead}")
    if dead:
        raise AssertionError(f"{cfg.name}: zero or non-finite gradients "
                             f"{dead}")


def _named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict, paths joined by '/'."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def train_full_width(arch: str, bwd_ms: dict) -> dict:
    """``arch`` at full width and depth TRAINED[arch]: a warm-up step, then
    TIMED_STEPS steps through train_step, each of TRAIN_BATCH sequences of
    TRAIN_SEQ tokens in grad_accum microbatches. Asserts finite losses and
    grad norms, a first loss near ln(vocab), the launches of train_counts
    (and the Mamba scan's all in its chunked body), and in the warm-up
    step a nonzero gradient on every leaf that feeds the recurrence (of a
    stub-frontend model, on every leaf but its unread token table).
    Spies on the torch-ops backwards that the kernels replaced
    (flash_attention_bwd, wkv6_bwd, mamba_scan_bwd): the timed steps must
    call them 0 times. Prints a profile (of a step, or for the recurrent
    families of one microbatch) and CUDA-event spans of the step's parts, each
    backward among them. ``bwd_ms``: {(backward, model): ms alone at the
    model's shape}."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import synth_batch
    from repro_torch.train.optimizer import OptConfig
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=TRAINED[arch])
    accum = cfg.grad_accum
    shape = ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    opt_cfg = OptConfig(name=cfg.optimizer, warmup_steps=2, total_steps=100)
    t0 = time.perf_counter()
    state = ts.init_train_state(torch.Generator("cuda").manual_seed(0), cfg,
                                opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    heads = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}" \
        if not cfg.attn_free else \
        f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of {cfg.rwkv_head_dim}"
    log(f"train {arch} at depth {cfg.n_layers} of {full.n_layers}: d_model "
        f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}, {cfg.optimizer}; {n_params / 1e9:.3f} B params;"
        f" params and optimizer state "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, initialised in "
        f"{time.perf_counter() - t0:.1f} s; {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens a step in {accum} microbatches")
    bound, by, flops = train_bound(cfg, TRAIN_BATCH)
    log(f"  step bound {bound:.1f} ms ({by}; {flops:.4g} model flops)")
    want = train_counts(cfg)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    launches, steps, seen, peaks = dict.fromkeys(want, 0), [], [], []
    real_updates = ts.apply_updates

    def first_grads(grads, *args, **kwargs):
        if not seen:
            seen.append(1)
            check_recurrent_leaves(cfg, grads)
            check_stub_leaves(cfg, grads)
        return real_updates(grads, *args, **kwargs)

    # the torch-ops backwards the kernels replaced: never called on the card
    torch_ops = {"flash_attention_bwd": 0, "wkv6_bwd": 0,
                 "mamba_scan_bwd": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def counted(*args, **kwargs):
            torch_ops[name] += 1
            return real(*args, **kwargs)
        return mock.patch.object(mod, name, counted)

    for step in range(1 + TIMED_STEPS):
        batch = ts.to_device(synth_batch(cfg, shape, step), "cuda")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with mock.patch.object(ts, "apply_updates", first_grads), \
                spy(fa, "flash_attention_bwd"), spy(wk, "wkv6_bwd"), \
                spy(ms_mod, "mamba_scan_bwd"):
            start.record()
            state, m = ts.train_step(state, batch, cfg, opt_cfg)
            end.record()
            end.synchronize()
        counts = ops.launch_counts()
        ms = start.elapsed_time(end)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        what = "warm-up step" if step == 0 else "step"
        log(f"  {what} {step}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
            f"{ms:.1f} ms, {tokens * 1e3 / ms:.0f} tokens/s, train_mfu "
            f"{bound / ms:.4f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check_counts(f"train step {step}", counts, want)
        log(f"  torch-ops backwards called in step {step}: {torch_ops}")
        if any(torch_ops.values()):
            raise AssertionError(f"step {step} called the torch-ops "
                                 f"backwards {torch_ops}")
        if mamba_scan.token_launches or wk.wkv6.token_launches:
            raise AssertionError(f"step {step}: {mamba_scan.token_launches}"
                                 f" Mamba scan and {wk.wkv6.token_launches}"
                                 f" WKV6 launches ran the token body")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss}, norm {gnorm}")
        if step == 0 and abs(loss - math.log(cfg.vocab_size)) > 1.5:
            raise AssertionError(f"first loss {loss} is not within 1.5 of "
                                 f"ln(vocab) {math.log(cfg.vocab_size)}")
        if step:
            for k in launches:
                launches[k] += counts[k]
            steps.append(ms)
            peaks.append(torch.cuda.max_memory_allocated())
    mean = sum(steps) / len(steps)
    # each backward timed alone at this model's shape, times its calls
    calls = cfg.n_layers * accum
    alone = "".join(
        f"; {name} alone at this shape {t:.3f} ms x {calls} calls = "
        f"{t * calls:.1f} ms a step ({100 * t * calls / mean:.1f} %)"
        for (name, a), t in bwd_ms.items() if a == arch)
    log(f"  {TIMED_STEPS} timed steps: mean {mean:.1f} ms "
        f"({tokens * 1e3 / mean:.0f} tokens/s, train_mfu "
        f"{bound / mean:.4f}){alone}")
    batch = ts.to_device(synth_batch(cfg, shape, 1 + TIMED_STEPS), "cuda")
    if cfg.attn_free or cfg.hybrid_ssm or cfg.is_moe:
        # a step of these runs ~10^5 kernels (MoE: the dispatch's shares
        # are read per microbatch): the profile takes one microbatch of
        # the step's grad_accum
        micro = ts._split_microbatches(batch, accum)[0]
        averages = profile(f"one microbatch of {accum} of a train step",
                           lambda: ts.loss_and_grads(state["params"], cfg,
                                                     micro),
                           mean / accum, top=12, shapes=cfg.is_moe)
        if cfg.is_moe:
            dispatch_shares(averages, cfg)
    else:
        averages = profile("train step", lambda: ts.train_step(
            state, batch, cfg, opt_cfg), mean, top=12)
    by_kind(averages)
    for fn in ("FlashAttentionFnBackward", "Wkv6FnBackward",
               "MambaScanFnBackward"):
        bwd = [e.device_time_total / 1e3 for e in averages if fn in e.key]
        if bwd:
            log(f"  profiler: {fn} {max(bwd):.1f} ms of the profiled "
                f"device time")
    time_step_parts(state, batch, cfg, opt_cfg, mean)
    del state, batch
    return {"launches": launches, "step_ms": mean, "peak_bytes": max(peaks)}


def compare_train_paths(arch: str, seq: int, micro: int) -> None:
    """The first microbatch (``micro`` x ``seq`` tokens) of ``arch``'s loss
    and gradients at depth 2, full width, through the kernels and through
    the plain versions (impl="reference"), in bf16 and with the weights
    widened to fp32; fp32 plain is the truth. fp32 kernel path: its loss
    and the rest within FP32_REL_TOL of it. bf16 kernel path: the rel L2
    of its tokens' losses (``token_losses``), its grad norm, the rel L2 of
    the embedding's gradient and that of all other leaves, each within
    BWD_BF16_RATIO x the plain path's own error; its mean loss within
    BF16_LOSS_GAP of the bf16 plain path's, relative to the fp32 loss.
    The tokens' losses are every token's of the microbatch once
    (``forward_chunks``). The embedding's bf16 scatter-add drifts far from
    fp32 on both paths (as JAX's does: tests/test_torch_bf16_grads.py), so
    the other leaves are held apart from it, to their own much smaller
    error. MoE routing is
    discontinuous (``compare_paths``): the fp32 plain path runs first and
    its expert choices pin both bf16 paths (the same experts, each path's
    own gates), and the fp32 kernel path too where its own choices are not
    all the same."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.data import synth_batch
    from repro_torch.train.train_step import loss_and_grads, to_device
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    params = init_params_cuda(cfg)
    batch = synth_batch(cfg, ShapeConfig("t", "train", seq, micro), 0)
    batch = to_device(batch, "cuda")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")

    tokens = {}

    def run(key, p, c, impl, record=None, pinned=None):
        chunks = []
        with routing(record=record, pinned=pinned), token_losses(chunks):
            loss, grads = loss_and_grads(p, c, batch, impl)
        tokens[key] = forward_chunks(chunks, seq, f"{arch} {key}")
        embed = grads.pop("embed").float()
        if cfg.embedding_stub and bool(embed.any()):
            raise AssertionError(f"{arch} {c.param_dtype} {impl}: the "
                                 f"unread token table has a gradient")
        rest = torch.cat([g.float().flatten() for g in _leaves(grads)])
        norm = torch.cat([embed.flatten(), rest]).norm().item()
        return loss.item(), norm, embed.cpu(), rest.cpu()

    runs, truth, own = {}, [], []
    p = _map(params, lambda t: t.float())
    runs["fp32", "reference"] = run(("fp32", "reference"), p, cfg32,
                                    "reference", record=truth)
    runs["fp32", "kernel"] = run(("fp32", "kernel"), p, cfg32, "kernel",
                                 record=own)
    pinned = truth if cfg.is_moe else None
    if cfg.is_moe:
        share = routing_agreement(own, truth)
        log(f"  MoE routing: fp32 kernel path's own expert choices equal "
            f"the fp32 plain path's on {share:.6f} of (token, call); bf16 "
            f"paths{' and the fp32 kernel path' if share < 1 else ''} "
            f"routed as the fp32 plain path")
        if share < 1:
            runs["fp32", "kernel"] = run(("fp32", "kernel"), p, cfg32,
                                         "kernel", pinned=truth)
    del p
    if arch in FP64_COMPARED:
        p = _map(params, lambda t: t.double())
        with mock.patch.object(torch.Tensor, "float", _kept_fp64):
            fp64 = run("fp64", p,
                       dataclasses.replace(cfg, param_dtype="float64"),
                       "reference")
        del p
    for impl in ("kernel", "reference"):
        runs["bf16", impl] = run(("bf16", impl), params, cfg, impl,
                                 pinned=pinned)
    del params
    t_loss, t_norm, t_embed, t_rest = runs["fp32", "reference"]
    for key, (loss, norm, _, _) in runs.items():
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"{key}: loss {loss}, grad norm {norm}")
    what = ("tokens' losses", "grad norm", "embedding grad", "other grads")
    # a stub-frontend model's token table is unread: its gradient is 0 on
    # every path (asserted in run), so no relative error is taken of it
    err = {key: (rel_err(tokens[key], tokens["fp32", "reference"]),
                 abs(norm - t_norm) / t_norm,
                 0.0 if cfg.embedding_stub else rel_err(embed, t_embed),
                 rel_err(rest, t_rest))
           for key, (loss, norm, embed, rest) in runs.items()}
    loss_err = {key: abs(r[0] - t_loss) / t_loss for key, r in runs.items()}
    for key, e in err.items():
        log(f"  {arch} depth 2, {micro} x {seq}, {key[0]} {key[1]}: loss "
            f"{runs[key][0]:.6f}, grad norm {runs[key][1]:.6f}, embedding "
            f"grad norm {runs[key][2].norm().item():.4f} (fp32 plain "
            f"{t_embed.norm().item():.4f}); vs fp32 plain (relative): loss "
            f"{loss_err[key]:.3e}, "
            + ", ".join(f"{w} {x:.3e}" for w, x in zip(what, e)))
    if max(loss_err["fp32", "kernel"], *err["fp32", "kernel"]) \
            > FP32_REL_TOL:
        raise AssertionError(f"{arch}: fp32 training paths disagree: loss "
                             f"{loss_err['fp32', 'kernel']}, "
                             f"{err['fp32', 'kernel']}")
    if arch in FP64_COMPARED:
        log_fp64_distances(arch, runs, fp64)
    kern, plain = err["bf16", "kernel"], err["bf16", "reference"]
    log(f"  bf16 kernel path within {BWD_BF16_RATIO} x the plain path's "
        f"error: " + ", ".join(f"{w} {k / p:.3f} x" if p else f"{w} {k} vs 0"
                               for w, k, p in zip(what, kern, plain)))
    gap = abs(runs["bf16", "kernel"][0] - runs["bf16", "reference"][0]) \
        / t_loss
    log(f"  bf16 mean loss: kernel path from plain path {gap:.3e} of the "
        f"fp32 loss (limit {BF16_LOSS_GAP})")
    for w, k, p in zip(what, kern, plain):
        if k > BWD_BF16_RATIO * p:
            raise AssertionError(f"{arch} bf16 {w}: kernel path {k} vs "
                                 f"plain {p}")
    if gap > BF16_LOSS_GAP:
        raise AssertionError(f"{arch} bf16 mean loss: kernel path "
                             f"{runs['bf16', 'kernel'][0]}, plain "
                             f"{runs['bf16', 'reference'][0]}")


def forward_chunks(chunks: list, seq: int, what: str) -> torch.Tensor:
    """The tokens' losses (B, seq) of one ``loss_and_grads`` call, from
    what ``token_losses`` recorded: ``forward_train``'s chunks, then the
    backward's recompute of each, which must give the same bits (in any
    order), so the result holds every token of the microbatch once."""
    from repro_torch.models.transformer import LOSS_CHUNK
    n = max(1, seq // min(LOSS_CHUNK, seq))
    if len(chunks) != 2 * n:
        raise AssertionError(f"{what}: {len(chunks)} loss chunks recorded, "
                             f"not {n} and their {n} recomputes")
    forward, left = chunks[:n], chunks[n:]
    for i, c in enumerate(forward):
        same = [j for j, r in enumerate(left) if torch.equal(r, c)]
        if not same:
            raise AssertionError(f"{what}: loss chunk {i}'s recompute is "
                                 f"not its bits")
        left.pop(same[0])
    out = torch.cat(forward, dim=1)
    if out.shape[1] != seq:
        raise AssertionError(f"{what}: loss chunks hold {out.shape[1]} of "
                             f"{seq} tokens")
    return out.cpu()


@contextlib.contextmanager
def token_losses(out: list):
    """Within the block, each chunk of the training loss appends its
    tokens' cross-entropies (B, chunk) to ``out``, detached, as
    ``_chunk_ce`` computes their sum: the forward's chunks, then the
    backward's recompute of each (the chunks are checkpointed)."""
    from repro_torch.models import transformer as tf
    real = tf._chunk_ce

    def chunk_ce(h, w, labels):
        with torch.no_grad():
            logits = (h @ w).float()
            gold = logits.gather(-1, labels[..., None])[..., 0]
            out.append(torch.logsumexp(logits, dim=-1) - gold)
        return real(h, w, labels)
    with mock.patch.object(tf, "_chunk_ce", chunk_ce):
        yield


def _kept_fp64(t: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Tensor.float for the fp64 run: the model's casts to fp32 (norms, the
    recurrence's inputs, the logits) keep an fp64 tensor as it is."""
    if t.dtype == torch.float64:
        return t
    return torch._C.TensorBase.float(t, *args, **kwargs)


def log_fp64_distances(arch: str, runs: dict, fp64: tuple) -> None:
    """Each fp32 path's loss and gradients against the plain path run in
    fp64 (every fp32 cast of the model kept in fp64; the chunked loss's
    accumulator stays fp32, which rounds the loss's value, not its
    gradients): the side nearer the fp64 run is the more exact one."""
    loss64, norm64, embed64, rest64 = fp64

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()
    for impl in ("reference", "kernel"):
        loss, norm, embed, rest = runs["fp32", impl]
        log(f"  {arch} fp32 {impl} path vs the fp64 plain path (relative): "
            f"loss {abs(loss - loss64) / abs(loss64):.3e}, grad norm "
            f"{abs(norm - norm64) / norm64:.3e}, embedding grad "
            f"{rel(embed, embed64):.3e}, other grads {rel(rest, rest64):.3e}")
    _, _, e_p, r_p = runs["fp32", "reference"]
    _, _, e_k, r_k = runs["fp32", "kernel"]
    log(f"  {arch} fp32 kernel vs fp32 plain (relative): embedding grad "
        f"{rel(e_k, e_p):.3e}, other grads {rel(r_k, r_p):.3e}")


def time_step_parts(state, batch, cfg, opt_cfg, step_ms: float) -> None:
    """One more step, with CUDA events around the optimizer update
    (``apply_updates``: clip and AdamW), around the gradient-tree
    operations of ``train_step`` (zeroed buffers, the fp32 accumulation of
    each microbatch) and around each backward kernel that the step runs
    (flash_attention_backward, wkv6_backward, mamba_scan_backward): the
    device time
    between each pair, summed, and its share of the timed steps' mean. The
    stream is busy, so a span holds its own kernels, and the host time a
    span's launches take when the device waits on them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.train import train_step as ts
    spans = []

    def spanned(name, fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((name, start, end))
            return out
        return run
    parts = ((ts, "apply_updates", "optimizer (clip, AdamW)"),
             (ts, "tree_map", "gradient buffers and fp32 accumulation"),
             (fa, "flash_attention_backward", "flash_attention_backward"),
             (wk, "wkv6_backward", "wkv6_backward"),
             (ms, "mamba_scan_backward", "mamba_scan_backward"))
    with contextlib.ExitStack() as stack:
        for mod, attr, name in parts:
            stack.enter_context(mock.patch.object(
                mod, attr, spanned(name, getattr(mod, attr))))
        ts.train_step(state, batch, cfg, opt_cfg)
    torch.cuda.synchronize()
    sums: dict = {}
    for name, start, end in spans:
        ms_, n = sums.get(name, (0.0, 0))
        sums[name] = (ms_ + start.elapsed_time(end), n + 1)
    for name, (ms_, n) in sums.items():
        log(f"  CUDA events: {name} {ms_:.1f} ms of a step in {n} calls "
            f"({100 * ms_ / step_ms:.1f} % of the timed steps' mean)")


KINDS = (("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("flash attention kernel", ("fa_hopper", "fa_f32")),
         ("flash attention backward kernels", ("fa_bwd",)),
         ("flash decode kernel", ("fd_split", "fd_merge")),
         ("Mamba scan kernel", ("mamba_scan",)),
         ("WKV6 kernel", ("wkv6_",)),
         ("softmax", ("softmax",)),
         ("reductions", ("reduce",)),
         ("elementwise and copies", ("elementwise", "copy", "fill",
                                     "index", "scatter", "gather")))


def by_kind(averages) -> None:
    """The profile's device time summed by kind of kernel."""
    from torch.autograd import DeviceType
    sums: dict = {}
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, keys in KINDS
                     if any(x in e.key for x in keys)), "other")
        ms, n = sums.get(kind, (0.0, 0))
        sums[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log("  by kind: " + "; ".join(
        f"{k} {ms:.1f} ms ({n}x)" for k, (ms, n) in
        sorted(sums.items(), key=lambda kv: -kv[1][0])))


def init_params_cuda(cfg):
    from repro_torch.models import init_params
    return init_params(torch.Generator("cuda").manual_seed(0), cfg)


def run_training_resumes() -> None:
    """run_training on the card at the tiny preset, with its registry,
    checkpoint commit and resume: 6 straight steps against 3 steps, a
    commit, a restore from the committed manifest and 3 more steps."""
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.coord.registry import ClusterRegistry
    from repro_torch.launch.train import PRESETS, run_training
    cfg, shape = PRESETS["tiny"], ShapeConfig("s", "train", 128, 8)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        full = run_training(cfg, shape, 6, d + "/a", ckpt_every=100,
                            registry=ClusterRegistry(), log_every=100,
                            device="cuda")["losses"]
        reg = ClusterRegistry()
        first = run_training(cfg, shape, 3, d + "/b", ckpt_every=3,
                             registry=reg, log_every=100,
                             device="cuda")["losses"]
        resumed = run_training(cfg, shape, 6, d + "/b", ckpt_every=100,
                               registry=reg, log_every=100,
                               device="cuda")["losses"]
    log(f"run_training tiny on the card: 6 straight {full}; 3 + resume + 3 "
        f"{first + resumed}; latest committed step "
        f"{reg.latest_checkpoint()['step']}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(first + resumed, full))
    if len(resumed) != 3 or worst > 1e-4:
        raise AssertionError(f"resume diverged: rel {worst}")


def check_grouped_dispatch() -> None:
    """Phase 5f: moonshot's group-local MoE dispatch (``set_moe_groups``)
    against the flat one, at full width, depth 1, fp32 (routing is then
    computed once, on equal inputs), one microbatch of GROUPED_SHAPE
    through ``loss_and_grads``. Drop-free (cf = E) both compute one
    function: loss and gradients within FP32_REL_TOL. At the config's cf
    1.25 the group-local capacity drops other rows: the gradients must
    differ by more than 10 x FP32_REL_TOL. The dispatch's calls with more
    than one group are counted (2 a layer with remat)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import moe
    from repro_torch.sharding import ctx
    from repro_torch.train.data import synth_batch
    from repro_torch.train.train_step import loss_and_grads, to_device
    full = get_arch("moonshot-v1-16b-a3b")
    b, s = GROUPED_SHAPE
    for cf in (float(full.n_experts), full.capacity_factor):
        cfg = dataclasses.replace(full, n_layers=1, param_dtype="float32",
                                  capacity_factor=cf)
        params = init_params_cuda(cfg)
        batch = to_device(synth_batch(cfg, ShapeConfig("t", "train", s, b),
                                      0), "cuda")
        runs = {}
        for groups in (1, MOE_GROUPS):
            ctx.set_moe_groups(groups)
            try:
                with mock.patch.object(moe, "_dispatch",
                                       wraps=moe._dispatch) as spy:
                    loss, grads = loss_and_grads(params, cfg, batch)
            finally:
                ctx.set_moe_groups(1)
            torch.cuda.synchronize()
            # _dispatch(x, router, cfg, groups, capacity)
            runs[groups] = (loss.item(), torch.cat(
                [g.flatten() for g in _leaves(grads)]),
                sum(c.args[3] > 1 for c in spy.call_args_list))
            del grads
        (lf, gf, nf), (lg, gg, ng) = runs[1], runs[MOE_GROUPS]
        dl, dg = abs(lg - lf) / abs(lf), rel_err(gg, gf)
        log(f"  moonshot depth 1 fp32, {b} x {s} tokens, cf {cf}: flat loss "
            f"{lf:.6f}, {MOE_GROUPS} groups {lg:.6f} (grouped calls {ng}, "
            f"flat run {nf}); relative differences: loss {dl:.3e}, "
            f"gradients (rel L2) {dg:.3e}")
        if nf != 0 or ng != 2 * cfg.n_layers:
            raise AssertionError(f"grouped dispatch calls: flat {nf}, "
                                 f"grouped {ng}")
        if not all(map(math.isfinite, (lf, lg))):
            raise AssertionError(f"losses {lf}, {lg}")
        if cf == full.n_experts and max(dl, dg) > FP32_REL_TOL:
            raise AssertionError("drop-free grouped dispatch disagrees with "
                                 "the flat one")
        if cf != full.n_experts and dg <= 10 * FP32_REL_TOL:
            raise AssertionError("at cf 1.25 the grouped dispatch gives the "
                                 "flat one's gradients: no group-local "
                                 "capacity ran")
        del params, batch, runs, gf, gg
        free()


def launch_counts() -> dict:
    """Every kernel's launches since the last reset, and of WKV6's and the
    Mamba scan's those that ran their token body."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.wkv6 import wkv6
    return {**ops.launch_counts(), "wkv6_token": wkv6.token_launches,
            "mamba_scan_token": mamba_scan.token_launches}


def rel_l2(got: list, want: list) -> float:
    """Relative L2 error of a list of tensors taken as one vector."""
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(got, want))
    return (num / max(sum(float(b.float().square().sum()) for b in want),
                      1e-30)) ** 0.5


def sharded_train(mesh, arch: str) -> None:
    """Phase 6a and the train phases after it: ``arch`` at full width and
    depth SHARDED_TRAIN_DEPTH, SHARDED_STEPS train steps (grad_accum
    microbatches of SHARDED_TRAIN_SHAPE; a stub frontend's seeded
    embeddings in place of tokens) from the same seed twice: unsharded,
    then on ``shard_tree(state, state_specs)`` with the batch by
    ``batch_specs``. Each step's loss and grad norm, and the updated
    parameters, must agree (relative L2 within FP32_REL_TOL), with the
    same launch counts of every kernel in a step (WKV6 and the Mamba scan
    under their Functions), as many as ``train_counts`` expects. Each
    step's host-clock time is printed: the difference is DTensor's host
    cost."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.sharding import rules
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import synth_batch
    from repro_torch.train.optimizer import OptConfig
    cfg = dataclasses.replace(get_arch(arch), n_layers=SHARDED_TRAIN_DEPTH)
    opt_cfg = OptConfig(name=cfg.optimizer, warmup_steps=2, total_steps=100)
    b, s = SHARDED_TRAIN_SHAPE
    shape = ShapeConfig("t", "train", s, b * cfg.grad_accum)
    batch = ts.to_device(synth_batch(cfg, shape, 0), "cuda")
    runs = {}
    for sharded in (False, True):
        state = ts.init_train_state(torch.Generator("cuda").manual_seed(0),
                                    cfg, opt_cfg)
        feed = batch
        if sharded:
            state = rules.shard_tree(state, rules.state_specs(state, mesh),
                                     mesh)
            feed = rules.shard_tree(batch, rules.batch_specs(batch, mesh),
                                    mesh)
        metrics, times = [], []
        for _ in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            state, m = ts.train_step(state, feed, cfg, opt_cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics += [float(m["loss"]), float(m["grad_norm"])]
        embed = state["params"]["embed"]
        runs[sharded] = (metrics, [ts.whole(t).clone() for t in
                                   _leaves(state["params"])],
                         launch_counts(), times,
                         getattr(embed, "placements", None))
        del state, m, embed
        free()
    (m0, p0, c0, ms0, _), (m1, p1, c1, ms1, pl) = runs[False], runs[True]
    err = rel_l2(p1, p0)
    worst = max(max_err(a, b) for a, b in zip(p1, p0))
    log(f"  {arch} depth {cfg.n_layers}, {cfg.grad_accum} x {b} x {s} "
        f"tokens a step, {SHARDED_STEPS} steps: unsharded loss, grad norm "
        f"{', '.join(f'{v:.6f}' for v in m0)}; on the (1, 1) mesh "
        f"{', '.join(f'{v:.6f}' for v in m1)}; host clock a step "
        f"unsharded {', '.join(f'{t:.1f}' for t in ms0)} ms, sharded "
        f"{', '.join(f'{t:.1f}' for t in ms1)} ms (DTensor's host cost "
        f"{', '.join(f'{t1 - t0:.1f}' for t0, t1 in zip(ms0, ms1))} ms); "
        f"updated parameters rel L2 {err:.3e}, max abs {worst:.3e}; embed "
        f"placed {pl}; launches of a step {c0} and {c1}")
    want = {**train_counts(cfg), "wkv6_token": 0, "mamba_scan_token": 0}
    if c0 != c1 or c0 != want:
        raise AssertionError(f"launch counts: unsharded {c0}, sharded {c1}, "
                             f"expected {want}")
    if max(abs(a - b) / abs(b) for a, b in zip(m1, m0)) > FP32_REL_TOL \
            or err > FP32_REL_TOL:
        raise AssertionError(f"{arch}: the sharded train steps disagree "
                             f"with the unsharded ones")


def sharded_serve(mesh, arch: str, depth=None, prompt_len: int = 0) -> None:
    """Phase 6b and the serve phases after it: ``arch`` at full width, at
    ``depth`` layers (None: all), served from seeded prompts (REQUESTS x
    ``prompt_len`` tokens, or a stub frontend's embeddings made as
    train/data.py makes them) through prefill and 3 greedy decode_steps
    (a stub's fed the next positions' embeddings) twice: unsharded, then
    on ``param_specs(mode="serve")`` with the prompts, inputs and
    positions by ``batch_specs`` and the caches by ``cache_specs``
    (prefill builds RWKV's and Mamba's states so; ``preallocate_cache``
    lays out the K/V). The greedy ids must be equal, the logits within
    FP32_REL_TOL (relative L2), every cache and recurrent state after the
    last step equal to the unsharded one (relative L2 within
    FP32_REL_TOL), and every kernel's launches equal, the Mamba scan's
    token-body ones too: the kernels ran on the local shards. Each side
    runs twice, and both runs' host-clock times are printed."""
    from repro_torch.bridge import flatten_tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    from repro_torch.sharding import rules
    from repro_torch.train.data import synth_batch
    from repro_torch.train.train_step import whole
    cfg = get_arch(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params = init_params_cuda(cfg)
    steps = 3
    if cfg.embedding_stub:
        shape = ShapeConfig("p", "prefill", prompt_len + steps, REQUESTS)
        embeds = torch.from_numpy(synth_batch(cfg, shape, 0)["embeds"]).to(
            "cuda")
        prompt = {"embeds": embeds[:, :prompt_len]}
    else:
        gen = torch.Generator("cuda").manual_seed(1)
        prompt = {"tokens": torch.randint(0, cfg.vocab_size,
                                          (REQUESTS, prompt_len),
                                          generator=gen, device="cuda")}

    def batch(tree, sharded):
        return rules.shard_tree(tree, rules.batch_specs(tree, mesh), mesh) \
            if sharded else tree

    def serve(p, sharded):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, caches, pos = prefill(p, cfg, batch(prompt, sharded))
        caches = preallocate_cache(cfg, caches, prompt_len + steps)
        outs, ids = [whole(logits)], []
        for i in range(steps):
            ids.append(outs[-1].argmax(-1))
            x = embeds[:, prompt_len + i] if cfg.embedding_stub else ids[-1]
            fed = batch({"x": x, "p": pos + i}, sharded)
            logits, caches = decode_step(p, cfg, fed["x"], caches, fed["p"])
            outs.append(whole(logits))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        states = {k: whole(v) for k, v in flatten_tree(caches).items()}
        placed = {k: getattr(v, "placements", None)
                  for k, v in flatten_tree(caches).items()}
        return outs, torch.stack(ids), launch_counts(), states, placed, ms

    with torch.no_grad():
        # twice each: the second run's host time is the steady one
        ms0 = [serve(params, False)[-1]]
        o0, i0, c0, s0, _, ms = serve(params, False)
        ms0.append(ms)
        sparams = rules.shard_tree(params, rules.param_specs(
            params, mesh, mode="serve"), mesh)
        ms1 = [serve(sparams, True)[-1]]
        o1, i1, c1, s1, placed, ms = serve(sparams, True)
        ms1.append(ms)
    errs = [rel_err(a, b) for a, b in zip(o1, o0)]
    state_errs = {k: rel_err(s1[k], s0[k]) for k in s0}
    log(f"  {arch} served at depth {cfg.n_layers}, {REQUESTS} x "
        f"{prompt_len} prompt positions + {steps} decode steps: greedy ids "
        f"equal {bool((i0 == i1).all())}; logits rel L2 (prefill, decode "
        f"1-{steps}) {', '.join(f'{e:.3e}' for e in errs)}; caches and "
        f"states after the last step, rel L2 "
        f"{', '.join(f'{k} {e:.3e}' for k, e in state_errs.items())}; "
        f"placed {placed}; host clock of a first and a second run "
        f"unsharded {ms0[0]:.1f}, {ms0[1]:.1f} ms, sharded {ms1[0]:.1f}, "
        f"{ms1[1]:.1f} ms ({ms1[1] / ms0[1]:.2f}x); launches unsharded "
        f"{c0}, sharded {c1}")
    want = {**expected_counts(cfg, steps),
            "wkv6_token": cfg.n_layers * steps if cfg.attn_free else 0,
            "mamba_scan_token": cfg.n_layers * steps if cfg.hybrid_ssm
            else 0}
    if c0 != c1 or c0 != want:
        raise AssertionError(f"launch counts: unsharded {c0}, sharded {c1}, "
                             f"expected {want}")
    if not (i0 == i1).all() or max(errs) > FP32_REL_TOL or \
            max(state_errs.values()) > FP32_REL_TOL:
        raise AssertionError(f"{arch}: sharded serving disagrees with "
                             f"unsharded")


def sharded_phase() -> None:
    """Phase 6: the sharded path on a one-card (1, 1) mesh: an NCCL process
    group of one rank on a local store, ``make_local_mesh(1, 1)``, the
    sharding context set from it; qwen3-8b (6a, 6b), then each family of
    SHARDED_FAMILIES trained and served. It proves NCCL, DTensor dispatch
    and the kernels on local shards; with one card it moves no data
    between cards, so it does not measure communication."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import ctx
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device="cuda")
        ctx.set_axes(*ctx.axes_from_mesh(mesh))
        with phase("6a, qwen3-8b train step on the (1, 1) mesh"):
            sharded_train(mesh, "qwen3-8b")
            free()
        with phase("6b, qwen3-8b served on the (1, 1) mesh"):
            sharded_serve(mesh, "qwen3-8b", None, PROMPT_LEN)
            free()
        for i, (arch, depth) in enumerate(SHARDED_FAMILIES.items()):
            with phase(f"6{'cdefghij'[2 * i]}, {arch} train step on the "
                       f"(1, 1) mesh"):
                sharded_train(mesh, arch)
                free()
                if get_arch(arch).family == "moe":
                    log_flat_dispatch_bytes(arch)
            with phase(f"6{'cdefghij'[2 * i + 1]}, {arch} served on the "
                       f"(1, 1) mesh"):
                sharded_serve(mesh, arch, depth, prompt_len_of(arch))
                free()
    finally:
        ctx.clear()
        dist.destroy_process_group()


def log_flat_dispatch_bytes(arch: str = "moonshot-v1-16b-a3b") -> None:
    """The data-sharded flat MoE dispatch's collectives on the production
    (16, 16) mesh, counted from ``arch``'s shapes (one card has no peer to
    measure them), a layer's forward at TRAIN_MICRO and at TRAIN_4K's
    microbatch (its batch over grad_accum) of sequences a dp rank: the
    counts' all-gather over dp; the (E, C, d) buffer that every rank
    holds whole, capacity from the global T, summed over dp (a ring
    all-reduce moves 2 (n-1)/n of it a rank); the combine's (T/dp, d)
    rows summed over model."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.models.moe import _capacity
    cfg = get_arch(arch)
    dp = mp = 16
    item = getattr(torch, cfg.param_dtype).itemsize
    for seqs in (TRAIN_MICRO, TRAIN_4K.global_batch // cfg.grad_accum // dp):
        rank_t = seqs * TRAIN_4K.seq_len
        c = _capacity(cfg, rank_t * dp, 1)
        buf = cfg.n_experts * c * cfg.d_model * item
        rows = rank_t * cfg.d_model * item
        log(f"  {arch} flat dispatch on (16, 16), {seqs} x "
            f"{TRAIN_4K.seq_len} tokens a dp rank (T {rank_t * dp}, C {c}), "
            f"counted: counts all-gather {dp * cfg.n_experts * 8} B; buffer "
            f"{buf} B a rank, its all-reduce over dp moves "
            f"{2 * (dp - 1) * buf // dp} B a rank (its model shard "
            f"{buf // mp} B); the combine's rows {rows} B, their "
            f"all-reduce over model moves {2 * (mp - 1) * rows // mp} B a "
            f"rank")


# ------------------------------------------------------------ phase 7
# the roofline's flops against the bounds' parts, and its peak against the
# allocator's: relative limits
FLOPS_TOL, PEAK_TOL = 0.05, 0.15
# training runs each layer's forward (remat) and each loss chunk's LM head
# (its checkpoint) again in the backward: 8 flops a matmul parameter and
# token where train_bound counts 6, and every kernel's forward twice
REMAT_DENSE, REMAT_KERNEL = 8 / 6, 2
# phase 7b: one cell a family on the production (16, 16) mesh, counted in
# a subprocess (the fake process group must not meet phase 6's NCCL one)
FAMILY_CELLS = ("qwen3-8b", "moonshot-v1-16b-a3b", "pixtral-12b",
                "rwkv6-3b", "hymba-1.5b", "musicgen-large")
FAMILY_SHAPE = "decode_32k"
DRYRUN_CELLS = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_dryrun_mesh
mesh = make_dryrun_mesh()
for arch in sys.argv[2:]:
    print("ROW " + json.dumps(dryrun.run_cell(arch, sys.argv[1], mesh,
                                              "16x16", verbose=False),
                              default=str), flush=True)
"""


def moe_padding(cfg, tokens: int) -> int:
    """Forward flops the flat dispatch runs beyond the routed tokens'
    products in one call over ``tokens`` tokens, all layers: each of E
    experts runs its C = max(1, int(cf t k / E)) capacity rows, where the
    bounds count the t k routed ones."""
    if not cfg.is_moe:
        return 0
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * tokens * k / e))
    return 6 * cfg.d_model * cfg.d_ff * (e * cap - tokens * k) * cfg.n_layers


def count_serving(arch: str):
    """Phase 3's served path counted on meta tensors on one device, at the
    shapes it ran: the prefill of REQUESTS x the prompt (ids, or a stub's
    embeds), its cache preallocated for MAX_NEW more positions and the
    first token sampled; then one decode step. Returns (cfg, the meta
    weights, prefill's counter, decode's, the predicted peak: the weights
    and inputs, which exist before the run, and the most the run holds at
    once)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.roofline import RooflineCounter
    from repro_torch.serve.engine import preallocate_cache
    cfg, prompt_len = get_arch(arch), prompt_len_of(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, "meta")
    if cfg.embedding_stub:
        inputs = torch.empty((REQUESTS, prompt_len + MAX_NEW, cfg.d_model),
                             device="meta")
        batch, step = {"embeds": inputs[:, :prompt_len]}, \
            inputs[:, prompt_len]
    else:
        inputs = torch.empty((REQUESTS, prompt_len), dtype=torch.long,
                             device="meta")
        batch, step = {"tokens": inputs}, None
    counter = RooflineCounter()
    resident = counter.resident((params, inputs))
    with torch.no_grad(), counter:
        logits, pre, pos = prefill(params, cfg, batch)
        caches = preallocate_cache(cfg, pre, prompt_len + MAX_NEW)
        del pre
        tok = logits.argmax(dim=-1) if step is None else step
        pre_counts = counter.take()
        decode_step(params, cfg, tok, caches, pos)
        dec_counts = counter.take()
    return cfg, params, pre_counts, dec_counts, resident + counter.peak_bytes


def count_training(arch: str):
    """Phase 5's train step counted on meta tensors on one device:
    TRAIN_BATCH x TRAIN_SEQ ids in grad_accum microbatches, the state at
    depth 1 and at depth 2, extrapolated to depth TRAINED[arch]
    (``roofline.over_depth``: the layers are identical, and a step on meta
    tensors takes ~0.2 s a layer on the host). Returns (cfg at
    TRAINED[arch], its counts, the predicted peak, extrapolated as
    well)."""
    from repro_torch.configs import get_arch
    from repro_torch.roofline import RooflineCounter, over_depth
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptConfig
    runs = []
    for depth in (1, 2):
        cfg = dataclasses.replace(get_arch(arch), n_layers=depth)
        opt_cfg = OptConfig(name=cfg.optimizer, warmup_steps=2,
                            total_steps=100)
        state = ts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    opt_cfg, device="meta")
        batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.long,
                                device="meta") for k in ("tokens", "labels")}
        if cfg.embedding_stub:
            # the frontend stub's fp32 embeddings, as train/data.py makes
            # them, in place of the ids
            batch["embeds"] = torch.empty((TRAIN_BATCH, TRAIN_SEQ,
                                           cfg.d_model), device="meta")
            del batch["tokens"]
        counter = RooflineCounter()
        resident = counter.resident((state, batch))
        with counter:
            ts.train_step(state, batch, cfg, opt_cfg)
        runs.append((counter.take(), resident + counter.peak_bytes))
    depth = TRAINED[arch]
    (one, peak1), (two, peak2) = runs
    return (dataclasses.replace(cfg, n_layers=depth),
            over_depth(one, two, depth), peak1 + (depth - 1) * (peak2 - peak1))


def roofline_terms_of(counts) -> dict:
    """The roofline's terms of ``counts`` on the H100, as the dry run's rows
    give them: ``roofline_terms`` (one bf16 peak, as JAX's) and
    ``typed_terms``' ``compute_typed_s`` (each dtype's flops at its own
    peak, as the bounds count them) and ``bound_typed_s``."""
    from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_BY_DTYPE)
    from repro_torch.roofline import roofline_terms, typed_terms
    return typed_terms(roofline_terms(counts.counts,
                                      peak_flops=PEAK_FLOPS_BF16,
                                      hbm_bw=HBM_BW, ici_bw=NVLINK_BW),
                       counts.flops_by_dtype, PEAK_FLOPS_BY_DTYPE)


def hold_parts(what: str, counted: dict, expected: dict,
               at_least: dict) -> None:
    """The counter's flops by region against the bound's parts: each part
    of ``expected`` (the bound's, with the named cases where the path does
    more added from the shapes) within FLOPS_TOL; each of ``at_least`` at
    or above it; every other region printed."""
    log(f"  {what}: flops by region {counted}; expected {expected}; at "
        f"least {at_least}")
    for part, want in expected.items():
        got = counted.get(part, 0)
        if abs(got - want) > FLOPS_TOL * want:
            raise AssertionError(f"{what}: {part} counted {got:.6g} flops, "
                                 f"the bound's part {want:.6g}")
    for part, want in at_least.items():
        if counted.get(part, 0) < want:
            raise AssertionError(f"{what}: {part} counted "
                                 f"{counted.get(part, 0):.6g} flops, below "
                                 f"the bound's {want:.6g}")


def hold_peak(what: str, predicted: int, measured: int) -> None:
    log(f"  {what}: predicted peak {predicted / 1e9:.4f} GB, "
        f"torch.cuda.max_memory_allocated {measured / 1e9:.4f} GB "
        f"({predicted / measured:.4f}x)")
    if abs(predicted - measured) > PEAK_TOL * measured:
        raise AssertionError(f"{what}: predicted peak {predicted} B, "
                             f"measured {measured} B")


def log_terms(what: str, terms: dict, measured_ms: float) -> None:
    log(f"  {what}: compute_s {terms['compute_s']:.6g} (by dtype "
        f"{terms['compute_typed_s']:.6g}), memory_s {terms['memory_s']:.6g},"
        f" memory_ref_s {terms['memory_ref_s']:.6g}, bound_s "
        f"{terms['bound_s']:.6g}, bound_typed_s {terms['bound_typed_s']:.6g}"
        f"; measured {measured_ms:.4f} ms, "
        f"{measured_ms / 1e3 / terms['bound_typed_s']:.3f}x the typed bound")


def roofline_served(arch: str, run: dict) -> None:
    """Phase 7a for one served model: its counted prefill and decode step
    against serve_bounds' parts and phase 3's times and peak."""
    cfg, params, pre, dec, peak = count_serving(arch)
    (_, _, pre_b), (_, _, dec_b) = serve_bounds(cfg, params,
                                                prompt_len_of(arch))
    log(f"{arch} served, counted on meta: prefill {pre.counts.flops:.6g} "
        f"flops, {pre.counts.hbm_bytes:.6g} B (plain bodies +"
        f"{pre.counts.kernel_region_bytes:.6g} B); decode step "
        f"{dec.counts.flops:.6g} flops, {dec.counts.hbm_bytes:.6g} B "
        f"(+{dec.counts.kernel_region_bytes:.6g} B); kernels "
        f"{ {k: v['calls'] for k, v in pre.kernels.items()} } and "
        f"{ {k: v['calls'] for k, v in dec.kernels.items()} }")
    log_terms("prefill", roofline_terms_of(pre), run["prefill_ms"])
    log_terms("decode step", roofline_terms_of(dec),
              run["decode_ms_per_token"])
    for what, counts, bound, tokens in (
            ("prefill", pre, pre_b, REQUESTS * prompt_len_of(arch)),
            ("decode step", dec, dec_b, REQUESTS)):
        want = dict(bound["flops"])
        # the flat dispatch's capacity rows: the path does more than the
        # bound counts (moonshot)
        want["dense"] += moe_padding(cfg, tokens)
        # decode's attention is not in serve_bounds (it is bound by bytes):
        # reported, not held
        hold_parts(f"{arch} {what}", counts.flops_by_region, want, {})
    log(f"  decode bytes: counted {dec.counts.hbm_bytes:.6g}, the bound's "
        f"{dec_b['bytes']:.6g}")
    if dec.counts.hbm_bytes < dec_b["bytes"]:
        raise AssertionError(f"{arch}: decode counts fewer bytes than its "
                             f"bound reads")
    hold_peak(f"{arch} served", peak, run["peak_bytes"])


def roofline_trained(arch: str, run: dict) -> None:
    """Phase 7a for one trained model: its counted step against
    train_bound's parts and phase 5's step time and peak."""
    cfg, step, peak = count_training(arch)
    parts = train_work(cfg, TRAIN_BATCH)
    micro = TRAIN_BATCH // cfg.grad_accum * TRAIN_SEQ
    log(f"{arch} trained at depth {cfg.n_layers}, counted on meta: "
        f"{step.counts.flops:.6g} flops, {step.counts.hbm_bytes:.6g} B "
        f"(plain bodies +{step.counts.kernel_region_bytes:.6g} B); kernels "
        f"{ {k: v['calls'] for k, v in step.kernels.items()} }")
    log_terms("train step", roofline_terms_of(step), run["step_ms"])
    # remat: every product's forward again in the backward, but a dense
    # layer's last (the MLP's down projection, whose output no backward
    # reads: the checkpoint stops recomputing after the last saved
    # tensor); the capacity rows' products, forward, again and backward
    # (4x their forward)
    dense = REMAT_DENSE * (parts["dense"] + parts.get("router", 0)) \
        + 4 * cfg.grad_accum * moe_padding(cfg, micro)
    if not (cfg.attn_free or cfg.is_moe):
        dense -= 2 * cfg.d_model * cfg.d_ff * TRAIN_BATCH * TRAIN_SEQ \
            * cfg.n_layers
    want = {"dense": dense}
    for kernel in ("flash_attention", "wkv6", "mamba_scan"):
        if kernel in parts:
            want[kernel] = REMAT_KERNEL * parts[kernel]
    # the backward kernels, by their flop formulas: attention's dQ kernel
    # recomputes S and dP (seven products where the bound counts four over
    # the visible pairs); WKV6's and the scan's recompute their forward
    # from the kept states
    if "FlashAttentionFnBackward" in parts:
        want["FlashAttentionFnBackward"] = \
            parts["FlashAttentionFnBackward"] * 7 // 4
    if "Wkv6FnBackward" in parts:
        want["Wkv6FnBackward"] = parts["Wkv6FnBackward"] + parts["wkv6"]
    if "MambaScanFnBackward" in parts:
        want["MambaScanFnBackward"] = \
            parts["MambaScanFnBackward"] + parts["mamba_scan"]
    hold_parts(f"{arch} train step", step.flops_by_region, want, {})
    hold_peak(f"{arch} trained", peak, run["peak_bytes"])


def roofline_family_cells() -> None:
    """Phase 7b: one cell a family, FAMILY_SHAPE on the production (16, 16)
    mesh, counted by ``launch/dryrun.py`` in a subprocess on the fake
    process group; each row written under build/dryrun_rows/."""
    out_dir = ROOT / "build" / "dryrun_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", DRYRUN_CELLS, FAMILY_SHAPE,
                           *FAMILY_CELLS], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    rows = [json.loads(line[4:]) for line in proc.stdout.splitlines()
            if line.startswith("ROW ")]
    if proc.returncode or len(rows) != len(FAMILY_CELLS):
        raise AssertionError(f"dry-run cells failed:\n{proc.stderr[-3000:]}")
    for row in rows:
        (out_dir / f"{row['arch']}_{row['shape']}_{row['mesh']}.json"
         ).write_text(json.dumps(row, indent=1))
        log(f"  {row['arch']} x {row['shape']} x {row['mesh']}: "
            f"{row['status']}; per device {row.get('hlo_flops_per_dev', 0):.6g}"
            f" flops, {row.get('hbm_bytes_per_dev', 0):.6g} B HBM, "
            f"{row.get('link_bytes_per_dev', 0):.6g} B link "
            f"{row.get('collective_breakdown')}; compute "
            f"{row.get('compute_s', 0):.6g} s, memory "
            f"{row.get('memory_s', 0):.6g} s, collective "
            f"{row.get('collective_s', 0):.6g} s -> {row.get('dominant')}; "
            f"args {row.get('arg_bytes', 0) / 1e9:.3f} GB, temp "
            f"{row.get('temp_bytes', 0) / 1e9:.3f} GB; undivided dims "
            f"{row.get('undivided_dims')}")
        if row["status"] != "ok":
            raise AssertionError(f"dry-run cell {row}")


def roofline_phase(served: dict, trained: dict) -> None:
    """Phase 7: the roofline against the card. Every model served in phase
    3 and trained in phase 5 is counted again on meta tensors at the
    shapes it ran (``repro_torch.roofline``), beside its measured times
    and peak memory: the counted flops must hold the bounds' parts, the
    decode step's bytes must reach the bound's, and the predicted peak
    must be within PEAK_TOL of the allocator's; then one cell a family on
    the (16, 16) fake mesh."""
    with phase("7a, the served and trained models counted on meta"):
        for arch, run in served.items():
            roofline_served(arch, run)
        for arch, run in trained.items():
            roofline_trained(arch, run)
    with phase("7b, one cell a family on the (16, 16) fake mesh"):
        roofline_family_cells()


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_phase() -> list:
    """Phase 5; returns the JSON entries of the kernels at the training
    shapes, each with the launches of its model's timed train steps, and
    {model: its train_full_width numbers}."""
    with phase("5a, the attention backward"):
        attention = check_attention_backward()
        free()
    with phase("5b, the recurrence backwards"):
        recurrences = check_recurrence_backward()
        free()
    bwd_ms = {**{("flash_attention_backward", arch): t
                 for arch, t in attention["bwd_ms"].items()},
              **recurrences["bwd_ms"]}
    trained = {}
    for arch in TRAINED:
        with phase(f"5c, {arch} trained"):
            trained[arch] = train_full_width(arch, bwd_ms)
            free()
    for arch, seq, micro in COMPARED:
        with phase(f"5d, {arch} kernel vs plain paths"):
            compare_train_paths(arch, seq, micro)
            free()
    with phase("5e, run_training resumes"):
        run_training_resumes()
    with phase("5f, moonshot's grouped MoE dispatch against the flat one"):
        check_grouped_dispatch()
        free()
    launched_by = {"wkv6_train": ("rwkv6-3b", "wkv6"),
                   "wkv6_backward": ("rwkv6-3b", "wkv6_backward"),
                   "mamba_scan_train": ("hymba-1.5b", "mamba_scan"),
                   "mamba_scan_bwd": ("hymba-1.5b", "mamba_scan_backward")}
    for suffix, arch in ATTENTION_TRAINED.items():
        launched_by[f"flash_attention_bwd{suffix}"] = \
            (arch, "flash_attention_backward")
        launched_by[f"flash_attention_train{suffix}"] = \
            (arch, "flash_attention")
    entries = [*attention["entries"], *recurrences["entries"]]
    for e in entries:
        arch, kernel = launched_by[e["name"]]
        e["launches"] = trained[arch]["launches"][kernel]
    return entries, trained


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels.ops  # noqa: F401  (fails outside the repo)
    with phase("1, environment and build"):
        smi = environment()
    with phase("2, kernels against their plain versions"):
        kernels = [check_flash_attention(), check_decode_attention(),
                   *check_wkv6()]
        kernels += check_mamba_scan()
        for tag in ATTENTION_SHAPES:
            kernels += check_attention_shape(tag)
            free()
    # each entry's launches come from the run of the model served at its
    # shape: {entry: (model, kernel)}
    launched_by = {"flash_attention": ("qwen3-8b", "flash_attention"),
                   "decode_attention": ("qwen3-8b", "decode_attention"),
                   "wkv6": ("rwkv6-3b", "wkv6_chunked"),
                   "wkv6_decode": ("rwkv6-3b", "wkv6_token"),
                   "mamba_scan": ("hymba-1.5b", "mamba_scan_chunked"),
                   "mamba_scan_decode": ("hymba-1.5b", "mamba_scan_token")}
    for tag, arch in ATTENTION_SHAPES.items():
        for kernel in ("flash_attention", "decode_attention"):
            launched_by[f"{kernel}_{tag}"] = (arch, kernel)
    launches, served = {}, {}
    for arch in [*SERVED, *STUB_SERVED]:
        with phase(f"3, {arch} served"):
            served[arch] = serve_stub(arch) if arch in STUB_SERVED \
                else serve_full_width(arch)
            launches[arch] = served[arch]["launches"]
            free()
            log(f"{arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
                f"GB still allocated")
    with phase("3b, every config at depth 1"):
        sweep_depth_one()
    with phase("4, small models on the card and the CPU"):
        small_models_cpu_vs_card()
        free()
    with phase("5, training"):
        trained, train_runs = train_phase()
    with phase("6, the sharded path on a (1, 1) mesh"):
        sharded_phase()
    with phase("7, the roofline against the card"):
        roofline_phase(served, train_runs)
    for k in kernels:
        arch, kernel = launched_by[k["name"]]
        k["launches"] = launches[arch][kernel]
    # the kernels at the training shapes, launched by the timed train steps
    kernels += trained
    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - t0:.1f}"
        f" s")
    # every entry's keys, then the backward kernels' torch-ops backward
    # that the card ran before them
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "cold_ms", "torch_ops_ms"]
    print(json.dumps({"kernels": [{key: k[key] for key in order if key in k}
                                  for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
