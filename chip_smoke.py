"""Smoke run of the PyTorch + CUDA port (``spatialrgpt_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--profile DIR] [--paths A,B]

Phases, each printed as one JSON line:

1. device  -- the card, its power limit, TF32 switched off for every
   comparison (float32 matmuls and cuDNN convolutions in full float32).
2. build   -- nvcc builds every kernel of ``spatialrgpt_tpu_torch/csrc``
   (one nvcc per source, all at once); ptxas's registers, spill bytes and
   static shared memory per kernel, from the build's log.
3. kernel  -- each kernel against its plain PyTorch version at its main
   path's shapes, in bf16, with the max abs error and its ratio to the
   per-element bound of ``ops/_checks.py::bf16_err_over_bound`` (4 bf16
   ulps of the element plus of its row's largest value; at most 1
   passes): K1-K3 at the serving shapes (K2 also at SpatialRGPT-Bench's
   prefill: 32 rows in the 1024 bucket, one live segment of 250-320
   positions a row, the rest padding), K4's forward, dK/dV and dQ
   kernels at the align step's (B4 S4096 Hq32 Hk8 D128, 4 packed samples
   per row and a padded tail), K5 at SAM vit_h's global layers (B4 S4096
   on a 64 x 64 grid, H16 D80, f32 rel-pos bias; also at B1, the synth
   path's one image a call) and K6 at SAM's and
   Depth-Anything's LayerNorm rows, K7-K9 (the quantized projections) at
   the W8A8 serve's shapes: K7 over the prefill's 20,480 rows (at 4096
   and at down's 14,336), a decode step's 64 rows and the engine's 32
   slots, and the tower's 93,312 rows (at 1152 and 4304), each row naming
   the form ``act_quant_form`` picks and timing the two-pass loop form
   beside it (``loop_ms``; the decode rows also an empty kernel,
   ``empty_kernel_ms``), K8 at the
   prefill's gate and SigLIP's fc1 over the tower's 93,312 rows (ragged N
   4304 and K 1152; its large form) and at the decode's lm_head and gate
   (its decode form), K9 at the decode's down and k/v projections (its
   decode form) and on its large form at the QLoRA step's gate, down and
   k / v over 16,384 rows with the LoRA side branch's f32 addend, a
   4096-row chunk of its lm_head and an engine admission's down projection
   (1536 rows; each row names the form), K10 over the W8A8 align step's
   gate / up output gradient (16,384 x 14,336), q / wo / down's (x 4096)
   and Mixtral's router's (x 8), with ``loop_ms``, and K11 at its gate / up
   and down dx (both launches; the transpose alone in ``transpose_ms``)
   (K7, K8, K10 and K11 must equal their plain versions bit for bit).  K1, K2, K5 and K4's three kernels run
   on the TMA + wgmma loops of ``csrc/attention_sm90.cuh`` (K2 and K4's
   forward and dQ with G = 4 query heads x 32 positions per CTA and the
   causal x segment mask built in the kernel; K4 walks only the tiles of
   its rows' segments, dK/dV key-stationary: 128 keys per CTA, the G heads'
   dK and dV summed in registers); K3 is one launch of a thread-block
   cluster per (row, kv head), also at the W8A8 serve's 64 rows and there
   in its packed-int4 form (listed under K3's ``other_shapes``); K6 is a streaming kernel that takes the
   models' bf16 weights as they are (one launch per LayerNorm).  Per row:
   the device time of the kernel (``ms``), of its plain version
   (``plain_ms``) and of one PyTorch call of the same function
   (``library_ms``, with ``library`` naming it and its pinned SDPA
   backend; null for K3 and K7, which no single call computes; for K8
   ``torch._int_mm``'s int32 product alone (N zero-padded to a multiple
   of 8 where it is none), for K11 the same in the
   faster of two layouts of the weight (as stored, and a column-major copy
   made beforehand; each layout's time in ``library_each_layout_ms``), for
   K9 ``F.linear`` on a bf16 copy of the weight); for K4 also
   ``library_per_sample_ms``, SDPA's flash backend with ``is_causal`` over
   the per-sample view of the same q/k/v (4 equal samples per row, checked),
   which computes only the live pairs, as K4 does.  All by CUDA events:
   around one replay of a CUDA graph of
   many calls where a call is shorter than its launch on the host (K1-K3,
   K6, K7, K9, K8 at decode), around many back-to-back calls for the
   kernels of milliseconds (K4, K5, K8 at prefill and tower rows); and ``bound_ms`` /
   ``bound_by``, the larger of the live work's operations over the peak of
   their type (bf16 989 TFLOP/s, int8 1,979 TOP/s, K7's elementwise f32
   67 TFLOP/s) and its bytes over 3.35 TB/s (causal and segment pairs only
   for K2 and K4, and q, k, v read at positions of a nonzero segment only;
   K3's live cache positions).
4. grad    -- gradients of q, k and v through the CUDA routes of K1 and K2
   against the plain path's, with the same bound.
5. main    -- region-QA ``generate`` at the full width of llama3-8b (bf16
   weights from a fixed seed, made on the card; int8 KV cache), 8 rows of
   RGB + depth + 2 masks and a 320-token prompt bucket, 32 greedy tokens:
   bench.py with SRGPT_BENCH_W8A8=0.  Checks the tokens, the first- and
   last-step logits against the plain path run on the same weights (the
   last step in the rows whose tokens all equal the plain path's), and
   the kernels' launch counts.
   serve_w8a8 -- bench.py's default: the same at 64 rows with the llm and
   the vision tower W8A8 (``init_random_quantized``) and the int8 KV
   cache.  Checks the launch counts of K1-K3 and K7-K9 (K9 exactly where
   a contracting projection runs below 2048 rows), first-token logits bit-
   equal to the same run on K7-K9's plain versions, and the attention
   kernels at 64 rows (``phase_serve_w8a8`` says why the plain route is
   held in two halves).
   engine -- the continuous-batching ``ServingEngine``: (a) on phase
   main's model, 16 requests through 8 slots in two waves of one
   admission each, every wave's greedy tokens equal to ``generate`` on its
   rows with the int8 cache (K3) and with the bf16 cache, the int8 run's
   first-token logits against the engine on the plain route; (b)
   bench_engine.py's configuration on serve_w8a8's W8A8 model: 32 slots,
   64 requests of 48-127 text tokens in the 384 bucket, 64 greedy tokens,
   windows of 8, admission width 8, all submitted at once after a warm-up;
   every request's 64 tokens, the launch counts of K1-K3 and K7-K9 worked
   out from the admissions and windows that ran (an admission of n
   requests prefills n x 384 rows: W8A8 throughout from n = 8, K9 for the
   contracting projections below), the cache's and the run's peak GB, and
   bench_engine.py's figures (tokens/s, wall, latency p50 / p95, scheduler
   syncs); (c) the fused mixed-batch chunked prefill on (b)'s model and
   requests (chunks of 64 tokens, 2 admissions in flight, all submitted
   at t0): every request's tokens, the launch counts from the fused steps
   by their live rows, the same figures, the chunk attention's device ms
   per fused step and its share of the fused windows; part (a) runs the
   same fused engine on its bf16 model, every admission's first-token
   logits within LOGITS_REL_BOUND of its unchunked admission and of the
   fused engine on K1-K3's plain versions.  serve_w8a8 adds two runs on
   its model: ``generate(kv_bits=4)`` on K3's packed-int4 form (its
   launches; the cache's GB against int8's; the int4 form against its plain
   version through ``generate`` on bf16 weights, as the attention kernels
   are held there) and ``fuse_serving_kernels`` (first-token logits
   bit-equal to the unfused run; with every projection on W8A8 the fused
   and unfused runs bit-equal).
6. train   -- the stage-1 align step at the full width of llama3-8b and
   SigLIP-so400m (frozen decoder and tower, tuned projector and region
   extractor, lr 1e-3, remat, chunked CE over 1024 positions,
   ``attn_impl="pallas"``) on bench_train.py's batch (4 packed rows of
   4096 tokens, 4 samples per row, RGB + depth, 2 regions): the kernel
   path's loss and gradients against the plain path's on one row, then
   three ``Trainer`` steps with a checkpoint.  Checks the launch counts
   of every step, the first loss, that the frozen modules stay
   bit-unchanged and that the tuned ones move once the lr is above 0.
   align_w8a8 -- bench_train.py's SRGPT_TRAIN_BENCH_QUANT=1, then =2, on one
   model: the same align step over a W8A8 decoder and tower (quantized
   from init_random's bf16 weights), the bf16 straight-through dx, then
   the int8 dx on K10 + K11.  Per setting: the quantized route (K7, K8,
   K10, K11) against its plain versions on one row (loss bit-equal,
   gradients bit-equal where the route is deterministic), the cosine of
   the tuned gradients against the bf16 align step's (reported); under
   both, on the same W8A8 forward, the int8 dx against the bf16 STE's by
   depth (the cosine at the lm_head's input and at each decoder layer's
   input, with the int8 dx everywhere, in the decoder alone, in the
   lm_head alone; reported); three
   steps with the launch counts of K1, K4 and K7-K11 from the shapes, the
   frozen base bit-unchanged, the tuned modules moving; the median of
   steps 2-3, tokens/s and the steps' peak GB.
   qlora -- bench_train.py's qlora stage: int8 weight-only decoder and
   lm_head made in the int8 layout, bf16 tower, LoRA r 64 / alpha 16 on
   the seven projections (bf16 adapters, the side branch), projector and
   region extractor co-trained at lr 2e-5; the K9 route against its plain
   version on one row with every b drawn nonzero (so the side branch's
   addend is live), and two wrong routes (K9's sums in bf16, the addend
   dropped) that must fail the same comparison; three steps with the
   launch counts, the base
   bit-unchanged and the adapters, projector and region extractor moving;
   the same figures.
   recipe -- the training entry point, ``train/train.py::main``, from argv
   as ``python -m spatialrgpt_tpu_torch.train.train`` takes it, at the
   same widths and RECIPE_LAYERS = 4 of llama3-8b's 32 layers (each run
   writes or reads a composite of the whole model): a composite directory
   of ``init_random`` weights (seed 0)
   written first is the base model, a character tokenizer of Llama-3's
   size (``CharTokenizer``; ``<mask>`` / ``<depth>`` added past it grow
   the vocabulary by 2) stands in for the tokenizer files, and the
   ``dummy`` mixture (32 samples of one 384 x 384 image, its depth and one
   region, packed by the collator into 4 rows of 4096) for the data.
   (a) 1_mm_align.sh's flags cut to ``--data_mixture dummy
   --gradient_accumulation_steps 2 --max_steps 4 --save_steps 2``: K1's
   and K4's launches every micro step, the projector and region
   extractor moving after micro steps 2 and 4 only, decoder and tower
   bit-unchanged, the accumulator in the checkpoint; a second ``main`` in
   the same directory to 6 micro steps resumes at 4 with it restored; the
   same flags on ``--attn_impl xla`` (stopped after one step by
   ``--total_time_limit``): the first loss within 1%.  (d) The composite
   that (a) saved, read back by ``load_reference_checkpoint``: logits on
   one row bit-equal to the trained model's.  (e) The same trained model
   written by ``save_composite_hf`` (the directory the PyTorch reference
   loads: float32 tensors and HF configs) and read back through
   ``SpatialRGPTConfig.load``'s reference-composite branch: its logits on
   that row bit-equal too, the top-level config holding ``llm_cfg`` and
   the region tokens; the bytes written, the write and read seconds.
   (b) ``--lora_enable true
   --bits 8 --lora_r 64 --lora_alpha 16``, 2 steps: K9's launches on its
   large form, the int8 base bit-unchanged, the trained modules moving,
   ``adapter.npz`` and ``non_lora_trainables.npz`` loading back equal.
   (c) ``--dpo_enable`` on 4 preference pairs over PNG images, 2 a step,
   2 steps: the first loss ln 2 within 1e-4 with every reward 0, the
   second finite, the reference copy unchanged.  Per part the median step
   after the first, positions/s and peak GB.  The launches counted are
   ``main``'s alone (``recipe_main``); (d)'s and (e)'s comparisons are
   not counted.
   eval -- the evaluation entry points (``spatialrgpt_tpu_torch/eval``) at
   the same widths, bf16 weights from seed 0, a character tokenizer of
   Llama-3's size and synthetic files: 24 SpatialRGPT-Bench entries (48
   records) over 12 JPEGs of 480 x 640, 768 x 1024 and 375 x 1242, a COCO
   instances file, a VQA question file.  (a) ``run_bench`` at
   srgpt_bench.sh's configuration (32 rows, the 1024 bucket, 128 greedy
   tokens, bf16 KV cache) with Depth-Anything ViT-L read from an HF-named
   ``pytorch_model.bin`` through ``depth_model_path`` (its depth bit-equal
   to the in-memory model's): the records' fields, K1 / K2 counts from the
   batches and no other kernel, the first batch's first-token logits
   against the plain route (``generate`` on ``attn_impl="xla"`` patched
   into the runner), then ``judge.score_file``: a score for every
   category.  (b) The same with ``w8a8=True, kv_quant=True`` on the same
   model and predictor: no Depth-Anything forward (memoized), K1-K3 and
   K7-K9 counts from the shapes, first-token logits bit-equal to K7-K9's
   plain versions, the caller's bf16 model bit-unchanged.  (c)
   ``run_region_cls`` on 32 COCO boxes and ``run_vqa`` on 16 questions (32
   tokens each): records, K1 / K2 counts, ``score_region_predictions``.
   Per run wall s, records/s, generated tokens/s, peak GB; per batch the
   first-token and decode s (a wrapper around the runner's ``generate``);
   the Depth-Anything stage's s.
7. demo    -- bench_demo.py's pipeline (``demo/pipeline.py``) on 8
   synthetic photos of 768 x 1024: Depth-Anything ViT-L colorized depth,
   SAM-HQ vit_h masks for 2 boxes per image in chunks of 4, device
   preprocessing, region QA on llama3-8b (32 greedy tokens), all from
   fixed seeds on the card, with ``SRGPT_FUSED_LN``'s switch on and the
   VLM W8A8 as bench_demo.py builds it.  Checks the launch counts (K5 per
   SAM global layer and chunk, K6 at every LayerNorm that passes the gate,
   K1-K3 and K7-K9 as in phase serve_w8a8), then runs the same pipeline on
   K5's, K6's and K7-K9's plain versions and the VLM's xla route and holds
   depth and mask logits to it, and the VLM stage as serve_w8a8 does; also
   ``DemoEngine.set_image`` / ``add_regions`` on one photo through the
   adapters.
8. synth   -- the 2D -> 3D synthesis pipeline's entry point,
   ``run_directory(SynthPipeline(cfg, **build_stage_models(...)), dir,
   out)``, over 8 synthetic JPEGs (4 of 480 x 640, 4 of 768 x 1024): RAM
   Swin-L tagger (4585 synthetic tag names), OWL-ViT B/32 detector (a
   character tokenizer in the CLIP BPE's place), SAM vit_h segmenter, metric
   Depth-Anything ViT-L with CameraNet intrinsics and gravity, the host's
   lift, template QA; bf16, random from fixed seeds, ``SRGPT_FUSED_LN``'s
   switch on.  Checks the launch counts (K5 once per SAM global layer and
   segmented image, K6 at RAM's head and SAM's encoder, nothing else), each
   segmented image's mask logits on the K5 route against the plain route
   (its recorded boxes through both, K6 on in both), QA pairs on each shape
   and ``out.json``; reports per image the counts of each stage and the
   mask pixels that differ between the routes, and per stage the seconds.
9. families -- the presets beside Llama's through ``generate`` (phase
   main's region QA: 8 rows, 320 bucket, the int8 cache, 64 greedy
   tokens), random weights from seed 0 at full width: mistral-7b bf16 (and
   one row of 4600 live positions in the 4608 bucket, where its 4096
   window binds: the plain route without the window must lie further from
   the plain route than the kernels do) and W8A8; gemma-7b bf16 and W8A8
   (K2's D = 256 form, K3 at D 256, the tied f32 head); mixtral-8x7b W8A8
   on the dense MoE at its 32 layers, then a ``ServingEngine`` run of the
   same 8 rows through 8 slots, its tokens equal to ``generate``'s; the
   sparse MoE in bf16 at Mixtral's widths on 8 of its layers, experts
   stacked, against the dense block.  Checks each run's launch counts, the
   bf16 runs against K1-K3's plain versions (``logits_vs``), the W8A8 runs'
   first-token logits bit-equal on K7-K9's plain versions; reports TTFT,
   decode tokens/s, peak GB per run.  The kernel phase adds K2 at D 256
   (B8 S320 Hq16 Hk16) and windowed (B1 S4608, window 4096), K3 at D 256
   n_rep 1 (B8 C384 Hq16), K8 and K9 at Mixtral's router (N 8) and Gemma's
   gate and down.
10. families_train -- the families' training at full width on phase
   train's batch (``phase_families_train``): gemma-7b's and mistral-7b's
   bf16 align steps (K4's D = 256 forms and the tied head's backward; K4 at
   D 128 with Mistral's window), each held to the plain route on one row
   (Gemma at FAMILY_TRAIN_CHECK_DEPTH layers, its full depth reported),
   then one QLoRA step each on the decoder quantized to int8; mixtral-8x7b
   over a frozen W8A8 base at its 32 layers, QUANT=1 then =2, the router
   aux loss in the loss and the metrics, held bit-equal to K7-K11's plain
   versions on one row; one Mixtral QLoRA step (LoRA on every expert) at
   MIXTRAL_QLORA_LAYERS layers; ``train.main`` from argv on
   ``--llm_preset gemma-7b`` and on ``mistral-7b --lora_enable --bits
   8``, one micro step each.  Launch counts per step from the config.
   The kernel phase adds K4's three D = 256 forms at Gemma's B4 S4096
   Hq16 Hk16 and K10 / K11 at Mixtral's router (N 8).
11. synth_train -- ``synth/train_calibration.py``'s two trainers on the
   card (``phase_synth_train``): CameraNet at its widths on warps of the
   synth path's photos, the metric Depth-Anything ViT-L on an RGBD
   manifest of them, without and with ``freeze_backbone`` (whose
   backbone must only decay); loss histories and seconds a step.
12. towers -- the other vision towers and the MPT decoder
   (``phase_towers``), full width, bf16, random from fixed seeds, each
   built from ``build_vision_tower``'s config: CLIP ViT-L/14-336 on 16
   images (23 of 24 layers), CLIP-S² at 336 / 672 / 1008 on 4 images (56
   crops in one tower pass, hidden 3072), InternViT-6B on 4 images at 448
   px (48 layers, K1's D = 128 form), RADIO ViT-H/16 through
   ``RadioVisionTower`` on 2 photos at the 768-pixel longest edge in
   ``patch`` and ``dense``, ``vlm.forward_mpt`` on MPT-7B behind
   SigLIP-so400m over phase main's 8 rows and over the same samples packed
   2 a row.  Checks K1's launches (once a tower layer, nothing else) and
   the kernel route against K1's plain version (features and logits within
   0.05, or each layer's update within 0.02 where random depth amplifies);
   reports a forward's device ms and peak GB per model.  The kernel phase
   adds K1 at CLIP's B16 S577 H16 D64 and InternViT-6B's B4 S1025 H25 D128.
13. parallel -- the parallel stack (``parallel/``) on a one-rank NCCL
   process group made from a ``FileStore`` in a temporary directory
   (``phase_parallel``; the card has one rank: a larger group's collectives
   run in the CPU tests over gloo): (a) the llama3-8b + SigLIP-so400m align
   step at full width wrapped in FSDP2 by ``shard_state`` (its parameters
   DTensors), Ulysses at degree 1 with K4 as its local attention, held to
   the unwrapped step's loss and gradients (TRAIN_LOSS_REL_BOUND,
   TRAIN_GRAD_REL_BOUND); (b) ``generate`` through the tensor-parallel code
   path (``tp_shard_model`` on a one-rank tp dim: its all-reduces and the
   logits all-gather over that rank) on bf16 and on W8A8 weights, greedy
   tokens equal to the plain serve's; (c) the ``ServingEngine`` with a
   one-rank ``mesh``, its wave's tokens equal to (b)'s; (e) ``train.main``
   from argv (1_mm_align.sh's flags, ``--ckpt_backend orbax``) stopped after
   one micro step with a sharded checkpoint, then resumed from it for one
   more.  Launch counts of every run from the config.  The kernel phase
   adds (d): K2, K3, K4 (all three), K7's split form (a fan-in slice
   quantized by the whole rows' scales; at the prefill's down slice and a
   decode step's wo slice, its passes also timed apart: ``pass1_ms``,
   ``pass2_ms``) and K8 / K9 at the shapes a rank
   of a degree-4 run hands them (llama3-8b's Hq 8, Hk 2, intermediate
   3584, a quarter of the vocabulary; K4 also at sp 8 and at one row of
   16,384 positions).

The times of phases 5-13 are smoke figures of this card, not a
benchmark.  Then the ``kernels`` line (one row per kernel at its first
shape, its later shapes under ``other_shapes``) and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before that line; so does a machine
without a CUDA card, and a directory without the port's package.
``--paths recipe`` (or any other paths of ``PATHS``, comma-separated)
runs the device and build phases and only those paths: a partial run for
working on one path, without the kernel phase and the last two lines.
``--profile DIR`` (the recipe phase is not profiled: its steps are the
align and QLoRA steps' own) also profiles the W8A8 serve's first token and its
whole ``generate``, one wave of the engine's phase (b) (32 requests
through the 32 slots) and one of its part (c), the fused chunked prefill, one align step, one W8A8 align step under each
backward, one QLoRA step, one demo pipeline run and one synth image with
``torch.profiler`` and writes their operator tables to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_ROWS = 8
# bench.py's default serve (bench.py:123, :197-227): 64 rows, W8A8 llm and
# vision tower, int8 KV cache
SERVE_ROWS = 64
N_REGIONS = 2
PROMPT_TEXT_TOKENS = 96
PAD_BUCKET = 320
MAX_NEW = 32
# the engine phase: (b) is bench_engine.py's default configuration
# (bench_engine.py:31-38); (a) takes its windows of 8 and admission width 8
ENGINE_SLOTS, ENGINE_REQS, ENGINE_BUCKET, ENGINE_MAX_NEW, ENGINE_MULTI, ENGINE_ADMIT = 32, 64, 384, 64, 8, 8
ENGINE_TEXT_TOKENS = (48, 128)  # rng.integers' range of text tokens per request
# the fused chunked prefill's prompt tokens a chunk and admissions in flight (engine parts (a) and (c))
ENGINE_CHUNK, ENGINE_CHUNK_ROWS = 64, 2
# relative L2 distance allowed between the logits of the kernel path and of
# the plain path (first token, and last of the 32 steps): both run bf16
# through 26 ViT and 32 decoder layers, and each of the ~60 layers may round
# differently at bf16's 2^-8
LOGITS_REL_BOUND = 0.05
# the align step of bench_train.py: rows x tokens, samples per row
TRAIN_ROWS = 4
TRAIN_SEQ = 4096
TRAIN_SAMPLES_PER_ROW = 4
TRAIN_STEPS = 3
CE_CHUNK = 1024
# kernel path against plain path at the first align step, on one row: the
# loss (a mean over ~4000 targets) within 1% relative, and the projector's
# and region extractor's gradients within a relative L2 of 0.1 (both paths
# run bf16 forward and backward through 26 ViT and 32 decoder layers)
TRAIN_LOSS_REL_BOUND = 0.01
TRAIN_GRAD_REL_BOUND = 0.1
# the demo: bench_demo.py's batch of photos, their size, SAM's chunk
DEMO_IMAGES = 8
DEMO_HW = (768, 1024)
DEMO_SAM_CHUNK = 4
# kernel path against plain path over the whole demo pipeline, relative L2:
# the depth (only K6 differs; ViT-L in bf16), SAM's mask logits (K5 in 4 of
# 32 bf16 layers, K6) and, as in phase 5, the VLM's first-token logits.  On
# an H100 the sound K6 reads 0.0180 on the depth and a LayerNorm whose
# statistics leave out a row's last 8 columns reads 0.0214: the depth bound
# lies between them (PERF.md lists the faults it cannot see)
DEMO_DEPTH_REL_BOUND = 0.02
DEMO_MASK_REL_BOUND = 0.05
# the binary masks must agree wherever the plain path's logit is at least
# this share of the logits' RMS away from 0
DEMO_MASK_MARGIN = 0.5


# the synth path: run_directory over synthetic JPEGs of two shapes, 4 each
# (interleaved in the directory's sorted order), on the five models at the
# JAX package's widths in bf16 from fixed seeds
SYNTH_HW = ((480, 640), (768, 1024)) * 4
# random weights force the thresholds.  The tagger keeps RAM's class
# threshold (0.68: about a fifth of 4585 random logits pass).  A random
# OWL-ViT's patch scores sit at 0.507-0.520 in every image (its logits are
# nearly equal across patches and photos): 0.51 keeps 4-34 of the 576
# proposals of each of these photos.  SynthConfig keeps its defaults but for the mask
# area bound (random SAM masks cover ~3/4 of an image)
SYNTH_BOX_THRESHOLD = 0.51
SYNTH_CONFIG = dict(mask_area_max=1.0)
# the metric head's range in meters: Depth-Anything-V2-Metric's indoor
# (Hypersim) model's; the config's default of 1 is the relative model's
SYNTH_MAX_DEPTH = 20.0
# the CLIP BPE's begin / end-of-text ids (the end id is the largest, where
# OWL-ViT's text tower pools) and its 16 positions
CLIP_BOS, CLIP_EOT, CLIP_LEN = 49406, 49407, 16


# the families path: the presets of config.py beside the Llama ones, each
# as bench.py's region QA (the serve phase's rows and bucket) at 64 greedy
# tokens; Mistral also on one row whose live prompt passes its 4096-position
# window, and the sparse MoE (bf16: its stacked experts are float) at
# Mixtral's widths on this many of its 32 layers
FAMILY_MAX_NEW = 64
FAMILY_LONG_BUCKET, FAMILY_LONG_LIVE, FAMILY_LONG_MAX_NEW = 4608, 4600, 8
SPARSE_MOE_LAYERS = 8
# each decoder layer's update (output less input) on the kernel route
# against the plain route's, from the same input, relative L2: the
# attention kernels inside the model at full depth (H100: Mistral-7B's
# layers 0.0047-0.0074, Gemma-7B's 0.0060-0.0085); the sparse MoE block
# against the dense one on the tokens without a router tie (median 0.0055
# a token in bf16)
LAYER_REL_BOUND = 0.02
# the depth at which a preset's bf16 run is held to the plain route by
# ``logits_vs`` (its full widths): random Gemma-7B amplifies a bf16
# rounding layer after layer (first-token logits 0.208 apart after its 28
# layers on the H100, each route as far from an f32 decoder as the other),
# so its full depth is held layer by layer (LAYER_REL_BOUND) and its
# logits at 2 layers; the others at their full depth
FAMILY_LOGITS_DEPTH = {"gemma-7b": 2}


# kernels held bit-equal to their plain versions (the others within
# bf16_err_over_bound)
BIT_EQUAL = {"act_quant_int8", "w8a8_gemm", "act_quant_dy_int8", "int8_dx_gemm"}


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "ok": True, "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "tf32": "off (torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False)",
    })
    return smi


def ptxas_usage(log: str) -> dict:
    """Per compiled kernel (mangled name) in ptxas's -v output: [registers,
    spill store bytes, spill load bytes, static shared memory bytes]."""
    import re

    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = [None, 0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            usage[name][3] = int(m.group(1))
    return usage


def phase_build():
    from spatialrgpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log_path = os.path.join(os.path.dirname(_build.build_info["path"]), "build.log")
    emit({
        "phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
        "library": os.path.relpath(_build.build_info["path"], ROOT),
        "ptxas_registers_spill_store_load_smem_bytes": ptxas_usage(open(log_path).read()) if os.path.exists(log_path) else {},
    })


def train_spliced(cfg, rng, rows: int):
    """bench_train.py::build_batch's token layout: ``rows`` packed rows of
    TRAIN_SEQ tokens, each packing 4 samples of bos + the image + 2 x
    (<mask>, <depth>) + text (labels on the text), and a padded tail."""
    import numpy as np

    from spatialrgpt_tpu_torch import IGNORE_INDEX, IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE, expand_rows, pack_rows

    text_len = TRAIN_SEQ // TRAIN_SAMPLES_PER_ROW - NUM_TOKENS_PER_IMAGE - 2 * N_REGIONS - 8
    singles = []
    for _ in range(rows * TRAIN_SAMPLES_PER_ROW):
        ids = [1, IMAGE_TOKEN_INDEX] + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
        ids += list(rng.integers(10, 1000, text_len))
        labs = [IGNORE_INDEX] * (2 + 2 * N_REGIONS) + ids[2 + 2 * N_REGIONS:]
        singles.append(expand_rows(
            [np.asarray(ids, np.int64)], [np.asarray(labs, np.int64)], max_len=TRAIN_SEQ,
            tokens_per_image=NUM_TOKENS_PER_IMAGE, mask_token_id=cfg.mask_token_id,
            depth_token_id=cfg.depth_token_id, regions_per_image=N_REGIONS,
        ))
    sb = pack_rows(singles, max_len=TRAIN_SEQ)
    check(sb.input_ids.shape[0] == rows, f"packing gave {sb.input_ids.shape[0]} rows, not {rows}")
    return sb


def train_batch(torch, cfg, rng, rows: int):
    """The spliced rows plus random pixels, depths and region masks at the
    tower resolution, one image per sample (bench_train.py draws them so)."""
    import numpy as np

    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    sb = train_spliced(cfg, rng, rows)
    n, size = rows * TRAIN_SAMPLES_PER_ROW, cfg.vision.image_size
    return VLMInputs.from_spliced(
        sb,
        rng.standard_normal((n, size, size, 3)).astype(np.float32),
        rng.standard_normal((n, size, size, 3)).astype(np.float32),
        (rng.random((n, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((n, N_REGIONS), bool),
        device=DEVICE, dtype=torch.bfloat16,
    )


def llama3_8b_cfg():
    from spatialrgpt_tpu_torch import preset

    cfg = preset("llama3-8b")
    return cfg.replace(
        mask_token_id=cfg.llm.vocab_size, depth_token_id=cfg.llm.vocab_size + 1, num_extra_tokens=8,
        model_max_length=max(TRAIN_SEQ, cfg.model_max_length),
    )


def per_row(torch, fn, *args):
    """``fn`` over one batch row at a time, outputs concatenated: the plain
    K4 versions hold (rows, 8, 4, S, S) f32 scores, 2.1 GB per row at S 4096."""
    outs = [fn(*(a[b : b + 1] for a in args)) for b in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def event_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device time per call of a function that runs for milliseconds: CUDA
    events around ``iters`` back-to-back calls after a warm-up call, the
    median of ``reps`` such runs.  The host enqueues the next call while
    the device runs this one, so its launch cost stays hidden."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def graph_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device time per call of a function shorter than its own launch on
    the host (ctypes, the wrapper's checks, PyTorch's dispatch): ``iters``
    calls captured in one CUDA graph after a warm-up call, CUDA events
    around one replay, the median of ``reps`` replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(runs)


TIMERS = {
    "graph": (graph_ms, "a CUDA graph of {n} calls, CUDA events around its replay, median of 3 replays"),
    "events": (event_ms, "CUDA events around {n} back-to-back calls, median of 3 runs"),
}


# the H100 SXM's dense bf16 and int8 tensor-core peaks and its memory rate
# (NVIDIA's data sheet), for the least time a kernel's work can take on this card
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: elementwise work
PEAK_BYTES_S = 3.35e12


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The larger of operations over the peak of their type (bf16 unless
    given) and bytes (each input read once, each output written once) over
    the memory rate, in ms."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(seg, *tensors) -> int:
    """Bytes of per-position tensors (B * S positions in any layout) at the
    positions of a nonzero segment: a packed-segment kernel never reads
    the rest (its rows of segment 0 come out as zeros)."""
    live = int((seg != 0).sum())
    return sum(t.numel() // seg.numel() * t.element_size() * live for t in tensors)


def live_pairs(torch, seg, window=None) -> int:
    """(query, key) pairs a causal packed-segment kernel must compute: both
    in one nonzero segment, key <= query (and query - key < window)."""
    n = 0
    for row in seg:
        _, counts = torch.unique_consecutive(row[row != 0], return_counts=True)
        for c in counts.tolist():
            w = c if window is None else min(window, c)  # query i of a run of c sees min(i + 1, w) keys
            n += w * (w + 1) // 2 + (c - w) * w
    return n


def per_sample_length(seg, samples: int) -> int:
    """L, after checking that every row of ``seg`` holds ``samples``
    segments of L positions each, contiguous from position 0 with distinct
    nonzero ids, then only padding (bench_train.py's packing of equal
    samples): then causal attention over each sample as a row of its own
    is K4's function on the live rows."""
    L = int((seg[0] != 0).sum()) // samples
    for row in seg.tolist():
        ids = [row[i * L] for i in range(samples)]
        runs = all(row[i * L : (i + 1) * L] == [ids[i]] * L for i in range(samples))
        check(L > 0 and runs and 0 not in ids and len(set(ids)) == samples and not any(row[samples * L :]),
              f"the packed rows are not {samples} equal contiguous samples of {L} positions")
    return L


def sdpa_library(torch, backend: str, q, k, v, mask=None, is_causal=False):
    """One call of F.scaled_dot_product_attention on (B, H, S, D) copies of
    (B, S, H, D) inputs (k and v expanded to q's heads), made here, outside
    any timed window; pinned to ``backend``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(r, dim=2).transpose(1, 2).contiguous() for t, r in ((q, 1), (k, rep), (v, rep)))
    pinned = getattr(SDPBackend, backend)

    def call(*ins):
        with sdpa_kernel(pinned):
            return F.scaled_dot_product_attention(*ins, attn_mask=mask, is_causal=is_causal)

    return (qt, kt, vt), call



class Backward:
    """A library backward's figure: forward + backward minus forward, timed
    once and shared by the rows that name it (K4's dK/dV and dQ)."""

    def __init__(self, torch, fwd, fwd_bwd):
        self.torch, self.fwd, self.fwd_bwd, self.value = torch, fwd, fwd_bwd, None

    def ms(self, timer, iters: int) -> float:
        if self.value is None:
            self.value = timer(self.torch, self.fwd_bwd, iters) - timer(self.torch, self.fwd, iters)
        return self.value


def sdpa_yardsticks(torch, q, k, v, do, n: int, L: int, mask) -> dict:
    """K4's library yardsticks at one shape, as its D = 128 rows take them:
    SDPA's efficient backend with the (B, 1, S, S) causal x segment mask
    (``fwd``, and ``bwd`` one figure for dK/dV + dQ), and its flash backend
    with ``is_causal`` over the per-sample view of the rows' ``n`` samples
    of ``L`` positions (``per_sample_fwd`` / ``per_sample_bwd``).  A backend
    that refuses the shape gives None and its error as the label."""
    B = q.shape[0]
    out = {}
    for key, backend, ins, kw, dout in (
            ("", "EFFICIENT_ATTENTION", (q, k, v, do), {"mask": mask}, do),
            ("per_sample_", "FLASH_ATTENTION",
             tuple(t[:, : n * L].reshape(B * n, L, *t.shape[2:]) for t in (q, k, v, do)), {"is_causal": True}, None)):
        view = "(B, 1, S, S) causal x segment mask" if not key else f"the per-sample view ({B * n}, Hq, {L}, D), is_causal"
        label = f"F.scaled_dot_product_attention, k/v expanded to Hq, {view}, SDPBackend.{backend}"
        (qt, kt, vt), call = sdpa_library(torch, backend, *ins[:3], **kw)
        grad_in = tuple(t.detach().clone().requires_grad_() for t in (qt, kt, vt))
        do_t = ins[3].transpose(1, 2).contiguous()

        def fwd(call=call, qt=qt, kt=kt, vt=vt):
            with torch.no_grad():
                return call(qt, kt, vt)

        def fwd_bwd(call=call, grad_in=grad_in, do_t=do_t):
            return torch.autograd.grad(call(*grad_in), grad_in, do_t)

        try:
            fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused = f"{label}; refused at this shape: {e}"[:300]
            out[key + "fwd"] = out[key + "bwd"] = (refused, None)
            continue
        out[key + "fwd"] = (label, fwd)
        out[key + "bwd"] = (f"the backward of {label}: forward + backward minus forward, one figure for dK/dV + dQ",
                            Backward(torch, fwd, fwd_bwd))
    return out


def int_mm_library(torch, xq, q):
    """K8's yardstick: ``torch._int_mm``'s int32 product alone (no scales,
    bias or bf16 cast), where it takes the shape (M > 16, K and N multiples
    of 8); q.t() is a view, made here.  An N that is no multiple of 8 (a
    tp = 4 rank's slice of the decode head, 32,066) is zero-padded to the
    next one, made here: the padded columns are products of zero rows."""
    label = "torch._int_mm(xq, q.t()): the int32 product alone, without K8's scales, bias and bf16 cast"
    n = q.shape[0]
    if n % 8:
        q = torch.cat([q, q.new_zeros(8 - n % 8, q.shape[1])])
        label += f"; q zero-padded from N {n} to {q.shape[0]}"
    qt = q.t()
    try:
        torch._int_mm(xq, qt)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"{label}; refused at this shape: {e}"[:300], None
    return label, lambda: torch._int_mm(xq, qt)


def per_rows(torch, fn, a, q, s, rows: int = 4096):
    """K11's plain version over slices of ``rows`` rows: its f32 product
    chunks stay a few hundred MB."""
    return torch.cat([fn(a[i:i + rows], q, s[i:i + rows]) for i in range(0, a.shape[0], rows)])


def dx_int_mm_library(torch, dyq, q):
    """K11's yardstick: ``torch._int_mm``'s int32 product dyq @ q alone (no
    gscale, no bf16 cast) in each layout of q that cuBLASLt takes: q as
    stored (row-major), and a column-major copy of q made here, outside the
    timing.  The loop times every layout and keeps the fastest."""
    label = "torch._int_mm(dyq, q): the int32 product alone, without K11's gscale and bf16 cast, the faster layout of q"
    layouts, refused = {}, []
    for name, b in (("q as stored", q), ("a column-major copy of q made beforehand", q.t().contiguous().t())):
        try:
            torch._int_mm(dyq, b)
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused.append(f"{name}: {e}"[:150])
            continue
        layouts[name] = lambda b=b: torch._int_mm(dyq, b)
    if not layouts:
        return f"{label}; refused at this shape: {refused}"[:300], None
    return label, layouts


# the parallel path's rank-local shapes: llama3-8b at degree 4 (Hq 32 / 4,
# Hk 8 / 4, intermediate 14,336 / 4, vocab 128,256 / 4); K4 also at sp 8
PARALLEL_DEGREE = 4
PARALLEL_LONG_SEQ = 16384


def aq_bound(M: int, K: int, dy: bool = False, passes: str = "both") -> dict:
    """K7's (``dy``: K10's, with its column scale) bound: bf16 rows read
    once, int8 rows and an f32 scale a row written once; ``passes`` "max"
    (the split form's pass 1: the rows read, a max a row written) or
    "given" (its pass 2: the rows and a max a row read, the int8 rows and
    the scales written); a few f32 operations an element."""
    read = 2 * M * K + (4 * K if dy else 0)
    if passes == "max":
        return bound(2 * M * K, read + 4 * M, PEAK_F32_FLOPS)
    return bound((8 if dy else 6) * M * K, read + M * K + 4 * M + (4 * M if passes == "given" else 0), PEAK_F32_FLOPS)


def aq_shape(K789, M: int, K: int, dy: bool = False, **more) -> dict:
    """A K7 / K10 row's shape, with the form the wrapper picks for it and
    its launch numbers (csrc/act_quant.cu::srgpt_act_quant's)."""
    form, warps, count, each = K789.act_quant_form(M, K, dy)
    name = {K789.AQ_NARROW: "narrow", K789.AQ_ROWS: "rows", K789.AQ_LOOP: "loop", K789.AQ_RING: "ring"}[form]
    return {"M": M, "K": K, "form": name, "launch": {"warps": warps, "count": count, "each": each}, **more}


def aq_side_timings(torch, K789, x, col_scale=None, others=None, empty_kernel: bool = False) -> dict:
    """Figures timed beside a K7 / K10 row, each on buffers made here: the
    two-pass loop form at the same shape (``loop_ms``: where the wrapper
    picks another form, the one it is held against); with
    ``empty_kernel``, an empty kernel (the floor of a launch); for the
    split form (``others``: the other slices' row maxima, reduced in by a
    maximum as the all-reduce MAX would) its pass 1 alone, its pass 2 alone
    (from the maxima: each call writes the scales over them, the same work
    at every call) and the loop form's pair."""
    from spatialrgpt_tpu_torch.ops import _build

    M, K = x.shape
    loop = K789.AQ_LOOP_FORM
    xq = torch.empty((M, K789._pad16(K) if col_scale is not None else K), dtype=torch.int8, device=x.device)
    amax = x.float().abs().amax(dim=1)
    side = {}
    if empty_kernel:  # on the stream current at the call (a graph captures on its own)
        side["empty_kernel_ms"] = lambda: _build.check(_build.lib().srgpt_empty_kernel(_build.stream_ptr(x)),
                                                       "empty_kernel")
    if others is None:
        side["loop_ms"] = lambda: K789.act_quant_launch(x, col_scale, xq, amax, form=loop)
        return side

    def loop_pair():
        K789.act_quant_launch(x, None, None, amax, K789.AQ_MAX, loop)
        torch.maximum(amax, others, out=amax)
        K789.act_quant_launch(x, None, xq, amax, K789.AQ_GIVEN_MAX, loop)

    side["pass1_ms"] = lambda: K789.act_quant_launch(x, None, None, amax, K789.AQ_MAX)
    side["pass2_ms"] = lambda: K789.act_quant_launch(x, None, xq, amax, K789.AQ_GIVEN_MAX)
    side["loop_ms"] = loop_pair
    return side


def parallel_kernel_cases(torch, rn, i8, scales, causal_segment_mask):
    """The kernel phase's cases at the shapes a rank of a degree-4 run
    hands the kernels (tensor-parallel prefill and decode, Ulysses' local
    attention, the tensor-parallel W8A8 projections): a list of (case, its
    per-sample yardstick or None), each case in ``phase_kernels``' form."""
    import numpy as np
    import torch.nn.functional as F

    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops.quant import dequantize, quantize_kv

    dev = torch.device(DEVICE)
    n = PARALLEL_DEGREE
    cfg = llama3_8b_cfg()
    lc = cfg.llm
    Hq, Hk, D = lc.num_attention_heads // n, lc.num_key_value_heads // n, lc.head_dim
    out = []
    # K2: the tensor-parallel prefill of phase main's 8 rows, right-padded
    B, S = N_ROWS, PAD_BUCKET
    q2, k2, v2 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, : S - 3 * b - 15] = 1
    lib2_in, lib2_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q2, k2, v2, causal_segment_mask(seg))
    shape = {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "path": f"parallel: tp={n} prefill, a rank's heads"}
    out.append(((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228", shape,
        lambda: K2.onepass_attention(q2, k2, v2, seg), lambda: K2.onepass_attention_plain(q2, k2, v2, seg),
        (50, 5, "graph"),
        bound(4 * D * Hq * live_pairs(torch, seg), live_bytes(seg, q2, k2, v2) + nbytes(seg, q2)),
        ("F.scaled_dot_product_attention, k/v expanded to Hq, (B, 1, S, S) causal x segment mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib2_call(*lib2_in)),
    ), None))
    # K3: the tensor-parallel decode against a rank's kv heads of the int8 cache
    C = PAD_BUCKET + MAX_NEW
    q3 = rn(B, Hq, D)
    kq, ks = quantize_kv(rn(B, C, Hk, D))
    vq, vs = quantize_kv(rn(B, C, Hk, D))
    kq, vq = kq.reshape(B, C, Hk * D), vq.reshape(B, C, Hk * D)
    lengths = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 330], dtype=torch.int32, device=dev)
    live3 = int(torch.clamp(lengths + 1, max=C).sum())
    out.append(((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174",
        {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D, "path": f"parallel: tp={n} decode, a rank's kv heads"},
        lambda: K3.decode_attention_int8_flat(q3, kq, ks, vq, vs, lengths, Hk),
        lambda: K3.decode_attention_int8_flat_plain(q3, kq, ks, vq, vs, lengths, Hk), (200, 20, "graph"),
        bound(4 * Hq * D * live3, nbytes(q3, lengths, q3) + live3 * Hk * (2 * D + 2 * 4)),
        ("no single call dequantises an int8 cache", None),
    ), None))
    # K4 (forward, dK/dV, dQ): Ulysses' local attention over the whole
    # sequence at a rank's heads: the align step's 4 packed rows at sp 4 and
    # at sp 8, and one long row of PARALLEL_LONG_SEQ positions at sp 4
    src4, fa = "spatialrgpt_tpu_torch/csrc/flash_attention_sm90.cu", "spatialrgpt_tpu/ops/flash_attention.py"
    seg_train = torch.as_tensor(train_spliced(cfg, np.random.default_rng(0), TRAIN_ROWS).segment_ids, device=dev)
    seg_long = torch.ones(1, PARALLEL_LONG_SEQ, dtype=torch.int32, device=dev)
    for seg4, sp, samples in ((seg_train, n, TRAIN_SAMPLES_PER_ROW), (seg_train, 2 * n, TRAIN_SAMPLES_PER_ROW),
                              (seg_long, n, 1)):
        B4, S4 = seg4.shape
        hq, hk = lc.num_attention_heads // sp, lc.num_key_value_heads // sp
        q4, k4, v4, do4 = rn(B4, S4, hq, D), rn(B4, S4, hk, D), rn(B4, S4, hk, D), rn(B4, S4, hq, D)
        out4, lse4 = K4.flash_attention_fwd(q4, k4, v4, seg4)
        bwd = (q4, k4, v4, seg4, lse4, K4.attention_delta(out4, do4), do4)
        per_position = (q4, k4, v4, lse4, bwd[5], do4)
        shape4 = {"B": B4, "S": S4, "Hq": hq, "Hk": hk, "D": D, "samples_per_row": samples,
                  "path": f"parallel: Ulysses sp={sp}, the local attention at a rank's heads"}
        L = per_sample_length(seg4, samples)
        lib = sdpa_yardsticks(torch, q4, k4, v4, do4, samples, L, causal_segment_mask(seg4))
        pairs = live_pairs(torch, seg4)
        out += [
            (("flash_attention_fwd", src4, f"{fa}:226", shape4,
              lambda q=q4, k=k4, v=v4, s=seg4: K4.flash_attention_fwd(q, k, v, s),
              lambda q=q4, k=k4, v=v4, s=seg4: per_row(torch, K4.flash_attention_fwd_plain, q, k, v, s),
              (10, 1, "events"), bound(4 * D * hq * pairs, live_bytes(seg4, q4, k4, v4) + nbytes(seg4, q4, lse4)),
              lib["fwd"]), lib["per_sample_fwd"]),
            (("flash_attention_bwd_dkv", src4, f"{fa}:716", shape4,
              lambda b=bwd: K4.flash_attention_bwd_dkv(*b),
              lambda b=bwd: per_row(torch, K4.flash_attention_bwd_dkv_plain, *b), (10, 1, "events"),
              bound(8 * D * hq * pairs, live_bytes(seg4, *per_position) + nbytes(seg4, k4, v4)), lib["bwd"]),
             lib["per_sample_bwd"]),
            (("flash_attention_bwd_dq", src4, f"{fa}:776", shape4,
              lambda b=bwd: K4.flash_attention_bwd_dq(*b),
              lambda b=bwd: per_row(torch, K4.flash_attention_bwd_dq_plain, *b), (10, 1, "events"),
              bound(6 * D * hq * pairs, live_bytes(seg4, *per_position) + nbytes(seg4, q4)), lib["bwd"]),
             lib["per_sample_bwd"]),
        ]
    # K8 / K9: the tensor-parallel W8A8 projections of a rank (bench.py's
    # default serve, SERVE_ROWS rows in the 320 bucket): the fan-out slices
    # of q, k / v, gate / up and the head, the fan-in slices of wo and down,
    # and the decode's weight-only down (a contracting slice under 2048 rows)
    H, I = lc.hidden_size, lc.intermediate_size
    kvd = lc.num_key_value_heads * lc.head_dim
    V = lc.vocab_size + cfg.num_extra_tokens
    m_pf = SERVE_ROWS * PAD_BUCKET
    # K7's split form on a rank's fan-in slice of down (the first I / n
    # columns of the prefill's rows): pass 1, the rows' maxima reduced with
    # the other slices' (the all-reduce MAX of a tp group; here a maximum
    # with theirs, found beforehand), pass 2
    x7 = rn(m_pf, I)
    mine7, others7 = x7[:, : I // n].contiguous(), x7[:, I // n :].float().abs().amax(dim=1)
    del x7

    def reduce7(amax, others=others7):
        torch.maximum(amax, others, out=amax)

    Ks = I // n
    out.append(((
        "act_quant_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:30 (XLA)",
        aq_shape(K789, m_pf, Ks, path=f"parallel: tp={n} prefill down (fan-in slice), split form",
                 pass1_bound_ms=aq_bound(m_pf, Ks, passes="max")["bound_ms"],
                 pass2_bound_ms=aq_bound(m_pf, Ks, passes="given")["bound_ms"]),
        lambda: K789.act_quant_int8(mine7, reduce7), lambda: K789.act_quant_int8_plain(mine7, reduce7),
        (20, 2, "events"), bound(6 * m_pf * Ks, nbytes(mine7) + m_pf * Ks + 3 * 4 * m_pf, PEAK_F32_FLOPS),
        ("no single call quantizes rows to int8 with a scale per row", None),
    ), None, aq_side_timings(torch, K789, mine7, others=others7)))
    # the same on a rank's fan-in slice of wo in a decode step (SERVE_ROWS rows)
    x7d = rn(SERVE_ROWS, H)
    mine7d, others7d = x7d[:, : H // n].contiguous(), x7d[:, H // n :].float().abs().amax(dim=1)
    del x7d
    Kd = H // n
    out.append(((
        "act_quant_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:30 (XLA)",
        aq_shape(K789, SERVE_ROWS, Kd, path=f"parallel: tp={n} decode wo (fan-in slice), split form",
                 pass1_bound_ms=aq_bound(SERVE_ROWS, Kd, passes="max")["bound_ms"],
                 pass2_bound_ms=aq_bound(SERVE_ROWS, Kd, passes="given")["bound_ms"]),
        lambda: K789.act_quant_int8(mine7d, lambda a: torch.maximum(a, others7d, out=a)),
        lambda: K789.act_quant_int8_plain(mine7d, lambda a: torch.maximum(a, others7d, out=a)),
        (200, 20, "graph"), bound(6 * SERVE_ROWS * Kd, nbytes(mine7d) + SERVE_ROWS * Kd + 3 * 4 * SERVE_ROWS,
                                  PEAK_F32_FLOPS),
        ("no single call quantizes rows to int8 with a scale per row", None),
    ), None, aq_side_timings(torch, K789, mine7d, others=others7d, empty_kernel=True)))
    for label, M, N, K in (("prefill q", m_pf, H // n, H), ("prefill k / v", m_pf, kvd // n, H),
                           ("prefill gate / up", m_pf, I // n, H), ("prefill wo (fan-in slice)", m_pf, H, H // n),
                           ("prefill down (fan-in slice)", m_pf, H, I // n),
                           ("decode lm_head (vocab slice)", SERVE_ROWS, -(-V // n), H)):
        xq8, q8 = i8(M, K), i8(N, K)
        as8 = torch.rand(M, generator=torch.Generator(device=dev).manual_seed(M + N), device=dev) * 0.05 + 1e-3
        s8 = scales(N, K)
        out.append(((
            "w8a8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:36 (XLA)",
            {"projection": f"parallel: tp={n} {label}", "M": M, "N": N, "K": K},
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm(a, s, q, w),
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm_plain(a, s, q, w), (20, 2, "events"),
            bound(2 * M * N * K, nbytes(xq8, q8, as8, s8) + 2 * M * N, PEAK_INT8_OPS),
            int_mm_library(torch, xq8, q8),
        ), None))
    M, N, K = SERVE_ROWS, H, I // n
    x9, q9, s9 = rn(M, K), i8(N, K), scales(N, K)
    w9 = dequantize(q9, s9)
    out.append(((
        "w8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:123 (XLA)",
        {"projection": f"parallel: tp={n} decode down (fan-in slice)", "M": M, "N": N, "K": K,
         "f32_addend": False, "form": "decode" if K789.w8_gemm_form(M) == K789.FORM_DECODE else "large"},
        lambda: K789.w8_gemm(x9, q9, s9), lambda: K789.w8_gemm_plain(x9, q9, s9), (100, 10, "graph"),
        bound(2 * M * N * K, nbytes(x9, q9, s9) + 2 * M * N),
        ("F.linear on the weight dequantized to bf16 beforehand", lambda: F.linear(x9, w9)),
    ), None))
    return out


def phase_kernels(torch):
    import numpy as np
    import torch.nn.functional as F

    from spatialrgpt_tpu_torch import preset

    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound
    from spatialrgpt_tpu_torch.ops.quant import dequantize, quantize_kv, quantize_kv4

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def causal_segment_mask(seg):
        """(B, 1, S, S) additive bf16 mask of K2's and K4's function."""
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        causal = torch.ones(seg.shape[1], seg.shape[1], dtype=torch.bool, device=dev).tril()
        live = (same & causal)[:, None]
        return torch.zeros(live.shape, dtype=torch.bfloat16, device=dev).masked_fill(~live, float("-inf"))

    # extra figures timed beside a case's kernel, by the case's index
    side_timings = {}
    # a case's per-sample library figure (K4's), by the case's index
    per_sample_case = {}
    # each case: name, source, replaces, shape, kernel, plain, iterations
    # timed (kernel, plain) and the timer of TIMERS (a graph where one call
    # is shorter than its launch on the host: K1-K3, K6), the work of
    # bound(), and the library call: (what it is, a function of no
    # arguments, or None and the reason)
    cases = []
    # K1: the SigLIP tower over [images; depths] of 8 rows
    B, S, H, D = 2 * N_ROWS, 729, 16, 72
    q, k, v = rn(B, S, H, D), rn(B, S, H, D), rn(B, S, H, D)
    lib_in, lib_call = sdpa_library(torch, "FLASH_ATTENTION", q, k, v)
    cases.append((
        "vit_attention", "spatialrgpt_tpu_torch/csrc/vit_attention.cu",
        "spatialrgpt_tpu/ops/vit_attention.py:196", {"B": B, "S": S, "H": H, "D": D},
        lambda: K1.vit_attention(q, k, v), lambda: K1.vit_attention_plain(q, k, v), (50, 5, "graph"),
        bound(4 * B * H * S * S * D, nbytes(q, k, v, q)),
        ("F.scaled_dot_product_attention, (B, H, S, D) copies, SDPBackend.FLASH_ATTENTION", lambda: lib_call(*lib_in)),
    ))
    # K1 at the towers path's shapes: CLIP ViT-L/14-336 over 16 images (D 64,
    # the narrow form) and InternViT-6B over 4 images at 448 px (S 1025, 25
    # heads of D 128: the wide form)
    k1_towers = []
    for B, S, H, D in ((TOWER_CLIP_IMAGES, 577, 16, 64), (TOWER_INTERN_IMAGES, 1025, 25, 128)):
        qt, kt, vt = rn(B, S, H, D), rn(B, S, H, D), rn(B, S, H, D)
        libt_in, libt_call = sdpa_library(torch, "FLASH_ATTENTION", qt, kt, vt)
        k1_towers.append(libt_in)
        cases.append((
            "vit_attention", "spatialrgpt_tpu_torch/csrc/vit_attention.cu",
            "spatialrgpt_tpu/ops/vit_attention.py:196", {"B": B, "S": S, "H": H, "D": D},
            lambda qt=qt, kt=kt, vt=vt: K1.vit_attention(qt, kt, vt),
            lambda qt=qt, kt=kt, vt=vt: K1.vit_attention_plain(qt, kt, vt), (50, 5, "graph"),
            bound(4 * B * H * S * S * D, nbytes(qt, kt, vt, qt)),
            ("F.scaled_dot_product_attention, (B, H, S, D) copies, SDPBackend.FLASH_ATTENTION",
             lambda libt_in=libt_in, libt_call=libt_call: libt_call(*libt_in)),
        ))
    # K2: llama3-8b prefill over the 320 bucket, right-padded rows; the
    # Hopper main loop at D 128 with G = 4 heads x 32 positions per CTA
    B, S, Hq, Hk, D = N_ROWS, PAD_BUCKET, 32, 8, 128
    q2, k2, v2 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, : S - 3 * b - 15] = 1
    lib2_in, lib2_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q2, k2, v2, causal_segment_mask(seg))
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228", {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D},
        lambda: K2.onepass_attention(q2, k2, v2, seg), lambda: K2.onepass_attention_plain(q2, k2, v2, seg),
        (50, 5, "graph"),
        bound(4 * D * Hq * live_pairs(torch, seg), live_bytes(seg, q2, k2, v2) + nbytes(seg, q2)),
        ("F.scaled_dot_product_attention, k/v expanded to Hq, (B, 1, S, S) causal x segment mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib2_call(*lib2_in)),
    ))
    # K2 at SpatialRGPT-Bench's prefill (srgpt_bench.sh: 32 rows in the 1024
    # bucket), each row one live segment of EVAL_K2_LIVE positions and the
    # rest padding: does K2 skip the padded tiles?
    B, S = EVAL_BATCH, EVAL_BUCKET
    qe, ke, ve = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    sege = torch.zeros(B, S, dtype=torch.int32, device=dev)
    live_e = np.random.default_rng(2).integers(*EVAL_K2_LIVE, B)
    for b in range(B):
        sege[b, : live_e[b]] = 1
    libe_in, libe_call = sdpa_library(torch, "EFFICIENT_ATTENTION", qe, ke, ve, causal_segment_mask(sege))
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228",
        {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "live_positions_min_max": [int(live_e.min()), int(live_e.max())],
         "padding_share": 1 - float(live_e.sum()) / (B * S)},
        lambda: K2.onepass_attention(qe, ke, ve, sege), lambda: K2.onepass_attention_plain(qe, ke, ve, sege),
        (20, 3, "events"),
        bound(4 * D * Hq * live_pairs(torch, sege), live_bytes(sege, qe, ke, ve) + nbytes(sege, qe)),
        ("F.scaled_dot_product_attention, k/v expanded to Hq, (B, 1, S, S) causal x segment mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: libe_call(*libe_in)),
    ))
    # K2's D = 256 form at Gemma-7B's prefill (the families path: B8 S320,
    # Hq = Hk = 16, G = 1), right-padded rows as the serve's
    B, S, Hq, Hk, D = N_ROWS, PAD_BUCKET, 16, 16, 256
    qg, kg, vg = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    libg_in, libg_call = sdpa_library(torch, "EFFICIENT_ATTENTION", qg, kg, vg, causal_segment_mask(seg))
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228",
        {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "path": "families: gemma-7b, the D = 256 form"},
        lambda: K2.onepass_attention(qg, kg, vg, seg), lambda: K2.onepass_attention_plain(qg, kg, vg, seg),
        (50, 5, "graph"),
        bound(4 * D * Hq * live_pairs(torch, seg), live_bytes(seg, qg, kg, vg) + nbytes(seg, qg)),
        ("F.scaled_dot_product_attention at D 256, (B, 1, S, S) causal x segment mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: libg_call(*libg_in)),
    ))
    # K2 with Mistral-7B's window of 4096 over one row of 4600 live
    # positions (the families path's long prompt): the window binds
    wl = preset("mistral-7b").llm.sliding_window
    B, S, Hq, Hk, D = 1, FAMILY_LONG_BUCKET, 32, 8, 128
    ql, kl, vl = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    segl = torch.zeros(B, S, dtype=torch.int32, device=dev)
    segl[:, :FAMILY_LONG_LIVE] = 1
    at = torch.arange(S, device=dev)
    in_window = (at[:, None] - at[None, :]) < wl
    maskl = causal_segment_mask(segl).masked_fill(~in_window, float("-inf"))
    libl_in, libl_call = sdpa_library(torch, "EFFICIENT_ATTENTION", ql, kl, vl, maskl)
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228",
        {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "window": wl, "live": FAMILY_LONG_LIVE,
         "path": "families: mistral-7b's long prompt"},
        lambda: K2.onepass_attention(ql, kl, vl, segl, window=wl),
        lambda: K2.onepass_attention_plain(ql, kl, vl, segl, window=wl), (20, 2, "events"),
        bound(4 * D * Hq * live_pairs(torch, segl, wl), live_bytes(segl, ql, kl, vl) + nbytes(segl, ql)),
        ("F.scaled_dot_product_attention, k/v expanded to Hq, (1, 1, S, S) causal x segment x window mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: libl_call(*libl_in)),
    ))
    # K3: one decode step against the int8 cache of 320 + 32 slots
    B, C, Hq, Hk, D = N_ROWS, PAD_BUCKET + MAX_NEW, 32, 8, 128
    q3 = rn(B, Hq, D)
    kq, ks = quantize_kv(rn(B, C, Hk, D))
    vq, vs = quantize_kv(rn(B, C, Hk, D))
    kq, vq = kq.reshape(B, C, Hk * D), vq.reshape(B, C, Hk * D)
    lengths = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 330], dtype=torch.int32, device=dev)
    live3 = int(torch.clamp(lengths + 1, max=C).sum())  # cache positions <= lengths[b]
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174", {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D},
        lambda Hk=Hk: K3.decode_attention_int8_flat(q3, kq, ks, vq, vs, lengths, Hk),
        lambda Hk=Hk: K3.decode_attention_int8_flat_plain(q3, kq, ks, vq, vs, lengths, Hk), (200, 20, "graph"),
        bound(4 * Hq * D * live3, nbytes(q3, lengths, q3) + live3 * Hk * (2 * D + 2 * 4)),
        ("no single call dequantises an int8 cache", None),
    ))
    # K3 at the W8A8 serve's 64 rows (320 + 32 slots), then its packed-int4
    # form at the same shape (generate(kv_bits=4)): half the payload bytes,
    # the same scales; the kernels line lists the int4 form under K3's
    # other_shapes, with its own launches ("counted_as")
    B, C, Hq, Hk, D = SERVE_ROWS, PAD_BUCKET + MAX_NEW, 32, 8, 128
    q64 = rn(B, Hq, D)
    k64, v64 = rn(B, C, Hk, D), rn(B, C, Hk, D)
    (kq64, ks64), (vq64, vs64) = quantize_kv(k64), quantize_kv(v64)
    (kq4, ks4), (vq4, vs4) = quantize_kv4(k64), quantize_kv4(v64)
    kq64, vq64, kq4, vq4 = (t.reshape(B, C, -1) for t in (kq64, vq64, kq4, vq4))
    lengths64 = torch.as_tensor(np.random.default_rng(4).integers(PAD_BUCKET - 250, C, B), dtype=torch.int32,
                                device=dev)
    lengths64[:2] = torch.tensor([0, C - 1], dtype=torch.int32)
    live64 = int(torch.clamp(lengths64 + 1, max=C).sum())
    del k64, v64
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174",
        {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D, "path": "serve_w8a8: the int8 cache at 64 rows"},
        lambda Hk=Hk: K3.decode_attention_int8_flat(q64, kq64, ks64, vq64, vs64, lengths64, Hk),
        lambda Hk=Hk: K3.decode_attention_int8_flat_plain(q64, kq64, ks64, vq64, vs64, lengths64, Hk),
        (200, 20, "graph"),
        bound(4 * Hq * D * live64, nbytes(q64, lengths64, q64) + live64 * Hk * (2 * D + 2 * 4)),
        ("no single call dequantises an int8 cache", None),
    ))
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/serving/generate.py:341 (generate(kv_bits=4)'s decode, XLA; the form of K3 for "
        "spatialrgpt_tpu/ops/decode_attention.py:174's function over quantize_kv4's cache)",
        {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D, "form": "int4", "counted_as": "decode_attention_int4_flat",
         "path": "serve_w8a8: generate(kv_bits=4)"},
        lambda Hk=Hk: K3.decode_attention_int4_flat(q64, kq4, ks4, vq4, vs4, lengths64, Hk),
        lambda Hk=Hk: K3.decode_attention_int4_flat_plain(q64, kq4, ks4, vq4, vs4, lengths64, Hk),
        (200, 20, "graph"),
        bound(4 * Hq * D * live64, nbytes(q64, lengths64, q64) + live64 * Hk * (D + 2 * 4)),
        ("no single call dequantises a packed int4 cache", None),
    ))
    # K3 at Gemma-7B's decode (the families path): n_rep 1, D 256, the cache
    # of 320 + 64 slots
    B, C, Hq, Hk, D = N_ROWS, PAD_BUCKET + FAMILY_MAX_NEW, 16, 16, 256
    q3g = rn(B, Hq, D)
    kqg, ksg = quantize_kv(rn(B, C, Hk, D))
    vqg, vsg = quantize_kv(rn(B, C, Hk, D))
    kqg, vqg = kqg.reshape(B, C, Hk * D), vqg.reshape(B, C, Hk * D)
    lengths_g = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 383], dtype=torch.int32, device=dev)
    live3g = int(torch.clamp(lengths_g + 1, max=C).sum())
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174",
        {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D, "path": "families: gemma-7b"},
        lambda Hk=Hk: K3.decode_attention_int8_flat(q3g, kqg, ksg, vqg, vsg, lengths_g, Hk),
        lambda Hk=Hk: K3.decode_attention_int8_flat_plain(q3g, kqg, ksg, vqg, vsg, lengths_g, Hk), (200, 20, "graph"),
        bound(4 * Hq * D * live3g, nbytes(q3g, lengths_g, q3g) + live3g * Hk * (2 * D + 2 * 4)),
        ("no single call dequantises an int8 cache", None),
    ))
    # K4: the align step's attention, segment ids of bench_train.py's packing
    B, S, Hq, Hk, D = TRAIN_ROWS, TRAIN_SEQ, 32, 8, 128
    seg4 = torch.as_tensor(train_spliced(llama3_8b_cfg(), np.random.default_rng(0), B).segment_ids, device=dev)
    L4 = per_sample_length(seg4, TRAIN_SAMPLES_PER_ROW)
    q4, k4, v4, do4 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D), rn(B, S, Hq, D)
    out4, lse4 = K4.flash_attention_fwd(q4, k4, v4, seg4)
    delta4 = K4.attention_delta(out4, do4)
    bwd = (q4, k4, v4, seg4, lse4, delta4, do4)
    bwd_per_position = (q4, k4, v4, lse4, delta4, do4)
    shape4 = {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
              "padded_tail": int((seg4 == 0).sum(dim=1).min())}
    src4, fa = "spatialrgpt_tpu_torch/csrc/flash_attention_sm90.cu", "spatialrgpt_tpu/ops/flash_attention.py"
    pairs4 = live_pairs(torch, seg4)
    lib4 = sdpa_yardsticks(torch, q4, k4, v4, do4, TRAIN_SAMPLES_PER_ROW, L4, causal_segment_mask(seg4))
    cases += [
        ("flash_attention_fwd", src4, f"{fa}:226", shape4,
         lambda: K4.flash_attention_fwd(q4, k4, v4, seg4),
         lambda: per_row(torch, K4.flash_attention_fwd_plain, q4, k4, v4, seg4), (10, 1, "events"),
         bound(4 * D * Hq * pairs4, live_bytes(seg4, q4, k4, v4) + nbytes(seg4, q4, lse4)), lib4["fwd"]),
        ("flash_attention_bwd_dkv", src4, f"{fa}:716", shape4,
         lambda: K4.flash_attention_bwd_dkv(*bwd),
         lambda: per_row(torch, K4.flash_attention_bwd_dkv_plain, *bwd), (10, 1, "events"),
         bound(8 * D * Hq * pairs4, live_bytes(seg4, *bwd_per_position) + nbytes(seg4, k4, v4)), lib4["bwd"]),
        ("flash_attention_bwd_dq", src4, f"{fa}:776", shape4,
         lambda: K4.flash_attention_bwd_dq(*bwd),
         lambda: per_row(torch, K4.flash_attention_bwd_dq_plain, *bwd), (10, 1, "events"),
         bound(6 * D * Hq * pairs4, live_bytes(seg4, *bwd_per_position) + nbytes(seg4, q4)), lib4["bwd"]),
    ]
    for i_case in range(len(cases) - 3, len(cases)):
        per_sample_case[i_case] = lib4["per_sample_fwd" if cases[i_case][0] == "flash_attention_fwd"
                                       else "per_sample_bwd"]
    # K4's D = 256 forms at Gemma-7B's align step (B4 S4096 Hq16 Hk16 D256,
    # the same packing); SDPA's yardsticks as at D 128 where they take D 256
    Hqg, Hkg, Dg = 16, 16, 256
    q4g, k4g, v4g, do4g = rn(B, S, Hqg, Dg), rn(B, S, Hkg, Dg), rn(B, S, Hkg, Dg), rn(B, S, Hqg, Dg)
    out4g, lse4g = K4.flash_attention_fwd(q4g, k4g, v4g, seg4)
    bwdg = (q4g, k4g, v4g, seg4, lse4g, K4.attention_delta(out4g, do4g), do4g)
    shape4g = {**shape4, "Hq": Hqg, "Hk": Hkg, "D": Dg, "path": "families_train: gemma-7b, the D = 256 forms"}
    lib4g = sdpa_yardsticks(torch, q4g, k4g, v4g, do4g, TRAIN_SAMPLES_PER_ROW, L4, causal_segment_mask(seg4))
    cases += [
        ("flash_attention_fwd", src4, f"{fa}:226", shape4g,
         lambda: K4.flash_attention_fwd(q4g, k4g, v4g, seg4),
         lambda: per_row(torch, K4.flash_attention_fwd_plain, q4g, k4g, v4g, seg4), (10, 1, "events"),
         bound(4 * Dg * Hqg * pairs4, live_bytes(seg4, q4g, k4g, v4g) + nbytes(seg4, q4g, lse4g)),
         lib4g["fwd"]),
        ("flash_attention_bwd_dkv", src4, f"{fa}:716", shape4g,
         lambda: K4.flash_attention_bwd_dkv(*bwdg),
         lambda: per_row(torch, K4.flash_attention_bwd_dkv_plain, *bwdg), (10, 1, "events"),
         bound(8 * Dg * Hqg * pairs4, live_bytes(seg4, *bwdg[:3], *bwdg[4:]) + nbytes(seg4, k4g, v4g)),
         lib4g["bwd"]),
        ("flash_attention_bwd_dq", src4, f"{fa}:776", shape4g,
         lambda: K4.flash_attention_bwd_dq(*bwdg),
         lambda: per_row(torch, K4.flash_attention_bwd_dq_plain, *bwdg), (10, 1, "events"),
         bound(6 * Dg * Hqg * pairs4, live_bytes(seg4, *bwdg[:3], *bwdg[4:]) + nbytes(seg4, q4g)),
         lib4g["bwd"]),
    ]
    for i_case in range(len(cases) - 3, len(cases)):
        per_sample_case[i_case] = lib4g["per_sample_fwd" if cases[i_case][0] == "flash_attention_fwd"
                                        else "per_sample_bwd"]
    # K5: SAM vit_h's global layers, a chunk of 4 images: q/k/v as views into
    # the fused qkv projection, f32 rel-pos bias terms of the 64 x 64 grid
    B, gh, gw, H, D = DEMO_SAM_CHUNK, 64, 64, 16, 80
    S = gh * gw
    q5, k5, v5 = rn(B, S, 3, H, D).unbind(2)
    rel_h = torch.randn(B, H, S, gh, generator=g, device=dev)
    rel_w = torch.randn(B, H, S, gw, generator=g, device=dev)
    bias5 = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, H, S, S).to(torch.bfloat16)  # 2.1 GB
    lib5_in, lib5_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q5, k5, v5, bias5)
    cases.append((
        "grid_bias_attention", "spatialrgpt_tpu_torch/csrc/grid_bias_attention.cu",
        "spatialrgpt_tpu/ops/flash_attention.py:397", {"B": B, "S": S, "grid": [gh, gw], "H": H, "D": D},
        lambda: K4.grid_bias_attention(q5, k5, v5, rel_h, rel_w, gw),
        lambda: per_row(torch, lambda *a: K4.grid_bias_attention_plain(*a, gw), q5, k5, v5, rel_h, rel_w),
        (20, 2, "events"),
        bound(4 * B * H * S * S * D, nbytes(q5, k5, v5, rel_h, rel_w, q5)),
        ("F.scaled_dot_product_attention, (B, H, S, S) bf16 bias materialised from rel_h / rel_w, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib5_call(*lib5_in)),
    ))
    # K5 at the synth path's shape: the segmenter runs one image a call (B1)
    q5s, k5s, v5s = rn(1, S, 3, H, D).unbind(2)
    rel_hs = torch.randn(1, H, S, gh, generator=g, device=dev)
    rel_ws = torch.randn(1, H, S, gw, generator=g, device=dev)
    bias5s = (rel_hs[..., :, None] + rel_ws[..., None, :]).reshape(1, H, S, S).to(torch.bfloat16)
    lib5s_in, lib5s_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q5s, k5s, v5s, bias5s)
    cases.append((
        "grid_bias_attention", "spatialrgpt_tpu_torch/csrc/grid_bias_attention.cu",
        "spatialrgpt_tpu/ops/flash_attention.py:397", {"B": 1, "S": S, "grid": [gh, gw], "H": H, "D": D,
                                                       "path": "synth: one image a segmenter call"},
        lambda: K4.grid_bias_attention(q5s, k5s, v5s, rel_hs, rel_ws, gw),
        lambda: K4.grid_bias_attention_plain(q5s, k5s, v5s, rel_hs, rel_ws, gw), (40, 4, "events"),
        bound(4 * H * S * S * D, nbytes(q5s, k5s, v5s, rel_hs, rel_ws, q5s)),
        ("F.scaled_dot_product_attention, (1, H, S, S) bf16 bias materialised from rel_h / rel_w, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib5s_call(*lib5s_in)),
    ))
    # K6: SAM vit_h's encoder rows (a chunk of 4 images x 4096 tokens, C 1280),
    # Depth-Anything ViT-L's (8 images x 1814 tokens, C 1024) and the synth
    # path's RAM tagging head (4585 tag queries, C 768, eps 1e-12), bf16
    # weights as the models hold them (the streaming kernel takes them as
    # they are: one launch per call)
    for rows6, C, eps, path in ((DEMO_SAM_CHUNK * 4096, 1280, 1e-6, None), (DEMO_IMAGES * 1814, 1024, 1e-6, None),
                                (4585, 768, 1e-12, "synth: RAM's tagging head")):
        x6 = (torch.randn(rows6, C, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
        w6, b6 = rn(C), rn(C)
        cases.append((
            "fused_layer_norm", "spatialrgpt_tpu_torch/csrc/layer_norm.cu", "spatialrgpt_tpu/ops/layer_norm.py:36",
            {"rows": rows6, "C": C, "eps": eps, **({"path": path} if path else {})},
            lambda x=x6, w=w6, b=b6, e=eps: K6.fused_layer_norm(x, w, b, e),
            lambda x=x6, w=w6, b=b6, e=eps: K6.fused_layer_norm_plain(x, w, b, e), (200, 20, "graph"),
            bound(8 * rows6 * C, nbytes(x6, w6, b6, x6)),
            ("F.layer_norm", lambda x=x6, w=w6, b=b6, C=C, e=eps: F.layer_norm(x, (C,), w, b, e)),
        ))
    # K7-K9: the quantized projections of bench.py's default serve (W8A8,
    # SERVE_ROWS rows): K7 over the prefill rows, K8 at the prefill's gate
    # projection and the decode's lm_head, K9 at the decode's contracting
    # down and k/v projections
    lcfg = llama3_8b_cfg()
    Hd, Id, Vd = lcfg.llm.hidden_size, lcfg.llm.intermediate_size, lcfg.llm.vocab_size + lcfg.num_extra_tokens
    kvd = lcfg.llm.num_key_value_heads * lcfg.llm.head_dim
    m_pf = SERVE_ROWS * PAD_BUCKET

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(n, k):  # fast_init_quantized's weight scale
        return torch.full((n,), k**-0.5 * 3.0 / 127.0, device=dev)

    vcfg = lcfg.vision
    m_tower = SERVE_ROWS * 2 * (vcfg.image_size // vcfg.patch_size) ** 2  # RGB + depth images of 729 patches
    # K7 over the prefill's rows (its q / wo / gate / up input, then down's),
    # a decode step's rows (the W8A8 serve's, the engine's slots: the
    # decode's K7 launches), and the tower's (SigLIP at SERVE_ROWS requests)
    for label, M, K, timing in (("prefill q / wo / gate / up", m_pf, Hd, (50, 5, "graph")),
                                ("decode q / wo / gate / up, lm_head", SERVE_ROWS, Hd, (200, 20, "graph")),
                                ("engine slots' decode", ENGINE_SLOTS, Hd, (200, 20, "graph")),
                                ("prefill down", m_pf, Id, (20, 2, "events")),
                                ("siglip q / o / fc1", m_tower, vcfg.hidden_size, (20, 2, "events")),
                                ("siglip fc2", m_tower, vcfg.intermediate_size, (10, 1, "events"))):
        x7 = rn(M, K)
        side_timings[len(cases)] = aq_side_timings(torch, K789, x7, empty_kernel=M < 2048)
        cases.append((
            "act_quant_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:30 (XLA)",
            aq_shape(K789, M, K, projection=label), lambda x=x7: K789.act_quant_int8(x),
            lambda x=x7: K789.act_quant_int8_plain(x), timing, aq_bound(M, K),
            ("no single call quantizes rows to int8 with a scale per row", None),
        ))
    gemma, mixtral = preset("gemma-7b").llm, preset("mixtral-8x7b").llm
    m_fam = N_ROWS * PAD_BUCKET  # the families path's prefill rows
    for label, M, N, K, (iters, plain_iters, how) in (("prefill gate", m_pf, Id, Hd, (20, 2, "events")),
                                                     ("decode lm_head", SERVE_ROWS, Vd, Hd, (20, 2, "graph")),
                                                     ("decode gate", SERVE_ROWS, Id, Hd, (100, 10, "graph")),
                                                     ("siglip fc1", m_tower, vcfg.intermediate_size,
                                                      vcfg.hidden_size, (20, 2, "events")),
                                                     ("families: mixtral-8x7b prefill router", m_fam,
                                                      mixtral.num_experts, mixtral.hidden_size, (50, 5, "graph")),
                                                     ("families: gemma-7b prefill gate", m_fam,
                                                      gemma.intermediate_size, gemma.hidden_size, (20, 2, "events"))):
        xq8, q8 = i8(M, K), i8(N, K)
        as8 = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
        s8 = scales(N, K)
        cases.append((
            "w8a8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:36 (XLA)",
            {"projection": label, "M": M, "N": N, "K": K},
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm(a, s, q, w),
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm_plain(a, s, q, w), (iters, plain_iters, how),
            bound(2 * M * N * K, nbytes(xq8, q8, as8, s8) + 2 * M * N, PEAK_INT8_OPS),
            int_mm_library(torch, xq8, q8),
        ))
    # K9 also on its large form: the QLoRA step's projections over 4 x 4096
    # rows (with the f32 addend that the LoRA side branch hands the epilogue
    # of each of them), a chunk of its lm_head's rows, and an engine
    # admission's down projection (4 x 384 rows)
    m_train = TRAIN_ROWS * TRAIN_SEQ
    for label, M, N, K, timing in (("decode down", SERVE_ROWS, Hd, Id, (100, 10, "graph")),
                                   ("decode k / v", SERVE_ROWS, kvd, Hd, (100, 10, "graph")),
                                   ("qlora train gate + LoRA addend", m_train, Id, Hd, (5, 1, "events")),
                                   ("qlora train down + LoRA addend", m_train, Hd, Id, (5, 1, "events")),
                                   ("qlora train k / v + LoRA addend", m_train, kvd, Hd, (20, 2, "events")),
                                   ("qlora lm_head chunk", 4 * 1024, Vd, Hd, (5, 1, "events")),
                                   ("engine admission down", 4 * 384, Hd, Id, (20, 2, "events")),
                                   ("families: mixtral-8x7b decode router", N_ROWS, mixtral.num_experts,
                                    mixtral.hidden_size, (200, 20, "graph")),
                                   ("families: gemma-7b decode down", N_ROWS, gemma.hidden_size,
                                    gemma.intermediate_size, (100, 10, "graph"))):
        x9, q9, s9 = rn(M, K), i8(N, K), scales(N, K)
        add9 = torch.randn(M, N, generator=g, device=dev) * 0.25 if "LoRA addend" in label else None
        w9 = dequantize(q9, s9)  # bf16, made here for the library yardstick only
        form9 = "decode" if K789.w8_gemm_form(M) == K789.FORM_DECODE else "large"
        cases.append((
            "w8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:123 (XLA)",
            {"projection": label, "M": M, "N": N, "K": K, "f32_addend": add9 is not None, "form": form9},
            lambda x=x9, q=q9, s=s9, a=add9: K789.w8_gemm(x, q, s, add=a),
            lambda x=x9, q=q9, s=s9, a=add9: K789.w8_gemm_plain(x, q, s, add=a),
            timing, bound(2 * M * N * K, nbytes(x9, q9, s9) + 2 * M * N + (0 if add9 is None else nbytes(add9))),
            ("F.linear on the weight dequantized to bf16 beforehand" + ("" if add9 is None else ", without the addend"),
             lambda x=x9, w=w9: F.linear(x, w)),
        ))
    # K10-K11: the int8 backward of the W8A8 align step (bench_train.py's
    # SRGPT_TRAIN_BENCH_QUANT=2) over its 4 x 4096 rows: K10 over the gate /
    # up output gradient (the widest), K11 for gate / up (14,336 -> 4096) and
    # for down (4096 -> 14,336)
    # K10 over the gate / up output gradient (N 14,336), then q / wo / down's
    # (N 4096), and Mixtral's router's (N 8) over the same rows
    mix = preset("mixtral-8x7b").llm
    for label, N, K, timing in (("gate / up dy", Id, Hd, (20, 2, "events")),
                                ("q / wo / down dy", Hd, Id, (20, 2, "events")),
                                ("families_train: mixtral-8x7b's router dy", mix.num_experts, mix.hidden_size,
                                 (50, 5, "graph"))):
        dy10 = (torch.randn(m_train, N, generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        s10 = scales(N, K)
        side_timings[len(cases)] = aq_side_timings(torch, K789, dy10, s10)
        cases.append((
            "act_quant_dy_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:70 (XLA)",
            aq_shape(K789, m_train, N, True, projection=label), lambda d=dy10, s=s10: K789.act_quant_dy_int8(d, s),
            lambda d=dy10, s=s10: K789.act_quant_dy_int8_plain(d, s), timing, aq_bound(m_train, N, dy=True),
            ("no single call quantizes rows to int8 with a scale per row", None),
        ))
    for label, N, K in (("gate / up dx", Id, Hd), ("down dx", Hd, Id),
                        ("families_train: mixtral-8x7b router dx (contracts over its 8 rows)", mix.num_experts,
                         mix.hidden_size)):
        dyq11, q11 = i8(m_train, N), i8(N, K)
        gs11 = torch.rand(m_train, generator=g, device=dev) * 1e-4 + 1e-6
        # K11 is two launches: its row times both; its first alone beside them
        side_timings[len(cases)] = {"transpose_ms": lambda q=q11: K789.int8_transpose(q)}
        cases.append((
            "int8_dx_gemm", "spatialrgpt_tpu_torch/csrc/int8_dx_gemm.cu", "spatialrgpt_tpu/ops/layers.py:74 (XLA)",
            {"projection": label, "M": m_train, "N": N, "K": K},
            lambda a=dyq11, q=q11, s=gs11: K789.int8_dx_gemm(a, q, s),
            lambda a=dyq11, q=q11, s=gs11: per_rows(torch, K789.int8_dx_gemm_plain, a, q, s), (5, 1, "events"),
            bound(2 * m_train * N * K, nbytes(dyq11, q11, gs11) + 2 * m_train * K, PEAK_INT8_OPS),
            dx_int_mm_library(torch, dyq11, q11),
        ))

    for case, per_sample, *side in parallel_kernel_cases(torch, rn, i8, scales, causal_segment_mask):
        if per_sample is not None:
            per_sample_case[len(cases)] = per_sample
        if side:
            side_timings[len(cases)] = side[0]
        cases.append(case)

    rows, shapes = [], []
    for i_case, (name, source, replaces, shape, kernel, plain, (iters, plain_iters, how), work,
                 (library, lib_fn)) in enumerate(cases):
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        bit_equal = all(o.dtype == r.dtype and torch.equal(o, r) for o, r in zip(outs, refs))
        if name == "flash_attention_fwd":  # lse: f32, compared where a key is live
            live = refs[1] > K4.NEG_INF / 2
            lse_err = float((outs[1] - refs[1])[live].abs().max())
            check(torch.equal(live, outs[1] > K4.NEG_INF / 2) and lse_err < 1e-3, f"{name}: lse off by {lse_err}")
            outs, refs = outs[:1], refs[:1]
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
        floor = GRAD_FLOOR if "_bwd_" in name else 0.0
        ratio = max(bf16_err_over_bound(o, r, floor) for o, r in zip(outs, refs))
        del out, ref, outs, refs
        timer, timing = TIMERS[how]
        library_each_ms = None
        plain_ms = timer(torch, plain, plain_iters)
        ms = timer(torch, kernel, iters)
        if isinstance(lib_fn, Backward):  # K4's dK/dV and dQ share one figure
            library_ms = lib_fn.ms(timer, iters)
        elif isinstance(lib_fn, dict):  # one call in several layouts: the fastest is the yardstick
            library_each_ms = {layout: timer(torch, fn, iters) for layout, fn in lib_fn.items()}
            library_ms = min(library_each_ms.values())
        else:
            library_ms = timer(torch, lib_fn, iters) if lib_fn is not None else None
        ps_label, ps_fn = per_sample_case.get(i_case, (None, None))
        if isinstance(ps_fn, Backward):
            ps_ms = ps_fn.ms(timer, iters)
        else:
            ps_ms = timer(torch, ps_fn, iters) if ps_fn is not None else None
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "err_over_bound": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"], "library_ms": library_ms, "library": library,
            "library_each_layout_ms": library_each_ms,
            "share_of_bound": work["bound_ms"] / ms,
            "library_over_kernel": library_ms / ms if library_ms is not None else None,
            "library_per_sample_ms": ps_ms, "library_per_sample": ps_label,
            "per_sample_library_over_kernel": ps_ms / ms if ps_ms is not None else None,
            "flops": work["flops"], "bytes": work["bytes"],
            "timing": timing.format(n=iters) + f" ({plain_iters} calls for the plain version)",
        }
        for key, fn in side_timings.get(i_case, {}).items():
            row[key] = timer(torch, fn, iters)
        ok = bit_equal if name in BIT_EQUAL else ratio <= 1.0
        row["bit_equal_to_plain"] = bit_equal
        emit({"phase": "kernel", "ok": ok, "shape": shape, **row})
        check(ok, f"{name}: error {ratio} x the per-element bound (max abs err {err}, bit-equal {bit_equal})")
        rows.append(row)
        shapes.append(shape)
    del bias5, bias5s, lib_in, k1_towers, lib2_in, libe_in, libg_in, libl_in, maskl, lib4, lib5_in, lib5s_in, lib4g, cases
    torch.cuda.empty_cache()
    # one row per kernel in the kernels line, at its first shape (K2 the
    # serve's prefill, K5 the demo's B4 chunk, K6 SAM's rows); a kernel's
    # later shapes go under that row's ``other_shapes``
    first = {}
    for row, shape in zip(rows, shapes):
        if row["name"] not in first:
            first[row["name"]] = dict(row, other_shapes=[])
        else:
            first[row["name"]]["other_shapes"].append({"shape": shape, **{k: row[k] for k in (
                "route", "source", "replaces", "ms", "plain_ms", "library_ms", "library", "library_per_sample_ms",
                "bound_ms", "bound_by", "max_abs_err", "err_over_bound", "share_of_bound")}})
    return list(first.values())


def phase_grads(torch):
    """K1 and K2 carry gradients on the CUDA route: dq, dk, dv through the
    kernel wrapper against autograd through the plain version."""
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    seg = torch.ones(N_ROWS, PAD_BUCKET, dtype=torch.int32, device=dev)
    seg[:, PAD_BUCKET - 15 :] = 0
    cases = [
        ("vit_attention", K1.vit_attention, K1.vit_attention_plain, (2 * N_ROWS, 729, 16, 72), (2 * N_ROWS, 729, 16, 72), ()),
        ("onepass_attention", K2.onepass_attention, K2.onepass_attention_plain,
         (N_ROWS, PAD_BUCKET, 32, 128), (N_ROWS, PAD_BUCKET, 8, 128), (seg,)),
    ]
    for name, kernel, plain, qshape, kshape, extra in cases:
        q, k, v, dout = rn(*qshape), rn(*kshape), rn(*kshape), rn(*qshape)
        grads = []
        for fn in (kernel, plain):
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fn(*ins, *extra).backward(dout)
            grads.append([t.grad for t in ins])
        present = all(t is not None for t in grads[0])
        ratio = max(bf16_err_over_bound(a, b, GRAD_FLOOR) for a, b in zip(*grads)) if present else float("inf")
        emit({"phase": "grad", "ok": present and ratio <= 1.0, "name": name, "grads_present": present,
              "err_over_bound": ratio, "shape_q": list(qshape)})
        check(present and ratio <= 1.0, f"{name}: gradients missing or off ({ratio} x the bound)")


def draw_rows(cfg, rng, n_rows: int, text_tokens: int = PROMPT_TEXT_TOKENS):
    """bench.py::build_batch's draws: ``n_rows`` prompts of bos + 8 text
    tokens + the image + 2 x (<mask>, <depth>) + the 96-token question (or
    ``text_tokens``), then random pixels, depths and region masks at the
    tower resolution."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX

    rows = []
    for _ in range(n_rows):
        ids = (
            [1] + list(rng.integers(10, 1000, 8)) + [IMAGE_TOKEN_INDEX]
            + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
            + list(rng.integers(10, 1000, text_tokens))
        )
        rows.append(np.asarray(ids, np.int64))
    size = cfg.vision.image_size
    pixels = (
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        (rng.random((n_rows, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((n_rows, N_REGIONS), bool),
    )
    return rows, pixels


def splice(torch, cfg, rows, pixels, bucket: int = PAD_BUCKET, host_index_fields: bool = False):
    """Prompts spliced and padded to ``bucket`` with their pixels on the
    card in bf16: (VLMInputs, prompt lengths).  With ``host_index_fields``
    the token and index fields stay numpy arrays on the host, as a queued
    engine request holds them (bench_engine.py::make_request)."""
    from spatialrgpt_tpu_torch import NUM_TOKENS_PER_IMAGE, expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    sb = expand_rows(
        rows, None, max_len=cfg.model_max_length, tokens_per_image=NUM_TOKENS_PER_IMAGE,
        mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id,
        regions_per_image=N_REGIONS, pad_to=bucket,
    )
    inputs = VLMInputs.from_spliced(sb, *pixels, device=DEVICE, dtype=torch.bfloat16)
    if host_index_fields:
        inputs = inputs._replace(**{f: getattr(sb, f) for f in sb.__dataclass_fields__ if f != "labels"},
                                 labels=None, mask_valid=pixels[3])
    return inputs, torch.as_tensor(sb.segment_ids.sum(axis=1), device=DEVICE)


def build_batch(torch, cfg, rng, n_rows: int = N_ROWS):
    """bench.py::build_batch for the port: ``draw_rows`` padded to the 320
    bucket, pixels on the card."""
    return splice(torch, cfg, *draw_rows(cfg, rng, n_rows))


def reset_counts():
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1

    for m in (K1, K2, K3, K6):
        m.launches = 0
    K3.launches_int4 = 0
    for counts in (K4.launches, K789.launches):
        for name in counts:
            counts[name] = 0
    K4.grid_bias_launches = 0


def read_counts() -> dict:
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1

    return {"vit_attention": K1.launches, "onepass_attention": K2.launches,
            "decode_attention_int8_flat": K3.launches, "decode_attention_int4_flat": K3.launches_int4, **K4.launches,
            "grid_bias_attention": K4.grid_bias_launches, "fused_layer_norm": K6.launches, **K789.launches}


# no projection is quantized: K7-K11 launch no time
NO_QUANT = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0, "act_quant_dy_int8": 0, "int8_dx_gemm": 0}


def add_counts(*parts) -> dict:
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def times(n: int, part: dict) -> dict:
    return {k: n * v for k, v in part.items()}


def quant_expected_counts(cfg, rows: int, bucket: int, max_new: int, fused: bool = False) -> dict:
    """K7-K9 launches of one W8A8 ``generate`` (llm and vision tower
    quantized; ``fused``: by ``fuse_serving_kernels``): the prefill of
    ``rows`` rows, then ``max_new - 1`` decode steps of ``rows`` rows
    (``quant_phase_counts``)."""
    prefill, step = quant_phase_counts(cfg, rows, bucket, rows, fused)
    return add_counts(prefill, times(max_new - 1, step))


def quant_group(m: int, *shapes) -> dict:
    """K7-K11 launches of the forward of sibling projections of (din, dout)
    ``shapes`` that read one x of ``m`` rows, by the reference's
    per-call-site rule (spatialrgpt_tpu/ops/layers.py:114-120): a weight
    takes int8 activations when it expands (in <= out) or at 2048 rows and
    more, else the int8 weight-only product (K9); the siblings that take
    W8A8 quantize x once (K7)."""
    a8 = [din <= dout or m >= 2048 for din, dout in shapes]
    return {**NO_QUANT, "act_quant_int8": int(any(a8)), "w8a8_gemm": sum(a8), "w8_gemm": len(a8) - sum(a8)}


def tower_layer_counts(cfg, m: int, fused: bool = False) -> dict:
    """A SigLIP layer's K7-K11 launches at ``m`` rows; ``fused``: q/k/v as
    one (C, 3C) projection (``fuse_serving_kernels``)."""
    C, Iv = cfg.vision.hidden_size, cfg.vision.intermediate_size
    qkv = quant_group(m, (C, 3 * C)) if fused else quant_group(m, (C, C), (C, C), (C, C))
    return add_counts(qkv, quant_group(m, (C, C)), quant_group(m, (C, Iv)), quant_group(m, (Iv, C)))


def decoder_layer_counts(cfg, m: int, fused: bool = False) -> dict:
    """A decoder layer's K7-K11 launches at ``m`` rows: q/k/v, o, then the
    MLP's gate and up and its down, or a MoE layer's router with every
    expert's gate and up (all read one x: one K7) and each expert's down.
    ``fused`` (``fuse_serving_kernels``): q/k/v one expanding projection,
    gate / up one, each taking W8A8 at every row count."""
    lc = cfg.llm
    H, I = lc.hidden_size, lc.intermediate_size
    q_out, kv_out = lc.num_attention_heads * lc.head_dim, lc.num_key_value_heads * lc.head_dim
    qkv = quant_group(m, (H, q_out + 2 * kv_out)) if fused else quant_group(m, (H, q_out), (H, kv_out), (H, kv_out))
    attn = add_counts(qkv, quant_group(m, (q_out, H)))
    if lc.is_moe:
        E = lc.num_experts
        return add_counts(attn, quant_group(m, (H, E), *[(H, I)] * (2 * E)), times(E, quant_group(m, (I, H))))
    gate_up = quant_group(m, (H, 2 * I)) if fused else quant_group(m, (H, I), (H, I))
    return add_counts(attn, gate_up, quant_group(m, (I, H)))


def tower_layers(cfg) -> int:
    """The tower layers that run: up to the selected layer (-2: 26 of 27)."""
    return cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer


def lm_head_counts(cfg, m: int) -> dict:
    """The lm_head's K7-K11 launches at ``m`` rows (a tied head is the float
    embedding table: none)."""
    lc = cfg.llm
    if lc.tie_word_embeddings:
        return dict(NO_QUANT)
    return quant_group(m, (lc.hidden_size, lc.vocab_size + cfg.num_extra_tokens))


def tower_counts(cfg, requests: int, fused: bool = False) -> dict:
    """K7-K11 launches of the tower over ``requests`` requests' images and
    depths."""
    v = cfg.vision
    return times(tower_layers(cfg), tower_layer_counts(cfg, 2 * requests * (v.image_size // v.patch_size) ** 2, fused))


def quant_phase_counts(cfg, rows: int, bucket: int, decode_rows: int, fused: bool = False) -> tuple:
    """(K7-K11 launches of the prefill of ``rows`` rows of ``bucket``
    positions with their tower and lm_head, of one decode step of
    ``decode_rows`` rows), from the config (``quant_group``); ``fused``:
    after ``fuse_serving_kernels``."""
    L = cfg.llm.num_hidden_layers
    step = add_counts(times(L, decoder_layer_counts(cfg, decode_rows, fused)), lm_head_counts(cfg, decode_rows))
    prefill = add_counts(tower_counts(cfg, rows, fused), times(L, decoder_layer_counts(cfg, rows * bucket, fused)),
                         lm_head_counts(cfg, rows))  # the head at the last position of every row
    return prefill, step


def k7_launch_split(cfg, rows: int, bucket: int, max_new: int) -> dict:
    """K7's launches in one W8A8 ``generate`` (``quant_expected_counts``)
    by the rows each quantizes: the decode steps', the prefill's (its
    decoder layers, and its lm_head at the rows' last positions) and the
    tower's."""
    v = cfg.vision
    prefill, step = quant_phase_counts(cfg, rows, bucket, rows)
    tower = tower_counts(cfg, rows)["act_quant_int8"]
    return {f"decode: {rows} rows": (max_new - 1) * step["act_quant_int8"],
            f"prefill: {rows * bucket} rows (its lm_head: {rows})": prefill["act_quant_int8"] - tower,
            f"tower: {2 * rows * (v.image_size // v.patch_size) ** 2} rows": tower}


def recomputed_layer_counts(cfg, m: int) -> dict:
    """A decoder layer's K7-K9 launches in remat's recompute: PyTorch's
    non-reentrant checkpoint stops once the backward's saved tensors are
    made again (its early stop), and the layer's tail, the down projection
    (whose backward keeps no tensor) and the residual add, is not run.  A
    MoE layer runs whole: each expert's output is saved for its gate's
    gradient, and the aux loss at the layer's end saves its token shares."""
    lc = cfg.llm
    if lc.is_moe:
        return decoder_layer_counts(cfg, m)
    down = quant_group(m, (lc.intermediate_size, lc.hidden_size))
    return {k: v - down[k] for k, v in decoder_layer_counts(cfg, m).items()}


def align_quant_counts(cfg, rows: int, int8_backward: bool) -> dict:
    """K7-K11 launches of one W8A8 align step (decoder and tower W8A8) over
    ``rows`` packed rows of TRAIN_SEQ tokens, remat, CE chunks of CE_CHUNK
    positions: the tower forward once; every decoder layer forward and
    recomputed (``recomputed_layer_counts``); the lm_head forward twice per
    chunk (the chunk's checkpoint); with ``int8_backward`` one K10 and one
    K11 per W8A8 projection's dx (each decoder projection, the lm_head per
    chunk)."""
    v, lc = cfg.vision, cfg.llm
    tower_rows = 2 * rows * TRAIN_SAMPLES_PER_ROW * (v.image_size // v.patch_size) ** 2
    m, chunks = rows * TRAIN_SEQ, TRAIN_SEQ // CE_CHUNK
    layer = decoder_layer_counts(cfg, m)
    lm_head = quant_group(rows * CE_CHUNK, (lc.hidden_size, lc.vocab_size + cfg.num_extra_tokens))
    fwd = add_counts(times(tower_layers(cfg), tower_layer_counts(cfg, tower_rows)),
                     times(lc.num_hidden_layers, add_counts(layer, recomputed_layer_counts(cfg, m))),
                     times(2 * chunks, lm_head))
    dx = lc.num_hidden_layers * layer["w8a8_gemm"] + chunks * lm_head["w8a8_gemm"] if int8_backward else 0
    return {**fwd, "act_quant_dy_int8": dx, "int8_dx_gemm": dx}


def qlora_quant_counts(cfg, rows: int) -> dict:
    """K7-K11 launches of one QLoRA step (int8 weight-only decoder and
    lm_head, bf16 tower): K9 for every decoder projection in the forward
    and all but the down projection in remat's recompute
    (``recomputed_layer_counts``), the lm_head twice per CE chunk (a tied
    head is the float table: none); in a MoE layer the experts take the
    merged form (a bf16 product), so K9 runs q/k/v/o and the router, in the
    forward and in the whole layer's recompute.  The weight-only dx is a
    plain product."""
    lc = cfg.llm
    chunks = TRAIN_SEQ // CE_CHUNK
    per_layer = 5 + 5 if lc.is_moe else 7 + 6
    return {**NO_QUANT, "w8_gemm": lc.num_hidden_layers * per_layer + (0 if lc.tie_word_embeddings else 2 * chunks)}


@contextlib.contextmanager
def plain_projections():
    """The quantized branches of ``linear`` on K7-K9's plain versions (on
    the card too) inside the block: the projections' half of the plain
    route, whose attention half is ``attn_impl="xla"``."""
    from spatialrgpt_tpu_torch.ops import layers

    before = layers.QUANT_KERNELS
    layers.QUANT_KERNELS = False
    try:
        yield
    finally:
        layers.QUANT_KERNELS = before


@contextlib.contextmanager
def int4_decode_plain():
    """``generate``'s int4-cache decode on K3's int4 form's plain version
    (on the card too) inside the block; the rest of the route unchanged."""
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.serving import generate as gen

    gen.decode_attention_int4_flat = K3.decode_attention_int4_flat_plain
    try:
        yield
    finally:
        gen.decode_attention_int4_flat = K3.decode_attention_int4_flat


@contextlib.contextmanager
def w8a8_at_every_row_count():
    """Every W8A8 projection takes int8 activations whatever its rows
    (``layers.A8_MIN_ROWS`` 0) inside the block: the unfused and the fused
    model then run the same routes."""
    from spatialrgpt_tpu_torch.ops import layers

    before = layers.A8_MIN_ROWS
    layers.A8_MIN_ROWS = 0
    try:
        yield
    finally:
        layers.A8_MIN_ROWS = before


# the running sum of K9_PLAIN_VARIANTS["bf16_sums"] is rounded to bf16 after
# every this many columns of k
BF16_SUM_COLUMNS = 128


@contextlib.contextmanager
def k9_plain_variant(torch, variant: str):
    """K9's plain version replaced inside the block by one of:
    ``regrouped``, the same function with its f32 sums in another order
    (the two halves of k summed apart, then added), as K9's own order
    differs from its plain version's; and two wrong routes, the controls
    that the QLoRA comparison must reject: ``bf16_sums``, the running sum
    held in bf16 (rounded after every ``BF16_SUM_COLUMNS`` columns of k),
    and ``no_addend``, the LoRA side branch's addend dropped from the
    forward."""
    from spatialrgpt_tpu_torch.ops import int8_linear

    before = int8_linear.w8_gemm_plain

    def regrouped(x, q, scale, bias=None, add=None):
        h = x.shape[1] // 2
        y = torch.matmul(x[:, :h].float(), q[:, :h].float().T) + torch.matmul(x[:, h:].float(), q[:, h:].float().T)
        return int8_linear.finish(y * scale, add, bias, x.dtype)

    def bf16_sums(x, q, scale, bias=None, add=None):
        y = torch.zeros(x.shape[0], q.shape[0], dtype=torch.bfloat16, device=x.device)
        for k0 in range(0, x.shape[1], BF16_SUM_COLUMNS):
            k = slice(k0, k0 + BF16_SUM_COLUMNS)
            y = (y.float() + torch.matmul(x[:, k].float(), q[:, k].float().T)).to(torch.bfloat16)
        return int8_linear.finish(y.float() * scale, add, bias, x.dtype)

    def no_addend(x, q, scale, bias=None, add=None):
        return before(x, q, scale, bias)

    int8_linear.w8_gemm_plain = {"regrouped": regrouped, "bf16_sums": bf16_sums, "no_addend": no_addend}[variant]
    try:
        yield
    finally:
        int8_linear.w8_gemm_plain = before


@contextlib.contextmanager
def dx_by_depth(torch, got: dict, lm_head_int8=None):
    """Inside the block, the gradient that reaches the decoder's final
    hidden states (``got["lm_head"]``, the lm_head's dx, chunks in order)
    and each decoder layer's input (``got[i]`` for layer i: the dx after
    L - i layers) is kept in ``got``.  With ``lm_head_int8`` set, the
    lm_head's forward reads it as the int8-backward switch, so that its dx
    alone takes that route.  Both checkpoints (llama.py's per layer,
    vlm.py's per CE chunk) are wrapped: a hook on each one's input."""
    from spatialrgpt_tpu_torch.models import llama, vlm
    from spatialrgpt_tpu_torch.ops import layers

    real_layer, real_chunk = llama.checkpoint, vlm.checkpoint
    chunks, n_layers = [], [0]

    def layer_checkpoint(fn, x, *args, **kw):
        x.register_hook(lambda g, i=n_layers[0]: got.__setitem__(i, g))
        n_layers[0] += 1
        return real_layer(fn, x, *args, **kw)

    def chunk_checkpoint(fn, h, *args, **kw):
        chunks.append(None)
        h.register_hook(lambda g, i=len(chunks) - 1: chunks.__setitem__(i, g))
        before = layers.INT8_BACKWARD
        layers.INT8_BACKWARD = before if lm_head_int8 is None else lm_head_int8
        try:
            return real_chunk(fn, h, *args, **kw)
        finally:
            layers.INT8_BACKWARD = before

    llama.checkpoint, vlm.checkpoint = layer_checkpoint, chunk_checkpoint
    try:
        yield
    finally:
        llama.checkpoint, vlm.checkpoint = real_layer, real_chunk
        got["lm_head"] = torch.cat(chunks, dim=1) if chunks and all(c is not None for c in chunks) else None


def dx_depth_witness(torch, cfg, model, batch, params) -> dict:
    """Where the int8 dx leaves the bf16 STE's direction, on the same W8A8
    forward (one row): per depth, the cosine and the norm ratio of the
    gradient at the lm_head's input and at each decoder layer's input,
    int8 route against the STE's, for the int8 dx everywhere, in the
    decoder with the lm_head's dx on the STE, and in the lm_head alone;
    and the tuned gradients' cosine for each."""
    from spatialrgpt_tpu_torch.ops import layers

    L = cfg.llm.num_hidden_layers

    def run(int8: bool, lm_head_int8=None):
        got = {}
        layers.enable_int8_backward(int8)
        try:
            with dx_by_depth(torch, got, lm_head_int8):
                _, g = loss_and_grads(torch, cfg, model, batch, params)
        finally:
            layers.enable_int8_backward(False)
        check(len(got) == L + 1 and got["lm_head"] is not None, "dx_by_depth: a hook did not fire")
        return [got["lm_head"]] + [got[i] for i in reversed(range(L))], g

    ref, g_ref = run(False)
    out = {"depths": ["lm_head dx"] + [f"after {n} layers" for n in range(1, L + 1)]}
    for name, route in (("int8_dx_everywhere", (True, None)), ("int8_dx_decoder_lm_head_ste", (True, False)),
                        ("int8_dx_lm_head_only", (False, True))):
        got, g = run(*route)
        out[name] = {
            "cosine_by_depth": [cosine(a.flatten(), b.flatten()) for a, b in zip(got, ref)],
            "norm_ratio_by_depth": [float(a.float().norm() / b.float().norm()) for a, b in zip(got, ref)],
            "tuned_grads_cosine": cosine(g, g_ref),
        }
        del got, g
    return out


def serve_runner(torch, cfg, model, n_rows: int, text_tokens: int = PROMPT_TEXT_TOKENS, bucket: int = PAD_BUCKET):
    """``run(max_new, impl="onepass", model_cfg=cfg, kv_bits=8)``: region-QA ``generate``
    of ``model`` over ``n_rows`` rows of bench.py's batch (``text_tokens``
    of question, padded to ``bucket``), drawn from seed 0."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.generate import generate

    inputs, plens = splice(torch, cfg, *draw_rows(cfg, np.random.default_rng(0), n_rows, text_tokens), bucket)

    def run(max_new, impl="onepass", model_cfg=cfg, kv_bits=8):
        out = generate(model, model_cfg, inputs, plens, max_new_tokens=max_new, temperature=0.0,
                       eos_token_id=-1, attn_impl=impl, kv_quant=True, kv_bits=kv_bits)  # SRGPT_BENCH_KV_INT8=1
        torch.cuda.synchronize()
        return out

    return run


def serve_run(torch, cfg, model, n_rows: int, max_new: int = MAX_NEW, **batch):
    """Region-QA ``generate`` over ``n_rows`` rows of bench.py's batch: a
    warm-up, then the timed run of ``max_new`` greedy tokens with the launch
    counts read around it, then three TTFT runs.  Returns the timed run's
    result, its counts, the smoke figures and a function ``run(max_new,
    impl)`` that runs ``generate`` on the same batch (``serve_runner``'s,
    ``batch`` its batch arguments)."""
    run = serve_runner(torch, cfg, model, n_rows, **batch)
    run(2)  # warm-up: cuBLAS handles, allocator, every op of the path once

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run(max_new)
    e2e_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(1)
        ttfts.append(time.perf_counter() - t0)
    ttft_s = statistics.median(ttfts)
    figures = {"ttft_s": ttft_s, "e2e_s": e2e_s, "tok_s": n_rows * max_new / e2e_s,
               "decode_tok_s": n_rows * (max_new - 1) / (e2e_s - ttft_s), "peak_mem_gb": peak_gb}
    return res, counts, figures, run


def logits_vs(torch, res, ref, vocab: int, min_equal_rows: int = 0, max_new: int = MAX_NEW) -> tuple:
    """Checks and fields of a serve run against another route's run of the
    same batch and weights.  The last step's logits hold K3 and the per-row
    cache scatter, 31 decode steps on.  Greedy decoding amplifies bf16
    near-ties, so a row may pick another token somewhere and then sees
    other inputs; only rows whose 32 tokens are all equal saw the same
    inputs at every step, and at least ``min_equal_rows`` (default half the
    rows) must be such."""
    tokens, first = res.tokens, res.first_logits
    n_rows = tokens.shape[0]
    rel = rel_l2(first, ref.first_logits)
    same = (tokens == ref.tokens).all(dim=1)
    n_same = int(same.sum())
    rel_last = rel_l2(res.last_logits[same], ref.last_logits[same]) if n_same else float("inf")
    min_equal_rows = min_equal_rows or -(-n_rows // 2)
    checks = {
        "tokens_shape": list(tokens.shape) == [n_rows, max_new],
        "tokens_in_vocab": bool(((tokens >= 0) & (tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(first).all() and torch.isfinite(res.last_logits).all()),
        "first_logits_vs_plain": rel <= LOGITS_REL_BOUND,
        "last_logits_vs_plain": n_same >= min_equal_rows and rel_last <= LOGITS_REL_BOUND,
    }
    fields = {
        "first_logits_rel_l2_vs_plain": rel, "last_logits_rel_l2_vs_plain": rel_last,
        "rel_bound": LOGITS_REL_BOUND, "tokens_agreement_vs_plain": float((tokens == ref.tokens).float().mean()),
        "rows_with_all_tokens_equal": n_same, "rows_with_all_tokens_equal_needed": min_equal_rows,
        "last_logits_rel_l2_per_row": [rel_l2(res.last_logits[b], ref.last_logits[b]) for b in range(n_rows)],
    }
    return checks, fields


def phase_main(torch, nvidia_smi: str) -> dict:
    """bench.py's serve with SRGPT_BENCH_W8A8=0: bf16 weights, 8 rows;
    checked against the plain route (K1-K3's plain versions)."""
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    t0 = time.perf_counter()
    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    want = serve_counts(cfg, N_ROWS, PAD_BUCKET, MAX_NEW, quantized=False)
    res, counts, figures, run = serve_run(torch, cfg, model, N_ROWS)
    checks, fields = logits_vs(torch, res, run(MAX_NEW, "xla"), cfg.llm.vocab_size + cfg.num_extra_tokens)
    checks["launch_counts"] = counts == want
    emit({"phase": "main", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), bf16 weights",
          "rows": N_ROWS, "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW,
          "launches": counts, "launches_expected": want, **fields,
          "smoke_figures_not_a_benchmark": {**figures, "init_s": init_s, "card": nvidia_smi},
          "first_tokens_row0": res.tokens[0, :8].tolist()})
    check(all(checks.values()), f"main path checks failed: {checks}")
    return counts


def decode_kernel_ratio(torch, cfg, prompt_lengths) -> float:
    """K3 against its plain version at the shape of a serve run's last
    decode step: one row per prompt, PAD_BUCKET + MAX_NEW cache slots, row
    b's slots live up to prompt_lengths[b] + MAX_NEW - 2; random q and
    int8 cache.  Returns the ratio of ``bf16_err_over_bound`` (at most 1
    passes)."""
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound
    from spatialrgpt_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device=DEVICE).manual_seed(3)
    lc = cfg.llm
    B, C, D = prompt_lengths.shape[0], PAD_BUCKET + MAX_NEW, lc.head_dim
    Hq, Hk = lc.num_attention_heads, lc.num_key_value_heads
    q = torch.randn(B, Hq, D, generator=g, device=DEVICE).to(torch.bfloat16)
    kq, ks = quantize_kv(torch.randn(B, C, Hk, D, generator=g, device=DEVICE).to(torch.bfloat16))
    vq, vs = quantize_kv(torch.randn(B, C, Hk, D, generator=g, device=DEVICE).to(torch.bfloat16))
    args = (q, kq.reshape(B, C, Hk * D), ks, vq.reshape(B, C, Hk * D), vs,
            (prompt_lengths + MAX_NEW - 2).to(device=DEVICE, dtype=torch.int32), Hk)
    return bf16_err_over_bound(K3.decode_attention_int8_flat(*args), K3.decode_attention_int8_flat_plain(*args))


def phase_serve_w8a8(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench.py's default serve: W8A8 llm and vision tower made directly in
    the int8 layout (``init_random_quantized``, the twin of
    ``fast_init_quantized``), int8 KV cache, the 320 bucket, SERVE_ROWS
    rows, with K7-K9's launch counts.

    The plain route is checked in its two halves.  Per-token int8
    activations round to steps of max|x| / 127: where two routes' inputs
    differ by a bf16 rounding, some activations land a step apart, and
    through the 58 quantized layers of random weights the two runs come
    apart by the size of the quantization error itself.  So: (1) the
    projections: the same W8A8 run with K7-K9's plain versions (the same
    K1-K3) gives first-token logits bit-equal to the kernels' (K7 and K8
    are exact; K9 runs only in decode); (2) the attention kernels at this
    phase's shapes: phase main's check at SERVE_ROWS rows, bf16 weights of
    ``init_random`` (fast_init_quantized's uniform int8 weights are ~1.7x
    wider and, even dequantized to bf16, amplify a rounding further), with
    at least one row whose 32 tokens all agree (at 64 rows more rows meet a
    near-tie in 32 greedy steps: 27 of 64 agreed on the H100, where phase
    main's half of 8 rows holds), and K3 itself, against its plain version,
    at this phase's last decode step.  Reported without a bound: the W8A8 decode steps against (1), the W8A8
    run against the whole plain route, and the W8A8 first-token logits
    against its own weights dequantized to bf16 (the float branch of
    ``linear``), on K1-K3 and on their plain versions."""
    import numpy as np

    from spatialrgpt_tpu_torch.ops.layers import dequantize_model
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

    cfg = llama3_8b_cfg()
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    t0 = time.perf_counter()
    model = init_random_quantized(cfg, torch.device(DEVICE), w8a8=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    want = serve_counts(cfg, SERVE_ROWS, PAD_BUCKET, MAX_NEW, quantized=True)
    res, counts, figures, run = serve_run(torch, cfg, model, SERVE_ROWS)
    k7_by_rows = k7_launch_split(cfg, SERVE_ROWS, PAD_BUCKET, MAX_NEW)
    if profile_dir:
        profile_run(torch, lambda: run(1), profile_dir, "serve_w8a8_ttft")
        profile_run(torch, lambda: run(MAX_NEW), profile_dir, "serve_w8a8_generate")
    with plain_projections():
        proj_plain = run(MAX_NEW)
        all_plain = run(MAX_NEW, "xla")
    _, vs_proj_plain = logits_vs(torch, res, proj_plain, vocab)
    _, vs_all_plain = logits_vs(torch, res, all_plain, vocab)
    projections_bit_equal = torch.equal(res.first_logits, proj_plain.first_logits)
    del proj_plain, all_plain
    checks4, out4, counts4 = serve_int4_kv(torch, cfg, run, res)
    checks_f, out_f, counts_f = serve_fused_kernels(torch, cfg, model, run, res)
    dequantize_model(model)
    deq, deq_plain = run(1), run(1, "xla")
    del model, run
    torch.cuda.empty_cache()
    bf16_run = serve_runner(torch, cfg, init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0), SERVE_ROWS)
    attn_checks, vs_attn_plain = logits_vs(torch, bf16_run(MAX_NEW), bf16_run(MAX_NEW, "xla"), vocab, 1)
    # K3's int4 form against its plain version through generate, on the same bf16 weights
    res4 = bf16_run(MAX_NEW, kv_bits=4)
    with int4_decode_plain():
        res4_plain = bf16_run(MAX_NEW, kv_bits=4)
    int4_checks, vs_int4_plain = logits_vs(torch, res4, res4_plain, vocab, 1)
    checks4.update({f"bf16_weights_{k}": v for k, v in int4_checks.items()})
    out4["bf16_weights_int4_kernel_vs_plain"] = vs_int4_plain
    del bf16_run, res4, res4_plain
    torch.cuda.empty_cache()
    k3_ratio = decode_kernel_ratio(torch, cfg, build_batch(torch, cfg, np.random.default_rng(0), SERVE_ROWS)[1])
    checks = {
        "tokens_shape": list(res.tokens.shape) == [SERVE_ROWS, MAX_NEW],
        "tokens_in_vocab": bool(((res.tokens >= 0) & (res.tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(res.first_logits).all() and torch.isfinite(res.last_logits).all()),
        "launch_counts": counts == want,
        "k7_launch_split_sums_to_the_count": sum(k7_by_rows.values()) == counts["act_quant_int8"],
        "first_logits_bit_equal_to_plain_projections": projections_bit_equal,
        **{f"attention_bf16_{k}": v for k, v in attn_checks.items()},
        "decode_attention_kernel_at_serve_shape": k3_ratio <= 1.0,
        **{f"kv_bits_4_{k}": v for k, v in checks4.items()},
        **{f"fused_kernels_{k}": v for k, v in checks_f.items()},
    }
    emit({"phase": "serve_w8a8", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision "
                   "tower (int8 weights, int8 per-token activations), int8 KV, random from seed 0",
          "rows": SERVE_ROWS, "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW,
          "launches": counts, "launches_expected": want, "act_quant_int8_launches_by_rows": k7_by_rows,
          "w8a8_vs_plain_projections_same_attention": vs_proj_plain,
          "w8a8_vs_whole_plain_route": vs_all_plain,
          "attention_bf16_init_random_kernel_vs_plain": vs_attn_plain,
          "decode_attention_err_over_bound_at_serve_shape": k3_ratio,
          "first_logits_rel_l2_w8a8_vs_dequantized_bf16": rel_l2(res.first_logits, deq.first_logits),
          "first_logits_rel_l2_dequantized_bf16_kernel_vs_plain_attention": rel_l2(deq.first_logits,
                                                                                   deq_plain.first_logits),
          "kv_bits_4": out4, "fuse_serving_kernels": out_f,
          "smoke_figures_not_a_benchmark": {**figures, "init_s": init_s, "card": nvidia_smi},
          "first_tokens_row0": res.tokens[0, :8].tolist()})
    check(all(checks.values()), f"serve_w8a8 checks failed: {checks}")
    return add_counts(counts, counts4, counts_f)


def quant_cache_gb(cfg, rows: int, capacity: int, kv_bits: int) -> float:
    """GB of ``generate``'s quantized cache from the config: per layer, row
    and position K and V payloads of Hk * D * kv_bits / 8 bytes and their
    f32 scales per kv head."""
    lc = cfg.llm
    Hk = lc.num_key_value_heads
    return lc.num_hidden_layers * rows * capacity * 2 * (Hk * lc.head_dim * kv_bits // 8 + 4 * Hk) / 1e9


def serve_int4_kv(torch, cfg, run, res) -> tuple:
    """The W8A8 serve with ``generate(kv_bits=4)``: the packed-int4 cache
    on K3's int4 form, SERVE_ROWS rows, MAX_NEW tokens.  Checks the launch
    counts (the int4 form at every decode step and layer, the int8 form
    never) and the tokens' shape and vocabulary; reports the cache's GB
    against the int8 cache's, the peak GB of both runs, the share of
    tokens equal to the int8-KV run ``res`` (lossy by design), and the run
    against the same run on the int4 form's plain version (unbounded: the
    random W8A8 weights' chaos; ``phase_serve_w8a8`` bounds it on bf16
    weights)."""
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res4 = run(MAX_NEW, kv_bits=4)
    e2e_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = serve_counts(cfg, SERVE_ROWS, PAD_BUCKET, MAX_NEW, quantized=True, kv_bits=4)
    with int4_decode_plain():
        plain = run(MAX_NEW, kv_bits=4)
    _, vs_plain = logits_vs(torch, res4, plain, vocab)
    capacity = PAD_BUCKET + MAX_NEW
    checks = {
        "launch_counts": counts == want,
        "tokens_shape": list(res4.tokens.shape) == [SERVE_ROWS, MAX_NEW],
        "tokens_in_vocab": bool(((res4.tokens >= 0) & (res4.tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(res4.first_logits).all() and torch.isfinite(res4.last_logits).all()),
        "first_logits_equal_int8_kv_run": torch.equal(res4.first_logits, res.first_logits),
    }
    out = {
        "launches": counts, "launches_expected": want,
        "cache_gb_from_shapes": {"int4": quant_cache_gb(cfg, SERVE_ROWS, capacity, 4),
                                 "int8": quant_cache_gb(cfg, SERVE_ROWS, capacity, 8)},
        "tokens_agreement_vs_int8_kv_run": float((res4.tokens == res.tokens).float().mean()),
        "w8a8_int4_kernel_vs_plain_unbounded": vs_plain,
        "smoke_figures_not_a_benchmark": {"e2e_s": e2e_s, "tok_s": SERVE_ROWS * MAX_NEW / e2e_s,
                                          "peak_mem_gb": peak_gb},
    }
    return checks, out, counts


def serve_fused_kernels(torch, cfg, model, run, res) -> tuple:
    """The W8A8 serve after ``fuse_serving_kernels`` (in place; the model
    stays fused): q/k/v one product in the decoder and the tower, gate/up
    one.  Checks the launch counts by the fused shapes and the first-token
    logits bit-equal to the unfused run ``res`` (its prefill takes W8A8 in
    every projection, and K8's int32 sums are exact per column, so only
    K8's launch count changes).  The decode is not the same function: the
    fused (expanding) q/k/v take W8A8 at every row count, where the unfused
    k and v run K9 below 2048 rows, as in the reference; so with every
    projection on W8A8 in both (``w8a8_at_every_row_count``) the fused and
    the unfused runs must give bit-equal tokens and last-step logits, and
    at the reference's rule the tokens' agreement is reported."""
    from spatialrgpt_tpu_torch.ops.layers import fuse_serving_kernels

    with w8a8_at_every_row_count():
        unfused_a8 = run(MAX_NEW)
    fuse_serving_kernels(model)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fused = run(MAX_NEW)
    e2e_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = serve_counts(cfg, SERVE_ROWS, PAD_BUCKET, MAX_NEW, quantized=True, fused=True)
    with w8a8_at_every_row_count():
        fused_a8 = run(MAX_NEW)
    checks = {
        "launch_counts": counts == want,
        "first_logits_bit_equal_to_unfused": torch.equal(fused.first_logits, res.first_logits),
        "first_tokens_equal_to_unfused": torch.equal(fused.tokens[:, 0], res.tokens[:, 0]),
        "all_w8a8_tokens_bit_equal_to_unfused": torch.equal(fused_a8.tokens, unfused_a8.tokens),
        "all_w8a8_last_logits_bit_equal_to_unfused": torch.equal(fused_a8.last_logits, unfused_a8.last_logits),
    }
    out = {
        "launches": counts, "launches_expected": want,
        "tokens_agreement_vs_unfused": float((fused.tokens == res.tokens).float().mean()),
        "rows_with_all_tokens_equal_to_unfused": int((fused.tokens == res.tokens).all(dim=1).sum()),
        "smoke_figures_not_a_benchmark": {"e2e_s": e2e_s, "tok_s": SERVE_ROWS * MAX_NEW / e2e_s,
                                          "peak_mem_gb": peak_gb},
    }
    return checks, out, counts


def engine_request(torch, cfg, rng, n_text: int):
    """bench_engine.py::make_request for the port: bos + the image + 2 x
    (<mask>, <depth>) + ``n_text`` text tokens padded to the 384 bucket,
    pixels drawn as it draws them and staged on the card in bf16, the
    token and index fields on the host.  Returns (inputs, prompt length)."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX

    ids = [1, IMAGE_TOKEN_INDEX] + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
    ids += list(rng.integers(10, 1000, n_text))
    size = cfg.vision.image_size
    pixels = (rng.standard_normal((1, size, size, 3)).astype(np.float32),
              rng.standard_normal((1, size, size, 3)).astype(np.float32),
              (rng.random((1, N_REGIONS, size, size)) > 0.5).astype(np.float32), np.ones((1, N_REGIONS), bool))
    inputs, plens = splice(torch, cfg, [np.asarray(ids, np.int64)], pixels, ENGINE_BUCKET, host_index_fields=True)
    return inputs, int(plens[0])


def record_engine(eng) -> dict:
    """Wrap an engine's device work to record each unchunked admission's
    width and first-token logits, each window's steps, the plain decode
    steps, and of the fused chunked prefill: the chunked admissions, each
    fused step's live rows, each fused window's completing rows, their
    first-token logits by request id, and the fused windows' wall s (the
    engine reads their tokens right after, so a synchronize here costs
    nothing).  A window that replays the engine's CUDA graph runs no
    ``_decode_once`` (its capture ran one): ``graph_stats``, the engine's
    own counts of captures, replayed and eager windows, says how many."""
    log = {"admissions": [], "windows": [], "first_logits": [], "plain_steps": 0, "chunk_admissions": 0,
           "fused_steps": [], "completions": [], "chunk_first_logits": {}, "fused_window_s": [],
           "graph_stats": eng.graph_stats}
    prefill, window, once = eng._prefill_batch, eng._decode_window, eng._decode_once
    fused_once, fused_window, start_row = eng._fused_once, eng._run_fused_window, eng._start_row

    def prefill_recorded(inputs, *args):
        kv, toks, logits = prefill(inputs, *args)
        log["admissions"].append(int(inputs.input_ids.shape[0]))
        log["first_logits"].append(logits)
        return kv, toks, logits

    def window_recorded(k, *args):
        log["windows"].append(k)
        return window(k, *args)

    def once_recorded(*args):
        log["plain_steps"] += 1
        return once(*args)

    def fused_once_recorded(live, *args):
        log["fused_steps"].append(len(live))
        return fused_once(live, *args)

    def start_row_recorded(*args):
        log["chunk_admissions"] += 1
        return start_row(*args)

    def fused_window_recorded(k, *args):
        ids = {r: rs["req"].request_id for r, rs in enumerate(eng._rows) if rs is not None}
        log["windows"].append(k)
        t0 = time.perf_counter()
        out = fused_window(k, *args)
        torch_sync()
        log["fused_window_s"].append(time.perf_counter() - t0)
        _, done, _, logits = out
        if done:
            log["completions"].append(len(done))
            for i, r in enumerate(done):
                log["chunk_first_logits"][ids[r]] = logits[i]
        return out

    eng._prefill_batch, eng._decode_window, eng._decode_once = prefill_recorded, window_recorded, once_recorded
    eng._fused_once, eng._run_fused_window, eng._start_row = fused_once_recorded, fused_window_recorded, \
        start_row_recorded
    return log


def torch_sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def engine_counts(cfg, log: dict, slots: int, bucket: int, quantized: bool, kv_quant: bool = True,
                  chunk: int = 0) -> dict:
    """The launches of an engine run from what it ran (``record_engine``):
    K1 per tower layer at each admission, chunked or not, K2 per decoder
    layer at each unchunked one, K3 per decoder layer and decode step
    (plain or fused), and K7-K9 per admission prefill (its width x bucket
    rows), per plain decode step of all the slots, per fused step (the
    slots plus ``chunk`` rows per live chunk row through every decoder
    layer, the head over the slots), per chunked admission's tower, and per
    fused window's head over its completing rows."""
    L, T = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer
    n_adm, n_chunked = len(log["admissions"]), log["chunk_admissions"]
    steps = log["plain_steps"] + len(log["fused_steps"])
    quant = NO_QUANT
    if quantized:
        step = quant_phase_counts(cfg, 1, bucket, slots)[1]
        parts = [quant_phase_counts(cfg, n, bucket, slots)[0] for n in log["admissions"]]
        parts += [times(log["plain_steps"], step), times(n_chunked, tower_counts(cfg, 1))]
        parts += [add_counts(times(L, decoder_layer_counts(cfg, slots + n * chunk)), lm_head_counts(cfg, slots))
                  for n in log["fused_steps"]]
        parts += [lm_head_counts(cfg, n) for n in log["completions"]]
        quant = add_counts(*parts)
    return {"vit_attention": T * (n_adm + n_chunked), "onepass_attention": L * n_adm,
            "decode_attention_int8_flat": L * steps if kv_quant else 0, "decode_attention_int4_flat": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "grid_bias_attention": 0, "fused_layer_norm": 0, **quant}


def engine_vs_lockstep(torch, cfg) -> dict:
    """(a) The engine against lockstep ``generate`` on phase main's model
    (bf16 weights, seed 0): 16 requests, phase main's rows of seeds 0 and 1,
    through N_ROWS slots (bucket 320, MAX_NEW tokens, windows of 8,
    admission width 8), all submitted at once: each wave of 8 is one
    admission and decodes in lockstep, the second in recycled slots.  Each
    wave's greedy tokens must equal ``generate`` on its 8 rows with the same
    kernels and capacity, with the int8 cache (K3) and with the bf16 cache
    (plain decode attention); the int8 run's first-token logits must lie
    within LOGITS_REL_BOUND of the same engine on K1-K3's plain versions.
    Then the fused chunked prefill (ENGINE_CHUNK, ENGINE_CHUNK_ROWS rows in
    flight) on the same requests with the int8 cache: every admission's
    first-token logits within LOGITS_REL_BOUND of the same request's
    unchunked admission, and of the same fused engine on K1-K3's plain
    versions; launch counts from what it ran; its tokens' agreement with
    the unchunked run reported (the chunk attention rounds elsewhere than
    K2).  These bounds hold here, on bf16 weights: on phase (b)'s random
    W8A8 weights one bf16 rounding moves first-token logits ~0.33 (the
    W8A8 route against the whole plain route, ``phase_serve_w8a8``), so
    part (c) there reports the same distances unbounded."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.serving.generate import generate
    from spatialrgpt_tpu_torch.utils.weights import init_random

    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    waves = [draw_rows(cfg, np.random.default_rng(seed), N_ROWS) for seed in (0, 1)]
    requests = [splice(torch, cfg, [rows[i]], tuple(a[i : i + 1] for a in pixels), host_index_fields=True)
                for rows, pixels in waves for i in range(N_ROWS)]

    def engine_run(kv_quant: bool, impl: str, chunk: int = 0):
        eng = ServingEngine(model, cfg, num_slots=N_ROWS, prompt_bucket=PAD_BUCKET, max_new_tokens=MAX_NEW,
                            attn_impl=impl, kv_quant=kv_quant, admit_width=N_ROWS, prefill_chunk=chunk,
                            chunk_rows=ENGINE_CHUNK_ROWS)
        log = record_engine(eng)
        reset_counts()
        ids = [eng.submit(x, int(p[0]), max_new_tokens=MAX_NEW) for x, p in requests]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=ENGINE_MULTI)}
        torch.cuda.synchronize()
        counts = read_counts()
        if chunk:  # first-token logits in submission order
            log["first_logits"] = [torch.stack([log["chunk_first_logits"][i] for i in ids])]
        return [done.get(i) for i in ids], log, counts, eng.capacity

    out, checks, logs = {}, {}, {}
    for kv_quant in (True, False):
        toks, log, counts, capacity = engine_run(kv_quant, "onepass")
        logs[kv_quant] = log
        if kv_quant:
            logs["tokens"] = toks
        want = engine_counts(cfg, log, N_ROWS, PAD_BUCKET, quantized=False, kv_quant=kv_quant)
        cache = "int8" if kv_quant else "bf16"
        equal_rows = 0
        for w, (rows, pixels) in enumerate(waves):
            inputs, plens = splice(torch, cfg, rows, pixels)
            ref = generate(model, cfg, inputs, plens, max_new_tokens=MAX_NEW, eos_token_id=-1, kv_quant=kv_quant)
            ref_toks = ref.tokens.tolist()
            equal_rows += sum(toks[w * N_ROWS + b] == ref_toks[b] for b in range(N_ROWS))
        checks[f"{cache}_tokens_equal_lockstep"] = equal_rows == 2 * N_ROWS
        checks[f"{cache}_one_admission_per_wave"] = log["admissions"] == [N_ROWS, N_ROWS]
        checks[f"{cache}_launch_counts"] = counts == want
        out[cache] = {"rows_equal_to_lockstep": equal_rows, "admissions": log["admissions"],
                      "windows": log["windows"], "graph_stats": log["graph_stats"], "capacity": capacity,
                      "launches": counts, "launches_expected": want,
                      "first_tokens_request0": toks[0][:8] if toks[0] else None}
    _, plain_log, _, _ = engine_run(True, "xla")
    first = torch.cat(logs[True]["first_logits"])
    rel = rel_l2(first, torch.cat(plain_log["first_logits"]))
    checks["int8_first_logits_vs_plain"] = rel <= LOGITS_REL_BOUND
    out["int8_first_logits_rel_l2_vs_plain"] = rel
    out["int8_first_logits_finite"] = bool(torch.isfinite(first).all())
    checks["int8_first_logits_finite"] = out["int8_first_logits_finite"]
    # the fused chunked prefill on the same requests
    ftoks, flog, fcounts, _ = engine_run(True, "onepass", ENGINE_CHUNK)
    _, fplain_log, _, _ = engine_run(True, "xla", ENGINE_CHUNK)
    ffirst = flog["first_logits"][0]
    fwant = engine_counts(cfg, flog, N_ROWS, PAD_BUCKET, quantized=False, chunk=ENGINE_CHUNK)
    rel_unchunked, rel_fplain = rel_l2(ffirst, first), rel_l2(ffirst, fplain_log["first_logits"][0])
    checks["fused_all_tokens"] = all(t is not None and len(t) == MAX_NEW for t in ftoks)
    checks["fused_first_logits_vs_unchunked_admission"] = rel_unchunked <= LOGITS_REL_BOUND
    checks["fused_first_logits_vs_plain"] = rel_fplain <= LOGITS_REL_BOUND
    checks["fused_launch_counts"] = fcounts == fwant
    out["fused"] = {
        "prefill_chunk": ENGINE_CHUNK, "chunk_rows": ENGINE_CHUNK_ROWS, "chunked_admissions": flog["chunk_admissions"],
        "fused_steps_by_live_rows": {n: flog["fused_steps"].count(n) for n in sorted(set(flog["fused_steps"]))},
        "plain_steps": flog["plain_steps"], "windows": flog["windows"],
        "first_logits_rel_l2_vs_unchunked_admission": rel_unchunked, "first_logits_rel_l2_vs_plain": rel_fplain,
        "tokens_agreement_vs_unchunked": float(np.mean([a == b for ta, tb in zip(ftoks, logs["tokens"])
                                                        for a, b in zip(ta, tb)])),
        "launches": fcounts, "launches_expected": fwant,
    }
    del model
    torch.cuda.empty_cache()
    return checks, out


def engine_bench(torch, cfg, nvidia_smi: str, profile_dir=None) -> tuple:
    """(b) bench_engine.py's configuration on the main path's model:
    llama3-8b W8A8 llm and tower (``init_random_quantized``, as
    serve_w8a8), int8 KV, ``attn_impl="onepass"``; 32 slots, 64 requests
    of ``make_request``'s recipe (48-127 text tokens, ``default_rng(0)``),
    bucket 384, 64 greedy tokens, windows of 8, admission width 8, inputs
    staged on the card; one warm-up pass (bench_engine.py's: 15 requests of
    4 tokens, which admits at widths 8, 4, 2 and 1), then all 64 submitted
    at t0 and ``step(8)`` until they are done."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.utils.weights import init_random_quantized

    t0 = time.perf_counter()
    model = init_random_quantized(cfg, torch.device(DEVICE), w8a8=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [engine_request(torch, cfg, rng, int(rng.integers(*ENGINE_TEXT_TOKENS))) for _ in range(ENGINE_REQS)]
    eng = ServingEngine(model, cfg, num_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET, max_new_tokens=ENGINE_MAX_NEW,
                        kv_quant=True, admit_width=ENGINE_ADMIT, attn_impl="onepass")
    warm_reqs = reqs[: min(15, ENGINE_REQS)]
    for i, (x, plen) in enumerate(warm_reqs):
        eng.submit(x, plen, max_new_tokens=4, seed=i)
    warm = eng.run_until_drained(num_steps=ENGINE_MULTI)
    torch.cuda.synchronize()
    log = record_engine(eng)
    done, ids, counts, run_figures = engine_timed_run(torch, eng, reqs)
    peak_gb = run_figures["peak_mem_gb"]
    cache_gb = sum(t.numel() * t.element_size() for t in eng.cache) / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    want = engine_counts(cfg, log, ENGINE_SLOTS, ENGINE_BUCKET, quantized=True)
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    checks = {
        "warm_up_drained": len(warm) == len(warm_reqs) and all(len(r.tokens) == 4 for r in warm),
        "all_requests_64_tokens": len(done) == ENGINE_REQS and all(len(r.tokens) == ENGINE_MAX_NEW for r in done),
        "tokens_in_vocab": all(0 <= t < vocab for r in done for t in r.tokens),
        "launch_counts": counts == want,
        "cache_fits": peak_gb < total_gb,
    }
    out = {
        "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision tower, "
                 "int8 KV, random from seed 0",
        "config": {"slots": ENGINE_SLOTS, "requests": ENGINE_REQS, "prompt_bucket": ENGINE_BUCKET,
                   "max_new_tokens": ENGINE_MAX_NEW, "num_steps": ENGINE_MULTI, "admit_width": ENGINE_ADMIT,
                   "text_tokens": [ENGINE_TEXT_TOKENS[0], ENGINE_TEXT_TOKENS[1] - 1], "capacity": eng.capacity,
                   "greedy": True, "prestaged_inputs": True},
        "admissions": log["admissions"], "windows": log["windows"], "graph_stats": log["graph_stats"],
        "launches": counts, "launches_expected": want, "cache_gb": cache_gb, "peak_mem_gb": peak_gb,
        "device_mem_gb": total_gb,
        "smoke_figures_not_a_benchmark": {
            **run_figures, "n_scheduler_syncs": run_figures["n_scheduler_syncs"] + len(log["admissions"]),
            "init_s": init_s, "card": nvidia_smi,
        },
    }
    if profile_dir:  # one wave: the first 32 requests through the 32 slots

        def wave():
            for i, (x, plen) in enumerate(reqs[:ENGINE_SLOTS]):
                eng.submit(x, plen, max_new_tokens=ENGINE_MAX_NEW, seed=i)
            eng.run_until_drained(num_steps=ENGINE_MULTI)
            torch.cuda.synchronize()

        profile_run(torch, wave, profile_dir, "engine_w8a8_wave")
    unchunked_first = torch.cat(log["first_logits"])  # the admissions take the requests in submission order
    checks_c, out["c_fused_chunked_prefill"], counts_c = engine_fused(
        torch, cfg, model, reqs, {i: unchunked_first[k] for k, i in enumerate(ids)}, ids, done, nvidia_smi,
        profile_dir)
    checks.update({f"c_{k}": v for k, v in checks_c.items()})
    return checks, out, add_counts(counts, counts_c)


def engine_timed_run(torch, eng, reqs) -> tuple:
    """``reqs`` submitted to ``eng`` at t0 (seed i each), then ``step(ENGINE_MULTI)``
    until they are done, with the launch counts read around it.  Returns
    (the finished requests, their ids in submission order, the counts,
    bench_engine.py's figures)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    submit_t, finish_t, ids = {}, {}, []
    for i, (x, plen) in enumerate(reqs):
        ids.append(eng.submit(x, plen, max_new_tokens=ENGINE_MAX_NEW, seed=i))
        submit_t[ids[-1]] = time.perf_counter()
    done, n_syncs = [], 0
    while len(done) < len(reqs) and n_syncs < 10 * len(reqs):
        fin = eng.step(ENGINE_MULTI)
        n_syncs += 1
        now = time.perf_counter()
        for r in fin:
            finish_t[r.request_id] = now
        done.extend(fin)
        if not eng.queue and not eng.active.any() and all(rs is None for rs in eng._rows):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lat = sorted(finish_t[r.request_id] - submit_t[r.request_id] for r in done)
    total_tokens = sum(len(r.tokens) for r in done)
    figures = {"tok_s": total_tokens / wall, "wall_s": wall, "latency_p50_s": lat[len(lat) // 2] if lat else None,
               "latency_p95_s": lat[int(len(lat) * 0.95)] if lat else None, "n_scheduler_syncs": n_syncs,
               "total_tokens": total_tokens, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return done, ids, counts, figures


def chunk_attention_ms(torch, cfg) -> float:
    """Device ms of one ``streamed_position_attention`` call at part (c)'s
    shapes: a chunk of ENGINE_CHUNK queries (the prompt's last, attending
    to the whole staging row) of one row, llama3-8b's heads, bf16 staging
    of the bucket in whole chunks (one CUDA graph of 20 calls)."""
    from spatialrgpt_tpu_torch.ops.attention import streamed_position_attention

    lc, c = cfg.llm, ENGINE_CHUNK
    Sp = -(-ENGINE_BUCKET // c) * c
    g = torch.Generator(device=DEVICE).manual_seed(5)
    q = torch.randn(1, c, lc.num_attention_heads, lc.head_dim, generator=g, device=DEVICE).to(torch.bfloat16)
    k, v = (torch.randn(1, Sp, lc.num_key_value_heads, lc.head_dim, generator=g, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    q_idx = torch.arange(Sp - c, Sp, device=DEVICE)[None]
    return graph_ms(torch, lambda: streamed_position_attention(q, k, v, q_idx, 512), 20)


def engine_fused(torch, cfg, model, reqs, unchunked_first: dict, unchunked_ids, unchunked_done, nvidia_smi: str,
                 profile_dir=None) -> tuple:
    """(c) The fused mixed-batch chunked prefill on part (b)'s model and
    requests: ENGINE_CHUNK-token chunks, ENGINE_CHUNK_ROWS admissions in
    flight, the rest of (b)'s configuration; a warm-up of 2 requests, then
    all of them at t0.  Checks every request's tokens and the launch
    counts from what ran (``engine_counts``: the fused steps by their live
    rows).  Reports (b)'s figures, the agreement of the tokens with (b)'s
    (not gated: the chunk attention rounds elsewhere than K2), the
    first-token logits of four fused admissions against the same requests'
    unchunked admission in (b) (unbounded here: random W8A8 weights, see
    ``engine_vs_lockstep``), and the chunk attention's device ms a call,
    per fused step and as a share of the fused windows' wall."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, cfg, num_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET, max_new_tokens=ENGINE_MAX_NEW,
                        kv_quant=True, admit_width=ENGINE_ADMIT, attn_impl="onepass", prefill_chunk=ENGINE_CHUNK,
                        chunk_rows=ENGINE_CHUNK_ROWS)
    warm = [eng.submit(x, plen, max_new_tokens=4, seed=i) for i, (x, plen) in enumerate(reqs[:2])]
    warm_done = eng.run_until_drained(num_steps=ENGINE_MULTI)
    log = record_engine(eng)
    done, ids, counts, figures = engine_timed_run(torch, eng, reqs)
    want = engine_counts(cfg, log, ENGINE_SLOTS, ENGINE_BUCKET, quantized=True, chunk=ENGINE_CHUNK)
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    by_id = {r.request_id: r.tokens for r in done}
    b_tokens = {r.request_id: r.tokens for r in unchunked_done}
    agree = [a == b for i, j in zip(ids, unchunked_ids) for a, b in zip(by_id.get(i, []), b_tokens.get(j, []))]
    first = [rel_l2(log["chunk_first_logits"][i], unchunked_first[j]) for i, j in list(zip(ids, unchunked_ids))[:4]]
    call_ms = chunk_attention_ms(torch, cfg)
    n_live = statistics.mean(log["fused_steps"]) if log["fused_steps"] else 0.0
    per_step_ms = call_ms * n_live * cfg.llm.num_hidden_layers
    fused_windows = len(log["fused_window_s"])
    checks = {
        "warm_up_drained": len(warm_done) == len(warm),
        "all_requests_64_tokens": len(done) == len(reqs) and all(len(r.tokens) == ENGINE_MAX_NEW for r in done),
        "tokens_in_vocab": all(0 <= t < vocab for r in done for t in r.tokens),
        "all_admissions_chunked": log["chunk_admissions"] == len(reqs) and not log["admissions"],
        "launch_counts": counts == want,
        "first_logits_finite": all(bool(torch.isfinite(t).all()) for t in log["chunk_first_logits"].values()),
    }
    out = {
        "config": {"prefill_chunk": ENGINE_CHUNK, "chunk_rows": ENGINE_CHUNK_ROWS, "staging_length": eng.Sp,
                   "chunk_attention_block": eng._chunk_block, "slots": ENGINE_SLOTS, "requests": len(reqs),
                   "max_new_tokens": ENGINE_MAX_NEW, "num_steps": ENGINE_MULTI, "submitted": "all at t0"},
        "fused_windows": fused_windows, "plain_steps": log["plain_steps"],
        "fused_steps_by_live_rows": {n: log["fused_steps"].count(n) for n in sorted(set(log["fused_steps"]))},
        "launches": counts, "launches_expected": want,
        "tokens_agreement_vs_unchunked_b": float(np.mean(agree)) if agree else None,
        "first_logits_rel_l2_vs_unchunked_b_first_4_unbounded": first,
        "chunk_attention": {
            "device_ms_per_call": call_ms, "calls_per_fused_step": n_live * cfg.llm.num_hidden_layers,
            "device_ms_per_fused_step": per_step_ms,
            "fused_window_wall_s_mean": statistics.mean(log["fused_window_s"]) if fused_windows else None,
            "share_of_fused_window_wall": (per_step_ms * len(log["fused_steps"]) / 1e3 / sum(log["fused_window_s"])
                                           if fused_windows else None),
        },
        "smoke_figures_not_a_benchmark": {**figures, "card": nvidia_smi},
    }
    if profile_dir:  # one wave: the first 32 requests through the 32 slots, chunked

        def wave():
            for i, (x, plen) in enumerate(reqs[:ENGINE_SLOTS]):
                eng.submit(x, plen, max_new_tokens=ENGINE_MAX_NEW, seed=i)
            eng.run_until_drained(num_steps=ENGINE_MULTI)
            torch.cuda.synchronize()

        profile_run(torch, wave, profile_dir, "engine_w8a8_fused_wave")
    del eng
    torch.cuda.empty_cache()
    return checks, out, counts


def phase_engine(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The continuous-batching ``ServingEngine`` at the full width of
    llama3-8b: (a) ``engine_vs_lockstep``, (b) ``engine_bench`` and its part
    (c), ``engine_fused``; eos at -1, so every request runs its full budget.
    Returns the launch counts of (b) and (c)."""
    import dataclasses

    cfg = llama3_8b_cfg()
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, eos_token_id=-1))
    checks_a, out_a = engine_vs_lockstep(torch, cfg)
    checks_b, out_b, counts = engine_bench(torch, cfg, nvidia_smi, profile_dir)
    checks = {**{f"a_{k}": v for k, v in checks_a.items()}, **{f"b_{k}": v for k, v in checks_b.items()}}
    emit({"phase": "engine", "ok": all(checks.values()), "checks": checks,
          "a_engine_vs_lockstep": {"model": "llama3-8b + siglip-so400m, bf16 weights from seed 0 (phase main's)",
                                   "slots": N_ROWS, "requests": 2 * N_ROWS, "prompt_bucket": PAD_BUCKET,
                                   "max_new_tokens": MAX_NEW, "num_steps": ENGINE_MULTI, **out_a},
          "b_bench_engine_config": out_b})
    check(all(checks.values()), f"engine checks failed: {checks}")
    return counts


def family_cfg(name: str, **llm):
    """``preset(name)`` as bench.py serves it (phase main's extra tokens),
    eos at -1 so that every row runs its full budget, room for the long
    prompt; ``llm`` overrides decoder fields."""
    from spatialrgpt_tpu_torch import preset

    cfg = preset(name)
    return cfg.replace(
        mask_token_id=cfg.llm.vocab_size, depth_token_id=cfg.llm.vocab_size + 1, num_extra_tokens=8,
        model_max_length=max(FAMILY_LONG_BUCKET, cfg.model_max_length),
        llm=dataclasses.replace(cfg.llm, eos_token_id=-1, **llm),
    )


def serve_counts(cfg, rows: int, bucket: int, max_new: int, quantized: bool, kv_bits: int = 8,
                 fused: bool = False) -> dict:
    """The launches of one region-QA ``generate`` with the int8 cache (or
    the packed-int4 one): K1 per tower layer, K2 per decoder layer, K3 (or
    its int4 form) per decoder layer and decode step, K7-K9 by
    ``quant_expected_counts`` when the llm and tower are W8A8 (``fused``:
    by ``fuse_serving_kernels``)."""
    L = cfg.llm.num_hidden_layers
    k3 = {"decode_attention_int8_flat": 0, "decode_attention_int4_flat": 0}
    k3["decode_attention_int4_flat" if kv_bits == 4 else "decode_attention_int8_flat"] = L * (max_new - 1)
    return {
        "vit_attention": tower_layers(cfg), "onepass_attention": L, **k3,
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
        "grid_bias_attention": 0, "fused_layer_norm": 0,
        **(quant_expected_counts(cfg, rows, bucket, max_new, fused) if quantized else NO_QUANT),
    }


def layer_updates_vs_plain(torch, cfg, model) -> list:
    """Per decoder layer, over phase main's 8 rows: the relative L2 distance
    of the layer's update (output less input) on the kernel route from the
    plain route's, both from the plain route's input to that layer."""
    import numpy as np

    from spatialrgpt_tpu_torch.models import llama, vlm

    inputs, _ = build_batch(torch, cfg, np.random.default_rng(0), N_ROWS)
    rels = []
    with torch.no_grad():
        x = vlm.prepare_embeds(model, cfg, inputs, "xla")
        for layer in model.llm.model.layers:
            args = (layer, cfg.llm, inputs.position_ids, inputs.segment_ids)
            plain = llama.decoder_layer(x, *args, "xla")[0]
            rels.append(rel_l2(llama.decoder_layer(x, *args, "onepass")[0] - x, plain - x))
            x = plain
    return rels


def moe_blocks_sparse_vs_dense(torch, cfg, model) -> dict:
    """Per MoE layer, over phase main's 8 rows on the dense route: the
    sparse block's output against the dense block's, from the layer's MoE
    input, on the tokens where the dense gate keeps exactly k experts
    (relative L2), and how many tokens tie at the k-th probability (there
    the dense gate keeps every tied expert and the sparse block k, as the
    reference's two blocks do; bf16 router logits tie often)."""
    import numpy as np

    from spatialrgpt_tpu_torch.models import llama, vlm

    inputs, _ = build_batch(torch, cfg, np.random.default_rng(0), N_ROWS)
    lc, rels, ties = cfg.llm, [], []
    with torch.no_grad():
        x = vlm.prepare_embeds(model, cfg, inputs, "onepass")
        for layer in model.llm.model.layers:
            attn, _ = llama.attention_block(llama.norm(x, layer.input_layernorm), layer.self_attn, lc,
                                            inputs.position_ids, inputs.segment_ids, "onepass")
            x = x + attn
            h = llama.norm(x, layer.post_attention_layernorm)
            moe = layer.block_sparse_moe
            dense, _ = llama.moe_block(h, moe, lc)
            sparse, _ = llama.moe_block_sparse(h, moe, lc)
            untied = (llama.router_gates(h, moe, lc)[1] > 0).sum(dim=-1) == lc.num_experts_per_tok
            rels.append(rel_l2(sparse[untied], dense[untied]))
            ties.append(int((~untied).sum()))
            x = x + dense
    return {"rel_l2_untied_tokens": rels, "tied_tokens": ties, "tokens": int(inputs.input_ids.numel())}


def phase_families(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The presets beside Llama's through ``generate`` (bench.py's region QA:
    8 rows, RGB + depth, 2 regions, the 320 bucket, FAMILY_MAX_NEW greedy
    tokens, the int8 cache), weights random from seed 0 at full width:

    - mistral-7b, bf16 then W8A8 (llm and tower); bf16 also on one row of
      FAMILY_LONG_LIVE live positions in the FAMILY_LONG_BUCKET bucket,
      where its 4096-position window binds (the plain route without the
      window must lie further from the plain route than the kernel route);
    - gemma-7b, bf16 then W8A8: K2's D = 256 form, K3 at D 256, the tied
      f32 head, scaled embeddings, ``1 + w`` norms, GeLU-tanh;
    - mixtral-8x7b, W8A8 on the dense MoE at its 32 layers (bf16 would
      not fit the card), then one ``ServingEngine`` run of the same 8 rows
      through 8 slots (one admission, windows of 8), its tokens equal to
      ``generate``'s;
    - the sparse MoE: bf16 at Mixtral's widths on SPARSE_MOE_LAYERS layers,
      experts stacked, held to the dense block on the same weights.

    Each run is counted (its launches against ``serve_counts``) and held to
    the plain route.  bf16: every decoder layer's update against the plain
    route's from the same input (``layer_updates_vs_plain``, at most
    LAYER_REL_BOUND), and phase main's check (``logits_vs`` over MAX_NEW
    tokens, K1-K3's plain versions) at FAMILY_LOGITS_DEPTH layers of the
    full widths (Gemma: 2; its full depth's first-token distance and an
    f32-decoder witness reported).  W8A8: first-token logits bit-equal to
    the same run on K7-K9's plain versions.  The sparse MoE: its
    first-token logits within LOGITS_REL_BOUND of the dense route's, each
    layer's block within LAYER_REL_BOUND of the dense block's on the
    tokens without a router tie (``moe_blocks_sparse_vs_dense``); its
    tokens against the dense route's reported.  Per run TTFT, decode
    tokens/s and peak memory.  Returns the summed launch counts of the
    kernel runs."""
    import numpy as np

    from spatialrgpt_tpu_torch import NUM_TOKENS_PER_IMAGE
    from spatialrgpt_tpu_torch.models import llama
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    checks, runs, totals = {}, {}, []
    # draw_rows' prompt: bos, 8 tokens, the image, 2 x (<mask>, <depth>), then the question
    long_batch = {"text_tokens": FAMILY_LONG_LIVE - (1 + 8 + NUM_TOKENS_PER_IMAGE + 2 * N_REGIONS),
                  "bucket": FAMILY_LONG_BUCKET}

    def served(label, cfg, model, quantized, n_rows=N_ROWS, max_new=FAMILY_MAX_NEW, **batch):
        res, counts, figures, run = serve_run(torch, cfg, model, n_rows, max_new, **batch)
        want = serve_counts(cfg, n_rows, batch.get("bucket", PAD_BUCKET), max_new, quantized)
        checks[f"{label}_launch_counts"] = counts == want
        vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
        checks[f"{label}_tokens_in_vocab"] = bool(((res.tokens >= 0) & (res.tokens < vocab)).all())
        totals.append(counts)
        runs[label] = {"rows": n_rows, "max_new_tokens": max_new, "launches": counts,
                       "launches_expected": want if counts != want else "equal",
                       "smoke_figures_not_a_benchmark": {**figures, "card": nvidia_smi},
                       "first_tokens_row0": res.tokens[0, :8].tolist()}
        return res, run

    def held(label, res, ref, **kw):
        got, fields = logits_vs(torch, res, ref, **kw)
        checks.update({f"{label}_{k}": v for k, v in got.items()})
        runs[label]["vs_plain_route"] = fields

    def w8a8_held(label, res, run):
        with plain_projections():
            ref = run(1)
        checks[f"{label}_first_logits_bit_equal_to_plain_projections"] = torch.equal(res.first_logits,
                                                                                      ref.first_logits)

    def layers_held(label, cfg, model):
        rels = layer_updates_vs_plain(torch, cfg, model)
        checks[f"{label}_layer_updates_vs_plain"] = max(rels) <= LAYER_REL_BOUND
        runs[label]["layer_updates_rel_l2_vs_plain"] = rels

    def init(cfg, quantized):
        t0 = time.perf_counter()
        model = (init_random_quantized(cfg, dev, w8a8=True, seed=0) if quantized
                 else init_random(cfg, dev, torch.bfloat16, seed=0))
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    for name in ("mistral-7b", "gemma-7b"):
        cfg = family_cfg(name)
        vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
        model, init_s = init(cfg, False)
        label = f"{name}_bf16"
        res, run = served(label, cfg, model, False)
        runs[label]["init_s"] = init_s
        layers_held(label, cfg, model)
        depth = FAMILY_LOGITS_DEPTH.get(name)
        if depth is None:
            held(label, run(MAX_NEW), run(MAX_NEW, "xla"), vocab=vocab)
        else:  # full depth reported; the logits held at `depth` layers of the full widths
            kernel, plain = run(1), run(1, "xla")
            runs[label]["full_depth_first_logits_rel_l2_vs_plain"] = rel_l2(kernel.first_logits, plain.first_logits)
            with torch.no_grad():
                model.float()  # the decoder in f32 (the tower keeps the bf16 pixels): a witness, not a route
                f32 = run(1, "xla")
            runs[label]["full_depth_first_logits_rel_l2_to_f32_decoder"] = {
                "kernel_route": rel_l2(kernel.first_logits, f32.first_logits),
                "plain_route": rel_l2(plain.first_logits, f32.first_logits)}
            del model, run, kernel, plain, f32
            release(torch)
            short = family_cfg(name, num_hidden_layers=depth)
            model, _ = init(short, False)
            run = serve_runner(torch, short, model, N_ROWS)
            held(label, run(MAX_NEW), run(MAX_NEW, "xla"), vocab=vocab)
            runs[label]["vs_plain_route"]["layers"] = depth
        if cfg.llm.sliding_window:
            label = f"{name}_bf16_long_prompt"
            res, run = served(label, cfg, model, False, 1, FAMILY_LONG_MAX_NEW, **long_batch)
            plain = run(FAMILY_LONG_MAX_NEW, "xla")
            checks[f"{label}_live_positions"] = serve_runner_lengths(torch, cfg, long_batch) == [FAMILY_LONG_LIVE]
            held(label, res, plain, vocab=vocab, min_equal_rows=1, max_new=FAMILY_LONG_MAX_NEW)
            unwindowed = cfg.replace(llm=dataclasses.replace(cfg.llm, sliding_window=None))
            full = run(1, "xla", model_cfg=unwindowed)
            kernel_rel, window_rel = rel_l2(res.first_logits, plain.first_logits), rel_l2(full.first_logits,
                                                                                          plain.first_logits)
            checks[f"{label}_window_binds"] = window_rel > kernel_rel
            runs[label]["first_logits_rel_l2_without_the_window_vs_plain"] = window_rel
            del plain, full
        del model, run, res
        release(torch)
        model, init_s = init(cfg, True)
        label = f"{name}_w8a8"
        res, run = served(label, cfg, model, True)
        runs[label]["init_s"] = init_s
        w8a8_held(label, res, run)
        del model, run, res
        release(torch)

    # mixtral-8x7b: W8A8 at full width (~47 GB), then the engine on the same model
    cfg = family_cfg("mixtral-8x7b")
    model, init_s = init(cfg, True)
    label = "mixtral-8x7b_w8a8"
    res, run = served(label, cfg, model, True)
    runs[label]["init_s"] = init_s
    runs[label]["weights_gb"] = sum(t.numel() * t.element_size() for t in model.llm.state_dict().values()) / 1e9
    w8a8_held(label, res, run)
    rows, pixels = draw_rows(cfg, np.random.default_rng(0), N_ROWS)
    requests = [splice(torch, cfg, [rows[i]], tuple(a[i : i + 1] for a in pixels), PAD_BUCKET, host_index_fields=True)
                for i in range(N_ROWS)]
    eng = ServingEngine(model, cfg, num_slots=N_ROWS, prompt_bucket=PAD_BUCKET, max_new_tokens=FAMILY_MAX_NEW,
                        kv_quant=True, admit_width=N_ROWS, attn_impl="onepass")
    log = record_engine(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ids = [eng.submit(x, int(p[0]), max_new_tokens=FAMILY_MAX_NEW) for x, p in requests]
    done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=ENGINE_MULTI)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = engine_counts(cfg, log, N_ROWS, PAD_BUCKET, quantized=True)
    totals.append(counts)
    lockstep = res.tokens.tolist()
    equal = sum(done.get(i) == lockstep[b] for b, i in enumerate(ids))
    checks["mixtral-8x7b_engine_tokens_equal_lockstep"] = equal == N_ROWS
    checks["mixtral-8x7b_engine_launch_counts"] = counts == want
    checks["mixtral-8x7b_engine_one_admission"] = log["admissions"] == [N_ROWS]
    runs["mixtral-8x7b_w8a8_engine"] = {
        "slots": N_ROWS, "requests": N_ROWS, "rows_equal_to_lockstep": equal, "admissions": log["admissions"],
        "windows": log["windows"], "launches": counts, "launches_expected": want if counts != want else "equal",
        "smoke_figures_not_a_benchmark": {"tok_s": N_ROWS * FAMILY_MAX_NEW / wall, "wall_s": wall,
                                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                                          "card": nvidia_smi}}
    del model, run, res, eng, requests
    release(torch)

    # the sparse MoE against the dense block on the same weights
    cfg = family_cfg("mixtral-8x7b", num_hidden_layers=SPARSE_MOE_LAYERS)
    model, init_s = init(cfg, False)
    llama.stack_experts(model.llm)
    sparse_cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, moe_impl="sparse"))
    dense, _ = served("mixtral-8x7b_bf16_dense", cfg, model, False)
    label = "mixtral-8x7b_bf16_sparse"
    sparse, _ = served(label, sparse_cfg, model, False)
    runs[label]["layers"] = SPARSE_MOE_LAYERS
    got, fields = logits_vs(torch, sparse, dense, cfg.llm.vocab_size + cfg.num_extra_tokens, max_new=FAMILY_MAX_NEW)
    checks[f"{label}_first_logits_vs_dense"] = got["first_logits_vs_plain"]
    runs[label]["vs_dense_route_tokens_reported"] = fields
    blocks = moe_blocks_sparse_vs_dense(torch, cfg, model)
    checks[f"{label}_blocks_vs_dense"] = max(blocks["rel_l2_untied_tokens"]) <= LAYER_REL_BOUND
    runs[label]["blocks_vs_dense"] = blocks
    del model, dense, sparse
    release(torch)

    emit({"phase": "families", "ok": all(checks.values()), "seconds": time.perf_counter() - t_phase,
          "checks": checks, "runs": runs,
          "model": "mistral-7b, gemma-7b, mixtral-8x7b at full width (the sparse MoE at "
                   f"{SPARSE_MOE_LAYERS} of 32 layers) + siglip-so400m (26 of 27 layers), random from seed 0"})
    check(all(checks.values()), f"families checks failed: {[k for k, v in checks.items() if not v]}")
    return add_counts(*totals)


# families_train: the depth of the full widths at which the one-row
# kernel-vs-plain check is held where the full depth amplifies bf16
# roundings past TRAIN_GRAD_REL_BOUND (the full depth's distance reported)
FAMILY_TRAIN_CHECK_DEPTH = {"gemma-7b": 2}
# Mixtral's QLoRA step: its experts take the merged form (a bf16 (out, in)
# tensor per expert projection, 2.8 GB a layer), so it runs at this depth
MIXTRAL_QLORA_LAYERS = 4
# train.main's family runs: 1_mm_align.sh's flags with these cuts, one
# micro step; --total_time_limit stops the run after it with a checkpoint
# of the trained tensors, so that no composite of the full model is written
# (phase recipe writes and reloads one)
FAMILY_MAIN_CUTS = ["--data_mixture", "dummy", "--per_device_train_batch_size", "8", "--max_steps", "2",
                    "--gradient_checkpointing", "true", "--total_time_limit", "1", "--pre_terminate_time", "1"]


def family_train_cfg(name: str, **llm):
    """``family_cfg`` with room for the align step's TRAIN_SEQ positions."""
    cfg = family_cfg(name, **llm)
    return cfg.replace(model_max_length=max(TRAIN_SEQ, cfg.model_max_length))


def phase_families_train(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The decoder families' training at full width, on phase train's batch
    (4 packed rows of 4096 tokens, 4 samples a row, RGB + depth, 2 regions),
    remat, CE chunks of 1024, attn_impl pallas, weights random from seed 0:

    - gemma-7b bf16: the align step (frozen decoder and tower, tuned
      projector and region extractor, lr 1e-3) on K4's D = 256 forms and the
      tied head's backward (``ops/layers.py::MatmulF32``): the kernel route
      against the plain route on one row (loss within TRAIN_LOSS_REL_BOUND,
      tuned gradients within TRAIN_GRAD_REL_BOUND), held at
      FAMILY_TRAIN_CHECK_DEPTH layers of the full widths and reported at the
      full depth; 3 steps; then the decoder quantized to int8 weight-only
      and one QLoRA step (r 64, alpha 16, bf16 adapters; K9);
    - mistral-7b bf16: the same on K4 at D 128 with its 4096 window (held at
      the full depth), and one QLoRA step;
    - mixtral-8x7b over a frozen W8A8 base at its 32 layers
      (``init_random_quantized``, ~47 GB), bench_train.py's
      SRGPT_TRAIN_BENCH_QUANT=1 then =2 as phase align_w8a8: per setting the
      quantized route against its plain versions on one row (loss and
      router aux loss bit-equal, gradients as ``RUN_TO_RUN_FACTOR`` says),
      3 ``make_frozen_base_train_step`` steps with the aux in the loss and
      the logged metrics; then one QLoRA step at MIXTRAL_QLORA_LAYERS layers
      of the full widths, LoRA on every expert (merged) and the attention
      projections (side branch);
    - ``train.main`` from argv (``--llm_preset gemma-7b``, and
      ``--llm_preset mistral-7b --lora_enable true --bits 8``) on the
      ``dummy`` mixture, one micro step each (FAMILY_MAIN_CUTS).

    Every run's launches are held to the counts worked out from the config;
    the frozen base stays bit-unchanged.  Per run the step seconds,
    tokens/s, peak memory, loss and router aux loss.  Returns the summed
    launch counts."""
    import numpy as np
    from torch import nn

    from spatialrgpt_tpu_torch.config import LLAMA_PRESETS
    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.train.lora import LoraConfig, init_lora
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import (create_train_state, make_frozen_base_train_step,
                                                  make_lora_train_step, make_train_step)
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    checks, runs, totals = {}, {}, []
    align_ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                                 tune_mm_projector=True, tune_region_extractor=True, total_steps=100)

    def batches(cfg):
        rng = np.random.default_rng(0)
        return train_batch(torch, cfg, rng, TRAIN_ROWS), train_batch(torch, cfg, rng, 1)

    def tuned_of(model):
        return [p for m in (model.mm_projector, model.region_extractor) for p in m.parameters()]

    def stepped(label, cfg, model, step_fn, state, batch, trainable, want, n_steps=TRAIN_STEPS):
        """``n_steps`` steps with their launches against ``want``; the base
        (decoder and tower) bit-unchanged; the figures."""
        base_before = {n: state_fingerprint(torch, getattr(model, n)) for n in ("llm", "vision_tower")}
        before = state_fingerprint(torch, trainable)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _, record = run_steps(torch, step_fn, state, batch, lambda: state_fingerprint(torch, trainable) != before,
                              want, n_steps)
        counts = read_counts()
        totals.append(counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        checks[f"{label}_launch_counts_every_step"] = all(r["launches_as_expected"] for r in record)
        checks[f"{label}_losses_finite"] = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                               for r in record)
        checks[f"{label}_base_bit_unchanged"] = all(state_fingerprint(torch, getattr(model, n)) == f
                                                    for n, f in base_before.items())
        if cfg.llm.is_moe:
            checks[f"{label}_router_aux_loss_in_the_metrics"] = all(r.get("router_aux_loss", 0.0) > 0 for r in record)
        if n_steps > 1:  # the warmup's first update has lr 0
            checks[f"{label}_trained_moved_after"] = record[-1]["tuned_moved"]
        step_s = statistics.median(r["seconds"] for r in record[1:]) if n_steps > 1 else record[0]["seconds"]
        runs[label] = {"layers": cfg.llm.num_hidden_layers, "steps": record, "launches": counts,
                       "launches_expected_per_step": want,
                       "smoke_figures_not_a_benchmark": {
                           "step_s": step_s, "step_s_is": "median of steps 2-3" if n_steps > 1
                           else "the one step, its first calls' set-up included",
                           "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / step_s, "peak_mem_gb": peak, "card": nvidia_smi}}

    def vs_plain(cfg, model, one_row) -> dict:
        """The align loss and tuned gradients on one row, kernel route
        (K1, K4) against the plain route."""
        params = tuned_of(model)
        loss_k, g_k = loss_and_grads(torch, cfg, model, one_row, params, "pallas")
        loss_p, g_p = loss_and_grads(torch, cfg, model, one_row, params, "xla")
        return {"loss_rel": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)), "grad_rel_l2": rel_l2(g_k, g_p),
                "loss_bound": TRAIN_LOSS_REL_BOUND, "grad_bound": TRAIN_GRAD_REL_BOUND}

    def held_vs_plain(label, result):
        checks[f"{label}_loss_vs_plain_one_row"] = result["loss_rel"] <= TRAIN_LOSS_REL_BOUND
        checks[f"{label}_grads_vs_plain_one_row"] = result["grad_rel_l2"] <= TRAIN_GRAD_REL_BOUND

    def qlora(label, cfg, model, batch):
        """One QLoRA step over ``model``'s int8 weight-only decoder: bf16
        adapters r 64 / alpha 16 on the reference's seven targets, projector
        and region extractor co-trained at lr 2e-5 (bench_train.py's qlora
        stage)."""
        lcfg = LoraConfig(r=64, alpha=16.0)
        model.adapters = init_lora(model.llm, lcfg, torch.Generator(device=dev).manual_seed(1), dtype=torch.bfloat16)
        names = [n for n, _ in model.adapters.items()]
        lc = cfg.llm
        if lc.is_moe:
            checks[f"{label}_every_expert_adapted_router_not"] = (
                sum(".experts." in n for n in names) == lc.num_hidden_layers * lc.num_experts * 3
                and not any(n.endswith("block_sparse_moe.gate") for n in names))
        trainable = nn.ModuleDict({"adapters": model.adapters, "mm_projector": model.mm_projector,
                                   "region_extractor": model.region_extractor})
        optimizer = build_optimizer(trainable, OptimizerConfig(learning_rate=2e-5, total_steps=100))
        step_fn = make_lora_train_step(cfg, optimizer, lcfg, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
        want = {**attention_train_counts(cfg), **qlora_quant_counts(cfg, TRAIN_ROWS)}
        stepped(label, cfg, model, step_fn, create_train_state(model, optimizer), batch, trainable, want, n_steps=1)
        runs[label]["lora"] = {"r": lcfg.r, "alpha": lcfg.alpha, "adapters": len(names),
                               "adapter_parameters": sum(p.numel() for p in model.adapters.parameters())}
        del model.adapters

    # ---- gemma-7b and mistral-7b: bf16 align, then QLoRA ----
    for name in ("gemma-7b", "mistral-7b"):
        cfg = family_train_cfg(name)
        batch, one_row = batches(cfg)
        t0 = time.perf_counter()
        model = init_random(cfg, dev, torch.bfloat16, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        optimizer = build_optimizer(model, align_ocfg)
        full = vs_plain(cfg, model, one_row)
        depth = FAMILY_TRAIN_CHECK_DEPTH.get(name)
        label = f"{name}_bf16_align"
        step_fn = make_train_step(cfg, optimizer, attn_impl="pallas", remat=True, frozen=("llm", "vision"),
                                  ce_chunk=CE_CHUNK)
        trainable = nn.ModuleDict({"mm_projector": model.mm_projector, "region_extractor": model.region_extractor})
        stepped(label, cfg, model, step_fn, create_train_state(model, optimizer), batch, trainable,
                {**attention_train_counts(cfg), **NO_QUANT})
        runs[label]["init_s"] = init_s
        runs[label]["vs_plain_one_row_full_depth"] = full
        if depth is None:
            held_vs_plain(label, full)
        layers.quantize_model(model, bits=8)  # train.main's --bits 8 (train/train.py:108-109)
        torch.cuda.empty_cache()
        qlora(f"{name}_qlora", cfg, model, batch)
        del model, optimizer, step_fn, trainable
        release(torch)
        if depth is not None:
            short = family_train_cfg(name, num_hidden_layers=depth)
            model = init_random(short, dev, torch.bfloat16, seed=0)
            build_optimizer(model, align_ocfg)
            runs[label]["vs_plain_one_row"] = {**vs_plain(short, model, batches(short)[1]), "layers": depth}
            held_vs_plain(label, runs[label]["vs_plain_one_row"])
            del model
            release(torch)
        del batch, one_row

    # ---- mixtral-8x7b over a frozen W8A8 base, 32 layers ----
    cfg = family_train_cfg("mixtral-8x7b")
    batch, one_row = batches(cfg)
    t0 = time.perf_counter()
    model = init_random_quantized(cfg, dev, w8a8=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    build_optimizer(model, align_ocfg)
    tuned = tuned_of(model)
    tuned_init = {n: {k: v.detach().clone() for k, v in getattr(model, n).state_dict().items()}
                  for n in ("mm_projector", "region_extractor")}
    for quant in (1, 2):
        label = f"mixtral-8x7b_w8a8_quant{quant}"
        for n, state in tuned_init.items():  # each setting from the same start
            getattr(model, n).load_state_dict(state)
        layers.enable_int8_backward(quant == 2)
        try:
            m_k, m_p = {}, {}
            loss_k, g_k = loss_and_grads(torch, cfg, model, one_row, tuned, metrics=m_k)
            _, g_k2 = loss_and_grads(torch, cfg, model, one_row, tuned)
            with plain_projections():
                loss_p, g_p = loss_and_grads(torch, cfg, model, one_row, tuned, metrics=m_p)
            run_to_run, vs = rel_l2(g_k2, g_k), rel_l2(g_k, g_p)
            del g_k, g_k2, g_p
            optimizer = build_optimizer(model, align_ocfg)
            step_fn = make_frozen_base_train_step(cfg, optimizer, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
            trainable = nn.ModuleDict({"mm_projector": model.mm_projector, "region_extractor": model.region_extractor})
            want = {**attention_train_counts(cfg), **align_quant_counts(cfg, TRAIN_ROWS, quant == 2)}
            stepped(label, cfg, model, step_fn, create_train_state(model, optimizer), batch, trainable, want)
        finally:
            layers.enable_int8_backward(False)
        checks[f"{label}_loss_bit_equal_to_plain_route"] = torch.equal(loss_k, loss_p)
        checks[f"{label}_router_aux_bit_equal_to_plain_route"] = m_k["router_aux_loss"] == m_p["router_aux_loss"] > 0
        checks[f"{label}_grads_vs_plain_route"] = vs <= RUN_TO_RUN_FACTOR * run_to_run
        checks[f"{label}_int8_backward_kernels"] = all(
            (r["launches"]["int8_dx_gemm"] > 0) == (quant == 2) for r in runs[label]["steps"])
        runs[label].update(init_s=init_s, vs_plain_route_one_row={
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "router_aux_kernel": m_k["router_aux_loss"],
            "router_aux_plain": m_p["router_aux_loss"], "grad_rel_l2": vs, "grad_rel_l2_kernel_route_run_to_run": run_to_run})
        runs[label]["weights_gb"] = sum(t.numel() * t.element_size() for t in model.llm.state_dict().values()) / 1e9
    del model, optimizer, step_fn, trainable, tuned
    release(torch)
    cfg = family_train_cfg("mixtral-8x7b", num_hidden_layers=MIXTRAL_QLORA_LAYERS)
    model = init_random_quantized(cfg, dev, w8a8=False, seed=0, vision_quant=False)
    qlora("mixtral-8x7b_qlora", cfg, model, batch)
    del model, batch, one_row
    release(torch)

    # ---- train.main from argv ----
    align = list(ALIGN_FLAGS)
    for preset_name, label, extra, quant in (
            ("gemma-7b", "main_gemma-7b_align", [], False),
            ("mistral-7b", "main_mistral-7b_qlora", ["--lora_enable", "true", "--bits", "8"], True)):
        argv = align[:]
        argv[argv.index("--llm_preset") + 1] = preset_name
        cfg = family_cfg(preset_name)
        L = cfg.llm.num_hidden_layers
        want = {**attention_train_counts(cfg), **NO_QUANT}
        if quant:  # remat recomputes all but down; the lm_head once (no CE chunks)
            want["w8_gemm"] = L * (7 + 6) + 1
        counted = {}
        with tempfile.TemporaryDirectory(prefix="famtrain_", dir=os.path.join(ROOT, "build")) as out:
            result, run, peak = recipe_main(torch, argv + FAMILY_MAIN_CUTS + ["--output_dir", out] + extra, counted,
                                            CharTokenizer(LLAMA_PRESETS[preset_name].vocab_size))
            saved = sorted(os.listdir(out))
        totals.append(counted)
        steps_ = run["steps"]
        checks[f"{label}_one_micro_step"] = result == {"status": "timeout", "step": 1} and len(steps_) == 1
        checks[f"{label}_launch_counts"] = bool(steps_) and steps_[0]["launches"] == want
        checks[f"{label}_loss_finite"] = bool(steps_) and math.isfinite(steps_[0]["metrics"]["loss"])
        checks[f"{label}_checkpoint_only"] = saved == ["checkpoint-1", "metrics.jsonl"]
        runs[label] = {"argv_extra": extra, "result": result, "steps": steps_, "launches_expected": want,
                       "saved": saved, "smoke_figures_not_a_benchmark": {
                           "step_s": steps_[0]["seconds"] if steps_ else None, "peak_mem_gb": peak,
                           "card": nvidia_smi}}
        del run
        release(torch)

    emit({"phase": "families_train", "ok": all(checks.values()), "seconds": time.perf_counter() - t_phase,
          "checks": checks, "runs": runs,
          "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                    "regions": N_REGIONS, "rgb_and_depth": True},
          "model": "gemma-7b, mistral-7b (bf16, then int8 weight-only for QLoRA), mixtral-8x7b (W8A8 base at 32 "
                   f"layers; QLoRA at {MIXTRAL_QLORA_LAYERS} of 32 layers) at full width + siglip-so400m (26 of 27 "
                   "layers), random from seed 0"})
    check(all(checks.values()), f"families_train checks failed: {[k for k, v in checks.items() if not v]}")
    return add_counts(*totals)


# synth_train: steps of each trainer, CameraNet's batch, the metric
# Depth-Anything's batch and the learning rates (larger than the CLI's, so
# that the frozen backbone's decay shows in f32)
SYNTH_TRAIN_STEPS = 4
SYNTH_CAMERA_BATCH = 32
SYNTH_DEPTH_BATCH = 2
SYNTH_DEPTH_LR, SYNTH_DEPTH_WD = 1e-3, 0.05


def phase_synth_train(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """``synth/train_calibration.py`` on the card: SYNTH_TRAIN_STEPS steps of
    ``train_camera_net`` at ``CameraNetConfig``'s widths on virtual-camera
    warps of the synth path's photos (``synth_photo``, 480 x 640 and 768 x
    1024), then of ``train_metric_depth`` at ViT-L widths (the metric head,
    max depth 20 m) on an RGBD manifest of the same photos with synthetic
    depths (a tilted plane, a hole of zeros) written as .npy to a temporary
    directory, without and with ``freeze_backbone``; each from random f32
    weights, in the default LayerNorm (no kernel of the port runs: the
    reference runs this module in XLA).  Checks finite losses, that the
    trained weights move, and that under ``freeze_backbone`` the backbone
    equals its start times prod(1 - lr_t weight_decay) (the reference's
    decay of a stopped parameter) while the head learns.  Reports the loss
    histories, seconds a step and peak memory."""
    import numpy as np
    from PIL import Image

    from spatialrgpt_tpu_torch.demo.pipeline import synth_photo
    from spatialrgpt_tpu_torch.models.depth_anything import DepthAnythingConfig
    from spatialrgpt_tpu_torch.synth import train_calibration as tc
    from spatialrgpt_tpu_torch.synth.calibration import CameraNetConfig
    from spatialrgpt_tpu_torch.utils.weights import init_random_camera_net, init_random_depth_anything

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    checks, runs = {}, {}
    rng = np.random.default_rng(0)
    photos = [synth_photo(rng, h, w) for h, w in SYNTH_HW[:4]]
    reset_counts()

    def timed(fn):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

    ccfg = CameraNetConfig()
    cam = init_random_camera_net(ccfg, dev, torch.float32, seed=0)
    start = cam.head.weight.detach().clone()
    (_, hist), seconds, peak = timed(lambda: tc.train_camera_net(
        photos, ccfg, steps=SYNTH_TRAIN_STEPS, batch_size=SYNTH_CAMERA_BATCH, lr=3e-4, warmup=1, log_every=1,
        model=cam))
    checks["camera_losses_finite"] = len(hist) == SYNTH_TRAIN_STEPS and all(map(math.isfinite, hist))
    checks["camera_moved"] = not torch.equal(cam.head.weight, start)
    runs["camera_net"] = {"config": dataclasses.asdict(ccfg), "batch": SYNTH_CAMERA_BATCH, "losses": hist,
                          "smoke_figures_not_a_benchmark": {"s_per_step": seconds / SYNTH_TRAIN_STEPS,
                                                            "peak_mem_gb": peak, "card": nvidia_smi}}
    del cam
    release(torch)

    dcfg = DepthAnythingConfig(metric=True, max_depth=20.0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="synth_train_", dir=os.path.join(ROOT, "build")) as work:
        lines = []
        for i, img in enumerate(photos):
            h, w = img.shape[:2]
            depth = (2.0 + 8.0 * np.linspace(0, 1, h)[:, None] + 0.5 * np.linspace(0, 1, w)[None]).astype(np.float32)
            depth[: h // 8, : w // 8] = 0.0
            Image.fromarray(img).save(os.path.join(work, f"p{i}.png"))
            np.save(os.path.join(work, f"d{i}.npy"), depth)
            lines.append(json.dumps({"image": os.path.join(work, f"p{i}.png"), "depth": os.path.join(work, f"d{i}.npy"),
                                     "fx": 0.8 * w}))
        manifest = os.path.join(work, "manifest.jsonl")
        with open(manifest, "w") as f:
            f.write("\n".join(lines) + "\n")
        lrs = [0.0] + [SYNTH_DEPTH_LR * 0.5 * (1 + math.cos(math.pi * t / (SYNTH_TRAIN_STEPS - 1)))
                       for t in range(SYNTH_TRAIN_STEPS - 1)]  # warmup 1, then the cosine
        shrink = math.prod(1 - lr * SYNTH_DEPTH_WD for lr in lrs)
        for freeze in (False, True):
            label = "metric_depth_freeze_backbone" if freeze else "metric_depth"
            model = init_random_depth_anything(dcfg, dev, torch.float32, seed=2)
            w_bb = model.backbone.encoder.layer[0].mlp.fc1.weight
            bb0, head0 = w_bb.detach().clone(), model.head.conv3.weight.detach().clone()
            (_, hist), seconds, peak = timed(lambda: tc.train_metric_depth(
                manifest, dcfg, model=model, steps=SYNTH_TRAIN_STEPS, batch_size=SYNTH_DEPTH_BATCH,
                lr=SYNTH_DEPTH_LR, weight_decay=SYNTH_DEPTH_WD, warmup=1, log_every=1, freeze_backbone=freeze))
            decayed = (bb0.double() * shrink).float()
            decay_err = float(((w_bb.detach() - decayed).abs() / decayed.abs().clamp(min=1e-30)).max())
            checks[f"{label}_losses_finite"] = len(hist) == SYNTH_TRAIN_STEPS and all(map(math.isfinite, hist))
            checks[f"{label}_head_moved"] = not torch.equal(model.head.conv3.weight, head0)
            if freeze:
                checks[f"{label}_backbone_decayed_only"] = decay_err <= 2e-6
            else:
                checks[f"{label}_backbone_learned"] = decay_err > 1e-4
            runs[label] = {"config": "ViT-L (24 layers, 1024 wide), metric head, max depth 20 m, f32",
                           "batch": SYNTH_DEPTH_BATCH, "lr": SYNTH_DEPTH_LR, "weight_decay": SYNTH_DEPTH_WD,
                           "losses": hist, "backbone_vs_decay_only_max_rel": decay_err, "decay_factor": shrink,
                           "smoke_figures_not_a_benchmark": {"s_per_step": seconds / SYNTH_TRAIN_STEPS,
                                                             "peak_mem_gb": peak, "card": nvidia_smi}}
            del model, w_bb
            release(torch)
    counts = read_counts()
    checks["no_kernel_launched"] = not any(counts.values())
    emit({"phase": "synth_train", "ok": all(checks.values()), "seconds": time.perf_counter() - t_phase,
          "checks": checks, "runs": runs, "photos": [list(p.shape[:2]) for p in photos]})
    check(all(checks.values()), f"synth_train checks failed: {[k for k, v in checks.items() if not v]}")
    return counts


def serve_runner_lengths(torch, cfg, batch: dict) -> list:
    """The live prompt lengths of ``serve_runner``'s batch."""
    import numpy as np

    _, plens = splice(torch, cfg, *draw_rows(cfg, np.random.default_rng(0), 1, batch["text_tokens"]),
                      batch["bucket"])
    return plens.tolist()


def local_tensor(t):
    """A DTensor's local shard (an FSDP-sharded model's parameter; the whole
    tensor on one rank), a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def state_fingerprint(torch, module) -> list:
    """Per tensor of the module's state (parameters and buffers: int8
    weights and their scales too), the int64 sum of its bytes."""
    return [int(local_tensor(t).detach().reshape(-1).view(torch.uint8).sum(dtype=torch.int64))
            for t in module.state_dict().values()]


def loss_and_grads(torch, cfg, model, batch, params, attn_impl: str = "pallas", metrics=None):
    """The align-style loss on ``batch`` (remat, chunked CE) and the
    gradients of ``params`` concatenated in f32; ``metrics``, a dict, gets
    the loss's metrics (an MoE decoder's ``router_aux_loss`` among them)."""
    from spatialrgpt_tpu_torch.models import vlm

    for p in params:
        p.grad = None
    loss, got = vlm.loss_fn(model, cfg, batch, attn_impl=attn_impl, remat=True, ce_chunk=CE_CHUNK)
    if metrics is not None:
        metrics.update((k, float(v.detach())) for k, v in got.items())
    loss.backward()
    grads = torch.cat([p.grad.float().flatten() for p in params])
    for p in params:
        p.grad = None
    return loss.detach(), grads


def attention_train_counts(cfg) -> dict:
    """K1-K6 launches of one align-style step (remat): the frozen tower's
    forward, K4's forward twice per decoder layer and its backward once."""
    L = cfg.llm.num_hidden_layers
    return {"vit_attention": tower_layers(cfg), "onepass_attention": 0, "decode_attention_int8_flat": 0,
            "decode_attention_int4_flat": 0,
            "flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L, "flash_attention_bwd_dq": L,
            "grid_bias_attention": 0, "fused_layer_norm": 0}


def phase_train(torch, profile_dir):
    import numpy as np

    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_train_step
    from spatialrgpt_tpu_torch.train.trainer import Trainer, TrainerConfig
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # stage-1 align (bench_train.py:178-185)
    ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                           tune_mm_projector=True, tune_region_extractor=True, total_steps=100)
    optimizer = build_optimizer(model, ocfg)
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)

    # kernel path against the plain path (K1's and K4's plain versions) on
    # one row: the plain attention holds (1, 8, 4, 4096, 4096) f32 scores
    # per layer, which for 4 rows would not fit beside the model
    tuned_params = [p for m in (model.mm_projector, model.region_extractor) for p in m.parameters()]
    compare = {impl: loss_and_grads(torch, cfg, model, one_row, tuned_params, impl) for impl in ("pallas", "xla")}
    loss_rel = abs(float(compare["pallas"][0]) - float(compare["xla"][0])) / abs(float(compare["xla"][0]))
    grad_rel = rel_l2(compare["pallas"][1], compare["xla"][1])
    del compare
    torch.cuda.empty_cache()

    frozen_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    tuned = lambda: state_fingerprint(torch, model.mm_projector) + state_fingerprint(torch, model.region_extractor)  # noqa: E731
    tuned_before = tuned()
    step_fn = make_train_step(cfg, optimizer, attn_impl="pallas", remat=True, frozen=("llm", "vision"),
                              ce_chunk=CE_CHUNK)
    record = []

    def observed_step(state, b):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        record.append({"seconds": seconds, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "num_tokens": int(metrics["num_tokens"]), "tuned_changed": tuned() != tuned_before,
                       "launches": {n: after[n] - before[n] for n in after}})
        return state, metrics

    want_step = {**attention_train_counts(cfg), **NO_QUANT}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out_dir:
        saved = []

        def save_tuned(root, state):  # the align stage's output: projector + region extractor
            for name in ("mm_projector", "region_extractor"):
                os.makedirs(os.path.join(root, name), exist_ok=True)
                torch.save(getattr(state.model, name).state_dict(), os.path.join(root, name, "pytorch_model.bin"))
                saved.append(name)

        tcfg = TrainerConfig(output_dir=out_dir, max_steps=TRAIN_STEPS, save_steps=2, log_steps=1)
        trainer = Trainer(cfg, tcfg, observed_step, create_train_state(model, optimizer),
                          (batch for _ in range(TRAIN_STEPS)), save_final_fn=save_tuned)
        reset_counts()
        result = trainer.train()
        counts = read_counts()
        ckpt = sorted(os.listdir(out_dir))
        ckpt_files = sorted(os.listdir(os.path.join(out_dir, "checkpoint-2"))) if "checkpoint-2" in ckpt else []
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    first_loss = record[0]["loss"] if record else float("nan")
    checks = {
        "trainer_completed": result == {"status": "completed", "step": TRAIN_STEPS} and logged == [1, 2, 3],
        "checkpoint_saved": "checkpoint-2" in ckpt and ckpt_files == ["opt.pt", "state.pt", "trainer_state.json"]
        and saved == ["mm_projector", "region_extractor"],
        "launch_counts_every_step": len(record) == TRAIN_STEPS and all(r["launches"] == want_step for r in record),
        "first_loss_near_ln_vocab": math.isfinite(first_loss) and abs(first_loss - math.log(vocab)) < 1.0,
        "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
        "frozen_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f for n, f in frozen_before.items()),
        "tuned_unchanged_at_lr_0": bool(record) and not record[0]["tuned_changed"],
        "tuned_moved_after": len(record) == TRAIN_STEPS and record[-1]["tuned_changed"],
        "loss_vs_plain": loss_rel <= TRAIN_LOSS_REL_BOUND,
        "grads_vs_plain": grad_rel <= TRAIN_GRAD_REL_BOUND,
    }
    step_s = statistics.median(r["seconds"] for r in record[1:]) if len(record) > 1 else float("nan")
    emit({
        "phase": "train", "ok": all(checks.values()), "checks": checks,
        "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), bf16, random from seed 0",
        "stage": "align: frozen llm + vision tower, tuned mm_projector + region_extractor, lr 1e-3, remat, "
                 f"ce_chunk {CE_CHUNK}, attn_impl pallas",
        "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                  "regions": N_REGIONS, "images": TRAIN_ROWS * TRAIN_SAMPLES_PER_ROW, "rgb_and_depth": True},
        "launches": counts, "launches_expected_per_step": want_step, "steps": record,
        "first_loss": first_loss, "ln_vocab": math.log(vocab),
        "vs_plain_one_row": {"loss_rel": loss_rel, "loss_bound": TRAIN_LOSS_REL_BOUND,
                             "grad_rel_l2": grad_rel, "grad_bound": TRAIN_GRAD_REL_BOUND},
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "step_s_median_after_first": step_s,
            "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / step_s, "peak_mem_gb": peak_gb,
        },
    })
    check(all(checks.values()), f"train checks failed: {checks}")
    if profile_dir:
        state = create_train_state(model, optimizer)
        profile_run(torch, lambda: step_fn(state, batch), profile_dir, "train_step")
    return counts


def cosine(a, b) -> float:
    return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))


def run_steps(torch, step_fn, state, batch, moved, want_step, n_steps: int = TRAIN_STEPS):
    """``n_steps`` steps of ``step_fn`` on ``batch``: per step the seconds
    (host clock around a synchronised step), loss (an MoE decoder's router
    aux loss too), grad norm, whether the tuned modules have moved
    (``moved()``) and the kernels' launches."""
    record = []
    for _ in range(n_steps):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        launches = {n: after[n] - before[n] for n in after}
        record.append({"seconds": seconds, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "num_tokens": int(metrics["num_tokens"]), "tuned_moved": moved(),
                       "launches_as_expected": launches == want_step, "launches": launches,
                       **({"router_aux_loss": float(metrics["router_aux_loss"])} if "router_aux_loss" in metrics
                          else {})})
    return state, record


def step_figures(record, peak_gb) -> dict:
    """The median of steps 2-3 (the first carries the first calls' set-up),
    tokens/s at TRAIN_ROWS x TRAIN_SEQ tokens a step, the steps' peak."""
    step_s = statistics.median(r["seconds"] for r in record[1:])
    return {"step_s_median_of_steps_2_3": step_s, "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / step_s,
            "peak_mem_gb_steps": peak_gb}


# the int8 route's gradients against the plain route's on one row: the
# forward is deterministic (K7, K8 exact), so the loss must be bit-equal;
# the gradients too where the kernel route equals itself run twice, and
# otherwise within this many times its own run-to-run distance
RUN_TO_RUN_FACTOR = 2.0
# QLoRA's K9 route against its plain route: at most this many times the
# plain route's distance from itself with K9's sums regrouped
SUM_ORDER_FACTOR = 2.0


def phase_align_w8a8(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench_train.py with SRGPT_TRAIN_BENCH_QUANT=1, then =2, on one model:
    the stage-1 align step over a W8A8 decoder and tower (``quantize_model``
    of ``init_random``'s bf16 weights, as bench_train.py quantizes its
    params), projector and region extractor trained at lr 1e-3, remat,
    CE chunks of 1024, pallas attention, on phase train's batch.  Each
    setting starts from the same projector and region extractor, as each
    is a run of its own of bench_train.py.  For each:
    (i) the quantized route (K7, K8; K10, K11 under =2) against its plain
    versions, attention kernels on in both, on one row: the loss bit-equal
    and the tuned gradients as ``RUN_TO_RUN_FACTOR`` says; (ii) reported
    without a bound: the cosine of the tuned gradients against the bf16
    align step's on the same row (the reference gates > 0.95 on
    trained-scale weights, tests/test_misc.py:278-320; random weights may
    be chaotic); (iii) reported without a bound: ``dx_depth_witness``, the
    int8 dx against the bf16 STE's by depth on the same forward; then
    three ``make_frozen_base_train_step`` steps with
    their launch counts worked out from the shapes, the frozen base
    bit-unchanged, the tuned modules moving once the lr is above 0."""
    import numpy as np

    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_frozen_base_train_step
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = init_random(cfg, dev, torch.bfloat16, seed=0)
    ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                           tune_mm_projector=True, tune_region_extractor=True, total_steps=100)
    build_optimizer(model, ocfg)  # requires_grad on the tuned modules only
    tuned = [p for m in (model.mm_projector, model.region_extractor) for p in m.parameters()]
    n_proj = sum(p.numel() for p in model.mm_projector.parameters())
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)
    _, g_bf16 = loss_and_grads(torch, cfg, model, one_row, tuned)
    layers.quantize_model(model, bits=8, act_quant=True, vision=True)  # bench_train.py:199-204
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    frozen_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    witness = dx_depth_witness(torch, cfg, model, one_row, tuned)
    torch.cuda.empty_cache()
    tuned_init = {name: {k: v.detach().clone() for k, v in getattr(model, name).state_dict().items()}
                  for name in ("mm_projector", "region_extractor")}
    results, counts_all, checks = {}, None, {}
    for quant in (1, 2):
        for name, state in tuned_init.items():  # each setting from the same start, as its own bench_train.py run
            getattr(model, name).load_state_dict(state)
        layers.enable_int8_backward(quant == 2)
        try:
            loss_k, g_k = loss_and_grads(torch, cfg, model, one_row, tuned)
            _, g_k2 = loss_and_grads(torch, cfg, model, one_row, tuned)
            with plain_projections():
                loss_p, g_p = loss_and_grads(torch, cfg, model, one_row, tuned)
            run_to_run = rel_l2(g_k2, g_k)
            vs_plain = rel_l2(g_k, g_p)
            optimizer = build_optimizer(model, ocfg)
            state = create_train_state(model, optimizer)
            step_fn = make_frozen_base_train_step(cfg, optimizer, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
            tuned_before = state_fingerprint(torch, model.mm_projector) + state_fingerprint(torch, model.region_extractor)
            moved = lambda: (state_fingerprint(torch, model.mm_projector)  # noqa: E731
                             + state_fingerprint(torch, model.region_extractor)) != tuned_before
            want_step = {**attention_train_counts(cfg), **align_quant_counts(cfg, TRAIN_ROWS, quant == 2)}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            state, record = run_steps(torch, step_fn, state, batch, moved, want_step)
            counts = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if profile_dir:
                profile_run(torch, lambda: step_fn(state, batch), profile_dir, f"align_w8a8_quant{quant}_step")
        finally:
            layers.enable_int8_backward(False)
        counts_all = counts if counts_all is None else add_counts(counts_all, counts)
        q_checks = {
            "loss_bit_equal_to_plain_route": torch.equal(loss_k, loss_p),
            "grads_vs_plain_route": vs_plain <= RUN_TO_RUN_FACTOR * run_to_run,
            "launch_counts_every_step": all(r["launches_as_expected"] for r in record),
            "int8_backward_kernels": all((r["launches"]["int8_dx_gemm"] > 0) == (quant == 2) for r in record),
            "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
            "tuned_unchanged_at_lr_0": not record[0]["tuned_moved"],
            "tuned_moved_after": record[-1]["tuned_moved"],
            "frozen_base_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f
                                             for n, f in frozen_before.items()),
        }
        checks.update({f"quant{quant}_{k}": v for k, v in q_checks.items()})
        results[f"SRGPT_TRAIN_BENCH_QUANT={quant}"] = {
            "checks": q_checks, "launches_expected_per_step": want_step, "steps": record,
            "vs_plain_route_one_row": {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                                       "grad_rel_l2": vs_plain, "grad_rel_l2_kernel_route_run_to_run": run_to_run},
            "grad_cosine_vs_bf16_align_one_row_no_bound": {
                "all": cosine(g_k, g_bf16), "mm_projector": cosine(g_k[:n_proj], g_bf16[:n_proj]),
                "region_extractor": cosine(g_k[n_proj:], g_bf16[n_proj:])},
            "smoke_figures_not_a_benchmark": {**step_figures(record, peak_gb), "card": nvidia_smi},
        }
        del g_k, g_k2, g_p
        torch.cuda.empty_cache()
    emit({"phase": "align_w8a8", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision "
                   "tower quantized from init_random's bf16 weights (seed 0)",
          "stage": "align over a frozen W8A8 base: tuned mm_projector + region_extractor, lr 1e-3, remat, "
                   f"ce_chunk {CE_CHUNK}, attn_impl pallas (bench_train.py SRGPT_TRAIN_BENCH_QUANT=1, then =2)",
          "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                    "regions": N_REGIONS, "rgb_and_depth": True},
          "init_and_quantize_s": init_s, **results,
          "int8_dx_vs_bf16_ste_by_depth_one_row_no_bound": witness})
    check(all(checks.values()), f"align_w8a8 checks failed: {checks}")
    return counts_all


def phase_qlora(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench_train.py's qlora stage at llama3-8b: an int8 weight-only
    decoder with its lm_head made straight into the int8 layout
    (``init_random_quantized(w8a8=False, vision_quant=False)``, no bf16
    copy of the decoder on the card), bf16 tower, LoRA r 64, alpha 16 on the
    seven projections, bf16 adapters, projector and region extractor
    co-trained, the default ``OptimizerConfig`` (lr 2e-5, total 100), remat,
    CE chunks of 1024, pallas attention, on phase train's batch.  The
    kernel route (K9) against the plain route (K9's plain version) on one
    row, with every b drawn nonzero for the comparison (b = 0 at init would
    make the side branch's addend zero), then set back to 0: the loss
    within phase train's 1%, and the trained gradients no farther from the
    plain route's than ``SUM_ORDER_FACTOR`` times the plain route's own
    distance when its K9 sums are regrouped (``k9_plain_variant``): K9 sums
    f32 in another order than its plain version, and through 32 layers of
    random uniform int8 weights a difference of summation order alone moves
    the gradients by a share that only a run can say (0.118 relative L2 in
    a first H100 run).  Two wrong routes run through the same comparison
    and must fail it: K9's sums held in bf16, and the addend dropped.  Then
    three ``make_lora_train_step`` steps with their launch counts, the base
    bit-unchanged, and only the adapters, projector and region extractor
    moving."""
    import numpy as np
    from torch import nn

    from spatialrgpt_tpu_torch.train.lora import LoraConfig, apply_lora, init_lora, replace_modules
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_lora_train_step
    from spatialrgpt_tpu_torch.utils.weights import init_random_quantized

    cfg = llama3_8b_cfg()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = init_random_quantized(cfg, dev, w8a8=False, seed=0, vision_quant=False)
    lcfg = LoraConfig(r=64, alpha=16.0)  # bench_train.py:152-157, the 8B row's bf16 adapters
    model.adapters = init_lora(model.llm, lcfg, torch.Generator(device=dev).manual_seed(1), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainable = nn.ModuleDict({"adapters": model.adapters, "mm_projector": model.mm_projector,
                               "region_extractor": model.region_extractor})
    optimizer = build_optimizer(trainable, OptimizerConfig(learning_rate=2e-5, total_steps=100))
    params = list(trainable.parameters())
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)
    view = replace_modules(model, {"llm": apply_lora(model.llm, model.adapters, lcfg, merge=False)})
    g_b = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():  # b ~ N(0, 1 / r): the side branch ~ 15% of a projection's output
        for _, pair in model.adapters.items():
            pair.b.copy_(torch.randn(pair.b.shape, generator=g_b, device=dev) * lcfg.r**-0.5)
    loss_k, g_k = loss_and_grads(torch, cfg, view, one_row, params)
    routes = {}
    with plain_projections():
        loss_p, g_p = loss_and_grads(torch, cfg, view, one_row, params)
        for variant in ("regrouped", "bf16_sums", "no_addend"):
            with k9_plain_variant(torch, variant):
                loss_v, g_v = loss_and_grads(torch, cfg, view, one_row, params)
            routes[variant] = {"loss_rel": abs(float(loss_v) - float(loss_p)) / abs(float(loss_p)),
                               "grad_rel_l2": rel_l2(g_v, g_p)}
            del g_v
    with torch.no_grad():
        for _, pair in model.adapters.items():
            pair.b.zero_()
    del view
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel, grad_bound = rel_l2(g_k, g_p), SUM_ORDER_FACTOR * routes["regrouped"]["grad_rel_l2"]
    del g_k, g_p
    torch.cuda.empty_cache()
    base_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    parts_before = {name: state_fingerprint(torch, module) for name, module in trainable.items()}
    tuned_before = state_fingerprint(torch, trainable)
    state = create_train_state(model, optimizer)
    step_fn = make_lora_train_step(cfg, optimizer, lcfg, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
    want_step = {**attention_train_counts(cfg), **qlora_quant_counts(cfg, TRAIN_ROWS)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, record = run_steps(torch, step_fn, state, batch, lambda: state_fingerprint(torch, trainable) != tuned_before,
                              want_step)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {
        "loss_vs_plain_route": loss_rel <= TRAIN_LOSS_REL_BOUND,
        "grads_vs_plain_route": grad_rel <= grad_bound,
        "control_bf16_sums_fails_the_comparison": routes["bf16_sums"]["grad_rel_l2"] > grad_bound,
        "control_no_addend_fails_the_comparison": routes["no_addend"]["grad_rel_l2"] > grad_bound,
        "launch_counts_every_step": all(r["launches_as_expected"] for r in record),
        "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
        "trained_unchanged_at_lr_0": not record[0]["tuned_moved"],
        "trained_moved_after": record[-1]["tuned_moved"],
        "adapters_projector_region_each_moved": all(state_fingerprint(torch, trainable[name]) != f
                                                    for name, f in parts_before.items()),
        "base_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f for n, f in base_before.items()),
        "no_float_decoder_weight": not any(isinstance(m, nn.Linear) for m in model.llm.modules()),
    }
    emit({"phase": "qlora", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width): int8 weight-only decoder and lm_head made in the int8 layout "
                   "(init_random_quantized, seed 0) + siglip-so400m (26 of 27 layers) bf16",
          "stage": f"QLoRA: LoRA r {lcfg.r} alpha {lcfg.alpha} on {list(lcfg.targets)}, bf16 adapters "
                   f"({sum(p.numel() for p in model.adapters.parameters())} parameters), mm_projector + "
                   f"region_extractor co-trained, lr 2e-5, remat, ce_chunk {CE_CHUNK}, attn_impl pallas",
          "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                    "regions": N_REGIONS, "rgb_and_depth": True},
          "launches": counts, "launches_expected_per_step": want_step, "steps": record,
          "vs_plain_route_one_row": {"b": "drawn N(0, 1/r) for the comparison, then set back to 0",
                                     "loss_rel": loss_rel, "loss_bound": TRAIN_LOSS_REL_BOUND,
                                     "grad_rel_l2": grad_rel, "grad_bound": grad_bound,
                                     "plain_route_variants": routes,
                                     "bf16_sums_rounded_every_k_columns": BF16_SUM_COLUMNS},
          "smoke_figures_not_a_benchmark": {**step_figures(record, peak_gb), "init_s": init_s, "card": nvidia_smi}})
    check(all(checks.values()), f"qlora checks failed: {checks}")
    if profile_dir:
        profile_run(torch, lambda: step_fn(state, batch), profile_dir, "qlora_step")
    return counts


# ---------------------------------------------------------------------------
# recipe: the training entry point, train/train.py::main
# ---------------------------------------------------------------------------

LLAMA3_VOCAB = 128256  # the Llama-3 tokenizer's size: <mask> and <depth> are added past it
# scripts/srgpt/llama3_8b/1_mm_align.sh's flags (its base model and output
# directory aside), with the recipe phase's cuts after them
ALIGN_FLAGS = [
    "--llm_preset", "llama3-8b", "--conv_template", "llama_3", "--vision_tower", "siglip-so400m-patch14-384",
    "--mm_vision_select_feature", "cls_patch", "--mm_vision_select_layer", "-2", "--mm_projector", "mlp_downsample",
    "--enable_region", "true", "--enable_depth", "true", "--region_extractor", "regiongpt",
    "--tune_vision_tower", "false", "--tune_mm_projector", "true", "--tune_language_model", "false",
    "--tune_region_extractor", "true", "--image_aspect_ratio", "resize", "--per_device_train_batch_size", "32",
    "--learning_rate", "1e-3", "--model_max_length", "4096", "--save_steps", "100", "--save_total_limit", "1",
    "--logging_steps", "1", "--dp_size", "1", "--fsdp_size", "1",
]
RECIPE_CUTS = ["--data_mixture", "dummy", "--gradient_accumulation_steps", "2", "--max_steps", "4", "--save_steps", "2"]
RECIPE_RESUME_STEPS = 6
# the recipe phase's depth of llama3-8b's full widths: each of its runs
# writes or reads a composite of the whole model, 16.6 GB at 32 layers; 4
# layers keep the whole script well inside its time limit
RECIPE_LAYERS = 4
DPO_PAIRS, DPO_BATCH = 4, 2


class CharTokenizer:
    """A character tokenizer of Llama-3's size (the tests' FakeTokenizer,
    ``tests/test_templates.py:18``): each template special string one
    token, every other character one token, no BOS prepended (the llama_3
    template writes its own), and the HF methods ``load_tokenizer`` calls;
    ``add_tokens`` appends past ``size``."""

    SPECIALS = ["<|begin_of_text|>", "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>", "<|end_of_text|>",
                "</s>", "<s>", "[/INST]", "[INST]"]

    def __init__(self, size: int = LLAMA3_VOCAB):
        self.specials = list(self.SPECIALS)
        self.vocab = {s: 1000 + i for i, s in enumerate(self.specials)}
        self.size = size
        self.bos_token_id, self.eos_token_id, self.pad_token_id = 1, 2, 0
        self.model_max_length = 4096

    def __len__(self) -> int:
        return self.size

    def __call__(self, text, **kw):
        ids, i = [], 0
        while i < len(text):
            for s in self.specials:
                if text.startswith(s, i):
                    ids.append(self.vocab[s])
                    i += len(s)
                    break
            else:
                ids.append(3 + ord(text[i]) % 900)
                i += 1
        return argparse.Namespace(input_ids=ids)

    def add_tokens(self, tokens, special_tokens=False) -> int:
        new = [t for t in tokens if t not in self.vocab]
        for t in new:
            self.vocab[t], self.size = self.size, self.size + 1
        self.specials += new
        return len(new)

    def convert_tokens_to_ids(self, token) -> int:
        return self.vocab[token]

    def decode(self, ids, skip_special_tokens=False) -> str:
        """The tests' FakeTokenizer.decode: a special string back, or left
        out with ``skip_special_tokens``; any other id one character."""
        inv = {v: k for k, v in self.vocab.items()}
        out = []
        for t in map(int, ids):
            if t in (self.bos_token_id, self.eos_token_id, self.pad_token_id) or t in inv:
                if not skip_special_tokens:
                    out.append(inv.get(t, f"<{t}>"))
            else:
                out.append(chr((t - 3) % 900))
        return "".join(out)


@contextlib.contextmanager
def observed_trainers(torch):
    """``train/train.py``'s ``Trainer`` replaced, inside the block, by a
    subclass that watches each run ``main`` makes: per step the seconds
    (host clock around a synchronised step), the kernels' launches, the
    metrics, the rows and live tokens of the batch and whether the
    optimizer's parameters moved; the frozen modules' fingerprints before
    and after the run; what a resume restored.  Yields the list of runs;
    each holds its trainer (its model) until the list is cleared."""
    from spatialrgpt_tpu_torch.train import train as train_mod

    base_cls, runs = train_mod.Trainer, []

    def trained_fp(state):
        return [int(local_tensor(p).detach().reshape(-1).view(torch.uint8).sum(dtype=torch.int64))
                for g in state.optimizer.param_groups for p in g["params"]]

    class Observed(base_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            model = self.state.model
            rec = {"trainer": self, "steps": [], "resumed": None,
                   "frozen_before": {n: state_fingerprint(torch, getattr(model, n)) for n in ("llm", "vision_tower")}}
            if hasattr(self.state, "ref_model"):  # DPO's reference copy: its own clones of the trained modules
                rec["reference_before"] = state_fingerprint(torch, self.state.ref_model)
            runs.append(rec)
            inner = self.train_step

            def step(state, batch):
                before, fp = read_counts(), trained_fp(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = inner(state, batch)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                after = read_counts()
                parts = (batch,) if hasattr(batch, "input_ids") else batch  # DPO: (chosen, rejected)
                rec["steps"].append({
                    "seconds": seconds, "metrics": {k: float(v) for k, v in metrics.items()},
                    "rows": [int(b.input_ids.shape[0]) for b in parts],
                    "live_tokens": [int((b.segment_ids != 0).sum()) for b in parts],
                    "images": [int(b.images.shape[0]) for b in parts],
                    "trained_moved": trained_fp(state) != fp, "launches": {n: after[n] - before[n] for n in after},
                })
                return state, metrics

            self.train_step = step

        def load_checkpoint(self, path):
            step = super().load_checkpoint(path)
            opt = self.state.optimizer
            runs[-1]["resumed"] = {"step": step, "mini_step": getattr(opt, "mini_step", None),
                                   "gradient_step": getattr(opt, "gradient_step", None),
                                   "accumulator_zero": all(not bool(a.any()) for a in getattr(opt, "acc", []))}
            return step

    train_mod.Trainer = Observed
    try:
        yield runs
    finally:
        train_mod.Trainer = base_cls


def frozen_unchanged(torch, rec) -> bool:
    model = rec["trainer"].state.model
    return all(state_fingerprint(torch, getattr(model, n)) == f for n, f in rec["frozen_before"].items())


def recipe_figures(rec, nvidia_smi: str, peak_gb: float) -> dict:
    """The median step after the first, positions/s (rows x 4096 a step)
    and live tokens/s, the run's peak."""
    steps = rec["steps"][1:] or rec["steps"]
    step_s = statistics.median(s["seconds"] for s in steps)
    positions = statistics.median(sum(s["rows"]) * TRAIN_SEQ for s in steps)
    live = statistics.median(sum(s["live_tokens"]) for s in steps)
    return {"step_s_median_after_first": step_s, "positions_per_s": positions / step_s, "live_tokens_per_s": live / step_s,
            "peak_mem_gb": peak_gb, "card": nvidia_smi}


def dpo_pairs(out_dir: str) -> str:
    """DPO_PAIRS preference pairs over a PNG each (the card has Pillow:
    ``data/preprocess.py`` decodes them), a region in every prompt."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(4)
    answers = ["a red cube", "two boxes side by side", "the lamp is taller", "the chair", "about 2 meters",
               "about 10 meters", "yes, behind it", "no, in front"]
    rows = []
    for i in range(DPO_PAIRS):
        path = os.path.join(out_dir, f"pair{i}.png")
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(path)
        rows.append({"prompt": f"What is <mask> <depth> next to? ({i})", "chosen": answers[(2 * i) % 8],
                     "rejected": answers[(2 * i + 1) % 8], "image": path})
    path = os.path.join(out_dir, "pairs.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return path


def recipe_main(torch, argv, totals: dict, tokenizer=None):
    """``main(argv)`` as a user calls it on the card (the default device),
    given ``tokenizer`` (default ``CharTokenizer()``: there are no tokenizer
    files), with the counts set to 0 before it and added to ``totals``
    after; -> (result, the observed run, peak GB)."""
    from spatialrgpt_tpu_torch.train import train as train_mod

    torch.cuda.reset_peak_memory_stats()
    with observed_trainers(torch) as runs:
        reset_counts()
        result = train_mod.main(argv, tokenizer=tokenizer or CharTokenizer())
        counts = read_counts()
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n
    check(len(runs) == 1, f"main built {len(runs)} trainers")
    return result, runs[0], torch.cuda.max_memory_allocated() / 1e9


def move_composite(src: str, dst: str) -> None:
    """The final save's files (config.json and the split directories) out
    of ``src``, its checkpoints left in place."""
    from spatialrgpt_tpu_torch.utils.weights import SPLIT_DIRS

    os.makedirs(dst)
    for name in ("config.json",) + SPLIT_DIRS:
        os.replace(os.path.join(src, name), os.path.join(dst, name))


def phase_recipe(torch, nvidia_smi: str) -> dict:
    """``python -m spatialrgpt_tpu_torch.train.train`` at llama3-8b's widths
    (RECIPE_LAYERS of its 32 layers) through ``train.main`` and argv, on the ``dummy`` mixture (32 samples of one
    384 x 384 image, RGB + depth, a region each), with a character
    tokenizer of Llama-3's size and a composite directory of random
    weights (``init_random``, seed 0) as the base model:
    (a) 1_mm_align.sh's flags with 2-step accumulation, 4 micro steps:
        K1 / K4 launches per micro step, the tuned modules moving only on
        micro steps 2 and 4, the frozen ones bit-unchanged; then a second
        ``main`` in the same directory to 6 micro steps that resumes at 4
        with the accumulator restored; then the same flags on
        ``--attn_impl xla`` (stopped after its first step by
        ``--total_time_limit``), whose first loss the kernel route's must
        match within 1%;
    (b) QLoRA: ``--lora_enable --bits 8``, r 64 / alpha 16, 2 steps: K9's
        launches (its large form), the int8 base bit-unchanged, the
        adapters moving, ``adapter.npz`` / ``non_lora_trainables.npz``
        loading back equal;
    (c) DPO on DPO_PAIRS pairs with images, 2 pairs a step, 2 steps: the
        first loss ln 2 within 1e-4 and every reward 0 (the policy is its
        reference copy), the second finite;
    (d) the composite that (a)'s first run saved, read back by
        ``load_reference_checkpoint``: logits on one row bit-equal to the
        trained model's;
    (e) the trained model written by ``save_composite_hf`` and read back
        by ``SpatialRGPTConfig.load`` (the reference-composite branch) and
        ``load_reference_checkpoint`` in the trained dtype: the same row's
        logits bit-equal, the top-level config holding ``llm_cfg`` and the
        region tokens."""
    import numpy as np

    from spatialrgpt_tpu_torch import SpatialRGPTConfig, preset
    from spatialrgpt_tpu_torch.models import vlm
    from spatialrgpt_tpu_torch.ops.int8_linear import FORM_LARGE, w8_gemm_form
    from spatialrgpt_tpu_torch.utils.checkpoint import load_pytree, load_reference_checkpoint
    from spatialrgpt_tpu_torch.utils.weights import init_random, save_composite, save_composite_hf

    cfg = preset("llama3-8b")
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, num_hidden_layers=RECIPE_LAYERS))
    dev = torch.device(DEVICE)
    totals, report, checks = {}, {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        base = os.path.join(work, "base")
        t0 = time.perf_counter()
        save_composite(base, init_random(cfg, dev, torch.bfloat16, seed=0), cfg)
        release(torch)
        report["base_composite_s"] = time.perf_counter() - t0
        align = ["--model_name_or_path", base] + ALIGN_FLAGS + RECIPE_CUTS
        attn = attention_train_counts(cfg)

        # (a) stage 1 with accumulation, its composite (d), its resume, its plain route
        out_a = os.path.join(work, "align")
        t0 = time.perf_counter()
        result, run, peak = recipe_main(torch, align + ["--output_dir", out_a], totals)
        wall = time.perf_counter() - t0
        steps = run["steps"]
        loaded = SpatialRGPTConfig.load(out_a)
        opt = torch.load(os.path.join(out_a, "checkpoint-4", "opt.pt"), map_location="cpu")
        with open(os.path.join(out_a, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        checks["a_completed_4_micro_steps"] = result == {"status": "completed", "step": 4} and logged == [1, 2, 3, 4]
        checks["a_launches_every_micro_step"] = len(steps) == 4 and all(
            s["launches"] == {**attn, **NO_QUANT} for s in steps)
        checks["a_tuned_move_on_micro_steps_2_and_4_only"] = [s["trained_moved"] for s in steps] == [False, True] * 2
        checks["a_frozen_bit_unchanged"] = frozen_unchanged(torch, run)
        checks["a_checkpoint_holds_the_accumulator"] = (sorted(os.listdir(out_a)) == [
            "checkpoint-4", "config.json", "llm", "metrics.jsonl", "mm_projector", "region_extractor",
            "vision_tower"] and opt["mini_step"] == 0 and opt["gradient_step"] == 2 and len(opt["acc"]) > 0)
        checks["a_vocab_grown_by_region_tokens"] = (loaded.mask_token_id, loaded.depth_token_id,
                                                    loaded.num_extra_tokens) == (LLAMA3_VOCAB, LLAMA3_VOCAB + 1, 2)
        report["a_align"] = {"result": result, "wall_s": wall, "steps": steps,
                             "launches_expected_per_micro_step": {**attn, **NO_QUANT},
                             "figures": recipe_figures(run, nvidia_smi, peak)}

        # (d) the composite the run saved, read back
        final = os.path.join(work, "align_final")
        move_composite(out_a, final)
        trained = run["trainer"].state.model
        t0 = time.perf_counter()
        back = load_reference_checkpoint(final, loaded, dev, trained.llm.lm_head.weight.dtype)
        load_s = time.perf_counter() - t0
        one_row = train_batch(torch, loaded, np.random.default_rng(3), 1)
        with torch.no_grad():
            want, got = (vlm.forward(m, loaded, one_row, attn_impl="pallas") for m in (trained, back))
            same = bool(torch.equal(got, want))
        checks["d_reloaded_logits_bit_equal"] = same and bool(torch.isfinite(want).all())
        report["d_composite"] = {"load_s": load_s, "logits_shape": list(want.shape), "bit_equal": same}
        del back, got
        shutil.rmtree(final)
        release(torch)

        # (e) the trained model as the reference's HF composite, read back
        hf = os.path.join(work, "align_hf")
        t0 = time.perf_counter()
        save_composite_hf(hf, trained, loaded)
        write_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(hf) for f in files)
        t0 = time.perf_counter()
        hf_cfg = SpatialRGPTConfig.load(hf)
        back = load_reference_checkpoint(hf, hf_cfg, dev, trained.llm.lm_head.weight.dtype)
        read_s = time.perf_counter() - t0
        with open(os.path.join(hf, "config.json")) as f:
            top = json.load(f)
        with torch.no_grad():
            got = vlm.forward(back, hf_cfg, one_row, attn_impl="pallas")
            same = bool(torch.equal(got, want))
        checks["e_hf_reloaded_logits_bit_equal"] = same and bool(torch.isfinite(got).all())
        checks["e_hf_config_holds_llm_cfg_and_region_tokens"] = (
            top.get("llm_cfg", {}).get("vocab_size") == LLAMA3_VOCAB + 2
            and (hf_cfg.mask_token_id, hf_cfg.depth_token_id) == (LLAMA3_VOCAB, LLAMA3_VOCAB + 1))
        report["e_hf_composite"] = {"bytes": written, "write_s": write_s, "read_s": read_s, "bit_equal": same}
        print(f"recipe (e): save_composite_hf wrote {written} bytes in {write_s:.3f} s, read back in {read_s:.3f} s",
              flush=True)
        del back, trained, run, want, got, one_row
        shutil.rmtree(hf)
        release(torch)

        result, run, peak = recipe_main(torch, align + ["--output_dir", out_a, "--max_steps",
                                                        str(RECIPE_RESUME_STEPS)], totals)
        with open(os.path.join(out_a, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        checks["a_resume_continues_at_4"] = (result == {"status": "completed", "step": RECIPE_RESUME_STEPS}
                                             and logged == list(range(1, 7)) and len(run["steps"]) == 2)
        checks["a_resume_restores_the_accumulator"] = run["resumed"] == {
            "step": 4, "mini_step": 0, "gradient_step": 2, "accumulator_zero": True}
        checks["a_resume_moves_on_micro_step_6_only"] = [s["trained_moved"] for s in run["steps"]] == [False, True]
        report["a_resume"] = {"result": result, "resumed": run["resumed"], "steps": run["steps"]}
        del run
        shutil.rmtree(out_a)
        release(torch)

        out_x = os.path.join(work, "align_xla")
        result, run, peak = recipe_main(torch, align + ["--output_dir", out_x, "--attn_impl", "xla",
                                                        "--total_time_limit", "1", "--pre_terminate_time", "1"], totals)
        plain_loss = run["steps"][0]["metrics"]["loss"] if run["steps"] else float("nan")
        kernel_loss = steps[0]["metrics"]["loss"]
        loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
        checks["a_plain_route_stopped_by_its_time_limit"] = result == {"status": "timeout", "step": 1}
        checks["a_plain_route_launches_no_kernel"] = all(n == 0 for n in run["steps"][0]["launches"].values())
        checks["a_first_loss_vs_plain_route"] = loss_rel <= TRAIN_LOSS_REL_BOUND
        report["a_plain_route"] = {"first_loss": plain_loss, "kernel_first_loss": kernel_loss, "loss_rel": loss_rel,
                                   "bound": TRAIN_LOSS_REL_BOUND, "seconds": run["steps"][0]["seconds"],
                                   "peak_mem_gb": peak}
        del run
        shutil.rmtree(out_x)
        release(torch)

        # (b) QLoRA through main
        out_b = os.path.join(work, "qlora")
        result, run, peak = recipe_main(torch, align + ["--output_dir", out_b, "--max_steps", "2", "--lora_enable",
                                                        "true", "--bits", "8", "--lora_r", "64", "--lora_alpha", "16",
                                                        "--gradient_accumulation_steps", "1"], totals)
        state = run["trainer"].state
        L = cfg.llm.num_hidden_layers
        want_step = {**attn, **NO_QUANT, "w8_gemm": L * (7 + 6) + 1}  # remat recomputes all but down; lm_head once
        rows = [s["rows"][0] * TRAIN_SEQ for s in run["steps"]]
        adapters = load_pytree(os.path.join(out_b, "adapter.npz"))
        non_lora = load_pytree(os.path.join(out_b, "non_lora_trainables.npz"))

        def loads_back(saved, module) -> bool:
            return all(np.array_equal(saved[n], p.detach().float().cpu().numpy()) for n, p in module.named_parameters())

        checks["b_completed"] = result == {"status": "completed", "step": 2}
        checks["b_k9_launches_every_step_on_its_large_form"] = all(
            s["launches"] == want_step for s in run["steps"]) and all(w8_gemm_form(m) == FORM_LARGE for m in rows)
        checks["b_int8_base_bit_unchanged"] = frozen_unchanged(torch, run)
        checks["b_trained_moved_every_step"] = all(s["trained_moved"] for s in run["steps"])
        checks["b_adapter_npz_loads_back_equal"] = (
            sorted(adapters["adapters"]) == sorted(n for n, _ in state.model.adapters.items())
            and all(loads_back(adapters["adapters"][n], pair) for n, pair in state.model.adapters.items())
            and int(adapters["config"]["r"]) == 64)
        checks["b_non_lora_npz_loads_back_equal"] = sorted(non_lora) == ["mm_projector", "region_extractor"] and all(
            loads_back(non_lora[n], getattr(state.model, n)) for n in non_lora)
        report["b_qlora"] = {"result": result, "steps": run["steps"], "launches_expected_per_step": want_step,
                             "k9_rows": rows, "figures": recipe_figures(run, nvidia_smi, peak)}
        del run, state
        shutil.rmtree(out_b)
        release(torch)

        # (c) DPO through main
        out_c = os.path.join(work, "dpo")
        os.makedirs(out_c)
        result, run, peak = recipe_main(torch, align + [
            "--output_dir", out_c, "--dpo_enable", "true", "--dpo_data_path", dpo_pairs(out_c),
            "--per_device_train_batch_size", str(DPO_BATCH), "--max_steps", "2", "--gradient_accumulation_steps", "1",
        ], totals)
        first, second = ({**s["metrics"]} for s in run["steps"]) if len(run["steps"]) == 2 else ({}, {})
        want_step = {**NO_QUANT, **{k: 2 * v for k, v in attn.items()}}  # the policy's two passes (remat)
        for k, v in {"vit_attention": 2 * attn["vit_attention"], "flash_attention_fwd": L * 2}.items():
            want_step[k] += v  # the reference copy's two forwards
        checks["c_completed"] = result == {"status": "completed", "step": 2}
        checks["c_first_loss_ln2"] = abs(first.get("dpo_loss", float("nan")) - math.log(2)) <= 1e-4
        checks["c_first_rewards_zero"] = first.get("chosen_reward") == first.get("rejected_reward") == 0.0
        checks["c_second_finite"] = bool(second) and all(math.isfinite(v) for v in second.values())
        checks["c_launches_every_step"] = all(s["launches"] == want_step for s in run["steps"])
        checks["c_policy_moved_reference_kept"] = all(s["trained_moved"] for s in run["steps"]) and \
            state_fingerprint(torch, run["trainer"].state.ref_model) == run["reference_before"]
        report["c_dpo"] = {"result": result, "steps": run["steps"], "launches_expected_per_step": want_step,
                           "figures": recipe_figures(run, nvidia_smi, peak)}
        del run
        release(torch)
    emit({"phase": "recipe", "ok": all(checks.values()), "checks": checks,
          "model": f"llama3-8b ({RECIPE_LAYERS} of 32 layers, full width) + siglip-so400m (26 of 27 layers), bf16, "
                   "random from seed 0, through a composite directory; character tokenizer of Llama-3's size",
          "data": "dummy mixture: 32 samples of one 384 x 384 image + depth + 1 region, packed into rows of 4096",
          **report, "launches": totals})
    check(all(checks.values()), f"recipe checks failed: {checks}")
    return totals


# SpatialRGPT-Bench as scripts/srgpt/eval/srgpt_bench.sh runs it
# (BenchConfig's defaults: 32 rows, the 1024 bucket, 128 new tokens, 8
# region slots, the bf16 KV cache), on a synthetic annotation file of 24
# entries over 12 JPEGs of three sizes; its rounds make 48 records, and the
# first 16 entries exactly the first batch of 32
EVAL_IMAGE_HW = ((480, 640), (768, 1024), (375, 1242))
EVAL_IMAGES = 12
EVAL_ROUNDS = (1, 2, 3, 2) * 4 + (2,) * 8
EVAL_FIRST_BATCH_ENTRIES = 16
EVAL_BATCH, EVAL_BUCKET, EVAL_MAX_NEW = 32, 1024, 128
EVAL_CATEGORIES = [("quantitative", c) for c in ("distance_data", "vertical_distance_data",
                                                 "horizontal_distance_data", "width_data", "height_data",
                                                 "direction")] + \
                  [("qualitative", c) for c in ("left_predicate", "below_predicate", "behind_predicate",
                                                "tall_predicate", "big_predicate", "wide_predicate")]
# region classification (coco_cls.sh: conv v1, run_region_cls's batch 16 and
# 512 bucket) and VQA (VQAConfig's batch 16 and 1024 bucket), 32 new tokens
RC_ITEMS, RC_CATEGORIES = 32, ("person", "dog", "chair", "car", "cup", "bottle")
VQA_QUESTIONS = 16
EVAL_SHORT_MAX_NEW = 32
# the K2 row at the bench's prefill: live prompt lengths of a real
# tokenizer's SpatialRGPT-Bench prompt (196 image tokens + ~60-120 text and
# region tokens) in the 1024 bucket
EVAL_K2_LIVE = (250, 321)


def eval_data(work: str, cfg) -> dict:
    """The eval phase's files under ``work``: 12 JPEGs (``synth_photo``, 4 of
    each of EVAL_IMAGE_HW), a SpatialRGPT-Bench annotation file (``id``,
    ``image_info``, ``text_q``, ``qa_info`` over the bench's 12 categories,
    ``rle`` of 1-3 masks by the port's ``rle_encode`` but one entry with
    ``bbox`` only, ``conversations`` of EVAL_ROUNDS rounds), the same
    file's first EVAL_FIRST_BATCH_ENTRIES entries, a COCO instances file of
    RC_ITEMS boxes (and one crowd annotation, which the items skip) and a
    VQA question file."""
    import numpy as np
    from PIL import Image

    from spatialrgpt_tpu_torch.data.preprocess import rle_encode
    from spatialrgpt_tpu_torch.demo.pipeline import synth_photo

    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(work, "images"))
    sizes = {}
    for i in range(EVAL_IMAGES):
        h, w = EVAL_IMAGE_HW[i % len(EVAL_IMAGE_HW)]
        name = f"img{i:02d}.jpg"
        Image.fromarray(synth_photo(rng, h, w)).save(os.path.join(work, "images", name), quality=90)
        sizes[name] = (h, w)
    names = sorted(sizes)

    def box(h, w):
        x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        return [x1, y1, x1 + int(rng.integers(w // 8, w // 2)), y1 + int(rng.integers(h // 8, h // 2))]

    answers = {"quantitative": ["2.5 meters", "about 80 centimeters", "3 o'clock", "1.2 feet"],
               "qualitative": ["Yes, Region [0] is to the left.", "No, it is shorter.", "Region [1] is behind it."]}
    entries = []
    for i, n_rounds in enumerate(EVAL_ROUNDS):
        fp = names[i % EVAL_IMAGES]
        h, w = sizes[fp]
        qtype, cat = EVAL_CATEGORIES[i % len(EVAL_CATEGORIES)]
        boxes = [box(h, w) for _ in range(1 + i % 3)]
        conv = []
        for r in range(n_rounds):
            regions = " and ".join(f"Region [{k}] <mask>" for k in range(len(boxes)))
            q = f"Round {r}: what is the {cat.replace('_', ' ')} of {regions}?"
            conv += [{"from": "human", "value": ("<image>\n" if r == 0 else "") + q},
                     {"from": "gpt", "value": answers[qtype][(i + r) % len(answers[qtype])]}]
        e = {"id": f"srgpt-{i:03d}", "image_info": {"file_path": fp, "height": h, "width": w},
             "text_q": conv[0]["value"].replace("<image>\n", ""), "qa_info": {"type": qtype, "category": cat},
             "bbox": boxes, "conversations": conv}
        if i != 5:  # entry 5 has a bbox only
            masks = []
            for x1, y1, x2, y2 in boxes:
                m = np.zeros((h, w), np.uint8)
                m[y1:y2, x1:x2] = 1
                masks.append(rle_encode(m))
            e["rle"] = masks
        entries.append(e)
    paths = {"images": os.path.join(work, "images"), "bench": os.path.join(work, "bench.json"),
             "bench_first_batch": os.path.join(work, "bench_first_batch.json"),
             "coco": os.path.join(work, "instances.json"), "vqa": os.path.join(work, "vqa.jsonl"), "sizes": sizes}
    with open(paths["bench"], "w") as f:
        json.dump(entries, f)
    with open(paths["bench_first_batch"], "w") as f:
        json.dump(entries[:EVAL_FIRST_BATCH_ENTRIES], f)

    coco = {"images": [{"id": i + 1, "file_name": n, "height": sizes[n][0], "width": sizes[n][1]}
                       for i, n in enumerate(names)],
            "categories": [{"id": 10 + k, "name": c} for k, c in enumerate(RC_CATEGORIES)], "annotations": []}
    for a in range(RC_ITEMS + 1):
        img = coco["images"][a % EVAL_IMAGES]
        x1, y1, x2, y2 = box(img["height"], img["width"])
        coco["annotations"].append({"id": a, "image_id": img["id"], "bbox": [x1, y1, x2 - x1, y2 - y1],
                                    "category_id": 10 + a % len(RC_CATEGORIES), "iscrowd": int(a == 7)})
    with open(paths["coco"], "w") as f:
        json.dump(coco, f)
    with open(paths["vqa"], "w") as f:
        for q in range(VQA_QUESTIONS):
            f.write(json.dumps({"question_id": q, "image": names[q % EVAL_IMAGES],
                                "text": f"Question {q}: how many boxes are in the picture?"}) + "\n")
    return paths


@contextlib.contextmanager
def watched_generate(torch, module, attn_impl=None):
    """``module.generate`` (an eval runner's) replaced inside the block by a
    wrapper that times each batch: the first token (``serving/generate.py``'s
    ``_prefill``, synchronised) and the decode after it, and records the
    batch's rows, prompt lengths, decode steps run (the longest row's
    tokens less the first: every row decodes until all stop) and
    generated tokens, and the first batch's result.  With ``attn_impl``
    every batch runs on that route.  Yields the list of batches."""
    from spatialrgpt_tpu_torch.serving import generate as gen_mod

    real, real_prefill, batches = module.generate, gen_mod._prefill, []

    def prefill(*a, **k):
        out = real_prefill(*a, **k)
        torch.cuda.synchronize()
        batches[-1]["t_first"] = time.perf_counter()
        return out

    def wrapped(model, cfg, inputs, plens, **kw):
        if attn_impl is not None:
            kw["attn_impl"] = attn_impl
        rec = {"rows": int(inputs.input_ids.shape[0]), "positions": int(inputs.input_ids.shape[1]),
               "prompt_lengths": plens.tolist()}
        batches.append(rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(model, cfg, inputs, plens, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t_first = rec.pop("t_first")
        rec.update(first_token_s=t_first - t0, decode_s=t1 - t_first, decode_steps=int(res.num_generated.max()) - 1,
                   generated_tokens=int(res.num_generated.sum()))
        if len(batches) == 1:
            rec["result"] = res
        return res

    module.generate, gen_mod._prefill = wrapped, prefill
    try:
        yield batches
    finally:
        module.generate, gen_mod._prefill = real, real_prefill


def eval_run(torch, fn, module, totals: dict, attn_impl=None) -> tuple:
    """One runner call as a user makes it, its counts set to 0 before it and
    added to ``totals`` after: -> (answers path, batches, counts, wall s,
    peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    with watched_generate(torch, module, attn_impl) as batches:
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n
    return out, batches, counts, wall, torch.cuda.max_memory_allocated() / 1e9


def eval_figures(records: int, batches, wall: float, peak_gb: float, nvidia_smi: str) -> dict:
    gen = sum(b["generated_tokens"] for b in batches)
    return {"wall_s": wall, "records": records, "records_per_s": records / wall, "generated_tokens": gen,
            "generated_tokens_per_s": gen / wall, "peak_mem_gb": peak_gb, "card": nvidia_smi,
            "per_batch": [{k: b[k] for k in ("rows", "positions", "first_token_s", "decode_s", "decode_steps")}
                          for b in batches],
            "prompt_lengths_min_max": [min(min(b["prompt_lengths"]) for b in batches),
                                       max(max(b["prompt_lengths"]) for b in batches)],
            "padding_share": 1 - sum(sum(b["prompt_lengths"]) for b in batches)
            / sum(b["rows"] * b["positions"] for b in batches)}


def eval_counts(cfg, batches, quantized: bool, kv_quant: bool) -> dict:
    """K1-K11 launches of a runner's batches: per batch one tower pass (K1
    per tower layer) and one prefill (K2 per decoder layer); with the int8
    cache K3 per layer and decode step; with a W8A8 model K7-K9 by
    ``quant_phase_counts`` (the tower over [images; depths])."""
    L = cfg.llm.num_hidden_layers
    want = {"vit_attention": tower_layers(cfg) * len(batches), "onepass_attention": L * len(batches),
            "decode_attention_int8_flat": L * sum(b["decode_steps"] for b in batches) if kv_quant else 0,
            "decode_attention_int4_flat": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "grid_bias_attention": 0, "fused_layer_norm": 0, **NO_QUANT}
    if quantized:  # the bench's tower runs over [images; depths], as quant_phase_counts counts it
        for b in batches:
            prefill, step = quant_phase_counts(cfg, b["rows"], b["positions"], b["rows"])
            want.update(add_counts({k: want[k] for k in NO_QUANT}, prefill, times(b["decode_steps"], step)))
    return want


BENCH_FIELDS = ["question_id", "round", "image", "question", "pred", "output_ids", "gt", "model_id", "qa_info"]


def phase_eval(torch, nvidia_smi: str) -> dict:
    """The evaluation entry points at llama3-8b + SigLIP-so400m (random
    bf16 weights, seed 0, on the card), with a character tokenizer of
    Llama-3's size (``CharTokenizer``; <mask> and <depth> added past it)
    and synthetic files (``eval_data``):
    (a) ``run_bench`` at srgpt_bench.sh's configuration with
        ``depth_source="model"``: Depth-Anything ViT-L (``init_random_
        depth_anything``, f32, seed 2) written as an HF-named
        ``pytorch_model.bin`` and read back through ``depth_model_path``
        (its colorized depth of one image bit-equal to the in-memory
        model's); 48 records with the reference's fields; K1 / K2 launch
        counts from the batches and no other kernel; the first batch's
        first-token logits against the same batch on the plain route
        (``generate`` with ``attn_impl="xla"`` patched into the runner for
        a ``run_bench`` of the first batch's entries, and
        ``plain_projections()``), by ``logits_vs``; then ``judge.score_file``
        with ``LocalExtractor``: score.json written, a key for every
        category;
    (b) the same with ``w8a8=True, kv_quant=True`` on the same model tuple
        and predictor: no Depth-Anything forward (memoized by path), K1-K3
        and K7-K9 counts from the shapes, the first batch's first-token
        logits bit-equal to a ``run_bench`` of the first batch on K7-K9's
        plain versions, the caller's bf16 model bit-unchanged;
    (c) ``run_region_cls`` on RC_ITEMS COCO-style items
        (``coco_annotation_to_items``) and ``run_vqa`` on VQA_QUESTIONS
        questions: record counts, K1 / K2 counts,
        ``score_region_predictions``' keys.
    Per run the wall s, records/s, generated tokens/s and peak GB; per
    batch the first-token and decode s; the Depth-Anything stage's s."""
    import numpy as np
    from PIL import Image

    from spatialrgpt_tpu_torch.data.preprocess import SiglipProcessor
    from spatialrgpt_tpu_torch.eval import judge, region_cls, spatial_bench, vqa
    from spatialrgpt_tpu_torch.models import depth_anything as tda
    from spatialrgpt_tpu_torch.ops.layers import QuantLinear
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_depth_anything

    cfg = llama3_8b_cfg()
    dev = torch.device(DEVICE)
    totals, report, checks = {}, {}, {}
    phase_t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        data = eval_data(work, cfg)
        t0 = time.perf_counter()
        model = init_random(cfg, dev, torch.bfloat16, seed=0)
        tok = CharTokenizer()
        tok.add_tokens(["<mask>", "<depth>"], special_tokens=True)
        check((tok.convert_tokens_to_ids("<mask>"), tok.convert_tokens_to_ids("<depth>")) ==
              (cfg.mask_token_id, cfg.depth_token_id), "the tokenizer's region ids are not the config's")
        tup = (tok, model, cfg, SiglipProcessor(size=cfg.vision.image_size))

        # Depth-Anything ViT-L through depth_model_path
        dcfg = tda.DepthAnythingConfig()
        da_dir = os.path.join(work, "depth_anything")
        os.makedirs(da_dir)
        da_model = init_random_depth_anything(dcfg, dev, torch.float32, seed=2)
        torch.save({k: v.cpu() for k, v in da_model.state_dict().items()}, os.path.join(da_dir, "pytorch_model.bin"))
        bcfg = spatial_bench.BenchConfig(
            annotation_file=data["bench"], image_folder=data["images"], answers_file=os.path.join(work, "a", "answers.jsonl"),
            conv_mode="llama_3", batch_size=EVAL_BATCH, depth_model_path=da_dir)
        predictor = spatial_bench._build_depth_predictor(bcfg, None)
        one = np.asarray(Image.open(os.path.join(data["images"], "img01.jpg")).convert("RGB"))
        loaded_bit_equal = bool(np.array_equal(predictor.predict_colorized([one])[0],
                                               tda.DepthPredictor(da_model, dcfg).predict_colorized([one])[0]))
        checks["depth_model_path_bit_equal_to_in_memory"] = loaded_bit_equal
        del da_model
        torch.cuda.synchronize()
        report["init_s"] = time.perf_counter() - t0
        da_calls = []
        colorized = predictor.colorized

        def counted_colorized(images):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = colorized(images)
            torch.cuda.synchronize()
            da_calls.append({"images": list(images.shape), "s": time.perf_counter() - t})
            return out

        predictor.colorized = counted_colorized
        release(torch)

        # (a) srgpt_bench.sh's configuration, then the judge
        ans, batches, counts, wall, peak = eval_run(
            torch, lambda: spatial_bench.run_bench(bcfg, tup, predictor), spatial_bench, totals)
        recs = [json.loads(line) for line in open(ans)]
        want = eval_counts(cfg, batches, quantized=False, kv_quant=False)
        first = batches[0].pop("result")
        checks["a_48_records_with_the_reference_fields"] = len(recs) == sum(EVAL_ROUNDS) and all(
            list(r) == BENCH_FIELDS and len(r["output_ids"]) == EVAL_MAX_NEW for r in recs)
        checks["a_batches_32_and_16"] = [(b["rows"], b["positions"]) for b in batches] == \
            [(EVAL_BATCH, EVAL_BUCKET), (sum(EVAL_ROUNDS) - EVAL_BATCH, EVAL_BUCKET)]
        checks["a_launch_counts"] = counts == want
        checks["a_depth_anything_once_per_shape"] = sorted(tuple(c["images"][:3]) for c in da_calls) == sorted(
            (EVAL_IMAGES // len(EVAL_IMAGE_HW), h, w) for h, w in EVAL_IMAGE_HW)
        a_da = {"calls": list(da_calls), "s": sum(c["s"] for c in da_calls)}
        with plain_projections():
            _, plain_batches, _, _, _ = eval_run(torch, lambda: spatial_bench.run_bench(
                dataclasses.replace(bcfg, annotation_file=data["bench_first_batch"],
                                    answers_file=os.path.join(work, "a_plain", "answers.jsonl")), tup, predictor),
                spatial_bench, {}, attn_impl="xla")
        vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
        vs_checks, vs_fields = logits_vs(torch, first, plain_batches[0].pop("result"), vocab, max_new=EVAL_MAX_NEW)
        # greedy near-ties over 128 steps leave few rows equal throughout:
        # the last step is reported, the first token held
        vs_fields["last_logits_check_reported_only"] = vs_checks.pop("last_logits_vs_plain")
        checks.update({f"a_{k}": v for k, v in vs_checks.items()})
        scores = judge.score_file(ans)
        cats = {c for _, c in EVAL_CATEGORIES}
        score_keys = {f"Quan_{judge.QUANT_CATEGORY_NAMES[c]}_acc" for t, c in EVAL_CATEGORIES if t == "quantitative"} | \
            {f"Qual_{judge._qual_bucket(c)}_acc" for t, c in EVAL_CATEGORIES if t == "qualitative"}
        checks["a_score_json_has_every_category"] = os.path.exists(
            os.path.join(os.path.dirname(ans), "score.json")) and score_keys <= set(scores) and cats == {
            r["qa_info"]["category"] for r in recs}
        report["a_bench"] = {"launches": counts, "launches_expected": want, "depth_anything": a_da,
                             "first_batch_vs_plain_route": vs_fields, "scores": scores,
                             "first_record": {k: recs[0][k] for k in ("question_id", "round", "pred", "output_ids")},
                             "figures": eval_figures(len(recs), batches, wall, peak, nvidia_smi)}
        del first, plain_batches
        release(torch)

        # (b) the same with W8A8 and the int8 cache, on the same tuple and predictor
        before = state_fingerprint(torch, model)
        n_da = len(da_calls)
        bcfg_q = dataclasses.replace(bcfg, w8a8=True, kv_quant=True, answers_file=os.path.join(work, "b", "answers.jsonl"))
        ans, batches, counts, wall, peak = eval_run(
            torch, lambda: spatial_bench.run_bench(bcfg_q, tup, predictor), spatial_bench, totals)
        recs_q = [json.loads(line) for line in open(ans)]
        want = eval_counts(cfg, batches, quantized=True, kv_quant=True)
        first = batches[0].pop("result")
        release(torch)
        with plain_projections():
            _, plain_batches, _, _, _ = eval_run(torch, lambda: spatial_bench.run_bench(
                dataclasses.replace(bcfg_q, annotation_file=data["bench_first_batch"], max_new_tokens=1,
                                    answers_file=os.path.join(work, "b_plain", "answers.jsonl")), tup, predictor),
                spatial_bench, {})
        plain_first = plain_batches[0].pop("result")
        checks["b_48_records"] = len(recs_q) == len(recs) and all(list(r) == BENCH_FIELDS for r in recs_q)
        checks["b_no_depth_anything_forward"] = len(da_calls) == n_da
        checks["b_launch_counts"] = counts == want
        checks["b_first_logits_bit_equal_to_plain_projections"] = bool(
            torch.equal(first.first_logits, plain_first.first_logits) and torch.isfinite(first.first_logits).all())
        checks["b_caller_model_unchanged"] = state_fingerprint(torch, model) == before and not any(
            isinstance(m, QuantLinear) for m in model.modules())
        report["b_bench_w8a8"] = {
            "launches": counts, "launches_expected": want,
            "tokens_agreement_vs_bf16_run": float(np.mean([a["output_ids"] == b["output_ids"]
                                                           for a, b in zip(recs, recs_q)])),
            "figures": eval_figures(len(recs_q), batches, wall, peak, nvidia_smi)}
        del first, plain_first, plain_batches
        release(torch)

        # (c) region classification and VQA
        with open(data["coco"]) as f:
            items = region_cls.coco_annotation_to_items(json.load(f))
        ans, batches, counts, wall, peak = eval_run(torch, lambda: region_cls.run_region_cls(
            tup, items, data["images"], answers_file=os.path.join(work, "region_cls.jsonl"), conv_mode="v1"),
            region_cls, totals)
        recs_rc = [json.loads(line) for line in open(ans)]
        batches[0].pop("result")
        want = eval_counts(cfg, batches, quantized=False, kv_quant=False)
        rc_scores = region_cls.score_region_predictions(recs_rc)
        checks["c_region_cls_records"] = len(items) == RC_ITEMS and len(recs_rc) == RC_ITEMS and all(
            list(r) == ["pred", "gt_category", "file_name"] for r in recs_rc)
        checks["c_region_cls_launch_counts"] = counts == want and [b["rows"] for b in batches] == [16, 16]
        checks["c_region_cls_scores"] = set(rc_scores) == {"accuracy"} | {f"acc_{c}" for c in RC_CATEGORIES}
        report["c_region_cls"] = {"launches": counts, "launches_expected": want, "scores": rc_scores,
                                  "figures": eval_figures(len(recs_rc), batches, wall, peak, nvidia_smi)}
        vcfg = vqa.VQAConfig(question_file=data["vqa"], image_folder=data["images"],
                             answers_file=os.path.join(work, "vqa", "answers.jsonl"), max_new_tokens=EVAL_SHORT_MAX_NEW)
        ans, batches, counts, wall, peak = eval_run(torch, lambda: vqa.run_vqa(vcfg, tup), vqa, totals)
        recs_v = [json.loads(line) for line in open(ans)]
        batches[0].pop("result")
        want = eval_counts(cfg, batches, quantized=False, kv_quant=False)
        checks["c_vqa_records"] = len(recs_v) == VQA_QUESTIONS and all(
            list(r) == ["question_id", "prompt", "text", "model_id"] for r in recs_v)
        checks["c_vqa_launch_counts"] = counts == want and [(b["rows"], b["positions"]) for b in batches] == [
            (VQA_QUESTIONS, EVAL_BUCKET)]
        report["c_vqa"] = {"launches": counts, "launches_expected": want,
                           "figures": eval_figures(len(recs_v), batches, wall, peak, nvidia_smi)}
        del tup, model, predictor
        release(torch)
    emit({"phase": "eval", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), bf16, random from seed 0; "
                   "Depth-Anything ViT-L f32, random from seed 2, through depth_model_path; character tokenizer",
          "data": f"{len(EVAL_ROUNDS)} SpatialRGPT-Bench entries ({sum(EVAL_ROUNDS)} records) over {EVAL_IMAGES} "
                  f"JPEGs of {list(EVAL_IMAGE_HW)}; {RC_ITEMS} COCO boxes; {VQA_QUESTIONS} VQA questions",
          **report, "launches": totals, "phase_s": time.perf_counter() - phase_t0, "card": nvidia_smi,
          "smoke_figures_not_a_benchmark": True})
    check(all(checks.values()), f"eval checks failed: {checks}")
    return totals


def demo_expected_counts(vlm_cfg, sam_cfg, da_cfg, n_images: int, chunk: int, hw):
    """The demo pipeline's launch counts, from its shapes, and K6's by stage.
    K6 is counted at every LayerNorm whose input passes
    ``ops/layers.py::layer_norm``'s gate (bf16, C % 128 == 0, at least 4096
    rows): per stage and site, the rows and width it normalizes."""
    from spatialrgpt_tpu_torch.models.depth_anything import resize_lower_bound_hw

    def gate(rows: int, c: int) -> int:
        return int(c % 128 == 0 and rows >= 4096)

    # Depth-Anything: norm1 + norm2 per layer over cls + patch tokens, and the
    # final norm at each selected layer
    oh, ow = resize_lower_bound_hw(*hw, 518, da_cfg.patch_size)
    da_rows = n_images * (1 + (oh // da_cfg.patch_size) * (ow // da_cfg.patch_size))
    depth = gate(da_rows, da_cfg.hidden_size) * (2 * da_cfg.num_hidden_layers + len(da_cfg.out_indices))
    # SAM-HQ per chunk of b images, 2 boxes (prompt rows) per image
    v, g, c = sam_cfg.vision, sam_cfg.image_embedding_size, sam_cfg.decoder_hidden_size
    chunks = [min(chunk, n_images - i) for i in range(0, n_images, chunk)]
    sam = 0
    for b in chunks:
        sam += gate(b * g * g, v.hidden_size) * 2 * v.num_hidden_layers  # ln1, ln2 (before windowing)
        sam += gate(b * g * g, v.output_channels) * 2  # neck
        # the mask decoder runs in f32 as the reference's does: the box
        # prompts' Fourier features are f32 and promote the tokens, and the
        # keys after the first image-to-token attention; only the HQ head's
        # norms over the bf16 image embedding and ViT features stay bf16
        sam += gate(2 * b * 4 * g * g, c // 4)  # HQ encoder norm
        sam += gate(2 * b * 4 * g * g, c)  # HQ compress-ViT norm
    # the VLM: SigLIP over [images; depths], the refinement's deconv norms,
    # the projector's norm (Llama's are RMSNorms)
    sv, r = vlm_cfg.vision, vlm_cfg.region
    side = sv.image_size // sv.patch_size
    layers_run = sv.num_hidden_layers + 1 + sv.select_layer
    vlm = gate(2 * n_images * side * side, sv.hidden_size) * 2 * layers_run
    vlm += sum(gate(n_images * (side * 2 ** (d + 1)) ** 2, r.mm_hidden_size) for d in range(r.deconv_depth - 1))
    vlm += gate(n_images * ((r.ada_pool_size + 1) // 2) ** 2, 4 * vlm_cfg.projector.mm_hidden_size)
    L = vlm_cfg.llm.num_hidden_layers
    counts = {
        "vit_attention": layers_run, "onepass_attention": L, "decode_attention_int8_flat": L * (MAX_NEW - 1),
        "decode_attention_int4_flat": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
        "grid_bias_attention": len(v.global_attn_indexes) * len(chunks), "fused_layer_norm": depth + sam + vlm,
        **quant_expected_counts(vlm_cfg, n_images, PAD_BUCKET, MAX_NEW),  # the VLM is W8A8, as bench_demo.py's
    }
    return counts, {"depth": depth, "sam": sam, "vlm": vlm}


def phase_demo(torch, profile_dir=None) -> dict:
    import numpy as np

    from spatialrgpt_tpu_torch.demo import pipeline
    from spatialrgpt_tpu_torch.models import depth_anything as tda
    from spatialrgpt_tpu_torch.models.sam import SamConfig
    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.utils.weights import (
        init_random,
        init_random_depth_anything,
        init_random_quantized,
        init_random_sam_hq,
    )

    dev = torch.device(DEVICE)
    cfg, scfg, dcfg = llama3_8b_cfg(), SamConfig(), tda.DepthAnythingConfig()  # llama3-8b, SAM-HQ vit_h, DA ViT-L
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = pipeline.DemoModels(
        depth=tda.DepthPredictor(init_random_depth_anything(dcfg, dev, torch.bfloat16, seed=2), dcfg),
        sam=init_random_sam_hq(scfg, dev, torch.bfloat16, seed=1), sam_cfg=scfg,
        vlm=init_random_quantized(cfg, dev, w8a8=True, seed=0), vlm_cfg=cfg,  # bench_demo.py:177
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    h, w = DEMO_HW
    photos = np.stack([pipeline.synth_photo(rng, h, w) for _ in range(DEMO_IMAGES)])
    images = torch.as_tensor(photos, device=dev)
    boxes = torch.as_tensor(pipeline.demo_boxes(DEMO_IMAGES, h, w), device=dev)
    spliced = pipeline.demo_prompts(cfg, rng, DEMO_IMAGES)

    def run(impl):
        return pipeline.run_pipeline(models, images, boxes, spliced, MAX_NEW, attn_impl=impl, chunk=DEMO_SAM_CHUNK,
                                     sync=torch.cuda.synchronize)

    def depth_and_head():
        """Depth maps and the head's pre-relu output of the photos (all 8:
        Depth-Anything's rows pass K6's gate from 3 photos on)."""
        with torch.no_grad():
            px = models.depth.preprocess(images)
            return models.depth.depth(images), tda.head_logits(models.depth.model, px, dcfg)

    def vlm_stage(vlm, inputs, impl):
        return pipeline.stage_vlm(vlm, cfg, spliced, *inputs, MAX_NEW, attn_impl=impl)

    fused_before = layers.FUSED_LN
    try:
        layers.FUSED_LN = True
        run("onepass")  # warm-up: cuBLAS / cuDNN handles, allocator, every op of the path once
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = run("onepass")
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        depth_k, head_k = depth_and_head()
        engine = pipeline.DemoEngine(pipeline.segment_boxes_fn(models.sam, scfg),
                                     pipeline.estimate_depth_fn(models.depth), generate=None)
        state = pipeline.DemoState()
        engine.set_image(state, photos[0])
        overlay = engine.add_regions(state, pipeline.demo_boxes(1, h, w)[0].tolist())
        # the W8A8 VLM as phase serve_w8a8 holds it: its projections against
        # their plain versions on the same inputs and attention kernels, bit
        # for bit at the first token; the VLM stage's attention kernels, on
        # each route's own depth and masks, as this phase held them before
        # the VLM was quantized: with init_random's bf16 weights
        with plain_projections():
            proj_plain = vlm_stage(models.vlm, out.vlm_inputs, "onepass")
        bf16_vlm = init_random(cfg, dev, torch.bfloat16, seed=0)
        vlm_k = vlm_stage(bf16_vlm, out.vlm_inputs, "onepass")
        layers.FUSED_LN = False
        with plain_projections():
            plain = run("xla")
        depth_p, head_p = depth_and_head()
        vlm_p = vlm_stage(bf16_vlm, plain.vlm_inputs, "xla")
        del bf16_vlm
        torch.cuda.empty_cache()
    finally:
        layers.FUSED_LN = fused_before

    want, by_stage = demo_expected_counts(cfg, scfg, dcfg, DEMO_IMAGES, DEMO_SAM_CHUNK, DEMO_HW)
    logits, ref = out.mask_logits, plain.mask_logits
    rms = float(ref.float().square().mean().sqrt())
    sure = ref.abs() > DEMO_MASK_MARGIN * rms
    mask_mismatch = int(((logits > 0) != (ref > 0))[sure].sum())
    depth_spread = float(depth_k.float().std())
    # a random relu head may output a constant map: then its input is compared
    depth_rel = rel_l2(depth_k, depth_p) if depth_spread > 0 else rel_l2(head_k, head_p)
    mask_rel = rel_l2(logits, ref)
    first_rel = rel_l2(vlm_k.first_logits, vlm_p.first_logits)
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    tokens, g = out.result.tokens, scfg.image_embedding_size * 4
    checks = {
        "colorized_shape": list(out.colorized.shape) == [DEMO_IMAGES, h, w, 3] and out.colorized.dtype == torch.uint8,
        "mask_logits_shape_finite": list(logits.shape) == [DEMO_IMAGES * 2, g, g] and bool(torch.isfinite(logits).all()),
        "tokens_shape_in_vocab": list(tokens.shape) == [DEMO_IMAGES, MAX_NEW] and bool(((tokens >= 0) & (tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(out.result.first_logits).all()),
        "launch_counts": counts == want,
        "depth_vs_plain": depth_rel <= DEMO_DEPTH_REL_BOUND,
        "mask_logits_vs_plain": mask_rel <= DEMO_MASK_REL_BOUND,
        "masks_vs_plain_beyond_margin": mask_mismatch == 0,
        "first_logits_vs_plain": first_rel <= LOGITS_REL_BOUND,
        "vlm_first_logits_bit_equal_to_plain_projections": torch.equal(out.result.first_logits,
                                                                       proj_plain.first_logits),
        "engine_depth_and_masks": state.depth_colorized.shape == (h, w, 3) and len(state.region_masks) == 2
        and all(m.shape == (h, w) and m.dtype == np.uint8 for m in state.region_masks) and overlay.shape == (h, w, 3),
    }
    seconds = out.seconds
    emit({
        "phase": "demo", "ok": all(checks.values()), "checks": checks,
        "models": "Depth-Anything ViT-L (24 layers) + SAM-HQ vit_h (32 layers), bf16, + llama3-8b (32 layers) with "
                  "siglip-so400m (26 of 27 layers), W8A8, random from seeds 2 / 1 / 0; SRGPT_FUSED_LN on",
        "batch": {"images": DEMO_IMAGES, "hw": list(DEMO_HW), "boxes_per_image": 2, "sam_chunk": DEMO_SAM_CHUNK,
                  "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW},
        "launches": counts, "launches_expected": want, "fused_layer_norm_expected_by_stage": by_stage,
        "depth_spread_std": depth_spread, "depth_compared": "depth" if depth_spread > 0 else "head pre-relu",
        "depth_rel_l2_vs_plain": depth_rel, "depth_bound": DEMO_DEPTH_REL_BOUND,
        "mask_logits_rel_l2_vs_plain": mask_rel, "mask_bound": DEMO_MASK_REL_BOUND,
        "mask_margin_abs": DEMO_MASK_MARGIN * rms, "mask_pixels_beyond_margin": int(sure.sum()),
        "mask_mismatches_beyond_margin": mask_mismatch,
        "mask_pixels_positive_share": float((logits > 0).float().mean()),
        "first_logits_rel_l2_vs_plain": first_rel, "rel_bound": LOGITS_REL_BOUND,
        "first_logits_compared": "the VLM stage with init_random's bf16 weights, on each route's own depth and masks",
        "w8a8_first_logits_rel_l2_vs_whole_plain_route": rel_l2(out.result.first_logits, plain.result.first_logits),
        "tokens_agreement_vs_plain": float((tokens == plain.result.tokens).float().mean()),
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "images_per_s": DEMO_IMAGES / sum(seconds.values()),
            # without the VLM, whose decode loop the host paces
            "vision_images_per_s": DEMO_IMAGES / (seconds["depth_s"] + seconds["sam_s"] + seconds["preprocess_s"]),
            **seconds,
            "plain_path_seconds": plain.seconds, "peak_mem_gb": peak_gb,
        },
    })
    check(all(checks.values()), f"demo checks failed: {checks}")
    if profile_dir:
        layers.FUSED_LN = True
        try:
            profile_run(torch, lambda: run("onepass"), profile_dir, "demo_pipeline")
        finally:
            layers.FUSED_LN = fused_before
    return counts


def clip_char_tokenize(prompts):
    """A character tokenizer in the CLIP BPE's place (no tokenizer files are
    part of the repository): begin-of-text, one id per byte (256 + byte),
    end-of-text, padded with 0 to OWL-ViT's 16 positions; the mask marks
    the real ids."""
    import numpy as np

    ids = np.zeros((len(prompts), CLIP_LEN), np.int64)
    for i, text in enumerate(prompts):
        row = [CLIP_BOS] + [256 + b for b in text.encode()[: CLIP_LEN - 2]] + [CLIP_EOT]
        ids[i, : len(row)] = row
    return ids, (ids != 0).astype(np.int64)


def synth_expected_counts(ram_cfg, sam_cfg, tagged: int, segmented: int) -> tuple:
    """The synth path's launch counts: K5 once per SAM global layer and
    segmented image (one ``predict_boxes`` call an image, B1), K6 at every
    LayerNorm whose bf16 input passes ``ops/layers.py::layer_norm``'s gate
    (C % 128 == 0, at least 4096 rows), per stage; no other kernel.  Of the
    five models only two have such rows: RAM's tagging head (4585 query rows
    at width 768: per decoder layer its self-attention, cross-attention and
    FFN norms, and the final norm; Swin-L's rows are 9216 at C 192 and 2304
    and fewer at 384 and up) and SAM's encoder (4096 rows: two norms a layer
    and the neck's two; its mask decoder runs in f32).  OWL-ViT (577 and 512
    rows), Depth-Anything (1370) and CameraNet (f32 activations) have none."""
    def gate(rows: int, c: int) -> int:
        return int(c % 128 == 0 and rows >= 4096)

    ram = gate(ram_cfg.num_tags, ram_cfg.hidden_size) * (3 * ram_cfg.num_decoder_layers + 1)
    v, g = sam_cfg.vision, (sam_cfg.vision.image_size // sam_cfg.vision.patch_size) ** 2
    sam = gate(g, v.hidden_size) * 2 * v.num_hidden_layers + gate(g, v.output_channels) * 2
    counts = {name: 0 for name in read_counts()}
    counts["grid_bias_attention"] = len(v.global_attn_indexes) * segmented
    counts["fused_layer_norm"] = ram * tagged + sam * segmented
    return counts, {"ram_per_image": ram, "sam_per_image": sam}


class StageWatch:
    """Wraps a pipeline's stage callables: per image (an image starts at its
    tagger call) the counts of each stage's output, and per stage the
    seconds, synchronised on the card.  The lift's seconds leave out the
    depth and calibration models it calls."""

    def __init__(self, torch, pipe):
        self.torch, self.images, self.seconds, self.calls, self.called_by = torch, [], {}, [], []
        seg, lift = pipe.segment, pipe.lift
        seg.tagger = self.wrap("tag", seg.tagger, lambda out: {"tags": len(out)}, first=True)
        seg.detector = self.wrap("detect", seg.detector, lambda out: {"detections": len(out)})
        seg.segmenter = self.wrap("segment", seg.segmenter, None)
        seg.process = self.wrap("filter", seg.process, lambda out: {"masks_kept": len(out)}, timed=False)
        for name in ("depth_model", "intrinsics_model", "gravity_model"):
            setattr(lift, name, self.wrap("depth_calib", getattr(lift, name), None))
        lift.process = self.wrap("lift", lift.process, lambda out: {"objects_lifted": len(out)}, nested="depth_calib")
        pipe.prompter.evaluate_predicates_on_pairs = self.wrap(
            "qa", pipe.prompter.evaluate_predicates_on_pairs, lambda out: {"qa_pairs": len(out)})

    def wrap(self, stage, fn, count, first=False, timed=True, nested=None):
        def run(*args, **kwargs):
            if first:
                self.images.append({})
            if stage == "segment" and len(args[1]):  # an image with boxes: one SAM forward
                self.calls.append(args)
                self.called_by.append(len(self.images) - 1)
            inner = self.seconds.get(nested, 0.0)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            if timed:
                spent = time.perf_counter() - t0 - (self.seconds.get(nested, 0.0) - inner)
                self.seconds[stage] = self.seconds.get(stage, 0.0) + spent
            if count is not None:
                self.images[-1].update(count(out))
            return out

        return run


def phase_synth(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The synthesis pipeline's entry point on the card: ``run_directory``
    over ``SynthPipeline(cfg, **build_stage_models(...))``."""
    import numpy as np
    from PIL import Image

    from spatialrgpt_tpu_torch.demo.pipeline import synth_photo
    from spatialrgpt_tpu_torch.models import depth_anything as tda
    from spatialrgpt_tpu_torch.models import owl_vit, ram, sam
    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.synth import calibration
    from spatialrgpt_tpu_torch.synth import models as smodels
    from spatialrgpt_tpu_torch.synth import pipeline as spipe
    from spatialrgpt_tpu_torch.utils import weights

    phase_t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    rcfg, ocfg, scfg = ram.RamConfig(), owl_vit.OwlViTConfig(), sam.SamConfig()
    dcfg, ccfg = tda.DepthAnythingConfig(metric=True, max_depth=SYNTH_MAX_DEPTH), calibration.CameraNetConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ram_m = weights.init_random_ram(rcfg, dev, torch.bfloat16, seed=3)
    owl_m = weights.init_random_owl_vit(ocfg, dev, torch.bfloat16, seed=4)
    sam_m = weights.init_random_sam_hq(scfg, dev, torch.bfloat16, seed=1)
    depth_m = weights.init_random_depth_anything(dcfg, dev, torch.bfloat16, seed=2)
    cam_m = weights.init_random_camera_net(ccfg, dev, torch.bfloat16, seed=5)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tags = [f"object{i}" for i in range(rcfg.num_tags)]  # a synthetic tag list of RAM's size
    models = smodels.build_stage_models(  # no device: the card is the default
        ram_params=ram_m, ram_cfg=rcfg, ram_tags=tags, owl_params=owl_m, owl_cfg=ocfg,
        owl_tokenize=clip_char_tokenize, sam_params=sam_m, sam_cfg=scfg, depth_params=depth_m, depth_cfg=dcfg,
        calib_params=cam_m, calib_cfg=ccfg, box_threshold=SYNTH_BOX_THRESHOLD,
    )
    cfg = spipe.SynthConfig(**SYNTH_CONFIG)
    pipe = spipe.SynthPipeline(cfg, **models)
    watch = StageWatch(torch, pipe)
    seg_kernel = smodels.make_sam_segmenter(sam_m, scfg)
    seg_plain = smodels.make_sam_segmenter(sam_m, scfg, attn_impl="xla")
    rng = np.random.default_rng(0)
    shapes = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    fused_before = layers.FUSED_LN
    with tempfile.TemporaryDirectory(prefix="synth_", dir=os.path.join(ROOT, "build")) as work:
        for i, (h, w) in enumerate(SYNTH_HW):
            name = f"photo{i}.jpg"
            Image.fromarray(synth_photo(rng, h, w)).save(os.path.join(work, name), quality=95)
            shapes[name] = [h, w]
        photos = {n: np.asarray(Image.open(os.path.join(work, n)).convert("RGB")) for n in sorted(shapes)}

        def detector_ranks(image):
            """The detector's patch scores (sigmoid of the best query's logit)
            at ranks 1, 4, 16, 32 and 64 of the 576, for the first 32 tags."""
            ids, mask = clip_char_tokenize([f"a photo of a {t}" for t in tags[:32]])
            x = torch.as_tensor(owl_vit.preprocess_image(image, ocfg.vision.image_size)[None], device=dev)
            logits, _ = owl_vit.detect(owl_m, ocfg, x, torch.as_tensor(ids, device=dev),
                                       torch.as_tensor(mask, device=dev))
            top = torch.sigmoid(logits[0].amax(dim=-1)).sort(descending=True).values.cpu().numpy()
            return {f"rank{r}": float(top[r - 1]) for r in (1, 4, 16, 32, 64) if r <= len(top)}

        def segment_route(attn_impl, segmenter):
            """Each segmented image's recorded boxes through one route: SAM's
            mask logits and the segmenter's masks at the image's size."""
            out = []
            for image, boxes in watch.calls:
                x, b = (torch.as_tensor(a, device=dev) for a in smodels.sam_inputs(image, boxes, scfg))
                logits, _ = sam.predict_boxes(sam_m, scfg, x, b, attn_impl=attn_impl)
                out.append((logits, segmenter(image, boxes)))
            return out

        try:
            # SRGPT_FUSED_LN on in the run and on both routes of the
            # comparison: the routes differ in K5 alone
            layers.FUSED_LN = True
            try:  # warm-up on its own pipeline (the QA sampler's stream stays fresh): handles, allocator, every op once
                spipe.SynthPipeline(cfg, **models).annotate(photos["photo0.jpg"])
            except spipe.SkipImageException:
                pass
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            stats = spipe.run_directory(pipe, work, os.path.join(work, "out.json"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with open(os.path.join(work, "out.json")) as f:
                records = json.load(f)
            ranks = {n: detector_ranks(im) for n, im in photos.items()}
            kernel_route = segment_route("onepass", seg_kernel)
            reset_counts()
            plain_route = segment_route("xla", seg_plain)
            plain_counts = read_counts()
        finally:
            layers.FUSED_LN = fused_before

    names = sorted(shapes)
    tagged, segmented = len(watch.images), len(watch.calls)
    want, per_image_ln = synth_expected_counts(rcfg, scfg, tagged, segmented)
    # the plain route of the comparison: K6 at SAM's encoder rows, twice an
    # image (its logits, then its segmenter's masks), and no K5
    want_plain = dict.fromkeys(want, 0)
    want_plain["fused_layer_norm"] = 2 * per_image_ln["sam_per_image"] * segmented
    vs_plain = []
    for (logits_k, masks_k), (logits_p, masks_p) in zip(kernel_route, plain_route):
        rms = float(logits_p.float().square().mean().sqrt())
        sure = logits_p.abs() > DEMO_MASK_MARGIN * rms
        vs_plain.append({
            "boxes": len(masks_k), "mask_logits_rel_l2": rel_l2(logits_k, logits_p),
            "mismatches_beyond_margin": int(((logits_k > 0) != (logits_p > 0))[sure].sum()),
            "mask_pixels_differing": int(sum((mk != mp).sum() for mk, mp in zip(masks_k, masks_p))),
            "mask_pixels": int(sum(mk.size for mk in masks_k)),
        })
    qa_shapes = {tuple(shapes[n]) for n, r in records.items() if r["qa"]}
    checks = {
        "launch_counts": counts == want,
        "plain_route_launches_k6_alone": plain_counts == want_plain,
        "tagged_every_image": tagged == len(names),
        "segmented_some_image": segmented > 0,
        "mask_logits_vs_plain": all(v["mask_logits_rel_l2"] <= DEMO_MASK_REL_BOUND for v in vs_plain),
        "masks_vs_plain_beyond_margin": all(v["mismatches_beyond_margin"] == 0 for v in vs_plain),
        "qa_on_each_shape": qa_shapes == {tuple(hw) for hw in SYNTH_HW},
        "out_json_has_every_annotated_image": stats["annotated"] == len(records) and set(records) <= set(names)
        and stats["annotated"] + stats["skipped"] == len(names),
        "records_well_formed": all(
            r["objects"] and all(len(o["center"]) == 3 and len(o["extent"]) == 3 and len(o["box"]) == 4
                                 and all(math.isfinite(v) for v in o["center"] + o["extent"]) for o in r["objects"])
            and all(q["question"] and q["answer"] and q["type"] for q in r["qa"]) for r in records.values()),
    }
    per_image = {n: dict(hw=shapes[n], annotated=n in records, **c) for n, c in zip(names, watch.images)}
    for i, v in zip(watch.called_by, vs_plain):
        per_image[names[i]]["segment_vs_plain_route"] = v
    emit({
        "phase": "synth", "ok": all(checks.values()), "checks": checks,
        "models": "RAM Swin-L 384 (4585 tags) + OWL-ViT B/32 768 + SAM-HQ vit_h (box head) + Depth-Anything ViT-L "
                  "metric + CameraNet, bf16, random from seeds 3 / 4 / 1 / 2 / 5; SRGPT_FUSED_LN on",
        "data": f"{len(names)} synthetic JPEGs of {sorted({tuple(hw) for hw in SYNTH_HW})}",
        "cuts": {"weights": "random", "photos": "demo/pipeline.py::synth_photo", "tokenizer": "clip_char_tokenize",
                 "tag_list": f"object0..object{rcfg.num_tags - 1}", "tagger_thresholds": rcfg.default_threshold,
                 "box_threshold": SYNTH_BOX_THRESHOLD, "synth_config_changed": SYNTH_CONFIG},
        "launches": counts, "launches_expected": want, "fused_layer_norm_per_image": per_image_ln,
        "plain_route_launches": plain_counts,
        "images_tagged": tagged, "images_segmented": segmented,
        "mask_bound": DEMO_MASK_REL_BOUND, "annotated": stats["annotated"], "skipped": stats["skipped"],
        "segment_output_equal_to_plain_route_share": sum(
            v["mask_pixels_differing"] == 0 for v in vs_plain) / max(len(vs_plain), 1),
        "per_image": per_image, "detector_score_ranks": ranks,
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "wall_s": wall, "images_per_s": len(names) / wall, "stage_s": watch.seconds,
            "peak_mem_gb": peak_gb, "card": nvidia_smi, "phase_s": time.perf_counter() - phase_t0,
        },
    })
    check(all(checks.values()), f"synth checks failed: {checks}")
    if profile_dir:
        def one_image():
            try:
                spipe.SynthPipeline(cfg, **models).annotate(photos["photo0.jpg"])
            except spipe.SkipImageException:
                pass

        layers.FUSED_LN = True
        try:
            profile_run(torch, one_image, profile_dir, "synth_image")
        finally:
            layers.FUSED_LN = fused_before
    return counts


# the towers path: CLIP ViT-L/14-336 on 16 images at select_layer -2, CLIP-S²
# at 336 / 672 / 1008 on 4 images (14 crops an image, all in one tower pass),
# InternViT-6B on 4 images at 448 px (all 48 layers), RADIO ViT-H/16 on 2
# square photos resized to the 768-pixel longest edge (48 x 48 patches + 4
# summary tokens), MPT-7B behind SigLIP-so400m on phase main's rows; bf16,
# random from fixed seeds
TOWER_CLIP = "openai/clip-vit-large-patch14-336"
TOWER_INTERN = "OpenGVLab/InternViT-6B-448px-V1-5"
TOWER_RADIO = "radio:768:radio_v2.5-h:"
TOWER_CLIP_IMAGES = 16
TOWER_S2_IMAGES = 4
TOWER_S2_SCALES = "336,672,1008"
TOWER_INTERN_IMAGES = 4
TOWER_RADIO_IMAGES = 2
TOWER_RADIO_PHOTO = 640  # square photos, their longest edge resized to 768 by the tower's processor
# MPT-7B's table has 50,432 rows (its tokenizer's 50,277 ids and room to
# grow): <mask> and <depth> take two of its last rows
MPT_MASK_TOKEN, MPT_DEPTH_TOKEN = 50430, 50431


def layer_updates(torch, x, layers, step) -> list:
    """Per layer: the relative L2 distance of the layer's update (output
    less input) on the kernel route from the plain route's, both from the
    plain route's input to that layer (``step(x, layer, attn_impl)``)."""
    rels = []
    with torch.no_grad():
        for layer in layers:
            plain = step(x, layer, "xla")
            rels.append(rel_l2(step(x, layer, "onepass") - x, plain - x))
            x = plain
    return rels


def tower_run(torch, fn, plain_fn, nvidia_smi: str) -> tuple:
    """One model of the towers path: a warm-up call, the counted call (the
    launch counts reset just before it and read just after), the device
    ms of one call (CUDA events, median of 3) and its peak GB, and the plain
    route's output.  Returns (output, plain output, counts, figures)."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = event_ms(torch, fn, 1)
        ref = plain_fn()
    figures = {"forward_device_ms": ms, "peak_mem_gb": peak_gb, "card": nvidia_smi,
               "timing": "CUDA events around one call after a warm-up, median of 3"}
    return out, ref, counts, figures


def phase_towers(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The other vision towers and the MPT decoder at full width
    (``build_vision_tower``'s configs, ``init_random_*`` on the card, bf16):
    CLIP ViT-L/14-336 (23 of 24 layers, K1's narrow form at D 64), CLIP-S²
    (one tower pass over 56 crops, hidden 3072), InternViT-6B (48 layers,
    K1's wide form at D 128), RADIO ViT-H/16 through ``RadioVisionTower``
    in ``patch`` and ``dense`` (plain attention, as the reference's), and
    ``forward_mpt`` on MPT-7B behind SigLIP-so400m over phase main's 8 rows
    (320 bucket, RGB + depth, 2 regions), then the same 8 samples packed 2
    a row.  Checks each run's launch counts (K1 once a tower layer, nothing
    else) and the kernel route against the plain route (K1's plain
    version): the features and logits within LOGITS_REL_BOUND, or, where
    random depth amplifies bf16 roundings past it, each layer's update
    within LAYER_REL_BOUND with the full-depth figure reported; RADIO's
    dense features end in its patch features, bit for bit (its bf16
    features' distance from an f32 copy's is reported)."""
    import numpy as np

    from spatialrgpt_tpu_torch import NUM_TOKENS_PER_IMAGE, expand_rows, pack_rows
    from spatialrgpt_tpu_torch.models import clip, intern_vit, mpt, radio, s2, siglip, vlm
    from spatialrgpt_tpu_torch.models.tower_builder import build_vision_tower
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs
    from spatialrgpt_tpu_torch.ops.layers import layer_norm
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_clip, init_random_intern_vit, init_random_radio

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(7)
    checks, runs, totals = {}, {}, []

    def pixels(n, size):
        return torch.randn(n, size, size, 3, generator=g, device=dev).to(torch.bfloat16)

    def k1_only(counts, n):
        want = {k: 0 for k in counts}
        want["vit_attention"] = n
        return want

    def record(label, counts, want, figures, **fields):
        totals.append(counts)
        checks[f"{label}_launch_counts"] = counts == want
        runs[label] = {"launches": counts if counts != want else "as expected", "k1_launches": counts["vit_attention"],
                       **fields, "smoke_figures_not_a_benchmark": figures}

    def held(label, out, ref, shape, layer_rels=None):
        rel = rel_l2(out, ref)
        checks[f"{label}_shape_finite"] = list(out.shape) == shape and bool(torch.isfinite(out).all())
        fields = {"shape": list(out.shape), "rel_l2_vs_plain": rel, "rel_bound": LOGITS_REL_BOUND}
        if rel <= LOGITS_REL_BOUND or layer_rels is None:
            checks[f"{label}_vs_plain"] = rel <= LOGITS_REL_BOUND
        else:  # the full depth amplifies: each layer's update is held instead
            rels = layer_rels()
            checks[f"{label}_layer_updates_vs_plain"] = max(rels) <= LAYER_REL_BOUND
            fields.update(layer_update_rel_l2=rels, layer_rel_bound=LAYER_REL_BOUND,
                          held="layer by layer: the full depth amplifies bf16 roundings past rel_bound")
        return fields

    # CLIP ViT-L/14-336, then CLIP-S² on the same weights
    h = build_vision_tower(TOWER_CLIP)
    cfg = h.config
    model = init_random_clip(cfg, dev, torch.bfloat16, seed=0)
    layers = cfg.num_hidden_layers + 1 + cfg.select_layer
    pre = model.vision_model.pre_layrnorm

    def clip_layers(x):
        return layer_updates(torch, layer_norm(clip.embed(model, x, cfg), pre.weight, pre.bias, cfg.layer_norm_eps),
                             model.vision_model.encoder.layers[:layers],
                             lambda x, layer, impl: clip.encoder_layer(x, layer, cfg, impl))

    px = pixels(TOWER_CLIP_IMAGES, cfg.image_size)
    out, ref, counts, figures = tower_run(torch, lambda: clip.forward_features(model, px, cfg),
                                          lambda: clip.forward_features(model, px, cfg, "xla"), nvidia_smi)
    fields = held("clip", out, ref, [TOWER_CLIP_IMAGES, cfg.num_patches, cfg.hidden_size], lambda: clip_layers(px))
    record("clip", counts, k1_only(counts, layers), figures, images=TOWER_CLIP_IMAGES, layers=layers, **fields)

    hs = build_vision_tower(TOWER_CLIP, use_s2=True, s2_scales=TOWER_S2_SCALES)
    crops = sum((s // cfg.image_size) ** 2 for s in hs.s2_scales)
    px = pixels(TOWER_S2_IMAGES, max(hs.s2_scales))
    calls, seen = [], {}

    def s2_route(impl):
        def tower(x):
            calls.append(int(x.shape[0]))
            seen["crops"] = x
            return clip.forward_features(model, x, cfg, impl)
        return lambda: s2.multiscale_forward(tower, px, hs.s2_scales, cfg.image_size)

    out, ref, counts, figures = tower_run(torch, s2_route("onepass"), s2_route("xla"), nvidia_smi)
    checks["clip_s2_one_tower_pass"] = set(calls) == {TOWER_S2_IMAGES * crops}
    fields = held("clip_s2", out, ref, [TOWER_S2_IMAGES, cfg.num_patches, hs.mm_hidden_size],
                  lambda: clip_layers(seen["crops"]))
    record("clip_s2", counts, k1_only(counts, layers), figures, images=TOWER_S2_IMAGES, scales=list(hs.s2_scales),
           crops_per_tower_pass=TOWER_S2_IMAGES * crops, mm_hidden_size=hs.mm_hidden_size, **fields)
    del model, out, ref, px
    release(torch)

    # InternViT-6B at 448 px, all 48 layers
    h = build_vision_tower(TOWER_INTERN, select_layer=-1)
    cfg = h.config
    t0 = time.perf_counter()
    model = init_random_intern_vit(cfg, dev, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    px = pixels(TOWER_INTERN_IMAGES, cfg.image_size)
    out, ref, counts, figures = tower_run(torch, lambda: intern_vit.forward_features(model, px, cfg),
                                          lambda: intern_vit.forward_features(model, px, cfg, "xla"), nvidia_smi)
    fields = held("intern_vit", out, ref, [TOWER_INTERN_IMAGES, cfg.num_patches, cfg.hidden_size], lambda: layer_updates(
        torch, intern_vit.embed(model, px, cfg), model.encoder.layer,
        lambda x, layer, impl: intern_vit.encoder_layer(x, layer, cfg, impl)))
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    record("intern_vit", counts, k1_only(counts, cfg.num_hidden_layers), figures, images=TOWER_INTERN_IMAGES,
           layers=cfg.num_hidden_layers, heads=cfg.num_attention_heads, head_dim=cfg.hidden_size // cfg.num_attention_heads,
           weights_gb=weights_gb, init_s=init_s, **fields)
    del model, out, ref, px
    release(torch)

    # RADIO ViT-H/16 on 2 square photos through the tower's own processor
    h = build_vision_tower(TOWER_RADIO)
    rcfg = radio.RadioBackboneConfig()
    model = init_random_radio(rcfg, dev, torch.bfloat16, seed=0)
    towers = {sel: radio.RadioVisionTower(TOWER_RADIO, model=model, backbone_cfg=rcfg, select_feature=sel)
              for sel in ("patch", "dense")}
    rng = np.random.default_rng(8)
    photos = [rng.integers(0, 256, (TOWER_RADIO_PHOTO, TOWER_RADIO_PHOTO, 3), dtype=np.uint8)
              for _ in range(TOWER_RADIO_IMAGES)]
    px = torch.as_tensor(np.stack([towers["patch"].processor(p)["pixel_values"] for p in photos]), device=dev)
    grid = (px.shape[1] // rcfg.patch_size) * (px.shape[2] // rcfg.patch_size)
    feats = {}
    for sel, tower in towers.items():
        feats[sel], _, counts, figures = tower_run(torch, lambda: tower(px.to(torch.bfloat16)), lambda: None, nvidia_smi)
        want_shape = [TOWER_RADIO_IMAGES, grid, tower.hidden_size]
        checks[f"radio_{sel}_shape_finite"] = list(feats[sel].shape) == want_shape and bool(torch.isfinite(feats[sel]).all())
        record(f"radio_{sel}", counts, k1_only(counts, 0), figures, images=TOWER_RADIO_IMAGES,
               input_hw=list(px.shape[1:3]), tokens=grid + rcfg.num_skip, shape=list(feats[sel].shape),
               hidden_size=tower.hidden_size, features_rms=float(feats[sel].float().square().mean().sqrt()))
    checks["radio_dense_ends_in_patch"] = torch.equal(feats["dense"][..., -rcfg.hidden_size:], feats["patch"])
    with torch.no_grad():  # reported: the same weights in f32
        runs["radio_patch"]["rel_l2_vs_f32_copy"] = rel_l2(feats["patch"], radio.radio_forward(model.float(), rcfg, px)[1])
    runs["radio"] = {"h_family": h.family, "mm_hidden_size": h.mm_hidden_size, "spec": h.config.checkpoint}
    del model, towers, feats, px
    release(torch)

    # forward_mpt: MPT-7B behind SigLIP-so400m on phase main's rows, then packed
    mcfg = mpt.MPTConfig()
    vcfg = llama3_8b_cfg().replace(mask_token_id=MPT_MASK_TOKEN, depth_token_id=MPT_DEPTH_TOKEN)
    t0 = time.perf_counter()
    model = init_random(vcfg, dev, torch.bfloat16, seed=0, mpt_cfg=mcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows, pix = draw_rows(vcfg, np.random.default_rng(0), N_ROWS)
    spliced = [expand_rows([r], None, max_len=vcfg.model_max_length, tokens_per_image=NUM_TOKENS_PER_IMAGE,
                           mask_token_id=MPT_MASK_TOKEN, depth_token_id=MPT_DEPTH_TOKEN, regions_per_image=N_REGIONS,
                           pad_to=PAD_BUCKET) for r in rows]
    batches = {
        "mpt": splice(torch, vcfg, rows, pix)[0],
        "mpt_packed": VLMInputs.from_spliced(pack_rows(spliced, max_len=2 * PAD_BUCKET), *pix, device=DEVICE,
                                             dtype=torch.bfloat16),
    }
    tower_layers_n = vcfg.vision.num_hidden_layers + 1 + vcfg.vision.select_layer
    for label, inputs in batches.items():
        out, ref, counts, figures = tower_run(torch, lambda: vlm.forward_mpt(model, vcfg, mcfg, inputs),
                                              lambda: vlm.forward_mpt(model, vcfg, mcfg, inputs, "xla"), nvidia_smi)

        def tower_layers(inputs=inputs):
            x = siglip.embed(model.vision_tower, torch.cat([inputs.images, inputs.depths]), vcfg.vision)
            return layer_updates(torch, x, model.vision_tower.vision_model.encoder.layers[:tower_layers_n],
                                 lambda x, layer, impl: siglip._encoder_layer(x, layer, vcfg.vision, impl))

        B, S = inputs.input_ids.shape
        fields = held(label, out, ref, [B, S, mcfg.vocab_size], tower_layers)
        live = inputs.segment_ids != 0
        fields["greedy_agreement_vs_plain_live_positions"] = float((out.argmax(-1) == ref.argmax(-1))[live].float().mean())
        segs = [len(set(r) - {0}) for r in inputs.segment_ids.tolist()]
        record(label, counts, k1_only(counts, tower_layers_n), figures, rows=B, bucket=S, segments_per_row=segs,
               init_s=init_s, **fields)
    checks["mpt_packed_two_samples_a_row"] = runs["mpt_packed"]["segments_per_row"] == [2] * (N_ROWS // 2)
    del model, batches, out, ref
    release(torch)

    emit({"phase": "towers", "ok": all(checks.values()), "seconds": time.perf_counter() - t_phase, "checks": checks,
          "runs": runs, "model": "clip vit-l/14-336 (+ S² 336/672/1008), internvit-6b (448 px, 48 layers), "
                                 "radio vit-h/16 (768 px), mpt-7b + siglip-so400m; bf16, random from fixed seeds"})
    check(all(checks.values()), f"towers checks failed: {[k for k, v in checks.items() if not v]}")
    return add_counts(*totals)


PARALLEL_STORE_TIMEOUT_S = 300


def phase_parallel(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The parallel path (see the module docstring, 13): (a), (b), (c) and
    (e) on a one-rank NCCL group, torn down at the end.  Returns the summed
    launch counts of the parallel runs (the unwrapped and plain reference
    runs are not counted)."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
    from spatialrgpt_tpu_torch.parallel.context import SPContext, set_sp_context
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.serving.generate import generate
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_train_step, shard_state
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    checks, runs, totals = {}, {}, []
    # one host and no network: NCCL's bootstrap and the checkpoint's gloo
    # group on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "store"), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=PARALLEL_STORE_TIMEOUT_S),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        checks["nccl_group"] = dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = mesh_lib.make_mesh(1, 1, 1, 1)
        cfg = llama3_8b_cfg()

        # (a) the align step under FSDP2, Ulysses (degree 1) on K4
        t0 = time.perf_counter()
        model = init_random(cfg, dev, torch.bfloat16, seed=0)
        ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                               tune_mm_projector=True, tune_region_extractor=True, total_steps=100)
        optimizer = build_optimizer(model, ocfg)
        batch = train_batch(torch, cfg, np.random.default_rng(0), TRAIN_ROWS)
        tuned = [n for n, p in model.named_parameters() if n.startswith(("mm_projector.", "region_extractor."))]
        params = dict(model.named_parameters())
        ref_loss, ref_grads = loss_and_grads(torch, cfg, model, batch, [params[n] for n in tuned])
        state = shard_state(create_train_state(model, optimizer), mesh)
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp", inner_impl="pallas"))
        step_fn = make_train_step(cfg, state.optimizer, attn_impl="ulysses", remat=True, frozen=("llm", "vision"),
                                  ce_chunk=CE_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        counts = read_counts()
        set_sp_context(None)
        totals.append(counts)
        params = dict(state.model.named_parameters())
        grads = torch.cat([local_tensor(params[n].grad).float().flatten() for n in tuned])  # one rank: whole
        loss_rel = abs(float(metrics["loss"]) - float(ref_loss)) / abs(float(ref_loss))
        grad_rel = rel_l2(grads, ref_grads)
        n_dtensors = sum(hasattr(p, "device_mesh") for p in params.values())
        checks.update(a_parameters_are_dtensors=n_dtensors > 0, a_loss_vs_unwrapped=loss_rel <= TRAIN_LOSS_REL_BOUND,
                      a_grads_vs_unwrapped=grad_rel <= TRAIN_GRAD_REL_BOUND,
                      a_launch_counts=counts == {**attention_train_counts(cfg), **NO_QUANT})
        runs["a_align_step_fsdp2"] = {
            "loss": float(metrics["loss"]), "unwrapped_loss": float(ref_loss), "loss_rel": loss_rel,
            "loss_rel_bound": TRAIN_LOSS_REL_BOUND, "grad_rel_l2": grad_rel, "grad_rel_bound": TRAIN_GRAD_REL_BOUND,
            "grad_norm": float(metrics["grad_norm"]), "dtensor_parameters": n_dtensors,
            "parameters": len(params), "launches": counts,
            "smoke_figures_not_a_benchmark": {"step_s": step_s, "phase_a_s": time.perf_counter() - t0,
                                              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                                              "card": nvidia_smi}}
        del model, state, optimizer, step_fn, params, grads, ref_grads, batch
        release(torch)

        # (b) generate through the tensor-parallel path, bf16 and W8A8; (c)
        # the engine with the mesh on (b)'s bf16 model
        rows, pixels = draw_rows(cfg, np.random.default_rng(0), N_ROWS)
        inputs, plens = splice(torch, cfg, rows, pixels)
        for label, make in (("bf16", lambda: init_random(cfg, dev, torch.bfloat16, seed=0)),
                            ("w8a8", lambda: init_random_quantized(cfg, dev, w8a8=True, seed=0))):
            model = make()

            def serve(m=None):
                out = generate(model, cfg, inputs, plens, max_new_tokens=MAX_NEW, eos_token_id=-1, kv_quant=True)
                torch.cuda.synchronize()
                return out

            plain = serve()
            mesh_lib.tp_shard_model(model, mesh)
            reset_counts()
            t1 = time.perf_counter()
            got = serve()
            gen_s = time.perf_counter() - t1
            counts = read_counts()
            totals.append(counts)
            quantized = label == "w8a8"
            want = serve_counts(cfg, N_ROWS, PAD_BUCKET, MAX_NEW, quantized)
            checks[f"b_{label}_tp_path"] = model.llm.tp is not None and model.llm.tp.size == 1
            checks[f"b_{label}_tokens_equal_plain_serve"] = torch.equal(got.tokens, plain.tokens)
            checks[f"b_{label}_launch_counts"] = counts == want
            runs[f"b_generate_tp_{label}"] = {
                "rows": N_ROWS, "bucket": PAD_BUCKET, "max_new": MAX_NEW, "tokens_row0": got.tokens[0, :8].tolist(),
                "first_logits_max_abs_diff": float((got.first_logits - plain.first_logits).abs().max()),
                "launches": counts if counts != want else "as expected",
                "smoke_figures_not_a_benchmark": {"generate_s": gen_s, "card": nvidia_smi}}
            if label == "bf16":
                requests = [splice(torch, cfg, [rows[i]], tuple(a[i : i + 1] for a in pixels), host_index_fields=True)
                            for i in range(N_ROWS)]
                eng = ServingEngine(model, cfg, num_slots=N_ROWS, prompt_bucket=PAD_BUCKET, max_new_tokens=MAX_NEW,
                                    kv_quant=True, admit_width=N_ROWS, mesh=mesh)
                log = record_engine(eng)
                reset_counts()
                ids = [eng.submit(x, int(p[0]), max_new_tokens=MAX_NEW) for x, p in requests]
                done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=ENGINE_MULTI)}
                torch.cuda.synchronize()
                counts = read_counts()
                totals.append(counts)
                ref_toks = got.tokens.tolist()
                equal = sum(done.get(i) == ref_toks[b] for b, i in enumerate(ids))
                want = engine_counts(cfg, log, N_ROWS, PAD_BUCKET, quantized=False)
                checks["c_engine_tokens_equal_tp_generate"] = equal == N_ROWS
                checks["c_engine_one_admission"] = log["admissions"] == [N_ROWS]
                checks["c_engine_launch_counts"] = counts == want
                checks["c_engine_cache_heads"] = eng.cache.k_s.shape[-1] == cfg.llm.num_key_value_heads
                runs["c_engine_mesh"] = {"rows_equal_to_tp_generate": equal, "admissions": log["admissions"],
                                         "windows": log["windows"], "launches": counts if counts != want else
                                         "as expected"}
                del eng
            del model, plain, got
            release(torch)

        # (e) train.main from argv on the group, the orbax backend: one micro
        # step stopped by the time limit with a checkpoint, then resumed
        out_dir = os.path.join(work, "main")
        argv = ALIGN_FLAGS + FAMILY_MAIN_CUTS + ["--ckpt_backend", "orbax", "--output_dir", out_dir]
        main_totals = {}
        first, run1, peak1 = recipe_main(torch, argv, main_totals)
        ckpt1 = os.path.join(out_dir, "checkpoint-1", "state_orbax", ".metadata")
        saved_first = os.path.exists(ckpt1)
        second, run2, peak2 = recipe_main(torch, argv, main_totals)
        ckpt2 = os.path.join(out_dir, "checkpoint-2", "state_orbax", ".metadata")
        totals.append(main_totals)
        want = times(2, {**attention_train_counts(cfg), **NO_QUANT})
        checks.update(e_first_run_stopped_after_one_step=first == {"status": "timeout", "step": 1},
                      e_orbax_checkpoint_written=saved_first, e_resumed_to_step_2=second == {"status": "timeout",
                                                                                              "step": 2},
                      e_second_checkpoint=os.path.exists(ckpt2) and not os.path.exists(ckpt1),
                      e_losses_finite=all(np.isfinite(s["metrics"]["loss"]) for s in run1["steps"] + run2["steps"]),
                      e_launch_counts=main_totals == want)
        runs["e_train_main_orbax"] = {"results": [first, second], "steps": [run1["steps"], run2["steps"]],
                                      "launches": main_totals if main_totals != want else "as expected",
                                      "smoke_figures_not_a_benchmark": {"peak_mem_gb": [peak1, peak2],
                                                                        "card": nvidia_smi}}
    finally:
        set_sp_context(None)
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "parallel", "ok": all(checks.values()), "seconds": time.perf_counter() - t_phase,
          "checks": checks, "runs": runs,
          "model": "llama3-8b + siglip-so400m, bf16 (b: also W8A8), random from fixed seeds; one NCCL rank"})
    check(all(checks.values()), f"parallel checks failed: {[k for k, v in checks.items() if not v]}")
    return add_counts(*totals)


def release(torch) -> None:
    """Between phases: free what the last phase left (its model may sit in
    a reference cycle until the collector runs), so that the next phase's
    peak memory counts only its own tensors."""
    gc.collect()
    torch.cuda.empty_cache()


def profile_run(torch, fn, out_dir, name):
    """One warm call of ``fn`` under torch.profiler: device-busy share and
    the operator table by device time, written to ``out_dir/<name>_ops.txt``.
    Device time is summed over the device's own events (kernels, copies); an
    operator's "self device time" repeats the time of the kernels it
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events; a profiler range (a demo stage) also appears
    # on the device as a user annotation spanning its kernels
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in device)
    with open(os.path.join(out_dir, f"{name}_ops.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:25]
    spans = [e for e in events if e.device_type == DeviceType.CUDA and e.is_user_annotation]
    emit({"phase": "profile", "ok": True, "run": name, "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
          "top_kernels_ms_calls": {e.key[:120]: [e.self_device_time_total / 1e3, e.count] for e in top},
          "spans_device_ms_calls": {e.key[:120]: [e.device_time_total / 1e3, e.count] for e in spans}})


# the paths after the kernel phase, in order: name -> its phase (each
# returns the kernels' launch counts of its main path)
PATHS = {
    "serve": lambda torch, smi, prof: phase_main(torch, smi),
    "serve_w8a8": phase_serve_w8a8,
    "engine": phase_engine,
    "train": lambda torch, smi, prof: phase_train(torch, prof),
    "align_w8a8": phase_align_w8a8,
    "qlora": phase_qlora,
    "recipe": lambda torch, smi, prof: phase_recipe(torch, smi),
    "eval": lambda torch, smi, prof: phase_eval(torch, smi),
    "demo": lambda torch, smi, prof: phase_demo(torch, prof),
    "synth": phase_synth,
    "families": phase_families,
    "families_train": phase_families_train,
    "synth_train": phase_synth_train,
    "towers": phase_towers,
    "parallel": phase_parallel,
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile a W8A8 serve TTFT and generate run, one wave "
                        "of the W8A8 engine, one align step, one W8A8 align step of each backward, one QLoRA step "
                        "and one demo pipeline run; write their tables to DIR")
    parser.add_argument("--paths", metavar="A,B", help="run only these paths after the build (of: "
                        f"{', '.join(PATHS)}; 'none' for none): a partial run, which ends without the kernel phase, "
                        "the kernels line and the ok line")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "spatialrgpt_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository (spatialrgpt_tpu_torch/ is missing)",
              file=sys.stderr)
        return 2
    paths = list(PATHS) if args.paths is None else [p for p in args.paths.split(",") if p != "none"]
    unknown = set(paths) - set(PATHS)
    if unknown:
        parser.error(f"unknown paths {sorted(unknown)}")
    sys.path.insert(0, ROOT)
    import torch

    phase = "device"
    counts = {}
    try:
        smi = phase_device(torch)
        phase = "build"
        phase_build()
        if args.paths is None:
            phase = "kernels"
            rows = phase_kernels(torch)
            phase = "grads"
            phase_grads(torch)
        for phase in paths:
            counts[phase] = PATHS[phase](torch, smi, args.profile)
            release(torch)
    except Exception as e:  # report which phase failed, then exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    if args.paths is not None:
        return 0
    for row in rows:
        by_path = {path: part[row["name"]] for path, part in counts.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        for other in row["other_shapes"]:  # a form with a count of its own (K3's int4 form)
            if "counted_as" in other["shape"]:
                other["launches"] = sum(part[other["shape"]["counted_as"]] for part in counts.values())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
