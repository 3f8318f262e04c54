"""Drive the PyTorch port's serving, training and evaluation paths on one
CUDA card, in the paper recipe's fp32 and in its bf16 clip_conv_tpu form,
Table 2's DeepMel cell, feature decoding, the encode task and ConvRNN,
the paper's grid chain (grid runner, grid evaluation, paper table),
data-parallel training, the wav2vec 2.0 targets (random=True) with
the planted-map rehearsal, the train step's remaining options, the
serving export with the checkpoint readers, the rest of the model
zoo with int8 evaluation pools, resuming training from the JAX package's
checkpoint.pkl, the notebook helpers, the native batch gather, and ranks
on several hosts with the event query.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every kernel from brainmagick_tpu_torch/csrc with nvcc into the
gitignored brainmagick_tpu_torch/_build/, so the script and the checkout's
sources are all it needs. Phases, each printing its lines; any failed
check raises, so the script exits non-zero and prints no result:

1. card and environment: the card's name and power limit (nvidia-smi),
   torch/CUDA versions, and torch's TF32 flags as they are: the script
   leaves them at torch's defaults, since the entry points turn TF32 off
   themselves (precision.exact_fp32), and checks at the end that they are
   unchanged;
2. build: the CUDA kernels from brainmagick_tpu_torch/csrc (nvcc), timed
   as set-up;
3. each kernel against its plain PyTorch version on the card, at a few
   ragged shapes and at the shapes its path gives it, with the median time
   of both at the latter, of one PyTorch call that computes the same
   function where there is one, and the least time the card could take,
   all inside precision.exact_fp32 so that plain versions and library
   calls are fp32 (normalize bit-equal with NaN and inf, bf16 meg and rec
   tables, its stage's device activities in torch.profiler; conv_stats
   forward and backward in fp32 and bf16, both on the tensor-core route,
   at every edge of that route, k = 9 and 11 included, and at every
   encoder layer shape, two calls of each type bit-equal, each type timed
   beside cuDNN's conv in that type; inv_norms within 1e-5 of the plain
   version in fp32, bf16 and int8 at ragged shapes, rows off 16 bytes and
   an all-zero row, then at the retrieval bank's, the evaluation's and a
   test stage's shapes, two calls bit-equal, timed beside the plain
   version and torch.linalg.vector_norm, and one launch a
   losses.retrieval_scores call);
4. the serving slice at the clip_conv preset's full width (273 sensors,
   361 samples, 1024 features, random seeded weights): four requests
   through Server.forward_batch and Server.probabilities against a bank of
   2048 candidates, the largest one again warm (fp32 scoring, then bf16
   scoring as clip.compute_dtype = "bfloat16" sets it, against the bank
   stored in bf16), each kernel's launch count over all of it, and the
   smallest request held against the same server on the CPU;
5. the training slice at the same width with simpleconv.fused_conv_bn:
   five Adam steps of Trainer.step at B=256 on one seeded batch (finite
   losses that fall, conv_stats launched once per encoder layer per step,
   every launch fp32 on the tensor-core route, normalize once per step),
   the warm step's time and peak memory, and a B=8 step held against the
   same trainer on the CPU;
6. the offline evaluation at the same width: nine seeded B=256 batches
   (2,304 predictions, one word event each, over 2,150 segments; rows of
   one segment share its features) through eval.load_test_data, a
   profiled eval.build_probs, eval.run_eval with fp32 and with bf16
   scoring and once with the outputs as the predictions (top-1 must be
   1), wer.get_wer, and again with the outputs as the estimates (wer must
   be 0); each pass's wall time, transfers and peak memory, the launch
   counts the loops imply, and 64 predictions x 300 candidates of
   build_probs held against the same call on the CPU;
7. the clip_conv_tpu recipe at the same width (bf16 compute and
   estimates, no conv bias before BatchNorm, the fused head, tanh GELU,
   bf16 scores and the bf16 wire): phase 4's four requests through Server
   against the bank stored in bf16, then the warm B=256 forward and
   scoring, and phase 5's five Adam steps with fused_conv_bn (conv_stats
   10 times a step, every launch bf16 on the tensor-core route), each
   beside the fp32 recipe's, every forward through the fused head; the
   B=1 request and a B=8 step held against the same server and trainer
   on the CPU at RECIPE_TOL, beside the same step with fp32 compute at
   STEP_TOL and each bf16 gradient's distance from the fp32 one against
   the CPU's (RECIPE_SPREAD);
8. the training CLI (``brainmagick_tpu_torch.train.main``, in this
   process) on the fake study with the clip_conv preset and
   fused_conv_bn: one recording's preprocessed raw on the card against
   the CPU (PREPROCESS_TOL), then CLI_EPOCHS epochs over all four
   recordings at B=64 (120 mels, 361 samples at 120 Hz) in a temporary
   folder: each split's segment count, history-torch.json with finite
   losses, the test stage's WER keys, done-torch.json, conv_stats 10
   times a train step (fp32 on "tc"), normalize once a forward, nt_matmul
   in each test stage, and the data path's and the loop's times; a rerun with
   optim.epochs=3 and continue_sig that restores the XP and trains one
   epoch; one epoch of the clip_conv_tpu recipe (bf16 conv_stats, the
   loaders sending bf16); then each kernel against its plain version at
   the shapes that run gave it (B=64, the 160 test windows' WER), timed
   as in phase 3 and added to its other_shapes;
9. the paper's four studies (STUDY_TREES), each a synthetic tree written
   in a temporary folder in the study's on-disk format, at its real
   sensor count and rate, by the port's writers, csv, json, wave and
   scipy.io.savemat: gwilliams2022 (KIT .con, 208 MEG at 1000 Hz, BIDS
   events.tsv), audio_mous (CTF .ds, 273 MEG + 28 references + UPPT001
   at 1200 Hz, Presentation logs, TextGrids), brennan2019 (MATLAB raw and
   proc structs, 60 EEG + VEOG + AUD at 500 Hz, the story CSV) and
   broderick2019 (MATLAB eegData, 128 EEG at 128 Hz, gentle JSON and
   transcripts), two recordings each, the mock speech as every stimulus.
   For each: the first recording's raw as its adapter reads it against
   the array written (within half a quantization step, then bit-equal
   after a second write and read; bit-equal for MATLAB), the words of
   the events against the words written, its preprocessing on the card
   against the CPU (PREPROCESS_TOL), then ``train.main`` for one epoch of
   the clip_conv_tpu recipe with fused_conv_bn at B=256 (finite losses,
   at least two train batches, conv_stats 10 times a train step in bf16
   on "tc", normalize once a forward, nt_matmul in the test stage), the
   read, preprocess, track, step and epoch times, and each kernel
   against its plain version at the shapes the run gave it (normalize at
   the study's sensor count), added to its other_shapes; the launch
   counts go into launches_by_path as study_<selection>;
10. Table 2's "MelSpectrum + DeepMel" cell on phase 9's gwilliams2022
   tree (kept for it; phases 8-12 share one temporary folder):
   ``train.main`` with clip_conv, deep_mel and fused_conv_bn at B=256
   for one epoch, DeepMel at its published 320 x 10 -> 768 and the
   encoder at the paper's width with 768 outputs (finite losses,
   history-torch.json and done-torch.json, conv_stats 10 times a train
   step in fp32 on "tc" and so none inside DeepMel, normalize once a
   forward, nt_matmul in the test stage; deepmel_train); that XP
   evaluated by signature with ``eval.main`` in this process (the six
   files in eval/<sig>-torch, top-1/5/10 in [0, 1], normalize once a
   forward, nt_matmul as build_probs' loop implies; run_eval's seconds
   and peak memory; eval_sig) and again on the CPU, whose first
   HELD_PREDS probabilities hold the card's to EVAL_SIG_TOL; phase 8's
   clip_conv_tpu XP evaluated by signature with bf16 scoring
   (eval_sig_recipe); each kernel against its plain version at these
   runs' shapes (nt_matmul at DeepMel's K = 768 x 343), added to its
   other_shapes;
11. feature decoding on the same tree: ``train.main`` with clip_conv,
   fused_conv_bn, optim.loss=regression_classification and class weights
   (optim.use_weighting) over WordEmbedding, PartOfSpeech, Pitch and
   WordSegment (303 targets, 324 outputs) at B=256 for one epoch: first
   without allow_fallback, which must raise MissingModelError before any
   step (a real study, and no spacy model on the card's machine), then
   with it (finite losses, history-torch.json and done-torch.json,
   conv_stats 10 times a train step in fp32 on "tc", normalize once a
   forward, nt_matmul never; the test stage's accuracies in [0, 1] and
   finite L2 and correlations; regression_words); the track render's
   seconds and Pitch's alone, the step's device time and peak memory; a
   B=HELD_B step of the same configuration on the card against the CPU
   at STEP_TOL; normalize and conv_stats against their plain versions at
   this run's shapes, added to their other_shapes;
12. the encode task and ConvRNN on the same tree, each ``train.main`` at
   its preset's published widths, B=256, one epoch (ENCODE_RUNS): the
   convrnn preset over MelSpectrum (phase 15 trains it on its default
   wav2vec 2.0 features; encode_convrnn), decoder_convrnn
   (decoder_convrnn) and clip_conv with task.type=encode, optim.loss=l1
   and fused_conv_bn (encode_simpleconv): finite losses,
   history-torch.json and done-torch.json, a finite corr_meg or an
   acc_WordSegment in [0, 1], normalize once a forward, conv_stats 20
   times a train step (fp32 on "tc") for SimpleConv's two fused encoders
   and never for ConvRNN's, nt_matmul never; each run's step device
   time, peak memory, track, scaler and phase seconds; the ENCODE_HELD
   B=HELD_B steps against the CPU at STEP_TOL (the convrnn preset, a
   ConvRNN with attention, a bidirectional LSTM and reversed time, whose
   gradients are held in float64 as ENCODE_HELD says why, and SimpleConv
   encoding); the convrnn step's device time in
   torch.profiler, split into the LSTM's forward and backward, the convs
   and the rest; normalize, and conv_stats at the features encoder's
   first layer [256, 120, 343], against their plain versions, added to
   their other_shapes;
13. the paper's grid chain through the port's CLI layer on the same tree
   (GRID, GRID_EXTRA): the rehearsal grid (clip_conv_tpu at the paper's
   width, B=16, MelSpectrum at 120 mels, one epoch of GRID_BATCHES
   batches, fused_conv_bn) trained by ``grids.runner.run_jobs`` in this
   process (conv_stats 10 times a train step in bf16 on "tc", normalize
   once a forward, nt_matmul in the test stage, the TF32 flags and the
   card's memory handed back; grid_train); its 128-sensor variant
   (GRID_SUBSAMPLE) by ``--run --workers=2`` in a subprocess; a second
   --run that skips both on done-torch.json; --table and --sbatch as
   text; ``eval grid=rehearsal`` of the first in this process (grid_eval)
   and of the second with workers=2, into eval/<sig>-torch;
   ``paper_tables table`` of each (accuracy in [0, 1]); GRID_STEPS warm
   train steps of the second, restored by signature, its mask on the card
   (grid_subsample_steps); each XP's warm step in device time and peak
   memory, the phase's wall seconds; each kernel against its plain
   version at the phase's shapes, added to its other_shapes;
14. data-parallel training through torch.distributed on the same tree
   (``run_parallel_phase``): the train CLI under ``python -m
   torch.distributed.run --standalone --nproc_per_node=1`` (one rank,
   NCCL) with ``preset=clip_conv_v5e8 optim.batch_size=256`` for
   PARALLEL_BATCHES batches, a valid and a test stage, against the same
   overrides without the launcher (losses and test metrics within
   LAUNCHER_TOL, the same launches; parallel_launcher, parallel_cli);
   then two ranks sharing the card over gloo (NCCL takes one rank a
   card) at PARALLEL_RANK_B a rank in the clip_conv_tpu recipe:
   negatives_group_size=0's eval-mode loss and gradients against one
   rank at twice the batch, PARALLEL_STEPS train steps with the
   negatives gathered over both ranks and passed around their ring (the
   ring's held to the gathered), ``losses.ring_scores`` against one
   card's scores, each rank's step device time, peak memory, launches
   (parallel_ranks) and the collectives' share of a profiled step; each
   kernel at the per-rank shapes, added to its other_shapes;
15. the wav2vec 2.0 features with random=True (``run_wav2vec_phase``):
   (a) the features' seeded xlsr-53 network, built on the host, against
   the per-tensor SHA-256 digest of HF's seeded init (W2V_GOLDEN); (b) a
   rehearsal recording's Wav2VecTransformer track rendered on the card
   (s per s of audio, peak memory) and W2V_CPU_EVENTS of its sound events
   through the same weights on the CPU, each collected hidden state
   within W2V_TOL of the card's; (c) the JAX package's planted-map
   rehearsal (scripts/rehearsal.py) written with the port's writers: 4
   KIT subjects whose MEG is a seeded mix of that track plus noise, the
   rehearsal grid trained by ``runner.run_jobs`` in this process at the
   paper's width with its own run length (wav2vec_rehearsal), evaluated
   by signature with REHEARSAL_NEGATIVES negatives (wav2vec_eval) and
   tabulated by ``paper_tables``: top-1 at least max(0.15, 5 x chance);
   (d) two train steps of the convrnn preset on its default
   Wav2VecTransformer on the kept gwilliams2022 tree (wav2vec_convrnn);
   each kernel at the rehearsal's shapes, added to its other_shapes;
16. the train step's options on the same tree (``run_options_phase``,
   OPTIONS_RUNS): ``train.main`` of the clip_conv_tpu recipe at the
   paper's width, B=256, with sampled negatives from the pool
   (optim.negatives=512), the SVD penalty, the three dropouts on the
   explicit generator, the rewrite conv, LayerScale, the post-skip conv
   and the "btc" estimate, OPTIONS_BATCHES train batches, the valid pass
   and the test stage (options_train: conv_stats 10 times a train step in
   bf16 on "tc", normalize once a forward, nt_matmul in the test stage);
   a B=HELD_B step of it with fp32 compute against the CPU at STEP_TOL
   from the same weights, dropout draws and negatives; the SVD penalty on
   the card against the CPU (SVD_TOL); the warm step with and without
   the pool's work, the penalty alone, and their shares of the step in
   torch.profiler (the pool's device-to-host copies and host time, the
   penalty's forward); then clip.linear with twin off for 2 steps
   (options_linear, nt_matmul never: the projection scores through
   ClipLoss.get_scores) and its XP evaluated by signature through the
   trained projection (options_eval_sig); each kernel at run 1's shapes,
   added to its other_shapes;
17. the serving export and the checkpoint readers (``run_serve_phase``):
   ``serve.main`` in this process on phase 8's fp32 XP (export_train) and
   its clip_conv_tpu XP (export_recipe): the forward and scorer artifacts
   with a symbolic batch, saved, reloaded and self-checked (normalize 5
   times, nt_matmul 4); every artifact loaded and called in one fresh
   process at B=2 and B=256 from one file (normalize once a forward
   call, nt_matmul once a scorer call, conv_stats never; no model code
   imported; the same bits with the caller's TF32 on), held to
   Solver.forward_batch (EXPORT_TOL of max|x|) and Server.probabilities
   (EXPORT_PROBS_TOL); the export seconds, artifact MB, load seconds and
   the warm B=256 artifact call against Solver.forward_batch, the batch
   on the host and on the card, with each one's device time; a
   paper-width unfused clip_conv reference-named checkpoint (a seeded
   model's ``convert.export_state_dict``, saved as {"best_state": ...})
   through ``convert.main`` (bit for bit by signature) and ``serve.main``
   (export_convert); the normalize and nt_matmul wrappers' times before
   and after the custom-op registration at phase 3's shapes; each kernel
   at the artifact calls' shapes, added to its other_shapes;
18. the rest of the model zoo and int8 pools (``run_zoo_phase``): each
   ZOO_RUNS option of SimpleConv (per-subject merger heads, a
   DualPathRNN, the spectrogram branch at n_fft=16) trained ZOO_STEPS
   Adam steps at the clip_conv preset's full width on phase 5's batch,
   in fp32 and in the clip_conv_tpu recipe, with fused_conv_bn (finite,
   falling losses; conv_stats once a fused encoder layer a step, at
   [256, 4860, 48] for the spectrogram's first layer; normalize once a
   forward; the fused head in the recipe but under per-subject heads;
   the warm step and peak memory beside phases 5 and 7; the B=8 step
   against the CPU at STEP_TOL and RECIPE_TOL; a torch.profiler split of
   the option's part: the LSTMs, the rfft branch and the strided head,
   the heads' gather and einsum); the strided DeepMel forward and
   backward against the CPU (its JAX solver fails on the shortened
   targets, so no step trains it); phase 6's evaluation with
   test.pool_int8 (run_eval and get_wer beside phase 6's fp32 metrics,
   the pool's bytes, normalize once a forward and no nt_matmul; 64
   predictions x 300 candidates against the CPU, the int8 rows and int32
   partial sums bit-equal; the evaluation's 2048 x 2048 x 351,232 chunk
   in int8 timed beside the bf16 nt_matmul and cuBLAS, with its bound);
   conv_stats at the spectrogram layer's shape, added to its
   other_shapes;
19. resuming, the notebook helpers and the native gather on phase 9's
   gwilliams2022 tree (``run_resume_phase``): (a) the clip_conv preset
   with fused_conv_bn at the paper's width, B=256, trained RESUME_STEPS
   Adam steps and written as the JAX package's checkpoint.pkl
   (``convert.save_jax_checkpoint``), resumed by a fresh solver (its
   weights, statistics and Adam state bit-equal to the written ones) and
   trained RESUME_STEPS more, held to an uninterrupted run at STEP_TOL
   (each loss, and the whole state in norm), conv_stats 10 times a
   resumed step (resume_train), then its test stage (resume_test,
   nt_matmul); (b) on phase 11's XP by signature,
   ``play.SentenceFeatures`` of a typed sentence, ``Solver.predict`` of
   a test window's MEG and features against the CPU at REFERENCE_TOL
   (predict: normalize once a call) and ``play.attention_map``; on
   phase 12's encode_simpleconv XP, whose estimate reads the features,
   ``play.predict`` of the sentence without and with ``meg_init``
   (play_predict: normalize once a ``Solver.predict``), each not 0;
   (c) the native gather at [256, 208, 361] from
   the recording's memmap, bit for bit against its plain version in fp32
   and bf16, timed beside it, and the train loader's epoch with either;
   normalize and nt_matmul at these runs' shapes, added to their
   other_shapes;
20. ranks on several hosts and the event query on the same tree
   (``run_hosts_phase``): ``train.main`` of the clip_conv_tpu recipe at
   the paper's width with fused_conv_bn, B=256 in one pool over HOSTS
   hosts of HOSTS_RANKS ranks (64 a rank), four processes spawned on the
   one card with a two-node launcher's environment, gloo between them,
   a cache folder a host and the XP folder shared, HOSTS_BATCHES train
   steps, the valid pass and the test stage (hosts_hosts: conv_stats 10
   times a train step in bf16 on "tc", normalize once a forward, nt_matmul
   in each host's test stage); the same four ranks as one host
   (hosts_one_host), whose train and valid losses the hosts' must give
   within LAUNCHER_TOL; each host's test-stage metrics against its rows
   scored in this process (LAUNCHER_TOL), the reported ones their mean;
   each rank's warm step device time, peak memory and dataset build;
   HOSTS_QUERY as dset.condition builds the splits without pandas, the
   test split's HOSTS_QUERY_SEGMENTS segments as on the CPU; each kernel
   at a rank's shapes, added to its other_shapes.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it raises at once.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import typing as tp
from pathlib import Path

import numpy as np
import torch

SEED = 0
#: phase 7's preset: the paper recipe in bf16 (see the module docstring)
RECIPE = "clip_conv_tpu"
#: clip_conv at full width: sensors, samples (3 s at 120 Hz), features
C, T, F = 273, 361, 1024
N_RECORDINGS = N_SUBJECTS = 4
#: the recording whose sensors past this index have no position
MASKED_RECORDING, VALID_SENSORS = 3, 208
REQUESTS = (256, 256, 64, 1)
N_CANDIDATES = 2048
LIMIT = 20.0                     # norm.max_scale
SCORE_K = F * (T - 18)           # F x T' after the 150 ms offset: 351,232
#: nt_matmul: max |kernel - plain| / (|a_m| |b_n|), both fp32-accumulated
MATMUL_TOL = 1e-6
#: conv_stats: each error over its Cauchy-Schwarz bound. y: |dy| / (|w_o|
#: |x window|); s, ss: over the sums of that bound and of its square; dx,
#: dw: over |w[:, c]| |dY_b| and |x_c| |dY_o|. fp32: both sides accumulate
#: in fp32 in other orders (cuDNN against the kernel, torch.sum against
#: the kernel's fixed-order partial sums).
CONV_TOL = 1e-5
#: bf16: y is the kernel's fp32 accumulator rounded once to bf16, so it
#: may land one bf16 rounding (2^-8 of |y|) from the plain version's fp32
#: y on top of CONV_TOL; the kernel's backward rounds dY to bf16 where the
#: plain version's fp32 autograd does not (2^-7 of the bound)
CONV_GRAD_TOL_BF16 = 2 ** -7
#: (B, C, O, T, dilation, k) checked in fp32 and bf16: partial tiles in
#: every dimension, and the widest halo at a short T
RAGGED_CONV = ((1, 1, 1, 1, 1, 3), (2, 3, 5, 7, 2, 3), (2, 17, 33, 130, 4, 3),
               (3, 270, 320, 37, 16, 3))
#: the other edges of the tensor-core route, in fp32 and bf16: k in {1, 5,
#: 7}, T a multiple of 4 (fp32's alignment) and not of 8 (bf16's), B=1, O
#: not a multiple of its tile width (200 in tiles of 160, 72 in one of
#: 128), a tap's x box wholly outside the sequence (k=7, d=64, T=37), C
#: past one bf16 K step (64 channels) and ragged within the next, and the
#: widths the SIMT kernel before it did not take (k=9 at d=1, k=11 at d=4)
RAGGED_CONV_TC = ((1, 40, 200, 128, 1, 1), (2, 64, 72, 259, 2, 5),
                  (1, 32, 160, 36, 8, 7), (2, 24, 48, 37, 64, 7),
                  (2, 48, 64, 101, 1, 9), (2, 40, 72, 203, 4, 11),
                  (2, 100, 64, 60, 2, 3))
#: the encoder's layers at the paper shape: C=320 at each dilation, and the
#: first layer's C=270
PAPER_CONV = tuple((REQUESTS[0], 320, 320, T - 18, d, 3)
                   for d in (1, 2, 4, 8, 16)) + ((REQUESTS[0], 270, 320,
                                                  T - 18, 1, 3),)
#: the H100's peaks (NVIDIA's data sheet, SXM part, dense): memory bytes/s,
#: TF32 and bf16 tensor-core FLOP/s. An fp32 product on the tensor cores
#: takes three TF32 products (3xTF32), so its bound counts three.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS, BF16_FLOPS = 495e12, 989e12
TRAIN_B, TRAIN_STEPS, HELD_B = 256, 5, 8
#: the B=8 step on the card against the CPU (fp32, TF32 off; cuDNN and the
#: CPU sum in other orders): loss relative, each gradient's max error over
#: its max magnitude, running statistics allclose rtol = atol
STEP_TOL = 1e-4
HELD_LEAVES = ("merger.heads", "subject_layers.weights",
               "encoders.meg.sequence.0.0.weight",
               "encoders.meg.sequence.9.1.weight",
               "encoders.meg.glus.9.0.weight", "final.2.weight")
#: the card's estimates against the CPU's (fp32, TF32 off; cuDNN and the
#: CPU sum in other orders): allclose rtol = atol
REFERENCE_TOL = 1e-4
PROBS_TOL = 1e-5
#: the clip_conv_tpu recipe (phase 7) on the card against the same bf16
#: model on the CPU: the error's norm over the reference's norm, for the
#: estimate, the probabilities, the loss, the held gradients and the
#: running statistics. cuDNN and the CPU accumulate in other orders, so a
#: bf16 rounding may land one step (2^-8 of a value) apart anywhere, and
#: the steps travel through the encoder's ten layers. The B=8 step's
#: gradients go through those layers twice, forward and back, with dY
#: rounded to bf16 at each (cuDNN's bf16 wgrad and dgrad against the
#: CPU's): RECIPE_GRAD_TOL. Two witnesses stand beside that limit: the
#: same step with the recipe's compute in fp32 holds the card to the CPU
#: at STEP_TOL (every structural option, no bf16 rounding), and each held
#: bf16 gradient of the card lies no farther from the CPU's fp32 one than
#: RECIPE_SPREAD times the CPU's own bf16 gradient does (what parts the
#: card from the CPU is bf16 rounding of the size the CPU shows itself).
RECIPE_TOL = 2 ** -5
RECIPE_GRAD_TOL = 2 ** -4
RECIPE_SPREAD = 2.
STEADY_RUNS = 5
#: normalize_clamp_peak beyond the path's shape: B=1, samples shorter and
#: longer than a block, B C T not a multiple of 4 (fp32's vector) nor of 8
#: (bf16's), a (b, c) row longer than the largest block
RAGGED_NORM = ((1, 1, 1), (2, 3, 5), (3, 200, 61), (3, 5, 7), (2, 1, 9001))
#: recordings whose [R, C] tables the normalize checks gather from
NORM_RECORDINGS = 4
#: nt_matmul: every edge of the tile plan (M past each prediction width, N
#: past a bank tile, K within, at and past a K step, aligned and not)
RAGGED_M = (1, 7, 9, 65, 255, 257)
RAGGED_N = (1, 129, 2047)
RAGGED_K = (1, 7, 33, 1000, 4099)
#: inv_norms: max |kernel - plain| / plain, both summing in fp32 in other
#: orders
INV_NORMS_TOL = 1e-5
#: inv_norms beyond the path's shapes, (N, K): one row, K below a vector,
#: K not a multiple of any vector width, rows split over blocks, K = 0
RAGGED_INV_NORMS = ((1, 1), (3, 7), (5, 1001), (1, 351_233), (129, 4099),
                    (2, 0))
#: the evaluation phase: EVAL_BATCHES batches of REQUESTS[0] rows over
#: EVAL_SEGMENTS (sequence, word index) segments of EVAL_SEQUENCES stories
#: and EVAL_WORDS words; the rows past EVAL_SEGMENTS repeat segments
EVAL_BATCHES, EVAL_SEGMENTS = 9, 2150
EVAL_SEQUENCES, EVAL_WORDS = 8, 499
#: prediction rows per scoring call and candidates per block (the eval
#: and WER defaults), the scoring shape's M and N
EVAL_CHUNK = 2048
#: a word event's length, s
WORD_SECONDS = 0.3
#: the card's build_probs against the CPU's on this many predictions and
#: candidates
HELD_PREDS, HELD_CANDIDATES = 64, 300
#: int8 scores of the same int8 operands on the card against the CPU: the
#: same int32 partial sums, added and scaled in fp32 in the same order;
#: max error over the largest magnitude
INT8_SCORE_TOL = 1e-6


def tf32_flags() -> dict:
    return {"torch.backends.cuda.matmul.allow_tf32":
            torch.backends.cuda.matmul.allow_tf32,
            "torch.backends.cudnn.allow_tf32":
            torch.backends.cudnn.allow_tf32}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(n_bytes: float, flops: float = 0., rate: float = TF32_FLOPS
          ) -> tuple:
    """(bound_ms, bound_by): the least time the card could take, the
    larger of `n_bytes` over its memory rate and `flops` over `rate`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def kernel_launches(counts: dict) -> dict:
    """{kernel: launches} of the program's counters (``ops.launch_counts()``
    or the train CLI's ``Program counters`` line), its dotted counters
    (``h2d.bytes``, ``loader.wait_us``, ...) left out."""
    return {k: v for k, v in counts.items() if "." not in k}


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median device time of `fn` over `runs` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(event, own: bool = True) -> float:
    """A torch.profiler event's own device time in µs, or with `own`
    False its children's included (the attributes' names differ across
    torch versions)."""
    prefix = "self_" if own else ""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.


def device_rows(fn, calls: int = 5) -> list:
    """The device activities of one call of `fn` in torch.profiler, over
    `calls` calls after a warm one: (name, launches, µs) per call, the
    longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_activities(prof, calls)


def device_activities(prof, calls: int = 1) -> list:
    """A finished torch.profiler's device activities per call: (name,
    launches, µs), the longest first."""
    rows = [(e.key, e.count / calls, device_us(e) / calls)
            for e in prof.key_averages() if device_us(e) > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    return sorted(rows, key=lambda row: -row[2])


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits, NaN where `want` has NaN (any NaN)."""
    nan = want.isnan()
    return got.shape == want.shape and torch.equal(got.isnan(), nan) and \
        torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                    want.masked_fill(nan, 0).view(torch.int32))


def _norm_case(shape, dtype, device, gen, misaligned=False, nan=False):
    """Seeded normalize operands at [B, C, T]: meg (x 30, so some samples
    peak past LIMIT) in `dtype`, starting one element past a 16-byte
    boundary when `misaligned`; NORM_RECORDINGS recordings' center and
    scale tables; rec [B] with indices past both ends of the tables. With
    `nan`, sample 0 holds a NaN, a +inf and a -inf and the last sample a
    +inf."""
    batch, channels, times = shape
    meg = (torch.randn(shape, generator=gen, device=device) * 30).to(dtype)
    if misaligned:
        buf = torch.empty(meg.numel() + 1, dtype=dtype, device=device)
        meg = buf[1:].view(shape).copy_(meg)
    if nan:
        first, last = meg[0].view(-1), meg[-1].view(-1)
        first[first.numel() // 2] = float("-inf")
        first[-1] = float("inf")
        first[0] = float("nan")
        last[last.numel() // 3] = float("inf")
    center = torch.randn((NORM_RECORDINGS, channels), generator=gen,
                         device=device)
    scale = 0.5 + torch.rand((NORM_RECORDINGS, channels), generator=gen,
                             device=device)
    rec = torch.randint(-2, NORM_RECORDINGS + 2, (batch,), generator=gen,
                        device=device)
    return meg, center, scale, rec


def check_normalize(device: torch.device) -> dict:
    """normalize_clamp_peak against its plain version, bit for bit (NaN
    where it has NaN): the ragged shapes and [256, 273, 361], fp32 and
    bf16 meg, aligned and not, with and without NaN and inf, clip True and
    False, with rec into [4, C] tables and with the tables gathered first
    (rec=None). Then at [256, 273, 361], limit 20, rec into four
    recordings' tables as the serving path gives them: the median time
    through the wrapper, of the kernel alone on prepared out and peak, of
    the old stage (the upcast, the two gathers, then the kernel on the
    gathered tables) and of the plain version, on fp32 and bf16 meg, each
    with its bound, and the device activities of the stage and of the old
    stage in torch.profiler."""
    from brainmagick_tpu_torch.ops import norm

    gen = torch.Generator(device=device).manual_seed(SEED)
    full = (REQUESTS[0], C, T)
    calls, err = 0, None
    for shape in RAGGED_NORM + (full,):
        for dtype in (torch.float32, torch.bfloat16):
            for misaligned in (False, True):
                for nan in (False, True):
                    meg, center, scale, rec = _norm_case(
                        shape, dtype, device, gen, misaligned, nan)
                    index = norm.gather_index(rec, NORM_RECORDINGS)
                    gathered = (center[index].contiguous(),
                                scale[index].contiguous())
                    for clip in (True, False):
                        for tables, kw in (((center, scale), dict(rec=rec)),
                                           (gathered, {})):
                            got = norm.normalize_clamp_peak(
                                meg, *tables, LIMIT, clip=clip, **kw)
                            want = norm._reference_impl(
                                meg, *tables, LIMIT, clip, kw.get("rec"))
                            calls += 1
                            if not all(map(_same_bits, got, want)):
                                raise AssertionError(
                                    f"normalize_clamp_peak {shape} {dtype} "
                                    f"misaligned={misaligned} nan={nan} "
                                    f"clip={clip} rec={bool(kw)} differs "
                                    f"from plain")
                            if (shape, dtype, misaligned, nan, clip) == (
                                    full, torch.float32, False, False, True):
                                if not (want[1] > LIMIT).any():
                                    raise AssertionError("no peak past the "
                                                         "limit")
                                err = max((g - w).abs().max().item()
                                          for g, w in zip(got, want))
                    del meg, center, scale, rec, gathered, got, want
    print(f"normalize_clamp_peak: {calls} calls bit-equal to plain (NaN "
          f"where it has NaN) over {len(RAGGED_NORM) + 1} shapes x fp32/bf16"
          f" x aligned/not x with/without NaN and inf x clip True/False x "
          f"rec/gathered tables")

    meg, center, scale, _ = _norm_case(full, torch.float32, device, gen)
    rec = torch.arange(full[0], device=device) % NORM_RECORDINGS
    out = torch.empty(full, dtype=torch.float32, device=device)
    peak = torch.empty(full[0], dtype=torch.float32, device=device)
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = meg.to(dtype)
        name = str(dtype).split(".")[-1]

        def stage():
            return norm.normalize_clamp_peak(x, center, scale, LIMIT,
                                             rec=rec)

        def old_stage():
            return norm.normalize_clamp_peak(x.float(), center[rec],
                                             scale[rec], LIMIT)

        ms = median_ms(stage)
        kernel_ms = median_ms(lambda: norm._kernel(x, center, scale, rec,
                                                   out, peak, LIMIT, True))
        old_ms = median_ms(old_stage)
        plain_ms = median_ms(lambda: norm._reference_impl(
            x, center, scale, LIMIT, True, rec))
        # meg read and out written once, the tables and rec read, peak
        # written
        n_bytes = (x.element_size() * x.numel() + 4 * x.numel()
                   + 2 * center.numel() * 4 + 8 * rec.numel()
                   + 4 * full[0])
        bound_ms, bound_by = bound(n_bytes)
        gbytes = n_bytes / 1e9
        print(f"normalize_clamp_peak {list(full)} {name} meg, rec into "
              f"[{NORM_RECORDINGS}, {C}] tables: through its wrapper "
              f"{ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s), the kernel "
              f"alone {kernel_ms:.4f} ms ({gbytes / kernel_ms * 1e3:.1f} "
              f"GB/s), the old stage (upcast, two gathers, kernel) "
              f"{old_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
              f"computes it")
        device_ms = {}
        for label, fn in (("stage", stage), ("old stage", old_stage)):
            rows = device_rows(fn)
            device_ms[label] = sum(us for _, _, us in rows) / 1e3
            print(f"normalize {name} meg, the {label} in torch.profiler: "
                  f"{device_ms[label]:.4f} ms of device time per call in "
                  f"{sum(n for _, n, _ in rows):g} activities")
            for key, count, us in rows:
                print(f"  {us:9.2f} us  {count:g}x  {key[:100]}")
        timed[name] = dict(ms=ms, kernel_ms=kernel_ms, old_stage_ms=old_ms,
                           device_ms=device_ms["stage"],
                           old_stage_device_ms=device_ms["old stage"],
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        del x
    return dict(name="normalize_clamp_peak", route="cuda",
                source="brainmagick_tpu_torch/csrc/normalize.cu",
                replaces="brainmagick_tpu/ops/pallas_norm.py:51",
                max_abs_err=err, **timed["float32"],
                other_shapes={f"{'x'.join(map(str, full))} bfloat16":
                              timed["bfloat16"]})


def _matmul_error(a, b, got) -> tuple:
    """(max|kernel - plain|, max of it over |a_m| |b_n|)."""
    from brainmagick_tpu_torch.ops import matmul

    diff = (got - matmul._reference_impl(a, b)).abs()
    scale = a.float().norm(dim=1)[:, None] * b.float().norm(dim=1)[None, :]
    return diff.max().item(), (diff / scale).max().item()


def check_nt_matmul(device: torch.device) -> dict:
    """nt_matmul against the plain version (fp32 accumulation, TF32 off):
    ragged shapes over fp32, bf16 and mixed operands, then M in {1, 256,
    2048} (a request, the serving batch, the evaluation's chunk), N 2048,
    K 351,232 on fp32 and bf16 operands, each called twice (the same bits
    both times) and timed; at M = 2048 in fp32, the device activities of a
    call in torch.profiler (the split of the predictions into TF32 hi/lo,
    the tiles, the split sum)."""
    from brainmagick_tpu_torch.ops import matmul

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16))
    worst = {}
    for rows in RAGGED_M:
        for cols in RAGGED_N:
            for depth in RAGGED_K:
                for a_type, b_type in pairs:
                    a = torch.randn((rows, depth), generator=gen,
                                    device=device).to(a_type)
                    b = torch.randn((cols, depth), generator=gen,
                                    device=device).to(b_type)
                    _, rel_err = _matmul_error(a.to(b_type), b,
                                               matmul.nt_matmul(a, b))
                    key = " x ".join(str(t).split(".")[-1]
                                     for t in (a_type, b_type))
                    worst[key] = max(worst.get(key, 0.), rel_err)
                    if not rel_err <= MATMUL_TOL:
                        raise AssertionError(
                            f"nt_matmul {(rows, cols, depth)} {key}: "
                            f"max|diff|/(|a||b|) {rel_err} > {MATMUL_TOL}")
    print(f"nt_matmul ragged: {len(RAGGED_M) * len(RAGGED_N) * len(RAGGED_K)}"
          f" shapes x {len(pairs)} operand types, worst max|diff|/(|a||b|) "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {MATMUL_TOL})")

    m, n = REQUESTS[0], N_CANDIDATES
    a32 = torch.randn((EVAL_CHUNK, SCORE_K), generator=gen, device=device)
    b32 = torch.randn((n, SCORE_K), generator=gen, device=device)
    summary, shapes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        a_all, b = a32.to(dtype), b32.to(dtype)
        name = str(dtype).split(".")[-1]
        for rows in (1, m, EVAL_CHUNK):
            a = a_all[:rows]
            got = matmul.nt_matmul(a, b)
            again = matmul.nt_matmul(a, b)
            torch.cuda.synchronize()
            abs_err, rel_err = _matmul_error(a, b, got)
            if not rel_err <= MATMUL_TOL:
                raise AssertionError(
                    f"nt_matmul {name} M={rows}: max|diff|/(|a||b|) "
                    f"{rel_err} > {MATMUL_TOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"nt_matmul {name} M={rows}: two calls "
                                     f"differ")
            ms = median_ms(lambda: matmul.nt_matmul(a, b))
            plain_ms = median_ms(lambda: matmul._reference_impl(a, b))
            # one cuBLAS call computes the same function: torch.mm, on
            # bf16 operands with out_dtype=float32 (fp32 accumulation and
            # output, where a plain bf16 mm rounds its output to bf16)
            out_dtype = ({} if dtype == torch.float32
                         else dict(out_dtype=torch.float32))

            def library():
                return torch.mm(a, b.T, **out_dtype)

            _, library_err = _matmul_error(a, b, library())
            library_ms = median_ms(library)
            flop = 2 * rows * n * SCORE_K
            bound_ms, bound_by = bound(
                a.element_size() * (rows + n) * SCORE_K + 4 * rows * n,
                *((3 * flop, TF32_FLOPS) if dtype == torch.float32
                  else (flop, BF16_FLOPS)))
            print(f"nt_matmul [{rows}, {SCORE_K}] x [{n}, {SCORE_K}]^T "
                  f"{name}: max|diff| {abs_err:.3e}, max|diff|/(|a||b|) "
                  f"{rel_err:.3e}, two calls bit-equal; kernel {ms:.3f} ms "
                  f"({flop / 1e9 / ms:.2f} TFLOP/s), plain {plain_ms:.3f} "
                  f"ms ({flop / 1e9 / plain_ms:.2f} TFLOP/s), torch.mm"
                  f"{'' if dtype == torch.float32 else ' out_dtype fp32'} "
                  f"{library_ms:.3f} ms (max|diff|/(|a||b|) "
                  f"{library_err:.3e}), bound {bound_ms:.3f} ms "
                  f"({bound_by})")
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=abs_err)
            if rows == EVAL_CHUNK and dtype == torch.float32:
                activities = device_rows(lambda: matmul.nt_matmul(a, b), 3)
                device_ms = sum(us for _, _, us in activities) / 1e3
                split_ms = sum(us for key, _, us in activities
                               if "split_tf32" in key) / 1e3
                print(f"nt_matmul [{rows}, {SCORE_K}] x [{n}, {SCORE_K}]^T "
                      f"{name} in torch.profiler: {device_ms:.3f} ms of "
                      f"device time per call, of which the hi/lo split of "
                      f"the predictions {split_ms:.3f} ms "
                      f"({100 * split_ms / device_ms:.1f}%)")
                for key, count, us in activities:
                    print(f"  {us:9.2f} us  {count:g}x  {key[:100]}")
                timed.update(device_ms=device_ms, split_ms=split_ms,
                             split_share=split_ms / device_ms)
            if dtype == torch.float32 and rows == m:
                summary = timed
            else:
                shapes[f"{rows}x{n}x{SCORE_K} {name}"] = timed
        del a_all, b
    return dict(name="nt_matmul", route="cuda",
                source="brainmagick_tpu_torch/csrc/nt_matmul.cu",
                replaces="brainmagick_tpu/ops/pallas_matmul.py:53",
                **summary, other_shapes=shapes)


def inv_norms_entry(x: torch.Tensor, what: str) -> dict:
    """inv_norms of the [N, K] block `x` on the card against its plain
    version (max error over the plain value within INV_NORMS_TOL; an
    all-zero row's 1e8 exactly), called twice (the same bits both times),
    timed beside the plain version, one library call (the fp32 norm alone,
    ``torch.linalg.vector_norm``, which takes no int8) and the bound (`x`
    read once, the [N] fp32 result written once)."""
    inv_norms = importlib.import_module("brainmagick_tpu_torch.ops.inv_norms")

    got = inv_norms.inv_norms(x)
    again = inv_norms.inv_norms(x)
    want = inv_norms._reference_impl(x)
    torch.cuda.synchronize()
    err = ((got - want).abs() / want).max().item() if len(x) else 0.
    if not err <= INV_NORMS_TOL or not torch.equal(got, again) \
            or not torch.equal(want == 1e8, got == 1e8):
        raise AssertionError(f"inv_norms {what}: max|diff|/plain {err} (tol "
                             f"{INV_NORMS_TOL}), two calls equal "
                             f"{torch.equal(got, again)}")
    entry = dict(
        ms=median_ms(lambda: inv_norms.inv_norms(x)),
        plain_ms=median_ms(lambda: inv_norms._reference_impl(x)),
        library_ms=None if x.dtype == torch.int8 else median_ms(
            lambda: torch.linalg.vector_norm(x, dim=1, dtype=torch.float32)),
        max_rel_err=err, max_abs_err=(got - want).abs().max().item())
    entry.update(zip(("bound_ms", "bound_by"),
                     bound(x.element_size() * x.numel() + 4 * len(x))))
    return entry


def check_inv_norms(device: torch.device) -> dict:
    """inv_norms against the plain version: ragged shapes in fp32, bf16 and
    int8 (a row start off 16 bytes too, and an all-zero row), then the
    retrieval cell's bank [2048, 351,232] bf16, the evaluation's 2048-row
    blocks in fp32 and bf16 and int8, and a test stage's [200, 41,160]
    (its rows split over blocks), each timed; the bank's device activities
    in torch.profiler; and one ``losses.retrieval_scores`` call launches it
    once."""
    from brainmagick_tpu_torch import losses, ops

    inv_norms = importlib.import_module("brainmagick_tpu_torch.ops.inv_norms")
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    types_ = (torch.float32, torch.bfloat16, torch.int8)

    def block(n, k, dtype, offset=0):
        if dtype == torch.int8:
            flat = torch.randint(-127, 128, (n * k + offset,), generator=gen,
                                 device=device, dtype=torch.int8)
        else:
            flat = torch.randn(n * k + offset, generator=gen,
                               device=device).to(dtype)
        return flat[offset:].view(n, k)

    ragged = 0
    for n, k in RAGGED_INV_NORMS:
        for dtype in types_:
            for offset in (0, 1):
                x = block(n, k, dtype, offset)
                if n > 1:
                    x[n // 2] = 0
                inv_norms_entry(x, f"[{n}, {k}] {_type_name(dtype)} offset "
                                f"{offset}")
                ragged += 1
    print(f"inv_norms ragged: {ragged} blocks within {INV_NORMS_TOL} of the "
          f"plain version, an all-zero row 1e8, two calls bit-equal")

    summary, shapes = {}, {}
    for (n, k), dtype in (((N_CANDIDATES, SCORE_K), torch.bfloat16),
                          ((EVAL_CHUNK, SCORE_K), torch.float32),
                          ((EVAL_CHUNK, SCORE_K), torch.int8),
                          ((200, 41_160), torch.float32),
                          ((200, 41_160), torch.bfloat16)):
        x = block(n, k, dtype)
        label = f"{n}x{k} {_type_name(dtype)}"
        entry = inv_norms_entry(x, label)
        splits = inv_norms.plan_splits(
            n, k, x.element_size(),
            torch.cuda.get_device_properties(device).multi_processor_count)
        if dtype == torch.bfloat16 and n == N_CANDIDATES:
            activities = device_rows(lambda: inv_norms.inv_norms(x), 5)
            entry["device_ms"] = sum(us for _, _, us in activities) / 1e3
            for key, count, us in activities:
                print(f"  {us:9.2f} us  {count:g}x  {key[:100]}")
            summary = entry
        else:
            shapes[label] = entry
        print(f"inv_norms [{n}, {k}] {_type_name(dtype)} ({splits} blocks a "
              f"row): max|diff|/plain {entry['max_rel_err']:.3e}, two calls "
              f"bit-equal; kernel {entry['ms']:.4f} ms"
              + (f" (device {entry['device_ms']:.4f})" if "device_ms" in entry
                 else "")
              + f", plain {entry['plain_ms']:.4f} ms, vector_norm "
              + ("none" if entry["library_ms"] is None
                 else f"{entry['library_ms']:.4f} ms")
              + f", bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        del x
    # the scoring path: one launch a retrieval_scores call
    bank = block(N_CANDIDATES, SCORE_K, torch.bfloat16)
    est = torch.randn((REQUESTS[0], SCORE_K), generator=gen, device=device)
    clip = losses.ClipLoss(compute_dtype="bfloat16")
    before = {k.__name__: k.launches for k in ops.KERNELS}
    scores = losses.retrieval_scores(clip, est, bank)
    torch.cuda.synchronize()
    moved = {k.__name__: k.launches - before[k.__name__] for k in ops.KERNELS}
    if moved["inv_norms"] != 1 or moved["nt_matmul"] != 1 \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"retrieval_scores launched {moved}")
    print(f"retrieval_scores [{REQUESTS[0]}] x [{N_CANDIDATES}] bf16: "
          f"launches {moved}")
    del bank, est, scores
    return dict(name="inv_norms", route="cuda",
                source="brainmagick_tpu_torch/csrc/inv_norms.cu",
                replaces="none (brainmagick_tpu/losses.py block_inv_norms is "
                         "plain jnp)",
                **summary, other_shapes=shapes)


def _conv_case(shape, dtype, device, gen):
    """Seeded conv_stats operands and backward cotangents at (B, C, O, T,
    d, k): x [B, C, T], w [O, C, k] (LeCun scale), G for y, a and b for s
    and ss."""
    B, Cin, O, Tc, _, k = shape
    x = torch.randn((B, Cin, Tc), generator=gen, device=device).to(dtype)
    w = (torch.randn((O, Cin, k), generator=gen, device=device)
         / (k * Cin) ** 0.5).to(dtype)
    cot = (torch.randn((B, O, Tc), generator=gen, device=device).to(dtype),
           torch.randn(O, generator=gen, device=device),
           torch.randn(O, generator=gen, device=device) * 0.1)
    return x, w, cot


def _conv_grads(fn, x, w, d, cot):
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    return torch.autograd.grad(fn(xr, wr, d), (xr, wr), cot)


def _conv_errors(x, w, d, cot, got, want, got_grads, want_grads):
    """Each conv_stats error over its Cauchy-Schwarz bound (CONV_TOL)."""
    import torch.nn.functional as fn

    x32, w32 = x.float(), w.float()
    k = w.shape[2]
    window = fn.conv1d(x32 * x32, torch.ones((1, x.shape[1], k),
                                             device=x.device),
                       padding=(k // 2) * d, dilation=d).sqrt()
    bound = w32.flatten(1).norm(dim=1)[None, :, None] * window  # [B, O, T]
    # the plain version's y before its rounding to x's type
    y_ref = fn.conv1d(x32, w32, padding=(k // 2) * d, dilation=d)
    rounding = 2 ** -8 * y_ref.abs() if x.dtype == torch.bfloat16 else 0.
    dy = (got[0].float() - y_ref).abs()
    dY = (cot[0].float() + cot[1][None, :, None]
          + 2 * y_ref * cot[2][None, :, None])
    dx_bound = (w32.norm(dim=(0, 2))[None, :, None]
                * dY.flatten(1).norm(dim=1)[:, None, None])
    dw_bound = (dY.norm(dim=(0, 2))[:, None, None]
                * x32.norm(dim=(0, 2))[None, :, None])
    return dict(
        y=((dy - rounding).clamp(min=0) / bound).max().item(),
        s=((got[1] - want[1]).abs() / bound.sum((0, 2))).max().item(),
        ss=((got[2] - want[2]).abs() / (bound ** 2).sum((0, 2))).max().item(),
        dx=((got_grads[0].float() - want_grads[0].float()).abs()
            / dx_bound).max().item(),
        dw=((got_grads[1].float() - want_grads[1].float()).abs()
            / dw_bound).max().item(),
        abs_y=dy.max().item())


def _conv_bound(shape, dtype) -> tuple:
    """(bound_ms, bound_by) of the forward at (B, C, O, T, d, k) in
    `dtype`: x, w read and y written once in that type, s and ss in fp32;
    2 B T C O k operations, in fp32 as three TF32 products each, in bf16 as
    one bf16 product."""
    B, Cin, O, Tc, _, k = shape
    n_bytes = (dtype.itemsize * (B * Cin * Tc + O * Cin * k + B * O * Tc)
               + 4 * 2 * O)
    flop = 2 * B * Tc * Cin * O * k
    if dtype == torch.float32:
        return bound(n_bytes, 3 * flop)
    return bound(n_bytes, flop, BF16_FLOPS)


def _type_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def check_conv_stats(device: torch.device) -> dict:
    """conv_stats forward (y, s, ss) and backward (dx, dw through autograd)
    against its plain version's autograd, in fp32 and bf16: the ragged
    shapes, the tensor-core route's other edges (k = 9 and 11 included) and
    the encoder's paper shapes, two calls of each type bit-equal at [256,
    320, 343]; then at every paper shape in each type the weights' B
    operand on the card equal to its plain version, and the median times
    of the forward through its wrapper, of its parts alone (the kernel with
    its column sums, the zero-padding of T to 16 bytes, the weights'
    operand: fp32's split, bf16's rearranging copy), of its plain version
    (cuDNN conv + the two sums) and of cuDNN's conv alone in that type (y
    only: no single PyTorch call computes the sums with it); and the
    forward + backward at [256, 320, 343] in each type."""
    import torch.nn.functional as fn

    from brainmagick_tpu_torch.ops import conv_bn, matmul

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    types = (torch.float32, torch.bfloat16)
    cases = [(shape, dtype) for shape in RAGGED_CONV + RAGGED_CONV_TC
             + PAPER_CONV for dtype in types]
    summary = {}
    for shape, dtype in cases:
        d = shape[4]
        x, w, cot = _conv_case(shape, dtype, device, gen)
        got = conv_bn.conv_stats(x, w, d)
        want = conv_bn._reference_impl(x, w, d)
        got_grads = _conv_grads(conv_bn.conv_stats, x, w, d, cot)
        want_grads = _conv_grads(conv_bn._reference_impl, x, w, d, cot)
        torch.cuda.synchronize()
        errors = _conv_errors(x, w, d, cot, got, want, got_grads, want_grads)
        bf16 = dtype == torch.bfloat16
        limits = dict(y=CONV_TOL, s=CONV_TOL, ss=CONV_TOL,
                      dx=CONV_GRAD_TOL_BF16 if bf16 else CONV_TOL,
                      dw=CONV_GRAD_TOL_BF16 if bf16 else CONV_TOL)
        name = _type_name(dtype)
        print(f"conv_stats {shape} {name}: " + ", ".join(
            f"{key} {value:.2e}" for key, value in errors.items())
            + " (over their bounds; abs_y is max|dy|)")
        for key, limit in limits.items():
            if not errors[key] <= limit:
                raise AssertionError(f"conv_stats {shape} {name}: {key} "
                                     f"error {errors[key]} > {limit}")
        if shape == PAPER_CONV[0]:
            summary[name] = errors["abs_y"]
            again = conv_bn.conv_stats(x, w, d)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"conv_stats {shape} {name}: two calls "
                                     f"differ")
            print(f"conv_stats {shape} {name}: two calls bit-equal")
        del x, w, cot, got, want, got_grads, want_grads

    shapes = {}
    for dtype in types:
        name = _type_name(dtype)
        for shape in PAPER_CONV:
            B, Cin, O, Tc, d, k = shape
            x, w, _ = _conv_case(shape, dtype, device, gen)
            weights = (conv_bn.split_weights if dtype == torch.float32
                       else conv_bn.weight_taps)
            # the weights' operand on the card against its plain version
            w_op = weights(w)
            if not torch.equal(w_op.cpu(), weights(w.cpu())):
                raise AssertionError(f"{weights.__name__} {tuple(w.shape)} "
                                     f"{name} differs from its plain version")
            x_pad = matmul.tma_operand(x.view(B * Cin, Tc)).view(B, Cin, -1)
            y, s, ss = conv_bn.conv_stats(x, w, d)
            ms = median_ms(lambda: conv_bn.conv_stats(x, w, d))
            kernel_ms = median_ms(lambda: conv_bn._tc_kernel(
                x_pad, w_op, y, s, ss, d))
            pad_ms = median_ms(lambda: matmul.tma_operand(
                x.view(B * Cin, Tc)))
            weights_ms = median_ms(lambda: weights(w))
            plain_ms = median_ms(lambda: conv_bn._reference_impl(x, w, d))
            library_ms = median_ms(lambda: fn.conv1d(
                x, w, padding=(k // 2) * d, dilation=d))
            bound_ms, bound_by = _conv_bound(shape, dtype)
            gflop = 2 * B * Tc * Cin * O * k / 1e9
            print(f"conv_stats [{B}, {Cin}, {Tc}] x [{O}, {Cin}, {k}] d={d} "
                  f"{name} forward: through its wrapper {ms:.3f} ms "
                  f"({gflop / ms:.1f} TFLOP/s) = the kernel and its column "
                  f"sums {kernel_ms:.3f} ms + the pad of T to "
                  f"{x_pad.shape[2]} {pad_ms:.3f} ms + the weights' "
                  f"{weights.__name__} {weights_ms:.3f} ms (each timed "
                  f"alone); plain {plain_ms:.3f} ms, cuDNN {name} conv "
                  f"alone {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
                  f"({bound_by})")
            shapes[f"{B}x{Cin}x{Tc} O{O} k{k} d{d} {name}"] = dict(
                ms=ms, kernel_ms=kernel_ms, pad_ms=pad_ms,
                weights_ms=weights_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            del x, w, w_op, x_pad, y, s, ss

    B, Cin, O, Tc, d, k = PAPER_CONV[0]
    head = f"{B}x{Cin}x{Tc} O{O} k{k} d{d}"
    for dtype in types:
        name = _type_name(dtype)
        x, w, cot = _conv_case(PAPER_CONV[0], dtype, device, gen)
        ms_bwd = median_ms(lambda: _conv_grads(conv_bn.conv_stats, x, w, d,
                                               cot))
        plain_bwd = median_ms(lambda: _conv_grads(conv_bn._reference_impl,
                                                  x, w, d, cot))
        print(f"conv_stats [{B}, {Cin}, {Tc}] x [{O}, {Cin}, {k}] d={d} "
              f"{name} forward + backward: kernel {ms_bwd:.3f} ms, plain "
              f"{plain_bwd:.3f} ms")
        shapes[f"{head} {name}"].update(fwd_bwd_ms=ms_bwd,
                                        plain_fwd_bwd_ms=plain_bwd,
                                        max_abs_err=summary[name])
        del x, w, cot
    return dict(name="conv_stats", route="cuda",
                source="brainmagick_tpu_torch/csrc/conv_stats.cu",
                replaces="brainmagick_tpu/ops/pallas_conv_bn.py:89",
                **shapes.pop(f"{head} float32"), other_shapes=shapes)


def seeded_arrays():
    """Seeded normalization arrays and per-recording sensor positions
    (the last recording's sensors past VALID_SENSORS have none)."""
    from brainmagick_tpu_torch.models.common import INVALID_POSITION

    rng = np.random.RandomState(SEED)
    rec_positions = rng.rand(N_RECORDINGS, C, 2).astype(np.float32)
    rec_positions[MASKED_RECORDING, VALID_SENSORS:] = INVALID_POSITION
    norm_arrays = dict(
        meg_center=(rng.randn(N_RECORDINGS, C) * 0.1).astype(np.float32),
        meg_scale=rng.uniform(0.5, 2.0, (N_RECORDINGS, C)).astype(np.float32),
        feat_center=rng.randn(F).astype(np.float32),
        feat_scale=rng.uniform(0.5, 2.0, F).astype(np.float32),
        rec_positions=rec_positions,
        rec_subjects=np.arange(N_RECORDINGS, dtype=np.int32))
    return norm_arrays, rng


def build_server(device, preset: str = "clip_conv"):
    """`preset` (clip_conv, or clip_conv_tpu: bf16 compute, estimates,
    scores and wire) at full width on `device`, from seeds only:
    port-initialized weights, BatchNorm running stats drawn from numpy
    (mean ~ N(0, 0.1), var ~ U(0.5, 1.5)) and seeded normalization
    arrays. Two calls give the same server on any device."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.serve import Server

    norm_arrays, rng = seeded_arrays()
    rec_positions = norm_arrays["rec_positions"]
    args = apply_preset(MainConfig(), preset)
    server = Server(args, C, F, N_SUBJECTS, None, None, norm_arrays, device,
                    generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for module in server.model.modules():
            if isinstance(module, torch.nn.BatchNorm1d):
                shape = module.running_mean.shape
                module.running_mean.copy_(torch.from_numpy(
                    (rng.randn(*shape) * 0.1).astype(np.float32)))
                module.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, shape).astype(np.float32)))
    return server, rec_positions


def make_request(rng: np.random.RandomState, batch: int,
                 rec_positions: np.ndarray) -> types.SimpleNamespace:
    rec = np.arange(batch) % N_RECORDINGS
    return types.SimpleNamespace(
        meg=(rng.randn(batch, C, T) * 5).astype(np.float32),
        features=rng.randn(batch, F, T).astype(np.float32),
        features_mask=np.ones((batch, 1, T), dtype=bool),
        subject_index=rec.astype(np.int32),     # a recording binds its subject
        recording_index=rec.astype(np.int32),
        positions=rec_positions[rec])


def _check_probs(probs: torch.Tensor, b: int, what: str) -> None:
    if probs.shape != (b, N_CANDIDATES):
        raise AssertionError(f"{what}: probabilities {tuple(probs.shape)}")
    if not torch.isfinite(probs).all():
        raise AssertionError(f"{what}: non-finite probabilities")
    row_err = (probs.sum(dim=1) - 1).abs().max().item()
    if row_err > PROBS_TOL:
        raise AssertionError(f"{what}: probability rows off 1 by {row_err}")


def _norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| (Frobenius), on the CPU in fp32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).norm() / want.norm()).item()


def _against_cpu(what: str, got: torch.Tensor, want: torch.Tensor,
                 atol: float, recipe: bool) -> str:
    """Hold the card's `got` to the CPU's `want`: fp32 allclose at rtol 0
    and `atol` (rtol = atol for estimates), or the recipe's bf16 norm
    tolerance. Returns the error's description."""
    if recipe:
        err = _norm_err(got, want)
        if not err <= RECIPE_TOL:
            raise AssertionError(f"card vs CPU {what}: |diff|/|ref| {err}")
        return f"{what} |diff|/|ref| {err:.3e} (tol {RECIPE_TOL:.3e})"
    got = got.detach().cpu()
    err = (got - want).abs().max().item()
    rtol = atol if what == "estimate" else 0.
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"card vs CPU {what}: max|diff| {err}")
    return f"{what} max|diff| {err:.3e} (rtol {rtol}, atol {atol})"


def count_fused_head(model) -> list:
    """Count the calls of `model`'s fused head (SimpleConv falls back to
    the unfused ops, silently, when an engage condition fails): a
    one-item list that each call adds one to."""
    calls = [0]
    fused_head = model._fused_head

    def counted(*args, **kwargs):
        calls[0] += 1
        return fused_head(*args, **kwargs)
    model._fused_head = counted
    return calls


def _check_fused_head(calls: list, want: int, what: str) -> None:
    if calls[0] != want:
        raise AssertionError(f"{what}: the fused head ran {calls[0]} times, "
                             f"want {want}")


def run_slice(device: torch.device, card_name: str,
              preset: str = "clip_conv"):
    """The serving slice of `preset`: four requests, then the largest one
    warm (its forward and scoring against the bank, stored in the scores'
    compute dtype: fp32 for clip_conv, bf16 for clip_conv_tpu; clip_conv
    also scores with clip.compute_dtype bfloat16 against the bank stored
    in bf16). Returns the kernel launch counts over all of it, the first
    B=256 request (the train slice's batch) and the warm medians."""
    from brainmagick_tpu_torch import ops

    recipe = preset == RECIPE
    server, rec_positions = build_server(device, preset)
    fused_calls = count_fused_head(server.model)
    rng = np.random.RandomState(SEED + 2)
    requests = [make_request(rng, b, rec_positions) for b in REQUESTS]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    t_out = T - server.solver._offsets()[0]
    bank = torch.randn((N_CANDIDATES, F, t_out), generator=gen,
                       device=device)
    bank_bf16 = bank.to(torch.bfloat16)
    if recipe:
        bank = bank_bf16
    est_dtype = server.model.estimate_dtype
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    results = []
    for batch in requests:
        b = len(batch.meg)
        t0 = time.perf_counter()
        estimate, output, mask, keep = server.forward_batch(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs = server.probabilities(estimate, bank)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if estimate.shape != (b, F, t_out) or output.shape != (b, F, t_out):
            raise AssertionError(f"estimate {tuple(estimate.shape)}, output "
                                 f"{tuple(output.shape)}; want "
                                 f"{(b, F, t_out)}")
        if estimate.dtype != est_dtype:
            raise AssertionError(f"{preset}: estimate in {estimate.dtype}, "
                                 f"want {est_dtype}")
        for name, t in (("estimate", estimate), ("output", output)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite {name} at B={b}")
        _check_probs(probs, b, f"{preset} B={b}")
        if not keep.all() or mask.shape != (b, 1, t_out):
            raise AssertionError(f"B={b}: keep {keep.tolist()[:8]}, mask "
                                 f"{tuple(mask.shape)}")
        print(f"{preset} request B={b}: forward {(t1 - t0) * 1e3:.2f} ms, "
              f"scoring against {N_CANDIDATES} candidates "
              f"{(t2 - t1) * 1e3:.2f} ms (host clock, synchronized; "
              f"{card_name})")
        results.append((batch, estimate, probs))

    # each request above was its batch size's first call (cuDNN picks its
    # algorithms then); the steady state of the largest one, warm
    batch = requests[0]
    forward_ms, scoring_ms = [], []
    for _ in range(STEADY_RUNS):
        t0 = time.perf_counter()
        estimate, _, _, _ = server.forward_batch(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs = server.probabilities(estimate, bank)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        forward_ms.append((t1 - t0) * 1e3)
        scoring_ms.append((t2 - t1) * 1e3)
    b = len(batch.meg)
    warm = dict(forward_ms=statistics.median(forward_ms),
                scoring_ms=statistics.median(scoring_ms))
    print(f"{preset} warm B={b} over {STEADY_RUNS} runs: forward median "
          f"{warm['forward_ms']:.2f} ms, scoring median "
          f"{warm['scoring_ms']:.2f} ms ({card_name})")
    if not recipe:
        # the same estimate scored with bf16 operands (clip_conv_tpu's
        # clip.compute_dtype) against the bank already stored in bf16
        server.clip.compute_dtype = torch.bfloat16
        bf16_ms = []
        for _ in range(STEADY_RUNS):
            t0 = time.perf_counter()
            probs_bf16 = server.probabilities(estimate, bank_bf16)
            torch.cuda.synchronize()
            bf16_ms.append((time.perf_counter() - t0) * 1e3)
        server.clip.compute_dtype = None
        _check_probs(probs_bf16, b, f"B={b} bf16 scoring")
        print(f"warm B={b} scoring with clip.compute_dtype bfloat16 over "
              f"{STEADY_RUNS} runs: median {statistics.median(bf16_ms):.2f} "
              f"ms; max|p_bf16 - p_fp32| "
              f"{(probs_bf16 - probs).abs().max().item():.3e} ({card_name})")

    launches = {k.__name__: k.launches for k in ops.KERNELS}
    print(f"{preset} kernel launches over the {len(REQUESTS)} requests and "
          f"the warm runs: {launches}; fused head calls {fused_calls[0]}")
    _check_fused_head(fused_calls,
                      len(REQUESTS) + STEADY_RUNS if recipe else 0,
                      f"the {preset} serving path")
    scorings = len(REQUESTS) + STEADY_RUNS * (1 if recipe else 2)
    want = dict(normalize_clamp_peak=len(REQUESTS) + STEADY_RUNS,
                nt_matmul=scorings, conv_stats=0, inv_norms=scorings)
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"the {preset} serving path launched {name} "
                                 f"{launches[name]} times, want {count}")

    # the smallest request, held against the same server on the CPU
    batch, estimate, _ = results[-1]
    reference, _ = build_server("cpu", preset)
    fused_calls = count_fused_head(reference.model)
    est_ref, _, _, _ = reference.forward_batch(batch)
    _check_fused_head(fused_calls, 1 if recipe else 0,
                      f"the {preset} B=1 request on the CPU")
    cands = bank[:64]
    probs = server.probabilities(estimate, cands)
    probs_ref = reference.probabilities(est_ref, cands.cpu())
    print(f"{preset} B=1 against the CPU: "
          + _against_cpu("estimate", estimate, est_ref, REFERENCE_TOL, recipe)
          + "; over 64 candidates "
          + _against_cpu("probabilities", probs, probs_ref, PROBS_TOL,
                         recipe))
    return launches, requests[0], warm


def build_trainer(device, preset: str = "clip_conv",
                  compute_fp32: bool = False,
                  options: tp.Optional[dict] = None):
    """`preset` with simpleconv.fused_conv_bn (and the simpleconv
    `options`) at full width on `device`, from seeds only
    (port-initialized weights, seeded normalization arrays, the dropout
    generator seeded SEED). Two calls give the same trainer on any
    device, drawing the same dropout disks, with the same fp32 weights
    whatever the compute dtype. `compute_fp32` sets the preset's compute
    dtypes (simpleconv.dtype and output_dtype, clip.compute_dtype) back to
    fp32 and keeps the rest of it, the wire's dtype included."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.train import Trainer

    norm_arrays, _ = seeded_arrays()
    args = apply_preset(MainConfig(), preset)
    args.simpleconv.update(fused_conv_bn=True, **(options or {}))
    if compute_fp32:
        args.simpleconv.update(dtype=None, output_dtype=None)
        args.clip.compute_dtype = None
    return Trainer(args, C, F, N_SUBJECTS, None, None, norm_arrays, device,
                   generator=torch.Generator().manual_seed(SEED))


def run_train(device: torch.device, card_name: str, batch,
              preset: str = "clip_conv", options: tp.Optional[dict] = None,
              steps: int = TRAIN_STEPS, inspect=None) -> tuple:
    """`steps` Adam steps of Trainer.step on one B=256 batch, then a
    B=8 step held against the same trainer on the CPU; with the simpleconv
    `options` on top of `preset`, and `inspect(trainer)` called after the
    steps. Returns the kernel launch counts over the steps, conv_stats'
    by dtype, and the warm step's median and peak memory."""
    from brainmagick_tpu_torch import ops

    recipe = preset == RECIPE
    dtype = "bfloat16" if recipe else "float32"
    label = preset + (f" {options}" if options else "")
    # the fused head stays off under per-subject merger heads, as in flax
    fused_head = recipe and not (options or {}).get("merger_per_subject")
    trainer = build_trainer(device, preset, options=options)
    n_fused = sum(trainer.model.encoders["meg"].fused)
    if n_fused != 10:
        raise AssertionError(f"{n_fused} fused encoder layers, want 10")
    fused_calls = count_fused_head(trainer.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        loss = metrics["loss"].item()                   # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if {metrics["keep"].item(), metrics["count"].item()} != {TRAIN_B}:
            raise AssertionError(f"keep/count {metrics}")
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    routes = dict(ops.conv_stats.launches_by_route)
    by_dtype = dict(ops.conv_stats.launches_by_dtype)
    warm = dict(step_ms=statistics.median(step_ms[1:]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label} train B={TRAIN_B}: losses {losses}; step times "
          f"{[round(t, 2) for t in step_ms]} ms (host clock, synchronized, "
          f"host-to-device copy included; {card_name})")
    print(f"{label} train warm step median over steps 2-{steps}: "
          f"{warm['step_ms']:.2f} ms; peak device memory "
          f"{warm['peak_gb']:.2f} GB; kernel launches over the "
          f"{steps} steps: {launches}, conv_stats by route {routes}, "
          f"by type {by_dtype}; fused head calls {fused_calls[0]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label} train losses {losses}: want finite, "
                             f"and the last below the first")
    _check_fused_head(fused_calls, steps if fused_head else 0,
                      f"the {label} train steps")
    want = dict(conv_stats=n_fused * steps, normalize_clamp_peak=steps,
                inv_norms=0)
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{label} train path launched {name} "
                                 f"{launches[name]} times, want {count}")
    if routes != {"tc": n_fused * steps} \
            or by_dtype[dtype] != n_fused * steps:
        raise AssertionError(f"{label} train steps ran conv_stats by route "
                             f"{routes}, by type {by_dtype}, want every "
                             f"launch {dtype} on 'tc'")
    if inspect is not None:
        warm.update(inspect(trainer))
    del trainer, metrics
    torch.cuda.empty_cache()

    check_held_step(device, preset, batch, options)
    return launches, by_dtype, warm


def held_step(where, preset: str, batch, compute_fp32: bool = False,
              options: tp.Optional[dict] = None):
    """One Trainer.step of build_trainer(where, preset, compute_fp32,
    options) on `batch`: (loss, model). clip_conv_tpu's must run its fused
    head, but under per-subject merger heads."""
    trainer = build_trainer(where, preset, compute_fp32, options)
    fused_calls = count_fused_head(trainer.model)
    loss = trainer.step(batch)["loss"].item()
    fused_head = preset == RECIPE and not (options or {}).get(
        "merger_per_subject")
    _check_fused_head(fused_calls, 1 if fused_head else 0,
                      f"the {preset} B={len(batch.meg)} step on {where}")
    return loss, trainer.model


def _grad(model, name: str) -> torch.Tensor:
    return model.get_parameter(name).grad.cpu()


def _step_errors(card: tuple, cpu: tuple, bf16: bool,
                 leaves: tp.Sequence[str] = HELD_LEAVES) -> tuple:
    """A held_step on the card against one on the CPU: the loss's relative
    error and each of the `leaves`' gradients', in bf16 the gradients' and
    the running statistics' in norm (_norm_err), in fp32 each gradient's
    max error over its max magnitude, with the running statistics held
    allclose at rtol = atol = STEP_TOL here. Returns (errors, note)."""
    (loss, model), (loss_ref, model_ref) = card, cpu
    errors = {"loss": abs(loss - loss_ref) / abs(loss_ref)}
    for name in leaves:
        grad, ref = _grad(model, name), _grad(model_ref, name)
        errors[f"grad {name}"] = (_norm_err(grad, ref) if bf16 else
                                  ((grad - ref).abs().max()
                                   / ref.abs().max()).item())
    stats = dict(model_ref.named_buffers())
    running = [(name, buf.cpu(), stats[name])
               for name, buf in model.named_buffers() if "running" in name]
    if bf16:
        errors["running statistics"] = max(_norm_err(got, ref)
                                           for _, got, ref in running)
        return errors, (f"relative, of the norm; the gradients' tol "
                        f"{RECIPE_GRAD_TOL:.2e}")
    for name, got, ref in running:
        if not torch.allclose(got, ref, rtol=STEP_TOL, atol=STEP_TOL):
            raise AssertionError(f"card vs CPU {name}: max|diff| "
                                 f"{(got - ref).abs().max()}")
    worst = max(((g - r).abs().max().item() for _, g, r in running),
                default=0.)
    return errors, (f"relative; running statistics max|diff| {worst:.2e} "
                    f"(rtol=atol={STEP_TOL})")


def _check_errors(errors: dict, tol: float, what: str,
                  grad_tol: float | None = None) -> None:
    for key, value in errors.items():
        limit = grad_tol if grad_tol and key.startswith("grad") else tol
        if not value <= limit:
            raise AssertionError(f"card vs CPU {what}: {key} {value} > "
                                 f"{limit}")


def check_held_step(device, preset: str, batch,
                    options: tp.Optional[dict] = None) -> None:
    """A B=HELD_B step on the card against the same trainer on the CPU, at
    STEP_TOL for clip_conv; for clip_conv_tpu at RECIPE_TOL in norm (the
    gradients at RECIPE_GRAD_TOL), with the two witnesses RECIPE_SPREAD
    describes: the step with fp32 compute at STEP_TOL, and the card's bf16
    gradients no farther from the CPU's fp32 ones than RECIPE_SPREAD times
    the CPU's bf16 gradients. With the simpleconv `options`, the held
    leaves gain the first DualPathRNN LSTM's recurrent kernel when there
    is one."""
    from brainmagick_tpu_torch import dataset

    small = types.SimpleNamespace(**{
        name: getattr(batch, name)[:HELD_B] for name in dataset.ARRAY_FIELDS})
    recipe = preset == RECIPE
    label = preset + (f" {options}" if options else "")
    leaves = HELD_LEAVES + (ZOO_LSTM_LEAVES if (options or {}).get(
        "dual_path") else ())
    card, cpu = (held_step(where, preset, small, options=options)
                 for where in (device, "cpu"))
    errors, note = _step_errors(card, cpu, recipe, leaves)
    tol = RECIPE_TOL if recipe else STEP_TOL
    print(f"{label} train B={HELD_B} against the CPU: " + ", ".join(
        f"{key} {value:.2e}" for key, value in errors.items())
        + f" (tol {tol:.2e}; {note})")
    _check_errors(errors, tol, f"{label} train step",
                  RECIPE_GRAD_TOL if recipe else None)
    if not recipe:
        return
    card32, cpu32 = (held_step(where, preset, small, compute_fp32=True,
                               options=options)
                     for where in (device, "cpu"))
    errors, note = _step_errors(card32, cpu32, False, leaves)
    print(f"{label} train B={HELD_B} with fp32 compute against the CPU: "
          + ", ".join(f"{key} {value:.2e}" for key, value in errors.items())
          + f" (tol {STEP_TOL:.2e}; {note})")
    _check_errors(errors, STEP_TOL, f"{label} train step in fp32")
    spread = {name: (_norm_err(_grad(card[1], name), _grad(cpu32[1], name)),
                     _norm_err(_grad(cpu[1], name), _grad(cpu32[1], name)))
              for name in leaves}
    print(f"{label} train B={HELD_B}, each bf16 gradient against the CPU's "
          f"fp32 one in norm, card / CPU: " + ", ".join(
              f"{name} {a:.2e} / {b:.2e}" for name, (a, b) in spread.items())
          + f" (the card's within {RECIPE_SPREAD} times the CPU's)")
    for name, (on_card, on_cpu) in spread.items():
        if not on_card <= RECIPE_SPREAD * on_cpu:
            raise AssertionError(
                f"{preset} bf16 gradient {name}: {on_card} from the fp32 one "
                f"on the card, {on_cpu} on the CPU")


def make_eval_batches(device, args, rec_positions: np.ndarray) -> list:
    """EVAL_BATCHES seeded batches of REQUESTS[0] rows, as eval and wer take
    them: each row hears one word of one of EVAL_SEGMENTS segments (every
    segment at least once, the rest drawn again, the rows shuffled), and
    rows of one segment share its features. A row's events are a marker at
    the window's start and the word, -dset.tmin later; its word_hash holds
    the word's hash over the word's samples. The arrays are drawn on the
    card from a seed."""
    from brainmagick_tpu_torch.eval import stable_word_hash

    n = EVAL_BATCHES * REQUESTS[0]
    rng = np.random.RandomState(SEED + 5)
    segment = np.concatenate([np.arange(EVAL_SEGMENTS), rng.randint(
        0, EVAL_SEGMENTS, n - EVAL_SEGMENTS)])
    rng.shuffle(segment)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    features = torch.randn((EVAL_SEGMENTS, F, T), generator=gen,
                           device=device).cpu().numpy()
    meg = (torch.randn((n, C, T), generator=gen, device=device)
           * 5).cpu().numpy()
    tmin, rate = args.dset.tmin, args.dset.sample_rate
    onset_sample = int(-tmin * rate)
    word_samples = int(WORD_SECONDS * rate)
    batches = []
    for lo in range(0, n, REQUESTS[0]):
        rows = np.arange(lo, lo + REQUESTS[0])
        rec = rows % N_RECORDINGS
        event_lists, word_hash = [], np.zeros((len(rows), T), np.int64)
        for k, s in enumerate(segment[rows]):
            word_index, story = divmod(int(s), EVAL_SEQUENCES)
            onset = 10.0 + 0.5 * word_index
            word = f"word{int(s) % EVAL_WORDS}"
            event_lists.append([
                types.SimpleNamespace(kind="segment", start=onset + tmin,
                                      duration=T / rate),
                types.SimpleNamespace(kind="word", start=onset,
                                      duration=WORD_SECONDS, word=word,
                                      word_index=word_index,
                                      word_sequence=f"story {story}")])
            word_hash[k, onset_sample:onset_sample + word_samples] = \
                stable_word_hash(word)
        batches.append(types.SimpleNamespace(
            meg=meg[rows], features=features[segment[rows]],
            features_mask=np.ones((len(rows), 1, T), dtype=bool),
            subject_index=rec.astype(np.int32),
            recording_index=rec.astype(np.int32),
            positions=rec_positions[rec], event_lists=event_lists,
            study="seeded", word_hash=word_hash))
    return batches


class OutputsAsEstimates:
    """A server whose estimates are its outputs: the identity pass, whose
    every prediction must retrieve its own segment."""

    def __init__(self, server) -> None:
        self.server = server

    def __getattr__(self, name):
        return getattr(self.server, name)

    def forward_batch(self, batch, pad_weight=None):
        _, output, mask, keep = self.server.forward_batch(batch, pad_weight)
        return output, output, mask, keep


def scoring_calls(n_rows: int, n_candidates: int) -> int:
    """nt_matmul launches of one streamed scoring: chunks x blocks."""
    return math.ceil(n_rows / EVAL_CHUNK) * math.ceil(n_candidates
                                                      / EVAL_CHUNK)


def norm_calls(n_candidates: int) -> int:
    """inv_norms launches of one streamed scoring: one a candidate block."""
    return math.ceil(n_candidates / EVAL_CHUNK)


def _check_eval_probs(probs: np.ndarray, shape: tuple, what: str) -> None:
    if probs.shape != shape:
        raise AssertionError(f"{what}: probabilities {probs.shape}, want "
                             f"{shape}")
    if not np.isfinite(probs).all():
        raise AssertionError(f"{what}: non-finite probabilities")
    row_err = float(np.abs(probs.sum(axis=1, dtype=np.float64) - 1).max())
    if row_err > PROBS_TOL:
        raise AssertionError(f"{what}: probability rows off 1 by {row_err}")


def run_eval_phase(device: torch.device, card_name: str) -> tuple:
    """The offline evaluation at full width (see the module docstring).
    Returns the kernel launch counts over the phase, and the fp32
    run_eval's top-1/5/10 and get_wer's metrics (phase 18 sets its int8
    pools beside them)."""
    from torch.profiler import ProfilerActivity, profile

    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import ops, wer

    server, rec_positions = build_server(device)
    batches = make_eval_batches(device, server.args, rec_positions)
    n_preds = EVAL_BATCHES * REQUESTS[0]
    t_out = T - server.solver._offsets()[0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    want = dict(normalize_clamp_peak=0, nt_matmul=0, inv_norms=0)
    times, transfers, peaks = {}, {}, {}

    def timed(name, fn, forwards=True, scorings=()):
        """fn() timed by the host clock (synchronized), with its transfer
        counts (a `stats` dict it fills) and peak device memory; the
        launches it implies join `want`."""
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn(stats)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        transfers[name] = stats
        want["normalize_clamp_peak"] += EVAL_BATCHES if forwards else 0
        want["nt_matmul"] += sum(scoring_calls(*s) for s in scorings)
        want["inv_norms"] += sum(norm_calls(n) for _, n in scorings)
        print(f"eval {name}: {times[name]:.2f} s (host clock, synchronized), "
              f"peak device memory {peaks[name]:.2f} GB, transfers {stats} "
              f"({card_name})")
        return result

    data = timed("load_test_data", lambda _: port_eval.load_test_data(
        server, batches))
    n_cands = len(data["trues"])
    if (data["preds"].shape != (n_preds, F, t_out)
            or data["trues"].shape != (EVAL_SEGMENTS, F, t_out)
            or len(np.unique(data["segment_hashes"])) != EVAL_SEGMENTS):
        raise AssertionError(f"load_test_data: preds {data['preds'].shape}, "
                             f"trues {data['trues'].shape}")
    for key in ("preds", "trues"):
        if not np.isfinite(data[key]).all():
            raise AssertionError(f"load_test_data: non-finite {key}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        probs = timed("build_probs fp32, profiled",
                      lambda stats: port_eval.build_probs(
                          server, data["preds"], data["trues"],
                          stats=stats),
                      forwards=False, scorings=[(n_preds, n_cands)])
    _check_eval_probs(probs, (n_preds, n_cands), "build_probs")
    if transfers["build_probs fp32, profiled"]["groups"] != 2:
        raise AssertionError("fp32 candidates: want two device groups")
    activities = device_activities(prof)
    device_ms = sum(us for _, _, us in activities) / 1e3
    gemm_ms = sum(us for key, _, us in activities
                  if any(part in key for part in
                         ("nt_matmul_tiles", "split_tf32", "sum_splits"))
                  ) / 1e3
    print(f"build_probs fp32 in torch.profiler: {device_ms:.2f} ms of device "
          f"time, nt_matmul's kernels {gemm_ms:.2f} ms "
          f"({100 * gemm_ms / device_ms:.1f}% of the device time, "
          f"{100 * gemm_ms / 1e3 / times['build_probs fp32, profiled']:.1f}%"
          f" of the call's wall time)")
    for key, count, us in activities[:12]:
        print(f"  {us / 1e3:9.3f} ms  {count:g}x  {key[:100]}")
    del probs

    accs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, who, dtype in (
                ("fp32", server, None), ("bf16", server, torch.bfloat16),
                ("identity", OutputsAsEstimates(server), None)):
            server.clip.compute_dtype = dtype
            accs[name] = timed(
                f"run_eval {name}", lambda stats: port_eval.run_eval(
                    who, batches, out_dir, stats=stats),
                scorings=[(n_preds, n_cands)])
            server.clip.compute_dtype = None
            _check_eval_probs(np.load(Path(out_dir) / "probs_segment.npy"),
                              (n_preds, n_cands), f"run_eval {name}")
            print(f"run_eval {name}: top-1/5/10 {accs[name]}")
    if accs["identity"][1] != 1.0:
        raise AssertionError(f"identity pass: top-1 {accs['identity'][1]}")

    n_fixed = min(n_preds, server.args.test.wer_negatives) - 1
    metrics = {}
    for name, who in (("", server), (" identity", OutputsAsEstimates(server))):
        metrics[name] = timed(f"get_wer{name}", lambda stats: wer.get_wer(
            who, batches, stats=stats), scorings=[(n_preds, n_fixed)])
        print(f"get_wer{name}: {metrics[name]}")
    if not 0 <= metrics[""]["wer"] <= 1:
        raise AssertionError(f"get_wer: {metrics['']}")
    if metrics[" identity"]["wer"] != 0:
        raise AssertionError(f"get_wer identity: {metrics[' identity']}")

    # the card's build_probs against the CPU's on a sub-block
    preds = data["preds"][:HELD_PREDS]
    trues = data["trues"][:HELD_CANDIDATES]
    probs = port_eval.build_probs(server, preds, trues)
    want["nt_matmul"] += scoring_calls(HELD_PREDS, HELD_CANDIDATES)
    want["inv_norms"] += norm_calls(HELD_CANDIDATES)
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    reference, _ = build_server("cpu")
    probs_ref = port_eval.build_probs(reference, preds, trues)
    held_err = float(np.abs(probs - probs_ref).max())
    print(f"build_probs {HELD_PREDS} x {HELD_CANDIDATES} against the CPU: "
          f"max|diff| {held_err:.3e} (atol {PROBS_TOL})")
    if held_err > PROBS_TOL:
        raise AssertionError(f"card vs CPU build_probs: max|diff| {held_err}")

    print(f"eval phase: {n_preds} predictions, {n_cands} candidates, kernel "
          f"launches {launches}, want {want}")
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"the eval path launched {name} "
                                 f"{launches[name]} times, want {count}")
    del server, data, batches
    torch.cuda.empty_cache()
    return launches, dict(accuracy=accs["fp32"], wer=metrics[""])


#: phase 8: the CLI on the fake study (all four recordings, 120 mels, the
#: default tmin/tmax at 120 Hz), the paper encoder with fused_conv_bn
CLI_ARGS = ("preset=clip_conv", "simpleconv.fused_conv_bn=True",
            'dset.selections=["fake"]', 'dset.features=["MelSpectrum"]',
            "optim.batch_size=64")
CLI_EPOCHS = 2
#: the card's preprocessed raw against the CPU's, as a share of max|x|
PREPROCESS_TOL = 1e-5


class SolverSpy:
    """While installed: times each Solver.step with CUDA events (read after
    the run), counts the forwards (Solver._forward) and the nt_matmul and
    inv_norms launches of each test stage, keeps the dtypes of the meg the
    loaders send to the card and the last solver seen."""

    def __init__(self) -> None:
        from brainmagick_tpu_torch import loader, solver
        self.targets = [(solver.Solver, "step"), (solver.Solver, "_forward"),
                        (solver.Solver, "_test_one_epoch"),
                        (loader._Staging, "send")]
        self.saved = [getattr(cls, name) for cls, name in self.targets]
        self.events: list = []
        self.forwards = 0
        self.test_nt_matmul: list = []
        self.test_inv_norms: list = []
        self.sent_dtypes: set = set()
        self.solver = None

    def __enter__(self) -> "SolverSpy":
        from brainmagick_tpu_torch import ops
        step, forward, test, send = self.saved
        spy = self

        def timed_step(solver, arrays, pad_weight, train, **kwargs):
            spy.solver = solver
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(solver, arrays, pad_weight, train, **kwargs)
            end.record()
            spy.events.append((train, start, end))
            return out

        def counted_forward(solver, *args, **kwargs):
            spy.forwards += 1
            return forward(solver, *args, **kwargs)

        def counted_test(solver):
            before = ops.nt_matmul.launches, ops.inv_norms.launches
            out = test(solver)
            spy.test_nt_matmul.append(ops.nt_matmul.launches - before[0])
            spy.test_inv_norms.append(ops.inv_norms.launches - before[1])
            return out

        def seen_send(staging, *args, **kwargs):
            arrays, weight = send(staging, *args, **kwargs)
            spy.sent_dtypes.add(arrays["meg"].dtype)
            return arrays, weight

        for (cls, name), fn in zip(self.targets, (
                timed_step, counted_forward, counted_test, seen_send)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc) -> None:
        for (cls, name), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)

    def train_step_ms(self) -> list:
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for train, start, end in self.events
                if train]


def run_cli(argv: list, what: str, card_name: str) -> tuple:
    """``train.main(argv)`` with every launch count set to 0 just before
    it; returns (the kernels' launch counts, conv_stats' by route and by
    type, the spy, the wall seconds, the peak device memory in GB)."""
    from brainmagick_tpu_torch import ops, train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with SolverSpy() as spy:
        t0 = time.perf_counter()
        best = train.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    routes = dict(ops.conv_stats.launches_by_route)
    by_dtype = dict(ops.conv_stats.launches_by_dtype)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"cli {what}: best valid loss {best:.4f} in {wall:.1f} s "
          f"({card_name}); kernel launches {launches}, conv_stats by route "
          f"{routes}, by type {by_dtype}; {len(spy.events)} steps, "
          f"{spy.forwards} forwards, peak device memory {peak_gb:.2f} GB")
    return launches, routes, by_dtype, spy, wall, peak_gb


def _check_cli_launches(what: str, launches: dict, routes: dict,
                        by_dtype: dict, spy: SolverSpy, dtype: str,
                        tested: bool = True, scored: bool = True,
                        fused: int = 10) -> int:
    """conv_stats `fused` times a train step (the fused encoder layers),
    every launch `dtype` on the tensor-core route; normalize once a
    forward; nt_matmul and inv_norms in every test stage (`scored`: a CLIP
    test stage scores its estimates; else never) and nowhere else, and
    (`tested`) a test stage ran. Returns the train steps."""
    steps = sum(1 for train, _, _ in spy.events if train)
    want = dict(conv_stats=fused * steps, normalize_clamp_peak=spy.forwards,
                nt_matmul=sum(spy.test_nt_matmul) if scored else 0,
                inv_norms=sum(spy.test_inv_norms) if scored else 0)
    if steps == 0 or (tested and not spy.test_nt_matmul) \
            or (scored and min(spy.test_nt_matmul + spy.test_inv_norms,
                               default=1) < 1):
        raise AssertionError(f"cli {what}: {steps} train steps, nt_matmul "
                             f"launches by test stage {spy.test_nt_matmul}")
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"cli {what} launched {name} "
                                 f"{launches[name]} times, want {count}")
    if routes != {"tc": fused * steps} or by_dtype[dtype] != fused * steps:
        raise AssertionError(f"cli {what} ran conv_stats by route {routes}, "
                             f"by type {by_dtype}, want every launch "
                             f"{dtype} on 'tc'")
    return steps


def _read_history(folder: Path, epochs: int, what: str) -> list:
    """The port's history-torch.json in the XP folder: `epochs` epochs of
    finite losses; done-torch.json beside it, and neither of the JAX
    package's untagged names."""
    history = json.loads((folder / "history-torch.json").read_text())
    losses = [h[stage]["loss"] for h in history
              for stage in ("train", "valid")]
    if len(history) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"cli {what}: history-torch.json {history}, "
                             f"want {epochs} epochs of finite losses")
    if not (folder / "done-torch.json").exists():
        raise AssertionError(f"cli {what}: no done-torch.json in {folder}")
    untagged = [name for name in ("done.json", "history.json")
                if (folder / name).exists()]
    if untagged:
        raise AssertionError(f"cli {what}: the port wrote {untagged}")
    return history


def check_loader(dataset, device: torch.device, dtype) -> int:
    """The card loader's batches (pinned buffers reused behind CUDA
    events, `dtype` = parallel.assemble_dtype) against the host loader's
    for the same seed and epoch, bit for bit after the same cast. A GEMM
    between batches keeps the stream busy, so each copy lands late, and
    every batch is read only after the loop. Returns the batch count."""
    from brainmagick_tpu_torch.dataset import ARRAY_FIELDS
    from brainmagick_tpu_torch.loader import Loader
    from brainmagick_tpu_torch.precision import torch_dtype

    kwargs = dict(batch_size=64, shuffle=True, seed=SEED, num_workers=2)
    host = Loader(dataset, **kwargs)
    card = Loader(dataset, device=device, assemble_dtype=dtype, **kwargs)
    host.set_epoch(1)
    card.set_epoch(1)
    busy = torch.randn(4096, 4096, device=device)
    sent = []
    for batch, weight in card:
        busy = busy @ busy.T / busy.norm()
        sent.append((batch, weight))
    wire = torch_dtype(dtype)
    n = 0
    for (want, want_weight), (got, weight) in zip(host, sent):
        for name in ARRAY_FIELDS + ("pad_weight",):
            ref = torch.from_numpy(np.asarray(
                want_weight if name == "pad_weight" else getattr(want, name)))
            value = weight if name == "pad_weight" else getattr(got, name)
            if wire is not None and name in ("meg", "features"):
                ref = ref.to(wire)
            if value.device.type != "cuda" or not torch.equal(
                    value.cpu(), ref.to(value.dtype)):
                raise AssertionError(f"card loader ({dtype}), batch {n}: "
                                     f"{name} differs from the host's")
        n += 1
    if n != len(host) or len(sent) != n:
        raise AssertionError(f"card loader gave {len(sent)} batches, the "
                             f"host's {n} of {len(host)}")
    return n


def check_cli_shapes(device: torch.device, batch: int, n_test: int,
                     n_mels: int, channels: int = C, with_conv: bool = True,
                     prefix: str = "",
                     n_cand: tp.Optional[int] = None,
                     with_matmul: bool = True,
                     convs: tp.Optional[tuple] = None,
                     n_times: int = T) -> dict:
    """Each kernel against its plain version at the shapes phase 8's CLI
    run gave it, in fp32 (clip_conv) and bf16 (clip_conv_tpu), timed
    beside its plain version, its library call and its bound: normalize
    at [batch, C, T] with four recordings' tables; conv_stats at the
    encoder's first two layer shapes at `batch`, forward and backward;
    nt_matmul at the test stage's `n_test` estimates against the other
    `n_test - 1` outputs (`n_cand` when given: an evaluation's
    candidates), K = n_mels x T' (n_mels the scored width: the mel bins,
    or DeepMel's outputs); normalize at `channels`
    sensors and `n_times` samples, conv_stats only `with_conv` (at the
    `convs` shapes when given, (B, C, O, T, dilation, k) each), nt_matmul
    only `with_matmul`, each label after `prefix`.
    Returns {kernel name: {shape label: entry}} for the kernels'
    other_shapes."""
    import torch.nn.functional as fn

    from brainmagick_tpu_torch.ops import conv_bn, norm

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    out: dict = {"normalize_clamp_peak": {}, "nt_matmul": {},
                 "conv_stats": {}, "inv_norms": {}}
    conv_shapes = (convs or ((batch, 270, 320, T - 18, 1, 3),
                             (batch, 320, 320, T - 18, 2, 3))
                   ) if with_conv else ()
    for dtype in (torch.float32, torch.bfloat16):
        name = _type_name(dtype)
        shape = (batch, channels, n_times)
        meg, center, scale, _ = _norm_case(shape, dtype, device, gen)
        rec = torch.arange(batch, device=device) % NORM_RECORDINGS
        got = norm.normalize_clamp_peak(meg, center, scale, LIMIT, rec=rec)
        want = norm._reference_impl(meg, center, scale, LIMIT, True, rec)
        if not all(map(_same_bits, got, want)):
            raise AssertionError(f"normalize_clamp_peak {shape} {name} "
                                 f"differs from plain")
        n_bytes = (meg.element_size() * meg.numel() + 4 * meg.numel()
                   + 2 * center.numel() * 4 + 8 * batch + 4 * batch)
        entry = dict(
            ms=median_ms(lambda: norm.normalize_clamp_peak(
                meg, center, scale, LIMIT, rec=rec)),
            plain_ms=median_ms(lambda: norm._reference_impl(
                meg, center, scale, LIMIT, True, rec)),
            library_ms=None, max_abs_err=0.0)
        entry.update(zip(("bound_ms", "bound_by"), bound(n_bytes)))
        out["normalize_clamp_peak"][
            f"{prefix}{batch}x{channels}x{n_times} {name}"] = entry

        if with_matmul:
            check_matmul_shape(device, gen, dtype, n_test, n_mels, n_cand,
                               prefix, out)

        for conv in conv_shapes:
            _, Cin, O, Tc, d, k = conv
            x, w, cot = _conv_case(conv, dtype, device, gen)
            got = conv_bn.conv_stats(x, w, d)
            want = conv_bn._reference_impl(x, w, d)
            errors = _conv_errors(
                x, w, d, cot, got, want,
                _conv_grads(conv_bn.conv_stats, x, w, d, cot),
                _conv_grads(conv_bn._reference_impl, x, w, d, cot))
            grad_tol = CONV_GRAD_TOL_BF16 if dtype == torch.bfloat16 \
                else CONV_TOL
            limits = dict(y=CONV_TOL, s=CONV_TOL, ss=CONV_TOL, dx=grad_tol,
                          dw=grad_tol)
            if any(not errors[key] <= limit
                   for key, limit in limits.items()):
                raise AssertionError(f"conv_stats {conv} {name}: {errors}")
            entry = dict(
                ms=median_ms(lambda: conv_bn.conv_stats(x, w, d)),
                plain_ms=median_ms(lambda: conv_bn._reference_impl(x, w, d)),
                library_ms=median_ms(lambda: fn.conv1d(
                    x, w, padding=(k // 2) * d, dilation=d)),
                max_abs_err=errors["abs_y"])
            entry.update(zip(("bound_ms", "bound_by"),
                             _conv_bound(conv, dtype)))
            out["conv_stats"][
                f"{prefix}{batch}x{Cin}x{Tc} O{O} k{k} d{d} {name}"] = entry
            del x, w, cot, got, want
        del meg, center, scale
    for kernel, shapes in out.items():
        for label, entry in shapes.items():
            print(f"{kernel} at the CLI's shape {label}: kernel "
                  f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
                  f"library "
                  + ("none" if entry["library_ms"] is None
                     else f"{entry['library_ms']:.4f} ms")
                  + f", bound {entry['bound_ms']:.4f} ms "
                  f"({entry['bound_by']}), max|diff| "
                  f"{entry['max_abs_err']:.3e}")
    return out


def check_matmul_shape(device: torch.device, gen: torch.Generator, dtype,
                       n_test: int, n_mels: int,
                       n_cand: tp.Optional[int], prefix: str,
                       out: dict) -> None:
    """nt_matmul against its plain version at a test stage's `n_test`
    estimates against the other `n_test - 1` outputs (`n_cand` when
    given), K = n_mels x T', timed beside its plain version, cuBLAS and
    its bound, and inv_norms over those outputs; the entries go into
    `out` under their kernels."""
    from brainmagick_tpu_torch.ops import matmul

    name = _type_name(dtype)
    depth = n_mels * (T - 18)
    a = torch.randn((n_test, depth), generator=gen, device=device).to(dtype)
    n_b = n_test - 1 if n_cand is None else n_cand
    b = torch.randn((n_b, depth), generator=gen, device=device).to(dtype)
    abs_err, rel_err = _matmul_error(a, b, matmul.nt_matmul(a, b))
    if not rel_err <= MATMUL_TOL:
        raise AssertionError(f"nt_matmul {tuple(a.shape)} x "
                             f"{tuple(b.shape)} {name}: {rel_err}")
    flop = 2 * a.shape[0] * b.shape[0] * depth
    out_dtype = ({} if dtype == torch.float32
                 else dict(out_dtype=torch.float32))
    entry = dict(
        ms=median_ms(lambda: matmul.nt_matmul(a, b)),
        plain_ms=median_ms(lambda: matmul._reference_impl(a, b)),
        library_ms=median_ms(lambda: torch.mm(a, b.T, **out_dtype)),
        max_abs_err=abs_err)
    entry.update(zip(("bound_ms", "bound_by"), bound(
        a.element_size() * (a.shape[0] + b.shape[0]) * depth
        + 4 * a.shape[0] * b.shape[0],
        *((3 * flop, TF32_FLOPS) if dtype == torch.float32
          else (flop, BF16_FLOPS)))))
    out["nt_matmul"][f"{prefix}{n_test}x{n_b}x{depth} {name}"] = entry
    out["inv_norms"][f"{prefix}{n_b}x{depth} {name}"] = inv_norms_entry(
        b, f"{prefix}{n_b}x{depth} {name}")


def run_cli_phase(device: torch.device, card_name: str, work: Path
                  ) -> tuple:
    """Phase 8: ``python -m brainmagick_tpu_torch.train``'s main in this
    process on the fake study at the paper encoder's width: CLI_EPOCHS
    epochs, a rerun with one epoch more, and one epoch of the
    clip_conv_tpu recipe, each XP in `work` (whose name holds
    "fake_cache"). Returns the kernel launch counts of the first run
    (cli_train) and of the recipe's (cli_recipe), the shapes the run gave
    the kernels (``check_cli_shapes``' arguments), and the first run's
    and the recipe's XPs (cli_train, cli_recipe: each signature, out_dir
    and cache) for phases 10 and 17."""
    from brainmagick_tpu_torch.studies import api, fake
    from brainmagick_tpu_torch.train import parse_overrides

    raw = fake.create_fake_meg(seed=1234)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = api.preprocess_raw(raw, 120, device=device)
    preprocess_s = time.perf_counter() - t0
    on_cpu = api.preprocess_raw(raw, 120, device="cpu")
    err = float(np.abs(on_card.data - on_cpu.data).max()
                / np.abs(on_cpu.data).max())
    print(f"preprocessed raw {list(raw.data.shape)} at 1200 Hz -> "
          f"{list(on_card.data.shape)} at 120 Hz on the card in "
          f"{preprocess_s:.3f} s (first call; {card_name}); max |card - "
          f"CPU| / max |x| = {err:.2e} (limit {PREPROCESS_TOL:.0e})")
    if not err <= PREPROCESS_TOL:
        raise AssertionError(f"preprocessed raw: card against CPU {err:.2e}")

    out: dict = {}
    common = [*CLI_ARGS, f"cache={work}/cache", f"out_dir={work}/outputs"]
    first = common + [f"optim.epochs={CLI_EPOCHS}"]
    launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
        first, f"{CLI_EPOCHS} epochs", card_name)
    solver = spy.solver
    sizes = {name: len(getattr(solver.datasets, name))
             for name in ("train", "valid", "test")}
    n_train_batches = len(solver.loaders["train"])
    print(f"cli splits (segments): {sizes}; {n_train_batches} train "
          f"batches of {solver.args.optim.batch_size}")
    shapes = dict(batch=solver.args.optim.batch_size,
                  n_test=sizes["test"], n_mels=solver.used_features[
                      "MelSpectrum"].n_mels)
    if n_train_batches < 2:
        raise AssertionError(f"the train split holds {sizes['train']} "
                             f"segments, fewer than two batches")
    for dtype in (None, "bfloat16"):
        n = check_loader(solver.datasets.train, device, dtype)
        print(f"card loader ({dtype or 'float32'}): {n} batches equal "
              f"to the host loader's")
    steps = _check_cli_launches(f"{CLI_EPOCHS} epochs", launches,
                                routes, by_dtype, spy, "float32")
    if steps != CLI_EPOCHS * n_train_batches:
        raise AssertionError(f"{steps} train steps, want "
                             f"{CLI_EPOCHS * n_train_batches}")
    args = parse_overrides(first)
    history = _read_history(Path(args.xp_folder), CLI_EPOCHS, "run")
    wer_keys = {"wer", "wer_vocab", "wer_n_vocab"}
    if not wer_keys <= set(history[0].get("test", {})):
        raise AssertionError(f"no WER in the test stage: {history[0]}")
    step_ms = spy.train_step_ms()
    tracks_s = sum(d.track_seconds for split in solver.datasets
                   for d in split.datasets)
    timings = solver.build_timings
    epoch_s = [sum(v for k, v in sec.items() if k != "test")
               for sec in solver.stage_seconds]
    test_s = [sec["test"] for sec in solver.stage_seconds
              if "test" in sec]
    print(f"cli timings ({card_name}): preprocessing "
          f"{preprocess_s:.3f} s per recording, dataset build "
          f"{timings['datasets']:.2f} s (4 recordings preprocessed on "
          f"the card), track render {tracks_s:.2f} s, scaler fit "
          f"{timings['scaler']:.2f} s (the track render included), "
          f"train step median {statistics.median(step_ms):.2f} ms over "
          f"{len(step_ms)} steps (device time), s per epoch (train + "
          f"valid) {[round(x, 2) for x in epoch_s]}, test stage "
          f"{[round(x, 2) for x in test_s]} s, peak device memory "
          f"{peak_gb:.2f} GB, whole run {wall:.1f} s")
    print(f"cli history: {history}")
    out["cli_train"] = launches

    # one epoch more, from the finished XP's whole state
    resumed = common + ["optim.epochs=3", f"continue_sig={args.sig}",
                        "continue_best=False"]
    launches, routes, by_dtype, spy, _, _ = run_cli(
        resumed, "resumed with optim.epochs=3", card_name)
    # its test stage runs only if epoch 3 improves the valid loss
    steps = _check_cli_launches("resume", launches, routes, by_dtype,
                                spy, "float32", tested=False)
    history3 = _read_history(Path(parse_overrides(resumed).xp_folder), 3,
                             "resume")
    if steps != n_train_batches or history3[:2] != history:
        raise AssertionError(f"the resumed run took {steps} train steps "
                             f"(want {n_train_batches}) and its history "
                             f"starts {history3[:2]}")

    # one epoch of the bf16 recipe, the loaders assembling in bf16
    recipe = [f"preset={RECIPE}", *common[1:], "optim.epochs=1"]
    if parse_overrides(recipe).parallel.assemble_dtype != "bfloat16":
        raise AssertionError(f"{RECIPE} does not assemble in bf16")
    launches, routes, by_dtype, spy, _, _ = run_cli(
        recipe, f"{RECIPE}, 1 epoch", card_name)
    _check_cli_launches(RECIPE, launches, routes, by_dtype, spy,
                        "bfloat16")
    if spy.sent_dtypes != {torch.bfloat16}:
        raise AssertionError(f"the {RECIPE} loaders sent meg in "
                             f"{spy.sent_dtypes}, want bf16 only")
    _read_history(Path(parse_overrides(recipe).xp_folder), 1, RECIPE)
    out["cli_recipe"] = launches
    xps = {name: dict(sig=parse_overrides(argv).sig,
                      out_dir=f"{work}/outputs", cache=f"{work}/cache")
           for name, argv in (("cli_train", first), ("cli_recipe", recipe))}
    del solver, spy
    torch.cuda.empty_cache()
    return out, shapes, xps


#: phase 9: the paper's four studies, each a synthetic tree in the study's
#: on-disk format at its real sensor count and rate, two recordings of
#: STUDY_SECONDS (brennan2019's story needs its 2,129 words; MOUS's
#: sentence trials, one 3 s window in three of their 4.4 s, need
#: MOUS_SECONDS for three train batches), trained by the CLI for one
#: epoch of the clip_conv_tpu recipe with fused_conv_bn
STUDY_SECONDS = 360.
MOUS_SECONDS = 900.
STUDY_ARGS = (f"preset={RECIPE}", "simpleconv.fused_conv_bn=True",
              'dset.features=["MelSpectrum"]', "optim.batch_size=256",
              "optim.epochs=1", "dset.n_recordings=2")
#: a word every WORD_STEP seconds, each WORD_SECONDS long
WORD_STEP, WORD_SECONDS = 0.3, 0.25
#: the MOUS presentation log (two tab-separated blocks)
MOUS_LOG_HEADER = ("Subject\tTrial\tEvent Type\tCode\tTime\tTTime\t"
                   "Uncertainty\tDuration\tUncertainty\tReqTime\tReqDur")
#: MOUS: the MEG clock runs this far ahead of the log's
MOUS_SHIFT = 0.5


def _vocabulary(rng: np.random.RandomState, size: int = 400) -> list:
    """Pseudo-words of one to three syllables."""
    onsets = ["b", "d", "k", "l", "m", "n", "p", "r", "s", "t", "v", "z"]
    vowels = ["a", "e", "i", "o", "u", "aa", "ee", "oo"]
    words: set = set()
    while len(words) < size:
        words.add("".join(rng.choice(onsets) + rng.choice(vowels)
                          for _ in range(rng.randint(1, 4))))
    return sorted(words)


def _sentences(rng: np.random.RandomState, n_words: int) -> list:
    """Distinct sentences (lists of 6 to 12 words), `n_words` words in
    all (the last one cut to fit, at least 2 words)."""
    vocabulary = _vocabulary(rng)
    out, seen, total = [], set(), 0
    while total < n_words:
        n = min(rng.randint(6, 13), n_words - total)
        words = [str(w) for w in rng.choice(vocabulary, max(n, 2))]
        if " ".join(words)[:45] in seen:
            continue
        seen.add(" ".join(words)[:45])
        out.append(words)
        total += len(words)
    return out


def _meg(rng, n: int, sample_rate: float, seconds: float,
         scale: float) -> np.ndarray:
    return (rng.randn(n, int(sample_rate * seconds)) * scale
            ).astype(np.float32)


def write_gwilliams_tree(root: Path, rng) -> dict:
    """MEG-MASC's BIDS layout: participants.tsv, then per subject the
    session-0 story-0 KIT .con (208 axial gradiometers in tesla, a
    trigger and a misc channel at 1000 Hz) and its events.tsv (a sound
    over the story, a word every WORD_STEP s, with dict-literal
    trial_type cells), and the story's wav."""
    import csv

    from brainmagick_tpu_torch.mockdata import write_speech_wav
    from brainmagick_tpu_torch.studies import api, fake, kit

    download = root / "download"
    download.mkdir(parents=True)
    subjects = ["01", "02"]
    with open(download / "participants.tsv", "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(["participant_id", "age"])
        writer.writerows([f"sub-{s}", 30 + k] for k, s in enumerate(subjects))
    n_words = int((STUDY_SECONDS - 4) / WORD_STEP * 0.9)
    sentences = _sentences(rng, n_words)
    story = STUDY_SECONDS - 2.
    write_speech_wav(download / "stimuli" / "audio" / "story0.wav", story)
    rows = [(1.0, story - 1., repr(dict(
        kind="sound", sound="stimuli/audio/story0.WAV.wav")))]
    t, words = 1.0, []
    for seq_id, sentence in enumerate(sentences):
        for word in sentence:
            rows.append((round(t, 4), WORD_SECONDS, repr(dict(
                kind="word", word=word, sequence_id=seq_id,
                condition="sentence"))))
            words.append(word)
            t += WORD_STEP
        t += WORD_STEP
    written: dict = {"sample_rate": 1000.}
    for subject in subjects:
        meg = download / f"sub-{subject}" / "ses-0" / "meg"
        meg.mkdir(parents=True)
        stem = f"sub-{subject}_ses-0_task-0"
        with open(meg / f"{stem}_events.tsv", "w", newline="") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(["onset", "duration", "trial_type"])
            writer.writerows(rows)
        n = int(1000 * STUDY_SECONDS)
        stim = np.zeros((1, n), dtype=np.float32)
        stim[0, 1000:1050] = 1.
        raw = api.RawData(
            data=np.concatenate([_meg(rng, 208, 1000., STUDY_SECONDS, 1e-13),
                                 stim, _meg(rng, 1, 1000., STUDY_SECONDS,
                                            0.1)]),
            sample_rate=1000., ch_names=[f"MEG {k:03d}" for k in range(210)],
            positions=np.concatenate([fake.grid_positions(208),
                                      np.full((2, 2), api.INVALID_POSITION)]
                                     ).astype(np.float32),
            ch_kinds=[kit.KIND_MEG] * 208 + [kit.KIND_STIM, kit.KIND_OTHER])
        path = meg / f"{stem}_meg.con"
        kit.write_kit(path, raw, system_name="New York University 208ch")
        written.setdefault("file", path)
        written.setdefault("data", raw.data[:208])
    written["words"] = words * len(subjects)
    return written


def _write_textgrid(path: Path, words: list) -> float:
    """A long-format TextGrid: the words (ORT-MAU, one every WORD_STEP s)
    and two or three phonemes each (MAU); returns the audio's length."""
    from brainmagick_tpu_torch.phonemes import ph_dict

    names = list(ph_dict)
    word_entries, ph_entries = [], []
    t = 0.1
    for k, word in enumerate(words):
        word_entries.append((t, t + WORD_SECONDS, word))
        n_ph = 2 + k % 2
        for j in range(n_ph):
            ph_entries.append((t + WORD_SECONDS * j / n_ph,
                               t + WORD_SECONDS * (j + 1) / n_ph,
                               names[(7 * k + j) % len(names)]))
        t += WORD_STEP
    end = round(t + 0.1, 4)
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {end}", "tiers? <exists>", "size = 2",
             "item []:"]
    for tier_idx, (tier, entries) in enumerate(
            [("ORT-MAU", word_entries), ("MAU", ph_entries)], 1):
        lines += [f"    item [{tier_idx}]:", '        class = "IntervalTier"',
                  f'        name = "{tier}"', "        xmin = 0",
                  f"        xmax = {end}",
                  f"        intervals: size = {len(entries)}"]
        for j, (a, b, name) in enumerate(entries, 1):
            lines += [f"        intervals [{j}]:",
                      f"            xmin = {round(a, 4)}",
                      f"            xmax = {round(b, 4)}",
                      f'            text = "{name}"']
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return end


def write_mous_tree(root: Path, rng) -> dict:
    """The MOUS (Donders) layout for two audio subjects: stimuli.txt, a
    wav and a TextGrid per sentence, each subject's Presentation log (a
    fixation, a ZINNEN context, the sentence's sound and its audio onset
    per trial) and CTF .ds (273 MEG head sensors in tesla, 28 reference
    channels and the UPPT001 trigger channel at 1200 Hz, its triggers
    MOUS_SHIFT s after the log's fixations (20) and contexts (10))."""
    from brainmagick_tpu_torch.mockdata import write_speech_wav
    from brainmagick_tpu_torch.studies import api, ctf, fake

    download = root / "download"
    # more sentences than the recording holds: the trials fill it
    sentences = _sentences(rng, int(MOUS_SECONDS / 4.) * 9)
    (download / "stimuli").mkdir(parents=True)
    (download / "stimuli" / "stimuli.txt").write_text("".join(
        f"{uid} {' '.join(s)}\n" for uid, s in enumerate(sentences, 1)))
    lengths = {}
    for uid, sentence in enumerate(sentences, 1):
        lengths[uid] = _write_textgrid(
            download / "derivatives" / "textgrids"
            / ("EQ_Ramp_Int2_Int1LPF%.3i.TextGrid" % uid), sentence)
        write_speech_wav(download / "stimuli" / "audio_files"
                         / f"{uid:03d}.wav", lengths[uid])
    sfreq = 1200.
    written: dict = {"words": [], "sample_rate": sfreq}
    for subject in ("sub-A2002", "sub-A2003"):
        rows1, rows2, sync = [], [], []

        def add(event_type, code, t, duration=0.):
            rows1.append(f"{subject[4:]}\t1\t{event_type}\t{code}\t"
                         f"{int(round(t * 1e4))}\t0\t0\t"
                         f"{int(round(duration * 1e4))}\t0\t0\t0")
            if event_type in ("Picture", "Sound", "Nothing"):
                rows2.append("0\tx")

        t = 1.
        for uid, sentence in enumerate(sentences, 1):
            if t + 1.5 + lengths[uid] > MOUS_SECONDS - 2:
                break
            add("Picture", f"FIX {uid}", t)
            sync.append((t, 20))
            t += 0.5
            add("Picture", f"ZINNEN {uid}", t)
            sync.append((t, 10))
            t += 0.5
            add("Sound", f"Start File {uid:03d}.wav", t)
            add("Nothing", "Audio onset", t + 0.01)
            written["words"] += sentence
            t += lengths[uid]
            add("Nothing", "End of file", t)
            t += 0.5
        log = download / "sourcedata" / "meg_task" / \
            f"{subject}-MEG-MOUS-Aud.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        log.write_text("Scenario - synthetic\nheader\n" + MOUS_LOG_HEADER
                       + "\n" + "\n".join(rows1) + "\n\n\nUncertainty\t"
                       "StimInfo\n" + "\n".join(rows2) + "\n")
        n = int(sfreq * MOUS_SECONDS)
        stim = np.zeros((1, n), dtype=np.float32)
        for when, code in sync + [(MOUS_SECONDS - 1. - MOUS_SHIFT, 5)]:
            sample = int((when + MOUS_SHIFT) * sfreq)
            stim[0, sample:sample + 300] = code
        raw = api.RawData(
            data=np.concatenate([_meg(rng, 273, sfreq, MOUS_SECONDS, 1e-12),
                                 _meg(rng, 28, sfreq, MOUS_SECONDS, 1.),
                                 stim]),
            sample_rate=sfreq,
            ch_names=[f"MEG{k:03d}-4304" for k in range(273)]
            + [f"REF{k:02d}-4304" for k in range(28)] + ["UPPT001"],
            positions=np.concatenate([
                fake.grid_positions(273),
                np.full((29, 2), api.INVALID_POSITION)]).astype(np.float32),
            ch_kinds=[ctf.KIND_MEG] * 273 + [ctf.KIND_OTHER] * 28
            + [ctf.KIND_STIM])
        path = download / subject / "meg" / f"{subject}_task-auditory_meg.ds"
        ctf.write_ctf(path, raw, trial_samples=int(sfreq))
        written.setdefault("file", path)
        written.setdefault("data", raw.data[:273])
    return written


def write_brennan_tree(root: Path, rng) -> dict:
    """Brennan2019's layout for subjects S01 and S03: each subject's
    MATLAB proc struct (the 2,129 word trials, at WORD_STEP s) and raw
    struct (60 EEG + VEOG + AUD channels in µV at 500 Hz), the story's
    AliceChapterOne-EEG.csv (12 audio segments) and a wav per segment."""
    import csv

    from scipy.io import savemat

    from brainmagick_tpu_torch.mockdata import write_speech_wav

    download = root / "download"
    (download / "proc").mkdir(parents=True)
    n_trials, sfreq, n_segments = 2129, 500., 12
    sentences = _sentences(rng, n_trials)
    rows, k = [], 0
    per_segment = -(-n_trials // n_segments)
    for seq_id, sentence in enumerate(sentences):
        for position, word in enumerate(sentence):
            segment = 1 + k // per_segment
            onset = 0.1 + (k - (segment - 1) * per_segment) * WORD_STEP
            rows.append((word, position, seq_id, segment, round(onset, 4),
                         round(onset + WORD_SECONDS, 4)))
            k += 1
    with open(download / "AliceChapterOne-EEG.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Word", "Position", "Sentence", "Segment",
                         "onset", "offset"])
        writer.writerows(rows)
    for segment in range(1, n_segments + 1):
        write_speech_wav(download / "audio"
                         / f"DownTheRabbitHoleFinal_SoundFile{segment}.wav",
                         per_segment * WORD_STEP + 0.5)
    starts = (np.arange(n_trials) * WORD_STEP * sfreq + sfreq).astype(float)
    trl = np.stack([starts, starts + WORD_SECONDS * sfreq,
                    np.zeros(n_trials), np.array([r[3] for r in rows], float),
                    np.arange(n_trials, dtype=float)], axis=1)
    seconds = float(np.ceil(starts[-1] / sfreq + 5.))
    labels = [str(i + 1 + (i >= 28)) for i in range(60)] + ["VEOG", "AUD"]
    written: dict = {"words": [r[0] for r in rows] * 2,
                     "sample_rate": sfreq}
    for subject in ("S01", "S03"):
        savemat(download / "proc" / f"{subject}.mat", dict(proc=dict(
            trl=trl, tot_trials=float(n_trials), tot_chans=61.,
            varnames=np.array(["segment", "order"], dtype=object))))
        trial = _meg(rng, 62, sfreq, seconds, 10.)
        savemat(download / f"{subject}.mat", dict(raw=dict(
            hdr=dict(Fs=sfreq, nChans=62., label=np.array(labels,
                                                          dtype=object)),
            fsample=sfreq, trial=trial)))
        written.setdefault("file", download / f"{subject}.mat")
        written.setdefault("data", trial[:60] * 1e-6)
    return written


def write_broderick_tree(root: Path, rng) -> dict:
    """Broderick2019's layout for Subject1's runs 1 and 2 (the study lists
    20 runs a subject, so two recordings are two runs): each run's gentle
    alignment JSON (a word every WORD_STEP s, its phones), transcript and
    wav, and the run's MATLAB eegData (128 channels at 128 Hz)."""
    import json

    from scipy.io import savemat

    from brainmagick_tpu_torch.mockdata import write_speech_wav

    download = root / "download"
    private = download / "private"
    private.mkdir(parents=True)
    eeg_dir = download / "Natural Speech" / "EEG" / "Subject1"
    eeg_dir.mkdir(parents=True)
    written: dict = {"words": [], "sample_rate": 128.}
    for run in (1, 2):
        sentences = _sentences(rng, int((STUDY_SECONDS - 3) / WORD_STEP))
        (private / f"oldman_run{run}.txt").write_text(" ".join(
            " ".join(s).capitalize() + "." for s in sentences))
        t, entries = 0.5, []
        for word in (w for s in sentences for w in s):
            entries.append(dict(
                case="success", word=word, alignedWord=word,
                start=round(t, 3), end=round(t + WORD_SECONDS, 3),
                phones=[dict(phone=f"{c}_B", duration=WORD_SECONDS / 2)
                        for c in word[:2]], startOffset=0, endOffset=1))
            written["words"].append(word)
            t += WORD_STEP
        (private / f"align{run}.json").write_text(json.dumps(
            dict(words=entries)))
        write_speech_wav(private / f"audio{run}.wav", t + 1.)
        eeg = (rng.randn(int(128 * STUDY_SECONDS), 128) * 1e-6
               ).astype(np.float32)
        savemat(eeg_dir / f"Subject1_Run{run}.mat",
                dict(fs=np.array([[128.]]), eegData=eeg))
        written.setdefault("file", eeg_dir / f"Subject1_Run{run}.mat")
        written.setdefault("data", eeg.T * 1e6)
    return written


#: (selection, study, tree writer, sensors the model sees)
STUDY_TREES = (("gwilliams2022", "gwilliams2022", write_gwilliams_tree, 208),
               ("audio_mous", "schoffelen2019", write_mous_tree, 273),
               ("brennan2019", "brennan2019", write_brennan_tree, 60),
               ("broderick2019", "broderick2019", write_broderick_tree, 128))


def check_reread(study: str, raw, written: dict, scratch: Path) -> str:
    """The first recording's raw, as its adapter reads it, against the
    array written: within half a quantization step of the format (KIT
    int16 counts, CTF int32), then bit-equal after one more write and read
    of the reader's arrays; equal bits for MATLAB's float32."""
    from brainmagick_tpu_torch.studies import ctf, kit

    got, want = raw.data, written["data"]
    if got.shape != want.shape:
        raise AssertionError(f"{study}: read {got.shape}, wrote {want.shape}")
    path = written["file"]
    if path.suffix in (".con", ".ds"):
        if path.suffix == ".con":
            step = kit.INPUT_RANGE_VOLTS / 2 ** kit.ADC_BITS * 1e-12
            full = kit.read_kit(path)
            kit.write_kit(scratch / "again.con", full,
                          system_name="New York University 208ch")
            again = kit.read_kit(scratch / "again.con")
        else:
            step = 1. / (1e9 * 2 ** 20)
            full = ctf.read_ctf(path)
            ctf.write_ctf(scratch / "again.ds", full, trial_samples=1200)
            again = ctf.read_ctf(scratch / "again.ds")
        err = float(np.abs(got.astype(np.float64) - want).max())
        # half a step, and the float32 rounding of the scaled counts
        limit = 0.5 * step + 2. ** -22 * float(np.abs(want).max())
        if not err <= limit:
            raise AssertionError(f"{study}: read back {err:.3e} from the "
                                 f"written data, past half a step and "
                                 f"the fp32 rounding, {limit:.3e}")
        if not np.array_equal(again.data, full.data):
            raise AssertionError(f"{study}: a second write and read changed "
                                 f"the reader's arrays")
        return f"within {err / step:.3f} of a quantization step, then " \
            "bit-equal after a second write and read"
    if not np.array_equal(got, want):
        raise AssertionError(f"{study}: the MATLAB arrays read back differ")
    return "bit-equal"


def prepare_study(device: torch.device, card_name: str, selection: str,
                  study: str, write_tree, sensors: int, root: Path) -> tuple:
    """A study's tree written into `root`, its first two recordings
    listed, the first one's raw read back against what was written and
    preprocessed on `device` against the CPU, and their words against the
    words written. Returns (read s, preprocess s)."""
    from brainmagick_tpu_torch.config import MainConfig
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.studies import api

    t0 = time.perf_counter()
    written = write_tree(root, np.random.RandomState(SEED + 9))
    write_s = time.perf_counter() - t0
    with env.temporary(studies={study: root}, cache=None):
        recs = list(api.from_selection(MainConfig().selections[selection]))
        if len(recs) < 2:
            raise AssertionError(f"{selection}: {len(recs)} recordings")
        recs = recs[:2]
        t0 = time.perf_counter()
        raw = recs[0].raw()
        read_s = time.perf_counter() - t0
        if raw.n_channels != sensors:
            raise AssertionError(f"{selection}: {raw.n_channels} sensors, "
                                 f"want {sensors}")
        reread = check_reread(study, raw, written, root)
        words = [w for rec in recs for w in rec.events()[
            rec.events().kind_mask("word")]["word"].tolist()]
        if words != written["words"]:
            raise AssertionError(f"{selection}: the events hold "
                                 f"{len(words)} words, {len(written['words'])}"
                                 f" were written (or not the same)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = api.preprocess_raw(raw, 120, device=device)
    preprocess_s = time.perf_counter() - t0
    on_cpu = api.preprocess_raw(raw, 120, device="cpu")
    err = float(np.abs(on_card.data - on_cpu.data).max()
                / np.abs(on_cpu.data).max())
    if not err <= PREPROCESS_TOL:
        raise AssertionError(f"{selection}: preprocessed raw, card "
                             f"against CPU {err:.2e}")
    print(f"study {selection} ({study}): tree written in {write_s:.1f} s; "
          f"{sensors} sensors at {written['sample_rate']:g} Hz read in "
          f"{read_s:.3f} s ({reread}); {len(words)} words in the events as "
          f"written; preprocessed to 120 Hz on {device} in "
          f"{preprocess_s:.3f} s, max |card - CPU| / max |x| = {err:.2e} "
          f"({card_name})")
    return read_s, preprocess_s


def run_study(device: torch.device, card_name: str, selection: str,
              study: str, write_tree, sensors: int, tmp: Path) -> tuple:
    """One study: ``prepare_study``, then ``train.main`` for one epoch of
    STUDY_ARGS on its tree. Returns (the kernels' launch counts, the
    shapes the run gave them, the train + valid epoch's seconds). The
    tree of KEPT_STUDY stays in `tmp` for phase 10; the others are
    removed."""
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.train import parse_overrides

    root = tmp / study
    read_s, preprocess_s = prepare_study(device, card_name, selection,
                                         study, write_tree, sensors, root)
    with env.temporary(studies={study: root}):
        argv = [*STUDY_ARGS, f"dset.selections=[{selection!r}]",
                f"cache={tmp}/cache_{study}", f"out_dir={tmp}/outputs"]
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, f"study {selection}", card_name)
    solver = spy.solver
    sizes = {name: len(getattr(solver.datasets, name))
             for name in ("train", "valid", "test")}
    n_train_batches = len(solver.loaders["train"])
    if n_train_batches < 2:
        raise AssertionError(f"{selection}: the train split holds "
                             f"{sizes['train']} segments, fewer than two "
                             f"batches")
    _check_cli_launches(f"study {selection}", launches, routes, by_dtype,
                        spy, "bfloat16")
    history = _read_history(Path(parse_overrides(argv).xp_folder), 1,
                            f"study {selection}")
    step_ms = spy.train_step_ms()
    tracks_s = sum(d.track_seconds for split in solver.datasets
                   for d in split.datasets)
    epoch_s = sum(v for k, v in solver.stage_seconds[0].items()
                  if k != "test")
    print(f"study {selection} timings ({card_name}): read {read_s:.3f} s, "
          f"preprocess {preprocess_s:.3f} s (one recording), dataset build "
          f"{solver.build_timings['datasets']:.2f} s (2 recordings, "
          f"preprocessed on the card), track {tracks_s:.2f} s, scaler fit "
          f"{solver.build_timings['scaler']:.2f} s, train step median "
          f"{statistics.median(step_ms):.2f} ms over {len(step_ms)} steps "
          f"(device time), epoch (train + valid) {epoch_s:.2f} s, test "
          f"stage {solver.stage_seconds[0].get('test', 0.):.2f} s, peak "
          f"device memory {peak_gb:.2f} GB, run {wall:.1f} s; splits "
          f"{sizes}; history {history}")
    shape = dict(batch=solver.args.optim.batch_size, n_test=sizes["test"],
                 n_mels=solver.used_features["MelSpectrum"].n_mels,
                 channels=solver.datasets.train[0].meg.shape[0])
    del solver, spy
    torch.cuda.empty_cache()
    if study != KEPT_STUDY:
        shutil.rmtree(root)
    return launches, shape, epoch_s


def run_study_phase(device: torch.device, card_name: str, tmp: Path
                    ) -> tuple:
    """Phase 9: each study of STUDY_TREES in turn, in `tmp`. Returns
    ({"study_<name>": launch counts}, {name: the shapes of its run},
    {name: its train + valid epoch's seconds})."""
    launches, shapes, epochs = {}, {}, {}
    for selection, study, write_tree, sensors in STUDY_TREES:
        (launches[f"study_{selection}"], shapes[selection],
         epochs[selection]) = run_study(device, card_name, selection, study,
                                        write_tree, sensors, tmp)
    return launches, shapes, epochs


#: phase 10: Table 2's "MelSpectrum + DeepMel" cell on phase 9's
#: gwilliams2022 tree (KEPT_STUDY; KIT, 208 sensors): the paper recipe with
#: fused_conv_bn and DeepMel at its published 320 x 10 -> 768, B=256, one
#: epoch; then that XP and phase 8's clip_conv_tpu XP evaluated by
#: signature
KEPT_STUDY = "gwilliams2022"
DEEPMEL_ARGS = ("preset=clip_conv", "preset=deep_mel",
                "simpleconv.fused_conv_bn=True",
                'dset.features=["MelSpectrum"]', "optim.batch_size=256",
                "optim.epochs=1", "dset.n_recordings=2",
                f"dset.selections=[{KEPT_STUDY!r}]")
#: DeepMel's published widths: (in, hidden, layers, out); the paper
#: encoder's (hidden, depth)
DEEPMEL_WIDTHS = (120, 320, 10, 768)
PAPER_ENCODER = (320, 10)
#: what an evaluation by signature writes into eval/<sig>-torch
EVAL_FILES = ("solver_config.yaml", "probs_segment.npy", "vocab_segment.npy",
              "metadata.csv", "acc.csv", "negative_stats.csv")
#: the card's evaluation by signature against the CPU's, on the first
#: HELD_PREDS predictions' probabilities (max |diff|): each package's
#: forward of the XP (fp32, TF32 off on the card) agrees to REFERENCE_TOL,
#: and a softmax row moves by no more than its scores do
EVAL_SIG_TOL = 1e-4


def eval_by_sig(xp: dict, what: str, card_name: str,
                studies: tp.Optional[dict] = None,
                extra: tp.Sequence[str] = (),
                kernel_scoring: bool = True) -> dict:
    """``eval.main(["sig=...", "out_dir=...", *extra])`` in this process, with
    every launch count set to 0 just before it and the XP's cache (and
    `studies`) in the env: the six files in ``eval/<sig>-torch`` and none
    in the JAX package's ``eval/<sig>``, finite probability rows, top-1,
    5 and 10 in [0, 1], normalize once a forward, nt_matmul as often as
    build_probs' loop implies and inv_norms once a candidate block (both
    never without `kernel_scoring`: a scorer
    that transforms its operands, such as clip.linear's projection,
    scores through ``ClipLoss.get_scores``) and conv_stats never. Returns
    the launch counts, the top-1, 5 and 10 accuracies, the probabilities
    and vocabulary, run_eval's seconds and the call's peak device memory,
    and the dtypes nt_matmul scored in."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import losses, ops
    from brainmagick_tpu_torch.env import env

    run_eval, nt_matmul = port_eval.run_eval, losses.nt_matmul
    seconds, dtypes = {}, set()

    def timed_run_eval(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_eval(*args, **kwargs)
        torch.cuda.synchronize()
        seconds["run_eval"] = time.perf_counter() - t0
        return out

    def seen_nt_matmul(a, b):
        dtypes.add(b.dtype)
        return nt_matmul(a, b)

    port_eval.run_eval, losses.nt_matmul = timed_run_eval, seen_nt_matmul
    try:
        with env.temporary(cache=xp["cache"], **(
                {"studies": studies} if studies else {})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with SolverSpy() as spy:
                t0 = time.perf_counter()
                acc = port_eval.main([f"sig={xp['sig']}",
                                      f"out_dir={xp['out_dir']}", *extra])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        port_eval.run_eval, losses.nt_matmul = run_eval, nt_matmul
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    folder = Path(xp["out_dir"]) / "eval" / f"{xp['sig']}-torch"
    missing = [name for name in EVAL_FILES if not (folder / name).exists()]
    if missing or (Path(xp["out_dir"]) / "eval" / xp["sig"]).exists():
        raise AssertionError(f"eval {what}: {missing} missing from {folder}"
                             f", or the JAX package's eval/<sig> written")
    vocab = np.load(folder / "vocab_segment.npy")
    probs = np.load(folder / "probs_segment.npy")
    _check_eval_probs(probs, (probs.shape[0], len(vocab)), f"eval {what}")
    if sorted(acc) != [1, 5, 10] or not all(0 <= v <= 1
                                            for v in acc.values()):
        raise AssertionError(f"eval {what}: accuracies {acc}")
    want = dict(normalize_clamp_peak=spy.forwards, conv_stats=0,
                nt_matmul=scoring_calls(*probs.shape) if kernel_scoring
                else 0,
                inv_norms=norm_calls(probs.shape[1]) if kernel_scoring
                else 0)
    if spy.forwards < 1 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"eval {what} launched {launches}, want {want}")
    print(f"eval by signature, {what}: top-1/5/10 {acc}; "
          f"{probs.shape[0]} predictions x {probs.shape[1]} candidates, "
          f"scored in {sorted(map(str, dtypes))}; run_eval "
          f"{seconds['run_eval']:.2f} s, the whole call {wall:.2f} s (the "
          f"solver's datasets and checkpoint included), peak device memory "
          f"{peak_gb:.2f} GB ({card_name}); kernel launches {launches}")
    return dict(launches=launches, acc=acc, probs=probs, vocab=vocab,
                seconds=seconds["run_eval"], peak_gb=peak_gb, dtypes=dtypes)


def run_deepmel_phase(device: torch.device, card_name: str, work: Path,
                      recipe_xp: dict) -> tuple:
    """Phase 10: the DeepMel cell trained by ``train.main`` on the kept
    gwilliams2022 tree in `work`, evaluated by signature on the card and,
    on its first HELD_PREDS predictions, on the CPU; then phase 8's
    clip_conv_tpu XP (`recipe_xp`) evaluated by signature. Returns
    ({path: launch counts}, {path: ``check_cli_shapes`` arguments})."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import play
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.train import parse_overrides

    studies = {KEPT_STUDY: work / KEPT_STUDY}
    argv = [*DEEPMEL_ARGS, f"cache={work}/cache_{KEPT_STUDY}",
            f"out_dir={work}/outputs"]
    args = parse_overrides(argv)
    with env.temporary(studies=studies):
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, "deep_mel", card_name)
    solver = spy.solver
    fm = solver.feature_model
    widths = (fm.n_in_channels, fm.n_hidden_channels, fm.n_hidden_layers,
              fm.n_out_channels)
    paper = (args.simpleconv["hidden"], args.simpleconv["depth"],
             solver.model.out_channels)
    if widths != DEEPMEL_WIDTHS \
            or paper != (*PAPER_ENCODER, DEEPMEL_WIDTHS[3]):
        raise AssertionError(f"deep_mel: DeepMel {widths}, SimpleConv "
                             f"(hidden, depth, out) {paper}")
    # conv_stats 10 times a step: the SimpleConv's fused layers, none
    # inside DeepMel (its convs are cuDNN's)
    steps = _check_cli_launches("deep_mel", launches, routes, by_dtype, spy,
                                "float32")
    history = _read_history(Path(args.xp_folder), 1, "deep_mel")
    step_ms = spy.train_step_ms()
    epoch_s = sum(v for k, v in solver.stage_seconds[0].items()
                  if k != "test")
    n_test = len(solver.datasets.test)
    print(f"deep_mel cell timings ({card_name}): train step median "
          f"{statistics.median(step_ms):.2f} ms over {steps} steps (device "
          f"time; each {[round(x, 2) for x in step_ms]}), epoch (train + "
          f"valid) "
          f"{epoch_s:.2f} s, test stage "
          f"{solver.stage_seconds[0].get('test', 0.):.2f} s, dataset build "
          f"{solver.build_timings['datasets']:.2f} s, peak device memory "
          f"{peak_gb:.2f} GB, run {wall:.1f} s; history {history}")
    out = {"deepmel_train": launches}
    shapes = {"deepmel_train": dict(batch=args.optim.batch_size,
                                    n_test=n_test, n_mels=DEEPMEL_WIDTHS[3],
                                    channels=208)}
    del solver, spy, fm
    torch.cuda.empty_cache()

    xp = dict(sig=args.sig, out_dir=args.out_dir, cache=args.cache)
    card = eval_by_sig(xp, "deep_mel", card_name, studies)
    out["eval_sig"] = card["launches"]
    shapes["eval_sig"] = dict(
        batch=args.optim.batch_size, n_test=card["probs"].shape[0],
        n_cand=card["probs"].shape[1], n_mels=DEEPMEL_WIDTHS[3],
        channels=208, with_conv=False)
    t0 = time.perf_counter()
    with env.temporary(cache=xp["cache"], studies=studies):
        cpu = play.get_solver_from_sig(xp["sig"], out_dir=xp["out_dir"],
                                       override_args={"device": "cpu"})
        data = port_eval.load_test_data(cpu)
        probs = port_eval.build_probs(cpu, data["preds"][:HELD_PREDS],
                                      data["trues"])
    if not np.array_equal(data["trues_segment_hashes"], card["vocab"]):
        raise AssertionError("deep_mel: the CPU's candidates are not the "
                             "card's")
    err = float(np.abs(probs - card["probs"][:HELD_PREDS]).max())
    print(f"eval by signature, deep_mel, {HELD_PREDS} predictions x "
          f"{probs.shape[1]} candidates against the CPU: max|diff| "
          f"{err:.3e} (atol {EVAL_SIG_TOL}); the CPU's pass "
          f"{time.perf_counter() - t0:.1f} s")
    if not err <= EVAL_SIG_TOL:
        raise AssertionError(f"eval by signature, card vs CPU: {err}")
    del cpu, data

    recipe = eval_by_sig(recipe_xp, RECIPE, card_name)
    if recipe["dtypes"] != {torch.bfloat16}:
        raise AssertionError(f"eval {RECIPE} scored in {recipe['dtypes']}")
    out["eval_sig_recipe"] = recipe["launches"]
    shapes["eval_sig_recipe"] = dict(
        batch=parse_overrides([f"preset={RECIPE}", *CLI_ARGS[1:]]
                              ).optim.batch_size,
        n_test=recipe["probs"].shape[0], n_cand=recipe["probs"].shape[1],
        n_mels=parse_overrides(list(CLI_ARGS)).dset.features_params[
            "MelSpectrum"]["n_mels"], with_conv=False)
    torch.cuda.empty_cache()
    return out, shapes


#: phase 11: feature decoding on phase 9's gwilliams2022 tree (KEPT_STUDY):
#: the paper encoder with fused_conv_bn, B=256, one epoch, regressing the
#: word vectors and the pitch and classifying the part of speech and the
#: word segments with class weights; the card's machine has no spacy
#: model, so the word features run on their offline stand-ins, which a
#: real study takes only with allow_fallback
WORDS_FEATURES = ("WordEmbedding", "PartOfSpeech", "Pitch", "WordSegment")
WORDS_ARGS = ("preset=clip_conv", "simpleconv.fused_conv_bn=True",
              "optim.loss=regression_classification",
              "optim.use_weighting=True",
              f"dset.features={list(WORDS_FEATURES)!r}",
              "optim.batch_size=256", "optim.epochs=1", "dset.n_recordings=2",
              f"dset.selections=[{KEPT_STUDY!r}]")
WORDS_FALLBACK = ("dset.features_params=" + repr({
    name: {"allow_fallback": True}
    for name in ("WordEmbedding", "PartOfSpeech")}),)
#: the model's outputs: 300 word-vector channels, 21 part-of-speech
#: logits, the pitch, 2 word-segment logits
WORDS_OUTPUTS = 324


def words_held_step(where, args, solver, batch) -> tuple:
    """One Trainer.step of phase 11's configuration on `where`, from seeds
    (the weights, the dropout generator) and the solver's normalization
    arrays, features and scaler: (loss, model)."""
    from brainmagick_tpu_torch.train import Trainer

    model = solver.model
    trainer = Trainer(
        args, model.in_channels["meg"], model.out_channels,
        model.subject_layers.weights.shape[0], None, None,
        {k: v.cpu() for k, v in solver.norm_arrays.items()}, where,
        generator=torch.Generator().manual_seed(SEED),
        used_features=solver.used_features, scaler=solver.scaler)
    return trainer.step(batch)["loss"].item(), trainer.model


def run_words_phase(device: torch.device, card_name: str, work: Path
                    ) -> tuple:
    """Phase 11: ``train.main`` of WORDS_ARGS on the kept gwilliams2022
    tree in `work`, first without WORDS_FALLBACK (MissingModelError before
    any step), then with it for one epoch; a B=HELD_B step held against
    the CPU. Returns ({"regression_words": launch counts},
    {"regression_words": ``check_cli_shapes`` arguments})."""
    from brainmagick_tpu_torch import dataset
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.features import FeaturesBuilder
    from brainmagick_tpu_torch.features.embeddings import MissingModelError
    from brainmagick_tpu_torch.train import main, parse_overrides

    studies = {KEPT_STUDY: work / KEPT_STUDY}
    common = [*WORDS_ARGS, f"cache={work}/cache_{KEPT_STUDY}",
              f"out_dir={work}/outputs"]
    with env.temporary(studies=studies):
        with SolverSpy() as spy:
            try:
                main(list(common))
            except MissingModelError as error:
                refused = str(error)
            else:
                raise AssertionError("a real study trained on the word "
                                     "features' stand-ins without "
                                     "allow_fallback")
        if spy.events or spy.forwards:
            raise AssertionError(f"MissingModelError after {len(spy.events)}"
                                 f" steps and {spy.forwards} forwards")
        print(f"words without allow_fallback: MissingModelError before any "
              f"step ({refused.split('.')[0]})")
        argv = common + list(WORDS_FALLBACK)
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, "regression_words", card_name)
    args = parse_overrides(argv)
    solver = spy.solver
    widths = (args.simpleconv["hidden"], args.simpleconv["depth"],
              solver.model.in_channels["meg"], solver.model.out_channels,
              solver.used_features.dimension)
    if list(solver.used_features) != list(WORDS_FEATURES) \
            or widths != (*PAPER_ENCODER, 208, WORDS_OUTPUTS, 303):
        raise AssertionError(f"words: features {list(solver.used_features)}"
                             f", (hidden, depth, sensors, outputs, "
                             f"targets) {widths}")
    steps = _check_cli_launches("regression_words", launches, routes,
                                by_dtype, spy, "float32", scored=False)
    history = _read_history(Path(args.xp_folder), 1, "regression_words")
    test = history[0].get("test", {})
    accuracies = [test.get(f"acc_{name}", -1.)
                  for name in ("PartOfSpeech", "WordSegment")]
    regressed = [test.get(f"{kind}_{name}", math.nan)
                 for name in ("WordEmbedding", "Pitch")
                 for kind in ("l2", "corr")]
    if not all(0 <= a <= 1 for a in accuracies) \
            or not np.isfinite(regressed).all():
        raise AssertionError(f"words test metrics {test}")
    step_ms = spy.train_step_ms()
    tracks_s = sum(d.track_seconds for split in solver.datasets
                   for d in split.datasets)
    first = solver.datasets.train.datasets[0]
    with env.temporary(cache=None):
        pitch = FeaturesBuilder(first.events, ["Pitch"], None,
                                first.sample_rate)
        t0 = time.perf_counter()
        pitch.render_track(first.raw.duration)
        pitch_s = time.perf_counter() - t0
    epoch_s = sum(v for k, v in solver.stage_seconds[0].items()
                  if k != "test")
    print(f"words cell timings ({card_name}): track render {tracks_s:.2f} s "
          f"for {sum(len(split.datasets) for split in solver.datasets)} "
          f"datasets ({list(WORDS_FEATURES)}, Pitch's YIN on the host; "
          f"Pitch alone over one {first.raw.duration:.0f} s recording, "
          f"uncached, {pitch_s:.2f} s), dataset build "
          f"{solver.build_timings['datasets']:.2f} s, scaler fit "
          f"{solver.build_timings['scaler']:.2f} s, train step median "
          f"{statistics.median(step_ms):.2f} ms over {steps} steps (device "
          f"time; each {[round(x, 2) for x in step_ms]}; after the first "
          f"{statistics.median(step_ms[1:] or step_ms):.2f}), epoch (train "
          f"+ valid, the valid tracks' render included) {epoch_s:.2f} s, "
          f"test stage (its tracks' render included) "
          f"{solver.stage_seconds[0].get('test', 0.):.2f} s, peak device "
          f"memory {peak_gb:.2f} GB, run {wall:.1f} s; history {history}")

    batches = iter(solver.make_loader(solver.datasets.train))
    batch, _ = next(batches)
    batches.close()
    small = types.SimpleNamespace(**{
        name: getattr(batch, name)[:HELD_B] for name in dataset.ARRAY_FIELDS})
    card, cpu = (words_held_step(where, args, solver, small)
                 for where in (device, "cpu"))
    errors, note = _step_errors(card, cpu, False)
    print(f"regression_words train B={HELD_B} against the CPU: " + ", ".join(
        f"{key} {value:.2e}" for key, value in errors.items())
        + f" (tol {STEP_TOL:.2e}; {note})")
    _check_errors(errors, STEP_TOL, "regression_words train step")
    shapes = {"regression_words": dict(
        batch=args.optim.batch_size, n_test=len(solver.datasets.test),
        n_mels=1, channels=208, with_matmul=False)}
    del solver, spy, card, cpu
    torch.cuda.empty_cache()
    return {"regression_words": launches}, shapes


#: phase 12: the encode task and ConvRNN on phase 9's gwilliams2022 tree
#: (KEPT_STUDY), each at its preset's published widths, B=256, one epoch.
#: The convrnn preset encodes MelSpectrum (120 mels) here, so that these
#: numbers stay comparable with earlier runs (phase 15 trains it on its
#: default Wav2VecTransformer); the rest of each preset is as published
ENCODE_COMMON = ("optim.batch_size=256", "optim.epochs=1",
                 "dset.n_recordings=2", f"dset.selections=[{KEPT_STUDY!r}]")
ENCODE_RUNS = {
    "encode_convrnn": ("preset=convrnn", 'dset.features=["MelSpectrum"]'),
    "decoder_convrnn": ("preset=decoder_convrnn",),
    "encode_simpleconv": ("preset=clip_conv", "task.type=encode",
                          "optim.loss=l1", "simpleconv.fused_conv_bn=True",
                          'dset.features=["MelSpectrum"]')}
#: each run's model: its class, inputs, hidden widths and outputs, and
#: ConvRNN's LSTM cells, their width and the subject embedding's
ENCODE_WIDTHS = {
    "encode_convrnn": ("ConvRNN", {"meg": 208, "features": 120},
                       {"meg": 512, "features": 12}, 208, 4, 524, 64),
    "decoder_convrnn": ("ConvRNN", {"meg": 208}, {"meg": 512}, 2, 8, 512,
                        64),
    "encode_simpleconv": ("SimpleConv", {"meg": 208, "features": 120},
                          {"meg": 320, "features": 320}, 208, None, None,
                          None)}
#: the B=HELD_B steps held against the CPU: (run, extra overrides, the
#: gradients compared, whether the gradients are held in float64). With
#: attention, ConvRNN's fp32 gradients at B=HELD_B are not a function of
#: the inputs to STEP_TOL on any device: the attention block's BatchNorm
#: divides channels whose means reach 67 times their spread, leaving the
#: estimate 2.6e-5 (relative) off in fp32, enough to flip ReLU units of
#: the decoder that sit at the edge of 0, and each flipped unit moves a
#: gradient by about 2e-2 of its largest entry (on the CPU, against
#: float64: 8 units of 771,328 apart, gradients 2.0e-2 off;
#: scripts/torch_convrnn_conditioning.py). Its loss is held in fp32, and
#: its gradients in float64 from the same fp32-wired inputs.
CONVRNN_LEAVES = ("subject_embedding.embedding.weight",
                  "encoders.meg.sequence.0.0.weight",
                  "encoders.features.sequence.1.0.weight",
                  "lstm.cells.0.input.i", "lstm.cells.0.hidden.f",
                  "lstm.cells.3.bias.g", "decoder.sequence.0.0.weight",
                  "decoder.sequence.1.0.bias")
ENCODE_HELD = (
    ("encode_convrnn", (), CONVRNN_LEAVES, False),
    ("encode_convrnn", ("convrnn.attention=1",
                        "convrnn.bidirectional_lstm=True",
                        "convrnn.flip_lstm=True"),
     CONVRNN_LEAVES + ("lstm.cells.7.hidden.o", "lstm.linear.weight",
                       "attentions.0.embedding", "attentions.0.query.weight",
                       "attentions.0.scale"), True),
    ("encode_simpleconv", (),
     ("merger.heads", "subject_layers.weights",
      "encoders.meg.sequence.0.0.weight",
      "encoders.features.sequence.0.0.weight",
      "encoders.features.sequence.9.1.weight",
      "encoders.features.glus.9.0.weight", "final.2.weight"), False))


def encode_held_step(where, args, solver, batch,
                     float64: bool = False) -> tuple:
    """One Trainer.step of `args` on `where`, from seeds (the weights, the
    dropout generator) and the solver's normalization arrays, features and
    scaler, at the solver's model widths: (loss, model). With `float64`,
    the step's forward wires the model's inputs, targets and weights in
    fp32 as the step does, then the model runs in float64 on them, with
    the loss and its backward (no update)."""
    from brainmagick_tpu_torch.dataset import to_device
    from brainmagick_tpu_torch.precision import exact_fp32
    from brainmagick_tpu_torch.train import Trainer

    model = solver.model
    n_subjects = 1 + max(d.recording.subject_index
                         for d in solver.datasets.train.datasets)
    trainer = Trainer(
        args, model.in_channels["meg"], model.out_channels, n_subjects,
        None, None, {k: v.cpu() for k, v in solver.norm_arrays.items()},
        where, generator=torch.Generator().manual_seed(SEED),
        used_features=solver.used_features, scaler=solver.scaler,
        features_channels=model.in_channels.get("features"))
    if not float64:
        return trainer.step(batch)["loss"].item(), trainer.model
    seen = {}
    hook = trainer.model.register_forward_pre_hook(
        lambda module, inputs: seen.update(inputs=inputs))
    weight = torch.ones(len(batch.meg), device=trainer.device)
    with torch.no_grad(), exact_fp32():
        _, output, mask, keep, _ = trainer.solver._forward(
            to_device(batch, trainer.device, None), weight, train=True)
    hook.remove()
    inputs, subjects = seen["inputs"][:2]
    model = trainer.model.double()
    estimate = model({k: v.double() for k, v in inputs.items()}, subjects)
    limit = trainer.solver._prompt_limit()
    loss = trainer.solver._loss_value(estimate[..., limit:], output.double(),
                                      mask, keep.double(), True)
    loss.backward()
    return loss.item(), model


def profile_step_split(solver, batch, calls: int = 3) -> dict:
    """A Solver.step of `solver`'s configuration on `batch`, resident on
    the card, in torch.profiler after a warm one: ms a step of kernel
    time in all, in the LSTM's forward (aten::_cudnn_rnn) and backward
    (aten::_cudnn_rnn_backward), in the convs (forward, transposed and
    backward), and the rest; and the longest kernels. The kernel times
    are summed over streams: cuDNN runs the LSTM's layers on streams of
    its own at once, so they add up to more than the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from brainmagick_tpu_torch.dataset import to_device

    arrays = to_device(batch, solver.device, None)
    pad = torch.ones(len(batch.meg), device=solver.device)
    solver.step(arrays, pad, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            solver.step(arrays, pad, True)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(device_us(e) for e in events
                if e.device_type != torch.autograd.DeviceType.CPU)

    def under(*names):
        return sum(device_us(e, own=False) for e in events
                   if e.key in names)
    split = dict(
        lstm_forward=under("aten::_cudnn_rnn"),
        lstm_backward=under("aten::_cudnn_rnn_backward"),
        convs=under("aten::cudnn_convolution",
                    "aten::cudnn_convolution_transpose",
                    "aten::convolution_backward"))
    split["other"] = total - sum(split.values())
    split = {k: v / calls / 1e3 for k, v in split.items()}
    split["total"] = total / calls / 1e3
    split["kernels"] = device_activities(prof, calls)[:6]
    return split


def run_encode_phase(device: torch.device, card_name: str, work: Path
                     ) -> tuple:
    """Phase 12: ``train.main`` of each ENCODE_RUNS entry on the kept
    gwilliams2022 tree in `work` at its preset's widths (ENCODE_WIDTHS),
    B=256, one epoch: finite losses, history-torch.json and
    done-torch.json, the test stage's corr_meg finite or acc_WordSegment
    in [0, 1]; normalize once a forward, conv_stats 20 times a train step
    (fp32 on "tc") for SimpleConv's two fused encoders and never for
    ConvRNN's, nt_matmul never (no CLIP scoring). Then the ENCODE_HELD
    steps against the CPU at STEP_TOL, and the convrnn step's profile.
    Returns ({path: launch counts}, {path: ``check_cli_shapes``
    arguments})."""
    from brainmagick_tpu_torch import dataset
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.train import parse_overrides

    studies = {KEPT_STUDY: work / KEPT_STUDY}
    common = [*ENCODE_COMMON, f"cache={work}/cache_{KEPT_STUDY}",
              f"out_dir={work}/outputs"]
    launches_by_path, solvers, argvs = {}, {}, {}
    for path, overrides in ENCODE_RUNS.items():
        t0 = time.perf_counter()
        argv = [*overrides, *common]
        with env.temporary(studies=studies):
            launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
                argv, path, card_name)
        args = parse_overrides(argv)
        solver = spy.solver
        model = solver.model
        name, inputs, hidden, outputs, cells, width, emb = ENCODE_WIDTHS[
            path]
        lstm = getattr(model, "lstm", None)
        got = (type(model).__name__, model.in_channels, model.hidden,
               model.out_channels, lstm and len(lstm.cells),
               lstm and lstm.hidden_size,
               getattr(model, "subject_embedding", None)
               and model.subject_embedding.embedding.embedding_dim)
        if got != ENCODE_WIDTHS[path]:
            raise AssertionError(f"{path}: model {got}, want "
                                 f"{ENCODE_WIDTHS[path]}")
        fused = 0
        if name == "SimpleConv":
            fused = sum(sum(e.fused) for e in model.encoders.values())
            if fused != 20:
                raise AssertionError(f"{path}: {fused} fused layers")
        steps = _check_cli_launches(path, launches, routes, by_dtype, spy,
                                    "float32", scored=False, fused=fused)
        history = _read_history(Path(args.xp_folder), 1, path)
        test = history[0].get("test", {})
        if path == "decoder_convrnn":
            ok = set(test) == {"acc_WordSegment"} \
                and 0 <= test["acc_WordSegment"] <= 1
        else:
            ok = set(test) == {"corr_meg"} and np.isfinite(test["corr_meg"])
        if not ok:
            raise AssertionError(f"{path} test metrics {test}")
        step_ms = spy.train_step_ms()
        tracks_s = sum(d.track_seconds for split in solver.datasets
                       for d in split.datasets)
        print(f"{path} ({card_name}): train step device time "
              f"{[round(x, 2) for x in step_ms]} ms over {steps} steps "
              f"(warm {step_ms[-1]:.2f}), peak device memory "
              f"{peak_gb:.2f} GB, track render {tracks_s:.2f} s, scaler "
              f"{solver.build_timings['scaler']:.2f} s, dataset build "
              f"{solver.build_timings['datasets']:.2f} s, run {wall:.1f} s, "
              f"phase {time.perf_counter() - t0:.1f} s; history {history}")
        launches_by_path[path] = launches
        solvers[path], argvs[path] = solver, argv
        del spy

    t0 = time.perf_counter()
    batches = {}
    for path, extra, leaves, float64 in ENCODE_HELD:
        solver = solvers[path]
        if path not in batches:
            loader = iter(solver.make_loader(solver.datasets.train))
            batches[path] = next(loader)[0]
            loader.close()
        small = types.SimpleNamespace(**{
            name: getattr(batches[path], name)[:HELD_B]
            for name in dataset.ARRAY_FIELDS})
        args = parse_overrides(argvs[path] + list(extra))
        what = " ".join((path,) + extra)
        card, cpu = (encode_held_step(where, args, solver, small)
                     for where in (device, "cpu"))
        errors, note = _step_errors(card, cpu, False, leaves)
        print(f"{what} train B={HELD_B} against the CPU: " + ", ".join(
            f"{key} {value:.2e}" for key, value in errors.items())
            + f" (tol {STEP_TOL:.2e}" + ("; the loss held, the gradients "
                                          "shown" if float64 else "")
            + f"; {note})")
        if float64:
            _check_errors({"loss": errors["loss"]}, STEP_TOL,
                          f"{what} train step")
            card, cpu = (encode_held_step(where, args, solver, small, True)
                         for where in (device, "cpu"))
            errors, note = _step_errors(card, cpu, False, leaves)
            print(f"{what} B={HELD_B} in float64 against the CPU: "
                  + ", ".join(f"{key} {value:.2e}"
                              for key, value in errors.items())
                  + f" (tol {STEP_TOL:.2e}; {note})")
        _check_errors(errors, STEP_TOL, f"{what} train step")
        del card, cpu
    print(f"encode held steps: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    solver = solvers["encode_convrnn"]
    split = profile_step_split(solver, batches["encode_convrnn"])
    print(f"encode_convrnn train step B={len(batches['encode_convrnn'].meg)}"
          f" in torch.profiler ({card_name}): "
          f"{split['total']:.2f} ms of kernel time summed over streams "
          f"(cuDNN runs the LSTM's layers at once), LSTM forward "
          f"{split['lstm_forward']:.2f}, LSTM backward "
          f"{split['lstm_backward']:.2f}, convs {split['convs']:.2f}, other "
          f"{split['other']:.2f}; longest kernels (name, launches, µs a "
          f"step) {split['kernels']} ({time.perf_counter() - t0:.1f} s)")
    if not split["lstm_forward"] > 0 < split["lstm_backward"]:
        raise AssertionError(f"no cuDNN LSTM in the profile: {split}")
    shapes = {
        "encode_convrnn": dict(batch=256, n_test=0, n_mels=1, channels=208,
                               with_conv=False, with_matmul=False),
        "encode_simpleconv": dict(
            batch=256, n_test=0, n_mels=1, channels=208, with_matmul=False,
            convs=((256, 120, 320, T - 18, 1, 3),))}
    del solvers, solver
    torch.cuda.empty_cache()
    return launches_by_path, shapes


#: phase 13: the paper's grid chain through the port's CLI layer, on phase
#: 9's gwilliams2022 tree (KEPT_STUDY), in the folder phases 8-12 share: the
#: port's rehearsal grid (clip_conv_tpu at the paper's width: depth 10,
#: hidden 320, merger pos_dim 2048, B=16), configured through its own hooks
#: (BM_REHEARSAL_CACHE, BM_REHEARSAL_EXTRA): MelSpectrum targets (kept so
#: that its numbers stay comparable; phase 15 runs the grid on its wav2vec
#: 2.0 targets) at Table 2's 120 mels, the tree's two recordings, one
#: epoch of GRID_BATCHES batches, and
#: fused_conv_bn (conv_stats on the train step); a second variant keeps 128
#: of the 208 sensors (nmi.fair_compare_meg_eeg's option)
GRID = "rehearsal"
GRID_BATCHES = 3
GRID_EXTRA = {
    "dset.features": ["MelSpectrum"],
    "dset.features_params": {"MelSpectrum": dict(
        n_fft=512, n_mels=120, normalized=True, use_log_scale=True,
        log_scale_eps=1e-5)},
    "dset.n_recordings": 2, "optim.epochs": 1,
    "optim.max_batches": GRID_BATCHES, "simpleconv.fused_conv_bn": True}
GRID_SUBSAMPLE = {"simpleconv.subsample_meg_channels": 128}
#: the grid's model at the paper's width, in the clip_conv_tpu recipe
GRID_MODEL = dict(hidden=320, depth=10, merger_pos_dim=2048,
                  dtype="bfloat16", fused_head=True, fused_conv_bn=True)
#: warm steps timed on the subsampled XP, restored by signature
GRID_STEPS = 3


def _grid_cli(argv: list) -> str:
    """``grids.runner.main(argv)`` in this process; returns what it
    printed (also printed here, a failure's output too)."""
    import contextlib
    import io

    from brainmagick_tpu_torch.grids import runner

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runner.main(argv)
    finally:
        print(buf.getvalue(), end="")
    return buf.getvalue()


def _log_tail(path: Path, lines: int = 40) -> str:
    return "\n".join(path.read_text().splitlines()[-lines:]) \
        if path.exists() else f"(no {path})"


def run_grid_phase(device: torch.device, card_name: str, work: Path
                   ) -> tuple:
    """Phase 13: the rehearsal grid's chain on the kept gwilliams2022 tree
    in `work`: the GRID_EXTRA XP trained by ``runner.run_jobs`` in this
    process (conv_stats 10 times a train step, bf16 on "tc", normalize
    once a forward, nt_matmul in the test stage; no solver alive after
    it); the GRID_SUBSAMPLE variant by ``--run --workers=2``
    (a subprocess, the kernel library built here first); a second
    ``--run`` of each that skips it on done-torch.json; ``--table`` and
    ``--sbatch --force`` (text only, nothing submitted); ``eval
    grid=rehearsal`` of the first in this process (normalize once a
    forward, nt_matmul as build_probs' loop implies, conv_stats never) and
    of the second with workers=2, each into eval/<sig>-torch; ``paper_tables
    table`` of each, accuracy in [0, 1]; GRID_STEPS warm train steps of the
    second XP, restored by signature (its 128-sensor mask on the card).
    Returns ({path: launch counts}, {path: ``check_cli_shapes``
    arguments})."""
    import csv
    import gc
    import os
    import weakref

    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import ops, paper_tables, play
    from brainmagick_tpu_torch.dataset import to_device
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.grids import runner

    t_phase = time.perf_counter()
    cache = work / f"cache_{KEPT_STUDY}"
    out_dir = str(work / "grid_outputs")
    variants = {"base": GRID_EXTRA, "subsample": {**GRID_EXTRA,
                                                  **GRID_SUBSAMPLE}}
    hooks = ("BM_REHEARSAL_CACHE", "BM_REHEARSAL_EXTRA")
    saved = {key: os.environ.get(key) for key in hooks}
    os.environ["BM_REHEARSAL_CACHE"] = str(cache)

    def grid_job(variant: str):
        os.environ["BM_REHEARSAL_EXTRA"] = json.dumps(variants[variant])
        _, jobs = runner.get_grid(GRID)
        if len(jobs) != 1:
            raise AssertionError(f"grid {GRID}: {len(jobs)} jobs, want 1")
        return jobs[0]

    def counts() -> tuple:
        return ({k.__name__: k.launches for k in ops.KERNELS},
                dict(ops.conv_stats.launches_by_route),
                dict(ops.conv_stats.launches_by_dtype))

    launches_by_path: dict = {}
    try:
        jobs = {name: grid_job(name) for name in variants}
        cfg = jobs["base"].to_config()
        paper = {k: cfg.simpleconv[k] for k in GRID_MODEL}
        if paper != GRID_MODEL or jobs["subsample"].to_config().simpleconv[
                    "subsample_meg_channels"] != 128:
            raise AssertionError(f"grid {GRID}: model {paper}")
        sigs = {name: job.sig for name, job in jobs.items()}
        print(f"grid {GRID}: XPs {sigs}, cache {cache}, out_dir {out_dir}")

        # 1. the first variant in this process
        grid_job("base")
        with env.temporary(studies={KEPT_STUDY: work / KEPT_STUDY}):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            flags = tf32_flags()
            with SolverSpy() as spy:
                t0 = time.perf_counter()
                results = runner.run_jobs([jobs["base"]], out_dir, workers=1)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            launches, routes, by_dtype = counts()
        if results != {sigs["base"]: 0} or tf32_flags() != flags:
            raise AssertionError(f"grid in-process run: {results}, TF32 "
                                 f"flags {tf32_flags()} after {flags}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # one fused conv_stats layer a block of the encoder
        fused = sum(sum(e.fused) for e in spy.solver.model.encoders.values())
        if fused != GRID_MODEL["depth"]:
            raise AssertionError(f"grid base: {fused} fused layers")
        steps = _check_cli_launches("grid base", launches, routes, by_dtype,
                                    spy, "bfloat16", fused=fused)
        step_ms = spy.train_step_ms()
        history = _read_history(Path(out_dir) / "xps" / sigs["base"], 1,
                                "grid base")
        build = dict(spy.solver.build_timings)
        solver_ref = weakref.ref(spy.solver)
        spy.solver = None
        del spy
        gc.collect()
        torch.cuda.empty_cache()
        kept_gb = (torch.cuda.memory_allocated() - before) / 1e9
        print(f"grid base, in process ({card_name}): {steps} train steps, "
              f"device time {[round(x, 2) for x in step_ms]} ms (warm "
              f"{step_ms[-1]:.2f}), peak device memory {peak_gb:.2f} GB, "
              f"{kept_gb:.3f} GB still allocated after it, dataset build "
              f"{build['datasets']:.2f} s, scaler {build['scaler']:.2f} s, "
              f"run_jobs {train_s:.1f} s; kernel launches {launches}; "
              f"history {history}")
        # nothing keeps the XP's solver alive, and what stays allocated
        # is the libraries' (cuBLAS workspaces: 0.07 GB in a fresh
        # process), not the XP's
        if solver_ref() is not None or kept_gb > 0.25 * peak_gb:
            raise AssertionError(f"the in-process XP kept {kept_gb:.3f} GB "
                                 f"of the card's memory, its solver "
                                 f"{solver_ref()}")
        launches_by_path["grid_train"] = launches

        # 2. the second variant in a subprocess
        grid_job("subsample")
        t0 = time.perf_counter()
        with env.temporary(studies={KEPT_STUDY: work / KEPT_STUDY}):
            try:
                _grid_cli([GRID, "--run", "--workers=2",
                           f"--out_dir={out_dir}"])
            except SystemExit:
                print(_log_tail(Path(out_dir) / "logs"
                                / f"{sigs['subsample']}.log"))
                raise
        sub_s = time.perf_counter() - t0
        history = _read_history(Path(out_dir) / "xps" / sigs["subsample"],
                                1, "grid subsample")
        print(f"grid subsample, --run --workers=2 ({card_name}): "
              f"{sub_s:.1f} s (the subprocess's start, set-up and run); "
              f"history {history}; log tail:\n"
              + _log_tail(Path(out_dir) / "logs"
                          / f"{sigs['subsample']}.log", 3))

        # 3-4. --run skips both, --table, --sbatch
        for name in variants:
            grid_job(name)
            text = _grid_cli([GRID, "--run", "--workers=2",
                              f"--out_dir={out_dir}"])
            if f"skipping {sigs[name]}" not in text:
                raise AssertionError(f"--run did not skip {name}")
            table = _grid_cli([GRID, "--table",
                               f"--out_dir={out_dir}"]).splitlines()
            row = dict(zip(table[0].split(), table[1].split()))
            if row.get("sig") != sigs[name] or row.get("epoch") != "1" \
                    or row.get("wer_vocab", "-") == "-":
                raise AssertionError(f"--table of {name}: {row}")
        _grid_cli([GRID, "--sbatch", "--force", f"--out_dir={out_dir}"])
        script = (Path(out_dir) / f"grid_{GRID}.sbatch").read_text()
        if script.count(";;") != 2 \
                or "-m brainmagick_tpu_torch.train" not in script:
            raise AssertionError(f"the sbatch script:\n{script}")

        # 5. the grid's evaluation, in this process and in a subprocess
        with env.temporary(cache=cache,
                           studies={KEPT_STUDY: work / KEPT_STUDY}):
            grid_job("base")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with SolverSpy() as spy:
                t0 = time.perf_counter()
                accs = port_eval.main([f"grid={GRID}", f"out_dir={out_dir}"])
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
            launches, _, _ = counts()
            eval_gb = torch.cuda.max_memory_allocated() / 1e9
            forwards = spy.forwards
            del spy
            grid_job("subsample")
            t0 = time.perf_counter()
            try:
                codes = port_eval.main([f"grid={GRID}", f"out_dir={out_dir}",
                                        "workers=2"])
            except SystemExit:
                print(_log_tail(Path(out_dir) / "eval" / "logs"
                                / f"{sigs['subsample']}.log"))
                raise
            eval_sub_s = time.perf_counter() - t0
        if list(accs) != [sigs["base"]] or codes != {sigs["subsample"]: 0}:
            raise AssertionError(f"eval grid=: {accs}, {codes}")
        probs = {}
        for name, sig in sigs.items():
            folder = Path(out_dir) / "eval" / f"{sig}-torch"
            missing = [f for f in EVAL_FILES if not (folder / f).exists()]
            if missing or (Path(out_dir) / "eval" / sig).exists():
                raise AssertionError(f"eval {name}: {missing} missing from "
                                     f"{folder}, or eval/<sig> written")
            probs[name] = np.load(folder / "probs_segment.npy")
            vocab = np.load(folder / "vocab_segment.npy")
            _check_eval_probs(probs[name], (len(probs[name]), len(vocab)),
                              f"eval grid {name}")
        acc = accs[sigs["base"]]
        want = dict(normalize_clamp_peak=forwards, conv_stats=0,
                    nt_matmul=scoring_calls(*probs["base"].shape),
                    inv_norms=norm_calls(probs["base"].shape[1]))
        if forwards < 1 or any(launches[k] != v for k, v in want.items()) \
                or not all(0 <= v <= 1 for v in acc.values()):
            raise AssertionError(f"eval grid base: launches {launches}, "
                                 f"want {want}; accuracies {acc}")
        print(f"eval grid={GRID} ({card_name}): base in process "
              f"{eval_s:.2f} s (the solver's datasets and checkpoint "
              f"included), top-1/5/10 {acc}, {probs['base'].shape[0]} "
              f"predictions x {probs['base'].shape[1]} candidates, peak "
              f"device memory {eval_gb:.2f} GB, kernel launches {launches}; "
              f"subsample with workers=2 {eval_sub_s:.1f} s")
        launches_by_path["grid_eval"] = launches

        # 6. the paper table of each variant
        for name in variants:
            grid_job(name)
            dest = paper_tables.main(["table", f"grid={GRID}",
                                      f"out_dir={out_dir}"])
            with open(dest) as f:
                rows = list(csv.DictReader(f))
            if len(rows) != 1 or rows[0]["dataset"] != KEPT_STUDY \
                    or not 0 <= float(rows[0]["mean"]) <= 1 \
                    or rows[0]["count"] != "1":
                raise AssertionError(f"paper table of {name}: {rows}")
            print(f"paper table of {name}: {rows[0]}")

        # 7. warm steps of the subsampled XP, restored by signature
        with env.temporary(cache=cache,
                           studies={KEPT_STUDY: work / KEPT_STUDY}):
            solver = play.get_solver_from_sig(sigs["subsample"],
                                              out_dir=out_dir, training=True)
        mask = solver.model.meg_mask
        if mask is None or mask.device.type != device.type \
                or int(mask.sum()) != 128:
            raise AssertionError(f"the subsampled XP's mask: {mask}")
        loader = iter(solver.make_loader(solver.datasets.train))
        batch, weight = next(loader)
        loader.close()
        arrays = to_device(batch, device, solver.args.parallel.transfer_dtype)
        weight = torch.as_tensor(weight, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sub_ms = []
        for _ in range(GRID_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = solver.step(arrays, weight, True)["loss"]
            end.record()
            sub_ms.append((start, end))
        torch.cuda.synchronize()
        sub_ms = [a.elapsed_time(b) for a, b in sub_ms]
        launches, routes, by_dtype = counts()
        sub_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict(normalize_clamp_peak=GRID_STEPS, nt_matmul=0,
                    conv_stats=fused * GRID_STEPS, inv_norms=0)
        if launches != want or routes != {"tc": fused * GRID_STEPS} \
                or by_dtype["bfloat16"] != fused * GRID_STEPS \
                or not torch.isfinite(loss):
            raise AssertionError(f"grid subsample steps: launches "
                                 f"{launches}, routes {routes}, {by_dtype}, "
                                 f"loss {loss}")
        launches_by_path["grid_subsample_steps"] = launches
        # the same steps in torch.profiler (their launches uncounted): the
        # kernels' time a step against the warm step's event time, which
        # holds the card's idle gaps too
        rows = device_rows(lambda: solver.step(arrays, weight, True),
                           GRID_STEPS)
        kernel_ms = sum(row[2] for row in rows) / 1e3
        print(f"grid subsample, {GRID_STEPS} train steps B="
              f"{len(batch.meg)} restored by signature ({card_name}): "
              f"device time {[round(x, 2) for x in sub_ms]} ms (warm "
              f"{sub_ms[-1]:.2f}), peak device memory {sub_gb:.2f} GB; "
              f"kernel launches {launches}; in torch.profiler "
              f"{kernel_ms:.2f} ms of kernel time a step in "
              f"{sum(row[1] for row in rows):.0f} device activities "
              f"(device busy {100 * kernel_ms / sub_ms[-1]:.0f}% of the "
              f"warm step); longest (name, "
              f"launches, µs a step) {rows[:4]}")
        del solver, arrays, batch, weight, loss
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    print(f"grid phase: {time.perf_counter() - t_phase:.1f} s "
          f"({card_name})")
    shapes = {"grid": dict(batch=cfg.optim.batch_size,
                           n_test=probs["base"].shape[0],
                           n_cand=probs["base"].shape[1],
                           n_mels=GRID_EXTRA["dset.features_params"][
                               "MelSpectrum"]["n_mels"], channels=208)}
    return launches_by_path, shapes


#: phase 14: data-parallel training over torch.distributed. The CLI under
#: the launcher (one rank, NCCL) trains the weak-scaling 8-card preset at
#: B=256 for PARALLEL_BATCHES batches on the kept gwilliams2022 tree,
#: beside the same overrides without the launcher
PARALLEL_ARGS = ("preset=clip_conv_v5e8", "optim.batch_size=256",
                 "simpleconv.fused_conv_bn=True",
                 'dset.features=["MelSpectrum"]', "optim.epochs=1",
                 "dset.n_recordings=2", f"dset.selections=[{KEPT_STUDY!r}]")
PARALLEL_BATCHES = 3
#: the launcher's run against the same run without it: each loss
#: relative, each test metric absolute (two processes, one card, the same
#: seeds; the train step's backward runs cuDNN's deterministic algorithms
#: only, so the two runs give the same bits)
LAUNCHER_TOL = 1e-3
#: two ranks sharing the card over gloo, the clip_conv_tpu recipe at this
#: batch a rank: PARALLEL_STEPS train steps each with negatives gathered
#: over both ranks and passed around their ring
PARALLEL_RANK_B = 128
PARALLEL_STEPS = 2
#: the ranks' ring scoring: estimates x candidates, at SCORE_K
PARALLEL_RING = (64, 256)
#: the collectives' ranges in torch.profiler (``parallel``'s spans)
COLLECTIVES = ("bm.all_reduce", "bm.all_gather", "bm.broadcast",
               "bm.exchange", "bm.reduce_scatter")


def _rank_run(device, group, arrays, weight, out: dict, **parallel) -> dict:
    """PARALLEL_STEPS recipe train steps of a rank of `group` on its rows,
    timed with CUDA events (the host clock on the CPU, where a rehearsal
    runs); the first step's held gradients. Before the first run's steps,
    the eval-mode loss and gradients with negatives_group_size=0 into
    `out`["eval"], and the fused layers into `out`["fused"]."""
    cuda = device.type == "cuda"
    trainer = build_trainer(device, RECIPE)
    trainer.solver.set_group(group)
    if "eval" not in out:
        out["fused"] = sum(trainer.model.encoders["meg"].fused)
        trainer.args.parallel.negatives_group_size = 0
        metrics = trainer.solver.loss_and_grad(arrays, weight, train=False)
        out["eval"] = dict(loss=metrics["loss"].item(), grads={
            name: _grad(trainer.model, name) for name in HELD_LEAVES})
    for key, value in parallel.items():
        setattr(trainer.args.parallel, key, value)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, grads = [], [], None
    for _ in range(PARALLEL_STEPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        losses.append(trainer.solver.step(arrays, weight, True)["loss"])
        if cuda:
            end.record()
            end.synchronize()
        step_ms.append(start.elapsed_time(end) if cuda
                       else (time.perf_counter() - t0) * 1e3)
        if grads is None:
            grads = {name: _grad(trainer.model, name) for name in HELD_LEAVES}
    return dict(losses=[x.item() for x in losses], grads=grads,
                step_ms=step_ms, trainer=trainer,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
                else float("nan"))


def _rank_body(device_type: str) -> dict:
    """One rank of phase 14's two ranks on the card: the k=0 eval-mode
    loss and gradients, the gathered and the ring train steps, one warm
    gathered step in torch.profiler (the collectives' ``bm.*``
    ranges), and the ring scoring of PARALLEL_RING; the launch counts of
    all but the profiled step."""
    from brainmagick_tpu_torch import dataset, losses, ops, parallel

    device = parallel.init_distributed(device_type, backend="gloo")
    group = parallel.DataGroup()
    norm_arrays, _ = seeded_arrays()
    batch = make_request(np.random.RandomState(SEED + 14),
                         group.size * PARALLEL_RANK_B,
                         norm_arrays["rec_positions"])
    local, weight = parallel.slice_global_batch(
        {name: getattr(batch, name) for name in dataset.ARRAY_FIELDS},
        np.ones(len(batch.meg), np.float32), group.rank, group.size)
    arrays = dataset.to_device(types.SimpleNamespace(**local), device,
                               "bfloat16")
    weight = torch.from_numpy(weight).to(device)
    out: dict = {"rank": group.rank}
    ops.reset_launch_counts()
    runs = {name: _rank_run(device, group, arrays, weight, out,
                            negatives_group_size=2, ring_negatives=ring)
            for name, ring in (("gathered", False), ("ring", True))}
    gen = torch.Generator().manual_seed(SEED + 15)
    est, pool = (torch.randn((n, SCORE_K), generator=gen).numpy()
                 for n in PARALLEL_RING)
    scores = losses.ring_scores(group, est, pool, torch.bfloat16, device)
    out["launches"] = kernel_launches(ops.launch_counts())
    out["routes"] = dict(ops.conv_stats.launches_by_route)
    out["by_dtype"] = dict(ops.conv_stats.launches_by_dtype)
    if group.lead:
        clip = losses.ClipLoss(compute_dtype="bfloat16")
        want = losses.retrieval_scores(
            clip, torch.from_numpy(est).to(device),
            torch.from_numpy(pool).to(device)).cpu().numpy()
        # MATMUL_TOL's measure: a score is a_m . b_n / |b_n|
        out["ring_scores_err"] = float((np.abs(scores - want) / np.linalg.norm(
            est, axis=1)[:, None]).max())
    # one warm gathered step, profiled on every rank (the collectives
    # meet), its collectives' ranges against the step's host time
    trainer = runs["gathered"].pop("trainer")
    runs["ring"].pop("trainer")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        trainer.solver.step(arrays, weight, True)
        sync()
        step_s = time.perf_counter() - t0
    # a range's CUDA-side annotation has the same key and no host time
    ranges: dict = {}
    for event in prof.key_averages():
        if event.key in COLLECTIVES:
            ranges[event.key] = max(ranges.get(event.key, 0.),
                                    event.cpu_time_total / 1e3)
    out.update(runs=runs, profiled_step_ms=step_s * 1e3,
               collective_ms=ranges)
    return out


def _rank_main(rank: int, world: int, port: int, device_type: str,
               out: str) -> None:
    """A spawned rank of phase 14 (the card shared, gloo between the
    ranks): its ``_rank_body`` or its traceback, pickled into
    `out`.<rank>."""
    import os
    import pickle
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    try:
        from brainmagick_tpu_torch.ops import _build
        if device_type == "cuda":
            _build.library()
        result = (True, _rank_body(device_type))
    except BaseException:  # noqa: BLE001 - sent to the parent
        result = (False, traceback.format_exc())
    with open(f"{out}.{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")


def _check_rank_launches(result: dict) -> None:
    """A rank of phase 14 launched normalize once a forward, conv_stats
    once a fused layer a train step, all bf16 on "tc" (none in the
    eval-mode step), nt_matmul once a ring hop and inv_norms once (the
    rank's block of the pool)."""
    convs = result["fused"] * 2 * PARALLEL_STEPS
    want = dict(conv_stats=convs, normalize_clamp_peak=1 + 2 * PARALLEL_STEPS,
                nt_matmul=2, inv_norms=1)
    if result["launches"] != want or result["routes"] != {"tc": convs} \
            or result["by_dtype"]["bfloat16"] != convs:
        raise AssertionError(f"rank {result['rank']} launched "
                             f"{result['launches']} ({result['routes']}, "
                             f"{result['by_dtype']}), want {want}")


def run_ranks_on_one_card(device: torch.device, card_name: str,
                          work: Path, world: int = 2,
                          timeout: float = 300.) -> list:
    """`world` spawned ranks of ``_rank_body`` sharing the card; their
    results, or AssertionError with a failing rank's traceback. Every rank
    still running at `timeout` is killed."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = str(work / "parallel_rank")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device.type, out))
             for r in range(world)]
    for proc in procs:
        proc.start()
    end = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.join(max(0., end - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    results = []
    for r, proc in enumerate(procs):
        path = Path(f"{out}.{r}")
        if not path.exists():
            raise AssertionError(f"phase 14 rank {r}: no result (exit code "
                                 f"{proc.exitcode})")
        ok, value = pickle.loads(path.read_bytes())
        if not ok:
            raise AssertionError(f"phase 14 rank {r} ({card_name}):\n{value}")
        results.append(value)
    return results


def _launcher_run(device: torch.device, card_name: str, work: Path,
                  argv: list) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node=1
    -m brainmagick_tpu_torch.train <argv>`` in a subprocess, the card's
    rank over NCCL (gloo on the CPU); returns (the launch counts its log
    ends with, its log, its wall seconds)."""
    import os
    import re
    import sys

    from brainmagick_tpu_torch.env import env

    repo = Path(__file__).resolve().parent
    environ = dict(env.environ(), PYTHONPATH=str(repo), OMP_NUM_THREADS="4")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        environ.pop(key, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "brainmagick_tpu_torch.train", *argv],
        cwd=repo, env=environ, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    backend = "nccl" if device.type == "cuda" else "gloo"
    found = re.findall(r"Program counters: (\{.*\})", log)
    if proc.returncode or not found or \
            f"Data-parallel run over 1 rank(s) ({backend})" not in log:
        print(log[-6000:])
        raise AssertionError(f"the launcher's run exited {proc.returncode}"
                             f" ({card_name})")
    return kernel_launches(json.loads(found[-1])), log, wall


def run_parallel_phase(device: torch.device, card_name: str, work: Path,
                       study_shape: tp.Optional[dict] = None) -> tuple:
    """Phase 14: data-parallel training through torch.distributed.

    1. The train CLI under the launcher (one rank on the card over NCCL)
       with PARALLEL_ARGS for PARALLEL_BATCHES batches, a valid and a test
       stage on the kept gwilliams2022 tree, against the same overrides
       without the launcher (``run_cli``): the losses and the test metrics
       within LAUNCHER_TOL, the same launches of every kernel, conv_stats
       10 times a train step in bf16 on "tc", nt_matmul in the test
       stage.
    2. Two ranks sharing the card over gloo (NCCL takes one rank a card;
       gloo carries the CUDA tensors through host copies), the recipe at
       PARALLEL_RANK_B a rank: negatives_group_size=0's eval-mode loss and
       gradients against one rank at 2 x PARALLEL_RANK_B on the same batch
       at RECIPE_TOL / RECIPE_GRAD_TOL; PARALLEL_STEPS train steps with the
       negatives gathered over both ranks and passed around their ring,
       the ring's against the gathered at the same tolerances, and every
       rank's weights alike; ring_scores over the ranks against one
       card's scores; each rank's warm step, peak memory and launches,
       and the collectives' share of a profiled step.

    `study_shape` is phase 9's gwilliams2022 run's ``check_cli_shapes``
    arguments, which part 1's must equal. Returns ({path: launch counts},
    {path: ``check_cli_shapes`` arguments})."""
    from brainmagick_tpu_torch import dataset
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.train import parse_overrides

    t_phase = time.perf_counter()
    cpu = [] if device.type == "cuda" else ["device=cpu"]
    common = [*PARALLEL_ARGS, f"optim.max_batches={PARALLEL_BATCHES}",
              f"cache={work}/cache_{KEPT_STUDY}", *cpu]
    histories, launches_by_path = {}, {}
    with env.temporary(studies={KEPT_STUDY: work / KEPT_STUDY}):
        launched, log, launcher_s = _launcher_run(
            device, card_name, work,
            common + [f"out_dir={work}/parallel_launcher"])
        alone = common + [f"out_dir={work}/parallel_alone"]
        launches, routes, by_dtype, spy, alone_s, peak_gb = run_cli(
            alone, "parallel: the same run without the launcher", card_name)
    solver = spy.solver
    fused = sum(sum(e.fused) for e in solver.model.encoders.values())
    steps = _check_cli_launches("parallel alone", launches, routes, by_dtype,
                                spy, "bfloat16", fused=fused)
    step_ms = spy.train_step_ms()
    n_test = len(solver.datasets.test)
    channels = solver.datasets.train[0].meg.shape[0]
    n_mels = solver.used_features["MelSpectrum"].n_mels
    del solver, spy
    torch.cuda.empty_cache()
    if launched != launches:
        raise AssertionError(f"the launcher's run launched {launched}, the "
                             f"run without it {launches}")
    for name, out_dir in (("launcher", "parallel_launcher"),
                          ("alone", "parallel_alone")):
        folder = Path(parse_overrides(
            common + [f"out_dir={work}/{out_dir}"]).xp_folder)
        histories[name] = _read_history(folder, 1, f"parallel {name}")[0]
    diffs = {}
    for stage, metrics in histories["alone"].items():
        for key, value in metrics.items():
            got = histories["launcher"][stage][key]
            diffs[f"{stage} {key}"] = abs(got - value) / abs(value) \
                if stage != "test" else abs(got - value)
    backend = "NCCL" if device.type == "cuda" else "gloo"
    print(f"parallel, the CLI under the launcher ({card_name}): one rank "
          f"over {backend}, {launcher_s:.1f} s (the launcher's start, the "
          f"datasets from the cache, {steps} train steps, valid and test); "
          f"history {histories['launcher']}; without the launcher "
          f"{alone_s:.1f} s, history {histories['alone']}, train step "
          f"device time {[round(x, 2) for x in step_ms]} ms, peak device "
          f"memory {peak_gb:.2f} GB; differences {diffs} (tol "
          f"{LAUNCHER_TOL}); kernel launches {launched} in both")
    if not all(d <= LAUNCHER_TOL for d in diffs.values()):
        raise AssertionError(f"the launcher's run against the run without "
                             f"it: {diffs}")
    launches_by_path["parallel_launcher"] = launched
    launches_by_path["parallel_cli"] = launches

    # 2. two ranks on the card; the reference: one rank at the whole batch
    norm_arrays, _ = seeded_arrays()
    batch = make_request(np.random.RandomState(SEED + 14),
                         2 * PARALLEL_RANK_B, norm_arrays["rec_positions"])
    trainer = build_trainer(device, RECIPE)
    metrics = trainer.solver.loss_and_grad(
        dataset.to_device(batch, device, "bfloat16"),
        torch.ones(2 * PARALLEL_RANK_B, device=device), train=False)
    want = dict(loss=metrics["loss"].item(), grads={
        name: _grad(trainer.model, name) for name in HELD_LEAVES})
    del trainer, metrics
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks_on_one_card(device, card_name, work)
    ranks_s = time.perf_counter() - t0

    def errors(got: dict, ref: dict) -> dict:
        errs = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}
        errs.update({f"grad {name}": _norm_err(got["grads"][name],
                                               ref["grads"][name])
                     for name in HELD_LEAVES})
        return errs

    for result in ranks:
        r = result["rank"]
        errs = errors(result["eval"], want)
        _check_errors(errs, RECIPE_TOL, f"rank {r} k=0 eval-mode step",
                      RECIPE_GRAD_TOL)
        gathered, ring = result["runs"]["gathered"], result["runs"]["ring"]
        ring_errs = {f"step {i} loss": abs(a - b) / abs(b) for i, (a, b)
                     in enumerate(zip(ring["losses"], gathered["losses"]))}
        ring_errs.update(errors(dict(loss=ring["losses"][0],
                                     grads=ring["grads"]),
                                dict(loss=gathered["losses"][0],
                                     grads=gathered["grads"])))
        _check_errors(ring_errs, RECIPE_TOL, f"rank {r} ring against "
                      f"gathered", RECIPE_GRAD_TOL)
        _check_rank_launches(result)
        if not all(np.isfinite(x) for x in gathered["losses"]
                   + ring["losses"]):
            raise AssertionError(f"rank {r} losses {gathered['losses']} "
                                 f"{ring['losses']}")
        share = sum(result["collective_ms"].values()) \
            / result["profiled_step_ms"]
        print(f"parallel, rank {r} of 2 on the one card over gloo "
              f"({card_name}): k=0 eval-mode step against one rank at "
              f"B={2 * PARALLEL_RANK_B}: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items())
              + f"; ring against gathered (k=2): " + ", ".join(
                  f"{k} {v:.2e}" for k, v in ring_errs.items())
              + f" (tol {RECIPE_TOL:.2e}, gradients {RECIPE_GRAD_TOL:.2e} "
              f"in norm); gathered losses {gathered['losses']}, step device "
              f"time {[round(x, 2) for x in gathered['step_ms']]} ms, peak "
              f"{gathered['peak_gb']:.2f} GB; ring losses {ring['losses']}, "
              f"step device time {[round(x, 2) for x in ring['step_ms']]} "
              f"ms, peak {ring['peak_gb']:.2f} GB; a profiled warm gathered "
              f"step {result['profiled_step_ms']:.1f} ms (host clock), its "
              f"collectives' ranges (ms) {result['collective_ms']}, "
              f"{100 * share:.0f}% of it (gloo through host copies: two "
              f"ranks sharing one card, not NVLink); launches "
              f"{result['launches']}")
    lead = ranks[0]
    if not lead["ring_scores_err"] <= MATMUL_TOL:
        raise AssertionError(f"ring_scores over the ranks against one card:"
                             f" {lead['ring_scores_err']}")
    print(f"parallel: ring_scores over 2 ranks, {PARALLEL_RING[0]} "
          f"estimates x {PARALLEL_RING[1]} candidates x {SCORE_K} in bf16, "
          f"against one card's retrieval_scores: max |diff| / |a_m| "
          f"{lead['ring_scores_err']:.2e}; two ranks' run {ranks_s:.1f} s "
          f"(their start included)")
    print("parallel: what one card leaves out: NCCL ran one rank (part 1: "
          "its all-reduce, broadcast and barrier); between two ranks gloo "
          "carried every collective through a host copy (all-reduce, "
          "all-gather, broadcast, the ring's P2P). NCCL's all-gather, P2P "
          "and reduce-scatter between cards, and a gradient through the "
          "gathered or ring-passed rows (the recipe's candidates are its "
          "targets, which take none), are held on the CPU by "
          "tests/test_torch_parallel.py over gloo")
    launches_by_path["parallel_ranks"] = {
        name: sum(r["launches"][name] for r in ranks)
        for name in ranks[0]["launches"]}
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s "
          f"({card_name})")
    shapes = {"parallel_ranks": dict(batch=PARALLEL_RANK_B, n_test=0,
                                     n_mels=F, with_matmul=False),
              "parallel_ring": dict(batch=PARALLEL_RANK_B, with_conv=False,
                                    n_test=PARALLEL_RING[0] // 2, n_mels=F,
                                    n_cand=PARALLEL_RING[1] // 2)}
    # part 1's shapes are phase 9's gwilliams2022 run's (the same tree,
    # batch and test split), whose kernels main holds at them
    got = dict(batch=256, n_test=n_test, n_mels=n_mels, channels=channels)
    if study_shape is not None and got != study_shape:
        raise AssertionError(f"parallel: the CLI's shapes {got}, phase 9's "
                             f"{study_shape}")
    return launches_by_path, shapes


#: phase 15: the wav2vec 2.0 features with random=True (the JAX package's
#: default ``dset.features``, the paper's 1024-dim target), on the card.
#: The seeded xlsr-53 init is held to the per-tensor SHA-256 digest of
#: HF's (W2V_GOLDEN, written by scripts/torch_wav2vec2_digest.py)
W2V_GOLDEN = Path("tests") / "golden" / "wav2vec2_xlsr53_init_sha256.json"
W2V_LAYERS = [14, 15, 16, 17, 18]
#: the SHA-256 of the port's truncated LeCun draws
#: (``models.common.lecun_normal_``) of a [256, 320, 3] kernel at seed
#: 2036, as the CPU tests draw them (tests/test_torch_models.py): the
#: card machine's torch must draw the weights the tests draw at a seed
LECUN_SHA256 = ("1c2bf42d7c313a3d4014ecc7927d22ee"
                "4b6ec5287cfab3a49ee500549dd5d95d")
#: each collected hidden state of the card against the CPU's on the same
#: weights and waveform: max |diff| / max |value| (fp32, TF32 off)
W2V_TOL = 1e-4
W2V_CPU_EVENTS = 2
#: the planted-map rehearsal: a copy of the JAX package's study
#: (scripts/rehearsal.py): 4 subjects, 48 sentences (16 written out, 32
#: drawn from a word bank with a seeded RandomState), a word every
#: REHEARSAL_WORD_STEP s, REHEARSAL_GAP s between sentences, 208 KIT
#: channels at 1000 Hz, MEG = a RandomState(777) mix of the centered
#: Wav2VecTransformer track plus 0.3 x noise; the rehearsal grid trains
#: on it with its own run length (8 epochs x 24 batches at B=16) and only
#: fused_conv_bn added (so conv_stats runs on the path)
REHEARSAL_SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore today",
    "a stitch in time saves nine they always say",
    "every good boy deserves fudge and fruit at noon",
    "the rain in spain falls mainly on the plain",
    "pack my box with five dozen brown liquor jugs",
    "how quickly daft jumping zebras vex the old judge",
    "we watched the bright stars fade before cold dawn",
    "small rivers carve deep valleys through patient stone walls",
    "the baker sold warm bread before the town woke",
    "tall ships crossed rough seas under heavy grey skies",
    "her garden grew wild roses beside the old gate",
    "the children chased bright kites across the open field",
    "old clocks tick slowly in the quiet dusty hall",
    "fresh snow covered every roof in the sleeping village",
    "long trains carried coal north through the frozen hills"]
REHEARSAL_WORD_BANK = (
    "time river stone light cloud dream horse paper garden winter "
    "summer candle window forest meadow copper silver branch valley "
    "thunder breeze harbor lantern marble pebble saddle tunnel velvet "
    "whisper yellow anchor basket cradle dagger ember feather goblet "
    "hollow island jungle kettle ladder mirror needle orchard puzzle "
    "quiver ribbon shadow timber urchin violet walnut yonder zephyr "
    "bridge castle desert engine flower").split()
REHEARSAL_SUBJECTS, REHEARSAL_CHANNELS, REHEARSAL_SR = 4, 208, 1000
REHEARSAL_WORD_STEP, REHEARSAL_GAP = 0.4, 2.0
REHEARSAL_EXTRA = {"simpleconv.fused_conv_bn": True}
REHEARSAL_NEGATIVES = 200
#: phase 15 (d): the convrnn preset on its default features, random=True
W2V_CONVRNN = ("preset=convrnn", "dset.features_params=" + repr({
    "Wav2VecTransformer": dict(layers=W2V_LAYERS, device="cpu",
                               random=True)}), "optim.max_batches=2")


def rehearsal_sentences() -> list:
    rng = np.random.RandomState(20260819)
    return REHEARSAL_SENTENCES + [
        " ".join(rng.choice(REHEARSAL_WORD_BANK, 8, replace=False))
        for _ in range(32)]


def _write_rehearsal_wav(path: Path, seconds: float) -> None:
    """The JAX rehearsal's story: a gliding tone under an envelope plus
    seeded wideband noise, so that every slice of it is a distinct
    waveform (``mockdata.write_speech_wav`` repeats an 8 s clip, which
    would give segments 8 s apart the same targets), 16-bit at 16 kHz."""
    import wave

    path.parent.mkdir(parents=True, exist_ok=True)
    sr = 16_000
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sig = (np.sin(2 * np.pi * (220 + 40 * np.sin(0.5 * t)) * t)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t)))
    sig = 0.7 * sig + 0.3 * np.random.RandomState(123).randn(n)
    sig = (np.clip(sig, -1.9, 1.9) * 2 ** 13).astype("<i2")
    with wave.open(str(path), "w") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(sig.tobytes())


def write_rehearsal_tree(root: Path) -> float:
    """The rehearsal study's BIDS tree without its MEG: participants.tsv,
    each subject's events.tsv (a sound per sentence at its own offset of
    one story wav, its words) and the story. Returns the story's
    seconds."""
    import csv

    download = root / "download"
    download.mkdir(parents=True)
    subjects = [f"sub-{k + 1:02d}" for k in range(REHEARSAL_SUBJECTS)]
    with open(download / "participants.tsv", "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(["participant_id"])
        writer.writerows([s] for s in subjects)
    rows, t = [], 1.0
    for seq_id, sentence in enumerate(rehearsal_sentences()):
        words = sentence.split()
        rows.append((t, len(words) * REHEARSAL_WORD_STEP, repr(dict(
            kind="sound", offset=t, sound="stimuli/audio/story0.WAV.wav"))))
        for word in words:
            rows.append((t, 0.3, repr(dict(
                kind="word", word=word, sequence_id=seq_id,
                condition="sentence"))))
            t += REHEARSAL_WORD_STEP
        t += REHEARSAL_GAP
    total = t + 2.0
    _write_rehearsal_wav(download / "stimuli" / "audio" / "story0.wav", total)
    for sub in subjects:
        meg = download / sub / "ses-0" / "meg"
        meg.mkdir(parents=True)
        with open(meg / f"{sub}_ses-0_task-0_events.tsv", "w",
                  newline="") as f:
            writer = csv.writer(f, delimiter="\t")
            writer.writerow(["onset", "duration", "trial_type"])
            writer.writerows(rows)
    return total


def plant_rehearsal_meg(root: Path, track: np.ndarray, total: float) -> None:
    """Each subject's KIT .con: a RandomState(777) mix of the centered
    [1024, T@120 Hz] `track` onto the sensors, upsampled to 1000 Hz by
    nearest neighbour, unit std, plus 0.3 x RandomState(100 + subject)
    noise, at tesla scale."""
    from brainmagick_tpu_torch.studies import api, kit

    track = track - track.mean(axis=1, keepdims=True)
    mix = np.random.RandomState(777).randn(
        REHEARSAL_CHANNELS, track.shape[0]).astype(np.float32)
    mix /= np.sqrt(track.shape[0])
    signal_120 = mix @ track
    n = int(REHEARSAL_SR * total)
    idx = np.minimum(np.arange(n) * 120 // REHEARSAL_SR,
                     signal_120.shape[1] - 1)
    signal = signal_120[:, idx]
    signal /= max(signal.std(), 1e-9)
    positions = np.random.RandomState(0).rand(REHEARSAL_CHANNELS,
                                              2).astype(np.float32)
    for k in range(REHEARSAL_SUBJECTS):
        sub = f"sub-{k + 1:02d}"
        noise = np.random.RandomState(100 + k).randn(
            REHEARSAL_CHANNELS, n).astype(np.float32)
        raw = api.RawData(
            data=((signal + 0.3 * noise) * 1e-13).astype(np.float32),
            sample_rate=float(REHEARSAL_SR),
            ch_names=[f"MEG{c:03d}" for c in range(REHEARSAL_CHANNELS)],
            positions=positions, ch_kinds=[kit.KIND_MEG] * REHEARSAL_CHANNELS)
        kit.write_kit(root / "download" / sub / "ses-0" / "meg"
                      / f"{sub}_ses-0_task-0_meg.con", raw)


def _max_share(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def check_w2v_init(card_name: str) -> float:
    """(a) The features' seeded xlsr-53 network, built on the host as the
    features build it (and kept for them), against W2V_GOLDEN tensor by
    tensor; the first tensor that differs stops the run. Returns the host
    seconds of the init."""
    from brainmagick_tpu_torch.features import audio
    from brainmagick_tpu_torch.models.wav2vec2 import state_digest
    from brainmagick_tpu_torch.utils import Frequency

    golden = json.loads((Path(__file__).resolve().parent / W2V_GOLDEN
                         ).read_text())
    feature = audio.Wav2VecTransformer(Frequency(120.), layers=W2V_LAYERS,
                                       random=True)
    t0 = time.perf_counter()
    model = feature.model
    init_s = time.perf_counter() - t0
    got = state_digest(model.state_dict())
    for name, digest in golden["sha256"].items():
        if got.get(name) != digest:
            raise AssertionError(
                f"wav2vec2 seeded init: tensor {name} differs from HF's "
                f"(golden {digest[:16]}, here {str(got.get(name))[:16]}; "
                f"torch {torch.__version__} here, {golden['torch']} for the "
                f"golden)")
    if set(got) != set(golden["sha256"]):
        raise AssertionError(f"wav2vec2 tensors {set(got) ^ set(golden)}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"wav2vec2 seeded init ({golden['model']}, seed "
          f"{golden['seed']}): {n_params:,} parameters in "
          f"{init_s:.2f} s on the host, {len(got)} tensors equal to HF's "
          f"digest (torch {torch.__version__}, golden from "
          f"{golden['torch']}) ({card_name})")
    return init_s


def check_lecun_init() -> None:
    """The port's truncated LeCun draws at a seed against LECUN_SHA256."""
    import hashlib

    from brainmagick_tpu_torch.models.common import lecun_normal_

    kernel = torch.empty(256, 320, 3)
    lecun_normal_(kernel, 320 * 3, torch.Generator().manual_seed(2036))
    got = hashlib.sha256(kernel.numpy().tobytes()).hexdigest()
    if got != LECUN_SHA256:
        raise AssertionError(f"lecun_normal_ at seed 2036: {got[:16]}, the "
                             f"CPU tests' {LECUN_SHA256[:16]} (torch "
                             f"{torch.__version__})")
    print(f"the port's truncated LeCun draws at seed 2036 equal the CPU "
          f"tests' digest (torch {torch.__version__})")


def check_w2v_render(device: torch.device, card_name: str, root: Path,
                     total: float) -> np.ndarray:
    """(b) One rehearsal recording's Wav2VecTransformer track rendered by
    FeaturesBuilder on the card (s per s of audio, peak memory), then
    W2V_CPU_EVENTS of its sound events through the same weights on the
    CPU, each collected hidden state held to the card's at W2V_TOL.
    Returns the [1024, T@120 Hz] track."""
    import copy

    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.features import FeaturesBuilder
    from brainmagick_tpu_torch.precision import exact_fp32
    from brainmagick_tpu_torch.studies.gwilliams2022 import (
        Gwilliams2022Recording)
    from brainmagick_tpu_torch.utils import Frequency

    with env.temporary(studies={KEPT_STUDY: root}):
        events = Gwilliams2022Recording(subject_uid="01", session="0",
                                        story="0")._load_events()
    builder = FeaturesBuilder(
        events, ["Wav2VecTransformer"], {"Wav2VecTransformer": dict(
            layers=W2V_LAYERS, device="cpu", random=True)},
        Frequency(120.), study=KEPT_STUDY, device=device)
    sounds = list(builder.events[builder.events.kind_mask("sound")].iter())
    audio_s = sum(s.duration for s in sounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    track, _, _ = builder(0.0, total)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(track).all() or track.shape[0] != 1024 \
            or not (track != 0).any():
        raise AssertionError(f"the rehearsal track {track.shape}")
    model = builder["Wav2VecTransformer"].model
    if next(model.parameters()).device.type != device.type:
        raise AssertionError(f"the encoder did not run on {device}")
    cpu_model = copy.deepcopy(model).cpu()
    errs, cpu_s, cpu_audio = [], 0., 0.
    for sound in sounds[:W2V_CPU_EVENTS]:
        wav = builder["Wav2VecTransformer"]._preprocess_wav(
            str(sound.filepath), sound.offset, sound.offset + sound.duration)
        with torch.no_grad(), exact_fp32():
            card_states = model(wav.to(device), W2V_LAYERS)[2]
            t0 = time.perf_counter()
            cpu_states = cpu_model(wav, W2V_LAYERS)[2]
            cpu_s += time.perf_counter() - t0
        cpu_audio += sound.duration
        errs += [_max_share(c.cpu(), h) for c, h in zip(card_states,
                                                         cpu_states)]
    del cpu_model
    print(f"wav2vec2 render ({card_name}): one recording's "
          f"Wav2VecTransformer track, {len(sounds)} sound events, "
          f"{audio_s:.1f} s of audio (longest {max(s.duration for s in sounds):.1f}"
          f" s) in {card_s:.2f} s on the card ({card_s / audio_s:.4f} s per s "
          f"of audio), peak device memory {peak_gb:.2f} GB; on the CPU "
          f"{cpu_s / cpu_audio:.4f} s per s over {W2V_CPU_EVENTS} events; "
          f"layers {W2V_LAYERS} card against CPU, max|diff|/max|x| "
          f"{[f'{e:.2e}' for e in errs]} (tol {W2V_TOL:.0e})")
    if not max(errs) <= W2V_TOL:
        raise AssertionError(f"wav2vec2 card against CPU: {errs}")
    return track


def run_wav2vec_phase(device: torch.device, card_name: str, work: Path
                      ) -> tuple:
    """Phase 15: (a) the seeded init against HF's digest, and the port's
    LeCun draws against the CPU tests' (``check_lecun_init``); (b) a rehearsal
    recording's track on the card against the CPU (``check_w2v_render``);
    (c) the planted-map rehearsal: the study written and planted from
    that track, the rehearsal grid (REHEARSAL_EXTRA) trained by
    ``runner.run_jobs`` in this process (conv_stats 10 times a train step
    in bf16 on "tc", normalize once a forward, nt_matmul in the test
    stage; wav2vec_rehearsal), evaluated by signature with
    REHEARSAL_NEGATIVES negatives (wav2vec_eval) and tabulated by
    ``paper_tables``, its top-1 at least max(0.15, 5 x chance), the JAX
    rehearsal's gate; (d) two train steps of the convrnn preset on its
    default features (W2V_CONVRNN) on the kept gwilliams2022 tree, its
    sound events (the story's sound split into blocks, the longest about
    20 s) rendered on the card (wav2vec_convrnn). Returns
    ({path: launch counts}, {path: ``check_cli_shapes`` arguments})."""
    import csv
    import gc
    import os

    from brainmagick_tpu_torch import ops, paper_tables
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.grids import runner
    from brainmagick_tpu_torch.train import parse_overrides

    t_phase = time.perf_counter()
    check_w2v_init(card_name)
    check_lecun_init()
    root = work / "rehearsal"
    cache = work / "cache_rehearsal"
    out_dir = str(work / "rehearsal_outputs")
    t0 = time.perf_counter()
    total = write_rehearsal_tree(root)
    with env.temporary(cache=cache):
        track = check_w2v_render(device, card_name, root, total)
    plant_rehearsal_meg(root, track, total)
    print(f"rehearsal study: {REHEARSAL_SUBJECTS} subjects x "
          f"{total:.1f} s, {len(rehearsal_sentences())} sentences, written "
          f"and planted in {time.perf_counter() - t0:.1f} s")

    hooks = ("BM_REHEARSAL_CACHE", "BM_REHEARSAL_EXTRA")
    saved = {key: os.environ.get(key) for key in hooks}
    os.environ["BM_REHEARSAL_CACHE"] = str(cache)
    os.environ["BM_REHEARSAL_EXTRA"] = json.dumps(REHEARSAL_EXTRA)
    launches_by_path: dict = {}
    try:
        _, jobs = runner.get_grid(GRID)
        cfg = jobs[0].to_config()
        if len(jobs) != 1 or cfg.dset.features != ["Wav2VecTransformer"] \
                or not cfg.dset.features_params["Wav2VecTransformer"][
                    "random"]:
            raise AssertionError(f"grid {GRID}: {len(jobs)} jobs, "
                                 f"{cfg.dset.features}")
        sig = jobs[0].sig
        with env.temporary(studies={KEPT_STUDY: root}):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with SolverSpy() as spy:
                t0 = time.perf_counter()
                results = runner.run_jobs(jobs, out_dir, workers=1)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in ops.KERNELS}
            routes = dict(ops.conv_stats.launches_by_route)
            by_dtype = dict(ops.conv_stats.launches_by_dtype)
        if results != {sig: 0}:
            raise AssertionError(f"rehearsal run: {results}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fused = sum(sum(e.fused) for e in spy.solver.model.encoders.values())
        steps = _check_cli_launches("wav2vec rehearsal", launches, routes,
                                    by_dtype, spy, "bfloat16", fused=fused)
        step_ms = spy.train_step_ms()
        history = _read_history(Path(out_dir) / "xps" / sig,
                                cfg.optim.epochs, "wav2vec rehearsal")
        build = dict(spy.solver.build_timings)
        spy.solver = None
        del spy
        print(f"rehearsal grid ({card_name}): {steps} train steps B="
              f"{cfg.optim.batch_size}, run_jobs {train_s:.1f} s, warm step "
              f"{step_ms[-1]:.2f} ms of device time (median "
              f"{statistics.median(step_ms):.2f}), peak device memory "
              f"{peak_gb:.2f} GB, dataset build {build['datasets']:.2f} s, "
              f"scaler {build['scaler']:.2f} s; kernel launches "
              f"{launches}; losses "
              f"{[(round(h['train']['loss'], 4), round(h['valid']['loss'], 4)) for h in history]}")
        launches_by_path["wav2vec_rehearsal"] = launches

        xp = dict(sig=sig, out_dir=out_dir, cache=cache)
        got = eval_by_sig(xp, "wav2vec rehearsal", card_name,
                          studies={KEPT_STUDY: root},
                          extra=(f"n_negatives={REHEARSAL_NEGATIVES}",))
        launches_by_path["wav2vec_eval"] = got["launches"]
        n_cand = len(got["vocab"])
        chance = 1. / max(n_cand, 1)
        top1 = got["acc"][1]
        print(f"rehearsal top-1 segment accuracy (planted wav2vec2 -> MEG "
              f"map) {100 * top1:.1f}% over {n_cand} candidates, chance "
              f"{100 * chance:.2f}%, gate {100 * max(0.15, 5 * chance):.1f}% "
              f"({card_name})")
        if not top1 >= max(0.15, 5 * chance):
            raise AssertionError(f"the rehearsal did not learn the planted "
                                 f"map: top-1 {top1:.3f}, chance {chance:.3f}")
        dest = paper_tables.main(["table", f"grid={GRID}",
                                  f"out_dir={out_dir}"])
        with open(dest) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or not 0 <= float(rows[0]["mean"]) <= 1 \
                or rows[0]["count"] != "1":
            raise AssertionError(f"paper table of the rehearsal: {rows}")
        print(f"paper table of the rehearsal: {rows[0]}")
        n_test = got["probs"].shape[0]
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the convrnn preset on its default features
    t0 = time.perf_counter()
    argv = [*W2V_CONVRNN, *ENCODE_COMMON, f"cache={work}/cache_{KEPT_STUDY}",
            f"out_dir={work}/outputs"]
    with env.temporary(studies={KEPT_STUDY: work / KEPT_STUDY}):
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, "wav2vec convrnn", card_name)
    solver = spy.solver
    model = solver.model
    if type(model).__name__ != "ConvRNN" \
            or model.in_channels != {"meg": 208, "features": 1024} \
            or list(solver.used_features) != ["Wav2VecTransformer"]:
        raise AssertionError(f"wav2vec convrnn: {type(model).__name__} "
                             f"{model.in_channels}")
    steps = _check_cli_launches("wav2vec convrnn", launches, routes,
                                by_dtype, spy, "float32", scored=False,
                                fused=0)
    history = _read_history(Path(parse_overrides(argv).xp_folder), 1,
                            "wav2vec convrnn")
    test = history[0].get("test", {})
    if steps != 2 or set(test) != {"corr_meg"} \
            or not np.isfinite(test["corr_meg"]):
        raise AssertionError(f"wav2vec convrnn: {steps} steps, {test}")
    sounds = [d.events for d in solver.datasets.train.datasets]
    longest = max(float(e["duration"].max()) for e in (
        t[t.kind_mask("sound")] for t in sounds))
    tracks_s = sum(d.track_seconds for split in solver.datasets
                   for d in split.datasets)
    step_ms = spy.train_step_ms()
    print(f"wav2vec convrnn ({card_name}): {steps} train steps B=256 on "
          f"Wav2VecTransformer (random=True), device time "
          f"{[round(x, 2) for x in step_ms]} ms, peak device memory "
          f"{peak_gb:.2f} GB with the longest sound event {longest:.1f} s "
          f"rendered on the card, track render {tracks_s:.2f} s, run "
          f"{wall:.1f} s ({time.perf_counter() - t0:.1f} s); history "
          f"{history}")
    launches_by_path["wav2vec_convrnn"] = launches
    del solver, model, spy
    gc.collect()
    torch.cuda.empty_cache()
    print(f"wav2vec phase: {time.perf_counter() - t_phase:.1f} s "
          f"({card_name})")
    shapes = {"wav2vec_rehearsal": dict(
        batch=cfg.optim.batch_size, n_test=n_test, n_cand=n_cand,
        n_mels=1024, channels=REHEARSAL_CHANNELS)}
    return launches_by_path, shapes


#: phase 16: the train step's options on phase 9's gwilliams2022 tree
#: (KEPT_STUDY), in the folder phases 8-15 share: the clip_conv_tpu recipe
#: at the paper's width, B=256, fused conv_stats, MelSpectrum at 120 mels;
#: run 1 with every option of the slice (sampled negatives from the pool,
#: the SVD penalty, the three dropouts on the explicit generator, the
#: rewrite conv, LayerScale, the post-skip conv, the "btc" estimate) for
#: OPTIONS_BATCHES train batches, the valid pass and the test stage; run 2
#: the learned projection (clip.linear, twin off) for 2 train steps, then
#: its XP evaluated by signature
OPTIONS_BATCHES = 3
#: (the runs' own overrides follow OPTIONS_COMMON: its preset sets
#: optim.max_batches)
OPTIONS_COMMON = (f"preset={RECIPE}", "simpleconv.fused_conv_bn=True",
                  'dset.features=["MelSpectrum"]', "optim.batch_size=256",
                  "optim.epochs=1", "dset.n_recordings=2",
                  f"dset.selections=[{KEPT_STUDY!r}]")
OPTIONS_RUNS = {
    "options_train": (
        "optim.negatives=512", "optim.svd=0.01",
        "simpleconv.conv_dropout=0.1", "simpleconv.dropout_input=0.1",
        "simpleconv.dropout=0.1", "simpleconv.rewrite=True",
        "simpleconv.scale=0.1", "simpleconv.post_skip=True",
        "simpleconv.output_layout=btc",
        f"optim.max_batches={OPTIONS_BATCHES}"),
    "options_linear": ("clip.linear=256", "clip.twin=False",
                       "optim.max_batches=2")}
#: the held step's gradients: layer 0's conv (behind the input dropout),
#: layer 9's conv, rewrite conv, LayerScale and post-skip conv
OPTIONS_LEAVES = ("merger.heads", "subject_layers.weights",
                  "encoders.meg.sequence.0.1.weight",
                  "encoders.meg.sequence.9.0.weight",
                  "encoders.meg.sequence.9.4.weight",
                  "encoders.meg.sequence.9.6.scale",
                  "encoders.meg.sequence.9.7.weight", "final.2.weight")
#: the SVD penalty on the card against the CPU, relative
SVD_TOL = 1e-5


def _options_held_step(where, args, widths: tuple, norm_arrays: dict,
                       batch, negatives, float64: bool = False) -> tuple:
    """One Trainer.step of `args` at `widths` (the MEG's sensors, the
    targets' width, the subjects) on `where` from seeds (the weights, and
    the dropout generator on the CPU: the card's run draws the same disks
    and masks as the CPU's, moved to the card) and `norm_arrays`, with the
    same `negatives` (rows, weights; none when empty): (loss, model).
    With `float64`, as ``encode_held_step``: the step's
    forward wires the model's inputs and targets in fp32, then the model
    runs in float64 on them (its fused layers unfused: the same
    parameters, cuDNN's float64 convs in place of conv_stats, which takes
    fp32 and bf16), with the CLIP loss, the SVD penalty and their
    backward (no update)."""
    from brainmagick_tpu_torch import svd
    from brainmagick_tpu_torch.dataset import to_device
    from brainmagick_tpu_torch.precision import exact_fp32
    from brainmagick_tpu_torch.solver import target_length
    from brainmagick_tpu_torch.train import Trainer

    trainer = Trainer(
        args, *widths, None, None, norm_arrays, where,
        generator=torch.Generator().manual_seed(SEED),
        length=target_length(args, batch.features.shape[-1]))
    rows, weight = (torch.from_numpy(x).to(trainer.device)
                    if len(x) else None for x in negatives)
    if not float64:
        loss = trainer.step(batch, negatives=rows, negative_weight=weight)
        return loss["loss"].item(), trainer.model
    seen = {}
    hook = trainer.model.register_forward_pre_hook(
        lambda module, args, kwargs: seen.update(args=args, kwargs=kwargs),
        with_kwargs=True)
    pad = torch.ones(len(batch.meg), device=trainer.device)
    with torch.no_grad(), exact_fp32():
        _, output, mask, keep, _ = trainer.solver._forward(
            to_device(batch, trainer.device, None), pad, train=True)
    hook.remove()

    def wide(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x
    inputs, subjects, positions = seen["args"][:3]
    model = trainer.model.double()
    for encoder in model.encoders.values():
        encoder.fused = [False] * len(encoder.fused)
    with exact_fp32():
        estimate, penalty = model(
            {k: v.double() for k, v in inputs.items()}, subjects,
            wide(positions), **{k: wide(v) for k, v in
                                seen["kwargs"].items()})
        if model.output_layout == "btc":
            estimate = estimate.transpose(1, 2)
        loss = trainer.solver._loss_value(
            estimate, output.double(), mask, keep.double(), True,
            *(None if x is None else x.double() for x in (rows, weight))
        ) + penalty
        loss = loss + args.optim.svd * svd.svd_penalty(
            model, rng=types.SimpleNamespace(random=lambda: 0.))
        loss.backward()
    return loss.item(), model


def _options_profile(solver, batch, calls: int = 3) -> dict:
    """The pool's loop on `batch` (resident on the card): sample the
    negatives, a train step, the pool's update (its targets to the host),
    after a warm one. Host ms a step with and without the pool's work
    (synchronized), the SVD penalty's forward and backward alone (ms), and
    in torch.profiler the device time of a step, of the device-to-host
    copies, of the SVD penalty's forward (``bm.svd_penalty``), and the
    host time of ``bm.negative_pool`` and ``bm.sample_negatives``."""
    from torch.profiler import ProfilerActivity, profile

    from brainmagick_tpu_torch import svd
    from brainmagick_tpu_torch.dataset import to_device

    args = solver.args
    arrays = to_device(batch, solver.device, args.parallel.transfer_dtype)
    pad = torch.ones(len(batch.meg), device=solver.device)
    n_neg = args.optim.negatives

    def pooled():
        negatives = solver._sample_negatives(
            "train", arrays["features"].shape, n_neg,
            solver._effective_candidates(len(batch.meg)))
        out = solver.step(arrays, pad, True, *negatives, return_output=True)
        solver._update_negative_pool("train", out["output"])

    def timed(fn, runs=calls) -> float:
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pooled()
    negatives = solver._sample_negatives(
        "train", arrays["features"].shape, n_neg,
        solver._effective_candidates(len(batch.meg)))
    step_ms = timed(lambda: solver.step(arrays, pad, True, *negatives))
    pooled_ms = timed(pooled)

    def penalty():
        solver.model.zero_grad(set_to_none=True)
        svd.svd_penalty(solver.model, rng=types.SimpleNamespace(
            random=lambda: 0.)).backward()
    penalty_ms = timed(penalty, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            pooled()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type != torch.autograd.DeviceType.CPU]

    def host_ms(name):
        return sum(e.cpu_time_total for e in events if e.key == name) \
            / calls / 1e3
    return dict(
        step_ms=step_ms, pooled_ms=pooled_ms, penalty_ms=penalty_ms,
        device_ms=sum(device_us(e) for e in device) / calls / 1e3,
        d2h_ms=sum(device_us(e) for e in device if "DtoH" in e.key)
        / calls / 1e3,
        h2d_ms=sum(device_us(e) for e in device if "HtoD" in e.key)
        / calls / 1e3,
        svd_forward_ms=sum(device_us(e, own=False) for e in events
                           if e.key == "bm.svd_penalty") / calls / 1e3,
        pool_host_ms=host_ms("bm.negative_pool"),
        sample_host_ms=host_ms("bm.sample_negatives"))


def run_options_phase(device: torch.device, card_name: str, work: Path
                      ) -> tuple:
    """Phase 16: ``train.main`` of each OPTIONS_RUNS entry on the kept
    gwilliams2022 tree in `work`. Run 1: the options in the model (9
    LayerScales, 10 fused layers with rewrite convs, ChannelDropout, the
    "btc" layout), conv_stats 10 times a train step (bf16 on "tc"),
    normalize once a forward, nt_matmul in the test stage; its pool at
    its size; a B=HELD_B step with fp32 compute on the card against the
    CPU at STEP_TOL from the same weights, dropout draws and negatives;
    the SVD penalty of the trained model on the card against the CPU
    (SVD_TOL); the pool's and the penalty's cost (``_options_profile``).
    Run 2: the projection (``linear_gt`` beside ``linear_est``) trained,
    in the checkpoint's best state under ``loss.``, nt_matmul never; the
    XP evaluated by signature, scoring through the projection (nt_matmul
    never). Returns ({path: launch counts}, {path: ``check_cli_shapes``
    arguments})."""
    from brainmagick_tpu_torch import dataset, svd
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.models.common import ChannelDropout, \
        LayerScale
    from brainmagick_tpu_torch.train import parse_overrides

    studies = {KEPT_STUDY: work / KEPT_STUDY}
    common = [*OPTIONS_COMMON, f"cache={work}/cache_{KEPT_STUDY}",
              f"out_dir={work}/outputs"]
    out, shapes = {}, {}
    argv = [*common, *OPTIONS_RUNS["options_train"]]
    with env.temporary(studies=studies):
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, "options_train", card_name)
    args = parse_overrides(argv)
    solver = spy.solver
    model = solver.model
    encoder = model.encoders["meg"]
    structure = dict(
        fused=sum(encoder.fused),
        layer_scales=sum(isinstance(m, LayerScale)
                         for m in encoder.modules()),
        channel_dropout=isinstance(model.channel_dropout, ChannelDropout),
        layout=model.output_layout,
        pool=len(solver.negative_pool["train"]),
        pool_size=solver.negative_pool_size)
    steps = _check_cli_launches("options_train", launches, routes, by_dtype,
                                spy, "bfloat16")
    pool_size = 2 * args.optim.negatives
    want = dict(fused=10, layer_scales=9, channel_dropout=True,
                layout="btc", pool_size=pool_size,
                pool=min(pool_size, args.optim.batch_size * steps))
    if structure != want:
        raise AssertionError(f"options_train: {structure}, want {want}")
    history = _read_history(Path(args.xp_folder), 1, "options_train")
    step_ms = spy.train_step_ms()
    print(f"options_train ({card_name}): {structure}; train step device "
          f"time {[round(x, 2) for x in step_ms]} ms over {steps} steps "
          f"(warm {step_ms[-1]:.2f}), peak device memory {peak_gb:.2f} GB, "
          f"run {wall:.1f} s; history {history}")
    out["options_train"] = launches
    shapes["options_train"] = dict(
        batch=args.optim.batch_size, n_test=len(solver.datasets.test),
        n_mels=solver.used_features["MelSpectrum"].n_mels, channels=208)

    loader = iter(solver.make_loader(solver.datasets.train))
    batch = next(loader)[0]
    loader.close()
    t0 = time.perf_counter()
    small = types.SimpleNamespace(**{
        name: getattr(batch, name)[:HELD_B] for name in dataset.ARRAY_FIELDS})
    n_extra = args.optim.negatives - HELD_B
    rows = solver.negative_pool["train"][:n_extra].copy()
    weight = np.ones(n_extra, np.float32)
    rows[-4:], weight[-4:] = 0., 0.          # the pool's zero padding
    held_args = parse_overrides(argv + ["simpleconv.dtype=None",
                                        "simpleconv.output_dtype=None",
                                        "clip.compute_dtype=None"])
    widths = (model.in_channels["meg"], model.out_channels,
              1 + max(d.recording.subject_index
                      for d in solver.datasets.train.datasets))
    norm_arrays = {k: v.cpu() for k, v in solver.norm_arrays.items()}
    for float64 in (False, True):
        card, cpu = (_options_held_step(where, held_args, widths,
                                        norm_arrays, small, (rows, weight),
                                        float64)
                     for where in (device, "cpu"))
        errors, note = _step_errors(card, cpu, False, OPTIONS_LEAVES)
        print(f"options_train B={HELD_B} "
              + ("in float64" if float64 else "with fp32 compute")
              + f", {n_extra} negatives (4 zero-weight) against the CPU: "
              + ", ".join(f"{key} {value:.2e}"
                          for key, value in errors.items())
              + f" (tol {STEP_TOL:.2e}"
              + ("" if float64 else "; the loss held, the gradients shown")
              + f"; {note}; {time.perf_counter() - t0:.1f} s)")
        # in fp32 the rewrite's ReLU (relu_leakiness 0) flips within
        # rounding, which moves the early layers' gradients by 1e-3 of
        # their size between any two summation orders, the CPU's at 1 and
        # 8 threads too (scripts/torch_options_conditioning.py): the
        # gradients are held in float64, as phase 12 holds ConvRNN's
        _check_errors(errors if float64 else {"loss": errors["loss"]},
                      STEP_TOL, "options train step")
        del card, cpu

    always = types.SimpleNamespace(random=lambda: 0.)
    with torch.no_grad():
        on_card = svd.svd_penalty(model, rng=always).item()
        on_cpu = svd.svd_penalty(copy.deepcopy(model).cpu(),
                                 rng=always).item()
    err = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"options_train SVD penalty over "
          f"{len(list(svd.iter_weight_matrices(model)))} matrices: card "
          f"{on_card:.6f}, CPU {on_cpu:.6f}, relative {err:.2e} (tol "
          f"{SVD_TOL:.0e})")
    if not err <= SVD_TOL:
        raise AssertionError(f"SVD penalty, card vs CPU: {err}")
    cost = _options_profile(solver, batch)

    def share(part: str, whole: str) -> str:
        return f"{cost[part]:.3f} ms ({cost[part] / cost[whole]:.1%})" \
            if cost[whole] else f"{cost[part]:.3f} ms"
    print(f"options_train B=256 pool and penalty cost ({card_name}): a "
          f"step {cost['step_ms']:.2f} ms, with the pool's sampling and "
          f"update {cost['pooled_ms']:.2f} ms (host clock, synchronized); "
          f"the penalty's forward and backward alone "
          f"{share('penalty_ms', 'step_ms')} of a step; in torch.profiler "
          f"a pooled step {cost['device_ms']:.2f} ms of device time, "
          f"device-to-host copies {share('d2h_ms', 'device_ms')}, "
          f"host-to-device {cost['h2d_ms']:.3f} ms, the penalty's forward "
          f"{share('svd_forward_ms', 'device_ms')}, host time of the "
          f"pool's update {share('pool_host_ms', 'pooled_ms')} of the "
          f"pooled step, of the sampling {cost['sample_host_ms']:.2f} ms")
    del solver, spy, model, encoder, batch
    torch.cuda.empty_cache()

    argv = [*common, *OPTIONS_RUNS["options_linear"]]
    with env.temporary(studies=studies):
        launches, routes, by_dtype, spy, wall, peak_gb = run_cli(
            argv, "options_linear", card_name)
    args = parse_overrides(argv)
    clip = spy.solver.clip_loss
    steps = _check_cli_launches("options_linear", launches, routes,
                                by_dtype, spy, "bfloat16", scored=False)
    checkpoint = torch.load(Path(args.xp_folder) / "checkpoint-torch.pt",
                            map_location="cpu", weights_only=True)
    keys = sorted(k for k in checkpoint["best_state"]
                  if k.startswith("loss."))
    if clip.linear_gt is None or keys != [
            f"loss.{n}.{p}" for n in ("linear_est", "linear_gt")
            for p in ("bias", "weight")] \
            or clip.linear_est.weight.device.type != device.type:
        raise AssertionError(f"options_linear: projection {clip}, best "
                             f"state's loss keys {keys}")
    history = _read_history(Path(args.xp_folder), 1, "options_linear")
    shape = tuple(clip.linear_est.weight.shape)
    print(f"options_linear ({card_name}): the projection {shape} x 2 "
          f"trained over {steps} steps, "
          f"run {wall:.1f} s, peak device memory {peak_gb:.2f} GB; "
          f"history {history}")
    out["options_linear"] = launches
    del spy, clip, checkpoint
    xp = dict(sig=args.sig, out_dir=args.out_dir, cache=args.cache)
    evaluated = eval_by_sig(xp, "options_linear", card_name, studies,
                            kernel_scoring=False)
    out["options_eval_sig"] = evaluated["launches"]
    torch.cuda.empty_cache()
    return out, shapes



#: phase 17: the serving export (``serve.main`` in this process) of phase
#: 8's two XPs and of a converted reference checkpoint; each artifact is
#: loaded and called in a fresh process at these batch sizes
EXPORT_BATCHES = (2, 256)
#: the artifact's forward against Solver.forward_batch, a share of max|x|
EXPORT_TOL = 1e-6
#: the artifact's probabilities against Server.probabilities, absolute
EXPORT_PROBS_TOL = 1e-5
#: the unfused paper-width XP of phase 17's reference-named checkpoint
#: (phase 8's data without fused_conv_bn), and the seed of the model that
#: writes the checkpoint
CONVERT_ARGS = ("preset=clip_conv", 'dset.selections=["fake"]',
                'dset.features=["MelSpectrum"]', "optim.batch_size=64")
CONVERT_SEED = 7
#: a fresh process: for each job of the JSON file (forward and scorer
#: artifacts, a batches' file, an output file) loads the artifacts (each
#: job's load timed, the first one's imports included) and calls them at
#: each batch size of the batches' file (launches counted per call; again
#: with TF32 on, as the caller may leave it; and the module once without
#: call_exported under TF32), writes the results and prints one JSON line
ARTIFACT_CHILD = r"""
import json, sys, time, types
import numpy as np
import torch
from brainmagick_tpu_torch import ops, serve

cuda = torch.cuda.is_available()
backends = (torch.backends.cuda.matmul, torch.backends.cudnn)
reports = {}


def counted(launches, name, fn):
    ops.reset_launch_counts()
    result = fn()
    if cuda:
        torch.cuda.synchronize()
    launches[name] = {k: v for k, v in ops.launch_counts().items()
                      if "." not in k}
    return result


for what, job in json.loads(open(sys.argv[1]).read()).items():
    t0 = time.perf_counter()
    module = serve.load_exported(job["forward"]).module()
    scorer = serve.load_exported(job["scores"]).module()
    load_s = time.perf_counter() - t0
    data = np.load(job["batches"])
    specs = [node.meta["val"] for node in serve._placeholders(module)]
    out, launches, tf32_same, tf32_raw = {}, {}, {}, {}
    for b in sorted({int(k.split("_")[0]) for k in data.files}):
        batch = types.SimpleNamespace(**{n: data[f"{b}_{n}"]
                                         for n in serve.ARG_FIELDS})
        results = list(counted(launches, f"forward {b}",
                               lambda: serve.call_exported(module, batch)))
        results.append(counted(launches, f"scores {b}",
                               lambda: serve.call_exported(
                                   scorer, results[0], results[1])))
        flags = [x.allow_tf32 for x in backends]
        for x in backends:
            x.allow_tf32 = True
        try:
            again = list(serve.call_exported(module, batch))
            again.append(serve.call_exported(scorer, again[0], again[1]))
            args = [torch.from_numpy(data[f"{b}_{n}"]).to(spec.device)
                    for n, spec in zip(serve.ARG_FIELDS, specs)]
            with torch.no_grad():
                raw = module(*args)[0]
        finally:
            for x, flag in zip(backends, flags):
                x.allow_tf32 = flag
        tf32_same[b] = all(torch.equal(x, y)
                           for x, y in zip(results, again))
        tf32_raw[b] = float((raw.float() - results[0].float()).abs().max())
        for name, value in zip(("estimate", "output", "mask", "keep",
                                "probs"), results):
            out[f"{b}_{name}"] = (value.float() if value.is_floating_point()
                                  else value).cpu().numpy()
    np.savez(job["out"], **out)
    reports[what] = dict(load_s=load_s, launches=launches,
                         tf32_same=tf32_same, tf32_raw=tf32_raw,
                         dtypes=[str(spec.dtype) for spec in specs])
print(json.dumps(dict(reports=reports, model_code=sorted(
    m for m in sys.modules if m.split(".")[:2] in (
        ["brainmagick_tpu_torch", "models"],
        ["brainmagick_tpu_torch", "solver"])))))
"""


def _relative_err(got: np.ndarray, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in fp32 on the host."""
    want = want.detach().float().cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _sum_counts(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def export_xp(device: torch.device, card_name: str, work: Path, xp: dict,
              what: str) -> dict:
    """``serve.main`` on the XP `xp` in this process (export, save, reload,
    self-check at B=2 and 5: normalize 5 launches, nt_matmul and inv_norms 4
    each on the fast route, conv_stats none), and EXPORT_BATCHES of its
    data written for the artifact's process. Returns the job: the
    artifacts, the batches' and output files, the solver, its batches,
    serve.main's launches and whether its scorer takes the fast route."""
    from brainmagick_tpu_torch import losses, ops, play, serve
    from brainmagick_tpu_torch.env import env

    with env.temporary(cache=xp["cache"]):
        synchronize(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = serve.main([f"sig={xp['sig']}", f"out_dir={xp['out_dir']}",
                             f"device={device}"])
        synchronize(device)
        main_s = time.perf_counter() - t0
        launches = kernel_launches(ops.launch_counts())
        solver = play.get_solver_from_sig(
            xp["sig"], out_dir=xp["out_dir"],
            override_args={"device": str(device)})
    fast = losses.int8_retrieval_ok(solver.clip_loss)
    # export_scores' eager forward; at each of the self-check's two sizes
    # the artifact's and the solver's forward, the artifact's and the
    # eager scorer
    want = dict(normalize_clamp_peak=5, nt_matmul=4 if fast else 0,
                conv_stats=0, inv_norms=4 if fast else 0)
    if launches != want:
        raise AssertionError(f"serve.main {what} launched {launches}, "
                             f"want {want}")
    seconds = ", ".join(f"{k} {v:.2f} s"
                        for k, v in result["seconds"].items())
    print(f"serve.main {what} ({card_name}): {seconds}, artifacts "
          f"{result['forward'].stat().st_size / 1e6:.1f} + "
          f"{result['scores'].stat().st_size / 1e6:.2f} MB, the call "
          f"{main_s:.1f} s with its self-check at B=2 and 5; launches "
          f"{launches}")
    batches = {b: serve.example_batch(solver, b) for b in EXPORT_BATCHES}
    job = dict(forward=str(result["forward"]), scores=str(result["scores"]),
               batches=str(work / f"{what}_batches.npz"),
               out=str(work / f"{what}_out.npz"))
    np.savez(job["batches"], **{
        f"{b}_{name}": np.asarray(getattr(batch, name))
        for b, batch in batches.items() for name in serve.ARG_FIELDS})
    return dict(job=job, solver=solver, batches=batches, launches=launches,
                fast=fast)


def run_artifacts(card_name: str, work: Path, exported: dict) -> dict:
    """One fresh process (ARTIFACT_CHILD) over every exported XP's
    artifacts; each call's launches (normalize 1 a forward, nt_matmul 1 a
    scorer call on the fast route, conv_stats never), no model code
    imported, the same bits with the caller's TF32 on; its outputs against
    Solver.forward_batch (EXPORT_TOL of max|x|) and Server.probabilities
    (EXPORT_PROBS_TOL). Returns each XP's launches in that process."""
    from brainmagick_tpu_torch import serve

    jobs = work / "artifact_jobs.json"
    jobs.write_text(json.dumps({what: e["job"]
                                for what, e in exported.items()}))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, str(jobs)],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    child_s = time.perf_counter() - t0
    if child.returncode:
        raise AssertionError(f"the artifacts' process exited "
                             f"{child.returncode}:\n{child.stderr[-3000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    if report["model_code"]:
        raise AssertionError(f"the artifacts' process imported "
                             f"{report['model_code']}")
    out = {}
    for what, e in exported.items():
        rep, solver = report["reports"][what], e["solver"]
        got = np.load(e["job"]["out"])
        calls = []
        for b, batch in e["batches"].items():
            counts = rep["launches"][f"forward {b}"], \
                rep["launches"][f"scores {b}"]
            if counts != (dict(normalize_clamp_peak=1, nt_matmul=0,
                               conv_stats=0, inv_norms=0),
                          dict(normalize_clamp_peak=0,
                               nt_matmul=int(e["fast"]), conv_stats=0,
                               inv_norms=int(e["fast"]))):
                raise AssertionError(f"{what} artifacts at B={b} launched "
                                     f"{counts}")
            calls += counts
            est, output, mask, keep = solver.forward_batch(batch)
            errs = dict(estimate=_relative_err(got[f"{b}_estimate"], est),
                        output=_relative_err(got[f"{b}_output"], output))
            probs = serve.Server.probabilities(
                types.SimpleNamespace(clip=solver.clip_loss,
                                      device=solver.device), est, output)
            errs["probs"] = float(np.abs(got[f"{b}_probs"]
                                         - probs.cpu().numpy()).max())
            same = (np.array_equal(got[f"{b}_mask"], mask.cpu().numpy())
                    and np.array_equal(got[f"{b}_keep"], keep.cpu().numpy()))
            tf32_same, tf32_raw = rep["tf32_same"][str(b)], \
                rep["tf32_raw"][str(b)]
            print(f"{what} artifacts in a fresh process, B={b}: max|x - "
                  f"solver| / max|x| estimate {errs['estimate']:.2e}, "
                  f"output {errs['output']:.2e} (limit {EXPORT_TOL:.0e}); "
                  f"probabilities against Server.probabilities "
                  f"{errs['probs']:.2e} (limit {EXPORT_PROBS_TOL:.0e}); mask "
                  f"and keep equal {same}; with the caller's TF32 on the "
                  f"same bits {tf32_same}, the module called without "
                  f"call_exported {tf32_raw:.2e} off")
            if not (errs["estimate"] <= EXPORT_TOL
                    and errs["output"] <= EXPORT_TOL
                    and errs["probs"] <= EXPORT_PROBS_TOL and same
                    and tf32_same):
                raise AssertionError(f"{what} artifacts at B={b}: {errs}, "
                                     f"mask and keep equal {same}, TF32 "
                                     f"{tf32_same}")
        print(f"{what} artifacts loaded in {rep['load_s']:.2f} s "
              f"({card_name}); inputs {rep['dtypes']}")
        out[what] = calls
    print(f"the artifacts' process ({card_name}): {child_s:.1f} s for "
          f"{len(exported)} XPs, no model code imported")
    return out


def time_artifact(device: torch.device, card_name: str, e: dict,
                  what: str) -> None:
    """The warm forward at the largest EXPORT_BATCHES through the artifact
    and Solver.forward_batch in turns (artifact, solver, solver,
    artifact; CUDA events): with the host batch in, with the batch already
    on the card, and each one call's device time in torch.profiler."""
    from brainmagick_tpu_torch import serve
    from brainmagick_tpu_torch.dataset import to_device

    module = serve.load_exported(e["job"]["forward"]).module()
    solver = e["solver"]
    host = e["batches"][EXPORT_BATCHES[-1]]
    resident = to_device(host, device)
    args = [resident[name].to(node.meta["val"].dtype)
            for name, node in zip(serve.ARG_FIELDS,
                                  serve._placeholders(module))]
    calls = {("host", "artifact"): lambda: serve.call_exported(module, host),
             ("host", "solver"): lambda: solver.forward_batch(host),
             ("card", "artifact"): lambda: serve.call_exported(module, *args),
             ("card", "solver"): lambda: solver.forward_batch(
                 types.SimpleNamespace(**resident))}
    for source in ("host", "card"):
        times: dict = {"artifact": [], "solver": []}
        for name in ("artifact", "solver", "solver", "artifact"):
            times[name].append(median_ms(calls[source, name], runs=5))
        device_ms = {name: sum(us for _, _, us in device_rows(
            calls[source, name], 2)) / 1e3 for name in times}
        print(f"{what} warm B={EXPORT_BATCHES[-1]} forward, batch on the "
              f"{source} ({card_name}, CUDA events, in turns): the artifact "
              f"{' / '.join(f'{t:.2f}' for t in times['artifact'])} ms, "
              f"Solver.forward_batch "
              f"{' / '.join(f'{t:.2f}' for t in times['solver'])} ms; device "
              f"time of one call {device_ms['artifact']:.2f} against "
              f"{device_ms['solver']:.2f} ms (torch.profiler)")
    del module, resident, args
    torch.cuda.empty_cache()


def convert_reference(device: torch.device, card_name: str, work: Path
                      ) -> dict:
    """A reference-named checkpoint of a seeded paper-width unfused
    clip_conv model (``convert.export_state_dict``, BatchNorm statistics
    drawn as build_server does), saved as ``{"best_state": ...}``, through
    ``convert.main`` into the XP of CONVERT_ARGS; that XP's weights by
    signature must equal the source's bit for bit, and export again to the
    same state dict. Returns the XP."""
    from brainmagick_tpu_torch import convert, play, train
    from brainmagick_tpu_torch.env import env

    common = [*CONVERT_ARGS, f"cache={work}/cache",
              f"out_dir={work}/outputs", f"device={device}"]
    source_args = train.parse_overrides(common + [f"seed={CONVERT_SEED}"])
    with env.temporary_from_args(source_args):
        source = train.get_solver(source_args, training=False)
    rng = np.random.RandomState(CONVERT_SEED)
    with torch.no_grad():
        for module in source.model.modules():
            if isinstance(module, torch.nn.BatchNorm1d):
                shape = module.running_mean.shape
                module.running_mean.copy_(torch.from_numpy(
                    (rng.randn(*shape) * 0.1).astype(np.float32)))
                module.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, shape).astype(np.float32)))
    state = convert.export_state_dict(source.model)
    path = work / "reference_checkpoint.th"
    torch.save({"best_state": state, "history": []}, path)
    t0 = time.perf_counter()
    convert.main([f"in={path}", *common])
    convert_s = time.perf_counter() - t0
    args = train.parse_overrides(common)
    with env.temporary_from_args(args):
        restored = play.get_solver_from_sig(
            args.sig, out_dir=args.out_dir,
            override_args={"device": str(device)})
    ours = source.model.state_dict()
    theirs = restored.model.state_dict()
    again = convert.export_state_dict(restored.model)
    differ = [k for k in ours if not torch.equal(ours[k].cpu(),
                                                 theirs[k].cpu())]
    differ += [k for k in state if not torch.equal(state[k], again[k])]
    if differ or sorted(again) != sorted(state) or \
            args.sig == source_args.sig:
        raise AssertionError(f"the converted XP differs from its source at "
                             f"{differ[:8]}")
    print(f"convert.main ({card_name}): {len(state)} reference tensors "
          f"({sum(v.numel() for v in state.values()) / 1e6:.2f} M values) "
          f"into {args.sig} in {convert_s:.1f} s; by signature bit-equal to "
          f"the source and exported back bit-equal")
    del source, restored
    torch.cuda.empty_cache()
    return dict(sig=args.sig, out_dir=args.out_dir, cache=args.cache)


def time_registration(device: torch.device, card_name: str) -> dict:
    """The normalize and nt_matmul wrappers at PERF.md's shapes through
    the registered op (after) and as the implementation called directly,
    which is what the wrapper ran before the registration (before), in
    turns (before, after, after, before). Returns {kernel name: times}."""
    from brainmagick_tpu_torch.ops import matmul, norm

    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    full = (REQUESTS[0], C, T)
    meg, center, scale, _ = _norm_case(full, torch.float32, device, gen)
    rec = torch.arange(full[0], device=device) % NORM_RECORDINGS
    rows: dict = {"normalize_clamp_peak": {}, "nt_matmul": {}}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x = meg.to(dtype)
        cases.append(("normalize_clamp_peak", f"{list(full)} {dtype}",
                      lambda x=x: norm._normalize(x, center, scale, rec,
                                                  LIMIT, True),
                      lambda x=x: norm.normalize_clamp_peak(
                          x, center, scale, LIMIT, rec=rec)))
    bank = torch.randn((N_CANDIDATES, SCORE_K), generator=gen,
                       device=device)
    preds = torch.randn((REQUESTS[0], SCORE_K), generator=gen, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = preds.to(dtype), bank.to(dtype)
        cases.append(("nt_matmul", f"{REQUESTS[0]} x {N_CANDIDATES} x "
                      f"{SCORE_K} {dtype}",
                      lambda a=a, b=b: matmul._nt_matmul(a, b),
                      lambda a=a, b=b: matmul.nt_matmul(a, b)))
    for name, label, before, after in cases:
        times = [median_ms(fn) for fn in (before, after, after, before)]
        rows[name][label] = dict(before_ms=[times[0], times[3]],
                                 after_ms=[times[1], times[2]])
        print(f"{name} {label} ({card_name}): before the registration "
              f"{times[0]:.4f} / {times[3]:.4f} ms, through the registered "
              f"op {times[1]:.4f} / {times[2]:.4f} ms")
    del bank, preds, meg
    torch.cuda.empty_cache()
    return rows


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_serve_phase(device: torch.device, card_name: str, work: Path,
                    xps: dict) -> tuple:
    """Phase 17: ``serve.main`` on phase 8's fp32 XP (export_train) and
    its clip_conv_tpu XP (export_recipe), then a reference checkpoint
    through ``convert.main`` and ``serve.main`` (export_convert); every
    artifact called in one fresh process (``run_artifacts``); the first
    two timed against their solvers; the wrappers' times before and after
    the registration. Returns the launch counts by path (serve.main's and
    the artifacts' process's), the artifact calls' kernel shapes and the
    registration times."""
    exported = {what: export_xp(device, card_name, work, xps[name], what)
                for what, name in (("export_train", "cli_train"),
                                   ("export_recipe", "cli_recipe"))}
    converted = convert_reference(device, card_name, work)
    exported["export_convert"] = export_xp(device, card_name, work,
                                           converted, "export_convert")
    calls = run_artifacts(card_name, work, exported)
    for what in ("export_train", "export_recipe"):
        time_artifact(device, card_name, exported[what], what)
    out = {what: _sum_counts(e["launches"], *calls[what])
           for what, e in exported.items()}
    del exported
    torch.cuda.empty_cache()
    b = EXPORT_BATCHES[-1]
    shapes = {"export": dict(batch=b, n_test=b, n_mels=120, n_cand=b,
                             with_conv=False)}
    return out, shapes, time_registration(device, card_name)

#: phase 18: the rest of the model zoo and int8 pools. Each SimpleConv
#: option trained ZOO_STEPS Adam steps at the clip_conv preset's full width
#: on phase 5's B=256 batch, in fp32 and in the clip_conv_tpu recipe, both
#: with fused_conv_bn
ZOO_RUNS = {"merger_per_subject": dict(merger_per_subject=True),
            "dual_path": dict(dual_path=1),
            "n_fft": dict(n_fft=16)}
ZOO_STEPS = 3
#: the first DualPathRNN LSTM's recurrent kernel, held with HELD_LEAVES
ZOO_LSTM_LEAVES = ("dual_path_rnn.lstms.0.cells.0.hidden.i",)
#: the spectrogram branch's first encoder layer at n_fft=16: 270 merged
#: channels x 9 bins x 2 parts over 48 frames of 361 samples,
#: (B, C, O, T, dilation, k)
STFT_CONV = (TRAIN_B, 270 * 9 * 2, 320, 48, 1, 3)
#: the int8 score chunk timed: the evaluation's prediction chunk against a
#: candidate block at the scored K, and the H100's dense int8 tensor-core
#: peak (NVIDIA's data sheet, SXM part), operations/s
INT8_CHUNK = (EVAL_CHUNK, EVAL_CHUNK, SCORE_K)
INT8_OPS = 1979e12
#: the strided DeepMel, run forward and backward at the DeepMel cell's
#: targets [B, 120 mels, T'] on the card against the CPU (the JAX solver
#: fails on its shortened targets, so no train step runs it)
DEEPMEL_STRIDE = 2


def _part_ms(fn) -> tuple:
    """(device ms of one call of `fn` in torch.profiler, its activities)."""
    rows = device_rows(fn, calls=2)
    return sum(us for _, _, us in rows) / 1e3, rows


def zoo_split(device: torch.device, trainer, batch, option: str) -> dict:
    """The option's part of a train step: the step's device time in
    torch.profiler, and its part's forward and backward alone at the
    step's shapes (dual_path: the DualPathRNN's LSTMs; n_fft: the rfft
    branch and the strided head; merger_per_subject: the heads' gather,
    scores, softmax and the mixing einsum) by CUDA events and its kernels
    in torch.profiler, each as a share of the step."""
    from brainmagick_tpu_torch.precision import einsum_fp32, exact_fp32

    model = trainer.model
    dt = model.compute_dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(SEED + 18)

    def fwd_bwd(fn, shape, dtype):
        x = torch.randn(shape, generator=gen, device=device).to(
            dtype).requires_grad_()

        def run():
            fn(x).float().sum().backward()
        return run

    parts = {}
    if option == "dual_path":
        parts["LSTMs"] = fwd_bwd(model.dual_path_rnn, (TRAIN_B, 320, T), dt)
    elif option == "n_fft":
        # the subject layers hand the branch fp32; the head reads the 1x1
        # conv's activation in the compute dtype
        parts["rfft branch"] = fwd_bwd(model._stft, (TRAIN_B, 270, T),
                                       torch.float32)
        parts["strided head"] = fwd_bwd(model.final[2],
                                        (TRAIN_B, 640, STFT_CONV[3]), dt)
    else:
        def attend(meg):
            weights = model.merger.attention(
                positions, pos_emb=pos_emb, dtype=meg.dtype,
                subjects=subjects, center=torch.full((2,), 0.5))
            return einsum_fp32("bct,boc->bot", meg, weights, dtype=meg.dtype)
        rec = torch.as_tensor(batch.recording_index, device=device).long()
        subjects = torch.as_tensor(batch.subject_index, device=device).long()
        positions = torch.as_tensor(batch.positions, device=device)
        pos_emb = trainer.solver.norm_arrays["pos_emb"][rec]
        parts["heads' gather and einsum"] = fwd_bwd(attend, (TRAIN_B, C, T),
                                                    dt)
    step_ms, rows = _part_ms(lambda: trainer.step(batch))
    out = {"step_device_ms": step_ms}
    for name, fn in parts.items():
        # fp32 as the step runs it (cuDNN's LSTM would take TF32 outside);
        # CUDA events time the part, the profiler names its kernels (it
        # has been seen to miss a call's cuDNN kernels)
        with exact_fp32():
            part_ms = median_ms(fn, runs=5)
            traced_ms, part_rows = _part_ms(fn)
        out[f"{name} ms"] = part_ms
        out[f"{name} share"] = part_ms / step_ms
        print(f"  {option} {name}: forward and backward {part_ms:.2f} ms "
              f"(CUDA events; {traced_ms:.2f} ms of kernels in "
              f"torch.profiler), {100 * part_ms / step_ms:.1f}% of a step's "
              f"{step_ms:.2f} ms of device time; its longest kernels: "
              + "; ".join(f"{key[:60]} {us / 1e3:.3f} ms"
                          for key, _, us in part_rows[:3]))
    model.zero_grad(set_to_none=True)
    if option == "n_fft":
        frames = model._stft(torch.zeros((1, 270, T), device=device)).shape
        weight = model.encoders["meg"].sequence[0][0].weight.shape
        print(f"  n_fft: the branch gives {tuple(frames)} a sample; the "
              f"first encoder layer's weight {tuple(weight)}")
        if (TRAIN_B, frames[1], weight[0], frames[2]) != STFT_CONV[:4]:
            raise AssertionError(f"the spectrogram layer's conv_stats shape "
                                 f"{frames}, weight {weight}; want "
                                 f"{STFT_CONV}")
    return out


@contextlib.contextmanager
def relu_masks(module: torch.nn.Module,
               masks: tp.Optional[tp.Sequence[torch.Tensor]] = None
               ) -> tp.Iterator[tp.List[torch.Tensor]]:
    """Within the block, each ``nn.ReLU`` of `module` records its mask
    (input > 0) into the list this yields, in the order the ReLUs run, or,
    given `masks`, applies the next of them in place of its own (input x
    mask, whose gradient is the mask). A ReLU's gradient steps where its
    input crosses 0, so an input within rounding of 0 flips it between two
    runs; given the same masks two runs differ only by their rounding."""
    seen: tp.List[torch.Tensor] = []

    def hook(_, inputs, out):
        if masks is None:
            seen.append(inputs[0] > 0)
            return None
        mask = masks[len(seen)].to(inputs[0].device)
        seen.append(mask)
        return inputs[0] * mask

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.ReLU)]
    try:
        yield seen
    finally:
        for handle in handles:
            handle.remove()


def check_strided_deepmel(device: torch.device, card_name: str) -> None:
    """The strided DeepMel (published widths, stride DEEPMEL_STRIDE) in
    train mode at [TRAIN_B, 120, T'] forward and backward on the card,
    against the same module and inputs on the CPU, each max error over its
    max magnitude within STEP_TOL: the fp32 output and running variance;
    the fp32 input's and first conv's gradients against the CPU's fp32
    run on the card's ReLU masks (``relu_masks``); and the same gradients
    in float64. Against the CPU's own masks the fp32 gradients part where
    a ReLU's input lies within rounding of 0 (one such element moves them
    by up to 1e-2 of their largest: scripts/torch_deepmel_relu_flips.py),
    so those, the flips and each run against float64 are printed."""
    from brainmagick_tpu_torch.models.features import DeepMel
    from brainmagick_tpu_torch.precision import exact_fp32

    t_in = T - 18
    rng = np.random.RandomState(SEED + 18)
    x0 = rng.randn(TRAIN_B, 120, t_in).astype(np.float32)

    def run(where, dtype=torch.float32, masks=None):
        fm = DeepMel(n_in_channels=120, stride=DEEPMEL_STRIDE)
        fm.reset_parameters(torch.Generator().manual_seed(SEED))
        fm = fm.to(where, dtype).train()
        x = torch.from_numpy(x0).to(where, dtype).requires_grad_()
        t0 = time.perf_counter()
        with relu_masks(fm, masks) as seen:
            y = fm(x)
        cot = torch.from_numpy(np.random.RandomState(SEED + 19).randn(
            *y.shape).astype(np.float32)).to(where, dtype)
        (y * cot).sum().backward()
        synchronize(torch.device(where))
        ms = (time.perf_counter() - t0) * 1e3
        return ms, dict(output=y.detach().cpu(), dx=x.grad.cpu(),
                        dw=fm.sequence[0][0].weight.grad.cpu(),
                        running_var=fm.sequence[0][1].running_var.cpu(),
                        masks=[m.cpu() for m in seen])

    def err(got, want):
        return ((got.double() - want.double()).abs().max()
                / want.double().abs().max()).item()

    with exact_fp32():
        run(device)
        card_ms, card32 = run(device)
        _, card64 = run(device, torch.float64)
    cpu_ms, cpu32 = run("cpu")
    _, cpu_card_masks = run("cpu", masks=card32["masks"])
    _, cpu64 = run("cpu", torch.float64)
    errors = {key: err(card32[key], cpu32[key])
              for key in ("output", "running_var")}
    errors.update({f"{key} on the card's masks": err(card32[key],
                                                     cpu_card_masks[key])
                   for key in ("dx", "dw")})
    errors.update({f"{key} float64": err(card64[key], cpu64[key])
                   for key in ("dx", "dw")})
    own = {f"{key} {where}": err(grads[key], want[key])
           for key in ("dx", "dw")
           for where, grads, want in (("card vs CPU fp32", card32, cpu32),
                                      ("card vs float64", card32, cpu64),
                                      ("CPU vs float64", cpu32, cpu64))}
    flips = {where: [int((a != b).sum()) for a, b in zip(
        grads["masks"], cpu64["masks"])]
        for where, grads in (("card", card32), ("CPU", cpu32))}
    print(f"strided DeepMel (stride {DEEPMEL_STRIDE}) [{TRAIN_B}, 120, "
          f"{t_in}] -> {tuple(card32['output'].shape)}: forward and "
          f"backward {card_ms:.2f} ms on the card (host clock, warm), "
          f"{cpu_ms:.0f} ms on the CPU; against the CPU " + ", ".join(
              f"{k} {v:.2e}" for k, v in errors.items())
          + f" (tol {STEP_TOL}); the fp32 gradients on their own ReLU "
          f"masks: " + ", ".join(f"{k} {v:.2e}" for k, v in own.items())
          + f"; ReLU inputs of another sign than float64's, a layer: "
          f"{flips} ({card_name})")
    if not all(value <= STEP_TOL for value in errors.values()):
        raise AssertionError(f"strided DeepMel card vs CPU: {errors}")


def int8_reference_scores(preds: np.ndarray, trues: np.ndarray,
                          device: torch.device) -> np.ndarray:
    """The int8 scores of `preds` against the pool `trues`, computed plainly
    on `device` in one piece: the rows quantized per row
    (``losses._int8_quantize_rows``), the pool per candidate
    (``losses.quantize_candidates``), each K chunk's integer product as a
    float64 GEMM (exact: every sum stays below 2^53), rounded to fp32 and
    added in K order, times the row scales and the candidates' inverse
    norms. No int8 GEMM, layout, chunk of rows or block of candidates."""
    from brainmagick_tpu_torch import losses

    rows = torch.from_numpy(preds).to(device).reshape(len(preds), -1)
    e_q, s_e = losses._int8_quantize_rows(rows)
    del rows
    c_q = torch.from_numpy(losses.quantize_candidates(trues)).to(device)
    c_q = c_q.reshape(len(trues), -1)
    inv = losses.block_inv_norms(c_q)
    acc = None
    for lo in range(0, c_q.shape[1], losses.INT8_K_CHUNK):
        hi = lo + losses.INT8_K_CHUNK
        part = (e_q[:, lo:hi].double() @ c_q[:, lo:hi].double().T).float()
        acc = part if acc is None else acc + part
    return (acc * s_e[:, None] * inv[None, :]).cpu().numpy()


def run_int8_eval(device: torch.device, card_name: str, fp32: dict) -> dict:
    """Phase 6's evaluation data with test.pool_int8: run_eval and get_wer
    (top-1 and WER printed beside phase 6's fp32 ones; the pool's bytes
    against bf16's), each kernel's launches (normalize once a forward,
    nt_matmul and conv_stats never); the int8 scores of every prediction
    against the whole pool through the evaluation's own route and chunk
    (``losses.pool_scores``, which get_wer's pool takes too) against
    ``int8_reference_scores`` within INT8_SCORE_TOL of their largest
    magnitude, and run_eval's probabilities against their softmax within
    PROBS_TOL; HELD_PREDS predictions x HELD_CANDIDATES candidates on the
    card against the CPU (the int8 rows and the int32 partial sums
    bit-equal, the scores within INT8_SCORE_TOL, build_probs within
    PROBS_TOL); then the int8 scoring of the evaluation's chunk INT8_CHUNK
    timed beside the bf16 nt_matmul and torch.mm(out_dtype=float32), with
    its bound. Returns the launch counts of the evaluation's path."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import losses, ops, wer
    from brainmagick_tpu_torch.ops.matmul import nt_matmul

    server, rec_positions = build_server(device)
    server.args.test.pool_int8 = True
    batches = make_eval_batches(device, server.args, rec_positions)
    n_preds = EVAL_BATCHES * REQUESTS[0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results, times = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, fn in (
                ("run_eval", lambda stats: port_eval.run_eval(
                    server, batches, out_dir, stats=stats)),
                ("get_wer", lambda stats: wer.get_wer(server, batches,
                                                      stats=stats))):
            stats = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            results[name] = fn(stats)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            print(f"int8 {name}: {times[name]:.2f} s (host clock, "
                  f"synchronized), peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
                  f"transfers {stats} ({card_name})")
            results[f"{name} stats"] = stats
        probs = np.load(Path(out_dir) / "probs_segment.npy")
        _check_eval_probs(probs, (n_preds, EVAL_SEGMENTS), "int8 run_eval")
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    # inv_norms once an int8 candidate block: run_eval's pool of segments,
    # get_wer's fixed negatives
    n_fixed = min(n_preds, server.args.test.wer_negatives) - 1
    want = dict(normalize_clamp_peak=2 * EVAL_BATCHES, nt_matmul=0,
                conv_stats=0,
                inv_norms=norm_calls(EVAL_SEGMENTS) + norm_calls(n_fixed))
    print(f"int8 evaluation: kernel launches {launches}, want {want}")
    if launches != want:
        raise AssertionError(f"the int8 evaluation launched {launches}, "
                             f"want {want}")
    acc, metrics = results["run_eval"], results["get_wer"]
    k = SCORE_K
    pool_bytes = results["run_eval stats"]["pool_bytes"]
    print(f"int8 against fp32 (phase 6): top-1/5/10 {acc} against "
          f"{fp32['accuracy']}, WER {metrics} against {fp32['wer']}; the "
          f"pool {pool_bytes / 1e9:.3f} GB in int8 against "
          f"{2 * EVAL_SEGMENTS * k / 1e9:.3f} GB in bf16 and "
          f"{4 * EVAL_SEGMENTS * k / 1e9:.3f} GB in fp32")
    if pool_bytes != EVAL_SEGMENTS * k:
        raise AssertionError(f"int8 pool bytes {pool_bytes}, want "
                             f"{EVAL_SEGMENTS * k}")

    # every prediction against the whole pool, through the evaluation's
    # route at its chunk and blocks, against the plain computation
    data = port_eval.load_test_data(server, batches)
    scores = losses.pool_scores(server, server.clip, data["preds"],
                                data["trues"], chunk=EVAL_CHUNK)
    ref = int8_reference_scores(data["preds"], data["trues"], device)
    whole_err = float(np.abs(scores - ref).max() / np.abs(ref).max())
    scores -= scores.max(axis=1, keepdims=True)
    np.exp(scores, out=scores)
    scores /= scores.sum(axis=1, keepdims=True)
    whole_probs_err = float(np.abs(probs - scores).max())
    print(f"int8 {scores.shape[0]} x {scores.shape[1]} through pool_scores "
          f"(chunks of {EVAL_CHUNK} rows, blocks of "
          f"{losses.CANDIDATE_BLOCK} candidates) against the plain float64 "
          f"products: scores {whole_err:.3e} of their largest (tol "
          f"{INT8_SCORE_TOL}); run_eval's probabilities against their "
          f"softmax max|diff| {whole_probs_err:.3e} (atol {PROBS_TOL})")
    if scores.shape != (n_preds, EVAL_SEGMENTS) \
            or not whole_err <= INT8_SCORE_TOL \
            or not whole_probs_err <= PROBS_TOL:
        raise AssertionError(f"int8 evaluation scores {scores.shape}: "
                             f"{whole_err}, probs {whole_probs_err}")
    del scores, ref, probs

    # HELD_PREDS x HELD_CANDIDATES on the card against the CPU
    preds = data["preds"][:HELD_PREDS]
    trues = data["trues"][:HELD_CANDIDATES]
    reference, _ = build_server("cpu")
    reference.args.test.pool_int8 = True
    (block,) = losses.candidate_blocks(trues, None, len(trues), int8=True)
    held = []
    for where in (device, torch.device("cpu")):
        rows = torch.from_numpy(preds).to(where)
        e_q, s_e = losses._int8_quantize_rows(rows.reshape(len(rows), -1))
        c_q = block.to(where).reshape(len(block), -1)
        held.append(dict(
            rows=e_q.cpu(), scales=s_e.cpu(),
            parts=[p.cpu() for p in losses.int8_partial_sums(e_q, c_q)],
            scores=losses.retrieval_scores_int8((e_q, s_e), c_q).cpu(),
            probs=port_eval.build_probs(server if where == device
                                        else reference, preds, trues)))
    got, ref = held
    equal = {key: torch.equal(got[key], ref[key])
             for key in ("rows", "scales")}
    equal["parts"] = len(got["parts"]) == len(ref["parts"]) and all(
        torch.equal(a, b) for a, b in zip(got["parts"], ref["parts"]))
    score_err = ((got["scores"] - ref["scores"]).abs().max()
                 / ref["scores"].abs().max()).item()
    probs_err = float(np.abs(got["probs"] - ref["probs"]).max())
    print(f"int8 {HELD_PREDS} x {HELD_CANDIDATES} against the CPU: bit-equal "
          f"{equal} ({len(got['parts'])} K chunks), scores {score_err:.3e} "
          f"of their largest (tol {INT8_SCORE_TOL}), build_probs max|diff| "
          f"{probs_err:.3e} (atol {PROBS_TOL})")
    if not all(equal.values()) or score_err > INT8_SCORE_TOL \
            or probs_err > PROBS_TOL:
        raise AssertionError(f"int8 card vs CPU: {equal}, scores "
                             f"{score_err}, probs {probs_err}")
    # the pool's preparation on the host: int8 quantization (numpy, as
    # the JAX package's) against the bf16 cast
    pool = data["trues"]
    host_s = {}
    for name, kw in (("int8", dict(int8=True)),
                     ("bf16", dict(compute_dtype=torch.bfloat16))):
        t0 = time.perf_counter()
        losses.candidate_blocks(pool, **{"compute_dtype": None, **kw})
        host_s[name] = time.perf_counter() - t0
    print(f"the pool's host preparation, {len(pool)} candidates "
          f"({pool.nbytes / 1e9:.3f} GB fp32): int8 quantization "
          f"{host_s['int8']:.3f} s, bf16 cast {host_s['bf16']:.3f} s "
          f"(host clock; {card_name}'s host)")
    del server, reference, batches, data
    torch.cuda.empty_cache()

    # the evaluation's chunk: int8 against bf16 nt_matmul and cuBLAS
    m, n, k = INT8_CHUNK
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    e_q = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                        dtype=torch.int8)
    c_q = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                        dtype=torch.int8)
    s_e = torch.rand(m, generator=gen, device=device)
    inv = losses.block_inv_norms(c_q)
    # laid out once a block or a chunk, as the evaluation prepares them
    layout_ms = median_ms(lambda: losses.int8_rows(c_q))
    e_rows, c_rows = losses.int8_rows(e_q), losses.int8_rows(c_q)
    int8_ms = median_ms(lambda: losses.retrieval_scores_int8(
        (e_rows, s_e), c_rows, inv))
    parts_ms = median_ms(lambda: losses.int8_partial_sums(e_rows, c_rows))
    del e_q, c_q, e_rows, c_rows
    a = torch.randn((m, k), generator=gen, device=device).bfloat16()
    b = torch.randn((n, k), generator=gen, device=device).bfloat16()
    bf16_ms = median_ms(lambda: nt_matmul(a, b))
    mm_ms = median_ms(lambda: torch.mm(a, b.T, out_dtype=torch.float32))
    del a, b
    torch.cuda.empty_cache()
    bound_ms, bound_by = bound((m + n) * k + 4 * m * n, 2 * m * n * k,
                               INT8_OPS)
    print(f"int8 scoring {m} x {n} x {k}: {int8_ms:.3f} ms "
          f"(the int32 partial sums alone {parts_ms:.3f} ms; laying out "
          f"one operand for them, once a block, {layout_ms:.3f} ms), bf16 "
          f"nt_matmul {bf16_ms:.3f} ms, bf16 torch.mm(out_dtype=float32) "
          f"{mm_ms:.3f} ms; int8 bound {bound_ms:.3f} ms ({bound_by}, "
          f"{INT8_OPS / 1e12:.0f} TOP/s); {card_name}")
    return launches


def run_zoo_phase(device: torch.device, card_name: str, batch,
                  eval_fp32: dict, train_warm: dict,
                  recipe_warm: dict) -> tuple:
    """Phase 18: each ZOO_RUNS option trained ZOO_STEPS steps in fp32 and
    in the clip_conv_tpu recipe (``run_train`` with the option: finite,
    falling losses, conv_stats once a fused encoder layer a step,
    normalize once a forward, the fused head only in the recipe and never
    under per-subject heads, the B=8 step against the CPU, the warm step
    and peak memory, ``zoo_split``'s profile); the strided DeepMel
    against the CPU; the int8 evaluation (``run_int8_eval``). Returns the
    launch counts by path and the STFT layer's conv_stats shape for the
    kernels' other_shapes."""
    launches, warm = {}, {}
    for option, options in ZOO_RUNS.items():
        for preset in ("clip_conv", RECIPE):
            path = f"zoo_{option}" + ("_recipe" if preset == RECIPE else "")
            launches[path], _, warm[path] = run_train(
                device, card_name, batch, preset, options, ZOO_STEPS,
                inspect=lambda trainer, option=option: zoo_split(
                    device, trainer, batch, option))
    for path, entry in warm.items():
        base = recipe_warm if path.endswith("_recipe") else train_warm
        print(f"{path}: warm step {entry['step_ms']:.2f} ms against "
              f"{base['step_ms']:.2f} without the option (phase "
              f"{7 if path.endswith('_recipe') else 5}), peak "
              f"{entry['peak_gb']:.2f} GB against {base['peak_gb']:.2f}, "
              f"device time {entry['step_device_ms']:.2f} ms a step "
              f"({card_name})")
    check_strided_deepmel(device, card_name)
    launches["zoo_int8_eval"] = run_int8_eval(device, card_name, eval_fp32)
    shapes = {"zoo": dict(batch=TRAIN_B, n_test=TRAIN_B, n_mels=F,
                          with_matmul=False, convs=(STFT_CONV,))}
    return launches, shapes


#: phase 19: resuming training from the JAX package's checkpoint.pkl, the
#: notebook helpers and the native batch gather, on phase 9's
#: gwilliams2022 tree (KEPT_STUDY). The resumed XP: the clip_conv preset
#: with fused_conv_bn at the paper's width on MelSpectrum (phase 10's
#: data without DeepMel), B=256
RESUME_ARGS = ("preset=clip_conv", "simpleconv.fused_conv_bn=True",
               'dset.features=["MelSpectrum"]', "optim.batch_size=256",
               "optim.epochs=1",
               "dset.n_recordings=2", f"dset.selections=[{KEPT_STUDY!r}]")
#: Adam steps before the checkpoint, and as many after it
RESUME_STEPS = 2
#: the sentence phase 19 paints and predicts from
PREDICT_SENTENCE = "de kat slaapt in de woonkamer"
#: host-clock runs of each batch assembly the gather's timings take
GATHER_RUNS = 10


def _resume_solver(work: Path, name: str):
    """The training solver of RESUME_ARGS in ``work/resume_<name>``
    (restoring what its XP folder holds)."""
    from brainmagick_tpu_torch.train import get_solver, parse_overrides

    return get_solver(parse_overrides(
        [*RESUME_ARGS, f"cache={work}/cache_{KEPT_STUDY}",
         f"out_dir={work}/resume_{name}"]))


def _resume_steps(solver, batches: list, first: int) -> list:
    """Adam steps of `solver` on `batches` ((arrays, pad_weight) on the
    card), the dropout generator seeded SEED + the step's index from
    `first` (so that each run draws the same disks at the same step):
    the losses."""
    losses = []
    for i, (arrays, weight) in enumerate(batches):
        solver.generator.manual_seed(SEED + first + i)
        losses.append(solver.step(arrays, weight, True)["loss"].item())
    return losses


def _state_errors(got: dict, want: dict) -> dict:
    """Each floating entry of a solver's flat state against another's:
    max|diff| over max|want|, and under "whole state" the distance of
    the two states over the norm of `want` (every floating entry)."""
    errors, diff2, norm2 = {}, 0., 0.
    for key, ref in want.items():
        if ref.is_floating_point():
            ref = ref.double()
            diff = got[key].double() - ref
            scale = ref.abs().max().item()
            errors[key] = diff.abs().max().item() / (scale if scale else 1.)
            diff2 += diff.square().sum().item()
            norm2 += ref.square().sum().item()
    errors["whole state"] = math.sqrt(diff2 / norm2)
    return errors


def _adam_state(optimizer) -> list:
    """Copies of each parameter's Adam state, in the optimizer's order."""
    return [{k: v.detach().clone() for k, v in optimizer.state[p].items()}
            for group in optimizer.param_groups for p in group["params"]]


def run_resume(device: torch.device, card_name: str, work: Path) -> tuple:
    """Phase 19 (a): RESUME_ARGS trained 2 RESUME_STEPS Adam steps
    uninterrupted; the same XP in another folder trained RESUME_STEPS steps
    and written as the JAX package's ``checkpoint.pkl``
    (``convert.save_jax_checkpoint``), then resumed by a fresh solver
    (``Solver.restore``), whose weights, statistics and Adam state must be
    the written ones bit for bit, and trained RESUME_STEPS more on the
    same batches: each loss within STEP_TOL of the uninterrupted run's,
    and the whole state (weights and statistics, in norm) within STEP_TOL
    of it; conv_stats 10 times a resumed step, normalize once; its test
    stage (nt_matmul).
    Returns ({path: launch counts}, the resumed solver's train loader,
    the test split's size)."""
    from brainmagick_tpu_torch import convert, ops
    from brainmagick_tpu_torch.dataset import ARRAY_FIELDS

    t0 = time.perf_counter()
    full = _resume_solver(work, "full")
    build_s = time.perf_counter() - t0
    loader = full.loaders["train"]
    loader.set_epoch(0)
    batches = []
    for batch, weight in loader:        # the native gather, pinned, sent
        batches.append(({name: getattr(batch, name)
                         for name in ARRAY_FIELDS}, weight))
        if len(batches) == RESUME_STEPS:
            break
    batches = (batches * 2)[:2 * RESUME_STEPS]
    want_losses = _resume_steps(full, batches, 0)
    want = full._copy_params()
    del full
    first = _resume_solver(work, "split")
    _resume_steps(first, batches[:RESUME_STEPS], 0)
    written, written_adam = first._copy_params(), _adam_state(first.optimizer)
    t0 = time.perf_counter()
    path = convert.save_jax_checkpoint(first)
    save_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    del first
    t0 = time.perf_counter()
    solver = _resume_solver(work, "split")
    restore_s = time.perf_counter() - t0
    restored, adam = solver._copy_params(), _adam_state(solver.optimizer)
    differ = [k for k, v in written.items()
              if not k.endswith("num_batches_tracked")
              and not torch.equal(restored[k], v)]
    differ += [f"Adam {i} {k}" for i, (a, b) in enumerate(zip(adam,
                                                             written_adam))
               for k in b if not torch.equal(a[k].cpu(), b[k].cpu())]
    own = solver.folder / "checkpoint-torch.pt"
    if differ or len(adam) != len(written_adam) or own.exists():
        raise AssertionError(f"resume: restored state differs from the "
                             f"written one at {differ[:8]}, {len(adam)} "
                             f"Adam states against {len(written_adam)}, "
                             f"{own.name} {own.exists()}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses = _resume_steps(solver, batches[RESUME_STEPS:], RESUME_STEPS)
    torch.cuda.synchronize()
    train_launches = kernel_launches(ops.launch_counts())
    routes = dict(ops.conv_stats.launches_by_route)
    errors = {f"loss of step {RESUME_STEPS + 1 + i}": abs(a - b) / abs(b)
              for i, (a, b) in enumerate(zip(losses,
                                             want_losses[RESUME_STEPS:]))}
    state_errors = _state_errors(solver._copy_params(), want)
    whole = state_errors.pop("whole state")
    worst = max(state_errors, key=state_errors.get)
    print(f"resume from checkpoint.pkl ({card_name}): {size_mb:.1f} MB "
          f"written in {save_s:.2f} s, the resumed solver built and "
          f"restored in {restore_s:.2f} s (an uninterrupted one built in "
          f"{build_s:.2f} s), its weights, statistics and {len(adam)} Adam "
          f"states bit-equal to the written ones; uninterrupted losses "
          f"{want_losses}, resumed {losses}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in errors.items())
          + f"; the whole state against the uninterrupted run's "
          f"{whole:.2e}, the worst entry {worst} "
          f"{state_errors[worst]:.2e} of its largest; tol {STEP_TOL:.0e}; "
          f"launches over the {RESUME_STEPS} resumed steps "
          f"{train_launches}, conv_stats by route {routes}")
    _check_errors(errors, STEP_TOL,
                  "resumed losses against the uninterrupted run")
    _check_errors({"whole state": whole}, STEP_TOL,
                  "resumed state against the uninterrupted run")
    want_launches = dict(conv_stats=10 * RESUME_STEPS,
                         normalize_clamp_peak=RESUME_STEPS, nt_matmul=0,
                         inv_norms=0)
    if train_launches != want_launches or routes != {
            "tc": 10 * RESUME_STEPS}:
        raise AssertionError(f"resume: launches {train_launches}, routes "
                             f"{routes}, want {want_launches} on 'tc'")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with SolverSpy() as spy:
        t0 = time.perf_counter()
        test = solver._test_one_epoch()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
    test_launches = kernel_launches(ops.launch_counts())
    want_launches = dict(conv_stats=0, normalize_clamp_peak=spy.forwards,
                         nt_matmul=sum(spy.test_nt_matmul),
                         inv_norms=sum(spy.test_inv_norms))
    if test_launches != want_launches or test_launches["nt_matmul"] < 1 \
            or not 0 <= test["wer"] <= 1:
        raise AssertionError(f"resume test stage: {test}, launches "
                             f"{test_launches}, want {want_launches}")
    print(f"resumed test stage ({card_name}): {test} in {test_s:.2f} s; "
          f"launches {test_launches}")
    loader, n_test = solver.loaders["train"], len(solver.datasets.test)
    del solver
    torch.cuda.empty_cache()
    return ({"resume_train": train_launches, "resume_test": test_launches},
            loader, n_test)


def run_predict(device: torch.device, card_name: str, work: Path) -> tuple:
    """Phase 19 (b). On phase 11's XP (feature decoding over the word
    features) by signature: ``SentenceFeatures.from_solver`` paints
    PREDICT_SENTENCE, one ``Solver.predict`` of the test split's first
    window (its MEG and features) against the same XP on the CPU at
    REFERENCE_TOL (normalize once, no other kernel), and
    ``attention_map`` (each row a distribution over the sensors with a
    position). On phase 12's encode_simpleconv XP, whose estimate reads
    the features: ``play.predict`` of the sentence painted for its
    features over both recordings, without and with ``meg_init``
    (normalize once a ``Solver.predict``, no other kernel), each finite
    and not 0, and the two apart. Returns ({path: launch counts}, {path:
    ``check_cli_shapes`` arguments})."""
    from brainmagick_tpu_torch import ops, play
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.studies.api import INVALID_POSITION
    from brainmagick_tpu_torch.train import parse_overrides

    outputs = str(work / "outputs")
    common = [f"cache={work}/cache_{KEPT_STUDY}", f"out_dir={outputs}"]
    words_sig = parse_overrides([*WORDS_ARGS, *common,
                                 *WORDS_FALLBACK]).sig
    encode_sig = parse_overrides([*ENCODE_RUNS["encode_simpleconv"],
                                  *ENCODE_COMMON, *common]).sig
    kernels_none = dict(normalize_clamp_peak=0, conv_stats=0, nt_matmul=0,
                        inv_norms=0)
    with env.temporary(cache=work / f"cache_{KEPT_STUDY}",
                       studies={KEPT_STUDY: work / KEPT_STUDY}):
        solver = play.get_solver_from_sig(words_sig, out_dir=outputs)
        t0 = time.perf_counter()
        features = play.SentenceFeatures.from_solver(solver)(
            PREDICT_SENTENCE).astype(np.float32)
        paint_s = time.perf_counter() - t0
        if features.shape[0] != solver.used_features.dimension:
            raise AssertionError(f"predict: features {features.shape}")
        item = solver.datasets.test[0]
        window = dict(meg=item.meg, features=item.features,
                      subject_index=int(item.subject_index),
                      recording_index=int(item.recording_index))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        estimate = torch.from_numpy(solver.predict(**window))
        one = kernel_launches(ops.launch_counts())
        ms = median_ms(lambda: solver.predict(**window), runs=5)
        cpu = play.get_solver_from_sig(words_sig, out_dir=outputs,
                                       override_args={"device": "cpu"})
        reference = torch.from_numpy(cpu.predict(**window))
        held = _against_cpu("estimate", estimate, reference, REFERENCE_TOL,
                            False)
        del cpu
        t0 = time.perf_counter()
        weights, positions = play.attention_map(solver)
        attention_s = time.perf_counter() - t0
        del solver
        valid = ~(positions == INVALID_POSITION).all(-1)
        sums = (weights * valid[:, None, :]).sum(-1)
        if one != {**kernels_none, "normalize_clamp_peak": 1} \
                or estimate.shape[0] != WORDS_OUTPUTS \
                or not estimate.abs().max().item() > 0 \
                or not np.allclose(sums, 1., rtol=0, atol=1e-5) \
                or (weights.transpose(0, 2, 1)[~valid] != 0).any():
            raise AssertionError(f"Solver.predict launches {one}, estimate "
                                 f"{tuple(estimate.shape)}; attention rows "
                                 f"sum to {sums.min()}..{sums.max()}")

        encoder = play.get_solver_from_sig(encode_sig, out_dir=outputs)
        sentence = play.SentenceFeatures.from_solver(encoder)(
            PREDICT_SENTENCE).astype(np.float32)
        calls = []
        single = encoder.predict

        def counted(**kwargs):
            calls.append(kwargs["subject_index"])
            return single(**kwargs)
        encoder.predict = counted
        evoked, predict_s, launches = {}, {}, dict(kernels_none)
        for meg_init in (False, True):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            evoked[meg_init] = play.predict(encoder, sentence,
                                            meg_init=meg_init)
            torch.cuda.synchronize()
            predict_s[meg_init] = time.perf_counter() - t0
            launches = {k: v + launches[k]
                        for k, v in kernel_launches(
                            ops.launch_counts()).items()}
        channels = encoder.datasets.train[0].meg.shape[0]
        del encoder
    want = {**kernels_none, "normalize_clamp_peak": len(calls)}
    init_diff = np.abs(evoked[True] - evoked[False]).max()
    if launches != want or len(calls) != 8 or not init_diff > 0 or any(
            x.shape != evoked[False].shape or x.shape[0] != channels
            or not np.isfinite(x).all() or not np.abs(x).max() > 0
            for x in evoked.values()):
        raise AssertionError(
            f"play.predict: launches {launches}, want {want}; {len(calls)} "
            f"calls; evoked " + ", ".join(
                f"{x.shape} max|x| {np.abs(x).max()}"
                for x in evoked.values())
            + f", meg_init moves it by {init_diff}")
    print(f"predict ({card_name}): {features.shape} features of "
          f"{PREDICT_SENTENCE!r} painted in {paint_s:.3f} s; Solver.predict "
          f"of a test window ({tuple(item.meg.shape)} MEG) {ms:.2f} ms "
          f"(CUDA events, median of 5), against the CPU {held}; "
          f"attention_map {weights.shape} in {attention_s:.3f} s, rows sum "
          f"to 1 within {np.abs(sums - 1).max():.1e}; launches {one}")
    print(f"play.predict ({card_name}) on encode_simpleconv over 2 "
          f"recordings ({len(calls)} Solver.predict calls): "
          + ", ".join(f"meg_init={k} [{x.shape[0]}, {x.shape[1]}] in "
                      f"{predict_s[k]:.3f} s, max|x| {np.abs(x).max():.3e}"
                      for k, x in evoked.items())
          + f", meg_init moves it by {init_diff:.3e}; launches {launches}")
    shape = dict(batch=1, n_test=0, n_mels=1, channels=channels,
                 with_conv=False, with_matmul=False)
    torch.cuda.empty_cache()
    return ({"predict": one, "play_predict": launches},
            {"predict": {**shape, "n_times": item.meg.shape[1]},
             "play_predict": {**shape, "n_times": sentence.shape[1]}})


def _plain_gathers():
    """The plain gathers with the native ones' signatures (bf16 as torch's
    round to nearest even of the plain float32 batch)."""
    from brainmagick_tpu_torch import dataset

    def cast(out, dtype):
        return out if dtype in (None, "float32") else \
            torch.from_numpy(out).to(torch.bfloat16)

    def epochs(raw, starts, n_times, out_channels, baseline_len=0,
               dtype=None):
        return cast(dataset.gather_epochs(raw, starts, n_times,
                                          out_channels, baseline_len), dtype)

    def track(track, starts, n_times, dtype=None):
        return cast(dataset.gather_track(track, starts, n_times), dtype)
    return epochs, track


def _loader_epoch_s(loader, dtype: tp.Optional[str]) -> tuple:
    """One pass of a copy of `loader` (same dataset, batch, seed, workers,
    device) assembling in `dtype`: (seconds, batches)."""
    from brainmagick_tpu_torch.loader import Loader

    copy_ = Loader(loader.dataset, batch_size=loader.batch_size,
                   shuffle=loader.shuffle, seed=loader.seed,
                   drop_last=loader.drop_last,
                   num_workers=loader.num_workers, device=loader.device,
                   assemble_dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in copy_)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n


def run_gather(card_name: str, loader, study_epoch_s: float) -> None:
    """Phase 19 (c): the native gather at [256, 208, 361] from the
    gwilliams2022 recording's memmap and its track, in fp32 and bf16, bit
    for bit against the plain version (bf16: its round to nearest even),
    timed against it (host clock, GATHER_RUNS runs) with its GB/s; then an
    epoch of the resumed XP's train loader with the native gather and
    with the plain one, in fp32 and bf16, beside phase 9's epoch
    (`study_epoch_s`)."""
    from brainmagick_tpu_torch import dataset, native

    sub = loader.dataset.datasets[0]
    raw = sub.raw.data
    n_times, channels = sub._n_times, raw.shape[0]
    baseline = sub.sample_rate.to_ind(sub.baseline[1] - sub.tmin) + 1
    starts = np.random.RandomState(SEED + 19).randint(
        0, raw.shape[1] - n_times + 1, TRAIN_B)
    track = sub._get_track()[0][:-1]
    if (n_times, channels) != (T, 208):
        raise AssertionError(f"gather: {n_times} samples, {channels} sensors")
    plain = dataset.gather_epochs(raw, starts, n_times, channels, baseline)
    plain_track = dataset.gather_track(track, starts, n_times)
    plain_epochs, _ = plain_gathers = _plain_gathers()
    rows = []
    for dtype in ("float32", "bfloat16"):
        got = native.gather_epochs(raw, starts, n_times, channels, baseline,
                                   dtype=dtype)
        got_track = native.gather_track(track, starts, n_times, dtype=dtype)
        for what, out, ref in (("epochs", got, plain),
                               ("track", got_track, plain_track)):
            ref = torch.from_numpy(ref)
            out = torch.from_numpy(out) if isinstance(out, np.ndarray) \
                else out
            if dtype == "bfloat16":
                ref = ref.to(torch.bfloat16)
            bits = torch.int16 if dtype == "bfloat16" else torch.int32
            if out.dtype != ref.dtype or not torch.isfinite(ref).all() \
                    or not torch.equal(out.view(bits), ref.view(bits)):
                raise AssertionError(f"native gather {what} {dtype} differs "
                                     f"from the plain version")
        # the library into one reused array: the batch's fresh array costs
        # its page faults in the wrapper
        reused = np.empty(plain.shape, dtype=np.uint16 if dtype == "bfloat16"
                          else np.float32)
        entry = getattr(native.gather.library(), "gather_epochs" + (
            "_bf16" if dtype == "bfloat16" else ""))
        rows_, st = np.ascontiguousarray(raw), np.ascontiguousarray(
            starts, dtype=np.int64)
        times = {}
        for name, fn in (("native", lambda: native.gather_epochs(
                raw, starts, n_times, channels, baseline, dtype=dtype)),
                         ("reused", lambda: entry(
                             rows_.ctypes.data, channels, rows_.shape[1],
                             st.ctypes.data, len(st), n_times, channels,
                             baseline, reused.ctypes.data, 0)),
                         ("plain", lambda: plain_epochs(
                             raw, starts, n_times, channels, baseline,
                             dtype=dtype))):
            fn()
            runs = []
            for _ in range(GATHER_RUNS):
                t0 = time.perf_counter()
                fn()
                runs.append(time.perf_counter() - t0)
            times[name] = statistics.median(runs) * 1e3
        moved = plain.size * (4 + (2 if dtype == "bfloat16" else 4))
        rows.append(f"{dtype}: native {times['native']:.2f} ms "
                    f"({moved / times['native'] / 1e6:.2f} GB/s read + "
                    f"written; into a reused array {times['reused']:.2f} ms, "
                    f"{moved / times['reused'] / 1e6:.2f} GB/s), plain "
                    f"{times['plain']:.2f} ms "
                    f"({times['plain'] / times['native']:.1f}x)")
    print(f"native gather [{TRAIN_B}, {channels}, {n_times}], baseline "
          f"{baseline} samples, bit-equal to the plain version in fp32 and "
          f"bf16, epochs and the {track.shape[0]}-row track; ms per batch "
          f"(host clock, median of {GATHER_RUNS}, {card_name}'s host): "
          + "; ".join(rows))
    epochs = {}
    for name, gathers in (("native", None), ("plain", plain_gathers)):
        saved = native.gather_epochs, native.gather_track
        if gathers is not None:
            native.gather_epochs, native.gather_track = gathers
        try:
            for dtype in (None, "bfloat16"):
                epochs[name, dtype or "float32"] = _loader_epoch_s(loader,
                                                                   dtype)
        finally:
            native.gather_epochs, native.gather_track = saved
    print(f"train loader epoch, B={loader.batch_size}, "
          f"{loader.num_workers} workers, sent to the card (s, batches; "
          f"{card_name}): " + ", ".join(
              f"{name} {dtype} {s:.3f} s / {n}"
              for (name, dtype), (s, n) in epochs.items())
          + f"; phase 9's {KEPT_STUDY} epoch (train + valid, its steps "
          f"included, bf16 assembly) "
          f"{study_epoch_s:.2f} s")


def run_resume_phase(device: torch.device, card_name: str, work: Path,
                     study_epoch_s: float) -> tuple:
    """Phase 19: ``run_resume``, ``run_predict``, ``run_gather`` (beside
    phase 9's KEPT_STUDY epoch of `study_epoch_s`). Returns ({path:
    launch counts}, {path: ``check_cli_shapes`` arguments})."""
    with _studies_env(work):
        launches, loader, n_test = run_resume(device, card_name, work)
        run_gather(card_name, loader, study_epoch_s)
        del loader
    predict_launches, shapes = run_predict(device, card_name, work)
    launches.update(predict_launches)
    shapes["resume"] = dict(batch=TRAIN_B, n_test=n_test, n_mels=120,
                            channels=208, with_conv=False)
    return launches, shapes


#: phase 20: ranks on several hosts, on phase 9's gwilliams2022 tree
#: (KEPT_STUDY): the clip_conv_tpu recipe at the paper's width with
#: fused_conv_bn, B=256 over HOSTS hosts of HOSTS_RANKS ranks (64 a rank),
#: one candidate pool of the whole batch (the paper's 256 candidates,
#: gathered across the hosts), HOSTS_BATCHES train batches (the tree's
#: train split holds two), the valid pass and the test stage; four
#: processes on the one card over gloo
HOSTS, HOSTS_RANKS, HOSTS_BATCHES = 2, 2, 2
HOSTS_ARGS = (f"preset={RECIPE}", "simpleconv.fused_conv_bn=True",
              'dset.features=["MelSpectrum"]', "optim.batch_size=256",
              "optim.epochs=1", "dset.n_recordings=2",
              f"dset.selections=[{KEPT_STUDY!r}]",
              f"optim.max_batches={HOSTS_BATCHES}",
              "parallel.negatives_group_size=0", "device=cuda:0")
#: a compound dset.condition (the test split takes it too), and the test
#: split's segment count that the port's parser gives on the CPU on the
#: same tree (tests/test_torch_query.py)
HOSTS_QUERY = ("kind=='word' and duration > 0.1 and (start < 60 or "
               "start > 180)")
HOSTS_QUERY_SEGMENTS = 118


def _hosts_rank_main(rank: int, per_host: int, port: int, argv: list,
                     caches: list, studies: str, out: str) -> None:
    """A spawned rank of phase 20: a launcher's environment of
    `per_host` ranks a node (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, GROUP_RANK), the card shared, gloo between the
    ranks; ``train.main(argv)`` with its node's cache folder of `caches`
    and every launch count set to 0 just before it, its steps timed (``SolverSpy``), its host's test-stage
    metrics before the mean over the hosts and its scoring's shapes
    recorded. Its result or its traceback is pickled into `out`.<rank>,
    its log written to `out`.<rank>.log."""
    import os
    import pickle
    import traceback

    marks = {"started": time.time()}
    world = HOSTS * HOSTS_RANKS
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % per_host),
                      LOCAL_WORLD_SIZE=str(per_host),
                      GROUP_RANK=str(rank // per_host),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    log = os.open(f"{out}.{rank}.log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    torch.set_num_threads(2)
    try:
        from brainmagick_tpu_torch import ops, parallel, train, wer
        from brainmagick_tpu_torch.env import env
        from brainmagick_tpu_torch.ops import _build
        _build.library()
        parallel.init_distributed("cuda:0", backend="gloo")
        marks["joined"] = time.time()
        host_metrics, scored = [], []
        get_solver = train.get_solver

        def timed_get_solver(*args, **kwargs):
            solver = get_solver(*args, **kwargs)
            marks["solver"] = time.time()
            return solver

        train.get_solver = timed_get_solver
        average, pool_scores = (wer.average_metrics_across_processes,
                                wer.pool_scores)

        def spied_average(metrics, group):
            host_metrics.append(dict(metrics))
            return average(metrics, group)

        def spied_scores(server, clip, rows, pool, **kwargs):
            scored.append((len(rows), len(pool)))
            return pool_scores(server, clip, rows, pool, **kwargs)

        wer.average_metrics_across_processes = spied_average
        wer.pool_scores = spied_scores
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with SolverSpy() as spy, env.temporary(
                studies={KEPT_STUDY: Path(studies)}):
            t0 = time.perf_counter()
            train.main([*argv, f"cache={caches[rank // per_host]}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        marks["done"] = time.time()
        solver = spy.solver
        result = (True, dict(
            rank=rank, host=solver.group.host_index,
            n_hosts=solver.group.n_hosts, host_size=solver.group.host.size,
            launches={k.__name__: k.launches for k in ops.KERNELS},
            routes=dict(ops.conv_stats.launches_by_route),
            by_dtype=dict(ops.conv_stats.launches_by_dtype),
            trains=[t for t, _, _ in spy.events], forwards=spy.forwards,
            test_nt_matmul=spy.test_nt_matmul,
            test_inv_norms=spy.test_inv_norms, step_ms=spy.train_step_ms(),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall=wall,
            datasets_s=solver.build_timings["datasets"],
            host_metrics=host_metrics, scored=scored, marks=marks,
            n_mels=solver.used_features["MelSpectrum"].n_mels,
            channels=solver.datasets.train[0].meg.shape[0]))
    except BaseException:  # noqa: BLE001 - sent to the parent
        result = (False, traceback.format_exc())
    with open(f"{out}.{rank}.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")


def run_host_ranks(card_name: str, work: Path, name: str, per_host: int,
                   argv: list, caches: list, timeout: float = 300.) -> list:
    """HOSTS x HOSTS_RANKS spawned ranks of ``train.main(argv)`` sharing
    the card, `per_host` ranks a node (HOSTS_RANKS: HOSTS hosts; all of
    them: one host), node n's ranks with the cache folder `caches`[n];
    their results, or AssertionError with a failing rank's traceback and
    log. Every rank still running at `timeout` is killed."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = str(work / f"{name}_rank")
    world = HOSTS * HOSTS_RANKS
    ctx = mp.get_context("spawn")
    spawned = time.time()
    procs = [ctx.Process(target=_hosts_rank_main,
                         args=(r, per_host, port, argv, caches,
                               str(work / KEPT_STUDY), out))
             for r in range(world)]
    for proc in procs:
        proc.start()
    end = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.join(max(0., end - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    results = []
    for r, proc in enumerate(procs):
        path = Path(f"{out}.{r}")
        ok, value = pickle.loads(path.read_bytes()) if path.exists() \
            else (False, f"no result (exit code {proc.exitcode})")
        if not ok:
            print(_log_tail(Path(f"{out}.{r}.log"), 60))
            raise AssertionError(f"phase 20 {name} rank {r} ({card_name}):"
                                 f"\n{value}")
        value["marks"]["spawned"] = spawned
        results.append(value)
    return results


class HostView:
    """One host's test stage in this process: ``forward_batch`` of a batch
    that divides over the ranks forwards each of the host's ranks' row
    blocks alone, as the ranks do, and returns the host's rows
    (``local_rows``), which ``wer.get_wer`` then scores here."""

    def __init__(self, solver, host: int, hosts: int, ranks: int) -> None:
        self.solver, self.host, self.hosts, self.ranks = (solver, host,
                                                          hosts, ranks)

    def __getattr__(self, name):
        return getattr(self.solver, name)

    def local_rows(self, n: int) -> slice:
        from brainmagick_tpu_torch.parallel import process_rows
        return process_rows(n, self.host, self.hosts) \
            if n % (self.hosts * self.ranks) == 0 else slice(0, n)

    def forward_batch(self, batch, pad_weight=None):
        from brainmagick_tpu_torch.dataset import ARRAY_FIELDS
        from brainmagick_tpu_torch.parallel import process_rows
        n = len(batch.meg)
        world = self.hosts * self.ranks
        if n % world:
            return self.solver.forward_batch(batch, pad_weight)
        outs = []
        for r in range(self.host * self.ranks, (self.host + 1) * self.ranks):
            rows = process_rows(n, r, world)
            part = types.SimpleNamespace(**{
                name: getattr(batch, name)[rows] for name in ARRAY_FIELDS})
            outs.append(self.solver.forward_batch(
                part, None if pad_weight is None else pad_weight[rows]))
        return tuple(torch.cat(parts) for parts in zip(*outs))


def _check_host_rank(result: dict, n_hosts: int) -> None:
    """A rank of phase 20 knows its hosts and launched conv_stats 10 times
    a train step in bf16 on "tc", normalize once a forward and nt_matmul
    in its host's test stage."""
    want = (n_hosts, result["rank"] // (HOSTS * HOSTS_RANKS // n_hosts),
            HOSTS * HOSTS_RANKS // n_hosts)
    if (result["n_hosts"], result["host"], result["host_size"]) != want:
        raise AssertionError(f"rank {result['rank']}: hosts "
                             f"{result['n_hosts']}, host {result['host']} "
                             f"of {result['host_size']} ranks, want {want}")
    spy = types.SimpleNamespace(
        events=[(t, None, None) for t in result["trains"]],
        forwards=result["forwards"], test_nt_matmul=result["test_nt_matmul"],
        test_inv_norms=result["test_inv_norms"])
    steps = _check_cli_launches(f"hosts rank {result['rank']}",
                                result["launches"], result["routes"],
                                result["by_dtype"], spy, "bfloat16")
    if steps != HOSTS_BATCHES:
        raise AssertionError(f"rank {result['rank']}: {steps} train steps")


def run_hosts_phase(device: torch.device, card_name: str, work: Path
                    ) -> tuple:
    """Phase 20: ranks on several hosts and the event query.

    1. HOSTS "hosts" of HOSTS_RANKS ranks, four processes spawned on the
       one card with a two-node launcher's environment, gloo between
       them, each host with its own cache folder (so that its first rank
       fills it, ``parallel.lead_first``), the XP folder shared:
       ``train.main`` of HOSTS_ARGS. Then the same four ranks as one host
       (its cache read from host 0's). The train and valid losses of the
       two launches within LAUNCHER_TOL: the train step is global on any
       number of hosts.
    2. Each host's test-stage metrics (its rows against its own pool)
       against that host's rows scored in this process (``HostView``,
       the best state restored by signature) within LAUNCHER_TOL, and the
       reported metrics the mean of the two hosts'.
    3. Each rank's launches (conv_stats 10 a train step, bf16 on "tc";
       normalize once a forward; nt_matmul in its host's test stage),
       warm step device time, peak memory and dataset build seconds.
    4. HOSTS_QUERY as dset.condition (and the test split's) builds the
       splits here: the test split holds HOSTS_QUERY_SEGMENTS segments.

    Returns ({path: launch counts}, {path: ``check_cli_shapes``
    arguments})."""
    from brainmagick_tpu_torch import train, wer
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.play import get_solver_from_sig

    t_phase = time.perf_counter()
    caches = [f"{work}/hosts_cache{h}" for h in range(HOSTS)]
    runs = {}
    for name, per_host, folders in (
            ("hosts", HOSTS_RANKS, caches),
            ("one_host", HOSTS * HOSTS_RANKS, caches[:1])):
        t0 = time.perf_counter()
        runs[name] = run_host_ranks(card_name, work, name, per_host,
                                    [*HOSTS_ARGS, f"out_dir={work}/{name}"],
                                    folders)
        print(f"hosts: the {name} run ({card_name}): "
              f"{time.perf_counter() - t0:.1f} s, four processes on the "
              f"one card (their start included)")
    for name in runs:
        for result in runs[name]:
            warm = result["step_ms"][1:] or result["step_ms"]
            marks = result["marks"]
            print(f"hosts: {name} rank {result['rank']} (host "
                  f"{result['host']} of {result['n_hosts']}) on the shared "
                  f"card ({card_name}): train step device time "
                  f"{[round(x, 2) for x in result['step_ms']]} ms (warm "
                  f"median {statistics.median(warm):.2f}; four processes' "
                  f"kernels interleave on one card), peak device memory "
                  f"{result['peak_gb']:.2f} GB; seconds: to start "
                  f"{marks['started'] - marks['spawned']:.1f}, to join "
                  f"{marks['joined'] - marks['started']:.1f}, get_solver "
                  f"{marks['solver'] - marks['joined']:.1f} (datasets "
                  f"{result['datasets_s']:.2f}), the epoch, test stage and "
                  f"files {marks['done'] - marks['solver']:.1f}; scored rows "
                  f"x pool {result['scored']}; launches "
                  f"{result['launches']} (conv_stats by type "
                  f"{result['by_dtype']})")
    for name, n_hosts in (("hosts", HOSTS), ("one_host", 1)):
        for result in runs[name]:
            _check_host_rank(result, n_hosts)
    sig = train.parse_overrides(list(HOSTS_ARGS)).sig
    histories = {name: _read_history(work / name / "xps" / sig, 1,
                                     f"hosts {name}")[0] for name in runs}

    # 1. the train step is global: the same losses on one host
    diffs = {f"{stage} loss": abs(histories["hosts"][stage]["loss"]
                                  - histories["one_host"][stage]["loss"])
             / abs(histories["one_host"][stage]["loss"])
             for stage in ("train", "valid")}
    print(f"hosts: {HOSTS} hosts of {HOSTS_RANKS} ranks against one host of "
          f"{HOSTS * HOSTS_RANKS} ({card_name}): history "
          f"{histories['hosts']} against {histories['one_host']}; loss "
          f"differences {diffs} (tol {LAUNCHER_TOL})")
    if not all(d <= LAUNCHER_TOL for d in diffs.values()):
        raise AssertionError(f"hosts: the losses on {HOSTS} hosts against "
                             f"one host: {diffs}")

    # 2. each host's test stage against its rows scored in this process
    by_host = {}
    for result in runs["hosts"]:
        if len(result["host_metrics"]) != 1:
            raise AssertionError(f"rank {result['rank']}: host metrics "
                                 f"{result['host_metrics']}")
        metrics = result["host_metrics"][0]
        if by_host.setdefault(result["host"], metrics) != metrics:
            raise AssertionError(f"hosts: host {result['host']}'s ranks "
                                 f"report {by_host[result['host']]} and "
                                 f"{metrics}")
    reported = histories["hosts"]["test"]
    mean_diff = max(abs(reported[k] - np.mean([by_host[h][k]
                                               for h in range(HOSTS)]))
                    for k in reported)
    with _studies_env(work):
        solver = get_solver_from_sig(
            sig, out_dir=f"{work}/hosts",
            override_args={"cache": caches[0], "device": str(device)})
        alone = {h: wer.get_wer(HostView(solver, h, HOSTS, HOSTS_RANKS),
                                wer.test_batches(solver))
                 for h in range(HOSTS)}
        n_test = len(solver.datasets.test)
        del solver
    torch.cuda.empty_cache()
    host_diffs = {f"host {h} {k}": abs(by_host[h][k] - alone[h][k])
                  for h in range(HOSTS) for k in alone[h]}
    print(f"hosts: each host's test stage ({card_name}): {by_host}; its "
          f"rows scored in this process {alone}; differences {host_diffs} "
          f"(tol {LAUNCHER_TOL}); reported {reported}, the hosts' mean to "
          f"{mean_diff:.1e}; one host reports {histories['one_host']['test']}"
          f" over all {n_test} test segments")
    if not all(d <= LAUNCHER_TOL for d in host_diffs.values()) \
            or not mean_diff <= 1e-9:
        raise AssertionError(f"hosts: the hosts' test stages {host_diffs}, "
                             f"the reported mean off by {mean_diff}")
    if by_host[0] == by_host[1]:
        raise AssertionError(f"hosts: both hosts report {by_host[0]}")

    # 3. the event query
    t0 = time.perf_counter()
    query_args = train.parse_overrides([
        *HOSTS_ARGS, f"dset.condition={HOSTS_QUERY}",
        "dset.test.condition=None", f"cache={caches[0]}",
        f"device={device}"])
    with _studies_env(work), env.temporary_from_args(query_args):
        built = train.build_datasets(query_args)
    sizes = {split: len(getattr(built, split))
             for split in ("train", "valid", "test")}
    print(f"hosts: dset.condition={HOSTS_QUERY!r} on the card's machine "
          f"(no pandas) builds the splits {sizes} in "
          f"{time.perf_counter() - t0:.2f} s; the test split's "
          f"{HOSTS_QUERY_SEGMENTS} segments on the CPU, {n_test} with "
          f"'word'")
    if sizes["test"] != HOSTS_QUERY_SEGMENTS:
        raise AssertionError(f"hosts: the query's test split holds "
                             f"{sizes['test']} segments, the CPU's "
                             f"{HOSTS_QUERY_SEGMENTS}")
    del built

    launches = {f"hosts_{name}": {
        kernel: sum(r["launches"][kernel] for r in runs[name])
        for kernel in runs[name][0]["launches"]} for name in runs}
    lead = runs["hosts"][0]
    rows, pool = lead["scored"][0]
    batch = train.parse_overrides(list(HOSTS_ARGS)).optim.batch_size
    shapes = {"hosts_ranks": dict(
        batch=batch // (HOSTS * HOSTS_RANKS), n_test=-(-rows // HOSTS_RANKS),
        n_cand=pool, n_mels=lead["n_mels"], channels=lead["channels"])}
    print(f"hosts phase: {time.perf_counter() - t_phase:.1f} s "
          f"({card_name})")
    return launches, shapes


@contextlib.contextmanager
def _studies_env(work: Path):
    from brainmagick_tpu_torch.env import env

    with env.temporary(studies={KEPT_STUDY: work / KEPT_STUDY}):
        yield


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    from brainmagick_tpu_torch.ops import _build
    from brainmagick_tpu_torch.precision import exact_fp32

    device = torch.device("cuda", 0)
    card_name = card()
    print(card_name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    defaults = tf32_flags()
    print(f"torch's TF32 defaults, left as they are (the entry points turn "
          f"TF32 off themselves): {defaults}")

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"built {path.relative_to(_build.PACKAGE_DIR.parent)} from "
          f"{[s.name for s in _build._sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    phase_s = {}
    t0 = time.perf_counter()
    with exact_fp32():
        kernels = [check_normalize(device), check_nt_matmul(device),
                   check_conv_stats(device), check_inv_norms(device)]
    phase_s["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_launches, batch, serve_warm = run_slice(device, card_name)
    train_launches, train_types, train_warm = run_train(device, card_name,
                                                        batch)
    phase_s["4-5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eval_launches, eval_fp32 = run_eval_phase(device, card_name)
    phase_s["6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recipe_serve, _, recipe_serve_warm = run_slice(device, card_name,
                                                   RECIPE)
    recipe_train, recipe_types, recipe_train_warm = run_train(
        device, card_name, batch, RECIPE)
    phase_s["7"] = time.perf_counter() - t0
    # phases 8-16 share one folder: phases 10-16 train on phase 9's
    # gwilliams2022 tree, and phase 10 evaluates phase 8's recipe XP
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fake_cache_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        cli_launches, cli_shape, cli_xps = run_cli_phase(device,
                                                         card_name, work)
        phase_s["8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        study_launches, study_shapes, study_epochs = run_study_phase(
            device, card_name, work)
        phase_s["9"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        deepmel_launches, deepmel_shapes = run_deepmel_phase(
            device, card_name, work, cli_xps["cli_recipe"])
        phase_s["10"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        words_launches, words_shapes = run_words_phase(device, card_name,
                                                       work)
        phase_s["11"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        encode_launches, encode_shapes = run_encode_phase(device, card_name,
                                                          work)
        phase_s["12"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grid_launches, grid_shapes = run_grid_phase(device, card_name, work)
        phase_s["13"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parallel_launches, parallel_shapes = run_parallel_phase(
            device, card_name, work, study_shapes[KEPT_STUDY])
        phase_s["14"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wav2vec_launches, wav2vec_shapes = run_wav2vec_phase(
            device, card_name, work)
        phase_s["15"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        options_launches, options_shapes = run_options_phase(
            device, card_name, work)
        phase_s["16"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        export_launches, export_shapes, registration = run_serve_phase(
            device, card_name, work, cli_xps)
        phase_s["17"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume_launches, resume_shapes = run_resume_phase(
            device, card_name, work, study_epochs[KEPT_STUDY])
        phase_s["19"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hosts_launches, hosts_shapes = run_hosts_phase(device, card_name,
                                                       work)
        phase_s["20"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_launches, zoo_shapes = run_zoo_phase(
        device, card_name, batch, eval_fp32, train_warm, recipe_train_warm)
    phase_s["18"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with exact_fp32():
        cli_shapes = check_cli_shapes(device, **cli_shape)
        for k, (selection, shape) in enumerate(study_shapes.items()):
            for name, shapes in check_cli_shapes(
                    device, **shape, with_conv=k == 0,
                    prefix=f"{selection}: ").items():
                cli_shapes[name].update(shapes)
        for path, shape in {**deepmel_shapes, **words_shapes,
                            **encode_shapes, **grid_shapes,
                            **parallel_shapes, **wav2vec_shapes,
                            **options_shapes, **export_shapes,
                            **zoo_shapes, **resume_shapes,
                            **hosts_shapes}.items():
            for name, shapes in check_cli_shapes(
                    device, **shape, prefix=f"{path}: ").items():
                cli_shapes[name].update(shapes)
    phase_s["the runs' shapes"] = time.perf_counter() - t0
    print(f"wall seconds by phase ({card_name}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(f"{RECIPE} against clip_conv, warm B={REQUESTS[0]} ({card_name}): "
          f"forward {recipe_serve_warm['forward_ms']:.2f} ms against "
          f"{serve_warm['forward_ms']:.2f}, scoring "
          f"{recipe_serve_warm['scoring_ms']:.2f} ms against "
          f"{serve_warm['scoring_ms']:.2f}, train step "
          f"{recipe_train_warm['step_ms']:.2f} ms against "
          f"{train_warm['step_ms']:.2f}, peak memory "
          f"{recipe_train_warm['peak_gb']:.2f} GB against "
          f"{train_warm['peak_gb']:.2f}")
    if tf32_flags() != defaults:
        raise AssertionError(f"TF32 flags {tf32_flags()} after the run, "
                             f"{defaults} before it")
    for entry in kernels:
        by_path = dict(serve=serve_launches[entry["name"]],
                       train=train_launches[entry["name"]],
                       eval=eval_launches[entry["name"]],
                       recipe_serve=recipe_serve[entry["name"]],
                       recipe_train=recipe_train[entry["name"]],
                       **{path: counts[entry["name"]]
                          for path, counts in {**cli_launches,
                                               **study_launches,
                                               **deepmel_launches,
                                               **words_launches,
                                               **encode_launches,
                                               **grid_launches,
                                               **parallel_launches,
                                               **wav2vec_launches,
                                               **options_launches,
                                               **export_launches,
                                               **zoo_launches,
                                               **resume_launches,
                                               **hosts_launches}.items()})
        entry["other_shapes"].update(cli_shapes[entry["name"]])
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["name"] in registration:
            entry["wrapper_ms_before_after_registration"] = registration[
                entry["name"]]
        if entry["name"] == "conv_stats":
            entry["train_launches_by_dtype"] = train_types
            entry["recipe_train_launches_by_dtype"] = recipe_types
    print(card_name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
