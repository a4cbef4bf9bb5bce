#!/usr/bin/env python3
"""Serve llama_1b (float32 and bf16, and as a streaming generation server)
and llamas at Phi-3-mini's widths (head dim 96) and GPT-J-6B's (head dim
256), train transformer-base, llama_1b, ResNet-50, SE-ResNeXt-50, VGG-16,
the MNIST CNN, DeepFM, Wide&Deep (under every optimizer), word2vec and
the stacked dynamic-LSTM LM (ragged LoD feeds) through paddle_tpu_torch
on one NVIDIA GPU, and hold each hand-written CUDA kernel against its
plain PyTorch version.

    python3 chip_smoke.py                      # all phases, one card
    python3 chip_smoke.py --phases card,kernels
    python3 chip_smoke.py --phases training_llama,train_llama_gpu_vs_cpu
    python3 chip_smoke.py --phases card,kernels,training_composed
    python3 chip_smoke.py --phases serving_bf16,generation,generation_gpu_vs_cpu
    python3 chip_smoke.py --phases card,kernels,serving_d96
    python3 chip_smoke.py --phases card,kernels,serving_d256
    python3 chip_smoke.py --phases card,kernels,training_llama_d256
    python3 chip_smoke.py --phases card,training,nan_trip
    python3 chip_smoke.py --phases card,kernels,training_resnet50,train_resnet_gpu_vs_cpu
    python3 chip_smoke.py --phases card,kernels,training_se_resnext50,training_vgg16,training_mnist,train_conv_gpu_vs_cpu
    python3 chip_smoke.py --phases card,training_ctr,training_optimizers,training_word2vec,train_ctr_gpu_vs_cpu
    python3 chip_smoke.py --phases card,training_stacked_lstm,train_seq_gpu_vs_cpu
    python3 chip_smoke.py --phases training_recompute,training_fluid_loss,ops_gpu_vs_cpu

Every program runs through the PT_OPT passes (on by default): their fused
groups run as generated CUDA kernels (paddle_tpu_torch/ops/kernelgen),
compiled by one nvcc call per program at its first run.  Executor.run and
Predictor.run replay each launch signature as a captured CUDA graph from
its second run (paddle_tpu_torch/core/graphs.py); use_program_cache=False
is the interpreter, which the graph phases time beside it.

Phases, each printing JSON lines:
  card        nvidia-smi name and power limit; build the kernels (nvcc,
              sm_90a, one process per source) from paddle_tpu_torch/csrc
              and time the build
  kernels     every kernel on the card against its plain version at its
              main path's shapes (timed: kernel / plain / library ms and the
              bound) and at ragged ones: flash-attention forward and the
              embedding gather at the served shapes (the gather also with
              L2 flushed before each call, beside F.embedding timed the
              same way); the flash backward
              (dQ, dK/dV), LayerNorm and the multi-tensor Adam at the
              training step's shapes; softmax rows (K5) at the composed
              attention's scores and ragged shapes; every generated segment
              of the main paths (the served program at each bucket, the
              flash and the composed training steps, the training llama)
              against its plain replay, all built by one nvcc call; K1-K3
              at the training llama's shape (B=2, H=16 / 8, T=2048,
              D=128, causal) in float32 and bf16, beside SDPA, and
              float32 K2 and K3 also in the CUDA-core design
              (csrc/flash_cc.cu, llama_f32_bwd_designs), and the bf16 K2
              and K3 at the flash step's and the llama's shapes
              (c7_bwd_bf16: dS as hi + lo terms at D = 64 and 128 too);
              the other head dims up to 128: K1, K2 and K3 in the
              tensor-core kernels' padded instances, K1 checked and timed
              at serving_d96's shape (B=4, H=32 / 32, T=2048, D=96,
              causal), all three timed at D = 96 (B=2, H=16 / 8, T=1024)
              beside the CUDA-core designs they replaced and SDPA
              (d96_fwd_designs, d96_bwd_designs),
              checked at D = 16 (the tiny llama's), 32, 40, 72 and 120, the
              forward's kernel and instance read from the profiler; the
              head dims 136-256: K1 in the tensor-core instance of width
              256 checked and timed at serving_d256's shape (B=4, H=16 /
              16, T=2048, D=256, causal), timed at D = 256 (B=2, H=16 / 8,
              T=1024) beside the CUDA-core kernel it replaced and SDPA
              (d256_fwd_designs); K2 and K3 in the tensor-core instances
              of width 256 (bf16; float32 as 3xTF32 in clusters of two
              blocks splitting D) timed there and at the AMP step's shape
              (B=2, H=16 / 16, T=2048) beside SDPA's whole backward and
              the CUDA-core pair they replaced (d256_bwd_designs); all
              three checked at D = 256, 136, 200 (MQA) and 248 with k_len
              0 and 1 rows, Tq < Tk and ragged tiles; Adam's bf16
              instance at the llama's 147 tensors
  serving     llama_1b (full width, 16 layers, random weights from a seed)
              built through the port's layers, saved with
              save_inference_model, loaded by Predictor behind
              ServingEngine.from_predictor with FeedBucketer([1, 2, 4]);
              seeded requests of 1-2 rows x 2048 tokens; launch counts
              read around the served requests; then torch.profiler over
              one 4-row batch (device time by kernel group, idle share),
              whose 16 flash forwards must all be the 3xTF32 kernel
  serving_bf16
              the same model, feeds and buckets through a Predictor with
              AnalysisConfig.enable_bf16 (bf16 parameters): every request
              ok, served rows within the bf16 bound of pred.run alone and
              of the float32 Predictor's logits on the same feeds, and two
              faults made in a third bf16 Predictor's parameters (the
              last layer's attention dropped; fp8 precision) outside it;
              one profiled 4-row batch, whose 16 flash forwards must all be
              the bf16 wgmma kernel
              (serving and serving_bf16 both end with serve_modes: the
              4-row batch through the interpreter and through its CUDA
              graph in turns, eager, graph, graph, eager; median ms,
              tokens/s, device busy and idle share, peak memory; the
              served rows bit for bit equal)
  serving_d96 a llama at Phi-3-mini's widths (d_model 3072, 32 heads
              and 32 KV heads, so D = 96, FFN 8192, vocab 32064, rope
              theta 10000; microsoft/Phi-3-mini-4k-instruct), max_len
              2048, cut to 4 of its 32 layers (0.65 B parameters, random
              weights from a seed), built, saved and loaded by Predictor
              in float32 and with enable_bf16: one profiled 4-row batch
              of 2048 tokens in each (batch ms, flash ms), whose 4 flash
              forwards must all be the padded tensor-core kernel of width
              128 (fwd_tf32x3, fwd_wgmma); bf16 within the bf16 bound of
              float32
  serving_d256
              the same at GPT-J-6B's widths (d_model 4096, 16 heads and 16
              KV heads, so D = 256, FFN 16384, vocab 50400, rope theta
              10000; EleutherAI/gpt-j-6b) on the llama architecture,
              max_len 2048, cut to 4 of its 28 layers (1.49 B parameters):
              its 4 flash forwards a batch must be the tensor-core kernel
              of width 256, unpadded (<256, false, 8>)
  generation  llama_1b (full width and depth, float32, TF32 off, weights
              from its program's startup) through make_streaming_runtime
              (8 slots, prefill chunks of 256) and GenerationEngine
              (decode windows of 4), after DecodeRuntime.warmup(4) built
              the prefill chunk's and the decode window's CUDA graphs
              (capture seconds by key, reserved memory; warmup changes no
              state outside page 0): 8 concurrent requests of 128-1024
              prompt tokens and 64 new tokens, greedy and seeded top-k,
              every chunk and window a graph replay;
              TTFT and ITL p50 / p99, decode tokens/s, window ms, KV pool
              bytes and peak memory; every stream terminal once, K4 one
              launch a prefill chunk and a decode step, no plain version on
              the card; two greedy streams against dense_reference on the
              card, a seeded and a greedy stream of the batch bitwise
              equal to the same request run alone, a seeded stream bitwise
              at windows of 1 and 4; graph_vs_eager: from one state, a
              prefill chunk, a decode and a verify window through the
              graph and the private eager body, bit for bit (tokens,
              logits, lengths, tok, every page but page 0), in float32 and
              with int8 KV; window_modes: 8 decoding slots' windows eager
              and graph in turns (median ms), one profiled window of each
              (device busy, idle share, kernels a step split by group,
              equal in both modes); a decode_step fault (testing/faults)
              errors its window's stream and frees its slot, and a seeded
              stream after it equals the same request alone; the
              plain cached_attention against one
              SDPA call with the same mask at the decode and prefill
              shapes (timed only)
  gpu_vs_cpu  llama_1b widths, Phi-3-mini's (D = 96) and GPT-J-6B's (D =
              256), 1 layer (cut from 2 for the time limit),
              max_len 512: one saved model each through the port's
              Predictor on the card and on the CPU
  generation_gpu_vs_cpu
              llama_1b width, 2 layers: a 64-token prompt and 16 greedy
              tokens through the paged runtime on the card and on the CPU
  training    transformer-base as bench.py builds it (full width, 6+6
              layers, vocab 32000, B=32, T=256, bf16 AMP, flash attention,
              dropout 0, random init from a seed) trained by
              Executor.run: 3 warm-up and 10 timed steps (step ms, tokens/s,
              losses, which must be finite), kernel launches per step read
              around the timed steps, then torch.profiler over one step,
              whose 18 bf16 flash forwards, 18 dQ and 18 dK/dV launches
              must all be the tensor-core (wgmma) kernels; then
              graph_modes: the interpreter (use_program_cache=False), the
              graph, run_steps(K=8) and Executor(check_nan=True,
              nan_poll=8), in turns (ABCDDCBA), each with median step
              ms, tokens/s, launches per step (equal in every mode),
              peak memory, a profiled window's device busy and idle share,
              and the captures' seconds; then bitwise_paths: 3 steps from
              one scope state and one set of run counters through the
              interpreter, the graph and run_steps must agree bit for bit
              in the losses and every scope tensor
  training_f32
              the same step in float32 (AMP off, the reference's default
              precision; float32 GEMMs in full float32): the same counts,
              and its 18 flash forwards, 18 dQ and 18 dK/dV launches must
              all be the 3xTF32 tensor-core kernels
  train_gpu_vs_cpu
              the same model at full width cut to 2 layers, B=4, T=256,
              float32: 2 steps from the same weights on the card and on the
              CPU; losses and parameters after the updates must agree
  training_composed
              transformer-base at its own defaults (composed attention,
              dropout 0.1, label smoothing 0.1; full width and depth, vocab
              32000, B=32, T=256, bf16 AMP): 3 warm-up and 10 timed steps;
              launches per step (18 softmax, no flash, the planned
              generated segments, 32 LayerNorms, 2 gathers, 1 Adam), no
              plain version called on the card, the generated build's nvcc
              time, torch.profiler over one step; graph_modes and
              bitwise_paths as in training (dropout 0.1: the masks too)
  train_composed_gpu_vs_cpu
              that model at full width cut to 2 layers, B=4, float32,
              dropout 0: 2 steps on the card and on the CPU must agree
  composed_opt_on_off
              that model at full width cut to 2 layers, B=32, bf16 AMP,
              dropout 0.1: 3 steps with PT_OPT=1 (generated kernels) and
              with PT_OPT=0 (one eager op at a time) from the same seed;
              losses within 1e-6 relative, and whether bit for bit
  nan_trip    check_nan through the graph: that model at full width, 2
              layers, float32, dropout 0; after three clean steps a NaN
              in one target pad entry must raise naming the loss at
              nan_poll=1, and with nan_window_steps=8 at nan_poll=8
  training_llama
              llama_1b as models/llama.py::build makes it (full width and
              depth: d_model 2048, 16 layers, 16 / 8 heads, D = 128, vocab
              32000, 0.87 B parameters, float32, gradient clip by global
              norm 1.0, Adam), B = 2 rows of 2048 tokens from make_batch,
              random weights from SEED: the interpreter, the CUDA graph
              and run_steps(8) on one repeated batch (step ms, tokens/s,
              losses finite and falling over 8 steps, launches a step:
              16 of each flash kernel, one Adam, one K4), profiles of an
              interpreted step (device ms by group, idle share; 16
              fwd_tf32x3, 16 bwd_dq_tf32x3, 16 bwd_dkv_tf32x3, no CUDA-core
              backward) and of two graph
              steps, peak memory, no plain version on the card; then the
              device kernels a step with the clip on and off
  training_llama_bf16
              the same step from build(dtype='bfloat16'): the bf16 step
              (interpreted, three times from one state; profiled: 16 of
              each bf16 wgmma flash kernel, Adam's bf16 instance), the
              dtypes it leaves (float32 parameters and moments, bf16 beta
              powers, as the JAX package's Adam returns them), then seven
              float32 steps through the graph
  training_llama_d256
              a llama at GPT-J-6B's widths (GPTJ_CFG as serving_d256 has
              it, 4 of 28 layers, 1.49 B parameters) built by
              models/llama.py::build and trained under bf16 AMP
              (Program.set_amp(True): Adam behind clip by global norm 1.0,
              B = 2 rows of 2048 tokens from make_batch, one repeated
              batch): an interpreted step, the capture, 3 graph steps
              (step ms, tokens/s, losses finite, launches a step: 4 of each
              flash kernel, one Adam, one K4), a profile of two graph
              steps (device busy by group, idle share; every flash launch
              the tensor-core instance of width 256, the 4 dQ and 4 dK/dV
              a step included), peak memory, no plain version on the card;
              then the same in float32 in a fresh scope (2 graph steps;
              every flash launch the 3xTF32 instance of width 256, the
              backward as clusters of two blocks)
  train_llama_gpu_vs_cpu
              two steps from the same weights on the card and on the CPU:
              llama_1b widths cut to 1 layer, B = 2, T = 256, float32
              (losses within 1e-5 relative, parameters within 2.01 x the
              summed lr, the clip's global norm within 1e-5 relative);
              the tiny config (D = 16: the tensor-core forward's and
              backward's padded instances of width 64) in float32 and
              from build(dtype='bfloat16'), and GPT-J-6B's widths cut to
              1 layer at T = 128 under bf16 AMP (gptj_amp: D = 256, the
              instances of width 256), each within the bf16 bounds
              tests/test_torch_llama_train.py derives, and in float32
              (gptj_f32: within the float32 bounds above; a profiled step
              must run the width-256 3xTF32 dQ and dK/dV, no CUDA-core
              kernel); the two GPT-J-width runs hold one step (cut from
              two for the time limit)
  training_resnet50
              ResNet-50 as the reference's models/resnet.py::bench_program
              builds it (224 x 224, 1000 classes, B = 128, full depth,
              bf16 AMP: convolutions in bf16 whose outputs stay bf16,
              batch-norm statistics in float32; Momentum lr 0.1, mu 0.9;
              random weights from the startup's seed, a synthetic feed):
              an interpreted step, the capture, 10 graph steps (images/s,
              step ms median and range, model FLOP/s from the conv and fc
              FLOPs x 3, losses finite), a profile of two graph steps by
              group (convolutions and GEMMs, batch norm's float32 torch
              ops, bf16 elementwise and pooling, casts, the feed's upload,
              generated segments, K5, momentum_multi; device busy and
              idle share), peak memory, launches a step (one
              momentum_multi, on the profiler too, one K5), no plain
              version on the card
  train_resnet_gpu_vs_cpu
              models/resnet.py::build at sizes the CPU runs quickly (the
              CIFAR-10 ResNet-8 at 32 x 32, B 8; ResNet-50 at 64 x 64, 10
              classes, B 8), 3 Momentum steps (ResNet-50: 1, the step it
              holds) in float32 and under bf16
              AMP on the card and on the CPU from one scope, cuDNN's TF32
              flag at PyTorch's default: losses, parameters, velocities,
              moving statistics and the for_test clone's predictions
              within the bounds the phase derives
  training_se_resnext50
              SE-ResNeXt-50 as the reference's models/se_resnext.py::build
              makes it (224 x 224, 1000 classes, cardinality 32,
              reduction 16, uncut), B 128, bf16 AMP, Momentum 0.9 on the
              piecewise schedule with L2Decay(1e-4), dropout 0.5: the
              steps, profile and checks of training_resnet50 (one
              momentum_multi and one K5 a step), and the SE block's gate
              (bias add + sigmoid), its mul(axis=0) + add + relu and the
              schedule's less_than + cast among the launched segments
  training_vgg16
              VGG-16 with batch norm and dropout (models/vgg.py::build at
              224 x 224, 1000 classes), B 64, bf16 AMP, Adam 1e-3: the
              same steps and profile, one adam_multi and one K5 a step
  training_mnist
              the MNIST CNN (models/mnist.py::build), B 128, float32,
              Adam: step ms and images/s (no profile)
  train_conv_gpu_vs_cpu
              the three at sizes the CPU runs quickly (MNIST full size,
              VGG-16 at 32 x 32 with 10 classes, SE-ResNeXt-50 at 64 x 64),
              every dropout at 0, 3 steps float32 and AMP on the card and
              on the CPU from one scope, held as train_resnet_gpu_vs_cpu
              holds its runs (VGG-16 and SE-ResNeXt-50 run and are held
              at their first step); then
              every learning-rate schedule computed inside the captured
              graph: piecewise_decay(boundaries [3, 6]) with Momentum over
              11 runs (9 graph replays), its rate each run equal to the
              plain formula and the parameters after the last run equal
              to the CPU's, each other schedule over 3 runs
  training_ctr
              PaddleRec CTR as BASELINE.json names it: DeepFM (Adam 1e-3)
              and Wide&Deep (Adagrad 1e-2) as models/ctr.py builds them at
              their own widths (26 slots, 13 dense features, embedding 8;
              fc 400 x 3 and 256, 128, 64) with 1,000,001 vocabulary rows
              (their vocab_size), B 2048 rows of synthetic_reader, float32:
              an interpreted step, the capture, 10 graph steps (ms a step,
              examples/s, losses finite), a profile of two graph steps by
              group (idle share), peak memory; two K4 gathers and one
              adam_multi / adagrad_multi a step, no plain version
  training_optimizers
              Wide&Deep at that size under SGD, Adagrad, DecayedAdagrad,
              Adamax, Adadelta, RMSProp (plain and centered), Ftrl (at
              lr_power -0.5 and -0.6), LarsMomentum, and ModelAverage over
              SGD, each in a fresh scope: an interpreted step, the
              capture, 3 graph steps; losses finite, each optimizer's
              csrc/optim_multi.cu instance once a step (LarsMomentum,
              plain torch ops as the reference leaves it to XLA, none);
              ModelAverage's apply() writes sum / cnt, restore() the
              trained values
  training_word2vec
              the book's word2vec (models/word2vec.py at its defaults:
              dictionary 2073, embedding 32, hidden 256, 5-grams, SGD),
              B 512: the steps and profile of training_ctr; four K4
              gathers, one K5 and one sgd_multi a step
  train_ctr_gpu_vs_cpu
              DeepFM, Wide&Deep and fit_a_line at vocab 10,000, B 256,
              and Wide&Deep under each optimizer of training_optimizers:
              3 steps on the card and on the CPU from one state; losses
              within 1e-5 relative, every parameter and optimizer state
              within the L2 bound the phase derives and prints
  training_stacked_lstm
              models/stacked_lstm.py at its defaults (dict 5147, emb and
              hid 512, 3 layers, layers 2 and 3 alternately reversed,
              Adam 0.002), B 32 synthetic reviews of 32-512 tokens (cut
              from the benchmark's IMDB lengths for the time limit) fed
              through DataFeeder (a LoDTensor) and FeedBucketer (T
              bucketed: 512): an interpreted step, the capture, 10 graph
              steps on one batch (ms, examples/s, real tokens/s), two
              batches of other lengths replaying the one graph, a profile
              of two graph steps by group, peak memory; the fixed batch's
              loss falls; one K4, one K5 and one adam_multi a step
  train_seq_gpu_vs_cpu
              the LM at emb and hid 64 (dict 5147, 3 layers, B 8, 3-40
              tokens: three steps, a fourth batch of the same T bucket
              with other lengths, a dense array into the lod var) and
              the recommender at its defaults (MovieLens widths, B 256,
              three SGD steps) on the card and on the CPU from one
              state: losses within 1e-5 relative, parameters within 2.01
              x the summed lr; the LM's predict saved and run by
              Predictor on a LoDTensor, card against CPU
  training_recompute
              transformer-base (B 32, T 256, bf16 AMP) at COMPOSED_CFG
              (dropout 0.1, composed attention) and at BENCH_CFG (flash),
              each as the plain program and with its forward in one
              recompute_scope(), from one seed and one state: 3 steps each
              (step 1's loss bit for bit, losses and parameters within 1e-5
              relative plus 2.01 x the summed lr), the recompute's graph
              step bit for bit its interpreted one, step ms, peak memory
              and launches a step of each (K5 and K1 twice the plain
              program's)
  training_fluid_loss
              transformer-base at BENCH_CFG minimizing Fluid's own
              one_hot -> label_smooth -> soft-label cross-entropy, the
              model's closed form fetched beside it (the two within the
              derived (V + 8) 2^-24 bound), step ms, peak memory and
              label_smooth's generated segment launched once a step
  ops_gpu_vs_cpu
              every dense op of GVC_OPS on the card against the CPU,
              bit for bit where exact, else within its stated tolerance;
              tests/test_recompute.py's program card against CPU
The kernels phase also holds one generated segment for each rule of the
elementwise, comparison, logical and activation ops (RULE_CASES, 4 M
values from RULE_SPECIALS and normal ones) against its plain op, timed;
each instance of csrc/optim_multi.cu (OPTIM_CASES) at Wide&Deep's 12
tensors with 1,000,001 rows (its kernels-line row), at ResNet-50's 161
and at ragged sizes, bit for bit (the pow instance within its bound),
timed beside its plain version and torch's optimizer where one exists;
K4 at the CTR tables (1 and 8 columns, 53,248 int64 ids) and at the
sequence models' lookups beside F.embedding; and (C12) the bf16 segment
of each rule whose Python constants meet the tensor (C12_RULE_CASES) on
every bf16 bit pattern, bit for bit its plain op; and the
segments of the label_smooth, fill_zeros_like and flatten rules
(A10_RULE_CASES), a kernelgen_rule and a kernelgen_rule_bf16 line each.
The phases run in that order, except that the ones that also compute on
the CPU (gpu_vs_cpu, generation_gpu_vs_cpu, train_gpu_vs_cpu,
train_composed_gpu_vs_cpu, train_llama_gpu_vs_cpu,
train_resnet_gpu_vs_cpu, train_conv_gpu_vs_cpu, train_ctr_gpu_vs_cpu,
train_c11_gpu_vs_cpu, train_seq_gpu_vs_cpu, ops_gpu_vs_cpu) run last, and that
training_llama, training_llama_bf16, training_llama_d256 and the conv
models' training phases run after training_composed.  For the time
limit some card-vs-CPU runs hold fewer steps (VGG-16, SE-ResNeXt-50 and
ResNet-50 one, the GPT-J-width llama one), each as its phase says; the
models at public widths are cut in depth, each as its phase says.
The line before the last is the nvidia-smi line; the line before that
lists every kernel, with its launches per step on its training path (the
composed one for K5, its generated segments, K4, K6 and Adam; the flash
one for K1-K3 and its own segments), per served run for the serving-only
ones, and `launches_by_path` (per served run for serving and
serving_bf16, per decode step for generation, per step for each training
path); K1, K2 and K3 also list their instances, each timed at its path's
shape: bf16 on tensor cores (the flash step; K1 also the bf16 served
run) and float32 (3xTF32 on tensor cores; launches per served run for
K1, per float32 step for K2 and K3), both also at the llama's D = 128
and at the other head dims up to 128, and at width 256 (K1 per
serving_d256 batch, K2 and K3 per step of training_llama_d256, all on
the tensor cores); with every phase run, a kernel or instance launched
on none of its paths fails the script.  The last line
is {"ok": true, "device": ...}.  Any failed check raises, so the script exits non-zero and prints no
result; it refuses to run without a CUDA device.  Float32 matrix products
run in full float32 (TF32 off, set below); float32 convolutions do so by
the conv op itself, whatever cuDNN's TF32 flag says.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
PHASES = ('card', 'kernels', 'serving', 'serving_bf16', 'serving_d96',
          'serving_d256', 'generation',
          'gpu_vs_cpu', 'generation_gpu_vs_cpu', 'training', 'training_f32',
          'train_gpu_vs_cpu', 'training_composed',
          'train_composed_gpu_vs_cpu', 'composed_opt_on_off', 'nan_trip',
          'training_llama', 'training_llama_bf16', 'training_llama_d256',
          'train_llama_gpu_vs_cpu', 'training_resnet50',
          'train_resnet_gpu_vs_cpu', 'training_se_resnext50',
          'training_vgg16', 'training_mnist', 'train_conv_gpu_vs_cpu',
          'training_ctr', 'training_optimizers', 'training_word2vec',
          'train_ctr_gpu_vs_cpu', 'train_c11_gpu_vs_cpu',
          'training_stacked_lstm', 'train_seq_gpu_vs_cpu',
          'training_recompute', 'training_fluid_loss', 'ops_gpu_vs_cpu')
SEED = 1234
SERVED_FETCHES = ('last_logits', 'next_token')
BUCKETS = (1, 2, 4)
ALL_FETCHES = ('logits', 'last_logits', 'next_token')

# the training configuration bench.py headlines (transformer-base)
BENCH_CFG = dict(src_vocab=32000, trg_vocab=32000, max_len=256, n_layer=6,
                 n_head=8, d_model=512, d_inner=2048, dropout=0.0,
                 use_flash=True)
# transformer-base at models/transformer.py::build's own defaults
COMPOSED_CFG = dict(BENCH_CFG, dropout=0.1, use_flash=False)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type;
# 'tf32x3' is a float32 product as three TF32 tensor-core products (the
# float32 flash forward's design), 495 TFLOP/s / 3
HBM_BPS = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12, 'tf32x3': 495e12 / 3}
# bytes written between launches to push a kernel's inputs and outputs out
# of the 50 MB L2
FLUSH_BYTES = 128 << 20


def emit(**obj):
    print(json.dumps(obj, sort_keys=False), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, stdout=subprocess.PIPE,
        universal_newlines=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    """Mean device ms per call on the card: CUDA events around `iters`
    calls after a warm-up.  The stream first runs a spin kernel long enough
    for the host to queue all the calls behind it, so the events time the
    calls back to back on the device, not the host's launch overhead
    (tens of microseconds a call, which would bound a small kernel)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second: cover the host's queueing of every call
    torch.cuda._sleep(int(min(2.0 * host_s * iters + 1e-3, 0.5) * 2e9))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_ms_flushed(fn, iters):
    """Mean device ms per call with the L2 flushed before each call (a
    FLUSH_BYTES write, outside the timed interval): CUDA events around each
    call, all queued behind a spin kernel as in time_ms."""
    import torch
    junk = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device='cuda')
    for _ in range(2):
        junk.zero_()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    junk.zero_()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(min(2.0 * host_s * iters + 1e-3, 0.5) * 2e9))
    for e0, e1 in ev:
        junk.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


# ------------------------------------------------------------- phase 1

def phase_card():
    from paddle_tpu_torch.kernels import build
    smi = smi_line()
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    log = build.build_log()
    if log:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, 'kernel_build.log'), 'w') as f:
            f.write(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit(phase='card', nvidia_smi=smi, library=os.path.relpath(path, ROOT),
         build_s=round(build_s, 2), ptxas=ptxas,
         ptxas_by_kernel=ptxas_by_kernel(log),
         flash_fwd_occupancy=flash_fwd_occupancy(build.library()),
         flash_bwd_occupancy=flash_bwd_occupancy(build.library()))
    return smi


def flash_fwd_occupancy(lib):
    """The flash forward's shared memory a block and blocks an SM, by
    instance (D = 64, 128, 256, and the padded ones of width 64, 128 and
    256, asked for at D = 40, 96 and 200), as the CUDA runtime reports
    them."""
    import ctypes
    res = {}
    for dtype, code in (('float32', 0), ('bfloat16', 1)):
        for D, inst in ((64, 'd64'), (128, 'd128'), (256, 'd256'),
                        (40, 'dp64_padded'), (96, 'dp128_padded'),
                        (200, 'dp256_padded')):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            rc = lib.pt_flash_fwd_occupancy(D, code, ctypes.byref(smem),
                                            ctypes.byref(blocks))
            require(rc == 0, 'pt_flash_fwd_occupancy(%d, %s): %d'
                    % (D, dtype, rc))
            res['%s_%s' % (dtype, inst)] = dict(smem_bytes=smem.value,
                                                blocks_per_sm=blocks.value)
    return res


def flash_bwd_occupancy(lib):
    """The flash backward's shared memory a block and blocks an SM, for
    the dQ and the dK/dV kernel of each instance (D = 64, 128, 256, and
    the padded ones of width 64, 128 and 256, asked for at D = 40, 96 and
    200; float32 at width 256 a block of a two-block cluster), as the
    CUDA runtime reports them."""
    import ctypes
    res = {}
    for kind, kname in ((0, 'dq'), (1, 'dkv')):
        for dtype, code in (('float32', 0), ('bfloat16', 1)):
            for D, inst in ((64, 'd64'), (128, 'd128'), (256, 'd256'),
                            (40, 'dp64_padded'), (96, 'dp128_padded'),
                            (200, 'dp256_padded')):
                smem, blocks = ctypes.c_int(), ctypes.c_int()
                rc = lib.pt_flash_bwd_occupancy(D, code, kind,
                                                ctypes.byref(smem),
                                                ctypes.byref(blocks))
                require(rc == 0, 'pt_flash_bwd_occupancy(%d, %s, %s): %d'
                        % (D, dtype, kname, rc))
                res['%s_%s_%s' % (kname, dtype, inst)] = dict(
                    smem_bytes=smem.value, blocks_per_sm=blocks.value)
    return res


def ptxas_by_kernel(log):
    """{kernel, demangled where c++filt is there: 'N registers, S bytes
    spill stores, L bytes spill loads'} from nvcc's -Xptxas -v output."""
    import re
    names, res, cur = [], {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            names.append(cur)
            res[cur] = []
        elif cur and ('registers' in ln or 'spill' in ln):
            res[cur].append(ln.split(':', 1)[-1].strip())
    try:
        out = subprocess.run(['c++filt'], input='\n'.join(names),
                             capture_output=True, text=True, timeout=30)
        plain = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = []
    if len(plain) != len(names):
        plain = names
    short = [p.replace('(anonymous namespace)::', '').split('(')[0]
             for p in plain]
    return {p[5:] if p.startswith('void ') else p: '; '.join(res[n])
            for n, p in zip(names, short)}


# ------------------------------------------------------------- phase 2

def flash_case(name, B, H, Hkv, Tq, Tk, D, causal, dtype, klen=None,
               timed=False, design='port', profiled=False):
    """K1 against `_ref_attention`: the port's (flash_forward, its
    wrapper), or with design 'cc' the CUDA-core kernel called directly
    (_cc_fwd_launch); the design's rate bounds it: bf16 and float32
    tensor cores (3xTF32) at every D up to 256 (D other than 64, 128 and
    256 padded), CUDA cores (float32 FMAs, both dtypes) for design 'cc'.
    `profiled`: the kernel one port forward launches, from the profiler,
    must be its dtype's tensor-core design in the instance of D's
    width."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Tq, D, generator=g, device='cuda').to(dt)
    k = torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
    v = torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
    kl = [Tk] * B if klen is None else list(klen)
    kl_t = torch.tensor(kl, dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    if design == 'cc':
        def run():
            return _cc_fwd_launch(q, k, v, kl_t, causal, scale)
    else:
        def run():
            return att.flash_forward(q, k, v, causal, scale, kl_t)
    out, lse = run()
    ref, ref_lse = att._ref_attention(q, k, v, causal, scale, kl_t)
    torch.cuda.synchronize()
    # float32: both sum in float32 in other orders; bfloat16: both round an
    # (almost equal) float32 result to bf16, so they may differ by one
    # bf16 unit in the last place, 2^-8 relative
    rtol, atol = (1e-4, 1e-5) if dtype == 'float32' else (8e-3, 1e-3)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    valid_rows = ref_lse > -1e29
    lse_err = float((lse - ref_lse).abs()[valid_rows].max()) \
        if bool(valid_rows.any()) else 0.0
    lse_ok = bool(torch.equal(lse > -1e29, valid_rows)) and lse_err <= 1e-4
    res = dict(phase='kernels', kernel='flash_attention_fwd', case=name,
               B=B, H=H, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, causal=causal,
               dtype=dtype, design=design, k_len=kl, max_abs_err=err,
               rtol=rtol, atol=atol, lse_max_abs_err=lse_err, lse_atol=1e-4)
    if design == 'port' and D not in (64, 128, 256):
        res.update(DP=_padded_width(D), useful_share=D / _padded_width(D))
    if profiled:
        res['profiled_kernels'], res['profile_tries'] = \
            fwd_kernels_profiled(run, dtype, D)
    if 0 in kl:
        zero_rows = out[torch.tensor(kl) == 0].float().abs().max()
        res['k_len0_rows_max_abs'] = float(zero_rows)
        ok = ok and float(zero_rows) == 0.0
    if timed:
        # the work these inputs need: 4*D FLOPs per valid (query, key)
        # pair; each input read once, each output written once
        itemsize = q.element_size()
        qpos = np.arange(Tq)
        pairs = 0
        for b in range(B):
            vis = (np.minimum(kl[b], qpos + (Tk - Tq) + 1) if causal
                   else np.full(Tq, kl[b]))
            pairs += int(np.clip(vis, 0, Tk).sum()) * H
        flops = 4.0 * D * pairs
        nbytes = ((2 * B * H * Tq + 2 * B * Hkv * Tk) * D * itemsize
                  + 4 * B * H * Tq + 4 * B)
        t_bytes = nbytes / HBM_BPS * 1e3
        # float32 runs as 3xTF32 on the tensor cores: that rate bounds it;
        # the CUDA cores' float32 rate is printed beside it.  The work is
        # the true D's (a padded instance does D / DP of P V usefully)
        t_ops = flops / PEAK_FLOPS[_fwd_rate(dtype, design)] * 1e3
        if dtype == 'float32':
            res['bound_cuda_cores_ms'] = max(
                t_bytes, flops / PEAK_FLOPS['float32'] * 1e3)
            res['bound_tf32x3_ms'] = max(
                t_bytes, flops / PEAK_FLOPS['tf32x3'] * 1e3)
        res.update(
            ms=time_ms(run, 10),
            plain_ms=time_ms(lambda: att._ref_attention(q, k, v, causal,
                                                        scale, kl_t), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 10),
            bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes > t_ops else 'operations',
            flops=flops, bytes=nbytes)
        res['tflops'] = flops / res['ms'] / 1e9
        res['bound_share'] = res['bound_ms'] / res['ms']
    emit(**res)
    require(ok and lse_ok, 'flash_attention_fwd disagrees with its plain '
            'version in case %s: %s' % (name, res))
    return res


def gather_case(name, V, D, N, dtype, special=False, ids64=False,
                timed=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import gather as ga
    g = torch.Generator(device='cuda').manual_seed(SEED)
    w = torch.randn(V, D, generator=g, device='cuda').to(getattr(torch,
                                                                 dtype))
    ids = torch.randint(0, V, (N,), generator=g, device='cuda')
    if special:
        # negative ids wrap once; ids still out of range give NaN rows
        ids[:6] = torch.tensor([-1, -V, V, V + 5, -V - 1, 2 ** 30])
    ids = ids.to(torch.int64 if ids64 else torch.int32)
    out = ga.embedding_gather(w, ids)
    ref = ga.embedding_gather_reference(w, ids)
    torch.cuda.synchronize()
    nan_same = bool(torch.equal(torch.isnan(out), torch.isnan(ref)))
    diff = (out.float() - ref.float()).abs().nan_to_num(0.0)
    err = float(diff.max())
    res = dict(phase='kernels', kernel='embedding_gather', case=name, V=V,
               D=D, N=N, dtype=dtype, ids_dtype=str(ids.dtype),
               nan_rows=int(torch.isnan(out[:, 0]).sum()), max_abs_err=err,
               atol=0.0)
    if timed:
        # warm: the same ids again and again, so rows and output that fit
        # in L2 stay there; flushed: L2 emptied before each call
        nbytes = 2 * N * D * w.element_size() + N * ids.element_size()
        res.update(
            ms=time_ms(lambda: ga.embedding_gather(w, ids), 50),
            plain_ms=time_ms(lambda: ga.embedding_gather_reference(w, ids),
                             20),
            library_ms=time_ms(lambda: F.embedding(ids, w), 50),
            flushed_ms=time_ms_flushed(lambda: ga.embedding_gather(w, ids),
                                       20),
            library_flushed_ms=time_ms_flushed(lambda: F.embedding(ids, w),
                                               20),
            bound_ms=nbytes / HBM_BPS * 1e3, bound_by='bytes', bytes=nbytes)
        # what the card reaches on these bytes without a gather: a plain
        # contiguous copy of a tensor the size of the output
        src, dst = ref.clone(), torch.empty_like(ref)
        res.update(copy_ms=time_ms(lambda: dst.copy_(src), 50),
                   copy_flushed_ms=time_ms_flushed(lambda: dst.copy_(src),
                                                   20))
        res['gbps'] = nbytes / res['ms'] / 1e6
        res['bound_share'] = res['bound_ms'] / res['ms']
        res['flushed_bound_share'] = res['bound_ms'] / res['flushed_ms']
        res['copy_bound_share'] = res['bound_ms'] / res['copy_ms']
    emit(**res)
    require(nan_same and err == 0.0, 'embedding_gather disagrees with its '
            'plain version in case %s: %s' % (name, res))
    return res


def _close(out, ref, rtol, atol):
    """(max |out - ref|, all within atol + rtol |ref|), in float32."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def _bound(flops, nbytes, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def _valid_pairs(B, H, Tq, Tk, causal, kl):
    qpos = np.arange(Tq)
    pairs = 0
    for b in range(B):
        vis = (np.minimum(kl[b], qpos + (Tk - Tq) + 1) if causal
               else np.full(Tq, kl[b]))
        pairs += int(np.clip(vis, 0, Tk).sum()) * H
    return pairs


def _fwd_rate(dtype, design='port'):
    """The PEAK_FLOPS key of the flash forward's design in `dtype`: the
    port's, tensor cores at every D (float32 as 3xTF32; D other than 64,
    128 and 256 padded), or the CUDA-core kernel (design 'cc',
    csrc/flash_cc.cu)."""
    if design == 'cc':
        return 'float32'
    return 'tf32x3' if dtype == 'float32' else dtype


def _bwd_tc(D, dtype):
    """Whether the port's flash backward at (D, dtype name) is the
    tensor-core pair (ops/attention.py bwd_tensor_core)."""
    import torch
    from paddle_tpu_torch.ops import attention as att
    return att.bwd_tensor_core(D, getattr(torch, dtype))


def _bwd_rate(dtype, D, design='port'):
    """The PEAK_FLOPS key of the flash backward's design at (dtype, D):
    the port's, tensor cores at every D up to 256 (float32 as 3xTF32; D
    other than 64, 128 and 256 padded), or the CUDA-core kernels (design
    'cc', csrc/flash_cc.cu, on no path)."""
    if design == 'cc' or not _bwd_tc(D, dtype):
        return 'float32'
    return 'tf32x3' if dtype == 'float32' else dtype


def _padded_width(D):
    """The width of the tensor-core kernels' instance that runs head dim D
    (csrc/hopper_mma.cuh with_instance, with_fwd_instance): 64 up to 64,
    128 up to 128, else 256 (the forward's alone)."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _cc_fwd_launch(q, k, v, kl_t, causal, scale):
    """The CUDA-core design of K1 (pt_flash_cc_fwd, csrc/flash_cc.cu),
    called directly -> (out, lse): the port routes every D up to 256 to
    csrc/flash_fwd.cu, so this times the design the tensor-core kernels
    replaced, uncounted."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import attention as att
    B, H, Tq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    rc = kernels.library().pt_flash_cc_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl_t.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, k.shape[1], Tq, k.shape[2], D,
        att._DTYPE_CODE[q.dtype], int(bool(causal)), float(scale),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, 'pt_flash_cc_fwd')
    return out, lse


def _fwd_instance(name):
    """(padded width, padded) of the tensor-core flash forward kernel a
    profiler key names; None for another kernel."""
    import re
    m = re.search(r'flash_fwd_\w+?_kernel<(\d+), (true|false)', name)
    return (int(m.group(1)), m.group(2) == 'true') if m else None


def _kernel_key(name):
    """A profiler key up to its arguments, template arguments kept."""
    return name.replace('(anonymous namespace)::', '').replace(
        'void ', '').split('(')[0]


def fwd_kernels_profiled(run, dtype, D):
    """{kernel: launches} of the flash forward kernels one run() launches,
    from the profiler (names up to their arguments, template arguments
    included): one launch of the design the port routes (dtype, D) to, a
    tensor-core kernel in the instance of D's width.  A trace without it
    is taken again, up to PROFILE_TRIES times.  Each trace starts on an
    idle card and runs a short spin kernel ahead of run(): in two card
    runs a lone short forward (Tq 37 x Tk 161) left three traces in a row
    without it.  -> (kernels, the traces taken)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    got = {}
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)
            run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and 'flash_fwd' in e.key:
                key = _kernel_key(e.key)
                got[key] = got.get(key, 0) + e.count
        if got:
            break
    want = 'fwd_' + ('tf32x3' if dtype == 'float32' else 'wgmma')
    ok = list(got.values()) == [1] and _flash_design(next(iter(got))) == \
        want and _fwd_instance(next(iter(got))) == (
            _padded_width(D), D not in (64, 128, 256))
    require(ok, 'flash forward at D = %d, %s: profiled %s, expected one %s'
            % (D, dtype, got, want))
    return got, tries


def _cc_bwd_launch(entry, q, k, v, kl_t, lse, delta, do, causal, scale,
                   outs):
    """The CUDA-core design of K2 (`entry` pt_flash_cc_bwd_dq) or K3
    (pt_flash_cc_bwd_dkv) of csrc/flash_cc.cu, called directly into
    `outs`: the port routes every D up to 256 to csrc/flash_bwd.cu, so
    this times the design the tensor-core kernels replaced, uncounted."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import attention as att
    B, H, Tq, D = q.shape
    lib = kernels.library()
    rc = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl_t.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
        *[o.data_ptr() for o in outs], B, H, k.shape[1], Tq, k.shape[2], D,
        att._DTYPE_CODE[q.dtype], int(bool(causal)), float(scale),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, entry)
    return outs


def bwd_designs_profiled(B, H, Hkv, T, D, dtype):
    """The flash backward kernels one port backward at (B, H, Hkv, T, D,
    causal) launches, by design, from the profiler: the tensor-core pair
    of its dtype (bwd_tensor_core), never the CUDA-core pair.  The
    profiler drops events now and then: a trace without both is taken
    again, up to PROFILE_TRIES times."""
    import torch
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED + 9)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(B, H, T, D, generator=g, device='cuda').to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, T, D, generator=g, device='cuda').to(dt)
            for _ in range(2))
    out, lse = att.flash_forward(q, k, v, True)
    require(_bwd_tc(D, dtype), 'no tensor-core backward at D = %d, %s'
            % (D, dtype))
    tc = 'tf32x3' if dtype == 'float32' else 'wgmma'
    want = {'bwd_dq_' + tc: 1, 'bwd_dkv_' + tc: 1}
    for _ in range(PROFILE_TRIES):
        got = {name: c for name, (_, c) in _profiled(
            lambda: att.flash_backward(q, k, v, None, out, lse, do,
                                       True))[2].items()}
        if got == want:
            break
    require(got == want, 'flash backward at D = %d, %s: profiled %s, '
            'expected %s' % (D, dtype, got, want))
    return got


def flash_bwd_case(name, B, H, Hkv, Tq, Tk, D, causal, dtype, klen=None,
                   timed=False, design='port'):
    """dQ and dK/dV kernels against flash_backward_reference on the same
    q, k, v, dO and the kernel forward's out and LSE: the port's
    (flash_backward, its wrappers), or with design 'cc' the CUDA-core
    kernels called directly (_cc_bwd_launch)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(B, H, Tq, D, generator=g, device='cuda').to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, Tk, D, generator=g, device='cuda').to(dt)
            for _ in range(2))
    kl = [Tk] * B if klen is None else list(klen)
    kl_t = torch.tensor(kl, dtype=torch.int32, device='cuda')
    scale = D ** -0.5
    out, lse = att.flash_forward(q, k, v, causal, scale, kl_t)
    delta = att._bwd_delta(out, do)
    if design == 'cc':
        def run_dq():
            return _cc_bwd_launch('pt_flash_cc_bwd_dq', q, k, v, kl_t, lse,
                                  delta, do, causal, scale,
                                  (torch.empty_like(q),))

        def run_dkv():
            return _cc_bwd_launch('pt_flash_cc_bwd_dkv', q, k, v, kl_t, lse,
                                  delta, do, causal, scale,
                                  (torch.empty_like(k), torch.empty_like(v)))
        (dq,), (dk, dv) = run_dq(), run_dkv()
    else:
        def run_dq():
            return att._launch_bwd_dq(q, k, v, kl_t, lse, delta, do, causal,
                                      scale)

        def run_dkv():
            return att._launch_bwd_dkv(q, k, v, kl_t, lse, delta, do,
                                       causal, scale)
        dq, dk, dv = att.flash_backward(q, k, v, kl_t, out, lse, do, causal,
                                        scale)
    # float32 is held to the plain backward evaluated in float64 on the
    # same inputs (the exact gradients), as the card tests hold it: where a
    # k_len = 1 row of a GQA or MQA group cancels dS = P (dP - delta), the
    # plain version's own float32 rounding misses the float32 check (1.17x
    # at d256_mqa_noncausal on an H100), so only kernels that round as it
    # does could match it
    exact = (q, k, v, out, lse, do) if dtype != 'float32' else \
        tuple(t.double() for t in (q, k, v, out, lse, do))
    rq, rk, rv = att.flash_backward_reference(
        exact[0], exact[1], exact[2], kl_t, exact[3], exact[4], exact[5],
        causal, scale)
    torch.cuda.synchronize()
    # float32: sums in other orders, and dS = P (dP - delta) cancels, so
    # the bound is relative to the largest gradient; bfloat16: both round
    # an (almost equal) float32 result to bf16 once
    rtol, arel = (1e-4, 1e-5) if dtype == 'float32' else (8e-3, 2e-3)
    res = {}
    for kname, outs, refs in (('flash_attention_bwd_dq', (dq,), (rq,)),
                              ('flash_attention_bwd_dkv', (dk, dv),
                               (rk, rv))):
        errs = [_close(o, r, rtol, arel * float(r.float().abs().max()))
                for o, r in zip(outs, refs)]
        row = dict(phase='kernels', kernel=kname, case=name, B=B, H=H,
                   Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, causal=causal, dtype=dtype,
                   design=design, k_len=kl,
                   max_abs_err=max(e for e, _ in errs), rtol=rtol,
                   atol_of_max=arel, reference='the plain backward in ' + (
                       'float64' if dtype == 'float32' else dtype))
        if 0 in kl:
            zero = torch.tensor(kl, device='cuda') == 0
            row['k_len0_max_abs'] = max(float(t[zero].float().abs().max())
                                        for t in outs)
            errs.append((row['k_len0_max_abs'],
                         row['k_len0_max_abs'] == 0.0))
        ok = all(o for _, o in errs)
        res[kname] = (row, ok)
    if timed:
        itemsize = q.element_size()
        pairs = _valid_pairs(B, H, Tq, Tk, causal, kl)
        in_bytes = ((2 * B * H * Tq + 2 * B * Hkv * Tk) * D * itemsize
                    + 8 * B * H * Tq + 4 * B)
        plain_ms = time_ms(lambda: att.flash_backward_reference(
            q, k, v, kl_t, out, lse, do, causal, scale), 3)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        # the library yardstick: PyTorch's SDPA forward+backward minus its
        # forward, bf16 (key padding and GQA given as they are here)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), do)
        lib_ms = None
        if klen is None:
            lib_ms = time_ms(sdpa_fwd_bwd, 10) - time_ms(sdpa_fwd, 10)
        for kname, fn, flops_per, out_bytes in (
                ('flash_attention_bwd_dq', run_dq, 6,
                 B * H * Tq * D * itemsize),
                ('flash_attention_bwd_dkv', run_dkv, 8,
                 2 * B * Hkv * Tk * D * itemsize)):
            flops = float(flops_per * D * pairs)
            nbytes = in_bytes + out_bytes
            # float32 up to D = 128 runs as 3xTF32 on the tensor cores:
            # that rate bounds it; the CUDA cores' float32 rate is printed
            # beside.  The work is the true D's (a padded instance does
            # D / DP of its products' work usefully)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        _bwd_rate(dtype, D, design))
            row = res[kname][0]
            if design == 'port' and _bwd_tc(D, dtype) and \
                    D not in (64, 128, 256):
                row.update(DP=_padded_width(D),
                           useful_share=D / _padded_width(D))
            if dtype == 'float32':
                row['bound_cuda_cores_ms'] = _bound(flops, nbytes,
                                                    'float32')[0]
                row['bound_tf32x3_ms'] = _bound(flops, nbytes, 'tf32x3')[0]
            row.update(ms=time_ms(fn, 10), plain_ms=plain_ms,
                       plain_is='the whole plain backward (dq, dk, dv)',
                       library_ms=lib_ms,
                       library_is='SDPA fwd+bwd minus fwd (dq, dk, dv)',
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                       bytes=nbytes)
            row['tflops'] = flops / row['ms'] / 1e9
            row['bound_share'] = bound_ms / row['ms']
    for kname, (row, ok) in res.items():
        emit(**row)
        require(ok, '%s disagrees with its plain version in case %s: %s'
                % (kname, name, row))
    return {k: r for k, (r, _) in res.items()}


def layer_norm_case(name, rows, cols, dtype, affine=True, two_pass=False,
                    offset=0.0, timed=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn as tnn
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    x = (torch.randn(rows, cols, generator=g, device='cuda')
         + offset).to(getattr(torch, dtype))
    scale = bias = None
    if affine:
        scale = 1.0 + 0.1 * torch.randn(cols, generator=g, device='cuda')
        bias = 0.1 * torch.randn(cols, generator=g, device='cuda')
    eps = 1e-5
    y, m, v = tnn.layer_norm_rows(x, scale, bias, eps, two_pass)
    ry, rm, rv = tnn.layer_norm_reference(x, scale, bias, eps, two_pass)
    torch.cuda.synchronize()
    # float32 sums in other orders; bf16 Y: one rounding of ~equal floats
    rtol, atol = (1e-5, 1e-5) if dtype == 'float32' else (8e-3, 8e-3)
    e_y, ok_y = _close(y, ry, rtol, atol)
    e_m, ok_m = _close(m, rm, 1e-5, 1e-5)
    e_v, ok_v = _close(v, rv, 1e-4, 1e-6)
    row = dict(phase='kernels', kernel='layer_norm', case=name, rows=rows,
               cols=cols, dtype=dtype, affine=affine, two_pass=two_pass,
               offset=offset, max_abs_err=e_y, mean_err=e_m, var_err=e_v,
               rtol=rtol, atol=atol)
    if timed:
        nbytes = 2 * rows * cols * x.element_size() + 8 * rows + 8 * cols
        bound_ms, bound_by = _bound(0.0, nbytes, dtype)
        row.update(
            ms=time_ms(lambda: tnn.layer_norm_rows(x, scale, bias, eps,
                                                   two_pass), 50),
            plain_ms=time_ms(lambda: tnn.layer_norm_reference(
                x, scale, bias, eps, two_pass), 20),
            library_ms=time_ms(lambda: F.layer_norm(x, (cols,), scale, bias,
                                                    eps), 50),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(ok_y and ok_m and ok_v, 'layer_norm disagrees with its plain '
            'version in case %s: %s' % (name, row))
    return row


def transformer_param_shapes():
    """The 158 parameter shapes of the training program at the bench
    configuration, from the port's layers (no weights are made)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tr.build(**BENCH_CFG)
    return [tuple(p.shape) for p in main.all_parameters()]


def adam_case(name, shapes, steps=3, timed=False):
    """adam_multi over the tensors of `shapes` against adam_reference on
    copies, `steps` steps with an LR tensor on the device."""
    import torch
    from paddle_tpu_torch.ops import optimizer_ops as oo
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    n = len(shapes)

    def rand(shape, s=1.0):
        return s * torch.randn(shape, generator=g, device='cuda')
    params = [rand(s, 0.05) for s in shapes]
    m1s = [rand(s, 1e-3) for s in shapes]
    m2s = [rand(s, 1e-3).square() for s in shapes]
    b1, b2, eps = 0.9, 0.997, 1e-9
    b1ps = [torch.full((1,), b1 ** 3, device='cuda') for _ in range(n)]
    b2ps = [torch.full((1,), b2 ** 3, device='cuda') for _ in range(n)]
    lr = [torch.full((1,), 1e-3, device='cuda')] * n
    state = [params, m1s, m2s, b1ps, b2ps]
    ref = [[t.clone() for t in col] for col in state]
    cache = {}
    for _ in range(steps):
        grads = [rand(s, 1e-2) for s in shapes]
        oo.adam_multi(params, grads, m1s, m2s, b1ps, b2ps, lr, b1, b2, eps,
                      cache=cache)
        oo.adam_reference(ref[0], grads, ref[1], ref[2], ref[3], ref[4], lr,
                          b1, b2, eps)
    torch.cuda.synchronize()
    # the kernel rounds each operation in the reference's order (IEEE
    # multiply, add, divide and square root, no FMA contraction): equal up
    # to the last bit of PyTorch's own elementwise kernels
    errs = [_close(torch.cat([t.reshape(-1) for t in a]),
                   torch.cat([t.reshape(-1) for t in r]), 2e-6, 1e-12)
            for a, r in zip(state, ref)]
    pows_ok = bool(torch.allclose(b1ps[0], torch.full_like(
        b1ps[0], b1 ** (3 + steps)), rtol=1e-6))
    row = dict(phase='kernels', kernel='adam_multi', case=name, tensors=n,
               elements=int(sum(int(np.prod(s)) for s in shapes)),
               steps=steps, max_abs_err=max(e for e, _ in errs),
               rtol=2e-6, atol=1e-12, pows_advanced=pows_ok)
    if timed:
        grads = [rand(s, 1e-2) for s in shapes]
        elems = row['elements']
        nbytes = 28 * elems + 16 * n
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        lib_params = [p.clone().requires_grad_(True) for p in params]
        for p, gr in zip(lib_params, grads):
            p.grad = gr
        lib = torch.optim.Adam(lib_params, lr=1e-3, betas=(b1, b2), eps=eps,
                               fused=True)
        row.update(
            ms=time_ms(lambda: oo.adam_multi(params, grads, m1s, m2s, b1ps,
                                             b2ps, lr, b1, b2, eps,
                                             cache=cache), 20),
            plain_ms=time_ms(lambda: oo.adam_reference(
                ref[0], grads, ref[1], ref[2], ref[3], ref[4], lr, b1, b2,
                eps), 5),
            library_ms=time_ms(lib.step, 20),
            library_is='torch.optim.Adam(fused=True).step(), eps placed '
                       'otherwise: a timing yardstick only',
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            table_builds=cache.get('adam_multi_tables'))
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(all(o for _, o in errs) and pows_ok, 'adam_multi disagrees '
            'with adam_reference in case %s: %s' % (name, row))
    return row


def resnet50_param_shapes():
    """The 161 trainable tensor shapes of the ResNet-50 training program
    (models/resnet.py::bench_program), from the port's layers."""
    from paddle_tpu_torch.models import resnet
    main = resnet.bench_program(**RESNET_CFG)[0]
    return [tuple(p.shape) for p in main.all_parameters() if p.trainable]


def momentum_case(name, shapes, nesterov, steps=3, timed=False):
    """momentum_multi over the tensors of `shapes` against
    momentum_reference on copies, `steps` steps with an LR tensor on the
    device: bit for bit (the kernel rounds each operation as PyTorch's
    elementwise kernels do, no FMA contraction)."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import optimizer_ops as oo
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    n, mu = len(shapes), 0.9

    def rand(shape, s):
        return s * torch.randn(shape, generator=g, device='cuda')
    params = [rand(s, 0.05) for s in shapes]
    vels = [rand(s, 1e-3) for s in shapes]
    lr = [torch.full((1,), 0.1, device='cuda')] * n
    ref = [[t.clone() for t in params], [t.clone() for t in vels]]
    cache = {}
    before = kernels.launches['momentum_multi']
    for _ in range(steps):
        grads = [rand(s, 1e-2) for s in shapes]
        oo.momentum_multi(params, grads, vels, lr, mu, nesterov, cache=cache)
        oo.momentum_reference(ref[0], grads, ref[1], lr, mu, nesterov)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(params + vels,
                                                    ref[0] + ref[1]))
    err = max(float((a - b).abs().max()) for a, b in zip(
        params + vels, ref[0] + ref[1]))
    elems = int(sum(int(np.prod(s)) for s in shapes))
    row = dict(phase='kernels', kernel='momentum_multi', case=name,
               tensors=n, elements=elems, nesterov=nesterov, steps=steps,
               launches=kernels.launches['momentum_multi'] - before,
               bitwise=bitwise, max_abs_err=err, rtol=0.0, atol=0.0)
    if timed:
        grads = [rand(s, 1e-2) for s in shapes]
        # p, g and v read, p and v written: 20 bytes an element
        nbytes = 20 * elems
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        lib_params = [p.clone().requires_grad_(True) for p in params]
        for p, gr in zip(lib_params, grads):
            p.grad = gr
        try:
            lib = torch.optim.SGD(lib_params, lr=0.1, momentum=mu,
                                  nesterov=nesterov, fused=True)
            lib_is = 'torch.optim.SGD(momentum=0.9, fused=True).step()'
        except (RuntimeError, TypeError, ValueError) as e:
            lib = torch.optim.SGD(lib_params, lr=0.1, momentum=mu,
                                  nesterov=nesterov, foreach=True)
            lib_is = 'torch.optim.SGD(momentum=0.9, foreach=True).step() ' \
                '(fused=True refused: %s)' % e
        # the kernel alone, as a graph replay runs it: its two tables
        # already on the device
        table, step, n_chunks = oo._momentum_tables(params, grads, vels, lr,
                                                    cache, None)
        lib_fn = kernels.library().pt_momentum_multi

        def launch():
            kernels.check(lib_fn(table.data_ptr(), step.data_ptr(), n,
                                 n_chunks, mu, int(nesterov),
                                 torch.cuda.current_stream().cuda_stream),
                          'momentum_multi')
        row.update(
            ms=time_ms(launch, 50),
            plain_ms=time_ms(lambda: oo.momentum_reference(
                ref[0], grads, ref[1], lr, mu, nesterov), 5),
            library_ms=time_ms(lib.step, 20), library_is=lib_is,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            table_builds=cache.get('momentum_multi_tables'))
        row['gbps'] = nbytes / row['ms'] / 1e6
        row['bound_share'] = bound_ms / row['ms']
    emit(**row)
    require(bitwise and row['launches'] == steps, 'momentum_multi '
            'disagrees with momentum_reference in case %s: %s'
            % (name, row))
    return row


# bytes a kernel instance of csrc/optim_multi.cu moves per element: p and g
# read, p written, and each state array read and written
OPTIM_BYTES = {'sgd': 12, 'adagrad': 20, 'decayed_adagrad': 20,
               'adamax': 28, 'adadelta': 28, 'rmsprop': 28, 'ftrl': 28,
               'ftrl_pow': 28, 'rmsprop_centered': 36}
# the instances: name -> (op type, attrs); the kernels phase runs each at
# ResNet-50's and at Wide&Deep's (CTR_VOCAB) parameter shapes
OPTIM_CASES = {
    'sgd': ('sgd', {}),
    'adagrad': ('adagrad', {'epsilon': 1e-6}),
    'decayed_adagrad': ('decayed_adagrad', {'decay': 0.95, 'epsilon': 1e-6}),
    'adamax': ('adamax', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
    'adadelta': ('adadelta', {'rho': 0.95, 'epsilon': 1e-6}),
    'rmsprop': ('rmsprop', {'decay': 0.95, 'epsilon': 1e-6,
                            'momentum': 0.9}),
    'rmsprop_centered': ('rmsprop', {'decay': 0.95, 'epsilon': 1e-6,
                                     'momentum': 0.9, 'centered': True}),
    'ftrl': ('ftrl', {'l1': 1e-4, 'l2': 1e-3}),
    'ftrl_pow': ('ftrl', {'l1': 1e-4, 'l2': 1e-3, 'lr_power': -0.6}),
}


def optim_state(op_type, key, shapes, g):
    """(params, state arrays by slot, scalars) of `op_type` at `shapes`,
    on the card from generator `g`: params 0.05 N(0, 1), the state arrays
    1e-3 |N(0, 1)| (a signed moment or linear accumulator where the update
    takes no root of it; centered rmsprop's mean square above its mean
    grad squared), adamax's Beta1Pow 0.9^3."""
    import torch
    from paddle_tpu_torch.ops import optimizer_ops as oo

    def rand(shape, s):
        return s * torch.randn(shape, generator=g, device='cuda')
    params = [rand(s, 0.05) for s in shapes]
    slots = oo.array_slots(op_type, key)
    arrays = [[rand(s, 1e-3).abs() for s in shapes] for _ in slots]
    for i, slot in enumerate(slots):
        if slot in ('Moment', 'LinearAccumulator') and \
                op_type in ('rmsprop', 'ftrl'):
            arrays[i] = [t * torch.sign(rand(t.shape, 1.0)) for t in
                         arrays[i]]
    if 'MeanGrad' in slots:
        mg = [rand(s, 1e-2) for s in shapes]
        arrays[2] = mg
        arrays[0] = [m * m + a for m, a in zip(mg, arrays[0])]
    scalars = [torch.full((1,), 0.9 ** 3, device='cuda') for _ in shapes] \
        if op_type == 'adamax' else None
    return params, arrays, scalars


def _optim_library(kind, key, params, grads, lr):
    """(torch optimizer over copies of `params` with `grads` set, what it
    is, whether it computes the reference's function) for the instance
    `kind`, or (None, why, None) where torch has no such optimizer."""
    import torch
    o = torch.optim
    lp = [p.clone().requires_grad_(True) for p in params]
    for p, gr in zip(lp, grads):
        p.grad = gr
    if kind == 'sgd':
        try:
            return (o.SGD(lp, lr=lr, fused=True),
                    'torch.optim.SGD(fused=True).step()',
                    'the same function, p - lr g')
        except (RuntimeError, TypeError, ValueError):
            return (o.SGD(lp, lr=lr, foreach=True),
                    'torch.optim.SGD(foreach=True).step()',
                    'the same function, p - lr g')
    if kind == 'adagrad':
        return (o.Adagrad(lp, lr=lr, eps=key[0], foreach=True),
                'torch.optim.Adagrad(foreach=True).step()',
                'the same function, m + g^2, p - lr g / (sqrt(m) + eps)')
    if kind == 'decayed_adagrad':
        return (o.RMSprop(lp, lr=lr, alpha=key[0], eps=key[1], momentum=0,
                          foreach=True),
                'torch.optim.RMSprop(alpha=decay, momentum=0, '
                'foreach=True).step()',
                'the same function, d m + (1 - d) g^2, p - lr g / '
                '(sqrt(m) + eps)')
    if kind == 'adamax':
        return (o.Adamax(lp, lr=lr, betas=key[:2], eps=key[2], foreach=True),
                'torch.optim.Adamax(foreach=True).step()',
                'a different function: u = max(b2 u, |g| + eps), eps inside '
                'the max, not added to u')
    if kind == 'adadelta':
        return (o.Adadelta(lp, lr=1.0, rho=key[0], eps=key[1], foreach=True),
                'torch.optim.Adadelta(lr=1, foreach=True).step()',
                'the same function at lr 1 (the reference\'s has no lr), '
                'its root taken of numerator and denominator apart')
    if kind in ('rmsprop', 'rmsprop_centered'):
        return (o.RMSprop(lp, lr=lr, alpha=key[0], eps=key[1],
                          momentum=key[2], centered=key[3], foreach=True),
                'torch.optim.RMSprop(momentum=%g, centered=%s, '
                'foreach=True).step()' % (key[2], key[3]),
                'a different function: eps added after the root, and lr '
                'applied after the momentum (v = mu v + g / (sqrt(s) + '
                'eps), p - lr v)')
    return None, 'torch has no FTRL optimizer', None


def optim_case(name, case, shapes, steps=3, timed=False):
    """optim_multi of OPTIM_CASES[case] over tensors of `shapes` against
    optim_reference on copies, `steps` steps with an LR tensor on the
    device, each step from the same inputs: bit for bit (the kernel
    rounds each operation as PyTorch's elementwise kernels do, no FMA
    contraction), the pow instance (ftrl_pow) within
    optimizer_ops.ftrl_pow_bound.  Timed: the kernel alone (its tables on
    the device), the plain version, the library call (_optim_library) and
    the bound (OPTIM_BYTES an element at HBM_BPS)."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import optimizer_ops as oo
    op_type, attrs = OPTIM_CASES[case]
    key = oo.optim_key(op_type, attrs)
    kind = oo._kind(op_type, key)
    counter = kind + '_multi'
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    params, arrays, scalars = optim_state(op_type, key, shapes, g)
    n = len(params)
    lrs = None if op_type == 'adadelta' else \
        [torch.full((1,), 0.01, device='cuda')] * n
    cache = {}
    before = kernels.launches[counter]
    bitwise, within, err, share = True, True, 0.0, 0.0
    for _ in range(steps):
        grads = [1e-2 * torch.randn(p.shape, generator=g, device='cuda')
                 for p in params]
        ins = [t.clone() for t in params], [[t.clone() for t in c]
                                            for c in arrays]
        ref = [t.clone() for t in params], [[t.clone() for t in c]
                                            for c in arrays]
        oo.optim_multi(op_type, params, grads, arrays, scalars, lrs, key,
                       cache=cache)
        oo.optim_reference(op_type, ref[0], grads, ref[1], scalars, lrs,
                           key)
        torch.cuda.synchronize()
        outs = params + [t for c in arrays for t in c]
        refs = ref[0] + [t for c in ref[1] for t in c]
        err = max([err] + [float((a - b).abs().max())
                           for a, b in zip(outs, refs)])
        bitwise &= all(torch.equal(a, b) for a, b in zip(outs, refs))
        if kind == 'ftrl_pow':
            for i in range(n):
                bp, bz = oo.ftrl_pow_bound(ins[0][i], grads[i], ins[1][0][i],
                                           ins[1][1][i], lrs[i], key)
                for a, b, bd in ((params[i], ref[0][i], bp),
                                 (arrays[1][i], ref[1][1][i], bz)):
                    d = (a.double() - b.double()).abs()
                    within &= bool((d <= bd).all())
                    share = max(share, float((d / bd.clamp_min(1e-300))
                                             .max()))
                within &= bool(torch.equal(arrays[0][i], ref[1][0][i]))
            # each step from the same inputs
            for a, b in zip(outs, refs):
                a.copy_(b)
    elems = int(sum(int(np.prod(s)) for s in shapes))
    row = dict(phase='kernels', kernel='optim_multi', instance=kind,
               case=name, tensors=n, elements=elems, key=list(key),
               steps=steps, launches=kernels.launches[counter] - before,
               bitwise=bitwise, max_abs_err=err,
               rtol=0.0, atol=0.0)
    if kind == 'ftrl_pow':
        row.update(held='ftrl_pow_bound (POW_ULPS %d)' % oo.POW_ULPS,
                   within_bound=within, max_share_of_bound=share)
    if timed:
        grads = [1e-2 * torch.randn(p.shape, generator=g, device='cuda')
                 for p in params]
        nbytes = OPTIM_BYTES[kind] * elems
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        lib, lib_is, lib_same = _optim_library(kind, key, params, grads,
                                               0.01)
        # the kernel alone, as a graph replay runs it: its two tables
        # already on the device
        table, step, n_chunks = oo._optim_tables(kind, params, grads, arrays,
                                                 scalars, lrs, cache, None)
        consts = oo._optim_consts(op_type, key)
        lib_fn, kid = kernels.library().pt_optim_multi, oo._KINDS.index(kind)

        def launch():
            kernels.check(lib_fn(kid, table.data_ptr(), step.data_ptr(), n,
                                 n_chunks, *consts,
                                 torch.cuda.current_stream().cuda_stream),
                          counter)
        row.update(
            ms=time_ms(launch, 50),
            plain_ms=time_ms(lambda: oo.optim_reference(
                op_type, ref[0], grads, ref[1], scalars, lrs, key), 3),
            library_ms=time_ms(lib.step, 20) if lib else None,
            library_is=lib_is, library_computes=lib_same,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            bytes_per_element=OPTIM_BYTES[kind],
            table_builds=cache.get(counter + '_tables'))
        row['gbps'] = nbytes / row['ms'] / 1e6
        row['bound_share'] = bound_ms / row['ms']
    emit(**row)
    require((within if kind == 'ftrl_pow' else bitwise) and
            row['launches'] == steps, 'optim_multi (%s) disagrees with '
            'optim_reference in case %s: %s' % (kind, name, row))
    return row


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def optim_bf16_case(name, case, shapes, timed=False):
    """C11's bf16 instances: `case` 'momentum' (csrc/momentum.cu
    momentum_bf16_kernel) or one of OPTIM_CASES (csrc/optim_multi.cu
    optim_bf16_kernel) over tensors of `shapes` with the param, grad and
    state (and adamax's Beta1Pow) bf16 and the learning rate float32, one
    step, against the plain version on copies: the outputs in jnp's
    promoted dtypes (the param float32), bit for bit (the pow instance
    within optimizer_ops.ftrl_pow_bound).  Timed: the kernel alone (its
    tables on the device), the plain version and the bound (each input
    read once at its dtype, each output written once at its dtype, at
    HBM_BPS); no library call: torch's optimizers keep a bf16 parameter
    bf16, a different function."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import optimizer_ops as oo
    bf = torch.bfloat16
    g = torch.Generator(device='cuda').manual_seed(SEED + 13)
    if case == 'momentum':
        kind, counter = 'momentum', 'momentum_multi_bf16'
        params = [(0.05 * torch.randn(s, generator=g, device='cuda'))
                  .to(bf) for s in shapes]
        arrays = [[(1e-3 * torch.randn(s, generator=g, device='cuda'))
                   .to(bf) for s in shapes]]
        scalars, key = None, None
    else:
        op_type, attrs = OPTIM_CASES[case]
        key = oo.optim_key(op_type, attrs)
        kind = oo._kind(op_type, key)
        counter = kind + '_multi_bf16'
        params, arrays, scalars = optim_state(op_type, key, shapes, g)
        params = [t.to(bf) for t in params]
        arrays = [[t.to(bf) for t in col] for col in arrays]
        scalars = scalars and [t.to(bf) for t in scalars]
    grads = [(1e-2 * torch.randn(p.shape, generator=g, device='cuda'))
             .to(bf) for p in params]
    lrs = None if case == 'adadelta' else \
        [torch.full((1,), 0.01, device='cuda')] * len(params)
    ins = [t.clone() for t in params], [[t.clone() for t in c]
                                        for c in arrays]

    def run(multi, ps, arrs):
        if case == 'momentum':
            f = oo.momentum_multi if multi else oo.momentum_reference
            pn, vn = f(ps, grads, arrs[0], lrs, 0.9, False)
            return pn, [vn]
        f = oo.optim_multi if multi else oo.optim_reference
        return f(op_type, ps, grads, arrs, scalars, lrs, key)
    before = kernels.launches[counter]
    got = run(True, params, arrays)
    want = run(False, [t.clone() for t in ins[0]],
               [[t.clone() for t in c] for c in ins[1]])
    torch.cuda.synchronize()
    outs = got[0] + [t for c in got[1] for t in c]
    refs = want[0] + [t for c in want[1] for t in c]
    dtypes_equal = [t.dtype for t in outs] == [t.dtype for t in refs]
    # equal, NaN where NaN (centered rmsprop's root of a bf16 mean square
    # that rounding took below its mean grad squared)
    bitwise = dtypes_equal and all(
        bool(((a == b) | (a.isnan() & b.isnan())).all())
        for a, b in zip(outs, refs))
    err = max(float((a.double() - b.double()).nan_to_num().abs().max())
              for a, b in zip(outs, refs))
    nans = sum(int(t.isnan().sum()) for t in refs)
    within, share = bitwise, 0.0
    if kind == 'ftrl_pow':
        within = dtypes_equal
        for i in range(len(params)):
            bp, bz = oo.ftrl_pow_bound(ins[0][i], grads[i], ins[1][0][i],
                                       ins[1][1][i], lrs[i], key)
            for a, b, bd in ((got[0][i], want[0][i], bp),
                             (got[1][1][i], want[1][1][i], bz)):
                d = (a.double() - b.double()).abs()
                within &= bool((d <= bd).all())
                share = max(share, float((d / bd.clamp_min(1e-300)).max()))
            within &= bool(torch.equal(got[1][0][i], want[1][0][i]))
    elems = int(sum(int(np.prod(s)) for s in shapes))
    row = dict(phase='kernels', kernel=counter, instance=kind, case=name,
               tensors=len(shapes), elements=elems,
               in_dtypes='bf16 param, grad and state, float32 lr',
               out_dtypes=sorted({str(t.dtype) for t in outs}),
               launches=kernels.launches[counter] - before,
               dtypes_equal=dtypes_equal, bitwise=bitwise,
               nan_in_plain=nans, max_abs_err=err, rtol=0.0, atol=0.0)
    if kind == 'ftrl_pow':
        row.update(held='ftrl_pow_bound (POW_ULPS %d, bf16 state)'
                   % oo.POW_ULPS, within_bound=within,
                   max_share_of_bound=share)
    if timed:
        nbytes = _nbytes(params + grads + [t for c in arrays for t in c]) + \
            _nbytes(outs)
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        lib = kernels.library()
        stream = torch.cuda.current_stream().cuda_stream
        # the kernel alone, as a graph replay runs it: its tables on the
        # device, writing the outputs of the timed call's tables
        if case == 'momentum':
            table, step, n_chunks, _, flags = oo._momentum_bf16_tables(
                params, grads, arrays[0], lrs, False, None)

            def launch():
                kernels.check(lib.pt_momentum_multi_bf16(
                    table.data_ptr(), step.data_ptr(), len(params),
                    n_chunks, 0.9, oo._bf16_const(0.9), 0, flags, stream),
                    counter)
        else:
            table, step, n_chunks, _, flags = oo._optim_bf16_tables(
                op_type, key, params, grads, arrays, scalars, lrs, None)
            consts = oo._optim_consts(op_type, key) + \
                oo._optim_consts(op_type, key, bf)
            kid = oo._KINDS.index(kind)

            def launch():
                kernels.check(lib.pt_optim_multi_bf16(
                    kid, table.data_ptr(), step.data_ptr(), len(params),
                    n_chunks, *consts, flags, stream), counter)
        row.update(
            ms=time_ms(launch, 50),
            plain_ms=time_ms(lambda: run(False, [t.clone() for t in ins[0]],
                                         [[t.clone() for t in c]
                                          for c in ins[1]]), 3),
            library_ms=None,
            library_is='none: torch\'s optimizers keep a bf16 parameter '
            'and its state bf16 (the reference promotes the parameter to '
            'float32), a different function',
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
        row['bound_share'] = bound_ms / row['ms']
    emit(**row)
    require(within and row['launches'] == 1, '%s disagrees with its plain '
            'version in case %s: %s' % (counter, name, row))
    return row


def ctr_param_shapes(model='wide_deep', vocab=None):
    """The trainable tensor shapes of a CTR training program at the
    builders' widths and `vocab` (CTR_VOCAB) rows (no weights are
    made)."""
    main = ctr_program(model, vocab=vocab or CTR_VOCAB, B=1)[0]
    return [tuple(p.shape) for p in main.all_parameters() if p.trainable]


def llama_param_shapes():
    """The 147 parameter shapes of the training llama_1b program (no
    weights are made)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import llama
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        llama.build('llama_1b')
    return [tuple(p.shape) for p in main.all_parameters()]


def adam_bf16_case(name, shapes, timed=False, state='bfloat16'):
    """adam_multi's bf16 instance against adam_reference on copies, one
    step as the bf16 llama build takes it: its first with `state`
    bfloat16 (bf16 parameters, moments and beta powers), its later ones
    with `state` float32 (float32 parameters and moments, the beta powers
    still bf16); the clip's float32 gradients; float32 parameters and
    moments out."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import optimizer_ops as oo
    g = torch.Generator(device='cuda').manual_seed(SEED + 6)
    bf = torch.bfloat16
    st = getattr(torch, state)
    n = len(shapes)

    def rand(shape, s, dt=st):
        return (s * torch.randn(shape, generator=g, device='cuda')).to(dt)
    params = [rand(s, 0.02) for s in shapes]
    m1s = [rand(s, 1e-3) for s in shapes]
    m2s = [rand(s, 1e-3).square() for s in shapes]
    b1ps = [torch.full((1,), 0.9, device='cuda').to(bf) for _ in range(n)]
    b2ps = [torch.full((1,), 0.95, device='cuda').to(bf) for _ in range(n)]
    lr = [torch.full((1,), 3e-4, device='cuda')] * n
    grads = [rand(s, 1e-4, torch.float32) for s in shapes]
    ref = [[t.clone() for t in col] for col in (params, m1s, m2s, b1ps,
                                                  b2ps)]
    before = kernels.launches['adam_multi_bf16']
    got = oo.adam_multi(params, grads, m1s, m2s, b1ps, b2ps, lr, 0.9, 0.95,
                        1e-8)
    bf16_instance = kernels.launches['adam_multi_bf16'] == before + 1
    want = oo.adam_reference(ref[0], grads, ref[1], ref[2], ref[3], ref[4],
                             lr, 0.9, 0.95, 1e-8)
    torch.cuda.synchronize()
    # the same IEEE operations and bf16 roundings in the same order
    errs = [_close(torch.cat([t.reshape(-1) for t in a]),
                   torch.cat([t.reshape(-1) for t in r]), 2e-6, 1e-12)
            for a, r in zip(got, want)]
    dtypes_ok = all(a.dtype == r.dtype == torch.float32
                    for col, rcol in zip(got, want) for a, r in zip(col, rcol))
    pows_ok = all(torch.equal(a, r) and a.dtype == bf for a, r in
                  zip(b1ps + b2ps, ref[3] + ref[4]))
    elems = int(sum(int(np.prod(s)) for s in shapes))
    row = dict(phase='kernels', kernel='adam_multi_bf16', case=name,
               state=state, tensors=n, elements=elems,
               max_abs_err=max(e for e, _ in errs), rtol=2e-6, atol=1e-12,
               dtypes_out='float32', pows_exact=pows_ok,
               bf16_instance=bf16_instance)
    del got, want, ref
    if timed:
        # reads p, m1, m2 (bf16) and g (float32), writes p, m1, m2 (float32)
        nbytes = (3 * 2 + 4 + 3 * 4) * elems + 4 * n
        bound_ms, bound_by = _bound(0.0, nbytes, 'bfloat16')
        lib_params = [p.clone().requires_grad_(True) for p in params]
        for p, gr in zip(lib_params, grads):
            p.grad = gr.to(bf)
        lib = torch.optim.Adam(lib_params, lr=3e-4, betas=(0.9, 0.95),
                               eps=1e-8, fused=True)
        row.update(
            ms=time_ms(lambda: oo.adam_multi(params, grads, m1s, m2s, b1ps,
                                             b2ps, lr, 0.9, 0.95, 1e-8), 10),
            plain_ms=time_ms(lambda: oo.adam_reference(
                [p.clone() for p in params], grads, [m.clone() for m in m1s],
                [m.clone() for m in m2s], b1ps, b2ps, lr, 0.9, 0.95, 1e-8),
                2),
            library_ms=time_ms(lib.step, 10),
            library_is='torch.optim.Adam(fused=True).step() over bf16 '
                       'parameters and grads, in place: a timing yardstick '
                       'only',
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
        del lib, lib_params
    emit(**row)
    require(all(o for _, o in errs) and dtypes_ok and pows_ok and
            bf16_instance,
            'adam_multi_bf16 disagrees with adam_reference in case %s: %s'
            % (name, row))
    return row


def softmax_case(name, rows, cols, dtype, neg_inf_rows=0, timed=False):
    """K5 against softmax_reference on the same rows; timed at the
    composed attention's scores (65,536 rows of 256, float32)."""
    import torch
    from paddle_tpu_torch.ops import nn as tnn
    g = torch.Generator(device='cuda').manual_seed(SEED + 9)
    x = (3 * torch.randn(rows, cols, generator=g, device='cuda')).to(
        getattr(torch, dtype))
    x[:neg_inf_rows] = float('-inf')
    y = tnn.softmax_rows(x)
    ref = tnn.softmax_reference(x)
    torch.cuda.synchronize()
    # float32: the same operations, the row sums in other orders; bf16:
    # one rounding of (almost) equal float32 results
    rtol, atol = (1e-5, 1e-7) if dtype == 'float32' else (8e-3, 1e-3)
    nan_same = bool(torch.equal(torch.isnan(y), torch.isnan(ref)))
    err, ok = _close(y.nan_to_num(0.0), ref.nan_to_num(0.0), rtol, atol)
    row = dict(phase='kernels', kernel='softmax', case=name, rows=rows,
               cols=cols, dtype=dtype, neg_inf_rows=neg_inf_rows,
               max_abs_err=err, rtol=rtol, atol=atol, nan_rows_equal=nan_same)
    if timed:
        nbytes = 2 * rows * cols * x.element_size()
        # max, subtract, exp, sum and divide: 5 operations an element
        bound_ms, bound_by = _bound(5.0 * rows * cols, nbytes, 'float32')
        row.update(
            ms=time_ms(lambda: tnn.softmax_rows(x), 50),
            plain_ms=time_ms(lambda: tnn.softmax_reference(x), 20),
            library_ms=time_ms(lambda: torch.softmax(x, -1), 50),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        row['gbps'] = nbytes / row['ms'] / 1e6
    emit(**row)
    require(ok and nan_same, 'softmax disagrees with its plain version in '
            'case %s: %s' % (name, row))
    return row


def _meta_env(main, feed, bf16=False):
    """Meta tensors for a program's persistables and a feed: enough for
    the executor's planning pass, with no weights made; with `bf16` the
    float32 persistables are bf16, as a Predictor with enable_bf16 holds
    them."""
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype

    def dt(v):
        d = torch_dtype(v.dtype)
        return torch.bfloat16 if bf16 and d == torch.float32 else d
    env = {v.name: torch.empty(v.shape, dtype=dt(v), device='meta')
           for v in main.list_vars() if v.persistable}
    block = main.global_block()
    for name, a in feed.items():
        env[name] = torch.empty(a.shape, device='meta',
                                dtype=torch_dtype(block.var(name).dtype))
    return env


def _planned_specs(main, feed, fetch_names, amp, bf16=False,
                   promoted=False, dtypes=None):
    """The generated segments `main` runs at `feed`'s shapes, from the
    executor's planning pass on meta tensors: name -> (spec, sub-op
    types).  `bf16`: with bf16 parameters (enable_bf16).  `promoted`:
    the bf16 llama build after its first step, every bf16 persistable
    float32 but the beta powers.  `dtypes`: {persistable: torch dtype}
    that a scope holds at a later step."""
    import torch
    from paddle_tpu_torch.core import executor as ex, passes
    from paddle_tpu_torch.ops import kernelgen
    opt, _ = passes.maybe_optimize(main, fetch_names)
    env = _meta_env(main, feed, bf16)
    if promoted:
        for n, t in env.items():
            if t.dtype == torch.bfloat16 and '_pow_acc' not in n:
                env[n] = torch.empty(t.shape, dtype=torch.float32,
                                     device='meta')
    for n, d in (dtypes or {}).items():
        if n in env:
            env[n] = torch.empty(env[n].shape, dtype=d, device='meta')
    seen, real = [], kernelgen.plan_for

    def spy(attrs, avals, amp_):
        plan = real(attrs, avals, amp_)
        seen.append(plan)
        return plan
    kernelgen.plan_for = spy
    try:
        ex._plan_kernels(opt.global_block().ops, env, amp)
    finally:
        kernelgen.plan_for = real
    specs = {}
    for plan in seen:
        for kind, *rest in plan.steps:
            if kind == 'kernel':
                spec = rest[0]
                specs.setdefault(spec.name, (spec, '+'.join(
                    op[0]['type'] for op in spec.ops)))
    return specs


def path_segments():
    """Every generated segment the main paths run: the composed and the
    flash training steps (B=32, T=256, bf16 AMP), the flash step in
    float32, the training llama_1b (B=2, T=2048; float32, and the bf16
    build before and after its first step), the ResNet-50 AMP step (B=128,
    224 x 224), the stacked-LSTM LM (B 32, T 512), and the served llama_1b
    decode program at each bucket (1, 2, 4 rows x 2048 tokens) in float32
    and with bf16 parameters: name -> (spec, sub-op types, paths)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models import transformer as tr
    found = []
    feed = tr.synthetic_batch(np.random.RandomState(0), 32,
                              COMPOSED_CFG['max_len'],
                              COMPOSED_CFG['trg_vocab'])
    for path, cfg, amp in (('training_composed', COMPOSED_CFG, True),
                           ('training', BENCH_CFG, True),
                           ('training_f32', BENCH_CFG, False)):
        main, _, out = _train_program(fluid, tr, amp=amp, **cfg)
        found.append((path, _planned_specs(main, feed, [out['loss'].name],
                                           amp)))
    # the training llama at full size, float32 and the bf16 build (its
    # bf16 first step and its later steps on float32 state)
    lfeed = _llama_batch(llama, LLAMA_B, 2048, 32000)
    for path, dtype, promoted in (('training_llama', 'float32', False),
                                  ('training_llama_bf16', 'bfloat16', False),
                                  ('training_llama_bf16', 'bfloat16', True)):
        main, _, out = _llama_program(fluid, llama, dtype=dtype)
        found.append((path, _planned_specs(main, lfeed, [out['loss'].name],
                                           False, promoted=promoted)))
    # the ResNet-50 AMP step at its bench shape
    from paddle_tpu_torch.models import resnet
    main, _, out, rfeed = resnet.bench_program(**RESNET_CFG)
    found.append(('training_resnet50', _planned_specs(
        main, rfeed, [out['loss'].name], True)))
    # SE-ResNeXt-50, VGG-16 and MNIST at their configurations
    for name in CONV_CFGS:
        main, _, out, cfeed, amp = conv_program(name)
        found.append(('training_' + name, _planned_specs(
            main, cfeed, [out['loss'].name], amp)))
    # the stacked-LSTM LM at its T bucket of 512
    from paddle_tpu_torch.core.executor import normalize_feed
    main, _, out, feeder, bucketer = sl_program()
    sfeed = sl_feed(feeder, bucketer, review_rows(
        np.random.RandomState(SEED), SL_B, (SL_LEN[1], SL_LEN[1]), SL_VOCAB))
    found.append(('training_stacked_lstm', _planned_specs(
        main, normalize_feed(main.global_block(), sfeed),
        [out['loss'].name], False)))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='decode',
                                       temperature=0.0)
    T = out['config']['max_len']
    for rows in BUCKETS:
        feed = {'tokens': np.zeros((rows, T, 1), 'int64')}
        for path, bf16 in (('serving', False), ('serving_bf16', True)):
            found.append((path, _planned_specs(
                main, feed, [out[k].name for k in SERVED_FETCHES], False,
                bf16)))
    specs = {}
    for path, got in found:
        for name, (spec, ops) in got.items():
            paths = specs.setdefault(name, (spec, ops, []))[2]
            if path not in paths:
                paths.append(path)
    return specs


# one-op segments whose function one PyTorch call computes, by op type
_ONE_CALL = {'elementwise_add': 'add', 'elementwise_sub': 'sub',
             'elementwise_mul': 'mul', 'elementwise_div': 'div',
             'relu': 'relu', 'sigmoid': 'sigmoid', 'tanh': 'tanh',
             'exp': 'exp', 'sqrt': 'sqrt'}


def _segment_library(spec, ents, refs):
    """One PyTorch call that computes a segment's function, where there is
    one: a one-op segment whose op is one torch call on its inputs (as
    broadcast by torch, checked against the segment's replay `refs`), or a
    global-norm clip's rescale (every op of a flat group an
    elementwise_mul by one scalar), the bulk of which is torch._foreach_mul
    of the gradients by a device scalar.  -> (callable, what it is), or
    None for a fused chain of ops, which no one call computes."""
    import torch
    if len(spec.ops) == 1 and len(refs) == 1:
        name = _ONE_CALL.get(spec.ops[0][0]['type'])
        fn = name and getattr(torch, name)
        try:
            got = fn and fn(*ents)
        except (RuntimeError, TypeError):
            got = None
        if got is not None and got.shape == refs[0].reshape(
                got.shape).shape and _close(got, refs[0].reshape(
                    got.shape), 1e-6, 0.0)[1]:
            return (lambda: fn(*ents),
                    'torch.%s of the segment\'s inputs' % name)
    flat = [op for op in spec.ops if op[4] > 1]
    if len(flat) < 2 or any(op[0]['type'] != 'elementwise_mul'
                            for op in flat):
        return None
    grads = [t for t, e in zip(ents, spec.entries) if e[1] == 'tile']
    scale = torch.full((), 0.5, device='cuda')
    return (lambda: torch._foreach_mul(grads, scale),
            'torch._foreach_mul of the segment\'s flat inputs by one '
            'device scalar')


def segment_case(spec, ops, paths, timed=True):
    """One generated segment against its plain replay (the sub-ops' eager
    PyTorch impls) on the same positive random inputs."""
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype
    from paddle_tpu_torch.ops import kernelgen
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    ents = []
    for shape, dt in spec.entry_avals:
        if dt == 'int32':
            ents.append(torch.randint(1, 100, shape, generator=g,
                                      device='cuda', dtype=torch.int32))
        else:
            ents.append((torch.rand(shape, generator=g, device='cuda')
                         + 0.5).to(torch_dtype(dt)))
    with torch.no_grad():
        outs = kernelgen._launch(spec, ents)
        refs = spec.replay(ents)
        torch.cuda.synchronize()
        # every operation rounds as PyTorch's eager kernel does: equal,
        # up to exp / pow implementations (1e-6 relative)
        errs = [_close(o, r, 1e-6, 0.0) for o, r in zip(outs, refs)]
        row = dict(phase='kernels', kernel='kernelgen_segment',
                   name=spec.name, ops=ops, paths=paths, groups=spec.groups,
                   inputs=[list(s) for s, _ in spec.entry_avals],
                   outputs=[list(s) for s, _ in spec.esc_aval],
                   max_abs_err=max(e for e, _ in errs), rtol=1e-6, atol=0.0)
        if timed:
            nbytes = sum(int(np.prod(s)) * torch.empty(
                (), dtype=torch_dtype(d)).element_size()
                for s, d in list(spec.entry_avals) + list(spec.esc_aval))
            bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
            lib = _segment_library(spec, ents, refs)
            row.update(ms=time_ms(lambda: kernelgen._launch(spec, ents), 50),
                       plain_ms=time_ms(lambda: spec.replay(ents), 20),
                       library_ms=lib and time_ms(lib[0], 50),
                       library_is=lib[1] if lib else 'none: a fused chain '
                       'of ops, which no one PyTorch call computes',
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
            row['gbps'] = nbytes / row['ms'] / 1e6
            row['share_of_bound'] = bound_ms / row['ms']
        # the tile table (builder.Layout): blocks, threads, and per group
        # its size, vector width, tiles, and whether
        # these inputs' and outputs' pointers took the 16-byte path
        lay = spec.layout
        ptrs = [t.data_ptr() for t in ents] + [o.data_ptr() for o in outs]
        row.update(tiles=lay.grid, threads=lay.threads,
                   streaming=lay.streaming, vector_by_group=[
                       dict(n=g['n'], v=g['v'], tiles=g['tiles'],
                            vec=vec) for g, vec in zip(
                           lay.groups, kernelgen.vector_groups(spec, ptrs))])
    emit(**row)
    require(all(o for _, o in errs), 'generated segment %s disagrees with '
            'its plain replay: %s' % (spec.name, row))
    return row


def phase_kernels():
    """-> {'rows': kernel name -> its timed row at its main path's shape,
    'instances': K1-K3 by dtype -> the timed row of that instance}.
    K1, K2 and K3 have two instances: bf16 on tensor cores (the training
    path) and float32 (serving, for K1; the float32 training path): all
    three as 3xTF32 on tensor cores."""
    served = {}
    inst = {'flash_attention_fwd': {}, 'flash_attention_bwd_dq': {},
            'flash_attention_bwd_dkv': {}}
    # the served shapes (llama_1b, 4 rows x 2048 tokens): timed
    inst['flash_attention_fwd']['float32'] = flash_case(
        'served_f32', 4, 16, 8, 2048, 2048, 128, True, 'float32',
        timed=True)
    flash_case('served_bf16', 4, 16, 8, 2048, 2048, 128, True, 'bfloat16',
               timed=True)
    flash_case('noncausal_gqa_d64', 2, 4, 2, 200, 200, 64, False, 'float32')
    flash_case('causal_klen', 3, 4, 1, 300, 300, 128, True, 'float32',
               klen=[300, 77, 1])
    flash_case('decode_tq_lt_tk', 2, 8, 2, 5, 333, 128, True, 'bfloat16',
               klen=[333, 100])
    flash_case('decode_tq_lt_tk_f32', 2, 8, 2, 5, 333, 128, True, 'float32',
               klen=[333, 100])
    flash_case('ragged_f32_d64', 1, 2, 2, 97, 161, 64, False, 'float32',
               klen=[130])
    flash_case('ragged_bf16_d64', 1, 2, 2, 97, 161, 64, False, 'bfloat16',
               klen=[130])
    flash_case('klen0', 2, 4, 4, 70, 70, 64, True, 'float32', klen=[0, 50])
    flash_case('klen0_bf16', 2, 4, 4, 70, 70, 64, True, 'bfloat16',
               klen=[0, 50])
    # Tq = 200: the last query tile is ragged
    flash_case('gqa_causal_bf16_d128', 2, 8, 2, 200, 200, 128, True,
               'bfloat16')
    served['embedding_gather'] = gather_case(
        'served_f32', 32000, 2048, 8192, 'float32', timed=True)
    # the bf16 served lookup, and the generation embedding: a prefill
    # chunk and a decode step of 8 slots, float32
    gather_case('served_bf16', 32000, 2048, 8192, 'bfloat16', timed=True)
    gather_case('gen_prefill_chunk_f32', 32000, 2048, 256, 'float32',
                timed=True)
    gather_case('gen_decode_step_f32', 32000, 2048, 8, 'float32',
                timed=True)
    gather_case('wrap_nan_f32_ids64', 32000, 2048, 4096, 'float32',
                special=True, ids64=True)
    gather_case('wrap_nan_bf16', 32000, 2048, 4096, 'bfloat16',
                special=True)
    gather_case('scalar_path_f32_d99', 1000, 99, 777, 'float32',
                special=True)
    gather_case('scalar_path_bf16_d100', 1000, 100, 777, 'bfloat16',
                special=True)
    # the training path's shapes (transformer-base, B=32, T=256, bf16
    # attention under AMP, a float32 [32000, 512] table): timed; then
    # ragged cases.  The kernels line keeps the served rows of the two
    # kernels serving and training share.
    served['flash_attention_fwd'] = inst['flash_attention_fwd'][
        'bfloat16'] = flash_case('path_bf16', 32, 8, 8, 256, 256, 64, False,
                                 'bfloat16', timed=True)
    flash_case('path_bf16_causal', 32, 8, 8, 256, 256, 64, True, 'bfloat16',
               timed=True)
    gather_case('path_f32', 32000, 512, 8192, 'float32', timed=True)
    bwd = flash_bwd_case('path_bf16', 32, 8, 8, 256, 256, 64, False,
                         'bfloat16', timed=True)
    served.update(bwd)
    for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        inst[kname]['bfloat16'] = bwd[kname]
    flash_bwd_case('path_bf16_causal', 32, 8, 8, 256, 256, 64, True,
                   'bfloat16', timed=True)
    # the float32 instances at the training path's shape (the float32
    # step, training_f32, runs them)
    bwd_f32 = flash_bwd_case('path_f32', 32, 8, 8, 256, 256, 64, False,
                             'float32', timed=True)
    for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        inst[kname]['float32'] = bwd_f32[kname]
    flash_bwd_case('gqa_f32_d64', 2, 8, 2, 128, 128, 64, True, 'float32')
    flash_bwd_case('gqa_bf16_d64', 2, 8, 2, 128, 128, 64, True, 'bfloat16')
    flash_bwd_case('tq_lt_tk_bf16', 2, 4, 1, 37, 161, 64, True, 'bfloat16',
                   klen=[161, 100])
    flash_bwd_case('klen_bf16_d128', 3, 4, 2, 150, 150, 128, False,
                   'bfloat16', klen=[150, 77, 1])
    flash_bwd_case('klen_f32_d128', 3, 4, 2, 150, 150, 128, False, 'float32',
                   klen=[150, 77, 1])
    flash_bwd_case('klen0_bf16', 2, 4, 4, 70, 70, 64, True, 'bfloat16',
                   klen=[0, 50])
    flash_bwd_case('tq_lt_tk_f32', 2, 4, 1, 37, 161, 64, True, 'float32',
                   klen=[161, 100])
    flash_bwd_case('ragged_bf16_d128', 1, 2, 2, 97, 161, 128, False,
                   'bfloat16', klen=[130])
    # the float32 D = 128 kernels' ragged edges: k_len 0 and 1 rows, GQA,
    # Tq < Tk causal, partial last query and key tiles
    flash_bwd_case('klen01_f32_d128', 3, 8, 4, 150, 150, 128, True,
                   'float32', klen=[150, 0, 1])
    flash_bwd_case('tq_lt_tk_f32_d128', 2, 16, 8, 37, 161, 128, True,
                   'float32', klen=[161, 100])
    flash_bwd_case('ragged_f32_d128', 1, 2, 2, 97, 161, 128, False,
                   'float32', klen=[130])
    # the training llama's attention (llama_1b, B=2, T=2048, D=128,
    # causal): K1-K3 in float32 (3xTF32) and in bf16 (tensor cores),
    # timed beside SDPA at the same dtype; float32 K2 and K3 also in the
    # CUDA-core design (csrc/flash_cc.cu), which the 3xTF32 kernels
    # replaced, in this call
    for dt in ('float32', 'bfloat16'):
        key = dt + '_d128'
        inst['flash_attention_fwd'][key] = flash_case(
            'llama_' + dt, 2, 16, 8, 2048, 2048, 128, True, dt, timed=True)
        bwd = flash_bwd_case('llama_' + dt, 2, 16, 8, 2048, 2048, 128, True,
                             dt, timed=True)
        for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
            inst[kname][key] = bwd[kname]
        if dt == 'float32':
            cc = flash_bwd_case('llama_float32_cc', 2, 16, 8, 2048, 2048,
                                128, True, dt, timed=True, design='cc')
            dq, dkv = (bwd[n]['ms'] for n in ('flash_attention_bwd_dq',
                                              'flash_attention_bwd_dkv'))
            cdq, cdkv = (cc[n]['ms'] for n in ('flash_attention_bwd_dq',
                                               'flash_attention_bwd_dkv'))
            for kname in cc:
                bwd[kname]['cuda_core_ms'] = cc[kname]['ms']
            emit(phase='kernels', step='llama_f32_bwd_designs',
                 tf32x3_dq_ms=dq, tf32x3_dkv_ms=dkv, tf32x3_pair_ms=dq + dkv,
                 cuda_core_dq_ms=cdq, cuda_core_dkv_ms=cdkv,
                 cuda_core_pair_ms=cdq + cdkv,
                 sdpa_f32_whole_bwd_ms=bwd['flash_attention_bwd_dq'][
                     'library_ms'],
                 speedup_dq=cdq / dq, speedup_dkv=cdkv / dkv)
    # C7: the bf16 backward splits dS into hi + lo terms at D = 64 and 128
    # too (one more product a tile): K2 / K3 at the flash step's shape and
    # the bf16 llama's.  tools/pt_flash_ab.py times them against another
    # tree in one call
    llama_bf16 = {n: inst[n]['bfloat16_d128'] for n in (
        'flash_attention_bwd_dq', 'flash_attention_bwd_dkv')}
    path_bf16 = {n: inst[n]['bfloat16'] for n in llama_bf16}
    emit(phase='kernels', step='c7_bwd_bf16',
         flash_step_dq_ms=path_bf16['flash_attention_bwd_dq']['ms'],
         flash_step_dkv_ms=path_bf16['flash_attention_bwd_dkv']['ms'],
         llama_dq_ms=llama_bf16['flash_attention_bwd_dq']['ms'],
         llama_dkv_ms=llama_bf16['flash_attention_bwd_dkv']['ms'])
    # the other head dims up to 128: K1, K2 and K3 in the tensor-core
    # kernels' padded instances (csrc/flash_fwd.cu, csrc/flash_bwd.cu).
    # K1's instance row is its main path's shape, serving_d96's batch (4
    # rows x 2048 tokens, 32 heads, D = 96).  All three are timed at D = 96
    # (the 128 instance, B 2, H 16 / 8, T 1024) beside the CUDA-core
    # designs they replaced and SDPA, in this call (d96_fwd_designs,
    # d96_bwd_designs); checked at the tiny llama's D = 16, at D = 32 (the
    # 64 instance; float32 with a 32-column region wholly past D), and at
    # D = 40, 72 and 120 (a 32-column region partly past D; the bf16
    # backward's last k16 step half zeros) with k_len 0 and 1 rows in a
    # GQA group and Tq < Tk, the forward's kernel read from the profiler
    for dt in ('float32', 'bfloat16'):
        key = dt + '_other_d'
        inst['flash_attention_fwd'][key] = flash_case(
            'served_d96_' + dt, 4, 32, 32, 2048, 2048, 96, True, dt,
            timed=True, profiled=True)
        fwd = flash_case('d96_' + dt, 2, 16, 8, 1024, 1024, 96, True, dt,
                         timed=True, profiled=True)
        cc_fwd = flash_case('d96_cc_' + dt, 2, 16, 8, 1024, 1024, 96, True,
                            dt, timed=True, design='cc')
        emit(phase='kernels', step='d96_fwd_designs', dtype=dt, D=96,
             DP=fwd['DP'], useful_share=fwd['useful_share'],
             tensor_core_ms=fwd['ms'], cuda_core_ms=cc_fwd['ms'],
             sdpa_ms=fwd['library_ms'],
             over_sdpa=fwd['ms'] / fwd['library_ms'],
             speedup=cc_fwd['ms'] / fwd['ms'], bound_ms=fwd['bound_ms'],
             bound_share=fwd['bound_share'],
             cuda_core_bound_share=cc_fwd['bound_share'],
             profiled_kernels=fwd['profiled_kernels'])
        bwd = flash_bwd_case('d96_' + dt, 2, 16, 8, 1024, 1024, 96, True,
                             dt, timed=True)
        cc = flash_bwd_case('d96_cc_' + dt, 2, 16, 8, 1024, 1024, 96, True,
                            dt, timed=True, design='cc')
        for kname in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
            bwd[kname]['cuda_core_ms'] = cc[kname]['ms']
            inst[kname][key] = bwd[kname]
        designs = bwd_designs_profiled(2, 16, 8, 1024, 96, dt)
        dq, dkv = (bwd[n] for n in ('flash_attention_bwd_dq',
                                    'flash_attention_bwd_dkv'))
        cdq, cdkv = (cc[n]['ms'] for n in ('flash_attention_bwd_dq',
                                           'flash_attention_bwd_dkv'))
        pair, sdpa = dq['ms'] + dkv['ms'], dq['library_ms']
        emit(phase='kernels', step='d96_bwd_designs', dtype=dt, D=96,
             DP=dq['DP'], useful_share=dq['useful_share'],
             tensor_core_dq_ms=dq['ms'], tensor_core_dkv_ms=dkv['ms'],
             tensor_core_pair_ms=pair, cuda_core_dq_ms=cdq,
             cuda_core_dkv_ms=cdkv, cuda_core_pair_ms=cdq + cdkv,
             sdpa_whole_bwd_ms=sdpa, pair_over_sdpa=pair / sdpa,
             speedup_pair=(cdq + cdkv) / pair,
             bound_share_dq=dq['bound_share'],
             bound_share_dkv=dkv['bound_share'],
             profiled_designs=designs)
        for D in (16, 32):
            flash_case('d%d_%s' % (D, dt), 2, 4, 2, 32, 32, D, True, dt,
                       profiled=True)
            flash_bwd_case('d%d_%s' % (D, dt), 2, 4, 2, 32, 32, D, True, dt)
        flash_case('d16_klen01_' + dt, 3, 8, 2, 100, 100, 16, True, dt,
                   klen=[100, 0, 1], profiled=True)
        flash_case('d32_klen0_' + dt, 2, 8, 2, 100, 133, 32, False, dt,
                   klen=[133, 0], profiled=True)
        flash_case('d40_klen01_' + dt, 3, 8, 2, 150, 150, 40, True, dt,
                   klen=[150, 0, 1], profiled=True)
        flash_case('d72_tq_lt_tk_' + dt, 3, 8, 4, 37, 161, 72, True, dt,
                   klen=[161, 100, 1], profiled=True)
        flash_case('d120_tq_lt_tk_' + dt, 3, 8, 4, 37, 161, 120, True, dt,
                   klen=[161, 0, 1], profiled=True)
        flash_bwd_case('d32_klen_' + dt, 2, 8, 2, 100, 133, 32, True, dt,
                       klen=[133, 40])
        flash_bwd_case('d40_klen01_' + dt, 3, 8, 2, 150, 150, 40, True, dt,
                       klen=[150, 0, 1])
        flash_bwd_case('d120_tq_lt_tk_' + dt, 3, 8, 4, 37, 161, 120, True,
                       dt, klen=[161, 100, 1])
        # the head dims above 128: K1, K2 and K3 on the tensor cores in
        # the instances of width 256 (csrc/flash_fwd.cu, csrc/flash_bwd.cu;
        # the float32 backward as clusters of two blocks splitting D).
        # K1's instance row is its main path's shape,
        # serving_d256's batch (4 rows x 2048 tokens, 16 / 16 heads, D =
        # 256), K2's and K3's the AMP step's of training_llama_d256 (2
        # rows x 2048, 16 / 16 heads); at B 2, H 16 / 8, T 1024, D = 256
        # K1 is timed beside the CUDA-core kernel it replaced and SDPA
        # (d256_fwd_designs), and K2 / K3 at that shape and the AMP
        # step's beside the CUDA-core pair they replaced and SDPA's whole
        # backward (d256_bwd_designs), in this call.  Checked at D = 256
        # and the
        # padded 136, 200 (MQA) and 248 with k_len 0 and 1 rows, Tq < Tk
        # and ragged last query and key tiles, the kernel and instance
        # read from the profiler
        key = dt + '_d256'
        inst['flash_attention_fwd'][key] = flash_case(
            'served_d256_' + dt, 4, 16, 16, 2048, 2048, 256, True, dt,
            timed=True, profiled=True)
        fwd = flash_case('d256_' + dt, 2, 16, 8, 1024, 1024, 256, True, dt,
                         timed=True, profiled=True)
        cc_fwd = flash_case('d256_cc_' + dt, 2, 16, 8, 1024, 1024, 256,
                            True, dt, timed=True, design='cc')
        emit(phase='kernels', step='d256_fwd_designs', dtype=dt, D=256,
             tensor_core_ms=fwd['ms'], cuda_core_ms=cc_fwd['ms'],
             sdpa_ms=fwd['library_ms'],
             over_sdpa=fwd['ms'] / fwd['library_ms'],
             speedup=cc_fwd['ms'] / fwd['ms'], bound_ms=fwd['bound_ms'],
             bound_share=fwd['bound_share'],
             cuda_core_bound_ms=cc_fwd['bound_ms'],
             cuda_core_bound_share=cc_fwd['bound_share'],
             plain_ms=fwd['plain_ms'],
             profiled_kernels=fwd['profiled_kernels'])
        shapes = {}
        for shape, (B, H, Hkv, T) in (('d256', (2, 16, 8, 1024)),
                                      ('amp_step', (2, 16, 16, 2048))):
            name = '%s_%s' % (shape, dt)
            bwd = flash_bwd_case(name, B, H, Hkv, T, T, 256, True, dt,
                                 timed=True)
            dq, dkv = (bwd[n] for n in ('flash_attention_bwd_dq',
                                        'flash_attention_bwd_dkv'))
            pair, sdpa = dq['ms'] + dkv['ms'], dq['library_ms']
            row = dict(B=B, H=H, Hkv=Hkv, T=T, port_dq_ms=dq['ms'],
                       port_dkv_ms=dkv['ms'], port_pair_ms=pair,
                       sdpa_whole_bwd_ms=sdpa, pair_over_sdpa=pair / sdpa,
                       dq_bound_ms=dq['bound_ms'],
                       dkv_bound_ms=dkv['bound_ms'],
                       bound_share_dq=dq['bound_share'],
                       bound_share_dkv=dkv['bound_share'],
                       bwd_plain_ms=dq['plain_ms'])
            # the CUDA-core pair the tensor-core one replaced
            cc = flash_bwd_case(name + '_cc', B, H, Hkv, T, T, 256, True,
                                dt, timed=True, design='cc')
            cdq, cdkv = (cc[n]['ms'] for n in (
                'flash_attention_bwd_dq', 'flash_attention_bwd_dkv'))
            for kname in cc:
                bwd[kname]['cuda_core_ms'] = cc[kname]['ms']
            row.update(cuda_core_dq_ms=cdq, cuda_core_dkv_ms=cdkv,
                       cuda_core_pair_ms=cdq + cdkv,
                       speedup_pair=(cdq + cdkv) / pair,
                       cuda_core_bound_share_dq=cc[
                           'flash_attention_bwd_dq']['bound_share'],
                       cuda_core_bound_share_dkv=cc[
                           'flash_attention_bwd_dkv']['bound_share'])
            if dt == 'bfloat16':
                # the dV and dK blocks compute S^T both (10 D FLOPs a
                # valid pair where the function needs 8 D: the bound
                # counts 8)
                row.update(design='tensor cores (wgmma, width 256)',
                           dkv_design_flops=dkv['flops'] * 10 / 8)
            else:
                row.update(design='tensor cores (3xTF32 wgmma, width 256, '
                           'clusters of two blocks splitting D)')
            shapes[shape] = row
            if shape == 'amp_step':
                for kname in ('flash_attention_bwd_dq',
                              'flash_attention_bwd_dkv'):
                    inst[kname][key] = bwd[kname]
        designs = bwd_designs_profiled(2, 16, 8, 1024, 256, dt)
        emit(phase='kernels', step='d256_bwd_designs', dtype=dt, D=256,
             causal=True, shapes=shapes, profiled_designs=designs)
        flash_case('d256_klen01_' + dt, 3, 8, 2, 150, 150, 256, True, dt,
                   klen=[150, 0, 1], profiled=True)
        flash_case('d256_tq_lt_tk_' + dt, 2, 8, 2, 37, 161, 256, True, dt,
                   klen=[161, 100], profiled=True)
        flash_case('d136_tq_lt_tk_klen01_' + dt, 3, 8, 2, 37, 161, 136,
                   True, dt, klen=[161, 0, 1], profiled=True)
        flash_case('d200_mqa_ragged_' + dt, 2, 8, 1, 97, 161, 200, True,
                   dt, klen=[130, 1], profiled=True)
        flash_case('d248_gqa_klen0_' + dt, 2, 8, 2, 150, 150, 248, False,
                   dt, klen=[150, 0], profiled=True)
        flash_bwd_case('d256_klen01_' + dt, 3, 8, 2, 150, 150, 256, True,
                       dt, klen=[150, 0, 1])
        flash_bwd_case('d256_mqa_noncausal_' + dt, 2, 8, 1, 97, 161, 256,
                       False, dt, klen=[161, 1])
        flash_bwd_case('d136_tq_lt_tk_klen01_' + dt, 3, 8, 2, 37, 161, 136,
                       True, dt, klen=[161, 0, 1])
        flash_bwd_case('d200_mqa_ragged_' + dt, 2, 8, 1, 97, 161, 200, True,
                       dt, klen=[130, 1])
        flash_bwd_case('d248_gqa_klen0_' + dt, 2, 8, 2, 150, 150, 248,
                       False, dt, klen=[150, 0])
    served['layer_norm'] = layer_norm_case('path_f32', 8192, 512, 'float32',
                                           timed=True)
    layer_norm_case('ragged_cols_f32', 300, 1000, 'float32')
    layer_norm_case('bf16_no_affine', 257, 512, 'bfloat16', affine=False)
    layer_norm_case('pilot_offset_f32', 64, 512, 'float32', offset=1e4)
    layer_norm_case('two_pass_f32', 100, 77, 'float32', two_pass=True)
    served['adam_multi'] = adam_case('transformer_158', 
                                     transformer_param_shapes(), timed=True)
    adam_case('ragged', [(1,), (7,), (32769,), (3, 33333), (5, 4)])
    # the bf16 instance at the bf16 llama_1b step's 147 tensors
    served['adam_multi_bf16'] = adam_bf16_case('llama_147',
                                               llama_param_shapes(),
                                               timed=True)
    # and at its later steps: float32 state, the beta powers bf16
    adam_bf16_case('llama_147_later', llama_param_shapes(), state='float32')
    adam_bf16_case('ragged', [(1,), (7,), (32769,), (3, 33333)])
    # K7's momentum instance at ResNet-50's 161 tensors, nesterov off (the
    # training step's) and on, then ragged sizes and misaligned tensors
    r50 = resnet50_param_shapes()
    served['momentum_multi'] = momentum_case('resnet50_161', r50, False,
                                             timed=True)
    momentum_case('resnet50_161_nesterov', r50, True, timed=True)
    momentum_case('ragged', [(1,), (7,), (4097,), (3, 3333), (5, 4)], False)
    momentum_case('ragged_nesterov', [(1,), (4095,), (8193,)], True)
    # K7's other instances (csrc/optim_multi.cu) at Wide&Deep's tensors
    # with CTR_VOCAB rows (training_optimizers' path: the kernels line's
    # rows) and at ResNet-50's 161, then ragged sizes
    ctr = ctr_param_shapes()
    for case in sorted(OPTIM_CASES):
        served[case + '_multi'] = optim_case('wide_deep_%d' % len(ctr),
                                             case, ctr, timed=True)
        optim_case('resnet50_161', case, r50, timed=True)
        optim_case('ragged', case, [(1,), (7,), (4097,), (3, 3333), (5, 4)])
    # C11's bf16 instances of csrc/momentum.cu and csrc/optim_multi.cu:
    # bf16 param, grad and state, at Wide&Deep's tensors (the optim rows
    # of the kernels line) and ResNet-50's 161 (momentum's row), then
    # ragged sizes
    for case in ['momentum'] + sorted(OPTIM_CASES):
        name = 'momentum_multi_bf16' if case == 'momentum' else \
            case + '_multi_bf16'
        w = optim_bf16_case('wide_deep_%d' % len(ctr), case, ctr,
                            timed=True)
        r = optim_bf16_case('resnet50_161', case, r50, timed=True)
        served[name] = r if case == 'momentum' else w
        optim_bf16_case('ragged', case, [(1,), (7,), (4097,), (3, 3333)])
    # K4 at the CTR tables: 1 and 8 columns, 1,000,001 rows, B 2048 x 26
    # int64 ids (training_ctr's lookups)
    inst_gather = {}
    for D in (1, 8):
        inst_gather['ctr_d%d' % D] = gather_case(
            'ctr_d%d' % D, CTR_VOCAB, D, CTR_B * 26, 'float32', ids64=True,
            timed=True)
    # K4 at the sequence models' lookups: the LM's [32, 512] int64 ids
    # into its [5147, 512] table, the recommender's titles (B 256 x 15
    # ids into [5175, 32])
    gather_seq = {
        'stacked_lstm': gather_case('stacked_lstm', SL_VOCAB, SL_EMB,
                                    SL_B * SL_LEN[1], 'float32', ids64=True,
                                    timed=True),
        'recommender_title': gather_case('recommender_title', 5175, 32,
                                         RC_B * RC_TITLE[1], 'float32',
                                         ids64=True, timed=True)}
    # the composed attention's scores: [32, 8, 256, 256] float32
    served['softmax'] = softmax_case('path_f32', 65536, 256, 'float32',
                                     timed=True)
    softmax_case('register_branch_1000', 300, 1000, 'float32',
                 neg_inf_rows=3)
    softmax_case('block_branch_3000', 7, 3000, 'float32', neg_inf_rows=1)
    softmax_case('bf16_255', 257, 255, 'bfloat16')
    softmax_case('cols_1', 33, 1, 'float32')
    # the 16-byte vector branch in bf16 (a block's last rows empty), and a
    # float32 column count off the 4-value vectors (the scalar branch)
    softmax_case('vec_bf16_256', 4099, 256, 'bfloat16', neg_inf_rows=1)
    softmax_case('scalar_f32_258', 1000, 258, 'float32', neg_inf_rows=2)
    from paddle_tpu_torch.ops import kernelgen
    t0 = time.perf_counter()
    specs = path_segments()
    rules = rule_specs()
    rules_bf16 = rule_specs_bf16()
    rules_a10 = {dt: a10_rule_specs(dt, n) for dt, n in
                 (('float32', RULE_N), ('bfloat16', C12_N))}
    kernelgen.ensure_built()
    log = kernelgen.build_stats['log']
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'kernelgen_build.log'), 'w') as f:
        f.write(log)
    emit(phase='kernels', step='kernelgen_build', functions=len(specs),
         plan_and_build_s=time.perf_counter() - t0,
         nvcc_s=kernelgen.build_stats['nvcc_s'],
         ptxas=sorted({ln.split(':', 1)[-1].strip() for ln in log.splitlines()
                       if 'registers' in ln or 'spill' in ln}))
    for name, (spec, ops, paths) in sorted(specs.items()):
        served[name] = segment_case(spec, ops, paths)
    # one segment a rule of the elementwise family (RULE_CASES), on no
    # path of its own
    for case, spec in rules.items():
        rule_case(case, spec)
    # C12: each rule whose constants meet the tensor, its bf16 segment on
    # every bf16 value, bit for bit its plain op
    for case, spec in rules_bf16.items():
        rule_case_bf16(case, spec)
    # the rules of label_smooth, fill_zeros_like and flatten, a
    # kernelgen_rule and a kernelgen_rule_bf16 line each
    for dt, n in (('float32', RULE_N), ('bfloat16', C12_N)):
        for case, spec in rules_a10[dt].items():
            a10_rule_case(case, spec, dt, n)
    return {'rows': served, 'instances': inst, 'gather_ctr': inst_gather,
            'gather_seq': gather_seq}


# ------------------------------------------------------------- phase 3

def _build_and_save(fluid, llama, dirname, fetches, **overrides):
    """Build the decode program through the port's layers, run its startup
    on the card and save it with the `generation_program` outputs named in
    `fetches` as targets; returns the program's config."""
    import torch
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='decode',
                                       temperature=0.0, **overrides)
    scope = fluid.Scope()
    exe = fluid.Executor()
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fluid.io.save_inference_model(
            dirname, ['tokens'],
            [out[k] for k in fetches], exe, main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    t2 = time.perf_counter()
    del scope
    torch.cuda.empty_cache()
    return out['config'], n_params, t1 - t0, t2 - t1


def _model_dir():
    """A scratch model directory inside the checkout's (git-ignored) build
    directory, removed afterwards."""
    from paddle_tpu_torch.kernels import build
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix='model_', dir=build.BUILD_DIR)


def _tokens(rng, rows, T, V):
    return rng.randint(0, V, (rows, T, 1)).astype('int64')


def _agree(a, b, what):
    """Logits within tolerance, greedy tokens equal wherever the top-two
    gap exceeds it.  Tolerance: 1e-4 of the largest |logit| — float32
    sums over 2048..5504 terms taken in other orders (other GEMM tilings
    per batch size, CPU vs GPU libraries, the kernel vs the plain
    attention) differ by ~1e-6 relative; the margin covers depth."""
    tol = 1e-4 * float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    require(err <= tol, '%s: logits differ by %g > %g' % (what, err, tol))
    clear = _clear(b, tol)
    same = np.argmax(a, -1) == np.argmax(b, -1)
    require(bool(same[clear].all()), '%s: greedy tokens differ where the '
            'top-two gap exceeds the tolerance' % what)
    return err, tol, int(clear.sum()), int(clear.size)


def _clear(logits, tol):
    """Positions whose top-two logit gap exceeds twice the tolerance: there
    the greedy token cannot flip within it."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * tol


def _interpreted(pred):
    """Predictor.run through the interpreter: the same program, scope and
    fetches, with use_program_cache=False (no CUDA graph)."""
    from paddle_tpu_torch.inference import _fetch_numpy

    def run(feed):
        with pred._run_lock:
            out = pred._exe.run(pred._program, feed=feed,
                                fetch_list=pred._fetch_names,
                                scope=pred._scope, return_numpy=False,
                                use_program_cache=False)
        return [_fetch_numpy(o) for o in out]
    return run


def profile_batch(pred, feed, n_layer, phase='serving',
                  design='fwd_tf32x3', instance=None):
    """Where one dispatched batch spends its time: torch.profiler over one
    interpreted Predictor.run (device time by kernel, grouped; the flash
    kernels by design; taken again, up to PROFILE_TRIES times, while it
    shows fewer flash forwards than layers), beside the host wall time of
    three unprofiled runs; every flash forward of the batch must be
    `design`, and with `instance` (padded width, padded) that instance of
    it.  serve_modes times and profiles the graph replays.  -> the
    emitted line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = _interpreted(pred)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(feed)
        walls.append(time.perf_counter() - t0)
    # the profiler drops kernel events now and then, never adds one: a
    # batch whose flash forwards it undercounts is profiled again
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(feed)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        flash = _flash_by_design(prof.key_averages())
        if sum(c for _, c in flash.values()) >= n_layer:
            break
    groups, instances = {}, {}
    top = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's device
        # total repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if not us:
            continue
        name = e.key
        if _fwd_instance(name):
            inst = '%d, %s' % _fwd_instance(name)
            instances[inst] = instances.get(inst, 0) + e.count
        low = name.lower()
        group = ('flash_attention_fwd' if 'flash_fwd' in name else
                 'embedding_gather' if 'gather_rows' in name else
                 'kernelgen_segment' if 'kg_' in name else
                 'memcpy' if 'memcpy' in low else
                 'matmul' if any(s in low for s in ('gemm', 'cutlass',
                                                    'sm90_', 'xmma',
                                                    'nvjet')) else
                 'other')
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, name[:80], e.count))
    top.sort(reverse=True)
    busy = sum(groups.values())
    res = dict(phase=phase, step='profile', profile_tries=tries,
               rows=int(feed['tokens'].shape[0]),
               run_wall_ms=[w * 1e3 for w in walls],
               profiled_wall_ms=prof_wall * 1e3, device_ms_by_group=groups,
               device_busy_ms=busy,
               device_idle_share=(1 - busy / (prof_wall * 1e3)) if busy
               else None, flash_by_design=flash,
               flash_fwd_instances=instances,
               top_kernels=[dict(ms=t, name=n, count=c)
                            for t, n, c in top[:12]])
    emit(**res)
    # one batch: a flash forward a layer, all of the dtype's design
    require(set(flash) == {design} and flash[design][1] == n_layer,
            'the served batch ran flash kernels %s, not %d %s'
            % (flash, n_layer, design))
    if instance:
        want = {'%d, %s' % instance: n_layer}
        require(instances == want, 'the served batch ran flash forward '
                'instances %s, not %s' % (instances, want))
    return res


def serve_modes(phase, smi, pred, feed, n_layer, design):
    """The 4-row batch through Predictor.run in turns (eager, graph, graph,
    eager): `eager` the interpreter (use_program_cache=False), `graph` a
    replay of its signature's CUDA graph.  3 runs a reading; median batch
    ms, prompt tokens/s, peak memory; one profiled run each (device busy,
    idle share, the flash kernels by design, the device launches of the
    hand-written and generated kernels beside the counted ones);
    the served rows must agree bit for bit."""
    import torch
    T = feed['tokens'].shape[1]
    rows = feed['tokens'].shape[0]
    runs = {'eager': _interpreted(pred), 'graph': pred.run}
    outs = {m: fn(feed) for m, fn in runs.items()}   # the graph is warm
    readings = {m: [] for m in runs}
    for mode in ('eager', 'graph', 'graph', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            runs[mode](feed)
            ms.append((time.perf_counter() - t0) * 1e3)
        readings[mode].append(dict(batch_ms=ms, **_peak_memory()))
    out = {}
    for mode, rs in readings.items():
        med = [float(np.median(r['batch_ms'])) for r in rs]
        (wall, busy, flash, seen, groups), counted, tries = \
            _profiled_launches(lambda: runs[mode](feed))
        out[mode] = dict(median_batch_ms=med,
                         prompt_tokens_per_s=[rows * T / (m / 1e3)
                                              for m in med],
                         readings=rs, profiled_wall_ms=wall,
                         device_busy_ms=busy,
                         device_idle_share=(1 - busy / wall) if busy
                         else None, profiled_device_events=seen,
                         flash_by_design=flash, device_launches=groups,
                         counted_device_launches=counted,
                         profile_tries=tries)
    same = all(a.tobytes() == b.tobytes()
               for a, b in zip(outs['eager'], outs['graph']))
    entries = [e for e in pred._exe._graphs.entries.values()
               if e.capture_s is not None]
    emit(phase=phase, step='serve_modes', rows=rows, modes=out,
         rows_bitwise_equal=same, graphs=len(entries),
         capture_s=[e.capture_s for e in entries], card=smi)
    require(same, 'served rows: the graph replay and the interpreter differ')
    # the device launches are not held to the counted ones here: after
    # the float32 served phase the profiler shows no gather_rows event in
    # the bf16 batch's windows, interpreted and replayed alike, though the
    # wrapper launched it (PERF.md §7)
    seen_flash = out['graph']['flash_by_design']
    require(not seen_flash or (set(seen_flash) == {design} and
                               seen_flash[design][1] == n_layer),
            'the replayed batch ran flash kernels %s, not %d %s'
            % (seen_flash, n_layer, design))


# bf16 bound: a logit passes R = 12 L + 2 bf16 roundings (unit roundoff
# u = 2^-8; tests/test_torch_inference_bf16.py lists them); as independent
# draws uniform in +-u the logits of two bf16 runs differ with standard
# deviation sqrt(2 R / 3) u max|logit|, and a bf16 run and a float32 one
# (only one side rounds) with sqrt(R / 3) u max|logit|.  The checks allow
# one such deviation, set from readings on llama_1b (L = 16, 0.0314
# max|logit| against float32): sound bf16 runs differ from float32 by
# 0.0113-0.0136 max|logit| and the faults of `bf16_controls` by
# 0.116-0.265 (PERF.md), and every fault must fail the check
def bf16_tol(M, n_layer, runs=2):
    return np.sqrt(runs * (12 * n_layer + 2) / 3.0) * 2.0 ** -8 * M


def _round_significand(x, bits):
    """x rounded to `bits` significant bits (fp8 e4m3 keeps 4), in x's
    dtype; the exponent range is x's own."""
    import torch
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits,
                       e).to(x.dtype)


def bf16_controls(pred, feeds, refs, n_layer):
    """Faults the bf16 check must catch, made in place in a bf16
    Predictor's parameters and undone after: the last layer's attention
    dropped (its output projection zeroed) and every parameter at fp8
    (e4m3) precision.  Each is held to the float32 logits `refs` of
    `feeds` under the bf16-vs-float32 bound; returns its readings."""
    import torch
    params = pred._scope.vars
    att = 'layer_%d_att_o_w' % (n_layer - 1)
    with torch.inference_mode():
        saved = {n: v.clone() for n, v in params.items()}

    def drop_attention():
        params[att].zero_()

    def fp8_precision():
        for v in params.values():
            if v.is_floating_point():
                v.copy_(_round_significand(v, 4))
    out = {}
    for name, fault in (('attention_dropped', drop_attention),
                        ('fp8_precision', fp8_precision)):
        with torch.inference_mode():
            fault()
        errs = []
        for f, ref in zip(feeds, refs):
            a = np.asarray(pred.run(f)[0], np.float32)
            M = float(np.abs(ref).max())
            errs.append(dict(max_abs_err=float(np.abs(a - ref).max()),
                             tol=bf16_tol(M, n_layer, runs=1), max_logit=M))
        with torch.inference_mode():
            for n, v in params.items():
                v.copy_(saved[n])
        out[name] = errs
    torch.cuda.synchronize()
    caught = [e['max_abs_err'] > e['tol'] for v in out.values() for e in v]
    require(all(caught), 'a bf16 fault passes the bf16 bound: %s' % out)
    return out


def _agree_bf16(a, b, n_layer, what, runs=2):
    """bf16 logits `a` within the bf16 bound of `b` (bf16, runs=2, or
    float32, runs=1); greedy tokens equal wherever the top-two gap exceeds
    twice the bound."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = bf16_tol(float(np.abs(b).max()), n_layer, runs)
    err = float(np.abs(a - b).max())
    require(err <= tol, '%s: logits differ by %g > %g' % (what, err, tol))
    clear = _clear(b, tol)
    same = np.argmax(a, -1) == np.argmax(b, -1)
    require(bool(same[clear].all()), '%s: greedy tokens differ where the '
            'top-two gap exceeds the tolerance' % what)
    return err, tol, int(clear.sum()), int(clear.size)


def phase_serving(smi):
    """llama_1b served in float32, the reference's default."""
    return _serve('serving', smi, bf16=False)


def phase_serving_bf16(smi):
    """llama_1b served with AnalysisConfig.enable_bf16: bf16 parameters,
    bf16 GEMMs and K1's bf16 wgmma kernel; logits held to the bf16 bound
    of the float32 Predictor's on the same feeds."""
    return _serve('serving_bf16', smi, bf16=True)


def _serve(phase, smi, bf16):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernelgen
    f32 = ctl = None
    with _model_dir() as d:
        # what a serving client reads: the last position's logits and the
        # greedy next token (not the [B, T, V] logits of every position)
        cfg, n_params, startup_s, save_s = _build_and_save(
            fluid, llama, d, SERVED_FETCHES)
        T, V = cfg['max_len'], cfg['vocab']
        t0 = time.perf_counter()
        conf = fluid.inference.AnalysisConfig(d)
        if bf16:
            conf.enable_bf16()
        pred = fluid.inference.Predictor(conf)
        load_s = time.perf_counter() - t0
        if bf16:
            f32 = fluid.inference.Predictor(d)
            ctl = fluid.inference.Predictor(conf)
    dtypes = sorted({str(v.dtype) for v in pred._scope.vars.values()})
    emit(phase=phase, step='model', config='llama_1b',
         n_layer=cfg['n_layer'], params=n_params,
         param_bytes=(2 if bf16 else 4) * n_params, param_dtypes=dtypes,
         startup_s=startup_s, save_s=save_s, load_s=load_s,
         fetches=pred.get_output_names())
    require(dtypes == (['torch.bfloat16'] if bf16 else ['torch.float32']),
            'parameter dtypes %s' % dtypes)
    rng = np.random.RandomState(SEED)
    # dispatched as buckets 1 (the first request alone), 4 (2 + 2), 4 (1 +
    # 1 + 2) and 2, so every bucket's generated kernels run
    rows = [1, 2, 2, 1, 1, 2, 2]
    feeds = [{'tokens': _tokens(rng, r, T, V)} for r in rows]
    # warm the device (cuBLAS handles, allocator) and build the generated
    # kernels of every bucket's shape (their shapes are compiled in; the
    # kernels phase, when it ran, built them already) outside the counted
    # run
    nvcc0 = kernelgen.build_stats['nvcc_s']
    for rows_ in BUCKETS:
        pred.run({'tokens': _tokens(np.random.RandomState(SEED + rows_),
                                    rows_, T, V)})
    torch.cuda.synchronize()
    emit(phase=phase, step='warm', buckets=list(BUCKETS),
         kernelgen_nvcc_s=kernelgen.build_stats['nvcc_s'] - nvcc0)
    eng = serving.ServingEngine.from_predictor(
        pred, bucketer=fluid.FeedBucketer(list(BUCKETS)),
        config=serving.ServingConfig(max_queue=16, max_batch_rows=4))
    kernels.reset_launches()
    kernelgen.launches.clear()
    t0 = time.perf_counter()
    with eng:
        futs = [eng.submit(feeds[0])]
        # the rest queue up while the first request runs, so the
        # dispatcher coalesces them into 4-row batches
        deadline = time.time() + 30
        while eng.health()['queue_depth'] and time.time() < deadline:
            time.sleep(0.001)
        futs += [eng.submit(f) for f in feeds[1:]]
        results = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    seg = dict(kernelgen.launches)
    c = eng.counters
    batches = c.get('serving.batches')
    dispatched = c.histogram('serving.dispatched_rows')
    batch_ms = c.histogram('serving.batch_ms')
    statuses = [r.status for r in results]
    require(all(r.ok for r in results), 'requests not ok: %s (first '
            'error: %r)' % (statuses, next((r.error for r in results
                                             if not r.ok), None)))
    require(c.get('serving.deadlocks') == 0, 'serving.deadlocks != 0')
    require(dispatched['max'] == 4, 'no dispatched batch had 4 rows: %s'
            % dispatched)
    require(launches['flash_attention_fwd'] == cfg['n_layer'] * batches,
            'flash launches %d != %d layers x %d batches'
            % (launches['flash_attention_fwd'], cfg['n_layer'], batches))
    require(launches['embedding_gather'] == batches,
            'gather launches %d != %d batches'
            % (launches['embedding_gather'], batches))
    checks, vs_f32, f32_logits = [], [], []
    for f, r in zip(feeds, results):
        last, tok = r.outputs
        n = f['tokens'].shape[0]
        require(last.shape == (n, V) and tok.shape == (n,),
                'bad output shapes')
        require(str(last.dtype) == ('bfloat16' if bf16 else 'float32'),
                'fetched logits of dtype %s' % last.dtype)
        last = np.asarray(last, np.float32)
        require(bool(np.isfinite(last).all()), 'non-finite logits')
        require(bool(((tok >= 0) & (tok < V)).all()), 'token out of range')
        require(bool((tok == np.argmax(last, -1)).all()),
                'greedy token is not the argmax of the last logits')
        a_last, a_tok = pred.run(f)
        a_last = np.asarray(a_last, np.float32)
        if bf16:
            # batched against alone: two bf16 runs (other GEMM shapes)
            checks.append(_agree_bf16(last, a_last, cfg['n_layer'],
                                      'served vs alone'))
            f32_logits.append(f32.run(f)[0])
            vs_f32.append(_agree_bf16(last, f32_logits[-1], cfg['n_layer'],
                                      'bf16 vs float32', runs=1))
        else:
            checks.append(_agree(last, a_last, 'served vs alone'))
        require(bool((a_tok == tok)[_clear(a_last, checks[-1][1])].all()),
                'served vs alone: next tokens differ')
    real_rows = sum(rows)
    res = dict(phase=phase, step='served', requests=len(results),
               statuses=statuses, batches=batches, rows=real_rows,
               dispatched_rows=dispatched, launches=launches,
               segment_launches=seg, wall_s=wall, batch_ms=batch_ms,
               tokens_per_s=real_rows * T / wall,
               alone_vs_batched=[dict(max_abs_err=e, tol=t, clear_rows=cl,
                                      rows=n) for e, t, cl, n in checks],
               card=smi)
    if bf16:
        res['bf16_vs_float32'] = [dict(max_abs_err=e, tol=t, clear_rows=cl,
                                       rows=n) for e, t, cl, n in vs_f32]
        res['controls'] = bf16_controls(ctl, feeds[:3], f32_logits[:3],
                                        cfg['n_layer'])
    emit(**res)
    four = {'tokens': np.concatenate([f['tokens'] for f in feeds[1:3]])}
    design = 'fwd_wgmma' if bf16 else 'fwd_tf32x3'
    profile_batch(pred, four, cfg['n_layer'], phase, design)
    serve_modes(phase, smi, pred, four, cfg['n_layer'], design)
    del pred, eng, f32, ctl
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


# Phi-3-mini's widths (microsoft/Phi-3-mini-4k-instruct config.json:
# hidden 3072, 32 heads and 32 KV heads, so D = 96, FFN 8192, vocab 32064,
# rope theta 10000) on the llama architecture, cut to 4 of its 32 layers
D96_CFG = dict(vocab=32064, d_model=3072, n_layer=4, n_head=32,
               n_kv_head=32, d_ffn=8192, theta=10000.0, max_len=2048)
# GPT-J-6B's widths (EleutherAI/gpt-j-6b config.json: n_embd 4096, n_head
# 16, so D = 256; n_inner null, so the FFN is 4 x 4096; vocab_size 50400,
# n_positions 2048, rotary base 10000) on the llama architecture, cut to
# 4 of its 28 layers
GPTJ_CFG = dict(vocab=50400, d_model=4096, n_layer=4, n_head=16,
                n_kv_head=16, d_ffn=16384, theta=10000.0, max_len=2048)
GPTJ_REDUCED = [
    'n_layer 28 -> 4 (the save, the load and the script within the time '
    'limit)',
    'the llama architecture where GPT-J has a parallel residual, '
    'LayerNorm, a two-matrix GELU MLP (here SwiGLU, three matrices of '
    'the same width) and rotary on 64 of 256 dims (here on all); theta '
    '10000, GPT-J\'s rotary base']


def phase_serving_d96(smi):
    """The served llama at a head dim other than 64 and 128 (Phi-3-mini's
    widths, D = 96), float32 and enable_bf16: one profiled 4-row batch of
    2048 tokens each, whose 4 flash forwards must be the padded
    tensor-core kernel of width 128; bf16 within the bf16 bound of
    float32.  -> {path: launches a batch}."""
    return _serve_widths(
        'serving_d96', smi, D96_CFG, 'phi3_mini_widths',
        'n_layer 32 -> 4 (the save, the load and the script within the '
        'time limit; 8 until the sequence phases came)',
        (_padded_width(96), True))


def phase_serving_d256(smi):
    """The served llama at GPT-J-6B's widths (D = 256), float32 and
    enable_bf16: one profiled 4-row batch of 2048 tokens each, whose 4
    flash forwards must be the tensor-core kernel of width 256, unpadded;
    bf16 within the bf16 bound of float32.  -> {path: launches a batch}."""
    return _serve_widths('serving_d256', smi, GPTJ_CFG, 'gptj_6b_widths',
                         GPTJ_REDUCED, (256, False))


def _serve_widths(phase, smi, config, name, reduced, instance):
    """A llama at a public model's widths (`config`), built, saved and
    loaded by Predictor in float32 and with enable_bf16: one profiled
    4-row batch of max_len tokens in each (batch ms, flash ms, device
    busy), whose flash forwards (one a layer) must all be the tensor-core
    kernel's `instance` (padded width, padded); bf16 within the bf16
    bound of float32.  -> {path: launches a batch}."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import llama
    with _model_dir() as d:
        cfg, n_params, startup_s, save_s = _build_and_save(
            fluid, llama, d, SERVED_FETCHES, **config)
        t0 = time.perf_counter()
        f32 = fluid.inference.Predictor(d)
        t1 = time.perf_counter()
        conf = fluid.inference.AnalysisConfig(d)
        conf.enable_bf16()
        bf16 = fluid.inference.Predictor(conf)
        t2 = time.perf_counter()
    T, V, L = cfg['max_len'], cfg['vocab'], cfg['n_layer']
    emit(phase=phase, step='model', config=name, cfg=cfg,
         head_dim=cfg['d_model'] // cfg['n_head'], reduced=reduced,
         params=n_params, param_bytes=4 * n_params, startup_s=startup_s,
         save_s=save_s, load_s=t1 - t0, load_bf16_s=t2 - t1)
    feed = {'tokens': _tokens(np.random.RandomState(SEED + 2), 4, T, V)}
    paths, last, rows = {}, {}, {}
    for dtype, pred, design in (('float32', f32, 'fwd_tf32x3'),
                                ('bfloat16', bf16, 'fwd_wgmma')):
        pred.run(feed)       # builds the generated kernels of the shape
        kernels.reset_launches()
        out = pred.run(feed)
        torch.cuda.synchronize()
        path = phase + ('_f32' if dtype == 'float32' else '_bf16')
        paths[path] = {k: v for k, v in kernels.launches.items() if v}
        require(paths[path].get('flash_attention_fwd') == L,
                '%s: flash launches %s, not one a layer' % (path,
                                                            paths[path]))
        last[dtype] = np.asarray(out[0], np.float32)
        require(last[dtype].shape == (4, V) and
                bool(np.isfinite(last[dtype]).all()),
                '%s %s: logits of shape %s, finite %s'
                % (phase, dtype, last[dtype].shape,
                   np.isfinite(last[dtype]).all()))
        prof = profile_batch(pred, feed, L, phase, design, instance=instance)
        rows[dtype] = dict(
            batch_ms=prof['run_wall_ms'],
            flash_ms=prof['device_ms_by_group'].get('flash_attention_fwd'),
            device_busy_ms=prof['device_busy_ms'],
            flash_fwd_instances=prof['flash_fwd_instances'])
    err, tol, clear, n = _agree_bf16(last['bfloat16'], last['float32'], L,
                                     '%s bf16 vs float32' % phase, runs=1)
    emit(phase=phase, step='served', rows=4, T=T, by_dtype=rows,
         launches=paths, bf16_vs_float32=dict(max_abs_err=err, tol=tol,
                                              clear_rows=clear, rows=n),
         card=smi)
    del f32, bf16
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------- phase 4

def phase_gpu_vs_cpu():
    """One saved model through the port's Predictor on the card and on
    the CPU, at 1 layer and max_len 512: llama_1b's widths (D = 128),
    Phi-3-mini's (D = 96: the padded tensor-core forward on the card) and
    GPT-J-6B's (D = 256: the forward's instance of width 256)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import llama
    for config, over in (('llama_1b', {}),
                         ('phi3_mini_widths', D96_CFG),
                         ('gptj_6b_widths', GPTJ_CFG)):
        with _model_dir() as d:
            cfg, n_params, _, _ = _build_and_save(
                fluid, llama, d, ALL_FETCHES,
                **dict(over, n_layer=1, max_len=512))
            gpu = fluid.inference.Predictor(d)
            conf = fluid.inference.AnalysisConfig(d)
            conf.disable_gpu()
            cpu = fluid.inference.Predictor(conf)
        rng = np.random.RandomState(SEED + 1)
        feed = {'tokens': _tokens(rng, 2, cfg['max_len'], cfg['vocab'])}
        t0 = time.perf_counter()
        g_logits, g_last, g_tok = gpu.run(feed)
        t1 = time.perf_counter()
        c_logits, c_last, c_tok = cpu.run(feed)
        t2 = time.perf_counter()
        err, tol, clear, n = _agree(g_logits, c_logits,
                                    'gpu vs cpu (%s)' % config)
        require(bool((g_tok == c_tok)[_clear(c_last, tol)].all()),
                'gpu vs cpu (%s): next tokens differ' % config)
        emit(phase='gpu_vs_cpu', config=config, n_layer=cfg['n_layer'],
             max_len=cfg['max_len'],
             head_dim=cfg['d_model'] // cfg['n_head'], params=n_params,
             max_abs_err=err, tol=tol, clear_positions=clear, positions=n,
             gpu_tokens=g_tok.tolist(), cpu_tokens=c_tok.tolist(),
             gpu_s=t1 - t0, cpu_s=t2 - t1)
        del gpu, cpu
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 4b

# the streaming decode server: 8 slots, prefill chunks of 256 tokens (a
# 1024-token prompt prefills in 4 rounds, interleaved with decode windows;
# the reference's default of 8 would take 128), decode windows of 4
GEN_SLOTS, GEN_CHUNK, GEN_WINDOW, GEN_MAX_NEW = 8, 256, 4, 64
GEN_PROMPTS = (128, 1024, 256, 768, 384, 512, 640, 896)


def _llama_scope(fluid, llama, **overrides):
    """llama_1b's weights (full width; `overrides` may cut depth) from its
    program's startup on the card, random from SEED."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.generation_program('llama_1b', mode='prefill',
                                       **overrides)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
    return scope, out['config']


def _stream_vs_dense(gen, w, cfg, prompt, stream, what):
    """Token for token against `dense_reference` (on the weights' device)
    while its top-two gap exceeds 4x the float32 tolerance (1e-4 of the
    largest |logit|: the paged runtime and the dense reference sum in
    other orders); returns the tokens compared."""
    n = 0
    for t in range(len(stream)):
        _, _, lref = gen.dense_reference(w, cfg, list(prompt) +
                                         list(stream[:t]))
        tol = 1e-4 * float(np.abs(lref).max())
        top2 = np.sort(lref)[-2:]
        if top2[1] - top2[0] <= 4 * tol:
            break
        require(int(stream[t]) == int(np.argmax(lref)),
                '%s: token %d is %d, the dense reference says %d'
                % (what, t, stream[t], int(np.argmax(lref))))
        n += 1
    return n


def _op_group(key):
    """A decode window's aten op -> where its device time goes."""
    if key in ('aten::mm', 'aten::addmm'):
        return 'gemm_weights'
    if key == 'aten::bmm':
        return 'attention_products'
    if key in ('aten::_softmax', 'aten::softmax'):
        return 'attention_softmax'
    if key in ('aten::index', 'aten::index_select'):
        return 'logical_row_gathers'
    if key in ('aten::copy_', 'aten::clone', 'aten::contiguous',
               'aten::_reshape_alias', 'aten::reshape'):
        return 'copies'
    if key in ('aten::index_put_', 'aten::_index_put_impl_'):
        return 'kv_writes'
    if key in ('aten::sort', 'aten::argmax', 'aten::gather'):
        return 'sampling'
    return 'elementwise_and_other'


def _decode_kernel_group(name):
    """A decode step's device event -> what launched it (the kernel's
    name: graphs replay no aten ops to attribute it to)."""
    low = name.lower()
    if 'gather_rows' in name:
        return 'embedding_gather'
    if 'memcpy' in low or 'memset' in low:
        return 'memcpy_memset'
    if any(t in low for t in ('gemm', 'gemv', 'cutlass', 'sm90_', 'xmma',
                              'cublas', 'nvjet', 'splitk')):
        return 'gemm'
    if 'index' in low:
        return 'index_gather_scatter'
    if 'sort' in low or 'radix' in low or 'cub::' in low:
        return 'sort'
    if 'softmax' in low:
        return 'softmax'
    if 'reduce' in low:
        return 'reduce'
    if 'catarray' in low:
        return 'cat'
    if 'elementwise' in low:
        return 'elementwise'
    return 'other'


def profile_window(rt, window, phase='generation'):
    """torch.profiler over `window()` (one decode window of GEN_WINDOW
    steps, eager or replayed): device busy ms and idle share, device
    events and kernels (memcpy / memset left out) a step, both split by
    _decode_kernel_group, and for an eager window the device ms by aten
    op group and the kernels each aten op launched a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, events, kernels, by_op = 0.0, 0, 0, {}
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            g = _decode_kernel_group(e.key)
            n_ms = groups.setdefault(g, [0, 0.0])
            n_ms[0] += e.count
            n_ms[1] += e.self_device_time_total / 1e3
            events += e.count
            if g != 'memcpy_memset':
                kernels += e.count
            busy += e.self_device_time_total / 1e3
            top.append((e.self_device_time_total / 1e3, e.key[:80], e.count))
        elif e.self_device_time_total:
            g = _op_group(e.key)
            by_op[g] = by_op.get(g, 0.0) + e.self_device_time_total / 1e3
    by_aten = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and getattr(e, 'kernels', None):
            by_aten[e.name] = by_aten.get(e.name, 0) + len(e.kernels)
    top.sort(reverse=True)
    K = GEN_WINDOW
    return dict(
        phase=phase, steps=K, profiled_wall_ms=wall_ms,
        device_busy_ms=busy,
        device_idle_share=1 - busy / wall_ms if busy else None,
        device_events_per_step=events / K, kernels_per_step=kernels / K,
        kernels_per_step_by_group={g: v[0] / K for g, v in groups.items()},
        device_ms_by_group={g: v[1] for g, v in groups.items()},
        device_ms_by_op_group=by_op,
        kernels_per_step_by_aten_op={k: v / K for k, v in sorted(
            by_aten.items(), key=lambda kv: -kv[1])[:20]},
        top_kernels=[dict(ms=t, name=n, count=c) for t, n, c in top[:12]])


def _state_clone(rt):
    return {n: t.clone() for n, t in rt.state.items()}


def _state_restore(rt, snap):
    for n, t in snap.items():
        rt.state[n].copy_(t)


def _states_equal(a, b):
    """lengths, tok and every page but the garbage page 0 (inactive slots
    all write it, in no fixed order), bit for bit, by state tensor."""
    import torch
    return {n: bool(torch.equal(a[n][1:], b[n][1:]) if a[n].dim() > 1
                    else torch.equal(a[n], b[n])) for n in a}


def graph_vs_eager(rt, gen, prompts, sampling, what):
    """From one state, a prefill chunk, a decode window and a verify window
    of all GEN_SLOTS slots through the runtime's CUDA graphs and through
    the private eager bodies: the tokens, the prefill's logits, lengths,
    tok and every page but page 0 bit for bit."""
    import torch
    rt.reset()
    S, K, C = rt.slots, GEN_WINDOW, rt.prefill_chunk
    params = [gen.SamplingParams(*sp) for sp in sampling]
    # the compared chunk: the short last chunk of a prompt of several
    hold = next(i for i, p in enumerate(prompts) if p.size > C and p.size % C)
    for slot, p in enumerate(prompts):
        require(rt.alloc_slot() == slot, 'slots out of order')
        require(rt.try_begin(slot, p, 4 * K) == 0, 'no pages')
        offs = list(range(0, p.size, C))
        for off in offs[:-1] if slot == hold else offs:
            rt.prefill(slot, p[off:off + C], off, params[slot])
    act = np.ones(S, bool)
    seeds = np.asarray([sp.seed for sp in params], np.int64)
    temps = np.asarray([sp.temperature for sp in params], np.float32)
    topks = np.asarray([sp.top_k for sp in params], np.int64)
    res = {}

    def both(name, call):
        snap = _state_clone(rt)
        g = call(False)
        g_state = _state_clone(rt)
        _state_restore(rt, snap)
        e = call(True)
        torch.cuda.synchronize()
        same_out = all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(g, e)) if isinstance(g, tuple) \
            else np.array_equal(g, e)
        res[name] = dict(outputs=same_out, state=_states_equal(g_state,
                                                               rt.state))
        return e

    p, off = prompts[hold], (prompts[hold].size - 1) // C * C
    tok, _ = both('prefill', lambda eager: rt._prefill(
        hold, p[off:off + C], off, params[hold], eager=eager))
    rt.host_len[hold], rt.host_tok[hold] = p.size, tok
    out = both('decode', lambda eager: rt._window(
        'decode', K, None, act, seeds, temps, topks, eager=eager))
    rt.host_len[:] += K
    rt.host_tok[:] = out[:, -1]
    fed = np.zeros((S, K), np.int64)
    for slot, p in enumerate(prompts):
        fed[slot, 0] = rt.host_tok[slot]
        fed[slot, 1:] = gen.draft_ngram(p, K - 1)
    both('verify', lambda eager: rt._window(
        'verify', K, fed, act, seeds, temps, topks, eager=eager))
    line = dict(phase='generation', step='graph_vs_eager', kv=what,
                keys=sorted('%s_%d' % k for k in rt._execs), checks=res)
    emit(**line)
    bad = {k: v for k, v in res.items()
           if not (v['outputs'] and all(v['state'].values()))}
    require(not bad, '%s: graph and eager differ: %s' % (what, bad))
    rt.reset()
    return line


def window_modes(rt, gen, prompts, smi):
    """GEN_SLOTS slots decoding: decode windows through the private eager
    body and through the CUDA graph, in turns (eager, graph, graph,
    eager), WINDOW_READS windows each: median window ms; then one window
    of each profiled (device busy, idle share, kernels a step split by
    group), re-profiled up to PROFILE_TRIES times while the two modes'
    kernels a step differ (the profiler drops events now and then)."""
    import torch
    rt.reset()
    K = GEN_WINDOW
    for slot, p in enumerate(prompts):
        require(rt.alloc_slot() == slot, 'slots out of order')
        # pages for every window below
        require(rt.try_begin(slot, p, 32 * K) == 0, 'no pages')
        for off in range(0, p.size, GEN_CHUNK):
            rt.prefill(slot, p[off:off + GEN_CHUNK], off,
                       gen.SamplingParams())
    S = rt.slots
    act = np.ones(S, bool)
    zi, zf = np.zeros(S, np.int64), np.zeros(S, np.float32)

    def window(eager):
        return lambda: rt._window('decode', K, None, act, zi, zf, zi,
                                  eager=eager)

    ms = {'eager': [], 'graph': []}
    for mode in ('eager', 'graph', 'graph', 'eager'):
        for _ in range(WINDOW_READS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window(mode == 'eager')()
            ms[mode].append((time.perf_counter() - t0) * 1e3)
    for tries in range(1, PROFILE_TRIES + 1):
        prof = {m: profile_window(rt, window(m == 'eager'))
                for m in ('eager', 'graph')}
        if prof['eager']['kernels_per_step'] == \
                prof['graph']['kernels_per_step']:
            break
    med = {m: float(np.median(v)) for m, v in ms.items()}
    res = dict(phase='generation', step='window_modes', steps=K,
               active_slots=S, key_positions=[int(x) for x in
                                              rt.state['lengths'].cpu()],
               window_ms=med,
               # the profiled window's device busy time over the median
               # unprofiled window (the profiler slows the host)
               device_idle_share={m: 1 - prof[m]['device_busy_ms'] / med[m]
                                  for m in med},
               window_ms_readings=ms, profile_tries=tries, profiles=prof,
               card=smi)
    emit(**res)
    for m, pr in prof.items():
        require(pr['device_busy_ms'] > 0, 'the profiler saw no device time '
                'in the %s window' % m)
    require(prof['eager']['kernels_per_step'] ==
            prof['graph']['kernels_per_step'], 'kernels a step differ: '
            'eager %s, graph %s' % (prof['eager']['kernels_per_step'],
                                    prof['graph']['kernels_per_step']))
    rt.reset()
    return res


WINDOW_READS = 5   # decode windows a reading of window_modes


def fault_then_alone(rt, gen, serving, prompts):
    """A decode_step fault through the real site (testing/faults.py): the
    faulted window's streams get error replies and free their slots; a
    seeded stream after it equals the same request run alone."""
    from paddle_tpu_torch.testing import faults
    rt.reset()
    eng = gen.GenerationEngine(
        rt, config=serving.ServingConfig(max_queue=16),
        gen_config=gen.GenerationConfig(decode_window=GEN_WINDOW))
    sp = (0.8, 40, 21)
    try:
        faults.configure('decode_step:at=1')
        with eng:
            hit = [eng.generate(p[:128], max_new=8).result(300)
                   for p in prompts[:2]]
            after = eng.generate(prompts[2][:200], max_new=16,
                                 temperature=sp[0], top_k=sp[1],
                                 seed=sp[2]).result(300)
    finally:
        faults.reset()
    # every page still held is one the prefix cache keeps
    free = rt.free_slots() == rt.slots and rt.pool.in_use() == (
        len(rt.prefix) if rt.prefix is not None else 0)
    rt.reset()
    alone = rt.generate(prompts[2][:200], 16, gen.SamplingParams(*sp),
                        steps_per_window=GEN_WINDOW)
    res = dict(phase='generation', step='decode_step_fault',
               statuses=[(r.status, r.reason) for r in hit],
               after=(after.status, after.reason), slots_freed=free,
               after_equals_alone=after.ok and
               [int(t) for t in after.outputs[0]] == alone)
    emit(**res)
    require(any(r.status == 'error' and r.reason == 'decode_step'
                for r in hit), 'the decode_step fault errored no stream')
    require(free, 'the fault left slots or pages held')
    require(res['after_equals_alone'], 'a stream after the fault differs '
            'from the same request alone')
    rt.reset()
    return res


def cached_attention_case(name, S, Tq, Tk, offset, H=16, Hkv=8, D=128):
    """The plain cached_attention (float32) against one SDPA call with the
    same positional mask, timed only: the decision on a decode-attention
    kernel waits on it."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as att
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    q = torch.randn(S, H, Tq, D, generator=g, device='cuda')
    k = torch.randn(S, Hkv, Tk, D, generator=g, device='cuda')
    v = torch.randn(S, Hkv, Tk, D, generator=g, device='cuda')
    # each slot at its own length: slot s sees keys [0, offset - 3 s + t]
    qpos = (offset + torch.arange(Tq, device='cuda')[None, :]
            - 3 * torch.arange(S, device='cuda')[:, None]).clamp(0, Tk - 1)
    mask = (torch.arange(Tk, device='cuda')[None, None, :]
            <= qpos[:, :, None])[:, None]
    out = att.cached_attention(q, k, v, qpos)
    ref = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    pairs = int(mask.sum()) * H
    nbytes = 4 * (2 * S * H * Tq * D + 2 * S * Hkv * Tk * D) + 8 * S * Tq
    bound_ms, bound_by = _bound(4.0 * D * pairs, nbytes, 'float32')
    res = dict(phase='generation', step='cached_attention', case=name, S=S,
               H=H, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, dtype='float32',
               max_abs_err_vs_sdpa=float((out - ref).abs().max()),
               ms=time_ms(lambda: att.cached_attention(q, k, v, qpos), 20),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True), 20),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=4.0 * D * pairs)
    emit(**res)
    require(res['max_abs_err_vs_sdpa'] <= 1e-4, 'cached_attention and SDPA '
            'disagree in case %s: %s' % (name, res))
    return res


def phase_generation(smi):
    """Streaming generation of llama_1b (full width and depth, float32,
    TF32 off) through GenerationEngine over make_streaming_runtime, whose
    prefill chunks and decode windows replay CUDA graphs."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import generation as gen
    t0 = time.perf_counter()
    scope, cfg = _llama_scope(fluid, llama)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = llama.make_streaming_runtime(scope, 'llama_1b', slots=GEN_SLOTS,
                                      prefill_chunk=GEN_CHUNK)
    del scope
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    # build the served keys before the first request: nvcc for K4 and the
    # warm-up run on the side stream, then the captures; no state changes
    # outside the garbage page 0
    t0 = time.perf_counter()
    rt.warmup(GEN_WINDOW)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the graphs' private pool keeps its blocks through empty_cache
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    graphs = dict(warmup_s=warmup_s, warm_up_s={
        '%s_%d' % k: e.warm_up_s for k, e in rt._execs.items()}, capture_s={
        '%s_%d' % k: e.capture_s for k, e in rt._execs.items()},
        reserved_gb_before=reserved0 / 1e9,
        reserved_gb_after=reserved1 / 1e9,
        graph_pool_gb=(reserved1 - reserved0) / 1e9)
    require(not rt.state['lengths'].any() and not rt.state['tok'].any() and
            not any(t[1:].any() for t in rt.state.values() if t.dim() > 1),
            'warmup changed state outside page 0')
    V = cfg['vocab']
    rng = np.random.RandomState(SEED + 7)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in GEN_PROMPTS]
    # greedy and seeded top-k, alternating
    sampling = [(0.0, 0, 0) if i % 2 == 0 else (0.8, 40, 100 + i)
                for i in range(len(prompts))]
    eng = gen.GenerationEngine(
        rt, config=serving.ServingConfig(max_queue=16),
        gen_config=gen.GenerationConfig(decode_window=GEN_WINDOW))
    kernels.reset_launches()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        with eng:
            streams = [eng.generate(p, max_new=GEN_MAX_NEW, temperature=t,
                                    top_k=k, seed=s)
                       for p, (t, k, s) in zip(prompts, sampling)]
            results = [st.result(900) for st in streams]
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    c = eng.counters
    statuses = [r.status for r in results]
    require(all(r.ok and r.reason == 'max_tokens' for r in results),
            'streams not ok: %s' % statuses)
    require(set(rt._execs) == {('prefill', GEN_CHUNK),
                               ('decode', GEN_WINDOW)},
            'the served run built keys past warmup: %s' % sorted(rt._execs))
    outs = [np.asarray(r.outputs[0]) for r in results]
    require(all(o.shape == (GEN_MAX_NEW,) and ((o >= 0) & (o < V)).all()
                for o in outs), 'bad generated ids')
    require(all(st.tokens_so_far() == list(o)
                for st, o in zip(streams, outs)), 'streamed tokens differ '
            'from the terminal reply')
    done = sum(c.get('serving.' + k) for k in (
        'completed', 'shed', 'deadline_exceeded', 'errors', 'rejected'))
    require(done == c.get('serving.submitted') == len(prompts) and
            c.get('serving.deadlocks') == 0, 'terminal replies %d of %d'
            % (done, c.get('serving.submitted')))
    chunks = c.get('generation.prefill_chunks')
    windows = c.get('generation.decode_windows')
    require(chunks == sum(-(-n // GEN_CHUNK) for n in GEN_PROMPTS),
            'prefill chunks %d' % chunks)
    # K4 embeds every prefill chunk and every decode step; nothing else
    # (credited once a replay with what its capture launched)
    per_step = (launches['embedding_gather'] - chunks) / (windows *
                                                          GEN_WINDOW)
    require(per_step == 1, 'gather launches %d != %d chunks + %d steps'
            % (launches['embedding_gather'], chunks, windows * GEN_WINDOW))
    require(not plain.counts, 'plain versions ran on the card: %s'
            % plain.counts)
    win = c.histogram('generation.decode_window_ms')
    pre = c.histogram('generation.prefill_chunk_ms')
    decode_tokens = c.get('generation.tokens') - len(prompts)
    res = dict(
        phase='generation', step='served', config='llama_1b',
        n_layer=cfg['n_layer'], dtype='float32', tf32=False,
        slots=GEN_SLOTS, prefill_chunk=GEN_CHUNK, decode_window=GEN_WINDOW,
        page_len=rt.cache.page_len,
        prompts=list(GEN_PROMPTS), max_new=GEN_MAX_NEW, sampling=sampling,
        statuses=statuses, wall_s=wall, setup_s=setup_s, graphs=graphs,
        ttft_ms_p50=c.quantile('serving.ttft_ms', 0.5),
        ttft_ms_p99=c.quantile('serving.ttft_ms', 0.99),
        itl_ms_p50=c.quantile('serving.itl_ms', 0.5),
        itl_ms_p99=c.quantile('serving.itl_ms', 0.99),
        decode_window_ms=win, decode_window_ms_p50=c.quantile(
            'generation.decode_window_ms', 0.5),
        prefill_chunk_ms=pre, prefill_chunk_ms_p50=c.quantile(
            'generation.prefill_chunk_ms', 0.5),
        prefill_chunks=chunks, decode_windows=windows,
        mixed_rounds=c.get('generation.mixed_dispatches'),
        decode_tokens_per_s=decode_tokens / (win['sum'] / 1e3),
        output_tokens_per_s=c.get('generation.tokens') / wall,
        prompt_tokens_per_s=sum(GEN_PROMPTS) / (pre['sum'] / 1e3),
        kv_pool_bytes=rt.cache.bytes(), kv_pages=rt.cache.pages,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, card=smi)
    emit(**res)
    # two greedy streams against the page-free dense reference, on the card
    compared = [_stream_vs_dense(gen, rt.w, cfg, prompts[i], outs[i],
                                 'greedy stream %d' % i) for i in (0, 2)]
    # a stream of the batch against the same request alone (the longest
    # prompt, seeded, and the shortest, greedy): bitwise
    alone = {}
    for i in (1, 0):
        rt.reset()
        alone[i] = rt.generate(prompts[i], GEN_MAX_NEW,
                               gen.SamplingParams(*sampling[i]),
                               steps_per_window=GEN_WINDOW)
    # a seeded stream at windows of 1 and 4: bitwise
    sp = gen.SamplingParams(0.8, 40, 7)
    one = rt.generate(prompts[1][:250], 24, sp, steps_per_window=1)
    four = rt.generate(prompts[1][:250], 24, sp, steps_per_window=4)
    batch_equal = {i: alone[i] == [int(t) for t in outs[i]] for i in alone}
    emit(phase='generation', step='checks', greedy_vs_dense_compared=compared,
         alone_equals_batched=batch_equal, seeded_k1=one, seeded_k4=four,
         seeded_equal=one == four)
    require(min(compared) >= 8, 'greedy streams held to the dense reference '
            'for only %s tokens' % compared)
    require(all(batch_equal.values()), 'a stream run alone differs from the '
            'same request in the batch: %s' % batch_equal)
    require(one == four, 'a seeded stream differs between windows of 1 and 4')
    # graph against the private eager body, float32 then int8 KV
    graph_vs_eager(rt, gen, prompts, sampling, 'float32')
    window_modes(rt, gen, prompts, smi)
    fault_then_alone(rt, gen, serving, prompts)
    rt8 = gen.DecodeRuntime(rt.w, cfg, slots=GEN_SLOTS,
                            prefill_chunk=GEN_CHUNK, kv_quant='int8')
    rt8.warmup(GEN_WINDOW, speculative=True)
    graph_vs_eager(rt8, gen, prompts, sampling, 'int8')
    del rt8
    for case in (('decode_tk128', 8, 1, 128, 127),
                 ('decode_tk512', 8, 1, 512, 511),
                 ('decode_tk1152', 8, 1, 1152, 1151),
                 ('decode_tk2048', 8, 1, 2048, 2047),
                 ('prefill_chunk256_tk1024', 1, 256, 1024, 768)):
        cached_attention_case(*case)
    del rt, eng
    torch.cuda.empty_cache()
    return {'embedding_gather': per_step}


def phase_generation_gpu_vs_cpu():
    """llama_1b width cut to 2 layers (random_weights from SEED): a 64-token
    prompt and 16 greedy tokens through the paged runtime on the card and
    on the CPU."""
    import torch
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import generation as gen
    cfg = dict(llama.CONFIGS['llama_1b'], n_layer=2)
    w = gen.random_weights(cfg, seed=SEED)
    prompt = np.random.RandomState(SEED + 9).randint(0, cfg['vocab'], 64)
    res = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        rt = gen.DecodeRuntime(w, cfg, slots=1, prefill_chunk=64,
                               device=dev)
        slot = rt.alloc_slot()
        require(rt.try_begin(slot, prompt, 16) == 0, 'no pages')
        first, logits = rt.prefill(slot, prompt, 0, gen.SamplingParams())
        toks = rt.decode_window(15, np.ones(1, bool), np.zeros(1, np.int64),
                                np.zeros(1, np.float32),
                                np.zeros(1, np.int64))[0]
        res[dev] = ([int(first)] + [int(t) for t in toks], logits,
                    time.perf_counter() - t0)
        del rt
    torch.cuda.empty_cache()
    (g_stream, g_logits, g_s), (c_stream, c_logits, c_s) = \
        res['cuda'], res['cpu']
    tol = 1e-4 * float(np.abs(c_logits).max())
    err = float(np.abs(g_logits - c_logits).max())
    # the CPU stream held to the dense reference while the margin clears;
    # the card's stream must equal it there
    compared = _stream_vs_dense(gen, w, cfg, prompt, c_stream, 'cpu stream')
    same = g_stream[:compared] == c_stream[:compared]
    emit(phase='generation_gpu_vs_cpu', config='llama_1b width, 2 layers',
         dtype='float32', tf32=False, prompt_tokens=64, new_tokens=16,
         prefill_max_abs_err=err, tol=tol, gpu_stream=g_stream,
         cpu_stream=c_stream, compared=compared, equal_where_clear=same,
         equal=g_stream == c_stream, gpu_s=g_s, cpu_s=c_s)
    require(err <= tol, 'gpu vs cpu: prefill logits differ by %g > %g'
            % (err, tol))
    require(compared >= 8 and same, 'gpu vs cpu: streams differ where the '
            'margin clears (%d compared)' % compared)


# ------------------------------------------------------------- phase 5

# launches per training step on the bench configuration: 18 attention
# calls (6 encoder self, 6 decoder causal self, 6 cross) forward and
# backward, 2 embedding gathers, 32 LayerNorms (2 per encoder layer, 3 per
# decoder layer, 2 final), one multi-tensor Adam call for 158 parameters
TRAIN_LAUNCHES = {'flash_attention_fwd': 18, 'flash_attention_bwd_dq': 18,
                  'flash_attention_bwd_dkv': 18, 'embedding_gather': 2,
                  'layer_norm': 32, 'adam_multi': 1}


def _train_program(fluid, tr, amp, **overrides):
    cfg = dict(BENCH_CFG, **overrides)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = tr.build(**cfg)
    main.set_amp(amp)
    return main, startup, out


def _group(name):
    low = name.lower()
    if 'flash_bwd_dq' in name:    # flash_bwd_dq_[wgmma_]kernel
        return 'flash_attention_bwd_dq'
    if 'flash_bwd_dkv' in name:   # flash_bwd_dkv_[wgmma_]kernel
        return 'flash_attention_bwd_dkv'
    if 'flash_fwd' in name:       # flash_fwd_[wgmma_]kernel
        return 'flash_attention_fwd'
    if 'layer_norm_kernel' in name:
        return 'layer_norm'
    if 'softmax_kernel' in name:
        return 'softmax'
    if 'kg_' in name:
        return 'kernelgen_segment'
    if 'adam_bf16' in name:
        return 'adam_multi_bf16'
    if 'adam_kernel' in name or 'adam_pows_kernel' in name:
        return 'adam_multi'
    if 'momentum_kernel' in name:
        return 'momentum_multi'
    if 'momentum_bf16_kernel' in name:
        return 'momentum_multi_bf16'
    m = _OPTIM_KERNEL.search(name)
    if m and (m.group(2), m.group(3) or '') in OPTIM_FUNCTORS:
        # csrc/optim_multi.cu's instances, by update functor
        return OPTIM_FUNCTORS[m.group(2), m.group(3) or ''] + (
            '_bf16' if m.group(1) else '')
    if 'gather_rows' in name:
        return 'embedding_gather'
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    if any(t in low for t in ('gemm', 'cutlass', 'sm90_', 'xmma', 'cublas',
                              'nvjet')):
        return 'gemm'
    return 'elementwise_and_other'


def _flash_design(name):
    """The flash kernel a profiler key names, by design: 'fwd_wgmma',
    'bwd_dq_wgmma' and 'bwd_dkv_wgmma' (bf16, tensor cores), 'fwd_tf32x3',
    'bwd_dq_tf32x3' and 'bwd_dkv_tf32x3' (float32 as 3xTF32, tensor cores),
    'fwd_cc', 'bwd_dq_cc' and 'bwd_dkv_cc' (CUDA cores, csrc/flash_cc.cu:
    the other head dims); None for any other kernel."""
    for stem, short in (('flash_fwd', 'fwd'), ('flash_bwd_dkv', 'bwd_dkv'),
                        ('flash_bwd_dq', 'bwd_dq')):
        if stem in name:
            return short + ('_wgmma' if 'wgmma' in name else
                            '_tf32x3' if 'tf32x3' in name else '_cc')
    return None


def _flash_by_design(averages):
    """{design: [device ms, launches]} of the flash kernels in a profile's
    key_averages()."""
    from torch.autograd import DeviceType
    flash = {}
    for e in averages:
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        design = _flash_design(e.key)
        if design:
            acc = flash.setdefault(design, [0.0, 0])
            acc[0] += e.self_device_time_total / 1e3
            acc[1] += e.count
    return flash


def profile_step(exe, main, feed, fetch, phase='training'):
    """torch.profiler over one interpreted training step
    (use_program_cache=False): device time by kernel group (device-side
    events only) and the device's idle share of the step; returns the
    flash kernels' {design: [device ms, launches]}.  graph_modes profiles
    the graph replays."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, use_program_cache=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        ms = e.self_device_time_total / 1e3
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
        top.append((ms, e.key[:80], e.count))
    flash = _flash_by_design(prof.key_averages())
    top.sort(reverse=True)
    busy = sum(groups.values())
    emit(phase=phase, step='profile', profiled_wall_ms=wall_ms,
         device_ms_by_group=groups, device_busy_ms=busy,
         device_idle_share=(1 - busy / wall_ms) if busy else None,
         flash_by_design=flash,
         top_kernels=[dict(ms=t, name=n, count=c) for t, n, c in top[:15]])
    require(busy > 0, 'the profiler saw no device time')
    return flash


# the kernel groups (_group) of the hand-written and generated kernels: a
# profile counts their device launches beside the wrappers' counts
# csrc/optim_multi.cu's update functors, as the profiler names them in
# optim_kernel<...>, and the instance each is
OPTIM_FUNCTORS = {('Sgd', ''): 'sgd_multi', ('Adagrad', 'false'):
                  'adagrad_multi', ('Adagrad', 'true'): 'decayed_adagrad_multi',
                  ('Adamax', ''): 'adamax_multi',
                  ('Adadelta', ''): 'adadelta_multi',
                  ('Rmsprop', 'false'): 'rmsprop_multi',
                  ('Rmsprop', 'true'): 'rmsprop_centered_multi',
                  ('Ftrl', 'false'): 'ftrl_multi',
                  ('Ftrl', 'true'): 'ftrl_pow_multi'}
# optim_kernel<Functor<float[, flag]>> and its bf16 instance
# optim_bf16_kernel<Functor<jnp::J[, flag]>>
_OPTIM_KERNEL = re.compile(r'optim(_bf16)?_kernel<.*?(\w+)<(?:float|jnp::J)'
                           r'(?:, (true|false))?>')
KERNEL_GROUPS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'layer_norm', 'softmax',
                 'kernelgen_segment', 'adam_multi', 'adam_multi_bf16',
                 'momentum_multi', 'momentum_multi_bf16',
                 'embedding_gather') + tuple(
                     g + s for g in OPTIM_FUNCTORS.values()
                     for s in ('', '_bf16'))


def _profiled(fn):
    """torch.profiler over fn(): (host wall ms, device busy ms, the flash
    kernels by design, device kernels seen, {KERNEL_GROUPS group: device
    launches}); a CUDA graph's kernels show as device events of their
    own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, seen, groups = 0.0, 0, {}
    averages = prof.key_averages()
    for e in averages:
        if e.device_type != DeviceType.CUDA:
            continue
        g = _group(e.key)
        if g in KERNEL_GROUPS:
            groups[g] = groups.get(g, 0) + e.count
        if e.self_device_time_total:
            busy += e.self_device_time_total / 1e3
            seen += e.count
    return wall_ms, busy, _flash_by_design(averages), seen, groups


# device kernels one counted launch runs: each Adam instance's update and
# its beta-power kernel; every other wrapper launches one
DEVICE_KERNELS = {'adam_multi': 2, 'adam_multi_bf16': 2}
PROFILE_TRIES = 3


def _profiled_launches(fn):
    """_profiled(fn) with the wrappers' counts over the same window, as
    device kernels (DEVICE_KERNELS) of each KERNEL_GROUPS group; a CUDA
    graph's replay adds what its capture counted.  The profiler drops
    kernel events now and then (card runs saw 90 of a window's 92
    generated-segment launches, and 141 of 144 flash forwards in a
    run_steps window; one call lost a flash forward, and more, in each of
    three tries), so a window whose device launches differ from the
    counted ones is profiled again, at most PROFILE_TRIES times in all.
    Every try runs the same kernels and the profiler never adds an event,
    so each kernel group and flash design keeps the most launches any try
    saw (its device ms from that try); wall, busy and events are the last
    try's.  -> (_profiled's tuple so merged, counted, tries)."""
    from paddle_tpu_torch import kernels
    groups, flash = {}, {}
    for tries in range(1, PROFILE_TRIES + 1):
        before = dict(kernels.launches)
        res = _profiled(fn)
        counted = {k: (v - before.get(k, 0)) * DEVICE_KERNELS.get(k, 1)
                   for k, v in kernels.launches.items()
                   if k in KERNEL_GROUPS and v != before.get(k, 0)}
        for g, c in res[4].items():
            groups[g] = max(groups.get(g, 0), c)
        for d, (ms, c) in res[2].items():
            if c >= flash.get(d, (0.0, 0))[1]:
                flash[d] = [ms, c]
        if groups == counted:
            break
    return (res[0], res[1], flash, res[3], groups), counted, tries


def _seen_on_device(what, device, counted):
    """Every kernel group the wrappers counted in a window shows on the
    device, and none more than counted (the profiler may drop an event,
    never add one)."""
    for g in set(device) | set(counted):
        require(0 < device.get(g, 0) <= counted.get(g, 0),
                '%s: %s device launches of %s, %s counted'
                % (what, device.get(g, 0), g, counted.get(g, 0)))


def _peak_memory():
    """Peak device memory since the last reset, in GB: `peak_mem_gb`
    counts live tensors only, which leaves out the blocks a CUDA graph's
    private pool keeps for its intermediates between replays;
    `peak_reserved_gb` counts every block the allocator holds (emptied of
    unused cached blocks before the reading), the graph pools included."""
    import torch
    return dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


K_STEPS = 8      # run_steps' K, as bench.py headlines it
MODE_STEPS = 10  # steps a reading of run, the graph and check_nan


def graph_modes(phase, smi, exe, main, feed, fetch, tokens, flash_want):
    """The step through four paths, in turns (ABCDDCBA): `eager` is
    Executor.run with use_program_cache=False (the interpreter), `graph`
    Executor.run (a replay of the signature's CUDA graph), `run_steps`
    run_steps(K=8), two launches with return_numpy=False and one sync,
    then two with return_numpy=True, and `check_nan` an
    Executor(check_nan=True, nan_poll=8) on the same scope.  Per mode:
    median step ms, tokens/s, launches per step, peak memory; one
    profiled window (two steps, one run_steps call) for device busy and
    idle share; the capture seconds of each signature.  Launches per step
    must agree across the modes as the wrappers count them (a replay adds
    what its capture counted); on the device, each mode's profiled window
    must show exactly the flash kernels of `flash_want` ({design:
    launches a step}) and every kernel group the wrappers counted in it
    (`_profiled_launches`, `_seen_on_device`)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    stacked = {k: np.stack([v] * K_STEPS) for k, v in feed.items()}
    nan_exe = fluid.Executor(check_nan=True, nan_poll=8)
    for _ in range(2):          # its own signature: warm-up, capture
        nan_exe.run(main, feed=feed, fetch_list=fetch)
    losses = []

    def steps(ex, **kw):
        ms = []
        for _ in range(MODE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(ex.run(main, feed=feed, fetch_list=fetch,
                                       **kw)[0][0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return dict(step_ms=ms, steps=MODE_STEPS, wall_ms=sum(ms))

    def run_steps():
        t0 = time.perf_counter()
        outs = [exe.run_steps(main, feed_list=stacked, steps=K_STEPS,
                              fetch_list=fetch, return_numpy=False)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        losses.extend(float(v) for o in outs for v in o.reshape(-1).cpu())
        t0 = time.perf_counter()
        for _ in range(2):
            out = exe.run_steps(main, feed_list=stacked, steps=K_STEPS,
                                fetch_list=fetch)[0]
            losses.extend(float(v) for v in out.reshape(-1))
        np_ms = (time.perf_counter() - t0) * 1e3
        per = dev_ms / (2 * K_STEPS)
        return dict(step_ms=[per], steps=4 * K_STEPS, wall_ms=dev_ms + np_ms,
                    step_ms_return_numpy=np_ms / (2 * K_STEPS))

    runs = {'eager': lambda: steps(exe, use_program_cache=False),
            'graph': lambda: steps(exe), 'run_steps': run_steps,
            'check_nan': lambda: steps(nan_exe)}
    readings = {m: [] for m in runs}
    for mode in ('eager', 'graph', 'run_steps', 'check_nan', 'check_nan',
                 'run_steps', 'graph', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = (dict(kernels.launches), dict(kernelgen.launches))
        r = runs[mode]()
        torch.cuda.synchronize()
        n = r.pop('steps')
        r['launches_per_step'] = {
            k: (v - before[0].get(k, 0)) / n
            for k, v in kernels.launches.items() if v - before[0].get(k, 0)}
        r['segment_launches_per_step'] = sum(
            v - before[1].get(k, 0) for k, v in kernelgen.launches.items()
            ) / n
        r.update(_peak_memory())
        readings[mode].append(r)
    windows = {
        'eager': lambda: [exe.run(main, feed=feed, fetch_list=fetch,
                                  use_program_cache=False)
                          for _ in range(2)],
        'graph': lambda: [exe.run(main, feed=feed, fetch_list=fetch)
                          for _ in range(2)],
        'run_steps': lambda: exe.run_steps(main, feed_list=stacked,
                                           steps=K_STEPS, fetch_list=fetch,
                                           return_numpy=False),
        'check_nan': lambda: [nan_exe.run(main, feed=feed, fetch_list=fetch)
                              for _ in range(2)]}
    out = {}
    for mode, rs in readings.items():
        med = [float(np.median(r['step_ms'])) for r in rs]
        (wall, busy, flash, seen, groups), counted, tries = \
            _profiled_launches(windows[mode])
        n = K_STEPS if mode == 'run_steps' else 2
        out[mode] = dict(
            median_step_ms=med, tokens_per_s=[tokens / (m / 1e3)
                                              for m in med],
            readings=rs, profiled_wall_ms=wall, device_busy_ms=busy,
            device_idle_share=(1 - busy / wall) if busy else None,
            profiled_steps=n, profiled_device_events=seen,
            flash_by_design=flash, profile_tries=tries,
            device_launches_per_step={g: c / n for g, c in groups.items()},
            counted_device_launches_per_step={g: c / n
                                              for g, c in counted.items()})
    captures = {'run': [e.capture_s for e in exe._graphs.entries.values()
                        if e.capture_s is not None],
                'check_nan': [e.capture_s for e in
                              nan_exe._graphs.entries.values()
                              if e.capture_s is not None]}
    emit(phase=phase, step='graph_modes', k=K_STEPS, modes=out,
         capture_s=captures, card=smi)
    require(all(np.isfinite(losses)), 'non-finite loss in graph_modes')
    ref = readings['eager'][0]['launches_per_step']
    for mode, rs in readings.items():
        for r in rs:
            require(r['launches_per_step'] == ref,
                    '%s: launches per step %s, the interpreter %s'
                    % (mode, r['launches_per_step'], ref))
    for mode, o in out.items():
        n = o['profiled_steps']
        got = {k: c for k, (_, c) in o['flash_by_design'].items()}
        want = {k: v * n for k, v in flash_want.items()}
        require(got == want, '%s: flash kernels in the profiled window of '
                '%d steps: %s, expected %s' % (mode, n, got, want))
        _seen_on_device(mode, o['device_launches_per_step'],
                        o['counted_device_launches_per_step'])
    nan_exe.poll_nan()
    return out


def bitwise_paths(phase, exe, main, scope, feed, fetch, n=3):
    """From one scope state and one set of run counters, n steps through
    the interpreter, through the graph and through run_steps(n): the
    losses and every scope tensor must agree bit for bit."""
    snap = {k: t.clone() for k, t in scope.vars.items()}
    state = exe.rng_state()
    res = {}
    for mode in ('eager', 'graph', 'run_steps'):
        for k, t in snap.items():
            scope.vars[k].copy_(t)
        exe.set_rng_state(state)
        if mode == 'run_steps':
            losses = exe.run_steps(main, feed_list=[feed] * n,
                                   fetch_list=fetch)[0]
        else:
            losses = np.stack([exe.run(
                main, feed=feed, fetch_list=fetch,
                use_program_cache=mode == 'graph')[0] for _ in range(n)])
        res[mode] = (losses.reshape(n), {k: t.clone()
                                         for k, t in scope.vars.items()})
    import torch
    eager = res['eager']
    differ = {m: sorted(k for k, t in eager[1].items()
                        if not torch.equal(res[m][1][k], t))
              for m in ('graph', 'run_steps')}
    same_losses = {m: res[m][0].tobytes() == eager[0].tobytes()
                   for m in differ}
    emit(phase=phase, step='bitwise', steps=n, tensors=len(snap),
         losses={m: r[0].tolist() for m, r in res.items()},
         losses_equal=same_losses, tensors_differing=differ)
    require(all(same_losses.values()) and not any(differ.values()),
            'graph / run_steps against the interpreter: losses equal %s, '
            'tensors differing %s' % (same_losses, differ))
    del snap, res


# the flash kernels of one training step, by design (profile_step): bf16
# under AMP on the bf16 tensor-core kernels, float32 on the 3xTF32 ones;
# neither runs a CUDA-core flash kernel
TRAIN_FLASH = {
    True: {'fwd_wgmma': 18, 'bwd_dq_wgmma': 18, 'bwd_dkv_wgmma': 18},
    False: {'fwd_tf32x3': 18, 'bwd_dq_tf32x3': 18, 'bwd_dkv_tf32x3': 18}}


def phase_training(smi):
    """transformer-base (bench.py's step) trained through the port's
    Executor on the card: AMP on, random init from a seed."""
    return _train_flash('training', smi, amp=True)


def phase_training_f32(smi):
    """The same step in float32, the reference's default precision (no
    set_amp): its flash forward, dQ and dK/dV run as 3xTF32 on the tensor
    cores; the other float32 matrix products stay full float32 (TF32 off,
    set in main)."""
    return _train_flash('training_f32', smi, amp=False)


def _train_flash(phase, smi, amp):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _train_program(fluid, tr, amp=amp)
    params = main.all_parameters()
    n_params = sum(int(np.prod(p.shape)) for p in params)
    mm_params = sum(int(np.prod(p.shape)) for p in params
                    if len(p.shape) == 2 and not p.name.endswith('_emb'))
    B, T = 32, BENCH_CFG['max_len']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T,
                              BENCH_CFG['trg_vocab'])
    tokens = float(np.sum(1.0 - feed['trg_pad']))
    # model math: 6 FLOPs per matrix-product weight per token (forward and
    # backward, both token streams), plus attention: 4*D per (query, key)
    # pair forward and twice that backward, 18 attention calls
    dh = BENCH_CFG['d_model'] // BENCH_CFG['n_head']
    attn = 3 * 18 * 4 * dh * B * BENCH_CFG['n_head'] * T * T
    model_flops = 6.0 * mm_params * B * T + attn
    scope, exe = fluid.Scope(), fluid.Executor()
    fetch = [out['loss']]
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            warm.append(float(exe.run(main, feed=feed,
                                      fetch_list=fetch)[0][0]))
            warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_launches()
        kernelgen.launches.clear()
        losses, step_ms = [], []
        t_all = time.perf_counter()
        for _ in range(10):
            t0 = time.perf_counter()
            loss = exe.run(main, feed=feed, fetch_list=fetch)[0]
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss[0]))
        wall = time.perf_counter() - t_all
        launches = dict(kernels.launches)
        seg = dict(kernelgen.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v / 10 for k, v in launches.items()}
        planned = planned_segments(main, [out['loss'].name])
        med = float(np.median(step_ms))
        emit(phase=phase, step='steps', config='transformer-base',
             cfg=BENCH_CFG, amp=amp, B=B, T=T, params=n_params,
             param_tensors=len(params), startup_s=startup_s,
             warmup_losses=warm, last_warmup_step_s=warm_s, losses=losses,
             step_ms=step_ms, median_step_ms=med, wall_s=wall,
             tokens_per_step=tokens, tokens_per_s=tokens * 10 / wall,
             model_tflop_per_step=model_flops / 1e12,
             model_tflops=model_flops / med / 1e9, peak_mem_gb=peak_gb,
             launches_per_step=per_step, planned_segments_per_step=planned,
             segment_launches_per_step={k: v / 10 for k, v in seg.items()},
             adam_table_builds=exe._kernel_cache.get('adam_multi_tables'),
             card=smi)
        require(all(np.isfinite(losses + warm)), 'non-finite training loss')
        for k, n in TRAIN_LAUNCHES.items():
            require(per_step.get(k) == n, '%s: %s launches per step, expected '
                    '%d' % (k, per_step.get(k), n))
        require(per_step.get('kernelgen_segment') == planned > 0,
                'generated segments: %s launches per step, %d planned'
                % (per_step.get('kernelgen_segment'), planned))
        flash = profile_step(exe, main, feed, fetch, phase=phase)
        # the step's flash forward, dQ and dK/dV run on the tensor-core
        # designs of its dtype only: 18 launches each, none of the
        # CUDA-core kernels
        want = TRAIN_FLASH[amp]
        got = {k: c for k, (_, c) in flash.items()}
        require(got == want, 'flash kernels in the profiled step: %s, '
                'expected %s' % (got, want))
        graph_modes(phase, smi, exe, main, feed, fetch, tokens, want)
        bitwise_paths(phase, exe, main, scope, feed, fetch)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


def phase_train_gpu_vs_cpu():
    """Two float32 training steps of the full-width transformer, cut to 2
    layers, B=4, T=256, from the same weights on the card and on the CPU."""
    _gpu_vs_cpu('train_gpu_vs_cpu', dict(BENCH_CFG, n_layer=2))


def _gpu_vs_cpu(phase, cfg):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup, out = _train_program(fluid, tr, amp=False, **cfg)
    feed = tr.synthetic_batch(np.random.RandomState(1), 4, 256, 32000)
    feed['trg_pad'][1, 200:] = 1.0    # ragged rows: k_len < T
    feed['src_pad'][2, 150:] = 1.0
    gpu, cpu = fluid.Scope(), fluid.Scope()
    gexe, cexe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(gpu):
        gexe.run(startup)
    fluid.scope_from_numpy({n: t.cpu().numpy() for n, t in gpu.vars.items()},
                           cpu, 'cpu')
    watch = ['src_emb', 'enc_0_att_qkv_w', 'dec_1_xatt_kv_w',
             'dec_post_ln_w', 'proj_w', 'proj_b']
    res = {}
    for name, scope, exe in (('gpu', gpu, gexe), ('cpu', cpu, cexe)):
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=feed,
                                    fetch_list=[out['loss']])[0][0])
                      for _ in range(2)]
        res[name] = (losses, {w: scope.vars[w].cpu().numpy()
                              for w in watch},
                     time.perf_counter() - t0)
    # losses: float32 sums in other orders on the two devices (~1e-7
    # relative through 2 layers).  Parameters: an Adam update is at most
    # about the scheduled lr in size (the bias correction makes the first
    # exactly lr * sign(g), the second at most 1.002 lr), so an entry
    # whose gradient is float noise may move the other way on the other
    # device: allow 2.01 * sum(lr) plus 1e-6 relative.
    lrs = [2.0 * 512 ** -0.5 * min(t ** -0.5, t * 8000 ** -1.5)
           for t in (1, 2)]
    p_atol = 2.01 * sum(lrs)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(res['gpu'][0], res['cpu'][0]))
    p_err = {w: float(np.abs(res['gpu'][1][w] - res['cpu'][1][w]).max())
             for w in watch}
    p_ok = all(np.allclose(res['gpu'][1][w], res['cpu'][1][w], rtol=1e-6,
                           atol=p_atol) for w in watch)
    emit(phase=phase, config='transformer-base width, 2 layers',
         use_flash=cfg['use_flash'], B=4, T=256, dtype='float32', tf32=False,
         gpu_losses=res['gpu'][0], cpu_losses=res['cpu'][0],
         loss_rel_err=loss_err, loss_rtol=1e-5, param_max_abs_err=p_err,
         param_atol=p_atol, param_rtol=1e-6, gpu_s=res['gpu'][2],
         cpu_s=res['cpu'][2])
    require(all(np.isfinite(res['gpu'][0])), 'non-finite GPU loss')
    require(loss_err <= 1e-5, 'gpu vs cpu: losses differ by %g' % loss_err)
    require(p_ok, 'gpu vs cpu: parameters differ after 2 steps: %s' % p_err)
    del gpu, cpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 7

# launches per step of the composed training path: 18 softmax rows (6
# encoder self, 6 decoder self, 6 cross attention), no flash kernel, 2
# gathers, 32 LayerNorms, one Adam call; the generated segments as planned
COMPOSED_LAUNCHES = {'softmax': 18, 'flash_attention_fwd': 0,
                     'flash_attention_bwd_dq': 0,
                     'flash_attention_bwd_dkv': 0, 'embedding_gather': 2,
                     'layer_norm': 32, 'adam_multi': 1}


class PlainCalls(object):
    """Counts calls of the kernels' plain versions with a CUDA tensor
    among their arguments, while installed."""
    TARGETS = (('paddle_tpu_torch.ops.nn', 'softmax_reference'),
               ('paddle_tpu_torch.ops.nn', 'layer_norm_reference'),
               ('paddle_tpu_torch.ops.fused', 'replay'),
               ('paddle_tpu_torch.ops.optimizer_ops', 'adam_reference'),
               ('paddle_tpu_torch.ops.optimizer_ops', 'momentum_reference'),
               ('paddle_tpu_torch.ops.optimizer_ops', 'optim_reference'),
               ('paddle_tpu_torch.ops.gather', 'embedding_gather_reference'),
               ('paddle_tpu_torch.ops.attention', '_ref_attention'),
               ('paddle_tpu_torch.ops.attention',
                'flash_backward_reference'))

    def __init__(self):
        self.counts = {}
        self._saved = []

    def __enter__(self):
        import importlib
        import torch

        def on_cuda(args):
            for a in args:
                if isinstance(a, (list, tuple)) and on_cuda(a):
                    return True
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    return True
            return False

        for mod_name, fn_name in self.TARGETS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, fn_name)

            def wrapper(*a, _real=real, _name=fn_name, **k):
                if on_cuda(list(a) + list(k.values())):
                    self.counts[_name] = self.counts.get(_name, 0) + 1
                return _real(*a, **k)
            self._saved.append((mod, fn_name, real))
            setattr(mod, fn_name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, real in self._saved:
            setattr(mod, fn_name, real)


def planned_segments(main, fetch_names):
    """Generated-segment launches one run of `main` makes, from the plans
    its fused ops used in their last run."""
    from paddle_tpu_torch.core import passes
    from paddle_tpu_torch.ops import kernelgen
    opt, _ = passes.maybe_optimize(main, fetch_names)
    n = 0
    for op in opt.global_block().ops:
        if op.type == 'fused_elementwise':
            n += kernelgen.plan_of(op.attrs).n_kernels
    return n


def phase_training_composed(smi):
    """transformer-base at its own defaults trained through the passes and
    the generated kernels on the card: AMP on, random init from a seed."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _train_program(fluid, tr, amp=True, **COMPOSED_CFG)
    B, T = 32, COMPOSED_CFG['max_len']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T,
                              COMPOSED_CFG['trg_vocab'])
    tokens = float(np.sum(1.0 - feed['trg_pad']))
    scope, exe = fluid.Scope(), fluid.Executor()
    fetch = [out['loss']]
    nvcc0, builds0 = kernelgen.build_stats['nvcc_s'], \
        kernelgen.build_stats['builds']
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # installed from the first run of main to the last: the
        # interpreted warm-up and the captures run Python, a replay none
        with PlainCalls() as plain:
            warm, warm_s = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                warm.append(float(exe.run(main, feed=feed,
                                          fetch_list=fetch)[0][0]))
                warm_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            kernels.reset_launches()
            kernelgen.launches.clear()
            losses, step_ms = [], []
            t_all = time.perf_counter()
            for _ in range(10):
                t0 = time.perf_counter()
                loss = exe.run(main, feed=feed, fetch_list=fetch)[0]
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss[0]))
            wall = time.perf_counter() - t_all
            launches = dict(kernels.launches)
            seg = dict(kernelgen.launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            per_step = {k: v / 10 for k, v in launches.items()}
            planned = planned_segments(main, [out['loss'].name])
            med = float(np.median(step_ms))
            emit(phase='training_composed', step='steps',
                 config='transformer-base defaults', cfg=COMPOSED_CFG,
                 amp=True,
                 pt_opt=os.environ.get('PT_OPT', '1'), B=B, T=T,
                 startup_s=startup_s, warmup_losses=warm,
                 warmup_step_s=warm_s,
                 losses=losses, step_ms=step_ms, median_step_ms=med,
                 wall_s=wall, tokens_per_step=tokens,
                 tokens_per_s=tokens * 10 / wall, peak_mem_gb=peak_gb,
                 launches_per_step=per_step,
                 planned_segments_per_step=planned,
                 segment_functions=len(seg),
                 segment_launches_per_step={k: v / 10
                                            for k, v in seg.items()},
                 plain_calls_on_cuda=plain.counts,
                 kernelgen_builds=kernelgen.build_stats['builds'] - builds0,
                 kernelgen_nvcc_s=kernelgen.build_stats['nvcc_s'] - nvcc0,
                 adam_table_builds=exe._kernel_cache.get(
                     'adam_multi_tables'),
                 card=smi)
            require(all(np.isfinite(losses + warm)),
                    'non-finite training loss')
            for k, n in COMPOSED_LAUNCHES.items():
                require(per_step.get(k) == n, '%s: %s launches per step, '
                        'expected %d' % (k, per_step.get(k), n))
            require(per_step['kernelgen_segment'] == planned > 0,
                    'generated segments: %s launches per step, %d planned'
                    % (per_step['kernelgen_segment'], planned))
            require(not plain.counts, 'plain versions ran on the card: %s'
                    % plain.counts)
            profile_step(exe, main, feed, fetch,
                         phase='training_composed')
            graph_modes('training_composed', smi, exe, main, feed, fetch,
                        tokens, {})
            bitwise_paths('training_composed', exe, main, scope, feed,
                          fetch)
        require(not plain.counts, 'plain versions ran on the card in '
                'the profile, graph_modes or bitwise_paths: %s'
                % plain.counts)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in seg.items()})
    return launches


def phase_train_composed_gpu_vs_cpu():
    """Two float32 steps of the composed transformer at full width, cut
    to 2 layers, B=4, dropout 0, from the same weights on the card and on
    the CPU (the CPU runs the fused groups' plain replay)."""
    _gpu_vs_cpu('train_composed_gpu_vs_cpu',
                dict(COMPOSED_CFG, dropout=0.0, n_layer=2))


def phase_composed_opt_on_off():
    """PT_OPT=1 (generated kernels) against PT_OPT=0 (one eager op at a
    time) on the card, dropout 0.1, from the same seed."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    cfg = dict(COMPOSED_CFG, n_layer=2)
    feed = tr.synthetic_batch(np.random.RandomState(2), 32, 256, 32000)
    watch = ['src_emb', 'enc_0_att_qkv_w', 'dec_1_xatt_kv_w',
             'dec_post_ln_w', 'proj_w', 'proj_b']
    res = {}
    saved = os.environ.get('PT_OPT')
    try:
        for opt in ('1', '0'):
            os.environ['PT_OPT'] = opt
            main, startup, out = _train_program(fluid, tr, amp=True, **cfg)
            scope, exe = fluid.Scope(), fluid.Executor()
            with fluid.scope_guard(scope):
                exe.run(startup)
                init = {w: scope.vars[w].clone() for w in watch}
                losses = [float(exe.run(main, feed=feed,
                                        fetch_list=[out['loss']])[0][0])
                          for _ in range(3)]
            res[opt] = (losses, init, {w: scope.vars[w].clone()
                                       for w in watch})
            del scope, exe
    finally:
        if saved is None:
            os.environ.pop('PT_OPT', None)
        else:
            os.environ['PT_OPT'] = saved
    on, off = res['1'], res['0']
    rel = max(abs(a - b) / abs(b) for a, b in zip(on[0], off[0]))
    same_init = all(torch.equal(on[1][w], off[1][w]) for w in watch)
    bitwise = on[0] == off[0] and all(torch.equal(on[2][w], off[2][w])
                                      for w in watch)
    emit(phase='composed_opt_on_off', cfg=cfg, amp=True, B=32, T=256,
         losses_opt_on=on[0], losses_opt_off=off[0], loss_rel_err=rel,
         loss_rtol=1e-6, startup_equal=same_init, bitwise=bitwise)
    require(all(np.isfinite(on[0])), 'non-finite loss with the passes on')
    require(rel <= 1e-6, 'PT_OPT=1 vs 0: losses differ by %g' % rel)
    torch.cuda.empty_cache()


def phase_nan_trip(smi):
    """check_nan on the card through the graph: transformer-base at full
    width cut to 2 layers, composed attention (the pads reach only the
    loss weights and the additive masks), B=4, T=256, float32; after
    three clean steps (warm-up, capture, replay) one NaN in a target pad
    entry.  nan_poll=1 must raise naming the loss at that step; nan_poll=8
    must raise with nan_window_steps=8 at the poll."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    main, startup, out = _train_program(
        fluid, tr, amp=False, **dict(COMPOSED_CFG, dropout=0.0, n_layer=2))
    feed = tr.synthetic_batch(np.random.RandomState(3), 4, 256, 32000)
    bad = dict(feed, trg_pad=feed['trg_pad'].copy())
    bad['trg_pad'][0, -1] = np.nan
    fetch = [out['loss']]
    res = {}
    for poll in (1, 8):
        scope, exe = fluid.Scope(), fluid.Executor(check_nan=True,
                                                   nan_poll=poll)
        with fluid.scope_guard(scope):
            exe.run(startup)
            exe.poll_nan()
            clean = [float(exe.run(main, feed=feed, fetch_list=fetch)[0][0])
                     for _ in range(3)]
            err, bad_steps = None, 0
            try:
                for _ in range(poll):
                    bad_steps += 1
                    exe.run(main, feed=bad, fetch_list=fetch)
            except RuntimeError as e:
                err = e
        captured = sum(e.graph is not None
                       for e in exe._graphs.entries.values())
        res[poll] = dict(clean_losses=clean, bad_steps=bad_steps,
                         raised=err is not None,
                         names_loss=out['loss'].name in str(err),
                         message=str(err)[:300] if err else None,
                         nan_window_steps=getattr(err, 'nan_window_steps',
                                                  None),
                         graphs_captured=captured)
        del scope, exe
    emit(phase='nan_trip', config='transformer-base width, 2 layers, '
         'composed, float32', B=4, T=256, by_nan_poll=res, card=smi)
    one, eight = res[1], res[8]
    require(all(np.isfinite(one['clean_losses'] + eight['clean_losses'])),
            'non-finite loss before the poisoned feed')
    require(one['raised'] and one['bad_steps'] == 1 and
            one['message'].startswith('check_nan') and one['names_loss'],
            'nan_poll=1: no raise naming %s at the poisoned step: %s'
            % (out['loss'].name, one))
    require(eight['raised'] and eight['bad_steps'] == 5 and
            eight['nan_window_steps'] == 8,
            'nan_poll=8: no raise with a window of 8: %s' % eight)
    require(one['graphs_captured'] >= 1 and eight['graphs_captured'] >= 1,
            'the check ran without a captured graph')
    torch.cuda.empty_cache()


# ------------------------------------------------------ training llama

LLAMA_B = 2
# the flash kernels of one llama_1b step (16 layers, D = 128), by design
LLAMA_FLASH = {
    'float32': {'fwd_tf32x3': 16, 'bwd_dq_tf32x3': 16,
                'bwd_dkv_tf32x3': 16},
    'bfloat16': {'fwd_wgmma': 16, 'bwd_dq_wgmma': 16, 'bwd_dkv_wgmma': 16}}
LLAMA_STEPS = 16   # steps on one repeated batch in training_llama


def _llama_program(fluid, llama, config='llama_1b', dtype='float32',
                   grad_clip=1.0, **overrides):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = llama.build(config, dtype=dtype, grad_clip=grad_clip,
                          **overrides)
    return main, startup, out


def _llama_batch(llama, B, T, V, seed=SEED):
    """B rows of T + 1 random token ids packed by make_batch."""
    rng = np.random.RandomState(seed)
    return llama.make_batch([rng.randint(1, V, T + 1) for _ in range(B)], T)


def _llama_flops(cfg, B, T):
    """Model FLOPs of one training step: 6 per matrix-product weight per
    token, and attention's 4 D per valid (query, key) pair forward, 14 D
    backward (dQ 6 D, dK/dV 8 D), causal."""
    d, L, V = cfg['d_model'], cfg['n_layer'], cfg['vocab']
    H, Hkv, F = cfg['n_head'], cfg['n_kv_head'], cfg['d_ffn']
    dh = d // H
    mm = L * (d * d * 2 + 2 * d * Hkv * dh + 3 * d * F) + d * V
    pairs = B * H * T * (T + 1) // 2
    return 6.0 * mm * B * T + L * 18.0 * dh * pairs


def phase_training_llama(smi):
    """llama_1b at full width and depth (float32, global-norm clip 1.0,
    Adam) trained through the port's entry points on the card: the
    interpreter, the CUDA graph and run_steps(8) on one repeated batch;
    profiles of an interpreted step and of two graph steps; the device
    kernels a step with the clip on and off."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _llama_program(fluid, llama)
    cfg = out['config']
    B, T = LLAMA_B, cfg['max_len']
    feed = _llama_batch(llama, B, T, cfg['vocab'])
    tokens = float(feed['loss_mask'].sum())
    params = main.all_parameters()
    flops = _llama_flops(cfg, B, T)
    fetch = [out['loss']]
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with PlainCalls() as plain:
            losses = []

            def step(**kw):
                t0 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=fetch,
                                            **kw)[0][0]))
                return (time.perf_counter() - t0) * 1e3
            first_ms = step()                  # the graph's warm-up
            eager_ms = [step(use_program_cache=False) for _ in range(2)]
            capture_ms = step()                # capture, then replay
            kernels.reset_launches()
            kernelgen.launches.clear()
            graph_ms = [step() for _ in range(3)]
            launches = {k: v / 3 for k, v in kernels.launches.items() if v}
            seg = {k: v / 3 for k, v in kernelgen.launches.items()}
            stacked = {k: np.stack([v] * K_STEPS) for k, v in feed.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = exe.run_steps(main, feed_list=stacked, steps=K_STEPS,
                               fetch_list=fetch)[0]
            run_steps_ms = (time.perf_counter() - t0) * 1e3 / K_STEPS
            losses.extend(float(v) for v in rs.reshape(-1))
            mem = _peak_memory()
            flash = profile_step(exe, main, feed, fetch,
                                 phase='training_llama')
            (wall, busy, flash_g, seen, groups), counted, tries = \
                _profiled_launches(lambda: [exe.run(main, feed=feed,
                                                    fetch_list=fetch)
                                            for _ in range(2)])
            _, busy_on, _, events_on, _ = _profiled(
                lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                use_program_cache=False))
        med = float(np.median(graph_ms))
        emit(phase='training_llama', step='steps', config='llama_1b',
             cfg=cfg, dtype='float32', grad_clip=1.0, B=B, T=T,
             params=sum(int(np.prod(p.shape)) for p in params),
             param_tensors=len(params), losses=losses,
             first_step_ms=first_ms, eager_step_ms=eager_ms,
             capture_step_ms=capture_ms, graph_step_ms=graph_ms,
             run_steps_step_ms=run_steps_ms, median_graph_step_ms=med,
             tokens_per_step=tokens, tokens_per_s=tokens / med * 1e3,
             run_steps_tokens_per_s=tokens / run_steps_ms * 1e3,
             model_tflop_per_step=flops / 1e12,
             model_tflops=flops / med / 1e9, launches_per_step=launches,
             segment_launches_per_step=sum(seg.values()),
             plain_calls_on_cuda=plain.counts, card=smi, **mem)
        emit(phase='training_llama', step='graph_profile', steps=2,
             profiled_wall_ms=wall, device_busy_ms=busy,
             device_idle_share=(1 - busy / wall) if busy else None,
             flash_by_design=flash_g, device_events=seen,
             device_launches=groups, counted_device_launches=counted,
             profile_tries=tries)
        require(all(np.isfinite(losses)), 'non-finite llama loss')
        require(losses[7] < losses[0], 'the llama loss did not fall over 8 '
                'steps on one batch: %s' % losses[:8])
        require(not plain.counts, 'plain versions ran on the card: %s'
                % plain.counts)
        got = {k: c for k, (_, c) in flash.items()}
        require(got == LLAMA_FLASH['float32'], 'flash kernels in the '
                'profiled llama step: %s, expected %s'
                % (got, LLAMA_FLASH['float32']))
        got = {k: c for k, (_, c) in flash_g.items()}
        want = {k: 2 * v for k, v in LLAMA_FLASH['float32'].items()}
        require(got == want, 'flash kernels in two profiled graph steps: '
                '%s, expected %s' % (got, want))
        _seen_on_device('training_llama graph', groups, counted)
        for k in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                  'flash_attention_bwd_dkv'):
            require(launches.get(k) == 16, '%s: %s launches a step, expected '
                    '16' % (k, launches.get(k)))
        require(launches.get('adam_multi') == 1 and
                launches.get('embedding_gather') == 1,
                'Adam and K4 launches a step: %s' % launches)
    del scope, exe
    torch.cuda.empty_cache()
    # the same step with the clip off: the device kernels a step (its
    # device ms by group in the 'training_llama_clip_off' profile line)
    main0, startup0, out0 = _llama_program(fluid, llama, grad_clip=0)
    fetch0 = [out0['loss']]
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(startup0)
        exe.run(main0, feed=feed, fetch_list=fetch0, use_program_cache=False)
        kernels.reset_launches()
        _, busy_off, _, events_off, _ = _profiled(
            lambda: exe.run(main0, feed=feed, fetch_list=fetch0,
                            use_program_cache=False))
        off = {k: v for k, v in kernels.launches.items() if v}
        profile_step(exe, main0, feed, fetch0,
                     phase='training_llama_clip_off')
    emit(phase='training_llama', step='clip_on_off',
         device_events_a_step={'clip_on': events_on,
                               'clip_off': events_off},
         device_busy_ms={'clip_on': busy_on, 'clip_off': busy_off},
         launches_clip_off=off)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


def phase_training_llama_bf16(smi):
    """The same step from build(dtype='bfloat16'): the first step runs on
    bf16 parameters (the bf16 tensor-core flash kernels, Adam's bf16
    instance), and the JAX package's Adam returns float32 parameters and
    moments, so the later steps are float32 ones with bf16 beta powers
    (the bf16 instance again).  The bf16 step changes the scope's dtypes,
    so no CUDA graph can hold it: it is timed through the interpreter,
    three times from one saved state; the later steps through the graph."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out = _llama_program(fluid, llama, dtype='bfloat16')
    cfg = out['config']
    B, T = LLAMA_B, cfg['max_len']
    feed = _llama_batch(llama, B, T, cfg['vocab'])
    tokens = float(feed['loss_mask'].sum())
    fetch = [out['loss']]
    pnames = [p.name for p in main.all_parameters()]
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(startup)
        require(all(scope.vars[p].dtype == torch.bfloat16 for p in pnames),
                'the bf16 build made non-bf16 parameters')
        torch.cuda.reset_peak_memory_stats()
        with PlainCalls() as plain:
            exe.prepare(main, feed=feed, fetch_list=fetch)
            snap = {k: v.clone() for k, v in scope.vars.items()}

            def restore():
                scope.vars.clear()
                scope.vars.update({k: v.clone() for k, v in snap.items()})
            bf16_ms, first = [], []
            for _ in range(3):
                restore()
                kernels.reset_launches()
                kernelgen.launches.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first.append(float(exe.run(main, feed=feed, fetch_list=fetch,
                                           use_program_cache=False)[0][0]))
                bf16_ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: v for k, v in kernels.launches.items() if v}
            seg = dict(kernelgen.launches)

            def bf16_step():
                # from the saved bf16 state each time: a profile that drops
                # an event runs again (_profiled_launches)
                restore()
                exe.run(main, feed=feed, fetch_list=fetch,
                        use_program_cache=False)
            (wall, busy, flash, seen, groups), counted, tries = \
                _profiled_launches(bf16_step)
            dtypes = sorted({(n.split('_')[-2] if '_pow_' in n or
                              '_moment' in n else 'param',
                              str(scope.vars[n].dtype))
                             for n in scope.vars
                             if n.startswith(tuple(pnames))})
            del snap
            losses, later_ms = [first[-1]], []
            for _ in range(7):
                t0 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=fetch)[0][0]))
                later_ms.append((time.perf_counter() - t0) * 1e3)
            kernels.reset_launches()
            exe.run(main, feed=feed, fetch_list=fetch)
            later_launches = {k: v for k, v in kernels.launches.items() if v}
        mem = _peak_memory()
        med = float(np.median(bf16_ms))
        emit(phase='training_llama_bf16', step='steps', config='llama_1b',
             dtype='bfloat16', B=B, T=T, bf16_step_ms=bf16_ms,
             median_bf16_step_ms=med, tokens_per_s=tokens / med * 1e3,
             bf16_step_losses=first, losses=losses,
             later_step_ms=later_ms,
             later_graph_step_ms=float(np.median(later_ms[3:])),
             dtypes_after_step_1=dtypes, launches_bf16_step=launches,
             segment_launches_bf16_step=sum(seg.values()),
             launches_later_step=later_launches,
             plain_calls_on_cuda=plain.counts, card=smi, **mem)
        emit(phase='training_llama_bf16', step='profile',
             profiled_wall_ms=wall, device_busy_ms=busy,
             device_idle_share=(1 - busy / wall) if busy else None,
             flash_by_design=flash, device_events=seen,
             device_launches=groups, counted_device_launches=counted,
             profile_tries=tries)
        require(all(np.isfinite(losses + first)), 'non-finite bf16 loss')
        require(losses[-1] < losses[0], 'the bf16 build\'s loss did not '
                'fall over 8 steps: %s' % losses)
        require(dtypes == [('acc', 'torch.bfloat16'),
                           ('moment1', 'torch.float32'),
                           ('moment2', 'torch.float32'),
                           ('param', 'torch.float32')],
                'dtypes after the bf16 step: %s' % dtypes)
        require(not plain.counts, 'plain versions ran on the card: %s'
                % plain.counts)
        got = {k: c for k, (_, c) in flash.items()}
        require(got == LLAMA_FLASH['bfloat16'], 'flash kernels in the '
                'profiled bf16 step: %s, expected %s'
                % (got, LLAMA_FLASH['bfloat16']))
        _seen_on_device('training_llama_bf16', groups, counted)
        require(launches.get('adam_multi_bf16') == 1 and
                'adam_multi' not in launches,
                'Adam instances in the bf16 step: %s' % launches)
        require(later_launches.get('adam_multi_bf16') == 1,
                'Adam instances in a later step: %s' % later_launches)
    del scope, exe
    torch.cuda.empty_cache()
    launches.update(seg)
    return launches


# the GPT-J-width llama trained under bf16 AMP (training_llama_d256)
GPTJ_TRAIN_REDUCED = GPTJ_REDUCED + [
    'trained as the reference\'s models/llama.py::build makes it, under '
    'bf16 AMP (Program.set_amp(True)): Adam (beta2 0.95, lr 3e-4) behind '
    'clip by global norm 1.0, B 2 rows of 2048 tokens from make_batch, '
    'one repeated batch']
# the flash kernels of one step of it (4 layers, D = 256), under AMP and
# in float32: by design, and by instance (the profiler's names, template
# arguments kept)
GPTJ_FLASH = {
    'bfloat16': {'fwd_wgmma': 4, 'bwd_dq_wgmma': 4, 'bwd_dkv_wgmma': 4},
    'float32': {'fwd_tf32x3': 4, 'bwd_dq_tf32x3': 4, 'bwd_dkv_tf32x3': 4}}
GPTJ_INSTANCES = {
    'bfloat16': {'flash_fwd_wgmma_kernel<256, false, 8>': 4,
                 'flash_bwd_dq_wgmma_kernel<256, false>': 4,
                 'flash_bwd_dkv_wgmma_kernel<256, false>': 4},
    'float32': {'flash_fwd_tf32x3_kernel<256, false, 8>': 4,
                'flash_bwd_dq_tf32x3_kernel<256, false, 8>': 4,
                'flash_bwd_dkv_tf32x3_kernel<256, false, 8>': 4}}


def step_breakdown(fn, want=None, grouping=None):
    """torch.profiler over fn(): (host wall ms, device busy ms, {group:
    device ms}, {flash kernel (_kernel_key): launches}), the groups by
    `grouping` (default _group).  With `want` ({flash kernel: launches}) a
    trace whose flash kernels differ is taken again, up to PROFILE_TRIES
    times (the profiler drops events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        groups, flash = {}, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if e.self_device_time_total:
                g = (grouping or _group)(e.key)
                groups[g] = groups.get(g, 0.0) + \
                    e.self_device_time_total / 1e3
            if 'flash_' in e.key:
                k = _kernel_key(e.key)
                flash[k] = flash.get(k, 0) + e.count
        if want is None or flash == want:
            break
    return wall, sum(groups.values()), groups, flash


def phase_training_llama_d256(smi):
    """The llama at GPT-J-6B's widths (GPTJ_CFG: D = 256, 4 of 28
    layers, 1.49 B parameters) trained through the port's entry points
    under bf16 AMP, and then in float32 in a fresh scope: an interpreted
    step, the capture, 3 graph steps (2 in float32), profiles of two graph
    steps (device busy by group, idle share, the flash kernels by design
    and instance), peak memory, launches a step, no plain version on the
    card.  Every flash launch must be the tensor-core instance of width
    256, the backward's 4 dQ and 4 dK/dV a step included (in float32 the
    3xTF32 pair in clusters of two blocks).  -> {path: launches a
    step}."""
    import gc
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernelgen
    paths = {}
    for amp in (True, False):
        dtype = 'bfloat16' if amp else 'float32'
        path = 'training_llama_d256' + ('' if amp else '_f32')
        main, startup, out = _llama_program(fluid, llama, 'tiny',
                                            **GPTJ_CFG)
        main.set_amp(amp)
        cfg = out['config']
        B, T = LLAMA_B, cfg['max_len']
        feed = _llama_batch(llama, B, T, cfg['vocab'])
        tokens = float(feed['loss_mask'].sum())
        params = main.all_parameters()
        flops = _llama_flops(cfg, B, T)
        fetch = [out['loss']]
        n_graph = 3 if amp else 2
        scope, exe = fluid.Scope(), fluid.Executor()
        with fluid.scope_guard(scope):
            exe.run(startup)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with PlainCalls() as plain:
                losses = []

                def step():
                    t0 = time.perf_counter()
                    losses.append(float(exe.run(main, feed=feed,
                                                fetch_list=fetch)[0][0]))
                    return (time.perf_counter() - t0) * 1e3

                def two_steps():
                    for _ in range(2):
                        exe.run(main, feed=feed, fetch_list=fetch)
                first_ms = step()       # interpreted: builds the kernels
                capture_ms = step()     # capture, then replay
                kernels.reset_launches()
                kernelgen.launches.clear()
                graph_ms = [step() for _ in range(n_graph)]
                launches = {k: v / n_graph
                            for k, v in kernels.launches.items() if v}
                seg = {k: v / n_graph for k, v in kernelgen.launches.items()}
                mem = _peak_memory()
                (_, _, flash_g, seen, groups), counted, tries = \
                    _profiled_launches(two_steps)
                want = {k: 2 * v for k, v in GPTJ_INSTANCES[dtype].items()}
                wall, busy, by_group, flash_kernels = step_breakdown(
                    two_steps, want)
            med = float(np.median(graph_ms))
            emit(phase='training_llama_d256', step='steps',
                 config='gptj_6b_widths', cfg=cfg, reduced=GPTJ_TRAIN_REDUCED,
                 amp=amp, dtype=dtype, B=B, T=T,
                 params=sum(int(np.prod(p.shape)) for p in params),
                 losses=losses, first_step_ms=first_ms,
                 capture_step_ms=capture_ms, graph_step_ms=graph_ms,
                 median_graph_step_ms=med, tokens_per_step=tokens,
                 tokens_per_s=tokens / med * 1e3,
                 model_tflop_per_step=flops / 1e12,
                 model_tflops=flops / med / 1e9, launches_per_step=launches,
                 segment_launches_per_step=sum(seg.values()),
                 plain_calls_on_cuda=plain.counts, card=smi, **mem)
            emit(phase='training_llama_d256', step='graph_profile',
                 dtype=dtype, steps=2, profiled_wall_ms=wall,
                 device_busy_ms=busy,
                 device_idle_share=(1 - busy / wall) if busy else None,
                 device_ms_by_group=by_group, flash_by_design=flash_g,
                 flash_kernels=flash_kernels, device_events=seen,
                 device_launches=groups, counted_device_launches=counted,
                 profile_tries=tries)
            require(all(np.isfinite(losses)), 'non-finite %s loss: %s'
                    % (path, losses))
            require(not plain.counts, 'plain versions ran on the card: %s'
                    % plain.counts)
            for k in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                      'flash_attention_bwd_dkv'):
                require(launches.get(k) == cfg['n_layer'],
                        '%s: %s %s launches a step, expected one a layer'
                        % (path, launches.get(k), k))
            require(launches.get('adam_multi') == 1 and
                    launches.get('embedding_gather') == 1,
                    '%s: Adam and K4 launches a step: %s' % (path, launches))
            got = {k: c for k, (_, c) in flash_g.items()}
            want_design = {k: 2 * v for k, v in GPTJ_FLASH[dtype].items()}
            require(got == want_design, '%s: flash kernels in two profiled '
                    'graph steps: %s, expected %s' % (path, got, want_design))
            _seen_on_device(path + ' graph', groups, counted)
            require(flash_kernels == want, '%s: flash kernels by instance '
                    'in two graph steps: %s, expected %s'
                    % (path, flash_kernels, want))
        launches.update(seg)
        paths[path] = launches
        del scope, exe, main, startup, out
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def phase_train_llama_gpu_vs_cpu():
    """Two steps from the same weights on the card and on the CPU: the
    llama_1b widths cut to 2 layers (D = 128, GQA 16 / 8), B = 2, T = 256,
    float32; the tiny config (D = 16: the tensor-core forward and
    backward's padded instances of width 64 on the card) in float32 and
    from build(dtype='bfloat16'); and GPT-J-6B's widths (D = 256) cut to
    1 layer at T = 128 under bf16 AMP (gptj_amp: the instances of width
    256 on the card) and in float32 (gptj_f32: a further step on the
    card, profiled, must launch the width-256 3xTF32 dQ and dK/dV, the
    clusters of two blocks, and no CUDA-core kernel); the two GPT-J-width
    runs hold one step (their CPU steps took ~30 s each; cut from two for
    the time limit), the others two.  -> {path: launches a step on the
    card} for the runs but llama_1b_2l."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import llama
    paths = {}
    for name, config, over, dtype, amp in (
            ('llama_1b_2l', 'llama_1b', dict(n_layer=2, max_len=256),
             'float32', False),
            ('tiny_f32', 'tiny', {}, 'float32', False),
            ('tiny_bf16', 'tiny', {}, 'bfloat16', False),
            ('gptj_amp', 'tiny', dict(GPTJ_CFG, n_layer=1, max_len=128),
             'float32', True),
            ('gptj_f32', 'tiny', dict(GPTJ_CFG, n_layer=1, max_len=128),
             'float32', False)):
        main, startup, out = _llama_program(fluid, llama, config, dtype,
                                            **over)
        main.set_amp(amp)
        cfg = out['config']
        feed = _llama_batch(llama, LLAMA_B, cfg['max_len'], cfg['vocab'],
                            seed=SEED + 1)
        gnorm = next(op.output('Out')[0] for op in main.global_block().ops
                     if op.type == 'sqrt')
        watch = ['tok_emb', 'layer_0_att_q_w',
                 'layer_%d_ffn_fc2_w' % (cfg['n_layer'] - 1), 'final_norm',
                 'lm_proj_w']
        gpu, cpu = fluid.Scope(), fluid.Scope()
        gexe, cexe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(gpu):
            gexe.run(startup)
        fluid.scope_from_numpy({n: t.cpu() for n, t in gpu.vars.items()},
                               cpu, 'cpu')
        res = {}
        # one step where the CPU's take ~7-20 s each (for the time limit)
        steps = 1 if name.startswith('gptj') or name == 'llama_1b_2l' \
            else 2
        for dev, scope, exe in (('gpu', gpu, gexe), ('cpu', cpu, cexe)):
            t0 = time.perf_counter()
            if dev == 'gpu':
                kernels.reset_launches()
            with fluid.scope_guard(scope):
                runs = [exe.run(main, feed=feed,
                                fetch_list=[out['loss'], gnorm,
                                            out['logits']])
                        for _ in range(steps)]
            if dev == 'gpu':
                paths['train_llama_' + name] = {
                    k: v / steps for k, v in kernels.launches.items() if v}
            if dev == 'cpu':
                max_logit = float(np.abs(runs[0][2]).max())
            res[dev] = ([float(r[0][0]) for r in runs],
                        [float(r[1][0]) for r in runs],
                        {w: scope.vars[w].float().cpu().numpy()
                         for w in watch},
                        time.perf_counter() - t0)
        lr = 3e-4
        p_atol = 2.01 * steps * lr
        loss_err = [abs(a - b) / abs(b)
                    for a, b in zip(res['gpu'][0], res['cpu'][0])]
        norm_err = [abs(a - b) / abs(b)
                    for a, b in zip(res['gpu'][1], res['cpu'][1])]
        p_err = {w: float(np.abs(res['gpu'][2][w] - res['cpu'][2][w]).max())
                 for w in watch}
        p_ok = all(np.allclose(res['gpu'][2][w], res['cpu'][2][w],
                               rtol=1e-6, atol=p_atol) for w in watch)
        row = dict(phase='train_llama_gpu_vs_cpu', config=name, cfg=cfg,
                   dtype=dtype, amp=amp, B=LLAMA_B, T=cfg['max_len'],
                   gpu_losses=res['gpu'][0], cpu_losses=res['cpu'][0],
                   loss_rel_err=loss_err, gpu_global_norm=res['gpu'][1],
                   cpu_global_norm=res['cpu'][1], global_norm_rel_err=norm_err,
                   param_max_abs_err=p_err, param_atol=p_atol,
                   param_rtol=1e-6, gpu_s=res['gpu'][3], cpu_s=res['cpu'][3],
                   launches_per_step=paths.get('train_llama_' + name))
        if dtype == 'float32' and not amp:
            # float32 sums in other orders (~1e-7 relative through the
            # layers); an Adam step moves an entry by at most ~lr, and
            # an entry whose gradient is float noise may move the other
            # way on the other device: 2.01 x the summed lr
            row.update(loss_rtol=1e-5, global_norm_rtol=1e-5)
            ok = max(loss_err) <= 1e-5 and max(norm_err) <= 1e-5 and p_ok
        else:
            # the first step on bf16 parameters, or under AMP (bf16
            # inputs to mul, matmul and the flash attention: every bf16
            # rounding of that step is one the bf16 build also makes, so
            # its R bounds it; both steps are AMP steps, from parameters
            # that differ by at most the first step's 2.01 lr on entries
            # whose gradients are noise).  Two packages that round
            # each operation to bf16 (u = 2^-8) from float32 values
            # differing in the last bits give logits 4 sqrt(2 R / 3) u
            # max|logit| apart, R = 12 L + 2 roundings
            # (tests/test_torch_llama_train.py derives it), gradients
            # 4 sqrt(4 R / 3) u.  Here one program runs on two devices:
            # an operation's float32 values differ only by summation
            # order, delta = 2^-24 sqrt(K) relative for sums of K terms
            # (K the longest: d_model, d_ffn, T or the vocabulary), and
            # their bf16 roundings differ, by one unit, only for the
            # share f = delta / u of values that lie within delta of a
            # rounding boundary.  One-unit differences in a share f have
            # sqrt(f) times the spread of independent roundings: the
            # loss within sqrt(f) 2 x 4 sqrt(2 R / 3) u max|logit|, the
            # first step's global norm within sqrt(f) 4 sqrt(4 R / 3) u
            R = 12 * cfg['n_layer'] + 2
            K = max(cfg['d_model'], cfg['d_ffn'], cfg['max_len'],
                    cfg['vocab'])
            shrink = np.sqrt(min(1.0, 2.0 ** -24 * np.sqrt(K) / 2.0 ** -8))
            loss_tol = shrink * 2 * 4 * np.sqrt(2 * R / 3.0) * 2.0 ** -8 * \
                max_logit
            norm_rtol = shrink * 4 * np.sqrt(4 * R / 3.0) * 2.0 ** -8
            abs_err = [abs(a - b) for a, b in zip(res['gpu'][0],
                                                  res['cpu'][0])]
            row.update(loss_atol=loss_tol, global_norm_rtol=norm_rtol,
                       loss_abs_err=abs_err)
            ok = max(abs_err) <= loss_tol and norm_err[0] <= norm_rtol and p_ok
        if name == 'gptj_f32':
            # the kernels of a further step on the card, after the
            # compared one: the float32 flash at width 256, all on tensor
            # cores
            want = {k: 1 for k in GPTJ_INSTANCES['float32']}
            with fluid.scope_guard(gpu):
                flash = step_breakdown(lambda: gexe.run(
                    main, feed=feed, fetch_list=[out['loss']]), want)[3]
            row['profiled_flash_kernels'] = flash
            ok = ok and flash == want
        emit(**row)
        require(all(np.isfinite(res['gpu'][0])), 'non-finite GPU loss')
        require(ok, 'gpu vs cpu (%s): %s' % (name, row))
        del gpu, cpu, gexe, cexe
        torch.cuda.empty_cache()
    require(paths['train_llama_tiny_f32'].get('flash_attention_fwd') == 2,
            'the tiny llama did not run the flash kernels on the card: %s'
            % paths)
    for name in ('train_llama_gptj_amp', 'train_llama_gptj_f32'):
        require(paths[name].get('flash_attention_bwd_dkv') == 1,
                'the GPT-J-width llama did not run the flash backward on '
                'the card (%s): %s' % (name, paths))
    return paths


# ------------------------------------------------------- ResNet-50 (AMP)

# the reference's ResNet-50 training step (paddle_tpu/models/resnet.py
# bench_program, bench.py:91 bench_resnet50): B 128, 224 x 224, 1000
# classes, depth 50, bf16 AMP, Momentum lr 0.1 mu 0.9
RESNET_CFG = dict(B=128, side=224, classes=1000, depth=50)
RESNET_GRAPH_STEPS = 10


def _resnet_group(name):
    """A profiler key's group in a ResNet step: the convolutions and the
    fc GEMM (cuDNN, cuBLAS, their layout transposes), the float32
    elementwise and reduction kernels (batch_norm's torch ops forward and
    backward, and the loss's), the bf16 ones (the unfused relus, pooling,
    residual adds in the backward), the casts, the feed's upload, and the
    port's own kernels (_group)."""
    low = name.lower()
    own = _group(name)
    if own in KERNEL_GROUPS:
        return own
    if 'memcpy htod' in low:
        return 'feed_upload'
    if 'copy_kernel' in low:
        return 'casts_and_copies'
    if any(t in low for t in ('xmma', 'cudnn', 'cask', 'cutlass', 'nvjet',
                              'gemm', 'nchwtonhwc', 'nhwctonchw')):
        return 'conv_and_gemm'
    if 'bfloat16' in low:
        return 'bf16_elementwise_and_pooling'
    if 'elementwise' in low or 'reduce_kernel' in low:
        return 'float32_elementwise_and_reductions'
    return 'other'


def _conv_fc_flops(main, B):
    """Model FLOPs of one forward: 2 multiply-adds a weight a conv output
    position, and the fc's, from the program's shapes."""
    block = main.global_block()
    flops = 0
    for op in block.ops:
        if op.type == 'conv2d':
            out = block.var(op.output('Output')[0]).shape
            w = block.var(op.input('Filter')[0]).shape
            flops += 2 * B * int(np.prod(out[1:])) * int(np.prod(w[1:]))
        elif op.type == 'mul':
            x = block.var(op.input('X')[0]).shape
            w = block.var(op.input('Y')[0]).shape
            flops += 2 * B * int(np.prod(x[1:])) * int(w[1])
    return flops


# --------------------------------- SE-ResNeXt-50, VGG-16 and the MNIST CNN

# the configurations BASELINE.json names besides ResNet-50: the reference's
# SE-ResNeXt-50 (models/se_resnext.py: cardinality 32, reduction 16;
# Momentum 0.9 on piecewise_decay, L2Decay 1e-4, dropout 0.5) and VGG-16
# with batch norm and dropout (models/vgg.py, Adam 1e-3), both at 224 x 224
# with 1000 classes under bf16 AMP, and the MNIST CNN (models/mnist.py,
# Adam 1e-3, float32), each uncut, with a synthetic feed from SEED
CONV_CFGS = {
    'se_resnext50': dict(module='se_resnext', B=128, amp=True,
                         kw=dict(data_shape=(3, 224, 224), class_dim=1000,
                                 depth=50),
                         optimizer='Momentum(mu=0.9) on piecewise_decay('
                         '[1000, 2000], [0.1, 0.01, 0.001]), L2Decay(1e-4)'),
    'vgg16': dict(module='vgg', B=64, amp=True,
                  kw=dict(data_shape=(3, 224, 224), class_dim=1000),
                  optimizer='Adam(lr=1e-3)'),
    'mnist': dict(module='mnist', B=128, amp=False, kw={},
                  optimizer='Adam(lr=1e-3)'),
}
CONV_GRAPH_STEPS = 10


def _no_dropout(main):
    """Every dropout of `main` at dropout_prob 0 (the masks cannot differ
    between two devices)."""
    for op in main.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    main._bump()


def conv_program(name, B=None, seed=SEED, dropout=True, **overrides):
    """One of CONV_CFGS built through the port's models: (main, startup,
    out, feed, amp) with AMP set as the config says and a synthetic feed
    of B rows from `seed`."""
    import importlib
    import paddle_tpu_torch as fluid
    cfg = CONV_CFGS[name]
    mod = importlib.import_module('paddle_tpu_torch.models.' +
                                  cfg['module'])
    kw = dict(cfg['kw'], **overrides)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build(**kw)
    main.set_amp(cfg['amp'])
    if not dropout:
        _no_dropout(main)
    shape = out['feeds'][0].shape[1:]
    classes = kw.get('class_dim', 10)
    rng = np.random.RandomState(seed)
    B = B or cfg['B']
    feed = {out['feeds'][0].name: rng.rand(B, *shape).astype('float32'),
            'label': rng.randint(0, classes, (B, 1)).astype('int64')}
    return main, startup, out, feed, cfg['amp']


def _conv_step_phase(phase, config, main, startup, out, feed, amp, smi,
                     profile=True, per_s='images_per_s'):
    """Train `main` through the port's entry points: Executor.run through
    the PT_OPT rewriter, an interpreted first step, the capture,
    CONV_GRAPH_STEPS graph steps (images/s, step ms median and range,
    model FLOP/s from the conv and fc FLOPs x 3, losses finite), peak
    memory, launches a step on the wrappers, no plain version on the
    card; with `profile` a profile of two graph steps by group (device
    busy, idle share) and the launches on the profiler; `per_s` names the
    rows a second (images, or examples for the CTR models and word2vec).
    -> (launches a step, generated launches a step by function, profiled
    groups)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    B = next(iter(feed.values())).shape[0]
    params = [p for p in main.all_parameters() if p.trainable]
    flops = 3 * _conv_fc_flops(main, B)
    fetch = [out['loss']]
    scope, exe = fluid.Scope(), fluid.Executor()
    groups = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []

        def step():
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=fetch)[0][0]))
            return (time.perf_counter() - t0) * 1e3

        def two_steps():
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=fetch)
        with PlainCalls() as plain:
            first_ms = step()       # interpreted: builds the kernels
            capture_ms = step()     # capture, then replay
            kernels.reset_launches()
            kernelgen.launches.clear()
            graph_ms = [step() for _ in range(CONV_GRAPH_STEPS)]
            launches = {k: v / CONV_GRAPH_STEPS
                        for k, v in kernels.launches.items() if v}
            seg = {k: v / CONV_GRAPH_STEPS
                   for k, v in kernelgen.launches.items()}
            mem = _peak_memory()
            if profile:
                (_, _, _, seen, groups), counted, tries = \
                    _profiled_launches(two_steps)
                wall, busy, by_group, _ = step_breakdown(
                    two_steps, grouping=_resnet_group)
    med = float(np.median(graph_ms))
    emit(phase=phase, step='steps', config=config, B=B, amp=amp,
         feed_shape=list(next(iter(feed.values())).shape),
         trainable_tensors=len(params),
         params=sum(int(np.prod(p.shape)) for p in params),
         losses=losses, first_step_ms=first_ms, capture_step_ms=capture_ms,
         graph_step_ms=graph_ms, median_graph_step_ms=med,
         min_graph_step_ms=min(graph_ms), max_graph_step_ms=max(graph_ms),
         model_tflop_per_step=flops / 1e12, **{per_s: B / med * 1e3},
         model_tflops=flops / med / 1e9, launches_per_step=launches,
         segment_launches_per_step=sum(seg.values()),
         plain_calls_on_cuda=plain.counts, card=smi, **mem)
    if profile:
        emit(phase=phase, step='graph_profile', steps=2,
             profiled_wall_ms=wall, device_busy_ms=busy,
             device_idle_share=(1 - busy / wall) if busy else None,
             device_ms_by_group=by_group,
             device_share_by_group={k: v / busy for k, v in by_group.items()},
             device_events=seen, device_launches=groups,
             counted_device_launches=counted, profile_tries=tries, card=smi)
        _seen_on_device(phase + ' graph', groups, counted)
    require(all(np.isfinite(losses)), 'non-finite %s loss: %s'
            % (config, losses))
    require(not plain.counts, 'plain versions ran on the card: %s'
            % plain.counts)
    return launches, seg, groups


def phase_training_resnet50(smi):
    """ResNet-50 at the reference's bench shape trained through the
    port's entry points: models/resnet.py::bench_program, then
    _conv_step_phase (one momentum_multi, one K5 and the generated
    segments a step, on the wrappers and on the profiler).  -> launches
    a step."""
    from paddle_tpu_torch.models import resnet
    main, startup, out, feed = resnet.bench_program(**RESNET_CFG)
    params = [p for p in main.all_parameters() if p.trainable]
    require(len(params) == 161, 'ResNet-50 has %d trainable tensors, '
            'expected 161' % len(params))
    emit(phase='training_resnet50', step='config', config='resnet50',
         cfg=RESNET_CFG, optimizer='Momentum(lr=0.1, mu=0.9)')
    launches, seg, groups = _conv_step_phase(
        'training_resnet50', 'resnet50', main, startup, out, feed, True, smi)
    require(launches.get('momentum_multi') == 1 and
            launches.get('softmax') == 1 and
            launches.get('kernelgen_segment', 0) >= 1,
            'ResNet-50: launches a step %s, expected one momentum_multi, '
            'one K5 and the generated segments' % launches)
    require(groups.get('momentum_multi') == 2, 'ResNet-50: %s momentum '
            'kernels on the profiler in two graph steps, expected 2'
            % groups.get('momentum_multi'))
    launches.update(seg)
    return launches


def _conv_phase(phase, name, smi, want, profile=True, check=None):
    """A CONV_CFGS model at its configuration through _conv_step_phase;
    `want`: {kernel: launches a step}, each required on the wrappers (and
    twice on the two profiled steps); `check(main, out, feed, seg)` adds the
    model's own checks.  -> launches a step, the generated functions'
    included."""
    main, startup, out, feed, amp = conv_program(name)
    emit(phase=phase, step='config', config=name, cfg={
        k: v for k, v in CONV_CFGS[name].items() if k != 'module'})
    launches, seg, groups = _conv_step_phase(phase, name, main, startup,
                                             out, feed, amp, smi, profile)
    for k, n in want.items():
        require(launches.get(k) == n, '%s: %s launches a step of %s, '
                'expected %s (%s)' % (name, launches.get(k), k, n,
                                      launches))
        # each launch is DEVICE_KERNELS kernels on the profiler
        dev = 2 * n * DEVICE_KERNELS.get(k, 1)
        if profile:
            require(groups.get(k) == dev, '%s: %s %s kernels on the '
                    'profiler in two graph steps, expected %d'
                    % (name, groups.get(k), k, dev))
    require(launches.get('kernelgen_segment', 0) >= 1, '%s: no generated '
            'segment ran (%s)' % (name, launches))
    if check:
        check(main, out, feed, seg)
    launches.update(seg)
    return launches


def _se_block_segments(main, out, feed, seg):
    """The SE block's generated segments ran: its gate's bias add +
    sigmoid, its scale, residual add and relu (the mul(axis=0) -> add ->
    relu of every block with an identity shortcut), and the piecewise
    schedule's comparisons (bool in registers, cast to float)."""
    specs = _planned_specs(main, feed, [out['loss'].name], True)
    ran = {ops for name, (_, ops) in specs.items() if seg.get(name)}
    emit(phase='training_se_resnext50', step='segments',
         functions=len(specs), launched=sorted(
             o if len(o) < 100 else '%s... (%d ops)' % (o[:80], o.count('+')
                                                       + 1) for o in ran))
    for want in ('sigmoid', 'elementwise_mul+elementwise_add+relu',
                 'less_than+cast'):
        require(any(want in ops for ops in ran), 'SE-ResNeXt-50: no '
                'launched segment holds %s (%s)' % (want, sorted(ran)))


def phase_training_se_resnext50(smi):
    """SE-ResNeXt-50 as the reference's models/se_resnext.py::build makes
    it (224 x 224, 1000 classes, cardinality 32, reduction 16), B 128,
    bf16 AMP, Momentum 0.9 on the piecewise schedule with L2Decay, dropout
    0.5 in training: one momentum_multi and one K5 a step, and the SE
    block's and the schedule's generated segments."""
    return _conv_phase('training_se_resnext50', 'se_resnext50', smi,
                       {'momentum_multi': 1, 'softmax': 1},
                       check=_se_block_segments)


def phase_training_vgg16(smi):
    """VGG-16 with batch norm and dropout (models/vgg.py::build at 224 x
    224, 1000 classes), B 64, bf16 AMP, Adam 1e-3: one adam_multi and one
    K5 a step and the generated segments."""
    return _conv_phase('training_vgg16', 'vgg16', smi,
                       {'adam_multi': 1, 'softmax': 1})


def phase_training_mnist(smi):
    """The MNIST CNN (models/mnist.py::build), B 128, float32, Adam: step
    ms and images/s (no profile: its step is small)."""
    return _conv_phase('training_mnist', 'mnist', smi,
                       {'adam_multi': 1, 'softmax': 1}, profile=False)


# the plain formulas of the schedules (layers/learning_rate_scheduler.py,
# in float64) at decay step k, and how each is built
def _lr_formulas():
    import math as m

    def pw(k, b=(3, 6), v=(0.1, 0.01, 0.001)):
        return next((v[i] for i, bi in enumerate(b) if k < bi), v[-1])

    def poly(k, lr, ds, end, power, cycle):
        if cycle:
            dsv = ds * max(m.ceil(k / ds), 1)
        else:
            k, dsv = min(k, ds), ds
        return (lr - end) * (1 - k / dsv) ** power + end
    return {
        'piecewise_decay': (lambda L: L.piecewise_decay(
            [3, 6], [0.1, 0.01, 0.001]), pw),
        'exponential_decay': (lambda L: L.exponential_decay(
            0.1, 2, 0.5, staircase=True),
            lambda k: 0.1 * 0.5 ** m.floor(k / 2)),
        'natural_exp_decay': (lambda L: L.natural_exp_decay(0.1, 3, 0.4),
                              lambda k: 0.1 * m.exp(-0.4 * k / 3)),
        'inverse_time_decay': (lambda L: L.inverse_time_decay(0.1, 2, 0.5),
                               lambda k: 0.1 / (1 + 0.5 * k / 2)),
        'polynomial_decay': (lambda L: L.polynomial_decay(
            0.1, 4, 0.001, power=2.0),
            lambda k: poly(k, 0.1, 4, 0.001, 2.0, False)),
        'polynomial_decay_cycle': (lambda L: L.polynomial_decay(
            0.1, 2, 0.001, power=1.0, cycle=True),
            lambda k: poly(k, 0.1, 2, 0.001, 1.0, True)),
        'cosine_decay': (lambda L: L.cosine_decay(0.1, 2, 8),
                         lambda k: 0.1 * 0.5 * (m.cos(m.floor(k / 2) *
                                                      m.pi / 8) + 1)),
        'linear_lr_warmup': (lambda L: L.linear_lr_warmup(0.1, 2, 0.01,
                                                          0.05),
                             lambda k: 0.01 + 0.04 * k / 2 if k < 2
                             else 0.1),
        'noam_decay': (lambda L: L.noam_decay(64, 2),
                       lambda k: 64 ** -0.5 * min((k + 1) ** -0.5,
                                                  2 ** -1.5 * (k + 1))),
    }


def _schedule_program(fluid, make_lr):
    """A small float32 fc trained by Momentum 0.9 on the schedule
    `make_lr(layers)` -> (main, startup, loss, lr)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[16], dtype='float32')
        h = fluid.layers.fc(x, 32, act='relu')
        loss = fluid.layers.mean(fluid.layers.fc(h, 8))
        lr = make_lr(fluid.layers)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss, lr


SCHEDULE_RUNS = 11    # an interpreted run, the capture, 9 graph replays
LR_RTOL = 2e-6        # the schedule's float32 ops against float64


def schedules_under_graphs():
    """Each schedule computed inside the captured CUDA graph: the
    piecewise one over SCHEDULE_RUNS runs (boundaries 3 and 6 crossed by
    graph replays), its learning rate fetched each run equal to the plain
    formula (LR_RTOL), and the parameters after the last run equal to the
    CPU's after the same runs (relative L2 within 1e-5: float32 in both,
    the rate the same); every other schedule over three runs (the third a
    replay) against its formula.  -> {schedule: max relative error}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    rng = np.random.RandomState(SEED)
    feed = {'x': rng.randn(8, 16).astype('float32')}
    errs, progs = {}, {}
    for name, (make, _) in _lr_formulas().items():
        progs[name] = _schedule_program(fluid, make)
        # one nvcc call for every schedule program's segments, its
        # startup's too
        _planned_specs(progs[name][0], feed, [progs[name][3].name], False)
        _planned_specs(progs[name][1], {}, [], False)
    kernelgen.ensure_built()
    for name, (_, formula) in _lr_formulas().items():
        runs = SCHEDULE_RUNS if name == 'piecewise_decay' else 3
        main, startup, loss, lr = progs[name]
        states, init = {}, None
        for dev in ('gpu', 'cpu')[:2 if name == 'piecewise_decay' else 1]:
            if dev == 'gpu':
                scope, exe = fluid.Scope(), fluid.Executor()
                with fluid.scope_guard(scope):
                    exe.run(startup)
                init = {n: t.cpu().numpy() for n, t in scope.vars.items()}
            else:
                scope = fluid.scope_from_numpy(init, fluid.Scope(), 'cpu')
                exe = fluid.Executor(fluid.CPUPlace())
            kernels.reset_launches()
            with fluid.scope_guard(scope):
                got = [float(exe.run(main, feed=feed, fetch_list=[lr])[0][0])
                       for _ in range(runs)]
            states[dev] = {n: t.float().cpu().numpy()
                           for n, t in scope.vars.items()}
            want = [formula(k) for k in range(runs)]
            err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
            errs['%s_%s' % (name, dev)] = err
            emit(phase='train_conv_gpu_vs_cpu', step='schedule',
                 schedule=name, device=dev, runs=runs, lr=got, formula=want,
                 max_rel_err=err, rtol=LR_RTOL,
                 momentum_launches=kernels.launches.get('momentum_multi'))
            require(err <= LR_RTOL, 'schedule %s on the %s: %s against %s'
                    % (name, dev, got, want))
        if name == 'piecewise_decay':
            params = sorted(p.name for p in main.all_parameters())
            d = _rel([states['gpu'][n] for n in params],
                     [states['cpu'][n] for n in params])
            errs['piecewise_params_gpu_vs_cpu'] = d
            require(d <= 1e-5, 'piecewise schedule: parameters after %d '
                    'runs %.3g apart on the card and the CPU' % (runs, d))
    return errs


# the conv models card vs CPU: (run name, CONV_CFGS name, build overrides,
# B, whole runs held)
CONV_SMALL = (
    ('mnist', 'mnist', {}, 8, True),
    ('vgg16_32', 'vgg16', dict(data_shape=(3, 32, 32), class_dim=10), 8,
     False),
    ('se_resnext50_64', 'se_resnext50',
     dict(data_shape=(3, 64, 64), class_dim=10), 8, False))
CONV_SMALL_STEPS = 3
CONV_KINDS = ('losses', 'params', 'moments', 'moving', 'pred')


def _conv_kinds(main, state):
    """A scope's tensors by kind: trainable parameters, the optimizer's
    moments or velocities, batch norm's moving statistics."""
    ps = main.all_parameters()
    return dict(
        params=[state[p.name] for p in ps if p.trainable],
        moments=[v for n, v in sorted(state.items())
                 if '_moment' in n or '_velocity_' in n],
        moving=[state[p.name] for p in ps if not p.trainable])


def phase_train_conv_gpu_vs_cpu():
    """The three conv models at sizes the CPU runs quickly (CONV_SMALL:
    MNIST at full size, VGG-16 at 32 x 32 with 10 classes, the
    reference's default build, SE-ResNeXt-50 at 64 x 64), every dropout
    at 0 in the built program, CONV_SMALL_STEPS steps (one where only
    the first step is held) in float32 and
    under bf16 AMP on the card and on the CPU from one scope, then the
    for_test clone's predictions; then schedules_under_graphs.

    Whole runs are held as train_resnet_gpu_vs_cpu holds ResNet-8, each
    kind a relative L2 distance d against the size of the bf16 effect,
    e_bf16 = d(CPU AMP, CPU float32): d(card AMP, CPU AMP) <= e_bf16,
    d(card AMP, card float32) within [1/2, 2] e_bf16, d(card float32, CPU
    float32) <= 2^-8 e_bf16.  VGG-16 at 32 x 32 (13 batch norms, the last
    over 8 rows at 1 x 1) and SE-ResNeXt-50 at 64 x 64 from random weights
    part beyond their first step in float32 already (card runs: VGG's
    third float32 losses 0.0723 and 0.0660), so they are held at their
    first step, as ResNet-50 is there: the float32 loss within 1e-4
    relative, the AMP loss within the larger of the two devices' own bf16
    effects on it, |AMP - float32| (both AMP runs round the same float32
    values; SE-ResNeXt-50 at B 4 parts further, so it runs at B 8); each
    runs that one step.  -> launches a step on the card, by run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    progs = {}
    for run, name, kw, B, _ in CONV_SMALL:
        for amp in (False, True):
            main, startup, out, feed, _ = conv_program(name, B=B,
                                                       dropout=False, **kw)
            main.set_amp(amp)
            test = main.clone(for_test=True)
            test.set_amp(amp)
            progs[run, amp] = (main, startup, out, feed, test)
            _planned_specs(main, feed, [out['loss'].name], amp)
            _planned_specs(test, feed, [out['predict'].name], amp)
            _planned_specs(startup, {}, [], False)
    kernelgen.ensure_built()
    paths = {}
    for run, name, kw, B, whole in CONV_SMALL:
        # a run held at its first step takes only that step
        steps = CONV_SMALL_STEPS if whole else 1
        res, init, t0 = {}, None, time.perf_counter()
        for amp in (False, True):
            main, startup, out, feed, test = progs[run, amp]
            if init is None:
                gscope = fluid.Scope()
                with fluid.scope_guard(gscope):
                    fluid.Executor().run(startup)
                init = {n: t.cpu().numpy() for n, t in gscope.vars.items()}
            for dev in ('gpu', 'cpu'):
                scope = fluid.scope_from_numpy(
                    {n: a.copy() for n, a in init.items()}, fluid.Scope(),
                    'cuda' if dev == 'gpu' else 'cpu')
                exe = fluid.Executor() if dev == 'gpu' else \
                    fluid.Executor(fluid.CPUPlace())
                if dev == 'gpu':
                    kernels.reset_launches()
                with fluid.scope_guard(scope):
                    losses = [float(exe.run(main, feed=feed, fetch_list=[
                        out['loss']])[0][0])
                        for _ in range(steps)]
                    if dev == 'gpu':
                        paths['train_conv_%s_%s' % (
                            run, 'amp' if amp else 'f32')] = {
                            k: v / steps
                            for k, v in kernels.launches.items() if v}
                    pred, = exe.run(test, feed=feed,
                                    fetch_list=[out['predict']])
                state = {n: t.float().cpu().numpy()
                         for n, t in scope.vars.items()}
                res[dev, amp] = dict(losses=[losses], pred=[pred],
                                     **_conv_kinds(main, state))

        def dist(a, b):
            return {k: _rel(res[a][k], res[b][k]) for k in CONV_KINDS
                    if res[a][k]}
        e_bf16 = dist(('cpu', True), ('cpu', False))
        e_amp = dist(('gpu', True), ('cpu', True))
        e_f32 = dist(('gpu', False), ('cpu', False))
        gpu_bf16 = dist(('gpu', True), ('gpu', False))
        first = {k: res[k]['losses'][0][0] for k in res}
        row = dict(phase='train_conv_gpu_vs_cpu', config=run, model=name,
                   cfg=kw, B=B, steps=steps,
                   held='whole runs' if whole else 'the first step',
                   gpu_losses_f32=res['gpu', False]['losses'][0],
                   cpu_losses_f32=res['cpu', False]['losses'][0],
                   gpu_losses_amp=res['gpu', True]['losses'][0],
                   cpu_losses_amp=res['cpu', True]['losses'][0],
                   e_bf16=e_bf16, e_amp=e_amp, e_f32=e_f32,
                   gpu_amp_vs_f32=gpu_bf16, seconds=time.perf_counter() - t0)
        emit(**row)
        require(all(np.all(np.isfinite(np.concatenate(
            [np.ravel(x) for x in r['losses'] + r['pred']])))
            for r in res.values()), 'non-finite losses or predictions '
            '(%s)' % run)
        if whole:
            for k in e_bf16:
                require(e_amp[k] <= e_bf16[k] and
                        0.5 * e_bf16[k] <= gpu_bf16[k] <= 2 * e_bf16[k] and
                        e_f32[k] <= 2.0 ** -8 * e_bf16[k],
                        'train_conv_gpu_vs_cpu (%s, %s): %s' % (run, k, row))
        else:
            f32 = abs(first['gpu', False] - first['cpu', False])
            amp = abs(first['gpu', True] - first['cpu', True])
            bf16 = max(abs(first[d, True] - first[d, False])
                       for d in ('gpu', 'cpu'))
            require(f32 <= 1e-4 * abs(first['cpu', False]) and amp <= bf16,
                    'train_conv_gpu_vs_cpu (%s, first step): %s'
                    % (run, row))
    emit(phase='train_conv_gpu_vs_cpu', step='schedules',
         max_rel_err=schedules_under_graphs(), cuda=torch.version.cuda)
    for p in paths.values():
        require(p.get('softmax') == 1, 'the small conv models did not run '
                'K5 once a step on the card: %s' % paths)
    return paths


# one generated segment for each rule of the elementwise, comparison,
# logical and activation ops, and of relu, clip, max and min: case ->
# (op, attrs); binary ops take X and Y of one shape
RULE_CASES = {
    'elementwise_mod': ('elementwise_mod', {'axis': -1}),
    'elementwise_floordiv': ('elementwise_floordiv', {'axis': -1}),
    'less_than': ('less_than', {'axis': -1}),
    'less_equal': ('less_equal', {'axis': -1}),
    'greater_than': ('greater_than', {'axis': -1}),
    'greater_equal': ('greater_equal', {'axis': -1}),
    'equal': ('equal', {'axis': -1}),
    'not_equal': ('not_equal', {'axis': -1}),
    'logical_and': ('logical_and', {}), 'logical_or': ('logical_or', {}),
    'logical_xor': ('logical_xor', {}), 'logical_not': ('logical_not', {}),
    'relu6': ('relu6', {}), 'leaky_relu': ('leaky_relu', {'alpha': 0.1}),
    'elu': ('elu', {'alpha': 0.7}), 'selu': ('selu', {}),
    'brelu': ('brelu', {'t_min': -1.0, 't_max': 6.0}),
    'soft_relu': ('soft_relu', {'threshold': 20.0}),
    'hard_sigmoid': ('hard_sigmoid', {}), 'stanh': ('stanh', {}),
    'pow': ('pow', {'factor': 1.7}), 'pow_sqrt': ('pow', {'factor': 0.5}),
    'pow_rsqrt': ('pow', {'factor': -0.5}),
    'pow_cube': ('pow', {'factor': 3.0}),
    'thresholded_relu': ('thresholded_relu', {'threshold': 0.5}),
    'hard_shrink': ('hard_shrink', {}), 'softshrink': ('softshrink', {}),
    # C10's repaired rules: -0 < +0 in relu, clip, max and min
    'relu': ('relu', {}), 'clip': ('clip', {'min': -0.5, 'max': 0.0}),
    'elementwise_max': ('elementwise_max', {'axis': -1}),
    'elementwise_min': ('elementwise_min', {'axis': -1}),
}
for _op in ('sigmoid', 'logsigmoid', 'tanh', 'tanh_shrink', 'exp', 'log',
            'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round',
            'reciprocal', 'softplus', 'softsign', 'erf'):
    RULE_CASES[_op] = (_op, {})
RULE_N = 1 << 22
_BINARY_RULES = ('elementwise_mod', 'elementwise_floordiv',
                 'elementwise_max', 'elementwise_min', 'less_than',
                 'less_equal', 'greater_than', 'greater_equal', 'equal',
                 'not_equal', 'logical_and', 'logical_or', 'logical_xor')
def _rule_library(case):
    """The one PyTorch call that computes a rule case's function, where
    there is one: (what it is, fn(*inputs)) or None."""
    import torch
    import torch.nn.functional as F
    plain = {'elementwise_mod': torch.remainder,
             'elementwise_floordiv': torch.floor_divide,
             'less_than': torch.lt, 'less_equal': torch.le,
             'greater_than': torch.gt, 'greater_equal': torch.ge,
             'equal': torch.eq, 'not_equal': torch.ne,
             'logical_and': torch.logical_and,
             'logical_or': torch.logical_or,
             'logical_xor': torch.logical_xor,
             'logical_not': torch.logical_not, 'sigmoid': torch.sigmoid,
             'logsigmoid': F.logsigmoid, 'tanh': torch.tanh,
             'tanh_shrink': F.tanhshrink, 'exp': torch.exp,
             'log': torch.log, 'rsqrt': torch.rsqrt, 'abs': torch.abs,
             'ceil': torch.ceil, 'floor': torch.floor, 'cos': torch.cos,
             'sin': torch.sin, 'round': torch.round,
             'reciprocal': torch.reciprocal, 'softplus': F.softplus,
             'softsign': F.softsign, 'erf': torch.erf, 'relu6': F.relu6,
             'selu': F.selu, 'hard_shrink': F.hardshrink,
             'softshrink': F.softshrink, 'relu': torch.relu,
             'elementwise_max': torch.maximum,
             'elementwise_min': torch.minimum}
    if case in plain:
        return plain[case].__name__, plain[case]
    args = {'leaky_relu': (F.leaky_relu, 0.1), 'elu': (F.elu, 0.7),
            'brelu': (F.hardtanh, -1.0, 6.0), 'pow': (torch.pow, 1.7),
            'pow_sqrt': (torch.pow, 0.5), 'pow_rsqrt': (torch.pow, -0.5),
            'pow_cube': (torch.pow, 3.0),
            'thresholded_relu': (F.threshold, 0.5, 0.0),
            'clip': (torch.clamp, -0.5, 0.0)}.get(case)
    if args is None:
        return None
    return ('%s(x, %s)' % (args[0].__name__, ', '.join(map(str, args[1:]))),
            lambda x: args[0](x, *args[1:]))


# the values every rule case starts with, then normal values x 3
RULE_SPECIALS = (float('nan'), float('inf'), float('-inf'), -0.0, 0.0, 0.5,
                 -0.5, 1.5, -2.5, 2.5, 1e-30, -1e-30, 100.0, -100.0, 6.0,
                 -1.0, 1.0, 3.0, -3.0, 0.25)


def rule_fused_attrs(op, attrs):
    """A fused_elementwise op of one sub-op (X [, Y] -> o)."""
    ins = {'X': ['x'], 'Y': ['y']} if op in _BINARY_RULES else {'X': ['x']}
    sub = {'type': op, 'inputs': ins, 'outputs': {'Out': ['o']},
           'input_is_list': {k: False for k in ins},
           'output_is_list': {'Out': False}, 'attrs': dict(attrs),
           'stop_grad': []}
    return {'sub_ops': [sub], 'arg_names': [v[0] for v in ins.values()],
            'out_names': ['o'], 'fused_count': 1}


def rule_specs(n=RULE_N):
    """The generated segment of each RULE_CASES case at n float32 values:
    case -> spec (planned, not built)."""
    from paddle_tpu_torch.ops import kernelgen
    out = {}
    for case, (op, attrs) in RULE_CASES.items():
        fa = rule_fused_attrs(op, attrs)
        plan = kernelgen.plan_for(fa, tuple(((n,), 'float32')
                                            for _ in fa['arg_names']), False)
        kinds = [st[0] for st in plan.steps]
        require(kinds == ['kernel'], 'rule %s planned as %s' % (case, kinds))
        out[case] = plan.steps[0][1]
    return out


def _rule_inputs(case, n):
    import torch
    g = torch.Generator(device='cuda').manual_seed(SEED + 19)
    sp = torch.tensor(RULE_SPECIALS, device='cuda')
    xs = []
    for k in range(2 if RULE_CASES[case][0] in _BINARY_RULES else 1):
        x = torch.randn(n, generator=g, device='cuda') * 3
        # every pair of specials meets once in the binary ops
        x[:sp.numel() ** 2] = sp.repeat_interleave(sp.numel()) if k == 0 \
            else sp.repeat(sp.numel())
        if k == 1:
            # equal operands for the comparisons, in a quarter of the rest
            eq = torch.rand(n, generator=g, device='cuda') < 0.25
            eq[:sp.numel() ** 2] = False
            x = torch.where(eq, xs[0], x)
        xs.append(x.contiguous())
    return xs


def _same(a, b, rtol):
    """Equal values (a zero's sign included), both NaN, or within rtol of
    a nonzero b; bools equal."""
    import torch
    if a.dtype == torch.bool:
        return a == b
    a, b = a.float(), b.float()
    return ((a == b) & (torch.signbit(a) == torch.signbit(b))) | \
        (torch.isnan(a) & torch.isnan(b)) | \
        ((b != 0) & ((a - b).abs() <= rtol * b.abs()))


def rule_case(case, spec, n=RULE_N):
    """One rule's segment against its plain version (the op's eager
    PyTorch impl) on RULE_SPECIALS and normal values: equal up to 1e-6
    relative where a libdevice function (expf, tanhf, erff, powf) may
    round otherwise in torch's own build, NaN where it is NaN, the sign of
    a zero kept; timed beside the plain version and the one PyTorch call
    computing the same function (_rule_library), if it agrees on these
    inputs."""
    import torch
    from paddle_tpu_torch.core.dtypes import torch_dtype
    from paddle_tpu_torch.ops import kernelgen
    ents = _rule_inputs(case, n)
    with torch.no_grad():
        out, = kernelgen._launch(spec, ents)
        ref, = spec.replay(ents)
        torch.cuda.synchronize()
        ok = _same(out, ref, 1e-6)
        bad = int((~ok).sum())
        lib = _rule_library(case)
        if lib and not bool(_same(lib[1](*ents), ref, 1e-6).all()):
            lib = (lib[0] + ' differs from the plain op on these inputs',
                   None)
        nbytes = sum(t.numel() * t.element_size() for t in ents) + \
            out.numel() * torch.empty((), dtype=torch_dtype(
                spec.esc_aval[0][1])).element_size()
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        row = dict(phase='kernels', kernel='kernelgen_rule', case=case,
                   op=RULE_CASES[case][0], attrs=RULE_CASES[case][1],
                   name=spec.name, n=n, out_dtype=spec.esc_aval[0][1],
                   mismatches=bad, max_abs_err=float(
                       (out.float() - ref.float()).abs().nan_to_num(
                           0.0, posinf=0.0).max()), rtol=1e-6,
                   ms=time_ms(lambda: kernelgen._launch(spec, ents), 50),
                   plain_ms=time_ms(lambda: spec.replay(ents), 20),
                   library_is=lib[0] if lib else 'none',
                   library_ms=time_ms(lambda: lib[1](*ents), 50)
                   if lib and lib[1] else None, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes)
    if bad:
        idx = torch.nonzero(~ok)[:8, 0]
        row['first_mismatches'] = [
            [float(e[i]) for e in ents] + [float(out[i]), float(ref[i])]
            for i in idx.tolist()]
    emit(**row)
    require(not bad, 'rule %s: its generated segment disagrees with the '
            'plain op at %d values: %s' % (case, bad, row))
    return row


# C12's rule cases: each op that takes a Python constant, with constants
# bf16 does not hold (jnp rounds them to bf16 first, as weak types)
C12_RULE_CASES = {
    'relu6': ('relu6', {'threshold': 5.3}),
    'leaky_relu': ('leaky_relu', {'alpha': 0.3}),
    'elu': ('elu', {'alpha': 0.7}), 'selu': ('selu', {}),
    'brelu': ('brelu', {'t_min': -1.3, 't_max': 5.3}),
    'soft_relu': ('soft_relu', {'threshold': 3.3}),
    'hard_sigmoid': ('hard_sigmoid', {}), 'stanh': ('stanh', {}),
    'pow': ('pow', {'factor': 1.3}),
    'thresholded_relu': ('thresholded_relu', {'threshold': 1.006}),
    'hard_shrink': ('hard_shrink', {'threshold': 0.3}),
    'softshrink': ('softshrink', {'lambda': 0.3}),
    'scale': ('scale', {'scale': 0.3, 'bias': 0.1}),
    'scale_bias_first': ('scale', {'scale': 0.3, 'bias': 0.1,
                                   'bias_after_scale': False}),
    'swish': ('swish', {'beta': 0.3}),
    'clip': ('clip', {'min': -1.3, 'max': 2.3}),
    'increment': ('increment', {'step': 0.1}),
    'dropout_test': ('dropout', {'dropout_prob': 0.3, 'is_test': True}),
    'sigmoid': ('sigmoid', {}),
}
C12_N = 1 << 20


def rule_specs_bf16(n=C12_N):
    """The generated bf16 segment of each C12_RULE_CASES case at n values:
    case -> spec (planned, not built)."""
    from paddle_tpu_torch.ops import kernelgen
    out = {}
    for case, (op, attrs) in C12_RULE_CASES.items():
        plan = kernelgen.plan_for(rule_fused_attrs(op, attrs),
                                  (((n,), 'bfloat16'),), False)
        kinds = [st[0] for st in plan.steps]
        require(kinds == ['kernel'], 'bf16 rule %s planned as %s'
                % (case, kinds))
        out[case] = plan.steps[0][1]
    return out


def rule_case_bf16(case, spec, n=C12_N):
    """One C12 rule's bf16 segment on every bf16 bit pattern (subnormals,
    +-0, +-inf, NaNs and each constant's neighbours), then normal values,
    against its plain op on the card: the same bits (any NaN as NaN)."""
    import torch
    from paddle_tpu_torch.ops import kernelgen
    g = torch.Generator(device='cuda').manual_seed(SEED + 22)
    x = (torch.randn(n, generator=g, device='cuda') * 3).to(torch.bfloat16)
    x[:1 << 16] = torch.arange(1 << 16, dtype=torch.int32,
                               device='cuda').to(torch.int16).view(
                                   torch.bfloat16)
    with torch.no_grad():
        out, = kernelgen._launch(spec, [x])
        ref, = spec.replay([x])
        torch.cuda.synchronize()
    same = (out.view(torch.int16) == ref.view(torch.int16)) | (
        torch.isnan(out.float()) & torch.isnan(ref.float()))
    bad = int((~same).sum())
    row = dict(phase='kernels', kernel='kernelgen_rule_bf16', case=case,
               op=C12_RULE_CASES[case][0], attrs=C12_RULE_CASES[case][1],
               name=spec.name, n=n, out_dtype=spec.esc_aval[0][1],
               mismatches=bad, bit_for_bit=not bad)
    if bad:
        idx = torch.nonzero(~same)[:8, 0]
        row['first_mismatches'] = [[float(x[i]), float(out[i]),
                                    float(ref[i])] for i in idx.tolist()]
    emit(**row)
    require(not bad, 'bf16 rule %s: its generated segment differs from the '
            'plain op at %d values: %s' % (case, bad, row))
    return row


# the rules of label_smooth, fill_zeros_like and flatten, each a
# one-segment sub-program: case -> (sub-ops, argument names, shapes of
# the arguments, in elements: RULE_N values in all, the prior one row)
def _rule_sub(type, inputs, outputs, attrs=None):
    return {'type': type, 'inputs': {k: list(v) for k, v in inputs.items()},
            'outputs': {k: list(v) for k, v in outputs.items()},
            'input_is_list': {k: False for k in inputs},
            'output_is_list': {k: False for k in outputs},
            'attrs': dict(attrs or {}), 'stop_grad': []}


A10_RULE_V = 1024
A10_RULE_CASES = {
    'label_smooth': (
        [_rule_sub('label_smooth', {'X': ['x']}, {'Out': ['o']},
                   {'epsilon': 0.1})], ['x'], ['rows']),
    'label_smooth_prior': (
        [_rule_sub('label_smooth', {'X': ['x'], 'PriorDist': ['p']},
                   {'Out': ['o']}, {'epsilon': 0.3})], ['x', 'p'],
        ['rows', 'row']),
    'fill_zeros_like': (
        [_rule_sub('fill_zeros_like', {'X': ['x']}, {'Out': ['o']})],
        ['x'], ['rows']),
    # flatten between two kernel ops: a flat alias inside the segment
    'flatten': (
        [_rule_sub('scale', {'X': ['x']}, {'Out': ['s']}, {'scale': 3.0}),
         _rule_sub('flatten', {'X': ['s']}, {'Out': ['f']}, {'axis': 1}),
         _rule_sub('scale', {'X': ['f']}, {'Out': ['o']}, {'scale': 0.5})],
        ['x'], ['rows3']),
}


def _a10_shape(kind, n):
    rows = n // A10_RULE_V
    return {'rows': (rows, A10_RULE_V), 'row': (A10_RULE_V,),
            'rows3': (rows, 32, A10_RULE_V // 32)}[kind]


def a10_rule_specs(dtype, n):
    """The generated segment of each A10_RULE_CASES case in `dtype` at n
    values: case -> spec (planned, not built)."""
    from paddle_tpu_torch.ops import kernelgen
    out = {}
    for case, (subs, args, kinds) in A10_RULE_CASES.items():
        fa = {'sub_ops': subs, 'arg_names': args, 'out_names': ['o'],
              'fused_count': len(subs)}
        plan = kernelgen.plan_for(fa, tuple((_a10_shape(k, n), dtype)
                                            for k in kinds), False)
        kinds_ = [st[0] for st in plan.steps]
        require(kinds_ == ['kernel'], 'rule %s (%s) planned as %s'
                % (case, dtype, kinds_))
        out[case] = plan.steps[0][1]
    return out


def a10_rule_case(case, spec, dtype, n):
    """One new rule's segment against its plain op on the card, bit for
    bit (each is IEEE multiplies and adds, or a constant): float32 on
    normal values and RULE_SPECIALS, timed beside its plain replay and a
    PyTorch call of the same function (torch.lerp for label_smooth,
    zeros_like, mul by 1.5) where it agrees; bf16 on every bf16 bit
    pattern, then normal values."""
    import torch
    from paddle_tpu_torch.ops import kernelgen
    subs, args, kinds = A10_RULE_CASES[case]
    g = torch.Generator(device='cuda').manual_seed(SEED + 23)
    ents = []
    for k in kinds:
        shape = _a10_shape(k, n)
        x = torch.rand(shape, generator=g, device='cuda') if k != 'rows3' \
            else torch.randn(shape, generator=g, device='cuda') * 3
        flat = x.view(-1)
        if dtype == 'float32' and k != 'row':
            flat[:len(RULE_SPECIALS)] = torch.tensor(RULE_SPECIALS,
                                                     device='cuda')
        x = x.to(getattr(torch, dtype))
        if dtype == 'bfloat16' and k != 'row':
            x.view(-1)[:1 << 16] = torch.arange(
                1 << 16, dtype=torch.int32, device='cuda').to(
                    torch.int16).view(torch.bfloat16)
        ents.append(x.contiguous())
    # the segment's entries (fill_zeros_like reads X's shape only: none)
    launched = ents[:len(spec.entry_avals)]
    with torch.no_grad():
        out, = kernelgen._launch(spec, launched)
        ref, = spec.replay(launched)
        torch.cuda.synchronize()
    iv = torch.int16 if dtype == 'bfloat16' else torch.int32
    ref = ref.reshape(out.shape).to(out.device)
    same = (out.view(iv) == ref.view(iv)) | (
        torch.isnan(out.float()) & torch.isnan(ref.float()))
    bad = int((~same).sum())
    if dtype == 'bfloat16':
        row = dict(phase='kernels', kernel='kernelgen_rule_bf16', case=case,
                   ops=[s_['type'] for s_ in subs], name=spec.name, n=n,
                   out_dtype=spec.esc_aval[0][1], mismatches=bad,
                   bit_for_bit=not bad)
    else:
        eps = subs[0]['attrs'].get('epsilon', 0.0)
        lib = {'label_smooth': ('torch.lerp', lambda x: torch.lerp(
                   x, torch.full_like(x, eps / x.shape[-1]), eps)),
               'label_smooth_prior': ('torch.lerp', lambda x, p: torch.lerp(
                   x, p.expand_as(x), eps)),
               'fill_zeros_like': ('torch.zeros_like', torch.zeros_like),
               'flatten': ('torch.mul', lambda x: torch.mul(
                   x, 1.5).reshape(x.shape[0], -1))}[case]
        lib_ok = bool(_same(lib[1](*ents).reshape(ref.shape), ref,
                            1e-6).all())
        nbytes = sum(t.numel() * t.element_size() for t in launched) + \
            out.numel() * out.element_size()
        bound_ms, bound_by = _bound(0.0, nbytes, 'float32')
        row = dict(phase='kernels', kernel='kernelgen_rule', case=case,
                   ops=[s_['type'] for s_ in subs], name=spec.name, n=n,
                   out_dtype=spec.esc_aval[0][1], mismatches=bad,
                   max_abs_err=float((out.float() - ref.float()).abs()
                                     .nan_to_num(0.0, 0.0, 0.0).max()),
                   rtol=0.0,
                   ms=time_ms(lambda: kernelgen._launch(spec, launched),
                              50),
                   plain_ms=time_ms(lambda: spec.replay(launched), 20),
                   library_is=lib[0] if lib_ok else
                   lib[0] + ' differs from the plain op on these inputs',
                   library_ms=time_ms(lambda: lib[1](*ents), 50)
                   if lib_ok else None, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes)
    emit(**row)
    require(not bad, 'rule %s (%s): its generated segment differs from the '
            'plain op at %d values: %s' % (case, dtype, bad, row))
    return row


def _resnet_program(fluid, resnet, amp, for_test=False, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = resnet.build(**kw)
    test = main.clone(for_test=True)
    main.set_amp(amp)
    test.set_amp(amp)
    return main, startup, out, test


def _rel(a, b):
    """||a - b|| / ||b|| over the concatenated arrays."""
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# the GPU-vs-CPU ResNets: (name, build kwargs, B, whole runs held)
RESNET_SMALL = (
    ('cifar10_d8', dict(data_shape=(3, 32, 32), class_dim=10, depth=8,
                        data_set='cifar10'), 8, True),
    ('imagenet_d50', dict(data_shape=(3, 64, 64), class_dim=10, depth=50,
                          lr=0.001), 8, False))
RESNET_SMALL_STEPS = 3
RESNET_KINDS = ('losses', 'params', 'velocities', 'moving', 'pred')


def phase_train_resnet_gpu_vs_cpu():
    """The port's models/resnet.py::build at sizes the CPU runs quickly
    (RESNET_SMALL: the CIFAR-10 ResNet-8 at 32 x 32, B 8, and ResNet-50 at
    64 x 64, 10 classes, B 8), RESNET_SMALL_STEPS Momentum steps (one for
    ResNet-50, held at its first step) in float32
    and under bf16 AMP on the card and on the CPU from one scope
    (convert.scope_from_numpy), with cuDNN's TF32 flag left at PyTorch's
    default (True: the conv op computes float32 in float32 itself), then
    the for_test clone's predictions.

    ResNet-8's runs are held whole: the losses, parameters, velocities,
    batch-norm moving statistics and predictions, each kind as a relative
    L2 distance d over its tensors, against the size of the bf16 effect
    itself, e_bf16 = d(CPU AMP, CPU float32):
    - AMP, d(card AMP, CPU AMP) <= e_bf16: both round the same values to
      bf16 (u = 2^-8) at the same places; they differ only where a
      float32 value lies within its summation-order difference of a
      rounding boundary, a share of the values, so their distance is
      below that of either from float32.  And the card's AMP run must be
      an AMP run: d(card AMP, card float32) within [1/2, 2] e_bf16;
    - float32, d(card float32, CPU float32) <= 2^-8 e_bf16: the two
      differ by the order of float32 sums (u = 2^-24; a sum of K terms
      sqrt(K) u apart, K <= 2^13 here: the batch norm's N H W), where bf16
      rounds every value once, so the ratio is sqrt(K) 2^-16 <= 2^-9.5;
      the same network amplifies both alike.
    ResNet-50 at 64 x 64 from random weights is chaotic beyond its first
    step: two float32 runs whose first losses agree to 6e-6 part at the
    second (2.71 and 2.67 on the card and the CPU, H100 80GB HBM3, 700 W),
    and its AMP velocities differ from its float32 ones by 1.36 (L2,
    relative: the phase's own e_bf16).
    So it runs and holds its first step only: the float32 loss within
    1e-4 relative (ten times one deep float32 sum's order error, 2^-24
    sqrt(2^15)), the AMP loss within e_bf16 of the first loss; its other
    distances after that step are reported.  -> launches a step on the
    card, by run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import kernelgen
    feeds = {}
    for name, kw, B, _ in RESNET_SMALL:
        rng = np.random.RandomState(SEED)
        feeds[name] = {
            'data': rng.rand(B, *kw['data_shape']).astype('float32'),
            'label': rng.randint(0, kw['class_dim'], (B, 1)).astype('int64')}
        # every program of the phase planned first, so that one nvcc call
        # builds all their generated kernels
        for amp in (False, True):
            main, startup, out, test = _resnet_program(fluid, resnet, amp,
                                                       **kw)
            _planned_specs(main, feeds[name], [out['loss'].name], amp)
            _planned_specs(test, feeds[name], [out['predict'].name], amp)
            _planned_specs(startup, {}, [], False)
    kernelgen.ensure_built()
    paths = {}
    for name, kw, B, whole in RESNET_SMALL:
        feed = feeds[name]
        # a run held at its first step takes only that step (cut from 3
        # for the script's time limit)
        steps = RESNET_SMALL_STEPS if whole else 1
        res, init, t0 = {}, None, time.perf_counter()
        for amp in (False, True):
            main, startup, out, test = _resnet_program(fluid, resnet, amp,
                                                       **kw)
            if init is None:
                gscope = fluid.Scope()
                with fluid.scope_guard(gscope):
                    fluid.Executor().run(startup)
                init = {n: t.cpu().numpy() for n, t in gscope.vars.items()}
            for dev in ('gpu', 'cpu'):
                # copies: the runs update their scopes in place
                scope = fluid.scope_from_numpy(
                    {n: a.copy() for n, a in init.items()}, fluid.Scope(),
                    'cuda' if dev == 'gpu' else 'cpu')
                exe = fluid.Executor() if dev == 'gpu' else \
                    fluid.Executor(fluid.CPUPlace())
                if dev == 'gpu':
                    kernels.reset_launches()
                with fluid.scope_guard(scope):
                    losses = [float(exe.run(main, feed=feed, fetch_list=[
                        out['loss']])[0][0])
                        for _ in range(steps)]
                    if dev == 'gpu':
                        paths['train_resnet_%s_%s' % (
                            name, 'amp' if amp else 'f32')] = {
                            k: v / steps
                            for k, v in kernels.launches.items() if v}
                    pred, = exe.run(test, feed=feed,
                                    fetch_list=[out['predict']])
                state = {n: t.float().cpu().numpy()
                         for n, t in scope.vars.items()}
                res[dev, amp] = dict(
                    losses=[losses], pred=[pred],
                    params=[state[p.name] for p in main.all_parameters()
                            if p.trainable],
                    velocities=[v for n, v in sorted(state.items())
                                if n.endswith('_velocity_0')],
                    moving=[state[p.name] for p in main.all_parameters()
                            if not p.trainable])

        def dist(a, b, kinds=RESNET_KINDS):
            return {k: _rel(res[a][k], res[b][k]) for k in kinds}
        e_bf16 = dist(('cpu', True), ('cpu', False))
        e_amp = dist(('gpu', True), ('cpu', True))
        e_f32 = dist(('gpu', False), ('cpu', False))
        gpu_bf16 = dist(('gpu', True), ('gpu', False))
        first = {k: res[k]['losses'][0][0] for k in res}
        row = dict(phase='train_resnet_gpu_vs_cpu', config=name, cfg=kw,
                   B=B, steps=steps, held='whole runs' if whole
                   else 'the first step',
                   cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                   gpu_losses_f32=res['gpu', False]['losses'][0],
                   cpu_losses_f32=res['cpu', False]['losses'][0],
                   gpu_losses_amp=res['gpu', True]['losses'][0],
                   cpu_losses_amp=res['cpu', True]['losses'][0],
                   e_bf16=e_bf16, e_amp=e_amp, e_f32=e_f32,
                   gpu_amp_vs_f32=gpu_bf16, seconds=time.perf_counter() - t0)
        emit(**row)
        require(all(np.all(np.isfinite(np.concatenate(
            [np.ravel(x) for x in r['losses'] + r['pred']])))
            for r in res.values()), 'non-finite ResNet losses or '
            'predictions (%s)' % name)
        if whole:
            for k in RESNET_KINDS:
                require(e_amp[k] <= e_bf16[k] and
                        0.5 * e_bf16[k] <= gpu_bf16[k] <= 2 * e_bf16[k] and
                        e_f32[k] <= 2.0 ** -8 * e_bf16[k],
                        'train_resnet_gpu_vs_cpu (%s, %s): %s'
                        % (name, k, row))
        else:
            f32 = abs(first['gpu', False] - first['cpu', False])
            amp = abs(first['gpu', True] - first['cpu', True])
            bf16 = abs(first['cpu', True] - first['cpu', False])
            require(f32 <= 1e-4 * abs(first['cpu', False]) and amp <= bf16,
                    'train_resnet_gpu_vs_cpu (%s, first step): %s'
                    % (name, row))
    for p in paths.values():
        require(p.get('momentum_multi') == 1, 'the small ResNets did not '
                'run momentum_multi once a step on the card: %s' % paths)
    return paths

# ---------------------------------- CTR, word2vec and the other optimizers

# PaddleRec CTR as BASELINE.json names it, at models/ctr.py's own widths
# (26 slots, 13 dense features, embedding 8; DeepFM's fc (400, 400, 400)
# with Adam 1e-3, Wide&Deep's (256, 128, 64) with Adagrad 1e-2) and a
# vocabulary of 1,000,001 rows (the builders' vocab_size), so that the
# tables and their optimizer state are real bytes on the card; B 2048
# rows of the reference's synthetic_reader from SEED
CTR_VOCAB = 1000001
CTR_B = 2048
# the book's word2vec (models/word2vec.py at its defaults: dictionary
# 2073, embedding 32, hidden 256, 5-grams, SGD 1e-3), B 512
W2V_B = 512
# training_optimizers: Wide&Deep under each optimizer, this many graph
# steps after the interpreted step and the capture
OPT_STEPS = 3


def _model_average(fluid, loss):
    """SGD 1e-2, then ModelAverage(0.15) over every parameter."""
    for p in loss.block.program.all_parameters():
        p.do_model_average = True
    fluid.optimizer.SGD(learning_rate=1e-2).minimize(loss)
    return fluid.optimizer.ModelAverage(0.15)


def _minimize(make):
    def run(fluid, loss):
        opt = make(fluid.optimizer)
        opt.minimize(loss)
        return opt
    return run


# the optimizers training_optimizers and train_ctr_gpu_vs_cpu run
# Wide&Deep under: name -> (minimize(fluid, loss) -> optimizer, the
# optim_multi instance it launches once a step, or None)
OPT_RUNS = {
    'SGD': (_minimize(lambda o: o.SGD(learning_rate=1e-2)), 'sgd_multi'),
    'Adagrad': (_minimize(lambda o: o.Adagrad(learning_rate=1e-2)),
                'adagrad_multi'),
    'DecayedAdagrad': (_minimize(lambda o: o.DecayedAdagrad(
        learning_rate=1e-2)), 'decayed_adagrad_multi'),
    'Adamax': (_minimize(lambda o: o.Adamax(learning_rate=1e-3)),
               'adamax_multi'),
    'Adadelta': (_minimize(lambda o: o.Adadelta(learning_rate=1.0)),
                 'adadelta_multi'),
    'RMSProp': (_minimize(lambda o: o.RMSProp(learning_rate=1e-3,
                                              momentum=0.9)),
                'rmsprop_multi'),
    'RMSPropCentered': (_minimize(lambda o: o.RMSProp(
        learning_rate=1e-3, momentum=0.9, centered=True)),
        'rmsprop_centered_multi'),
    'Ftrl': (_minimize(lambda o: o.Ftrl(learning_rate=1e-2, l1=1e-4,
                                        l2=1e-3)), 'ftrl_multi'),
    'FtrlPow': (_minimize(lambda o: o.Ftrl(learning_rate=1e-2, l1=1e-4,
                                           l2=1e-3, lr_power=-0.6)),
                'ftrl_pow_multi'),
    'LarsMomentum': (_minimize(lambda o: o.LarsMomentum(
        learning_rate=1e-2, momentum=0.9)), None),
    'ModelAverage': (_model_average, 'sgd_multi'),
}


def ctr_program(model, vocab=CTR_VOCAB, B=CTR_B, seed=SEED, minimize=None,
                **kw):
    """models/ctr.py's `model` through the port's layers with its own
    optimizer, or under `minimize(fluid, loss)`: (main, startup, out,
    feed), out['optimizer'] the optimizer; the feed B rows of
    synthetic_reader(seed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ctr
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = getattr(ctr, model)(vocab_size=vocab,
                                  is_train=minimize is None, **kw)
        if minimize is not None:
            out['optimizer'] = minimize(fluid, out['loss'])
    rows = list(ctr.synthetic_reader(n=B, vocab_size=vocab, seed=seed)())
    feed = {'dense_input': np.stack([r[0] for r in rows]),
            'sparse_input': np.stack([r[1] for r in rows]),
            'label': np.asarray([r[2] for r in rows], 'int64')}
    return main, startup, out, feed


def w2v_program(B=W2V_B, seed=SEED):
    """models/word2vec.py::build at its defaults and B rows of 5-grams
    drawn from `seed`: (main, startup, out, feed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import word2vec
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = word2vec.build()
    rng = np.random.RandomState(seed)
    feed = {v.name: rng.randint(0, 2073, (B, 1)).astype('int64')
            for v in out['feeds']}
    return main, startup, out, feed


def line_program(B, seed=SEED):
    """models/simple.py::fit_a_line and B rows of y = 0.1 sum(x)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import simple
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = simple.fit_a_line()
    x = np.random.RandomState(seed).randn(B, 13).astype('float32')
    return main, startup, out, {'x': x, 'y': (0.1 * x.sum(
        1, keepdims=True)).astype('float32')}


def phase_training_ctr(smi):
    """DeepFM with Adam and Wide&Deep with Adagrad at CTR_VOCAB rows, B
    CTR_B, float32, through _conv_step_phase (an interpreted step, the
    capture, graph steps, a profile by group; ms a step, examples/s, the
    idle share, peak memory): two K4 gathers, one adam_multi (DeepFM) or
    adagrad_multi (Wide&Deep) and the generated segments a step.  ->
    {path: launches a step}."""
    paths = {}
    for model, opt, want in (
            ('deepfm', 'Adam(lr=1e-3)', 'adam_multi'),
            ('wide_deep', 'Adagrad(lr=1e-2)', 'adagrad_multi')):
        main, startup, out, feed = ctr_program(model)
        params = [p for p in main.all_parameters() if p.trainable]
        emit(phase='training_ctr', step='config', config=model,
             vocab=CTR_VOCAB, B=CTR_B, optimizer=opt,
             entries=sum(int(np.prod(p.shape)) for p in params))
        launches, seg, groups = _conv_step_phase(
            'training_ctr', model, main, startup, out, feed, False, smi,
            per_s='examples_per_s')
        require(launches.get('embedding_gather') == 2 and
                launches.get(want) == 1 and
                launches.get('kernelgen_segment', 0) >= 1,
                '%s: launches a step %s, expected two K4 gathers, one %s '
                'and the generated segments' % (model, launches, want))
        require(groups.get(want) == 2 * DEVICE_KERNELS.get(want, 1),
                '%s: %s %s kernels on the profiler in two graph steps'
                % (model, groups.get(want), want))
        launches.update(seg)
        paths['training_ctr_' + model] = launches
    return paths


def phase_training_optimizers(smi):
    """Wide&Deep at CTR_VOCAB rows, B CTR_B, under each of OPT_RUNS in a
    fresh scope: an interpreted step, the capture, OPT_STEPS graph steps
    (losses finite, step ms, launches a step: the optimizer's optim_multi
    instance once a step, LarsMomentum none), no plain version on the
    card; ModelAverage's apply() puts sum / cnt into every parameter and
    restore() the trained values back.  All programs are planned first,
    so their generated segments, their startups' too, build in one nvcc
    call.  -> {path: launches a step}."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    progs = {}
    for name, (make, _) in OPT_RUNS.items():
        progs[name] = ctr_program('wide_deep', minimize=make)
        main, startup, out, feed = progs[name]
        _planned_specs(main, feed, [out['loss'].name], False)
        _planned_specs(startup, {}, [], False)
    t0 = time.perf_counter()
    kernelgen.ensure_built()
    emit(phase='training_optimizers', step='build',
         seconds=time.perf_counter() - t0)
    paths = {}
    for name, (make, want) in OPT_RUNS.items():
        main, startup, out, feed = progs[name]
        scope, exe = fluid.Scope(), fluid.Executor()
        fetch = [out['loss']]
        with fluid.scope_guard(scope), PlainCalls() as plain:
            exe.run(startup)
            losses, ms = [], []
            for i in range(2 + OPT_STEPS):
                if i == 2:
                    kernels.reset_launches()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=fetch)[0][0]))
                ms.append((time.perf_counter() - t1) * 1e3)
            launches = {k: v / OPT_STEPS for k, v in kernels.launches.items()
                        if v}
            averaged = None
            if name == 'ModelAverage':
                avg = out['optimizer']
                trained = {p: scope.vars[p].clone() for p in avg._avg_vars}
                with avg.apply(exe):
                    averaged = max(
                        float((scope.vars[p] - scope.vars[acc.name] /
                               scope.vars[cnt.name].clamp_min(1.0))
                              .abs().max())
                        for p, (acc, cnt) in avg._avg_vars.items())
                require(all(torch.equal(scope.vars[p], t)
                            for p, t in trained.items()),
                        'ModelAverage.restore() left other values')
        emit(phase='training_optimizers', optimizer=name, steps=OPT_STEPS,
             losses=losses, first_step_ms=ms[0], capture_step_ms=ms[1],
             graph_step_ms=ms[2:], median_graph_step_ms=float(
                 np.median(ms[2:])), launches_per_step=launches,
             plain_calls_on_cuda=plain.counts,
             model_average_max_abs_err=averaged, card=smi)
        require(all(np.isfinite(losses)), 'non-finite %s loss: %s'
                % (name, losses))
        require(not plain.counts, 'plain versions ran on the card: %s'
                % plain.counts)
        optim = {k: v for k, v in launches.items()
                 if k in kernels.launches and k.endswith('_multi')}
        require(optim == ({want: 1} if want else {}), '%s: optimizer '
                'kernels a step %s, expected %s once' % (name, optim, want))
        require(averaged is None or averaged == 0.0, 'ModelAverage.apply() '
                'wrote other values than sum / cnt: %s' % averaged)
        paths['training_optimizers_' + name] = launches
    return paths


def phase_training_word2vec(smi):
    """word2vec at its defaults (the book's imikolov model), SGD, B
    W2V_B, float32, through _conv_step_phase: four K4 gathers of the
    shared table, one K5 (the softmax fc), one sgd_multi and the
    generated segments a step.  -> launches a step."""
    main, startup, out, feed = w2v_program()
    emit(phase='training_word2vec', step='config', B=W2V_B,
         cfg=dict(dict_size=2073, embed_size=32, hidden_size=256, n=5),
         optimizer='SGD(lr=1e-3)')
    launches, seg, _ = _conv_step_phase(
        'training_word2vec', 'word2vec', main, startup, out, feed, False,
        smi, per_s='examples_per_s')
    require(launches.get('embedding_gather') == 4 and
            launches.get('softmax') == 1 and
            launches.get('sgd_multi') == 1,
            'word2vec: launches a step %s, expected four K4 gathers, one '
            'K5 and one sgd_multi' % launches)
    launches.update(seg)
    return launches


# train_ctr_gpu_vs_cpu: vocabulary, rows, steps
CTR_SMALL_VOCAB = 10000
CTR_SMALL_B = 256
CTR_SMALL_STEPS = 3


def _ctr_small_runs():
    """run -> (main, startup, out, feed): DeepFM (Adam), Wide&Deep
    (Adagrad) and fit_a_line (SGD) at their own optimizers, and Wide&Deep
    under each of OPT_RUNS, at CTR_SMALL_VOCAB rows and CTR_SMALL_B."""
    runs = {m: ctr_program(m, vocab=CTR_SMALL_VOCAB, B=CTR_SMALL_B)
            for m in ('deepfm', 'wide_deep')}
    runs['fit_a_line'] = line_program(CTR_SMALL_B)
    for name, (make, _) in OPT_RUNS.items():
        runs['wide_deep_' + name] = ctr_program(
            'wide_deep', vocab=CTR_SMALL_VOCAB, B=CTR_SMALL_B, minimize=make)
    return runs


def phase_train_ctr_gpu_vs_cpu():
    """Each of _ctr_small_runs, CTR_SMALL_STEPS steps on the card and on
    the CPU from one startup state.  Losses within 1e-5 relative.  Each
    persistable X (parameters and optimizer state) within a bound derived
    from the CPU run: ||X_card - X_cpu||_2 <= 1e-5 (||X||_2 + sqrt(n)
    max|X|) + 2 S sqrt(n_loose) CTR_SMALL_STEPS.  The first term is the
    float32 difference of two summation orders (the backward's GEMMs)
    carried through a well-conditioned update, as the CPU tests hold the
    port against the JAX package (rtol 1e-5, atol 1e-5 of the largest
    entry); the second covers the entries the normalising optimizers
    (Adam, Adagrad, RMSProp, ...) may step apart, by up to the largest
    step S any entry of X took in one CPU step, in both directions: those
    whose CPU gradient fell below 1% of its tensor's largest, but not to
    0, at some step (n_loose of them; the state of a parameter takes its
    mask; SGD, LarsMomentum, ModelAverage and the other persistables have
    none).  Prints each run's bound terms and its largest share of the
    bound.  -> launches a step on the card, by run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    runs = _ctr_small_runs()
    for main, startup, out, feed in runs.values():
        _planned_specs(main, feed, [out['loss'].name], False)
        _planned_specs(startup, {}, [], False)
    kernelgen.ensure_built()
    linear = ('fit_a_line', 'wide_deep_SGD', 'wide_deep_LarsMomentum',
              'wide_deep_ModelAverage')
    paths = {}
    for run, (main, startup, out, feed) in runs.items():
        t0 = time.perf_counter()
        gscope = fluid.Scope()
        with fluid.scope_guard(gscope):
            fluid.Executor().run(startup)
        init = {n: t.cpu().numpy() for n, t in gscope.vars.items()}
        params = [p.name for p in main.all_parameters() if p.trainable]
        res = {}
        for dev in ('gpu', 'cpu'):
            scope = fluid.scope_from_numpy(
                {n: a.copy() for n, a in init.items()}, fluid.Scope(),
                'cuda' if dev == 'gpu' else 'cpu')
            exe = fluid.Executor() if dev == 'gpu' else \
                fluid.Executor(fluid.CPUPlace())
            if dev == 'gpu':
                kernels.reset_launches()
            fetch = [out['loss']] + ([p + '@GRAD' for p in params]
                                     if dev == 'cpu' else [])
            losses, loose, step = [], {p: None for p in params}, {}
            with fluid.scope_guard(scope):
                for _ in range(CTR_SMALL_STEPS):
                    prev = {n: t.clone() for n, t in scope.vars.items()}
                    got = exe.run(main, feed=feed, fetch_list=fetch)
                    losses.append(float(got[0][0]))
                    for p, gr in zip(params, got[1:]):
                        gr = np.abs(np.asarray(gr))
                        small = (gr > 0) & (gr < 1e-2 * gr.max())
                        loose[p] = small if loose[p] is None else \
                            loose[p] | small
                    for n, t in scope.vars.items():
                        if n in prev and t.is_floating_point():
                            d = float((t.double() - prev[n].double()).abs()
                                      .max()) if t.numel() else 0.0
                            step[n] = max(step.get(n, 0.0), d)
            if dev == 'gpu':
                paths['train_ctr_' + run] = {
                    k: v / CTR_SMALL_STEPS
                    for k, v in kernels.launches.items() if v}
            res[dev] = dict(losses=losses, loose=loose, step=step, state={
                n: t.double().cpu().numpy() for n, t in scope.vars.items()
                if t.is_floating_point()})
        worst, terms = 0.0, {}
        for n, want in res['cpu']['state'].items():
            got = res['gpu']['state'][n]
            owner = next((p for p in params if n == p or
                          n.startswith(p + '_')), None)
            n_loose = 0
            if owner is not None and run not in linear:
                n_loose = int(res['cpu']['loose'][owner].sum())
            bound = 1e-5 * (np.linalg.norm(want) + np.sqrt(want.size) *
                            np.abs(want).max()) + 2 * res['cpu']['step'].get(
                n, 0.0) * np.sqrt(n_loose) * CTR_SMALL_STEPS
            d = float(np.linalg.norm(got - want))
            share = d / bound if bound > 0 else (0.0 if d == 0 else np.inf)
            if share > worst:
                worst = share
            terms[n] = dict(dist=d, bound=bound, n_loose=n_loose,
                            step=res['cpu']['step'].get(n, 0.0))
        gl, cl = res['gpu']['losses'], res['cpu']['losses']
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        emit(phase='train_ctr_gpu_vs_cpu', run=run, steps=CTR_SMALL_STEPS,
             vocab=CTR_SMALL_VOCAB, B=CTR_SMALL_B, gpu_losses=gl,
             cpu_losses=cl, loss_max_rel=loss_rel,
             worst_share_of_bound=worst,
             worst_tensor=max(terms, key=lambda k: terms[k]['dist'] /
                              max(terms[k]['bound'], 1e-300)),
             bound_terms={k: v for k, v in terms.items()
                          if v['n_loose'] or v['dist']},
             seconds=time.perf_counter() - t0)
        require(all(np.isfinite(gl + cl)) and loss_rel <= 1e-5,
                'train_ctr_gpu_vs_cpu (%s): losses %s vs %s' % (run, gl, cl))
        require(worst <= 1.0, 'train_ctr_gpu_vs_cpu (%s): a tensor past '
                'its bound (%.3g of it)' % (run, worst))
    return paths


# C11's program: a [C11_N] bf16 parameter, two steps under each update op
C11_N = 4100
C11_RUNS = {
    'sgd': (lambda o: o.SGD(learning_rate=0.1), 'sgd_multi_bf16'),
    'momentum': (lambda o: o.Momentum(learning_rate=0.1, momentum=0.9),
                 'momentum_multi_bf16'),
    'momentum_nesterov': (lambda o: o.Momentum(
        learning_rate=0.1, momentum=0.9, use_nesterov=True),
        'momentum_multi_bf16'),
    'lars_momentum': (lambda o: o.LarsMomentum(learning_rate=0.1,
                                               momentum=0.9), None),
    'adagrad': (lambda o: o.Adagrad(learning_rate=0.1),
                'adagrad_multi_bf16'),
    'decayed_adagrad': (lambda o: o.DecayedAdagrad(learning_rate=0.1),
                        'decayed_adagrad_multi_bf16'),
    'adamax': (lambda o: o.Adamax(learning_rate=0.01), 'adamax_multi_bf16'),
    'adadelta': (lambda o: o.Adadelta(learning_rate=1.0),
                 'adadelta_multi_bf16'),
    'rmsprop': (lambda o: o.RMSProp(learning_rate=0.01, momentum=0.9),
                'rmsprop_multi_bf16'),
    'rmsprop_centered': (lambda o: o.RMSProp(
        learning_rate=0.01, momentum=0.9, centered=True),
        'rmsprop_centered_multi_bf16'),
    'ftrl': (lambda o: o.Ftrl(learning_rate=0.1, l1=1e-4, l2=1e-3),
             'ftrl_multi_bf16'),
    'ftrl_pow': (lambda o: o.Ftrl(learning_rate=0.1, l1=1e-4, l2=1e-3,
                                  lr_power=-0.6), 'ftrl_pow_multi_bf16'),
}


def c11_program(make_opt, n=C11_N):
    """The program that showed C11, widened: a [n] bf16 parameter w
    (Constant 0.5), loss = mean(cast(cast(x, bf16) * w, float32)), and
    `make_opt`'s update.  -> (main, startup, loss, the two steps'
    feeds: x from 0.5 + U(0, 1), then twice that)."""
    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[n], dtype='float32',
                              append_batch_size=False)
        w = fluid.layers.create_parameter(
            [n], 'bfloat16', name='w',
            default_initializer=fluid.initializer.Constant(0.5))
        y = fluid.layers.elementwise_mul(fluid.layers.cast(x, 'bfloat16'), w)
        loss = fluid.layers.mean(fluid.layers.cast(y, 'float32'))
        make_opt(fluid.optimizer).minimize(loss)
    x1 = (0.5 + np.random.RandomState(SEED).rand(n)).astype('float32')
    return main, startup, loss, [{'x': x1}, {'x': 2 * x1}]


def phase_train_c11_gpu_vs_cpu():
    """C11 on the card: the program of c11_program under each update op of
    C11_RUNS, two steps on the card and on the CPU, each from its own
    startup (constants): every persistable's dtype after each step the
    CPU's (the parameter float32, as jnp promotes it), and its value
    within 2^-7 of the change the step made and one unit of its dtype
    (PyTorch's CPU sqrt is not correctly rounded; ftrl at lr_power -0.6
    computes pow, which no implementation rounds correctly: 2^-4); the
    update op's bf16 instance launched on the card (LarsMomentum: plain
    torch ops, none), no plain version on the card.  The card's plans of
    both steps (the bf16 parameter, then the promoted state) are made
    and built before the first step.  -> the card's launches over the
    two steps, by run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    runs = {k: c11_program(make) for k, (make, _) in C11_RUNS.items()}
    cpu = {}
    for run, (main, startup, loss, feeds) in runs.items():
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            states = [{n: t.clone() for n, t in scope.vars.items()}]
            for feed in feeds:
                exe.run(main, feed=feed, fetch_list=[loss])
                states.append({n: t.clone() for n, t in scope.vars.items()})
        cpu[run] = states
        for st, feed in zip(states, feeds):
            _planned_specs(main, feed, [loss.name], False, dtypes={
                n: t.dtype for n, t in st.items()})
        _planned_specs(startup, {}, [], False)
    kernelgen.ensure_built()
    paths = {}
    for run, (main, startup, loss, feeds) in runs.items():
        t0 = time.perf_counter()
        scope, exe = fluid.Scope(), fluid.Executor()
        kernels.reset_launches()
        worst, dtypes = 0.0, {}
        with fluid.scope_guard(scope), PlainCalls() as plain:
            exe.run(startup)
            for k, feed in enumerate(feeds):
                exe.run(main, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                before, after = cpu[run][k], cpu[run][k + 1]
                for n, want in after.items():
                    got = scope.vars[n]
                    dtypes[n] = str(got.dtype).replace('torch.', '')
                    require(got.dtype == want.dtype, 'C11 %s step %d: %s is '
                            '%s on the card, %s on the CPU' % (
                                run, k + 1, n, got.dtype, want.dtype))
                    w = want.double()
                    unit = torch.finfo(want.dtype).eps * w.abs().clamp_min(
                        torch.finfo(want.dtype).tiny)
                    rel = 2.0 ** (-4 if run == 'ftrl_pow' else -7)
                    tol = rel * (w - before[n].double()).abs() + unit
                    g = got.double().cpu()
                    # NaN where NaN; a NaN on one side only fails
                    d = (g - w).abs().masked_fill(g.isnan() & w.isnan(), 0)
                    worst = max(worst, float(torch.nan_to_num(
                        d / tol, nan=float('inf')).max()))
        launched = {k: v for k, v in kernels.launches.items() if v}
        paths['train_c11_' + run] = launched
        want_kernel = C11_RUNS[run][1]
        emit(phase='train_c11_gpu_vs_cpu', run=run, n=C11_N, steps=2,
             dtypes_after=dtypes, worst_share_of_tolerance=worst,
             launches=launched, plain_calls_on_cuda=plain.counts,
             seconds=time.perf_counter() - t0)
        require(worst <= 1.0, 'C11 %s: the card and the CPU differ past '
                'the tolerance (%.3g of it)' % (run, worst))
        # adadelta's update has no learning rate: a bf16 parameter stays
        # bf16, as in the reference
        want_w = 'bfloat16' if run == 'adadelta' else 'float32'
        require(dtypes['w'] == want_w, 'C11 %s: the parameter is %s'
                % (run, dtypes['w']))
        require(want_kernel is None or launched.get(want_kernel, 0) >= 1,
                'C11 %s: %s never launched (%s)' % (run, want_kernel,
                                                    launched))
        require(not plain.counts, 'C11 %s: plain versions ran on the card: '
                '%s' % (run, plain.counts))
    return paths


# ------------------------------------------------------------- main

_REPLACES = {
    'flash_attention_fwd': ('paddle_tpu_torch/csrc/flash_fwd.cu',
                            'paddle_tpu/ops/attention.py:52'),
    'embedding_gather': ('paddle_tpu_torch/csrc/gather.cu',
                         'paddle_tpu/ops/gather.py:34'),
    'flash_attention_bwd_dq': ('paddle_tpu_torch/csrc/flash_bwd.cu',
                               'paddle_tpu/ops/attention.py:125'),
    'flash_attention_bwd_dkv': ('paddle_tpu_torch/csrc/flash_bwd.cu',
                                'paddle_tpu/ops/attention.py:167'),
    'layer_norm': ('paddle_tpu_torch/csrc/layer_norm.cu',
                   'paddle_tpu/ops/kernelgen/rules.py:336'),
    'adam_multi': ('paddle_tpu_torch/csrc/adam.cu',
                   'paddle_tpu/ops/kernelgen/builder.py:795'),
    'adam_multi_bf16': ('paddle_tpu_torch/csrc/adam.cu',
                        'paddle_tpu/ops/kernelgen/builder.py:795'),
    'momentum_multi': ('paddle_tpu_torch/csrc/momentum.cu',
                       'paddle_tpu/ops/kernelgen/builder.py:795'),
    'softmax': ('paddle_tpu_torch/csrc/softmax.cu',
                'paddle_tpu/ops/kernelgen/rules.py:291'),
}
_REPLACES.update({k + '_multi': ('paddle_tpu_torch/csrc/optim_multi.cu',
                                 'paddle_tpu/ops/kernelgen/builder.py:929')
                  for k in OPTIM_CASES})
# C11's bf16 instances
_REPLACES.update({k + '_bf16': v for k, v in list(_REPLACES.items())
                  if k == 'momentum_multi' or k[:-6] in OPTIM_CASES})
# the instances of K1-K3, by the key phase_kernels files them under:
# (dtype, design, source, the paths that run it)
_PADDED_DESIGN = (
    'tensor cores (bf16 wgmma, float32 3xTF32), the padded instances DP = '
    '64 (D < 64) and 128 (64 < D < 128); ')
_OTHER_D = {
    'flash_attention_fwd': (
        _PADDED_DESIGN + 'timed at the served D = 96 batch (DP = 128), '
        'launched there and at the tiny llama\'s D = 16 (DP = 64)',
        'paddle_tpu_torch/csrc/flash_fwd.cu'),
    'flash_attention_bwd_dq': (
        _PADDED_DESIGN + 'timed at D = 96 (DP = 128), launched on its path '
        'at D = 16 (DP = 64)', 'paddle_tpu_torch/csrc/flash_bwd.cu')}
_OTHER_D['flash_attention_bwd_dkv'] = _OTHER_D['flash_attention_bwd_dq']
_INSTANCES = {
    'bfloat16': ('bfloat16', 'wgmma, tensor cores', None,
                 ('training', 'serving_bf16')),
    'float32': ('float32', None, None, ('serving', 'training_f32')),
    'float32_d128': ('float32', None, None, ('training_llama',)),
    'bfloat16_d128': ('bfloat16', 'wgmma, tensor cores, D = 128', None,
                      ('training_llama_bf16',)),
    'float32_other_d': ('float32', None, None,
                        ('serving_d96_f32', 'train_llama_tiny_f32')),
    'bfloat16_other_d': ('bfloat16', None, None,
                         ('serving_d96_bf16', 'train_llama_tiny_bf16')),
    'float32_d256': ('float32', None, None,
                     ('serving_d256_f32', 'training_llama_d256_f32',
                      'train_llama_gptj_f32')),
    'bfloat16_d256': ('bfloat16', 'wgmma, tensor cores, the instances of '
                      'width 256 (D 136-256; the products over rows '
                      'm64n256k16; dK/dV as dV and dK blocks)', None,
                      ('serving_d256_bf16', 'training_llama_d256',
                       'train_llama_gptj_amp')),
}
# the float32 designs of K1-K3 at each head dim
_F32_DESIGNS = {
    ('flash_attention_fwd', 'float32'): '3xTF32 wgmma, tensor cores',
    ('flash_attention_fwd', 'float32_d128'):
        '3xTF32 wgmma, tensor cores, D = 128',
    ('flash_attention_bwd_dq', 'float32'): '3xTF32 wgmma, tensor cores, '
                                           'D = 64',
    ('flash_attention_bwd_dq', 'float32_d128'):
        '3xTF32 wgmma, tensor cores, D = 128, 16-key ring tiles',
    ('flash_attention_bwd_dkv', 'float32'): '3xTF32 wgmma, tensor cores, '
                                            'D = 64',
    ('flash_attention_bwd_dkv', 'float32_d128'):
        '3xTF32 wgmma, tensor cores, D = 128, 16-row ring tiles',
    ('flash_attention_fwd', 'float32_d256'):
        '3xTF32 wgmma, tensor cores, the instance of width 256 (D 136-256; '
        '16-key tiles, V^T split from registers)',
    ('flash_attention_bwd_dq', 'float32_d256'):
        '3xTF32 wgmma, tensor cores, the instance of width 256 (D 136-256; '
        'clusters of two blocks splitting D, each 16-key ring tiles, partial '
        'S and dP exchanged through distributed shared memory)',
    ('flash_attention_bwd_dkv', 'float32_d256'):
        '3xTF32 wgmma, tensor cores, the instance of width 256 (D 136-256; '
        'clusters of two blocks splitting D, each 16-row ring tiles, partial '
        'S^T and dP^T exchanged through distributed shared memory)',
}
# every generated segment: the generator's source, the TPU generator
SEGMENT_SOURCE = ('paddle_tpu_torch/ops/kernelgen/builder.py',
                  'paddle_tpu/ops/kernelgen/builder.py:795')


# ------------------------------------------------- the sequence models

# the stacked dynamic-LSTM LM at models/stacked_lstm.py's defaults: dict
# 5147, emb and hid 512, 3 layers, 2 classes, Adam 0.002; B reviews of
# SL_LEN tokens (uniform), bucketed on T by FeedBucketer
SL_VOCAB, SL_EMB = 5147, 512
SL_B = 32
SL_LEN = (32, 512)
SL_STEPS = 10
# the recommender at models/simple.py's defaults, B rows; categories and
# title words a movie (uniform)
RC_B = 256
RC_CATS = (1, 6)
RC_TITLE = (1, 15)


def review_rows(rng, B, lens, vocab):
    """B synthetic IMDB-like reviews as DataFeeder rows (word ids, label):
    lengths uniform in `lens`, ids and labels from `rng`."""
    rows = []
    for _ in range(B):
        n = int(rng.randint(lens[0], lens[1] + 1))
        rows.append((rng.randint(0, vocab, n).astype('int64'),
                     [int(rng.randint(0, 2))]))
    return rows


def sl_program(seed=SEED, **kw):
    """models/stacked_lstm.build(**kw) through the port: (main, startup,
    out, DataFeeder, FeedBucketer on the words' T)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import stacked_lstm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = stacked_lstm.build(**kw)
    feeder = fluid.DataFeeder(out['feeds'], program=main)
    return main, startup, out, feeder, fluid.FeedBucketer(
        seq_names=('words',))


def sl_feed(feeder, bucketer, rows):
    """Reader rows -> the bucketed feed: a LoDTensor padded on T to its
    boundary, its lengths the reviews'."""
    feed, n = bucketer.bucket_feed(feeder.feed(rows))
    require(n == len(rows), 'the bucketer padded the batch: %d' % n)
    return feed


def rc_program(B=RC_B, seed=SEED, n_steps=1):
    """models/simple.py::recommender at its defaults (MovieLens-1M: 6041
    users, 3953 movies, 18 categories, title vocabulary 5175, dim 32,
    SGD 1e-3): (main, startup, out, feeds), n_steps bucketed feeds of B
    rows drawn from `seed`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import simple
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = simple.recommender()
    feeder = fluid.DataFeeder(out['feeds'], program=main)
    bucketer = fluid.FeedBucketer(seq_names=('category_id', 'movie_title'))
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n_steps):
        rows = [(rng.randint(0, 6041), rng.randint(0, 2), rng.randint(0, 7),
                 rng.randint(0, 21), rng.randint(0, 3953),
                 rng.randint(0, 18, rng.randint(RC_CATS[0], RC_CATS[1] + 1)),
                 rng.randint(0, 5175, rng.randint(RC_TITLE[0],
                                                  RC_TITLE[1] + 1)),
                 [rng.rand() * 5]) for _ in range(B)]
        feeds.append(bucketer.bucket_feed(feeder.feed(rows))[0])
    return main, startup, out, feeds


def _seq_group(name):
    """A profiler key's group in a stacked-LSTM step: the port's kernels
    (_group: K4, K5, K7's Adam and segments), the GEMMs (the
    projections and each step's h W, forward and backward), the
    elementwise functors the LSTM cell runs step by step (sigmoid, tanh,
    mul, add, sub, where and their backwards, the stacks and flips), the
    copies, the rest (the reductions: bias gradients, pooling, loss)."""
    own = _group(name)
    if own in KERNEL_GROUPS:
        return own
    low = name.lower()
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    if any(t in low for t in ('gemm', 'cutlass', 'sm90_', 'xmma', 'cublas',
                              'nvjet')):
        return 'gemm'
    if any(t in low for t in ('sigmoid', 'tanh', 'mulfunctor', 'add',
                              'sub', 'where', 'catarray', 'flip',
                              'copy_kernel', 'fill')):
        return 'recurrence_elementwise'
    return 'other'


def _seq_profile(fn):
    """One torch.profiler trace of fn() for both readings a LM step
    needs: (host wall ms, device busy ms, {_seq_group: device ms}, device
    events, {KERNEL_GROUPS group: device launches}, the wrappers' counts
    over the window, tries).  A window of two steps: a one-step trace lost
    its first kernel (K4) in three tries of three.  Taken again, up to
    PROFILE_TRIES times, while a counted group is missing or over its
    count on the device (the profiler drops events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels
    for tries in range(1, PROFILE_TRIES + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counted = {k: (v - before.get(k, 0)) * DEVICE_KERNELS.get(k, 1)
                   for k, v in kernels.launches.items()
                   if k in KERNEL_GROUPS and v != before.get(k, 0)}
        by_group, groups, seen = {}, {}, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            g = _group(e.key)
            if g in KERNEL_GROUPS:
                groups[g] = groups.get(g, 0) + e.count
            if e.self_device_time_total:
                k = _seq_group(e.key)
                by_group[k] = by_group.get(k, 0.0) + \
                    e.self_device_time_total / 1e3
                seen += e.count
        if all(0 < groups.get(g, 0) <= counted.get(g, 0)
               for g in set(groups) | set(counted)):
            break
    return wall, sum(by_group.values()), by_group, seen, groups, counted, \
        tries


def phase_training_stacked_lstm(smi):
    """The stacked dynamic-LSTM LM at full width (dict 5147, emb and hid
    512, 3 layers, layers 2 and 3 alternating is_reverse), B SL_B
    reviews of SL_LEN tokens fed through DataFeeder (a LoDTensor) and
    FeedBucketer (T bucketed: every batch here falls in the 512 bucket),
    Adam (csrc/adam.cu): an interpreted first step, the capture, SL_STEPS
    graph steps on one fixed batch (ms median and range, examples/s, real
    tokens/s: the sum of the lengths), then two batches of other lengths
    in the same bucket (replays of the one graph); a profile of a graph
    steps by group (_seq_profile: device busy, idle share, the launches
    on the profiler), peak memory,
    the captured graphs, launches a step.  Gates: finite losses, the
    fixed batch's loss below its first after the timed steps, K4, K5 and
    one adam_multi a step, no plain version on the card.  -> launches a
    step."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    main, startup, out, feeder, bucketer = sl_program()
    rng = np.random.RandomState(SEED)
    fixed = review_rows(rng, SL_B, SL_LEN, SL_VOCAB)
    others = [review_rows(rng, SL_B, SL_LEN, SL_VOCAB) for _ in range(2)]
    feed = sl_feed(feeder, bucketer, fixed)
    T = feed['words'].padded.shape[1]
    tokens = int(feed['words'].lengths.sum())
    params = [p for p in main.all_parameters() if p.trainable]
    emit(phase='training_stacked_lstm', step='config', B=SL_B,
         cfg=dict(dict_dim=SL_VOCAB, emb_dim=SL_EMB, hid_dim=512,
                  stacked_num=3, class_dim=2), optimizer='Adam(lr=0.002)',
         lengths=list(SL_LEN), T_bucket=T, real_tokens=tokens,
         params=sum(int(np.prod(p.shape)) for p in params),
         reduced='review lengths 32-512 tokens (uniform) for the time limit')
    fetch = [out['loss']]
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope), PlainCalls() as plain:
        exe.run(startup)
        torch.cuda.synchronize()
        # the earlier phases' cached blocks out of this phase's reading
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = []

        def step(f):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=f,
                                        fetch_list=fetch)[0][0]))
            return (time.perf_counter() - t0) * 1e3
        first_ms = step(feed)       # interpreted: builds the kernels
        capture_ms = step(feed)     # capture, then replay
        kernels.reset_launches()
        kernelgen.launches.clear()
        graph_ms = [step(feed) for _ in range(SL_STEPS)]
        launches = {k: v / SL_STEPS for k, v in kernels.launches.items()
                    if v}
        seg = {k: v / SL_STEPS for k, v in kernelgen.launches.items()}
        step(feed)
        last = losses[-1]
        other_feeds = [sl_feed(feeder, bucketer, r) for r in others]
        other_ms = [step(f) for f in other_feeds]
        mem = _peak_memory()
        entries = [e for e in exe._graphs.entries.values()
                   if e.graph is not None]

        wall, busy, by_group, seen, groups, counted, tries = _seq_profile(
            lambda: [exe.run(main, feed=feed, fetch_list=fetch)
                     for _ in range(2)])
    med = float(np.median(graph_ms))
    emit(phase='training_stacked_lstm', step='steps', B=SL_B, T_bucket=T,
         losses=losses, first_step_ms=first_ms, capture_step_ms=capture_ms,
         capture_s=[e.capture_s for e in entries],
         captured_graphs=len(entries), graph_step_ms=graph_ms,
         median_graph_step_ms=med, min_graph_step_ms=min(graph_ms),
         max_graph_step_ms=max(graph_ms), examples_per_s=SL_B / med * 1e3,
         real_tokens_per_s=tokens / med * 1e3,
         padded_tokens_per_s=SL_B * T / med * 1e3,
         other_batches=dict(T=[f['words'].padded.shape[1]
                               for f in other_feeds],
                            real_tokens=[int(f['words'].lengths.sum())
                                         for f in other_feeds],
                            step_ms=other_ms),
         launches_per_step=launches,
         segment_launches_per_step=sum(seg.values()),
         plain_calls_on_cuda=plain.counts, card=smi, **mem)
    emit(phase='training_stacked_lstm', step='graph_profile', steps=2,
         profiled_wall_ms=wall, device_busy_ms=busy,
         device_idle_share=(1 - busy / wall) if busy else None,
         device_ms_by_group=by_group,
         device_share_by_group={k: v / busy for k, v in by_group.items()},
         device_events=seen, device_launches=groups,
         counted_device_launches=counted, profile_tries=tries, card=smi)
    _seen_on_device('training_stacked_lstm graph', groups, counted)
    require(all(np.isfinite(losses)), 'non-finite stacked_lstm loss: %s'
            % losses)
    require(last < losses[0], 'stacked_lstm: the fixed batch\'s loss %s '
            'after %d steps is not below its first, %s'
            % (last, SL_STEPS + 2, losses[0]))
    require(len(entries) == 1 and all(
        f['words'].padded.shape[1] == T for f in other_feeds),
            'stacked_lstm: %d graphs for one T bucket' % len(entries))
    require(not plain.counts, 'plain versions ran on the card: %s'
            % plain.counts)
    require(launches.get('embedding_gather') == 1 and
            launches.get('softmax') == 1 and
            launches.get('adam_multi') == 1 and
            launches.get('kernelgen_segment', 0) >= 1,
            'stacked_lstm: launches a step %s, expected one K4, one K5, one '
            'adam_multi and the generated segments' % launches)
    launches.update(seg)
    return launches


# train_seq_gpu_vs_cpu: the LM at narrow widths
SEQ_SMALL = dict(dict_dim=SL_VOCAB, emb_dim=64, hid_dim=64, stacked_num=3)
SEQ_SMALL_B = 8
SEQ_SMALL_LEN = (3, 40)
SEQ_SMALL_LR = 0.002
RC_SMALL_STEPS = 3


def _seq_small_feeds(feeder, bucketer, rng):
    """The LM's card-vs-CPU feeds: three batches of SEQ_SMALL_LEN
    reviews, then one more with other lengths in the bucket of the last
    (so the second, third and fourth run one graph's replays, the lengths
    a feed of each), then a dense [B, T, 1] array of that bucket into the
    lod var (full lengths synthesized) -> (feeds, what each is)."""
    feeds = []
    while len(feeds) < 4:
        f = sl_feed(feeder, bucketer, review_rows(
            rng, SEQ_SMALL_B, SEQ_SMALL_LEN, SL_VOCAB))
        # the bucket of 48: reviews of 33-40 tokens at the longest
        if f['words'].padded.shape[1] == 48 and all(
                not np.array_equal(f['words'].lengths, g['words'].lengths)
                for g in feeds):
            feeds.append(f)
    dense = {'words': rng.randint(0, SL_VOCAB, (SEQ_SMALL_B, 48, 1))
             .astype('int64'),
             'label': rng.randint(0, 2, (SEQ_SMALL_B, 1)).astype('int64')}
    return feeds + [dense], ['lod'] * 4 + ['dense']


def phase_train_seq_gpu_vs_cpu():
    """The sequence models on the card against Executor(CPUPlace()) from
    one startup state (weights carried across by scope_from_numpy): the
    LM at SEQ_SMALL (dict 5147, emb and hid 64, 3 layers), B 8, Adam,
    over _seq_small_feeds (three steps, a fourth batch of the same T
    bucket with other lengths, a dense array into the lod var); the
    recommender at its defaults, B RC_B, RC_SMALL_STEPS SGD steps.  Each
    loss within 1e-5 relative; every parameter within 2.01 x the summed
    learning rate (each entry moves at most lr a step under Adam, PERF.md
    section 2).  Then the LM's `predict` saved by save_inference_model,
    loaded by Predictor on the card and on the CPU, run on a LoDTensor
    feed twice (interpreted, then the graph): the loaded program reads
    the lengths companion, the card within 1e-4 of the largest output of
    the CPU.  -> launches a step on the card, by run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    paths = {}
    rng = np.random.RandomState(SEED + 2)
    main, startup, out, feeder, bucketer = sl_program(
        lr=SEQ_SMALL_LR, **SEQ_SMALL)
    lm_feeds, kinds = _seq_small_feeds(feeder, bucketer, rng)
    rmain, rstartup, rout, rc_feeds = rc_program(n_steps=RC_SMALL_STEPS)
    from paddle_tpu_torch.core.executor import normalize_feed as norm
    for m, s, o, f in ((main, startup, out, lm_feeds[0]),
                       (rmain, rstartup, rout, rc_feeds[0])):
        _planned_specs(m, norm(m.global_block(), f), [o['loss'].name],
                       False)
        _planned_specs(s, {}, [], False)
    kernelgen.ensure_built()
    scopes = {}
    for run, (m, s, o, feeds, lr) in (
            ('stacked_lstm', (main, startup, out, lm_feeds, SEQ_SMALL_LR)),
            ('recommender', (rmain, rstartup, rout, rc_feeds, 1e-3))):
        t0 = time.perf_counter()
        gscope = fluid.Scope()
        with fluid.scope_guard(gscope):
            fluid.Executor().run(s)
        init = {n: t.cpu().numpy() for n, t in gscope.vars.items()}
        params = [p.name for p in m.all_parameters() if p.trainable]
        res = {}
        for dev in ('gpu', 'cpu'):
            scope = fluid.scope_from_numpy(
                {n: a.copy() for n, a in init.items()}, fluid.Scope(),
                'cuda' if dev == 'gpu' else 'cpu')
            exe = fluid.Executor() if dev == 'gpu' else \
                fluid.Executor(fluid.CPUPlace())
            if dev == 'gpu':
                kernels.reset_launches()
            losses = []
            with fluid.scope_guard(scope), PlainCalls() as plain:
                for f in feeds:
                    losses.append(float(exe.run(
                        m, feed=f, fetch_list=[o['loss']])[0][0]))
            if dev == 'gpu':
                paths['train_seq_' + run] = {
                    k: v / len(feeds) for k, v in kernels.launches.items()
                    if v}
                graphs = len([e for e in exe._graphs.entries.values()
                              if e.graph is not None])
                require(not plain.counts, 'plain versions ran on the card: '
                        '%s' % plain.counts)
            res[dev] = dict(losses=losses, params={
                p: scope.vars[p].double().cpu().numpy() for p in params})
            scopes[run, dev] = scope
        gl, cl = res['gpu']['losses'], res['cpu']['losses']
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        bound = 2.01 * lr * len(feeds)
        dist = max(float(np.abs(res['gpu']['params'][p] -
                                res['cpu']['params'][p]).max())
                   for p in params)
        emit(phase='train_seq_gpu_vs_cpu', run=run, steps=len(feeds),
             feeds=kinds if run == 'stacked_lstm' else ['lod'] * len(feeds),
             T=[(f['words'] if run == 'stacked_lstm' else
                 f['movie_title']).shape[1] for f in feeds],
             lengths=[getattr(f.get('words'), 'lengths', np.zeros(0))
                      .tolist() for f in feeds],
             gpu_losses=gl, cpu_losses=cl, loss_max_rel=loss_rel,
             param_max_abs_diff=dist, param_bound=bound,
             captured_graphs=graphs, launches_per_step=paths[
                 'train_seq_' + run], seconds=time.perf_counter() - t0)
        require(all(np.isfinite(gl + cl)) and loss_rel <= 1e-5,
                'train_seq_gpu_vs_cpu (%s): losses %s vs %s' % (run, gl, cl))
        require(dist <= bound, 'train_seq_gpu_vs_cpu (%s): a parameter '
                '%.3g apart, bound %.3g' % (run, dist, bound))
    want = {'stacked_lstm': ('adam_multi', 1), 'recommender':
            ('sgd_multi', 1)}
    for run, (k, n) in want.items():
        got = paths['train_seq_' + run]
        require(got.get(k) == n and got.get('embedding_gather') == (
            1 if run == 'stacked_lstm' else 7) and
            got.get('kernelgen_segment', 0) >= 1 and
            (run != 'stacked_lstm' or got.get('softmax') == 1),
            '%s: launches a step %s' % (run, got))
    # the LM's predict through save_inference_model and the Predictor
    test = main.clone(for_test=True)
    pfeed = {'words': fluid.create_lod_tensor(
        [rng.randint(0, SL_VOCAB, (n, 1)) for n in (17, 3, 40, 9)])}
    outs = {}
    with tempfile.TemporaryDirectory(prefix='seq_predict_') as d:
        with fluid.scope_guard(scopes['stacked_lstm', 'gpu']):
            fluid.io.save_inference_model(d, ['words'], [out['predict']],
                                          fluid.Executor(),
                                          main_program=test)
        for dev in ('gpu', 'cpu'):
            cfg = fluid.inference.AnalysisConfig(d)
            if dev == 'cpu':
                cfg.disable_gpu()
            pred = fluid.inference.Predictor(cfg)
            blk = pred._program.global_block()
            lstm_len = [op.inputs.get('Length') for op in blk.ops
                        if op.type == 'lstm']
            require(blk.var('words').lod_length_name == 'words@LENGTH' and
                    lstm_len and all(x == ['words@LENGTH']
                                     for x in lstm_len),
                    'the loaded program does not read the lengths: %s'
                    % lstm_len)
            outs[dev] = [pred.run(pfeed)[0] for _ in range(2)]
    ref = outs['cpu'][0]
    err = max(float(np.abs(o - ref).max()) for o in outs['gpu'])
    tol = 1e-4 * float(np.abs(ref).max())
    emit(phase='train_seq_gpu_vs_cpu', run='predictor', feed='LoDTensor',
         lengths=pfeed['words'].lengths.tolist(), max_abs_err=err, tol=tol)
    require(err <= tol, 'the LoD Predictor on the card: %.3g from the CPU, '
            'bound %.3g' % (err, tol))
    return paths


# --------------------------------------- recompute and Fluid's own loss

RECOMPUTE_STEPS = 3   # steps of each program compared in training_recompute
RECOMPUTE_TIMED = 5   # graph replays timed after them


def _remat_program(fluid, tr, cfg, remat, chain=False):
    """transformer-base at `cfg` with models/transformer.py::build's Adam
    on noam_decay (scale 2.0, warmup 8000), under bf16 AMP; its forward
    (`transformer`) built inside one recompute_scope() when `remat`.  With
    `chain` it minimizes Fluid's own loss on the logits: one_hot(lbl) ->
    label_smooth(0.1) -> softmax_with_cross_entropy(soft_label=True),
    under the model's pad mask and token mean (the token weights 1 - pad
    as one `scale` next to the smoothing, so that the rewriter fuses the
    two into one generated segment).  -> (main, startup, loss minimized,
    the model's fused closed-form loss, probes): with `chain`, `probes`
    maps 'chain' and 'closed' to their unmasked per-token losses and each
    planted fault ('eps_0.09': the chain smoothing by 0.09, 'unsmoothed':
    the chain on the bare one_hot) to its (per-token, mean) losses.  The
    faults are built after the optimizer, so a run that does not fetch
    them prunes them (dce) and runs the program as it was."""
    import contextlib
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    probes = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        with (fluid.recompute_scope() if remat else
              contextlib.nullcontext()):
            out = tr.transformer(label_smooth_eps=0.1, **cfg)
        loss = out['loss']
        if chain:
            lbl, trg_pad = out['feeds'][2], out['feeds'][4]
            soft = layers.label_smooth(
                layers.one_hot(lbl, cfg['trg_vocab']), epsilon=0.1)
            w = layers.scale(trg_pad, scale=-1.0, bias=1.0)
            tok = layers.softmax_with_cross_entropy(
                out['logits'], soft, soft_label=True)
            per_tok = layers.elementwise_mul(
                layers.squeeze(tok, axes=[2]), w)
            loss = layers.elementwise_div(layers.reduce_sum(per_tok),
                                          layers.reduce_sum(w))
            blk = main.global_block()
            closed, = [op.outputs['Loss'][0] for op in blk.ops
                       if op.type == 'softmax_with_cross_entropy' and
                       op.attrs.get('label_smooth_eps')]
            probes.update(chain=tok, closed=blk.var(closed))

            def chain_loss(eps):
                soft = layers.one_hot(lbl, cfg['trg_vocab'])
                if eps:
                    soft = layers.label_smooth(soft, epsilon=eps)
                tok = layers.softmax_with_cross_entropy(
                    out['logits'], soft, soft_label=True)
                per_tok = layers.elementwise_mul(
                    layers.squeeze(tok, axes=[2]), w)
                return tok, layers.elementwise_div(
                    layers.reduce_sum(per_tok), layers.reduce_sum(w))
        lr = layers.scale(layers.noam_decay(cfg['d_model'], 8000),
                          scale=2.0)
        fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                             epsilon=1e-9).minimize(loss)
        if chain:
            probes.update({'eps_0.09': chain_loss(0.09),
                           'unsmoothed': chain_loss(0.0)})
    main.set_amp(True)
    return main, startup, loss, out['loss'], probes


def _noam_lrs(steps, d_model=512, warmup=8000, scale=2.0):
    return [scale * d_model ** -0.5 * min(t ** -0.5, t * warmup ** -1.5)
            for t in range(1, steps + 1)]


def _live_peak(snapshot):
    """The most bytes the captured step's own tensors held at once: each
    allocation the recorded run made in a CUDA graph's private pool, its
    requested size from its alloc to its free (the allocator's trace,
    torch.cuda.memory._snapshot).  Left out: what the run allocated
    outside the capture, the same in every program but the state of each
    generator the capture registers (one a random draw, 16 bytes).  The
    allocator's own peak counts blocks, which it may leave up to 1 MiB
    larger than the tensor in them, as the order of earlier allocations
    decides."""
    import torch
    pools = [(seg['address'], seg['address'] + seg['total_size'])
             for seg in snapshot['segments']
             if tuple(seg['segment_pool_id']) != (0, 0)]
    require(pools, 'the captured run allocated in no graph pool')
    live, cur, best = {}, 0, 0
    for ev in snapshot['device_traces'][torch.cuda.current_device()]:
        if ev['action'] == 'alloc' and any(lo <= ev['addr'] < hi
                                           for lo, hi in pools):
            live[ev['addr']] = ev['size']
            cur += ev['size']
            best = max(best, cur)
        elif ev['action'] == 'free_requested' and ev['addr'] in live:
            cur -= live.pop(ev['addr'])
    return best


def _train_steps(exe, main, feed, fetch, steps):
    """`steps` runs of main (the first interpreted on the side stream, the
    second captured, the rest replays) -> (fetches by step, peak bytes
    allocated in each run above the bytes allocated before it, the live
    tensors' peak bytes in the captured run (`_live_peak`), launches a
    step by kernel, generated-segment launches a step by function)."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import kernelgen
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernelgen.launches.clear()
    outs, peaks, live = [], [], None
    for k in range(steps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if k == 1:
            torch.cuda.memory._record_memory_history(max_entries=1 << 20)
        outs.append([np.asarray(v) for v in exe.run(main, feed=feed,
                                                    fetch_list=fetch)])
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if k == 1:
            live = _live_peak(torch.cuda.memory._snapshot())
            torch.cuda.memory._record_memory_history(enabled=None)
    per = {k: v / steps for k, v in kernels.launches.items() if v}
    seg = {k: v / steps for k, v in kernelgen.launches.items() if v}
    return outs, peaks, live, per, seg


def _free(scope, exe):
    """Give an executor's CUDA graphs and a scope's tensors back to the
    card: a graph entry and its executor refer to each other, so only a
    collection frees the graphs' private pools."""
    import gc
    import torch
    exe.close()
    scope.vars.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _timed_replays(exe, main, feed, fetch, n=RECOMPUTE_TIMED):
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_training_recompute(smi):
    """transformer-base at full width and depth under bf16 AMP, B 32, T
    256, at COMPOSED_CFG (dropout 0.1, composed attention: the dropout
    masks must replay, K5, K6 and the dropout segments run again in the
    backward) and at BENCH_CFG (flash, dropout 0: K1 runs again in the
    backward): at each, the plain program and the one whose forward is
    built inside one recompute_scope(), from one seed and the same
    weights, RECOMPUTE_STEPS steps each (interpreted, captured, replayed).
    Step 1's loss is bit for bit the plain program's; the losses after
    within 1e-5 relative and every parameter within 1e-5 relative plus
    2.01 x the summed learning rates (an Adam update moves an entry by
    about lr whatever its gradient, so float noise in a gradient may move
    it either way); the recompute's graph step equals its interpreted step
    bit for bit (bitwise_paths, one step); the peak memory of the
    recompute's interpreted and captured step is no higher than the plain
    program's (the interpreted step's as the allocator counts it, the
    captured step's as its live tensors' bytes, `_live_peak`: the
    allocator's count of a captured step moves by a few hundred KiB with
    the order its blocks were carved in).  Printed beside the card: step
    ms of RECOMPUTE_TIMED replays, those peaks, launches a step (K1 twice
    the plain program's at BENCH_CFG, K5 twice at COMPOSED_CFG).  ->
    launches a step of the recompute programs, by path."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    B, T = 32, BENCH_CFG['max_len']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T,
                              BENCH_CFG['trg_vocab'])
    paths = {}
    lr_atol = 2.01 * sum(_noam_lrs(RECOMPUTE_STEPS))
    for name, cfg, twice in (('composed', COMPOSED_CFG, 'softmax'),
                             ('flash', BENCH_CFG, 'flash_attention_fwd')):
        t0 = time.perf_counter()
        init, res = None, {}
        for remat in (False, True):
            main, startup, loss, _, _ = _remat_program(fluid, tr, cfg, remat)
            scope, exe = fluid.Scope(), fluid.Executor()
            with fluid.scope_guard(scope):
                if init is None:
                    exe.run(startup)
                    init = {n: t.clone() for n, t in scope.vars.items()}
                else:
                    for n, t in init.items():
                        scope.vars[n] = t.clone()
                outs, peaks, live, per, seg = _train_steps(
                    exe, main, feed, [loss], RECOMPUTE_STEPS)
                params = {p.name: scope.vars[p.name].detach().clone()
                          for p in main.all_parameters()}
                ms = _timed_replays(exe, main, feed, [loss])
                if remat:
                    bitwise_paths('training_recompute', exe, main, scope,
                                  feed, [loss], n=1)
            res[remat] = dict(losses=[float(o[0].reshape(-1)[0])
                                      for o in outs], peaks=peaks, live=live,
                              per=per,
                              seg=seg, params=params, ms=ms)
            _free(scope, exe)
            del scope, exe
        plain, rem = res[False], res[True]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(rem['losses'], plain['losses']))
        p_err, p_ok, bitwise = 0.0, True, True
        for n, t in rem['params'].items():
            d = (t.float() - plain['params'][n].float()).abs()
            p_err = max(p_err, float(d.max()))
            p_ok &= bool((d <= 1e-5 * plain['params'][n].float().abs() +
                          lr_atol).all())
            bitwise &= bool(torch.equal(t, plain['params'][n]))
        emit(phase='training_recompute', config=name, cfg=cfg, amp=True,
             B=B, T=T, steps=RECOMPUTE_STEPS,
             plain_losses=plain['losses'], recompute_losses=rem['losses'],
             step1_bitwise=rem['losses'][0] == plain['losses'][0],
             loss_max_rel=loss_rel, param_max_abs_diff=p_err,
             param_atol=lr_atol, param_rtol=1e-5, params_bitwise=bitwise,
             plain_step_ms=plain['ms'], recompute_step_ms=rem['ms'],
             plain_median_step_ms=float(np.median(plain['ms'])),
             recompute_median_step_ms=float(np.median(rem['ms'])),
             plain_peak_gb_interpreted=plain['peaks'][0] / 1e9,
             recompute_peak_gb_interpreted=rem['peaks'][0] / 1e9,
             plain_peak_gb_capture=plain['peaks'][1] / 1e9,
             recompute_peak_gb_capture=rem['peaks'][1] / 1e9,
             peak_bytes=dict(plain=plain['peaks'][:2],
                             recompute=rem['peaks'][:2]),
             live_peak_bytes_capture=dict(plain=plain['live'],
                                          recompute=rem['live']),
             plain_launches_per_step=plain['per'],
             recompute_launches_per_step=rem['per'],
             plain_segment_launches_per_step=sum(plain['seg'].values()),
             recompute_segment_launches_per_step=sum(rem['seg'].values()),
             seconds=time.perf_counter() - t0, card=smi)
        require(all(np.isfinite(plain['losses'] + rem['losses'])),
                'training_recompute (%s): non-finite loss' % name)
        require(rem['losses'][0] == plain['losses'][0],
                'training_recompute (%s): step 1 loss %r, plain %r'
                % (name, rem['losses'][0], plain['losses'][0]))
        require(loss_rel <= 1e-5, 'training_recompute (%s): losses %s vs '
                '%s' % (name, rem['losses'], plain['losses']))
        require(p_ok, 'training_recompute (%s): a parameter %.3g apart '
                '(bound 1e-5 relative + %.3g)' % (name, p_err, lr_atol))
        require(rem['peaks'][0] <= plain['peaks'][0] and
                rem['live'] <= plain['live'],
                'training_recompute (%s): peak bytes of the interpreted step '
                '%d, plain %d; live peak bytes of the captured step %d, plain '
                '%d' % (name, rem['peaks'][0], plain['peaks'][0], rem['live'],
                        plain['live']))
        require(rem['per'].get(twice) == 2 * plain['per'].get(twice, 0) > 0,
                'training_recompute (%s): %s launches a step %s, plain %s'
                % (name, twice, rem['per'].get(twice),
                   plain['per'].get(twice)))
        paths['training_recompute_' + name] = dict(rem['per'], **rem['seg'])
    return paths


def _segments_with(main, fetch_names, op_type):
    """Names of the generated functions, among the plans the fused ops of
    main's optimized twin used, whose segment runs an `op_type` sub-op."""
    from paddle_tpu_torch.core import passes
    from paddle_tpu_torch.ops import kernelgen
    opt, _ = passes.maybe_optimize(main, fetch_names)
    names = []
    for op in opt.global_block().ops:
        if op.type != 'fused_elementwise':
            continue
        plan = kernelgen.plan_of(op.attrs)
        for st in (plan.steps if plan is not None else ()):
            if st[0] == 'kernel' and any(sub['type'] == op_type
                                         for sub, *_ in st[1].ops):
                names.append(st[1].name)
    return names


def phase_training_fluid_loss(smi):
    """transformer-base at BENCH_CFG (flash, dropout 0: both losses see
    the same logits), bf16 AMP, B 32, T 256, minimizing Fluid's own
    `one_hot -> label_smooth -> softmax_with_cross_entropy(soft_label)`
    chain on the logits, the model's fused closed form fetched beside it:
    RECOMPUTE_STEPS steps, then RECOMPUTE_TIMED timed replays, then one
    run that fetches the per-token losses and the planted faults
    (`_remat_program`'s probes).

    Per token, the chain sums V = 32000 terms soft_j (-logp_j) of one
    sign and the closed form a mean of V terms -logp_j: each float32 sum
    rounds V times, each rounding within 2^-24 of the partial sum, so its
    error has a standard deviation of at most sqrt(V / 3) 2^-24 of the
    token's loss, and the two forms' difference at most sqrt(2 V / 3)
    2^-24.  The limits: the token mean within sqrt(V) 2^-24 relative
    (1.07e-5; the mean of 8000 tokens' errors shrinks further), each real
    token within 8 sqrt(V) 2^-24 relative (9.8 standard deviations).  A
    fault moves a token by eps |logp_true - mean_j logp_j| or, for the
    chain at 0.09, by 0.01 of it: the run reads both faults and fails
    unless each token check sees both and the mean check sees the
    unsmoothed one.  Printed: step ms, peak memory of the interpreted and
    the captured step (the chain holds [B, T, V] float32 buffers the
    closed form never builds), and label_smooth's generated segment with
    its launches a step.  -> its launches a step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tr
    B, T, V = 32, BENCH_CFG['max_len'], BENCH_CFG['trg_vocab']
    feed = tr.synthetic_batch(np.random.RandomState(0), B, T, V)
    feed['trg_pad'][5, 180:] = 1.0      # a ragged row: the mask matters
    main, startup, loss, fused, probes = _remat_program(
        fluid, tr, BENCH_CFG, False, chain=True)
    faults = ('eps_0.09', 'unsmoothed')
    probe_fetch = [loss, fused, probes['chain'], probes['closed']] + [
        v for f in faults for v in probes[f]]
    scope, exe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(startup)
        outs, peaks, _, per, seg = _train_steps(
            exe, main, feed, [loss, fused], RECOMPUTE_STEPS)
        ms = _timed_replays(exe, main, feed, [loss, fused])
        got = [np.asarray(v, 'float64') for v in exe.run(
            main, feed=feed, fetch_list=probe_fetch)]
    smooth = _segments_with(main, [loss.name, fused.name], 'label_smooth')
    chain = [float(o[0].reshape(-1)[0]) for o in outs]
    closed = [float(o[1].reshape(-1)[0]) for o in outs]
    rel = np.sqrt(V) * 2.0 ** -24
    bound = [rel * abs(c) for c in chain]
    diff = [abs(a - b) for a, b in zip(chain, closed)]
    real = feed['trg_pad'].reshape(-1) == 0
    ref_tok = got[3].reshape(-1)[real]

    def tok_rel(t):
        return float((np.abs(t.reshape(-1)[real] - ref_tok) /
                      np.abs(ref_tok)).max())
    ref_mean = float(got[1].reshape(-1)[0])
    readings = {'sound': dict(mean_rel=abs(float(got[0].reshape(-1)[0]) -
                                           ref_mean) / abs(ref_mean),
                              token_max_rel=tok_rel(got[2]))}
    for k, f in enumerate(faults):
        readings[f] = dict(
            mean_rel=abs(float(got[5 + 2 * k].reshape(-1)[0]) - ref_mean) /
            abs(ref_mean), token_max_rel=tok_rel(got[4 + 2 * k]))
    emit(phase='training_fluid_loss', config='transformer-base',
         cfg=BENCH_CFG, amp=True, B=B, T=T, steps=RECOMPUTE_STEPS,
         chain_losses=chain, closed_form_losses=closed, abs_diff=diff,
         bound=bound, mean_rtol=rel, token_rtol=8 * rel, readings=readings,
         step_ms=ms, median_step_ms=float(np.median(ms)),
         peak_gb_interpreted=peaks[0] / 1e9, peak_gb_capture=peaks[1] / 1e9,
         launches_per_step=per, label_smooth_segments=smooth,
         label_smooth_segment_launches_per_step={
             n: seg.get(n, 0) for n in smooth}, card=smi)
    _free(scope, exe)
    del scope, exe
    require(all(np.isfinite(chain + closed)) and all(
        np.isfinite(g).all() for g in got),
            'training_fluid_loss: non-finite loss')
    require(all(d <= b for d, b in zip(diff, bound)) and
            readings['sound']['mean_rel'] <= rel,
            'training_fluid_loss: the chain %s against the closed form %s, '
            'bound %s; %s' % (chain, closed, bound, readings['sound']))
    require(readings['sound']['token_max_rel'] <= 8 * rel,
            'training_fluid_loss: a token\'s chain loss %.3g relative from '
            'the closed form, bound %.3g' % (
                readings['sound']['token_max_rel'], 8 * rel))
    require(all(readings[f]['token_max_rel'] > 8 * rel for f in faults) and
            readings['unsmoothed']['mean_rel'] > rel,
            'training_fluid_loss: a planted fault passes the checks: %s'
            % readings)
    require(smooth and all(seg.get(n, 0) >= 1 for n in smooth),
            'training_fluid_loss: label_smooth ran in no generated segment: '
            '%s, %s' % (smooth, seg))
    return dict(per, **seg)


class _OpCtx(object):
    """A port op context on one device, its draws from one fixed seed."""
    recomputing = False

    def __init__(self, device):
        import torch
        self.device = torch.device(device)

    def generator(self, seed=0):
        import torch
        return torch.Generator(device=self.device).manual_seed(5)

    def wants(self, slot):
        return True

    def upload(self, host):
        import torch
        return torch.from_numpy(host).to(self.device)


def _r(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype('float32')


def _specials(rng, *shape):
    x = _r(rng, *shape)
    x.reshape(-1)[:8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 2.0, -3.0, 2.0]
    return x


# the dense ops on the card against the port's CPU run at small sizes:
# name -> (op, inputs(rng), attrs, tolerance: 'exact', or a fraction of
# the CPU output's largest magnitude where cuDNN's or a reduction's order
# differs from the CPU's)
GVC_OPS = {
    'sce_soft': ('softmax_with_cross_entropy', lambda r: {
        'Logits': _r(r, 4, 6, 9, scale=3),
        'Label': np.full((4, 6, 9), 1 / 9.0, 'float32')},
        {'soft_label': True}, 1e-6),
    'sce_axis1_smooth': ('softmax_with_cross_entropy', lambda r: {
        'Logits': _r(r, 3, 9, 4, scale=3), 'Label': r.randint(
            -2, 11, (3, 1, 4)).astype('int32')},
        {'axis': 1, 'label_smooth_eps': 0.1, 'ignore_index': 10}, 1e-6),
    'reduce_mean': ('reduce_mean', lambda r: {'X': _r(r, 8, 300)},
                    {'dim': [1]}, 1e-6),
    'reduce_max': ('reduce_max', lambda r: {'X': _specials(r, 6, 50)},
                   {'dim': [1]}, 'exact'),
    'reduce_min': ('reduce_min', lambda r: {'X': _r(r, 6, 50)},
                   {'reduce_all': True}, 'exact'),
    'reduce_prod': ('reduce_prod', lambda r: {'X': 1 + 0.01 * _r(r, 5, 40)},
                    {'dim': [1]}, 1e-6),
    'reduce_prod_int': ('reduce_prod', lambda r: {
        'X': r.randint(-3, 4, (4, 9)).astype('int32')}, {'dim': [1]},
        'exact'),
    'reduce_all': ('reduce_all', lambda r: {'X': r.rand(5, 7) > 0.2},
                   {'dim': [1]}, 'exact'),
    'reduce_any': ('reduce_any', lambda r: {'X': _specials(r, 5, 7)},
                   {'dim': [0], 'keep_dim': True}, 'exact'),
    'prelu': ('prelu', lambda r: {'X': _specials(r, 2, 3, 4, 4),
                                  'Alpha': _r(r, 3)}, {'mode': 'channel'},
              'exact'),
    'l2_normalize': ('l2_normalize', lambda r: {'X': _r(r, 6, 33)},
                     {'axis': 1}, 1e-6),
    'isfinite': ('isfinite', lambda r: {'X': _specials(r, 4, 4)}, {},
                 'exact'),
    'has_nan': ('has_nan', lambda r: {'X': _r(r, 4, 4)}, {}, 'exact'),
    'maxout': ('maxout', lambda r: {'X': _r(r, 2, 6, 5, 5)}, {'groups': 2},
               'exact'),
    'flatten': ('flatten', lambda r: {'X': _r(r, 2, 3, 4)}, {'axis': 2},
                'exact'),
    'stack': ('stack', lambda r: {'X': [_r(r, 3, 4), _r(r, 3, 4)]},
              {'axis': 1}, 'exact'),
    'unstack': ('unstack', lambda r: {'X': _r(r, 3, 4)}, {'axis': 1},
                'exact'),
    'expand': ('expand', lambda r: {'X': _r(r, 2, 3)},
               {'expand_times': [3, 2]}, 'exact'),
    'expand_as': ('expand_as', lambda r: {'X': _r(r, 1, 3), 'target_tensor':
                                          _r(r, 4, 6)}, {}, 'exact'),
    'strided_slice': ('strided_slice', lambda r: {'Input': _r(r, 9, 8)},
                      {'axes': [0, 1], 'starts': [-1, 1], 'ends': [0, 8],
                       'strides': [-2, 3]}, 'exact'),
    'gather': ('gather', lambda r: {'X': _r(r, 6, 3), 'Index': np.array(
        [5, -1, 7, 0, -9], 'int32')}, {}, 'exact'),
    'scatter': ('scatter', lambda r: {'X': _r(r, 6, 3), 'Ids': np.array(
        [1, -2, 9], 'int32'), 'Updates': _r(r, 3, 3)}, {}, 'exact'),
    'scatter_add': ('scatter', lambda r: {'X': _r(r, 6, 3), 'Ids': np.array(
        [1, 4, 9], 'int32'), 'Updates': _r(r, 3, 3)}, {'overwrite': False},
        'exact'),
    'gather_nd': ('gather_nd', lambda r: {'X': _r(r, 4, 5), 'Index':
                                          np.array([[1, 2], [7, -1],
                                                    [-6, 0]], 'int32')},
                  {}, 'exact'),
    'pad': ('pad', lambda r: {'X': _r(r, 2, 3)},
            {'paddings': [1, 2, 0, 1], 'pad_value': 0.5}, 'exact'),
    'pad2d_reflect': ('pad2d', lambda r: {'X': _r(r, 2, 3, 5, 6)},
                      {'paddings': [1, 2, 2, 1], 'mode': 'reflect'},
                      'exact'),
    'pad2d_edge_nhwc': ('pad2d', lambda r: {'X': _r(r, 2, 5, 6, 3)},
                        {'paddings': [2, 0, 1, 3], 'mode': 'edge',
                         'data_format': 'NHWC'}, 'exact'),
    'pad_constant_like': ('pad_constant_like', lambda r: {
        'X': _r(r, 4, 5), 'Y': _r(r, 2, 3)}, {'pad_value': 1.5}, 'exact'),
    'one_hot': ('one_hot', lambda r: {'X': r.randint(-1, 9, (5, 7, 1))
                                      .astype('int32')}, {'depth': 8},
                'exact'),
    'label_smooth': ('label_smooth', lambda r: {'X': r.rand(5, 31).astype(
        'float32')}, {'epsilon': 0.1}, 'exact'),
    'label_smooth_prior': ('label_smooth', lambda r: {
        'X': r.rand(5, 31).astype('float32'),
        'PriorDist': r.rand(31).astype('float32')}, {'epsilon': 0.2},
        'exact'),
    'fill_zeros_like': ('fill_zeros_like', lambda r: {'X': _r(r, 3, 5)}, {},
                        'exact'),
    'shape': ('shape', lambda r: {'Input': _r(r, 2, 7, 3)}, {}, 'exact'),
    'arg_max': ('arg_max', lambda r: {'X': np.round(_specials(r, 4, 9))},
                {'axis': 1}, 'exact'),
    'arg_min': ('arg_min', lambda r: {'X': np.round(_r(r, 4, 9))},
                {'axis': 0}, 'exact'),
    'argsort': ('argsort', lambda r: {'X': np.round(_r(r, 4, 33))},
                {'axis': -1}, 'exact'),
    'reverse': ('reverse', lambda r: {'X': _r(r, 3, 4, 5)},
                {'axis': [0, 2]}, 'exact'),
    'multiplex': ('multiplex', lambda r: {'X': [_r(r, 4, 3), _r(r, 4, 3)],
                                          'Ids': np.array([[1], [0], [3],
                                                           [-1]], 'int32')},
                  {}, 'exact'),
    'space_to_depth': ('space_to_depth', lambda r: {'X': _r(r, 2, 3, 4, 6)},
                       {'blocksize': 2}, 'exact'),
    'shuffle_channel': ('shuffle_channel', lambda r: {'X': _r(r, 2, 6, 3,
                                                                3)},
                        {'group': 2}, 'exact'),
    'smooth_l1_loss': ('smooth_l1_loss', lambda r: {'X': _r(r, 6, 5),
                                                    'Y': _r(r, 6, 5)},
                       {'sigma': 1.5}, 1e-6),
    'huber_loss': ('huber_loss', lambda r: {'X': _r(r, 8, 1, scale=2),
                                            'Y': _r(r, 8, 1)},
                   {'delta': 0.7}, 1e-6),
    'log_loss': ('log_loss', lambda r: {
        'Predicted': r.rand(8, 1).astype('float32'),
        'Labels': (r.rand(8, 1) > 0.5).astype('float32')}, {}, 1e-6),
    'rank_loss': ('rank_loss', lambda r: {
        'Label': (r.rand(8, 1) > 0.5).astype('float32'), 'Left': _r(r, 8, 1),
        'Right': _r(r, 8, 1)}, {}, 1e-6),
    'margin_rank_loss': ('margin_rank_loss', lambda r: {
        'Label': np.sign(_r(r, 8, 1)), 'X1': _r(r, 8, 1), 'X2': _r(r, 8, 1)},
        {'margin': 0.1}, 1e-6),
    'bpr_loss': ('bpr_loss', lambda r: {'X': _r(r, 6, 7), 'Label':
                                        r.randint(0, 7, (6, 1)).astype(
                                            'int32')}, {}, 1e-6),
    'kldiv_loss': ('kldiv_loss', lambda r: {
        'X': np.log(r.rand(5, 8).astype('float32') + 0.1),
        'Target': r.rand(5, 8).astype('float32')},
        {'reduction': 'batchmean'}, 1e-6),
    'conv3d': ('conv3d', lambda r: {'Input': _r(r, 2, 4, 6, 7, 6),
                                    'Filter': _r(r, 6, 2, 3, 3, 3)},
               {'paddings': [1, 1, 1], 'strides': [1, 2, 1], 'groups': 2},
               1e-5),
    'conv2d_transpose': ('conv2d_transpose', lambda r: {
        'Input': _r(r, 2, 6, 7, 8), 'Filter': _r(r, 6, 2, 3, 3)},
        {'strides': [2, 2], 'paddings': [1, 1], 'groups': 3}, 1e-5),
    'conv3d_transpose': ('conv3d_transpose', lambda r: {
        'Input': _r(r, 1, 4, 4, 5, 4), 'Filter': _r(r, 4, 3, 2, 3, 2)},
        {'strides': [2, 1, 2], 'paddings': [0, 1, 0]}, 1e-5),
    'pool3d_max': ('pool3d', lambda r: {'X': _specials(r, 2, 3, 6, 7, 5)},
                   {'ksize': [2, 3, 2], 'strides': [2, 2, 2],
                    'paddings': [1, 1, 0], 'ceil_mode': True}, 'exact'),
    'pool3d_avg': ('pool3d', lambda r: {'X': _r(r, 2, 3, 6, 7, 5)},
                   {'ksize': [3, 3, 3], 'strides': [1, 2, 2],
                    'paddings': [1, 1, 1], 'pooling_type': 'avg'}, 1e-6),
    'adaptive_pool2d': ('adaptive_pool2d', lambda r: {'X': _r(r, 2, 3, 8,
                                                              6)},
                        {'ksize': [4, 3], 'pooling_type': 'avg'}, 1e-6),
    'adaptive_pool3d': ('adaptive_pool3d', lambda r: {'X': _r(r, 1, 2, 4, 6,
                                                              4)},
                        {'ksize': 2}, 'exact'),
    'group_norm': ('group_norm', lambda r: {
        'X': _r(r, 2, 8, 5, 5, scale=3) + 1, 'Scale': _r(r, 8),
        'Bias': _r(r, 8)}, {'groups': 4}, 1e-5),
    'log_softmax': ('log_softmax', lambda r: {'X': _r(r, 7, 33, scale=4)},
                    {'axis': -1}, 1e-6),
    'lrn': ('lrn', lambda r: {'X': _r(r, 2, 9, 4, 4)},
            {'n': 5, 'k': 1.0, 'alpha': 1e-2, 'beta': 0.75}, 1e-6),
    'bilinear_ac': ('bilinear_interp', lambda r: {'X': _r(r, 2, 3, 6, 7)},
                    {'out_h': 11, 'out_w': 5, 'align_corners': True}, 1e-6),
    'bilinear_half_down': ('bilinear_interp', lambda r: {
        'X': _r(r, 2, 3, 9, 8)}, {'out_h': 4, 'out_w': 3,
                                  'align_corners': False}, 1e-5),
    'nearest_ac': ('nearest_interp', lambda r: {'X': _r(r, 2, 3, 6, 7)},
                   {'out_h': 11, 'out_w': 4, 'align_corners': True},
                   'exact'),
    'nearest_half': ('nearest_interp', lambda r: {'X': _r(r, 2, 3, 6, 7)},
                     {'out_h': 9, 'out_w': 3, 'align_corners': False},
                     'exact'),
    'affine_channel': ('affine_channel', lambda r: {
        'X': _r(r, 2, 3, 4, 4), 'Scale': _r(r, 3), 'Bias': _r(r, 3)}, {},
        'exact'),
}


def _gvc_same(g, c, tol):
    """-> (max abs difference, ok): bit for bit (NaN as NaN, the sign of a
    zero kept) when `tol` is 'exact', else within tol x max |c|."""
    import torch
    g = g.detach().cpu()
    c = c.detach()
    if g.shape != c.shape or g.dtype != c.dtype:
        return float('inf'), False
    if g.dtype == torch.bool or not g.is_floating_point():
        return float((g.long() - c.long()).abs().max()) if g.numel() \
            else 0.0, bool(torch.equal(g, c))
    err = float((g.float() - c.float()).abs().nan_to_num(0.0, 0.0, 0.0)
                .max()) if g.numel() else 0.0
    if tol == 'exact':
        same = ((g == c) & (torch.signbit(g) == torch.signbit(c))) | (
            torch.isnan(g) & torch.isnan(c))
        return err, bool(same.all())
    return err, err <= tol * float(c.float().abs().nan_to_num(0.0).max())


def gvc_case(name):
    """GVC_OPS[name] on the card and on the CPU from its seed -> {output
    (slot, with the list index of a list slot): (max abs difference,
    ok)}."""
    import torch
    from paddle_tpu_torch.core import registry
    op, make, attrs, tol = GVC_OPS[name]
    ins = make(np.random.RandomState(sum(map(ord, name))))
    out = {}
    for dev in ('cuda', 'cpu'):
        t = {k: [torch.from_numpy(a).to(dev) for a in v]
             if isinstance(v, list) else torch.from_numpy(
                 np.ascontiguousarray(v)).to(dev)
             for k, v in ins.items()}
        out[dev] = registry.get_op(op)(_OpCtx(dev), t, attrs)
    errs = {}
    for slot, c in out['cpu'].items():
        g = out['cuda'][slot]
        for k, (gv, cv) in enumerate(zip(g, c) if isinstance(c, list)
                                     else [(g, c)]):
            errs['%s%s' % (slot, k if isinstance(c, list) else '')] = \
                _gvc_same(gv, cv, tol)
    return errs


def _mlp_remat(fluid):
    """tests/test_recompute.py's program: three fc + relu layers in one
    recompute_scope, an fc head, the mean squared error, SGD 0.01."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data('x', shape=[8], dtype='float32')
        y = layers.data('y', shape=[1], dtype='float32')
        h = x
        with fluid.recompute_scope():
            for i in range(3):
                h = layers.fc(h, 16, act='relu',
                              param_attr=fluid.ParamAttr(name='w%d' % i),
                              bias_attr=False)
        pred = layers.fc(h, 1, param_attr=fluid.ParamAttr(name='wout'),
                         bias_attr=False)
        loss = layers.reduce_mean(layers.square(pred - y))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    return main, startup, loss


def phase_ops_gpu_vs_cpu():
    """Every dense op of GVC_OPS (the soft-label and any-axis
    cross-entropy, the reductions, the tensor, math, loss and nn ops) on
    the card against the port's CPU run on the same inputs: bit for bit
    where the op is exact, within the stated fraction of the largest
    magnitude where cuDNN's or a reduction's order differs; then
    tests/test_recompute.py's program (a recompute_scope over three fc
    layers, SGD) five steps on the card and on the CPU from one state,
    losses within 1e-5 relative."""
    import paddle_tpu_torch as fluid
    rows, bad = {}, []
    for name, (op, _, _, tol) in sorted(GVC_OPS.items()):
        errs = gvc_case(name)
        rows[name] = dict(op=op, tol=tol, max_abs_err={
            k: e for k, (e, _) in errs.items()})
        if not all(ok for _, ok in errs.values()):
            bad.append((name, errs))
    # test_recompute's program, card against CPU
    main, startup, loss = _mlp_remat(fluid)
    rng = np.random.RandomState(0)
    xb = rng.rand(16, 8).astype('float32')
    feed = {'x': xb, 'y': xb.sum(1, keepdims=True)}
    gpu = fluid.Scope()
    with fluid.scope_guard(gpu):
        fluid.Executor().run(startup)
    cpu = fluid.scope_from_numpy({n: t.cpu().numpy()
                                  for n, t in gpu.vars.items()},
                                 fluid.Scope(), 'cpu')
    losses = {}
    for dev, scope, exe in (('gpu', gpu, fluid.Executor()),
                            ('cpu', cpu, fluid.Executor(fluid.CPUPlace()))):
        with fluid.scope_guard(scope):
            losses[dev] = [float(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0][0])
                           for _ in range(5)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses['gpu'],
                                                  losses['cpu']))
    emit(phase='ops_gpu_vs_cpu', ops=rows, failed=[n for n, _ in bad],
         recompute_program=dict(gpu_losses=losses['gpu'],
                                cpu_losses=losses['cpu'],
                                loss_max_rel=rel, loss_rtol=1e-5))
    require(not bad, 'ops_gpu_vs_cpu: the card differs from the CPU: %s'
            % bad)
    require(rel <= 1e-5 and losses['gpu'][-1] < losses['gpu'][0],
            'ops_gpu_vs_cpu: the recompute program %s on the card, %s on '
            'the CPU' % (losses['gpu'], losses['cpu']))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(PHASES),
                    help='comma-separated subset of %s' % (PHASES,))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(',') if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error('unknown phases %s' % sorted(unknown))

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device — this script runs on the card',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch  # noqa: F401 - fails outside the repository
    from paddle_tpu_torch import kernels as kernels_py

    emit(phase='env', python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    took = {}

    def run(name, fn, *a):
        """fn(*a) when phase `name` was asked for, else {}; timed."""
        if name not in phases:
            return {}
        t0 = time.perf_counter()
        res = fn(*a)
        took[name] = time.perf_counter() - t0
        emit(phase='script', step='phase_done', name=name,
             seconds=took[name])
        return res

    smi = run('card', phase_card) or smi_line()
    kern = run('kernels', phase_kernels) or {'rows': {}, 'instances': {}}
    # the timed phases first, the ones that also compute on the CPU last:
    # CPU work left behind slows the host that issues the timed steps
    served_launches = run('serving', phase_serving, smi)
    served_bf16 = run('serving_bf16', phase_serving_bf16, smi)
    served_d96 = run('serving_d96', phase_serving_d96, smi)
    served_d256 = run('serving_d256', phase_serving_d256, smi)
    generated = run('generation', phase_generation, smi)
    trained = run('training', phase_training, smi)
    trained_f32 = run('training_f32', phase_training_f32, smi)
    composed = run('training_composed', phase_training_composed, smi)
    llama_f32 = run('training_llama', phase_training_llama, smi)
    llama_bf16 = run('training_llama_bf16', phase_training_llama_bf16, smi)
    llama_d256 = run('training_llama_d256', phase_training_llama_d256, smi)
    resnet50 = run('training_resnet50', phase_training_resnet50, smi)
    se50 = run('training_se_resnext50', phase_training_se_resnext50, smi)
    vgg16 = run('training_vgg16', phase_training_vgg16, smi)
    mnist = run('training_mnist', phase_training_mnist, smi)
    ctr = run('training_ctr', phase_training_ctr, smi)
    optimizers = run('training_optimizers', phase_training_optimizers, smi)
    w2v = run('training_word2vec', phase_training_word2vec, smi)
    seq_lm = run('training_stacked_lstm', phase_training_stacked_lstm, smi)
    remat = run('training_recompute', phase_training_recompute, smi)
    fluid_loss = run('training_fluid_loss', phase_training_fluid_loss, smi)
    run('composed_opt_on_off', phase_composed_opt_on_off)
    run('nan_trip', phase_nan_trip, smi)
    run('gpu_vs_cpu', phase_gpu_vs_cpu)
    run('generation_gpu_vs_cpu', phase_generation_gpu_vs_cpu)
    run('train_gpu_vs_cpu', phase_train_gpu_vs_cpu)
    run('train_composed_gpu_vs_cpu', phase_train_composed_gpu_vs_cpu)
    llama_tiny = run('train_llama_gpu_vs_cpu', phase_train_llama_gpu_vs_cpu)
    resnet_small = run('train_resnet_gpu_vs_cpu',
                       phase_train_resnet_gpu_vs_cpu)
    conv_small = run('train_conv_gpu_vs_cpu', phase_train_conv_gpu_vs_cpu)
    ctr_small = run('train_ctr_gpu_vs_cpu', phase_train_ctr_gpu_vs_cpu)
    c11 = run('train_c11_gpu_vs_cpu', phase_train_c11_gpu_vs_cpu)
    seq_small = run('train_seq_gpu_vs_cpu', phase_train_seq_gpu_vs_cpu)
    run('ops_gpu_vs_cpu', phase_ops_gpu_vs_cpu)
    emit(phase='script', seconds_by_phase=took,
         seconds=sum(took.values()))

    def per_step(steps):
        return {k: v // 10 if v % 10 == 0 else v / 10
                for k, v in steps.items() if v}
    # launches by path: per served run (serving, serving_bf16), per decode
    # step (generation: K4), per step of each training path
    by_path = {'serving': served_launches, 'serving_bf16': served_bf16,
               'generation': generated, 'training': per_step(trained),
               'training_f32': per_step(trained_f32),
               'training_composed': per_step(composed),
               # per step (graph replays), per bf16 step, per tiny step
               'training_llama': llama_f32,
               'training_llama_bf16': llama_bf16,
               'train_llama_tiny_f32': llama_tiny.get(
                   'train_llama_tiny_f32', {}),
               'train_llama_tiny_bf16': llama_tiny.get(
                   'train_llama_tiny_bf16', {}),
               # per step of the GPT-J-width llama (D = 256): bf16 AMP
               # (graph replays), float32, and its 1-layer check
               'training_llama_d256': llama_d256.get('training_llama_d256',
                                                     {}),
               'training_llama_d256_f32': llama_d256.get(
                   'training_llama_d256_f32', {}),
               'train_llama_gptj_amp': llama_tiny.get(
                   'train_llama_gptj_amp', {}),
               'train_llama_gptj_f32': llama_tiny.get(
                   'train_llama_gptj_f32', {}),
               # per 4-row batch of the Phi-3-mini-width llama (D = 96)
               'serving_d96_f32': served_d96.get('serving_d96_f32', {}),
               'serving_d96_bf16': served_d96.get('serving_d96_bf16', {}),
               # per 4-row batch of the GPT-J-width llama (D = 256)
               'serving_d256_f32': served_d256.get('serving_d256_f32', {}),
               'serving_d256_bf16': served_d256.get('serving_d256_bf16',
                                                    {}),
               # per step of the ResNet-50 AMP step (graph replays) and of
               # the small ResNets on the card
               'training_resnet50': resnet50,
               # per step of SE-ResNeXt-50 and VGG-16 (bf16 AMP) and of
               # MNIST (float32), graph replays
               'training_se_resnext50': se50, 'training_vgg16': vgg16,
               'training_mnist': mnist,
               # per step of word2vec (graph replays)
               'training_word2vec': w2v,
               # per step of the stacked-LSTM LM (graph replays)
               'training_stacked_lstm': seq_lm,
               # per step of transformer-base trained on Fluid's own
               # one_hot -> label_smooth -> soft-label loss
               'training_fluid_loss': fluid_loss}
    # per step of the recompute programs (composed and flash)
    by_path.update(remat)
    by_path.update(resnet_small)
    by_path.update(conv_small)
    # per step of DeepFM and Wide&Deep (graph replays), of Wide&Deep under
    # each optimizer, and of the small runs on the card
    by_path.update(ctr)
    by_path.update(optimizers)
    by_path.update(ctr_small)
    # C11's bf16 instances: over the two steps of each C11 run on the card
    by_path.update(c11)
    # per step of the LM and the recommender on the card against the CPU
    by_path.update(seq_small)
    # the main path's launches: per step of the composed training path for
    # the kernels it runs, per step of the flash training path for K1-K3
    # and its own generated segments, per served run for the serving-only
    # ones (the float32 step adds only its own segments: its flash kernels
    # are the float32 instances, below)
    launches = dict(served_launches)
    launches.update({k: v for k, v in served_bf16.items()
                     if k not in kernels_py.launches})
    launches.update({k: v for k, v in by_path['training_f32'].items()
                     if k not in kernels_py.launches})
    for path in ('training', 'training_composed'):
        launches.update(by_path[path])
    # the kernels only the training llamas and the conv models run (Adam's
    # bf16 instance, the clip's segments, the AMP step's segments, Momentum
    # and the conv models' segments): per step of the float32 llama path,
    # else of the bf16 llama step, else of the GPT-J-width AMP step, else
    # of the ResNet-50, SE-ResNeXt-50, VGG-16 and MNIST steps
    # the K7 instances of csrc/optim_multi.cu: per step of Wide&Deep
    # under each optimizer (adagrad's per step of training_ctr's)
    for path in ('training_llama', 'training_llama_bf16',
                 'training_llama_d256', 'training_resnet50',
                 'training_se_resnext50', 'training_vgg16',
                 'training_mnist', 'training_ctr_wide_deep') + tuple(
                     'training_optimizers_' + n for n in OPT_RUNS) + tuple(
                     'train_c11_' + n for n in C11_RUNS
                     if 'train_c11_' + n in c11):
        for k, v in by_path.get(path, {}).items():
            if v and not launches.get(k):
                launches[k] = v
    # the float32 instances of K1-K3: K1 per served run (serving), K2 and
    # K3 per step of the float32 flash training path
    f32_steps = by_path['training_f32']
    f32_launches = {'flash_attention_fwd': served_launches.get(
        'flash_attention_fwd'), 'flash_attention_bwd_dq': f32_steps.get(
        'flash_attention_bwd_dq'), 'flash_attention_bwd_dkv': f32_steps.get(
        'flash_attention_bwd_dkv')}
    def path_counts(name, paths=tuple(by_path)):
        return {p: by_path[p][name] for p in paths
                if by_path[p].get(name)}

    def instance_launches(name, key):
        """An instance's launches on its main path: the flash step for
        bf16, the served run (K1) or the float32 step (K2, K3) for
        float32, else on the first of its own paths that launches it (the
        served D = 96 or 256 batch for K1; a step of the tiny llama, or
        of the GPT-J-width llama at width 256, for K2, K3)."""
        if key == 'bfloat16':
            return launches.get(name)
        if key == 'float32':
            return f32_launches[name]
        return next((by_path[p][name] for p in _INSTANCES[key][3]
                     if by_path[p].get(name)), None)

    rows = []
    for name, res in kern['rows'].items():
        src, replaces = _REPLACES.get(name, SEGMENT_SOURCE)
        row = dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=launches.get(name), max_abs_err=res['max_abs_err'],
            ms=res['ms'], plain_ms=res['plain_ms'],
            bound_ms=res['bound_ms'], bound_by=res['bound_by'],
            library_ms=res['library_ms'],
            launches_by_path=path_counts(name))
        if name not in _REPLACES:
            row.update(ops=res['ops'], paths=res['paths'])
        if res.get('kernel') == 'optim_multi':
            row.update(kernel='optim_multi', instance=res['instance'],
                       case=res['case'], library_is=res['library_is'],
                       library_computes=res['library_computes'])
        if 'in_dtypes' in res:
            # C11's bf16 instances (optim_bf16_case)
            row.update(instance=res['instance'] + ' bf16', case=res['case'],
                       in_dtypes=res['in_dtypes'],
                       library_is=res['library_is'])
        for key, cases in (('ctr_cases', 'gather_ctr'),
                           ('seq_cases', 'gather_seq')):
            if name == 'embedding_gather' and kern.get(cases):
                row[key] = {
                    k: {f: r[f] for f in ('V', 'D', 'N', 'ms', 'plain_ms',
                                          'library_ms', 'bound_ms',
                                          'flushed_ms',
                                          'library_flushed_ms')}
                    for k, r in kern[cases].items()}
        if name in kern['instances']:
            row['instances'] = []
            for key, r in sorted(kern['instances'][name].items()):
                dt, design, isrc, ipaths = _INSTANCES[key]
                if key.endswith('_other_d'):
                    design, isrc = _OTHER_D[name]
                inst = dict(
                    key=key, dtype=dt,
                    design=design or _F32_DESIGNS[name, key],
                    source=isrc or src,
                    case=r['case'], D=r['D'],
                    launches=instance_launches(name, key),
                    launches_by_path=path_counts(name, ipaths),
                    max_abs_err=r['max_abs_err'], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'])
                for extra in ('bound_cuda_cores_ms', 'bound_tf32x3_ms',
                              'cuda_core_ms', 'DP', 'useful_share',
                              'bound_share'):
                    if extra in r:
                        inst[extra] = r[extra]
                row['instances'].append(inst)
        rows.append(row)
    if set(PHASES) <= set(phases):
        idle = [r['name'] for r in rows if not r['launches_by_path']] + [
            '%s/%s' % (r['name'], i['dtype']) for r in rows
            for i in r.get('instances', ()) if not i['launches_by_path']]
        require(not idle, 'kernels never launched on any of their paths: '
                '%s' % idle)
    print(json.dumps({'kernels': rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
