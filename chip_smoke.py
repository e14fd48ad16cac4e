#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

  python3 chip_smoke.py [--only kernels|launches|phases|prng|serving|train|
                                stage2|step|damsm|weights|lstm|options|
                                parallel|archs]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel:
     six sources, twelve kernels, and the measurement build of the tower
     kernels, `tower_block_phases`, used by the phase table alone);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes (R = 768 token rows of B = 32 captions x
     T = 24, H = 768, 12 heads, I = 3072; ragged key masks from the
     synthetic captions; weights passed as the model passes them, the .t()
     view of an (out, in) nn.Linear weight; dropout 0.1 from int32 bits
     drawn on the card; DAMSM words (32, 256, 22) and regions
     (32, 256, 196), l2-normalised over features as the heads make them),
     in bf16 and f32 (K9: f32), then timed beside its plain version, a
     one-call library equivalent where PyTorch has one, and its bound on
     the card. A time is the device time per call of a CUDA graph of
     back-to-back calls (no host work in the timed span), with a warm L2
     (`ms`) and with the L2 flushed before each call (`ms_cold_l2`: a
     graph of flush + call less a graph of the flushes). K1 and K2 are
     also held at (rows, H) = (37, 389), (768, 768), (50, 1024), (9, 8)
     and with rows one element into their storage (the scalar path), f32
     and bf16; at R = H = 768 in bf16 one call of each is one device
     operation (torch.profiler, the most over three sessions), and K2's
     outputs are bit for bit the same over repeated calls, from a CUDA
     graph's replay and on two streams at once (each with its own arrival
     counters); so are the LN sums of K4
     and K6 over two calls. K3 and K5 (bf16, eval) and K4 and K6 (bf16,
     host bits and prng mode) are also listed launch by launch, each
     launch's device us (torch.profiler) beside one PyTorch call doing its
     work on the same bf16-rounded operands (torch.matmul,
     F.scaled_dot_product_attention and its backward, F.layer_norm,
     native_layer_norm_backward, Tensor.sum: reference columns, used
     nowhere in the port; `--only launches` runs these tables alone); K5
     is held at T = 512 (two captions, padded keys) without residuals and
     with them (p included), and K4 and K6 at T = 64, 65, 200 and 512 (two
     captions; f32 up to its limit of 64) in host bits and prng mode. K3
     and K5 are
     held and timed twice: serving (rate 0, no residuals) and train mode
     (rate 0.1, the residuals the backward reads, `*_train` keys); K3-K6
     once more in prng mode (`seed=`: the bits drawn in-kernel from the
     Philox stream of ops/philox.py, `*_prng` keys) against their plain prng
     mode. The
     whole-tower kernels K7 and K8 (12 layers in one launch each way) are
     held in eval and train mode, bf16 and f32: K7 layer by layer, each
     layer's qkv, p, o and f against the plain version run from the
     kernel's own input to that layer, element-wise like a half-layer,
     and the residual sums r1 and r2, the layer's output z and all 12
     layers end to end f32 element-wise, bf16 to the tolerance times the
     largest element (where an addend of r1 = x + h or r2 = y + g flipped
     one bf16 step and the other nearly cancels it, the sum is off by
     that step at an element near zero, and LayerNorm divides it by a row
     deviation that may be below one); K8 like the other backwards;
     and both against
     the chain of half-layer kernels from the same weights and bits
     (12 x (K5, K3) forward, 12 x (K4, K6) backward); and in prng mode,
     K7 layer by layer and K8 against their plain prng mode (prng mode
     against host mode fed the dump is phase 4's). Their times are CUDA
     events around 20 back-to-back calls (`timing: cuda_events`), not a
     graph: a cooperative launch that a stream capture refused would leave
     the capture half-open; a call is milliseconds long, so the host's
     launch work hides behind the queue. The chain is timed both ways.
     Then the phase table: from the measurement build (%globaltimer
     stamps at every grid barrier), the time of each of the 7 phases a
     layer and of the barriers, K7 in eval and prng mode and K8 in prng
     mode, with each block's SM and the compiler's register and spill
     report of the tower kernels (`--only phases` runs this alone). K9
     (f32) is also held with a ragged mask, bit for bit over two calls,
     and at T = 510 (bert_words_num 512, its long path) against its plain
     version, and timed there beside the plain version, with its
     yardsticks at the flagship: the two contractions alone as f32
     torch.bmm (TF32 off), regions_j^T by all captions' words and attended
     weights by regions_j^T, batched over the images (reference columns,
     used nowhere in the port); its bound counts the three TF32 products
     of 3xTF32 at the TF32 peak, the f32 FMA bound listed beside it
     (`--only damsm` runs K9 alone);
  4. prng: the port's tools/verify_block_prng at full width (B 32, T 24,
     12 layers of H 768, I 3072), f32 and bf16, with the counts zeroed
     before and read after: for K3/K4, K5/K6 and K7/K8 in prng mode,
     determinism, other seeds other outputs, prng mode equal to host mode
     fed the dumps of K10-K12 (values and every gradient, bit for bit), a
     wrong-seed backward that differs, each site's kept share within 5
     sigma of 1 - rate; then K10-K12 against their plain versions bit for
     bit, timed beside torch.randint of the same count;
  5. serving at full width in bf16 (bert-base 12 layers, iresnet18 at
     112x112, ImageHeading, FCFM 640; random weights from manual_seed;
     synthetic test split; batch 32; fused_block=both, fused_ln=true):
     run_test in pair mode, then extract_embeddings, with every kernel's
     launch count zeroed before and read after; then one pair batch with
     the kernels off (plain PyTorch modules on the card) against the same
     batch with them on, and the time of a pair batch either way; one pair
     batch of captions up to 512 tokens, kernels on against off; and
     run_test once more with fused_block=tower (K7 in place of K3 and K5),
     its scores against kernels off and against `both`;
  6. stage-1 training at full width in bf16 (bert-base, iresnet18 at
     112x112, batch 32, num_classes 4500, fused_block=both, fused_ln,
     use_pallas, dropout 0.1 in prng mode, as the JAX package trains on
     its chip: fused_dropout false, the embeddings' bits from the host and
     the half-layers' drawn in-kernel from one seed per layer; Adam
     moments bf16, synthetic train split):
     the CLI (cli/train_encoders_bert.py: one epoch of 2 steps, both
     eager warm-up steps of the captured step, its checkpoints written and
     removed again) with every count zeroed before and read after; the CLI
     again for two epochs of the synthetic split's two steps (3 eager
     warm-up steps, then the capture; the schedule's rate edit between the
     epochs), its counts (the counters count at capture, not at replay: 4
     steps' launches) and its replays' device kernels (torch.profiler)
     against an eager twin's step's; then, going on with the first run
     eagerly (its weights, optimizer state, rates and dropout stream), 20
     steps on one fixed batch (counts per step,
     a finite loss that falls); one step's loss and gradients with the
     kernels on against off, from the same weights and the same dropout
     masks (the off twin fed the host bits and the K10/K11 dumps of the
     seeds), and once more with a planted K6 fault (the wrong seed in its
     backward) that the comparison must catch, in f32 also with a planted
     K3 forward fault (below); one step at
     bert_words_num 512 (captions up to 512 tokens) on against off, K9 on
     its long path (regions x words 196 x 510) launched once on the on
     side, its loss held to the same limit and its per-module readings
     printed beside the T = 24 ones; in host mode
     (fused_dropout) the same comparison in bf16, which must pass, beside
     a planted fault (all-keep bits in K6) that it must catch, and a
     `tower` twin held against `both` (same weights,
     same bits) and two steps with the same launches as a prng step; the
     step time, device time, peak memory and host words per step in prng
     mode, host mode and with the kernels off, and the step's device-time
     split (its device ms per step on a line of its own);
  7. stage-2 fusion training at full width in bf16 (cfg/fusion_bert.yml as
     it stands: bert-base, iresnet18 frozen, FCFM 640, num_classes 4500,
     batch 16; fused_block=tower, fused_ln; prng mode, the tower's one seed
     per step): the CLI
     (cli/fusion_bert.py: one epoch of 2 steps, its artifacts saved, then
     resumed for a second epoch) with every count zeroed before and read
     after; the CLI again for one epoch of 4 steps, captured, checked as
     in stage 1; going on with the resumed run eagerly, 20 steps on one fixed batch with a falling loss; kernels on
     against off per top-level module in bf16 and f32 (the off twin fed
     the K12 dump), and again with a planted K8 fault (the wrong seed in
     its backward) that the comparison must catch, in f32 also with a
     planted K7 forward fault (below); in host mode the bf16
     comparison and its all-keep fault in K8 as in stage 1; the three
     dropout modes as in stage 1, and the device-time split;
  8. step (`--only step` runs it alone, building the six sources): the
     compiled step for stage 1 (as in 6) and stage 2 (as in 7): an eager
     trainer and a captured one from the same weights, batch and drop_gen
     seed, six steps each (the head's rate halved before the fifth; the
     captured one's fourth step is its capture), every parameter, BN
     statistic, Adam moment, count and metric bit for bit after 3 and 6
     steps; a replay launching, by the profiler's device kernel names,
     what one eager step launches (the most over three profiler sessions
     a side: the profiler drops a replay's records now and then, never
     adds any), the counters unmoved; and the step table, (b) eager and
     (c) captured, kernels on and off, in turns: host ms per step (median
     of 10), device ms
     (profiler), busy share (device over host ms), resident, peak and
     reserved memory. A refused capture of `tower` is printed with its
     error and stage 2 is measured with `both`;
  9. weights (`--only weights` runs it alone, building the four sources it
     needs): files in the reference's layouts, made from seeded tensors
     under its key names and written under checkpoints/chip_smoke_weights
     (removed at the end): ArcFace's iresnet18 .pth (`features.weight`
     off 1), AdaFace's ir_18 Lightning .ckpt (with hyper-parameters that
     weights_only=True refuses), MagFace's .pth (with its margin head's
     `module.fc.weight`), one bert-base {'model', 'head'} text bundle (an
     HF BertModel under 'model.', pooler included), the {'image_head'}
     bundle and the {'net'} FCFM bundle (`module.`-prefixed). For each
     backbone, in serving's configuration (bf16, batch 32, fused_block
     both, fused_ln), every module through the prepare path from these
     files: layer 11's fused qkv, the folded `features` variance
     (ArcFace, MagFace) and AdaFace's permuted output_fc equal to the
     written tensors after the map; run_test with the counts zeroed before
     and read after (K1, K3, K5 as in phase 5); one pair batch kernels on
     against off within SCORE_TOL; the device ms (profiled) and host ms of
     a pair batch; then the COTS baseline (org_face_test, no text, no
     kernel launched) and its ms per pair batch. Then one AdaFace stage-1
     step (cfg/train_bert.yml, the same files) with the kernels on: a
     finite loss and the launches of phase 6's step;
 10. lstm (`--only lstm` runs it alone, building K9's source): the
     LSTM/GRU recipe at the shipped widths in bf16, random weights from
     manual_seed, the synthetic corpus (its vocabulary printed):
     stage 1 (cfg/train_lstm.yml, B 128, T 18, 4500 classes) captured
     against eager bit for bit, use_pallas off (as shipped) and on; the
     use_pallas twin counted (K9 once a step, masked by the captions'
     lengths), its replays launching K9 as an eager step (profiler), and a
     step with K9 against one without within ON_OFF_TOL; stage 2
     (cfg/fusion_lstm.yml, B 64, linear) captured against eager bit for
     bit and one fcfm step (WordLevelCFA_LSTM); one GRU stage-1 step;
     serving (run_test, one pair batch of 32, its f32 scores on the card
     against the CPU's within LSTM_SCORE_TOL); host ms, device ms and busy
     share of the steps and the pair batch, with the card;
 11. options (`--only options` runs it alone, building the six sources):
     the stage options is_CMP, is_WRA and frozen_feature_cache at full
     width in bf16. Stage 1 (as in 6) with is_CMP and is_WRA captured
     against eager bit for bit with the counts zeroed before and read
     after (K1-K6 and K9 as in 6), its replays launching K1-K6 and K9 as an
     eager step (profiler), its wra_loss and cmp_loss printed; a stage-1
     train state saved after 2 eager steps and resumed in a fresh trainer,
     step 3 equal to the uninterrupted run's bit for bit (cmp's Adam state
     among it); the frozen-feature cache in stage 1 (CMP+WRA) and stage 2
     (as in 7): the refresh over a synthetic split of CACHE_SPLIT images
     (a short last chunk) timed, its host bytes, its last 32 images'
     (global, local) features against the in-step backbone at B 32 within
     2e-2 max(1, max |b|), one epoch's caption indices with the cache
     equal to those without it bit for bit, a step with the cache and one
     without on the same draws (total loss within 1e-2 relative), and the
     cached step captured against eager bit for bit; host and device ms
     and busy share per step, median of 10 in turns, stage 1 with CMP+WRA
     against without and each stage with the cache against without,
     beside the card's name and power limit;
 12. parallel (`--only parallel` runs it alone, building the six sources):
     data parallelism over torch.distributed at full width, the ranks
     processes of this script (`--dp_rank`) launched with torchrun's
     variables, their logs and results under
     checkpoints/chip_smoke_parallel/: (a)
     two gloo ranks sharing the card, eager, host bits: a stage-1 step (as
     in 6, B 32, 16 a rank) and a stage-2 step (as in 7, B 16, 8 a rank),
     in bf16 and in f32, each rank's gradients against one process's step
     on the same global batch, weights and bits (whose backbone features
     are made at the ranks' batch size: cuDNN's bf16 convolutions round by
     batch size) under the one-step rule (ON_OFF_TOL; in f32 also 1e-4 of
     each parameter's norm and its largest element), with each rank's
     launch counts against that step's (K9 on the global 32 captions), a
     planted gather whose backward sums over the ranks that must fail, one
     pair batch of 33 pairs within SCORE_TOL of one process, and the
     captured step refused under gloo; (b) one NCCL rank: the stage-1 step
     captured with its collectives, bit for bit against eager steps after
     3 and 6 steps, then the stage-1 entry point (cli.train_encoders_bert
     through cli.run, as `python -m` runs it) under the launcher's
     variables, captured, two epochs of two steps, which must write rank
     0's checkpoints and leave the process group with its graph closed
     within CLI_TIMEOUT; (c) where there are two cards, two NCCL ranks, a
     card each: captured stage-1 steps against one process and against
     eager steps bit for bit, the device-time split of a rank's step and
     of one process's at the global batch (`_split`), the gradient
     reduction against two other designs (`_reduce_ab`), and the entry
     point as
     in (b) on both ranks (else a line says why (c) did not run). Host and
     device ms a step per rank, and the collectives' share. `--dp_parts`
     (default abc) runs some of (a), (b), (c).
 13. archs (`--only archs` runs it alone, building layernorm and damsm):
     the text archs of bert_type other than bert and align (clip,
     groupvit, falva, blip) at full width, bf16, fused_ln, use_pallas and
     fused_block both, which none of them takes (the unfused tower runs,
     as in the JAX package): per arch one pair batch of 32, the stage-1
     step (B 32, 4500 classes) captured against eager bit for bit, one
     stage-2 step (B 16), each counted (K1 once per LayerNorm of each
     tower pass, K2 as often in training, K9 once a stage-1 step, K3-K8
     never); K1 and K2 on the stage-1 step's own LayerNorm inputs (widths
     256, 512, 768; eps 1e-5 and 1e-12) against their plain versions in
     bf16 and f32 and timed beside F.layer_norm and
     native_layer_norm_backward; host and device ms of the pair batch and
     the steps; then each module of the model surface off the main path
     (margins and heads, MagFace, iresnet34-200, GNAP, GDC, the attention,
     CFA and AttnGAN modules) on the card against the CPU within 1e-4.
Each kernel launches on at least one driven path, and on each path exactly
the expected number of times. The last two lines are the `kernels` JSON
line and the result line.

Tolerances. Kernel against plain version, forward outputs:
|k - p| <= atol + rtol |p| with rtol = atol = 2e-2 in bf16 (1 bf16 ulp at
|x| < 8 is <= 2^-5; the two sum in different orders and may round the
other way) and 1e-4 in f32, with TF32 off for matmuls and convolutions so
the plain f32 version is full f32. Backward outputs (K2, K4, K6, K8):
max |k - p| <= tol max(1, max |p|), tol 2e-2 in bf16 and 1e-4 in f32, per
output: the weight and bias gradients are f32 sums over 768 rows whose
rounded bf16 terms may each differ by one ulp between the two, so the
error scales with the gradient's magnitude, not element by element. K8
against the K4/K6 chain in bf16: each weight gradient within one bf16 step
(2^-7 of its value) of the chain's f32 one, the difference the two designs
have by construction. K9
(f32, 3xTF32 on tensor cores): |k - p| <= 1e-4 + 1e-4 |p|. Kernels on
against off: serving pair scores 2e-2 (bf16 rounding differences carried
through 12 layers and a 640-d cosine). One training step, from the same
weights and dropout bits, in the trainer's bf16 and again in f32: the
loss within 1e-2 (bf16) /
1e-5 (f32) relative; and per top-level module (image_head, text_encoder,
text_head, image_cls, text_cls) its gradients as one vector within
||g_on - g_off|| <= 0.1 (bf16; the text head 0.25) / 1e-4 (f32)
||g_off||, and each of its parameters within max |g_on - g_off| <= 0.5
(bf16) / 1e-3 (f32) (max |g_off| + k G), G the largest gradient element of
the model, k 1e-3 (bf16) / 1e-6 (f32). The k G term holds gradients that
are zero in exact arithmetic, like the query bias of IMIM's softmax over
queries, to their rounding noise. The bf16 limits leave room for the text
head, whose gradients differ most (its elementwise max over three window
convolutions and its max over positions route each element's gradient
to one winner, and a bf16 rounding in the tower below can change the
winner); the other modules have read at most 0.051 in bf16. The limits
fail planted faults (stage 2 takes the same limits with the f32 floor k
at 1e-4, see ON_OFF_TOL_STAGE2; its faults are planted in K8): the same
step, bf16 and f32, with K6 handed the wrong seed in the backward, so
that it regenerates other masks than its forward drew (it moves the text
tower by about 0.22 of its norm), and in host mode a bf16 step with K6
handed all-keep bits for the probabilities; the script runs them after
the real comparison and each must fail it. The f32 step is also held in
two parts (`_f32_on_off`): the text tower's output within the kernels' f32
limit (1e-4 + 1e-4 |p|), and the gradients at the limits above with
everything after the tower run on the same values (the off tower hands on
the on tower's output, its gradient still flowing into the off tower);
and two witnesses run the kernels-off model against itself with its
tower output moved by the same magnitudes as the on/off difference, in
other directions, and once through the same hook adding zeros. The f32
step passes end to end, or, where the gap comes from the kernels-off
model itself, in its two parts: the control must move nothing and each
witness must reach a quarter of the end-to-end gap in every module beyond
the limits. Such a gap: an exact tie of two positive values in the text
head's max over time in the kernels-off forward, where the max's gradient
is split between the two and any rounding difference (the kernels', or
a witness's) hands it to one (stage 2 after the CLI's 2 + 2 steps, on an
H100: one tie, text head and text encoder 2.3e-3 and 1.5e-3 apart end to end and
in both witnesses alike, 0 in the control). A
planted f32 forward fault (K3's, or K7's, weights rounded to bf16) must
fail the tower's limit, and both f32 faults the whole check. Each on/off
step also prints where its two sides route differently (ROUTES: the ReLUs
and max pools of the text head, IMIM and FCFM, the text head's maxima),
the tower output's difference, the kernels-off side's exact ties in the
text head's maxima and the norms of its word features before their l2
normalisation. K10-K12 and prng mode against
host mode fed the dumps: bit for bit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit). The data
# sheet gives no 32-bit integer rate, so the Philox words a call draws (20
# integer operations a word: 10 rounds of two 32 x 32 products and 4 xors
# a 4-word block) enter no bound: K10-K12 are bound by the bytes they write.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "tf32_tensor": 495e12, "f32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K9 (f32 as 3xTF32 on tensor cores) against its plain version at these
# l2-normalised inputs: absolute, about 5x the kernel's largest error and
# below a third of the plain version's own with its contractions at single
# TF32, which each run shows fails it (PERF.md, K9)
DAMSM_ATOL = 5e-6
SCORE_TOL = 2e-2
# the LSTM recipe's pair scores in f32 on the card against the same modules
# on the CPU (TF32 off): sums in other orders, cosines in [-1, 1]
LSTM_SCORE_TOL = 1e-3
# kernels on against off, one training step (see the docstring)
ON_OFF_TOL = {"bfloat16": {"loss": 1e-2, "l2": 0.1, "l2_text_head": 0.25,
                           "max": 0.5, "floor": 1e-3},
              "float32": {"loss": 1e-5, "l2": 1e-4, "max": 1e-3,
                          "floor": 1e-6}}
# Stage 2 holds the same limits but for the f32 floor: k G is the room
# left to parameters whose gradient is zero in exact arithmetic (the query
# biases of the two softmaxes over queries), which hold rounding noise of
# the order of f32's epsilon (6e-8) times the gradients that cancel in
# them. The limit 1e-3 (max |g_off| + k G) admits 1e-3 k G: 1e-9 G at
# k = 1e-6, which only stage 1's G (a loss in the thousands) makes roomy
# enough; stage 2 (loss 24, G 2.8, noise 1e-8) takes k = 1e-4, 1e-7 G.
ON_OFF_TOL_STAGE2 = {"bfloat16": ON_OFF_TOL["bfloat16"],
                     "float32": dict(ON_OFF_TOL["float32"], floor=1e-4)}
RATE = 0.1
TRAIN_STEPS = 20
# steps of each CLI run (the synthetic train split holds 64 images): 3
# eager warm-up steps, then the capture (stage 1: two epochs of two steps,
# the schedule's rate edit between them; stage 2: one epoch of four)
CLI_STEPS = 4
# caption lengths of the long-caption checks of K4 and K6 (bf16 up to 512;
# f32 up to its limit of 64): the edge of one key block and one past it
LONG_T = (64, 65, 200, 512)
# K9's caption length at bert_words_num 512 (words without [CLS], [SEP])
DAMSM_LONG_T = 510


def _graph_ms(fn, calls: int = 20, reps: int = 9) -> float:
    """Device ms per call: one CUDA graph of `calls` back-to-back calls of
    fn, replayed `reps` times between two CUDA events; the median replay
    over `calls`. The graph leaves the host's launch work out of the span."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream: per-stream state made at a first call
    # (the LN backward's arrival counters) exists before the capture
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _times(fn, flush, flush_ms: float) -> tuple:
    """(warm-L2 ms, cold-L2 ms) per call of fn; the cold time is a graph
    of flush + call less `flush_ms`, the graph of the flushes alone."""
    def cold():
        flush()
        fn()
    return _graph_ms(fn), _graph_ms(cold) - flush_ms


def _close(a, b, tol: float, rtol: float | None = None):
    """(max |a - b|, whether |a - b| <= tol + rtol |b| everywhere; rtol
    defaults to tol)."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    rtol = tol if rtol is None else rtol
    return err.max().item(), bool((err <= tol + rtol * b.abs()).all())


def _close_scaled(a, b, tol: float):
    """(max |a - b|, whether max |a - b| <= tol max(1, max |b|))."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, err <= tol * max(1.0, b.abs().max().item())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take for the call: the larger of its
    bytes (each input read once, each output written once) over HBM rate
    and its floating-point operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _damsm_bound(b, d, t, r, kind: str) -> dict:
    """K9's bound: words, regions in and sim out once; the two
    contractions (logits R x T x D and context T x R x D per pair, B^2
    pairs) in f32 FMA (`f32`) or as the kernel runs them, 3xTF32 on tensor
    cores (`tf32_3x`: three TF32 products for each f32 one)."""
    flops = 4.0 * b * b * r * t * d
    return _bound(4 * (b * d * (t + r) + b * b),
                  3 * flops if kind == "tf32_3x" else flops,
                  "tf32_tensor" if kind == "tf32_3x" else "f32")


def _bounds(b, t, h, heads, inter, es, d_words, t_words, r_regions):
    """Bounds per kernel, from the shapes and the element size es of the
    activations; dropout bits count 4 bytes an element where the call
    reads them (train mode)."""
    r = b * t
    act = r * h * es                      # one (R, H) activation
    p_el = heads * b * t * t
    d = h // heads
    attn_core = 4.0 * b * heads * t * t * d
    attn_w = 4 * (4 * h * h + 3 * h + 3 * h)      # wqkv, wo, biases, LN
    ffn_w = 4 * (2 * h * inter + inter + 3 * h)
    out = {
        "layernorm_fused": _bound(2 * act + 2 * h * 4, 8.0 * r * h, "f32"),
        "layernorm_bwd": _bound(3 * act + 3 * h * 4, 12.0 * r * h, "f32"),
        "ffn_block": _bound(2 * act + ffn_w, 4.0 * r * h * inter,
                            "bf16_tensor"),
        "attn_block": _bound(2 * act + 4 * b * t + attn_w,
                             2.0 * r * h * 4 * h + attn_core,
                             "bf16_tensor"),
        # in: dz, x, r, f, w1, w2, gamma, bits; out: dx, dw1, dw2, biases
        "ffn_block_bwd": _bound(
            4 * act + r * inter * es + 4 * (4 * h * inter + inter + 4 * h)
            + 4 * r * h, 8.0 * r * h * inter, "bf16_tensor"),
        # in: dy, x, o, r, qkv, p, wqkv, wo, gamma, bits; out: dx, dW, db
        "attn_block_bwd": _bound(
            8 * act + p_el * es + 4 * (8 * h * h + 6 * h) + 4 * (p_el + r * h),
            2.0 * r * h * 8 * h + 2 * attn_core, "bf16_tensor"),
        "damsm_similarity": _damsm_bound(b, d_words, t_words, r_regions,
                                         "tf32_3x"),
    }
    # train-mode forwards: + bits in, + residuals out (f, r / qkv, p, o, r)
    out["ffn_block_train"] = _bound(
        3 * act + r * inter * es + ffn_w + 4 * r * h, 4.0 * r * h * inter,
        "bf16_tensor")
    out["attn_block_train"] = _bound(
        6 * act + p_el * es + 4 * b * t + attn_w + 4 * (p_el + r * h),
        2.0 * r * h * 4 * h + attn_core, "bf16_tensor")
    # prng mode: no bits read, the Philox words drawn in-kernel instead
    for name, words in (("ffn_block", r * h), ("attn_block", p_el + r * h)):
        for key in (name + "_train", name + "_bwd"):
            b_ = out[key]
            out[key.replace("_train", "") + "_prng"] = _bound(
                b_["bytes"] - 4 * words, b_["flops"], "bf16_tensor")
    return out


def _tower_bounds(layers, b, t, h, heads, inter, es):
    """Bounds of the whole-tower kernels: the stacked leaves arrive in the
    activation type (es bytes); eval reads x, mask and the leaves and writes
    z; train adds the bits read and the residuals written; the backward
    reads dz, the residuals, seven of the leaves and the bits and writes dx
    and the 12 stacked gradients."""
    r = b * t
    act = r * h * es
    p_el = heads * b * t * t
    leaves = layers * es * (4 * h * h + 2 * h * inter + 9 * h + inter)
    resid = layers * (5 * act + r * 3 * h * es + r * inter * es + p_el * es)
    bits = layers * 4 * (p_el + 2 * r * h)
    fwd_flops = layers * (2.0 * r * h * 4 * h + 4.0 * r * h * inter
                          + 4.0 * b * heads * t * t * (h // heads))
    return {
        "tower_block": _bound(2 * act + 4 * b * t + leaves, fwd_flops,
                              "bf16_tensor"),
        "tower_block_train": _bound(2 * act + 4 * b * t + leaves + bits
                                    + resid, fwd_flops, "bf16_tensor"),
        "tower_block_bwd": _bound(2 * act + 4 * b * t + 2 * leaves + bits
                                  + resid, 2.0 * fwd_flops, "bf16_tensor"),
        # prng mode: no bits read, the words drawn in-kernel instead
        "tower_block_prng": _bound(2 * act + 4 * b * t + leaves + resid,
                                   fwd_flops, "bf16_tensor"),
        "tower_block_bwd_prng": _bound(
            2 * act + 4 * b * t + 2 * leaves + resid, 2.0 * fwd_flops,
            "bf16_tensor"),
    }


SRC = "text_guided_face_recognition_tpu_torch/csrc/"
JAX = "text_guided_face_recognition_tpu/ops/"
# (rows, H) of the LayerNorm kernels' other paths: H not a multiple of the
# 16-byte vector (the scalar path), the flagship, the widest row, a row
# narrower than a warp's vectors
LN_SHAPES = ((37, 389), (768, 768), (50, 1024), (9, 8))


def damsm_extras(dev, B, D, TW, RG, seed: int, flush,
                 flush_ms: float) -> dict:
    """K9 beyond the kernel table's flagship row: at the flagship (B, D,
    TW, RG) with a ragged mask, two calls bit for bit, and its yardsticks,
    the two contractions alone as f32 torch.bmm (TF32 off; used nowhere in
    the port): regions_j^T (RG x D) by all captions' words (D x B TW) and
    attended weights (B TW x RG) by regions_j^T (RG x D), batched over the
    B images; then at T = DAMSM_LONG_T (bert_words_num 512) the kernel
    against its plain version and both timed. Each comparison also runs the
    plain version with its contractions at single TF32 and shows that it
    fails DAMSM_ATOL, the limit the kernel (3xTF32) is held to."""
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.ops import attention, damsm

    def held(tag, got, want, plain_tf32):
        """The kernel within DAMSM_ATOL of the f32 plain version, the
        single-TF32 plain version outside it."""
        err, ok = _close(got, want, DAMSM_ATOL, 0.0)
        err_tf32 = _close(plain_tf32, want, DAMSM_ATOL, 0.0)[0]
        if not ok or err_tf32 <= DAMSM_ATOL:
            raise AssertionError(
                f"damsm_similarity{tag}: max |err| {err}, the single-TF32 "
                f"plain version's {err_tf32} (limit {DAMSM_ATOL} between)")
        out[f"max_abs_err{tag}"] = err
        out[f"max_abs_err{tag}_plain_tf32"] = err_tf32

    def tf32(fn):
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was

    gen = torch.Generator().manual_seed(seed)

    def unit(*shape):
        return F.normalize(torch.randn(*shape, generator=gen), dim=1).to(
            dev).contiguous()

    words, regions = unit(B, D, TW), unit(B, D, RG)
    lens = torch.randint(1, TW + 1, (B,), generator=gen)
    mask = (torch.arange(TW)[None] < lens[:, None]).to(dev)
    out = {}
    for tag, m in (("", None), ("_masked", mask)):
        got = damsm.damsm_similarity_cuda(words, regions, 4.0, 5.0, m)
        again = damsm.damsm_similarity_cuda(words, regions, 4.0, 5.0, m)
        ref = (lambda m=m: attention.damsm_similarity(words, regions, 4.0,
                                                      5.0, m))
        held("_flagship" + tag, got, ref(), tf32(ref))
        if not torch.equal(got, again):
            raise AssertionError(f"damsm_similarity{tag}: two calls differ")
    out["bitwise_repeat"] = True
    # the yardsticks: the two contractions alone
    reg_t = regions.transpose(1, 2).contiguous()              # (B, RG, D)
    w_all = words.permute(1, 0, 2).reshape(D, B * TW).expand(B, D, B * TW)
    att_w = torch.softmax(torch.randn(B, B * TW, RG, generator=gen), -1).to(
        dev).contiguous()
    out["bmm_logits_ms"], out["bmm_logits_ms_cold_l2"] = _times(
        lambda: torch.bmm(reg_t, w_all), flush, flush_ms)
    out["bmm_context_ms"], out["bmm_context_ms_cold_l2"] = _times(
        lambda: torch.bmm(att_w, reg_t), flush, flush_ms)
    out["bmm_sum_ms"] = out["bmm_logits_ms"] + out["bmm_context_ms"]
    out.update({k + "_f32_fma": v for k, v in _damsm_bound(
        B, D, TW, RG, "f32").items() if k in ("bound_ms", "bound_by")})
    # the long captions: T = DAMSM_LONG_T
    tl = DAMSM_LONG_T
    words_l = unit(B, D, tl)
    lens = torch.randint(tl // 2, tl + 1, (B,), generator=gen)
    mask_l = (torch.arange(tl)[None] < lens[:, None]).to(dev)
    run = (lambda: damsm.damsm_similarity_cuda(words_l, regions, 4.0, 5.0,
                                               mask_l))
    ref = (lambda: attention.damsm_similarity(words_l, regions, 4.0, 5.0,
                                              mask_l))
    got, want = run(), ref()
    held(f"_t{tl}", got, want, tf32(ref))
    if not torch.equal(got, run()):
        raise AssertionError(f"damsm_similarity at t = {tl}: two calls "
                             "differ")
    out[f"ms_t{tl}"], out[f"ms_t{tl}_cold_l2"] = _times(run, flush, flush_ms)
    out[f"plain_ms_t{tl}"] = _graph_ms(ref, calls=2, reps=3)
    for kind, key in (("tf32_3x", ""), ("f32", "_f32_fma")):
        b = _damsm_bound(B, D, tl, RG, kind)
        out[f"bound_ms_t{tl}{key}"] = b["bound_ms"]
    del words_l, want
    torch.cuda.empty_cache()
    return out


def damsm_phase(args) -> dict:
    """`--only damsm`: K9 at the flagship shapes against its plain version,
    timed beside it and its yardsticks (`damsm_extras`), with its bounds."""
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.ops import attention, damsm

    dev = torch.device("cuda")
    B, D, TW, RG = 32, args.aux_feat_dim_per_granularity, \
        args.bert_words_num - 2, (args.img_size // 8) ** 2
    gen = torch.Generator().manual_seed(args.manual_seed)
    words = F.normalize(torch.randn(B, D, TW, generator=gen), dim=1).to(
        dev).contiguous()
    regions = F.normalize(torch.randn(B, D, RG, generator=gen), dim=1).to(
        dev).contiguous()
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    flush_ms = _graph_ms(flush)
    run = (lambda: damsm.damsm_similarity_cuda(words, regions, 4.0, 5.0))
    ref = (lambda: attention.damsm_similarity(words, regions, 4.0, 5.0))
    err, ok = _close(run(), ref(), DAMSM_ATOL, 0.0)
    if not ok:
        raise AssertionError(f"damsm_similarity: max |err| {err}")
    row = {"max_abs_err": err}
    # in turns: kernel, plain, kernel
    row["ms"], row["ms_cold_l2"] = _times(run, flush, flush_ms)
    row["plain_ms"], row["plain_ms_cold_l2"] = _times(ref, flush, flush_ms)
    ms2 = _times(run, flush, flush_ms)
    row["ms_runs"], row["ms_cold_l2_runs"] = [row["ms"], ms2[0]], \
        [row["ms_cold_l2"], ms2[1]]
    row.update(_damsm_bound(B, D, TW, RG, "tf32_3x"))
    row.update(damsm_extras(dev, B, D, TW, RG, args.manual_seed + 11, flush,
                            flush_ms))
    print("damsm: " + json.dumps(row), flush=True)
    return row


def _device_ops(fn, sessions: int = 3) -> int:
    """Device operations (kernels, memsets, copies) one call of fn runs, as
    torch.profiler records them: the most over `sessions` sessions of one
    call each, after one call to warm up. The profiler loses a session's
    device records now and then (it never adds any), so the most over
    sessions is a bound from below of what a call runs, and any extra
    operation still shows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA))
    return best


def _graph_outputs(fn):
    """fn's outputs from a CUDA graph of one call, captured on a side
    stream after a warm-up call there, and replayed twice."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out


def ln_checks(dev, gen, eps: float) -> dict:
    """K1 and K2 beyond the main path's shape: each against its plain
    version at LN_SHAPES and with rows one element into their storage (the
    scalar path), f32 and bf16; the part rows the wrappers allocate against
    the kernel's own count; and at R = H = 768 in bf16 the device
    operations of one call (1 each, from torch.profiler: `_device_ops`),
    and K2's outputs bit for bit over repeated calls, from a CUDA graph's
    replay (arrival counters back at 0) and on two streams at once.
    Returns extra keys for the two rows."""
    import ctypes

    import torch

    from text_guided_face_recognition_tpu_torch.ops import _cuda, layernorm

    def data(rows, h):
        x = torch.randn(rows, h, generator=gen) * 3.0 + 1.0
        dy = torch.randn(rows, h, generator=gen)
        g = 1.0 + 0.1 * torch.randn(h, generator=gen)
        b = 0.1 * torch.randn(h, generator=gen)
        return x.to(dev), dy.to(dev), g.to(dev), b.to(dev)

    def hold(what, x, dy, g, b, tol):
        err, ok = _close(layernorm.layernorm_fused(x, g, b, eps),
                         layernorm.layernorm_ref(x, g, b, eps), tol)
        if not ok:
            raise AssertionError(f"layernorm_fused {what}: kernel disagrees "
                                 f"with its plain version ({err})")
        errs = []
        for k, (o, p) in enumerate(zip(
                layernorm.layernorm_bwd(dy, x, g, eps),
                layernorm.layernorm_bwd_ref(dy, x, g, eps))):
            e, ok = _close_scaled(o, p, tol)
            errs.append(e)
            if not ok:
                raise AssertionError(f"layernorm_bwd {what} output {k}: "
                                     f"kernel disagrees with its plain "
                                     f"version ({e})")
        return err, max(errs)

    fwd, bwd = {}, {}
    for rows, h in LN_SHAPES + ((64, 768),):
        x, dy, g, b = data(rows, h)
        for dt in (torch.bfloat16, torch.float32):
            key = f"{rows}x{h}_{str(dt)[6:]}"
            xd, dyd = x.to(dt), dy.to(dt)
            if (rows, h) == (64, 768):      # one element into the storage
                key = "unaligned_" + key
                xd, dyd = (torch.empty(rows * h + 1, dtype=dt, device=dev)[
                    1:].view(rows, h).copy_(a) for a in (xd, dyd))
            fwd[key], bwd[key] = hold(key, xd, dyd, g, b,
                                      TOL[str(dt)[6:]])
    parts = _cuda.function("layernorm", "tgfr_ln_bwd_parts", (ctypes.c_int,))
    for rows in (1, 9, 37, 64, 65, 384, 768, 1024, 1025, 100000):
        if parts(rows) != layernorm.ln_bwd_parts(rows):
            raise AssertionError(f"ln_bwd_parts({rows}): the wrapper "
                                 f"allocates {layernorm.ln_bwd_parts(rows)} "
                                 f"part rows, the kernel needs {parts(rows)}")
    x, dy, g, b = data(768, 768)
    x, dy = x.bfloat16(), dy.bfloat16()
    ops = {"layernorm_fused": _device_ops(
               lambda: layernorm.layernorm_fused(x, g, b, eps)),
           "layernorm_bwd": _device_ops(
               lambda: layernorm.layernorm_bwd(dy, x, g, eps))}
    if ops != {"layernorm_fused": 1, "layernorm_bwd": 1}:
        raise AssertionError(f"device operations per call: {ops}, not 1")
    first = layernorm.layernorm_bwd(dy, x, g, eps)
    others = [layernorm.layernorm_bwd(dy, x, g, eps) for _ in range(3)]
    others.append(_graph_outputs(
        lambda: layernorm.layernorm_bwd(dy, x, g, eps)))
    for k, other in enumerate(others):
        if not all(torch.equal(a, o) for a, o in zip(first, other)):
            raise AssertionError(f"layernorm_bwd: call {k + 1} ("
                                 f"{'graph' if k == 3 else 'eager'}) is not "
                                 "bit for bit the first")
    if layernorm.ln_bwd_counter(dev).any():
        raise AssertionError("layernorm_bwd: arrival counters not reset")
    # two streams at once, each with its own arrival counters: every call
    # bit for bit its serial twin
    x2, dy2 = (a.bfloat16() for a in data(768, 768)[:2])
    serial = (first, layernorm.layernorm_bwd(dy2, x2, g, eps))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = ([], [])
    for _ in range(20):
        for s, out, args in zip(streams, outs, ((dy, x), (dy2, x2))):
            with torch.cuda.stream(s):
                out.append(layernorm.layernorm_bwd(*args, g, eps))
    torch.cuda.synchronize()
    for k, (out, want) in enumerate(zip(outs, serial)):
        if not all(torch.equal(a, b) for o in out for a, b in zip(o, want)):
            raise AssertionError(f"layernorm_bwd on stream {k} of two at "
                                 "once is not bit for bit the serial call")
    print(f"LN checks: device ops per call {ops}; max |err| K1 {fwd}, K2 "
          f"{bwd}; K2 bit for bit over 4 calls, a graph replay and on two "
          "streams at once", flush=True)
    return {"layernorm_fused": {"device_ops_per_call": 1,
                                "max_abs_err_shapes": fwd},
            "layernorm_bwd": {"device_ops_per_call": 1,
                              "max_abs_err_shapes": bwd,
                              "bitwise_repeat_and_graph": True,
                              "bitwise_two_streams_at_once": True}}


def kernel_phase(args):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.engine.prepare import (
        _synthetic_bert)
    from text_guided_face_recognition_tpu_torch.ops import (
        attention, block, damsm, layernorm)
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw

    dev = torch.device("cuda")
    seed = torch.tensor([args.manual_seed + 3], dtype=torch.int32,
                        device=dev)
    B, T, H, heads, I = 32, args.bert_words_num, 768, 12, 3072
    R = B * T
    D, TW, RG = args.aux_feat_dim_per_granularity, T - 2, (
        args.img_size // 8) ** 2
    eps = 1e-12
    _, _, masks = _synthetic_bert(args, B)
    mask = torch.from_numpy(np.stack(masks[::args.captions_per_image][:B]))
    mask = mask.to(dev, torch.int32).contiguous()
    gen = torch.Generator().manual_seed(args.manual_seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x32, dy32 = rn(R, H), rn(R, H)
    # dy in each type, made once: no cast inside a timed call
    dys = {torch.float32: dy32, torch.bfloat16: dy32.bfloat16()}
    ln_g, ln_b = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    # weights (in, out) as the .t() view of (out, in), as the model has them
    wqkv, bqkv = rn(3 * H, H, std=H ** -0.5).t(), rn(3 * H, std=0.1)
    wo, bo = rn(H, H, std=H ** -0.5).t(), rn(H, std=0.1)
    w1, c1 = rn(I, H, std=H ** -0.5).t(), rn(I, std=0.1)
    w2, c2 = rn(H, I, std=I ** -0.5).t(), rn(H, std=0.1)
    dgen = torch.Generator(device=dev).manual_seed(args.manual_seed + 1)
    bits_p = draw(heads * B * T * T, dgen, dev).view(heads * B, T, T)
    bits_h = draw(R * H, dgen, dev).view(R, H)
    bits_f = draw(R * H, dgen, dev).view(R, H)
    words = F.normalize(rn(B, D, TW), dim=1).contiguous()
    regions = F.normalize(rn(B, D, RG), dim=1).contiguous()
    # the library calls take their affine in the input dtype
    ln_g_bf16, ln_b_bf16 = ln_g.bfloat16(), ln_b.bfloat16()
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    flush_ms = _graph_ms(flush)
    attn_w = (wqkv, bqkv, wo, bo, ln_g, ln_b)
    ffn_w = (w1, c1, w2, c2, ln_g, ln_b)

    def ln_library(x, dy):
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            x, [H], ln_g_bf16, ln_b_bf16, eps)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [H], mean, rstd, ln_g_bf16, ln_b_bf16, [True, True, True])

    # per kernel: run(x) and ref(x) give tuples compared output by output
    specs = [
        dict(name="layernorm_fused", fn=layernorm.layernorm_fused,
             source=SRC + "layernorm.cu",
             replaces=JAX + "layernorm_pallas.py:103",
             run=lambda x: (layernorm.layernorm_fused(x, ln_g, ln_b, eps),),
             ref=lambda x: (layernorm.layernorm_ref(x, ln_g, ln_b, eps),),
             library=lambda x: lambda: F.layer_norm(x, (H,), ln_g_bf16,
                                                    ln_b_bf16, eps)),
        dict(name="layernorm_bwd", fn=layernorm.layernorm_bwd, bwd=True,
             source=SRC + "layernorm.cu",
             replaces=JAX + "layernorm_pallas.py:120",
             run=lambda x: layernorm.layernorm_bwd(dys[x.dtype], x, ln_g,
                                                   eps),
             ref=lambda x: layernorm.layernorm_bwd_ref(dys[x.dtype], x,
                                                       ln_g, eps),
             library=lambda x: ln_library(x, dys[x.dtype])),
        dict(name="attn_block", fn=block.attn_block,
             source=SRC + "attn_block.cu",
             replaces=JAX + "block_pallas.py:626",
             run=lambda x: (block.attn_block(x, mask, *attn_w, B, T, heads,
                                             0.0, eps),),
             ref=lambda x: (block.attn_block_ref(x, mask, *attn_w, B, T,
                                                 heads, 0.0, eps),),
             train_run=lambda x: block.attn_block_fwd(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps),
             train_ref=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps),
             prng_run=lambda x: block.attn_block_fwd(
                 x, mask, *attn_w, B, T, heads, rate=RATE, eps=eps,
                 seed=seed),
             prng_ref=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, rate=RATE, eps=eps,
                 seed=seed)),
        dict(name="attn_block_bwd", fn=block.attn_block_bwd, bwd=True,
             source=SRC + "attn_block.cu",
             replaces=JAX + "block_pallas.py:650",
             res=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps),
             run=lambda x, res: block.attn_block_bwd(
                 dys[x.dtype], x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 bits_p, bits_h, RATE, eps),
             ref=lambda x, res: block.attn_block_bwd_ref(
                 dys[x.dtype], x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 bits_p, bits_h, RATE, eps),
             prng_res=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, rate=RATE, eps=eps,
                 seed=seed),
             prng_run=lambda x, res: block.attn_block_bwd(
                 dys[x.dtype], x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 rate=RATE, eps=eps, seed=seed),
             prng_ref=lambda x, res: block.attn_block_bwd_ref(
                 dys[x.dtype], x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 rate=RATE, eps=eps, seed=seed)),
        dict(name="ffn_block", fn=block.ffn_block,
             source=SRC + "ffn_block.cu",
             replaces=JAX + "block_pallas.py:331",
             run=lambda x: (block.ffn_block(x, *ffn_w, 0.0, eps),),
             ref=lambda x: (block.ffn_block_ref(x, *ffn_w, 0.0, eps),),
             train_run=lambda x: block.ffn_block_fwd(x, *ffn_w, bits_f,
                                                     RATE, eps),
             train_ref=lambda x: block.ffn_block_fwd_ref(x, *ffn_w, bits_f,
                                                         RATE, eps),
             prng_run=lambda x: block.ffn_block_fwd(x, *ffn_w, rate=RATE,
                                                    eps=eps, seed=seed),
             prng_ref=lambda x: block.ffn_block_fwd_ref(
                 x, *ffn_w, rate=RATE, eps=eps, seed=seed)),
        dict(name="ffn_block_bwd", fn=block.ffn_block_bwd, bwd=True,
             source=SRC + "ffn_block.cu",
             replaces=JAX + "block_pallas.py:375",
             res=lambda x: block.ffn_block_fwd_ref(x, *ffn_w, bits_f, RATE,
                                                   eps),
             run=lambda x, res: block.ffn_block_bwd(
                 dys[x.dtype], x, res[1], res[2], res[3], w1, w2, ln_g,
                 bits_f, RATE, eps),
             ref=lambda x, res: block.ffn_block_bwd_ref(
                 dys[x.dtype], x, res[1], res[3], w1, w2, ln_g, bits_f,
                 RATE, eps),
             prng_res=lambda x: block.ffn_block_fwd_ref(
                 x, *ffn_w, rate=RATE, eps=eps, seed=seed),
             prng_run=lambda x, res: block.ffn_block_bwd(
                 dys[x.dtype], x, res[1], res[2], res[3], w1, w2, ln_g,
                 rate=RATE, eps=eps, seed=seed),
             prng_ref=lambda x, res: block.ffn_block_bwd_ref(
                 dys[x.dtype], x, res[1], res[3], w1, w2, ln_g,
                 rate=RATE, eps=eps, seed=seed)),
        dict(name="damsm_similarity", fn=damsm.damsm_similarity_cuda,
             source=SRC + "damsm.cu",
             replaces=JAX + "damsm_pallas.py:115", dtypes=(torch.float32,),
             atol=DAMSM_ATOL,
             run=lambda x: (damsm.damsm_similarity_cuda(words, regions, 4.0,
                                                        5.0),),
             ref=lambda x: (attention.damsm_similarity(words, regions, 4.0,
                                                       5.0),)),
    ]
    bounds = _bounds(B, T, H, heads, I, 2, D, TW, RG)
    rows = []
    for s in specs:
        row = {"name": s["name"], "route": "cuda", "source": s["source"],
               "replaces": s["replaces"]}
        check = _close_scaled if s.get("bwd") else _close
        dtypes = s.get("dtypes", (torch.bfloat16, torch.float32))
        for dt in dtypes:
            x = x32.to(dt)
            tol = s.get("atol", TOL[str(dt)[6:]])
            rtol = 0.0 if "atol" in s else tol
            tag = "" if dt == dtypes[0] else "_f32"
            if "res" in s:
                res = s["res"](x)
                run, ref = (lambda f=s["run"], r=res: lambda x: f(x, r))(), \
                    (lambda f=s["ref"], r=res: lambda x: f(x, r))()
            else:
                run, ref = s["run"], s["ref"]
            errs = []
            for k, (o, p) in enumerate(zip(run(x), ref(x))):
                torch.cuda.synchronize()
                err, ok = (check(o, p, tol) if s.get("bwd")
                           else _close(o, p, tol, rtol))
                errs.append(err)
                if not ok:
                    raise AssertionError(
                        f"{s['name']} {dt} output {k}: kernel disagrees with "
                        f"its plain version (max |err| {err})")
            row[f"max_abs_err{tag}"] = max(errs)
            row[f"tolerance{tag}"] = {"rtol": rtol, "atol": tol,
                                      "scaled": bool(s.get("bwd"))}
            if "train_run" in s:
                errs = []
                for k, (o, p) in enumerate(zip(s["train_run"](x),
                                               s["train_ref"](x))):
                    torch.cuda.synchronize()
                    err, ok = _close(o, p, tol)
                    errs.append(err)
                    if not ok:
                        raise AssertionError(
                            f"{s['name']} train {dt} output {k}: kernel "
                            f"disagrees with its plain version ({err})")
                row[f"max_abs_err_train{tag}"] = max(errs)
            if "prng_run" in s:
                prun, pref = _prng_pair(s, x)
                errs = []
                for k, (o, p) in enumerate(zip(prun(x), pref(x))):
                    torch.cuda.synchronize()
                    err, ok = check(o, p, tol)
                    errs.append(err)
                    if not ok:
                        raise AssertionError(
                            f"{s['name']} prng {dt} output {k}: kernel "
                            f"disagrees with its plain prng version ({err})")
                row[f"max_abs_err_prng{tag}"] = max(errs)
        x = x32.to(dtypes[0])
        if "res" in s:
            res = s["res"](x)
            run = (lambda f=s["run"], r=res: lambda: f(x, r))()
            ref = (lambda f=s["ref"], r=res: lambda: f(x, r))()
        else:
            run = (lambda f=s["run"]: lambda: f(x))()
            ref = (lambda f=s["ref"]: lambda: f(x))()
        row["ms"], row["ms_cold_l2"] = _times(run, flush, flush_ms)
        row["kernel_ms"] = row["ms"]
        row["plain_ms"], row["plain_ms_cold_l2"] = _times(ref, flush,
                                                          flush_ms)
        lib = s.get("library")
        row["library_ms"], row["library_ms_cold_l2"] = (
            (None, None) if lib is None else _times(lib(x), flush, flush_ms))
        row.update(bounds[s["name"]])
        if "train_run" in s:
            tr = (lambda f=s["train_run"]: lambda: f(x))()
            tp = (lambda f=s["train_ref"]: lambda: f(x))()
            row["ms_train"], row["ms_train_cold_l2"] = _times(tr, flush,
                                                              flush_ms)
            row["plain_ms_train"], _ = _times(tp, flush, flush_ms)
            b = bounds[s["name"] + "_train"]
            row["bound_ms_train"], row["bound_by_train"] = (b["bound_ms"],
                                                            b["bound_by"])
        if "prng_run" in s:
            prun, pref = _prng_pair(s, x)
            row["ms_prng"], row["ms_prng_cold_l2"] = _times(
                lambda: prun(x), flush, flush_ms)
            row["plain_ms_prng"], _ = _times(lambda: pref(x), flush,
                                             flush_ms)
            b = bounds[s["name"] + "_prng"]
            row["bound_ms_prng"], row["bound_by_prng"] = (b["bound_ms"],
                                                          b["bound_by"])
        rows.append(row)
        print(f"kernel {row['name']}: max|err| {row['max_abs_err']:.3g}"
              f"{'' if 'max_abs_err_f32' not in row else ', f32 %.3g' % row['max_abs_err_f32']}"
              f"; {row['ms']:.4f} ms, cold L2 {row['ms_cold_l2']:.4f} "
              f"(plain {row['plain_ms']:.4f}, library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} by {row['bound_by']})"
              + ("" if "ms_train" not in row else
                 f"; train {row['ms_train']:.4f} ms (plain "
                 f"{row['plain_ms_train']:.4f}, bound "
                 f"{row['bound_ms_train']:.4f})")
              + ("" if "ms_prng" not in row else
                 f"; prng {row['ms_prng']:.4f} ms (plain "
                 f"{row['plain_ms_prng']:.4f}, bound "
                 f"{row['bound_ms_prng']:.4f}, max|err| "
                 f"{row['max_abs_err_prng']:.3g})"), flush=True)
    ln_gen = torch.Generator().manual_seed(args.manual_seed + 5)
    for row, extra in ln_checks(dev, ln_gen, eps).items():
        rows[[r["name"] for r in rows].index(row)].update(extra)
    xb = x32.bfloat16()
    tables = half_layer_launches(xb, mask, attn_w, ffn_w, B, T, heads, eps)
    tables.update(half_layer_bwd_launches(
        xb, dys[torch.bfloat16], mask, attn_w, ffn_w, bits_p, bits_h, bits_f,
        seed, B, T, heads, eps))
    for row, launches in tables.items():
        rows[[r["name"] for r in rows].index(row)]["launch_breakdown"] = \
            launches
    # the bf16 attention forward without residuals takes captions up to
    # MAX_T_FWD (bert-base's position table): K5 at that length, two
    # captions with padded keys, against its plain version
    t_long = block.MAX_T_FWD
    long_gen = torch.Generator().manual_seed(args.manual_seed + 7)
    x_long = torch.randn(2 * t_long, H, generator=long_gen).to(
        dev, torch.bfloat16)
    mask_long = torch.ones(2, t_long, dtype=torch.int32, device=dev)
    mask_long[1, t_long // 3:] = 0
    for kw in (dict(rate=0.0), dict(rate=RATE, seed=seed)):
        got = block.attn_block_fwd(x_long, mask_long, *attn_w, 2, t_long,
                                   heads, eps=eps, save=False, **kw)[0]
        want = block.attn_block_fwd_ref(x_long, mask_long, *attn_w, 2,
                                        t_long, heads, eps=eps, **kw)[0]
        torch.cuda.synchronize()
        err, ok = _close(got, want, TOL["bfloat16"])
        if not ok:
            raise AssertionError(f"attn_block at t = {t_long} "
                                 f"{kw.get('rate')}: kernel disagrees with "
                                 f"its plain version ({err})")
        rows[[r["name"] for r in rows].index("attn_block")][
            f"max_abs_err_t{t_long}" + ("_prng" if kw["rate"] else "")] = err
    # with residuals (training) too, past 128 the tensor-core tile, its
    # saved p included
    for kw in (dict(rate=0.0), dict(rate=RATE, seed=seed)):
        got = block.attn_block_fwd(x_long, mask_long, *attn_w, 2, t_long,
                                   heads, eps=eps, **kw)
        want = block.attn_block_fwd_ref(x_long, mask_long, *attn_w, 2,
                                        t_long, heads, eps=eps, **kw)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("y", "qkv", "p", "o", "r"), got, want):
            err, ok = (_close_scaled if name == "r" else _close)(
                a, b, TOL["bfloat16"])
            errs.append(err)
            if not ok:
                raise AssertionError(f"attn_block with residuals at t = "
                                     f"{t_long} {kw.get('rate')}: {name} "
                                     f"disagrees with its plain version "
                                     f"({err})")
        rows[[r["name"] for r in rows].index("attn_block")][
            f"max_abs_err_train_t{t_long}"
            + ("_prng" if kw["rate"] else "")] = max(errs)
    k5 = rows[[r["name"] for r in rows].index("attn_block")]
    print(f"kernel attn_block at t = {t_long} (bf16, 2 captions): max|err| "
          f"{k5[f'max_abs_err_t{t_long}']:.3g}, prng "
          f"{k5[f'max_abs_err_t{t_long}_prng']:.3g}; with residuals (p "
          f"included) {k5[f'max_abs_err_train_t{t_long}']:.3g}, prng "
          f"{k5[f'max_abs_err_train_t{t_long}_prng']:.3g}", flush=True)
    for row, errs in long_backwards(dev, attn_w, ffn_w, H, heads, eps,
                                    seed).items():
        rows[[r["name"] for r in rows].index(row)].update(errs)
    # the half-layer backwards' LN sums (the bias gradient, dgamma, dbeta)
    # are bit for bit the same over two calls
    for s in specs:
        if s["name"] in ("ffn_block_bwd", "attn_block_bwd"):
            x = x32.to(torch.bfloat16)
            res = s["res"](x)
            one, two = s["run"](x, res), s["run"](x, res)
            if not all(torch.equal(a, b) for a, b in zip(one[4:], two[4:])):
                raise AssertionError(f"{s['name']}: LN sums differ between "
                                     "two calls")
            rows[[r["name"] for r in rows].index(s["name"])][
                "ln_sums_bitwise_repeat"] = True
    rows[[r["name"] for r in rows].index("damsm_similarity")].update(
        damsm_extras(dev, B, D, TW, RG, args.manual_seed + 11, flush,
                     flush_ms))
    print("kernel damsm_similarity, flagship masked, yardsticks and t = "
          f"{DAMSM_LONG_T}: " + json.dumps({k: v for k, v in rows[-1].items()
                                            if "t510" in k or "bmm" in k
                                            or "flagship" in k
                                            or "f32_fma" in k}), flush=True)
    towers = tower_kernels(dev, B, T, H, heads, I, mask, x32, dy32, gen,
                           flush, seed)
    return rows[:6] + towers + rows[6:]


def long_backwards(dev, attn_w, ffn_w, H, heads, eps, seed) -> dict:
    """K4 and K6 at caption lengths past the T = 24 of the main checks: two
    captions of T in LONG_T (the second's keys padded past a third), from
    the plain forward's residuals, host bits and prng mode, against their
    plain versions; in bf16 at every T, in f32 up to its limit of 64.
    Returns {kernel: {max_abs_err_t<T>[_prng][_f32]: err}}."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import block
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw

    gen = torch.Generator().manual_seed(17)
    dgen = torch.Generator(device=dev).manual_seed(19)
    wqkv, wo, g = attn_w[0], attn_w[2], attn_w[4]
    w1, w2 = ffn_w[0], ffn_w[2]
    out = {"attn_block_bwd": {}, "ffn_block_bwd": {}}
    for t in LONG_T:
        x32 = torch.randn(2 * t, H, generator=gen).to(dev)
        dy32 = torch.randn(2 * t, H, generator=gen).to(dev)
        mask = torch.ones(2, t, dtype=torch.int32, device=dev)
        mask[1, max(1, t // 3):] = 0
        bits_p = draw(heads * 2 * t * t, dgen, dev).view(heads * 2, t, t)
        bits_h = draw(2 * t * H, dgen, dev).view(2 * t, H)
        for dt in (torch.bfloat16, torch.float32):
            if t > block.max_t(dt, True):
                continue
            x, dy, tol = x32.to(dt), dy32.to(dt), TOL[str(dt)[6:]]
            for mode, akw, fkw in (
                    ("", dict(bits_p=bits_p, bits_h=bits_h),
                     dict(bits=bits_h)),
                    ("_prng", dict(seed=seed), dict(seed=seed))):
                res = block.attn_block_fwd_ref(x, mask, *attn_w, 2, t, heads,
                                               rate=RATE, eps=eps, **akw)
                args = (dy, x, *res[1:], wqkv, wo, g, 2, t, heads)
                pairs = {"attn_block_bwd": zip(
                    block.attn_block_bwd(*args, rate=RATE, eps=eps, **akw),
                    block.attn_block_bwd_ref(*args, rate=RATE, eps=eps,
                                             **akw))}
                _, f, act, r = block.ffn_block_fwd_ref(x, *ffn_w, rate=RATE,
                                                       eps=eps, **fkw)
                pairs["ffn_block_bwd"] = zip(
                    block.ffn_block_bwd(dy, x, f, act, r, w1, w2, g,
                                        rate=RATE, eps=eps, **fkw),
                    block.ffn_block_bwd_ref(dy, x, f, r, w1, w2, g,
                                            rate=RATE, eps=eps, **fkw))
                for name, outs in pairs.items():
                    errs = []
                    for k, (a, b) in enumerate(outs):
                        torch.cuda.synchronize()
                        err, ok = _close_scaled(a, b, tol)
                        errs.append(err)
                        if not ok:
                            raise AssertionError(
                                f"{name} at t = {t} {dt}{mode} output {k}: "
                                f"kernel disagrees with its plain version "
                                f"({err})")
                    key = f"max_abs_err_t{t}{mode}" + (
                        "_f32" if dt == torch.float32 else "")
                    out[name][key] = max(errs)
    for name, errs in out.items():
        print(f"kernel {name} at t in {LONG_T} (2 captions): max|err| "
              + ", ".join(f"{k[11:]} {v:.3g}" for k, v in errs.items()),
              flush=True)
    return out


def _launch_seq_us(fn, calls: int = 20, tries: int = 3) -> list:
    """The device kernels one call of fn launches, one entry a launch in
    the first call's order of starts (two launches of one kernel stay
    apart; launches on two streams may start in another order in another
    call, so each call's k-th launch of a kernel is matched to the first
    call's), from torch.profiler over `calls` calls (after one to warm
    up): [(kernel name, device us)], each the mean over the calls. The
    profiler now and then loses a window's device events; such a window
    (events that do not split into equal calls) is taken again, up to
    `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if not ev or len(ev) % calls:
            continue
        n = len(ev) // calls
        first = [e.name for e in ev[:n]]
        slots = {}
        for i, name in enumerate(first):
            slots.setdefault(name, []).append(i)
        total, ok = [0.0] * n, True
        for c in range(calls):
            seen = {}
            for e in ev[c * n:(c + 1) * n]:
                k = seen.get(e.name, 0)
                seen[e.name] = k + 1
                if k >= len(slots.get(e.name, ())):
                    ok = False
                    break
                total[slots[e.name][k]] += e.time_range.elapsed_us()
            if not ok:
                break
        if ok:
            return [(name, us / calls) for name, us in zip(first, total)]
    raise AssertionError(f"the profiler's device events did not split into "
                         f"{calls} equal calls in {tries} tries")


def half_layer_launches(x, mask, attn_w, ffn_w, B, T, heads, eps) -> dict:
    """K3 and K5 (bf16, eval) launch by launch: each kernel's device us per
    call (torch.profiler) beside one PyTorch call doing that launch's work
    on the same bf16-rounded operands: torch.matmul for each GEMM (the
    weight rounded once, outside the timed call), F.layer_norm for the LN
    rows, F.scaled_dot_product_attention for the attention. Reference
    columns only; the port calls none of them."""
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.ops import block

    wqkv, _, wo, _, g, b = attn_w
    w1, _, w2 = ffn_w[:3]
    H = x.shape[1]
    # each launch's inputs, as the kernels see them
    _, qkv, _, o, r1 = block.attn_block_fwd(x, mask, *attn_w, B, T, heads,
                                            eps=eps)
    _, _, act, r2 = block.ffn_block_fwd(x, *ffn_w, eps=eps)
    wb = {k: v.t().contiguous().bfloat16() for k, v in
          (("wqkv", wqkv), ("wo", wo), ("w1", w1), ("w2", w2))}
    gb, bb = g.bfloat16(), b.bfloat16()
    q, k, v = (qkv[:, i * H:(i + 1) * H].reshape(B, T, heads, -1)
               .transpose(1, 2) for i in range(3))
    neg = torch.finfo(torch.float32).min
    amask = torch.where(mask[:, None, None, :] > 0, 0.0, neg).to(x.dtype)

    def ref_us(fn):
        return sum(us for _, us in _launch_seq_us(fn))

    refs = {
        "attn_block": [
            ("torch.matmul x . Wqkv^T", ref_us(
                lambda: torch.matmul(x, wb["wqkv"].t()))),
            ("F.scaled_dot_product_attention", ref_us(
                lambda: F.scaled_dot_product_attention(q, k, v, amask))),
            ("torch.matmul o . Wo^T", ref_us(
                lambda: torch.matmul(o, wb["wo"].t()))),
            ("F.layer_norm", ref_us(
                lambda: F.layer_norm(r1, (H,), gb, bb, eps)))],
        "ffn_block": [
            ("torch.matmul x . W1^T", ref_us(
                lambda: torch.matmul(x, wb["w1"].t()))),
            ("torch.matmul act . W2^T", ref_us(
                lambda: torch.matmul(act, wb["w2"].t()))),
            ("F.layer_norm", ref_us(
                lambda: F.layer_norm(r2, (H,), gb, bb, eps)))]}
    runs = {"attn_block": lambda: block.attn_block_fwd(
                x, mask, *attn_w, B, T, heads, eps=eps, save=False),
            "ffn_block": lambda: block.ffn_block_fwd(x, *ffn_w, eps=eps,
                                                     save=False)}
    out = {}
    for name, run in runs.items():
        launches = _launch_seq_us(run)
        if len(launches) != len(refs[name]):
            raise AssertionError(f"{name}: {len(launches)} device launches "
                                 f"a call, expected {len(refs[name])}: "
                                 f"{launches}")
        out[name] = [{"kernel": kn, "us": us, "reference": rn,
                      "reference_us": rus}
                     for (kn, us), (rn, rus) in zip(launches, refs[name])]
        print(f"kernel {name} launch by launch (bf16 eval, device us a "
              "call): " + "; ".join(
                  f"{d['kernel'][:60]} {d['us']:.3f} (beside "
                  f"{d['reference']} {d['reference_us']:.3f})"
                  for d in out[name]), flush=True)
    return out


def half_layer_bwd_launches(x, dy, mask, attn_w, ffn_w, bits_p, bits_h,
                            bits_f, seed, B, T, heads, eps) -> dict:
    """K4 and K6 (bf16) launch by launch, with host bits (`*_bwd`) and in
    prng mode (`*_bwd_prng`): each kernel's device us per call
    (torch.profiler) beside one PyTorch call doing that launch's work on
    the same bf16-rounded operands: torch.matmul for each GEMM (the weight
    rounded once, outside the timed call),
    torch.ops.aten.native_layer_norm_backward for the LN row pass,
    Tensor.sum(0) for a bias gradient's column sums (added to the weight
    gradient's matmul where one launch computes both), and the device time
    of the backward kernels of F.scaled_dot_product_attention at (B, heads,
    T, 64) for the per-head backward. Reference columns only; the port
    calls none of them."""
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.ops import block

    wqkv, _, wo, _, g, b = attn_w
    w1, _, w2 = ffn_w[:3]
    H = x.shape[1]
    wb = {k: v.t().contiguous().bfloat16() for k, v in
          (("wqkv", wqkv), ("wo", wo), ("w1", w1), ("w2", w2))}
    gb, bb = g.bfloat16(), b.bfloat16()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [H], gb, bb, eps)
    # operands of the shapes each launch sees (their values do not move a
    # reference's time)
    xi = torch.randn(x.shape[0], ffn_w[0].shape[1], device=x.device).to(
        x.dtype)
    xq = torch.randn(x.shape[0], 3 * H, device=x.device).to(x.dtype)
    q, k, v = (torch.randn(B, heads, T, H // heads, device=x.device,
                           dtype=x.dtype, requires_grad=True)
               for _ in range(3))
    neg = torch.finfo(torch.float32).min
    amask = torch.where(mask[:, None, None, :] > 0, 0.0, neg).to(x.dtype)
    sdpa = F.scaled_dot_product_attention(q, k, v, amask)
    do = torch.randn_like(sdpa)

    def ref_us(fn):
        return 1e3 * _graph_ms(fn)

    ln = ("native_layer_norm_backward", ref_us(
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [H], mean, rstd, gb, bb, [True, True, True])))
    colsum_i = ref_us(lambda: xi.sum(0))
    colsum_q = ref_us(lambda: xq.sum(0))
    # the GEMMs' references: the weight gradients in launch order (the
    # second with the bias gradient's column sums where no launch of its
    # own sums them), then the data gradients in launch order
    refs = {
        "ffn_block_bwd": dict(sums=colsum_i, dw=[
            ("torch.matmul dgg^T . act", ref_us(
                lambda: torch.matmul(x.t(), xi))),
            ("torch.matmul df^T . x", ref_us(
                lambda: torch.matmul(xi.t(), x)))], dx=[
            ("torch.matmul dgg . W2", ref_us(
                lambda: torch.matmul(x, wb["w2"]))),
            ("torch.matmul df . W1", ref_us(
                lambda: torch.matmul(xi, wb["w1"])))]),
        "attn_block_bwd": dict(sums=colsum_q, dw=[
            ("torch.matmul dh^T . o", ref_us(
                lambda: torch.matmul(x.t(), x))),
            ("torch.matmul dqkv^T . x", ref_us(
                lambda: torch.matmul(xq.t(), x)))], dx=[
            ("torch.matmul dh . Wo", ref_us(
                lambda: torch.matmul(x, wb["wo"]))),
            ("torch.matmul dqkv . Wqkv", ref_us(
                lambda: torch.matmul(xq, wb["wqkv"])))],
            attn=("scaled_dot_product_attention backward", sum(
                us for _, us in _launch_seq_us(
                    lambda: torch.autograd.grad(sdpa, (q, k, v), do,
                                                retain_graph=True)))))}

    def beside(name, launches):
        """Each launch's reference, by its kind: the weight gradients are
        the route's mode 2 (hl_bwd_gemm_kernel<2, ...>) or the core's
        (A stored (K, M), gemm_kernel<..., 4, 1, 2>)."""
        r, out = refs[name], []
        dw, dx = iter(r["dw"]), iter(r["dx"])
        fused = not any("colsum" in kn for kn, _ in launches)
        n_dw = 0
        for kn, _ in launches:
            if "layernorm_bwd" in kn:
                out.append(ln)
            elif "colsum" in kn:
                out.append(("Tensor.sum(0)", r["sums"]))
            elif "attention" in kn:
                out.append(r["attn"])
            elif "gemm_kernel<2," in kn or "4, 1, 2>" in kn:
                label, us = next(dw)
                n_dw += 1
                if fused and n_dw == 2:
                    label, us = label + " + Tensor.sum(0)", us + r["sums"]
                out.append((label, us))
            else:
                out.append(next(dx))
        return out

    fres = block.ffn_block_fwd(x, *ffn_w, bits_f, RATE, eps)
    fres_p = block.ffn_block_fwd(x, *ffn_w, rate=RATE, eps=eps, seed=seed)
    ares = block.attn_block_fwd(x, mask, *attn_w, B, T, heads, bits_p,
                                bits_h, RATE, eps)
    ares_p = block.attn_block_fwd(x, mask, *attn_w, B, T, heads, rate=RATE,
                                  eps=eps, seed=seed)
    runs = {
        "ffn_block_bwd": (
            lambda: block.ffn_block_bwd(dy, x, *fres[1:], w1, w2, g, bits_f,
                                        RATE, eps),
            lambda: block.ffn_block_bwd(dy, x, *fres_p[1:], w1, w2, g,
                                        rate=RATE, eps=eps, seed=seed)),
        "attn_block_bwd": (
            lambda: block.attn_block_bwd(dy, x, *ares[1:], wqkv, wo, g, B, T,
                                         heads, bits_p, bits_h, RATE, eps),
            lambda: block.attn_block_bwd(dy, x, *ares_p[1:], wqkv, wo, g, B,
                                         T, heads, rate=RATE, eps=eps,
                                         seed=seed))}
    out = {}
    for name, (host, prng) in runs.items():
        rows = []
        for mode, run in (("train", host), ("prng", prng)):
            # prng mode's seed is handed over as stream seed ^ 0x5BD1E995
            # by a small elementwise kernel (ffn only): no reference
            launches = [(kn, us) for kn, us in _launch_seq_us(run)
                        if kn.startswith(("void tgfr", "tgfr"))]
            ref = beside(name, launches)
            rows += [{"mode": mode, "kernel": kn, "us": us,
                      "reference": rn, "reference_us": rus}
                     for (kn, us), (rn, rus) in zip(launches, ref)]
            print(f"kernel {name} launch by launch (bf16 {mode}, device us "
                  "a call): " + "; ".join(
                      f"{kn[:60]} {us:.3f} (beside {rn} {rus:.3f})"
                      for (kn, us), (rn, rus) in zip(launches, ref))
                  + f"; sum of launches {sum(us for _, us in launches):.3f}",
                  flush=True)
        out[name] = rows
    return out


def launches_phase(args) -> None:
    """K3-K6 launch by launch alone (`--only launches`): the inputs of
    kernel_phase's flagship shape, the tables of half_layer_launches and
    half_layer_bwd_launches."""
    import numpy as np
    import torch

    from text_guided_face_recognition_tpu_torch.engine.prepare import (
        _synthetic_bert)
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw

    dev = torch.device("cuda")
    seed = torch.tensor([args.manual_seed + 3], dtype=torch.int32,
                        device=dev)
    B, T, H, heads, I = 32, args.bert_words_num, 768, 12, 3072
    R = B * T
    eps = 1e-12
    _, _, masks = _synthetic_bert(args, B)
    mask = torch.from_numpy(np.stack(masks[::args.captions_per_image][:B]))
    mask = mask.to(dev, torch.int32).contiguous()
    gen = torch.Generator().manual_seed(args.manual_seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x, dy = rn(R, H).bfloat16(), rn(R, H).bfloat16()
    ln_g, ln_b = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    attn_w = (rn(3 * H, H, std=H ** -0.5).t(), rn(3 * H, std=0.1),
              rn(H, H, std=H ** -0.5).t(), rn(H, std=0.1), ln_g, ln_b)
    ffn_w = (rn(I, H, std=H ** -0.5).t(), rn(I, std=0.1),
             rn(H, I, std=I ** -0.5).t(), rn(H, std=0.1), ln_g, ln_b)
    dgen = torch.Generator(device=dev).manual_seed(args.manual_seed + 1)
    bits_p = draw(heads * B * T * T, dgen, dev).view(heads * B, T, T)
    bits_h = draw(R * H, dgen, dev).view(R, H)
    bits_f = draw(R * H, dgen, dev).view(R, H)
    half_layer_launches(x, mask, attn_w, ffn_w, B, T, heads, eps)
    half_layer_bwd_launches(x, dy, mask, attn_w, ffn_w, bits_p, bits_h,
                            bits_f, seed, B, T, heads, eps)


def _prng_pair(spec, x):
    """A kernel spec's prng-mode (run, plain) as functions of x, bound to
    the prng forward's residuals where the spec is a backward."""
    if "prng_res" not in spec:
        return spec["prng_run"], spec["prng_ref"]
    res = spec["prng_res"](x)
    return ((lambda x_: spec["prng_run"](x_, res)),
            (lambda x_: spec["prng_ref"](x_, res)))


def _event_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call from CUDA events around `calls` back-to-back
    calls of fn; the median of `reps` such spans."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _event_times(fn, flush) -> tuple:
    """(warm-L2 ms, cold-L2 ms) per call of fn by `_event_ms`; the cold
    time is flush + call less the flush alone."""
    def cold():
        flush()
        fn()
    return _event_ms(fn), _event_ms(cold) - _event_ms(flush)


def _one_bf16_step(a, c) -> tuple:
    """(the largest |a - c| / |c|, whether a is within one bf16 step of the
    f32 value c everywhere: |a - c| <= 2^-7 |c|)."""
    a, c = a.float(), c.float()
    err = (a - c).abs()
    rel = (err / c.abs().clamp_min(1e-30)).max().item()
    return rel, bool((err <= 2.0 ** -7 * c.abs() + 1e-30).all())


# The phases of the tower kernels, in a layer's order (csrc/tower_block.cu)
TOWER_PHASES = {
    0: ("qkv", "attention", "wo_resid", "ln1", "w1_gelu", "w2_resid",
        "ln2"),
    1: ("ln2_bwd", "dw2_df_sums", "dy_dw1_dc1", "ln1_bwd", "dwo_do_sums",
        "attention_bwd", "dx_dwqkv_dbqkv")}


def _ptxas(lib: str, pattern: str) -> list:
    """Registers and spills of the entry functions of built library `lib`
    whose mangled name holds `pattern`, from nvcc's -Xptxas -v report."""
    from text_guided_face_recognition_tpu_torch.ops import _cuda
    out, cur = [], None
    log = _cuda._target(lib).with_suffix(".so.log")
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            cur = {"function": line.split("'")[1]}
            if pattern in cur["function"]:
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            w = line.replace(",", "").split()
            cur["stack_bytes"] = int(w[0])
            cur["spill_store_bytes"] = int(w[4])
            cur["spill_load_bytes"] = int(w[8])
        elif cur is not None and "Used" in line and "registers" in line:
            w = line.replace(",", "").split()
            cur["registers"] = int(w[w.index("Used") + 1])
    return out


def tower_phases(dev, B, T, H, heads, I, mask, gen, seed, reps: int = 5
                 ) -> dict:
    """Device time of each phase and each grid barrier of K7 (eval and prng
    mode) and K8 (prng mode), 12 layers at R = B T, bf16, from the
    measurement build of csrc/tower_block.cu (TGFR_PHASE_TIMES: %globaltimer
    stamps at every barrier; loaded here only). Per phase name: its time
    summed over the layers (ms) and per layer (us), the median of `reps`
    calls; the barriers' total and mean; the stamped span."""
    import ctypes

    import torch

    from text_guided_face_recognition_tpu_torch.ops import _cuda, block

    lib = "tower_block_phases"
    _cuda.build([lib])
    reset = _cuda.function(lib, "tgfr_tower_phase_reset",
                           (ctypes.c_void_p,))
    read = _cuda.function(lib, "tgfr_tower_phase_read",
                          (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p))
    L, R, eps = 12, B * T, 1e-12

    def rn(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=gen) * std).to(dev)

    m = dict(
        wqkv=rn(L, 3 * H, H, std=H ** -0.5), bqkv=rn(L, 1, 3 * H, std=0.1),
        wo=rn(L, H, H, std=H ** -0.5), bo=rn(L, 1, H, std=0.1),
        g1=rn(L, 1, H, std=0.1, mean=1.0), b1=rn(L, 1, H, std=0.1),
        w1=rn(L, I, H, std=H ** -0.5), c1=rn(L, 1, I, std=0.1),
        w2=rn(L, H, I, std=I ** -0.5), c2=rn(L, 1, H, std=0.1),
        g2=rn(L, 1, H, std=0.1, mean=1.0), b2=rn(L, 1, H, std=0.1))
    lv = {k: (v.bfloat16().transpose(1, 2) if k.startswith("w")
              else v.bfloat16()) for k, v in m.items()}
    x, dz = rn(R, H).bfloat16(), rn(R, H).bfloat16()
    args7 = (x, mask, *lv.values(), B, T, heads)
    w8 = [lv[k] for k in ("wqkv", "wo", "g1", "b1", "w1", "w2", "g2")]
    res = block.tower_block_fwd(*args7, rate=RATE, eps=eps, seed=seed)
    runs = {
        "k7_eval": (0, lambda: block.tower_block_fwd(
            *args7, rate=0.0, eps=eps, save=False)),
        "k7_prng": (0, lambda: block.tower_block_fwd(
            *args7, rate=RATE, eps=eps, seed=seed)),
        "k8_prng": (1, lambda: block.tower_block_bwd(
            dz, mask, *res[1:], *w8, B, T, heads, rate=RATE, eps=eps,
            seed=seed))}
    n = 7 * L
    stamps = (ctypes.c_ulonglong * (1 + 2 * n))()
    smid = (ctypes.c_uint * 1024)()
    out = {}
    before, block._TOWER_LIB = block._TOWER_LIB, lib
    try:
        for key, (d, fn) in runs.items():
            fn()
            torch.cuda.synchronize()
            per = []
            for _ in range(reps):
                _cuda.launch(reset)
                fn()
                _cuda.launch(read, d, ctypes.addressof(stamps),
                             ctypes.addressof(smid), n)
                t = [int(v) for v in stamps]
                start, arrive, release = t[0], t[1:1 + n], t[1 + n:]
                work = [arrive[i] - (start if i == 0 else release[i - 1])
                        for i in range(n)]
                bars = [release[i] - arrive[i] for i in range(n - 1)]
                per.append((work, bars, arrive[-1] - start))
            phases = {}
            for k, name in enumerate(TOWER_PHASES[d]):
                tot = statistics.median(
                    sum(w[j * 7 + k] for j in range(L)) for w, _, _ in per)
                phases[name] = {"ms_total": tot / 1e6,
                                "us_per_layer": tot / 1e3 / L}
            bar = statistics.median(sum(b) for _, b, _ in per)
            out[key] = {
                "phases": phases, "barriers": n - 1,
                "barriers_ms_total": bar / 1e6,
                "barrier_us_mean": bar / 1e3 / (n - 1),
                "stamped_ms": statistics.median(s for _, _, s in per) / 1e6,
                "grid": dict(zip(("blocks", "per_sm", "smem_bytes"),
                                 (block.tower_block_bwd if d else
                                  block.tower_block_fwd).info))}
            grid = out[key]["grid"]["blocks"]
            first = [smid[i] for i in range(min(grid, 1024))]
            # how many SMs the first of every `sms` blocks spread over
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out[key]["sms_of_first_blocks"] = len(set(first[:sms]))
            print(f"phases {key}: grid {out[key]['grid']}, the first "
                  f"{min(sms, len(first))} blocks on "
                  f"{out[key]['sms_of_first_blocks']} SMs; "
                  f"stamped {out[key]['stamped_ms']:.4f} ms, "
                  f"{n - 1} barriers {out[key]['barriers_ms_total']:.4f} ms "
                  f"(mean {out[key]['barrier_us_mean']:.2f} us); "
                  + ", ".join(f"{p} {v['us_per_layer']:.2f} us"
                              for p, v in phases.items()), flush=True)
    finally:
        block._TOWER_LIB = before
    out["ptxas"] = _ptxas("tower_block", "tower_")
    print(f"ptxas tower_block: {json.dumps(out['ptxas'])}", flush=True)
    return out


def _tower_inputs(args) -> tuple:
    """(dev, B, T, H, heads, I, mask, gen, seed) of the flagship tower, as
    kernel_phase makes them."""
    import numpy as np
    import torch

    from text_guided_face_recognition_tpu_torch.engine.prepare import (
        _synthetic_bert)
    dev = torch.device("cuda")
    B = 32
    _, _, masks = _synthetic_bert(args, B)
    mask = torch.from_numpy(np.stack(masks[::args.captions_per_image][:B]))
    seed = torch.tensor([args.manual_seed + 3], dtype=torch.int32,
                        device=dev)
    return (dev, B, args.bert_words_num, 768, 12, 3072,
            mask.to(dev, torch.int32).contiguous(),
            torch.Generator().manual_seed(args.manual_seed), seed)


def tower_kernels(dev, B, T, H, heads, I, mask, x32, dz32, gen, flush,
                  seed):
    """K7 and K8 at the flagship tower (12 layers) against their plain
    versions, host bits and prng mode (`seed`), and against the half-layer
    chains; returns their two rows."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import block, philox
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw

    L, R, eps = 12, B * T, 1e-12
    n_p, n_h = heads * B * T * T, R * H

    def rn(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=gen) * std).to(dev)

    # f32 masters, stacked; weights stored (L, out, in) as nn.Linear has them
    m = dict(
        wqkv=rn(L, 3 * H, H, std=H ** -0.5), bqkv=rn(L, 1, 3 * H, std=0.1),
        wo=rn(L, H, H, std=H ** -0.5), bo=rn(L, 1, H, std=0.1),
        g1=rn(L, 1, H, std=0.1, mean=1.0), b1=rn(L, 1, H, std=0.1),
        w1=rn(L, I, H, std=H ** -0.5), c1=rn(L, 1, I, std=0.1),
        w2=rn(L, H, I, std=I ** -0.5), c2=rn(L, 1, H, std=0.1),
        g2=rn(L, 1, H, std=0.1, mean=1.0), b2=rn(L, 1, H, std=0.1))
    dgen = torch.Generator(device=dev).manual_seed(7)
    flat = draw(L * (n_p + 2 * n_h), dgen, dev).view(L, n_p + 2 * n_h)
    bits = (flat[:, :n_p].unflatten(1, (heads * B, T, T)),
            flat[:, n_p:n_p + n_h].unflatten(1, (R, H)),
            flat[:, n_p + n_h:].unflatten(1, (R, H)))
    none = (None, None, None)
    bwd_names = ("wqkv", "wo", "g1", "b1", "w1", "w2", "g2")

    def leaves(dt):
        """The stacked leaves as the model hands them over, in dt."""
        return {k: (v.to(dt).transpose(1, 2) if k.startswith("w")
                    else v.to(dt)) for k, v in m.items()}

    def chain_fwd(x, bt, rate):
        """12 x (K5, K3) from the f32 masters: (z, per-layer residuals)."""
        res = []
        for j in range(L):
            bp, bh, bf = (None if b_ is None else b_[j] for b_ in bt)
            y, qkv, p, o, r1 = block.attn_block_fwd(
                x, mask, m["wqkv"][j].t(), m["bqkv"][j, 0], m["wo"][j].t(),
                m["bo"][j, 0], m["g1"][j, 0], m["b1"][j, 0], B, T, heads, bp,
                bh, rate, eps)
            z, f, act, r2 = block.ffn_block_fwd(
                y, m["w1"][j].t(), m["c1"][j, 0], m["w2"][j].t(),
                m["c2"][j, 0], m["g2"][j, 0], m["b2"][j, 0], bf, rate, eps)
            res.append((x, qkv, p, o, r1, y, f, act, r2))
            x = z
        return x, res

    def chain_bwd(dz, res, bt, rate):
        """12 x (K4, K6): (dx, {leaf: [per-layer f32 gradient]})."""
        g = {k: [None] * L for k in block.TOWER_LEAVES}
        for j in reversed(range(L)):
            bp, bh, bf = (None if b_ is None else b_[j] for b_ in bt)
            x, qkv, p, o, r1, y, f, act, r2 = res[j]
            dy, g["w1"][j], g["c1"][j], g["w2"][j], g["c2"][j], g["g2"][j], \
                g["b2"][j] = block.ffn_block_bwd(
                    dz, y, f, act, r2, m["w1"][j].t(), m["w2"][j].t(),
                    m["g2"][j, 0], bf, rate, eps)
            dz, g["wqkv"][j], g["bqkv"][j], g["wo"][j], g["bo"][j], \
                g["g1"][j], g["b1"][j] = block.attn_block_bwd(
                    dy, x, qkv, p, o, r1, m["wqkv"][j].t(), m["wo"][j].t(),
                    m["g1"][j, 0], B, T, heads, bp, bh, rate, eps)
        return dz, g

    shape = (L, B, T, H, heads, I, 2)
    bounds = _tower_bounds(*shape)
    k7 = {"name": "tower_block", "route": "cuda",
          "source": SRC + "tower_block.cu",
          "replaces": JAX + "block_pallas.py:916", "layers": L}
    k8 = {"name": "tower_block_bwd", "route": "cuda",
          "source": SRC + "tower_block.cu",
          "replaces": JAX + "block_pallas.py:964", "layers": L}

    def hold(row, key, what, pairs, tol, scaled):
        errs = []
        for name, a, b_ in pairs:
            torch.cuda.synchronize()
            err, ok = (_close_scaled if scaled else _close)(a, b_, tol)
            errs.append(err)
            if not ok:
                raise AssertionError(f"{row['name']} {what} output {name}: "
                                     f"max |err| {err} over tolerance {tol}")
        row[key] = max(errs)

    fwd_out = ("z", "xin", "qkv", "p", "o", "r1", "f", "r2")
    for dt in (torch.bfloat16, torch.float32):
        tag = "" if dt == torch.bfloat16 else "_f32"
        tol = TOL[str(dt)[6:]]
        x, dz = x32.to(dt), dz32.to(dt)
        lv = leaves(dt)
        args7 = (x, mask, *lv.values(), B, T, heads)
        # K7 layer by layer: each layer of the kernel's output against the
        # plain version run from the kernel's own input to that layer, so
        # every layer is held element-wise like a half-layer kernel and no
        # rounding flip of an earlier layer is carried into the comparison
        def layerwise(got, bt, rate):
            pairs, outs = [], []
            for j in range(L):
                ref = block.tower_block_fwd_ref(
                    got[1][j], mask, *(v[j:j + 1] for v in lv.values()), B,
                    T, heads, *(None if b_ is None else b_[j:j + 1]
                                for b_ in bt), rate, eps)
                outs.append((f"z of layer {j}",
                             got[0] if j == L - 1 else got[1][j + 1],
                             ref[0]))
                for n, g, r in zip(fwd_out[2:], got[2:], ref[2:]):
                    (outs if n in ("r1", "r2") else pairs).append(
                        (f"{n} of layer {j}", g[j], r[0]))
            pairs.append(("xin of layer 0", got[1][0], x))
            return pairs, outs

        def hold_layers(key, what, got, bt, rate):
            """qkv, p, o and f element-wise; the two residual sums r1 =
            x + h and r2 = y + g and the output z = LN(r2), in bf16, to the
            tolerance times the largest element: where an addend flipped
            one bf16 step (0.031 at a magnitude in [4, 8)) and the other
            nearly cancels it, the sum is off by that step at an element
            near zero, and z by the step over the row's deviation. Twelve
            layers give such an element twelve times the chances one
            half-layer's check has."""
            pairs, outs = layerwise(got, bt, rate)
            hold(k7, key, what, pairs, tol, False)
            resid = k7[key]
            hold(k7, key, what, outs, tol, dt == torch.bfloat16)
            k7[key] = max(resid, k7[key])

        # eval mode (rate 0): with residuals for the layer-wise check, and
        # without, as serving calls it; the two outputs are the same bits
        got0 = block.tower_block_fwd(*args7, *none, 0.0, eps)
        hold_layers(f"max_abs_err{tag}", f"{dt}", got0, none, 0.0)
        k7[f"tolerance{tag}"] = {"rtol": tol, "atol": tol, "per": "layer",
                                 "scaled": "r1, r2 and z in bf16 only"}
        z_k = block.tower_block_fwd(*args7, *none, 0.0, eps, save=False)
        if any(r is not None for r in z_k[1:]):
            raise AssertionError("tower_block kept residuals in eval mode")
        if not torch.equal(z_k[0], got0[0]):
            raise AssertionError("tower_block: z differs with and without "
                                 "residuals")
        # all 12 layers against the plain tower: f32 element-wise; bf16 to
        # the tolerance times the largest element, since a flipped rounding
        # of one layer is carried through the LayerNorms of the next
        z_p = block.tower_block_fwd_ref(*args7, *none, 0.0, eps)[0]
        hold(k7, f"max_abs_err_end_to_end{tag}", f"12 layers {dt}",
             [("z", z_k[0], z_p)], tol, dt == torch.bfloat16)
        del got0
        # train mode: rate 0.1, the residuals
        got = block.tower_block_fwd(*args7, *bits, RATE, eps)
        hold_layers(f"max_abs_err_train{tag}", f"train {dt}", got, bits,
                    RATE)
        ref = block.tower_block_fwd_ref(*args7, *bits, RATE, eps)
        hold(k7, f"max_abs_err_train_end_to_end{tag}",
             f"train, 12 layers {dt}", [("z", got[0], ref[0])], tol,
             dt == torch.bfloat16)
        # K8 at the plain version's residuals
        args8 = (*ref[1:], *(lv[k] for k in bwd_names), B, T, heads, *bits,
                 RATE, eps)
        grads = block.tower_block_bwd(dz, mask, *args8)
        want = block.tower_block_bwd_ref(dz, mask, *args8)
        for name, a in zip(block.TOWER_LEAVES, grads[1:]):
            if a.dtype != dt:
                raise AssertionError(f"tower_block_bwd: d{name} is {a.dtype},"
                                     f" the stacked leaves are {dt}")
        hold(k8, f"max_abs_err{tag}", f"{dt}",
             zip(("dx",) + block.TOWER_LEAVES, grads, want), tol, True)
        k8[f"tolerance{tag}"] = {"rtol": tol, "atol": tol, "scaled": True}
        # against the half-layer chains, same weights and bits
        z_c, res = chain_fwd(x, bits, RATE)
        hold(k7, f"max_abs_err_vs_chain{tag}", f"vs 12 x (K5, K3) {dt}",
             [("z", got[0], z_c)], tol, False)
        dx_c, g_c = chain_bwd(dz, res, bits, RATE)
        # K8 at K7's own residuals, as the training path runs it
        own = block.tower_block_bwd(dz, mask, *got[1:],
                                    *(lv[k] for k in bwd_names), B, T, heads,
                                    *bits, RATE, eps)
        pairs = [("dx", own[0], dx_c)]
        for name, a in zip(block.TOWER_LEAVES, own[1:]):
            c = torch.stack(g_c[name])
            pairs.append((name, a, c if c.dim() == 3 else c[:, None]))
        hold(k8, f"max_abs_err_vs_chain{tag}", f"vs 12 x (K4, K6) {dt}",
             pairs, tol, True)
        # prng mode: stream seed + j in layer j, drawn in-kernel; held layer
        # by layer against the plain version fed the plain dump (the plain
        # prng mode); prng == host mode fed the dump is the prng phase's
        dump = philox.tower_stream_bits_ref(seed, L, B, T, H, heads)
        got_p = block.tower_block_fwd(*args7, rate=RATE, eps=eps, seed=seed)
        hold_layers(f"max_abs_err_prng{tag}", f"prng {dt}", got_p, dump,
                    RATE)
        w7 = [lv[k] for k in bwd_names]
        ref_p = block.tower_block_fwd_ref(*args7, *dump, RATE, eps)
        g_p = block.tower_block_bwd(dz, mask, *ref_p[1:], *w7, B, T, heads,
                                    rate=RATE, eps=eps, seed=seed)
        hold(k8, f"max_abs_err_prng{tag}", f"prng {dt}",
             zip(("dx",) + block.TOWER_LEAVES, g_p,
                 block.tower_block_bwd_ref(dz, mask, *ref_p[1:], *w7, B, T,
                                           heads, rate=RATE, eps=eps,
                                           seed=seed)), tol, True)
        del got_p, ref_p, g_p, dump
        if dt == torch.bfloat16:
            worst = 0.0
            for name, a, c in pairs[1:]:
                if name in ("wqkv", "wo", "w1", "w2"):
                    rel, ok = _one_bf16_step(a, c)
                    worst = max(worst, rel)
                    if not ok:
                        af, cf = a.float(), c.float()
                        over = (af - cf).abs() > 2.0 ** -7 * cf.abs() + 1e-30
                        i = int(((af - cf).abs() * over).argmax())
                        raise AssertionError(
                            f"tower_block_bwd d{name}: more than one bf16 "
                            f"step from the chain's f32 gradient ({rel}): "
                            f"{int(over.sum())} of {over.numel()} elements,"
                            f" the worst {af.flatten()[i].item()} against "
                            f"{cf.flatten()[i].item()}, max |chain| "
                            f"{cf.abs().max().item()}")
            k8["weight_grad_rel_vs_chain_f32"] = worst
        del res, g_c, got, ref, grads, want, own

    # times, bf16, at the model's call shapes
    x, dz = x32.bfloat16(), dz32.bfloat16()
    lv = leaves(torch.bfloat16)
    args7 = (x, mask, *lv.values(), B, T, heads)

    def k7_eval():
        return block.tower_block_fwd(*args7, *none, 0.0, eps, save=False)

    def k7_train():
        return block.tower_block_fwd(*args7, *bits, RATE, eps)

    def k7_prng():
        return block.tower_block_fwd(*args7, rate=RATE, eps=eps, seed=seed)

    saved = k7_train()
    args8 = (*saved[1:], *(lv[k] for k in bwd_names), B, T, heads, *bits,
             RATE, eps)
    saved_p = k7_prng()
    args8p = (*saved_p[1:], *(lv[k] for k in bwd_names), B, T, heads)
    _, chain_res = chain_fwd(x, bits, RATE)
    timed = [
        (k7, "", k7_eval,
         lambda: block.tower_block_fwd_ref(*args7, *none, 0.0, eps),
         lambda: chain_fwd(x, none, 0.0)),
        (k7, "_train", k7_train,
         lambda: block.tower_block_fwd_ref(*args7, *bits, RATE, eps),
         lambda: chain_fwd(x, bits, RATE)),
        (k8, "", lambda: block.tower_block_bwd(dz, mask, *args8),
         lambda: block.tower_block_bwd_ref(dz, mask, *args8),
         lambda: chain_bwd(dz, chain_res, bits, RATE))]
    timed += [
        (k7, "_prng", k7_prng,
         lambda: block.tower_block_fwd_ref(*args7, rate=RATE, eps=eps,
                                           seed=seed), None),
        (k8, "_prng",
         lambda: block.tower_block_bwd(dz, mask, *args8p, rate=RATE,
                                       eps=eps, seed=seed),
         lambda: block.tower_block_bwd_ref(dz, mask, *args8p, rate=RATE,
                                           eps=eps, seed=seed), None)]
    for row, tag, run, plain, chain in timed:
        row[f"ms{tag}"], row[f"ms{tag}_cold_l2"] = _event_times(run, flush)
        row[f"plain_ms{tag}"] = _event_ms(plain, calls=3, reps=3)
        if chain is not None:
            row[f"chain_ms{tag}_events"] = _event_ms(chain)
            row[f"chain_ms{tag}"] = _graph_ms(chain, calls=5, reps=5)
        b = bounds[row["name"] + tag]
        if tag:
            row["bound_ms" + tag], row["bound_by" + tag] = (b["bound_ms"],
                                                            b["bound_by"])
        else:
            row.update(b)
            row["kernel_ms"], row["library_ms"] = row["ms"], None
        row["timing"] = "cuda_events"
    k7["grid"], k8["grid"] = (dict(zip(("blocks", "per_sm", "smem_bytes"),
                                       f.info))
                              for f in (block.tower_block_fwd,
                                        block.tower_block_bwd))
    # the phase table (the measurement build) and the compiler's report
    phases = tower_phases(dev, B, T, H, heads, I, mask, gen, seed)
    k7["phases"] = {k: phases[k] for k in ("k7_eval", "k7_prng")}
    k8["phases"] = phases["k8_prng"]
    k7["ptxas"] = [r for r in phases["ptxas"] if "fwd" in r["function"]]
    k8["ptxas"] = [r for r in phases["ptxas"] if "bwd" in r["function"]]
    for row in (k7, k8):
        print(f"kernel {row['name']}: max|err| {row['max_abs_err']:.3g}, f32 "
              f"{row['max_abs_err_f32']:.3g}, vs chain "
              f"{row['max_abs_err_vs_chain']:.3g} / f32 "
              f"{row['max_abs_err_vs_chain_f32']:.3g}; {row['ms']:.4f} ms, "
              f"cold L2 {row['ms_cold_l2']:.4f} (plain {row['plain_ms']:.4f}, "
              f"12 x half-layer chain {row['chain_ms']:.4f} device / "
              f"{row['chain_ms_events']:.4f} as called, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}), grid "
              f"{row['grid']}"
              + ("" if "ms_train" not in row else
                 f"; train {row['ms_train']:.4f} ms (plain "
                 f"{row['plain_ms_train']:.4f}, chain "
                 f"{row['chain_ms_train']:.4f}, bound "
                 f"{row['bound_ms_train']:.4f})")
              + f"; prng {row['ms_prng']:.4f} ms (plain "
                f"{row['plain_ms_prng']:.4f}, bound "
                f"{row['bound_ms_prng']:.4f}, max|err| "
                f"{row['max_abs_err_prng']:.3g}, f32 "
                f"{row['max_abs_err_prng_f32']:.3g})", flush=True)
    return [k7, k8]


def prng_phase(args, kernels):
    """The in-kernel dropout check at full width (the port's
    tools/verify_block_prng: K3-K8 in prng mode, f32 and bf16, against
    their host mode fed the dumps of K10-K12), with the counts zeroed
    before and read after; then K10-K12 against their plain versions bit
    for bit and timed. Returns (launch counts of the check, the same per
    check, the three dump rows)."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import philox
    from text_guided_face_recognition_tpu_torch.tools.verify_block_prng \
        import verify

    dev = torch.device("cuda")
    B, T, H, heads, I, L = 32, args.bert_words_num, 768, 12, 3072, 12
    _zero(kernels)
    t0 = time.perf_counter()
    report = verify(dev, B, T, H, heads, I, L, RATE,
                    log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    counts = _counts(kernels)
    print(f"prng: verify_block_prng at B {B}, T {T}, H {H}, {L} layers, f32 "
          f"and bf16 in {time.perf_counter() - t0:.1f} s, launches {counts};"
          f" kept shares " + json.dumps({
              case: report[case]["float32"]["kept"]
              for case in ("ffn", "attn", "tower")}), flush=True)
    missing = [k for k in ("attn_block", "attn_block_bwd", "ffn_block",
                           "ffn_block_bwd", "tower_block", "tower_block_bwd",
                           "attn_stream_bits", "ffn_stream_bits",
                           "tower_stream_bits") if counts[k] < 1]
    if missing:
        raise AssertionError(f"the prng check never launched {missing}")

    R = B * T
    n_p, n_h = heads * B * T * T, R * H
    seed = torch.tensor([args.manual_seed + 5], dtype=torch.int32,
                        device=dev)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    flush_ms = _graph_ms(flush)
    where = "tools/verify_block_prng.py:"
    specs = [
        ("attn_stream_bits", "156",
         lambda: philox.attn_stream_bits(seed, B, T, H, heads),
         lambda: philox.attn_stream_bits_ref(seed, B, T, H, heads),
         n_p + n_h),
        ("ffn_stream_bits", "206",
         lambda: (philox.ffn_stream_bits(seed, R, H),),
         lambda: (philox.ffn_stream_bits_ref(seed, R, H),), n_h),
        ("tower_stream_bits", "251",
         lambda: philox.tower_stream_bits(seed, L, B, T, H, heads),
         lambda: philox.tower_stream_bits_ref(seed, L, B, T, H, heads),
         L * (n_p + 2 * n_h))]
    rows = []
    for name, line, run, ref, words in specs:
        got, want = run(), ref()
        torch.cuda.synchronize()
        err = max((a.long() - b_.long()).abs().max().item()
                  for a, b_ in zip(got, want))
        if err or not all(torch.equal(a, b_) for a, b_ in zip(got, want)):
            raise AssertionError(f"{name}: the dump differs from its plain "
                                 f"version (max |err| {err})")
        row = {"name": name, "route": "cuda", "source": SRC + "philox.cu",
               "replaces": where + line, "words": words, "max_abs_err": err,
               "tolerance": "bit for bit"}
        row["ms"], row["ms_cold_l2"] = _times(run, flush, flush_ms)
        row["kernel_ms"] = row["ms"]
        row["plain_ms"], row["plain_ms_cold_l2"] = _times(ref, flush,
                                                          flush_ms)
        row["library_ms"], row["library_ms_cold_l2"] = _times(
            lambda: torch.randint(-(1 << 31), 1 << 31, (words,),
                                  dtype=torch.int32, device=dev),
            flush, flush_ms)
        row["library_call"] = ("torch.randint of the same count: "
                               "comparable, not the same bits")
        # writes the words, reads the seed
        row.update(_bound(4.0 * words + 4, 0.0, "f32"))
        rows.append(row)
        print(f"kernel {name}: {words} words bit for bit; {row['ms']:.4f} ms,"
              f" cold L2 {row['ms_cold_l2']:.4f} (plain {row['plain_ms']:.4f},"
              f" torch.randint {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']})", flush=True)
    return counts, counts, rows


def _profile(step, reps: int = 3, what: str = "pair batch") -> dict:
    """Device time and the kernels that take it over `reps` calls of step,
    from torch.profiler. The busy share is device time over the wall time
    under the profiler, which slows the host: it is not the share of an
    unprofiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a user annotation (torch.optim's `Optimizer.step#...` range) spans the
    # kernels it encloses and the gaps between them: it is not device time
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not busy_us:
        return {"device_busy_share_profiled": "not measured"}

    def group(name):
        for key in ("tower_fwd_kernel", "tower_bwd_kernel",
                    "hl_gemm_kernel", "gemm_kernel", "attention_mma",
                    "attention_core_bwd", "attention_core",
                    "layernorm_bwd_kernel", "layernorm_fwd_kernel",
                    "colsum",
                    "damsm_kernel", "philox_dump"):
            if key in name:
                return "port kernels: " + key
        return "other: " + name[:60]

    by_group = {}
    for e in dev:
        g = group(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total
    top = sorted(by_group.items(), key=lambda kv: -kv[1])[:12]
    kernels = {}        # names cut to 120 characters; those alike add up
    for e in dev:
        ms, n = kernels.get(e.key[:120], (0.0, 0.0))
        kernels[e.key[:120]] = (ms + e.self_device_time_total / reps / 1e3,
                                n + e.count / reps)
    return {what + "es" if what.endswith("batch") else what + "s": reps,
            "wall_ms_per_call": wall_us / reps / 1e3,
            "device_ms_per_call": busy_us / reps / 1e3,
            "device_busy_share_profiled": busy_us / wall_us,
            "top_ms_per_call": {k: v / reps / 1e3 for k, v in top},
            "kernels": kernels}


def _show(profile: dict) -> dict:
    """A `_profile` result without its per-kernel table, for printing."""
    return {k: v for k, v in profile.items() if k != "kernels"}


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


def kernel_fns() -> dict:
    """{name: wrapper} of the twelve kernels; each wrapper counts its
    launches in `launches`."""
    from text_guided_face_recognition_tpu_torch.ops import (
        block, damsm, layernorm, philox)
    return {"layernorm_fused": layernorm.layernorm_fused,
            "layernorm_bwd": layernorm.layernorm_bwd,
            "attn_block": block.attn_block,
            "attn_block_bwd": block.attn_block_bwd,
            "ffn_block": block.ffn_block,
            "ffn_block_bwd": block.ffn_block_bwd,
            "tower_block": block.tower_block,
            "tower_block_bwd": block.tower_block_bwd,
            "damsm_similarity": damsm.damsm_similarity_cuda,
            "attn_stream_bits": philox.attn_stream_bits,
            "ffn_stream_bits": philox.ffn_stream_bits,
            "tower_stream_bits": philox.tower_stream_bits}


def slice_phase(args, kernels):
    """The serving path at full width; returns the per-kernel launch counts
    of the path and prints its metrics."""
    import numpy as np
    import torch

    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        pair_scores, run_test)
    from text_guided_face_recognition_tpu_torch.engine.extract import (
        extract_embeddings)

    dev = prep.resolve_device(False)
    test_dl, test_ds = prep.prepare_dataloader(args, "test")
    text_encoder, text_head = prep.prepare_text_encoder(args, dev)
    backbone = prep.prepare_backbone(args, dev)
    image_head = prep.prepare_image_head(args, dev)
    fusion_net = prep.prepare_fusion_net(args, dev)
    n_batches = len(test_dl)

    _zero(kernels)
    t0 = time.perf_counter()
    metrics = run_test(args, test_dl, backbone, image_head, fusion_net,
                       text_encoder, text_head)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    after_test = _counts(kernels)
    t0 = time.perf_counter()
    emb = extract_embeddings(args, "test", device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    total = _counts(kernels)
    layers = text_encoder.model.arch.layers

    expected_test = {k: 0 for k in kernels}   # fused_block=both
    expected_test.update({"layernorm_fused": 2 * n_batches,
                          "attn_block": 2 * layers * n_batches,
                          "ffn_block": 2 * layers * n_batches})
    n_emb = math.ceil(len(emb["keys"]) / args.batch_size)
    expected_extract = {k: 0 for k in kernels}
    expected_extract.update({"layernorm_fused": n_emb,
                             "attn_block": layers * n_emb,
                             "ffn_block": layers * n_emb})
    got_extract = {k: total[k] - after_test[k] for k in total}
    print(f"serving: run_test {n_batches} pair batches in {t_test:.3f} s, "
          f"launches {after_test}; extract {len(emb['keys'])} samples in "
          f"{t_extract:.3f} s, launches {got_extract}")
    if after_test != expected_test or got_extract != expected_extract:
        raise AssertionError(
            f"launch counts {after_test} / {got_extract} != expected "
            f"{expected_test} / {expected_extract}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    e = emb["embeddings"]
    if e.shape != (len(test_ds.filenames), args.fusion_final_dim) or \
            not np.isfinite(e).all():
        raise AssertionError(f"embeddings: shape {e.shape} or non-finite")

    # the same pair batch with the kernels off: plain modules on the card
    off = args.replace(fused_block="none", fused_ln=False)
    te_off, th_off = prep.prepare_text_encoder(off, dev)
    te_off.load_state_dict(text_encoder.state_dict())
    th_off.load_state_dict(text_head.state_dict())
    batch = next(iter(test_dl))
    cols = [batch[k] for k in ("img1", "img2", "cap1", "cap2", "mask1",
                               "mask2")]

    def run(te, th):
        return pair_scores(args, backbone, image_head, fusion_net, te, th,
                           *cols)

    s_on, s_off = run(text_encoder, text_head), run(te_off, th_off)
    diff = (s_on.float() - s_off.float()).abs().max().item()
    print(f"serving: kernels on vs off, one pair batch: max |score diff| "
          f"{diff:.6g} (tolerance {SCORE_TOL})")
    if not diff <= SCORE_TOL:
        raise AssertionError(f"kernels on/off scores differ by {diff}")
    ms_on, ms_off = [], []
    for _ in range(5):  # in turns: on, off, off, on
        for te, th, acc in ((text_encoder, text_head, ms_on),
                            (te_off, th_off, ms_off),
                            (te_off, th_off, ms_off),
                            (text_encoder, text_head, ms_on)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(te, th)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
    # once more through the whole-tower kernel: K7 in place of K3 and K5
    tower = args.replace(fused_block="tower")
    te_tw, th_tw = prep.prepare_text_encoder(tower, dev)
    te_tw.load_state_dict(text_encoder.state_dict())
    th_tw.load_state_dict(text_head.state_dict())
    _zero(kernels)
    t0 = time.perf_counter()
    metrics_tw = run_test(tower, test_dl, backbone, image_head, fusion_net,
                          te_tw, th_tw)
    torch.cuda.synchronize()
    t_tower = time.perf_counter() - t0
    tower_counts = _counts(kernels)
    expected_tower = {k: 0 for k in kernels}
    expected_tower.update({"layernorm_fused": 2 * n_batches,
                           "tower_block": 2 * n_batches})
    s_tw = run(te_tw, th_tw)
    diff_off = (s_tw.float() - s_off.float()).abs().max().item()
    diff_both = (s_tw.float() - s_on.float()).abs().max().item()
    print(f"serving, fused_block=tower: run_test {n_batches} pair batches in "
          f"{t_tower:.3f} s, launches {tower_counts}; one pair batch: max "
          f"|score diff| {diff_off:.6g} against kernels off, {diff_both:.6g} "
          f"against both (tolerance {SCORE_TOL})")
    if tower_counts != expected_tower:
        raise AssertionError(f"launch counts {tower_counts} != expected "
                             f"{expected_tower}")
    if not all(math.isfinite(v) for v in metrics_tw.values()):
        raise AssertionError(f"non-finite metrics {metrics_tw}")
    if not (diff_off <= SCORE_TOL and diff_both <= SCORE_TOL):
        raise AssertionError(f"tower scores differ by {diff_off} from "
                             f"kernels off, {diff_both} from both")
    ms_tw = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(te_tw, th_tw)
        torch.cuda.synchronize()
        ms_tw.append((time.perf_counter() - t0) * 1e3)
    long_diff = long_captions(args, backbone, image_head, fusion_net,
                              text_encoder, text_head, kernels)
    profile = _profile(lambda: run(text_encoder, text_head))
    print("serving profile: " + json.dumps(_show(profile)))
    print("serving profile, tower: " + json.dumps(
        _show(_profile(lambda: run(te_tw, th_tw)))))
    print("serving: " + json.dumps({
        "metrics": metrics, "ms_per_pair_batch_kernels_on":
        statistics.median(ms_on), "ms_per_pair_batch_kernels_off":
        statistics.median(ms_off), "ms_per_pair_batch_tower":
        statistics.median(ms_tw), "score_diff_on_off": diff,
        "score_diff_tower_off": diff_off, "score_diff_tower_both": diff_both,
        "metrics_tower": metrics_tw, "score_diff_on_off_t512": long_diff,
        "pair_batches": n_batches, "batch_size": args.batch_size}))
    return {k: total[k] + tower_counts[k] for k in total}, {
        k: max(after_test[k], tower_counts[k]) // n_batches for k in total}


def long_captions(args, backbone, image_head, fusion_net, text_encoder,
                  text_head, kernels) -> float:
    """One pair batch of captions as long as bert-base's position table
    (the synthetic split's ragged lengths up to block.MAX_T_FWD) through
    the serving path with fused_block=both, kernels on (K5's tensor-core
    attention) against off, the same weights; returns the largest score
    difference, which must stay within SCORE_TOL."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import check_serving
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        pair_scores)
    from text_guided_face_recognition_tpu_torch.ops import block

    long = args.replace(bert_words_num=block.MAX_T_FWD)
    check_serving(long)
    dev = next(text_encoder.parameters()).device
    dl, _ = prep.prepare_dataloader(long, "test")
    batch = next(iter(dl))
    cols = [batch[k] for k in ("img1", "img2", "cap1", "cap2", "mask1",
                               "mask2")]
    scores = []
    for cfg in (long, long.replace(fused_block="none", fused_ln=False)):
        te, th = prep.prepare_text_encoder(cfg, dev)
        te.load_state_dict(text_encoder.state_dict())
        th.load_state_dict(text_head.state_dict())
        _zero(kernels)
        scores.append(pair_scores(cfg, backbone, image_head, fusion_net, te,
                                  th, *cols).float())
        torch.cuda.synchronize()
        counts = _counts(kernels)
        want = 2 * te.model.arch.layers if cfg is long else 0
        if counts["attn_block"] != want or counts["ffn_block"] != want:
            raise AssertionError(f"t = {block.MAX_T_FWD} pair batch: "
                                 f"launches {counts}, expected {want} of "
                                 "K3 and K5")
    diff = (scores[0] - scores[1]).abs().max().item()
    print(f"serving, captions up to {block.MAX_T_FWD} tokens (longest "
          f"{int(batch['mask1'].sum(-1).max())}), one pair batch: kernels on "
          f"vs off max |score diff| {diff:.6g} (tolerance {SCORE_TOL})",
          flush=True)
    if not (diff <= SCORE_TOL and bool(torch.isfinite(scores[0]).all())):
        raise AssertionError(f"t = {block.MAX_T_FWD}: kernels on/off scores "
                             f"differ by {diff}")
    return diff


def _twin(trainer, state, **changes):
    """Another trainer of `trainer`'s configuration with `changes`, holding
    the weights (and BN statistics) `state`, taking eager steps (the
    counters count every launch)."""
    tw = type(trainer)(trainer.args.replace(**changes), trainer.device,
                       eager=True)
    tw.model.load_state_dict(state)
    return tw


# the model's points where a difference at rounding level can send a
# gradient elsewhere: (module, what its output routes)
ROUTES = (("text_head.bwm.conv_k2", "relu"), ("text_head.bwm.conv_k3", "relu"),
          ("text_head.bwm.conv_k4", "relu"),
          ("image_head.imim.conv1x1_1", "relu"),
          ("image_head.imim.conv1x1_2", "relu"),
          ("fusion_net.conv", "relu, max pool"), ("fusion_net.ln", "max pool"),
          ("text_encoder", "tower output"))


def _grads(on, off, batch, drop_on, drop_off,
           same_tower_output: bool = False, tower_shift=None,
           keep=None) -> tuple:
    """One step's loss and gradients (no update) from two trainers holding
    the same weights, on the same batch and the same dropout masks
    (drop_*: each trainer's (host bits, kernel seeds)): (loss_on,
    loss_off, per parameter (name, max |d|, max |g_off|, ||d||^2,
    ||g_off||^2), the routing differences) with d = g_on - g_off. With
    `same_tower_output` the off side's text tower hands on the on side's
    output values (its gradient still flows into the off tower), so both
    sides run everything after the tower on the same values; `tower_shift`
    is added to the on side's tower output (a constant). `keep`, a dict,
    receives the outputs at ROUTES by (side, module)."""
    out, hooks = {}, []
    for side, tr in (("on", on), ("off", off)):
        for path, _ in ROUTES:
            mod = tr.model
            for name in path.split("."):
                mod = getattr(mod, name, None)
            if mod is not None:
                hooks.append(mod.register_forward_hook(
                    lambda m, i, o, key=(side, path): out.__setitem__(
                        key, (o[0] if isinstance(o, tuple) else o).detach())))
    if same_tower_output:
        hooks.append(off.model.text_encoder.register_forward_hook(
            lambda m, i, o: (o[0] + (out[("on", "text_encoder")] - o[0])
                             .detach(), *o[1:])))
    if tower_shift is not None:
        hooks.append(on.model.text_encoder.register_forward_hook(
            lambda m, i, o: (o[0] + tower_shift, *o[1:])))
    try:
        loss_on, _ = on.compute_grads(batch, *drop_on)
        loss_off, _ = off.compute_grads(batch, *drop_off)
    finally:
        for h in hooks:
            h.remove()
    if keep is not None:
        keep.update(out)
    offp = dict(off.model.named_parameters())
    stats = []
    for name, p in on.model.named_parameters():
        q = offp[name]
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"{name}: a gradient on one side only")
        if p.grad is not None:
            a, c = p.grad.float(), q.grad.float()
            d = a - c
            stats.append((name, d.abs().max().item(), c.abs().max().item(),
                          d.square().sum().item(), c.square().sum().item()))
    return float(loss_on), float(loss_off), stats, _routing_differences(out)


def _routing_differences(out: dict) -> dict:
    """Where the two sides of a kernels on/off step route differently, from
    the outputs at ROUTES (out[(side, module)]): elements whose ReLU is on
    for one side only, 2 x 2 max pools and the text head's per-word maxima
    over its three scales and per-sentence maxima over time won by another
    element. Each sends an element's gradient elsewhere, so a difference
    in the forward at rounding level becomes one of the order of that
    gradient. Also the largest difference of the text tower's output."""
    import torch
    import torch.nn.functional as F

    res = {}
    for path, kind in ROUTES:
        if ("on", path) not in out:
            continue
        a, b = out[("on", path)].float(), out[("off", path)].float()
        if kind == "tower output":
            res["tower_output_max_abs"] = float((a - b).abs().max())
            # against the kernels' f32 limit, 1e-4 + 1e-4 |off|
            res["tower_output_vs_f32_limit"] = float(
                ((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max())
            continue
        n = 0
        if kind.startswith("relu"):
            n += int(((a > 0) != (b > 0)).sum())
            a, b = torch.relu(a), torch.relu(b)
        if kind.endswith("max pool"):
            n += int((F.max_pool2d(a, 2, return_indices=True)[1]
                      != F.max_pool2d(b, 2, return_indices=True)[1]).sum())
        res[path] = n
    convs = [f"text_head.bwm.conv_k{k}" for k in (2, 3, 4)]
    if ("on", convs[0]) in out:
        def maxima(side):
            outs = [torch.relu(out[(side, c)].float()) for c in convs]
            t = outs[0].shape[1]
            neg = torch.finfo(torch.float32).min
            words = torch.stack([F.pad(o, (0, 0, 0, t - o.shape[1]),
                                       value=neg) for o in outs]).argmax(0)
            return words, [o.argmax(1) for o in outs]
        (wa, sa), (wb, sb) = maxima("on"), maxima("off")
        res["text_head word max"] = int((wa != wb).sum())
        res["text_head sentence max"] = sum(int((x != y).sum())
                                            for x, y in zip(sa, sb))
        # the word features' norms before the head's l2 normalisation (the
        # largest over scales of the ReLU outputs, per word): its gradient
        # is 1/||w|| times the one after it, and a rounding difference in
        # w turns it by |dw|/||w||, so small norms amplify
        outs = [torch.relu(out[("off", c)].float()) for c in convs]
        t = outs[0].shape[1]
        w = torch.stack([F.pad(o, (0, 0, 0, t - o.shape[1])) for o in outs]
                        ).amax(0).norm(dim=-1).flatten()
        live = w[w > 0]
        # exact ties at a positive value, where max and amax split the
        # gradient and any perturbation picks one winner
        sent_ties = sum(int(((o == o.amax(1, keepdim=True)) & (o > 0))
                            .sum(1).gt(1).sum()) for o in outs)
        st = torch.stack([F.pad(o, (0, 0, 0, t - o.shape[1]), value=-1.0)
                          for o in outs])
        top = st.amax(0, keepdim=True)
        res["ties"] = {"sentence max": sent_ties, "word max": int(
            ((st == top) & (top > 0)).sum(0).gt(1).sum())}
        res["word_norms"] = {
            "min": float(live.min()) if live.numel() else 0.0,
            "median": float(live.median()) if live.numel() else 0.0,
            "below_1e-2": int((live < 1e-2).sum()), "zero": int(
                (w == 0).sum()), "words": int(w.numel())}
    res["total"] = sum(v for k, v in res.items()
                       if not k.startswith("tower_output")
                       and k not in ("word_norms", "ties"))
    return res


def _on_off(on, off, batch, drop_on, drop_off, floor: float,
            same_tower_output: bool = False, tower_shift=None,
            keep=None) -> dict:
    """Kernels on against off for one step (`_grads`), summed per
    top-level module (image_head, text_encoder, text_head, image_cls,
    text_cls): l2 = ||g_on - g_off|| / ||g_off|| over the module, and max,
    the largest over its parameters of max |g_on - g_off| / (max |g_off| +
    floor G), G the largest gradient element of the model."""
    loss_on, loss_off, stats, routing = _grads(on, off, batch, drop_on,
                                               drop_off, same_tower_output,
                                               tower_shift, keep)
    big = max(s[2] for s in stats)
    groups = {}
    for name, dmax, cmax, d2, c2 in stats:
        g = groups.setdefault(name.split(".")[0],
                              {"d2": 0.0, "c2": 0.0, "max": 0.0, "max_at": ""})
        g["d2"] += d2
        g["c2"] += c2
        rel = dmax / (cmax + floor * big)
        if rel > g["max"]:
            g["max"], g["max_at"] = rel, name
            g["max_abs"] = (dmax, cmax)
    for g in groups.values():
        d2, c2 = g.pop("d2"), g.pop("c2")
        g["l2"] = math.sqrt(d2 / c2) if c2 else math.inf
    return {"loss_on": loss_on, "loss_off": loss_off,
            "loss_rel": abs(loss_on - loss_off) / abs(loss_off),
            "groups": groups, "gradients": len(stats),
            "largest_gradient": big,
            "routing_differences": routing,
            "same_tower_output": same_tower_output}


def _l2_tol(tol: dict, module: str) -> float:
    return tol.get("l2_" + module, tol["l2"])


def _on_off_ok(r, tol) -> bool:
    if r["same_tower_output"] and \
            not r["routing_differences"]["tower_output_vs_f32_limit"] <= 1:
        return False
    return r["loss_rel"] <= tol["loss"] and all(
        g["l2"] <= _l2_tol(tol, m) and g["max"] <= tol["max"]
        for m, g in r["groups"].items())


def _planted_fault(on, off, batch, drop_on, drop_off, floor: float,
                   name: str = "attn_block_bwd", bits_p_at=None,
                   same_tower_output: bool = False, bf16_at=()) -> dict:
    """`_on_off` with a fault planted in the inputs of the backward `name`
    (K6, or K8 `tower_block_bwd`) of the trainer `on`. In prng mode
    (bits_p_at None) it is handed the wrong seed, so it regenerates other
    dropout masks than its forward drew; in host mode it is handed all-keep
    bits for the probabilities that the forward dropped (bits_p_at: where
    the autograd Function's backward passes bits_p, 13th for K6, 20th for
    K8). Only the text tower's gradients move; the forward and the loss do
    not. With `bf16_at`, `name` is a forward (K3 `ffn_block_fwd`, K7
    `tower_block_fwd`) handed its weights at those positions rounded to
    bf16, as a kernel that multiplied f32 operands on bf16 tensor cores
    would: the forward moves, the backward reads the true weights."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import block
    real = getattr(block, name)

    def faulty(*a, **kw):
        if bf16_at:
            a = list(a)
            for i in bf16_at:     # the same (transposed) layout
                w = a[i].transpose(-1, -2)
                a[i] = w.to(torch.bfloat16).to(w.dtype).transpose(-1, -2)
        elif bits_p_at is None:
            kw["seed"] = kw["seed"] + 1
        else:
            a = list(a)
            a[bits_p_at] = torch.full_like(a[bits_p_at], -1)
        return real(*a, **kw)

    # the wrapper counts into the function its name is bound to, so the
    # control's launches land here and not in the main path's count
    faulty.launches = 0
    setattr(block, name, faulty)
    try:
        return _on_off(on, off, batch, drop_on, drop_off, floor,
                       same_tower_output)
    finally:
        setattr(block, name, real)


# seeds of the f32 witnesses' directions (`_f32_on_off`)
WITNESS_SEEDS = (1, 2)


def _f32_ok(e2e: dict, split: dict, witnesses, control: dict, tol) -> str:
    """The f32 kernels on/off verdict: "end to end" when the step's
    gradients agree within `tol`; else "explained" when the text tower's
    output is within the kernels' f32 limit and everything after it, run on
    the same values, agrees within `tol` (`split`), the plain model agrees
    with itself through the witnesses' hook with a zero shift (`control`),
    and the plain model alone, its tower output moved by the same
    magnitudes in other directions (`witnesses`), reaches in every module
    beyond `tol` at least a quarter of the end-to-end l2 gap: the gap is
    the plain model's own response to any rounding difference of the
    tower's size (as at an exact tie of a max), not the kernels'; else ""
    (failed)."""
    if _on_off_ok(e2e, tol):
        return "end to end"
    if not _on_off_ok(split, tol) or not _on_off_ok(control, tol) or \
            e2e["loss_rel"] > tol["loss"]:
        return ""
    over = [m for m, g in e2e["groups"].items()
            if g["l2"] > _l2_tol(tol, m) or g["max"] > tol["max"]]
    if all(w["groups"][m]["l2"] >= e2e["groups"][m]["l2"] / 4
           for w in witnesses for m in over):
        return "explained"
    return ""


def _f32_on_off(on, off, plain, batch, drop_on, drop_off, tol, fwd: tuple,
                bwd: str, tag: str) -> dict:
    """Kernels on against off in f32 (trainers `on`, `off`; `plain` a second
    kernels-off twin): the step end to end; split in two, the tower's
    output within the kernels' f32 limit (1e-4 + 1e-4 |p|) and the
    gradients with everything after the tower on the same values; and the
    witnesses: `plain` against `off` with `plain`'s tower output moved by
    the split step's tower difference, its elements permuted and their
    signs flipped at random (WITNESS_SEEDS), and once with a zero shift
    (the control: the hook alone moves nothing). Planted faults, each of which
    must fail the verdict (`_f32_ok`) and the end-to-end check: the wrong
    seed in the backward `bwd`, and the forward fwd = (name, weight
    positions) handed bf16-rounded weights, which the tower's f32 limit
    must catch. Raises if the verdict fails or a fault passes."""
    import torch

    floor = tol["floor"]
    keep = {}
    r = {"float32": _on_off(on, off, batch, drop_on, drop_off, floor),
         "float32, split": _on_off(on, off, batch, drop_on, drop_off, floor,
                                   True, keep=keep)}
    d = (keep[("on", "text_encoder")] - keep[("off", "text_encoder")])
    flat = d.flatten()
    for seed in WITNESS_SEEDS:
        gen = torch.Generator(device=d.device).manual_seed(seed)
        perm = torch.randperm(flat.numel(), generator=gen, device=d.device)
        sign = torch.randint(0, 2, (flat.numel(),), generator=gen,
                             device=d.device) * 2 - 1
        shift = (flat[perm] * sign).view_as(d).to(d.dtype)
        r[f"float32, witness, seed {seed}"] = _on_off(
            plain, off, batch, drop_off, drop_off, floor, tower_shift=shift)
    r["float32, witness, zero shift"] = _on_off(
        plain, off, batch, drop_off, drop_off, floor,
        tower_shift=torch.zeros_like(d))
    witnesses = [r[f"float32, witness, seed {seed}"]
                 for seed in WITNESS_SEEDS]
    control = r["float32, witness, zero shift"]
    fwd_name, fwd_at = fwd
    planted = {}
    for label, kw in ((f"wrong seed in {bwd}", dict(name=bwd)),
                      (f"bf16 weights in {fwd_name}", dict(
                          name=fwd_name, bf16_at=fwd_at))):
        planted[f"float32, {label}"] = _planted_fault(
            on, off, batch, drop_on, drop_off, floor, **kw)
        planted[f"float32, {label}, split"] = _planted_fault(
            on, off, batch, drop_on, drop_off, floor, same_tower_output=True,
            **kw)
    for dt, x in (*r.items(), *planted.items()):
        _print_on_off(tag, dt, x, {"float32": tol})
    verdict = _f32_ok(r["float32"], r["float32, split"], witnesses, control,
                      tol)
    print(f"{tag}, float32 verdict: {verdict or 'failed'}", flush=True)
    if not verdict:
        raise AssertionError(f"{tag}: the f32 kernels on/off step disagrees")
    for label in (f"wrong seed in {bwd}", f"bf16 weights in {fwd_name}"):
        e2e, split = (planted[f"float32, {label}"],
                      planted[f"float32, {label}, split"])
        if _on_off_ok(e2e, tol) or _f32_ok(e2e, split, witnesses, control,
                                           tol):
            raise AssertionError(f"{tag}: the f32 on/off check passed a "
                                 f"planted fault: {label}")
    fwd_split = planted[f"float32, bf16 weights in {fwd_name}, split"]
    if fwd_split["routing_differences"]["tower_output_vs_f32_limit"] <= 1:
        raise AssertionError(f"{tag}: the tower's f32 limit passed the "
                             f"planted forward fault in {fwd_name}")
    r["float32 verdict"] = verdict
    r["planted"] = planted
    return r


def _faults_caught(planted: dict, tols: dict, kernel: str) -> None:
    """Every planted fault must fail the on/off check."""
    for key, r in planted.items():
        if _on_off_ok(r, tols[key.split(",")[0]]):
            raise AssertionError(f"the on/off check passed a planted "
                                 f"{kernel} fault: {key}")


def _print_on_off(tag: str, dt: str, r: dict, tols=ON_OFF_TOL) -> None:
    tol = tols[dt.split(",")[0]]
    if r["same_tower_output"]:
        dt += " (after the tower on the same values)"
    if "zero shift" in dt:
        dt += " (kernels off on both sides, one through the hook adding 0)"
    elif "witness" in dt:
        dt += (" (kernels off on both sides, one side's tower output moved "
               "by the on/off difference's magnitudes)")
    print(f"{tag}, one step, {dt}: loss "
          f"{r['loss_on']:.6f} vs {r['loss_off']:.6f} (rel "
          f"{r['loss_rel']:.3g}, tolerance {tol['loss']}); per module "
          f"l2 / largest per parameter (tolerance {tol['l2']}"
          + ("" if "l2_text_head" not in tol else
             f" (text_head {tol['l2_text_head']})")
          + f" / {tol['max']}, floor {tol['floor']} G, G "
          f"{r['largest_gradient']:.4g}): " + "; ".join(
              f"{m} {g['l2']:.4g} / {g['max']:.4g} at {g['max_at']}"
              + ("" if "max_abs" not in g else
                 " (|d| %.3g of %.3g)" % g["max_abs"])
              for m, g in r["groups"].items())
          + f"; routing differences {r['routing_differences']}", flush=True)


def _modes(trainers, batch, reps: int = 5) -> dict:
    """Per trainer (a dropout mode): ms per step on the host clock (median
    of 2 x reps, in turns forwards and backwards), the step's device ms from
    the profiler, its peak memory, and the host words and kernel seeds it
    draws per step."""
    import torch

    ms = {k: [] for k in trainers}
    order = list(trainers.items())
    for _ in range(reps):
        for k, tr in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    b, t = batch["caps"].shape
    gc.collect()         # twins dropped earlier hold reference cycles
    torch.cuda.empty_cache()
    for k, tr in order:
        bits, seeds = tr.draw_drop(b, t)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        prof = _profile(lambda: tr.train_step(batch), what="step")
        out[k] = {"ms_per_step": statistics.median(ms[k]),
                  "ms_per_step_all": ms[k],
                  "device_ms_per_step": prof.get("device_ms_per_call",
                                                 "not measured"),
                  "peak_memory_gb": peak / 1e9,
                  "step_peak_above_resident_gb": (peak - base) / 1e9,
                  "host_bit_words_per_step": 0 if bits is None
                  else bits.numel(),
                  "kernel_seeds_per_step": 0 if seeds is None
                  else seeds.numel(),
                  "profile": prof}
    # which kernels the host draw adds or moves: (ms, launches) per step,
    # host mode less prng mode, the largest eight by time
    ka, kb = (out[k]["profile"].get("kernels", {}) for k in ("host", "prng"))
    diff = {n: (ka.get(n, (0, 0))[0] - kb.get(n, (0, 0))[0],
                ka.get(n, (0, 0))[1] - kb.get(n, (0, 0))[1])
            for n in set(ka) | set(kb)}
    out["host_minus_prng_kernels"] = dict(sorted(
        diff.items(), key=lambda kv: -abs(kv[1][0]))[:8])
    return out


def _print_modes(tag: str, modes: dict) -> None:
    print(f"{tag}, device ms and launches per step, host mode less prng "
          f"mode: " + json.dumps(modes["host_minus_prng_kernels"]))
    for k, m in modes.items():
        if k == "host_minus_prng_kernels":
            continue
        print(f"{tag}, {k}: {m['ms_per_step']:.2f} ms per step (median of "
              f"{len(m['ms_per_step_all'])}), device {m['device_ms_per_step']}"
              f" ms, peak {m['peak_memory_gb']:.3f} GB "
              f"({m['step_peak_above_resident_gb']:.3f} above resident), "
              f"host bit words {m['host_bit_words_per_step']}, seeds "
              f"{m['kernel_seeds_per_step']}", flush=True)


def _host_mode_counts(host, batch, per_step, kernels, tag: str) -> None:
    """Two steps of the host-mode twin (fused_dropout) launch each kernel
    as a prng-mode step does, and no dump."""
    _zero(kernels)
    host.train_step(batch)
    host.train_step(batch)
    got = _counts(kernels)
    if got != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"{tag} host mode: launch counts {got} != 2 x "
                             f"{per_step}")


def long_caption_step(trainer, state, short: dict, kernels) -> dict:
    """One stage-1 step at bert_words_num = LONG_T[-1] (512, bert-base's
    position table; the synthetic split's ragged lengths), kernels on (prng
    mode: K1-K6, K5 with residuals on the tensor-core tile past 128, K6's
    tensor-core backward, K9 on its long path at regions x words 196 x 510)
    against off, from the same weights as the T = 24 comparison (`short`),
    whose per-module readings are printed beside these; the on step
    launches K9 once, the off step never. The loss is held to the bf16
    limit; the gradients are read, not held."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops.philox import (
        compose_drop_bits)

    t_long = LONG_T[-1]
    on = _twin(trainer, state, bert_words_num=t_long, use_pallas=True)
    batch = on.to_device(next(iter(on.train_dl)))
    b, t = batch["caps"].shape
    bits, seeds = on.draw_drop(b, t)
    off = _twin(on, state, fused_block="none", fused_ln=False,
                use_pallas=False)
    _zero(kernels)
    r = _on_off(on, off, batch, (bits, seeds),
                (compose_drop_bits(on.arch, b, t, "both", bits, seeds),
                 None), ON_OFF_TOL["bfloat16"]["floor"])
    torch.cuda.synchronize()
    k9 = kernels["damsm_similarity"].launches
    if k9 != 1:
        raise AssertionError(f"stage-1 step at t = {t_long}: K9 launched "
                             f"{k9} times, expected once (kernels on)")
    longest = int(batch["mask"].sum(1).max())
    print(f"train: one step at bert_words_num {t_long} (longest caption "
          f"{longest}), kernels on vs off: loss {r['loss_on']:.6g} / "
          f"{r['loss_off']:.6g} (rel {r['loss_rel']:.3g}); per module l2 / "
          "max at T = {0} and at {1}: ".format(
              trainer.args.bert_words_num, t_long) + "; ".join(
              f"{m} {short['groups'][m]['l2']:.3g} / "
              f"{short['groups'][m]['max']:.3g} and {g['l2']:.3g} / "
              f"{g['max']:.3g}" for m, g in r["groups"].items()),
          flush=True)
    print(f"train: at bert_words_num {t_long}, K9 launches {k9} (kernels on "
          "side; regions x words "
          f"{(on.args.img_size // 8) ** 2} x {t - 2})", flush=True)
    if not r["loss_rel"] <= ON_OFF_TOL["bfloat16"]["loss"]:
        raise AssertionError(f"stage-1 step at t = {t_long}: kernels on/off "
                             f"loss differs by {r['loss_rel']}")
    del on, off
    torch.cuda.empty_cache()
    return dict(r, longest_caption=longest, t=t, damsm_launches=k9)


def _counted_steps(trainer, steps: int, tag: str) -> int:
    """The steps of a CLI run whose launches the counters saw: the eager
    warm-up steps and the capture (the counters count at capture, not at
    replay); every later step must have been a replay."""
    w = trainer.WARMUP_STEPS
    if trainer.eager or trainer.graph_replays != max(0, steps - w):
        raise AssertionError(f"{tag}: {steps} steps, {trainer.graph_replays} "
                             f"replays (eager {trainer.eager}): the CLI "
                             "runs the captured step on the card")
    return min(steps, w + 1)


def _eager_continuation(trainer):
    """An eager trainer that goes on with `trainer`'s run: its weights and
    BN statistics, optimizer state, learning rates and dropout stream."""
    tw = _twin(trainer, trainer.model.state_dict())
    tw.opt.load_state_dict(trainer.opt.state_dict())
    tw.lr = dict(trainer.lr)
    tw._apply_lrs()
    tw.drop_gen.set_state(trainer.drop_gen.get_state())
    tw.steps = trainer.steps
    return tw


def _captured_cli(main, argv, ckpt, per_step, kernels, tag: str) -> dict:
    """One CLI run long enough to capture its step (CLI_STEPS: 3 eager
    warm-up steps, then the capture), with every count zeroed before and
    read after: the warm-up steps' and the capture's launches; then its
    replays' device kernels against an eager twin's step (profiler).
    Returns the counts."""
    import torch

    _zero(kernels)
    t0 = time.perf_counter()
    try:
        cli = main(argv)
        torch.cuda.synchronize()
        saved = sorted(os.listdir(cli.save_dir()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    counts = _counts(kernels)
    counted = _counted_steps(cli, cli.steps, tag)
    print(f"{tag}: {cli.steps} steps ({counted} eager or captured, "
          f"{cli.graph_replays} replays) + {saved} in "
          f"{time.perf_counter() - t0:.1f} s (set-up included), launches "
          f"{counts}", flush=True)
    if cli.steps != CLI_STEPS or \
            counts != {k: counted * v for k, v in per_step.items()}:
        raise AssertionError(f"{tag}: {cli.steps} steps, launch counts "
                             f"{counts} != {counted} x {per_step}")
    batch = cli.to_device(next(iter(cli.train_dl)))
    eager = _twin(cli, cli.model.state_dict())
    _replays_launch_as_eager(cli, eager, batch, kernels, tag)
    return counts


def train_phase(kernels):
    """Stage-1 training at full width; returns the per-kernel launch counts
    of the CLI's run and prints the phase's metrics."""
    import torch

    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert)
    from text_guided_face_recognition_tpu_torch.ops.philox import (
        compose_drop_bits)

    ckpt = os.path.join(ROOT, "checkpoints", "chip_smoke")
    argv = ["--cfg", os.path.join(ROOT, "cfg", "train_bert.yml"),
            "--synthetic", "--fused_block", "both", "--fused_ln",
            "--use_pallas", "--compute_dtype", "bfloat16", "--batch_size",
            "32", "--checkpoints_path", ckpt]
    _zero(kernels)
    t0 = time.perf_counter()
    try:
        trainer = train_encoders_bert.main(argv + ["--max_steps", "2",
                                                   "--max_epoch", "1"])
        torch.cuda.synchronize()
        saved = sorted(os.listdir(trainer.save_dir()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t_cli = time.perf_counter() - t0
    warm_counts = _counts(kernels)
    args = trainer.args
    layers = trainer.arch.layers
    per_step = {k: 0 for k in kernels}
    per_step.update({"layernorm_fused": 1, "layernorm_bwd": 1,
                     "attn_block": layers, "attn_block_bwd": layers,
                     "ffn_block": layers, "ffn_block_bwd": layers,
                     "damsm_similarity": 1})
    steps = trainer.steps
    _counted_steps(trainer, steps, "train: CLI")
    print(f"train: CLI {steps} steps (warm-up, eager) + checkpoints {saved} "
          f"in {t_cli:.1f} s (set-up included), launches {warm_counts}",
          flush=True)
    if warm_counts != {k: steps * v for k, v in per_step.items()}:
        raise AssertionError(f"CLI launch counts {warm_counts} != {steps} x "
                             f"{per_step}")
    expect = {f"{args.model_type}_image_encoder_1",
              f"{args.bert_type}_text_encoder_1", "train_state_1"}
    if set(saved) != expect:
        raise AssertionError(f"checkpoints {saved} != {sorted(expect)}")
    # the checks below go on with this run eagerly (the counters see every
    # launch), on the batch its loader gives next
    batch = trainer.to_device(next(iter(trainer.train_dl)))
    b, t = batch["caps"].shape
    trainer = _eager_continuation(trainer)
    # the CLI run long enough to capture its step: two epochs of the
    # synthetic split's two steps, the schedule's rate edit between them
    cli_counts = _captured_cli(
        train_encoders_bert.main,
        argv + ["--max_steps", str(CLI_STEPS // 2), "--max_epoch", "2"],
        ckpt, per_step, kernels, "train: captured CLI")
    gc.collect()
    torch.cuda.empty_cache()

    # 20 steps on one fixed batch
    _zero(kernels)
    losses = [trainer.train_step(batch)["total_loss"]
              for _ in range(TRAIN_STEPS)]
    losses = [float(v) for v in losses]
    fixed_counts = _counts(kernels)
    print(f"train: {TRAIN_STEPS} steps on one batch, total loss "
          f"{[round(v, 4) for v in losses]}, launches {fixed_counts}",
          flush=True)
    if fixed_counts != {k: TRAIN_STEPS * v for k, v in per_step.items()}:
        raise AssertionError(f"launch counts {fixed_counts} != "
                             f"{TRAIN_STEPS} x {per_step}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"loss does not fall: first five {first}, "
                             f"last five {last}")

    # one step, kernels on (prng mode) against off: same weights, same
    # masks, the off twin fed the composed stream (the on step's host bits
    # and the K10/K11 dumps of its seeds); in bf16 (the trainer's own) and
    # in f32; and in host mode, bf16, the on twin fed the composed stream
    # too. Planted K6 faults, each of which the check must catch: the
    # wrong seed in the backward, bf16 and f32, and, in host mode, all-keep
    # bits for the probabilities in bf16
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bits, seeds = trainer.draw_drop(b, t)
    drop_on = (bits, seeds)
    drop_off = (compose_drop_bits(trainer.arch, b, t, "both", bits, seeds),
                None)
    off = _twin(trainer, state, fused_block="none", fused_ln=False,
                use_pallas=False)
    floor = ON_OFF_TOL["bfloat16"]["floor"]
    on_off = {"bfloat16": _on_off(trainer, off, batch, drop_on, drop_off,
                                  floor)}
    planted = {"bfloat16, wrong seed in K6": _planted_fault(
        trainer, off, batch, drop_on, drop_off, floor)}
    trainer.model.load_state_dict(state)
    f32_off = dict(compute_dtype="float32", fused_block="none",
                   fused_ln=False, use_pallas=False)
    f32 = [_twin(trainer, state, compute_dtype="float32"),
           _twin(trainer, state, **f32_off), _twin(trainer, state, **f32_off)]
    f32_r = _f32_on_off(*f32, batch, drop_on, drop_off,
                        ON_OFF_TOL["float32"], ("ffn_block_fwd", (1, 3)),
                        "attn_block_bwd", "train: kernels on vs off")
    on_off["float32"] = f32_r.pop("float32")
    planted["float32, wrong seed in K6"] = f32_r["planted"][
        "float32, wrong seed in attn_block_bwd"]
    del f32
    host = _twin(trainer, state, fused_dropout=True)
    on_off["bfloat16, host mode"] = _on_off(host, off, batch, drop_off,
                                            drop_off, floor)
    planted["bfloat16, host mode, all-keep bits in K6"] = _planted_fault(
        host, off, batch, drop_off, drop_off, floor, bits_p_at=12)
    host.model.load_state_dict(state)
    for dt, r in (*on_off.items(), *planted.items()):
        if not dt.startswith("float32"):      # printed by _f32_on_off
            _print_on_off("train: kernels on vs off", dt, r)
    # host mode (fused_dropout): the whole-tower kernels against the
    # half-layer ones, same weights, same bits (K7 and K8 once each, K3-K6
    # once each for the `both` twin)
    tower = _twin(trainer, state, fused_block="tower", fused_dropout=True)
    _zero(kernels)
    tower_both = _on_off(tower, host, batch, drop_off, drop_off, floor)
    tower_counts = _counts(kernels)
    trainer.model.load_state_dict(state)
    host.model.load_state_dict(state)
    _print_on_off("train: tower vs both (host mode)", "bfloat16", tower_both)
    expect = dict(per_step)      # the `both` twin ran in the same window
    expect.update({"tower_block": 1, "tower_block_bwd": 1,
                   "layernorm_fused": 2, "layernorm_bwd": 2,
                   "damsm_similarity": 2})
    if tower_counts != expect:
        raise AssertionError(f"tower twin: launch counts {tower_counts} != "
                             f"{expect}")
    if not _on_off_ok(tower_both, ON_OFF_TOL["bfloat16"]):
        raise AssertionError("stage-1 step: tower disagrees with both")
    on_off["bfloat16_tower_vs_both"] = tower_both
    del tower
    for dt in ("bfloat16", "bfloat16, host mode"):
        if not _on_off_ok(on_off[dt], ON_OFF_TOL[dt.split(",")[0]]):
            raise AssertionError(f"kernels on/off training step disagrees "
                                 f"in {dt}")
    _faults_caught(planted, ON_OFF_TOL, "K6")
    on_off["float32, checks"] = f32_r
    on_off["planted_k6_faults"] = planted
    on_off[f"bfloat16_t{LONG_T[-1]}"] = long_caption_step(
        trainer, state, on_off["bfloat16"], kernels)
    torch.cuda.empty_cache()
    _host_mode_counts(host, batch, per_step, kernels, "train")

    # the step in prng mode, in host mode and with the kernels off, in turns
    modes = _modes({"prng": trainer, "host": host, "off": off}, batch)
    _print_modes("train", modes)
    ms_on, ms_off = (modes[k]["ms_per_step_all"] for k in ("prng", "off"))
    # the step's two halves on the host clock, kernels on
    ms_grads, ms_opt = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.compute_grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.opt.step()
        torch.cuda.synchronize()
        ms_grads.append((t1 - t0) * 1e3)
        ms_opt.append((time.perf_counter() - t1) * 1e3)
    profile = modes["prng"]["profile"]
    k9_ms = sum(ms for name, (ms, _) in profile.get("kernels", {}).items()
                if "damsm_kernel" in name)
    print("train: stage-1 device ms per step (prng mode, profiled): "
          f"{profile.get('device_ms_per_call', 'not measured')}; K9 "
          f"{k9_ms} ms of it", flush=True)
    print("train profile: " + json.dumps(_show(profile)))
    print("train profile, host mode: " + json.dumps(
        _show(modes["host"]["profile"])))
    print("train: " + json.dumps({
        "ms_per_step_kernels_on": statistics.median(ms_on),
        "ms_per_step_kernels_off": statistics.median(ms_off),
        "ms_forward_backward": statistics.median(ms_grads),
        "ms_optimizer": statistics.median(ms_opt),
        "ms_per_step_on_all": ms_on, "ms_per_step_off_all": ms_off,
        "loss_first": losses[0], "loss_last": losses[-1],
        "on_off": on_off,
        "modes": {k: ({n: v for n, v in m.items() if n != "profile"}
                      if "profile" in m else m) for k, m in modes.items()},
        "batch_size": b, "steps_cli": steps}))
    return cli_counts, {k: v // TRAIN_STEPS for k, v in fixed_counts.items()}


def stage2_phase(kernels):
    """Stage-2 fusion training at full width through the whole-tower
    kernels; returns the per-kernel launch counts of the CLI's runs and
    the counts per step, and prints the phase's metrics."""
    import torch

    from text_guided_face_recognition_tpu_torch.cli import fusion_bert
    from text_guided_face_recognition_tpu_torch.ops.philox import (
        compose_drop_bits)

    ckpt = os.path.join(ROOT, "checkpoints", "chip_smoke_stage2")
    argv = ["--cfg", os.path.join(ROOT, "cfg", "fusion_bert.yml"),
            "--synthetic", "--fused_block", "tower", "--fused_ln",
            "--checkpoints_path", ckpt]
    per_step = {k: 0 for k in kernels}
    per_step.update({"layernorm_fused": 1, "layernorm_bwd": 1,
                     "tower_block": 1, "tower_block_bwd": 1})
    _zero(kernels)
    t0 = time.perf_counter()
    try:
        first = fusion_bert.main(argv + ["--max_steps", "2", "--max_epoch",
                                         "1"])
        torch.cuda.synchronize()
        save_dir = first.save_dir()
        saved = sorted(os.listdir(save_dir))
        # resume: the second epoch starts from the first one's train state
        trainer = fusion_bert.main(argv + [
            "--max_steps", "2", "--max_epoch", "2", "--resume_epoch", "2",
            "--resume_model_path", os.path.join(save_dir, "train_state_1")])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t_cli = time.perf_counter() - t0
    warm_counts = _counts(kernels)
    args = trainer.args
    steps = first.steps + trainer.steps
    _counted_steps(first, first.steps, "stage2: CLI")
    _counted_steps(trainer, trainer.steps, "stage2: resumed CLI")
    print(f"stage2: CLI {first.steps} steps + artifacts {saved}, resumed at "
          f"epoch {trainer.start_epoch} for {trainer.steps} more (warm-up, "
          f"eager), in {t_cli:.1f} s (set-up included), launches "
          f"{warm_counts}", flush=True)
    if warm_counts != {k: steps * v for k, v in per_step.items()}:
        raise AssertionError(f"CLI launch counts {warm_counts} != {steps} x "
                             f"{per_step}")
    expect = {f"fusion_{args.fusion_type}_{args.model_type}_1",
              f"encoder_{args.en_type}_{args.fusion_type}_1", "train_state_1"}
    if set(saved) != expect or trainer.start_epoch != 2 or \
            (first.steps, trainer.steps) != (2, 2):
        raise AssertionError(f"artifacts {saved} != {sorted(expect)}, or the "
                             "resume did not start at epoch 2")
    del first
    # the checks below go on with the resumed run eagerly (the counters see
    # every launch), on the batch its loader gives next
    batch = trainer.to_device(next(iter(trainer.train_dl)))
    b, t = batch["caps"].shape
    trainer = _eager_continuation(trainer)
    # the CLI run long enough to capture its step: one epoch of four
    cli_counts = _captured_cli(
        fusion_bert.main, argv + ["--max_steps", str(CLI_STEPS),
                                  "--max_epoch", "1"],
        ckpt, per_step, kernels, "stage2: captured CLI")
    gc.collect()
    torch.cuda.empty_cache()

    # one step, kernels on against off: same weights, same bits, per
    # top-level module; bf16 and f32, and bf16 in host mode; then planted
    # K8 faults as in stage 1.
    # Before the 20 steps below: they take the focal loss of one batch of
    # 16 to 1e-3, where (1 - p)^2 shrinks every gradient towards the
    # rounding noise of the parameters whose exact gradient is zero
    # (prng mode: the off twin fed the composed stream, the on step's host
    # bits and the K12 dump of its seed)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bits, seeds = trainer.draw_drop(b, t)
    drop_on = (bits, seeds)
    drop_off = (compose_drop_bits(trainer.arch, b, t, "tower", bits, seeds),
                None)
    off = _twin(trainer, state, fused_block="none", fused_ln=False)
    tols = ON_OFF_TOL_STAGE2
    floor = tols["bfloat16"]["floor"]
    on_off = {"bfloat16": _on_off(trainer, off, batch, drop_on, drop_off,
                                  floor)}
    planted = {"bfloat16, wrong seed in K8": _planted_fault(
        trainer, off, batch, drop_on, drop_off, floor, "tower_block_bwd")}
    f32_off = dict(compute_dtype="float32", fused_block="none",
                   fused_ln=False)
    f32 = [_twin(trainer, state, compute_dtype="float32"),
           _twin(trainer, state, **f32_off), _twin(trainer, state, **f32_off)]
    f32_r = _f32_on_off(*f32, batch, drop_on, drop_off, tols["float32"],
                        ("tower_block_fwd", (2, 4, 8, 10)), "tower_block_bwd",
                        "stage2: kernels on vs off")
    f32_e2e = f32_r.pop("float32")
    planted["float32, wrong seed in K8"] = f32_r["planted"][
        "float32, wrong seed in tower_block_bwd"]
    del f32
    host = _twin(trainer, state, fused_dropout=True)
    on_off["bfloat16, host mode"] = _on_off(host, off, batch, drop_off,
                                            drop_off, floor)
    planted["bfloat16, host mode, all-keep bits in K8"] = _planted_fault(
        host, off, batch, drop_off, drop_off, floor, "tower_block_bwd", 19)
    for dt, r in (*on_off.items(), *planted.items()):
        if not dt.startswith("float32"):      # printed by _f32_on_off
            _print_on_off("stage2: kernels on vs off", dt, r, tols)
    want = {"text_encoder", "text_head", "image_head", "fusion_net",
            "metric_fc"}
    for dt, r in on_off.items():
        if set(r["groups"]) != want:
            raise AssertionError(f"modules compared {set(r['groups'])} != "
                                 f"{want}")
        if not _on_off_ok(r, tols[dt.split(",")[0]]):
            raise AssertionError(f"stage-2 kernels on/off step disagrees in "
                                 f"{dt}")
    if set(f32_e2e["groups"]) != want:
        raise AssertionError(f"modules compared {set(f32_e2e['groups'])} != "
                             f"{want}")
    _faults_caught(planted, tols, "K8")
    on_off["float32"] = f32_e2e
    on_off["float32, checks"] = f32_r
    on_off["planted_k8_faults"] = planted
    torch.cuda.empty_cache()

    # 20 steps on one fixed batch
    _zero(kernels)
    losses = [float(v) for v in [trainer.train_step(batch)["loss"]
                                 for _ in range(TRAIN_STEPS)]]
    fixed_counts = _counts(kernels)
    print(f"stage2: {TRAIN_STEPS} steps on one batch of {b}, loss "
          f"{[round(v, 4) for v in losses]}, launches {fixed_counts}",
          flush=True)
    if fixed_counts != {k: TRAIN_STEPS * v for k, v in per_step.items()}:
        raise AssertionError(f"launch counts {fixed_counts} != "
                             f"{TRAIN_STEPS} x {per_step}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < first5:
        raise AssertionError(f"loss does not fall: first five {first5}, "
                             f"last five {last5}")

    host.model.load_state_dict(trainer.model.state_dict())
    _host_mode_counts(host, batch, per_step, kernels, "stage2")
    modes = _modes({"prng": trainer, "host": host, "off": off}, batch)
    _print_modes("stage2", modes)
    ms_on, ms_off = (modes[k]["ms_per_step_all"] for k in ("prng", "off"))
    ms_grads, ms_opt = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.compute_grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.opt.step()
        torch.cuda.synchronize()
        ms_grads.append((t1 - t0) * 1e3)
        ms_opt.append((time.perf_counter() - t1) * 1e3)
    print("stage2 profile: " + json.dumps(_show(modes["prng"]["profile"])))
    print("stage2 profile, host mode: " + json.dumps(
        _show(modes["host"]["profile"])))
    print("stage2: " + json.dumps({
        "ms_per_step_kernels_on": statistics.median(ms_on),
        "ms_per_step_kernels_off": statistics.median(ms_off),
        "ms_forward_backward": statistics.median(ms_grads),
        "ms_optimizer": statistics.median(ms_opt),
        "ms_per_step_on_all": ms_on, "ms_per_step_off_all": ms_off,
        "loss_first": losses[0], "loss_last": losses[-1],
        "on_off": on_off, "batch_size": b, "steps_cli": steps,
        "modes": {k: ({n: v for n, v in m.items() if n != "profile"}
                      if "profile" in m else m)
                  for k, m in modes.items()}}))
    return cli_counts, {k: v // TRAIN_STEPS for k, v in fixed_counts.items()}


# ------------------------------------------------------ the compiled step --

PORT_KERNEL_KEYS = ("tower_fwd_kernel", "tower_bwd_kernel", "hl_gemm_kernel",
                    "hl_bwd_gemm_kernel", "gemm_kernel", "attention_mma",
                    "attention_core_bwd", "attention_core",
                    "layernorm_bwd_kernel", "layernorm_fwd_kernel", "colsum",
                    "damsm_kernel", "philox_dump")


def _device_kernels(fn, reps: int) -> dict:
    """{device kernel name: launches per call} of the port's kernels over
    `reps` calls of fn, from torch.profiler's device records: they see the
    kernels of a CUDA graph's replay, which the wrappers' counters do not
    (those count at capture). One call before them runs under the
    profiler's warm-up, whose records are dropped: without it the first
    kernels of a replay went unrecorded now and then."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps, repeat=1),
                 acc_events=True) as prof:
        for _ in range(1 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(
                k in e.name for k in PORT_KERNEL_KEYS):
            out[e.name] = out.get(e.name, 0) + 1
    return {k: v / reps for k, v in sorted(out.items())}


def _kernel_counts(fn, sessions: int) -> dict:
    """Per device kernel name of the port's, the most launches that one
    call of fn showed in `sessions` profiler sessions (`_device_kernels`,
    one call each): the profiler drops records of a graph's replay now
    and then (it never adds any), so the most over sessions is a bound
    from below of what a call launches."""
    best = {}
    for _ in range(sessions):
        for k, v in _device_kernels(fn, 1).items():
            best[k] = max(best.get(k, 0.0), v)
    return best


def _replays_launch_as_eager(graphed, eager, batch, kernels, tag: str,
                             sessions: int = 3) -> dict:
    """The replayed steps of `graphed` launch the port's device kernels of
    one eager step of `eager` (same configuration), name for name and as
    many times, by the profiler (`_kernel_counts`, each side over
    `sessions` sessions); the launch counters do not move at replay."""
    eager_k = _kernel_counts(lambda: eager.train_step(batch), sessions)
    n0, before = graphed.graph_replays, _counts(kernels)
    graph_k = _kernel_counts(lambda: graphed.train_step(batch), sessions)
    if graphed.graph_replays != n0 + 2 * sessions or \
            _counts(kernels) != before:
        raise AssertionError(f"{tag}: {graphed.graph_replays - n0} replays "
                             f"in {2 * sessions} captured steps, counters "
                             f"{before} -> {_counts(kernels)}")
    if not eager_k or graph_k != eager_k:
        raise AssertionError(f"{tag}: replayed steps launch {graph_k}, an "
                             f"eager step {eager_k}")
    print(f"{tag}: a replayed step launches the port kernels of an eager "
          f"step (profiler, {sessions} sessions a side; counters unmoved): "
          + json.dumps({k[:70]: v for k, v in graph_k.items()}), flush=True)
    return graph_k


def _snapshot(tr) -> dict:
    """Every parameter, BN statistic, moment, momentum buffer and count of
    a trainer, cloned."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in tr.model.state_dict().items()}
    for g, sd in tr.opt.state_dict().items():
        out[f"{g}.count"] = sd["count"].clone()
        for i, st in sd["state"].items():
            for k, t in st.items():
                out[f"{g}.{i}.{k}"] = t.clone()
    return out


def _max_diff(a: dict, b: dict) -> tuple:
    """(equal bit for bit, largest |a - b| over every tensor, where)."""
    import torch
    worst, at = 0.0, ""
    if a.keys() != b.keys():
        return False, math.inf, "keys"
    equal = True
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return False, math.inf, k
        if not torch.equal(x, y):
            equal = False
            d = (x.double() - y.double()).abs().max().item()
            if d > worst:
                worst, at = d, k
    return equal, worst, at


def _time_modes(trainers, batch, reps: int = 5) -> dict:
    """Per trainer: host-clock ms per step (median of 2 x reps, in turns
    forwards and backwards), device ms per step from the profiler, the busy
    share (device ms over the unprofiled host ms), the memory resident and
    the peak of a step, and what the caching allocator holds (a graph's
    private pool among it)."""
    import torch

    ms = {k: [] for k in trainers}
    order = list(trainers.items())
    for _ in range(reps):
        for k, step in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    gc.collect()
    for k, step in order:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        prof = _profile(step, what="step")
        host = statistics.median(ms[k])
        dev = prof.get("device_ms_per_call")
        out[k] = {"host_ms": host, "host_ms_all": ms[k],
                  "device_ms": dev if dev is not None else "not measured",
                  "busy_share": dev / host if dev else "not measured",
                  "resident_gb": base / 1e9, "peak_gb": peak / 1e9,
                  "reserved_gb": reserved / 1e9,
                  "top_ms": prof.get("top_ms_per_call")}
    return out


def _captured_vs_eager(cls, args, dev, make_batch=None) -> tuple:
    """An eager trainer and a captured one of `args` from the same weights,
    six steps each on one batch (the head's rate halved before the fifth):
    (eager, captured, the initial weights, the batch, {after 3 and after 6
    steps: bit for bit (parameters, BN statistics, moments, counts and the
    step's metrics), the largest difference and where}). The captured
    trainer's fourth step is its capture. The batch is the train loader's
    first, or make_batch(eager trainer)."""
    import torch

    eager = cls(args, dev, eager=True)
    state = {k: v.clone() for k, v in eager.model.state_dict().items()}
    batch = (make_batch(eager) if make_batch is not None
             else eager.to_device(next(iter(eager.train_dl))))
    graphed = cls(args, dev)
    graphed.model.load_state_dict(state)
    cmp = {}
    for n in range(6):
        if n == 4:
            for tr in (eager, graphed):
                tr.lr["head"] *= 0.5
                tr._apply_lrs()
        ma, mb = eager.train_step(batch), graphed.train_step(batch)
        if n in (2, 5):
            equal, worst, at = _max_diff(_snapshot(graphed), _snapshot(eager))
            m_eq = all(torch.equal(ma[k], mb[k]) for k in ma)
            cmp[f"after {n + 1} steps"] = {
                "bitwise": equal and m_eq, "max_abs": worst, "at": at,
                "metrics_equal": m_eq, "replays": graphed.graph_replays}
    return eager, graphed, state, batch, cmp


def step_phase(kernels) -> dict:
    """The compiled step (`--only step`): for stage 1 (cfg/train_bert.yml,
    bf16, batch 32, fused_block both, fused_ln, use_pallas, prng mode) and
    stage 2 (cfg/fusion_bert.yml, batch 16, fused_block tower, fused_ln),
    kernels on and off: (b) the eager step and (c) the captured one, timed
    in turns in this process. Checks: (c) against (b) from the same
    weights, batch and drop_gen seed after 3 and 6 steps (a learning-rate
    edit between), every parameter, BN statistic, moment and count bit for
    bit; the replayed steps launch the device kernels of an eager step
    (profiler)."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)

    dev = torch.device("cuda")
    stages = {
        "stage1": (Stage1Trainer, load_yaml(
            os.path.join(ROOT, "cfg", "train_bert.yml")).replace(
            synthetic=True, fused_block="both", fused_ln=True,
            use_pallas=True, compute_dtype="bfloat16", batch_size=32,
            checkpoints_path="")),
        "stage2": (FusionTrainer, load_yaml(
            os.path.join(ROOT, "cfg", "fusion_bert.yml")).replace(
            synthetic=True, fused_block="tower", fused_ln=True,
            checkpoints_path="")),
    }
    off = dict(fused_block="none", fused_ln=False, use_pallas=False)
    report, failures = {}, []
    for stage, (cls, args) in stages.items():
        try:
            eager, graphed, state, batch, cmp = _captured_vs_eager(cls, args,
                                                                   dev)
        except RuntimeError as e:
            if args.fused_block != "tower" or \
                    "capturing the train step" not in str(e):
                raise
            print(f"step, {stage}: the card refuses to capture fused_block "
                  f"tower ({e}); this stage's graph is measured with both",
                  flush=True)
            report[f"{stage}_tower_refused"] = str(e)
            args = args.replace(fused_block="both")
            eager, graphed, state, batch, cmp = _captured_vs_eager(cls, args,
                                                                   dev)
        print(f"step, {stage}: captured against eager (3 warm-up steps, "
              f"capture, replays): {json.dumps(cmp)}", flush=True)
        if not all(c["bitwise"] for c in cmp.values()):
            failures.append(f"{stage}: the captured step differs from the "
                            f"eager step: {cmp}")
        _replays_launch_as_eager(graphed, eager, batch, kernels,
                                 f"step, {stage}")

        # the table: (b), (c), kernels on and off
        modes = {"(b) eager, kernels on": lambda: eager.train_step(batch),
                 "(c) captured, kernels on": lambda: graphed.train_step(batch)}
        e_off = cls(args.replace(**off), dev, eager=True)
        g_off = cls(args.replace(**off), dev)
        for tr in (e_off, g_off):
            tr.model.load_state_dict(state)
        for _ in range(graphed.WARMUP_STEPS + 1):
            g_off.train_step(batch)
        modes.update({
            "(b) eager, kernels off": lambda: e_off.train_step(batch),
            "(c) captured, kernels off": lambda: g_off.train_step(batch)})
        table = _time_modes(modes, batch)
        for k, m in table.items():
            print(f"step, {stage}, {k}: {m['host_ms']:.3f} host ms per step "
                  f"(median of {len(m['host_ms_all'])}), device "
                  f"{m['device_ms']} ms, busy {m['busy_share']}, resident "
                  f"{m['resident_gb']:.3f} GB, peak {m['peak_gb']:.3f} GB, "
                  f"reserved {m['reserved_gb']:.3f} GB",
                  flush=True)
        report[stage] = {"captured_vs_eager": cmp,
                         "table": {k: {n: v for n, v in m.items()
                                       if n != "top_ms"}
                                   for k, m in table.items()},
                         "top_ms": {k: m["top_ms"] for k, m in table.items()}}
        del eager, graphed, e_off, g_off, modes
        gc.collect()
        torch.cuda.empty_cache()
    print("step: " + json.dumps(report), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return report


# ----------------------------------------------- reference weight files --

def _ref_tensors(gen):
    """Builders of seeded tensors under the reference's key names: conv
    and linear weights N(0, 1/fan_in), biases and BN affines near their
    init, BN statistics (mean N(0, 0.1^2), var U(0.5, 1.5))."""
    import torch

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    def weight(*shape):
        return normal(*shape, std=1.0 / math.sqrt(math.prod(shape[1:])))

    def bn(sd, name, c, affine=True):
        if affine:
            sd[f"{name}.weight"] = 1.0 + normal(c, std=0.1)
            sd[f"{name}.bias"] = normal(c, std=0.1)
        sd[f"{name}.running_mean"] = normal(c, std=0.1)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    return normal, weight, bn


def ref_iresnet18(gen) -> dict:
    """ArcFace's iresnet18 state_dict (the reference's models/iresnet.py
    key names), `features.weight` off 1 so that loading takes the fold."""
    import torch
    normal, weight, bn = _ref_tensors(gen)
    sd = {"conv1.weight": weight(64, 3, 3, 3)}
    bn(sd, "bn1", 64)
    sd["prelu.weight"] = torch.full((64,), 0.25)
    cin = 64
    for stage, planes in enumerate((64, 128, 256, 512), start=1):
        for i in range(2):
            t = f"layer{stage}.{i}"
            bn(sd, f"{t}.bn1", cin)
            sd[f"{t}.conv1.weight"] = weight(planes, cin, 3, 3)
            bn(sd, f"{t}.bn2", planes)
            sd[f"{t}.prelu.weight"] = torch.full((planes,), 0.25)
            sd[f"{t}.conv2.weight"] = weight(planes, planes, 3, 3)
            bn(sd, f"{t}.bn3", planes)
            if i == 0:
                sd[f"{t}.downsample.0.weight"] = weight(planes, cin, 1, 1)
                bn(sd, f"{t}.downsample.1", planes)
            cin = planes
    bn(sd, "bn2", 512)
    sd["fc.weight"] = weight(512, 512 * 7 * 7)
    sd["fc.bias"] = normal(512, std=0.1)
    bn(sd, "features", 512)
    return sd


def ref_ir18(gen) -> dict:
    """AdaFace's ir_18 state_dict (the reference's models/net.py key
    names, without the Lightning module's `model.` prefix)."""
    import torch
    normal, weight, bn = _ref_tensors(gen)
    sd = {"input_layer.0.weight": weight(64, 3, 3, 3)}
    bn(sd, "input_layer.1", 64)
    sd["input_layer.2.weight"] = torch.full((64,), 0.25)
    cin, i = 64, 0
    for depth in (64, 128, 256, 512):
        for u in range(2):
            t = f"body.{i}"
            if cin != depth:
                sd[f"{t}.shortcut_layer.0.weight"] = weight(depth, cin, 1, 1)
                bn(sd, f"{t}.shortcut_layer.1", depth)
            bn(sd, f"{t}.res_layer.0", cin)
            sd[f"{t}.res_layer.1.weight"] = weight(depth, cin, 3, 3)
            bn(sd, f"{t}.res_layer.2", depth)
            sd[f"{t}.res_layer.3.weight"] = torch.full((depth,), 0.25)
            sd[f"{t}.res_layer.4.weight"] = weight(depth, depth, 3, 3)
            bn(sd, f"{t}.res_layer.5", depth)
            cin, i = depth, i + 1
    bn(sd, "output_layer.0", 512)
    sd["output_layer.3.weight"] = weight(512, 512 * 7 * 7)
    sd["output_layer.3.bias"] = normal(512, std=0.1)
    bn(sd, "output_layer.4", 512, affine=False)
    return sd


def ref_text_bundle(gen, layers=12, h=768, inter=3072, vocab=30522,
                    positions=512, feat=256) -> dict:
    """The reference's stage-1 text artifact at bert-base width:
    {'model': TextEncoder state_dict (an HF BertModel under 'model.',
    pooler included), 'head': TextHeading state_dict
    (Bert_Word_Mapping's Conv2d(1, feat, (K, h)) kernels)}."""
    import torch
    normal, weight, _ = _ref_tensors(gen)
    m = {"embeddings.word_embeddings.weight": normal(vocab, h, std=0.02),
         "embeddings.position_embeddings.weight": normal(positions, h,
                                                          std=0.02),
         "embeddings.token_type_embeddings.weight": normal(2, h, std=0.02),
         "embeddings.LayerNorm.weight": 1.0 + normal(h, std=0.05),
         "embeddings.LayerNorm.bias": normal(h, std=0.05)}
    for j in range(layers):
        t = f"encoder.layer.{j}"
        for name, (o, i) in (("attention.self.query", (h, h)),
                             ("attention.self.key", (h, h)),
                             ("attention.self.value", (h, h)),
                             ("attention.output.dense", (h, h)),
                             ("intermediate.dense", (inter, h)),
                             ("output.dense", (h, inter))):
            m[f"{t}.{name}.weight"] = weight(o, i)
            m[f"{t}.{name}.bias"] = normal(o, std=0.02)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            m[f"{t}.{name}.weight"] = 1.0 + normal(h, std=0.05)
            m[f"{t}.{name}.bias"] = normal(h, std=0.05)
    m["pooler.dense.weight"] = weight(h, h)
    m["pooler.dense.bias"] = torch.zeros(h)
    head = {}
    for idx, k in enumerate((2, 3, 4)):
        head[f"bwm.convs1.{idx}.weight"] = weight(feat, 1, k, h)
        head[f"bwm.convs1.{idx}.bias"] = normal(feat, std=0.02)
    return {"model": {"model." + k: v for k, v in m.items()}, "head": head}


def ref_image_head(gen, c=256, feat=256, s=14) -> dict:
    """The reference's stage-1 image artifact: {'image_head': ImageHeading
    state_dict}, its IMIM's projections as 1x1 convolutions."""
    normal, weight, bn = _ref_tensors(gen)
    sd = {}
    bn(sd, "imim.bn_img", c)
    for name in ("query_proj", "key_proj", "value_proj"):
        sd[f"imim.sa.{name}.weight"] = weight(c, c, 1, 1)
        sd[f"imim.sa.{name}.bias"] = normal(c, std=0.02)
    sd["imim.ln.weight"] = 1.0 + normal(c, s, s, std=0.05)
    sd["imim.ln.bias"] = normal(c, s, s, std=0.05)
    sd["imim.conv1x1_1.weight"] = weight(c // 2, c, 1, 1)
    sd["imim.conv1x1_1.bias"] = normal(c // 2, std=0.02)
    sd["imim.conv1x1_2.weight"] = weight(c, c // 2, 1, 1)
    sd["imim.conv1x1_2.bias"] = normal(c, std=0.02)
    sd["imim.project_local.projection.weight"] = weight(feat, c)
    sd["imim.project_local.projection.bias"] = normal(feat, std=0.02)
    sd["project_global.projection.weight"] = weight(feat, 512)
    sd["project_global.projection.bias"] = normal(feat, std=0.02)
    return {"image_head": sd}


def ref_fcfm(gen, c=36, feat=256) -> dict:
    """The reference's stage-2 artifact: {'net': Working (FCFM)
    state_dict}, DataParallel's `module.` prefix on every key."""
    normal, weight, bn = _ref_tensors(gen)
    sd = {"conv.weight": weight(c, 256, 3, 3), "conv.bias": normal(c, std=0.02),
          "projection.weight": weight(c, feat),
          "projection.bias": normal(c, std=0.02),
          "linear.weight": weight(128, c * 9),
          "linear.bias": normal(128, std=0.02),
          "ln.weight": 1.0 + normal(c, 6, 6, std=0.05),
          "ln.bias": normal(c, 6, 6, std=0.05)}
    for name in ("query_proj", "key_proj", "value_proj"):
        sd[f"sa.{name}.weight"] = weight(c, c, 1, 1)
        sd[f"sa.{name}.bias"] = normal(c, std=0.02)
    for name in ("ln_gl_image", "ln_sent"):
        sd[f"{name}.weight"] = 1.0 + normal(feat, std=0.05)
        sd[f"{name}.bias"] = normal(feat, std=0.05)
    bn(sd, "bn_img", c)
    bn(sd, "bn_word", c)
    return {"net": {"module." + k: v for k, v in sd.items()}}


def write_reference_files(root: str, seed: int = 0) -> dict:
    """Write every reference layout the weights phase loads under `root`;
    returns {kind: path} and the written trees under `trees`."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    arc, ada, mag = ref_iresnet18(gen), ref_ir18(gen), ref_iresnet18(gen)
    trees = {
        "arcface": arc,
        "adaface": {"state_dict": {**{"model." + k: v for k, v in ada.items()},
                                   "head.kernel": torch.randn(
                                       512, 4500, generator=gen)},
                    "epoch": 25, "hyper_parameters": argparse.Namespace(
                        arch="ir_18", head="adaface", m=0.4, h=0.333)},
        "magface": {"state_dict": {
            **{"module.features." + k: v for k, v in mag.items()},
            "module.fc.weight": torch.randn(4500, 512, generator=gen)}},
        "text": ref_text_bundle(gen), "image": ref_image_head(gen),
        "fusion": ref_fcfm(gen)}
    names = {"arcface": "arcface_ir18_ms1mv3.pth",
             "adaface": "adaface_ir18_webface4m.ckpt",
             "magface": "magface_iresnet18_casia_dp.pth",
             "text": "bert_text_encoder_1", "image": "arcface_image_encoder_1",
             "fusion": "fusion_fcfm_arcface_1"}
    os.makedirs(root, exist_ok=True)
    paths = {k: os.path.join(root, n) for k, n in names.items()}
    for k, tree in trees.items():
        torch.save(tree, paths[k])
    return {"paths": paths, "trees": trees}


def _check_leaves(model_type: str, backbone, text_encoder, trees) -> dict:
    """A few leaves of the loaded modules against the written tensors
    after the map: layer 11's fused qkv ([q | k | v] on the output axis),
    ArcFace's and MagFace's folded `features` variance, AdaFace's
    output_fc (its input axis from (C, H, W) to (H, W, C) order)."""
    import torch
    m = trees["text"]["model"]
    t = "model.encoder.layer.11.attention.self"
    want_qkv = torch.cat([m[f"{t}.{n}.weight"] for n in ("query", "key",
                                                          "value")])
    got = text_encoder.model.layer_11.attn.qkv.weight.detach().cpu()
    checks = {"qkv_layer11": float((got - want_qkv).abs().max())}
    if model_type == "adaface":
        w = trees["adaface"]["state_dict"]["model.output_layer.3.weight"]
        want = w.reshape(512, 512, 7, 7).permute(0, 2, 3, 1).reshape(512, -1)
        got = backbone.output_fc.weight.detach().cpu()
        checks["adaface_output_fc"] = float((got - want).abs().max())
    else:
        sd = trees[model_type]
        pre = "" if model_type == "arcface" else "module.features."
        if model_type == "magface":
            sd = sd["state_dict"]
        w, var = sd[pre + "features.weight"], sd[pre + "features.running_var"]
        want = (var + 1e-5) / w ** 2 - 1e-5
        got = backbone.features.running_var.detach().cpu()
        checks["features_var_fold"] = float(
            ((got - want).abs() / want.abs()).max())
    print(f"weights, {model_type}: leaves after the map, max |loaded - "
          f"written| {checks} (0 expected; the fold relative, 1e-6)",
          flush=True)
    if checks["qkv_layer11"] != 0 or checks.get("adaface_output_fc", 0) != 0 \
            or not checks.get("features_var_fold", 0) <= 1e-6:
        raise AssertionError(f"{model_type}: loaded leaves differ from the "
                             f"file: {checks}")
    return checks


def _host_ms(fn, reps: int = 10) -> float:
    import torch
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def weights_phase(args, kernels):
    """The reference's weight files through the prepare path: for each
    backbone (arcface, adaface, magface) run_test with every module loaded
    from a reference-layout file, its leaves, launches, kernels on against
    off and its times, then the COTS baseline (org_face_test); then one
    AdaFace stage-1 step with the kernels on. Returns the launch counts of
    the driven runs and per pair batch, and prints the phase's metrics."""
    import torch

    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        org_face_test, pair_scores, raw_pair_scores, run_test)
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)

    root = os.path.join(ROOT, "checkpoints", "chip_smoke_weights")
    t0 = time.perf_counter()
    try:
        ref = write_reference_files(root)
        paths, trees = ref["paths"], ref["trees"]
        print(f"weights: reference files written in "
              f"{time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{k} {os.path.getsize(p) / 2**20:.1f} MiB"
                          for k, p in paths.items()), flush=True)
        dev = prep.resolve_device(False)
        total = {k: 0 for k in kernels}
        per_batch, report = None, {}
        files = dict(text_encoder_path=paths["text"],
                     image_encoder_path=paths["image"],
                     fusion_net_path=paths["fusion"])
        for mt in ("arcface", "adaface", "magface"):
            a = args.replace(model_type=mt, **files,
                             **{f"weights_{mt}": paths[mt]})
            test_dl, _ = prep.prepare_dataloader(a, "test")
            te, th = prep.prepare_text_encoder(a, dev)
            backbone = prep.prepare_backbone(a, dev)
            ih = prep.prepare_image_head(a, dev)
            fu = prep.prepare_fusion_net(a, dev)
            leaves = _check_leaves(mt, backbone, te, trees)
            n = len(test_dl)
            _zero(kernels)
            metrics = run_test(a, test_dl, backbone, ih, fu, te, th)
            torch.cuda.synchronize()
            counts = _counts(kernels)
            layers = te.model.arch.layers
            want = {k: 0 for k in kernels}
            want.update({"layernorm_fused": 2 * n,
                         "attn_block": 2 * layers * n,
                         "ffn_block": 2 * layers * n})
            if counts != want:
                raise AssertionError(f"weights, {mt}: launch counts {counts}"
                                     f" != expected {want}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"weights, {mt}: non-finite {metrics}")
            total = {k: total[k] + counts[k] for k in total}
            per_batch = {k: v // n for k, v in counts.items()}
            # kernels on against off on one pair batch, the same weights
            off = a.replace(fused_block="none", fused_ln=False)
            te_off, th_off = prep.prepare_text_encoder(off, dev)
            batch = next(iter(test_dl))
            cols = [batch[k] for k in ("img1", "img2", "cap1", "cap2",
                                       "mask1", "mask2")]

            def run(te_, th_, a=a, backbone=backbone, ih=ih, fu=fu,
                    cols=cols):
                return pair_scores(a, backbone, ih, fu, te_, th_, *cols)

            s_on, s_off = run(te, th).float(), run(te_off, th_off).float()
            diff = (s_on - s_off).abs().max().item()
            if not (diff <= SCORE_TOL and bool(torch.isfinite(s_on).all())):
                raise AssertionError(f"weights, {mt}: kernels on/off scores "
                                     f"differ by {diff}")
            # the COTS baseline: no text, no kernel
            _zero(kernels)
            cots = org_face_test(a, test_dl, backbone)
            torch.cuda.synchronize()
            if any(_counts(kernels).values()):
                raise AssertionError(f"weights, {mt}: the COTS baseline "
                                     f"launched {_counts(kernels)}")
            if not all(math.isfinite(v) for v in cots.values()):
                raise AssertionError(f"weights, {mt}: non-finite {cots}")

            def cots_batch(backbone=backbone, mt=mt, batch=batch):
                return raw_pair_scores(backbone, mt, batch["img1"],
                                       batch["img2"])

            prof = _profile(lambda: run(te, th))
            prof_cots = _profile(cots_batch)
            report[mt] = {
                "leaves": leaves, "metrics": metrics, "cots_metrics": cots,
                "score_diff_on_off": diff,
                "ms_per_pair_batch": _host_ms(lambda: run(te, th)),
                "device_ms_per_pair_batch": prof.get("device_ms_per_call",
                                                     "not measured"),
                "cots_ms_per_pair_batch": _host_ms(cots_batch),
                "cots_device_ms_per_pair_batch": prof_cots.get(
                    "device_ms_per_call", "not measured"),
                "cots_top_ms": prof_cots.get("top_ms_per_call", {}),
                "pair_batches": n, "launches": counts}
            print(f"weights, {mt}: " + json.dumps(report[mt]), flush=True)
            del te, th, te_off, th_off, backbone, ih, fu
            torch.cuda.empty_cache()

        # one AdaFace stage-1 step, kernels on, from the reference files
        from text_guided_face_recognition_tpu_torch.config import load_yaml
        targs = load_yaml(os.path.join(ROOT, "cfg", "train_bert.yml")).replace(
            synthetic=True, fused_block="both", fused_ln=True,
            use_pallas=True, compute_dtype="bfloat16", batch_size=32,
            checkpoints_path="", model_type="adaface",
            weights_adaface=paths["adaface"],
            text_encoder_path=paths["text"],
            image_encoder_path=paths["image"])
        trainer = Stage1Trainer(targs, dev, eager=True)
        batch = trainer.to_device(next(iter(trainer.train_dl)))
        _zero(kernels)
        loss = float(trainer.train_step(batch)["total_loss"])
        torch.cuda.synchronize()
        step_counts = _counts(kernels)
        layers = trainer.arch.layers
        want = {k: 0 for k in kernels}
        want.update({"layernorm_fused": 1, "layernorm_bwd": 1,
                     "attn_block": layers, "attn_block_bwd": layers,
                     "ffn_block": layers, "ffn_block_bwd": layers,
                     "damsm_similarity": 1})
        print(f"weights: one AdaFace stage-1 step (batch {batch['caps'].shape[0]}"
              f"), total loss {loss}, launches {step_counts}", flush=True)
        if step_counts != want or not math.isfinite(loss):
            raise AssertionError(f"AdaFace stage-1 step: loss {loss}, "
                                 f"launches {step_counts} != {want}")
        total = {k: total[k] + step_counts[k] for k in total}
        report["adaface_stage1_step"] = {"loss": loss,
                                         "launches": step_counts}
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("weights: " + json.dumps({
        "times": {mt: {k: report[mt][k] for k in (
            "ms_per_pair_batch", "device_ms_per_pair_batch",
            "cots_ms_per_pair_batch", "cots_device_ms_per_pair_batch")}
            for mt in ("arcface", "adaface", "magface")},
        "batch_size": args.batch_size}))
    return total, per_batch


def _lstm_batch(trainer, n: int):
    """A train batch of n samples on the device, image i % len of the
    synthetic train split (64 images) at sample i: the shipped stage-1
    batch of 128 is larger than that split, which the loader, dropping its
    last batch, would leave empty."""
    import numpy as np
    ds = trainer.train_ds
    samples = [ds[i % len(ds)] for i in range(n)]
    return trainer.to_device({k: np.stack([x[k] for x in samples])
                              for k in samples[0] if k != "key"})


def _lstm_k9_alone(trainer, batch, failures: list) -> dict:
    """K9 on the inputs an LSTM stage-1 step gives it: one eager step of
    `trainer` (use_pallas) records what words_loss hands K9 (the f32
    words_emb (B, 256, T), the regions (B, 256, 196), the cap_len mask);
    K9 called again on them equals the step's own call bit for bit, and
    holds against the plain version within DAMSM_ATOL. The mask must cut
    words, or the masked path was not exercised."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import (
        attention, damsm, losses)
    seen = {}
    real = losses.damsm_similarity_fused

    def record(words, regions, gamma1, gamma2, word_mask=None):
        sim = real(words, regions, gamma1, gamma2, word_mask)
        seen.update(words=words.detach().clone(),
                    regions=regions.detach().clone(), mask=word_mask,
                    gammas=(gamma1, gamma2), sim=sim.detach().clone())
        return sim

    losses.damsm_similarity_fused = record
    try:
        trainer.train_step(batch)
    finally:
        losses.damsm_similarity_fused = real
    torch.cuda.synchronize()
    if not seen or seen["mask"] is None:
        failures.append(f"stage 1 use_pallas: K9 not reached with a word "
                        f"mask ({sorted(seen)})")
        return {}
    words, regions, mask = seen["words"], seen["regions"], seen["mask"]
    got = damsm.damsm_similarity_cuda(words, regions, *seen["gammas"], mask)
    want = attention.damsm_similarity(words, regions, *seen["gammas"], mask)
    err, ok = _close(got, want, DAMSM_ATOL, 0.0)
    r = {"words": list(words.shape), "regions": list(regions.shape),
         "words_masked": int((~mask).sum()), "max_abs_err": err,
         "atol": DAMSM_ATOL, "equals_step_call": torch.equal(got, seen["sim"])}
    print(f"lstm, stage 1: K9 alone on the step's own inputs against its "
          f"plain version: {json.dumps(r)}", flush=True)
    if not ok or not r["equals_step_call"] or not r["words_masked"]:
        failures.append(f"stage 1: K9 on the LSTM step's inputs: {r}")
    return r


def _step_times(tag: str, modes: dict, batch) -> dict:
    """Host ms, device ms (profiler) and busy share per mode
    (`_time_modes`), printed with the card."""
    table = _time_modes(modes, batch)
    for k, m in table.items():
        print(f"lstm, {tag}, {k}: {m['host_ms']:.3f} host ms per step "
              f"(median of {len(m['host_ms_all'])}), device "
              f"{m['device_ms']} ms, busy {m['busy_share']}, peak "
              f"{m['peak_gb']:.3f} GB; {card_line()}", flush=True)
    return {k: {n: v for n, v in m.items() if n not in ("top_ms",
                                                         "host_ms_all")}
            for k, m in table.items()}


def lstm_phase(kernels) -> dict:
    """The LSTM/GRU recipe at the shipped widths (`--only lstm`): random
    weights from manual_seed, the synthetic corpus, bf16.
    (a) stage 1, cfg/train_lstm.yml (B 128, T 18, embedding 300, 128 units
    a direction, 4500 classes, use_pallas false as shipped): the captured
    step against the eager one bit for bit after 3 and 6 steps, and so
    with use_pallas true; that twin's path counted (3 eager warm-up steps
    and the capture: one K9 launch each, masked by cap_len), its replays
    launching K9 as an eager step does (profiler), and one step with K9
    against one without it, from the same weights and dropout bits, within
    the bf16 on/off limits (ON_OFF_TOL), and K9 alone on the inputs that
    step gives it (`_lstm_k9_alone`: B 128, T 18, masked by cap_len)
    within DAMSM_ATOL of its plain version; (b) stage 2, cfg/fusion_lstm.yml
    (B 64, linear fusion): captured against eager bit for bit, its path
    counted (no kernel), and one step with fcfm (WordLevelCFA_LSTM,
    fusion_final_dim 768); (c) one stage-1 step with en_type GRU; (d)
    serving, cfg/fusion_lstm.yml at batch 32: run_test (counted: no
    kernel), and one pair batch of 32 pairs, its bf16 scores finite and
    its f32 scores on the card against the same modules' on the CPU within
    LSTM_SCORE_TOL. Host ms, device ms and busy share of (a), (b) and (d).
    Returns {path: (counts, per step or pair batch)} for the kernels line:
    "lstm_serving", "lstm_train", "lstm_stage2"."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        pair_scores, run_test)
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)

    dev = torch.device("cuda")
    failures, out = [], {}
    s1 = load_yaml(os.path.join(ROOT, "cfg", "train_lstm.yml")).replace(
        synthetic=True, checkpoints_path="")
    s2 = load_yaml(os.path.join(ROOT, "cfg", "fusion_lstm.yml")).replace(
        synthetic=True, checkpoints_path="")
    big = lambda tr: _lstm_batch(tr, s1.batch_size)  # noqa: E731

    # (a) stage 1: captured against eager, use_pallas off (as shipped)
    # and on
    report = {}
    for pallas in (False, True):
        eager, graphed, state, batch, cmp = _captured_vs_eager(
            Stage1Trainer, s1.replace(use_pallas=pallas), dev, big)
        tag = f"stage 1, use_pallas {pallas}"
        print(f"lstm, {tag}: vocabulary {eager.args.vocab_size} words "
              f"(synthetic), batch {tuple(batch['caps'].shape)}, lengths "
              f"{int(batch['cap_len'].min())}-{int(batch['cap_len'].max())}"
              f"; captured against eager: {json.dumps(cmp)}", flush=True)
        if not all(c["bitwise"] for c in cmp.values()):
            failures.append(f"{tag}: captured differs from eager: {cmp}")
        if not pallas:
            report["stage1"] = _step_times("stage 1", {
                "eager": lambda: eager.train_step(batch),
                "captured": lambda: graphed.train_step(batch)}, batch)
        del eager, graphed
    # the use_pallas path, counted: 3 eager warm-up steps and the capture
    # (its first replay), then 2 more replays (not counted)
    _zero(kernels)
    on = Stage1Trainer(s1.replace(use_pallas=True), dev)
    on.model.load_state_dict(state)
    for _ in range(6):
        on.train_step(batch)
    torch.cuda.synchronize()
    counts = _counts(kernels)
    per = {k: v / (on.WARMUP_STEPS + 1) for k, v in counts.items()}
    want = {k: (1.0 if k == "damsm_similarity" else 0.0) for k in counts}
    if per != want or on.graph_replays != 6 - on.WARMUP_STEPS:
        failures.append(f"stage 1 use_pallas: launches per step {per}, "
                        f"want {want}; replays {on.graph_replays}")
    out["lstm_train"] = (counts, per)
    on_e = _twin(on, state)
    _replays_launch_as_eager(on, on_e, batch, kernels, "lstm, stage 1, "
                             "use_pallas")
    off_e = _twin(on, state, use_pallas=False)
    on_e.model.load_state_dict(state)
    bits, _ = on_e.draw_drop(*batch["caps"].shape)
    r = _on_off(on_e, off_e, batch, (bits, None), (bits, None),
                ON_OFF_TOL["bfloat16"]["floor"])
    print(f"lstm, stage 1: K9 on against off, one step: {json.dumps(r)}",
          flush=True)
    if not _on_off_ok(r, ON_OFF_TOL["bfloat16"]):
        failures.append(f"stage 1: K9 on against off past the limits: {r}")
    report["stage1_k9_on_off"] = r
    report["stage1_k9_alone"] = _lstm_k9_alone(on_e, batch, failures)
    del on, on_e, off_e

    # (c) GRU: one stage-1 step
    gru = Stage1Trainer(s1.replace(en_type="GRU"), dev, eager=True)
    m = gru.train_step(big(gru))
    loss = float(m["total_loss"])
    print(f"lstm, stage 1 GRU: one step, total loss {loss}", flush=True)
    if not math.isfinite(loss):
        failures.append(f"GRU step: loss {loss}")
    del gru

    # (b) stage 2, linear as shipped: captured against eager, counted
    _zero(kernels)
    eager, graphed, state, batch, cmp = _captured_vs_eager(
        FusionTrainer, s2, dev)
    counts = _counts(kernels)
    steps = 6 + graphed.WARMUP_STEPS + 1
    out["lstm_stage2"] = (counts, {k: v / steps for k, v in counts.items()})
    print(f"lstm, stage 2 (linear): batch {tuple(batch['caps'].shape)}; "
          f"captured against eager: {json.dumps(cmp)}; launches "
          f"{json.dumps(counts)}", flush=True)
    if not all(c["bitwise"] for c in cmp.values()):
        failures.append(f"stage 2: captured differs from eager: {cmp}")
    if any(counts.values()):
        failures.append(f"stage 2 launched kernels: {counts}")
    report["stage2"] = _step_times("stage 2", {
        "eager": lambda: eager.train_step(batch),
        "captured": lambda: graphed.train_step(batch)}, batch)
    del eager, graphed
    fcfm = FusionTrainer(s2.replace(fusion_type="fcfm", fusion_final_dim=768),
                         dev, eager=True)
    batch = fcfm.to_device(next(iter(fcfm.train_dl)))
    loss = float(fcfm.train_step(batch)["loss"])
    print(f"lstm, stage 2 fcfm (WordLevelCFA_LSTM): one step, loss {loss}",
          flush=True)
    if not math.isfinite(loss):
        failures.append(f"fcfm step: loss {loss}")
    del fcfm
    gc.collect()
    torch.cuda.empty_cache()

    # (d) serving
    args = s2.replace(batch_size=32, is_roc=False, is_ident=False,
                      eval_table_mode=False)
    test_dl, _ = prep.prepare_dataloader(args, "test")
    mods = _serving_modules(args, dev)
    _zero(kernels)
    t0 = time.perf_counter()
    metrics = run_test(args, test_dl, *mods, None)
    torch.cuda.synchronize()
    counts = _counts(kernels)
    out["lstm_serving"] = (counts, {k: v / len(test_dl)
                                    for k, v in counts.items()})
    print(f"lstm, serving: run_test over {len(test_dl)} pair batches of 32 "
          f"in {time.perf_counter() - t0:.3f} s: {json.dumps(metrics)}; "
          f"launches {json.dumps(counts)}", flush=True)
    if any(counts.values()) or not all(
            math.isfinite(v) for v in metrics.values()):
        failures.append(f"serving: launches {counts}, metrics {metrics}")
    b = next(iter(test_dl))
    cols = [b[k] for k in ("img1", "img2", "cap1", "cap2", "cap_len1",
                           "cap_len2")]

    def pair_batch():
        return pair_scores(args, *mods, None, *cols)

    scores = pair_batch()
    host = _host_ms(pair_batch)
    prof = _profile(pair_batch)
    dev_ms = prof.get("device_ms_per_call")
    report["serving"] = {
        "host_ms": host, "device_ms": dev_ms if dev_ms else "not measured",
        "busy_share": dev_ms / host if dev_ms else "not measured"}
    print(f"lstm, serving, one pair batch of {scores.shape[0]}: "
          f"{host:.3f} host ms (median of 10), device {dev_ms} ms, busy "
          f"{report['serving']['busy_share']}; {card_line()}", flush=True)
    if scores.shape != (32,) or not bool(torch.isfinite(scores).all()):
        failures.append(f"serving scores: {scores}")
    # f32 on the card against the same modules on the CPU
    f32 = args.replace(compute_dtype="float32")
    s_card, s_cpu = (pair_scores(f32, *_serving_modules(f32, d), None, *cols)
                     for d in (dev, torch.device("cpu")))
    diff = float((s_card.cpu() - s_cpu).abs().max())
    print(f"lstm, serving: f32 pair scores, card against CPU, max |d| "
          f"{diff:.3g} (tolerance {LSTM_SCORE_TOL})", flush=True)
    if not diff <= LSTM_SCORE_TOL:
        failures.append(f"serving: f32 card against CPU {diff}")
    report["serving"]["f32_card_vs_cpu"] = diff
    print("lstm: " + json.dumps(report), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# ------------------------------------- the text archs of bert_type --

ARCHS = ("clip", "groupvit", "falva", "blip")


def _ln_count(arch) -> int:
    """The tower's LayerNorms a pass runs unfused: two a layer, the
    embeddings' and the final one where the arch has them."""
    return 2 * arch.layers + int(arch.emb_ln) + int(arch.final_ln)


def _ln_inputs(encoder, run) -> list:
    """(LayerNorm module, its input in the module's dtype) of every
    LayerNorm of `encoder` in the forward of run()."""
    from text_guided_face_recognition_tpu_torch.models.text_bert import (
        LayerNorm)
    seen, hooks = [], []

    def grab(mod, inp):
        seen.append((mod, inp[0].detach().to(mod.dtype).contiguous()))

    for m in encoder.modules():
        if isinstance(m, LayerNorm):
            hooks.append(m.register_forward_pre_hook(grab))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _ln_hold(seen: list, gen, failures: list, tag: str) -> dict:
    """K1 and K2 on each captured LayerNorm input against their plain
    versions, in the step's bf16 and again in f32 (TOL; K2 with a
    cotangent drawn from gen, `_close_scaled`), and the two kernels' device
    ms at that shape (bf16, warm L2, a graph of 20 calls) beside the plain
    version's, one PyTorch call's (F.layer_norm; native_layer_norm_backward)
    and the bound. Launches made here are not counted on any path."""
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.ops import layernorm as L
    worst = {"bfloat16": [0.0, 0.0], "float32": [0.0, 0.0]}
    for mod, x in seen:
        g, b, eps = mod.weight.detach(), mod.bias.detach(), mod.eps
        dy = torch.randn(x.shape, generator=gen).to(x.device)
        for dt, tol in TOL.items():
            xd, dyd = x.to(getattr(torch, dt)), dy.to(getattr(torch, dt))
            e, ok = _close(L.layernorm_fused(xd, g, b, eps),
                           L.layernorm_ref(xd, g, b, eps), tol)
            worst[dt][0] = max(worst[dt][0], e)
            if not ok:
                failures.append(f"{tag}: K1 at {tuple(x.shape)} {dt} eps "
                                f"{eps}: {e}")
            for k, (o, r) in enumerate(zip(L.layernorm_bwd(dyd, xd, g, eps),
                                           L.layernorm_bwd_ref(dyd, xd, g,
                                                               eps))):
                e, ok = _close_scaled(o, r, tol)
                worst[dt][1] = max(worst[dt][1], e)
                if not ok:
                    failures.append(f"{tag}: K2 output {k} at "
                                    f"{tuple(x.shape)} {dt}: {e}")
    mod, x = seen[-1]
    g, b, eps = mod.weight.detach(), mod.bias.detach(), mod.eps
    x2 = x.reshape(-1, x.shape[-1]).bfloat16()
    dy = torch.randn(x2.shape, generator=gen).to(x2.device).bfloat16()
    rows, h = x2.shape
    bg, bb = g.bfloat16(), b.bfloat16()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x2, [h], bg, bb, eps)
    times = {
        "rows": rows, "h": h, "eps": eps,
        "k1_ms": _graph_ms(lambda: L.layernorm_fused(x2, g, b, eps)),
        "k1_plain_ms": _graph_ms(lambda: L.layernorm_ref(x2, g, b, eps)),
        "k1_library_ms": _graph_ms(lambda: F.layer_norm(x2, (h,), bg, bb,
                                                        eps)),
        "k1_bound": _bound(2 * rows * h * 2 + 2 * h * 4, 8.0 * rows * h,
                           "f32")["bound_ms"],
        "k2_ms": _graph_ms(lambda: L.layernorm_bwd(dy, x2, g, eps)),
        "k2_plain_ms": _graph_ms(lambda: L.layernorm_bwd_ref(dy, x2, g,
                                                             eps)),
        "k2_library_ms": _graph_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x2, [h], mean, rstd, bg, bb, [True, True, True])),
        "k2_bound": _bound(3 * rows * h * 2 + 3 * h * 4, 12.0 * rows * h,
                           "f32")["bound_ms"],
        "max_abs_err": worst}
    return times


def _surface_on_card(failures: list) -> dict:
    """Each module of the model surface off the main path (ops/margins.py,
    models/{margins,magface,iresnet,irnet,layers,fusion,legacy_attention}
    .py) built on the CPU from a seed, run there in f32, moved to the card
    and run again on the same inputs: the largest |card - CPU| of each,
    within 1e-4 + 1e-4 |CPU| (TF32 off)."""
    import torch

    from text_guided_face_recognition_tpu_torch import models as PM
    from text_guided_face_recognition_tpu_torch.ops import margins as OM

    gen = torch.Generator().manual_seed(11)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    emb, lab = r(8, 64), torch.randint(0, 40, (8,), generator=gen)
    big = r(8, 64, scale=3.0)
    norms = emb.norm(dim=1, keepdim=True)
    img = r(1, 3, 112, 112)
    cases = {
        "add_margin_logits": (lambda: OM.add_margin_logits, (emb, r(40, 64),
                                                             lab)),
        "sphere_margin_logits": (lambda: OM.sphere_margin_logits,
                                 (emb, r(40, 64), lab, 5)),
        "adaface_logits": (lambda: OM.adaface_logits,
                           (emb / norms, r(64, 40), norms, lab,
                            torch.tensor(20.0), torch.tensor(100.0))),
        "mag_margin_logits": (lambda: lambda e, w: OM.mag_margin_logits(
            e, w, OM.linear_margin_fn(0.45, 0.8, 10.0, 110.0)),
            (big, r(64, 40))),
        "AddMarginProduct": (lambda: PM.AddMarginProduct(64, 40), (emb, lab)),
        "SphereProduct": (lambda: PM.SphereProduct(64, 40), (emb, lab)),
        "AdaFaceHead": (lambda: PM.AdaFaceHead(64, 40),
                        (emb / norms, norms, lab)),
        "MagLinear": (lambda: PM.MagLinear(64, 40), (big,)),
        "SoftmaxBuilder": (lambda: PM.SoftmaxBuilder(last_fc_size=40).eval(),
                           (img,)),
        "GNAP": (lambda: PM.GNAP(64).eval(), (r(2, 64, 7, 7),)),
        "GDC": (lambda: PM.GDC(64, 32).eval(), (r(2, 64, 7, 7),)),
        "ScaledDotProductAttention": (
            lambda: PM.ScaledDotProductAttention(32),
            (r(2, 5, 32), r(2, 7, 32), r(2, 7, 32))),
        "DotProductAttention": (lambda: PM.DotProductAttention(),
                                (r(2, 5, 32), r(2, 7, 32))),
        "MultiHeadAttention": (lambda: PM.MultiHeadAttention(32, 4),
                               (r(2, 5, 32), r(2, 7, 32), r(2, 7, 32))),
        "TorchMultiheadAttention": (
            lambda: PM.TorchMultiheadAttention(32, 4),
            (r(2, 5, 32), r(2, 7, 32), r(2, 7, 32))),
        "ParagraphLevelCFA": (lambda: PM.ParagraphLevelCFA(),
                              (r(3, 512), r(3, 256))),
        "ConcatAttention": (lambda: PM.ConcatAttention(),
                            (r(3, 512), r(3, 256))),
        "SpatialAttention": (lambda: PM.SpatialAttention(16, 24),
                             (r(2, 16, 4, 4), r(2, 5, 24))),
        "ChannelAttention": (lambda: PM.ChannelAttention(16, 24, 4, 4),
                             (r(2, 16, 16), r(2, 5, 24))),
    }
    for arch in ("iresnet34", "iresnet50", "iresnet100", "iresnet200"):
        cases[arch] = (lambda a=arch: PM.network_builder(a).eval(), (img,))
    errs = {}
    dev = torch.device("cuda")

    def flat(out):
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in flat(o)]
        return [out]

    def on(x, d):
        return x.to(d) if torch.is_tensor(x) else x

    for name, (make, inputs) in cases.items():
        with torch.no_grad():
            torch.manual_seed(0)
            cpu = flat(make()(*inputs))
            torch.manual_seed(0)       # the same weights, fresh margin state
            mod = make()
            if isinstance(mod, torch.nn.Module):
                mod.to(dev)
            card = flat(mod(*(on(x, dev) for x in inputs)))
        err = max((c.cpu().float() - p.float()).abs().max().item()
                  for c, p in zip(card, cpu))
        errs[name] = err
        if not all(_close(c.cpu(), p, 1e-4)[1] for c, p in zip(card, cpu)):
            failures.append(f"surface {name}: card against CPU {err}")
    with torch.no_grad():
        c_pair, c_norm = PM.MagLinear(64, 40)(big)
        loss = PM.mag_loss(c_pair, lab, c_norm)
        g_pair, g_norm = PM.MagLinear(64, 40).to(dev)(big.to(dev))
        errs["mag_loss"] = max(abs(float(a) - float(b)) for a, b in zip(
            loss, PM.mag_loss(g_pair, lab.to(dev), g_norm)))
    if errs["mag_loss"] > 1e-4 * (1 + abs(float(loss[0]))):
        failures.append(f"surface mag_loss: {errs['mag_loss']}")
    return errs


def archs_phase(kernels) -> dict:
    """The text archs of bert_type other than bert and align (`--only
    archs`), each at full width (12 layers; clip 512 wide, 8 heads, vocab
    49408, 77 positions; groupvit 256, 4 heads; falva and blip 768, blip's
    heads 96 wide), random weights from manual_seed, synthetic data, bf16,
    fused_ln, use_pallas and fused_block both, which none of them takes:
    the unfused tower runs (the JAX package's rule), so K3-K8 launch 0
    times. Per arch: one pair batch of 32 (cfg/test.yml; K1 on every
    LayerNorm of both sides' towers); the stage-1 step (cfg/train_bert.yml,
    B 32, 4500 classes) captured against eager bit for bit after 3 and 6
    steps (`_captured_vs_eager`), one eager step counted (K1 and K2 once
    per LayerNorm, K9 once); one stage-2 step (cfg/fusion_bert.yml, B 16,
    FCFM; K1 and K2 once per LayerNorm); K1 and K2 on that stage-1 step's
    own LayerNorm inputs (widths 256, 512, 768; eps 1e-5 and 1e-12)
    against their plain versions (`_ln_hold`) and timed; host ms of the
    pair batch and of each step (median of 5) and their device ms from the
    profiler, with the card. Then each module of the model
    surface off the main path once on the card against the CPU
    (`_surface_on_card`). Returns {path: (counts, per call)} for the
    kernels line: archs_{arch}_pair, archs_{arch}_stage1,
    archs_{arch}_stage2."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        pair_scores)
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)
    from text_guided_face_recognition_tpu_torch.models.text_bert import (
        TEXT_ARCHS)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    failures, out, report = [], {}, {}
    common = dict(synthetic=True, checkpoints_path="", fused_block="both",
                  fused_ln=True, use_pallas=True, compute_dtype="bfloat16")
    cfg = {name: load_yaml(os.path.join(ROOT, "cfg", name)).replace(
        **common) for name in ("test.yml", "train_bert.yml",
                               "fusion_bert.yml")}
    widths, epss = set(), set()
    import warnings
    for name in ARCHS:
        arch = TEXT_ARCHS[name]
        n_ln = _ln_count(arch)
        rep = {"layernorms_a_pass": n_ln}
        zero = {k: 0 for k in kernels}

        def want(**kw):
            return {**zero, **kw}

        with warnings.catch_warnings():
            # every arch here warns that it runs the unfused tower
            warnings.simplefilter("ignore", UserWarning)
            # a pair batch of 32
            args = cfg["test.yml"].replace(bert_type=name, batch_size=32,
                                           is_roc=False, is_ident=False,
                                           eval_table_mode=False)
            test_dl, _ = prep.prepare_dataloader(args, "test")
            enc, head = prep.prepare_text_encoder(args, dev)
            if enc.fused_block_effective != "none":
                failures.append(f"{name}: fused_block in effect "
                                f"{enc.fused_block_effective}")
            mods = (prep.prepare_backbone(args, dev),
                    prep.prepare_image_head(args, dev),
                    prep.prepare_fusion_net(args, dev), enc, head)
            b = next(iter(test_dl))
            cols = [b[k] for k in ("img1", "img2", "cap1", "cap2", "mask1",
                                   "mask2")]

            def pair_batch():
                return pair_scores(args, *mods, *cols)

            _zero(kernels)
            scores = pair_batch()
            torch.cuda.synchronize()
            counts = _counts(kernels)
            out[f"archs_{name}_pair"] = (counts, dict(counts))
            if counts != want(layernorm_fused=2 * n_ln):
                failures.append(f"{name} pair batch: launches {counts}")
            if scores.shape != (32,) or not bool(
                    torch.isfinite(scores).all()):
                failures.append(f"{name} pair batch: scores {scores}")
            rep["pair_host_ms"] = _host_ms(pair_batch, reps=5)
            rep["pair_device_ms"] = _profile(pair_batch).get(
                "device_ms_per_call", "not measured")
            del mods, enc, head, test_dl

            # stage 1: captured against eager, then one counted eager step
            s1 = cfg["train_bert.yml"].replace(bert_type=name)
            eager, graphed, state, batch, cmp = _captured_vs_eager(
                Stage1Trainer, s1, dev)
            if not all(c["bitwise"] for c in cmp.values()):
                failures.append(f"{name} stage 1: captured differs from "
                                f"eager: {cmp}")
            rep["stage1_captured_vs_eager"] = cmp
            _zero(kernels)
            seen = _ln_inputs(eager.model.text_encoder,
                              lambda: eager.train_step(batch))
            torch.cuda.synchronize()
            counts = _counts(kernels)
            out[f"archs_{name}_stage1"] = (counts, dict(counts))
            if counts != want(layernorm_fused=n_ln, layernorm_bwd=n_ln,
                              damsm_similarity=1) or len(seen) != n_ln:
                failures.append(f"{name} stage 1: launches {counts}, "
                                f"LayerNorm inputs {len(seen)}")
            rep["stage1_eager_host_ms"] = _host_ms(
                lambda: eager.train_step(batch), reps=5)
            rep["stage1_captured_host_ms"] = _host_ms(
                lambda: graphed.train_step(batch), reps=5)
            prof = _profile(lambda: graphed.train_step(batch), what="step")
            rep["stage1_captured_device_ms"] = prof.get(
                "device_ms_per_call", "not measured")
            rep["ln"] = _ln_hold(seen, gen, failures, name)
            widths.update(x.shape[-1] for _, x in seen)
            epss.update(m.eps for m, _ in seen)
            del eager, graphed, state, batch, seen

            # stage 2: one counted eager step
            s2 = cfg["fusion_bert.yml"].replace(
                bert_type=name, fused_block="tower", text_encoder_path="",
                image_encoder_path="")
            tr = FusionTrainer(s2, dev, eager=True)
            batch = tr.to_device(next(iter(tr.train_dl)))
            _zero(kernels)
            loss = float(tr.train_step(batch)["loss"])
            torch.cuda.synchronize()
            counts = _counts(kernels)
            out[f"archs_{name}_stage2"] = (counts, dict(counts))
            if counts != want(layernorm_fused=n_ln, layernorm_bwd=n_ln) \
                    or not math.isfinite(loss):
                failures.append(f"{name} stage 2: launches {counts}, loss "
                                f"{loss}")
            rep["stage2_eager_host_ms"] = _host_ms(
                lambda: tr.train_step(batch), reps=5)
            rep["stage2_eager_device_ms"] = _profile(
                lambda: tr.train_step(batch), what="step").get(
                "device_ms_per_call", "not measured")
            del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
        report[name] = rep
        print(f"archs, {name}: " + json.dumps(rep), flush=True)
    if widths != {256, 512, 768} or epss != {1e-5, 1e-12}:
        failures.append(f"LayerNorm widths {widths}, eps {epss}")
    t_surface = time.perf_counter()
    surface = _surface_on_card(failures)
    print(f"archs: the model surface on the card against the CPU, max "
          f"|d| {json.dumps(surface)} ({time.perf_counter() - t_surface:.1f}"
          f" s)", flush=True)
    print(f"archs: phase {time.perf_counter() - t_phase:.1f} s; "
          f"{card_line()}", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


# ------------------------------------------- the stage options (PR 13) --

# images of the synthetic train split for the frozen-feature cache's checks:
# four chunks of feature_cache_batch 256 and a short fifth of 76
CACHE_SPLIT = 1100
# the device kernels of a stage-1 step's replay that K1-K6 and K9 launch
STAGE1_REPLAY_KEYS = ("layernorm_fwd_kernel", "layernorm_bwd_kernel",
                      "hl_gemm_kernel", "hl_bwd_gemm_kernel", "attention",
                      "damsm_kernel")


def _grow_split(ds, n: int) -> None:
    """Make a synthetic train split `n` images long: keys s{i}_0 (a
    distinct image each), image i's captions those of image i mod the old
    length, class ids i mod num_classes."""
    m, cpi = len(ds.filenames), ds.embeddings_num

    def spread(xs):
        return [xs[(i % m) * cpi + k] for i in range(n) for k in range(cpi)]

    ds.filenames = [f"s{i}_0" for i in range(n)]
    ds.captions = spread(ds.captions)
    if ds.att_masks is not None:
        ds.att_masks = spread(ds.att_masks)
    ds.class_id = [i % int(ds.args.num_classes) for i in range(n)]


def _cache_checks(cls, args, dev, tag: str) -> dict:
    """With and without the frozen-feature cache, eager, from the same
    weights over a CACHE_SPLIT-image split: the refresh (seconds per 1000
    images, host bytes); the cache's (gl, lc) of the short last chunk's
    last 32 images against the in-step backbone at B 32 (bf16: max |a - b|
    <= 2e-2 max(1, max |b|), as the backward outputs are held: the
    backbone at B 256 and at B 32 runs other cuDNN algorithms, whose bf16
    roundings move an element by steps of the largest ones); one epoch of
    the two loaders, caption indices, masks and class ids equal bit for
    bit; the first batch's step with the cache and without it, on the same
    dropout draws, total loss within 1e-2 relative. Returns the readings,
    the two trainers and the first batch of each."""
    import numpy as np
    import torch

    cached = cls(args.replace(frozen_feature_cache=True), dev, eager=True)
    plain = cls(args, dev, eager=True)
    plain.model.load_state_dict(cached.model.state_dict())
    for tr in (cached, plain):
        _grow_split(tr.train_ds, CACHE_SPLIT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached.refresh_features()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    cache = cached.feat_cache
    n = len(cached.train_ds)
    idx = list(range(n - 32, n))
    img = torch.from_numpy(np.stack([cached.train_ds.peek_augmented_image(i)
                                     for i in idx])).to(dev)
    gl, lc = cached.image_features(img)
    gl_err, gl_ok = _close_scaled(cache.gl[idx].to(dev), gl, 2e-2)
    lc_err, lc_ok = _close_scaled(cache.lc[idx].to(dev), lc, 2e-2)
    extra = "mask" if args.en_type == "BERT" else "cap_len"
    first, n_batches, same = None, 0, True
    for bc, bp in zip(cached.train_dl, plain.train_dl):
        if "img" in bc or "img_gl" not in bc or "img" not in bp:
            raise AssertionError(f"{tag}: batch keys {sorted(bc)} with the "
                                 f"cache, {sorted(bp)} without")
        same &= all(np.array_equal(bc[k], bp[k])
                    for k in ("caps", extra, "cls_id"))
        if first is None:
            first = (cached.to_device(bc), plain.to_device(bp))
        n_batches += 1
    key = "total_loss" if cls.__name__ == "Stage1Trainer" else "loss"
    loss_c = float(cached.train_step(first[0])[key])
    loss_p = float(plain.train_step(first[1])[key])
    rel = abs(loss_c - loss_p) / abs(loss_p)
    out = {"images": n, "chunk": int(args.feature_cache_batch),
           "refresh_s": refresh_s,
           "refresh_s_per_1000": refresh_s * 1e3 / n,
           "host_bytes": cache.host_bytes(),
           "host_bytes_per_image": cache.host_bytes() / n,
           "gl_max_abs_err": gl_err, "gl_max_abs": gl.abs().max().item(),
           "lc_max_abs_err": lc_err,
           "lc_max_abs": lc.float().abs().max().item(),
           "batches_compared": n_batches, "captions_equal": bool(same),
           "loss_cached": loss_c, "loss_plain": loss_p, "loss_rel": rel}
    print(f"{tag}: cache against in-step backbone: " + json.dumps(out),
          flush=True)
    if not (gl_ok and lc_ok and same and rel <= 1e-2
            and n_batches == len(cached.train_dl)):
        raise AssertionError(f"{tag}: cache checks failed: {out}")
    return out, cached, plain, first


def _resume_check(args, dev, tag: str) -> dict:
    """A stage-1 run of 2 eager steps saved as a train state and resumed in
    a fresh trainer: step 3 of the resumed trainer equals step 3 of the
    uninterrupted one bit for bit (every parameter, BN statistic, moment,
    count and metric), both fed step 3's dropout draw."""
    import tempfile

    import torch

    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    run = Stage1Trainer(args, dev, eager=True)
    batch = run.to_device(next(iter(run.train_dl)))
    for _ in range(2):
        run.train_step(batch)
    os.makedirs(os.path.join(ROOT, "checkpoints"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "checkpoints"))
    try:
        run.save_state(d, 1)
        back = Stage1Trainer(args, dev, eager=True)
        back.resume_from(os.path.join(d, "train_state_1"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bits, seeds = run.draw_drop(*batch["caps"].shape)
    m_run = run.train_step(batch, drop_bits=bits, drop_seeds=seeds)
    m_back = back.train_step(batch, drop_bits=bits, drop_seeds=seeds)
    equal, worst, at = _max_diff(_snapshot(back), _snapshot(run))
    m_eq = all(torch.equal(m_run[k], m_back[k]) for k in m_run)
    out = {"bitwise": equal and m_eq, "max_abs": worst, "at": at,
           "start_epoch": back.start_epoch,
           "cmp_in_state": any(k.startswith("model.cmp.")
                               for k in _snapshot(back))}
    print(f"{tag}: step 3 resumed against uninterrupted: {json.dumps(out)}",
          flush=True)
    if not (out["bitwise"] and out["cmp_in_state"]):
        raise AssertionError(f"{tag}: the resumed step differs: {out}")
    return out


def options_phase(kernels) -> dict:
    """The stage options last ported (`--only options`), at full width in
    bf16: stage 1 (cfg/train_bert.yml, batch 32, 4500 classes, fused_block
    both, fused_ln, use_pallas) with is_CMP and is_WRA, captured against
    eager bit for bit, with every count zeroed before and read after (the
    eager trainer's 6 steps and the captured one's 3 warm-up steps and
    capture), its replays launching K1-K6 and K9 as an eager step does
    (profiler); the frozen-feature cache in stage 1 (with CMP and WRA) and
    stage 2 (cfg/fusion_bert.yml, batch 16, tower, fused_ln; its counts
    read as stage 1's), each captured against eager bit for bit with the
    cache and checked against the in-step backbone (`_cache_checks`); a
    resumed stage-1 train state (`_resume_check`); and the step times in
    turns: stage 1 with CMP+WRA against without, each stage with the cache
    against without. Returns {path: (counts, counts per step)}."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)

    dev = torch.device("cuda")
    base1 = load_yaml(os.path.join(ROOT, "cfg", "train_bert.yml")).replace(
        synthetic=True, fused_block="both", fused_ln=True, use_pallas=True,
        compute_dtype="bfloat16", batch_size=32, checkpoints_path="")
    opts = base1.replace(is_CMP=True, is_WRA=True)
    base2 = load_yaml(os.path.join(ROOT, "cfg", "fusion_bert.yml")).replace(
        synthetic=True, fused_block="tower", fused_ln=True,
        checkpoints_path="")
    layers = 12
    per1 = {k: 0 for k in kernels}
    per1.update({"layernorm_fused": 1, "layernorm_bwd": 1,
                 "attn_block": layers, "attn_block_bwd": layers,
                 "ffn_block": layers, "ffn_block_bwd": layers,
                 "damsm_similarity": 1})
    per2 = {k: 0 for k in kernels}
    per2.update({"layernorm_fused": 1, "layernorm_bwd": 1,
                 "tower_block": 1, "tower_block_bwd": 1})
    report, paths, failures = {}, {}, []

    def captured(tag, cls, args, per, make_batch=None):
        _zero(kernels)
        eager, graphed, state, batch, cmp = _captured_vs_eager(
            cls, args, dev, make_batch)
        torch.cuda.synchronize()
        counts = _counts(kernels)
        steps = 6 + graphed.WARMUP_STEPS + 1
        print(f"{tag}: captured against eager: {json.dumps(cmp)}; "
              f"launches {counts}", flush=True)
        if not all(c["bitwise"] for c in cmp.values()):
            failures.append(f"{tag}: captured differs from eager: {cmp}")
        if counts != {k: steps * v for k, v in per.items()}:
            failures.append(f"{tag}: launch counts {counts} != {steps} x "
                            f"{per}")
        replay = _replays_launch_as_eager(graphed, eager, batch, kernels,
                                          tag)
        report[tag] = {"captured_vs_eager": cmp}
        return eager, graphed, batch, (counts, per), replay

    # stage 1 with CMP and WRA: the path's counts, replays, losses
    e1, g1, b1, paths["options_stage1"], replay = captured(
        "options, stage 1 CMP+WRA", Stage1Trainer, opts, per1)
    missing = [k for k in STAGE1_REPLAY_KEYS
               if not any(k in name for name in replay)]
    if missing:
        failures.append(f"stage-1 replay lacks {missing}: {sorted(replay)}")
    m = e1.train_step(b1)
    losses = {k: float(v) for k, v in m.items()}
    print("options, stage 1 CMP+WRA: losses " + json.dumps(losses),
          flush=True)
    if not all(math.isfinite(v) for v in losses.values()) or not (
            "wra_loss" in losses and "cmp_loss" in losses):
        failures.append(f"stage-1 CMP+WRA losses {losses}")
    report["stage1_losses"] = losses
    del e1
    g_plain = Stage1Trainer(base1, dev)
    b_plain = g_plain.to_device(next(iter(g_plain.train_dl)))
    for _ in range(g_plain.WARMUP_STEPS + 1):
        g_plain.train_step(b_plain)
    times = {"stage 1, CMP+WRA": _time_modes(
        {"stage 1 CMP+WRA, captured": lambda: g1.train_step(b1),
         "stage 1 without, captured": lambda: g_plain.train_step(b_plain)},
        b1)}
    del g1, g_plain
    gc.collect()
    torch.cuda.empty_cache()

    # the resumed train state (stage 1, CMP+WRA)
    report["resume"] = _resume_check(opts, dev, "options, resume")
    gc.collect()
    torch.cuda.empty_cache()

    # the cache, stage 1 (CMP+WRA) and stage 2
    for stage, cls, args, per in (("stage 1", Stage1Trainer, opts, per1),
                                  ("stage 2", FusionTrainer, base2, per2)):
        tag = f"options, {stage} cache"
        checks, cached, plain, first = _cache_checks(cls, args, dev, tag)
        report[f"{stage}_cache"] = checks
        del cached, plain, first
        gc.collect()
        torch.cuda.empty_cache()

        def cache_batch(tr):
            tr.refresh_features()
            return tr.to_device(next(iter(tr.train_dl)))

        _, g_cache, bc, paths[f"options_{stage.replace(' ', '')}_cache"], \
            _ = captured(tag, cls, args.replace(frozen_feature_cache=True),
                         per, cache_batch)
        gp = cls(args, dev)
        gp.model.load_state_dict(g_cache.model.state_dict())
        bp = gp.to_device(next(iter(gp.train_dl)))
        for _ in range(gp.WARMUP_STEPS + 1):
            gp.train_step(bp)
        times[f"{stage}, cache"] = _time_modes(
            {f"{stage} with the cache, captured":
                 lambda: g_cache.train_step(bc),
             f"{stage} without, captured": lambda: gp.train_step(bp)}, bc)
        del g_cache, gp
        gc.collect()
        torch.cuda.empty_cache()

    card = card_line()
    for what, table in times.items():
        for k, m in table.items():
            print(f"options, {k}: {m['host_ms']:.3f} host ms per step "
                  f"(median of {len(m['host_ms_all'])} in turns), device "
                  f"{m['device_ms']} ms, busy {m['busy_share']}, peak "
                  f"{m['peak_gb']:.3f} GB ({card})", flush=True)
    report["times"] = {w: {k: {n: v for n, v in m.items() if n != "top_ms"}
                           for k, m in t.items()} for w, t in times.items()}
    report["card"] = card
    print("options: " + json.dumps(report), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


# ------------------------------------------------------------ parallel --
# Data parallelism (`--only parallel`): the ranks are processes of this
# script (`--dp_rank`), launched as torchrun would launch them.

PARALLEL_TIMEOUT = 300
# an entry point's run in the parallel phase, process start to exit: a
# rank left hanging in the process group's teardown fails it
CLI_TIMEOUT = 180
LOSS_KEY = {"stage1": "total_loss", "stage2": "loss"}


def _dp_configs() -> dict:
    """The phase's configurations: stage 1 as cfg/train_bert.yml trains
    (bert-base, B 32, 4500 classes, bf16, fused_block both, fused_ln,
    use_pallas) in host mode, stage 2 as cfg/fusion_bert.yml (B 16,
    fused_block tower, fused_ln) in host mode, serving as phase 5 with one
    pair batch of 33 pairs."""
    from text_guided_face_recognition_tpu_torch.config import load_yaml

    def cfg(name, **kw):
        return load_yaml(os.path.join(ROOT, "cfg", name)).replace(
            synthetic=True, compute_dtype="bfloat16", fused_ln=True,
            fused_dropout=True, checkpoints_path="", **kw)

    return {"stage1": cfg("train_bert.yml", fused_block="both",
                          use_pallas=True, batch_size=32),
            "stage2": cfg("fusion_bert.yml", fused_block="tower"),
            "serving": cfg("test.yml", fused_block="both", batch_size=33,
                           is_roc=False, is_ident=False,
                           eval_table_mode=False)}


def _dp_grad_check(got: dict, ref: dict, loss: float, loss_ref: float,
                   dtype: str, stage: str) -> dict:
    """A rank's step against one process's, under the rule the script holds
    one training step to (kernels on against off: ON_OFF_TOL, stage 2
    ON_OFF_TOL_STAGE2): the loss, each top-level module's ||d|| / ||g_ref||
    and each parameter's max |d| / (max |g_ref| + k G), d = g - g_ref, G
    the largest reference gradient element. In f32 also per parameter
    ||d|| <= 1e-4 ||g_ref|| + k G sqrt(n) and the kernels' backward rule
    max |d| <= 1e-4 max(1, max |g_ref|). In bf16 those two are read, not
    held: the ranks' GEMMs and convolutions run at half the batch, where
    cuBLAS and cuDNN choose other algorithms, and the BatchNorm sums add in
    another order, so bf16 roundings flip, and a bias whose gradient is
    zero in exact arithmetic (before a train-mode BatchNorm) keeps only
    that noise. Returns the readings and "ok"."""
    import torch
    tol = (ON_OFF_TOL_STAGE2 if stage == "stage2" else ON_OFF_TOL)[dtype]
    big = max(float(g.abs().max()) for g in ref.values())
    worst = {"kernel_rule": (0.0, ""), "norm_rule": (0.0, ""),
             "max": (0.0, "")}
    sums = {}
    for name, r in ref.items():
        d = got[name].float() - r.float()
        dmax, rmax = float(d.abs().max()), float(r.abs().max())
        dn = float(torch.linalg.vector_norm(d))
        rn = float(torch.linalg.vector_norm(r.float()))
        for key, v in (
                ("kernel_rule", dmax / (TOL[dtype] * max(1.0, rmax))),
                ("norm_rule", dn / (TOL[dtype] * rn + tol["floor"] * big
                                    * math.sqrt(r.numel())) if dn else 0.0),
                ("max", dmax / (rmax + tol["floor"] * big) if dmax
                 else 0.0)):
            worst[key] = max(worst[key], (v, name))
        acc = sums.setdefault(name.split(".")[0], [0.0, 0.0])
        acc[0] += dn ** 2
        acc[1] += rn ** 2
    l2 = {mod: math.sqrt(e / n) if n else math.sqrt(e)
          for mod, (e, n) in sums.items()}
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    ok = (loss_rel <= tol["loss"] and worst["max"][0] <= tol["max"]
          and all(l2[mod] <= _l2_tol(tol, mod) for mod in l2))
    if dtype == "float32":
        ok = ok and worst["kernel_rule"][0] <= 1.0 and \
            worst["norm_rule"][0] <= 1.0
    return {"ok": ok, "loss_rel": loss_rel, "l2": l2,
            **{f"worst_{k}": v for k, v in worst.items()}}


def _param_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


class _CollectiveClock:
    """Wall time inside torch.distributed's all_gather and all_reduce
    (synchronised on both sides), and the calls made while the calling
    thread's stream is being captured (`captured`); every call counted by
    collective, thread and capture (`by_thread`)."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.saved = dist, {}
        self.seconds, self.calls, self.captured = 0.0, 0, 0
        self.by_thread = {}

    def __enter__(self):
        import threading

        import torch
        for name in ("all_gather", "all_reduce"):
            fn = self.saved[name] = getattr(self.dist, name)

            def timed(*a, _fn=fn, _name=name, **k):
                self.calls += 1
                capturing = torch.cuda.is_current_stream_capturing()
                key = (f"{_name} on {threading.current_thread().name}"
                       + (", capturing" if capturing else ""))
                self.by_thread[key] = self.by_thread.get(key, 0) + 1
                if capturing:
                    self.captured += 1
                    return _fn(*a, **k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out

            setattr(self.dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _nccl_kernels(fn) -> int:
    """Device kernels whose name holds "nccl" in one call of fn
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "nccl" in e.name.lower())


def _split(prof: dict) -> dict:
    """A `_profile` result's device ms a call by kind of kernel: the
    port's kernels, cuBLAS/CUTLASS GEMMs, cuDNN convolutions, NCCL,
    the optimizer's multi-tensor kernels, copies and fills, and the rest
    (elementwise, reductions, norms)."""
    kinds = (("port kernels", ("tower_", "hl_gemm", "gemm_kernel",
                               "attention_mma", "attention_core",
                               "layernorm_", "colsum", "damsm_kernel")),
             ("nccl", ("nccl",)),
             ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
             ("cuBLAS/CUTLASS GEMM", ("gemm", "xmma", "cutlass", "gemv",
                                      "sm90_", "sm80_")),
             ("cuDNN convolution", ("conv", "implicit", "winograd",
                                    "fprop", "dgrad", "wgrad")),
             ("copies and fills", ("memcpy", "memset", "copy_", "fill_")))
    out = {"device_ms": prof.get("device_ms_per_call", "not measured")}
    for name, (ms, _) in prof.get("kernels", {}).items():
        low = name.lower()
        kind = next((k for k, keys in kinds if any(w in low for w in keys)),
                    "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def _reduce_ab(tr, reps: int = 10) -> dict:
    """Three designs of the gradient reduction on the trainer's gradients:
    the trainer's, its persistent flat buckets that the gradients live in
    as views (`attach_buckets`: the bucket's fill and the backward's
    accumulation, here an add, then one all-reduce), against each bucket's
    gradients flattened into a new tensor, all-reduced and copied back,
    and one coalesced NCCL call of a bucket's tensors in place. Device ms
    a call (CUDA events, median of `reps`, in turns); every rank makes the
    same calls."""
    import torch
    import torch.distributed as dist

    buckets = [[p.grad.clone() for p in params]
               for _, params, _ in tr._buckets]

    def bucket_views():
        for (flat, _, views), grads in zip(tr._buckets, buckets):
            flat.zero_()
            torch._foreach_add_(views, grads)
            dist.all_reduce(flat)

    def flat_copy():
        for grads in buckets:
            f = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(f)
            torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
                f.split([g.numel() for g in grads]), grads)])

    def coalesced():
        for grads in buckets:
            with dist._coalescing_manager():
                for g in grads:
                    dist.all_reduce(g)

    times = {"bucket_views": [], "flat_copy": [], "coalesced": []}
    for _ in range(reps):
        for name, fn in (("bucket_views", bucket_views),
                         ("flat_copy", flat_copy), ("coalesced", coalesced)):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {"bytes": sum(g.numel() * g.element_size() for b in buckets
                         for g in b),
            "tensors": sum(len(b) for b in buckets),
            **{f"{k}_ms": statistics.median(v) for k, v in times.items()},
            **{f"{k}_ms_all": v for k, v in times.items()}}


def _dp_reference(cls, args, dev, kernels, tag: str, world: int,
                  steps: int = 0) -> dict:
    """One process's step on the global batch (this card, no process
    group): the train loader's first batch, the weights from manual_seed,
    the first dropout draw of drop_gen; its gradients, loss, launch counts
    and, with `steps`, the losses of that many steps of the captured
    trainer on the batch (the first three eager, then the capture and its
    replays) and the device-time split of a replay (`_split`).
    The frozen backbone's features enter the batch (img_gl, img_lc), made
    `world` chunks at a time as the ranks make theirs in their steps: cuDNN
    picks its bf16 convolution by batch size, and the features of one
    batch of B and of two of B / 2 differ by rounding (`backbone_chunks`:
    the largest difference), which is not the data parallelism's to
    answer for."""
    import torch
    t0 = time.perf_counter()
    tr = cls(args, dev, eager=not steps)
    batch = next(iter(tr.train_dl))
    gen = tr.drop_gen.get_state()
    dev_batch = tr.to_device(batch)
    img = dev_batch.pop("img")
    bl = img.shape[0] // world
    parts = [tr.image_features(img[i * bl:(i + 1) * bl])
             for i in range(world)]
    dev_batch["img_gl"] = torch.cat([p[0] for p in parts])
    dev_batch["img_lc"] = torch.cat([p[1] for p in parts])
    whole = tr.image_features(img)
    chunks = max(float((a - b).abs().max()) for a, b in zip(
        whole, (dev_batch["img_gl"], dev_batch["img_lc"])))
    _zero(kernels)
    total, _ = tr.compute_grads(dev_batch)
    torch.cuda.synchronize()
    out = {"keys": [str(k) for k in batch["key"]], "gen": gen,
           "loss": float(total), "grads": _param_grads(tr.model),
           "counts": _counts(kernels), "backbone_chunks": chunks}
    if steps:
        tr.drop_gen.set_state(gen)
        out["losses"] = [float(tr.train_step(dev_batch)[LOSS_KEY[tag]])
                         for _ in range(steps)]
        out["split"] = _split(_profile(lambda: tr.train_step(dev_batch),
                                       reps=3, what="step"))
        tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _dp_stage(cls, args, dev, kernels, ref: dict, captured: bool, tag: str,
              full: bool, failures: list) -> dict:
    """This rank's step: its rows of the global batch (the loader's
    process shard), the same weights and dropout stream as the reference;
    counts zeroed just before and read just after (and K9's operand
    shapes); the gradients against the reference's (`_dp_grad_check`).
    With `full`: in stage 1 a gather whose backward sums over the ranks,
    which the check must fail; host and device ms per step and the
    collectives' share. `captured`: the trainer's captured steps (six: the
    first three eager, the fourth captured). A failed check is appended to
    `failures`."""
    import torch

    from text_guided_face_recognition_tpu_torch.engine import stage1 as s1
    from text_guided_face_recognition_tpu_torch.ops import losses
    from text_guided_face_recognition_tpu_torch.parallel import (
        contrastive, mesh)

    t0 = time.perf_counter()
    rank, world = mesh.rank(), mesh.world_size()
    what = f"parallel ({tag}, {args.compute_dtype})"
    tr = cls(args, dev, eager=not captured)
    batch = next(iter(tr.train_dl))
    keys = [str(k) for k in batch["key"]]
    bl = len(keys)
    if bl * world != args.batch_size or \
            keys != ref["keys"][rank * bl:(rank + 1) * bl]:
        failures.append(f"{what}: rank {rank} loads {keys}, not its rows "
                        "of the global batch")
    tr.drop_gen.set_state(ref["gen"])
    dev_batch = tr.to_device(batch)
    shapes = []
    orig = losses.damsm_similarity_fused       # K9's caller in words_loss

    def recorded(words, *a, **k):
        shapes.append(tuple(words.shape))
        return orig(words, *a, **k)

    losses.damsm_similarity_fused = recorded
    _zero(kernels)
    try:
        if captured:     # the first of the captured trainer's steps
            total = tr.train_step(dev_batch)[LOSS_KEY[tag]]
        else:
            total, _ = tr.compute_grads(dev_batch)
        torch.cuda.synchronize()
    finally:
        losses.damsm_similarity_fused = orig
    counts = _counts(kernels)
    check = _dp_grad_check(_param_grads(tr.model), ref["grads"],
                           float(total), ref["loss"], args.compute_dtype, tag)
    out = {"rows": bl, "loss": float(total), "loss_one_process": ref["loss"],
           "counts": counts, "damsm_words": shapes, "check": check,
           "backbone_chunks_vs_whole": ref["backbone_chunks"]}
    if counts != ref["counts"]:
        failures.append(f"{what}: rank {rank} launches {counts}, one "
                        f"process {ref['counts']}")
    if not check["ok"]:
        failures.append(f"{what}: rank {rank} against one process: "
                        f"{json.dumps(check)}")
    if full and tag == "stage1":
        saved = s1.gather_global_negatives
        s1.gather_global_negatives = (
            lambda x: contrastive._gather_rows(x, summed=True))
        try:
            tr.drop_gen.set_state(ref["gen"])
            fault_total, _ = tr.compute_grads(dev_batch)
        finally:
            s1.gather_global_negatives = saved
        planted = _dp_grad_check(_param_grads(tr.model), ref["grads"],
                                 float(fault_total), ref["loss"],
                                 args.compute_dtype, tag)
        out["planted_summed_gather"] = planted
        if planted["ok"]:
            failures.append(f"{what}: a gather whose backward sums over the "
                            f"ranks passed the check: {planted}")
    if captured:
        losses_ = [float(total)] + [
            float(tr.train_step(dev_batch)[LOSS_KEY[tag]]) for _ in range(5)]
        out["losses"], out["replays"] = losses_, tr.graph_replays
        tol = ON_OFF_TOL[args.compute_dtype]["loss"]
        if tr.graph_replays != 6 - tr.WARMUP_STEPS or any(
                abs(a - b) > tol * abs(b)
                for a, b in zip(losses_, ref["losses"])):
            failures.append(f"{what}: captured losses {losses_} against one "
                            f"process {ref['losses']} (replays "
                            f"{tr.graph_replays})")
        out["nccl_kernels_in_a_replay"] = _nccl_kernels(
            lambda: tr.train_step(dev_batch))
        if not out["nccl_kernels_in_a_replay"]:
            failures.append(f"{what}: no NCCL kernel in a replay")
    if full:
        def step():
            tr.train_step(dev_batch)

        host = []
        with _CollectiveClock() as clock:
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t1) * 1e3)
        prof = _profile(step, reps=1, what="step")
        nccl = sum(v[0] for k, v in prof.get("kernels", {}).items()
                   if "nccl" in k.lower())
        ms = statistics.median(host)
        if captured:
            out["split"] = _split(_profile(step, reps=3, what="step"))
            out["split_one_process"] = ref.get("split")
            out["reduction"] = _reduce_ab(tr)
        out["timing"] = {
            "host_ms": ms, "host_ms_all": host,
            "device_ms": prof.get("device_ms_per_call", "not measured"),
            "collectives_host_ms": clock.seconds * 1e3 / 3,
            "collectives_host_share": (clock.seconds * 1e3 / 3 / ms
                                       if not captured else "captured"),
            "nccl_device_ms": nccl,
            "top_device_ms": prof.get("top_ms_per_call")}
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _dp_pairs(args, dev, kernels) -> tuple:
    """One pair batch of 33 pairs through predict_pairs (sharded under a
    process group): (scores, launch counts)."""
    import torch

    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        predict_pairs)
    dl, ds = prep.prepare_dataloader(args, "test")
    ds.imgs_pair, ds.pair_label = ds.imgs_pair[:33], ds.pair_label[:33]
    te, th = prep.prepare_text_encoder(args, dev)
    mods = (prep.prepare_backbone(args, dev), prep.prepare_image_head(
        args, dev), prep.prepare_fusion_net(args, dev), te, th)
    _zero(kernels)
    preds, _ = predict_pairs(args, dl, *mods)
    torch.cuda.synchronize()
    return preds, _counts(kernels)


def _dp_captured(cfg, dev) -> dict:
    """The captured data-parallel stage-1 step against eager steps bit for
    bit (`_captured_vs_eager`), with the collectives counted; the trainers
    and their graph are gone when it returns (a process group left with a
    graph of its collectives alive hung on two cards)."""
    import torch

    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    with _CollectiveClock() as clock:
        _, graphed, _, batch, cmp = _captured_vs_eager(Stage1Trainer, cfg,
                                                       dev)
    out = {"captured_vs_eager": cmp, "collectives": clock.by_thread,
           "collectives_in_capture": clock.captured,
           "nccl_kernels_in_a_replay": _nccl_kernels(
               lambda: graphed.train_step(batch)),
           "graph": graphed.graph is not None}
    graphed.close()
    del graphed, batch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def dp_cli(out_dir: str) -> None:
    """One rank of the stage-1 entry point under the launcher's variables
    (`--dp_rank cli`): cli.train_encoders_bert.main through cli.run, as
    `python -m` runs it (the step captured, two epochs of two steps; run
    closes the trainer and leaves the group), then this rank's record to
    out_dir/rank{RANK}.json: what the trainer held at the end of main,
    the files rank 0 wrote, and whether the group was left."""
    from text_guided_face_recognition_tpu_torch.cli import (
        run, train_encoders_bert)
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    rank = int(os.environ["RANK"])
    ckpt = os.path.join(out_dir, "checkpoints")
    res = {"rank": rank, "mode": "cli"}
    t0 = time.perf_counter()

    def main():
        tr = train_encoders_bert.main([
            "--cfg", os.path.join(ROOT, "cfg", "train_bert.yml"),
            "--synthetic", "--fused_block", "both", "--fused_ln",
            "--use_pallas", "--compute_dtype", "bfloat16", "--batch_size",
            "32", "--checkpoints_path", ckpt, "--max_steps", "2",
            "--max_epoch", "2"])
        res.update(backend=mesh.backend(), world=mesh.world_size(),
                   steps=tr.steps, graph=tr.graph is not None,
                   replays=tr.graph_replays, rows=tr.train_dl.batch_size
                   // mesh.world_size(), save_dir=tr.save_dir(),
                   expect=[f"{tr.args.model_type}_image_encoder_2",
                           f"{tr.args.bert_type}_text_encoder_2",
                           "train_state_2"])
        return tr

    run(main)
    res["group_left"] = not mesh.active()
    res["saved"] = (sorted(os.listdir(res["save_dir"]))
                    if os.path.isdir(res["save_dir"]) else [])
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _check_cli(runs: list, world: int, tag: str) -> str:
    """The entry point's ranks (`dp_cli`): each captured its step and left
    the group, rank 0 wrote the last epoch's three files (the prune keeps
    the newest); a line for the log."""
    bad = [r for r in runs if r["world"] != world or r["backend"] != "nccl"
           or r["steps"] != 4 or not r["graph"] or r["replays"] != 1
           or not r["group_left"]]
    if len(runs) != world or bad or \
            not set(runs[0]["expect"]) <= set(runs[0]["saved"]):
        raise AssertionError(f"parallel ({tag}) entry point: {runs}")
    return (f"the entry point on {world} NCCL rank(s): 4 steps (the fourth "
            f"captured), rank 0 wrote {runs[0]['saved']}, every rank left "
            f"the group, {max(r['seconds'] for r in runs):.1f} s")


def dp_rank(mode: str, out_dir: str) -> None:
    """One rank of the parallel phase (`--dp_rank`; RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT set by the
    launcher). Modes: "gloo" (two ranks sharing one card, eager steps),
    "nccl1" (one rank over NCCL, the captured step with its collectives
    against eager steps bit for bit), "nccl2" (a rank a card, captured).
    The stage steps run in bf16 (the configs') and once more in f32, whose
    rounding leaves the data parallelism's own differences in sight.
    Writes its results to out_dir/rank{RANK}.json, then raises if a check
    failed."""
    import torch

    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    kernels = kernel_fns()
    cfgs = _dp_configs()
    res = {"rank": rank, "mode": mode, "device": str(dev)}
    failures = []
    t0 = time.perf_counter()
    if mode == "nccl1":
        mesh.init_group(dev, "nccl", 0, 1, "env://")
        res["backend"] = mesh.backend()
        res.update(_dp_captured(cfgs["stage1"], dev))
    else:
        runs = [("stage1", Stage1Trainer, "bfloat16"),
                ("stage1", Stage1Trainer, "float32")]
        if mode == "gloo":
            runs += [("stage2", FusionTrainer, "bfloat16"),
                     ("stage2", FusionTrainer, "float32")]
        refs = [_dp_reference(cls, cfgs[tag].replace(compute_dtype=dt), dev,
                              kernels, tag, world,
                              steps=6 if mode == "nccl2" and
                              dt == "bfloat16" else 0)
                for tag, cls, dt in runs]
        if mode == "gloo":
            pairs_ref, pair_counts_ref = _dp_pairs(cfgs["serving"], dev,
                                                   kernels)
        res["reference_s"] = time.perf_counter() - t0
        mesh.init_from_env(cpu=False)
        res["backend"] = mesh.backend()
        want = "gloo" if mode == "gloo" else "nccl"
        if res["backend"] != want:
            raise AssertionError(f"{mode}: backend {res['backend']}")
        # CUDA tensors through the backend's collectives
        x = torch.full((3,), float(rank + 1), device=dev)
        got = mesh.all_gather_rows(x)
        mesh.all_reduce_sum_(x)
        if got.tolist() != [float(r + 1) for r in range(world)
                            for _ in range(3)] or \
                x.tolist() != [world * (world + 1) / 2] * 3:
            raise AssertionError(f"{mode}: collectives of CUDA tensors gave "
                                 f"{got.tolist()} and {x.tolist()}")
        for (tag, cls, dt), ref in zip(runs, refs):
            full = dt == "bfloat16"     # f32: the gradients of one step
            res[tag if full else f"{tag}_f32"] = _dp_stage(
                cls, cfgs[tag].replace(compute_dtype=dt), dev, kernels, ref,
                mode == "nccl2" and full, tag, full, failures)
        if mode == "nccl2":     # the captured DP step against eager DP
            res.update(_dp_captured(cfgs["stage1"], dev))
        if mode == "gloo":
            preds, counts = _dp_pairs(cfgs["serving"], dev, kernels)
            diff = max(abs(a - b) for a, b in zip(preds, pairs_ref))
            res["pairs"] = {"pairs": len(preds), "max_abs_diff": diff,
                            "counts": counts,
                            "counts_one_process": pair_counts_ref}
            if len(preds) != 33 or diff > SCORE_TOL or \
                    counts != pair_counts_ref:
                failures.append(f"pairs: {res['pairs']}")
            if rank == 0:       # the captured step under gloo raises
                try:
                    FusionTrainer(cfgs["stage2"], dev)
                except RuntimeError as e:
                    res["captured_under_gloo"] = str(e)[:160]
                else:
                    failures.append("a captured step under gloo was made")
        mesh.barrier()
    if "captured_vs_eager" in res:
        if not all(v["bitwise"] for v in res["captured_vs_eager"].values()):
            failures.append(f"captured against eager "
                            f"{res['captured_vs_eager']}")
        if not res["collectives_in_capture"] or not res["graph"]:
            failures.append("no collective in the captured step")
    res["seconds"] = time.perf_counter() - t0
    res["failures"] = failures
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.shutdown()
    if failures:
        raise AssertionError(f"parallel {mode} rank {rank}: " +
                             "; ".join(failures))


def _launch_ranks(mode: str, world: int, out_dir: str) -> list:
    """Start `world` ranks of this script in `mode` with the variables
    torchrun sets (LOCAL_WORLD_SIZE `world` on this host), wait for all,
    kill any left on failure (`timeout` seconds at most; PARALLEL_TIMEOUT,
    or CLI_TIMEOUT in mode "cli"); returns each rank's results, or raises
    with their failures."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--dp_rank", mode, "--dp_dir", out_dir], env=env, cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.time() + (CLI_TIMEOUT if mode == "cli"
                              else PARALLEL_TIMEOUT)
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    out, bad = [], []
    timed_out = time.time() > deadline
    for r, (p, _) in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
            print(f"parallel {mode} rank {r}: {json.dumps(out[-1])}",
                  flush=True)
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                cut = " (killed at the time limit)" if timed_out else ""
                bad.append(f"rank {r} exited {p.returncode}{cut}:\n"
                           f"{f.read()[-3000:]}")
    if bad:
        raise AssertionError(f"parallel {mode}: " + "\n".join(bad))
    return out


def parallel_phase(kernels, parts: str = "abc") -> dict:
    """Data parallelism over torch.distributed at full width (`--only
    parallel`): (a) two ranks over gloo sharing this card, eager: a stage-1
    step (cfg/train_bert.yml: B 32, 16 a rank) and a stage-2 step
    (cfg/fusion_bert.yml: B 16) in host mode, bf16 and f32, each rank's
    gradients against one process's step on the same global batch and bits
    (`_dp_grad_check`), its launch counts against that step's (K9 on the
    global B 32), a planted gather whose backward sums over the ranks
    failing the check, one pair batch of 33 pairs within SCORE_TOL of one
    process, and the captured step refused under gloo; (b) one rank over
    NCCL: the stage-1 step captured with its collectives, bit for bit
    against eager steps after 3 and 6 steps, then the stage-1 entry point
    on that rank (`dp_cli`); (c) with two cards or more, two ranks over
    NCCL, a card each, captured stage-1 steps against one process and
    against eager steps bit for bit, the device-time split of a rank's
    step and of one process's, the reduction against two other designs,
    and the entry point on both ranks. Host and device ms per step of each
    rank (one shared card in (a): not a scaling result). `parts` picks
    some of a, b, c. Returns {path: (counts, counts per call)} of rank 0
    in (a), bf16 ({} without (a))."""
    import torch

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    base = os.path.join(ROOT, "checkpoints", "chip_smoke_parallel")
    paths = {}
    if "a" in parts:
        a = _launch_ranks("gloo", 2, os.path.join(base, "a"))
        ta = time.perf_counter() - t0
        for tag in ("stage1", "stage2", "pairs"):
            if a[0][tag]["counts"] != a[1][tag]["counts"]:
                raise AssertionError(f"parallel (a) {tag}: ranks launch "
                                     f"{a[0][tag]['counts']} and "
                                     f"{a[1][tag]['counts']}")
        words = {tuple(s) for r in a for s in r["stage1"]["damsm_words"]}
        if len(words) != 1 or next(iter(words))[0] != 32:
            raise AssertionError(f"parallel (a): K9 took words {words}, not "
                                 "the global batch of 32")
        print(f"parallel (a): two gloo ranks sharing one card "
              f"({card_line()}; not a scaling result), {ta:.1f} s; captured "
              f"step under gloo refused: {a[0]['captured_under_gloo']}",
              flush=True)
        paths = {f"parallel_{tag}": (a[0][k]["counts"], a[0][k]["counts"])
                 for tag, k in (("stage1_step", "stage1"),
                                ("stage2_step", "stage2"),
                                ("pair_batch", "pairs"))}
    if "b" in parts:
        t1 = time.perf_counter()
        b = _launch_ranks("nccl1", 1, os.path.join(base, "b"))[0]
        print(f"parallel (b) one rank over NCCL: captured against eager "
              f"{json.dumps(b['captured_vs_eager'])}, collectives issued in "
              f"the capture {b['collectives_in_capture']} (every call by "
              f"thread: {b['collectives']}), NCCL kernels in a replay "
              f"{b['nccl_kernels_in_a_replay']}, "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        t1 = time.perf_counter()
        line = _check_cli(_launch_ranks("cli", 1, os.path.join(base,
                                                               "b_cli")),
                          1, "b")
        print(f"parallel (b): {line} ({time.perf_counter() - t1:.1f} s "
              "with the process start)", flush=True)
    if "c" in parts and cards >= 2:
        t2 = time.perf_counter()
        c = _launch_ranks("nccl2", 2, os.path.join(base, "c"))
        print(f"parallel (c): two NCCL ranks on two cards, captured against "
              f"eager {json.dumps(c[0]['captured_vs_eager'])}, collectives "
              f"issued in the capture {c[0]['collectives_in_capture']}, "
              f"{time.perf_counter() - t2:.1f} s", flush=True)
        for r in c:
            st = r["stage1"]
            print(f"parallel (c) rank {r['rank']} ({card_line()}): device "
                  f"split of a captured step at {st['rows']} rows "
                  f"{json.dumps(st.get('split'))}; one process at the "
                  f"global batch {json.dumps(st.get('split_one_process'))}; "
                  f"gradient reduction {json.dumps(st.get('reduction'))}",
                  flush=True)
        t2 = time.perf_counter()
        line = _check_cli(_launch_ranks("cli", 2, os.path.join(base,
                                                               "c_cli")),
                          2, "c")
        print(f"parallel (c): {line} ({time.perf_counter() - t2:.1f} s "
              "with the process start)", flush=True)
    elif "c" in parts:
        print(f"parallel (c) did not run: torch.cuda.device_count() is "
              f"{cards}; two ranks over NCCL need a card each", flush=True)
    print(f"parallel: whole phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def _serving_modules(args, dev) -> tuple:
    """(backbone, image head, fusion net, text encoder) of `args` on `dev`,
    random from manual_seed (the same weights on every device)."""
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    return (prep.prepare_backbone(args, dev),
            prep.prepare_image_head(args, dev),
            prep.prepare_fusion_net(args, dev),
            prep.prepare_text_encoder(args, dev)[0])


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "launches", "phases",
                                       "prng", "serving", "train",
                                       "stage2", "step", "damsm",
                                       "weights", "lstm", "options",
                                       "parallel", "archs"))
    ap.add_argument("--dp_rank", choices=("gloo", "nccl1", "nccl2", "cli"),
                    help=argparse.SUPPRESS)     # a rank of the parallel phase
    ap.add_argument("--dp_parts", default="abc",
                    help="the parts of the parallel phase to run: some of "
                         "a (gloo ranks sharing a card), b (one NCCL rank), "
                         "c (two NCCL ranks on two cards)")
    ap.add_argument("--dp_dir", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    only = ns.only
    sys.path.insert(0, ROOT)
    if ns.dp_rank == "cli":
        dp_cli(ns.dp_dir)
        return 0
    if ns.dp_rank:
        dp_rank(ns.dp_rank, ns.dp_dir)
        return 0
    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    # the sources and the measurement build of the tower kernels, all at once
    per_source = _cuda.build(
        ("layernorm", "ffn_block", "attn_block") if only == "launches"
        else ("damsm",) if only in ("damsm", "lstm")
        else ("layernorm", "damsm") if only == "archs"
        else ("layernorm", "ffn_block", "attn_block", "damsm")
        if only == "weights" else _cuda.SOURCES
        if only in ("step", "options", "parallel")
        else _cuda.SOURCES + tuple(_cuda.VARIANTS))
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})",
          flush=True)

    args = load_yaml(os.path.join(ROOT, "cfg", "test.yml")).replace(
        synthetic=True, fused_block="both", fused_ln=True,
        compute_dtype="bfloat16", batch_size=32, is_roc=False,
        checkpoints_path="", eval_table_mode=False)
    kernels = kernel_fns()

    if only == "phases":
        tower_phases(*_tower_inputs(args))
    if only == "launches":
        launches_phase(args)
    if only == "damsm":
        damsm_phase(args)
    rows = kernel_phase(args) if only in (None, "kernels") else []
    prng = prng_phase(args, kernels) if only in (None, "prng") else None
    rows += [] if prng is None else prng[2]
    serving = (slice_phase(args, kernels) if only in (None, "serving")
               else None)
    train = train_phase(kernels) if only in (None, "train") else None
    stage2 = stage2_phase(kernels) if only in (None, "stage2") else None
    if only in (None, "step"):
        step_phase(kernels)
    weights = (weights_phase(args, kernels) if only in (None, "weights")
               else None)
    lstm = lstm_phase(kernels) if only in (None, "lstm") else {}
    options = options_phase(kernels) if only in (None, "options") else {}
    parallel = (parallel_phase(kernels, ns.dp_parts)
                if only in (None, "parallel") else {})
    archs = archs_phase(kernels) if only in (None, "archs") else {}
    # every path was driven with the counts zeroed just before it and read
    # just after; each phase held its path to the expected count per kernel
    paths = (("launches_prng", "launches_per_prng_check", prng),
             ("launches_serving", "launches_per_pair_batch", serving),
             ("launches_train", "launches_per_train_step", train),
             ("launches_stage2", "launches_per_stage2_step", stage2),
             ("launches_weights", "launches_per_weights_pair_batch",
              weights),
             ("launches_lstm_serving", "launches_per_lstm_pair_batch",
              lstm.get("lstm_serving")),
             ("launches_lstm_train", "launches_per_lstm_step_use_pallas",
              lstm.get("lstm_train")),
             ("launches_lstm_stage2", "launches_per_lstm_stage2_step",
              lstm.get("lstm_stage2")),
             *((f"launches_{k}", f"launches_per_{k}_step", v)
               for k, v in options.items()),
             *((f"launches_{k}", f"launches_per_{k}", v)
               for k, v in parallel.items()),
             *((f"launches_{k}", f"launches_per_{k}", v)
               for k, v in archs.items()))
    for r in rows:
        for key, per_key, got in paths:
            if got is not None:
                r[key], r[per_key] = got[0][r["name"]], got[1][r["name"]]
        r["launches"] = sum(got[0][r["name"]] for _, _, got in paths
                            if got is not None)
        if only is None and r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on a driven "
                                 "path")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
