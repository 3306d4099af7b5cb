#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device  — the card's name, count and power limit (fails without CUDA);
  2. build   — nvcc builds every kernel source under src/repro_torch/csrc,
               one process per source, all started together;
  3. kernels — first the wgmma layout probe of the tensor-core kernels (one
               SS and one RS chain on exact {-1, 0, 1} matrices, d 32, 64
               and 128, equal to torch.matmul bit for bit; then the same
               chains on tiles densified from top-k codes in shared memory,
               also at d 80 (a 96-column tile) and 256 (two 128-column
               halves)) and the count of HGMMA instructions in the
               flash_attention, flash_sfa_tc and flash_sfa_tc_wide
               libraries (cuobjdump -sass; 0 fails); then
               each kernel against its
               plain PyTorch version on the card at
               the main paths' shapes (the training ones at bh 96 = batch
               8 x 12 heads, n 1024 and a ragged 1000, f32 and bf16), with
               the tolerance stated beside the check; kernel, plain and
               library-call device times (a torch.profiler trace;
               CUDA-event times per call beside them) and the bound (least
               time the card could take); then the rows this slice's
               models run at their own shapes (``phase_qwen3_llama_shapes``):
               rows 1, 3, 5, 6, 7 at qwen3-0.6b-sfa8's training shape (bh
               8 x 16, n 1024, d 128, k 8), rows 10-14 at its decode
               shape (8 slots, 16 query heads over 8 kv heads, d 128; row
               12 one slot, C 5), rows 2, 4, 8, 9 at llama3.2-3b's
               seam shape (24 heads, d 128, k 16, code width 32, m 3072;
               rows 8 and 9 on their tensor-core bodies at width 32),
               each an extra shape of its entry in the ``kernels`` line;
               then (``phase_moonshot_shapes``) rows 1, 3, 5 at
               moonshot-v1-16b-a3b's training shape (bh 8 x 16, n 1024, d
               128, k 16) and 10-14 at its decode shape (8 slots x 16
               heads, MHA), the shape "MS" of each row, and rows 2, 4, 5
               (compact2), 8 and 9 at its RoPE compact seam (x 8 x 1024 x
               2048, 16 heads, d 128, k 16, code width 32), the shape
               "MSs"; then
               (``phase_frontend_shapes``) the instantiations the frontend
               families add, on rtopk's warp body and FlashSFA's
               tensor-core bodies in bf16 (flash_sfa_tc_wide.cu), its
               CUDA-core bodies in f32, each against its plain version:
               rows 1, 3, 5 at hubert-xlarge's training shape (bh 8 x 16,
               n 1024, d = dv 80, k 16, bidirectional; row 3 causal too;
               row 5 in bf16 and f32 with every emit), rows 1, 3, 5 at
               paligemma-3b's prefill (8 heads, n 1024, d = dv 256, k 16;
               row 5 in f32 on the CUDA-core body's 32-row tiles too, every
               emit, timed as the shape "PG f32") and rows 10-14 at its
               decode step (8 slots
               x 8 query heads over 1 kv head, dv 256; run boundaries, a
               zero-length slot, the bit-equalities), the shapes "HB" and
               "PG" of each row, after the new instantiations' ptxas
               registers, spills and shared memory; then
               (``phase_wide_seam_shapes``) rows 2, 4, 8 and 9 at
               hubert-xlarge's compact seam (x 8 x 1024 x 1280, 16 + 16
               heads of 80, k 16, width 16, bidirectional) and
               paligemma-3b's (x 8 x 1024 x 2048, 8 + 1 heads of 256, k 16,
               RoPE, width 32, causal): bf16 on the tensor-core bodies of
               proj_rtopk_wide.cu, flash_sfa_tc_wide.cu (block skip) and
               code_grad_wide.cu, f32 on the CUDA-core ones, each against
               its plain version, the shapes "HBs" and "PGs", after those
               sources' ptxas registers, spills and shared memory; then
               (``phase_llama8b_deepseek_shapes``) rows 2, 4, 8 and 9 at
               llama3-8b's RoPE compact seam (x 8 x 1024 x 4096, 32 query
               heads over 8 kv heads of 128, k 16, width 32) and rows 1, 3
               and 5 at deepseek-7b's training shape (bh 8 x 32, n 1024, d
               128, k 16), the shapes "L8" and "D7";
  4. engine  — the serving main path at full width: gpt2-small-sfa8
               (12 layers, d_model 768, 12 heads of 64, SFA k=8, vocab
               50,257), bf16, random weights from a seed, through
               ``DecodeEngine`` (8 slots, max_len 2048), 8 requests with
               prompts of 64-1024 tokens and 32 greedy new tokens each;
               every kernel must have launched in this phase and no backend
               fallback may be recorded; then a separate traced window of 4
               decode steps gives the device's busy share;
  4b. paged  — (a) the same 8 requests through ``PagedDecodeEngine``
               (cuda, pages of 128, full residency, whole-prompt prefill):
               streams identical to DecodeEngine's, one paged decode launch
               per layer and tick; (b) 16 prompts of 64-1024 tokens, 64 new
               tokens each, chunked prefill of 256, a pool of a quarter of
               full residency: queueing and preemption must happen, every
               request gets its tokens, the free list is whole at the end;
  4c. speculative — ``SpeculativeDecodeEngine`` (draft_len 4, draft_k 2) on
               the same 8 requests: the launches of the paged decode and the
               multi-query verify kernel equal the prediction from ticks,
               live slots and layers; each stream equals the paged engine's
               or parts from it at a near-tie of the reference logits;
  4d. cuda_fm — the feature-major kernels through the slot and the paged
               engine on the same requests: launches as predicted, paged
               streams identical to the slot streams, the token-major
               streams equal or parted at a near-tie; then the serving
               launcher with ``--no-reduced --paged --speculative`` and
               ``--decode-backend cuda_fm --paged``;
  4e. qwen3  — qwen3-0.6b-sfa8 at full width and 7 of its 28 layers (d_model
               1024, 16 heads over 8 kv heads of 128, k 8, vocab 151,936),
               bf16, random weights from the seed: the same 8 requests
               through the slot engine (its KV cache at rest equal to
               ``cache_bytes_per_token``'s byte model, a traced window of 4
               decode steps), the paged engine at full residency (streams
               identical) and the cuda_fm engines (the near-tie rule);
  4f. moonshot — moonshot-v1-16b-a3b (MoE: 64 routed experts top-6 of
               width 1,408 + 2 shared, d_model 2048, 16 heads of 128, k 16,
               vocab 163,840) at full width and 12 of its 48 layers (1
               dense + 11 MoE; the depth cut: 28.37 B f32 parameters do not
               fit), bf16: the slot engine (decode launches = layers x
               steps, the KV cache at rest = the byte model, the experts'
               f32 -> bf16 cast timed a layer), the paged engine (streams
               identical), the speculative engine (rows 11 and 12 as
               predicted, streams by the near-tie rule) and cuda_fm;
  4g. paligemma — paligemma-3b (vlm: 18 layers, d_model 2048, 8 query
               heads over 1 kv head of 256, k 16, vocab 257,216) at full
               width and 6 of its layers, bf16: the slot engine with 256 seeded
               patches in front of each prompt (``extra_inputs``; the KV
               cache at rest = the byte model), then the same prompts
               text-only, to which the paged (full residency), speculative
               and cuda_fm engines' streams are held; rtopk on its warp body
               (d 256) throughout;
  4h. llama3-8b, deepseek-7b — llama3-8b (32 layers, d_model 4096, 32
               query heads over 8 kv heads of 128, k 16, RoPE theta
               500,000, vocab 128,256, untied) at full width and
               ``LLAMA8B_SERVE_LAYERS`` of its layers, bf16: the slot,
               paged (full residency), speculative and cuda_fm engines on
               the same 8 requests, launches as predicted; deepseek-7b (30
               layers, d_model 4096, MHA 32 of 128, k 16, vocab 102,400,
               untied) at full width and depth through the slot engine;
  5. end to end — gpt2-small-sfa8 in float32, prefill logits and 8
               teacher-forced decode steps through the "cuda" (kernels) and
               "torch" (plain) backends, held to a stated tolerance with the
               argmax equal at every step; then qwen3-0.6b-sfa8 the same way
               at full width and 4 of its 28 layers, moonshot at 2 of
               its 48 layers on f32 caches, and paligemma at 2 of its 18
               layers with the patch prefix on f32 caches (tolerance 1e-4),
               and llama3-8b at 2 of its 32 layers on f32 caches
               (tolerance 1e-4);
  6. train   — the training main path at full width: gpt2-small-sfa8 in
               bf16 through ``Trainer`` (AdamW, remat="full", Markov data),
               batch 8 x seq 1024, 1 warm-up and 5 timed steps; step ms,
               tokens/s, peak memory; losses finite, no backend fallback,
               and the launches of rtopk, flash_sfa and flash_sfa_bwd equal
               to the count predicted from the layer count; then one traced
               step gives the device's busy share;
  7. dense train — the dense baseline gpt2-small the same way (1 warm-up,
               2 timed steps), through flash_attention and its backward;
  8. compact train — the compact code-gradient seam at full width:
               gpt2-small-sfa8, bf16, batch 8 x seq 1024, through
               ``Trainer`` under TrainPolicy(bwd_emit="compact",
               fwd_fuse=True, remat="codes"), 1 warm-up and 5 timed steps;
               the launches of proj_rtopk, block-skip flash_sfa, the
               compact flash_sfa_bwd and code_grad_dx/dw equal to the
               prediction (and no rtopk or plain-schedule flash_sfa), every
               proj_rtopk, code_grad_dx and code_grad_dw on its tensor-core
               body, no fallback, the seam taken on every layer, "codes"
               applied;
               then the launcher ``python -m repro_torch.launch.train
               --no-reduced --bwd-emit compact --remat codes`` for 2 steps;
  8c. checkpoint — gpt2-small-sfa8 at full width and 6 of 12 layers
               (``CKPT_LAYERS``; batch 8 x 1024, bf16,
               remat full, dense emit, cuda) through ``Trainer.train``
               under the Supervisor: run A checkpoints every 2 steps and
               takes an injected fault before step 3 (restore of step 2,
               replay), run B none; one restart, A equal to B bit for bit
               (metrics, parameters, m, v), the launches of the 13 steps
               as predicted, ``elastic_remesh`` onto CPU tensors equal to
               the card's state, no fallback in ``collect_reports()``; the
               checkpoint's bytes, the save's blocking ms, the writer's and
               restore's seconds, step ms with and without a write in
               flight, the straggler events;
  8b. qwen3 train — qwen3-0.6b-sfa8 (dense emit, remat "full"; then a
               compact request, which qk-norm sends off the seam: the report
               says why and the op-level compact emit runs) and the dense
               qwen3-0.6b, full width and depth, batch 8 x 1024, bf16;
               llama3.2-3b at full width and 4 of 28 layers through the RoPE
               compact seam (compact2, remat "codes"; code width 32, code_grad
               dx and dW on their tensor-core bodies, no CUDA-core body);
               moonshot at full width and 4 of 48 layers (dense emit, remat
               "full"; then through the RoPE compact seam, compact2, remat
               "codes", launches as llama's, no CUDA-core body);
               hubert-xlarge (audio,
               bidirectional, d 80) at full width and depth through
               ``make_train_step`` on seeded frame batches of 8 x 1024
               (``phase_train_frames``: rtopk on its warp body, FlashSFA
               forward and backward on the tensor-core bodies, launches as
               predicted; then through the compact seam, remat "codes",
               launches as llama's, no CUDA-core body, collect_reports()
               saying the seam was taken); paligemma-3b (d 256, 8 query
               heads over 1 kv head) at full width and 6 of 18 layers
               through ``Trainer`` on text batches of 8 x 1024 (dense emit,
               remat "full", FlashSFA on the tensor-core bodies, rtopk on
               its warp body; then through the RoPE compact seam, compact2,
               remat "codes"), each seam run's step, peak memory and busy
               share printed beside its dense-emit run's; llama3-8b at 4
               of 32 layers through the RoPE compact seam (compact2, remat
               "codes", launches as llama3.2-3b's); deepseek-7b at 4 of 30
               layers (dense emit, remat "full"); gpt2-small-sfa8 at full
               width and depth with sfa_distill 0.1 (paper Eq. 8: the
               aux term positive at every step; the teacher plain chunked
               attention), dense emit, then a compact request, which the
               seam declines with the reference's reason (collect_reports());
               each train phase prints its step FLOPs
               (``utils.analytic.step_flops``) and their share of the bf16
               peak;
  9. gradients end to end — float32 gpt2-small-sfa8 at full width, batch 1
               x seq 512: the loss and every parameter gradient through the
               "cuda" backend, dense emit with remat="full" and the compact
               seam with remat="codes", against the "torch" oracle
               (remat="none"), to a stated tolerance; then the dense
               gpt2-small in bf16 the same way, through the tensor-core
               flash_attention and its backward; then gpt2-small-sfa8 in
               bf16 (dense emit, remat="full"; compact seam,
               remat="codes") through the tensor-core FlashSFA bodies,
               held to the torch backend's own bf16 distance from float32;
               then qwen3-0.6b-sfa8 (dense emit) and moonshot (dense emit,
               then the compact seam: code width 32 on code_grad's
               tensor-core bodies) at full width and 2 layers in bf16 by the
               same rule, and llama3.2-3b at full width and 2
               layers in float32 through the compact seam against the torch
               backend (1e-4 on the loss, 1e-3 relative L2 a leaf); then
               hubert-xlarge at 2 layers on frames: bf16 by the rule above
               (the tensor-core bodies at d 80; dense emit and the compact
               seam), float32 (the CUDA-core bodies) with 1e-4 on the loss
               and on each leaf's relative L2 (its learned positions are
               never read: a zero gradient in both runs), and its float32
               compact seam (1e-4 on the loss, 1e-3 a leaf); paligemma-3b
               at 2 layers in bf16 by the same rule (the tensor-core bodies
               at d 256; dense emit and the compact seam), then in float32
               (the CUDA-core backward at dv 256; dense emit and the
               compact2 seam under remat "codes"), and gpt2-small-sfa8 at 2
               layers in float32 with sfa_distill 0.1 (loss, aux and every
               leaf); every cuda run's launches as predicted a layer and no
               fallback recorded;
 11. attention variants — the layers the reference's Pallas backends
               decline (windows, protected RoPE dims, MLA), which run on the
               torch backend in the port (no kernel lies on these paths:
               every launch count stays 0, and with "cuda" requested every
               fallback report names torch and the one reason): (a)
               gemma3-4b (34 layers, d_model 2560, 8 query heads over 4 kv
               heads of 256, k 16, window 1,024 with every 6th layer global,
               vocab 262,144) at full width and 6 of 34 layers (layer 5
               global), bf16, through the
               slot engine (one prompt of 1,536 tokens, past the window; the
               KV cache at rest = the byte model), the paged engine (whole
               prompts; then chunked prefill of 256) and the speculative
               engine, streams equal to the slot streams or parted at a
               near-tie; float32 at 2 layers,
               the card against the port on the CPU (f32 caches, 1e-4,
               argmax equal); (b) gemma3-4b trained at 6 of 34 layers
               (batch 8 x 1024, bf16, AdamW, remat "full", 1 warm-up and 2
               timed steps), and its float32 gradients at 1 layer, the card
               against the CPU (1e-4 on the loss and each leaf's relative
               L2; bf16 finite); (c) deepseek-v2-236b (MLA r 512 + 64, 128
               heads, k 16 on the latent; MoE 160 experts top-6 + 2 shared)
               at full width and 3 of 60 layers through the slot and paged
               engines (chunked prefill and the speculative engine must
               raise the reference's NotImplementedError), float32 at 2
               layers against the CPU; (d) llama3.2-3b with sfa_rope_protect
               64 at full width and 4 of 28 layers through the slot, chunked
               paged and speculative engines, one dense-emit train step and
               a compact request, which the seam declines with the
               reference's reason;
 12. recurrent families (``phase_recurrent``) — (a) rows 1, 3, 10 and 13
               at jamba-v0.1-52b's attention shape (32 query heads over 8 kv
               heads of 128, k 16): row 1 at its prefill (32,768 rows) and
               decode step (256 rows), row 3 at bh 32 x 1024 causal, rows
               10 and 13 at 8 slots, n_max 2,048, the shapes "JB" / "JB
               decode" of each row; (b) jamba at full width and one
               super-block (8 of 32 layers: Mamba, attention at index 4,
               MoE 16 experts top-2 on every second sublayer; 13.3 B f32
               parameters), bf16, through the slot engine on the cuda and
               the cuda_fm decode backend (8 requests of 64-1024 tokens, 32
               greedy tokens each; launches per attention layer as
               predicted; the KV at rest = the byte model's per-layer bytes
               x the one attention layer; the recurrent state apart; the
               experts' cast timed), the two streams equal or parted at a
               near-tie, the paged and speculative engines refused with the
               reference's message, float32 cuda against torch on f32
               caches (1e-4, argmax equal); (c) rwkv6-3b (32 layers, d_model
               2560, attention-free: no kernel, no KV) at full width and
               ``RWKV_LAYERS`` of its layers through the slot engine, the
               refusals, float32 the card against the port on the CPU
               (logits on f32 caches at 2 layers and every gradient at 1,
               1e-4), and trained at full width and ``RWKV_LAYERS`` layers
               (batch 8 x 1024, bf16, AdamW, remat "full");
 14. distribution (``phase_distributed``) — rows 3 and 5 at the ring's hop
               shape (one rank's shard on the ring of 4: bh 24, 1,024 x
               1,024, d 64, k 8, non-causal; row 5's compact emit), the
               shape "RING" of each row; then 4 ranks on the one card
               (``launch.mesh.spawn``, gloo; the ring's hops through pinned
               host memory: gloo's send refuses device memory) on three
               meshes, the state sharded by the launcher's specs
               (``launch.specs.param_specs``): (a)
               a ring of 4 (``make_debug_mesh(seq=4)``, nothing split):
               full-width
               gpt2-small-sfa8 at global batch 2 x 4,096, bf16, remat full,
               its gradients and 2 steps' losses held to one process by
               phase 9's bf16 rule, each rank's ring bytes equal to the
               byte model and its launches of rows 1, 3 and 5 to the
               prediction, a 2-layer f32 model at 1e-4, the code-level
               ``ring_sfa`` against flash_sfa + its compact backward
               (random and banded codes, f32 at 1e-4; bf16); (b) TP 2 x DP 2
               through the compact seam at 8 x 1,024 (rows 2, 4, 5, 8, 9 on
               each rank's 6 heads), 637,843,968 B of state a rank, a
               sharded checkpoint byte for byte the replicated one; (c) DP 4
               with top-5% gradient compression, a 2-layer f32 model,
               against one process; the state bytes a rank equal to the
               specs' and the bytes a rank by collective to their
               prediction on (b) and (c); replicas equal, ms per step per
               rank, peak memory per mesh;
 15. a ``kernels`` JSON line, then the result line.

Phase 3 holds row 1 (rtopk, d 64, k 8, bf16 and f32, tie-heavy rows) at
the three shapes of its main paths: a decode step's 96 rows, a prefill's
12,288 and a training step's 98,304, on its one-thread body, with the warp
body at k 24 and d 256 beside. The serving phases and the dense-emit
train phase must run rtopk on its one-thread body only (``rtopk_warp`` 0).
``tools/rtopk_sweep.py`` times the same shapes for design sweeps and A/B
calls against another tree.

Phase 3 also holds the dense attention's bf16 tensor-core bodies at d 32,
64 and 128, causal and not, at n 1000, and two bf16 backward calls on the
same inputs to be equal bit for bit. The FlashSFA rows (3-5) run bf16 on
their tensor-core bodies (codes densified in shared memory) and f32 on the
CUDA-core ones: both are held against the plain versions, the tensor-core
bodies also at d 32 and 128, causal and not, ragged n (the backward with
every emit, the compact emit equal to the dense one gathered, two calls
equal bit for bit). Phases 6, 8 and 9's bf16 gpt2-small-sfa8 runs, and
phase 8b's llama and moonshot seam runs and phase 9's bf16 moonshot seam
run (code width 32), and hubert's and paligemma's seam runs (d 80 and 256)
must launch no CUDA-core body (proj_rtopk, FlashSFA, code_grad_dx,
code_grad_dw); hubert's and paligemma's bf16 training phases no CUDA-core
FlashSFA body.

Phase 3 also holds the paged, multi-query and feature-major decode
kernels (rows 11-14) at the serving path's shapes: 8 slots x 12 heads of
64, k 8, pages of 128, up to 2048 tokens a slot, bf16 and f32, a shuffled
non-monotone block table and one slot at the past-the-table sentinel; the
paged kernel must equal flash_sfa_decode on the gathered view bit for bit,
each verify row the paged kernel at its length, and the paged
feature-major kernel the contiguous one on the gathered image. Rows 10-14
(the token-major and the feature-major decode, each split over the keys in
runs of 128 positions) are also held at lengths on and around a run
boundary with a zero-length row, which must give 0: against the plain
versions and for their bit-equalities (row 10 also against itself in the
folded layout and on a second call). Each timed row names the kernels one
call launches (a decode's split and merge kernels), and phase 4 prints the
decode kernels' device ms per traced step.

Phase 3 also holds the compact seam's kernels at the training path's
shapes: proj_rtopk (x 8 x 1024 x 768, 12 heads of 64, k 8; bf16 on its
tensor-core body, f32 on the CUDA-core one) on dyadic inputs (every sum
exact: indices equal, values bit-equal), f32 and bf16 with and without
RoPE at full width, bf16 also with w read in place and packed, at d 32 and
128, ragged n, m 200 and 3 heads, k 8, 16 and 24; and in bf16 and f32 on
random inputs (rows whose index sets differ must have a near-tie; with
RoPE the codes bit-equal to RoPE and selection of the kernel's own y,
which is within one ulp of the plain y), timed beside bf16 w in place and
the CUDA-core body on the same bf16 inputs; code_grad_dx/dw (12 heads x
8,192 tokens, k 8, the 2k pair closure and code width 32 at d 64 and 128;
bf16 codes on the tensor-core bodies, also against the CUDA-core bodies on
the same inputs, bit-equal to the plain version on inputs whose sums are
exact at d 32, 64 and 128 and widths 8, 16 and 32, dx
with an f32 w in multiples of 1/16 or 2^-12 and a bf16 w, and dW with one
token split, which must agree and is timed beside the default; the
tensor-core kernels' ptxas registers and spills); block-skip flash_sfa on the training
path's codes and on a planted banded input (tile t on features 8(t mod 8)
.. +7) that sends most tile pairs down the closed form, with
``block_skip_stats`` of both; the compact and compact2 backward emits
against their plain versions and against the dense emit gathered at the
stored indices.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the
# port's one source, utils/roofline.py
from repro_torch.utils.roofline import H100_SXM_BF16_FLOPS as BF16_TC_FLOPS  # noqa: E402
from repro_torch.utils.roofline import H100_SXM_F32_FLOPS as F32_FLOPS  # noqa: E402
from repro_torch.utils.roofline import H100_SXM_HBM_BW as HBM_BYTES_PER_S  # noqa: E402

SEED = 0


def event_ms(fn, iters=50, warmup=5):
    """Mean ms per call of fn() between CUDA events over ``iters``
    back-to-back calls: the device time, or the host's time per call where
    the host issues work slower than the device runs it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def short_name(kernel):
    """A traced kernel's name without its return type, namespace and
    parameter list."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:72]


def device_ms(fn, iters=20, attempts=3, per_kernel=None):
    """Mean device time per call of fn() in ms: the CUDA kernels' own time,
    summed from a torch.profiler trace of ``iters`` calls (host overhead
    between launches excluded). fn() launches the same kernels on every
    call, so a whole trace holds each kernel a multiple of ``iters`` times;
    one that does not (the profiler lost events) or has no device events
    is taken again, up to ``attempts`` times; None if none was whole.
    ``per_kernel``, if given, receives {kernel: ms per call} of the trace
    taken."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        counts = {}
        kernels, _ = trace_kernels(lambda: [fn() for _ in range(iters)], counts)
        total_us = sum(kernels.values())
        if total_us > 0 and all(c % iters == 0 for c in counts.values()):
            if per_kernel is not None:
                per_kernel.update({short_name(n): us / 1e3 / iters for n, us in kernels.items()})
            return total_us / 1e3 / iters
        print(f"[timing] retake: traced launches per kernel {sorted(counts.values())} "
              f"over {iters} calls")
    return None


def trace_kernels(fn, counts=None):
    """Run fn() under torch.profiler (CUDA activity only) and return
    ({kernel name: summed device us}, host wall ms); ``counts``, if given,
    receives {kernel name: launches traced}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    # the raw events: parsing them into ``prof.events()`` costs ~0.1 ms an
    # event, tens of seconds for an rwkv training step's ~300,000 launches
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            kernels[name] = kernels.get(name, 0.0) + e.duration_ns() / 1e3
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1
    return kernels, wall_ms


def timings(kernel, plain, library):
    """ms / plain_ms / library_ms as device time (profiler), and the CUDA
    event time per call beside each; ``timing`` says which "ms" holds, and
    ``kernels_ms`` names each kernel one call of ``kernel`` launches."""
    out = {"kernels_ms": {}}
    for key, fn, iters in (("ms", kernel, 50), ("plain_ms", plain, 10),
                           ("library_ms", library, 50)):
        out[key.replace("ms", "call_ms")] = event_ms(fn, iters=iters)
        out[key] = device_ms(fn, iters=min(iters, 20),
                             per_kernel=out["kernels_ms"] if key == "ms" else None)
    replayed = [k for k in ("ms", "plain_ms", "library_ms") if out[k] is None]
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        if out[key] is None and getattr(fn, "graph_ok", True):
            out[key] = graph_ms(fn)
    missing = [k for k in ("ms", "plain_ms", "library_ms") if out[k] is None]
    if missing:
        out.update(ms=out["call_ms"], plain_ms=out["plain_call_ms"],
                   library_ms=out["library_call_ms"],
                   timing=f"cuda events: no device events traced for {', '.join(missing)}")
    elif replayed:
        out["timing"] = (f"profiler device time; CUDA-graph replay for {', '.join(replayed)}, "
                         f"whose traces lost events")
    else:
        out["timing"] = "profiler device time"
    return out


def graph_ms(fn, iters=20, replays=5):
    """Device ms per call of fn(): ``iters`` calls captured in a CUDA graph
    and replayed between CUDA events, so no host time sits between the
    launches. None where fn() cannot be captured: a host synchronization
    inside it, found by a warm-up call under the sync debug mode before any
    capture starts (a capture that fails part-way leaves the caching
    allocator unable to hand memory back, so ``torch.cuda.empty_cache``
    frees nothing for the rest of the run). A callable with ``graph_ok =
    False`` is never captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    mode = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.cuda.stream(side):
            fn()
    except RuntimeError as err:
        torch.cuda.synchronize()
        print(f"[timing] no CUDA graph (fn synchronizes): {str(err).splitlines()[0][:100]}")
        return None
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (replays * iters)
    except Exception as err:  # noqa: BLE001 - any capture failure means "not capturable"
        torch.cuda.synchronize()
        print(f"[timing] no CUDA graph: {str(err).splitlines()[0][:120]}")
        return None


def kernel_ms(fn):
    """Device ms per call of fn(): the profiler's, else a CUDA-graph replay's
    (both without host time), else CUDA events around the calls."""
    return device_ms(fn) or graph_ms(fn) or event_ms(fn)


def fmt(r):
    names = "; ".join(f"{n} {ms:.4f}" for n, ms in r.get("kernels_ms", {}).items())
    return (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms ({r['timing']}; per call with host: "
            f"{r['call_ms']:.4f} / {r['plain_call_ms']:.4f} / "
            f"{r['library_call_ms']:.4f} ms), bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); kernels per call (ms): {names or 'not traced'}")


def bound(bytes_moved, op_seconds):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    byte_s = bytes_moved / HBM_BYTES_PER_S
    if byte_s >= op_seconds:
        return byte_s * 1e3, "bytes"
    return op_seconds * 1e3, "operations"


def code_product_s(k_flops, d_flops):
    """Least seconds of a product over top-k codes: the lesser of its
    gathered form (k-wide, CUDA cores at the f32 rate) and its densified
    form (d-wide, bf16 tensor cores), the same function either way."""
    return min(k_flops / F32_FLOPS, d_flops / BF16_TC_FLOPS)


def timed(fn, *args, **kwargs):
    """fn(*args, **kwargs), then a line with its wall seconds and the
    card's memory after it (in use on the device, and this process's
    allocated and cached tensors), so a slow or swollen run shows which
    phase took the time or the memory."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    free, total = torch.cuda.mem_get_info()
    print(f"[time] {fn.__name__} {time.perf_counter() - t:.1f} s; device memory in use "
          f"{(total - free) / 2**30:.2f} GiB (allocated {torch.cuda.memory_allocated() / 2**30:.2f},"
          f" reserved {torch.cuda.memory_reserved() / 2**30:.2f})", flush=True)
    return out


def release():
    """Free what earlier phases left on the card: collect reference cycles,
    then hand the allocator's cached blocks back to CUDA (a launcher
    phase's subprocess allocates beside this process)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phase 1-2
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {name} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi.splitlines()[0])
    return name, count


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 ")]
        wall = [line for line in log.splitlines() if line.startswith("nvcc wall")]
        print(f"[build] {name}: {wall[-1] if wall else 'built earlier'}; {len(regs)} kernels, "
              f"registers max {max(regs, default=0)}, spills: {spills or 'none'}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def phase_wgmma_probe():
    """The tensor-core kernels' layouts, before any attention check: for d
    in (32, 64, 128), one SS wgmma chain S = A·Bᵀ and one RS chain O =
    bf16(S)·C fed from S's accumulator registers, on (64, d) tiles that TMA
    loads as the attention kernels load theirs. Entries are in {-1, 0, 1},
    so every product and sum is exact: S and O must equal torch.matmul in
    f32 bit for bit; then the same chains on tiles densified from codes, at
    the FlashSFA tensor-core bodies' widths (80 in a 96-column tile, 256 in
    two 128-column halves of O). Then the count of HGMMA instructions that
    cuobjdump finds in the tensor-core libraries: 0, or no cuobjdump,
    fails."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_sfa import TC_DIMS, tc_library
    rs = np.random.RandomState(SEED + 5)
    fn = _build.entry("flash_attention", "wgmma_probe_launch",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    for d in (32, 64, 128):
        a, b, c = (torch.from_numpy(rs.randint(-1, 2, (64, d)).astype(np.float32))
                   .cuda().bfloat16() for _ in range(3))
        s_out = torch.empty(64, 64, device="cuda")
        o_out = torch.empty(64, d, device="cuda")
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), s_out.data_ptr(), o_out.data_ptr(),
                 d, _build.stream_ptr(a))
        _build.check("flash_attention", err, "wgmma probe launch")
        torch.cuda.synchronize()
        s_want = a.float() @ b.float().T
        o_want = s_want.bfloat16().float() @ c.float()
        for name, got, want in (("SS A.B^T", s_out, s_want), ("RS bf16(S).C", o_out, o_want)):
            bad = (got != want).nonzero()
            if bad.numel():
                at = tuple(bad[0].tolist())
                raise AssertionError(f"wgmma probe d={d} {name}: {bad.shape[0]} entries differ, "
                                     f"first at {at}: got {got[at].item()}, want "
                                     f"{want[at].item()}")
        print(f"[probe] d={d}: SS S = A.B^T (K-major A and B) and RS O = bf16(S).C (A from the "
              f"S accumulator, C MN-major) equal torch.matmul in f32 exactly")
    # the same chains on tiles densified from top-k codes into shared memory
    # (the FlashSFA tensor-core bodies' layout): A, B, C from codes with
    # values in {-1, 1} at distinct indices, one row of each with a
    # duplicated index (the densify sums it), one all-padding row
    k = 8
    for d in TC_DIMS:
        probe = _build.entry(tc_library(d), "densify_probe_launch",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                             + [ctypes.c_int, ctypes.c_void_p])
        idx = np.stack([np.sort(rs.permutation(d)[:k]) for _ in range(3 * 64)]).reshape(3, 64, k)
        vals = rs.choice([-1.0, 1.0], size=(3, 64, k)).astype(np.float32)
        idx[:, 5, 1] = idx[:, 5, 0]
        idx[:, 9], vals[:, 9] = 0, 0.0
        vals_t = torch.from_numpy(vals).cuda().bfloat16()
        idx_t = torch.from_numpy(idx.astype(np.int32)).cuda()
        packed = torch.empty(3 * 64 * k, dtype=torch.int32, device="cuda")
        s_out = torch.empty(64, 64, device="cuda")
        o_out = torch.empty(64, d, device="cuda")
        err = probe(vals_t.data_ptr(), idx_t.data_ptr(), packed.data_ptr(), k, s_out.data_ptr(),
                    o_out.data_ptr(), d, _build.stream_ptr(vals_t))
        _build.check(tc_library(d), err, "densify probe launch")
        torch.cuda.synchronize()
        dense = torch.zeros(3, 64, d, device="cuda").scatter_add_(-1, idx_t.long(),
                                                                  vals_t.float())
        s_want = dense[0] @ dense[1].T
        o_want = s_want.bfloat16().float() @ dense[2]
        for name, got, want in (("SS A.B^T", s_out, s_want), ("RS bf16(S).C", o_out, o_want)):
            bad = (got != want).nonzero()
            if bad.numel():
                at = tuple(bad[0].tolist())
                raise AssertionError(f"densify probe d={d} {name}: {bad.shape[0]} entries "
                                     f"differ, first at {at}: got {got[at].item()}, want "
                                     f"{want[at].item()}")
        print(f"[probe] d={d}: the same chains on tiles densified from k={k} codes in shared "
              f"memory equal torch.matmul on the densified matrices exactly")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"cuobjdump not found beside nvcc ({cuobjdump})")
    for lib in ("flash_attention", "flash_sfa_tc", "flash_sfa_tc_wide"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        check(hgmma > 0, f"cuobjdump -sass finds no HGMMA in the {lib} library")
        print(f"[probe] cuobjdump -sass: {hgmma} HGMMA instructions in the {lib} library")


def _tie_rows(rs, rows, d):
    x = rs.randn(rows, d).astype(np.float32)
    x[::3, 1] = -x[::3, 0]                    # equal magnitudes, both signs
    x[1::3, 4:12] = x[1::3, 3:4]              # a block of equal values
    x[2::7, :] = np.round(x[2::7, :])         # many ties at the threshold
    return x


# row 1's shapes on its main paths (d 64, k 8): a decode step's q or k (8
# slots x 12 heads), one 1024-token prefill's (12 heads), a training step's
# (batch 8 x 12 heads x 1024 tokens)
RTOPK_SHAPES = (("decode", 8 * 12), ("prefill", 1024 * 12), ("training", 8 * 12 * 1024))


def _rtopk_exact(x, k, kv, ki, what):
    """rtopk's codes against rtopk_ref's: indices equal, values bit-equal
    (tolerance: none). Returns max |error| (0)."""
    from repro_torch.kernels.ref import rtopk_ref
    pv, pi = rtopk_ref(x, k)
    torch.cuda.synchronize()
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    check(torch.equal(ki, pi), f"rtopk {what}: indices differ")
    check(torch.equal(kv.view(bits), pv.view(bits)), f"rtopk {what}: values not bit-equal")
    return (kv.float() - pv.float()).abs().max().item()


def rtopk_shapes(rs, own):
    """rtopk at RTOPK_SHAPES, d 64, k 8, f32 and bf16, on tie-heavy rows
    (the prefill rows from ``rs``, the others from ``own``): the codes equal
    rtopk_ref's, and kernel, plain and library (torch.topk + sort) times and
    the byte bound at each shape. Returns ({(shape, dtype): timings},
    [max |error|]). ``tools/rtopk_sweep.py`` also runs it on another tree's
    port, which may lack the body counter."""
    from repro_torch.kernels import body_counts, reset_launches, rtopk
    from repro_torch.kernels.ref import rtopk_ref
    d, k = 64, 8
    res, errs = {}, []
    for shape, rows in RTOPK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(_tie_rows(rs if shape == "prefill" else own, rows, d)
                                 ).cuda().to(dtype)
            reset_launches()
            kv, ki = rtopk(x, k)
            check(body_counts().get("rtopk_warp", 0) == 0,
                  f"rtopk {shape} {dtype}: not the one-thread body {body_counts()}")
            errs.append(_rtopk_exact(x, k, kv, ki, f"{shape} {dtype}"))

            def library(x=x):
                _, i = torch.topk(x.abs(), k, dim=-1)
                i, _ = torch.sort(i, dim=-1)
                return x.gather(-1, i), i

            es = x.element_size()
            b_ms, b_by = bound(rows * d * es + rows * k * (es + 4),
                               rows * d / F32_FLOPS)   # about d compares a row
            r = dict(bound_ms=b_ms, bound_by=b_by,
                     **timings(lambda x=x: rtopk(x, k), lambda x=x: rtopk_ref(x, k), library))
            print(f"[rtopk] {shape} {dtype} rows={rows} d={d} k={k}: indices equal, values "
                  f"bit-equal; library = topk+sort; {fmt(r)}")
            res[(shape, dtype)] = r
    return res, errs


def phase_rtopk(rs):
    """Row 1: ``rtopk_shapes`` on the one-thread body (rtopk_warp stays 0);
    then the warp body (k 24 at d 64; d 256) held the same way. The
    prefill rows come from ``rs``, so later phases draw what they drew when
    row 1 ran at one shape; the others from a random state of their own."""
    from repro_torch.kernels import body_counts, reset_launches, rtopk
    own = np.random.RandomState(SEED + 20)
    res, errs = rtopk_shapes(rs, own)
    # the warp body: k > 16, and a width without a one-thread instantiation
    for d_, k_ in ((64, 24), (256, 16)):
        x = torch.from_numpy(_tie_rows(own, 1024 * 12, d_)).cuda().bfloat16()
        reset_launches()
        kv, ki = rtopk(x, k_)
        check(body_counts()["rtopk_warp"] == 1, f"rtopk d={d_} k={k_}: {body_counts()}")
        errs.append(_rtopk_exact(x, k_, kv, ki, f"warp body d={d_} k={k_}"))
        print(f"[rtopk] warp body, bf16 rows={x.shape[0]} d={d_} k={k_}: indices equal, "
              f"values bit-equal; kernel {kernel_ms(lambda x=x: rtopk(x, k_)):.4f} ms")
    out = dict(res[("prefill", torch.bfloat16)], max_abs_err=max(errs))
    out["shapes"] = {f"{shape} {str(dt).split('.')[-1]}": {
        key: r[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        for (shape, dt), r in res.items()}
    return out


def _densify(vals, idx, d):
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=vals.dtype, device=vals.device)
    return out.scatter_(-1, idx.long(), vals)


def _tc_only(what):
    """Check that no CUDA-core body (proj_rtopk, FlashSFA forward or
    backward, code_grad_dx or code_grad_dw) and no rtopk warp body
    launched since the last reset."""
    from repro_torch.kernels import body_counts
    counts = body_counts()
    check(not any(counts.values()), f"{what}: a CUDA-core body launched: {counts}")


def _codes_of(rs, bh, n, d, k, dtype):
    from repro_torch.kernels import rtopk
    q, kk = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().to(dtype)
             for _ in range(2))
    return (*rtopk(q, k), *rtopk(kk, k))


def phase_flash_sfa(rs):
    """Row 3 (block_skip=False) at the serving shape bh 12: bf16 runs the
    tensor-core body, f32 the CUDA-core body; the tensor-core body also at
    d 32 and 128, causal and not, ragged n."""
    from repro_torch.kernels import body_counts, flash_sfa, reset_launches
    from repro_torch.kernels.ref import flash_sfa_ref
    bh, d, k, dv = 12, 64, 8, 64
    res = {}
    for n in (1024, 1000):
        reset_launches()
        qv, qi, kv, ki = _codes_of(rs, bh, n, d, k, torch.bfloat16)
        v = torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().bfloat16()
        scale = d ** -0.5
        ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True)
        po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale,
                               return_residuals=True)
        torch.cuda.synchronize()
        _tc_only(f"flash_sfa bf16 n={n}")
        # tolerance: both accumulate in f32 and round to bf16, so outputs
        # may differ by one bf16 ulp (2^-7 relative); the f32 LSE by 1e-4
        err = (ko.float() - po.float()).abs().max().item()
        torch.testing.assert_close(ko.float(), po.float(), rtol=2 ** -7, atol=1e-5)
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
        lse_err = (kl - pl).abs().max().item()
        qd = _densify(qv, qi, d)[None]
        kd = _densify(kv, ki, d)[None]
        vb = v[None]
        pairs = bh * n * (n + 1) // 2
        es = 2
        b_ms, b_by = bound(2 * bh * n * k * (es + 4) + 2 * bh * n * dv * es + bh * n * 4,
                           code_product_s(2 * k * pairs, 2 * d * pairs)
                           + 2 * dv * pairs / BF16_TC_FLOPS)
        r = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(
            lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True),
            lambda: flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale,
                                  return_residuals=True),
            lambda: F.scaled_dot_product_attention(qd, kd, vb, is_causal=True,
                                                   scale=scale)))
        print(f"[flash_sfa] bh={bh} n={n} k={k} dv={dv} bf16 (tensor-core body): max|err| "
              f"{err:.3g} (lse {lse_err:.3g}); library = SDPA on densified Q/K; {fmt(r)}")
        res[n] = r
    # the f32 CUDA-core body, and the tensor-core body at every head width
    # (inputs from a random state of their own: later phases see PR 15's)
    rs = np.random.RandomState(SEED + 16)
    for d_, causal, dtype in ((64, True, torch.float32), (64, False, torch.float32),
                              (32, True, torch.bfloat16), (32, False, torch.bfloat16),
                              (64, False, torch.bfloat16), (128, True, torch.bfloat16),
                              (128, False, torch.bfloat16)):
        n = 1000
        reset_launches()
        qv, qi, kv, ki = _codes_of(rs, bh, n, d_, k, dtype)
        v = torch.from_numpy(rs.randn(bh, n, d_).astype(np.float32)).cuda().to(dtype)
        ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d_, causal=causal, return_residuals=True)
        po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d_, causal=causal, return_residuals=True)
        torch.cuda.synchronize()
        want_core = int(dtype == torch.float32)
        check(body_counts()["flash_sfa_cuda_core"] == want_core,
              f"flash_sfa {dtype} d={d_}: body launches {body_counts()}")
        what = f"n={n} d={d_} causal={causal} {dtype}"
        e = _close(ko, po, dtype, f"flash_sfa {what}")[0]
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
        res[1024]["max_abs_err"] = max(res[1024]["max_abs_err"], e)
        print(f"[flash_sfa] bh={bh} {what} ({'CUDA-core' if want_core else 'tensor-core'} "
              f"body): max|err| {e:.3g} (lse {(kl - pl).abs().max().item():.3g})")
    res[1024]["max_abs_err"] = max(res[1024]["max_abs_err"], res[1000]["max_abs_err"])
    return res[1024]


def _close_rows(got, want, lens, what):
    """got against its plain version (1e-4: f32 outputs, sums in another
    order); a row of length 0 must be exactly 0. -> max |err|."""
    check(not got[lens <= 0].any(), f"{what}: a zero-length row is not 0")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    return (got - want).abs().max().item()


def _boundary_lengths(n_max, count):
    """``count`` lengths at and around the decode kernels' run boundaries
    (SPLIT = 128 tokens), with a zero-length row and n_max."""
    from repro_torch.kernels.flash_sfa_decode import SPLIT
    cand = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT, n_max - 1, n_max, 2 * SPLIT + 1]
    return np.array((cand * count)[:count], np.int32)


def phase_decode(rs):
    from repro_torch.kernels import flash_sfa_decode, rtopk, topk_dense
    from repro_torch.kernels.ref import flash_sfa_decode_ref
    b, h, n_max, k, d, dv = 8, 12, 2048, 8, 64, 64
    lengths = rs.randint(64, n_max + 1, size=b)
    lens = torch.from_numpy(np.repeat(lengths, h).astype(np.int32)).cuda()
    scale = d ** -0.5
    # 4 distinct caches (> the 50 MB L2 together), cycled so each timed call
    # reads its cache from HBM as a decode step does
    caches = []
    for _ in range(4):
        kd = torch.from_numpy(rs.randn(b, n_max, h, d).astype(np.float32)).cuda()
        kv, ki = rtopk(kd.bfloat16(), k)      # SparseKV leaves (b, n, hkv, k)
        v = torch.from_numpy(rs.randn(b, n_max, h, dv).astype(np.float32)).cuda().bfloat16()
        caches.append((kv, ki.to(torch.uint8), v))
    q = topk_dense(torch.from_numpy(rs.randn(b * h, d).astype(np.float32)).cuda(), k)
    kv, ki, v = caches[0]
    ko = flash_sfa_decode(q, kv, ki, v, lens, d=d, scale=scale)
    po = flash_sfa_decode_ref(q, kv, ki, v, lens, d=d, scale=scale)
    torch.cuda.synchronize()
    # tolerance: f32 outputs, sums in another order: 1e-4
    err = (ko - po).abs().max().item()
    torch.testing.assert_close(ko, po, rtol=0, atol=1e-4)
    # run boundaries and a zero-length row: against the plain version; the
    # same content in the folded (bh, n, F) layout (other strides, other
    # load paths) and a second call give the same bits
    bl = torch.from_numpy(np.repeat(_boundary_lengths(n_max, b), h)).cuda()
    folded = [t.permute(0, 2, 1, 3).reshape(b * h, n_max, t.shape[-1]).contiguous()
              for t in (kv, ki, v)]
    kb = flash_sfa_decode(q, kv, ki, v, bl, d=d, scale=scale)
    e_b = _close_rows(kb, flash_sfa_decode_ref(q, kv, ki, v, bl, d=d, scale=scale), bl,
                      "flash_sfa_decode at the run boundaries")
    check(torch.equal(kb, flash_sfa_decode(q, *folded, bl, d=d, scale=scale)),
          "flash_sfa_decode: the folded layout does not give the same bits")
    check(torch.equal(kb, flash_sfa_decode(q, kv, ki, v, bl, d=d, scale=scale)),
          "flash_sfa_decode: two identical calls differ")
    err = max(err, e_b)
    print(f"[flash_sfa_decode] lengths {_boundary_lengths(n_max, b).tolist()}: max|err| "
          f"{e_b:.3g} (tol 1e-4; zero-length row 0); folded layout and a second call "
          f"bit-equal")
    # library yardstick: SDPA on the densified cache, masked to the lengths
    dense = []
    for kv_, ki_, v_ in caches:
        kdn = _densify(kv_, ki_, d).permute(0, 2, 1, 3).contiguous()
        dense.append((kdn, v_.permute(0, 2, 1, 3).contiguous()))
    mask = (torch.arange(n_max, device="cuda")[None, :]
            < torch.from_numpy(lengths).cuda()[:, None])[:, None, None, :]
    qb = q.bfloat16().reshape(b, h, 1, d)
    it = {"i": 0}

    def cycle(fn):
        def call():
            it["i"] = (it["i"] + 1) % 4
            return fn(it["i"])
        return call

    run_kernel = cycle(lambda i: flash_sfa_decode(q, *caches[i], lens, d=d, scale=scale))
    run_plain = cycle(lambda i: flash_sfa_decode_ref(q, *caches[i], lens, d=d, scale=scale))
    run_lib = cycle(lambda i: F.scaled_dot_product_attention(
        qb, dense[i][0], dense[i][1], attn_mask=mask, scale=scale))
    tokens = int(lengths.sum())
    b_ms, b_by = bound(tokens * h * (k * (2 + 1) + dv * 2) + b * h * (d + dv) * 4,
                       code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
                       + tokens * h * 2 * dv / F32_FLOPS)
    r = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
             **timings(run_kernel, run_plain, run_lib))
    print(f"[flash_sfa_decode] b={b} h={h} n_max={n_max} lengths={lengths.tolist()} "
          f"k={k} uint8 idx, bf16 V, f32 out: max|err| {err:.3g}; library = SDPA on "
          f"the densified cache; {fmt(r)}")
    return r


# the paged decode kernels' main path: 8 slots x 12 heads of 64, k 8, pages
# of 128 tokens, up to 2048 tokens a slot
PAGED = dict(slots=8, h=12, d=64, k=8, dv=64, page=128, mp=16)


def _paged_pools(rs, dtype, copies=4, c=PAGED):
    """``copies`` distinct pool sets (> the 50 MB L2 together, cycled so a
    timed call reads from HBM) in the (hkv, P, page, F) layout (hkv =
    ``c["h"]``), a shuffled non-monotone block table and ragged lengths with
    slot 1 at the past-the-table sentinel. Codes are rtopk codes of random
    rows."""
    from repro_torch.kernels import rtopk
    P = c["slots"] * c["mp"] + 1
    pools = []
    for _ in range(copies):
        kd = torch.from_numpy(rs.randn(c["h"], P, c["page"], c["d"]).astype(np.float32)).cuda()
        kv, ki = rtopk(kd.to(dtype), c["k"])
        v = torch.from_numpy(rs.randn(c["h"], P, c["page"], c["dv"]).astype(np.float32))
        kf = torch.from_numpy(rs.randn(c["h"], P, c["d"], c["page"]).astype(np.float32))
        pools.append(dict(kv=kv, ki=ki.to(torch.uint8), v=v.cuda().to(dtype),
                          kf=kf.cuda().to(dtype)))
    bt = rs.permutation(np.arange(1, P))[:c["slots"] * c["mp"]]
    bt = torch.from_numpy(bt.reshape(c["slots"], c["mp"]).astype(np.int32)).cuda()
    lengths = rs.randint(64, c["mp"] * c["page"] + 1, size=c["slots"])
    lengths[1] = c["mp"] * c["page"] + 1
    return pools, bt, lengths


def _cycle(fns):
    it = {"i": 0}

    def call():
        it["i"] = (it["i"] + 1) % len(fns)
        return fns[it["i"]]()
    return call


def _check_paged_multi(q, qm, p0, bt, lens, slot, start, what, c=PAGED):
    """Rows 11 and 12 on one pool set: each against its plain version (a
    zero-length row must be exactly 0), the paged
    decode bit-equal to flash_sfa_decode on the gathered view, and each of
    the C verify rows of ``slot`` at lengths start+1.. bit-equal to the
    paged decode at its length. Query heads ``c["heads"]`` (GQA) or
    ``c["h"]``. -> (verify lengths, (paged err, multi err))."""
    from repro_torch.kernels import flash_sfa_decode, flash_sfa_decode_multi, flash_sfa_decode_paged
    from repro_torch.kernels.ref import (
        _pool_view, flash_sfa_decode_multi_ref, flash_sfa_decode_paged_ref,
    )
    h, d = c.get("heads", c["h"]), c["d"]
    C = qm.shape[0] // h
    ko = flash_sfa_decode_paged(q, p0["kv"], p0["ki"], p0["v"], bt, lens, d=d, heads=h)
    po = flash_sfa_decode_paged_ref(q, p0["kv"], p0["ki"], p0["v"], bt, lens, d=d, heads=h)
    view = [_pool_view(p0[n], bt).contiguous() for n in ("kv", "ki", "v")]
    o10 = flash_sfa_decode(q, *view, lens.repeat_interleave(h), d=d)
    lm = (start + torch.arange(C, device="cuda") + 1).repeat_interleave(h).int()
    mo = flash_sfa_decode_multi(qm, p0["kv"], p0["ki"], p0["v"], lm, d=d, heads=h,
                                block_tables=bt, slot=slot)
    mp_ = flash_sfa_decode_multi_ref(qm, p0["kv"], p0["ki"], p0["v"], lm, d=d, heads=h,
                                     block_tables=bt, slot=slot)
    multi_eq = True
    for i in range(C):
        li = lens.clone()
        li[slot] = start + i + 1
        qi = q.clone()
        qi[slot * h:(slot + 1) * h] = qm[i * h:(i + 1) * h]
        one = flash_sfa_decode_paged(qi, p0["kv"], p0["ki"], p0["v"], bt, li, d=d, heads=h)
        multi_eq &= torch.equal(mo[i * h:(i + 1) * h], one[slot * h:(slot + 1) * h])
    torch.cuda.synchronize()
    errs = (_close_rows(ko, po, lens.repeat_interleave(h), f"flash_sfa_decode_paged {what}"),
            _close_rows(mo, mp_, lm, f"flash_sfa_decode_multi {what}"))
    check(torch.equal(ko, o10), f"flash_sfa_decode_paged {what}: not bit-equal to "
                                f"flash_sfa_decode on the gathered view")
    check(multi_eq, f"flash_sfa_decode_multi {what}: a row is not bit-equal to the paged "
                    f"decode at its length")
    print(f"[flash_sfa_decode_paged/multi] {what}: slot lengths {lens.tolist()}, verify "
          f"slot {slot} at {start + 1}..{start + C}: max|err| paged {errs[0]:.3g}, multi "
          f"{errs[1]:.3g} (tol 1e-4); paged == flash_sfa_decode on the gathered view "
          f"(bit-equal); each of the {C} verify rows == the paged decode at its length "
          f"(bit-equal)")
    return lm, errs


def phase_decode_paged(rs):
    """Rows 11 and 12: the paged decode kernel and the multi-query verify
    kernel, each against its plain version, with the bit-equalities the
    engines rely on."""
    from repro_torch.kernels import flash_sfa_decode_multi, flash_sfa_decode_paged, topk_dense
    from repro_torch.kernels.flash_sfa_decode import SPLIT
    from repro_torch.kernels.ref import (
        _pool_view, flash_sfa_decode_multi_ref, flash_sfa_decode_paged_ref,
    )
    c = PAGED
    h, d, k, dv = c["h"], c["d"], c["k"], c["dv"]
    scale = d ** -0.5
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        pools, bt, lengths = _paged_pools(rs, dtype)
        lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
        q = topk_dense(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32)).cuda(), k)
        p0 = pools[0]
        # verify pass: C = 5 queries of slot 2 at cache_len + c + 1
        C, slot = 5, 2
        start = int(min(lengths[slot], c["mp"] * c["page"])) - C
        qm = topk_dense(torch.from_numpy(rs.randn(C * h, d).astype(np.float32)).cuda(), k)
        lm, errs = _check_paged_multi(q, qm, p0, bt, lens, slot, start, str(dtype))
        # run boundaries, a zero-length slot and the past-the-table
        # sentinel; the verify rows' lengths SPLIT-2..SPLIT+2 cross a boundary
        bl = torch.from_numpy(_boundary_lengths(c["mp"] * c["page"], c["slots"])).cuda()
        bl[-1] = c["mp"] * c["page"] + 1
        e_b = _check_paged_multi(q, qm, p0, bt, bl, slot, SPLIT - 3,
                                 f"{dtype} at the run boundaries")[1]
        errs = (max(errs[0], e_b[0]), max(errs[1], e_b[1]))
        if dtype != torch.bfloat16:
            out["err"] = errs
            continue
        n_all = c["mp"] * c["page"]
        eff = np.minimum(lengths, n_all)
        tokens = int(eff.sum())
        es = 2
        per_tok = h * (k * (es + 1) + dv * es)
        # library yardsticks: SDPA on the densified gathered cache (masked to
        # the lengths), and on one slot's densified view for the verify rows
        dense = []
        for p in pools:
            kd = _densify(_pool_view(p["kv"], bt), _pool_view(p["ki"], bt), d)
            dense.append((kd.permute(0, 2, 1, 3).contiguous(),
                          _pool_view(p["v"], bt).permute(0, 2, 1, 3).contiguous()))
        mask = (torch.arange(n_all, device="cuda")[None, :]
                < torch.from_numpy(eff).cuda()[:, None])[:, None, None, :]
        qb = q.bfloat16().reshape(c["slots"], h, 1, d)
        b_ms, b_by = bound(tokens * per_tok + c["slots"] * h * (d + dv) * 4,
                           code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
                           + tokens * h * 2 * dv / F32_FLOPS)
        r11 = dict(max_abs_err=max(out["err"][0], errs[0]), bound_ms=b_ms, bound_by=b_by,
                   **timings(_cycle([lambda p=p: flash_sfa_decode_paged(
                       q, p["kv"], p["ki"], p["v"], bt, lens, d=d, heads=h) for p in pools]),
                       _cycle([lambda p=p: flash_sfa_decode_paged_ref(
                           q, p["kv"], p["ki"], p["v"], bt, lens, d=d, heads=h)
                           for p in pools]),
                       _cycle([lambda i=i: F.scaled_dot_product_attention(
                           qb, dense[i][0], dense[i][1], attn_mask=mask, scale=scale)
                           for i in range(len(pools))])))
        print(f"[flash_sfa_decode_paged] slots {c['slots']} x h {h}, pages of {c['page']}, "
              f"{c['mp']} a slot, lengths {eff.tolist()} (slot 1 at the sentinel), k {k}, "
              f"uint8 idx, bf16 pools; library = SDPA on the densified gathered cache; "
              f"{fmt(r11)}")
        L = start + C
        sdense = [(dense[i][0][slot:slot + 1], dense[i][1][slot:slot + 1])
                  for i in range(len(pools))]
        smask = (torch.arange(n_all, device="cuda")[None, :] < lm[::h, None])[None, None]
        qmb = qm.bfloat16().reshape(C, h, d).transpose(0, 1)[None]
        b_ms, b_by = bound(L * per_tok + C * h * (d + dv) * 4,
                           code_product_s(C * L * h * 2 * k, C * L * h * 2 * d)
                           + C * L * h * 2 * dv / F32_FLOPS)
        r12 = dict(max_abs_err=max(out["err"][1], errs[1]), bound_ms=b_ms, bound_by=b_by,
                   **timings(_cycle([lambda p=p: flash_sfa_decode_multi(
                       qm, p["kv"], p["ki"], p["v"], lm, d=d, heads=h, block_tables=bt,
                       slot=slot) for p in pools]),
                       _cycle([lambda p=p: flash_sfa_decode_multi_ref(
                           qm, p["kv"], p["ki"], p["v"], lm, d=d, heads=h, block_tables=bt,
                           slot=slot) for p in pools]),
                       _cycle([lambda i=i: F.scaled_dot_product_attention(
                           qmb, sdense[i][0], sdense[i][1], attn_mask=smask, scale=scale)
                           for i in range(len(pools))])))
        print(f"[flash_sfa_decode_multi] one slot, C {C} queries x h {h} at lengths "
              f"{start + 1}..{L}, bf16 pools; library = SDPA on the slot's densified view "
              f"with the per-query length mask; bound counts the slot's cache once; "
              f"{fmt(r12)}")
        del dense
        return r11, r12


def phase_decode_fm(rs):
    """Rows 13 and 14: the feature-major decode kernels against their plain
    versions; row 14 bit-equal to row 13 on the gathered image."""
    from repro_torch.kernels import flash_sfa_decode_fm, flash_sfa_decode_fm_paged, rtopk
    from repro_torch.kernels.ref import flash_sfa_decode_fm_paged_ref, flash_sfa_decode_fm_ref
    c = PAGED
    h, d, k, dv = c["h"], c["d"], c["k"], c["dv"]
    n_all = c["mp"] * c["page"]
    scale = d ** -0.5
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        pools, bt, lengths = _paged_pools(rs, dtype)
        lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
        qv, qi = rtopk(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32))
                       .cuda().to(dtype), k)
        btl = bt.long()

        def image(p):
            kf = p["kf"][:, btl].permute(1, 0, 3, 2, 4).reshape(-1, d, n_all).contiguous()
            v = p["v"][:, btl].transpose(0, 1).reshape(-1, n_all, dv).contiguous()
            return kf, v

        imgs = [image(p) for p in pools]
        rlens = lens.repeat_interleave(h)
        p0 = pools[0]
        ko = flash_sfa_decode_fm_paged(qv, qi, p0["kf"], p0["v"], bt, lens, heads=h)
        po = flash_sfa_decode_fm_paged_ref(qv, qi, p0["kf"], p0["v"], bt, lens, heads=h)
        fo = flash_sfa_decode_fm(qv, qi, *imgs[0], rlens)
        fp = flash_sfa_decode_fm_ref(qv, qi, *imgs[0], rlens)
        torch.cuda.synchronize()
        torch.testing.assert_close(ko, po, rtol=0, atol=1e-4)
        torch.testing.assert_close(fo, fp, rtol=0, atol=1e-4)
        check(torch.equal(ko, fo), "flash_sfa_decode_fm_paged: not bit-equal to "
                                   "flash_sfa_decode_fm on the gathered image")
        # run boundaries (runs of SPLIT positions), a zero-length slot (its
        # rows must be exactly 0) and the past-the-table sentinel
        bl = torch.from_numpy(_boundary_lengths(n_all, c["slots"])).cuda()
        bl[-1] = n_all + 1
        rbl = bl.repeat_interleave(h)
        kb = flash_sfa_decode_fm_paged(qv, qi, p0["kf"], p0["v"], bt, bl, heads=h)
        fb = flash_sfa_decode_fm(qv, qi, *imgs[0], rbl)
        eb = (_close_rows(fb, flash_sfa_decode_fm_ref(qv, qi, *imgs[0], rbl), rbl,
                          f"flash_sfa_decode_fm {dtype} at the run boundaries"),
              _close_rows(kb, flash_sfa_decode_fm_paged_ref(qv, qi, p0["kf"], p0["v"], bt, bl,
                                                            heads=h), rbl,
                          f"flash_sfa_decode_fm_paged {dtype} at the run boundaries"))
        check(torch.equal(kb, fb), "flash_sfa_decode_fm_paged at the run boundaries: not "
                                   "bit-equal to flash_sfa_decode_fm on the gathered image")
        e = (max((fo - fp).abs().max().item(), eb[0]), max((ko - po).abs().max().item(), eb[1]))
        errs.append(e)
        print(f"[flash_sfa_decode_fm/_paged] {dtype}: max|err| fm {e[0]:.3g}, fm_paged "
              f"{e[1]:.3g} (tol 1e-4), also at slot lengths {bl.tolist()} (zero-length rows 0); "
              f"fm_paged == fm on the gathered image (bit-equal)")
        if dtype != torch.bfloat16:
            continue
        eff = np.minimum(lengths, n_all)
        tokens = int(eff.sum())
        es = 2
        b_ms, b_by = bound(tokens * h * (k * es + dv * es) + c["slots"] * h * (k * 8 + dv * 4),
                           code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
                           + tokens * h * 2 * dv / F32_FLOPS)
        # library yardstick: SDPA on the dense K the image holds (transposed),
        # masked to the lengths
        lib_in = [(kf.reshape(c["slots"], h, d, n_all).transpose(2, 3).contiguous(),
                   v.reshape(c["slots"], h, n_all, dv)) for kf, v in imgs]
        qd = _densify(qv, qi, d).reshape(c["slots"], h, 1, d)
        mask = (torch.arange(n_all, device="cuda")[None, :]
                < torch.from_numpy(eff).cuda()[:, None])[:, None, None, :]
        lib = _cycle([lambda i=i: F.scaled_dot_product_attention(
            qd, lib_in[i][0], lib_in[i][1], attn_mask=mask, scale=scale)
            for i in range(len(pools))])
        r13 = dict(max_abs_err=max(x[0] for x in errs), bound_ms=b_ms, bound_by=b_by,
                   **timings(_cycle([lambda i=i: flash_sfa_decode_fm(qv, qi, *imgs[i], rlens)
                                     for i in range(len(pools))]),
                             _cycle([lambda i=i: flash_sfa_decode_fm_ref(qv, qi, *imgs[i], rlens)
                                     for i in range(len(pools))]), lib))
        print(f"[flash_sfa_decode_fm] rows {c['slots'] * h}, image (rows, d {d}, n {n_all}) "
              f"bf16, lengths {eff.tolist()}, k {k}; library = SDPA on the image's dense K; "
              f"{fmt(r13)}")
        r14 = dict(max_abs_err=max(x[1] for x in errs), bound_ms=b_ms, bound_by=b_by,
                   **timings(_cycle([lambda p=p: flash_sfa_decode_fm_paged(
                       qv, qi, p["kf"], p["v"], bt, lens, heads=h) for p in pools]),
                       _cycle([lambda p=p: flash_sfa_decode_fm_paged_ref(
                           qv, qi, p["kf"], p["v"], bt, lens, heads=h) for p in pools]), lib))
        print(f"[flash_sfa_decode_fm_paged] the same through (hkv, P, d, {c['page']}) pools "
              f"and the shuffled block table; library = SDPA on the gathered image's dense "
              f"K; {fmt(r14)}")
        return r13, r14


TRAIN_BH, TRAIN_N = 96, 1024              # batch 8 x 12 heads, seq 1024


def _pairs(bh, n):
    """(query, key) pairs under the causal mask."""
    return bh * n * (n + 1) // 2


def _sdpa_bwd(q, k, v, g, scale, causal=True):
    """Library yardstick for a backward: SDPA's own backward through
    autograd on (bh, n, d) inputs viewed as (8, bh / 8, n, d)."""
    q, k, v = (t.detach().reshape(8, -1, *t.shape[1:]).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)
    g = g.reshape(out.shape)

    def run():
        return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    # autograd runs the backward on its own thread: not for a CUDA graph
    run.graph_ok = False
    return run


def _close(got, want, dtype, what):
    """Tolerance: f32 — sums in another order, 1e-4 absolute and relative;
    bf16 — both accumulate in f32 and round once, one bf16 ulp (2^-7
    relative) plus 1e-4 absolute. Returns (max |error|, max |want|)."""
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-4, msg=what)
    check(want.abs().max().item() > 0, f"{what}: the plain version is all zero")
    return (got.float() - want.float()).abs().max().item(), want.abs().max().item()


def phase_flash_sfa_bwd(rs):
    """Row 5: the dense emit and the compact emits at the training shape;
    bf16 runs the tensor-core body (also at d 32 and 128, causal and not),
    f32 the CUDA-core body."""
    from repro_torch.kernels import body_counts, flash_sfa, flash_sfa_bwd, reset_launches, rtopk
    from repro_torch.kernels.ref import _support, flash_sfa_bwd_ref
    bh, d, k, dv = TRAIN_BH, 64, 8, 64
    scale = d ** -0.5
    errs, compact_errs = [], []
    for n in (TRAIN_N, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            reset_launches()
            q, kk = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().to(dtype)
                     for _ in range(2))
            v, g = (torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().to(dtype)
                    for _ in range(2))
            qv, qi = rtopk(q, k)
            kv, ki = rtopk(kk, k)
            o, lse = flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True)
            args = (qv, qi, kv, ki, v, o, lse, g)
            got = flash_sfa_bwd(*args, d=d, scale=scale)
            want = flash_sfa_bwd_ref(*args, d=d, scale=scale)
            torch.cuda.synchronize()
            errs_mags = [_close(a, b, dtype, f"flash_sfa_bwd {name} n={n} {dtype}")
                         for name, a, b in zip(("dq", "dk", "dv"), got, want)]
            err = max(e for e, _ in errs_mags)
            # the straight-through support: exactly zero off the stored coordinates
            for grad, idx in ((got[0], qi), (got[1], ki)):
                check(bool((grad[_support(idx, d) == 0] == 0).all()),
                      f"flash_sfa_bwd n={n} {dtype}: gradient off the stored support")
            print(f"[flash_sfa_bwd] bh={bh} n={n} k={k} dv={dv} {dtype}: max|err| {err:.3g} "
                  f"(max |dq|, |dk|, |dv| {', '.join(f'{m:.3g}' for _, m in errs_mags)}), "
                  f"dQ/dK zero off the support")
            errs.append(err)
            # the compact emits: against their plain versions, and compact
            # against the kernel's dense emit gathered at the stored indices
            # (the same accumulators: equal bit for bit)
            for emit, rot in (("compact", d), ("compact2", d), ("compact2", d // 2)):
                cgot = flash_sfa_bwd(*args, d=d, scale=scale, emit=emit, rot_dim=rot)
                cwant = flash_sfa_bwd_ref(*args, d=d, scale=scale, emit=emit, rot_dim=rot)
                torch.cuda.synchronize()
                cerr = max(_close(a, b, dtype, f"flash_sfa_bwd {emit}/{rot} {name} n={n} {dtype}")[0]
                           for name, a, b in zip(("dq", "dk", "dv"), cgot, cwant))
                check(torch.equal(cgot[2], got[2]), f"{emit}: dV differs from the dense emit's")
                if emit == "compact":
                    for a, dense, idx in ((cgot[0], got[0], qi), (cgot[1], got[1], ki)):
                        check(torch.equal(a, dense.gather(-1, idx.long())),
                              f"compact emit n={n} {dtype}: not the gathered dense emit")
                compact_errs.append(cerr)
                print(f"[flash_sfa_bwd] {emit} (rot_dim {rot}) n={n} {dtype}: max|err| vs plain "
                      f"{cerr:.3g}" + ("; equal to the dense emit gathered at the stored "
                                       "indices" if emit == "compact" else ""))
            cores = body_counts()["flash_sfa_bwd_cuda_core"]
            check(cores == (4 if dtype == torch.float32 else 0),
                  f"flash_sfa_bwd n={n} {dtype}: body launches {body_counts()}")
            if n == TRAIN_N and dtype == torch.bfloat16:
                main = (args, _densify(qv, qi, d), _densify(kv, ki, d), v, g)
    # the tensor-core body at the other head widths, causal and not, ragged n
    # (inputs from a random state of their own: later phases see PR 15's)
    rs_tc = np.random.RandomState(SEED + 18)
    for d_, causal in ((32, True), (32, False), (64, False), (128, True), (128, False)):
        n = 1000
        reset_launches()
        qv, qi, kv, ki = _codes_of(rs_tc, bh, n, d_, k, torch.bfloat16)
        v_, g_ = (torch.from_numpy(rs_tc.randn(bh, n, d_).astype(np.float32)).cuda().bfloat16()
                  for _ in range(2))
        o, lse = flash_sfa(qv, qi, kv, ki, v_, d=d_, causal=causal, return_residuals=True)
        a = (qv, qi, kv, ki, v_, o, lse, g_)
        dense = flash_sfa_bwd(*a, d=d_, causal=causal)
        what = f"n={n} d={d_} causal={causal} bf16"
        for emit, rot in (("dense", d_), ("compact", d_), ("compact2", d_),
                          ("compact2", d_ // 2)):
            got = flash_sfa_bwd(*a, d=d_, causal=causal, emit=emit, rot_dim=rot)
            want = flash_sfa_bwd_ref(*a, d=d_, causal=causal, emit=emit, rot_dim=rot)
            torch.cuda.synchronize()
            e = max(_close(x, y, torch.bfloat16, f"flash_sfa_bwd {emit}/{rot} {name} {what}")[0]
                    for name, x, y in zip(("dq", "dk", "dv"), got, want))
            (errs if emit == "dense" else compact_errs).append(e)
            check(torch.equal(got[2], dense[2]), f"{emit} {what}: dV differs from the dense emit's")
            if emit == "compact":
                for x, y, idx in ((got[0], dense[0], qi), (got[1], dense[1], ki)):
                    check(torch.equal(x, y.gather(-1, idx.long())),
                          f"compact emit {what}: not the gathered dense emit")
            print(f"[flash_sfa_bwd] {emit} (rot_dim {rot}) {what} (tensor-core body): max|err| "
                  f"{e:.3g}")
        _tc_only(f"flash_sfa_bwd {what}")
    args, qd, kd, v, g = main
    # no atomics, one owner per output tile: the bf16 backward is deterministic
    for emit in ("dense", "compact"):
        first, again = (flash_sfa_bwd(*args, d=d, scale=scale, emit=emit) for _ in range(2))
        check(all(torch.equal(x, y) for x, y in zip(first, again)),
              f"flash_sfa_bwd bf16 {emit}: two calls on the same inputs differ")
    print("[flash_sfa_bwd] bf16 n=1024 (tensor-core body): two calls on the same inputs equal "
          "bit for bit, dense and compact emits")
    es, pairs = 2, _pairs(bh, TRAIN_N)
    n = TRAIN_N
    b_ms, b_by = bound(2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                       + 2 * bh * n * d * es + bh * n * dv * es,
                       code_product_s(6 * k * pairs, 6 * d * pairs)
                       + 4 * dv * pairs / BF16_TC_FLOPS)
    r = dict(max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: flash_sfa_bwd(*args, d=d, scale=scale),
        lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale),
        _sdpa_bwd(qd, kd, v, g, scale)))
    print(f"[flash_sfa_bwd] bf16 n={n}: library = SDPA backward (autograd) on densified "
          f"Q/K; {fmt(r)}")
    kernels, _ = trace_kernels(lambda: [flash_sfa_bwd(*args, d=d, scale=scale)
                                        for _ in range(10)])
    print("[flash_sfa_bwd] bf16 n=1024, device ms a call by kernel (one trace of 10 calls): "
          + "; ".join(f"{name[:60]} {us / 1e4:.4f}" for name, us in
                      sorted(kernels.items(), key=lambda kv: -kv[1])))
    # the compact emit writes k-wide dQ/dK rows where the dense one writes d
    b_ms, b_by = bound(2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                       + 2 * bh * n * k * es + bh * n * dv * es,
                       code_product_s(6 * k * pairs, 6 * d * pairs)
                       + 4 * dv * pairs / BF16_TC_FLOPS)
    rc = dict(max_abs_err=max(compact_errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: flash_sfa_bwd(*args, d=d, scale=scale, emit="compact"),
        lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale, emit="compact"),
        _sdpa_bwd(qd, kd, v, g, scale)))
    print(f"[flash_sfa_bwd] compact emit bf16 n={n}: library = SDPA backward (autograd) on "
          f"densified Q/K; {fmt(rc)}")
    return r, rc


def phase_flash_attention(rs):
    """The dense forward and backward kernels; returns (fwd, bwd) results."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
    bh, d = TRAIN_BH, 64
    scale = d ** -0.5
    fwd_errs, bwd_errs = [], []
    for n in (TRAIN_N, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().to(dtype)
                          for _ in range(4))
            ko, kl = flash_attention(q, k, v, scale=scale, return_residuals=True)
            po, pl = flash_attention_ref(q, k, v, scale=scale, return_residuals=True)
            got = flash_attention_bwd(q, k, v, po, pl, g, scale=scale)
            want = flash_attention_bwd_ref(q, k, v, po, pl, g, scale=scale)
            torch.cuda.synchronize()
            fwd_errs.append(_close(ko, po, dtype, f"flash_attention n={n} {dtype}")[0])
            # the LSE is f32 in both: 1e-4
            torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
            errs_mags = [_close(a, b, dtype, f"flash_attention_bwd {name} n={n} {dtype}")
                         for name, a, b in zip(("dq", "dk", "dv"), got, want)]
            bwd_errs.append(max(e for e, _ in errs_mags))
            print(f"[flash_attention] bh={bh} n={n} d={d} {dtype}: forward max|err| "
                  f"{fwd_errs[-1]:.3g} (lse {(kl - pl).abs().max().item():.3g}), backward "
                  f"max|err| {bwd_errs[-1]:.3g} (max |dq|, |dk|, |dv| "
                  f"{', '.join(f'{m:.3g}' for _, m in errs_mags)})")
            if n == TRAIN_N and dtype == torch.bfloat16:
                main = (q, k, v, g, po, pl)
    # the bf16 tensor-core bodies at every head width, causal and not, ragged n
    for d_, causal in ((32, True), (32, False), (64, False), (128, True), (128, False)):
        n = 1000
        q_, k_, v_, g_ = (torch.from_numpy(rs.randn(bh, n, d_).astype(np.float32)).cuda()
                          .bfloat16() for _ in range(4))
        ko, kl = flash_attention(q_, k_, v_, causal=causal, return_residuals=True)
        po_, pl_ = flash_attention_ref(q_, k_, v_, causal=causal, return_residuals=True)
        got = flash_attention_bwd(q_, k_, v_, po_, pl_, g_, causal=causal)
        want = flash_attention_bwd_ref(q_, k_, v_, po_, pl_, g_, causal=causal)
        torch.cuda.synchronize()
        what = f"n={n} d={d_} causal={causal} bf16"
        fwd_errs.append(_close(ko, po_, torch.bfloat16, f"flash_attention {what}")[0])
        torch.testing.assert_close(kl, pl_, rtol=1e-5, atol=1e-4)
        bwd_errs.append(max(_close(a, b, torch.bfloat16, f"flash_attention_bwd {name} {what}")[0]
                            for name, a, b in zip(("dq", "dk", "dv"), got, want)))
        print(f"[flash_attention] bh={bh} {what}: forward max|err| {fwd_errs[-1]:.3g} (lse "
              f"{(kl - pl_).abs().max().item():.3g}), backward max|err| {bwd_errs[-1]:.3g}")
    del q_, k_, v_, g_, got, want
    q, k, v, g, po, pl = main
    # no atomics, one owner per output tile: the bf16 backward is deterministic
    first, again = (flash_attention_bwd(q, k, v, po, pl, g, scale=scale) for _ in range(2))
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "flash_attention_bwd bf16: two calls on the same inputs differ")
    print("[flash_attention_bwd] bf16 n=1024: two calls on the same inputs equal bit for bit")
    n, es, pairs = TRAIN_N, 2, _pairs(bh, TRAIN_N)
    qb, kb, vb = (t.reshape(8, -1, n, d) for t in (q, k, v))
    b_ms, b_by = bound(4 * bh * n * d * es + bh * n * 4, 4 * d * pairs / BF16_TC_FLOPS)
    fwd = dict(max_abs_err=max(fwd_errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: flash_attention(q, k, v, scale=scale, return_residuals=True),
        lambda: flash_attention_ref(q, k, v, scale=scale, return_residuals=True),
        lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True, scale=scale)))
    print(f"[flash_attention] bf16 n={n}: library = SDPA; {fmt(fwd)}")
    b_ms, b_by = bound(8 * bh * n * d * es + bh * n * 4, 10 * d * pairs / BF16_TC_FLOPS)
    bwd = dict(max_abs_err=max(bwd_errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: flash_attention_bwd(q, k, v, po, pl, g, scale=scale),
        lambda: flash_attention_bwd_ref(q, k, v, po, pl, g, scale=scale),
        _sdpa_bwd(q, k, v, g, scale)))
    print(f"[flash_attention_bwd] bf16 n={n}: library = SDPA backward (autograd); {fmt(bwd)}")
    # where the backward's time goes: its two kernels and the wrapper's D
    kernels, _ = trace_kernels(
        lambda: [flash_attention_bwd(q, k, v, po, pl, g, scale=scale) for _ in range(10)])
    print("[flash_attention_bwd] bf16 n=1024, device ms a call by kernel (one trace of 10 "
          "calls): " + "; ".join(f"{name[:60]} {us / 1e4:.4f}" for name, us in
                                 sorted(kernels.items(), key=lambda kv: -kv[1])))
    return fwd, bwd


# --------------------------------------------------------------------------
# phase 3, the compact seam's kernels
# --------------------------------------------------------------------------

TRAIN_B, D_MODEL, HEADS, HD, SFA_K = 8, 768, 12, 64, 8


def near_ties(y, got_idx, want_idx, k, rel):
    """(rows whose top-k index sets differ, their count, and how many of
    them have their k-th and (k+1)-th magnitudes of y within ``rel`` of
    each other, relative to the k-th)."""
    diff = (got_idx.sort(-1).values != want_idx.sort(-1).values).any(-1)
    mags = y.float().abs().sort(-1, descending=True).values
    kth, nxt = mags[..., k - 1], mags[..., k]
    tie = (kth - nxt) <= rel * kth
    return diff, int(diff.sum()), int((diff & tie).sum())


def _dyadic_proj(rs, b, n, m, cols):
    """x (b, n, m) in {-1, -3/4, ..., 1} and w (m, cols) in multiples of
    1/16 up to 1/2: bf16 values, every product a multiple of 2^-6 and every
    |sum| <= m / 2, exact in f32 in any order."""
    x = torch.from_numpy(rs.randint(-4, 5, size=(b, n, m)).astype(np.float32) / 4).cuda()
    w = torch.from_numpy(rs.randint(-8, 9, size=(m, cols)).astype(np.float32) / 16).cuda()
    return x, w


def phase_proj_rtopk(rs):
    """proj_rtopk at the training path's shapes: the 12 query heads' view of
    a packed (768, 2304) f32 w_qkv, x (8, 1024, 768). bf16 x runs the
    tensor-core body, f32 the CUDA-core body (body_counts says which)."""
    from repro_torch.kernels import body_counts, proj_rtopk, reset_launches
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.kernels.ref import proj_rtopk_ref, rtopk_ref
    from repro_torch.kernels.rtopk import tensor_core_body, w_in_place
    from repro_torch.models.layers import rope
    rt = sys.modules["repro_torch.kernels.rtopk"]
    b, n, m, h, d, k = TRAIN_B, TRAIN_N, D_MODEL, HEADS, HD, SFA_K
    for fn, (regs, spill) in ptxas_kernels("proj_rtopk").items():
        if "tc_kernel" in fn or "w_heads_bf16" in fn:
            print(f"[proj_rtopk] ptxas: {fn}: {regs} registers; {spill}")

    def exact(x, wh, what, pos=None, spec=None, k=k):
        """Dyadic inputs: indices equal and values bit-equal to the plain
        version (the rounding, RoPE and selection see the same f32 sums)."""
        reset_launches()
        kv, ki = proj_rtopk(x, wh, pos, k=k, rope_spec=spec)
        tc = body_counts()["proj_rtopk_cuda_core"] == 0
        check(tc == tensor_core_body(x.dtype, wh.shape[-1], x.shape[-1]),
              f"proj_rtopk {what}: body launches {body_counts()}")
        pv, pi = proj_rtopk_ref(x, wh, pos, k=k, rope_spec=spec)
        torch.cuda.synchronize()
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        check(torch.equal(ki, pi), f"proj_rtopk {what}: indices differ")
        check(torch.equal(kv.view(bits), pv.view(bits)), f"proj_rtopk {what}: values not "
                                                          f"bit-equal")
        print(f"[proj_rtopk] {what}: {'tensor-core' if tc else 'CUDA-core'} body, indices "
              f"equal, values bit-equal")
        return kv, ki

    # f32 (the CUDA-core body) and bf16 (the tensor cores) at the main shapes,
    # w the strided view of the packed f32 w_qkv (rounded to bf16 by the
    # pack kernel; its dyadic values are bf16), with and without RoPE
    x, w = _dyadic_proj(rs, b, n, m, 3 * h * d)
    wq = head_blocks(w, 0, h, d)
    pos = torch.arange(n, device="cuda")[None, :].expand(b, n)
    exact(x, wq, f"f32 dyadic x {tuple(x.shape)}, w heads {tuple(wq.shape)} (strided view)")
    got = exact(x.bfloat16(), wq, f"bf16 dyadic x {tuple(x.shape)}, f32 w heads "
                                   f"{tuple(wq.shape)} (strided view)")
    again = proj_rtopk(x.bfloat16(), wq, k=k)
    check(torch.equal(got[1], again[1]) and torch.equal(got[0].view(torch.int16),
                                                         again[0].view(torch.int16)),
          "proj_rtopk tensor-core body: two calls differ")
    exact(x.bfloat16(), wq, "bf16 dyadic, RoPE at full width", pos, (10_000.0, d))
    wb = head_blocks(w.bfloat16(), 0, h, d)
    check(w_in_place(wb), "a bf16 head view of the packed w_qkv is not read in place")
    exact(x.bfloat16(), wb, "bf16 dyadic, bf16 w heads read in place by TMA")
    exact(x.bfloat16(), wb.contiguous(), "bf16 dyadic, contiguous bf16 w heads (packed)")
    # head dims 32 and 128, ragged n, m = 200 and 3 heads (the last column
    # tile part empty), with and without RoPE (rot_dim d and d / 2); k 8
    # and 16 (one thread selects a row) and 24 (one warp a row); inputs
    # from a random state of their own, so the later phases' stay as they were
    rs_r = np.random.RandomState(SEED + 19)
    for bb, nn, mm, hh, dd in ((2, 1000, 200, 3, 64), (2, 777, 200, 5, 32), (1, 300, 136, 3, 128)):
        xe, we = _dyadic_proj(rs_r, bb, nn, mm, 2 * hh * dd)
        whe = head_blocks(we, 1, hh, dd)
        pe = torch.arange(nn, device="cuda")[None, :].expand(bb, nn)
        for spec, kk in ((None, k), ((10_000.0, dd), 16), ((500.0, dd // 2), 24)):
            exact(xe.bfloat16(), whe, f"bf16 dyadic b {bb}, n {nn}, m {mm}, {hh} heads of {dd}, "
                                      f"k {kk}, rope {spec}", pe if spec else None, spec, kk)
    # random inputs: the kernel's f32 sum runs in another order than the
    # plain einsum's, so a row may keep another index only where its k-th
    # and (k+1)-th magnitudes are within the two results' difference of
    # each other: bf16 — a rounding each side, 2 ulps (2^-6 relative),
    # with or without RoPE; f32 — the sums' own error, which grows with
    # sqrt(m): 64 ulps (2^-17). Without RoPE the values of the other rows
    # are within _close. With RoPE a one-ulp move of y becomes a move of
    # up to ulp(y_2j)·|cos| + ulp(y_2j+1)·|sin| in a rotated value, more
    # than an ulp of it where the rotation cancels; so the RoPE'd codes are
    # held to the kernel's own y instead: that y (every entry, k = d)
    # within _close of the plain one, and the codes bit-equal to the plain
    # RoPE and selection applied to it
    w = (0.04 * torch.from_numpy(rs.randn(m, 3 * h * d).astype(np.float32))).cuda()
    wq = head_blocks(w, 0, h, d)
    xr = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).cuda()
    errs = []
    for dtype, rope_on in ((torch.float32, False), (torch.bfloat16, False),
                           (torch.bfloat16, True)):
        xx = xr.to(dtype)
        spec = (10_000.0, d) if rope_on else None
        reset_launches()
        kv, ki = proj_rtopk(xx, wq, pos if rope_on else None, k=k, rope_spec=spec)
        check(body_counts()["proj_rtopk_cuda_core"] == (1 if dtype == torch.float32 else 0),
              f"proj_rtopk {dtype}: body launches {body_counts()}")
        pv, pi = proj_rtopk_ref(xx, wq, pos if rope_on else None, k=k, rope_spec=spec)
        y0 = torch.einsum("bnm,hmd->bnhd", xx.float(), wq.to(dtype).float()).to(dtype)
        y = rope(y0, pos, theta=10_000.0, rot_dim=d) if rope_on else y0
        y = y.transpose(1, 2)
        rel = 2.0 ** -17 if dtype == torch.float32 else 2.0 ** -6
        diff, n_diff, n_tie = near_ties(y, ki, pi, k, rel)
        check(n_diff == n_tie, f"proj_rtopk {dtype} rope={rope_on}: {n_diff - n_tie} rows "
                               f"differ without a near-tie")
        same = ~diff
        moved = (kv[same].float() - pv[same].float()).abs()
        err = moved.max().item()
        errs.append(err)
        note = ""
        if rope_on:
            yk = proj_rtopk(xx, wq, k=d)[0]             # the kernel's y, every entry
            _close(yk, y0.transpose(1, 2), dtype, f"proj_rtopk {dtype}: y before RoPE")
            own = rtopk_ref(rope(yk.transpose(1, 2), pos, theta=10_000.0, rot_dim=d)
                            .transpose(1, 2), k)
            check(torch.equal(ki, own[1]) and torch.equal(kv.view(torch.int16),
                                                         own[0].view(torch.int16)),
                  f"proj_rtopk {dtype} rope: codes differ from RoPE + selection of its own y")
            outside = int((moved > 1e-4 + 2 ** -7 * pv[same].float().abs()).sum())
            note = (f"; y before RoPE within one ulp of the plain y (max|err| "
                    f"{(yk.float() - y0.transpose(1, 2).float()).abs().max().item():.3g}), the "
                    f"codes bit-equal to RoPE + selection of it; {outside} values of the other "
                    f"rows beyond one ulp of the plain codes (a rotation of a moved y)")
        else:
            _close(kv[same], pv[same], dtype, f"proj_rtopk {dtype} values")
        print(f"[proj_rtopk] {dtype} random, rope={rope_on}: {n_diff} of {diff.numel()} rows "
              f"pick another index set, each at a near-tie (gap <= {rel:.3g} relative); "
              f"max|err| on the others {err:.3g}{note}")
    xb = xr.bfloat16()
    rows = b * h * n

    def library():
        y = torch.matmul(xb, w[:, :h * d].bfloat16()).reshape(b, n, h, d)
        _, i = torch.topk(y.abs(), k, dim=-1)
        return i

    # the product on the tensor cores and about d compares a row for the
    # selection on the CUDA cores run side by side: the larger of the two
    b_ms, b_by = bound(b * n * m * 2 + m * h * d * 4 + rows * k * (2 + 4),
                       max(2 * b * n * m * h * d / BF16_TC_FLOPS, rows * d / F32_FLOPS))
    r = dict(max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: proj_rtopk(xb, wq, k=k), lambda: proj_rtopk_ref(xb, wq, k=k), library))
    print(f"[proj_rtopk] bf16 x {tuple(xb.shape)}, {h} heads of {d}, k={k}: library = "
          f"torch.matmul + torch.topk; {fmt(r)}")
    # beside it: bf16 w heads read in place (no pack kernel), and the
    # CUDA-core body on the same bf16 inputs (what the tensor cores replaced)
    wqb = head_blocks(w.bfloat16(), 0, h, d)
    outs = {}

    def run_core():
        vals = torch.empty((b, h, n, k), dtype=xb.dtype, device="cuda")
        idx = torch.empty((b, h, n, k), dtype=torch.int32, device="cuda")
        rt._proj_cuda_core(xb, wq, None, k, None, 0, vals, idx)
        return vals, idx
    for name, fn in (("bf16 w in place", lambda: proj_rtopk(xb, wqb, k=k)),
                     ("CUDA-core body", run_core)):
        outs[name] = (kernel_ms(fn),)
    core = run_core()
    diff, n_diff, n_tie = near_ties(torch.einsum("bnm,hmd->bhnd", xb.float(),
                                                 wq.bfloat16().float()).bfloat16(),
                                    core[1], proj_rtopk(xb, wq, k=k)[1], k, 2.0 ** -6)
    check(n_diff == n_tie, f"proj_rtopk: the two bodies part at {n_diff - n_tie} rows without "
                           f"a near-tie")
    print(f"[proj_rtopk] tensor-core body with f32 w (pack kernel + dense kernel) "
          f"{r['ms']:.4f} ms ({'; '.join(f'{kn} {v:.4f}' for kn, v in r['kernels_ms'].items())}); "
          f"with bf16 w in place {outs['bf16 w in place'][0]:.4f} ms; the CUDA-core body on "
          f"the same bf16 inputs {outs['CUDA-core body'][0]:.4f} ms ({n_diff} rows part from "
          f"the tensor-core body's, each at a near-tie) (device time per call)")
    return r


def ptxas_kernels(name):
    """{kernel: (registers, spill line)} from the ``-Xptxas -v`` log of
    ``csrc/<name>.cu``'s build."""
    from repro_torch.kernels import _build
    out, fn, spill = {}, None, ""
    for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            regs = int(line.split("Used")[1].split()[0])
            out[fn] = (regs, spill)
    return out


def _exact_codes(rs, h, ntok, d, kw, dups=True):
    """Codes whose dW sums are exact in f32 on either body: values in
    {-1, 1} at distinct indices; with ``dups`` every 7th row repeats its
    first index with the value 2^-9, so the summed duplicate 1 + 2^-9 (or
    -1 + 2^-9) is not a bf16 and goes through the lo tile exactly (hi +-1,
    lo 2^-9); without, every 9th row is padding (index 0, value 0)."""
    idx = np.sort(np.argsort(rs.rand(h, ntok, d), -1)[..., :kw], -1).astype(np.int32)
    vals = rs.choice([-1.0, 1.0], size=(h, ntok, kw)).astype(np.float32)
    if dups:
        idx[:, 3::7, 1] = idx[:, 3::7, 0]
        vals[:, 3::7, 1] = 2.0 ** -9
    else:
        idx[:, 5::9], vals[:, 5::9] = 0, 0.0
    idx[:, 9::11, -1] = d + 1                      # outside [0, d): adds nothing
    return (torch.from_numpy(vals).cuda().bfloat16(), torch.from_numpy(idx).cuda())


def _bit_equal(got, want, what):
    bad = (got != want).nonzero()
    if bad.numel():
        at = tuple(bad[0].tolist())
        raise AssertionError(f"{what}: {bad.shape[0]} entries differ, first at {at}: got "
                             f"{got[at].item()}, want {want[at].item()}")


def phase_code_grad(rs):
    """code_grad_dx/dw at the training path's shapes: 12 heads x 8,192
    tokens of bf16 codes, k 8 (and the pair closure's 2k; and code width 32,
    a k-16 RoPE model's, at d 64 and 128), m 768. bf16 codes run the
    tensor-core bodies, f32 the CUDA-core ones; each tensor-core body is
    also held against its CUDA-core body on the same bf16 inputs, bit for
    bit against the plain version on inputs whose sums are exact (the
    layout check: d 32, 64 and 128, widths 8, 16 and 32, ragged n and m),
    and dW with one token split."""
    from repro_torch.kernels import body_counts, code_grad_dw, code_grad_dx, reset_launches
    from repro_torch.kernels.code_grad import tensor_core_body
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.kernels.ref import code_grad_dw_ref, code_grad_dx_ref, scatter_code_grads
    cg = sys.modules["repro_torch.kernels.code_grad"]
    h, ntok, m, d = HEADS, TRAIN_B * TRAIN_N, D_MODEL, HD
    for fn, (regs, spill) in ptxas_kernels("code_grad").items():
        if "tc_kernel" in fn or "w_heads_bf16" in fn or "pack_dw_codes" in fn:
            print(f"[code_grad] ptxas: {fn}: {regs} registers; {spill}")
    w = torch.from_numpy((0.04 * rs.randn(m, 3 * h * d)).astype(np.float32)).cuda()
    wq = head_blocks(w, 0, h, d)
    # d 128's weights from a stream of their own: the timed gpt2 inputs
    # below stay the draws they were before width 32 was added
    w128 = np.random.RandomState(SEED + 27).randn(m, h * 128).astype(np.float32)
    wq_of = {d: wq, 128: head_blocks(torch.from_numpy(0.04 * w128).cuda(), 0, h, 128)}
    x = torch.from_numpy(rs.randn(ntok, m).astype(np.float32)).cuda()
    errs = {"dx": [], "dw": []}
    # width 32 (the pair closure of a k-16 RoPE model) at d 128, the
    # llama / moonshot head, and at d 64
    for kw, dtype, dd in ((SFA_K, torch.bfloat16, d), (SFA_K, torch.float32, d),
                          (2 * SFA_K, torch.bfloat16, d), (4 * SFA_K, torch.bfloat16, 128),
                          (4 * SFA_K, torch.bfloat16, d)):
        vals = torch.from_numpy(rs.randn(h, ntok, kw).astype(np.float32)).cuda().to(dtype)
        idx = torch.from_numpy(np.sort(np.argsort(rs.rand(h, ntok, dd), -1)[..., :kw], -1)
                               .astype(np.int32)).cuda()
        idx[:, 3::7, 1] = idx[:, 3::7, 0]          # duplicates sum (pair closures)
        xx, wd = x.to(dtype), wq_of[dd]
        reset_launches()
        got = (code_grad_dx(vals, idx, wd, d=dd), code_grad_dw(xx, vals, idx, d=dd))
        tc = tensor_core_body(dtype, dd, kw, m)
        check(body_counts()["code_grad_dx_cuda_core"] == body_counts()["code_grad_dw_cuda_core"]
              == (0 if tc else 1), f"code_grad kw={kw} d={dd} {dtype}: body launches "
                                   f"{body_counts()}")
        want = (code_grad_dx_ref(vals, idx, wd, d=dd), code_grad_dw_ref(xx, vals, idx, d=dd))
        torch.cuda.synchronize()
        # f32 outputs, sums of up to 12·32 (dx) or 8,192·32 (dW) terms in
        # another order, each summed duplicate and (dx) each f32 weight kept
        # to ~16 bits (hi + lo) on the tensor cores: 1e-4 of the output's
        # largest magnitude
        for name, a, bb in zip(("dx", "dw"), got, want):
            scale_ = bb.abs().max().item()
            torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-4 * scale_,
                                       msg=f"code_grad {name} kw={kw} d={dd} {dtype}")
            errs[name].append((a - bb).abs().max().item())
        line = (f"[code_grad] kw={kw} d={dd} {dtype}: max|err| dx {errs['dx'][-1]:.3g}, dW "
                f"{errs['dw'][-1]:.3g} ({'tensor-core' if tc else 'CUDA-core'} bodies; max "
                f"|dx| {want[0].abs().max().item():.3g}, |dW| {want[1].abs().max().item():.3g})")
        if tc:   # the same inputs through the CUDA-core bodies
            core = (cg._dx_cuda_core(vals, idx, wd, dd), cg._dw_cuda_core(xx, vals, idx, dd))
            for name, a, c, bb in zip(("dx", "dw"), got, core, want):
                torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * bb.abs().max().item(),
                                           msg=f"code_grad {name} kw={kw} d={dd}: tensor-core vs "
                                               f"CUDA-core body")
            line += (f"; against the CUDA-core bodies dx {(got[0] - core[0]).abs().max().item():.3g}"
                     f", dW {(got[1] - core[1]).abs().max().item():.3g}")
        print(line)
        if kw == SFA_K and dtype == torch.bfloat16:
            main = (vals, idx, xx)
    # the layout: exact sums give the plain version's bits. dW: values in
    # {-1, 1}, x in {-1, 0, 1}, a summed duplicate 1 + 2^-9 through the lo
    # tile. dx: the same codes against a w in multiples of 1/16 (bf16, no lo
    # part), or, without duplicates, against a w in multiples of 2^-12 (an
    # f32 with a nonzero lo part) or a bf16 w; the body leaves out S_lo.W_lo
    # (below 2^-16 of a product), so exact inputs keep one of them zero
    for hh, n_, m_, d_, kw, dups in ((h, ntok, m, d, SFA_K, True), (h, ntok, m, d, SFA_K, False),
                                     (h, ntok, m, d, 2 * SFA_K, True),
                                     (5, 1000, 200, 32, SFA_K, True),
                                     (3, 777, 136, 128, 2 * SFA_K, True),
                                     (4, 1000, 200, 128, SFA_K, False),
                                     (5, 333, 72, 32, 2 * SFA_K, False),
                                     (h, ntok, m, 128, 4 * SFA_K, True),
                                     (h, ntok, m, 128, 4 * SFA_K, False),
                                     (3, 777, 136, 64, 4 * SFA_K, True),
                                     (5, 333, 72, 64, 4 * SFA_K, False)):
        vals, idx = _exact_codes(rs, hh, n_, d_, kw, dups)
        xe = torch.from_numpy(rs.randint(-1, 2, (n_, m_)).astype(np.float32)).cuda().bfloat16()
        check(tensor_core_body(torch.bfloat16, d_, kw, m_), "exact inputs: not the tensor cores")
        reset_launches()
        _bit_equal(code_grad_dw(xe, vals, idx, d=d_), code_grad_dw_ref(xe, vals, idx, d=d_),
                   f"code_grad_dw exact inputs h={hh} n={n_} m={m_} d={d_} kw={kw}")
        how = "duplicates through the lo tile" if dups else "no duplicate: no lo products"
        print(f"[code_grad] dW tensor-core body on exact inputs, {hh} heads x {n_} tokens, m "
              f"{m_}, d {d_}, kw {kw} ({how}): equal to the plain version bit for bit")
        grid = 16 if dups else 4096
        wd = torch.from_numpy(rs.randint(-grid // 2, grid // 2 + 1, (m_, 2 * hh * d_))
                              .astype(np.float32) / grid).cuda()
        weights = [("f32 w" + (" in 1/16" if dups else " in 2^-12, nonzero lo"),
                    head_blocks(wd, 1, hh, d_))]
        if not dups:
            weights.append(("bf16 w", head_blocks(wd.bfloat16(), 1, hh, d_)))
        for wname, we in weights:
            got = code_grad_dx(vals, idx, we, d=d_)
            _bit_equal(got, code_grad_dx_ref(vals, idx, we, d=d_),
                       f"code_grad_dx exact inputs h={hh} n={n_} m={m_} d={d_} kw={kw} {wname}")
            check(torch.equal(got, code_grad_dx(vals, idx, we, d=d_)),
                  f"code_grad_dx h={hh} d={d_} kw={kw} {wname}: two calls differ")
            print(f"[code_grad] dx tensor-core body on exact inputs, {hh} heads x {n_} tokens, "
                  f"m {m_}, d {d_}, kw {kw} ({how}; {wname}): equal to the plain version bit "
                  f"for bit, and to itself on a second call")
        check(not any(body_counts().values()), f"exact inputs: body launches {body_counts()}")
    vals, idx, xx = main
    kw, es = SFA_K, 2
    ops_s = code_product_s(2 * ntok * m * h * kw, 2 * ntok * m * h * d)
    codes = h * ntok * kw * (es + 4)
    res = {}
    for name, kern, plain, lib, out_bytes, in_bytes in (
            ("code_grad_dx", lambda: code_grad_dx(vals, idx, wq, d=d),
             lambda: code_grad_dx_ref(vals, idx, wq, d=d),
             lambda: torch.einsum("hnd,hmd->nm", scatter_code_grads(vals, idx, d).float(), wq),
             ntok * m * 4, h * m * d * 4),
            ("code_grad_dw", lambda: code_grad_dw(xx, vals, idx, d=d),
             lambda: code_grad_dw_ref(xx, vals, idx, d=d),
             lambda: torch.einsum("nm,hnd->hmd", xx.float(), scatter_code_grads(vals, idx, d).float()),
             h * m * d * 4, ntok * m * es)):
        b_ms, b_by = bound(codes + in_bytes + out_bytes, ops_s)
        r = dict(max_abs_err=max(errs[name[-2:]]), bound_ms=b_ms, bound_by=b_by,
                 **timings(kern, plain, lib))
        print(f"[{name}] bf16 codes {h} x {ntok} x {kw}, m {m}: library = scatter_code_grads + "
              f"torch.einsum; {fmt(r)}")
        res[name] = r
    # the CUDA-core bodies on the same bf16 inputs (what the tensor-core
    # bodies replaced on this path), dx with a bf16 w (no lo products), and
    # dW with one token split
    def run_dx_core():
        return cg._dx_cuda_core(vals, idx, wq, d)
    wqb = wq.bfloat16()

    def run_dx_bf16():
        return code_grad_dx(vals, idx, wqb, d=d)
    dx_core_ms = kernel_ms(run_dx_core)
    dx_bf16_ms = kernel_ms(run_dx_bf16)

    def run_core():
        return cg._dw_cuda_core(xx, vals, idx, d)
    core_ms = kernel_ms(run_core)
    split_ms = res["code_grad_dw"]["ms"]
    want = code_grad_dw(xx, vals, idx, d=d)
    saved, cg._DW_MAX_SPLITS = cg._DW_MAX_SPLITS, 1
    try:
        one = code_grad_dw(xx, vals, idx, d=d)
        torch.testing.assert_close(one, want, rtol=1e-4, atol=1e-4 * want.abs().max().item(),
                                   msg="code_grad_dw with one token split")
        def run_one():
            return code_grad_dw(xx, vals, idx, d=d)
        one_ms = kernel_ms(run_one)
        one_core_ms = kernel_ms(run_core)
    finally:
        cg._DW_MAX_SPLITS = saved
    splits = cg.tc_splits(ntok, h, d, m, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"[code_grad_dx] tensor-core body {res['code_grad_dx']['ms']:.4f} ms with the f32 w "
          f"(hi + lo), {dx_bf16_ms:.4f} ms with a bf16 w (no lo products); CUDA-core body on "
          f"the same bf16 inputs {dx_core_ms:.4f} ms (device time per call)")
    print(f"[code_grad_dw] tensor-core body: {splits[0]} token splits of {splits[1]} tokens "
          f"{split_ms:.4f} ms, one split {one_ms:.4f} ms; CUDA-core body on the same bf16 "
          f"inputs: {max(1, min(saved, ntok // cg._DW_SPLIT_TOKENS))} splits {core_ms:.4f} ms, one split "
          f"{one_core_ms:.4f} ms (device time per call)")
    return res["code_grad_dx"], res["code_grad_dw"]


def banded(rs, bh, n, k, band_of):
    """Codes whose row i stores the k features of band ``band_of(i)``."""
    band = band_of(np.arange(n))
    idx = np.broadcast_to((band[:, None] * k + np.arange(k)).astype(np.int32), (bh, n, k))
    return (torch.from_numpy(rs.randn(bh, n, k).astype(np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(idx)).cuda())


def _skip_work(level, causal=True):
    """(query, key) pairs that the level map sends to the tile update, and
    the level-1 tiles (closed form)."""
    lv = level.long()
    nqb, nkb = lv.shape[1:]
    diag = torch.eye(nqb, nkb, dtype=torch.bool, device=lv.device)[None]
    per = torch.where(diag & causal, 64 * 65 // 2, 64 * 64)
    return int(((lv == 2) * per).sum()), int((lv == 1).sum())


def phase_block_skip(rs):
    """Block-skip FlashSFA at the training path's shapes (bh 96, n 1024,
    k 8, dv 64, bf16, causal) on rtopk codes of random rows (the training
    path's kind) and on a planted banded input (tile t on features
    8·(t mod 8)..+7) whose off-band tile pairs take the closed form."""
    from repro_torch.kernels import block_skip_stats, flash_sfa, reset_launches, rtopk
    from repro_torch.kernels.flash_sfa import BLOCK, _skip_schedule
    from repro_torch.kernels.ref import flash_sfa_ref
    bh, n, d, k, dv = TRAIN_BH, TRAIN_N, HD, SFA_K, 64
    scale = d ** -0.5
    errs = []
    inputs = {}
    q = torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().bfloat16()
    kk = torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().bfloat16()
    inputs["random"] = (*rtopk(q, k), *rtopk(kk, k))
    qv, qi = banded(rs, bh, n, k, lambda i: (i // BLOCK) % 8)
    kv, ki = banded(rs, bh, n, k, lambda i: (i // BLOCK) % 8)
    inputs["banded"] = (qv.bfloat16(), qi, kv.bfloat16(), ki)
    v = torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().bfloat16()
    reset_launches()
    for name, codes in inputs.items():
        for nn in (n, 1000):
            c = [t[:, :nn] for t in codes]
            vv = v[:, :nn]
            stats = block_skip_stats(*c, d=d)
            ko, kl = flash_sfa(*c, vv, d=d, scale=scale, return_residuals=True, block_skip=True)
            po, pl = flash_sfa_ref(*c, vv, d=d, scale=scale, return_residuals=True)
            torch.cuda.synchronize()
            err = _close(ko, po, torch.bfloat16, f"flash_sfa block_skip {name} n={nn}")[0]
            torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
            errs.append(err)
            print(f"[flash_sfa block_skip] {name} codes bh={bh} n={nn} bf16: block_skip_stats "
                  f"(dead, closed form, compute) = ({stats[0]:.4f}, {stats[1]:.4f}, "
                  f"{stats[2]:.4f}); max|err| {err:.3g} (lse "
                  f"{(kl - pl).abs().max().item():.3g})")
            if name == "banded" and nn == n:
                check(stats[1] > 0.5 * (1 - stats[0]),
                      f"banded input: closed-form share {stats[1]} of the live steps "
                      f"{1 - stats[0]}")
    _tc_only("flash_sfa block_skip bf16")
    # the tensor-core body at the other head widths and non-causal, on banded
    # codes (level 1 taken), ragged n; inputs from a random state of their own
    rs_tc = np.random.RandomState(SEED + 17)
    for d_, causal in ((32, True), (128, True), (64, False), (128, False)):
        nn = 1000
        bands = d_ // k
        qv, qi = banded(rs_tc, bh, nn, k, lambda i: (i // BLOCK) % bands)
        kv, ki = banded(rs_tc, bh, nn, k, lambda i: (i // BLOCK) % bands)
        c = (qv.bfloat16(), qi, kv.bfloat16(), ki)
        vv = torch.from_numpy(rs_tc.randn(bh, nn, d_).astype(np.float32)).cuda().bfloat16()
        stats = block_skip_stats(*c, d=d_, causal=causal)
        ko, kl = flash_sfa(*c, vv, d=d_, causal=causal, return_residuals=True, block_skip=True)
        po, pl = flash_sfa_ref(*c, vv, d=d_, causal=causal, return_residuals=True)
        torch.cuda.synchronize()
        what = f"banded d={d_} causal={causal} n={nn}"
        errs.append(_close(ko, po, torch.bfloat16, f"flash_sfa block_skip {what}")[0])
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
        check(stats[1] > 0, f"flash_sfa block_skip {what}: no closed-form tile")
        print(f"[flash_sfa block_skip] {what} bf16: block_skip_stats "
              f"{tuple(round(x, 4) for x in stats)}; max|err| {errs[-1]:.3g}")
    _tc_only("flash_sfa block_skip bf16, d 32 / 128")
    qv, qi, kv, ki = inputs["random"]
    level = _skip_schedule(qv, qi, kv, ki, d=d, causal=True, block_q=BLOCK, block_k=BLOCK)
    pairs, closed = _skip_work(level)
    es = 2
    b_ms, b_by = bound(2 * bh * n * k * (es + 4) + 2 * bh * n * dv * es + bh * n * 4,
                       code_product_s(2 * k * pairs, 2 * d * pairs)
                       + 2 * dv * pairs / BF16_TC_FLOPS + 2 * dv * BLOCK * closed / F32_FLOPS)
    qd = _densify(qv, qi, d)[None]
    kd = _densify(kv, ki, d)[None]
    r = dict(max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True,
                          block_skip=True),
        lambda: flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True),
        lambda: F.scaled_dot_product_attention(qd, kd, v[None], is_causal=True, scale=scale)))
    print(f"[flash_sfa block_skip] random codes bh={bh} n={n}: {pairs} computed pairs, "
          f"{closed} closed-form tiles; library = SDPA on densified Q/K; {fmt(r)}")
    kernels, _ = trace_kernels(lambda: [flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale,
                                                  return_residuals=True, block_skip=True)
                                        for _ in range(20)])
    fwd_us = sum(us for name, us in kernels.items() if "tc_fwd_kernel" in name)
    pack_us = sum(us for name, us in kernels.items() if "pack_codes_kernel" in name)
    print(f"[flash_sfa block_skip] of the wrapper's device time per call, the tensor-core "
          f"kernel {fwd_us / 20e3:.4f} ms, the code pack {pack_us / 20e3:.4f} ms, the level "
          f"map and V row sums (torch) {(sum(kernels.values()) - fwd_us - pack_us) / 20e3:.4f} ms")
    qv, qi, kv, ki = inputs["banded"]
    skip_ms = device_ms(lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale,
                                          return_residuals=True, block_skip=True))
    full_ms = device_ms(lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale,
                                          return_residuals=True))
    print(f"[flash_sfa block_skip] banded codes: device ms per call, block skip {skip_ms} "
          f"against the plain schedule {full_ms}")
    return r


# --------------------------------------------------------------------------
# phase 3 at the qwen3 and llama shapes
# --------------------------------------------------------------------------

SHAPE_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms")
# qwen3-0.6b-sfa8's training step (batch 8 x 16 heads, 1024 tokens, d 128,
# k 8) and decode step (8 slots, 16 query heads over 8 kv heads, d 128);
# llama3.2-3b's compact seam (24 query heads, d 128, k 16, code width 32,
# m 3072, RoPE theta 500,000)
Q3 = dict(b=8, h=16, hkv=8, d=128, k=8)
LL = dict(b=8, h=24, hkv=8, d=128, k=16, m=3072, theta=500_000.0)
Q3_PAGED = dict(slots=8, h=8, heads=16, d=128, k=8, dv=128, page=128, mp=16)
# moonshot-v1-16b-a3b's training step (batch 8 x 16 heads, MHA, 1024
# tokens, d 128, k 16) and decode step (8 slots x 16 heads, MHA, d 128, k 16)
MS = dict(b=8, h=16, hkv=16, d=128, k=16)
MS_PAGED = dict(slots=8, h=16, heads=16, d=128, k=16, dv=128, page=128, mp=16)
# its RoPE compact seam (x 8 x 1024 x 2048, 16 heads, MHA, d 128, k 16: code
# width 32; RoPE theta 50,000)
MSS = dict(b=8, h=16, hkv=16, d=128, k=16, m=2048, theta=50_000.0)
# llama3-8b's RoPE compact seam (x 8 x 1024 x 4096, 32 query heads over 8
# kv heads of 128, k 16: code width 32; RoPE theta 500,000) and
# deepseek-7b's training step (batch 8 x 32 heads, MHA, 1024 tokens, d 128,
# k 16)
L8 = dict(b=8, h=32, hkv=8, d=128, k=16, m=4096, theta=500_000.0)
D7 = dict(b=8, h=32, hkv=32, d=128, k=16)


def _add_shape(results, name, label, r):
    """Record ``r`` as one more shape of kernel ``name``'s entry (the row's
    first shape, gpt2-small-sfa8's, beside it under "gpt2")."""
    row = results[name]
    shapes = row.setdefault("shapes", {})
    if not shapes:
        shapes["gpt2"] = {key: row[key] for key in SHAPE_KEYS}
    shapes[label] = {key: r[key] for key in SHAPE_KEYS}
    row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])


def _timed_shape(results, name, label, key, what, err, bytes_moved, op_s, kernel, plain,
                 library):
    """Time one shape of kernel ``name``, print it under ``label`` and record
    it as the shape ``key`` (None: the label) of its entry."""
    b_ms, b_by = bound(bytes_moved, op_s)
    r = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(kernel, plain, library))
    print(f"[{name}] {label}: {what}; {fmt(r)}")
    _add_shape(results, name, key or label, r)


def _rtopk_shape(results, rs, rows, d, k, label, key=None):
    """Row 1 on ``rows`` bf16 tie-heavy rows of d, one-thread body: exact
    against its plain version, timed beside it and topk + sort."""
    from repro_torch.kernels import body_counts, reset_launches, rtopk
    from repro_torch.kernels.ref import rtopk_ref
    es = 2
    x = torch.from_numpy(_tie_rows(rs, rows, d)).cuda().bfloat16()
    reset_launches()
    kv, ki = rtopk(x, k)
    check(body_counts()["rtopk_warp"] == 0, f"rtopk {label}: {body_counts()}")
    err = _rtopk_exact(x, k, kv, ki, label)

    def rtopk_library():
        _, i = torch.topk(x.abs(), k, dim=-1)
        i, _ = torch.sort(i, dim=-1)
        return x.gather(-1, i), i

    _timed_shape(results, "rtopk", f"{label} bfloat16", key,
                 f"bf16 rows={rows} d={d} k={k}, one-thread body: indices equal, values "
                 f"bit-equal; library = topk+sort", err, rows * d * es + rows * k * (es + 4),
                 rows * d / F32_FLOPS, lambda: rtopk(x, k), lambda: rtopk_ref(x, k),
                 rtopk_library)


def _sfa_train_rows(results, rs, s, label, key=None, dense=True, bwd=True):
    """Rows 1, 3, 5 (and with ``dense`` 7, 6; without ``bwd`` rows 1 and 3
    alone) at a model's training shape ``s`` (batch b x h heads, TRAIN_N
    tokens, d = dv, k), bf16: each against its plain version, timed beside
    it and its library call, the bound from these inputs; recorded as the
    shape ``key`` (default: the printed label) of each row's entry."""
    from repro_torch.kernels import (
        flash_attention, flash_attention_bwd, flash_sfa, flash_sfa_bwd, reset_launches,
    )
    from repro_torch.kernels.ref import (
        flash_attention_bwd_ref, flash_attention_ref, flash_sfa_bwd_ref, flash_sfa_ref,
    )
    es = 2
    b, h, d, k = s["b"], s["h"], s["d"], s["k"]
    bh, n, dv, scale = b * h, TRAIN_N, d, d ** -0.5
    _rtopk_shape(results, rs, bh * n, d, k, label, key)
    reset_launches()
    qv, qi, kv, ki = _codes_of(rs, bh, n, d, k, torch.bfloat16)
    v, g = (torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().bfloat16()
            for _ in range(2))
    ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True)
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True)
    torch.cuda.synchronize()
    err = _close(ko, po, torch.bfloat16, f"flash_sfa {label}")[0]
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
    args = (qv, qi, kv, ki, v, ko, kl, g)
    if bwd:
        got = flash_sfa_bwd(*args, d=d, scale=scale)
        want = flash_sfa_bwd_ref(*args, d=d, scale=scale)
        torch.cuda.synchronize()
        berr = max(_close(a, w, torch.bfloat16, f"flash_sfa_bwd {nm} {label}")[0]
                   for nm, a, w in zip(("dq", "dk", "dv"), got, want))
        del got, want
    _tc_only(f"flash_sfa {label}")
    del po, pl
    qd = _densify(qv, qi, d)
    kd = _densify(kv, ki, d)
    pairs = _pairs(bh, n)
    _timed_shape(results, "flash_sfa", label, key,
                 f"bh={bh} n={n} d=dv={d} k={k} bf16 (tensor-core body): max|err| {err:.3g}; "
                 f"library = SDPA on densified Q/K", err,
                 2 * bh * n * k * (es + 4) + 2 * bh * n * dv * es + bh * n * 4,
                 code_product_s(2 * k * pairs, 2 * d * pairs) + 2 * dv * pairs / BF16_TC_FLOPS,
                 lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, return_residuals=True),
                 lambda: flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale,
                                       return_residuals=True),
                 lambda: F.scaled_dot_product_attention(
                     qd.reshape(b, h, n, d), kd.reshape(b, h, n, d), v.reshape(b, h, n, dv),
                     is_causal=True, scale=scale))
    if bwd:
        _timed_shape(results, "flash_sfa_bwd", label, key,
                     f"dense emit, bh={bh} n={n} d=dv={d} k={k} bf16 (tensor-core body): max|err| "
                     f"{berr:.3g}; library = SDPA backward (autograd) on densified Q/K", berr,
                     2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                     + 2 * bh * n * d * es + bh * n * dv * es,
                     code_product_s(6 * k * pairs, 6 * d * pairs) + 4 * dv * pairs / BF16_TC_FLOPS,
                     lambda: flash_sfa_bwd(*args, d=d, scale=scale),
                     lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale),
                     _sdpa_bwd(qd, kd, v, g, scale))
    del qd, kd, args
    if dense:
        q, kk = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().bfloat16()
                 for _ in range(2))
        ko, kl = flash_attention(q, kk, v, scale=scale, return_residuals=True)
        po, pl = flash_attention_ref(q, kk, v, scale=scale, return_residuals=True)
        got = flash_attention_bwd(q, kk, v, po, pl, g, scale=scale)
        want = flash_attention_bwd_ref(q, kk, v, po, pl, g, scale=scale)
        torch.cuda.synchronize()
        ferr = _close(ko, po, torch.bfloat16, f"flash_attention {label}")[0]
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
        berr = max(_close(a, w, torch.bfloat16, f"flash_attention_bwd {nm} {label}")[0]
                   for nm, a, w in zip(("dq", "dk", "dv"), got, want))
        del got, want
        _timed_shape(results, "flash_attention", label, key,
                     f"bh={bh} n={n} d={d} bf16: max|err| {ferr:.3g}; library = SDPA", ferr,
                     4 * bh * n * d * es + bh * n * 4, 4 * d * pairs / BF16_TC_FLOPS,
                     lambda: flash_attention(q, kk, v, scale=scale, return_residuals=True),
                     lambda: flash_attention_ref(q, kk, v, scale=scale, return_residuals=True),
                     lambda: F.scaled_dot_product_attention(
                         q.reshape(b, h, n, d), kk.reshape(b, h, n, d), v.reshape(b, h, n, d),
                         is_causal=True, scale=scale))
        _timed_shape(results, "flash_attention_bwd", label, key,
                     f"bh={bh} n={n} d={d} bf16: max|err| {berr:.3g}; library = SDPA backward "
                     f"(autograd)", berr, 8 * bh * n * d * es + bh * n * 4,
                     10 * d * pairs / BF16_TC_FLOPS,
                     lambda: flash_attention_bwd(q, kk, v, po, pl, g, scale=scale),
                     lambda: flash_attention_bwd_ref(q, kk, v, po, pl, g, scale=scale),
                     _sdpa_bwd(q, kk, v, g, scale))
        del q, kk, po, pl
    del v, g, ko, kl
    torch.cuda.empty_cache()


def _sfa_decode_rows(results, rs, s, c, label, key=None, timed=(10, 11, 12, 13, 14)):
    """Rows 10-14 at a model's decode step: ``s``
    (b slots, h query heads over hkv kv heads, d = dv, k), ``c`` its paged
    pools (pages of c["page"], c["mp"] a slot), bf16 caches of up to 2048
    tokens a slot: each against its plain version and in its bit-equalities,
    the rows in ``timed`` timed beside their plain version and SDPA on the
    densified cache (heads expanded), the bound from these inputs; recorded
    as the shape ``key`` (default: the label)."""
    from repro_torch.kernels import (
        flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
        flash_sfa_decode_multi, flash_sfa_decode_paged, rtopk, topk_dense,
    )
    from repro_torch.kernels.ref import (
        _pool_view, flash_sfa_decode_fm_paged_ref, flash_sfa_decode_fm_ref,
        flash_sfa_decode_multi_ref, flash_sfa_decode_paged_ref, flash_sfa_decode_ref,
    )
    es = 2
    b, h, hkv, d, k = s["b"], s["h"], s["hkv"], s["d"], s["k"]
    dv, scale, group, n_max = d, d ** -0.5, s["h"] // s["hkv"], 2048
    lengths = rs.randint(64, n_max + 1, size=b)
    lens = torch.from_numpy(np.repeat(lengths, h).astype(np.int32)).cuda()
    caches = []
    for _ in range(4):
        kdn = torch.from_numpy(rs.randn(b, n_max, hkv, d).astype(np.float32)).cuda()
        kv, ki = rtopk(kdn.bfloat16(), k)
        v = torch.from_numpy(rs.randn(b, n_max, hkv, dv).astype(np.float32)).cuda().bfloat16()
        caches.append((kv, ki.to(torch.uint8), v))
    q = topk_dense(torch.from_numpy(rs.randn(b * h, d).astype(np.float32)).cuda(), k)
    bl = torch.from_numpy(np.repeat(_boundary_lengths(n_max, b), h)).cuda()
    err = 0.0
    for ll in (lens, bl):
        err = max(err, _close_rows(flash_sfa_decode(q, *caches[0], ll, d=d, scale=scale),
                                   flash_sfa_decode_ref(q, *caches[0], ll, d=d, scale=scale), ll,
                                   f"flash_sfa_decode {label}"))
    dense = [(_densify(kv_, ki_, d).permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous(),
              v_.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous())
             for kv_, ki_, v_ in caches]
    mask = (torch.arange(n_max, device="cuda")[None, :]
            < torch.from_numpy(lengths).cuda()[:, None])[:, None, None, :]
    qb = q.bfloat16().reshape(b, h, 1, d)
    tokens = int(lengths.sum())
    if 10 in timed:
        _timed_shape(results, "flash_sfa_decode", label, key,
                     f"b={b} h={h} over hkv={hkv} n_max={n_max} lengths={lengths.tolist()} (and run "
                     f"boundaries, a zero-length row 0) k={k} d=dv={d}: max|err| {err:.3g} (tol "
                     f"1e-4); library = SDPA on the densified cache, heads expanded", err,
                     tokens * hkv * (k * (es + 1) + dv * es) + b * h * (d + dv) * 4,
                     code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
                     + tokens * h * 2 * dv / F32_FLOPS,
                     _cycle([lambda i=i: flash_sfa_decode(q, *caches[i], lens, d=d, scale=scale)
                             for i in range(4)]),
                     _cycle([lambda i=i: flash_sfa_decode_ref(q, *caches[i], lens, d=d, scale=scale)
                             for i in range(4)]),
                     _cycle([lambda i=i: F.scaled_dot_product_attention(
                         qb, dense[i][0], dense[i][1], attn_mask=mask, scale=scale)
                         for i in range(4)]))
    del caches, dense
    pools, bt, plen = _paged_pools(rs, torch.bfloat16, c=c)
    plens = torch.from_numpy(plen.astype(np.int32)).cuda()
    q = topk_dense(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32)).cuda(), k)
    C, slot = 5, 2
    start = int(min(plen[slot], c["mp"] * c["page"])) - C
    qm = topk_dense(torch.from_numpy(rs.randn(C * h, d).astype(np.float32)).cuda(), k)
    lm, errs = _check_paged_multi(q, qm, pools[0], bt, plens, slot, start, label, c=c)
    n_all = c["mp"] * c["page"]
    eff = np.minimum(plen, n_all)
    tokens = int(eff.sum())
    mask = (torch.arange(n_all, device="cuda")[None, :]
            < torch.from_numpy(eff).cuda()[:, None])[:, None, None, :]
    dense = []
    for p in (pools if 11 in timed or 12 in timed else []):
        kdn = _densify(_pool_view(p["kv"], bt), _pool_view(p["ki"], bt), d)
        dense.append((kdn.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous(),
                      _pool_view(p["v"], bt).permute(0, 2, 1, 3).repeat_interleave(group, 1)
                      .contiguous()))
    qb = q.bfloat16().reshape(c["slots"], h, 1, d)
    if 11 in timed:
        _timed_shape(results, "flash_sfa_decode_paged", label, key,
                     f"slots {c['slots']} x h {h} over hkv {hkv}, pages of {c['page']}, lengths "
                     f"{eff.tolist()}: max|err| {errs[0]:.3g}; library = SDPA on the densified "
                     f"gathered cache, heads expanded", errs[0],
                     tokens * hkv * (k * (es + 1) + dv * es) + c["slots"] * h * (d + dv) * 4,
                     code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
                     + tokens * h * 2 * dv / F32_FLOPS,
                     _cycle([lambda p=p: flash_sfa_decode_paged(
                         q, p["kv"], p["ki"], p["v"], bt, plens, d=d, heads=h) for p in pools]),
                     _cycle([lambda p=p: flash_sfa_decode_paged_ref(
                         q, p["kv"], p["ki"], p["v"], bt, plens, d=d, heads=h) for p in pools]),
                     _cycle([lambda i=i: F.scaled_dot_product_attention(
                         qb, dense[i][0], dense[i][1], attn_mask=mask, scale=scale)
                         for i in range(len(pools))]))
    if 12 in timed:
        # row 12: the C verify queries of one slot, against SDPA on the slot's
        # densified view with the per-query length mask
        L = start + C
        smask = (torch.arange(n_all, device="cuda")[None, :] < lm[::h, None])[None, None]
        qmb = qm.bfloat16().reshape(C, h, d).transpose(0, 1)[None]
        _timed_shape(results, "flash_sfa_decode_multi", label, key,
                     f"one slot, C {C} queries x {h} heads over {hkv} kv head(s) at lengths "
                     f"{start + 1}..{L}: max|err| {errs[1]:.3g}; library = SDPA on the slot's "
                     f"densified view, heads expanded; the bound counts the slot's cache once",
                     errs[1], L * hkv * (k * (es + 1) + dv * es) + C * h * (d + dv) * 4,
                     code_product_s(C * L * h * 2 * k, C * L * h * 2 * d)
                     + C * L * h * 2 * dv / F32_FLOPS,
                     _cycle([lambda p=p: flash_sfa_decode_multi(
                         qm, p["kv"], p["ki"], p["v"], lm, d=d, heads=h, block_tables=bt, slot=slot)
                         for p in pools]),
                     _cycle([lambda p=p: flash_sfa_decode_multi_ref(
                         qm, p["kv"], p["ki"], p["v"], lm, d=d, heads=h, block_tables=bt, slot=slot)
                         for p in pools]),
                     _cycle([lambda i=i: F.scaled_dot_product_attention(
                         qmb, dense[i][0][slot:slot + 1], dense[i][1][slot:slot + 1],
                         attn_mask=smask, scale=scale) for i in range(len(pools))]))
    del dense
    btl = bt.long()
    imgs = [(p["kf"][:, btl].permute(1, 0, 3, 2, 4).reshape(-1, d, n_all).contiguous(),
             p["v"][:, btl].transpose(0, 1).reshape(-1, n_all, dv).contiguous()) for p in pools]
    qv, qi = rtopk(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32))
                   .cuda().bfloat16(), k)
    rlens = plens.repeat_interleave(h)
    fo = flash_sfa_decode_fm(qv, qi, *imgs[0], rlens, group=group)
    e13 = _close_rows(fo, flash_sfa_decode_fm_ref(qv, qi, *imgs[0], rlens, group=group), rlens,
                      f"flash_sfa_decode_fm {label}")
    ko = flash_sfa_decode_fm_paged(qv, qi, pools[0]["kf"], pools[0]["v"], bt, plens, heads=h)
    e14 = _close_rows(ko, flash_sfa_decode_fm_paged_ref(qv, qi, pools[0]["kf"], pools[0]["v"],
                                                        bt, plens, heads=h), rlens,
                      f"flash_sfa_decode_fm_paged {label}")
    check(torch.equal(ko, fo), f"flash_sfa_decode_fm_paged {label}: not bit-equal to "
                               f"flash_sfa_decode_fm on the gathered image")
    lib_in = [(kf.reshape(c["slots"], hkv, d, n_all).transpose(2, 3).repeat_interleave(group, 1)
               .contiguous(), vv.reshape(c["slots"], hkv, n_all, dv).repeat_interleave(group, 1)
               .contiguous()) for kf, vv in imgs]
    qd = _densify(qv, qi, d).reshape(c["slots"], h, 1, d)
    lib = _cycle([lambda i=i: F.scaled_dot_product_attention(
        qd, lib_in[i][0], lib_in[i][1], attn_mask=mask, scale=scale) for i in range(len(pools))])
    fm_bytes = tokens * (h * k * es + hkv * dv * es) + c["slots"] * h * (k * 8 + dv * 4)
    fm_ops = (code_product_s(tokens * h * 2 * k, tokens * h * 2 * d)
              + tokens * h * 2 * dv / F32_FLOPS)
    if 13 in timed:
        _timed_shape(results, "flash_sfa_decode_fm", label, key,
                     f"rows {c['slots'] * h} in groups of {group}, image (rows / {group}, d {d}, n "
                     f"{n_all}) bf16: max|err| {e13:.3g}; library = SDPA on the image's dense K, "
                     f"heads expanded", e13, fm_bytes, fm_ops,
                     _cycle([lambda i=i: flash_sfa_decode_fm(qv, qi, *imgs[i], rlens, group=group)
                             for i in range(len(pools))]),
                     _cycle([lambda i=i: flash_sfa_decode_fm_ref(qv, qi, *imgs[i], rlens,
                                                                 group=group)
                             for i in range(len(pools))]), lib)
    if 14 in timed:
        _timed_shape(results, "flash_sfa_decode_fm_paged", label, key,
                     f"the same through (hkv {hkv}, P, d, {c['page']}) pools, heads {h}: max|err| "
                     f"{e14:.3g}, bit-equal to flash_sfa_decode_fm on the gathered image", e14,
                     fm_bytes, fm_ops,
                     _cycle([lambda p=p: flash_sfa_decode_fm_paged(
                         qv, qi, p["kf"], p["v"], bt, plens, heads=h) for p in pools]),
                     _cycle([lambda p=p: flash_sfa_decode_fm_paged_ref(
                         qv, qi, p["kf"], p["v"], bt, plens, heads=h) for p in pools]), lib)
    del pools, imgs, lib_in
    torch.cuda.empty_cache()


def phase_qwen3_llama_shapes(results):
    """Rows 1, 3, 5, 6, 7 at qwen3's training shape, rows 10-14 at its
    decode shape (GQA, a group of 2), rows 2, 4, 8, 9 at llama's seam shape
    (k 16: code width 32, code_grad on its tensor-core bodies): each against
    its plain version with the tolerance of its gpt2 check, timed beside
    its plain version and its library call, and the bound from these
    inputs. The d 128 kernels' ptxas registers first."""
    for lib in ("flash_attention", "flash_sfa_tc", "flash_sfa_bwd", "proj_rtopk", "code_grad"):
        regs = ptxas_kernels(lib)
        print(f"[ptxas] {lib}: " + "; ".join(
            f"{fn[:60]} {r} regs" + ("" if sp.startswith("0 bytes stack frame, 0 ") or not sp
                                    else f" ({sp})") for fn, (r, sp) in regs.items()))
    rs = np.random.RandomState(SEED + 30)
    _sfa_train_rows(results, rs, Q3, "qwen3 training")
    _sfa_decode_rows(results, rs, Q3, Q3_PAGED, "qwen3 decode")
    _seam_rows(results, rs, LL, "llama seam")


def _seam_rows(results, rs, s, label, key=None, compact2=False):
    """Rows 2, 4, 8, 9 (with ``compact2`` also row 5's compact2 emit) at a
    model's compact seam ``s`` (batch b x n TRAIN_N tokens of width m, h
    query heads over hkv kv heads of d, k; RoPE at theta where ``s`` has
    one; causal unless ``s["causal"]`` is False; code width ``s["kw"]``,
    default the RoPE pair closure's 2k), bf16 on the tensor-core bodies:
    each against its plain version (row 2 also bit-equal on dyadic inputs,
    bf16 and f32, for the query and the key heads), timed beside its plain
    version and its library call, the bound from these inputs; rows 4, 8
    and 9 also in f32 (their CUDA-core bodies) on a slice; recorded as the
    shape ``key`` (default: ``label``) of each row's entry."""
    from repro_torch.kernels import (
        body_counts, code_grad_dw, code_grad_dx, flash_sfa, flash_sfa_bwd, proj_rtopk,
        reset_launches,
    )
    from repro_torch.kernels.flash_sfa import BLOCK, _skip_schedule
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.kernels.ref import (
        code_grad_dw_ref, code_grad_dx_ref, flash_sfa_bwd_ref, flash_sfa_ref, proj_rtopk_ref,
        scatter_code_grads,
    )
    es, n = 2, TRAIN_N
    b, h, hkv, d, k, m = s["b"], s["h"], s["hkv"], s["d"], s["k"], s["m"]
    causal, kw = s.get("causal", True), s.get("kw", 2 * k)
    bh, scale = b * h, d ** -0.5
    spec = (s["theta"], d) if "theta" in s else None
    rope_txt = f"RoPE theta {spec[0]:g}" if spec else "no RoPE"
    pos = torch.arange(n, device="cuda")[None, :].expand(b, n) if spec else None
    x, w = _dyadic_proj(rs, b, n, m, (h + 2 * hkv) * d)
    for heads, wh in (("query", head_blocks(w, 0, h, d)), ("key", head_blocks(w, h, hkv, d))):
        reset_launches()
        kv, ki = proj_rtopk(x.bfloat16(), wh, pos, k=k, rope_spec=spec)
        pv, pi = proj_rtopk_ref(x.bfloat16(), wh, pos, k=k, rope_spec=spec)
        torch.cuda.synchronize()
        check(body_counts()["proj_rtopk_cuda_core"] == 0,
              f"proj_rtopk {label} {heads}: {body_counts()}")
        check(torch.equal(ki, pi) and torch.equal(kv.view(torch.int16), pv.view(torch.int16)),
              f"proj_rtopk {label} {heads}: dyadic inputs ({rope_txt}) not bit-equal to the "
              f"plain version")
        # f32 x (the CUDA-core body, which the f32 gradient check runs), 2 of the 8 rows
        x2, p2 = x[:2].contiguous(), None if pos is None else pos[:2]
        kv, ki = proj_rtopk(x2, wh, p2, k=k, rope_spec=spec)
        pv, pi = proj_rtopk_ref(x2, wh, p2, k=k, rope_spec=spec)
        torch.cuda.synchronize()
        check(body_counts()["proj_rtopk_cuda_core"] == 1,
              f"proj_rtopk {label} {heads} f32: {body_counts()}")
        check(torch.equal(ki, pi) and torch.equal(kv.view(torch.int32), pv.view(torch.int32)),
              f"proj_rtopk {label} {heads} f32: dyadic inputs ({rope_txt}) not bit-equal to "
              f"the plain version")
    print(f"[proj_rtopk] {label}: dyadic x ({b}, {n}, {m}) bf16 (tensor-core body) and (2, {n}, "
          f"{m}) f32 (CUDA-core body), {h} query and {hkv} key heads of {d}, {rope_txt}, k "
          f"{k}: indices equal, values bit-equal to the plain version")
    del x, w, x2, kv, ki, pv, pi
    w = (0.02 * torch.from_numpy(rs.randn(m, (h + 2 * hkv) * d).astype(np.float32))).cuda()
    wq = head_blocks(w, 0, h, d)
    xb = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).cuda().bfloat16()
    rows = b * h * n

    def proj_library():
        y = torch.matmul(xb, w[:, :h * d].bfloat16()).reshape(b, n, h, d)
        _, i = torch.topk(y.abs(), k, dim=-1)
        return i

    _timed_shape(results, "proj_rtopk", label, key,
                 f"bf16 x {tuple(xb.shape)}, {h} heads of {d}, {rope_txt}, k={k} "
                 f"(tensor-core body; dyadic inputs bit-equal to the plain version); library = "
                 f"torch.matmul + torch.topk", 0.0,
                 b * n * m * es + m * h * d * 4 + rows * k * (es + 4),
                 max(2 * b * n * m * h * d / BF16_TC_FLOPS, rows * d / F32_FLOPS),
                 lambda: proj_rtopk(xb, wq, pos, k=k, rope_spec=spec),
                 lambda: proj_rtopk_ref(xb, wq, pos, k=k, rope_spec=spec), proj_library)
    qv, qi, kv, ki = _codes_of(rs, bh, n, d, k, torch.bfloat16)
    v = torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().bfloat16()
    reset_launches()
    ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                       return_residuals=True, block_skip=True)
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                           return_residuals=True)
    torch.cuda.synchronize()
    err = _close(ko, po, torch.bfloat16, f"flash_sfa block_skip {label}")[0]
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
    _tc_only(f"flash_sfa block_skip {label}")
    del po, pl
    # f32 on the CUDA-core body, 2 of the batch's rows of heads
    f32 = [t[:2 * h].float() if t.is_floating_point() else t[:2 * h]
           for t in (qv, qi, kv, ki, v)]
    reset_launches()
    fo, fl = flash_sfa(*f32, d=d, causal=causal, scale=scale, return_residuals=True,
                       block_skip=True)
    po, pl = flash_sfa_ref(*f32, d=d, causal=causal, scale=scale, return_residuals=True)
    torch.cuda.synchronize()
    check(body_counts()["flash_sfa_cuda_core"] == 1, f"flash_sfa block_skip {label} f32: "
                                                     f"{body_counts()}")
    ferr = _close(fo, po, torch.float32, f"flash_sfa block_skip {label} f32")[0]
    torch.testing.assert_close(fl, pl, rtol=1e-5, atol=1e-4)
    del f32, fo, fl, po, pl
    level = _skip_schedule(qv, qi, kv, ki, d=d, causal=causal, block_q=BLOCK, block_k=BLOCK)
    pairs, closed = _skip_work(level, causal)
    qd, kd = _densify(qv, qi, d), _densify(kv, ki, d)
    _timed_shape(results, "flash_sfa_block_skip", label, key,
                 f"rtopk codes bh={bh} n={n} d=dv={d} k={k} bf16, "
                 f"{'causal' if causal else 'bidirectional'}: max|err| {err:.3g} (f32 on the "
                 f"CUDA-core body, bh {2 * h}: {ferr:.3g}); {pairs} computed pairs, {closed} "
                 f"closed-form tiles; library = SDPA on densified Q/K",
                 err, 2 * bh * n * k * (es + 4) + 2 * bh * n * d * es + bh * n * 4,
                 code_product_s(2 * k * pairs, 2 * d * pairs) + 2 * d * pairs / BF16_TC_FLOPS
                 + 2 * d * BLOCK * closed / F32_FLOPS,
                 lambda: flash_sfa(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                                   return_residuals=True, block_skip=True),
                 lambda: flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                                       return_residuals=True),
                 lambda: F.scaled_dot_product_attention(
                     qd.reshape(b, h, n, d), kd.reshape(b, h, n, d), v.reshape(b, h, n, d),
                     is_causal=causal, scale=scale))
    if compact2:
        g = torch.from_numpy(rs.randn(bh, n, d).astype(np.float32)).cuda().bfloat16()
        args = (qv, qi, kv, ki, v, ko, kl, g)
        reset_launches()
        got = flash_sfa_bwd(*args, d=d, scale=scale, emit="compact2", rot_dim=d)
        want = flash_sfa_bwd_ref(*args, d=d, scale=scale, emit="compact2", rot_dim=d)
        torch.cuda.synchronize()
        berr = max(_close(a, w_, torch.bfloat16, f"flash_sfa_bwd compact2 {nm} {label}")[0]
                   for nm, a, w_ in zip(("dq", "dk", "dv"), got, want))
        _tc_only(f"flash_sfa_bwd compact2 {label}")
        del got, want
        pairs = _pairs(bh, n)
        _timed_shape(results, "flash_sfa_bwd_compact", label, key,
                     f"compact2 emit (rot_dim {d}: code width {2 * k}), bh={bh} n={n} d=dv={d} "
                     f"k={k} bf16, on the block-skip forward's output (tensor-core body): "
                     f"max|err| {berr:.3g}; library = SDPA backward (autograd) on densified Q/K",
                     berr, 2 * bh * n * k * (es + 4) + 3 * bh * n * d * es + bh * n * 4
                     + 2 * bh * n * 2 * k * es + bh * n * d * es,
                     code_product_s(6 * k * pairs, 6 * d * pairs) + 4 * d * pairs / BF16_TC_FLOPS,
                     lambda: flash_sfa_bwd(*args, d=d, scale=scale, emit="compact2", rot_dim=d),
                     lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale, emit="compact2",
                                               rot_dim=d),
                     _sdpa_bwd(qd, kd, v, g, scale))
        del g, args
    del qv, qi, kv, ki, v, qd, kd, level
    torch.cuda.empty_cache()
    ntok = b * n
    vals = torch.from_numpy(rs.randn(h, ntok, kw).astype(np.float32)).cuda().bfloat16()
    idx = torch.from_numpy(np.sort(np.argsort(rs.rand(h, ntok, d), -1)[..., :kw], -1)
                           .astype(np.int32)).cuda()
    idx[:, 3::7, 1] = idx[:, 3::7, 0]          # duplicates sum (pair closures)
    xx = xb.reshape(ntok, m)
    reset_launches()
    got = (code_grad_dx(vals, idx, wq, d=d), code_grad_dw(xx, vals, idx, d=d))
    check(body_counts()["code_grad_dx_cuda_core"] == body_counts()["code_grad_dw_cuda_core"] == 0,
          f"code_grad {label} (width {kw}): not the tensor-core bodies {body_counts()}")
    want = (code_grad_dx_ref(vals, idx, wq, d=d), code_grad_dw_ref(xx, vals, idx, d=d))
    torch.cuda.synchronize()
    cerr = {}
    for nm, a, bb in zip(("dx", "dw"), got, want):
        torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-4 * bb.abs().max().item(),
                                   msg=f"code_grad {nm} {label}")
        cerr[nm] = (a - bb).abs().max().item()
    del got, want
    # f32 codes (the CUDA-core bodies), the first 2,048 tokens
    v32, i32, x32 = vals[:, :2048].float(), idx[:, :2048].contiguous(), xx[:2048].float()
    reset_launches()
    got = (code_grad_dx(v32, i32, wq, d=d), code_grad_dw(x32, v32, i32, d=d))
    check(body_counts()["code_grad_dx_cuda_core"] == body_counts()["code_grad_dw_cuda_core"] == 1,
          f"code_grad {label} f32: not the CUDA-core bodies {body_counts()}")
    want = (code_grad_dx_ref(v32, i32, wq, d=d), code_grad_dw_ref(x32, v32, i32, d=d))
    torch.cuda.synchronize()
    for nm, a, bb in zip(("dx", "dw"), got, want):
        torch.testing.assert_close(a, bb, rtol=1e-4, atol=1e-4 * bb.abs().max().item(),
                                   msg=f"code_grad {nm} {label} f32")
    del got, want, v32, i32, x32
    ops_s = code_product_s(2 * ntok * m * h * kw, 2 * ntok * m * h * d)
    codes = h * ntok * kw * (es + 4)
    _timed_shape(results, "code_grad_dx", label, key,
                 f"bf16 codes {h} x {ntok} x {kw}, m {m}, d {d} (tensor-core body, width {kw}; "
                 f"f32 codes on the CUDA-core body within 1e-4): max|err| {cerr['dx']:.3g}; "
                 f"library = scatter_code_grads + torch.einsum",
                 cerr["dx"], codes + h * m * d * 4 + ntok * m * 4, ops_s,
                 lambda: code_grad_dx(vals, idx, wq, d=d),
                 lambda: code_grad_dx_ref(vals, idx, wq, d=d),
                 lambda: torch.einsum("hnd,hmd->nm", scatter_code_grads(vals, idx, d).float(),
                                      wq))
    _timed_shape(results, "code_grad_dw", label, key,
                 f"the same codes, x ({ntok}, {m}) bf16 (tensor-core body): max|err| "
                 f"{cerr['dw']:.3g}; library = scatter_code_grads + torch.einsum", cerr["dw"],
                 codes + ntok * m * es + h * m * d * 4, ops_s,
                 lambda: code_grad_dw(xx, vals, idx, d=d),
                 lambda: code_grad_dw_ref(xx, vals, idx, d=d),
                 lambda: torch.einsum("nm,hnd->hmd", xx.float(),
                                      scatter_code_grads(vals, idx, d).float()))
    torch.cuda.empty_cache()


def phase_moonshot_shapes(results):
    """Rows 1, 3, 5 at moonshot-v1-16b-a3b's training shape and rows 10-14
    at its decode shape (MHA, k 16), each recorded as the shape "MS" of its
    row's entry; then rows 2, 4, 5 (compact2), 8 and 9 at its RoPE compact
    seam, the shape "MSs"."""
    rs = np.random.RandomState(SEED + 40)
    _sfa_train_rows(results, rs, MS, "MS training", key="MS", dense=False)
    _sfa_decode_rows(results, rs, MS, MS_PAGED, "MS decode", key="MS")
    _seam_rows(results, rs, MSS, "MSs seam", key="MSs", compact2=True)


def phase_llama8b_deepseek_shapes(results):
    """Rows 2, 4, 8 and 9 at llama3-8b's RoPE compact seam (``L8``: code
    width 32, code_grad on its tensor-core bodies) and rows 1, 3 and 5 at
    deepseek-7b's training shape (``D7``: bh 8 x 32, d 128, k 16), each
    against its plain version, timed beside it and its library call, the
    bound from these inputs; the shapes "L8" and "D7" of their rows."""
    rs = np.random.RandomState(SEED + 70)
    _seam_rows(results, rs, L8, "L8 seam", key="L8")
    _sfa_train_rows(results, rs, D7, "D7 training", key="D7", dense=False)


# hubert-xlarge's training step (batch 8 x 16 heads, 1024 frames, d = dv 80,
# k 16, bidirectional); paligemma-3b's prefill (8 query heads over 1 kv head,
# 256 patches + 768 prompt tokens, d = dv 256, k 16) and decode step (8 slots
# x 8 query heads over 1 kv head, pages of 128)
HB = dict(b=8, h=16, hkv=16, d=80, k=16, n=TRAIN_N)
PG = dict(b=1, h=8, hkv=1, d=256, k=16, n=1024)
PG_DECODE = dict(b=8, h=8, hkv=1, d=256, k=16)
PG_PAGED = dict(slots=8, h=1, heads=8, d=256, k=16, dv=256, page=128, mp=16)


def _frontend_rows(results, rs, s, label, key, *, causal, bwd, f32_key=None):
    """Rows 1, 3 (and with ``bwd`` 5) at a frontend model's shape ``s`` (b x
    h heads, s["n"] tokens, d = dv, k), where rtopk runs its warp body and
    FlashSFA its tensor-core bodies in bf16 (d 80 in 96-column tiles, d 256
    with two warpgroups a block) and its CUDA-core bodies in f32 (the
    backward at dv 256 on 32-row tiles): each in f32 and bf16 against its
    plain version (row 3 with the other mask too; row 5 with every emit),
    the bf16 calls timed beside their plain versions and library calls with
    the bound from these inputs, recorded as the shape ``key`` of each
    row's entry; with ``f32_key`` row 5's f32 dense emit too, under that
    key, its bound the f32 operations on the CUDA cores (f32 on the tensor
    cores would be TF32) and its library call SDPA's f32 backward."""
    from repro_torch.kernels import (
        body_counts, flash_sfa, flash_sfa_bwd, reset_launches, rtopk,
    )
    from repro_torch.kernels.ref import flash_sfa_bwd_ref, flash_sfa_ref, rtopk_ref
    b, h, d, k, n = s["b"], s["h"], s["d"], s["k"], s["n"]
    bh, dv, scale = b * h, d, d ** -0.5
    rows = bh * n
    pairs = _pairs(bh, n) if causal else bh * n * n
    mask = "causal" if causal else "bidirectional"
    for dtype in (torch.float32, torch.bfloat16):
        es = 2 if dtype == torch.bfloat16 else 4
        tc = dtype == torch.bfloat16
        body = "tensor-core body" if tc else "CUDA-core body"
        x = torch.from_numpy(_tie_rows(rs, rows, d)).cuda().to(dtype)
        reset_launches()
        kv, ki = rtopk(x, k)
        check(body_counts()["rtopk_warp"] == 1, f"rtopk {label}: {body_counts()}")
        err = _rtopk_exact(x, k, kv, ki, f"{label} {dtype}")
        print(f"[rtopk] {label} {dtype} rows={rows} d={d} k={k}, warp body: indices equal, "
              f"values bit-equal")
        if dtype == torch.bfloat16:
            def rtopk_library(x=x):
                _, i = torch.topk(x.abs(), k, dim=-1)
                i, _ = torch.sort(i, dim=-1)
                return x.gather(-1, i), i

            _timed_shape(results, "rtopk", f"{label} bfloat16", key,
                         f"bf16 rows={rows} d={d} k={k}, warp body: indices equal, values "
                         f"bit-equal; library = topk+sort", err,
                         rows * d * es + rows * k * (es + 4), rows * d / F32_FLOPS,
                         lambda: rtopk(x, k), lambda: rtopk_ref(x, k), rtopk_library)
        del x, kv, ki
        qv, qi, kv, ki = _codes_of(rs, bh, n, d, k, dtype)
        v, g = (torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().to(dtype)
                for _ in range(2))
        reset_launches()
        ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, causal=causal,
                           return_residuals=True)
        po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale, causal=causal,
                               return_residuals=True)
        oo = flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, causal=not causal)
        op = flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale, causal=not causal)
        torch.cuda.synchronize()
        err = _close(ko, po, dtype, f"flash_sfa {label} {dtype}")[0]
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
        oerr = _close(oo, op, dtype, f"flash_sfa {label} {dtype} (the other mask)")[0]
        check(body_counts()["flash_sfa_cuda_core"] == (0 if tc else 2),
              f"flash_sfa {label} {dtype}: not the {body} {body_counts()}")
        print(f"[flash_sfa] {label} {dtype} bh={bh} n={n} d=dv={d} k={k} ({body}): "
              f"{mask} max|err| {err:.3g}, LSE within 1e-5 + 1e-4; the other mask max|err| "
              f"{oerr:.3g}")
        del oo, op, po, pl
        args = (qv, qi, kv, ki, v, ko, kl, g)
        if bwd:
            for emit in ("dense", "compact", "compact2"):
                reset_launches()
                got = flash_sfa_bwd(*args, d=d, scale=scale, causal=causal, emit=emit)
                want = flash_sfa_bwd_ref(*args, d=d, scale=scale, causal=causal, emit=emit)
                torch.cuda.synchronize()
                e = max(_close(a, w, dtype, f"flash_sfa_bwd {emit} {nm} {label} {dtype}")[0]
                        for nm, a, w in zip(("dq", "dk", "dv"), got, want))
                check(body_counts()["flash_sfa_bwd_cuda_core"] == (0 if tc else 1),
                      f"flash_sfa_bwd {label} {dtype}: not the {body} {body_counts()}")
                print(f"[flash_sfa_bwd] {label} {dtype} {emit} emit, {mask} ({body}): "
                      f"max|err| {e:.3g}")
                if emit == "dense":
                    berr = e
                del got, want
        if bwd and f32_key and not tc:
            qd, kd = _densify(qv, qi, d), _densify(kv, ki, d)
            _timed_shape(results, "flash_sfa_bwd", f"{label} f32", f32_key,
                         f"dense emit, bh={bh} n={n} d=dv={d} k={k} {mask} f32 ({body}): "
                         f"max|err| {berr:.3g}; library = SDPA's f32 backward (autograd) on "
                         f"densified Q/K", berr,
                         2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                         + 2 * bh * n * d * es + bh * n * dv * es,
                         (6 * k + 4 * dv) * pairs / F32_FLOPS,
                         lambda: flash_sfa_bwd(*args, d=d, scale=scale, causal=causal),
                         lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale, causal=causal),
                         _sdpa_bwd(qd, kd, v, g, scale, causal))
            del qd, kd
        if dtype == torch.bfloat16:
            qd, kd = _densify(qv, qi, d), _densify(kv, ki, d)
            _timed_shape(results, "flash_sfa", label, key,
                         f"bh={bh} n={n} d=dv={d} k={k} {mask} bf16 ({body}): "
                         f"max|err| {err:.3g}; library = SDPA on densified Q/K", err,
                         2 * bh * n * k * (es + 4) + 2 * bh * n * dv * es + bh * n * 4,
                         code_product_s(2 * k * pairs, 2 * d * pairs)
                         + 2 * dv * pairs / BF16_TC_FLOPS,
                         lambda: flash_sfa(qv, qi, kv, ki, v, d=d, scale=scale, causal=causal,
                                           return_residuals=True),
                         lambda: flash_sfa_ref(qv, qi, kv, ki, v, d=d, scale=scale,
                                               causal=causal, return_residuals=True),
                         lambda: F.scaled_dot_product_attention(
                             qd.reshape(b, h, n, d), kd.reshape(b, h, n, d),
                             v.reshape(b, h, n, dv), is_causal=causal, scale=scale))
            if bwd:
                _timed_shape(results, "flash_sfa_bwd", label, key,
                             f"dense emit, bh={bh} n={n} d=dv={d} k={k} {mask} bf16 ({body}): "
                             f"max|err| {berr:.3g}; library = SDPA backward (autograd) "
                             f"on densified Q/K", berr,
                             2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                             + 2 * bh * n * d * es + bh * n * dv * es,
                             code_product_s(6 * k * pairs, 6 * d * pairs)
                             + 4 * dv * pairs / BF16_TC_FLOPS,
                             lambda: flash_sfa_bwd(*args, d=d, scale=scale, causal=causal),
                             lambda: flash_sfa_bwd_ref(*args, d=d, scale=scale, causal=causal),
                             _sdpa_bwd(qd, kd, v, g, scale, causal))
            del qd, kd
        del qv, qi, kv, ki, v, g, ko, kl, args
        torch.cuda.empty_cache()


def _decode_boundaries(rs, c, label):
    """Rows 10-14 at a decode geometry ``c`` (pools of c["h"] kv heads read
    by c["heads"] query heads) in f32 and bf16, at slot lengths on and
    around the runs of 128 positions with a zero-length slot (its rows must
    be 0) and the past-the-table sentinel: row 10 against its plain
    version on the gathered view, rows 11-12 by ``_check_paged_multi``
    (each against its plain version, row 11 bit-equal to row 10, each
    verify row bit-equal to row 11 at its length), rows 13-14 against their
    plain versions, row 14 bit-equal to row 13 on the gathered image.
    -> {row: max |err|}."""
    from repro_torch.kernels import (
        flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged, rtopk, topk_dense,
    )
    from repro_torch.kernels.ref import (
        _pool_view, flash_sfa_decode_fm_paged_ref, flash_sfa_decode_fm_ref, flash_sfa_decode_ref,
    )
    h, d, k, dv = c["heads"], c["d"], c["k"], c["dv"]
    group, n_all = h // c["h"], c["mp"] * c["page"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        pools, bt, _ = _paged_pools(rs, dtype, copies=1, c=c)
        p0 = pools[0]
        lens = torch.from_numpy(_boundary_lengths(n_all, c["slots"])).cuda()
        lens[1] = n_all + 1
        rlens = lens.repeat_interleave(h)
        q = topk_dense(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32))
                       .cuda(), k)
        view = [_pool_view(p0[nm], bt).contiguous() for nm in ("kv", "ki", "v")]
        e10 = _close_rows(flash_sfa_decode(q, *view, rlens, d=d),
                          flash_sfa_decode_ref(q, *view, rlens, d=d), rlens,
                          f"flash_sfa_decode {label} {dtype}")
        slot, C = 2, 5
        qm = topk_dense(torch.from_numpy(rs.randn(C * h, d).astype(np.float32)).cuda(), k)
        _, (e11, e12) = _check_paged_multi(q, qm, p0, bt, lens, slot, int(lens[slot]) - C,
                                           f"{label} {dtype}", c=c)
        qv, qi = rtopk(torch.from_numpy(rs.randn(c["slots"] * h, d).astype(np.float32))
                       .cuda().to(dtype), k)
        btl = bt.long()
        kf = p0["kf"][:, btl].permute(1, 0, 3, 2, 4).reshape(-1, d, n_all).contiguous()
        vv = p0["v"][:, btl].transpose(0, 1).reshape(-1, n_all, dv).contiguous()
        fo = flash_sfa_decode_fm(qv, qi, kf, vv, rlens, group=group)
        ko = flash_sfa_decode_fm_paged(qv, qi, p0["kf"], p0["v"], bt, lens, heads=h)
        e13 = _close_rows(fo, flash_sfa_decode_fm_ref(qv, qi, kf, vv, rlens, group=group),
                          rlens, f"flash_sfa_decode_fm {label} {dtype}")
        e14 = _close_rows(ko, flash_sfa_decode_fm_paged_ref(qv, qi, p0["kf"], p0["v"], bt, lens,
                                                            heads=h), rlens,
                          f"flash_sfa_decode_fm_paged {label} {dtype}")
        check(torch.equal(ko, fo), f"flash_sfa_decode_fm_paged {label} {dtype}: not "
                                   f"bit-equal to flash_sfa_decode_fm on the gathered image")
        for row, e in zip((10, 11, 12, 13, 14), (e10, e11, e12, e13, e14)):
            errs[row] = max(errs.get(row, 0.0), e)
        print(f"[decode rows 10-14] {label} {dtype}, {h} query heads over {c['h']} kv head(s), "
              f"d = dv {d}, k {k}, slot lengths {lens.tolist()} (zero-length rows 0): max|err| "
              f"10 {e10:.3g}, 11 {e11:.3g}, 12 {e12:.3g}, 13 {e13:.3g}, 14 {e14:.3g} (tol 1e-4); "
              f"fm_paged == fm on the gathered image (bit-equal)")
        del pools, view, kf, vv
    torch.cuda.empty_cache()
    return errs


def _kernel_label(mangled):
    """A kernel template's name and arguments from its mangled name, e.g.
    ``flash_sfa_fwd_kernel<256, bf16>``."""
    import re
    m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", mangled)
    if m is None:
        return mangled[:64]
    rest, out = m.group(2), []
    types = {"f": "f32", "h": "u8", "t": "u16", "i": "i32"}
    while rest:
        if rest.startswith("Li"):
            num, rest = rest[2:].split("E", 1)
            out.append(num)
        elif rest.startswith("Lb"):
            out.append("true" if rest[2] == "1" else "false")
            rest = rest[4:]
        elif rest.startswith("13__nv_bfloat16"):
            out.append("bf16")
            rest = rest[len("13__nv_bfloat16"):]
        else:
            out.append(types.get(rest[0], rest[0]))
            rest = rest[1:]
    return f"{m.group(1)}<{', '.join(out)}>"


def _wide_smem(label, k=32, n=TRAIN_N):
    """The dynamic shared memory (bytes) a launch of the tensor-core
    FlashSFA kernel ``label`` (``_kernel_label``) at d 80 or 256 asks for,
    at code width k and n keys (csrc/flash_sfa_tc.cuh's launchers; the
    static part is ptxas's)."""
    d = int(label.split("<")[1].split(",")[0].rstrip(">"))
    w = 96 if d == 80 else d
    tile, codes = 64 * w * 2, 4 * 64 * (k + 1)
    if label.startswith("flash_attention_tc_fwd_kernel"):
        qrows = 64 if d == 256 else 128
        return 1024 + qrows * w * 2 + 4 * tile + codes + 2 * -(-n // 64)
    return 1024 + 6 * tile + codes           # either backward kernel


def phase_frontend_shapes(results):
    """The instantiations the frontend families add, each against its plain
    version in f32 and bf16: rows 1, 3, 5 at hubert-xlarge's training shape
    (d = dv 80, bidirectional; row 3 causal too), rows 1, 3, 5 at
    paligemma-3b's prefill (d = dv 256, causal) and rows 10-14 at its
    decode step (dv 256, 8 query heads over 1 kv head), the bf16 calls
    timed and recorded as the shapes "HB" and "PG" of their rows, row 5's
    f32 call at PG as "PG f32"; rows 3 and 5 run bf16 on the tensor-core
    bodies of flash_sfa_tc_wide.cu, f32 on the CUDA-core ones (row 5 at dv
    256 on 32-row tiles).
    The new instantiations' ptxas registers, spills and shared memory first
    (each tensor-core one <= 255 registers, no spill, <= 227 KB)."""
    for lib in ("flash_sfa", "flash_sfa_bwd", "flash_sfa_decode", "flash_sfa_decode_fm"):
        regs = {fn: r for fn, r in ptxas_kernels(lib).items() if "Li80E" in fn or "Li256E" in fn}
        check(regs, f"ptxas {lib}: no dv 80 or 256 instantiation in the build log")
        print(f"[ptxas] {lib} at dv 80 / 256: " + "; ".join(
            f"{_kernel_label(fn)} {r} regs" + ("" if sp.startswith("0 bytes stack frame, 0 ")
                                               or not sp else f" ({sp})")
            for fn, (r, sp) in regs.items()))
    wide = []
    for fn, (r, sp) in ptxas_kernels("flash_sfa_tc_wide").items():
        label = _kernel_label(fn)
        if "<" not in label or label.startswith("densify_probe"):
            continue                              # the pack kernel, phase 3's probe
        smem = _wide_smem(label)
        check(r <= 255 and sp.startswith("0 bytes stack frame, 0 bytes spill stores")
              and smem <= 232_448, f"ptxas flash_sfa_tc_wide {label}: {r} regs, {sp}, "
                                   f"{smem} B dynamic shared memory")
        wide.append(f"{label} {r} regs, 0 spill, {smem} B dynamic shared memory")
    check(len(wide) == 6, f"ptxas flash_sfa_tc_wide: {wide}")
    print("[ptxas] flash_sfa_tc_wide (the tensor-core bodies at d 80 / 256; shared memory "
          "at k 32, n 1024, plus ptxas's static bytes): " + "; ".join(wide))
    rs = np.random.RandomState(SEED + 50)
    _frontend_rows(results, rs, HB, "HB training", "HB", causal=False, bwd=True)
    _frontend_rows(results, rs, PG, "PG prefill", "PG", causal=True, bwd=True,
                   f32_key="PG f32")
    _sfa_decode_rows(results, rs, PG_DECODE, PG_PAGED, "PG decode", key="PG")
    errs = _decode_boundaries(rs, PG_PAGED, "PG decode")
    names = ("flash_sfa_decode", "flash_sfa_decode_paged", "flash_sfa_decode_multi",
             "flash_sfa_decode_fm", "flash_sfa_decode_fm_paged")
    for name, row in zip(names, (10, 11, 12, 13, 14)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], errs[row])


# hubert-xlarge's and paligemma-3b's compact seams: x 8 x 1024 tokens of
# d_model; hubert 16 + 16 heads of 80, k 16, code width 16, bidirectional,
# no RoPE; paligemma 8 query heads over 1 kv head of 256, k 16, RoPE theta
# 10,000, code width 32 (the pair closure), causal
HBS = dict(b=8, h=16, hkv=16, d=80, k=16, m=1280, causal=False, kw=16)
PGS = dict(b=8, h=8, hkv=1, d=256, k=16, m=2048, theta=10_000.0, kw=32)


def _wide_seam_smem(label):
    """The dynamic shared memory (bytes) a launch of the wide seam's
    tensor-core kernel ``label`` (``_kernel_label``) asks for: the launchers
    of csrc/proj_rtopk_wide.cu and csrc/code_grad_tc.cuh (the static part
    is ptxas's); None for a kernel without such a launcher."""
    args = label.split("<")[1].rstrip(">").split(", ")
    if label.startswith("proj_rtopk_wide_tc_kernel"):
        nc = 160 if int(args[0]) == 80 else int(args[0])   # a block's columns: whole heads
        return 1024 + 3 * (128 * 64 * 2 + nc * 64 * 2) + 3 * 8
    if not label.startswith(("code_grad_dw_tc_kernel", "code_grad_dx_tc_kernel")):
        return None
    d, kw = int(args[0]), int(args[1])
    if label.startswith("code_grad_dw_tc_kernel"):
        # one head (of 80) or half a head (of 256) a block: 64 packed rows a chunk
        return 1024 + 4 * 64 * 128 * 2 + 4 * 128 * 64 * 2 + 4 * 64 * kw * 6 + 4 * 8
    if label.startswith("code_grad_dx_tc_kernel"):
        f = 64 if d % 64 == 0 else 32              # features of a step
        return 1024 + (4 + 2 * 3) * 128 * f * 2 + (2 if kw > 16 else 3) * 128 * kw * 6 + 3 * 8
    return None


def phase_wide_seam_shapes(results):
    """Rows 2, 4, 8 and 9 at hubert-xlarge's compact seam (``HBS``: d 80,
    width 16, bidirectional) and paligemma-3b's (``PGS``: d 256, MQA,
    RoPE, width 32), bf16 on the tensor-core bodies of proj_rtopk_wide.cu,
    flash_sfa_tc_wide.cu (the block-skip schedule) and code_grad_wide.cu,
    f32 on the CUDA-core bodies, each against its plain version
    (``_seam_rows``), the bf16 calls timed and recorded as the shapes "HBs"
    and "PGs" of their rows. The new instantiations' ptxas registers,
    spills and shared memory first (each <= 255 registers, no spill, <= 227
    KB; proj_rtopk's bodies keep RoPE's double cos / sin in a 40-byte stack
    frame, as at d 32, 64 and 128)."""
    for lib, keep in (("proj_rtopk_wide", "_kernel<"), ("code_grad_wide", "_tc_kernel<"),
                      ("flash_sfa_tc_wide", "flash_attention_tc_fwd_kernel<")):
        lines = []
        for fn, (r, sp) in ptxas_kernels(lib).items():
            label = _kernel_label(fn)
            if keep not in label:
                continue
            smem = (_wide_smem(label) if lib == "flash_sfa_tc_wide"
                    else _wide_seam_smem(label))
            # a stack frame without spills is RoPE's double cos / sin
            check(r <= 255 and " 0 bytes spill stores" in sp
                  and (smem is None or smem <= 232_448),
                  f"ptxas {lib} {label}: {r} regs, {sp}, {smem} B dynamic shared memory")
            frame = sp.split(" bytes stack frame")[0]
            lines.append(f"{label} {r} regs, 0 spill"
                         + (f" ({frame} B stack frame)" if frame != "0" else "")
                         + (f", {smem} B dynamic shared memory" if smem else ""))
        check(lines, f"ptxas {lib}: no kernel in the build log")
        print(f"[ptxas] {lib} (the wide seam's bodies; shared memory plus ptxas's static "
              f"bytes): " + "; ".join(lines))
    rs = np.random.RandomState(SEED + 60)
    _seam_rows(results, rs, HBS, "HBs seam", key="HBs")
    _seam_rows(results, rs, PGS, "PGs seam", key="PGs")


# --------------------------------------------------------------------------
# phase 4-5: the serving main path
# --------------------------------------------------------------------------

def phase_engine(model, cfg, depth="full depth", patches=False, decode_backend=None):
    """The slot engine on 8 requests (with ``patches``, each with a seeded
    patch prefix of a vlm through ``extra_inputs``, and then the same
    prompts text-only, whose streams the paged, speculative and
    feature-major phases are held to), on ``decode_backend`` (default: the
    config's). Launches as predicted per attention layer (rtopk 3 a prefill
    and 2 a step, FlashSFA 1 a prefill, the decode kernel 1 a step; an
    attention-free model none), no fallback; the KV cache at rest equal to
    the byte model's per-layer bytes x the attention layers (the same as
    ``cache_bytes_per_token`` x 8 x capacity but for jamba, whose byte
    model counts every layer, as the reference's does), a recurrent state
    equal to its size; a traced window of 4 decode steps gives the device's
    busy share; for an MoE model the expert cast's device ms."""
    from repro_torch.core.kv_cache import kv_cache_nodes
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.serve import DecodeEngine, EngineConfig, cache_bytes_per_token
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int64)
               for n in rs.randint(64, 1025, size=8)]
    extras = [None] * len(prompts)
    if patches:
        fe, prs = cfg.frontend, np.random.RandomState(SEED + 60)
        extras = [{"patches": prs.randn(fe.prefix_len, fe.input_dim).astype(np.float32)}
                  for _ in prompts]
    # warm-up on a small engine (library loading, cuBLAS handles), not counted
    backend = dict(decode_backend=decode_backend)
    warm = DecodeEngine(model, cfg, EngineConfig(max_slots=1, max_len=128, **backend),
                        device="cuda")
    warm.add_request(prompts[0][:64], 3)
    while warm.live.any():
        warm.step()
    del warm
    eng = DecodeEngine(model, cfg, EngineConfig(max_slots=8, max_len=2048, **backend),
                       device="cuda")
    torch.cuda.synchronize()
    # the peak since the counter's last reset (model init, the warm-up and
    # whatever earlier phases held since their reset), then the timed run's
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clear_fallback_reports()
    reset_launches()
    t_start = time.perf_counter()
    prefill_ms = []
    for p, x in zip(prompts, extras):
        t0 = time.perf_counter()
        eng.add_request(p, max_new_tokens=32, extra_inputs=x)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    prefill_counts = launch_counts()
    step_ms = []
    while eng.live.any():
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reports = fallback_reports()
    outputs = [eng.outputs[s] for s in range(8)]
    check(all(len(o) == 32 for o in outputs), "engine: a request did not get 32 tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          "engine: token out of vocabulary")
    check(not reports, f"engine: backend fallbacks recorded: {reports}")
    # every step decodes all 8 slots: one decode launch per attention layer
    # and step; rtopk codes q, k and the cache's k a prefill, q and k a step
    la, steps = _attention_layers(cfg), len(step_ms)
    decode_kernel = "flash_sfa_decode_fm" if decode_backend == "cuda_fm" else "flash_sfa_decode"
    want = {name: 0 for name in counts}
    if la:
        want.update({"rtopk": la * (3 * 8 + 2 * steps), "flash_sfa": la * 8,
                     decode_kernel: la * steps})
        _rtopk_bodies("engine", cfg)
    check(counts == want, f"engine: launches {counts}, predicted {want}")
    # the cache at rest against the byte model: 8 slots x its token capacity
    layout = "fm" if decode_backend == "cuda_fm" else "sfa"
    per_layer = (cache_bytes_per_token(dataclasses.replace(cfg, num_layers=1))[layout]
                 if la else 0)
    model_bytes = per_layer * la * 8 * eng._cache_len
    check(eng.cache_bytes() == model_bytes, f"engine: kv cache {eng.cache_bytes()} bytes, the "
                                            f"byte model {model_bytes}")
    check(eng.state_bytes() == _state_bytes(cfg, 8),
          f"engine: recurrent state {eng.state_bytes()} bytes, predicted {_state_bytes(cfg, 8)}")
    prefix = cfg.frontend.prefix_len if patches else 0
    check(all(int(eng.lengths[s]) == len(p) + prefix + 31 for s, p in enumerate(prompts)),
          f"engine: slot lengths {eng.lengths.tolist()} (the prefix is {prefix} positions)")
    # a separate traced window: the same requests again, 4 decode steps
    for p, x in zip(prompts, extras):
        eng.add_request(p, max_new_tokens=5, extra_inputs=x)
    torch.cuda.synchronize()
    kernels, traced_ms = trace_kernels(lambda: [eng.step() for _ in range(4)])
    busy_ms = sum(kernels.values()) / 1e3
    # the decode's kernels (split and merge), per step
    decode_ms = sum(us for n, us in kernels.items()
                    if short_name(n).startswith(("decode_split_kernel", "decode_fm_split_kernel",
                                                 "decode_merge_kernel"))) / 1e3 / 4
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    layouts = sorted({type(n).__name__ for n in kv_cache_nodes(eng.caches)})
    tokens = sum(len(o) for o in outputs)
    decode_tokens = tokens - len(outputs)
    print(f"[engine] {cfg.name} full width bf16, {depth}, 8 slots, max_len 2048"
          + (f", decode_backend {decode_backend}" if decode_backend else "")
          + f", prompt lengths {[len(p) for p in prompts]}"
          + (f", each behind {prefix} seeded patches (extra_inputs)" if patches else ""))
    print(f"[engine] prefill ms per request {[round(x, 2) for x in prefill_ms]} "
          f"(mean {np.mean(prefill_ms):.2f}); decode ms per step mean "
          f"{np.mean(step_ms):.3f} p50 {np.median(step_ms):.3f} over {steps} "
          f"steps; {decode_tokens / (sum(step_ms) / 1e3):.1f} decode tokens/s, "
          f"{tokens / wall:.1f} tokens/s overall ({tokens} tokens in {wall:.2f} s)")
    print(f"[engine] kv cache {eng.cache_bytes() / 2**20:.2f} MiB ({', '.join(layouts) or 'none'}; "
          f"{la} attention layers x {per_layer} B a token x 8 x {eng._cache_len}; "
          f"cache_bytes_per_token counts {cfg.num_layers} layers: "
          f"{cache_bytes_per_token(cfg).get(layout, 0) * 8 * eng._cache_len / 2**20:.2f} MiB)"
          + (f"; recurrent state {eng.state_bytes() / 2**20:.2f} MiB" if eng.state_bytes()
             else "")
          + f"; launches {({k: v for k, v in counts.items() if v})} (as predicted); fallbacks "
          f"none; peak memory {peak / 2**30:.2f} GiB in the timed run, from the engine's "
          f"construction on ({max(peak, peak_before) / 2**30:.2f} GiB since the counter's "
          f"last reset, with model init and the warm-up)")
    print(f"[engine] traced 4 decode steps (profiler on): wall {traced_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / traced_ms:.1f}%); decode kernels {decode_ms:.4f} ms a "
          f"step ({100 * decode_ms * 4 / busy_ms:.1f}% of busy); top kernels by device time: "
          + "; ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in top))
    print(f"[engine] slot 0 tokens: {outputs[0]}")
    if cfg.moe is not None:
        _moe_cast(model, cfg, float(np.mean(step_ms)))
    if patches:
        # the other engines take text-only prompts: their streams are held
        # to this engine's on the same prompts without the prefix
        reset_launches()
        text, text_ms, _, _ = _serve(eng, prompts, 32, paged=False)
        check(launch_counts()["flash_sfa_decode"] == cfg.num_layers * len(text_ms),
              f"engine (text only): launches {launch_counts()}")
        check(not fallback_reports(), f"engine (text only): fallbacks {fallback_reports()}")
        print(f"[engine] the same prompts text-only: decode ms per step mean "
              f"{np.mean(text_ms):.3f}; {sum(a != b for a, b in zip(text, outputs))} of 8 "
              f"streams differ from the streams behind the patches; slot 0 tokens {text[0]}")
        outputs = text
    return counts, dict(prompts=prompts, outputs=outputs, cache_bytes=eng.cache_bytes(),
                        step_ms=float(np.mean(step_ms)), prefill_counts=prefill_counts)


def _moe_cast(model, cfg, step_ms):
    """The device time of one MoE layer's f32 -> bf16 cast of all its
    experts (up, gate, down), which ``moe_apply`` makes at every call, as
    the reference does, and its share of a decode step."""
    from repro_torch.models import segments
    from repro_torch.models.layers import tree_index
    p = tree_index(model.tree()["segments"][-1], 0)
    subs = p.get("subs", [p])                      # a jamba super-block's sublayers
    p = next(sub["moe"] for sub in subs if "moe" in sub)
    names = [n for n in ("up", "gate", "down") if n in p]

    def cast():
        # nothing kept: a jamba layer's copies take 5.6 GB a call
        for n in names:
            p[n].to(torch.bfloat16)

    ms = device_ms(cast)
    per = {"block_moe": 1, "jamba": sum("moe" in sub for sub in subs)}
    layers = sum(count * per.get(kind, 0) for kind, count in segments(cfg))
    moved = sum(p[n].numel() for n in names) * 6
    if ms is None:
        ms = event_ms(cast, iters=10)
    print(f"[engine] MoE expert cast, one layer ({', '.join(names)}: {cfg.moe.num_experts} "
          f"experts, f32 -> bf16, {moved / 1e9:.3f} GB read + written): {ms:.4f} ms "
          f"(bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms); x {layers} MoE layers = "
          f"{ms * layers:.3f} ms of the {step_ms:.3f} ms decode step "
          f"({100 * ms * layers / step_ms:.1f}%)")


# --------------------------------------------------------------------------
# the paged, speculative and feature-major serving paths
# --------------------------------------------------------------------------

def _rtopk_bodies(what, cfg):
    """Check that the path just driven ran rtopk, all on the body its head
    dim takes: the one-thread body (d 64 or 128; k 8, 16 or a draft's k' 2)
    or, at a head dim it does not take (paligemma's 256), the warp body."""
    from repro_torch.kernels import body_counts, launch_counts
    from repro_torch.kernels.rtopk import one_thread_body
    a = cfg.attention
    n, warp = launch_counts()["rtopk"], body_counts()["rtopk_warp"]
    want = 0 if one_thread_body(a.head_dim, a.sfa_k) else n
    check(n > 0 and warp == want, f"{what}: rtopk launches {n}, warp body {warp} "
                                  f"(expected {want} at d {a.head_dim}, k {a.sfa_k})")


def _serve(eng, prompts, max_new, paged=True):
    """Drive an engine to the end: (outputs per request, per-tick host ms,
    wall s, live slots before each tick). Every tick ends in a synchronize."""
    ids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    tick_ms, live = [], []
    t_start = time.perf_counter()
    while (eng.busy if paged else eng.live.any()):
        live.append(int(eng.live.sum()))
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    return [eng.outputs[i] for i in ids], tick_ms, wall, live


def _near_tie_divergences(model, cfg, prompts, got, want, bound_logit):
    """For each request whose stream ``got`` leaves ``want``, the reference
    logit gap between the two tokens at the first differing position (a
    prefill over the common prefix, in the engines' bf16); raises if a gap
    exceeds ``bound_logit``. Returns [(request, position, gap)]."""
    from repro_torch.models import prefill
    out = []
    for r, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        i = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        toks = np.concatenate([p, np.asarray(b[:i], np.int64)])
        logits, _ = prefill(model, {"tokens": torch.from_numpy(toks)[None].cuda()}, cfg)
        gap = abs(float(logits[0, a[i]] - logits[0, b[i]]))
        check(gap <= bound_logit, f"request {r}: streams part at token {i} where the "
                                  f"reference logits differ by {gap:.4g} > {bound_logit}")
        out.append((r, i, round(gap, 5)))
    return out


def phase_paged(model, cfg, slot_run, preempt=True):
    """(a) the paged engine on the slot engine's prompts, full residency:
    streams identical to DecodeEngine's; (b, with ``preempt``) 16 prompts,
    chunked prefill, a quarter of full residency: queueing and preemption."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.serve import PagedDecodeEngine, PagedEngineConfig, paged_page_bytes
    layers = cfg.num_layers
    clear_fallback_reports()
    reset_launches()
    eng = PagedDecodeEngine(model, cfg, PagedEngineConfig(max_slots=8, max_len=2048,
                                                          page_size=128, decode_backend="cuda"),
                            device="cuda")
    outputs, tick_ms, wall, live = _serve(eng, slot_run["prompts"], 32)
    counts = launch_counts()
    check(outputs == slot_run["outputs"], "paged (a): streams differ from DecodeEngine's")
    check(not fallback_reports(), f"paged (a): fallbacks {fallback_reports()}")
    # every tick decodes (the first one after admitting all 8): one paged
    # decode launch per layer and tick
    check(counts["flash_sfa_decode_paged"] == layers * len(tick_ms) and
          counts["flash_sfa_decode"] == 0 and counts["rtopk"] > 0 and counts["flash_sfa"] > 0,
          f"paged (a): launches {counts}")
    _rtopk_bodies("paged (a)", cfg)
    tokens = sum(len(o) for o in outputs)
    res = dict(counts=counts, outputs=outputs)
    print(f"[paged a] {cfg.name} full width bf16, cuda, 8 slots, max_len 2048, pages of "
          f"128, full residency ({eng.num_pages - 1} pages), whole-prompt prefill: streams "
          f"identical to DecodeEngine's for all 8 requests; {len(tick_ms)} ticks, decode ms "
          f"per tick mean {np.mean(tick_ms[1:]):.3f} p50 {np.median(tick_ms[1:]):.3f} (first "
          f"tick, with the 8 prefills, {tick_ms[0]:.1f}); DecodeEngine's decode step mean "
          f"{slot_run['step_ms']:.3f}; {tokens / wall:.1f} tokens/s overall; kv cache "
          f"{eng.cache_bytes() / 2**20:.2f} MiB (DecodeEngine "
          f"{slot_run['cache_bytes'] / 2**20:.2f} MiB); launches {counts}")
    if not preempt:
        return res
    # (b) queueing and preemption
    rs = np.random.RandomState(SEED + 3)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int64)
               for n in rs.randint(64, 1025, size=16)]
    per = paged_page_bytes(cfg, page_size=128)
    # a quarter of 8 slots x 16 pages; with 64 new tokens a request this
    # schedule preempts three times (the schedule depends on the lengths
    # only, so it is the same on any card)
    budget_pages, new = 32, 64
    clear_fallback_reports()
    eng = PagedDecodeEngine(model, cfg, PagedEngineConfig(
        max_slots=8, max_len=2048, page_size=128, prefill_chunk=256,
        mem_budget_bytes=budget_pages * per, decode_backend="cuda"), device="cuda")
    ids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    tick_ms, queued, t_start = [], 0, time.perf_counter()
    while eng.busy:
        queued = max(queued, len(eng.queue))
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        check(len(tick_ms) < 5000, "paged (b): scheduler livelock")
    wall = time.perf_counter() - t_start
    outs = [eng.outputs[i] for i in ids]
    check(all(len(o) == new for o in outs), f"paged (b): a request did not get its {new} tokens")
    check(queued > 0 and eng.preemptions >= 1,
          f"paged (b): queued {queued}, preemptions {eng.preemptions}")
    check(len(eng.free_pages) == eng.num_pages - 1 and (eng.bt == 0).all(),
          "paged (b): the free list is not whole at the end")
    check(not fallback_reports(), f"paged (b): fallbacks {fallback_reports()}")
    _rtopk_bodies("paged (a) and (b)", cfg)
    tokens = sum(len(o) for o in outs)
    print(f"[paged b] 16 prompts of {sorted(len(p) for p in prompts)} tokens, {new} new each, "
          f"prefill_chunk 256, pool {eng.num_pages - 1} pages ({budget_pages} x "
          f"{per / 2**20:.3f} MiB = {eng.cache_bytes() / 2**20:.2f} MiB with the block "
          f"table, against the slot engine's {slot_run['cache_bytes'] / 2**20:.2f} MiB): "
          f"up to {queued} queued, {eng.preemptions} preemptions, every request got "
          f"{new} tokens, free list whole; {len(tick_ms)} ticks, ms per tick mean "
          f"{np.mean(tick_ms):.3f} p50 {np.median(tick_ms):.3f}; {tokens / wall:.1f} tokens/s")
    return res


SPEC_TIE = 0.125   # logit gap that counts as a near-tie, bf16 model


def phase_speculative(model, cfg, paged_run, prompts):
    """draft_len 4, draft_k 2 on the paged phase's prompts: the launches of
    rows 11 and 12 as predicted from ticks, live slots and layers; streams
    equal the paged engine's or part at a near-tie."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.serve import SpeculativeDecodeEngine, SpeculativeEngineConfig
    layers, J = cfg.num_layers, 4
    clear_fallback_reports()
    reset_launches()
    eng = SpeculativeDecodeEngine(model, cfg, SpeculativeEngineConfig(
        max_slots=8, max_len=2048, page_size=128, decode_backend="cuda", draft_len=J,
        draft_k=2), device="cuda")
    outputs, tick_ms, wall, live = _serve(eng, prompts, 32)
    counts = launch_counts()
    check(not fallback_reports(), f"speculative: fallbacks {fallback_reports()}")
    ticks = len(tick_ms)
    # every tick drafts J decode steps over the slot batch (one paged launch
    # per layer each) and verifies each live slot (one multi launch per
    # layer). The first tick admits all 8 requests before it decodes; after
    # it, the live slots before a tick are those it verifies.
    want11 = J * layers * ticks
    want12 = layers * (len(prompts) + sum(live[1:]))
    check(counts["flash_sfa_decode_paged"] == want11
          and counts["flash_sfa_decode_multi"] == want12,
          f"speculative: launches {counts}, predicted paged {want11}, multi {want12}")
    _rtopk_bodies("speculative", cfg)
    check(all(len(o) == 32 for o in outputs), "speculative: a request did not get 32 tokens")
    parted = _near_tie_divergences(model, cfg, prompts, outputs, paged_run["outputs"],
                                   SPEC_TIE)
    st = eng.spec_stats
    tokens = sum(len(o) for o in outputs)
    # the draft pass narrows the pools with sub_k (a torch op) for every
    # layer and draft step: its time on one layer's pools, and one traced
    # tick of the same requests served again (the first tick prefills)
    from repro_torch.core.kv_cache import unpack_indices
    from repro_torch.core.sparse import sub_k
    pool = eng.caches[0].layer(0)

    def draft_narrow():
        return sub_k(pool.k_vals, unpack_indices(pool.k_idx), 2)
    sub_dev, sub_call = device_ms(draft_narrow), event_ms(draft_narrow, iters=10)
    for p in prompts:
        eng.add_request(p, max_new_tokens=9)
    eng.step()
    torch.cuda.synchronize()
    kernels, traced_ms = trace_kernels(eng.step)
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"[speculative] traced tick (profiler on): wall {traced_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%); sub_k on one layer's pools "
          f"{tuple(pool.k_vals.shape)}: device "
          f"{'not measured' if sub_dev is None else f'{sub_dev:.4f} ms'}, per call with host "
          f"{sub_call:.4f} ms, {J * layers} calls a tick = {J * layers * sub_call:.1f} ms of "
          f"host time a tick; top kernels: "
          + "; ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in top))
    print(f"[speculative] draft_len {J}, draft_k 2, 8 requests x 32 tokens: {ticks} ticks, "
          f"alpha {st['alpha']:.4f}, emitted tokens per tick over the 8 slots "
          f"{st['acc_per_step']:.4f} (emitted {st['emitted']} over {st['ticks']} ticks), "
          f"ms per tick mean "
          f"{np.mean(tick_ms[1:]):.3f} p50 {np.median(tick_ms[1:]):.3f}, {tokens / wall:.1f} "
          f"tokens/s; launches paged {counts['flash_sfa_decode_paged']} (predicted {want11}), "
          f"multi {counts['flash_sfa_decode_multi']} (predicted {want12}); streams equal "
          f"the paged engine's for {8 - len(parted)} of 8 requests, the others part at a "
          f"near-tie (reference logit gap <= {SPEC_TIE}): {parted}")
    return counts


def phase_feature_major(model, cfg, cuda_run, prompts):
    """cuda_fm through the slot and the paged engine on the paged phase's
    prompts: rows 13 and 14 launched as predicted, the paged streams
    identical to the slot streams, and against the token-major streams the
    near-tie rule."""
    from repro_torch.core.kv_cache import kv_cache_nodes
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.serve import (
        DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig,
    )
    layers = cfg.num_layers
    clear_fallback_reports()
    reset_launches()
    slot = DecodeEngine(model, cfg, EngineConfig(max_slots=8, max_len=2048,
                                                 decode_backend="cuda_fm"), device="cuda")
    s_out, s_ms, _, _ = _serve(slot, prompts, 32, paged=False)
    c_slot = launch_counts()
    check(c_slot["flash_sfa_decode_fm"] == layers * len(s_ms)
          and c_slot["flash_sfa_decode_fm_paged"] == 0 and c_slot["flash_sfa_decode"] == 0,
          f"cuda_fm slot: launches {c_slot}")
    _rtopk_bodies("cuda_fm slot", cfg)
    reset_launches()
    paged = PagedDecodeEngine(model, cfg, PagedEngineConfig(
        max_slots=8, max_len=2048, page_size=128, decode_backend="cuda_fm"), device="cuda")
    p_out, p_ms, wall, _ = _serve(paged, prompts, 32)
    c_paged = launch_counts()
    check(c_paged["flash_sfa_decode_fm_paged"] == layers * len(p_ms)
          and c_paged["flash_sfa_decode_fm"] == 0, f"cuda_fm paged: launches {c_paged}")
    _rtopk_bodies("cuda_fm paged", cfg)
    check(not fallback_reports(), f"cuda_fm: fallbacks {fallback_reports()}")
    check(p_out == s_out, "cuda_fm: the paged streams differ from the slot streams")
    parted = _near_tie_divergences(model, cfg, prompts, s_out, cuda_run["outputs"], SPEC_TIE)
    layouts = sorted({type(n).__name__ for n in kv_cache_nodes(slot.caches)})
    print(f"[cuda_fm] slot engine ({', '.join(layouts)}, "
          f"{slot.cache_bytes() / 2**20:.2f} MiB, dense K image at rest): decode ms per step "
          f"mean {np.mean(s_ms):.3f}; paged engine ({paged.cache_bytes() / 2**20:.2f} MiB): "
          f"ms per tick mean {np.mean(p_ms[1:]):.3f}; paged streams identical to the slot "
          f"streams; against the token-major cuda streams {8 - len(parted)} of 8 equal, the "
          f"others part at a near-tie (gap <= {SPEC_TIE}): {parted}; launches fm "
          f"{c_slot['flash_sfa_decode_fm']} (predicted {layers * len(s_ms)}), fm_paged "
          f"{c_paged['flash_sfa_decode_fm_paged']} (predicted {layers * len(p_ms)})")
    return c_slot, c_paged


def phase_serve_launcher():
    """The serving launcher's paged modes at full width."""
    release()
    for extra in (["--paged", "--speculative"], ["--decode-backend", "cuda_fm", "--paged"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gpt2-small-sfa8",
               "--no-reduced", "--requests", "4", "--max-new", "16", *extra]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                             cwd=ROOT)
        out = res.stdout.strip().splitlines()
        check(res.returncode == 0, f"serve launcher exit {res.returncode}: "
                                   f"{res.stderr[-2000:]}")
        check(not any("fallback" in line for line in out), f"serve launcher: {out}")
        print(f"[serve launcher] {' '.join(cmd[3:])}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s; " + " | ".join(out[-3:]))


def phase_end_to_end(model, cfg, depth="full depth", cache_dtype=torch.bfloat16,
                     patches=False, tol=5e-3):
    """Kernels against plain on the whole model, float32 (caches in
    ``cache_dtype``; with ``patches`` a vlm's seeded patch prefix in front
    of the prompt), max |logit diff| <= ``tol``."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import decode_step, init_decode_caches, prefill
    from repro_torch.models.model import insert_slot
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rs = np.random.RandomState(SEED + 1)
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=512)).cuda()[None]
    stream = rs.randint(0, cfg.vocab_size, size=8)
    batch, n0 = {"tokens": prompt}, 512
    if patches:
        fe = cfg.frontend
        batch["patches"] = torch.from_numpy(rs.randn(1, fe.prefix_len, fe.input_dim)
                                            .astype(np.float32)).cuda()
        n0 += fe.prefix_len
    runs = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg32, attention=dataclasses.replace(
            cfg32.attention, backend=backend, decode_backend=backend))
        reset_launches()
        logits, one = prefill(model, batch, c)
        caches = insert_slot(init_decode_caches(c, 1, 1024, cache_dtype, device="cuda"), one,
                             slot=0, max_len=1024)
        steps = [logits]
        for i, tok in enumerate(stream):
            lg, caches = decode_step(model, torch.tensor([int(tok)], device="cuda"),
                                     caches, torch.tensor([n0 + i], device="cuda"), c)
            steps.append(lg)
        runs[backend] = torch.stack(steps)
        counts = launch_counts()
        launched = counts["flash_sfa"] > 0 and counts["flash_sfa_decode"] > 0
        check(launched == (backend == "cuda"), f"end to end ({backend}): launches {counts}")
    a, b = runs["cuda"], runs["torch"]
    check(bool(torch.isfinite(a).all()), "end to end: non-finite logits")
    err = (a - b).abs().max().item()
    # tolerance: f32 model; with bf16 caches a 1e-6 difference upstream can
    # round a cached value to the neighbouring bf16 number: 5e-3 absolute on
    # logits of magnitude ~1; with f32 caches the sums' order alone, 1e-4
    # (where the caller asks for it); the argmax equal at every step
    check(err <= tol, f"end to end: max |logit diff| {err:.3g} > {tol:g}")
    check(torch.equal(a.argmax(-1), b.argmax(-1)), "end to end: argmax differs")
    print(f"[end-to-end] f32 {cfg.name} full width, {depth}, {str(cache_dtype)[6:]} caches: "
          f"prefill(512{f' behind {n0 - 512} patches' if patches else ''}) + 8 teacher-forced "
          f"decode steps, cuda vs torch backends: max |logit diff| {err:.3g} (tol {tol:g}), "
          f"argmax equal at all {a.shape[0]} steps; max |logit| {b.abs().max().item():.3g}")


# --------------------------------------------------------------------------
# phase 6-8: the training main path
# --------------------------------------------------------------------------

def phase_train(arch, timed_steps, predicted, *, layers=None, bodies=None, attention=None,
                distill=0.0, **policy):
    """Train full-width ``arch`` in bf16 through ``Trainer``: 1 warm-up and
    ``timed_steps`` timed steps with the launch counts read over all of
    them, then one traced step. ``predicted`` maps kernel -> launches per
    step (every other kernel: none) and ``bodies`` CUDA-core body -> its
    launches per step (default: none on any); ``layers`` cuts the depth;
    ``attention`` replaces fields of the config's attention (the protected
    RoPE dims of phase 11); ``distill`` sets ``sfa_distill`` (paper Eq. 8:
    every step's aux term must then be positive, and a compact request is
    declined with the reference's reason, which ``collect_reports()``
    must give); ``policy`` overrides the TrainPolicy (default
    remat="full"). A compact
    request must take the seam where proj_rtopk is predicted, and record why
    not elsewhere. Prints the step's FLOPs (``utils.analytic.step_flops``)
    and their share of the bf16 peak. Returns (launch counts, step
    summary)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainPolicy
    from repro_torch.core.remat import clear_remat_reports, remat_reports
    from repro_torch.data import DataConfig, markov_batch
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.models.attention import clear_compact_seam_reports, compact_seam_reports
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.utils.analytic import step_flops
    cfg = get_config(arch)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of {cfg.num_layers} layers (depth cut)"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if attention:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, **attention))
    if distill:
        cfg = dataclasses.replace(cfg, sfa_distill=distill)
    policy = dict({"remat": "full"}, **policy)
    batch, seq = 8, TRAIN_N
    steps = 1 + timed_steps
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=SEED)
    tr = Trainer(cfg, OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=steps + 1), dcfg,
                 TrainerConfig(total_steps=steps + 1, seed=SEED,
                               policy=TrainPolicy.from_model(cfg, **policy)),
                 device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_fallback_reports()
    clear_compact_seam_reports()
    clear_remat_reports()
    reset_launches()
    hist, step_ms = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        hist.append(tr.run_step(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    reports = fallback_reports()
    seams, remats = compact_seam_reports(), remat_reports()
    peak = torch.cuda.max_memory_allocated()
    want = {name: predicted.get(name, 0) * steps for name in counts}
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"train {arch}: non-finite loss or gradient norm: {hist}")
    check(not reports, f"train {arch}: backend fallbacks recorded: {reports}")
    check(counts == want, f"train {arch}: launches {counts}, predicted {want}")
    # bf16 at d = dv in {64, 128}, k <= 16: every FlashSFA launch and the
    # compact seam's proj_rtopk on the tensor-core bodies, code_grad dx and
    # dW on theirs at code width 8, 16 or 32
    want_bodies = {name: (bodies or {}).get(name, 0) * steps for name in body_counts()}
    check(body_counts() == want_bodies,
          f"train {arch}: body launches {body_counts()}, predicted {want_bodies}")
    if policy.get("bwd_emit") in ("compact", "compact2"):
        taken = "proj_rtopk" in predicted
        check(len(seams) == 1 and seams[0].taken == taken and (taken or seams[0].reason),
              f"train {arch}: compact seam {seams}")
    check(all(r.eligible for r in remats), f"train {arch}: remat degraded: {remats}")
    if distill:
        # the stop-grad teacher is plain chunked attention (the reference's
        # is XLA's chunked_attention, not a Pallas kernel): no launch of its own
        check(all(h["aux"] > 0 for h in hist), f"train {arch}: distill aux terms {hist}")
        if policy.get("bwd_emit") in ("compact", "compact2"):
            from repro_torch.core.reports import collect_reports
            routes = collect_reports("compact_seam")
            check([(r.eligible, r.reason) for r in routes]
                  == [(False, "distill needs the dense q/k/v for the stop-grad teacher")],
                  f"train {arch} (distill): compact seam routes {routes}")
    t0 = time.perf_counter()
    markov_batch(dcfg, 0)
    data_ms = (time.perf_counter() - t0) * 1e3
    kernels, traced_ms = trace_kernels(lambda: tr.run_step(steps))
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    timed = step_ms[1:]
    tokens = batch * seq
    label = ", ".join(f"{k} {v}" for k, v in policy.items())
    fl = step_flops(dataclasses.replace(cfg, remat=policy["remat"]),
                    ShapeConfig("chip", seq, batch, "train"))
    step_s = np.mean(timed) / 1e3
    moe_note = ("; the total counts the reference's one-hot dispatch and combine einsums, "
                "which the port's index dispatch does not run, and model FLOPs are "
                "6 N_active" if cfg.moe is not None else "")
    print(f"[train] {arch}: step FLOPs (utils.analytic.step_flops) total "
          f"{fl['total_flops']:.4g} (model 6N {fl['model_flops']:.4g}); at the mean step, "
          f"{100 * fl['total_flops'] / step_s / BF16_TC_FLOPS:.2f}% of the bf16 peak "
          f"(model FLOPs {100 * fl['model_flops'] / step_s / BF16_TC_FLOPS:.2f}%){moe_note}")
    print(f"[train] {arch} full width bf16, {depth}, batch {batch} x seq {seq}, {label}"
          + (f", sfa_distill {distill}" if distill else "") + ", AdamW; "
          f"losses {[round(h['loss'], 4) for h in hist]}"
          + (f" (aux, the distillation term x {distill}: "
             f"{[round(h['aux'], 6) for h in hist]})" if distill else "")
          + f", grad norms {[round(h['grad_norm'], 3) for h in hist]}")
    print(f"[train] {arch}: warm-up step {step_ms[0]:.1f} ms; timed steps ms "
          f"{[round(x, 2) for x in timed]} (mean {np.mean(timed):.2f}, median "
          f"{np.median(timed):.2f}); {tokens / (np.mean(timed) / 1e3):.1f} tokens/s; "
          f"host data generation {data_ms:.1f} ms of each step; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts} (predicted {want}); fallbacks none")
    print(f"[train] {arch}: traced step (profiler on): wall {traced_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / traced_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / traced_ms:.1f}%); top kernels by device time: "
          + "; ".join(f"{name[:48]} {us / 1e3:.2f} ms" for name, us in top))
    # the port's kernels live in anonymous namespaces (as do a few of torch's)
    ours = sorted(((name.split("::", 1)[1], us) for name, us in kernels.items()
                   if name.startswith("void (anonymous namespace)::")), key=lambda kv: -kv[1])
    print(f"[train] {arch}: kernels of anonymous namespaces in the traced step (the port's, "
          f"a few of torch's): " + "; ".join(f"{name[:56]} {us / 1e3:.2f} ms"
                                              for name, us in ours))
    if seams:
        print(f"[train] {arch}: compact seam "
              + (f"taken (fused forward {seams[0].fused_fwd})" if seams[0].taken
                 else f"declined: {seams[0].reason}")
              + f"; remat {[(r.requested, r.applied) for r in remats]}; CUDA-core bodies "
              f"{body_counts()}")
    return counts, dict(step_ms=float(np.mean(timed)), tokens_s=tokens / (np.mean(timed) / 1e3),
                        peak_gib=peak / 2**30, busy=busy_ms / traced_ms)


def _frame_batch(cfg, batch, seq, seed):
    """An audio model's batch: seeded frame features (batch, seq,
    input_dim) f32 and per-frame labels in [0, vocab) (the JAX package has
    no frame pipeline; its Trainer builds token batches)."""
    rs = np.random.RandomState(seed)
    return {"frames": rs.randn(batch, seq, cfg.frontend.input_dim).astype(np.float32),
            "labels": rs.randint(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)}


def phase_train_frames(arch, timed_steps, predicted, *, layers=None, bodies=None, **policy):
    """Train full-width audio ``arch`` in bf16 through ``make_train_step``
    (AdamW; ``policy`` overrides the TrainPolicy, default dense emit, remat
    "full") on seeded frame batches of 8 x 1024: 1 warm-up and
    ``timed_steps`` timed steps with the launch counts read over all of
    them (``predicted`` per step; ``bodies``: the CUDA-core and warp bodies
    per step), then one traced step. A compact request must take the seam
    at every layer where proj_rtopk is predicted, and "codes" must be kept.
    Prints step ms, peak memory, the busy share and the step's FLOPs
    (``utils.analytic.step_flops``) as a share of the bf16 peak. Returns
    (launch counts, step summary)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainPolicy
    from repro_torch.core.reports import clear_reports, collect_reports
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.models import init
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils.analytic import step_flops
    cfg = get_config(arch)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of {cfg.num_layers} layers (depth cut)"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    batch, seq = 8, TRAIN_N
    steps = 1 + timed_steps
    policy = dict({"remat": "full", "bwd_emit": "dense"}, **policy)
    opt = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=steps + 1)
    step = make_train_step(cfg, opt, policy=TrainPolicy.from_model(cfg, **policy))
    model = init(cfg, device="cuda", seed=SEED).requires_grad_(True)
    state = init_opt_state(dict(model.named_parameters()))
    data = [_frame_batch(cfg, batch, seq, SEED + 70 + i) for i in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_fallback_reports()
    clear_reports()
    reset_launches()
    hist, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model, state, m = step(model, state, data[i])
        hist.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts, reports = launch_counts(), fallback_reports()
    routes = collect_reports()
    peak = torch.cuda.max_memory_allocated()
    want = {name: predicted.get(name, 0) * steps for name in counts}
    want_bodies = {name: (bodies or {}).get(name, 0) * steps for name in body_counts()}
    seams = [r for r in routes if r.component == "compact_seam"]
    remats = [r for r in routes if r.component == "remat"]
    if policy["bwd_emit"] in ("compact", "compact2"):
        check(seams and all(r.eligible for r in seams) and "proj_rtopk" in predicted,
              f"train {arch}: compact seam {seams}")
    check(all(r.eligible for r in remats), f"train {arch}: remat degraded: {remats}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"train {arch}: non-finite loss or gradient norm: {hist}")
    check(not reports, f"train {arch}: backend fallbacks recorded: {reports}")
    check(counts == want, f"train {arch}: launches {counts}, predicted {want}")
    check(body_counts() == want_bodies,
          f"train {arch}: body launches {body_counts()}, predicted {want_bodies}")
    kernels, traced_ms = trace_kernels(lambda: step(model, state, data[steps]))
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    timed_ms = step_ms[1:]
    tokens = batch * seq
    fl = step_flops(dataclasses.replace(cfg, remat=policy["remat"]),
                    ShapeConfig("chip", seq, batch, "train"))
    step_s = np.mean(timed_ms) / 1e3
    label = ", ".join(f"{k} {v}" for k, v in policy.items())
    ours = sorted(((name.split("::", 1)[1], us) for name, us in kernels.items()
                   if name.startswith("void (anonymous namespace)::")), key=lambda kv: -kv[1])
    print(f"[train] {arch}: step FLOPs (utils.analytic.step_flops) total "
          f"{fl['total_flops']:.4g} (model 6N {fl['model_flops']:.4g}); at the mean step, "
          f"{100 * fl['total_flops'] / step_s / BF16_TC_FLOPS:.2f}% of the bf16 peak "
          f"(model FLOPs {100 * fl['model_flops'] / step_s / BF16_TC_FLOPS:.2f}%)")
    print(f"[train] {arch} full width bf16, {depth}, batch {batch} x {seq} seeded frames "
          f"({cfg.frontend.input_dim} features), bidirectional, {label}, AdamW; "
          f"losses {[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]}")
    print(f"[train] {arch}: warm-up step {step_ms[0]:.1f} ms; timed steps ms "
          f"{[round(x, 2) for x in timed_ms]} (mean {np.mean(timed_ms):.2f}, median "
          f"{np.median(timed_ms):.2f}); {tokens / step_s:.1f} frames/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts} (predicted {want}); bodies "
          f"{body_counts()} (predicted {want_bodies}); fallbacks none")
    print(f"[train] {arch}: traced step (profiler on): wall {traced_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / traced_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / traced_ms:.1f}%); top kernels by device time: "
          + "; ".join(f"{name[:48]} {us / 1e3:.2f} ms" for name, us in top))
    print(f"[train] {arch}: kernels of anonymous namespaces in the traced step (the port's, "
          f"a few of torch's): " + "; ".join(f"{name[:56]} {us / 1e3:.2f} ms"
                                              for name, us in ours))
    if seams:
        print(f"[train] {arch}: collect_reports(): compact_seam taken at {len(seams)} "
              f"site(s) (every layer of the stack), {[r.where for r in seams]}; remat "
              f"{[(r.where, r.reason) for r in remats] or 'as requested'}")
    del model, state
    return counts, dict(step_ms=float(np.mean(timed_ms)), peak_gib=peak / 2**30,
                        busy=busy_ms / traced_ms)


def _grad_batch(cfg, seed):
    """Batch 1 x 512 for the gradient checks: a Markov token batch, or an
    audio model's seeded frames and labels, on the card."""
    from repro_torch.data import DataConfig, markov_batch
    from repro_torch.train.train_step import to_batch
    if cfg.family == "audio":
        return to_batch(_frame_batch(cfg, 1, 512, seed), "cuda")
    return to_batch(markov_batch(DataConfig(cfg.vocab_size, 512, 1, seed=seed), 0), "cuda")


def _grads(loss, params):
    """Every parameter's gradient; one that the loss never reads (an audio
    model's learned positions) as zeros."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g for p, g in zip(params, grads))


GRAD_RUNS = (("torch", "torch", "none", "dense"),
             ("cuda dense emit, remat full", "cuda", "full", "dense"),
             ("cuda compact seam, remat codes", "cuda", "codes", "compact"),
             ("cuda compact2 seam, remat codes", "cuda", "codes", "compact2"))
# launches a layer of a cuda run: the dense emit under remat "full" (the
# forward twice, rtopk for q and k each time) and the compact seam under
# remat "codes" (the backward's rerun takes the kept codes)
GRAD_LAUNCHES = {
    "dense": {"rtopk": 4, "flash_sfa": 2, "flash_sfa_bwd": 1},
    "compact": {"proj_rtopk": 2, "flash_sfa_block_skip": 2, "flash_sfa_bwd_compact": 1,
                "code_grad_dx": 2, "code_grad_dw": 2},
}


def _own_y_dense(cfg):
    """``models.layers.dense`` whose q and k columns of the packed qkv
    projection take their values from proj_rtopk's own f32 y (k = d: every
    entry, before RoPE) and their gradient from the dense product: the
    plain path on the y the compact seam selects from."""
    from repro_torch.kernels import proj_rtopk
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.models import layers as L
    a = cfg.attention
    h, hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim

    def dense(params, x, dtype=None):
        y = L.dense(params, x, dtype)
        if y.shape[-1] != (h + 2 * hkv) * hd:
            return y
        b, n, _ = x.shape
        own = proj_rtopk(x.detach(), head_blocks(params["w"].detach(), 0, h + hkv, hd), k=hd)[0]
        own = own.transpose(1, 2).reshape(b, n, (h + hkv) * hd)
        qk = y[..., :(h + hkv) * hd]
        return torch.cat([qk + (own - qk).detach(), y[..., (h + hkv) * hd:]], dim=-1)
    return dense


def _layer0_code_flips(model, cfg, batch):
    """Layer 0's q and k codes from the compact seam's fused projection
    (proj_rtopk) against the torch path's (dense projection, RoPE, plain
    top-k) on the same f32 input: rows whose index sets differ must sit at
    a near-tie of the torch path's magnitudes (2^-17 relative, f32 sums of
    m terms in two orders). -> (rows that differ, rows)."""
    from repro_torch.kernels.ops import fused_qk_codes
    from repro_torch.kernels.ref import rtopk_ref
    from repro_torch.models import layers as L
    from repro_torch.models.attention import split_qkv
    a = cfg.attention
    h, hkv, hd, k = a.num_heads, a.num_kv_heads, a.head_dim, a.sfa_k
    with torch.no_grad():
        x = model.embed.w[batch["tokens"]].float()
        if cfg.norm == "rmsnorm":
            x = x * cfg.d_model ** 0.5
        p = L.tree_index(model.tree()["segments"][0], 0)
        x = L.apply_norm(p["ln1"], x, cfg.norm)
        n = x.shape[1]
        pos = torch.arange(n, device=x.device)[None, :]
        q, kk, _ = split_qkv(L.dense(p["attn"]["w_qkv"], x), h, hkv, hd)
        got = fused_qk_codes(x, p["attn"]["w_qkv"]["w"], pos, h=h, hkv=hkv, hd=hd, sfa_k=k,
                             rope_spec=(a.rope_theta, hd))
        diff = rows = 0
        for y, idx in ((q, got[1]), (kk, got[3])):
            y = L.rope(y, pos, theta=a.rope_theta).transpose(1, 2).reshape(-1, n, hd)
            d_rows, n_diff, n_tie = near_ties(y, idx, rtopk_ref(y, k)[1], k, 2.0 ** -17)
            check(n_diff == n_tie, f"layer 0 codes: {n_diff - n_tie} rows differ from the torch "
                                   f"path's without a near-tie")
            diff, rows = diff + n_diff, rows + d_rows.numel()
    return diff, rows


def phase_grad_end_to_end(arch="gpt2-small-sfa8", layers=None, runs=GRAD_RUNS[:3], own_y=False,
                          leaf_tol=1e-3, distill=0.0):
    """Loss and every parameter gradient, kernels against plain, float32,
    full width (``layers`` cuts the depth); ``runs``: (label, backend,
    remat, emit), the torch run first. A cuda run launches as
    ``GRAD_LAUNCHES`` predicts a layer and records no fallback; with
    ``distill`` (``sfa_distill``, paper Eq. 8) its aux term is held to the
    torch run's beside the loss. With ``own_y`` (the compact seam at
    a width where f32 sums of d_model terms in two orders part top-k
    near-ties): layer 0's seam codes are held to the torch path's but at
    near-ties, and the torch run takes its q and k values from
    proj_rtopk's own f32 y (``_own_y_dense``), so both runs select from the
    same y; the plain torch run's distance is printed beside it. Each
    leaf's relative L2 is held to ``leaf_tol``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.models import init, loss_fn
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    cfg = dataclasses.replace(get_config(arch), dtype="float32", sfa_distill=distill)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of {cfg.num_layers} layers (depth cut)"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = init(cfg, device="cuda", seed=SEED).requires_grad_(True)
    named = dict(model.named_parameters())
    batch = _grad_batch(cfg, SEED + 2)
    runs_out, bodies, aux = {}, {}, {}
    if own_y:
        from repro_torch.models import attention as attn_mod
        c = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention,
                                                                   backend="torch"))
        loss, _ = loss_fn(model, batch, c)
        plain = (loss.item(), torch.autograd.grad(loss, list(named.values())))
        saved, attn_mod.dense = attn_mod.dense, _own_y_dense(cfg)
        try:
            loss, metrics = loss_fn(model, batch, c)
            runs_out["torch"] = (loss.item(), torch.autograd.grad(loss, list(named.values())))
            aux["torch"] = metrics["aux"].item()
        finally:
            attn_mod.dense = saved
        runs = [r for r in runs if r[0] != "torch"]
        flips, rows = _layer0_code_flips(model, cfg, batch)
        print(f"[grad end-to-end] f32 {cfg.name}: layer 0's seam codes differ from the torch "
              f"path's on {flips} of {rows} rows, each at a near-tie (2^-17 relative)")
    for label, backend, remat, emit in runs:
        c = dataclasses.replace(cfg, remat=remat, attention=dataclasses.replace(
            cfg.attention, backend=backend, bwd_emit=emit, fwd_fuse=True))
        reset_launches()
        clear_fallback_reports()
        loss, metrics = loss_fn(model, batch, c)
        runs_out[label] = (loss.item(), _grads(loss, list(named.values())))
        aux[label] = metrics["aux"].item()
        counts = launch_counts()
        bodies[label] = {n_: v for n_, v in body_counts().items() if v}
        check(not fallback_reports(), f"gradients end to end ({label}): fallbacks "
                                      f"{fallback_reports()}")
        per = {} if backend == "torch" else GRAD_LAUNCHES[
            "dense" if emit == "dense" else "compact"]
        want = {n_: per.get(n_, 0) * cfg.num_layers for n_ in counts}
        check(counts == want, f"gradients end to end ({label}): launches {counts}, predicted "
                              f"{want}")
    lb, gb = runs_out.pop("torch")
    if distill:
        check(aux["torch"] > 0, f"gradients end to end: distill aux {aux}")
    for label, (la, ga) in runs_out.items():
        if own_y:
            dist = {name: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                    for name, a, b in zip(named, ga, plain[1])}
            print(f"[grad end-to-end] f32 {cfg.name}, {label} against the plain torch run "
                  f"(its own dense projection; not held to 1e-3, the seam parts from it at "
                  f"near-ties): loss {la:.6f} vs {plain[0]:.6f}; relative L2 per leaf "
                  + ", ".join(f"{n_} {e:.3g}" for n_, e in dist.items()))
        check(np.isfinite(la), f"gradients end to end ({label}): non-finite loss")
        # tolerance: f32, sums in another order (1e-6 relative expected); a
        # top-k tie that the two orders break apart moves one coordinate of
        # one row, so 1e-4 on the loss and 1e-3 relative (L2) on each leaf
        # (``leaf_tol`` 1e-4 where the caller holds a stack to that)
        check(abs(la - lb) <= 1e-4, f"gradients end to end ({label}): loss {la} vs {lb}")
        check(abs(aux[label] - aux["torch"]) <= 1e-4 * max(1.0, abs(aux["torch"])),
              f"gradients end to end ({label}): aux {aux[label]} vs {aux['torch']}")
        worst = (0.0, "")
        for name, a, b in zip(named, ga, gb):
            check(bool(torch.isfinite(a).all()),
                  f"gradients end to end ({label}): non-finite d{name}")
            rel = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
            check(rel <= leaf_tol, f"gradients end to end ({label}): d{name} relative error "
                                   f"{rel:.3g} > {leaf_tol:g}")
            worst = max(worst, (rel, name))
        print(f"[grad end-to-end] f32 {cfg.name} full width, {depth}, batch 1 x seq 512, "
              f"{label}" + (f", sfa_distill {distill}" if distill else "")
              + f" (CUDA-core bodies {bodies[label]}; launches as predicted, no fallback): "
              f"loss {la:.6f} vs torch {lb:.6f} (|diff| {abs(la - lb):.3g}, tol 1e-4); "
              + (f"aux {aux[label]:.6g} vs {aux['torch']:.6g}; " if distill else "")
              + f"all {len(named)} parameter gradients "
              f"within {leaf_tol:g} relative L2, worst {worst[0]:.3g} ({worst[1]})"
              + (" (torch run on proj_rtopk's own y)" if own_y else ""))


def phase_dense_grad_end_to_end():
    """Loss and every parameter gradient of the dense baseline in bf16, the
    tensor-core kernels against plain."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, markov_batch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import init, loss_fn
    from repro_torch.train.train_step import to_batch
    cfg = get_config("gpt2-small")
    check(cfg.dtype == "bfloat16", f"gpt2-small trains in {cfg.dtype}, expected bfloat16")
    model = init(cfg, device="cuda", seed=SEED).requires_grad_(True)
    named = dict(model.named_parameters())
    batch = to_batch(markov_batch(DataConfig(cfg.vocab_size, 512, 1, seed=SEED + 3), 0), "cuda")
    runs = {}
    for backend, remat in (("torch", "none"), ("cuda", "full")):
        c = dataclasses.replace(cfg, remat=remat, attention=dataclasses.replace(
            cfg.attention, backend=backend))
        reset_launches()
        loss, _ = loss_fn(model, batch, c)
        runs[backend] = (loss.item(), torch.autograd.grad(loss, list(named.values())))
        if backend == "cuda":
            counts = launch_counts()
    layers = cfg.num_layers
    check(counts["flash_attention"] == 2 * layers and counts["flash_attention_bwd"] == layers,
          f"dense gradients end to end: launches {counts}, expected flash_attention "
          f"{2 * layers} (forward and remat rerun) and flash_attention_bwd {layers}")
    (lb, gb), (la, ga) = runs["torch"], runs["cuda"]
    # tolerance: both runs are bf16 end to end and differ only in the
    # attention, where each rounds its f32 result to bf16 once (one ulp,
    # 2^-8 relative, apart at most); twelve layers of bf16 matmuls carry
    # that into a ~1e-2 relative difference of a gradient. So 1e-2 on the
    # loss and 5e-2 relative (L2) on each leaf; a wrong mask, scale or
    # product moves the attention leaves by O(1).
    check(np.isfinite(la) and abs(la - lb) <= 1e-2,
          f"dense gradients end to end: loss {la} vs torch {lb}")
    worst = (0.0, "")
    for name, a, b in zip(named, ga, gb):
        check(bool(torch.isfinite(a).all()), f"dense gradients end to end: non-finite d{name}")
        rel = ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
        check(rel <= 5e-2, f"dense gradients end to end: d{name} relative error {rel:.3g} > 5e-2")
        worst = max(worst, (rel, name))
    print(f"[grad end-to-end] bf16 {cfg.name} full width, batch 1 x seq 512, cuda (remat full; "
          f"flash_attention {counts['flash_attention']}, flash_attention_bwd "
          f"{counts['flash_attention_bwd']} launches) vs torch (remat none): loss {la:.6f} vs "
          f"{lb:.6f} (|diff| {abs(la - lb):.3g}, tol 1e-2); all {len(named)} parameter "
          f"gradients within 5e-2 relative L2, worst {worst[0]:.3g} ({worst[1]})")


def phase_sfa_grad_bf16_end_to_end(arch="gpt2-small-sfa8", layers=None, compact=True):
    """Loss and every parameter gradient of ``arch`` (full width; ``layers``
    cuts the depth) in bf16, the tensor-core FlashSFA bodies (dense emit
    under remat "full", and with ``compact`` the compact seam under remat
    "codes") against the torch backend. Top-k at bf16 flips near-ties
    wherever two runs round differently, so the tolerance is the torch
    backend's own distance, at these weights and this batch, from the
    float32 run of the same weights. Every FlashSFA launch must take the
    tensor-core body (hubert's d 80 and paligemma's d 256 too); where a
    shape had none, the CUDA-core bodies would have to run instead."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.kernels.flash_sfa import tensor_core_body
    from repro_torch.kernels.rtopk import one_thread_body
    from repro_torch.models import init, loss_fn
    cfg = get_config(arch)
    depth = f"{cfg.num_layers} layers"
    if layers is not None:
        depth = f"{layers} of {cfg.num_layers} layers (depth cut)"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    check(cfg.dtype == "bfloat16", f"{arch} trains in {cfg.dtype}, expected bfloat16")
    model = init(cfg, device="cuda", seed=SEED).requires_grad_(True)
    named = dict(model.named_parameters())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = init(cfg32, device="cuda", seed=SEED)
    with torch.no_grad():
        for name, p in model32.named_parameters():
            p.copy_(named[name].float())
    model32.requires_grad_(True)
    batch = _grad_batch(cfg, SEED + 4)
    a = cfg.attention
    on_tc = tensor_core_body(torch.bfloat16, a.head_dim, a.head_dim, a.sfa_k, a.sfa_k)

    def run(m, c, **attention):
        c = dataclasses.replace(c, remat=attention.pop("remat", "none"),
                                attention=dataclasses.replace(c.attention, **attention))
        loss, _ = loss_fn(m, batch, c)
        grads = _grads(loss, list(m.parameters()))
        return loss.item(), {n: g.float() for n, g in zip(dict(m.named_parameters()), grads)}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    l32, g32 = run(model32, cfg32, backend="torch")
    lt, gt = run(model, cfg, backend="torch")
    check(np.isfinite(lt), "sfa bf16 gradients end to end: non-finite torch loss")
    noise = {name: rel(gt[name], g32[name]) for name in named}
    print(f"[grad end-to-end] bf16 {cfg.name} full width, {depth}, batch 1 x seq 512: the torch "
          f"backend in bf16 against float32 on the same weights: loss {lt:.6f} vs {l32:.6f}; "
          f"relative L2 per leaf " + ", ".join(f"{n} {e:.3g}" for n, e in noise.items()))
    for label, remat, emit, rows in (
            ("dense emit, remat full", "full", "dense", ("rtopk", "flash_sfa", "flash_sfa_bwd")),
            ("compact seam, remat codes", "codes", "compact",
             ("proj_rtopk", "flash_sfa_block_skip", "flash_sfa_bwd_compact", "code_grad_dx",
              "code_grad_dw")))[:2 if compact else 1]:
        reset_launches()
        la, ga = run(model, cfg, backend="cuda", remat=remat, bwd_emit=emit, fwd_fuse=True)
        counts = launch_counts()
        check(all(counts[r] > 0 for r in rows),
              f"sfa bf16 gradients end to end ({label}): kernels not launched {counts}")
        if on_tc:
            # no CUDA-core body; rtopk's warp body only where the head is
            # wider than its one-thread body takes (hubert's 80, paligemma's 256)
            bc = body_counts()
            warp = 0 if one_thread_body(a.head_dim, a.sfa_k) else counts["rtopk"]
            check(bc == dict({name: 0 for name in bc}, rtopk_warp=warp),
                  f"sfa bf16 gradients end to end ({label}): bodies {bc}, launches {counts}")
        else:
            bc = body_counts()
            check(bc["flash_sfa_cuda_core"] == counts["flash_sfa"]
                  and bc["flash_sfa_bwd_cuda_core"] == counts["flash_sfa_bwd"],
                  f"sfa bf16 gradients end to end ({label}): bodies {bc}, launches {counts}")
        # tolerance: the cuda and torch runs differ only in the attention
        # (and, on the seam, the fused projection), each rounding its f32
        # result to bf16 once; the torch run differs from float32 in every
        # product. So the cuda run stays within twice the torch run's
        # distance from float32, plus 1e-2 (a leaf the flips barely move):
        # |loss - torch| <= 2 |torch - f32| + 1e-2 and each leaf's relative
        # L2 from torch <= 2 x its torch-from-f32 error + 1e-2. A wrong
        # mask, scale, emit or support moves the attention leaves by O(1).
        tol = 2 * abs(lt - l32) + 1e-2
        check(np.isfinite(la) and abs(la - lt) <= tol,
              f"sfa bf16 gradients end to end ({label}): loss {la} vs torch {lt} (tol {tol:.3g})")
        worst = (0.0, "", 0.0)
        for name in named:
            check(bool(torch.isfinite(ga[name]).all()),
                  f"sfa bf16 gradients end to end ({label}): non-finite d{name}")
            e, t = rel(ga[name], gt[name]), 2 * noise[name] + 1e-2
            check(e <= t, f"sfa bf16 gradients end to end ({label}): d{name} relative error "
                          f"{e:.3g} > {t:.3g}")
            worst = max(worst, (e / t, name, e))
        print(f"[grad end-to-end] bf16 {cfg.name} full width, {depth}, batch 1 x seq 512, cuda "
              f"{label} (launches {', '.join(f'{r} {counts[r]}' for r in rows)}; "
              f"{'no CUDA-core body' if on_tc else 'the CUDA-core bodies'}) vs torch: loss {la:.6f} vs {lt:.6f} (|diff| {abs(la - lt):.3g}, tol "
              f"{tol:.3g}); all {len(named)} parameter gradients within their tolerance, "
              f"nearest to it d{worst[1]} at {worst[2]:.3g} ({100 * worst[0]:.1f}% of its "
              f"tolerance)")


# --------------------------------------------------------------------------
# phase 11: the attention variants (windows, MLA, protected RoPE dims)
# --------------------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _requesting_cuda(cfg):
    """``cfg`` with both attention backends asked for as "cuda" explicitly:
    every layer of this slice's paths must decline them (as the reference's
    pallas backends decline windows, protected RoPE dims and MLA) and record
    why, running on the torch backend."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend="cuda", decode_backend="cuda"))


def phase_variant_serve(model, cfg, depth, reason, *, long_prompt=None, mla=False,
                        speculative=False, device="cuda"):
    """Serve ``cfg`` at full width through the slot engine (8 slots,
    max_len 2048, 8 requests of 64-1024 prompt tokens, ``long_prompt`` the
    first one's length where given, 32 greedy tokens each, bf16), then the
    paged engine at full residency with whole-prompt prefill, then chunked
    prefill (256 a tick, the first 4 requests) and with ``speculative`` the
    speculative engine
    (draft_len 4): the latter three's streams equal the slot streams or part
    at a near-tie. With ``mla`` the chunked and speculative engines must
    raise the reference's NotImplementedError instead. The KV cache at rest
    equals the byte model; no kernel launches (none lies on these paths);
    every fallback report names torch with ``reason``; a traced window of 4
    decode steps gives the device's busy share."""
    from repro_torch.core.kv_cache import kv_cache_nodes
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.serve import (
        DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig,
        SpeculativeDecodeEngine, SpeculativeEngineConfig, cache_bytes_per_token,
    )
    req = _requesting_cuda(cfg)
    rs = np.random.RandomState(SEED)
    lens = rs.randint(64, 1025, size=8)
    if long_prompt is not None:
        lens[0] = long_prompt
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int64) for n in lens]
    warm = DecodeEngine(model, req, EngineConfig(max_slots=1, max_len=128), device=device)
    warm.add_request(prompts[1][:64], 3)
    while warm.live.any():
        warm.step()
    del warm
    clear_fallback_reports()
    reset_launches()
    eng = DecodeEngine(model, req, EngineConfig(max_slots=8, max_len=2048), device=device)
    _sync(device)
    t_start, prefill_ms = time.perf_counter(), []
    for p in prompts:
        t0 = time.perf_counter()
        eng.add_request(p, max_new_tokens=32)
        _sync(device)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    while eng.live.any():
        t0 = time.perf_counter()
        eng.step()
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    outputs = [eng.outputs[s] for s in range(8)]
    check(all(len(o) == 32 for o in outputs), "variant serve: a request did not get 32 tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          "variant serve: token out of vocabulary")
    model_bytes = cache_bytes_per_token(cfg)["sfa"] * 8 * eng._cache_len
    check(eng.cache_bytes() == model_bytes, f"variant serve: kv cache {eng.cache_bytes()} bytes, "
                                            f"the byte model {model_bytes}")
    layouts = sorted({type(n).__name__ for n in kv_cache_nodes(eng.caches)})
    tokens = sum(len(o) for o in outputs)
    print(f"[variant] {cfg.name} full width bf16, {depth}, backend and decode_backend 'cuda' "
          f"requested, 8 slots, max_len 2048, prompt lengths {lens.tolist()}")
    print(f"[variant] slot engine: prefill ms per request {[round(x, 2) for x in prefill_ms]} "
          f"(mean {np.mean(prefill_ms):.2f}); decode ms per step mean {np.mean(step_ms):.3f} "
          f"p50 {np.median(step_ms):.3f} over {len(step_ms)} steps; "
          f"{(tokens - 8) / (sum(step_ms) / 1e3):.1f} decode tokens/s, {tokens / wall:.1f} "
          f"tokens/s overall; kv cache {eng.cache_bytes() / 2**20:.2f} MiB ({', '.join(layouts)}; "
          f"equal to cache_bytes_per_token x 8 x {eng._cache_len}); slot 0 tokens {outputs[0]}")
    common = dict(max_slots=8, max_len=2048, page_size=128)
    paged = PagedDecodeEngine(model, req, PagedEngineConfig(**common), device=device)
    p_out, p_ms, _, _ = _serve(paged, prompts, 32)
    parted = _near_tie_divergences(model, cfg, prompts, p_out, outputs, SPEC_TIE)
    print(f"[variant] paged engine, full residency ({paged.num_pages - 1} pages), whole-prompt "
          f"prefill: ms per tick mean {np.mean(p_ms[1:]):.3f} (first tick, with the 8 "
          f"prefills, {p_ms[0]:.1f}); kv cache {paged.cache_bytes() / 2**20:.2f} MiB; "
          f"{8 - len(parted)} of 8 streams equal the slot streams, the others part at a "
          f"near-tie (gap <= {SPEC_TIE}): {parted}")
    del paged
    chunked = PagedDecodeEngine(model, req, PagedEngineConfig(**common, prefill_chunk=256),
                                device=device)
    if mla:
        chunked.add_request(prompts[1], 4)
        try:
            chunked.step()
        except NotImplementedError as e:
            refusal = str(e)
        else:
            refusal = None
        check(refusal is not None and "whole-prompt prefill" in refusal,
              f"variant serve: chunked prefill of MLA caches did not refuse: {refusal}")
        try:
            SpeculativeDecodeEngine(model, req, SpeculativeEngineConfig(**common),
                                    device=device)
            spec_refusal = None
        except NotImplementedError as e:
            spec_refusal = str(e)
        check(spec_refusal is not None and "MLA" in spec_refusal,
              "variant serve: the speculative engine took MLA caches")
        print(f"[variant] chunked prefill refused: {refusal!r}; the speculative engine "
              f"refused: {spec_refusal!r}")
    else:
        # the first 4 requests (the long prompt among them): chunk ticks
        # score a chunk's queries as that many decodes, the phase's cost
        c_out, c_ms, _, _ = _serve(chunked, prompts[:4], 32)
        parted = _near_tie_divergences(model, cfg, prompts[:4], c_out, outputs[:4], SPEC_TIE)
        print(f"[variant] paged engine, chunked prefill 256, the first 4 requests: {len(c_ms)} "
              f"ticks, ms per tick mean {np.mean(c_ms):.3f} p50 {np.median(c_ms):.3f}; "
              f"{4 - len(parted)} of 4 streams equal the slot streams, the others part at a "
              f"near-tie: {parted}")
    del chunked
    if speculative:
        spec = SpeculativeDecodeEngine(model, req, SpeculativeEngineConfig(
            **common, draft_len=4), device=device)
        s_out, s_ms, _, _ = _serve(spec, prompts, 32)
        parted = _near_tie_divergences(model, cfg, prompts, s_out, outputs, SPEC_TIE)
        st = spec.spec_stats
        print(f"[variant] speculative engine, draft_len 4, draft_k {spec.draft_k}: "
              f"{len(s_ms)} ticks, alpha {st['alpha']:.4f}, emitted tokens per tick "
              f"{st['acc_per_step']:.4f}, ms per tick mean {np.mean(s_ms[1:]):.3f}; "
              f"{8 - len(parted)} of 8 streams equal the slot streams, the others part at "
              f"a near-tie: {parted}")
        del spec
    counts, reports = launch_counts(), fallback_reports()
    check(not any(counts.values()), f"variant serve: a kernel launched on a torch path: {counts}")
    check(reports and all(r.selected == "torch" and r.reason == reason for r in reports),
          f"variant serve: fallback reports {reports}")
    for p in prompts:
        eng.add_request(p, max_new_tokens=5)
    _sync(device)
    kernels, traced_ms = trace_kernels(lambda: [eng.step() for _ in range(4)])
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    print(f"[variant] launches: none; fallback reports {len(reports)}, all torch, all "
          f"{reason!r}, at {sorted({r.where for r in reports})}; traced 4 decode steps "
          f"(profiler on): wall {traced_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / max(traced_ms, 1e-9):.1f}%); top kernels: "
          + "; ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in top))
    return dict(step_ms=float(np.mean(step_ms)), cache_bytes=eng.cache_bytes())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device)


def phase_variant_end_to_end(model, cfg, depth, prompt_len, device="cuda"):
    """The card against the port on the CPU, float32 with f32 caches: prefill
    of a seeded ``prompt_len``-token prompt and 8 teacher-forced decode
    steps, max |logit diff| <= 1e-4 and the argmax equal at every step.
    These layers run on the torch backend on both, so this holds the card's
    arithmetic to the CPU's (which the CPU tests hold to the JAX package)."""
    from repro_torch.models import decode_step, init_decode_caches, prefill
    from repro_torch.models.model import Model, insert_slot
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = Model(_tree_to(model.tree(), "cpu"), cfg32)
    rs = np.random.RandomState(SEED + 5)
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=prompt_len))[None]
    stream = rs.randint(0, cfg.vocab_size, size=8)
    runs, secs = {}, {}
    for dev, m in ((device, model), ("cpu", cpu)):
        t0 = time.perf_counter()
        logits, one = prefill(m, {"tokens": prompt.to(dev)}, cfg32)
        caches = insert_slot(init_decode_caches(cfg32, 1, prompt_len + 8, torch.float32,
                                                device=dev), one, slot=0,
                             max_len=prompt_len + 8)
        steps = [logits.cpu()]
        for i, tok in enumerate(stream):
            lg, caches = decode_step(m, torch.tensor([int(tok)], device=dev), caches,
                                     torch.tensor([prompt_len + i], device=dev), cfg32)
            steps.append(lg.cpu())
        runs[dev] = torch.cat(steps)
        secs[dev] = time.perf_counter() - t0
    a, b = runs[device], runs["cpu"]
    check(bool(torch.isfinite(a).all()), "variant end to end: non-finite logits")
    err = (a - b).abs().max().item()
    check(err <= 1e-4, f"variant end to end: max |logit diff| {err:.3g} > 1e-4")
    check(torch.equal(a.argmax(-1), b.argmax(-1)), "variant end to end: argmax differs")
    print(f"[variant end-to-end] f32 {cfg.name} full width, {depth}, f32 caches: "
          f"prefill({prompt_len}) + 8 teacher-forced decode steps, the card against the CPU "
          f"(torch backend on both; {secs[device]:.1f} s and {secs['cpu']:.1f} s): max "
          f"|logit diff| {err:.3g} (tol 1e-4), argmax equal at all 9 steps; max |logit| "
          f"{b.abs().max().item():.3g}")


def phase_variant_grads(arch, layers, device="cuda"):
    """Loss and every parameter gradient of ``arch`` at full width and
    ``layers`` layers, batch 1 x 512: float32 on the card against float32 on
    the CPU, 1e-4 on the loss and on each leaf's relative L2 (the torch
    backend on both: no second implementation runs on the card, so phase
    9's cuda-against-torch rule has no counterpart here); then bf16 on the
    card, finite, each leaf's relative L2 from the float32 run printed."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, markov_batch
    from repro_torch.models import init, loss_fn
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import to_batch
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = init(cfg32, device=device, seed=SEED).requires_grad_(True)
    cpu = Model(_tree_to(model.tree(), "cpu"), cfg32).requires_grad_(True)
    batch = markov_batch(DataConfig(cfg.vocab_size, 512, 1, seed=SEED + 4), 0)

    def run(m, c, dev):
        loss, _ = loss_fn(m, to_batch(batch, dev), c)
        names = [n for n, _ in m.named_parameters()]
        grads = _grads(loss, list(m.parameters()))
        return loss.item(), {n: g.detach().float().cpu() for n, g in zip(names, grads)}

    def rel(x, y):
        return ((x - y).norm() / y.norm().clamp(min=1e-30)).item()

    t0 = time.perf_counter()
    l_card, g_card = run(model, cfg32, device)
    l_cpu, g_cpu = run(cpu, cfg32, "cpu")
    secs = time.perf_counter() - t0
    check(abs(l_card - l_cpu) <= 1e-4, f"variant gradients: loss {l_card} vs CPU {l_cpu}")
    errs = {n: rel(g_card[n], g_cpu[n]) for n in g_cpu}
    worst = max(errs.items(), key=lambda kv: kv[1])
    check(worst[1] <= 1e-4, f"variant gradients: d{worst[0]} relative L2 {worst[1]:.3g} > 1e-4")
    l_bf, g_bf = run(model, cfg, device)
    check(np.isfinite(l_bf) and all(bool(torch.isfinite(g).all()) for g in g_bf.values()),
          "variant gradients: non-finite bf16 loss or gradient")
    bf = {n: rel(g_bf[n], g_card[n]) for n in g_card}
    print(f"[variant gradients] {cfg.name} full width, {layers} of {get_config(arch).num_layers} "
          f"layers, batch 1 x 512: f32 on the card vs the CPU ({secs:.1f} s): loss {l_card:.6f} "
          f"vs {l_cpu:.6f}, all {len(errs)} leaves within 1e-4 relative L2, worst d{worst[0]} "
          f"{worst[1]:.3g}; bf16 on the card: loss {l_bf:.6f}, relative L2 from f32 per leaf "
          + ", ".join(f"{n} {e:.3g}" for n, e in bf.items()))


def phase_variants():
    """Phases 11a-d: gemma3-4b served and trained at full width and 6 of 34
    layers; deepseek-v2-236b served at 3 of 60 layers; llama3.2-3b
    with sfa_rope_protect 64 served and trained at 4 of 28 layers; the f32
    checks at 2 layers (gemma3's gradients at 1). Returns nothing: no
    kernel lies on these paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import init
    from repro_torch.models.attention import compact_seam_reports
    release()
    gcfg = get_config("gemma3-4b")
    # 6 of 34 layers (the depth cut of the script's time budget): layer 5
    # is global, the other 5 local
    g6 = dataclasses.replace(gcfg, num_layers=6)
    model = init(g6, device="cuda", seed=SEED)
    timed(phase_variant_serve, model, g6, f"6 of {gcfg.num_layers} layers (depth cut)",
          "windowed attention not supported", long_prompt=1536, speculative=True)
    del model
    release()
    g2 = dataclasses.replace(gcfg, num_layers=2)
    model = init(g2, device="cuda", seed=SEED)
    timed(phase_variant_end_to_end, model, g2, f"2 of {gcfg.num_layers} layers (depth cut)", 1100)
    del model
    release()
    timed(phase_train, "gemma3-4b", 2, {}, layers=6)
    release()
    # 1 of 34 layers (local, as the second would be: the global one is layer 5)
    timed(phase_variant_grads, "gemma3-4b", 1)
    release()
    dcfg = get_config("deepseek-v2-236b")
    d3 = dataclasses.replace(dcfg, num_layers=3)
    model = init(d3, device="cuda", seed=SEED)
    timed(phase_variant_serve, model, d3, f"3 of {dcfg.num_layers} layers (depth cut)",
          "sfa_rope_protect dims not supported", mla=True)
    del model
    release()
    d2 = dataclasses.replace(dcfg, num_layers=2)
    model = init(d2, device="cuda", seed=SEED)
    timed(phase_variant_end_to_end, model, d2, f"2 of {dcfg.num_layers} layers (depth cut)", 512)
    del model
    release()
    lcfg = get_config("llama3.2-3b")
    l4 = dataclasses.replace(lcfg, num_layers=4, attention=dataclasses.replace(
        lcfg.attention, sfa_rope_protect=64))
    model = init(l4, device="cuda", seed=SEED)
    timed(phase_variant_serve, model, l4, f"4 of {lcfg.num_layers} layers (depth cut), "
          f"sfa_rope_protect 64", "sfa_rope_protect dims not supported", speculative=True)
    del model
    release()
    timed(phase_train, "llama3.2-3b", 1, {}, layers=4, attention={"sfa_rope_protect": 64})
    timed(phase_train, "llama3.2-3b", 1, {}, layers=4, attention={"sfa_rope_protect": 64},
          bwd_emit="compact")
    seams = compact_seam_reports()
    check([s.reason for s in seams] == ["sfa_rope_protect keeps leading dims dense outside "
                                        "the codes"], f"variant train: compact seam {seams}")
    release()


# rwkv6-3b's serving and training depth (the script's time budget)
RWKV_LAYERS = 4
# llama3-8b's serving depth (the script's time budget)
LLAMA8B_SERVE_LAYERS = 8
# jamba-v0.1-52b's attention sublayer (JB): 32 query heads over 8 kv heads
# of 128, k 16, no RoPE; its prefill of a 1,024-token prompt and its decode
# step (8 slots, pages of 128 for the image rows 13 reads)
JB = dict(b=1, h=32, hkv=8, d=128, k=16)
JB_DECODE = dict(b=8, h=32, hkv=8, d=128, k=16)
JB_PAGED = dict(slots=8, h=8, heads=32, d=128, k=16, dv=128, page=128, mp=16)


def phase_jamba_shapes(results):
    """Rows 1 and 3 at jamba's prefill (rtopk on the 32 heads' 32,768 rows,
    FlashSFA bh 32 x 1024 causal), row 1 at its decode step (256 query
    rows), rows 10 and 13 at its decode step (8 slots x 32 query heads over
    8 kv heads, n_max 2,048), each against its plain version and recorded as
    the shape "JB" ("JB decode" for row 1's decode) of its row's entry."""
    rs = np.random.RandomState(SEED + 70)
    _sfa_train_rows(results, rs, JB, "JB prefill", key="JB", dense=False, bwd=False)
    _rtopk_shape(results, rs, JB_DECODE["b"] * JB_DECODE["h"], JB["d"], JB["k"], "JB decode",
                 key="JB decode")
    _sfa_decode_rows(results, rs, JB_DECODE, JB_PAGED, "JB decode", key="JB", timed=(10, 13))


def _attention_layers(cfg):
    """The layers that hold attention (and KV): one a jamba super-block."""
    if cfg.attention is None:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_period
    return cfg.num_layers


def _state_bytes(cfg, slots):
    """The recurrent state's bytes at rest, bf16 caches: per Mamba sublayer
    the conv window (bf16) and h (f32); per rwkv layer two token-shift rows
    (bf16) and the WKV state (f32); none for the other families."""
    d = cfg.d_model
    if cfg.family not in ("hybrid", "ssm"):
        return 0
    if cfg.family == "hybrid":
        di, s = cfg.ssm.expand * d, cfg.ssm.state_dim
        per = (cfg.hybrid_period - 1) * (cfg.ssm.conv_dim * di * 2 + di * s * 4)
        return cfg.num_layers // cfg.hybrid_period * slots * per
    dh = cfg.rwkv.head_dim
    return cfg.num_layers * slots * (2 * d * 2 + d // dh * dh * dh * 4)


def _recurrent_refusals(model, cfg):
    """The paged and speculative engines refuse recurrent state as the
    reference's do (rwkv's speculative engine first for want of SFA codes)."""
    from repro_torch.serve import (
        PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine, SpeculativeEngineConfig,
    )
    said = []
    for make in (lambda: PagedDecodeEngine(model, cfg, PagedEngineConfig(max_slots=8),
                                           device="cuda"),
                 lambda: SpeculativeDecodeEngine(model, cfg, SpeculativeEngineConfig(
                     max_slots=8), device="cuda")):
        try:
            make()
        except (NotImplementedError, ValueError) as e:
            said.append(f"{type(e).__name__}: {e}")
        else:
            check(False, f"{cfg.name}: an engine took recurrent state")
    check("recurrent state" in said[0], f"{cfg.name}: paged refusal {said[0]!r}")
    print(f"[recurrent] {cfg.name}: the paged engine refused ({said[0]!r}); the speculative "
          f"engine refused ({said[1]!r})")


def phase_recurrent(results):
    """Phase 12, the recurrent families. jamba-v0.1-52b at full width, one
    super-block of 8 sublayers (13.3 B parameters, 53.2 GB f32): the JB
    kernel shapes, the slot engine on the cuda and on the cuda_fm decode
    backend (their streams equal or parted at a near-tie), the paged and
    speculative refusals, the f32 end to end cuda against torch on f32
    caches at 1e-4. rwkv6-3b at full width and ``RWKV_LAYERS`` of 32
    layers: the slot engine (no kernel, no KV), the refusals; the f32 end
    to end at 2 layers and the f32 gradients at 1, the card against the CPU
    at 1e-4; trained at full width and ``RWKV_LAYERS`` layers. Returns the
    launches of the two jamba serving runs by (kernel, JB shape): rtopk's
    split into its prefill and decode launches as counted after the
    prefills and at the end."""
    from repro_torch.configs import get_config
    from repro_torch.models import init
    release()
    timed(phase_jamba_shapes, results)
    jcfg = get_config("jamba-v0.1-52b")
    j8 = dataclasses.replace(jcfg, num_layers=jcfg.hybrid_period)
    depth = f"one super-block, {j8.num_layers} of {jcfg.num_layers} layers (depth cut)"
    model = init(j8, device="cuda", seed=SEED)
    c_cuda, cuda = timed(phase_engine, model, j8, depth, decode_backend="cuda")
    c_fm, fm = timed(phase_engine, model, j8, depth, decode_backend="cuda_fm")
    parted = _near_tie_divergences(model, j8, cuda["prompts"], fm["outputs"], cuda["outputs"],
                                   SPEC_TIE)
    print(f"[recurrent] {j8.name}: cuda_fm streams against the cuda streams: "
          f"{8 - len(parted)} of 8 equal, the others part at a near-tie (gap <= {SPEC_TIE}): "
          f"{parted}")
    _recurrent_refusals(model, j8)
    timed(phase_end_to_end, model, j8, depth, torch.float32, tol=1e-4)
    del model
    release()
    rcfg = get_config("rwkv6-3b")
    rl = dataclasses.replace(rcfg, num_layers=RWKV_LAYERS)
    model = init(rl, device="cuda", seed=SEED)
    timed(phase_engine, model, rl, f"{RWKV_LAYERS} of {rcfg.num_layers} layers (depth cut)")
    _recurrent_refusals(model, rl)
    del model
    release()
    r2 = dataclasses.replace(rcfg, num_layers=2)
    model = init(r2, device="cuda", seed=SEED)
    timed(phase_variant_end_to_end, model, r2, f"2 of {rcfg.num_layers} layers (depth cut)",
          512)
    del model
    release()
    timed(phase_variant_grads, "rwkv6-3b", 1)
    release()
    timed(phase_train, "rwkv6-3b", 1, {}, layers=RWKV_LAYERS)
    release()
    prefill = cuda["prefill_counts"]["rtopk"] + fm["prefill_counts"]["rtopk"]
    return {("rtopk", "JB"): prefill,
            ("rtopk", "JB decode"): c_cuda["rtopk"] + c_fm["rtopk"] - prefill,
            ("flash_sfa", "JB"): c_cuda["flash_sfa"] + c_fm["flash_sfa"],
            ("flash_sfa_decode", "JB"): c_cuda["flash_sfa_decode"],
            ("flash_sfa_decode_fm", "JB"): c_fm["flash_sfa_decode_fm"]}


def phase_launcher():
    """The slice's launcher command at full width for 2 steps."""
    release()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2-small-sfa8",
           "--no-reduced", "--batch", "8", "--seq-len", str(TRAIN_N), "--steps", "2",
           "--bwd-emit", "compact", "--remat", "codes"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    out = res.stdout.strip().splitlines()
    check(res.returncode == 0, f"launcher exit {res.returncode}: {res.stderr[-2000:]}")
    check(any("compact seam" in line and "taken" in line for line in out),
          f"launcher: compact seam not reported taken: {out}")
    check(not any(("fallback" in line or "applied as" in line) for line in out),
          f"launcher: fallback or remat degrade reported: {out}")
    print(f"[launcher] {' '.join(cmd[1:])}: exit 0 in {time.perf_counter() - t0:.1f} s; "
          + " | ".join(out[-3:]))



# --------------------------------------------------------------------------
# phase 8c: checkpointing and fault tolerance at full width
# --------------------------------------------------------------------------

CKPT_STEPS, CKPT_FAULT = 6, 3
# its depth (the script's time budget)
CKPT_LAYERS = 6


def phase_checkpoint():
    """Full-width gpt2-small-sfa8 (``CKPT_LAYERS`` of its 12 layers) through
    ``Trainer.train`` on the card in the training phases' setting (batch 8
    x 1024, bf16 compute, f32 parameters, dense emit, remat full, the cuda
    backend: rows 1, 3 and 5). Run A
    checkpoints every 2 steps (keep 2, max_restarts 1) over 6 steps with a
    fault injected before step 3, so the Supervisor restores step 2 and
    replays steps 2-5; run B, a fresh Trainer from the same seed, runs the 6
    steps without a fault and checkpoints only at the end. Checks: one
    restart; A's replayed step 2 equal to its first; A's metrics by step and
    final parameters, m and v equal to B's (bit for bit; else each within
    ``_close``'s bf16 tolerance, the leaves that differ printed); the
    launches of rows 1, 3 and 5 over the 13 steps run as predicted, no
    CUDA-core body; ``elastic_remesh`` restores A's step-6 checkpoint onto
    CPU tensors equal bit for bit to the card's state copied to the host;
    ``collect_reports()`` holds no fallback and nothing ineligible. Prints
    the checkpoint's bytes on disk against the state's array bytes, the ms
    the loop blocks in each save (its wait for the previous write, then the
    host copy), the writer's and restore's seconds, the step ms of steps
    that overlapped a write against those that did not, and the straggler
    events. The checkpoint directories are temporary."""
    import tempfile
    from unittest import mock

    from torch.utils._pytree import tree_map

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainPolicy
    from repro_torch.core.reports import clear_reports, collect_reports
    from repro_torch.data import DataConfig
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.train_step import make_train_step
    release()
    cfg = dataclasses.replace(get_config("gpt2-small-sfa8"), num_layers=CKPT_LAYERS)
    layers = cfg.num_layers
    policy = TrainPolicy.from_model(cfg, backend="cuda", remat="full", bwd_emit="dense")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=CKPT_STEPS + 1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_N, global_batch=8, seed=SEED)
    stats = {"save": [], "write": [], "restore": [], "steps": []}
    sups = []
    write, restore = ckpt.save, ckpt.restore

    class TimedCheckpointer(ckpt.AsyncCheckpointer):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            self.wait()
            t1 = time.perf_counter()
            super().save(step, tree, extra)
            stats["save"].append((step, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))

    class RecordedSupervisor(ft.Supervisor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ckptr = TimedCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
            sups.append(self)

    def timed_write(*args, **kwargs):
        t0 = time.perf_counter()
        out = write(*args, **kwargs)
        stats["write"].append((t0, time.perf_counter()))
        return out

    def timed_restore(*args, **kwargs):
        t0 = time.perf_counter()
        out = restore(*args, **kwargs)
        torch.cuda.synchronize()
        stats["restore"].append(time.perf_counter() - t0)
        return out

    def trainer(ckpt_dir, every):
        tr = Trainer(cfg, ocfg, dcfg, TrainerConfig(
            total_steps=CKPT_STEPS, log_every=CKPT_STEPS, seed=SEED, policy=policy,
            ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=every, keep=2, max_restarts=1)),
            device="cuda")
        run_step = tr.run_step

        def timed_step(step):
            t0 = time.perf_counter()
            out = run_step(step)          # ends reading the metrics: synchronized
            stats["steps"].append((step, t0, time.perf_counter()))
            return out

        tr.run_step = timed_step
        return tr

    fired = []

    def injector(step):
        if step == CKPT_FAULT and not fired:
            fired.append(step)
            raise RuntimeError(f"injected fault before step {step}")

    def split(key):
        out, stats[key] = stats[key], []
        return out

    def differing_leaves(xs, ys):
        return [i for i, (x, y) in enumerate(zip(xs, ys)) if not (
            torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y))]

    clear_reports()
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root, \
            mock.patch.object(trainer_mod, "Supervisor", RecordedSupervisor), \
            mock.patch.object(ckpt, "save", timed_write), \
            mock.patch.object(ckpt, "restore", timed_restore):
        dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
        t0 = time.perf_counter()
        tr_a = trainer(dir_a, 2)
        logs_a = tr_a.train(injector)
        run_a_s = time.perf_counter() - t0
        steps_a, writes_a, saves_a = split("steps"), split("write"), split("save")
        step_dir = os.path.join(dir_a, f"step_{CKPT_STEPS:09d}")
        disk = {name: os.path.getsize(os.path.join(step_dir, name))
                for name in os.listdir(step_dir)}
        state_a = ckpt.tree_leaves(tr_a._save_state())
        array_bytes = sum(x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes
                          for x in state_a)
        # the card's state copied to the host, against elastic_remesh onto CPU tensors
        host = [x.cpu() if torch.is_tensor(x) else x for x in state_a]
        like = tree_map(lambda x: torch.zeros_like(x, device="cpu") if torch.is_tensor(x)
                        else np.zeros_like(x), tr_a._save_state())
        step_fn, state_cpu, remesh_step = ft.elastic_remesh(
            lambda device: make_train_step(cfg, ocfg, policy=policy), torch.device("cpu"),
            dir_a, like)
        remesh = ckpt.tree_leaves(state_cpu)
        check(callable(step_fn) and remesh_step == CKPT_STEPS,
              f"checkpoint: elastic_remesh gave step {remesh_step}")
        check(all(x.device.type == "cpu" and x.dtype == y.dtype for x, y in zip(remesh, host)
                  if torch.is_tensor(x)) and not differing_leaves(remesh, host),
              "checkpoint: elastic_remesh's CPU state is not the card's state bit for bit")
        del like, state_cpu, remesh, host
        t0 = time.perf_counter()
        tr_b = trainer(dir_b, 100)
        logs_b = tr_b.train()
        run_b_s = time.perf_counter() - t0
        steps_b, writes_b, saves_b = split("steps"), split("write"), split("save")
    counts, bodies, reports = launch_counts(), body_counts(), collect_reports()
    restarts = [e for e in logs_a if "event" in e]
    runs_a = [e for e in logs_a if "event" not in e]
    check(len(restarts) == 1 and restarts[0]["step"] == CKPT_FAULT - 1
          and sups[0].restarts == 1,
          f"checkpoint: restarts {restarts}, predicted one at step {CKPT_FAULT - 1}")
    ran = [e["step"] for e in runs_a]
    check(ran == [0, 1, 2, 2, 3, 4, 5], f"checkpoint: run A's steps {ran}")
    n_steps = len(runs_a) + len(logs_b)
    want = {name: 0 for name in counts}
    want.update(rtopk=4 * layers * n_steps, flash_sfa=2 * layers * n_steps,
                flash_sfa_bwd=layers * n_steps)
    check(n_steps == 13 and counts == want,
          f"checkpoint: launches {counts} over {n_steps} steps, predicted {want}")
    check(not any(bodies.values()), f"checkpoint: a CUDA-core body launched: {bodies}")
    check(not any(r.component == "backend" or not r.eligible for r in reports),
          f"checkpoint: routing {reports}")
    check(all(np.isfinite(e["loss"]) for e in runs_a + logs_b),
          f"checkpoint: non-finite loss {runs_a} {logs_b}")
    # A against B: bit for bit, else within the bf16 tolerance, naming the leaves
    last_a = {e["step"]: e for e in runs_a}
    state_b = ckpt.tree_leaves(tr_b._save_state())
    differ = differing_leaves(state_a, state_b)
    metrics_equal = [last_a[s] for s in range(CKPT_STEPS)] == logs_b
    replay_equal = runs_a[2] == runs_a[3]
    if differ or not metrics_equal or not replay_equal:
        for i in differ:
            _close(state_a[i], state_b[i], torch.bfloat16, f"checkpoint: leaf {i}")
        for a, b in zip([last_a[s] for s in range(CKPT_STEPS)] + [runs_a[2]],
                        logs_b + [runs_a[3]]):
            check(abs(a["loss"] - b["loss"]) <= 2 ** -7 * abs(b["loss"]) + 1e-4,
                  f"checkpoint: losses {a} against {b}")
        print(f"[checkpoint] A against B NOT bit for bit: metrics equal {metrics_equal}, "
              f"replayed step equal {replay_equal}; leaves that differ (within the bf16 "
              f"tolerance): {[(i, tuple(state_a[i].shape)) for i in differ]}")
    else:
        print(f"[checkpoint] A (faulted, replayed) and B equal bit for bit: the metrics of "
              f"all {CKPT_STEPS} steps, the replayed step {CKPT_FAULT - 1} against its first "
              f"run, and all {len(state_a)} state leaves (parameters, m, v, step)")

    def step_ms(steps, writes):
        """(ms of steps overlapping a write, ms of the others), the first
        step of a run (its warm-up) left out."""
        over, clear = [], []
        for i, (_, t0, t1) in enumerate(steps):
            if i == 0:
                continue
            hit = any(t0 < w1 and t1 > w0 for w0, w1 in writes)
            (over if hit else clear).append(round((t1 - t0) * 1e3, 2))
        return over, clear

    over, clear = step_ms(steps_a, writes_a)
    _, clear_b = step_ms(steps_b, writes_b)
    print(f"[checkpoint] gpt2-small-sfa8 full width, {layers} of 12 layers (depth cut), batch 8 x "
          f"{TRAIN_N}, bf16, remat full, "
          f"dense emit, cuda: run A {run_a_s:.1f} s ({len(runs_a)} steps, a fault before step "
          f"{CKPT_FAULT}, restored step {restarts[0]['step']}), run B {run_b_s:.1f} s; losses "
          f"{[round(e['loss'], 4) for e in logs_b]}; launches {counts} (predicted)")
    print(f"[checkpoint] step {CKPT_STEPS}: {sum(disk.values())} B on disk ({disk}) for "
          f"{array_bytes} B of array data in {len(state_a)} leaves")
    print(f"[checkpoint] saves (step, ms waiting for the previous write, ms blocking on the "
          f"host copy): A {[(st, round(w, 1), round(b, 1)) for st, w, b in saves_a]}, "
          f"B {[(st, round(w, 1), round(b, 1)) for st, w, b in saves_b]}")
    print(f"[checkpoint] writer s per checkpoint: A "
          f"{[round(w1 - w0, 2) for w0, w1 in writes_a]}, B "
          f"{[round(w1 - w0, 2) for w0, w1 in writes_b]}; restore s (the Supervisor's, "
          f"then elastic_remesh onto CPU tensors): {[round(x, 2) for x in stats['restore']]}")
    print(f"[checkpoint] step ms overlapping a write: {over} (mean "
          f"{np.mean(over) if over else float('nan'):.2f}); the others in A: {clear} (mean "
          f"{np.mean(clear) if clear else float('nan'):.2f}), in B: {clear_b} (mean "
          f"{np.mean(clear_b):.2f}); straggler events A {sups[0].monitor.events}, "
          f"B {sups[1].monitor.events}")
    print(f"[checkpoint] routing (collect_reports): {list(reports) or 'nothing recorded'} "
          f"(no fallback; remat full is not recorded, a codes request is)")
    del tr_a, tr_b, state_a, state_b
    release()

# --------------------------------------------------------------------------
# phase 14: distribution on 4 ranks of the one card
# --------------------------------------------------------------------------

DIST_WORLD = 4
# the seq-4 mesh's step: full-width gpt2-small-sfa8, global batch 2 x 4096,
# so each rank's shard is 1024 tokens and the folded batch bh = 2 x 12
RING_B, RING_N, RING_STEPS = 2, 4096, 2
# the TP (model 2 x data 2) and DP (data 4) meshes' global batch, and their
# steps: TP's cut to 1 (the script's time cap), DP's 2 carry a residual
MESH_B, MESH_N, TP_STEPS, DP_STEPS = 8, 1024, 1, 2
COMPRESSION = 0.05
# bytes one rank sends per layer on the ring of 4 at the port's widths
# (bf16 code values and V, int32 indices, f32 accumulators): the byte model
# of distributed/ring.py (Motivation's figures, PERF.md section 6)
RING_HOP_BYTES = 4_325_376
RING_FWD_BYTES = 12_976_128
RING_BWD_BYTES = 41_287_680


def _ring_hop_rows(results, rs):
    """Rows 3 and 5 at the ring's hop shape: one rank's shard of
    gpt2-small-sfa8 on the ring of 4 (bh 24, 1,024 queries against 1,024
    keys, d = dv 64, k 8, bf16), non-causal (a fully-past hop), row 5 with
    the compact emit the ring runs; each against its plain version, timed
    beside it and SDPA on the densified Q/K, the bound from these inputs;
    the shape "RING" of each row."""
    from repro_torch.kernels import flash_sfa, flash_sfa_bwd, reset_launches
    from repro_torch.kernels.ref import flash_sfa_bwd_ref, flash_sfa_ref
    es, bh, n, d, k = 2, RING_B * 12, RING_N // DIST_WORLD, 64, 8
    dv, scale = d, d ** -0.5
    reset_launches()
    qv, qi, kv, ki = _codes_of(rs, bh, n, d, k, torch.bfloat16)
    v, g = (torch.from_numpy(rs.randn(bh, n, dv).astype(np.float32)).cuda().bfloat16()
            for _ in range(2))
    kw = dict(d=d, scale=scale, causal=False)
    ko, kl = flash_sfa(qv, qi, kv, ki, v, return_residuals=True, **kw)
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, return_residuals=True, **kw)
    torch.cuda.synchronize()
    err = _close(ko, po, torch.bfloat16, "flash_sfa ring hop")[0]
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
    args = (qv, qi, kv, ki, v, ko, kl, g)
    got = flash_sfa_bwd(*args, emit="compact", **kw)
    want = flash_sfa_bwd_ref(*args, emit="compact", **kw)
    torch.cuda.synchronize()
    berr = max(_close(a, w, torch.bfloat16, f"flash_sfa_bwd compact ring hop {nm}")[0]
               for nm, a, w in zip(("dq", "dk", "dv"), got, want))
    _tc_only("ring hop rows")
    del got, want, po, pl
    qd, kd = _densify(qv, qi, d), _densify(kv, ki, d)
    pairs = bh * n * n                   # no mask: every (query, key) pair
    _timed_shape(results, "flash_sfa", "ring hop", "RING",
                 f"bh={bh} n={n}x{n} d=dv={d} k={k} bf16 non-causal (tensor-core body): max|err| "
                 f"{err:.3g}; library = SDPA on densified Q/K", err,
                 2 * bh * n * k * (es + 4) + 2 * bh * n * dv * es + bh * n * 4,
                 code_product_s(2 * k * pairs, 2 * d * pairs) + 2 * dv * pairs / BF16_TC_FLOPS,
                 lambda: flash_sfa(qv, qi, kv, ki, v, return_residuals=True, **kw),
                 lambda: flash_sfa_ref(qv, qi, kv, ki, v, return_residuals=True, **kw),
                 lambda: F.scaled_dot_product_attention(
                     qd.reshape(RING_B, 12, n, d), kd.reshape(RING_B, 12, n, d),
                     v.reshape(RING_B, 12, n, dv), scale=scale))
    _timed_shape(results, "flash_sfa_bwd_compact", "ring hop", "RING",
                 f"compact emit, bh={bh} n={n}x{n} d=dv={d} k={k} bf16 non-causal (tensor-core "
                 f"body): max|err| {berr:.3g}; library = SDPA backward (autograd) on densified "
                 f"Q/K", berr,
                 2 * bh * n * k * (es + 4) + 3 * bh * n * dv * es + bh * n * 4
                 + 2 * bh * n * k * es + bh * n * dv * es,
                 code_product_s(6 * k * pairs, 6 * d * pairs) + 4 * dv * pairs / BF16_TC_FLOPS,
                 lambda: flash_sfa_bwd(*args, emit="compact", **kw),
                 lambda: flash_sfa_bwd_ref(*args, emit="compact", **kw),
                 _sdpa_bwd(qd, kd, v, g, scale, causal=False))
    del qd, kd, args, v, g, ko, kl
    torch.cuda.empty_cache()


def _dist_cfgs():
    """(the seq-4 mesh's bf16 model and policy, its f32 2-layer model, the
    TP mesh's compact-seam policy, the DP mesh's f32 2-layer model)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainPolicy
    cfg = get_config("gpt2-small-sfa8")
    ring = TrainPolicy.from_model(cfg, backend="cuda", remat="full", bwd_emit="dense",
                                  ring=True).apply(cfg)
    ring32 = dataclasses.replace(ring, num_layers=2, dtype="float32")
    seam = TrainPolicy.from_model(cfg, backend="cuda", remat="codes", bwd_emit="compact",
                                  fwd_fuse=True).apply(cfg)
    dp32 = dataclasses.replace(TrainPolicy.from_model(
        cfg, backend="cuda", remat="full", bwd_emit="dense").apply(cfg),
        num_layers=2, dtype="float32")
    return ring, ring32, seam, dp32


def _dist_batches(cfg, b, n, steps):
    from repro_torch.data import DataConfig, markov_batch
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=n, global_batch=b, seed=SEED)
    return [markov_batch(dcfg, s) for s in range(steps)]


def _host(tree):
    return {k: v.detach().float().cpu() for k, v in tree.items() if v is not None}


def _state_specs(cfg, mesh):
    """The training state's specs on ``mesh``, as the launcher places it:
    ``launch.specs.param_specs(..., mode="tp")`` of the parameters."""
    from repro_torch.launch import specs as S
    from repro_torch.models.model import param_tree
    return S.param_specs(param_tree(cfg, device="meta"), cfg, mesh, mode="tp")


def _whole(model, tree=None):
    """Each tensor of ``tree`` (default: the parameters; else a flat dict of
    gradients, moments or residuals by parameter name) gathered whole by its
    parameter's spec (every rank of the mesh must call this)."""
    from repro_torch.distributed.shard import gather_full, spec_of
    named = dict(model.named_parameters())
    tree = named if tree is None else tree
    return {k: gather_full(t.detach(), spec_of(named[k])) for k, t in tree.items()
            if t is not None}


def _dist_grads(cfg, batch, specs=None):
    """Loss and every gradient of a fresh ``init(cfg, seed)`` model (its
    state sharded by ``specs``, if given) on the global ``batch`` through
    the train step's ``loss_and_grads`` (under the active mesh, if any),
    gradients gathered whole, on the host in f32."""
    from repro_torch.models import init
    from repro_torch.train.train_step import loss_and_grads
    model = init(cfg, device="cuda", seed=SEED, specs=specs).requires_grad_(True)
    loss, _, grads = loss_and_grads(model, batch, cfg)
    out = float(loss.detach()), _host(_whole(model, grads))
    del model, grads
    return out


def _dist_steps(cfg, batches, compression=None, mesh=None, specs=None):
    """``len(batches)`` steps of ``make_train_step`` (AdamW, lr 3e-4) from
    ``init(cfg, seed)``, the state sharded by ``specs`` if given; -> (losses,
    step ms, the model, its optimizer state, its residuals, the state's
    bytes: the parameters' and both moments' as ``memory_allocated`` rose
    over their init, as their tensors hold, and how many tensors)."""
    from repro_torch.distributed.compression import init_error_state
    from repro_torch.models import init
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = init(cfg, device="cuda", seed=SEED, specs=specs).requires_grad_(True)
    opt = init_opt_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    sizes = [t.numel() * t.element_size()
             for t in [*model.parameters(), *opt.m.values(), *opt.v.values()]]
    state = dict(allocated=torch.cuda.memory_allocated() - before, tensors=sum(sizes),
                 count=len(sizes))
    err = init_error_state(model) if compression else None
    step = make_train_step(cfg, OptimizerConfig(lr=3e-4, warmup_steps=1,
                                                total_steps=len(batches) + 1),
                           grad_compression=compression)
    losses, ms = [], []
    for batch in batches:
        if mesh is not None:
            mesh.barrier()            # the ranks start each timed step together
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(model, opt, batch) if err is None else step(model, opt, batch, err)
        model, opt, m = out[:3]
        if err is not None:
            err = out[3]
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, model, opt, err, state


def _dist_compressed(cfg, batch, specs=None):
    """The compressed gradient and residual of the first step of ``cfg``
    from ``init(cfg, seed)`` (the step's ``loss_and_grads`` under the
    active mesh, then ``compress_tree`` from zero residuals; the state
    sharded by ``specs`` if given), gathered whole, on the host."""
    from repro_torch.distributed.compression import compress_tree, init_error_state
    from repro_torch.distributed.shard import spec_of
    from repro_torch.models import init
    from repro_torch.train.train_step import loss_and_grads
    model = init(cfg, device="cuda", seed=SEED, specs=specs).requires_grad_(True)
    _, _, grads = loss_and_grads(model, batch, cfg)
    comp, err = compress_tree(grads, init_error_state(model), fraction=COMPRESSION,
                              specs={k: spec_of(p) for k, p in model.named_parameters()})
    out = _host(_whole(model, comp)), _host(_whole(model, err))
    del model, grads, comp, err
    return out


def _compressed_gap(got, want):
    """(entries whose selection differs, the largest relative L2 of a leaf's
    kept values on the entries both runs kept, or of its residual on those
    both dropped) of two (compressed gradient, residual) pairs."""
    flips, worst = 0, (0.0, "")
    for name, b in want[0].items():
        a = got[0][name]
        ka, kb = a != 0, b != 0
        flips += int((ka != kb).sum())
        both, neither = ka & kb, ~(ka | kb)
        worst = max(worst, (_rel(a[both], b[both]), name),
                    (_rel(got[1][name][neither], want[1][name][neither]), name))
    return flips, worst


def _noise(cfg, batch):
    """The torch backend's loss and per-leaf gradients in bf16 against
    float32 on the same weights and batch (remat "full"): the tolerance
    scale of ``phase_sfa_grad_bf16_end_to_end``, at this batch."""
    from repro_torch.configs.base import TrainPolicy
    base = TrainPolicy.from_model(cfg, backend="torch", remat="full", bwd_emit="dense",
                                  ring=False).apply(cfg)
    l16, g16 = _dist_grads(base, batch)
    l32, g32 = _dist_grads(dataclasses.replace(base, dtype="float32"), batch)
    return abs(l16 - l32), {k: _rel(g16[k], g32[k]) for k in g32}


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _checkpoint_pair(cfg, model, opt, step):
    """The sharded state's checkpoint against the same state's replicated
    one: every rank gathers the state into a ``Trainer``'s layout and rank
    0 writes it (the Supervisor's path); rank 0 then restores that file
    into a replicated ``Trainer`` and writes it again. -> on rank 0 whether
    the two directories hold the same manifest and arrays, byte for byte
    (the npz's zip headers carry the write time, so its members are
    compared), the leaves and the bytes; None elsewhere."""
    import tempfile
    import zipfile

    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    def trainer(params=None):
        return Trainer(cfg, OptimizerConfig(), DataConfig(cfg.vocab_size, MESH_N, MESH_B),
                       TrainerConfig(seed=SEED), device=model.device, params=params)

    def members(path):
        with zipfile.ZipFile(path) as z:
            return {name: z.read(name) for name in z.namelist()}

    tr = trainer(model)
    tr.opt_state = opt
    state = tr._save_state()               # every rank: the sharded leaves gathered
    del tr
    if torch.distributed.get_rank() != 0:
        torch.distributed.barrier()
        return None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        a, b = os.path.join(tmp, "sharded"), os.path.join(tmp, "replicated")
        ckpt.save(a, step, state)
        del state
        rep = trainer()                    # replicated: the whole tree on this rank
        rep._load_state(ckpt.restore(a, step, rep._save_state()))
        ckpt.save(b, step, rep._save_state())
        del rep
        da, db = (os.path.join(d, f"step_{step:09d}") for d in (a, b))
        same = (open(os.path.join(da, "manifest.json"), "rb").read()
                == open(os.path.join(db, "manifest.json"), "rb").read()
                and members(os.path.join(da, "arrays.npz"))
                == members(os.path.join(db, "arrays.npz")))
        nbytes = os.path.getsize(os.path.join(da, "arrays.npz"))
        leaves = len(members(os.path.join(da, "arrays.npz")))
    release()
    torch.distributed.barrier()
    return {"same": same, "bytes": nbytes, "leaves": leaves}


def _dist_rank():
    """One of the 4 ranks on the card: the three meshes in turn (the
    module's phase 14 docstring), the state sharded by the launcher's specs
    on each. Returns this rank's counts, times, state bytes and peaks,
    checksums of what every rank must hold alike (the gathered
    parameters), and on rank 0 the gradients and states the parent holds to
    its single-process runs."""
    import torch.distributed as dist

    from repro_torch.distributed import ring as R
    from repro_torch.distributed.shard import named_leaves, split_axes
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.kernels import body_counts, launch_counts, reset_launches
    from repro_torch.kernels import flash_sfa, flash_sfa_bwd, rtopk
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import clear_ring_reports, ring_reports
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    ring_cfg, ring32, seam_cfg, dp32 = _dist_cfgs()
    out = {"rank": rank, "device": torch.cuda.get_device_name(), "backend": dist.get_backend()}

    def sums(tree):
        return {k: (v.double().sum().item(), v.double().abs().sum().item())
                for k, v in tree.items()}

    def counted(fn):
        reset_launches()
        R.STATS.reset()
        mesh.reset_counts()
        res = fn()
        return res, launch_counts(), body_counts(), dataclasses.asdict(R.STATS), dict(mesh.sent)

    def split(specs):
        return sum(bool(split_axes(s, mesh)) for _, s in named_leaves(specs))

    # (a) the ring of 4: data 1, so the specs split nothing
    mesh = make_debug_mesh(seq=DIST_WORLD)
    torch.cuda.reset_peak_memory_stats()
    batches = _dist_batches(ring_cfg, RING_B, RING_N, RING_STEPS)
    with axis_rules(mesh):
        specs = _state_specs(ring_cfg, mesh)
        out["ring_split"] = split(specs)
        clear_ring_reports()
        (loss, grads), *_ = counted(lambda: _dist_grads(ring_cfg, batches[0], specs))
        out["ring_loss"], out["ring_sums"] = loss, sums(grads)
        if rank == 0:
            out["ring_grads"] = grads
        del grads
        (losses, ms, model, _, _, state), counts, bodies, stats, sent = counted(
            lambda: _dist_steps(ring_cfg, batches, mesh=mesh, specs=specs))
        out["ring_steps"] = dict(losses=losses, ms=ms, counts=counts, bodies=bodies,
                                 stats=stats, sent=sent, transports=dict(mesh.transports),
                                 device=str(next(model.parameters()).device), state=state,
                                 params=sums(_whole(model)))
        out["ring_reports"] = [dataclasses.asdict(r) for r in ring_reports()]
        del model
        release()
        out["ring_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # the same mesh on a 2-layer f32 model (CUDA-core bodies)
        loss32, g32 = _dist_grads(ring32, batches[0])
        out["ring32_loss"] = loss32
        if rank == 0:
            out["ring32_grads"] = g32
        del g32
        # the code-level op at bh 24 x 4096, d 64, k 8, f32: random codes,
        # then banded ones whose fully-past hops close in form; bf16 once
        gen = torch.Generator().manual_seed(SEED + 40)
        bh, n, d, k = RING_B * 12, RING_N, 64, 8
        out["code"] = {}
        for case in ("random", "banded", "random bf16"):
            dt = torch.bfloat16 if case.endswith("bf16") else torch.float32
            q, kk, v, g = (torch.randn(bh, n, d, generator=gen).cuda().to(dt) for _ in range(4))
            qv, qi = rtopk(q, k)
            kv, ki = rtopk(kk, k)
            if case == "banded":
                # Q on features [0, 8), K shard s on [8s, 8s + 8): rank r's
                # hops from shards 1 .. r - 1 close in form
                band = torch.arange(n) // (n // DIST_WORLD) * 8
                qi = torch.sort(torch.randint(0, 8, (bh, n, k), generator=gen), -1)[0]
                ki = torch.sort(torch.randint(0, 8, (bh, n, k), generator=gen), -1)[0] \
                    + band[None, :, None]
                qi, ki = qi.int().cuda(), ki.int().cuda()
            want_o, lse = flash_sfa(qv, qi, kv, ki, v, d=d, return_residuals=True)
            want = (want_o, *flash_sfa_bwd(qv, qi, kv, ki, v, want_o, lse, g, d=d,
                                           emit="compact"))
            leaves = [t.detach().requires_grad_() for t in (qv, kv, v)]

            def ring_and_grads():
                o = R.ring_sfa(leaves[0], qi, leaves[1], ki, leaves[2], d=d)
                return (o.detach(), *torch.autograd.grad(o, leaves, g))

            got, _, _, stats, sent = counted(ring_and_grads)
            out["code"][case] = dict(
                err=[(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)],
                close=[bool(torch.allclose(x.float(), y.float(), rtol=1e-4, atol=1e-4))
                       for x, y in zip(got, want)],
                stats=stats, sent=sent, vmax=v.float().abs().max().item())
            del got, want, leaves
    release()
    # (b) tensor parallelism: model 2 x data 2, the compact seam, the state
    # sharded (FSDP over data, TP over model)
    mesh = make_debug_mesh(model=2, data=2)
    torch.cuda.reset_peak_memory_stats()
    batches = _dist_batches(seam_cfg, MESH_B, MESH_N, TP_STEPS)
    with axis_rules(mesh):
        specs = _state_specs(seam_cfg, mesh)
        out["tp_split"] = split(specs)
        (loss, grads), *_ = counted(lambda: _dist_grads(seam_cfg, batches[0], specs))
        out["tp_loss"], out["tp_sums"] = loss, sums(grads)
        if rank == 0:
            out["tp_grads"] = grads
        del grads
        (losses, ms, model, opt, _, state), counts, bodies, stats, sent = counted(
            lambda: _dist_steps(seam_cfg, batches, mesh=mesh, specs=specs))
        out["tp_steps"] = dict(losses=losses, ms=ms, counts=counts, bodies=bodies, sent=sent,
                               transports=dict(mesh.transports), state=state,
                               params=sums(_whole(model)))
        out["tp_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        out["tp_ckpt"] = _checkpoint_pair(seam_cfg, model, opt, TP_STEPS)
        out["tp_ckpt_s"] = time.perf_counter() - t0
        del model, opt
    release()
    # (c) data parallelism over 4 with top-5% compression, f32, 2 layers,
    # the state sharded over data: the first step's compressed gradient and
    # residual, then 2 steps
    mesh = make_debug_mesh(data=DIST_WORLD)
    torch.cuda.reset_peak_memory_stats()
    batches = _dist_batches(dp32, MESH_B, MESH_N, DP_STEPS)
    with axis_rules(mesh):
        specs = _state_specs(dp32, mesh)
        out["dp_split"] = split(specs)
        comp, err = _dist_compressed(dp32, batches[0], specs)
        if rank == 0:
            out["dp_comp"], out["dp_err"] = comp, err
        del comp, err
        (losses, ms, model, _, err, state), counts, bodies, stats, sent = counted(
            lambda: _dist_steps(dp32, batches, COMPRESSION, mesh=mesh, specs=specs))
        params = _whole(model)
        out["dp_steps"] = dict(losses=losses, ms=ms, sent=sent, transports=dict(mesh.transports),
                               state=state, params=sums(params), err=sums(_whole(model, err)))
        if rank == 0:
            out["dp_params"] = _host(params)
        del model, err, params
    release()
    out["dp_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _sharded_state_bytes(cfg, shape) -> int:
    """The f32 parameters and both AdamW moments a rank holds on a mesh of
    ``shape`` by the launcher's specs: 12 B a parameter of its shards."""
    import math

    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models.model import param_tree
    mesh = ShapeMesh(shape)
    params = param_tree(cfg, device="meta")
    shards = S.shardings_of(params, S.param_specs(params, cfg, mesh), mesh)
    return 12 * sum(math.prod(s) for _, s in S.named_leaves(shards))


def _predicted_sent(cfg, shape, *, steps, rows, n, compression=False):
    """Bytes a rank passes to each collective over ``steps`` training steps
    on a mesh of ``shape`` (``rows`` of the batch a data rank, ``n``
    tokens), from the launcher's specs and the remat policy:

      * each leaf a spec splits is all-gathered over its split axes, the
        later dim's axis first, at every use: the leaves outside the layer
        stack once a step, a layer's once in its forward and again in the
        backward's rerun under remat "full" or "codes"; with compression its
        gradient and residual are gathered too;
      * its gradient is cut to its model slice and reduce-scattered over
        data; a leaf that data does not split is all-reduced over data, with
        the token count (4 B), the (ce, aux) pair (8 B) and one 4-byte sum of
        squares per axis of each set of split axes for the global norm;
      * under a model axis, the compact seam's regions (``shard.run_tp``,
        heads split): per layer the q and k codes of proj_rtopk (values in
        the model's dtype, int32 indices), FlashSFA's output and LSE and its
        rerun's output, the backward's q / k code gradients and dV, the q
        and k blocks of dW (f32), all-gathered; the seam's dx for q and k
        (f32) all-reduced over model."""
    import math

    from repro_torch.distributed.shard import named_leaves, split_axes
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models.model import param_tree
    mesh = ShapeMesh(shape)
    params = param_tree(cfg, device="meta")
    specs = S.param_specs(params, cfg, mesh)
    reruns = 2 if cfg.remat in ("full", "codes") else 1
    sent = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 12}
    norm_groups = set()
    for (path, leaf), (_, spec) in zip(named_leaves(params), named_leaves(specs)):
        axes = split_axes(spec, mesh)
        shard = size = 4 * math.prod(S.shard_shape(leaf.shape, spec, mesh))
        if axes:
            norm_groups.add(frozenset(a for _, a in axes))
        chain = 0
        for _, axis in reversed(axes):
            chain += size
            size *= mesh.size(axis)
        uses = reruns if path[0] == "segments" else 1
        sent["all_gather"] += (uses + (2 if compression else 0)) * chain
        if any(a == "data" for _, a in axes):
            size //= math.prod(mesh.size(a) for _, a in axes if a != "data")
            sent["reduce_scatter"] += size
        else:
            sent["all_reduce"] += shard
    sent["all_reduce"] += 4 * sum(len(g) for g in norm_groups)
    tp = mesh.size("model")
    if tp > 1:
        a = cfg.attention
        h, hkv, d, k, m = a.num_heads // tp, a.num_kv_heads // tp, a.head_dim, a.sfa_k, \
            cfg.d_model
        es = 2 if cfg.dtype == "bfloat16" else 4
        tok = rows * n
        sent["all_gather"] += cfg.num_layers * (
            tok * (h + hkv) * k * (es + 4)              # proj_rtopk's q and k codes
            + tok * h * (d * es + 4) + tok * h * d * es  # FlashSFA out + LSE, its rerun
            + tok * h * (2 * k * es + d * es)            # dq, dk codes, dV
            + (h + hkv) * m * d * 4)                     # dW's q and k blocks
        sent["all_reduce"] += cfg.num_layers * 2 * tok * m * 4
    return {key: steps * v for key, v in sent.items()}


def _replica_gap(got, want):
    """The largest relative gap between two ranks' per-leaf (sum, |sum|)
    checksums (0: equal bit for bit, as far as the sums show)."""
    return max(abs(a - b) / max(abs(b), 1e-30)
               for k in want for a, b in zip(got[k], want[k]))


def _held(what, got, want, loss_tol, leaf_tol):
    """The loss within ``loss_tol`` and each gradient leaf's relative L2
    within ``leaf_tol[name]``; -> (|loss diff|, worst leaf (share of its
    tolerance, name, error))."""
    (lg, gg), (lw, gw) = got, want
    check(np.isfinite(lg) and abs(lg - lw) <= loss_tol,
          f"{what}: loss {lg} vs {lw} (tol {loss_tol:.3g})")
    check(set(gg) == set(gw), f"{what}: leaves {sorted(set(gg) ^ set(gw))}")
    worst = (0.0, "", 0.0)
    for name in gw:
        check(bool(torch.isfinite(gg[name]).all()), f"{what}: non-finite d{name}")
        e, t = _rel(gg[name], gw[name]), leaf_tol[name]
        check(e <= t, f"{what}: d{name} relative L2 {e:.3g} > {t:.3g}")
        worst = max(worst, (e / t, name, e))
    return abs(lg - lw), worst


def phase_distributed(results):
    """Phase 14 — distribution on 4 ranks of the one card (gloo: NCCL
    refuses two ranks on one device; the kernels run on the card in every
    rank, the ring's hops staged through pinned host memory, since gloo's
    send refuses device memory; ``tools/gloo_cuda_probe.py``). First rows 3 and 5 at the ring's hop shape, then the parent's
    single-process references on the card, then one ``launch.mesh.spawn`` of
    4 ranks running three meshes in turn, each with the training state
    placed as the launcher places it (``launch.specs.param_specs``, mode
    "tp": FSDP over data, TP over model; each rank holds its shards and the
    model gathers a leaf at use, ``distributed/shard.py``):

      (a) ``make_debug_mesh(seq=4)``: full-width gpt2-small-sfa8, global
          batch 2 x 4,096, bf16, dense emit, remat full, cuda (data 1: the
          specs split nothing): the loss and
          every gradient of the first batch held to the single-process step
          by phase 9's bf16 rule (the torch backend's bf16-from-f32
          distance at this batch, twice, + 1e-2), then 2 steps (losses by
          the same loss rule), each rank's ring bytes equal to the byte
          model (Motivation's figures) and its launches of rows 1, 3 and 5
          equal to the prediction (rank r: rtopk 48, FlashSFA 24 (r + 1) and
          the compact backward 12 (r + 1) a step), the ring report taken
          with its transport; a 2-layer f32 model on the same mesh held to
          one process at 1e-4 (loss, and each leaf's relative L2); the
          code-level ``ring_sfa`` at bh 24 x 4,096, d 64, k 8 held to
          flash_sfa + flash_sfa_bwd(compact) on the card in f32 (random
          codes; banded codes whose fully-past hops close in form) at 1e-4,
          and in bf16 within 2^-7 max|v| (each hop's partial rounds once);
      (b) ``make_debug_mesh(model=2, data=2)``: the compact seam (remat
          codes) at batch 8 x 1,024, each rank running rows 2, 4, 5, 8 and 9
          on its 6 heads and 4 rows, six of the 12 leaves sharded: gathered
          gradients by the bf16 rule, 1 step; then the state's checkpoint
          (every rank gathers, rank 0 writes) against the same state
          restored into a replicated Trainer and written again, byte for
          byte (``_checkpoint_pair``);
      (c) ``make_debug_mesh(data=4)``: a 2-layer f32 model with top-5%
          gradient compression at batch 8 x 1,024, the state sharded over
          data: the first step's
          compressed gradient and residual held to one process (phase 9's
          f32 leaf rule; selection flips at a threshold counted, below
          1e-5 of the entries), then 2 steps (the second carries the
          residual) with their losses held at 1e-4.

    Every rank must hold the same gathered parameters (checksums within
    1e-6) and run on the card; on (b) and (c) the parameter and moment
    bytes each rank holds equal the specs' count (``_sharded_state_bytes``: the
    tensors' bytes exactly; ``memory_allocated`` over the init within the
    allocator's rounding, under 1 MiB a tensor) and the bytes it
    passes to each collective equal ``_predicted_sent``. Prints the state
    bytes a rank, the bytes by collective against their prediction, the
    bytes per hop against the model, the hops per rank, each collective's
    transport, ms per step per rank (4 ranks share one card: no measure of
    context-parallel speed) and each mesh's peak memory."""
    from repro_torch.distributed.ring import (
        ring_bwd_wire_bytes, ring_bytes_per_hop, ring_fwd_wire_bytes,
    )
    from repro_torch.launch.mesh import spawn
    rs = np.random.RandomState(SEED + 50)
    _ring_hop_rows(results, rs)
    widths = dict(val_bytes=2, idx_bytes=4, v_bytes=2)
    bh, nl = RING_B * 12, RING_N // DIST_WORLD
    model_bytes = (ring_bytes_per_hop(bh, nl, 8, 64, **widths),
                   ring_fwd_wire_bytes(DIST_WORLD, bh, nl, 8, 64, **widths),
                   ring_bwd_wire_bytes(DIST_WORLD, bh, nl, 8, 64, grad_bytes=4, **widths))
    check(model_bytes == (RING_HOP_BYTES, RING_FWD_BYTES, RING_BWD_BYTES),
          f"distributed: the byte model gives {model_bytes}")
    # the single-process references, on the card, before the ranks start
    ring_cfg, ring32, seam_cfg, dp32 = _dist_cfgs()
    t0 = time.perf_counter()
    ring_batches = _dist_batches(ring_cfg, RING_B, RING_N, RING_STEPS)
    ref_ring = _dist_grads(ring_cfg, ring_batches[0])
    ring_noise = _noise(ring_cfg, ring_batches[0])
    ref_ring_losses = _dist_steps(ring_cfg, ring_batches)[0]
    ref_ring32 = _dist_grads(ring32, ring_batches[0])
    mesh_batches = _dist_batches(seam_cfg, MESH_B, MESH_N, DP_STEPS)
    ref_tp = _dist_grads(seam_cfg, mesh_batches[0])
    tp_noise = _noise(seam_cfg, mesh_batches[0])
    ref_tp_losses = _dist_steps(seam_cfg, mesh_batches[:TP_STEPS])[0]
    ref_comp = _dist_compressed(dp32, mesh_batches[0])
    dp_losses, _, dp_model, _, _, _ = _dist_steps(dp32, mesh_batches, COMPRESSION)
    ref_dp = (dp_losses, _host(dict(dp_model.named_parameters())))
    del dp_model
    release()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn(_dist_rank, DIST_WORLD, device="cuda", seed=SEED, timeout_s=600)
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        check(r["device"] == torch.cuda.get_device_name(0) and r["backend"] == "gloo"
              and r["ring_steps"]["device"].startswith("cuda"),
              f"distributed: rank {r['rank']} ran on {r['device']} / "
              f"{r['ring_steps']['device']} over {r['backend']}")
    r0 = ranks[0]
    # (a) the ring: gradients and losses against one process
    dl, worst = _held("distributed ring-4 gradients", (r0["ring_loss"], r0["ring_grads"]),
                      ref_ring, 2 * ring_noise[0] + 1e-2,
                      {k: 2 * e + 1e-2 for k, e in ring_noise[1].items()})
    for s, (a, b) in enumerate(zip(r0["ring_steps"]["losses"], ref_ring_losses)):
        check(abs(a - b) <= 2 * ring_noise[0] + 1e-2,
              f"distributed ring-4: step {s} loss {a} vs one process {b}")
    layers = ring_cfg.num_layers
    per_step = RING_STEPS * layers
    replicas = {}
    for r in ranks:
        rk, st = r["rank"], r["ring_steps"]
        want = {name: 0 for name in st["counts"]}
        want.update(rtopk=4 * per_step, flash_sfa=2 * per_step * (rk + 1),
                    flash_sfa_bwd_compact=per_step * (rk + 1))
        check(st["counts"] == want, f"distributed ring-4 rank {rk}: launches {st['counts']}, "
                                    f"predicted {want}")
        check(not any(st["bodies"].values()), f"distributed ring-4 rank {rk}: bodies "
                                              f"{st['bodies']}")
        s = st["stats"]
        check(s["fwd_bytes"] == 2 * per_step * RING_FWD_BYTES
              and s["bwd_bytes"] == per_step * RING_BWD_BYTES
              and st["sent"]["ring"] == s["fwd_bytes"] + s["bwd_bytes"]
              and st["sent"]["ring"] == RING_STEPS * 806_879_232,
              f"distributed ring-4 rank {rk}: sent {st['sent']}, stats {s}")
        check((s["fwd_computed"], s["fwd_closed"], s["fwd_skipped"])
              == (2 * per_step * (rk + 1), 0, 2 * per_step * (DIST_WORLD - 1 - rk))
              and (s["bwd_computed"], s["bwd_closed"], s["bwd_skipped"])
              == (per_step * (rk + 1), 0, per_step * (DIST_WORLD - 1 - rk)),
              f"distributed ring-4 rank {rk}: hops {s}")
        check([(x["taken"], x["transport"]) for x in r["ring_reports"]]
              == [(True, "gloo, pinned host")],
              f"distributed ring-4 rank {rk}: ring reports {r['ring_reports']}")
        for what, got, want in (("ring gradients", r["ring_sums"], r0["ring_sums"]),
                                ("TP gradients", r["tp_sums"], r0["tp_sums"]),
                                *((f"{key} parameters", r[key]["params"], r0[key]["params"])
                                  for key in ("ring_steps", "tp_steps", "dp_steps"))):
            apart = _replica_gap(got, want)
            replicas.setdefault(what, []).append(apart)
            check(apart <= 1e-6, f"distributed: rank {rk}'s {what} differ from rank 0's by "
                                 f"{apart:.3g} (relative, a leaf's sum or |sum|)")
    dl32, worst32 = _held("distributed ring-4 f32 2 layers", (r0["ring32_loss"],
                                                               r0["ring32_grads"]),
                          ref_ring32, 1e-4, {k: 1e-4 for k in ref_ring32[1]})
    for r in ranks:
        rk = r["rank"]
        for case, c in r["code"].items():
            if case.endswith("bf16"):
                check(c["err"][0] <= 2 ** -7 * c["vmax"],
                      f"distributed code-level ring_sfa {case} rank {rk}: o off by {c['err'][0]}")
            else:
                check(all(c["close"]), f"distributed code-level ring_sfa {case} rank {rk}: "
                                       f"max|err| o, dqv, dkv, dv {c['err']}")
            closed = max(0, rk - 1) if case == "banded" else 0
            check(c["stats"]["fwd_closed"] == closed == c["stats"]["bwd_closed"]
                  and c["stats"]["fwd_computed"] == rk + 1 - closed,
                  f"distributed code-level ring_sfa {case} rank {rk}: hops {c['stats']}")
    # (b) tensor parallelism
    dtp, worst_tp = _held("distributed TP-2 x DP-2 seam gradients", (r0["tp_loss"],
                                                                    r0["tp_grads"]),
                          ref_tp, 2 * tp_noise[0] + 1e-2,
                          {k: 2 * e + 1e-2 for k, e in tp_noise[1].items()})
    for s, (a, b) in enumerate(zip(r0["tp_steps"]["losses"], ref_tp_losses)):
        check(abs(a - b) <= 2 * tp_noise[0] + 1e-2,
              f"distributed TP-2 x DP-2: step {s} loss {a} vs one process {b}")
    per_tp = TP_STEPS * layers
    # the state a rank holds and the bytes it passes to each collective,
    # against the specs and the remat policy (``_sharded_state_bytes``,
    # ``_predicted_sent``); the ring splits nothing
    tp_shape, dp_shape = {"data": 2, "model": 2}, {"data": DIST_WORLD, "model": 1}
    want_state = {"tp_steps": _sharded_state_bytes(seam_cfg, tp_shape),
                  "dp_steps": _sharded_state_bytes(dp32, dp_shape)}
    want_sent = {"tp_steps": _predicted_sent(seam_cfg, tp_shape, steps=TP_STEPS,
                                             rows=MESH_B // 2, n=MESH_N),
                 "dp_steps": _predicted_sent(dp32, dp_shape, steps=DP_STEPS,
                                             rows=MESH_B // DIST_WORLD, n=MESH_N,
                                             compression=True)}
    check(want_state["tp_steps"] == 637_843_968,
          f"distributed: the specs give {want_state['tp_steps']} B of TP-2 x DP-2 state")
    for r in ranks:
        check(r["ring_split"] == 0 and r["tp_split"] == 6 and r["dp_split"] == 6,
              f"distributed rank {r['rank']}: leaves split ring / TP / DP "
              f"{r['ring_split']} / {r['tp_split']} / {r['dp_split']}")
        for key in ("tp_steps", "dp_steps"):
            st = r[key]["state"]
            # the allocator rounds a block to 512 B and keeps a remainder
            # below 1 MiB in it: memory_allocated exceeds the tensors' bytes
            # by less than 1 MiB a tensor (the whole leaves freed)
            check(st["tensors"] == want_state[key]
                  and 0 <= st["allocated"] - st["tensors"] < st["count"] * 2**20,
                  f"distributed rank {r['rank']} {key}: state {st}, the specs' "
                  f"{want_state[key]} B")
            check(r[key]["sent"] == want_sent[key],
                  f"distributed rank {r['rank']} {key}: bytes {r[key]['sent']}, predicted "
                  f"{want_sent[key]}")
        st = r["tp_steps"]
        want = {name: 0 for name in st["counts"]}
        want.update(proj_rtopk=2 * per_tp, flash_sfa_block_skip=2 * per_tp,
                    flash_sfa_bwd_compact=per_tp, code_grad_dx=2 * per_tp,
                    code_grad_dw=2 * per_tp)
        check(st["counts"] == want and not any(st["bodies"].values()),
              f"distributed TP-2 x DP-2 rank {r['rank']}: launches {st['counts']}, predicted "
              f"{want}; bodies {st['bodies']}")
    ck = r0["tp_ckpt"]
    check(ck["same"] and ck["leaves"] == 37,
          f"distributed TP-2 x DP-2: the sharded checkpoint differs from the replicated one "
          f"({ck})")
    # (c) data parallelism with compression, against one process
    for s, (a, b) in enumerate(zip(r0["dp_steps"]["losses"], ref_dp[0])):
        check(abs(a - b) <= 1e-4, f"distributed DP-4 compressed: step {s} loss {a} vs {b}")
    # the first step's compressed gradient and residual against one
    # process, each leaf's kept values and residual by phase 9's float32
    # leaf rule (1e-3 relative L2: 4 data shards sum in another order than
    # one). An entry within that distance of its leaf's top-5% threshold
    # can land on either side, moving its whole value between the two:
    # about (distance x threshold x density there) of the entries, below
    # 1e-5 of them; such flips are counted apart
    flips, comp_worst = _compressed_gap((r0["dp_comp"], r0["dp_err"]), ref_comp)
    n_comp = sum(t.numel() for t in ref_comp[0].values())
    check(flips <= 1e-5 * n_comp and comp_worst[0] <= 1e-3,
          f"distributed DP-4 compressed: {flips} selection flips of {n_comp}, worst leaf "
          f"{comp_worst}")
    # after AdamW the parameters are reported, not held: the update
    # normalizes each entry, so a near-zero gradient entry whose sign the
    # two summation orders differ on moves that entry by 2 lr
    dp_worst = max((_rel(r0["dp_params"][k], ref_dp[1][k]), k) for k in ref_dp[1])
    # the printed record
    print(f"[distributed] 4 ranks on one {torch.cuda.get_device_name(0)}, gloo; references in "
          f"one process {ref_s:.1f} s, the ranks' run {ranks_s:.1f} s (process start "
          f"included)")
    replicated = _sharded_state_bytes(seam_cfg, {"data": 1, "model": 1})
    print("[distributed] state a rank (f32 parameters + AdamW m, v by the launcher's specs; "
          "tensors / memory_allocated over the init, B): " + "; ".join(
              f"{mesh} " + ", ".join(
                  f"rank {r['rank']} {r[key]['state']['tensors']} / "
                  f"{r[key]['state']['allocated']}"
                  for r in ranks) for mesh, key in
              (("ring-4", "ring_steps"), ("TP-2 x DP-2", "tp_steps"), ("DP-4", "dp_steps")))
          + f"; specs: TP-2 x DP-2 {want_state['tp_steps']}, DP-4 (2 layers) "
          f"{want_state['dp_steps']}, replicated {replicated}")
    print("[distributed] bytes a rank by collective, measured (rank 0) against predicted: "
          + "; ".join(f"{mesh} {r0[key]['sent']} vs {want_sent[key]}" for mesh, key in
                      (("TP-2 x DP-2", "tp_steps"), ("DP-4", "dp_steps"))))
    print(f"[distributed] TP-2 x DP-2 checkpoint at step {TP_STEPS}: sharded (gathered, rank 0 "
          f"writes) and replicated (restored, written again) identical, {ck['leaves']} "
          f"arrays, {ck['bytes']} B of arrays.npz; {r0['tp_ckpt_s']:.1f} s")
    print(f"[distributed] ring-4 byte model at bf16 codes / int32 indices / bf16 V / f32 "
          f"accumulators: {model_bytes[0]} B a hop, forward {model_bytes[1]} B, backward "
          f"{model_bytes[2]} B a layer; K-payload ratio against a dense ring "
          f"{64 * 2 / (8 * 6):.3f}x; a step under remat full sends "
          f"{layers * (2 * model_bytes[1] + model_bytes[2])} B a rank; sent per rank over "
          f"{RING_STEPS} steps: " + ", ".join(
              f"rank {r['rank']} {r['ring_steps']['sent']}" for r in ranks))
    print("[distributed] ring-4 hops over the steps (computed / closed / skipped, forward | "
          "backward): " + "; ".join(
              f"rank {r['rank']} {s['fwd_computed']}/{s['fwd_closed']}/{s['fwd_skipped']} | "
              f"{s['bwd_computed']}/{s['bwd_closed']}/{s['bwd_skipped']}"
              for r in ranks for s in [r["ring_steps"]["stats"]]))
    print("[distributed] replicas (largest relative gap of a leaf's sum or |sum| from rank "
          "0's, ranks 0-3): " + "; ".join(f"{what} {[f'{x:.3g}' for x in gaps]}"
                                          for what, gaps in replicas.items()))
    print("[distributed] transports: " + "; ".join(
        f"{mesh} {ranks[0][key]['transports']}" for mesh, key in
        (("ring-4", "ring_steps"), ("TP-2 x DP-2", "tp_steps"), ("DP-4", "dp_steps"))))
    print("[distributed] ms per step per rank (4 ranks share one card and the host: no "
          "measure of context-parallel speed): " + "; ".join(
              f"{mesh} " + ", ".join(f"rank {r['rank']} {[round(x, 1) for x in r[key]['ms']]}"
                                     for r in ranks)
              for mesh, key in (("ring-4", "ring_steps"), ("TP-2 x DP-2", "tp_steps"),
                                ("DP-4", "dp_steps"))))
    print("[distributed] peak memory a rank (GiB): " + "; ".join(
        f"{mesh} {[round(r[key], 2) for r in ranks]}" for mesh, key in
        (("ring-4", "ring_peak_gib"), ("TP-2 x DP-2", "tp_peak_gib"), ("DP-4", "dp_peak_gib"))))
    print(f"[distributed] ring-4 gpt2-small-sfa8 bf16 batch {RING_B} x {RING_N}: loss "
          f"{r0['ring_loss']:.6f} vs one process {ref_ring[0]:.6f} (|diff| {dl:.3g}, tol "
          f"{2 * ring_noise[0] + 1e-2:.3g}); every gradient within the bf16 rule, nearest to "
          f"it d{worst[1]} at {worst[2]:.3g} ({100 * worst[0]:.1f}% of its tolerance); step "
          f"losses {[round(x, 5) for x in r0['ring_steps']['losses']]} vs "
          f"{[round(x, 5) for x in ref_ring_losses]}; launches per rank "
          + "; ".join(f"rank {r['rank']} {({k: v for k, v in r['ring_steps']['counts'].items() if v})}"
                      for r in ranks))
    print(f"[distributed] ring-4 f32 2 layers: loss |diff| {dl32:.3g}, worst leaf "
          f"d{worst32[1]} relative L2 {worst32[2]:.3g} (tol 1e-4); code-level ring_sfa bh "
          f"{bh} x {RING_N}, d 64, k 8 against flash_sfa + flash_sfa_bwd(compact), max|err| "
          "(o, dqv, dkv, dv): " + "; ".join(
              f"{case} " + ", ".join(f"rank {r['rank']} {[f'{e:.3g}' for e in r['code'][case]['err']]}"
                                     for r in ranks) for case in r0["code"]))
    print(f"[distributed] TP-2 x DP-2 compact seam, batch {MESH_B} x {MESH_N}: loss |diff| "
          f"{dtp:.3g}, nearest leaf d{worst_tp[1]} at {worst_tp[2]:.3g} "
          f"({100 * worst_tp[0]:.1f}% of its tolerance); step losses "
          f"{[round(x, 5) for x in r0['tp_steps']['losses']]} vs "
          f"{[round(x, 5) for x in ref_tp_losses]}; launches a rank "
          f"{({k: v for k, v in r0['tp_steps']['counts'].items() if v})}; bytes a rank "
          f"{r0['tp_steps']['sent']}")
    print(f"[distributed] DP-4 f32 2 layers, top-{100 * COMPRESSION:.0f}% compression: the "
          f"first step's compressed gradient against one process: {flips} selection flips of "
          f"{n_comp} entries, kept values and residuals within {comp_worst[0]:.3g} (worst "
          f"{comp_worst[1]}); losses {r0['dp_steps']['losses']} vs {ref_dp[0]}; parameters "
          f"after {DP_STEPS} steps (AdamW) worst relative L2 {dp_worst[0]:.3g} "
          f"({dp_worst[1]}); bytes a rank {r0['dp_steps']['sent']}")
    return {name: sum(r["ring_steps"]["counts"][name] for r in ranks)
            for name in ("rtopk", "flash_sfa", "flash_sfa_bwd_compact")}


def main():
    t_start = time.perf_counter()
    device_name, count = timed(phase_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed(phase_build)
    from repro_torch.configs import get_config
    from repro_torch.models import init
    timed(phase_wgmma_probe)
    rs = np.random.RandomState(SEED)
    results = {"rtopk": timed(phase_rtopk, rs), "proj_rtopk": timed(phase_proj_rtopk, rs),
               "flash_sfa": timed(phase_flash_sfa, rs),
               "flash_sfa_block_skip": timed(phase_block_skip, rs),
               "flash_sfa_decode": timed(phase_decode, rs)}
    results["flash_sfa_decode_paged"], results["flash_sfa_decode_multi"] = \
        timed(phase_decode_paged, rs)
    results["flash_sfa_decode_fm"], results["flash_sfa_decode_fm_paged"] = \
        timed(phase_decode_fm, rs)
    results["flash_sfa_bwd"], results["flash_sfa_bwd_compact"] = timed(phase_flash_sfa_bwd, rs)
    results["flash_attention"], results["flash_attention_bwd"] = timed(phase_flash_attention, rs)
    results["code_grad_dx"], results["code_grad_dw"] = timed(phase_code_grad, rs)
    timed(phase_qwen3_llama_shapes, results)
    timed(phase_moonshot_shapes, results)
    timed(phase_frontend_shapes, results)
    timed(phase_wide_seam_shapes, results)
    timed(phase_llama8b_deepseek_shapes, results)
    cfg = get_config("gpt2-small-sfa8")
    model = init(cfg, device="cuda", seed=SEED)
    counts, slot_run = timed(phase_engine, model, cfg)
    paged_run = timed(phase_paged, model, cfg, slot_run)
    spec = timed(phase_speculative, model, cfg, paged_run, slot_run["prompts"])
    fm_slot, fm_paged = timed(phase_feature_major, model, cfg, paged_run, slot_run["prompts"])
    timed(phase_end_to_end, model, cfg)
    del model
    timed(phase_serve_launcher)
    # qwen3-0.6b-sfa8 at full width and 7 of its 28 layers (the depth cut
    # of the script's budget): the slot, paged (full residency) and cuda_fm
    # engines on the same 8 requests (GQA, d 128)
    qcfg = get_config("qwen3-0.6b-sfa8")
    q7 = dataclasses.replace(qcfg, num_layers=7)
    model = init(q7, device="cuda", seed=SEED)
    _, q_slot = timed(phase_engine, model, q7, f"7 of {qcfg.num_layers} layers (depth cut)")
    q_paged = timed(phase_paged, model, q7, q_slot, preempt=False)
    timed(phase_feature_major, model, q7, q_paged, q_slot["prompts"])
    del model
    # its f32 end to end at full width, 4 of 28 layers
    q4 = dataclasses.replace(qcfg, num_layers=4)
    model = init(q4, device="cuda", seed=SEED)
    timed(phase_end_to_end, model, q4, f"4 of {qcfg.num_layers} layers (depth cut)")
    del model
    release()
    # moonshot-v1-16b-a3b at full width, 12 of 48 layers (1 dense + 11 MoE;
    # 28.8 GB of f32 weights): the slot, paged (full residency) and cuda_fm
    # engines on the same 8 requests (MHA, d 128, k 16)
    mcfg = get_config("moonshot-v1-16b-a3b")
    m12 = dataclasses.replace(mcfg, num_layers=12)
    model = init(m12, device="cuda", seed=SEED)
    _, m_slot = timed(phase_engine, model, m12, f"12 of {mcfg.num_layers} layers (depth cut)")
    m_paged = timed(phase_paged, model, m12, m_slot, preempt=False)
    timed(phase_speculative, model, m12, m_paged, m_slot["prompts"])
    timed(phase_feature_major, model, m12, m_paged, m_slot["prompts"])
    del model
    release()
    # its f32 end to end at 2 layers (1 dense + 1 MoE), f32 caches: a bf16
    # cache rounds a 1e-6 difference to the neighbouring number, which can
    # move a token to another expert
    m2 = dataclasses.replace(mcfg, num_layers=2)
    model = init(m2, device="cuda", seed=SEED)
    timed(phase_end_to_end, model, m2, f"2 of {mcfg.num_layers} layers (depth cut)",
          torch.float32)
    del model
    release()
    # paligemma-3b at full width and 6 of its 18 layers (the depth cut of
    # phase 12's budget; vlm: 256 patches in front, 8 query heads over 1 kv
    # head of 256, k 16): the slot engine with each request's patches, then
    # text-only prompts through the paged (full residency), speculative and
    # cuda_fm engines; rtopk on its warp body
    pcfg = get_config("paligemma-3b")
    p6 = dataclasses.replace(pcfg, num_layers=6)
    model = init(p6, device="cuda", seed=SEED)
    _, p_slot = timed(phase_engine, model, p6, f"6 of {pcfg.num_layers} layers (depth cut)",
                      patches=True)
    p_paged = timed(phase_paged, model, p6, p_slot, preempt=False)
    timed(phase_speculative, model, p6, p_paged, p_slot["prompts"])
    timed(phase_feature_major, model, p6, p_paged, p_slot["prompts"])
    del model
    release()
    # its f32 end to end at 2 layers with the patch prefix, f32 caches
    p2 = dataclasses.replace(pcfg, num_layers=2)
    model = init(p2, device="cuda", seed=SEED)
    timed(phase_end_to_end, model, p2, f"2 of {pcfg.num_layers} layers (depth cut)",
          torch.float32, patches=True, tol=1e-4)
    del model
    release()
    # llama3-8b at full width and LLAMA8B_SERVE_LAYERS of its 32 layers (GQA
    # 32 over 8 kv heads of 128, k 16, RoPE theta 500,000, vocab 128,256,
    # untied): the slot, paged (full residency), speculative and cuda_fm
    # engines on the same 8 requests
    l8cfg = get_config("llama3-8b")
    l8 = dataclasses.replace(l8cfg, num_layers=LLAMA8B_SERVE_LAYERS)
    l8_depth = (f"{l8.num_layers} of {l8cfg.num_layers} layers (depth cut)"
                if l8.num_layers < l8cfg.num_layers else "full depth")
    model = init(l8, device="cuda", seed=SEED)
    _, l_slot = timed(phase_engine, model, l8, l8_depth)
    l_paged = timed(phase_paged, model, l8, l_slot, preempt=False)
    timed(phase_speculative, model, l8, l_paged, l_slot["prompts"])
    timed(phase_feature_major, model, l8, l_paged, l_slot["prompts"])
    del model
    release()
    # its f32 logits at 2 layers on f32 caches, cuda against torch on the card
    # (against the port on the CPU the two machines' projection sums part
    # top-k near-ties: 4.86e-4 on the H100)
    l2 = dataclasses.replace(l8cfg, num_layers=2)
    model = init(l2, device="cuda", seed=SEED)
    timed(phase_end_to_end, model, l2, f"2 of {l8cfg.num_layers} layers (depth cut)",
          torch.float32, tol=1e-4)
    del model
    release()
    # deepseek-7b at full width and depth (30 layers, MHA 32 of 128, k 16,
    # vocab 102,400, untied; 27.6 GB of f32 weights): the slot engine
    d7cfg = get_config("deepseek-7b")
    model = init(d7cfg, device="cuda", seed=SEED)
    timed(phase_engine, model, d7cfg)
    del model
    release()
    layers = cfg.num_layers
    # remat="full": each layer's forward runs twice per step (rtopk for Q
    # and K each time), its backward once
    train, _ = timed(phase_train, "gpt2-small-sfa8", 5,
                     {"rtopk": 4 * layers, "flash_sfa": 2 * layers, "flash_sfa_bwd": layers})
    dense, _ = timed(phase_train, "gpt2-small", 2,
                     {"flash_attention": 2 * layers, "flash_attention_bwd": layers})
    # the compact seam under remat="codes": per layer and step proj_rtopk
    # for q and k once (the backward's rerun takes the kept codes),
    # block-skip FlashSFA twice (forward and rerun), the compact backward
    # once, code_grad dx and dW for q and k
    compact, _ = timed(
        phase_train, "gpt2-small-sfa8", 5,
        {"proj_rtopk": 2 * layers, "flash_sfa_block_skip": 2 * layers,
         "flash_sfa_bwd_compact": layers, "code_grad_dx": 2 * layers,
         "code_grad_dw": 2 * layers},
        bwd_emit="compact", fwd_fuse=True, remat="codes")
    timed(phase_launcher)
    timed(phase_checkpoint)
    # qwen3 at full width and depth: the dense emit; a compact request,
    # which qk-norm sends off the seam (the op-level compact emit runs:
    # flash_sfa_bwd_compact); the dense qwen3-0.6b
    ql = qcfg.num_layers
    timed(phase_train, "qwen3-0.6b-sfa8", 3,
          {"rtopk": 4 * ql, "flash_sfa": 2 * ql, "flash_sfa_bwd": ql})
    timed(phase_train, "qwen3-0.6b-sfa8", 2,
          {"rtopk": 4 * ql, "flash_sfa": 2 * ql, "flash_sfa_bwd_compact": ql},
          bwd_emit="compact", fwd_fuse=True)
    timed(phase_train, "qwen3-0.6b", 2, {"flash_attention": 2 * ql, "flash_attention_bwd": ql})
    # llama3.2-3b at full width, 4 layers, through the RoPE compact seam:
    # k 16 gives codes 2k = 32 wide, which code_grad's tensor-core bodies
    # take at d 128 (no CUDA-core body)
    ll = 4
    seam = {"proj_rtopk": 2, "flash_sfa_block_skip": 2, "flash_sfa_bwd_compact": 1,
            "code_grad_dx": 2, "code_grad_dw": 2}
    timed(phase_train, "llama3.2-3b", 2, {name: n * ll for name, n in seam.items()},
          layers=ll, bwd_emit="compact2", fwd_fuse=True, remat="codes")
    # moonshot-v1-16b-a3b at full width, 4 of 48 layers (1 dense + 3 MoE),
    # dense emit, remat "full"; then the same model through the RoPE compact
    # seam (MHA, d 128, k 16: code width 32), launches as llama's
    ml = 4
    timed(phase_train, "moonshot-v1-16b-a3b", 2,
          {"rtopk": 4 * ml, "flash_sfa": 2 * ml, "flash_sfa_bwd": ml}, layers=ml)
    release()
    timed(phase_train, "moonshot-v1-16b-a3b", 2, {name: n * ml for name, n in seam.items()},
          layers=ml, bwd_emit="compact2", fwd_fuse=True, remat="codes")
    release()
    # llama3-8b at full width, 4 of 32 layers, through the RoPE compact seam
    # (GQA 32 / 8, k 16: code width 32), launches as llama3.2-3b's
    timed(phase_train, "llama3-8b", 2, {name: n * ll for name, n in seam.items()},
          layers=ll, bwd_emit="compact2", fwd_fuse=True, remat="codes")
    release()
    # deepseek-7b at full width, 4 of 30 layers: the dense emit, remat "full"
    dl = 4
    timed(phase_train, "deepseek-7b", 2,
          {"rtopk": 4 * dl, "flash_sfa": 2 * dl, "flash_sfa_bwd": dl}, layers=dl)
    release()
    # SFA distillation (paper Eq. 8) at full width and depth, sfa_distill 0.1:
    # the dense emit (the teacher, plain chunked attention, launches nothing),
    # then a compact request, which the seam declines with the reference's
    # reason (the op-level compact emit runs)
    timed(phase_train, "gpt2-small-sfa8", 2,
          {"rtopk": 4 * layers, "flash_sfa": 2 * layers, "flash_sfa_bwd": layers},
          distill=0.1)
    timed(phase_train, "gpt2-small-sfa8", 1,
          {"rtopk": 4 * layers, "flash_sfa": 2 * layers, "flash_sfa_bwd_compact": layers},
          distill=0.1, bwd_emit="compact", fwd_fuse=True)
    # hubert-xlarge at full width and depth on seeded frames: bidirectional,
    # d = dv 80, so rtopk's warp body and FlashSFA's tensor-core bodies on
    # 96-column tiles (the same per-layer launches as gpt2's dense emit
    # under remat "full")
    hl = get_config("hubert-xlarge").num_layers
    hubert, hubert_dense = timed(phase_train_frames, "hubert-xlarge", 2,
                                 {"rtopk": 4 * hl, "flash_sfa": 2 * hl, "flash_sfa_bwd": hl},
                                 bodies={"rtopk_warp": 4 * hl})
    release()
    # the same through the compact seam under remat "codes" (width 16, no
    # RoPE): proj_rtopk, block-skip FlashSFA and code_grad on the wide
    # tensor-core bodies, launches as llama's seam, no CUDA-core or warp body
    _, hubert_seam = timed(phase_train_frames, "hubert-xlarge", 2,
                           {name: n * hl for name, n in seam.items()},
                           bwd_emit="compact", fwd_fuse=True, remat="codes")
    release()
    # paligemma-3b at full width and 6 of 18 layers (its serving depth) on
    # text batches, as the launchers build them: d = dv 256 (K and V
    # repeated to the 8 query heads before rtopk), rtopk's warp body,
    # FlashSFA's tensor-core bodies with two warpgroups a block
    pl_ = 6
    _, pali_dense = timed(phase_train, "paligemma-3b", 2,
                          {"rtopk": 4 * pl_, "flash_sfa": 2 * pl_, "flash_sfa_bwd": pl_},
                          layers=pl_, bodies={"rtopk_warp": 4 * pl_})
    release()
    # the same through the RoPE compact seam (compact2: code width 32 at d
    # 256) under remat "codes", launches as llama's seam
    _, pali_seam = timed(phase_train, "paligemma-3b", 2,
                         {name: n * pl_ for name, n in seam.items()}, layers=pl_,
                         bwd_emit="compact2", fwd_fuse=True, remat="codes")
    release()
    for arch, sm, dn in (("hubert-xlarge", hubert_seam, hubert_dense),
                         ("paligemma-3b", pali_seam, pali_dense)):
        print(f"[train] {arch}: compact seam, remat codes against the dense emit, remat full: "
              f"step {sm['step_ms']:.2f} vs {dn['step_ms']:.2f} ms, peak {sm['peak_gib']:.2f} "
              f"vs {dn['peak_gib']:.2f} GiB, device busy {100 * sm['busy']:.1f}% vs "
              f"{100 * dn['busy']:.1f}% of the traced step")
    timed(phase_grad_end_to_end)
    timed(phase_dense_grad_end_to_end)
    timed(phase_sfa_grad_bf16_end_to_end)
    timed(phase_sfa_grad_bf16_end_to_end, "qwen3-0.6b-sfa8", 2, False)
    timed(phase_sfa_grad_bf16_end_to_end, "moonshot-v1-16b-a3b", 2)
    timed(phase_grad_end_to_end, "llama3.2-3b", 2, (GRAD_RUNS[0], GRAD_RUNS[2]), True)
    timed(phase_sfa_grad_bf16_end_to_end, "hubert-xlarge", 2)
    timed(phase_grad_end_to_end, "hubert-xlarge", 2, GRAD_RUNS[:2], leaf_tol=1e-4)
    # hubert's f32 seam (the CUDA-core bodies at d 80) against the torch run
    timed(phase_grad_end_to_end, "hubert-xlarge", 2, (GRAD_RUNS[0], GRAD_RUNS[2]))
    timed(phase_sfa_grad_bf16_end_to_end, "paligemma-3b", 2)
    # paligemma's f32 gradients: the CUDA-core backward at dv 256 (32-row
    # tiles), dense emit and the compact2 seam under remat "codes"
    timed(phase_grad_end_to_end, "paligemma-3b", 2, (GRAD_RUNS[0], GRAD_RUNS[1], GRAD_RUNS[3]))
    # gpt2-small-sfa8's f32 gradients with sfa_distill 0.1: loss, aux, leaves
    timed(phase_grad_end_to_end, "gpt2-small-sfa8", 2, GRAD_RUNS[:2], distill=0.1)
    timed(phase_variants)
    # the JB shapes carry their launches in phase 12's two jamba serving runs
    for (kname, key), n in timed(phase_recurrent, results).items():
        results[kname]["shapes"][key]["launches"] = n
    # the RING shapes carry the launches of phase 14's ring-4 steps, all ranks
    for kname, n in timed(phase_distributed, results).items():
        if kname != "rtopk":
            results[kname]["shapes"]["RING"]["launches"] = n
    decode_src = "src/repro_torch/csrc/flash_sfa_decode.cu"
    fm_src = "src/repro_torch/csrc/flash_sfa_decode_fm.cu"
    # rows 3-5 run bf16 on the tensor-core bodies (f32 on flash_sfa.cu and
    # flash_sfa_bwd.cu); their timed calls are bf16
    sfa_tc_src = "src/repro_torch/csrc/flash_sfa_tc.cu"
    meta = {
        "rtopk": ("src/repro_torch/csrc/rtopk.cu", "src/repro/kernels/rtopk.py:112", counts),
        "proj_rtopk": ("src/repro_torch/csrc/proj_rtopk.cu",
                       "src/repro/kernels/rtopk.py:202", compact),
        "flash_sfa": (sfa_tc_src, "src/repro/kernels/flash_sfa.py:297", counts),
        "flash_sfa_block_skip": (sfa_tc_src, "src/repro/kernels/flash_sfa.py:387", compact),
        "flash_sfa_bwd_compact": (sfa_tc_src, "src/repro/kernels/flash_sfa_bwd.py:342",
                                  compact),
        "code_grad_dx": ("src/repro_torch/csrc/code_grad.cu",
                         "src/repro/kernels/code_grad.py:81", compact),
        "code_grad_dw": ("src/repro_torch/csrc/code_grad.cu",
                         "src/repro/kernels/code_grad.py:140", compact),
        "flash_sfa_decode": (decode_src, "src/repro/kernels/flash_sfa_decode.py:110", counts),
        "flash_sfa_decode_paged": (decode_src, "src/repro/kernels/flash_sfa_decode.py:198",
                                   paged_run["counts"]),
        "flash_sfa_decode_multi": (decode_src, "src/repro/kernels/flash_sfa_decode.py:298",
                                   spec),
        "flash_sfa_decode_fm": (fm_src, "src/repro/kernels/flash_sfa_decode.py:429", fm_slot),
        "flash_sfa_decode_fm_paged": (fm_src, "src/repro/kernels/flash_sfa_decode.py:536",
                                      fm_paged),
        "flash_sfa_bwd": (sfa_tc_src, "src/repro/kernels/flash_sfa_bwd.py:342", train),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:155", dense),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_sfa_bwd.py:380", dense),
    }
    kernels = []
    for kname, r in results.items():
        src, replaces, path_counts = meta[kname]
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                            launches=path_counts[kname], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            **({"shapes": r["shapes"]} if "shapes" in r else {})))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
