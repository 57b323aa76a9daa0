#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases, in order; any failure raises and the script exits non-zero:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA).
2. Build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once); log ptxas's registers, shared memory
   and spills, the tensor-core flash forward's registers, local (spill)
   bytes, dynamic shared memory and blocks per SM at each head dim (hd
   192: its own kernel, three 64-row blocks an SM), and the flash forward
   and backward kernels' shared memory and blocks per SM
   (the fp32 forward at hd 32, 64, 80, 128 and 192, the backward at 32, 64
   and 128 in fp32 and in bf16 and at 80 in bf16, the bf16 backward's
   kernels with their registers and local bytes; each must fit at least
   one block on an SM), and the sLSTM backward walk's registers, local
   bytes, shared memory and clusters held at xlstm's microbatch with r in
   bf16 and fp32 (no spill).
3. The serve paths' bf16 GEMMs (prefill and decode rows) against the fp32
   product of the same operands rounded to bf16, with
   ``allow_bf16_reduced_precision_reduction`` at its default and False:
   the worst error in bf16 ulps per shape (at most one at the default),
   and whether the flag changes a bit (a split-K GEMM reducing its
   partials in bf16 would); also moonshot's expert products' bf16
   backward GEMMs at its Trainer microbatch, batched over 64 experts of
   120 slots (``dup @ w_up^T``, K = 1408; ``dy @ w_down^T``, K = 2048).
4. Hold each kernel against its plain PyTorch version on the card (fp32
   tolerance 2e-5, bf16 2e-2, as |got - want| <= tol + tol * |want|, each
   output at its own dtype's tolerance), on the grids of
   ``tests/test_kernels.py`` and at the serving paths' shapes, and time
   kernel, plain version, a one-call PyTorch yardstick where one exists and
   the bound: flash_attention (every case in fp32, the CUDA-core kernel,
   and in bf16, the tensor-core kernel: causal, three windows, non-causal,
   T=1 at q_offset 76, T=37/S=100 at q_offset 63, then bf16 prefill
   lengths, each also held per row against the fp32 result relative to
   the row's RMS; then phase 5f's regimes in bf16 at hd 128, each held per
   row and timed beside SDPA and the bound over its visible pairs: B=1
   T=S=1000 at H=40 KV=8 (qwen3-14b), H=12 KV=2 (qwen2-1.5b) and H=KV=16
   (moonshot), and H=48 KV=8 T=S=5000 with a 4096-key window (mixtral;
   SDPA on the window's boolean mask); then hd 80, zamba2's shared block, in both dtypes:
   B=1 T=S=137 / 1000 / 1291 H=KV=32, GQA, a window, non-causal and T=1 at
   q_offset 76, the three prefill shapes also held per row in bf16 and
   timed in both dtypes), rmsnorm (both dtypes, the vector path and the scalar
   one: d=100 and a view 16-byte misaligned, the q_norm decode rows
   64 x 128, phase 5f's widths 1000 x 1536 / 5120 / 6144, and in fp32
   every norm shape of both training paths),
   ssd_scan (outputs and final states, B and C per group, both paths in
   both dtypes with the path each case took logged: the grid, one case
   also with its group expanded to G = H, one N = 128 case on the ordered
   walk; with and without an initial state, with the mLSTM normalizer,
   and one path case drawn like the served model: slow forgetting,
   exponential input gates; timed at each path length; then zamba2's
   Mamba-2 shape on the chunk-parallel path, b=1 H=80 G=1 N=64 P=64
   without the normalizer, drawn like that model: dt = softplus(N(0, 1) +
   dt_bias), dt_bias the inverse softplus of a log-uniform draw in
   [1e-3, 1e-1], A = -(1..80), at T = 137 / 1000 / 1291, each timed and
   called twice for the same bits, the ordered walk also held and timed
   at T=1000, and once from an initial state; the small grid cases timed
   on both paths), slstm_scan (outputs and final states; path cases at
   every path length, fp32 r at dh=512 whose rows beyond shared memory come from
   L2, and B=4; each timed, in µs per step too; the cluster shape and how
   many such clusters the card holds at once). Then the member step's
   backward kernels, in fp32, against autograd of the plain versions, each
   gradient within 1e-4 of its largest magnitude: flash_attention_bwd (hd 32
   and 128, GQA group 2, causal, T = 32 / 137 / 512 / 1000 with B.T >= 2048
   at the larger T, one q_offset > 0 and one window case, one hd 64 case;
   the fp32 forward's output beside it; a run without the first key tile
   must fail the check; two calls at T=512 and T=137, hd 128, must give the
   same bits; the delta, dk/dv and dq kernels also timed apart; the fp32
   forward's lse against the plain lse in every case and in the run without
   the first key tile, whose first 64 rows see no key: within 1e-5 as
   above, +inf rows identical; two forward calls at T=512 the same bits;
   the forward timed at T=512, B=3 T=1000 and B=8 T=32 hd 32)
   and rmsnorm_bwd (every norm shape of both training paths and a view off
   16-byte alignment, the scalar path). Then the trainer's bf16 backward
   kernels against their plain versions on the same bf16 inputs, per row
   relative to the row's RMS within twice the plain version's own bf16
   rounding: flash_attention_bwd (the tensor-core kernels) at B=4 T=512
   H=16 KV=8 hd=128 (the trainer's microbatch), T=137 with a window, hd
   32 (the reduced config's), hd 64, a q_offset and a non-causal window
   with S > T, fed o, lse and o rounding residual o_lo as training feeds
   them (D reads o + o_lo), with the bf16 forward's lse against the plain
   lse and its o_lo within half a bf16 unit of o in each case and the
   error against the plain version with the kernels' own
   rounding (P and dS in bf16) logged, two calls the same bits and a run
   without the first key tile failing the check; at each regime, on
   inputs whose P is exactly 1 (``check_flash_residual``), o + o_lo
   within 2^-16 of the exact output and the backward fed the forward's
   own o, lse and o_lo held to the exact gradient, a zeroed o_lo failing
   both; rmsnorm_bwd (dx and dg,
   the kernels of ``rmsnorm_bwd_sm90.cu``) at every training norm shape,
   at qwen3-14b's d = 5120 and on a view 2 bytes off alignment, two calls
   the same bits at each, its layout (``bwd_plan``) logged; the bf16
   forward timed with and without lse at B=1 T=1000 and B=4 T=512. Each
   backward is timed beside its bound, its plain backward and the backward
   of ``F.scaled_dot_product_attention`` (GQA) or ``F.rms_norm`` in the
   same dtype, the flash backward's three kernels also apart; the bf16
   rmsnorm backward at the Trainer's three norm shapes (2048 x 1024, 32768
   x 128, 16384 x 128), with those times summed over one Trainer step's
   114 / 56 / 56 launches. Last, phase 5g's regimes on a generator of
   their own: flash non-causal with S != T in both dtypes (whisper's
   cross attention, H = KV = 12 hd 64, B, T = 1, 4 / 2, 37 / 4, 224
   against S = 1500: a ragged last key tile and query tiles under 64
   rows), each also held per row in bf16; in bf16, held, held per row
   and timed beside SDPA and the bound: non-causal B=4 T=S=1500 H=KV=12
   hd 64 (whisper's encoder) and causal B=1 T=S=1000 H=28 KV=4 hd 128
   (qwen2-vl's GQA group of 7); rmsnorm at 6000 x 768 (the encoder's
   rows) and 1000 x 3584 in both dtypes, timed in bf16. Then phase 5h's
   regimes on a generator of their own: flash at hd 192 with nemotron's
   GQA 96:8, causal, in both dtypes at B=1 T=S=1000, T=S=137 and two
   decode shapes (T=1 against S=1100 at q_offset 1099, T=4 against S=1100
   at q_offset 1096: the 4-slot decode), each held against the plain
   version and in bf16 per row and called twice for the same bits;
   T=S=1000 timed in bf16 beside SDPA and in fp32 (the CUDA-core kernel,
   which phase 5h's fp32 reference runs) beside SDPA in fp32; the
   backward at hd 192 must raise NotImplementedError on the card; rmsnorm
   at 1000 x 18432 in both dtypes (the streamed path), timed in bf16.
5. Serve: ``ServeEngine`` at full width, bf16 weights drawn from a seeded
   generator, 4 slots, 8 requests (prompt lengths from ``default_rng(0)`` in
   [100, 1500], 32 new tokens each), for three models in turn:
   - qwen3-0.6b (28 layers, 2048 positions): 28 flash launches per prefill,
     113 rmsnorm launches per prefill and per decode step;
   - xlstm-1.3b (48 blocks, 42 mLSTM + 6 sLSTM): 42 ssd_scan and 6
     slstm_scan launches per prefill (one ssd_scan call, the ordered
     walk's two kernels, computes an mLSTM layer's output and normalizer),
     55 rmsnorm launches per prefill and per decode step;
   - zamba2-2.7b (54 Mamba-2 layers, one shared ATTN block applied after
     every 6, 9 times, hd 80): 54 ssd_scan (the chunk-parallel path's
     three kernels a call) and 9 flash_attention launches per prefill,
     127 rmsnorm launches per prefill and per decode step (ln1 and the
     mixer's norm per Mamba-2 layer, ln1 and ln2 per shared application,
     final_norm).
   Each checks every request finished, the exact launch counts (set to 0
   just before the phase and read just after), and teacher-forced logits of
   one request against the same model run through the plain versions on the
   card (bf16 within twice the bf16 noise floor, measured against an fp32
   run; fp32 weights within the floor; at each position where the greedy
   tokens differ, the fp32 path's token and top-2 margin are logged). A
   traced window then gives the
   device's busy share and device time by kernel, and shows that bf16
   serving ran no fp32 (CUDA-core) flash kernel and that each model's
   ssd_scan ran the kernels of its path and no other.
5f. Serve the remaining decoder-only text archs the same way (bf16, 4
   slots, 8 requests of 32 new tokens), one model on the card at a time
   (each freed before the next), logging params, GiB, peak memory,
   seconds, prefill ms, decode ms and tokens/s beside the card line:
   - qwen3-14b (40 layers, GQA 40:8, qk-norm): 40 flash launches per
     prefill, 161 rmsnorm per prefill and per decode step;
   - qwen2-1.5b (28 layers, GQA 12:2, QKV biases): 28 and 57;
   - moonshot-v1-16b-a3b (48 MoE layers, 64 experts, top 6; 28.06 B
     params, 52.3 GiB): 48 and 97, and one traced window with the MoE's
     routing, sort, gather and combine kernels in a group of their own;
   - mixtral-8x22b cut to 8 of its 56 layers at full width (8 experts,
     top 2, ~37 GiB; all 56 take 140.6 B params), the phase's one
     reduction: 8 and 17, prompts of 4200-6000 tokens at max_seq 8192, so
     every prompt runs past the 4096-token window and the rolling cache
     wraps in prefill and in decode.
   The teacher-forced check runs whole where the model's fp32 copy fits
   beside it (qwen2-1.5b). Otherwise on a depth cut, the first k layers
   (views of the same weights, same embed and head; k fixed per model in
   ``FP32_DEPTH_CUT``: qwen3-14b 24, moonshot 5, mixtral 2; the check
   raises where it does not fit), which gives the bf16 noise floor; the
   full-depth model's kernel path must then be within twice that floor of
   its plain path in bf16. The plain attention runs 2048 query rows a call
   so a 5000-token prompt's fp32 scores fit beside the model. For an MoE
   model the layer check also logs, per layer, the (token, k) router
   choices in which the kernel block and the plain block differ on the
   same input, each with its top-k margin beside the router's bf16
   rounding at its token (a tie when within twice that).
5g. Serve the frontend archs at full width in bf16 through the model's
   own entry points, ``prefill`` with the modality inputs and then
   ``decode_step`` (``ServeEngine`` refuses both: its requests carry
   tokens only, and the JAX package's engine cannot serve them either),
   one model on the card at a time, random weights from seed 0: two
   batches of 4 prompts of one length (``default_rng(0)``), then 32
   greedy decode steps at a scalar cache_len, the tokens chosen on the
   card:
   - qwen2-vl-7b (28 layers, GQA 28:4, QKV biases, M-RoPE (16, 24, 24);
     7.6 B params): prompts in [300, 1300], max_seq 2048, each holding one
     16 x 16 grid of patch embeddings (N(0, 0.02^2), bf16) at positions
     8-263 with Qwen2-VL's M-RoPE ids (text before the grid at t = h = w
     = i, patch (r, c) at (8, 8 + r, 8 + c), text after it from 24 on):
     28 flash and 57 rmsnorm launches per prefill, 57 per decode step;
   - whisper-small (12 encoder + 12 decoder layers, d 768, hd 64, the
     ungated GELU MLP, sinusoidal positions): 1500 frames per request
     (N(0, 0.02^2), bf16), prompts in [4, 224], max_seq 448: 36 flash (12
     encoder, non-causal 1500 x 1500; 12 causal self; 12 cross, T against
     1500) and 62 rmsnorm per prefill, 37 rmsnorm per decode step.
   The exact launch counts, prefill ms per request, decode ms per step,
   tokens/s and peak memory beside the card line, and the teacher-forced
   check of each model whole (its fp32 copy fits), with the first
   request's frames or patches and M-RoPE ids.
5h. Serve nemotron-4-340b at full width in bf16 (d 18432, GQA 96:8, hd
   192, the ungated squared-ReLU MLP of 73728, an untied vocabulary of
   256000) cut to 4 of its 96 layers, the phase's one reduction (23.2 B
   params, 43.3 GiB; all 96 layers take 341 B), as phase 5f serves: 4
   flash and 9 rmsnorm launches per prefill, 9 rmsnorm per decode step,
   exactly; one traced window. Its logits cannot be held on a fp32 copy,
   not even a 1-layer cut's (the two fp32 tables alone take 35.2 GiB), so
   ``check_streamed`` keeps the weights in bf16 and upcasts only what a
   step reads: the prompt's and the forced tokens' embedding rows run as
   one causal sequence, each layer's fp32 copy in turn (12.9 GiB), the
   head one vocabulary chunk at a time; the kernel path's and the plain
   path's bf16 logits (prefill and 8 decode steps) are held to that fp32
   reference by the teacher-forced rule, the same layers through the
   fp32 kernels within the floor of it; the GiB free logged at each step;
   then every layer on the kernel path's input.
5b. Train: the sweep's member step (``repro_torch.launch.sweep``:
   ``forward_loss`` -> autograd through the kernels' Functions ->
   ``adamw_update``), TF32 off, params in fp32:
   - qwen3-0.6b at full width (28 layers, vocab 151936, tied; random from
     seed 0) on one fixed 4 x 512 batch: one step with the kernels against
     the same step through the plain versions (loss, grad norm, every
     gradient and updated leaf), then 8 steps at lr 1e-3 with exactly 28
     flash_attention, 28 flash_attention_bwd, 113 rmsnorm and 113
     rmsnorm_bwd launches each and a falling loss, then one traced step,
     recorded after a warm-up step (busy share, device ms by group);
   - the sweep's own member (``member_config``: 4 layers, hd 32, vocab
     256): one step held against its plain step as above, then 16
     members x 5 steps on ``SyntheticLM(256, 32, 8, seed=0)`` at
     lr ``np.geomspace(1e-4, 3e-2, 16)``, one after another, with exactly
     4 / 4 / 17 / 17 launches per step; then 20 ticks of a 2-slot engine
     on the last member's trained params: no param leaf requires grad, no
     cache leaf carries autograd state, and the tokens equal an engine's on
     a detached copy.
5c. The sweep's command line (``repro_torch.launch.sweep``: preposition,
   supervisor, one task array of members on the inline backend):
   - ``python -m repro_torch.launch.sweep`` as a user runs it (16 members
     x 5 steps on the card) in a subprocess with ``PYTHONPATH=<root>/src``
     under a timeout, finding phase 2's library: exit 0 and ``launched
     16/16 members``; its process wall time, ``prepositioned in`` and
     members/s are logged;
   - ``run_sweep`` with the same defaults in this process: warm cache
     ``{warms 1, hits 16, misses 0}``, 16 of 16 ok, exactly 81 member
     steps' launches (the warm step and 16 x 5), the prepositioned params
     bit-equal to a fresh seed-0 init after the sweep, the final losses
     within 1e-6 of 5b's hand-run sweep (bit-equality logged); member
     launch times logged;
   - the supervisor at full width (qwen3-0.6b fp32, 28 layers, 5b's
     seed-0 params and 4 x 512 batch): prepositioned through the warm
     cache (``build_s``, ``first_step_s`` logged), then 3 members x 3 steps
     at lr 1e-3, 1e-3, 3e-4, launched one at a time under the quota of one
     card: 3 hits, exactly 10 steps' launches, members 0 and 1 the same
     losses bit for bit, every first loss 5b's step-0 loss within 1e-6;
     launch times, step times and the peak memory logged.
5d. The fault-tolerant trainer (``repro_torch.train``) at full width in
   bf16: ``Trainer`` on qwen3-0.6b as configured (bf16 params, fp32
   moments, 2 microbatches, remat full, random from seed 0) on
   ``SyntheticLM`` 8 x 512, peak lr 1e-3, warmup 2. Step 0's loss and
   gradients through the kernels against the same through the plain
   versions, held to the plain bf16 path's noise floor against plain fp32;
   8 steps with a checkpoint every 4, exactly 112 flash_attention, 56
   flash_attention_bwd, 450 rmsnorm and 226 rmsnorm_bwd launches a step
   (the remat recompute counted), no retry, a falling loss; then a new
   Trainer on the same directory, without step 8's checkpoint, resumes at
   step 4 and its losses for steps 5-8 must be the first run's (within
   1e-5, bit-equality logged); step ms, peak memory, the async save's,
   write's and restore's seconds and one traced step's device ms by group
   logged, its "rmsnorm bwd" group beside phase 4's sum over a step.
   ``python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20``
   (the reduced config, hd 32: exit 0 and ``done at step 20``) runs with
   phase 5j's CLIs.
5i. The Trainer on the recurrent archs at full width in bf16, one model on
   the card at a time, as configured (2 microbatches, remat full; xlstm
   bf16 moments, zamba2 fp32), on ``SyntheticLM`` 8 x 512, peak lr 1e-3:
   - step 0's loss and gradients on a depth cut (xlstm 2 layers: 1 mLSTM
     + 1 sLSTM; zamba2 12 layers: two shared applications; the fp32 copy
     and three gradient trees of ``check_trainer_step0`` do not fit beside
     the full model's state), held as phase 5d holds qwen3's (zamba2's
     also to the plain path with the flash backward's rounding by
     design, within the same 2x), with the cut's exact launch counts; the same step twice from one state on the
     cut: the same bits;
   - 4 steps at full depth (xlstm 42 mLSTM + 6 sLSTM, 3.0 B params;
     zamba2 54 Mamba-2 layers + the shared block 9 times, 2.4 B), exactly
     ``recurrent_launches`` a step: per microbatch every scan and stage
     norm forward twice (remat), each backward once (ssd_scan_bwd,
     slstm_scan_bwd; zamba2's flash_attention_bwd at hd 80), a falling
     loss; one traced step (busy share, device ms by group, "scan fwd" and
     "scan bwd" among them);
   - their CLIs run with phase 5j's.
   Before it, phase 4's checks of these paths' new kernels run (after the
   serving phases, so their streams' cuBLAS workspaces do not take from
   the memory beside the fp32 depth cuts), at the Trainer's microbatch (B.T = 4 x 512): ``ssd_scan_bwd`` (csrc/ssd_scan_bwd.cu) at
   zamba2's b=4 H=80 G=1 N=P=64 and xlstm's H=4 N=512 P=1024 with the
   normalizer (drawn like the models) and on a grid (groups, ragged T,
   decays of e^-8 a step and near 1), ``slstm_scan_bwd``
   (csrc/slstm_scan_bwd.cu: one launch of a cluster per head) at B=4
   T=512 nh=4 dh=512 with r in bf16 and fp32 and on a grid (B=16 at dh
   512, 16-unit blocks at dh 48, T=1, the input gate across I_CLAMP),
   each against its plain backward (``ssd_scan_bwd_ref``,
   ``slstm_scan_bwd_ref``) within GRAD_TOL of every gradient's largest
   magnitude (dr from bf16 r within a bf16 rounding), two calls the same
   bits, timed beside the plain version and the bound (the sLSTM walk
   also without its dR product, with the clusters the card holds at
   once and µs a step); the bf16 flash
   backward at hd 80 (zamba2's H=KV=32 at B=4 T=512, GQA groups 2 and 4,
   and zamba2's heads under a 128-key window) per row as the other bf16
   backward cases, each called twice for the same bits, timed beside
   SDPA's with its three kernels apart; the bf16 rmsnorm
   backward at 2048 rows of d = 2048, 2560 and 5120, timed.
5j. The Trainer on moonshot-v1-16b-a3b (MoE) in bf16 at full width, as
   configured (4 microbatches, remat full, fp32 moments, capacity factor
   1.25: 120 slots an expert at 2 x 512 tokens), on ``SyntheticLM`` 8 x
   512:
   - through ``train_arch``, as phase 5k's archs: step 0's loss and
     gradients on a cut of 2 layers (1.8 B params) against the plain
     paths within twice the plain bf16 floor, as 5i
     holds its cuts, with the kernel path's top-k choices pinned into
     every path (``PinnedRouting``: a random router turns the paths'
     roundings into other experts at near-ties); the choices the
     unpinned plain bf16 and fp32 paths would have made otherwise
     (``router_flips``) and the slots each microbatch drops are logged;
     the same step twice from one state on the cut: the same bits (the
     MoE's backward sums in a fixed order);
   - 8 steps at 4 of 48 layers (2.95 B params), exactly 32 / 16 / 68 /
     36 launches of flash_attention / flash_attention_bwd / rmsnorm /
     rmsnorm_bwd a step, a falling finite loss, step ms and peak GiB, one
     traced step ("moe dispatch" and "matmul fp32", the gate product's
     backward, apart);
   - two reduced moonshot member steps from one state in process: the
     same bits;
   - the training CLIs of phases 5d, 5i and 5j, seven processes at once
     (``arch_clis``): ``python -m repro_torch.launch.train --arch <arch>``
     for qwen3-0.6b (20 steps), xlstm-1.3b, zamba2-2.7b and moonshot (10
     steps): ``done at step N``; ``python -m repro_torch.launch.sweep
     --arch <arch> --members 4 --steps 2`` for the last three:
     ``launched 4/4 members``.
   Before it, phase 4 holds this path's regimes: the bf16 flash forward
   and backward at B=2 T=S=512 H=KV=16 hd=128 causal (the backward's
   first MHA regime at hd 128; per row, twice for the same bits) and the
   bf16 rmsnorm forward and backward at 1024 x 2048, each timed beside
   SDPA or ``F.rms_norm`` and the bound.
5k. The Trainer on whisper-small (12 encoder + 12 decoder layers, 0.28 B
   params, 1 microbatch of 8 x 512 with frames [8, 512, 768] drawn per
   step), qwen2-vl-7b (4 of 28 layers, 2.02 B params, 4 microbatches of 2
   x 512, an 8 x 8 grid of patches at 8-71 with M-RoPE ids) and
   mixtral-8x22b (1 of 56 layers, 2.91 B params, 8 microbatches of 1 x
   4096 through the 4096-key window, step 0 with the routing pinned) in
   bf16 at full width, each as configured, through ``train_arch``: step 0
   on the trained depth against the plain paths within twice the plain
   bf16 floor, the same step twice for the same bits, 8 steps with
   exactly ``trainer_launches`` a step (whisper: one flash an encoder
   layer, self and cross a decoder layer; ln1 / ln2, ln1 / ln_x / ln2,
   enc_norm and final_norm) and a falling loss, one traced step, the
   peaks of the step-0 checks and of the steps. Before it, phase 4 holds
   the flash forward (with its lse and rounding residual) and backward
   at B=8 T=S=512 H=KV=12 hd 64 non-causal and causal, B=2 T=S=512 H=28
   KV=4 (GQA 7) and H=48 KV=8 under the 4096-key window at B=1 T=S=4096
   (forward and backward the bits of plain causal: key 0 is in every
   row's window) and T=S=5000 (the window binds), each per row, twice the
   same bits, a run without the first key tile failing, timed beside
   SDPA; and the bf16 rmsnorm forward and backward at 4096 x 768, 1024 x
   3584 and 4096 x 6144, timed.
5l. The one-card dry-run and the assignment's cells (after 5k, before 5e):
   - ``python -m repro_torch.launch.dryrun --all``, started in the
     background after phase 1 (the meta device: the host's CPU, beside
     the card's phases) and collected here: exactly the expected ok /
     skip / fail set over the 40 cells (``DRYRUN_FAILS``: the cells where
     the card raises too, each for its reason), exit code 1;
   - every applicable cell whose dry-run peak (arguments + temps) fits
     ``FIT_SHARE`` of the card, run once whole (xlstm-1.3b ``decode_32k``
     and ``long_500k``, zamba2-2.7b ``long_500k``), and the cut cells of
     ``CUT_CELLS`` at the largest power-of-two batch whose dry-run peak
     fits (qwen3-0.6b ``train_4k`` and ``prefill_32k``: flash and rmsnorm
     forward and backward; xlstm-1.3b ``prefill_32k`` at batch 1: the
     scans), each through ``build_step``'s program on ``real_args``: the
     argument bytes exactly the dry-run's, the peak
     (``max_memory_allocated`` beyond what was live before the arguments)
     within ``PEAK_TOL`` of the dry-run's, exact launches, every kernel
     call at a shape phase 4 held (``recording``, ``call_key``), the
     device ms (and tokens/s for decode), and a repeat-determinism check:
     the direct entry point the spec wraps (``decode_step``, ``prefill``,
     ``make_train_step``), on arguments made again from the same seed,
     gives outputs of the same ``bits_digest`` (plain and
     position-weighted bit sums);
   - the five examples (``examples/torch_*.py``) as processes at once, the
     four model examples with ``--device cuda``, wordstats on the real
     worker pool: each must exit 0.
   Before it, phase 4 holds each kernel at the shapes these cells give it
   (``check_cell_kernels``): the bf16 flash forward (lse, rounding
   residual) and backward at qwen3's train_4k microbatch, B=4 T=S=4096
   H=16 KV=8, as phase 5k's regimes; the bf16 forward at the whole
   prefill_32k cut, B=4 T=S=32768, held one (batch row, KV group) at a
   time and timed on one of them (the plain scores of the whole call
   would take 256 GiB); every norm of the cells, forward, and train_4k's
   backward; ssd_scan (walk, normalizer) and slstm_scan at T=32768
   against their plain versions over the whole sequence. Phase 2 holds
   the wrapper's ssd_scan workspace sizes and shape refusals (Python, the
   meta path's one source) against the C entries
   (``check_ssd_shape_rules``).
5e. The paper's launch layer on the card's host, with no JAX (no kernel
   runs here: the counts, set to 0 just before, must still be 0 after):
   - the discrete-event reproduction of TX-Green through the port's
     ``measure_launch``, held to the paper's bounds: TensorFlow 512 x 64
     (32,768 processes) under 5 s, Octave 512 x 64 under 10 s, Octave
     512 x 512 (262,144 processes) under 40 s, Octave 512 x 256 at
     4000-12000 launches/s, MATLAB 625 x 64 flat and cold in 1800-3600 s;
     each logged in *simulated* TX-Green seconds, not a time of this host;
   - ``get_backend("sim")``: a map of 16 and a reduce under a seeded
     ``KILL_LAUNCHER`` plan: all ok, right values, at least one lost
     attempt, and the event stream replays against the declared protocol
     (``validate_trace``);
   - ``get_backend("procpool", n_launchers=2, workers_per_launcher=2)``:
     8 ``cmd`` tasks while the plan SIGKILLs a launcher: all ok, right
     values, one crash, at least one lost attempt (as many ``LOST``
     events), ``validate_trace``, and every launcher it ever spawned
     reaped;
   - ``core.realproc.compare(8, 16)``: flat and two-tier launches of 128
     real processes complete and leave none unreaped; both wall times
     logged with the host's CPU count and the card line (no rate is
     compared: it follows the host's load);
   - the port's lint, ``python -m repro_torch.analysis --baseline
     src/repro_torch/analysis/baseline.txt``, in a subprocess under a
     timeout: exit 0.
6. Print the kernels' JSON line (flash and rmsnorm with every serving
   path's launches, phase 5f's four and 5g's two under ``"<arch> serve"``,
   and under ``"regimes"`` the rows timed for phase 5g; the bf16 forward
   at hd 192, its own kernel, as a row of its own with nemotron's
   launches; rmsnorm's phase 5h row under ``"regimes"``;
   the fp32 forward with its hd 192 row under ``"regimes"``; the fp32
   forward and both backward kernels with their training and sweep
   launches beside the serving kernels, the bf16 backward kernels with the
   trainers' launches, hd 80's as a row of its own with zamba2's; ssd_scan
   as two rows, the ordered walk with xlstm's launches and the
   chunk-parallel path with zamba2's, serving and phase 5i's; ssd_scan_bwd
   as two rows, xlstm's shape and zamba2's; slstm_scan_bwd with its fp32-r
   row under ``"regimes"``; phase 5j's and 5k's rows under the
   ``"regimes"`` of flash_attention, flash_attention_bwd_bf16, rmsnorm and
   rmsnorm_bwd_bf16, with their Trainers' launches under ``"<arch>
   train"``), the card line,
   and as the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN, so fp32 comparisons are full fp32.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      shape_applicable)
from repro_torch.core import SweepSupervisor  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import (LAUNCHES, build, flash_attention,  # noqa: E402
                                 flash_attention_bwd, flash_attention_bwd_ref,
                                 flash_attention_ref, ops, rmsnorm,
                                 rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref,
                                 slstm_scan, slstm_scan_bwd,
                                 slstm_scan_bwd_ref, slstm_scan_ref, ssd_scan,
                                 ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref,
                                 work)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _BWD_HEAD_DIMS, _FWD_HEAD_DIMS, _forward as flash_forward, bwd_occupancy,
    bwd_operands, fwd_occupancy, per_kv_head, sm90_occupancy, visible)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    bwd_layout as rmsnorm_bwd_layout, plan as rmsnorm_plan)
from repro_torch.kernels.slstm_scan import (  # noqa: E402
    I_CLAMP, _forward as slstm_forward, bwd_walk as slstm_bwd_walk,
    slstm_bwd_occupancy, slstm_max_clusters, slstm_plan)
from repro_torch.kernels.ssd_scan import _launch as ssd_launch  # noqa: E402
from repro_torch.kernels.ssd_scan import path as ssd_path  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    _ARGTYPES as SSD_FWD_ARGTYPES, _BWD_WS_ARGTYPES as SSD_BWD_WS_ARGTYPES,
    _CHUNKS_ARGTYPES as SSD_CHUNKS_ARGTYPES, bwd_occupancy as ssd_bwd_occupancy,
    bwd_workspace_floats as ssd_bwd_workspace_floats,
    fwd_workspace_floats as ssd_fwd_workspace_floats)
from repro_torch.ckpt import latest_step  # noqa: E402
from repro_torch.core import measure_launch, realproc  # noqa: E402
from repro_torch.exec import (FAULT, KILL_LAUNCHER, LOST,  # noqa: E402
                              FaultPlan, get_backend, validate_trace)
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models.blocks import block_forward  # noqa: E402
from repro_torch.models.model import (embed_tokens, encode,  # noqa: E402
                                      forward_hidden, lm_logits,
                                      n_shared_applications)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import build_step, real_args  # noqa: E402
from repro_torch.launch.sweep import (build_member_step,  # noqa: E402
                                      loss_and_grads, member_config,
                                      run_sweep, to_batch)
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.models import mlp as model_mlp  # noqa: E402
from repro_torch.models.common import (matmul, rms_norm,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.taskarray import RetryPolicy, TaskGraph  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import (_microbatch_stack,  # noqa: E402
                                    make_train_step,
                                    microbatch_grads, shaped_batch)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
QWEN_LAYERS = 28
QWEN_NORMS = 4 * QWEN_LAYERS + 1   # ln1, q_norm, k_norm, ln2 per layer + final
XLSTM_MLSTM, XLSTM_SLSTM = 42, 6
XLSTM_NORMS = XLSTM_MLSTM + 2 * XLSTM_SLSTM + 1   # ln1s, sLSTM ff_ln, final
ZAMBA_LAYERS, ZAMBA_APPS = 54, 9                   # Mamba-2 layers, shared
ZAMBA_NORMS = 2 * ZAMBA_LAYERS + 2 * ZAMBA_APPS + 1   # ln1 + mixer norm,
                                                      # ln1 + ln2, final
# phase 5f: arch, layers served, rmsnorm launches a layer (ln1 and ln2, +
# q_norm and k_norm with qk-norm), prompt lengths [lo, hi), max_seq
ARCH_SERVE = (
    ("qwen3-14b", 40, 4, (100, 1501), 2048),
    ("qwen2-1.5b", 28, 2, (100, 1501), 2048),
    ("moonshot-v1-16b-a3b", 48, 2, (100, 1501), 2048),
    ("mixtral-8x22b", 8, 2, (4200, 6001), 8192),   # 8 of 56 layers
)
TRACED_ARCH = "moonshot-v1-16b-a3b"


def log(*a):
    print(*a, flush=True)


def require(ok, what: str = "check failed"):
    """A check of this run's results; raises (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def run_modules(runs, timeout: float):
    """``python -m <args>`` (``python <args>`` where args[0] is a ``.py``
    file) for each (args, tag) of ``runs``, all started at
    once from the checkout's root, each a fresh process that finds the port
    (and phase 2's library) through ``PYTHONPATH``, its output to a file of
    its own; each one's output logged line by line under its tag. Past
    ``timeout`` s every process still running is killed and the call
    raises. Returns [(completed process, its wall s)] in ``runs``' order."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in runs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, *([] if args[0].endswith(".py") else ["-m"]),
             *args], cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
                 for (args, _), (out, err) in zip(runs, files)]
        walls = [None] * len(procs)
        try:
            while None in walls:
                for i, proc in enumerate(procs):
                    if walls[i] is None and proc.poll() is not None:
                        walls[i] = time.perf_counter() - t0
                if time.perf_counter() - t0 > timeout:
                    raise subprocess.TimeoutExpired(
                        [r[0] for r in runs], timeout)
                time.sleep(0.05)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        done = []
        for proc, (_, tag), (out, err), wall in zip(procs, runs, files,
                                                    walls):
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
            for line in (stdout + stderr).splitlines():
                log(f"  {tag}| {line}")
            done.append((subprocess.CompletedProcess(
                proc.args, proc.returncode, stdout, stderr), wall))
    return done


def run_module(args, tag: str, timeout: float):
    """``run_modules`` of one run: (the process, its wall s)."""
    return run_modules([(args, tag)], timeout)[0]


def host_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` called back to back from Python: the
    cost a caller pays, host overhead included (events bracket the calls)."""
    for _ in range(3):
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


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so host overhead is out of the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def max_err(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    require(torch.isfinite(got).all(), "non-finite kernel output")
    ok = bool((err <= tol + tol * want.abs()).all())
    return float(err.max()), ok


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def compare(kernel: str, name: str, got, want) -> float:
    """Every output of a kernel against its plain version's, each at its own
    dtype's tolerance; returns the largest error."""
    errs = [max_err(g, w, TOL[w.dtype]) for g, w in zip(got, want)]
    err, ok = max(e for e, _ in errs), all(o for _, o in errs)
    log(f"{kernel} {name}: max_abs_err={err:.3e} over {len(errs)} outputs "
        f"{'ok' if ok else 'FAIL'} ({', '.join(f'{e:.2e}' for e, _ in errs)})")
    require(ok, f"{kernel} disagrees with its plain version: {name}")
    return err


# --------------------------------------------------------------------------
# phase 3: bf16 GEMMs of the serving paths, split-K reduction precision
# --------------------------------------------------------------------------
SPLITK_SHAPES = [      # (model, GEMM, K, N, weight is a transposed [N, K])
    ("qwen3-0.6b", "q", 1024, 2048, False),
    ("qwen3-0.6b", "k / v", 1024, 1024, False),
    ("qwen3-0.6b", "o", 2048, 1024, False),
    ("qwen3-0.6b", "mlp gate / up", 1024, 3072, False),
    ("qwen3-0.6b", "mlp down", 3072, 1024, False),
    ("qwen3-0.6b", "lm head (tied)", 1024, 151936, True),
    ("xlstm-1.3b", "up_x / up_z", 2048, 4096, False),
    ("xlstm-1.3b", "down", 4096, 2048, False),
    ("xlstm-1.3b", "lm head (tied)", 2048, 50304, True),
]
SPLITK_ROWS = (1000, 4)          # prefill rows; decode rows at 4 slots
SPLITK_BMM = [   # (model, GEMM, batch, M, K, N): the weight a transposed
    # [E, N, K]; moonshot's expert products' backward at its microbatch
    ("moonshot-v1-16b-a3b", "dup @ w_up^T", 64, 120, 1408, 2048),
    ("moonshot-v1-16b-a3b", "dy @ w_down^T", 64, 120, 2048, 1408),
]


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps, each ulp taken at the larger of
    |want| and the RMS of want's row: an output that cancels to near 0 would
    otherwise count the fp32 rounding of its terms as thousands of ulps."""
    want = want.float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    scale = torch.maximum(want.abs(), rms).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def check_splitk(gen):
    """``torch.matmul`` on bf16 operands against their fp32 product rounded
    to bf16 (TF32 off, so that product is full fp32), with
    ``allow_bf16_reduced_precision_reduction`` at its default and False: a
    split-K GEMM that reduces its partials in bf16 is off by more than the
    one ulp that rounding the same fp32 sum in another order can give.
    Logs per shape the worst error in ulps, the share of outputs whose bits
    differ from the reference and the time at each setting, and whether the
    two settings gave the same bits; fails if the default setting is off by
    more than one ulp; returns the worst error in ulps at each setting."""
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    worst = {True: 0.0, False: 0.0}
    cases = []
    for model, name, K, N, tied in SPLITK_SHAPES:
        w = randn(gen, *((N, K) if tied else (K, N)),
                  dtype=torch.bfloat16, scale=1 / math.sqrt(K))
        w = w.T if tied else w
        cases += [(f"{model} {name} M={M} K={K} N={N}",
                   randn(gen, M, K, dtype=torch.bfloat16), w)
                  for M in SPLITK_ROWS]
    for model, name, E, M, K, N in SPLITK_BMM:
        w = randn(gen, E, N, K, dtype=torch.bfloat16,
                  scale=1 / math.sqrt(K)).transpose(1, 2)
        cases.append((f"{model} {name} E={E} M={M} K={K} N={N} (bmm)",
                      randn(gen, E, M, K, dtype=torch.bfloat16), w))
    try:
        for label, x, w in cases:
            want = (x.float() @ w.float()).to(torch.bfloat16)
            cells, outs = [], []
            for setting in (True, False):
                flags.allow_bf16_reduced_precision_reduction = setting
                got = torch.matmul(x, w)
                ulps = bf16_ulps(got, want)
                worst[setting] = max(worst[setting], ulps)
                outs.append(got)
                cells.append(
                    f"{setting}: {ulps:.2f} ulp, "
                    f"{float((got != want).float().mean()):.3%} differ, "
                    f"{device_ms(lambda: torch.matmul(x, w), 10):.4f} ms")
            log(f"splitk {label}: " + "; ".join(cells)
                + "; same bits at both settings: " + str(torch.equal(*outs)))
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    log(f"splitk: default allow_bf16_reduced_precision_reduction={default}; "
        f"worst error True {worst[True]:.2f} ulp, False {worst[False]:.2f} "
        f"ulp")
    # the port's matmul (models/common.py) relies on fp32 accumulation
    require(worst[default] <= 1, "bf16 GEMM off by more than one ulp of its "
            "fp32 product: reduced-precision split-K reduction")
    return worst


# --------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# --------------------------------------------------------------------------
FLASH_GRID = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
              (1, 256, 256, 8, 1, 32), (1, 128, 384, 4, 4, 64),
              (2, 384, 384, 2, 2, 128)]      # tests/test_kernels.py:36-42
PATH_T = (137, 512, 1000, 1291, 2048)        # prefill lengths; H=16 KV=8
RMS_ROWS = (4, 1000, 16000)
RMS_EXTRA = ((64, 128), (4, 100), (1000, 100))   # q_norm decode rows; tails
TRAIN_NORM_SHAPES = [  # rows, d: every norm of both training paths (fp32)
    (2048, 1024), (2048 * 16, 128), (2048 * 8, 128),   # full width, B.T=2048
    (256, 128), (256 * 4, 32), (256 * 2, 32)]         # sweep member, B.T=256
ZAMBA_FLASH = (1, 32, 32, 80)                # B, H, KV, hd of zamba2's prefill
ZAMBA_T = (137, 1000, 1291)                  # its prefill lengths here
ARCH_FLASH = (   # phase 5f's regimes (bf16, hd 128, causal): H, KV, T, window
    (40, 8, 1000, 0),            # qwen3-14b: GQA group 5
    (12, 2, 1000, 0),            # qwen2-1.5b: group 6
    (16, 16, 1000, 0),           # moonshot-v1-16b-a3b: no grouping
    (48, 8, 5000, 4096))         # mixtral-8x22b: a 4096-key window, T > W
ARCH_RMS_D = (1536, 5120, 6144)              # with 2048: phase 5f's d_model
ENC_LEN = 1500                               # whisper's encoder frames
CROSS_FLASH = ((1, 4), (2, 37), (4, 224))    # B, T: cross attention, S=1500
MODAL_FLASH = (   # phase 5g's timed regimes (bf16): B, T, S, H, KV, hd, causal
    (4, ENC_LEN, ENC_LEN, 12, 12, 64, False),   # whisper's encoder
    (1, 1000, 1000, 28, 4, 128, True))          # qwen2-vl: GQA group 7
MODAL_RMS = ((4 * ENC_LEN, 768), (1000, 3584))  # whisper's encoder rows, qwen2-vl
NEMO_FLASH = (   # phase 5h's regimes (hd 192, GQA 96:8, causal): B, T, S, q_offset
    (1, 1000, 1000, 0),          # a prefill (timed in bf16 and fp32)
    (1, 137, 137, 0),            # a ragged T
    (1, 1, 1100, 1099),          # decode-shaped: one row against S at q_offset
    (1, 4, 1100, 1096))          # the 4-slot decode: 4 rows of one 64-row block
NEMO_RMS = (1000, 18432)                     # nemotron's d_model, one prefill
REPORT_T = 1000                              # the JSON line's flash shape
REPORT_RMS = "rows=16000 d=128 bfloat16"     # q_norm rows at T=1000


def check_flash(gen):
    """Every case in fp32 (the CUDA-core kernel) and bf16 (the tensor-core
    kernel), then the bf16 prefill shapes of the serving path."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, KV, hd in FLASH_GRID:
            cases.append((B, T, S, H, KV, hd, dtype, True, 0, S - T))
        for window in (64, 128, 256):
            cases.append((1, 256, 256, 4, 4, 64, dtype, True, window, 0))
        cases += [(2, 128, 128, 2, 2, 64, dtype, False, 0, 0),
                  (1, 1, 77, 4, 2, 32, dtype, True, 0, 76),
                  (1, 37, 100, 4, 2, 64, dtype, True, 0, 63)]
    for T in PATH_T:
        cases.append((1, T, T, 16, 8, 128, torch.bfloat16, True, 0, 0))
    for H, KV, T, window in ARCH_FLASH:
        cases.append((1, T, T, H, KV, 128, torch.bfloat16, True, window, 0))
    B, H, KV, hd = ZAMBA_FLASH
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(B, T, T, H, KV, hd, dtype, True, 0, 0)
                  for T in ZAMBA_T]
        cases += [(2, 128, 128, 4, 2, hd, dtype, True, 0, 0),
                  (1, 256, 256, 4, 4, hd, dtype, True, 64, 0),
                  (2, 128, 128, 2, 2, hd, dtype, False, 0, 0),
                  (1, 1, 77, 4, 2, hd, dtype, True, 0, 76)]
    path = {}
    for B, T, S, H, KV, hd, dtype, causal, window, off in cases:
        q, k, v, got, err, name = hold_flash(gen, B, T, S, H, KV, hd, dtype,
                                             causal, window, off)
        if (H, KV, T, window) in ARCH_FLASH and dtype == torch.bfloat16:
            check_flash_rows(q, k, v, got, name, window)
            path[H, KV, T, window] = time_flash(q, k, v, err, window)
        elif (B, H, KV, hd, dtype) == (1, 16, 8, 128, torch.bfloat16) \
                and T == S and causal and off == 0 and window == 0:
            check_flash_rows(q, k, v, got, name)
            path[T] = time_flash(q, k, v, err)
        if (B, H, KV, hd) == ZAMBA_FLASH and T in ZAMBA_T:
            if dtype == torch.bfloat16:
                check_flash_rows(q, k, v, got, name)
                path[hd, T] = time_flash(q, k, v, err)
            else:
                path[hd, T, "fp32"] = time_flash_fwd(q, k, v, err)
    return path


def hold_flash(gen, B, T, S, H, KV, hd, dtype, causal, window=0, off=0):
    """One case drawn from ``gen``, the kernel held against its plain
    version; returns (q, k, v, got, err, name)."""
    q = randn(gen, B, T, H, hd, dtype=dtype)
    k = randn(gen, B, S, KV, hd, dtype=dtype)
    v = randn(gen, B, S, KV, hd, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(got, flash_attention_ref(q, k, v, **kw), TOL[dtype])
    name = (f"B={B} T={T} S={S} H={H} KV={KV} hd={hd} "
            f"{str(dtype)[6:]} causal={causal} window={window} "
            f"q_offset={off}")
    log(f"flash_attention {name}: max_abs_err={err:.3e} "
        f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    require(ok, f"flash_attention disagrees with its plain version: {name}")
    return q, k, v, got, err, name


def row_rel_err(got, want) -> float:
    """The largest error in any (batch, position, head) row of ``got``,
    relative to the RMS of that row of ``want``."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=-1) / rms).max())


def check_flash_rows(q, k, v, got, name, window: int = 0,
                     causal: bool = True, q_offset: int = 0):
    """At a prefill shape, where outputs are ~0.05 and 2e-2 absolute would
    pass a kernel that dropped a KV tile: the bf16 kernel's error per row
    against the plain version in fp32 (same bf16 inputs), relative to the
    row's RMS, within twice the plain version's own bf16 rounding of the
    same rows. A plain run without the first 64 keys of the last rows (with
    a window: the oldest 64 keys of every full window; non-causal, or
    causal at a q_offset: the first 64 keys of every row) must fail the
    same limit, or the check could not see a missing tile."""
    T = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    want = plain_attention(qf, kf, vf, causal=causal, window=window,
                           q_offset=q_offset)
    limit = 2 * row_rel_err(want.to(torch.bfloat16), want)
    err = row_rel_err(got, want)
    if causal and q_offset:
        short = plain_attention(qf, kf[:, 64:], vf[:, 64:],
                                q_offset=q_offset - 64)
    elif causal:
        short = plain_attention(qf, kf, vf, window=(window or T) - 64)
    else:
        short = plain_attention(qf, kf[:, 64:], vf[:, 64:], causal=False)
    dropped = row_rel_err(short.to(torch.bfloat16), want)
    ok = err <= limit < dropped
    log(f"  per row {name}: max |err| / row RMS {err:.3e}, limit {limit:.3e} "
        f"(2x the bf16 rounding of the fp32 result), first tile dropped "
        f"{dropped:.3e} {'ok' if ok else 'FAIL'}")
    require(err <= limit, f"flash_attention rows off the fp32 result: {name}")
    require(dropped > limit, f"per-row check cannot see a dropped tile: {name}")


def time_flash(q, k, v, err, window: int = 0, causal: bool = True):
    """Causal with T == S, or non-causal at any T and S: the kernel, its
    plain version, SDPA (with a window: on the window's boolean mask, k and
    v repeated to every head) and the bound over the visible (t, s)
    pairs."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    fwd = work.flash_fwd(B, T, S, H, KV, hd, q.element_size(), causal,
                         window)
    flops, bound = fwd.flops, fwd.bound()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        mask = visible(T, S, 0, True, window, q.device)
        kt, vt = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask)
    else:
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernel = lambda: flash_attention(q, k, v, causal=causal, window=window)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 20),
        "plain_ms": device_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), 5),
        "library_ms": device_ms(library, 20),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": (f"B={B} " + (f"T=S={T}" if T == S else f"T={T} S={S}")
                  + f" H={H} KV={KV} hd={hd} bf16 "
                  + ("causal" if causal else "non-causal")
                  + (f" window={window}" if window else "")),
    }
    log(f"  device time {row['shape']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel / sdpa "
        f"{row['ms'] / row['library_ms']:.3f}, {row['bound_ms'] / row['ms']:.1%} "
        f"of the bound, {flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from "
        f"Python {host_ms(kernel, 20):.4f} ms")
    return row


def rmsnorm_cases(gen, dtype):
    """(name, x, g): the grid, the q_norm decode rows, tails of d = 100,
    phase 5f's widths (1000 rows at d = 1536, 5120 and 6144; 2048 is in the
    grid), in fp32 the training paths' norm shapes, and two contiguous
    views off 16-byte alignment: ``x[1:]`` of a [1001, 100]
    tensor (200 bytes in: the scalar path in bf16; 400 bytes, aligned, in
    fp32) and rows of 1024 starting one element into a flat buffer (the
    scalar path in both dtypes, a row too wide to hold: streamed)."""
    shapes = [(rows, d) for rows in RMS_ROWS for d in (128, 1024, 2048)]
    shapes += list(RMS_EXTRA) + [(1000, d) for d in ARCH_RMS_D]
    if dtype == torch.float32:
        shapes += TRAIN_NORM_SHAPES
    for rows, d in shapes:
        x = randn(gen, rows, d, dtype=dtype)
        g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
        yield f"rows={rows} d={d} {str(dtype)[6:]}", x, g
    table = randn(gen, 1001, 100, dtype=dtype)
    flat = randn(gen, 1000 * 1024 + 1, dtype=dtype)
    for base, view in ((table, table[1:]), (flat, flat[1:].view(1000, 1024))):
        d = view.shape[-1]
        g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
        require(view.is_contiguous())
        yield (f"rows=1000 d={d} {str(dtype)[6:]} view at byte offset "
               f"{view.data_ptr() - base.data_ptr()}"), view, g


def check_rmsnorm(gen):
    path = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, x, g in rmsnorm_cases(gen, dtype):
            err = hold_rmsnorm(name, x, g)
            if dtype == torch.bfloat16:
                path[name] = time_rmsnorm(name, x, g, err)
    return path


def hold_rmsnorm(name, x, g) -> float:
    """The kernel against its plain version (the path it took logged)."""
    got = rmsnorm(x, g, eps=1e-6)
    torch.cuda.synchronize()
    err, ok = max_err(got, rmsnorm_ref(x, g, eps=1e-6), TOL[x.dtype])
    vec, group, held = rmsnorm_plan(
        x.data_ptr() | g.data_ptr() | got.data_ptr(), x.shape[-1],
        x.element_size())
    log(f"rmsnorm {name}: path vec={vec} group={group} "
        f"{'held' if held else 'streamed'} "
        f"max_abs_err={err:.3e} tol={TOL[x.dtype]:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"rmsnorm disagrees with its plain version: {name}")
    return err


def time_rmsnorm(name, x, g, err):
    rows, d = x.shape
    fwd = work.rmsnorm(rows, d, x.element_size())
    nbytes, bound = fwd.bytes, fwd.bound()
    kernel = lambda: rmsnorm(x, g, eps=1e-6)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(lambda: rmsnorm_ref(x, g, eps=1e-6), 50),
        "library_ms": device_ms(lambda: F.rms_norm(x, (d,), g, 1e-6), 50),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": name,
    }
    log(f"  device time {name}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); kernel / "
        f"F.rms_norm {row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound, moves "
        f"{nbytes / row['ms'] / 1e6:.1f} GB/s; one call from Python "
        f"{host_ms(kernel, 50):.4f} ms")
    return row


def check_modal_kernels(gen):
    """Phase 5g's regimes, on a generator of their own (the earlier cases
    keep their draws): flash non-causal with S != T in both dtypes,
    whisper's cross attention at (B, T) of ``CROSS_FLASH`` against its
    1500 frames (H = KV = 12, hd 64; a ragged last key tile, T < 64 in one
    query tile), each held against the plain version and in bf16 per row;
    ``MODAL_FLASH`` in bf16, held, held per row and timed; rmsnorm at
    ``MODAL_RMS`` in both dtypes, timed in bf16. Returns the timed flash
    and rmsnorm rows."""
    cases = [(B, T, ENC_LEN, 12, 12, 64, dtype, False)
             for dtype in (torch.float32, torch.bfloat16)
             for B, T in CROSS_FLASH]
    cases += [(*shape, torch.bfloat16, causal)
              for *shape, causal in MODAL_FLASH]
    flash_rows, rms_rows = [], []
    for B, T, S, H, KV, hd, dtype, causal in cases:
        q, k, v, got, err, name = hold_flash(gen, B, T, S, H, KV, hd, dtype,
                                             causal)
        if dtype == torch.bfloat16:
            check_flash_rows(q, k, v, got, name, causal=causal)
            if (B, T, S, H, KV, hd, causal) in MODAL_FLASH:
                flash_rows.append(time_flash(q, k, v, err, causal=causal))
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in MODAL_RMS:
            x = randn(gen, n, d, dtype=dtype)
            g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
            name = f"rows={n} d={d} {str(dtype)[6:]}"
            err = hold_rmsnorm(name, x, g)
            if dtype == torch.bfloat16:
                rms_rows.append(time_rmsnorm(name, x, g, err))
    return flash_rows, rms_rows


def check_nemotron_kernels(gen):
    """Phase 5h's regimes, on a generator of their own: flash at hd 192
    with nemotron's GQA 96:8, causal, at ``NEMO_FLASH`` (a prefill, a
    ragged T and two decode shapes against S at a q_offset) in both
    dtypes, each held against the plain version and in bf16 per row and
    called twice for the same bits; the prefill timed in bf16 (the
    tensor-core kernel, beside SDPA) and in fp32 (the CUDA-core kernel,
    which the streamed fp32 check of phase 5h runs); the backward at hd 192 must raise NotImplementedError on the
    card; rmsnorm at ``NEMO_RMS`` in both dtypes, timed in bf16. Returns
    the timed bf16 flash, fp32 flash and rmsnorm rows."""
    H, KV, hd = 96, 8, 192
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, off in NEMO_FLASH:
            q, k, v, got, err, name = hold_flash(gen, B, T, S, H, KV, hd,
                                                 dtype, True, 0, off)
            if dtype == torch.bfloat16:
                check_flash_rows(q, k, v, got, name, q_offset=off)
            again = flash_attention(q, k, v, causal=True, q_offset=off)
            require(torch.equal(got, again),
                    f"two flash_attention calls differ: {name}")
            if T == S == REPORT_T:
                rows[dtype] = (time_flash(q, k, v, err)
                               if dtype == torch.bfloat16
                               else time_flash_fwd(q, k, v, err))
    o = torch.zeros_like(q)
    lse = torch.zeros(B, H, T, dtype=torch.float32, device="cuda")
    try:
        flash_attention_bwd(q, k, v, o, lse, o)
        raised = False
    except NotImplementedError as e:
        raised = True
        log(f"flash_attention_bwd at hd {hd}: raises ({e})")
    require(raised, "the flash backward at hd 192 did not raise")
    n, d = NEMO_RMS
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(gen, n, d, dtype=dtype)
        g = (1 + 0.1 * randn(gen, d, dtype=torch.float32)).to(dtype)
        name = f"rows={n} d={d} {str(dtype)[6:]}"
        err = hold_rmsnorm(name, x, g)
        if dtype == torch.bfloat16:
            rms_row = time_rmsnorm(name, x, g, err)
    return rows[torch.bfloat16], rows[torch.float32], rms_row


# --------------------------------------------------------------------------
# phase 4, backward: the member step's gradient kernels
# --------------------------------------------------------------------------
GRAD_TOL = 1e-4       # fp32, of each gradient's largest magnitude
FLASH_BWD_CASES = [   # B, T, S, H, KV, hd, window, q_offset
    *[(B, T, T, 4, 2, 32, 0, 0)            # the sweep member's heads
      for B, T in ((8, 32), (2, 137), (4, 512), (3, 1000))],
    *[(B, T, T, 16, 8, 128, 0, 0)          # qwen3-0.6b at full width
      for B, T in ((8, 32), (2, 137), (4, 512), (3, 1000))],
    (1, 100, 300, 16, 8, 128, 0, 200),     # q_offset > 0
    (2, 512, 512, 4, 2, 32, 128, 0),       # window
    (2, 200, 200, 8, 2, 64, 0, 0),         # hd 64, GQA group 4
]
FLASH_BWD_REPORT = (4, 512, 16, 8, 128)    # B, T, H, KV, hd: the member step
FLASH_BWD_REPEAT = ((4, 512, 16, 8, 128), (2, 137, 16, 8, 128))  # bit-identical
FLASH_FWD_TIMED = ((3, 1000, 16, 8, 128), (8, 32, 4, 2, 32))  # + the report
LSE_TOL = 1e-5        # the fp32 forward's lse, as |err| <= tol + tol * |want|
RMS_BWD_REPORT = "rows=2048 d=1024"                    # ln1 / ln2 / final


def grad_device_ms(forward, inputs, grad, iters: int) -> float:
    """Mean device time of one ``torch.autograd.grad`` through
    ``forward(*inputs)`` (a library's backward): the forward runs once on
    the capture stream, since autograd runs each node's backward on its
    forward's stream, then ``iters`` backward calls are captured in one
    CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*inputs)
        for _ in range(3):
            torch.autograd.grad(out, inputs, grad, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            torch.autograd.grad(out, inputs, grad, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def check_grads(kernel: str, name: str, got, want, tol: float = GRAD_TOL):
    """Each gradient against autograd's through the plain version, within
    ``tol`` of that tensor's largest magnitude (fp32 sums of up to a few
    thousand terms in another order stay ~100x inside it; a dropped key tile
    or row is off by a large share of it). Returns the largest such error."""
    errs = []
    for g, w in zip(got, want):
        require(g.shape == w.shape and torch.isfinite(g).all(),
                f"{kernel}: gradient of shape {tuple(g.shape)} not finite or "
                f"not {tuple(w.shape)}: {name}")
        scale = float(w.float().abs().max())
        errs.append(float((g.float() - w.float()).abs().max()) / max(scale,
                                                                     1e-30))
    ok = max(errs) <= tol
    log(f"{kernel} {name}: max |err| / max |grad| "
        f"{', '.join(f'{e:.2e}' for e in errs)}, tol {tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{kernel} disagrees with autograd of its plain version: "
            f"{name}")
    return max(errs)


def flash_grads(q, k, v, do, attend, **kw):
    """(out, dq, dk, dv) through ``attend`` (the kernel's Function or the
    plain version) with fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = attend(*leaves, **kw)
    return (out.detach(), *torch.autograd.grad(out, leaves, do))


def check_flash_bwd(gen):
    """The fp32 forward with lse and the backward kernels against autograd
    of the plain version (fp32 on the card); a run without the first key
    tile must fail. Returns the timed rows of the backward and of the fp32
    forward at the member step's shape."""
    rows = None
    for B, T, S, H, KV, hd, window, off in FLASH_BWD_CASES:
        q, do = (randn(gen, B, T, H, hd) for _ in range(2))
        k, v = (randn(gen, B, S, KV, hd) for _ in range(2))
        kw = dict(causal=True, window=window, q_offset=off)
        out, *got = flash_grads(q, k, v, do, flash_attention, **kw)
        torch.cuda.synchronize()
        ref_out, *want = flash_grads(q, k, v, do, flash_attention_ref, **kw)
        name = (f"B={B} T={T} S={S} H={H} KV={KV} hd={hd} fp32 causal "
                f"window={window} q_offset={off}")
        fwd_err = compare("flash_attention", f"{name}, forward with lse",
                          (out,), (ref_out,))
        check_flash_lse(q, k, v, kw, name)
        err = check_grads("flash_attention_bwd", name, got, want)
        if (B, T, H, KV, hd) in FLASH_BWD_REPEAT:
            check_flash_bwd_repeats(q, k, v, do, name)
        if (B, T, H, KV, hd) in FLASH_FWD_TIMED:
            time_flash_fwd(q, k, v, fwd_err)
        if (B, T, H, KV, hd) == FLASH_BWD_REPORT:
            check_flash_fwd_repeats(q, k, v, name)
            rows = time_flash_bwd(q, k, v, do, err, fwd_err)
        if (B, T, hd, window, off) == (2, 137, 128, 0, 0):
            check_flash_bwd_dropped_tile(q, k, v, do, want)
    return rows


def check_flash_lse(q, k, v, kw, name):
    """The forward's lse against the plain version's: rows with a visible
    key within ``LSE_TOL``, the rows without one +inf in both. In bf16 at a
    head dim the backward takes, the forward also writes its output's
    rounding residual o_lo, which must be finite and within half a bf16
    unit of each output element (2^-8 of it, the residual's own rounding
    allowed for). Returns the number of +inf rows."""
    out, got, out_lo = flash_forward(q, k, v, kw["causal"], kw["window"],
                                     kw["q_offset"], with_lse=True)
    if out_lo is not None:
        lo, hi = out_lo.float().abs(), out.float().abs()
        ok = bool(torch.isfinite(lo).all()) and bool(
            (lo <= 2.0 ** -8 * (1 + 2.0 ** -7) * hi).all())
        log(f"flash_attention {name}, the output's rounding residual: "
            f"largest |o_lo| / |o| {float((lo / hi.clamp_min(1e-30)).max()):.3e} "
            f"(bound {2.0 ** -8 * (1 + 2.0 ** -7):.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_attention's o_lo is not o's rounding residual: "
                f"{name}")
    _, want = flash_attention_ref(q, k, v, with_lse=True, **kw)
    inf = torch.isinf(want)
    same_inf = torch.equal(got[inf], want[inf])
    finite = got[~inf]
    err = (finite - want[~inf]).abs()
    ok = (same_inf and bool(torch.isfinite(finite).all())
          and bool((err <= LSE_TOL + LSE_TOL * want[~inf].abs()).all()))
    log(f"flash_attention {name}, lse: max_abs_err="
        f"{float(err.max()) if err.numel() else 0.0:.3e} over "
        f"{finite.numel()} rows, {int(inf.sum())} +inf rows "
        f"{'identical' if same_inf else 'DIFFER'}, tol {LSE_TOL:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"flash_attention lse disagrees with the plain lse: {name}")
    return int(inf.sum())


def check_flash_fwd_repeats(q, k, v, name, causal=True, window=0,
                            q_offset=0):
    """Two calls of the forward with lse on the same inputs give the same
    bits in the output, the lse and (bf16) the output's rounding residual
    (every sum runs in a fixed order)."""
    first, second = (flash_forward(q, k, v, causal, window, q_offset,
                                   with_lse=True) for _ in range(2))
    same = [a is b is None or torch.equal(a, b)
            for a, b in zip(first, second)]
    log(f"flash_attention {name}: two forward calls bit-identical in out, "
        f"lse, o_lo: {same}")
    require(all(same), f"the flash forward is not deterministic: {name}")


def check_flash_bwd_repeats(q, k, v, do, name):
    """Two calls of the backward kernels on the same inputs give the same
    bits: every gradient element is summed in a fixed order (in bf16 with
    the forward's rounding residual, as training calls them)."""
    o, lse, o_lo = flash_attention_ref(q, k, v, with_lse=True,
                                       with_residual=True)
    o = o.contiguous()
    o_lo = o_lo.contiguous() if q.dtype == torch.bfloat16 else None
    first = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo)
    second = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"flash_attention_bwd {name}: two calls bit-identical in dq, dk, dv: "
        f"{same}")
    require(all(same), f"flash_attention_bwd is not deterministic: {name}")


def device_ms_by_kernel(fn, iters: int, kept: dict | None = None) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name, from a
    profiler trace of ``iters`` calls after three warm-up calls: each
    name's mean per launch times its launches per call. The trace can miss
    the first calls' launches (it once kept 11 of 20), so a name's total
    over ``iters`` would undercount; a missed launch is logged. ``kept``,
    where given, gets each name's launches in the trace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times, missed = Counter(), {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            per_call = max(1, round(e.count / iters))
            if e.count != per_call * iters:
                missed[e.key[:60]] = f"{e.count} of {per_call * iters}"
            if kept is not None:
                kept[e.key] = kept.get(e.key, 0) + e.count
            times[e.key] += e.self_device_time_total / 1e3 / e.count * per_call
    if missed:
        log(f"  the trace kept fewer launches than were made: {missed}")
    return times


def check_flash_bwd_dropped_tile(q, k, v, do, want):
    """The kernels run without the first 64 keys (k, v from key 64 on at
    q_offset -64: rows 0..63 see no key) must fail ``check_grads``."""
    T = q.shape[1]
    k64, v64 = k[:, 64:].contiguous(), v[:, 64:].contiguous()
    kw = dict(causal=True, window=0, q_offset=-64)
    n_inf = check_flash_lse(q, k64, v64, kw, f"T={T}, first key tile "
                            "dropped, q_offset -64")
    require(n_inf == q.shape[0] * q.shape[2] * 64,
            "the rows without a visible key are not the first 64")
    _, dq, dk, dv = flash_grads(q, k64, v64, do, flash_attention,
                                q_offset=-64)
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 64, 0))
    try:
        check_grads("flash_attention_bwd", f"T={T}, first key tile dropped",
                    (dq, pad(dk), pad(dv)), want)
    except RuntimeError:
        log(f"flash_attention_bwd T={T}: the run without the first key tile "
            "fails the check, as it must")
    else:
        require(False, "the gradient check cannot see a dropped key tile")


def time_flash_bwd(q, k, v, do, err, fwd_err):
    B, T, H, hd = q.shape
    KV = k.shape[2]
    o, lse = flash_attention_ref(q, k, v, with_lse=True)
    o = o.contiguous()
    bwd = work.flash_bwd(B, T, T, H, KV, hd, q.element_size())
    flops, bound = bwd.flops, bwd.bound()
    kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 5),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse,
                                                              do), 2),
        "library_ms": grad_device_ms(sdpa, (qt, kt, vt), do.transpose(1, 2),
                                     5),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T=S={T} H={H} KV={KV} hd={hd} fp32 causal",
    }
    by_name = device_ms_by_kernel(kernel, 20)
    row["split_ms"] = {part: sum(ms for key, ms in by_name.items()
                                 if f"flash_bwd_{part}_kernel" in key)
                       for part in ("delta", "dkdv", "dq")}
    # 4 tile products per visible tile pair in dk/dv, 3 in dq
    tile_flops = work.flash_tile_flops(B, H, hd,
                                       work.visible_tiles(T, T, True, 0))
    split = row["split_ms"]
    log(f"  backward kernels apart, device ms per call (profiler, 20 calls): "
        f"delta {split['delta']:.4f}, dk/dv {split['dkdv']:.4f} "
        f"({4 * tile_flops / split['dkdv'] / 1e9:.1f} TFLOP/s on its tile "
        f"products), dq {split['dq']:.4f} "
        f"({3 * tile_flops / split['dq'] / 1e9:.1f} TFLOP/s); sum "
        f"{sum(split.values()):.4f}; all kernels of the call "
        f"{sum(by_name.values()):.4f}")
    require(all(ms > 0 for ms in split.values()),
            f"a backward kernel is missing from the trace: {dict(by_name)}")
    fwd = time_flash_fwd(q, k, v, fwd_err)
    log(f"  device time {row['shape']}: backward kernels {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, SDPA backward (fp32, GQA) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); {row['bound_ms'] / row['ms']:.1%} of the "
        f"bound, {flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from Python "
        f"{host_ms(kernel, 5):.4f} ms")
    return row, fwd


def time_flash_fwd(q, k, v, err):
    """The fp32 forward (CUDA cores) beside its bound, its plain version and
    SDPA's forward (fp32, GQA, on inputs that require grad, as in training);
    logs its rate on the tile products and the kernel's occupancy."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    bound = work.flash_fwd(B, T, T, H, KV, hd, q.element_size()).bound()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    row = {
        "max_abs_err": err,
        "ms": device_ms(lambda: flash_attention(q, k, v), 5),
        "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v), 2),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T=S={T} H={H} KV={KV} hd={hd} fp32 causal",
    }
    # two tile products per visible tile pair: S and P V
    row["tile_tflops"] = (2 * work.flash_tile_flops(
        B, H, hd, work.visible_tiles(T, T, True, 0)) / row["ms"] / 1e9)
    occ = fwd_occupancy(hd)
    log(f"  device time {row['shape']}: forward (fp32, CUDA cores) "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA (fp32, "
        f"GQA) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); kernel / SDPA "
        f"{row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound, "
        f"{row['tile_tflops']:.1f} TFLOP/s on its tile products; "
        f"{occ['smem_bytes']} bytes of shared memory, "
        f"{occ['blocks_per_sm']} block(s) of 16 warps per SM")
    return row


def rmsnorm_bwd_cases(gen):
    """(name, x, g, dy): every training norm's shape, then a view 4 bytes
    off 16-byte alignment (the scalar path)."""
    for rows, d in TRAIN_NORM_SHAPES:
        yield (f"rows={rows} d={d}", randn(gen, rows, d),
               1 + 0.1 * randn(gen, d), randn(gen, rows, d))
    flat = randn(gen, 1000 * 128 + 1)
    yield ("rows=1000 d=128 view at byte offset 4", flat[1:].view(1000, 128),
           1 + 0.1 * randn(gen, 128), randn(gen, 1000, 128))


def check_rmsnorm_bwd(gen):
    path = {}
    for name, x, g, dy in rmsnorm_bwd_cases(gen):
        d = x.shape[-1]
        vec, group, _ = rmsnorm_plan(x.data_ptr() | g.data_ptr()
                                     | dy.data_ptr(), d, 4)
        got = rmsnorm_bwd(x, g, dy, eps=1e-6)
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_(True) for t in (x, g)]
        want = torch.autograd.grad(rmsnorm_ref(*leaves, eps=1e-6), leaves, dy)
        err = check_grads("rmsnorm_bwd", f"{name} fp32 (vec={vec} "
                          f"group={group})", got, want)
        path[name] = time_rmsnorm_bwd(name, x, g, dy, err)
    return path


def time_rmsnorm_bwd(name, x, g, dy, err):
    rows, d = x.shape
    bwd = work.rmsnorm_bwd(rows, d, x.element_size())
    nbytes, bound = bwd.bytes, bwd.bound()
    kernel = lambda: rmsnorm_bwd(x, g, dy, eps=1e-6)
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(lambda: rmsnorm_bwd_ref(x, g, dy, eps=1e-6),
                              20),
        "library_ms": grad_device_ms(
            lambda x_, g_: F.rms_norm(x_, (d,), g_, 1e-6), (xl, gl), dy, 50),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": name if "bfloat16" in name else f"{name} fp32",
    }
    log(f"  device time {name}: backward kernels {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, F.rms_norm backward "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); kernel / F.rms_norm "
        f"{row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the "
        f"bound, moves {nbytes / row['ms'] / 1e6:.1f} GB/s; one call from "
        f"Python {host_ms(kernel, 50):.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 4, backward in bf16: the trainer's gradient kernels
# --------------------------------------------------------------------------
FLASH_BWD_BF16_CASES = [   # B, T, S, H, KV, hd, window, q_offset, causal
    (4, 512, 512, 16, 8, 128, 0, 0, True),    # the trainer's microbatch
    (2, 137, 137, 16, 8, 128, 64, 0, True),   # ragged T with a window
    (8, 64, 64, 4, 2, 32, 0, 0, True),        # launch/train's reduced config
    (2, 200, 200, 8, 2, 64, 0, 0, True),      # hd 64, GQA group 4
    (1, 100, 300, 16, 8, 128, 0, 200, True),  # q_offset > 0
    (2, 150, 200, 8, 4, 64, 32, 0, False),    # non-causal, a window, S > T
]
FLASH_BWD_BF16_DROPPED = (2, 137, 128)   # B, T, hd: dropped-tile check
BF16_BWD_KERNELS = {"delta": "flash_bwd_delta_kernel",   # flash_attention_
                    "dkdv": "flash_bwd_dkdv_sm90_kernel",  # bwd_sm90.cu
                    "dq": "flash_bwd_dq_sm90_kernel"}
FWD_LSE_TIMED = ((1, 1000, 16, 8, 128), (4, 512, 16, 8, 128))  # prefill, train
RMS_BWD_BF16_REPORT = "rows=2048 d=1024 bfloat16"
RMS_BWD_BF16_STEP = {   # a Trainer step's launches at each shape, B.T = 2048
    RMS_BWD_BF16_REPORT: 2 * (2 * QWEN_LAYERS + 1),          # ln1, ln2, final
    "rows=32768 d=128 bfloat16": 2 * QWEN_LAYERS,           # q_norm, 16 heads
    "rows=16384 d=128 bfloat16": 2 * QWEN_LAYERS}           # k_norm, 8 heads
RMS_BWD_BF16_WIDE = (2048, 5120)   # qwen3-14b's d_model


def grad_row_rms(want):
    """Each row's RMS (the last dim), or a thousandth of the whole tensor's
    RMS where the row's is smaller (a row whose true gradient is 0, such as
    dq of a query that sees one key, has no relative error to speak of)."""
    want = want.float()
    rms = want.pow(2).mean(dim=-1).sqrt()
    return rms.clamp_min(1e-3 * float(want.pow(2).mean().sqrt()) + 1e-30)


def grad_row_rel_err(got, want) -> float:
    """``row_rel_err`` for gradients: the largest of the rows' errors, each
    relative to its row's ``grad_row_rms``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(dim=-1) / grad_row_rms(want)).max())


def bf16_rows_ok(kernel, name, got, want32):
    """Each bf16 output against the fp32 result of the same inputs, per row
    (the last dim) relative to the row's RMS (``grad_row_rel_err``), within
    twice the plain version's own bf16 rounding of the same rows, as
    ``check_flash_rows`` holds the forward. Returns (largest ratio of error
    to limit, max abs error against the plain version's bf16 result)."""
    worst, abs_err, parts = 0.0, 0.0, []
    for i, (g, w) in enumerate(zip(got, want32)):
        require(g.dtype == torch.bfloat16 and g.shape == w.shape
                and bool(torch.isfinite(g).all()),
                f"{kernel}: output {i} not finite bf16 {tuple(w.shape)}: {name}")
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() > 1 else w[None]
        g2 = g.reshape(w2.shape)
        limit = 2 * grad_row_rel_err(w2.to(torch.bfloat16), w2)
        err = grad_row_rel_err(g2, w2)
        worst = max(worst, err / max(limit, 1e-30))
        abs_err = max(abs_err, float((g.float() - w.to(torch.bfloat16).float())
                                     .abs().max()))
        parts.append(f"{err:.3e}/{limit:.3e}")
    ok = worst <= 1.0
    log(f"{kernel} {name}: per row |err| / row RMS vs limit (2x the bf16 "
        f"rounding of the fp32 result) {', '.join(parts)}; max_abs_err vs the "
        f"plain bf16 result {abs_err:.3e} {'ok' if ok else 'FAIL'}")
    return worst, abs_err


BF16_ULP = 2.0 ** -7     # one unit in bf16's last place, relative: 8 bits


def flash_bwd_operand_bounds(q, k, v, o, lse, do, o_lo=None, d_err=None,
                             **kw):
    """Per element of (dq, dk, dv), fp32: u scale (|dS| |K|), u scale
    (|dS|^T |Q|) and u (|P|^T |dO|) with u = ``BF16_ULP``, from the plain
    backward's fp32 P and dS on these inputs (``bwd_operands``), dk and dv
    summed over each KV head's query heads: what rounding each element of
    P and dS to bf16 once, to either neighbour, can move each gradient
    element (``flash_bwd_rows_ok``). ``d_err`` [B,H,T], where given, is an
    error allowed in each row's D (and in each dP of the row): it moves dS
    by up to P d_err, which adds scale (P d_err) |K| to dq and scale
    (P d_err)^T |Q| to dk."""
    qf, kf, dof, p, ds, scale = bwd_operands(q, k, v, o, lse, do, o_lo=o_lo,
                                             **kw)
    p, ds = p.abs(), ds.abs() * BF16_ULP
    if d_err is not None:
        ds = ds + p * d_err[..., None]
    dq = torch.matmul(ds, kf.abs()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof.abs()) * BF16_ULP
    KV = k.shape[2]
    return dq.transpose(1, 2), per_kv_head(dk, KV), per_kv_head(dv, KV)


def flash_bwd_rows_ok(kernel, name, got, want32, bounds):
    """The bf16 flash backward's (dq, dk, dv) against the fp32 result of the
    plain version on the same inputs, per row (the last dim) relative to the
    row's RMS as ``bf16_rows_ok``, each row within a limit of its own: twice
    the bf16 rounding of the fp32 result (``bf16_rows_ok``'s limit) plus
    what the kernels' rounding of their tensor-core operands can move that
    row (``bounds``, from ``flash_bwd_operand_bounds`` on the same call's
    inputs).

    The derivation. The kernels round P to bf16 before dv = P^T dO, and dS
    before dq = scale dS K and dk = scale dS^T Q, and sum each product in
    fp32. Rounding a value x to bf16 moves it by less than one unit in its
    last place, at most u |x| with u = 2^-7 (8 significant bits): a whole
    unit, not the half of rounding to nearest, because the kernels' fp32 P
    and dS may differ from the plain version's in their last bits and round
    to the other neighbour. Each output element is a sum of such products,
    so it moves by at most u times the sum of its terms' magnitudes: u
    (|P|^T |dO|) in dv, u scale (|dS| |K|) in dq, u scale (|dS|^T |Q|) in
    dk, summed over a KV head's query heads as dk and dv are. A row's share
    is its largest element over the row's RMS (``grad_row_rms``), the
    measure ``grad_row_rel_err`` takes of an error. That bound does not
    cover the rounding of the output itself, nor sums taken in another
    order: the first term, unchanged, does. Returns (largest ratio of a
    row's error to its limit, max abs error against the plain version's
    bf16 result)."""
    worst, abs_err, parts = 0.0, 0.0, []
    for i, (g, w, e) in enumerate(zip(got, want32, bounds)):
        require(g.dtype == torch.bfloat16 and g.shape == w.shape
                and bool(torch.isfinite(g).all()),
                f"{kernel}: output {i} not finite bf16 {tuple(w.shape)}: {name}")
        w2 = w.float().reshape(-1, w.shape[-1])
        g2, e2 = g.float().reshape(w2.shape), e.float().reshape(w2.shape)
        rms = grad_row_rms(w2)
        rounding = 2 * grad_row_rel_err(w2.to(torch.bfloat16), w2)
        limit = rounding + e2.amax(dim=-1) / rms
        err = (g2 - w2).abs().amax(dim=-1) / rms
        ratio = float((err / limit).max())
        worst = max(worst, ratio)
        abs_err = max(abs_err, float((g.float() - w.to(torch.bfloat16).float())
                                     .abs().max()))
        parts.append(f"{float(err.max()):.3e} ({ratio:.3f}x; rounding "
                     f"{rounding:.3e}, operands up to "
                     f"{float((e2.amax(dim=-1) / rms).max()):.3e})")
    ok = worst <= 1.0
    log(f"{kernel} {name}: per row |err| / row RMS, worst share of the row's "
        f"limit (2x the bf16 rounding of the fp32 result + the bound of the "
        f"bf16 P and dS), dq dk dv: {', '.join(parts)}; max_abs_err vs the "
        f"plain bf16 result {abs_err:.3e} {'ok' if ok else 'FAIL'}")
    return worst, abs_err


def flash_bwd_bf16_inputs(gen, B, T, S, H, KV, hd, kw):
    """bf16 q, k, v, do, and the plain forward's bf16 o, fp32 lse and bf16
    rounding residual o_lo (the backward's D reads o + o_lo, as in
    training)."""
    q, do = (randn(gen, B, T, H, hd, dtype=torch.bfloat16) for _ in range(2))
    k, v = (randn(gen, B, S, KV, hd, dtype=torch.bfloat16) for _ in range(2))
    o, lse, o_lo = flash_attention_ref(q, k, v, with_lse=True,
                                       with_residual=True, **kw)
    return q, k, v, do, o.contiguous(), lse, o_lo.contiguous()


def check_flash_bwd_bf16(gen):
    """The bf16 forward's lse against the plain lse, and the bf16 backward
    kernels against ``flash_attention_bwd_ref`` on the same bf16 inputs (the
    plain forward's o and lse fed to both), per row within twice the plain
    version's own bf16 rounding; two calls the same bits; a run without the
    first key tile must fail the check. Returns the timed row at the
    trainer's microbatch."""
    row = None
    for B, T, S, H, KV, hd, window, off, causal in FLASH_BWD_BF16_CASES:
        kw = dict(causal=causal, window=window, q_offset=off)
        q, k, v, do, o, lse, o_lo = flash_bwd_bf16_inputs(gen, B, T, S, H,
                                                          KV, hd, kw)
        name = (f"B={B} T={T} S={S} H={H} KV={KV} hd={hd} bf16 "
                f"{'causal' if causal else 'non-causal'} window={window} "
                f"q_offset={off}")
        check_flash_lse(q, k, v, kw, name)
        got = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo, **kw)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), o_lo=o_lo,
                                       **kw)
        bounds = flash_bwd_operand_bounds(q, k, v, o, lse, do, o_lo, **kw)
        worst, err = flash_bwd_rows_ok("flash_attention_bwd_bf16", name, got,
                                       want, bounds)
        require(worst <= 1.0, f"flash_attention_bwd bf16 off its plain "
                f"version: {name}")
        log_rounded_rows(got, flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            bf16_operands=True, o_lo=o_lo, **kw), name)
        check_flash_residual(gen, B, T, S, H, KV, hd, kw, name)
        if (B, T, hd) == FLASH_BWD_BF16_DROPPED:
            check_flash_bwd_repeats(q, k, v, do, name)
            check_flash_bwd_bf16_dropped_tile(q, k, v, do, want, bounds)
        if (B, T, H, KV, hd) == FLASH_BWD_REPORT:
            check_flash_bwd_repeats(q, k, v, do, name)
            row = time_flash_bwd_bf16(q, k, v, do, o, lse, err, o_lo)
    for B, T, H, KV, hd in FWD_LSE_TIMED:
        q = randn(gen, B, T, H, hd, dtype=torch.bfloat16)
        k, v = (randn(gen, B, T, KV, hd, dtype=torch.bfloat16)
                for _ in range(2))
        plain = device_ms(lambda: flash_forward(q, k, v, True, 0, 0, False), 20)
        with_lse = device_ms(lambda: flash_forward(q, k, v, True, 0, 0, True),
                             20)
        log(f"  flash_attention bf16 forward B={B} T=S={T} H={H} KV={KV} "
            f"hd={hd} causal: {plain:.4f} ms without lse (serving), "
            f"{with_lse:.4f} ms with lse and o_lo (training), "
            f"{with_lse / plain - 1:+.1%}")
    return row


def log_rounded_rows(got, want, name):
    """Logs the bf16 kernels' per-row error (``grad_row_rel_err``) against
    the fp32 result of the plain version with the kernels' own rounding (P
    and dS in bf16), in units of the per-row limit of ``bf16_rows_ok``."""
    parts = []
    for g, w in zip(got, want):
        w2 = w.float().reshape(-1, w.shape[-1])
        limit = 2 * grad_row_rel_err(w2.to(torch.bfloat16), w2)
        err = grad_row_rel_err(g.reshape(w2.shape), w2)
        parts.append(f"{err:.3e} ({err / max(limit, 1e-30):.3f}x)")
    log(f"flash_attention_bwd_bf16 {name}: per row |err| / row RMS vs the "
        f"plain version rounding P and dS to bf16, dq dk dv: "
        f"{', '.join(parts)}")


def check_flash_bwd_bf16_dropped_tile(q, k, v, do, want, bounds,
                                      causal=True, window=0):
    """The bf16 kernels run without the first 64 keys must fail the per-row
    check (``flash_bwd_rows_ok`` with the whole run's ``bounds``). Causal
    (with or without a window): keys from 64 on at q_offset -64, so each
    row sees its own keys but the first 64, and rows 0..63 see none (their
    lse is +inf); non-causal: every row without the first 64 keys."""
    T = q.shape[1]
    k64, v64 = k[:, 64:].contiguous(), v[:, 64:].contiguous()
    kw = dict(causal=causal, window=window, q_offset=-64 if causal else 0)
    n_inf = check_flash_lse(q, k64, v64, kw, f"T={T} bf16, first key tile "
                            f"dropped, q_offset {kw['q_offset']}")
    require(n_inf == (q.shape[0] * q.shape[2] * 64 if causal else 0),
            "the rows without a visible key are not the first 64")
    o, lse, o_lo = flash_attention_ref(q, k64, v64, with_lse=True,
                                       with_residual=True, **kw)
    dq, dk, dv = flash_attention_bwd(q, k64, v64, o.contiguous(), lse, do,
                                     o_lo=o_lo.contiguous(), **kw)
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 64, 0))
    worst, _ = flash_bwd_rows_ok("flash_attention_bwd_bf16", f"T={T}, first "
                                 "key tile dropped", (dq, pad(dk), pad(dv)),
                                 want, bounds)
    require(worst > 1.0, "the bf16 gradient check cannot see a dropped key "
            "tile")
    log(f"flash_attention_bwd_bf16 T={T}: the run without the first key tile "
        f"fails the check, as it must ({worst:.1f}x the limit)")


RESIDUAL_TOL = 2.0 ** -16   # o + o_lo against the exact output, relative
D_TOL = 2.0 ** -14          # D and dP, relative to sum |do| |o| of the row


def residual_inputs(gen, B, T, S, H, KV, hd, device="cuda"):
    """bf16 q, k, v and do whose attention the kernels compute exactly up
    to the output's rounding: q lives on the first half of the head dims
    and k on the second, so every score is exactly 0 and P exactly 1 in
    the bf16 forward; v lies on bf16's 2^-7 grid in [1, 2), so the fp32
    sum P V over up to 2^13 keys is exact, and each column's chance of the
    upper of its two values is drawn anew, so the visible means fill the
    bf16 unit and their rounding is not 0. k has a common part (a bias
    gives one), through which an error in D moves dq: with sum_s dS = 0,
    dq's error is scale D's error times the row's mean key."""
    half = hd // 2
    draw = lambda draw_fn, *shape: draw_fn(*shape, generator=gen,
                                           device=device)
    q = torch.zeros(B, T, H, hd, dtype=torch.bfloat16, device=device)
    q[..., :half] = draw(torch.randn, B, T, H, half)
    k = torch.zeros(B, S, KV, hd, dtype=torch.bfloat16, device=device)
    k[..., half:] = (draw(torch.randn, B, S, KV, hd - half) + 4)
    base = torch.randint(0, 127, (B, 1, KV, hd), generator=gen, device=device)
    upper = draw(torch.rand, B, S, KV, hd) < draw(torch.rand, B, 1, KV, hd)
    v = (1 + (base + upper) / 128).to(torch.bfloat16)
    do = draw(torch.randn, B, T, H, hd).to(torch.bfloat16)
    return q, k, v, do


def check_flash_residual(gen, B, T, S, H, KV, hd, kw, name):
    """The bf16 forward's rounding residual and the backward's use of it,
    on ``residual_inputs``, whose exact output o is the mean of each row's
    visible v (computed in fp64) and whose lse is log of their count:

    - o + o_lo within ``RESIDUAL_TOL`` of o elementwise (the fp32 output is
      exact but for 1/l, and o_lo keeps all but 2^-9 of the rest of it),
      where o alone must fail that (a zero o_lo fails);
    - two forward calls the same bits in o, lse and o_lo;
    - the backward fed the kernel forward's own o, lse and o_lo, held per
      row (``flash_bwd_rows_ok``) against the plain backward fed the exact
      o and lse, its bound widened by a D held to ``D_TOL`` of each row's
      sum |do| |o| (o + o_lo's own 2^-16, the delta kernel's and the plain
      version's fp32 sums of hd <= 128 terms, 2^-17 each, and dP's fp32
      sums in both, 2^-16: each within sum |do| |v| <= 2 sum |do| |o|);
    - the same backward fed a zero o_lo must fail that check, by D's error
      alone (the bf16 rounding of o is 2^-8 of it where D_TOL allows 2^-14).
    """
    q, k, v, do = residual_inputs(gen, B, T, S, H, KV, hd, gen.device)
    causal, window, off = kw["causal"], kw["window"], kw["q_offset"]
    vis = visible(T, S, off, causal, window, q.device).double()
    n = vis.sum(-1)                                               # [T]
    exact = (torch.einsum("ts,bskd->btkd", vis, v.double())
             / n.clamp_min(1)[None, :, None, None]).repeat_interleave(
        H // KV, dim=2)                                           # [B,T,H,hd]
    lse_exact = torch.where(n > 0, n.log(), math.inf).float()[None, None]
    lse_exact = lse_exact.expand(B, H, T).contiguous()
    o, lse, o_lo = flash_forward(q, k, v, causal, window, off, with_lse=True)
    check_flash_fwd_repeats(q, k, v, name + ", residual inputs", causal,
                            window, off)
    tol = RESIDUAL_TOL * exact.abs()
    err = (o.double() + o_lo.double() - exact).abs()
    err_hi = (o.double() - exact).abs()
    rel = lambda e: float((e / exact.abs().clamp_min(1e-30)).max())
    lse_err = (lse - lse_exact).nan_to_num().abs()     # inf - inf: no key
    ok = (bool((err <= tol).all()) and bool((err_hi > tol).any())
          and torch.equal(torch.isinf(lse), torch.isinf(lse_exact))
          and bool((lse_err <= LSE_TOL * (1 + lse_exact.nan_to_num(
              posinf=0).abs())).all()))
    log(f"flash_attention {name}, residual inputs (P exactly 1): largest "
        f"|o + o_lo - exact| / |exact| {rel(err):.3e}, of o alone "
        f"{rel(err_hi):.3e} (tol {RESIDUAL_TOL:.3e}, o alone must exceed "
        f"it); lse off log(keys) by {float(lse_err.max()):.1e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"flash_attention's o + o_lo is not the output to 16 bits, "
            f"or its lse not log(keys): {name}")
    got = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo, **kw)
    zero = flash_attention_bwd(q, k, v, o, lse, do,
                               o_lo=torch.zeros_like(o_lo), **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   exact.float(), lse_exact, do.float(), **kw)
    d_err = D_TOL * (do.double().abs() * exact.abs()).sum(-1).float()
    bounds = flash_bwd_operand_bounds(q, k, v, exact.float(), lse_exact, do,
                                      d_err=d_err.transpose(1, 2), **kw)
    label = f"{name}, residual inputs, the forward's own o, lse and o_lo"
    worst, _ = flash_bwd_rows_ok("flash_attention_bwd_bf16", label, got, want,
                                 bounds)
    require(worst <= 1.0, f"flash_attention_bwd bf16 fed the forward's o_lo "
            f"off the exact gradient: {name}")
    worst0, _ = flash_bwd_rows_ok("flash_attention_bwd_bf16",
                                  f"{name}, residual inputs, o_lo zeroed",
                                  zero, want, bounds)
    require(worst0 > 1.0, f"the bf16 gradient check cannot see a backward "
            f"that drops o_lo: {name}")
    log(f"flash_attention_bwd_bf16 {name}: without o_lo the check fails, as "
        f"it must ({worst0:.1f}x the limit; with it {worst:.3f}x)")


def time_flash_bwd_bf16(q, k, v, do, o, lse, err, o_lo=None, causal=True,
                        window=0):
    """The bf16 backward (T = S; causal, windowed or non-causal; with the
    forward's rounding residual where given, as training calls it) beside
    its plain version, SDPA's backward (with a window: on the window's
    boolean mask, k and v repeated to every head) and the bound over the
    visible pairs."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    mask = dict(causal=causal, window=window)
    bwd = work.flash_bwd(B, T, T, H, KV, hd, q.element_size(), causal,
                         window, residual=o_lo is not None)
    flops, bound = bwd.flops, bwd.bound()
    kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo,
                                         **mask)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    if window:
        attn_mask = visible(T, T, 0, True, window, q.device)
        sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_.repeat_interleave(H // KV, dim=1),
            v_.repeat_interleave(H // KV, dim=1), attn_mask=attn_mask)
    else:
        sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, is_causal=causal, enable_gqa=True)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 5),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, o_lo=o_lo, **mask), 2),
        "library_ms": grad_device_ms(sdpa, (qt, kt, vt), do.transpose(1, 2),
                                     5),
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": (f"B={B} T=S={T} H={H} KV={KV} hd={hd} bf16 "
                  + ("causal" if causal else "non-causal")
                  + (f" window={window}" if window else "")),
    }
    for tries in range(1, 4):   # a trace has dropped every launch of a kernel
        kept = {}
        by_name = device_ms_by_kernel(kernel, 20, kept)
        row["split_ms"] = {part: sum(ms for key, ms in by_name.items()
                                     if name in key)
                           for part, name in BF16_BWD_KERNELS.items()}
        if all(ms > 0 for ms in row["split_ms"].values()):
            break
    log(f"  bf16 backward split read from trace {tries} of at most 3; "
        f"launches each kernel kept in it, of 20: " + ", ".join(
            f"{part} {sum(n for key, n in kept.items() if name in key)}"
            for part, name in BF16_BWD_KERNELS.items()))
    split = row["split_ms"]
    # tile products per visible tile pair: 4 in dk/dv, 3 in dq
    tile_flops = work.flash_tile_flops(
        B, H, hd, work.visible_tiles(T, T, causal, window))
    require(all(ms > 0 for ms in split.values()),
            f"a bf16 backward kernel is missing from the trace: {dict(by_name)}")
    log(f"  bf16 backward kernels apart, device ms per call (profiler, 20 "
        f"calls): delta {split['delta']:.4f}, dk/dv {split['dkdv']:.4f} "
        f"({4 * tile_flops / split['dkdv'] / 1e9:.1f} TFLOP/s on its tile "
        f"products), dq {split['dq']:.4f} "
        f"({3 * tile_flops / split['dq'] / 1e9:.1f} TFLOP/s); sum "
        f"{sum(split.values()):.4f}; all kernels of the call "
        f"{sum(by_name.values()):.4f}")
    log(f"  device time {row['shape']}: backward kernels {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, SDPA backward (bf16, GQA) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); kernel / SDPA "
        f"{row['ms'] / row['library_ms']:.3f}, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound, "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s; one call from Python "
        f"{host_ms(kernel, 5):.4f} ms")
    return row


def check_rmsnorm_bwd_bf16(gen):
    """bf16 dx and dg against ``rmsnorm_bwd_ref``'s fp32 result of the same
    inputs, per row within twice its bf16 rounding, at every training norm
    shape, at qwen3-14b's width and on a view off 16-byte alignment (the
    scalar path); two calls the same bits at each. Timed at the Trainer's
    three shapes. Returns the timed rows and their sums weighted by a
    Trainer step's launches."""
    path = {}
    cases = [(f"rows={rows} d={d} bfloat16",
              randn(gen, rows, d, dtype=torch.bfloat16), d)
             for rows, d in TRAIN_NORM_SHAPES + [RMS_BWD_BF16_WIDE]]
    flat = randn(gen, 1000 * 128 + 1, dtype=torch.bfloat16)
    cases.append(("rows=1000 d=128 bfloat16 view at byte offset 2",
                  flat[1:].view(1000, 128), 128))
    for name, x, d in cases:
        g = (1 + 0.1 * randn(gen, d)).to(torch.bfloat16)
        dy = randn(gen, *x.shape, dtype=torch.bfloat16)
        p = rmsnorm_bwd_layout(x.data_ptr() | g.data_ptr() | dy.data_ptr(),
                               x.shape[0], d, 0)
        got = rmsnorm_bwd(x, g, dy, eps=1e-6)
        again = rmsnorm_bwd(x, g, dy, eps=1e-6)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = rmsnorm_bwd_ref(x.float(), g.float(), dy.float(), eps=1e-6)
        worst, err = bf16_rows_ok(
            "rmsnorm_bwd_bf16", f"{name} (vec={p.vec} group={p.group} "
            f"clusters={p.clusters} rows/block={p.rows_per_block} "
            f"smem={p.smem})",
            got, want)
        log(f"  two calls: {'the same bits' if same else 'DIFFERENT bits'}")
        require(worst <= 1.0, f"rmsnorm_bwd bf16 off its plain version: "
                f"{name}")
        require(same, f"rmsnorm_bwd bf16: two calls differ: {name}")
        if name in RMS_BWD_BF16_STEP:
            path[name] = time_rmsnorm_bwd(name, x, g, dy, err)
    step = {key: sum(n * path[name][key]
                     for name, n in RMS_BWD_BF16_STEP.items())
            for key in ("ms", "library_ms", "bound_ms")}
    log(f"rmsnorm_bwd_bf16 over one Trainer step "
        f"({sum(RMS_BWD_BF16_STEP.values())} launches: "
        f"{', '.join(f'{n} x {k}' for k, n in RMS_BWD_BF16_STEP.items())}): "
        f"kernels {step['ms']:.4f} ms, F.rms_norm backward "
        f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms; the "
        f"kernels at {step['bound_ms'] / step['ms']:.1%} of the bound")
    return path, step


SSD_GRID = [(1, 128, 4, 1, 16, 32), (2, 256, 2, 2, 8, 64),
            (1, 512, 8, 1, 16, 32),          # tests/test_kernels.py:124-128
            (1, 137, 4, 2, 128, 32)]         # N = 128: the ordered walk
SSD_AS_HEADS = 2                             # this grid case also passes G = H
SSD_PATH = (1, 4, 512, 1024)                 # mLSTM: b, H, N=dqk, P=dv
SSD_PATH_T = (137, 1000, 1291)
SSD_MAMBA = (1, 80, 64, 64)                  # Mamba-2 (zamba2): b, H, N, P
SLSTM_GRID = [(2, 64, 2, 16), (1, 128, 4, 32),
              (3, 128, 1, 64)]               # tests/test_kernels.py:197-201
SLSTM_PATH = (1, 4, 512)                     # sLSTM: B, nh, dh
SLSTM_PATH_T = (1, 137, 1000)
SLSTM_EXTRA = [(1, 137, torch.float32),      # B, T, r dtype: fp32 r (L2 tail)
               (4, 137, torch.bfloat16)]     # a batch tile of 4 rows


def model_like_ssd(gen, b, T, H, N, P):
    """mLSTM inputs drawn as the served model makes them: log forget gates
    logsigmoid(N(3, 1)) (b_f = 3: slow forgetting, state carried across
    many chunks), input gates w = exp(clamp(N(-2, 1), max=15)), x = v * w,
    B = k / sqrt(N), C = q."""
    a = F.logsigmoid(randn(gen, b, T, H) + 3)
    w = torch.exp(torch.clamp(randn(gen, b, T, H) - 2, max=15))
    x = randn(gen, b, T, H, P) * w[..., None]
    return x, a, randn(gen, b, T, H, N, scale=1 / math.sqrt(N)), \
        randn(gen, b, T, H, N), w


def mamba2_like_ssd(gen, b, T, H, N, P):
    """Mamba-2 inputs drawn as zamba2 makes them at random init:
    dt = softplus(N(0, 1) + dt_bias), dt_bias the inverse softplus of a
    per-head log-uniform draw in [1e-3, 1e-1], A = -(1..H), a = dt * A
    (per-step decays down to e^-8 and beyond on the fast heads: exp(a_cum)
    underflows to 0 within a chunk), x = silu(N(0, 1)) * dt, B and C the
    one group's silu(N(0, 1)), [b, T, 1, N], all fp32."""
    u = torch.rand(H, generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt = F.softplus(randn(gen, b, T, H) + torch.log(torch.expm1(dt0)))
    a = dt * -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    x = F.silu(randn(gen, b, T, H, P)) * dt[..., None]
    B, C = (F.silu(randn(gen, b, T, 1, N)) for _ in range(2))
    return x, a, B, C


def check_ssd(gen):
    """Both paths against the plain version in both dtypes (each case logs
    the path it took), B and C per group as the models hand them (and once
    expanded to G = H); then the paths' shapes, timed."""
    for dtype in (torch.float32, torch.bfloat16):
        for case, (b, T, H, G, N, P) in enumerate(SSD_GRID):
            x = randn(gen, b, T, H, P, dtype=dtype, scale=0.5)
            a = -randn(gen, b, T, H, scale=0.3).abs()
            B, C = (randn(gen, b, T, G, N, dtype=dtype, scale=0.5)
                    for _ in range(2))
            groups = [(G, B, C)]
            if case == SSD_AS_HEADS:
                groups.append((H, *(t.repeat_interleave(H // G, dim=2)
                                    for t in (B, C))))
            for g, Bg, Cg in groups:
                got = ssd_scan(x, a, Bg, Cg)
                torch.cuda.synchronize()
                compare("ssd_scan", f"b={b} T={T} H={H} G={g} N={N} P={P} "
                        f"{str(dtype)[6:]}, path {ssd_path(N, P, False)}",
                        got, ssd_scan_ref(x, a, Bg, Cg))
            if dtype == torch.float32 and ssd_path(N, P, False) == "chunks":
                ms = {r: device_ms(lambda: ssd_launch(r, x, a, B, C), 5)
                      for r in ("chunks", "walk")}
                log("  device time by path: " + ", ".join(
                    f"{r} {t:.4f} ms" for r, t in ms.items()))
    path = {}
    b, H, N, P = SSD_PATH
    for T in SSD_PATH_T:
        for init in (False, True):
            x = randn(gen, b, T, H, P, scale=0.5)
            a = -randn(gen, b, T, H, scale=0.3).abs()
            B, C = (randn(gen, b, T, H, N, scale=0.5) for _ in range(2))
            kw = {"norm_weights": torch.exp(randn(gen, b, T, H, scale=0.5) - 2)}
            if init:
                kw["initial_state"] = randn(gen, b, H, N, P)
                kw["initial_norm_state"] = randn(gen, b, H, N)
            got = ssd_scan(x, a, B, C, **kw)
            torch.cuda.synchronize()
            err = compare("ssd_scan", f"b={b} T={T} H={H} N={N} P={P} fp32 "
                          f"normalizer initial_state={init}, path "
                          f"{ssd_path(N, P, True)}", got,
                          ssd_scan_ref(x, a, B, C, **kw))
            if not init:
                path[T] = time_ssd(x, a, B, C, kw["norm_weights"], err)
    T = SSD_PATH_T[-1]
    x, a, B, C, w = model_like_ssd(gen, b, T, H, N, P)
    kw = {"norm_weights": w, "initial_state": randn(gen, b, H, N, P),
          "initial_norm_state": randn(gen, b, H, N)}
    got = ssd_scan(x, a, B, C, **kw)
    torch.cuda.synchronize()
    compare("ssd_scan", f"b={b} T={T} H={H} N={N} P={P} fp32 normalizer "
            "initial_state=True, drawn like the model", got,
            ssd_scan_ref(x, a, B, C, **kw))
    b, H, N, P = SSD_MAMBA
    require(ssd_path(N, P, False) == "chunks")
    for T in ZAMBA_T:
        x, a, B, C = mamba2_like_ssd(gen, b, T, H, N, P)
        got = ssd_scan(x, a, B, C)
        torch.cuda.synchronize()
        err = compare("ssd_scan", f"b={b} T={T} H={H} G=1 N={N} P={P} fp32, "
                      "drawn like Mamba-2 (zamba2), path chunks", got,
                      ssd_scan_ref(x, a, B, C))
        check_ssd_repeats(x, a, B, C)
        path["mamba2", T] = time_ssd(x, a, B, C, None, err)
        if T == REPORT_T:            # the other path at this shape
            walk = lambda: ssd_launch("walk", x, a, B, C)
            compare("ssd_scan", f"b={b} T={T} H={H} G=1 N={N} P={P} fp32, "
                    "path walk", walk(), ssd_scan_ref(x, a, B, C))
            log(f"  device time of the ordered walk at this shape: "
                f"{device_ms(walk, 5):.4f} ms")
    T = ZAMBA_T[0]
    x, a, B, C = mamba2_like_ssd(gen, b, T, H, N, P)
    S0 = randn(gen, b, H, N, P)
    compare("ssd_scan", f"b={b} T={T} H={H} G=1 N={N} P={P} fp32, drawn "
            "like Mamba-2, initial_state=True, path chunks",
            ssd_scan(x, a, B, C, initial_state=S0),
            ssd_scan_ref(x, a, B, C, initial_state=S0))
    return path


def check_ssd_repeats(x, a, B, C):
    """One owner per output, no atomics: two calls give the same bits."""
    first, second = ssd_scan(x, a, B, C), ssd_scan(x, a, B, C)
    require(all(torch.equal(f, s) for f, s in zip(first, second)),
            "ssd_scan: two calls gave different bits")


def time_ssd(x, a, B, C, w, err, plain_ms=None):
    """The bound counts the kernel's inputs as they are given: B and C per
    group ([b, T, G, N]; G = 1 for Mamba-2, G = H for mLSTM), each read
    once. ``plain_ms``: the plain version's time where the caller has
    measured it (``plain_graphed``), else measured here."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    fwd = work.ssd_scan(b, T, H, G, N, P, w is not None)
    flops, bound = fwd.flops, fwd.bound()
    kw = {} if w is None else {"norm_weights": w}
    kernel = lambda: ssd_scan(x, a, B, C, **kw)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 5),
        "plain_ms": plain_ms or device_ms(
            lambda: ssd_scan_ref(x, a, B, C, **kw), 1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"b={b} T={T} H={H} G={G} N={N} P={P} fp32"
                 + ("" if w is None else " + normalizer"),
    }
    if ssd_path(N, P, w is not None) == "chunks":
        parts = []
        for k, v in device_ms_by_kernel(kernel, 10).items():
            name = re.search(r"ssd_scan\w*", k)
            parts.append(f"{name.group(0) if name else k[:40]} {v:.4f}")
        log("  device ms by kernel: " + ", ".join(parts))
    log(f"  device time {row['shape']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; operations "
        f"{bound['operations']:.4f}, bytes {bound['bytes']:.4f}); kernel reaches "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound; one call from "
        f"Python {host_ms(kernel, 5):.4f} ms; path "
        f"{ssd_path(N, P, w is not None)}")
    return row


def slstm_inputs(gen, B, T, nh, dh, dtype, path, r_dtype=torch.bfloat16):
    """Grid inputs as tests/test_kernels.py draws them; path inputs as the
    model's: wx ~ N(0, 1) (rms-normed x through w_in), r ~ N(0, 1/dh) in
    ``r_dtype`` (bf16 weights; fp32 in the fp32-weight check), b = -2 / 3 /
    0 / 0 for the i / f / z / o gates."""
    if not path:
        return (randn(gen, B, T, nh, 4 * dh, dtype=dtype, scale=0.5),
                randn(gen, nh, dh, 4 * dh, scale=0.3),
                randn(gen, nh, 4 * dh, scale=0.2))
    gate_b = torch.tensor([-2.0, 3.0, 0.0, 0.0], device="cuda")
    return (randn(gen, B, T, nh, 4 * dh),
            randn(gen, nh, dh, 4 * dh, dtype=r_dtype,
                  scale=1 / math.sqrt(dh)),
            gate_b.repeat_interleave(dh).expand(nh, 4 * dh).contiguous())


def check_slstm(gen):
    """Every case against the plain version; each path case (the served
    model's shapes) also timed. Returns the path rows by (B, T, r dtype)."""
    bf16 = torch.bfloat16
    cases = [(B, T, nh, dh, dtype, torch.float32, False)
             for dtype in (torch.float32, bf16) for B, T, nh, dh in SLSTM_GRID]
    B1, nh, dh = SLSTM_PATH
    cases += [(B1, T, nh, dh, torch.float32, bf16, True) for T in SLSTM_PATH_T]
    cases += [(B, T, nh, dh, torch.float32, r_dtype, True)
              for B, T, r_dtype in SLSTM_EXTRA]
    for B, r_dtype in [(B1, bf16)] + [(B, r) for B, _, r in SLSTM_EXTRA]:
        plan = slstm_plan(B, nh, dh, r_dtype)
        fit = slstm_max_clusters(B, nh, dh, torch.float32, r_dtype)
        log(f"slstm_scan B={B} nh={nh} dh={dh} r {str(r_dtype)[6:]}: {plan}; "
            f"the card holds {fit} such clusters at once"
            + ("" if fit >= nh else f", so the {nh} heads run in waves"))
    path = {}
    for B, T, nh, dh, dtype, r_dtype, on_path in cases:
        wx, r, b = slstm_inputs(gen, B, T, nh, dh, dtype, on_path, r_dtype)
        hs, state = slstm_scan(wx, r, b)
        torch.cuda.synchronize()
        want_hs, want_state = slstm_scan_ref(wx, r, b)
        err = compare("slstm_scan", f"B={B} T={T} nh={nh} dh={dh} wx "
                      f"{str(wx.dtype)[6:]} r {str(r.dtype)[6:]}",
                      (hs, *state), (want_hs, *want_state))
        if on_path:
            path[B, T, str(r_dtype)[6:]] = time_slstm(wx, r, b, err)
    return path


def time_slstm(wx, r, b, err, plain_ms=None):
    """The kernel, its plain version (``plain_ms``: as ``time_ssd``'s) and
    the bound."""
    B, T, nh, gd = wx.shape
    dh = gd // 4
    fwd = work.slstm_scan(B, T, nh, dh, wx.element_size(), r.element_size())
    flops, bound = fwd.flops, fwd.bound()
    kernel = lambda: slstm_scan(wx, r, b)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 3),
        "plain_ms": plain_ms or device_ms(lambda: slstm_scan_ref(wx, r, b),
                                          1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T={T} nh={nh} dh={dh} wx {str(wx.dtype)[6:]} r "
                 f"{str(r.dtype)[6:]}",
    }
    log(f"  device time {row['shape']}: kernel {row['ms']:.4f} ms "
        f"({row['ms'] / T * 1e3:.3f} us per step), plain "
        f"{row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); one call from Python "
        f"{host_ms(kernel, 3):.4f} ms")
    return row


# --------------------------------------------------------------------------
# phase 4, backward of the recurrent archs: the scans and zamba2's hd 80
# --------------------------------------------------------------------------
SSD_BWD_GRID = [   # b, T, H, G, N, P, normalizer, log decays
    (1, 70, 4, 2, 16, 8, True, "mild"),       # groups, T % 64, normalizer
    (1, 137, 4, 2, 16, 8, False, "strong"),   # e^-8 a step
    (2, 130, 3, 3, 8, 5, True, "near0"),      # decays ~1: state kept whole
]
SSD_BWD_TRAIN = {   # the Trainer's microbatch (B.T = 4 x 512)
    "mamba2": (4, 512, 80, 1, 64, 64),        # zamba2: b, T, H, G, N, P
    "mlstm": (4, 512, 4, 4, 512, 1024),       # xlstm: + the normalizer
}
SLSTM_BWD_TRAIN = (4, 512, 4, 512)            # xlstm: B, T, nh, dh
SLSTM_BWD_GRID = [  # B, T, nh, dh, r dtype, scale of the input gate's wx
    (2, 9, 2, 32, torch.float32, 1.0), (3, 70, 1, 64, torch.bfloat16, 1.0),
    (16, 33, 2, 512, torch.bfloat16, 1.0),    # MAX_BATCH at dh 512
    (2, 15, 2, 48, torch.bfloat16, 1.0),      # 16-unit blocks (G = 3)
    (3, 1, 2, 64, torch.bfloat16, 1.0),       # T = 1: no recurrent product
    (4, 40, 2, 128, torch.bfloat16, 20.0)]    # i across I_CLAMP
FLASH_BWD_80_CASES = [                        # (B, T, S, H, KV, hd), window
    ((2, 137, 137, 8, 4, 80), 0),             # GQA 2, a ragged T
    ((2, 256, 256, 16, 4, 80), 0),            # GQA 4
    ((1, 512, 512, 32, 32, 80), 128)]         # zamba2's heads under a window
FLASH_BWD_ZAMBA = (4, 512, 32, 32, 80)        # B, T=S, H, KV, hd: zamba2's
RMS_BWD_RECURRENT = [(2048, 2048), (2048, 2560), (2048, 5120)]  # rows, d:
#   xlstm's d_model, zamba2's d_model, zamba2's mixer norm (2 x d_model)



GRID_EDGE = 65535    # a grid's y and z extent, where the C entries refuse
SSD_FWD_RULES = [   # route, (b, T, H, G, N, P): the entries' shape checks
    ("walk", (1, 32768, 4, 4, 512, 1024)),           # xlstm's prefill_32k
    ("walk", (1, 64 * (GRID_EDGE - 1), 1, 1, 64, 32)),   # chunks at the edge
    ("walk", (1, 64 * (GRID_EDGE - 1) + 1, 1, 1, 64, 32)),   # one past it
    ("walk", (1, 64, 1, 1, 64, 32 * (GRID_EDGE - 1))),   # P's tiles
    ("walk", (1, 64, 1, 1, 64, 32 * (GRID_EDGE - 1) + 1)),
    ("walk", (1, 64, 3, 2, 64, 32)),                 # G not dividing H
    ("walk", (0, 64, 1, 1, 64, 32)),
    ("chunks", (1, 1291, 80, 1, 64, 64)),            # zamba2's prefill
    ("chunks", (13106, 64, 4, 1, 64, 64)),           # b (G + H) = 65530
    ("chunks", (13107, 64, 4, 1, 64, 64)),           # 65535: past it
    ("chunks", (1, 64, 4, 1, 12, 64)),               # N not a multiple of 8
    ("chunks", (1, 64, 4, 1, 72, 64)),               # N past 64
    ("chunks", (1, 64, 4, 1, 64, 65)),               # P past 64
    ("chunks", (1, 64, 4, 1, 0, 64))]
SSD_BWD_RULES = [   # b, T, H, G, N, Pe: sizes and refusals of the backward
    (*SSD_BWD_TRAIN["mamba2"][:5], 64), (*SSD_BWD_TRAIN["mlstm"][:5], 1025),
    (128, 4096, 80, 1, 64, 64), (2, 137, 4, 2, 16, 33),
    (32767, 137, 1, 1, 16, 8),                       # 2 b H at the edge
    (32768, 137, 1, 1, 16, 8),                       # past it
    (1, 64 * GRID_EDGE, 1, 1, 16, 8),                # chunks at the edge
    (1, 64 * GRID_EDGE + 1, 1, 1, 16, 8),            # past it
    (1, 137, 4, 2, 6, 8),                            # N not a multiple of 4
    (1, 137, 3, 2, 16, 8)]                           # G not dividing H
MISALIGNED = 716    # cudaErrorMisalignedAddress


def check_ssd_shape_rules():
    """The wrapper sizes ssd_scan's workspaces and refuses shapes in Python
    on every device (``fwd_workspace_floats``, ``bwd_workspace_floats``; the
    meta path has no C): both held to the C entries. The backward's floats
    and refusals against ``ssd_scan_bwd_workspace``; the forward's
    refusals against ``ssd_scan_fwd`` / ``ssd_scan_chunks_fwd`` themselves,
    called so that they return before a launch: a refused shape returns
    invalid argument (1), an accepted one meets a misaligned B (walk) or
    workspace (chunks) and returns 716. No memory is touched."""
    verdict = {1: "refused", MISALIGNED: "accepted"}
    for route, (b, T, H, G, N, P) in SSD_FWD_RULES:
        if route == "walk":
            code = build.function("ssd_scan_fwd", SSD_FWD_ARGTYPES)(
                None, None, 1, None, None, None, None, None, None, None,
                None, None, 0, b, T, H, G, N, P, None)
        else:
            code = build.function("ssd_scan_chunks_fwd", SSD_CHUNKS_ARGTYPES)(
                None, None, None, None, None, None, None, 1, 0, b, T, H, G,
                N, P, None)
        try:
            floats = ssd_fwd_workspace_floats(route, b, T, H, G, N, P)
            mine = "accepted"
        except RuntimeError:
            floats, mine = None, "refused"
        log(f"ssd_scan {route} b={b} T={T} H={H} G={G} N={N} P={P}: C entry "
            f"{verdict.get(code, code)}, the wrapper {mine}"
            + (f" ({floats} floats of workspace)" if floats else ""))
        require(verdict.get(code) == mine, f"ssd_scan's wrapper and its C "
                f"entry judge b={b} T={T} H={H} G={G} N={N} P={P} apart")
    for b, T, H, G, N, Pe in SSD_BWD_RULES:
        size = ctypes.c_longlong(0)
        code = build.function("ssd_scan_bwd_workspace", SSD_BWD_WS_ARGTYPES)(
            b, T, H, G, N, Pe, ctypes.addressof(size))
        try:
            mine = ssd_bwd_workspace_floats(b, T, H, G, N, Pe)
        except RuntimeError:
            mine = None
        want = size.value if code == 0 else None
        log(f"ssd_scan_bwd workspace b={b} T={T} H={H} G={G} N={N} Pe={Pe}: "
            f"C entry {want if code == 0 else f'refused ({code})'}, the "
            f"wrapper {mine if mine is not None else 'refused'}")
        require(code in (0, 1) and mine == want, "the wrapper sizes or "
                "refuses ssd_scan_bwd's workspace unlike the C entry")


SSD_BWD_KERNELS = (  # csrc/ssd_scan_bwd.cu's kernels, in launch order
    "ssd_bwd_decay_kernel", "ssd_bwd_gram_kernel", "ssd_bwd_state_kernel",
    "ssd_bwd_pass_kernel", "ssd_bwd_dx_kernel", "ssd_bwd_dbc_kernel",
    "ssd_bwd_da_kernel", "ssd_bwd_group_sum_kernel")


def ssd_bwd_split(fn, products: dict, iters: int = 5):
    """Device ms per call of each kernel of an ``ssd_scan_bwd`` call ``fn``
    by its name in ``SSD_BWD_KERNELS`` (``device_ms_by_kernel``), and a line
    with each product's TFLOP/s and the pass's GB/s from ``products``
    (``kernels.work.ssd_bwd_products``), then the four products' together."""
    ms = Counter()
    for key, t in device_ms_by_kernel(fn, iters).items():
        found = re.search(r"ssd_bwd_\w*?kernel", key)
        ms[found.group(0) if found else key[:40]] += t
    parts = []
    for name, t in ms.items():
        rate = ("" if name not in products else
                f" ({products[name] / t / 1e6:.0f} GB/s)"
                if name == "ssd_bwd_pass_kernel" else
                f" ({products[name] / t / 1e9:.1f} TFLOP/s)")
        parts.append(f"{name} {t:.4f}{rate}")
    kinds = [n for n in products if n != "ssd_bwd_pass_kernel"]
    t = sum(ms[n] for n in kinds)
    flops = sum(products[n] for n in kinds)
    parts.append(f"the four products {t:.4f} ms, "
                 f"{flops / max(t, 1e-9) / 1e9:.1f} TFLOP/s")
    return dict(ms), ", ".join(parts)


def ssd_bwd_inputs(gen, b, T, H, G, N, P, norm, draw):
    """x, a, B, C, norm weights (or None) and the gradients dy, dn of y and
    n: grid draws, or the model's (``mamba2_like_ssd``,
    ``model_like_ssd``) at the training shapes."""
    if draw == "mamba2":
        x, a, B, C = mamba2_like_ssd(gen, b, T, H, N, P)
        w = None
    elif draw == "mlstm":
        x, a, B, C, w = model_like_ssd(gen, b, T, H, N, P)
    else:
        x = randn(gen, b, T, H, P)
        scale = {"mild": 0.3, "strong": 8.0, "near0": 1e-3}[draw]
        a = -torch.rand(b, T, H, generator=gen, device="cuda") * scale
        B, C = (randn(gen, b, T, G, N, scale=N ** -0.5) for _ in range(2))
        w = torch.rand(b, T, H, generator=gen, device="cuda") if norm else None
    dy = randn(gen, b, T, H, P)
    dn = randn(gen, b, T, H) if w is not None else None
    return x, a, B, C, w, dy, dn


def check_ssd_bwd(gen):
    """``ssd_scan_bwd`` (csrc/ssd_scan_bwd.cu) against ``ssd_scan_bwd_ref``
    on the same inputs, every gradient within GRAD_TOL of its largest
    magnitude; two calls the same bits; timed at the training shapes.
    Returns the timed rows by draw."""
    rows = {}
    cases = SSD_BWD_GRID + [(*shape, draw == "mlstm", draw)
                            for draw, shape in SSD_BWD_TRAIN.items()]
    for b, T, H, G, N, P, norm, draw in cases:
        x, a, B, C, w, dy, dn = ssd_bwd_inputs(gen, b, T, H, G, N, P, norm,
                                               draw)
        kw = dict(norm_weights=w, dn=dn)
        got = ssd_scan_bwd(x, a, B, C, dy, **kw)
        again = ssd_scan_bwd(x, a, B, C, dy, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, again)
                   if g is not None)
        want = ssd_scan_bwd_ref(x, a, B, C, dy, **kw)
        name = (f"b={b} T={T} H={H} G={G} N={N} P={P} fp32"
                f"{' + normalizer' if norm else ''}, decays {draw}")
        err = check_grads("ssd_scan_bwd", name,
                          [g for g in got if g is not None],
                          [v for v in want if v is not None])
        log(f"  two calls: {'the same bits' if same else 'DIFFERENT bits'}")
        require(same, f"ssd_scan_bwd: two calls differ: {name}")
        if draw in SSD_BWD_TRAIN:
            rows[draw] = time_ssd_bwd(x, a, B, C, w, dy, dn, err)
    return rows


def time_ssd_bwd(x, a, B, C, w, dy, dn, err):
    """The bound: 12 N Pe flops a step and head (the state and its
    gradient, 2 each; dx, dB, dC and da, 2 each; Pe = P + 1 with the
    normalizer), or the inputs (x, a, B, C, dy, w, dn) read once and the
    gradients written once, in fp32."""
    b, T, H, P = x.shape
    G, N = B.shape[2:]
    cols = P + (w is not None)
    require((w is None) == (dn is None), "ssd_scan_bwd's row takes w and dn "
            "together")
    bwd = work.ssd_scan_bwd(b, T, H, G, N, P, w is not None)
    flops, bound = bwd.flops, bwd.bound()
    kw = dict(norm_weights=w, dn=dn)
    kernel = lambda: ssd_scan_bwd(x, a, B, C, dy, **kw)
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 3),
        "plain_ms": device_ms(lambda: ssd_scan_bwd_ref(x, a, B, C, dy, **kw),
                              1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"b={b} T={T} H={H} G={G} N={N} P={P} fp32"
                 + ("" if w is None else " + normalizer"),
    }
    _, split = ssd_bwd_split(kernel, work.ssd_bwd_products(b, T, H, G, N, cols))
    log(f"  device ms by kernel: {split}")
    log(f"  device time {row['shape']} backward: kernels {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; operations "
        f"{bound['operations']:.4f}, bytes {bound['bytes']:.4f}); "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound; one call from "
        f"Python {host_ms(kernel, 3):.4f} ms")
    return row


def check_slstm_bwd(gen):
    """``slstm_scan_bwd`` (csrc/slstm_scan_bwd.cu, the forward's trace)
    against ``slstm_scan_bwd_ref``, dwx, dr and db within GRAD_TOL of their
    largest magnitudes (dr with bf16 r: within a bf16 rounding, both round
    their fp32 sums once); r in both dtypes at the Trainer's microbatch;
    two calls the same bits. Returns the timed rows by r dtype."""
    rows = {}
    B, T, nh, dh = SLSTM_BWD_TRAIN
    cases = SLSTM_BWD_GRID + [(B, T, nh, dh, r_dtype, 1.0)
                              for r_dtype in (torch.bfloat16, torch.float32)]
    for B, T, nh, dh, r_dtype, i_scale in cases:
        wx, r, b = slstm_inputs(gen, B, T, nh, dh, torch.float32, True,
                                r_dtype)
        wx[..., :dh] *= i_scale
        if i_scale > 1:
            require(bool((wx[..., :dh] + b[:, :dh] > I_CLAMP).any()),
                    "slstm_scan_bwd: no input gate across I_CLAMP")
        dhs = randn(gen, B, T, nh, dh)
        (hs, _), trace = slstm_forward(wx, r, b, trace=True)
        want_hs, _ = slstm_scan_ref(wx, r, b)
        compare("slstm_scan", f"B={B} T={T} nh={nh} dh={dh} with the "
                "backward's trace", hs, want_hs)
        require(bool((trace[1][3] == hs.float()).all()),
                "slstm_scan: the trace's h is not hs")
        got = slstm_scan_bwd(wx, r, b, dhs, trace=trace)
        again = slstm_scan_bwd(wx, r, b, dhs, trace=trace)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        want = slstm_scan_bwd_ref(wx, r, b, dhs)
        name = (f"B={B} T={T} nh={nh} dh={dh} r {str(r_dtype)[6:]}"
                + (f" i x {i_scale:g}" if i_scale > 1 else ""))
        tol = GRAD_TOL if r_dtype == torch.float32 else 2 ** -7
        err = max(check_grads("slstm_scan_bwd", name, got[::2], want[::2]),
                  check_grads("slstm_scan_bwd", name + ", dr", got[1:2],
                              want[1:2], tol))
        log(f"  two calls: {'the same bits' if same else 'DIFFERENT bits'}")
        require(same, f"slstm_scan_bwd: two calls differ: {name}")
        if (B, T, nh, dh) == SLSTM_BWD_TRAIN:
            rows[str(r_dtype)[6:]] = time_slstm_bwd(wx, r, b, dhs, trace, err)
    return rows


def time_slstm_bwd(wx, r, b, dhs, trace, err):
    """The bound: the recurrent product R dpre and dR = sum h^T dpre, 2 B T
    nh dh 4dh flops each, ~40 gate operations a unit and step; or pre,
    the per-step states, dhs and r read once and dwx, dr, db written once.
    The walk (the kernel's one launch) is also timed alone, without the
    wrapper's dR product, with the clusters the card holds at once."""
    B, T, nh, gd = wx.shape
    dh = gd // 4
    occ = slstm_bwd_occupancy(B, nh, dh, wx.dtype, r.dtype)
    G = slstm_plan(B, nh, dh, r.dtype).blocks
    dstate = torch.zeros(3, B, nh, dh, device="cuda")
    bwd = work.slstm_scan_bwd(B, T, nh, dh, wx.element_size(),
                              r.element_size())
    flops, bound = bwd.flops, bwd.bound()
    kernel = lambda: slstm_scan_bwd(wx, r, b, dhs, trace=trace)
    eager = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    kernel()
    eager[0].record()
    for _ in range(3):
        kernel()
    eager[1].record()
    torch.cuda.synchronize()
    row = {
        "max_abs_err": err,
        "ms": device_ms(kernel, 2),
        "plain_ms": device_ms(lambda: slstm_scan_bwd_ref(wx, r, b, dhs), 1),
        "library_ms": None,
        "bound_by": max(bound, key=bound.get),
        "bound_ms": max(bound.values()),
        "shape": f"B={B} T={T} nh={nh} dh={dh} wx fp32 r {str(r.dtype)[6:]}",
        "eager_ms": eager[0].elapsed_time(eager[1]) / 3,
        "walk_ms": device_ms(lambda: slstm_bwd_walk(r, *trace, dhs, dstate),
                             3),
        "clusters_held": occ["clusters"],
    }
    log(f"  device time {row['shape']} backward: {row['ms']:.4f} ms replayed "
        f"in a CUDA graph, {row['eager_ms']:.4f} ms launched eagerly as the "
        f"path does (one launch and the dR product), plain "
        f"{row['plain_ms']:.4f} ms, no one-call PyTorch equivalent, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound; the walk alone "
        f"{row['walk_ms']:.4f} ms ({row['walk_ms'] / T * 1e3:.3f} us per "
        f"step), dR and the copies {row['ms'] - row['walk_ms']:.4f} ms; the "
        f"card holds {occ['clusters']} such clusters of {G} blocks at once "
        f"({nh} needed)")
    return row


def hold_flash_bwd_bf16(gen, B, T, H, KV, hd, window=0, causal=True):
    """One T = S case of the bf16 backward kernels (with the forward's
    rounding residual, as training calls them) held per row against the
    plain version (``flash_bwd_rows_ok``; the rounded plain version's rows
    logged), then called twice for the same bits; a run without the first
    key tile must fail the check. Returns ``time_flash_bwd_bf16``'s
    arguments."""
    kw = dict(causal=causal, window=window, q_offset=0)
    q, k, v, do, o, lse, o_lo = flash_bwd_bf16_inputs(gen, B, T, T, H, KV,
                                                      hd, kw)
    name = (f"B={B} T=S={T} H={H} KV={KV} hd={hd} bf16 "
            f"{'causal' if causal else 'non-causal'} window={window}")
    got = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo, **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                   lse, do.float(), o_lo=o_lo, **kw)
    bounds = flash_bwd_operand_bounds(q, k, v, o, lse, do, o_lo, **kw)
    worst, err = flash_bwd_rows_ok("flash_attention_bwd_bf16", name, got,
                                   want, bounds)
    require(worst <= 1.0, f"flash_attention_bwd bf16 off its plain version: "
            f"{name}")
    log_rounded_rows(got, flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        bf16_operands=True, o_lo=o_lo, **kw), name)
    again = flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo, **kw)
    same = [torch.equal(a, b) for a, b in zip(got, again)]
    log(f"flash_attention_bwd {name}: two calls bit-identical in dq, dk, "
        f"dv: {same}")
    require(all(same), f"flash_attention_bwd is not deterministic: {name}")
    check_flash_bwd_bf16_dropped_tile(q, k, v, do, want, bounds, causal,
                                      window)
    check_flash_residual(gen, B, T, T, H, KV, hd, kw, name)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, err=err, o_lo=o_lo,
                causal=causal, window=window)


def hold_rmsnorm_bwd_bf16(gen, rows, d):
    """The bf16 rmsnorm backward at rows x d per row against its plain
    version (``bf16_rows_ok``), twice the same bits, then timed. Returns
    the timed row."""
    x = randn(gen, rows, d, dtype=torch.bfloat16)
    g = (1 + 0.1 * randn(gen, d)).to(torch.bfloat16)
    dy = randn(gen, rows, d, dtype=torch.bfloat16)
    name = f"rows={rows} d={d} bfloat16"
    got, again = rmsnorm_bwd(x, g, dy), rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    worst, err = bf16_rows_ok("rmsnorm_bwd_bf16", name, got,
                              rmsnorm_bwd_ref(x.float(), g.float(),
                                              dy.float()))
    require(worst <= 1.0 and all(torch.equal(a, c) for a, c in
                                 zip(got, again)),
            f"rmsnorm_bwd bf16 off its plain version or not the same bits "
            f"twice: {name}")
    return time_rmsnorm_bwd(name, x, g, dy, err)


def check_recurrent_bwd_kernels(gen):
    """Phase 4's rows for phase 5i's paths: the two scan backwards, the
    bf16 flash backward at hd 80 (zamba2's shared block) and the bf16
    rmsnorm backward at the recurrent archs' widths."""
    ssd_rows = check_ssd_bwd(gen)
    slstm_rows = check_slstm_bwd(gen)
    B, T, H, KV, hd = FLASH_BWD_ZAMBA
    for (b, t, _, h, kv, _), window in (FLASH_BWD_80_CASES
                                       + [((B, T, T, H, KV, hd), 0)]):
        held = hold_flash_bwd_bf16(gen, b, t, h, kv, hd, window)
    flash_row = time_flash_bwd_bf16(**held)
    rms_rows = {d: hold_rmsnorm_bwd_bf16(gen, rows, d)
                for rows, d in RMS_BWD_RECURRENT}
    return ssd_rows, slstm_rows, flash_row, rms_rows


# --------------------------------------------------------------------------
# phase 5: serve
# --------------------------------------------------------------------------
PLAIN_ROWS = 2048       # query rows per call of the plain attention


def plain_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """``flash_attention_ref`` over blocks of ``PLAIN_ROWS`` query rows, the
    same arithmetic per row, so the fp32 scores of a 5000-token prompt (4.8
    GB at 48 heads in one call) fit beside a large model."""
    return torch.cat([flash_attention_ref(
        q[:, i:i + PLAIN_ROWS], k, v, causal=causal, window=window,
        q_offset=q_offset + i) for i in range(0, q.shape[1], PLAIN_ROWS)],
        dim=1)


class DesignAttention(torch.autograd.Function):
    """Plain attention with the flash backward's rounding by design:
    ``flash_attention_ref`` forward, and ``flash_attention_bwd_ref`` with D
    = rowsum(do * (o + o_lo)) from the forward's output and its rounding
    residual and, in bf16, P and dS rounded to bf16 where the kernels hand
    them to the tensor cores (``bf16_operands``), where autograd of the
    plain forward sums P * dP in fp32. A reference run on the card; the
    port never calls it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse, out_lo = flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            with_lse=True, with_residual=True)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        return (*flash_attention_bwd_ref(
            q, k, v, out, lse, do.contiguous(),
            bf16_operands=q.dtype == torch.bfloat16, o_lo=out_lo,
            **ctx.mask), None, None, None)


def design_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    return DesignAttention.apply(q, k, v, causal, window, q_offset)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (reference run
    on the card; the port itself never does this)."""
    saved = ops.attention, ops.norm, ops.ssd, ops.slstm
    ops.attention = plain_attention
    ops.norm = lambda x, gain, **kw: rmsnorm_ref(x, gain, **kw)
    ops.ssd = lambda x, a, B, C, **kw: ssd_scan_ref(x, a, B, C, **kw)
    ops.slstm = lambda wx, r, b: slstm_scan_ref(wx, r, b)
    try:
        yield
    finally:
        ops.attention, ops.norm, ops.ssd, ops.slstm = saved


def teacher_forced(params, cfg, prompt, forced, extra=None):
    """Logits of prefill and one decode step per forced token, [n+1, V].
    ``extra``: the prompt's modality inputs for ``prefill`` (batch 1),
    frames and patches cast to the params' dtype."""
    toks = torch.as_tensor(prompt[None], device="cuda")
    dtype = params["embed"].dtype
    extra = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in (extra or {}).items()}
    logits, cache = prefill(params, cfg, toks, pad=len(forced) + 1, **extra)
    out = [logits[0]]
    for i, tok in enumerate(forced):
        logits, cache = decode_step(
            params, cfg, torch.tensor([tok], device="cuda"), cache,
            torch.tensor([len(prompt) + i], device="cuda"))
        out.append(logits[0])
    return torch.stack(out).float()


SSD_KERNELS = {"chunks": ("ssd_scan_chunk_state_kernel",
                          "ssd_scan_chunk_pass_kernel",
                          "ssd_scan_chunk_out_kernel"),
               "walk": ("ssd_scan_intra_kernel", "ssd_scan_kernel")}


def serve(arch: str, n_layers: int, per_prefill: dict, per_step: dict,
          ssd: str = None, *, cfg=None, prompt_range=(100, 1501),
          max_seq: int = 2048, trace: bool = True, norms_per_layer=None,
          card: str = ""):
    """Serve 8 requests on ``arch`` at full width (``cfg``, default the
    registry's); require the launch counts ``per_prefill`` x prefills +
    ``per_step`` x decode steps exactly, and that the traced ssd_scan
    kernels are those of the path ``ssd``. Then the teacher-forced logits
    check, on the model itself or, where its fp32 copy does not fit beside
    it, on a depth cut or a streamed fp32 reference
    (``check_serving_logits``)."""
    cfg = cfg or get_config(arch)
    require(cfg.n_layers == n_layers and cfg.param_dtype == "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    eng = ServeEngine(cfg, params, slots=4, max_seq=max_seq, device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"serve: {arch} full width ({cfg.n_layers} layers "
        f"{dict(Counter(cfg.block_pattern))}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params, "
        f"{n_bytes / 2**30:.2f} GiB), weights+cache set up in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(*prompt_range, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]

    LAUNCHES.clear()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=32) for p in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    require(sorted(done) == rids, "not every request finished")
    require(all(len(done[r].tokens) == 32 for r in rids))
    require(all(0 <= t < cfg.vocab_size for r in rids for t in done[r].tokens))
    st = eng.stats
    want = expected_launches(per_prefill, per_step, st["prefills"],
                             st["decode_steps"])
    log(f"serve: prompt lengths {lens.tolist()}, {st['prefills']} prefills, "
        f"{st['decode_steps']} decode steps, launches {launches} "
        f"(expected {want})")
    require(launches == want, f"launch counts {launches} != {want}")
    tokens = sum(len(done[r].tokens) for r in rids)
    metrics = {
        "params_b": n_params / 1e9,
        "params_gib": n_bytes / 2**30,
        "prefill_ms_per_request": st["prefill_s"] / st["prefills"] * 1e3,
        "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
        "tokens_per_s": tokens / wall,
        "wall_s": wall,
        "generated_tokens": tokens,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"serve metrics {arch}: " + json.dumps(metrics)
        + (f" ({card})" if card else ""))

    if trace:
        traced = profile_serving(eng, prompts[:4])
        if ssd is not None:
            ran = [k for k in traced if "ssd_scan" in k]
            log(f"serve: {arch} traced ssd_scan kernels {ran}")
            names = SSD_KERNELS[ssd]
            require(all(any(n in k for k in ran) for n in names)
                    and all(any(n in k for n in names) for k in ran),
                    f"{arch} ran ssd_scan kernels {ran}, not path {ssd}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    check_serving_logits(params, cfg, prompts[0], done[rids[0]].tokens[:8],
                         per_prefill, per_step, norms_per_layer)
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"serve: {arch} done in {metrics['phase_s']:.1f} s"
        + (f" ({card})" if card else ""))
    return launches, metrics


def serve_archs(card: str) -> dict:
    """Phase 5f: the remaining decoder-only text archs served at full
    width in bf16, one model on the card at a time. mixtral-8x22b keeps 8
    of its 56 layers (all 56 take 140.6 B params), its one reduction; its
    prompts all run past the 4096-token window. Returns each path's
    launches under ``"<arch> serve"``."""
    t0 = time.perf_counter()
    out = {}
    for arch, layers, norms, prompt_range, max_seq in ARCH_SERVE:
        cfg = get_config(arch)
        if layers < cfg.n_layers:
            log(f"serve: {arch} depth cut to {layers} of {cfg.n_layers} "
                f"layers at full width (the phase's one reduction)")
            cfg = dataclasses.replace(cfg, n_layers=layers, block_pattern=())
        if cfg.sliding_window:
            require(prompt_range[0] > cfg.sliding_window,
                    "every prompt must run past the window")
        per_prefill, per_step = arch_launches(layers, norms)
        out[f"{arch} serve"], _ = serve(
            arch, layers, per_prefill, per_step, cfg=cfg,
            prompt_range=prompt_range, max_seq=max_seq,
            trace=arch == TRACED_ARCH, norms_per_layer=norms, card=card)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 5f: {time.perf_counter() - t0:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 5g: the frontend archs through prefill / decode_step
# --------------------------------------------------------------------------
# arch, prompt lengths [lo, hi), max_seq
MODAL_SERVE = (("qwen2-vl-7b", (300, 1301), 2048),
               ("whisper-small", (4, 225), 448))
MODAL_BATCH, MODAL_BATCHES, MODAL_STEPS = 4, 2, 32
VLM_GRID, VLM_AT = 16, 8          # one 16 x 16 grid of patches at 8-263


def vlm_pos3(B: int, T: int, grid: int = VLM_GRID):
    """[3, B, T] M-RoPE ids as Qwen2-VL's rope index lays out one image of
    ``grid`` x ``grid`` patches at ``VLM_AT``: text before it at
    t = h = w = i, patch (r, c) at (VLM_AT, VLM_AT + r, VLM_AT + c), text
    after it from VLM_AT + grid on."""
    end = VLM_AT + grid * grid
    ids = torch.empty(3, T, dtype=torch.long)
    ids[:, :VLM_AT] = torch.arange(VLM_AT)
    patch = torch.arange(grid * grid)
    r, c = patch // grid, patch % grid
    ids[0, VLM_AT:end] = VLM_AT
    ids[1, VLM_AT:end] = VLM_AT + r
    ids[2, VLM_AT:end] = VLM_AT + c
    ids[:, end:] = VLM_AT + grid + torch.arange(T - end)
    return ids[:, None].expand(3, B, T).contiguous().cuda()


def modal_inputs(cfg, gen, B: int, T: int) -> dict:
    """``prefill``'s modality inputs for B prompts of T tokens: whisper's
    frames [B, 1500, d], or qwen2-vl's patch embeddings [B, 256, d] at
    positions 8-263 with their M-RoPE ids; N(0, 0.02^2), bf16."""
    if cfg.enc_dec:
        return {"frames": randn(gen, B, cfg.enc_len, cfg.d_model,
                                dtype=torch.bfloat16, scale=0.02)}
    P = VLM_GRID * VLM_GRID
    return {"patch_embeds": randn(gen, B, P, cfg.d_model,
                                  dtype=torch.bfloat16, scale=0.02),
            "patch_pos": torch.arange(VLM_AT, VLM_AT + P,
                                      device="cuda")[None].expand(B, P),
            "pos3": vlm_pos3(B, T)}


def modal_launches(cfg):
    """Per prefill and per decode step. whisper: one flash a layer in the
    encoder (non-causal) and two in the decoder (self and cross); ln1 and
    ln2 a layer and enc_norm in the encoder, ln1, ln_x and ln2 a layer and
    final_norm in the decoder. qwen2-vl as any one-stage ATTN model."""
    if not cfg.enc_dec:
        return arch_launches(cfg.n_layers, 2)
    E, L = cfg.n_enc_layers, cfg.n_layers
    step = {"rmsnorm": 3 * L + 1}
    return {"flash_attention": E + 2 * L,
            "rmsnorm": 2 * E + 1 + step["rmsnorm"]}, step


def serve_modal(arch: str, prompt_range, max_seq: int, card: str):
    """One arch at full width in bf16 through ``prefill`` (with its
    modality inputs) and ``MODAL_STEPS`` greedy ``decode_step``s at a
    scalar cache_len, for ``MODAL_BATCHES`` batches of ``MODAL_BATCH``
    prompts of one length each; the exact launch counts; then the
    teacher-forced check of the first request, whole. Returns the path's
    launches and metrics."""
    cfg = get_config(arch)
    require(cfg.param_dtype == "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"serve: {arch} full width ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_len} frames"
           if cfg.enc_dec else f", M-RoPE {cfg.mrope_sections}")
        + f", d_model {cfg.d_model}, H {cfg.n_heads} KV {cfg.n_kv_heads} hd "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
        f"params, {n_bytes / 2**30:.2f} GiB) set up in "
        f"{time.perf_counter() - t_phase:.2f} s")
    per_prefill, per_step = modal_launches(cfg)
    rng = np.random.default_rng(0)
    gen = torch.Generator("cuda").manual_seed(0)
    B = MODAL_BATCH
    first = None
    prefill_s = decode_s = 0.0
    LAUNCHES.clear()
    t_all = time.perf_counter()
    for _ in range(MODAL_BATCHES):
        T = int(rng.integers(*prompt_range))
        prompts = rng.integers(0, cfg.vocab_size, (B, T))
        extra = modal_inputs(cfg, gen, B, T)
        toks = torch.as_tensor(prompts, device="cuda")
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, toks, pad=max_seq - T, **extra)
        out = [logits.argmax(-1)]
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(MODAL_STEPS):            # greedy, on the card
            logits, cache = decode_step(params, cfg, out[-1], cache, T + i)
            out.append(logits.argmax(-1))
        out = torch.stack(out, dim=1).cpu()
        decode_s += time.perf_counter() - t0
        require(torch.isfinite(logits).all(), f"{arch}: non-finite logits")
        require(bool(((out >= 0) & (out < cfg.vocab_size)).all()))
        log(f"serve: {arch} batch of {B} x {T} tokens -> {out.shape[1]} "
            f"tokens each; request 0: {out[0, :8].tolist()}")
        if first is None:
            first = (prompts[0], out[0, :8].tolist(),
                     {k: v[:, :1] if k == "pos3" else v[:1]
                      for k, v in extra.items()})
        del cache, extra
    wall = time.perf_counter() - t_all
    launches = dict(LAUNCHES)
    steps = MODAL_BATCHES * MODAL_STEPS
    want = expected_launches(per_prefill, per_step, MODAL_BATCHES, steps)
    log(f"serve: {arch} {MODAL_BATCHES} prefills, {steps} decode steps, "
        f"launches {launches} (expected {want})")
    require(launches == want, f"launch counts {launches} != {want}")
    tokens = MODAL_BATCHES * B * (MODAL_STEPS + 1)
    metrics = {
        "params_b": n_params / 1e9,
        "params_gib": n_bytes / 2**30,
        "prefill_ms_per_request": prefill_s / (MODAL_BATCHES * B) * 1e3,
        "decode_ms_per_step": decode_s / steps * 1e3,
        "tokens_per_s": tokens / wall,
        "wall_s": wall,
        "generated_tokens": tokens,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"serve metrics {arch}: " + json.dumps(metrics) + f" ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] - FP32_HEADROOM
    require(fp32_bytes(params) <= free,
            f"{arch}: its fp32 copy does not fit beside it")
    prompt, forced, extra = first
    check_teacher_forced(params, cfg, prompt, forced, per_prefill, per_step,
                         extra)
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"serve: {arch} done in {metrics['phase_s']:.1f} s ({card})")
    return launches, metrics


def serve_modal_archs(card: str) -> dict:
    """Phase 5g: qwen2-vl-7b and whisper-small at full width in bf16, one
    model on the card at a time. Returns each path's launches under
    ``"<arch> serve"``."""
    t0 = time.perf_counter()
    out = {}
    for arch, prompt_range, max_seq in MODAL_SERVE:
        out[f"{arch} serve"], _ = serve_modal(arch, prompt_range, max_seq,
                                              card)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 5g: {time.perf_counter() - t0:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 5h: nemotron-4-340b at full width, 4 of its 96 layers
# --------------------------------------------------------------------------
# arch, layers served, rmsnorm launches a layer (ln1, ln2), prompt lengths
# [lo, hi), max_seq
NEMOTRON_SERVE = ("nemotron-4-340b", 4, 2, (100, 1501), 2048)


def serve_nemotron(card: str):
    """Phase 5h: nemotron-4-340b at full width in bf16 (d 18432, GQA 96:8,
    hd 192, squared-ReLU MLP of 73728, untied vocabulary of 256000) cut to
    4 of its 96 layers, the phase's one reduction (one layer holds 3.45 B
    params, the two tables 9.44 B: all 96 layers take 341 B), served as
    phase 5f serves (8 requests, 4 slots, 32 greedy tokens, one traced
    window), its logits held by ``check_streamed``. Returns the path's
    launches under ``"<arch> serve"`` and its metrics."""
    t0 = time.perf_counter()
    arch, layers, norms, prompt_range, max_seq = NEMOTRON_SERVE
    cfg = get_config(arch)
    log(f"serve: {arch} depth cut to {layers} of {cfg.n_layers} layers at "
        f"full width (the phase's one reduction)")
    cfg = dataclasses.replace(cfg, n_layers=layers, block_pattern=())
    per_prefill, per_step = arch_launches(layers, norms)
    launches, metrics = serve(arch, layers, per_prefill, per_step, cfg=cfg,
                              prompt_range=prompt_range, max_seq=max_seq,
                              norms_per_layer=norms, card=card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 5h: {time.perf_counter() - t0:.1f} s ({card})")
    return {f"{arch} serve": launches}, metrics


def expected_launches(per_prefill, per_step, prefills, steps):
    want = Counter({k: v * prefills for k, v in per_prefill.items()})
    want.update({k: v * steps for k, v in per_step.items()})
    return dict(want)


FP32_HEADROOM = 10 * 2**30   # bytes kept free beside an fp32 copy: the
                             # activations of a 5000-token plain fp32 run
HEADROOM_TOKENS = 5000
# the depth cut of each served model whose fp32 copy does not fit beside it,
# fixed so that every run checks the same layers (nemotron-4-340b streams)
FP32_DEPTH_CUT = {"qwen3-14b": 24, "moonshot-v1-16b-a3b": 5,
                  "mixtral-8x22b": 2}


def fp32_bytes(tree) -> int:
    return sum(t.numel() * 4 for t in tree_leaves(tree))


def depth_cut(params, cfg, k: int):
    """The first ``k`` layers of a one-stage model: views of the same
    weights, with the same embed, head and final norm."""
    require(len(params["stages"]) == 1 and not cfg.shared_attn_every)
    cut = dataclasses.replace(cfg, n_layers=k, block_pattern=())
    return {**params, "stages": [tree_map(lambda t: t[:k],
                                          params["stages"][0])]}, cut


def arch_launches(L: int, norms_per_layer: int):
    """A one-stage ATTN / MOE model of L layers: one flash launch a layer
    per prefill, ``norms_per_layer`` rmsnorm launches a layer and the final
    norm per prefill and per decode step."""
    norms = norms_per_layer * L + 1
    return {"flash_attention": L, "rmsnorm": norms}, {"rmsnorm": norms}


def check_serving_logits(params, cfg, prompt, forced, per_prefill, per_step,
                         norms_per_layer=None):
    """``check_teacher_forced`` on the model where its fp32 copy fits
    beside it (with ``FP32_HEADROOM`` to spare); ``check_streamed`` where
    not even a 1-layer cut's does (nemotron's two fp32 tables alone take
    35.2 GiB). Otherwise:
    - on a depth cut, the first ``FP32_DEPTH_CUT`` layers (fixed per
      model; it must fit beside the model with the activations of a plain
      fp32 run of this prompt to spare, ``FP32_HEADROOM`` scaled to its
      length, or the check raises), which measures the bf16 noise floor
      and holds the kernel path to it in both dtypes, prefill and decode;
    - at full depth, every layer on the kernel path's own input
      (``check_layers``);
    - at full depth end to end, the kernel path's logits against its plain
      path's in bf16, within twice the cut's floor. Required for a dense
      model; logged for an MoE one, whose router turns the two paths'
      rounding differences into other experts (a discrete jump) at near
      ties, which later layers carry on: with random weights 48 such layers
      leave the two paths' logits unrelated (PERF.md §6)."""
    free = torch.cuda.mem_get_info()[0] - FP32_HEADROOM
    if fp32_bytes(params) <= free:
        check_teacher_forced(params, cfg, prompt, forced, per_prefill,
                             per_step)
        return
    require(norms_per_layer is not None, f"{cfg.name}: no depth cut given")
    stage = params["stages"][0]
    per_layer = fp32_bytes(stage) // cfg.n_layers
    rest = fp32_bytes({k: v for k, v in params.items() if k != "stages"})
    if cfg.name not in FP32_DEPTH_CUT:
        require(rest + per_layer > free, f"{cfg.name}: no fixed depth cut "
                f"in FP32_DEPTH_CUT")
        log(f"teacher-forced: not even a 1-layer cut of {cfg.name} fits in "
            f"fp32 ({(rest + per_layer) / 2**30:.1f} GiB beside "
            f"{free / 2**30:.1f} GiB free after {FP32_HEADROOM / 2**30:.0f} "
            f"GiB headroom): the fp32 reference is streamed")
        check_streamed(params, cfg, prompt, forced, per_prefill, per_step,
                       norms_per_layer)
        return
    k = FP32_DEPTH_CUT[cfg.name]
    raw = torch.cuda.mem_get_info()[0]
    headroom = FP32_HEADROOM * len(prompt) // HEADROOM_TOKENS
    need = rest + k * per_layer
    log(f"teacher-forced: {cfg.name}'s fp32 copy "
        f"({fp32_bytes(params) / 2**30:.1f} GiB) does not fit beside it "
        f"({free / 2**30:.1f} GiB free after {FP32_HEADROOM / 2**30:.0f} GiB "
        f"headroom); depth cut: the first {k} of {cfg.n_layers} layers "
        f"({need / 2**30:.1f} GiB in fp32, {raw / 2**30:.1f} GiB free, "
        f"{headroom / 2**30:.1f} GiB kept for a {len(prompt)}-token run)")
    require(k < cfg.n_layers and need + headroom <= raw,
            f"{cfg.name}: the {k}-layer fp32 cut does not fit")

    LAUNCHES.clear()
    got = teacher_forced(params, cfg, prompt, forced)
    require(dict(LAUNCHES) == expected_launches(per_prefill, per_step, 1,
                                                len(forced)),
            f"teacher-forced run launched {dict(LAUNCHES)}")
    with plain_versions():
        plain = teacher_forced(params, cfg, prompt, forced)
    require(torch.isfinite(got).all() and torch.isfinite(plain).all())
    cut_params, cut_cfg = depth_cut(params, cfg, k)
    floor = check_teacher_forced(cut_params, cut_cfg, prompt, forced,
                                 *arch_launches(k, norms_per_layer))
    check_layers(params, cfg, prompt, norms_per_layer)
    diff = float((got - plain).abs().max())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    required = not cfg.n_experts
    log(f"teacher-forced logits, full depth ({cfg.n_layers} layers, bf16): "
        f"kernel vs plain max|diff| {diff:.4e} beside max|logit| "
        f"{float(plain.abs().max()):.4e}; 2x the {k}-layer cut's bf16 noise "
        f"floor {2 * floor:.4e} ({'required' if required else 'logged: MoE'}"
        f", {'within' if diff <= 2 * floor else 'beyond'}); argmax "
        f"agreement {agree:.3f}")
    require(not required or diff <= 2 * floor,
            "full-depth kernel path disagrees with the plain path")


def check_layers(params, cfg, prompt, norms_per_layer):
    """Every layer of the full-depth model on the kernel path's own input
    (the prompt's embeddings through the layers before it, kernel path),
    as ``check_teacher_forced`` holds a whole model: the block through the
    kernels must be within twice that layer's own bf16 noise floor of the
    block through the plain versions and of the same block in fp32, the
    floor being the plain block's distance from the fp32 one (that layer's
    weights and input in fp32, one layer's copy at a time). Each layer
    launches one flash and ``norms_per_layer`` rmsnorm. For an MoE model,
    the three blocks' router inputs are kept and the routing compared
    (``router_flips``), logged per layer."""
    kind, stage = cfg.block_pattern[0], params["stages"][0]
    toks = torch.as_tensor(prompt[None], device="cuda")
    pos = torch.arange(toks.shape[1], device="cuda")[None]
    ratios, worst = [], (0.0, 0.0, 0.0, -1)
    routing = []
    LAUNCHES.clear()
    with torch.no_grad():
        h = embed_tokens(params, cfg, toks)
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], stage)
            inputs = []
            with router_inputs(inputs):
                got, _ = block_forward(kind, lp, cfg, h, pos=pos)
                with plain_versions():
                    plain, _ = block_forward(kind, lp, cfg, h, pos=pos)
                    ref, _ = block_forward(kind, tree_map(lambda t: t.float(),
                                                          lp),
                                           cfg, h.float(), pos=pos)
            if inputs:
                routing.append(router_flips(lp["moe"]["router"], cfg,
                                            *inputs))
            del inputs
            require(torch.isfinite(got).all(), f"layer {i}: non-finite")
            diff = float((got.float() - plain.float()).abs().max())
            to32 = float((got.float() - ref).abs().max())
            floor = float((plain.float() - ref).abs().max())
            ratios.append(max(diff, to32) / max(floor, 1e-30))
            if ratios[-1] >= max(ratios):
                worst = (diff, to32, floor, i)
            require(max(diff, to32) <= 2 * floor,
                    f"layer {i}: kernel block {diff:.4e} from the plain "
                    f"block and {to32:.4e} from fp32, beyond 2x its floor "
                    f"{floor:.4e}")
            h = got
            del got, plain, ref
    want = {"flash_attention": cfg.n_layers,
            "rmsnorm": norms_per_layer * cfg.n_layers}
    require(dict(LAUNCHES) == want, f"layer check launched {dict(LAUNCHES)}")
    log(f"layer check, full depth ({cfg.n_layers} layers, prompt "
        f"{toks.shape[1]}): kernel block vs plain block and vs fp32 within "
        f"2x each layer's bf16 floor; the larger of the two over the floor "
        f"by layer {[round(r, 3) for r in ratios]}; worst layer {worst[3]}: "
        f"{worst[0]:.4e} from plain, {worst[1]:.4e} from fp32, floor "
        f"{worst[2]:.4e}; final |h| {float(h.float().abs().max()):.4e}")
    if routing:
        log_routing(routing, cfg, toks.shape[1])


@contextlib.contextmanager
def router_inputs(store: list):
    """Keep each MoE block's router input (``moe_forward``'s x) in
    ``store`` while the blocks run."""
    saved = model_blocks.moe_forward

    def recording(p, cfg, x, inference=False):
        store.append(x)
        return saved(p, cfg, x, inference=inference)

    model_blocks.moe_forward = recording
    try:
        yield
    finally:
        model_blocks.moe_forward = saved


def router_flips(router, cfg, x_kernel, x_plain, x32):
    """The (token, k) router choices in which the kernel block and the
    plain block differ on the same layer input (their router inputs
    ``x_kernel`` and ``x_plain``, bf16; ``x32`` the fp32 block's), taken
    as ``moe_forward`` takes them: fp32 logits of x and the router in x's
    dtype, top-k of their softmax. For each token whose choices differ:
    the plain router's margin between them (the smallest plain logit of an
    expert only the plain block chose minus the largest of one only the
    kernel block chose; a swap needs that gap crossed) and the router's
    bf16 rounding at that token, max |plain logits - fp32 block's logits|
    over the experts. Returns (choices that differ, choices in all,
    margins, roundings)."""
    def logits(x):
        xf = x.reshape(-1, x.shape[-1])
        return matmul(xf, router.to(xf.dtype), out_dtype=torch.float32)

    lk, lp, l32 = logits(x_kernel), logits(x_plain), logits(x32)
    E = lp.shape[-1]

    def chosen(lg):
        top = torch.softmax(lg, dim=-1).topk(cfg.top_k, dim=-1).indices
        return torch.zeros(lg.shape[0], E, dtype=torch.bool,
                           device=lg.device).scatter_(1, top, True)

    ck, cp = chosen(lk), chosen(lp)
    only_k, only_p = ck & ~cp, cp & ~ck
    rows = only_k.any(dim=-1)
    margin = (torch.where(only_p, lp, math.inf).amin(dim=-1)
              - torch.where(only_k, lp, -math.inf).amax(dim=-1))[rows]
    rounding = (lp - l32).abs().amax(dim=-1)[rows]
    return (int(only_k.sum()), int(ck.sum()), margin.tolist(),
            rounding.tolist())


def log_routing(routing, cfg, T: int):
    """Per layer, the router choices in which the kernel and plain blocks
    differ, and whether each is a tie: its margin within twice the
    router's bf16 rounding at its token (the layer check's rule)."""
    per_layer, wide = [], []
    for i, (n, total, margins, roundings) in enumerate(routing):
        per_layer.append(n)
        for m, r in zip(margins, roundings):
            if m > 2 * r:
                wide.append(f"layer {i}: margin {m:.4e}, rounding {r:.4e}")
    pairs = [(m, r) for _, _, ms, rs in routing for m, r in zip(ms, rs)]
    worst = max((m / max(r, 1e-30) for m, r in pairs), default=0.0)
    log(f"router choices, full depth ({cfg.n_layers} layers, top {cfg.top_k} "
        f"of {cfg.n_experts}, {T} tokens = {routing[0][1]} choices a "
        f"layer): kernel block vs plain block differ in {sum(per_layer)} "
        f"choices, by layer {per_layer}; {len(pairs)} tokens with a "
        f"differing choice, largest margin / bf16 rounding {worst:.3f}; "
        + (f"{len(wide)} NOT ties (margin > 2x rounding): {wide}" if wide
           else "every one a tie (margin <= 2x the router's bf16 rounding)"))
    if pairs:
        log("  (margin, rounding) by token: " + ", ".join(
            f"({m:.3e}, {r:.3e})" for m, r in pairs[:64])
            + (" ..." if len(pairs) > 64 else ""))


def check_teacher_forced(params, cfg, prompt, forced, per_prefill, per_step,
                         extra=None):
    """The kernel path's logits against the same model through the plain
    versions on the card, in bf16 and in fp32, and both bf16 paths against
    the fp32 plain run.

    Tolerance: the bf16 noise floor of this run, which is the plain bf16
    path's own distance from fp32. In bf16 the kernel path must be within
    twice that of the plain path and of fp32; in fp32, where both paths see
    the same fp32 activations and differ only in summation order, the
    kernel path must be within the floor itself of the plain path. A wrong
    mask, norm or state moves the logits by far more than rounding does.
    """
    LAUNCHES.clear()
    got = teacher_forced(params, cfg, prompt, forced, extra)
    require(dict(LAUNCHES) == expected_launches(per_prefill, per_step, 1,
                                                len(forced)),
            f"teacher-forced run launched {dict(LAUNCHES)}")
    mid = dict(LAUNCHES)
    params32 = tree_map(lambda t: t.float(), params)
    with plain_versions():
        plain = teacher_forced(params, cfg, prompt, forced, extra)
        ref32 = teacher_forced(params32, cfg, prompt, forced, extra)
    require(dict(LAUNCHES) == mid, "the plain reference launched a kernel")
    got32 = teacher_forced(params32, cfg, prompt, forced, extra)
    del params32
    return hold_logits(got, plain, ref32, got32, cfg, prompt, forced)


def hold_logits(got, plain, ref32, got32, cfg, prompt, forced) -> float:
    """The teacher-forced logits [n+1, V] of the kernel path (``got``) and
    the plain path (``plain``) in bf16, and of both paths on fp32 weights
    (``got32``, ``ref32``: plain versions), held as
    ``check_teacher_forced`` says; returns the bf16 noise floor."""
    shape = (len(forced) + 1, cfg.vocab_size)
    require(all(t.shape == shape for t in (got, plain, ref32, got32)))
    require(torch.isfinite(got).all() and torch.isfinite(got32).all())
    diff = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    to32 = float((got - ref32).abs().max())
    floor = float((plain - ref32).abs().max())
    diff32 = float((got32 - ref32).abs().max())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    top2 = plain.float().topk(2, dim=-1).values
    flipped = (got.argmax(-1) != plain.argmax(-1)).nonzero().flatten()
    flips = [f"{int(i)}: {float(top2[i, 0] - top2[i, 1]):.4e}"
             for i in flipped]
    log_flips(got, plain, ref32, flipped)
    log(f"teacher-forced logits (prefill + {len(forced)} decode steps, "
        f"prompt {len(prompt)}): kernel vs plain max|diff| {diff:.4e} beside "
        f"max|logit| {scale:.4e} (ratio {diff / scale:.4e}); kernel vs fp32 "
        f"{to32:.4e}; bf16 noise floor (plain vs fp32) {floor:.4e}, tol "
        f"2x that; argmax agreement {agree:.3f} (plain path's top-2 margin "
        f"where they differ, by position: {flips}); fp32 weights: kernel "
        f"vs plain {diff32:.4e}, tol the floor")
    require(diff <= 2 * floor, "kernel path disagrees with the plain path")
    require(to32 <= 2 * floor, "kernel path further from fp32 than plain")
    require(diff32 <= floor, "fp32 kernel path disagrees with fp32 plain")
    return floor


VOCAB_CHUNK = 16384     # head rows upcast at a time: 1.1 GiB in fp32 at d 18432


def gib_free(device) -> str:
    if device.type != "cuda":
        return "host memory"
    return f"{torch.cuda.mem_get_info(device)[0] / 2**30:.1f} GiB free"


def streamed_logits(params, cfg, prompt, forced, vocab_chunk=VOCAB_CHUNK):
    """fp32 teacher-forced logits [n+1, V] of a one-stage model whose fp32
    copy does not fit beside it, with its weights kept in bf16 and only
    what a step reads upcast (bf16 -> fp32 is exact): the embedding rows of
    the prompt and the forced tokens, run as one causal sequence (row P-1+i
    is what prefill, then decode step i, predicts), each layer's fp32 copy
    in turn, then the final norm and the head one ``vocab_chunk`` rows at a
    time, rounded to bf16 as ``lm_logits`` rounds them. The layers run
    twice on each copy, through the plain versions and through the kernels
    (on the card: the fp32 flash forward and rmsnorm). Logs the memory
    free at each step. Returns (plain, kernel)."""
    require(len(params["stages"]) == 1 and not cfg.shared_attn_every
            and not cfg.enc_dec, f"{cfg.name}: not a one-stage model")
    dev = params["embed"].device
    seq = np.concatenate([prompt, np.asarray(forced, dtype=prompt.dtype)])
    seq = torch.as_tensor(seq[None], device=dev)
    pos = torch.arange(seq.shape[1], device=dev)[None]
    kind, stage = cfg.block_pattern[0], params["stages"][0]
    steps = []
    with torch.no_grad():
        h = embed_tokens(params, cfg, seq).float()
        hs = {"plain": h, "kernel": h}
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i].float(), stage)
            steps.append(f"layer {i} in fp32: {gib_free(dev)}")
            with plain_versions():
                hs["plain"], _ = block_forward(kind, lp, cfg, hs["plain"],
                                               pos=pos)
            hs["kernel"], _ = block_forward(kind, lp, cfg, hs["kernel"],
                                            pos=pos)
            del lp
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        gain = params["final_norm"].float()
        out = {}
        for name, h in hs.items():
            norm_ctx = (plain_versions() if name == "plain"
                        else contextlib.nullcontext())
            with norm_ctx:
                hn = rms_norm(h[0, len(prompt) - 1:], gain, cfg.norm_eps)
            logits = torch.empty(hn.shape[0], cfg.vocab_size, device=dev)
            for c in range(0, cfg.vocab_size, vocab_chunk):
                w = head[c:c + vocab_chunk].float()
                logits[:, c:c + vocab_chunk] = (hn @ w.T).to(
                    torch.bfloat16).float()
                del w
            out[name] = logits
            steps.append(f"{name} head in fp32 chunks of {vocab_chunk}: "
                         f"{gib_free(dev)}")
    log(f"streamed fp32 reference of {cfg.name} ({cfg.n_layers} layers, "
        f"{seq.shape[1]} positions): " + "; ".join(steps))
    return out["plain"], out["kernel"]


def check_streamed(params, cfg, prompt, forced, per_prefill, per_step,
                   norms_per_layer):
    """The teacher-forced check of a model that holds no fp32 copy, not
    even a 1-layer cut's (its tables alone do not fit): the kernel path's
    and the plain path's bf16 logits (prefill and one decode step per
    forced token) against ``streamed_logits``' fp32 reference, held by
    ``check_teacher_forced``'s rule (``hold_logits``; its fp32 kernel path
    is the streamed run through the kernels, which must launch one flash
    and ``norms_per_layer`` rmsnorm a layer and the final norm); then every
    layer on the kernel path's own input (``check_layers``)."""
    dev = params["embed"].device
    LAUNCHES.clear()
    got = teacher_forced(params, cfg, prompt, forced)
    require(dict(LAUNCHES) == expected_launches(per_prefill, per_step, 1,
                                                len(forced)),
            f"teacher-forced run launched {dict(LAUNCHES)}")
    with plain_versions():
        plain = teacher_forced(params, cfg, prompt, forced)
    log(f"teacher-forced bf16 runs of {cfg.name} done: {gib_free(dev)}")
    LAUNCHES.clear()
    ref32, got32 = streamed_logits(params, cfg, prompt, forced)
    want = arch_launches(cfg.n_layers, norms_per_layer)[0]
    require(dict(LAUNCHES) == want,
            f"streamed fp32 run launched {dict(LAUNCHES)}, not {want}")
    hold_logits(got, plain, ref32, got32, cfg, prompt, forced)
    check_layers(params, cfg, prompt, norms_per_layer)


def log_flips(got, plain, ref32, flipped):
    """At each position where the kernel path's greedy token differs from
    the plain path's: the three paths' tokens, the fp32 path's (``ref32``:
    fp32 weights, plain versions) top-2 margin beside the bf16 ulp of its
    top logit and the bf16 noise floor at that position (max |plain -
    ref32| over the vocab), and whether the flip is a tie: the kernel's
    token is the fp32 path's, or the fp32 margin is within that floor."""
    for i in flipped.tolist():
        top = ref32[i].topk(2)
        margin = float(top.values[0] - top.values[1])
        ulp = 2.0 ** (math.floor(math.log2(abs(float(top.values[0])))) - 7)
        floor = float((plain[i] - ref32[i]).abs().max())
        tokens = [int(t[i].argmax()) for t in (got, plain, ref32)]
        tie = tokens[0] == tokens[2] or margin <= floor
        log(f"  flip at position {i}: tokens kernel {tokens[0]}, plain "
            f"{tokens[1]}, fp32 {tokens[2]} (fp32 runner-up "
            f"{int(top.indices[1])}); fp32 top-2 margin {margin:.4e}, bf16 "
            f"ulp of its top logit {ulp:.4e}, bf16 noise floor there "
            f"{floor:.4e}: {'a tie' if tie else 'NOT a tie'}")


# the MoE's routing, sort, gathers and combine (models/mlp.py): top-k,
# the stable argsort (cub radix sort), bincount, cumsum, index_select,
# scatter_ / gather. Grouped only for a model with experts: index_select
# is also the embedding lookup's kernel (one small launch a step)
MOE_KERNELS = ("topk", "sort", "radix", "histogram", "scan", "indexselect",
               "index_select", "scatter_gather")


def profile_serving(eng, prompts):
    """Trace the engine serving a few more requests: device busy share of
    the window and device time by kernel. The tracer records the card's
    activity only (no host ops), so its own host cost is small; it still
    makes the idle share an upper bound. Returns the traced kernels'
    names."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, max_new=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    groups = {"flash_attention": 0.0, "rmsnorm": 0.0, "ssd_scan": 0.0,
              "slstm_scan": 0.0, "matmul": 0.0, "moe dispatch": 0.0,
              "other": 0.0}
    moe = Counter()
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "flash_fwd" in name else
                 "rmsnorm" if "rmsnorm_kernel" in name else
                 "ssd_scan" if "ssd_scan" in name else
                 "slstm_scan" if "slstm_scan_kernel" in name else
                 "matmul" if any(w in name for w in ("gemm", "cutlass",
                                                      "xmma", "sm90_",
                                                      "nvjet"))
                 else "moe dispatch" if eng.cfg.n_experts and any(
                     w in name for w in MOE_KERNELS)
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
        if group == "moe dispatch":
            moe[e.key[:60]] += e.self_device_time_total / 1e3
    cuda_core = [e.key for e in kernels if "flash_fwd_kernel" in e.key]
    require(not cuda_core, f"bf16 serving ran the fp32 flash kernel: {cuda_core}")
    copies = sum(e.self_device_time_total for e in kernels
                 if "direct_copy" in e.key) / 1e3
    log(f"profile: {len(prompts)} requests x 8 tokens (traced), wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}), {len(kernels)} kernel names; device ms by "
        f"group {json.dumps({k: round(v, 3) for k, v in groups.items()})}; "
        f"direct_copy kernels (in other) {copies:.3f} ms")
    if moe:
        log("  moe dispatch kernels (ms): " + json.dumps(
            {k: round(v, 3) for k, v in moe.most_common()}))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    return [e.key for e in kernels]


# --------------------------------------------------------------------------
# phase 5b: training, the sweep's member step
# --------------------------------------------------------------------------
TRAIN_LR = 1e-3
TRAIN_STEPS = 8
TRAIN_BATCH = (4, 512)
SWEEP_MEMBERS, SWEEP_STEPS = 16, 5           # launch/sweep.py's defaults
B1, B2, ADAM_EPS, WD = 0.9, 0.95, 1e-8, 0.1  # adamw_update's defaults
LOSS_RTOL = 1e-5      # kernel step vs plain step on the card, fp32
GNORM_RTOL = 1e-4
LEAF_GRAD_TOL = 1e-3  # of each gradient leaf's largest magnitude


def train_launches(n_layers: int) -> dict:
    """One member step's launches: a flash call and its backward per layer,
    ln1, q_norm, k_norm, ln2 per layer and final_norm, each with its
    backward."""
    norms = 4 * n_layers + 1
    return {"flash_attention": n_layers, "flash_attention_bwd": n_layers,
            "rmsnorm": norms, "rmsnorm_bwd": norms}


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from named_leaves(sub, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, f"{prefix}/{i}")
    else:
        yield prefix, tree


def first_step(params, cfg, batch, lr):
    """One member step from fresh moments, in its parts: (loss, grads, grad
    norm); the params are updated in place."""
    loss, grads = loss_and_grads(params, cfg, batch)
    _, _, gnorm = adamw_update(grads, adamw_init(params), params, lr=lr)
    return float(loss), grads, float(gnorm)


def adam_first_step64(g, p, clip, lr):
    """A first AdamW step of one leaf in float64 from zero moments, and the
    magnitude of its terms (the scale of its fp32 rounding)."""
    g, p = g.double() * clip, p.double()
    m, v = (1 - B1) * g, (1 - B2) * g * g
    step = (m / (1 - B1)) / (torch.sqrt(v / (1 - B2)) + ADAM_EPS)
    if p.dim() >= 2:
        step = step + WD * p
    return p - lr * step, p.abs() + lr * step.abs()


def check_train_step_vs_plain(label, cfg, base, batch):
    """One member step with the kernels against the same step through the
    plain versions on the card, from the same params and batch: loss, grad
    norm, every gradient leaf and every updated leaf. The updated leaves are
    held to 1e-6 of their terms plus what the two runs' gradients move a
    first Adam step by (float64): that step is ~g/|g| elementwise, so where
    |g| is within the gradients' agreement its sign is noise and the two
    updates may differ by up to 2 lr."""
    want_launches = train_launches(len(cfg.block_pattern))
    LAUNCHES.clear()
    kernel = clone_tree(base)
    loss_k, grads_k, gn_k = first_step(kernel, cfg, batch, TRAIN_LR)
    torch.cuda.synchronize()
    require(dict(LAUNCHES) == want_launches,
            f"kernel step launched {dict(LAUNCHES)}, not {want_launches}")
    plain = clone_tree(base)
    with plain_versions():
        loss_p, grads_p, gn_p = first_step(plain, cfg, batch, TRAIN_LR)
    require(dict(LAUNCHES) == want_launches,
            "the plain step launched a kernel")
    loss_err, gn_err = abs(loss_k - loss_p) / loss_p, abs(gn_k - gn_p) / gn_p
    grad_err, upd_err, noisy, n = 0.0, 0.0, 0, 0
    clip_k, clip_p = min(1.0, 1.0 / gn_k), min(1.0, 1.0 / gn_p)
    for (path, gk), (_, gp), (_, p0), (_, pk), (_, pp) in zip(
            named_leaves(grads_k), named_leaves(grads_p), named_leaves(base),
            named_leaves(kernel), named_leaves(plain)):
        err = float((gk - gp).abs().max() / gp.abs().max())
        grad_err = max(grad_err, err)
        require(err <= LEAF_GRAD_TOL, f"gradient {path}: {err:.3e} of its max")
        ref_k, terms = adam_first_step64(gk, p0, clip_k, TRAIN_LR)
        ref_p, _ = adam_first_step64(gp, p0, clip_p, TRAIN_LR)
        diff = (pk.detach().double() - pp.detach().double()).abs()
        tol = 1e-6 * terms + (ref_k - ref_p).abs()
        require(bool((diff <= tol).all()),
                f"updated {path} off the plain step")
        upd_err = max(upd_err, float(diff.max()) / TRAIN_LR)
        noisy += int((diff > 1e-3 * TRAIN_LR).sum())
        n += diff.numel()
    log(f"train check {label}, one step kernels vs plain versions: loss "
        f"{loss_k:.6f} "
        f"vs {loss_p:.6f} (rel {loss_err:.2e}, tol {LOSS_RTOL:.0e}); grad "
        f"norm {gn_k:.6f} vs {gn_p:.6f} (rel {gn_err:.2e}, tol "
        f"{GNORM_RTOL:.0e}); worst gradient leaf {grad_err:.2e} of its max "
        f"(tol {LEAF_GRAD_TOL:.0e}); updated leaves within tolerance, largest "
        f"difference {upd_err:.3f} lr, {noisy} of {n} elements differ by more "
        f"than 1e-3 lr (Adam's sign noise where |g| ~ 0)")
    require(loss_err <= LOSS_RTOL,
            "training loss disagrees with the plain run")
    require(gn_err <= GNORM_RTOL, "grad norm disagrees with the plain run")


FP32_GEMM = ("sgemm", "f32f32_f32f32", "nvjet_sss", "gemm_f32")  # names
# of fp32-operand GEMMs (TF32 is off); the bf16 ones with an fp32 output
# stay in "matmul"
TRAIN_MOE_KERNELS = MOE_KERNELS + ("gather", "index", "catarray")


def profile_train_step(step_once, expect, moe=False):
    """Trace one training step (``step_once()`` runs one and returns its
    loss): device busy share and device ms by group, the card's activity
    only, as ``profile_serving`` traces it. The tracer runs through
    a warm-up step first and records only the second step, so no kernel
    launched while it starts is missed; the log says whether the recorded
    step holds the kernel launches ``expect`` counts ({name prefix: count},
    a flash forward and the backward's dq kernel). ``moe`` keeps the
    dispatch's gathers, sorts and top-k in a group of their own."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            float(step_once())
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = [e for e in prof.key_averages()    # not the step's own span
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    traced = Counter()
    for e in kernels:
        for name in expect:
            if name in e.key:
                traced[name] += e.count
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = dict.fromkeys(("flash fwd", "flash bwd", "rmsnorm fwd",
                            "rmsnorm bwd", "scan fwd", "scan bwd", "matmul",
                            "matmul fp32", "other")
                           + (("moe dispatch",) if moe else ()), 0.0)
    for e in kernels:
        name = e.key.lower()
        gemm = any(w in name for w in ("gemm", "cutlass", "xmma", "sm90_",
                                       "nvjet"))
        group = ("scan bwd" if "ssd_bwd" in name or "slstm_bwd" in name else
                 "scan fwd" if "ssd_scan" in name or "slstm_scan" in name else
                 "flash fwd" if "flash_fwd" in name else
                 "flash bwd" if "flash_bwd" in name else
                 "rmsnorm bwd" if "rmsnorm_bwd" in name else
                 "rmsnorm fwd" if "rmsnorm_kernel" in name else
                 "matmul fp32" if gemm and any(w in name for w in FP32_GEMM)
                 else "matmul" if gemm
                 else "moe dispatch" if moe and any(
                     w in name for w in TRAIN_MOE_KERNELS)
                 else "other")
        groups[group] += e.self_device_time_total / 1e3
    require(kernels, "the traced step shows no device time")
    complete = dict(traced) == expect
    log(f"train profile: traced kernels {dict(traced)} of {expect} "
        f"per step: {'complete' if complete else 'INCOMPLETE'} trace")
    log(f"train profile: one traced step, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), {len(kernels)} kernel names; "
        f"device ms by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    return {"traced_step_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms, "device_ms_by_group": groups}


def train_full_width():
    """qwen3-0.6b at full width in fp32, the sweep member's dtype: the
    kernel step against the plain one, then ``TRAIN_STEPS`` member steps on
    one fixed batch with exact launch counts per step and a falling loss,
    then one traced step. Returns (launches of the steps, metrics)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), param_dtype="float32",
                              remat="none")
    require(cfg.block_pattern == ("attn",) * QWEN_LAYERS
            and cfg.head_dim == 128)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    n_params = sum(t.numel() for _, t in named_leaves(params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = to_batch({"tokens": tokens, "labels": tokens}, "cuda")
    log(f"train: {cfg.name} full width ({cfg.n_layers} ATTN layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, tied), fp32 params from "
        f"seed 0: {n_params / 1e6:.1f} M ({n_params * 4 / 2**30:.2f} GiB); "
        f"batch {TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}, lr {TRAIN_LR}; TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = False), so the fp32 GEMMs "
        "run in full fp32 as the CPU parity holds them")
    check_train_step_vs_plain("qwen3-0.6b full width", cfg, params, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = build_member_step(cfg, device="cuda")
    opt = adamw_init(params)
    want = train_launches(cfg.n_layers)
    losses, step_ms, launches = [], [], Counter()
    for i in range(TRAIN_STEPS):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, TRAIN_LR)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        require(dict(LAUNCHES) == want,
                f"step {i} launched {dict(LAUNCHES)}, not {want}")
        launches.update(LAUNCHES)
        log(f"train step {i}: loss {losses[-1]:.6f}, {step_ms[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(x) for x in losses), "non-finite training loss")
    require(losses[-1] < 0.9 * losses[0],
            f"loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    metrics = {"loss_first": losses[0], "loss_last": losses[-1],
               "step_ms_median": float(np.median(step_ms[1:])),
               "step_ms": step_ms, "peak_mem_gib": peak,
               "launches_per_step": want}
    log("train metrics qwen3-0.6b fp32 full width: " + json.dumps(metrics))
    state = [params, opt]

    def step_once():
        state[0], state[1], loss = step(*state, batch, TRAIN_LR)
        return loss
    metrics.update(profile_train_step(step_once, {
        "flash_fwd_kernel<": cfg.n_layers,
        "flash_bwd_dq_kernel<": cfg.n_layers}))
    return dict(launches), metrics


SERVE_TRAINED_TICKS = 20


def check_serving_trained(cfg, params, device="cuda"):
    """Serve params straight from training (2 slots, prompts of 9 and 23
    tokens, 40 new tokens each, ``SERVE_TRAINED_TICKS`` ticks): no param
    leaf requires grad, no cache leaf has a ``grad_fn`` (the engine records
    no graph), and the tokens equal an engine's on a detached copy."""
    require(not any(t.requires_grad for t in tree_leaves(params)),
            "a param leaf requires grad after a member step")

    def run(p):
        eng = ServeEngine(cfg, p, slots=2, max_seq=128, device=device)
        rng = np.random.default_rng(0)
        for n in (9, 23):
            eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=40)
        reqs = list(eng.queue)
        for _ in range(SERVE_TRAINED_TICKS):
            eng.tick()
        return [list(r.tokens) for r in reqs], eng.cache

    tokens, cache = run(params)
    leaves = tree_leaves(cache)
    graphs = sum(t.grad_fn is not None or t.requires_grad for t in leaves)
    want, _ = run(clone_tree(params))
    log(f"serve after training: {SERVE_TRAINED_TICKS} ticks, "
        f"{sum(map(len, tokens))} tokens; {graphs} of {len(leaves)} cache "
        f"leaves carry autograd state; tokens "
        f"{'equal' if tokens == want else 'DIFFER from'} those of an engine "
        "on a detached copy")
    require(graphs == 0, "serving trained params recorded an autograd graph")
    require(tokens == want, "serving trained params changed the tokens")


def train_sweep():
    """The sweep's own member (``member_config``: 4 ATTN layers, hd 32,
    vocab 256, fp32): ``SWEEP_MEMBERS`` members of ``SWEEP_STEPS`` steps on
    ``SyntheticLM`` batches at the sweep's learning rates, one after another
    in-process, each from the same base params, after one member step with
    the kernels is held against the same step through the plain versions.
    Returns (launches, metrics)."""
    cfg = member_config("qwen3-0.6b")
    require(cfg.block_pattern == ("attn",) * 4 and cfg.head_dim == 32)
    base = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                       device="cuda")
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    batches = [to_batch(src.batch(i), "cuda") for i in range(SWEEP_STEPS)]
    check_train_step_vs_plain("sweep member", cfg, base, batches[0])
    step = build_member_step(cfg, device="cuda")
    lrs = np.geomspace(1e-4, 3e-2, SWEEP_MEMBERS)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    finals = []
    for lr in lrs:
        params = clone_tree(base)
        opt = adamw_init(params)
        for batch in batches:
            params, opt, loss = step(params, opt, batch, float(lr))
        finals.append(float(loss))
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {k: v * SWEEP_MEMBERS * SWEEP_STEPS
            for k, v in train_launches(len(cfg.block_pattern)).items()}
    log(f"sweep: {SWEEP_MEMBERS} members x {SWEEP_STEPS} steps of "
        f"{cfg.name} (4 ATTN layers, d_model {cfg.d_model}, hd "
        f"{cfg.head_dim}, fp32) in {wall:.2f} s "
        f"({wall / (SWEEP_MEMBERS * SWEEP_STEPS) * 1e3:.2f} ms per step); "
        f"launches {launches} (expected {want})")
    log("sweep final losses by lr: " + ", ".join(
        f"{lr:.2e}: {x:.4f}" for lr, x in zip(lrs, finals)))
    require(launches == want, f"sweep launch counts {launches} != {want}")
    require(all(math.isfinite(x) for x in finals), "a member's loss is not "
            "finite")
    require(min(finals) < math.log(cfg.vocab_size),
            "no member's loss fell below the uniform guess")
    check_serving_trained(cfg, params)
    return launches, {"members": SWEEP_MEMBERS, "steps": SWEEP_STEPS,
                      "wall_s": wall, "final_losses": finals}


# --------------------------------------------------------------------------
# phase 5c: the sweep's command line (preposition, supervisor, task array)
# --------------------------------------------------------------------------
SWEEP_CLI_TIMEOUT = 300         # seconds; the CLI takes well under a minute
FULL_GRID = ({"lr": 1e-3}, {"lr": 1e-3}, {"lr": 3e-4})
FULL_STEPS = 3
SWEEP_LOSS_RTOL = 1e-6


def sweep_cli():
    """``python -m repro_torch.launch.sweep`` as a user runs it (qwen3-0.6b,
    16 members x 5 steps on the card), in a fresh process that finds the
    kernels' library phase 2 built. Returns its metrics."""
    proc, wall = run_module(["repro_torch.launch.sweep"], "cli",
                            SWEEP_CLI_TIMEOUT)
    require(proc.returncode == 0, f"the sweep CLI exited {proc.returncode}")
    want = f"launched {SWEEP_MEMBERS}/{SWEEP_MEMBERS} members"
    require(want in proc.stdout, f"the sweep CLI did not print {want!r}")
    prep = re.search(r"prepositioned in ([0-9.]+)s", proc.stdout)
    rate = re.search(r"members x \d+ steps in ([0-9.]+)s \(([0-9.]+)/s",
                     proc.stdout)
    require(prep and rate, "the sweep CLI's lines did not parse")
    metrics = {"process_wall_s": wall,
               "prepositioned_s": float(prep.group(1)),
               "sweep_s": float(rate.group(1)),
               "members_per_s": float(rate.group(2))}
    log("sweep cli metrics: " + json.dumps(metrics))
    return metrics


def sweep_in_process(want_finals):
    """``run_sweep`` with the CLI's defaults in this process: the warm cache
    holds one entry hit once per member, the array runs 16 of 16, the
    launches are exactly one warm step and 80 member steps, the
    prepositioned params come out as they went in, and the final losses are
    ``train_sweep``'s (same seed, batches and kernels). Returns (launches,
    metrics)."""
    cfg = member_config("qwen3-0.6b")
    LAUNCHES.clear()
    run = run_sweep(cfg, SWEEP_MEMBERS, SWEEP_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    sup, arr = run.supervisor, run.result["sweep"]
    stats = dict(sup.warmer.stats)
    devices = sup.devices[:1]                 # run_sweep's member devices
    entry = sup.warmer.get(cfg, SHAPES["train_4k"], devices)
    want = {k: v * (1 + SWEEP_MEMBERS * SWEEP_STEPS)
            for k, v in train_launches(len(cfg.block_pattern)).items()}
    finals = [m["loss"] for m in run.members]
    errs = [abs(a - b) / abs(b) for a, b in zip(finals, want_finals)]
    base = sup.weights.get(cfg, devices, 0)
    fresh = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(base), tree_leaves(fresh)))
    launch_ms = [1e3 * m["launch_s"] for m in run.members]
    metrics = {"members": SWEEP_MEMBERS, "steps": SWEEP_STEPS,
               "preposition_s": run.preposition_s,
               "build_s": entry.build_s, "first_step_s": entry.first_step_s,
               "sweep_s": run.wall_s,
               "members_per_s": SWEEP_MEMBERS / run.wall_s,
               "member_step_ms": run.wall_s / (SWEEP_MEMBERS * SWEEP_STEPS)
               * 1e3,
               "launch_ms": launch_ms, "report": sup.launch_report()}
    log(f"sweep in process: {arr.summary}; warm cache {stats}; launches "
        f"{launches} (expected {want}); base params "
        f"{'unchanged' if unchanged else 'CHANGED'}; final losses vs "
        f"train_sweep's: worst rel {max(errs):.2e} (tol "
        f"{SWEEP_LOSS_RTOL:.0e}), "
        f"{'bit-equal' if finals == want_finals else 'not bit-equal'}")
    log("sweep in process metrics: " + json.dumps(metrics))
    require(stats == {"warms": 1, "hits": SWEEP_MEMBERS, "misses": 0},
            f"warm cache stats {stats}")
    require(arr.summary.ok == SWEEP_MEMBERS and arr.summary.failed == 0,
            f"sweep array {arr.summary}")
    require(launches == want, f"sweep launch counts {launches} != {want}")
    require(unchanged, "the sweep changed the prepositioned params")
    require(max(errs) <= SWEEP_LOSS_RTOL,
            "the in-process sweep's losses differ from train_sweep's")
    return launches, metrics


def sweep_full_width(step0_loss):
    """The supervisor at full width: qwen3-0.6b fp32, 28 layers, seed-0
    params and phase 5b's fixed batch, prepositioned through the warm cache,
    then 3 members of 3 steps launched one at a time under the default quota
    of one card, each from its own clone. Returns (launches, metrics)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), param_dtype="float32",
                              remat="none")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               TRAIN_BATCH)
    batch = to_batch({"tokens": tokens, "labels": tokens}, "cuda")
    shape = SHAPES["train_4k"]
    sup = SweepSupervisor()
    devices = sup.devices[:1]

    def seeded(seed):
        return init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                           device="cuda")

    def build():
        def make_args():
            params = seeded(1)
            return params, adamw_init(params), batch, TRAIN_LR
        return build_member_step(cfg, device="cuda"), make_args

    LAUNCHES.clear()
    t0 = time.perf_counter()
    entry = sup.preposition(cfg, shape, devices, build,
                            init=lambda: seeded(0))
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    base = sup.weights.get(cfg, devices, 0)

    def run_member(entry, member):
        params = tree_map(torch.clone, base)
        opt = adamw_init(params)
        losses, ms = [], []
        for _ in range(FULL_STEPS):
            t = time.perf_counter()
            params, opt, loss = entry.step(params, opt, batch,
                                           member.hparams["lr"])
            losses.append(float(loss))
            ms.append((time.perf_counter() - t) * 1e3)
        return {"losses": losses, "step_ms": ms}

    members = []
    for hp in FULL_GRID:
        [m] = sup.launch_sweep(cfg, shape, devices, [hp], run_member)
        require(m.state == "running", f"full-width member {m.mid} {m.state}:"
                f" {m.result}")
        sup.release(m)
        members.append(m)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {k: v * (1 + len(FULL_GRID) * FULL_STEPS)
            for k, v in train_launches(cfg.n_layers).items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for m in members:
        log(f"full-width member {m.mid} lr {m.hparams['lr']:.0e}: losses "
            f"{m.result['losses']}, step ms "
            f"{[round(x, 1) for x in m.result['step_ms']]}, launch "
            f"{1e3 * m.launch_time:.1f} ms")
    first_errs = [abs(m.result["losses"][0] - step0_loss) / step0_loss
                  for m in members]
    metrics = {"preposition_s": prep_s, "build_s": entry.build_s,
               "first_step_s": entry.first_step_s,
               "launch_ms": [1e3 * m.launch_time for m in members],
               "step_ms": [m.result["step_ms"] for m in members],
               "peak_mem_gib": peak, "warm_cache": dict(sup.warmer.stats),
               "first_loss_rel_err": max(first_errs)}
    log(f"sweep full width: launches {launches} (expected {want}); step-0 "
        f"loss of phase 5b {step0_loss:.6f}; " + json.dumps(metrics))
    require(sup.warmer.stats["hits"] == len(FULL_GRID),
            f"warm cache stats {sup.warmer.stats}")
    require(launches == want, f"full-width launch counts {launches} != "
            f"{want}")
    require(members[0].result["losses"] == members[1].result["losses"],
            "two members at one lr from one base trained differently")
    require(max(first_errs) <= SWEEP_LOSS_RTOL,
            "a member's first loss is not phase 5b's step-0 loss")
    require(all(math.isfinite(x) for m in members
                for x in m.result["losses"]), "non-finite loss")
    return launches, metrics


# --------------------------------------------------------------------------
# phase 5d: the fault-tolerant trainer at full width, in bf16
# --------------------------------------------------------------------------
TRAINER_STEPS, TRAINER_CKPT_EVERY = 8, 4
TRAINER_BATCH = (8, 512)                    # SyntheticLM global batch, seq
TRAINER_LR, TRAINER_WARMUP = 1e-3, 2
TRAINER_CLI_STEPS, TRAINER_CLI_TIMEOUT = 20, 300
RESUME_RTOL = 1e-5                          # tests/test_trainer.py's


def trainer_launches(cfg) -> dict:
    """One Trainer step's launches on an ATTN or MOE stack: per
    microbatch, every block's flash and norm forwards twice under remat
    full (the forward and the recompute in the backward), final_norm's
    once, and each backward once; a block's norms are ln1 and ln2, and
    q_norm and k_norm with qk-norm. whisper (encoder-decoder) as
    ``modal_launches`` counts its prefill: one flash an encoder layer
    (non-causal) and two a decoder layer (self and cross), ln1 and ln2 an
    encoder layer, ln1, ln_x and ln2 a decoder layer, and enc_norm and
    final_norm outside the remat wrapper."""
    L, k = cfg.n_layers, cfg.microbatches
    fwd = 2 if cfg.remat == "full" else 1
    if cfg.enc_dec:
        E = cfg.n_enc_layers
        flash, norms, once = E + 2 * L, 2 * E + 3 * L, 2
    else:
        flash, norms, once = L, (2 + 2 * cfg.qk_norm) * L, 1
    return {"flash_attention": k * fwd * flash, "flash_attention_bwd": k * flash,
            "rmsnorm": k * (fwd * norms + once),
            "rmsnorm_bwd": k * (norms + once)}


def token_nll(params, cfg, batch):
    """Per-token next-token losses of ``forward_loss`` on ``batch``'s tokens
    and modality inputs (every label valid), [B, T-1], a microbatch of the
    step at a time."""
    mbs = _microbatch_stack(batch, cfg.microbatches)
    out = []
    with torch.no_grad():
        for i in range(cfg.microbatches):
            mb = {name: x[i] for name, x in mbs.items()}
            tokens = mb["tokens"]
            enc_out = (encode(params, cfg, mb["frames"]) if cfg.enc_dec
                       else None)
            h, _ = forward_hidden(params, cfg, tokens, pos3=mb.get("pos3"),
                                  enc_out=enc_out,
                                  patch_embeds=mb.get("patch_embeds"),
                                  patch_pos=mb.get("patch_pos"))
            logits = lm_logits(params, cfg, h)[:, :-1].float()
            tgt = torch.gather(logits, -1, tokens[:, 1:, None])[..., 0]
            out.append(torch.logsumexp(logits, dim=-1) - tgt)
            del h, logits
    return torch.cat(out)


def check_trainer_step0(cfg, params, batch, against_design=False,
                        routing=None):
    """Step 0's loss and gradients through the kernels against the same
    through the plain versions on the card, in bf16, held to the bf16 noise
    floor of the plain bf16 path against the plain fp32 one (fp32 params):
    the loss within twice the mean over tokens of the plain path's per-token
    loss deviation, the grad norm within twice the norm of its gradient
    error, every gradient leaf within twice its largest element error (as
    the CPU tests hold the port to JAX). With ``against_design`` (zamba2)
    every leaf is also held, against the same floor, to the plain bf16
    path with the flash backward's rounding by design
    (``DesignAttention``): a leaf fed by many heads' dq, dk and dv, such
    as A_log, is moved by D from the bf16 output as well as by the plain
    path's own bf16 rounding, and the path that rounds as the kernels do
    should be the nearer one. With ``routing`` (a ``PinnedRouting``) the
    kernel path's top-k choices are every path's. The fp32 path takes the
    batch's embeddings (frames, patches) in fp32, the same values. Returns
    the step's launches."""
    k = cfg.microbatches
    run = (routing.run if routing else
           lambda *a, **kw: contextlib.nullcontext())
    with run("nll", record=True):
        nll_k = token_nll(params, cfg, batch)
    LAUNCHES.clear()
    with run("grads", record=True):
        loss_k, grads_k = microbatch_grads(params, cfg, batch, k)
    torch.cuda.synchronize()
    grad_launches = dict(LAUNCHES)
    params32 = tree_map(lambda t: t.float(), params)
    batch32 = {name: t.float() if t.is_floating_point() else t
               for name, t in batch.items()}
    with plain_versions():      # the losses first, beside one gradient tree
        with run("nll", label="plain bf16"):
            nll_p = token_nll(params, cfg, batch)
        with run("nll", label="plain fp32"):
            nll_32 = token_nll(params32, cfg, batch32)
        with run("grads", label="plain bf16"):
            loss_p, grads_p = microbatch_grads(params, cfg, batch, k)
        with run("grads", label="plain fp32"):
            loss_32, grads_32 = microbatch_grads(params32, cfg, batch32, k)
        grads_d = grads_32
        if against_design:
            ops.attention = design_attention
            _, grads_d = microbatch_grads(params, cfg, batch, k)
    require(dict(LAUNCHES) == grad_launches, "the plain step launched a "
            "kernel")
    del params32
    loss_floor = float((nll_p - nll_32).abs().mean())
    gn = {}
    for name, g in (("kernel", grads_k), ("plain", grads_p),
                    ("fp32", grads_32)):
        gn[name] = float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                        for x in tree_leaves(g))))
    gn_floor = float(torch.sqrt(sum(torch.sum((a.double() - b.double()) ** 2)
                                    for a, b in zip(tree_leaves(grads_p),
                                                    tree_leaves(grads_32)))))
    ratios, to_design, design_from_fp32 = {}, {}, {}
    for (path, gk), (_, gp), (_, g32), (_, gd) in zip(
            named_leaves(grads_k), named_leaves(grads_p),
            named_leaves(grads_32), named_leaves(grads_d)):
        require(bool(torch.isfinite(gk).all()), f"gradient {path} not finite")
        floor = max(float((gp - g32).abs().max()), 1e-30)
        ratios[path] = float((gk - g32).abs().max()) / floor
        to_design[path] = float((gk - gd).abs().max()) / floor
        design_from_fp32[path] = float((gd - g32).abs().max()) / floor
    top = lambda r: sorted(r.items(), key=lambda kv: -kv[1])[:4]
    worst = top(ratios)
    loss_err = abs(float(loss_k) - float(loss_32))
    gn_err = abs(gn["kernel"] - gn["fp32"])
    log(f"trainer step 0, kernels vs plain versions (bf16) vs plain fp32: "
        f"loss {float(loss_k):.6f} / {float(loss_p):.6f} / "
        f"{float(loss_32):.6f}, kernel's distance from fp32 {loss_err:.3e} "
        f"(tol 2x the plain path's mean per-token deviation {loss_floor:.3e}, "
        f"the plain loss's own {abs(float(loss_p) - float(loss_32)):.3e}); "
        f"mean per-token |kernel - plain| "
        f"{float((nll_k - nll_p).abs().mean()):.3e}; grad norm "
        f"{gn['kernel']:.6f} / {gn['plain']:.6f} / {gn['fp32']:.6f}, "
        f"distance {gn_err:.3e} (tol 2x the norm of the plain path's "
        f"gradient error {gn_floor:.3e}); gradient leaves' max distance "
        f"from fp32 over the plain path's, worst {worst} (tol 2)"
        + (f"; from the plain path with the flash backward rounding by "
           f"design, worst {top(to_design)} (tol 2; that path's own from "
           f"fp32 {top(design_from_fp32)})" if against_design else ""))
    require(loss_err <= 2 * loss_floor, "trainer step-0 loss off the plain "
            "path's bf16 noise floor")
    require(gn_err <= 2 * gn_floor, "trainer step-0 grad norm off the plain "
            "path's bf16 noise floor")
    require(max(ratios.values()) <= 2, f"trainer step-0 gradient {worst[0]} "
            "off the plain path's bf16 noise floor")
    require(not against_design or max(to_design.values()) <= 2,
            f"trainer step-0 gradient {top(to_design)[0]} off the path with "
            "the flash backward's rounding by design")
    return grad_launches


def timed(fn, record):
    """``fn`` wrapped to add its seconds to ``record``."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        record.append(time.perf_counter() - t0)
        return out
    return run


def trainer_full_width():
    """``Trainer`` on qwen3-0.6b as configured (bf16 params, fp32 moments,
    2 microbatches, remat full, 28 layers, vocab 151936): step 0 against the
    plain versions, 8 steps with a checkpoint every 4 and exact launch
    counts, then a new Trainer on the same directory without the step-8
    checkpoint resumes at step 4 and must give steps 5-8's losses; one
    traced step. Returns (launches of the 8 steps, metrics)."""
    from repro_torch.ckpt import checkpoint as ckpt_module
    from repro_torch.train import trainer as trainer_module
    cfg = get_config("qwen3-0.6b")
    require(cfg.param_dtype == "bfloat16" and cfg.opt_state_dtype ==
            "float32" and cfg.microbatches == 2 and cfg.remat == "full"
            and cfg.n_layers == QWEN_LAYERS and cfg.vocab_size == 151936)
    src = SyntheticLM(cfg.vocab_size, TRAINER_BATCH[1], TRAINER_BATCH[0],
                      seed=0)
    workdir = tempfile.mkdtemp(prefix="trainer_smoke_")
    ckpt_dir = os.path.join(workdir, "ckpt")
    usage = shutil.disk_usage(workdir)
    log(f"trainer: {cfg.name} full width in bf16 ({cfg.n_layers} layers, "
        f"microbatches {cfg.microbatches}, remat {cfg.remat}, moments "
        f"{cfg.opt_state_dtype}); SyntheticLM {TRAINER_BATCH[0]}x"
        f"{TRAINER_BATCH[1]}, peak_lr {TRAINER_LR}, warmup {TRAINER_WARMUP}; "
        f"checkpoints under {workdir} ({usage.free / 2**30:.0f} GiB free)")
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=TRAINER_CKPT_EVERY,
                       peak_lr=TRAINER_LR, warmup=TRAINER_WARMUP,
                       total_steps=100, log_every=1)
    writes, restores = [], []
    saved_write, saved_restore = ckpt_module._write, trainer_module.restore
    ckpt_module._write = timed(saved_write, writes)
    trainer_module.restore = timed(saved_restore, restores)
    try:
        torch.cuda.empty_cache()
        tr = Trainer(cfg, src.batch, tc, device="cuda", log=log)
        require(tr.step == 0, "a fresh checkpoint directory resumed")
        want = trainer_launches(cfg)
        grad_launches = check_trainer_step0(
            cfg, tr.params, to_batch(src.batch(0), "cuda"))
        require(grad_launches == want, f"step 0's gradients launched "
                f"{grad_launches}, not {want}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls, step_ms, launches = [], [], Counter()
        step_fn = tr.step_fn

        def counted(*a):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = step_fn(*a)
            float(out[2]["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(dict(LAUNCHES))
            return out

        saves = []
        tr.step_fn = counted
        tr.mgr.save_async = timed(tr.mgr.save_async, saves)
        out_a = tr.run(TRAINER_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = out_a["losses"]
        require(out_a["step"] == TRAINER_STEPS and not out_a["preempted"])
        require(len(calls) == TRAINER_STEPS, f"{len(calls)} step calls for "
                f"{TRAINER_STEPS} steps: a step was retried")
        for i, got in enumerate(calls):
            require(got == want, f"trainer step {i} launched {got}, not "
                    f"{want}")
            launches.update(got)
        require(all(math.isfinite(x) for x in losses), "non-finite loss")
        require(losses[-1] < losses[0], f"trainer loss did not fall: "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        require(latest_step(ckpt_dir) == TRAINER_STEPS
                and sorted(os.listdir(ckpt_dir)) == [
                    f"step_{s:08d}" for s in range(
                        TRAINER_CKPT_EVERY, TRAINER_STEPS + 1,
                        TRAINER_CKPT_EVERY)], f"checkpoints {os.listdir(ckpt_dir)}")
        ckpt_gib = sum(f.stat().st_size for f in Path(
            ckpt_dir, f"step_{TRAINER_STEPS:08d}").iterdir()) / 2**30
        del tr
        torch.cuda.empty_cache()

        # killed after step 8's checkpoint was lost: resume at step 4
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{TRAINER_STEPS:08d}"))
        t0 = time.perf_counter()
        tr_b = Trainer(cfg, src.batch, dataclasses.replace(
            tc, ckpt_every=10**9), device="cuda", log=log)
        resume_s = time.perf_counter() - t0
        require(tr_b.step == TRAINER_CKPT_EVERY, f"resumed at {tr_b.step}")
        out_b = tr_b.run(TRAINER_STEPS - TRAINER_CKPT_EVERY)
        tail = losses[TRAINER_CKPT_EVERY:]
        diff = max(abs(a - b) / abs(b) for a, b in zip(out_b["losses"], tail))
        log(f"trainer resumed at step {TRAINER_CKPT_EVERY}: losses "
            f"{out_b['losses']} vs the uninterrupted run's {tail}: "
            f"{'bit-equal' if out_b['losses'] == tail else 'not bit-equal'}, "
            f"largest relative difference {diff:.3e} (tol {RESUME_RTOL:.0e})")
        require(diff <= RESUME_RTOL, "the resumed run's losses differ")
        batch = to_batch(src.batch(0), "cuda")

        def step_once():
            tr_b.params, tr_b.opt_state, m = tr_b.step_fn(
                tr_b.params, tr_b.opt_state, batch, TRAINER_STEPS)
            return m["loss"]
        profile = profile_train_step(step_once, {
            "flash_fwd_sm90_kernel<": want["flash_attention"],
            "flash_bwd_dq_sm90_kernel<": want["flash_attention_bwd"]})
    finally:
        ckpt_module._write, trainer_module.restore = saved_write, saved_restore
        shutil.rmtree(workdir, ignore_errors=True)
    metrics = {"loss_first": losses[0], "loss_last": losses[-1],
               "losses": losses, "step0_ms": step_ms[0],
               "step_ms_median": float(np.median(step_ms[1:])),
               "step_ms": step_ms, "peak_mem_gib": peak,
               "launches_per_step": want, "retries": len(calls) - len(losses),
               "checkpoint_gib": ckpt_gib, "save_async_s": saves,
               "write_s": writes, "restore_s": restores,
               "resume_trainer_s": resume_s, "resume_max_rel_diff": diff,
               **profile}
    log("trainer metrics qwen3-0.6b bf16 full width: " + json.dumps(metrics))
    return dict(launches), metrics


def trainer_cli_run(arch: str, steps: int, ckpt: str):
    """(args, tag) of ``python -m repro_torch.launch.train --arch <arch>
    --steps <steps>`` as a user runs it (the reduced config in bf16, one
    device), checkpointing under ``ckpt``."""
    return (["repro_torch.launch.train", "--arch", arch, "--steps",
             str(steps), "--ckpt-dir", ckpt], f"train cli {arch}")


def check_trainer_cli(arch: str, steps: int, proc, wall: float):
    require(proc.returncode == 0, f"the train CLI --arch {arch} exited "
            f"{proc.returncode}")
    want = f"done at step {steps}"
    require(want in proc.stdout, f"the train CLI --arch {arch} did not print "
            f"{want!r}")
    log(f"train cli {arch}: process wall {wall:.2f} s")


# --------------------------------------------------------------------------
# phase 5i: the Trainer on the recurrent archs at full width, in bf16
# --------------------------------------------------------------------------
RECURRENT_CUT = {   # the step-0 check's depth cut (its plain paths step the
    # scans a token at a time, several seconds a recurrent layer)
    "xlstm-1.3b": dict(n_layers=2, xlstm_slstm_every=2),   # 1 mLSTM, 1 sLSTM
    "zamba2-2.7b": dict(n_layers=12)}       # two shared applications
RECURRENT_STEPS, RECURRENT_CLI_STEPS = 4, 10    # steps: 8 before phase 5k
RECURRENT_SWEEP = (4, 2)                    # the sweep CLI: members, steps
LAYER_NORMS = {"mlstm": 1, "slstm": 2, "mamba2": 2}    # ln1 (+ ff_ln / the
#   Mamba-2 mixer's norm); each shared ATTN application ln1 and ln2


def recurrent_launches(cfg) -> dict:
    """One Trainer step's launches on a recurrent arch: per microbatch each
    stage layer's scan and norm forwards twice under remat full (the
    forward and the backward's recompute), the shared ATTN block (outside
    the remat wrapper, as ``forward_hidden`` applies it) and final_norm
    once, and each backward once."""
    k, fwd = cfg.microbatches, (2 if cfg.remat == "full" else 1)
    kinds = Counter(cfg.block_pattern)
    scans = {"ssd_scan": kinds["mlstm"] + kinds["mamba2"],
             "slstm_scan": kinds["slstm"]}
    apps = n_shared_applications(cfg)
    norms = sum(LAYER_NORMS[kind] * n for kind, n in kinds.items())
    want = {"rmsnorm": k * (fwd * norms + 2 * apps + 1),
            "rmsnorm_bwd": k * (norms + 2 * apps + 1)}
    for name, n in scans.items():
        if n:
            want[name], want[name + "_bwd"] = k * fwd * n, k * n
    if apps:
        want["flash_attention"] = want["flash_attention_bwd"] = k * apps
    return want


def check_step_repeats(cfg, params, batch):
    """The same Trainer step (``make_train_step``, moments as configured)
    twice from clones of one state: params, moments and metrics must be
    the same bits (every sum of the path's kernels and of autograd runs in
    a fixed order, zamba2's shared block's nine gradients too)."""
    step = make_train_step(cfg, peak_lr=TRAINER_LR, warmup=TRAINER_WARMUP,
                           total_steps=100, device="cuda")
    runs = []
    # each run from a clone of the params and fresh moments, its results
    # kept on the host: one run's state at a time on the card
    for _ in range(2):
        p, o, m = step(clone_tree(params),
                       adamw_init(params, cfg.opt_state_dtype), batch, 1)
        runs.append([t.cpu() for t in tree_leaves(p) + tree_leaves(o)
                     + [m["loss"], m["grad_norm"]]])
        del p, o, m
        gc.collect()
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"trainer {cfg.name} at {cfg.n_layers} layers: one step twice from "
        f"the same state: {'the same bits' if same else 'DIFFERENT bits'} "
        f"(loss {float(runs[0][-2]):.6f}, grad norm "
        f"{float(runs[0][-1]):.6f})")
    require(same, f"{cfg.name}: a repeated step changed bits")


def train_recurrent(arch: str):
    """``Trainer`` on a recurrent arch as configured (bf16 params, 2
    microbatches, remat full; xlstm bf16 moments, zamba2 fp32) on
    ``SyntheticLM`` 8 x 512: step 0's loss and gradients on the depth cut
    against the plain versions (``check_trainer_step0``), one step twice
    from the same state on the cut, then 8 steps at full depth with exact
    launch counts and a falling loss (no checkpoint: the phase tests the
    step) and one traced step. Returns (launches of the 8 steps,
    metrics)."""
    cfg = get_config(arch)
    require(cfg.param_dtype == "bfloat16" and cfg.microbatches == 2
            and cfg.remat == "full", f"{arch} is not configured as assumed")
    src = SyntheticLM(cfg.vocab_size, TRAINER_BATCH[1], TRAINER_BATCH[0],
                      seed=0)
    batch = to_batch(src.batch(0), "cuda")
    t_phase = time.perf_counter()
    cut = dataclasses.replace(cfg, **RECURRENT_CUT[arch], block_pattern=())
    k = cut.n_layers
    log(f"trainer: {arch} in bf16 ({cfg.n_layers} layers, microbatches "
        f"{cfg.microbatches}, remat {cfg.remat}, moments "
        f"{cfg.opt_state_dtype}); SyntheticLM {TRAINER_BATCH[0]}x"
        f"{TRAINER_BATCH[1]}; step 0 checked on a depth cut of {k} layers "
        f"{dict(Counter(cut.block_pattern))} (its fp32 copy and three "
        f"gradient trees beside the full model's state would not fit)")
    params = init_params(cut, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    got = check_trainer_step0(cut, params, batch,
                              against_design=bool(cut.shared_attn_every))
    want_cut = recurrent_launches(cut)
    require(got == want_cut, f"{arch} step 0 at {k} layers launched {got}, "
            f"not {want_cut}")
    check_step_repeats(cut, params, batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix="trainer_recurrent_")
    tc = TrainerConfig(ckpt_dir=workdir, ckpt_every=10**9,
                       peak_lr=TRAINER_LR, warmup=TRAINER_WARMUP,
                       total_steps=100, log_every=1)
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, src.batch, tc, device="cuda", log=log)
        n_params = sum(t.numel() for t in tree_leaves(tr.params))
        state_gib = sum(t.numel() * t.element_size() for t in
                        tree_leaves(tr.params) + tree_leaves(tr.opt_state)
                        if torch.is_tensor(t)) / 2**30
        log(f"trainer {arch}: {n_params / 1e9:.3f} B params, params and "
            f"moments {state_gib:.2f} GiB")
        want = recurrent_launches(cfg)
        calls, step_ms = [], []
        step_fn = tr.step_fn

        def counted(*a):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = step_fn(*a)
            float(out[2]["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(dict(LAUNCHES))
            return out

        tr.step_fn = counted
        out = tr.run(RECURRENT_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = out["losses"]
        require(out["step"] == RECURRENT_STEPS and len(calls) ==
                RECURRENT_STEPS, f"{arch}: {len(calls)} step calls for "
                f"{RECURRENT_STEPS} steps")
        launches = Counter()
        for i, got in enumerate(calls):
            require(got == want, f"{arch} trainer step {i} launched {got}, "
                    f"not {want}")
            launches.update(got)
        require(all(math.isfinite(x) for x in losses), "non-finite loss")
        require(losses[-1] < losses[0], f"{arch} trainer loss did not fall: "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        tr.step_fn = step_fn

        def step_once():
            tr.params, tr.opt_state, m = tr.step_fn(
                tr.params, tr.opt_state, batch, RECURRENT_STEPS)
            return m["loss"]
        expect = {"ssd_bwd_da_kernel": want["ssd_scan_bwd"]}
        if "slstm_scan_bwd" in want:
            expect["slstm_bwd_walk_kernel"] = want["slstm_scan_bwd"]
        if "flash_attention_bwd" in want:
            expect["flash_bwd_dq_sm90_kernel<"] = want["flash_attention_bwd"]
        profile = profile_train_step(step_once, expect)
        del tr
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    metrics = {"params_b": n_params / 1e9, "state_gib": state_gib,
               "loss_first": losses[0], "loss_last": losses[-1],
               "losses": losses, "step0_ms": step_ms[0],
               "step_ms_median": float(np.median(step_ms[1:])),
               "step_ms": step_ms, "peak_mem_gib": peak,
               "launches_per_step": want,
               "phase_s": time.perf_counter() - t_phase, **profile}
    log(f"trainer metrics {arch} bf16 full width: " + json.dumps(metrics))
    return dict(launches), metrics


def arch_clis(card: str):
    """The training CLIs of phases 5d, 5i and 5j, all at once (each a small
    reduced config; nothing is timed here but the processes' wall):
    ``python -m repro_torch.launch.train --arch <arch>`` for qwen3-0.6b
    (``TRAINER_CLI_STEPS``), the recurrent archs and moonshot (exit 0,
    "done at step N"), and ``python -m repro_torch.launch.sweep --arch
    <arch>`` for the last three (the member: the reduced config's layers
    in fp32, remat none; exit 0 and every member launched)."""
    t0 = time.perf_counter()
    members, steps = RECURRENT_SWEEP
    archs = [(arch, RECURRENT_CLI_STEPS) for arch in RECURRENT_CUT]
    archs.append((MOE_ARCH, MOE_CLI_STEPS))
    with tempfile.TemporaryDirectory(prefix="train_cli_") as ckpt:
        runs = [trainer_cli_run("qwen3-0.6b", TRAINER_CLI_STEPS,
                                os.path.join(ckpt, "qwen3-0.6b"))]
        for arch, n in archs:
            runs += [trainer_cli_run(arch, n, os.path.join(ckpt, arch)),
                     (["repro_torch.launch.sweep", "--arch", arch,
                       "--members", str(members), "--steps", str(steps)],
                      f"sweep {arch}")]
        done = run_modules(runs, max(TRAINER_CLI_TIMEOUT, SWEEP_CLI_TIMEOUT))
    check_trainer_cli("qwen3-0.6b", TRAINER_CLI_STEPS, *done[0])
    for (arch, n), (train, train_wall), (sweep, sweep_wall) in zip(
            archs, done[1::2], done[2::2]):
        check_trainer_cli(arch, n, train, train_wall)
        require(sweep.returncode == 0, f"the sweep CLI --arch {arch} exited "
                f"{sweep.returncode}")
        want = f"launched {members}/{members} members"
        require(want in sweep.stdout, f"the sweep CLI --arch {arch} did not "
                f"print {want!r}")
        log(f"sweep cli --arch {arch}: process wall {sweep_wall:.2f} s")
    log(f"the training CLIs of phases 5d, 5i and 5j, {len(runs)} processes "
        f"at once: {time.perf_counter() - t0:.1f} s ({card})")


def train_recurrent_archs(card: str) -> dict:
    """Phase 5i: both recurrent archs in turn, one on the card at a time
    (their CLIs run at the end of phase 5j, ``arch_clis``). Returns each
    Trainer's launches under ``"<arch> Trainer (bf16, full width)"``."""
    t0 = time.perf_counter()
    out = {}
    for arch in RECURRENT_CUT:
        out[f"{arch} Trainer (bf16, full width)"], _ = train_recurrent(arch)
    log(f"phase 5i: {time.perf_counter() - t0:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 5j: the Trainer on an MoE arch (moonshot-v1-16b-a3b), in bf16
# --------------------------------------------------------------------------
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_CLI_STEPS = 10
MOE_FLASH = (2, 512, 16, 16, 128)           # B, T=S, H, KV, hd a microbatch
MOE_RMS = (1024, 2048)                      # rows, d: ln1 / ln2 / final_norm


def check_moe_train_kernels(gen):
    """Phase 4's rows for phase 5j's path: the bf16 flash forward and
    backward at moonshot's microbatch (B=2 T=S=512 H=KV=16 hd=128 causal,
    the backward's first MHA regime at hd 128), per row against the plain
    version and each called twice for the same bits; the bf16 rmsnorm
    forward and backward at 1024 x 2048. Each timed beside its library
    call and bound. Returns (flash fwd, flash bwd, rmsnorm, rmsnorm bwd)
    rows."""
    B, T, H, KV, hd = MOE_FLASH
    q, k, v, got, err, name = hold_flash(gen, B, T, T, H, KV, hd,
                                         torch.bfloat16, True)
    check_flash_rows(q, k, v, got, name)
    require(torch.equal(got, flash_attention(q, k, v, causal=True)),
            f"two flash_attention calls differ: {name}")
    fwd_row = time_flash(q, k, v, err)
    bwd_row = time_flash_bwd_bf16(**hold_flash_bwd_bf16(gen, B, T, H, KV, hd))
    rows, d = MOE_RMS
    x = randn(gen, rows, d, dtype=torch.bfloat16)
    g = (1 + 0.1 * randn(gen, d)).to(torch.bfloat16)
    name = f"rows={rows} d={d} bfloat16"
    err = hold_rmsnorm(name, x, g)
    require(torch.equal(rmsnorm(x, g, eps=1e-6), rmsnorm(x, g, eps=1e-6)),
            f"two rmsnorm calls differ: {name}")
    rms_row = time_rmsnorm(name, x, g, err)
    return fwd_row, bwd_row, rms_row, hold_rmsnorm_bwd_bf16(gen, rows, d)


class _PinnedTopk:
    """``torch`` as ``models/mlp.py`` sees it during one pinned
    ``moe_forward`` call: ``topk`` returns the pinned experts (and their
    probabilities); everything else is torch's."""

    def __init__(self, top_e):
        self.top_e = top_e

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1):
        return torch.gather(probs, dim, self.top_e), self.top_e


class PinnedRouting:
    """The kernel path's top-k choices made every path's, without a change
    to the model: a wrapper around ``model_blocks.moe_forward`` that, in a
    recording run, keeps each call's router input and top-k experts (the
    choices ``moe_forward`` makes, taken with its own ops), and in a
    replaying run hands the same call of the same run its recorded
    experts through ``torch.topk`` as ``models/mlp.py`` sees it. The calls
    of a run come in a fixed order (per microbatch the blocks' forwards,
    then the backward's recomputes in reverse), so a call's index names
    it. A replay also counts the choices its own router would have made
    otherwise (``router_flips`` against the kernel path's input), and a
    recording the slots each call drops past the capacity."""

    def __init__(self, cfg):
        self.cfg, self.calls, self.flips, self.drops = cfg, {}, {}, {}

    @contextlib.contextmanager
    def run(self, name, record=False, label=None):
        calls = self.calls.setdefault(name, []) if record else self.calls[name]
        seen = iter(range(len(calls))) if not record else None
        saved, saved_torch = model_blocks.moe_forward, model_mlp.torch

        def pinned(p, cfg, x, inference=False):
            xf = x.reshape(-1, x.shape[-1]).detach()
            if record:
                with torch.no_grad():
                    logits = matmul(xf, p["router"].to(xf.dtype),
                                    out_dtype=torch.float32)
                top_e = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k,
                                   dim=-1)[1]
                calls.append((x.detach(), top_e))
                counts = torch.bincount(top_e.reshape(-1),
                                        minlength=cfg.n_experts)
                C = model_mlp.capacity(cfg, xf.shape[0], inference)
                self.drops.setdefault(name, []).append(
                    int((counts - C).clamp_min(0).sum()))
                return saved(p, cfg, x, inference=inference)
            x_k, top_e = calls[next(seen)]
            require(x_k.shape == x.shape, f"pinned routing: call of shape "
                    f"{tuple(x.shape)} replays one of {tuple(x_k.shape)}")
            with torch.no_grad():
                n, total, _, _ = router_flips(p["router"], cfg, x_k,
                                              x.detach(), x.detach())
            tally = self.flips.setdefault((name, label), [0, 0])
            tally[0], tally[1] = tally[0] + n, tally[1] + total
            model_mlp.torch = _PinnedTopk(top_e)
            try:
                return saved(p, cfg, x, inference=inference)
            finally:
                model_mlp.torch = saved_torch

        model_blocks.moe_forward = pinned
        try:
            yield
            require(record or next(seen, None) is None,
                    f"pinned routing: {label} made fewer calls of {name}")
        finally:
            model_blocks.moe_forward = saved
            model_mlp.torch = saved_torch

    def log(self, cfg):
        L, k = cfg.n_layers, cfg.microbatches
        drops = self.drops["grads"]
        per_mb = [drops[i * 2 * L:i * 2 * L + L] for i in range(k)]
        C = model_mlp.capacity(cfg, len(self.calls["grads"][0][1]), False)
        log(f"{cfg.name} step 0 routing pinned to the kernel path's choices "
            f"(top {cfg.top_k} of {cfg.n_experts}, C = {C} slots an expert "
            f"at {self.calls['grads'][0][1].shape[0]} tokens): slots dropped "
            f"past capacity per microbatch and layer {per_mb} (of "
            f"{self.calls['grads'][0][1].numel()} choices); unpinned, the "
            f"plain paths would have chosen otherwise in "
            + "; ".join(f"{label} {name}: {n} of {total} choices"
                        for (name, label), (n, total) in self.flips.items()))


def moe_member_repeats():
    """Two steps of the reduced moonshot sweep member (``member_config``:
    fp32, remat none) from clones of one state on the card: params,
    moments and loss the same bits."""
    cfg = member_config(MOE_ARCH)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    opt = adamw_init(params, "float32")
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)    # launch/sweep.py's
    step = build_member_step(cfg, "cuda")
    runs = []
    for _ in range(2):
        p, o, loss = step(clone_tree(params), clone_tree(opt), src.batch(0),
                          TRAIN_LR)
        runs.append(tree_leaves(p) + tree_leaves(o) + [loss])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"sweep member {cfg.name} ({cfg.n_layers} layers, fp32): one step "
        f"twice from the same state: {'the same bits' if same else 'DIFFERENT bits'} "
        f"(loss {float(runs[0][-1]):.6f})")
    require(same, f"{cfg.name}: a repeated member step changed bits")


class TrainArch(NamedTuple):
    """One arch through the Trainer in bf16 at full width: the config
    fields the phase relies on (``assumed``), the layers of the step-0
    check (``cut``) and of the Trainer run (``depth``; the config's own
    where they are equal), ``SyntheticLM``'s global batch and length, the
    steps, whether step 0 pins the routing (``PinnedRouting``) and the
    launch path's name in the kernels line."""
    arch: str
    assumed: dict
    cut: int
    depth: int
    batch: tuple
    steps: int
    path: str
    pinned: bool = False


def train_modal(cfg, B: int, T: int, step: int) -> dict:
    """The modality inputs of a training batch, filled at ``shaped_batch``'s
    train shapes from a generator seeded by the step: whisper's frames
    [B, T, d] ~ N(0, 0.02^2) in bf16; qwen2-vl's npatch patch embeddings
    (npatch = T // 8 here, a square grid), N(0, 0.02^2) in bf16, at
    positions ``VLM_AT`` on, with their M-RoPE ids (``vlm_pos3``). Nothing
    for a token-only arch."""
    meta = shaped_batch(cfg, ShapeConfig("train", T, B, "train"))
    gen = torch.Generator("cuda").manual_seed(step)
    out = {name: randn(gen, *meta[name].shape, dtype=meta[name].dtype,
                       scale=0.02)
           for name in ("frames", "patch_embeds") if name in meta}
    if "patch_pos" in meta:
        P = meta["patch_pos"].shape[1]
        grid = math.isqrt(P)
        require(grid * grid == P, f"{P} patches are not a square grid")
        out["patch_pos"] = torch.arange(VLM_AT, VLM_AT + P,
                                        device="cuda")[None].expand(B, P)
        out["pos3"] = vlm_pos3(B, T, grid)
    return out


def train_arch(spec: TrainArch):
    """``Trainer`` on ``spec.arch`` as configured (bf16 params, its own
    microbatches, remat and moments) at full width on ``SyntheticLM`` with
    the arch's modality inputs (``train_modal``): step 0 on a cut of
    ``spec.cut`` layers against the plain paths (with the routing pinned
    for an MoE), one step twice from one state on the cut,
    ``spec.steps`` steps at ``spec.depth`` layers with exact launch counts
    and a falling loss, one traced step; peak memory logged. Returns
    (launches of the steps, metrics)."""
    t_phase = time.perf_counter()
    cfg = get_config(spec.arch)
    have = {f: getattr(cfg, f) for f in spec.assumed}
    require(have == spec.assumed, f"{spec.arch} is not configured as "
            f"assumed: {have}")
    B, T = spec.batch
    src = SyntheticLM(cfg.vocab_size, T, B, seed=0)
    batch_fn = lambda step: {**src.batch(step),
                             **train_modal(cfg, B, T, step)}
    batch = to_batch(batch_fn(0), "cuda")
    cut = (cfg if spec.cut == cfg.n_layers else
           dataclasses.replace(cfg, n_layers=spec.cut, block_pattern=()))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cut, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    n_cut = sum(t.numel() for t in tree_leaves(params))
    log(f"trainer: {spec.arch} in bf16 ({cfg.n_layers} layers configured"
        + (f" and {cfg.n_enc_layers} encoder layers" if cfg.enc_dec else "")
        + f", {spec.depth} trained; microbatches {cfg.microbatches}, remat "
        f"{cfg.remat}, moments {cfg.opt_state_dtype}); SyntheticLM {B}x{T}"
        f"{' with ' + ', '.join(sorted(set(batch) - {'tokens', 'labels'})) if len(batch) > 2 else ''}"
        f"; step 0 checked on {spec.cut} layers ({n_cut / 1e9:.3f} B params)")
    routing = PinnedRouting(cut) if spec.pinned else None
    got = check_trainer_step0(cut, params, batch, routing=routing)
    if routing:
        routing.log(cut)
    want_cut = trainer_launches(cut)
    require(got == want_cut, f"{spec.arch} step 0 at {spec.cut} layers "
            f"launched {got}, not {want_cut}")
    del routing
    check_step_repeats(cut, params, batch)
    step0_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"trainer {spec.arch}: the step-0 checks' peak {step0_peak:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    run_cfg = (cfg if spec.depth == cfg.n_layers else
               dataclasses.replace(cfg, n_layers=spec.depth, block_pattern=()))
    workdir = tempfile.mkdtemp(prefix="trainer_arch_")
    tc = TrainerConfig(ckpt_dir=workdir, ckpt_every=10**9,
                       peak_lr=TRAINER_LR, warmup=TRAINER_WARMUP,
                       total_steps=100, log_every=1)
    try:
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(run_cfg, batch_fn, tc, device="cuda", log=log)
        n_params = sum(t.numel() for t in tree_leaves(tr.params))
        state_gib = sum(t.numel() * t.element_size() for t in
                        tree_leaves(tr.params) + tree_leaves(tr.opt_state)
                        if torch.is_tensor(t)) / 2**30
        log(f"trainer {spec.arch} at {spec.depth} of {cfg.n_layers} layers: "
            f"{n_params / 1e9:.3f} B params, params and moments "
            f"{state_gib:.2f} GiB")
        want = trainer_launches(run_cfg)
        calls, step_ms = [], []
        step_fn = tr.step_fn

        def counted(*a):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = step_fn(*a)
            float(out[2]["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.append(dict(LAUNCHES))
            return out

        tr.step_fn = counted
        out = tr.run(spec.steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = out["losses"]
        require(out["step"] == spec.steps and len(calls) == spec.steps,
                f"{spec.arch}: {len(calls)} step calls for {spec.steps} "
                f"steps")
        launches = Counter()
        for i, got in enumerate(calls):
            require(got == want, f"{spec.arch} trainer step {i} launched "
                    f"{got}, not {want}")
            launches.update(got)
        require(all(math.isfinite(x) for x in losses), "non-finite loss")
        require(losses[-1] < losses[0], f"{spec.arch} trainer loss did not "
                f"fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
        tr.step_fn = step_fn

        def step_once():
            tr.params, tr.opt_state, m = tr.step_fn(
                tr.params, tr.opt_state, batch, spec.steps)
            return m["loss"]
        profile = profile_train_step(step_once, {
            "flash_fwd_sm90_kernel<": want["flash_attention"],
            "flash_bwd_dq_sm90_kernel<": want["flash_attention_bwd"]},
            moe=cfg.n_experts > 0)
        del tr
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    metrics = {"params_b": n_params / 1e9, "state_gib": state_gib,
               "loss_first": losses[0], "loss_last": losses[-1],
               "losses": losses, "step0_ms": step_ms[0],
               "step_ms_median": float(np.median(step_ms[1:])),
               "step_ms": step_ms, "peak_mem_gib": peak,
               "step0_check_peak_gib": step0_peak,
               "launches_per_step": want,
               "phase_s": time.perf_counter() - t_phase, **profile}
    log(f"trainer metrics {spec.arch} bf16 full width, {spec.depth} layers: "
        + json.dumps(metrics))
    return dict(launches), metrics


MOE_TRAIN = TrainArch(
    MOE_ARCH, dict(param_dtype="bfloat16", opt_state_dtype="float32",
                   microbatches=4, remat="full", capacity_factor=1.25,
                   d_model=2048, n_heads=16, head_dim=128, n_experts=64,
                   top_k=6, d_ff_expert=1408, vocab_size=163840),
    cut=2, depth=4, batch=TRAINER_BATCH, steps=8,
    path=f"{MOE_ARCH} Trainer (bf16, 4 layers)", pinned=True)


def train_moe(card: str):
    """Phase 5j: moonshot-v1-16b-a3b (capacity factor 1.25) at 4 of its 48
    layers through ``train_arch`` (step 0 on a 2-layer cut, routing
    pinned), two member steps, then the training CLIs of phases 5d, 5i
    and 5j (``arch_clis``). Returns (launches of the steps, metrics)."""
    t_phase = time.perf_counter()
    out = train_arch(MOE_TRAIN)
    moe_member_repeats()
    gc.collect()
    torch.cuda.empty_cache()
    arch_clis(card)
    log(f"phase 5j: {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 5k: the Trainer on mixtral-8x22b and the two frontend archs, in bf16
# --------------------------------------------------------------------------
FRONTEND_TRAIN = (
    TrainArch("whisper-small", dict(
        param_dtype="bfloat16", opt_state_dtype="float32", microbatches=1,
        remat="full", n_layers=12, n_enc_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, qk_norm=False, enc_dec=True),
        cut=12, depth=12, batch=TRAINER_BATCH, steps=8,
        path="whisper-small train"),
    TrainArch("qwen2-vl-7b", dict(
        param_dtype="bfloat16", opt_state_dtype="float32", microbatches=4,
        remat="full", d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        qk_norm=False, vocab_size=152064, tie_embeddings=False),
        cut=4, depth=4, batch=TRAINER_BATCH, steps=8,
        path="qwen2-vl-7b train"),
    TrainArch("mixtral-8x22b", dict(
        param_dtype="bfloat16", opt_state_dtype="float32", microbatches=8,
        remat="full", d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        n_experts=8, top_k=2, d_ff_expert=16384, sliding_window=4096,
        vocab_size=32768, qk_norm=False),
        cut=1, depth=1, batch=(8, 4096), steps=8,
        path="mixtral-8x22b train", pinned=True),
)
FRONTEND_FLASH = (   # phase 5k's attention regimes: B, T=S, H, KV, hd, causal,
    (8, 512, 12, 12, 64, False, 0),    # window. whisper's encoder and its
    (8, 512, 12, 12, 64, True, 0),     # cross attention at S = T; its decoder
    (2, 512, 28, 4, 128, True, 0),     # qwen2-vl's microbatch: GQA 7
    (1, 4096, 48, 8, 128, True, 4096),  # mixtral's: the window reaches key 0
    (1, 5000, 48, 8, 128, True, 4096))  # past 4096 keys the window binds
FRONTEND_RMS = ((4096, 768), (1024, 3584), (4096, 6144))   # rows, d a
#   microbatch: whisper 8 x 512, qwen2-vl 2 x 512, mixtral 1 x 4096


def check_frontend_train_kernels(gen):
    """Phase 4's rows for phase 5k's paths: at each ``FRONTEND_FLASH``
    regime the bf16 forward (per row against the plain version, with its
    lse and rounding residual, twice the same bits, timed beside SDPA) and
    the bf16 backward (``hold_flash_bwd_bf16``: per row, twice the same
    bits, a run without the first key tile failing; timed beside SDPA's
    backward); at T = 4096 under the 4096-key window, forward and backward
    the same bits as without it (key 0 is inside every row's window: k >
    q - window); at each ``FRONTEND_RMS`` shape the bf16 rmsnorm forward and
    backward, each twice the same bits and timed. Returns (flash fwd rows,
    flash bwd rows, rmsnorm rows, rmsnorm bwd rows)."""
    fwd_rows, bwd_rows = [], []
    for B, T, H, KV, hd, causal, window in FRONTEND_FLASH:
        q, k, v, got, err, name = hold_flash(gen, B, T, T, H, KV, hd,
                                             torch.bfloat16, causal, window)
        check_flash_rows(q, k, v, got, name, window, causal=causal)
        kw = dict(causal=causal, window=window, q_offset=0)
        require(torch.equal(got, flash_attention(q, k, v, **kw)),
                f"two flash_attention calls differ: {name}")
        check_flash_lse(q, k, v, kw, name)
        fwd_rows.append(time_flash(q, k, v, err, window, causal))
        held = hold_flash_bwd_bf16(gen, B, T, H, KV, hd, window, causal)
        if window == T:
            check_window_edge(held)
        bwd_rows.append(time_flash_bwd_bf16(**held))
        del q, k, v, got, held
        torch.cuda.empty_cache()
    rms_rows, rms_bwd_rows = [], []
    for rows, d in FRONTEND_RMS:
        x = randn(gen, rows, d, dtype=torch.bfloat16)
        g = (1 + 0.1 * randn(gen, d)).to(torch.bfloat16)
        name = f"rows={rows} d={d} bfloat16"
        err = hold_rmsnorm(name, x, g)
        require(torch.equal(rmsnorm(x, g, eps=1e-6), rmsnorm(x, g, eps=1e-6)),
                f"two rmsnorm calls differ: {name}")
        rms_rows.append(time_rmsnorm(name, x, g, err))
        rms_bwd_rows.append(hold_rmsnorm_bwd_bf16(gen, rows, d))
    return fwd_rows, bwd_rows, rms_rows, rms_bwd_rows


def check_window_edge(held):
    """A window as long as the sequence: every row's window reaches key 0
    (k > q - window holds for k = 0 up to q = window - 1), so the forward
    and the backward must give the bits of plain causal attention, which
    visit the same tiles with the same masks."""
    q, k, v, do = (held[n] for n in ("q", "k", "v", "do"))
    o, lse, o_lo = (held[n] for n in ("o", "lse", "o_lo"))
    window = held["window"]
    same = [torch.equal(flash_attention(q, k, v, window=window),
                        flash_attention(q, k, v))]
    same += [torch.equal(a, b) for a, b in zip(
        flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo, window=window),
        flash_attention_bwd(q, k, v, o, lse, do, o_lo=o_lo))]
    log(f"flash_attention T=S={q.shape[1]} window={window}: output, dq, dk, "
        f"dv the same bits as without the window: {same}")
    require(all(same), "a window as long as the sequence dropped a key")


def train_frontend_archs(card: str) -> dict:
    """Phase 5k: ``FRONTEND_TRAIN``'s archs in turn through ``train_arch``,
    one on the card at a time. Returns each run's launches under its path's
    name."""
    t0 = time.perf_counter()
    out = {}
    for spec in FRONTEND_TRAIN:
        out[spec.path], _ = train_arch(spec)
    log(f"phase 5k: {time.perf_counter() - t0:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 5e: the paper's launch layer on the card's host
# --------------------------------------------------------------------------
# (app, nodes, processes per node, strategy, prepositioned), the bound of
# tests/test_scheduler.py:23-49 it must meet, and that bound in words
PAPER_CELLS = (
    (("tensorflow", 512, 64, "two-tier", True),
     lambda r: r.total_procs == 32768 and r.launch_time < 5.0,
     "32768 processes in under 5 s"),
    (("octave", 512, 64, "two-tier", True),
     lambda r: r.launch_time < 10.0, "under 10 s"),
    (("octave", 512, 512, "two-tier", True),
     lambda r: r.total_procs == 262144 and r.launch_time < 40.0,
     "262144 processes in under 40 s"),
    (("octave", 512, 256, "two-tier", True),
     lambda r: 4000 <= r.launch_rate <= 12000, "4000-12000 launches/s"),
    (("matlab", 625, 64, "flat", False),
     lambda r: 1800 <= r.launch_time <= 3600, "1800-3600 s"),
)
CHAOS_SEED = 123
NO_STRAGGLERS = dict(min_straggler_samples=10 ** 6)
LINT_TIMEOUT = 120


def chaos_plan(n):
    return FaultPlan.seeded(CHAOS_SEED, n, n_launchers=2,
                            workers_per_launcher=2, kinds=(KILL_LAUNCHER,))


def launch_sim_cells():
    for (app, n, p, strategy, warm), ok, bound in PAPER_CELLS:
        r = measure_launch(app, n, p, strategy=strategy, prepositioned=warm)
        log(f"launch sim {app} {n} x {p} {strategy} "
            f"{'prepositioned' if warm else 'cold'}: {r.total_procs} "
            f"processes in {r.launch_time!r} simulated TX-Green s, "
            f"{r.launch_rate!r} launches per simulated s (the model's "
            f"seconds, not a time of this host)")
        require(ok(r), f"measure_launch({app!r}, {n}, {p}) misses the "
                f"paper's bound: {bound}")


def launch_sim_graph():
    """A map of 16 and a reduce on the simulated cluster while the plan
    kills a launcher."""
    n = 16
    g = TaskGraph("smoke-sim")
    sq = g.map(lambda p, _: p["x"] * p["x"], [{"x": x} for x in range(n)],
               cmd="params['x'] * params['x']", name="sq")
    g.reduce(lambda p, i: sum(i["sq"][p["lo"]:p["hi"]]), sq, name="total")
    policy = RetryPolicy(max_retries=3, backoff=0.01, scan_period=0.05,
                         **NO_STRAGGLERS)
    with get_backend("sim") as b:
        res = g.run(b, policy, chaos=chaos_plan(n))
    stats = validate_trace(res.events, max_retries=3)
    lost = res["sq"].summary.lost
    log(f"launch sim graph: {res.events.counts()}, lost {lost}, "
        f"simulated span {stats.span!r} s")
    require(res.all_ok, "the sim graph did not end all ok")
    require(res["sq"].values == [x * x for x in range(n)]
            and res["total"].values == [sum(x * x for x in range(n))],
            "the sim graph's values are wrong")
    require(lost >= 1, "the sim graph's kill plan lost no attempt")


def launch_procpool_graph():
    """8 ``cmd`` tasks on the real two-tier pool while the plan SIGKILLs a
    launcher."""
    n = 8
    g = TaskGraph("smoke-procpool")
    g.map(cmd="time.sleep(0.25) or params['x'] * params['x']",
          params=[{"x": x} for x in range(n)], name="a")
    policy = RetryPolicy(max_retries=3, backoff=0.05, scan_period=0.1,
                         task_deadline=60.0, **NO_STRAGGLERS)
    t0 = time.perf_counter()
    with get_backend("procpool", n_launchers=2, workers_per_launcher=2,
                     ready_timeout=60.0) as b:
        res = g.run(b, policy, chaos=chaos_plan(n))
        pool = b.pool
    wall = time.perf_counter() - t0
    counts = res.events.counts()
    stats = validate_trace(res.events, max_retries=3)
    lost = res["a"].summary.lost
    log(f"launch procpool graph: {counts}, crashes {pool.crashes}, "
        f"respawns {pool.respawns}, lost {lost}, "
        f"{len(pool._all_launchers)} launchers spawned, wall {wall!r} s "
        f"(host clock)")
    require(res.all_ok and all(r.status == "ok" for r in res["a"].results),
            "the procpool graph did not end all ok")
    require(res["a"].values == [x * x for x in range(n)],
            "the procpool graph's values are wrong")
    require(pool.crashes == 1, f"the pool counted {pool.crashes} crashes")
    require(lost >= 1 and counts.get(LOST, 0) == lost,
            f"lost {lost} against {counts.get(LOST, 0)} LOST events")
    require(counts.get(FAULT, 0) >= 2 and stats.faults >= 2,
            "the kill and the pool's crash report are not both in the trace")
    require(all(lp.poll() is not None for lp in pool._all_launchers),
            "a launcher was left unreaped")


def launch_real_processes(card):
    flat, twot = realproc.compare(8, 16)
    for r in (flat, twot):
        require(r.total_procs == 128 and r.procs,
                f"the {r.strategy} launch did not complete")
        require(all(pr.poll() is not None for pr in r.procs),
                f"the {r.strategy} launch left a process unreaped")
        log(f"launch real {r.strategy} 8 x 16: {r.total_procs} processes "
            f"ready in {r.launch_time!r} s wall ({r.launch_rate!r}/s) on "
            f"{os.cpu_count()} host CPUs beside {card}")


def launch_lint():
    proc, _ = run_module(["repro_torch.analysis", "--baseline",
                          "src/repro_torch/analysis/baseline.txt"], "lint",
                         LINT_TIMEOUT)
    require(proc.returncode == 0, f"the port's lint exited {proc.returncode}")


def launch_layer(card):
    """Phase 5e; the launch layer runs no kernel."""
    t0 = time.perf_counter()
    LAUNCHES.clear()
    launch_sim_cells()
    launch_sim_graph()
    launch_procpool_graph()
    launch_real_processes(card)
    launch_lint()
    require(not LAUNCHES, f"the launch layer launched {dict(LAUNCHES)}")
    log(f"launch layer: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 5l: the one-card dry-run over the 40 (arch x shape) cells, and its
# figures held against runs of build_step's programs on the card
# --------------------------------------------------------------------------
CELL_FLASH_TRAIN = (4, 4096, 16, 8, 128)   # B, T=S, H, KV, hd: qwen3-0.6b
#   train_4k cut to batch 8, a microbatch of 4 (forward and backward)
CELL_FLASH_PREFILL = (4, 32768, 16, 8, 128)   # prefill_32k cut to batch 4
CELL_RMS = (   # rows, d (bf16): every norm of phase 5l's cells
    (16384, 1024), (262144, 128), (131072, 128),     # train_4k, a microbatch
    (131072, 1024), (2097152, 128), (1048576, 128), (4, 1024),  # prefill
    (32768, 2048), (1, 2048),                        # xlstm-1.3b prefill_32k
    (128, 2048),                                     # its decode_32k
    (1, 2560), (1, 5120))                            # zamba2-2.7b long_500k
CELL_RMS_BWD = ((16384, 1024), (262144, 128), (131072, 128))   # train_4k
CELL_SCAN_T = 32768          # xlstm-1.3b prefill_32k cut to batch 1


def call_key(kernel: str, *args, **kw) -> tuple:
    """A kernel call's shape, as ``check_cell_kernels`` holds it and phase
    5l's cells record it (``recording``)."""
    name = lambda t: str(t.dtype)[6:]
    if kernel == "flash_attention":
        q, k, _ = args
        return (kernel, *q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], name(q), kw.get("causal", True),
                kw.get("window", 0), kw.get("q_offset", 0))
    if kernel == "rmsnorm":
        x = args[0]
        return (kernel, x.numel() // x.shape[-1], x.shape[-1], name(x))
    if kernel == "ssd_scan":
        x, _, B, _ = args
        return (kernel, *x.shape[:3], *B.shape[2:], x.shape[3], name(x),
                kw.get("norm_weights") is not None,
                kw.get("initial_state") is not None)
    wx, r, _ = args
    return (kernel, *wx.shape[:3], wx.shape[3] // 4, name(wx), name(r))


@contextlib.contextmanager
def recording(into: set):
    """Adds each of the model's kernel calls' ``call_key`` to ``into`` and
    passes the call on (the backward kernels run at their forwards'
    shapes)."""
    saved = ops.attention, ops.norm, ops.ssd, ops.slstm

    def tap(kernel, fn):
        def call(*args, **kw):
            into.add(call_key(kernel, *args, **kw))
            return fn(*args, **kw)
        return call

    ops.attention, ops.norm, ops.ssd, ops.slstm = (
        tap(k, f) for k, f in zip(("flash_attention", "rmsnorm", "ssd_scan",
                                   "slstm_scan"), saved))
    try:
        yield into
    finally:
        ops.attention, ops.norm, ops.ssd, ops.slstm = saved


def hold_flash_by_group(q, k, v, got, name) -> float:
    """``got``, the bf16 forward at the whole causal shape of q, k and v,
    held against the plain version one (batch row, KV group) at a time
    (``plain_attention`` on fp32 inputs; the plain scores of a whole
    32768-token call would take 256 GiB): every slice within ``TOL``, and
    per row (``check_flash_rows``' limit, taken over every slice) within
    twice the bf16 rounding of the fp32 result; the last slice without its
    first key tile must fail that limit. Returns the max abs error."""
    B, T, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    err = rounding = abs_err = 0.0
    for b in range(B):
        for g in range(KV):
            heads = slice(g * G, (g + 1) * G)
            qf = q[b:b + 1, :, heads].float()
            kf, vf = (t[b:b + 1, :, g:g + 1].float() for t in (k, v))
            want = plain_attention(qf, kf, vf)
            part = got[b:b + 1, :, heads]
            e, ok = max_err(part, want.to(torch.bfloat16),
                            TOL[torch.bfloat16])
            require(ok, f"flash_attention disagrees with its plain version: "
                    f"{name}, batch row {b}, KV head {g}")
            abs_err = max(abs_err, e)
            rounding = max(rounding, row_rel_err(want.to(torch.bfloat16),
                                                 want))
            err = max(err, row_rel_err(part, want))
    limit = 2 * rounding
    short = plain_attention(qf, kf, vf, window=T - 64)
    dropped = row_rel_err(short.to(torch.bfloat16), want)
    ok = err <= limit < dropped
    log(f"flash_attention {name}: held by (batch row, KV group), {B * KV} "
        f"plain calls of {G} heads: max_abs_err={abs_err:.3e} "
        f"tol={TOL[torch.bfloat16]:.0e}; per row max |err| / row RMS "
        f"{err:.3e}, limit {limit:.3e}, the last group without its first "
        f"key tile {dropped:.3e} {'ok' if ok else 'FAIL'}")
    require(err <= limit, f"flash_attention rows off the fp32 result: {name}")
    require(dropped > limit, f"per-row check cannot see a dropped tile: "
            f"{name}")
    return abs_err


def check_cell_kernels(gen):
    """Phase 4's rows for phase 5l's cells: each kernel at the shapes the
    cells give it (``CELL_*``; phase 5l requires every call it records to
    be one of these). The bf16 flash forward and backward at qwen3-0.6b's
    train_4k microbatch, as ``check_frontend_train_kernels`` holds its
    regimes; the bf16 forward at the whole prefill_32k cut, held by
    ``hold_flash_by_group`` and timed beside its plain version and SDPA on
    one (batch row, KV group), the cut marked in the row; every norm
    forward (and train_4k's backward); ssd_scan (walk, normalizer) and
    slstm_scan at xlstm-1.3b's prefill_32k cut, against their plain
    versions at the whole T. Returns (rows by kernel, the held
    ``call_key``s)."""
    bf16 = torch.bfloat16
    rows = {"flash": [], "flash_bwd": [], "rmsnorm": [], "rmsnorm_bwd": []}
    held = set()
    laps = [time.perf_counter()]
    B, T, H, KV, hd = CELL_FLASH_TRAIN
    q, k, v, got, err, name = hold_flash(gen, B, T, T, H, KV, hd, bf16, True)
    check_flash_rows(q, k, v, got, name)
    kw = dict(causal=True, window=0, q_offset=0)
    require(torch.equal(got, flash_attention(q, k, v, **kw)),
            f"two flash_attention calls differ: {name}")
    check_flash_lse(q, k, v, kw, name)
    check_flash_fwd_repeats(q, k, v, name)
    rows["flash"].append(time_flash(q, k, v, err))
    held.add(call_key("flash_attention", q, k, v, **kw))
    del q, k, v, got
    held_bwd = hold_flash_bwd_bf16(gen, B, T, H, KV, hd)
    rows["flash_bwd"].append(time_flash_bwd_bf16(**held_bwd))
    del held_bwd
    torch.cuda.empty_cache()

    B, T, H, KV, hd = CELL_FLASH_PREFILL
    q = randn(gen, B, T, H, hd, dtype=bf16)
    k, v = (randn(gen, B, T, KV, hd, dtype=bf16) for _ in range(2))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    name = f"B={B} T=S={T} H={H} KV={KV} hd={hd} bf16 causal"
    err = hold_flash_by_group(q, k, v, got, name)
    require(torch.equal(got, flash_attention(q, k, v)),
            f"two flash_attention calls differ: {name}")
    whole = work.flash_fwd(B, T, T, H, KV, hd, 2, True, 0).bound()
    log(f"  device time {name} (the whole cut): kernel "
        f"{device_ms(lambda: flash_attention(q, k, v), 3):.4f} ms, bound "
        f"{max(whole.values()):.4f} ms ({max(whole, key=whole.get)})")
    held.add(call_key("flash_attention", q, k, v))
    G = H // KV
    one = [t.contiguous() for t in (q[:1, :, :G], k[:1, :, :1], v[:1, :, :1])]
    del q, k, v, got
    torch.cuda.empty_cache()
    row = time_flash(*one, err)
    row["cut"] = (f"timed on one batch row and one KV group ({G} heads), "
                  f"where the plain version's {T} x {T} fp32 scores fit; "
                  f"held at the whole B={B} H={H} KV={KV}")
    rows["flash"].append(row)
    del one
    torch.cuda.empty_cache()

    laps.append(time.perf_counter())
    for n, d in CELL_RMS:
        x = randn(gen, n, d, dtype=bf16)
        g = (1 + 0.1 * randn(gen, d)).to(bf16)
        name = f"rows={n} d={d} bfloat16"
        err = hold_rmsnorm(name, x, g)
        require(torch.equal(rmsnorm(x, g, eps=1e-6), rmsnorm(x, g, eps=1e-6)),
                f"two rmsnorm calls differ: {name}")
        rows["rmsnorm"].append(time_rmsnorm(name, x, g, err))
        held.add(call_key("rmsnorm", x))
    for n, d in CELL_RMS_BWD:
        rows["rmsnorm_bwd"].append(hold_rmsnorm_bwd_bf16(gen, n, d))
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())

    b, H, N, P = SSD_PATH
    x, a, B_, C, w = model_like_ssd(gen, b, CELL_SCAN_T, H, N, P)
    got = ssd_scan(x, a, B_, C, norm_weights=w)
    torch.cuda.synchronize()
    name = (f"b={b} T={CELL_SCAN_T} H={H} N={N} P={P} fp32 normalizer, "
            f"drawn like the model, path {ssd_path(N, P, True)}")
    want, graph, plain_ms = plain_graphed(
        lambda: ssd_scan_ref(x, a, B_, C, norm_weights=w))
    err = compare("ssd_scan", name, got, want)
    require(all(torch.equal(f, s) for f, s in
                zip(got, ssd_scan(x, a, B_, C, norm_weights=w))),
            "ssd_scan: two calls gave different bits")
    del want, graph
    rows["ssd"] = time_ssd(x, a, B_, C, w, err, plain_ms)
    held.add(call_key("ssd_scan", x, a, B_, C, norm_weights=w))
    del x, a, B_, C, w, got
    B1, nh, dh = SLSTM_PATH
    wx, r, bias = slstm_inputs(gen, B1, CELL_SCAN_T, nh, dh, torch.float32,
                               True)
    hs, state = slstm_scan(wx, r, bias)
    torch.cuda.synchronize()
    (want_hs, want_state), graph, plain_ms = plain_graphed(
        lambda: slstm_scan_ref(wx, r, bias))
    err = compare("slstm_scan", f"B={B1} T={CELL_SCAN_T} nh={nh} dh={dh} wx "
                  f"float32 r bfloat16", (hs, *state),
                  (want_hs, *want_state))
    del want_hs, want_state, graph
    rows["slstm"] = time_slstm(wx, r, bias, err, plain_ms)
    held.add(call_key("slstm_scan", wx, r, bias))
    del wx, r, bias, hs, state
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    log("phase 4, phase 5l's rows: " + ", ".join(
        f"{part} {b - a:.1f} s" for part, a, b in
        zip(("flash", "norms", "scans"), laps, laps[1:])))
    return rows, held


def plain_graphed(fn):
    """One call of a plain scan ``fn`` captured in a CUDA graph (the same
    ops ran in graphs at T = 1000 earlier in phase 4, so nothing is left
    to warm up) and replayed twice: the first replay gives the outputs the
    kernel is held to, the second is timed. At T = 32768 the host's pass
    over the steps (one launch each) takes ~10 s, so the plain version is
    walked once, not three times as ``device_ms`` would. Returns (outputs,
    the graph, which owns their memory, device ms)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return out, graph, start.elapsed_time(end)


DRYRUN_FAILS = {   # (arch, shape): what the card raises there too
    ("xlstm_1_3b", "train_4k"): "B <= 16",        # slstm_scan's MAX_BATCH:
    ("xlstm_1_3b", "prefill_32k"): "B <= 16",     # microbatch 128, batch 32
    ("nemotron_4_340b", "train_4k"): "head_dim 192",   # no hd 192 backward
}
DRYRUN_TIMEOUT = 900         # s; it runs on the host beside phases 2-5k
FIT_SHARE = 0.9              # of the card's memory a whole cell may take
CUT_SHARE = 0.65             # a cut cell's: the allocator's room to fragment
#   (qwen3-0.6b prefill_32k at batch 8, 57.72 GiB of dry-run peak, 73% of
#   the card, ran out of memory holding 21.55 GiB free in segments too
#   small for the final stack of its layers' caches; PERF.md, 5l)
DIGEST_CHUNK = 1 << 26       # elements summed at a time by bits_digest
PEAK_TOL = (0.02, 256 * 2**20)   # real peak within rel x dry-run + abs bytes
CUT_CELLS = (  # arch, shape, batch to start from (None: the largest that fits)
    ("qwen3-0.6b", "train_4k", None), ("qwen3-0.6b", "prefill_32k", None),
    ("xlstm-1.3b", "prefill_32k", 1))
EXAMPLES_TIMEOUT = 600


def start_dryrun(out_dir: Path):
    """``python -m repro_torch.launch.dryrun --all --out out_dir`` in the
    background: the meta device only, on the host's CPU, so it runs beside
    the card's phases. Returns (process, its log file, start time)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    # one thread at the lowest priority: the card's phases come first
    env["OMP_NUM_THREADS"] = "1"
    out_dir.mkdir(parents=True, exist_ok=True)
    logf = open(out_dir / "dryrun.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out",
         str(out_dir)], cwd=ROOT, env=env, stdout=logf,
        stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(19))
    return proc, logf, time.perf_counter()


def expected_status(arch: str, shape: str) -> str:
    if (arch, shape) in DRYRUN_FAILS:
        return "fail"
    return ("ok" if shape_applicable(get_config(arch), SHAPES[shape])[0]
            else "skip")


def check_dryrun(proc, logf, t0, out_dir: Path) -> dict:
    """Waits for the background dry-run; requires exactly the expected set
    of ok / skip / fail cells (each fail for its reason) and exit code 1
    (there are failed cells). Returns {(arch, shape): record}."""
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError("the dry-run did not end within "
                           f"{DRYRUN_TIMEOUT} s")
    finally:
        logf.seek(0)
        text = logf.read()
        logf.close()
    for line in text.splitlines():      # the cells' lines, not tracebacks
        if (re.match(r"  \w+ +\w+ +\w+_step ", line)
                or " cells in " in line or "FAILED" in line):
            log(f"  dryrun| {line.strip()}")
    with open(out_dir / dryrun.OUT_NAME) as f:
        recs = {(r["arch"], r["shape"]): r for r in json.load(f)}
    want = {(a, sh): expected_status(a, sh) for a in ARCH_IDS for sh in SHAPES}
    got = {cell: rec["status"] for cell, rec in recs.items()}
    require(got == want, f"dry-run cells differ from the expected set: "
            f"{ {c: (got.get(c), w) for c, w in want.items() if got.get(c) != w} }")
    for cell, why in DRYRUN_FAILS.items():
        require(why in recs[cell]["reason"],
                f"dry-run {cell} failed for another reason: "
                f"{recs[cell]['reason']}")
    require(rc == 1, f"the dry-run exited {rc} with failed cells")
    counts = Counter(got.values())
    log(f"dry-run: {counts['ok']} ok, {counts['skip']} skip, "
        f"{counts['fail']} fail (the expected set), exit {rc}; "
        f"{sum(r.get('eval_s', 0) for r in recs.values()):.1f} s of cells")
    return recs


def bits_digest(tree):
    """Per tensor leaf: its shape and two sums of its elements' bit
    patterns (as int64), ``DIGEST_CHUNK`` elements at a time: the plain sum
    and the sum weighted by each element's position (from 1, wrapping in
    int64). Equal bits give equal digests; permuted or transposed elements,
    or errors that cancel in the plain sum, change the weighted one. Other
    leaves as they are. The outputs of a whole cell stay on the card (42
    GiB of state at xlstm-1.3b's decode_32k), so they are digested there
    rather than copied."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        flat = t.detach().contiguous().reshape(-1).view(ints[t.element_size()])
        total = weighted = 0
        for i in range(0, flat.numel(), DIGEST_CHUNK):
            part = flat[i:i + DIGEST_CHUNK].to(torch.int64)
            pos = torch.arange(i + 1, i + 1 + part.numel(), dtype=torch.int64,
                               device=part.device)
            total += int(part.sum())
            weighted += int((part * pos).sum())
        out.append((tuple(t.shape), total, weighted))
    return out


def cut_cell(cfg, shape, rec, start, total):
    """The largest power-of-two batch (at least the microbatches of a train
    cell; from ``start`` where given) whose dry-run peak fits
    ``CUT_SHARE`` of the card, found from the whole cell's temps scaled
    by the batch and confirmed on meta; returns (shape, evaluation)."""
    limit = CUT_SHARE * total
    least = cfg.microbatches if shape.kind == "train" else 1
    B = start
    if B is None:
        m = rec["memory"]
        per_row = m["temp_bytes"] / shape.global_batch
        B = 1 << int(math.log2(max(least, (limit - m["argument_bytes"])
                                   / per_row)))
        B = min(B, shape.global_batch)
    while B >= least:
        cut = dataclasses.replace(shape, global_batch=B)
        got = dryrun.evaluate(build_step(cfg, cut, device="meta"))
        if got["argument_bytes"] + got["temp_bytes"] <= limit:
            return cut, got
        B //= 2
    raise RuntimeError(f"{cfg.name} {shape.name}: no batch fits the card")


def run_program(spec, cfg, direct, label):
    """One run of ``spec.fn`` on real arguments (``real_args``, seed 0) on
    the card: its device ms, launches, kernel calls (``recording``),
    argument bytes and peak (allocated, beyond what was live before the
    arguments); then the port's direct entry point ``direct`` on arguments
    made again from the same seed, whose outputs must have the same
    ``bits_digest``. ``spec.fn`` is that entry point (``build_step`` wraps
    ``make_train_step``, ``prefill`` and ``decode_step`` themselves), so
    this is a repeat-determinism check of the spec's arguments and
    wrapper, not a second implementation held against the first."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = real_args(spec, cfg, "cuda", seed=0)
    arg_bytes = dryrun.storage_bytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    calls = set()
    start.record()
    with recording(calls):
        out = spec.fn(*args)
    end.record()
    end.synchronize()
    launches = Counter(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    ms = start.elapsed_time(end)
    got = bits_digest(out)
    del out, args
    gc.collect()
    torch.cuda.empty_cache()
    args = real_args(spec, cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    start.record()
    out = direct(*args)
    end.record()
    end.synchronize()
    direct_ms = start.elapsed_time(end)
    want = bits_digest(out)
    del out, args
    gc.collect()
    torch.cuda.empty_cache()
    same = got == want
    log(f"  {label}: {spec.name} {ms:.2f} device ms (the process's first "
        f"call at these shapes), launches {dict(launches)}; the direct "
        f"entry point again on arguments from the same seed {direct_ms:.2f} "
        f"ms: {len(got)} outputs' digests (plain and position-weighted bit "
        f"sums) {'equal' if same else 'DIFFER'} (repeat determinism)")
    require(same, f"{label}: the spec and the entry point differ")
    return {"ms": ms, "direct_ms": direct_ms, "peak": peak,
            "arg_bytes": arg_bytes, "launches": launches, "calls": calls}


def hold_cell(label, cfg, shape, predicted, direct, want_launches, card,
              held):
    """``run_program`` on ``build_step``'s program for the cell, held to the
    dry-run: the arguments' bytes exactly, the peak within ``PEAK_TOL``,
    the launches exactly ``want_launches``; and every kernel call it made
    at a shape phase 4 held (``held``, from ``check_cell_kernels``)."""
    spec = build_step(cfg, shape, device="cuda")
    got = run_program(spec, cfg, direct, label)
    unheld = got["calls"] - held
    log(f"  {label}: {len(got['calls'])} kernel call shapes, each held in "
        f"phase 4" if not unheld else f"  {label}: kernel calls at shapes "
        f"phase 4 did not hold: {sorted(unheld)}")
    require(not unheld, f"{label}: a kernel ran at a shape phase 4 did not "
            f"hold")
    dry_peak = predicted["argument_bytes"] + predicted["temp_bytes"]
    rel, extra = PEAK_TOL
    gap = got["peak"] - dry_peak
    tok = (f", {shape.global_batch / got['direct_ms'] * 1e3:.1f} tokens/s "
           f"at the second call's ms" if shape.kind == "decode" else "")
    log(f"  {label}: B={shape.global_batch} T={shape.seq_len}: arguments "
        f"{got['arg_bytes'] / 2**30:.3f} GiB (dry-run "
        f"{predicted['argument_bytes'] / 2**30:.3f}), peak "
        f"{got['peak'] / 2**30:.3f} GiB against the dry-run's "
        f"{dry_peak / 2**30:.3f} ({gap / 2**20:+.1f} MiB, "
        f"{gap / dry_peak:+.3%}); {got['ms']:.2f} / {got['direct_ms']:.2f} "
        f"device ms (first / second call){tok} ({card})")
    require(got["arg_bytes"] == predicted["argument_bytes"],
            f"{label}: argument bytes differ from the dry-run's")
    require(abs(gap) <= rel * dry_peak + extra,
            f"{label}: peak {got['peak']} off the dry-run's {dry_peak}")
    require(dict(got["launches"]) == want_launches,
            f"{label}: launches {dict(got['launches'])}, want "
            f"{want_launches}")
    return got


def serve_launches(cfg) -> dict:
    """One prefill's launches: flash per ATTN layer (and shared-block
    application), the scans per recurrent layer, the norms
    (``LAYER_NORMS``; ln1 and ln2, + q_norm and k_norm with qk-norm, an
    ATTN layer) and final_norm."""
    kinds = Counter(cfg.block_pattern)
    apps = n_shared_applications(cfg)
    want = {"rmsnorm": sum(LAYER_NORMS.get(k, 2 + 2 * cfg.qk_norm) * n
                           for k, n in kinds.items()) + 2 * apps + 1}
    scans = {"ssd_scan": kinds["mlstm"] + kinds["mamba2"],
             "slstm_scan": kinds["slstm"],
             "flash_attention": kinds["attn"] + apps}
    want.update({k: n for k, n in scans.items() if n})
    return want


def run_cells(recs, card, held):
    """Every applicable cell whose dry-run peak fits ``FIT_SHARE`` of the
    card, whole; the cut cells of ``CUT_CELLS``; each through ``hold_cell``
    (``held``: phase 4's ``call_key``s). Returns {path: launches}."""
    total = torch.cuda.get_device_properties(0).total_memory
    paths = {}
    whole = [cell for cell, r in recs.items() if r["status"] == "ok" and
             r["memory"]["peak_bytes"] <= FIT_SHARE * total]
    log(f"whole cells that fit {FIT_SHARE:.0%} of {total / 2**30:.2f} GiB: "
        f"{whole}")
    require(("xlstm_1_3b", "decode_32k") in whole,
            "xlstm-1.3b decode_32k does not fit the card in the dry-run")
    for arch, name in whole:
        cfg, shape = get_config(arch), SHAPES[name]
        require(shape.kind == "decode", f"{arch} {name}: a whole "
                f"{shape.kind} cell fits; give it a direct entry point")
        direct = lambda p, tok, cache, cl, cfg=cfg: decode_step(
            p, cfg, tok, cache, cl)
        label = f"{arch} {name} (whole)"
        want = {"rmsnorm": serve_launches(cfg)["rmsnorm"]}
        got = hold_cell(label, cfg, shape, recs[arch, name]["memory"],
                        direct, want, card, held)
        paths[f"5l {label}"] = got["launches"]
    for arch, name, start in CUT_CELLS:
        cfg, shape = get_config(arch), SHAPES[name]
        cut, predicted = cut_cell(cfg, shape, recs[arch.replace("-", "_")
                                                   .replace(".", "_"), name],
                                  start, total)
        label = f"{arch} {name} (batch cut to {cut.global_batch})"
        if shape.kind == "train":
            direct = make_train_step(cfg, device="cuda")
            want = trainer_launches(cfg)
        else:
            direct = lambda p, b, cfg=cfg: prefill(
                p, cfg, b["tokens"], **{k: v for k, v in b.items()
                                        if k != "tokens"})
            want = serve_launches(cfg)
        got = hold_cell(label, cfg, cut, predicted, direct, want, card,
                        held)
        paths[f"5l {label}"] = got["launches"]
    return paths


def run_examples(card):
    """The five examples at once as processes: the four model examples on
    the card, wordstats on the real worker pool; each must exit 0."""
    runs = [(["examples/torch_quickstart.py", "--device", "cuda"],
             "quickstart"),
            (["examples/torch_serve_batch.py", "--device", "cuda"],
             "serve_batch"),
            (["examples/torch_interactive_sweep.py", "--device", "cuda"],
             "interactive_sweep"),
            (["examples/torch_fault_tolerance.py", "--device", "cuda"],
             "fault_tolerance"),
            (["examples/torch_mapreduce_wordstats.py", "--backend",
              "procpool", "--inject"], "wordstats")]
    done = run_modules(runs, EXAMPLES_TIMEOUT)
    for (proc, wall), (_, tag) in zip(done, runs):
        log(f"example {tag}: exit {proc.returncode} in {wall:.1f} s ({card})")
        require(proc.returncode == 0, f"example {tag} failed")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible; this script runs only "
                 "on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name):
        """Logs the seconds since the last lap: each phase's time."""
        laps.append(time.perf_counter())
        log(f"{name}: {laps[-1] - laps[-2]:.1f} s (at {laps[-1] - t_start:.1f} s)")

    card = card_line()                                       # phase 1
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}; tf32 off")
    # phase 5l's dry-run: on the host's CPU, beside the card's phases
    dry_dir = Path(tempfile.mkdtemp(prefix="dryrun-"))
    dry_bg = start_dryrun(dry_dir)
    try:
        kernels = run_phases(card, laps, lap, dry_bg, dry_dir)
    finally:
        if dry_bg[0].poll() is None:
            dry_bg[0].kill()
        dry_bg[0].wait()
        dry_bg[1].close()
        shutil.rmtree(dry_dir, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_phases(card, laps, lap, dry_bg, dry_dir) -> list:
    """Phases 2-6; returns the kernels' JSON line's list."""

    t0 = time.perf_counter()                                 # phase 2
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling", "smem")):
            log(f"  {line.strip()}")
    for hd in _FWD_HEAD_DIMS:
        occ = sm90_occupancy(hd)
        kernel = ("flash_fwd_sm90_hd192_kernel (4 warps, K and V single-"
                  "buffered, O stored by TMA)" if hd == 192
                  else "flash_fwd_sm90_kernel (4 warps)")
        log(f"flash_attention bf16 forward hd={hd}: {kernel}: "
            f"{occ['registers']} registers a thread at launch, "
            f"{occ['spill_bytes']} local (spill) bytes a thread, "
            f"{occ['smem_bytes']} bytes of shared memory, "
            f"{occ['blocks_per_sm']} block(s) per SM")
        require(occ["blocks_per_sm"] >= 1,
                f"the bf16 flash forward does not fit an SM at hd={hd}")
    for draw, (*_, N, P) in SSD_BWD_TRAIN.items():
        Pe = P + (draw == "mlstm")
        for name, occ in ssd_bwd_occupancy(N, Pe).items():
            log(f"ssd_scan_bwd N={N} Pe={Pe}: ssd_bwd_{name}_kernel "
                f"{occ['registers']} registers, {occ['spill_bytes']} local "
                f"(spill) bytes a thread, {occ['smem_bytes']} bytes of "
                f"shared memory, {occ['blocks_per_sm']} block(s) per SM")
            require(occ["blocks_per_sm"] >= 1 and occ["spill_bytes"] == 0,
                    f"ssd_bwd_{name}_kernel at N={N} spills or does not fit")
    check_ssd_shape_rules()
    B, _, nh, dh = SLSTM_BWD_TRAIN
    for r_dtype in (torch.bfloat16, torch.float32):
        occ = slstm_bwd_occupancy(B, nh, dh, torch.float32, r_dtype)
        log(f"slstm_scan_bwd B={B} nh={nh} dh={dh} r {str(r_dtype)[6:]}: "
            f"slstm_bwd_walk_kernel {occ['registers']} registers, "
            f"{occ['spill_bytes']} local (spill) bytes a thread, "
            f"{occ['smem_bytes']} bytes of shared memory, {occ['clusters']} "
            f"clusters held at once")
        require(occ["clusters"] >= 1 and occ["spill_bytes"] == 0,
                f"slstm_bwd_walk_kernel spills or does not fit: r {r_dtype}")
    for hd in _FWD_HEAD_DIMS:
        fwd_occ = fwd_occupancy(hd)
        log(f"flash_attention_fwd hd={hd}: {fwd_occ['smem_bytes']} bytes of "
            f"shared memory, {fwd_occ['blocks_per_sm']} block(s) of 16 warps "
            f"per SM")
        require(fwd_occ["blocks_per_sm"] >= 1,
                f"the fp32 flash forward does not fit an SM at hd={hd}")
        for dtype, warps in ((torch.float32, (16, 16)),
                             (torch.bfloat16, (4 if hd == 80 else 8, 4))):
            if hd not in _BWD_HEAD_DIMS[dtype]:  # fp32 80, both 192
                continue
            occ = bwd_occupancy(hd, dtype)
            regs = ("" if dtype == torch.float32 else
                    f" (dk/dv {occ['dkdv_registers']} registers, "
                    f"{occ['dkdv_spill_bytes']} local bytes; dq "
                    f"{occ['dq_registers']} registers, "
                    f"{occ['dq_spill_bytes']} local bytes a thread)")
            log(f"flash_attention_bwd hd={hd} {str(dtype)[6:]}: dk/dv kernel "
                f"{occ['dkdv_smem_bytes']} bytes of shared memory, "
                f"{occ['dkdv_blocks_per_sm']} block(s) of {warps[0]} warps per "
                f"SM; dq kernel {occ['dq_smem_bytes']} bytes, "
                f"{occ['dq_blocks_per_sm']} block(s) of {warps[1]} warps per "
                f"SM{regs}")
            require(min(occ["dkdv_blocks_per_sm"],
                        occ["dq_blocks_per_sm"]) >= 1,
                    f"a flash backward kernel does not fit an SM at hd={hd} "
                    f"{dtype}")

    lap("phases 1-2 (card, build)")
    check_splitk(torch.Generator("cuda").manual_seed(1))    # phase 3
    lap("phase 3")

    gen = torch.Generator("cuda").manual_seed(0)             # phase 4
    flash_rows = check_flash(gen)
    rms_rows = check_rmsnorm(gen)
    flash_bwd_row, flash_fp32_row = check_flash_bwd(gen)
    rms_bwd_rows = check_rmsnorm_bwd(gen)
    flash_bwd_bf16_row = check_flash_bwd_bf16(gen)
    rms_bwd_bf16_rows, rms_bwd_bf16_step = check_rmsnorm_bwd_bf16(gen)
    ssd_rows = check_ssd(gen)
    slstm_rows = check_slstm(gen)
    flash_5g_rows, rms_5g_rows = check_modal_kernels(
        torch.Generator("cuda").manual_seed(31))
    flash_5h_row, flash_fp32_5h_row, rms_5h_row = check_nemotron_kernels(
        torch.Generator("cuda").manual_seed(32))
    lap("phase 4")

    qwen, _ = serve("qwen3-0.6b", QWEN_LAYERS,                # phase 5
                    {"flash_attention": QWEN_LAYERS, "rmsnorm": QWEN_NORMS},
                    {"rmsnorm": QWEN_NORMS})
    xlstm, _ = serve("xlstm-1.3b", XLSTM_MLSTM + XLSTM_SLSTM,
                     {"ssd_scan": XLSTM_MLSTM, "slstm_scan": XLSTM_SLSTM,
                      "rmsnorm": XLSTM_NORMS},
                     {"rmsnorm": XLSTM_NORMS}, ssd="walk")
    zamba, _ = serve("zamba2-2.7b", ZAMBA_LAYERS,
                     {"ssd_scan": ZAMBA_LAYERS, "flash_attention": ZAMBA_APPS,
                      "rmsnorm": ZAMBA_NORMS},
                     {"rmsnorm": ZAMBA_NORMS}, ssd="chunks")
    lap("phase 5 (qwen3, xlstm, zamba2 serving)")
    archs = serve_archs(card)                                # phase 5f
    modal = serve_modal_archs(card)                          # phase 5g
    nemotron, _ = serve_nemotron(card)                       # phase 5h
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    train, train_metrics = train_full_width()                # phase 5b
    sweep, sweep_metrics = train_sweep()
    torch.cuda.empty_cache()
    lap("phase 5b")

    sweep_cli()                                              # phase 5c
    cli, _ = sweep_in_process(sweep_metrics["final_losses"])
    full, _ = sweep_full_width(train_metrics["loss_first"])
    torch.cuda.empty_cache()
    lap("phase 5c")

    trainer, trainer_metrics = trainer_full_width()          # phase 5d
    log(f"trainer: rmsnorm bwd in the traced step "
        f"{trainer_metrics['device_ms_by_group']['rmsnorm bwd']:.3f} ms; "
        f"phase 4's times weighted by a step's launches "
        f"{rms_bwd_bf16_step['ms']:.3f} ms (F.rms_norm backward "
        f"{rms_bwd_bf16_step['library_ms']:.3f}, bound "
        f"{rms_bwd_bf16_step['bound_ms']:.3f})")
    torch.cuda.empty_cache()
    lap("phase 5d")
    # phase 4's rows of phase 5i's kernels, run after the serving phases:
    # the cuBLAS workspaces of these checks' streams stay, and would take
    # from the memory beside the serving phases' fp32 depth cuts
    ssd_bwd_rows, slstm_bwd_rows, flash_80_row, rms_5i_rows = \
        check_recurrent_bwd_kernels(torch.Generator("cuda").manual_seed(33))
    torch.cuda.empty_cache()
    lap("phase 4, phase 5i's rows")
    recurrent = train_recurrent_archs(card)                  # phase 5i
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    flash_5j_row, flash_bwd_5j_row, rms_5j_row, rms_bwd_5j_row = \
        check_moe_train_kernels(torch.Generator("cuda").manual_seed(34))
    torch.cuda.empty_cache()
    lap("phase 4, phase 5j's rows")
    moe_train, _ = train_moe(card)                           # phase 5j
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    flash_5k_rows, flash_bwd_5k_rows, rms_5k_rows, rms_bwd_5k_rows = \
        check_frontend_train_kernels(torch.Generator("cuda").manual_seed(35))
    torch.cuda.empty_cache()
    lap("phase 4, phase 5k's rows")
    frontend_train = train_frontend_archs(card)              # phase 5k
    torch.cuda.empty_cache()
    laps.append(time.perf_counter())
    cell_rows, held = check_cell_kernels(torch.Generator("cuda").manual_seed(36))
    torch.cuda.empty_cache()
    lap("phase 4, phase 5l's rows")
    recs = check_dryrun(*dry_bg, dry_dir)                    # phase 5l
    lap("phase 5l, the dry-run (ran beside phases 2-5k)")
    cells = run_cells(recs, card, held)
    lap("phase 5l, the cells on the card")
    run_examples(card)
    lap("phase 5l, the examples")

    launch_layer(card)                                       # phase 5e

    cell_train = {k: v for k, v in cells.items() if "train_4k" in k}
    xlstm_cells = {k: v for k, v in cells.items() if "xlstm" in k}
    serving = {"qwen3-0.6b serve": qwen, "xlstm-1.3b serve": xlstm,
               "zamba2-2.7b serve": zamba, **archs, **modal, **nemotron,
               **{k: v for k, v in cells.items() if k not in cell_train}}
    bf16_training = {"qwen3-0.6b Trainer (bf16, full width)": trainer,
                     **recurrent, MOE_TRAIN.path: moe_train,
                     **frontend_train, **cell_train}
    xlstm_train = {k: v for k, v in recurrent.items() if "xlstm" in k}
    zamba_train = {k: v for k, v in recurrent.items() if "zamba2" in k}
    training = {"qwen3-0.6b train (fp32, full width)": train,
                "sweep member (qwen3-0.6b reduced, fp32)": sweep,
                "sweep CLI run_sweep (qwen3-0.6b reduced, fp32)": cli,
                "sweep supervisor (qwen3-0.6b fp32, full width)": full}

    def launches(name, paths):                               # phase 6
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    csrc = "src/repro_torch/kernels/csrc/"
    flash_tpu = "src/repro/kernels/flash_attention.py:121"
    rms_tpu = "src/repro/kernels/rmsnorm.py:35"
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention_sm90.cu", "replaces": flash_tpu,
         **launches("flash_attention", {
             k: v for k, v in {**serving, **bf16_training}.items()
             if k not in nemotron}),
         **flash_rows[REPORT_T],
         "regimes": (flash_5g_rows + [flash_5j_row] + flash_5k_rows
                     + cell_rows["flash"])},
        {"name": "flash_attention_hd192", "route": "cuda",
         "source": csrc + "flash_attention_sm90.cu", "replaces": flash_tpu,
         "kernel": "flash_fwd_sm90_hd192_kernel<192> (64-row blocks, three "
                   "an SM, O stored by TMA)",
         **launches("flash_attention", nemotron), **flash_5h_row},
        {"name": "flash_attention_fp32", "route": "cuda",
         "source": csrc + "flash_attention.cu", "replaces": flash_tpu,
         **launches("flash_attention", training), **flash_fp32_row,
         "regimes": [flash_fp32_5h_row]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu", "replaces": flash_tpu,
         **launches("flash_attention_bwd", training), **flash_bwd_row},
        {"name": "flash_attention_bwd_bf16", "route": "cuda",
         "source": csrc + "flash_attention_bwd_sm90.cu", "replaces": flash_tpu,
         **launches("flash_attention_bwd", {
             k: v for k, v in bf16_training.items() if k not in zamba_train}),
         **flash_bwd_bf16_row,
         "regimes": ([flash_bwd_5j_row] + flash_bwd_5k_rows
                     + cell_rows["flash_bwd"])},
        {"name": "flash_attention_bwd_bf16_hd80", "route": "cuda",
         "source": csrc + "flash_attention_bwd_sm90.cu", "replaces": flash_tpu,
         "kernel": "flash_bwd_dkdv_sm90_kernel_one_wg<80>, "
                   "flash_bwd_dq_sm90_kernel<80> (80-column tiles)",
         **launches("flash_attention_bwd", zamba_train), **flash_80_row},
        {"name": "rmsnorm", "route": "cuda", "source": csrc + "rmsnorm.cu",
         "replaces": rms_tpu,
         **launches("rmsnorm", {**serving, **training, **bf16_training}),
         **rms_rows[REPORT_RMS],
         "regimes": (rms_5g_rows + [rms_5h_row, rms_5j_row] + rms_5k_rows
                     + cell_rows["rmsnorm"])},
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": csrc + "rmsnorm_bwd.cu", "replaces": rms_tpu,
         **launches("rmsnorm_bwd", training),
         **rms_bwd_rows[RMS_BWD_REPORT]},
        {"name": "rmsnorm_bwd_bf16", "route": "cuda",
         "source": csrc + "rmsnorm_bwd_sm90.cu", "replaces": rms_tpu,
         **launches("rmsnorm_bwd", bf16_training),
         **rms_bwd_bf16_rows[RMS_BWD_BF16_REPORT],
         "regimes": (list(rms_5i_rows.values()) + [rms_bwd_5j_row]
                     + rms_bwd_5k_rows + cell_rows["rmsnorm_bwd"])},
        {"name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:82",
         **launches("ssd_scan", {"xlstm-1.3b serve": xlstm, **xlstm_train,
                                 **xlstm_cells}),
         **ssd_rows[REPORT_T], "regimes": [cell_rows["ssd"]]},
        {"name": "ssd_scan_chunks", "route": "cuda",
         "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:82",
         **launches("ssd_scan", {"zamba2-2.7b serve": zamba, **zamba_train}),
         **ssd_rows["mamba2", REPORT_T]},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": csrc + "ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:82",
         **launches("ssd_scan_bwd", xlstm_train), **ssd_bwd_rows["mlstm"]},
        {"name": "ssd_scan_bwd_mamba2", "route": "cuda",
         "source": csrc + "ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:82",
         **launches("ssd_scan_bwd", zamba_train), **ssd_bwd_rows["mamba2"]},
        {"name": "slstm_scan", "route": "cuda",
         "source": csrc + "slstm_scan.cu",
         "replaces": "src/repro/kernels/slstm_scan.py:94",
         **launches("slstm_scan", {**serving, **xlstm_train}),
         **slstm_rows[1, REPORT_T, "bfloat16"],
         "regimes": [cell_rows["slstm"]]},
        {"name": "slstm_scan_bwd", "route": "cuda",
         "source": csrc + "slstm_scan_bwd.cu",
         "replaces": "src/repro/kernels/slstm_scan.py:94",
         "kernel": "slstm_bwd_walk_kernel (one cluster per head for the "
                   "whole walk; bf16 R on the tensor cores)",
         **launches("slstm_scan_bwd", xlstm_train),
         **slstm_bwd_rows["bfloat16"],
         "regimes": [slstm_bwd_rows["float32"]]},
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never ran on its paths")
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                 "bound_ms")))
        require(k["library_ms"] is None or math.isfinite(k["library_ms"]))
    return kernels


if __name__ == "__main__":
    main()
